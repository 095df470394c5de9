"""CFF font programs and Type2 charstrings, read as FreeType reads them.

A bare CFF (a PDF's ``FontFile3`` of Subtype Type1C or CIDFontType0C) or
the ``CFF `` table of an OpenType font: the header, the Name, Top DICT,
String and Global Subr INDEXes, the charset (formats 0-2 and the three
predefined ones), FDSelect (formats 0 and 3) and FDArray for CID-keyed
fonts, each Private DICT with its local subrs, and the Type2 charstrings.
The font's encoding is not read: FreeType selects the Unicode charmap it
builds from the glyph names, never the encoding's, so text never reaches
a glyph through it.

Outlines come out in font units as 16.16 fixed point, which is how
FreeType's CFF engine (``psaux``'s ``cf2``) keeps them: integer operands
are shifted left by 16, ``255``-prefixed operands are 16.16 already, and
``div``/``mul`` are ``FT_DivFix``/``FT_MulFix``. Stem hints are counted (to
skip ``hintmask`` bytes) and otherwise ignored; flex operators draw their
two curves; ``endchar`` with four operands composes two standard-encoding
glyphs (``seac``). A contour starts only with its first drawing operator,
so a ``moveto`` that draws nothing leaves no point, as in FreeType.

The Unicode charmap FreeType builds for a name-keyed font maps each glyph
name through ``uniXXXX``, ``uXXXX[XX]`` and the Adobe Glyph List (a name
with a ``.suffix`` counts as a variant of its base name, and loses to the
base glyph); a CID-keyed font has no charmap.
"""
from __future__ import annotations

import struct

from .glyph_names import (
    AGL, CFF_EXPERT_CHARSET, CFF_EXPERT_SUBSET_CHARSET, CFF_STANDARD_STRINGS,
    STANDARD_ENCODING,
)

ON, CUBIC = 1, 2
VARIANT_BIT = 0x80000000


def _read_index(b: bytes, p: int) -> tuple[list[bytes], int]:
    count = struct.unpack_from(">H", b, p)[0]
    if count == 0:
        return [], p + 2
    osz = b[p + 2]
    offs = []
    q = p + 3
    for _ in range(count + 1):
        v = 0
        for k in range(osz):
            v = (v << 8) | b[q + k]
        offs.append(v)
        q += osz
    base = q - 1
    items = [b[base + offs[i]:base + offs[i + 1]] for i in range(count)]
    return items, base + offs[-1]


def _real(b: bytes, p: int) -> tuple[float, int]:
    s = ""
    nib = "0123456789.EE?-?"
    while True:
        v = b[p]
        p += 1
        for n in (v >> 4, v & 15):
            if n == 15:
                return float(s or 0), p
            if n == 0xC:
                s += "E-"
            else:
                s += nib[n]


def _read_dict(b: bytes) -> dict:
    out, ops = {}, []
    p = 0
    while p < len(b):
        v = b[p]
        if v <= 21:
            p += 1
            if v == 12:
                v = 1200 + b[p]
                p += 1
            out[v] = ops
            ops = []
        elif v == 28:
            ops.append(struct.unpack_from(">h", b, p + 1)[0])
            p += 3
        elif v == 29:
            ops.append(struct.unpack_from(">i", b, p + 1)[0])
            p += 5
        elif v == 30:
            r, p = _real(b, p + 1)
            ops.append(r)
        elif 32 <= v <= 246:
            ops.append(v - 139)
            p += 1
        elif 247 <= v <= 250:
            ops.append((v - 247) * 256 + b[p + 1] + 108)
            p += 2
        elif 251 <= v <= 254:
            ops.append(-(v - 251) * 256 - b[p + 1] - 108)
            p += 2
        else:
            raise ValueError("bad CFF DICT byte %d" % v)
    return out


def _bias(n: int) -> int:
    return 107 if n < 1240 else (1131 if n < 33900 else 32768)


def mulfix(a: int, b: int) -> int:
    s = (a < 0) != (b < 0)
    c = (abs(a) * abs(b) + 0x8000) >> 16
    return -c if s else c


def divfix(a: int, b: int) -> int:
    if b == 0:
        return 0x7FFFFFFF
    s = (a < 0) != (b < 0)
    a, b = abs(a), abs(b)
    q = ((a << 16) + (b >> 1)) // b
    return -q if s else q


def ps_unicode_value(name: str) -> int:
    """FreeType's ``ps_unicode_value``: a glyph name's code point (0 for
    none), with VARIANT_BIT for names with a ``.suffix``."""
    def hexrun(s: str, lo: int, hi: int):
        n = 0
        while n < len(s) and n < hi and s[n] in "0123456789ABCDEFabcdef" and not s[n].islower():
            n += 1
        return n

    if name.startswith("uni") and len(name) >= 7:
        h = name[3:7]
        if hexrun(h, 4, 4) == 4:
            rest = name[7:]
            if rest == "":
                return int(h, 16)
            if rest[0] == ".":
                return int(h, 16) | VARIANT_BIT
    if name.startswith("u") and len(name) >= 5:
        body = name[1:]
        n = hexrun(body, 4, 6)
        if n >= 4:
            v = int(body[:n], 16)
            rest = body[n:]
            if v <= 0x10FFFF:
                if rest == "":
                    return v
                if rest[0] == ".":
                    return v | VARIANT_BIT
    dot = name.find(".")
    if dot > 0:
        v = AGL.get(name[:dot], 0)
        return v | VARIANT_BIT if v else 0
    if dot == 0:
        return 0
    return AGL.get(name, 0)


def unicode_charmap(names: list[str]) -> dict[int, int]:
    """{code point: glyph} from glyph names, as FreeType's psnames builds
    it: a base name wins over a variant, then the lower glyph index."""
    best: dict[int, tuple[int, int]] = {}
    for gid, name in enumerate(names):
        if not name or name == ".notdef":
            continue
        v = ps_unicode_value(name)
        if not v:
            continue
        cp = v & ~VARIANT_BIT
        rank = (1 if v & VARIANT_BIT else 0, gid)
        cur = best.get(cp)
        if cur is None or rank < cur:
            best[cp] = rank
    return {cp: r[1] for cp, r in best.items()}


class Outline:
    """A charstring's path: contours of (x, y, tag) in 16.16 font units."""

    def __init__(self) -> None:
        self.contours: list[list] = []
        self.cur: list | None = None
        self.x = self.y = 0
        self.width: int | None = None

    def move(self, dx: int, dy: int) -> None:
        self.close()
        self.x += dx
        self.y += dy

    def _start(self) -> None:
        if self.cur is None:
            self.cur = [(self.x, self.y, ON)]

    def line(self, dx: int, dy: int) -> None:
        self._start()
        self.x += dx
        self.y += dy
        self.cur.append((self.x, self.y, ON))

    def curve(self, d1x, d1y, d2x, d2y, d3x, d3y) -> None:
        self._start()
        x1, y1 = self.x + d1x, self.y + d1y
        x2, y2 = x1 + d2x, y1 + d2y
        x3, y3 = x2 + d3x, y2 + d3y
        self.cur += [(x1, y1, CUBIC), (x2, y2, CUBIC), (x3, y3, ON)]
        self.x, self.y = x3, y3

    def close(self) -> None:
        cur = self.cur
        self.cur = None
        if not cur:
            return
        # FreeType drops a last point that repeats the first, and a
        # contour of one point
        if len(cur) > 1 and cur[-1][:2] == cur[0][:2] and cur[-1][2] == ON:
            cur = cur[:-1]
        if len(cur) > 1:
            self.contours.append(cur)


class CFFFont:
    """The first font of a CFF program."""

    def __init__(self, data: bytes) -> None:
        b = bytes(data)
        if len(b) < 4 or b[0] != 1:
            raise ValueError("not a CFF font program")
        self.data = b
        p = b[2]
        names, p = _read_index(b, p)
        tops, p = _read_index(b, p)
        strings, p = _read_index(b, p)
        self.gsubrs, p = _read_index(b, p)
        if not tops:
            raise ValueError("CFF without a Top DICT")
        self.strings = [s.decode("latin-1") for s in strings]
        top = _read_dict(tops[0])
        self.top = top
        if top.get(1206, [2])[0] != 2:
            raise ValueError("CFF charstring type %r" % top.get(1206))
        fm = top.get(1207, [0.001, 0, 0, 0.001, 0, 0])
        self.font_matrix = tuple(float(v) for v in fm)
        self.bbox = tuple(top.get(5, [0, 0, 0, 0]))
        if 17 not in top:
            raise ValueError("CFF without CharStrings")
        self.charstrings, _ = _read_index(b, top[17][0])
        self.num_glyphs = len(self.charstrings)
        # FreeType reads a font as CID-keyed only with ROS and an FDArray
        self.is_cid = 1230 in top and 1236 in top
        self.fd_select = None
        self.privates = []
        if self.is_cid:
            fds, _ = _read_index(b, top[1236][0])
            for fd in fds:
                self.privates.append(self._private(_read_dict(fd)))
            self.fd_select = self._read_fdselect(top[1237][0]) if 1237 in top else None
        else:
            self.privates.append(self._private(top))
        self.charset = self._read_charset(top.get(15, [0])[0])
        self.glyph_names = None if self.is_cid else [self.sid(s) for s in self.charset]
        self._cache: dict[int, Outline] = {}

    def sid(self, s: int) -> str:
        if s < len(CFF_STANDARD_STRINGS):
            return CFF_STANDARD_STRINGS[s]
        k = s - len(CFF_STANDARD_STRINGS)
        return self.strings[k] if k < len(self.strings) else ".notdef"

    def _private(self, d: dict) -> dict:
        if 18 not in d:
            return {"subrs": [], "default_width": 0, "nominal_width": 0}
        size, off = d[18][0], d[18][1]
        pd = _read_dict(self.data[off:off + size])
        subrs = []
        if 19 in pd:
            subrs, _ = _read_index(self.data, off + pd[19][0])
        return {"subrs": subrs, "default_width": pd.get(20, [0])[0],
                "nominal_width": pd.get(21, [0])[0], "has_blues": 6 in pd}

    def _read_fdselect(self, off: int) -> list[int]:
        b = self.data
        fmt = b[off]
        n = self.num_glyphs
        if fmt == 0:
            return list(b[off + 1:off + 1 + n])
        if fmt == 3:
            nr = struct.unpack_from(">H", b, off + 1)[0]
            out = [0] * n
            for i in range(nr):
                first, fd = struct.unpack_from(">HB", b, off + 3 + 3 * i)
                nxt = struct.unpack_from(">H", b, off + 3 + 3 * (i + 1))[0]
                for g in range(first, min(nxt, n)):
                    out[g] = fd
            return out
        raise ValueError("FDSelect format %d" % fmt)

    def _read_charset(self, off: int) -> list[int]:
        n = self.num_glyphs
        if not self.is_cid and off in (0, 1, 2):
            if off == 0:
                return list(range(n))
            table = CFF_EXPERT_CHARSET if off == 1 else CFF_EXPERT_SUBSET_CHARSET
            std = {s: i for i, s in enumerate(CFF_STANDARD_STRINGS)}
            return [std.get(nm, 0) for nm in table[:n]]
        if self.is_cid and off == 0:
            return list(range(n))
        b = self.data
        fmt = b[off]
        out = [0]
        p = off + 1
        if fmt == 0:
            while len(out) < n:
                out.append(struct.unpack_from(">H", b, p)[0])
                p += 2
        elif fmt in (1, 2):
            while len(out) < n:
                first = struct.unpack_from(">H", b, p)[0]
                if fmt == 1:
                    left = b[p + 2]
                    p += 3
                else:
                    left = struct.unpack_from(">H", b, p + 2)[0]
                    p += 4
                out.extend(range(first, first + left + 1))
        else:
            raise ValueError("charset format %d" % fmt)
        return out[:n]

    def unicode_charmap(self) -> dict[int, int]:
        if self.is_cid:
            return {}
        return unicode_charmap(self.glyph_names)

    def gid_of_name(self, name: str) -> int:
        if self.glyph_names is None:
            return -1
        try:
            return self.glyph_names.index(name)
        except ValueError:
            return -1

    def private_of(self, gid: int) -> dict:
        if self.fd_select is not None:
            fd = self.fd_select[gid] if gid < len(self.fd_select) else 0
            return self.privates[fd] if fd < len(self.privates) else self.privates[0]
        return self.privates[0]

    def outline(self, gid: int) -> Outline:
        o = self._cache.get(gid)
        if o is None:
            o = Outline()
            if 0 <= gid < self.num_glyphs:
                _Type2(self, o).run(self.charstrings[gid], self.private_of(gid), 0)
            o.close()
            if o.width is None:
                o.width = self.private_of(gid)["default_width"] << 16 if 0 <= gid < self.num_glyphs else 0
            self._cache[gid] = o
        return o


class _Type2:
    """A Type2 charstring interpreter writing into an Outline."""

    def __init__(self, font: CFFFont, out: Outline) -> None:
        self.font = font
        self.o = out
        self.stack: list[int] = []
        self.nstems = 0
        self.width_done = False
        self.trans: dict[int, int] = {}
        self.done = False

    def _width(self, extra: bool, priv: dict) -> None:
        if self.width_done:
            return
        self.width_done = True
        if extra:
            self.o.width = (priv["nominal_width"] << 16) + self.stack.pop(0)

    def run(self, code: bytes, priv: dict, depth: int) -> None:
        if depth > 10:
            raise ValueError("charstring subroutines nest too deep")
        o, st = self.o, self.stack
        p, n = 0, len(code)
        while p < n and not self.done:
            v = code[p]
            p += 1
            if v >= 32 or v == 28:
                if v == 28:
                    st.append(struct.unpack_from(">h", code, p)[0] << 16)
                    p += 2
                elif v <= 246:
                    st.append((v - 139) << 16)
                elif v <= 250:
                    st.append(((v - 247) * 256 + code[p] + 108) << 16)
                    p += 1
                elif v <= 254:
                    st.append((-(v - 251) * 256 - code[p] - 108) << 16)
                    p += 1
                else:
                    st.append(struct.unpack_from(">i", code, p)[0])
                    p += 4
                continue
            if v in (1, 3, 18, 23):  # stems
                self._width(len(st) % 2 == 1, priv)
                self.nstems += len(st) // 2
                st.clear()
            elif v in (19, 20):  # hintmask, cntrmask
                self._width(len(st) % 2 == 1, priv)
                self.nstems += len(st) // 2
                st.clear()
                p += (self.nstems + 7) // 8
            elif v == 21:
                self._width(len(st) > 2, priv)
                o.move(st[-2], st[-1])
                st.clear()
            elif v == 22:
                self._width(len(st) > 1, priv)
                o.move(st[-1], 0)
                st.clear()
            elif v == 4:
                self._width(len(st) > 1, priv)
                o.move(0, st[-1])
                st.clear()
            elif v == 5:
                for i in range(0, len(st) - 1, 2):
                    o.line(st[i], st[i + 1])
                st.clear()
            elif v in (6, 7):
                horiz = v == 6
                for a in st:
                    o.line(a, 0) if horiz else o.line(0, a)
                    horiz = not horiz
                st.clear()
            elif v == 8:
                for i in range(0, len(st) - 5, 6):
                    o.curve(*st[i:i + 6])
                st.clear()
            elif v == 24:  # rcurveline
                k = 0
                while k + 6 <= len(st) - 2:
                    o.curve(*st[k:k + 6])
                    k += 6
                o.line(st[k], st[k + 1])
                st.clear()
            elif v == 25:  # rlinecurve
                k = 0
                while k + 2 <= len(st) - 6:
                    o.line(st[k], st[k + 1])
                    k += 2
                o.curve(*st[k:k + 6])
                st.clear()
            elif v == 26:  # vvcurveto
                k = 0
                dx1 = 0
                if len(st) % 2:
                    dx1 = st[0]
                    k = 1
                while k + 4 <= len(st):
                    o.curve(dx1, st[k], st[k + 1], st[k + 2], 0, st[k + 3])
                    dx1 = 0
                    k += 4
                st.clear()
            elif v == 27:  # hhcurveto
                k = 0
                dy1 = 0
                if len(st) % 2:
                    dy1 = st[0]
                    k = 1
                while k + 4 <= len(st):
                    o.curve(st[k], dy1, st[k + 1], st[k + 2], st[k + 3], 0)
                    dy1 = 0
                    k += 4
                st.clear()
            elif v in (30, 31):  # vhcurveto, hvcurveto
                horiz = v == 31
                k = 0
                m = len(st)
                while k + 4 <= m:
                    last = k + 4 == m - 1
                    extra = st[k + 4] if last else 0
                    if horiz:
                        o.curve(st[k], 0, st[k + 1], st[k + 2], extra, st[k + 3])
                    else:
                        o.curve(0, st[k], st[k + 1], st[k + 2], st[k + 3], extra)
                    horiz = not horiz
                    k += 5 if last else 4
                st.clear()
            elif v in (10, 29):  # callsubr, callgsubr
                subrs = priv["subrs"] if v == 10 else self.font.gsubrs
                idx = (st.pop() >> 16) + _bias(len(subrs))
                if not 0 <= idx < len(subrs):
                    raise ValueError("charstring calls a missing subr %d" % idx)
                self.run(subrs[idx], priv, depth + 1)
            elif v == 11:
                return
            elif v == 14:  # endchar
                self._width(len(st) in (1, 5), priv)
                if len(st) == 4:
                    self._seac(*st, priv=priv, depth=depth)
                o.close()
                self.done = True
                return
            elif v == 12:
                e = code[p]
                p += 1
                self._escape(e)
            else:
                raise ValueError("unknown charstring operator %d" % v)

    def _seac(self, adx, ady, bchar, achar, priv, depth) -> None:
        f = self.font
        base = f.gid_of_name(STANDARD_ENCODING[(bchar >> 16) & 255])
        acc = f.gid_of_name(STANDARD_ENCODING[(achar >> 16) & 255])
        if base < 0 or acc < 0:
            raise ValueError("seac names a glyph the font lacks")
        for gid, (dx, dy) in ((base, (0, 0)), (acc, (adx, ady))):
            sub = Outline()
            _Type2(f, sub).run(f.charstrings[gid], f.private_of(gid), depth + 1)
            sub.close()
            for c in sub.contours:
                self.o.contours.append([(x + dx, y + dy, t) for x, y, t in c])

    def _escape(self, e: int) -> None:
        o, st = self.o, self.stack
        if e == 35:  # flex
            o.curve(*st[0:6])
            o.curve(*st[6:12])
        elif e == 34:  # hflex
            dx1, dx2, dy2, dx3, dx4, dx5, dx6 = st[:7]
            o.curve(dx1, 0, dx2, dy2, dx3, 0)
            o.curve(dx4, 0, dx5, -dy2, dx6, 0)
        elif e == 36:  # hflex1
            dx1, dy1, dx2, dy2, dx3, dx4, dx5, dy5, dx6 = st[:9]
            o.curve(dx1, dy1, dx2, dy2, dx3, 0)
            o.curve(dx4, 0, dx5, dy5, dx6, -(dy1 + dy2 + dy5))
        elif e == 37:  # flex1
            d = st[:11]
            sx = d[0] + d[2] + d[4] + d[6] + d[8]
            sy = d[1] + d[3] + d[5] + d[7] + d[9]
            o.curve(*d[0:6])
            if abs(sx) > abs(sy):
                o.curve(d[6], d[7], d[8], d[9], d[10], -sy)
            else:
                o.curve(d[6], d[7], d[8], d[9], -sx, d[10])
        elif e == 9:
            st.append(abs(st.pop()))
            return
        elif e == 10:
            b_, a = st.pop(), st.pop()
            st.append(a + b_)
            return
        elif e == 11:
            b_, a = st.pop(), st.pop()
            st.append(a - b_)
            return
        elif e == 12:
            b_, a = st.pop(), st.pop()
            st.append(divfix(a, b_))
            return
        elif e == 14:
            st.append(-st.pop())
            return
        elif e == 24:
            b_, a = st.pop(), st.pop()
            st.append(mulfix(a, b_))
            return
        elif e == 18:
            st.pop()
            return
        elif e == 27:
            st.append(st[-1])
            return
        elif e == 28:
            st[-1], st[-2] = st[-2], st[-1]
            return
        elif e == 20:
            i = st.pop() >> 16
            self.trans[i] = st.pop()
            return
        elif e == 21:
            st.append(self.trans.get(st.pop() >> 16, 0))
            return
        elif e == 0:  # dotsection (Type1 leftover)
            pass
        else:
            raise ValueError("unsupported charstring operator 12 %d" % e)
        st.clear()
