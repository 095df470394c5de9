"""Type1 font programs, read as FreeType reads them.

A PDF embeds a Type1 font (``FontFile``) as its cleartext part followed by
the eexec part in binary (``Length1``/``Length2``); PFB segments and a
hexadecimal eexec part are read too. The eexec part is decrypted with
r = 55665 (its first four bytes dropped), the ``/Subrs`` and
``/CharStrings`` entries with r = 4330 (``/lenIV`` bytes dropped, none
when it is -1). The cleartext gives ``/FontMatrix`` and ``/FontBBox``;
``/Encoding`` is not read, as in ``cff``: text reaches glyphs through the
Unicode charmap of the glyph names.

Charstrings run as FreeType's ``cf2`` engine runs them, in 16.16 fixed
point like ``cff``: ``hsbw``/``sbw`` set the side bearing point and the
width; ``callothersubr`` 1, 2 and 0 collect the seven flex points and draw
their two curves (``setcurrentpoint`` then moves to the flex's end),
othersubr 3 hands the hint-replacement subr back through ``pop``, and other
othersubrs return their arguments; ``seac`` composes the base glyph and the
accent moved by ``adx - asb``; ``div`` is ``FT_DivFix``. Stem hints are
ignored (FreeType hints such a glyph: ``ft_face``).

FreeType puts ``.notdef`` at glyph 0 and builds the Unicode charmap from
the glyph names (``cff.unicode_charmap``).
"""
from __future__ import annotations

import re

from .cff import Outline, divfix, unicode_charmap
from .glyph_names import STANDARD_ENCODING

_HEX = set(b"0123456789abcdefABCDEF")


def decrypt(data: bytes, r: int, skip: int) -> bytes:
    c1, c2 = 52845, 22719
    out = bytearray(len(data))
    for i, c in enumerate(data):
        out[i] = c ^ (r >> 8)
        r = ((c + r) * c1 + c2) & 0xFFFF
    return bytes(out[skip:])


def _join_pfb(b: bytes) -> bytes:
    out = bytearray()
    p = 0
    while p + 6 <= len(b) and b[p] == 0x80 and b[p + 1] in (1, 2):
        n = int.from_bytes(b[p + 2:p + 6], "little")
        out += b[p + 6:p + 6 + n]
        p += 6 + n
    return bytes(out)


def _numbers(s: bytes) -> list[float]:
    return [float(v) for v in re.findall(rb"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?", s)]


class Type1Font:
    def __init__(self, data: bytes) -> None:
        b = bytes(data)
        if b[:2] == b"\x80\x01":
            b = _join_pfb(b)
        if not (b.startswith(b"%!PS-AdobeFont") or b.startswith(b"%!FontType1")
                or b.startswith(b"%!")):
            raise ValueError("not a Type1 font program")
        k = b.find(b"eexec")
        if k < 0:
            raise ValueError("Type1 program without eexec")
        clear = b[:k]
        p = k + 5
        while p < len(b) and b[p] in b" \t\r\n":
            p += 1
        enc = b[p:]
        if len(enc) >= 4 and all(c in _HEX for c in enc[:4]):
            hexd = bytes(c for c in enc if c in _HEX)
            enc = bytes.fromhex(hexd[:len(hexd) // 2 * 2].decode())
        priv = decrypt(enc, 55665, 4)
        self.font_matrix = (0.001, 0.0, 0.0, 0.001, 0.0, 0.0)
        m = re.search(rb"/FontMatrix\s*[\[{]([^\]}]*)[\]}]", clear)
        if m:
            v = _numbers(m.group(1))
            if len(v) == 6:
                self.font_matrix = tuple(v)
        self.bbox = (0, 0, 0, 0)
        m = re.search(rb"/FontBBox\s*[\[{]([^\]}]*)[\]}]", clear)
        if m:
            v = _numbers(m.group(1))
            if len(v) == 4:
                self.bbox = tuple(int(x) for x in v)
        m = re.search(rb"/lenIV\s+(-?\d+)", priv)
        self.len_iv = int(m.group(1)) if m else 4
        self.subrs = self._subrs(priv)
        names, codes = self._charstrings(priv)
        if ".notdef" in names and names[0] != ".notdef":
            i = names.index(".notdef")
            names[0], names[i] = names[i], names[0]
            codes[0], codes[i] = codes[i], codes[0]
        if not names:
            raise ValueError("Type1 program without CharStrings")
        self.glyph_names = names
        self.charstrings = codes
        self.num_glyphs = len(names)
        self._by_name = {n: i for i, n in enumerate(names)}
        self._cache: dict[int, Outline] = {}

    def _decrypt_cs(self, raw: bytes) -> bytes:
        if self.len_iv < 0:
            return raw
        return decrypt(raw, 4330, self.len_iv)

    def _subrs(self, priv: bytes) -> list[bytes]:
        m = re.search(rb"/Subrs\s+(\d+)\s+array", priv)
        if not m:
            return []
        out = [b""] * int(m.group(1))
        p = m.end()
        rx = re.compile(rb"dup\s+(\d+)\s+(\d+)\s+(\S+)\s")
        while True:
            mm = rx.match(priv, p) or rx.search(priv, p, p + 64)
            if not mm or mm.group(3) not in (b"RD", b"-|"):
                break
            idx, n = int(mm.group(1)), int(mm.group(2))
            start = mm.end()
            if idx < len(out):
                out[idx] = self._decrypt_cs(priv[start:start + n])
            p = start + n
        return out

    def _charstrings(self, priv: bytes) -> tuple[list[str], list[bytes]]:
        m = re.search(rb"/CharStrings\s+\d+\s+dict\s+dup\s+begin", priv)
        if not m:
            return [], []
        names, codes = [], []
        p = m.end()
        rx = re.compile(rb"\s*/([^\s/\[\]{}()<>]+)\s+(\d+)\s+(\S+)\s")
        while True:
            mm = rx.match(priv, p)
            if not mm or mm.group(3) not in (b"RD", b"-|"):
                break
            n = int(mm.group(2))
            start = mm.end()
            names.append(mm.group(1).decode("latin-1"))
            codes.append(self._decrypt_cs(priv[start:start + n]))
            p = start + n
            q = re.compile(rb"\s*(ND|\|-|noaccess\s+def)").match(priv, p)
            if q:
                p = q.end()
        return names, codes

    def unicode_charmap(self) -> dict[int, int]:
        return unicode_charmap(self.glyph_names)

    def gid_of_name(self, name: str) -> int:
        return self._by_name.get(name, -1)

    def outline(self, gid: int) -> Outline:
        o = self._cache.get(gid)
        if o is None:
            o = Outline()
            o.width = 0
            if 0 <= gid < self.num_glyphs:
                _Type1(self, o).run(self.charstrings[gid], 0)
            o.close()
            self._cache[gid] = o
        return o


class _Type1:
    def __init__(self, font: Type1Font, out: Outline) -> None:
        self.font = font
        self.o = out
        self.st: list[int] = []
        self.ps: list[int] = []
        self.flex: list | None = None
        self.done = False

    def run(self, code: bytes, depth: int) -> None:
        if depth > 10:
            raise ValueError("Type1 subrs nest too deep")
        o, st = self.o, self.st
        p, n = 0, len(code)
        while p < n and not self.done:
            v = code[p]
            p += 1
            if v >= 32:
                if v <= 246:
                    st.append((v - 139) << 16)
                elif v <= 250:
                    st.append(((v - 247) * 256 + code[p] + 108) << 16)
                    p += 1
                elif v <= 254:
                    st.append((-(v - 251) * 256 - code[p] - 108) << 16)
                    p += 1
                else:
                    st.append(int.from_bytes(code[p:p + 4], "big", signed=True) << 16)
                    p += 4
                continue
            if v == 12:
                e = code[p]
                p += 1
                self._escape(e, depth)
                continue
            if v in (1, 3):  # stems: ignored
                pass
            elif v == 13:  # hsbw
                o.x, o.y = st[0], 0
                o.width = st[1]
            elif v == 21:
                self._move(st[-2], st[-1])
            elif v == 22:
                self._move(st[-1], 0)
            elif v == 4:
                self._move(0, st[-1])
            elif v == 5:
                o.line(st[0], st[1])
            elif v == 6:
                o.line(st[0], 0)
            elif v == 7:
                o.line(0, st[0])
            elif v == 8:
                o.curve(*st[:6])
            elif v == 30:
                o.curve(0, st[0], st[1], st[2], st[3], 0)
            elif v == 31:
                o.curve(st[0], 0, st[1], st[2], 0, st[3])
            elif v == 9:
                o.close()
            elif v == 10:
                idx = st.pop() >> 16
                subrs = self.font.subrs
                if not 0 <= idx < len(subrs):
                    raise ValueError("Type1 charstring calls a missing subr %d" % idx)
                self.run(subrs[idx], depth + 1)
                continue
            elif v == 11:
                return
            elif v == 14:
                o.close()
                self.done = True
                return
            else:
                raise ValueError("unknown Type1 charstring operator %d" % v)
            st.clear()

    def _move(self, dx: int, dy: int) -> None:
        if self.flex is not None:
            self.o.x += dx
            self.o.y += dy
            return
        self.o.move(dx, dy)

    def _escape(self, e: int, depth: int) -> None:
        o, st = self.o, self.st
        if e == 12:  # div
            b_, a = st.pop(), st.pop()
            st.append(divfix(a, b_))
            return
        if e == 16:  # callothersubr
            num = st.pop() >> 16
            cnt = st.pop() >> 16
            args = [st.pop() for _ in range(cnt)][::-1]
            if num == 1:
                self.flex = []
            elif num == 2 and self.flex is not None:
                self.flex.append((o.x, o.y))
            elif num == 0 and self.flex is not None:
                pts = self.flex
                self.flex = None
                if len(pts) < 7:
                    raise ValueError("Type1 flex with %d points" % len(pts))
                # pts[0] is the reference point; start from before the flex
                x0, y0 = self._flex_start
                o.x, o.y = x0, y0
                p = pts[1:7]
                o.curve(p[0][0] - x0, p[0][1] - y0, p[1][0] - p[0][0], p[1][1] - p[0][1],
                        p[2][0] - p[1][0], p[2][1] - p[1][1])
                o.curve(p[3][0] - p[2][0], p[3][1] - p[2][1], p[4][0] - p[3][0],
                        p[4][1] - p[3][1], p[5][0] - p[4][0], p[5][1] - p[4][1])
                self.ps.extend([args[2], args[1]] if len(args) >= 3 else args[::-1])
                return
            elif num == 3:
                # hint replacement: pop hands back subr 3, which is empty
                self.ps.append(3 << 16)
                return
            else:
                self.ps.extend(args[::-1])
                return
            if num == 1:
                self._flex_start = (o.x, o.y)
            return
        if e == 17:  # pop
            st.append(self.ps.pop() if self.ps else 0)
            return
        if e == 33:  # setcurrentpoint
            o.x, o.y = st[0], st[1]
        elif e == 7:  # sbw
            o.x, o.y = st[0], st[1]
            o.width = st[2]
        elif e in (0, 1, 2):  # dotsection, vstem3, hstem3: ignored
            pass
        elif e == 6:  # seac
            asb, adx, ady, bchar, achar = st[:5]
            self._seac(asb, adx, ady, bchar >> 16, achar >> 16, depth)
            self.done = True
            return
        else:
            raise ValueError("unsupported Type1 charstring operator 12 %d" % e)
        st.clear()

    def _seac(self, asb, adx, ady, bchar, achar, depth) -> None:
        f = self.font
        width = self.o.width
        base = f.gid_of_name(STANDARD_ENCODING[bchar & 255])
        acc = f.gid_of_name(STANDARD_ENCODING[achar & 255])
        if base < 0 or acc < 0:
            raise ValueError("seac names a glyph the font lacks")
        self.o.close()
        for gid, off in ((base, (0, 0)), (acc, (adx - asb, ady))):
            sub = Outline()
            sub.width = 0
            _Type1(f, sub).run(f.charstrings[gid], depth + 1)
            sub.close()
            for c in sub.contours:
                self.o.contours.append([(x + off[0], y + off[1], t) for x, y, t in c])
        self.o.width = width
