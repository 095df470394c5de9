"""Font programs built in code for the text tests: TrueType, OpenType CFF,
bare CFF and Type1, from seeded random outlines. fontTools writes the sfnt
and CFF programs; the Type1 writer is here (cleartext, then the eexec part
in binary, as a PDF's FontFile holds it).

Every face is one FreeType draws without moving a point (see
``rapiddoc_tpu_torch/pdfio/ft_face.py``): a TrueType font gets an ``fpgm``
table and no glyph instructions (without ``fpgm`` FreeType autohints it);
CFF and Type1 glyphs get no stem hints.
"""
from __future__ import annotations

import io

import numpy as np
from fontTools.fontBuilder import FontBuilder
from fontTools.pens.t2CharStringPen import T2CharStringPen
from fontTools.pens.ttGlyphPen import TTGlyphPen
from fontTools.ttLib import TTFont, newTable
from fontTools.ttLib.tables import ttProgram

NOTDEF_BOX = [("move", (100, 0)), ("line", (100, 700)), ("line", (500, 700)), ("line", (500, 0)),
              ("close",), ("move", (150, 50)), ("line", (450, 50)), ("line", (450, 650)),
              ("line", (150, 650)), ("close",)]


def random_glyph(rng, cubic: bool = False, n_contours: int | None = None, scale: float = 1.0) -> list:
    """Pen operations of a random glyph: 1-3 closed contours of lines and
    quadratic (or cubic) curves, some contours reversed."""
    ops = []
    for c in range(n_contours or int(rng.integers(1, 4))):
        cx, cy = rng.uniform(150, 850), rng.uniform(0, 700)
        r = rng.uniform(80, 300)
        n = int(rng.integers(3, 8))
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        pts = [(int(scale * (cx + r * np.cos(a) * rng.uniform(.5, 1.2))),
                int(scale * (cy + r * np.sin(a) * rng.uniform(.5, 1.2)))) for a in ang]
        if c % 2:
            pts = pts[::-1]
        ops.append(("move", pts[0]))
        for i in range(1, n + 1):
            p, q = pts[i % n], pts[i - 1]
            k = int(rng.integers(0, 3))
            if k == 0:
                ops.append(("line", p))
            elif cubic:
                c1 = (int(q[0] + rng.uniform(-150, 150)), int(q[1] + rng.uniform(-150, 150)))
                c2 = (int(p[0] + rng.uniform(-150, 150)), int(p[1] + rng.uniform(-150, 150)))
                ops.append(("curve", c1, c2, p))
            else:
                m = int(rng.integers(1, 4))
                offs = [(int(q[0] + (p[0] - q[0]) * (j + 1) / (m + 1) + rng.uniform(-150, 150)),
                         int(q[1] + (p[1] - q[1]) * (j + 1) / (m + 1) + rng.uniform(-150, 150)))
                        for j in range(m)]
                ops.append(("qcurve", *offs, p))
        ops.append(("close",))
    return ops


def draw(pen, ops) -> None:
    for op in ops:
        if op[0] == "move":
            pen.moveTo(op[1])
        elif op[0] == "line":
            pen.lineTo(op[1])
        elif op[0] == "qcurve":
            pen.qCurveTo(*op[1:])
        elif op[0] == "curve":
            pen.curveTo(*op[1:])
        elif op[0] == "close":
            pen.closePath()


def _finish(fb: FontBuilder, family: str) -> None:
    fb.setupHorizontalHeader(ascent=800, descent=-200)
    fb.setupNameTable({"familyName": family, "styleName": "Regular"})
    fb.setupOS2(sTypoAscender=800, sTypoDescender=-200, usWinAscent=800, usWinDescent=200)
    fb.setupPost()


def build_ttf(glyphs: dict, cmap: dict, *, notdef: list | None = NOTDEF_BOX,
              advances: dict | None = None, composites: dict | None = None,
              cmap_tables: list | None = None, family: str = "CodeTT") -> bytes:
    """A TrueType font: ``glyphs`` name -> pen ops, ``cmap`` code point ->
    name, ``composites`` name -> [(component, dx, dy)], ``cmap_tables``
    [(platform, encoding, format, {code: name})] replacing the default."""
    names = [".notdef"] + list(glyphs) + list(composites or {})
    fb = FontBuilder(1000, isTTF=True)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap(dict(cmap))
    out = {}
    pen = TTGlyphPen(None)
    draw(pen, notdef or [])
    out[".notdef"] = pen.glyph()
    for n, ops in glyphs.items():
        pen = TTGlyphPen(None)
        draw(pen, ops)
        out[n] = pen.glyph()
    fb.setupGlyf(out)
    glyf = fb.font["glyf"]
    for n, comps in (composites or {}).items():
        pen = TTGlyphPen(glyf)
        for comp, dx, dy in comps:
            pen.addComponent(comp, (1, 0, 0, 1, dx, dy))
        g = pen.glyph()
        for c in g.components:
            c.flags &= ~0x4  # no ROUND_XY_TO_GRID
        glyf[n] = g
        g.recalcBounds(glyf)
    adv = advances or {}
    fb.setupHorizontalMetrics({n: (adv.get(n, 600), getattr(glyf[n], "xMin", 0)) for n in names})
    _finish(fb, family)
    t = newTable("fpgm")
    t.program = ttProgram.Program()
    t.program.fromBytecode(b"\xb0\x00\x21")  # PUSHB[0] 0, POP
    fb.font["fpgm"] = t
    if cmap_tables is not None:
        from fontTools.ttLib.tables._c_m_a_p import CmapSubtable

        subs = []
        for pid, eid, fmt, mapping in cmap_tables:
            st = CmapSubtable.newSubtable(fmt)
            st.platformID, st.platEncID, st.language = pid, eid, 0
            st.cmap = dict(mapping)
            subs.append(st)
        fb.font["cmap"].tables = subs
    return save(fb)


def _t2_charstrings(glyphs: dict, notdef, advances: dict):
    cs = {}
    for n, ops in [(".notdef", notdef or [])] + list(glyphs.items()):
        pen = T2CharStringPen(advances.get(n, 600), None)
        draw(pen, ops)
        cs[n] = pen.getCharString()
    return cs


def build_otf(glyphs: dict, cmap: dict, *, notdef: list | None = NOTDEF_BOX,
              advances: dict | None = None, bare: bool = False, family: str = "CodeCFF") -> bytes:
    """An OpenType CFF font (or, with ``bare``, its CFF table alone: a
    PDF's FontFile3 of Subtype Type1C)."""
    names = [".notdef"] + list(glyphs)
    adv = advances or {}
    fb = FontBuilder(1000, isTTF=False)
    fb.setupGlyphOrder(names)
    fb.setupCharacterMap(dict(cmap))
    fb.setupCFF(family, {"FullName": family}, _t2_charstrings(glyphs, notdef, adv), {})
    fb.setupHorizontalMetrics({n: (adv.get(n, 600), 0) for n in names})
    _finish(fb, family)
    if bare:
        return fb.font["CFF "].compile(fb.font)
    return save(fb)


# ---------------------------------------------------------------- Type1

def _t1_num(v: int) -> bytes:
    if -107 <= v <= 107:
        return bytes([v + 139])
    if 108 <= v <= 1131:
        v -= 108
        return bytes([(v >> 8) + 247, v & 255])
    if -1131 <= v <= -108:
        v = -v - 108
        return bytes([(v >> 8) + 251, v & 255])
    return b"\xff" + int(v).to_bytes(4, "big", signed=True)


_T1_OPS = {"hstem": b"\x01", "vstem": b"\x03", "vmoveto": b"\x04", "rlineto": b"\x05",
           "hlineto": b"\x06", "vlineto": b"\x07", "rrcurveto": b"\x08", "closepath": b"\x09",
           "callsubr": b"\x0a", "return": b"\x0b", "hsbw": b"\x0d", "endchar": b"\x0e",
           "rmoveto": b"\x15", "hmoveto": b"\x16", "vhcurveto": b"\x1e", "hvcurveto": b"\x1f",
           "seac": b"\x0c\x06", "div": b"\x0c\x0c", "callothersubr": b"\x0c\x10",
           "pop": b"\x0c\x11", "setcurrentpoint": b"\x0c\x21", "dotsection": b"\x0c\x00"}


def t1_charstring(prog: list) -> bytes:
    out = b""
    for tok in prog:
        out += _T1_OPS[tok] if isinstance(tok, str) else _t1_num(int(tok))
    return out


def _encrypt(data: bytes, r: int) -> bytes:
    out = bytearray()
    for c in data:
        e = c ^ (r >> 8)
        out.append(e)
        r = ((e + r) * 52845 + 22719) & 0xFFFF
    return bytes(out)


def t1_program(ops, width: int = 600, flex_at: int | None = None) -> list:
    """Type1 charstring tokens for pen ops (lines and cubics), relative
    moves; ``flex_at`` turns the curve pair after that op index into a
    flex (the seven rmoveto points through Subrs 1, 2 and 0)."""
    prog = [0, width, "hsbw"]
    x = y = 0
    start = None
    i = 0
    while i < len(ops):
        op = ops[i]
        if op[0] == "move":
            px, py = op[1]
            prog += [px - x, py - y, "rmoveto"]
            x, y = px, py
            start = (x, y)
        elif op[0] == "line":
            px, py = op[1]
            prog += [px - x, py - y, "rlineto"]
            x, y = px, py
        elif op[0] == "curve":
            if flex_at is not None and i == flex_at and i + 1 < len(ops) and ops[i + 1][0] == "curve":
                a, b = op, ops[i + 1]
                pts = [a[1], a[2], a[3], b[1], b[2], b[3]]
                ref = a[3]
                prog += [1, "callsubr", ref[0] - x, ref[1] - y, "rmoveto", 2, "callsubr"]
                cx, cy = ref
                for p in pts:
                    prog += [p[0] - cx, p[1] - cy, "rmoveto", 2, "callsubr"]
                    cx, cy = p
                prog += [50, b[3][0], b[3][1], 0, "callsubr"]
                x, y = b[3]
                i += 2
                continue
            (c1x, c1y), (c2x, c2y), (px, py) = op[1], op[2], op[3]
            prog += [c1x - x, c1y - y, c2x - c1x, c2y - c1y, px - c2x, py - c2y, "rrcurveto"]
            x, y = px, py
        elif op[0] == "close":
            # a line back to the start first: closepath leaves the current
            # point where it is
            if start is not None and (x, y) != start:
                prog += [start[0] - x, start[1] - y, "rlineto"]
                x, y = start
            prog += ["closepath"]
        i += 1
    return prog + ["endchar"]


def build_type1(charstrings: dict, *, encoding: dict | None = None, name: str = "CodeType1",
                len_iv: int = 4) -> bytes:
    """A Type1 program: ``charstrings`` name -> token list (see
    ``t1_program``); ``encoding`` code -> name (StandardEncoding when
    None). Subrs 0-3 are the standard flex and hint-replacement subrs."""
    subrs = [
        [3, 0, "callothersubr", "pop", "pop", "setcurrentpoint", "return"],
        [0, 1, "callothersubr", "return"],
        [0, 2, "callothersubr", "return"],
        ["return"],
    ]
    iv = b"\x00" * len_iv

    def enc_cs(tokens):
        return _encrypt(iv + t1_charstring(tokens), 4330)

    if encoding is None:
        enc = b"/Encoding StandardEncoding def\n"
    else:
        enc = b"/Encoding 256 array\n0 1 255 {1 index exch /.notdef put} for\n"
        for code, gname in sorted(encoding.items()):
            enc += b"dup %d /%s put\n" % (code, gname.encode())
        enc += b"readonly def\n"
    clear = (b"%!PS-AdobeFont-1.0: " + name.encode() + b"\n"
             b"12 dict begin\n/FontType 1 def\n/FontName /" + name.encode() + b" def\n"
             b"/PaintType 0 def\n/FontMatrix [0.001 0 0 0.001 0 0] readonly def\n"
             b"/FontBBox {-100 -300 1200 1000} readonly def\n" + enc
             + b"currentdict end\ncurrentfile eexec\n")
    priv = bytearray(b"dup /Private 8 dict dup begin\n/RD {string currentfile exch readstring pop} "
                     b"executeonly def\n/ND {noaccess def} executeonly def\n/NP {noaccess put} "
                     b"executeonly def\n/lenIV %d def\n/password 5839 def\n/MinFeature {16 16} def\n"
                     % len_iv)
    priv += b"/Subrs %d array\n" % len(subrs)
    for i, s in enumerate(subrs):
        c = enc_cs(s)
        priv += b"dup %d %d RD " % (i, len(c)) + c + b" NP\n"
    priv += b"ND\n2 index /CharStrings %d dict dup begin\n" % len(charstrings)
    for gname, tokens in charstrings.items():
        c = enc_cs(tokens)
        priv += b"/%s %d RD " % (gname.encode(), len(c)) + c + b" ND\n"
    priv += b"end\nend\nreadonly put\nnoaccess put\ndup /FontName get exch definefont pop\nmark currentfile closefile\n"
    body = _encrypt(b"\x00\x00\x00\x00" + bytes(priv), 55665)
    trailer = (b"0" * 64 + b"\n") * 8 + b"cleartomark\n"
    return clear + body + b"\n" + trailer


def save(f: FontBuilder) -> bytes:
    """The font's bytes, with fixed timestamps (the same bytes every run)."""
    f.font.recalcTimestamp = False
    f.font["head"].created = f.font["head"].modified = 3_000_000_000
    buf = io.BytesIO()
    f.font.save(buf)
    return buf.getvalue()


def ttfont(data: bytes) -> TTFont:
    return TTFont(io.BytesIO(data))
