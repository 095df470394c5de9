"""Text drawn from font programs and system fonts through the port's
renderer and ``RapidDoc()``, against the JAX package, on the CPU.

The fixture (``rapiddoc_tpu_torch/assets/text_smoke_doc.pdf``) is written
by ``make_text_doc()``: three US Letter pages whose text uses fonts built
here with fontTools from the outlines of the DejaVu fonts matplotlib
bundles (no instructions, no stem hints: faces FreeType draws unhinted,
see ``rapiddoc_tpu_torch/pdfio/ft_face.py``):

- F1, an embedded TrueType subset (``FontFile2``, a (3, 1) cmap, simple
  ``Tf``/``Tj``, WinAnsi);
- F2, a Type0/Identity-H CID font with ``FontFile2`` whose only cmap is a
  symbol (3, 0) one, so every character is glyph 0, a box PIL draws (a
  ToUnicode entry maps one CID to "fi": a two-glyph run);
- F3, a ``FontFile3`` Type1C (bare CFF) font whose charset lacks some
  letters, which then fall back to the system font (its ``.notdef`` is
  empty);
- F4, a ``FontFile`` Type1 font (cleartext and binary eexec), with a flex
  and a ``seac`` accent;
- F5, base-14 Helvetica with no program (the system fallback font), and
  F6, a Type3 font whose codes have no CharProc (also the fallback);
- text turned by 30 and 90 degrees, fill alpha 0.5, render modes 0-3.

The golden (``text_smoke_golden.json``) is the JAX package's reading with
``RAPIDDOC_FALLBACK_FONT`` set to a file holding F1's program (so the
fallback is the same unhinted face here and on a machine without fonts):
each page's raster sha256 at 200 and 72 dpi, the text dicts, and
``classify_pdf``; the fp32 "ocr" parses with the int8 formula head off and
on and the fp32 "txt" parse; the bf16 "ocr" parse with the int8 head (for
``chip_smoke.py``). Two hinted cases hold the port to bands: the fallback
left to the host (DejaVu Sans here, hinted by its bytecode), and no
fallback font at all (``ImageFont.load_default()``: Aileron at 10 px,
autohinted), whose JAX rasters at 72 dpi are kept in
``text_smoke_band.npz`` as grey arrays for ``chip_smoke.py``.

``python tests/test_torch_text.py`` rebuilds the fixture, the golden and
the band arrays with the JAX package (needs PIL, fontTools and matplotlib;
a few minutes) and prints the port's readings against them.
"""
import hashlib
import json
import os
import sys
import tempfile
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_table as tt  # noqa: E402
import torch_font_programs as fb  # noqa: E402
from test_torch_image_inputs import assert_same_parse, clean_env, summary  # noqa: E402
from test_torch_vector import _text_lines  # noqa: E402

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "text_smoke_doc.pdf"
GOLDEN_JSON = ASSETS / "text_smoke_golden.json"
BAND_NPZ = ASSETS / "text_smoke_band.npz"
DPIS = (200, 72)
PARSE_ENV = {"RAPIDDOC_DEMO_LAYOUT": "1"}
MODES = {
    # name: (parse_method, environment beyond PARSE_ENV)
    "ocr_fp32": ("ocr", {"RAPIDDOC_FP32_PARAMS": "1"}),
    "ocr_fp32_int8": ("ocr", {"RAPIDDOC_FP32_PARAMS": "1", "RAPIDDOC_INT8_HEAD": "1"}),
    "txt_fp32": ("txt", {"RAPIDDOC_FP32_PARAMS": "1"}),
    "ocr_bf16_int8": ("ocr", {"RAPIDDOC_INT8_HEAD": "1"}),
}
# the hinted cases: the fallback font each one gives the JAX package
BANDS = ("dejavu", "aileron")
# measured on the CPU at 72 dpi (compare()): over the pixels either raster
# inks, the largest page's mean absolute difference and share more than 64
# apart were 7.82 and 0.035 (DejaVu), 27.24 and 0.197 (Aileron at 10 px)
RASTER_BAND = {"dejavu": (10.0, 0.05), "aileron": (32.0, 0.25)}
# the "ocr" parse against the JAX package's: Markdown CER 0.073 and 0.238
# measured, and the largest gap in a page's det count 1 and 6 (the demo
# weights' layout model and OCR detector turn or add dets where the hinted
# glyphs differ)
OCR_CER_BAND = {"dejavu": 0.10, "aileron": 0.30}
OCR_DET_COUNT_GAP = {"dejavu": 2, "aileron": 8}
BOX_TOL_PT = 1.0

ASCII = "".join(chr(c) for c in range(0x20, 0x7F))


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


# ------------------------------------------------------------------- fonts

def _dejavu(name: str):
    import matplotlib
    from fontTools.ttLib import TTFont

    return TTFont(Path(matplotlib.get_data_path()) / "fonts" / "ttf" / name)


def _glyph_ops(font, ch: str, scale: float = 1.0, cubic: bool = False):
    """Pen ops of ``ch``'s glyph (components decomposed), scaled and
    rounded; quadratic curves raised to cubics when ``cubic``."""
    from fontTools.pens.basePen import BasePen
    from fontTools.pens.recordingPen import DecomposingRecordingPen

    gs = font.getGlyphSet()
    name = font.getBestCmap().get(ord(ch))
    if name is None:
        return None, 0
    rec = DecomposingRecordingPen(gs)
    gs[name].draw(rec)
    adv = int(round(font["hmtx"][name][0] * scale))

    def r(p):
        return (int(round(p[0] * scale)), int(round(p[1] * scale)))

    if not cubic:
        ops = []
        for op, args in rec.value:
            if op == "moveTo":
                ops.append(("move", r(args[0])))
            elif op == "lineTo":
                ops.append(("line", r(args[0])))
            elif op == "qCurveTo":
                ops.append(("qcurve", *[None if a is None else r(a) for a in args]))
            elif op == "closePath":
                ops.append(("close",))
        return ops, adv

    class Cubic(BasePen):
        def __init__(self):
            super().__init__(None)
            self.ops = []

        def _moveTo(self, p):
            self.ops.append(("move", r(p)))

        def _lineTo(self, p):
            self.ops.append(("line", r(p)))

        def _curveToOne(self, a, b, c):
            self.ops.append(("curve", r(a), r(b), r(c)))

        def _closePath(self):
            self.ops.append(("close",))

    pen = Cubic()
    rec.replay(pen)
    return pen.ops, adv


def _draw_none_ok(pen, ops):
    for op in ops:
        if op[0] == "qcurve" and op[-1] is None:
            pen.qCurveTo(*op[1:])
        else:
            fb.draw(pen, [op])


def f1_program() -> bytes:
    """F1: DejaVu Sans outlines for printable ASCII, an unhinted TrueType
    font with a (3, 1) cmap (also the exact golden's fallback font)."""
    src = _dejavu("DejaVuSans.ttf")
    glyphs, adv = {}, {}
    for ch in ASCII:
        ops, a = _glyph_ops(src, ch)
        name = "g%02X" % ord(ch)
        glyphs[name], adv[name] = ops or [], a
    return _ttf(glyphs, {ord(ch): "g%02X" % ord(ch) for ch in ASCII}, adv, upem=2048)


def _ttf(glyphs, cmap, adv, upem=2048, cmap_tables=None, family="CodeSans") -> bytes:
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.ttGlyphPen import TTGlyphPen
    from fontTools.ttLib import newTable
    from fontTools.ttLib.tables import ttProgram

    names = [".notdef"] + list(glyphs)
    f = FontBuilder(upem, isTTF=True)
    f.setupGlyphOrder(names)
    f.setupCharacterMap(cmap)
    out = {}
    box = [(op[0], *[(int(p[0] * upem / 1000), int(p[1] * upem / 1000)) for p in op[1:]])
           for op in fb.NOTDEF_BOX]
    for n, ops in [(".notdef", box)] + list(glyphs.items()):
        pen = TTGlyphPen(None)
        _draw_none_ok(pen, ops)
        out[n] = pen.glyph()
    f.setupGlyf(out)
    adv = dict(adv, **{".notdef": int(600 * upem / 1000)})
    f.setupHorizontalMetrics({n: (adv.get(n, 0), getattr(f.font["glyf"][n], "xMin", 0))
                              for n in names})
    f.setupHorizontalHeader(ascent=int(0.93 * upem), descent=-int(0.24 * upem))
    f.setupNameTable({"familyName": family, "styleName": "Regular"})
    f.setupOS2(sTypoAscender=int(0.76 * upem), sTypoDescender=-int(0.24 * upem),
               usWinAscent=int(0.93 * upem), usWinDescent=int(0.24 * upem))
    f.setupPost()
    t = newTable("fpgm")
    t.program = ttProgram.Program()
    t.program.fromBytecode(b"\xb0\x00\x21")  # PUSHB[0] 0, POP: FreeType's own hinter, no moves
    f.font["fpgm"] = t
    if cmap_tables is not None:
        from fontTools.ttLib.tables._c_m_a_p import CmapSubtable

        subs = []
        for pid, eid, fmt, mapping in cmap_tables:
            st = CmapSubtable.newSubtable(fmt)
            st.platformID, st.platEncID, st.language = pid, eid, 0
            st.cmap = dict(mapping)
            subs.append(st)
        f.font["cmap"].tables = subs
    return fb.save(f)


F2_TEXT = "Symbol cmap glyphs fi"


def f2_program() -> tuple[bytes, list[str]]:
    """F2: DejaVu Sans Bold outlines of F2_TEXT's letters and an "fi"
    glyph, glyph i = CID i, under a symbol (3, 0) cmap only."""
    src = _dejavu("DejaVuSans-Bold.ttf")
    letters = sorted(set(F2_TEXT.replace(" ", ""))) + ["fi"]
    glyphs, adv, cmap = {}, {}, {}
    for i, key in enumerate(letters):
        ch = "f" if key == "fi" else key
        ops, a = _glyph_ops(src, ch)
        name = "c%02d" % (i + 1)
        glyphs[name], adv[name] = ops or [], a
        cmap[0xF021 + i] = name
    prog = _ttf(glyphs, {}, adv, cmap_tables=[(3, 0, 4, cmap)], family="CodeSymbol")
    return prog, letters


F3_MISSING = "qxz0123456789"


def f3_program() -> bytes:
    """F3: DejaVu Sans Oblique outlines as a bare CFF (Type1C) with
    AGL glyph names; F3_MISSING and an empty .notdef."""
    from fontTools.agl import UV2AGL

    src = _dejavu("DejaVuSans-Oblique.ttf")
    glyphs, adv = {}, {}
    for ch in ASCII:
        if ch in F3_MISSING:
            continue
        ops, a = _glyph_ops(src, ch, 1000 / 2048, cubic=True)
        name = UV2AGL.get(ord(ch), "uni%04X" % ord(ch))
        glyphs[name], adv[name] = ops or [], a
    return fb.build_otf(glyphs, {}, notdef=[], advances=adv, bare=True, family="CodeOblique")


def f4_program() -> bytes:
    """F4: DejaVu Serif outlines as a Type1 program: a flex in one glyph
    and ``Aacute`` composed with ``seac``."""
    from fontTools.agl import UV2AGL

    src = _dejavu("DejaVuSerif.ttf")
    cs = {".notdef": fb.t1_program(fb.NOTDEF_BOX, width=600)}
    for ch in ASCII:
        ops, a = _glyph_ops(src, ch, 1000 / 2048, cubic=True)
        flex = None
        if ch == "o":
            flex = next(k for k in range(len(ops) - 1)
                        if ops[k][0] == "curve" and ops[k + 1][0] == "curve")
        cs[UV2AGL.get(ord(ch), "uni%04X" % ord(ch))] = fb.t1_program(ops, width=a, flex_at=flex)
    acute, a = _glyph_ops(src, "´", 1000 / 2048, cubic=True)
    cs["acute"] = fb.t1_program(acute, width=a)
    aw = int(round(src["hmtx"]["A"][0] * 1000 / 2048))
    cs["Aacute"] = [0, aw, "hsbw", 0, 150, 180, 65, 194, "seac"]
    return fb.build_type1(cs, name="CodeSerif")


# ----------------------------------------------------------------- content

def _fmt(v: float) -> str:
    return ("%.3f" % v).rstrip("0").rstrip(".")


def _esc(text: str) -> str:
    return text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def _show(font: str, size: float, x: float, y: float, text: str, pre: str = "") -> str:
    return f"BT /{font} {_fmt(size)} Tf {pre}{_fmt(x)} {_fmt(y)} Td ({_esc(text)}) Tj ET"


def _page1() -> str:
    ops = ["0 g", _show("F1", 18, 72, 730, "Text Rendering Report 2026")]
    ops.append(_show("F1", 12, 72, 700, "1 Embedded TrueType"))
    y = 684
    for line in _text_lines(21, 8, 92):
        ops.append(_show("F1", 9, 72, y, line))
        y -= 12
    ops.append(_show("F3", 12, 72, y - 8, "2 Compact font format (Type1C)"))
    y -= 26
    for line in _text_lines(22, 5, 80):
        ops.append(_show("F3", 9, 72, y, line + " quiz 2026"))
        y -= 12
    ops.append(_show("F5", 12, 72, y - 8, "3 Base-14 Helvetica without a program"))
    y -= 26
    for line in _text_lines(23, 6, 92):
        ops.append(_show("F5", 9, 72, y, line))
        y -= 12
    ops.append(_show("F1", 7, 72, 60, "Page 1 of 3. Generated by code; fonts built with fontTools."))
    return "\n".join(ops)


def _page2() -> str:
    ops = ["0 g", _show("F4", 16, 72, 730, "Type1 Serif Program with Flex and Seac")]
    y = 700
    for line in _text_lines(24, 9, 84):
        ops.append(_show("F4", 10, 72, y, line))
        y -= 14
    ops.append(_show("F4", 10, 72, y - 6, "Accented: \xc1 and \xc1ngel in a seac glyph; solo flex."))
    y -= 40
    # F2: two-byte CIDs through Identity-H
    cids = [F2_LETTERS.index(ch) + 1 if ch != " " else 0 for ch in F2_TEXT[:-3]]
    cids += [0, len(F2_LETTERS)]
    hexs = "".join("%04X" % c for c in cids)
    ops.append(f"BT /F2 14 Tf 72 {y} Td <{hexs}> Tj ET")
    ops.append(_show("F6", 12, 72, y - 30, "Type three"))
    ops.append("0.1 0.2 0.7 rg")
    ops.append(_show("F1", 11, 72, y - 60, "Coloured text in blue, then red:"))
    ops.append("0.8 0.1 0.1 rg")
    ops.append(_show("F1", 11, 260, y - 60, "alert value 42"))
    return "\n".join(ops)


def _page3() -> str:
    ops = ["0 g", _show("F1", 16, 72, 730, "Turned, Translucent and Stroked Text")]
    ops.append("BT /F1 14 Tf 0.866 0.5 -0.5 0.866 90 560 Tm (Turned by thirty degrees) Tj ET")
    ops.append("BT /F4 12 Tf 0 1 -1 0 520 420 Tm (A column turned by ninety) Tj ET")
    ops.append("q /GS0 gs 0 0.4 0 rg")
    ops.append(_show("F3", 14, 72, 470, "Half transparent Type1C text"))
    ops.append("Q")
    y = 420
    for mode in (0, 1, 2, 3):
        ops.append(_show("F1", 12, 72, y, f"Render mode {mode}: fill, stroke, both, hidden",
                         pre=f"{mode} Tr "))
        y -= 20
    ops.append(_show("F1", 6, 72, 300, "Six point text stays legible " * 2, pre="0 Tr "))
    ops.append(_show("F5", 24, 72, 250, "Large Helvetica"))
    for k, line in enumerate(_text_lines(25, 4, 70)):
        ops.append(_show("F4", 10, 72, 200 - 14 * k, line))
    return "\n".join(ops)


F2_LETTERS: list[str] = []


def make_text_doc() -> bytes:
    """The fixture PDF (see the module docstring), written by code."""
    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    N = Name
    w = PdfWriter()
    pages_ref = w.reserve()

    def stream(d: dict, data: bytes, flate: bool = True):
        d = dict(d)
        if flate:
            d[N("Filter")] = N("FlateDecode")
            data = zlib.compress(data, 9)
        return w.add(Stream(d, data))

    def widths_of(prog_adv, first=32, last=126):
        return [prog_adv(chr(c)) for c in range(first, last + 1)]

    src = _dejavu("DejaVuSans.ttf")

    def adv_sans(ch):
        name = src.getBestCmap().get(ord(ch))
        return int(round(src["hmtx"][name][0] * 1000 / 2048)) if name else 0

    f1 = f1_program()
    f1_fd = w.add({N("Type"): N("FontDescriptor"), N("FontName"): N("AAAAAA+CodeSans"),
                   N("Flags"): 32, N("FontBBox"): [-1021, -463, 1793, 1232], N("ItalicAngle"): 0,
                   N("Ascent"): 760, N("Descent"): -240, N("CapHeight"): 729, N("StemV"): 80,
                   N("FontFile2"): stream({N("Length1"): len(f1)}, f1)})
    font1 = w.add({N("Type"): N("Font"), N("Subtype"): N("TrueType"),
                   N("BaseFont"): N("AAAAAA+CodeSans"), N("FirstChar"): 32, N("LastChar"): 126,
                   N("Widths"): widths_of(adv_sans), N("FontDescriptor"): f1_fd,
                   N("Encoding"): N("WinAnsiEncoding")})

    f2, letters = f2_program()
    F2_LETTERS[:] = letters
    bold = _dejavu("DejaVuSans-Bold.ttf")
    cid_w = []
    for i, key in enumerate(letters):
        name = bold.getBestCmap()[ord(key[0])]
        cid_w += [i + 1, [int(round(bold["hmtx"][name][0] * 1000 / 2048))]]
    tu = ["/CIDInit /ProcSet findresource begin 12 dict begin begincmap",
          "/CMapName /CodeSymbol-UTF16 def /CMapType 2 def",
          "1 begincodespacerange <0000> <FFFF> endcodespacerange",
          "%d beginbfchar" % (len(letters) + 1), "<0000> <0020>"]
    for i, key in enumerate(letters):
        tu.append("<%04X> <%s>" % (i + 1, "".join("%04X" % ord(c) for c in key)))
    tu += ["endbfchar", "endcmap CMapName currentdict /CMap defineresource pop end end"]
    f2_fd = w.add({N("Type"): N("FontDescriptor"), N("FontName"): N("BBBBBB+CodeSymbol"),
                   N("Flags"): 4, N("FontBBox"): [-1069, -415, 1975, 1174], N("ItalicAngle"): 0,
                   N("Ascent"): 760, N("Descent"): -240, N("CapHeight"): 729, N("StemV"): 120,
                   N("FontFile2"): stream({N("Length1"): len(f2)}, f2)})
    cidfont = w.add({N("Type"): N("Font"), N("Subtype"): N("CIDFontType2"),
                     N("BaseFont"): N("BBBBBB+CodeSymbol"),
                     N("CIDSystemInfo"): {N("Registry"): b"Adobe", N("Ordering"): b"Identity",
                                          N("Supplement"): 0},
                     N("FontDescriptor"): f2_fd, N("DW"): 600, N("W"): cid_w,
                     N("CIDToGIDMap"): N("Identity")})
    font2 = w.add({N("Type"): N("Font"), N("Subtype"): N("Type0"),
                   N("BaseFont"): N("BBBBBB+CodeSymbol"), N("Encoding"): N("Identity-H"),
                   N("DescendantFonts"): [cidfont],
                   N("ToUnicode"): stream({}, "\n".join(tu).encode())})

    obl = _dejavu("DejaVuSans-Oblique.ttf")

    def adv_obl(ch):
        if ch in F3_MISSING:
            return 0
        name = obl.getBestCmap().get(ord(ch))
        return int(round(obl["hmtx"][name][0] * 1000 / 2048)) if name else 0

    f3 = f3_program()
    f3_fd = w.add({N("Type"): N("FontDescriptor"), N("FontName"): N("CCCCCC+CodeOblique"),
                   N("Flags"): 96, N("FontBBox"): [-1016, -350, 1659, 1068], N("ItalicAngle"): -11,
                   N("Ascent"): 760, N("Descent"): -240, N("CapHeight"): 729, N("StemV"): 80,
                   N("FontFile3"): stream({N("Subtype"): N("Type1C")}, f3)})
    font3 = w.add({N("Type"): N("Font"), N("Subtype"): N("Type1"),
                   N("BaseFont"): N("CCCCCC+CodeOblique"), N("FirstChar"): 32, N("LastChar"): 126,
                   N("Widths"): widths_of(adv_obl), N("FontDescriptor"): f3_fd,
                   N("Encoding"): N("WinAnsiEncoding")})

    serif = _dejavu("DejaVuSerif.ttf")

    def adv_serif(ch):
        name = serif.getBestCmap().get(ord(ch))
        return int(round(serif["hmtx"][name][0] * 1000 / 2048)) if name else 0

    f4 = f4_program()
    k = f4.index(b"eexec") + 6
    tail = f4.index(b"0000000000")
    f4_fd = w.add({N("Type"): N("FontDescriptor"), N("FontName"): N("DDDDDD+CodeSerif"),
                   N("Flags"): 34, N("FontBBox"): [-100, -300, 1200, 1000], N("ItalicAngle"): 0,
                   N("Ascent"): 760, N("Descent"): -240, N("CapHeight"): 729, N("StemV"): 80,
                   N("FontFile"): stream({N("Length1"): k, N("Length2"): tail - k,
                                          N("Length3"): len(f4) - tail}, f4)})
    w4 = widths_of(adv_serif, 32, 255)
    w4[0xC1 - 32] = adv_serif("A")
    font4 = w.add({N("Type"): N("Font"), N("Subtype"): N("Type1"),
                   N("BaseFont"): N("DDDDDD+CodeSerif"), N("FirstChar"): 32, N("LastChar"): 255,
                   N("Widths"): w4, N("FontDescriptor"): f4_fd,
                   N("Encoding"): N("WinAnsiEncoding")})
    font5 = w.add({N("Type"): N("Font"), N("Subtype"): N("Type1"), N("BaseFont"): N("Helvetica")})
    proc_a = stream({}, b"600 0 d0 50 0 m 300 700 l 550 0 l h f")
    diffs = [65] + [N(chr(c)) for c in range(65, 91)] + [97] + [N(chr(c)) for c in range(97, 123)]
    font6 = w.add({N("Type"): N("Font"), N("Subtype"): N("Type3"),
                   N("FontBBox"): [0, 0, 600, 700], N("FontMatrix"): [0.001, 0, 0, 0.001, 0, 0],
                   N("CharProcs"): {N("Z"): proc_a}, N("Resources"): {},
                   N("Encoding"): {N("Type"): N("Encoding"), N("Differences"): diffs},
                   N("FirstChar"): 65, N("LastChar"): 122, N("Widths"): [600] * (122 - 65 + 1)})
    resources = {N("Font"): {N("F1"): font1, N("F2"): font2, N("F3"): font3, N("F4"): font4,
                             N("F5"): font5, N("F6"): font6},
                 N("ExtGState"): {N("GS0"): {N("Type"): N("ExtGState"), N("ca"): 0.5}}}
    kids = []
    for content in (_page1(), _page2(), _page3()):
        kids.append(w.add({N("Type"): N("Page"), N("Parent"): pages_ref,
                           N("MediaBox"): [0, 0, 612, 792], N("Resources"): resources,
                           N("Contents"): stream({}, content.encode("latin-1"))}))
    w.set(pages_ref, {N("Type"): N("Pages"), N("Kids"): kids, N("Count"): len(kids)})
    root = w.add({N("Type"): N("Catalog"), N("Pages"): pages_ref})
    return w.tobytes(root)


def fallback_program(pdf: bytes) -> bytes:
    """F1's program as the port reads it from the fixture (the exact
    golden's RAPIDDOC_FALLBACK_FONT)."""
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.fonts import load_font

    doc = open_pdf(pdf)
    fonts = doc.resolve(doc.get_page(0).resources["Font"])
    return load_font(doc, doc.resolve(fonts["F1"])).font_program


# ------------------------------------------------------------------ golden

class fallback_case:
    """The fallback font of one case, for both packages: ``"exact"`` sets
    RAPIDDOC_FALLBACK_FONT to a file holding F1's program; ``"dejavu"``
    to the DejaVu Sans matplotlib bundles (hinted by its own bytecode);
    ``"aileron"`` leaves no candidate at all, so both packages draw with
    ``ImageFont.load_default()`` (Aileron at 10 px). The JAX package's
    and the port's candidate lists are found again on entry and on exit."""

    def __init__(self, case: str, pdf: bytes, **extra: str):
        self.case, self.pdf, self.extra = case, pdf, extra

    def __enter__(self):
        import matplotlib

        import rapiddoc_tpu.pdfio.render as jax_render_mod
        import rapiddoc_tpu_torch.pdfio.render as port_render_mod

        self.mods = (jax_render_mod, port_render_mod)
        self.tmp = tempfile.TemporaryDirectory()
        env = dict(self.extra)
        if self.case == "exact":
            path = Path(self.tmp.name) / "fallback.ttf"
            path.write_bytes(fallback_program(self.pdf))
            env["RAPIDDOC_FALLBACK_FONT"] = str(path)
        elif self.case == "dejavu":
            env["RAPIDDOC_FALLBACK_FONT"] = str(
                Path(matplotlib.get_data_path()) / "fonts" / "ttf" / "DejaVuSans.ttf")
        self.env = clean_env(**env)
        self.env.__enter__()
        for m in self.mods:
            m._FALLBACK_FONTS_CACHE = [] if self.case == "aileron" else None
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m._FALLBACK_FONTS_CACHE = None
        self.env.__exit__(*exc)
        self.tmp.cleanup()


def grey(img) -> np.ndarray:
    """A raster's darkest channel (what the band metrics compare)."""
    return np.asarray(img).min(axis=2)


def raster_band(got, want) -> dict:
    """Over the pixels either grey raster inks (below 250): the mean
    absolute difference and the share more than 64 apart."""
    a, b = grey(got).astype(np.int16), grey(want).astype(np.int16)
    ink = (a < 250) | (b < 250)
    d = np.abs(a - b)[ink]
    return {"ink_pixels": int(ink.sum()), "mean_abs": float(d.mean()) if d.size else 0.0,
            "share_over_64": float((d > 64).mean()) if d.size else 0.0}


def jax_render(pdf: bytes) -> dict:
    """The JAX package's page rasters (sha256) at each of DPIS, the text
    dicts and image boxes at the first, and classify_pdf."""
    from rapiddoc_tpu.pdfio import classify_pdf, open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full

    out = {"classify": classify_pdf(pdf), "pages": {}}
    doc = open_pdf(pdf)
    for dpi in DPIS:
        rows = []
        for i in range(len(doc)):
            img, text, boxes = render_page_full(doc.get_page(i), dpi=dpi)
            rows.append({"sha256": sha256(np.asarray(img))})
            if dpi == DPIS[0]:
                rows[-1].update(text=text, boxes=boxes)
        out["pages"][str(dpi)] = rows
    return out


def jax_parse(pdf: bytes, mode: str) -> dict:
    """The JAX package's parse in ``mode`` (the int8 head quantized
    eagerly first, as test_torch_vector.jax_parse does)."""
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    method, env = MODES[mode]
    ModelStack._instances.clear()
    rapid = RapidDoc()
    analyzer = ModelStack.get("ch", True, True, {
        "layout": {}, "ocr": {}, "formula": {}, "table": {}, "checkbox": {}}).analyzer
    if "INT8" in " ".join(env):
        assert analyzer.formula_model._int8_head() is not None
    got = summary(rapid(pdf, parse_method=method))
    ModelStack._instances.clear()
    return got


def make_golden(pdf: bytes) -> tuple[dict, dict]:
    """The golden and the band arrays (the aileron case's grey rasters at
    72 dpi)."""
    from rapiddoc_tpu.pdfio import open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full

    golden = {"source": "rapiddoc_tpu on the CPU: render_page_full, classify_pdf and "
                        "RapidDoc()(pdf, parse_method=...) with RAPIDDOC_DEMO_LAYOUT=1, every "
                        "stage on and RAPIDDOC_FALLBACK_FONT holding F1's program; the "
                        "bands' parses with DejaVu Sans and with no fallback font; rebuilt "
                        "by tests/test_torch_text.py"}
    with fallback_case("exact", pdf):
        golden["render"] = json.loads(json.dumps(jax_render(pdf)))
    for mode, (_, env) in MODES.items():
        with fallback_case("exact", pdf, **PARSE_ENV, **env):
            golden[mode] = jax_parse(pdf, mode)
    arrays = {}
    for case in BANDS:
        golden[case] = {}
        for mode in ("ocr_fp32", "txt_fp32"):
            with fallback_case(case, pdf, **PARSE_ENV, **MODES[mode][1]):
                golden[case][mode] = jax_parse(pdf, mode)
        if case == "aileron":
            with fallback_case(case, pdf):
                doc = open_pdf(pdf)
                for i in range(len(doc)):
                    arrays[f"page{i}"] = grey(render_page_full(doc.get_page(i), dpi=72)[0])
    return golden, arrays


def port_parse(pdf: bytes, mode: str):
    """The port's RapidDoc on the CPU in ``mode`` (inside a fallback_case)."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    method, env = MODES[mode]
    dtype = torch.float32 if "fp32" in mode else torch.bfloat16
    for k, v in env.items():
        if k != "RAPIDDOC_FP32_PARAMS":
            os.environ[k] = v
    return RapidDoc(device="cpu", dtype=dtype)(pdf, parse_method=method)


def det_rows(got: dict) -> list:
    return [[(d["category_id"], d["poly"]) for d in page] for page in got["model_info"]]


def band_parse(got: dict, want: dict) -> dict:
    """A hinted case's parse against the JAX package's: the dets' number
    and classes per page and their largest box gap in page points, the
    Markdown's CER."""
    import chip_smoke as smoke

    g, w = det_rows(got), det_rows(want)
    same = [len(a) == len(b) and [c for c, _ in a] == [c for c, _ in b] for a, b in zip(g, w)]
    count_gap = max((abs(len(a) - len(b)) for a, b in zip(g, w)), default=0)
    gap = 0.0
    for a, b in zip(g, w):
        if len(a) == len(b):
            for (_, pa), (_, pb) in zip(a, b):
                gap = max(gap, float(np.abs(np.asarray(pa) - np.asarray(pb)).max()) * 72 / 200)
    return {"pages": len(w), "same_dets": all(same) and len(g) == len(w), "box_gap_pt": gap,
            "det_count_gap": count_gap,
            "markdown_equal": got["markdown"] == want["markdown"],
            "cer": smoke.compare_markdown(got["markdown"], want["markdown"])["cer"]}


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (see
    test_torch_table.capped_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pdf() -> bytes:
    return DOC_PDF.read_bytes()


# ------------------------------------------------------------------- tests

def test_committed_fixture_is_make_text_doc(pdf):
    assert make_text_doc() == pdf
    assert len(pdf) < 1 << 20


@pytest.mark.parametrize("dpi", DPIS)
def test_pages_byte_equal_jax(pdf, golden, dpi):
    """Every page's raster equals the JAX package's (its sha256 in the
    golden, and the JAX renderer run here); text dicts equal."""
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render_page

    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    want_pages = golden["render"]["pages"][str(dpi)]
    with fallback_case("exact", pdf):
        doc, jdoc = open_pdf(pdf), jax_open(pdf)
        for i, want in enumerate(want_pages):
            img, text, boxes = render_page_full(doc.get_page(i), dpi=dpi)
            jimg, jtext, jboxes = jax_render_page(jdoc.get_page(i), dpi=dpi)
            assert np.array_equal(img, np.asarray(jimg)), (dpi, i)
            assert sha256(img) == want["sha256"]
            assert text == jtext and boxes == jboxes
            if "text" in want:
                assert json.loads(json.dumps(text)) == want["text"] and boxes == want["boxes"]


def test_classify_equal(pdf, golden):
    from rapiddoc_tpu.pdfio import classify_pdf as jax_classify

    from rapiddoc_tpu_torch.pdfio import classify_pdf

    assert classify_pdf(pdf) == jax_classify(pdf) == golden["render"]["classify"] == "txt"


@pytest.mark.parametrize("mode", ["ocr_fp32", "ocr_fp32_int8", "txt_fp32"])
def test_parse_equals_golden(pdf, golden, mode):
    """RapidDoc(device="cpu") in fp32 gives the JAX package's Markdown,
    content list, LaTeX, layout dets and span payloads."""
    with fallback_case("exact", pdf, **PARSE_ENV):
        got = summary(port_parse(pdf, mode))
    assert_same_parse(got, golden[mode])


@pytest.mark.parametrize("case", BANDS)
def test_hinted_fallback_rasters_within_band(pdf, case):
    """With a fallback face FreeType hints (DejaVu Sans; Aileron at 10 px)
    the pages differ from the JAX package's only within RASTER_BAND; the
    pages that use no fallback glyph stay byte-equal. The aileron case
    also matches the stored grey rasters chip_smoke.py checks."""
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render_page

    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    mean_max, share_max = RASTER_BAND[case]
    with fallback_case(case, pdf):
        doc, jdoc = open_pdf(pdf), jax_open(pdf)
        stored = np.load(BAND_NPZ) if case == "aileron" else None
        for i in range(len(doc)):
            img = render_page_full(doc.get_page(i), dpi=72)[0]
            jimg = np.asarray(jax_render_page(jdoc.get_page(i), dpi=72)[0])
            vs = raster_band(img, jimg)
            assert vs["mean_abs"] <= mean_max and vs["share_over_64"] <= share_max, (case, i, vs)
            if stored is not None:
                assert np.array_equal(stored[f"page{i}"], grey(jimg))


@pytest.mark.parametrize("case", BANDS)
def test_hinted_fallback_parses_within_band(pdf, golden, case):
    """In each hinted case the "txt" parse's Markdown equals the JAX
    package's and its dets have the same number and classes, boxes within
    BOX_TOL_PT; the "ocr" parse's Markdown is within OCR_CER_BAND and each
    page's det count within OCR_DET_COUNT_GAP of the JAX package's (the
    OCR lines' dets are not held one by one)."""
    with fallback_case(case, pdf, **PARSE_ENV):
        txt = summary(port_parse(pdf, "txt_fp32"))
        ocr = summary(port_parse(pdf, "ocr_fp32"))
    vs = band_parse(txt, golden[case]["txt_fp32"])
    assert vs["markdown_equal"] and vs["same_dets"] and vs["box_gap_pt"] <= BOX_TOL_PT, vs
    vs = band_parse(ocr, golden[case]["ocr_fp32"])
    assert vs["cer"] <= OCR_CER_BAND[case] and vs["det_count_gap"] <= OCR_DET_COUNT_GAP[case], vs


def compare(pdf: bytes, golden: dict) -> dict:
    """The bands' readings on the CPU (the source of RASTER_BAND and
    OCR_CER_BAND) and the port's bf16 "ocr" parse with the int8 head
    against the golden's (chip_smoke.py's TEXT_BF16)."""
    import chip_smoke as smoke
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render_page

    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    out = {}
    for case in BANDS:
        with fallback_case(case, pdf):
            doc, jdoc = open_pdf(pdf), jax_open(pdf)
            out[f"{case}_raster"] = [raster_band(
                render_page_full(doc.get_page(i), dpi=dpi)[0],
                jax_render_page(jdoc.get_page(i), dpi=dpi)[0])
                for dpi in DPIS for i in range(len(doc))]
        with fallback_case(case, pdf, **PARSE_ENV):
            out[f"{case}_ocr"] = band_parse(summary(port_parse(pdf, "ocr_fp32")),
                                            golden[case]["ocr_fp32"])
    with fallback_case("exact", pdf, **PARSE_ENV):
        got = summary(port_parse(pdf, "ocr_bf16_int8"))
    out["port_bf16_int8_cpu"] = smoke.compare_layout_parse(got, golden["ocr_bf16_int8"])
    out["jax_fp32_int8_vs_bf16_int8"] = smoke.compare_layout_parse(
        golden["ocr_fp32_int8"], golden["ocr_bf16_int8"])
    return out


if __name__ == "__main__":
    # Rewrites the fixture, the golden and the band arrays, then prints
    # compare().
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" not in sys.argv[1:]:
        data = make_text_doc()
        DOC_PDF.write_bytes(data)
        gold, arrays = make_golden(data)
        GOLDEN_JSON.write_text(json.dumps(gold, indent=1) + "\n")
        np.savez_compressed(BAND_NPZ, **arrays)
        print("wrote", DOC_PDF, GOLDEN_JSON, BAND_NPZ)
    print(json.dumps(compare(DOC_PDF.read_bytes(), json.loads(GOLDEN_JSON.read_text())), indent=1))
