"""The port's font program readers against fontTools and Pillow, on seeded
code-built fonts (``tests/torch_font_programs.py``).

- ``sfnt``: TrueType outlines (simple and composite glyphs), advances,
  side bearings, unitsPerEm, the Unicode charmap (formats 4 and 12, and
  0 and 6 through hand-made subtables) and ``post`` names equal to
  fontTools' reading of the same bytes;
- ``cff``: a bare CFF's charset names and outlines (in 16.16 font units)
  equal to fontTools' charstring decompiler;
- ``type1``: a Type1 program (binary eexec, Subrs, flex, ``seac``) whose
  outlines and names equal fontTools' ``t1Lib`` reading;
- the charmap FreeType and HarfBuzz pick, and what glyph 0 does, equal to
  Pillow's boxes: a (3, 1) cmap, a symbol (3, 0) one alone and beside a
  (3, 1) one, a Macintosh (1, 0) one alone, a (0, 3) one; an empty and a
  boxed ``.notdef``; a CID-keyed CFF (no charmap);
- which bytes each side refuses: the same set.
"""
import io
import sys
from pathlib import Path

import numpy as np
import pytest
from fontTools.pens.recordingPen import DecomposingRecordingPen, RecordingPen
from PIL import ImageFont

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import torch_font_programs as fb  # noqa: E402
from rapiddoc_tpu_torch.pdfio import cff, glyph_names, sfnt, type1  # noqa: E402
from rapiddoc_tpu_torch.pdfio.ft_face import Face  # noqa: E402

LETTERS = [chr(c) for c in range(65, 91)]


def _tt_font(seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    glyphs = {f"g{c}": fb.random_glyph(rng) for c in LETTERS}
    cmap = {ord(c): f"g{c}" for c in LETTERS}
    cmap[0x1F600] = "gA"  # a code point past the BMP: a format 12 subtable
    comps = {"comp1": [("gA", 100, 0), ("gB", -50, 120)], "comp2": [("comp1", 30, -40)]}
    return fb.build_ttf(glyphs, cmap, composites=comps,
                        advances={f"g{c}": 400 + 17 * i for i, c in enumerate(LETTERS)})


@pytest.mark.parametrize("seed", [0, 1])
def test_sfnt_outlines_and_metrics_equal_fonttools(seed):
    data = _tt_font(seed)
    t = fb.ttfont(data)
    f = sfnt.Sfnt(data)
    assert f.units_per_em == t["head"].unitsPerEm
    assert f.num_glyphs == len(t.getGlyphOrder())
    assert f.cmap == {cp: t.getGlyphID(n) for cp, n in t.getBestCmap().items()}
    assert f.glyph_names() == t.getGlyphOrder()
    face = Face(data, 1000)  # x_scale 1.0: composites resolve in font units
    for gid, name in enumerate(t.getGlyphOrder()):
        adv, lsb = t["hmtx"][name]
        assert (f.advance(gid), int(f.lsbs[gid])) == (adv, lsb)
        coords, ends, flags = t["glyf"][name].getCoordinates(t["glyf"])
        pts, tags, got_ends, _ = face.outline(gid)
        want = np.asarray(coords, np.int64).reshape(-1, 2) * 64
        assert np.array_equal(pts, want), name
        assert list(got_ends) == list(ends) and np.array_equal(tags, np.asarray(flags) & 1)


@pytest.mark.parametrize("fmt", [0, 6])
def test_sfnt_cmap_formats_0_and_6(fmt):
    mapping = {0x41 + i: f"g{c}" for i, c in enumerate(LETTERS[:10])}
    rng = np.random.default_rng(2)
    data = fb.build_ttf({f"g{c}": fb.random_glyph(rng) for c in LETTERS[:10]}, {},
                        cmap_tables=[(0, 3, fmt, mapping)])
    t = fb.ttfont(data)
    assert sfnt.Sfnt(data).cmap == {cp: t.getGlyphID(n) for cp, n in mapping.items()}


def _t2_outline(cs) -> list:
    """fontTools' drawing of a charstring as contours of points (font units)."""
    pen = RecordingPen()
    cs.draw(pen)
    out, cur = [], []
    for op, args in pen.value:
        if op == "moveTo":
            cur = [args[0]]
        elif op in ("lineTo", "curveTo"):
            cur.extend(args)
        elif op in ("closePath", "endPath"):
            if len(cur) > 1 and cur[-1] == cur[0]:
                cur = cur[:-1]
            out.append(cur)
    return out


def _our_contours(ol) -> list:
    return [[(x / 65536, y / 65536) for x, y, _ in c] for c in ol.contours]


def test_cff_names_and_outlines_equal_fonttools():
    from fontTools.cffLib import CFFFontSet

    rng = np.random.default_rng(4)
    glyphs = {g: fb.random_glyph(rng, cubic=True) for g in ("A", "B", "uni0416", "one", "A.alt")}
    data = fb.build_otf(glyphs, {}, bare=True, advances={"A": 555})
    ours = cff.CFFFont(data)
    fs = CFFFontSet()
    fs.decompile(io.BytesIO(data), None)
    top = fs[fs.fontNames[0]]
    assert ours.glyph_names == top.charset
    for gid, name in enumerate(top.charset):
        want = _t2_outline(top.CharStrings[name])
        assert _our_contours(ours.outline(gid)) == [[tuple(map(float, p)) for p in c] for c in want]
    assert ours.outline(1).width >> 16 == 555
    assert ours.unicode_charmap() == {0x41: 1, 0x42: 2, 0x416: 3, 0x31: 4}


def test_type1_names_and_outlines_equal_fonttools(tmp_path):
    from fontTools import t1Lib

    rng = np.random.default_rng(6)
    ops = {c: fb.random_glyph(rng, cubic=True) for c in ("A", "B", "C")}
    cs = {".notdef": fb.t1_program(fb.NOTDEF_BOX)}
    for c, o in ops.items():
        flex = next((k for k in range(len(o) - 1) if o[k][0] == "curve" and o[k + 1][0] == "curve"),
                    None)
        cs[c] = fb.t1_program(o, width=500, flex_at=flex)
    cs["acute"] = fb.t1_program([("move", (200, 800)), ("line", (300, 950)), ("line", (350, 900)),
                                 ("close",)])
    cs["Aacute"] = [0, 600, "hsbw", 0, 65, 200, 65, 194, "seac"]
    data = fb.build_type1(cs)
    ours = type1.Type1Font(data)
    # fontTools reads PFB segments: the cleartext, the binary eexec part, the trailer
    k = data.index(b"eexec") + 6
    tail = data.index(b"0000000000")
    pfb = b"".join(b"\x80" + bytes([kind]) + len(part).to_bytes(4, "little") + part
                   for kind, part in ((1, data[:k]), (2, data[k:tail]), (1, data[tail:])))
    path = tmp_path / "code.pfb"
    path.write_bytes(pfb + b"\x80\x03")
    t1 = t1Lib.T1Font(str(path))
    t1.parse()
    gs = t1.getGlyphSet()
    assert sorted(ours.glyph_names) == sorted(gs.keys())
    assert type1.Type1Font(pfb + b"\x80\x03").glyph_names == ours.glyph_names
    for gid, name in enumerate(ours.glyph_names):
        if name == "Aacute":
            continue  # fontTools draws no seac
        pen = DecomposingRecordingPen(gs)
        gs[name].draw(pen)
        rec = RecordingPen()
        rec.value = pen.value
        want = _t2_outline(rec)
        assert _our_contours(ours.outline(gid)) == [[tuple(map(float, p)) for p in c] for c in want]
    # seac: the base's contours, then the accent's moved by adx - asb
    base = _our_contours(ours.outline(ours.gid_of_name("A")))
    acc = [[(x + 65, y + 200) for x, y in c] for c in _our_contours(ours.outline(
        ours.gid_of_name("acute")))]
    assert _our_contours(ours.outline(ours.gid_of_name("Aacute"))) == base + acc
    assert ours.unicode_charmap()[0xC1] == ours.gid_of_name("Aacute")


def test_glyph_names_module_is_fonttools_data():
    from fontTools import agl
    from fontTools.cffLib import cffStandardStrings
    from fontTools.encodings.StandardEncoding import StandardEncoding
    from fontTools.ttLib.standardGlyphOrder import standardGlyphOrder

    assert glyph_names.AGL == {k: v[0] for k, v in agl.LEGACY_AGL2UV.items()}
    assert list(glyph_names.CFF_STANDARD_STRINGS) == list(cffStandardStrings)
    assert list(glyph_names.STANDARD_ENCODING) == list(StandardEncoding)
    assert list(glyph_names.MAC_GLYPHS) == list(standardGlyphOrder)


@pytest.mark.parametrize("name,value", [
    ("A", 0x41), ("uni0416", 0x416), ("uni0416.alt", 0x416 | cff.VARIANT_BIT),
    ("u1F600", 0x1F600), ("A.sc", 0x41 | cff.VARIANT_BIT), ("uni04", 0), ("uni0416A", 0),
    ("g123", 0), (".notdef", 0), ("uni00e9", 0), ("Aacute", 0xC1)])
def test_ps_unicode_value(name, value):
    assert cff.ps_unicode_value(name) == value


# ------------------------------------------------------------ charmap picks

GLYPHS = {"g1": [("move", (50, 0)), ("line", (50, 300)), ("line", (150, 300)), ("close",)],
          "g2": [("move", (0, 0)), ("line", (0, 100)), ("line", (550, 100)), ("close",)]}
CMAPS = {
    "unicode_3_1": [(3, 1, 4, {0x41: "g1", 0x42: "g2"})],
    "symbol_only": [(3, 0, 4, {0xF041: "g1", 0xF042: "g2"})],
    "symbol_plain_codes": [(3, 0, 4, {0x41: "g1", 0x42: "g2"})],
    "mac_only": [(1, 0, 0, {0x41: "g1", 0x42: "g2"})],
    "symbol_and_unicode": [(3, 0, 4, {0xF041: "g2"}), (3, 1, 4, {0x41: "g1"})],
    "unicode_0_3": [(0, 3, 4, {0x41: "g2", 0x42: "g1"})],
}


@pytest.mark.parametrize("notdef", ["box", "empty"])
@pytest.mark.parametrize("name", list(CMAPS))
def test_charmap_and_notdef_equal_pillow(name, notdef):
    data = fb.build_ttf(GLYPHS, {}, cmap_tables=CMAPS[name],
                        notdef=fb.NOTDEF_BOX if notdef == "box" else [])
    for px in (13, 40):
        pil, face = ImageFont.truetype(io.BytesIO(data), px), Face(data, px)
        for text in ("A", "B", "C", "", "AB"):
            assert face.getbbox(text) == pil.getbbox(text), (name, px, text)
            assert face.getbbox(text, anchor="ls") == pil.getbbox(text, anchor="ls")


def test_cid_keyed_cff_has_no_charmap():
    """A CIDFontType0C program: every character is glyph 0, in Pillow too."""
    from fontTools.cffLib import FDArrayIndex, FDSelect, FontDict
    from fontTools.fontBuilder import FontBuilder
    from fontTools.pens.t2CharStringPen import T2CharStringPen

    f = FontBuilder(1000, isTTF=False)
    names = [".notdef", "cid00001", "cid00002"]
    f.setupGlyphOrder(names)
    f.setupCharacterMap({})
    cs = {}
    for n, ops in zip(names, [fb.NOTDEF_BOX, GLYPHS["g1"], GLYPHS["g2"]]):
        pen = T2CharStringPen(600, None)
        fb.draw(pen, ops)
        cs[n] = pen.getCharString()
    f.setupCFF("CodeCID", {"FullName": "CodeCID"}, cs, {})
    top = f.font["CFF "].cff[0]
    top.ROS = ("Adobe", "Identity", 0)
    top.CIDCount = len(names)
    fd = FontDict()
    fd.Private, fd.FontMatrix = top.Private, [0.001, 0, 0, 0.001, 0, 0]
    top.FDArray = FDArrayIndex()
    top.FDArray.append(fd)
    top.FDSelect = FDSelect()
    top.FDSelect.format, top.FDSelect.gidArray = 3, [0] * len(names)
    data = f.font["CFF "].compile(f.font)
    assert cff.CFFFont(data).is_cid and cff.CFFFont(data).unicode_charmap() == {}
    for px in (13, 40):
        pil, face = ImageFont.truetype(io.BytesIO(data), px), Face(data, px)
        for text in ("A", "1"):
            assert face.getbbox(text) == pil.getbbox(text)


def _refused(fn) -> bool:
    try:
        fn()
    except Exception:  # noqa: BLE001 - any refusal
        return True
    return False


def test_refused_bytes_are_pillows():
    """The bytes ImageFont.truetype refuses are the ones Face refuses."""
    rng = np.random.default_rng(8)
    good = fb.build_ttf({"g1": fb.random_glyph(rng)}, {0x41: "g1"})
    bare = fb.build_otf({"A": fb.random_glyph(rng, cubic=True)}, {}, bare=True)
    t1 = fb.build_type1({".notdef": fb.t1_program(fb.NOTDEF_BOX),
                         "A": fb.t1_program(fb.random_glyph(rng, cubic=True))})
    cases = {"ttf": good, "cff": bare, "type1": t1, "empty": b"", "text": b"hello world font",
             "ttf_truncated": good[:200], "cff_truncated": bare[:30],
             "ttf_no_head": good.replace(b"head", b"hexd", 1), "zeros": bytes(64)}
    for name, data in cases.items():
        pil = _refused(lambda: ImageFont.truetype(io.BytesIO(data), 12))
        ours = _refused(lambda: Face(data, 12))
        assert pil == ours, name
    assert not _refused(lambda: Face(good, 12))
