"""The port's page renderer against the JAX package's, and resize_area
against OpenCV's INTER_AREA.

``render_page_full`` must give the JAX package's page arrays exactly: on
the fixture PDF at 200 dpi (the 960 px JPEGs enlarged, INTER_LINEAR) and
at 100 and 72 dpi (shrunk, INTER_AREA), and on hand-written pages whose
images are raw RGB or grey samples (Flate or not) placed flipped,
rotated by 90 degrees (or by less than 45, which the JAX package draws
unrotated), clipped by a rectangle or partly off the page; and on pages
of vector paths (fills, strokes, even-odd, translucent ink, a stroke
under a rectangular clip), a clip that is not a rectangle, an image
resized to under 16384 pixels, a rotation by 60 degrees, an image mask,
a soft mask and Type3 glyphs (an outline and an inline image mask); and
on text drawn through FreeType with an unhinted fallback font: Type1
Helvetica and a Type3 glyph without a CharProc (both the fallback), an
embedded TrueType font upright and turned by 30 and 90 degrees.
Shadings, pattern fills and decode arrays (which raised before they were
ported) equal the JAX package's render. What it does not draw yet must
raise NotImplementedError: a face of bitmap strikes, text that needs
complex shaping, a JPX image and an arithmetic-coded JPEG.
"""
import sys
import zlib
from pathlib import Path

import cv2
import numpy as np
import pytest

from rapiddoc_tpu.pdfio import open_pdf as jax_open_pdf
from rapiddoc_tpu.pdfio.render import render_page_full as jax_render
from rapiddoc_tpu_torch.models.ocr.pre_post import resize_area
from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
FIXTURE = REPO / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_doc.pdf"


def image_pdf(content: bytes, img: np.ndarray, flate: bool = True, extra: bytes = b"",
              media=(0, 0, 400, 300), res: bytes = b"", objs: dict | None = None,
              fonts: bytes = b"") -> bytes:
    """One page drawing ``content`` with the raw-sample image XObject
    /Im0 (RGB or grey, 8 bits) and the fonts /F1 and /T3; ``res`` adds
    resource entries, ``fonts`` font entries and ``objs`` objects numbered
    from 7."""
    h, w = img.shape[:2]
    cs = b"/DeviceRGB" if img.ndim == 3 else b"/DeviceGray"
    data = zlib.compress(img.tobytes()) if flate else img.tobytes()
    filt = b"/Filter /FlateDecode " if flate else b""
    objs = {
        1: b"<< /Type /Catalog /Pages 2 0 R >>",
        2: b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>",
        3: b"<< /Type /Page /Parent 2 0 R /MediaBox [%d %d %d %d] " % media
           + b"/Resources << /XObject << /Im0 5 0 R >> /Font << /F1 6 0 R /T3 7 0 R " + fonts + b">> "
           + res + b" >> /Contents 4 0 R >>",
        4: b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream",
        5: b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace " % (w, h)
           + cs + b" /BitsPerComponent 8 " + filt + extra + b"/Length %d >>\nstream\n" % len(data)
           + data + b"\nendstream",
        6: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>",
        **TYPE3,
        **(objs or {}),
    }
    out = bytearray(b"%PDF-1.4\n")
    offsets = []
    for num in sorted(objs):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % num + objs[num] + b"\nendobj\n"
    xref = len(out)
    n = len(objs) + 1
    out += b"xref\n0 %d\n0000000000 65535 f \n" % n + b"".join(
        b"%010d 00000 n \n" % o for o in offsets)
    out += b"trailer\n<< /Size %d /Root 1 0 R >>\nstartxref\n%d\n%%%%EOF\n" % (n, xref)
    return bytes(out)


# a Type3 font: /A a filled outline (d0), /B an inline image mask (d1);
# code 67 (/C) has no CharProc
_MASK_HEX = np.packbits(~np.eye(8, dtype=bool) & ~np.eye(8, dtype=bool)[::-1], axis=1).tobytes().hex()
_GLYPH_A = (b"600 0 d0 0 0 m 500 0 l 250 700 l h f 100 100 m 400 100 l 400 200 l 100 200 l h "
            b"80 60 m 300 -40 520 60 v 500 250 y f")
_GLYPH_B = (b"600 0 0 0 500 700 d1 q 500 0 0 700 0 0 cm BI /W 8 /H 8 /IM true /BPC 1 "
            b"/F /AHx ID " + _MASK_HEX.encode() + b"> EI Q")
TYPE3 = {
    7: b"<< /Type /Font /Subtype /Type3 /FontBBox [0 -100 600 800] "
       b"/FontMatrix [0.001 0 0 0.001 0 0] /CharProcs << /A 8 0 R /B 9 0 R >> "
       b"/Encoding << /Type /Encoding /Differences [65 /A /B /C] >> /FirstChar 65 "
       b"/LastChar 67 /Widths [600 600 600] /Resources << >> >>",
    8: b"<< /Length %d >>\nstream\n" % len(_GLYPH_A) + _GLYPH_A + b"\nendstream",
    9: b"<< /Length %d >>\nstream\n" % len(_GLYPH_B) + _GLYPH_B + b"\nendstream",
}
_SHADING = (b"<< /ShadingType 2 /ColorSpace /DeviceRGB /Coords [0 0 200 0] /Function "
            b"<< /FunctionType 2 /Domain [0 1] /C0 [1 0 0] /C1 [0 0 1] /N 1 >> >>")
_ALPHA = np.tile(np.linspace(0, 255, 40).astype(np.uint8), (30, 1))
_SMASK_OBJ = {10: b"<< /Type /XObject /Subtype /Image /Width 40 /Height 30 /ColorSpace "
                  b"/DeviceGray /BitsPerComponent 8 /Length %d >>\nstream\n" % _ALPHA.size
                  + _ALPHA.tobytes() + b"\nendstream"}


def both(data: bytes, dpi: int, page: int = 0):
    want, _, jboxes = jax_render(jax_open_pdf(data).get_page(page), dpi=dpi, with_text=False)
    got, text, boxes = render_page_full(open_pdf(data).get_page(page), dpi=dpi, with_text=False)
    return got, np.asarray(want), boxes, jboxes, text


@pytest.mark.parametrize("dpi", [200, 100, 72])
@pytest.mark.parametrize("page", [0, 1, 2])
def test_fixture_pages_equal_jax(dpi, page):
    got, want, boxes, jboxes, text = both(FIXTURE.read_bytes(), dpi, page)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)
    assert boxes == jboxes and text is None


RNG = np.random.default_rng(5)
RGB = RNG.integers(0, 256, (150, 200, 3), dtype=np.uint8)
GREY = RNG.integers(0, 256, (300, 240), dtype=np.uint8)
PLACED = {
    # name: (content, image, flate)
    "rgb_enlarged": (b"q 300 0 0 200 40 50 cm /Im0 Do Q", RGB, True),
    "grey_shrunk_raw": (b"q 150 0 0 200 10 10 cm /Im0 Do Q", GREY, False),
    "flipped_x": (b"q -300 0 0 200 340 50 cm /Im0 Do Q", RGB, True),
    "flipped_y": (b"q 300 0 0 -200 40 250 cm /Im0 Do Q", RGB, True),
    "rotated_90": (b"q 0 200 -150 0 300 40 cm /Im0 Do Q", RGB, True),
    "rotated_270": (b"q 0 -200 150 0 100 260 cm /Im0 Do Q", GREY, True),
    "rect_clip": (b"q 50 60 200 150 re W n 300 0 0 200 40 50 cm /Im0 Do Q", RGB, True),
    "off_page": (b"q 300 0 0 250 -100 120 cm /Im0 Do Q", RGB, True),
    "two_images": (b"q 200 0 0 150 10 10 cm /Im0 Do Q q 180 0 0 140 210 150 cm /Im0 Do Q",
                   RGB, True),
    # under 45 degrees the JAX package draws into the bounding box unrotated
    "skewed_30": (b"q 173.2 100 -100 173.2 200 20 cm /Im0 Do Q", RGB, True),
}


@pytest.mark.parametrize("name", list(PLACED))
@pytest.mark.parametrize("dpi", [200, 72])
def test_placed_images_equal_jax(name, dpi):
    content, img, flate = PLACED[name]
    got, want, boxes, jboxes, _ = both(image_pdf(content, img, flate), dpi)
    assert np.array_equal(got, want)
    assert boxes == jboxes


# cases the JAX package draws with PIL: name -> (content, image_pdf kwargs)
VECTOR = {
    "path_fill": (b"0 0 1 rg 10 10 100 50 re f", {}),
    "path_stroke": (b"2 w 10 10 m 200 200 l S", {}),
    "clip_not_rect": (b"q 10 10 m 200 20 l 100 250 l h W n 300 0 0 200 40 50 cm /Im0 Do Q", {}),
    "small_resize": (b"q 40 0 0 30 10 10 cm /Im0 Do Q", {}),
    "rotated_60": (b"q 100 173.2 -173.2 100 250 20 cm /Im0 Do Q", {}),
    "image_mask": (b"q 300 0 0 200 40 50 cm /Im0 Do Q", {"extra": b"/ImageMask true "}),
    "even_odd_fill": (b"0.2 0.6 0.3 rg 20 20 m 220 20 l 220 220 l 20 220 l h 60 60 m 180 60 l "
                      b"180 180 l 60 180 l h f* 0 0 1 RG 3 w 30 250 m 120 230 200 290 c S", {}),
    # a stroke ignores a rectangular clip, as the JAX package draws it
    "stroke_under_rect_clip": (b"q 50 50 100 100 re W n 1 0 0 RG 4 w 10 10 m 300 280 l S "
                               b"0 1 0 rg 20 20 200 200 re f Q", {}),
    "translucent_strokes": (b"q /GS0 gs 1 w 0 0 0 RG 3 w 20 20 m 150 150 l 300 40 l S "
                            b"0 0 1 rg 60 60 m 200 260 l 330 90 l h f Q",
                            {"res": b"/ExtGState << /GS0 << /CA 0.5 /ca 0.4 >> >>"}),
    "soft_mask": (b"q 300 0 0 200 40 50 cm /Im0 Do Q q 100 0 0 60 20 200 cm /Im0 Do Q",
                  {"extra": b"/SMask 10 0 R ", "objs": _SMASK_OBJ}),
    "type3_glyphs": (b"0.1 0.1 0.5 rg BT /T3 48 Tf 40 150 Td (ABAB) Tj ET "
                     b"BT /T3 12 Tf 1 0.3 -0.3 1 40 60 Tm (ABBA) Tj ET", {}),
}


@pytest.mark.parametrize("name", list(VECTOR))
@pytest.mark.parametrize("dpi", [200, 72])
def test_vector_cases_equal_jax(name, dpi):
    content, kw = VECTOR[name]
    got, want, boxes, jboxes, _ = both(image_pdf(content, RGB, **kw), dpi)
    assert np.array_equal(got, want)
    assert boxes == jboxes


def _text_font_objs() -> dict:
    """Objects 10-17: an embedded unhinted TrueType font /TT (seeded random
    glyphs for A-Z a-z), a copy whose table directory claims a bitmap
    strike (EBDT) /BM, and Helvetica with a ToUnicode map to Arabic /AR."""
    import torch_font_programs as fb

    rng = np.random.default_rng(17)
    letters = [chr(c) for c in list(range(65, 91)) + list(range(97, 123))]
    prog = fb.build_ttf({f"g{c}": fb.random_glyph(rng, scale=0.6) for c in letters},
                        {ord(c): f"g{c}" for c in letters})
    bitmap = prog.replace(b"name", b"EBDT", 1)
    cmap = (b"/CIDInit /ProcSet findresource begin 12 dict begin begincmap 1 begincodespacerange "
            b"<00> <FF> endcodespacerange 2 beginbfchar <41> <0633> <42> <0644> endbfchar "
            b"endcmap CMapName currentdict /CMap defineresource pop end end")

    def font(num, prog_bytes, name):
        return {
            num: b"<< /Type /Font /Subtype /TrueType /BaseFont /%s /FirstChar 65 /LastChar 122 "
                 b"/Widths [%s] /FontDescriptor %d 0 R /Encoding /WinAnsiEncoding >>"
                 % (name, b" ".join([b"600"] * 58), num + 1),
            num + 1: b"<< /Type /FontDescriptor /FontName /%s /Flags 32 /FontBBox [0 -200 1000 "
                     b"900] /ItalicAngle 0 /Ascent 800 /Descent -200 /CapHeight 700 /StemV 80 "
                     b"/FontFile2 %d 0 R >>" % (name, num + 2),
            num + 2: b"<< /Length %d >>\nstream\n" % len(prog_bytes) + prog_bytes + b"\nendstream",
        }

    return {**font(10, prog, b"CodeTT"), **font(13, bitmap, b"CodeBitmap"),
            16: b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica /ToUnicode 17 0 R >>",
            17: b"<< /Length %d >>\nstream\n" % len(cmap) + cmap + b"\nendstream"}


TEXT_FONTS = b"/TT 10 0 R /BM 13 0 R /AR 16 0 R "
# text the JAX package draws through FreeType, with an unhinted fallback
# font (RAPIDDOC_FALLBACK_FONT): name -> content
TEXT = {
    "text": b"BT /F1 24 Tf 50 150 Td (Hello) Tj ET",
    "type3_without_charproc": b"BT /T3 24 Tf 50 150 Td (AC) Tj ET",
    "truetype_turned": b"0.6 0.1 0.1 rg BT /TT 30 Tf 40 200 Td (Glyphs) Tj ET "
                       b"BT /TT 20 Tf 0.866 0.5 -0.5 0.866 60 40 Tm (Turned) Tj ET "
                       b"BT /TT 16 Tf 0 1 -1 0 360 40 Tm (Upward) Tj ET",
}


@pytest.fixture
def unhinted_fallback(tmp_path, monkeypatch):
    """An unhinted TrueType fallback font (seeded random glyphs for
    A-Z a-z) for the JAX package and the port alike."""
    import torch_font_programs as fb

    import rapiddoc_tpu.pdfio.render as jax_render_mod
    import rapiddoc_tpu_torch.pdfio.render as port_render_mod

    rng = np.random.default_rng(3)
    letters = [chr(c) for c in list(range(65, 91)) + list(range(97, 123))]
    path = tmp_path / "fallback.ttf"
    path.write_bytes(fb.build_ttf({f"g{c}": fb.random_glyph(rng, scale=0.7) for c in letters},
                                  {ord(c): f"g{c}" for c in letters}))
    monkeypatch.setenv("RAPIDDOC_FALLBACK_FONT", str(path))
    for mod in (jax_render_mod, port_render_mod):
        monkeypatch.setattr(mod, "_FALLBACK_FONTS_CACHE", None)


@pytest.mark.parametrize("name", list(TEXT))
@pytest.mark.parametrize("dpi", [200, 72])
def test_text_cases_equal_jax(name, dpi, unhinted_fallback):
    got, want, boxes, jboxes, _ = both(image_pdf(TEXT[name], RGB, fonts=TEXT_FONTS,
                                                 objs=_text_font_objs()), dpi)
    assert np.array_equal(got, want)
    assert boxes == jboxes


def _image_obj(filt: bytes, data: bytes) -> bytes:
    return (b"<< /Type /XObject /Subtype /Image /Width 16 /Height 16 /ColorSpace /DeviceRGB "
            b"/BitsPerComponent 8 /Filter " + filt + b" /Length %d >>\nstream\n" % len(data)
            + data + b"\nendstream")


def _arithmetic_jpeg() -> bytes:
    """A baseline JPEG whose frame marker says arithmetic coding (SOF9)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(RGB[:16, :16]).save(buf, format="JPEG")
    data = buf.getvalue()
    at = data.index(b"\xff\xc0")
    return data[:at] + b"\xff\xc9" + data[at + 2:]


_OTHER_IMAGE = b"/XObject << /Im0 5 0 R /Im1 20 0 R >>"
UNSUPPORTED = {
    "bitmap_strike_face": (b"BT /BM 24 Tf 50 150 Td (Hello) Tj ET", {"text": True}),
    "complex_shaping": (b"BT /AR 24 Tf 50 150 Td (AB) Tj ET", {"text": True}),
    "jpx_image": (b"q 100 0 0 100 40 50 cm /Im1 Do Q",
                  {"objs": {20: _image_obj(b"/JPXDecode", b"\x00\x00\x00\x0cjP  \r\n\x87\n")}}),
    "arithmetic_jpeg": (b"q 100 0 0 100 40 50 cm /Im1 Do Q",
                        {"objs": {20: _image_obj(b"/DCTDecode", _arithmetic_jpeg())}}),
}
# forms that raised before the shadings, patterns and decode arrays were
# ported; now equal to the JAX package's render
ONCE_UNSUPPORTED = {
    "decode_array": (b"q 300 0 0 200 40 50 cm /Im0 Do Q", {"extra": b"/Decode [1 0 1 0 1 0] "}),
    "shading": (b"q 10 10 200 100 re W n /Sh0 sh Q",
                {"res": b"/Shading << /Sh0 " + _SHADING + b" >>"}),
    "pattern_fill": (b"/Pattern cs /P0 scn 10 10 100 50 re f",
                     {"res": b"/Pattern << /P0 << /PatternType 2 /Shading " + _SHADING
                             + b" >> >>"}),
}


@pytest.mark.parametrize("name", list(ONCE_UNSUPPORTED))
@pytest.mark.parametrize("dpi", [200, 72])
def test_once_unsupported_content_equals_jax(name, dpi):
    content, kw = ONCE_UNSUPPORTED[name]
    got, want, boxes, jboxes, _ = both(image_pdf(content, RGB, **kw), dpi)
    assert np.array_equal(got, want)
    assert boxes == jboxes


@pytest.mark.parametrize("name", list(UNSUPPORTED))
def test_content_not_ported_raises(name):
    content, kw = UNSUPPORTED[name]
    kw = dict(kw)
    if kw.pop("text", False):
        kw = dict(kw, fonts=TEXT_FONTS, objs=_text_font_objs())
    page = open_pdf(image_pdf(content, RGB, **kw)).get_page(0)
    if "objs" in kw and 20 in kw["objs"]:  # an image XObject /Im1 beside /Im0
        page = open_pdf(image_pdf(content, RGB, **kw).replace(
            b"/XObject << /Im0 5 0 R >>", _OTHER_IMAGE)).get_page(0)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        render_page_full(page, dpi=200, with_text=False)


def test_invisible_and_blank_text_draws_nothing_as_in_jax():
    content = b"BT 3 Tr /F1 24 Tf 50 150 Td (Hidden) Tj ET BT /F1 24 Tf 50 100 Td ( ) Tj ET " \
              b"q 300 0 0 200 40 50 cm /Im0 Do Q"
    got, want, _, _, _ = both(image_pdf(content, RGB), 100)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("size,out", [((960, 960), (667, 667)), ((960, 960), (480, 480)),
                                      ((301, 200), (100, 67)), ((90, 120), (30, 40)),
                                      ((51, 49), (50, 48)), ((1333, 800), (999, 250))])
def test_resize_area_equals_cv2(size, out, channels):
    rng = np.random.default_rng(size[0] * channels + out[0])
    img = rng.integers(0, 256, size + ((3,) if channels == 3 else ()), dtype=np.uint8)
    want = cv2.resize(img, (out[1], out[0]), interpolation=cv2.INTER_AREA)
    assert np.array_equal(resize_area(img, out[1], out[0]), want)
