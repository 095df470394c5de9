"""The port's shadings, functions and pattern fills against the JAX
package's.

Each case of ``tests/test_shading.py`` runs on the port: its function
cases on the port's ``pdfio.shading``, its page cases with every raster
drawn by both renderers and held byte-equal (the case's own checks then
run on that raster). Text on those pages is drawn with an unhinted
fallback font in both packages (``test_torch_render.unhinted_fallback``),
whose random glyphs carry less ink than the thresholds of the three text
cases expect; there the byte equality is the check.
More pages cover what the page cases leave out: radial and
function-based shadings, shading BBoxes, mesh shadings' average colour,
shading patterns under clips and alpha, tiling hatches of strokes, of
translucent fills and of nested text and images, tilings that are not
axis-aligned (mid-grey), and patterns inside forms.
"""
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_shading as T  # noqa: E402
from test_torch_render import unhinted_fallback  # noqa: E402,F401
from rapiddoc_tpu.pdfio import open_pdf as jax_open_pdf  # noqa: E402
from rapiddoc_tpu.pdfio.render import render_page as jax_render_page  # noqa: E402
from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full  # noqa: E402
from rapiddoc_tpu_torch.pdfio import shading as port_shading  # noqa: E402

FUNCTION_CASES = ["test_function_type2_exponential", "test_function_type3_stitching",
                  "test_function_type0_sampled", "test_function_type4_postscript",
                  "test_ps_calculator_control_flow"]
TEXT_CASES = {"test_gradient_background_keeps_text_legible", "test_rotated_text_renders_ink",
              "test_watermark_form_with_alpha_keeps_text_legible"}
PAGE_CASES = ["test_sh_operator_paints_axial_gradient", "test_sh_operator_radial_gradient",
              "test_shading_pattern_fills_path", "test_tiling_pattern_fill",
              "test_nonrect_clip_masks_fill", "test_nonrect_clip_masks_image",
              "test_gradient_background_keeps_text_legible", "test_type3_font_glyphs_render",
              "test_rotated_text_renders_ink", "test_watermark_form_with_alpha_keeps_text_legible"]


def both(data: bytes, dpi: int) -> tuple[np.ndarray, np.ndarray]:
    want = np.asarray(jax_render_page(jax_open_pdf(data).get_page(0), dpi=dpi))
    got, _, _ = render_page_full(open_pdf(data).get_page(0), dpi=dpi, with_text=False)
    return got, want


@pytest.mark.parametrize("name", FUNCTION_CASES)
def test_function_case_on_port(name, monkeypatch):
    """The case's own assertions, on the port's functions."""
    monkeypatch.setitem(sys.modules, "rapiddoc_tpu.pdfio.shading", port_shading)
    getattr(T, name)()


class RasterMismatch(Exception):
    pass


@pytest.mark.parametrize("name", PAGE_CASES)
def test_page_case_equals_jax(name, monkeypatch, unhinted_fallback):  # noqa: F811
    seen = []

    def render(data: bytes, dpi: int = 72) -> np.ndarray:
        got, want = both(data, dpi)
        if got.shape != want.shape or not np.array_equal(got, want):
            raise RasterMismatch(f"{name} at {dpi} dpi")
        seen.append(dpi)
        return got

    monkeypatch.setattr(T, "_render", render)
    try:
        getattr(T, name)()
    except AssertionError:
        if name not in TEXT_CASES:
            raise
    assert seen


def _fn_values(mod, fn_obj, ts):
    doc = T._StubDoc()
    fn = mod.PdfFunction(doc, fn_obj)
    return [fn(t) for t in ts]


def test_function_values_equal_jax():
    """Types 0 (1, 4, 8, 16 bits a sample, two outputs), 2, 3 and 4 at a
    sweep of inputs inside and outside the domain."""
    import rapiddoc_tpu.pdfio.shading as jax_shading

    ts = list(np.linspace(-0.25, 1.25, 31))
    objs = [
        {"FunctionType": 2, "Domain": [0, 1], "C0": [0.2, 0.1], "C1": [0.9, 0.5], "N": 2.2},
        {"FunctionType": 3, "Domain": [0, 1], "Bounds": [0.3, 0.7], "Encode": [1, 0, 0, 1, 0, 1],
         "Functions": [{"FunctionType": 2, "C0": [0.0], "C1": [1.0], "N": 1},
                       {"FunctionType": 2, "C0": [1.0], "C1": [0.5], "N": 0.5},
                       {"FunctionType": 2, "C0": [0.5], "C1": [0.0], "N": 3}]},
        T._StubStream({"FunctionType": 4, "Domain": [0, 1], "Range": [0, 1, 0, 1]},
                      b"{ dup dup mul exch 0.5 gt { 1 exch sub } if 2 copy add 2 div "
                      b"exch pop sqrt }"),
    ]
    rng = np.random.default_rng(9)
    for bps in (1, 4, 8, 16):
        n = 7
        samples = rng.integers(0, 1 << bps, 2 * n)
        if bps == 16:
            raw = samples.astype(">u2").tobytes()
        else:
            bits = "".join(format(int(v), f"0{bps}b") for v in samples)
            bits += "0" * (-len(bits) % 8)
            raw = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
        objs.append(T._StubStream({"FunctionType": 0, "Domain": [0, 1], "Range": [0, 1, 0, 1],
                                   "Size": [n], "BitsPerSample": bps,
                                   "Decode": [0, 1, 1, 0]}, raw))
    for obj in objs:
        assert _fn_values(port_shading, obj, ts) == _fn_values(jax_shading, obj, ts)


# ------------------------------------------------------------ more pages

def _stream(d: bytes, body: bytes, flate: bool = False) -> bytes:
    if flate:
        body = zlib.compress(body)
        d += b" /Filter /FlateDecode"
    return b"<< " + d + b" /Length %d >>\nstream\n" % len(body) + body + b"\nendstream"


_AXIAL = (b"<< /ShadingType 2 /ColorSpace /DeviceRGB /Coords [20 10 180 90] /Extend [false true] "
          b"/Function << /FunctionType 2 /Domain [0 1] /C0 [0.9 0.2 0.1] /C1 [0.1 0.3 0.8] /N 1 >> "
          b">>")
_RADIAL = (b"<< /ShadingType 3 /ColorSpace /DeviceCMYK /Coords [80 50 5 110 60 70] "
           b"/Extend [true false] /Function << /FunctionType 3 /Domain [0 1] /Bounds [0.4] "
           b"/Encode [0 1 0 1] /Functions [<< /FunctionType 2 /C0 [0 0 0 0] /C1 [0.8 0 0.2 0] "
           b"/N 1 >> << /FunctionType 2 /C0 [0.8 0 0.2 0] /C1 [0.1 0.9 0 0.2] /N 1 >>] >> >>")
_FUNC = (b"<< /ShadingType 1 /ColorSpace /DeviceRGB /Domain [0 1 0 1] /Matrix [150 0 0 80 25 10] "
         b"/Function 6 0 R >>")
_FUNC_OBJ = _stream(b"/FunctionType 4 /Domain [0 1 0 1] /Range [0 1 0 1 0 1]",
                    b"{ 2 copy mul 3 1 roll exch }")
_MESH = (b"<< /ShadingType 4 /ColorSpace /DeviceGray /BitsPerCoordinate 8 /BitsPerComponent 8 "
         b"/BitsPerFlag 8 /Decode [0 200 0 100 0 1] /Function << /FunctionType 2 /Domain [0 1] "
         b"/C0 [0.2] /C1 [0.9] /N 1 >> /Length 0 >>\nstream\n\nendstream")
_HATCH = _stream(b"/PatternType 1 /PaintType 1 /TilingType 1 /BBox [0 0 12 12] /XStep 12 "
                 b"/YStep 12 /Resources << >>",
                 b"0.1 0.2 0.6 RG 1.5 w 0 0 m 12 12 l S 0 12 m 12 0 l S "
                 b"1 0 0 rg 4 4 3 3 re f")
_HATCH_SCALED = _stream(b"/PatternType 1 /PaintType 1 /TilingType 1 /BBox [0 0 10 10] "
                        b"/XStep 14 /YStep 9 /Matrix [1.5 0 0 1.2 3 7] "
                        b"/Resources << /ExtGState << /G 8 0 R >> >>",
                        b"/G gs 0 0.5 0 rg 0 0 6 6 re f 0 0 0 RG 0.5 w 0 8 m 10 8 l S")
_TURNED = _stream(b"/PatternType 1 /PaintType 1 /TilingType 1 /BBox [0 0 10 10] /XStep 10 "
                  b"/YStep 10 /Matrix [0.7 0.7 -0.7 0.7 0 0] /Resources << >>",
                  b"0 0 0 rg 0 0 5 5 re f")
_NESTED = _stream(b"/PatternType 1 /PaintType 1 /TilingType 1 /BBox [0 0 30 20] /XStep 30 "
                  b"/YStep 20 /Resources << /XObject << /Im 9 0 R >> /Pattern << /Q 10 0 R >> "
                  b">>",
                  b"q 12 0 0 8 2 2 cm /Im Do Q /Pattern cs /Q scn 16 4 10 10 re f "
                  b"0 0 1 RG 0 0 m 30 20 l S")
_IMG = _stream(b"/Type /XObject /Subtype /Image /Width 3 /Height 2 /ColorSpace /DeviceRGB "
               b"/BitsPerComponent 8", bytes(range(40, 58)))
_SHPAT = b"<< /PatternType 2 /Matrix [0.5 0 0 0.5 10 5] /Shading " + _RADIAL + b" >>"
_FORM = _stream(b"/Type /XObject /Subtype /Form /BBox [0 0 200 100] /Resources << /Pattern "
                b"<< /P 7 0 R >> >>", b"/Pattern cs /P scn 100 10 80 60 re f")

PAGES = {
    "axial_bbox_clip": (b"q 30 20 120 60 re W n /A sh Q",
                        {5: _AXIAL[:-2] + b" /BBox [0 0 100 60] >>"}, b"/Shading << /A 5 0 R >>"),
    "radial_cmyk_alpha": (b"q /G gs 10 10 180 80 re W n /R sh Q",
                          {5: _RADIAL, 8: b"<< /ca 0.6 >>"},
                          b"/Shading << /R 5 0 R >> /ExtGState << /G 8 0 R >>"),
    "function_based": (b"/F sh", {5: _FUNC, 6: _FUNC_OBJ}, b"/Shading << /F 5 0 R >>"),
    "mesh_average": (b"q 0 0 m 150 20 l 60 90 l h W n /M sh Q", {5: _MESH},
                     b"/Shading << /M 5 0 R >>"),
    "shading_pattern_clip_evenodd": (
        b"q 20 20 m 180 30 l 100 95 l h W* n /Pattern cs /P scn 0 0 200 100 re "
        b"40 30 60 40 re f* Q", {5: _SHPAT}, b"/Pattern << /P 5 0 R >>"),
    "hatch": (b"/Pattern cs /H scn 10 10 170 80 re f 0 0 0 RG 10 10 170 80 re S",
              {5: _HATCH}, b"/Pattern << /H 5 0 R >>"),
    "hatch_scaled_alpha": (b"q 0.8 0 0 0.8 15 12 cm /Pattern cs /H scn 0 0 m 200 0 l 120 110 l h "
                           b"f Q", {5: _HATCH_SCALED, 8: b"<< /ca 0.5 >>"},
                           b"/Pattern << /H 5 0 R >>"),
    "tiling_turned_grey": (b"/Pattern cs /T scn 20 20 100 60 re f", {5: _TURNED},
                           b"/Pattern << /T 5 0 R >>"),
    "tiling_nested": (b"q 30 10 150 70 re W n /Pattern cs /N scn 0 0 200 100 re f Q",
                      {5: _NESTED, 9: _IMG, 10: _HATCH}, b"/Pattern << /N 5 0 R >>"),
    "pattern_in_form": (b"q 0.9 0 0 0.9 5 5 cm /Fm Do Q",
                        {5: _FORM, 7: _HATCH}, b"/XObject << /Fm 5 0 R >>"),
}


def page_pdf(content: bytes, objs: dict, res: bytes) -> bytes:
    return T._build_pdf(b" /Resources << " + res + b" >>", objs, content)


@pytest.mark.parametrize("name", list(PAGES))
@pytest.mark.parametrize("dpi", [200, 72])
def test_pages_equal_jax(name, dpi):
    content, objs, res = PAGES[name]
    got, want = both(page_pdf(content, objs, res), dpi)
    assert got.shape == want.shape and np.array_equal(got, want)
    assert (got != 255).any()  # something was painted


def test_many_fills_of_one_pattern_equal_jax():
    """Many paths filled with one tiling pattern (its cell drawn once and
    reused from the cache) give the JAX package's raster."""
    content = b"/Pattern cs /H scn " + b" ".join(
        b"%d 10 15 15 re f" % (10 + 20 * i) for i in range(8))
    got, want = both(page_pdf(content, {5: _HATCH}, b"/Pattern << /H 5 0 R >>"), 100)
    assert np.array_equal(got, want) and (got != 255).any()
