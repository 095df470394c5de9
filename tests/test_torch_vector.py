"""Born-digital pages through the port's renderer and ``RapidDoc()``
against the JAX package, on the CPU.

The fixture (``rapiddoc_tpu_torch/assets/vector_smoke_doc.pdf``) is
written by ``make_vector_doc()``: three US Letter pages whose ink is
vector paths, clips, masks and Type3 glyphs.

- Report page: a title, headings and body text in a Type3 outline font
  (``d0`` and filled paths with curves, as matplotlib's ``pdf.fonttype 3``
  writes glyphs; outlines of the DejaVu Sans bundled with matplotlib),
  a ruled 5 x 4 table (``re S`` and ``m l S`` at 0.5-2 pt) whose header
  row is filled through an ExtGState with ``/ca 0.5``, and a display
  formula made of glyphs.
- Figure page: axes under a rectangular clip, a 240-point polyline,
  markers drawn by a Form XObject, an even-odd shape with a hole, curves
  drawn with ``c``, ``v`` and ``y``, an RGB image under a curved clip
  (``W n``), an image with an 8-bit soft mask of half its size, a logo
  under 16384 destination pixels, and images turned by 30 degrees (drawn
  unturned into their box by the JAX package) and by 60 degrees.
- TeX page: text in Type3 bitmap glyphs (``d1`` and an inline image mask,
  as dvips writes them) and a stencil-mask XObject with ``/Decode [1 0]``
  under a green fill.

The golden (``vector_smoke_golden.json``) is the JAX package's reading:
each page's raster sha256 at 200 and 72 dpi, the text dicts, image boxes
and ``classify_pdf``; ``RapidDoc()(pdf, parse_method="ocr")`` in fp32
with the demo layout and every stage on, the int8 formula head off and
on, and ``parse_method="auto"`` (which classifies the document "txt");
and the bf16 "ocr" parse with the int8 head (what ``chip_smoke.py``'s
``vector`` phase bands are set from).

``python tests/test_torch_vector.py`` rebuilds the fixture and the golden
with the JAX package (needs PIL and matplotlib; a few minutes) and prints
the port's bf16 reading on the CPU beside the golden's.
"""
import hashlib
import json
import os
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_table as tt  # noqa: E402
from test_torch_image_inputs import assert_same_parse, clean_env, summary  # noqa: E402

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "vector_smoke_doc.pdf"
GOLDEN_JSON = ASSETS / "vector_smoke_golden.json"
DPIS = (200, 72)
PARSE_ENV = {"RAPIDDOC_DEMO_LAYOUT": "1"}
MODES = {
    # name: (parse_method, environment beyond PARSE_ENV)
    "ocr_fp32": ("ocr", {"RAPIDDOC_FP32_PARAMS": "1"}),
    "ocr_fp32_int8": ("ocr", {"RAPIDDOC_FP32_PARAMS": "1", "RAPIDDOC_INT8_HEAD": "1"}),
    "auto_fp32": ("auto", {"RAPIDDOC_FP32_PARAMS": "1"}),
    "ocr_bf16_int8": ("ocr", {"RAPIDDOC_INT8_HEAD": "1"}),
}


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


# ----------------------------------------------------------------- fixture

GLYPH_NAMES = {" ": "space", ".": "period", ",": "comma", "=": "equal", "+": "plus",
               "(": "parenleft", ")": "parenright", "-": "hyphen", "/": "slash",
               ":": "colon", "%": "percent", "0": "zero", "1": "one", "2": "two",
               "3": "three", "4": "four", "5": "five", "6": "six", "7": "seven",
               "8": "eight", "9": "nine"}
CHARS = (" .,=+()-/:%0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ"
         "abcdefghijklmnopqrstuvwxyz")
WORDS = ("the of and model page layout table vector paths render glyph stroke "
         "clip image mask figure result value data report sample device kernel "
         "width height curve point line text area cell region parse order time "
         "rate score input output batch scan fill color rule grid frame shape").split()


def _name(ch: str) -> str:
    return GLYPH_NAMES.get(ch, ch)


def _fmt(v: float) -> str:
    return f"{v:.1f}".rstrip("0").rstrip(".")


def _outline_glyphs() -> dict[str, tuple[float, bytes]]:
    """Per character: (advance in 1/1000 em, CharProc ``d0`` + filled
    outline), DejaVu Sans outlines as matplotlib's TextPath gives them
    (quadratic segments raised to cubics)."""
    from matplotlib import font_manager
    from matplotlib.font_manager import FontProperties
    from matplotlib.ft2font import FT2Font
    from matplotlib.textpath import TextPath

    prop = FontProperties(family="DejaVu Sans")
    face = FT2Font(font_manager.findfont(prop))
    face.set_size(1000, 72)
    out = {}
    for ch in CHARS:
        adv = face.load_char(ord(ch)).horiAdvance / 64.0 / 8.0  # hinting factor 8
        ops = [f"{_fmt(adv)} 0 d0"]
        if ch != " ":
            path = TextPath((0, 0), ch, size=1000, prop=prop)
            verts, codes = path.vertices, path.codes
            i, cur = 0, (0.0, 0.0)
            while i < len(codes):
                c = codes[i]
                if c == 1:
                    cur = tuple(verts[i])
                    ops.append(f"{_fmt(cur[0])} {_fmt(cur[1])} m")
                    i += 1
                elif c == 2:
                    cur = tuple(verts[i])
                    ops.append(f"{_fmt(cur[0])} {_fmt(cur[1])} l")
                    i += 1
                elif c == 3:
                    q, p = verts[i], verts[i + 1]
                    c1 = (cur[0] + 2 / 3 * (q[0] - cur[0]), cur[1] + 2 / 3 * (q[1] - cur[1]))
                    c2 = (p[0] + 2 / 3 * (q[0] - p[0]), p[1] + 2 / 3 * (q[1] - p[1]))
                    ops.append(" ".join(_fmt(v) for v in (*c1, *c2, *p)) + " c")
                    cur = tuple(p)
                    i += 2
                elif c == 4:
                    ops.append(" ".join(_fmt(v) for v in (*verts[i], *verts[i + 1],
                                                          *verts[i + 2])) + " c")
                    cur = tuple(verts[i + 2])
                    i += 3
                else:
                    ops.append("h")
                    i += 1
            ops.append("f")
        out[ch] = (adv, "\n".join(ops).encode())
    return out


def _bitmap_glyphs() -> dict[str, tuple[float, bytes]]:
    """Per character: (advance in 1/100 em, CharProc ``d1`` + an inline
    1-bit image mask, hex-coded), from a 40 px DejaVu Sans bitmap drawn by
    PIL and thresholded, as dvips writes TeX's bitmap fonts."""
    from matplotlib import font_manager
    from matplotlib.font_manager import FontProperties
    from PIL import Image, ImageDraw, ImageFont

    font = ImageFont.truetype(font_manager.findfont(FontProperties(family="DejaVu Sans")), 40)
    ascent, _ = font.getmetrics()
    out = {}
    for ch in CHARS:
        adv = font.getlength(ch) * 100 / 40
        if ch == " ":
            out[ch] = (adv, f"{_fmt(adv)} 0 0 0 0 0 d1".encode())
            continue
        im = Image.new("L", (60, 60), 0)
        ImageDraw.Draw(im).text((5, 5), ch, font=font, fill=255)
        bits = np.asarray(im) >= 128
        ys, xs = np.nonzero(bits)
        y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
        cell = bits[y0:y1, x0:x1]
        h, w = cell.shape
        # 0 paints (no /Decode): ink samples are 0
        data = np.packbits(~cell, axis=1).tobytes()
        llx = (x0 - 5) * 100 / 40
        lly = (ascent + 5 - y1) * 100 / 40
        sw, sh = w * 100 / 40, h * 100 / 40
        proc = (f"{_fmt(adv)} 0 {_fmt(llx)} {_fmt(lly)} {_fmt(llx + sw)} {_fmt(lly + sh)} d1\n"
                f"q {_fmt(sw)} 0 0 {_fmt(sh)} {_fmt(llx)} {_fmt(lly)} cm\n"
                f"BI /W {w} /H {h} /IM true /BPC 1 /F /AHx ID\n"
                f"{data.hex()}>\nEI Q").encode()
        out[ch] = (adv, proc)
    return out


def _text_lines(seed: int, n: int, length: int) -> list[str]:
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        words = []
        while len(" ".join(words)) < length:
            words.append(str(rng.choice(WORDS)))
        line = " ".join(words)[:length].rsplit(" ", 1)[0]
        lines.append(line[0].upper() + line[1:] + ".")
    return lines


def _show(font: str, size: float, x: float, y: float, text: str) -> str:
    esc = text.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")
    return f"BT /{font} {_fmt(size)} Tf {_fmt(x)} {_fmt(y)} Td ({esc}) Tj ET"


def _report_content() -> str:
    ops = ["0 g", _show("T1", 18, 72, 730, "Vector Rendering Report 2026")]
    ops.append(_show("T1", 12, 72, 700, "1 Introduction"))
    y = 682
    for line in _text_lines(1, 7, 92):
        ops.append(_show("T1", 9, 72, y, line))
        y -= 12
    ops.append(_show("T1", 12, 72, y - 8, "2 Results"))
    y -= 26
    for line in _text_lines(2, 3, 92):
        ops.append(_show("T1", 9, 72, y, line))
        y -= 12
    # the table: 5 rows x 4 columns, header filled at ca 0.5
    top, rh, left, cw = y - 10, 20, 72, 117
    rows, cols = 5, 4
    bottom, right = top - rows * rh, left + cols * cw
    ops.append(f"q /GS0 gs 0.2 0.4 0.8 rg {left} {top - rh} {cols * cw} {rh} re f Q")
    ops.append(f"q 1.5 w 0 G {left} {bottom} {cols * cw} {rows * rh} re S Q")
    ops.append("q 0.5 w 0.3 G")
    for r in range(1, rows):
        yy = top - r * rh
        ops.append(f"{left} {yy} m {right} {yy} l S")
    for c in range(1, cols):
        xx = left + c * cw
        ops.append(f"{xx} {bottom} m {xx} {top} l S")
    ops.append("Q")
    ops.append(f"q 2 w 0 G {left} {top - rh} m {right} {top - rh} l S Q")
    head = ["Region", "Count", "Width", "Score"]
    cells = [head] + [[f"cell {r}{c}" if c == 0 else f"{(r * 37 + c * 11) % 97}.{c}"
                       for c in range(cols)] for r in range(1, rows)]
    for r, row in enumerate(cells):
        for c, text in enumerate(row):
            ops.append(_show("T1", 9, left + c * cw + 6, top - r * rh - 14, text))
    y = bottom - 34
    ops.append(_show("T1", 13, 190, y, "E = m (a + b) / 2 + 3 x"))
    y -= 30
    for line in _text_lines(3, 3, 92):
        ops.append(_show("T1", 9, 72, y, line))
        y -= 12
    return "\n".join(ops)


def _figure_content() -> str:
    ops = ["0 g", _show("T1", 12, 72, 740, "Figure 1: a sampled curve and its markers")]
    # axes under a rectangular clip
    ax0, ay0, aw, ah = 90, 470, 420, 230
    ops.append(f"q 1 w 0 G {ax0} {ay0} m {ax0} {ay0 + ah} l S {ax0} {ay0} m {ax0 + aw} {ay0} l S Q")
    ops.append("q 0.5 w 0.4 G")
    for i in range(1, 8):
        x = ax0 + i * aw / 8
        ops.append(f"{_fmt(x)} {ay0} m {_fmt(x)} {ay0 - 6} l S")
    ops.append("Q")
    ops.append(f"q {ax0} {ay0} {aw} {ah} re W n 1.5 w 0.1 0.2 0.7 RG")
    xs = np.linspace(0, 1, 240)
    pts = [(ax0 + 5 + x * (aw - 10), ay0 + ah / 2 + 0.42 * ah * np.sin(9 * x) * np.exp(-1.3 * x))
           for x in xs]
    ops.append(f"{_fmt(pts[0][0])} {_fmt(pts[0][1])} m " +
               " ".join(f"{_fmt(x)} {_fmt(y)} l" for x, y in pts[1:]) + " S")
    for x, y in pts[::16]:
        ops.append(f"q 1 0 0 1 {_fmt(x)} {_fmt(y)} cm /Mk Do Q")
    ops.append("Q")
    # an even-odd shape with a hole, and curves drawn with c, v and y
    ops.append("q 0.9 0.5 0.1 rg 90 300 m 230 300 l 230 420 l 90 420 l h "
               "120 330 m 200 330 l 200 390 l 120 390 l h f* Q")
    ops.append("q 0.1 0.6 0.3 rg 260 300 m 300 420 340 420 380 330 c 400 360 410 300 v "
               "330 260 300 280 y h f Q")
    ops.append("q 2 w 0.6 0 0.6 RG 420 300 m 450 420 480 260 520 400 c S Q")
    ops.append(_show("T1", 9, 90, 285, "Even-odd fill, cubic curves, a curved clip and placed images."))
    # images: curved clip over RGB, soft mask, small logo, turned by 30 and 60
    ops.append("q 160 160 m 160 215 210 250 245 250 c 290 250 320 215 320 160 c "
               "320 110 290 70 245 70 c 200 70 160 110 160 160 c h W n "
               "170 0 0 170 155 75 cm /ImA Do Q")
    ops.append("q 120 0 0 90 350 150 cm /ImS Do Q")
    ops.append("q 48 0 0 32 500 180 cm /Logo Do Q")
    ops.append("q 86.6 50 -50 86.6 110 40 cm /ImA Do Q")
    ops.append("q 50 86.6 -86.6 50 520 30 cm /ImA Do Q")
    return "\n".join(ops)


def _tex_content() -> str:
    ops = ["0 g", _show("B1", 16, 72, 720, "Bitmap Glyphs from a TeX Run")]
    y = 690
    for line in _text_lines(4, 8, 84):
        ops.append(_show("B1", 10, 72, y, line))
        y -= 14
    ops.append("q 0.1 0.5 0.2 rg 140 0 0 100 380 150 cm /Stamp Do Q")
    ops.append(_show("B1", 10, 72, 160, "Stencil mask with Decode 1 0 in green."))
    return "\n".join(ops)


def _images() -> dict[str, np.ndarray]:
    rng = np.random.default_rng(12)
    yy, xx = np.mgrid[0:96, 0:128]
    rgb = np.stack([(xx * 2) % 256, (yy * 2 + 40) % 256,
                    (128 + 60 * np.sin(xx / 9.0) * np.cos(yy / 7.0)).astype(int)], -1)
    rgb = np.clip(rgb + rng.integers(-12, 13, rgb.shape), 0, 255).astype(np.uint8)
    alpha = np.clip(255 - np.hypot(np.mgrid[0:48, 0:64][0] - 24, np.mgrid[0:48, 0:64][1] - 32)
                    * 8, 0, 255).astype(np.uint8)
    logo = np.zeros((40, 60, 3), np.uint8)
    logo[..., 0] = 200
    logo[8:32, 10:50] = (255, 255, 255)
    logo[14:26, 18:42] = (30, 30, 160)
    stamp = np.zeros((50, 70), bool)
    sy, sx = np.mgrid[0:50, 0:70]
    stamp |= (np.abs(np.hypot(sy - 25, sx - 35) - 20) < 3)
    stamp[22:28, 10:60] = True
    return {"rgb": rgb, "alpha": alpha, "logo": logo, "stamp": stamp}


def make_vector_doc() -> bytes:
    """The fixture PDF (see the module docstring), written by code."""
    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    N = Name
    w = PdfWriter()
    pages_ref = w.reserve()

    def flate(d: dict, data: bytes):
        d = dict(d)
        d[N("Filter")] = N("FlateDecode")
        return w.add(Stream(d, zlib.compress(data, 9)))

    def type3(glyphs, matrix, bbox):
        procs = {N(_name(ch)): flate({}, proc) for ch, (_, proc) in glyphs.items()}
        codes = sorted(ord(ch) for ch in glyphs)
        diffs = []
        for code in codes:
            diffs += [code, N(_name(chr(code)))]
        widths = [glyphs[chr(c)][0] if chr(c) in glyphs else 0
                  for c in range(codes[0], codes[-1] + 1)]
        return w.add({N("Type"): N("Font"), N("Subtype"): N("Type3"),
                      N("FontBBox"): bbox, N("FontMatrix"): matrix,
                      N("CharProcs"): procs, N("Resources"): {},
                      N("Encoding"): {N("Type"): N("Encoding"), N("Differences"): diffs},
                      N("FirstChar"): codes[0], N("LastChar"): codes[-1],
                      N("Widths"): [round(v, 2) for v in widths]})

    outline = type3(_outline_glyphs(), [0.001, 0, 0, 0.001, 0, 0], [-1100, -300, 1900, 1000])
    bitmap = type3(_bitmap_glyphs(), [0.01, 0, 0, 0.01, 0, 0], [-20, -30, 190, 100])
    img = _images()

    def image(arr, **extra):
        d = {N("Type"): N("XObject"), N("Subtype"): N("Image"),
             N("Width"): arr.shape[1], N("Height"): arr.shape[0], N("BitsPerComponent"): 8,
             N("ColorSpace"): N("DeviceRGB" if arr.ndim == 3 else "DeviceGray")}
        d.update(extra)
        return flate(d, arr.tobytes())

    im_a = image(img["rgb"])
    im_s = image(img["rgb"], **{N("SMask"): image(img["alpha"])})
    logo = image(img["logo"])
    stamp = flate({N("Type"): N("XObject"), N("Subtype"): N("Image"),
                   N("Width"): 70, N("Height"): 50, N("ImageMask"): True,
                   N("Decode"): [1, 0]}, np.packbits(img["stamp"], axis=1).tobytes())
    marker = flate({N("Type"): N("XObject"), N("Subtype"): N("Form"),
                    N("BBox"): [-5, -5, 5, 5]},
                   b"0.85 0.1 0.1 rg 4 0 m 4 2.2 2.2 4 0 4 c -2.2 4 -4 2.2 -4 0 c "
                   b"-4 -2.2 -2.2 -4 0 -4 c 2.2 -4 4 -2.2 4 0 c f")
    resources = {N("Font"): {N("T1"): outline, N("B1"): bitmap},
                 N("ExtGState"): {N("GS0"): {N("Type"): N("ExtGState"), N("ca"): 0.5}},
                 N("XObject"): {N("ImA"): im_a, N("ImS"): im_s, N("Logo"): logo,
                                N("Stamp"): stamp, N("Mk"): marker}}
    kids = []
    for content in (_report_content(), _figure_content(), _tex_content()):
        kids.append(w.add({N("Type"): N("Page"), N("Parent"): pages_ref,
                           N("MediaBox"): [0, 0, 612, 792], N("Resources"): resources,
                           N("Contents"): flate({}, content.encode())}))
    w.set(pages_ref, {N("Type"): N("Pages"), N("Kids"): kids, N("Count"): len(kids)})
    root = w.add({N("Type"): N("Catalog"), N("Pages"): pages_ref})
    return w.tobytes(root)


# ------------------------------------------------------------------ golden

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
    """The JAX package's parse in ``mode``. The int8 head is quantized
    eagerly first (its ``_int8_head()`` caches a tracer when the jitted
    decode calls it first, and a second trace then fails)."""
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    method, env = MODES[mode]
    with clean_env(**PARSE_ENV, **env):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        analyzer = ModelStack.get("ch", True, True, {
            "layout": {}, "ocr": {}, "formula": {}, "table": {}, "checkbox": {}}).analyzer
        if "INT8" in " ".join(env):
            assert analyzer.formula_model._int8_head() is not None
        got = summary(rapid(pdf, parse_method=method))
        ModelStack._instances.clear()
    return got


def make_golden(pdf: bytes) -> dict:
    golden = {
        "source": "rapiddoc_tpu on the CPU: render_page_full, classify_pdf and "
                  "RapidDoc()(pdf, parse_method=...) with RAPIDDOC_DEMO_LAYOUT=1 and "
                  "every stage on; rebuilt by tests/test_torch_vector.py",
        "render": json.loads(json.dumps(jax_render(pdf))),
    }
    for mode in MODES:
        golden[mode] = jax_parse(pdf, mode)
    return golden


def port_parse(pdf: bytes, mode: str):
    """The port's RapidDoc on the CPU in ``mode``."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    method, env = MODES[mode]
    dtype = torch.float32 if "fp32" in mode else torch.bfloat16
    with clean_env(**PARSE_ENV, **{k: v for k, v in env.items() if k != "RAPIDDOC_FP32_PARAMS"}):
        return RapidDoc(device="cpu", dtype=dtype)(pdf, parse_method=method)


# ---------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pdf() -> bytes:
    return DOC_PDF.read_bytes()


# ------------------------------------------------------------------- tests

def test_committed_fixture_is_make_vector_doc(pdf):
    assert make_vector_doc() == pdf
    assert len(pdf) < 1 << 20


@pytest.mark.parametrize("dpi", DPIS)
def test_pages_byte_equal_jax(pdf, dpi):
    """Every page's raster equals the JAX package's (its sha256 in the
    golden, and the JAX renderer run here); text dicts and image boxes
    equal."""
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render_page

    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    golden = json.loads(GOLDEN_JSON.read_text())["render"]["pages"][str(dpi)]
    doc, jdoc = open_pdf(pdf), jax_open(pdf)
    for i, want in enumerate(golden):
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


@pytest.mark.parametrize("mode", ["ocr_fp32", "ocr_fp32_int8", "auto_fp32"])
def test_parse_equals_golden(pdf, golden, mode):
    """RapidDoc(device="cpu") in fp32 gives the JAX package's Markdown,
    content list, table HTML, LaTeX, layout dets and span payloads."""
    assert_same_parse(summary(port_parse(pdf, mode)), golden[mode])


def compare(pdf: bytes, golden: dict) -> dict:
    """The port's bf16 "ocr" parse with the int8 head on the CPU against
    the golden's (the source of chip_smoke.py's VECTOR_BF16 bands)."""
    import chip_smoke as smoke

    got = summary(port_parse(pdf, "ocr_bf16_int8"))
    return {"port_bf16_int8_cpu": smoke.compare_layout_parse(got, golden["ocr_bf16_int8"]),
            "jax_fp32_int8_vs_bf16_int8": smoke.compare_layout_parse(
                golden["ocr_fp32_int8"], golden["ocr_bf16_int8"])}


if __name__ == "__main__":
    # Rewrites the fixture and the golden, then prints compare().
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" not in sys.argv[1:]:
        data = make_vector_doc()
        DOC_PDF.write_bytes(data)
        GOLDEN_JSON.write_text(json.dumps(make_golden(data), indent=1) + "\n")
        print("wrote", DOC_PDF, GOLDEN_JSON)
    print(json.dumps(compare(DOC_PDF.read_bytes(), json.loads(GOLDEN_JSON.read_text())), indent=1))
