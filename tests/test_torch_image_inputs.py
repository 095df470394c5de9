"""The port's image inputs, PDF writer, batched parsing and original images
against PIL and the JAX package, on the CPU.

- ``pdfio/png.py`` against PIL: every colour type (0, 2, 3, 4, 6) at every
  8-bit-or-less depth, with the five row filters mixed per row, a short
  palette and a tRNS chunk: the pixels ``images_to_pdf`` takes (mode
  ``L`` grey, else RGB) equal; 16-bit and interlaced PNGs too (every
  form in ``tests/test_torch_image_files.py``), while WEBP raises
  NotImplementedError (ROADMAP item 12f).
- ``pdfio/jpeg_encode.py`` at quality 92 and other qualities, RGB and grey
  (mode ``L``): bytes equal to PIL's.
- ``pdfio/writer.py``: ``images_to_pdf`` of PNG and JPEG files and of
  grey, RGB and RGBA arrays, and ``select_pages``: bytes equal to the JAX
  package's.
- ``resize_area`` where INTER_AREA enlarges an axis: equal to cv2.
- ``RapidDoc(device="cpu")`` in fp32 with the demo layout and the formula
  stage (table off) on the committed inputs: a PNG path
  (``image_inputs_page.png``), JPEG bytes (``image_inputs_page.jpg``) and
  an (H, W, 3) array (``image_inputs_array.png``'s pixels): the PDF each
  becomes, the Markdown, content list, LaTeX and payloads equal to the
  JAX package's golden (``image_inputs_golden.json``); ``parse_batch``
  over [the JPEG input's PDF, the PNG path] equal to the single parses;
  ``image_config={"extract_original_image": True}`` on
  ``originals_doc.pdf`` (two embedded images drawn enlarged, fallback
  layout) gives the golden's payloads, the embedded images' own pixels.

``python tests/test_torch_image_inputs.py`` rebuilds the inputs and the
golden with the JAX package (needs PIL; about 6 minutes); the golden's
``table_on`` part (every stage on) is what the smoke's ``image_inputs``
phase holds the card's fp32 parse to.
"""
import hashlib
import io
import json
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_pipeline_layout as pl  # noqa: E402
import test_torch_table as tt  # noqa: E402

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
PNG_PATH = ASSETS / "image_inputs_page.png"
JPEG_PATH = ASSETS / "image_inputs_page.jpg"
ARRAY_PNG = ASSETS / "image_inputs_array.png"
ORIGINALS_PDF = ASSETS / "originals_doc.pdf"
GOLDEN_JSON = ASSETS / "image_inputs_golden.json"
DPI = 200  # get_pdf_render_dpi()
JPEG_INPUT_QUALITY = 85
DET_BOX_TOL = 0.05  # px, the layout detector's fp32 boxes (chip_smoke.LAYOUT_BOX_TOL)
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class clean_env:
    """Every RAPIDDOC_*/MINERU_* setting held off, then ``extra``."""

    def __init__(self, **extra: str):
        self.extra = extra

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items() if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        os.environ.update(self.extra)
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


# stages per configuration: the CPU test runs table_off, the smoke table_on
CONFIGS = {
    "table_off": {"RAPIDDOC_DEMO_LAYOUT": "1", "RAPIDDOC_DISABLE_TABLE": "1"},
    "table_on": {"RAPIDDOC_DEMO_LAYOUT": "1"},
}
ORIGINALS_ENV = {"RAPIDDOC_DISABLE_LAYOUT": "1", "RAPIDDOC_DISABLE_FORMULA": "1",
                 "RAPIDDOC_DISABLE_TABLE": "1"}


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


# ------------------------------------------------------------------ inputs

def _pil_bytes(arr: np.ndarray, fmt: str, **kw) -> bytes:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


def make_inputs() -> dict[str, bytes]:
    """Three pages of the layout fixture's generator as a PNG, a JPEG and
    the PNG whose pixels are the array input; a PDF with two embedded
    images (a JPEG and raw Flate RGB) drawn enlarged."""
    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    pages = pl.make_pages()
    out = {
        PNG_PATH.name: _pil_bytes(pages[0], "PNG"),
        JPEG_PATH.name: _pil_bytes(pages[1], "JPEG", quality=JPEG_INPUT_QUALITY),
        ARRAY_PNG.name: _pil_bytes(pages[2], "PNG"),
    }
    fig_a = np.ascontiguousarray(pages[3][40:240, 60:360])
    rng = np.random.default_rng(7)
    fig_b = np.clip(np.cumsum(rng.integers(-9, 10, (160, 240, 3)), axis=1) + 128, 0, 255).astype(np.uint8)
    writer = PdfWriter()
    pages_ref = writer.reserve()
    img_a = writer.add(Stream({Name("Type"): Name("XObject"), Name("Subtype"): Name("Image"),
                               Name("Width"): 300, Name("Height"): 200,
                               Name("ColorSpace"): Name("DeviceRGB"), Name("BitsPerComponent"): 8,
                               Name("Filter"): Name("DCTDecode")},
                              _pil_bytes(fig_a, "JPEG", quality=90)))
    img_b = writer.add(Stream({Name("Type"): Name("XObject"), Name("Subtype"): Name("Image"),
                               Name("Width"): 240, Name("Height"): 160,
                               Name("ColorSpace"): Name("DeviceRGB"), Name("BitsPerComponent"): 8,
                               Name("Filter"): Name("FlateDecode")},
                              zlib.compress(fig_b.tobytes())))
    content = b"q 300 0 0 200 72 520 cm /ImA Do Q q 240 0 0 160 300 200 cm /ImB Do Q"
    page = {Name("Type"): Name("Page"), Name("Parent"): pages_ref,
            Name("MediaBox"): [0, 0, 612, 792],
            Name("Resources"): {Name("XObject"): {Name("ImA"): img_a, Name("ImB"): img_b}},
            Name("Contents"): writer.add(Stream({}, content))}
    kid = writer.add(page)
    writer.set(pages_ref, {Name("Type"): Name("Pages"), Name("Kids"): [kid], Name("Count"): 1})
    root = writer.add({Name("Type"): Name("Catalog"), Name("Pages"): pages_ref})
    out[ORIGINALS_PDF.name] = writer.tobytes(root)
    return out


def load_inputs() -> dict:
    """The committed inputs as the tests and the smoke pass them."""
    from rapiddoc_tpu_torch.pdfio.png import decode_png

    return {"png_path": PNG_PATH, "jpeg_bytes": JPEG_PATH.read_bytes(),
            "array": decode_png(ARRAY_PNG.read_bytes()),
            "originals_pdf": ORIGINALS_PDF.read_bytes()}


def summary(out) -> dict:
    got = pl.summary(out)
    got["model_info"] = tt.mask_uuids(pl.plain([[{"category_id": d["category_id"],
                                                  "poly": d["poly"], "text": d.get("text", "")}
                                                 for d in p["layout_dets"]]
                                                for p in out.model_json]), out.model_json)
    return got


def jax_parses(config: str) -> dict:
    from PIL import Image

    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack
    from rapiddoc_tpu.pdfio.writer import images_to_pdf

    jpeg = JPEG_PATH.read_bytes()
    array = np.asarray(Image.open(ARRAY_PNG))
    with clean_env(RAPIDDOC_FP32_PARAMS="1", **CONFIGS[config]):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        got = {"png": summary(rapid(str(PNG_PATH), parse_method="ocr")),
               "jpeg": summary(rapid(jpeg, parse_method="ocr")),
               "array": summary(rapid(array, parse_method="ocr"))}
        rapid = RapidDoc(parse_method="ocr")
        got["batch"] = [summary(o) for o in rapid.parse_batch(
            [images_to_pdf([jpeg], dpi=DPI), str(PNG_PATH)])]
        ModelStack._instances.clear()
    return got


def make_golden() -> dict:
    from PIL import Image

    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack
    from rapiddoc_tpu.pdfio.writer import images_to_pdf

    array = np.asarray(Image.open(ARRAY_PNG))
    pdfs = {"png": images_to_pdf([PNG_PATH.read_bytes()], dpi=DPI),
            "jpeg": images_to_pdf([JPEG_PATH.read_bytes()], dpi=DPI),
            "array": images_to_pdf([_pil_bytes(array, "PNG")], dpi=DPI)}
    originals = {}
    for extract in (True, False):
        with clean_env(RAPIDDOC_FP32_PARAMS="1", **ORIGINALS_ENV):
            ModelStack._instances.clear()
            out = RapidDoc(image_config={"extract_original_image": extract})(
                ORIGINALS_PDF.read_bytes(), parse_method="ocr")
            ModelStack._instances.clear()
        originals["extract" if extract else "crop"] = pl.summary(out)
    return {
        "source": "rapiddoc_tpu RapidDoc()(input, parse_method='ocr') in fp32 on the CPU; "
                  "rebuilt by tests/test_torch_image_inputs.py",
        "dpi": DPI,
        "pdf_sha256": {k: sha256(v) for k, v in pdfs.items()},
        "table_off": jax_parses("table_off"),
        "table_on": jax_parses("table_on"),
        "originals": originals,
    }


# --------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def inputs() -> dict:
    return load_inputs()


# --------------------------------------------------------------- codecs

def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def write_png(samples: np.ndarray, depth: int, ctype: int, filters, palette=None,
              trns: bytes | None = None, interlace: int = 0) -> bytes:
    """A PNG of (H, W * channels) samples below 2**depth, each row filtered
    with its own filter type."""
    h = samples.shape[0]
    if depth < 8:
        per = 8 // depth
        width = samples.shape[1]
        padded = np.zeros((h, -(-width // per) * per), np.int64)
        padded[:, :width] = samples
        rows = np.zeros((h, padded.shape[1] // per), np.int64)
        for k in range(per):
            rows = rows * (1 << depth) + padded[:, k::per]
    else:
        rows = samples.astype(np.int64)
        width = samples.shape[1] // CHANNELS[ctype]
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    data = bytearray()
    prev = np.zeros(rows.shape[1], np.int64)
    for y in range(h):
        r, f = rows[y], int(filters[y])
        line = [f]
        for x in range(len(r)):
            a = r[x - bpp] if x >= bpp else 0
            c = prev[x - bpp] if x >= bpp else 0
            pred = (0, a, prev[x], (a + prev[x]) // 2, _paeth(a, prev[x], c))[f]
            line.append(int(r[x] - pred) & 255)
        data += bytes(line)
        prev = r

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", width, h, depth, ctype,
                                                             0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", bytes(np.asarray(palette, np.uint8).ravel()))
    if trns is not None:
        out += chunk(b"tRNS", trns)
    return out + chunk(b"IDAT", zlib.compress(bytes(data))) + chunk(b"IEND", b"")


@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (2, 8), (3, 1), (3, 2),
                                         (3, 4), (3, 8), (4, 8), (6, 8)])
def test_png_decoder_equals_pil(ctype, depth):
    """Seeded PNGs with every filter mixed per row (and one filter for the
    whole image): the pixels PIL gives images_to_pdf, equal."""
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.png import decode_png

    rng = np.random.default_rng(ctype * 16 + depth)
    for t in range(6):
        h, w = int(rng.integers(1, 24)), int(rng.integers(1, 30))
        samples = rng.integers(0, 1 << depth, (h, w * CHANNELS[ctype]))
        palette = rng.integers(0, 256, (int(rng.integers(1, (1 << depth) + 1)), 3)) \
            if ctype == 3 else None
        filters = rng.integers(0, 5, h) if t >= 5 else np.full(h, t)
        trns = {0: b"\x00\x01", 2: b"\x00\x01\x00\x02\x00\x03", 3: b"\x00\x80"}.get(ctype) \
            if t == 2 else None
        data = write_png(samples, depth, ctype, filters, palette, trns)
        img = Image.open(io.BytesIO(data))
        img.load()
        want = np.asarray(img if img.mode in ("L", "RGB") else img.convert("RGB"))
        got = decode_png(data)
        assert got.shape == want.shape and np.array_equal(got, want)


def test_png_inputs_not_ported_raise():
    """16-bit and interlaced PNGs decode as PIL opens them now
    (``tests/test_torch_image_files.py`` holds every form); WEBP and
    unknown files still raise, naming ROADMAP item 12f."""
    from PIL import Image
    from torch_image_files import png_bytes

    from rapiddoc_tpu_torch.pdfio.png import decode_image, decode_png

    rng = np.random.default_rng(0)
    for data in (png_bytes(rng.integers(0, 65535, (2, 6, 3)), 16, 2),
                 png_bytes(rng.integers(0, 255, (5, 6, 3)), 8, 2, interlace=True)):
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(decode_png(data), want)
    for data, name in ((b"RIFF\0\0\0\0WEBPVP8 ", "WEBP images"),
                       (b"\x00\x01" + bytes(20), "image files other than")):
        with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP Queue 1 item 12: 12f"):
            decode_image(data)


def test_jpeg_encoder_qualities_and_grey_equal_pil():
    """q92 (images_to_pdf) and other qualities, RGB 4:2:0 and grey: PIL's
    bytes."""
    from rapiddoc_tpu_torch.pdfio.jpeg_encode import encode_jpeg

    rng = np.random.default_rng(1)
    for i, quality in enumerate((92, 92, 92, 10, 49, 50, 75, 95, 100, 1)):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        for shape in ((h, w, 3), (h, w)):
            img = rng.integers(0, 256, shape, dtype=np.uint8)
            if i % 2:
                img = np.clip(np.cumsum(img.astype(int), axis=0) // 4, 0, 255).astype(np.uint8)
            assert encode_jpeg(img, quality) == _pil_bytes(img, "JPEG", quality=quality)


def test_images_to_pdf_and_select_pages_equal_jax_package(inputs):
    """PNG and JPEG files, grey, RGB and RGBA arrays: the JAX package's PDF
    bytes (its arrays go through PIL); select_pages of the result too."""
    from PIL import Image

    from rapiddoc_tpu.pdfio.writer import images_to_pdf as jax_images_to_pdf
    from rapiddoc_tpu.pdfio.writer import select_pages as jax_select_pages

    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf, select_pages

    rng = np.random.default_rng(2)
    grey = rng.integers(0, 256, (37, 51), dtype=np.uint8)
    rgba = rng.integers(0, 256, (20, 30, 4), dtype=np.uint8)
    small = [_pil_bytes(inputs["array"][:64, :80], "PNG"), _pil_bytes(grey, "PNG"),
             _pil_bytes(grey, "JPEG"), grey, rgba]
    want = jax_images_to_pdf([Image.fromarray(x) if isinstance(x, np.ndarray) else x
                              for x in small], dpi=144)
    got = images_to_pdf(small, dpi=144)
    assert got == want
    assert select_pages(got, [3, 0, 9]) == jax_select_pages(want, [3, 0, 9])


def test_committed_inputs_and_their_pdfs(inputs, golden):
    """The inputs are the generator's; each becomes the golden's PDF."""
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    made = make_inputs()
    for path in (PNG_PATH, JPEG_PATH, ARRAY_PNG, ORIGINALS_PDF):
        assert made[path.name] == path.read_bytes(), path.name
    pdfs = {"png": images_to_pdf([PNG_PATH.read_bytes()], dpi=DPI),
            "jpeg": images_to_pdf([inputs["jpeg_bytes"]], dpi=DPI),
            "array": images_to_pdf([inputs["array"]], dpi=DPI)}
    assert {k: sha256(v) for k, v in pdfs.items()} == golden["pdf_sha256"]


def test_resize_area_enlarging_an_axis_equals_cv2():
    """INTER_AREA where either axis grows (OpenCV's linear path with area
    coefficients), and where both shrink: equal to cv2."""
    cv2 = pytest.importorskip("cv2")
    from rapiddoc_tpu_torch.models.ocr.pre_post import resize_area

    rng = np.random.default_rng(3)
    for i in range(120):
        h, w = int(rng.integers(2, 90)), int(rng.integers(2, 90))
        oh, ow = (h + int(rng.integers(-1, 2)), w + int(rng.integers(-1, 2))) if i % 3 == 0 \
            else (int(rng.integers(2, 140)), int(rng.integers(2, 140)))
        oh, ow = max(oh, 1), max(ow, 1)
        img = rng.integers(0, 256, (h, w, 3) if i % 2 else (h, w), dtype=np.uint8)
        assert np.array_equal(resize_area(img, ow, oh),
                              cv2.resize(img, (ow, oh), interpolation=cv2.INTER_AREA))


# ----------------------------------------------------------------- parses

def port_parses(inputs: dict, config: str) -> dict:
    """The port's fp32 parses of the three inputs and parse_batch over [the
    JPEG input's PDF, the PNG path]."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    with clean_env(**CONFIGS[config]):
        rapid = RapidDoc(device="cpu", dtype=torch.float32)
        got = {"png": summary(rapid(inputs["png_path"], parse_method="ocr")),
               "jpeg": summary(rapid(inputs["jpeg_bytes"], parse_method="ocr")),
               "array": summary(rapid(inputs["array"], parse_method="ocr"))}
        rapid = RapidDoc(device="cpu", dtype=torch.float32, parse_method="ocr")
        got["batch"] = [summary(o) for o in rapid(
            [images_to_pdf([inputs["jpeg_bytes"]], dpi=DPI), inputs["png_path"]])]
    return got


def test_image_input_parses_equal_golden(inputs, golden):
    """fp32 with the demo layout and the formula stage: the PNG path, the
    JPEG bytes and the array parse as the JAX package parses them, and
    RapidDoc()([pdf, png]) (parse_batch) gives the single parses."""
    got = port_parses(inputs, "table_off")
    want = golden["table_off"]
    for key in ("png", "jpeg", "array"):
        assert_same_parse(got[key], want[key])
    assert want["png"]["latex"] != [[]]  # the formula stage ran
    for batched, want_b, single in zip(got["batch"], want["batch"], (got["jpeg"], got["png"])):
        assert_same_parse(batched, want_b)
        assert_same_parse(batched, single)


def assert_same_parse(got: dict, want: dict) -> None:
    """Markdown, content list, LaTeX and payloads equal; the dets'
    categories and texts equal, their boxes within DET_BOX_TOL."""
    for part in ("markdown", "content_list", "latex", "images"):
        assert got[part] == want[part], part
    assert [len(p) for p in got["model_info"]] == [len(p) for p in want["model_info"]]
    for gp, wp in zip(got["model_info"], want["model_info"]):
        for g, w in zip(gp, wp):
            assert (g["category_id"], g["text"]) == (w["category_id"], w["text"])
            assert np.abs(np.asarray(g["poly"]) - np.asarray(w["poly"])).max() <= DET_BOX_TOL


def test_extract_original_image_equals_golden(inputs, golden):
    """image_config={"extract_original_image": True}: each image span that
    matches an embedded image (a JPEG and a Flate RGB one, drawn
    enlarged) writes that image's own pixels as PIL's q90 JPEG, as the JAX
    package does; without it the spans are crops of the rendered page."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio.jpeg_encode import encode_jpeg

    got = {}
    for extract in (True, False):
        with clean_env(**ORIGINALS_ENV):
            out = RapidDoc(device="cpu", dtype=torch.float32,
                           image_config={"extract_original_image": extract})(
                inputs["originals_pdf"], parse_method="ocr")
        got["extract" if extract else "crop"] = pl.summary(out)
        if extract:
            payloads = set(out.images.values())
    assert got == golden["originals"]
    assert got["extract"]["images"] != got["crop"]["images"]
    assert {encode_jpeg(p) for p in _embedded_pixels(inputs["originals_pdf"])} <= payloads


def _embedded_pixels(pdf: bytes) -> list[np.ndarray]:
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.images import xobject_to_array
    from rapiddoc_tpu_torch.pdfio.placements import original_image_streams

    doc = open_pdf(pdf)
    return [xobject_to_array(doc, s) for _, s in original_image_streams(doc.get_page(0))]


if __name__ == "__main__":
    # Rewrites the inputs and the golden.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    for name, data in make_inputs().items():
        (ASSETS / name).write_bytes(data)
    GOLDEN_JSON.write_text(json.dumps(make_golden(), indent=1) + "\n")
    print("wrote", GOLDEN_JSON)
