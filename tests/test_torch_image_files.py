"""The port's image-file decoders and array conversions against PIL and the
JAX package, on the CPU.

- ``pdfio/png.py``: every bit depth and colour type, 16-bit ones
  included, plain and Adam7-interlaced, each row under a seeded filter;
- ``pdfio/bmp.py``: 1, 4, 8, 16, 24 and 32 bits; BI_RGB, RLE8, RLE4
  and BITFIELDS (every mask layout PIL knows); bottom-up and top-down;
  12- to 124-byte headers; grey and two-colour palettes; PIL's own BMPs;
- ``pdfio/gif.py``: global and local palettes, interlaced rows, frames
  placed inside or past the screen, transparency, grey palettes, more
  frames after the first, PIL's own GIFs, and a file cut short;
- ``pdfio/tiff.py``: PIL's TIFFs of modes 1, L, LA, RGB, RGBA, CMYK, P,
  I;16 and I;16B under no compression, PackBits, LZW and Deflate, with
  and without predictor 2 and several strips; CCITT G3 (1-D and 2-D) and
  G4 under both photometrics; the eight orientations;
- ``pdfio/pil_modes.py``: arrays of every type ``Image.fromarray`` takes
  and image objects of the modes PIL hands out, with the TypeError of
  the types it refuses.

Each is held byte-equal to the pixels the JAX package's ``images_to_pdf``
embeds (``torch_image_files.jax_pixels``: ``Image.open``, then
``convert("RGB")`` unless the mode is RGB or L); where PIL raises, the
port raises too. Then the committed page of each format
(``assets/image_files_*``) and two arrays made from it: the rasters and
PDFs equal to the JAX package's, and ``RapidDoc(device="cpu")`` in fp32
(OCR with the fallback layout) over all eight in one ``parse_batch``
giving the JAX package's Markdown and content list
(``assets/image_files_golden.json``).

``python tests/test_torch_image_files.py`` rebuilds the assets and the
golden with the JAX package (needs PIL; under a minute).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

from torch_image_files import (  # noqa: E402
    bmp_bytes,
    bomb_bytes,
    gif_bytes,
    jax_pixels,
    pil_save,
    png_bytes,
)

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
GOLDEN_JSON = ASSETS / "image_files_golden.json"
FILES = {  # case: asset file name
    "bmp": "image_files_page.bmp",
    "gif": "image_files_page.gif",
    "tiff_lzw": "image_files_page_lzw.tif",
    "tiff_g4": "image_files_page_g4.tif",
    "png16": "image_files_page16.png",
    "png_adam7": "image_files_page_adam7.png",
}
DPI = 200  # get_pdf_render_dpi()
OCR_ONLY = {"RAPIDDOC_DISABLE_LAYOUT": "1", "RAPIDDOC_DISABLE_FORMULA": "1",
            "RAPIDDOC_DISABLE_TABLE": "1"}


def _outcome(fn, data):
    try:
        return fn(data)
    except Exception as exc:  # PIL's OSError and the port's ValueError alike
        return exc


def assert_same_pixels(data: bytes, decode) -> None:
    want, got = _outcome(jax_pixels, data), _outcome(decode, data)
    if isinstance(want, Exception) or isinstance(got, Exception):
        assert isinstance(want, Exception) and isinstance(got, Exception), (want, got)
        assert not isinstance(got, NotImplementedError), got
        return
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.array_equal(got, want)


# ------------------------------------------------------------------ PNG

PNG_FORMS = [(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2), (1, 3), (2, 3),
             (4, 3), (8, 3), (8, 4), (16, 4), (8, 6), (16, 6)]
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("depth,ctype", PNG_FORMS)
def test_png_forms_equal_pil(depth, ctype, interlace):
    from rapiddoc_tpu_torch.pdfio.png import decode_png

    seed = depth * 16 + ctype + 100 * interlace
    rng = np.random.default_rng(seed)
    for h, w in ((1, 1), (5, 3), (13, 11), (17, 29)):
        shape = (h, w, PNG_CHANNELS[ctype])
        palette = None
        top = 1 << depth
        if ctype == 3:
            palette = rng.integers(0, 256, (int(rng.integers(1, top + 1)), 3), dtype=np.uint8)
        values = rng.integers(0, top, shape)
        data = png_bytes(values, depth, ctype, interlace=interlace, palette=palette, seed=seed)
        assert_same_pixels(data, decode_png)


# ------------------------------------------------------------------ BMP

GREY = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
BW = np.array([[0, 0, 0], [255, 255, 255]], np.uint8)
MASKS_32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
            (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
            (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
            (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0), (0xFF, 0xFF00, 0xFF0000, 0)]


def _bmp_cases():
    cases = []
    for bits in (1, 4, 8, 16, 24, 32):
        for hs in (12, 40, 56, 124):
            for top_down in (False, True):
                if hs == 12 and top_down:
                    continue
                cases.append(dict(width=13, height=7, bits=bits, header_size=hs,
                                  top_down=top_down))
    cases += [dict(width=17, height=9, bits=8, compression=1),
              dict(width=17, height=9, bits=4, compression=2),
              dict(width=16, height=9, bits=4, compression=2),
              dict(width=9, height=4, bits=8, compression=1, palette=GREY)]
    for m in ((0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F), (0x1F, 0x7E0, 0xF800)):
        for hs in (40, 56):
            cases.append(dict(width=11, height=5, bits=16, compression=3, masks=m, header_size=hs))
    for m in MASKS_32:
        cases.append(dict(width=11, height=5, bits=32, compression=3, masks=m, header_size=56))
    cases += [dict(width=11, height=5, bits=32, compression=3, masks=MASKS_32[0][:3]),
              dict(width=11, height=5, bits=24, compression=3, masks=(0xFF0000, 0xFF00, 0xFF)),
              dict(width=9, height=4, bits=8, palette=GREY),
              dict(width=9, height=4, bits=1, palette=BW),
              dict(width=9, height=4, bits=1, palette=BW[::-1]),
              dict(width=9, height=4, bits=4, palette=GREY[:16]),
              dict(width=9, height=4, bits=8, palette=GREY[:100], colors=100),
              dict(width=9, height=4, bits=8, colors=20)]
    return cases


@pytest.mark.parametrize("case", _bmp_cases(), ids=lambda c: "-".join(
    f"{k}{'' if isinstance(v, (int, bool)) else len(v)}" if not isinstance(v, (int, bool))
    else f"{k}{v}" for k, v in c.items()))
def test_bmp_forms_equal_pil(case):
    from rapiddoc_tpu_torch.pdfio.bmp import decode_bmp

    data = bmp_bytes(seed=sum(map(ord, repr(case))) % 1000, **case)
    assert_same_pixels(data, decode_bmp)


@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pil_written_bmp_equal_pil(mode):
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.bmp import decode_bmp

    rng = np.random.default_rng(len(mode))
    img = Image.fromarray(rng.integers(0, 256, (10, 13, 3), dtype=np.uint8)).convert(mode)
    assert_same_pixels(pil_save(img, "BMP"), decode_bmp)
    # truncated pixel data: both raise
    assert_same_pixels(pil_save(img, "BMP")[:-7], decode_bmp)


# ------------------------------------------------------------------ GIF

GIF_CASES = [
    dict(width=13, height=9), dict(width=13, height=9, interlace=True),
    dict(width=20, height=17, interlace=True, local_colors=4),
    dict(width=20, height=17, global_colors=None, local_colors=8),
    dict(width=20, height=17, global_colors=None),
    dict(width=20, height=17, transparency=3),
    dict(width=20, height=17, frame=(3, 2, 10, 9), transparency=5),
    dict(width=20, height=17, frame=(3, 2, 10, 9)),
    dict(width=10, height=10, frame=(5, 6, 10, 9)),
    dict(width=20, height=17, grey_palette=True),
    dict(width=20, height=17, grey_palette=True, local_colors=16),
    dict(width=20, height=17, global_colors=4, local_colors=256),
    dict(width=20, height=17, frames=3),
    dict(width=20, height=17, global_colors=2),
    dict(width=31, height=33, global_colors=256, interlace=True),
]


@pytest.mark.parametrize("case", GIF_CASES, ids=lambda c: "-".join(f"{k}{v}" for k, v in c.items()))
def test_gif_forms_equal_pil(case):
    from rapiddoc_tpu_torch.pdfio.gif import decode_gif

    data = gif_bytes(seed=GIF_CASES.index(case), **case)
    assert_same_pixels(data, decode_gif)
    # a file cut inside the frame's data: both raise
    assert_same_pixels(data[: len(data) - 3], decode_gif)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
def test_pil_written_gif_equal_pil(mode, interlace):
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.gif import decode_gif

    rng = np.random.default_rng(3)
    base = (rng.random((40, 60, 3)) * 60).astype(np.uint8) + (
        np.arange(60, dtype=np.uint8)[None, :, None] * 3)
    img = Image.fromarray(base).convert(mode)
    assert_same_pixels(pil_save(img, "GIF", interlace=interlace), decode_gif)


def test_large_gif_lzw_equal_pil():
    """A palette image wide enough for 12-bit codes and full tables."""
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.gif import decode_gif

    rng = np.random.default_rng(9)
    img = Image.fromarray(rng.integers(0, 256, (300, 400), dtype=np.uint8)).convert("P")
    assert_same_pixels(pil_save(img, "GIF"), decode_gif)


# ------------------------------------------------------------------ TIFF

TIFF_MODES = ("1", "L", "LA", "RGB", "RGBA", "CMYK", "P", "I;16", "I;16B")
TIFF_COMPRESSIONS = ("raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate")


def tiff_image(mode: str, seed: int = 7):
    from PIL import Image

    rng = np.random.default_rng(seed)
    shape = (23, 37)
    if mode == "1":
        return Image.fromarray(rng.random(shape) > 0.5)
    if mode in ("I;16", "I;16B"):
        return Image.fromarray(rng.integers(0, 600, shape).astype("<u2" if mode == "I;16" else ">u2"))
    if mode == "P":
        rgb = Image.fromarray(rng.integers(0, 256, shape + (3,), dtype=np.uint8))
        return rgb.convert("P", palette=Image.ADAPTIVE, colors=200)
    channels = {"L": (), "LA": (2,), "RGB": (3,), "RGBA": (4,), "CMYK": (4,)}[mode]
    img = Image.fromarray(rng.integers(0, 256, shape + channels, dtype=np.uint8))
    return img.convert("CMYK") if mode == "CMYK" else img


@pytest.mark.parametrize("compression", TIFF_COMPRESSIONS)
@pytest.mark.parametrize("mode", TIFF_MODES)
def test_tiff_forms_equal_pil(mode, compression):
    from rapiddoc_tpu_torch.pdfio.tiff import decode_tiff

    img = tiff_image(mode)
    # libtiff cannot difference 1-bit samples (PIL's writer crashes on it)
    predictors = (None,) if mode == "1" else (None, 2)
    for predictor in predictors:
        for rows_per_strip in (None, 5):
            info = {}
            if predictor:
                info[317] = predictor
            if rows_per_strip:
                info[278] = rows_per_strip
            data = pil_save(img, "TIFF", compression=compression, tiffinfo=info)
            assert_same_pixels(data, decode_tiff)


@pytest.mark.parametrize("compression", ["group3", "group4"])
@pytest.mark.parametrize("info", [{}, {262: 0}, {292: 1}, {278: 7}, {266: 2}],
                         ids=["plain", "white_is_zero", "t4_2d", "strips", "fill_order_2"])
def test_ccitt_tiff_equal_pil(compression, info):
    from rapiddoc_tpu_torch.pdfio.tiff import decode_tiff

    data = pil_save(tiff_image("1", seed=11), "TIFF", compression=compression, tiffinfo=info)
    assert_same_pixels(data, decode_tiff)


@pytest.mark.parametrize("orientation", range(1, 9))
def test_tiff_orientation_equal_pil(orientation):
    from rapiddoc_tpu_torch.pdfio.tiff import decode_tiff

    data = pil_save(tiff_image("RGB"), "TIFF", compression="tiff_lzw",
                    tiffinfo={274: orientation})
    assert_same_pixels(data, decode_tiff)


def test_tiff_forms_not_ported_raise():
    from rapiddoc_tpu_torch.pdfio.tiff import decode_tiff

    data = pil_save(tiff_image("RGB"), "TIFF", compression="jpeg")
    with pytest.raises(NotImplementedError, match="TIFF compression 7.*item 12: 12f"):
        decode_tiff(data)
    with pytest.raises(NotImplementedError, match="BigTIFF.*item 12: 12f"):
        decode_tiff(b"II+\x00" + bytes(12))


# --------------------------------------------------- decompression bombs

BOMBS = ("png", "bmp", "bmp_os2", "gif_screen", "gif_frame", "tiff_grey", "tiff_g4", "jpeg")


@pytest.mark.parametrize("kind", BOMBS)
def test_decompression_bomb_raises_as_pil(kind):
    """A header that declares 65535 x 65535 pixels: PIL's ``Image.open``
    raises its DecompressionBombError; the port raises ValueError with
    PIL's message before it allocates the image (well under 16 MiB)."""
    import tracemalloc

    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.png import decode_image

    data = bomb_bytes(kind)
    with pytest.raises(Image.DecompressionBombError) as want:
        jax_pixels(data)
    tracemalloc.start()
    try:
        with pytest.raises(ValueError) as got:
            decode_image(data)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert str(got.value) == str(want.value)
    assert peak < 16 << 20, peak


@pytest.mark.parametrize("size", [(1, 1), (0, 5), (2 * 89478485, 1), (2 * 89478485 + 1, 1),
                                  (13377, 13378), (65535, 65535)])
def test_check_size_is_pils_bomb_check(size):
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.pil_modes import MAX_IMAGE_PIXELS, check_size

    assert MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    want, got = _outcome(Image._decompression_bomb_check, size), _outcome(
        lambda s: check_size(*s), size)
    assert (want is None) == (got is None) and str(want) == str(got), (want, got)


def test_ccitt_strip_past_the_bomb_limit_raises():
    """A /CCITTFaxDecode image the JAX package opens as a TIFF through PIL
    (which refuses it as a bomb) raises before its bits are allocated."""
    from rapiddoc_tpu_torch.pdfio.ccitt import decode_ccitt

    with pytest.raises(ValueError, match="decompression bomb"):
        decode_ccitt(b"\x00\x01", 65535, 65535, {"K": -1})


# ------------------------------------------------------- arrays, objects

ARRAY_CASES = {
    "bool": lambda r: r.random((5, 7)) > 0.5,
    "uint8": lambda r: r.integers(0, 256, (5, 7), dtype=np.uint8),
    "uint8_la": lambda r: r.integers(0, 256, (5, 7, 2), dtype=np.uint8),
    "uint8_rgb": lambda r: r.integers(0, 256, (5, 7, 3), dtype=np.uint8),
    "uint8_rgba": lambda r: r.integers(0, 256, (5, 7, 4), dtype=np.uint8),
    "int8": lambda r: r.integers(-128, 128, (5, 7)).astype(np.int8),
    "uint16": lambda r: r.integers(0, 65536, (5, 7)).astype(np.uint16),
    "uint16_be": lambda r: r.integers(0, 65536, (5, 7)).astype(">u2"),
    "int16": lambda r: r.integers(-32768, 32768, (5, 7)).astype(np.int16),
    "int32": lambda r: r.integers(-40000, 40000, (5, 7)).astype(np.int32),
    "uint32": lambda r: r.integers(0, 2 ** 32, (5, 7)).astype(np.uint32),
    "float32": lambda r: (r.random((5, 7)) * 400 - 50).astype(np.float32),
    "float64": lambda r: r.random((5, 7)) * 300 - 20,
    "float32_edges": lambda r: np.array([[np.nan, np.inf, -np.inf, 254.9999, 255.0, 0.0, -0.0,
                                          0.99999, 255.00001]], np.float32),
}


def _jax_array_pixels(arr: np.ndarray) -> np.ndarray:
    """The JAX package's array path: ``Image.fromarray``, then
    ``convert("RGB")`` unless RGB or L (``rapiddoc_tpu/api.py:710-720``)."""
    from PIL import Image

    img = Image.fromarray(arr)
    return np.asarray(img if img.mode in ("RGB", "L") else img.convert("RGB"))


@pytest.mark.parametrize("name", list(ARRAY_CASES))
def test_array_types_equal_pil(name):
    from rapiddoc_tpu_torch.pdfio.pil_modes import array_pixels

    arr = ARRAY_CASES[name](np.random.default_rng(len(name)))
    want, got = _jax_array_pixels(arr), array_pixels(arr)
    assert got.dtype == np.uint8 and got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("arr", [np.zeros((2, 2), np.int64), np.zeros((2, 2, 1), np.uint8),
                                 np.zeros((2, 2), np.float16), np.zeros((2, 2, 3), np.uint16)],
                         ids=["int64", "uint8_1ch", "float16", "uint16_rgb"])
def test_array_types_pil_refuses_raise_alike(arr):
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.pil_modes import array_pixels

    with pytest.raises(TypeError) as want:
        Image.fromarray(arr)
    with pytest.raises(TypeError) as got:
        array_pixels(arr)
    assert str(got.value) == str(want.value)


OBJECT_MODES = ("1", "L", "P", "PA", "RGB", "RGBA", "RGBX", "LA", "CMYK", "I", "I;16",
                "I;16B", "F")


@pytest.mark.parametrize("mode", OBJECT_MODES)
def test_image_objects_equal_pil(mode):
    """A PIL image handed to the port directly, read through numpy and
    ``getpalette()``."""
    from PIL import Image

    from rapiddoc_tpu_torch.pdfio.pil_modes import is_image_object, object_pixels

    rng = np.random.default_rng(OBJECT_MODES.index(mode))
    raw = rng.integers(0, 256, len(Image.new(mode, (9, 6)).tobytes()), dtype=np.uint8).tobytes()
    img = Image.frombytes(mode, (9, 6), raw)
    if mode in ("P", "PA"):
        img.putpalette(rng.integers(0, 256, 3 * 40, dtype=np.uint8).tolist())
    assert is_image_object(img) and not is_image_object(np.zeros((2, 2), np.uint8))
    want = np.asarray(img if img.mode in ("RGB", "L") else img.convert("RGB"))
    assert np.array_equal(object_pixels(img), want)


@pytest.mark.parametrize("mode", ["1", "P", "RGBA", "CMYK", "I;16", "F", "array_float32"])
def test_facade_takes_image_objects_as_jax(mode):
    """``RapidDoc()`` on a PIL image or an array: the one-page PDF the
    facade builds equals the JAX package's (its PNG round trip)."""
    from PIL import Image

    from rapiddoc_tpu import RapidDoc as JaxRapidDoc
    from rapiddoc_tpu_torch import RapidDoc

    rng = np.random.default_rng(5)
    if mode == "array_float32":
        item = (rng.random((30, 40)) * 300 - 20).astype(np.float32)
    else:
        raw = rng.integers(0, 256, len(Image.new(mode, (40, 30)).tobytes()), dtype=np.uint8)
        item = Image.frombytes(mode, (40, 30), raw.tobytes())
        if mode == "P":
            item.putpalette(rng.integers(0, 256, 3 * 64, dtype=np.uint8).tolist())
    want = JaxRapidDoc()._normalize_input(item)
    got = RapidDoc(device="cpu")._normalize_input(item)
    assert got == want


# ------------------------------------------------- committed pages, parses


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def page_arrays(grey: np.ndarray) -> dict[str, np.ndarray]:
    """The two array inputs, from the grey of the committed PNG page: a
    float32 page with values past both ends, a uint16 one past 255."""
    g = grey.astype(np.float32)
    return {"float32": g * 1.25 - 20.0,
            "uint16": (grey.astype(np.uint16) * 3).astype(np.uint16)}


def load_inputs() -> dict:
    """{case: file bytes or array} of the eight committed inputs."""
    from rapiddoc_tpu_torch.pdfio.png import decode_png

    out = {k: (ASSETS / name).read_bytes() for k, name in FILES.items()}
    rgb = decode_png(out["png_adam7"])
    grey = (rgb.astype(np.int32) @ np.array([299, 587, 114]) // 1000).astype(np.uint8)
    out.update(page_arrays(grey))
    return out


def make_page(size: int = 480, height: int = 360) -> np.ndarray:
    import random

    from rapiddoc_tpu.train.synth_layout import render_layout_page

    page, _ = render_layout_page(random.Random(16), size=size, height=height,
                                 mix=(0.7, 1.0, 1.0, 1.0))
    return page


def page_files(page: np.ndarray) -> dict:
    """{case: file bytes} of an RGB page in each committed form."""
    from PIL import Image

    img = Image.fromarray(page)
    return {
        "bmp": pil_save(img.convert("P", palette=Image.ADAPTIVE, colors=64), "BMP"),
        "gif": pil_save(img.convert("P", palette=Image.ADAPTIVE, colors=32), "GIF",
                        interlace=True),
        "tiff_lzw": pil_save(img, "TIFF", compression="tiff_lzw", tiffinfo={317: 2, 278: 64}),
        "tiff_g4": pil_save(img.convert("L").point(lambda v: 255 if v > 160 else 0).convert("1"),
                            "TIFF", compression="group4"),
        "png16": png_bytes(page.astype(np.uint16) * 257, 16, 2, seed=1),
        "png_adam7": png_bytes(page, 8, 2, interlace=True, seed=2),
    }


def make_assets() -> None:
    for k, data in page_files(make_page()).items():
        (ASSETS / FILES[k]).write_bytes(data)


def jax_golden() -> dict:
    from test_torch_image_inputs import clean_env

    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack
    from rapiddoc_tpu.pdfio.writer import images_to_pdf

    inputs = load_inputs()
    golden = {"dpi": DPI, "config": OCR_ONLY, "raster_sha256": {}, "pdf_sha256": {},
              "parse": {}}
    with clean_env(RAPIDDOC_FP32_PARAMS="1", **OCR_ONLY):
        ModelStack._instances.clear()
        rapid = RapidDoc(parse_method="ocr")
        for k, item in inputs.items():
            if isinstance(item, np.ndarray):
                pixels = _jax_array_pixels(item)
                pdf = rapid._normalize_input(item)[0]
            else:
                pixels = jax_pixels(item)
                pdf = images_to_pdf([item], dpi=DPI)
            golden["raster_sha256"][k] = sha256(pixels)
            golden["pdf_sha256"][k] = sha256(pdf)
            out = rapid(item)
            golden["parse"][k] = {"markdown": out.markdown,
                                  "content_list": out.content_list_json}
        ModelStack._instances.clear()
    return golden


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


def test_committed_pages_equal_golden(golden):
    """Each committed page's raster and PDF: the JAX package's."""
    from rapiddoc_tpu_torch.pdfio.writer import _pixels, images_to_pdf

    for k, item in load_inputs().items():
        assert sha256(_pixels(item)) == golden["raster_sha256"][k], k
        assert sha256(images_to_pdf([item], dpi=DPI)) == golden["pdf_sha256"][k], k
        if not isinstance(item, np.ndarray):
            assert_same_pixels(item, lambda d: _pixels(d))


def test_parse_batch_of_every_format_equals_golden(golden, few_threads):
    """RapidDoc(device="cpu") in fp32, OCR with the fallback layout: one
    parse_batch of the eight inputs gives the JAX package's Markdown and
    content list, and a single parse the same."""
    import torch
    from test_torch_image_inputs import clean_env

    from rapiddoc_tpu_torch import RapidDoc

    inputs = load_inputs()
    with clean_env(**OCR_ONLY):
        rapid = RapidDoc(device="cpu", dtype=torch.float32, parse_method="ocr")
        outs = rapid(list(inputs.values()))
        single = rapid(inputs["gif"])
    for (k, _), out in zip(inputs.items(), outs):
        want = golden["parse"][k]
        assert out.markdown == want["markdown"], k
        assert json.loads(json.dumps(out.content_list_json)) == want["content_list"], k
        assert out.markdown.strip(), k
    assert single.markdown == golden["parse"]["gif"]["markdown"]


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    make_assets()
    GOLDEN_JSON.write_text(json.dumps(jax_golden(), indent=1, sort_keys=True) + "\n")
    print({k: (ASSETS / v).stat().st_size for k, v in FILES.items()})
