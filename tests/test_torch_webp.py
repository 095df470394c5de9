"""WEBP files: the port's decoders (``pdfio/webp.py``, ``vp8.py``,
``vp8l.py`` and ``csrc/webp.cu``) against PIL and the JAX package on the
CPU.

Every form PIL writes (``tests/torch_webp_jpx.py``: lossy at several
qualities, methods and sizes down to 1 x 1, with alpha (filtered,
quantised, raw), lossless with each transform and palette size, still
VP8X files with ICC, EXIF and XMP chunks, animated, and a first frame
smaller than its canvas, made by hand) decodes to PIL's
mode and pixels byte for byte, with the plain Python loops and with the
compiled ones (``csrc/webp.cu`` built with g++); ``images_to_pdf`` gives
the JAX package's bytes; cut and corrupt files PIL refuses raise
ValueError. The committed page (``webp_jpx_page.webp``) decodes to PIL's
pixels, the plain loops equal the compiled ones on a band of macroblock
rows, and one fp32 ``RapidDoc(device="cpu")`` parse of its path and of
its bytes with no suffix gives the JAX package's Markdown and content
list (``webp_jpx_golden.json``).

``python tests/test_torch_webp.py --golden`` rebuilds the slice's
fixtures and golden (``torch_webp_jpx.write_all``: a few minutes, the JAX
package's parses included).
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))
sys.path.insert(1, str(REPO))

import torch_host_builds as hb  # noqa: E402
import torch_webp_jpx as fx  # noqa: E402

WEBP = fx.webp_cases()
CORRUPT = fx.webp_corrupt_cases()
BAND_MB_ROWS = 3


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(fx.GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.mark.parametrize("name", list(WEBP))
def test_webp_equals_pil(name):
    """PIL's mode and pixels, plain and compiled."""
    from rapiddoc_tpu_torch.pdfio.webp import webp_mode

    mode, want = fx.pil_pixels(WEBP[name])
    got_mode, got = webp_mode(WEBP[name], compiled=False)
    assert got_mode == mode and got.shape == want.shape and np.array_equal(got, want)
    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/webp.cu on the CPU")
    with hb.compiled_host():
        got_mode, got = webp_mode(WEBP[name], compiled=True)
    assert got_mode == mode and np.array_equal(got, want)


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_webp_raises(name):
    """Files PIL refuses (so the JAX package's images_to_pdf raises) raise
    ValueError in the port."""
    from rapiddoc_tpu.pdfio.writer import images_to_pdf as jax_images_to_pdf

    from rapiddoc_tpu_torch.pdfio.png import decode_image
    from rapiddoc_tpu_torch.pdfio.webp import webp_mode

    with pytest.raises(Exception):
        fx.pil_pixels(CORRUPT[name])
    with pytest.raises(Exception):
        jax_images_to_pdf([CORRUPT[name]])
    with pytest.raises(ValueError):
        webp_mode(CORRUPT[name], compiled=False)
    with pytest.raises(ValueError):
        decode_image(CORRUPT[name])


@pytest.mark.parametrize("name", ["lossy_q75", "lossy_alpha", "lossless_rgba",
                                  "animated_small_first_frame_alpha", "lossy_1x17"])
def test_images_to_pdf_equals_jax(name):
    from rapiddoc_tpu.pdfio.writer import images_to_pdf as jax_images_to_pdf

    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    assert images_to_pdf([WEBP[name]], dpi=144) == jax_images_to_pdf([WEBP[name]], dpi=144)


def test_matrix_rebuilds_from_seeds_and_decodes_as_pil():
    """The smoke's small files are what the case builders write, with
    PIL's modes and pixel digests; the port gives those digests."""
    from rapiddoc_tpu_torch.pdfio.jpx import jpx_mode
    from rapiddoc_tpu_torch.pdfio.webp import webp_mode

    want = fx.make_matrix(WEBP, fx.jpx_cases())
    with np.load(fx.MATRIX_NPZ) as z:
        got = {k: z[k] for k in z.files}
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    decoders = {"webp": webp_mode, "jpx": jpx_mode}
    for key in (k for k in got if k.split("/")[0] in decoders):
        mode, px = decoders[key.split("/")[0]](got[key].tobytes(), compiled=False)
        assert (mode, fx.sha256(px)) == (str(got[f"mode/{key}"]), str(got[f"sha256/{key}"]))


def test_committed_page_equals_pil_and_golden(golden):
    """The page decodes (compiled) to PIL's pixels recorded in the golden,
    its PDF is the JAX package's, and the plain loops equal the compiled
    ones on the first BAND_MB_ROWS macroblock rows."""
    from rapiddoc_tpu_torch.pdfio import vp8
    from rapiddoc_tpu_torch.pdfio.webp import compiled_planes, webp_mode
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/webp.cu on the CPU")
    data = fx.PAGE_WEBP.read_bytes()
    payload = data[20:20 + int.from_bytes(data[16:20], "little")]
    assert data[12:16] == b"VP8 "
    with hb.compiled_host():
        mode, px = webp_mode(data)
        pdf = images_to_pdf([data], dpi=golden["dpi"])
        _, _, ys, us, vs = compiled_planes(payload, BAND_MB_ROWS)
    assert mode == golden["page_mode"] and fx.sha256(px) == golden["page_sha256"]
    assert fx.sha256(pdf) == golden["page_pdf_sha256"]
    _, py, pu, pv = vp8.decode_planes(payload, BAND_MB_ROWS)
    assert np.array_equal(py, ys) and np.array_equal(pu, us) and np.array_equal(pv, vs)


def test_fp32_parses_equal_golden(golden, few_threads):
    """RapidDoc(device="cpu") in fp32, demo layout and formula stage: the
    page's path and its bytes with no suffix (Magika's sniff) parse as the
    JAX package parses them."""
    import torch
    import test_torch_image_inputs as ii

    from rapiddoc_tpu_torch import RapidDoc

    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/webp.cu on the CPU")
    with hb.compiled_host(), ii.clean_env(**golden["config"]):
        rapid = RapidDoc(device="cpu", dtype=torch.float32)
        got = {"webp_path": fx.summary(rapid(fx.PAGE_WEBP, parse_method="ocr")),
               "webp_bytes": fx.summary(rapid(fx.PAGE_WEBP.read_bytes(), parse_method="ocr"))}
    for key, part in got.items():
        ii.assert_same_parse(part, golden["fp32"][key])
    assert golden["fp32"]["webp_path"]["latex"] != [[]]  # the formula stage ran


if __name__ == "__main__":
    if "--golden" in sys.argv:
        fx.write_all()
    else:
        print(__doc__)
