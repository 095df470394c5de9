"""JPEG 2000: the port's decoder (``pdfio/jpx.py``, ``jpx_t1.py`` and
``csrc/jpx.cu``) against PIL's OpenJPEG and the JAX package on the CPU.

Every form Pillow's JPEG 2000 writer produces (``tests/torch_webp_jpx.py``:
reversible and irreversible, with and without MCT, 1-4 components, 8 and
16 bits, signed samples, tiles and odd image and tile origins, 1-6
resolutions, code-block and precinct sizes, quality layers, the five
progression orders, raw codestreams, PLT and COM markers) and the JP2
colour spaces edited into PIL's files (sYCC, ICC, grey over RGBA, an
unknown one) decode to PIL's mode and pixels byte for byte, with the plain
Python tier 1 and the compiled one (``csrc/jpx.cu`` built with g++); the
9/7 path needs no tolerance. Cut and corrupt files PIL refuses raise
ValueError, also as image XObjects, where the JAX package's renderer
draws nothing. Pages with JPX images of each mode render as the JAX
package renders them; the committed 300 dpi scan (``webp_jpx_scan.pdf``)
renders and parses (fp32, demo layout and formula stage) to the JAX
package's golden (``webp_jpx_golden.json``, rebuilt by ``python
tests/test_torch_webp.py --golden``).
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

JPX = fx.jpx_cases()
CORRUPT = fx.jpx_corrupt_cases(JPX)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(fx.GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.mark.parametrize("name", list(JPX))
def test_jpx_equals_pil(name):
    """PIL's mode and pixels, plain and compiled tier 1."""
    from rapiddoc_tpu_torch.pdfio.jpx import jpx_mode

    mode, want = fx.pil_pixels(JPX[name])
    got_mode, got = jpx_mode(JPX[name], compiled=False)
    assert got_mode == mode and got.shape == want.shape and np.array_equal(got, want)
    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/jpx.cu on the CPU")
    with hb.compiled_host():
        got_mode, got = jpx_mode(JPX[name], compiled=True)
    assert got_mode == mode and np.array_equal(got, want)


def _xobject(data: bytes, width: int, height: int, **extra) -> tuple[dict, bytes]:
    d = {"Type": "XObject", "Subtype": "Image", "Width": width, "Height": height,
         "ColorSpace": "DeviceRGB", "BitsPerComponent": 8, "Filter": "JPXDecode", **extra}
    return d, data


@pytest.mark.parametrize("name", list(CORRUPT))
def test_corrupt_jpx_raises(name):
    """PIL refuses each file, so the JAX package's ``xobject_to_pil``
    returns None (its renderer draws nothing); the port raises
    ValueError, here and as an image XObject."""
    from test_torch_codecs import jax_xobject

    from rapiddoc_tpu_torch.pdfio.cos import Stream
    from rapiddoc_tpu_torch.pdfio.images import xobject_to_array
    from rapiddoc_tpu_torch.pdfio.jpx import jpx_mode
    from test_torch_codecs import _Doc

    with pytest.raises(Exception):
        fx.pil_pixels(CORRUPT[name])
    d, data = _xobject(CORRUPT[name], 16, 16)
    assert jax_xobject(d, data) is None
    with pytest.raises(ValueError):
        jpx_mode(CORRUPT[name], compiled=False)
    with pytest.raises(ValueError):
        xobject_to_array(_Doc(), Stream(d, data))


@pytest.mark.parametrize("name", ["l_irreversible", "la", "rgb", "rgba", "i16", "sycc",
                                  "codestream"])
def test_xobject_equals_jax(name):
    """``xobject_to_array`` gives the JAX package's PIL image as an array
    (its own mode: ``/ColorSpace`` and ``/Decode`` ignored), with and
    without a soft mask."""
    from test_torch_codecs import jax_xobject, port_xobject

    mode, px = fx.pil_pixels(JPX[name])
    h, w = px.shape[:2]
    extra = {"Decode": [1, 0, 1, 0, 1, 0], "SMaskInData": 1}
    d, data = _xobject(JPX[name], w, h, **extra)
    want = jax_xobject(d, data)
    got = port_xobject(d, data)
    assert want is not None and got is not None and np.array_equal(got, want)
    smask = np.random.default_rng(w).integers(0, 256, (h // 2 + 1, w // 2 + 1), dtype=np.uint8)
    sm = ({"Type": "XObject", "Subtype": "Image", "Width": smask.shape[1],
           "Height": smask.shape[0], "ColorSpace": "DeviceGray", "BitsPerComponent": 8},
          smask.tobytes())
    d, data = _xobject(JPX[name], w, h, SMask=sm)
    want = jax_xobject(d, data)
    got = port_xobject(d, data)
    assert want is not None and got is not None and np.array_equal(got, want)


def _page(name: str, size: tuple[int, int]) -> bytes:
    """A one-page PDF drawing case ``name`` in a box of ``size`` points."""
    from rapiddoc_tpu.pdfio.cos import Name, Stream
    from rapiddoc_tpu.pdfio.writer import PdfWriter

    _, px = fx.pil_pixels(JPX[name])
    writer = PdfWriter()
    pages_ref = writer.reserve()
    img = writer.add(Stream({Name("Type"): Name("XObject"), Name("Subtype"): Name("Image"),
                             Name("Width"): px.shape[1], Name("Height"): px.shape[0],
                             Name("ColorSpace"): Name("DeviceRGB"),
                             Name("BitsPerComponent"): 8, Name("Filter"): Name("JPXDecode")},
                            JPX[name]))
    content = b"0.2 0.4 0.8 rg q %d 0 0 %d 30 40 cm /Im0 Do Q" % size
    page = {Name("Type"): Name("Page"), Name("Parent"): pages_ref,
            Name("MediaBox"): [0, 0, 300, 300],
            Name("Resources"): {Name("XObject"): {Name("Im0"): img}},
            Name("Contents"): writer.add(Stream({}, content))}
    kid = writer.add(page)
    writer.set(pages_ref, {Name("Type"): Name("Pages"), Name("Kids"): [kid], Name("Count"): 1})
    return writer.tobytes(writer.add({Name("Type"): Name("Catalog"), Name("Pages"): pages_ref}))


@pytest.mark.parametrize("name,size,dpi", [
    ("rgb_irreversible", (200, 150), 200), ("rgba", (120, 90), 200), ("la", (140, 100), 72),
    ("l_reversible", (96, 72), 72), ("i16", (70, 50), 72), ("tiles_offsets", (110, 90), 144),
])
def test_render_equals_jax(name, size, dpi):
    """Pages with a JPX image render as the JAX package renders them (LA
    as a stencil of the fill colour; ``I;16`` at its own size)."""
    from rapiddoc_tpu.pdfio import open_pdf as jax_open
    from rapiddoc_tpu.pdfio.render import render_page_full as jax_render

    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    pdf = _page(name, size)
    want = np.asarray(jax_render(jax_open(pdf).get_page(0), dpi=dpi, with_text=False)[0])
    got = render_page_full(open_pdf(pdf).get_page(0), dpi=dpi, with_text=False)[0]
    assert np.array_equal(got, want)


def test_i16_at_another_size_raises():
    """PIL resamples an ``I;16`` image in its 16-bit path, which the port
    has not replayed: drawn at another size it raises, naming item 12f."""
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    with pytest.raises(NotImplementedError, match="16-bit JPX.*item 12: 12f"):
        render_page_full(open_pdf(_page("i16", (140, 100))).get_page(0), dpi=72,
                         with_text=False)


def test_not_written_by_pil_raises_not_ported():
    """Codestream features Pillow's writer never produces raise, naming
    ROADMAP item 12f: a code-block style bit, a POC marker, sub-sampling."""
    from rapiddoc_tpu_torch.pdfio.jpx import jpx_mode

    cs = JPX["codestream"]
    cod = cs.index(b"\xff\x52")
    style = bytearray(cs)
    style[cod + 4 + 5 + 3] = 0x01  # SPcod's code-block style: selective bypass
    poc = cs[:cod] + b"\xff\x5f\x00\x09\x00\x00\x00\x01\x05\x03\x00" + cs[cod:]
    siz = cs.index(b"\xff\x51")
    sub = bytearray(cs)
    sub[siz + 4 + 36 + 3 + 1] = 2  # the second component's XRsiz
    for data in (bytes(style), poc, bytes(sub)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 12: 12f"):
            jpx_mode(data, compiled=False)


def test_scan_renders_and_decodes_as_golden(golden):
    """The 300 dpi scan: its image (compiled tier 1) is PIL's, its page
    renders at 72 dpi as the JAX package renders it (200 dpi in the
    smoke), and the plain tier 1 equals the compiled one on the scan's
    first code-blocks."""
    from rapiddoc_tpu_torch.pdfio import jpx, open_pdf, render_page_full

    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/jpx.cu on the CPU")
    doc = open_pdf(fx.SCAN_PDF.read_bytes())
    stream = doc.resolve(doc.get_page(0).resources["XObject"]["Im0"])
    data = doc.stream_bytes(stream)
    with hb.compiled_host():
        assert fx.sha256(jpx.jpx_mode(data)[1]) == golden["scan_sha256"]
        img = render_page_full(doc.get_page(0), dpi=72, with_text=False)[0]
        assert fx.sha256(img) == golden["scan_render_sha256"]["72"]
        plain, compiled = jpx_band(data, 6)
    assert len(plain) == 6 and all(np.array_equal(a, b) for a, b in zip(plain, compiled))


def jpx_band(data: bytes, blocks: int) -> tuple[list, list]:
    """The first ``blocks`` code-blocks of tile 0 decoded plain and
    compiled."""
    from rapiddoc_tpu_torch.pdfio import jpx

    cs = jpx.Codestream(jpx.jp2_codestream(data)[0])
    _, _, res_by_comp = jpx.tile_blocks(cs, 0)
    plain, compiled = [], []
    for _, _, _, args in jpx.block_jobs(res_by_comp[0]):
        if len(plain) == blocks:
            break
        plain.append(jpx.decode_block(*args, compiled=False))
        compiled.append(jpx.decode_block(*args, compiled=True))
    return plain, compiled


def test_fp32_parse_equals_golden(golden, few_threads):
    """RapidDoc(device="cpu") in fp32, demo layout and formula stage, on
    the scan PDF: the JAX package's Markdown and content list."""
    import torch
    import test_torch_image_inputs as ii

    from rapiddoc_tpu_torch import RapidDoc

    if hb.gxx() is None:
        pytest.skip("no g++ to build csrc/jpx.cu on the CPU")
    with hb.compiled_host(), ii.clean_env(**golden["config"]):
        got = fx.summary(RapidDoc(device="cpu", dtype=torch.float32)(
            fx.SCAN_PDF.read_bytes(), parse_method="ocr"))
    ii.assert_same_parse(got, golden["fp32"]["jpx_pdf"])
