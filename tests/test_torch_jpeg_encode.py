"""The port's JPEG encoder against PIL (over libjpeg-turbo), on the
CPU: the span payload the JAX package writes is
``Image.fromarray(crop).save(buf, "JPEG", quality=90)``, and the port's
``encode_jpeg`` must give the same bytes. Sizes from 1x1 up, odd sizes
and sizes that are not a multiple of 16 (partial blocks, dummy blocks at
the right and bottom of the MCU grid), noise, flat colour and gradients,
and real span crops of the layout fixture (every image, table and
display-formula region of the fp32 golden's model output). The port's
own decoder (``pdfio/jpeg.py``, bit-equal to PIL's) reads every stream
back to PIL's pixels.
"""
import io
import json
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"

Image = pytest.importorskip("PIL.Image")

SIZES = [(1, 1), (1, 2), (2, 1), (8, 8), (9, 17), (15, 15), (16, 16), (17, 9),
         (31, 33), (47, 65), (64, 48), (100, 7), (7, 100), (121, 167)]


def pil_jpeg(rgb: np.ndarray) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgb).convert("RGB").save(buf, "JPEG", quality=90)
    return buf.getvalue()


def _content(kind: str, h: int, w: int, rng) -> np.ndarray:
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    yy, xx = np.mgrid[:h, :w]
    return np.stack([(xx * 7) % 256, (yy * 5) % 256, (xx * 3 + yy * 2) % 256], -1).astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "flat", "gradient"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_equals_pil(size, kind):
    from rapiddoc_tpu_torch.pdfio.jpeg import decode_jpeg
    from rapiddoc_tpu_torch.pdfio.jpeg_encode import encode_jpeg

    rng = np.random.default_rng([size[0], size[1], ["noise", "flat", "gradient"].index(kind)])
    rgb = _content(kind, *size, rng)
    data = encode_jpeg(rgb)
    want = pil_jpeg(rgb)
    assert data == want
    np.testing.assert_array_equal(decode_jpeg(data), np.asarray(Image.open(io.BytesIO(want))))


def test_span_crops_of_the_layout_fixture_equal_pil():
    """Every image, table and display-formula region of the fp32 golden,
    cropped from the rendered fixture page as cut_span_images crops."""
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full
    from rapiddoc_tpu_torch.pdfio.jpeg import decode_jpeg
    from rapiddoc_tpu_torch.types import CategoryId
    from rapiddoc_tpu_torch.utils.images import crop_bbox, encode_image

    golden = json.loads((ASSETS / "layout_smoke_golden.json").read_text())
    doc = open_pdf((ASSETS / "layout_smoke_doc.pdf").read_bytes())
    cats = (CategoryId.ImageBody, CategoryId.TableBody, CategoryId.InterlineEquation_YOLO)
    crops = 0
    for i, info in enumerate(golden["fp32"]["model_info"]):
        page = render_page_full(doc.get_page(i), dpi=200, with_text=False)[0]
        for det in info["layout_dets"]:
            if det["category_id"] not in cats:
                continue
            p = det["poly"]
            crop = np.ascontiguousarray(crop_bbox(page, [p[0], p[1], p[4], p[5]], 1.0))
            data = encode_image(crop)
            assert data == pil_jpeg(crop)
            np.testing.assert_array_equal(decode_jpeg(data),
                                          np.asarray(Image.open(io.BytesIO(data))))
            crops += 1
    assert crops >= 30


def test_encode_image_raises_for_other_formats():
    from rapiddoc_tpu_torch.utils.images import encode_image

    img = np.zeros((4, 4, 3), np.uint8)
    for fmt, quality in (("PNG", 90), ("JPEG", 75)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
            encode_image(img, fmt, quality)
