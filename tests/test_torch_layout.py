"""The port's layout model and its host-side helpers against the JAX
package (and OpenCV, which the JAX package calls), on the CPU.

- ``resize_cubic`` against ``cv2.resize(..., INTER_CUBIC)``: bit-equal
  on sources under 4 pixels (OpenCV's own fixed-point code) for any
  content. From 4 pixels up OpenCV hands the resize to IPP, and there,
  over a matrix of up- and down-scales of rendered page content (1 and
  3 channels, odd sizes, the page case 1056x1389 -> 640x640) and on
  random noise, a pixel may differ only where its exact value lies
  within 1e-4 of a tie at .5, and then by one: IPP's float32 rounding
  order, which is not documented, decides those (see ``resize_cubic``).
  Such near-ties are at most 1e-4 of the pixels on noise and 1e-3 on
  page content (1.9e-4 on the 2.17x up-scale, whose flat runs land on
  simple fractions; none on the page case).
- The contour functions against cv2 on 240 seeded random and structured
  masks: ``findContours(RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``,
  ``contourArea``, ``arcLength``, ``boundingRect`` and ``approxPolyDP``
  equal on every contour and every (contour, epsilon) pair (5796), and
  ``mask_to_polygon`` equal on all 200 masks.
- ``mask_to_polygon``, ``class_nms`` and ``_postprocess`` against the
  JAX package's on the same inputs; ``ms_deform_sample`` against the JAX
  one with locations past every border.
- The demo RT-DETR (fp32) against the JAX package's on a fixture page,
  and the port's ``LayoutDetector`` dets on the four fixture pages equal
  to the golden's (labels and order; boxes within 0.05 px).
- The published shape (B4, 300 queries, 6 decoder layers, masks) from a
  JAX random init carried across by ``load_flax_into``, at 320x320.
"""
import json
import math
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
GOLDEN_JSON = ASSETS / "layout_smoke_golden.json"
DOC_PDF = ASSETS / "layout_smoke_doc.pdf"
BOX_TOL = 0.05  # px, the fp32 dets against the golden
# float32 sums of 16 taps of values up to 255 carry errors of some 1e-5:
# within this of a .5 tie either rounding may come out
TIE_TOL = Fraction(1, 10_000)

cv2 = pytest.importorskip("cv2")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.fixture(scope="module")
def pages() -> list[np.ndarray]:
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    doc = open_pdf(DOC_PDF.read_bytes())
    return [render_page_full(doc.get_page(i), dpi=200, with_text=False)[0]
            for i in range(len(doc))]


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


# ------------------------------------------------------------ resize_cubic

def _cv_cubic(img, w, h):
    return cv2.resize(img, (w, h), interpolation=cv2.INTER_CUBIC).reshape((h, w) + img.shape[2:])


RESIZE_CASES = [
    # (crop h, crop w, out w, out h)
    (1389, 1056, 640, 640),  # the page case
    (1389, 1056, 800, 800),  # the published input
    (301, 217, 640, 640),
    (97, 131, 33, 250),
    (64, 64, 127, 31),
    (640, 640, 1389, 1056),
    (45, 33, 45, 67),
    (17, 9, 5, 3),
]


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("case", RESIZE_CASES, ids=lambda c: "x".join(map(str, c)))
def test_resize_cubic_on_page_content_equal_but_near_ties(pages, case, channels):
    from rapiddoc_tpu_torch.models.ocr.pre_post import to_luma

    h, w, ow, oh = case
    page = pages[RESIZE_CASES.index(case) % len(pages)]
    y0, x0 = (page.shape[0] - h) // 3, (page.shape[1] - w) // 3
    img = np.ascontiguousarray(page[y0:y0 + h, x0:x0 + w])
    if channels == 1:
        img = to_luma(img)[..., 0]
    ties, pixels = _check_cubic(img, ow, oh)
    assert ties <= pixels * 1e-3, (ties, pixels)


def test_resize_cubic_bit_equal_below_four_pixels():
    from rapiddoc_tpu_torch.models.ocr.pre_post import resize_cubic

    rng = np.random.default_rng(3)
    for _ in range(120):
        h, w = int(rng.integers(1, 4)), int(rng.integers(1, 60))
        if rng.random() < 0.5:
            h, w = w, h
        ow, oh = int(rng.integers(1, 60)), int(rng.integers(1, 60))
        shape = (h, w, 3) if rng.random() < 0.5 else (h, w)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(resize_cubic(img, ow, oh), _cv_cubic(img, ow, oh))


def _exact_cubic(img, ow, oh, y, x, c):
    """The exact rational INTER_CUBIC value of output pixel (y, x, c)."""
    h, w = img.shape[:2]
    a = Fraction(-3, 4)

    def taps(src, dst, d):
        pos = Fraction(2 * d + 1, 2) * Fraction(src, dst) - Fraction(1, 2)
        base = pos.numerator // pos.denominator
        t = pos - base
        u, x1 = 1 - t, t + 1
        wts = [((a * x1 - 5 * a) * x1 + 8 * a) * x1 - 4 * a,
               ((a + 2) * t - (a + 3)) * t * t + 1,
               ((a + 2) * u - (a + 3)) * u * u + 1]
        wts.append(1 - sum(wts))
        return [min(max(base + k, 0), src - 1) for k in (-1, 0, 1, 2)], wts

    xi, xw = taps(w, ow, x)
    yi, yw = taps(h, oh, y)
    px = img if img.ndim == 2 else img[..., c]
    return sum(yw[j] * xw[i] * int(px[yi[j], xi[i]]) for j in range(4) for i in range(4))


def _check_cubic(img: np.ndarray, ow: int, oh: int) -> tuple[int, int]:
    """Asserts resize_cubic equals cv2 except by one where the exact value
    lies within TIE_TOL of a .5 tie; returns (ties, pixels)."""
    from rapiddoc_tpu_torch.models.ocr.pre_post import resize_cubic

    got, want = resize_cubic(img, ow, oh), _cv_cubic(img, ow, oh)
    ties = 0
    for idx in np.argwhere(got != want):
        y, x = int(idx[0]), int(idx[1])
        c = int(idx[2]) if img.ndim == 3 else 0
        exact = _exact_cubic(img, ow, oh, y, x, c)
        assert 0 < exact < 255 and abs(exact - math.floor(exact) - Fraction(1, 2)) <= TIE_TOL, (
            idx, float(exact))
        assert abs(int(got[tuple(idx)]) - int(want[tuple(idx)])) == 1
        ties += 1
    return ties, want.size


def test_resize_cubic_on_noise_differs_only_at_near_ties():
    rng = np.random.default_rng(5)
    pixels = ties = 0
    for _ in range(150):
        h, w = int(rng.integers(4, 70)), int(rng.integers(4, 70))
        ow, oh = int(rng.integers(1, 70)), int(rng.integers(1, 70))
        shape = (h, w, 3) if rng.random() < 0.5 else (h, w)
        t, p = _check_cubic(rng.integers(0, 256, shape, dtype=np.uint8), ow, oh)
        ties, pixels = ties + t, pixels + p
    assert ties <= pixels * 1e-4, (ties, pixels)


# ---------------------------------------------------------------- contours

def _masks(n: int = 240) -> list[np.ndarray]:
    """Seeded random noise, opened noise, rectangles with holes and
    notches, ellipses, and nested rings."""
    from scipy import ndimage

    rng = np.random.default_rng(0)
    out = []
    for t in range(n):
        h, w = int(rng.integers(1, 48)), int(rng.integers(1, 48))
        kind = t % 5
        if kind == 0:
            m = rng.random((h, w)) < rng.uniform(0.1, 0.9)
        elif kind == 1:
            m = ndimage.binary_opening(rng.random((h, w)) < 0.6)
        elif kind == 2:
            m = np.zeros((h, w), bool)
            for _ in range(int(rng.integers(1, 5))):
                y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
                m[y0:y0 + int(rng.integers(1, h + 1)), x0:x0 + int(rng.integers(1, w + 1))] = True
                if rng.random() < 0.5:
                    m[y0 + 1:y0 + 3, x0 + 1:x0 + 3] = False
        elif kind == 3:
            yy, xx = np.mgrid[:h, :w]
            m = ((yy - h / 2) ** 2 / max(h, 1) + (xx - w / 3) ** 2 / max(w, 1)) < rng.uniform(1, 10)
        else:
            yy, xx = np.mgrid[:h, :w]
            r = np.hypot(yy - h / 2, xx - w / 2)
            m = (r < max(h, w) / 2) & ((r > max(h, w) / 4) | (r < max(h, w) / 8))
        out.append(m.astype(np.uint8))
    return out


def test_contours_equal_cv2():
    from rapiddoc_tpu_torch.utils import contours as C

    pairs = equal = 0
    for m in _masks():
        want, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        got = C.find_contours_external_simple(m)
        assert len(got) == len(want)
        for g, c in zip(got, want):
            np.testing.assert_array_equal(g, c)
            assert C.contour_area(c) == cv2.contourArea(c)
            assert C.arc_length(c) == pytest.approx(cv2.arcLength(c, True), rel=1e-12)
            assert C.bounding_rect(c) == tuple(cv2.boundingRect(c))
            for eps in (0.01 * cv2.arcLength(c, True), 0.5, 1.0, 2.5):
                pairs += 1
                equal += np.array_equal(C.approx_poly_dp(c, eps), cv2.approxPolyDP(c, eps, True))
    assert pairs > 1000
    assert equal == pairs, (equal, pairs)


def test_mask_to_polygon_matches_jax_package():
    from rapiddoc_tpu.models.layout.engine import mask_to_polygon as jax_m2p

    from rapiddoc_tpu_torch.models.layout.engine import mask_to_polygon

    rng = np.random.default_rng(1)
    checked = equal = 0
    for m in _masks(200):
        w, h = float(rng.uniform(300, 1400)), float(rng.uniform(300, 1400))
        got, want = mask_to_polygon(m.astype(np.float32), w, h), jax_m2p(m.astype(np.float32), w, h)
        checked += 1
        equal += got == want
        assert (got is None) == (want is None)
    assert equal == checked == 200, (equal, checked)


# ------------------------------------------------------ postprocess and NMS

def _fake_dets(rng, n=60):
    boxes = np.stack([rng.uniform(0.05, 0.95, n), rng.uniform(0.05, 0.95, n),
                      rng.uniform(0.01, 0.5, n), rng.uniform(0.01, 0.5, n)], 1).astype(np.float32)
    # near-duplicates so the NMS has work
    boxes[n // 2:] = boxes[: n - n // 2] + rng.normal(0, 0.01, (n - n // 2, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.integers(0, 25, n).astype(np.int64)
    return scores, labels, boxes


@pytest.mark.parametrize("class_thresholds", [None, {"table": 0.8, "text": 0.2}])
def test_postprocess_and_class_nms_match_jax_package(class_thresholds):
    from types import SimpleNamespace

    from rapiddoc_tpu.models.layout import engine as jax_engine

    from rapiddoc_tpu_torch.models.layout import engine

    rng = np.random.default_rng(2)
    for _ in range(20):
        scores, labels, boxes = _fake_dets(rng)
        xyxy = np.concatenate([boxes[:, :2] * 800, boxes[:, :2] * 800 + boxes[:, 2:] * 400], 1)
        assert engine.class_nms(xyxy, scores, labels) == jax_engine.class_nms(xyxy, scores, labels)
        cfg = engine.LayoutConfig(conf_threshold=0.4, class_thresholds=class_thresholds)
        jcfg = jax_engine.LayoutConfig(conf_threshold=0.4, class_thresholds=class_thresholds)
        got = engine.LayoutDetector._postprocess(
            SimpleNamespace(config=cfg, labels=engine.DOCLAYOUT_V2_LABELS),
            scores, labels, boxes, 1056, 1389)
        want = jax_engine.LayoutDetector._postprocess(
            SimpleNamespace(config=jcfg, labels=jax_engine.DOCLAYOUT_V2_LABELS),
            scores, labels, boxes, 1056, 1389)
        assert got == want


# ------------------------------------------------------- ms_deform_sample

def test_ms_deform_sample_matches_jax_at_the_borders():
    import jax.numpy as jnp

    from rapiddoc_tpu.models.layout.rtdetr import ms_deform_sample as jax_sample

    from rapiddoc_tpu_torch.models.layout.rtdetr import ms_deform_sample

    rng = np.random.default_rng(4)
    B, Nq, H, L, P, D = 2, 37, 4, 3, 4, 8
    shapes = [(20, 16), (10, 8), (5, 4)]
    values = [rng.standard_normal((B, h, w, H, D)).astype(np.float32) for h, w in shapes]
    # every corner case: inside, on the edge, just past it, far outside
    locs = rng.uniform(-0.3, 1.3, (B, Nq, H, L, P, 2)).astype(np.float32)
    locs[0, :4, 0, :, 0] = np.array([[0, 0], [1, 1], [-1 / 16, 1 + 1 / 20], [0.5, -0.05]],
                                    np.float32)[:, None, :]
    attn = rng.uniform(0, 1, (B, Nq, H, L, P)).astype(np.float32)
    want = np.asarray(jax_sample([jnp.asarray(v) for v in values], jnp.asarray(locs),
                                 jnp.asarray(attn)))
    got = ms_deform_sample([torch.from_numpy(v) for v in values], torch.from_numpy(locs),
                           torch.from_numpy(attn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- the model

def _jax_flat(variables) -> dict[str, np.ndarray]:
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v, np.float32)

    walk(variables, "")
    return flat


def test_demo_rtdetr_matches_jax_package(pages):
    """The demo checkpoint (B0, 640, 60 queries, 3 decoder layers) on one
    fixture page, fp32: scores within 1e-4, boxes within 1e-4 (of the
    unit square), labels equal."""
    import jax.numpy as jnp

    from rapiddoc_tpu.models.layout.rtdetr import RTDETR as JaxRTDETR
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    from rapiddoc_tpu_torch.models.layout.engine import LayoutConfig, LayoutDetector
    from rapiddoc_tpu_torch.models.ocr.pre_post import resize_cubic
    from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz

    arch = json.loads((DEMO_ASSETS_DIR / "layout_demo.json").read_text())
    cfg = LayoutConfig(model_size=arch["model_size"], input_size=arch["input_size"],
                       num_queries=arch["num_queries"], dec_layers=arch["dec_layers"],
                       with_masks=arch["with_masks"])
    x = resize_cubic(pages[1], cfg.input_size, cfg.input_size)[None].astype(np.float32) / 255.0
    model = load_flax_into(LayoutDetector.make_model(cfg), load_npz(DEMO_ASSETS_DIR / "layout_demo.npz"))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model.eval()(torch.from_numpy(x)).items()}
    jax_model = JaxRTDETR(num_classes=25, backbone_size=cfg.model_size,
                          num_queries=cfg.num_queries, dec_layers=cfg.dec_layers)
    want = jax_model.apply(_load_variables(DEMO_ASSETS_DIR / "layout_demo.npz"), jnp.asarray(x))
    np.testing.assert_array_equal(got["labels"], np.asarray(want["labels"]))
    np.testing.assert_allclose(got["scores"], np.asarray(want["scores"]), atol=1e-4)
    np.testing.assert_allclose(got["boxes"], np.asarray(want["boxes"]), atol=1e-4)


def test_layout_detector_dets_equal_golden(pages, golden):
    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector

    det = LayoutDetector.build({"demo_layout": True}, device="cpu", dtype=torch.float32)
    assert det.demo_txt_fallback
    got = det.batch_predict(pages)
    for page, want in zip(got, golden["fp32"]["layout"], strict=True):
        assert [d["original_label"] for d in page] == [w["label"] for w in want]
        for d, w in zip(page, want):
            box = [d["poly"][i] for i in (0, 1, 4, 5)]
            assert max(abs(a - b) for a, b in zip(box, w["box"])) <= BOX_TOL
            assert abs(d["score"] - w["score"]) <= 1e-4


def test_published_shape_with_masks_matches_jax_random_init():
    """PP-DocLayoutV3's shape (B4, 300 queries, 6 decoder layers, masks)
    from a JAX random init (PRNGKey(0)), carried across by name, on a
    320x320 input in fp32: scores within 2e-4, boxes within 2e-4, labels
    equal, and the bit-packed masks agreeing on at least 99.9 % of bits."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.layout.rtdetr import RTDETR as JaxRTDETR

    from rapiddoc_tpu_torch.models.layout.rtdetr import RTDETR
    from rapiddoc_tpu_torch.models.weights import load_flax_into

    size = 320
    jax_model = JaxRTDETR(num_classes=25, backbone_size="B4", num_queries=300,
                          dec_layers=6, with_masks=True)
    x = np.random.default_rng(6).uniform(0, 1, (1, size, size, 3)).astype(np.float32)
    variables = jax_model.init(jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))
    want = jax.tree.map(np.asarray, jax_model.apply(variables, jnp.asarray(x)))
    model = load_flax_into(RTDETR(num_classes=25, backbone_size="B4", num_queries=300,
                                  dec_layers=6, with_masks=True), _jax_flat(variables))
    with torch.no_grad():
        got = {k: v.numpy() for k, v in model.eval()(torch.from_numpy(x)).items()}
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=2e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=2e-4)
    assert got["masks_bits"].shape == want["masks_bits"].shape
    same = np.unpackbits(got["masks_bits"]) == np.unpackbits(want["masks_bits"])
    assert same.mean() >= 0.999, same.mean()
