"""The port's seal OCR, curved-text detection and 8-bit layout wire against
OpenCV and the JAX package, on the CPU.

- Every OpenCV call seal OCR makes, replayed in numpy, against cv2 on
  seeded inputs: ``medianBlur``, ``HoughCircles`` (with its Sobel and
  Canny), ``warpPolar`` (samples whose taps lie inside the image: OpenCV
  leaves the others as its output buffer held them), ``remap`` and
  ``warpPerspective`` with a white border, ``getRotationMatrix2D`` with
  ``warpAffine``, Otsu's ``threshold``, ``findContours`` in list and
  external mode with points, filled ``drawContours``, the elliptical
  dilation and ``fitEllipse`` (borders of 20 or more points: floats
  within 1e-3 px and degrees, and in practice equal): all equal.
- ``db_postprocess_poly`` against the JAX package's on seeded prob maps,
  equal.
- The five committed crops (``seal_smoke_crops.npz``: a round stamp, an
  oval stamp, a curved band, a straight band, no stamp) in fp32 with the
  demo OCR: circles, ellipses, ``detect_polys`` polygons, the regions
  ``SealOCR.batch`` reads (sha256) and its texts equal to the JAX
  package's golden (``seal_smoke_golden.json``), and ``_run_seals`` with
  seal dets put in place; the port's own OCR raises where the JAX package
  would swallow the error, a custom OCR object keeps the fallback.
- ``RAPIDDOC_LAYOUT_WIRE_BITS=8``: the demo layout detector's fp32 dets on
  the layout fixture's pages equal to the JAX package's (boxes within
  0.05 px).

``python tests/test_torch_seal.py`` rebuilds the crops and the golden
(needs the JAX package, PIL and cv2; about a minute); ``--compare``
prints the port's bf16 reading on the CPU against the bf16 golden (the
source of the smoke's ``SEAL_BF16`` band).
"""
import hashlib
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_table as tt  # noqa: E402

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
CROPS_NPZ = ASSETS / "seal_smoke_crops.npz"
GOLDEN_JSON = ASSETS / "seal_smoke_golden.json"
LAYOUT_PDF = ASSETS / "layout_smoke_doc.pdf"
CROP_NAMES = ("circle", "ellipse", "arc_band", "straight_band", "no_stamp")
ELLIPSE_TOL = 1e-3  # px and degrees, fitEllipse's floats against OpenCV's
LAYOUT_BOX_TOL = 0.05  # px, the layout detector's fp32 boxes
PAGE_SIZE = (1000, 1400)  # the page _run_seals reads the crops from (w, h)

cv2 = pytest.importorskip("cv2")


# ------------------------------------------------------------------ crops

def _font(size: int):
    from PIL import ImageFont

    return ImageFont.load_default(size=size)


def _glyph(img, ch: str, x: float, y: float, angle: float, font, color) -> None:
    from PIL import Image, ImageDraw

    g = Image.new("RGBA", (64, 64), (0, 0, 0, 0))
    ImageDraw.Draw(g).text((32, 32), ch, font=font, fill=color + (255,), anchor="mm")
    g = g.rotate(angle, resample=Image.BICUBIC)
    img.paste(g, (int(round(x)) - 32, int(round(y)) - 32), g)


def _ring(img, text, cx, cy, rx, ry, font, color, start=-0.85, span=1.7) -> None:
    n = len(text)
    for i, ch in enumerate(text):
        a = math.pi * (start + span * i / max(n - 1, 1)) - math.pi / 2
        _glyph(img, ch, cx + rx * math.cos(a), cy + ry * math.sin(a),
               -math.degrees(a) - 90, font, color)


def make_crops() -> list[np.ndarray]:
    """The five seal crops, drawn with PIL's default font."""
    from PIL import Image, ImageDraw

    red, blue, black = (200, 30, 30), (30, 40, 190), (0, 0, 0)
    circle = Image.new("RGB", (240, 240), "white")
    c, r = 120.0, 240 * 0.42
    ImageDraw.Draw(circle).ellipse([c - r, c - r, c + r, c + r], outline=red, width=5)
    _ring(circle, "RAPIDDOC SEAL COMPANY LTD", c, c, r * 0.78, r * 0.78, _font(int(r * 0.2)), red)
    ImageDraw.Draw(circle).text((c, c), "2026", font=_font(int(r * 0.3)), fill=red, anchor="mm")

    oval = Image.new("RGB", (380, 320), "white")
    cx, cy, a, b = 190.0, 160.0, 150, 75
    ImageDraw.Draw(oval).ellipse([cx - a, cy - b, cx + a, cy + b], outline=blue, width=4)
    _ring(oval, "OVAL STAMP OFFICE", cx, cy, a * 0.82, b * 0.72, _font(int(b * 0.22)), blue,
          -0.6, 1.2)
    ImageDraw.Draw(oval).text((cx, cy + 8), "No 42", font=_font(int(b * 0.3)), fill=blue,
                              anchor="mm")

    arc = Image.new("RGB", (420, 200), "white")
    text = "CURVED TEXT LINE"
    for i, ch in enumerate(text):
        x = 30 + 360 * i / (len(text) - 1)
        y = 120 - 60 * math.sin(math.pi * (x - 30) / 360)
        slope = -60 * math.pi / 360 * math.cos(math.pi * (x - 30) / 360)
        _glyph(arc, ch, x, y, -math.degrees(math.atan(slope)), _font(30), black)

    straight = Image.new("RGB", (420, 200), "white")
    ImageDraw.Draw(straight).text((20, 80), "STRAIGHT SEAL TEXT 2026", font=_font(30), fill=black)

    blank = Image.new("RGB", (200, 140), (250, 250, 246))
    ImageDraw.Draw(blank).text((12, 50), "blank", font=_font(22), fill=(90, 90, 90))
    return [np.asarray(im) for im in (circle, oval, arc, straight, blank)]


def seal_page(crops: list[np.ndarray]) -> tuple[np.ndarray, list[list[float]]]:
    """A white page with the crops pasted down its left half, and each
    crop's box (x0, y0, x1, y1) on it."""
    w, h = PAGE_SIZE
    page = np.full((h, w, 3), 255, np.uint8)
    boxes, y = [], 20
    for i, crop in enumerate(crops):
        x = 40 + 300 * (i % 2)
        ch, cw = crop.shape[:2]
        page[y:y + ch, x:x + cw] = crop
        boxes.append([float(x), float(y), float(x + cw - 1), float(y + ch - 1)])
        y += ch + 24
    return page, boxes


class SealLayout:
    """A layout model that puts a seal det on each given box."""

    def __init__(self, boxes):
        self.boxes = boxes

    def batch_predict(self, pages):
        return [[{"category_id": 3, "original_label": "seal", "score": 0.9,
                  "poly": [x0, y0, x1, y0, x1, y1, x0, y1]}
                 for x0, y0, x1, y1 in self.boxes] for _ in pages]


class Recording:
    """A text system that records the regions it reads."""

    def __init__(self, system):
        self.system = system
        self.detector = system.detector
        self.regions: list[np.ndarray] = []

    def __call__(self, regions):
        self.regions.extend(regions)
        return self.system(regions)


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def _ellipse_row(e):
    return None if e is None else [float(e[0][0]), float(e[0][1]), float(e[1][0]),
                                   float(e[1][1]), float(e[2])]


def _polys(polys):
    return [[np.asarray(p, np.float64).tolist() for p in page] for page in polys]


def jax_seal(crops: list[np.ndarray], fp32: bool) -> dict:
    from rapiddoc_tpu.models.ocr import seal
    from rapiddoc_tpu.models.registry import build_ocr_system
    from rapiddoc_tpu.pipeline.scheduler import DocumentAnalyzer

    env = {"RAPIDDOC_FP32_PARAMS": "1"} if fp32 else {}
    with tt.table_env(**env):
        ocr = build_ocr_system()
        rec = Recording(ocr)
        texts = seal.SealOCR(rec).batch(crops)
        page, boxes = seal_page(crops)
        infos = DocumentAnalyzer(layout_model=SealLayout(boxes), ocr_system=ocr).analyze_pages(
            [page], ["txt"], [None])
        out = {"texts": texts, "regions": [sha256(r) for r in rec.regions],
               "run_seals": [d.get("text", "") for d in infos[0]["layout_dets"]]}
        if fp32:
            out["polys"] = _polys(ocr.detector.detect_polys(crops, params=seal.SEAL_DET_PARAMS))
    return out


def jax_layout_rows(pages: list[np.ndarray]) -> list:
    from rapiddoc_tpu.models.layout.engine import LayoutDetector

    pl = tt._pipeline_helpers()
    with tt.table_env(RAPIDDOC_FP32_PARAMS="1", RAPIDDOC_LAYOUT_WIRE_BITS="8"):
        det = LayoutDetector.build({})
        assert not det.nibble_wire
        return [pl.layout_rows(d) for d in det.batch_predict(pages)]


def make_golden(crops: list[np.ndarray]) -> dict:
    from rapiddoc_tpu.models.ocr import seal

    pl = tt._pipeline_helpers()
    return {
        "source": "rapiddoc_tpu models/ocr/seal.py and LayoutDetector on the CPU; "
                  "rebuilt by tests/test_torch_seal.py",
        "crop_sha256": [sha256(c) for c in crops],
        "circles": [seal.detect_circle(c) for c in crops],
        "ellipses": [_ellipse_row(seal.detect_ellipse(c)) for c in crops],
        "fp32": jax_seal(crops, True),
        "bf16": jax_seal(crops, False),
        "layout_wire8": jax_layout_rows(pl.jax_pages(LAYOUT_PDF.read_bytes())),
    }


# --------------------------------------------------------------- fixtures

@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def crops() -> list[np.ndarray]:
    with np.load(CROPS_NPZ) as z:
        return [z[name] for name in CROP_NAMES]


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def ocr32():
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    with tt.table_env():
        return build_ocr_system(device="cpu", dtype=torch.float32)


# ------------------------------------------------------------ cv2 replays

def _stamp(rng) -> np.ndarray:
    size = int(rng.integers(120, 260))
    img = np.full((size, size, 3), 255, np.uint8)
    c = size // 2 + rng.integers(-8, 9, 2)
    color = tuple(int(v) for v in rng.integers(0, 200, 3))
    cv2.circle(img, (int(c[0]), int(c[1])), int(size * rng.uniform(0.3, 0.45)), color,
               int(rng.integers(2, 6)))
    for _ in range(12):
        p = rng.integers(20, size - 20, 2)
        cv2.putText(img, "AB", (int(p[0]), int(p[1])), cv2.FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    return img


def test_median_blur_sobel_canny_hough_equal_cv2(crops):
    """medianBlur(5), the 3x3 Sobel pair, Canny(L1, 60, 120) and
    HoughCircles(dp=1.5) with the seal's parameters, on the crops, drawn
    stamps and noise: equal to OpenCV's."""
    from rapiddoc_tpu_torch.models.ocr.pre_post import rgb_to_gray
    from rapiddoc_tpu_torch.utils import hough

    rng = np.random.default_rng(0)
    images = list(crops) + [_stamp(rng) for _ in range(24)] + [
        rng.integers(0, 256, (int(rng.integers(60, 160)), int(rng.integers(60, 160)), 3),
                     dtype=np.uint8) for _ in range(6)]
    found = 0
    for img in images:
        gray = rgb_to_gray(img)
        blur = hough.median_blur(gray, 5)
        assert np.array_equal(blur, cv2.medianBlur(gray, 5))
        dx, dy = hough.sobel3(blur)
        cdx = cv2.Sobel(blur, cv2.CV_16S, 1, 0, ksize=3, borderType=cv2.BORDER_REPLICATE)
        cdy = cv2.Sobel(blur, cv2.CV_16S, 0, 1, ksize=3, borderType=cv2.BORDER_REPLICATE)
        assert np.array_equal(dx, cdx) and np.array_equal(dy, cdy)
        assert np.array_equal(hough.canny_from_derivatives(dx, dy, 60, 120),
                              cv2.Canny(cdx, cdy, 60, 120))
        h, w = gray.shape
        kw = dict(min_radius=min(h, w) // 4, max_radius=max(h, w) // 2 + 8)
        want = cv2.HoughCircles(blur, cv2.HOUGH_GRADIENT, dp=1.5, minDist=max(h, w), param1=120,
                                param2=40, minRadius=kw["min_radius"], maxRadius=kw["max_radius"])
        got = hough.hough_circles(blur, 1.5, max(h, w), 120, 40, **kw)
        assert (got is None) == (want is None)
        if want is not None:
            found += 1
            assert np.array_equal(got, want)
        # all circles, not only the first: min_dist below a pixel
        want = cv2.HoughCircles(blur, cv2.HOUGH_GRADIENT, dp=1.5, minDist=0.5, param1=120,
                                param2=40, minRadius=kw["min_radius"], maxRadius=kw["max_radius"])
        got = hough.hough_circles(blur, 1.5, 0.5, 120, 40, **kw)
        assert (got is None) == (want is None) and (want is None or np.array_equal(got, want))
    assert found >= 20


def test_warps_equal_cv2(crops):
    """remap (white border), warpPolar (where its taps lie inside the
    image), getRotationMatrix2D with warpAffine and warpPerspective with a
    white border: equal to OpenCV's; remap past SHRT_MAX raises the
    named error."""
    from rapiddoc_tpu_torch.models.ocr import pre_post as P

    rng = np.random.default_rng(1)
    img = crops[1]
    ih, iw = img.shape[:2]
    for _ in range(4):
        h, w = int(rng.integers(5, 60)), int(rng.integers(5, 90))
        mx = rng.uniform(-8, iw + 8, (h, w)).astype(np.float32)
        my = rng.uniform(-8, ih + 8, (h, w)).astype(np.float32)
        want = cv2.remap(img, mx, my, cv2.INTER_LINEAR, borderValue=(255, 255, 255))
        assert np.array_equal(P.remap_linear(img, mx, my, 255), want)
    for cx, cy, r in ((190, 160, 120), (100, 120, 90), (300, 200, 17)):
        width, height = r, int(2 * math.pi * r)
        want = cv2.warpPolar(img, (width, height), (cx, cy), r,
                             cv2.WARP_POLAR_LINEAR + cv2.INTER_LINEAR)
        got = P.warp_polar_linear(img, width, height, (cx, cy), r)
        rho = (np.arange(width) * (r / width)).astype(np.float32).astype(np.float64)
        phi = np.arange(height) * (2 * math.pi / height)
        sx = (rho[None] * np.cos(phi)[:, None] + cx).astype(np.float32)
        sy = (rho[None] * np.sin(phi)[:, None] + cy).astype(np.float32)
        inside = (sx >= 0) & (sy >= 0) & (sx < iw - 1) & (sy < ih - 1)
        assert inside.mean() > 0.5
        assert np.array_equal(got[inside], want[inside])
    for _ in range(6):
        cx, cy = float(rng.uniform(0, iw)), float(rng.uniform(0, ih))
        angle = float(rng.uniform(-180, 180))
        m = P.rotation_matrix_2d(cx, cy, angle, 1.0)
        assert np.array_equal(m, cv2.getRotationMatrix2D((cx, cy), angle, 1.0))
        want = cv2.warpAffine(img, m, (iw, ih), borderValue=(255, 255, 255))
        assert np.array_equal(P.warp_affine(img, m, iw, ih, 255), want)
        src = np.float32([[10, 10], [200, 30], [220, 180], [5, 150]]) + rng.uniform(-5, 5, (4, 2))
        dst = np.float32([[0, 0], [90, 0], [90, 33], [0, 33]])
        m = P.perspective_transform(src.astype(np.float32), dst)
        want = cv2.warpPerspective(img, m, (90, 33), flags=cv2.INTER_LINEAR,
                                   borderValue=(255, 255, 255))
        assert np.array_equal(P.warp_perspective(img, m, 90, 33, border_value=255), want)
    with pytest.raises(P.OpenCVError):
        P.remap_linear(img, np.zeros((2, 32767), np.float32), np.zeros((2, 32767), np.float32))
    with pytest.raises(P.OpenCVError):
        P.warp_polar_linear(img, 0, 0, (10, 10), 0)


def _blobs(rng, n: int) -> list[np.ndarray]:
    from scipy import ndimage

    out = []
    for i in range(n):
        h, w = int(rng.integers(5, 60)), int(rng.integers(5, 60))
        m = rng.random((h, w)) < rng.uniform(0.2, 0.7)
        if i % 3 == 0:
            m = ndimage.binary_dilation(m, iterations=int(rng.integers(1, 3)))
        elif i % 3 == 1:
            m = ndimage.gaussian_filter(rng.random((h, w)), 2) > 0.5
        out.append(m.astype(np.uint8))
    return out


def test_contours_otsu_dilation_fill_equal_cv2():
    """findContours (RETR_LIST and RETR_EXTERNAL, CHAIN_APPROX_SIMPLE and
    NONE) with their points and order, filled drawContours of each
    contour, Otsu's threshold, the elliptical element and its dilation:
    equal to OpenCV's."""
    from rapiddoc_tpu_torch.models.ocr.pre_post import fill_poly_mask
    from rapiddoc_tpu_torch.utils import contours as C
    from rapiddoc_tpu_torch.utils import morph

    rng = np.random.default_rng(2)
    for m in _blobs(rng, 90):
        for simple, method in ((True, cv2.CHAIN_APPROX_SIMPLE), (False, cv2.CHAIN_APPROX_NONE)):
            want, _ = cv2.findContours(m, cv2.RETR_LIST, method)
            got = C.find_contours_list(m, simple)
            assert len(got) == len(want)
            for (g, _), w in zip(got, want):
                assert np.array_equal(g, w)
                if simple:
                    x, y, cw, ch = cv2.boundingRect(w)
                    filled = np.zeros((ch, cw), np.uint8)
                    cv2.drawContours(filled, [w - [x, y]], -1, 1, -1)
                    assert np.array_equal(fill_poly_mask((ch, cw), g.reshape(-1, 2) - [x, y]),
                                          filled.astype(bool))
            want, _ = cv2.findContours(m, cv2.RETR_EXTERNAL, method)
            got = C.find_contours_external_simple(m, simple)
            assert len(got) == len(want) and all(np.array_equal(g, w) for g, w in zip(got, want))
        k = 2 * int(rng.integers(1, 30)) + 1
        elem = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (k, k))
        assert np.array_equal(morph.ellipse_element(k), elem.astype(bool))
        assert np.array_equal(morph.dilate_ellipse(m, k), cv2.dilate(m, elem))
        gray = (rng.random(m.shape) * 255).astype(np.uint8)
        for g in (gray, m * 200, np.full(m.shape, 7, np.uint8)):
            thresh, want = cv2.threshold(g, 0, 255, cv2.THRESH_BINARY_INV + cv2.THRESH_OTSU)
            assert morph.otsu_threshold(g) == int(thresh)
            assert np.array_equal(morph.threshold_otsu_inv(g), want)


def test_fit_ellipse_and_contour_area_equal_cv2():
    """fitEllipse of external borders of 20 or more points (drawn
    ellipses, with noise): floats within ELLIPSE_TOL of OpenCV's (they come
    out equal here), and contourArea equal."""
    from rapiddoc_tpu_torch.utils import contours as C

    rng = np.random.default_rng(3)
    fits = 0
    for i in range(80):
        img = np.zeros((200, 300), np.uint8)
        center = (int(rng.uniform(80, 220)), int(rng.uniform(60, 140)))
        axes = (int(rng.uniform(20, 90)), int(rng.uniform(15, 60)))
        cv2.ellipse(img, center, axes, rng.uniform(0, 180), 0, 360, 255, int(rng.integers(1, 5)))
        if i % 2:
            img |= (rng.random(img.shape) < 0.02).astype(np.uint8) * 255
        for c in cv2.findContours(img, cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_NONE)[0]:
            if len(c) < 20:
                continue
            (x, y), (w, h), a = cv2.fitEllipse(c)
            (gx, gy), (gw, gh), ga = C.fit_ellipse(c)
            assert max(abs(x - gx), abs(y - gy), abs(w - gw), abs(h - gh), abs(a - ga)) <= ELLIPSE_TOL
            assert C.contour_area(c) == cv2.contourArea(c)
            fits += 1
    assert fits >= 80


# ------------------------------------------------------ poly det and seal

def test_db_postprocess_poly_equals_jax_package():
    """Seeded prob maps (smooth blobs and arc bands) through the seal
    params and the defaults: polygons and scores equal."""
    from scipy import ndimage

    from rapiddoc_tpu.models.ocr import pre_post as J

    from rapiddoc_tpu_torch.models.ocr import pre_post as P

    rng = np.random.default_rng(4)
    total = 0
    for i in range(60):
        h, w = int(rng.integers(32, 160)), int(rng.integers(32, 200))
        if i % 3 == 0:
            yy, xx = np.mgrid[0:h, 0:w]
            r = np.hypot(xx - w / 2, yy - h * 1.2)
            prob = np.clip(1 - np.abs(r - h * 0.8) / 6, 0, 1) * rng.uniform(0.6, 1)
        else:
            prob = ndimage.gaussian_filter(rng.random((h, w)), rng.uniform(1.5, 4))
            prob = (prob - prob.min()) / (prob.max() - prob.min() + 1e-9)
        prob = prob.astype(np.float32)
        for kw in (dict(thresh=0.2, box_thresh=0.6, unclip_ratio=0.5, use_dilation=False), {}):
            want, ws = J.db_postprocess_poly(prob, 2 * h, 2 * w, params=J.DBPostParams(**kw))
            got, gs = P.db_postprocess_poly(prob, 2 * h, 2 * w, params=P.DBPostParams(**kw))
            assert len(got) == len(want) and np.array_equal(gs, ws)
            assert all(np.array_equal(g, x) for g, x in zip(got, want))
            total += len(want)
    assert total >= 30


def test_crops_match_committed(crops, golden):
    assert [sha256(c) for c in crops] == golden["crop_sha256"]
    assert [sha256(c) for c in make_crops()] == golden["crop_sha256"]


def test_circles_ellipses_polys_equal_golden(crops, golden, ocr32):
    """detect_circle on every crop and detect_ellipse on each crop without
    a circle (a circle's fitEllipse angle is ill-conditioned): equal to
    the JAX package's (ellipse floats within ELLIPSE_TOL); detect_polys
    with the seal params in fp32: equal."""
    from rapiddoc_tpu_torch.models.ocr import seal

    circles = [seal.detect_circle(c) for c in crops]
    assert [None if c is None else list(c) for c in circles] == golden["circles"]
    assert circles[0] is not None and circles[1] is None
    for c, circle, want in zip(crops, circles, golden["ellipses"]):
        if circle is not None:
            continue
        got = _ellipse_row(seal.detect_ellipse(c))
        assert (got is None) == (want is None)
        if want is not None:
            assert max(abs(a - b) for a, b in zip(got, want)) <= ELLIPSE_TOL
    assert golden["ellipses"][1] is not None
    polys = _polys(ocr32.detector.detect_polys(crops, params=seal.SEAL_DET_PARAMS))
    assert polys == golden["fp32"]["polys"]


def test_seal_ocr_batch_and_run_seals_equal_golden(crops, golden, ocr32):
    """SealOCR.batch in fp32: the regions it reads (strips, inner crops,
    remainders; sha256) and its texts equal to the golden; _run_seals with
    seal dets put in place on a page: the seal texts equal."""
    from rapiddoc_tpu_torch.models.ocr.seal import SealOCR
    from rapiddoc_tpu_torch.pipeline.scheduler import DocumentAnalyzer

    want = golden["fp32"]
    rec = Recording(ocr32)
    assert SealOCR(rec).batch(crops) == want["texts"]
    assert [sha256(r) for r in rec.regions] == want["regions"]
    assert len(rec.regions) > len(crops)  # strips beside inner crops and remainders
    page, boxes = seal_page(crops)
    infos = DocumentAnalyzer(layout_model=SealLayout(boxes), ocr_system=ocr32).analyze_pages(
        [page], ["txt"], [None])
    assert [d.get("text", "") for d in infos[0]["layout_dets"]] == want["run_seals"]


def test_own_ocr_raises_custom_ocr_falls_back(crops, ocr32, monkeypatch):
    """A fault in the port's own detector surfaces from SealOCR and from
    _run_seals; a custom text system keeps the JAX package's fallbacks (no
    curved strips, the seals left without text); OpenCVError from the
    polar warp is caught as the JAX package catches cv2.error."""
    from rapiddoc_tpu_torch.models.ocr import seal
    from rapiddoc_tpu_torch.models.ocr.engine import TextDetector
    from rapiddoc_tpu_torch.pipeline.scheduler import DocumentAnalyzer

    def broken(self, *args, **kwargs):
        raise RuntimeError("det failed")

    page, boxes = seal_page(crops)
    with monkeypatch.context() as m:
        m.setattr(TextDetector, "detect_polys", broken)
        with pytest.raises(RuntimeError, match="det failed"):
            seal.SealOCR(ocr32).batch([crops[2]])
        with pytest.raises(RuntimeError, match="det failed"):
            DocumentAnalyzer(layout_model=SealLayout(boxes), ocr_system=ocr32).analyze_pages(
                [page], ["txt"], [None])

    class Custom:
        detector = type("D", (), {"detect_polys": broken})()

        def __call__(self, regions):
            raise RuntimeError("custom failed")

    strips, remainder = seal.SealOCR(Custom())._curved_strips(crops[2])
    assert strips == [] and remainder is crops[2]
    infos = DocumentAnalyzer(layout_model=SealLayout(boxes), ocr_system=Custom()).analyze_pages(
        [page], ["txt"], [None])
    assert all(not d.get("text") for d in infos[0]["layout_dets"])

    def polar_fails(*args, **kwargs):
        raise seal.OpenCVError("remap: a side of SHRT_MAX or more")

    rec = Recording(ocr32)
    monkeypatch.setattr(seal, "warp_polar_linear", polar_fails)
    seal.SealOCR(rec).batch([crops[0]])
    assert len(rec.regions) == 1  # the inner crop only, as the JAX package


def test_seal_debug_dump_writes_the_crop(crops, tmp_path, monkeypatch):
    """RAPIDDOC_SEAL_OCR_DEBUG_DIR: each crop is written as a PNG that
    decodes to its pixels (PIL and the port's decoder)."""
    from PIL import Image

    from rapiddoc_tpu_torch.models.ocr.seal import SealOCR
    from rapiddoc_tpu_torch.pdfio.png import decode_png

    monkeypatch.setenv("RAPIDDOC_SEAL_OCR_DEBUG_DIR", str(tmp_path))
    monkeypatch.setattr(SealOCR, "_dump_n", 0)
    SealOCR(lambda regions: [[] for _ in regions])._debug_dump(crops[4])
    data = (tmp_path / "seal_0000.png").read_bytes()
    assert np.array_equal(np.asarray(Image.open(tmp_path / "seal_0000.png")), crops[4])
    assert np.array_equal(decode_png(data), crops[4])


def test_layout_8bit_wire_dets_equal_jax_package(golden):
    """RAPIDDOC_LAYOUT_WIRE_BITS=8 ships RGB uint8 as the JAX package's
    wire does: the demo detector's fp32 dets on the layout fixture's four
    pages equal to the golden (labels in order, boxes within 0.05 px,
    scores within 1e-4)."""
    import torch

    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    doc = open_pdf(LAYOUT_PDF.read_bytes())
    pages = [render_page_full(doc.get_page(i), dpi=200, with_text=False)[0]
             for i in range(len(doc))]
    with tt.table_env(RAPIDDOC_LAYOUT_WIRE_BITS="8"):
        det = LayoutDetector.build({"demo_layout": True}, device="cpu", dtype=torch.float32)
    size = det.config.input_size
    assert not det.nibble_wire and det.preprocess(pages[:1]).shape == (1, size, size, 3)
    got = det.batch_predict(pages)
    for page, want in zip(got, golden["layout_wire8"], strict=True):
        assert [d["original_label"] for d in page] == [w["label"] for w in want]
        for d, w in zip(page, want):
            box = [d["poly"][i] for i in (0, 1, 4, 5)]
            assert max(abs(a - b) for a, b in zip(box, w["box"])) <= LAYOUT_BOX_TOL
            assert abs(d["score"] - w["score"]) <= 1e-4


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def compare() -> dict:
    import torch

    from rapiddoc_tpu_torch.models.ocr.seal import SealOCR
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    with np.load(CROPS_NPZ) as z:
        crops = [z[name] for name in CROP_NAMES]
    with tt.table_env():
        ocr = build_ocr_system(device="cpu", dtype=torch.bfloat16)
    texts = SealOCR(ocr).batch(crops)
    return {"port_bf16_cpu": smoke.compare_seal_texts(texts, golden["bf16"]["texts"]),
            "jax_fp32_vs_bf16": smoke.compare_seal_texts(golden["fp32"]["texts"],
                                                         golden["bf16"]["texts"])}


if __name__ == "__main__":
    # Rewrites the crops and the golden; with --compare, prints compare()
    # instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(), indent=1))
    else:
        made = make_crops()
        np.savez_compressed(CROPS_NPZ, **dict(zip(CROP_NAMES, made)))
        GOLDEN_JSON.write_text(json.dumps(make_golden(made), indent=1) + "\n")
        print("wrote", CROPS_NPZ, GOLDEN_JSON)
