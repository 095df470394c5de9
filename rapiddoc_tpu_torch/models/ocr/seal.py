"""Seal (stamp) OCR: polygon detection params and curved-text rectification.

Port of ``rapiddoc_tpu/models/ocr/seal.py``: ``detect_circle`` (:24),
``unwrap_circular_text`` (:40), ``rectify_curved_polygon`` (:56),
``AutoRectifier`` (:98), ``detect_ellipse`` (:169),
``unwrap_elliptical_text`` (:194) and ``SealOCR`` (:212). Round stamps
are unwrapped with a polar transform, oval ones squashed to a circle
first, and other curved text is detected as 2k-point polygons and
straightened. Every OpenCV call is a numpy replay:

- ``cvtColor(RGB2GRAY)``: ``pre_post.rgb_to_gray``;
- ``medianBlur`` and ``HoughCircles``: ``utils/hough.py``;
- ``warpPolar``, ``remap``, ``getRotationMatrix2D`` with ``warpAffine``,
  ``warpPerspective`` with a white border and ``resize(INTER_LINEAR)``:
  ``pre_post.warp_polar_linear``, ``remap_linear``,
  ``rotation_matrix_2d``, ``warp_affine``, ``warp_perspective`` and
  ``resize_linear``; ``rotate(ROTATE_90_COUNTERCLOCKWISE)`` is
  ``np.rot90``;
- Otsu's ``threshold``: ``utils/morph.py``;
- ``findContours(RETR_EXTERNAL, CHAIN_APPROX_NONE)``, ``fitEllipse`` and
  ``contourArea``: ``utils/contours.py``; ``fillPoly``:
  ``pre_post.fill_poly_mask``.

Where OpenCV raises ``cv2.error`` (a remap with a side of SHRT_MAX or
more, a polar warp to an empty size), the replays raise
``pre_post.OpenCVError``; ``SealOCR.batch`` catches that error alone,
where the JAX package catches ``cv2.error``. The JAX package also
swallows any exception around ``detect_polys``; here that holds only for
a text system that is not the port's own: the port's detector raises.
"""
from __future__ import annotations

import math
import os

import numpy as np

from ...utils.contours import contour_area, find_contours_external_simple, fit_ellipse
from ...utils.hough import hough_circles, median_blur
from ...utils.morph import threshold_otsu_inv
from .engine import TextDetector
from .pre_post import (
    DBPostParams,
    OpenCVError,
    fill_poly_mask,
    perspective_transform,
    remap_linear,
    resize_linear,
    rgb_to_gray,
    rotation_matrix_2d,
    warp_affine,
    warp_perspective,
    warp_polar_linear,
)

SEAL_DET_PARAMS = DBPostParams(
    thresh=0.2, box_thresh=0.6, unclip_ratio=0.5, use_dilation=False
)
WHITE = 255


def _gray(img: np.ndarray) -> np.ndarray:
    return rgb_to_gray(img) if img.ndim == 3 else img


def detect_circle(img: np.ndarray) -> tuple[int, int, int] | None:
    """(cx, cy, r) of the dominant circle, if the crop looks like a stamp."""
    gray = _gray(img)
    h, w = gray.shape
    circles = hough_circles(
        median_blur(gray, 5), dp=1.5, min_dist=max(h, w), param1=120, param2=40,
        min_radius=min(h, w) // 4, max_radius=max(h, w) // 2 + 8,
    )
    if circles is None:
        return None
    cx, cy, r = circles[0][0]
    return int(cx), int(cy), int(r)


def unwrap_circular_text(
    img: np.ndarray, cx: int, cy: int, r: int, band: float = 0.35
) -> np.ndarray:
    """Unwrap the outer text ring of a circular stamp into a straight strip."""
    out_w = int(2 * math.pi * r)
    out_h = max(12, int(r * band))
    polar = warp_polar_linear(img, r, out_w, (cx, cy), r)
    # polar: rows = angle, cols = radius; outer band then rotate to strip
    return np.ascontiguousarray(np.rot90(polar[:, r - out_h :]))


def rectify_curved_polygon(img: np.ndarray, pts) -> np.ndarray | None:
    """Straighten curved text given its 2k-point polygon (first k points
    along the top edge left to right, last k along the bottom edge right
    to left): each quad segment warps perspectively to an upright slice,
    and the slices concatenate into one strip."""
    pts = np.asarray(pts, np.float32)
    if len(pts) < 6 or len(pts) % 2:
        return None
    k = len(pts) // 2
    top = pts[:k]
    bot = pts[k:][::-1]
    heights = np.linalg.norm(top - bot, axis=1)
    out_h = int(np.clip(np.median(heights), 8, 256))
    slices = []
    for i in range(k - 1):
        w = 0.5 * (
            np.linalg.norm(top[i + 1] - top[i])
            + np.linalg.norm(bot[i + 1] - bot[i])
        )
        w = int(max(2, round(w)))
        src = np.asarray([top[i], top[i + 1], bot[i + 1], bot[i]], np.float32)
        dst = np.asarray([[0, 0], [w, 0], [w, out_h], [0, out_h]], np.float32)
        m = perspective_transform(src, dst)
        slices.append(warp_perspective(img, m, w, out_h, border_value=WHITE))
    return np.concatenate(slices, axis=1)


class AutoRectifier:
    """Curved-text rectification from a detected 2k-point polygon: a
    quartic least-squares fit per long edge, columns sampled uniformly in
    arc length along the mid curve, one remap. Polygons too short to fit
    (k < 4) or near-vertical go to ``rectify_curved_polygon``."""

    def __init__(self, degree: int = 4, max_h: int = 64):
        self.degree = degree
        self.max_h = max_h

    def __call__(self, img: np.ndarray, pts) -> np.ndarray | None:
        pts = np.asarray(pts, np.float32)
        if len(pts) < 6 or len(pts) % 2:
            return None
        k = len(pts) // 2
        if k < 4:
            return rectify_curved_polygon(img, pts)
        top = pts[:k]
        bot = pts[k:][::-1]
        # near-vertical text: column-parameterized fits are degenerate
        x_span = max(top[:, 0].max() - top[:, 0].min(), 1.0)
        y_span = max(pts[:, 1].max() - pts[:, 1].min(), 1.0)
        if x_span < y_span * 0.75:
            return rectify_curved_polygon(img, pts)
        deg = int(min(self.degree, k - 1))
        try:
            top_fit = np.polyfit(top[:, 0], top[:, 1], deg)
            bot_fit = np.polyfit(bot[:, 0], bot[:, 1], deg)
        except (np.linalg.LinAlgError, ValueError):
            return rectify_curved_polygon(img, pts)
        x0 = float(min(top[:, 0].min(), bot[:, 0].min()))
        x1 = float(max(top[:, 0].max(), bot[:, 0].max()))
        # arc length of the mid curve -> output width; uniform arc-length
        # sampling so curved ends are not horizontally squashed
        mid_fit = (top_fit + bot_fit) / 2.0
        xs_dense = np.linspace(x0, x1, 512)
        ys_dense = np.polyval(mid_fit, xs_dense)
        seg = np.hypot(np.diff(xs_dense), np.diff(ys_dense))
        arc = np.concatenate([[0.0], np.cumsum(seg)])
        out_w = int(np.clip(arc[-1], 8, 4096))
        thick = np.abs(np.polyval(bot_fit, xs_dense) - np.polyval(top_fit, xs_dense))
        out_h = int(np.clip(np.median(thick), 8, self.max_h))
        # invert arc-length: for each output column, the source x
        u = np.linspace(0.0, arc[-1], out_w)
        src_x = np.interp(u, arc, xs_dense)
        ty = np.polyval(top_fit, src_x)
        by = np.polyval(bot_fit, src_x)
        v = (np.arange(out_h, dtype=np.float32) + 0.5) / out_h
        map_x = np.broadcast_to(src_x[None, :], (out_h, out_w)).astype(np.float32)
        map_y = (ty[None, :] + v[:, None] * (by - ty)[None, :]).astype(np.float32)
        return remap_linear(img, map_x, map_y, WHITE)


def detect_ellipse(img: np.ndarray) -> tuple | None:
    """((cx, cy), (major, minor), angle) of the dominant stamp ellipse."""
    gray = _gray(img)
    h, w = gray.shape
    best = None
    for c in find_contours_external_simple(threshold_otsu_inv(gray), simple=False):
        if len(c) < 20:
            continue
        (cx, cy), (ma, mb), angle = fit_ellipse(c)
        if ma < min(h, w) * 0.4 or mb < min(h, w) * 0.3:
            continue
        if ma > max(h, w) * 1.2 or mb > max(h, w) * 1.2:
            continue
        area = contour_area(c)
        if best is None or area > best[0]:
            best = (area, ((cx, cy), (ma, mb), angle))
    return best[1] if best else None


def unwrap_elliptical_text(img: np.ndarray, ellipse) -> np.ndarray | None:
    """Scale the image so the stamp ellipse becomes a circle, then unwrap
    its text ring."""
    (cx, cy), (ma, mb), angle = ellipse
    if mb <= 0:
        return None
    # rotate so the major axis is horizontal, then squash x to a circle
    h, w = img.shape[:2]
    rotated = warp_affine(img, rotation_matrix_2d(cx, cy, angle - 90, 1.0), w, h,
                          border_value=WHITE)
    ratio = mb / ma
    squashed = resize_linear(rotated, max(1, int(w * ratio)), h)
    r = int(mb / 2)
    return unwrap_circular_text(squashed, int(cx * ratio), int(cy), r)


class SealOCR:
    """Detect and read stamp text inside a seal region crop."""

    def __init__(self, text_system):
        self.text_system = text_system

    def __call__(self, crop: np.ndarray) -> str:
        return self.batch([crop])[0]

    def batch(self, crops: list[np.ndarray]) -> list[str]:
        """All seals' rectified strips and centres go through the text
        system in one batched call."""
        regions: list[np.ndarray] = []
        owners: list[int] = []
        for i, crop in enumerate(crops):
            self._debug_dump(crop)
            circle = detect_circle(crop)
            if circle is not None:
                cx, cy, r = circle
                try:
                    strip = unwrap_circular_text(crop, cx, cy, r)
                    regions.append(strip)
                    owners.append(i)
                except OpenCVError:
                    pass
                # centre text (horizontal) from the inner region
                inner = crop[
                    max(cy - r // 2, 0) : cy + r // 2,
                    max(cx - r // 2, 0) : cx + r // 2,
                ]
                if inner.size:
                    regions.append(inner)
                    owners.append(i)
                continue
            ellipse = detect_ellipse(crop)
            if ellipse is not None:
                try:
                    strip = unwrap_elliptical_text(crop, ellipse)
                except OpenCVError:
                    strip = None
                if strip is not None and strip.size:
                    regions.append(strip)
                    owners.append(i)
                (ecx, ecy), (ma, mb), _ = ellipse
                iy0 = max(int(ecy - mb / 4), 0)
                ix0 = max(int(ecx - ma / 4), 0)
                inner = crop[iy0 : int(ecy + mb / 4), ix0 : int(ecx + ma / 4)]
                if inner.size:
                    regions.append(inner)
                    owners.append(i)
                continue
            # no circular or elliptical stamp: general curved text
            strips, remainder = self._curved_strips(crop)
            for s in strips:
                regions.append(s)
                owners.append(i)
            # the remainder (curved bands painted out) keeps straight
            # lines readable without reading the curved text twice
            regions.append(remainder)
            owners.append(i)
        texts: list[list[str]] = [[] for _ in crops]
        if regions:
            for i, items in zip(owners, self.text_system(regions)):
                texts[i].extend(item["text"] for item in items)
        return [" ".join(t for t in ts if t) for ts in texts]

    def _curved_strips(self, crop: np.ndarray) -> tuple[list[np.ndarray], np.ndarray]:
        """Curved text polys in the crop, each rectified to a straight
        strip, and the crop with those bands painted white. Straight
        bands stay in the remainder for the normal det and rec path."""
        det = getattr(self.text_system, "detector", None)
        if det is None or not hasattr(det, "detect_polys"):
            return [], crop
        if isinstance(det, TextDetector):
            polys = det.detect_polys([crop], params=SEAL_DET_PARAMS)[0]
        else:
            try:  # a custom detector: the JAX package's fallback
                polys = det.detect_polys([crop], params=SEAL_DET_PARAMS)[0]
            except Exception:
                return [], crop
        rectifier = AutoRectifier()
        strips: list[np.ndarray] = []
        remainder = crop
        for poly in polys:
            if len(poly) <= 4:
                continue
            top = poly[: len(poly) // 2]
            # curvature gate: skip effectively-straight bands
            resid = np.abs(
                np.polyval(np.polyfit(top[:, 0], top[:, 1], 1), top[:, 0]) - top[:, 1]
            ).max() if len(top) >= 3 else 0.0
            if resid < 2.0:
                continue
            strip = rectifier(crop, poly)
            if strip is not None and strip.size:
                strips.append(strip)
                if remainder is crop:
                    remainder = crop.copy()
                remainder[fill_poly_mask(remainder.shape[:2], poly.astype(np.int32))] = WHITE
        return strips, remainder

    _dump_n = 0

    def _debug_dump(self, crop: np.ndarray) -> None:
        """Write each seal crop as a PNG when RAPIDDOC_SEAL_OCR_DEBUG_DIR
        names a directory, or RAPIDDOC_SEAL_OCR_DEBUG is set (the
        directory is then ``rapiddoc_seal_debug`` under the system's
        temporary directory); the MINERU_ prefix works too."""
        import tempfile

        from ...pdfio.png import encode_png

        target = None
        for prefix in ("RAPIDDOC_", "MINERU_"):
            target = os.environ.get(f"{prefix}SEAL_OCR_DEBUG_DIR") or target
            if not target and os.environ.get(f"{prefix}SEAL_OCR_DEBUG"):
                target = os.path.join(tempfile.gettempdir(), "rapiddoc_seal_debug")
        if not target:
            return
        os.makedirs(target, exist_ok=True)
        with open(os.path.join(target, f"seal_{SealOCR._dump_n:04d}.png"), "wb") as f:
            f.write(encode_png(np.ascontiguousarray(crop)))
        SealOCR._dump_n += 1
