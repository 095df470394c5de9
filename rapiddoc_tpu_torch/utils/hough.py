"""The OpenCV filters that seal OCR's circle detection needs, in numpy.

``models/ocr/seal.py`` finds a round stamp with ``cv2.medianBlur`` and
``cv2.HoughCircles(HOUGH_GRADIENT)``. Each is replayed here to give what
OpenCV 5.0 computes:

- ``median_blur``: the exact median of each k x k window, the image
  edge repeated (OpenCV's border for k = 3 and 5).
- ``sobel3``: the 3x3 Sobel derivatives as int16, edge repeated.
- ``canny_from_derivatives``: ``cv2.Canny(dx, dy, low, high)`` with the L1
  norm: magnitude |dx| + |dy|, non-maximum suppression along the
  gradient's octant (tan 22.5 degrees in 15-bit fixed point, ties kept
  towards the right and the lower row), then hysteresis from pixels
  above ``high`` through 8-connected pixels above ``low``.
- ``hough_circles``: OpenCV's gradient method. Every edge pixel votes
  along its gradient, both ways, from ``min_radius`` to ``max_radius``
  on the 1/dp accumulator in 10-bit fixed point, stopping where the ray
  leaves the accumulator; centres are the accumulator's local maxima
  above ``acc_threshold`` (strict towards the left and the upper row);
  each centre's radius comes from the 10-bins-per-dp histogram of its
  distances to the edge pixels, scanned from the largest radius down in
  windows of 10 bins from each nonzero bin, the bin below a window
  skipped (as OpenCV's loop steps), the window whose count per radius is
  highest taken;
  circles are ordered by support, then radius, then x, then y, and a
  circle nearer than ``min_dist`` to one kept before it is dropped. All
  in OpenCV's float32 arithmetic.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage

_F = np.float32
_CANNY_SHIFT = 15
_TG22 = int(0.4142135623730950488016887242097 * (1 << _CANNY_SHIFT) + 0.5)
_HOUGH_SHIFT = 10
_BINS_PER_DR = 10


def median_blur(gray: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.medianBlur(gray, ksize)`` for a uint8 HxW image and ksize 3
    or 5."""
    if ksize not in (3, 5):
        raise ValueError("median_blur replays ksize 3 and 5")
    return ndimage.median_filter(gray, size=ksize, mode="nearest")


def sobel3(gray: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """``cv2.Sobel(gray, CV_16S, 1, 0, 3, borderType=BORDER_REPLICATE)``
    and its y counterpart."""
    p = np.pad(gray.astype(np.int32), 1, mode="edge")
    h, w = gray.shape
    rows = p[0:h] + 2 * p[1:h + 1] + p[2:h + 2]
    cols = p[:, 0:w] + 2 * p[:, 1:w + 1] + p[:, 2:w + 2]
    dx = rows[:, 2:w + 2] - rows[:, 0:w]
    dy = cols[2:h + 2] - cols[0:h]
    return dx.astype(np.int16), dy.astype(np.int16)


def canny_from_derivatives(dx: np.ndarray, dy: np.ndarray, low: float,
                           high: float) -> np.ndarray:
    """``cv2.Canny(dx, dy, low, high, L2gradient=False)``: uint8 0/255."""
    lo, hi = int(np.floor(low)), int(np.floor(high))
    if lo > hi:
        lo, hi = hi, lo
    xs = dx.astype(np.int64)
    ys = dy.astype(np.int64)
    mag = np.abs(xs) + np.abs(ys)
    h, w = mag.shape
    m = np.pad(mag, 1)  # zero magnitude around the image
    c = m[1:-1, 1:-1]
    ax = np.abs(xs)
    ay = np.abs(ys) << _CANNY_SHIFT
    tg22x = ax * _TG22
    tg67x = tg22x + (ax << (_CANNY_SHIFT + 1))
    horizontal = ay < tg22x
    vertical = ~horizontal & (ay > tg67x)
    diagonal = ~horizontal & ~vertical
    left, right = m[1:-1, :-2], m[1:-1, 2:]
    up, down = m[:-2, 1:-1], m[2:, 1:-1]
    # s = -1 where the signs differ: the previous row's x + 1 and the
    # next row's x - 1; else the previous row's x - 1 and the next's x + 1
    anti = (xs ^ ys) < 0
    prev_d = np.where(anti, m[:-2, 2:], m[:-2, :-2])
    next_d = np.where(anti, m[2:, :-2], m[2:, 2:])
    keep = (
        (horizontal & (c > left) & (c >= right))
        | (vertical & (c > up) & (c >= down))
        | (diagonal & (c > prev_d) & (c > next_d))
    )
    cand = (c > lo) & keep
    strong = cand & (c > hi)
    lab, n = ndimage.label(cand, structure=np.ones((3, 3), bool))
    if n == 0:
        return np.zeros((h, w), np.uint8)
    hit = np.zeros(n + 1, bool)
    hit[np.unique(lab[strong])] = True
    hit[0] = False
    return np.where(hit[lab], np.uint8(255), np.uint8(0))


def _accumulate(edges, dx, dy, min_r: int, max_r: int, idp):
    """The vote accumulator ((arows + 2) x (acols + 2) int32) and the edge
    points (x, y) that voted."""
    h, w = edges.shape
    acols = int(np.ceil(_F(w) * idp))
    arows = int(np.ceil(_F(h) * idp))
    accum = np.zeros((arows + 2) * (acols + 2), np.int64)
    py, px = np.nonzero(edges)
    vx = dx[py, px].astype(_F)
    vy = dy[py, px].astype(_F)
    mag = np.sqrt(vx * vx + vy * vy)
    ok = ((vx != 0) | (vy != 0)) & (mag >= _F(1))
    px, py, vx, vy, mag = px[ok], py[ok], vx[ok], vy[ok], mag[ok]
    one = _F(1 << _HOUGH_SHIFT)
    sx = np.rint(vx * idp * one / mag).astype(np.int64)
    sy = np.rint(vy * idp * one / mag).astype(np.int64)
    x0 = np.rint(px.astype(_F) * idp * one).astype(np.int64)
    y0 = np.rint(py.astype(_F) * idp * one).astype(np.int64)
    r = np.arange(min_r, max_r + 1, dtype=np.int64)
    chunk = max(1, (1 << 21) // len(r))  # points a step: bounded memory
    for lo in range(0, len(px), chunk):
        part = slice(lo, lo + chunk)
        for sign in (1, -1):
            x2 = (x0[part, None] + r[None] * (sign * sx[part])[:, None]) >> _HOUGH_SHIFT
            y2 = (y0[part, None] + r[None] * (sign * sy[part])[:, None]) >> _HOUGH_SHIFT
            inside = (x2 >= 0) & (x2 < acols) & (y2 >= 0) & (y2 < arows)
            # each ray stops at its first step outside
            inside = np.cumprod(inside, axis=1).astype(bool)
            accum += np.bincount((y2 * (acols + 2) + x2)[inside], minlength=accum.size)
    return accum.reshape(arows + 2, acols + 2), np.stack([px, py], 1)


def _centers(accum: np.ndarray, acc_threshold: int) -> np.ndarray:
    """Flat offsets of the local maxima, sorted by votes (then offset)."""
    a = accum
    c = a[1:-1, 1:-1]
    peak = ((c > acc_threshold) & (c > a[1:-1, :-2]) & (c >= a[1:-1, 2:])
            & (c > a[:-2, 1:-1]) & (c >= a[2:, 1:-1]))
    ys, xs = np.nonzero(peak)
    ofs = (ys + 1) * a.shape[1] + (xs + 1)
    votes = a.ravel()[ofs]
    return ofs[np.lexsort((ofs, -votes))]


def _radius(center, pts, min_r: int, max_r: int, dr, n_bins: int):
    """(radius, support) of OpenCV's histogram estimate for one centre."""
    ddx = center[0] - pts[:, 0].astype(_F)
    ddy = center[1] - pts[:, 1].astype(_F)
    r2 = ddx * ddx + ddy * ddy
    r2 = r2[(_F(min_r) * _F(min_r) <= r2) & (r2 <= _F(max_r) * _F(max_r))]
    if not len(r2):
        return _F(0), 0
    b = np.rint((np.sqrt(r2) - _F(min_r)) / dr * _F(_BINS_PER_DR)).astype(np.int64)
    bins = np.bincount(np.clip(b, 0, n_bins - 1), minlength=n_bins)
    best_r, max_count = _F(0), 0
    j = n_bins - 1
    while j > 0:
        if bins[j]:
            up = j
            count = 0
            while j > up - _BINS_PER_DR and j >= 0:
                count += int(bins[j])
                j -= 1
            r_cur = _F(_F(up + j) / _F(2)) / _F(_BINS_PER_DR) * dr + _F(min_r)
            if (_F(count) * best_r >= _F(max_count) * r_cur
                    or (best_r < np.finfo(np.float32).eps and count >= max_count)):
                best_r, max_count = r_cur, count
        # the bin just below a window is skipped: the next window starts
        # two below its last bin
        j -= 1
    return best_r, max_count


def hough_circles(gray: np.ndarray, dp: float, min_dist: float, param1: float,
                  param2: float, min_radius: int, max_radius: int) -> np.ndarray | None:
    """``cv2.HoughCircles(gray, HOUGH_GRADIENT, dp, min_dist,
    param1=param1, param2=param2, minRadius=min_radius,
    maxRadius=max_radius)`` for a uint8 HxW image with max_radius > 0:
    (1, n, 3) float32 (x, y, r), or None."""
    dp = max(_F(dp), _F(1))
    idp = _F(1) / dp
    min_r = max(0, int(min_radius))
    max_r = int(max_radius)
    if max_r <= min_r:
        max_r = min_r + 2
    canny_hi = int(np.rint(param1))
    acc_threshold = int(np.rint(param2))
    dx, dy = sobel3(gray)
    edges = canny_from_derivatives(dx, dy, max(1, canny_hi // 2), canny_hi)
    accum, pts = _accumulate(edges, dx, dy, min_r, max_r, idp)
    if not len(pts):
        return None
    centers = _centers(accum, acc_threshold)
    acols = accum.shape[1]
    n_bins = int(np.rint(_F(max_r - min_r) / dp * _F(_BINS_PER_DR)))
    found = []
    for ofs in centers:
        y, x = divmod(int(ofs), acols)
        center = ((_F(x) + _F(0.5)) * dp, (_F(y) + _F(0.5)) * dp)
        r, support = _radius(center, pts, min_r, max_r, dp, n_bins)
        if support > acc_threshold:
            found.append((support, r, center[0], center[1]))
    if not found:
        return None
    found.sort(key=lambda c: (-c[0], -c[1], c[2], c[3]))
    min_d2 = _F(min_dist) * _F(min_dist)
    kept: list[tuple] = []
    for _, r, cx, cy in found:
        if all((cx - kx) * (cx - kx) + (cy - ky) * (cy - ky) >= min_d2 for kx, ky, _ in kept):
            kept.append((cx, cy, r))
    return np.asarray([kept], np.float32)
