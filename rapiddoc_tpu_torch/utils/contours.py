"""The OpenCV contour functions that layout masks need, in numpy.

``mask_to_polygon`` (``models/layout/engine.py``) turns each instance
mask of the layout model into a polygon with ``cv2.findContours(
RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)``, ``contourArea``, ``arcLength``,
``approxPolyDP`` and ``boundingRect``. Each is replayed here to give
OpenCV's output and order:

- ``find_contours_external_simple``: Suzuki-Abe border following on the
  mask padded with a zero frame, OpenCV's chain codes and its search
  order (clockwise from the left neighbour for the first step, then
  counter-clockwise from the last direction), one outer border per
  8-connected component that touches the background around the frame
  (a component inside another's hole has no external contour), started
  at the component's first pixel in raster order; a point is kept where
  the chain turns (CHAIN_APPROX_SIMPLE). The list runs from the last
  contour found to the first, as OpenCV returns it.
- ``contour_area`` (the shoelace formula, unsigned), ``arc_length``
  (closed, float32 segments), ``bounding_rect`` (inclusive pixel
  extents) and ``approx_poly_dp`` (OpenCV 5's closed Douglas-Peucker,
  which measures a point's distance to a range's segment, with its
  clean-up pass).
"""
from __future__ import annotations

import math

import numpy as np
from scipy import ndimage

# OpenCV's chain code deltas (x, y), direction 0 pointing right and
# the codes turning counter-clockwise on screen
_DELTAS = ((1, 0), (1, -1), (0, -1), (-1, -1), (-1, 0), (-1, 1), (0, 1), (1, 1))


def _external_components(mask: np.ndarray) -> tuple[np.ndarray, list[int]]:
    """8-connected foreground labels of the framed mask, and the labels
    whose outer border touches the background component of the frame."""
    fg, _ = ndimage.label(mask, structure=np.ones((3, 3), bool))
    bg, _ = ndimage.label(mask == 0)  # 4-connected background
    outside = bg == bg[0, 0]  # the frame is background
    touch = ndimage.binary_dilation(outside, structure=np.ones((3, 3), bool))
    external = np.unique(fg[touch & (fg > 0)])
    return fg, [int(v) for v in external]


_NBD = 2  # the mark of a traced border pixel (RETR_LIST / RETR_EXTERNAL)


def _trace(img: np.ndarray, y0: int, x0: int, hole: bool = False,
           simple: bool = True) -> list[tuple[int, int]]:
    """OpenCV's icvFetchContour for a border starting at (x0, y0) of a
    framed image (0 background), in framed coordinates: an outer border
    searches clockwise from the left neighbour for its first step, a hole
    border from the right one. ``simple`` keeps a point where the chain
    turns (CHAIN_APPROX_SIMPLE), else every point (CHAIN_APPROX_NONE).
    Marks the traced pixels in ``img`` as OpenCV does, when ``img`` is
    int8: -126 where the search crossed the right neighbour, else 2 in
    place of 1."""
    marks = img.dtype == np.int8

    def nz(y: int, x: int, s: int) -> bool:
        dx, dy = _DELTAS[s & 7]
        return img[y + dy, x + dx] != 0

    s = s_end = 0 if hole else 4
    while True:
        s = (s - 1) & 7
        if nz(y0, x0, s) or s == s_end:
            break
    if s == s_end and not nz(y0, x0, s):
        if marks:
            img[y0, x0] = _NBD - 128
        return [(x0, y0)]  # a single pixel
    i1 = (y0 + _DELTAS[s][1], x0 + _DELTAS[s][0])
    y3, x3 = y0, x0
    prev_s = s ^ 4
    pts: list[tuple[int, int]] = []
    px, py = x0, y0
    while True:
        s_end = s
        while True:
            s += 1
            if nz(y3, x3, s):
                break
        s &= 7
        if marks:
            if 1 <= s <= s_end:
                img[y3, x3] = _NBD - 128
            elif img[y3, x3] == 1:
                img[y3, x3] = _NBD
        if s != prev_s or not simple:
            pts.append((px, py))
            prev_s = s
        px += _DELTAS[s][0]
        py += _DELTAS[s][1]
        y4, x4 = y3 + _DELTAS[s][1], x3 + _DELTAS[s][0]
        if (y4, x4) == (y0, x0) and (y3, x3) == i1:
            break
        y3, x3 = y4, x4
        s = (s + 4) & 7
    return pts


def find_contours_external_simple(mask: np.ndarray, simple: bool = True) -> list[np.ndarray]:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``
    (``simple=False``: CHAIN_APPROX_NONE) for a 2-D mask (nonzero is
    foreground): a list of (N, 1, 2) int32 point arrays (x, y)."""
    img = np.pad((np.asarray(mask) != 0).astype(np.uint8), 1)
    fg, external = _external_components(img)
    if not external:
        return []
    # the first pixel in raster order of each external component
    flat = fg.ravel()
    starts = []
    for lab in external:
        first = int(np.flatnonzero(flat == lab)[0])
        starts.append(divmod(first, img.shape[1]))
    starts.sort()
    out = []
    for y0, x0 in reversed(starts):
        pts = np.asarray(_trace(img, y0, x0, simple=simple), np.int32) - 1
        out.append(pts.reshape(-1, 1, 2))
    return out


def find_contours_list(mask: np.ndarray, simple: bool = True) -> list[tuple[np.ndarray, bool]]:
    """``cv2.findContours(mask, RETR_LIST, CHAIN_APPROX_SIMPLE)[0]``
    (``simple=False``: CHAIN_APPROX_NONE) for a 2-D mask, each contour
    with whether it is a hole border: OpenCV's raster scan of the framed
    image, an outer border started where a 1 follows a 0, a hole border
    at the pixel before a 0 that follows a pixel above 0 (a pixel marked
    while a border crossed its right neighbour starts none), each traced
    and marked in turn; the list runs from the last border found to the
    first. Points are (N, 1, 2) int32 (x, y)."""
    img = np.pad((np.asarray(mask) != 0).astype(np.int8), 1)
    h, w = img.shape
    found = []
    for y in range(1, h - 1):
        row = img[y]
        x, prev = 1, 0
        while x < w - 1:
            # the next pixel that differs from prev
            rest = np.flatnonzero(row[x:w - 1] != prev)
            if not len(rest):
                break
            x += int(rest[0])
            p = int(row[x])
            if prev == 0 and p == 1:
                found.append((_trace(img, y, x, simple=simple), False))
            elif p == 0 and prev >= 1:
                found.append((_trace(img, y, x - 1, hole=True, simple=simple), True))
            prev = int(row[x])  # as the trace left it
            x += 1
    return [(np.asarray(pts, np.int32).reshape(-1, 1, 2) - 1, hole)
            for pts, hole in reversed(found)]


def contour_area(contour: np.ndarray) -> float:
    """``cv2.contourArea`` (unsigned)."""
    p = np.asarray(contour, np.float64).reshape(-1, 2)
    if len(p) < 3:
        return 0.0
    x, y = p[:, 0], p[:, 1]
    a = 0.0
    xp, yp = x[-1], y[-1]
    for xi, yi in zip(x, y):
        a += xp * yi - xi * yp
        xp, yp = xi, yi
    return abs(a * 0.5)


def arc_length(contour: np.ndarray) -> float:
    """``cv2.arcLength(contour, True)``: the closed perimeter, each
    segment's length in float32 as OpenCV computes it."""
    p = np.asarray(contour, np.float32).reshape(-1, 2)
    if len(p) < 2:
        return 0.0
    seg = np.diff(np.concatenate([p[-1:], p]), axis=0)
    perimeter = 0.0
    for dx, dy in seg:
        perimeter += float(np.sqrt(np.float32(dx * dx + dy * dy)))
    return perimeter


def bounding_rect(contour: np.ndarray) -> tuple[int, int, int, int]:
    """``cv2.boundingRect`` of integer points: (x, y, w, h), inclusive."""
    p = np.asarray(contour).reshape(-1, 2)
    x0, y0 = p.min(axis=0)
    x1, y1 = p.max(axis=0)
    return int(x0), int(y0), int(x1 - x0 + 1), int(y1 - y0 + 1)


def approx_poly_dp(contour: np.ndarray, epsilon: float) -> np.ndarray:
    """``cv2.approxPolyDP(contour, epsilon, closed=True)`` of integer
    points, as OpenCV 5's approxPolyDP_ runs it (three passes for the
    farthest pair, its stack of ranges split on the point farthest from
    the range's segment, then its clean-up of points on near-straight
    runs); (M, 1, 2) int32."""
    src = [tuple(int(v) for v in p) for p in np.asarray(contour).reshape(-1, 2)]
    count = len(src)
    if count == 0:
        return np.zeros((0, 1, 2), np.int32)
    eps = float(epsilon) ** 2
    dst: list[tuple[int, int]] = []
    stack: list[tuple[int, int]] = []
    # 1. an approximately farthest pair
    pos, far = 0, 0
    le_eps = False
    start = src[0]
    for _ in range(3):
        pos = (pos + far) % count
        start = src[pos]
        max_dist = 0
        for j in range(1, count):
            pt = src[(pos + j) % count]
            dist = (pt[0] - start[0]) ** 2 + (pt[1] - start[1]) ** 2
            if dist > max_dist:
                max_dist, far = dist, j
        le_eps = max_dist <= eps
    if le_eps:
        dst.append(start)
    else:
        a = pos % count
        b = (far + a) % count
        stack += [(b, a), (a, b)]
    # 2. split each range on its point farthest from the chord, measured
    # to the segment (a point past an end is as far as that end; a closed
    # range measures to its one end), squared
    while stack:
        s0, s1 = stack.pop()
        end_pt = src[s1]
        start_pt = src[s0]
        i = (s0 + 1) % count
        if i != s1:
            dx, dy = end_pt[0] - start_pt[0], end_pt[1] - start_pt[1]
            length2 = dx * dx + dy * dy
            max_dist, split = 0.0, s0
            while i != s1:
                pt = src[i]
                px, py = pt[0] - start_pt[0], pt[1] - start_pt[1]
                along = px * dx + py * dy
                if along <= 0 or length2 == 0:
                    dist = float(px * px + py * py)
                elif along >= length2:
                    dist = float((pt[0] - end_pt[0]) ** 2 + (pt[1] - end_pt[1]) ** 2)
                else:
                    cross = px * dy - py * dx
                    dist = cross * cross / length2
                if dist > max_dist:
                    max_dist, split = dist, i
                i = (i + 1) % count
            le_eps = max_dist <= eps
        else:
            le_eps = True
        if le_eps:
            dst.append(start_pt)
        else:
            stack += [(split, s1), (s0, split)]
    # 3. drop points on near-straight runs
    count = new_count = len(dst)
    rpos = count - 1
    start_pt = dst[rpos]
    rpos = (rpos + 1) % count
    wpos = rpos
    pt = dst[rpos]
    rpos = (rpos + 1) % count
    i = 0
    while i < count and new_count > 2:
        end_pt = dst[rpos]
        rpos = (rpos + 1) % count
        dx, dy = end_pt[0] - start_pt[0], end_pt[1] - start_pt[1]
        dist = abs(float((pt[0] - start_pt[0]) * dy - (pt[1] - start_pt[1]) * dx))
        inner = (pt[0] - start_pt[0]) * (end_pt[0] - pt[0]) + (pt[1] - start_pt[1]) * (end_pt[1] - pt[1])
        if dist * dist <= 0.5 * eps * (dx * dx + dy * dy) and dx != 0 and dy != 0 and inner >= 0:
            new_count -= 1
            dst[wpos] = start_pt = end_pt
            wpos = (wpos + 1) % count
            pt = dst[rpos]
            rpos = (rpos + 1) % count
            i += 2
            continue
        dst[wpos] = start_pt = pt
        wpos = (wpos + 1) % count
        pt = end_pt
        i += 1
    return np.asarray(dst[:new_count], np.int32).reshape(-1, 1, 2)


def fit_ellipse(points: np.ndarray) -> tuple[tuple[float, float], tuple[float, float], float]:
    """``cv2.fitEllipse`` of six or more integer points: ((cx, cy), (w, h),
    angle), OpenCV's ``fitEllipseNoDirect``. The points are centred on
    their float32 mean and scaled so their mean L1 spread is 100; a
    least-squares fit of the five-parameter conic (OpenCV's SVD solve)
    gives the centre, a second fit with the centre fixed gives the axes
    and the angle. The least-squares solves are LAPACK's, not OpenCV's
    Jacobi SVD, so the floats can differ from OpenCV's in their last
    bits (tests/test_torch_seal.py states the tolerance). Degenerate
    point sets (OpenCV nudges the points and truncates singular values)
    are not replayed: seal OCR fits borders of 20 or more points."""
    p = np.asarray(points, np.float32).reshape(-1, 2)
    n = len(p)
    if n < 6:
        raise ValueError("fit_ellipse replays six or more points")
    cx = np.float32(0)
    cy = np.float32(0)
    for x, y in p:  # OpenCV sums the float32 points in order
        cx += x
        cy += y
    cx /= np.float32(n)
    cy /= np.float32(n)
    d = p - np.array([cx, cy], np.float32)
    s = 0.0
    for x, y in d:
        s += abs(float(x)) + abs(float(y))
    eps32 = float(np.finfo(np.float32).eps)
    scale = 100.0 / (s if s > eps32 else eps32)

    px = d[:, 0].astype(np.float64) * scale
    py = d[:, 1].astype(np.float64) * scale
    a = np.stack([-px * px, -py * py, -px * py, px, py], 1)
    gfp = np.linalg.lstsq(a, np.full(n, 10000.0), rcond=None)[0]
    m = np.array([[2 * gfp[0], gfp[2]], [gfp[2], 2 * gfp[1]]])
    rp = np.linalg.lstsq(m, gfp[3:5], rcond=None)[0]
    a = np.stack([(px - rp[0]) ** 2, (py - rp[1]) ** 2, (px - rp[0]) * (py - rp[1])], 1)
    gfp = np.linalg.lstsq(a, np.ones(n), rcond=None)[0]
    angle = -0.5 * math.atan2(gfp[2], gfp[1] - gfp[0])
    if abs(gfp[2]) > 1e-8:
        t = gfp[2] / math.sin(-2.0 * angle)
    else:
        t = gfp[1] - gfp[0]
    r0 = abs(gfp[0] + gfp[1] - t)
    if r0 > 1e-8:
        r0 = math.sqrt(2.0 / r0)
    r1 = abs(gfp[0] + gfp[1] + t)
    if r1 > 1e-8:
        r1 = math.sqrt(2.0 / r1)
    ecx = float(np.float32(rp[0] / scale) + cx)
    ecy = float(np.float32(rp[1] / scale) + cy)
    w = float(np.float32(r0 * 2 / scale))
    h = float(np.float32(r1 * 2 / scale))
    deg = float(np.float32(angle * 180 / math.pi))
    if w > h:
        w, h = h, w
        deg = float(np.float32(90 + angle * 180 / math.pi))
    if deg < -180:
        deg += 360
    if deg > 360:
        deg -= 360
    return (ecx, ecy), (w, h), deg
