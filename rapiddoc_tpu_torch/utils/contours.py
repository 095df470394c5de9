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


def _trace(img: np.ndarray, y0: int, x0: int) -> list[tuple[int, int]]:
    """OpenCV's icvFetchContour for an outer border starting at (x0, y0)
    of a framed 0/1 image, CHAIN_APPROX_SIMPLE, in framed coordinates."""

    def nz(y: int, x: int, s: int) -> bool:
        dx, dy = _DELTAS[s & 7]
        return img[y + dy, x + dx] != 0

    s = s_end = 4
    while True:
        s = (s - 1) & 7
        if nz(y0, x0, s) or s == s_end:
            break
    if s == s_end and not nz(y0, x0, s):
        return [(x0, y0)]  # a single pixel
    i1 = (y0 + _DELTAS[s][1], x0 + _DELTAS[s][0])
    y3, x3 = y0, x0
    prev_s = s ^ 4
    pts: list[tuple[int, int]] = []
    px, py = x0, y0
    while True:
        while True:
            s += 1
            if nz(y3, x3, s):
                break
        s &= 7
        if s != prev_s:
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


def find_contours_external_simple(mask: np.ndarray) -> list[np.ndarray]:
    """``cv2.findContours(mask, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)[0]``
    for a 2-D mask (nonzero is foreground): a list of (N, 1, 2) int32
    point arrays (x, y)."""
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
        pts = np.asarray(_trace(img, y0, x0), np.int32) - 1
        out.append(pts.reshape(-1, 1, 2))
    return out


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
