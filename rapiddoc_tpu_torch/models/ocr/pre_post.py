"""Host-side pre/post-processing for OCR det & rec, without OpenCV.

Port of ``rapiddoc_tpu/models/ocr/pre_post.py``. The JAX package calls
OpenCV for resizing, grey conversion, polygon filling, dilation, contour
extraction and minimum-area rectangles. Here each of those is numpy or
scipy, written to give OpenCV's results:

- ``resize_linear`` reproduces ``cv2.resize(..., INTER_LINEAR)`` on
  uint8 images bit for bit: 11-bit fixed-point weights per axis, the
  same rounding and edge taps, plus OpenCV's switch to a 2x2 box filter for an exact
  2x downscale.
- ``to_luma`` reproduces ``cvtColor(RGB2GRAY)``'s 15-bit fixed point.
- ``fill_poly_mask`` reproduces ``cv2.fillPoly`` (8-connected outline
  plus scanline fill in 16-bit fixed point), which box scoring averages
  over.
- ``find_contour_rects`` stands in for ``findContours(RETR_LIST,
  CHAIN_APPROX_SIMPLE)`` + ``minAreaRect``: a contour's minimum-area
  rectangle is that of its convex hull, and the hull of an outer border
  is the hull of its 8-connected component, the hull of a hole's border
  that of the hole grown by its 4-neighbours. Components and holes come
  from ``scipy.ndimage`` labelling; rectangles from OpenCV's rotating
  calipers, replayed in its float32 arithmetic.
- ``perspective_transform`` and ``perspective_points`` reproduce
  ``getPerspectiveTransform`` and ``perspectiveTransform`` (float32
  points), which map word boxes back onto a line's quad.
- ``resize_area`` reproduces INTER_AREA, enlarging axes included.
- ``resize_lanczos4`` reproduces INTER_LANCZOS4 (the table
  classifier's), bit for bit.
- ``warp_perspective``, ``warp_affine`` (with ``rotation_matrix_2d``),
  ``remap_linear`` and ``warp_polar_linear`` reproduce OpenCV 5.0's
  linear warps (``_blend``, with a constant border), for crops and seal
  OCR; ``OpenCVError`` stands for ``cv2.error`` where OpenCV raises.
- ``db_postprocess_poly`` (curved text, seal OCR) traces contours with
  their points (``utils/contours.find_contours_list``), where the quad
  postprocess only needs their hulls.

The DB postprocess, the CTC decoder and the other helpers are the JAX
package's code, unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
from scipy import ndimage

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


# ------------------------------------------------------------ cv2 stand-ins

_RESIZE_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS


def _linear_taps(src: int, dst: int, area: bool = False):
    """OpenCV's per-axis source index pairs and 11-bit weights; ``area``:
    the coefficients INTER_AREA takes when it enlarges an axis (source
    index floor(d * scale), weight of the second tap the fractional part
    of (d + 1) - (index + 1) / scale, or 0 where that is not positive)."""
    inv_scale = dst / src
    scale = 1.0 / inv_scale
    d = np.arange(dst)
    if area:
        i0 = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (i0 + 1) * inv_scale).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        i0 = np.floor(f).astype(np.int64)
        f = (f - i0.astype(np.float32)).astype(np.float32)
    # past an edge both taps read the edge pixel, with the weights kept
    i1 = np.clip(i0 + 1, 0, src - 1)
    i0 = np.clip(i0, 0, src - 1)
    one = np.float32(1 << _RESIZE_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return i0, i1, w0, w1


def resize_linear(img: np.ndarray, out_w: int, out_h: int, area: bool = False) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h))`` (INTER_LINEAR) for uint8 HW or
    HWC images, bit for bit; ``area``: OpenCV's INTER_AREA where it
    enlarges an axis, the same blend over ``_linear_taps(area=True)``."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    if w == 2 * out_w and h == 2 * out_h and not area:
        # OpenCV runs an exact 2x downscale as the 2x2 box filter
        s = img.astype(np.int32)
        q = s[0::2, 0::2] + s[0::2, 1::2] + s[1::2, 0::2] + s[1::2, 1::2]
        return ((q + 2) >> 2).astype(np.uint8)
    x0, x1, a0, a1 = _linear_taps(w, out_w, area)
    y0, y1, b0, b1 = _linear_taps(h, out_h, area)
    # int32 holds every step: a tap sum is at most 255 << 11, and a row
    # weight (at most 1 << 11) times a tap sum >> 4 stays under 1 << 27
    extra = (None,) * (img.ndim - 2)
    cols = (slice(None),) + extra
    hor = img[:, x0].astype(np.int32) * a0.astype(np.int32)[cols]
    hor += img[:, x1].astype(np.int32) * a1.astype(np.int32)[cols]
    hor >>= 4
    rows = (slice(None), None) + extra
    out = (b0.astype(np.int32)[rows] * hor[y0]) >> 16
    out += (b1.astype(np.int32)[rows] * hor[y1]) >> 16
    out += 2
    out >>= 2
    return out.astype(np.uint8)


def _area_taps(src: int, dst: int, scale: float):
    """OpenCV's computeResizeAreaTab for one axis: for each destination
    index its source indices and float32 weights, padded with weight 0
    to the longest list."""
    taps: list[list[tuple[int, float]]] = []
    for d in range(dst):
        fs1 = d * scale
        fs2 = fs1 + scale
        cell = min(scale, src - fs1)
        s1, s2 = math.ceil(fs1), math.floor(fs2)
        s2 = min(s2, src - 1)
        s1 = min(s1, s2)
        row = []
        if s1 - fs1 > 1e-3:
            row.append((s1 - 1, (s1 - fs1) / cell))
        row += [(s, 1.0 / cell) for s in range(s1, s2)]
        if fs2 - s2 > 1e-3:
            row.append((s2, min(min(fs2 - s2, 1.0), cell) / cell))
        taps.append(row)
    k = max(len(t) for t in taps)
    idx = np.zeros((dst, k), np.int64)
    wts = np.zeros((dst, k), np.float32)
    for d, row in enumerate(taps):
        for j, (s, a) in enumerate(row):
            idx[d, j], wts[d, j] = s, a
    return idx, wts


def resize_area(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_AREA)`` for
    uint8 HW or HWC images, bit for bit: an exact 2x as the rounded 2x2
    box, another integer factor as OpenCV's float32 box mean, any other
    factor as its float32 area weights, summed in its order (along x per
    source row, then the rows); where an axis is enlarged, OpenCV's
    linear path with area coefficients (``resize_linear(area=True)``)."""
    h, w = img.shape[:2]
    scale_x, scale_y = w / out_w, h / out_h
    if scale_x < 1 or scale_y < 1:
        return resize_linear(img, out_w, out_h, area=True)
    ix, iy = round(scale_x), round(scale_y)
    src = img.reshape(h, w, -1)
    if abs(scale_x - ix) < 2.220446049250313e-16 and abs(scale_y - iy) < 2.220446049250313e-16:
        s = src.reshape(out_h, iy, out_w, ix, src.shape[2]).astype(np.int32).sum(axis=(1, 3))
        if ix == iy == 2:
            out = (s + 2) >> 2
        else:
            out = np.rint(s.astype(np.float32) * np.float32(1.0 / (ix * iy)))
        return out.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])
    xi, xw = _area_taps(w, out_w, scale_x)
    yi, yw = _area_taps(h, out_h, scale_y)
    s = src.astype(np.float32)
    buf = s[:, xi[:, 0]] * xw[None, :, 0, None]
    for j in range(1, xi.shape[1]):
        buf += s[:, xi[:, j]] * xw[None, :, j, None]
    acc = yw[:, 0, None, None] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        acc += yw[:, j, None, None] * buf[yi[:, j]]
    out = np.clip(np.rint(acc), 0, 255).astype(np.uint8)
    return out.reshape((out_h, out_w) + img.shape[2:])


def _cubic_positions(src: int, dst: int, native: bool):
    """Per-axis source taps (replicated borders) and fractional offsets
    of INTER_CUBIC: dst pixel centre d maps to (d + 0.5) * src / dst -
    0.5, in float64 for IPP and rounded to float32 before the floor for
    OpenCV's own code."""
    pos = (np.arange(dst) + 0.5) * (1.0 / (dst / src) if native else src / dst) - 0.5
    if native:
        pos = pos.astype(np.float32)
    base = np.floor(pos)
    idx = np.clip(base.astype(np.int64)[:, None] + np.arange(-1, 3)[None], 0, src - 1)
    return idx, pos - base


def _cubic_weights_fixed(t: np.ndarray) -> np.ndarray:
    """OpenCV's interpolateCubic (A = -0.75) on the float32 offset, in
    11-bit fixed point."""
    f32 = np.float32
    x = t.astype(f32)
    a, one = f32(-0.75), f32(1)
    c0 = ((a * (x + one) - f32(5) * a) * (x + one) + f32(8) * a) * (x + one) - f32(4) * a
    c1 = ((a + f32(2)) * x - (a + f32(3))) * x * x + one
    c2 = ((a + f32(2)) * (one - x) - (a + f32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.rint(np.stack([c0, c1, c2, c3], 1) * f32(1 << _RESIZE_BITS)).astype(np.int64)


def _cubic_weights_float(t: np.ndarray) -> np.ndarray:
    """The cubic convolution weights (A = -0.75) as float32 polynomials
    of the float32 offset."""
    f32 = np.float32
    x = t.astype(f32)
    x2 = x * x
    x3 = x2 * x
    return np.stack([
        f32(-0.75) * x3 + f32(1.5) * x2 - f32(0.75) * x,
        f32(1.25) * x3 - f32(2.25) * x2 + f32(1),
        f32(-1.25) * x3 + f32(1.5) * x2 + f32(0.75) * x,
        f32(0.75) * x3 - f32(0.75) * x2,
    ], 1).astype(f32)


def _cubic_sum(taps: list[np.ndarray], weights: list[np.ndarray]) -> np.ndarray:
    """(t0 w0 + t1 w1) + (t2 w2 + t3 w3) in float32."""
    p = [t * w for t, w in zip(taps, weights)]
    return (p[0] + p[1]) + (p[2] + p[3])


def resize_cubic(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_CUBIC)`` for
    uint8 HW or HWC images, as OpenCV 5 on x86 computes it.

    When both source sides are at least 4 pixels, OpenCV hands the
    resize to Intel IPP, which computes in float32: rows first, then
    columns, each output the pairwise sum of four taps times float32
    cubic weights, rounded to nearest even. That is replayed here, bit
    for bit except where a pixel's exact value lies within float32
    rounding (1e-4) of a tie at .5 (about 1 pixel in 10^5 on random
    noise; none on the layout's 1056x1389 -> 640x640 page case, 2e-4 of
    the pixels on a 2.17x up-scale of page content): there IPP's own
    float32 order of operations, which is not documented, decides the
    side, and this replay may take the other, one away. A smaller source takes OpenCV's own code:
    11-bit weights, integer rows, and a column pass whose first
    multiple of 8 values per row is summed in float32 (its SSE path)
    and the rest in 22-bit fixed point, bit for bit."""
    h, w = img.shape[:2]
    if (h, w) == (out_h, out_w):
        return img.copy()
    native = min(h, w) < 4
    xi, tx = _cubic_positions(w, out_w, native)
    yi, ty = _cubic_positions(h, out_h, native)
    extra = (None,) * (img.ndim - 2)
    cols = (slice(None),) + extra
    rows = (slice(None), None) + extra
    if not native:
        wx, wy = _cubic_weights_float(tx), _cubic_weights_float(ty)
        # the row pass gathers whole columns: on the transposed image they
        # are contiguous rows (the same products and sums, twice as fast)
        st = np.ascontiguousarray(np.swapaxes(img, 0, 1))
        hor = _cubic_sum([st[xi[:, k]].astype(np.float32) for k in range(4)],
                         [wx[:, k][rows] for k in range(4)])
        hor = np.ascontiguousarray(np.swapaxes(hor, 0, 1))
        out = _cubic_sum([hor[yi[:, k]] for k in range(4)],
                         [wy[:, k][rows] for k in range(4)])
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    wx, wy = _cubic_weights_fixed(tx), _cubic_weights_fixed(ty)
    s = img.astype(np.int64)
    hor = sum(s[:, xi[:, k]] * wx[:, k][cols] for k in range(4))
    taps = [hor[yi[:, k]].reshape(out_h, -1) for k in range(4)]
    fixed = sum(t * wy[:, k, None] for k, t in enumerate(taps))
    out = np.clip((fixed + (1 << 21)) >> 22, 0, 255)
    vec = taps[0].shape[1] // 8 * 8
    if vec:
        bf = wy.astype(np.float32) * np.float32(1.0 / (1 << 22))
        acc = taps[3][:, :vec].astype(np.float32) * bf[:, 3, None]
        for k in (2, 1, 0):
            acc = taps[k][:, :vec].astype(np.float32) * bf[:, k, None] + acc
        out[:, :vec] = np.clip(np.rint(acc), 0, 255)
    return out.astype(np.uint8).reshape((out_h, out_w) + img.shape[2:])


_S45 = 0.70710678118654752440084436210485
# OpenCV's interpolateLanczos4: (sin, cos) factors of each of the 8 taps
_LANCZOS_CS = ((1, 0), (-_S45, -_S45), (0, 1), (_S45, -_S45), (-1, 0), (_S45, _S45),
               (0, -1), (-_S45, _S45))


def _lanczos4_taps(src: int, dst: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-axis source taps (replicated borders) and 11-bit weights of
    INTER_LANCZOS4: the float32 offset of (d + 0.5) * src / dst - 0.5,
    OpenCV's eight sin/cos coefficients in double rounded to float32,
    summed and normalised in float32, then rounded to short."""
    f32 = np.float32
    fx = ((np.arange(dst) + 0.5) * (1.0 / (dst / src)) - 0.5).astype(f32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx.astype(f32)).astype(f32)
    t = (fx + f32(3)).astype(f32)
    y0 = -t.astype(np.float64) * math.pi * 0.25
    s0 = np.array([math.sin(v) for v in y0])
    c0 = np.array([math.cos(v) for v in y0])
    coeffs = np.empty((dst, 8), f32)
    total = np.zeros(dst, f32)
    for i, (cs, cc) in enumerate(_LANCZOS_CS):
        yi = (t - f32(i)).astype(f32)
        y = -yi.astype(np.float64) * math.pi * 0.25
        with np.errstate(divide="ignore", invalid="ignore"):
            c = ((cs * s0 + cc * c0) / (y * y)).astype(f32)
        coeffs[:, i] = np.where(np.abs(yi) >= f32(1e-6), c, f32(1e30))
        total = (total + coeffs[:, i]).astype(f32)
    coeffs = (coeffs * (f32(1) / total)[:, None]).astype(f32)
    weights = np.clip(np.rint(coeffs * f32(1 << _RESIZE_BITS)), -32768, 32767).astype(np.int64)
    idx = np.clip(sx[:, None] - 3 + np.arange(8)[None], 0, src - 1)
    return idx, weights


def resize_lanczos4(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """``cv2.resize(img, (out_w, out_h), interpolation=INTER_LANCZOS4)``
    for uint8 HW or HWC images, bit for bit. IPP does not take this
    interpolation over, so it is OpenCV's own code: 11-bit weights per
    axis, integer rows, columns summed in 22-bit fixed point and rounded
    with a half added before the shift."""
    xi, wx = _lanczos4_taps(img.shape[1], out_w)
    yi, wy = _lanczos4_taps(img.shape[0], out_h)
    extra = (None,) * (img.ndim - 2)
    cols = (slice(None),) + extra
    rows = (slice(None), None) + extra
    s = img.astype(np.int64)
    hor = sum(s[:, xi[:, k]] * wx[:, k][cols] for k in range(8))
    out = sum(hor[yi[:, k]] * wy[:, k][rows] for k in range(8))
    return np.clip((out + (1 << 21)) >> 22, 0, 255).astype(np.uint8)


def rgb_to_gray(img: np.ndarray) -> np.ndarray:
    """``cvtColor(RGB2GRAY)`` for uint8: BT.601 weights in 15-bit fixed
    point, as OpenCV computes them."""
    s = img.astype(np.int32)
    y = s[..., 0] * 9798 + s[..., 1] * 19235 + s[..., 2] * 3735 + (1 << 14)
    return (y >> 15).astype(np.uint8)


def _dilate_2x2(seg: np.ndarray) -> np.ndarray:
    """``cv2.dilate`` with a 2x2 kernel of ones (anchor at (1, 1))."""
    out = seg.copy()
    out[1:] |= seg[:-1]
    out[:, 1:] |= seg[:, :-1]
    out[1:, 1:] |= seg[:-1, :-1]
    return out


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on integer endpoints; None when the segment
    misses the image."""
    right, bottom = w - 1, h - 1

    def code(x, y):
        return (x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int((a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int((a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int((a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int((a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line_pixels(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """Pixels of OpenCV's 8-connected line (LineIterator, left to right)."""
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return np.zeros((0,), np.int64), np.zeros((0,), np.int64)
        x1, y1, x2, y2 = clipped
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    if dy > dx:  # y is the major axis
        major, minor = dy, dx
        maj, mnr = (0, sy), (1, 0)
    else:
        major, minor = dx, dy
        maj, mnr = (1, 0), (0, sy)
    # err after k steps follows Bresenham; the minor step happens when err < 0
    n = major + 1
    xs = np.empty(n, np.int64)
    ys = np.empty(n, np.int64)
    err = major - 2 * minor
    x, y = x1, y1
    for i in range(n):
        xs[i], ys[i] = x, y
        if err < 0:
            err += 2 * major - 2 * minor
            x += maj[0] + mnr[0]
            y += maj[1] + mnr[1]
        else:
            err -= 2 * minor
            x += maj[0]
            y += maj[1]
    return xs, ys


_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def fill_poly_mask(shape: tuple[int, int], pts: np.ndarray) -> np.ndarray:
    """``cv2.fillPoly(zeros(shape, uint8), [pts], 1)`` for one int32
    polygon, as a bool mask: the 8-connected outline, then each scanline
    filled between its edge crossings (16.16 fixed point, left end
    rounded up, right end down). An edge with an end outside the image is
    taken from its clipped segment. Identical to OpenCV for polygons
    inside the image; at an image border a clipped edge can differ by a
    pixel (tests/test_torch_pre_post.py measures how often)."""
    h, w = shape
    mask = np.zeros((h, w), bool)
    pts = np.asarray(pts, np.int64).reshape(-1, 2)
    edges = []  # (y0, y1, x at y0 in 16.16 fixed point, dx per row)
    p0 = pts[-1]
    for p1 in pts:
        xa, ya, xb, yb = int(p0[0]), int(p0[1]), int(p1[0]), int(p1[1])
        p0 = p1
        lx, ly = _line_pixels(w, h, xa, ya, xb, yb)
        mask[ly, lx] = True
        if ya == yb:
            continue
        ca, cya, cb, cyb = xa, ya, xb, yb
        if not (0 <= xa < w and 0 <= xb < w and 0 <= ya < h and 0 <= yb < h):
            clipped = _clip_line(w, h, xa, ya, xb, yb)
            if clipped is not None and clipped[1] != clipped[3]:
                ca, cya, cb, cyb = clipped
        num, den = (cb - ca) << _XY_SHIFT, cyb - cya
        step = abs(num) // abs(den) * (1 if (num >= 0) == (den >= 0) else -1)
        if ya < yb:
            edges.append((ya, yb, (ca << _XY_SHIFT) + (ya - cya) * step, step))
        else:
            edges.append((yb, ya, (cb << _XY_SHIFT) + (yb - cyb) * step, step))
    if len(edges) < 2:
        return mask
    e = np.asarray(edges, np.int64)
    y_lo = max(int(e[:, 0].min()), 0)
    y_hi = min(int(e[:, 1].max()), h)
    if y_hi <= y_lo:
        return mask
    ys = np.arange(y_lo, y_hi)
    active = (e[:, 0:1] <= ys) & (ys < e[:, 1:2])  # (edges, rows)
    xs = e[:, 2:3] + (ys - e[:, 0:1]) * e[:, 3:4]
    big = np.iinfo(np.int64).max
    xs = np.sort(np.where(active, xs, big), axis=0)
    cols = np.arange(w)
    for k in range(0, len(edges) - 1, 2):
        ok = xs[k + 1] != big
        a = (xs[k][ok] + _XY_ONE - 1) >> _XY_SHIFT
        b = xs[k + 1][ok] >> _XY_SHIFT
        rows = ys[ok]
        keep = (a < w) & (b >= 0)
        a, b, rows = np.maximum(a[keep], 0), np.minimum(b[keep], w - 1), rows[keep]
        mask[rows] |= (cols >= a[:, None]) & (cols <= b[:, None])
    return mask


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull (no collinear points), float64 (k, 2)."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 2:
        return pts.astype(np.float64)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    p = pts[order].tolist()

    def half(seq):
        out: list = []
        for q in seq:
            while len(out) >= 2:
                (ax, ay), (bx, by) = out[-2], out[-1]
                if (bx - ax) * (q[1] - ay) - (by - ay) * (q[0] - ax) <= 0:
                    out.pop()
                else:
                    break
            out.append(q)
        return out

    lower = half(p)
    upper = half(p[::-1])
    return np.asarray(lower[:-1] + upper[:-1], np.float64)


_F = np.float32


def _rotating_calipers(p: list) -> tuple:
    """OpenCV's ``rotatingCalipers(CALIPERS_MINAREARECT)`` over a convex
    polygon of float32 points, in its float32 arithmetic. Returns the
    rectangle's corner and its two side vectors."""
    n = len(p)
    vect, inv_len = [], []
    left = bottom = right = top = 0
    left_x = right_x = p[0][0]
    top_y = bottom_y = p[0][1]
    for i in range(n):
        x0, y0 = p[i]
        if x0 < left_x:
            left_x, left = x0, i
        if x0 > right_x:
            right_x, right = x0, i
        if y0 > top_y:
            top_y, top = y0, i
        if y0 < bottom_y:
            bottom_y, bottom = y0, i
        dx = float(p[(i + 1) % n][0]) - float(x0)
        dy = float(p[(i + 1) % n][1]) - float(y0)
        vect.append((_F(dx), _F(dy)))
        inv_len.append(_F(1.0 / math.sqrt(dx * dx + dy * dy)))
    orientation = 0.0
    ax, ay = float(vect[-1][0]), float(vect[-1][1])
    for vx, vy in vect:
        convexity = ax * float(vy) - ay * float(vx)
        if convexity != 0:
            orientation = 1.0 if convexity > 0 else -1.0
            break
        ax, ay = float(vx), float(vy)
    base_a, base_b = _F(orientation), _F(0.0)
    seq = [bottom, right, top, left]
    min_area = _F(np.finfo(np.float32).max)
    best = None
    for _ in range(n):
        v = [vect[j] for j in seq]
        dp = (
            base_a * v[0][0] + base_b * v[0][1],
            -base_b * v[1][0] + base_a * v[1][1],
            -base_a * v[2][0] - base_b * v[2][1],
            base_b * v[3][0] - base_a * v[3][1],
        )
        main, max_cos = 0, dp[0] * inv_len[seq[0]]
        for i in range(1, 4):
            cos = dp[i] * inv_len[seq[i]]
            if cos > max_cos:
                main, max_cos = i, cos
        j = seq[main]
        lead_x, lead_y = vect[j][0] * inv_len[j], vect[j][1] * inv_len[j]
        base_a, base_b = (
            (lead_x, lead_y), (lead_y, -lead_x), (-lead_x, -lead_y), (-lead_y, lead_x)
        )[main]
        seq[main] = (seq[main] + 1) % n
        width = (p[seq[1]][0] - p[seq[3]][0]) * base_a + (p[seq[1]][1] - p[seq[3]][1]) * base_b
        height = -(p[seq[2]][0] - p[seq[0]][0]) * base_b + (p[seq[2]][1] - p[seq[0]][1]) * base_a
        area = width * height
        if area <= min_area:
            min_area = area
            best = (seq[3], base_a, width, base_b, height, seq[0])
    left_i, a1, width, b1, height, bottom_i = best
    a2, b2 = -b1, a1
    c1 = a1 * p[left_i][0] + p[left_i][1] * b1
    c2 = a2 * p[bottom_i][0] + p[bottom_i][1] * b2
    idet = _F(1.0) / (a1 * b2 - a2 * b1)
    corner = ((c1 * b2 - c2 * b1) * idet, (a1 * c2 - a2 * c1) * idet)
    return corner, (a1 * width, b1 * width), (a2 * height, b2 * height)


def min_area_rect(pts: np.ndarray, outer: bool = True):
    """``cv2.minAreaRect`` of a contour's integer points: ((cx, cy),
    (w, h), angle in [-90, 0)). Rotating calipers in OpenCV's float32
    arithmetic, over the convex hull in the vertex order OpenCV's
    ``convexHull`` gives an outer border (ending at the top-left vertex);
    a hole's hull starts at its left-most vertex."""
    hull = _convex_hull(np.asarray(pts).reshape(-1, 2))
    if outer and len(hull) > 2:
        k = int(np.lexsort((hull[:, 0], hull[:, 1]))[0])
        hull = np.roll(hull, -(k + 1), axis=0)
    p = [(_F(x), _F(y)) for x, y in hull]
    if len(p) == 1:
        return (float(p[0][0]), float(p[0][1])), (0.0, 0.0), 0.0
    if len(p) == 2:
        center = ((p[0][0] + p[1][0]) * _F(0.5), (p[0][1] + p[1][1]) * _F(0.5))
        side = (float(p[1][0]) - float(p[0][0]), float(p[1][1]) - float(p[0][1]))
        sides = [math.hypot(*side), 0.0]
        angle = math.degrees(math.atan2(side[1], side[0]))
    else:
        corner, s1, s2 = _rotating_calipers(p)
        center = (corner[0] + (s1[0] + s2[0]) * _F(0.5),
                  corner[1] + (s1[1] + s2[1]) * _F(0.5))
        sides = [math.hypot(float(s1[0]), float(s1[1])),
                 math.hypot(float(s2[0]), float(s2[1]))]
        angle = math.atan2(float(s1[1]), float(s1[0])) * 180 / math.pi
    while angle >= 0:  # OpenCV reports angles in [-90, 0)
        angle -= 90
        sides.reverse()
    while angle < -90:
        angle += 90
        sides.reverse()
    return ((float(center[0]), float(center[1])),
            (float(_F(sides[0])), float(_F(sides[1]))), float(_F(angle)))


def box_points(rect) -> np.ndarray:
    """``cv2.boxPoints``: the rect's 4 corners in float32 arithmetic,
    shape (4, 2)."""
    (cx, cy), (rw, rh), angle = rect
    f = np.float32
    cx, cy, rw, rh = f(cx), f(cy), f(rw), f(rh)
    a_rad = float(f(angle)) * math.pi / 180.0
    b = f(math.cos(a_rad)) * f(0.5)
    a = f(math.sin(a_rad)) * f(0.5)
    return np.array([
        (cx - a * rh - b * rw, cy + b * rh - a * rw),
        (cx + a * rh - b * rw, cy - b * rh - a * rw),
        (cx + a * rh + b * rw, cy - b * rh + a * rw),
        (cx - a * rh + b * rw, cy + b * rh + a * rw),
    ], dtype=np.float32)


_EIGHT = np.ones((3, 3), bool)
_FOUR = ndimage.generate_binary_structure(2, 1)


def _row_extremes(mask: np.ndarray, oy: int, ox: int) -> tuple[tuple[int, int], np.ndarray]:
    """Leftmost and rightmost pixel of each row of a sub-mask, as (x, y)
    points in image coordinates, and the first pixel in raster order."""
    rows = np.flatnonzero(mask.any(axis=1))
    sub = mask[rows]
    left = sub.argmax(axis=1)
    right = sub.shape[1] - 1 - sub[:, ::-1].argmax(axis=1)
    ys = rows + oy
    pts = np.concatenate([
        np.stack([left + ox, ys], 1), np.stack([right + ox, ys], 1)
    ])
    return (int(ys[0]), int(left[0] + ox)), pts


def find_contour_rects(seg: np.ndarray) -> list:
    """Minimum-area rectangles of the contours ``cv2.findContours(seg,
    RETR_LIST, CHAIN_APPROX_SIMPLE)`` returns, in its order: outer borders
    of 8-connected components and borders of their holes, last found
    first."""
    # (raster position where the border is met, 0 outer / 1 hole, hull
    # points): OpenCV meets an outer border before a hole border at the
    # same pixel, and returns the last border met first
    found = []
    lab, n = ndimage.label(seg, structure=_EIGHT)
    for i, sl in enumerate(ndimage.find_objects(lab)):
        start, pts = _row_extremes(lab[sl] == i + 1, sl[0].start, sl[1].start)
        found.append((start, 0, pts))
    bg, nb = ndimage.label(seg == 0, structure=_FOUR)
    if nb:
        edge = np.unique(np.concatenate([bg[0], bg[-1], bg[:, 0], bg[:, -1]]))
        for i, sl in enumerate(ndimage.find_objects(bg)):
            if i + 1 in edge:
                continue
            hole = np.pad(bg[sl] == i + 1, 1)
            (y, x), _ = _row_extremes(hole, sl[0].start - 1, sl[1].start - 1)
            ring = ndimage.binary_dilation(hole, structure=_FOUR)
            _, pts = _row_extremes(ring, sl[0].start - 1, sl[1].start - 1)
            # the border is met at the foreground pixel left of the hole's
            # first pixel
            found.append(((y, x - 1), 1, pts))
    found.sort(key=lambda t: t[:2], reverse=True)
    return [min_area_rect(pts, outer=kind == 0) for _, kind, pts in found]


# ------------------------------------------------------------------ det pre

def det_resize(
    img: np.ndarray, limit_side_len: int = 960, limit_type: str = "max",
    max_side_limit: int = 4000,
) -> tuple[np.ndarray, float, float]:
    """Resize so the max (or min) side respects the limit; sides to /32."""
    h, w = img.shape[:2]
    if limit_type == "max":
        ratio = min(1.0, limit_side_len / max(h, w))
    else:
        ratio = max(1.0, limit_side_len / max(min(h, w), 1))
    if max(h, w) * ratio > max_side_limit:
        ratio = max_side_limit / max(h, w)
    rh = max(32, int(round(h * ratio / 32) * 32))
    rw = max(32, int(round(w * ratio / 32) * 32))
    resized = resize_linear(img, rw, rh)
    return resized, rh / h, rw / w


def det_normalize_device(x):
    """Device-side det normalize of a full-depth uint8 NHWC batch:
    ImageNet-normalized fp32; 1-channel (luma) batches broadcast to RGB."""
    import torch

    if x.shape[-1] == 1:
        x = x.expand(-1, -1, -1, 3)
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (x.float() / 255.0 - mean) / std


def rec_normalize_device(x):
    """Device-side rec normalize of a full-depth uint8 NHWC batch: fp32
    in [-1, 1]; 1-channel (luma) batches broadcast to RGB."""
    if x.shape[-1] == 1:
        x = x.expand(-1, -1, -1, 3)
    return x.float() / 127.5 - 1.0


def _unpack_nibbles(x):
    """(N, H, W/2, 1) uint8 -> (N, H, W, 1) uint8 in 0..255 (x17)."""
    import torch

    y = torch.stack([x >> 4, x & 15], dim=3)
    n, h, w2 = x.shape[:3]
    return y.reshape(n, h, w2 * 2, 1) * 17


def det_normalize_device_nibble(x):
    """Device-side inverse of :func:`pack_nibbles` + det normalize:
    (N, H, W/2, 1) uint8 -> (N, H, W, 3) ImageNet-normalized fp32."""
    import torch

    y = _unpack_nibbles(x).expand(-1, -1, -1, 3).float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device)
    std = torch.as_tensor(IMAGENET_STD, device=x.device)
    return (y - mean) / std


def rec_normalize_device_nibble(x):
    """Device-side inverse of :func:`pack_nibbles` + rec normalize:
    (N, H, W/2, 1) uint8 -> (N, H, W, 3) in [-1, 1]."""
    return _unpack_nibbles(x).expand(-1, -1, -1, 3).float() / 127.5 - 1.0


def pack_nibbles(img: np.ndarray) -> np.ndarray:
    """(H, W, 1) uint8 luma -> (H, W/2, 1) with two 4-bit pixels per
    byte (even column in the high nibble)."""
    q = img[..., 0] >> 4  # (H, W) in 0..15
    if q.shape[1] % 2:
        q = np.pad(q, ((0, 0), (0, 1)))
    return ((q[:, 0::2] << 4) | q[:, 1::2])[..., None]


def contrast_stretch(
    img: np.ndarray, lo_pct: float = 2.0, hi_pct: float = 98.0
) -> np.ndarray:
    """Percentile contrast stretch for faded scans/photos (uint8)."""
    if img.dtype != np.uint8:
        return img
    hist = np.bincount(img.reshape(-1), minlength=256).cumsum()
    total = hist[-1]
    if total == 0:
        return img
    lo = int(np.searchsorted(hist, total * lo_pct / 100.0))
    hi = int(np.searchsorted(hist, total * hi_pct / 100.0))
    if hi - lo < 10 or (lo <= 6 and hi >= 249):
        return img  # degenerate or already (near) full range
    lut = np.clip(
        (np.arange(256, dtype=np.float32) - lo) * (255.0 / (hi - lo)),
        0, 255,
    ).astype(np.uint8)
    return lut[img]


def to_luma(img: np.ndarray) -> np.ndarray:
    """uint8 HWC RGB -> (H, W, 1) luminance for low-bandwidth transfer."""
    if img.ndim == 2:
        return img[..., None]
    if img.shape[-1] == 1:
        return img
    return rgb_to_gray(img)[..., None]


# ----------------------------------------------------------------- det post

@dataclass
class DBPostParams:
    thresh: float = 0.3
    box_thresh: float = 0.5
    unclip_ratio: float = 1.8
    max_candidates: int = 1000
    min_size: int = 3
    use_dilation: bool = True


def _box_score_fast(bitmap: np.ndarray, box: np.ndarray) -> float:
    h, w = bitmap.shape[:2]
    xmin = int(np.clip(np.floor(box[:, 0].min()), 0, w - 1))
    xmax = int(np.clip(np.ceil(box[:, 0].max()), 0, w - 1))
    ymin = int(np.clip(np.floor(box[:, 1].min()), 0, h - 1))
    ymax = int(np.clip(np.ceil(box[:, 1].max()), 0, h - 1))
    shifted = box.copy()
    shifted[:, 0] -= xmin
    shifted[:, 1] -= ymin
    mask = fill_poly_mask(
        (ymax - ymin + 1, xmax - xmin + 1), shifted.astype(np.int32)
    )
    region = bitmap[ymin : ymax + 1, xmin : xmax + 1]
    count = int(mask.sum())
    if count == 0:
        return 0.0
    return float(region[mask].astype(np.float64).sum() / count)


def _unclip_rect(rect, unclip_ratio: float):
    """Offset a min-area rect outward by area*ratio/perimeter."""
    (cx, cy), (rw, rh), angle = rect
    area = rw * rh
    perimeter = 2 * (rw + rh)
    if perimeter <= 0:
        return rect
    d = area * unclip_ratio / perimeter
    return ((cx, cy), (rw + 2 * d, rh + 2 * d), angle)


def _order_quad(pts: np.ndarray) -> np.ndarray:
    """Order 4 points clockwise starting top-left."""
    idx = np.argsort(pts[:, 0])
    left = pts[idx[:2]][np.argsort(pts[idx[:2]][:, 1])]
    right = pts[idx[2:]][np.argsort(pts[idx[2:]][:, 1])]
    return np.array([left[0], right[0], right[1], left[1]], dtype=np.float32)


def db_postprocess(
    prob_map: np.ndarray,
    src_h: int,
    src_w: int,
    valid_h: int | None = None,
    valid_w: int | None = None,
    params: DBPostParams | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """prob map (H, W) at network scale -> (boxes Nx4x2 in source pixels, scores).

    valid_h/valid_w crop off bucket padding before box extraction.
    """
    p = params or DBPostParams()
    prob = prob_map[..., 0] if prob_map.ndim == 3 else prob_map
    if valid_h is not None:
        prob = prob[:valid_h, :valid_w]
    seg = prob > p.thresh
    if p.use_dilation:
        seg = _dilate_2x2(seg)
    rects = find_contour_rects(seg)
    h, w = prob.shape
    scale_x = src_w / w
    scale_y = src_h / h
    boxes, scores = [], []
    for rect in rects[: p.max_candidates]:
        if min(rect[1]) < p.min_size:
            continue
        pts = box_points(rect)
        score = _box_score_fast(prob, pts)
        if score < p.box_thresh:
            continue
        rect = _unclip_rect(rect, p.unclip_ratio)
        if min(rect[1]) < p.min_size + 2:
            continue
        pts = _order_quad(box_points(rect))
        pts[:, 0] = np.clip(pts[:, 0] * scale_x, 0, src_w)
        pts[:, 1] = np.clip(pts[:, 1] * scale_y, 0, src_h)
        boxes.append(pts)
        scores.append(score)
    if not boxes:
        return np.zeros((0, 4, 2), dtype=np.float32), np.zeros((0,), dtype=np.float32)
    return np.stack(boxes), np.asarray(scores, dtype=np.float32)


def db_postprocess_poly(
    prob_map: np.ndarray,
    src_h: int,
    src_w: int,
    valid_h: int | None = None,
    valid_w: int | None = None,
    params: DBPostParams | None = None,
    n_points: int = 8,
) -> tuple[list[np.ndarray], np.ndarray]:
    """DB prob map -> 2k-point text polygons (curved-text mode): the JAX
    package's ``db_postprocess_poly``. Each contour of
    ``findContours(RETR_LIST, CHAIN_APPROX_SIMPLE)`` (``find_contours_list``)
    is filled (``fill_poly_mask``, as ``drawContours(thickness=-1)``),
    scored over that mask, grown by an elliptical dilation of about
    ``unclip_ratio`` times its thickness (``dilate_ellipse``) and sampled
    at ``n_points`` columns: the first k points trace the top edge left to
    right, the last k the bottom edge right to left. Near-vertical or
    degenerate components give the unclipped minAreaRect quad. Returns
    (list of (2k, 2) float32 polys in source pixels, scores)."""
    from ...utils.contours import bounding_rect, find_contours_list
    from ...utils.morph import dilate_ellipse

    p = params or DBPostParams()
    prob = prob_map[..., 0] if prob_map.ndim == 3 else prob_map
    if valid_h is not None:
        prob = prob[:valid_h, :valid_w]
    seg = prob > p.thresh
    if p.use_dilation:
        seg = _dilate_2x2(seg)
    contours = find_contours_list(seg)
    h, w = prob.shape
    scale_x = src_w / w
    scale_y = src_h / h
    polys: list[np.ndarray] = []
    scores = []
    for contour, hole in contours[: p.max_candidates]:
        rect = min_area_rect(contour, outer=not hole)
        if min(rect[1]) < p.min_size:
            continue
        x, y, cw, chh = bounding_rect(contour)
        mask = fill_poly_mask((chh, cw), contour.reshape(-1, 2) - [x, y]).astype(np.uint8)
        # score over the component mask, not the minAreaRect (an arc's
        # rect is mostly background)
        region = prob[y : y + chh, x : x + cw]
        denom = float(mask.sum())
        score = float((region * mask).sum() / denom) if denom else 0.0
        if score < p.box_thresh:
            continue
        # unclip: pad the component outward by ~unclip_ratio x thickness
        thickness = max(1.0, float(mask.sum()) / max(cw, 1))
        pad = max(1, int(round(thickness * p.unclip_ratio)))
        mask = dilate_ellipse(np.pad(mask, pad), 2 * pad + 1)
        cols = np.where(mask.any(axis=0))[0]
        if len(cols) < 2 or cw < chh:  # degenerate / vertical: quad path
            poly = _order_quad(box_points(_unclip_rect(rect, p.unclip_ratio)))
        else:
            sample_x = np.linspace(cols[0], cols[-1], n_points)
            top_pts, bot_pts = [], []
            for sx in sample_x:
                ys = np.where(mask[:, int(round(sx))])[0]
                if len(ys):  # a gap inside the band is left out
                    top_pts.append((sx, float(ys[0])))
                    bot_pts.append((sx, float(ys[-1])))
            if len(top_pts) < 2:
                continue
            top = np.asarray(top_pts, np.float32)
            bot = np.asarray(bot_pts, np.float32)
            poly = np.concatenate([top, bot[::-1]], axis=0)
            poly += [x - pad, y - pad]
        poly[:, 0] = np.clip(poly[:, 0] * scale_x, 0, src_w)
        poly[:, 1] = np.clip(poly[:, 1] * scale_y, 0, src_h)
        polys.append(poly.astype(np.float32))
        scores.append(score)
    return polys, np.asarray(scores, dtype=np.float32)


# ------------------------------------------------------------------ rec pre

REC_HEIGHT = 48


def rec_resize(img: np.ndarray, target_w: int, height: int = REC_HEIGHT) -> np.ndarray:
    """Keep-ratio resize to rec height, right-pad with zeros to target_w."""
    h, w = img.shape[:2]
    ratio = height / max(h, 1)
    rw = max(1, min(target_w, int(math.ceil(w * ratio))))
    resized = resize_linear(img, rw, height)
    out = np.zeros((height, target_w, 3), dtype=img.dtype)
    out[:, :rw] = resized if resized.ndim == 3 else resized[..., None]
    return out


def rec_width_bucket(w: int, h: int, widths: tuple[int, ...]) -> int:
    """Pick the smallest width bucket that fits the aspect-scaled crop."""
    target = int(math.ceil(w * REC_HEIGHT / max(h, 1)))
    for wb in widths:
        if target <= wb:
            return wb
    return widths[-1]


# ---------------------------------------------------------- perspective crop

def perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """``cv2.getPerspectiveTransform(src, dst)``: the 3x3 homography
    (float64) taking 4 float32 points ``src`` onto ``dst``, solved as
    OpenCV does (8x8 system, LU with partial pivoting)."""
    src = np.asarray(src, np.float32)
    dst = np.asarray(dst, np.float32)
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        sx, sy = src[i]
        dx, dy = dst[i]
        a[i, 0] = a[i + 4, 3] = sx
        a[i, 1] = a[i + 4, 4] = sy
        a[i, 2] = a[i + 4, 5] = 1.0
        a[i, 6] = -sx * dx  # float32 products, as OpenCV forms them
        a[i, 7] = -sy * dx
        a[i + 4, 6] = -sx * dy
        a[i + 4, 7] = -sy * dy
        b[i] = dx
        b[i + 4] = dy
    a = a.tolist()
    b = b.tolist()
    m = 8
    for i in range(m):
        k = max(range(i, m), key=lambda j: (abs(a[j][i]), -j))
        if k != i:
            a[i], a[k] = a[k], a[i]
            b[i], b[k] = b[k], b[i]
        d = -1.0 / a[i][i]
        for j in range(i + 1, m):
            alpha = a[j][i] * d
            for c in range(i + 1, m):
                a[j][c] += alpha * a[i][c]
            b[j] += alpha * b[i]
    for i in range(m - 1, -1, -1):
        s = b[i]
        for c in range(i + 1, m):
            s -= a[i][c] * b[c]
        b[i] = s / a[i][i]
    return np.array(b + [1.0]).reshape(3, 3)


def _invert3(m: np.ndarray) -> np.ndarray:
    """OpenCV's closed-form 3x3 inverse (``invert``, DECOMP_LU, n == 3)."""
    s = m.tolist()
    d = (s[0][0] * (s[1][1] * s[2][2] - s[1][2] * s[2][1])
         - s[0][1] * (s[1][0] * s[2][2] - s[1][2] * s[2][0])
         + s[0][2] * (s[1][0] * s[2][1] - s[1][1] * s[2][0]))
    if d == 0.0:
        return np.zeros((3, 3))
    d = 1.0 / d
    t = [
        (s[1][1] * s[2][2] - s[1][2] * s[2][1]) * d,
        (s[0][2] * s[2][1] - s[0][1] * s[2][2]) * d,
        (s[0][1] * s[1][2] - s[0][2] * s[1][1]) * d,
        (s[1][2] * s[2][0] - s[1][0] * s[2][2]) * d,
        (s[0][0] * s[2][2] - s[0][2] * s[2][0]) * d,
        (s[0][2] * s[1][0] - s[0][0] * s[1][2]) * d,
        (s[1][0] * s[2][1] - s[1][1] * s[2][0]) * d,
        (s[0][1] * s[2][0] - s[0][0] * s[2][1]) * d,
        (s[0][0] * s[1][1] - s[0][1] * s[1][0]) * d,
    ]
    return np.array(t).reshape(3, 3)


# OpenCV's linear warp kernel for uint8 works on two 8-lane float32
# vectors (its AVX2 build) per step of 16 output columns; the columns of a
# row past the last whole step take its scalar code, which rounds the map
# differently.
WARP_VECTOR_COLUMNS = 16


def _fma32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    """float32 a * b + c rounded once, as an FMA instruction does. The
    product is exact in float64; where the float64 sum lies on a float32
    tie that the exact sum does not, it is moved toward the exact sum
    (its TwoSum remainder) before the float32 rounding."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    rem = (p - (s - bb)) + (c - bb)
    r = s.astype(np.float32)
    other = np.nextafter(r, np.where(s > r, np.float32(np.inf), np.float32(-np.inf)))
    gap = np.abs(s - r)
    fix = (gap != 0) & (gap == np.abs(other.astype(np.float64) - s)) & (rem != 0)
    r[fix] = np.nextafter(s[fix], np.sign(rem[fix]) * np.inf).astype(np.float32)
    return r


def _row_major_map(coef: np.ndarray, w: int, h: int, i: int) -> np.ndarray:
    """``x * coef[i] + y * coef[i + 1] + coef[i + 2]`` over the output grid
    in float32, as OpenCV's linear warp kernels round it: in the vector
    columns (whole steps of WARP_VECTOR_COLUMNS) the row term
    ``y * c1 + c2`` first and ``fma(x, c0, row)`` once; in the scalar
    tail ``fma(x, c0, y * c1) + c2``."""
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.broadcast_to(np.arange(w, dtype=np.float32)[None, :], (h, w))
    vector = xs < (w // WARP_VECTOR_COLUMNS) * WARP_VECTOR_COLUMNS
    row = np.broadcast_to(ys * coef[i + 1] + coef[i + 2], (h, w))
    tail = _fma32(xs, coef[i], np.broadcast_to(ys * coef[i + 1], (h, w))) + coef[i + 2]
    return np.where(vector, _fma32(xs, coef[i], row), tail)


class OpenCVError(ValueError):
    """Raised where OpenCV raises ``cv2.error`` for an input the replays
    take: a remap whose output or source has a side of SHRT_MAX or more,
    a polar warp to an empty size."""


_SHRT_MAX = 32767


def remap_linear(img: np.ndarray, sx: np.ndarray, sy: np.ndarray,
                 border_value: int = 0) -> np.ndarray:
    """``cv2.remap(img, sx, sy, INTER_LINEAR, borderValue=(v, v, v))`` for
    uint8 HW or HWC images and float32 maps (``_blend``). A side of
    SHRT_MAX or more raises OpenCVError, as OpenCV asserts."""
    if max(np.shape(sx)[:2] + img.shape[:2]) >= _SHRT_MAX:
        raise OpenCVError("remap: a side of SHRT_MAX or more")
    return _blend(img, sx, sy, border_value)


def _blend(img: np.ndarray, sx: np.ndarray, sy: np.ndarray, border_value: int) -> np.ndarray:
    """OpenCV 5.0's linear kernel at float32 source positions: the 4
    source taps (the constant border outside the image) blend in float32
    by FMA, ``fma(fx, p01 - p00, p00)`` along x, then the same along y,
    and the result rounds half to even."""
    sx = np.asarray(sx, np.float32)
    sy = np.asarray(sy, np.float32)
    x0 = np.floor(sx)
    y0 = np.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    src = img if img.ndim == 3 else img[..., None]
    ih, iw = src.shape[:2]
    pad = np.full((ih + 2, iw + 2, src.shape[2]), np.float32(border_value))
    pad[1:-1, 1:-1] = src
    # taps outside the image read the border
    xi = np.clip(x0.astype(np.int64) + 1, 0, iw + 1)
    yi = np.clip(y0.astype(np.int64) + 1, 0, ih + 1)
    xj = np.clip(x0.astype(np.int64) + 2, 0, iw + 1)
    yj = np.clip(y0.astype(np.int64) + 2, 0, ih + 1)
    top = _fma32(fx, pad[yi, xj] - pad[yi, xi], pad[yi, xi])
    bot = _fma32(fx, pad[yj, xj] - pad[yj, xi], pad[yj, xi])
    out = np.clip(np.rint(_fma32(fy, bot - top, top)), 0, 255).astype(np.uint8)
    return out if img.ndim == 3 else out[..., 0]


def warp_perspective(img: np.ndarray, m: np.ndarray, w: int, h: int,
                     border_value: int = 0) -> np.ndarray:
    """``cv2.warpPerspective(img, m, (w, h), borderValue=(v, v, v))`` for
    uint8 HWC images (INTER_LINEAR, constant border), bit for bit as
    OpenCV 5.0's linear warp kernel computes it on an x86 host with AVX2:

    - the inverse homography in float64 (OpenCV's closed-form 3x3
      inverse), then cast to float32;
    - each output pixel (x, y) maps back in float32 (``_row_major_map``
      for the two coordinates and the denominator), then one division;
    - ``_blend`` of the 4 source taps.

    (OpenCV 4.x blended with 15-bit fixed-point weights on a 1/32 grid;
    the tests hold this function to the OpenCV they run with.)"""
    inv = _invert3(m).astype(np.float32).ravel()
    den = _row_major_map(inv, w, h, 6)
    sx = _row_major_map(inv, w, h, 0) / den
    sy = _row_major_map(inv, w, h, 3) / den
    return _blend(img, sx, sy, border_value)


def rotation_matrix_2d(cx: float, cy: float, angle: float, scale: float = 1.0) -> np.ndarray:
    """``cv2.getRotationMatrix2D((cx, cy), angle, scale)`` (2x3 float64;
    the centre is a float32 point)."""
    a = angle * (math.pi / 180)
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    cx, cy = float(np.float32(cx)), float(np.float32(cy))
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine(img: np.ndarray, m: np.ndarray, w: int, h: int,
                border_value: int = 0) -> np.ndarray:
    """``cv2.warpAffine(img, m, (w, h), borderValue=(v, v, v))``
    (INTER_LINEAR): OpenCV's float64 inverse of the 2x3 matrix cast to
    float32, each output pixel mapped back by ``_row_major_map`` and
    blended by ``_blend``."""
    a = np.asarray(m, np.float64).ravel()
    d = a[0] * a[4] - a[1] * a[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = a[4] * d, a[0] * d
    a12, a21 = -a[1] * d, -a[3] * d
    b1 = -a11 * a[2] - a12 * a[5]
    b2 = -a21 * a[2] - a22 * a[5]
    inv = np.array([a11, a12, b1, a21, a22, b2]).astype(np.float32)
    return _blend(img, _row_major_map(inv, w, h, 0), _row_major_map(inv, w, h, 3), border_value)


def warp_polar_linear(img: np.ndarray, width: int, height: int, center: tuple[float, float],
                      max_radius: float) -> np.ndarray:
    """``cv2.warpPolar(img, (width, height), center, max_radius,
    WARP_POLAR_LINEAR + INTER_LINEAR)``: row phi samples the angle
    2 pi phi / height, column rho the radius rho * max_radius / width
    (float32), the maps made in float64 and cast to float32. OpenCV
    remaps with a transparent border into an output it does not clear,
    so a sample whose taps leave the image has no defined value there;
    this replay gives it the blend over a zero border. An empty size
    raises OpenCVError, as OpenCV asserts."""
    if width <= 0 or height <= 0:
        raise OpenCVError("warpPolar: an empty size")
    k_angle = 2 * math.pi / height
    rhos = (np.arange(width) * (max_radius / width)).astype(np.float32).astype(np.float64)
    phi = np.arange(height) * k_angle
    cx, cy = float(np.float32(center[0])), float(np.float32(center[1]))
    mx = (rhos[None] * np.cos(phi)[:, None] + cx).astype(np.float32)
    my = (rhos[None] * np.sin(phi)[:, None] + cy).astype(np.float32)
    return remap_linear(img, mx, my, 0)


# ----------------------------------------------------------------- charsets

class CTCLabelDecoder:
    """CTC greedy decoder over a character dictionary.

    Dictionary layout matches PP-OCR: index 0 = blank, then dict entries,
    final entry is space.
    """

    def __init__(self, charset: list[str]):
        self.chars = [""] + list(charset) + [" "]

    @classmethod
    def from_file(cls, path: str) -> "CTCLabelDecoder":
        with open(path, encoding="utf-8") as f:
            lines = [ln.rstrip("\n\r") for ln in f]
        return cls([ln for ln in lines if ln != ""])

    def __call__(
        self, ids: np.ndarray, probs: np.ndarray, valid_t: int | None = None
    ) -> tuple[str, float]:
        """ids/probs: (T,) greedy argmax ids and their probabilities."""
        text, score, _ = self.decode_with_positions(ids, probs, valid_t)
        return text, score

    def decode_with_positions(
        self, ids: np.ndarray, probs: np.ndarray, valid_t: int | None = None
    ) -> tuple[str, float, list[int]]:
        """Greedy decode also returning each emitted char's frame index
        (for word-box geometry)."""
        if valid_t is not None:
            ids = ids[:valid_t]
            probs = probs[:valid_t]
        out: list[str] = []
        confs: list[float] = []
        frames: list[int] = []
        prev = -1
        for i, t in enumerate(ids.tolist()):
            if t != prev and t != 0 and t < len(self.chars):
                out.append(self.chars[t])
                confs.append(float(probs[i]))
                frames.append(i)
            prev = t
        if not out:
            return "", 0.0, []
        return "".join(out), float(np.mean(confs)), frames


# ------------------------------------------------------------- word boxes

def _is_cjk(ch: str) -> bool:
    o = ord(ch)
    return (
        0x2E80 <= o <= 0x9FFF or 0xF900 <= o <= 0xFAFF
        or 0xFF00 <= o <= 0xFFEF or 0x3000 <= o <= 0x303F
    )


def split_words(text: str, frames: list[int]) -> list[tuple[str, int, int]]:
    """Group decoded chars into words: CJK chars stand alone, latin runs
    group until whitespace. Returns (word, first_frame, last_frame)."""
    words: list[tuple[str, int, int]] = []
    cur = ""
    f0 = f1 = -1
    for ch, fr in zip(text, frames):
        if ch.isspace():
            if cur:
                words.append((cur, f0, f1))
                cur = ""
            continue
        if _is_cjk(ch):
            if cur:
                words.append((cur, f0, f1))
                cur = ""
            words.append((ch, fr, fr))
        else:
            if not cur:
                cur, f0 = ch, fr
            else:
                cur += ch
            f1 = fr
    if cur:
        words.append((cur, f0, f1))
    return words


def word_boxes_in_crop(
    words: list[tuple[str, int, int]], total_frames: int,
    crop_w: int, crop_h: int,
) -> list[list[float]]:
    """Frame span -> x-span boxes inside the rectified crop. Each frame
    covers crop_w/total_frames px."""
    if total_frames <= 0:
        return [[0, 0, crop_w, crop_h] for _ in words]
    px = crop_w / total_frames
    out = []
    for _, f0, f1 in words:
        x0 = max(0.0, f0 * px)
        x1 = min(float(crop_w), (f1 + 1) * px)
        out.append([x0, 0.0, x1, float(crop_h)])
    return out


def perspective_points(pts: np.ndarray, m: np.ndarray) -> np.ndarray:
    """``cv2.perspectiveTransform`` of float32 (N, 2) points by the
    float64 homography ``m``, as OpenCV computes it: each product and
    sum in float64, the denominator's reciprocal in float64, each result
    rounded once to float32; a denominator within FLT_EPSILON of 0 gives
    (0, 0)."""
    p = np.asarray(pts, np.float32).reshape(-1, 2).astype(np.float64)
    x, y = p[:, 0], p[:, 1]
    m = np.asarray(m, np.float64).ravel()
    w = x * m[6] + y * m[7] + m[8]
    ok = np.abs(w) > np.finfo(np.float32).eps
    inv = 1.0 / np.where(ok, w, 1.0)
    out = np.stack([(x * m[0] + y * m[1] + m[2]) * inv,
                    (x * m[3] + y * m[4] + m[5]) * inv], axis=1).astype(np.float32)
    out[~ok] = 0.0
    return out


def map_crop_box_to_quad(
    box: list[float], crop_w: int, crop_h: int, quad: np.ndarray
) -> np.ndarray:
    """Rect box in rectified-crop coords -> 4-point polygon in source-image
    coords via the inverse of the rectification homography."""
    quad = quad.astype(np.float32)
    dst = np.array(
        [[0, 0], [crop_w, 0], [crop_w, crop_h], [0, crop_h]], np.float32
    )
    m = perspective_transform(dst, quad)
    x0, y0, x1, y1 = box
    pts = np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], np.float32)
    return perspective_points(pts, m)
