"""PIL's ``Image.resize`` and ``Image.rotate``, replayed in numpy.

The JAX renderer resizes small placed images and every RGBA image with
``Image.resize(size, BILINEAR)``, image-mask stencils and soft masks with
``Image.resize(size)`` (BICUBIC), and turns placed images with
``Image.rotate(angle, expand=True)`` (NEAREST). These give Pillow 12.1's
bytes (``tests/test_torch_pil_draw.py`` holds them to PIL):

- ``resize`` is Pillow's two-pass resample (ImagingResample): a
  horizontal pass over the source rows the vertical pass needs, then a
  vertical pass, each with the filter's support scaled by the shrink
  factor, weights normalised in double and rounded to 22-bit fixed point,
  and sums clipped to 8 bits. RGBA goes through premultiplied RGBa and
  back, as ``Image.resize`` does.
- ``rotate`` by 90 or 270 degrees with ``expand`` is a transpose; any
  other angle is Pillow's affine NEAREST transform, whose source position
  is kept in 16.16 fixed point; pixels that map outside the source are 0
  (black on RGB, transparent on RGBA), or ``fillcolor`` where one is
  given (Pillow then makes the new image in that colour and leaves those
  pixels alone).
- ``rotate(expand=True, resample=BICUBIC)`` of an RGBA text tile (the JAX
  renderer turns glyph tiles so) goes through premultiplied RGBa: the
  source position of each pixel centre in double, Pillow's cubic (its
  ``BICUBIC`` macro, a = -1 form, in its order of operations) across four
  columns of each of four rows (edge columns clamped; rows past the
  bottom repeat the row above), the sum truncated to 8 bits.
"""
from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


FILTERS = {"bilinear": (_bilinear, 1.0), "bicubic": (_bicubic, 2.0)}


def _coeffs(in_size: int, out_size: int, filt: str):
    """Pillow's precompute_coeffs + normalize_coeffs_8bpc: per output pixel
    the first source index, the tap count and the int32 weights."""
    fn, support = FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    w = fn((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    # the weights' sum accumulates left to right in double, as Pillow's
    total = np.zeros(out_size)
    for t in range(ksize):
        total = total + w[:, t]
    w = np.where((total != 0.0)[:, None], w / np.where(total != 0.0, total, 1.0)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    k = np.trunc(np.where(w < 0, scaled - 0.5, scaled + 0.5)).astype(np.int64)
    return xmin, xmax, k


def _pass(src: np.ndarray, axis: int, xmin, xmax, k) -> np.ndarray:
    """One resample pass along ``axis`` (0 rows, 1 columns) of an
    (H, W, C) uint8 array."""
    a = np.moveaxis(src, axis, 0).astype(np.int64)
    out_n, ksize = k.shape
    acc = np.full((out_n,) + a.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    n_in = a.shape[0]
    for t in range(ksize):
        idx = np.minimum(xmin + t, n_in - 1)
        wt = np.where(t < xmax, k[:, t], 0)
        acc += a[idx] * wt.reshape((-1,) + (1,) * (a.ndim - 1))
    out = np.where(acc >= (1 << PRECISION_BITS << 8), 255,
                   np.where(acc <= 0, 0, acc >> PRECISION_BITS))
    return np.moveaxis(out.astype(np.uint8), 0, axis)


def _resample(img: np.ndarray, width: int, height: int, filt: str) -> np.ndarray:
    h, w = img.shape[:2]
    xmin_h, xmax_h, k_h = _coeffs(w, width, filt)
    ymin_v, ymax_v, k_v = _coeffs(h, height, filt)
    out = img
    if width != w:
        # only the source rows the vertical pass reads
        y0 = int(ymin_v[0])
        y1 = int(ymin_v[-1] + ymax_v[-1])
        out = _pass(out[y0:y1], 1, xmin_h, xmax_h, k_h)
        ymin_v = ymin_v - y0
    if height != h:
        out = _pass(out, 0, ymin_v, ymax_v, k_v)
    return out


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa: MULDIV255(c, alpha) per colour channel."""
    a = rgba[..., 3:4].astype(np.int64)
    t = rgba[..., :3].astype(np.int64) * a + 128
    out = rgba.copy()
    out[..., :3] = (((t >> 8) + t) >> 8).astype(np.uint8)
    return out


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA: 255 * c / alpha (clipped), kept where alpha is 0 or
    255."""
    a = rgba[..., 3:4].astype(np.int64)
    c = rgba[..., :3].astype(np.int64)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    keep = (a == 0) | (a == 255)
    out = rgba.copy()
    out[..., :3] = np.where(keep, c, div).astype(np.uint8)
    return out


def resize(img: np.ndarray, width: int, height: int, filt: str = "bicubic") -> np.ndarray:
    """``Image.resize((width, height), filter)`` of an L (H, W), RGB or RGBA
    (H, W, 3|4) uint8 array; the same size gives a copy."""
    h, w = img.shape[:2]
    if (w, h) == (width, height):
        return img.copy()
    grey = img.ndim == 2
    a = img[..., None] if grey else img
    if a.shape[2] == 4:
        out = _unpremultiply(_resample(_premultiply(a), width, height, filt))
    else:
        out = _resample(a, width, height, filt)
    return out[..., 0] if grey else out


def _rotate_matrix(w: int, h: int, angle: float):
    """``Image.rotate``'s output size and inverse affine matrix for
    ``expand=True``."""
    cx, cy = w / 2, h / 2
    rad = -math.radians(angle)
    m = [round(math.cos(rad), 15), round(math.sin(rad), 15), 0.0,
         round(-math.sin(rad), 15), round(math.cos(rad), 15), 0.0]

    def transform(x, y):
        return m[0] * x + m[1] * y + m[2], m[3] * x + m[4] * y + m[5]

    m[2], m[5] = transform(-cx, -cy)
    m[2] += cx
    m[5] += cy
    xx, yy = [], []
    for x, y in ((0, 0), (w, 0), (w, h), (0, h)):
        tx, ty = transform(x, y)
        xx.append(tx)
        yy.append(ty)
    nw = math.ceil(max(xx)) - math.floor(min(xx))
    nh = math.ceil(max(yy)) - math.floor(min(yy))
    m[2], m[5] = transform(-(nw - w) / 2.0, -(nh - h) / 2.0)
    return nw, nh, m


def _fast_turn(img: np.ndarray, angle: float):
    if angle == 0:
        return img.copy()
    if angle == 180:
        return img[::-1, ::-1].copy()
    if angle == 90:
        return np.rot90(img, 1).copy()
    if angle == 270:
        return np.rot90(img, -1).copy()
    return None


def rotate_expand(img: np.ndarray, angle: float, fillcolor=None) -> np.ndarray:
    """``Image.rotate(angle, expand=True[, fillcolor=...])`` (NEAREST) of an
    (H, W[, C]) uint8 array."""
    angle = angle % 360.0
    out = _fast_turn(img, angle)
    if out is not None:
        return out
    h, w = img.shape[:2]
    nw, nh, m = _rotate_matrix(w, h, angle)
    return _affine_nearest(img, nw, nh, m, fillcolor)


def rotate_expand_bicubic(rgba: np.ndarray, angle: float) -> np.ndarray:
    """``Image.rotate(angle, expand=True, resample=BICUBIC)`` of an RGBA
    (H, W, 4) uint8 array: premultiplied to RGBa, Pillow's affine BICUBIC
    filter, back to RGBA."""
    angle = angle % 360.0
    out = _fast_turn(rgba, angle)
    if out is not None:
        return out
    h, w = rgba.shape[:2]
    nw, nh, m = _rotate_matrix(w, h, angle)
    return _unpremultiply(_affine_bicubic(_premultiply(rgba), nw, nh, m))


def _cubic(v1, v2, v3, v4, d):
    """Pillow's BICUBIC macro (double precision, its order of operations)."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def _affine_bicubic(img: np.ndarray, out_w: int, out_h: int, a) -> np.ndarray:
    """ImagingGenericTransform with the affine map and bicubic_filter32RGB:
    the source position of each pixel centre in double, 0 outside the
    source, edge rows and columns repeated, each band truncated to 8 bits."""
    h, w = img.shape[:2]
    xs = np.arange(out_w, dtype=np.float64)[None, :] + 0.5
    ys = np.arange(out_h, dtype=np.float64)[:, None] + 0.5
    xin = a[0] * xs + a[1] * ys + a[2]
    yin = a[3] * xs + a[4] * ys + a[5]
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    out = np.zeros((out_h, out_w, img.shape[2]), np.uint8)
    xi, yi = xin[inside] - 0.5, yin[inside] - 0.5
    x = np.floor(xi).astype(np.int64)
    y = np.floor(yi).astype(np.int64)
    dx, dy = xi - x, yi - y
    x -= 1
    y -= 1
    cols = [np.clip(x + k, 0, w - 1) for k in range(4)]
    src = img.astype(np.float64)
    rows = []
    prev = None
    for k in range(4):
        yk = y + k
        ok = (yk >= 0) & (yk < h)
        row = src[np.clip(yk, 0, h - 1)]
        v = _cubic(*(row[np.arange(len(yk)), c] for c in cols), dx[:, None])
        if k > 0:
            v = np.where(ok[:, None], v, prev)
        rows.append(v)
        prev = v
    v = _cubic(*rows, dy[:, None])
    out[inside] = np.where(v <= 0.0, 0, np.where(v >= 255.0, 255, np.trunc(np.clip(v, 0, 255)))).astype(np.uint8)
    return out


def _affine_nearest(img: np.ndarray, out_w: int, out_h: int, a, fill=None) -> np.ndarray:
    """Pillow's ImagingTransformAffine with NEAREST: the source position of
    a pixel centre in 16.16 fixed point, stepped exactly per row and
    column, floored to the source pixel."""
    h, w = img.shape[:2]

    def fix(v: float) -> int:
        return math.floor(v * 65536.0 + 0.5)

    xo = fix(a[2] + a[1] * 0.5 + a[0] * 0.5)
    yo = fix(a[5] + a[4] * 0.5 + a[3] * 0.5)
    xs = np.arange(out_w, dtype=np.int64)
    ys = np.arange(out_h, dtype=np.int64)[:, None]
    xin = (xo + fix(a[1]) * ys + fix(a[0]) * xs) >> 16
    yin = (yo + fix(a[4]) * ys + fix(a[3]) * xs) >> 16
    inside = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.zeros((out_h, out_w) + img.shape[2:], np.uint8)
    if fill is not None:
        out[...] = np.asarray(fill, np.uint8)
    out[inside] = img[yin[inside], xin[inside]]
    return out
