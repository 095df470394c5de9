"""PIL's ``ImageFilter.GaussianBlur``, replayed in numpy.

Pillow 12.1 blurs with three box blurs a direction (``ImagingGaussianBlur``
in ``BoxBlur.c``): all three horizontal passes, then all three vertical
ones, each pass rounding to 8 bits. The box's radius comes from the
Gaussian's in float32 (``_gaussian_blur_radius``: ``sigma2 = r^2 / 3``,
``L = sqrt(12 sigma2 + 1)``, ``l = floor((L - 1) / 2)``, ``a = (2l + 1)
(l (l + 1) - 3 sigma2) / (6 (sigma2 - (l + 1)^2))``, radius ``l + a``).
A pass of box radius ``R`` (``r = int(R)``) sums the ``2r + 1`` pixels
around each one with the weight ``ww = (UINT32)(2^24 / (2R + 1))`` and the
two pixels just outside with ``fw = (2^24 - (2r + 1) ww) / 2``, in 32-bit
integers, edges repeated, and keeps ``(sum + 2^23) >> 24``. A radius that
comes out 0 skips its direction.
"""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def box_radius(radius: float, passes: int = 3) -> float:
    """``_gaussian_blur_radius`` in float32."""
    r = _F(radius)
    sigma2 = r * r / _F(passes)
    big_l = _F(math.sqrt(12.0 * float(sigma2) + 1.0))
    small_l = _F(math.floor((float(big_l) - 1.0) / 2.0))
    a = (_F(2) * small_l + _F(1)) * (small_l * (small_l + _F(1)) - _F(3) * sigma2)
    a = a / (_F(6) * (sigma2 - (small_l + _F(1)) * (small_l + _F(1))))
    return float(small_l + a)


def _box_pass(img: np.ndarray, radius: float) -> np.ndarray:
    """One ``ImagingHorizontalBoxBlur`` along axis 1 of (H, W, C) uint8."""
    r = int(radius)
    ww = int(_F(1 << 24) / (_F(radius) * _F(2) + _F(1)))
    fw = ((1 << 24) - (r * 2 + 1) * ww) // 2
    w = img.shape[1]
    idx = np.clip(np.arange(-r - 1, w + r + 1), 0, w - 1)
    ext = img[:, idx].astype(np.int64)  # edge pixels repeated
    csum = np.concatenate([np.zeros_like(ext[:, :1]), np.cumsum(ext, axis=1)], axis=1)
    # window of pixel x: ext[x + 1 .. x + 2r + 1]; the far pixels ext[x], ext[x + 2r + 2]
    acc = csum[:, 2 * r + 2:2 * r + 2 + w] - csum[:, 1:1 + w]
    bulk = (acc * ww + (ext[:, :w] + ext[:, 2 * r + 2:2 * r + 2 + w]) * fw) & 0xFFFFFFFF
    return ((bulk + (1 << 23)) >> 24).astype(np.uint8)


def gaussian_blur(img: np.ndarray, radius: float, passes: int = 3) -> np.ndarray:
    """``Image.filter(ImageFilter.GaussianBlur(radius))`` of an (H, W[, C])
    uint8 array."""
    squeeze = img.ndim == 2
    out = img[..., None] if squeeze else img
    if radius == 0:
        return img.copy()
    box = box_radius(radius, passes)
    if box != 0:
        for _ in range(passes):
            out = _box_pass(out, box)
        out = out.transpose(1, 0, 2)
        for _ in range(passes):
            out = _box_pass(out, box)
        out = np.ascontiguousarray(out.transpose(1, 0, 2))
    else:
        out = out.copy()
    return out[..., 0] if squeeze else out
