"""The OpenCV image filters that the table stage needs, in numpy and scipy.

The JAX package's table modules call OpenCV for the heuristic table
kind (``models/table/cls.py``), the ruling-line extractor
(``models/table/img2table.py``) and the UNet's cell recovery
(``models/table/unet.py``). Each call is replayed here to give OpenCV's
bytes:

- ``adaptive_threshold_mean``: ``cv2.adaptiveThreshold`` with
  ``ADAPTIVE_THRESH_MEAN_C``. The local mean is OpenCV's uint8 box
  filter (``BORDER_REPLICATE | BORDER_ISOLATED``), the window's sum
  divided and rounded to nearest, not floored. The threshold compares
  ``src - mean`` against the rounded C through OpenCV's integer table
  (``cvCeil(C)`` for ``THRESH_BINARY``, ``cvFloor(C)`` for the inverse).
- ``morph_open_rect``: ``cv2.morphologyEx(MORPH_OPEN)`` with a
  ``MORPH_RECT`` element of (k, 1) or (1, k): erosion then dilation,
  both over ``[x - k // 2, x - k // 2 + k - 1]`` (OpenCV's anchor), and
  OpenCV's default border, which leaves both unaffected by the outside.
- ``dilate3x3``: ``cv2.dilate`` with a 3x3 element of ones.
- ``connected_components_with_stats``: ``cv2.connectedComponentsWithStats``
  with connectivity 4; labels follow each component's first pixel in
  raster order, as OpenCV numbers them.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def box_mean_u8(gray: np.ndarray, block: int) -> np.ndarray:
    """``cv2.boxFilter(gray, -1, (block, block), normalize=True,
    borderType=BORDER_REPLICATE | BORDER_ISOLATED)`` for uint8 and an
    odd ``block``."""
    r = block // 2
    padded = np.pad(gray.astype(np.int32), r, mode="edge")
    c = np.cumsum(np.cumsum(padded, axis=0), axis=1)
    c = np.pad(c, ((1, 0), (1, 0)))
    h, w = gray.shape
    s = (c[block:block + h, block:block + w] - c[:h, block:block + w]
         - c[block:block + h, :w] + c[:h, :w])
    # the mean rounded to nearest: s / d is never a tie for an odd d
    d = block * block
    return ((2 * s + d) // (2 * d)).astype(np.uint8)


def adaptive_threshold_mean(
    gray: np.ndarray, max_value: int, block: int, c: float, inverse: bool = False
) -> np.ndarray:
    """``cv2.adaptiveThreshold(gray, max_value, ADAPTIVE_THRESH_MEAN_C,
    THRESH_BINARY_INV if inverse else THRESH_BINARY, block, c)`` for a
    uint8 image."""
    mean = box_mean_u8(gray, block).astype(np.int32)
    diff = gray.astype(np.int32) - mean
    if inverse:
        hit = diff <= -int(np.floor(c))
    else:
        hit = diff > -int(np.ceil(c))
    return np.where(hit, np.uint8(max_value), np.uint8(0))


def morph_open_rect(binary: np.ndarray, kw: int, kh: int) -> np.ndarray:
    """``cv2.morphologyEx(binary, MORPH_OPEN,
    cv2.getStructuringElement(MORPH_RECT, (kw, kh)))`` where one of kw,
    kh is 1."""
    if min(kw, kh) != 1:
        raise ValueError("a line element: one side must be 1")
    k, axis = (kw, 1) if kh == 1 else (kh, 0)
    if k == 1:
        return binary.copy()
    # scipy's window with origin 0 is [i - k // 2, i - k // 2 + k - 1],
    # OpenCV's for both operations (it does not reflect the element);
    # edge replication equals clipping, since a clipped window always
    # holds the edge pixel it would repeat
    eroded = ndimage.minimum_filter1d(binary, k, axis=axis, mode="nearest")
    return ndimage.maximum_filter1d(eroded, k, axis=axis, mode="nearest")


def dilate3x3(mask: np.ndarray) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((3, 3), np.uint8))``."""
    return ndimage.maximum_filter(mask, size=3, mode="nearest")


def connected_components_with_stats(
    binary: np.ndarray,
) -> tuple[int, np.ndarray, np.ndarray]:
    """``n, labels, stats, _ = cv2.connectedComponentsWithStats(binary,
    connectivity=4)``: (n, int32 labels, int32 stats rows of [x, y, w,
    h, area]), label 0 the zero pixels."""
    labels, n_fg = ndimage.label(binary != 0)
    labels = labels.astype(np.int32)
    n = n_fg + 1
    stats = np.zeros((n, 5), np.int32)
    area = np.bincount(labels.ravel(), minlength=n)
    stats[:, 4] = area
    for i, sl in enumerate(ndimage.find_objects(labels), start=1):
        if sl is None:
            continue
        stats[i] = (sl[1].start, sl[0].start, sl[1].stop - sl[1].start,
                    sl[0].stop - sl[0].start, area[i])
    if area[0]:
        ys, xs = np.nonzero(labels == 0)
        stats[0, :4] = (xs.min(), ys.min(), xs.max() - xs.min() + 1, ys.max() - ys.min() + 1)
    else:
        # what OpenCV reports for a background without pixels
        stats[0, :4] = (-1, np.iinfo(np.int32).max, 0, 0)
    return n, labels, stats


def otsu_threshold(gray: np.ndarray) -> int:
    """The threshold ``cv2.threshold(gray, 0, 255, THRESH_OTSU)`` picks
    for a uint8 image: the first level of greatest between-class
    variance, OpenCV's float64 recurrence over the histogram (levels
    where either class holds under FLT_EPSILON of the pixels skipped)."""
    hist = np.bincount(gray.ravel(), minlength=256)
    scale = 1.0 / gray.size
    mu = 0.0
    for i in range(256):
        mu += i * float(hist[i])
    mu *= scale
    mu1 = q1 = 0.0
    max_sigma = 0.0
    max_val = 0
    eps = float(np.finfo(np.float32).eps)
    for i in range(256):
        p_i = hist[i] * scale
        mu1 *= q1
        q1 += p_i
        q2 = 1.0 - q1
        if min(q1, q2) < eps or max(q1, q2) > 1.0 - eps:
            continue
        mu1 = (mu1 + i * p_i) / q1
        mu2 = (mu - q1 * mu1) / q2
        sigma = q1 * q2 * (mu1 - mu2) * (mu1 - mu2)
        if sigma > max_sigma:
            max_sigma, max_val = sigma, i
    return max_val


def threshold_otsu_inv(gray: np.ndarray) -> np.ndarray:
    """``cv2.threshold(gray, 0, 255, THRESH_BINARY_INV + THRESH_OTSU)[1]``."""
    return np.where(gray > otsu_threshold(gray), np.uint8(0), np.uint8(255))


def ellipse_element(ksize: int) -> np.ndarray:
    """``cv2.getStructuringElement(MORPH_ELLIPSE, (ksize, ksize))`` as bool:
    row i spans the centre column +- round(c * sqrt((r^2 - dy^2) / r^2))."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    elem = np.zeros((ksize, ksize), bool)
    for i in range(ksize):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        elem[i, max(c - dx, 0):min(c + dx + 1, ksize)] = True
    return elem


def dilate_ellipse(mask: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.dilate(mask, getStructuringElement(MORPH_ELLIPSE, (ksize,
    ksize)))`` for a uint8 mask and an odd ksize (outside the image counts
    as nothing). The element's rows narrow away from its centre, so it is
    the union of one rectangle per row half-width, and the dilation the
    maximum of separable rectangle dilations."""
    half = ellipse_element(ksize).sum(axis=1) // 2
    r = ksize // 2
    out = np.zeros_like(mask)
    for d in np.unique(half):
        reach = int(np.abs(np.flatnonzero(half >= d) - r).max())
        rect = ndimage.maximum_filter1d(mask, 2 * int(d) + 1, axis=1, mode="constant")
        rect = ndimage.maximum_filter1d(rect, 2 * reach + 1, axis=0, mode="constant")
        np.maximum(out, rect, out=out)
    return out
