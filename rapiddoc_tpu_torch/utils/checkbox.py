"""Checkbox detection + ticked/unticked classification.

Port of ``rapiddoc_tpu/utils/checkbox.py`` (reference:
rapid_doc/utils/checkbox_det_cls.py:6-132 — square detection, ink-density
tick classification), its OpenCV calls replayed in numpy:
``cvtColor(RGB2GRAY)`` by ``models/ocr/pre_post.rgb_to_gray``,
``adaptiveThreshold(MEAN_C, THRESH_BINARY_INV, 15, 10)`` by
``utils/morph.adaptive_threshold_mean``, and ``findContours(RETR_LIST,
CHAIN_APPROX_SIMPLE)``, ``boundingRect``, ``approxPolyDP``,
``arcLength``, ``isContourConvex`` and ``contourArea`` by
``utils/contours``. Each gives OpenCV's output, so the boxes are the JAX
package's.
"""
from __future__ import annotations

import numpy as np

from ..models.ocr.pre_post import rgb_to_gray
from .contours import (
    approx_poly_dp, arc_length, bounding_rect, contour_area, find_contours_list,
    is_contour_convex,
)
from .morph import adaptive_threshold_mean


def detect_checkboxes(
    img: np.ndarray,
    min_size: int = 8,
    max_size: int = 60,
) -> list[dict]:
    """Returns [{bbox, checked: bool}] for square checkbox-like shapes."""
    gray = rgb_to_gray(img) if img.ndim == 3 else img
    binary = adaptive_threshold_mean(gray, 255, 15, 10, inverse=True)
    results = []
    for contour, _ in find_contours_list(binary):
        x, y, w, h = bounding_rect(contour)
        if not (min_size <= w <= max_size and min_size <= h <= max_size):
            continue
        if not 0.75 <= w / max(h, 1) <= 1.33:
            continue
        approx = approx_poly_dp(contour, 0.04 * arc_length(contour))
        if len(approx) != 4 or not is_contour_convex(approx):
            continue
        area = contour_area(contour)
        if area < 0.6 * w * h:
            continue
        inner = binary[y + h // 5 : y + 4 * h // 5, x + w // 5 : x + 4 * w // 5]
        fill = float(inner.mean()) / 255.0 if inner.size else 0.0
        results.append(
            {
                "bbox": [float(x), float(y), float(x + w), float(y + h)],
                "checked": fill > 0.12,
            }
        )
    # dedup nested detections
    results.sort(key=lambda r: (r["bbox"][0], r["bbox"][1]))
    dedup: list[dict] = []
    for r in results:
        if not any(
            abs(r["bbox"][0] - d["bbox"][0]) < 4 and abs(r["bbox"][1] - d["bbox"][1]) < 4
            for d in dedup
        ):
            dedup.append(r)
    return dedup
