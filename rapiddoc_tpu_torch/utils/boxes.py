"""Axis-aligned box geometry used across the pipeline.

Boxes are [x0, y0, x1, y1] in page/image pixel coordinates, x1 > x0, y1 > y0.
Vectorized numpy variants are provided for the hot host-side paths
(capability parity with reference rapid_doc/utils/boxbase.py, re-designed
around batch numpy ops instead of per-pair Python loops).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

Box = Sequence[float]


def area(box: Box) -> float:
    return max(0.0, box[2] - box[0]) * max(0.0, box[3] - box[1])


def intersection(a: Box, b: Box) -> tuple[float, float, float, float] | None:
    x0, y0 = max(a[0], b[0]), max(a[1], b[1])
    x1, y1 = min(a[2], b[2]), min(a[3], b[3])
    if x1 <= x0 or y1 <= y0:
        return None
    return (x0, y0, x1, y1)


def intersection_area(a: Box, b: Box) -> float:
    inter = intersection(a, b)
    return area(inter) if inter else 0.0


def iou(a: Box, b: Box) -> float:
    ia = intersection_area(a, b)
    if ia <= 0:
        return 0.0
    return ia / (area(a) + area(b) - ia)


def overlap_ratio(inner: Box, outer: Box) -> float:
    """Fraction of `inner`'s area covered by `outer`."""
    a = area(inner)
    if a <= 0:
        return 0.0
    return intersection_area(inner, outer) / a


def contains(outer: Box, inner: Box, tol: float = 0.0) -> bool:
    return (
        inner[0] >= outer[0] - tol
        and inner[1] >= outer[1] - tol
        and inner[2] <= outer[2] + tol
        and inner[3] <= outer[3] + tol
    )


def merge(a: Box, b: Box) -> list[float]:
    return [min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3])]


def merge_all(boxes: Sequence[Box]) -> list[float]:
    arr = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    return [
        float(arr[:, 0].min()),
        float(arr[:, 1].min()),
        float(arr[:, 2].max()),
        float(arr[:, 3].max()),
    ]


def center(box: Box) -> tuple[float, float]:
    return ((box[0] + box[2]) / 2.0, (box[1] + box[3]) / 2.0)


def center_distance(a: Box, b: Box) -> float:
    (ax, ay), (bx, by) = center(a), center(b)
    return float(np.hypot(ax - bx, ay - by))


def edge_distance(a: Box, b: Box) -> float:
    """Minimum distance between two boxes (0 when they overlap/touch)."""
    dx = max(0.0, max(a[0], b[0]) - min(a[2], b[2]))
    dy = max(0.0, max(a[1], b[1]) - min(a[3], b[3]))
    return float(np.hypot(dx, dy))


def x_overlap(a: Box, b: Box) -> float:
    return max(0.0, min(a[2], b[2]) - max(a[0], b[0]))


def y_overlap(a: Box, b: Box) -> float:
    return max(0.0, min(a[3], b[3]) - max(a[1], b[1]))


def x_overlap_ratio(a: Box, b: Box) -> float:
    """Horizontal overlap relative to the narrower box."""
    w = min(a[2] - a[0], b[2] - b[0])
    return x_overlap(a, b) / w if w > 0 else 0.0


def y_overlap_ratio(a: Box, b: Box) -> float:
    h = min(a[3] - a[1], b[3] - b[1])
    return y_overlap(a, b) / h if h > 0 else 0.0


# --- vectorized ---

def iou_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """Pairwise IoU, shape [len(a), len(b)]."""
    a = np.asarray(boxes_a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, dtype=np.float64).reshape(-1, 4)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    area_b = np.clip(b[:, 2] - b[:, 0], 0, None) * np.clip(b[:, 3] - b[:, 1], 0, None)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def overlap_matrix(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """[i, j] = fraction of box a_i covered by box b_j."""
    a = np.asarray(boxes_a, dtype=np.float64).reshape(-1, 4)
    b = np.asarray(boxes_b, dtype=np.float64).reshape(-1, 4)
    x0 = np.maximum(a[:, None, 0], b[None, :, 0])
    y0 = np.maximum(a[:, None, 1], b[None, :, 1])
    x1 = np.minimum(a[:, None, 2], b[None, :, 2])
    y1 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x1 - x0, 0, None) * np.clip(y1 - y0, 0, None)
    area_a = np.clip(a[:, 2] - a[:, 0], 0, None) * np.clip(a[:, 3] - a[:, 1], 0, None)
    return inter / np.maximum(area_a[:, None], 1e-12)


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.5) -> list[int]:
    """Greedy NMS on the host; returns kept indices in score order."""
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    order = np.argsort(-np.asarray(scores))
    keep: list[int] = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    ious = iou_matrix(boxes, boxes)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        suppressed |= ious[i] > iou_threshold
        suppressed[i] = True
    return keep


def expand(box: Box, dx: float, dy: float | None = None) -> list[float]:
    if dy is None:
        dy = dx
    return [box[0] - dx, box[1] - dy, box[2] + dx, box[3] + dy]


def clip_to(box: Box, width: float, height: float) -> list[float]:
    return [
        float(np.clip(box[0], 0, width)),
        float(np.clip(box[1], 0, height)),
        float(np.clip(box[2], 0, width)),
        float(np.clip(box[3], 0, height)),
    ]


def is_valid(box: Box) -> bool:
    return box[2] > box[0] and box[3] > box[1]


def quad_to_box(quad: np.ndarray) -> list[float]:
    """4x2 polygon points -> bounding [x0,y0,x1,y1]."""
    q = np.asarray(quad, dtype=np.float64).reshape(-1, 2)
    return [float(q[:, 0].min()), float(q[:, 1].min()), float(q[:, 0].max()), float(q[:, 1].max())]


def box_to_quad(box: Box) -> np.ndarray:
    x0, y0, x1, y1 = box
    return np.array([[x0, y0], [x1, y0], [x1, y1], [x0, y1]], dtype=np.float32)
