"""Recursive XY-cut reading order.

Role parity with the reference's xycut-plus
(reference: rapid_doc/model/reading_order/xycut_plus.py — recursive
projection-profile splitting); implemented from the classic algorithm with
vectorized projections. Input bboxes are [x0, y0, x1, y1]; output is the
index permutation in reading order.
"""
from __future__ import annotations

import numpy as np


def _projection_gaps(
    intervals: np.ndarray, lo: float, hi: float, min_gap: float
) -> list[tuple[float, float]]:
    """Maximal empty gaps of the 1-D union of `intervals` within [lo, hi]."""
    if len(intervals) == 0:
        return []
    order = np.argsort(intervals[:, 0])
    merged: list[list[float]] = []
    for i in order:
        s, e = float(intervals[i, 0]), float(intervals[i, 1])
        if merged and s <= merged[-1][1] + 1e-6:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = []
    for (s1, e1), (s2, e2) in zip(merged, merged[1:]):
        if s2 - e1 >= min_gap:
            gaps.append((e1, s2))
    return gaps


def _split_indices(
    boxes: np.ndarray, idxs: np.ndarray, axis: int, cuts: list[tuple[float, float]]
) -> list[np.ndarray]:
    """Partition idxs into bands separated by the cut gaps along axis."""
    edges = sorted(c[0] + (c[1] - c[0]) / 2 for c in cuts)
    centers = (boxes[idxs, axis] + boxes[idxs, axis + 2]) / 2
    bands: list[np.ndarray] = []
    lo = -np.inf
    for edge in edges + [np.inf]:
        mask = (centers >= lo) & (centers < edge)
        if mask.any():
            bands.append(idxs[mask])
        lo = edge
    return bands


def xycut_order(
    bboxes: np.ndarray | list,
    min_gap_x: float = 1.0,
    min_gap_y: float = 1.0,
) -> list[int]:
    """Return reading-order permutation of the given boxes."""
    boxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
    n = len(boxes)
    if n <= 1:
        return list(range(n))
    out: list[int] = []

    def recurse(idxs: np.ndarray, depth: int) -> None:
        if len(idxs) <= 1 or depth > 64:
            out.extend(_final_sort(boxes, idxs))
            return
        sub = boxes[idxs]
        y_gaps = _projection_gaps(
            sub[:, [1, 3]], sub[:, 1].min(), sub[:, 3].max(), min_gap_y
        )
        x_gaps = _projection_gaps(
            sub[:, [0, 2]], sub[:, 0].min(), sub[:, 2].max(), min_gap_x
        )
        best_y = max(y_gaps, key=lambda g: g[1] - g[0], default=None)
        best_x = max(x_gaps, key=lambda g: g[1] - g[0], default=None)
        if best_y is None and best_x is None:
            out.extend(_final_sort(boxes, idxs))
            return
        # Classic recursion: one cut at the widest gap, then recurse both
        # halves. A column gutter (x gap) wider than the best row gap wins,
        # so columns are read fully before moving right; otherwise cut rows
        # top-down first.
        wy = best_y[1] - best_y[0] if best_y else 0.0
        wx = best_x[1] - best_x[0] if best_x else 0.0
        if wy >= wx:
            axis, gap = 1, best_y
        else:
            axis, gap = 0, best_x
        bands = _split_indices(boxes, idxs, axis, [gap])
        bands.sort(key=lambda b: boxes[b, axis].min())
        if len(bands) <= 1:
            out.extend(_final_sort(boxes, idxs))
            return
        for band in bands:
            recurse(band, depth + 1)

    recurse(np.arange(n), 0)
    return out


def _final_sort(boxes: np.ndarray, idxs: np.ndarray) -> list[int]:
    """No clean cut available: sort by (row-ish y, then x)."""
    sub = boxes[idxs]
    heights = np.maximum(sub[:, 3] - sub[:, 1], 1e-6)
    med_h = float(np.median(heights))
    rows = np.round(sub[:, 1] / max(med_h * 0.7, 1e-6))
    order = np.lexsort((sub[:, 0], rows))
    return [int(idxs[i]) for i in order]


def sort_boxes_reading_order(bboxes) -> list[int]:
    """Public helper: XY-cut with sane defaults scaled to content size."""
    boxes = np.asarray(bboxes, dtype=np.float64).reshape(-1, 4)
    if len(boxes) == 0:
        return []
    heights = np.maximum(boxes[:, 3] - boxes[:, 1], 1.0)
    med_h = float(np.median(heights))
    return xycut_order(boxes, min_gap_x=med_h * 0.5, min_gap_y=med_h * 0.3)
