"""Shape buckets: every model runs on a small closed set of padded shapes.

Port of ``rapiddoc_tpu/engine/buckets.py`` (``BucketSpec``,
``DET_BUCKETS``, ``REC_BUCKETS``, ``pad_rows``, ``batch_chunks``,
``group_by_bucket``) and of
``pad_image_to`` from ``rapiddoc_tpu/engine/session.py:556``. The port
keeps its own copy so that it imports nothing of the JAX package. A
closed shape set keeps the door open for one CUDA graph per bucket.
"""
from __future__ import annotations

import bisect
import math
from dataclasses import dataclass
from typing import Sequence

import numpy as np


def _ceil_to(value: int, step: int, lo: int, hi: int) -> int:
    v = max(lo, min(hi, value))
    return min(hi, int(math.ceil(v / step)) * step)


@dataclass(frozen=True)
class BucketSpec:
    """Defines the closed shape set for one model's inputs."""

    # spatial buckets: explicit sorted edge lists, or stride-generated
    heights: tuple[int, ...] = ()
    widths: tuple[int, ...] = ()
    stride: int = 128
    min_side: int = 128
    max_side: int = 1024
    batch_sizes: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)

    def bucket_dim(self, value: int, edges: tuple[int, ...]) -> int:
        if edges:
            idx = bisect.bisect_left(edges, min(value, edges[-1]))
            return edges[min(idx, len(edges) - 1)]
        return _ceil_to(value, self.stride, self.min_side, self.max_side)

    def bucket_hw(self, h: int, w: int) -> tuple[int, int]:
        return (self.bucket_dim(h, self.heights), self.bucket_dim(w, self.widths))

    def bucket_batch(self, n: int) -> int:
        for b in self.batch_sizes:
            if n <= b:
                return b
        return self.batch_sizes[-1]

    def max_batch(self) -> int:
        return self.batch_sizes[-1]


DET_BUCKETS = BucketSpec(stride=160, min_side=320, max_side=1280,
                         batch_sizes=(1, 2, 4))
REC_BUCKETS = BucketSpec(
    heights=(48,),
    widths=(160, 320, 640),
    batch_sizes=(32, 128),
)


def pad_rows(batch: np.ndarray, target: int) -> np.ndarray:
    """Pad axis 0 to ``target`` rows by repeating the last row (real
    pixels keep the padded rows on the ordinary numeric path; their
    results are sliced off)."""
    n = batch.shape[0]
    if n == target:
        return batch
    return np.concatenate(
        [batch, np.repeat(batch[-1:], target - n, axis=0)], axis=0
    )


def batch_chunks(
    n: int, sizes: tuple[int, ...] = (1, 2, 4, 8, 16)
) -> list[tuple[int, int, int]]:
    """Split n rows into (start, stop, padded_size) chunks whose padded
    sizes all come from the closed ``sizes`` set."""
    out: list[tuple[int, int, int]] = []
    start = 0
    mx = sizes[-1]
    while start < n:
        take = min(mx, n - start)
        padded = next(b for b in sizes if take <= b)
        out.append((start, start + take, padded))
        start += take
    return out


def group_by_bucket(
    shapes: Sequence[tuple[int, int]], spec: BucketSpec
) -> dict[tuple[int, int], list[int]]:
    """Group item indices by their (H, W) bucket."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, (h, w) in enumerate(shapes):
        groups.setdefault(spec.bucket_hw(h, w), []).append(i)
    return groups


def pad_image_to(
    img: np.ndarray, target_h: int, target_w: int, pad_value: float = 0.0
) -> np.ndarray:
    """Bottom/right-pad an HWC image to the bucket shape."""
    h, w = img.shape[:2]
    if h == target_h and w == target_w:
        return img
    out = np.full(
        (target_h, target_w) + img.shape[2:], pad_value, dtype=img.dtype
    )
    out[:h, :w] = img[: target_h, : target_w]
    return out
