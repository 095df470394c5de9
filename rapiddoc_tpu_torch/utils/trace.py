"""Per-stage timing/observability.

The reference only has ad-hoc perf_counter fields (SURVEY.md §5); here
stage timings are collected centrally so ms/page metrics fall out for free.
Copy of the JAX package's module; ``maybe_profile`` is its
``maybe_jax_profile`` on ``torch.profiler``.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class StageStats:
    total_s: float = 0.0
    items: int = 0
    calls: int = 0

    def ms_per_item(self) -> float:
        return self.total_s * 1000.0 / self.items if self.items else 0.0


class Tracer:
    def __init__(self) -> None:
        self._stats: dict[str, StageStats] = defaultdict(StageStats)
        self._lock = threading.Lock()

    def record(self, stage: str, seconds: float, items: int) -> None:
        with self._lock:
            s = self._stats[stage]
            s.total_s += seconds
            s.items += items
            s.calls += 1

    def report(self) -> dict[str, dict]:
        with self._lock:
            return {
                k: {
                    "total_s": round(v.total_s, 4),
                    "items": v.items,
                    "calls": v.calls,
                    "ms_per_item": round(v.ms_per_item(), 3),
                }
                for k, v in self._stats.items()
            }

    def reset(self) -> None:
        with self._lock:
            self._stats.clear()


GLOBAL_TRACER = Tracer()


@contextlib.contextmanager
def stage_timer(stage: str, items: int = 1):
    tic = time.perf_counter()
    try:
        yield
    finally:
        GLOBAL_TRACER.record(stage, time.perf_counter() - tic, items)


@contextlib.contextmanager
def maybe_profile(out_dir: str | None = None):
    """A ``torch.profiler`` trace of the block when ``out_dir``,
    ``RAPIDDOC_PROFILE_DIR`` or ``RAPIDDOC_PROFILE`` is set: the host's
    ops, and the card's kernels where there is one, written as a Chrome
    trace ``trace_<pid>_<n>.json`` into the directory (default
    ``rapiddoc_profile`` under the temporary directory)."""
    target = out_dir or os.environ.get("RAPIDDOC_PROFILE_DIR")
    if not target and not os.environ.get("RAPIDDOC_PROFILE"):
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    target = target or os.path.join(tempfile.gettempdir(), "rapiddoc_profile")
    os.makedirs(target, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(target, f"trace_{os.getpid()}_{time.time_ns()}.json"))
