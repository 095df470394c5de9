"""Per-stage timing/observability.

The reference only has ad-hoc perf_counter fields (SURVEY.md §5); here
stage timings are collected centrally so ms/page metrics fall out for free.
Copy of the JAX package's module without its jax.profiler hook.
"""
from __future__ import annotations

import contextlib
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
