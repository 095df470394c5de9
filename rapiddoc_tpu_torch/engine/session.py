"""TorchSession: the inference-engine layer of the port.

Port of ``JaxSession`` (``rapiddoc_tpu/engine/session.py:212``): one
model forward over bucket-padded NHWC batches, with the same
``dispatch`` / ``fetch`` / ``fetch_rows`` / ``__call__`` contract.
Weights go to the device once, in the policy dtype (bf16 unless the
caller asks for another, as ``commit_params`` does). ``preproc`` runs on
the device before the compute-dtype cast, so callers ship uint8 (or
packed 4-bit) batches. PyTorch runs eagerly, so nothing is compiled
per bucket; the first dispatch of each bucket signature stands in for
the JAX compile: ``SessionStats.compiles`` counts it, and the first
dispatch of a signature in the process counts the bucket's cost
(``engine/flops.py``). No CUDA graph yet. ``session_stats_report``,
``measure_wire_bandwidth`` and ``transfer_split_report`` are the JAX
package's (``:136-213``).
"""
from __future__ import annotations

import os
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from . import flops
from .buckets import BucketSpec


@dataclass
class SessionStats:
    compiles: int = 0
    calls: int = 0
    items: int = 0
    padded_items: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    fetches: int = 0

    def as_dict(self) -> dict:
        return {
            "compiles": self.compiles,
            "calls": self.calls,
            "items": self.items,
            "padded_items": self.padded_items,
            "pad_overhead": (self.padded_items / self.items - 1.0)
            if self.items
            else 0.0,
            "bytes_in": self.bytes_in,
            "bytes_out": self.bytes_out,
            "fetches": self.fetches,
        }


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device the caller names, else the card, or the CPU where
    ``RAPIDDOC_PLATFORM`` (or ``MINERU_PLATFORM``) says ``cpu``, as the JAX
    package's ``_force_platform`` reads it; raises if CUDA is asked for
    and missing."""
    if device is None:
        plat = os.environ.get("RAPIDDOC_PLATFORM") or os.environ.get("MINERU_PLATFORM") or ""
        device = "cpu" if plat.strip().lower() == "cpu" else "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


# every live TorchSession, oldest first (weak: a dropped model stack
# takes its sessions with it)
_ALL_SESSIONS: list[weakref.ref] = []


def live_sessions() -> list["TorchSession"]:
    alive = [s for s in (r() for r in _ALL_SESSIONS) if s is not None]
    _ALL_SESSIONS[:] = [weakref.ref(s) for s in alive]
    return alive


def session_stats_report() -> dict[str, dict]:
    """Transfer and compile accounting of every live TorchSession, by
    name (a later session of one name wins, as in the JAX package)."""
    return {s.name: s.stats.as_dict() for s in live_sessions()}


_WIRE_BW: dict | None = None


def _timed(fn) -> float:
    tic = time.perf_counter()
    fn()
    return time.perf_counter() - tic


def measure_wire_bandwidth(size_mb: int = 8, iters: int = 3) -> dict:
    """One-shot host<->card calibration (cached): pinned host-to-device
    and device-to-host MB/s of a bulk uint8 buffer (a fresh device tensor
    each iteration) and the round trip of a tiny one, each copy closed by
    ``torch.cuda.synchronize()``. With these constants and the byte
    counters of SessionStats the bench splits stage walls into transfer
    and compute. Without a card every value is None."""
    global _WIRE_BW
    if _WIRE_BW is not None:
        return _WIRE_BW
    if not torch.cuda.is_available():
        _WIRE_BW = {"h2d_mb_per_s": None, "d2h_mb_per_s": None, "roundtrip_ms": None}
        return _WIRE_BW
    n = size_mb << 20
    sync = torch.cuda.synchronize
    host = torch.from_numpy(
        np.random.default_rng(0).integers(0, 255, n, dtype=np.uint8)).pin_memory()
    dev = host.to("cuda")
    sync()
    h2d = min(_timed(lambda: (host.to("cuda", non_blocking=True), sync()))
              for _ in range(iters))
    d2h, rt = [], []
    tiny = torch.zeros(8, dtype=torch.uint8, device="cuda")
    for i in range(iters):
        fresh = dev + (i + 1)
        small = tiny + (i + 1)
        sync()
        d2h.append(_timed(lambda: (fresh.cpu(), sync())))
        rt.append(_timed(lambda: (small.cpu(), sync())))
    _WIRE_BW = {
        "h2d_mb_per_s": size_mb / max(h2d, 1e-9),
        "d2h_mb_per_s": size_mb / max(min(d2h), 1e-9),
        "roundtrip_ms": min(rt) * 1e3,
    }
    return _WIRE_BW


def transfer_split_report() -> dict[str, dict]:
    """Per-session estimated transfer cost from the measured wire
    constants times the byte counters: {session: {transfer_ms_est,
    bytes_in, bytes_out, fetches}}. transfer_ms_est is a serialized upper
    bound (transfers overlap compute, so a stage's wall can be below it;
    the bench caps it at the wall); None without a card."""
    bw = measure_wire_bandwidth()
    out = {}
    for s in live_sessions():
        st = s.stats
        ms = None
        if bw["h2d_mb_per_s"] is not None:
            ms = (st.bytes_in / (1 << 20) / bw["h2d_mb_per_s"] * 1e3
                  + st.bytes_out / (1 << 20) / bw["d2h_mb_per_s"] * 1e3
                  + st.fetches * bw["roundtrip_ms"])
        out[s.name] = {"transfer_ms_est": ms, "bytes_in": st.bytes_in,
                       "bytes_out": st.bytes_out, "fetches": st.fetches}
    return out


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


class TorchSession:
    """Bucketed forward pass over NHWC image batches.

    ``apply_fn(module, x)`` returns a tensor or a dict/tuple of tensors
    whose leading dim is the batch dim."""

    def __init__(
        self,
        apply_fn: Callable[[torch.nn.Module, torch.Tensor], Any],
        module: torch.nn.Module,
        bucket_spec: BucketSpec,
        *,
        name: str = "model",
        device: str | torch.device | None = None,
        dtype: torch.dtype | None = None,
        preproc: Callable[[torch.Tensor], torch.Tensor] | None = None,
    ):
        self.name = name
        self.apply_fn = apply_fn
        self.bucket_spec = bucket_spec
        self.device = resolve_device(device)
        self.compute_dtype = torch.bfloat16 if dtype is None else dtype
        self.preproc = preproc
        self.stats = SessionStats()
        self.module = module.to(device=self.device, dtype=self.compute_dtype).eval()
        self._seen: set[tuple] = set()  # bucket signatures dispatched
        self._lock = threading.Lock()
        _ALL_SESSIONS.append(weakref.ref(self))

    @torch.no_grad()
    def dispatch(self, batch_nhwc: np.ndarray) -> tuple[Any, int, "TorchSession"]:
        """Enqueue the forward pass; returns (device_output, n, session)
        without waiting for the device. Batches larger than the biggest
        bucket run as bucket-sized chunks concatenated on the device."""
        n = batch_nhwc.shape[0]
        max_b = self.bucket_spec.max_batch()
        if n > max_b:
            parts = [
                self.dispatch(batch_nhwc[i : i + max_b])
                for i in range(0, n, max_b)
            ]
            outs = [_map(lambda a, k=p[1]: a[:k], p[0]) for p in parts]
            merged = _map_many(lambda *xs: torch.cat(xs, 0), outs)
            return merged, n, self
        nb = self.bucket_spec.bucket_batch(n)
        if nb != n:
            pad = np.zeros((nb - n,) + batch_nhwc.shape[1:], batch_nhwc.dtype)
            batch_nhwc = np.concatenate([batch_nhwc, pad], axis=0)
        key = (nb, *batch_nhwc.shape[1:], str(batch_nhwc.dtype))
        with self._lock:
            if key not in self._seen:
                self._seen.add(key)
                self.stats.compiles += 1
        # the bucket's cost is counted on the first dispatch of its
        # signature in the process (engine/flops.py)
        out = flops.track(self.name, self._forward, (batch_nhwc,),
                          sig=key + (str(self.compute_dtype),), weights=self.module)
        self.stats.calls += 1
        self.stats.items += n
        self.stats.padded_items += nb
        self.stats.bytes_in += batch_nhwc.nbytes
        for leaf in _leaves(out):
            self.stats.bytes_out += leaf.numel() * leaf.element_size() * n // nb
        return out, n, self

    def _forward(self, batch_nhwc: np.ndarray) -> Any:
        x = torch.from_numpy(np.ascontiguousarray(batch_nhwc))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        if self.preproc is not None:
            x = self.preproc(x)
        out = self.apply_fn(self.module, x.to(self.compute_dtype))
        return _map(lambda a: a.float() if a.is_floating_point() else a, out)

    @staticmethod
    def fetch(handle: tuple) -> Any:
        """Materialize a dispatch() result on the host, sliced to true n."""
        out, n, sess = handle
        sess.stats.fetches += 1
        return _map(lambda a: a[:n].cpu().numpy(), out)

    @classmethod
    def fetch_rows(cls, handles: Sequence[tuple]) -> list[Any]:
        """Fetch several dispatch() handles and split them into per-row
        outputs of the same structure."""
        rows: list[Any] = []
        for handle in handles:
            fetched = cls.fetch(handle)
            n = handle[1]
            rows.extend(_map(lambda a, j=j: a[j], fetched) for j in range(n))
        return rows

    def __call__(self, batch_nhwc: np.ndarray) -> Any:
        """Run the forward pass on an already-bucketed NHWC batch."""
        return self.fetch(self.dispatch(batch_nhwc))


def _map_many(fn, trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map_many(fn, [t[k] for t in trees]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(
            _map_many(fn, [t[i] for t in trees]) for i in range(len(first))
        )
    return fn(*trees)
