"""TorchSession: the inference-engine layer of the port.

Port of ``JaxSession`` (``rapiddoc_tpu/engine/session.py:212``): one
model forward over bucket-padded NHWC batches, with the same
``dispatch`` / ``fetch`` / ``fetch_rows`` / ``__call__`` contract.
Weights go to the device once, in the policy dtype (bf16 unless the
caller asks for another, as ``commit_params`` does). ``preproc`` runs on
the device before the compute-dtype cast, so callers ship uint8 (or
packed 4-bit) batches. PyTorch runs eagerly: there is no per-bucket
compile, and no CUDA graph yet.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Callable, Sequence

import numpy as np
import torch

from .buckets import BucketSpec


@dataclass
class SessionStats:
    calls: int = 0
    items: int = 0
    padded_items: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    fetches: int = 0

    def as_dict(self) -> dict:
        return {
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
        x = torch.from_numpy(np.ascontiguousarray(batch_nhwc))
        if self.device.type == "cuda":
            x = x.pin_memory().to(self.device, non_blocking=True)
        if self.preproc is not None:
            x = self.preproc(x)
        out = self.apply_fn(self.module, x.to(self.compute_dtype))
        out = _map(
            lambda a: a.float() if a.is_floating_point() else a, out
        )
        self.stats.calls += 1
        self.stats.items += n
        self.stats.padded_items += nb
        self.stats.bytes_in += batch_nhwc.nbytes
        for leaf in _leaves(out):
            self.stats.bytes_out += leaf.numel() * leaf.element_size() * n // nb
        return out, n, self

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
