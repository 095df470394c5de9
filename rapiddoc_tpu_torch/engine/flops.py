"""Analytic FLOPs / bytes accounting for every program of the port.

Port of ``rapiddoc_tpu/engine/flops.py``: each program (a session's
bucket, an engine's decode, the ONNX interpreter's graph) gets a cost
once per shape signature, its calls are counted, and the bench joins the
totals with the tracer's stage walls into achieved FLOP/s, MFU against
the card's peak and a compute-bound ms projection. The functions and the
report keys are the JAX package's.

The counting rule (XLA's HLO cost analysis has no PyTorch counterpart):

- **FLOPs** are 2 x the multiply-adds of every convolution, matmul and
  attention a program runs, as ``torch.utils.flop_counter.FlopCounterMode``
  counts them, taken on the program's first call for each shape
  signature: that call is the counterpart of the JAX compile, and no
  second forward runs to count. Elementwise work, reductions, gathers and
  resampling count nothing. XLA's count differs: it counts elementwise
  ops, and leaves out the taps a padded convolution spends on its border
  (``tests/test_torch_flops.py`` holds the ratio in a band).
- **The hand-written kernels** run outside the dispatcher (ctypes), so
  their wrappers add an analytic count from shapes: K1
  (``ops/ctc_head.py``) 2·N·C·V, K2 (``ops/quant_head.py``) 2·N·K·V. Their
  plain versions, which CPU tensors take, run uncounted, so a program
  counts the same whichever runs.
- **Bytes** are the least traffic a call must make: every weight it reads
  once, plus its inputs and outputs. The bound does not depend on how the
  program is implemented.
- **Autoregressive decodes** keep the JAX package's scheme: a program's
  cost holds its encoder and ONE decode step (the loops run their later
  steps under :func:`uncounted`, as XLA counts a ``while_loop`` body
  once), and :func:`track_ar_extra` adds 2·dec_params·batch FLOPs and
  dec_param_bytes bytes for each further step.

Peaks come from :data:`PEAKS`, keyed by ``torch.cuda.get_device_name()``;
on the CPU or a card not in the table ``mfu`` is None and the report's
note says why.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable

import numpy as np
import torch

_LOCK = threading.Lock()
# (name, sig) -> {"flops": float, "bytes": float}
_COSTS: dict[tuple, dict | None] = {}
# (name, sig) -> weighted call count (weight = AR steps when known)
_CALLS: dict[tuple, float] = {}
_AR_EXTRA: dict[str, dict] = {}
_TLS = threading.local()

# torch.cuda.get_device_name() -> (dense bf16 FLOP/s, HBM bytes/s), from
# NVIDIA's H100 Tensor Core GPU datasheet: H100 SXM5 (700 W power limit),
# 989.4 TFLOP/s bf16 without sparsity, 3.35 TB/s HBM3. MFU is taken
# against the bf16 peak in every dtype, as the JAX package's report does.
PEAKS: dict[str, tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989.4e12, 3.35e12),
}


def device_peaks(device: str | torch.device | None = None) -> tuple[float, float] | None:
    """(peak FLOP/s, HBM bytes/s) of the card ``device`` names (the
    current card by default); None on the CPU or a card not in PEAKS."""
    if device is not None and torch.device(device).type != "cuda":
        return None
    if not torch.cuda.is_available():
        return None
    return PEAKS.get(torch.cuda.get_device_name(device))


class _Count:
    """One counting pass: the dispatcher's count plus the kernels'."""

    def __init__(self) -> None:
        from torch.utils.flop_counter import FlopCounterMode

        self.mode = FlopCounterMode(display=False)
        self.analytic = 0
        self.paused = False

    @property
    def flops(self) -> int:
        return self.mode.get_total_flops() + self.analytic


@contextlib.contextmanager
def uncounted(active: bool = True):
    """The ops inside count nothing in this thread's counting pass (when
    ``active`` and a pass is open): the kernels' plain versions, a decode's
    steps after its first, a program called inside another."""
    c = getattr(_TLS, "count", None)
    if not active or c is None or c.paused:
        yield
        return
    from torch.utils._python_dispatch import _disable_current_modes

    c.paused = True
    try:
        with _disable_current_modes():
            yield
    finally:
        c.paused = False


@contextlib.contextmanager
def counting():
    """Count the FLOPs of what runs inside on this thread; yields the
    count (read ``.flops`` after the block). A pass open around it is
    paused, so a program called inside another counts only for itself."""
    outer = getattr(_TLS, "count", None)
    c = _Count()
    with uncounted(outer is not None):
        _TLS.count = c
        try:
            with c.mode:
                yield c
        finally:
            _TLS.count = outer


def add_flops(n: float) -> None:
    """A hand-written kernel's analytic FLOPs, into the open counting
    pass of this thread (no-op without one, or while it is paused)."""
    c = getattr(_TLS, "count", None)
    if c is not None and not c.paused:
        c.analytic += int(n)


def nbytes(tree: Any) -> int:
    """Bytes of every tensor or array in ``tree`` (modules: their
    parameters and buffers; dicts, lists and tuples walked)."""
    if isinstance(tree, torch.nn.Module):
        return sum(t.numel() * t.element_size()
                   for t in (*tree.parameters(), *tree.buffers()))
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return int(tree.nbytes)
    if isinstance(tree, dict):
        return sum(nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(nbytes(v) for v in tree)
    return 0


def _sig_of(args: tuple) -> tuple:
    return tuple(
        (tuple(a.shape), str(a.dtype)) if hasattr(a, "shape") and hasattr(a, "dtype")
        else ("static", repr(a))
        for a in args
    )


def track(name: str, fn: Callable, args: tuple, *, steps: float = 1.0,
          sig: tuple | None = None, weights: Any = ()) -> Any:
    """Run ``fn(*args)``, count the call under ``name`` and return its
    output.

    The JAX package's ``track`` only records (XLA's analysis runs lazily
    on the lowered program); here the first call for each (name, sig)
    runs under the counter instead, and its cost is kept: the FLOPs it
    counted, and as bytes ``weights`` (modules or tensors, each read once)
    plus the arguments and the output. ``steps`` weights the call; ``sig``
    names what distinguishes shapes (default: the arguments' shapes and
    dtypes)."""
    key = (name, sig if sig is not None else _sig_of(args))
    with _LOCK:
        known = key in _COSTS
    if known:
        out = fn(*args)
    else:
        with counting() as c:
            out = fn(*args)
        register_compiled(name, key[1], {
            "flops": float(c.flops),
            "bytes": float(nbytes(weights) + nbytes(args) + nbytes(out)),
        })
    count(name, key[1], steps)
    return out


def track_ar_extra(name: str, *, steps: float, batch: int,
                   dec_params: float, dec_param_bytes: float) -> None:
    """The decode steps after the first of an autoregressive program.

    The program's recorded cost covers encoder + one decode step. The
    remaining (steps - 1) steps are added here: 2·dec_params FLOPs per
    token per sample (the dense-matmul MAC identity) and one full decoder
    weight read per step. ``steps`` is the realized decode length (the
    largest length of the padded batch), as in the JAX package."""
    extra_steps = max(steps - 1.0, 0.0)
    with _LOCK:
        d = _AR_EXTRA.setdefault(name, {"flops": 0.0, "bytes": 0.0})
        d["flops"] += 2.0 * dec_params * batch * extra_steps
        d["bytes"] += dec_param_bytes * extra_steps


def register_compiled(name: str, sig: tuple, cost: dict | None) -> None:
    """Record the cost of (name, sig), taken on its first call (a
    session's first dispatch of a bucket); kept if one is recorded."""
    with _LOCK:
        _COSTS.setdefault((name, sig), cost)


def count(name: str, sig: tuple, steps: float = 1.0) -> None:
    """Count one call against a cost recorded by register_compiled."""
    with _LOCK:
        _CALLS[(name, sig)] = _CALLS.get((name, sig), 0.0) + steps


def cost_report() -> dict[str, dict]:
    """{name: {flops, bytes, calls, analyzed, unanalyzed}}: aggregated
    over all shape signatures seen for that name. flops/bytes are
    call-weighted totals since process start (or the last reset())."""
    out: dict[str, dict] = {}

    def entry(name: str) -> dict:
        return out.setdefault(name, {"flops": 0.0, "bytes": 0.0, "calls": 0.0,
                                     "analyzed": 0, "unanalyzed": 0})

    with _LOCK:
        for (name, sig), calls in _CALLS.items():
            d = entry(name)
            d["calls"] += calls
            cost = _COSTS.get((name, sig))
            if cost is None:
                d["unanalyzed"] += 1
            else:
                d["analyzed"] += 1
                d["flops"] += cost["flops"] * calls
                d["bytes"] += cost["bytes"] * calls
        for name, extra in _AR_EXTRA.items():
            d = entry(name)
            d["flops"] += extra["flops"]
            d["bytes"] += extra["bytes"]
            d["ar_analytic"] = True
    return out


def reset() -> None:
    """Zero the call counters (the costs are kept: they are
    shape-determined and reusable)."""
    with _LOCK:
        _CALLS.clear()
        _AR_EXTRA.clear()


def mfu_report(stage_wall_s: dict[str, float],
               stage_names: dict[str, str] | None = None,
               device: str | torch.device | None = None) -> dict:
    """Join the costs with measured stage walls.

    ``stage_wall_s``: {stage: seconds} from the tracer. ``stage_names``:
    {program name -> stage} (defaults to identity). ``device``: where the
    programs ran (default: the current card). Returns per-stage {gflops,
    achieved_tflops, mfu, compute_bound_ms} plus the totals;
    ``compute_bound_ms`` = flops / peak + bytes / HBM rate, what the stage
    would cost on the card's peaks. Without known peaks ``mfu``,
    ``compute_bound_ms`` and the peak are None."""
    peaks = device_peaks(device)
    peak, bw = peaks if peaks else (None, None)
    per_stage: dict[str, dict] = {}
    for name, c in cost_report().items():
        stage = (stage_names or {}).get(name, name)
        d = per_stage.setdefault(stage, {"flops": 0.0, "bytes": 0.0})
        d["flops"] += c["flops"]
        d["bytes"] += c["bytes"]
    out: dict[str, Any] = {"stages": {}}
    tot_flops = 0.0
    for stage, d in per_stage.items():
        wall = stage_wall_s.get(stage)
        achieved = d["flops"] / wall if wall else None
        out["stages"][stage] = {
            "gflops": d["flops"] / 1e9,
            "achieved_tflops": achieved / 1e12 if achieved is not None else None,
            "mfu": achieved / peak if achieved is not None and peak else None,
            "compute_bound_ms": (d["flops"] / peak + d["bytes"] / bw) * 1e3 if peaks else None,
        }
        tot_flops += d["flops"]
    wall_total = sum(v for v in stage_wall_s.values() if v)
    out["total_gflops"] = tot_flops / 1e9
    if wall_total:
        out["mfu_total"] = tot_flops / wall_total / peak if peak else None
    out["chip_peak_tflops_bf16"] = peak / 1e12 if peak else None
    out["note"] = (
        "flops are 2 x the multiply-adds of convolutions, matmuls and "
        "attention (FlopCounterMode on each program's first call, the "
        "kernels' analytic counts); AR decoders add their steps after the "
        "first through track_ar_extra"
        + ("" if peaks else "; no peak is known for this device, so mfu is None")
    )
    return out
