"""Device time of the two fused head kernels, kernel by kernel, on the card.

    python3 -m rapiddoc_tpu_torch.profile_heads [--runs N]

Traces K1 (``ops/ctc_head.py``) at the OCR rec dispatch's width (N = 10240
frames, C = 120; V = 96 and 18710) and K2 (``ops/quant_head.py``) at the
formula decode's (N = 4 and 16 rows, K = 512; V = 57 and 50000), each
weight in the layout its model reads, with torch.profiler, and prints
for every kernel launch kind its mean device time. Three cache states:
"dirty" (a 512 MB write before each call, as ``chip_smoke.py``'s
``flushed_ms`` does: the L2 holds dirty lines that the call's reads must
evict), "clean" (a 512 MB read before each call: the inputs are out of
the L2, which holds only clean lines) and "warm" (calls back to back).
The profiler's time is the kernels' own: it leaves out the gaps between
launches that CUDA events around a call include. One JSON object per
line; the card's name and power limit come first.

``bench_ctc_head`` and ``bench_quant_head`` are the bench's
(``bench.py``) head timings at the root ``bench.py``'s shapes, each
beside one PyTorch call for the same function and the kernel's bound.
"""
from __future__ import annotations

import argparse
import json
import re
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .ops.ctc_head import fused_ctc_argmax, pad_ctc_kernel
from .ops.layout import aligned_rows
from .ops.quant_head import fused_argmax_int8, quantize_weight_int8

FLUSH_BYTES = 512 << 20
HEAD_KERNELS = r"(ctc|quant)_head_[a-z]+"
# NVIDIA's H100 SXM data sheet: dense bf16 tensor rate, HBM3 bandwidth
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12


def kernel_times(call, before, runs: int, pattern: str = HEAD_KERNELS) -> dict:
    """Mean device microseconds per launch of each kernel that ``call``
    launches whose name matches ``pattern`` (by default the two heads'),
    with ``before`` (untraced kind of flush, or None) run ahead of every
    call."""
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            if before is not None:
                before()
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        name = re.search(pattern, e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name.group(0)] = e.device_time_total / max(e.count, 1)
    return out


def device_ms_per_call(call, before, runs: int, pattern: str = r".+",
                       tries: int = 3) -> float:
    """Device milliseconds a ``call`` spends in the kernels whose names
    match ``pattern`` (every kernel by default), by ``kernel_times``.
    A trace that recorded none of them (the profiler's activity buffer
    can come back empty) is taken again, up to ``tries`` times, then
    raises: a missing reading is not a zero."""
    for _ in range(tries):
        times = kernel_times(call, before, runs, pattern)
        if sum(times.values()) > 0:
            return sum(times.values()) / 1e3
    raise RuntimeError(f"the profiler recorded no kernel matching {pattern!r} in {tries} traces")


def ctc_bound_ms(n: int, c: int, v: int) -> tuple[float, str]:
    """Least time for K1 on an H100: bf16 operations 2*N*C*V against
    bytes read once (x, W bf16; b fp32) and written once (ids int32,
    conf fp32)."""
    ops = 2.0 * n * c * v
    nbytes = n * c * 2 + c * v * 2 + v * 4 + n * 8
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def quant_bound_ms(n: int, k: int, v: int) -> tuple[float, str]:
    """Least time for K2 on an H100: 2*N*K*V operations at the bf16 rate
    against bytes read once (x bf16, wq int8, scale and bias fp32) and
    written once (ids int32, conf fp32)."""
    ops = 2.0 * n * k * v
    nbytes = n * k * 2 + k * v + v * 8 + n * 8
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def bench_ctc_head(runs: int = 20) -> dict:
    """K1 at the rec engine's shape, the root ``bench.py``'s
    ``_bench_ctc_head`` (B = 128 crops x T = 40 frames, C = 120, V =
    18 710; x and W standard normal in bf16, zero bias): device ms per
    call warm (``kernel_ms``, the counterpart of its ``pallas_ms``) and
    with the L2 dirty, against one PyTorch call for the same function
    (matmul, softmax, max: ``library_ms``, its ``xla_ms``) and the
    bound."""
    b_, t_, c, v = 128, 40, 120, 18710
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((b_ * t_, c)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy(rng.standard_normal((c, v)).astype(np.float32)).cuda().bfloat16()
    b = torch.zeros(v, dtype=torch.float32, device="cuda")
    wk = pad_ctc_kernel(w)

    def library():
        return torch.softmax(torch.matmul(x, w).float() + b, dim=-1).max(dim=-1)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel_ms = device_ms_per_call(lambda: fused_ctc_argmax(x, wk, b), None, runs, HEAD_KERNELS)
    dirty_ms = device_ms_per_call(lambda: fused_ctc_argmax(x, wk, b), flush.zero_, runs,
                                  HEAD_KERNELS)
    library_ms = device_ms_per_call(library, None, runs)
    ids, _ = fused_ctc_argmax(x, wk, b)
    bound, by = ctc_bound_ms(b_ * t_, c, v)
    return {"shape": f"({b_ * t_}, {c}) x ({c}, {v})", "kernel_ms": kernel_ms,
            "kernel_ms_l2_dirty": dirty_ms, "library_ms": library_ms,
            "speedup": library_ms / max(kernel_ms, 1e-9),
            "logits_hbm_mb_avoided": b_ * t_ * v * 4 / 1e6,
            "argmax_agreement": float((ids == library().indices).float().mean()),
            "bound_ms": bound, "bound_by": by}


def bench_quant_head(runs: int = 20) -> dict:
    """K2 at the root ``bench.py``'s ``_bench_quant_head`` shape (B = 16
    decode rows, K = 512, V = 50 000; x standard normal in bf16, W normal
    x 0.05, zero bias): device ms per call warm (``kernel_ms``, its
    ``int8_fused_ms``) and with the L2 dirty, against the bf16 head
    (one matmul and an argmax: ``library_ms``, its ``xla_bf16_ms``), the
    argmax agreement of the two and the bound."""
    n, k, v = 16, 512, 50000
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32)).cuda().bfloat16()
    w = torch.from_numpy((rng.standard_normal((k, v)) * 0.05).astype(np.float32)).cuda()
    b = torch.zeros(v, dtype=torch.float32, device="cuda")
    wq, scale = quantize_weight_int8(w)
    wq = aligned_rows(wq)
    wb = w.bfloat16()

    def library():
        return (torch.matmul(x, wb).float() + b).argmax(dim=-1)

    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    kernel_ms = device_ms_per_call(lambda: fused_argmax_int8(x, wq, scale, b), None, runs,
                                   HEAD_KERNELS)
    dirty_ms = device_ms_per_call(lambda: fused_argmax_int8(x, wq, scale, b), flush.zero_,
                                  runs, HEAD_KERNELS)
    library_ms = device_ms_per_call(library, None, runs)
    ids, _ = fused_argmax_int8(x, wq, scale, b)
    bound, by = quant_bound_ms(n, k, v)
    return {"shape": f"({n}, {k}) x ({k}, {v})", "kernel_ms": kernel_ms,
            "kernel_ms_l2_dirty": dirty_ms, "library_ms": library_ms,
            "speedup": library_ms / max(kernel_ms, 1e-9),
            "weight_mb_bf16": k * v * 2 / 1e6, "weight_mb_int8": k * v / 1e6,
            "argmax_agreement": float((ids == library()).float().mean()),
            "bound_ms": bound, "bound_by": by}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=20, help="traced calls per case")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    states = {"dirty": flush.zero_, "clean": lambda: flush.max(), "warm": None}
    cases = []
    for v in (96, 18710):
        rng = np.random.default_rng(v)
        x = torch.from_numpy(rng.standard_normal((10240, 120)).astype(np.float32)).cuda().bfloat16()
        w = torch.from_numpy((rng.standard_normal((120, v)) * 0.1).astype(np.float32)).cuda()
        b = torch.from_numpy((rng.standard_normal(v) * 0.1).astype(np.float32)).cuda()
        wk = pad_ctc_kernel(w)
        cases.append(("ctc_head", [10240, 120, v], lambda x=x, wk=wk, b=b: fused_ctc_argmax(x, wk, b)))
    for v in (57, 50000):
        rng = np.random.default_rng(v)
        w = torch.from_numpy((rng.standard_normal((512, v)) * 0.05).astype(np.float32)).cuda()
        bias = torch.from_numpy((rng.standard_normal(v) * 0.1).astype(np.float32)).cuda()
        wq, scale = quantize_weight_int8(w)
        wq = aligned_rows(wq)
        for n in (4, 16):
            x = torch.from_numpy(rng.standard_normal((n, 512)).astype(np.float32)).cuda().bfloat16()
            cases.append(("quant_head", [n, 512, v],
                          lambda x=x, wq=wq, s=scale, b=bias: fused_argmax_int8(x, wq, s, b)))
    for name, shape, call in cases:
        for state, before in states.items():
            times = kernel_times(call, before, args.runs)
            print(json.dumps({"kernel": name, "shape": shape, "cache": state,
                              "device_us_per_launch": times,
                              "total_us": sum(times.values())}), flush=True)


if __name__ == "__main__":
    main()
