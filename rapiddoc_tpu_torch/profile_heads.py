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


def kernel_times(call, before, runs: int) -> dict:
    """Mean device microseconds per launch of each kernel that ``call``
    launches, with ``before`` (untraced kind of flush, or None) run ahead
    of every call."""
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
        name = re.search(r"(ctc|quant)_head_[a-z]+", e.key)
        if e.device_type == torch.autograd.DeviceType.CUDA and name:
            out[name.group(0)] = e.device_time_total / max(e.count, 1)
    return out


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
