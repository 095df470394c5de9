"""Where the OCR slice's time goes on the card.

    python3 -m rapiddoc_tpu_torch.profile_ocr [--runs N]

Runs the OCR system (bf16, the card) on the committed fixture pages and
traces it with torch.profiler: for the whole system, the detector and
the recognizer apart, it prints the wall time per page, the device's
kernel time per page, the device's busy share (kernel time over wall)
and the kernels that take the most device time. One JSON object per
line; the card's name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from .models.ocr.engine import crop_quad
from .models.registry import build_ocr_system

PAGES = Path(__file__).resolve().parent / "assets" / "ocr_smoke_pages.npz"


def traced(fn, runs: int) -> tuple[float, list]:
    """Wall seconds of ``runs`` calls (synchronized) and the profiler's
    per-kernel device totals."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [
        (e.key, e.device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
    ]
    return wall, sorted(kernels, key=lambda k: -k[1])


def report(name: str, wall: float, kernels: list, pages: int) -> dict:
    device_ms = sum(k[1] for k in kernels)
    return {
        "part": name,
        "wall_ms_per_page": wall * 1e3 / pages,
        "device_kernel_ms_per_page": device_ms / pages,
        "device_busy_share": device_ms / (wall * 1e3) if wall else None,
        "top_kernels_ms_per_page": [
            [k[0][:80], k[1] / pages, k[2]] for k in kernels[:8]
        ],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    with np.load(PAGES) as z:
        pages = list(z["pages"])
    system = build_ocr_system()
    system(pages)  # warm-up
    torch.cuda.synchronize()
    n = args.runs * len(pages)
    wall, kernels = traced(lambda: system(pages), args.runs)
    print(json.dumps(report("system", wall, kernels, n)), flush=True)
    wall, kernels = traced(lambda: system.detector(pages), args.runs)
    print(json.dumps(report("detector", wall, kernels, n)), flush=True)
    crops = [crop_quad(p, q) for p, d in zip(pages, system.detector(pages)) for q in d.boxes]
    wall, kernels = traced(lambda: system.recognizer(crops), args.runs)
    print(json.dumps(report("recognizer", wall, kernels, n)), flush=True)


if __name__ == "__main__":
    main()
