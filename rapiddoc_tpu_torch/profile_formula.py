"""Where the formula recognizer's time goes on the card.

    python3 -m rapiddoc_tpu_torch.profile_formula [--runs N]

Runs ``batch_predict`` on the committed fixture crops (bf16, the card)
and traces it with torch.profiler, for the demo recognizer with the
plain lm_head (the JAX package's default) and with the int8 head (K2),
and for the published PP-FormulaNet_plus-M shape (random weights, int8
head, length bucket 256; one traced run by default, since its 512
decode steps make a large trace). For each it prints the wall time per crop,
the device's kernel time per crop, the device's busy share (kernel time
over wall), the decode steps and the kernels that take the most device
time. With the int8 head it also prints what the head costs a decode
step: its kernel's device time (traced), and, from as many untraced
runs, the wall time per step and the host time spent inside the head's
wrapper per call (checks, scratch, launch), read by timing
``FormulaRecognizer.argmax_int8``. One JSON object per line; the card's
name and power limit come first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from .models.formula.engine import FormulaConfig, FormulaRecognizer
from .models.registry import build_formula_recognizer
from .profile_ocr import traced

CROPS = Path(__file__).resolve().parent / "assets" / "formula_smoke_crops.npz"


def report(name: str, rec: FormulaRecognizer, crops: list, runs: int) -> dict:
    rec.batch_predict(crops)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    steps = rec.stats.decode_steps
    wall, kernels = traced(lambda: rec.batch_predict(crops), runs)
    n = runs * len(crops)
    device_ms = sum(k[1] for k in kernels)
    steps = rec.stats.decode_steps - steps
    cost = head_cost(rec, crops, runs, kernels, steps) if rec.int8_head else {}
    return {
        "part": name,
        "wall_ms_per_crop": wall * 1e3 / n,
        "device_kernel_ms_per_crop": device_ms / n,
        "device_busy_share": device_ms / (wall * 1e3),
        "decode_steps_per_run": steps / runs,
        "top_kernels_ms_per_crop": [[k[0][:80], k[1] / n, k[2]] for k in kernels[:10]],
        **cost,
    }


def head_cost(rec: FormulaRecognizer, crops: list, runs: int, kernels: list,
              traced_steps: int) -> dict:
    """The int8 head's cost a decode step: ``kernels`` (traced over
    ``traced_steps`` steps) give its kernels' device time; ``runs``
    untraced runs give the wall time per step and the host time inside
    ``rec.argmax_int8`` per call."""
    inner = rec.argmax_int8
    spent = [0.0, 0]

    def timed(*args):
        t0 = time.perf_counter()
        out = inner(*args)
        spent[0] += time.perf_counter() - t0
        spent[1] += 1
        return out

    rec.argmax_int8 = timed
    steps = rec.stats.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        rec.batch_predict(crops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec.argmax_int8 = inner
    steps = rec.stats.decode_steps - steps
    head = [k for k in kernels if "quant_head" in k[0]]
    return {
        "untraced_wall_ms_per_step": wall * 1e3 / steps,
        "head_host_ms_per_call": spent[0] * 1e3 / spent[1],
        "head_calls_per_step": spent[1] / steps,
        "head_device_ms_per_step": sum(k[1] for k in head) / traced_steps,
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3, help="traced runs of the demo")
    ap.add_argument("--published-runs", type=int, default=1,
                    help="traced runs of the published shape (512 decode steps each)")
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(json.dumps({"card": smi.stdout.strip()}), flush=True)
    with np.load(CROPS) as z:
        crops = [z[f"crop{i:02d}"] for i in range(len(z.files))]
    for name, build, runs in (
        ("demo_plain_head", lambda: build_formula_recognizer(int8_head=False), args.runs),
        ("demo_int8_head", lambda: build_formula_recognizer(int8_head=True), args.runs),
        ("published_int8_head",
         lambda: FormulaRecognizer(None, config=FormulaConfig(), int8_head=True),
         args.published_runs),
    ):
        print(json.dumps(report(name, build(), crops, runs)), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
