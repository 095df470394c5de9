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
time. One JSON object per line; the card's name and power limit come
first.
"""
from __future__ import annotations

import argparse
import json
import subprocess
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
    return {
        "part": name,
        "wall_ms_per_crop": wall * 1e3 / n,
        "device_kernel_ms_per_crop": device_ms / n,
        "device_busy_share": device_ms / (wall * 1e3),
        "decode_steps_per_run": (rec.stats.decode_steps - steps) / runs,
        "top_kernels_ms_per_crop": [[k[0][:80], k[1] / n, k[2]] for k in kernels[:10]],
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
