"""Host milliseconds a page of each image-file decoder of the port
(``pdfio.writer._pixels``: the pixels ``images_to_pdf`` embeds), at the
committed 480 x 360 pages (``assets/image_files_*``) and at a Letter page
at 200 dpi (1700 x 2200) written with the same recipes
(``test_torch_image_files.page_files``) from a ``train/synth_layout``
page of that size.

    python tests/time_image_decoders.py --write DIR   # PIL and the JAX package
    python tests/time_image_decoders.py DIR           # the port only

The first form writes the full pages and their two arrays into DIR. The
second times every case on both sizes, one untimed call first (it builds
``csrc/bilevel.cu`` where a card is present, so G4 runs compiled there,
as on the main path), and prints the card's name and power limit, then
one JSON object: per case the mean ms of each size and their ratio.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

PAGE = (1700, 2200)  # Letter at 200 dpi, width x height
RUNS = {"small": 5, "page": 3}


def _inputs(files: dict, grey: np.ndarray) -> dict:
    from test_torch_image_files import page_arrays

    return {**files, **page_arrays(grey)}


def write(out: Path) -> None:
    from test_torch_image_files import make_page, page_files

    page = make_page(*PAGE)
    out.mkdir(parents=True, exist_ok=True)
    for k, data in page_files(page).items():
        (out / k).write_bytes(data)
    grey = (page.astype(np.int32) @ np.array([299, 587, 114]) // 1000).astype(np.uint8)
    np.save(out / "grey.npy", grey)


def _card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "no card"
    except (OSError, subprocess.TimeoutExpired):
        return "no card"


def _ms(item, runs: int) -> float:
    from rapiddoc_tpu_torch.pdfio.writer import _pixels

    _pixels(item)
    t0 = time.perf_counter()
    for _ in range(runs):
        _pixels(item)
    return (time.perf_counter() - t0) * 1e3 / runs


def time_all(folder: Path) -> dict:
    from test_torch_image_files import load_inputs

    small = load_inputs()
    names = [k for k in small if not isinstance(small[k], np.ndarray)]
    page = _inputs({k: (folder / k).read_bytes() for k in names},
                   np.load(folder / "grey.npy"))
    out = {}
    for k in small:
        a, b = _ms(small[k], RUNS["small"]), _ms(page[k], RUNS["page"])
        out[k] = {"ms_480x360": a, "ms_1700x2200": b, "ratio": b / a}
    return out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--write"]:
        write(Path(sys.argv[2]))
    else:
        print(_card())
        print(json.dumps({"decode_host_ms": time_all(Path(sys.argv[1])), "runs": RUNS}))
