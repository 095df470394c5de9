"""Cold-start rehearsal of the port: first-parse budget with and without
the kernel and host-loop builds at hand.

Counterpart of the root ``tools/coldstart.py``. The JAX package's cold
start is XLA compiling every bucket, which its persistent compile cache
(``RAPIDDOC_XLA_CACHE_DIR``) can skip. The port's is nvcc building each
kernel and host library at first use (``ops/build.py``), cached by
source hash in a build directory that ``RAPIDDOC_BUILD_DIR`` moves; its
sessions' ``compiles`` (first dispatches of a bucket signature) cost no
compiler. Three fresh processes run the same parse:

1. ``nocache``: a new, empty build directory, removed afterwards: every
   library the parse needs is built.
2. ``cold``: another empty directory, which the run fills.
3. ``warm``: the same directory again: every build is found.

The parse is the root tool's: ``RapidDoc()`` and a two-page "ocr" parse
with ``RAPIDDOC_DEMO_LAYOUT=1`` (unless the caller's environment says
otherwise), on two synth-text pages (the first two pages of
``assets/ocr_smoke_doc.pdf``; the JAX tool draws its two pages with PIL,
which the port does not import). Each process reports ``import_s``,
``first_parse_s``, ``compiles`` by session and ``builds`` (the libraries
in its build directory when it ends); the parent adds
``process_wall_s``, ``warm_saves_s`` and the root tool's other keys.

    python3 -m rapiddoc_tpu_torch.tools.coldstart [out.json]

(also run by ``python3 -m rapiddoc_tpu_torch.bench`` under
``RAPIDDOC_BENCH_COLDSTART=1``). Needs the card: the builds are the
card's. Writes ``out.json`` only where named.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PKG_PARENT = Path(__file__).resolve().parent.parent.parent
CHILD_TIMEOUT_S = 900

_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
from rapiddoc_tpu_torch import RapidDoc
from rapiddoc_tpu_torch.bench import PDF, build_pdf, page_images
from rapiddoc_tpu_torch.ops import build
pdf = build_pdf(page_images(PDF.read_bytes())[:2], 2)
t_import = time.perf_counter() - t0
t1 = time.perf_counter()
doc = RapidDoc(device="cuda")
r = doc(pdf, parse_method="ocr")
torch.cuda.synchronize()
if not r.markdown:
    raise SystemExit("the parse produced no Markdown")
t_first = time.perf_counter() - t1
from rapiddoc_tpu_torch.engine.session import session_stats_report
print("CHILD:" + json.dumps({
    "import_s": t_import,
    "first_parse_s": t_first,
    "compiles": {k: v["compiles"] for k, v in session_stats_report().items()},
    "builds": sorted(p.parent.name for p in build.BUILD_DIR.glob("*/lib*.so")),
}))
"""


def run_child(build_dir: str) -> dict:
    """One fresh process's parse with ``build_dir`` as its build
    directory; raises with the end of its standard error if it fails."""
    env = dict(os.environ)
    env["RAPIDDOC_BUILD_DIR"] = build_dir
    env.setdefault("RAPIDDOC_DEMO_LAYOUT", "1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(PKG_PARENT)] + [p for p in [env.get("PYTHONPATH")] if p])
    tic = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _CHILD], capture_output=True, text=True,
                          env=env, timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - tic
    for line in proc.stdout.splitlines():
        if line.startswith("CHILD:"):
            return {**json.loads(line[len("CHILD:"):]), "process_wall_s": wall}
    raise RuntimeError(f"cold-start child failed (rc={proc.returncode}):\n"
                       f"{proc.stderr[-2000:]}")


def rehearse() -> dict:
    nocache_dir = tempfile.mkdtemp(prefix="rapiddoc_build_nocache_")
    try:
        nocache = run_child(nocache_dir)
    finally:
        shutil.rmtree(nocache_dir, ignore_errors=True)
    with tempfile.TemporaryDirectory(prefix="rapiddoc_build_") as cache:
        cold = run_child(cache)
        entries = sum(len(files) for _, _, files in os.walk(cache))
        warm = run_child(cache)
    saved = cold["first_parse_s"] - warm["first_parse_s"]
    return {
        "workload": "RapidDoc(device='cuda') + 2-page ocr parse, demo dims",
        "nocache": nocache,
        "cold": cold,
        "warm": warm,
        "cache_entries_written": entries,
        "warm_saves_s": saved,
        "cache_effective": bool(entries and saved > 1.0),
        "note": ("the cache is the build directory of ops/build.py (nvcc builds of "
                 "the kernels and host loops, keyed by source hash); 'nocache' and "
                 "'cold' build every library the parse needs"),
    }


if __name__ == "__main__":
    report = rehearse()
    if len(sys.argv) > 1:
        Path(sys.argv[1]).write_text(json.dumps(report, indent=1))
    print(json.dumps(report))
