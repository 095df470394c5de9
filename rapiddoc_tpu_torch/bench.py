"""GPU bench of the port's main path: ``RapidDoc()(pdf, parse_method="ocr")``.

    python3 -m rapiddoc_tpu_torch.bench [--corpus ocr|layout] [--pages 56]
        [--dtype bf16] [--device cuda] [--int8-head]

``--corpus ocr`` (the default) is ``bench.py``'s ``_bench_e2e`` in its
OCR-only form (layout, formula and table disabled,
``RAPIDDOC_DISABLE_*=1``): an N-page PDF (56 by default, as
``bench.py``) of synthetic text pages embedded as JPEG at quality 92,
144 dpi, repeating the committed fixture PDF's three JPEG streams
(``assets/ocr_smoke_doc.pdf``, written by the JAX package's
``images_to_pdf``), each page with the page dict and content stream
``images_to_pdf`` writes.

``--corpus layout`` is the counterpart of ``bench.py``'s
``_composite_corpus_pdf`` for the page kinds this repository holds, with
``RAPIDDOC_DEMO_LAYOUT=1`` and every stage on, as the JAX bench's
headline (layout, OCR, formula and table, demo checkpoints): in equal
thirds, in this order, the formula_dense and the table_heavy pages of
``assets/layout_smoke_doc.pdf`` and the synth-text pages of
``ocr_smoke_doc.pdf``, each kind's streams repeated. The JAX headline's
real English and CJK pages are not in the repository. ``--int8-head``
sets ``RAPIDDOC_INT8_HEAD=1``, which sends every formula decode step
through kernel K2.

Warm-up passes until no session adds a compile (a new bucket signature,
at most three passes, as ``bench.py``), two timed passes (under
``utils.trace.maybe_profile``: a Chrome trace when
``RAPIDDOC_PROFILE_DIR`` is set), then one pass under ``torch.profiler``
for the device's busy share (kernel time over wall time; not counted in
pages/s). On standard error, as ``bench.py`` prints them: ``[workload]``
(the last timed pass's rec crops, formula and table regions), a
``[session]`` line per session, ``[mfu]`` (``engine/flops.py``'s per-stage
GFLOPs, achieved TFLOP/s, MFU against the card's peak and
``compute_bound_ms_per_page``, through ``bench.py``'s program-to-stage
map), ``[wire]``, a ``[split]`` line per session (estimated transfer time
capped at the stage's wall), ``[overlap]`` (the host path, render,
ocr_crop, assembly and assembly_final, against the device path, layout,
ocr_det, ocr_rec, formula, table and orientation, in ms/page,
``e2e_ms_per_page`` and ``e2e_over_max_path``, ``ocr_rec_detail`` with
crops/s, ``pad_overhead`` and session calls) and ``[variance]``
(pages/s of each timed pass, ``spread_pct``, the corpus's pages by kind).

Then the root bench's other parts, in its order, each a JSON key:
``corpus`` (pages/s of four-page table_heavy and formula_dense
documents, every stage on, warmed once, one warm pass timed; its
cjk_scan needs a reference PDF that is not here and is left out, as the
JSON says), ``cold_start`` (``tools/coldstart.py``'s three fresh
processes, only under ``RAPIDDOC_BENCH_COLDSTART=1``), ``ctc_head`` and
``quant_head`` (the two kernels at the root bench's shapes, device ms
warm and with the L2 dirty, beside one PyTorch call for the same
function and the bound: ``profile_heads.py``), ``published_dims`` (the
layout detector and the formula recognizer at their published widths,
random weights: layout ms/page, formula ms/region at bucket 256, decode
ms/step from buckets 512 and 256, and the 2560 bucket under
``RAPIDDOC_BENCH_FORMULA_FULL=1``), ``vs_baseline`` and
``vs_baseline_xla_cpu`` (this run's pages/s over the unit costs persisted
in ``BASELINE_CPU.json`` and ``BASELINE_CPU_XLA.json`` times this run's
workload, with the root bench's kinds and caveat; None where a file is
absent). ``RAPIDDOC_BENCH_SKIP_CORPUS``, ``_PUBLISHED`` and ``_BASELINE``
skip their parts as in the root bench. A skipped part, or on the CPU a
part that needs the card (the heads, the cold start), is reported as
``{"skipped": why}``; a part that fails fails the bench.

Prints the card's name and power limit, then one JSON line with
``bench.py``'s keys: ``e2e_corpus`` (ocr or layout) and
``corpus_pages``, ``pages_per_sec`` (and each run's),
``stage_ms_per_page`` (render, layout, ocr_det, ocr_crop, ocr_rec,
formula, table, assembly, assembly_final, and ocr, which holds det, crop
and rec), ``workload``, ``overlap`` (with ``variance``),
``ocr_rec_detail`` (crops, session calls, crops/s, K1 launches),
``formula_detail`` (regions, decode dispatches and steps, K2 launches),
``table_detail`` (tables, UNet calls and crops, SLANet and UniTable
decode dispatches and steps), ``mfu`` (the ``[mfu]`` report of the last
timed pass), ``session_stats``, ``device_busy_share`` and the parts
above. On the CPU (``--device cpu``) it runs the same path for rehearsal
and reports no device numbers (``mfu`` None).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ASSETS = Path(__file__).resolve().parent / "assets"
PDF = ASSETS / "ocr_smoke_doc.pdf"
LAYOUT_PDF = ASSETS / "layout_smoke_doc.pdf"
STAGES = ("render", "layout", "ocr_det", "ocr_crop", "ocr_rec", "ocr", "formula",
          "table", "assembly", "assembly_final")
# layout_smoke_doc.pdf's pages by kind (tests/test_torch_pipeline_layout.py)
LAYOUT_KINDS = {"formula_dense": (0, 1), "table_heavy": (2, 3)}
# program name (engine/flops.py) -> tracer stage, bench.py's _PROGRAM_STAGE
PROGRAM_STAGE = {
    "layout": "layout",
    "ocr_det": "ocr_det",
    "ocr_rec": "ocr_rec",
    "formula": "formula",
    "table_unitable": "table",
    "table_slanet": "table",
    "table_unet": "table",
    "table_cls": "table",
    "orientation": "orientation",
}
WARMUP_PASSES = 3  # at most, until no session adds a compile
# bench.py's [overlap] paths: the window pipeline runs render (N+1) and
# assembly (N-1) on threads under device work of window N; "ocr" holds
# det, crop and rec, and "assembly" feeds assembly_final, so neither
# parent is summed
HOST_STAGES = ("render", "ocr_crop", "assembly", "assembly_final")
DEVICE_STAGES = ("layout", "ocr_det", "ocr_rec", "formula", "table", "orientation")
CORPUS_PAGES = 4  # bench.py's _bench_corpus documents
FORMULA_STEPS_PER_SEQ = 96  # bench.py's denominator: decode steps a formula
# the persisted CPU denominators (bench.py's; read, never written)
BASELINE_CPU = Path(__file__).resolve().parent.parent / "BASELINE_CPU.json"
BASELINE_CPU_XLA = BASELINE_CPU.with_name("BASELINE_CPU_XLA.json")
BASELINE_KIND = "torch-eager-cpu1"
BASELINE_XLA_CPU_KIND = "xla-cpu-jit-fp32-cpu1"
BASELINE_CAVEAT = (
    "denominator = reference torch nets, eager, on this "
    "host's single CPU core; NOT onnxruntime-CPU (not "
    "installable here). Methodology: BOTH local CPU "
    "denominators were measured — torch-eager (oneDNN) "
    "and XLA-CPU-jit (BASELINE_CPU_XLA.json); torch-"
    "eager is the FASTER of the two on every stage, so "
    "it is the conservative primary. ORT-CPU shares the "
    "oneDNN/MLAS kernel class with torch-eager and is "
    "expected within ~2x of it."
)
BASELINE_HOST = (
    "both denominators' unit costs were measured once on another host's single CPU "
    "core (the files' meta: cpu_count 1), the JAX package's build host: 'this host' in "
    "baseline_caveat is that host, not the card's; the port reads them and measures none"
)


def page_images(pdf: bytes) -> list[tuple[bytes, int, int, str]]:
    """(JPEG bytes, width, height, colour space) of each page's image."""
    from .pdfio import open_pdf

    doc = open_pdf(pdf)
    out = []
    for i in range(len(doc)):
        page = doc.get_page(i)
        xobjs = doc.resolve(page.resources.get("XObject"))
        stream = doc.resolve(xobjs["Im0"])
        d = {k: doc.resolve(v) for k, v in stream.dict.items()}
        if d.get("Filter") != "DCTDecode":
            raise ValueError(f"page {i}: expected one DCTDecode image")
        out.append((stream.raw, int(d["Width"]), int(d["Height"]), str(d["ColorSpace"])))
    return out


def build_pdf(images: list[tuple[bytes, int, int, str]], n_pages: int, dpi: int = 144) -> bytes:
    """An n_pages PDF cycling through ``images``, each page as
    ``images_to_pdf`` writes it: the JPEG as an image XObject, a page of
    the image's size at ``dpi``, and ``q w 0 0 h 0 0 cm /Im0 Do Q``."""
    objs: list[bytes] = []

    def add(body: bytes) -> int:
        objs.append(body)
        return len(objs)

    def stream(head: str, data: bytes) -> bytes:
        return f"<< {head} /Length {len(data)} >>\nstream\n".encode() + data + b"\nendstream"

    add(b"<< /Type /Catalog /Pages 2 0 R >>")
    add(b"")  # the page tree, written once the pages are known
    kids = []
    for i in range(n_pages):
        jpeg, w, h, cs = images[i % len(images)]
        img = add(stream(f"/Type /XObject /Subtype /Image /Width {w} /Height {h} "
                         f"/ColorSpace /{cs} /BitsPerComponent 8 /Filter /DCTDecode", jpeg))
        pw, ph = w * 72.0 / dpi, h * 72.0 / dpi
        content = add(stream("", f"q {pw:.2f} 0 0 {ph:.2f} 0 0 cm /Im0 Do Q".encode()))
        kids.append(add(
            f"<< /Type /Page /Parent 2 0 R /MediaBox [0 0 {round(pw, 2)} {round(ph, 2)}] "
            f"/Resources << /XObject << /Im0 {img} 0 R >> >> /Contents {content} 0 R >>".encode()
        ))
    objs[1] = (f"<< /Type /Pages /Kids [{' '.join(f'{k} 0 R' for k in kids)}] "
               f"/Count {len(kids)} >>").encode()
    out = bytearray(b"%PDF-1.7\n")
    offsets = []
    for num, body in enumerate(objs, 1):
        offsets.append(len(out))
        out += f"{num} 0 obj\n".encode() + body + b"\nendobj\n"
    xref = len(out)
    out += f"xref\n0 {len(objs) + 1}\n0000000000 65535 f \n".encode()
    out += b"".join(f"{o:010d} 00000 n \n".encode() for o in offsets)
    out += (f"trailer\n<< /Size {len(objs) + 1} /Root 1 0 R >>\n"
            f"startxref\n{xref}\n%%EOF\n").encode()
    return bytes(out)


def corpus_pdf(corpus: str, n_pages: int) -> tuple[bytes, dict[str, int]]:
    """The bench's PDF and its page count by kind."""
    synth = page_images(PDF.read_bytes())
    if corpus == "ocr":
        return build_pdf(synth, n_pages), {"synth_text": n_pages}
    layout = page_images(LAYOUT_PDF.read_bytes())
    kinds = [(name, [layout[i] for i in idx]) for name, idx in LAYOUT_KINDS.items()]
    kinds.append(("synth_text", synth))
    images, counts = [], {}
    for k, (name, streams) in enumerate(kinds):
        n = n_pages // 3 + (k < n_pages % 3)
        images += [streams[i % len(streams)] for i in range(n)]
        counts[name] = n
    return build_pdf(images, len(images)), counts


def set_corpus_env(corpus: str, int8_head: bool) -> None:
    """The stage switches of the corpus: OCR only, or the demo layout with
    the formula and table stages."""
    if corpus == "ocr":
        for k in ("LAYOUT", "FORMULA", "TABLE"):
            os.environ.setdefault(f"RAPIDDOC_DISABLE_{k}", "1")
    else:
        for k in ("LAYOUT", "FORMULA", "TABLE"):
            os.environ.pop(f"RAPIDDOC_DISABLE_{k}", None)
        os.environ["RAPIDDOC_DEMO_LAYOUT"] = "1"
    if int8_head:
        os.environ["RAPIDDOC_INT8_HEAD"] = "1"


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def device_busy_share(fn) -> tuple[float, float]:
    """(device kernel ms, wall ms) of one traced call of ``fn``. Only the
    device is traced: the host's operator events, which nothing here
    reads, cost the trace's post-processing tens of seconds on a whole
    parse or a long eager decode, and the traced call's wall less
    overhead."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernel_us = sum(e.device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    return kernel_us / 1e3, wall * 1e3


def table_counts(table) -> dict[str, int]:
    """The table models' counters: the classifier's crops, the UNet's
    dispatches and crops, the wireless model's decode dispatches and
    steps (under its name)."""
    if table is None:
        return {}
    out = {}
    if table.wired is not None:
        out.update(unet_calls=table.wired.calls, unet_crops=table.wired.items)
    if table.wireless is not None:
        name = table.wireless.name
        out.update({f"{name}_dispatches": table.wireless.calls,
                    f"{name}_decode_steps": table.wireless.decode_steps})
    return out


def warm_up(parse) -> tuple[float, int]:
    """Parse until no session adds a compile (a bucket signature it had
    not dispatched), at most WARMUP_PASSES times, as ``bench.py`` warms
    up: a first dispatch inside a timed pass would count its FLOPs there.
    Returns (seconds, passes)."""
    from .engine.session import session_stats_report

    t0 = time.perf_counter()
    compiles = -1
    for n in range(1, WARMUP_PASSES + 1):
        parse()
        now = sum(s["compiles"] for s in session_stats_report().values())
        if now == compiles:
            break
        compiles = now
    return time.perf_counter() - t0, n


def transfer_split(stage_wall_ms: dict[str, float]) -> dict:
    """``bench.py``'s ``_transfer_split``: each session's serialized
    transfer estimate capped at its stage's measured wall, the overlap
    reported beside it."""
    from .engine.session import transfer_split_report

    out = {}
    for name, tr in transfer_split_report().items():
        wall, est = stage_wall_ms.get(name), tr["transfer_ms_est"]
        if wall is None or est is None:
            out[name] = {**tr, "note": "no stage wall measured" if wall is None else "no card"}
            continue
        transfer = min(est, wall)
        out[name] = {"stage_wall_ms": wall, "transfer_ms": transfer,
                     "compute_ms": wall - transfer, "overlapped_ms": max(est - wall, 0.0),
                     "bytes_in": tr["bytes_in"], "bytes_out": tr["bytes_out"],
                     "fetches": tr["fetches"]}
    return out


def accounting(report: dict, n_pages: int, device) -> dict:
    """The accounting of one pass (``report``: the tracer's) over
    ``n_pages``, printed as ``bench.py`` prints it on standard error: a
    ``[session]`` line per session, ``[mfu]`` (``engine/flops.py``'s
    report through PROGRAM_STAGE, with compute_bound_ms_per_page),
    ``[wire]`` and ``[split]``. Returns {"mfu", "session_stats", "wire",
    "split"}."""
    from .engine import flops
    from .engine.session import measure_wire_bandwidth, session_stats_report

    sessions = session_stats_report()
    for name, st in sessions.items():
        print(f"[session] {name}: calls={st['calls']} in={st['bytes_in'] / 1e6:.1f}MB "
              f"out={st['bytes_out'] / 1e6:.1f}MB compiles={st['compiles']} "
              f"pad_overhead={st['pad_overhead']:.3f}", file=sys.stderr)
    stage_wall_s = {stage: report.get(stage, {}).get("total_s", 0.0)
                    for stage in set(PROGRAM_STAGE.values())}
    mfu = flops.mfu_report(stage_wall_s, PROGRAM_STAGE, device=device)
    for d in mfu["stages"].values():
        ms = d["compute_bound_ms"]
        d["compute_bound_ms_per_page"] = ms / n_pages if ms is not None else None
    print(f"[mfu] {json.dumps(mfu)}", file=sys.stderr)
    wire = measure_wire_bandwidth()
    print(f"[wire] {wire}", file=sys.stderr)
    split = transfer_split({k: v.get("total_s", 0.0) * 1e3 for k, v in report.items()})
    for name, tr in split.items():
        print(f"[split] {name}: {tr}", file=sys.stderr)
    return {"mfu": mfu, "session_stats": sessions, "wire": wire, "split": split}


def workload_report(report: dict, rec_crops: int) -> dict:
    """``bench.py``'s ``[workload]`` (bench.py:255-262): the last timed
    pass's rec crops (the rec session's items in it), formula regions
    and table regions (the tracer's items)."""
    return {
        "rec_crops": rec_crops,
        "formula_regions": report.get("formula", {}).get("items", 0),
        "table_regions": report.get("table", {}).get("items", 0),
    }


def overlap_report(report: dict, pages: int, last_wall_s: float, workload: dict,
                   rec_stats: dict) -> dict:
    """``bench.py``'s ``[overlap]`` (bench.py:306-340) of the last timed
    pass (``report``: the tracer's; ``last_wall_s``: its wall):
    HOST_STAGES against DEVICE_STAGES in ms/page, ``e2e_ms_per_page`` and
    ``e2e_over_max_path`` (1.0 is perfect overlap, more is serialization
    left in the pipeline), and ``ocr_rec_detail`` with the rec session's
    ``pad_overhead`` and ``session_calls`` (``rec_stats``: its counters
    since it was built). Rounded as ``bench.py`` rounds."""
    ms = {k: v.get("total_s", 0.0) * 1000.0 / pages for k, v in report.items()}
    host_ms = sum(ms.get(s, 0.0) for s in HOST_STAGES)
    dev_ms = sum(ms.get(s, 0.0) for s in DEVICE_STAGES)
    e2e_ms = last_wall_s * 1e3 / pages
    rec_wall_s = report.get("ocr_rec", {}).get("total_s", 0.0)
    return {
        "host_path_ms_per_page": round(host_ms, 1),
        "device_path_ms_per_page": round(dev_ms, 1),
        "e2e_ms_per_page": round(e2e_ms, 1),
        "e2e_over_max_path": round(e2e_ms / max(host_ms, dev_ms, 1e-9), 3),
        "ocr_rec_detail": {
            "crops": workload["rec_crops"],
            "crops_per_sec": round(workload["rec_crops"] / rec_wall_s, 1)
            if rec_wall_s else None,
            "ms_per_page": round(ms.get("ocr_rec", 0.0), 1),
            "pad_overhead": round(rec_stats.get("pad_overhead", 0.0), 3),
            "session_calls": rec_stats.get("calls"),
        },
    }


def variance_report(pages: int, walls: list[float], corpus_counts: dict) -> dict:
    """``bench.py``'s ``[variance]`` (bench.py:341-350): pages/s of each
    timed pass and their spread in percent of the mean; ``spread_pct`` is
    None for a single pass, where no spread was measured."""
    pps_runs = [round(pages / r, 3) for r in walls]
    spread = None
    if len(pps_runs) > 1:
        spread = round(
            (max(pps_runs) - min(pps_runs)) / max(sum(pps_runs) / len(pps_runs), 1e-9) * 100, 1)
    return {"pages_per_sec_runs": pps_runs, "spread_pct": spread, "corpus": corpus_counts}


def corpus_docs() -> dict[str, bytes]:
    """``bench.py``'s ``_bench_corpus`` documents the repository holds:
    CORPUS_PAGES pages of each layout kind (LAYOUT_KINDS' pages of
    ``assets/layout_smoke_doc.pdf``, repeated). Its ``cjk_scan`` reads a
    reference PDF that is not in the repository and is left out, as
    ``bench.py`` leaves it out where the file is missing."""
    layout = page_images(LAYOUT_PDF.read_bytes())
    return {kind: build_pdf([layout[i] for i in idx], CORPUS_PAGES)
            for kind, idx in (("table_heavy", LAYOUT_KINDS["table_heavy"]),
                              ("formula_dense", LAYOUT_KINDS["formula_dense"]))}


def bench_corpus(device: str, dtype, int8_head: bool) -> dict:
    """Per-kind pages/s (``bench.py``'s ``_bench_corpus``): each
    document parsed in "ocr" mode with every stage on (the layout
    corpus's switches) and lang "en", warmed once, then one warm pass
    timed."""
    import torch

    from . import RapidDoc

    set_corpus_env("layout", int8_head)
    doc = RapidDoc(device=device, dtype=dtype)
    cuda = torch.device(device).type == "cuda"
    out: dict = {}
    for kind, pdf in corpus_docs().items():
        doc(pdf, parse_method="ocr", lang="en")  # warm (new buckets)
        tic = time.perf_counter()
        r = doc(pdf, parse_method="ocr", lang="en")
        if cuda:
            torch.cuda.synchronize()
        dt = time.perf_counter() - tic
        if not r.markdown:
            raise RuntimeError(f"corpus {kind}: the parse produced no Markdown")
        out[kind] = {"pages": CORPUS_PAGES, "pages_per_sec": round(CORPUS_PAGES / dt, 3)}
        print(f"[corpus] {kind}: {out[kind]}", file=sys.stderr)
    out["left_out"] = {"cjk_scan": "bench.py reads it from a reference PDF that is not in "
                                   "the repository (bench.py skips it where the file is missing)"}
    return out


def formula_crops() -> list:
    """Four white crops of ``bench.py``'s sizes ((64 + 16 i) x (320 + 64 i))
    with seeded dark strokes in place of its cv2.putText "E=mc2" (the
    port draws no text; random weights read any crop alike)."""
    import numpy as np

    rng = np.random.default_rng(0)
    crops = []
    for i in range(4):
        crop = np.full((64 + 16 * i, 320 + 64 * i, 3), 255, np.uint8)
        for _ in range(6):
            y, x = rng.integers(8, crop.shape[0] - 12), rng.integers(8, crop.shape[1] - 40)
            crop[y:y + 4, x:x + rng.integers(8, 32)] = 0
        crops.append(crop)
    return crops


def published_dims(device: str, dtype) -> dict:
    """Stage costs at the published widths (``bench.py``'s
    ``_bench_published_dims``), random weights from seed 0: the layout
    detector (PP-DocLayoutV3: B4 at 800 x 800, 300 queries, 6 decoder
    layers, masks) in ms/page on the layout fixture's four pages rendered
    at 144 dpi (``bench.py`` renders four pages of a reference PDF that is
    not in the repository); the formula recognizer (PPHGNetV2-B6, 6 x 512
    MBart decoder, 50 000 tokens) in ms/region at length bucket 256 on
    formula_crops(), and decode ms/step by differencing buckets 512 and
    256 (random weights emit no EOS, so each runs its whole bucket).
    ``RAPIDDOC_BENCH_FORMULA_FULL=1`` also times the published 2560
    bucket."""
    import torch

    from .models.formula.engine import FormulaConfig, FormulaRecognizer
    from .models.layout.engine import LayoutConfig, LayoutDetector
    from .pdfio import open_pdf, render_page_full

    cuda = torch.device(device).type == "cuda"

    def timed(fn) -> float:
        fn()  # warm
        if cuda:
            torch.cuda.synchronize()
        tic = time.perf_counter()
        fn()
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - tic

    out: dict = {"pages": "layout_smoke_doc.pdf's four pages at 144 dpi"}
    doc = open_pdf(LAYOUT_PDF.read_bytes())
    pages = [render_page_full(doc.get_page(i), dpi=144, with_text=False)[0]
             for i in range(len(doc))]
    layout = LayoutDetector(None, LayoutConfig(), seed=0, device=device, dtype=dtype)
    out["layout_ms_per_page"] = round(timed(lambda: layout.batch_predict(pages)) * 1e3
                                      / len(pages), 1)
    del layout
    rec = FormulaRecognizer(None, config=FormulaConfig(), seed=0, device=device, dtype=dtype,
                            int8_head=False)
    crops = formula_crops()

    def bucket(n: int) -> float:
        return timed(lambda: rec.batch_predict(crops, length_bucket=n))

    t256, t512 = bucket(256), bucket(512)
    out["formula_ms_per_region"] = round(t256 * 1e3 / len(crops), 1)
    out["formula_decode_ms_per_step"] = round(max(t512 - t256, 0.0) * 1e3 / 256, 3)
    out["formula_len_bucket"] = 256
    if os.environ.get("RAPIDDOC_BENCH_FORMULA_FULL"):
        t2560 = bucket(2560)
        out["formula_ms_per_region_2560"] = round(t2560 * 1e3 / len(crops), 1)
        out["formula_decode_ms_per_step_2560"] = round(
            max(t2560 - t256, 0.0) * 1e3 / (2560 - 256), 3)
    out["formula_decode_steps"] = rec.stats.decode_steps
    return out


def _unit_costs(path: Path) -> dict | None:
    return json.loads(path.read_text())["unit_costs_ms"] if path.is_file() else None


def _units(workload: dict | None, pages: int) -> tuple[int, int, int]:
    """(rec crops, formula regions, table regions) as ``bench.py`` reads
    its WORKLOAD: no crops counted means 24 a page."""
    wl = workload or {}
    return (int(wl.get("rec_crops") or pages * 24), int(wl.get("formula_regions") or 0),
            int(wl.get("table_regions") or 0))


def cpu_reference_pps(workload: dict | None, pages: int,
                      path: Path = BASELINE_CPU) -> float | None:
    """``bench.py``'s ``_bench_torch_reference``: reference-CPU pages/s
    over this run's measured workload, from the unit costs persisted in
    BASELINE_CPU.json (None where the file is absent: the port cannot
    measure them)."""
    costs = _unit_costs(path)
    if costs is None:
        return None
    crops, n_formula, n_table = _units(workload, pages)

    det_s = pages * costs["det_ms_per_page"] / 1e3
    rec_s = crops * costs["rec_ms_per_crop"] / 1e3
    layout_s = pages * costs.get("layout_ms_per_page", 0.0) / 1e3
    formula_s = n_formula * (
        costs.get("formula_enc_ms_per_region", 0.0)
        + FORMULA_STEPS_PER_SEQ * costs.get("formula_step_ms", 0.0)
    ) / 1e3
    table_s = n_table * costs.get("table_unet_ms_per_region", 0.0) / 1e3
    total = det_s + rec_s + layout_s + formula_s + table_s
    if total <= 0:
        raise RuntimeError(f"degenerate baseline costs: {costs}")
    print(f"[baseline] layout={layout_s:.1f}s det={det_s:.1f}s rec={rec_s:.1f}s "
          f"formula={formula_s:.1f}s table={table_s:.1f}s total={total:.1f}s for "
          f"{pages}p/{crops}c/{n_formula}f/{n_table}t (per-unit costs from {path.name})",
          file=sys.stderr)
    return pages / total


def xla_cpu_reference_pps(workload: dict | None, pages: int,
                          path: Path = BASELINE_CPU_XLA) -> float | None:
    """``bench.py``'s ``_bench_xla_cpu_reference``: the same workload
    priced with BASELINE_CPU_XLA.json's unit costs (None where absent)."""
    costs = _unit_costs(path)
    if costs is None:
        return None
    crops, n_formula, n_table = _units(workload, pages)
    total = (
        pages * costs.get("det_ms_per_page", 0.0)
        + crops * costs.get("rec_ms_per_crop", 0.0)
        + pages * costs.get("layout_ms_per_page", 0.0)
        + n_formula * (
            costs.get("formula_enc_ms_per_region", 0.0)
            + FORMULA_STEPS_PER_SEQ * costs.get("formula_step_ms", 0.0)
        )
        + n_table * costs.get("table_unet_ms_per_region", 0.0)
    ) / 1e3
    if total <= 0:
        return None
    print(f"[baseline-xla-cpu] total={total:.1f}s for {pages}p/{crops}c/{n_formula}f/"
          f"{n_table}t (unit costs from {path.name})", file=sys.stderr)
    return pages / total


def baseline_report(pps: float, workload: dict | None, pages: int,
                    skip_torch: bool = False) -> dict:
    """``vs_baseline`` and ``vs_baseline_xla_cpu``: this run's pages/s
    over each persisted denominator, rounded as ``bench.py`` rounds
    (None where a file is absent, or the torch one under
    ``RAPIDDOC_BENCH_SKIP_BASELINE``), with ``bench.py``'s kinds and
    caveat."""
    base = None if skip_torch else cpu_reference_pps(workload, pages)
    xla = xla_cpu_reference_pps(workload, pages)
    return {
        "vs_baseline": round(pps / base, 3) if base else None,
        "baseline_kind": BASELINE_KIND,
        "baseline_caveat": BASELINE_CAVEAT,
        "vs_baseline_xla_cpu": round(pps / xla, 3) if xla else None,
        "baseline_xla_cpu_kind": BASELINE_XLA_CPU_KIND,
        "baseline_host": BASELINE_HOST,
    }


def run(n_pages: int, device: str, dtype, runs: int = 2,
        corpus: str = "ocr", int8_head: bool = False) -> dict:
    import torch

    set_corpus_env(corpus, int8_head)
    from . import RapidDoc
    from .engine import flops
    from .ops.ctc_head import fused_ctc_argmax
    from .ops.quant_head import fused_argmax_int8
    from .utils.trace import GLOBAL_TRACER, maybe_profile

    pdf, counts = corpus_pdf(corpus, n_pages)
    n_pages = sum(counts.values())
    doc = RapidDoc(device=device, dtype=dtype)
    cuda = torch.device(device).type == "cuda"

    def parse():
        out = doc(pdf, parse_method="ocr")
        if cuda:
            torch.cuda.synchronize()
        return out

    # model build, kernel builds, cuDNN's algorithm picks, every bucket
    warmup_s, warmup_passes = warm_up(parse)
    analyzer = doc._stack().analyzer
    rec = analyzer.ocr.recognizer.session.stats
    formula = analyzer.formula_model.stats if analyzer.formula_model is not None else None
    table = analyzer.table_model
    walls = []
    with maybe_profile():
        for _ in range(runs):
            GLOBAL_TRACER.reset()
            flops.reset()
            crops0, calls0, launches0 = rec.items, rec.calls, fused_ctc_argmax.launches
            k2_0 = fused_argmax_int8.launches
            f0 = (formula.dispatches, formula.decode_steps) if formula else (0, 0)
            t0_table = table_counts(table)
            t0 = time.perf_counter()
            out = parse()
            walls.append(time.perf_counter() - t0)
            if not out.markdown:
                raise RuntimeError("the parse produced no Markdown")
    report = GLOBAL_TRACER.report()
    for k, v in report.items():
        print(f"[stage] {k}: {v}", file=sys.stderr)
    crops, calls = rec.items - crops0, rec.calls - calls0
    workload = workload_report(report, crops)
    print(f"[workload] {workload}", file=sys.stderr)
    acc = accounting(report, n_pages, device)
    overlap = overlap_report(report, n_pages, walls[-1], workload, rec.as_dict())
    print(f"[overlap] {overlap}", file=sys.stderr)
    overlap["variance"] = variance_report(n_pages, walls, counts)
    print(f"[variance] {overlap['variance']}", file=sys.stderr)
    rec_s = report.get("ocr_rec", {}).get("total_s", 0.0)
    result = {
        "metric": "e2e_ocr_pages_per_sec",
        "e2e_corpus": corpus, "corpus_pages": counts,
        "pages": n_pages,
        "pages_per_sec": n_pages * len(walls) / sum(walls),
        "pages_per_sec_runs": [n_pages / w for w in walls],
        "warmup_s": warmup_s, "warmup_passes": warmup_passes,
        "stage_ms_per_page": {
            k: report[k]["total_s"] * 1e3 / n_pages for k in STAGES if k in report
        },
        "ocr_rec_detail": {
            "crops": crops, "session_calls": calls,
            "crops_per_sec": crops / rec_s if rec_s else None,
            "ctc_head_launches": fused_ctc_argmax.launches - launches0,
        },
        "workload": workload, "overlap": overlap,
        "mfu": acc["mfu"], "session_stats": acc["session_stats"],
        "device": str(torch.device(device)), "dtype": str(dtype).removeprefix("torch."),
    }
    if formula is not None:
        result["formula_detail"] = {
            "regions": report.get("formula", {}).get("items", 0),
            "decode_dispatches": formula.dispatches - f0[0],
            "decode_steps": formula.decode_steps - f0[1],
            "int8_head": bool(os.environ.get("RAPIDDOC_INT8_HEAD")),
            "quant_head_launches": fused_argmax_int8.launches - k2_0,
        }
    if table is not None:
        result["table_detail"] = {
            "tables": report.get("table", {}).get("items", 0),
            **{k: v - t0_table[k] for k, v in table_counts(table).items()},
        }
    if cuda:
        kernel_ms, wall_ms = device_busy_share(parse)
        result.update({
            "device_busy_share": kernel_ms / wall_ms,
            "device_kernel_ms_per_page": kernel_ms / n_pages,
            "traced_wall_ms_per_page": wall_ms / n_pages,
            "kind": torch.cuda.get_device_name(0),
        })
    return result


def main() -> None:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--corpus", choices=("ocr", "layout"), default="ocr")
    ap.add_argument("--pages", type=int, default=56)
    ap.add_argument("--int8-head", action="store_true",
                    help="RAPIDDOC_INT8_HEAD=1: formula decode steps through K2")
    ap.add_argument("--dtype", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("bench: CUDA is not available (pass --device cpu to rehearse)")
        smi = card()
        print(smi, flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cuda = torch.device(args.device).type == "cuda"
    result = run(args.pages, args.device, dtype, corpus=args.corpus, int8_head=args.int8_head)
    result.update(extra_parts(result, args.device, dtype, args.int8_head, cuda))
    if cuda:
        result["card"] = smi
    print(json.dumps(result), flush=True)


def extra_parts(result: dict, device: str, dtype, int8_head: bool, cuda: bool) -> dict:
    """The root ``bench.py``'s parts after its e2e run, in its order:
    ``corpus``, ``cold_start``, ``ctc_head`` and ``quant_head``,
    ``published_dims``, then the CPU denominators. A part skipped by its
    ``RAPIDDOC_BENCH_SKIP_*`` knob, not asked for, or needing the card
    on another device is {"skipped": why}; a part that raises fails the
    bench."""
    def skipped(why: str) -> dict:
        return {"skipped": why}

    needs_card = f"needs the card (--device {device})"
    out: dict = {}
    out["corpus"] = (skipped("RAPIDDOC_BENCH_SKIP_CORPUS")
                     if os.environ.get("RAPIDDOC_BENCH_SKIP_CORPUS")
                     else bench_corpus(device, dtype, int8_head))
    if not os.environ.get("RAPIDDOC_BENCH_COLDSTART"):
        out["cold_start"] = skipped("set RAPIDDOC_BENCH_COLDSTART=1")
    elif not cuda:
        out["cold_start"] = skipped(needs_card)
    else:
        from .tools.coldstart import rehearse

        out["cold_start"] = rehearse()
        print(f"[cold_start] {out['cold_start']}", file=sys.stderr)
    if cuda:
        from .profile_heads import bench_ctc_head, bench_quant_head

        out["ctc_head"] = bench_ctc_head()
        print(f"[ctc_head] {out['ctc_head']}", file=sys.stderr)
        out["quant_head"] = bench_quant_head()
        print(f"[quant_head] {out['quant_head']}", file=sys.stderr)
    else:
        out["ctc_head"] = out["quant_head"] = skipped(needs_card)
    if os.environ.get("RAPIDDOC_BENCH_SKIP_PUBLISHED"):
        out["published_dims"] = skipped("RAPIDDOC_BENCH_SKIP_PUBLISHED")
    else:
        out["published_dims"] = published_dims(device, dtype)
        print(f"[published-dims] {out['published_dims']}", file=sys.stderr)
    out.update(baseline_report(result["pages_per_sec"], result["workload"], result["pages"],
                               skip_torch=bool(os.environ.get("RAPIDDOC_BENCH_SKIP_BASELINE"))))
    return out


if __name__ == "__main__":
    main()
