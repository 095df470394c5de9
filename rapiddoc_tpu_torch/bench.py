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

One warm-up pass, two timed passes, then one pass under
``torch.profiler`` for the device's busy share (kernel time over wall
time; not counted in pages/s). Prints the card's name and power limit,
then one JSON line with ``bench.py``'s keys: ``pages_per_sec`` (and each
run's), ``stage_ms_per_page`` (render, layout, ocr_det, ocr_crop,
ocr_rec, formula, table, assembly, assembly_final, and ocr, which holds
det, crop and rec), ``ocr_rec_detail`` (crops, session calls, crops/s, K1
launches), ``formula_detail`` (regions, decode dispatches and steps, K2
launches), ``table_detail`` (tables, UNet calls and crops, SLANet and
UniTable decode dispatches and steps) and ``device_busy_share``. On the CPU (``--device cpu``) it
runs the same path for rehearsal and reports no device numbers.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time
from pathlib import Path

import torch

ASSETS = Path(__file__).resolve().parent / "assets"
PDF = ASSETS / "ocr_smoke_doc.pdf"
LAYOUT_PDF = ASSETS / "layout_smoke_doc.pdf"
STAGES = ("render", "layout", "ocr_det", "ocr_crop", "ocr_rec", "ocr", "formula",
          "table", "assembly", "assembly_final")
# layout_smoke_doc.pdf's pages by kind (tests/test_torch_pipeline_layout.py)
LAYOUT_KINDS = {"formula_dense": (0, 1), "table_heavy": (2, 3)}


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
    """(device kernel ms, wall ms) of one traced call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def run(n_pages: int, device: str, dtype: torch.dtype, runs: int = 2,
        corpus: str = "ocr", int8_head: bool = False) -> dict:
    set_corpus_env(corpus, int8_head)
    from . import RapidDoc
    from .ops.ctc_head import fused_ctc_argmax
    from .ops.quant_head import fused_argmax_int8
    from .utils.trace import GLOBAL_TRACER

    pdf, counts = corpus_pdf(corpus, n_pages)
    n_pages = sum(counts.values())
    doc = RapidDoc(device=device, dtype=dtype)
    cuda = torch.device(device).type == "cuda"

    def parse():
        out = doc(pdf, parse_method="ocr")
        if cuda:
            torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    parse()  # warm-up: model build, kernel builds, cuDNN's algorithm picks
    warmup_s = time.perf_counter() - t0
    analyzer = doc._stack().analyzer
    rec = analyzer.ocr.recognizer.session.stats
    formula = analyzer.formula_model.stats if analyzer.formula_model is not None else None
    table = analyzer.table_model
    walls = []
    for _ in range(runs):
        GLOBAL_TRACER.reset()
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
    crops, calls = rec.items - crops0, rec.calls - calls0
    rec_s = report.get("ocr_rec", {}).get("total_s", 0.0)
    result = {
        "metric": "e2e_ocr_pages_per_sec",
        "corpus": corpus, "corpus_pages": counts,
        "pages": n_pages,
        "pages_per_sec": n_pages * len(walls) / sum(walls),
        "pages_per_sec_runs": [n_pages / w for w in walls],
        "warmup_s": warmup_s,
        "stage_ms_per_page": {
            k: report[k]["total_s"] * 1e3 / n_pages for k in STAGES if k in report
        },
        "ocr_rec_detail": {
            "crops": crops, "session_calls": calls,
            "crops_per_sec": crops / rec_s if rec_s else None,
            "ctc_head_launches": fused_ctc_argmax.launches - launches0,
        },
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
    result = run(args.pages, args.device, dtype, corpus=args.corpus, int8_head=args.int8_head)
    if torch.device(args.device).type == "cuda":
        result["card"] = smi
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
