#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (rapiddoc_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, one JSON line each (quant_head and the formula phases one line
per shape or run):
  card    the card's name and power limit (nvidia-smi)
  build   nvcc build of every kernel (K1 ctc_head, K2 quant_head) and of
          the JPEG entropy decoder (host code), all started together,
          each timed
  ctc_head  the fused CTC head kernel against its plain PyTorch version
          at the main path's widths (N = 10240 frames, C = 120) for the
          demo (V = 96) and published (V = 18710) vocabularies, timed
          with the L2 cache flushed before every launch, beside the
          plain version and a PyTorch library yardstick
  ocr     the OCR system on the committed fixture pages: the bf16 main
          path (timed, kernel launches counted) and an fp32 run, each
          held to the JAX package's golden output in its dtype, and the
          det and rec models' bf16-vs-fp32 error held to the JAX
          package's own
  jpeg    the JPEG decoder on the fixture PDF's three streams: the
          compiled entropy decode's coefficients equal to the plain
          version's, the decoded and the rendered pages' sha256 equal to
          the golden's (PIL's and the JAX package's), ms per page of each;
          then on the committed matrix (assets/jpeg_matrix.npz: grey,
          4:4:4, 4:2:2, 4:2:0, sizes not multiples of 16, restart
          intervals, corrupt streams) the compiled and the plain entropy
          decode give equal coefficients or the same JpegError, and the
          decoded pixels' sha256 (or the error) is the one recorded from
          PIL by tests/test_torch_jpeg.py
  pipeline  the system's main path, RapidDoc(device="cuda")(pdf,
          parse_method="ocr") on the fixture PDF with layout, formula
          and table disabled: fp32 Markdown equal to the JAX package's
          fp32 golden; bf16 (timed, K1's launches counted and held to the
          rec dispatches) within limits of the bf16 golden, and the
          host stages rebuilding its Markdown from its own model output
          exactly; pages/s, stage ms/page and the device's busy share
  quant_head  the int8 fused head kernel against its plain version at
          the formula decode's widths (N = 4 and 16 rows, K = 512) for
          the demo (V = 57) and published (V = 50000) vocabularies, timed
          with the L2 cache flushed before every launch, beside the plain
          version and the bf16 head the JAX package runs by default
  formula the demo formula recognizer on the committed fixture crops in
          four runs (bf16 and fp32, each with the plain lm_head and with
          the int8 head through K2), each held to the JAX package's
          golden ids for its mode; K2's launches held to the decode
          steps; the bf16-vs-fp32 error of the encoder memory and of
          the first decode step's logits held to the JAX package's own
  formula_published  the published PP-FormulaNet_plus-M shape (B6
          encoder, 6 decoder layers, V = 50000, random weights from a
          seed), bf16, length bucket 256, with the int8 head through K2
          and again through its plain version: the token streams must
          be equal
  layout  the demo RT-DETR layout detector on the layout fixture's four
          rendered pages (their sha256 the golden's): fp32 (TF32 off)
          dets equal to the JAX package's golden (labels and order,
          boxes within 0.05 px), bf16 dets within limits of the bf16
          golden; ms/page at batches 1, 2, 4 and 8; the published shape
          (B4, 800x800, 300 queries, 6 decoder layers, masks, random
          weights from a seed) at batch 8: pages/s and the device's busy
          share
  pipeline_layout  RapidDoc(device="cuda")(pdf, parse_method="ocr") on
          the layout fixture with RAPIDDOC_DEMO_LAYOUT=1
          RAPIDDOC_DISABLE_TABLE=1 (layout, OCR with K1, formula regions
          through the demo recognizer, missed-text recovery, span images
          JPEG-encoded): fp32 Markdown, content list, LaTeX and payload
          sha256 equal to the golden's with the int8 head off, on, and
          on with one page per window (DeferredAR); the bf16 main path
          with the int8 head on (timed, K1's launches held to the rec
          dispatches and K2's to the decode steps) within limits of the
          bf16 golden; pages/s, stage ms/page and the device's busy share
  table   the table models (demo checkpoints) on the layout fixture's 15
          table crops (their sha256 the golden's): fp32 (TF32 off)
          classifier kinds, UNet cells and grid, SLANet and UniTable
          token streams equal to the JAX package's, SLANet's boxes within
          0.05 px and every differing UNet line bit a near-tie (|l1 - l0|
          < 1e-3); bf16 within bands of the JAX package's bf16; ms per
          table of the classifier and the UNet at batches 1, 2 and 4 (the
          UNet split into host preprocessing, device and host cell
          recovery), SLANet ms per decode step at buckets 4 and 16; the
          published UniTable shape (12x768 encoder, 4x768 decoder, random
          weights from a seed) at batch 4 and max_len 256: decode steps/s
          and the device's busy share
  pipeline_table  RapidDoc(device="cuda")(pdf, parse_method="ocr") on
          the layout fixture with RAPIDDOC_DEMO_LAYOUT=1 and the table
          stage on: fp32 Markdown, content list, every table's HTML,
          LaTeX and payload sha256 equal to the golden's, in one window
          and with one page per window (DeferredAR's table half)
  main_path  the same parse in bf16 with the int8 head on, this slice's
          main path: timed, K1's launches held to the rec dispatches and
          K2's to the decode steps (counted from 0 for this run), within
          bands of the bf16 golden; pages/s, stage ms/page (table
          included) and the device's busy share
  ocr_family, table_ocr, orientation  the per-language rec, the OCR
          knobs, word boxes and published-format OCR; OCR inside tables;
          the orientation classifier in the parse (each fp32 equal to its
          golden, bf16 within bands, K1's launches held to the rec
          dispatches)
  seal    seal OCR on the five committed crops: fp32 circles, ellipses,
          detect_polys polygons, the regions read, the texts and
          _run_seals with seal dets put in place equal to the JAX
          package's golden; bf16 texts within a band; ms a seal; K1's
          launches held to the rec dispatches; the 8-bit layout wire's
          fp32 dets on the layout fixture equal to the golden's
  image_inputs  a PNG path, JPEG bytes and an array through
          images_to_pdf (bytes equal to the JAX package's) into RapidDoc
          with every stage on: fp32 parses, parse_batch and
          extract_original_image's payloads equal to the golden; bf16
          with the int8 head over the three in one parse_batch: pages/s,
          K1's launches held to the rec dispatches, K2's to the decode
          steps; then a BMP, a GIF, an LZW and a G4 TIFF, a 16-bit and an
          interlaced PNG and a float32 and a uint16 array: rasters and
          PDFs equal to the JAX package's, host ms a page of each
          decoder, and one fp32 parse_batch of the eight (Markdown and
          content list equal to the golden, K1's launches held to the rec
          dispatches)
  vector  born-digital pages (vector paths, clips, masks, Type3 glyphs)
          rendered on the host, each raster's sha256 equal to the
          golden's at 200 and 72 dpi; fp32 "ocr" (int8 head off and on)
          and "auto" parses equal to the golden; bf16 timed, launches
          held to the rec dispatches and decode steps
  text    text from font programs (TrueType, symbol-cmap CID TrueType,
          bare CFF, Type1) and the fallback font (F1's program, read from
          the fixture): rasters' sha256 equal to the golden's at 200 and
          72 dpi, render ms/page and the glyph-tile cache's hit rate;
          fp32 "ocr" (int8 head off and on) and "txt" parses equal to the
          golden; bf16 timed, launches held to the rec dispatches and
          decode steps; with no fallback font (Aileron at 10 px, which
          FreeType hints) the 72 dpi pages within TEXT_AILERON_BAND
  onnx    the ONNX interpreter in fp32 (TF32 off): Magika on 13 byte
          inputs (labels equal to the JAX package's golden, scores within
          1e-4, ms a call); the contract graphs written by the port's
          writer from seeds (tests/test_onnx_family_graphs.py's four
          families and the 1024 x 1024 wired-table contract, outputs held
          to the golden, ms each); RapidDoc with a pp_doclayoutv3.onnx in
          a temporary models dir (Markdown and content list equal to the
          JAX package's, K1's launches held to the rec dispatches) and on
          suffix-less bytes (the sniff and the Markdown equal)
  codecs  JBIG2, CCITT, progressive and CMYK JPEG, raw colour spaces,
          shadings and patterns (see ``phase_codecs``)
  office  Office documents through RapidDoc on the card: a docx, a pptx,
          an xlsx and a zero-byte docx in "url" and "data_uri" modes,
          Markdown, content list and middle json equal to the JAX
          package's golden; host-only, its seconds reported
Then a timing line (seconds by phase), a ``{"kernels": [...]}`` line,
the nvidia-smi line, and last
``{"ok": true, "device": {...}}``. Any failure exits non-zero without
that last line. Needs the repository checkout around it and a card.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_FRAMES, C_FEAT = 10240, 120  # REC_BUCKETS batch 128 x T 80; neck width
VOCABS = (96, 91, 18710)  # demo charset; Cyrillic demo; published ppocrv6_small_dict.txt
H100_BF16_FLOPS = 989e12
H100_BYTES_PER_S = 3.35e12
TIMED_RUNS = 3
CONF_RTOL, CONF_ATOL = 1e-5, 1e-8  # K1's conf against its plain version
# The bf16 main path against the JAX package's bf16 golden. The two
# frameworks round bf16 at different places, and the demo models'
# near-tie characters flip under any such change: XLA's own
# --xla_allow_excess_precision=false moves 13 of the 74 golden lines. So
# these limits come from the port's bf16 on the CPU against the same
# golden (2 boxes unmatched, 51/74 lines equal, CER 0.0374; both read by
# `python tests/test_torch_ocr_system.py --compare`), with a margin of 2
# boxes, 7 lines and 0.0126 CER for the card's summation order.
BF16_MAX_UNMATCHED, BF16_MIN_EXACT, BF16_MAX_CER = 4, 0.60, 0.05
# The text limits above would pass a bf16 path that ran in fp32, so the
# models are also held at the tensor level: the bf16-vs-fp32 relative
# error of the det prob map and of the rec features must lie within this
# band of the JAX package's own (the golden's "bf16_rel_err"). The
# port's reading on the CPU is 0.86 (det) and 0.77 (rec) of it. A path
# that rounds only its weights to bf16 and computes in fp32 falls below
# the band, and full fp32 far below it.
BF16_GAP_BAND = (0.6, 1.5)
KERNELS = ("ctc_head", "quant_head")
# jpeg_entropy and bilevel: host code, not kernels
BUILDS = KERNELS + ("jpeg_entropy", "bilevel")
# The pipeline's bf16 Markdown against the JAX package's bf16 golden: the
# ocr phase's limits (line share and CER). The port's bf16 on the CPU
# reads 56/74 lines equal (0.757), CER 0.0083, and the JAX package's own
# fp32 against its bf16 53/74, CER 0.0247 (``python
# tests/test_torch_api.py --compare``).
PIPELINE_BF16_MIN_EXACT, PIPELINE_BF16_MAX_CER = 0.60, 0.05
QUANT_K = 512  # the formula decoder's d_model
QUANT_ROWS = (4, 16)  # the decode's batch_chunks sizes
QUANT_VOCABS = (57, 50000)  # demo vocabulary; published PP-FormulaNet_plus-M
# written before each timed K2 launch: ten times the 50 MB L2, and about
# 0.2 ms of device work, which covers the host's queueing of the timed
# call, so that the timed span holds device work only
L2_FLUSH_BYTES = 512 << 20
FORMULA_MODES = ("bf16", "bf16_int8", "fp32", "fp32_int8")
# The demo recognizer in bf16 against the JAX package's bf16 golden ids
# (14 crops). The port's bf16 on the CPU reads 9/14 crops equal, token
# error rate 0.084 with the plain head, and 8/14, 0.063 with the int8
# head against its own golden (``python
# tests/test_torch_formula_system.py --compare``); an AR decode turns
# one flipped near-tie into a different tail, and the JAX package's own
# bf16 and fp32 agree on 12/14 (0.033). The card's summation order is a
# third rounding, so the margin is 3 crops and 0.066 of token error
# rate.
FORMULA_BF16_MIN_EQUAL, FORMULA_BF16_MAX_TER = 5, 0.15
# The token limits above would pass a decoder that ran in fp32, so the
# bf16 run is also held at the tensor level, each gap within
# BF16_GAP_BAND of the JAX package's own (the golden's key): the encoder
# memory, and the first decode step's logits with the plain head.
FORMULA_GAPS = {"memory": "memory_bf16_rel_err",
                "first_step_logits": "first_step_logits_bf16_rel_err"}
# The layout path (tests/test_torch_pipeline_layout.py holds the
# generator of its fixture and golden). The bf16 detector against the
# JAX package's bf16 dets: the port's bf16 on the CPU matches 56/56
# golden dets with the same label at IoU >= 0.9, and the JAX package's
# own fp32 dets match 52/56 of its bf16 ones (python
# tests/test_torch_pipeline_layout.py --compare); the margin is 5 dets.
LAYOUT_BF16_MIN_MATCHED = 0.90
LAYOUT_BOX_TOL = 0.05  # px, fp32 dets against the fp32 golden
LAYOUT_BATCHES = (1, 2, 4, 8)
LAYOUT_TIMED_RUNS = 2  # per batch size; the published shape is timed once
# The bf16 parse of the layout fixture against the JAX package's bf16
# golden (int8 head on). The demo formula recognizer flips most LaTeX
# strings under any change of rounding (the JAX package's own fp32 and
# bf16 agree on 2 of 18), and a box that moves a pixel changes its span
# image's digest name, so these limits are on lines, characters and
# counts. The port's bf16 on the CPU with the int8 head: 136/169 lines
# equal (0.805), CER 0.214, LaTeX CER 0.499, 18/18 formulas and 17/17
# images; the JAX package's fp32 against its bf16: 0.769, 0.197, LaTeX
# CER 0.626 (python tests/test_torch_pipeline_layout.py --compare). The
# margins: 0.105 of lines, 0.106 of CER, 0.151 of LaTeX CER, 2 formulas
# or images.
LAYOUT_PARSE_BF16 = {"min_exact_share": 0.70, "max_cer": 0.32, "max_latex_cer": 0.65,
                     "max_count_gap": 2}
# The table path (tests/test_torch_table.py holds the generator of its
# crops and golden). fp32: a UNet line bit may differ from the JAX
# package's only where |l1 - l0| is below TABLE_UNET_TIE, and SLANet's
# boxes stay within TABLE_SLANET_BOX_TOL px of the golden's.
TABLE_UNET_TIE = 1e-3
TABLE_SLANET_BOX_TOL = 0.05
TABLE_BATCHES = (1, 2, 4)  # UNet and classifier batches timed
TABLE_SLANET_BUCKETS = (4, 16)
TABLE_TIMED_RUNS = 2
UNITABLE_MAX_LEN = 256
UNITABLE_PUBLISHED_BATCH = 4
# The bf16 table models on the 15 crops against the JAX package's bf16
# outputs, and the bf16 parse with the table stage on against the bf16
# int8 golden (python tests/test_torch_table.py --compare). The port's
# bf16 on the CPU: kinds 14/15, 1.9e-4 of the UNet's bits differ, grids
# 14/15, SLANet token CER 0.0022, UniTable 0.0094; the JAX package's own
# fp32 against its bf16: 14/15, 8.7e-4, 13/15, 0.0022, 0.028. The parse:
# 144/169 lines equal (0.852), CER 0.096, LaTeX CER 0.499, 11/15 tables'
# HTML equal, 18/18 formulas, 1/1 image; the JAX package's fp32 against
# its bf16: 0.805, 0.121, 0.626, 6/15 tables. The margins: one kind, 2.3x
# the JAX package's own bit share, two grids, 0.05 of token CER, 0.10 of
# lines and CER, 0.15 of LaTeX CER, 4 tables, 2 counts.
TABLE_BF16 = {"min_kinds_equal": 13, "max_unet_bit_diff_share": 2e-3,
              "min_grids_equal": 12, "max_slanet_token_cer": 0.05,
              "max_unitable_token_cer": 0.06}
TABLE_PARSE_BF16 = {"min_exact_share": 0.75, "max_cer": 0.20, "max_latex_cer": 0.65,
                    "max_count_gap": 2, "min_tables_equal": 7}
# The seventh slice's bf16 runs against the JAX package's bf16 goldens,
# from the port's bf16 on the CPU (python tests/test_torch_ocr_family.py
# --compare, tests/test_torch_table_ocr.py --compare and
# tests/test_torch_orientation.py --compare), with margins for the card's
# summation order:
# - RapidDoc(lang="ru"): 18/21 lines equal (0.857), CER 0.0155 (the JAX
#   package's own fp32 against its bf16: the same); margin 0.157, 0.045.
# - The OCR knobs on the three fixture pages, worst of the eight: 0.649 of
#   lines equal, CER 0.0408, 2 boxes unmatched (the JAX package's own:
#   0.689, 0.048, 2); margin 0.10 of lines, 0.03 of CER, 2 boxes.
# - The published-format rec on 17 lines of random-head text (about 80
#   characters each from 18 710 classes): 3 lines equal (the JAX
#   package's own fp32 against its bf16: 2); margin 2.
# - The table stage with OCR (default configuration, 17 crops): 4 tables'
#   HTML equal, CER 0.154 (the JAX package's own: 2, 0.170); margin 2
#   tables, 0.10 of CER.
# - The landscape fixture with USE_DOC_ORIENTATION_CLASSIFY=1, every stage
#   on: angles 2/2 equal, 75/108 lines equal (0.694), CER 0.243 (the JAX
#   package's own: 0.704, 0.480; the turned pages' text is mostly
#   near-tie characters); margin 1 angle, 0.15 of lines, 0.2 of CER.
RU_BF16 = {"min_exact_share": 0.70, "max_cer": 0.06}
KNOB_BF16 = {"max_unmatched": 4, "min_exact_share": 0.55, "max_cer": 0.07}
PUBLISHED_BF16_MIN_EQUAL = 1
TABLE_OCR_BF16 = {"min_equal": 2, "max_cer": 0.25}
ORIENTATION_BF16 = {"min_angles_equal": 1, "min_exact_share": 0.55, "max_cer": 0.45}
DET_MEAN = (0.485, 0.456, 0.406)
DET_STD = (0.229, 0.224, 0.225)


# The published-format OCR checkpoints the ocr_family phase writes into a
# models dir (write_published_ocr): the demo det's leaves as
# ocr_det_v6_small.npz, and the demo rec's backbone and neck under a
# (120, PUBLISHED_V) head from PUBLISHED_HEAD_SEED as ocr_rec_v6_small.npz.
# The registry decodes it through ppocrv6_small_dict.txt (18 708 entries,
# plus blank and space).
PUBLISHED_V = 18710
PUBLISHED_HEAD_SEED = 0
PUBLISHED_HEAD_STD = 4.0  # times 1/sqrt(C): logit gaps well above bf16 rounding


class SmokeFailure(Exception):
    pass


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ctc_bound_ms(n: int, c: int, v: int) -> tuple[float, str]:
    """Least time for the head on an H100: bf16 operations 2*N*C*V at
    989 TFLOP/s against bytes read once (x, W bf16; b fp32) and written
    once (ids int32, conf fp32) at 3.35 TB/s."""
    ops = 2.0 * n * c * v
    nbytes = n * c * 2 + c * v * 2 + v * 4 + n * 8
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def write_published_ocr(models_dir: Path) -> None:
    """Published-format OCR checkpoints (flat flax npz, float32) in
    ``models_dir``, made from the in-repo demo ones and a seed: a
    random-init det finds one box a page and a random-init rec emits only
    blanks, so the det keeps the demo's leaves and the rec the demo's
    backbone and neck, under a head of the published width."""
    import numpy as np

    from rapiddoc_tpu_torch.config import DEMO_ASSETS_DIR
    from rapiddoc_tpu_torch.models.weights import load_npz

    det = load_npz(DEMO_ASSETS_DIR / "ocr_det_demo.npz")
    rec = load_npz(DEMO_ASSETS_DIR / "ocr_rec_demo.npz")
    c = rec["params/head/kernel"].shape[0]
    rng = np.random.default_rng(PUBLISHED_HEAD_SEED)
    rec["params/head/kernel"] = (rng.standard_normal((c, PUBLISHED_V))
                                 * (PUBLISHED_HEAD_STD / np.sqrt(c))).astype(np.float32)
    rec["params/head/bias"] = np.zeros(PUBLISHED_V, np.float32)
    models_dir.mkdir(parents=True, exist_ok=True)
    np.savez(models_dir / "ocr_det_v6_small.npz", **det)
    np.savez(models_dir / "ocr_rec_v6_small.npz", **rec)


def compare_tables(got: list, want: list) -> dict:
    """Tables' HTML against a golden's: how many are equal, and the
    character error rate over the golden's HTML."""
    edits = sum(_edits(g, w) for g, w in zip(got, want))
    return {"tables": len(want), "equal": sum(g == w for g, w in zip(got, want)),
            "cer": edits / max(sum(len(w) for w in want), 1)}


def check_table_ocr_bf16(vs: dict) -> None:
    check(vs["equal"] >= TABLE_OCR_BF16["min_equal"],
          f"table_ocr bf16: {vs['equal']} of {vs['tables']} tables equal "
          f"< {TABLE_OCR_BF16['min_equal']}")
    check(vs["cer"] <= TABLE_OCR_BF16["max_cer"],
          f"table_ocr bf16: HTML CER {vs['cer']:.4f} > {TABLE_OCR_BF16['max_cer']}")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": line})
    return line


def phase_build() -> None:
    """Every kernel's nvcc build, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from rapiddoc_tpu_torch.ops import build

    def timed(name: str):
        t0 = time.perf_counter()
        path = build.build(name)
        return name, path, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        built = list(pool.map(timed, BUILDS))
    wall = time.perf_counter() - t0
    for name, path, seconds in built:
        build.load(name)
        emit({"phase": "build", ("kernel" if name in KERNELS else "host_code"): name,
              "seconds": seconds, "all_builds_wall_seconds": wall,
              "library": str(path.relative_to(ROOT))})


def phase_ctc_head() -> dict:
    """K1 against its plain version at the main path's widths, the weight
    in the recognizer's aligned layout; each call timed alone after an L2
    flush, beside the plain version and a PyTorch library yardstick.
    Returns the measurements by V."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.ops.ctc_head import (
        ctc_argmax_plain,
        fused_ctc_argmax,
        pad_ctc_kernel,
        schedule,
    )

    def library(x, w, b):
        # one PyTorch matmul + softmax reduction: the yardstick, never
        # called by the port
        logits = torch.matmul(x, w).float() + b
        p = torch.softmax(logits, dim=-1)
        return p.max(dim=-1)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    results = {}
    for v in VOCABS:
        rng = np.random.default_rng(v)
        x = torch.from_numpy(rng.standard_normal((N_FRAMES, C_FEAT)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((C_FEAT, v)) * 0.1).astype(np.float32))
        b = torch.from_numpy((rng.standard_normal(v) * 0.1).astype(np.float32))
        x, w, b = x.cuda().to(torch.bfloat16), w.cuda().to(torch.bfloat16), b.cuda()
        wk = pad_ctc_kernel(w)  # the layout TextRecognizer's head reads
        ids, conf = fused_ctc_argmax(x, wk, b)
        torch.cuda.synchronize()
        pids, pconf = ctc_argmax_plain(x, w, b)
        logits = x.float() @ w.float() + b
        top2 = logits.topk(2, dim=-1).values
        decisive = (top2[:, 0] - top2[:, 1]) > 1e-3
        id_mismatch = int(((ids != pids) & decisive).sum())
        err = float((conf - pconf).abs().max())
        # conf is held relatively: at V = 18710 it is about 3e-3, where a
        # lost vocabulary range's exp-sum would move it by far less than
        # any absolute limit that also suits V = 96
        over = int(((conf - pconf).abs() > CONF_RTOL * pconf + CONF_ATOL).sum())
        check(bool(((ids >= 0) & (ids < v)).all()), f"ctc_head V={v}: id out of range")
        check(id_mismatch == 0, f"ctc_head V={v}: {id_mismatch} ids differ from the plain version")
        check(over == 0, f"ctc_head V={v}: conf of {over} rows off by more than "
                         f"{CONF_RTOL} x plain + {CONF_ATOL}")
        bound, by = ctc_bound_ms(N_FRAMES, C_FEAT, v)
        plan = schedule(N_FRAMES, v)
        rec = {
            "n": N_FRAMES, "c": C_FEAT, "v": v,
            "ids_equal_where_margin_gt_1e-3": True,
            "ids_differing_near_ties": int((ids != pids).sum()),
            "max_abs_err": err,
            "max_rel_err": float(((conf - pconf).abs() / pconf).max()),
            "n_ranges": plan.n_ranges, "merge_launch": plan.merge,
            "kernel_ms": flushed_ms(lambda: fused_ctc_argmax(x, wk, b), flush),
            # launches queued back to back: the host's cost of one
            # wrapper call wherever that exceeds the kernel's device time
            "back_to_back_ms": cuda_ms(lambda: fused_ctc_argmax(x, wk, b)),
            "plain_ms": flushed_ms(lambda: ctc_argmax_plain(x, w, b), flush),
            "library_ms": flushed_ms(lambda: library(x, w, b), flush),
            "l2_flushed": True, "bound_ms": bound, "bound_by": by,
        }
        emit({"phase": "ctc_head", **rec})
        results[v] = rec
    return results


def flushed_ms(fn, flush, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` with ``flush`` (a buffer larger than the
    L2 cache) overwritten before every call, so that each call reads its
    inputs from device memory as a decode step, with the rest of the
    decoder's weights streamed in between, would; CUDA events bracket
    each call alone."""
    import torch

    for _ in range(warmup):
        flush.zero_()
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        flush.zero_()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / iters


def quant_bound_ms(n: int, k: int, v: int) -> tuple[float, str]:
    """Least time for the int8 head on an H100: 2*N*K*V operations at the
    bf16 rate (989 TFLOP/s) against bytes read once (x bf16, wq int8,
    scale and bias fp32) and written once (ids int32, conf fp32) at
    3.35 TB/s."""
    ops = 2.0 * n * k * v
    nbytes = n * k * 2 + k * v + v * 8 + n * 8
    t_ops, t_bytes = ops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def phase_quant_head() -> dict:
    """K2 against its plain version at the formula decode's widths;
    returns the measurements by (N, V)."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.ops.layout import aligned_rows
    from rapiddoc_tpu_torch.ops.quant_head import (
        fused_argmax_int8,
        quant_argmax_plain,
        quantize_weight_int8,
        schedule,
    )

    def library(xb, wb):
        # the bf16 lm_head + argmax that the JAX package runs by default:
        # one PyTorch matmul and the reduction, never called by the port
        logits = torch.matmul(xb, wb).float()
        top, ids = logits.max(dim=-1)
        return ids, 1.0 / torch.exp(logits - top[:, None]).sum(-1)

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    results = {}
    for v in QUANT_VOCABS:
        rng = np.random.default_rng(v)
        w = torch.from_numpy((rng.standard_normal((QUANT_K, v)) * 0.05).astype(np.float32)).cuda()
        bias = torch.from_numpy((rng.standard_normal(v) * 0.1).astype(np.float32)).cuda()
        wq, scale = quantize_weight_int8(w)
        wq = aligned_rows(wq)  # the layout FormulaRecognizer's head reads
        wb = w.to(torch.bfloat16)
        for n in QUANT_ROWS:
            x = torch.from_numpy(rng.standard_normal((n, QUANT_K)).astype(np.float32))
            x = x.cuda().to(torch.bfloat16)
            ids, conf = fused_argmax_int8(x, wq, scale, bias)
            torch.cuda.synchronize()
            pids, pconf = quant_argmax_plain(x, wq, scale, bias)
            differ = int((ids != pids).sum())
            plan = schedule(n, v)
            over = int(((conf - pconf).abs() > CONF_RTOL * pconf + CONF_ATOL).sum())
            check(differ == 0, f"quant_head N={n} V={v}: {differ} ids differ from the plain version")
            check(over == 0, f"quant_head N={n} V={v}: conf of {over} rows off by more than "
                             f"{CONF_RTOL} x plain + {CONF_ATOL}")
            bound, by = quant_bound_ms(n, QUANT_K, v)
            rec = {
                "n": n, "k": QUANT_K, "v": v, "ids_equal": True,
                "max_abs_err": float((conf - pconf).abs().max()),
                "max_rel_err": float(((conf - pconf).abs() / pconf).max()),
                "n_blocks": plan.n_blocks, "merged_in_kernel": plan.merge,
                "kernel_ms": flushed_ms(lambda: fused_argmax_int8(x, wq, scale, bias), flush),
                # launches queued back to back: the weight stays in L2,
                # and the time is the host's cost of one wrapper call
                # wherever that exceeds the kernel's device time
                "back_to_back_ms": cuda_ms(lambda: fused_argmax_int8(x, wq, scale, bias)),
                "plain_ms": flushed_ms(lambda: quant_argmax_plain(x, wq, scale, bias), flush),
                "library_ms": flushed_ms(lambda: library(x, wb), flush),
                "l2_flushed": True, "bound_ms": bound, "bound_by": by,
            }
            emit({"phase": "quant_head", **rec})
            results[(n, v)] = rec
    return results


def first_difference(got: list, want: list) -> int:
    """The first step at which two token streams differ."""
    for step, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return step
    return min(len(got), len(want))


def compare_ids(got: list, want: list, label: str | None) -> dict:
    """Crops with equal token ids, the token error rate (edit distance
    over the golden's tokens) and each differing crop with its first
    differing step. With a label, prints each differing crop to
    stderr."""
    differ = [[i, first_difference(g, w)] for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if label:
        for i, step in differ:
            print(f"[{label}] crop {i} differs from step {step}", file=sys.stderr)
    tokens = sum(len(w) for w in want)
    return {"crops": len(want), "equal": len(want) - len(differ),
            "ter": sum(_edits(g, w) for g, w in zip(got, want)) / max(tokens, 1),
            "differ": differ}


def check_formula_bf16(vs_golden: dict, gaps: dict, golden: dict) -> None:
    """The bf16 formula limits: ids against the bf16 golden, and the
    bf16-vs-fp32 error of the encoder memory and of the first decode
    step's logits each within BF16_GAP_BAND of the JAX package's (the
    golden's FORMULA_GAPS keys)."""
    check(vs_golden["equal"] >= FORMULA_BF16_MIN_EQUAL,
          f"formula bf16: {vs_golden['equal']} crops equal < {FORMULA_BF16_MIN_EQUAL}")
    check(vs_golden["ter"] <= FORMULA_BF16_MAX_TER,
          f"formula bf16: token error rate {vs_golden['ter']:.4f} > {FORMULA_BF16_MAX_TER}")
    lo, hi = BF16_GAP_BAND
    for name, key in FORMULA_GAPS.items():
        ratio = gaps[name] / golden[key]
        check(lo <= ratio <= hi, f"formula bf16: {name} bf16-vs-fp32 error {gaps[name]:.3g} is "
                                 f"{ratio:.3f} x the JAX package's, outside [{lo}, {hi}]")


def formula_crops() -> list:
    import numpy as np

    with np.load(ROOT / "rapiddoc_tpu_torch" / "assets" / "formula_smoke_crops.npz") as z:
        return [z[f"crop{i:02d}"] for i in range(len(z.files))]


def first_step_logits(rec, images):
    """The first decode step's logits (BOS at position 0, plain lm_head,
    caches of the default length bucket) for uint8 images on the
    recognizer's device, as float32 (B, V)."""
    import torch

    cfg = rec.mbart_cfg
    with torch.no_grad():
        memory = rec.encode(images)
        mem_k, mem_v = rec.mem_proj(memory)
        b = memory.shape[0]
        shape = (cfg.layers, b, rec.config.default_length_bucket, cfg.heads, cfg.d_model // cfg.heads)
        caches = [torch.zeros(shape, dtype=memory.dtype, device=memory.device) for _ in range(2)]
        cur = torch.full((b, 1), cfg.bos_token_id, dtype=torch.int32, device=memory.device)
        logits, _, _ = rec.decoder(cur, *caches, 0, mem_k, mem_v, None)
    return logits[:, -1].float()


def formula_gaps(bf16_rec, fp32_rec, crops) -> dict:
    """bf16-vs-fp32 relative errors on the crops that land in the first
    image bucket, each recognizer on its own device in its own dtype: the
    encoder memory ("memory") and the first decode step's logits
    ("first_step_logits"), which the decoder adds to the memory's."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.models.formula.engine import preprocess_formula

    canvases = [preprocess_formula(c) for c in crops]
    images = np.stack([x for x, b in canvases if b == canvases[0][1]])
    with torch.no_grad():
        mems = [r.encode(r.to_device(images)).float().cpu().numpy() for r in (bf16_rec, fp32_rec)]
    logits = [first_step_logits(r, r.to_device(images)).cpu().numpy() for r in (bf16_rec, fp32_rec)]
    return {"memory": rel_err(*mems), "first_step_logits": rel_err(*logits)}


def split_ms(rec, crops, max_len: int) -> tuple[float, float]:
    """Encoder and decode milliseconds of one pass over the crops'
    dispatch plan, each synchronized on its own."""
    import torch

    enc = dec = 0.0
    for _, batch in rec.chunks(crops):
        images = rec.to_device(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        memory = rec.encode(images)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        rec.decode(memory, max_len)
        torch.cuda.synchronize()
        enc, dec = enc + t1 - t0, dec + time.perf_counter() - t1
    return enc * 1e3, dec * 1e3


def timed_predict(rec, crops) -> dict:
    """One warm-up and one timed ``batch_predict(return_ids=True)``, with
    the K2 launch count set to 0 just before the timed run and read just
    after."""
    import torch

    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8

    rec.batch_predict(crops, return_ids=True)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    before = (rec.stats.dispatches, rec.stats.decode_steps, rec.stats.realized_steps)
    fused_argmax_int8.launches = 0
    t0 = time.perf_counter()
    ids = rec.batch_predict(crops, return_ids=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_argmax_int8.launches
    dispatches, steps, realized = (
        a - b for a, b in zip((rec.stats.dispatches, rec.stats.decode_steps,
                               rec.stats.realized_steps), before)
    )
    return {"ids": ids, "wall_s": wall, "crops_per_s": len(crops) / wall,
            "dispatches": dispatches, "decode_steps": steps, "realized_steps": realized,
            "ms_per_step": wall * 1e3 / max(steps, 1), "k2_launches": launches}


def phase_formula() -> int:
    """The demo recognizer in four runs; returns K2's launches in the
    bf16 int8-head run."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_formula_recognizer

    crops = formula_crops()
    golden = json.loads((ROOT / "rapiddoc_tpu_torch" / "assets"
                         / "formula_smoke_golden.json").read_text())
    # the fp32 runs are full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    recs, runs = {}, {}
    for mode in FORMULA_MODES:
        int8 = mode.endswith("int8")
        dtype = torch.float32 if mode.startswith("fp32") else torch.bfloat16
        rec = build_formula_recognizer(dtype=dtype, int8_head=int8)
        run = timed_predict(rec, crops)
        run["encoder_ms"], run["decode_ms"] = split_ms(rec, crops, rec.config.default_length_bucket)
        run["vs_golden"] = compare_ids(run.pop("ids"), golden[mode]["ids"], f"formula {mode}")
        if int8:
            check(run["k2_launches"] == run["decode_steps"] > 0,
                  f"formula {mode}: {run['k2_launches']} K2 launches for "
                  f"{run['decode_steps']} decode steps")
        else:
            check(run["k2_launches"] == 0, f"formula {mode}: K2 launched with the plain head")
        check(run["decode_steps"] >= run["realized_steps"], f"formula {mode}: fewer steps than realized")
        recs[mode], runs[mode] = rec, run
        emit({"phase": "formula", "mode": mode, "crops": len(crops),
              "length_bucket": rec.config.default_length_bucket, **run})
    gaps = formula_gaps(recs["bf16"], recs["fp32"], crops)
    emit({"phase": "formula", "bf16_rel_err": gaps,
          "jax_bf16_rel_err": {name: golden[key] for name, key in FORMULA_GAPS.items()},
          "share_of_jax": {name: gaps[name] / golden[key] for name, key in FORMULA_GAPS.items()}})
    # fp32 against the JAX package's fp32 ids: the correctness gate
    for mode in ("fp32", "fp32_int8"):
        vs = runs[mode]["vs_golden"]
        check(vs["equal"] == vs["crops"], f"formula {mode}: ids differ on crops {vs['differ']}")
    for mode in ("bf16", "bf16_int8"):
        check_formula_bf16(runs[mode]["vs_golden"], gaps, golden)
    return runs["bf16_int8"]["k2_launches"]


def phase_formula_published() -> int:
    """The published shape, random weights, through K2 and through its
    plain version; returns K2's launches in the timed run."""
    import torch

    from rapiddoc_tpu_torch.models.formula.engine import FormulaConfig, FormulaRecognizer
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8, quant_argmax_plain

    crops = formula_crops()
    cfg = FormulaConfig()
    t0 = time.perf_counter()
    rec = FormulaRecognizer(None, config=cfg, seed=0, int8_head=True)
    build_s = time.perf_counter() - t0
    run = timed_predict(rec, crops)
    check(run["k2_launches"] == run["decode_steps"] > 0,
          f"formula_published: {run['k2_launches']} K2 launches for {run['decode_steps']} steps")
    # the same decode with the plain version as the head, its inputs kept
    # so that a difference can be shown with the plain top-two margin
    calls = []
    first_dispatch = rec.stats.dispatches

    def plain_head(x, wq, scale, bias):
        calls.append((rec.stats.dispatches - first_dispatch, x.detach().clone()))
        return quant_argmax_plain(x, wq, scale, bias)

    rec.argmax_int8 = plain_head
    plain_ids = rec.batch_predict(crops, return_ids=True)
    rec.argmax_int8 = fused_argmax_int8
    differ = []
    wq, scale = rec._int8_head()
    for d, (idxs, _) in enumerate(rec.chunks(crops)):
        steps = [x for dd, x in calls if dd == d]
        for row, i in enumerate(idxs):
            if run["ids"][i] != plain_ids[i]:
                step = first_difference(run["ids"][i], plain_ids[i])
                # the plain version's logits (the decode's bias is zero)
                x = steps[step][row].to(torch.bfloat16).float()
                top2 = ((x @ wq.to(torch.bfloat16).float()) * scale).topk(2).values
                differ.append({"crop": i, "step": step,
                               "plain_top2_margin": float(top2[0] - top2[1])})
    emit({"phase": "formula_published", "config": {
              "backbone": cfg.backbone_size, "out_index": cfg.out_index,
              "layers": cfg.layers, "d_model": cfg.d_model, "heads": cfg.heads,
              "ffn": cfg.ffn, "vocab": cfg.vocab_size,
              "length_bucket": cfg.default_length_bucket, "weights": "random, seed 0"},
          "build_s": build_s, "crops": len(crops),
          **{k: v for k, v in run.items() if k != "ids"},
          "streams_equal_to_plain_head": not differ, "differ": differ})
    check(not differ, f"formula_published: K2 and its plain version differ: {differ}")
    return run["k2_launches"]


def witness_inputs(page):
    """Model inputs of the bf16 witness, NHWC float32: two 256x512 det
    crops of a fixture page, ImageNet-normalized, and two 48x320 rec
    strips scaled to [-1, 1]."""
    import numpy as np

    det = np.stack([page[96:352, 32:544], page[400:656, 300:812]]).astype(np.float32)
    det = (det / 255.0 - np.float32(DET_MEAN)) / np.float32(DET_STD)
    rec = np.stack([page[100:148, 40:360], page[148:196, 40:360]]).astype(np.float32)
    return det.astype(np.float32), rec / np.float32(127.5) - np.float32(1.0)


def rel_err(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    import numpy as np

    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_gaps(bf16_system, fp32_system, page) -> dict:
    """bf16-vs-fp32 relative error of the det model's prob map and the
    rec model's features on witness_inputs(page), each system's models
    run on its own device in its own dtype."""
    import torch

    det_x, rec_x = witness_inputs(page)
    gaps = {}
    for name, stage, x, kw in (("det", "detector", det_x, {}),
                               ("rec", "recognizer", rec_x, {"features_only": True})):
        ys = []
        for system in (bf16_system, fp32_system):
            sess = getattr(system, stage).session
            with torch.no_grad():
                y = sess.module(torch.from_numpy(x).to(sess.device, sess.compute_dtype), **kw)
            ys.append(y.float().cpu().numpy())
        gaps[name] = rel_err(*ys)
    return gaps


def check_bf16(vs_golden: dict, gaps: dict, jax_gaps: dict) -> None:
    """The bf16 path's limits: text against the bf16 golden, and each
    model's bf16-vs-fp32 error within BF16_GAP_BAND of the JAX package's."""
    missed = vs_golden["lines"] - vs_golden["boxes_iou_ge_0.9"]
    check(missed <= BF16_MAX_UNMATCHED, f"bf16: {missed} golden boxes unmatched > {BF16_MAX_UNMATCHED}")
    check(vs_golden["exact_share"] >= BF16_MIN_EXACT,
          f"bf16: only {vs_golden['exact_share']:.3f} of lines equal < {BF16_MIN_EXACT}")
    check(vs_golden["cer"] <= BF16_MAX_CER, f"bf16: CER {vs_golden['cer']:.4f} > {BF16_MAX_CER}")
    lo, hi = BF16_GAP_BAND
    for name, gap in gaps.items():
        ratio = gap / jax_gaps[name]
        check(lo <= ratio <= hi, f"bf16 {name}: bf16-vs-fp32 error {gap:.3g} is {ratio:.3f} x "
                                 f"the JAX package's, outside [{lo}, {hi}]")


def _clip(poly, a, b):
    """Sutherland-Hodgman: part of convex ``poly`` left of edge a->b."""
    out = []
    for i in range(len(poly)):
        p, q = poly[i], poly[(i + 1) % len(poly)]
        sp = (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0])
        sq = (b[0] - a[0]) * (q[1] - a[1]) - (b[1] - a[1]) * (q[0] - a[0])
        if sp >= 0:
            out.append(p)
        if (sp >= 0) != (sq >= 0):
            t = sp / (sp - sq)
            out.append((p[0] + t * (q[0] - p[0]), p[1] + t * (q[1] - p[1])))
    return out


def _area(poly) -> float:
    return 0.5 * abs(sum(
        poly[i][0] * poly[(i + 1) % len(poly)][1] - poly[(i + 1) % len(poly)][0] * poly[i][1]
        for i in range(len(poly))
    ))


def quad_iou(qa, qb) -> float:
    """IoU of two convex quads (clockwise in image coordinates)."""
    a = [tuple(map(float, p)) for p in qa]
    b = [tuple(map(float, p)) for p in qb]
    inter = a
    for i in range(4):
        if not inter:
            break
        inter = _clip(inter, b[i], b[(i + 1) % 4])
    ia = _area(inter) if len(inter) >= 3 else 0.0
    union = _area(a) + _area(b) - ia
    return ia / union if union > 0 else 0.0


def _edits(s: str, t: str) -> int:
    d = list(range(len(t) + 1))
    for i, cs in enumerate(s, 1):
        prev, d[0] = d[0], i
        for j, ct in enumerate(t, 1):
            prev, d[j] = d[j], min(d[j] + 1, d[j - 1] + 1, prev + (cs != ct))
    return d[-1]


def compare_markdown(got: str, want: str, label: str | None = None) -> dict:
    """The golden Markdown's non-empty lines against the port's: how many
    are equal (each port line matched once), and the character error
    rate, edits over the golden's characters, with the two line lists
    aligned by difflib and each unequal run of lines compared as one
    string. With a label, prints each unequal run to stderr."""
    import difflib
    from collections import Counter

    want_lines = [ln for ln in want.splitlines() if ln.strip()]
    got_lines = [ln for ln in got.splitlines() if ln.strip()]
    pool = Counter(got_lines)
    exact = 0
    for ln in want_lines:
        if pool[ln] > 0:
            pool[ln] -= 1
            exact += 1
    edits = 0
    matcher = difflib.SequenceMatcher(None, want_lines, got_lines, autojunk=False)
    for op, i1, i2, j1, j2 in matcher.get_opcodes():
        if op == "equal":
            continue
        w, g = "\n".join(want_lines[i1:i2]), "\n".join(got_lines[j1:j2])
        edits += _edits(g, w)
        if label:
            print(f"[{label}] golden {w!r} port {g!r}", file=sys.stderr)
    chars = sum(len(ln) for ln in want_lines)
    return {"lines": len(want_lines), "exact_lines": exact,
            "exact_share": exact / max(len(want_lines), 1), "cer": edits / max(chars, 1)}


def compare_to_golden(got: list, want: list, label: str | None) -> dict:
    """Match each golden line to the port's best-IoU box; count boxes
    with IoU >= 0.9, exact texts and the character error rate. With a
    label, prints each line that differs to stderr."""
    lines = matched = exact = edits = chars = 0
    for page, (gp, wp) in enumerate(zip(got, want)):
        for w in wp:
            lines += 1
            chars += len(w["text"])
            best, iou = None, 0.0
            for g in gp:
                v = quad_iou(g["box"], w["box"])
                if v > iou:
                    best, iou = g, v
            matched += iou >= 0.9
            text = best["text"] if best is not None else ""
            exact += text == w["text"]
            edits += _edits(text, w["text"])
            if label and (text != w["text"] or iou < 0.9):
                print(f"[{label}] page {page} iou {iou:.3f}: golden {w['text']!r} port {text!r}",
                      file=sys.stderr)
    return {"lines": lines, "boxes_iou_ge_0.9": matched, "exact_texts": exact,
            "exact_share": exact / max(lines, 1), "cer": edits / max(chars, 1)}


def phase_ocr() -> int:
    """Returns the K1 launches of the main path's timed runs."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.models.ocr.engine import crop_quad
    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax

    assets = ROOT / "rapiddoc_tpu_torch" / "assets"
    with np.load(assets / "ocr_smoke_pages.npz") as z:
        pages = list(z["pages"])
    golden = json.loads((assets / "ocr_smoke_golden.json").read_text())
    # the fp32 check runs full fp32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    system = build_ocr_system()  # the card, bf16: the main path
    out = system(pages)  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    fused_ctc_argmax.launches = 0
    rec_calls = system.recognizer.session.stats.calls
    t0 = time.perf_counter()
    for _ in range(TIMED_RUNS):
        out = system(pages)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_ctc_argmax.launches
    rec_calls = system.recognizer.session.stats.calls - rec_calls
    check(launches > 0, "the OCR main path launched the ctc_head kernel no time")
    for page in out:
        for it in page:
            box = np.asarray(it["box"])
            check(box.shape == (4, 2) and np.isfinite(box).all(), "bad box")
            check(np.isfinite(it["score"]) and 0 <= it["score"] <= 1, "bad score")

    t0 = time.perf_counter()
    dets = system.detector(pages)
    torch.cuda.synchronize()
    det_s = time.perf_counter() - t0
    crops = [crop_quad(p, q) for p, d in zip(pages, dets) for q in d.boxes]
    t0 = time.perf_counter()
    system.recognizer(crops)
    torch.cuda.synchronize()
    rec_s = time.perf_counter() - t0

    bf16 = compare_to_golden(out, golden["bf16"], "bf16")
    fp32_system = build_ocr_system(dtype=torch.float32)
    fp32 = compare_to_golden(fp32_system(pages), golden["fp32"], "fp32")
    gaps = bf16_gaps(system, fp32_system, pages[0])
    emit({
        "phase": "ocr", "pages": len(pages), "timed_runs": TIMED_RUNS,
        "pages_per_s": TIMED_RUNS * len(pages) / wall,
        "det_ms_per_page": det_s * 1e3 / len(pages),
        "rec_ms_per_page": rec_s * 1e3 / len(pages), "rec_crops": len(crops),
        "ctc_head_launches": launches,
        # one launch per rec batch dispatch (one per width bucket and
        # bucket-sized chunk of the call's crops), not per page
        "ctc_head_launches_per_call": launches / TIMED_RUNS,
        "rec_dispatches_per_call": rec_calls / TIMED_RUNS,
        "bf16_vs_golden_bf16": bf16, "fp32_vs_golden_fp32": fp32,
        "bf16_rel_err": gaps, "jax_bf16_rel_err": golden["bf16_rel_err"],
    })
    # fp32 against the JAX package's fp32 output: the correctness gate
    check(fp32["boxes_iou_ge_0.9"] == fp32["lines"], "fp32: a golden box has no match with IoU >= 0.9")
    check(fp32["exact_share"] >= 0.95, f"fp32: only {fp32['exact_share']:.3f} of lines equal")
    check(fp32["cer"] <= 0.01, f"fp32: CER {fp32['cer']:.4f} > 0.01")
    check_bf16(bf16, gaps, golden["bf16_rel_err"])
    return launches


def pipeline_golden() -> dict:
    return json.loads((ROOT / "rapiddoc_tpu_torch" / "assets"
                       / "pipeline_smoke_golden.json").read_text())


def fixture_pdf() -> bytes:
    return (ROOT / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_doc.pdf").read_bytes()


def sha256(arr) -> str:
    import hashlib

    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def host_ms(fn, runs: int) -> float:
    """Mean host milliseconds of ``fn`` over ``runs`` calls."""
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def phase_jpeg(golden: dict) -> None:
    """The JPEG decoder on the fixture PDF's streams, on the host."""
    import numpy as np

    from rapiddoc_tpu_torch.bench import page_images
    from rapiddoc_tpu_torch.pdfio import jpeg, open_pdf, render_page_full

    pdf = fixture_pdf()
    for i, (data, width, height, _) in enumerate(page_images(pdf)):
        stream = jpeg.parse_jpeg(data)
        plain = jpeg.decode_coefficients_plain(stream)
        compiled = jpeg.decode_coefficients_compiled(stream)
        check(np.array_equal(plain, compiled),
              f"jpeg page {i}: the compiled entropy decode differs from the plain one")
        pixels = jpeg.decode_jpeg(data)
        check(pixels.shape == (height, width, 3), f"jpeg page {i}: shape {pixels.shape}")
        check(sha256(pixels) == golden["jpeg_sha256"][i],
              f"jpeg page {i}: decoded pixels differ from PIL's")
        emit({"phase": "jpeg", "page": i, "bytes": len(data), "blocks": int(plain.shape[0]),
              "coefficients_equal": True, "pixels_equal_to_pil": True,
              "entropy_plain_ms": host_ms(lambda: jpeg.decode_coefficients_plain(stream), 1),
              "entropy_compiled_ms": host_ms(lambda: jpeg.decode_coefficients_compiled(stream), 10),
              "reconstruct_ms": host_ms(lambda: jpeg.reconstruct(stream, compiled), 3),
              "decode_ms": host_ms(lambda: jpeg.decode_jpeg(data), 3)})
    doc = open_pdf(pdf)
    for i, want in enumerate(golden["page_sha256"]):
        page = render_page_full(doc.get_page(i), dpi=golden["dpi"], with_text=False)[0]
        check(sha256(page) == want, f"jpeg: rendered page {i} differs from the JAX package's")
    emit({"phase": "jpeg", "rendered_pages_equal_to_jax": len(golden["page_sha256"]),
          "dpi": golden["dpi"]})
    check_jpeg_matrix()


def check_jpeg_matrix() -> None:
    """Both entropy decoders, and decode_jpeg (the compiled one here),
    on every stream of the committed matrix: equal coefficients or the
    same JpegError, and PIL's pixels (their recorded sha256) or the
    recorded error."""
    import numpy as np

    from rapiddoc_tpu_torch.pdfio import jpeg

    def outcome(fn, *args):
        try:
            return fn(*args)
        except jpeg.JpegError as e:
            return f"JpegError: {e}"

    with np.load(ROOT / "rapiddoc_tpu_torch" / "assets" / "jpeg_matrix.npz") as z:
        matrix = [(str(n), z[f"s{i}"].tobytes(), str(w))
                  for i, (n, w) in enumerate(zip(z["names"], z["want"]))]
    faults = 0
    for name, data, want in matrix:
        stream = jpeg.parse_jpeg(data)
        plain = outcome(jpeg.decode_coefficients_plain, stream)
        compiled = outcome(jpeg.decode_coefficients_compiled, stream)
        if isinstance(plain, str):
            check(compiled == plain == want,
                  f"jpeg matrix {name}: plain {plain!r}, compiled {compiled!r}, recorded {want!r}")
            faults += 1
            continue
        check(not isinstance(compiled, str) and np.array_equal(plain, compiled),
              f"jpeg matrix {name}: the compiled entropy decode differs from the plain one "
              f"({compiled if isinstance(compiled, str) else 'other coefficients'})")
        check(sha256(jpeg.decode_jpeg(data)) == want,
              f"jpeg matrix {name}: decoded pixels differ from PIL's")
    emit({"phase": "jpeg", "matrix_streams": len(matrix), "matrix_faults": faults,
          "coefficients_or_errors_equal": True, "pixels_equal_to_pil": len(matrix) - faults})


def host_stages_markdown(out, dims: list, scale: float) -> str:
    """The Markdown the port's host stages build from ``out.model_json``
    alone, on the CPU, one window, no threads."""
    from rapiddoc_tpu_torch.pipeline.middle import result_to_middle_json
    from rapiddoc_tpu_torch.pipeline.mkcontent import union_make
    from rapiddoc_tpu_torch.types import MakeMode

    middle = result_to_middle_json(out.model_json, dims, [scale] * len(dims), parse_mode="ocr")
    return union_make(middle["pdf_info"], MakeMode.MM_MD, "images")


def phase_pipeline(golden: dict, card: str) -> int:
    """The main path through RapidDoc on the card; returns K1's launches
    in the timed bf16 run. ``card``: the nvidia-smi line, printed beside
    the times."""
    import os

    import torch

    for k in ("LAYOUT", "FORMULA", "TABLE"):
        os.environ[f"RAPIDDOC_DISABLE_{k}"] = "1"
    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.bench import STAGES, device_busy_share
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.utils.trace import GLOBAL_TRACER

    pdf = fixture_pdf()
    doc = open_pdf(pdf)
    dims = [doc.get_page(i).size for i in range(len(doc))]
    scale = golden["dpi"] / 72.0
    # fp32 against the JAX package's fp32 golden: the correctness gate
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = RapidDoc(device="cuda", dtype=torch.float32)(pdf, parse_method="ocr")
    fp32_vs = compare_markdown(fp32.markdown, golden["fp32"]["markdown"], "pipeline fp32")
    emit({"phase": "pipeline", "dtype": "fp32", "vs_golden_fp32": fp32_vs,
          "markdown_equal": fp32.markdown == golden["fp32"]["markdown"],
          "content_list_equal": fp32.content_list_json == golden["fp32"]["content_list"]})
    check(fp32.markdown == golden["fp32"]["markdown"],
          "pipeline fp32: the Markdown differs from the JAX package's fp32 golden")

    rapid = RapidDoc(device="cuda")  # bf16: the main path
    rapid(pdf, parse_method="ocr")  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    rec = rapid._stack().analyzer.ocr.recognizer.session.stats
    GLOBAL_TRACER.reset()
    calls = rec.calls
    fused_ctc_argmax.launches = 0
    t0 = time.perf_counter()
    out = rapid(pdf, parse_method="ocr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused_ctc_argmax.launches
    dispatches = rec.calls - calls
    report = GLOBAL_TRACER.report()
    check(launches > 0, "the pipeline launched the ctc_head kernel no time")
    check(launches == dispatches,
          f"pipeline: {launches} K1 launches for {dispatches} rec dispatches")
    pages = len(dims)
    kernel_ms, traced_ms = device_busy_share(lambda: rapid(pdf, parse_method="ocr"))
    bf16_vs = compare_markdown(out.markdown, golden["bf16"]["markdown"], "pipeline bf16")
    rebuilt = host_stages_markdown(out, dims, scale)
    emit({"phase": "pipeline", "dtype": "bf16", "card": card, "pages": pages,
          "pages_per_s": pages / wall,
          "stage_ms_per_page": {k: report[k]["total_s"] * 1e3 / pages
                                for k in STAGES if k in report},
          "device_busy_share": kernel_ms / traced_ms,
          "device_kernel_ms_per_page": kernel_ms / pages,
          "ctc_head_launches": launches, "rec_dispatches": dispatches,
          "vs_golden_bf16": bf16_vs, "host_stages_exact": rebuilt == out.markdown})
    check(rebuilt == out.markdown,
          "pipeline bf16: the host stages build other Markdown from the same model output")
    check(bf16_vs["exact_share"] >= PIPELINE_BF16_MIN_EXACT,
          f"pipeline bf16: only {bf16_vs['exact_share']:.3f} of lines equal "
          f"< {PIPELINE_BF16_MIN_EXACT}")
    check(bf16_vs["cer"] <= PIPELINE_BF16_MAX_CER,
          f"pipeline bf16: CER {bf16_vs['cer']:.4f} > {PIPELINE_BF16_MAX_CER}")
    return launches


def layout_rows(dets: list[dict]) -> list[dict]:
    """(label, score, box) of a layout detector's dets."""
    return [{"label": d["original_label"], "score": float(d["score"]),
             "box": [float(d["poly"][i]) for i in (0, 1, 4, 5)]} for d in dets]


def box_iou(a, b) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    union = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / union if union > 0 else 0.0


def compare_layout_dets(got: list, want: list) -> dict:
    """Each golden det matched to the port's best-IoU det of the same
    label on its page; how many reach IoU >= 0.9, and on how many pages
    the label sequence is the golden's."""
    dets = matched = same_order = 0
    for gp, wp in zip(got, want):
        same_order += [g["label"] for g in gp] == [w["label"] for w in wp]
        for w in wp:
            dets += 1
            best = max((box_iou(g["box"], w["box"]) for g in gp if g["label"] == w["label"]),
                       default=0.0)
            matched += best >= 0.9
    return {"dets": dets, "got_dets": sum(len(p) for p in got), "matched_iou_0.9": matched,
            "matched_share": matched / max(dets, 1), "pages_same_labels": same_order}


def check_layout_fp32(got: list, want: list) -> float:
    """fp32 dets equal to the golden's: labels and order, boxes within
    LAYOUT_BOX_TOL. Returns the largest box difference."""
    worst = 0.0
    for i, (gp, wp) in enumerate(zip(got, want, strict=True)):
        check([g["label"] for g in gp] == [w["label"] for w in wp],
              f"layout fp32 page {i}: labels {[g['label'] for g in gp]} != golden's")
        for g, w in zip(gp, wp):
            worst = max(worst, max(abs(a - b) for a, b in zip(g["box"], w["box"])))
    check(worst <= LAYOUT_BOX_TOL, f"layout fp32: a box is {worst:.4f} px off the golden's")
    return worst


def parse_summary(out) -> dict:
    """The golden's reading of a parse: Markdown, content list, each
    page's LaTeX, and every payload's sha256 by name."""
    import hashlib

    return {
        "markdown": out.markdown, "content_list": out.content_list_json,
        "latex": [[d["latex"] for d in page["layout_dets"] if "latex" in d]
                  for page in out.model_json],
        "images": {k: hashlib.sha256(v).hexdigest() for k, v in sorted(out.images.items())},
    }


def compare_layout_parse(got: dict, want: dict) -> dict:
    """A parse summary against the golden's: Markdown lines and CER,
    LaTeX equal and its CER over the formulas in order, and the counts of
    formulas and images."""
    gl = [x for page in got["latex"] for x in page]
    wl = [x for page in want["latex"] for x in page]
    edits = sum(_edits(a, b) for a, b in zip(gl, wl)) + sum(len(x) for x in wl[len(gl):])
    return {"markdown": compare_markdown(got["markdown"], want["markdown"]),
            "formulas": len(gl), "golden_formulas": len(wl),
            "latex_equal": sum(a == b for a, b in zip(gl, wl)),
            "latex_cer": edits / max(sum(len(x) for x in wl), 1),
            "images": len(got["images"]), "golden_images": len(want["images"]),
            "image_names_equal": len(set(got["images"]) & set(want["images"]))}


def check_layout_parse_bf16(vs: dict) -> None:
    lim = LAYOUT_PARSE_BF16
    md = vs["markdown"]
    check(md["exact_share"] >= lim["min_exact_share"],
          f"pipeline_layout bf16: only {md['exact_share']:.3f} of lines equal")
    check(md["cer"] <= lim["max_cer"], f"pipeline_layout bf16: CER {md['cer']:.4f}")
    check(vs["latex_cer"] <= lim["max_latex_cer"],
          f"pipeline_layout bf16: LaTeX CER {vs['latex_cer']:.4f}")
    check(abs(vs["formulas"] - vs["golden_formulas"]) <= lim["max_count_gap"],
          f"pipeline_layout bf16: {vs['formulas']} formulas, golden {vs['golden_formulas']}")
    check(abs(vs["images"] - vs["golden_images"]) <= lim["max_count_gap"],
          f"pipeline_layout bf16: {vs['images']} images, golden {vs['golden_images']}")


def layout_golden() -> dict:
    return json.loads((ROOT / "rapiddoc_tpu_torch" / "assets"
                       / "layout_smoke_golden.json").read_text())


def layout_pdf() -> bytes:
    return (ROOT / "rapiddoc_tpu_torch" / "assets" / "layout_smoke_doc.pdf").read_bytes()


def phase_layout(golden: dict, card: str) -> None:
    """The demo layout detector on the card, and the published shape."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.bench import device_busy_share
    from rapiddoc_tpu_torch.models.layout.engine import LayoutConfig, LayoutDetector
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    doc = open_pdf(layout_pdf())
    pages = [render_page_full(doc.get_page(i), dpi=golden["dpi"], with_text=False)[0]
             for i in range(len(doc))]
    check([sha256(p) for p in pages] == golden["page_sha256"],
          "layout: the rendered fixture pages differ from the JAX package's")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = LayoutDetector.build({"demo_layout": True}, dtype=torch.float32)
    worst = check_layout_fp32([layout_rows(d) for d in fp32.batch_predict(pages)],
                              golden["fp32"]["layout"])
    det = LayoutDetector.build({"demo_layout": True})  # the card, bf16
    bf16 = compare_layout_dets([layout_rows(d) for d in det.batch_predict(pages)],
                               golden["bf16"]["layout"])
    check(bf16["matched_share"] >= LAYOUT_BF16_MIN_MATCHED,
          f"layout bf16: only {bf16['matched_iou_0.9']}/{bf16['dets']} golden dets matched")
    batches = {}
    for b in LAYOUT_BATCHES:
        imgs = (pages * 2)[:b]
        x = det.preprocess(imgs)
        det.batch_predict(imgs)  # warm-up: cuDNN picks its algorithms
        torch.cuda.synchronize()
        batches[b] = {
            "ms_per_page": host_ms(lambda: (det.batch_predict(imgs), torch.cuda.synchronize()),
                                   LAYOUT_TIMED_RUNS) / b,
            "forward_ms_per_page": cuda_ms(lambda: det.session.dispatch(x), iters=5,
                                           warmup=1) / b,
            "preprocess_ms_per_page": host_ms(lambda: det.preprocess(imgs), 2) / b,
        }
    # the published PP-DocLayoutV3 shape, random weights from seed 0
    pub = LayoutDetector(None, LayoutConfig(), seed=0)
    imgs = (pages * 2)[:8]
    pub.batch_predict(imgs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pub_out = pub.batch_predict(imgs)
    torch.cuda.synchronize()
    pub_s = time.perf_counter() - t0
    kernel_ms, traced_ms = device_busy_share(lambda: pub.batch_predict(imgs))
    x = pub.preprocess(imgs)
    outs = pub.session(x)
    check(outs["masks_bits"].shape == (8, 300, 100, 13), f"published masks {outs['masks_bits'].shape}")
    check(all(np.isfinite(outs[k]).all() for k in ("scores", "boxes")), "published: non-finite output")
    # the span payloads of the fp32 golden's image, table and formula
    # regions, JPEG-encoded on the host
    from rapiddoc_tpu_torch.types import CategoryId
    from rapiddoc_tpu_torch.utils.images import crop_bbox, encode_image

    spans = [crop_bbox(pages[i], [d["poly"][0], d["poly"][1], d["poly"][4], d["poly"][5]], 1.0)
             for i, info in enumerate(golden["fp32"]["model_info"]) for d in info["layout_dets"]
             if d["category_id"] in (CategoryId.ImageBody, CategoryId.TableBody,
                                     CategoryId.InterlineEquation_YOLO)]
    encode_ms = [host_ms(lambda c=c: encode_image(c), 2) for c in spans]
    emit({"phase": "layout", "card": card, "pages": len(pages),
          "jpeg_encode": {"spans": len(spans), "mean_ms": sum(encode_ms) / len(spans),
                          "max_ms": max(encode_ms),
                          "mean_pixels": sum(c.shape[0] * c.shape[1] for c in spans) / len(spans)},
          "fp32_dets_equal": True, "fp32_max_box_diff_px": worst,
          "bf16_vs_golden_bf16": bf16, "demo_batches": batches,
          "published": {"shape": "B4 800x800 300q 6 layers masks", "batch": 8,
                        "pages_per_s": 8 / pub_s, "ms_per_page": pub_s * 1e3 / 8,
                        "forward_ms_per_page": cuda_ms(lambda: pub.session.dispatch(x), iters=3,
                                                       warmup=1) / 8,
                        "device_busy_share": kernel_ms / traced_ms,
                        "dets_per_page": [len(d) for d in pub_out]}})


def table_assets() -> tuple[dict, dict]:
    """(golden, stored arrays) of the table path."""
    import numpy as np

    assets = ROOT / "rapiddoc_tpu_torch" / "assets"
    golden = json.loads((assets / "table_smoke_golden.json").read_text())
    with np.load(assets / "table_smoke_crops.npz") as z:
        return golden, dict(z)


def table_stage_outputs(rec, uni, crops: list) -> dict:
    """The table models on ``crops``: kinds, the UNet's line bits, cells
    and grid, SLANet's structure and boxes, UniTable's structure."""
    import numpy as np

    wired = rec.wired
    handles = wired.dispatch([wired.preprocess(c) for c in crops])
    bits = np.concatenate([h[:n].cpu().numpy() for h, n in handles])
    structs = wired.finish(crops, handles)
    return {"kinds": rec.classifier(crops), "bits": bits,
            "cells": [c for c, _ in structs], "grid": [[list(g) for g in gr] for _, gr in structs],
            "slanet": rec.wireless(crops),
            "unitable": uni(crops, max_len=UNITABLE_MAX_LEN)}


def compare_table_stages(got: dict, want: dict, want_bits) -> dict:
    """The table models' outputs against the JAX package's."""
    import numpy as np

    diff = np.unpackbits(got["bits"] ^ want_bits, axis=-1)
    cells_diff = [float(np.abs(np.asarray(g, float) - np.asarray(w, float)).max(initial=0.0))
                  for g, w in zip(got["cells"], want["cells"]) if len(g) == len(w)]
    out = {"crops": len(got["kinds"]),
           "kinds_equal": sum(g == w for g, w in zip(got["kinds"], want["kinds"])),
           "unet_bits_differing": int(diff.sum()),
           "unet_bit_diff_share": float(diff.sum()) / diff.size,
           "grids_equal": sum(g == w for g, w in zip(got["grid"], want["grid"])),
           "cells_max_diff_px": max(cells_diff, default=0.0)}
    for name in ("slanet", "unitable"):
        pairs = list(zip(got[name], want[name]))
        edits = sum(_edits(list(g[0]), list(w[0])) for g, w in pairs)
        out[f"{name}_equal"] = sum(list(g[0]) == list(w[0]) for g, w in pairs)
        out[f"{name}_token_cer"] = edits / max(sum(len(w[0]) for _, w in pairs), 1)
    out["slanet_box_max_diff_px"] = max(
        (float(np.abs(np.asarray(g[1]) - np.asarray(w[1])).max(initial=0.0))
         for g, w in zip(got["slanet"], want["slanet"]) if list(g[0]) == list(w[0])),
        default=0.0)
    return out


def check_table_stages_fp32(vs: dict, gaps: list) -> None:
    """fp32: everything equal, boxes within tolerance, every differing
    UNet bit a near-tie (``gaps``: |l1 - l0| at the differing bits)."""
    n = vs["crops"]
    for key in ("kinds_equal", "grids_equal", "slanet_equal", "unitable_equal"):
        check(vs[key] == n, f"table fp32: {key} {vs[key]}/{n}")
    check(vs["cells_max_diff_px"] == 0.0, f"table fp32: cells {vs['cells_max_diff_px']} px off")
    check(vs["slanet_box_max_diff_px"] <= TABLE_SLANET_BOX_TOL,
          f"table fp32: a SLANet box is {vs['slanet_box_max_diff_px']:.4f} px off")
    check(max(gaps, default=0.0) < TABLE_UNET_TIE,
          f"table fp32: a UNet bit differs at |l1 - l0| = {max(gaps, default=0.0):.2e}")


def check_table_stages_bf16(vs: dict) -> None:
    lim = TABLE_BF16
    check(vs["kinds_equal"] >= lim["min_kinds_equal"], f"table bf16: kinds {vs['kinds_equal']}")
    check(vs["unet_bit_diff_share"] <= lim["max_unet_bit_diff_share"],
          f"table bf16: {vs['unet_bit_diff_share']:.2e} of the UNet's bits differ")
    check(vs["grids_equal"] >= lim["min_grids_equal"], f"table bf16: grids {vs['grids_equal']}")
    for name in ("slanet", "unitable"):
        check(vs[f"{name}_token_cer"] <= lim[f"max_{name}_token_cer"],
              f"table bf16: {name} token CER {vs[f'{name}_token_cer']:.4f}")


def compare_table_parse(got: dict, want: dict) -> dict:
    """compare_layout_parse, and how many tables' HTML are equal."""
    vs = compare_layout_parse(got, want)
    vs.update(tables=len(got["tables"]), golden_tables=len(want["tables"]),
              tables_equal=sum(g == w for g, w in zip(got["tables"], want["tables"])),
              tables_with_html=sum(1 for t in got["tables"] if t))
    return vs


def check_table_parse_bf16(vs: dict) -> None:
    lim = TABLE_PARSE_BF16
    md = vs["markdown"]
    check(md["exact_share"] >= lim["min_exact_share"],
          f"main_path bf16: only {md['exact_share']:.3f} of lines equal")
    check(md["cer"] <= lim["max_cer"], f"main_path bf16: CER {md['cer']:.4f}")
    check(vs["latex_cer"] <= lim["max_latex_cer"],
          f"main_path bf16: LaTeX CER {vs['latex_cer']:.4f}")
    for key in ("formulas", "images", "tables"):
        check(abs(vs[key] - vs[f"golden_{key}"]) <= lim["max_count_gap"],
              f"main_path bf16: {vs[key]} {key}, golden {vs[f'golden_{key}']}")
    check(vs["tables_equal"] >= lim["min_tables_equal"],
          f"main_path bf16: {vs['tables_equal']} tables' HTML equal")


def _layout_env(int8: bool, window: int | None = None) -> None:
    import os

    for k in ("LAYOUT", "FORMULA"):
        os.environ.pop(f"RAPIDDOC_DISABLE_{k}", None)
    os.environ["RAPIDDOC_DISABLE_TABLE"] = "1"
    os.environ["RAPIDDOC_DEMO_LAYOUT"] = "1"
    os.environ.pop("RAPIDDOC_INT8_HEAD", None)
    if int8:
        os.environ["RAPIDDOC_INT8_HEAD"] = "1"
    os.environ.pop("RAPIDDOC_PROCESSING_WINDOW_SIZE", None)
    if window is not None:
        os.environ["RAPIDDOC_PROCESSING_WINDOW_SIZE"] = str(window)


def phase_pipeline_layout(golden: dict, card: str) -> dict:
    """The layout path through RapidDoc on the card; returns the main
    path's counts (K1, K2 launches; rec dispatches; decode steps)."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.bench import STAGES, device_busy_share
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8
    from rapiddoc_tpu_torch.utils.trace import GLOBAL_TRACER

    pdf = layout_pdf()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode, int8, window in (("fp32", False, None), ("fp32_int8", True, None),
                               ("fp32_int8", True, 1)):
        _layout_env(int8, window)
        got = parse_summary(RapidDoc(device="cuda", dtype=torch.float32)(pdf, parse_method="ocr"))
        want = golden[mode]
        equal = {k: got[k] == want[k] for k in ("markdown", "content_list", "latex", "images")}
        emit({"phase": "pipeline_layout", "dtype": "fp32", "int8_head": int8,
              "window": window, "equal_to_golden": equal,
              "vs_golden": compare_layout_parse(got, want)})
        for key, ok in equal.items():
            check(ok, f"pipeline_layout {mode} window {window}: the {key} differs from the golden's")

    _layout_env(True)  # the main path: bf16, int8 head on
    rapid = RapidDoc(device="cuda")
    rapid(pdf, parse_method="ocr")  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    analyzer = rapid._stack().analyzer
    rec, formula = analyzer.ocr.recognizer.session.stats, analyzer.formula_model.stats
    GLOBAL_TRACER.reset()
    calls, steps = rec.calls, formula.decode_steps
    fused_ctc_argmax.launches = 0
    fused_argmax_int8.launches = 0
    t0 = time.perf_counter()
    out = rapid(pdf, parse_method="ocr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"ctc_head": fused_ctc_argmax.launches, "quant_head": fused_argmax_int8.launches,
              "rec_dispatches": rec.calls - calls, "decode_steps": formula.decode_steps - steps}
    report = GLOBAL_TRACER.report()
    pages = len(out.model_json)
    kernel_ms, traced_ms = device_busy_share(lambda: rapid(pdf, parse_method="ocr"))
    vs = compare_layout_parse(parse_summary(out), golden["bf16_int8"])
    emit({"phase": "pipeline_layout", "dtype": "bf16", "int8_head": True, "card": card,
          "pages": pages, "pages_per_s": pages / wall,
          "stage_ms_per_page": {k: report[k]["total_s"] * 1e3 / pages
                                for k in STAGES if k in report},
          "formula_regions": report.get("formula", {}).get("items", 0),
          "device_busy_share": kernel_ms / traced_ms,
          "device_kernel_ms_per_page": kernel_ms / pages,
          "launches": counts, "vs_golden_bf16_int8": vs})
    check(counts["ctc_head"] > 0, "pipeline_layout launched the ctc_head kernel no time")
    check(counts["ctc_head"] == counts["rec_dispatches"],
          f"pipeline_layout: {counts['ctc_head']} K1 launches for {counts['rec_dispatches']} "
          f"rec dispatches")
    check(counts["quant_head"] > 0, "pipeline_layout launched the quant_head kernel no time")
    check(counts["quant_head"] == counts["decode_steps"],
          f"pipeline_layout: {counts['quant_head']} K2 launches for {counts['decode_steps']} "
          f"decode steps")
    check_layout_parse_bf16(vs)
    return counts


def table_parse_summary(out) -> dict:
    """parse_summary with every table det's HTML, the uuids of in-table
    image placeholders (uuid4) masked."""
    summary = parse_summary(out)
    summary["tables"] = [d.get("html", "") for page in out.model_json
                         for d in page["layout_dets"] if d["category_id"] == 5]
    text = json.dumps(summary)
    for page in out.model_json:
        for det in page["layout_dets"]:
            for fill in det.get("fill_images", []):
                text = text.replace(fill["uuid"], "<uuid>")
    return json.loads(text)


def _table_env(int8: bool, window: int | None = None) -> None:
    import os

    _layout_env(int8, window)
    os.environ.pop("RAPIDDOC_DISABLE_TABLE", None)


def phase_table(card: str) -> None:
    """The table models (demo checkpoints) on the layout fixture's 15
    table crops, and the published UniTable shape."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.bench import device_busy_share
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer
    from rapiddoc_tpu_torch.models.table.unitable import (
        UniTableDims, UniTableModel, UniTableStructure)
    from rapiddoc_tpu_torch.models.weights import random_init

    golden, stored = table_assets()
    crops = [stored[f"crop_{i}"] for i in range(len(golden["crops"]["sha256"]))]
    check([sha256(c) for c in crops] == golden["crops"]["sha256"],
          "table: the crops differ from the golden's")
    _table_env(False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fp32 = TableRecognizer.build({}, dtype=torch.float32)
    got = table_stage_outputs(
        fp32, TableRecognizer.build({"strategy": "unet_unitable"}, dtype=torch.float32).wireless,
        crops)
    fp32_vs = compare_table_stages(got, golden["stages"]["fp32"], stored["fp32/unet_bits"])
    diff = np.unpackbits(got["bits"] ^ stored["fp32/unet_bits"], axis=-1)
    rows = [i for i in range(len(crops)) if diff[i].any()]
    gaps = []
    if rows:
        x = torch.from_numpy(np.stack([fp32.wired.preprocess(crops[i]) for i in rows])).cuda()
        gap = fp32.wired.logit_gap(x).cpu().numpy()
        gaps = [float(np.abs(gap[j][diff[i] > 0]).max()) for j, i in enumerate(rows)]
    emit({"phase": "table", "dtype": "fp32", "vs_golden_fp32": fp32_vs,
          "unet_bit_max_abs_gap": max(gaps, default=0.0)})
    check_table_stages_fp32(fp32_vs, gaps)

    rec = TableRecognizer.build({})  # the card, bf16
    uni = TableRecognizer.build({"strategy": "unet_unitable"}).wireless
    bf16_vs = compare_table_stages(table_stage_outputs(rec, uni, crops),
                                   golden["stages"]["bf16"], stored["bf16/unet_bits"])
    check_table_stages_bf16(bf16_vs)
    wired, sla = rec.wired, rec.wireless
    batches = {}
    for b in TABLE_BATCHES:
        imgs = crops[:b]
        prepped = [wired.preprocess(c) for c in imgs]
        x = torch.from_numpy(np.stack(prepped)).cuda()
        rec.classifier(imgs)
        wired.batch(imgs)  # warm-up: cuDNN picks its algorithms
        handles = wired.dispatch(prepped)
        torch.cuda.synchronize()
        batches[b] = {
            "cls_ms_per_table": host_ms(lambda: rec.classifier(imgs), TABLE_TIMED_RUNS) / b,
            "unet_ms_per_table": host_ms(lambda: wired.batch(imgs), TABLE_TIMED_RUNS) / b,
            "unet_host_pre_ms_per_table": host_ms(
                lambda: [wired.preprocess(c) for c in imgs], TABLE_TIMED_RUNS) / b,
            "unet_device_ms_per_table": cuda_ms(lambda: wired.forward_bits(x), iters=3,
                                                warmup=1) / b,
            "unet_host_cells_ms_per_table": host_ms(lambda: wired.finish(imgs, handles),
                                                    TABLE_TIMED_RUNS) / b,
        }
    slanet = {}
    for bucket in TABLE_SLANET_BUCKETS:
        x = torch.from_numpy(np.stack([sla.preprocess(c) for c in (crops * 2)[:bucket]])).cuda()
        sla.run(x)
        torch.cuda.synchronize()
        steps = sla.decode_steps
        t0 = time.perf_counter()
        sla.run(x)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        slanet[bucket] = {"steps": sla.decode_steps - steps,
                          "ms_per_step": wall * 1e3 / (sla.decode_steps - steps)}
    # the published UniTable shape (12x768 encoder, 4x768 decoder), bf16,
    # random weights from seed 0
    model = UniTableModel(UniTableDims())
    random_init(model, np.random.default_rng(0))
    pub = UniTableStructure(model)
    imgs = crops[:UNITABLE_PUBLISHED_BATCH]
    pub(imgs, max_len=UNITABLE_MAX_LEN)
    torch.cuda.synchronize()
    steps = pub.decode_steps
    t0 = time.perf_counter()
    pub_out = pub(imgs, max_len=UNITABLE_MAX_LEN)
    torch.cuda.synchronize()
    pub_s = time.perf_counter() - t0
    pub_steps = pub.decode_steps - steps
    kernel_ms, traced_ms = device_busy_share(lambda: pub(imgs, max_len=UNITABLE_MAX_LEN))
    check(len(pub_out) == len(imgs), "table: the published UniTable returned no structure")
    emit({"phase": "table", "dtype": "bf16", "card": card, "crops": len(crops),
          "vs_golden_bf16": bf16_vs, "batches": batches, "slanet_buckets": slanet,
          "unitable_published": {
              "shape": "12x768 encoder, 4x768 decoder, random weights",
              "batch": len(imgs), "max_len": UNITABLE_MAX_LEN, "steps": pub_steps,
              "steps_per_s": pub_steps / pub_s, "ms_per_step": pub_s * 1e3 / pub_steps,
              "device_busy_share": kernel_ms / traced_ms}})


def phase_pipeline_table() -> None:
    """The fp32 table-on path through RapidDoc on the card, equal to the
    golden in one window and with one page per window."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    golden, _ = table_assets()
    pdf = layout_pdf()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for window in (None, 1):
        _table_env(False, window)
        got = table_parse_summary(
            RapidDoc(device="cuda", dtype=torch.float32)(pdf, parse_method="ocr"))
        want = golden["fp32"]
        keys = ("markdown", "content_list", "tables", "latex", "images")
        equal = {k: got[k] == want[k] for k in keys}
        emit({"phase": "pipeline_table", "dtype": "fp32", "window": window,
              "equal_to_golden": equal, "vs_golden": compare_table_parse(got, want)})
        for key, ok in equal.items():
            check(ok, f"pipeline_table fp32 window {window}: the {key} differs from the golden's")


def main_path(card: str) -> dict:
    """The slice's main path, RapidDoc(device="cuda") with the table stage
    on, bf16 with the int8 head: timed, its kernel launches counted from
    0 and held to the rec dispatches and decode steps, its output held to
    the bf16 int8 golden's bands. Returns the launch counts."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.bench import STAGES, device_busy_share, table_counts
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8
    from rapiddoc_tpu_torch.utils.trace import GLOBAL_TRACER

    golden, _ = table_assets()
    pdf = layout_pdf()
    _table_env(True)
    rapid = RapidDoc(device="cuda")
    rapid(pdf, parse_method="ocr")  # warm-up: cuDNN picks its algorithms
    torch.cuda.synchronize()
    analyzer = rapid._stack().analyzer
    rec, formula = analyzer.ocr.recognizer.session.stats, analyzer.formula_model.stats
    table0 = table_counts(analyzer.table_model)
    GLOBAL_TRACER.reset()
    calls, steps = rec.calls, formula.decode_steps
    fused_ctc_argmax.launches = 0
    fused_argmax_int8.launches = 0
    t0 = time.perf_counter()
    out = rapid(pdf, parse_method="ocr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"ctc_head": fused_ctc_argmax.launches, "quant_head": fused_argmax_int8.launches,
              "rec_dispatches": rec.calls - calls, "decode_steps": formula.decode_steps - steps}
    tables = {k: v - table0[k] for k, v in table_counts(analyzer.table_model).items()}
    report = GLOBAL_TRACER.report()
    pages = len(out.model_json)
    kernel_ms, traced_ms = device_busy_share(lambda: rapid(pdf, parse_method="ocr"))
    vs = compare_table_parse(table_parse_summary(out), golden["bf16_int8"])
    emit({"phase": "main_path", "dtype": "bf16", "int8_head": True, "card": card,
          "pages": pages, "pages_per_s": pages / wall,
          "stage_ms_per_page": {k: report[k]["total_s"] * 1e3 / pages
                                for k in STAGES if k in report},
          "tables": report.get("table", {}).get("items", 0),
          "table_counts": tables,
          "device_busy_share": kernel_ms / traced_ms,
          "device_kernel_ms_per_page": kernel_ms / pages,
          "launches": counts, "vs_golden_bf16_int8": vs})
    for name, per in (("ctc_head", "rec_dispatches"), ("quant_head", "decode_steps")):
        check(counts[name] > 0, f"main_path launched the {name} kernel no time")
        check(counts[name] == counts[per],
              f"main_path: {counts[name]} {name} launches for {counts[per]} {per}")
    check_table_parse_bf16(vs)
    return counts


# ------------------------------------------------ the seventh slice's paths

# The table stage with an OCR system inside it (tests/test_torch_table_ocr.py
# holds the crops' and the golden's generator): configurations by name.
TABLE_OCR_CONFIGS = {
    "default": {},
    "blank": {"enable_blank_cell_rec": True},
    "compare": {"use_compare_table": True},
    "wired_only": {"strategy": "unet"},
}
OCR_KNOBS = {
    "rgb_transfer": ({"RAPIDDOC_RGB_TRANSFER": "1"}, {}),
    "det_wire_8": ({"RAPIDDOC_DET_WIRE_BITS": "8"}, {}),
    "det_prob_8": ({"RAPIDDOC_DET_PROB_BITS": "8"}, {}),
    "rec_wire_8": ({"RAPIDDOC_REC_WIRE_BITS": "8"}, {}),
    "stretch_0": ({"RAPIDDOC_CONTRAST_STRETCH": "0"}, {}),
    "stretch_1": ({"RAPIDDOC_CONTRAST_STRETCH": "1"}, {}),
    "limit_640": ({}, {"Det.limit_side_len": 640}),
    "limit_1280": ({}, {"Det.limit_side_len": 1280}),
}
WORD_PAGES = (0, 2)
# fp32 OCR against the JAX package's fp32 golden: texts equal, box corners
# within OCR_BOX_TOL px, word polygons within WORD_POLY_TOL px
OCR_BOX_TOL = 1.0
WORD_POLY_TOL = 1e-3
ORIENTATION_BOX_TOL = 0.05  # px, the layout detector's fp32 boxes


def clean_env(**extra: str) -> None:
    """Every RAPIDDOC_*/MINERU_* setting and USE_DOC_ORIENTATION_CLASSIFY
    off, then ``extra``."""
    import os

    for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))
              or k == "USE_DOC_ORIENTATION_CLASSIFY"]:
        del os.environ[k]
    os.environ.update(extra)


def asset(name: str) -> Path:
    return ROOT / "rapiddoc_tpu_torch" / "assets" / name


def ocr_rows(out: list) -> list:
    """OCR output with numpy values as floats (boxes, scores, words)."""
    import numpy as np

    return [[{**it, "box": np.asarray(it["box"], np.float64).tolist()} for it in page]
            for page in out]


def check_ocr_equal(got: list, want: list, label: str, poly_tol: float | None = None) -> None:
    """fp32 OCR against the golden: the same lines in the same order, texts
    equal, box corners within OCR_BOX_TOL, word polygons within poly_tol."""
    import numpy as np

    check(len(got) == len(want), f"{label}: {len(got)} pages, golden {len(want)}")
    for page, (gp, wp) in enumerate(zip(got, want)):
        gt, wt = [it["text"] for it in gp], [it["text"] for it in wp]
        check(gt == wt, f"{label} page {page}: texts differ from the golden's "
                        f"({sum(a == b for a, b in zip(gt, wt))}/{len(wt)} equal)")
        for g, w in zip(gp, wp):
            err = float(np.abs(np.asarray(g["box"]) - np.asarray(w["box"])).max())
            check(err <= OCR_BOX_TOL, f"{label} page {page}: a box is {err:.3g} px off")
            if poly_tol is None:
                continue
            check([x["word"] for x in g.get("words", [])] == [x["word"] for x in w["words"]],
                  f"{label} page {page}: words differ from the golden's")
            for a, b in zip(g["words"], w["words"]):
                err = float(np.abs(np.asarray(a["poly"], np.float64)
                                   - np.asarray(b["poly"])).max())
                check(err <= poly_tol, f"{label} page {page}: a word polygon is {err:.3g} px off")


class LaunchCount:
    """K1's launches and the rec dispatches of ``recognizers`` over a run."""

    def __init__(self, *recognizers):
        from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax

        self.k1, self.recs = fused_ctc_argmax, recognizers

    def __enter__(self):
        self.k1.launches = 0
        self.calls0 = [r.session.stats.calls for r in self.recs]
        return self

    def __exit__(self, *exc):
        self.launches = self.k1.launches
        self.dispatches = sum(r.session.stats.calls - c for r, c in zip(self.recs, self.calls0))

    def check(self, label: str) -> dict:
        check(self.launches > 0, f"{label}: the ctc_head kernel launched no time")
        check(self.launches == self.dispatches,
              f"{label}: {self.launches} ctc_head launches for {self.dispatches} rec dispatches")
        return {"ctc_head": self.launches, "rec_dispatches": self.dispatches}


def phase_ocr_family(card: str) -> dict:
    """RapidDoc(lang="ru") on the Cyrillic fixture; the OCR knobs, word
    boxes and the published-format parse on the OCR fixture. fp32 equal
    to the JAX package's golden, bf16 within bands; K1's launches held to
    the rec dispatches on every path. Returns the launch counts."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.models.ocr.engine import crop_quad
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    golden = json.loads(asset("ocr_family_golden.json").read_text())
    with np.load(asset("ocr_smoke_pages.npz")) as z:
        pages = list(z["pages"])
    off = {f"RAPIDDOC_DISABLE_{k}": "1" for k in ("LAYOUT", "FORMULA", "TABLE")}
    counts = {}

    # RapidDoc(lang="ru"): the Cyrillic demo rec, K1 at V = 91
    pdf = asset("ocr_ru_doc.pdf").read_bytes()
    clean_env(**off)
    for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
        rapid = RapidDoc(lang="ru", device="cuda", dtype=dtype)
        rec = rapid._stack().analyzer.ocr.recognizer
        check(rec.session.module.head.kernel.shape[1] == 91, "ru: the head is not 91 wide")
        rapid(pdf, parse_method="ocr")  # warm-up
        torch.cuda.synchronize()
        with LaunchCount(rec) as lc:
            t0 = time.perf_counter()
            out = rapid(pdf, parse_method="ocr")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        lines = [d.get("text", "") for p in out.model_json for d in p["layout_dets"]]
        want = golden["ru"][mode]
        vs = compare_markdown(out.markdown, want["markdown"], f"ru {mode}")
        emit({"phase": "ocr_family", "path": "ru", "dtype": mode, "card": card, "v": 91,
              "pages": len(out.model_json), "pages_per_s": len(out.model_json) / wall,
              "launches": lc.check(f"ru {mode}"), "vs_golden": vs})
        counts["ru"] = lc.launches
        if mode == "fp32":
            check(out.markdown == want["markdown"], "ru fp32: the Markdown differs from the golden's")
            check(lines == want["lines"], "ru fp32: the lines differ from the golden's")
        else:
            check(vs["exact_share"] >= RU_BF16["min_exact_share"],
                  f"ru bf16: only {vs['exact_share']:.3f} of lines equal")
            check(vs["cer"] <= RU_BF16["max_cer"], f"ru bf16: CER {vs['cer']:.4f}")

    # the OCR knobs on the three fixture pages
    knob_launches = 0
    for name, (env, cfg) in OCR_KNOBS.items():
        readings = {}
        for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
            clean_env(**env)
            system = build_ocr_system(dict(cfg), dtype=dtype)
            with LaunchCount(system.recognizer) as lc:
                got = ocr_rows(system(pages))
            lc.check(f"knob {name} {mode}")
            knob_launches += lc.launches
            want = golden["knobs"][mode][name]
            if mode == "fp32":
                check_ocr_equal(got, want, f"knob {name} fp32")
            else:
                vs = compare_to_golden(got, want, f"knob {name} bf16")
                readings["bf16_vs_golden"] = vs
                missed = vs["lines"] - vs["boxes_iou_ge_0.9"]
                check(missed <= KNOB_BF16["max_unmatched"], f"knob {name} bf16: {missed} unmatched")
                check(vs["exact_share"] >= KNOB_BF16["min_exact_share"],
                      f"knob {name} bf16: only {vs['exact_share']:.3f} of lines equal")
                check(vs["cer"] <= KNOB_BF16["max_cer"], f"knob {name} bf16: CER {vs['cer']:.4f}")
        emit({"phase": "ocr_family", "path": "knob", "knob": name, "fp32_equal": True, **readings})
    counts["knobs"] = knob_launches

    # word boxes
    clean_env()
    system = build_ocr_system(dtype=torch.float32)
    with LaunchCount(system.recognizer) as lc:
        got = system([pages[i] for i in WORD_PAGES], return_word_boxes=True)
    lc.check("words fp32")
    check_ocr_equal(ocr_rows(got), golden["words"]["fp32"], "words fp32", WORD_POLY_TOL)
    words = sum(len(it["words"]) for p in got for it in p)
    emit({"phase": "ocr_family", "path": "words", "dtype": "fp32", "words": words,
          "poly_tol_px": WORD_POLY_TOL, "equal": True})

    # the published format: RapidDoc with ocr_det_v6_small.npz and
    # ocr_rec_v6_small.npz in its models dir; K1 at V = 18 710
    models_dir = ROOT / "rapiddoc_tpu_torch" / "_build" / "published_ocr"
    write_published_ocr(models_dir)
    lines = [crop_quad(pages[0], np.asarray(b, np.float32)) for b in golden["published"]["boxes"]]
    doc = fixture_pdf()
    for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
        clean_env(RAPIDDOC_MODELS_DIR=str(models_dir), **off)
        rapid = RapidDoc(device="cuda", dtype=dtype)
        rec = rapid._stack().analyzer.ocr.recognizer
        check(rec.session.module.head.kernel.shape[1] == PUBLISHED_V,
              "published: the head is not 18 710 wide")
        rapid(doc, parse_method="ocr")  # warm-up
        torch.cuda.synchronize()
        with LaunchCount(rec) as lc:
            t0 = time.perf_counter()
            out = rapid(doc, parse_method="ocr")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = lc.check(f"published parse {mode}")
        texts = [r.text for r in rec(lines)]
        want = golden["published"][mode]["texts"]
        equal = sum(a == b for a, b in zip(texts, want))
        emit({"phase": "ocr_family", "path": "published", "dtype": mode, "card": card,
              "v": PUBLISHED_V, "pages": len(out.model_json),
              "pages_per_s": len(out.model_json) / wall, "launches": launches,
              "rec_lines_equal": equal, "rec_lines": len(want)})
        counts["published"] = lc.launches
        if mode == "fp32":
            check(equal == len(want), f"published fp32: {equal}/{len(want)} rec lines equal")
        else:
            check(equal >= PUBLISHED_BF16_MIN_EQUAL,
                  f"published bf16: {equal}/{len(want)} rec lines equal")
    clean_env()
    return counts


def phase_table_ocr(card: str) -> dict:
    """TableRecognizer(ocr_system=build_ocr_system()) on the 15 committed
    crops and the two of table_ocr_crops.npz, in four configurations:
    fp32 HTML equal to the golden's with no fallback taken, bf16 (default
    configuration) within its band; ms a table and the OCR share of it.
    Returns K1's launches."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    golden = json.loads(asset("table_ocr_golden.json").read_text())
    with np.load(asset("table_smoke_crops.npz")) as z:
        crops = [z[f"crop_{i}"] for i in range(15)]
    with np.load(asset("table_ocr_crops.npz")) as z:
        crops += [z["stacked_glyphs"], z["text_grid"]]
    clean_env()
    launches = 0
    for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
        ocr = build_ocr_system(dtype=dtype)
        for name, cfg in TABLE_OCR_CONFIGS.items():
            if mode == "bf16" and name != "default":
                continue
            rec = TableRecognizer.build(dict(cfg), device="cuda", dtype=dtype)
            rec.ocr = ocr
            rec.batch_predict(crops[:2])  # warm-up
            torch.cuda.synchronize()
            with LaunchCount(ocr.recognizer) as lc:
                t0 = time.perf_counter()
                html = rec.batch_predict(crops)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counted = lc.check(f"table_ocr {name} {mode}")
            launches += lc.launches
            check(rec.fallbacks == 0, f"table_ocr {name} {mode}: a fallback was taken")
            t0 = time.perf_counter()
            ocr(crops, return_word_boxes=True)
            torch.cuda.synchronize()
            ocr_s = time.perf_counter() - t0
            vs = compare_tables(html, golden[mode][name])
            emit({"phase": "table_ocr", "config": name, "dtype": mode, "card": card,
                  "tables": len(crops), "ms_per_table": wall * 1e3 / len(crops),
                  "ocr_ms_per_table": ocr_s * 1e3 / len(crops), "ocr_share": ocr_s / wall,
                  "launches": counted, "vs_golden": vs})
            if mode == "fp32":
                check(html == golden["fp32"][name],
                      f"table_ocr {name} fp32: {vs['equal']}/{vs['tables']} tables' HTML equal")
            else:
                check_table_ocr_bf16(vs)
    clean_env()
    return {"table_ocr": launches}


def masked_dets(model_json: list) -> list:
    """Each page's dets (category, poly, text), the uuids of in-table image
    placeholders masked as table_parse_summary masks them."""
    dets = [[{"category_id": d["category_id"], "poly": [float(v) for v in d["poly"]],
              "text": d.get("text", "")} for d in page["layout_dets"]] for page in model_json]
    text = json.dumps(dets)
    for page in model_json:
        for det in page["layout_dets"]:
            for fill in det.get("fill_images", []):
                text = text.replace(fill["uuid"], "<uuid>")
    return json.loads(text)


def phase_orientation(card: str) -> dict:
    """USE_DOC_ORIENTATION_CLASSIFY=1 RapidDoc(device="cuda")(pdf,
    parse_method="ocr") on the landscape fixture with every stage on:
    fp32 angles, Markdown, content list, tables, LaTeX, payloads and dets
    equal to the golden's (boxes within ORIENTATION_BOX_TOL), bf16 within
    bands; _rotate_dets_back runs on the card. Returns K1's launches."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.render import render_page_full
    from rapiddoc_tpu_torch.pipeline import scheduler

    golden = json.loads(asset("orientation_smoke_golden.json").read_text())
    pdf = asset("orientation_smoke_doc.pdf").read_bytes()
    doc = open_pdf(pdf)
    pages = [np.asarray(render_page_full(doc.get_page(i), dpi=200, with_text=False)[0])
             for i in range(len(doc))]
    check([sha256(p) for p in pages] == golden["page_sha256"], "orientation: pages differ")
    turned = []
    real = scheduler._rotate_dets_back

    def counted(dets, angle, w, h):
        turned.append(angle)
        return real(dets, angle, w, h)

    scheduler._rotate_dets_back = counted
    launches = 0
    try:
        for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
            clean_env(USE_DOC_ORIENTATION_CLASSIFY="1", RAPIDDOC_DEMO_LAYOUT="1")
            rapid = RapidDoc(device="cuda", dtype=dtype)
            analyzer = rapid._stack().analyzer
            angles = analyzer.orientation_model(pages)
            rapid(pdf, parse_method="ocr")  # warm-up
            torch.cuda.synchronize()
            turned.clear()
            with LaunchCount(analyzer.ocr.recognizer) as lc:
                t0 = time.perf_counter()
                out = rapid(pdf, parse_method="ocr")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = lc.check(f"orientation {mode}")
            launches += lc.launches
            got = table_parse_summary(out)
            want = golden[mode]
            vs = compare_table_parse(got, want)
            emit({"phase": "orientation", "dtype": mode, "card": card, "angles": angles,
                  "golden_angles": golden["angles"][mode], "turned_back": turned,
                  "pages": len(out.model_json), "pages_per_s": len(out.model_json) / wall,
                  "launches": counts, "vs_golden": vs})
            check(sorted(turned) == sorted(a for a in angles if a),
                  f"orientation {mode}: dets turned back for {turned}, angles {angles}")
            if mode == "fp32":
                check(angles == golden["angles"]["fp32"], f"orientation fp32: angles {angles}")
                check(any(angles), "orientation fp32: no page was turned")
                for key in ("markdown", "content_list", "tables", "latex", "images"):
                    check(got[key] == want[key], f"orientation fp32: the {key} differs")
                dets = masked_dets(out.model_json)
                check([len(p) for p in dets] == [len(p) for p in want["dets"]],
                      "orientation fp32: det counts differ")
                for gp, wp in zip(dets, want["dets"]):
                    for g, w in zip(gp, wp):
                        check((g["category_id"], g["text"]) == (w["category_id"], w["text"]),
                              "orientation fp32: a det's category or text differs")
                        err = float(np.abs(np.asarray(g["poly"], np.float64)
                                           - np.asarray(w["poly"])).max())
                        check(err <= ORIENTATION_BOX_TOL, f"orientation fp32: a det is {err:.3g} px off")
            else:
                check(sum(a == b for a, b in zip(angles, golden["angles"]["bf16"]))
                      >= ORIENTATION_BF16["min_angles_equal"], f"orientation bf16: angles {angles}")
                md = vs["markdown"]
                check(md["exact_share"] >= ORIENTATION_BF16["min_exact_share"],
                      f"orientation bf16: only {md['exact_share']:.3f} of lines equal")
                check(md["cer"] <= ORIENTATION_BF16["max_cer"],
                      f"orientation bf16: CER {md['cer']:.4f}")
    finally:
        scheduler._rotate_dets_back = real
        clean_env()
    return {"orientation": launches}


# ------------------------------------------------- the eighth slice's paths

# tests/test_torch_seal.py holds the crops' and the golden's generator
SEAL_CROPS = ("circle", "ellipse", "arc_band", "straight_band", "no_stamp")
SEAL_ELLIPSE_TOL = 1e-3  # px and degrees, fitEllipse's floats
SEAL_PAGE_SIZE = (1000, 1400)
SEAL_TIMED_RUNS = 3
# The bf16 seal texts against the JAX package's bf16 golden. The demo rec
# reads stamp text poorly and unstably: the JAX package's own fp32 and
# bf16 agree on 2 of the 5 seals (CER 0.444), the port's bf16 on the CPU
# on 3 (CER 0.417; both read by `python tests/test_torch_seal.py
# --compare`), the card on 2 (CER 0.361, PERF.md §6). The band leaves
# one seal below the card and 0.13 CER above the CPU.
SEAL_BF16 = {"min_equal": 1, "max_cer": 0.55}
DET_BOX_TOL = 0.05  # px, the layout detector's fp32 boxes in a parse


def seal_page(crops: list) -> tuple:
    """The crops pasted on a white page (tests/test_torch_seal.seal_page),
    and their boxes."""
    import numpy as np

    w, h = SEAL_PAGE_SIZE
    page = np.full((h, w, 3), 255, np.uint8)
    boxes, y = [], 20
    for i, crop in enumerate(crops):
        x = 40 + 300 * (i % 2)
        ch, cw = crop.shape[:2]
        page[y:y + ch, x:x + cw] = crop
        boxes.append([float(x), float(y), float(x + cw - 1), float(y + ch - 1)])
        y += ch + 24
    return page, boxes


class SealLayout:
    """A layout model that puts a seal det on each given box."""

    def __init__(self, boxes):
        self.boxes = boxes

    def batch_predict(self, pages):
        return [[{"category_id": 3, "original_label": "seal", "score": 0.9,
                  "poly": [x0, y0, x1, y0, x1, y1, x0, y1]}
                 for x0, y0, x1, y1 in self.boxes] for _ in pages]


class RecordingOCR:
    """A text system that records the regions it reads."""

    def __init__(self, system):
        self.system, self.detector, self.regions = system, system.detector, []

    def __call__(self, regions):
        self.regions.extend(regions)
        return self.system(regions)


def compare_seal_texts(got: list, want: list) -> dict:
    """Seal texts against the golden's: how many equal, and the CER."""
    edits = sum(_edits(a, b) for a, b in zip(got, want))
    return {"seals": len(want), "equal": sum(a == b for a, b in zip(got, want)),
            "cer": edits / max(sum(len(w) for w in want), 1)}


def phase_seal(card: str) -> dict:
    """Seal OCR with the demo OCR on the committed crops: fp32 circles,
    ellipses, detect_polys polygons, the regions SealOCR.batch reads, its
    texts and _run_seals with seal dets put in place equal to the JAX
    package's golden; bf16 texts within SEAL_BF16, ms a seal, K1's
    launches held to the rec dispatches; the 8-bit layout wire's fp32
    dets equal to the golden's. Returns K1's launches."""
    import hashlib

    import numpy as np
    import torch

    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.models.ocr import seal
    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full
    from rapiddoc_tpu_torch.pipeline.scheduler import DocumentAnalyzer

    def digest(a) -> str:
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads(asset("seal_smoke_golden.json").read_text())
    with np.load(asset("seal_smoke_crops.npz")) as z:
        crops = [z[name] for name in SEAL_CROPS]
    check([digest(c) for c in crops] == golden["crop_sha256"], "seal: the crops differ")
    clean_env()
    circles = [seal.detect_circle(c) for c in crops]
    check([None if c is None else list(c) for c in circles] == golden["circles"],
          f"seal: circles {circles}")
    for c, circle, want in zip(crops, circles, golden["ellipses"]):
        if circle is None:
            e = seal.detect_ellipse(c)
            got = None if e is None else [*e[0], *e[1], e[2]]
            check((got is None) == (want is None) and (
                want is None or max(abs(a - b) for a, b in zip(got, want)) <= SEAL_ELLIPSE_TOL),
                f"seal: ellipse {got}, golden {want}")
    launches = 0
    page, boxes = seal_page(crops)
    for dtype, mode in ((torch.float32, "fp32"), (None, "bf16")):
        ocr = build_ocr_system(dtype=dtype)
        want = golden[mode]
        rec = RecordingOCR(ocr)
        seal.SealOCR(rec).batch(crops)  # warm-up
        torch.cuda.synchronize()
        rec.regions.clear()
        with LaunchCount(ocr.recognizer) as lc:
            t0 = time.perf_counter()
            for _ in range(SEAL_TIMED_RUNS):
                texts = seal.SealOCR(rec).batch(crops)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counted = lc.check(f"seal {mode}")
        launches += lc.launches
        infos = DocumentAnalyzer(layout_model=SealLayout(boxes), ocr_system=ocr).analyze_pages(
            [page], ["txt"], [None])
        run_seals = [d.get("text", "") for d in infos[0]["layout_dets"]]
        vs = compare_seal_texts(texts, want["texts"])
        emit({"phase": "seal", "dtype": mode, "card": card, "seals": len(crops),
              "ms_per_seal": wall * 1e3 / (SEAL_TIMED_RUNS * len(crops)),
              "regions": len(rec.regions) // SEAL_TIMED_RUNS, "launches": counted,
              "vs_golden": vs, "texts": texts, "run_seals_equal": run_seals == want["run_seals"]})
        if mode == "fp32":
            polys = [[np.asarray(p, np.float64).tolist() for p in page_polys] for page_polys in
                     ocr.detector.detect_polys(crops, params=seal.SEAL_DET_PARAMS)]
            check(polys == want["polys"], "seal fp32: the detect_polys polygons differ")
            regions = [digest(r) for r in rec.regions[: len(want["regions"])]]
            check(regions == want["regions"], "seal fp32: the regions read differ")
            check(texts == want["texts"], f"seal fp32: texts {texts}")
            check(run_seals == want["run_seals"], f"seal fp32: _run_seals gave {run_seals}")
        else:
            check(vs["equal"] >= SEAL_BF16["min_equal"], f"seal bf16: {vs['equal']} texts equal")
            check(vs["cer"] <= SEAL_BF16["max_cer"], f"seal bf16: CER {vs['cer']:.4f}")
    # RAPIDDOC_LAYOUT_WIRE_BITS=8: the JAX package's RGB wire
    doc = open_pdf(layout_pdf())
    pages = [render_page_full(doc.get_page(i), dpi=200, with_text=False)[0]
             for i in range(len(doc))]
    clean_env(RAPIDDOC_LAYOUT_WIRE_BITS="8")
    det = LayoutDetector.build({"demo_layout": True}, dtype=torch.float32)
    check(not det.nibble_wire, "layout: the 8-bit wire is off")
    worst = check_layout_fp32([layout_rows(d) for d in det.batch_predict(pages)],
                              golden["layout_wire8"])
    emit({"phase": "seal", "path": "layout_wire8", "dtype": "fp32", "pages": len(pages),
          "max_box_err_px": worst})
    clean_env()
    return {"seal": launches}


def assert_same_parse(got: dict, want: dict, label: str) -> None:
    """A parse summary (with its dets) equal to the golden's: Markdown,
    content list, LaTeX and payloads; dets' categories and texts, boxes
    within DET_BOX_TOL."""
    for part in ("markdown", "content_list", "latex", "images"):
        check(got[part] == want[part], f"{label}: the {part} differs from the golden's")
    check([len(p) for p in got["dets"]] == [len(p) for p in want["model_info"]],
          f"{label}: det counts differ")
    for gp, wp in zip(got["dets"], want["model_info"]):
        for g, w in zip(gp, wp):
            check((g["category_id"], g["text"]) == (w["category_id"], w["text"]),
                  f"{label}: a det's category or text differs")
            err = max(abs(a - b) for a, b in zip(g["poly"], w["poly"]))
            check(err <= DET_BOX_TOL, f"{label}: a det is {err:.3g} px off")


def phase_image_inputs(card: str) -> dict:
    """Image inputs through the PDF writer into RapidDoc on the card: the
    committed PNG path, JPEG bytes and array become the golden's PDFs;
    fp32 with every stage on equal to the golden, parse_batch over [a PDF,
    the PNG] equal to the single parses, extract_original_image's
    payloads equal; then bf16 with the int8 head, every stage on, over
    the three inputs in one parse_batch: pages/s, K1's launches held to
    the rec dispatches and K2's to the decode steps. Returns the
    launches."""
    import hashlib

    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8
    from rapiddoc_tpu_torch.pdfio.png import decode_png
    from rapiddoc_tpu_torch.pdfio.writer import images_to_pdf

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads(asset("image_inputs_golden.json").read_text())
    png_path, jpeg = asset("image_inputs_page.png"), asset("image_inputs_page.jpg").read_bytes()
    array = decode_png(asset("image_inputs_array.png").read_bytes())
    inputs = {"png": png_path, "jpeg": jpeg, "array": array}
    dpi = golden["dpi"]
    pdfs = {"png": images_to_pdf([png_path.read_bytes()], dpi=dpi),
            "jpeg": images_to_pdf([jpeg], dpi=dpi), "array": images_to_pdf([array], dpi=dpi)}
    check({k: hashlib.sha256(v).hexdigest() for k, v in pdfs.items()} == golden["pdf_sha256"],
          "image_inputs: images_to_pdf's bytes differ from the JAX package's")

    def summary(out) -> dict:
        got = parse_summary(out)
        got["dets"] = masked_dets(out.model_json)
        return got

    # fp32, every stage on
    clean_env(RAPIDDOC_DEMO_LAYOUT="1")
    want = golden["table_on"]
    rapid = RapidDoc(device="cuda", dtype=torch.float32)
    singles = {k: summary(rapid(v, parse_method="ocr")) for k, v in inputs.items()}
    for k, got in singles.items():
        assert_same_parse(got, want[k], f"image_inputs fp32 {k}")
    batch = [summary(o) for o in RapidDoc(device="cuda", dtype=torch.float32, parse_method="ocr")
             .parse_batch([pdfs["jpeg"], png_path])]
    for got, w, single, k in zip(batch, want["batch"], (singles["jpeg"], singles["png"]),
                                 ("jpeg", "png")):
        assert_same_parse(got, w, f"image_inputs fp32 parse_batch {k}")
        check({p: got[p] for p in ("markdown", "content_list", "latex", "images")}
              == {p: single[p] for p in ("markdown", "content_list", "latex", "images")},
              f"image_inputs fp32: parse_batch's {k} differs from its single parse")
    # extract_original_image on the fallback layout
    off = {f"RAPIDDOC_DISABLE_{k}": "1" for k in ("LAYOUT", "FORMULA", "TABLE")}
    originals = {}
    for extract in (True, False):
        clean_env(**off)
        out = RapidDoc(device="cuda", dtype=torch.float32,
                       image_config={"extract_original_image": extract})(
            asset("originals_doc.pdf").read_bytes(), parse_method="ocr")
        originals["extract" if extract else "crop"] = parse_summary(out)
    check(originals == golden["originals"],
          "image_inputs: extract_original_image's payloads differ from the golden's")
    emit({"phase": "image_inputs", "dtype": "fp32", "card": card, "inputs": list(inputs),
          "pdfs_equal": True, "parses_equal": True, "parse_batch_equal": True,
          "original_payloads": len(originals["extract"]["images"])})

    # bf16 with the int8 head, every stage on: the timed run
    clean_env(RAPIDDOC_DEMO_LAYOUT="1", RAPIDDOC_INT8_HEAD="1")
    rapid = RapidDoc(device="cuda", parse_method="ocr")
    items = list(inputs.values())
    rapid(items)  # warm-up
    torch.cuda.synchronize()
    analyzer = rapid._stack().analyzer
    rec, formula = analyzer.ocr.recognizer.session.stats, analyzer.formula_model.stats
    calls, steps = rec.calls, formula.decode_steps
    fused_ctc_argmax.launches = 0
    fused_argmax_int8.launches = 0
    t0 = time.perf_counter()
    outs = rapid(items)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"ctc_head": fused_ctc_argmax.launches, "quant_head": fused_argmax_int8.launches,
              "rec_dispatches": rec.calls - calls, "decode_steps": formula.decode_steps - steps}
    vs = [compare_markdown(o.markdown, want[k]["markdown"]) for o, k in zip(outs, inputs)]
    emit({"phase": "image_inputs", "dtype": "bf16", "int8_head": True, "card": card,
          "pages": len(outs), "pages_per_s": len(outs) / wall, "launches": counts,
          "vs_fp32_golden": vs})
    check(all(o.markdown.strip() for o in outs), "image_inputs bf16: an empty Markdown")
    for name, per in (("ctc_head", "rec_dispatches"), ("quant_head", "decode_steps")):
        check(counts[name] > 0, f"image_inputs launched the {name} kernel no time")
        check(counts[name] == counts[per],
              f"image_inputs: {counts[name]} {name} launches for {counts[per]} {per}")
    counts["image_files"] = image_files(card)
    clean_env()
    return counts


# The thirteenth slice's image inputs: one page of each file format the
# port decodes (tests/test_torch_image_files.py writes them with PIL and
# the golden with the JAX package) and two arrays made from it.
IMAGE_FILES = {"bmp": "image_files_page.bmp", "gif": "image_files_page.gif",
               "tiff_lzw": "image_files_page_lzw.tif", "tiff_g4": "image_files_page_g4.tif",
               "png16": "image_files_page16.png", "png_adam7": "image_files_page_adam7.png"}
IMAGE_DECODE_RUNS = 5


def image_file_inputs() -> dict:
    """{case: file bytes or array}: the committed pages, and a float32 and
    a uint16 array from the interlaced PNG's grey (values past 0..255 at
    both ends), as tests/test_torch_image_files.py makes them."""
    import numpy as np

    from rapiddoc_tpu_torch.pdfio.png import decode_png

    out = {k: asset(name).read_bytes() for k, name in IMAGE_FILES.items()}
    rgb = decode_png(out["png_adam7"])
    grey = (rgb.astype(np.int32) @ np.array([299, 587, 114]) // 1000).astype(np.uint8)
    out["float32"] = grey.astype(np.float32) * 1.25 - 20.0
    out["uint16"] = (grey.astype(np.uint16) * 3).astype(np.uint16)
    return out


def image_files(card: str) -> int:
    """BMP, GIF, LZW and G4 TIFF, 16-bit and interlaced PNG files and
    float32 and uint16 arrays: each page's raster (the pixels
    images_to_pdf embeds) and PDF sha256 equal to the JAX package's
    golden, host ms a page of each decoder; then one parse_batch of the
    eight in fp32 on the card (OCR, fallback layout): Markdown and content
    list equal to the golden, K1's launches held to the rec dispatches.
    Returns K1's launches."""
    import hashlib

    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio.writer import _pixels, images_to_pdf

    golden = json.loads(asset("image_files_golden.json").read_text())
    inputs = image_file_inputs()
    decode_ms = {}
    for k, item in inputs.items():
        pixels = _pixels(item)
        check(hashlib.sha256(np.ascontiguousarray(pixels).tobytes()).hexdigest()
              == golden["raster_sha256"][k], f"image_files: {k}'s raster differs from the golden's")
        pdf = images_to_pdf([item], dpi=golden["dpi"])
        check(hashlib.sha256(pdf).hexdigest() == golden["pdf_sha256"][k],
              f"image_files: {k}'s PDF differs from the JAX package's")
        decode_ms[k] = host_ms(lambda: _pixels(item), IMAGE_DECODE_RUNS)
    clean_env(**golden["config"])
    rapid = RapidDoc(device="cuda", dtype=torch.float32, parse_method="ocr")
    items = list(inputs.values())
    rapid(items[:1])  # builds the models
    torch.cuda.synchronize()
    with LaunchCount(rapid._stack().analyzer.ocr.recognizer) as counted:
        t0 = time.perf_counter()
        outs = rapid(items)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = counted.check("image_files fp32")
    for (k, _), out in zip(inputs.items(), outs):
        want = golden["parse"][k]
        check(out.markdown == want["markdown"], f"image_files fp32: {k}'s Markdown differs")
        check(json.loads(json.dumps(out.content_list_json)) == want["content_list"],
              f"image_files fp32: {k}'s content list differs")
    emit({"phase": "image_inputs", "path": "image_files", "dtype": "fp32", "card": card,
          "inputs": list(inputs), "rasters_equal": True, "pdfs_equal": True,
          "parses_equal": True, "decode_host_ms": decode_ms, "pages": len(outs),
          "parse_batch_s": wall, "launches": launches})
    return launches["ctc_head"]


# ------------------------------------------- the thirteenth slice's Office

def office_summary(out) -> dict:
    """What the Office golden holds: Markdown, content list and middle
    json through JSON, and each payload's size."""
    return json.loads(json.dumps({
        "markdown": out.markdown, "content_list": out.content_list_json,
        "middle_json": out.middle_json,
        "images": {k: len(v) for k, v in sorted(out.images.items())},
    }, default=str))


def phase_office(card: str) -> None:
    """Office documents through RapidDoc(device="cuda"): the committed
    docx, pptx and xlsx (tests/test_torch_office.py writes them from
    seeds, and the golden with the JAX package) and a zero-byte docx, in
    "url" and "data_uri" modes, each equal to the golden. The path runs
    on the host and launches no kernel; it reports its seconds."""
    import tempfile

    from rapiddoc_tpu_torch import RapidDoc

    t0 = time.perf_counter()
    golden = json.loads(asset("office_smoke_golden.json").read_text())
    got, ms = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        empty = Path(tmp) / "empty.docx"
        empty.write_bytes(b"")
        paths = {kind: asset(f"office_smoke.{kind}") for kind in ("docx", "pptx", "xlsx")}
        paths["empty_docx"] = empty
        for mode in ("url", "data_uri"):
            rapid = RapidDoc(device="cuda", image_output_mode=mode)
            for kind, path in paths.items():
                t1 = time.perf_counter()
                got[f"{kind}_{mode}"] = office_summary(rapid(path))
                ms[f"{kind}_{mode}"] = (time.perf_counter() - t1) * 1e3
    check(set(got) == set(golden), "office: the documents differ from the golden's")
    for key, want in golden.items():
        check(got[key] == want, f"office: {key}'s output differs from the golden's")
    emit({"phase": "office", "card": card, "documents": len(got), "outputs_equal": True,
          "host_ms": ms, "phase_seconds": time.perf_counter() - t0})


# ------------------------------------------------- the ninth slice's path

# The born-digital fixture (tests/test_torch_vector.py writes it and its
# golden). Its bf16 "ocr" parse with the int8 head against the JAX
# package's bf16 int8 golden. The port's bf16 on the CPU: 33/44 lines
# equal (0.75), CER 0.173, LaTeX CER 0.150, 2/2 formulas, 5/5 images; the
# JAX package's fp32 against its bf16: 0.705, 0.138, 0.329 (python
# tests/test_torch_vector.py). The margins: 0.15 of lines (44 lines),
# 0.13 of CER, LaTeX CER up to the earlier slices' 0.65 (two formulas),
# 2 formulas or images.
VECTOR_BF16 = {"min_exact_share": 0.60, "max_cer": 0.30, "max_latex_cer": 0.65,
               "max_count_gap": 2}
VECTOR_RENDER_RUNS = {"200": 2, "72": 1}


def phase_vector(card: str) -> dict:
    """Born-digital pages (vector paths, clips, masks, turned and small
    images, Type3 glyphs): each page rendered on the card's host at 200
    and 72 dpi with the raster's sha256 equal to the golden's, render
    ms/page; RapidDoc(device="cuda") in fp32 (TF32 off) in "ocr" mode with
    the int8 head off and on and in "auto" mode equal to the golden; the
    bf16 int8-head "ocr" parse timed, its launches counted from 0 and held
    to the rec dispatches and decode steps, its output within
    VECTOR_BF16. Returns the launches."""
    import hashlib

    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.bench import STAGES, device_busy_share
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8
    from rapiddoc_tpu_torch.pdfio import classify_pdf, open_pdf, render_page_full
    from rapiddoc_tpu_torch.utils.trace import GLOBAL_TRACER

    golden = json.loads(asset("vector_smoke_golden.json").read_text())
    pdf = asset("vector_smoke_doc.pdf").read_bytes()
    render_ms = {}
    for dpi, pages in golden["render"]["pages"].items():
        times = []
        for run in range(VECTOR_RENDER_RUNS[dpi]):
            doc = open_pdf(pdf)  # the render caches are the document's
            for i, want in enumerate(pages):
                t0 = time.perf_counter()
                img, text, boxes = render_page_full(doc.get_page(i), dpi=int(dpi))
                times.append(time.perf_counter() - t0)
                check(hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
                      == want["sha256"], f"vector: page {i} at {dpi} dpi differs from the golden's")
                if "text" in want:
                    check(json.loads(json.dumps(text)) == want["text"] and boxes == want["boxes"],
                          f"vector: page {i}'s text or image boxes differ at {dpi} dpi")
        render_ms[dpi] = {"mean": 1e3 * sum(times) / len(times), "max": 1e3 * max(times)}
    check(classify_pdf(pdf) == golden["render"]["classify"], "vector: classify_pdf differs")

    def summary(out) -> dict:
        got = parse_summary(out)
        got["dets"] = masked_dets(out.model_json)
        return got

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for mode, method, extra in (("ocr_fp32", "ocr", {}),
                                ("ocr_fp32_int8", "ocr", {"RAPIDDOC_INT8_HEAD": "1"}),
                                ("auto_fp32", "auto", {})):
        clean_env(RAPIDDOC_DEMO_LAYOUT="1", **extra)
        out = RapidDoc(device="cuda", dtype=torch.float32)(pdf, parse_method=method)
        assert_same_parse(summary(out), golden[mode], f"vector fp32 {mode}")
    emit({"phase": "vector", "dtype": "fp32", "card": card, "pages": len(pages),
          "render_ms_per_page": render_ms, "pages_equal": True, "parses_equal": True})

    # bf16 with the int8 head, every stage on: the timed run
    clean_env(RAPIDDOC_DEMO_LAYOUT="1", RAPIDDOC_INT8_HEAD="1")
    rapid = RapidDoc(device="cuda")
    rapid(pdf, parse_method="ocr")  # warm-up
    torch.cuda.synchronize()
    analyzer = rapid._stack().analyzer
    rec, formula = analyzer.ocr.recognizer.session.stats, analyzer.formula_model.stats
    GLOBAL_TRACER.reset()
    calls, steps = rec.calls, formula.decode_steps
    fused_ctc_argmax.launches = 0
    fused_argmax_int8.launches = 0
    t0 = time.perf_counter()
    out = rapid(pdf, parse_method="ocr")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"ctc_head": fused_ctc_argmax.launches, "quant_head": fused_argmax_int8.launches,
              "rec_dispatches": rec.calls - calls, "decode_steps": formula.decode_steps - steps}
    report = GLOBAL_TRACER.report()
    n = len(out.model_json)
    kernel_ms, traced_ms = device_busy_share(lambda: rapid(pdf, parse_method="ocr"))
    vs = compare_layout_parse(parse_summary(out), golden["ocr_bf16_int8"])
    emit({"phase": "vector", "dtype": "bf16", "int8_head": True, "card": card,
          "pages": n, "pages_per_s": n / wall,
          "stage_ms_per_page": {k: report[k]["total_s"] * 1e3 / n for k in STAGES if k in report},
          "device_busy_share": kernel_ms / traced_ms, "device_kernel_ms_per_page": kernel_ms / n,
          "launches": counts, "vs_golden_bf16_int8": vs})
    for name, per in (("ctc_head", "rec_dispatches"), ("quant_head", "decode_steps")):
        check(counts[name] > 0, f"vector launched the {name} kernel no time")
        check(counts[name] == counts[per],
              f"vector: {counts[name]} {name} launches for {counts[per]} {per}")
    lim = VECTOR_BF16
    md = vs["markdown"]
    check(md["exact_share"] >= lim["min_exact_share"],
          f"vector bf16: only {md['exact_share']:.3f} of lines equal")
    check(md["cer"] <= lim["max_cer"], f"vector bf16: CER {md['cer']:.4f}")
    check(vs["latex_cer"] <= lim["max_latex_cer"], f"vector bf16: LaTeX CER {vs['latex_cer']:.4f}")
    check(abs(vs["formulas"] - vs["golden_formulas"]) <= lim["max_count_gap"],
          f"vector bf16: {vs['formulas']} formulas, golden {vs['golden_formulas']}")
    check(abs(vs["images"] - vs["golden_images"]) <= lim["max_count_gap"],
          f"vector bf16: {vs['images']} images, golden {vs['golden_images']}")
    clean_env()
    return counts


# JAX package's fp32 int8 against its bf16 int8: 0.64 of lines, CER 0.051,
# LaTeX CER 0.667 (2 formulas); the port's bf16 on the CPU: 0.68, 0.018,
# 0.544 (python tests/test_torch_text.py --compare). The margins: 0.14 of
# lines (25 lines), 0.10 of CER, LaTeX CER to 0.80, 2 formulas or images.
TEXT_BF16 = {"min_exact_share": 0.50, "max_cer": 0.15, "max_latex_cer": 0.80,
             "max_count_gap": 2}
# the no-fallback-font page at 72 dpi against the JAX package's (Aileron at
# 10 px, which FreeType autohints and the port draws unhinted): over the
# pixels either inks, the mean absolute difference and the share more
# than 64 apart (tests/test_torch_text.py RASTER_BAND)
TEXT_AILERON_BAND = (32.0, 0.25)
TEXT_RENDER_RUNS = {"200": 2, "72": 1}


def text_fallback(pdf: bytes, case: str):
    """Point the port's fallback font at F1's program (read from the
    fixture) for ``case`` "exact", or at no candidate ("aileron":
    ImageFont.load_default's Aileron at 10 px); returns the temporary
    directory to clean up."""
    import tempfile

    import rapiddoc_tpu_torch.pdfio.render as render_mod
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.fonts import load_font

    tmp = tempfile.TemporaryDirectory()
    if case == "exact":
        doc = open_pdf(pdf)
        fonts = doc.resolve(doc.get_page(0).resources["Font"])
        path = Path(tmp.name) / "fallback.ttf"
        path.write_bytes(load_font(doc, doc.resolve(fonts["F1"])).font_program)
        os.environ["RAPIDDOC_FALLBACK_FONT"] = str(path)
        render_mod._FALLBACK_FONTS_CACHE = None
    else:
        os.environ.pop("RAPIDDOC_FALLBACK_FONT", None)
        render_mod._FALLBACK_FONTS_CACHE = []
    return tmp


def grey_band(got, want) -> dict:
    """Over the pixels either grey raster inks (below 250): the mean
    absolute difference and the share more than 64 apart."""
    import numpy as np

    a = np.asarray(got).min(axis=2).astype(np.int16) if got.ndim == 3 else got.astype(np.int16)
    b = want.astype(np.int16)
    ink = (a < 250) | (b < 250)
    d = np.abs(a - b)[ink]
    return {"mean_abs": float(d.mean()) if d.size else 0.0,
            "share_over_64": float((d > 64).mean()) if d.size else 0.0}


def phase_text(card: str) -> dict:
    """Text drawn from font programs (embedded TrueType, a symbol-cmap CID
    TrueType, bare CFF, Type1) and the fallback font: each page rendered
    on the card's host at 200 and 72 dpi with F1's program as the
    fallback, the raster's sha256 equal to the golden's, render ms/page and
    the glyph-tile cache's hit rate; with no fallback font (Aileron at
    10 px) each 72 dpi page within TEXT_AILERON_BAND of the JAX package's;
    RapidDoc(device="cuda") in fp32 (TF32 off) in "ocr" mode with the int8
    head off and on and in "txt" mode equal to the golden; the bf16
    int8-head "ocr" parse timed, its launches counted from 0 and held to
    the rec dispatches and decode steps, its output within TEXT_BF16.
    Returns the launches."""
    import hashlib

    import numpy as np
    import torch

    import rapiddoc_tpu_torch.pdfio.render as render_mod
    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.bench import STAGES, device_busy_share
    from rapiddoc_tpu_torch.ops.ctc_head import fused_ctc_argmax
    from rapiddoc_tpu_torch.ops.quant_head import fused_argmax_int8
    from rapiddoc_tpu_torch.pdfio import classify_pdf, open_pdf, render_page_full
    from rapiddoc_tpu_torch.utils.trace import GLOBAL_TRACER

    golden = json.loads(asset("text_smoke_golden.json").read_text())
    pdf = asset("text_smoke_doc.pdf").read_bytes()
    clean_env()
    tmp = text_fallback(pdf, "exact")
    try:
        render_ms, tiles = {}, {}
        for dpi, pages in golden["render"]["pages"].items():
            times = []
            render_mod.TILE_STATS.update(hits=0, misses=0)
            for run in range(TEXT_RENDER_RUNS[dpi]):
                doc = open_pdf(pdf)  # the render caches are the document's
                for i, want in enumerate(pages):
                    t0 = time.perf_counter()
                    img, text, boxes = render_page_full(doc.get_page(i), dpi=int(dpi))
                    times.append(time.perf_counter() - t0)
                    check(hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()
                          == want["sha256"], f"text: page {i} at {dpi} dpi differs from the golden's")
                    if "text" in want:
                        check(json.loads(json.dumps(text)) == want["text"] and boxes == want["boxes"],
                              f"text: page {i}'s text or image boxes differ at {dpi} dpi")
            render_ms[dpi] = {"mean": 1e3 * sum(times) / len(times), "max": 1e3 * max(times),
                              "first_run_mean": 1e3 * sum(times[:len(pages)]) / len(pages)}
            st = dict(render_mod.TILE_STATS)
            tiles[dpi] = {**st, "hit_rate": st["hits"] / max(st["hits"] + st["misses"], 1)}
        check(classify_pdf(pdf) == golden["render"]["classify"], "text: classify_pdf differs")

        def summary(out) -> dict:
            got = parse_summary(out)
            got["dets"] = masked_dets(out.model_json)
            return got

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        for mode, method, extra in (("ocr_fp32", "ocr", {}),
                                    ("ocr_fp32_int8", "ocr", {"RAPIDDOC_INT8_HEAD": "1"}),
                                    ("txt_fp32", "txt", {})):
            for k, v in {"RAPIDDOC_DEMO_LAYOUT": "1", **extra}.items():
                os.environ[k] = v
            out = RapidDoc(device="cuda", dtype=torch.float32)(pdf, parse_method=method)
            os.environ.pop("RAPIDDOC_INT8_HEAD", None)
            assert_same_parse(summary(out), golden[mode], f"text fp32 {mode}")
        emit({"phase": "text", "dtype": "fp32", "card": card, "pages": len(pages),
              "render_ms_per_page": render_ms, "glyph_tiles": tiles,
              "pages_equal": True, "parses_equal": True})

        # bf16 with the int8 head, every stage on: the timed run
        os.environ.update(RAPIDDOC_DEMO_LAYOUT="1", RAPIDDOC_INT8_HEAD="1")
        rapid = RapidDoc(device="cuda")
        rapid(pdf, parse_method="ocr")  # warm-up
        torch.cuda.synchronize()
        analyzer = rapid._stack().analyzer
        rec, formula = analyzer.ocr.recognizer.session.stats, analyzer.formula_model.stats
        GLOBAL_TRACER.reset()
        calls, steps = rec.calls, formula.decode_steps
        fused_ctc_argmax.launches = 0
        fused_argmax_int8.launches = 0
        t0 = time.perf_counter()
        out = rapid(pdf, parse_method="ocr")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"ctc_head": fused_ctc_argmax.launches, "quant_head": fused_argmax_int8.launches,
                  "rec_dispatches": rec.calls - calls, "decode_steps": formula.decode_steps - steps}
        report = GLOBAL_TRACER.report()
        n = len(out.model_json)
        kernel_ms, traced_ms = device_busy_share(lambda: rapid(pdf, parse_method="ocr"))
        vs = compare_layout_parse(parse_summary(out), golden["ocr_bf16_int8"])

        # no fallback font: Aileron at 10 px, held to a band at 72 dpi
        tmp.cleanup()
        tmp = text_fallback(pdf, "aileron")
        stored = np.load(asset("text_smoke_band.npz"))
        doc = open_pdf(pdf)
        band = []
        for i in range(len(pages)):
            band.append(grey_band(render_page_full(doc.get_page(i), dpi=72)[0], stored[f"page{i}"]))
        emit({"phase": "text", "dtype": "bf16", "int8_head": True, "card": card,
              "pages": n, "pages_per_s": n / wall,
              "stage_ms_per_page": {k: report[k]["total_s"] * 1e3 / n for k in STAGES if k in report},
              "device_busy_share": kernel_ms / traced_ms, "device_kernel_ms_per_page": kernel_ms / n,
              "launches": counts, "vs_golden_bf16_int8": vs, "aileron_band_72dpi": band})
    finally:
        tmp.cleanup()
        render_mod._FALLBACK_FONTS_CACHE = None
        clean_env()
    for name, per in (("ctc_head", "rec_dispatches"), ("quant_head", "decode_steps")):
        check(counts[name] > 0, f"text launched the {name} kernel no time")
        check(counts[name] == counts[per],
              f"text: {counts[name]} {name} launches for {counts[per]} {per}")
    lim = TEXT_BF16
    md = vs["markdown"]
    check(md["exact_share"] >= lim["min_exact_share"],
          f"text bf16: only {md['exact_share']:.3f} of lines equal")
    check(md["cer"] <= lim["max_cer"], f"text bf16: CER {md['cer']:.4f}")
    check(vs["latex_cer"] <= lim["max_latex_cer"], f"text bf16: LaTeX CER {vs['latex_cer']:.4f}")
    check(abs(vs["formulas"] - vs["golden_formulas"]) <= lim["max_count_gap"],
          f"text bf16: {vs['formulas']} formulas, golden {vs['golden_formulas']}")
    check(abs(vs["images"] - vs["golden_images"]) <= lim["max_count_gap"],
          f"text bf16: {vs['images']} images, golden {vs['golden_images']}")
    for i, b in enumerate(band):
        check(b["mean_abs"] <= TEXT_AILERON_BAND[0] and b["share_over_64"] <= TEXT_AILERON_BAND[1],
              f"text: the Aileron page {i} is outside its band: {b}")
    return counts


# ------------------------------------------------ the eleventh slice's path

# Magika's scores against the JAX package's golden on the card, fp32 with
# TF32 off; the contract graphs' float outputs as
# tests/test_onnx_family_graphs.py holds them against numpy
MAGIKA_SCORE_TOL = 1e-4
GRAPH_ATOL = GRAPH_RTOL = 2e-4
GRAPH_DET_TOL = 0.05  # px, the RT-DETR graph's boxes
ONNX_TIMED_RUNS = 10
# suffix-less bytes: the OCR fixture's first page behind a short prefix
# that is not %PDF (Magika still calls it a PDF)
SUFFIXLESS_PREFIX = b"\r\n"
# the page of the layout fixture whose golden dets the ONNX layout emits
ONNX_LAYOUT_PAGE = 0


def magika_corpus() -> dict[str, bytes]:
    """Byte inputs for Magika: the port's PDF fixtures, a PNG, a JPEG, a
    docx-shaped zip, Python, Markdown, JSON, CSV, HTML and plain text,
    all built in code or committed."""
    import io
    import zipfile

    corpus = {name: asset(f"{name}.pdf").read_bytes() for name in (
        "ocr_smoke_doc", "layout_smoke_doc", "vector_smoke_doc", "text_smoke_doc")}
    corpus["png"] = asset("image_inputs_page.png").read_bytes()
    corpus["jpeg"] = asset("image_inputs_page.jpg").read_bytes()
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr(zipfile.ZipInfo("[Content_Types].xml", (2024, 1, 1, 0, 0, 0)),
                   '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n<Types xmlns='
                   '"http://schemas.openxmlformats.org/package/2006/content-types"><Default '
                   'Extension="xml" ContentType="application/xml"/><Override PartName='
                   '"/word/document.xml" ContentType="application/vnd.openxmlformats-'
                   'officedocument.wordprocessingml.document.main+xml"/></Types>')
        z.writestr(zipfile.ZipInfo("word/document.xml", (2024, 1, 1, 0, 0, 0)),
                   '<?xml version="1.0" encoding="UTF-8" standalone="yes"?>\n<w:document '
                   'xmlns:w="http://schemas.openxmlformats.org/wordprocessingml/2006/main">'
                   '<w:body>' + "".join(f"<w:p><w:r><w:t>Paragraph {i} of the report."
                                        "</w:t></w:r></w:p>" for i in range(40))
                   + "</w:body></w:document>")
    corpus["docx"] = buf.getvalue()
    corpus["python"] = "\n".join(
        ["import json", "from pathlib import Path", "", "",
         "def load_rows(path: Path) -> list[dict]:",
         '    """Read one JSON object per line."""', "    rows = []",
         "    with open(path, encoding=\"utf-8\") as f:", "        for line in f:",
         "            if line.strip():", "                rows.append(json.loads(line))",
         "    return rows", "", ""]
        + [f"def total_{i}(rows):\n    return sum(r.get('v{i}', 0) for r in rows)\n\n"
           for i in range(20)]
        + ['if __name__ == "__main__":', "    print(total_0(load_rows(Path('a.jsonl'))))", ""]
    ).encode()
    corpus["markdown"] = "\n".join(
        ["# Document parsing", "", "A short guide to the **pipeline** and its stages.", ""]
        + [f"## Stage {i}\n\n- reads the page\n- writes `stage_{i}.json`\n\nSee "
           f"[the notes](notes/{i}.md) for details.\n" for i in range(15)]).encode()
    corpus["json"] = json.dumps({"pages": [{"index": i, "width": 1654, "height": 2339,
                                            "blocks": [{"type": "text", "bbox": [10, 20 * j, 400,
                                                        20 * j + 18]} for j in range(5)]}
                                           for i in range(12)]}, indent=2).encode()
    corpus["csv"] = ("id,name,price,quantity\n" + "".join(
        f"{i},item {i},{(i * 37) % 100}.{i % 10}9,{(i * 13) % 50}\n" for i in range(120))).encode()
    corpus["html"] = ("<!DOCTYPE html>\n<html>\n<head>\n<meta charset=\"utf-8\">\n<title>Report"
                      "</title>\n</head>\n<body>\n" + "".join(
                          f"<div class=\"section\"><h2>Section {i}</h2>\n<p>The table below lists "
                          f"the results.</p>\n<table><tr><td>{i}</td><td>{i * i}</td></tr></table>"
                          f"</div>\n" for i in range(20)) + "</body>\n</html>\n").encode()
    corpus["text"] = ("The committee met on Tuesday to review the annual budget. " * 3 + "\n"
                      + "".join(f"Item {i}: the members agreed to revisit the proposal next "
                                f"month, after the survey results are in.\n" for i in range(30))
                      ).encode()
    return corpus


def suffixless_bytes() -> bytes:
    """The OCR fixture's first page as a one-page PDF behind
    SUFFIXLESS_PREFIX."""
    from rapiddoc_tpu_torch.bench import build_pdf, page_images

    return SUFFIXLESS_PREFIX + build_pdf(page_images(asset("ocr_smoke_doc.pdf").read_bytes())[:1], 1)


def _f32(rng, shape, scale=None):
    import numpy as np

    x = rng.standard_normal(shape)
    return (x * scale if scale is not None else x).astype(np.float32)


def _rtdetr_graph(w):
    """tests/test_onnx_family_graphs.py's RT-DETR layout family graph (seed
    0): conv stem, pre-norm attention, exact-GELU FFN, TopK decode,
    cxcywh -> xyxy in original pixels, If-gated mask head."""
    import numpy as np

    rng = np.random.default_rng(0)
    h = wd = 32
    d, nq, nc, k = 8, 64, 3, 10
    img = rng.standard_normal((1, 3, h, wd)).astype(np.float32)
    names = ("stem_w", "stem_b", "ln1_s", "ln1_b", "w_qkv", "ln2_s", "ln2_b", "w_ff1", "w_ff2",
             "w_score", "w_box", "mask_w")
    shapes = ((d, 3, 4, 4), (d,), (d,), (d,), (d, d), (d,), (d,), (d, 2 * d), (2 * d, d),
              (d, nc), (d, 4), (1, d, 1, 1))
    scales = (0.3, None, None, None, 0.4, None, None, 0.4, 0.4, 0.5, 0.5, 0.5)
    inits = {n: _f32(rng, s, c) for n, s, c in zip(names, shapes, scales)}
    conv = {"strides": [1, 1], "pads": [0, 0, 0, 0], "dilations": [1, 1], "group": 1}
    then_g = w.SubGraph([
        w.encode_node("Conv", ["feat", "mask_w", "mask_b"], ["m0"], conv),
        w.encode_node("Resize", ["m0", "", "mask_scales"], ["m1"], {"mode": "nearest"}),
        w.encode_node("Sigmoid", ["m1"], ["masks_t"]),
    ], outputs={"masks_t": (1,)})
    else_g = w.SubGraph([
        w.encode_node("Conv", ["feat", "mask_w", "mask_b"], ["z0"], conv),
        w.encode_node("Resize", ["z0", "", "mask_scales"], ["z1"], {"mode": "nearest"}),
        w.encode_node("Mul", ["z1", "zero_f"], ["masks_e"]),
    ], outputs={"masks_e": (1,)})
    n = w.encode_node
    nodes = [
        n("Conv", ["image", "stem_w", "stem_b"], ["feat"], {**conv, "strides": [4, 4]}),
        n("Reshape", ["feat", "tok_shape"], ["tok0"]),
        n("Transpose", ["tok0", ], ["tok"], {"perm": [0, 2, 1]}),
        n("LayerNormalization", ["tok", "ln1_s", "ln1_b"], ["ln1"], {"axis": -1, "epsilon": 1e-5}),
        n("MatMul", ["ln1", "w_qkv"], ["q"]),
        n("Transpose", ["q"], ["qT"], {"perm": [0, 2, 1]}),
        n("MatMul", ["q", "qT"], ["att0"]),
        n("Mul", ["att0", "inv_sqrt_d"], ["att1"]),
        n("Softmax", ["att1"], ["att"], {"axis": -1}),
        n("MatMul", ["att", "q"], ["attn_out"]),
        n("Add", ["tok", "attn_out"], ["x1"]),
        n("LayerNormalization", ["x1", "ln2_s", "ln2_b"], ["ln2"], {"axis": -1, "epsilon": 1e-5}),
        n("MatMul", ["ln2", "w_ff1"], ["ff0"]),
        n("Gelu", ["ff0"], ["ff1"]),
        n("MatMul", ["ff1", "w_ff2"], ["ff2"]),
        n("Add", ["x1", "ff2"], ["x2"]),
        n("MatMul", ["x2", "w_score"], ["logits"]),
        n("Sigmoid", ["logits"], ["probs"]),
        n("MatMul", ["x2", "w_box"], ["box_raw"]),
        n("Sigmoid", ["box_raw"], ["box_n"]),
        n("ReduceMax", ["probs"], ["qscore"], {"axes": [-1], "keepdims": 0}),
        n("ArgMax", ["probs"], ["qlabel"], {"axis": -1, "keepdims": 0}),
        n("TopK", ["qscore", "k_const"], ["top_s", "top_i"], {"axis": -1, "largest": 1, "sorted": 1}),
        n("Gather", ["box_n", "top_i"], ["top_box_b"], {"axis": 1}),
        n("Reshape", ["top_box_b", "box_k_shape"], ["top_box"]),
        n("Gather", ["qlabel", "top_i"], ["top_l_b"], {"axis": 1}),
        n("Div", ["im_shape", "scale_factor"], ["orig_hw"]),
        n("Split", ["top_box"], ["cx", "cy", "bw", "bh"], {"axis": -1, "num_outputs": 4}),
        n("Mul", ["bw", "half"], ["bw2"]),
        n("Mul", ["bh", "half"], ["bh2"]),
        n("Sub", ["cx", "bw2"], ["x0n"]),
        n("Sub", ["cy", "bh2"], ["y0n"]),
        n("Add", ["cx", "bw2"], ["x1n"]),
        n("Add", ["cy", "bh2"], ["y1n"]),
        n("Concat", ["x0n", "y0n", "x1n", "y1n"], ["xyxy_n"], {"axis": -1}),
        n("Split", ["orig_hw", ], ["oh", "ow"], {"axis": -1, "num_outputs": 2}),
        n("Concat", ["ow", "oh", "ow", "oh"], ["whwh"], {"axis": -1}),
        n("Mul", ["xyxy_n", "whwh"], ["xyxy"]),
        n("Cast", ["top_l_b", ], ["top_l_f"], {"to": 1}),
        n("Reshape", ["top_l_f", "col_shape"], ["lab_col"]),
        n("Reshape", ["top_s", "col_shape"], ["s_col"]),
        n("Concat", ["lab_col", "s_col", "xyxy"], ["dets"], {"axis": -1}),
        n("If", ["use_mask"], ["masks"], {"then_branch": then_g, "else_branch": else_g}),
    ]
    inits.update({
        "mask_b": np.zeros((1,), np.float32),
        "tok_shape": np.asarray([1, d, nq], np.int64),
        "inv_sqrt_d": np.asarray(1.0 / np.sqrt(d), np.float32),
        "k_const": np.asarray([k], np.int64),
        "half": np.asarray([0.5], np.float32),
        "box_k_shape": np.asarray([k, 4], np.int64),
        "col_shape": np.asarray([k, 1], np.int64),
        "mask_scales": np.asarray([1, 1, 4, 4], np.float32),
        "zero_f": np.asarray(0.0, np.float32),
    })
    order = ("stem_w", "stem_b", "ln1_s", "ln1_b", "w_qkv", "ln2_s", "ln2_b", "w_ff1", "w_ff2",
             "w_score", "w_box", "mask_w", "mask_b", "tok_shape", "inv_sqrt_d", "k_const", "half",
             "box_k_shape", "col_shape", "mask_scales", "zero_f")
    data = w.build_model(
        nodes, {"image": img.shape, "im_shape": (1, 2), "scale_factor": (1, 2), "use_mask": ()},
        {"dets": (1,), "masks": (1,)}, {k_: inits[k_] for k_ in order}, input_dtypes={"use_mask": 9})
    feeds = [img, np.asarray([[h, wd]], np.float32), np.asarray([[0.5, 0.5]], np.float32)]
    return {"rtdetr_mask": (data, feeds + [np.asarray(True)]),
            "rtdetr_nomask": (data, feeds + [np.asarray(False)])}


def _formula_graph(w, seed: int):
    """The FormulaNet-style greedy AR decode Loop (tests/test_onnx_family_
    graphs.py, seeds 3, 7 and 11): embedding Gather, attention over a
    fixed memory, ArgMax, EOS exit, the token stream as a scan output."""
    import numpy as np

    rng = np.random.default_rng(seed)
    v, d, s = 12, 8, 5
    emb, w_q, mem, w_out = (rng.standard_normal(sh).astype(np.float32)
                            for sh in ((v, d), (d, d), (s, d), (d, v)))
    n = w.encode_node
    body = w.SubGraph([
        n("Gather", ["emb", "cur"], ["e"], {"axis": 0}),
        n("MatMul", ["e", "w_q"], ["q"]),
        n("MatMul", ["q", "memT"], ["scores"]),
        n("Softmax", ["scores"], ["alpha"], {"axis": -1}),
        n("MatMul", ["alpha", "mem"], ["ctx"]),
        n("MatMul", ["ctx", "w_out"], ["logits"]),
        n("ArgMax", ["logits"], ["nxt"], {"axis": -1, "keepdims": 0}),
        n("Equal", ["nxt", "eos"], ["is_eos"]),
        n("Not", ["is_eos"], ["cout"]),
        n("Identity", ["nxt"], ["scan_tok"]),
    ], inputs={"it": (), "cin": (), "cur": ()}, outputs={"cout": (), "nxt": (), "scan_tok": ()},
        initializers={"emb": emb, "w_q": w_q, "mem": mem, "memT": np.ascontiguousarray(mem.T),
                      "w_out": w_out, "eos": np.asarray(1, np.int64),
                      "ax0": np.asarray([0], np.int64)},
        input_dtypes={"it": 7, "cin": 9, "cur": 7})
    data = w.build_model([n("Loop", ["m", "c0", "bos"], ["last", "toks"], {"body": body})],
                         {"bos": ()}, {"last": (1,), "toks": (1,)},
                         {"m": np.asarray(9, np.int64), "c0": np.asarray(True)},
                         input_dtypes={"bos": 7})
    return data, [np.asarray(0, np.int64)]


def _unet_graph(w):
    """The UNET wired-table family graph (seed 5): conv -> pool encoder,
    nearest Resize, skip Concat, 1x1 head, channel Softmax."""
    import numpy as np

    rng = np.random.default_rng(5)
    x = rng.standard_normal((1, 3, 16, 16)).astype(np.float32)
    shapes = {"w1": ((4, 3, 3, 3), 0.4), "b1": ((4,), None), "w2": ((8, 4, 3, 3), 0.4),
              "b2": ((8,), None), "w3": ((2, 12, 1, 1), 0.4), "b3": ((2,), None)}
    inits = {k: _f32(rng, s, c) for k, (s, c) in shapes.items()}
    inits["up_scales"] = np.asarray([1, 1, 2, 2], np.float32)
    def conv(pad):
        return {"strides": [1, 1], "pads": [pad] * 4, "dilations": [1, 1], "group": 1}

    n = w.encode_node
    nodes = [
        n("Conv", ["x", "w1", "b1"], ["c1"], conv(1)),
        n("Relu", ["c1"], ["r1"]),
        n("MaxPool", ["r1"], ["p1"], {"kernel_shape": [2, 2], "strides": [2, 2], "pads": [0, 0, 0, 0]}),
        n("Conv", ["p1", "w2", "b2"], ["c2"], conv(1)),
        n("Relu", ["c2"], ["r2"]),
        n("Resize", ["r2", "", "up_scales"], ["u2"], {"mode": "nearest"}),
        n("Concat", ["r1", "u2"], ["cat"], {"axis": 1}),
        n("Conv", ["cat", "w3", "b3"], ["head"], conv(0)),
        n("Softmax", ["head"], ["prob"], {"axis": 1}),
    ]
    return w.build_model(nodes, {"x": x.shape}, {"prob": (1,)}, inits), [x]


def _slanet_graph(w, seed: int):
    """The SLANet-style GRU-attention decode Loop (seeds 2 and 9): carried
    hidden state and token, twin scan outputs (tokens, 8-coord boxes)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    s, c, hd, v = 6, 4, 8, 10
    names = ("fea", "w_k", "w_h", "v_a", "emb", "w_x", "w_hh", "w_o", "w_b")
    shapes = ((s, c), (c, hd), (hd, hd), (hd, 1), (v, hd), (c + hd, hd), (hd, hd), (hd, v), (hd, 8))
    inits = {k: rng.standard_normal(sh).astype(np.float32) for k, sh in zip(names, shapes)}
    n = w.encode_node
    body = w.SubGraph([
        n("MatMul", ["fea", "w_k"], ["fk"]),
        n("MatMul", ["h", "w_h"], ["hk"]),
        n("Add", ["fk", "hk"], ["pre"]),
        n("Tanh", ["pre"], ["t"]),
        n("MatMul", ["t", "v_a"], ["score"]),
        n("Softmax", ["score"], ["alpha"], {"axis": 0}),
        n("Mul", ["alpha", "fea"], ["weighted"]),
        n("ReduceSum", ["weighted"], ["ctx"], {"axes": [0], "keepdims": 1}),
        n("Gather", ["emb", "cur"], ["e0"], {"axis": 0}),
        n("Unsqueeze", ["e0", "ax0"], ["e"]),
        n("Concat", ["ctx", "e"], ["xcat"], {"axis": -1}),
        n("MatMul", ["xcat", "w_x"], ["xp"]),
        n("MatMul", ["h", "w_hh"], ["hp"]),
        n("Add", ["xp", "hp"], ["hpre"]),
        n("Tanh", ["hpre"], ["h2"]),
        n("MatMul", ["h2", "w_o"], ["logits"]),
        n("MatMul", ["h2", "w_b"], ["braw"]),
        n("Sigmoid", ["braw"], ["box2"]),
        n("ArgMax", ["logits"], ["nxt0"], {"axis": -1, "keepdims": 0}),
        n("Squeeze", ["nxt0", "ax0"], ["nxt"]),
        n("Equal", ["nxt", "eos"], ["is_eos"]),
        n("Not", ["is_eos"], ["cout"]),
        n("Identity", ["nxt"], ["scan_tok"]),
        n("Squeeze", ["box2", "ax0"], ["scan_box"]),
    ], inputs={"it": (), "cin": (), "h": (1, hd), "cur": ()},
        outputs={"cout": (), "h2": (1,), "nxt": (), "scan_tok": (), "scan_box": (1,)},
        initializers={**inits, "eos": np.asarray(1, np.int64), "ax0": np.asarray([0], np.int64)},
        input_dtypes={"it": 7, "cin": 9, "cur": 7})
    data = w.build_model(
        [n("Loop", ["m", "c0", "h0", "sos"], ["hf", "tok_last", "toks", "boxes"], {"body": body})],
        {"h0": (1, hd), "sos": ()}, {"hf": (1,), "tok_last": (1,), "toks": (1,), "boxes": (1,)},
        {"m": np.asarray(8, np.int64), "c0": np.asarray(True)}, input_dtypes={"sos": 7})
    return data, [np.zeros((1, hd), np.float32), np.asarray(0, np.int64)]


def tied_const_graph(w, out_specs: dict, consts: dict, in_shape, metadata=None) -> bytes:
    """tests/test_registry_assets.py's graph whose constant outputs are
    tied to the input (ReduceMean(x) * 0 added), so nothing folds."""
    import numpy as np

    nodes = [w.encode_node("ReduceMean", ["x"], ["m"], {"keepdims": 0}),
             w.encode_node("Mul", ["m", "zero"], ["z"])]
    inits = {"zero": np.asarray(0.0, np.float32)}
    for out_name, arr in consts.items():
        nodes.append(w.encode_node("Add", [f"{out_name}_c", "z"], [out_name]))
        inits[f"{out_name}_c"] = arr
    data = w.build_model(nodes, {"x": in_shape}, out_specs, inits)
    return w.build_model_with_metadata(data, metadata) if metadata else data


def wired_class_map():
    """The wired-table contract's 1024 x 1024 class map: a 3 x 3 line
    lattice (horizontal lines 1, vertical 2)."""
    import numpy as np

    pred = np.zeros((1, 1024, 1024), np.int64)
    for y in (64, 480, 960):
        pred[0, y - 3: y + 3, 64:960] = 1
    for x in (64, 512, 960):
        pred[0, 64:960, x - 3: x + 3] = 2
    return pred


def onnx_contract_graphs() -> dict:
    """name -> (graph bytes written by the port's writer, feeds): the four
    family graphs of tests/test_onnx_family_graphs.py with their seeds,
    and the wired-table contract at its published 1024 x 1024 input."""
    import numpy as np

    from rapiddoc_tpu_torch.tools import onnx_writer as w

    graphs = dict(_rtdetr_graph(w))
    for seed in (3, 7, 11):
        graphs[f"formula_ar_{seed}"] = _formula_graph(w, seed)
    graphs["unet"] = _unet_graph(w)
    for seed in (2, 9):
        graphs[f"slanet_{seed}"] = _slanet_graph(w, seed)
    x = np.random.default_rng(1).integers(0, 256, (1, 3, 1024, 1024)).astype(np.float32)
    graphs["wired_table_1024"] = (tied_const_graph(
        w, {"y": (1, 1024, 1024)}, {"y": wired_class_map().astype(np.float32)}, x.shape), [x])
    return graphs


def encode_array(a) -> dict:
    """An output for the golden: dtype, shape, and the values (the sha256
    of the bytes for an array of more than 4096 values)."""
    import hashlib

    import numpy as np

    a = np.ascontiguousarray(a)
    out = {"dtype": str(a.dtype), "shape": list(a.shape)}
    if a.size > 4096:
        out["sha256"] = hashlib.sha256(a.tobytes()).hexdigest()
    else:
        out["data"] = a.tolist()
    return out


def decode_array(d: dict):
    """The array behind an encoded output that keeps its values."""
    import numpy as np

    return np.asarray(d["data"], d["dtype"]).reshape(d["shape"])


def check_graph_outputs(name: str, got: list, want: list) -> None:
    """Graph outputs against the golden's: dtypes and shapes equal,
    integer and bool outputs equal, floats within GRAPH_ATOL/RTOL, the
    RT-DETR dets' labels equal and boxes within GRAPH_DET_TOL px; an
    output kept as a sha256 equal byte for byte."""
    import hashlib

    import numpy as np

    check(len(got) == len(want), f"onnx {name}: {len(got)} outputs, golden {len(want)}")
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.ascontiguousarray(g)
        check(str(g.dtype) == w["dtype"] and list(g.shape) == w["shape"],
              f"onnx {name} output {i}: {g.dtype} {list(g.shape)}, golden {w['dtype']} {w['shape']}")
        if "sha256" in w:
            check(hashlib.sha256(g.tobytes()).hexdigest() == w["sha256"],
                  f"onnx {name} output {i}: differs from the golden's")
            continue
        ref = decode_array(w)
        if np.issubdtype(ref.dtype, np.floating):
            check(bool(np.allclose(g, ref, atol=GRAPH_ATOL, rtol=GRAPH_RTOL)),
                  f"onnx {name} output {i}: {float(np.abs(g - ref).max()):.3g} off the golden")
        else:
            check(np.array_equal(g, ref), f"onnx {name} output {i}: differs from the golden's")
        if name.startswith("rtdetr") and i == 0:
            check(np.array_equal(g[:, 0], ref[:, 0]), f"onnx {name}: det labels differ")
            err = float(np.abs(g[:, 2:] - ref[:, 2:]).max())
            check(err <= GRAPH_DET_TOL, f"onnx {name}: a det box is {err:.3g} px off")


def onnx_layout_dets() -> list[dict]:
    """The layout fixture's golden (fp32) layout dets of ONNX_LAYOUT_PAGE."""
    golden = json.loads(asset("layout_smoke_golden.json").read_text())
    return [d for d in golden["fp32"]["model_info"][ONNX_LAYOUT_PAGE]["layout_dets"]
            if "original_label" in d]


def write_onnx_layout(models_dir: Path) -> None:
    """A pp_doclayoutv3.onnx with the V3 contract (image and scale_factor
    in; boxes (N, 6) [class, score, x0, y0, x1, y1] in page pixels,
    box_nums and masks out) emitting onnx_layout_dets(), tied to the
    input as tests/test_registry_assets.py's layout contract is."""
    import numpy as np

    from rapiddoc_tpu_torch.models.layout.onnx_engine import PP_DOCLAYOUT_V2_LABELS
    from rapiddoc_tpu_torch.tools import onnx_writer as w

    dets = onnx_layout_dets()
    boxes = np.asarray([[PP_DOCLAYOUT_V2_LABELS.index(d["original_label"]), d["score"],
                         d["poly"][0], d["poly"][1], d["poly"][4], d["poly"][5]]
                        for d in dets], np.float32)
    n = len(dets)
    nodes = [
        w.encode_node("ReduceMean", ["image"], ["m"], {"keepdims": 0}),
        w.encode_node("Mul", ["m", "zero"], ["z"]),
        w.encode_node("Add", ["boxes_c", "z"], ["boxes"]),
        w.encode_node("Add", ["masks_c", "z"], ["masks"]),
        w.encode_node("Identity", ["nums_c"], ["box_nums"]),
    ]
    data = w.build_model(
        nodes, {"image": (1, 3, 800, 800), "scale_factor": (1, 2)},
        {"boxes": (n, 6), "box_nums": (1,), "masks": (n, 50, 50)},
        {"boxes_c": boxes, "masks_c": np.zeros((n, 50, 50), np.float32),
         "nums_c": np.asarray([n], np.int32), "zero": np.asarray(0.0, np.float32)})
    (Path(models_dir) / "pp_doclayoutv3.onnx").write_bytes(data)


def onnx_layout_pdf() -> bytes:
    """The layout fixture's ONNX_LAYOUT_PAGE as a one-page PDF."""
    from rapiddoc_tpu_torch.bench import build_pdf, page_images

    return build_pdf(page_images(asset("layout_smoke_doc.pdf").read_bytes())
                     [ONNX_LAYOUT_PAGE:ONNX_LAYOUT_PAGE + 1], 1)


# The codec fixture's bf16 "ocr" parse against the JAX package's bf16
# golden (tests/test_torch_codecs.py holds the generator of the fixture
# and golden). The port's bf16 on the CPU: 52/67 lines equal (0.776), CER
# 0.0131; the JAX package's own fp32 against its bf16: 57/67 (0.851), CER
# 0.0206 (python tests/test_torch_codecs.py --compare). The margin for the
# card's summation order: 0.126 of lines (8 lines) and 0.037 of CER.
CODECS_BF16 = {"min_exact_share": 0.65, "max_cer": 0.05}
CODEC_BAND_ROWS = 400  # rows of the pages the plain bilevel decoders run


def phase_codecs(card: str) -> int:
    """Scanned and born-digital codecs (tests/test_torch_codecs.py holds
    the generator of the fixture and golden): the compiled JBIG2 and T.6
    loops (csrc/bilevel.cu) against the plain ones on the first
    CODEC_BAND_ROWS rows of the 300 dpi pages and of the fixture's
    text-region page (its symbol dictionary and text region whole: the
    integer and symbol-ID loops), and the compiled
    progressive and CMYK entropy decode against the plain one on the
    fixture's JPEGs; the full 300 dpi pages decoded compiled with their
    sha256 equal to the JAX package's, ms per page of each decoder on the
    card's host; the fixture's pages rendered at 200 and 72 dpi equal to
    the golden's; RapidDoc(device="cuda") in fp32 (TF32 off), "ocr" on the
    fixture and "auto" on its vector page, equal to the golden; the bf16
    "ocr" parse timed, K1's launches held to the rec dispatches, its
    Markdown within CODECS_BF16. Returns K1's launches."""
    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio import ccitt, jbig2, jpeg, open_pdf, render_page_full

    t_phase = time.perf_counter()
    golden = json.loads(asset("codec_smoke_golden.json").read_text())
    pdf = asset("codec_smoke_doc.pdf").read_bytes()
    vector = asset("codec_smoke_vector.pdf").read_bytes()
    with np.load(asset("codec_smoke_streams.npz")) as z:
        generic, g4 = z["jbig2_generic_300"].tobytes(), z["g4_300"].tobytes()

    # the 300 dpi pages: compiled in full, plain on a band
    t0 = time.perf_counter()
    bitmap = jbig2.decode(generic, None, 2550, 3300, compiled=True)
    jbig2_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    band = jbig2.decode(generic, None, 2550, 3300, compiled=False, max_rows=CODEC_BAND_ROWS)
    jbig2_band_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(band, bitmap[:CODEC_BAND_ROWS]),
          "codecs: the compiled JBIG2 generic region differs from the plain one")
    check(sha256(((1 - bitmap) * 255).astype(np.uint8)) == golden["bitmaps"]["jbig2_generic_300"],
          "codecs: the 300 dpi JBIG2 page differs from the JAX package's")
    t0 = time.perf_counter()
    bits, rows = ccitt.decode_bits_compiled(g4, 2550, 3300, -1)
    g4_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    band, _ = ccitt.decode_bits_plain(g4, 2550, CODEC_BAND_ROWS, -1)
    g4_band_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(band, bits[:CODEC_BAND_ROWS]),
          "codecs: the compiled T.6 decoder differs from the plain one")
    check(rows == 3300 and sha256(ccitt.to_l(bits, False)) == golden["bitmaps"]["g4_300"],
          "codecs: the 300 dpi G4 page differs from the JAX package's")

    # the fixture's streams: its JBIG2 text page and its two JPEGs
    doc = open_pdf(pdf)
    jpegs, text_pages = {}, []
    for i in range(len(doc)):
        page = doc.get_page(i)
        xobjs = doc.resolve(page.resources.get("XObject")) or {}
        for name, ref in xobjs.items():
            st = doc.resolve(ref)
            kind = doc.resolve(st.dict.get("Filter"))
            if kind == "DCTDecode":
                jpegs[f"page{i}_{name}"] = doc.stream_bytes(st)
            elif kind == "JBIG2Decode":
                parms = doc.resolve(st.dict.get("DecodeParms")) or {}
                text_pages.append((doc.stream_bytes(st),
                                   doc.stream_bytes(doc.resolve(parms["JBIG2Globals"])),
                                   int(st.dict["Width"]), int(st.dict["Height"])))
    check(len(jpegs) == 2, f"codecs: {len(jpegs)} JPEG streams in the fixture, not 2")
    check(len(text_pages) == 1, f"codecs: {len(text_pages)} JBIG2 streams in the fixture, not 1")
    t0 = time.perf_counter()
    text = jbig2.decode(*text_pages[0], compiled=True)
    text_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    band = jbig2.decode(*text_pages[0], compiled=False, max_rows=CODEC_BAND_ROWS)
    text_band_plain_ms = (time.perf_counter() - t0) * 1e3
    check(np.array_equal(band, text[:CODEC_BAND_ROWS]),
          "codecs: the compiled JBIG2 text-region loops differ from the plain ones")
    emit({"phase": "codecs", "path": "bilevel", "card": card,
          "jbig2_generic_compiled_ms_per_page": jbig2_ms, "g4_compiled_ms_per_page": g4_ms,
          "jbig2_text_200dpi_compiled_ms_per_page": text_ms,
          "band_rows": CODEC_BAND_ROWS, "jbig2_band_plain_ms": jbig2_band_plain_ms,
          "g4_band_plain_ms": g4_band_plain_ms, "jbig2_text_band_plain_ms": text_band_plain_ms,
          "equal_to_plain": True, "equal_to_jax": True})

    # the fixture's JPEGs: progressive 4:2:0 and CMYK, both entropy decoders
    jpeg_ms = {}
    for name, data in jpegs.items():
        stream = jpeg.parse_jpeg(data)
        t0 = time.perf_counter()
        plain = jpeg.decode_coefficients_plain(stream)
        plain_ms = (time.perf_counter() - t0) * 1e3
        compiled = jpeg.decode_coefficients_compiled(stream)
        check(np.array_equal(plain, compiled),
              f"codecs: the compiled entropy decode of {name} differs from the plain one")
        jpeg_ms[name] = {"progressive": stream.progressive, "colorspace": stream.colorspace,
                         "entropy_plain_ms": plain_ms,
                         "entropy_compiled_ms": host_ms(
                             lambda: jpeg.decode_coefficients_compiled(stream), 5),
                         "decode_ms": host_ms(lambda: jpeg.decode_jpeg(data), 3)}
    emit({"phase": "codecs", "path": "jpeg", "card": card, "streams": jpeg_ms,
          "coefficients_equal": True})

    # the rasters
    render_ms = {}
    for dpi in ("200", "72"):
        times = []
        for path_pdf, key in ((pdf, "pages"), (vector, "vector_pages")):
            rdoc = open_pdf(path_pdf)
            for i, want in enumerate(golden[key][dpi]):
                t0 = time.perf_counter()
                img = render_page_full(rdoc.get_page(i), dpi=int(dpi), with_text=False)[0]
                times.append(time.perf_counter() - t0)
                check(sha256(img) == want, f"codecs: {key} {i} at {dpi} dpi differs from the golden's")
        render_ms[dpi] = {"mean": 1e3 * sum(times) / len(times), "max": 1e3 * max(times)}
    emit({"phase": "codecs", "path": "render", "card": card, "pages_equal": True,
          "render_ms_per_page": render_ms})

    # the parses: fp32 equal to the golden, bf16 timed and counted
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    parse_env = {"RAPIDDOC_DISABLE_LAYOUT": "1", "RAPIDDOC_DISABLE_FORMULA": "1",
                 "RAPIDDOC_DISABLE_TABLE": "1"}
    clean_env(**parse_env)
    rapid = RapidDoc(device="cuda", dtype=torch.float32)
    for data, method, key in ((pdf, "ocr", "ocr_fp32"), (vector, "auto", "auto_fp32")):
        out = rapid(data, parse_method=method)
        check(out.markdown == golden[key]["markdown"],
              f"codecs: the fp32 {method} Markdown differs from the golden's")
        check(out.content_list_json == golden[key]["content_list"],
              f"codecs: the fp32 {method} content list differs from the golden's")
    rapid = RapidDoc(device="cuda")
    rapid(pdf, parse_method="ocr")  # warm-up
    torch.cuda.synchronize()
    with LaunchCount(rapid._stack().analyzer.ocr.recognizer) as counted:
        t0 = time.perf_counter()
        out = rapid(pdf, parse_method="ocr")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = counted.check("codecs bf16")
    vs = compare_markdown(out.markdown, golden["ocr_bf16"]["markdown"])
    emit({"phase": "codecs", "path": "parse", "card": card, "fp32_equal": True,
          "bf16_pages_per_s": len(out.model_json) / wall, "launches": counts,
          "vs_golden_bf16": vs, "phase_seconds": time.perf_counter() - t_phase})
    check(vs["exact_share"] >= CODECS_BF16["min_exact_share"],
          f"codecs bf16: only {vs['exact_share']:.3f} of lines equal")
    check(vs["cer"] <= CODECS_BF16["max_cer"], f"codecs bf16: CER {vs['cer']:.4f}")
    clean_env()
    return counts["ctc_head"]


def phase_onnx(card: str) -> dict:
    """The ONNX interpreter on the card, fp32 with TF32 off: Magika over
    magika_corpus() (labels equal to the JAX package's golden, scores
    within MAGIKA_SCORE_TOL, ms a call at batch 1); the contract graphs
    written by the port's writer (outputs held to the golden by
    check_graph_outputs, ms each) and the wired-table contract through
    OnnxWiredTableStructure (cells and grid equal); RapidDoc with a
    pp_doclayoutv3.onnx in a temporary models dir on the layout fixture's
    page (Markdown and content list equal to the JAX package's with the
    same models dir, K1's launches held to the rec dispatches); RapidDoc
    on suffix-less bytes (the sniff label and the Markdown equal to the
    JAX package's). Returns K1's launches."""
    import tempfile

    import numpy as np
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.engine.onnx_torch import OnnxTorchFunction
    from rapiddoc_tpu_torch.models.table.onnx_models import OnnxWiredTableStructure
    from rapiddoc_tpu_torch.utils import sniff

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    golden = json.loads(asset("onnx_smoke_golden.json").read_text())
    parses = json.loads(asset("onnx_parse_golden.json").read_text())
    clean_env()

    corpus = magika_corpus()
    check(set(corpus) == set(golden["magika"]), "onnx: the Magika corpus differs from the golden's")
    worst = 0.0
    for name, data in corpus.items():
        label, score = sniff.magika_classify(data, device="cuda")
        want = golden["magika"][name]
        check(label == want["label"], f"onnx: Magika calls {name} {label}, golden {want['label']}")
        worst = max(worst, abs(score - want["score"]))
    check(worst <= MAGIKA_SCORE_TOL, f"onnx: a Magika score is {worst:.3g} off the golden's")
    fn = sniff.load_magika("cuda")[0]
    feats = sniff.magika_features(corpus["python"])
    magika_ms = cuda_ms(lambda: fn(feats), iters=ONNX_TIMED_RUNS)
    emit({"phase": "onnx", "path": "magika", "card": card, "inputs": len(corpus),
          "labels_equal": True, "max_score_err": worst, "ms_per_call_batch1": magika_ms})

    graph_ms = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, (data, feeds) in onnx_contract_graphs().items():
            path = Path(tmp) / f"{name}.onnx"
            path.write_bytes(data)
            gfn = OnnxTorchFunction.from_file(path, device="cuda")
            check_graph_outputs(name, gfn(*feeds), golden["graphs"][name])
            graph_ms[name] = cuda_ms(lambda: gfn(*feeds), iters=ONNX_TIMED_RUNS)
        wired = OnnxWiredTableStructure(Path(tmp) / "wired_table_1024.onnx", device="cuda")
        page = np.full((512, 512, 3), 255, np.uint8)
        cells, grid = wired.batch([page])[0]
        check(json.loads(json.dumps([cells, grid])) == golden["wired_structure"],
              "onnx: the wired-table contract's cells differ from the golden's")
        wired_ms = cuda_ms(lambda: wired.batch([page]), iters=3, warmup=1)
    emit({"phase": "onnx", "path": "graphs", "card": card, "outputs_equal": True,
          "ms": graph_ms, "wired_structure_ms": wired_ms, "wired_cells": len(cells)})

    with tempfile.TemporaryDirectory() as models:
        write_onnx_layout(Path(models))
        clean_env(RAPIDDOC_MODELS_DIR=models, RAPIDDOC_DISABLE_FORMULA="1",
                  RAPIDDOC_DISABLE_TABLE="1")
        rapid = RapidDoc(device="cuda", dtype=torch.float32)
        pdf = onnx_layout_pdf()
        rapid(pdf, parse_method="ocr")  # warm-up
        analyzer = rapid._stack().analyzer
        check(type(analyzer.layout_model).__name__ == "OnnxLayoutDetector",
              "onnx: the models dir's pp_doclayoutv3.onnx did not build the ONNX layout")
        torch.cuda.synchronize()
        with LaunchCount(analyzer.ocr.recognizer) as counted:
            t0 = time.perf_counter()
            out = rapid(pdf, parse_method="ocr")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = counted.check("onnx layout")
        want = parses["onnx_layout"]
        check(out.markdown == want["markdown"], "onnx: the ONNX-layout Markdown differs from the golden's")
        check(out.content_list_json == want["content_list"],
              "onnx: the ONNX-layout content list differs from the golden's")
    emit({"phase": "onnx", "path": "onnx_layout", "dtype": "fp32", "card": card,
          "dets": len(onnx_layout_dets()), "parse_s": wall, "launches": counts,
          "markdown_equal": True, "content_list_equal": True})

    clean_env(RAPIDDOC_DISABLE_LAYOUT="1", RAPIDDOC_DISABLE_FORMULA="1", RAPIDDOC_DISABLE_TABLE="1")
    data = suffixless_bytes()
    want = parses["suffixless"]
    label = sniff.guess_suffix_by_bytes(data, device="cuda")
    check(label == want["suffix"], f"onnx: the suffix-less bytes sniff as {label!r}, "
                                   f"golden {want['suffix']!r}")
    out = RapidDoc(device="cuda", dtype=torch.float32)(data, parse_method="ocr")
    check(out.markdown == want["markdown"], "onnx: the suffix-less parse's Markdown differs")
    emit({"phase": "onnx", "path": "suffixless", "dtype": "fp32", "card": card,
          "prefix": SUFFIXLESS_PREFIX.decode("latin-1"), "suffix": label, "markdown_equal": True})
    clean_env()
    return counts["ctc_head"]


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: {exc}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    try:
        import rapiddoc_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable here ({exc})", file=sys.stderr)
        return 2
    seconds: dict[str, float] = {}
    t_all = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        return out

    try:
        card = timed("card", phase_card)
        timed("build", phase_build)
        k1_all = timed("ctc_head", phase_ctc_head)
        ocr_launches = timed("ocr", phase_ocr)
        golden = pipeline_golden()
        timed("jpeg", phase_jpeg, golden)
        launches = timed("pipeline", phase_pipeline, golden, card)
        k2_all = timed("quant_head", phase_quant_head)
        k2_launches = timed("formula", phase_formula)
        timed("formula_published", phase_formula_published)
        lgolden = layout_golden()
        timed("layout", phase_layout, lgolden, card)
        layout_counts = timed("pipeline_layout", phase_pipeline_layout, lgolden, card)
        timed("table", phase_table, card)
        timed("pipeline_table", phase_pipeline_table)
        counts = timed("main_path", main_path, card)
        family = timed("ocr_family", phase_ocr_family, card)
        table_ocr = timed("table_ocr", phase_table_ocr, card)
        orientation = timed("orientation", phase_orientation, card)
        seal_counts = timed("seal", phase_seal, card)
        image_counts = timed("image_inputs", phase_image_inputs, card)
        vector_counts = timed("vector", phase_vector, card)
        text_counts = timed("text", phase_text, card)
        onnx_launches = timed("onnx", phase_onnx, card)
        codec_launches = timed("codecs", phase_codecs, card)
        timed("office", phase_office, card)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    emit({"phase": "timing", "seconds_by_phase": seconds,
          "total_seconds": time.perf_counter() - t_all})
    k1 = k1_all[VOCABS[0]]
    k2 = k2_all[(QUANT_ROWS[-1], QUANT_VOCABS[-1])]

    def shapes(results):
        keys = ("kernel_ms", "back_to_back_ms", "plain_ms", "library_ms", "bound_ms",
                "bound_by", "max_rel_err", "n_ranges", "n_blocks")
        return [{"shape": [r["n"], r.get("c", r.get("k")), r["v"]],
                 **{key: r[key] for key in keys if key in r}} for r in results.values()]

    emit({"kernels": [{
        "name": "ctc_head", "route": "cuda",
        "source": "rapiddoc_tpu_torch/csrc/ctc_head.cu",
        "replaces": "rapiddoc_tpu/ops/ctc_head.py:30",
        # launches: the table-on pipeline's bf16 run (this slice's main
        # path), beside the earlier paths' runs
        "launches": counts["ctc_head"],
        "launches_by_path": {"main_path": counts["ctc_head"],
                             "pipeline_layout": layout_counts["ctc_head"], "pipeline": launches,
                             "ocr": ocr_launches,
                             **{f"ocr_family_{k}": v for k, v in family.items()},
                             **table_ocr, **orientation, **seal_counts,
                             "image_inputs": image_counts["ctc_head"],
                             "image_files": image_counts["image_files"],
                             "vector": vector_counts["ctc_head"],
                             "text": text_counts["ctc_head"], "onnx": onnx_launches,
                             "codecs": codec_launches},
        "max_abs_err": k1["max_abs_err"],
        "max_rel_err": k1["max_rel_err"], "matches_plain": True,
        "ms": k1["kernel_ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
        "library_ms": k1["library_ms"], "shape": [k1["n"], k1["c"], k1["v"]],
        "shapes": shapes(k1_all),
    }, {
        # launches: the table-on pipeline's bf16 int8-head run (this
        # slice's main path), beside the earlier paths'; times at the
        # published width, L2 flushed before each launch
        "name": "quant_head", "route": "cuda",
        "source": "rapiddoc_tpu_torch/csrc/quant_head.cu",
        "replaces": "rapiddoc_tpu/ops/quant_head.py:50",
        "launches": counts["quant_head"],
        "launches_by_path": {"main_path": counts["quant_head"],
                             "pipeline_layout": layout_counts["quant_head"],
                             "formula": k2_launches,
                             "image_inputs": image_counts["quant_head"],
                             "vector": vector_counts["quant_head"],
                             "text": text_counts["quant_head"]},
        "max_abs_err": k2["max_abs_err"],
        "max_rel_err": k2["max_rel_err"], "matches_plain": True,
        "ms": k2["kernel_ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": k2["library_ms"], "shape": [k2["n"], k2["k"], k2["v"]],
        "shapes": shapes(k2_all),
    }]})
    print(card, flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
