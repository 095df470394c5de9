"""The port's bench (``rapiddoc_tpu_torch/bench.py``) against the root
``bench.py`` (the JAX bench): the CPU denominators' pages/s equal the root
bench's ``_bench_torch_reference`` and ``_bench_xla_cpu_reference`` on
the same ``WORKLOAD`` and ``PAGES`` (set on the imported root module,
nothing in it edited); the ``[workload]``, ``[overlap]`` and
``[variance]`` arithmetic equals the root bench's formulas on one fixed
stage report; a ``--device cpu --pages 2`` rehearsal prints every new key
and reports the card-only parts skipped."""
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from rapiddoc_tpu_torch import bench

from torch_threads import capped_threads

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jax_bench():
    """The root bench.py, imported with its hang watchdog off."""
    saved = os.environ.get("RAPIDDOC_BENCH_WATCHDOG")
    os.environ["RAPIDDOC_BENCH_WATCHDOG"] = "0"
    try:
        spec = importlib.util.spec_from_file_location("root_bench_for_tests", REPO / "bench.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        if saved is None:
            os.environ.pop("RAPIDDOC_BENCH_WATCHDOG")
        else:
            os.environ["RAPIDDOC_BENCH_WATCHDOG"] = saved
    return module


WORKLOADS = [
    {"rec_crops": 1291, "formula_regions": 252, "table_regions": 210},
    {"rec_crops": 45, "formula_regions": 0, "table_regions": 0},
    {"rec_crops": 0, "formula_regions": 7, "table_regions": 0},  # 0 crops: pages * 24
    {},
    None,
]


@pytest.mark.parametrize("pages", [56, 2, 17])
@pytest.mark.parametrize("workload", WORKLOADS, ids=["layout", "ocr", "no_crops", "empty",
                                                     "none"])
def test_cpu_denominators_equal_the_root_bench(jax_bench, monkeypatch, workload, pages):
    monkeypatch.setattr(jax_bench, "WORKLOAD", workload)
    monkeypatch.setattr(jax_bench, "PAGES", pages)
    want = jax_bench._bench_torch_reference()
    want_xla = jax_bench._bench_xla_cpu_reference()
    assert bench.cpu_reference_pps(workload, pages) == want
    assert bench.xla_cpu_reference_pps(workload, pages) == want_xla
    pps = 1.3378
    got = bench.baseline_report(pps, workload, pages)
    # bench.py main(): vs = round(pps / base_pps, 3), and the same for XLA
    assert got["vs_baseline"] == round(pps / want, 3)
    assert got["vs_baseline_xla_cpu"] == round(pps / want_xla, 3)
    assert got["baseline_kind"] == "torch-eager-cpu1"
    assert got["baseline_xla_cpu_kind"] == "xla-cpu-jit-fp32-cpu1"
    src = (REPO / "bench.py").read_text()
    assert " ".join(got["baseline_caveat"].split()[:8]) in " ".join(src.split())
    assert bench.baseline_report(pps, workload, pages, skip_torch=True)["vs_baseline"] is None


def test_an_absent_denominator_is_none(tmp_path):
    wl = WORKLOADS[0]
    assert bench.cpu_reference_pps(wl, 56, path=tmp_path / "BASELINE_CPU.json") is None
    assert bench.xla_cpu_reference_pps(wl, 56, path=tmp_path / "BASELINE_CPU_XLA.json") is None


# one fixed stage report of a timed pass (the tracer's), its pages and walls
REPORT = {
    "render": {"total_s": 12.5201, "items": 56}, "layout": {"total_s": 6.1234, "items": 56},
    "ocr_det": {"total_s": 8.2711, "items": 56}, "ocr_crop": {"total_s": 3.0522, "items": 56},
    "ocr_rec": {"total_s": 2.1673, "items": 56}, "ocr": {"total_s": 13.4906, "items": 56},
    "formula": {"total_s": 2.3688, "items": 252}, "table": {"total_s": 10.8251, "items": 210},
    "assembly": {"total_s": 4.9963, "items": 56},
    "assembly_final": {"total_s": 0.3128, "items": 56},
}
PAGES, WALLS, REC_CROPS = 56, [41.73, 37.12], 1291
REC_STATS = {"calls": 47, "items": 5164, "padded_items": 7040,
             "pad_overhead": 7040 / 5164 - 1.0}
CORPUS = {"formula_dense": 19, "table_heavy": 19, "synth_text": 18}


def test_workload_overlap_and_variance_equal_the_root_bench_formulas():
    rep = REPORT
    # bench.py:255-262 (WORKLOAD)
    want_workload = {
        "rec_crops": REC_CROPS,
        "formula_regions": rep.get("formula", {}).get("items", 0),
        "table_regions": rep.get("table", {}).get("items", 0),
    }
    # bench.py:226-231 (report = ms/page of every stage) and :306-340
    report = {k: v.get("total_s", 0.0) * 1000.0 / PAGES for k, v in rep.items()}
    host_stages = ("render", "ocr_crop", "assembly", "assembly_final")
    dev_stages = ("layout", "ocr_det", "ocr_rec", "formula", "table", "orientation")
    host_ms = sum(report.get(s, 0.0) for s in host_stages)
    dev_ms = sum(report.get(s, 0.0) for s in dev_stages)
    dt = WALLS[-1]
    e2e_ms = dt * 1e3 / PAGES
    want_overlap = {
        "host_path_ms_per_page": round(host_ms, 1),
        "device_path_ms_per_page": round(dev_ms, 1),
        "e2e_ms_per_page": round(e2e_ms, 1),
        "e2e_over_max_path": round(e2e_ms / max(host_ms, dev_ms, 1e-9), 3),
    }
    rec_wall_s = rep.get("ocr_rec", {}).get("total_s", 0.0)
    want_overlap["ocr_rec_detail"] = {
        "crops": want_workload["rec_crops"],
        "crops_per_sec": round(want_workload["rec_crops"] / rec_wall_s, 1)
        if rec_wall_s else None,
        "ms_per_page": round(report.get("ocr_rec", 0.0), 1),
        "pad_overhead": round(REC_STATS.get("pad_overhead", 0.0), 3),
        "session_calls": REC_STATS.get("calls"),
    }
    # bench.py:341-350
    pps_runs = [round(PAGES / r, 3) for r in WALLS]
    want_variance = {
        "pages_per_sec_runs": pps_runs,
        "spread_pct": round(
            (max(pps_runs) - min(pps_runs)) / max(sum(pps_runs) /
                                                  len(pps_runs), 1e-9) * 100,
            1,
        ),
        "corpus": CORPUS,
    }
    workload = bench.workload_report(REPORT, REC_CROPS)
    assert workload == want_workload
    assert bench.overlap_report(REPORT, PAGES, WALLS[-1], workload, REC_STATS) == want_overlap
    assert bench.variance_report(PAGES, WALLS, CORPUS) == want_variance
    # one pass (the smoke's accounting parse): no spread was measured
    one = bench.variance_report(PAGES, WALLS[:1], CORPUS)
    assert one["spread_pct"] is None and one["pages_per_sec_runs"] == pps_runs[:1]
    # no rec stage: crops/s None, as bench.py gives it
    no_rec = {k: v for k, v in REPORT.items() if k != "ocr_rec"}
    assert bench.overlap_report(no_rec, PAGES, 1.0, workload, {})["ocr_rec_detail"][
        "crops_per_sec"] is None


def test_corpus_documents_are_the_layout_fixtures_pages_by_kind():
    layout = bench.page_images(bench.LAYOUT_PDF.read_bytes())
    docs = bench.corpus_docs()
    assert sorted(docs) == ["formula_dense", "table_heavy"]
    for kind, pdf in docs.items():
        pages = bench.page_images(pdf)
        idx = bench.LAYOUT_KINDS[kind]
        assert len(pages) == bench.CORPUS_PAGES
        assert pages == [layout[idx[i % len(idx)]] for i in range(bench.CORPUS_PAGES)]
    crops = bench.formula_crops()
    assert [c.shape for c in crops] == [(64 + 16 * i, 320 + 64 * i, 3) for i in range(4)]
    assert all(c.dtype == np.uint8 and (c == 0).any() for c in crops)


@pytest.fixture
def few_threads():
    yield from capped_threads(4)


def small_pages_pdf(n_pages: int) -> tuple[bytes, dict]:
    """The OCR fixture's first page cut to its top 320 rows (a few text
    lines), JPEG-encoded by the port, on n_pages pages: the rehearsal's
    parse at a fraction of the full page's CPU time."""
    from rapiddoc_tpu_torch.pdfio.jpeg_encode import encode_jpeg

    with np.load(REPO / "rapiddoc_tpu_torch" / "assets" / "ocr_smoke_pages.npz") as z:
        page = np.ascontiguousarray(z["pages"][0][:320])
    image = (encode_jpeg(page), page.shape[1], page.shape[0], "DeviceRGB")
    return bench.build_pdf([image], n_pages), {"synth_text": n_pages}


def test_cpu_rehearsal_prints_every_new_key(monkeypatch, capsys, few_threads):
    import torch  # noqa: F401  (the bench imports it too)

    for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
        monkeypatch.delenv(k)
    for k in ("DISABLE_LAYOUT", "DISABLE_FORMULA", "DISABLE_TABLE", "DEMO_LAYOUT",
              "INT8_HEAD"):
        monkeypatch.setenv(f"RAPIDDOC_{k}", "")  # restored after: the bench sets them
        monkeypatch.delenv(f"RAPIDDOC_{k}")
    monkeypatch.setenv("RAPIDDOC_BENCH_SKIP_CORPUS", "1")
    monkeypatch.setenv("RAPIDDOC_BENCH_SKIP_PUBLISHED", "1")
    monkeypatch.setenv("RAPIDDOC_BENCH_COLDSTART", "1")
    monkeypatch.setattr(bench, "corpus_pdf", lambda corpus, n: small_pages_pdf(n))
    monkeypatch.setattr(sys, "argv", ["bench", "--device", "cpu", "--pages", "2",
                                      "--dtype", "fp32"])
    bench.main()
    out, err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    for line in ("[workload]", "[overlap]", "[variance]", "[baseline]", "[baseline-xla-cpu]"):
        assert line in err
    assert set(result["workload"]) == {"rec_crops", "formula_regions", "table_regions"}
    assert result["workload"]["rec_crops"] > 0
    overlap = result["overlap"]
    assert {"host_path_ms_per_page", "device_path_ms_per_page", "e2e_ms_per_page",
            "e2e_over_max_path", "ocr_rec_detail", "variance"} <= set(overlap)
    assert overlap["e2e_ms_per_page"] > 0 and overlap["e2e_over_max_path"] > 0
    assert set(overlap["ocr_rec_detail"]) == {"crops", "crops_per_sec", "ms_per_page",
                                              "pad_overhead", "session_calls"}
    assert overlap["variance"]["corpus"] == {"synth_text": 2}
    assert len(overlap["variance"]["pages_per_sec_runs"]) == 2
    assert result["e2e_corpus"] == "ocr"
    assert result["corpus"] == {"skipped": "RAPIDDOC_BENCH_SKIP_CORPUS"}
    assert result["published_dims"] == {"skipped": "RAPIDDOC_BENCH_SKIP_PUBLISHED"}
    card_only = {"skipped": "needs the card (--device cpu)"}
    assert result["ctc_head"] == result["quant_head"] == result["cold_start"] == card_only
    assert result["vs_baseline"] > 0 and result["vs_baseline_xla_cpu"] > 0
    assert result["baseline_kind"] == "torch-eager-cpu1"
    assert result["mfu"]["mfu_total"] is None  # no device number on the CPU
