"""The port's layout path through RapidDoc against the JAX package's, on
the CPU.

The fixture PDF (``rapiddoc_tpu_torch/assets/layout_smoke_doc.pdf``: two
``formula_dense`` pages from ``random.Random(11)`` and two
``table_heavy`` pages from ``random.Random(7)`` of
``train/synth_layout.render_layout_page(rng, size=760, height=1000,
mix=...)``, written by the JAX package's ``images_to_pdf(..., dpi=144)``,
as ``bench.py``'s ``_synth_corpus_pdf`` writes them) and the golden
(``layout_smoke_golden.json``: the JAX package's ``RapidDoc()(pdf,
parse_method="ocr")`` with ``RAPIDDOC_DEMO_LAYOUT=1
RAPIDDOC_DISABLE_TABLE=1``, in fp32 and bf16, each with the int8 formula
head off and on) are rebuilt by this file. The golden holds, per mode,
the Markdown, the content list, the demo layout detector's dets on each
rendered page, every formula region's LaTeX and the name and sha256 of
every span payload (JPEG bytes PIL wrote).

The port on the CPU must give the fp32 goldens exactly (with the int8
head off and on, and with one page per window, which makes the facade
pack formula regions across windows with ``DeferredAR``), and in bf16
meet the limits ``chip_smoke.py`` holds the card's bf16 run to.

Rebuild both files with ``python tests/test_torch_pipeline_layout.py``
(needs the JAX package, PIL and matplotlib; about 4 minutes); ``python
tests/test_torch_pipeline_layout.py --compare`` prints the port's bf16
reading on the CPU against the bf16 goldens (the source of
chip_smoke.py's limits).
"""
import hashlib
import importlib.util
import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "layout_smoke_doc.pdf"
GOLDEN_JSON = ASSETS / "layout_smoke_golden.json"
PDF_DPI = 144  # bench.py _synth_corpus_pdf
# bench.py _synth_corpus_pdf: cumulative cuts (paragraph, heading,
# figure, table), the rest display formulas; (mix, seed, pages)
RECIPES = (
    ("formula_dense", (0.22, 0.28, 0.32, 0.36), 11, 2),
    ("table_heavy", (0.18, 0.24, 0.28, 0.92), 7, 2),
)
MODES = ("fp32", "fp32_int8", "bf16", "bf16_int8")
ENV = {"RAPIDDOC_DEMO_LAYOUT": "1", "RAPIDDOC_DISABLE_TABLE": "1"}


def make_pages() -> list[np.ndarray]:
    from rapiddoc_tpu.train.synth_layout import render_layout_page

    pages = []
    for _, mix, seed, n in RECIPES:
        rng = random.Random(seed)
        pages += [render_layout_page(rng, size=760, height=1000, mix=mix)[0]
                  for _ in range(n)]
    return pages


def make_pdf() -> bytes:
    from PIL import Image

    from rapiddoc_tpu import pdfio

    return pdfio.images_to_pdf([Image.fromarray(p) for p in make_pages()], dpi=PDF_DPI)


def plain(obj):
    """JSON-ready: numpy scalars and arrays as Python values, tuples as
    lists."""
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


class held_env:
    """ENV (demo layout on, table off) with every other RAPIDDOC_* /
    MINERU_* setting held off (other test files set some when they are
    imported), plus ``extra``."""

    def __init__(self, **extra: str):
        self.extra = extra

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items()
                      if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        os.environ.update(ENV)
        os.environ.update(self.extra)
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


def mode_env(mode: str) -> dict:
    env = {}
    if mode.startswith("fp32"):
        env["RAPIDDOC_FP32_PARAMS"] = "1"
    if mode.endswith("int8"):
        env["RAPIDDOC_INT8_HEAD"] = "1"
    return env


def sha256(data) -> str:
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data).tobytes()
    return hashlib.sha256(data).hexdigest()


def layout_rows(dets: list[dict]) -> list[dict]:
    """(label, score, box) of a layout detector's dets."""
    return [{"label": d["original_label"], "score": float(d["score"]),
             "box": [float(d["poly"][i]) for i in (0, 1, 4, 5)]} for d in dets]


def latexes(model_info: list[dict]) -> list[list[str]]:
    """Each page's formula LaTeX, in det order."""
    return [[d["latex"] for d in page["layout_dets"] if "latex" in d]
            for page in model_info]


def summary(out) -> dict:
    """The golden's reading of a parse."""
    return plain({
        "markdown": out.markdown, "content_list": out.content_list_json,
        "latex": latexes(out.model_json),
        "images": {k: sha256(v) for k, v in sorted(out.images.items())},
    })


def jax_pages(pdf: bytes, dpi: int = 200) -> list[np.ndarray]:
    from rapiddoc_tpu.pdfio import open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full

    doc = open_pdf(pdf)
    return [np.asarray(render_page_full(doc.get_page(i), dpi=dpi, with_text=False)[0])
            for i in range(len(doc))]


def jax_parse(pdf: bytes, mode: str, window: int | None = None) -> dict:
    """The JAX package's parse in ``mode``, with its layout detector's
    dets on the rendered pages. The int8 head is quantized eagerly first:
    the JAX package's _int8_head() caches a tracer when the jitted decode
    calls it first, and a second trace then fails."""
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    extra = mode_env(mode)
    if window is not None:
        extra["RAPIDDOC_PROCESSING_WINDOW_SIZE"] = str(window)
    with held_env(**extra):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        analyzer = ModelStack.get("ch", True, True, {
            "layout": {}, "ocr": {}, "formula": {}, "table": {}, "checkbox": {}}).analyzer
        assert analyzer.layout_model is not None and analyzer.formula_model is not None
        if mode.endswith("int8"):
            assert analyzer.formula_model._int8_head() is not None
        out = rapid(pdf, parse_method="ocr")
        got = summary(out)
        got["layout"] = [layout_rows(d) for d in
                         analyzer.layout_model.batch_predict(jax_pages(pdf))]
        got["model_info"] = plain(out.model_json)
        ModelStack._instances.clear()
    return got


def make_golden(pdf: bytes) -> dict:
    golden = {
        "source": "rapiddoc_tpu RapidDoc()(pdf, parse_method='ocr') on the CPU with "
                  "RAPIDDOC_DEMO_LAYOUT=1 RAPIDDOC_DISABLE_TABLE=1, on "
                  "layout_smoke_doc.pdf; rebuilt by tests/test_torch_pipeline_layout.py",
        "dpi": 200,
        "page_sha256": [sha256(p) for p in jax_pages(pdf)],
    }
    for mode in MODES:
        golden[mode] = jax_parse(pdf, mode)
        if mode.startswith("bf16"):
            del golden[mode]["model_info"]
    one = jax_parse(pdf, "fp32", window=1)
    # the JAX package's own output with one page per window (DeferredAR)
    golden["fp32_window1_equal"] = all(
        one[k] == golden["fp32"][k] for k in ("markdown", "content_list", "latex", "images"))
    return golden


def port_parse(pdf: bytes, mode: str, window: int | None = None, **kwargs):
    """The port's RapidDoc on the CPU in ``mode`` (its formula
    recognizer reads RAPIDDOC_INT8_HEAD)."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    dtype = torch.float32 if mode.startswith("fp32") else torch.bfloat16
    extra = {"RAPIDDOC_INT8_HEAD": "1"} if mode.endswith("int8") else {}
    if window is not None:
        extra["RAPIDDOC_PROCESSING_WINDOW_SIZE"] = str(window)
    with held_env(**extra):
        return RapidDoc(device="cpu", dtype=dtype, **kwargs)(pdf, parse_method="ocr")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_dets_equal(got: list[dict], want: list[dict]) -> None:
    """Every det of every page: the same keys, category, text and LaTeX;
    boxes within 0.05 px (the layout model's float32 boxes), scores
    within 5e-3 (fp32 summation order)."""
    for gp, wp in zip(got, want, strict=True):
        for g, w in zip(gp["layout_dets"], wp["layout_dets"], strict=True):
            assert set(g) == set(w)
            for key in g:
                if key == "score":
                    assert abs(g[key] - w[key]) <= 5e-3
                elif key == "poly":
                    assert max(abs(a - b) for a, b in zip(g[key], w[key])) <= 0.05
                else:
                    assert g[key] == w[key], key


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pdf() -> bytes:
    return DOC_PDF.read_bytes()


def test_fixture_pdf_matches_committed(pdf, golden):
    """The fixture rebuilt by the JAX package's generator is the committed
    file, and the golden's rendered pages are the JAX package's."""
    assert make_pdf() == pdf
    assert golden["page_sha256"] == [sha256(p) for p in jax_pages(pdf)]
    assert golden["fp32_window1_equal"]


def test_port_fp32_equals_fp32_golden_with_data_uris(pdf, golden):
    """fp32, the int8 head off, the default window (one window, no
    DeferredAR), image_output_mode='data_uri': the payloads' names and
    sha256 (JPEG bytes equal to PIL's), the Markdown equal to the JAX
    package's _embed_data_uris of the golden's Markdown over them, the
    content list, every formula's LaTeX and every det."""
    from rapiddoc_tpu.api import RapidDoc as JaxRapidDoc

    out = port_parse(pdf, "fp32", image_output_mode="data_uri")
    want = golden["fp32"]
    got = summary(out)
    assert got["images"] == want["images"]
    assert out.markdown == JaxRapidDoc._embed_data_uris(want["markdown"], out.images)
    assert "data:image/jpeg;base64," in out.markdown
    assert got["content_list"] == want["content_list"]
    assert got["latex"] == want["latex"]
    assert_dets_equal(plain(out.model_json), want["model_info"])


def test_port_fp32_int8_one_page_windows_equals_golden(pdf, golden):
    """fp32 with the int8 formula head (K2's plain version here) and one
    page per window, so the facade packs the formula regions of four
    windows with DeferredAR: everything equal to the int8 golden (the
    JAX package's own one-page windows give its default-window output,
    ``fp32_window1_equal``)."""
    out = port_parse(pdf, "fp32_int8", window=1)
    want = golden["fp32_int8"]
    got = summary(out)
    for key in ("markdown", "content_list", "latex", "images"):
        assert got[key] == want[key], key
    assert_dets_equal(plain(out.model_json), want["model_info"])
    stats = out.stage_report["formula"]
    assert stats["items"] >= 18 and stats["calls"] >= 1


def test_port_bf16_meets_the_card_limits(pdf, golden):
    """The port's bf16 on the CPU (int8 head on) against the JAX
    package's bf16 int8 golden, held to chip_smoke.py's pipeline_layout
    limits (``python tests/test_torch_pipeline_layout.py --compare``)."""
    smoke = _chip_smoke()
    vs = smoke.compare_layout_parse(summary(port_parse(pdf, "bf16_int8")), golden["bf16_int8"])
    smoke.check_layout_parse_bf16(vs)


@pytest.mark.parametrize("stage", ["layout", "formula", "span_jpeg"])
def test_port_raises_when_a_stage_fails(monkeypatch, stage):
    """A layout model, formula recognizer or span encoder that fails
    fails the parse (on the fixture's first page): no fallback layout, no
    empty LaTeX, no span without its payload."""
    from rapiddoc_tpu_torch.bench import build_pdf, page_images
    from rapiddoc_tpu_torch.models.formula.engine import FormulaRecognizer
    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.utils import images

    def broken(*args, **kwargs):
        raise RuntimeError(f"{stage} failed")

    target = {"layout": (LayoutDetector, "batch_predict"),
              "formula": (FormulaRecognizer, "batch_predict"),
              "span_jpeg": (images, "encode_jpeg")}[stage]
    monkeypatch.setattr(*target, broken)
    one_page = build_pdf(page_images(DOC_PDF.read_bytes())[:1], 1)
    with pytest.raises(RuntimeError, match=f"{stage} failed"):
        port_parse(one_page, "fp32")


def compare(pdf: bytes) -> dict:
    """The port's bf16 on the CPU against the bf16 goldens, and the JAX
    package's own fp32 against its bf16, read as chip_smoke.py reads the
    card's."""
    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    import torch

    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.pdfio import open_pdf, render_page_full

    doc = open_pdf(pdf)
    pages = [render_page_full(doc.get_page(i), dpi=200, with_text=False)[0]
             for i in range(len(doc))]
    det = LayoutDetector.build({"demo_layout": True}, device="cpu", dtype=torch.bfloat16)
    out = {"port_layout_bf16_cpu": smoke.compare_layout_dets(
        [layout_rows(d) for d in det.batch_predict(pages)], golden["bf16"]["layout"]),
        "jax_layout_fp32_vs_bf16": smoke.compare_layout_dets(
            golden["fp32"]["layout"], golden["bf16"]["layout"])}
    for mode in ("bf16", "bf16_int8"):
        out[f"port_{mode}_cpu"] = smoke.compare_layout_parse(
            summary(port_parse(pdf, mode)), golden[mode])
        out[f"jax_fp32_vs_{mode}"] = smoke.compare_layout_parse(
            golden[mode.replace("bf16", "fp32")], golden[mode])
    return out


if __name__ == "__main__":
    # Rewrites the fixture PDF and the golden; with --compare, prints
    # compare() instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(DOC_PDF.read_bytes()), indent=1))
    else:
        data = make_pdf()
        DOC_PDF.write_bytes(data)
        GOLDEN_JSON.write_text(json.dumps(make_golden(data), indent=1) + "\n")
        print("wrote", DOC_PDF, GOLDEN_JSON)
