"""The port's RapidDoc against the JAX package's, end to end on the CPU.

The fixture PDF (``rapiddoc_tpu_torch/assets/ocr_smoke_doc.pdf``: the
three OCR fixture pages written by the JAX package's
``pdfio.images_to_pdf(..., dpi=144)``, as ``bench.py`` writes its PDF)
and the golden (``pipeline_smoke_golden.json``: the JAX package's
``RapidDoc()(pdf, parse_method="ocr")`` with layout, formula and table
disabled, in fp32 and in bf16) that ``chip_smoke.py`` checks the card
against are rebuilt here from the JAX package: the PDF must equal the
committed file, and the golden's decoded and rendered pages and its
classification must equal what the JAX package gives now (its first
page's model output and its host stages are held to the JAX package in
``test_torch_pipeline.py``; the full three-page JAX run is the
generator's). Then the port, on the CPU, must give the fp32 golden's
Markdown exactly, and in bf16 meet the limits ``chip_smoke.py`` holds
the card's bf16 run to; its stages that the port does not have yet must
raise, and those it has now (the OCR wires, orientation) must build as
the JAX package's do.

Rebuild both files with ``python tests/test_torch_api.py``; ``python
tests/test_torch_api.py --compare`` prints the port's bf16 reading on
the CPU against the bf16 golden (the source of chip_smoke.py's limits).
"""
import hashlib
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
PAGES_NPZ = ASSETS / "ocr_smoke_pages.npz"
DOC_PDF = ASSETS / "ocr_smoke_doc.pdf"
GOLDEN_JSON = ASSETS / "pipeline_smoke_golden.json"
PDF_DPI = 144  # bench.py _bench_pdf_bytes
DISABLED = ("LAYOUT", "FORMULA", "TABLE")


def make_pdf() -> bytes:
    """The fixture pages as the JAX package's bench writes its PDF."""
    from PIL import Image

    from rapiddoc_tpu import pdfio

    with np.load(PAGES_NPZ) as z:
        pages = z["pages"]
    return pdfio.images_to_pdf([Image.fromarray(p) for p in pages], dpi=PDF_DPI)


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
    """RAPIDDOC_DISABLE_LAYOUT/FORMULA/TABLE=1 with every other
    RAPIDDOC_*/MINERU_* setting held off (other test files set some, such
    as RAPIDDOC_DISABLE_OCR, when they are imported), plus ``extra``."""

    def __init__(self, **extra: str):
        self.extra = extra

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items()
                      if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        for k in DISABLED:
            os.environ[f"RAPIDDOC_DISABLE_{k}"] = "1"
        os.environ.update(self.extra)
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


class jax_env(held_env):
    """held_env (with RAPIDDOC_FP32_PARAMS=1 for fp32), the JAX package's
    model-stack cache emptied on the way in and out (its key does not
    hold the precision)."""

    def __init__(self, fp32: bool):
        super().__init__(**({"RAPIDDOC_FP32_PARAMS": "1"} if fp32 else {}))

    def __enter__(self):
        from rapiddoc_tpu.api import ModelStack

        super().__enter__()
        ModelStack._instances.clear()
        return self

    def __exit__(self, *exc):
        from rapiddoc_tpu.api import ModelStack

        ModelStack._instances.clear()
        super().__exit__(*exc)


def jax_parse(pdf: bytes, fp32: bool) -> dict:
    from rapiddoc_tpu import RapidDoc

    with jax_env(fp32):
        out = RapidDoc()(pdf, parse_method="ocr")
    return plain({"markdown": out.markdown, "middle_json": out.middle_json,
                  "content_list": out.content_list_json, "model_info": out.model_json})


def jax_render(pdf: bytes, dpi: int) -> list[tuple[np.ndarray, list]]:
    """(page array, image placement boxes) of each page, from the JAX
    package's render_page_full."""
    from rapiddoc_tpu.pdfio import open_pdf
    from rapiddoc_tpu.pdfio.render import render_page_full

    doc = open_pdf(pdf)
    out = []
    for i in range(len(doc)):
        img, _, boxes = render_page_full(doc.get_page(i), dpi=dpi, with_text=False)
        out.append((np.asarray(img), boxes))
    return out


def sha256(arr: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(arr).tobytes()).hexdigest()


def pil_jpegs(pdf: bytes) -> list[np.ndarray]:
    """Each page's JPEG stream as PIL decodes it (the JAX package's
    xobject_to_pil)."""
    import io

    from PIL import Image

    from rapiddoc_tpu.pdfio import open_pdf

    doc = open_pdf(pdf)
    out = []
    for i in range(len(doc)):
        stream = doc.resolve(doc.resolve(doc.get_page(i).resources["XObject"])["Im0"])
        out.append(np.asarray(Image.open(io.BytesIO(stream.raw))))
    return out


def make_golden(pdf: bytes) -> dict:
    from rapiddoc_tpu.pdfio import classify_pdf

    return {
        "source": "rapiddoc_tpu RapidDoc()(pdf, parse_method='ocr') on the CPU with "
                  "RAPIDDOC_DISABLE_LAYOUT/FORMULA/TABLE=1, on ocr_smoke_doc.pdf; "
                  "rebuilt by tests/test_torch_api.py",
        "dpi": 200,
        "classify": classify_pdf(pdf),
        "jpeg_sha256": [sha256(p) for p in pil_jpegs(pdf)],
        "page_sha256": [sha256(p) for p, _ in jax_render(pdf, 200)],
        "fp32": jax_parse(pdf, fp32=True),
        "bf16": jax_parse(pdf, fp32=False),
    }


def port_parse(pdf: bytes, dtype_name: str) -> dict:
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    with held_env():
        out = RapidDoc(device="cpu", dtype=dtype)(pdf, parse_method="ocr")
    return plain({"markdown": out.markdown, "middle_json": out.middle_json,
                  "content_list": out.content_list_json, "model_info": out.model_json})


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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


def test_fixture_pdf_matches_committed(pdf):
    assert make_pdf() == pdf


def test_golden_pages_and_classification_match_jax_package(pdf, golden):
    from rapiddoc_tpu.pdfio import classify_pdf

    assert golden["classify"] == classify_pdf(pdf) == "ocr"
    assert golden["jpeg_sha256"] == [sha256(p) for p in pil_jpegs(pdf)]
    assert golden["page_sha256"] == [sha256(p) for p, _ in jax_render(pdf, golden["dpi"])]


def test_port_fp32_equals_fp32_golden(pdf, golden):
    """The port's RapidDoc on the CPU in fp32: the Markdown and the
    content list exactly, every det's category, box and text exactly;
    scores within 5e-3 (fp32 summation order, as the OCR system's test
    holds them)."""
    got = port_parse(pdf, "fp32")
    want = golden["fp32"]
    assert got["markdown"] == want["markdown"]
    assert got["content_list"] == want["content_list"]
    for gp, wp in zip(got["model_info"], want["model_info"], strict=True):
        for g, w in zip(gp["layout_dets"], wp["layout_dets"], strict=True):
            assert {k: v for k, v in g.items() if k != "score"} == \
                {k: v for k, v in w.items() if k != "score"}
            assert abs(g["score"] - w["score"]) <= 5e-3


def test_port_bf16_meets_the_card_limits(pdf, golden):
    """The port's bf16 on the CPU against the JAX package's bf16 golden,
    held to chip_smoke.py's pipeline limits (measured: 56/74 lines equal,
    CER 0.0083; ``python tests/test_torch_api.py --compare``)."""
    smoke = _chip_smoke()
    vs = smoke.compare_markdown(port_parse(pdf, "bf16")["markdown"], golden["bf16"]["markdown"])
    assert vs["lines"] == 74
    assert vs["exact_share"] >= smoke.PIPELINE_BF16_MIN_EXACT
    assert vs["cer"] <= smoke.PIPELINE_BF16_MAX_CER


@pytest.mark.parametrize("strategy", ["unet_slanet_plus", "unet_unitable"])
def test_port_builds_table_stage_as_jax_package(strategy):
    """With the table stage on, the port's analyzer holds what the JAX
    package's registry builds: the strategy's models from the demo
    checkpoints (the classifier routing by its own kinds), the defaults of
    the table options the port has, and no OCR system inside tables."""
    import torch

    from rapiddoc_tpu.models import registry as jax_registry

    from rapiddoc_tpu_torch.models.registry import build_analyzer
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    with held_env():
        del os.environ["RAPIDDOC_DISABLE_TABLE"]
        got = build_analyzer(configs={"table": {"strategy": strategy}}, device="cpu",
                             dtype=torch.float32).table_model
        want = jax_registry.build_table_model({"strategy": strategy})
    assert isinstance(got, TableRecognizer)
    assert got.ocr is None and want.ocr is None
    for field in ("strategy", "use_cls_model", "wireless_max_len", "use_img2table",
                  "use_compare_table", "detect_rotation", "enable_blank_cell_rec"):
        assert getattr(got.config, field) == getattr(want.config, field), field
    assert type(got.wireless).__name__ == type(want.wireless).__name__
    assert got.classifier is not None and want.classifier is not None
    if strategy == "unet_unitable":
        assert vars(got.wireless.dims) == vars(want.wireless.dims)


KNOBS = {
    "RAPIDDOC_RGB_TRANSFER": ("1", 7), "RAPIDDOC_DET_WIRE_BITS": ("8", 7),
    "RAPIDDOC_DET_PROB_BITS": ("8", 7), "RAPIDDOC_REC_WIRE_BITS": ("8", 7),
    "RAPIDDOC_LAYOUT_WIRE_BITS": ("8", 8),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_port_raises_for_wire_knobs_it_does_not_run(knob):
    """A wire or transfer knob the JAX package reads, set to anything but
    its default: the OCR wires (ROADMAP item 7) build the OCR system with
    the wires the JAX package's build sets, and the layout's 8-bit RGB
    wire (item 8, ported with item 11) builds the layout detector with
    the JAX package's wire. The default value builds the nibble wires.
    (The name is kept from when these knobs raised.)"""
    import torch

    from rapiddoc_tpu.models import registry as jax_registry
    from rapiddoc_tpu.models.layout.engine import LayoutDetector as JaxLayoutDetector

    from rapiddoc_tpu_torch.models.registry import build_analyzer

    value, item = KNOBS[knob]
    with held_env(RAPIDDOC_DEMO_LAYOUT="1", **{knob: value}):
        del os.environ["RAPIDDOC_DISABLE_LAYOUT"]
        analyzer = build_analyzer(formula_enable=False, table_enable=False, device="cpu",
                                  dtype=torch.float32)
        if item == 8:
            want = JaxLayoutDetector.build({})
            assert analyzer.layout_model.nibble_wire == want.nibble_wire is False
            page = np.random.default_rng(0).integers(0, 256, (50, 40, 3), dtype=np.uint8)
            size = want.config.input_size
            assert analyzer.layout_model.preprocess([page]).shape == (1, size, size, 3)
        else:
            got = analyzer.ocr
            want = jax_registry.build_ocr_system()
            for stage, keys in (("detector", ("gray_transfer", "nibble_wire", "prob4_wire")),
                                ("recognizer", ("gray_transfer", "nibble_wire"))):
                for key in keys:
                    assert getattr(getattr(got, stage), key) == \
                        getattr(getattr(want, stage), key), (stage, key)
        os.environ[knob] = "" if knob == "RAPIDDOC_RGB_TRANSFER" else "4"
        analyzer = build_analyzer(formula_enable=False, table_enable=False, device="cpu",
                                  dtype=torch.float32)
    assert analyzer.layout_model is not None and analyzer.ocr is not None
    assert analyzer.layout_model.nibble_wire
    assert analyzer.ocr.detector.nibble_wire and analyzer.ocr.recognizer.nibble_wire


def test_port_builds_orientation_as_jax_package():
    """USE_DOC_ORIENTATION_CLASSIFY=1 gives the analyzer the demo
    orientation classifier, as the JAX package's registry does; without
    it there is none."""
    import torch

    from rapiddoc_tpu.models import registry as jax_registry

    from rapiddoc_tpu_torch.models.orientation.engine import OrientationClassifier
    from rapiddoc_tpu_torch.models.registry import build_analyzer

    for flag in ("1", None):
        extra = {"USE_DOC_ORIENTATION_CLASSIFY": flag} if flag else {}
        saved = os.environ.pop("USE_DOC_ORIENTATION_CLASSIFY", None)
        os.environ.update(extra)
        try:
            with held_env():
                got = build_analyzer(device="cpu", dtype=torch.float32).orientation_model
                want = jax_registry.build_analyzer().orientation_model
        finally:
            os.environ.pop("USE_DOC_ORIENTATION_CLASSIFY", None)
            if saved is not None:
                os.environ["USE_DOC_ORIENTATION_CLASSIFY"] = saved
        assert (got is None) == (want is None) == (flag is None)
        if flag:
            assert isinstance(got, OrientationClassifier)


def test_port_raises_for_seal_ocr():
    """Seal OCR and the curved-text det it needs (ROADMAP item 11, ported):
    ``detect_polys`` on a crop with a curved line and ``_run_seals`` with a
    seal det put in place give the JAX package's polygons and text in
    fp32. (The name is kept from when they raised;
    tests/test_torch_seal.py holds the rest of seal OCR.)"""
    import torch
    from PIL import Image, ImageDraw, ImageFont

    from rapiddoc_tpu.models.ocr.seal import SEAL_DET_PARAMS
    from rapiddoc_tpu.models.registry import build_ocr_system as jax_build
    from rapiddoc_tpu.pipeline.scheduler import DocumentAnalyzer as JaxAnalyzer

    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.pipeline.scheduler import DocumentAnalyzer

    img = Image.new("RGB", (160, 96), "white")
    for i, ch in enumerate("SEAL TEXT"):
        ImageDraw.Draw(img).text((8 + 16 * i, 50 - 18 * np.sin(i / 2.7)), ch,
                                 font=ImageFont.load_default(size=20), fill=(150, 20, 20))
    crop = np.asarray(img)

    class SealLayout:
        def batch_predict(self, pages):
            return [[{"category_id": 3, "original_label": "seal", "score": 0.9,
                      "poly": [2, 2, 157, 2, 157, 93, 2, 93]}] for _ in pages]

    with held_env(RAPIDDOC_FP32_PARAMS="1"):
        ocr = build_ocr_system(device="cpu", dtype=torch.float32)
        jocr = jax_build()
        got = ocr.detector.detect_polys([crop], params=SEAL_DET_PARAMS)[0]
        want = jocr.detector.detect_polys([crop], params=SEAL_DET_PARAMS)[0]
        assert len(got) == len(want) >= 1
        assert all(np.array_equal(g, w) for g, w in zip(got, want))
        texts = [
            [d.get("text", "") for d in an.analyze_pages([crop], ["txt"], [None])[0]["layout_dets"]]
            for an in (DocumentAnalyzer(layout_model=SealLayout(), ocr_system=ocr),
                       JaxAnalyzer(layout_model=SealLayout(), ocr_system=jocr))
        ]
    assert texts[0] == texts[1]


@pytest.mark.parametrize("stage", ["LAYOUT", "LAYOUT_DEMO", "FORMULA"])
def test_port_builds_layout_and_formula_as_jax_package(stage):
    """With the stage's switch off, the port's analyzer holds what the
    JAX package's registry builds there: without RAPIDDOC_DEMO_LAYOUT no
    layout model (the fallback layout); with it the demo detector, its
    arch from layout_demo.json and txt pages left to the fallback; with
    the formula stage on, the demo recognizer and its vocabulary."""
    import torch

    from rapiddoc_tpu.models import registry as jax_registry

    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.models.registry import build_analyzer

    extra = {"RAPIDDOC_DEMO_LAYOUT": "1"} if stage == "LAYOUT_DEMO" else {}
    with held_env(**extra):
        del os.environ["RAPIDDOC_DISABLE_" + stage.split("_")[0]]
        analyzer = build_analyzer(device="cpu", dtype=torch.float32)
        if stage == "FORMULA":
            assert analyzer.layout_model is None
            want = jax_registry.build_formula_model()
            got = analyzer.formula_model
            assert got.tokenizer.vocab == want.tokenizer.vocab
            for key in ("max_len", "vocab_size", "layers", "backbone_size", "out_index",
                        "default_length_bucket"):
                assert getattr(got.config, key) == getattr(want.config, key), key
            return
        assert analyzer.formula_model is None
        want = jax_registry.build_layout_model()
        if stage == "LAYOUT":
            assert analyzer.layout_model is None and want is None
            return
        got = analyzer.layout_model
        assert isinstance(got, LayoutDetector)
        assert got.demo_txt_fallback and want.demo_txt_fallback
        for key in ("model_size", "input_size", "num_queries", "dec_layers", "with_masks",
                    "conf_threshold", "class_thresholds", "markdown_ignore_labels"):
            assert getattr(got.config, key) == getattr(want.config, key), key
        assert got.labels == want.labels


@pytest.mark.parametrize("error", [
    FileNotFoundError("csrc/argmax_head.cuh"),  # ops/build.py: a missing header
    OSError("ctc_head.so: invalid ELF header"),  # ctypes.CDLL
    ValueError("C = 300 exceeds the kernel's widest x, 256"),  # the wrapper's checks
], ids=lambda e: type(e).__name__)
def test_port_raises_when_the_rec_head_fails(pdf, monkeypatch, error):
    """A K1 that does not build, load or launch fails the parse: rec has
    no per-crop retry that would turn it into blank lines."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.ops import ctc_head

    def broken(*args, **kwargs):
        raise error

    monkeypatch.setattr(ctc_head, "ctc_argmax_plain", broken)
    with held_env(), pytest.raises(type(error), match=str(error).split(":")[0]):
        RapidDoc(device="cpu", dtype=torch.float32)(pdf, parse_method="ocr", end_page_id=0)


def test_port_raises_for_inputs_not_ported(tmp_path):
    """WEBP images and BigTIFF files (ROADMAP item 12f) raise; PNG, JPEG,
    BMP, GIF and TIFF images, arrays, Office documents and URLs are
    ported (tests/test_torch_image_inputs.py,
    tests/test_torch_image_files.py, tests/test_torch_office.py,
    tests/test_torch_data_io.py, against a local server)."""
    from rapiddoc_tpu_torch import RapidDoc

    doc = RapidDoc(device="cpu")
    with pytest.raises(NotImplementedError, match="WEBP images.*ROADMAP Queue 1 item 12: 12f"):
        doc(b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8))
    (tmp_path / "a.gif").write_bytes(b"II+\x00" + bytes(16))
    with pytest.raises(NotImplementedError, match="BigTIFF images.*item 12: 12f"):
        doc(tmp_path / "a.gif")


def test_data_uri_markdown_equals_jax_package():
    """image_output_mode='data_uri' embeds each payload as the JAX
    package's _embed_data_uris does (a JPEG span image from the port's
    encoder, a PNG, an <img> tag, a path with no payload)."""
    from rapiddoc_tpu.api import RapidDoc as JaxRapidDoc

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.pdfio.jpeg_encode import encode_jpeg

    rgb = np.random.default_rng(0).integers(0, 256, (9, 17, 3), dtype=np.uint8)
    images = {"images/a.jpg": encode_jpeg(rgb), "images/b.png": b"\x89PNG\r\n\x1a\n" + b"\0" * 8}
    md = ("# t\n\n![](images/a.jpg)\n\n<img src=\"images/b.png\"/>\n\n"
          "![](images/missing.jpg)\n")
    got = RapidDoc(device="cpu", image_output_mode="data_uri")._embed_data_uris(md, images)
    assert got == JaxRapidDoc._embed_data_uris(md, images)
    assert got.count("data:image/jpeg;base64,") == 1 and "data:image/png;base64," in got


def compare(pdf: bytes) -> dict:
    """The port's bf16 (and fp32) on the CPU against the goldens, read as
    chip_smoke.py reads the card's."""
    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    return {
        "port_bf16_cpu": smoke.compare_markdown(port_parse(pdf, "bf16")["markdown"],
                                                golden["bf16"]["markdown"]),
        "port_fp32_cpu": smoke.compare_markdown(port_parse(pdf, "fp32")["markdown"],
                                                golden["fp32"]["markdown"]),
        "jax_fp32_vs_bf16": smoke.compare_markdown(golden["fp32"]["markdown"],
                                                   golden["bf16"]["markdown"]),
    }


if __name__ == "__main__":
    # Rewrites the fixture PDF and the golden; with --compare, prints
    # compare() instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(DOC_PDF.read_bytes()), indent=1))
    else:
        data = make_pdf()
        DOC_PDF.write_bytes(data)
        GOLDEN_JSON.write_text(json.dumps(make_golden(data), indent=1) + "\n")
        print("wrote", DOC_PDF, GOLDEN_JSON)
