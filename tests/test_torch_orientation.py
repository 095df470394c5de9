"""The port's orientation classifier and its place in the pipeline against
the JAX package's, on the CPU.

- ``OrientationNet`` with ``orientation_demo.npz`` (22 leaves): logits
  within 1e-3 of the JAX package's in fp32 on seeded inputs, and the
  classifier's angles equal on pages turned every way.
- ``_rotate_dets_back``: the identity cycle of
  ``tests/test_scheduler_extras.py``, and the port's and the JAX
  package's maps equal.
- ``USE_DOC_ORIENTATION_CLASSIFY=1 RapidDoc()(pdf, parse_method="ocr")``
  on a landscape image-only fixture (``orientation_smoke_doc.pdf``: the
  first two pages of the layout fixture's generator with their pixels
  turned by ``np.rot90``, three and one quarter turns, written by the
  JAX package's ``images_to_pdf(..., dpi=144)``), with the demo layout and
  every stage on: the demo classifier reads 180 and 90 there (the JAX
  package's turn for an angle is ``np.rot90`` by it, so neither page
  comes out upright: reference behaviour), so both pages are turned
  before the stages and ``_rotate_dets_back`` maps their dets back. fp32 angles, Markdown, content list, tables, LaTeX, payloads
  and dets equal to the JAX package's golden
  (``orientation_smoke_golden.json``); bf16 within the smoke's bands.

``python tests/test_torch_orientation.py`` rebuilds the fixture and the
golden (needs the JAX package, PIL and matplotlib; about 3 minutes);
``--compare`` prints the port's bf16 reading on the CPU against the bf16
golden (the source of the smoke's ``ORIENTATION_BF16`` band).
"""
import importlib.util
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import test_torch_pipeline_layout as pl  # noqa: E402
import test_torch_table as tt  # noqa: E402

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
DOC_PDF = ASSETS / "orientation_smoke_doc.pdf"
GOLDEN_JSON = ASSETS / "orientation_smoke_golden.json"
TURNS = (3, 1)  # np.rot90 quarter turns of the layout fixture's pages 0 and 1
MODES = ("fp32", "bf16")
ENV = {"USE_DOC_ORIENTATION_CLASSIFY": "1"}
DET_BOX_TOL = 0.05  # px, the layout detector's fp32 boxes (chip_smoke.LAYOUT_BOX_TOL)


def make_pdf() -> bytes:
    from PIL import Image

    from rapiddoc_tpu import pdfio

    pages = pl.make_pages()
    turned = [np.ascontiguousarray(np.rot90(pages[i], k)) for i, k in enumerate(TURNS)]
    return pdfio.images_to_pdf([Image.fromarray(p) for p in turned], dpi=pl.PDF_DPI)


def jax_angles(pages: list[np.ndarray], fp32: bool) -> list[int]:
    from rapiddoc_tpu.models.orientation.engine import OrientationClassifier
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    env = {"RAPIDDOC_FP32_PARAMS": "1"} if fp32 else {}
    with tt.table_env(**env):
        clf = OrientationClassifier(_load_variables(DEMO_ASSETS_DIR / "orientation_demo.npz"))
        return clf(pages)


def dets_of(model_json: list[dict]) -> list[list[dict]]:
    """Each page's dets: category, poly and text."""
    return [[{"category_id": d["category_id"], "poly": [float(v) for v in d["poly"]],
              "text": d.get("text", "")} for d in page["layout_dets"]] for page in model_json]


def jax_parse(pdf: bytes, mode: str) -> dict:
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    extra = {**ENV, **pl.mode_env(mode)}
    with tt.table_env(**extra):
        ModelStack._instances.clear()
        rapid = RapidDoc()
        analyzer = ModelStack.get("ch", True, True, {
            "layout": {}, "ocr": {}, "formula": {}, "table": {}, "checkbox": {}}).analyzer
        assert analyzer.orientation_model is not None and analyzer.table_model is not None
        out = rapid(pdf, parse_method="ocr")
        ModelStack._instances.clear()
    got = tt.parse_summary(out)
    got["dets"] = tt.mask_uuids(dets_of(out.model_json), out.model_json)
    return got


def make_golden(pdf: bytes) -> dict:
    pages = pl.jax_pages(pdf)
    return {
        "source": "rapiddoc_tpu RapidDoc()(pdf, parse_method='ocr') on the CPU with "
                  "USE_DOC_ORIENTATION_CLASSIFY=1 RAPIDDOC_DEMO_LAYOUT=1 (table on), on "
                  "orientation_smoke_doc.pdf; rebuilt by tests/test_torch_orientation.py",
        "dpi": 200,
        "page_sha256": [pl.sha256(p) for p in pages],
        "angles": {"fp32": jax_angles(pages, True), "bf16": jax_angles(pages, False)},
        **{mode: jax_parse(pdf, mode) for mode in MODES},
    }


def port_parse(pdf: bytes, mode: str) -> dict:
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mode]
    with tt.table_env(**ENV):
        out = RapidDoc(device="cpu", dtype=dtype)(pdf, parse_method="ocr")
    got = tt.parse_summary(out)
    got["dets"] = tt.mask_uuids(dets_of(out.model_json), out.model_json)
    return got


def port_pages(pdf: bytes) -> list[np.ndarray]:
    from rapiddoc_tpu_torch.pdfio import open_pdf
    from rapiddoc_tpu_torch.pdfio.render import render_page_full

    doc = open_pdf(pdf)
    return [np.asarray(render_page_full(doc.get_page(i), dpi=200, with_text=False)[0])
            for i in range(len(doc))]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pdf() -> bytes:
    return DOC_PDF.read_bytes()


def classifier(dtype_name: str):
    import torch

    from rapiddoc_tpu_torch.models.registry import build_orientation_model

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[dtype_name]
    with tt.table_env(**ENV):
        return build_orientation_model(device="cpu", dtype=dtype)


def test_fixture_pdf_matches_committed(pdf):
    assert make_pdf() == pdf


def test_orientation_net_logits_equal_jax():
    """The demo net's logits on seeded NHWC inputs (x/255 rounded to bf16,
    as the classifier feeds it) within 1e-3 of the JAX package's in fp32,
    and its argmax equal."""
    import jax.numpy as jnp
    import torch

    from rapiddoc_tpu.models.orientation.engine import OrientationNet as JaxNet
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    from rapiddoc_tpu_torch.models.weights import load_npz

    flat = load_npz(DEMO_ASSETS_DIR / "orientation_demo.npz")
    assert len(flat) == 22
    model = classifier("fp32").session.module
    x = np.random.default_rng(0).integers(0, 256, (6, 224, 224, 3), dtype=np.uint8)
    xb = (x.astype(np.float32) / 255.0).astype(jnp.bfloat16)
    want = np.asarray(JaxNet().apply(_load_variables(DEMO_ASSETS_DIR / "orientation_demo.npz"),
                                     jnp.asarray(xb)).astype(jnp.float32))
    with torch.no_grad():
        got = model(torch.from_numpy(np.asarray(xb, np.float32))).numpy()
    assert np.abs(got - want).max() <= 1e-3
    assert np.array_equal(got.argmax(-1), want.argmax(-1))


def test_classifier_angles_equal_jax(pdf, golden):
    """The classifier on the fixture's rendered pages (the golden's
    sha256) and on the layout fixture's pages turned every way: angles
    equal to the JAX package's in fp32 and in bf16."""
    pages = port_pages(pdf)
    assert [pl.sha256(p) for p in pages] == golden["page_sha256"]
    for mode in MODES:
        assert classifier(mode)(pages) == golden["angles"][mode]
    assert golden["angles"]["fp32"] == [180, 90]
    turned = [np.ascontiguousarray(np.rot90(p, k)) for p in pl.make_pages()[:2] for k in range(4)]
    assert classifier("fp32")(turned) == jax_angles(turned, True)


@pytest.mark.parametrize("angle", [90, 180, 270])
def test_rotate_dets_back_identity_cycle(angle):
    """A box turned with the page by np.rot90 maps back onto itself
    (within 1.5 px, as the JAX package's test), and the port's map is the
    JAX package's."""
    from rapiddoc_tpu.pipeline.scheduler import _rotate_dets_back as jax_back

    from rapiddoc_tpu_torch.pipeline.scheduler import _quad_poly, _rotate_dets_back

    w, h = 200, 100
    x0, y0, x1, y1 = orig = [20.0, 30.0, 80.0, 60.0]
    if angle == 90:
        pts, rot_w, rot_h = [(y, w - 1 - x) for x, y in ((x0, y0), (x1, y1))], h, w
    elif angle == 180:
        pts, rot_w, rot_h = [(w - 1 - x, h - 1 - y) for x, y in ((x0, y0), (x1, y1))], w, h
    else:
        pts, rot_w, rot_h = [(h - 1 - y, x) for x, y in ((x0, y0), (x1, y1))], h, w
    xs, ys = [p[0] for p in pts], [p[1] for p in pts]
    det = {"poly": _quad_poly(min(xs), min(ys), max(xs), max(ys))}
    twin = {"poly": list(det["poly"])}
    _rotate_dets_back([det], angle, rot_w, rot_h)
    jax_back([twin], angle, rot_w, rot_h)
    assert det == twin
    back = [det["poly"][0], det["poly"][1], det["poly"][4], det["poly"][5]]
    np.testing.assert_allclose(back, orig, atol=1.5)


def test_port_fp32_parse_equals_golden(pdf, golden):
    """The landscape fixture with USE_DOC_ORIENTATION_CLASSIFY=1 and every
    stage on, fp32: everything the golden holds, equal."""
    got = port_parse(pdf, "fp32")
    want = golden["fp32"]
    for key in ("markdown", "content_list", "tables", "latex", "images"):
        assert got[key] == want[key], key
    assert_same_dets(got["dets"], want["dets"])


def assert_same_dets(got: list, want: list) -> None:
    assert [len(p) for p in got] == [len(p) for p in want]
    for gp, wp in zip(got, want):
        for g, w in zip(gp, wp):
            assert (g["category_id"], g["text"]) == (w["category_id"], w["text"])
            assert np.abs(np.asarray(g["poly"]) - np.asarray(w["poly"])).max() <= DET_BOX_TOL


def compare() -> dict:
    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    got = port_parse(DOC_PDF.read_bytes(), "bf16")
    return {"port_bf16_cpu": smoke.compare_table_parse(got, golden["bf16"]),
            "angles_bf16_cpu": classifier("bf16")(port_pages(DOC_PDF.read_bytes())),
            "jax_fp32_vs_bf16": smoke.compare_table_parse(golden["fp32"], golden["bf16"])}


if __name__ == "__main__":
    # Rewrites the fixture PDF and the golden; with --compare, prints
    # compare() instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(), indent=1))
    else:
        data = make_pdf()
        DOC_PDF.write_bytes(data)
        GOLDEN_JSON.write_text(json.dumps(make_golden(data), indent=1) + "\n")
        print("wrote", DOC_PDF, GOLDEN_JSON)
