"""The port's users of the ONNX interpreter against the JAX package's, on
the CPU: the published-format layout detector (PP-DocLayout V3 and S,
DocLayout-YOLO), the table classifiers, UNet and SLANet-plus, the
orientation classifier, content sniffing, and the four places the port
used to raise (``RapidDoc`` on suffix-less bytes, an ONNX layout in the
models dir, ONNX table models beside the demo checkpoints, and
``rapid_orientation.onnx``). The contracts are those of
tests/test_registry_assets.py and tests/test_onnx_jax.py, each graph
written once by the JAX package's writer and run through both packages.

    python tests/test_torch_onnx_models.py

rebuilds ``rapiddoc_tpu_torch/assets/onnx_parse_golden.json``: the JAX
package's fp32 parses that the smoke's ``onnx`` phase holds the card to
(the layout fixture's first page with the smoke's ``pp_doclayoutv3.onnx``
in the models dir, and the suffix-less bytes).
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parents[1])]
from torch_threads import capped_threads  # noqa: E402

import chip_smoke  # noqa: E402
from rapiddoc_tpu.tools import onnx_writer as w  # noqa: E402
from test_torch_api import held_env, plain  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "rapiddoc_tpu_torch/assets/onnx_parse_golden.json"


@pytest.fixture(autouse=True, scope="module")
def _threads():
    yield from capped_threads(4)


class both_stacks(tempfile.TemporaryDirectory):
    """A temporary models dir under held_env(RAPIDDOC_MODELS_DIR=it, ...),
    with both packages' model-stack caches emptied on the way in and out."""

    def __init__(self, **extra: str):
        super().__init__()
        self.extra = extra

    def __enter__(self):
        from rapiddoc_tpu.api import ModelStack as JaxStack

        from rapiddoc_tpu_torch.api import ModelStack

        path = Path(super().__enter__())
        self.env = held_env(RAPIDDOC_MODELS_DIR=str(path), **self.extra)
        self.env.__enter__()
        JaxStack._instances.clear()
        ModelStack._instances.clear()
        return path

    def __exit__(self, *exc):
        from rapiddoc_tpu.api import ModelStack as JaxStack

        from rapiddoc_tpu_torch.api import ModelStack

        JaxStack._instances.clear()
        ModelStack._instances.clear()
        self.env.__exit__(*exc)
        return super().__exit__(*exc)


def assert_dets_equal(got: list, want: list) -> None:
    assert len(got) == len(want)
    for g, v in zip(got, want):
        assert set(g) == set(v)
        for k in v:
            if k in ("poly", "polygon_points"):
                np.testing.assert_allclose(np.asarray(g[k], float), np.asarray(v[k], float),
                                           atol=1e-4)
            else:
                assert g[k] == v[k], k


def pages(seed: int = 0) -> list[np.ndarray]:
    """A white page and a noisy one."""
    rng = np.random.default_rng(seed)
    return [np.full((400, 300, 3), 255, np.uint8),
            rng.integers(0, 256, (333, 517, 3)).astype(np.uint8)]


# ------------------------------------------------------------ layout

def layout_v3_graph(path: Path) -> Path:
    """test_registry_assets.py's V3 contract: three dets (one below the
    threshold) and masks, tied to the input."""
    boxes = np.asarray([[6, 0.9, 10, 10, 200, 40], [21, 0.8, 10, 60, 200, 180],
                        [22, 0.1, 0, 0, 5, 5]], np.float32)
    masks = np.zeros((3, 50, 50), np.float32)
    masks[1, 15:45, 2:48] = 1.0
    masks[0, 5:20, 10:30] = 1.0
    masks[0, 12:20, 25:40] = 1.0  # an L shape: a polygon, not a box
    nodes = [w.encode_node("ReduceMean", ["image"], ["m"], {"keepdims": 0}),
             w.encode_node("Mul", ["m", "zero"], ["z"]),
             w.encode_node("Add", ["boxes_c", "z"], ["boxes"]),
             w.encode_node("Add", ["masks_c", "z"], ["masks"]),
             w.encode_node("Identity", ["nums_c"], ["box_nums"])]
    path.write_bytes(w.build_model(
        nodes, {"image": (1, 3, 800, 800), "scale_factor": (1, 2)},
        {"boxes": (3, 6), "box_nums": (1,), "masks": (3, 50, 50)},
        {"boxes_c": boxes, "masks_c": masks, "nums_c": np.asarray([3], np.int32),
         "zero": np.asarray(0.0, np.float32)}))
    return path


def layout_s_graph(path: Path) -> Path:
    boxes = np.asarray([[22, 0.9, 10, 10, 290, 60], [11, 0.9, 11, 11, 289, 59]], np.float32)
    nodes = [w.encode_node("ReduceMean", ["image"], ["m"], {"keepdims": 0}),
             w.encode_node("Mul", ["m", "zero"], ["z"]),
             w.encode_node("Add", ["boxes_c", "z"], ["boxes"]),
             w.encode_node("Identity", ["nums_c"], ["box_nums"])]
    path.write_bytes(w.build_model(
        nodes, {"image": (1, 3, 480, 480), "scale_factor": (1, 2)},
        {"boxes": (2, 6), "box_nums": (1,)},
        {"boxes_c": boxes, "nums_c": np.asarray([2], np.int32),
         "zero": np.asarray(0.0, np.float32)}))
    return path


def layout_yolo_graph(path: Path) -> Path:
    preds = np.asarray([[[100, 356, 300, 456, 0.9, 0], [400, 556, 600, 656, 0.8, 8],
                         [0, 256, 50, 306, 0.1, 1]]], np.float32)
    nodes = [w.encode_node("ReduceMean", ["images"], ["m"], {"keepdims": 0}),
             w.encode_node("Mul", ["m", "zero"], ["z"]),
             w.encode_node("Add", ["preds_c", "z"], ["preds"])]
    path.write_bytes(w.build_model(
        nodes, {"images": (1, 3, 1024, 1024)}, {"preds": (1, 3, 6)},
        {"preds_c": preds, "zero": np.asarray(0.0, np.float32)}))
    return path


LAYOUTS = {
    "pp_doclayoutv3": (layout_v3_graph, {}),
    "pp_doclayout_s": (layout_s_graph, {}),
    "doclayout_docstructbench": (layout_yolo_graph, {"conf_threshold": 0.2}),
}


@pytest.mark.parametrize("model_type", list(LAYOUTS))
def test_onnx_layout_contract(tmp_path, model_type):
    """OnnxLayoutDetector on the V3, S and YOLO contracts: the port's dets
    equal the JAX package's (labels, categories, order, scores, polys and
    mask polygons), and the contract tests' own claims hold."""
    from rapiddoc_tpu.models.layout.onnx_engine import OnnxLayoutConfig as JaxConfig
    from rapiddoc_tpu.models.layout.onnx_engine import OnnxLayoutDetector as JaxDetector
    from rapiddoc_tpu.types import CategoryId

    from rapiddoc_tpu_torch.models.layout.onnx_engine import OnnxLayoutConfig, OnnxLayoutDetector

    make, extra = LAYOUTS[model_type]
    path = make(tmp_path / f"{model_type}.onnx")
    imgs = pages()
    if model_type == "doclayout_docstructbench":
        imgs = [np.full((512, 1024, 3), 255, np.uint8)] + imgs
    jdet = JaxDetector(path, JaxConfig(model_type=model_type, **extra))
    pdet = OnnxLayoutDetector(path, OnnxLayoutConfig(model_type=model_type, **extra), device="cpu")
    # the graphs emit one page's dets: one page a call
    got = [pdet.batch_predict([img])[0] for img in imgs]
    for g, img in zip(got, imgs):
        assert_dets_equal(g, jdet.batch_predict([img])[0])
    first = got[0]
    if model_type == "pp_doclayoutv3":
        assert [d["original_label"] for d in first] == ["doc_title", "table"]
        assert [d["original_order"] for d in first] == [0, 1]
        assert first[0]["category_id"] == CategoryId.Title
        assert first[1]["category_id"] == CategoryId.TableBody
        assert "polygon_points" in first[0]
        assert max(first[1]["poly"][0::2]) <= 300
    elif model_type == "pp_doclayout_s":
        by_label = {d["original_label"]: d for d in first}
        assert by_label["formula"]["category_id"] == CategoryId.InlineEquation
        assert all(d["original_order"] == -1 for d in first)
    else:
        assert [d["original_label"] for d in first] == ["title", "isolate_formula"]
        assert first[1]["category_id"] == CategoryId.InterlineEquation_YOLO
        x0, y0, _, _, x1, y1, _, _ = first[0]["poly"]
        assert (round(x0), round(y0), round(x1), round(y1)) == (100, 100, 300, 200)


def test_layout_low_conf_models_and_specs():
    from rapiddoc_tpu.models.layout import onnx_engine as jax_onnx

    from rapiddoc_tpu_torch.models.layout import onnx_engine

    assert onnx_engine.LOW_CONF_MODELS == jax_onnx.LOW_CONF_MODELS == {
        "pp_doclayout_s", "doclayout_docstructbench"}
    assert onnx_engine.MODEL_SPECS == jax_onnx.MODEL_SPECS


def test_layout_preprocessing_equals_jax(tmp_path):
    """The uint8 batches both detectors feed their graphs: INTER_CUBIC to
    the square input (the port's resize_cubic, within one level at IPP's
    rounding ties) and the YOLO letterbox (INTER_LINEAR, equal); the
    normalisation on the device equal to the JAX package's in-graph one."""
    import jax.numpy as jnp
    import torch

    from rapiddoc_tpu.models.layout.onnx_engine import OnnxLayoutConfig as JaxConfig
    from rapiddoc_tpu.models.layout.onnx_engine import OnnxLayoutDetector as JaxDetector

    from rapiddoc_tpu_torch.models.layout.onnx_engine import OnnxLayoutConfig, OnnxLayoutDetector

    for model_type, make in (("pp_doclayout_s", layout_s_graph),
                             ("doclayout_docstructbench", layout_yolo_graph)):
        path = make(tmp_path / f"{model_type}.onnx")
        jdet = JaxDetector(path, JaxConfig(model_type=model_type))
        pdet = OnnxLayoutDetector(path, OnnxLayoutConfig(model_type=model_type), device="cpu")
        jnorm, pnorm = jdet.fn.preproc[jdet._img_in], pdet.fn.preproc[pdet._img_in]
        fed = {}
        for name, det in (("jax", jdet), ("port", pdet)):
            real = det.fn

            def record(*arrays, real=real, name=name):
                fed[name] = arrays[0]
                return real(*arrays)

            det.fn = type("Rec", (), {"__call__": staticmethod(record),
                                      "input_names": real.input_names})()
            det.batch_predict(pages(1)[1:])
        a, b = fed["port"].astype(int), fed["jax"].astype(int)
        assert a.shape == b.shape
        if model_type == "doclayout_docstructbench":
            assert np.array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= 1 and (a != b).mean() < 1e-3
        x = fed["jax"]
        want = np.asarray(jnorm(jnp.asarray(x)))
        got = pnorm(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------- tables

def tied(tmp_path, name, out_specs, consts, in_shape, metadata=None) -> Path:
    path = tmp_path / name
    path.write_bytes(chip_smoke.tied_const_graph(w, out_specs, consts, in_shape, metadata))
    return path


def test_onnx_table_classifier_consensus(tmp_path):
    from rapiddoc_tpu.models.table.onnx_models import OnnxTableClassifier as JaxCls

    from rapiddoc_tpu_torch.models.table.onnx_models import OnnxTableClassifier

    p1 = tied(tmp_path, "paddle_cls.onnx", {"y": (1, 2)}, {"y": np.asarray([[5.0, 0.0]], np.float32)},
              (1, 3, 224, 224))
    p2 = tied(tmp_path, "q_cls.onnx", {"y": (1, 2)}, {"y": np.asarray([[0.0, 5.0]], np.float32)},
              (1, 3, 224, 224))
    img = np.full((300, 400, 3), 255, np.uint8)
    for args, expect in (((p1, None), ["wired"]), ((None, p2), ["wireless"]),
                         ((p1, p2), ["wireless"])):
        assert OnnxTableClassifier(*args, device="cpu")([img]) == JaxCls(*args)([img]) == expect


def test_table_and_orientation_preprocessing_equals_jax():
    """The host preprocessing of every ONNX table and orientation model
    equals the JAX package's cv2 calls: paddle_cls's INTER_LANCZOS4 short
    side and crop, q_cls's grey + INTER_LINEAR, SLANet's padded canvas,
    the orientation crop's float32 normalisation."""
    from rapiddoc_tpu.models.orientation.engine import OnnxOrientationClassifier as JaxOri
    from rapiddoc_tpu.models.table.onnx_models import OnnxTableClassifier as JaxCls
    from rapiddoc_tpu.models.table.onnx_models import OnnxWirelessStructure as JaxSla

    from rapiddoc_tpu_torch.models.orientation.engine import OnnxOrientationClassifier
    from rapiddoc_tpu_torch.models.table.onnx_models import (OnnxTableClassifier,
                                                             OnnxWirelessStructure)

    rng = np.random.default_rng(2)
    for shape in ((300, 400), (517, 260), (230, 1000)):
        img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        assert np.array_equal(OnnxTableClassifier._paddle_pre(img), JaxCls._paddle_pre(img))
        assert np.array_equal(OnnxTableClassifier._q_pre(img), JaxCls._q_pre(img))
        assert np.array_equal(OnnxWirelessStructure._pre(OnnxWirelessStructure, img),
                              JaxSla._pre(JaxSla, img))
        assert np.array_equal(OnnxOrientationClassifier._pre(img), JaxOri._pre(img))


def test_onnx_wired_table_structure(tmp_path):
    from rapiddoc_tpu.models.table.onnx_models import OnnxWiredTableStructure as JaxWired

    from rapiddoc_tpu_torch.models.table.onnx_models import OnnxWiredTableStructure

    p = tied(tmp_path, "unet.onnx", {"y": (1, 1024, 1024)},
             {"y": chip_smoke.wired_class_map().astype(np.float32)}, (1, 3, 1024, 1024))
    imgs = [np.full((512, 512, 3), 255, np.uint8), np.full((300, 700, 3), 255, np.uint8)]
    got = OnnxWiredTableStructure(p, device="cpu").batch(imgs)
    want = JaxWired(p).batch(imgs)
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    cells, grid = got[0]
    assert len(cells) == 4
    assert max(g[0] for g in grid) == 1 and max(g[1] for g in grid) == 1


def test_onnx_wireless_structure_contract(tmp_path):
    """tests/test_onnx_jax.py's slanet-plus contract: metadata characters,
    merge_no_span vocabulary, EOS stop, td boxes rescaled to pixels."""
    from rapiddoc_tpu.models.table.onnx_models import OnnxWirelessStructure as JaxSla

    from rapiddoc_tpu_torch.models.table.onnx_models import OnnxWirelessStructure

    raw_chars = ["<thead>", "</thead>", "<tbody>", "</tbody>", "<tr>", "</tr>", "<td>", "</td>"]
    probs = np.zeros((1, 6, 10), np.float32)
    for t, cid in enumerate([5, 8, 7, 9, 9, 9]):
        probs[0, t, cid] = 1.0
    bbox = np.zeros((1, 6, 8), np.float32)
    bbox[0, 1] = [0.1, 0.2, 0.5, 0.2, 0.5, 0.6, 0.1, 0.6]
    nodes = [w.encode_node("Identity", ["bbox_c"], ["bbox"]),
             w.encode_node("Identity", ["probs_c"], ["probs"])]
    data = w.build_model(nodes, {"x": (1, 3, 488, 488)}, {"bbox": (1,), "probs": (1,)},
                         {"bbox_c": bbox, "probs_c": probs})
    p = tmp_path / "slanet-plus.onnx"
    p.write_bytes(w.build_model_with_metadata(data, {"character": "\n".join(raw_chars)}))
    img = np.full((100, 200, 3), 255, np.uint8)
    got = OnnxWirelessStructure(p, device="cpu")([img])
    assert got == JaxSla(p)([img])
    [(structure, bboxes)] = got
    assert structure == ["<tr>", "<td></td>", "</td>"]
    np.testing.assert_allclose(bboxes[0], [20.0, 40.0, 100.0, 120.0], atol=1e-3)


# -------------------------------------------------------- orientation

def orientation_graph(tmp_path) -> Path:
    logits = np.zeros((1, 4), np.float32)
    logits[0, 2] = 9.0  # third label
    return tied(tmp_path, "rapid_orientation.onnx", {"y": (1, 4)}, {"y": logits},
                (1, 3, 224, 224), metadata={"character": "0\n90\n180\n270"})


def test_onnx_orientation_with_metadata_labels(tmp_path):
    from rapiddoc_tpu.models.orientation.engine import OnnxOrientationClassifier as JaxOri

    from rapiddoc_tpu_torch.models.orientation.engine import OnnxOrientationClassifier

    p = orientation_graph(tmp_path)
    imgs = [np.full((400, 300, 3), 255, np.uint8)]
    assert OnnxOrientationClassifier(p, device="cpu")(imgs) == JaxOri(p)(imgs) == [180]


def test_orientation_build_takes_the_onnx_where_the_jax_package_does(tmp_path):
    """build_orientation_classifier with no flax leaves and a published
    rapid_orientation.onnx in the models dir builds the ONNX classifier
    (it used to raise); with leaves it builds the net, in both packages."""
    from rapiddoc_tpu.models.orientation import engine as jax_engine

    from rapiddoc_tpu_torch.models.orientation.engine import (OnnxOrientationClassifier,
                                                              OrientationClassifier,
                                                              build_orientation_classifier)

    orientation_graph(tmp_path)
    got = build_orientation_classifier(tmp_path, None, device="cpu")
    want = jax_engine.build_orientation_classifier(tmp_path, None)
    assert isinstance(got, OnnxOrientationClassifier)
    assert isinstance(want, jax_engine.OnnxOrientationClassifier)
    img = [np.full((300, 500, 3), 200, np.uint8)]
    assert got(img) == want(img) == [180]
    from rapiddoc_tpu_torch.models.weights import load_npz
    from rapiddoc_tpu_torch.config import DEMO_ASSETS_DIR

    flat = load_npz(DEMO_ASSETS_DIR / "orientation_demo.npz")
    assert isinstance(build_orientation_classifier(tmp_path, flat, device="cpu"),
                      OrientationClassifier)


# ------------------------------------------------------------ sniffing

def test_guess_suffix_by_bytes_equals_jax():
    """Magika's routing suffix on the smoke's corpus, and magic bytes on
    inputs too short for the model, equal to the JAX package's."""
    from rapiddoc_tpu.utils.sniff import guess_suffix_by_bytes as jax_guess

    from rapiddoc_tpu_torch.utils.sniff import guess_suffix_by_bytes

    cases = dict(chip_smoke.magika_corpus())
    cases.update(short_pdf=b"%PDF-1", short_png=b"\x89PNG\r", gif=b"GIF89a" + bytes(16),
                 riff=b"RIFF\x10\x00\x00\x00WEBPVP8 " + bytes(8), empty=b"",
                 suffixless=chip_smoke.suffixless_bytes())
    for name, data in cases.items():
        assert guess_suffix_by_bytes(data, device="cpu") == jax_guess(data), name


def test_magika_load_policy(tmp_path, monkeypatch):
    """No model file in RAPIDDOC_MAGIKA_DIR: both packages route on magic
    bytes. A model file that does not load: the JAX package logs and uses
    magic bytes, the port raises."""
    import rapiddoc_tpu.utils.sniff as jax_sniff

    from rapiddoc_tpu_torch.utils import sniff

    zip_bytes = chip_smoke.magika_corpus()["docx"]
    try:
        monkeypatch.setenv("RAPIDDOC_MAGIKA_DIR", str(tmp_path))
        jax_sniff._load_model.cache_clear()
        sniff._load.cache_clear()
        assert sniff.magika_classify(zip_bytes, device="cpu") == ("unknown", 0.0)
        assert sniff.guess_suffix_by_bytes(zip_bytes, device="cpu") == \
            jax_sniff.guess_suffix_by_bytes(zip_bytes) == "docx"
        assert sniff.guess_suffix_by_bytes(b"just some text here", device="cpu") == ""
        (tmp_path / "model.onnx").write_bytes(b"\x08\x01 not a model")
        (tmp_path / "config.min.json").write_text("{}")
        jax_sniff._load_model.cache_clear()
        assert jax_sniff.guess_suffix_by_bytes(zip_bytes) == "docx"
        with pytest.raises(Exception):
            sniff.guess_suffix_by_bytes(zip_bytes, device="cpu")
    finally:
        monkeypatch.delenv("RAPIDDOC_MAGIKA_DIR")
        jax_sniff._load_model.cache_clear()
        sniff._load.cache_clear()


# ---------------------------------------------- the former raise sites

def port_parse(data: bytes) -> dict:
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    out = RapidDoc(device="cpu", dtype=torch.float32)(data, parse_method="ocr")
    return {"markdown": out.markdown, "content_list": out.content_list_json}


def jax_parse(data: bytes) -> dict:
    from rapiddoc_tpu import RapidDoc

    os.environ["RAPIDDOC_FP32_PARAMS"] = "1"
    try:
        out = RapidDoc()(data, parse_method="ocr")
    finally:
        del os.environ["RAPIDDOC_FP32_PARAMS"]
    return plain({"markdown": out.markdown, "content_list": out.content_list_json})


def onnx_layout_parse(jax: bool) -> dict:
    with both_stacks(RAPIDDOC_DISABLE_LAYOUT="") as models:
        del os.environ["RAPIDDOC_DISABLE_LAYOUT"]
        chip_smoke.write_onnx_layout(models)
        pdf = chip_smoke.onnx_layout_pdf()
        return jax_parse(pdf) if jax else port_parse(pdf)


def suffixless_parse(jax: bool) -> dict:
    from rapiddoc_tpu.utils.sniff import guess_suffix_by_bytes

    data = chip_smoke.suffixless_bytes()
    with both_stacks():
        out = jax_parse(data) if jax else port_parse(data)
    out["suffix"] = guess_suffix_by_bytes(data)
    return out


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN.read_text())


def test_rapiddoc_with_an_onnx_layout_equals_jax(golden):
    """A pp_doclayoutv3.onnx in the models dir (the layout fixture's golden
    dets of page 0, tied to the input): LayoutDetector.build takes it, as
    the JAX package's does, and the fp32 parse of the page equals the JAX
    package's (the committed golden, rebuilt by this file)."""
    from rapiddoc_tpu.models.layout.engine import LayoutDetector as JaxLayout

    from rapiddoc_tpu_torch.models.layout.engine import LayoutDetector
    from rapiddoc_tpu_torch.models.layout.onnx_engine import OnnxLayoutDetector

    with both_stacks() as models:
        chip_smoke.write_onnx_layout(models)
        for configs in ({}, {"model_type": "pp_doclayoutv3", "conf_thresh": 0.3}):
            got = LayoutDetector.build(configs, device="cpu")
            want = JaxLayout.build(configs)
            assert isinstance(got, OnnxLayoutDetector)
            assert vars(got.config) == vars(want.config)
    got = onnx_layout_parse(jax=False)
    want = golden["onnx_layout"]
    assert got["markdown"] == want["markdown"]
    assert got["content_list"] == want["content_list"]
    assert len(chip_smoke.onnx_layout_dets()) >= 8


def test_rapiddoc_on_suffixless_bytes_equals_jax(golden):
    """Bytes with no suffix that do not start with %PDF: Magika (the
    port's interpreter) calls them a PDF and the parse equals the JAX
    package's (the committed golden); before, the port raised."""
    from rapiddoc_tpu_torch.utils.sniff import guess_suffix_by_bytes

    data = chip_smoke.suffixless_bytes()
    assert data[:4] != b"%PDF"
    assert guess_suffix_by_bytes(data, device="cpu") == golden["suffixless"]["suffix"] == "pdf"
    got = suffixless_parse(jax=False)
    assert got["markdown"] == golden["suffixless"]["markdown"]
    assert got["content_list"] == golden["suffixless"]["content_list"]


def test_onnx_parse_golden_is_the_jax_package_s():
    """The committed parse golden is what the JAX package gives now."""
    fresh = build_golden()
    assert fresh == json.loads(GOLDEN.read_text())


def test_table_routing_with_onnx_models_beside_the_demo_checkpoints():
    """unet.onnx and q_cls.onnx in the models dir: the JAX package keeps
    its demo UNet and classifier (an ONNX model only fills a model still
    missing), and so does the port, where it used to raise; one table
    page parses to the JAX package's Markdown."""
    import torch

    from rapiddoc_tpu.models.table.engine import TableRecognizer as JaxTables
    from rapiddoc_tpu.models.table.unet import WiredTableStructure as JaxWired

    from rapiddoc_tpu_torch.models.table.cls import TableClassifier
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer
    from rapiddoc_tpu_torch.models.table.unet import WiredTableStructure

    with both_stacks(RAPIDDOC_DEMO_LAYOUT="1", RAPIDDOC_DISABLE_LAYOUT="",
                     RAPIDDOC_DISABLE_TABLE="") as models:
        for k in ("RAPIDDOC_DISABLE_LAYOUT", "RAPIDDOC_DISABLE_TABLE"):
            del os.environ[k]
        models = Path(models)
        (models / "unet.onnx").write_bytes(chip_smoke.tied_const_graph(
            w, {"y": (1, 1024, 1024)}, {"y": np.zeros((1, 1024, 1024), np.float32)},
            (1, 3, 1024, 1024)))
        (models / "q_cls.onnx").write_bytes(chip_smoke.tied_const_graph(
            w, {"y": (1, 2)}, {"y": np.asarray([[5.0, 0.0]], np.float32)}, (1, 3, 224, 224)))
        want = JaxTables.build({})
        got = TableRecognizer.build({}, device="cpu", dtype=torch.float32)
        assert isinstance(want.wired, JaxWired) and isinstance(got.wired, WiredTableStructure)
        assert type(want.classifier).__name__ == "TableClassifier"
        assert isinstance(got.classifier, TableClassifier)
        assert got.config.use_cls_model and want.config.use_cls_model
        from rapiddoc_tpu_torch.bench import build_pdf, page_images

        pdf = build_pdf(page_images((REPO / "rapiddoc_tpu_torch/assets/layout_smoke_doc.pdf")
                                    .read_bytes())[:1], 1)
        got_md = port_parse(pdf)["markdown"]
        want_md = jax_parse(pdf)["markdown"]
    assert "<table>" in got_md
    assert got_md == want_md


def test_table_routing_fills_a_missing_model_from_onnx(tmp_path, monkeypatch):
    """Where a demo checkpoint is missing, both packages take the ONNX
    model in its place: here the classifier from paddle_cls.onnx."""
    import torch

    import rapiddoc_tpu.models.registry as jax_registry
    import rapiddoc_tpu_torch.models.table.engine as port_engine

    from rapiddoc_tpu_torch.models.table.onnx_models import OnnxTableClassifier

    demo = tmp_path / "demo"
    demo.mkdir()
    for key in ("unet", "slanet", "unitable"):
        (demo / f"table_{key}_demo.npz").symlink_to(
            port_engine.DEMO_ASSETS_DIR / f"table_{key}_demo.npz")
    models = tmp_path / "models"
    models.mkdir()
    (models / "paddle_cls.onnx").write_bytes(chip_smoke.tied_const_graph(
        w, {"y": (1, 2)}, {"y": np.asarray([[0.0, 5.0]], np.float32)}, (1, 3, 224, 224)))
    monkeypatch.setattr(port_engine, "DEMO_ASSETS_DIR", demo)
    monkeypatch.setattr(jax_registry, "DEMO_ASSETS_DIR", demo)
    from rapiddoc_tpu.models.table.engine import TableRecognizer as JaxTables

    with held_env(RAPIDDOC_MODELS_DIR=str(models)):
        want = JaxTables.build({})
        got = port_engine.TableRecognizer.build({}, device="cpu", dtype=torch.float32)
    assert type(want.classifier).__name__ == "OnnxTableClassifier"
    assert isinstance(got.classifier, OnnxTableClassifier)
    assert got.config.use_cls_model == want.config.use_cls_model is False
    crop = np.full((120, 200, 3), 255, np.uint8)
    assert got.kinds([crop]) == want.classifier([crop]) == ["wireless"]


# -------------------------------------------------------------- golden

def build_golden() -> dict:
    """The JAX package's fp32 parses for the smoke's onnx phase."""
    return {"onnx_layout": onnx_layout_parse(jax=True), "suffixless": suffixless_parse(jax=True)}


if __name__ == "__main__":
    GOLDEN.write_text(json.dumps(build_golden(), indent=1, ensure_ascii=False) + "\n")
    print("wrote", GOLDEN)
