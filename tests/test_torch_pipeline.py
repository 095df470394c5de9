"""The port's host stages against the JAX package's.

On the golden's per-page model output (``pipeline_smoke_golden.json``,
the JAX package's in fp32 and in bf16), the port's ``build_page_infos``,
``finalize_middle_json`` and ``union_make`` must give the JAX package's
middle json, content list and Markdown exactly, and so must the JAX
package's own host stages give the golden's. The JAX package's analyzer
on the fixture's first page must give the golden's first model output,
which ties the golden to the models. The reading-order sorts (xycut and
xycut v3) and ``para_split`` must agree with the JAX package's on seeded
random boxes and blocks.
"""
import copy
import json
from pathlib import Path

import numpy as np
import pytest

from rapiddoc_tpu.pipeline import middle as jax_middle
from rapiddoc_tpu.pipeline import mkcontent as jax_mkcontent
from rapiddoc_tpu.pipeline import para as jax_para
from rapiddoc_tpu.reading_order import xycut as jax_xycut
from rapiddoc_tpu.reading_order import xycut_v3 as jax_xycut_v3
from rapiddoc_tpu_torch.pipeline import middle, mkcontent, para
from rapiddoc_tpu_torch.reading_order import xycut, xycut_v3
from rapiddoc_tpu_torch.types import MakeMode

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
GOLDEN = json.loads((ASSETS / "pipeline_smoke_golden.json").read_text())
PDF = (ASSETS / "ocr_smoke_doc.pdf").read_bytes()


def page_dims() -> list[tuple[float, float]]:
    from rapiddoc_tpu_torch.pdfio import open_pdf

    doc = open_pdf(PDF)
    return [doc.get_page(i).size for i in range(len(doc))]


def host_stages(mid, mk, model_infos: list[dict], window: int) -> dict:
    """model output -> middle json, content list and Markdown, assembled
    in windows of ``window`` pages as RapidDoc's loop assembles them."""
    dims = page_dims()
    scale = GOLDEN["dpi"] / 72.0
    infos = []
    for start in range(0, len(model_infos), window):
        part = copy.deepcopy(model_infos[start:start + window])
        infos += mid.build_page_infos(part, dims[start:start + window], [scale] * len(part),
                                      parse_mode="ocr", page_idx_offset=start)
    middle_json = json.loads(json.dumps(mid.finalize_middle_json(infos, "ocr")))
    return {
        "middle_json": middle_json,
        "content_list": mk.union_make(middle_json["pdf_info"], "content_list", "images"),
        "markdown": mk.union_make(middle_json["pdf_info"], "mm_markdown", "images"),
    }


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
@pytest.mark.parametrize("window", [3, 1])
def test_host_stages_equal_jax_on_the_golden_model_output(policy, window):
    got = host_stages(middle, mkcontent, GOLDEN[policy]["model_info"], window)
    want = host_stages(jax_middle, jax_mkcontent, GOLDEN[policy]["model_info"], window)
    assert got == want
    for key in ("middle_json", "content_list", "markdown"):
        assert want[key] == GOLDEN[policy][key]


def test_make_modes_are_the_jax_package_s():
    assert MakeMode.MM_MD == "mm_markdown" and MakeMode.CONTENT_LIST == "content_list"


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_golden_first_page_model_info_matches_jax_package(policy):
    """The JAX package's analyzer on the first page alone gives the
    golden's first model output: dets, boxes and texts equal, scores
    within 1e-4 (the rec batches hold one page's crops here, three
    pages' there)."""
    test_api = _load_test_module("test_torch_api")
    from rapiddoc_tpu.models.registry import build_analyzer

    page, boxes = test_api.jax_render(PDF, GOLDEN["dpi"])[0]
    with test_api.jax_env(policy == "fp32"):
        got = test_api.plain(build_analyzer().analyze_pages(
            [page], ["ocr"], [None], [boxes], [GOLDEN["dpi"] / 72.0])[0])
    want = GOLDEN[policy]["model_info"][0]
    assert len(got["layout_dets"]) == len(want["layout_dets"]) > 20
    for g, w in zip(got["layout_dets"], want["layout_dets"]):
        assert {k: v for k, v in g.items() if k != "score"} == \
            {k: v for k, v in w.items() if k != "score"}
        assert abs(g["score"] - w["score"]) <= 1e-4


def _load_test_module(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"_{name}", Path(__file__).parent / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def random_boxes(rng: np.random.Generator, n: int, w: float = 600, h: float = 800) -> list:
    x0 = rng.uniform(0, w * 0.8, n)
    y0 = rng.uniform(0, h * 0.9, n)
    return [[float(a), float(b), float(a + rng.uniform(10, w * 0.5)), float(b + rng.uniform(8, 60))]
            for a, b in zip(x0, y0)]


@pytest.mark.parametrize("seed", range(6))
def test_xycut_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 2, 7, 25, 60):
        boxes = random_boxes(rng, n)
        assert xycut.sort_boxes_reading_order(boxes) == jax_xycut.sort_boxes_reading_order(boxes)


def _line(x0, y0, x1, y1, text):
    return {"bbox": [x0, y0, x1, y1],
            "spans": [{"content": text, "type": "text", "bbox": [x0, y0, x1, y1]}]}


def random_blocks(rng: np.random.Generator, n: int) -> list[dict]:
    """Text blocks of 1-5 lines in one or two columns, with some titles,
    list-like ragged edges and numbered lines."""
    words = "alpha beta gamma delta results method figure table 1. 2. (a) see".split()
    blocks = []
    y = 40.0
    for i in range(n):
        col = int(rng.integers(0, 2))
        x0 = 50.0 + col * 280.0 + float(rng.uniform(-5, 5))
        lines = []
        for _ in range(int(rng.integers(1, 6))):
            width = float(rng.uniform(80, 250))
            text = " ".join(rng.choice(words, int(rng.integers(2, 9))))
            if rng.random() < 0.5:
                text += "."
            lines.append(_line(x0, y, x0 + width, y + 12, text))
            y += 14.0
        y += float(rng.uniform(4, 30))
        if y > 760:
            y = 40.0
        bbox = [min(ln["bbox"][0] for ln in lines), min(ln["bbox"][1] for ln in lines),
                max(ln["bbox"][2] for ln in lines), max(ln["bbox"][3] for ln in lines)]
        kind = "title" if rng.random() < 0.15 else "text"
        blocks.append({"type": kind, "bbox": bbox, "bbox_fs": list(bbox), "lines": lines,
                       "index": i, "original_label": kind})
    return blocks


@pytest.mark.parametrize("seed", range(6))
def test_xycut_v3_equals_jax(seed):
    rng = np.random.default_rng(100 + seed)
    for n in (1, 3, 12, 30):
        blocks = random_blocks(rng, n)
        assert xycut_v3.sort_blocks_v3(copy.deepcopy(blocks), 600, 800) == \
            jax_xycut_v3.sort_blocks_v3(copy.deepcopy(blocks), 600, 800)


@pytest.mark.parametrize("seed", range(6))
def test_para_split_equals_jax(seed):
    rng = np.random.default_rng(200 + seed)
    pages = [{"page_idx": i, "page_size": [600, 800], "preproc_blocks": random_blocks(rng, 14)}
             for i in range(3)]
    got, want = copy.deepcopy(pages), copy.deepcopy(pages)
    para.para_split(got)
    jax_para.para_split(want)
    assert got == want
    assert any(p.get("para_blocks") for p in got)

