"""The port's table stage with an OCR system inside it against the JAX
package's, on the CPU.

``TableRecognizer(ocr_system=...)``: rotation detection over portrait
crops (one batched det call), the batched word-box OCR over every crop,
the cell text assignment (word items, line items, the CJK join,
``normalize_cell_text``), the blank-cell retry, ``use_compare_table``'s
arbitration with the OCR texts and the borderless extract for tables
every model left empty. The crops are the 15 of
``rapiddoc_tpu_torch/assets/table_smoke_crops.npz`` and two more in
``table_ocr_crops.npz``: a portrait crop of narrow upright glyphs
stacked in columns, on which the demo det finds tall boxes (rotation
detection fires), and a borderless text grid. The golden
(``table_ocr_golden.json``) holds the JAX package's HTML for every crop
with the demo table checkpoints and the demo OCR system, in fp32 and
bf16, for four configurations: the default (rotation on, retry off),
``enable_blank_cell_rec``, ``use_compare_table``, and the wired model
alone (``strategy="unet"``), where the UNet finds no cell in the text
grid and the borderless extract builds its table (the classifier sends
such a grid to SLANet otherwise). fp32 HTML must be equal; bf16 is held
to the band ``chip_smoke.py`` sets for the card.

``python tests/test_torch_table_ocr.py`` rebuilds both files with the
JAX package (needs PIL and fonts; about 5 minutes); ``--compare`` prints
the port's bf16 reading on the CPU against the bf16 golden (the source
of the smoke's ``TABLE_OCR_BF16`` band).
"""
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
CROPS_NPZ = ASSETS / "table_smoke_crops.npz"
EXTRA_NPZ = ASSETS / "table_ocr_crops.npz"
GOLDEN_JSON = ASSETS / "table_ocr_golden.json"
CONFIGS = {
    "default": {},
    "blank": {"enable_blank_cell_rec": True},
    "compare": {"use_compare_table": True},
    "wired_only": {"strategy": "unet"},
}
MODES = ("fp32", "bf16")
# the crops each configuration is checked on in fp32: every crop for the
# default, elsewhere the crops where the configuration changes the HTML
# (the text grid's borderless table is checked on its own)
CHECKED = {
    "default": tuple(range(17)),
    "blank": (1, 6, 7, 8),
    "compare": (0, 2, 3, 8),
    "wired_only": (13, 14, 15),
}


def stacked_glyphs() -> np.ndarray:
    """A portrait crop: 3 columns of 8 narrow upright glyphs stacked with
    4 px gaps (render_line at height 40)."""
    from rapiddoc_tpu.train.synth import render_line

    rng = random.Random(0)
    glyphs = [render_line(ch, rng, height=40) for ch in "17Il"]
    img = np.full((40 + 8 * 44, 40 + 3 * 80, 3), 255, np.uint8)
    for c in range(3):
        for r in range(8):
            g = glyphs[rng.randrange(len(glyphs))]
            gh, gw = g.shape[0], min(g.shape[1], 60)
            y, x = 20 + r * 44, 20 + c * 80
            img[y:y + gh, x:x + gw] = np.minimum(img[y:y + gh, x:x + gw], g[:, :gw])
    return img


def text_grid() -> np.ndarray:
    """A borderless 5x4 text grid of one-word cells, no rules."""
    from rapiddoc_tpu.train.synth import random_text, render_line

    rng = random.Random(2)
    img = np.full((30 + 5 * 45, 40 + 4 * 160, 3), 255, np.uint8)
    for r in range(5):
        for c in range(4):
            text = random_text(rng, max_words=1)[:7].strip() or "ab"
            line = render_line(text, rng, height=28)
            h, w = line.shape[0], min(line.shape[1], 120)
            y, x = 15 + r * 45, 20 + c * 160
            img[y:y + h, x:x + w] = line[:, :w]
    return img


def make_extra() -> dict[str, np.ndarray]:
    return {"stacked_glyphs": stacked_glyphs(), "text_grid": text_grid()}


def load_crops() -> list[np.ndarray]:
    """The 15 table crops, then the two of table_ocr_crops.npz."""
    with np.load(CROPS_NPZ) as z:
        crops = [z[f"crop_{i}"] for i in range(15)]
    with np.load(EXTRA_NPZ) as z:
        crops += [z["stacked_glyphs"], z["text_grid"]]
    return crops


class held_env:
    """Every RAPIDDOC_*/MINERU_* setting held off (other test files set
    some when imported), plus RAPIDDOC_FP32_PARAMS=1 for fp32."""

    def __init__(self, mode: str):
        self.mode = mode

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items()
                      if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        if self.mode == "fp32":
            os.environ["RAPIDDOC_FP32_PARAMS"] = "1"
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


def jax_recognizer(config: dict):
    """The JAX package's demo table recognizer with its demo OCR system
    inside (built in the caller's environment)."""
    from rapiddoc_tpu.models.registry import build_ocr_system
    from rapiddoc_tpu.models.table.engine import TableRecognizer

    rec = TableRecognizer.build(dict(config))
    rec.ocr = build_ocr_system()
    return rec


def jax_tables(crops: list[np.ndarray], mode: str) -> dict[str, list[str]]:
    with held_env(mode):
        return {name: jax_recognizer(cfg).batch_predict(crops) for name, cfg in CONFIGS.items()}


def port_recognizer(config: dict, mode: str, ocr=None, device: str = "cpu"):
    """The port's demo table recognizer with its demo OCR system (or
    ``ocr``) inside, as jax_recognizer builds the JAX package's."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer

    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16}[mode]
    with held_env("bf16"):
        rec = TableRecognizer.build(dict(config), device=device, dtype=dtype)
        rec.ocr = ocr or build_ocr_system(device=device, dtype=dtype)
    return rec


def make_golden(crops: list[np.ndarray]) -> dict:
    from rapiddoc_tpu.models.registry import build_ocr_system
    from rapiddoc_tpu.models.table.select import detect_table_rotations

    with held_env("fp32"):
        rotations = detect_table_rotations(crops, build_ocr_system().detector)
    return {
        "source": "rapiddoc_tpu TableRecognizer.build(config) with build_ocr_system() "
                  "inside, on the CPU, on table_smoke_crops.npz + table_ocr_crops.npz; "
                  "rebuilt by tests/test_torch_table_ocr.py",
        "rotations": rotations,
        **{mode: jax_tables(crops, mode) for mode in MODES},
    }


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def crops() -> list[np.ndarray]:
    return load_crops()


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_table as tt

    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def ocr_fp32():
    """The port's demo OCR system in fp32, shared by this file's tests."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    with held_env("bf16"):
        return build_ocr_system(device="cpu", dtype=torch.float32)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


def test_extra_crops_match_committed():
    with np.load(EXTRA_NPZ) as z:
        for name, img in make_extra().items():
            assert np.array_equal(z[name], img), name


def test_golden_exercises_rotation_and_borderless(crops, golden, ocr_fp32, monkeypatch):
    """The fixture reaches both paths: exactly the stacked-glyph crop
    rotates, and with the wired model alone the text grid's table is the
    borderless extract's, from the port's OCR boxes as from the JAX
    package's."""
    from rapiddoc_tpu_torch.models.table import img2table

    assert golden["rotations"] == [False] * 15 + [True, False]
    built = []
    real = img2table.borderless_table_extract

    def spy(items, shape):
        built.append(real(items, shape))
        return built[-1]

    monkeypatch.setattr(img2table, "borderless_table_extract", spy)
    got = port_recognizer(CONFIGS["wired_only"], "fp32", ocr_fp32).batch_predict([crops[16]])
    assert built and built[-1] and got == [built[-1]] == golden["fp32"]["wired_only"][16:]


def test_detect_table_rotations_equal_jax(crops, golden, ocr_fp32):
    """One batched det call over the portrait candidates: the same
    decision per crop as the JAX package's, in fp32."""
    from rapiddoc_tpu.models.registry import build_ocr_system as jax_build
    from rapiddoc_tpu.models.table.select import detect_table_rotations as jax_rot

    from rapiddoc_tpu_torch.models.table.select import detect_table_rotation, detect_table_rotations

    det = ocr_fp32.detector
    got = detect_table_rotations(crops, det)
    with held_env("fp32"):
        want = jax_rot(crops, jax_build().detector)
    assert got == want == golden["rotations"]
    assert detect_table_rotation(crops[15], det) is True
    assert detect_table_rotations(crops, None) == [False] * len(crops)


def _items(rng: np.random.Generator, rows: int, cols: int) -> list:
    """OCR items of a rows x cols grid of words, jittered, some spanning."""
    items = []
    for r in range(rows):
        for c in range(cols):
            if rng.random() < 0.15:
                continue
            x0 = 20 + c * 150 + rng.uniform(-4, 4)
            w = rng.uniform(40, 110) + (150 if rng.random() < 0.1 else 0)
            y0 = 10 + r * 40 + rng.uniform(-3, 3)
            items.append(([x0, y0, x0 + w, y0 + rng.uniform(18, 26)], f"w{r}{c}"))
    return items


@pytest.mark.parametrize("seed", range(6))
def test_borderless_table_extract_equals_jax(seed):
    """``borderless_table_extract`` (rows by y-overlap, columns by shared
    whitespace corridors, colspans) equal to the JAX package's on seeded
    word grids, and its rejection of plain text and of too few items."""
    from rapiddoc_tpu.models.table import img2table as jax_i2t

    from rapiddoc_tpu_torch.models.table import img2table as i2t

    rng = np.random.default_rng(seed)
    rows, cols = int(rng.integers(2, 7)), int(rng.integers(1, 5))
    items = _items(rng, rows, cols)
    shape = (20 + rows * 40, 40 + cols * 150)
    got = i2t.borderless_table_extract(items, shape)
    assert got == jax_i2t.borderless_table_extract(items, shape)
    assert i2t._cluster_rows(items) == jax_i2t._cluster_rows(items)
    prose = [([10, 10 + 30 * i, 600, 34 + 30 * i], "a line of running text") for i in range(6)]
    assert i2t.borderless_table_extract(prose, (200, 620)) == ""
    assert i2t.borderless_table_extract(items[:3], shape) == ""


class StubOCR:
    """A deterministic OCR stand-in: each crop gives one line whose text
    names the crop's size, empty for crops under 12 px high."""

    def __call__(self, crops, return_word_boxes=False):
        return [[] if c.shape[0] < 12 else
                [{"box": [[0, 0], [c.shape[1], 0], [c.shape[1], c.shape[0]], [0, c.shape[0]]],
                  "text": f"h{c.shape[0]} w{c.shape[1]}", "score": 0.9}] for c in crops]


def test_blank_cell_retry_equals_jax(crops):
    """``_retry_blank_cells`` on a wired crop's cells, some blank: the same
    cells retried and the same texts as the JAX package's."""
    from rapiddoc_tpu.models.table.engine import TableConfig as JaxConfig
    from rapiddoc_tpu.models.table.engine import TableRecognizer as JaxRecognizer

    from rapiddoc_tpu_torch.models.table.engine import TableConfig, TableRecognizer

    crop = crops[1]
    h, w = crop.shape[:2]
    rng = np.random.default_rng(0)
    boxes, texts = [], []
    for k in range(12):
        x0, y0 = rng.uniform(0, w - 20), rng.uniform(0, h - 8)
        boxes.append([x0, y0, x0 + rng.uniform(2, 60), y0 + rng.uniform(2, 40)])
        texts.append("" if k % 3 else "kept")
    jax = JaxRecognizer.__new__(JaxRecognizer)
    jax.config, jax.ocr = JaxConfig(enable_blank_cell_rec=True), StubOCR()
    port = TableRecognizer.__new__(TableRecognizer)
    port.config, port.ocr, port.fallbacks = TableConfig(enable_blank_cell_rec=True), StubOCR(), 0
    got = port._retry_blank_cells(crop, boxes, list(texts))
    assert got == jax._retry_blank_cells(crop, boxes, list(texts))
    assert got != texts


def test_port_raises_where_its_own_ocr_fails(crops, ocr_fp32, monkeypatch):
    """A failing rec of the port's own TextSystem reaches the caller, with
    no fallback taken. A custom OCR object keeps the JAX package's
    fallback around the batched call (counted in ``fallbacks``); its
    per-table call then raises, as in the JAX package."""
    from rapiddoc_tpu.models.table.engine import TableRecognizer as JaxRecognizer

    from rapiddoc_tpu_torch.models.ocr.engine import TextRecognizer

    def broken(*args, **kwargs):
        raise RuntimeError("rec head failed")

    rec = port_recognizer({}, "fp32", ocr_fp32)
    monkeypatch.setattr(TextRecognizer, "__call__", broken)
    with pytest.raises(RuntimeError, match="rec head failed"):
        rec.batch_predict([crops[0]])
    assert rec.fallbacks == 0
    rec.ocr = broken
    with pytest.raises(RuntimeError, match="rec head failed"):
        rec.batch_predict([crops[0]])
    assert rec.fallbacks == 1
    with held_env("fp32"):
        jax = JaxRecognizer.build({})
    jax.ocr = broken
    with pytest.raises(RuntimeError, match="rec head failed"):
        jax.batch_predict([crops[0]])


@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_port_fp32_tables_equal_golden(crops, golden, ocr_fp32, config):
    """The HTML of the port's TableRecognizer(ocr_system=...) in fp32 equal
    to the JAX package's on the configuration's CHECKED crops, with no
    fallback taken."""
    rec = port_recognizer(CONFIGS[config], "fp32", ocr_fp32)
    idx = CHECKED[config]
    assert rec.batch_predict([crops[i] for i in idx]) == [golden["fp32"][config][i] for i in idx]
    assert rec.fallbacks == 0


def compare() -> dict:
    """The port's bf16 reading on the CPU against the bf16 golden, and the
    JAX package's fp32 against its bf16, for every configuration."""
    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    crops = load_crops()
    out = {}
    for name, cfg in CONFIGS.items():
        got = port_recognizer(cfg, "bf16").batch_predict(crops)
        out[name] = {"port_bf16_cpu": smoke.compare_tables(got, golden["bf16"][name]),
                     "jax_fp32_vs_bf16": smoke.compare_tables(golden["fp32"][name],
                                                              golden["bf16"][name])}
    return out


if __name__ == "__main__":
    # Rewrites table_ocr_crops.npz and the golden; with --compare, prints
    # compare() instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(), indent=1))
    else:
        np.savez_compressed(EXTRA_NPZ, **make_extra())
        GOLDEN_JSON.write_text(json.dumps(make_golden(load_crops()), indent=1) + "\n")
        print("wrote", EXTRA_NPZ, GOLDEN_JSON)
