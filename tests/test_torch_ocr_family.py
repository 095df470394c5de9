"""The rest of the port's OCR family against the JAX package's, on the CPU.

- Word geometry: ``CTCLabelDecoder.decode_with_positions``,
  ``split_words``, ``word_boxes_in_crop`` equal to the JAX package's;
  ``map_crop_box_to_quad`` (the port's ``getPerspectiveTransform`` and
  ``perspectiveTransform``) equal to cv2's within 1e-4 px.
- The full-depth device normalisers, on RGB and 8-bit luma batches.
- The OCR knobs: ``RAPIDDOC_RGB_TRANSFER=1``, ``RAPIDDOC_DET_WIRE_BITS=8``,
  ``RAPIDDOC_DET_PROB_BITS=8``, ``RAPIDDOC_REC_WIRE_BITS=8``,
  ``RAPIDDOC_CONTRAST_STRETCH=0`` and ``=1`` and ``Det.limit_side_len``
  640 and 1280, each on the OCR fixture's pages: fp32 texts equal, box
  corners and scores as the golden rounds them.
- K1's plain version at V = 91 (the Cyrillic demo) and 18 710 (the
  published dictionary): ids equal to the JAX package's
  ``ctc_head_decode`` (the Pallas kernel in interpret mode).
- The registry's routing: ``lang="ru"`` (the in-repo demo rec and its
  dictionary), per-language files in the models dir, weights without
  their dictionary (refused with the warning), and published-format
  ``ocr_det_v6_small.npz`` / ``ocr_rec_v6_small.npz`` in a models dir
  (``chip_smoke.write_published_ocr``: the demo det's leaves, and the demo
  rec's backbone and neck under a head of the published width from a
  seed, since a random-init det finds one box a page and a random-init
  rec emits only blanks). The published rec's texts on the fixture page's
  lines equal the golden's, which the JAX package's rec gives with its
  fused head, as on its TPU.
- ``RapidDoc(lang="ru")`` on the committed Cyrillic image-only fixture
  (``ocr_ru_doc.pdf``) with layout, formula and table off: fp32 Markdown
  equal to the JAX package's.
- ``TextSystem(..., return_word_boxes=True)``: words equal, polygons
  within 1e-4 px of the JAX package's.

The golden (``ocr_family_golden.json``) holds the JAX package's outputs
in fp32 and bf16. ``python tests/test_torch_ocr_family.py`` rebuilds
the fixture and the golden (needs the JAX package, PIL and fonts; about
6 minutes); ``--compare`` prints the port's bf16 readings on the CPU
against the bf16 golden (the source of the smoke's bands).
"""
import importlib.util
import json
import logging
import os
import random
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
PAGES_NPZ = ASSETS / "ocr_smoke_pages.npz"
RU_PDF = ASSETS / "ocr_ru_doc.pdf"
GOLDEN_JSON = ASSETS / "ocr_family_golden.json"
PDF_DPI = 144
RU_SEEDS = (77, 78)
MODES = ("fp32", "bf16")
# name -> (environment, OCR config)
KNOBS = {
    "rgb_transfer": ({"RAPIDDOC_RGB_TRANSFER": "1"}, {}),
    "det_wire_8": ({"RAPIDDOC_DET_WIRE_BITS": "8"}, {}),
    "det_prob_8": ({"RAPIDDOC_DET_PROB_BITS": "8"}, {}),
    "rec_wire_8": ({"RAPIDDOC_REC_WIRE_BITS": "8"}, {}),
    "stretch_0": ({"RAPIDDOC_CONTRAST_STRETCH": "0"}, {}),
    "stretch_1": ({"RAPIDDOC_CONTRAST_STRETCH": "1"}, {}),
    "limit_640": ({}, {"Det.limit_side_len": 640}),
    "limit_1280": ({}, {"Det.limit_side_len": 1280}),
}
WORD_PAGES = (0, 2)  # an upright page and the tilted one (crop_quad's warp)
DIGITS = 4
POLY_DIGITS = 6


def ru_pages() -> list[np.ndarray]:
    """Two 640x480 pages of isolated Cyrillic lines, composed as
    tests/test_ocr_lang.py composes its page."""
    from rapiddoc_tpu.train.synth import random_text_lang, render_line

    pages = []
    for seed in RU_SEEDS:
        rng = random.Random(seed)
        page = np.full((640, 480, 3), 255, np.uint8)
        y = 30
        while y < 560:
            text = random_text_lang(rng, "ru", max_words=3)[:24].strip()
            if not text:
                continue
            line = render_line(text, rng, height=32)
            h, w = line.shape[0], min(line.shape[1], 440)
            page[y:y + h, 20:20 + w] = line[:, :w]
            y += h + 26
        pages.append(page)
    return pages


def make_ru_pdf() -> bytes:
    from PIL import Image

    from rapiddoc_tpu import pdfio

    return pdfio.images_to_pdf([Image.fromarray(p) for p in ru_pages()], dpi=PDF_DPI)


def fixture_pages() -> list[np.ndarray]:
    with np.load(PAGES_NPZ) as z:
        return list(z["pages"])


class held_env:
    """Every RAPIDDOC_*/MINERU_* setting held off (other test files set
    some when imported), then ``extra``; RAPIDDOC_FP32_PARAMS=1 in fp32
    for the JAX package."""

    def __init__(self, mode: str = "bf16", **extra: str):
        self.mode, self.extra = mode, extra

    def __enter__(self):
        self.saved = {k: v for k, v in os.environ.items()
                      if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in self.saved:
            del os.environ[k]
        if self.mode == "fp32":
            os.environ["RAPIDDOC_FP32_PARAMS"] = "1"
        os.environ.update(self.extra)
        return self

    def __exit__(self, *exc):
        for k in [k for k in os.environ if k.startswith(("RAPIDDOC_", "MINERU_"))]:
            del os.environ[k]
        os.environ.update(self.saved)


def rounded(out: list[list[dict]]) -> list[list[dict]]:
    """OCR output as the golden stores it: boxes, scores to DIGITS
    decimals, word polygons to POLY_DIGITS."""
    pages = []
    for page in out:
        items = []
        for it in page:
            item = {
                "box": np.round(np.asarray(it["box"], np.float64), DIGITS).tolist(),
                "det_score": round(float(it["det_score"]), DIGITS),
                "text": it["text"],
                "score": round(float(it["score"]), DIGITS),
            }
            if "words" in it:
                item["words"] = [
                    {"word": w["word"], "score": round(float(w["score"]), DIGITS),
                     "poly": np.round(np.asarray(w["poly"], np.float64), POLY_DIGITS).tolist()}
                    for w in it["words"]
                ]
            items.append(item)
        pages.append(items)
    return pages


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _TPUBackendView:
    """The ``jax`` module as the JAX package's OCR engine sees it on its
    TPU, where the rec takes the fused head (K1) at every vocabulary
    width; off a TPU it takes the plain fp32 head above 4096 classes.
    The fused head itself still runs in interpret mode here."""

    def __init__(self, mod):
        self._mod = mod

    def __getattr__(self, name):
        return getattr(self._mod, name)

    @staticmethod
    def default_backend() -> str:
        return "tpu"


def published_lines(page: np.ndarray, boxes: list) -> list[np.ndarray]:
    from rapiddoc_tpu_torch.models.ocr.engine import crop_quad

    return [crop_quad(page, np.asarray(b, np.float32)) for b in boxes]


# ---------------------------------------------------------------- golden


def jax_ru(pdf: bytes, mode: str) -> dict:
    from rapiddoc_tpu import RapidDoc
    from rapiddoc_tpu.api import ModelStack

    off = {f"RAPIDDOC_DISABLE_{k}": "1" for k in ("LAYOUT", "FORMULA", "TABLE")}
    with held_env(mode, **off):
        ModelStack._instances.clear()
        out = RapidDoc(lang="ru")(pdf, parse_method="ocr")
        ModelStack._instances.clear()
    return {"markdown": out.markdown,
            "lines": [d.get("text", "") for p in out.model_json for d in p["layout_dets"]]}


def jax_knobs(pages: list[np.ndarray], mode: str) -> dict:
    from rapiddoc_tpu.models.registry import build_ocr_system

    out = {}
    for name, (env, cfg) in KNOBS.items():
        with held_env(mode, **env):
            out[name] = rounded(build_ocr_system(dict(cfg))(pages))
    return out


def jax_words(pages: list[np.ndarray], mode: str) -> list:
    from rapiddoc_tpu.models.registry import build_ocr_system

    with held_env(mode):
        return rounded(build_ocr_system()([pages[i] for i in WORD_PAGES],
                                          return_word_boxes=True))


def jax_published(lines: list[np.ndarray], mode: str) -> dict:
    """The JAX package's published-format rec (read from a models dir that
    chip_smoke.write_published_ocr filled) on ``lines``, with its fused
    head as on its TPU."""
    from rapiddoc_tpu.models.ocr import engine as jax_engine
    from rapiddoc_tpu.models.registry import build_ocr_system

    smoke = _chip_smoke()
    real = jax_engine.jax
    with tempfile.TemporaryDirectory() as d, held_env(mode, RAPIDDOC_MODELS_DIR=d):
        smoke.write_published_ocr(Path(d))
        jax_engine.jax = _TPUBackendView(real)
        try:
            system = build_ocr_system()
            res = system.recognizer(lines)
        finally:
            jax_engine.jax = real
    assert len(system.recognizer.decoder.chars) == smoke.PUBLISHED_V
    return {"texts": [r.text for r in res], "scores": [round(r.score, DIGITS) for r in res]}


def make_golden(pdf: bytes) -> dict:
    pages = fixture_pages()
    ocr_golden = json.loads((ASSETS / "ocr_smoke_golden.json").read_text())
    boxes = [it["box"] for it in ocr_golden["fp32"][0]]
    lines = published_lines(pages[0], boxes)
    return {
        "source": "rapiddoc_tpu on the CPU: RapidDoc(lang='ru') on ocr_ru_doc.pdf (layout, "
                  "formula and table off); build_ocr_system(config) under each OCR knob and "
                  "with return_word_boxes on ocr_smoke_pages.npz; the published-format rec "
                  "on page 0's golden lines; rebuilt by tests/test_torch_ocr_family.py",
        "ru": {m: jax_ru(pdf, m) for m in MODES},
        "knobs": {m: jax_knobs(pages, m) for m in MODES},
        "words": {m: jax_words(pages, m) for m in MODES},
        "published": {"boxes": boxes, **{m: jax_published(lines, m) for m in MODES}},
    }


# ----------------------------------------------------------------- tests


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """At most four torch threads while this file runs (see
    test_torch_table.few_threads)."""
    sys.path.insert(0, str(REPO / "tests"))
    import test_torch_table as tt

    yield from tt.capped_threads(4)


@pytest.fixture(scope="module")
def golden() -> dict:
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def pages() -> list[np.ndarray]:
    return fixture_pages()


def assert_same_ocr(got: list, want: list, box_tol: float, score_tol: float,
                    poly_tol: float | None = None) -> None:
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert [it["text"] for it in gp] == [it["text"] for it in wp]
        for g, w in zip(gp, wp):
            assert np.abs(np.asarray(g["box"]) - np.asarray(w["box"])).max() <= box_tol
            assert abs(g["det_score"] - w["det_score"]) <= score_tol
            assert abs(g["score"] - w["score"]) <= score_tol
            if poly_tol is not None:
                assert [x["word"] for x in g["words"]] == [x["word"] for x in w["words"]]
                for a, b in zip(g["words"], w["words"]):
                    assert np.abs(np.asarray(a["poly"]) - np.asarray(b["poly"])).max() <= poly_tol


def test_ru_pdf_matches_committed():
    assert make_ru_pdf() == RU_PDF.read_bytes()


def test_word_geometry_equals_jax():
    """decode_with_positions, split_words and word_boxes_in_crop equal on
    seeded id streams (CJK, Latin, spaces, blanks, repeats) and crop
    sizes; map_crop_box_to_quad within 1e-4 px of cv2's (measured: equal)."""
    from rapiddoc_tpu.models.ocr import pre_post as jpp

    from rapiddoc_tpu_torch.models.ocr import pre_post as pp

    charset = list("abcXYZ09-") + ["中", "文", "字", "。"]
    rng = np.random.default_rng(0)
    for _ in range(200):
        t = int(rng.integers(1, 60))
        ids = rng.choice(len(charset) + 2, size=t, p=None).astype(np.int32)
        ids[rng.random(t) < 0.4] = 0
        probs = rng.random(t).astype(np.float32)
        valid = int(rng.integers(1, t + 1))
        got = pp.CTCLabelDecoder(charset).decode_with_positions(ids, probs, valid)
        want = jpp.CTCLabelDecoder(charset).decode_with_positions(ids, probs, valid)
        assert got == want
        words = pp.split_words(got[0], got[2])
        assert words == jpp.split_words(want[0], want[2])
        cw, ch = int(rng.integers(1, 900)), int(rng.integers(1, 80))
        boxes = pp.word_boxes_in_crop(words, valid, cw, ch)
        assert boxes == jpp.word_boxes_in_crop(words, valid, cw, ch)
        quad = (np.array([[0, 0], [cw, 0], [cw, ch], [0, ch]], np.float64)
                @ np.array([[1.0, 0.05], [-0.05, 1.0]]) + rng.uniform(0, 500, 2)
                + rng.normal(0, 1.5, (4, 2))).astype(np.float32)
        for box in boxes:
            a = pp.map_crop_box_to_quad(box, cw, ch, quad)
            b = jpp.map_crop_box_to_quad(box, cw, ch, quad)
            assert a.dtype == b.dtype == np.float32
            assert np.abs(a - b).max() <= 1e-4


@pytest.mark.parametrize("channels", [3, 1])
@pytest.mark.parametrize("stage", ["det", "rec"])
def test_full_depth_normalisers_equal_jax(stage, channels):
    """det_normalize_device and rec_normalize_device on a uint8 batch of
    RGB or 8-bit luma pixels: within 1e-6 of the JAX package's (float32
    rounding of the same expression)."""
    import jax.numpy as jnp
    import torch

    from rapiddoc_tpu.models.ocr import pre_post as jpp

    from rapiddoc_tpu_torch.models.ocr import pre_post as pp

    x = np.random.default_rng(channels).integers(0, 256, (2, 8, 16, channels), dtype=np.uint8)
    got = getattr(pp, f"{stage}_normalize_device")(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jpp, f"{stage}_normalize_device")(jnp.asarray(x)))
    assert got.shape == want.shape == (2, 8, 16, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("v", [91, 18710])
def test_ctc_plain_ids_equal_jax_ctc_head_decode(v):
    """K1's plain version at the Cyrillic and the published widths:
    ids equal to the JAX package's ctc_head_decode, confidences within
    1e-5 relative."""
    import jax.numpy as jnp
    import torch

    from rapiddoc_tpu.ops.ctc_head import ctc_head_decode as jax_decode

    from rapiddoc_tpu_torch.ops.ctc_head import ctc_head_decode

    rng = np.random.default_rng(v)
    feats = rng.standard_normal((4, 40, 120)).astype(np.float32)
    w = (rng.standard_normal((120, v)) / np.sqrt(120)).astype(np.float32)
    b = (rng.standard_normal(v) * 0.1).astype(np.float32)
    ids, conf = ctc_head_decode(torch.from_numpy(feats), torch.from_numpy(w), torch.from_numpy(b))
    ref_ids, ref_conf = jax_decode(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(b))
    assert np.array_equal(ids.numpy(), np.asarray(ref_ids))
    np.testing.assert_allclose(conf.numpy(), np.asarray(ref_conf), rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_port_fp32_knob_equals_golden(pages, golden, knob):
    """Each knob setting on the fixture's first page in fp32: the JAX
    package's texts, boxes and scores as the golden rounds them."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    env, cfg = KNOBS[knob]
    with held_env(**env):
        system = build_ocr_system(dict(cfg), device="cpu", dtype=torch.float32)
    got = rounded(system(pages[:1]))
    assert_same_ocr(got, golden["knobs"]["fp32"][knob][:1], box_tol=2e-4, score_tol=2e-4)


def test_knob_golden_matches_jax_package(pages, golden):
    """The committed golden of one knob (the RGB wire) on the first page is
    what the JAX package gives now."""
    from rapiddoc_tpu.models.registry import build_ocr_system

    with held_env("fp32", RAPIDDOC_RGB_TRANSFER="1"):
        want = rounded(build_ocr_system()(pages[:1]))
    assert_same_ocr(golden["knobs"]["fp32"]["rgb_transfer"][:1], want, 2e-4, 2e-4)


def test_knobs_reach_the_wires():
    """Each knob sets the wire the JAX package sets for it."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    want = {"rgb_transfer": (False, False, True, False), "det_wire_8": (True, False, True, True),
            "det_prob_8": (True, True, False, True), "rec_wire_8": (True, True, True, False)}
    for knob, (gray, det_nib, prob4, rec_nib) in want.items():
        with held_env(**KNOBS[knob][0]):
            s = build_ocr_system(device="cpu", dtype=torch.float32)
        assert (s.detector.gray_transfer, s.detector.nibble_wire, s.detector.prob4_wire,
                s.recognizer.nibble_wire) == (gray, det_nib, prob4, rec_nib), knob
    with held_env(RAPIDDOC_CONTRAST_STRETCH="0"):
        s = build_ocr_system({"Det.limit_side_len": 640}, device="cpu")
    assert (s.detector.contrast_stretch, s.recognizer.contrast_stretch) == (False, False)
    assert s.detector.limit_side_len == 640


def test_registry_routes_lang_as_jax_package(tmp_path, caplog):
    """lang='ru' takes the in-repo demo rec and its 89-entry dictionary
    (a 91-wide head, contrast stretch on); per-language files in the
    models dir win; weights without their dictionary are refused with
    the warning and the default rec is used."""
    import torch

    from rapiddoc_tpu.models.registry import build_ocr_system as jax_build

    from rapiddoc_tpu_torch.config import DEMO_ASSETS_DIR
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    def both(**env):
        with held_env(**env):
            return (build_ocr_system(lang="ru", device="cpu", dtype=torch.float32),
                    jax_build(lang="ru"))

    got, want = both()
    assert got.recognizer.decoder.chars == want.recognizer.decoder.chars
    assert len(got.recognizer.decoder.chars) == 91
    assert tuple(got.recognizer.session.module.head.kernel.shape) == (120, 91)
    assert got.recognizer.contrast_stretch is want.recognizer.contrast_stretch is True
    # per-language files in the models dir: the demo's, renamed, with a
    # dictionary whose first entry differs
    (tmp_path / "ocr_rec_ru.npz").write_bytes((DEMO_ASSETS_DIR / "ocr_rec_ru_demo.npz").read_bytes())
    chars = (DEMO_ASSETS_DIR / "ocr_rec_ru_dict.txt").read_text(encoding="utf-8").splitlines()
    (tmp_path / "ocr_rec_ru_dict.txt").write_text("\n".join(["#"] + chars[1:]) + "\n",
                                                  encoding="utf-8")
    got, want = both(RAPIDDOC_MODELS_DIR=str(tmp_path))
    assert got.recognizer.decoder.chars == want.recognizer.decoder.chars
    assert got.recognizer.decoder.chars[1] == "#"
    assert got.recognizer.contrast_stretch is want.recognizer.contrast_stretch is False
    (tmp_path / "ocr_rec_ru_dict.txt").unlink()
    with caplog.at_level(logging.WARNING):
        got, want = both(RAPIDDOC_MODELS_DIR=str(tmp_path))
    assert "dict file (ocr_rec_ru_dict.txt) is missing" in caplog.text
    assert got.recognizer.decoder.chars == want.recognizer.decoder.chars
    assert len(got.recognizer.decoder.chars) == 96


def test_published_format_rec_equals_golden(tmp_path, pages, golden):
    """Published-format det and rec in a models dir: the registry reads
    them as the JAX package does (the default 18 710-class dictionary,
    no contrast stretch), and the rec's texts on page 0's lines (one
    dispatch a width bucket) equal the JAX package's in fp32."""
    import torch

    from rapiddoc_tpu.models.registry import build_ocr_system as jax_build

    from rapiddoc_tpu_torch.models.ocr.pre_post import rec_width_bucket
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    smoke = _chip_smoke()
    smoke.write_published_ocr(tmp_path)
    with held_env(RAPIDDOC_MODELS_DIR=str(tmp_path)):
        system = build_ocr_system(device="cpu", dtype=torch.float32)
        want = jax_build()
    rec = system.recognizer
    assert rec.decoder.chars == want.recognizer.decoder.chars
    assert len(rec.decoder.chars) == smoke.PUBLISHED_V
    assert (system.detector.contrast_stretch, rec.contrast_stretch) == (False, False)
    lines = published_lines(pages[0], golden["published"]["boxes"])
    widths = {rec_width_bucket(c.shape[1], c.shape[0], rec.session.bucket_spec.widths)
              for c in lines}
    calls = rec.session.stats.calls
    res = rec(lines)
    assert rec.session.stats.calls - calls == len(widths) <= 2
    assert [r.text for r in res] == golden["published"]["fp32"]["texts"]
    np.testing.assert_allclose([r.score for r in res], golden["published"]["fp32"]["scores"],
                               atol=2e-4)


def test_port_ru_fp32_markdown_equals_golden(golden):
    """RapidDoc(lang='ru') on the Cyrillic fixture in fp32, layout,
    formula and table off: the JAX package's Markdown and lines."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc

    off = {f"RAPIDDOC_DISABLE_{k}": "1" for k in ("LAYOUT", "FORMULA", "TABLE")}
    with held_env(**off):
        out = RapidDoc(lang="ru", device="cpu", dtype=torch.float32)(
            RU_PDF.read_bytes(), parse_method="ocr")
    want = golden["ru"]["fp32"]
    assert out.markdown == want["markdown"]
    assert [d.get("text", "") for p in out.model_json for d in p["layout_dets"]] == want["lines"]
    assert sum("я" in ln or "е" in ln for ln in want["lines"]) >= 5


def test_port_fp32_word_boxes_equal_golden(pages, golden):
    """TextSystem(..., return_word_boxes=True) in fp32: lines and words
    equal, polygons within 1e-4 px of the JAX package's."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    with held_env():
        system = build_ocr_system(device="cpu", dtype=torch.float32)
    got = rounded(system([pages[i] for i in WORD_PAGES], return_word_boxes=True))
    assert_same_ocr(got, golden["words"]["fp32"], 2e-4, 2e-4, poly_tol=1e-4)
    assert sum(len(it["words"]) for p in got for it in p) >= 40


def compare() -> dict:
    """The port's bf16 readings on the CPU against the bf16 golden, beside
    the JAX package's fp32 against its bf16."""
    import torch

    from rapiddoc_tpu_torch import RapidDoc
    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    smoke = _chip_smoke()
    golden = json.loads(GOLDEN_JSON.read_text())
    pages = fixture_pages()
    out = {"knobs": {}}
    for name, (env, cfg) in KNOBS.items():
        with held_env(**env):
            got = build_ocr_system(dict(cfg), device="cpu")(pages)
        out["knobs"][name] = {
            "port_bf16_cpu": smoke.compare_to_golden(got, golden["knobs"]["bf16"][name], None),
            "jax_fp32_vs_bf16": smoke.compare_to_golden(golden["knobs"]["fp32"][name],
                                                        golden["knobs"]["bf16"][name], None)}
    off = {f"RAPIDDOC_DISABLE_{k}": "1" for k in ("LAYOUT", "FORMULA", "TABLE")}
    with held_env(**off):
        md = RapidDoc(lang="ru", device="cpu")(RU_PDF.read_bytes(), parse_method="ocr").markdown
    out["ru"] = {"port_bf16_cpu": smoke.compare_markdown(md, golden["ru"]["bf16"]["markdown"]),
                 "jax_fp32_vs_bf16": smoke.compare_markdown(golden["ru"]["fp32"]["markdown"],
                                                            golden["ru"]["bf16"]["markdown"])}
    with tempfile.TemporaryDirectory() as d, held_env(RAPIDDOC_MODELS_DIR=d):
        smoke.write_published_ocr(Path(d))
        rec = build_ocr_system(device="cpu").recognizer
        texts = [r.text for r in rec(published_lines(pages[0], golden["published"]["boxes"]))]
    want = golden["published"]["bf16"]["texts"]
    out["published"] = {"port_bf16_cpu_equal": sum(a == b for a, b in zip(texts, want)),
                        "jax_fp32_vs_bf16_equal": sum(
                            a == b for a, b in zip(golden["published"]["fp32"]["texts"], want)),
                        "lines": len(want)}
    return out


if __name__ == "__main__":
    # Rewrites the Cyrillic fixture PDF and the golden; with --compare,
    # prints compare() instead.
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare(), indent=1))
    else:
        data = make_ru_pdf()
        RU_PDF.write_bytes(data)
        GOLDEN_JSON.write_text(json.dumps(make_golden(data), indent=1, ensure_ascii=False) + "\n")
        print("wrote", RU_PDF, GOLDEN_JSON)
