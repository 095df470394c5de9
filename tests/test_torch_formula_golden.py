"""The fixture and golden files of the port's formula slice against a
fresh regeneration from the JAX package, on the CPU.

The fixture crops (``rapiddoc_tpu_torch/assets/formula_smoke_crops.npz``)
and the golden token ids (``formula_smoke_golden.json``) that
``chip_smoke.py`` and ``tests/test_torch_formula_system.py`` hold the
port to are both rebuilt here from the JAX package and must equal the
committed files, so the golden cannot drift from the reference.

Rebuild the two files with ``python tests/test_torch_formula_golden.py``
(needs the JAX package, PIL and matplotlib).
"""
import importlib.util
import io
import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
CROPS_NPZ = ASSETS / "formula_smoke_crops.npz"
GOLDEN_JSON = ASSETS / "formula_smoke_golden.json"
EVAL_SEED = 4242  # train/formula.py:evaluate's held-out seed
N_EVAL = 12
RAW_SEED, RAW_DPI, RAW_BUCKET, N_RAW = 4343, 240, (128, 512), 2
MODES = ("fp32", "fp32_int8", "bf16", "bf16_int8")


def make_crops() -> tuple[list[np.ndarray], list[str]]:
    """12 crops by train/formula.py:evaluate's recipe (random_latex +
    render_formula, random.Random(4242), grey repeated to 3 channels),
    then 2 raw mathtext renders at 240 dpi that land in the 128x512
    bucket. Returns (crops, latex truths)."""
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import mathtext
    from PIL import Image

    from rapiddoc_tpu.models.formula.engine import preprocess_formula
    from rapiddoc_tpu.train.formula import MAX_T, latex_tokenize, render_formula
    from rapiddoc_tpu.train.synth_layout import random_latex

    crops, truths = [], []
    rng = random.Random(EVAL_SEED)
    while len(crops) < N_EVAL:
        latex = random_latex(rng)
        if len(latex_tokenize(latex)) + 1 > MAX_T:
            continue
        img = render_formula(latex, rng)
        if img is None:
            continue
        crops.append(np.repeat(img, 3, axis=-1))
        truths.append(latex)
    rng = random.Random(RAW_SEED)
    while len(crops) < N_EVAL + N_RAW:
        latex = random_latex(rng)
        buf = io.BytesIO()
        mathtext.math_to_image(f"${latex}$", buf, dpi=RAW_DPI, format="png")
        buf.seek(0)
        img = np.asarray(Image.open(buf).convert("RGB"), np.uint8)
        if preprocess_formula(img)[1] == RAW_BUCKET:
            crops.append(img)
            truths.append(latex)
    return crops, truths


def load_crops() -> list[np.ndarray]:
    with np.load(CROPS_NPZ) as z:
        return [z[f"crop{i:02d}"] for i in range(len(z.files))]


def _held_env(**env):
    """Context: RAPIDDOC_*/MINERU_* settings (which other tests may leave
    in the process) held off, ``env`` set."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        saved = {k: v for k, v in os.environ.items()
                 if k.startswith(("RAPIDDOC_", "MINERU_"))}
        for k in saved:
            del os.environ[k]
        os.environ.update(env)
        try:
            yield
        finally:
            for k in env:
                os.environ.pop(k, None)
            os.environ.update(saved)

    return ctx()


def jax_ids(crops: list[np.ndarray], mode: str) -> list[list[int]]:
    """The JAX package's FormulaRecognizer.build({}) token ids per crop,
    in its bf16 policy or with RAPIDDOC_FP32_PARAMS=1, with or without
    RAPIDDOC_INT8_HEAD=1 (default length bucket, 160)."""
    from rapiddoc_tpu.models.formula.engine import FormulaRecognizer

    env = {}
    if mode.startswith("fp32"):
        env["RAPIDDOC_FP32_PARAMS"] = "1"
    if mode.endswith("int8"):
        env["RAPIDDOC_INT8_HEAD"] = "1"
    with _held_env(**env):
        rec = FormulaRecognizer.build({})
        # quantize outside jit: _int8_head() caches its result on the
        # first trace, and a second trace (the other image bucket) would
        # read that tracer and fail with UnexpectedTracerError
        rec._int8_head()
        return [list(map(int, ids)) for ids in rec.batch_predict(crops, return_ids=True)]


def jax_memory_gap(crops: list[np.ndarray]) -> float:
    """The JAX package's own bf16-vs-fp32 relative error of the encoder
    memory on the crops of the first image bucket: the demo encoder with
    its stored weights cast as commit_params casts them, the input
    normalized as the engine does."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.engine.session import commit_params
    from rapiddoc_tpu.models.formula.engine import UNIMER_MEAN, UNIMER_STD, preprocess_formula
    from rapiddoc_tpu.models.formula.model import FormulaEncoder
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    arch = json.loads((DEMO_ASSETS_DIR / "formula_demo.json").read_text())["arch"]
    encoder = FormulaEncoder(arch["backbone_size"], 512, out_index=arch["out_index"])
    enc = _load_variables(DEMO_ASSETS_DIR / "formula_demo.npz")["encoder"]
    images = memory_batch(crops, preprocess_formula)
    x = (images.astype(np.float32) / 255.0 - UNIMER_MEAN) / UNIMER_STD
    x = np.broadcast_to(x, (*x.shape[:-1], 3))
    fn = jax.jit(encoder.apply)
    m32 = fn(commit_params(enc, dtype=jnp.float32), jnp.asarray(x, jnp.float32))
    m16 = fn(commit_params(enc, dtype=jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
    return _chip_smoke().rel_err(np.asarray(m16.astype(jnp.float32)), np.asarray(m32))


def jax_first_step_gap(crops: list[np.ndarray]) -> float:
    """The JAX package's own bf16-vs-fp32 relative error of the first
    decode step's logits (BOS at position 0, plain lm_head, caches of the
    default length bucket) on the crops of the first image bucket: the
    demo modules with their stored weights cast as commit_params casts
    them, each dtype run from its own encoder memory."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.engine.session import commit_params
    from rapiddoc_tpu.models.formula.engine import (
        UNIMER_MEAN,
        UNIMER_STD,
        FormulaConfig,
        preprocess_formula,
    )
    from rapiddoc_tpu.models.formula.model import build_formula_modules
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    meta = json.loads((DEMO_ASSETS_DIR / "formula_demo.json").read_text())
    arch = meta["arch"]
    encoder, decoder, mem_proj, cfg = build_formula_modules(
        max_len=arch["max_len"], vocab_size=len(meta["vocab"]), layers=arch["layers"],
        backbone_size=arch["backbone_size"], out_index=arch["out_index"],
    )
    length = min(arch["max_len"], FormulaConfig.default_length_bucket)
    variables = _load_variables(DEMO_ASSETS_DIR / "formula_demo.npz")
    images = memory_batch(crops, preprocess_formula)
    x = (images.astype(np.float32) / 255.0 - UNIMER_MEAN) / UNIMER_STD
    x = np.broadcast_to(x, (*x.shape[:-1], 3))

    def first_step(enc, dec, mem, x):
        memory = encoder.apply(enc, x)
        b, s = memory.shape[:2]
        mem_k, mem_v = mem_proj.apply(mem, memory)
        hd = cfg.d_model // cfg.heads
        caches = jnp.zeros((cfg.layers, b, length, cfg.heads, hd), x.dtype)
        cur = jnp.full((b, 1), cfg.bos_token_id, jnp.int32)
        logits, _, _ = decoder.apply(dec, cur, caches, caches, 0, mem_k, mem_v,
                                     jnp.ones((b, s), bool))
        return logits[:, -1].astype(jnp.float32)

    fn = jax.jit(first_step)
    out = {}
    for dtype in (jnp.float32, jnp.bfloat16):
        params = [commit_params(variables[k], dtype=dtype) for k in ("encoder", "decoder", "mem_proj")]
        out[dtype] = np.asarray(fn(*params, jnp.asarray(x, dtype)))
    return _chip_smoke().rel_err(out[jnp.bfloat16], out[jnp.float32])


def memory_batch(crops, preprocess) -> np.ndarray:
    """The uint8 canvases of the crops that land in the first bucket."""
    canvases = [preprocess(c) for c in crops]
    first = canvases[0][1]
    return np.stack([x for x, b in canvases if b == first])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_golden(crops: list[np.ndarray], truths: list[str]) -> dict:
    from rapiddoc_tpu.models.formula.engine import DemoFormulaVocab

    meta = json.loads((REPO / "rapiddoc_tpu" / "assets" / "formula_demo.json").read_text())
    vocab = DemoFormulaVocab(meta["vocab"])
    golden = {
        "source": "rapiddoc_tpu FormulaRecognizer.build({}).batch_predict on the CPU, "
                  "on formula_smoke_crops.npz; rebuilt by tests/test_torch_formula_golden.py",
        "truths": truths,
    }
    for mode in MODES:
        ids = jax_ids(crops, mode)
        golden[mode] = {"ids": ids, "latex": [vocab.decode(i) for i in ids]}
    golden["memory_bf16_rel_err"] = round(jax_memory_gap(crops), 6)
    golden["first_step_logits_bf16_rel_err"] = round(jax_first_step_gap(crops), 6)
    return golden


@pytest.fixture(scope="module")
def fresh():
    return make_crops()


@pytest.fixture(scope="module")
def crops():
    return load_crops()


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_JSON.read_text())


def test_fixture_crops_match_committed(fresh, crops):
    made, _ = fresh
    assert len(crops) == len(made) == N_EVAL + N_RAW
    for a, b in zip(crops, made):
        assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[-1] == 3
        assert np.array_equal(a, b)


@pytest.mark.parametrize("mode", MODES)
def test_golden_matches_jax_package(crops, golden, mode):
    assert jax_ids(crops, mode) == golden[mode]["ids"]


def test_golden_first_step_gap_matches_jax_package(crops, golden):
    gap = jax_first_step_gap(crops)
    assert 1e-3 < gap < 0.1  # bf16 rounding, neither fp32 nor broken
    assert golden["first_step_logits_bf16_rel_err"] == pytest.approx(gap, rel=1e-3)


def test_golden_memory_gap_matches_jax_package(crops, golden):
    gap = jax_memory_gap(crops)
    assert 1e-3 < gap < 0.1  # bf16 rounding, neither fp32 nor broken
    assert golden["memory_bf16_rel_err"] == pytest.approx(gap, rel=1e-3)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    made, truths = make_crops()
    ASSETS.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(CROPS_NPZ, **{f"crop{i:02d}": c for i, c in enumerate(made)})
    GOLDEN_JSON.write_text(json.dumps(make_golden(made, truths), indent=1) + "\n")
    print("wrote", CROPS_NPZ, GOLDEN_JSON)
