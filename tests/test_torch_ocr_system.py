"""The port's OCR slice against the JAX package, end to end on the CPU.

The fixture pages (``rapiddoc_tpu_torch/assets/ocr_smoke_pages.npz``)
and the golden output (``ocr_smoke_golden.json``) that ``chip_smoke.py``
checks the card against are both rebuilt here from the JAX package and
must equal the committed files, so the golden cannot drift from the
reference. Then the port runs the same pages in fp32 and must give the
JAX package's fp32 texts exactly, with box corners within 1 px; and in
bf16 it must meet the limits that ``chip_smoke.py`` holds the card's
bf16 run to, against the JAX package's bf16 output.

Rebuild the two files with ``python tests/test_torch_ocr_system.py``.
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
PAGES_NPZ = ASSETS / "ocr_smoke_pages.npz"
GOLDEN_JSON = ASSETS / "ocr_smoke_golden.json"
SEEDS = (0, 1, 2)
ROTATE_DEG = {2: 3.0}  # one tilted page, so crop_quad's warp branch runs
DIGITS = 4


def make_pages() -> np.ndarray:
    """3 synthetic 960x960 pages from the JAX package's renderer; the
    third one rotated by 3 degrees."""
    from PIL import Image

    from rapiddoc_tpu.train.synth import render_page

    pages = []
    for seed in SEEDS:
        img, _, _ = render_page(random.Random(seed), 960, with_texts=True)
        img = np.asarray(img, np.uint8)
        if seed in ROTATE_DEG:
            bg = tuple(int(v) for v in img[0, 0])
            img = np.asarray(Image.fromarray(img).rotate(
                ROTATE_DEG[seed], resample=Image.BILINEAR, fillcolor=bg
            ))
        pages.append(img)
    return np.stack(pages)


def _rounded(out: list[list[dict]]) -> list[list[dict]]:
    return [
        [
            {
                "box": np.round(np.asarray(it["box"], np.float64), DIGITS).tolist(),
                "det_score": round(float(it["det_score"]), DIGITS),
                "text": it["text"],
                "score": round(float(it["score"]), DIGITS),
            }
            for it in page
        ]
        for page in out
    ]


def jax_ocr(pages: np.ndarray, fp32: bool) -> list[list[dict]]:
    """The JAX package's build_ocr_system() on the pages, in its default
    bf16 policy or (fp32=True) with RAPIDDOC_FP32_PARAMS=1. Every other
    RAPIDDOC_*/MINERU_* setting (which other tests may leave behind in the
    process) is held off while it builds and runs."""
    from rapiddoc_tpu.models.registry import build_ocr_system

    saved = {k: v for k, v in os.environ.items()
             if k.startswith(("RAPIDDOC_", "MINERU_"))}
    for k in saved:
        del os.environ[k]
    if fp32:
        os.environ["RAPIDDOC_FP32_PARAMS"] = "1"
    try:
        return _rounded(build_ocr_system()(list(pages)))
    finally:
        os.environ.pop("RAPIDDOC_FP32_PARAMS", None)
        os.environ.update(saved)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_bf16_gaps(page: np.ndarray) -> dict:
    """The JAX package's own bf16-vs-fp32 relative error of the DBNet prob
    map and the SVTRRec features on chip_smoke.witness_inputs(page), with
    the weights cast as commit_params casts them and the models jitted as
    JaxSession jits them."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.engine.session import commit_params
    from rapiddoc_tpu.models.ocr.det import DBNet
    from rapiddoc_tpu.models.ocr.rec import SVTRRec
    from rapiddoc_tpu.models.registry import DEMO_ASSETS_DIR, _load_variables

    smoke = _chip_smoke()
    det_x, rec_x = smoke.witness_inputs(page)
    gaps = {}
    for name, model, npz, x, kw in (
        ("det", DBNet(), "ocr_det_demo.npz", det_x, {}),
        ("rec", SVTRRec(num_classes=96), "ocr_rec_demo.npz", rec_x, {"features_only": True}),
    ):
        variables = _load_variables(DEMO_ASSETS_DIR / npz)
        fn = jax.jit(lambda v, x, model=model, kw=kw: model.apply(v, x, **kw))
        y32 = fn(commit_params(variables, dtype=jnp.float32), jnp.asarray(x))
        y16 = fn(commit_params(variables, dtype=jnp.bfloat16), jnp.asarray(x, jnp.bfloat16))
        gaps[name] = round(smoke.rel_err(np.asarray(y16.astype(jnp.float32)), np.asarray(y32)), 6)
    return gaps


def make_golden(pages: np.ndarray) -> dict:
    return {
        "source": "rapiddoc_tpu build_ocr_system() on the CPU, on "
                  "ocr_smoke_pages.npz; rebuilt by tests/test_torch_ocr_system.py",
        "fp32": jax_ocr(pages, fp32=True),
        "bf16": jax_ocr(pages, fp32=False),
        "bf16_rel_err": jax_bf16_gaps(pages[0]),
    }


def assert_same_output(got: list[list[dict]], want: list[list[dict]],
                       box_tol: float, score_tol: float) -> None:
    assert len(got) == len(want)
    for gp, wp in zip(got, want):
        assert [it["text"] for it in gp] == [it["text"] for it in wp]
        for g, w in zip(gp, wp):
            assert np.abs(np.asarray(g["box"]) - np.asarray(w["box"])).max() <= box_tol
            assert abs(g["det_score"] - w["det_score"]) <= score_tol
            assert abs(g["score"] - w["score"]) <= score_tol


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


@pytest.fixture(scope="module")
def pages():
    return make_pages()


@pytest.fixture(scope="module")
def golden(pages):
    return make_golden(pages)


def test_fixture_pages_match_committed(pages):
    with np.load(PAGES_NPZ) as z:
        committed = z["pages"]
    assert committed.dtype == np.uint8 and committed.shape == (3, 960, 960, 3)
    assert np.array_equal(committed, pages)


@pytest.mark.parametrize("policy", ["fp32", "bf16"])
def test_golden_matches_jax_package(golden, policy):
    committed = json.loads(GOLDEN_JSON.read_text())
    # rounded to DIGITS decimals when written; allow one unit of that
    assert_same_output(committed[policy], golden[policy],
                       box_tol=2 * 10 ** -DIGITS, score_tol=2 * 10 ** -DIGITS)


def test_golden_bf16_gap_matches_jax_package(golden):
    committed = json.loads(GOLDEN_JSON.read_text())["bf16_rel_err"]
    assert set(committed) == set(golden["bf16_rel_err"]) == {"det", "rec"}
    for name, gap in golden["bf16_rel_err"].items():
        assert 1e-3 < gap < 0.1  # bf16 rounding, neither fp32 nor broken
        assert committed[name] == pytest.approx(gap, rel=1e-3)


def test_port_bf16_meets_the_card_limits(pages, golden):
    """The port's bf16 on the CPU against the JAX package's bf16, held to
    the limits chip_smoke.py sets for the card from this reading
    (measured: 2 of 74 boxes unmatched, 51/74 lines equal, CER 0.0374;
    bf16-vs-fp32 error 0.86 (det) and 0.77 (rec) of the JAX package's;
    printed by ``python tests/test_torch_ocr_system.py --compare``)."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    smoke = _chip_smoke()
    system = build_ocr_system(device="cpu")
    vs_golden = smoke.compare_to_golden(system(list(pages)), golden["bf16"], None)
    assert vs_golden["lines"] == 74
    gaps = smoke.bf16_gaps(system, build_ocr_system(device="cpu", dtype=torch.float32), pages[0])
    smoke.check_bf16(vs_golden, gaps, golden["bf16_rel_err"])


def test_port_fp32_equals_jax_fp32(pages, golden):
    """Exact texts and box corners within 1 px (measured: 5e-5 px, the
    golden's rounding); scores within 5e-3 (measured: det 5e-5, rec
    4e-4, fp32 summation order before the bf16 head)."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    system = build_ocr_system(device="cpu", dtype=torch.float32)
    got = _rounded(system(list(pages)))
    assert sum(len(p) for p in got) >= 60
    assert_same_output(got, golden["fp32"], box_tol=1.0, score_tol=5e-3)


def compare_bf16(pages: np.ndarray) -> dict:
    """How far bf16 outputs lie from the committed golden: the JAX
    package's fp32, the JAX package's bf16 as this process's XLA_FLAGS
    compile it, and the port's bf16 on the CPU (with its bf16-vs-fp32
    model errors as a share of the JAX package's)."""
    import torch

    from rapiddoc_tpu_torch.models.registry import build_ocr_system

    smoke = _chip_smoke()
    committed = json.loads(GOLDEN_JSON.read_text())
    system = build_ocr_system(device="cpu")
    gaps = smoke.bf16_gaps(system, build_ocr_system(device="cpu", dtype=torch.float32), pages[0])
    return {
        "xla_flags": os.environ["XLA_FLAGS"],
        "jax_fp32": smoke.compare_to_golden(committed["fp32"], committed["bf16"], None),
        "jax_bf16": smoke.compare_to_golden(jax_ocr(pages, fp32=False), committed["bf16"], None),
        "port_bf16_cpu": smoke.compare_to_golden(system(list(pages)), committed["bf16"], None),
        "port_bf16_rel_err_share": {k: v / committed["bf16_rel_err"][k] for k, v in gaps.items()},
    }


if __name__ == "__main__":
    # Rewrites the fixture and golden files; with --compare, prints
    # compare_bf16() instead (for example under
    # XLA_FLAGS=--xla_allow_excess_precision=false).
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    os.environ["XLA_FLAGS"] = f"{flags} --xla_force_host_platform_device_count=8".strip()
    for k in ("LAYOUT", "FORMULA", "TABLE"):
        os.environ.setdefault(f"RAPIDDOC_DISABLE_{k}", "1")
    sys.path.insert(0, str(REPO))
    p = make_pages()
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare_bf16(p), indent=1))
    else:
        ASSETS.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(PAGES_NPZ, pages=p)
        GOLDEN_JSON.write_text(json.dumps(make_golden(p), indent=1) + "\n")
        print("wrote", PAGES_NPZ, GOLDEN_JSON)
