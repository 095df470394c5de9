"""The port's formula recognizer against the JAX package, end to end on
the CPU.

The port's ``preprocess_formula`` must equal the JAX package's (cv2) bit
for bit; its fp32 ids must equal the JAX package's fp32 ids (the
committed golden, which ``tests/test_torch_formula_golden.py`` holds to
a fresh JAX run) on every crop, with the plain head and with the int8
head; and its bf16 run must meet the limits that ``chip_smoke.py`` holds
the card's bf16 run to.

``python tests/test_torch_formula_system.py --compare`` prints the
port's bf16 readings against the bf16 golden.
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_formula_golden import GOLDEN_JSON, MODES, _chip_smoke, load_crops

REPO = Path(__file__).resolve().parent.parent


def port_ids(rec, crops, int8_head: bool) -> list[list[int]]:
    rec.int8_head = int8_head
    return rec.batch_predict(crops, return_ids=True)


def build(dtype):
    from rapiddoc_tpu_torch.models.registry import build_formula_recognizer

    return build_formula_recognizer(device="cpu", dtype=dtype)




@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two torch threads while this module runs: the decode is thousands
    of tiny ops, and with one OpenMP thread per core in each of the
    tier-1 run's six worker processes their spin-waits made it about
    100x slower (measured: six concurrent demo decodes took 301 s each
    at 8 threads, 2-3 s at 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def crops():
    return load_crops()


@pytest.fixture(scope="module")
def golden():
    return json.loads(GOLDEN_JSON.read_text())


@pytest.fixture(scope="module")
def recs():
    """The demo recognizer on the CPU in each dtype; tests set int8_head."""
    return {"fp32": build(torch.float32), "bf16": build(torch.bfloat16)}


def test_preprocess_bit_equal_to_jax_package(crops):
    from rapiddoc_tpu.models.formula.engine import preprocess_formula as jax_pre
    from rapiddoc_tpu_torch.models.formula.engine import preprocess_formula

    buckets = set()
    for crop in crops:
        got, bucket = preprocess_formula(crop)
        want, want_bucket = jax_pre(crop)
        assert bucket == want_bucket
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        buckets.add(bucket)
    assert len(buckets) == 2


@pytest.mark.parametrize("text", [
    "\\ frac { a } { b }", "x^{2}  +\\alpha", "\\sqrt{ {a}", "a \\ b\\beta"])
def test_fix_latex_matches_jax_package(text):
    from rapiddoc_tpu.models.formula.engine import fix_latex as jax_fix_latex
    from rapiddoc_tpu_torch.models.formula.engine import fix_latex

    assert fix_latex(text) == jax_fix_latex(text)


def test_demo_vocab_matches_jax_package(recs, golden):
    """Detokenizing the golden ids gives the JAX package's LaTeX."""
    for mode in MODES:
        got = [recs["fp32"].tokenizer.decode(ids) for ids in golden[mode]["ids"]]
        assert got == golden[mode]["latex"]


@pytest.mark.parametrize("int8_head", [False, True], ids=["plain_head", "int8_head"])
def test_port_fp32_equals_jax_fp32(recs, crops, golden, int8_head):
    want = golden["fp32_int8" if int8_head else "fp32"]["ids"]
    assert port_ids(recs["fp32"], crops, int8_head) == want


def test_port_bf16_meets_the_card_limits(recs, crops, golden):
    """The port's bf16 on the CPU against the JAX package's bf16 golden,
    held to the limits chip_smoke.py sets for the card from this reading
    (printed by ``python tests/test_torch_formula_system.py --compare``)."""
    smoke = _chip_smoke()
    got = port_ids(recs["bf16"], crops, int8_head=False)
    smoke.check_formula_bf16(smoke.compare_ids(got, golden["bf16"]["ids"], None),
                             smoke.formula_gaps(recs["bf16"], recs["fp32"], crops), golden)


def compare_bf16() -> dict:
    """How far bf16 ids lie from the committed bf16 golden: the JAX
    package's fp32 and the port's bf16 on the CPU with both heads, and
    the port's bf16-vs-fp32 errors (encoder memory, first decode step's
    logits) as shares of the JAX package's."""
    smoke = _chip_smoke()
    committed = json.loads(GOLDEN_JSON.read_text())
    bf16, fp32 = build(torch.bfloat16), build(torch.float32)
    crops = load_crops()
    return {
        "jax_fp32": smoke.compare_ids(committed["fp32"]["ids"], committed["bf16"]["ids"], None),
        "jax_bf16_int8": smoke.compare_ids(committed["bf16_int8"]["ids"],
                                           committed["bf16"]["ids"], None),
        "port_bf16_cpu": smoke.compare_ids(port_ids(bf16, crops, False), committed["bf16"]["ids"], None),
        "port_bf16_int8_cpu": smoke.compare_ids(port_ids(bf16, crops, True),
                                                committed["bf16_int8"]["ids"], None),
        "port_gap_share": {name: gap / committed[smoke.FORMULA_GAPS[name]]
                           for name, gap in smoke.formula_gaps(bf16, fp32, crops).items()},
    }


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))
    if "--compare" in sys.argv[1:]:
        print(json.dumps(compare_bf16(), indent=1))


def test_random_init_is_seeded_and_decodes(crops):
    """FormulaRecognizer(None, ...) — the published shape's path, here at
    a small depth and vocabulary — builds the same weights from the same
    seed, identity norms, and decodes every crop within its length
    bucket; without a tokenizer the text is empty."""
    from rapiddoc_tpu_torch.models.formula.engine import FormulaConfig, FormulaRecognizer

    cfg = FormulaConfig(max_len=16, vocab_size=300, layers=1, backbone_size="B0",
                        out_index=2, default_length_bucket=8)
    a, b = (FormulaRecognizer(None, config=cfg, seed=3, device="cpu", dtype=torch.float32,
                              int8_head=True) for _ in range(2))
    for (name, x), y in zip(a.decoder.state_dict().items(), b.decoder.state_dict().values()):
        assert torch.equal(x, y), name
    assert torch.equal(a.decoder.layer_norm.weight, torch.ones(512))
    ids = a.batch_predict(crops[10:], return_ids=True)  # two of each bucket
    assert len(ids) == 4 and all(len(i) <= 8 and all(0 <= t < 300 for t in i) for i in ids)
    assert a.batch_predict(crops[:1]) == [""]
    assert a.stats.dispatches == 3
