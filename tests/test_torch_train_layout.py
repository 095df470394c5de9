"""The port's layout and formula trainers (``rapiddoc_tpu_torch/train/
{layout,formula}.py``) and RT-DETR's training outputs against the JAX
package's, in fp32 on the CPU, at small sizes: RT-DETR at 320 x 320 with
batch 2, the formula recognizer at 64 x 256 with batch 2 and 20 tokens,
both from the demo checkpoints (carried across with ``load_flax_into``);
the batches are made from numpy seeds. The JAX sides are
``tests/torch_train_layout_fixtures.py``'s.

- **RT-DETR's ``aux``**: ``aux_logits``, ``aux_boxes``, ``enc_logits`` and
  ``enc_boxes`` equal to the JAX model's within ``AUX_TOL``; the inference
  outputs with ``aux`` on bit-equal to ``aux`` off.
- **Matching**: ``match_batch`` equal to the JAX function on given logits
  and boxes.
- **Step**: against the JAX trainer's step with float64 parameters
  (``jax.enable_x64``; the losses' own float32 casts stay): the loss within
  ``GRAD_TOL`` relative, the gradient's global norm within ``NORM_TOL``,
  every gradient leaf within ``LEAF_TOL`` of the model's largest gradient
  (leaves whose JAX gradient is under ``ZERO_LEAF`` of it held under that
  bound on both sides: affine scales and biases feeding a train-mode batch
  norm, which normalizes them away, attention key biases, which the
  softmax over keys cancels, and the formula encoder's stage 3, which runs
  for its batch statistics only; under a quarter of the leaves), the layout step's matching equal in every layer,
  the batch statistics within ``STATS_TOL`` of flax's; three steps' losses
  within ``STEPS_TOL`` relative. The leaves are not held to 1e-4 of their
  own scale, as the table trainers' are: RT-DETR's float32 gradients are
  not that close to the float64 step in either package. Read at 320 px on
  this batch: the JAX package's own float32 step is 0.12 of a leaf's scale
  off at worst (median 2.8e-5) and 2.2e-4 of the largest gradient; the
  port's 3.3e-2 at worst (median 5.7e-4) and 6.6e-4; the norms 9e-5 and
  3.8e-4 relative; the forward logits 7.6e-6 and 5.7e-6 of their scale.
  The port's worst leaves follow one ReLU: a pre-activation of the first
  decoder layer's FFN rounds to -7.1e-6 in the port's float32 and sits at
  +2.0e-6 in float64, so that layer's gradients move; the JAX float32
  step happens to round it as float64 does.
- **The batch-statistics trap**: the layout step's matching forward leaves
  the running statistics alone; the same step with a plain train-mode
  matching forward moves them twice and misses flax's.
- **Checkpoints**: ``flax_variables`` of the demo models equal to their
  files (the round trip of ``DenseGeneral`` kernels, the formula model's
  three-part tree, ``embed_positions``); the trained models written as the
  trainers write them read by the JAX registry's ``_load_variables`` and by
  the port's registries, the outputs of both packages' models equal.
- **The smoke's fixture**: ``assets/train_layout_smoke_batches.npz`` and
  ``mathtext_smoke_renders.npz`` are what the JAX code and matplotlib make
  now, and the port's fp32 first steps from the demo checkpoints meet
  ``train_layout_smoke_golden.json`` at the trainers' full shapes.
- The trainers refuse the CPU unless asked.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

import torch_train_layout_fixtures as fx  # noqa: E402

GRAD_TOL = 1e-4  # relative, the loss
LEAF_TOL = 1e-3  # of the model's largest gradient, each leaf's error
ZERO_LEAF = 1e-6  # of the model's largest gradient
STATS_TOL = 1e-5
STEPS_TOL = 1e-4  # relative, three steps' losses
NORM_TOL = 1e-3  # relative, the fixture's gradient norm against the golden
AUX_TOL = 2e-4
LAYOUT_HW, FORMULA_HW, FORMULA_T = 320, (64, 256), 20


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    from torch_threads import capped_threads

    yield from capped_threads(4)


def demo_flat(name: str) -> dict:
    from rapiddoc_tpu_torch.models.weights import load_npz

    return load_npz(fx.JAX_ASSETS / f"{name}_demo.npz")


# ------------------------------------------------------------- the batches

def layout_batch():
    """Two 320 px pages: seeded noise with dark blocks where the targets
    are (cxcywh in [0, 1], classes among the labels)."""
    from rapiddoc_tpu_torch.train.layout import MAX_T

    rng = np.random.default_rng(11)
    x = rng.integers(200, 256, (2, LAYOUT_HW, LAYOUT_HW, 3)).astype(np.uint8)
    tcls = np.full((2, MAX_T), -1, np.int32)
    tbox = np.zeros(tcls.shape + (4,), np.float32)
    for b, n in enumerate((5, 9)):
        for j in range(n):
            x0, y0 = rng.uniform(0, 0.7, 2)
            w, h = rng.uniform(0.08, 0.3, 2)
            tcls[b, j] = rng.integers(0, 25)
            tbox[b, j] = (x0 + w / 2, y0 + h / 2, w, h)
            px = (np.array([x0, y0, x0 + w, y0 + h]) * LAYOUT_HW).astype(int)
            x[b, px[1]:px[3], px[0]:px[2]] //= 3
    return x, tcls, tbox


def formula_batch():
    """Two seeded crops with bars of ink, 20 tokens (one sequence ends at
    9, with its eos), and the augmentation's draws."""
    rng = np.random.default_rng(12)
    h, w = FORMULA_HW
    x = np.full((2, h, w, 1), 255, np.uint8)
    x[:, 20:40, 10:200:7] = rng.integers(0, 90, (2, 20, 28, 1)).astype(np.uint8)
    tok = rng.integers(3, 57, (2, FORMULA_T)).astype(np.int32)
    tok[0, 8] = 2
    tok[0, 9:] = 1
    lens = np.array([9, FORMULA_T], np.int32)
    return (x, tok, lens, *fx.aug_draws(13, 2, FORMULA_HW))


# ------------------------------------------------------------- port side

def port_layout_run(flat_vars, x, tcls, tbox, steps: int = 3):
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables
    from rapiddoc_tpu_torch.train import layout as tl
    from rapiddoc_tpu_torch.train.bn import bn_training

    model = tl.new_model(variables=flat_vars)
    opt = tl.make_optimizer(model, fx.SCHEDULES["layout"][0])
    xt = torch.from_numpy(x)
    losses = []
    with bn_training(model):
        for i in range(steps):
            loss, qcls = tl.train_step(model, opt, xt, tcls, tbox)
            losses.append(float(loss))
            if i == 0:
                first = {"loss": losses[0], "qcls": qcls,
                         "grads": flatten(flax_variables(model, grads=True)["params"]),
                         "bstats": flatten(flax_variables(model)["batch_stats"])}
    return {**first, "losses": losses, "model": model}


def port_formula_run(flat_vars, batch, steps: int = 3):
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables
    from rapiddoc_tpu_torch.train import formula as tf
    from rapiddoc_tpu_torch.train.bn import bn_training

    vocab_size = flat_vars["decoder/params/embed_tokens/embedding"].shape[0]
    model = tf.new_model(vocab_size, variables=flat_vars)
    opt = tf.make_optimizer(model, fx.SCHEDULES["formula"][0])
    xs = [torch.from_numpy(a) for a in batch]
    losses = []
    with bn_training(model):
        for i in range(steps):
            losses.append(float(tf.train_step(model, opt, *xs)))
            if i == 0:
                first = {"loss": losses[0],
                         "grads": flatten(flax_variables(model, grads=True)["params"]),
                         "bstats": flatten(flax_variables(model)["batch_stats"])}
    return {**first, "losses": losses, "model": model}


@pytest.fixture(scope="module")
def cases():
    """Each trainer's JAX float64 run and the port's, in threads for the
    JAX compiles."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    layout_v, formula_v = fx.demo_variables("layout"), fx.demo_variables("formula")

    def jax_layout():
        with jax.enable_x64(True):
            return fx.jax_layout_run(fx.wide(layout_v), *layout_batch())

    def jax_formula():
        with jax.enable_x64(True):
            return fx.jax_formula_run(fx.wide(formula_v), formula_batch())

    with ThreadPoolExecutor(2) as pool:
        jl, jf = pool.submit(jax_layout), pool.submit(jax_formula)
        out = {"layout": (jl.result(), port_layout_run(demo_flat("layout"), *layout_batch())),
               "formula": (jf.result(), port_formula_run(demo_flat("formula"), formula_batch()))}
    return out


@pytest.fixture(scope="module", params=["layout", "formula"])
def case(request, cases):
    return (request.param, *cases[request.param])


# ------------------------------------------------------------------ tests

def test_rtdetr_aux_outputs_match_jax():
    import jax.numpy as jnp

    from rapiddoc_tpu.train import layout as jl
    from rapiddoc_tpu_torch.models.weights import load_flax_into
    from rapiddoc_tpu_torch.train import layout as tl

    x = layout_batch()[0].astype(np.float32) / 255.0
    want = jl.make_model(aux=True).apply(fx.demo_variables("layout"), jnp.asarray(x))
    flat = demo_flat("layout")
    with torch.no_grad():
        got = tl.new_model(variables=flat).eval()(torch.from_numpy(x))
        plain = load_flax_into(tl.make_model(aux=False), flat).eval()(torch.from_numpy(x))
    for k in ("aux_logits", "aux_boxes", "enc_logits", "enc_boxes", "boxes", "scores"):
        w = np.asarray(want[k], np.float32)
        assert got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=AUX_TOL * max(1, np.abs(w).max()),
                                   err_msg=k)
    assert set(plain) == {"scores", "labels", "boxes"}
    for k in plain:
        assert torch.equal(plain[k], got[k]), k
    # the last decoder layer's output is the prediction
    assert torch.equal(got["aux_boxes"][-1], got["boxes"])


def test_match_batch_equals_jax():
    from rapiddoc_tpu.train import layout as jl
    from rapiddoc_tpu_torch.train import layout as tl

    rng = np.random.default_rng(5)
    _, tcls, tbox = layout_batch()
    for _ in range(4):
        logits = rng.normal(0, 2, (2, 60, 25)).astype(np.float32)
        boxes = np.concatenate([rng.uniform(0.1, 0.9, (2, 60, 2)),
                                rng.uniform(0.02, 0.4, (2, 60, 2))], -1).astype(np.float32)
        want, got = jl.match_batch(logits, boxes, tcls, tbox), tl.match_batch(logits, boxes, tcls,
                                                                                tbox)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(tl._giou_np(boxes[0], tbox[0, :5]),
                                      jl._giou_np(boxes[0], tbox[0, :5]))


def test_step_loss_and_gradients_match_jax(case):
    name, want, got = case
    assert abs(got["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"]), (got["loss"], want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    assert fx.grad_norm(got["grads"]) == pytest.approx(fx.grad_norm(want["grads"]), rel=NORM_TOL)
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    worst, zero = {}, []
    for k, g in want["grads"].items():
        if float(np.abs(g).max()) < ZERO_LEAF * top:
            zero.append(k)
            if float(np.abs(got["grads"][k]).max()) >= ZERO_LEAF * top:
                worst[k] = ("not zero", float(np.abs(got["grads"][k]).max()), top)
            continue
        err = float(np.abs(got["grads"][k] - g).max())
        if err > LEAF_TOL * top:
            worst[k] = (err, top)
    assert not worst, worst
    assert len(zero) < len(want["grads"]) // 4, zero
    if name == "layout":
        np.testing.assert_array_equal(got["qcls"], want["qcls"])
        assert (got["qcls"] >= 0).sum() == 4 * (5 + 9)  # every target matched in every layer


def test_batch_statistics_match_flax(case):
    name, want, got = case
    assert sorted(got["bstats"]) == sorted(want["bstats"]) and got["bstats"]
    for k, v in want["bstats"].items():
        np.testing.assert_allclose(got["bstats"][k], v, rtol=0, atol=STATS_TOL, err_msg=k)


def test_three_steps_match_jax(case):
    name, want, got = case
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEPS_TOL, atol=0)
    assert got["losses"][2] < got["losses"][0]


def test_matching_pass_leaves_batch_statistics(cases, monkeypatch):
    """With the matching forward in plain train mode the running statistics
    move twice a step: a layout step then misses flax's, by about the
    second update."""
    from rapiddoc_tpu_torch.train import bn

    want = cases["layout"][0]["bstats"]
    good = cases["layout"][1]["bstats"]
    monkeypatch.setattr("rapiddoc_tpu_torch.train.layout.frozen_stats", bn.bn_training)
    bad = port_layout_run(demo_flat("layout"), *layout_batch(), steps=1)["bstats"]
    errs = {k: float(np.abs(bad[k] - v).max()) for k, v in want.items()}
    assert max(errs.values()) > 100 * STATS_TOL
    drift = {k: float(np.abs(bad[k] - good[k]).max()) for k in want}
    assert max(drift.values()) == pytest.approx(max(errs.values()), rel=1e-2)


def test_demo_checkpoints_round_trip_exactly():
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables, split_models
    from rapiddoc_tpu_torch.train import formula as tf, layout as tl

    for name, model, tree in (
            ("layout", tl.new_model(variables=demo_flat("layout")), flax_variables),
            ("formula", tf.new_model(57, variables=demo_flat("formula")),
             lambda m: split_models(flax_variables(m)))):
        want = demo_flat(name)
        got = flatten(tree(model))
        assert sorted(got) == sorted(want), name
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_trained_checkpoints_load_in_both_registries(cases, tmp_path, monkeypatch):
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.registry import _load_variables
    from rapiddoc_tpu.train import layout as jl
    from rapiddoc_tpu_torch.models import registry
    from rapiddoc_tpu_torch.models.layout import engine as layout_engine
    from rapiddoc_tpu_torch.models.weights import flax_variables, load_npz
    from rapiddoc_tpu_torch.train import formula as tf, layout as tl

    vocab = tf.build_vocab()
    tl.save_demo(flax_variables(cases["layout"][1]["model"]), tmp_path / "layout_demo.npz")
    tf.save_demo(tf.checkpoint(cases["formula"][1]["model"]), vocab, tmp_path / "formula_demo.npz")
    assert json.loads((tmp_path / "layout_demo.json").read_text())["conf_threshold"] == 0.4
    meta = json.loads((tmp_path / "formula_demo.json").read_text())
    assert meta == {"arch": tf.DEMO_ARCH, "vocab": vocab}
    # the port: the registries read the demo files from the demo folder
    monkeypatch.setattr(registry, "DEMO_ASSETS_DIR", tmp_path)
    monkeypatch.setattr(layout_engine, "DEMO_ASSETS_DIR", tmp_path)
    det = layout_engine.LayoutDetector.build({"demo_layout": True}, device="cpu",
                                             dtype=torch.float32)
    rec = registry.build_formula_recognizer(device="cpu", dtype=torch.float32)
    saved = load_npz(tmp_path / "layout_demo.npz")
    model = det.session.module
    np.testing.assert_array_equal(model.class_head.bias.detach().numpy(),
                                  saved["params/class_head/bias"])
    fsaved = load_npz(tmp_path / "formula_demo.npz")
    np.testing.assert_array_equal(rec.decoder.embed_positions.detach().numpy(),
                                  fsaved["decoder/params/embed_positions"])
    # the JAX package: the same files through its registry's reader, the
    # two packages' models equal on one input
    jv = _load_variables(tmp_path / "layout_demo.npz")
    x = layout_batch()[0][:1].astype(np.float32) / 255.0
    want = jax.jit(jl.make_model(aux=False).apply)(jv, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]), rtol=0, atol=AUX_TOL)
    fv = _load_variables(tmp_path / "formula_demo.npz")
    enc = fx.jax_formula_modules(len(vocab))[0]
    img = np.random.default_rng(3).uniform(-2, 2, (1, 64, 256, 3)).astype(np.float32)
    jmem = np.asarray(enc.apply(fv["encoder"], jnp.asarray(img)))
    with torch.no_grad():
        tmem = rec.encoder(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(tmem, jmem, rtol=0, atol=AUX_TOL * max(1, np.abs(jmem).max()))


def test_trainers_run_on_the_cpu_only_when_asked(monkeypatch):
    from rapiddoc_tpu_torch.train import formula as tf, layout as tl

    monkeypatch.delenv("RAPIDDOC_PLATFORM", raising=False)
    monkeypatch.delenv("MINERU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for train in (tl.train, tf.train):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(steps=1, out_path=None, device=None)


# ------------------------------------------------------- the smoke's fixture

def test_fixture_is_the_jax_synth():
    with np.load(fx.BATCHES_NPZ) as z:
        stored = {k: z[k] for k in z}
    made = fx.make_batches()
    assert sorted(stored) == sorted(made)
    for k, v in made.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert stored["layout_x"].shape == (2, 640, 640, 3)
    assert stored["formula_x"].shape == (16, 96, 384, 1)
    import chip_smoke  # the smoke draws the golden's augmentation itself

    for a, b in zip(chip_smoke.formula_aug_draws(fx.FIXTURE_SEED, 16),
                    fx.aug_draws(fx.FIXTURE_SEED, 16)):
        np.testing.assert_array_equal(a, b)
    with np.load(fx.MATHTEXT_NPZ) as z:
        renders = {k: z[k] for k in z}
    made = fx.make_mathtext()
    for k, v in made.items():
        np.testing.assert_array_equal(renders[k], v, err_msg=k)
    size = sum(p.stat().st_size for p in fx.ASSETS.glob("mathtext_*")) + sum(
        p.stat().st_size for p in fx.ASSETS.glob("train_layout_smoke_*"))
    assert size <= 4 << 20, size


def test_port_first_steps_meet_golden():
    """The smoke's check on the CPU: the port's fp32 first loss, gradient
    norm and matching on the fixture from the demo checkpoints."""
    golden = json.loads(fx.GOLDEN_JSON.read_text())
    with np.load(fx.BATCHES_NPZ) as z:
        batches = {k: z[k] for k in z}
    got = port_layout_run(demo_flat("layout"), batches["layout_x"], batches["layout_tcls"],
                          batches["layout_tbox"], steps=1)
    want = golden["layout"]
    assert got["loss"] == pytest.approx(want["loss"], rel=GRAD_TOL)
    assert fx.grad_norm(got["grads"]) == pytest.approx(want["grad_norm"], rel=NORM_TOL)
    np.testing.assert_array_equal(got["qcls"], np.array(want["qcls"]))
    got = port_formula_run(demo_flat("formula"), fx.formula_batch(batches), steps=1)
    want = golden["formula"]
    assert got["loss"] == pytest.approx(want["loss"], rel=GRAD_TOL)
    assert fx.grad_norm(got["grads"]) == pytest.approx(want["grad_norm"], rel=NORM_TOL)
