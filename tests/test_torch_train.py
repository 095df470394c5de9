"""The port's trainers (``rapiddoc_tpu_torch/train/``) against the JAX
package's (``rapiddoc_tpu/train/{det,rec,orientation}.py``), in fp32 on
the CPU, at the demo models' full widths and small spatial sizes: det
2 x 64 x 64, rec 2 x 48 x 64 (8 frames), orientation 2 x 64 x 64. The JAX
variables come from ``model.init(PRNGKey(0))`` and are carried across
with ``load_flax_into``; the batches are made from numpy seeds.

- **Step**: the loss and every gradient leaf equal to
  ``jax.value_and_grad`` of the JAX ``loss_fn`` within 1e-4 of the leaf's
  largest magnitude (``flax_variables(model, grads=True)`` gives the
  port's in the JAX layouts). A few leaves have a gradient that is zero
  in exact arithmetic: a bias whose channel goes only into train-mode
  batch norms, which take the batch mean off (DBNet's
  ``head/conv_up/bias``, a stride-2 block's ``token_conv/bn/bias``, the
  rec backbone's last ``token_conv/bias``). Both packages give them
  rounding noise, which no relative tolerance holds; the leaves whose JAX
  gradient is below ``ZERO_LEAF`` of the model's largest gradient are
  held, on both sides, below that same bound instead. The 1e-4 is near
  float32's own reach here: from another init draw (JAX's ``unsafe_rbg``
  generator) two of DBNet's 271 leaves come out 1.3e-4 and 1.6e-4 apart,
  where the port is within 5.3e-5 of a float64 run on every leaf and
  JAX's float32 1.4e-4 from it.
- **Batch statistics**: the running statistics after one train-mode
  forward within 1e-5 of flax's mutated ``batch_stats``.
- **Optimizer**: ``train/optim.py`` fed the same gradients as optax for
  five steps, updates within 1e-6: ``adam`` under the trainers' warm-up
  cosine schedule (its first update at lr 0), and ``clip_by_global_norm``
  before ``adamw`` with the norm above the clip.
- **Three steps**: each trainer's ``make_optimizer`` at its default step
  count and ``train_step`` three times on one batch, the losses within
  1e-3 relative of the JAX trainer's step (``optax.adam`` of the same
  schedule), and the loss's drop over them within 1e-2 of the JAX
  trainer's.
- **CTC**: ``train/rec.ctc_loss`` equal to ``optax.ctc_loss`` on labels
  that have an alignment (optax gives a large finite value where none
  exists, torch inf; only feasible labels are compared).
- **Checkpoints**: an npz the port trains (the demo det and rec, three
  steps) loads in the JAX registry's ``_load_variables`` and in the port's
  loader; det boxes (each side's ``db_postprocess``) and rec argmax ids
  are equal on crops of the OCR fixture (``ocr_smoke_pages.npz``), and
  ``flax_variables`` inverts ``load_flax_into`` exactly for the three
  models.
- **The smoke's fixture**: ``assets/train_smoke_batches.npz`` (det 2
  pages, rec 16 lines, orientation 8 images, made by the JAX synth) is
  what the JAX synth makes now, and the port's fp32 first step from the
  demo checkpoints on it meets ``train_smoke_golden.json``: the JAX
  trainers' step with float64 parameters (the JAX package's float32
  step is recorded beside it: its rec gradient norm is 1.35e-3 from the
  float64 one, see ``NORM_TOL``), the loss within 1e-4 and the gradient
  norm within ``NORM_TOL``.

``python tests/test_torch_train.py`` rebuilds the fixture and the golden
with the JAX package on the CPU in fp32 (about 2 minutes).
"""
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
BATCHES_NPZ = ASSETS / "train_smoke_batches.npz"
GOLDEN_JSON = ASSETS / "train_smoke_golden.json"
JAX_ASSETS = REPO / "rapiddoc_tpu" / "assets"
DEMO = {"det": "ocr_det_demo.npz", "rec": "ocr_rec_demo.npz",
        "orientation": "orientation_demo.npz"}
TRAINERS = ("det", "rec", "orientation")
GRAD_TOL = 1e-4  # of each leaf's largest magnitude; also the loss, relative
ZERO_LEAF = 1e-6  # of the model's largest gradient: a gradient zero but for rounding
STATS_TOL = 1e-5
UPDATE_TOL = 1e-6
STEPS_TOL = 1e-3  # relative, the losses of three steps
# relative, the loss's drop over the three steps (the second step's update
# alone: the first is at lr 0), which a frozen or half-sized update misses
# by 100 % or 50 %; float32 gives 2e-4
DROP_TOL = 1e-2
# relative, the fixture's gradient norm against the float64 golden: its
# largest leaf (the stem's first kernel) sums products over every pixel of
# white pages whose train-mode BN deltas have zero mean, which float32
# holds to 2.3e-4 (the port on the CPU) and 1.35e-3 (the JAX package's
# own float32 run) of the float64 value on the rec batch
NORM_TOL = 1e-3
FIXTURE_SEED = 7
# the fixture's batches: det pages, rec lines, orientation images
FIXTURE_SIZES = {"det": 2, "rec": 16, "orientation": 8}
SMALL_SHAPES = {"det": (2, 64, 64), "rec": (2, 48, 64), "orientation": (2, 64, 64)}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


def port_trainer(name):
    from rapiddoc_tpu_torch.train import det, orientation, rec

    return {"det": det, "rec": rec, "orientation": orientation}[name]


def port_model(name):
    from rapiddoc_tpu_torch.models.ocr.det import DBNet
    from rapiddoc_tpu_torch.models.ocr.rec import SVTRRec
    from rapiddoc_tpu_torch.models.orientation.engine import OrientationNet

    return {"det": DBNet, "rec": lambda: SVTRRec(num_classes=96),
            "orientation": OrientationNet}[name]()


def jax_model(name):
    from rapiddoc_tpu.models.ocr.det import DBNet
    from rapiddoc_tpu.models.ocr.rec import SVTRRec
    from rapiddoc_tpu.models.orientation.engine import OrientationNet

    return {"det": DBNet, "rec": lambda: SVTRRec(num_classes=96),
            "orientation": OrientationNet}[name]()


def jax_loss(name, model):
    """The JAX trainer's loss, ``(params, bstats, *batch) -> (loss, bstats)``
    (orientation's is local to its ``train``; this is its body)."""
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu.train import det, rec
    from rapiddoc_tpu.train.bn import apply_mutable

    if name == "det":
        return lambda p, b, x, y: det.loss_fn(p, b, model, x, y)
    if name == "rec":
        return lambda p, b, x, labels, pad: rec.loss_fn(p, b, model, x, labels, pad)

    def loss_fn(params, bstats, x_u8, y):
        x = x_u8.astype(jnp.float32) / 255.0
        logits, new_bs = apply_mutable(model, params, bstats, x)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), y).mean(), new_bs

    return loss_fn


def jax_schedule(name):
    """The JAX trainer's (default steps, lr, warm-up cap)."""
    return {"det": (1200, 2e-3, 100), "rec": (3000, 1e-3, 200),
            "orientation": (1500, 1e-3, 100)}[name]


def jax_run(name, variables, batch, steps: int = 3):
    """The JAX trainer's step ``steps`` times on ``batch``: the first loss,
    gradients (flat) and mutated batch stats (flat), and every loss."""
    import jax
    import optax

    from rapiddoc_tpu.train.bn import bn_training, split_vars

    model = jax_model(name)
    n, lr, cap = jax_schedule(name)
    tx = optax.adam(optax.warmup_cosine_decay_schedule(0.0, lr, min(cap, n // 10), n))
    params, bstats = split_vars(variables)
    state = tx.init(params)
    losses = []
    with bn_training():
        vg = jax.value_and_grad(jax_loss(name, model), has_aux=True)

        @jax.jit
        def step(params, bstats, state, *batch):
            (loss, new_bs), grads = vg(params, bstats, *batch)
            updates, state = tx.update(grads, state)
            return loss, grads, new_bs, optax.apply_updates(params, updates), state

        for i in range(steps):
            loss, grads, bstats, params, state = step(params, bstats, state, *batch)
            if i == 0:
                first = {"loss": float(loss), "grads": flat(grads), "bstats": flat(bstats)}
            losses.append(float(loss))
    return {**first, "losses": losses}


def port_run(name, flat_vars, batch, steps: int = 3, device: str = "cpu"):
    """The port's ``train_step`` ``steps`` times on ``batch`` from
    ``flat_vars``, as :func:`jax_run` reads the JAX trainer."""
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables, load_flax_into
    from rapiddoc_tpu_torch.train.bn import bn_training

    trainer = port_trainer(name)
    model = load_flax_into(port_model(name), flat_vars).to(device)
    n, _, _ = jax_schedule(name)
    opt = trainer.make_optimizer(model, n)
    xs = [torch.from_numpy(np.asarray(a)).to(device) for a in batch]
    losses = []
    with bn_training(model):
        for i in range(steps):
            losses.append(float(trainer.train_step(model, opt, *xs)))
            if i == 0:
                first = {"loss": losses[0],
                         "grads": flatten(flax_variables(model, grads=True)["params"]),
                         "bstats": flatten(flax_variables(model)["batch_stats"])}
    return {**first, "losses": losses, "model": model}


def flat(tree) -> dict:
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if hasattr(v, "items"):
                walk(v, key)
            else:
                out[key] = np.asarray(v)

    walk(tree, "")
    return out


def small_batch(name):
    """Seeded inputs at the small shapes; rec labels fit 8 frames."""
    rng = np.random.default_rng({"det": 1, "rec": 2, "orientation": 3}[name])
    b, h, w = SMALL_SHAPES[name]
    x = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    if name == "det":
        y = np.zeros((b, h, w), np.uint8)
        y[0, 10:20, 8:50] = 1
        y[1, 30:38, 4:60] = 1
        x[y.astype(bool)] //= 4  # ink where the target is
        return (x, y)
    if name == "rec":
        labels = np.zeros((b, 32), np.int32)
        pad = np.ones((b, 32), np.float32)
        for i, ids in enumerate(([5, 6, 7], [40, 40, 12])):
            labels[i, :len(ids)] = ids
            pad[i, :len(ids)] = 0.0
        return (x, labels, pad)
    return (x, np.array([1, 3], np.int32))


def jax_case(name):
    """The JAX init and three steps of one trainer on its small batch."""
    import jax
    import jax.numpy as jnp

    b, h, w = SMALL_SHAPES[name]
    variables = jax.jit(jax_model(name).init)(jax.random.PRNGKey(0), jnp.zeros((1, h, w, 3)))
    return variables, jax_run(name, variables, small_batch(name))


@pytest.fixture(scope="module")
def jax_cases():
    """Every trainer's JAX runs, in threads: XLA compiles without the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(TRAINERS)) as pool:
        return dict(zip(TRAINERS, pool.map(jax_case, TRAINERS)))


@pytest.fixture(scope="module", params=TRAINERS)
def case(request, jax_cases):
    """One trainer's JAX and port runs from the JAX init on its batch."""
    name = request.param
    variables, want = jax_cases[name]
    return name, want, port_run(name, flat(variables), small_batch(name))


def test_step_loss_and_gradients_match_jax(case):
    name, want, got = case
    assert abs(got["loss"] - want["loss"]) <= GRAD_TOL * abs(want["loss"]), (got["loss"], want["loss"])
    assert sorted(got["grads"]) == sorted(want["grads"])
    top = max(float(np.abs(g).max()) for g in want["grads"].values())
    worst, zero = {}, []
    for k, g in want["grads"].items():
        scale = float(np.abs(g).max())
        if scale < ZERO_LEAF * top:
            zero.append(k)
            if float(np.abs(got["grads"][k]).max()) >= ZERO_LEAF * top:
                worst[k] = ("not zero", float(np.abs(got["grads"][k]).max()), top)
            continue
        err = float(np.abs(got["grads"][k] - g).max())
        if err > GRAD_TOL * scale:
            worst[k] = (err, scale)
    assert not worst, worst
    assert len(zero) <= 6, zero


def test_batch_statistics_match_flax(case):
    name, want, got = case
    assert sorted(got["bstats"]) == sorted(want["bstats"])
    for k, v in want["bstats"].items():
        np.testing.assert_allclose(got["bstats"][k], v, rtol=0, atol=STATS_TOL, err_msg=k)


def test_three_steps_match_jax(case):
    name, want, got = case
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEPS_TOL, atol=0)
    drop, want_drop = got["losses"][0] - got["losses"][2], want["losses"][0] - want["losses"][2]
    assert abs(drop - want_drop) <= DROP_TOL * abs(want_drop), (drop, want_drop)
    # the first step's update is at lr 0: the second loss differs from the
    # first only through the batch statistics, which BN does not read in
    # train mode
    assert got["losses"][1] == pytest.approx(got["losses"][0], rel=1e-6)
    assert got["losses"][2] != got["losses"][1]


@pytest.mark.parametrize("kind", ["adam_warmup", "clip_adamw"])
def test_optimizer_matches_optax(kind):
    import jax
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu_torch.train import optim

    rng = np.random.default_rng(11)
    shapes = [(3, 3, 4, 8), (8,), (16, 5)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if kind == "adam_warmup":
        tx = optax.adam(optax.warmup_cosine_decay_schedule(0.0, 2e-3, 2, 8))
        port = optim.adam([torch.tensor(p) for p in params],
                          optim.warmup_cosine_decay_schedule(0.0, 2e-3, 2, 8))
    else:
        tx = optax.chain(optax.clip_by_global_norm(1.0),
                         optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 6)))
        port = optim.adamw([torch.tensor(p) for p in params],
                           optim.warmup_cosine_decay_schedule(0.0, 1e-3, 1, 6), max_norm=1.0)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    update = jax.jit(tx.update)
    for step in range(5):
        grads = [rng.standard_normal(s).astype(np.float32) * (1 + step) for s in shapes]
        if kind == "clip_adamw":
            assert np.sqrt(sum((g * g).sum() for g in grads)) > 1.0  # the clip acts
        want, state = update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, want)
        got = port.updates([torch.tensor(g) for g in grads])
        for w, g in zip(want, got):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=UPDATE_TOL)
            if step == 0 and kind == "adam_warmup":
                assert not np.asarray(w).any()  # lr 0 at count 0
        for p, u in zip(port.params, got):
            p.add_(u)


def test_schedule_matches_optax():
    import optax

    from rapiddoc_tpu_torch.train.optim import warmup_cosine_decay_schedule

    for args in ((0.0, 2e-3, 100, 1200), (0.0, 1e-3, 0, 3), (1e-4, 1e-3, 5, 40, 1e-5)):
        want = optax.warmup_cosine_decay_schedule(*args)
        got = warmup_cosine_decay_schedule(*args)
        for count in (0, 1, 2, 3, 4, 5, 50, 99, 100, 101, 600, 1199, 1200, 5000):
            assert got(count) == pytest.approx(float(want(count)), rel=1e-6, abs=1e-12), (args, count)
    with pytest.raises(ValueError):
        warmup_cosine_decay_schedule(0.0, 1e-3, 10, 10)


def test_clip_by_global_norm_is_optax_formula():
    from rapiddoc_tpu_torch.train.optim import clip_by_global_norm

    g = [torch.tensor([3.0, 4.0])]
    assert torch.equal(clip_by_global_norm(g, 5.0)[0], torch.tensor([3.0, 4.0]) / 5.0 * 5.0)
    assert torch.equal(clip_by_global_norm(g, 6.0)[0], g[0])  # below the clip: as is
    assert torch.equal(clip_by_global_norm(g, 2.0)[0], g[0] / 5.0 * 2.0)


def test_ctc_loss_matches_optax_on_feasible_labels():
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu_torch.train.rec import ctc_loss

    rng = np.random.default_rng(5)
    b, t, v = 4, 12, 9
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * 3
    labels = np.zeros((b, 8), np.int32)
    pad = np.ones((b, 8), np.float32)
    for i, ids in enumerate(([1, 2, 3], [4, 4, 4, 4, 4], [8], [2, 3, 2, 3, 2, 3])):
        labels[i, :len(ids)] = ids
        pad[i, :len(ids)] = 0
    want = np.asarray(optax.ctc_loss(jnp.asarray(logits), jnp.zeros((b, t)), jnp.asarray(labels),
                                     jnp.asarray(pad), blank_id=0))
    got = ctc_loss(torch.tensor(logits), torch.tensor(labels), torch.tensor(pad)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_flax_variables_inverts_load_flax_into():
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables, init_params, load_flax_into

    for name in TRAINERS:
        m = port_model(name)
        init_params(m, torch.Generator().manual_seed(3))
        with torch.no_grad():
            for mod in m.modules():
                if hasattr(mod, "running_var"):
                    mod.running_mean.normal_(generator=torch.Generator().manual_seed(4))
        back = load_flax_into(port_model(name), flatten(flax_variables(m)))
        for (k, a), (k2, b) in zip(m.state_dict().items(), back.state_dict().items()):
            assert k == k2 and torch.equal(a, b), k


def test_gru_and_embedding_round_trip():
    from torch import nn

    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables, load_flax_into

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.cell = nn.GRUCell(5, 4)
            self.embed = nn.Embedding(7, 3)

    net = Net()
    with torch.no_grad():
        net.cell.bias_hh[8:].normal_()
        net.cell.bias_hh[:8].zero_()  # flax has no recurrent r, z biases
    leaves = flatten(flax_variables(net))
    assert sorted(leaves) == sorted(
        [f"params/cell/{g}/kernel" for g in ("ir", "iz", "in", "hr", "hz", "hn")]
        + [f"params/cell/{g}/bias" for g in ("ir", "iz", "in", "hn")]
        + ["params/embed/embedding"])
    back = load_flax_into(Net(), leaves)
    for (k, a), (_, b) in zip(net.state_dict().items(), back.state_dict().items()):
        assert torch.equal(a, b), k


def test_trainers_run_on_the_cpu_only_when_asked(monkeypatch):
    from rapiddoc_tpu_torch.engine import session

    monkeypatch.delenv("RAPIDDOC_PLATFORM", raising=False)
    monkeypatch.delenv("MINERU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in TRAINERS:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_trainer(name).train(steps=1, out_path=None, device=None)
    assert session.resolve_device("cpu").type == "cpu"


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The demo det and rec after three of the port's steps on small
    batches, written as npz."""
    from rapiddoc_tpu_torch.models.weights import flax_variables, load_npz, save_variables

    out = tmp_path_factory.mktemp("trained")
    paths = {}
    for name in ("det", "rec"):
        got = port_run(name, load_npz(JAX_ASSETS / DEMO[name]), small_batch(name))
        paths[name] = out / f"{name}.npz"
        save_variables(flax_variables(got["model"]), paths[name])
    return paths


def test_port_checkpoint_loads_in_both_registries(trained):
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.ocr import pre_post as jpp
    from rapiddoc_tpu.models.registry import _load_variables
    from rapiddoc_tpu_torch.models.ocr import pre_post as tpp
    from rapiddoc_tpu_torch.models.ocr.det import DBNet
    from rapiddoc_tpu_torch.models.ocr.rec import SVTRRec
    from rapiddoc_tpu_torch.models.registry import _load_if
    from rapiddoc_tpu_torch.models.weights import load_flax_into, load_npz

    with np.load(ASSETS / "ocr_smoke_pages.npz") as z:
        page = z["pages"][0]
    demo = load_npz(JAX_ASSETS / DEMO["det"])
    assert any(not np.array_equal(v, demo[k]) for k, v in load_npz(trained["det"]).items())
    # det: two crops of the fixture page
    crops = np.stack([page[96:224, 32:224], page[400:528, 500:692]])
    x = ((crops.astype(np.float32) / 255.0 - np.array(tpp.IMAGENET_MEAN, np.float32))
         / np.array(tpp.IMAGENET_STD, np.float32)).astype(np.float32)
    jprob = np.asarray(jax.jit(jax_model("det").apply)(_load_variables(trained["det"]), jnp.asarray(x)))
    det = load_flax_into(DBNet(), _load_if(trained["det"])).eval()
    with torch.no_grad():
        tprob = det(torch.from_numpy(x)).numpy()
    n_boxes = 0
    for jp, tp in zip(jprob, tprob):
        jb, _ = jpp.db_postprocess(jp, 128, 192)
        tb, _ = tpp.db_postprocess(tp, 128, 192)
        assert len(jb) == len(tb) and np.array_equal(np.asarray(jb), np.asarray(tb))
        n_boxes += len(tb)
    assert n_boxes > 0
    # rec: text lines of the fixture page, argmax ids through the JAX
    # model's dense head and the port's fused head (its plain version here)
    lines = np.stack([page[100:148, 40:360], page[140:188, 40:360]]).astype(np.float32)
    xr = lines / 127.5 - 1.0
    jlog = np.asarray(jax.jit(jax_model("rec").apply)(_load_variables(trained["rec"]), jnp.asarray(xr)))
    rec = load_flax_into(SVTRRec(num_classes=96), _load_if(trained["rec"])).eval()
    with torch.no_grad():
        ids, _ = rec(torch.from_numpy(xr))
    top2 = np.sort(jlog, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-3
    np.testing.assert_array_equal(ids.numpy()[clear], jlog.argmax(-1)[clear])
    assert clear.mean() > 0.9


# ------------------------------------------------------- the smoke's fixture

def make_batches() -> dict:
    """The JAX synth's batches for the smoke (``FIXTURE_SEED``)."""
    from rapiddoc_tpu.train import det, orientation, rec

    x, y = det.make_pool(FIXTURE_SIZES["det"], FIXTURE_SEED)
    lines, labels, pad = rec.make_pool(FIXTURE_SIZES["rec"], FIXTURE_SEED)
    imgs, angles = orientation.make_pool(FIXTURE_SIZES["orientation"], FIXTURE_SEED)
    return {"det_x": x, "det_y": y, "rec_x": lines, "rec_labels": labels, "rec_pad": pad,
            "orientation_x": imgs, "orientation_y": angles}


def fixture_batch(batches: dict, name: str) -> tuple:
    if name == "det":
        return (batches["det_x"], batches["det_y"])
    if name == "rec":
        return (batches["rec_x"], batches["rec_labels"], batches["rec_pad"])
    return (batches["orientation_x"], batches["orientation_y"])


def grad_norm(grads: dict) -> float:
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))


def make_golden(batches: dict) -> dict:
    """The JAX trainers' first loss, gradient global norm and three losses
    from the demo checkpoints on the fixture's batches, with the
    parameters in float64 (``jax_enable_x64``; the losses' own float32
    casts stay), and the same in float32 (``*_fp32``, for the record)."""
    import jax

    from rapiddoc_tpu.models.registry import _load_variables

    out = {"seed": FIXTURE_SEED, "steps": 3}
    for name in TRAINERS:
        variables = _load_variables(JAX_ASSETS / DEMO[name])
        wide = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
        runs = {"": jax_run(name, wide, fixture_batch(batches, name)),
                "_fp32": jax_run(name, variables, fixture_batch(batches, name))}
        out[name] = {"schedule": list(jax_schedule(name))}
        for tag, run in runs.items():
            out[name].update({f"loss{tag}": run["loss"], f"grad_norm{tag}": grad_norm(run["grads"]),
                              f"losses{tag}": run["losses"]})
    return out


def test_fixture_is_the_jax_synth():
    with np.load(BATCHES_NPZ) as z:
        stored = {k: z[k] for k in z}
    made = make_batches()
    assert sorted(stored) == sorted(made)
    for k, v in made.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    assert BATCHES_NPZ.stat().st_size <= 4 << 20


@pytest.mark.parametrize("name", ["rec", "orientation"])
def test_port_first_step_meets_golden(name):
    """The smoke's check on the CPU: the port's fp32 first loss and gradient
    norm on the fixture from the demo checkpoint (det, at 640 x 640, is
    left to the card)."""
    from rapiddoc_tpu_torch.models.weights import load_npz

    golden = json.loads(GOLDEN_JSON.read_text())[name]
    with np.load(BATCHES_NPZ) as z:
        batches = {k: z[k] for k in z}
    got = port_run(name, load_npz(JAX_ASSETS / DEMO[name]), fixture_batch(batches, name), steps=1)
    assert got["loss"] == pytest.approx(golden["loss"], rel=GRAD_TOL)
    assert grad_norm(got["grads"]) == pytest.approx(golden["grad_norm"], rel=NORM_TOL)


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["JAX_ENABLE_X64"] = "1"  # the golden's float64 runs
    sys.path.insert(0, str(REPO))
    made = make_batches()
    np.savez_compressed(BATCHES_NPZ, **made)
    GOLDEN_JSON.write_text(json.dumps(make_golden(made), indent=1) + "\n")
    print("wrote", BATCHES_NPZ, BATCHES_NPZ.stat().st_size, "bytes;", GOLDEN_JSON)
