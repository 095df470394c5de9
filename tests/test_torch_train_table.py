"""The port's table trainers (``rapiddoc_tpu_torch/train/{table,unitable}.py``)
against the JAX package's (``rapiddoc_tpu/train/{table,unitable}.py``), in
fp32 on the CPU, at small sizes: UNet 2 x 64 x 64, the classifier 2 x 64 x
64, SLANet 2 x 128 x 128 with 12 head steps, UniTable at ``enc_d = dec_d =
128`` (two layers each) with 24 tokens over 16 patches. The JAX variables
come from ``init(PRNGKey(0))`` as the JAX trainers make them and are
carried across with ``load_flax_into``; the batches are made from numpy
seeds. The JAX trainers' losses are closures inside their ``train_*``; the
bodies are copied here (``jax_loss``), returning the argmax streams too.

- **Step**: the loss and every gradient leaf equal to
  ``jax.value_and_grad`` of the JAX loss, its parameters in float64
  (``jax.enable_x64``; the losses' own float32 casts stay), within
  ``GRAD_TOL`` of the leaf's largest magnitude. The JAX package's own
  float32 step is not the reference: on the UNet its gradients are up to
  5.5e-3 of a leaf's scale from the float64 step's, where the port's are
  within 7e-6. The leaves whose JAX gradient is below ``ZERO_LEAF``
  of the model's largest held below that bound on both sides (the neck's
  unused last level, biases feeding train-mode batch norms), as in
  ``tests/test_torch_train.py``; SLANet's and UniTable's with
  scheduled-sampling coins set, their argmax streams equal.
- **Batch statistics** within 1e-5 of flax's mutated ``batch_stats``.
- **Three steps** with each trainer's optimizer at its default step count:
  the losses within 1e-3 relative, the drop over them within 1e-2.
- **The GRU's extra biases**: one SLANet step at a constant learning rate
  meets optax's with ``flax_gru_grads`` and misses it without.
- **Checkpoints**: the trained models written as the trainers write them,
  read by the JAX registry's ``_load_variables`` and by the port's
  ``TableRecognizer.build`` (``RAPIDDOC_MODELS_DIR``): UNet line bits
  (but near-ties), classifier labels, SLANet and UniTable token ids equal.
- ``DEMO_UNITABLE_DIMS`` equal to the JAX constant; the decoder's old
  stacked caches failing a backward pass; the trainers refusing the CPU
  unless asked.
- **The smoke's fixture**: ``assets/train_table_smoke_batches.npz`` is what
  the JAX synth makes now (the UNet's table stored at its own size, made
  1024 x 1024 by ``table.unet_pool_row``), and the port's fp32 first step
  from the demo checkpoints meets ``train_table_smoke_golden.json`` (the
  JAX trainers' step with float64 parameters; the losses' own float32
  casts stay) for each of the four at its full shape.

``python tests/test_torch_train_table.py`` rebuilds the fixture and the
golden with the JAX package on the CPU (about 3 minutes).
"""
import dataclasses
import json
import os
import random
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tests"))

ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
BATCHES_NPZ = ASSETS / "train_table_smoke_batches.npz"
GOLDEN_JSON = ASSETS / "train_table_smoke_golden.json"
JAX_ASSETS = REPO / "rapiddoc_tpu" / "assets"
TRAINERS = ("unet", "cls", "slanet", "unitable")
GRAD_TOL = 1e-4  # of each leaf's largest magnitude; also the loss, relative
ZERO_LEAF = 1e-6  # of the model's largest gradient: a gradient zero but for rounding
STATS_TOL = 1e-5
STEPS_TOL = 1e-3  # relative, the losses of three steps
DROP_TOL = 1e-2  # relative, the loss's drop over them
NORM_TOL = 1e-3  # relative, the fixture's gradient norm against the float64 golden
FIXTURE_SEED = 7
COIN_P = 0.35  # the scheduled-sampling rate the JAX trainers ramp to
SMALL_DIMS = {"enc_d": 128, "enc_layers": 2, "dec_d": 128, "dec_layers": 2, "dec_ffn": 256}
# (default steps, peak lr, warm-up cap) of each JAX trainer's schedule
SCHEDULES = {"unet": (1500, 1e-3, 100), "cls": (1200, 1e-3, 100), "slanet": (4000, 1e-3, 200),
             "unitable": (12000, 2e-4, 200)}
SMALL_STEPS, SMALL_TOKENS = 12, 24


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Few torch threads while this file runs (``tests/torch_threads.py``)."""
    from torch_threads import capped_threads

    yield from capped_threads(4)


# ------------------------------------------------------------- JAX side

def jax_init(name: str, hw: tuple[int, int], dims=None) -> dict:
    """The JAX trainer's init at input size ``hw``, in the checkpoint's
    layout."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    x0 = np.zeros((1, *hw, 3), np.float32)
    if name in ("unet", "cls"):
        from rapiddoc_tpu.models.table.cls import TableClsNet
        from rapiddoc_tpu.models.table.unet import UNet

        return jax.jit((UNet() if name == "unet" else TableClsNet()).init)(key, x0)
    if name == "slanet":
        from rapiddoc_tpu.models.table.slanet import (FeaKey, PANNeck, SLAHeadStep, SLANetBackbone,
                                                      SLANetConfig, SLANetVocab)

        cfg, vocab = SLANetConfig(), SLANetVocab()
        backbone, neck = SLANetBackbone(cfg.scale), PANNeck(cfg.neck_ch)

        def fea_map(key):
            bb = backbone.init(key, x0)
            feats = backbone.apply(bb, x0)
            nk = neck.init(key, feats)
            return bb, nk, neck.apply(nk, feats)

        shape = jax.eval_shape(fea_map, key)[2].shape
        s = shape[1] * shape[2]

        def init(key):  # the JAX trainer's, in one program
            bb, nk, _ = fea_map(key)
            fea0 = jnp.zeros((1, s, cfg.neck_ch), jnp.float32)
            return {"backbone": bb, "neck": nk, "fea_key": FeaKey(cfg.hidden).init(key, fea0),
                    "step": SLAHeadStep(len(vocab), cfg.hidden).init(
                        key, jnp.zeros((1, cfg.hidden), jnp.float32), jnp.zeros((1,), jnp.int32),
                        fea0, jnp.zeros((1, s, cfg.hidden), jnp.float32))}

        return jax.jit(init)(key)
    from rapiddoc_tpu.models.formula.decoder import MemoryProjector
    from rapiddoc_tpu.models.table.unitable import GPTFastDecoder, UniTableEncoder

    s = (hw[0] // 16) * (hw[1] // 16)
    hd = dims.d_model // dims.heads
    cache = np.zeros((dims.layers, 1, 8, dims.heads, hd), np.float32)
    mem = np.zeros((dims.layers, 1, s, dims.heads, hd), np.float32)

    def init(key):
        return {"encoder": UniTableEncoder(d_model=dims.enc_d, layers=dims.enc_layers,
                                           heads=dims.enc_heads).init(key, x0),
                "decoder": GPTFastDecoder(cfg=dims).init(key, np.zeros((1, 1), np.int32), cache,
                                                         cache, 0, mem, mem, np.ones((1, s), bool)),
                "mem_proj": MemoryProjector(dims).init(key, np.zeros((1, s, dims.d_model),
                                                                     np.float32))}

    return jax.jit(init)(key)


def jax_split(name: str, variables: dict) -> tuple[dict, dict]:
    """(trainable, batch stats) as the JAX trainer splits them."""
    if name in ("unet", "cls"):
        return variables["params"], variables.get("batch_stats", {})
    if name == "slanet":
        return ({"backbone": variables["backbone"]["params"], "neck": variables["neck"]["params"],
                 "fea_key": variables["fea_key"], "step": variables["step"]},
                {"backbone": variables["backbone"]["batch_stats"],
                 "neck": variables["neck"]["batch_stats"]})
    return variables, {}


def jax_loss(name: str, dims=None):
    """The body of the JAX trainer's ``loss_fn``, as ``(trainable, bstats,
    *batch) -> (loss, (new batch stats, argmax stream or None))``. The only
    change: SLANet's hidden state starts in the parameters' dtype, which
    the float64 golden needs for ``lax.scan``'s carry (float32 as in the
    trainer otherwise)."""
    import jax
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu.train.bn import apply_mutable

    if name == "unet":
        from rapiddoc_tpu.models.table.unet import UNet

        model = UNet()

        def loss_fn(params, bstats, x_u8, y_u8):
            x = x_u8.astype(jnp.float32) / 255.0
            y = y_u8.astype(jnp.float32)
            logits, new_bs = apply_mutable(model, params, bstats, x)
            logits = logits.astype(jnp.float32)
            logp = jax.nn.log_softmax(logits, axis=-1)
            ce = -(y * logp[..., 1] + (1 - y) * logp[..., 0])
            pos = y.sum() + 1.0
            w = pos / (y.size - pos + 1.0) * 3.0
            ce = jnp.where(y > 0.5, ce, ce * w).mean()
            p = jax.nn.softmax(logits, axis=-1)[..., 1]
            dice = 1.0 - 2.0 * (p * y).sum() / (p.sum() + y.sum() + 1.0)
            return ce + dice, (new_bs, None)

        return loss_fn
    if name == "cls":
        from rapiddoc_tpu.models.table.cls import TableClsNet

        model = TableClsNet()

        def loss_fn(params, bstats, x_u8, y):
            x = x_u8.astype(jnp.float32) / 255.0
            logits, new_bs = apply_mutable(model, params, bstats, x)
            return optax.softmax_cross_entropy_with_integer_labels(
                logits.astype(jnp.float32), y).mean(), (new_bs, None)

        return loss_fn
    if name == "slanet":
        from rapiddoc_tpu.models.table.slanet import (IMAGENET_MEAN, IMAGENET_STD, FeaKey, PANNeck,
                                                      SLAHeadStep, SLANetBackbone, SLANetConfig,
                                                      SLANetVocab)

        cfg, vocab = SLANetConfig(), SLANetVocab()
        backbone, neck = SLANetBackbone(cfg.scale), PANNeck(cfg.neck_ch)
        step_mod, fea_key = SLAHeadStep(len(vocab), cfg.hidden), FeaKey(cfg.hidden)

        def loss_fn(trainable, bstats, x_u8, tok, loc, lmask, lens, coins):
            x = x_u8.astype(jnp.float32) / 255.0
            x = (x - jnp.asarray(IMAGENET_MEAN)) / jnp.asarray(IMAGENET_STD)
            feats, bb_upd = backbone.apply(
                {"params": trainable["backbone"], "batch_stats": bstats["backbone"]},
                x, mutable=["batch_stats"])
            fea_map, neck_upd = neck.apply(
                {"params": trainable["neck"], "batch_stats": bstats["neck"]},
                feats, mutable=["batch_stats"])
            new_bs = {"backbone": bb_upd["batch_stats"], "neck": neck_upd["batch_stats"]}
            b, h, w, c = fea_map.shape
            fea = fea_map.reshape(b, h * w, c).astype(jnp.float32)
            fkey = fea_key.apply(trainable["fea_key"], fea)
            B, T = tok.shape
            prev = jnp.concatenate([jnp.full((B, 1), vocab.sos_id, jnp.int32), tok[:, :-1]], axis=1)
            wdt = trainable["step"]["params"]["gru"]["hn"]["kernel"].dtype
            hidden = jnp.zeros((B, cfg.hidden), jnp.result_type(fea.dtype, wdt))
            prev_pred0 = jnp.full((B,), vocab.sos_id, jnp.int32)

            def scan_body(carry, inputs):
                hidden, prev_pred = carry
                gt_prev, coin = inputs
                prev_t = jnp.where(coin, prev_pred, gt_prev)
                hidden, logits, locp = step_mod.apply(trainable["step"], hidden, prev_t, fea, fkey)
                pred = jnp.argmax(jax.lax.stop_gradient(logits).astype(jnp.float32),
                                  axis=-1).astype(jnp.int32)
                return (hidden, pred), (logits, locp, pred)

            (_, _), (logits, locp, preds) = jax.lax.scan(
                scan_body, (hidden, prev_pred0), (prev.T, coins))
            logits = jnp.transpose(logits, (1, 0, 2)).astype(jnp.float32)
            locp = jnp.transpose(locp, (1, 0, 2)).astype(jnp.float32)
            step_mask = (jnp.arange(T)[None, :] < lens[:, None]).astype(jnp.float32)
            ce = optax.softmax_cross_entropy_with_integer_labels(logits, tok)
            ce = (ce * step_mask).sum() / jnp.maximum(step_mask.sum(), 1.0)
            l1 = (jnp.abs(locp - loc).sum(-1) * lmask).sum() / jnp.maximum(lmask.sum(), 1.0)
            return ce + 2.0 * l1, (new_bs, preds.T)

        return loss_fn
    from rapiddoc_tpu.models.formula.decoder import MemoryProjector
    from rapiddoc_tpu.models.table.unitable import (BBOX_BASE, N_BBOX_BINS, PREFIX_ID, UNITABLE_MEAN,
                                                    UNITABLE_STD, GPTFastDecoder, UniTableEncoder)

    cfg = dims
    encoder = UniTableEncoder(d_model=dims.enc_d, layers=dims.enc_layers, heads=dims.enc_heads)
    decoder, mem_proj = GPTFastDecoder(cfg=dims), MemoryProjector(dims)
    hd = cfg.d_model // cfg.heads

    def _decode_full(variables, prev, mem_k, mem_v, mem_mask):
        B, T = prev.shape
        caches_k = jnp.zeros((cfg.layers, B, T, cfg.heads, hd), jnp.float32)
        caches_v = jnp.zeros_like(caches_k)
        logits, _, _ = decoder.apply(variables["decoder"], prev, caches_k, caches_v, 0,
                                     mem_k, mem_v, mem_mask)
        return logits.astype(jnp.float32)

    def loss_fn(variables, bstats, x_u8, tok, lens, coins):
        x = x_u8.astype(jnp.float32) / 255.0
        x = (x - UNITABLE_MEAN) / UNITABLE_STD
        memory = encoder.apply(variables["encoder"], x)
        mem_k, mem_v = mem_proj.apply(variables["mem_proj"], memory)
        mem_mask = jnp.ones(memory.shape[:2], bool)
        B, T = tok.shape
        prev = jnp.concatenate([jnp.full((B, 1), PREFIX_ID, jnp.int32), tok[:, :-1]], axis=1)
        logits1 = _decode_full(jax.lax.stop_gradient(variables), prev,
                               jax.lax.stop_gradient(mem_k), jax.lax.stop_gradient(mem_v), mem_mask)
        pred = jnp.argmax(logits1, axis=-1).astype(jnp.int32)
        model_prev = jnp.concatenate([jnp.full((B, 1), PREFIX_ID, jnp.int32), pred[:, :-1]], axis=1)
        mixed = jnp.where(coins, model_prev, prev)
        logits = _decode_full(variables, mixed, mem_k, mem_v, mem_mask)
        mask = (jnp.arange(T)[None, :] < lens[:, None]).astype(jnp.float32)
        is_bbox = (tok >= BBOX_BASE) & (tok < BBOX_BASE + N_BBOX_BINS)
        logp = jax.nn.log_softmax(logits, axis=-1)

        def _nll(ids):
            return -jnp.take_along_axis(logp, ids[..., None], axis=-1)[..., 0]

        ce_hard = _nll(tok)
        lo = jnp.maximum(tok - 1, BBOX_BASE)
        hi = jnp.minimum(tok + 1, BBOX_BASE + N_BBOX_BINS - 1)
        ce_bbox = 0.7 * ce_hard + 0.15 * _nll(lo) + 0.15 * _nll(hi)
        ce = jnp.where(is_bbox, ce_bbox, ce_hard)
        loss = (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
        return loss, ({}, pred)

    return loss_fn


def jax_tx(name: str, lr=None):
    """The JAX trainer's optimizer at its default step count (or a constant
    ``lr`` in the schedule's place)."""
    import optax

    n, peak, cap = SCHEDULES[name]
    sched = lr if lr is not None else optax.warmup_cosine_decay_schedule(0.0, peak, min(cap, n // 10), n)
    if name in ("unet", "cls"):
        return optax.adam(sched)
    if name == "slanet":
        return optax.chain(optax.clip_by_global_norm(1.0), optax.adam(sched))
    return optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))


def jax_run(name, variables, batch, steps: int = 3, dims=None, lr=None):
    """The JAX trainer's step ``steps`` times on ``batch``: the first loss,
    gradients, batch stats and argmax stream (flat, as the port names
    them), every loss, and the trainable tree after the last step."""
    import jax
    import optax

    from rapiddoc_tpu.train.bn import bn_training

    tx = jax_tx(name, lr)
    trainable, bstats = jax_split(name, variables)
    state = tx.init(trainable)
    losses = []
    with bn_training():
        vg = jax.value_and_grad(jax_loss(name, dims), has_aux=True)

        @jax.jit
        def step(trainable, bstats, state, *batch):
            (loss, (new_bs, preds)), grads = vg(trainable, bstats, *batch)
            updates, state = tx.update(grads, state, trainable)
            return loss, grads, new_bs, preds, optax.apply_updates(trainable, updates), state

        for i in range(steps):
            loss, grads, new_bs, preds, trainable, state = step(trainable, bstats, state, *batch)
            if name != "unitable":
                bstats = new_bs
            if i == 0:
                first = {"loss": float(loss), "grads": flat(grads), "bstats": flat(new_bs),
                         "preds": None if preds is None else np.asarray(preds), "tree": grads}
            losses.append(float(loss))
    return {**first, "losses": losses, "trainable": trainable}


def flat(tree) -> dict:
    """Flat ``a/b/c`` leaves, flax's inner ``params`` level taken out (the
    port's ``flax_variables`` puts it on top)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if hasattr(v, "items"):
                walk(v, key)
            else:
                out[key.replace("/params/", "/")] = np.asarray(v)

    walk(tree, "")
    return out


def checkpoint_flat(tree) -> dict:
    """A checkpoint tree -> its flat npz leaves."""
    from rapiddoc_tpu_torch.models.weights import flatten

    return flatten(tree)


# ------------------------------------------------------------ port side

def port_model(name: str, flat_vars: dict):
    from rapiddoc_tpu_torch.models.table.cls import TableClsNet
    from rapiddoc_tpu_torch.models.table.slanet import SLANetConfig, SLANetModel, SLANetVocab
    from rapiddoc_tpu_torch.models.table.unet import UNet
    from rapiddoc_tpu_torch.models.table.unitable import UniTableModel, dims_from_variables
    from rapiddoc_tpu_torch.models.weights import load_flax_into, nest_models

    if name == "unet":
        return load_flax_into(UNet(), flat_vars)
    if name == "cls":
        return load_flax_into(TableClsNet(), flat_vars)
    if name == "slanet":
        return load_flax_into(SLANetModel(SLANetConfig(), len(SLANetVocab())), nest_models(flat_vars))
    return load_flax_into(UniTableModel(dims_from_variables(flat_vars)), nest_models(flat_vars))


def port_trainer(name: str):
    """(make_optimizer, train_step -> (loss, argmax stream or None))."""
    from rapiddoc_tpu_torch.train import table, unitable

    if name == "unet":
        return table.unet_optimizer, lambda *a: (table.unet_train_step(*a), None)
    if name == "cls":
        return table.cls_optimizer, lambda *a: (table.cls_train_step(*a), None)
    if name == "slanet":
        return table.slanet_optimizer, table.slanet_train_step

    def unitable_step(*args):
        loss, (_, _, pred) = unitable.train_step(*args)
        return loss, pred

    return unitable.make_optimizer, unitable_step


def port_run(name, flat_vars, batch, steps: int = 3, device: str = "cpu"):
    """The port's ``train_step`` ``steps`` times on ``batch`` from
    ``flat_vars``, as :func:`jax_run` reads the JAX trainer."""
    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables
    from rapiddoc_tpu_torch.train.bn import bn_training

    model = port_model(name, flat_vars).to(device)
    make_opt, step = port_trainer(name)
    opt = make_opt(model, SCHEDULES[name][0])
    xs = [torch.from_numpy(np.asarray(a)).to(device) for a in batch]
    losses = []
    with bn_training(model):
        for i in range(steps):
            loss, preds = step(model, opt, *xs)
            losses.append(float(loss))
            if i == 0:
                v = flax_variables(model)
                first = {"loss": losses[0],
                         "grads": flatten(flax_variables(model, grads=True)["params"]),
                         "bstats": flatten(v.get("batch_stats", {})),
                         "preds": None if preds is None else preds.cpu().numpy()}
    return {**first, "losses": losses, "model": model}


# ---------------------------------------------------------- the batches

def small_dims():
    from rapiddoc_tpu.models.table.unitable import UniTableDims

    return UniTableDims(**SMALL_DIMS)


def small_batch(name):
    """Seeded inputs at the small shapes; coins at ``COIN_P``."""
    rng = np.random.default_rng({"unet": 1, "cls": 2, "slanet": 3, "unitable": 4}[name])
    hw = {"unet": (64, 64), "cls": (64, 64), "slanet": (128, 128), "unitable": (64, 64)}[name]
    x = rng.integers(0, 256, (2, *hw, 3)).astype(np.uint8)
    if name == "unet":
        y = np.zeros((2, *hw), np.uint8)
        y[0, 10:12, 4:60] = 1
        y[1, :, 30:32] = 1
        x[y.astype(bool)] //= 4  # ink where the lines are
        return (x, y)
    if name == "cls":
        return (x, np.array([0, 1], np.int32))
    if name == "slanet":
        from rapiddoc_tpu.models.table.slanet import SLANetVocab

        vocab = SLANetVocab()
        t = SMALL_STEPS
        tok = np.full((2, t), vocab.eos_id, np.int32)
        tok[0, :9] = [vocab.token_to_id[s] for s in ("<thead>", "<tr>", "<td></td>", "<td></td>",
                                                     "</tr>", "</thead>", "<tbody>", "</tbody>")] + [
            vocab.eos_id]
        tok[1, :] = rng.integers(1, vocab.eos_id, t)
        loc = rng.uniform(0, 1, (2, t, 8)).astype(np.float32)
        lmask = (rng.random((2, t)) < 0.4).astype(np.float32)
        lens = np.array([9, t], np.int32)
        coins = rng.random((t, 2)) < COIN_P
        return (x, tok, loc, lmask, lens, coins)
    from rapiddoc_tpu.models.table.unitable import BBOX_BASE, EOS_ID, HTML_BASE, PAD_ID

    t = SMALL_TOKENS
    tok = np.full((2, t), PAD_ID, np.int32)
    tok[0, :20] = np.concatenate([rng.integers(HTML_BASE, BBOX_BASE, 8),
                                  rng.integers(BBOX_BASE, BBOX_BASE + 449, 11), [EOS_ID]])
    tok[1, :] = rng.integers(HTML_BASE, BBOX_BASE + 449, t)
    tok[1, 5] = BBOX_BASE  # the lowest and highest bins: the smoothing's clamps
    tok[1, 6] = BBOX_BASE + 448
    coins = rng.random((2, t)) < COIN_P
    return (x, tok, np.array([20, t], np.int32), coins)


def wide(variables):
    """The tree with float64 leaves (for a run under ``jax.enable_x64``)."""
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def jax_case(name):
    """The JAX init (float32) and three steps of one trainer on its small
    batch with the parameters in float64."""
    import jax

    batch = small_batch(name)
    dims = small_dims() if name == "unitable" else None
    variables = jax_init(name, batch[0].shape[1:3], dims)
    with jax.enable_x64(True):
        return variables, jax_run(name, wide(variables), batch, dims=dims)


@pytest.fixture(scope="module")
def jax_cases():
    """Every trainer's JAX runs, in threads: XLA compiles without the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(TRAINERS)) as pool:
        return dict(zip(TRAINERS, pool.map(jax_case, TRAINERS)))


@pytest.fixture(scope="module")
def cases(jax_cases):
    return {name: (jax_cases[name][1], port_run(name, checkpoint_flat(jax_cases[name][0]),
                                                small_batch(name)))
            for name in TRAINERS}


@pytest.fixture(scope="module", params=TRAINERS)
def case(request, cases):
    return (request.param, *cases[request.param])


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
    assert len(zero) <= 8, zero


def test_argmax_streams_match_jax(case):
    """SLANet's per-step argmax (fed back where the coins are set) and
    UniTable's first-pass argmax: equal to the JAX trainer's."""
    name, want, got = case
    if name not in ("slanet", "unitable"):
        assert got["preds"] is None and want["preds"] is None
        return
    np.testing.assert_array_equal(got["preds"], want["preds"])
    coins = small_batch(name)[-1]
    assert coins.any() and not coins.all()


def test_batch_statistics_match_flax(case):
    name, want, got = case
    assert sorted(got["bstats"]) == sorted(want["bstats"])
    assert bool(got["bstats"]) == (name != "unitable")
    for k, v in want["bstats"].items():
        np.testing.assert_allclose(got["bstats"][k], v, rtol=0, atol=STATS_TOL, err_msg=k)


def test_three_steps_match_jax(case):
    name, want, got = case
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=STEPS_TOL, atol=0)
    drop, want_drop = got["losses"][0] - got["losses"][2], want["losses"][0] - want["losses"][2]
    assert abs(drop - want_drop) <= DROP_TOL * abs(want_drop), (drop, want_drop)
    assert got["losses"][2] != got["losses"][1]


def test_gru_bias_repair_is_needed_and_meets_optax(jax_cases):
    """One SLANet step at a constant learning rate from the JAX init: with
    ``flax_gru_grads`` every leaf moves as optax's clip and Adam move
    flax's on the JAX gradients; without it the folded r and z biases move
    about twice as far."""
    import jax
    import optax

    from rapiddoc_tpu_torch.models.weights import flatten, flax_variables
    from rapiddoc_tpu_torch.train import optim, table
    from rapiddoc_tpu_torch.train.bn import bn_training

    lr = 1e-3
    variables, run = jax_cases["slanet"]
    batch = small_batch("slanet")
    trainable = jax_split("slanet", variables)[0]
    with jax.enable_x64(True):
        tx = jax_tx("slanet", lr)

        @jax.jit
        def step(trainable, grads):
            return optax.apply_updates(trainable, tx.update(grads, tx.init(trainable))[0])

        want = flat(step(wide(trainable), run["tree"]))
    start = flat(trainable)
    moved = {}
    for repaired in (True, False):
        model = port_model("slanet", checkpoint_flat(variables))
        opt = optim.adam(list(model.parameters()), lambda count: lr, max_norm=1.0)
        xs = [torch.from_numpy(a) for a in batch]
        with bn_training(model):
            if repaired:
                table.slanet_train_step(model, opt, *xs)
            else:
                opt.zero_grad()
                table.slanet_loss_fn(model, *xs)[0].backward()
                opt.step()
        moved[repaired] = flatten(flax_variables(model)["params"])
    for key in ("step/gru/ir/bias", "step/gru/iz/bias"):
        step_jax = np.abs(want[key] - start[key]).mean()
        assert step_jax == pytest.approx(lr, rel=0.2)
        np.testing.assert_allclose(moved[True][key], want[key], rtol=0, atol=lr * 1e-3, err_msg=key)
        step_bad = np.abs(moved[False][key] - start[key]).mean()
        assert step_bad > 1.8 * step_jax, (key, step_bad, step_jax)
    # every other leaf too, but where a gradient is rounding: Adam's first
    # update is lr * g / (|g| + 1e-8), whose sign rounding decides (the
    # attention score's bias, which the softmax over positions cancels, and
    # single elements elsewhere)
    top = max(float(np.abs(g).max()) for g in run["grads"].values())
    off = {k: float(np.mean(np.abs(moved[True][k] - w) > lr * 1e-3)) for k, w in want.items()
           if float(np.abs(run["grads"][k]).max()) >= ZERO_LEAF * top}
    assert len(off) >= len(want) - 8 and max(off.values()) <= 1e-2, sorted(
        off.items(), key=lambda kv: -kv[1])[:4]


def test_demo_unitable_dims_are_the_jax_constant():
    from rapiddoc_tpu.models.table import unitable as J
    from rapiddoc_tpu_torch.models.table import unitable as T

    assert dataclasses.asdict(T.DEMO_UNITABLE_DIMS) == dataclasses.asdict(J.DEMO_UNITABLE_DIMS)
    flat = {k: v for k, v in np.load(JAX_ASSETS / "table_unitable_demo.npz").items()}
    assert T.dims_from_variables(flat) == T.DEMO_UNITABLE_DIMS


def test_stacked_caches_cannot_backpropagate():
    """The decoder's inference caches, one (L, B, S, H, hd) tensor, give
    each layer a view; a later layer's write invalidates what an earlier
    one saved, so training passes one tensor a layer (``decode_full``)."""
    from rapiddoc_tpu_torch.models.table.unitable import UniTableDims, UniTableModel
    from rapiddoc_tpu_torch.train.unitable import decode_full

    dims = UniTableDims(enc_d=64, enc_layers=1, dec_d=64, dec_layers=2, dec_ffn=64)
    model = UniTableModel(dims)
    mem_k, mem_v = model.mem_proj(torch.randn(1, 4, 64))
    prev = torch.tensor([[11, 12, 13]])
    caches = torch.zeros((2, 1, 3, 1, 64))
    logits = model.decoder(prev, caches, caches.clone(), 0, mem_k, mem_v, None)
    with pytest.raises(RuntimeError, match="inplace"):
        logits.sum().backward()
    decode_full(model.decoder, prev, mem_k, mem_v).sum().backward()
    assert model.decoder.layer0.self_attn.wqkv.weight.grad.abs().sum() > 0


def test_trainers_run_on_the_cpu_only_when_asked(monkeypatch):
    from rapiddoc_tpu_torch.train import table, unitable

    monkeypatch.delenv("RAPIDDOC_PLATFORM", raising=False)
    monkeypatch.delenv("MINERU_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for train in (table.train_unet, table.train_cls, table.train_slanet, unitable.train_unitable):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train(steps=1, out_path=None, device=None)


def test_port_checkpoints_load_in_both_registries(cases, tmp_path, monkeypatch):
    """The trained models as the trainers write them, in a models dir:
    the port's ``TableRecognizer.build`` takes every one (a leaf equal to
    the file's), and its modules give the JAX package's outputs on the
    same inputs from ``_load_variables``'s trees."""
    import jax
    import jax.numpy as jnp

    from rapiddoc_tpu.models.registry import _load_variables
    from rapiddoc_tpu.models.table import slanet as JS, unitable as JU
    from rapiddoc_tpu.models.formula.decoder import MemoryProjector as JMem
    from rapiddoc_tpu.models.table.cls import TableClsNet as JCls
    from rapiddoc_tpu.models.table.unet import UNet as JUNet
    from rapiddoc_tpu_torch.models.table import slanet as TS, unitable as TU
    from rapiddoc_tpu_torch.models.table.engine import TableRecognizer
    from rapiddoc_tpu_torch.models.weights import flax_variables, save_variables, split_models

    for name in TRAINERS:
        model = cases[name][1]["model"].cpu()
        tree = flax_variables(model) if name in ("unet", "cls") else split_models(flax_variables(model))
        save_variables(tree, tmp_path / f"table_{name}.npz", half=name == "unitable")
    monkeypatch.setenv("RAPIDDOC_MODELS_DIR", str(tmp_path))
    rec = TableRecognizer.build({}, device="cpu", dtype=torch.float32)
    uni = TableRecognizer.build({"strategy": "unet_unitable"}, device="cpu", dtype=torch.float32)
    jv = {name: _load_variables(tmp_path / f"table_{name}.npz") for name in TRAINERS}
    leaf = {"unet": (rec.wired.model.head.bias, jv["unet"]["params"]["head"]["bias"]),
            "cls": (rec.classifier.model.fc2.bias, jv["cls"]["params"]["fc2"]["bias"]),
            "slanet": (rec.wireless.model.step.struct_fc2.bias,
                       jv["slanet"]["step"]["params"]["struct_fc2"]["bias"]),
            "unitable": (uni.wireless.model.decoder.generator.bias,
                         jv["unitable"]["decoder"]["params"]["generator"]["bias"])}
    for name, (got, want) in leaf.items():
        np.testing.assert_array_equal(got.detach().numpy(), want, err_msg=name)
    rng = np.random.default_rng(9)
    x = rng.uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        # UNet line bits, but near-ties
        jl = np.asarray(jax.jit(JUNet().apply)(jv["unet"], jnp.asarray(x)))
        tl = rec.wired.model(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
        jgap, tgap = jl[..., 1] - jl[..., 0], tl[..., 1] - tl[..., 0]
        differ = (jgap > 0) != (tgap > 0)
        assert np.abs(jgap[differ]).max(initial=0.0) < 1e-3 and (jgap > 0).any() and (jgap <= 0).any()
        # classifier labels
        jp = np.asarray(JCls().apply(jv["cls"], jnp.asarray(x)))
        tp = rec.classifier.model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_array_equal(tp.argmax(-1), jp.argmax(-1))
        # SLANet token ids through each package's decode
        cfg, vocab = JS.SLANetConfig(), JS.SLANetVocab()
        xs = rng.uniform(-2, 2, (2, 128, 128, 3)).astype(np.float32)
        jsv = jv["slanet"]
        feats = JS.SLANetBackbone(cfg.scale).apply(jsv["backbone"], jnp.asarray(xs))
        fmap = np.asarray(JS.PANNeck(cfg.neck_ch).apply(jsv["neck"], feats))
        jfea = fmap.reshape(2, -1, fmap.shape[-1])
        want = JS.sla_decode(JS.SLAHeadStep(len(vocab), cfg.hidden), jsv["step"],
                             JS.FeaKey(cfg.hidden), jsv["fea_key"], jnp.asarray(jfea),
                             vocab.sos_id, vocab.eos_id, 24)
        tm = rec.wireless.model
        fm = tm.neck(tm.backbone(torch.from_numpy(xs).permute(0, 3, 1, 2)))
        tfea = fm.permute(0, 2, 3, 1).reshape(2, -1, fm.shape[1])
        np.testing.assert_allclose(tfea.numpy(), jfea, rtol=0, atol=1e-4)
        got = TS.sla_decode(tm.step, tm.fea_key, tfea, vocab.sos_id, vocab.eos_id, 24)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        # UniTable token ids (bf16 caches on both sides, the JAX default)
        juv = jv["unitable"]
        dims = JU.dims_from_variables(juv)
        xu = rng.uniform(-2, 2, (2, 64, 64, 3)).astype(np.float32)
        memory = JU.UniTableEncoder(d_model=dims.enc_d, layers=dims.enc_layers,
                                    heads=dims.enc_heads).apply(juv["encoder"], jnp.asarray(xu))
        want = JU.unitable_decode(JU.GPTFastDecoder(cfg=dims), juv["decoder"], JMem(dims),
                                  juv["mem_proj"], memory, 20)
        um = uni.wireless.model
        tmem = um.encoder(torch.from_numpy(xu).permute(0, 3, 1, 2))
        np.testing.assert_allclose(tmem.numpy(), np.asarray(memory), rtol=0, atol=1e-4)
        got = TU.unitable_decode(um.decoder, um.mem_proj, torch.from_numpy(np.array(memory)), 20)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))


# ------------------------------------------------------- the smoke's fixture

def make_batches() -> dict:
    """The JAX synth's batches for the smoke (``FIXTURE_SEED``): the UNet's
    wired table at its own size (``table.unet_pool_row`` makes it 1024 x
    1024, equal to ``make_unet_pool``), the classifier's four tables at
    224 as ``train_cls`` pools them, SLANet's and UniTable's pools of two,
    and coins at ``COIN_P`` for both."""
    import cv2

    from rapiddoc_tpu.models.table.slanet import SLANetVocab
    from rapiddoc_tpu.train import table as jt, unitable as ju

    s = jt.render_table(random.Random(FIXTURE_SEED), wired=True)
    rng = random.Random(FIXTURE_SEED)
    cls_x = np.zeros((4, 224, 224, 3), np.uint8)
    cls_y = np.zeros((4,), np.int32)
    for i in range(4):
        wired = i % 2 == 0
        cls_x[i] = cv2.resize(jt.render_table(rng, wired=wired).img, (224, 224))
        cls_y[i] = 0 if wired else 1
    sla = jt.make_sla_pool(2, SLANetVocab(), FIXTURE_SEED)
    uni = ju.make_pool(2, FIXTURE_SEED)
    nrng = np.random.default_rng(FIXTURE_SEED)
    sla_coins = nrng.random((jt.SLA_TRAIN_STEPS, 2)) < COIN_P
    uni_coins = nrng.random((2, ju.TRAIN_STEPS)) < COIN_P
    return {"unet_table": s.img, "unet_line_mask": s.line_mask, "cls_x": cls_x, "cls_y": cls_y,
            **dict(zip(("sla_x", "sla_tok", "sla_loc", "sla_lmask", "sla_lens"), sla)),
            "sla_coins": sla_coins, **dict(zip(("uni_x", "uni_tok", "uni_lens"), uni)),
            "uni_coins": uni_coins}


def fixture_batch(batches: dict, name: str) -> tuple:
    from rapiddoc_tpu_torch.train.synth_table import TableSample
    from rapiddoc_tpu_torch.train.table import unet_pool_row

    if name == "unet":
        x, y = unet_pool_row(TableSample(batches["unet_table"], batches["unet_line_mask"], True))
        return (x[None], y[None])
    if name == "cls":
        return (batches["cls_x"], batches["cls_y"])
    if name == "slanet":
        return tuple(batches[k] for k in ("sla_x", "sla_tok", "sla_loc", "sla_lmask", "sla_lens",
                                          "sla_coins"))
    return tuple(batches[k] for k in ("uni_x", "uni_tok", "uni_lens", "uni_coins"))


def grad_norm(grads: dict) -> float:
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))


def make_golden(batches: dict) -> dict:
    """The JAX trainers' first loss, gradient global norm, three losses and
    first argmax streams from the demo checkpoints on the fixture, with the
    parameters in float64 (``jax_enable_x64``; the losses' own float32
    casts stay), and the same in float32 (``*_fp32``, for the record)."""
    import jax

    from rapiddoc_tpu.models.registry import _load_variables
    from rapiddoc_tpu.models.table.unitable import dims_from_variables

    out = {"seed": FIXTURE_SEED, "coin_p": COIN_P, "steps": 3}
    for name in TRAINERS:
        variables = _load_variables(JAX_ASSETS / f"table_{name}_demo.npz")
        dims = dims_from_variables(variables) if name == "unitable" else None
        batch = fixture_batch(batches, name)
        runs = {"": jax_run(name, wide(variables), batch, dims=dims),
                "_fp32": jax_run(name, variables, batch, dims=dims)}
        out[name] = {"schedule": list(SCHEDULES[name])}
        for tag, run in runs.items():
            out[name].update({f"loss{tag}": run["loss"], f"grad_norm{tag}": grad_norm(run["grads"]),
                              f"losses{tag}": run["losses"]})
            if run["preds"] is not None:
                out[name][f"preds{tag}"] = run["preds"].tolist()
    return out


def test_fixture_is_the_jax_synth():
    from rapiddoc_tpu.train import table as jt

    with np.load(BATCHES_NPZ) as z:
        stored = {k: z[k] for k in z}
    made = make_batches()
    assert sorted(stored) == sorted(made)
    for k, v in made.items():
        np.testing.assert_array_equal(stored[k], v, err_msg=k)
    x, y = fixture_batch(stored, "unet")
    want_x, want_y = jt.make_unet_pool(1, FIXTURE_SEED)
    np.testing.assert_array_equal(x, want_x)
    np.testing.assert_array_equal(y, want_y)
    assert y.any() and stored["sla_coins"].any() and stored["uni_coins"].any()
    assert BATCHES_NPZ.stat().st_size + GOLDEN_JSON.stat().st_size <= 2 << 20


@pytest.mark.parametrize("name", TRAINERS)
def test_port_first_step_meets_golden(name):
    """The smoke's check on the CPU: the port's fp32 first loss, gradient
    norm and argmax stream on the fixture from the demo checkpoint."""
    from rapiddoc_tpu_torch.models.weights import load_npz

    golden = json.loads(GOLDEN_JSON.read_text())[name]
    with np.load(BATCHES_NPZ) as z:
        batches = {k: z[k] for k in z}
    got = port_run(name, load_npz(JAX_ASSETS / f"table_{name}_demo.npz"),
                   fixture_batch(batches, name), steps=1)
    assert got["loss"] == pytest.approx(golden["loss"], rel=GRAD_TOL)
    assert grad_norm(got["grads"]) == pytest.approx(golden["grad_norm"], rel=NORM_TOL)
    if "preds" in golden:
        np.testing.assert_array_equal(got["preds"], np.array(golden["preds"]))


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["JAX_ENABLE_X64"] = "1"  # the golden's float64 runs
    sys.path.insert(0, str(REPO))
    made = make_batches()
    np.savez_compressed(BATCHES_NPZ, **made)
    GOLDEN_JSON.write_text(json.dumps(make_golden(made), indent=1) + "\n")
    print("wrote", BATCHES_NPZ, BATCHES_NPZ.stat().st_size, "bytes;", GOLDEN_JSON)
