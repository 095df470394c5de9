"""The JAX side of the layout and formula trainers' tests, and the smoke's
fixtures and goldens for phase ``train_layout``.

- ``jax_layout_run`` / ``jax_formula_run``: the JAX trainers' steps
  (``rapiddoc_tpu/train/{layout,formula}.py``) on given batches, as the
  port's tests and the golden read them. The layout trainer's matching
  forward, loss and optimizer are its own (``loss_fn`` and ``match_batch``
  are module-level there; ``fwd`` and the chain are rebuilt as its
  ``train`` builds them). The formula trainer's loss is a closure inside
  its ``train``: its body is copied here with the augmentation's draws
  given (contrast, brightness, unit noise) instead of split from a PRNG
  key, the only change.
- ``make_batches``: the smoke's fixture, made by the JAX code from
  ``FIXTURE_SEED``: two layout pages at 640 x 640 from
  ``layout.make_pool`` with their padded targets, sixteen formula crops at
  96 x 384 from ``formula.make_pool`` with their tokens and lengths.
- ``make_golden``: the JAX trainers' first loss, gradient norm, step-one
  matching of every layer (layout) and three losses, from the demo
  checkpoints on the fixture with float64 parameters (``jax.enable_x64``;
  the losses' own float32 casts stay), and the same in float32 for the
  record. The augmentation's draws come from ``aug_draws(FIXTURE_SEED)``,
  not committed.
- ``make_mathtext``: the smoke's 24 formulas (spanning the grammar, dpis
  60-140) rendered by matplotlib under ``text.hinting: none`` and under its
  default, stored as their red planes (the renders are grey: the maker
  checks R = G = B and alpha 255).

``python tests/torch_train_layout_fixtures.py`` writes
``rapiddoc_tpu_torch/assets/train_layout_smoke_{batches.npz,golden.json}``
and ``mathtext_smoke_renders.npz`` with the JAX package on the CPU.
"""
from __future__ import annotations

import io
import json
import os
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
ASSETS = REPO / "rapiddoc_tpu_torch" / "assets"
JAX_ASSETS = REPO / "rapiddoc_tpu" / "assets"
BATCHES_NPZ = ASSETS / "train_layout_smoke_batches.npz"
GOLDEN_JSON = ASSETS / "train_layout_smoke_golden.json"
MATHTEXT_NPZ = ASSETS / "mathtext_smoke_renders.npz"
FIXTURE_SEED = 7
LAYOUT_PAGES = 2
FORMULA_CROPS = 16
# (default steps, peak lr) of each JAX trainer's schedule
SCHEDULES = {"layout": (12000, 2.5e-4), "formula": (16000, 4e-4)}
MATHTEXT = [
    ("x_{i} + y^{2}", 60), ("\\alpha = \\frac{\\beta}{\\gamma}", 80),
    ("\\sqrt{\\frac{a}{b}} - 3", 90), ("\\sum_{k=0}^{n} x", 100),
    ("\\int_{0}^{\\pi} f(t) dt", 110), ("\\frac{\\frac{p}{q}}{\\sqrt{z}}", 120),
    ("a - b = 42", 130), ("\\theta^{2} \\phi_{k}", 140),
    ("\\sqrt{\\frac{\\frac{a}{b}}{\\frac{c}{d}}}", 60), ("\\mu + \\sigma = \\omega", 70),
    ("f(x) = \\rho \\tau", 85), ("\\sum_{j=3}^{\\lambda} \\pi", 95),
    ("\\int_{5}^{y} g(s) ds = 7", 105), ("17^{\\alpha} - 8_{n}", 115),
    ("\\frac{1}{2} + \\frac{3}{4}", 125), ("c_{q} c^{u}", 135),
    ("\\sqrt{k + 1}", 140), ("h = \\frac{v}{\\sqrt{t}}", 75),
    ("\\beta \\gamma \\lambda", 65), ("z^{99} + 0", 100),
    ("\\sqrt{\\frac{\\frac{\\frac{a}{b}}{c}}{\\frac{d}{\\frac{e}{f}}}}", 120),
    ("\\sigma_{x} = \\sqrt{v}", 90), ("p - q - r", 110), ("\\omega \\mu_{3}", 130),
]


# ----------------------------------------------------------------- layout

def jax_layout_run(variables, x_u8, tcls, tbox, steps: int = 3, lr=None) -> dict:
    """The JAX layout trainer's step ``steps`` times on one batch: the
    first loss, gradients and batch stats (flat), the step-one matched
    classes (L+1, B, Nq), every loss and the final variables."""
    import jax
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu.train import layout as jl
    from rapiddoc_tpu.train.bn import apply_mutable, bn_training, join_vars, split_vars

    model = jl.make_model(aux=True)
    n, peak = SCHEDULES["layout"]
    sched = lr if lr is not None else optax.warmup_cosine_decay_schedule(
        0.0, peak, min(500, max(1, n // 10)), n)
    tx = optax.chain(optax.clip_by_global_norm(0.5), optax.adamw(sched, weight_decay=1e-4))
    params, bstats = split_vars(variables)
    state = tx.init(params)
    losses = []
    with bn_training():
        @jax.jit
        def fwd(params, bstats, x_u8):
            x = x_u8.astype(jnp.float32) / 255.0
            preds, _ = apply_mutable(model, params, bstats, x)
            return (jnp.concatenate([preds["aux_logits"], preds["enc_logits"][None]],
                                    axis=0).astype(jnp.float32),
                    jnp.concatenate([preds["aux_boxes"], preds["enc_boxes"][None]],
                                    axis=0).astype(jnp.float32))

        @jax.jit
        def step(params, bstats, state, x_u8, qcls, qbox):
            (loss, new_bs), grads = jax.value_and_grad(jl.loss_fn, has_aux=True)(
                params, bstats, model, x_u8, qcls, qbox)
            updates, state = tx.update(grads, state, params)
            return loss, grads, new_bs, optax.apply_updates(params, updates), state

        for i in range(steps):
            logits, boxes = (np.asarray(a) for a in fwd(params, bstats, x_u8))
            qcls = np.zeros(logits.shape[:3], np.int32)
            qbox = np.zeros(logits.shape[:3] + (4,), np.float32)
            for li in range(logits.shape[0]):
                qcls[li], qbox[li] = jl.match_batch(logits[li], boxes[li], tcls, tbox)
            loss, grads, new_bs, params, state = step(params, bstats, state, x_u8, qcls, qbox)
            bstats = new_bs
            if i == 0:
                first = {"loss": float(loss), "grads": flat(grads), "bstats": flat(new_bs),
                         "qcls": qcls, "logits": logits, "boxes": boxes}
            losses.append(float(loss))
    return {**first, "losses": losses, "variables": join_vars(params, bstats)}


# ---------------------------------------------------------------- formula

def jax_formula_modules(vocab_size: int):
    from rapiddoc_tpu.models.formula.model import build_formula_modules
    from rapiddoc_tpu.train.formula import DEMO_ARCH

    return build_formula_modules(max_len=DEMO_ARCH["max_len"], vocab_size=vocab_size,
                                 layers=DEMO_ARCH["layers"],
                                 backbone_size=DEMO_ARCH["backbone_size"],
                                 out_index=DEMO_ARCH["out_index"])


def jax_formula_loss(vocab_size: int):
    """The body of ``rapiddoc_tpu/train/formula.py``'s ``loss_fn`` with its
    ``augment``, the draws given."""
    import jax.numpy as jnp
    import optax

    from rapiddoc_tpu.models.formula.engine import UNIMER_MEAN, UNIMER_STD

    encoder, decoder, mem_proj, mcfg = jax_formula_modules(vocab_size)
    hd = mcfg.d_model // mcfg.heads

    def augment(x, c, b, noise):
        x = jnp.clip((x - 1.0) * c[:, None, None, None] + 1.0 + b[:, None, None, None], 0.0, 1.0)
        x = x + noise * 0.03
        return jnp.clip(x, 0.0, 1.0)

    def loss_fn(trainable, batch_stats, x_u8, tok, lens, c, b, noise):
        x = x_u8.astype(jnp.float32) / 255.0
        x = augment(x, c, b, noise)
        x = (x - UNIMER_MEAN) / UNIMER_STD
        x = jnp.broadcast_to(x, (*x.shape[:-1], 3))
        memory, upd = encoder.apply(
            {"params": trainable["encoder"], "batch_stats": batch_stats},
            x, mutable=["batch_stats"],
        )
        memory = memory.astype(jnp.float32)
        mem_mask = jnp.ones(memory.shape[:2], bool)
        mem_k, mem_v = mem_proj.apply(trainable["mem_proj"], memory)
        B, T = tok.shape
        prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), tok[:, :-1]], axis=1)
        caches_k = jnp.zeros((mcfg.layers, B, T, mcfg.heads, hd), jnp.float32)
        caches_v = jnp.zeros_like(caches_k)
        logits, _, _ = decoder.apply(trainable["decoder"], prev, caches_k, caches_v, 0,
                                     mem_k, mem_v, mem_mask)
        mask = (jnp.arange(T)[None, :] < lens[:, None]).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits.astype(jnp.float32), tok)
        loss = (ce * mask).sum() / jnp.maximum(mask.sum(), 1.0)
        return loss, upd["batch_stats"]

    return loss_fn


def jax_formula_run(variables, batch, steps: int = 3, lr=None) -> dict:
    """The JAX formula trainer's step ``steps`` times on ``batch`` =
    (x_u8, tok, lens, c, b, noise) from the checkpoint tree ``variables``."""
    import jax
    import optax

    from rapiddoc_tpu.train.bn import bn_training

    vocab_size = variables["decoder"]["params"]["embed_tokens"]["embedding"].shape[0]
    n, peak = SCHEDULES["formula"]
    sched = lr if lr is not None else optax.warmup_cosine_decay_schedule(
        0.0, peak, min(300, n // 10), n)
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(sched, weight_decay=1e-4))
    trainable = {"encoder": variables["encoder"]["params"], "decoder": variables["decoder"],
                 "mem_proj": variables["mem_proj"]}
    bstats = variables["encoder"]["batch_stats"]
    state = tx.init(trainable)
    losses = []
    with bn_training():
        vg = jax.value_and_grad(jax_formula_loss(vocab_size), has_aux=True)

        @jax.jit
        def step(trainable, bstats, state, *batch):
            (loss, new_bs), grads = vg(trainable, bstats, *batch)
            updates, state = tx.update(grads, state, trainable)
            return loss, grads, new_bs, optax.apply_updates(trainable, updates), state

        for i in range(steps):
            loss, grads, new_bs, trainable, state = step(trainable, bstats, state, *batch)
            bstats = new_bs
            if i == 0:
                first = {"loss": float(loss), "grads": flat(grads),
                         "bstats": flat({"encoder": new_bs})}
            losses.append(float(loss))
    return {**first, "losses": losses}


# ----------------------------------------------------------------- shared

def flat(tree) -> dict:
    """Flat ``a/b/c`` leaves, flax's inner ``params`` level taken out."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else k
            if hasattr(v, "items"):
                walk(v, key)
            else:
                out[key.replace("/params/", "/").removeprefix("params/")] = np.asarray(v)

    walk(tree, "")
    return out


def wide(variables):
    """The tree with float64 leaves (for a run under ``jax.enable_x64``)."""
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def grad_norm(grads: dict) -> float:
    return float(np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values())))


def aug_draws(seed: int, n: int, hw=(96, 384)) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The formula augmentation's draws for a fixed batch: contrast (n,),
    brightness (n,), unit noise (n, h, w, 1), float32, from a numpy seed."""
    rng = np.random.default_rng(seed)
    c = rng.uniform(0.6, 1.4, n).astype(np.float32)
    b = rng.uniform(-0.12, 0.12, n).astype(np.float32)
    noise = rng.standard_normal((n, *hw, 1)).astype(np.float32)
    return c, b, noise


def demo_variables(name: str):
    from rapiddoc_tpu.models.registry import _load_variables

    return _load_variables(JAX_ASSETS / f"{name}_demo.npz")


# ---------------------------------------------------------- the fixtures

def make_batches() -> dict:
    from rapiddoc_tpu.train import formula as jf, layout as jl

    imgs, tcls, tbox = jl.make_pool(LAYOUT_PAGES, FIXTURE_SEED)
    vocab = jf.build_vocab()
    fimgs, ftoks, flens, _ = jf.make_pool(FORMULA_CROPS, vocab, FIXTURE_SEED)
    return {"layout_x": imgs, "layout_tcls": tcls, "layout_tbox": tbox,
            "formula_x": fimgs, "formula_tok": ftoks, "formula_lens": flens}


def formula_batch(batches: dict) -> tuple:
    return (batches["formula_x"], batches["formula_tok"], batches["formula_lens"],
            *aug_draws(FIXTURE_SEED, len(batches["formula_x"])))


def make_golden(batches: dict) -> dict:
    import jax

    out = {"seed": FIXTURE_SEED, "steps": 3}
    layout_v, formula_v = demo_variables("layout"), demo_variables("formula")
    lx = (batches["layout_x"], batches["layout_tcls"], batches["layout_tbox"])
    with jax.enable_x64(True):
        runs = {"layout": (jax_layout_run(wide(layout_v), *lx),),
                "formula": (jax_formula_run(wide(formula_v), formula_batch(batches)),)}
    runs["layout"] += (jax_layout_run(layout_v, *lx),)
    runs["formula"] += (jax_formula_run(formula_v, formula_batch(batches)),)
    for name, (run, run32) in runs.items():
        out[name] = {"schedule": list(SCHEDULES[name]), "loss": run["loss"],
                     "grad_norm": grad_norm(run["grads"]), "losses": run["losses"],
                     "loss_fp32": run32["loss"], "grad_norm_fp32": grad_norm(run32["grads"]),
                     "losses_fp32": run32["losses"]}
        if name == "layout":
            out[name]["qcls"] = run["qcls"].tolist()
            out[name]["qcls_fp32_differ"] = int((run32["qcls"] != run["qcls"]).sum())
    return out


def mpl_render(latex: str, dpi: int, hinting: str) -> np.ndarray:
    import matplotlib

    matplotlib.use("Agg")
    from matplotlib import mathtext, rc_context
    from PIL import Image

    buf = io.BytesIO()
    with rc_context({"text.hinting": hinting}):
        mathtext.math_to_image(f"${latex}$", buf, dpi=dpi, format="png")
    buf.seek(0)
    return np.asarray(Image.open(buf).convert("RGBA"), np.uint8)


def make_mathtext() -> dict:
    """{latex, dpi, shapes (n, 2), none, default}: the planes concatenated
    flat in list order."""
    planes = {"none": [], "default": []}
    shapes = []
    for latex, dpi in MATHTEXT:
        for tag, hinting in (("none", "none"), ("default", "force_autohint")):
            img = mpl_render(latex, dpi, hinting)
            assert (img[..., 0] == img[..., 1]).all() and (img[..., 0] == img[..., 2]).all()
            assert (img[..., 3] == 255).all()
            planes[tag].append(img[..., 0].ravel())
        shapes.append(img.shape[:2])
    return {"latex": np.array([s for s, _ in MATHTEXT]), "dpi": np.array([d for _, d in MATHTEXT]),
            "shapes": np.array(shapes, np.int32),
            "none": np.concatenate(planes["none"]), "default": np.concatenate(planes["default"])}


if __name__ == "__main__":
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    sys.path.insert(0, str(REPO))
    made = make_batches()
    np.savez_compressed(BATCHES_NPZ, **made)
    np.savez_compressed(MATHTEXT_NPZ, **make_mathtext())
    GOLDEN_JSON.write_text(json.dumps(make_golden(made), indent=1) + "\n")
    for p in (BATCHES_NPZ, MATHTEXT_NPZ, GOLDEN_JSON):
        print("wrote", p, p.stat().st_size, "bytes")
