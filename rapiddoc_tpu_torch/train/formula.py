"""Demo trainer for the formula recognizer (image -> LaTeX).

Usage:
    python -m rapiddoc_tpu_torch.train.formula [steps] [out.npz]
    python -m rapiddoc_tpu_torch.train.formula pool [N]

Port of ``rapiddoc_tpu/train/formula.py``: the production PP-FormulaNet
stack (``models/formula``: HGNet encoder, MBart decoder, memory projector)
at the demo scale (B0 backbone at stage 2, two decoder layers, the closed
LaTeX vocabulary of ``synth_layout.random_latex``), trained on mathtext
renders (``utils/mathtext``, matplotlib's replayed) of random LaTeX,
preprocessed exactly as the recognizer preprocesses its crops (the 96 x 384
bucket only). Teacher forcing is one multi-token decoder call over fresh
caches at position 0, with a causal mask.

The loss: a photometric augmentation (contrast 0.6-1.4 about white,
brightness +-0.12, pixel noise of sigma 0.03, each clipped to [0, 1]; the
draws from a ``torch.Generator`` on the device, where the JAX trainer
splits a PRNG key), the UniMER normalization, the teacher-forced decode and
the masked cross-entropy over the sequence and its eos. The encoder trains
with batch statistics (``train/bn.py``); ``clip_by_global_norm(1.0)`` then
``adamw`` (weight decay 1e-4) under the warm-up cosine schedule. Every
eighth of the run (at least every 1000 steps) the recognizer decodes held
out renders, and the checkpoint with the best ``cer~`` is kept (and
written). The saved tree is the inference layout
``{encoder: {params, batch_stats}, decoder, mem_proj}``, with the arch and
the vocabulary in the ``.json``.

``render_formula`` draws its dpi before it renders, so the pool's latex
stream is the JAX stream but where a render lands in the 96 x 384 bucket
on one side only (matplotlib's crop is hinted, the replay's is not: ROADMAP
item 12e). Runs on the card unless ``device="cpu"``; fp32 parameters.
"""
from __future__ import annotations

import os
import random
import re
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..engine.session import resolve_device
from ..models.formula.engine import (UNIMER_MEAN, UNIMER_STD, FormulaConfig, detokenize,
                                     preprocess_formula)
from ..models.formula.model import build_formula_modules
from ..models.weights import (flatten, flax_variables, init_params, load_flax_into, load_npz,
                              nest_models, save_variables, split_models)
from ..utils.logging import get_logger
from ..utils.mathtext import math_to_image
from .bn import bn_training
from .optim import Adam, adamw, warmup_cosine_decay_schedule
from .synth_layout import random_latex

__all__ = ["detokenize", "latex_tokenize", "build_vocab", "render_formula", "make_pool",
           "load_or_make_pool", "FormulaModel", "loss_fn", "train", "save_demo", "evaluate"]

logger = get_logger("rapiddoc_tpu_torch.train.formula")

BUCKET_H, BUCKET_W = 96, 384
MAX_T = 64  # token budget (bos/eos included)

DEMO_ARCH = dict(max_len=160, layers=2, backbone_size="B0", out_index=2)

_TOKEN_RE = re.compile(r"\\[a-zA-Z]+|[^\s]")

SPECIALS = ["<s>", "<pad>", "</s>"]  # ids 0/1/2 = bos/pad/eos (MBartConfig)
DPI_CHOICES = [60, 80, 100, 120, 140]
SHARD = 3000  # renders per cache shard


def latex_tokenize(s: str) -> list[str]:
    return _TOKEN_RE.findall(s)


def build_vocab(seed: int = 0, probe: int = 2000) -> list[str]:
    """Closed vocabulary of the random_latex grammar (probed, sorted)."""
    rng = random.Random(seed)
    seen: set[str] = set()
    for _ in range(probe):
        seen.update(latex_tokenize(random_latex(rng)))
    return SPECIALS + sorted(seen)


def render_formula(latex: str, rng: random.Random) -> np.ndarray | None:
    """The mathtext render at a drawn dpi as the production input
    (``preprocess_formula``: margin crop, smallest fitting bucket, top-left
    placement): the (96, 384, 1) canvas, or None when the render is under
    6 px a side or lands in a larger bucket."""
    img = math_to_image(latex, rng.choice(DPI_CHOICES))[..., :3]
    if img.shape[0] < 6 or img.shape[1] < 6:
        return None
    canvas, bucket = preprocess_formula(img)
    if bucket != (BUCKET_H, BUCKET_W):
        return None
    return canvas


def make_pool(n: int, vocab: list[str], seed: int = 0):
    """(crops (n, 96, 384, 1) uint8, tokens (n, MAX_T) int32 padded with
    1, lengths (n,) with the eos, latex texts)."""
    tok_to_id = {t: i for i, t in enumerate(vocab)}
    rng = random.Random(seed)
    imgs = np.zeros((n, BUCKET_H, BUCKET_W, 1), np.uint8)
    toks = np.full((n, MAX_T), 1, np.int32)  # pad=1
    lens = np.zeros((n,), np.int32)
    texts: list[str] = []
    i = 0
    while i < n:
        latex = random_latex(rng)
        ids = [tok_to_id[t] for t in latex_tokenize(latex) if t in tok_to_id]
        if not ids or len(ids) + 1 > MAX_T:
            continue
        img = render_formula(latex, rng)
        if img is None:
            continue
        imgs[i] = img
        seq = ids + [2]  # eos
        toks[i, : len(seq)] = seq
        lens[i] = len(seq)
        texts.append(latex)
        i += 1
        if i % 500 == 0:
            logger.info("pool %d/%d", i, n)
    return imgs, toks, lens, texts


def _shard_path(k: int) -> str:
    base = os.environ.get("RAPIDDOC_FORMULA_POOL",
                          os.path.join(tempfile.gettempdir(), "formula_pool.npz"))
    return base if k == 0 else base.replace(".npz", f"_s{k}.npz")


def load_or_make_pool(n: int, vocab: list[str], seed: int = 0):
    """The JAX package's sharded disk cache (``RAPIDDOC_FORMULA_POOL``,
    its format): shard k holds SHARD renders from seed + k; a shard on
    disk with enough rows, the vocabulary's size and its seed is read,
    any other is rendered and written."""
    parts = []
    got = 0
    for k in range((n + SHARD - 1) // SHARD):
        want = min(SHARD, n - got)
        cache = _shard_path(k)
        if os.path.isfile(cache):
            with np.load(cache, allow_pickle=False) as d:
                if (len(d["imgs"]) >= want and d["vocab_size"] == len(vocab)
                        and int(d["seed"]) == seed + k):
                    logger.info("formula pool shard %d from cache %s", k, cache)
                    parts.append((d["imgs"][:want], d["toks"][:want], d["lens"][:want]))
                    got += want
                    continue
        imgs, toks, lens, _ = make_pool(SHARD, vocab, seed + k)
        np.savez(cache, imgs=imgs, toks=toks, lens=lens, vocab_size=len(vocab), seed=seed + k)
        parts.append((imgs[:want], toks[:want], lens[:want]))
        got += want
    imgs = np.concatenate([p[0] for p in parts])
    toks = np.concatenate([p[1] for p in parts])
    lens = np.concatenate([p[2] for p in parts])
    return imgs, toks, lens, []


def demo_config(vocab_size: int) -> FormulaConfig:
    return FormulaConfig(max_len=DEMO_ARCH["max_len"], vocab_size=vocab_size,
                         layers=DEMO_ARCH["layers"], backbone_size=DEMO_ARCH["backbone_size"],
                         out_index=DEMO_ARCH["out_index"])


class FormulaModel(nn.Module):
    """The three modules the recognizer runs, as one module for training:
    ``split_models(flax_variables(model))`` is the checkpoint's tree."""

    def __init__(self, cfg: FormulaConfig):
        super().__init__()
        self.encoder, self.decoder, self.mem_proj, self.mbart = build_formula_modules(
            max_len=cfg.max_len, vocab_size=cfg.vocab_size, layers=cfg.layers,
            backbone_size=cfg.backbone_size, out_index=cfg.out_index,
            d_model=cfg.d_model, ffn=cfg.ffn, heads=cfg.heads)


def new_model(vocab_size: int, seed: int = 0, variables: dict | None = None) -> FormulaModel:
    """From flax's initializers seeded with ``seed``, or from ``variables``
    (the checkpoint's flat ``encoder/params/…`` leaves or its tree)."""
    model = FormulaModel(demo_config(vocab_size))
    if variables is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        load_flax_into(model, nest_models(flatten(variables)))
    return model


def draw_augment(gen: torch.Generator, batch: int, device) -> tuple[torch.Tensor, ...]:
    """The augmentation's draws: contrast (B,), brightness (B,), unit
    noise (B, 96, 384, 1)."""
    c = torch.rand(batch, generator=gen, device=device) * 0.8 + 0.6
    b = torch.rand(batch, generator=gen, device=device) * 0.24 - 0.12
    noise = torch.randn((batch, BUCKET_H, BUCKET_W, 1), generator=gen, device=device)
    return c, b, noise


def augment(x: torch.Tensor, c: torch.Tensor, b: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Photometric-only jitter (the geometry stays the production top-left
    placement): contrast about the white background, brightness, noise."""
    x = torch.clamp((x - 1.0) * c[:, None, None, None] + 1.0 + b[:, None, None, None], 0.0, 1.0)
    x = x + noise * 0.03
    return torch.clamp(x, 0.0, 1.0)


def loss_fn(model: FormulaModel, x_u8: torch.Tensor, tok: torch.Tensor, lens: torch.Tensor,
            c: torch.Tensor, b: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    x = augment(x_u8.float() / 255.0, c, b, noise)
    x = (x - UNIMER_MEAN) / UNIMER_STD
    x = x.expand(*x.shape[:-1], 3)
    memory = model.encoder(x).float()
    mem_k, mem_v = model.mem_proj(memory)
    B, T = tok.shape
    cfg = model.mbart
    prev = torch.cat([torch.zeros((B, 1), dtype=tok.dtype, device=tok.device), tok[:, :-1]], 1)
    hd = cfg.d_model // cfg.heads
    caches_k = torch.zeros((cfg.layers, B, T, cfg.heads, hd), device=x.device)
    caches_v = torch.zeros_like(caches_k)
    logits, _, _ = model.decoder(prev.long(), caches_k, caches_v, 0, mem_k, mem_v, None)
    mask = (torch.arange(T, device=tok.device)[None, :] < lens[:, None]).float()
    ce = F.cross_entropy(logits.float().transpose(1, 2), tok.long(), reduction="none")
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def make_optimizer(model: nn.Module, steps: int, lr: float = 4e-4) -> Adam:
    return adamw(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(300, steps // 10), steps), weight_decay=1e-4, max_norm=1.0)


def train_step(model: FormulaModel, opt: Adam, *batch: torch.Tensor) -> torch.Tensor:
    """Forward, backward and update on (x_u8, tok, lens, c, b, noise);
    the loss, detached."""
    opt.zero_grad()
    loss = loss_fn(model, *batch)
    loss.backward()
    opt.step()
    return loss.detach()


def checkpoint(model: FormulaModel) -> dict:
    """``{encoder: {params, batch_stats}, decoder: {params}, mem_proj:
    {params}}`` as float32 numpy leaves."""
    return split_models(flax_variables(model))


def train(steps: int = 16000, out_path=None, pool_n: int = 9000, batch: int = 16,
          lr: float = 4e-4, seed: int = 0, variables: dict | None = None, device=None):
    """Train from a seeded init, or warm from ``variables`` (the saved
    tree or its flat leaves); returns (the best variables by ``cer~``, the
    vocabulary)."""
    dev = resolve_device(device)
    vocab = build_vocab()
    model = new_model(len(vocab), seed, variables).to(dev)
    opt = make_optimizer(model, steps, lr)
    logger.info("rendering %d formulas (mathtext, host-bound)", pool_n)
    imgs, toks, lens, _ = load_or_make_pool(pool_n, vocab, seed)
    nrng = np.random.default_rng(seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    tic = time.perf_counter()
    best = None  # (cer, variables); evaluation runs frozen-BN, outside the mode
    eval_every = max(1000, steps // 8)
    for start in range(0, steps, eval_every):
        with bn_training(model):
            for i in range(start, min(start + eval_every, steps)):
                idx = nrng.integers(0, pool_n, batch)
                xs = [torch.from_numpy(a[idx]).to(dev) for a in (imgs, toks, lens)]
                loss = train_step(model, opt, *xs, *draw_augment(gen, batch, dev))
                if i % 100 == 0 or i == steps - 1:
                    logger.info("step %d loss %.4f (%.1fs)", i, float(loss),
                                time.perf_counter() - tic)
        v = checkpoint(model)
        m = evaluate(v, vocab, n=16, device=dev)
        logger.info("step %d heldout %s", min(start + eval_every, steps), m)
        if best is None or m["cer~"] < best[0]:
            best = (m["cer~"], v)
            if out_path is not None:
                save_demo(v, vocab, out_path)
    variables = best[1] if best is not None else checkpoint(model)
    return variables, vocab


def save_demo(variables: dict, vocab: list[str], out_path) -> None:
    import json
    from pathlib import Path

    out_path = Path(out_path)
    save_variables(variables, out_path, half=True)
    out_path.with_suffix(".json").write_text(json.dumps({"arch": DEMO_ARCH, "vocab": vocab}))
    logger.info("formula weights -> %s (+ .json arch/vocab)", out_path)


def evaluate(variables: dict, vocab: list[str], n: int = 24, seed: int = 4242,
             device=None, dtype: torch.dtype | None = None) -> dict:
    """Greedy-decode held-out renders through the production
    ``FormulaRecognizer``: exact match and a character error rate."""
    import difflib

    from ..models.formula.engine import DemoFormulaVocab, FormulaRecognizer

    rec = FormulaRecognizer(flatten(variables), config=demo_config(len(vocab)),
                            device=device, dtype=dtype)
    rec.tokenizer = DemoFormulaVocab(vocab)
    rng = random.Random(seed)
    crops, truths = [], []
    while len(crops) < n:
        latex = random_latex(rng)
        if len(latex_tokenize(latex)) + 1 > MAX_T:
            continue
        img = render_formula(latex, rng)
        if img is None:
            continue
        crops.append(np.repeat(img, 3, axis=-1))
        truths.append(latex)
    preds = rec.batch_predict(crops, length_bucket=MAX_T)

    def norm(s):
        return re.sub(r"\s+", "", s)

    exact = cers = 0.0
    for p, t in zip(preds, truths):
        pn, tn = norm(p), norm(t)
        exact += pn == tn
        cers += 1.0 - difflib.SequenceMatcher(a=pn, b=tn).ratio()
    return {"exact": exact / n, "cer~": cers / n}


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "pool":
        load_or_make_pool(int(sys.argv[2]) if len(sys.argv) > 2 else 3000, build_vocab())
    else:
        steps = int(sys.argv[1]) if len(sys.argv) > 1 else 8000
        out = sys.argv[2] if len(sys.argv) > 2 else None
        init = None
        if out and os.path.isfile(out) and not os.environ.get("RAPIDDOC_TRAIN_FRESH"):
            init = load_npz(out)
            logger.info("warm start from %s", out)
        seed = int(os.environ.get("RAPIDDOC_TRAIN_SEED", "23" if init is not None else "0"))
        v, vocab = train(steps, out, seed=seed, variables=init)
        logger.info("eval: %s", evaluate(v, vocab))
