"""Train SVTR/CTC recognition on synthetic text lines (demo rec weights).

Usage: python -m rapiddoc_tpu_torch.train.rec [steps] [out.npz] [init.npz] [--lang=ru]

Port of ``rapiddoc_tpu/train/rec.py``: the CTC objective (blank 0) over
the demo ASCII charset, or a language's (``synth.LANG_CHARSETS``), the
vocabulary laid out as ``CTCLabelDecoder`` reads it ([blank] + charset +
[' ']). The loss is ``F.ctc_loss`` on ``log_softmax`` of the fp32 logits
(``SVTRRec.logits``), every frame counted, each label's length from its
padding, averaged over the batch: ``optax.ctc_loss(...).mean()`` of the
JAX trainer. The two agree wherever an alignment exists; where none does
(a label longer than the frames allow) optax returns a large finite value
and torch inf. Adam under a warm-up cosine schedule, batch statistics in
train mode, batches drawn with ``np.random.default_rng(seed).integers``;
``init_from`` warm-starts from an npz.
"""
from __future__ import annotations

import functools
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.session import resolve_device
from ..models.ocr.pre_post import CTCLabelDecoder, rec_normalize_device
from ..models.ocr.rec import SVTRRec
from ..models.weights import (flatten, flax_variables, init_params, load_flax_into, load_npz,
                              save_variables)
from ..utils.logging import get_logger
from .bn import bn_training
from .optim import Adam, adam, train_step as _step, warmup_cosine_decay_schedule
from .synth import DEMO_CHARSET, LANG_CHARSETS, encode_text, rec_sample, rec_sample_lang

logger = get_logger("rapiddoc_tpu_torch.train.rec")

WIDTH = 320
HEIGHT = 48
MAX_LABEL = 32
NUM_CLASSES = len(DEMO_CHARSET) + 2  # blank + charset + space


def charset_for(lang: str | None) -> list[str]:
    return LANG_CHARSETS.get(lang or "", DEMO_CHARSET)


def make_pool(n: int, seed: int = 0, lang: str | None = None):
    """(uint8 lines (n, 48, 320, 3), int32 labels (n, 32), float32 label
    padding (n, 32): 1 past each label's end)."""
    charset = charset_for(lang)
    rng = random.Random(seed)
    imgs = np.zeros((n, HEIGHT, WIDTH, 3), np.uint8)
    labels = np.zeros((n, MAX_LABEL), np.int32)
    label_pad = np.ones((n, MAX_LABEL), np.float32)
    for i in range(n):
        if lang:
            img, text = rec_sample_lang(rng, lang, WIDTH, HEIGHT)
        else:
            img, text = rec_sample(rng, WIDTH, HEIGHT)
        ids = encode_text(text, charset)[:MAX_LABEL]
        imgs[i] = img
        labels[i, : len(ids)] = ids
        label_pad[i, : len(ids)] = 0.0
    return imgs, labels, label_pad


def ctc_loss(logits: torch.Tensor, labels: torch.Tensor, label_pad: torch.Tensor) -> torch.Tensor:
    """Per-line CTC loss of (B, T, V) logits, every frame counted, blank 0."""
    b, t, _ = logits.shape
    log_probs = F.log_softmax(logits.float(), dim=-1).transpose(0, 1)
    target_lengths = (1.0 - label_pad).sum(dim=1).round().long()
    input_lengths = torch.full((b,), t, dtype=torch.long, device=logits.device)
    return F.ctc_loss(log_probs, labels.long(), input_lengths, target_lengths,
                      blank=0, reduction="none")


def loss_fn(model: SVTRRec, x_u8: torch.Tensor, labels: torch.Tensor,
            label_pad: torch.Tensor) -> torch.Tensor:
    return ctc_loss(model.logits(rec_normalize_device(x_u8)), labels, label_pad).mean()


def make_optimizer(model: torch.nn.Module, steps: int, lr: float = 1e-3) -> Adam:
    return adam(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(200, steps // 10), steps))


# one step: forward, backward, update; the loss
train_step = functools.partial(_step, loss_fn)


def new_model(seed: int = 0, lang: str | None = None) -> SVTRRec:
    model = SVTRRec(num_classes=len(charset_for(lang)) + 2)
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def train(steps: int = 3000, out_path=None, pool_size: int = 4096, batch: int = 64,
          lr: float = 1e-3, seed: int = 0, init_from: str | None = None,
          lang: str | None = None, device=None) -> dict:
    dev = resolve_device(device)
    model = new_model(seed, lang)
    if init_from:
        if not Path(init_from).is_file():
            raise FileNotFoundError(init_from)
        load_flax_into(model, load_npz(init_from))
        logger.info("warm start from %s", init_from)
    model.to(dev)
    opt = make_optimizer(model, steps, lr)
    logger.info("rendering %d synthetic lines (lang=%s)", pool_size, lang or "en")
    imgs, labels, label_pad = make_pool(pool_size, seed, lang=lang)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, pool_size, batch)
            loss = train_step(model, opt, torch.from_numpy(imgs[idx]).to(dev),
                              torch.from_numpy(labels[idx]).to(dev),
                              torch.from_numpy(label_pad[idx]).to(dev))
            if i % 200 == 0 or i == steps - 1:
                logger.info("step %d loss %.4f (%.1fs)", i, float(loss),
                            time.perf_counter() - tic)
    variables = flax_variables(model)
    if out_path is not None:
        save_variables(variables, out_path)
        logger.info("rec weights -> %s", out_path)
    return variables


def evaluate(variables: dict, n: int = 128, seed: int = 4242, lang: str | None = None,
             device=None, dtype: torch.dtype = torch.bfloat16) -> float:
    """Exact-match accuracy on held-out synthetic lines, through the fused
    CTC head (K1 on the card)."""
    charset = charset_for(lang)
    dev = resolve_device(device)
    model = load_flax_into(SVTRRec(num_classes=len(charset) + 2), flatten(variables))
    model = model.to(dev, dtype).eval()
    decoder = CTCLabelDecoder(charset)
    rng = random.Random(seed)
    imgs, texts = [], []
    for _ in range(n):
        img, text = (rec_sample_lang(rng, lang, WIDTH, HEIGHT) if lang
                     else rec_sample(rng, WIDTH, HEIGHT))
        imgs.append(img)
        texts.append(text)
    with torch.no_grad():
        x = rec_normalize_device(torch.from_numpy(np.stack(imgs)).to(dev)).to(dtype)
        ids, probs = model(x)
    ids, probs = ids.cpu().numpy(), probs.float().cpu().numpy()
    ok = sum(decoder(ids[i], probs[i])[0] == text for i, text in enumerate(texts))
    return ok / n


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if not a.startswith("--lang")]
    lang = None
    for a in sys.argv[1:]:
        if a.startswith("--lang="):
            lang = a.split("=", 1)[1]
    steps = int(args[0]) if len(args) > 0 else 3000
    out = args[1] if len(args) > 1 else None
    warm = args[2] if len(args) > 2 else None
    v = train(steps, out, init_from=warm, lang=lang)
    logger.info("exact match: %.3f", evaluate(v, lang=lang))
