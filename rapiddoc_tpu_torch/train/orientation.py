"""Demo trainer for the 0/90/180/270 orientation classifier.

Usage: python -m rapiddoc_tpu_torch.train.orientation [steps] [out.npz]

Port of ``rapiddoc_tpu/train/orientation.py``: synthetic pages
(``synth.render_page``) cut to a portrait width, turned by a known angle
(``np.rot90``) and resized to 224 x 224 (``resize_linear``, cv2's
INTER_LINEAR), softmax cross-entropy, Adam under a warm-up cosine
schedule. The checkpoint loads into ``models/orientation.OrientationNet``.
An existing ``out.npz`` is a warm start unless ``RAPIDDOC_TRAIN_FRESH`` is
set, as in the JAX trainer.
"""
from __future__ import annotations

import functools
import os
import random
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.session import resolve_device
from ..models.ocr.pre_post import resize_linear
from ..models.orientation.engine import ANGLES, OrientationClassifier, OrientationNet
from ..models.weights import flatten, flax_variables, init_params, load_flax_into, load_npz, save_variables
from ..utils.logging import get_logger
from .bn import bn_training
from .optim import Adam, adam, train_step as _step, warmup_cosine_decay_schedule
from .synth import render_page

logger = get_logger("rapiddoc_tpu_torch.train.orientation")

SIZE = 224


def make_pool(n: int, seed: int = 0):
    """(uint8 images (n, 224, 224, 3), int32 labels): image i turned by
    90 * (i % 4) degrees counter-clockwise, labelled with the clockwise
    turn that undoes it (an index of ``ANGLES``)."""
    rng = random.Random(seed)
    imgs = np.zeros((n, SIZE, SIZE, 3), np.uint8)
    labels = np.zeros((n,), np.int32)
    for i in range(n):
        # portrait-ish source so 90/270 are told apart by content
        page, _ = render_page(rng, 512)
        page = page[:, : rng.randint(280, 420)]
        k = i % 4
        imgs[i] = resize_linear(np.ascontiguousarray(np.rot90(page, k)), SIZE, SIZE)
        labels[i] = (4 - k) % 4 if k else 0
    return imgs, labels


def loss_fn(model: OrientationNet, x_u8: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = model(x_u8.float() / 255.0).float()
    return F.cross_entropy(logits, y.long())


def make_optimizer(model: torch.nn.Module, steps: int, lr: float = 1e-3) -> Adam:
    return adam(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(100, steps // 10), steps))


# one step: forward, backward, update; the loss
train_step = functools.partial(_step, loss_fn)


def new_model(seed: int = 0) -> OrientationNet:
    model = OrientationNet()
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def train(steps: int = 1500, out_path=None, pool_n: int = 512, batch: int = 16,
          lr: float = 1e-3, seed: int = 0, init_from: str | None = None, device=None) -> dict:
    dev = resolve_device(device)
    model = new_model(seed)
    if init_from:
        if not Path(init_from).is_file():
            raise FileNotFoundError(init_from)
        load_flax_into(model, load_npz(init_from))
        logger.info("warm start from %s", init_from)
    model.to(dev)
    opt = make_optimizer(model, steps, lr)
    logger.info("rendering %d rotated pages", pool_n)
    imgs, labels = make_pool(pool_n, seed)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, pool_n, batch)
            loss = train_step(model, opt, torch.from_numpy(imgs[idx]).to(dev),
                              torch.from_numpy(labels[idx]).to(dev))
            if i % 100 == 0 or i == steps - 1:
                logger.info("step %d loss %.4f (%.1fs)", i, float(loss),
                            time.perf_counter() - tic)
    out = flax_variables(model)
    if out_path is not None:
        save_variables(out, out_path)
        logger.info("orientation weights -> %s", out_path)
    return out


def evaluate(variables: dict, n: int = 40, seed: int = 1111, device=None) -> float:
    clf = OrientationClassifier(load_flax_into(OrientationNet(), flatten(variables)),
                                device=device)
    rng = random.Random(seed)
    ok = 0
    for i in range(n):
        page, _ = render_page(rng, 512)
        page = page[:, : rng.randint(280, 420)]
        k = i % 4
        rot = np.rot90(page, k).copy()
        want = (4 - k) % 4 if k else 0
        ok += int(clf([rot])[0] == ANGLES[want])
    return ok / n


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1500
    out = sys.argv[2] if len(sys.argv) > 2 else None
    fresh = not (out and os.path.isfile(out)) or os.environ.get("RAPIDDOC_TRAIN_FRESH")
    v = train(steps, out, init_from=None if fresh else out)
    logger.info("orientation acc: %.3f", evaluate(v))
