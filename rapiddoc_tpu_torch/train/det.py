"""Train DBNet on synthetic pages (demo det weights).

Usage: python -m rapiddoc_tpu_torch.train.det [steps] [out.npz]

Port of ``rapiddoc_tpu/train/det.py``: the binary-segmentation objective
on the DB shrink mask (class-balanced BCE plus dice), Adam under a warm-up
cosine schedule (``train/optim.py``), batch statistics in train mode
(``train/bn.py``), batches drawn from a pregenerated pool with
``np.random.default_rng(seed).integers`` as the JAX loop draws them. The
model starts from flax's initializers in distribution, drawn from a
``torch.Generator`` seeded with ``seed`` (not JAX's bits). Runs on the
card unless ``device="cpu"``; fp32 parameters and activations.
"""
from __future__ import annotations

import functools
import random
import sys
import time

import numpy as np
import torch

from ..engine.session import resolve_device
from ..models.ocr.det import DBNet
from ..models.ocr.pre_post import det_normalize_device
from ..models.weights import flatten, flax_variables, init_params, load_flax_into, save_variables
from ..utils.logging import get_logger
from .bn import bn_training
from .optim import Adam, adam, train_step as _step, warmup_cosine_decay_schedule
from .synth import db_prob_target, render_page, scan_wash

logger = get_logger("rapiddoc_tpu_torch.train.det")

SIZE = 640


def make_pool(n_pages: int, seed: int = 0, size: int = SIZE):
    """(uint8 pages (n, size, size, 3), uint8 0/1 shrink-mask targets)."""
    rng = random.Random(seed)
    imgs = np.zeros((n_pages, size, size, 3), np.uint8)
    targets = np.zeros((n_pages, size, size), np.uint8)
    for i in range(n_pages):
        img, boxes = render_page(rng, size)
        if rng.random() < 0.4:
            # photometric only (ink fade / gamma / JPEG): box targets
            # are geometry and stay valid
            img = scan_wash(img, rng)
        imgs[i] = img
        targets[i] = db_prob_target(boxes, size).astype(np.uint8)
    return imgs, targets


def loss_fn(model: DBNet, x_u8: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Class-balanced BCE plus dice of the prob map against ``y``."""
    y = y.float()
    prob = model(det_normalize_device(x_u8))[..., 0].float()
    p = torch.clamp(prob, 1e-5, 1 - 1e-5)
    bce = -(y * torch.log(p) + (1 - y) * torch.log(1 - p))
    # class-balanced: positives are sparse
    pos = y.sum() + 1.0
    neg_w = pos / (y.numel() - pos + 1.0) * 3.0
    bce = torch.where(y > 0.5, bce, bce * neg_w).mean()
    inter = (p * y).sum()
    dice = 1.0 - 2.0 * inter / (p.sum() + y.sum() + 1.0)
    return bce + dice


def make_optimizer(model: torch.nn.Module, steps: int, lr: float = 2e-3) -> Adam:
    return adam(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(100, steps // 10), steps))


# one step: forward, backward, update; the loss
train_step = functools.partial(_step, loss_fn)


def new_model(seed: int = 0) -> DBNet:
    model = DBNet()
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def train(steps: int = 1200, out_path=None, pool_pages: int = 192, batch: int = 4,
          lr: float = 2e-3, seed: int = 0, device=None) -> dict:
    """Train from a seeded init; returns the flax-layout variables (and
    writes them to ``out_path``)."""
    dev = resolve_device(device)
    model = new_model(seed).to(dev)
    opt = make_optimizer(model, steps, lr)
    logger.info("rendering %d synthetic pages", pool_pages)
    imgs, targets = make_pool(pool_pages, seed)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, pool_pages, batch)
            x = torch.from_numpy(imgs[idx]).to(dev)
            y = torch.from_numpy(targets[idx]).to(dev)
            loss = train_step(model, opt, x, y)
            if i % 100 == 0 or i == steps - 1:
                logger.info("step %d loss %.4f (%.1fs)", i, float(loss),
                            time.perf_counter() - tic)
    variables = flax_variables(model)
    if out_path is not None:
        save_variables(variables, out_path)
        logger.info("det weights -> %s", out_path)
    return variables


def evaluate(variables: dict, n_pages: int = 8, seed: int = 999, device=None) -> float:
    """Line-level recall: fraction of GT boxes hit by a detected box."""
    from ..models.ocr.engine import TextDetector

    det = TextDetector(load_flax_into(DBNet(), flatten(variables)), device=device)
    rng = random.Random(seed)
    hit = total = 0
    for _ in range(n_pages):
        img, boxes = render_page(rng, SIZE)
        found = det([img])[0].boxes
        for x0, y0, x1, y1 in boxes:
            total += 1
            cx, cy = (x0 + x1) / 2, (y0 + y1) / 2
            for quad in found:
                xs = quad[:, 0]
                ys = quad[:, 1]
                if xs.min() <= cx <= xs.max() and ys.min() <= cy <= ys.max():
                    hit += 1
                    break
    return hit / max(total, 1)


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 1200
    out = sys.argv[2] if len(sys.argv) > 2 else None
    v = train(steps, out)
    logger.info("line recall: %.3f", evaluate(v))
