"""Demo trainers for the table stack (UNet, wired/wireless classifier, SLANet).

Usage:
    python -m rapiddoc_tpu_torch.train.table unet   [steps] [out.npz]
    python -m rapiddoc_tpu_torch.train.table cls    [steps] [out.npz]
    python -m rapiddoc_tpu_torch.train.table slanet [steps] [out.npz]

Port of ``rapiddoc_tpu/train/table.py``. All three train on
``synth_table`` tables, whose drawn grid lines, wiring and HTML token
stream are exact ground truth, and write checkpoints in the JAX layout
(``models/weights.save_variables`` of ``flax_variables``), which both
packages' ``TableRecognizer.build`` read as ``table_{unet,cls,slanet}.npz``.
Each trainer has its ``*_loss_fn``, ``*_optimizer``, ``*_train_step`` and
``new_*`` model, fp32 parameters, batch statistics in train mode
(``train/bn.py``), batches drawn with ``np.random.default_rng(seed)`` as
the JAX loops draw them, and runs on the card unless ``device="cpu"``.

- **UNet**: class-weighted cross-entropy plus dice on the line channel,
  Adam under the warm-up cosine schedule, 1024 x 1024 inputs.
- **Classifier**: softmax cross-entropy at 224 x 224; labels alternate
  wired (0) and wireless (1).
- **SLANet**: ImageNet normalization in float32, the head's 160 steps as
  a Python loop of ``SLAHeadStep`` with scheduled sampling (where
  ``coins[t]`` is set, the previous step's argmax, taken without
  gradient, is fed instead of the ground truth), masked cross-entropy plus
  2 x the masked L1 of the eight loc values, ``clip_by_global_norm(1.0)``
  then Adam. flax's ``GRUCell`` has no recurrent bias for its r and z
  gates; torch's carries them in ``bias_hh[:2H]``, which would take the
  same gradient as ``bias_ih``'s r and z slices, so Adam would move the
  folded bias twice as fast and the clip would count it twice. The step
  keeps those slices at zero with a zero gradient (``flax_gru_grads``).
  A daemon thread re-renders random pool rows while the card trains.

The CLI mirrors the JAX package's: an existing ``out.npz`` is read unless
``RAPIDDOC_TRAIN_FRESH`` is set, and only SLANet continues from it (with
pool seed ``RAPIDDOC_TRAIN_SEED``, default 17 warm and 0 fresh).
"""
from __future__ import annotations

import os
import random
import sys
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.session import resolve_device
from ..models.ocr.pre_post import resize_linear
from ..models.table.cls import TableClsNet
from ..models.table.slanet import (IMAGENET_MEAN, IMAGENET_STD, IMG_SIZE as SLA_SIZE,
                                   SLANetConfig, SLANetModel, SLANetVocab)
from ..models.table.unet import UNet
from ..models.weights import (flatten, flax_variables, init_params, load_flax_into, load_npz,
                              nest_models, save_variables, split_models)
from ..utils.logging import get_logger
from .bn import bn_training
from .optim import Adam, adam, train_step as _step, warmup_cosine_decay_schedule
from .synth_table import render_table, slanet_sample

logger = get_logger("rapiddoc_tpu_torch.train.table")

UNET_SIZE = 1024  # the production WiredTableStructure input
CLS_SIZE = 224
SLA_TRAIN_STEPS = 160  # token budget for training tables (decode uses 512)


def _schedule(steps: int, lr: float, cap: int):
    return warmup_cosine_decay_schedule(0.0, lr, min(cap, steps // 10), steps)


def _log_every(i: int, steps: int) -> bool:
    return i % 100 == 0 or i == steps - 1


# ----------------------------------------------------------------- UNet

def unet_pool_row(s) -> tuple[np.ndarray, np.ndarray]:
    """A wired table as the UNet trains on it: the image and the line mask
    (x 255) resized to 1024 x 1024, the mask thresholded at 64."""
    img = resize_linear(s.img, UNET_SIZE, UNET_SIZE)
    m = resize_linear(s.line_mask * 255, UNET_SIZE, UNET_SIZE)
    return img, (m > 64).astype(np.uint8)


def make_unet_pool(n: int, seed: int = 0):
    rng = random.Random(seed)
    imgs = np.zeros((n, UNET_SIZE, UNET_SIZE, 3), np.uint8)
    masks = np.zeros((n, UNET_SIZE, UNET_SIZE), np.uint8)
    for i in range(n):
        imgs[i], masks[i] = unet_pool_row(render_table(rng, wired=True))
    return imgs, masks


def unet_loss_fn(model: UNet, x_u8: torch.Tensor, y_u8: torch.Tensor) -> torch.Tensor:
    """Class-weighted CE of the (B, 2, H, W) logits against the line mask
    plus dice on the line channel's softmax."""
    x = x_u8.float() / 255.0
    y = y_u8.float()
    logits = model(x.permute(0, 3, 1, 2)).float()
    logp = F.log_softmax(logits, dim=1)
    ce = -(y * logp[:, 1] + (1 - y) * logp[:, 0])
    pos = y.sum() + 1.0
    w = pos / (y.numel() - pos + 1.0) * 3.0
    ce = torch.where(y > 0.5, ce, ce * w).mean()
    p = torch.softmax(logits, dim=1)[:, 1]
    dice = 1.0 - 2.0 * (p * y).sum() / (p.sum() + y.sum() + 1.0)
    return ce + dice


def unet_optimizer(model: torch.nn.Module, steps: int, lr: float = 1e-3) -> Adam:
    return adam(list(model.parameters()), _schedule(steps, lr, 100))


def unet_train_step(model: UNet, opt: Adam, x_u8: torch.Tensor, y_u8: torch.Tensor) -> torch.Tensor:
    return _step(unet_loss_fn, model, opt, x_u8, y_u8)


def new_unet(seed: int = 0) -> UNet:
    model = UNet()
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def _loop(model, step, opt: Adam, pool: tuple, steps: int, batch: int, seed: int, dev,
          name: str) -> None:
    """The UNet's and the classifier's loop: ``batch`` pool rows drawn
    each step with ``default_rng(seed).integers``."""
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, len(pool[0]), batch)
            loss = step(model, opt, *(torch.from_numpy(a[idx]).to(dev) for a in pool))
            if _log_every(i, steps):
                logger.info("%s step %d loss %.4f (%.1fs)", name, i, float(loss),
                            time.perf_counter() - tic)


def train_unet(steps: int = 1500, out_path=None, pool_n: int = 256, batch: int = 2,
               lr: float = 1e-3, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    model = new_unet(seed).to(dev)
    opt = unet_optimizer(model, steps, lr)
    logger.info("rendering %d wired tables @%d", pool_n, UNET_SIZE)
    _loop(model, unet_train_step, opt, make_unet_pool(pool_n, seed), steps, batch, seed, dev,
          "unet")
    variables = flax_variables(model)
    if out_path is not None:
        save_variables(variables, out_path)
        logger.info("unet weights -> %s", out_path)
    return variables


def eval_unet(variables: dict, n_tables: int = 10, seed: int = 7777, device=None) -> float:
    """Cell recall at IoU 0.5 through the production host recovery."""
    from ..models.table.unet import WiredTableStructure

    wired = WiredTableStructure(load_flax_into(UNet(), flatten(variables)), device=device)
    rng = random.Random(seed)
    hit = total = 0
    for _ in range(n_tables):
        s = render_table(rng, wired=True)
        cells, _grid = wired(s.img)
        pred = np.array(cells, np.float32).reshape(-1, 4)
        for x0, y0, x1, y1 in s.cell_boxes:
            total += 1
            if not len(pred):
                continue
            ix0 = np.maximum(pred[:, 0], x0)
            iy0 = np.maximum(pred[:, 1], y0)
            ix1 = np.minimum(pred[:, 2], x1)
            iy1 = np.minimum(pred[:, 3], y1)
            inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
            union = (
                (pred[:, 2] - pred[:, 0]) * (pred[:, 3] - pred[:, 1])
                + (x1 - x0) * (y1 - y0) - inter
            )
            if (inter / np.maximum(union, 1e-9)).max() >= 0.5:
                hit += 1
    return hit / max(total, 1)


# ------------------------------------------------------------------ cls

def make_cls_pool(n: int, seed: int = 0):
    """(uint8 tables (n, 224, 224, 3), int32 labels): even rows wired (0),
    odd rows wireless (1)."""
    rng = random.Random(seed)
    imgs = np.zeros((n, CLS_SIZE, CLS_SIZE, 3), np.uint8)
    labels = np.zeros((n,), np.int32)
    for i in range(n):
        wired = i % 2 == 0
        imgs[i] = resize_linear(render_table(rng, wired=wired).img, CLS_SIZE, CLS_SIZE)
        labels[i] = 0 if wired else 1
    return imgs, labels


def cls_loss_fn(model: TableClsNet, x_u8: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = model((x_u8.float() / 255.0).permute(0, 3, 1, 2)).float()
    return F.cross_entropy(logits, y.long())


def cls_optimizer(model: torch.nn.Module, steps: int, lr: float = 1e-3) -> Adam:
    return adam(list(model.parameters()), _schedule(steps, lr, 100))


def cls_train_step(model: TableClsNet, opt: Adam, x_u8: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return _step(cls_loss_fn, model, opt, x_u8, y)


def new_cls(seed: int = 0) -> TableClsNet:
    model = TableClsNet()
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def train_cls(steps: int = 1200, out_path=None, pool_n: int = 512, batch: int = 16,
              lr: float = 1e-3, seed: int = 0, device=None) -> dict:
    dev = resolve_device(device)
    model = new_cls(seed).to(dev)
    opt = cls_optimizer(model, steps, lr)
    logger.info("rendering %d cls tables", pool_n)
    _loop(model, cls_train_step, opt, make_cls_pool(pool_n, seed), steps, batch, seed, dev,
          "cls")
    variables = flax_variables(model)
    if out_path is not None:
        save_variables(variables, out_path)
        logger.info("cls weights -> %s", out_path)
    return variables


def eval_cls(variables: dict, n: int = 40, seed: int = 5555, device=None) -> float:
    from ..models.table.cls import TableClassifier

    clf = TableClassifier(load_flax_into(TableClsNet(), flatten(variables)), device=device)
    rng = random.Random(seed)
    ok = 0
    for i in range(n):
        wired = i % 2 == 0
        s = render_table(rng, wired=wired)
        ok += int(clf([s.img])[0] == ("wired" if wired else "wireless"))
    return ok / n


# --------------------------------------------------------------- SLANet

def make_sla_pool(n: int, vocab, seed: int = 0):
    rng = random.Random(seed)
    imgs = np.zeros((n, SLA_SIZE, SLA_SIZE, 3), np.uint8)
    toks = np.zeros((n, SLA_TRAIN_STEPS), np.int32)
    locs = np.zeros((n, SLA_TRAIN_STEPS, 8), np.float32)
    lmask = np.zeros((n, SLA_TRAIN_STEPS), np.float32)
    lens = np.zeros((n,), np.int32)
    i = 0
    while i < n:
        s = slanet_sample(rng, vocab, SLA_TRAIN_STEPS)
        if s is None:
            continue
        imgs[i], toks[i], locs[i], lmask[i], lens[i] = s
        i += 1
    return imgs, toks, locs, lmask, lens


def slanet_loss_fn(model: SLANetModel, x_u8: torch.Tensor, tok: torch.Tensor, loc: torch.Tensor,
                   lmask: torch.Tensor, lens: torch.Tensor, coins: torch.Tensor):
    """(loss, the (B, T) argmax stream of the head's steps). ``coins``
    (T, B) bool: where set, step t is fed step t - 1's argmax instead of
    the ground truth ``tok[:, t - 1]`` (``sos`` at t = 0)."""
    vocab = SLANetVocab()
    dev = x_u8.device
    mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
    std = torch.from_numpy(IMAGENET_STD).to(dev)
    x = (x_u8.float() / 255.0 - mean) / std
    fea_map = model.neck(model.backbone(x.permute(0, 3, 1, 2)))
    b, c, h, w = fea_map.shape
    fea = fea_map.permute(0, 2, 3, 1).reshape(b, h * w, c).float()
    fkey = model.fea_key(fea)
    tok = tok.long()
    B, T = tok.shape
    sos = torch.full((B, 1), vocab.sos_id, dtype=torch.long, device=dev)
    prev = torch.cat([sos, tok[:, :-1]], dim=1)
    hidden = torch.zeros((B, model.step.hidden), dtype=fea.dtype, device=dev)
    pred = sos[:, 0]
    logits_t, loc_t, preds = [], [], []
    for t in range(T):
        prev_t = torch.where(coins[t], pred, prev[:, t])
        hidden, logits, locp = model.step(hidden, prev_t, fea, fkey)
        pred = torch.argmax(logits.detach().float(), dim=-1)
        logits_t.append(logits)
        loc_t.append(locp)
        preds.append(pred)
    logits = torch.stack(logits_t, dim=1).float()
    locp = torch.stack(loc_t, dim=1).float()
    step_mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()
    ce = F.cross_entropy(logits.reshape(B * T, -1), tok.reshape(-1), reduction="none").reshape(B, T)
    ce = (ce * step_mask).sum() / torch.clamp(step_mask.sum(), min=1.0)
    l1 = ((locp - loc).abs().sum(-1) * lmask).sum() / torch.clamp(lmask.sum(), min=1.0)
    return ce + 2.0 * l1, torch.stack(preds, dim=1)


def flax_gru_grads(cell: torch.nn.GRUCell) -> None:
    """Zero the gradient of the recurrent r and z biases (``bias_hh[:2H]``),
    which flax's ``GRUCell`` does not have: held at zero, they leave the
    folded biases, the global norm and Adam's moments as flax's."""
    if cell.bias_hh.grad is not None:
        cell.bias_hh.grad[: 2 * cell.hidden_size] = 0


def slanet_optimizer(model: torch.nn.Module, steps: int, lr: float = 1e-3) -> Adam:
    return adam(list(model.parameters()), _schedule(steps, lr, 200), max_norm=1.0)


def slanet_train_step(model: SLANetModel, opt: Adam, *batch: torch.Tensor):
    """One step: the loss, its gradients with the GRU's extra biases held
    (``flax_gru_grads``), the clip and Adam's update; (loss, argmax
    stream), detached."""
    opt.zero_grad()
    loss, preds = slanet_loss_fn(model, *batch)
    loss.backward()
    flax_gru_grads(model.step.gru)
    opt.step()
    return loss.detach(), preds


def new_slanet(seed: int = 0) -> SLANetModel:
    model = SLANetModel(SLANetConfig(), len(SLANetVocab()))
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def sampling_rate(i: int, steps: int, warm: bool) -> float:
    """The scheduled-sampling rate: a fresh run learns the grammar
    teacher-forced for a quarter, then ramps to 0.35; a warm continue
    ramps over 1000 steps."""
    if warm:
        return min(0.35, 0.35 * i / 1000.0)
    return 0.0 if i < steps // 4 else min(0.35, 0.35 * (i - steps // 4) / max(steps // 4, 1))


class PoolRefresh:
    """A daemon thread re-rendering random rows of a pool while the card
    trains (a fixed pool gets memorized): ``sample(rng)`` draws from
    ``random.Random(seed + 101)`` and the rows from
    ``default_rng(seed + 202)``; rows are written under ``lock``."""

    def __init__(self, arrays: tuple, sample, seed: int):
        self.arrays = arrays
        self.sample = sample
        self.seed = seed
        self.lock = threading.Lock()
        self.refreshed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        rrng = random.Random(self.seed + 101)
        nidx = np.random.default_rng(self.seed + 202)
        n = len(self.arrays[0])
        while not self._stop.is_set():
            s = self.sample(rrng)
            if s is None:
                continue
            j = int(nidx.integers(0, n))
            with self.lock:
                for a, v in zip(self.arrays, s):
                    a[j] = v
            self.refreshed += 1

    def take(self, idx: np.ndarray) -> tuple:
        with self.lock:
            return tuple(a[idx].copy() for a in self.arrays)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()


def train_slanet(steps: int = 4000, out_path=None, pool_n: int = 3072, batch: int = 8,
                 lr: float = 1e-3, seed: int = 0, variables: dict | None = None,
                 device=None) -> dict:
    """Train from a seeded init, or continue ``variables`` (flat
    ``backbone/params/…`` leaves, as the checkpoint stores them)."""
    warm = variables is not None
    dev = resolve_device(device)
    vocab = SLANetVocab()
    model = new_slanet(seed)
    if warm:
        load_flax_into(model, nest_models(variables))
    model.to(dev)
    opt = slanet_optimizer(model, steps, lr)

    def checkpoint() -> dict:
        return split_models(flax_variables(model))

    logger.info("rendering %d slanet tables", pool_n)
    pool = make_sla_pool(pool_n, vocab, seed)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with PoolRefresh(pool, lambda r: slanet_sample(r, vocab, SLA_TRAIN_STEPS), seed) as refresh, \
            bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, pool_n, batch)
            p = sampling_rate(i, steps, warm)
            coins = nrng.random((SLA_TRAIN_STEPS, batch)) < p
            xs = [torch.from_numpy(a).to(dev) for a in refresh.take(idx)]
            loss, _ = slanet_train_step(model, opt, *xs, torch.from_numpy(coins).to(dev))
            if _log_every(i, steps):
                logger.info("slanet step %d loss %.4f p_ss %.2f (%.1fs)", i, float(loss), p,
                            time.perf_counter() - tic)
            if out_path is not None and i and i % 1000 == 0:
                save_variables(checkpoint(), out_path)
    variables = checkpoint()
    if out_path is not None:
        save_variables(variables, out_path)
        logger.info("slanet weights -> %s", out_path)
    return variables


def eval_slanet(variables: dict, n: int = 24, seed: int = 3333, device=None) -> dict:
    """Exact structure-sequence rate, TEDS-S (structure-only tree edit
    distance similarity) and mean cell-box IoU."""
    from ..models.table.slanet import SLANetStructure
    from ..utils.teds import teds

    model = load_flax_into(SLANetModel(SLANetConfig(), len(SLANetVocab())),
                           nest_models(flatten(variables)))
    sla = SLANetStructure(model, device=device)
    rng = random.Random(seed)
    seq_ok = 0
    ious, teds_scores = [], []
    for _ in range(n):
        s = render_table(rng, wired=rng.random() < 0.5)
        (structure, bboxes), = sla([s.img])
        teds_scores.append(teds("<table>" + "".join(structure) + "</table>",
                                "<table>" + "".join(s.tokens) + "</table>", structure_only=True))
        seq_ok += structure == s.tokens
        ious += cell_ious(bboxes, s.cell_boxes)
    return {"seq_acc": seq_ok / n,
            "teds_s": float(np.mean(teds_scores)) if teds_scores else 0.0,
            "cell_iou": float(np.mean(ious)) if ious else 0.0}


def cell_ious(pred_boxes, gt_boxes) -> list[float]:
    """IoU of each predicted cell box with the ground truth's in order."""
    out = []
    for pred, gt in zip(pred_boxes, gt_boxes):
        x0, y0, x1, y1 = gt
        px0, py0, px1, py1 = pred
        iw = max(0.0, min(px1, x1) - max(px0, x0))
        ih = max(0.0, min(py1, y1) - max(py0, y0))
        inter = iw * ih
        union = (px1 - px0) * (py1 - py0) + (x1 - x0) * (y1 - y0) - inter
        out.append(inter / max(union, 1e-9))
    return out


def warm_start(out: str | None) -> dict | None:
    """The flat leaves of an existing ``out`` unless RAPIDDOC_TRAIN_FRESH
    is set (the JAX CLIs' rule)."""
    if out and os.path.isfile(out) and not os.environ.get("RAPIDDOC_TRAIN_FRESH"):
        logger.info("warm start from %s", out)
        return load_npz(out)
    return None


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "unet"
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else None
    out = sys.argv[3] if len(sys.argv) > 3 else None
    init = warm_start(out)
    if which == "unet":
        v = train_unet(steps or 1500, out)
        logger.info("unet cell recall: %.3f", eval_unet(v))
    elif which == "cls":
        v = train_cls(steps or 1200, out)
        logger.info("cls acc: %.3f", eval_cls(v))
    elif which == "slanet":
        # a warm continue defaults to a fresh pool seed: another tour of a
        # pool the model already fits teaches nothing about free-run drift
        seed = int(os.environ.get("RAPIDDOC_TRAIN_SEED", "17" if init is not None else "0"))
        v = train_slanet(steps or 4000, out, variables=init, seed=seed)
        logger.info("slanet eval: %s", eval_slanet(v))
    else:
        raise SystemExit(f"unknown target {which}")
