"""Train the RT-DETR layout detector on synthetic labeled pages (demo
layout weights).

Usage: python -m rapiddoc_tpu_torch.train.layout [steps] [out.npz]

Port of ``rapiddoc_tpu/train/layout.py``. The DETR recipe: Hungarian
matching (scipy's ``linear_sum_assignment``, on the host) of each decoder
layer's predictions and of the encoder's query-selection head (detached
from the decoder path, so it learns only from its own loss) against the
page's boxes, then a sigmoid focal loss (alpha 0.25, gamma 2) plus L1 and
GIoU, weighted 2 / 5 / 2, ``clip_by_global_norm(0.5)`` and ``adamw``
(weight decay 1e-4) under the warm-up cosine schedule.

Each step syncs once: a matching forward (batch statistics, as the grad
pass normalizes) brings logits and boxes to the host, the matched targets
go back, and the grad step recomputes the forward. The matching forward
leaves the running statistics as they were (``bn.frozen_stats``): flax's
``fwd`` discards its ``batch_stats`` update and only the grad step's is
kept, where a torch ``BatchNorm`` in train mode would move them on both
forwards. Runs on the card unless ``device="cpu"``; fp32 parameters.
"""
from __future__ import annotations

import random
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import linear_sum_assignment

from ..engine.session import resolve_device
from ..models.layout.engine import DOCLAYOUT_V2_LABELS
from ..models.layout.rtdetr import RTDETR
from ..models.ocr.pre_post import resize_area
from ..models.weights import flatten, flax_variables, init_params, load_flax_into, save_variables
from ..utils.logging import get_logger
from .bn import bn_training, frozen_stats
from .optim import Adam, adamw, warmup_cosine_decay_schedule
from .synth_layout import render_layout_page

logger = get_logger("rapiddoc_tpu_torch.train.layout")

SIZE = 640
NUM_CLASSES = 25
MAX_T = 56  # targets per page, padded

# the demo arch (LayoutDetector.build reads it from layout_demo.json)
DEMO_ARCH = dict(
    model_size="B0", input_size=SIZE, num_queries=60, dec_layers=3,
    with_masks=False,
)

W_CLS, W_L1, W_GIOU = 2.0, 5.0, 2.0
FOCAL_ALPHA, FOCAL_GAMMA = 0.25, 2.0

# page aspect ratios (h/w): square scans, 4:3, letter, A4; the detector
# squishes every page to its square, so training sees squished pages
ASPECTS = (1.0, 1.2, 1.294, 1.414)


def make_model(aux: bool) -> RTDETR:
    return RTDETR(
        num_classes=NUM_CLASSES,
        backbone_size=DEMO_ARCH["model_size"],
        num_queries=DEMO_ARCH["num_queries"],
        dec_layers=DEMO_ARCH["dec_layers"],
        with_masks=DEMO_ARCH["with_masks"],
        aux=aux,
    )


def new_model(seed: int = 0, variables: dict | None = None) -> RTDETR:
    """The training model (``aux``), from flax's initializers seeded with
    ``seed``, or from ``variables`` (flat ``params/…`` leaves or a tree)."""
    model = make_model(aux=True)
    if variables is None:
        init_params(model, torch.Generator().manual_seed(seed))
    else:
        load_flax_into(model, flatten(variables))
    return model


def _render_training_page(rng: random.Random):
    """(SIZE x SIZE squished page, gt in squished pixels)."""
    aspect = rng.choice(ASPECTS)
    h = int(SIZE * aspect)
    img, gt = render_layout_page(rng, SIZE, height=h)
    if h != SIZE:
        img = resize_area(img, SIZE, SIZE)
        sy = SIZE / h
        gt = [(cid, x0, y0 * sy, x1, y1 * sy) for cid, x0, y0, x1, y1 in gt]
    return img, gt


def make_pool(n_pages: int, seed: int = 0):
    """(uint8 pages (n, 640, 640, 3), classes (n, MAX_T) int32 with -1
    padding, boxes (n, MAX_T, 4) cxcywh in [0, 1])."""
    rng = random.Random(seed)
    imgs = np.zeros((n_pages, SIZE, SIZE, 3), np.uint8)
    tcls = np.full((n_pages, MAX_T), -1, np.int32)
    tbox = np.zeros((n_pages, MAX_T, 4), np.float32)
    for i in range(n_pages):
        img, gt = _render_training_page(rng)
        imgs[i] = img
        for j, (cid, x0, y0, x1, y1) in enumerate(gt[:MAX_T]):
            tcls[i, j] = cid
            tbox[i, j] = (
                (x0 + x1) / 2 / SIZE, (y0 + y1) / 2 / SIZE,
                (x1 - x0) / SIZE, (y1 - y0) / SIZE,
            )
    return imgs, tcls, tbox


def _giou_np(boxes_a: np.ndarray, boxes_b: np.ndarray) -> np.ndarray:
    """GIoU matrix for cxcywh boxes: (Na, Nb)."""
    def to_xyxy(b):
        return np.stack(
            [b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
             b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1,
        )

    a, b = to_xyxy(boxes_a), to_xyxy(boxes_b)
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[:, None] + area_b[None] - inter
    iou = inter / np.maximum(union, 1e-9)
    lt_c = np.minimum(a[:, None, :2], b[None, :, :2])
    rb_c = np.maximum(a[:, None, 2:], b[None, :, 2:])
    wh_c = np.clip(rb_c - lt_c, 0, None)
    hull = wh_c[..., 0] * wh_c[..., 1]
    return iou - (hull - union) / np.maximum(hull, 1e-9)


def match_batch(logits, boxes, tcls, tbox):
    """Hungarian match one prediction set against targets.

    logits (B, Nq, C) f32, boxes (B, Nq, 4); tcls (B, MAX_T) int (-1 pad).
    Returns per-query targets: qcls (B, Nq) int32 (-1 = background),
    qbox (B, Nq, 4).
    """
    B, Nq, _ = logits.shape
    qcls = np.full((B, Nq), -1, np.int32)
    qbox = np.zeros((B, Nq, 4), np.float32)
    probs = 1.0 / (1.0 + np.exp(-logits))
    for b in range(B):
        valid = tcls[b] >= 0
        T = int(valid.sum())
        if T == 0:
            continue
        tc = tcls[b, :T]
        tb = tbox[b, :T]
        cost_cls = -probs[b][:, tc]  # (Nq, T)
        cost_l1 = np.abs(boxes[b][:, None, :] - tb[None]).sum(-1)
        cost_giou = -_giou_np(boxes[b], tb)
        cost = W_CLS * cost_cls + W_L1 * cost_l1 + W_GIOU * cost_giou
        qi, ti = linear_sum_assignment(cost)
        qcls[b, qi] = tc[ti]
        qbox[b, qi] = tb[ti]
    return qcls, qbox


def giou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise GIoU for matched cxcywh pairs (..., 4)."""
    ax0, ay0 = a[..., 0] - a[..., 2] / 2, a[..., 1] - a[..., 3] / 2
    ax1, ay1 = a[..., 0] + a[..., 2] / 2, a[..., 1] + a[..., 3] / 2
    bx0, by0 = b[..., 0] - b[..., 2] / 2, b[..., 1] - b[..., 3] / 2
    bx1, by1 = b[..., 0] + b[..., 2] / 2, b[..., 1] + b[..., 3] / 2
    inter_w = torch.clamp(torch.minimum(ax1, bx1) - torch.maximum(ax0, bx0), min=0)
    inter_h = torch.clamp(torch.minimum(ay1, by1) - torch.maximum(ay0, by0), min=0)
    inter = inter_w * inter_h
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    iou = inter / torch.clamp(union, min=1e-9)
    hull_w = torch.maximum(ax1, bx1) - torch.minimum(ax0, bx0)
    hull_h = torch.maximum(ay1, by1) - torch.minimum(ay0, by0)
    hull = hull_w * hull_h
    return iou - (hull - union) / torch.clamp(hull, min=1e-9)


def predictions(model: RTDETR, x_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(logits, boxes) (L + 1, B, Nq, ·) in float32: the decoder layers,
    then the encoder's head."""
    preds = model(x_u8.float() / 255.0)
    logits = torch.cat([preds["aux_logits"], preds["enc_logits"][None]]).float()
    boxes = torch.cat([preds["aux_boxes"], preds["enc_boxes"][None]]).float()
    return logits, boxes


def loss_fn(model: RTDETR, x_u8: torch.Tensor, qcls: torch.Tensor,
            qbox: torch.Tensor) -> torch.Tensor:
    """qcls/qbox: (L+1, B, Nq[, 4]), decoder layers then the enc head."""
    logits, boxes = predictions(model, x_u8)
    pos = qcls >= 0
    n_pos = torch.clamp(pos.sum(), min=1).float()
    onehot = F.one_hot(qcls.clamp(min=0).long(), NUM_CLASSES).float() * pos[..., None]
    p = torch.sigmoid(logits)
    ce = -(onehot * torch.log(torch.clamp(p, min=1e-8))
           + (1 - onehot) * torch.log(torch.clamp(1 - p, min=1e-8)))
    p_t = p * onehot + (1 - p) * (1 - onehot)
    alpha_t = FOCAL_ALPHA * onehot + (1 - FOCAL_ALPHA) * (1 - onehot)
    focal = (alpha_t * (1 - p_t) ** FOCAL_GAMMA * ce).sum() / n_pos
    l1 = ((boxes - qbox).abs().sum(-1) * pos).sum() / n_pos
    g = ((1.0 - giou(boxes, qbox)) * pos).sum() / n_pos
    return W_CLS * focal + W_L1 * l1 + W_GIOU * g


def make_optimizer(model: torch.nn.Module, steps: int, lr: float = 2.5e-4) -> Adam:
    return adamw(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(500, max(1, steps // 10)), steps), weight_decay=1e-4, max_norm=0.5)


def match(model: RTDETR, x_u8: torch.Tensor, tcls: np.ndarray, tbox: np.ndarray):
    """The matching pass: a forward with batch statistics that leaves the
    running statistics alone, then each layer's Hungarian match on the
    host. Returns (qcls (L+1, B, Nq), qbox (L+1, B, Nq, 4)) numpy."""
    with torch.no_grad(), frozen_stats(model):
        logits, boxes = predictions(model, x_u8)
    logits, boxes = logits.cpu().numpy(), boxes.cpu().numpy()
    n_layers, batch, nq = logits.shape[:3]
    qcls = np.zeros((n_layers, batch, nq), np.int32)
    qbox = np.zeros((n_layers, batch, nq, 4), np.float32)
    for li in range(n_layers):
        qcls[li], qbox[li] = match_batch(logits[li], boxes[li], tcls, tbox)
    return qcls, qbox


def train_step(model: RTDETR, opt: Adam, x_u8: torch.Tensor, tcls: np.ndarray,
               tbox: np.ndarray) -> tuple[torch.Tensor, np.ndarray]:
    """One step: the matching pass, then forward, backward and update with
    the matched targets. Returns (the loss, detached; qcls)."""
    qcls, qbox = match(model, x_u8, tcls, tbox)
    dev = x_u8.device
    opt.zero_grad()
    loss = loss_fn(model, x_u8, torch.from_numpy(qcls).to(dev), torch.from_numpy(qbox).to(dev))
    loss.backward()
    opt.step()
    return loss.detach(), qcls


def train(steps: int = 12000, out_path=None, pool_pages: int = 768,
          batch: int = 8, lr: float = 2.5e-4, seed: int = 0,
          variables: dict | None = None, log_every: int = 100, device=None) -> dict:
    """Train from a seeded init, or from ``variables``; returns the
    flax-layout variables (and writes them to ``out_path``, also every
    2000 steps)."""
    dev = resolve_device(device)
    model = new_model(seed, variables).to(dev)
    opt = make_optimizer(model, steps, lr)
    logger.info("rendering %d labeled pages", pool_pages)
    imgs, tcls, tbox = make_pool(pool_pages, seed)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    with bn_training(model):
        for i in range(steps):
            idx = nrng.integers(0, pool_pages, batch)
            x = torch.from_numpy(imgs[idx]).to(dev)
            loss, _ = train_step(model, opt, x, tcls[idx], tbox[idx])
            if i % log_every == 0 or i == steps - 1:
                logger.info("step %d loss %.4f (%.1fs)", i, float(loss),
                            time.perf_counter() - tic)
            if out_path is not None and i and i % 2000 == 0:
                save_demo(flax_variables(model), out_path)
    variables = flax_variables(model)
    if out_path is not None:
        save_demo(variables, out_path)
    return variables


def save_demo(variables: dict, out_path) -> None:
    import json
    from pathlib import Path

    out_path = Path(out_path)
    save_variables(variables, out_path, half=True)
    cfg = dict(DEMO_ARCH)
    cfg["conf_threshold"] = 0.4
    out_path.with_suffix(".json").write_text(json.dumps(cfg))
    logger.info("layout weights -> %s (+ .json arch config)", out_path)


def evaluate(variables: dict, n_pages: int = 12, seed: int = 9999,
             conf: float = 0.4, iou_thresh: float = 0.5, device=None) -> dict:
    """Detection quality on held-out pages through the production
    LayoutDetector postprocess: {recall, precision, cls_acc}."""
    from ..models.layout.engine import LayoutConfig, LayoutDetector

    cfg = LayoutConfig(
        model_size=DEMO_ARCH["model_size"], input_size=DEMO_ARCH["input_size"],
        num_queries=DEMO_ARCH["num_queries"], dec_layers=DEMO_ARCH["dec_layers"],
        with_masks=DEMO_ARCH["with_masks"], conf_threshold=conf,
    )
    model = load_flax_into(LayoutDetector.make_model(cfg), flatten(variables))
    det = LayoutDetector(model, config=cfg, device=device)
    rng = random.Random(seed)
    hit = total = n_pred = cls_hit = 0
    for _ in range(n_pages):
        aspect = rng.choice(ASPECTS)
        img, gt = render_layout_page(rng, SIZE, height=int(SIZE * aspect))
        dets = det.batch_predict([img])[0]
        n_pred += len(dets)
        pred = np.array(
            [[d["poly"][0], d["poly"][1], d["poly"][4], d["poly"][5]] for d in dets],
            np.float32,
        ).reshape(-1, 4)
        labels = [d["original_label"] for d in dets]
        for cid, x0, y0, x1, y1 in gt:
            total += 1
            if len(pred) == 0:
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
            ious = inter / np.maximum(union, 1e-9)
            j = int(np.argmax(ious))
            if ious[j] >= iou_thresh:
                hit += 1
                if labels[j] == DOCLAYOUT_V2_LABELS[cid]:
                    cls_hit += 1
    return {
        "recall": hit / max(total, 1),
        "precision": hit / max(n_pred, 1),
        "cls_acc": cls_hit / max(hit, 1),
    }


def tune_conf(variables: dict, confs=(0.25, 0.3, 0.35, 0.4, 0.5), n_pages: int = 8,
              device=None):
    """The confidence threshold maximizing recall * precision on held-out
    pages: (best_conf, {conf: metrics})."""
    results = {c: evaluate(variables, n_pages=n_pages, conf=c, device=device) for c in confs}
    best = max(results, key=lambda c: results[c]["recall"] * results[c]["precision"])
    return best, results


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 12000
    out = sys.argv[2] if len(sys.argv) > 2 else None
    v = train(steps, out)
    logger.info("eval: %s", evaluate(v))
