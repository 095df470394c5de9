"""Demo trainer for UniTable (ViT encoder + GPT decoder, html+bbox stream).

Usage:
    python -m rapiddoc_tpu_torch.train.unitable [steps] [out.npz]

Port of ``rapiddoc_tpu/train/unitable.py``: the published architecture
(``models/table/unitable.py``; ``UniTableDims()`` is the 12 x 768
encoder and 4 x 768 decoder, the default is ``DEMO_UNITABLE_DIMS``) on
``synth_table`` tables, whose structure tokens and cell boxes are turned
into UniTable's html+bbox grammar (each ``<td>`` carries four quantized
bbox tokens between ``<td>[`` / ``]</td>`` or ``>[`` / ``></td>``).

Teacher forcing is one full-width decoder pass at position 0 over fresh
per-layer caches (``decode_full``): the cached attention's ``key <=
query`` mask is then the causal mask. Scheduled sampling takes two
passes: the first, without gradient, gives the model's own argmax
stream; where ``coins`` is set, the second sees that prediction as its
previous token. The loss is the masked CE, with 15 % of a bbox token's
target mass on each neighbouring bin, and the structure and bbox CEs
beside it. ``clip_by_global_norm(1.0)`` then ``adamw`` (weight decay
1e-4 on every leaf), fp32 parameters, a pool-refresh thread, checkpoints
in half precision in the JAX layout (``encoder/…``, ``decoder/…``,
``mem_proj/…``), which both packages' ``TableRecognizer.build`` read as
``table_unitable.npz``. Runs on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import os
import random
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..engine.session import resolve_device
from ..models.ocr.pre_post import resize_linear
from ..models.table.unitable import (BBOX_BASE, DEMO_UNITABLE_DIMS, EOS_ID, HTML_BASE, HTML_TOKENS,
                                     IMG_SIZE, N_BBOX_BINS, PAD_ID, PREFIX_ID, UNITABLE_MEAN,
                                     UNITABLE_STD, GPTFastDecoder, UniTableDims, UniTableModel,
                                     dims_from_variables)
from ..models.weights import (flatten, flax_variables, init_params, load_flax_into, nest_models,
                              save_variables, split_models)
from ..utils.logging import get_logger
from .optim import Adam, adamw, warmup_cosine_decay_schedule
from .synth_table import render_table
from .table import PoolRefresh, cell_ious, sampling_rate, warm_start

logger = get_logger("rapiddoc_tpu_torch.train.unitable")

TRAIN_STEPS = 256  # token budget (the production decode's default max_len)
_HTML_ID = {t: HTML_BASE + i for i, t in enumerate(HTML_TOKENS)}


def to_unitable_ids(tokens: list[str], cell_boxes: list[tuple[float, float, float, float]],
                    src_w: int, src_h: int) -> list[int] | None:
    """Canonical structure tokens + per-<td> boxes -> html+bbox id stream
    (terminated with EOS); None when a token has no vocab id."""
    sx, sy = IMG_SIZE / src_w, IMG_SIZE / src_h

    def bbox_ids(box):
        x0, y0, x1, y1 = box
        vals = (x0 * sx, y0 * sy, x1 * sx, y1 * sy)
        return [BBOX_BASE + int(np.clip(round(v), 0, N_BBOX_BINS - 1)) for v in vals]

    ids: list[int] = []
    cell_i = 0
    i = 0
    while i < len(tokens):
        t = tokens[i]
        if t == "<td></td>":
            ids.append(_HTML_ID["<td>["])
            ids += bbox_ids(cell_boxes[cell_i])
            ids.append(_HTML_ID["]</td>"])
            cell_i += 1
        elif t == "<td":
            ids.append(_HTML_ID["<td"])
            i += 1
            while i < len(tokens) and tokens[i] != ">":
                if tokens[i] not in _HTML_ID:
                    return None
                ids.append(_HTML_ID[tokens[i]])
                i += 1
            ids.append(_HTML_ID[">["])
            ids += bbox_ids(cell_boxes[cell_i])
            ids.append(_HTML_ID["></td>"])
            cell_i += 1
            i += 1  # skip the trailing "</td>"
        else:
            if t not in _HTML_ID:
                return None
            ids.append(_HTML_ID[t])
        i += 1
    ids.append(EOS_ID)
    return ids


def unitable_sample(rng: random.Random):
    """One teacher-forcing sample: (img uint8 (448, 448, 3), ids padded to
    TRAIN_STEPS with PAD, length), or None when over budget."""
    s = render_table(rng, wired=rng.random() < 0.5)
    h, w = s.img.shape[:2]
    ids = to_unitable_ids(s.tokens, s.cell_boxes, w, h)
    if ids is None or len(ids) > TRAIN_STEPS:
        return None
    img = resize_linear(s.img, IMG_SIZE, IMG_SIZE)
    tok = np.full((TRAIN_STEPS,), PAD_ID, np.int32)
    tok[: len(ids)] = ids
    return img, tok, len(ids)


def make_pool(n: int, seed: int = 0):
    rng = random.Random(seed)
    imgs = np.zeros((n, IMG_SIZE, IMG_SIZE, 3), np.uint8)
    toks = np.zeros((n, TRAIN_STEPS), np.int32)
    lens = np.zeros((n,), np.int32)
    i = 0
    while i < n:
        s = unitable_sample(rng)
        if s is None:
            continue
        imgs[i], toks[i], lens[i] = s
        i += 1
    return imgs, toks, lens


def decode_full(decoder: GPTFastDecoder, prev: torch.Tensor, mem_k, mem_v) -> torch.Tensor:
    """Teacher forcing: the decoder's cached step at position 0 over all
    of ``prev`` (B, T) with fresh zero caches of length T, one tensor a
    layer (so the pass backpropagates); float32 logits (B, T, vocab)."""
    cfg = decoder.cfg
    b, t = prev.shape
    shape = (b, t, cfg.heads, cfg.d_model // cfg.heads)
    caches_k = [mem_k.new_zeros(shape) for _ in range(cfg.layers)]
    caches_v = [mem_k.new_zeros(shape) for _ in range(cfg.layers)]
    return decoder(prev, caches_k, caches_v, 0, mem_k, mem_v, None).float()


def loss_fn(model: UniTableModel, x_u8: torch.Tensor, tok: torch.Tensor, lens: torch.Tensor,
            coins: torch.Tensor):
    """(loss, (structure CE, bbox CE, pass 1's (B, T) argmax stream)).
    ``coins`` (B, T) bool: where set, the second pass's previous token is
    the first pass's prediction."""
    dev = x_u8.device
    mean = torch.from_numpy(UNITABLE_MEAN).to(dev)
    std = torch.from_numpy(UNITABLE_STD).to(dev)
    x = (x_u8.float() / 255.0 - mean) / std
    memory = model.encoder(x.permute(0, 3, 1, 2))
    mem_k, mem_v = model.mem_proj(memory)
    tok = tok.long()
    B, T = tok.shape
    prefix = torch.full((B, 1), PREFIX_ID, dtype=torch.long, device=dev)
    prev = torch.cat([prefix, tok[:, :-1]], dim=1)
    with torch.no_grad():
        pred = torch.argmax(decode_full(model.decoder, prev, mem_k, mem_v), dim=-1)
    model_prev = torch.cat([prefix, pred[:, :-1]], dim=1)
    mixed = torch.where(coins, model_prev, prev)
    logits = decode_full(model.decoder, mixed, mem_k, mem_v)
    mask = (torch.arange(T, device=dev)[None, :] < lens[:, None]).float()
    is_bbox = (tok >= BBOX_BASE) & (tok < BBOX_BASE + N_BBOX_BINS)
    logp = F.log_softmax(logits, dim=-1)

    def nll(ids):
        return -torch.gather(logp, -1, ids[..., None])[..., 0]

    ce_hard = nll(tok)
    # bbox bins are ordinal: a one-bin miss is visually lossless, so 15 %
    # of the target mass goes onto each neighbouring bin
    lo = torch.clamp(tok - 1, min=BBOX_BASE)
    hi = torch.clamp(tok + 1, max=BBOX_BASE + N_BBOX_BINS - 1)
    ce_bbox = 0.7 * ce_hard + 0.15 * nll(lo) + 0.15 * nll(hi)
    ce = torch.where(is_bbox, ce_bbox, ce_hard)
    loss = (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    m_st = mask * (~is_bbox)
    m_bb = mask * is_bbox
    ce_st = (ce_hard * m_st).sum() / torch.clamp(m_st.sum(), min=1.0)
    ce_bb = (ce_hard * m_bb).sum() / torch.clamp(m_bb.sum(), min=1.0)
    return loss, (ce_st.detach(), ce_bb.detach(), pred)


def make_optimizer(model: torch.nn.Module, steps: int, lr: float = 2e-4) -> Adam:
    return adamw(list(model.parameters()), warmup_cosine_decay_schedule(
        0.0, lr, min(200, steps // 10), steps), weight_decay=1e-4, max_norm=1.0)


def train_step(model: UniTableModel, opt: Adam, *batch: torch.Tensor):
    """One step: forward, backward, the clip and AdamW's update; (loss,
    aux), detached."""
    opt.zero_grad()
    loss, aux = loss_fn(model, *batch)
    loss.backward()
    opt.step()
    return loss.detach(), aux


def new_model(seed: int = 0, dims: UniTableDims = DEMO_UNITABLE_DIMS) -> UniTableModel:
    model = UniTableModel(dims)
    init_params(model, torch.Generator().manual_seed(seed))
    return model


def train_unitable(steps: int = 12000, out_path=None, pool_n: int = 3072, batch: int = 8,
                   lr: float = 2e-4, seed: int = 0, variables: dict | None = None,
                   dims: UniTableDims | None = None, device=None) -> dict:
    """Train from a seeded init, or continue ``variables`` (flat
    ``encoder/params/…`` leaves). ``dims`` defaults to the checkpoint's
    (``dims_from_variables``), else ``DEMO_UNITABLE_DIMS``; pass
    ``UniTableDims()`` for the published 12 x 768 / 4 x 768 shape."""
    warm = variables is not None
    if dims is None:
        dims = dims_from_variables(variables) if warm else DEMO_UNITABLE_DIMS
    dev = resolve_device(device)
    model = new_model(seed, dims)
    if warm:
        load_flax_into(model, nest_models(variables))
    model.to(dev)
    opt = make_optimizer(model, steps, lr)

    def checkpoint() -> dict:
        return split_models(flax_variables(model))

    logger.info("rendering %d unitable tables", pool_n)
    pool = make_pool(pool_n, seed)
    nrng = np.random.default_rng(seed)
    tic = time.perf_counter()
    # a host thread re-renders random rows while the card trains: the ViT
    # memorizes a fixed pool
    with PoolRefresh(pool, unitable_sample, seed) as refresh:
        for i in range(steps):
            idx = nrng.integers(0, pool_n, batch)
            p = sampling_rate(i, steps, warm)
            coins = nrng.random((batch, TRAIN_STEPS)) < p
            xs = [torch.from_numpy(a).to(dev) for a in refresh.take(idx)]
            loss, aux = train_step(model, opt, *xs, torch.from_numpy(coins).to(dev))
            if i % 100 == 0 or i == steps - 1:
                logger.info("unitable step %d loss %.4f (st %.4f bb %.4f) p_ss %.2f "
                            "refreshed %d (%.1fs)", i, float(loss), float(aux[0]), float(aux[1]),
                            p, refresh.refreshed, time.perf_counter() - tic)
            if out_path is not None and i and i % 1000 == 0:
                save_variables(checkpoint(), out_path, half=True)
    variables = checkpoint()
    if out_path is not None:
        save_variables(variables, out_path, half=True)
        logger.info("unitable weights -> %s", out_path)
    return variables


def eval_unitable(variables: dict, n: int = 12, seed: int = 4444, device=None) -> dict:
    """Exact structure-token rate, TEDS-S and cell-box IoU through the
    production ``UniTableStructure`` (decode grammar, white-list, parse)."""
    from ..models.table.unitable import UniTableStructure
    from ..utils.teds import teds

    flat = flatten(variables)
    model = load_flax_into(UniTableModel(dims_from_variables(flat)), nest_models(flat))
    uni = UniTableStructure(model, device=device)
    rng = random.Random(seed)
    seq_ok = tried = 0
    ious, teds_scores = [], []
    while tried < n:
        s = render_table(rng, wired=rng.random() < 0.5)
        h, w = s.img.shape[:2]
        ids = to_unitable_ids(s.tokens, s.cell_boxes, w, h)
        if ids is None or len(ids) > TRAIN_STEPS:
            continue
        tried += 1
        (structure, bboxes), = uni([s.img])
        teds_scores.append(teds("<table>" + "".join(structure) + "</table>",
                                "<table>" + "".join(s.tokens) + "</table>", structure_only=True))
        seq_ok += structure == s.tokens
        ious += cell_ious(bboxes, s.cell_boxes)
    return {"seq_acc": seq_ok / n,
            "teds_s": float(np.mean(teds_scores)) if teds_scores else 0.0,
            "cell_iou": float(np.mean(ious)) if ious else 0.0}


if __name__ == "__main__":
    steps = int(sys.argv[1]) if len(sys.argv) > 1 else 3000
    out = sys.argv[2] if len(sys.argv) > 2 else None
    init = warm_start(out)
    # a warm continue defaults to a fresh pool seed
    seed = int(os.environ.get("RAPIDDOC_TRAIN_SEED", "17" if init is not None else "0"))
    v = train_unitable(steps, out, variables=init, seed=seed)
    logger.info("unitable eval: %s", eval_unitable(v))
