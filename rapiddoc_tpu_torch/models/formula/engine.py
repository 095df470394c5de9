"""Formula recognition engine: crops -> LaTeX.

Port of ``rapiddoc_tpu/models/formula/engine.py:28-358``: crop margin,
UniMERNet normalization (mean .7931, std .1738), grey replicated to 3
channels, the smallest image bucket that fits, and a KV-cached greedy
decode per (image bucket, batch chunk). OpenCV's grey conversion and
INTER_LINEAR resize are the port's bit-equal numpy versions
(``models/ocr/pre_post.py``). The published checkpoint's ids are decoded
by ``FormulaTokenizer``, a replay of the HF ``tokenizers`` package
(``utils/hf_tokenizer.py``). Each dispatch is the program ``formula`` of
the FLOP accounting (``engine/flops.py``: one signature per image
bucket, batch and ``max_len``; the decode's realized steps through
``track_ar_extra``).
"""
from __future__ import annotations

import os
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ...engine import flops
from ...engine.buckets import batch_chunks, pad_rows
from ...engine.session import resolve_device
from ...ops.layout import aligned_rows
from ...ops.quant_head import fused_argmax_int8, quantize_weight_int8
from ...utils.hf_tokenizer import Tokenizer
from ..ocr.pre_post import resize_linear, rgb_to_gray
from ..weights import load_flax_into, random_init, subtree
from .decoder import greedy_decode
from .model import build_formula_modules

UNIMER_MEAN = 0.7931
UNIMER_STD = 0.1738

# (H, W) buckets — all /32-divisible
IMAGE_BUCKETS = [(96, 384), (128, 512), (192, 768), (192, 1024)]
LENGTH_BUCKETS = (256, 512, 1024, 2560)

# uint8 luma -> normalized value, computed in float32 in the JAX
# package's order ((u / 255 - mean) / std), so the device reads it
# bit for bit on any backend
_NORM_TABLE = (
    (np.arange(256, dtype=np.float32) / np.float32(255.0) - np.float32(UNIMER_MEAN))
    / np.float32(UNIMER_STD)
).astype(np.float32)


def crop_margin(img: np.ndarray, pad: int = 8) -> np.ndarray:
    """Trim uniform white margins around the formula."""
    gray = rgb_to_gray(img) if img.ndim == 3 else img
    mask = gray < 250
    if not mask.any():
        return img
    ys, xs = np.where(mask)
    y0, y1 = max(ys.min() - pad, 0), min(ys.max() + pad + 1, img.shape[0])
    x0, x1 = max(xs.min() - pad, 0), min(xs.max() + pad + 1, img.shape[1])
    return img[y0:y1, x0:x1]


def preprocess_formula(img: np.ndarray) -> tuple[np.ndarray, tuple[int, int]]:
    """uint8 RGB -> uint8 luminance bucket canvas; returns (array
    (bh, bw, 1), bucket_hw). Normalization and the 3-channel broadcast
    run on the device."""
    img = crop_margin(img)
    if img.ndim == 3:
        img = rgb_to_gray(img)
    h, w = img.shape[:2]
    # pick the smallest bucket that fits at uniform scale
    for bh, bw in IMAGE_BUCKETS:
        scale = min(bh / max(h, 1), bw / max(w, 1))
        if scale >= 1.0 or (bh, bw) == IMAGE_BUCKETS[-1]:
            break
    scale = min(bh / max(h, 1), bw / max(w, 1), 1.5)
    rh, rw = max(1, int(h * scale)), max(1, int(w * scale))
    resized = resize_linear(img, rw, rh)
    canvas = np.full((bh, bw), 255, np.uint8)
    canvas[:rh, :rw] = resized
    return canvas[..., None], (bh, bw)


def detokenize(tokens: list[str]) -> str:
    """Join demo tokens, with a space after a control word that a letter
    follows (copy of ``rapiddoc_tpu/train/formula.py:62``)."""
    out = []
    for i, t in enumerate(tokens):
        out.append(t)
        nxt = tokens[i + 1] if i + 1 < len(tokens) else ""
        if t.startswith("\\") and t[1:].isalpha() and (
            nxt[:1].isalpha() and not nxt.startswith("\\")
        ):
            out.append(" ")
    return "".join(out)


class DemoFormulaVocab:
    """Closed-token-list decoder for the demo checkpoint (the vocabulary
    ships in formula_demo.json next to the weights)."""

    def __init__(self, vocab: list[str]):
        self.vocab = vocab

    def decode(self, ids: list[int]) -> str:
        return detokenize([self.vocab[i] for i in ids if 3 <= i < len(self.vocab)])


class FormulaTokenizer:
    """UniMERNet-style tokenizer (HF tokenizers format): ids -> LaTeX, as
    ``rapiddoc_tpu/models/formula/engine.py:71-91``. A missing file
    decodes every sequence to "", as in the JAX package; a file that does
    not parse raises ValueError here (the JAX package logs a warning and
    decodes to "")."""

    def __init__(self, path: Path | None):
        self._tok = Tokenizer.from_file(path) if path is not None and path.is_file() else None

    def available(self) -> bool:
        return self._tok is not None

    def decode(self, ids: list[int]) -> str:
        if self._tok is None:
            return ""
        return fix_latex(self._tok.decode(ids, skip_special_tokens=True))


def fix_latex(text: str) -> str:
    """Post-decode LaTeX cleanup (spacing artifacts from BPE)."""
    text = text.replace("\\ ", "\\")
    text = re.sub(r"\\(?=[a-zA-Z])", r" \\", text)
    text = re.sub(r"\s+", " ", text).strip()
    # rebalance braces defensively
    opens, closes = text.count("{"), text.count("}")
    if opens > closes:
        text += "}" * (opens - closes)
    return text


@dataclass
class FormulaConfig:
    max_len: int = 2560
    vocab_size: int = 50000
    layers: int = 6
    backbone_size: str = "B6"
    out_index: int = 3  # backbone stage for memory (3=stride 32, 2=16)
    default_length_bucket: int = 256
    # published PP-FormulaNet_plus-M decoder dims
    d_model: int = 512
    ffn: int = 2048
    heads: int = 16


@dataclass
class FormulaStats:
    """Counts since the recognizer was built: decode dispatches, the
    steps their loops ran, and the steps the JAX package's loop would
    have run (the largest length of each dispatch's padded batch)."""

    dispatches: int = 0
    decode_steps: int = 0
    realized_steps: int = 0


class FormulaRecognizer:
    """``variables`` is a flat ``encoder/…``, ``decoder/…``,
    ``mem_proj/…`` dict of flax leaves (the layout of the demo npz);
    a missing model is random-init from ``seed``. Runs on ``device``
    (the card by default) in ``dtype`` (bf16 by default). ``int8_head``
    None reads ``RAPIDDOC_INT8_HEAD`` at decode time, as the JAX package
    does; a bool wins over it. With the int8 head on, each decode step's
    head goes through ``argmax_int8`` (the K2 kernel's wrapper)."""

    def __init__(self, variables: dict[str, np.ndarray] | None = None,
                 config: FormulaConfig | None = None, seed: int = 0,
                 device: str | torch.device | None = None,
                 dtype: torch.dtype | None = None,
                 int8_head: bool | None = None):
        self.device = resolve_device(device)
        self.config = config or FormulaConfig()
        cfg = self.config
        self.encoder, self.decoder, self.mem_proj, self.mbart_cfg = build_formula_modules(
            max_len=cfg.max_len, vocab_size=cfg.vocab_size, layers=cfg.layers,
            backbone_size=cfg.backbone_size, out_index=cfg.out_index,
            d_model=cfg.d_model, ffn=cfg.ffn, heads=cfg.heads,
        )
        rng = np.random.default_rng(seed)
        for name in ("encoder", "decoder", "mem_proj"):
            module = getattr(self, name)
            flat = subtree(variables or {}, name)
            if flat:
                load_flax_into(module, flat)
            else:
                random_init(module, rng)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        for name in ("encoder", "decoder", "mem_proj"):
            getattr(self, name).to(device=self.device, dtype=self.dtype).eval()
        self._norm_table = torch.from_numpy(_NORM_TABLE).to(self.device)
        self.int8_head = int8_head
        self.argmax_int8: Callable = fused_argmax_int8
        self.tokenizer: DemoFormulaVocab | FormulaTokenizer | None = None
        self.stats = FormulaStats()
        self._int8_head_cache: tuple[torch.Tensor, torch.Tensor] | None = None
        # decoder weight census for the AR accounting (engine/flops.py
        # track_ar_extra), over the JAX package's leaves ("decoder"): per
        # decode step every decoder weight is read once and contributes
        # about 2 FLOPs per sample
        self._dec_params = float(sum(p.numel() for p in self.decoder.parameters()))
        self._dec_param_bytes = float(flops.nbytes(self.decoder))

    def _int8_head(self) -> tuple[torch.Tensor, torch.Tensor] | None:
        """The committed lm_head (rounded to the compute dtype), quantized
        to int8 once, its rows 16-byte aligned for the kernel's copies;
        None while the int8 head is off."""
        on = self.int8_head
        if on is None:
            on = bool(os.environ.get("RAPIDDOC_INT8_HEAD"))
        if not on:
            return None
        if self._int8_head_cache is None:
            w = self.decoder.lm_head.weight.detach().float().t().contiguous()
            wq, scale = quantize_weight_int8(w)
            self._int8_head_cache = (aligned_rows(wq), scale)
        return self._int8_head_cache

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 luma (B, H, W, 1) on the device -> memory (B, S, d_model)
        in the compute dtype."""
        x = self._norm_table[images.long()]
        x = x.expand(*x.shape[:-1], 3)
        return self.encoder(x.to(self.dtype))

    @torch.no_grad()
    def decode(self, memory: torch.Tensor, max_len: int):
        """-> (tokens (B, max_len), lengths (B,)) on the device."""
        tokens, lengths, steps = greedy_decode(
            self.decoder, self.mem_proj, memory, None, max_len,
            int8_head=self._int8_head(), argmax_int8=self.argmax_int8,
        )
        self.stats.dispatches += 1
        self.stats.decode_steps += steps
        return tokens, lengths

    def _encode_decode(self, batch: np.ndarray, max_len: int):
        return self.decode(self.encode(self.to_device(batch)), max_len)

    def to_device(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type == "cuda":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    @staticmethod
    def chunks(crops: list[np.ndarray]) -> list[tuple[list[int], np.ndarray]]:
        """The dispatch plan of ``batch_predict``: crops grouped by image
        bucket, each group cut into chunks padded (by repeating the last
        row) to 4 or 16 rows. Returns (crop indices, uint8 batch) pairs."""
        groups: dict[tuple[int, int], list[int]] = {}
        prepped: list[np.ndarray] = []
        for i, crop in enumerate(crops):
            x, bucket = preprocess_formula(crop)
            prepped.append(x)
            groups.setdefault(bucket, []).append(i)
        plan = []
        for idxs in groups.values():
            for s, e, padded in batch_chunks(len(idxs), sizes=(4, 16)):
                plan.append((idxs[s:e], pad_rows(np.stack([prepped[i] for i in idxs[s:e]]), padded)))
        return plan

    def batch_predict(self, crops: list[np.ndarray], length_bucket: int | None = None,
                      return_ids: bool = False) -> list:
        """LaTeX per crop; with return_ids, the raw token-id lists instead
        (before detokenizing). Crops are grouped by image bucket and cut
        into chunks padded to 4 or 16 rows; every chunk is dispatched
        before any result is fetched."""
        if not crops:
            return []
        max_len = length_bucket or self.config.default_length_bucket
        handles = []
        weights = (self.encoder, self.decoder, self.mem_proj)
        for idxs, batch in self.chunks(crops):
            handles.append((idxs, flops.track(
                "formula", self._encode_decode, (batch, max_len),
                sig=(batch.shape, str(batch.dtype), max_len, str(self.dtype)),
                weights=weights)))
        out: list = [""] * len(crops)
        eos = self.mbart_cfg.eos_token_id
        for idxs, (tokens, lengths) in handles:
            tokens = tokens.cpu().numpy()
            lengths = lengths.cpu().numpy()
            self.stats.realized_steps += int(lengths.max())
            flops.track_ar_extra("formula", steps=float(lengths.max()),
                                 batch=int(tokens.shape[0]), dec_params=self._dec_params,
                                 dec_param_bytes=self._dec_param_bytes)
            for j, i in enumerate(idxs):
                n_tok = int(lengths[j])
                # strip the terminator only when one was emitted: a decode
                # that exhausts the length budget ends on a real token
                if n_tok > 0 and int(tokens[j, n_tok - 1]) == eos:
                    n_tok -= 1
                ids = tokens[j, :n_tok].tolist()
                if return_ids:
                    out[i] = ids
                else:
                    out[i] = self.tokenizer.decode(ids) if self.tokenizer else ""
        return out
