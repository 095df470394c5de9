"""SLANet_plus wireless-table recognizer: LCNet CNN + GRU-attention AR head.

Port of ``rapiddoc_tpu/models/table/slanet.py``: ``SLANetBackbone``
(:82), ``PANNeck`` (:111), ``SLAHeadStep`` (:155), ``FeaKey`` (:189),
``sla_decode`` (:197) and ``SLANetStructure`` (:250). Each crop is
resized to fit 488 px with ``resize_linear`` (cv2's INTER_LINEAR) and
placed top-left on a black 488x488 canvas; the device normalizes it
with ImageNet's mean and std in float32, rounds it to bf16, runs the
backbone and neck in the compute dtype and decodes every crop of a
(4, 16)-row bucket together. Boxes come back as sigmoid quads
normalized to the resized region and are rescaled by ``488 / ratio``.

The decode keeps the JAX loop's semantics: a row that is done writes
``eos`` and a zero loc, its length stops at its eos, and the loop ends
when every row of the bucket is done or at 512 steps (on the card the
test is read one step late, ``engine/done_flag.py``). Softmax, argmax
and the loc head's sigmoid run in float32. flax's ``GRUCell`` is
torch's ``nn.GRUCell`` with the recurrent biases of r and z at zero
(``models/weights.py`` maps its gates). The neck's bottom-up chain
stops at the output level in eval mode: the JAX package computes one
more level, which nothing reads but whose batch statistics move in
training, so ``train()`` mode runs it too.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine import flops
from ...engine.buckets import batch_chunks, pad_rows
from ...engine.done_flag import DoneFlag
from ...engine.session import resolve_device
from ..common.layers import ConvBNAct, SqueezeExcite, upsample_nearest
from ..ocr.pre_post import resize_linear

IMG_SIZE = 488
MAX_STEPS = 512
LOC_REG = 8  # SLANet_plus regresses 4-point (8-coord) cell boxes

# Closed structure vocabulary (reference: table_structure_dict — merged
# no-span form per TableLabelDecode merge_no_span_structure, post_process.py).
STRUCT_TOKENS = [
    "<thead>", "</thead>", "<tbody>", "</tbody>", "<tr>", "</tr>",
    "<td></td>", "<td", ">", "</td>",
    *[f' rowspan="{i}"' for i in range(2, 21)],
    *[f' colspan="{i}"' for i in range(2, 21)],
]
TD_TOKENS = ("<td></td>", "<td")

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class SLANetVocab:
    def __init__(self) -> None:
        self.tokens = ["sos"] + STRUCT_TOKENS + ["eos"]
        self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        self.sos_id = 0
        self.eos_id = len(self.tokens) - 1

    def __len__(self) -> int:
        return len(self.tokens)


class LCNetBlock(nn.Module):
    """Depthwise-separable block (dw 3x3/5x5 + pw 1x1, hardswish, opt SE)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 1, kernel: int = 3,
                 use_se: bool = False):
        super().__init__()
        self.dw = ConvBNAct(in_ch, in_ch, kernel, stride, groups=in_ch, act="hardswish")
        self.se = SqueezeExcite(in_ch) if use_se else None
        self.pw = ConvBNAct(in_ch, out_ch, 1, 1, act="hardswish")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.dw(x)
        if self.se is not None:
            x = self.se(x)
        return self.pw(x)


class SLANetBackbone(nn.Module):
    """LCNet-style backbone: stride-4..32 pyramid (C2..C5), NCHW."""

    def __init__(self, scale: float = 1.0):
        super().__init__()

        def c(n: int) -> int:
            return max(16, int(n * scale) // 8 * 8)

        self.stem = ConvBNAct(3, c(16), 3, 2, act="hardswish")
        self.b1 = LCNetBlock(c(16), c(32), 1)
        self.b2a = LCNetBlock(c(32), c(64), 2)
        self.b2b = LCNetBlock(c(64), c(64), 1)
        self.b3a = LCNetBlock(c(64), c(128), 2)
        self.b3b = LCNetBlock(c(128), c(128), 1)
        self.b4a = LCNetBlock(c(128), c(256), 2, kernel=5)
        for name in "bcde":
            self.add_module(f"b4{name}", LCNetBlock(c(256), c(256), 1, kernel=5))
        self.b5a = LCNetBlock(c(256), c(512), 2, kernel=5, use_se=True)
        self.b5b = LCNetBlock(c(512), c(512), 1, kernel=5, use_se=True)
        self.channels = [c(64), c(128), c(256), c(512)]

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = self.b2b(self.b2a(self.b1(self.stem(x))))
        c2 = x
        x = self.b3b(self.b3a(x))
        c3 = x
        x = self.b4a(x)
        for name in "bcde":
            x = getattr(self, f"b4{name}")(x)
        c4 = x
        c5 = self.b5b(self.b5a(x))
        return [c2, c3, c4, c5]


class PANNeck(nn.Module):
    """Reduce the pyramid to ``out_ch``, top-down fuse, then a bottom-up
    strided chain to ``out_level`` (index into C2..C5)."""

    def __init__(self, in_channels: list[int], out_ch: int = 96, out_level: int = 2):
        super().__init__()
        self.out_level = out_level
        for i, cin in enumerate(in_channels):
            self.add_module(f"reduce{i}", ConvBNAct(cin, out_ch, 1, 1, act="hardswish"))
        for i in range(1, len(in_channels)):
            self.add_module(f"down{i}", ConvBNAct(out_ch, out_ch, 3, 2, act="hardswish"))
        self.out = ConvBNAct(out_ch, out_ch, 3, 1, act="hardswish")

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        reduced = [getattr(self, f"reduce{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(reduced) - 1, 0, -1):
            h, w = reduced[i - 1].shape[2:]
            reduced[i - 1] = reduced[i - 1] + upsample_nearest(reduced[i], 2)[:, :, :h, :w]
        x = out = reduced[0]
        # in train mode the chain runs to the last level, as flax does, so
        # that every batch norm's statistics move; its output is unused
        for i in range(1, len(reduced) if self.training else self.out_level + 1):
            h, w = reduced[i].shape[2:]
            x = getattr(self, f"down{i}")(x)[:, :, :h, :w] + reduced[i]
            if i == self.out_level:
                out = x
        return self.out(out)


class SLAHeadStep(nn.Module):
    """One GRU-attention decode step."""

    def __init__(self, vocab_size: int, hidden: int = 256, fea_ch: int = 96):
        super().__init__()
        self.hidden = hidden
        self.attn_hidden = nn.Linear(hidden, hidden, bias=False)
        self.attn_score = nn.Linear(hidden, 1)
        self.emb = nn.Embedding(vocab_size, hidden)
        self.gru = nn.GRUCell(fea_ch + hidden, hidden)
        self.struct_fc1 = nn.Linear(hidden, hidden)
        self.struct_fc2 = nn.Linear(hidden, vocab_size)
        self.loc_fc1 = nn.Linear(hidden + fea_ch, hidden)
        self.loc_fc2 = nn.Linear(hidden, LOC_REG)

    def forward(self, hidden, prev_tok, fea, fea_key):
        """hidden (B, H); prev_tok (B,); fea (B, S, C); fea_key (B, S, H),
        the precomputed projection of fea. Returns (new_hidden, logits,
        loc float32)."""
        score = self.attn_score(torch.tanh(fea_key + self.attn_hidden(hidden)[:, None]))
        alpha = torch.softmax(score.float(), dim=1).to(fea.dtype)
        context = (alpha * fea).sum(dim=1)
        emb = self.emb(prev_tok)
        new_h = self.gru(torch.cat([context.to(emb.dtype), emb], dim=-1), hidden)
        logits = self.struct_fc2(F.relu(self.struct_fc1(new_h)))
        loc_in = torch.cat([new_h, context.to(new_h.dtype)], dim=-1)
        loc = torch.sigmoid(self.loc_fc2(F.relu(self.loc_fc1(loc_in))).float())
        return new_h, logits, loc


class FeaKey(nn.Module):
    def __init__(self, fea_ch: int = 96, hidden: int = 256):
        super().__init__()
        self.proj = nn.Linear(fea_ch, hidden)

    def forward(self, fea: torch.Tensor) -> torch.Tensor:
        return self.proj(fea)


@torch.no_grad()
def sla_decode(step: SLAHeadStep, fea_key_mod: FeaKey, fea: torch.Tensor,
               sos_id: int, eos_id: int, max_steps: int):
    """AR structure decode: returns (token_ids (B, T) int32, locs (B, T,
    8) float32, lengths (B,) int32, the steps the loop ran). Stops when
    every table has emitted eos."""
    b, dev = fea.shape[0], fea.device
    fea_key = fea_key_mod(fea)
    hidden = torch.zeros((b, step.hidden), dtype=fea.dtype, device=dev)
    tokens = torch.full((b, max_steps), eos_id, dtype=torch.int32, device=dev)
    locs = torch.zeros((b, max_steps, LOC_REG), dtype=torch.float32, device=dev)
    cur = torch.full((b,), sos_id, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    eos = torch.tensor(eos_id, dtype=torch.long, device=dev)
    flag = DoneFlag(dev)
    steps = 0
    for i in range(max_steps):
        with flops.uncounted(i > 0):  # a counting pass takes the first step only
            hidden, logits, loc = step(hidden, cur, fea, fea_key)
        nxt = torch.where(done, eos, torch.argmax(logits.float(), dim=-1))
        tokens[:, i] = nxt.to(torch.int32)
        locs[:, i] = torch.where(done[:, None], 0.0, loc)
        lengths = torch.where(done, lengths, i + 1)
        done = done | (nxt == eos_id)
        cur = nxt
        steps += 1
        if flag.finished(done):
            break
    return tokens, locs, lengths, steps


@dataclass
class SLANetConfig:
    scale: float = 1.0
    neck_ch: int = 96
    hidden: int = 256
    max_steps: int = MAX_STEPS


class SLANetModel(nn.Module):
    """The four flax models of the checkpoint (``backbone``, ``neck``,
    ``fea_key``, ``step``) as one torch module, named as the npz."""

    def __init__(self, config: SLANetConfig, vocab_size: int):
        super().__init__()
        self.backbone = SLANetBackbone(config.scale)
        self.neck = PANNeck(self.backbone.channels, config.neck_ch)
        self.fea_key = FeaKey(config.neck_ch, config.hidden)
        self.step = SLAHeadStep(vocab_size, config.hidden, config.neck_ch)


class SLANetStructure:
    """488-fixed-shape SLANet_plus session: imgs -> [(structure_tokens,
    cell_bboxes_px)]. ``model`` with its weights loaded, on ``device``
    (the card by default) in ``dtype`` (bf16 by default). ``calls``
    counts decode dispatches, ``decode_steps`` the steps they ran."""

    name = "slanet"

    def __init__(self, model: SLANetModel, config: SLANetConfig | None = None, *,
                 device=None, dtype: torch.dtype | None = None):
        self.config = config or SLANetConfig()
        self.vocab = SLANetVocab()
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self._mean = torch.from_numpy(IMAGENET_MEAN).to(self.device)
        self._std = torch.from_numpy(IMAGENET_STD).to(self.device)
        self.calls = 0
        self.decode_steps = 0
        # per-step weight census for the AR accounting (engine/flops.py
        # track_ar_extra), over the JAX package's leaves ("step"): flax's
        # GRUCell has no hidden bias for its r and z gates, which torch's
        # GRUCell holds at zero
        step = self.model.step
        no_leaf = 2 * step.hidden
        self._step_params = float(sum(p.numel() for p in step.parameters()) - no_leaf)
        self._step_param_bytes = float(flops.nbytes(step)
                                       - no_leaf * step.gru.bias_hh.element_size())

    @staticmethod
    def preprocess(img: np.ndarray) -> np.ndarray:
        """uint8 padded canvas; normalization happens on device."""
        h, w = img.shape[:2]
        ratio = IMG_SIZE / max(h, w)
        rw, rh = max(1, int(w * ratio)), max(1, int(h * ratio))
        out = np.zeros((IMG_SIZE, IMG_SIZE, 3), np.uint8)
        out[:rh, :rw] = resize_linear(img, rw, rh)
        return out

    @torch.no_grad()
    def features(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 (B, 488, 488, 3) on the device -> (B, S, C) attention
        features in the compute dtype."""
        x = (images.float() / 255.0 - self._mean) / self._std
        x = x.to(torch.bfloat16).to(self.dtype).permute(0, 3, 1, 2)
        fea_map = self.model.neck(self.model.backbone(x))
        b, c, h, w = fea_map.shape
        return fea_map.permute(0, 2, 3, 1).reshape(b, h * w, c)

    def run(self, images: torch.Tensor):
        """One bucket: (tokens, locs, lengths) on the device."""
        tokens, locs, lengths, steps = sla_decode(
            self.model.step, self.model.fea_key, self.features(images),
            self.vocab.sos_id, self.vocab.eos_id, self.config.max_steps,
        )
        self.calls += 1
        self.decode_steps += steps
        return tokens, locs, lengths

    def __call__(
        self, imgs: list[np.ndarray], max_len: int | None = None
    ) -> list[tuple[list[str], list[list[float]]]]:
        if not imgs:
            return []
        all_imgs = np.stack([self.preprocess(im) for im in imgs])
        parts = []
        for s, e, padded in batch_chunks(len(imgs), sizes=(4, 16)):
            batch = torch.from_numpy(pad_rows(all_imgs[s:e], padded)).to(self.device)
            out = flops.track("table_slanet", self.run, (batch,),
                              sig=(tuple(batch.shape), str(batch.dtype), str(self.dtype)),
                              weights=self.model)
            t, l, n = (a.cpu().numpy() for a in out)
            flops.track_ar_extra("table_slanet", steps=float(n.max()), batch=int(t.shape[0]),
                                 dec_params=self._step_params,
                                 dec_param_bytes=self._step_param_bytes)
            parts.append((t[: e - s], l[: e - s], n[: e - s]))
        tokens = np.concatenate([p[0] for p in parts])
        locs = np.concatenate([p[1] for p in parts])
        lengths = np.concatenate([p[2] for p in parts])
        results = []
        for i, img in enumerate(imgs):
            n = int(lengths[i])
            structure: list[str] = []
            bboxes: list[list[float]] = []
            h, w = img.shape[:2]
            # boxes are sigmoid-normalized to the un-padded resized region
            ratio = IMG_SIZE / max(h, w)
            sx = IMG_SIZE / ratio
            sy = IMG_SIZE / ratio
            for t in range(n):
                tok_id = int(tokens[i, t])
                if tok_id in (self.vocab.sos_id, self.vocab.eos_id):
                    continue
                tok = self.vocab.tokens[tok_id]
                structure.append(tok)
                if tok in TD_TOKENS:
                    quad = locs[i, t]
                    xs = quad[0::2] * sx
                    ys = quad[1::2] * sy
                    bboxes.append(
                        [float(xs.min()), float(ys.min()),
                         float(xs.max()), float(ys.max())]
                    )
            results.append((structure, bboxes))
        return results
