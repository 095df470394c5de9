"""UNITABLE wireless-table recognizer: ViT encoder + GPT-style AR decoder.

Port of ``rapiddoc_tpu/models/table/unitable.py``: ``TableVocab`` (:57),
``whitelist_mask`` (:91), ``UniTableEncoder`` (:101), ``UniTableDims``
and ``dims_from_variables`` (:137-204), ``FusedCachedAttention``
(:207), ``GPTFastDecoder`` (:241), ``GPTFastBlock`` (:280),
``unitable_decode`` (:312) and ``UniTableStructure`` (:368). The
decoder's cross-attention and memory projection are the formula
decoder's ``CrossAttention`` and ``MemoryProjector``.

Each crop is resized to 448x448 with ``resize_linear`` (cv2's
INTER_LINEAR); the device normalizes it with the published mean and
std in float32 and rounds it to bf16. LayerNorm eps is 1e-5 throughout
and GELU is exact. The decode runs every crop of a (4, 16)-row bucket
together over preallocated bf16 KV caches: logits in float32 plus the
whitelist mask, argmax, a fifth consecutive bbox token replaced by
``]</td>``, PAD after a row is done, and a stop when every row is done
or at ``max_len`` (on the card the test is read one step late,
``engine/done_flag.py``). The published vocab, ``unitable_vocab.json``
in the models dir (copied there by ``tools/convert_weights.py
unitable``), replaces the id -> token map as the JAX package reads it.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...engine.buckets import batch_chunks, pad_rows
from ...engine.done_flag import DoneFlag
from ...config import get_models_dir
from ...engine.session import resolve_device
from ..common.layers import TransformerBlock
from ..formula.decoder import CrossAttention, MemoryProjector, _attend, _scaled
from ..ocr.pre_post import resize_linear

IMG_SIZE = 448
PATCH = 16
MAX_SEQ_LEN = 1024
N_BBOX_BINS = IMG_SIZE + 1
LN_EPS = 1e-5

# published preprocessing stats (reference: unitable/pre_process.py:24-26)
UNITABLE_MEAN = np.array([0.86597056, 0.88463002, 0.87491087], np.float32)
UNITABLE_STD = np.array([0.20686628, 0.18201602, 0.18485524], np.float32)

# published vocab layout, reconstructed from the checkpoint constants
# (reference: unitable_modules.py TOKEN_WHITE_LIST = {1} + [12..509],
# consts.py HTML_BBOX_HTML_TOKENS order, eos=1 pad=2 prefix [html+bbox]=11)
HTML_TOKENS = [
    "<td></td>", "<td>[", "]</td>", "<td", ">[", "></td>",
    "<tr>", "</tr>", "<tbody>", "</tbody>", "<thead>", "</thead>",
    *[f' rowspan="{i}"' for i in range(2, 20)],
    *[f' colspan="{i}"' for i in range(2, 20)],
    ' colspan="25"',
]
EOS_ID = 1
PAD_ID = 2
PREFIX_ID = 11  # "[html+bbox]"
HTML_BASE = 12
BBOX_BASE = HTML_BASE + len(HTML_TOKENS)  # 61
VOCAB_SIZE = 960
BBOX_CLOSE_ID = HTML_BASE + HTML_TOKENS.index("]</td>")


class TableVocab:
    """id <-> token map of the published layout, or of ``vocab_path``:
    a JSON map of token -> id, or of id -> token, which replaces the
    whole map. A file that is neither (or does not parse) leaves the
    published layout in place, as in the JAX package."""

    def __init__(self, vocab_path: str | Path | None = None) -> None:
        self.id_to_token: dict[int, str] = {EOS_ID: "<eos>", PAD_ID: "<pad>",
                                            PREFIX_ID: "[html+bbox]"}
        for i, tok in enumerate(HTML_TOKENS):
            self.id_to_token[HTML_BASE + i] = tok
        for i in range(N_BBOX_BINS):
            self.id_to_token[BBOX_BASE + i] = f"bbox-{i}"
        if vocab_path is not None:
            try:
                data = json.loads(Path(vocab_path).read_text(encoding="utf-8"))
                if isinstance(data, dict):
                    if all(isinstance(v, int) for v in data.values()):
                        self.id_to_token = {v: k for k, v in data.items()}
                    else:
                        self.id_to_token = {int(k): v for k, v in data.items()}
            except (OSError, UnicodeDecodeError, ValueError, TypeError):
                pass

    def decode(self, ids: list[int]) -> list[str]:
        out = []
        for i in ids:
            tok = self.id_to_token.get(int(i), "")
            if tok == "<eos>":
                break
            if tok and not tok.startswith("[") and tok != "<pad>":
                out.append(tok)
        return out


def whitelist_mask() -> np.ndarray:
    """(vocab,) additive mask: 0 on allowed ids, -1e9 elsewhere
    (reference: GPTFastDecoder.forward black-list fill)."""
    mask = np.full((VOCAB_SIZE,), -1e9, np.float32)
    mask[EOS_ID] = 0.0
    mask[HTML_BASE : BBOX_BASE + N_BBOX_BINS] = 0.0
    return mask


@dataclass(frozen=True)
class UniTableDims:
    """Joint encoder+decoder dims. Defaults are the published checkpoint
    (12x768 encoder, 4x768 GPT decoder); the committed demo asset uses
    smaller dims, inferred back from its shapes by dims_from_variables.
    The instance is also the decoder's and the MemoryProjector's config
    (d_model, layers, heads, ffn, vocab_size, max_positions). Head dim
    is pinned at 64 (published 768/12)."""

    enc_d: int = 768
    enc_layers: int = 12
    dec_d: int = 768
    dec_layers: int = 4
    dec_ffn: int = 3072
    head_dim: int = 64
    vocab_size: int = VOCAB_SIZE
    max_positions: int = MAX_SEQ_LEN

    @property
    def enc_heads(self) -> int:
        return self.enc_d // self.head_dim

    @property
    def d_model(self) -> int:
        return self.dec_d

    @property
    def layers(self) -> int:
        return self.dec_layers

    @property
    def heads(self) -> int:
        return self.dec_d // self.head_dim

    @property
    def ffn(self) -> int:
        return self.dec_ffn


def dims_from_variables(flat: dict[str, np.ndarray]) -> UniTableDims:
    """UniTableDims from a checkpoint's flat ``encoder/…``,
    ``decoder/…`` leaves."""
    enc_blocks = {k.split("/")[2] for k in flat
                  if k.startswith("encoder/params/block")}
    dec_layers = {k.split("/")[2] for k in flat
                  if k.startswith("decoder/params/layer")}
    return UniTableDims(
        enc_d=int(flat["encoder/params/conv_proj/kernel"].shape[-1]),
        enc_layers=len(enc_blocks),
        dec_d=int(flat["decoder/params/token_embed/embedding"].shape[-1]),
        dec_layers=len(dec_layers),
        dec_ffn=int(flat["decoder/params/layer0/linear1/kernel"].shape[-1]),
    )


class UniTableEncoder(nn.Module):
    """Published encoder: conv patchify + learned pos + prenorm blocks."""

    def __init__(self, d_model: int = 768, layers: int = 12, heads: int = 12):
        super().__init__()
        self.layers = layers
        self.conv_proj = nn.Conv2d(3, d_model, PATCH, stride=PATCH)
        self.pos_embed = nn.Parameter(torch.zeros(MAX_SEQ_LEN, d_model))
        for i in range(layers):
            self.add_module(f"block{i}", TransformerBlock(
                d_model, heads, mlp_ratio=4.0, act="gelu", ln_eps=LN_EPS))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NCHW -> (B, S, d_model) tokens in the patch grid's row order."""
        x = self.conv_proj(x)
        tokens = x.flatten(2).transpose(1, 2)
        tokens = tokens + self.pos_embed[None, : tokens.shape[1]].to(tokens.dtype)
        for i in range(self.layers):
            tokens = getattr(self, f"block{i}")(tokens)
        return self.norm(tokens)


class FusedCachedAttention(nn.Module):
    """Self-attention with a fused QKV projection over an external KV
    cache (reference: unitable_modules.py Attention :806 — wqkv/wo)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.wqkv = nn.Linear(dim, 3 * dim)
        self.wo = nn.Linear(dim, dim)

    def forward(self, x, cache_k, cache_v, position: int, mask):
        """x (B, T, C); cache_k/v (B, S, H, hd), written in place at
        [position, position + T); mask (1, 1, T, S)."""
        b, t, c = x.shape
        hd = c // self.heads
        q, k, v = self.wqkv(x).split(c, dim=-1)
        q = _scaled(q.reshape(b, t, self.heads, hd), hd ** -0.5)
        cache_k[:, position:position + t] = k.reshape(b, t, self.heads, hd)
        cache_v[:, position:position + t] = v.reshape(b, t, self.heads, hd)
        return self.wo(_attend(q, cache_k, cache_v, mask))


class GPTFastBlock(nn.Module):
    def __init__(self, cfg: UniTableDims):
        super().__init__()
        d = cfg.d_model
        self.norm1 = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = FusedCachedAttention(d, cfg.heads)
        self.norm2 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn = CrossAttention(d, cfg.heads)
        self.norm3 = nn.LayerNorm(d, eps=LN_EPS)
        self.linear1 = nn.Linear(d, cfg.ffn)
        self.linear2 = nn.Linear(cfg.ffn, d)

    def forward(self, x, cache_k, cache_v, position, mask, mem_k, mem_v, mem_mask):
        x = x + self.self_attn(self.norm1(x), cache_k, cache_v, position, mask)
        x = x + self.cross_attn(self.norm2(x), mem_k, mem_v, mem_mask)
        return x + self.linear2(F.gelu(self.linear1(self.norm3(x))))


class GPTFastDecoder(nn.Module):
    """Published UNITABLE decoder (reference: unitable_modules.py:667-755):
    no embed scaling, no embedding or final LayerNorm, positions without
    offset, fused QKV, biased generator head."""

    def __init__(self, cfg: UniTableDims):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.pos_embed = nn.Parameter(torch.zeros(cfg.max_positions, cfg.d_model))
        for i in range(cfg.layers):
            self.add_module(f"layer{i}", GPTFastBlock(cfg))
        self.generator = nn.Linear(cfg.d_model, cfg.vocab_size)

    def forward(self, tokens, caches_k, caches_v, position: int, mem_k_layers,
                mem_v_layers, mem_mask):
        """tokens (B, T); caches (L, B, S, H, hd), written in place.
        Returns logits (B, T, vocab)."""
        t = tokens.shape[1]
        x = self.token_embed(tokens)
        x = x + self.pos_embed[position:position + t][None].to(x.dtype)
        s = caches_k.shape[2]
        key_pos = torch.arange(s, device=x.device)
        query_pos = position + torch.arange(t, device=x.device)
        mask = (key_pos[None, :] <= query_pos[:, None])[None, None]
        for i in range(self.cfg.layers):
            x = getattr(self, f"layer{i}")(
                x, caches_k[i], caches_v[i], position, mask,
                mem_k_layers[i], mem_v_layers[i], mem_mask,
            )
        return self.generator(x)


@torch.no_grad()
def unitable_decode(decoder: GPTFastDecoder, mem_proj: MemoryProjector,
                    memory: torch.Tensor, max_len: int):
    """Batched greedy decode with white-list masking and bbox-grammar
    forcing (reference: main.py:85-101 loop_decode — a 5th consecutive
    bbox token is replaced by ']</td>'). memory (B, S, d) in the compute
    dtype. The KV caches are bf16 in either compute dtype, as the JAX
    package's default ``dtype=jnp.bfloat16`` makes them: each step's K and
    V are rounded to bf16 when stored. Returns (tokens (B, max_len)
    int32, lengths (B,) int32, the steps the loop ran)."""
    cfg = decoder.cfg
    b, dev = memory.shape[0], memory.device
    hd = cfg.d_model // cfg.heads
    mem_k, mem_v = mem_proj(memory)
    wl = torch.from_numpy(whitelist_mask()).to(dev)
    caches_k = torch.zeros((cfg.layers, b, max_len, cfg.heads, hd), dtype=torch.bfloat16,
                           device=dev)
    caches_v = torch.zeros_like(caches_k)
    tokens = torch.full((b, max_len), PAD_ID, dtype=torch.int32, device=dev)
    cur = torch.full((b, 1), PREFIX_ID, dtype=torch.long, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    bbox_run = torch.zeros((b,), dtype=torch.int32, device=dev)
    pad = torch.tensor(PAD_ID, dtype=torch.long, device=dev)
    close = torch.tensor(BBOX_CLOSE_ID, dtype=torch.long, device=dev)
    flag = DoneFlag(dev)
    steps = 0
    for step in range(max_len):
        logits = decoder(cur, caches_k, caches_v, step, mem_k, mem_v, None)
        nxt = torch.argmax(logits[:, -1].float() + wl[None], dim=-1)
        is_bbox = (nxt >= BBOX_BASE) & (nxt < BBOX_BASE + N_BBOX_BINS)
        bbox_run = torch.where(is_bbox, bbox_run + 1, 0)
        force_close = bbox_run > 4
        nxt = torch.where(force_close, close, nxt)
        bbox_run = torch.where(force_close, 0, bbox_run)
        nxt = torch.where(done, pad, nxt)
        tokens[:, step] = nxt.to(torch.int32)
        lengths = torch.where(done, lengths, step + 1)
        done = done | (nxt == EOS_ID)
        cur = nxt[:, None]
        steps += 1
        if flag.finished(done):
            break
    return tokens, lengths, steps


class UniTableModel(nn.Module):
    """The checkpoint's ``encoder``, ``decoder`` and ``mem_proj`` as one
    torch module, named as the npz."""

    def __init__(self, dims: UniTableDims):
        super().__init__()
        self.encoder = UniTableEncoder(dims.enc_d, dims.enc_layers, dims.enc_heads)
        self.decoder = GPTFastDecoder(dims)
        self.mem_proj = MemoryProjector(dims)


class UniTableStructure:
    """imgs -> [(structure_tokens, cell bboxes in source px)]. ``model``
    with its weights loaded, on ``device`` (the card by default) in
    ``dtype`` (bf16 by default). ``calls`` counts decode dispatches,
    ``decode_steps`` the steps they ran."""

    name = "unitable"

    def __init__(self, model: UniTableModel, *, device=None,
                 dtype: torch.dtype | None = None):
        self.dims = model.decoder.cfg
        vocab = get_models_dir() / "unitable_vocab.json"
        self.vocab = TableVocab(vocab if vocab.is_file() else None)
        self.device = resolve_device(device)
        self.dtype = torch.bfloat16 if dtype is None else dtype
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        self._mean = torch.from_numpy(UNITABLE_MEAN).to(self.device)
        self._std = torch.from_numpy(UNITABLE_STD).to(self.device)
        self.calls = 0
        self.decode_steps = 0

    @torch.no_grad()
    def encode(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 (B, 448, 448, 3) on the device -> memory (B, S, d) in
        the compute dtype."""
        x = (images.float() / 255.0 - self._mean) / self._std
        return self.model.encoder(x.to(torch.bfloat16).to(self.dtype).permute(0, 3, 1, 2))

    def run(self, images: torch.Tensor, max_len: int):
        """One bucket: (tokens, lengths) on the device."""
        tokens, lengths, steps = unitable_decode(
            self.model.decoder, self.model.mem_proj, self.encode(images), max_len)
        self.calls += 1
        self.decode_steps += steps
        return tokens, lengths

    def __call__(
        self, imgs: list[np.ndarray], max_len: int = 256
    ) -> list[tuple[list[str], list[list[float]]]]:
        """Returns per-table (structure_tokens, cell bboxes in source px)."""
        if not imgs:
            return []
        all_imgs = np.stack([resize_linear(im, IMG_SIZE, IMG_SIZE) for im in imgs])
        parts = []
        for s, e, padded in batch_chunks(len(imgs), sizes=(4, 16)):
            batch = torch.from_numpy(pad_rows(all_imgs[s:e], padded)).to(self.device)
            t, l = (a.cpu().numpy() for a in self.run(batch, max_len))
            parts.append((t[: e - s], l[: e - s]))
        tokens = np.concatenate([p[0] for p in parts])
        lengths = np.concatenate([p[1] for p in parts])
        results = []
        for i, img in enumerate(imgs):
            toks = self.vocab.decode(tokens[i, : int(lengths[i])].tolist())
            results.append(self._parse(toks, img.shape[1], img.shape[0]))
        return results

    @staticmethod
    def _parse(
        toks: list[str], src_w: int, src_h: int
    ) -> tuple[list[str], list[list[float]]]:
        """html+bbox token stream -> (canonical structure tokens, xyxy cell
        boxes in source pixels), mirroring reference decode_tokens
        (main.py:103-151): every td contributes exactly one bbox (zeros
        when the model omitted coordinates)."""
        structure: list[str] = []
        bboxes: list[list[float]] = []
        sx, sy = src_w / IMG_SIZE, src_h / IMG_SIZE
        pending: list[int] = []
        in_cell = False
        attrs: list[str] = []

        def close_cell():
            nonlocal pending, in_cell, attrs
            if not in_cell:
                return
            if attrs:
                structure.append("<td")
                structure.extend(attrs)
                structure.append(">")
                structure.append("</td>")
            else:
                structure.append("<td></td>")
            if len(pending) == 4:
                x0, y0, x1, y1 = pending
                bboxes.append(
                    [x0 * sx, y0 * sy, x1 * sx, y1 * sy]
                )
            else:
                bboxes.append([0.0, 0.0, 0.0, 0.0])
            pending = []
            attrs = []
            in_cell = False

        for tok in toks:
            if tok.startswith("bbox-"):
                if in_cell and len(pending) < 4:
                    pending.append(int(tok[5:]))
            elif tok in ("<td>[", ">["):
                in_cell = True
            elif tok in ("]</td>", "></td>"):
                close_cell()
            elif tok == "<td></td>":
                in_cell = True
                close_cell()
            elif tok == "<td":
                in_cell = True
            elif tok.startswith(" rowspan") or tok.startswith(" colspan"):
                attrs.append(tok)
            elif tok in ("<tr>", "</tr>", "<thead>", "</thead>", "<tbody>",
                         "</tbody>"):
                close_cell()
                structure.append(tok)
        if in_cell:
            close_cell()
        return structure, bboxes
