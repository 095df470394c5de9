"""MBart-style causal decoder with KV-cached greedy decode.

Port of ``rapiddoc_tpu/models/formula/decoder.py:26-249``: pre-norm
layers, scaled embeddings, learned positions at offset 2, exact GELU,
LayerNorm eps 1e-6 (flax's default, not torch's 1e-5), a separate
``lm_head``, pad 1 and eos 2. The caches are preallocated
(L, B, max_len, H, hd) buffers in the compute dtype, written in place,
and attention runs over the whole static cache with a -1e9 mask, as in
the JAX package. ``greedy_decode`` is a Python loop over steps in place
of the ``lax.while_loop``.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ...engine import flops
from ...engine.done_flag import DoneFlag
from ...ops.quant_head import fused_argmax_int8

POS_OFFSET = 2  # MBart learned-position offset
LN_EPS = 1e-6  # flax nn.LayerNorm's default
MASKED = -1e9


class MBartConfig(NamedTuple):
    vocab_size: int = 50000
    d_model: int = 512
    layers: int = 6
    heads: int = 16
    ffn: int = 2048
    max_positions: int = 2560
    pad_token_id: int = 1
    bos_token_id: int = 0
    eos_token_id: int = 2


def _scaled(x: torch.Tensor, factor: float) -> torch.Tensor:
    """x * factor with the factor rounded to x's dtype first, as JAX
    multiplies a bf16 array by a scalar."""
    return x * torch.tensor(factor, dtype=x.dtype, device=x.device)


def _attend(q, k, v, mask) -> torch.Tensor:
    """q (B, T, H, hd), k/v (B, S, H, hd), mask (B or 1, 1, T or 1, S)
    bool -> (B, T, H*hd). Scores in the compute dtype, masked to -1e9,
    softmax in fp32, cast back."""
    attn = torch.einsum("bthd,bshd->bhts", q, k.to(q.dtype))
    if mask is not None:
        attn = attn.masked_fill(~mask, MASKED)
    attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhts,bshd->bthd", attn, v.to(q.dtype))
    return out.reshape(*out.shape[:2], -1)


class CachedAttention(nn.Module):
    """Self-attention over an externally managed KV cache."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, cache_k, cache_v, position: int, mask):
        """x (B, T, C) new tokens; cache_k/v (B, S, H, hd), updated in
        place at [position, position + T); mask (1, 1, T, S): key visible
        to query."""
        b, t, c = x.shape
        hd = c // self.heads
        q = _scaled(self.q_proj(x).reshape(b, t, self.heads, hd), hd ** -0.5)
        cache_k[:, position:position + t] = self.k_proj(x).reshape(b, t, self.heads, hd)
        cache_v[:, position:position + t] = self.v_proj(x).reshape(b, t, self.heads, hd)
        return self.out_proj(_attend(q, cache_k, cache_v, mask))


class CrossAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mem_k, mem_v, mem_mask=None):
        """mem_k/v: precomputed (B, S, H, hd); mem_mask (B, S) bool."""
        b, t, c = x.shape
        hd = c // self.heads
        q = _scaled(self.q_proj(x).reshape(b, t, self.heads, hd), hd ** -0.5)
        mask = None if mem_mask is None else mem_mask[:, None, None, :]
        return self.out_proj(_attend(q, mem_k, mem_v, mask))


class MBartDecoderLayer(nn.Module):
    def __init__(self, cfg: MBartConfig):
        super().__init__()
        d = cfg.d_model
        self.self_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.self_attn = CachedAttention(d, cfg.heads)
        self.encoder_attn_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.encoder_attn = CrossAttention(d, cfg.heads)
        self.final_layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.fc1 = nn.Linear(d, cfg.ffn)
        self.fc2 = nn.Linear(cfg.ffn, d)

    def forward(self, x, cache_k, cache_v, position, mask, mem_k, mem_v, mem_mask):
        x = x + self.self_attn(self.self_attn_layer_norm(x), cache_k, cache_v,
                               position, mask)
        x = x + self.encoder_attn(self.encoder_attn_layer_norm(x), mem_k, mem_v,
                                  mem_mask)
        h = F.gelu(self.fc1(self.final_layer_norm(x)))  # exact (erf) GELU
        return x + self.fc2(h)


class MBartDecoder(nn.Module):
    """Single-step (or multi-token) decoder forward over cached state."""

    def __init__(self, cfg: MBartConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.d_model
        self.embed_tokens = nn.Embedding(cfg.vocab_size, d)
        self.embed_positions = nn.Parameter(torch.zeros(cfg.max_positions + POS_OFFSET, d))
        self.layernorm_embedding = nn.LayerNorm(d, eps=LN_EPS)
        for i in range(cfg.layers):
            self.add_module(f"layer{i}", MBartDecoderLayer(cfg))
        self.layer_norm = nn.LayerNorm(d, eps=LN_EPS)
        self.lm_head = nn.Linear(d, cfg.vocab_size, bias=False)

    def forward(self, tokens, caches_k, caches_v, position: int, mem_k_layers,
                mem_v_layers, mem_mask, skip_lm_head: bool = False):
        """tokens (B, T) int; caches (L, B, S, H, hd), updated in place.
        Returns (logits (B, T, vocab), caches_k, caches_v). With
        ``skip_lm_head`` the first item is the hidden state after the
        final norm (B, T, d) instead: the int8 fused head
        (``ops/quant_head.py``) projects and argmaxes it without writing
        (B, vocab) logits."""
        c = self.cfg
        t = tokens.shape[1]
        emb = self.embed_tokens(tokens)
        emb = _scaled(emb, math.sqrt(c.d_model))
        pos = self.embed_positions[position + POS_OFFSET:position + POS_OFFSET + t]
        x = self.layernorm_embedding(emb + pos[None].to(emb.dtype))
        s = caches_k.shape[2]
        key_pos = torch.arange(s, device=x.device)
        query_pos = position + torch.arange(t, device=x.device)
        mask = (key_pos[None, :] <= query_pos[:, None])[None, None]
        for i in range(c.layers):
            x = getattr(self, f"layer{i}")(
                x, caches_k[i], caches_v[i], position, mask,
                mem_k_layers[i], mem_v_layers[i], mem_mask,
            )
        x = self.layer_norm(x)
        return (x if skip_lm_head else self.lm_head(x)), caches_k, caches_v


class MemoryProjector(nn.Module):
    """Precompute per-layer cross-attention K/V from encoder memory."""

    def __init__(self, cfg: MBartConfig):
        super().__init__()
        self.cfg = cfg
        for i in range(cfg.layers):
            self.add_module(f"layer{i}_k", nn.Linear(cfg.d_model, cfg.d_model))
            self.add_module(f"layer{i}_v", nn.Linear(cfg.d_model, cfg.d_model))

    def forward(self, memory: torch.Tensor):
        """memory (B, S, d_model) -> (L, B, S, H, hd) K and V stacks."""
        c = self.cfg
        b, s, _ = memory.shape
        hd = c.d_model // c.heads
        ks = [getattr(self, f"layer{i}_k")(memory).reshape(b, s, c.heads, hd)
              for i in range(c.layers)]
        vs = [getattr(self, f"layer{i}_v")(memory).reshape(b, s, c.heads, hd)
              for i in range(c.layers)]
        return torch.stack(ks), torch.stack(vs)


def greedy_decode(
    decoder: MBartDecoder,
    mem_proj: MemoryProjector,
    memory: torch.Tensor,
    mem_mask: torch.Tensor | None,
    max_len: int,
    int8_head: tuple[torch.Tensor, torch.Tensor] | None = None,
    argmax_int8: Callable = fused_argmax_int8,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Batched greedy AR decode with early exit.

    memory (B, S, d_model), in the compute dtype, which the caches take.
    Returns (tokens (B, max_len) int32, lengths (B,) int32, the number of
    steps the loop ran).

    ``int8_head=(wq int8 (d_model, vocab), scale (vocab,))`` replaces the
    lm_head matmul + argmax with ``argmax_int8`` (the fused int8 kernel's
    wrapper unless the caller passes another function of its signature,
    such as its plain version).

    Early exit. A row is done once it has emitted EOS; the loop stops
    when every row (padded rows included) is done, or at max_len. On the
    card ``DoneFlag`` reads the test one step late, and the loop may run
    one step more than the JAX loop: every row is done then, so it
    writes pad where pad already stands and leaves lengths as they are."""
    cfg = decoder.cfg
    b = memory.shape[0]
    hd = cfg.d_model // cfg.heads
    dev = memory.device
    mem_k, mem_v = mem_proj(memory)
    caches_k = torch.zeros((cfg.layers, b, max_len, cfg.heads, hd), dtype=memory.dtype, device=dev)
    caches_v = torch.zeros_like(caches_k)
    tokens = torch.full((b, max_len), cfg.pad_token_id, dtype=torch.int32, device=dev)
    cur = torch.full((b, 1), cfg.bos_token_id, dtype=torch.int32, device=dev)
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    lengths = torch.zeros((b,), dtype=torch.int32, device=dev)
    pad = torch.tensor(cfg.pad_token_id, dtype=torch.int32, device=dev)
    if int8_head is not None:
        wq_head, head_scale = int8_head
        head_bias = torch.zeros((cfg.vocab_size,), dtype=torch.float32, device=dev)
    flag = DoneFlag(dev)
    steps = 0
    for step in range(max_len):
        # a counting pass (engine/flops.py) takes the first step only, as
        # XLA counts the JAX loop's body once
        with flops.uncounted(step > 0):
            out, _, _ = decoder(cur, caches_k, caches_v, step, mem_k, mem_v, mem_mask,
                                skip_lm_head=int8_head is not None)
            if int8_head is not None:
                nxt, _conf = argmax_int8(out[:, -1], wq_head, head_scale, head_bias)
            else:
                nxt = torch.argmax(out[:, -1].float(), dim=-1)
        nxt = torch.where(done, pad, nxt.to(torch.int32))
        tokens[:, step] = nxt
        lengths = torch.where(done, lengths, step + 1)
        done = done | (nxt == cfg.eos_token_id)
        cur = nxt[:, None]
        steps += 1
        if flag.finished(done):
            break
    return tokens, lengths, steps
