"""RT-DETR layout detector in PyTorch (PP-DocLayout family).

Port of ``rapiddoc_tpu/models/layout/rtdetr.py``: ``sincos_pos_embed_2d``
(:26), ``inverse_sigmoid`` (:41), ``MLP`` (:46),
``TransformerEncoderLayer`` (:60), ``RepBlock`` (:78), ``CSPRepLayer``
(:88), ``HybridEncoder`` (:101), ``ms_deform_sample`` (:155),
``MSDeformAttn`` (:216), ``DecoderLayer`` (:266) and ``RTDETR`` (:290)
with its mask branch, bit-packed on the device. Parameter names follow
the flax module tree, so ``models/weights.py`` carries a flax checkpoint
over by name.

What the JAX package's numbers depend on, kept here:

- flax's defaults: LayerNorm eps 1e-6; ``MultiHeadDotProductAttention``
  keeps its q/k/v kernels as (C, heads, head_dim) and its output kernel
  as (heads, head_dim, C) (``DenseGeneral`` below holds them as stored)
  and divides q by sqrt(head_dim), in the compute dtype, before the
  product;
- its dtypes in bf16: the anchors are rounded to bf16 before they go back
  to float32; the encoder's scores and boxes, every box refinement and
  the deformable sampling locations are float32; the sampled values,
  their sum and the cross-attention's output projection are float32
  (bf16 times float32 promotes, and flax's Dense computes in the
  promoted type with its bf16 weights upcast), and the LayerNorm after
  it returns to bf16;
- ``ms_deform_sample`` is not ``grid_sample``: each corner index is
  clamped into range and a sample is zeroed only when its location is
  outside [-1, W] x [-1, H], so it is written with gathers;
- query selection takes the top scores with ties to the lower index
  (``jax.lax.top_k``): a stable descending sort.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..common.layers import ConvBNAct, upsample_nearest
from .hgnet import PPHGNetV2

LN_EPS = 1e-6  # flax nn.LayerNorm


# ----------------------------------------------------------------- helpers

def sincos_pos_embed_2d(h: int, w: int, dim: int, temperature: float = 10000.0,
                        device=None) -> torch.Tensor:
    """2D sine-cosine positional embedding, (h*w, dim), float32."""
    gh, gw = torch.meshgrid(
        torch.arange(h, dtype=torch.float32, device=device),
        torch.arange(w, dtype=torch.float32, device=device), indexing="ij",
    )
    pos_dim = dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = gw.reshape(-1)[:, None] * omega[None]
    out_h = gh.reshape(-1)[:, None] * omega[None]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def _linear(x: torch.Tensor, layer: nn.Linear) -> torch.Tensor:
    """``layer(x)`` in the promoted dtype of x and the weights, as flax's
    Dense computes it."""
    dtype = torch.promote_types(x.dtype, layer.weight.dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        self.n = layers
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"fc{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n - 1):
            x = F.relu(getattr(self, f"fc{i}")(x))
        return getattr(self, f"fc{self.n - 1}")(x)


class DenseGeneral(nn.Module):
    """flax ``DenseGeneral`` of a multi-head attention: ``kernel`` as
    flax stores it, (C, heads, head_dim) for the q/k/v projections and
    (heads, head_dim, C) for the output."""

    def __init__(self, kernel_shape: tuple[int, ...], bias_shape: tuple[int, ...]):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(kernel_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kernel.dim() == 3 and self.bias.dim() == 2:  # C -> (heads, head_dim)
            return torch.einsum("blc,chd->blhd", x, self.kernel) + self.bias
        return torch.einsum("blhd,hdc->blc", x, self.kernel) + self.bias


class MultiHeadAttention(nn.Module):
    """flax ``nn.MultiHeadDotProductAttention`` (qkv_features = dim)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        hd = dim // heads
        self.head_dim = hd
        self.query = DenseGeneral((dim, heads, hd), (heads, hd))
        self.key = DenseGeneral((dim, heads, hd), (heads, hd))
        self.value = DenseGeneral((dim, heads, hd), (heads, hd))
        self.out = DenseGeneral((heads, hd, dim), (dim,))

    def forward(self, q_in: torch.Tensor, k_in: torch.Tensor, v_in: torch.Tensor) -> torch.Tensor:
        q = self.query(q_in)
        k = self.key(k_in)
        v = self.value(v_in)
        q = q / torch.tensor(math.sqrt(self.head_dim), dtype=q.dtype, device=q.device)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        w = torch.softmax(w, dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v))


# ------------------------------------------------------------ hybrid encoder

class TransformerEncoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, ffn: int = 1024):
        super().__init__()
        self.attn = MultiHeadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, ffn)
        self.fc2 = nn.Linear(ffn, dim)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        q = x + pos
        x = self.norm1(x + self.attn(q, q, x))
        h = self.fc2(F.gelu(self.fc1(x)))
        return self.norm2(x + h)


class RepBlock(nn.Module):
    """Inference-fused RepVGG-style 3x3 conv block (conv+BN+SiLU)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv = ConvBNAct(features, features, 3, act="silu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class CSPRepLayer(nn.Module):
    def __init__(self, in_channels: int, features: int, num_blocks: int = 3):
        super().__init__()
        self.num_blocks = num_blocks
        self.conv1 = ConvBNAct(in_channels, features, 1, act="silu")
        self.conv2 = ConvBNAct(in_channels, features, 1, act="silu")
        for i in range(num_blocks):
            self.add_module(f"bottleneck{i}", RepBlock(features))
        self.conv3 = ConvBNAct(features, features, 1, act="silu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.conv1(x)
        b = self.conv2(x)
        for i in range(self.num_blocks):
            a = getattr(self, f"bottleneck{i}")(a)
        return self.conv3(a + b)


class HybridEncoder(nn.Module):
    """AIFI on the stride-32 level + CCFF cross-scale fusion; NCHW."""

    def __init__(self, in_channels: list[int], dim: int = 256, heads: int = 8,
                 ffn: int = 1024, csp_blocks: int = 3):
        super().__init__()
        self.dim = dim
        self.n = n = len(in_channels)
        for i, c in enumerate(in_channels):
            self.add_module(f"input_proj{i}", ConvBNAct(c, dim, 1, act=None))
        self.aifi = TransformerEncoderLayer(dim, heads, ffn)
        for i in range(n - 1):
            self.add_module(f"lateral{i}", ConvBNAct(dim, dim, 1, act="silu"))
            self.add_module(f"fpn_block{i}", CSPRepLayer(2 * dim, dim, csp_blocks))
            self.add_module(f"downsample{i}", ConvBNAct(dim, dim, 3, strides=2, act="silu"))
            self.add_module(f"pan_block{i}", CSPRepLayer(2 * dim, dim, csp_blocks))

    def forward(self, feats: list[torch.Tensor]) -> list[torch.Tensor]:
        proj = [getattr(self, f"input_proj{i}")(f) for i, f in enumerate(feats)]
        c5 = proj[-1]
        b, c, h, w = c5.shape
        tokens = c5.flatten(2).transpose(1, 2)
        pos = sincos_pos_embed_2d(h, w, self.dim, device=c5.device).to(tokens.dtype)[None]
        tokens = self.aifi(tokens, pos)
        proj[-1] = tokens.transpose(1, 2).reshape(b, c, h, w)
        inner = [None] * self.n
        inner[-1] = proj[-1]
        for i in range(self.n - 2, -1, -1):
            upper = getattr(self, f"lateral{i}")(inner[i + 1])
            merged = torch.cat([upsample_nearest(upper, 2), proj[i]], dim=1)
            inner[i] = getattr(self, f"fpn_block{i}")(merged)
            inner[i + 1] = upper  # RT-DETR keeps the lateral as the new level
        outs = [inner[0]]
        for i in range(self.n - 1):
            down = getattr(self, f"downsample{i}")(outs[-1])
            merged = torch.cat([down, inner[i + 1]], dim=1)
            outs.append(getattr(self, f"pan_block{i}")(merged))
        return outs


# ------------------------------------------------- deformable attention

def ms_deform_sample(
    values: list[torch.Tensor],
    sampling_locs: torch.Tensor,
    attn_weights: torch.Tensor,
) -> torch.Tensor:
    """Multi-scale deformable attention aggregation, as the JAX package
    computes it.

    values: per-level (B, H_l, W_l, heads, head_dim)
    sampling_locs: (B, Nq, heads, L, P, 2) in [0,1] normalized coords (x, y)
    attn_weights: (B, Nq, heads, L, P)
    returns (B, Nq, heads*head_dim) in the promoted dtype of the three
    """
    B, Nq, H, L, P, _ = sampling_locs.shape
    head_dim = values[0].shape[-1]
    dtype = torch.promote_types(
        torch.promote_types(values[0].dtype, sampling_locs.dtype), attn_weights.dtype
    )
    out = torch.zeros((B, Nq, H, head_dim), dtype=dtype, device=values[0].device)
    head_ids = torch.arange(H, device=values[0].device)[None, None, :, None]
    for lvl, val in enumerate(values):
        _, Hl, Wl, _, _ = val.shape
        loc = sampling_locs[:, :, :, lvl]  # (B, Nq, H, P, 2)
        x = loc[..., 0] * Wl - 0.5
        y = loc[..., 1] * Hl - 0.5
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        wx = (x - x0)[..., None]
        wy = (y - y0)[..., None]
        flat = val.reshape(B, Hl * Wl * H, head_dim)

        def gather(ix: torch.Tensor, iy: torch.Tensor) -> torch.Tensor:
            ixc = ix.to(torch.int64).clamp(0, Wl - 1)
            iyc = iy.to(torch.int64).clamp(0, Hl - 1)
            idx = ((iyc * Wl + ixc) * H + head_ids).reshape(B, -1, 1)
            g = torch.gather(flat, 1, idx.expand(-1, -1, head_dim))
            return g.reshape(B, Nq, H, P, head_dim)

        sampled = (
            gather(x0, y0) * (1 - wx) * (1 - wy)
            + gather(x0 + 1, y0) * wx * (1 - wy)
            + gather(x0, y0 + 1) * (1 - wx) * wy
            + gather(x0 + 1, y0 + 1) * wx * wy
        )
        valid = ((x >= -1) & (x <= Wl) & (y >= -1) & (y <= Hl))[..., None]
        sampled = sampled * valid.to(sampled.dtype)
        w = attn_weights[:, :, :, lvl][..., None]
        out = out + (sampled * w).sum(dim=3)
    return out.reshape(B, Nq, H * head_dim)


class MSDeformAttn(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, levels: int = 3, points: int = 4):
        super().__init__()
        self.dim, self.heads, self.levels, self.points = dim, heads, levels, points
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, ref_points: torch.Tensor,
                value_levels: list[torch.Tensor]) -> torch.Tensor:
        """query (B, Nq, C); ref_points (B, Nq, 2 or 4), float32;
        value_levels per level (B, H, W, C)."""
        B, Nq, _ = query.shape
        hd = self.dim // self.heads
        values = [self.value_proj(v).reshape(*v.shape[:3], self.heads, hd)
                  for v in value_levels]
        offsets = self.sampling_offsets(query).reshape(
            B, Nq, self.heads, self.levels, self.points, 2)
        attn = self.attention_weights(query).reshape(
            B, Nq, self.heads, self.levels * self.points)
        attn = torch.softmax(attn.float(), dim=-1).to(query.dtype)
        attn = attn.reshape(B, Nq, self.heads, self.levels, self.points)
        if ref_points.shape[-1] == 4:
            center = ref_points[..., :2]
            wh = ref_points[..., 2:]
            locs = (center[:, :, None, None, None, :]
                    + offsets / self.points * wh[:, :, None, None, None, :] * 0.5)
        else:
            shapes = torch.tensor([[v.shape[2], v.shape[1]] for v in value_levels],
                                  dtype=query.dtype, device=query.device)
            locs = ref_points[:, :, None, None, None, :] + offsets / shapes[None, None, None, :, None, :]
        out = ms_deform_sample(values, locs, attn)
        return _linear(out, self.output_proj)


class DecoderLayer(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, ffn: int = 1024,
                 levels: int = 3, points: int = 4):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim, heads)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(dim, heads, levels, points)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.fc1 = nn.Linear(dim, ffn)
        self.fc2 = nn.Linear(ffn, dim)
        self.norm3 = nn.LayerNorm(dim, eps=LN_EPS)

    def forward(self, tgt, query_pos, ref_points, value_levels):
        q = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt))
        cross = self.cross_attn(tgt + query_pos, ref_points, value_levels)
        dtype = tgt.dtype
        tgt = _layer_norm(self.norm2, tgt + cross).to(dtype)
        h = self.fc2(F.relu(self.fc1(tgt)))
        return self.norm3(tgt + h)


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln(x)`` in x's dtype, whatever the dtype of ln's parameters."""
    return F.layer_norm(x, ln.normalized_shape, ln.weight.to(x.dtype),
                        ln.bias.to(x.dtype), ln.eps)


class RTDETR(nn.Module):
    """Full detector. Input NHWC in [0,1]; output dict with per-query
    scores/labels/boxes (cxcywh normalized, float32), in score order.

    ``aux`` (training) also returns each decoder layer's logits and boxes
    (``aux_logits`` (L, B, Nq, C), ``aux_boxes``) and the encoder's
    query-selection head at the top-k queries (``enc_logits``,
    ``enc_boxes``): the DETR auxiliary losses. The selected queries and
    each layer's boxes but the last are detached, as the JAX model stops
    their gradients; no parameter is added."""

    def __init__(self, num_classes: int = 25, backbone_size: str = "B4", dim: int = 256,
                 num_queries: int = 300, dec_layers: int = 6, heads: int = 8,
                 ffn: int = 1024, points: int = 4, with_masks: bool = False,
                 mask_dim: int = 32, aux: bool = False):
        super().__init__()
        self.num_queries = num_queries
        self.dec_layers = dec_layers
        self.with_masks = with_masks
        self.aux = aux
        self.backbone = PPHGNetV2(backbone_size)
        chans = PPHGNetV2.out_channels(backbone_size)
        self.encoder = HybridEncoder(chans, dim, heads, ffn)
        levels = len(chans)
        self.enc_proj = nn.Linear(dim, dim)
        self.enc_norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.enc_score_head = nn.Linear(dim, num_classes)
        self.enc_bbox_head = MLP(dim, dim, 4)
        self.query_pos_head = MLP(4, dim * 2, dim)
        self.class_head = nn.Linear(dim, num_classes)
        for i in range(dec_layers):
            self.add_module(f"decoder{i}", DecoderLayer(dim, heads, ffn, levels, points))
            self.add_module(f"bbox_head{i}", MLP(dim, dim, 4))
        if with_masks:
            self.mask_pixel_proj = nn.Conv2d(dim, mask_dim, 3, padding=1)
            self.mask_embed_head = MLP(dim, dim, mask_dim)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        feats = self.backbone(x)
        levels = self.encoder([f.permute(0, 3, 1, 2) for f in feats])
        B = x.shape[0]
        memories, anchors = [], []
        for lvl, f in enumerate(levels):
            _, c, h, w = f.shape
            memories.append(f.flatten(2).transpose(1, 2))
            gy, gx = torch.meshgrid(
                (torch.arange(h, dtype=torch.float32, device=x.device) + 0.5) / h,
                (torch.arange(w, dtype=torch.float32, device=x.device) + 0.5) / w,
                indexing="ij",
            )
            wh = torch.full((h * w, 2), 0.05 * (2.0 ** lvl), dtype=torch.float32, device=x.device)
            anchors.append(torch.cat([gx.reshape(-1, 1), gy.reshape(-1, 1), wh], dim=1))
        memory = torch.cat(memories, dim=1)
        anchor = torch.cat(anchors, dim=0)[None].expand(B, -1, -1).to(memory.dtype)

        enc_feat = self.enc_norm(self.enc_proj(memory))
        enc_logits = self.enc_score_head(enc_feat)
        enc_boxes = torch.sigmoid(
            self.enc_bbox_head(enc_feat).float() + inverse_sigmoid(anchor.float()))
        enc_scores = torch.sigmoid(enc_logits.float()).amax(dim=-1)
        topk = torch.sort(enc_scores, dim=1, descending=True, stable=True)[1][:, : self.num_queries]
        ref = torch.gather(enc_boxes, 1, topk[..., None].expand(-1, -1, 4))
        tgt = torch.gather(enc_feat, 1, topk[..., None].expand(-1, -1, enc_feat.shape[-1]))
        tgt, ref = tgt.detach(), ref.detach()

        value_levels = [f.permute(0, 2, 3, 1) for f in levels]
        aux_feats, aux_boxes = [], []
        for i in range(self.dec_layers):
            query_pos = self.query_pos_head(ref.to(tgt.dtype))
            tgt = getattr(self, f"decoder{i}")(tgt, query_pos, ref, value_levels)
            delta = getattr(self, f"bbox_head{i}")(tgt)
            ref = torch.sigmoid(delta.float() + inverse_sigmoid(ref.float()))
            if self.aux:
                aux_feats.append(tgt)
                aux_boxes.append(ref)
            if i < self.dec_layers - 1:
                ref = ref.detach()

        logits = self.class_head(tgt)
        probs = torch.sigmoid(logits.float())
        scores, labels = probs.max(dim=-1)
        out = {"scores": scores, "labels": labels, "boxes": ref}
        if self.aux:
            out["aux_logits"] = torch.stack([self.class_head(f) for f in aux_feats])
            out["aux_boxes"] = torch.stack(aux_boxes)
            idx = topk[..., None]
            out["enc_logits"] = torch.gather(enc_logits, 1, idx.expand(-1, -1, enc_logits.shape[-1]))
            out["enc_boxes"] = torch.gather(enc_boxes, 1, idx.expand(-1, -1, 4))
        if self.with_masks:
            pix = self.mask_pixel_proj(levels[0])  # (B, mask_dim, h, w)
            q_emb = self.mask_embed_head(tgt)
            mask_logits = torch.einsum("bqc,bchw->bqhw", q_emb, pix.to(q_emb.dtype))
            out["masks_bits"] = pack_mask_bits(mask_logits > 0)
        return out


def pack_mask_bits(bits: torch.Tensor) -> torch.Tensor:
    """(B, Nq, H, W) bool -> (B, Nq, H, ceil(W/8)) uint8, MSB first, the
    width padded with zeros to a multiple of 8."""
    pad_w = (-bits.shape[-1]) % 8
    b = bits.to(torch.uint8)
    if pad_w:
        b = F.pad(b, (0, pad_w))
    b = b.reshape(*b.shape[:-1], b.shape[-1] // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8, device=b.device)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)
