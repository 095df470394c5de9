"""PP-FormulaNet_plus in PyTorch: PPHGNetV2 encoder + MBart greedy decoder.

Port of ``rapiddoc_tpu/models/formula/model.py:19-61``
(``FormulaEncoder``, ``build_formula_modules``). The encoder takes NHWC
images, as the JAX package's does, and returns the (B, H*W, d_model)
memory in the same row-major order.
"""
from __future__ import annotations

import torch
from torch import nn

from ..layout.hgnet import PPHGNetV2
from .decoder import MBartConfig, MBartDecoder, MemoryProjector


class FormulaEncoder(nn.Module):
    """Image (B, H, W, 3) -> (B, S, d_model) memory for the decoder.
    ``out_index`` 3 is the stride-32 stage of the published layout; the
    demo checkpoint uses 2 (stride 16)."""

    def __init__(self, backbone_size: str = "B6", decoder_width: int = 512,
                 out_index: int = 3):
        super().__init__()
        self.backbone = PPHGNetV2(backbone_size, out_indices=(out_index,))
        width = PPHGNetV2.out_channels(backbone_size, (out_index,))[0]
        self.enc_to_dec_proj = nn.Linear(width, decoder_width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = self.backbone(x)[-1]  # (B, H/s, W/s, C)
        b, h, w, c = f.shape
        return self.enc_to_dec_proj(f.reshape(b, h * w, c))


def build_formula_modules(
    max_len: int = 2560,
    vocab_size: int = 50000,
    layers: int = 6,
    d_model: int = 512,
    ffn: int = 2048,
    heads: int = 16,
    backbone_size: str = "B6",
    out_index: int = 3,
):
    cfg = MBartConfig(
        vocab_size=vocab_size, d_model=d_model, layers=layers, heads=heads,
        ffn=ffn, max_positions=max_len,
    )
    return (
        FormulaEncoder(backbone_size, d_model, out_index=out_index),
        MBartDecoder(cfg),
        MemoryProjector(cfg),
        cfg,
    )
