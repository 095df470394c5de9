"""SVTR/CTC text recognition (PP-OCRv6-small flavor) in PyTorch.

Port of ``rapiddoc_tpu/models/ocr/rec.py:21-80``: PPLCNetV4(rec, small)
-> LightSVTR neck (2 transformer blocks) -> CTC head. The head's weight
keeps the flax (C, V) layout, which is what the fused head kernel
(``ops/ctc_head.py``) reads; ``features_only`` returns the (B, T, C)
sequence that goes into it.
"""
from __future__ import annotations

import torch
from torch import nn

from ...ops.ctc_head import ctc_head_decode, pad_ctc_kernel
from ..common.layers import ConvBNAct, TransformerBlock
from .backbone import PPLCNetV4


class LightSVTRNeck(nn.Module):
    def __init__(self, in_channels: int = 384, dims: int = 120,
                 depth: int = 2, num_heads: int = 8, mlp_ratio: float = 2.0,
                 local_kernel: int = 7):
        super().__init__()
        self.depth = depth
        self.skip_conv = ConvBNAct(in_channels, dims, 1, act="silu")
        self.reduce_conv = ConvBNAct(in_channels, dims, 1, act="silu")
        self.local_conv = ConvBNAct(
            dims, dims, (1, local_kernel), act="silu", groups=dims
        )
        for i in range(depth):
            self.add_module(
                f"block{i}",
                TransformerBlock(dims, num_heads, mlp_ratio),
            )
        self.norm = nn.LayerNorm(dims, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, C, 1, W')
        residual = self.skip_conv(x)
        h = self.reduce_conv(x)
        h = h + self.local_conv(h)
        b, c, hh, ww = h.shape
        seq = h.flatten(2).transpose(1, 2)  # (B, H*W, C), row-major as NHWC
        for i in range(self.depth):
            seq = getattr(self, f"block{i}")(seq)
        seq = self.norm(seq)
        return seq.transpose(1, 2).reshape(b, c, hh, ww) + residual


class CTCHead(nn.Module):
    """Vocabulary projection with a (C, V) kernel, run through the fused
    head kernel. On the card the kernel reads a bf16 copy of the weight
    with 16-byte aligned rows, made once per weight (again only if the
    weight is replaced or changed in place)."""

    def __init__(self, dims: int, num_classes: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(dims, num_classes))
        self.bias = nn.Parameter(torch.zeros(num_classes))
        self._aligned: tuple[tuple, torch.Tensor] | None = None

    def head_kernel(self) -> torch.Tensor:
        w = self.kernel
        if w.device.type != "cuda":
            return w
        key = (w.data_ptr(), w._version, w.dtype)
        if self._aligned is None or self._aligned[0] != key:
            self._aligned = (key, pad_ctc_kernel(w))
        return self._aligned[1]

    def forward(self, seq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        return ctc_head_decode(seq, self.head_kernel(), self.bias)


class SVTRRec(nn.Module):
    """CTC recognizer. Input (B, 48, W, 3) normalized (NHWC); output the
    (ids, probs) of each of the W/8 frames, or with ``features_only`` the
    (B, W/8, C) sequence."""

    def __init__(self, num_classes: int = 18710, model_size: str = "small",
                 dims: int = 120, depth: int = 2, mlp_ratio: float = 2.0,
                 local_kernel: int = 7):
        super().__init__()
        self.backbone = PPLCNetV4(det=False, model_size=model_size)
        self.neck = LightSVTRNeck(384, dims, depth, mlp_ratio=mlp_ratio,
                                  local_kernel=local_kernel)
        self.head = CTCHead(dims, num_classes)

    def forward(self, x: torch.Tensor, features_only: bool = False):
        feat = self.neck(self.backbone(x.permute(0, 3, 1, 2)))
        seq = feat.flatten(2).transpose(1, 2)  # h == 1 after pooling
        if features_only:
            return seq
        return self.head(seq)
