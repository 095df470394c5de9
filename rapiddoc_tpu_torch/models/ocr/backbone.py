"""PPLCNetV4 backbone (det & rec variants) in PyTorch, NCHW.

Port of ``rapiddoc_tpu/models/ocr/backbone.py:74-160``: branch stem,
then four stages of depthwise-separable blocks with GELU channel mixing
and optional SE.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.layers import ConvBNAct, SqueezeExcite

NET_CONFIG_DET = {
    "small": {
        "stem_channels": [3, 24, 48],
        "block_configs": [
            [[3, 48, 48, 1, True], [3, 48, 48, 1, False]],
            [[3, 48, 96, 2, False], [3, 96, 96, 1, True], [3, 96, 96, 1, False]],
            [
                [3, 96, 192, 2, False],
                [3, 192, 192, 1, True],
                [3, 192, 192, 1, False],
                [3, 192, 192, 1, True],
                [3, 192, 192, 1, False],
            ],
            [[3, 192, 384, 2, False], [3, 384, 384, 1, True], [3, 384, 384, 1, False]],
        ],
    },
}

NET_CONFIG_REC = {
    "small": {
        "stem_channels": [3, 48, 96],
        "block_configs": [
            [[3, 96, 96, 1, True]],
            [[3, 96, 96, 1, False], [3, 96, 96, 1, False]],
            [
                [3, 96, 192, (2, 1), False],
                [3, 192, 192, 1, True],
                [3, 192, 192, 1, False],
                [3, 192, 192, 1, True],
                [3, 192, 192, 1, False],
                [3, 192, 192, 1, True],
                [3, 192, 192, 1, False],
            ],
            [[3, 192, 384, (2, 1), False], [3, 384, 384, 1, True], [3, 384, 384, 1, False]],
        ],
    },
}


class LCNetV4Stem(nn.Module):
    """stem1 k3s2 -> {pool | stem2a/2b} concat -> stem3 k3s2 -> stem4 1x1."""

    def __init__(self, stem_channels: Sequence[int]):
        super().__init__()
        c0, c1, c2 = stem_channels
        self.stem1 = ConvBNAct(c0, c1, 3, strides=2)
        self.stem2a = ConvBNAct(c1, c1 // 2, 2, padding="VALID")
        self.stem2b = ConvBNAct(c1 // 2, c1, 2, padding="VALID")
        self.stem3 = ConvBNAct(2 * c1, c1, 3, strides=2)
        self.stem4 = ConvBNAct(c1, c2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem1(x)
        xp = F.pad(x, (0, 1, 0, 1))
        a = self.stem2b(F.pad(self.stem2a(xp), (0, 1, 0, 1)))
        pooled = F.max_pool2d(xp, 2, stride=1)
        x = torch.cat([pooled, a], dim=1)
        return self.stem4(self.stem3(x))


class LCNetV4DSBlock(nn.Module):
    """Token mixer (dw conv, rep-style when s1) + SE + GELU channel MLP."""

    def __init__(self, in_channels: int, out_channels: int,
                 stride: tuple[int, int], kernel_size: int = 3,
                 use_se: bool = False):
        super().__init__()
        cin, cout = in_channels, out_channels
        self.residual = cin == cout and tuple(stride) == (1, 1)
        if self.residual:
            # inference-fused reparam dw conv: plain conv with bias
            self.token_conv = nn.Conv2d(
                cin, cout, kernel_size, padding=kernel_size // 2,
                groups=cin, bias=True,
            )
        else:
            self.token_conv = ConvBNAct(
                cin, cin, kernel_size, strides=stride, groups=cin, act=None
            )
        self.se = SqueezeExcite(cin) if use_se else None
        self.channel_conv1 = ConvBNAct(cin, cin * 2, 1, act=None)
        self.channel_conv2 = ConvBNAct(cin * 2, cout, 1, act=None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.token_conv(x)
        if self.se is not None:
            x = self.se(x)
        h = self.channel_conv2(F.gelu(self.channel_conv1(x)))
        return x + h if self.residual else h


class PPLCNetV4(nn.Module):
    """Returns the four stage feature maps (det) or pooled rec features."""

    def __init__(self, det: bool = True, model_size: str = "small"):
        super().__init__()
        self.det = det
        cfg = (NET_CONFIG_DET if det else NET_CONFIG_REC)[model_size]
        self.stem = LCNetV4Stem(cfg["stem_channels"])
        self.stage_ends = []
        for si, stage in enumerate(cfg["block_configs"]):
            for bi, (k, cin, cout, stride, use_se) in enumerate(stage):
                stride = (stride, stride) if isinstance(stride, int) else tuple(stride)
                self.add_module(
                    f"stage{si}_block{bi}",
                    LCNetV4DSBlock(cin, cout, stride, k, use_se),
                )
            self.stage_ends.append(f"stage{si}_block{len(stage) - 1}")

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        feats = []
        for name, mod in self.named_children():
            if name == "stem":
                continue
            x = mod(x)
            if name in self.stage_ends:
                feats.append(x)
        if self.det:
            return feats
        # rec: final (3, 2) avg pool collapses height to 1
        return F.avg_pool2d(feats[-1], (3, 2), stride=(3, 2))
