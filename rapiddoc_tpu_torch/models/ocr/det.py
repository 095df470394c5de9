"""DBNet text detection (PP-OCRv6-small flavor) in PyTorch.

Port of ``rapiddoc_tpu/models/ocr/det.py:26-86``: PPLCNetV4(det, small)
-> RepLKFPN(96, k7) -> DBHeadV6. ``DBNet.forward`` takes and returns the
JAX package's NHWC layout; inside, maps are NCHW.
"""
from __future__ import annotations

import torch
from torch import nn

from ..common.layers import (
    ClampSqueezeExcite,
    ConvBNAct,
    Deconv2x2BNAct,
    deconv2x2,
    upsample_nearest,
)
from .backbone import NET_CONFIG_DET, PPLCNetV4


class RepLKFPN(nn.Module):
    """Top-down FPN with large-kernel depthwise fusion and clamp-SE."""

    def __init__(self, in_channels=(48, 96, 192, 384), out_channels: int = 96,
                 dilated_kernel_size: int = 7, reduction: int = 4):
        super().__init__()
        oc, k = out_channels, dilated_kernel_size
        self.n = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"insert_conv{i}", nn.Conv2d(cin, oc, 1, bias=False))
            self.add_module(f"insert_se{i}", ClampSqueezeExcite(oc, reduction))
            self.add_module(
                f"input_dw{i}",
                nn.Conv2d(oc, oc, k, padding=k // 2, groups=oc, bias=True),
            )
            self.add_module(f"input_pw{i}", nn.Conv2d(oc, oc // 4, 1, bias=False))
            self.add_module(f"input_se{i}", ClampSqueezeExcite(oc // 4, reduction))

    def forward(self, feats: list[torch.Tensor]) -> torch.Tensor:
        m = dict(self.named_children())
        fused = []
        for i, f in enumerate(feats):
            h = m[f"insert_conv{i}"](f)
            fused.append(h + m[f"insert_se{i}"](h))
        for i in range(self.n - 2, -1, -1):
            fused[i] = fused[i] + upsample_nearest(fused[i + 1], 2)
        outs = []
        for i, f in enumerate(fused):
            h = m[f"input_pw{i}"](m[f"input_dw{i}"](f))
            h = h + m[f"input_se{i}"](h)
            outs.append(upsample_nearest(h, 2 ** i))
        return torch.cat(outs[::-1], dim=1)


class DBHeadV6(nn.Module):
    """conv k3 -> deconv k2s2 -> deconv k2s2 -> sigmoid prob map."""

    def __init__(self, in_channels: int = 96):
        super().__init__()
        c = in_channels // 4
        self.conv_down = ConvBNAct(in_channels, c, 3)
        self.conv_up = Deconv2x2BNAct(c, c)
        self.final_kernel = nn.Parameter(torch.zeros(c, 1, 2, 2))
        self.final_bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_up(self.conv_down(x))
        x = deconv2x2(x, self.final_kernel, self.final_bias)
        return torch.nan_to_num(torch.sigmoid(x.float()))  # fix_nan


class DBNet(nn.Module):
    """Full text detector: NHWC normalized image -> NHW1 fp32 prob map."""

    def __init__(self, model_size: str = "small", fpn_channels: int = 96):
        super().__init__()
        stages = NET_CONFIG_DET[model_size]["block_configs"]
        self.backbone = PPLCNetV4(det=True, model_size=model_size)
        self.neck = RepLKFPN(tuple(s[-1][2] for s in stages), fpn_channels)
        self.head = DBHeadV6(fpn_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(x.permute(0, 3, 1, 2))
        return self.head(self.neck(feats)).permute(0, 2, 3, 1)
