"""PPHGNetV2 backbone in PyTorch (NCHW inside, NHWC at ``forward``).

Port of ``rapiddoc_tpu/models/layout/hgnet.py:12-239``: ``STAGE_CONFIGS``
(B0-B6), ``LearnableAffine``, ``HGConvBNAct``, ``HGLightConv``,
``HGStem``, ``HGBlock``, ``HGStage`` and ``PPHGNetV2``. Parameter names
follow the flax module tree, so ``models/weights.py`` carries a flax
checkpoint over by name. The formula encoder and the layout model
(``rtdetr.py``) use it.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..common.layers import ConvBNAct

# stage config: in, mid, out, blocks, downsample, light, kernel, layers
STAGE_CONFIGS = {
    "B0": {
        "stem": [3, 16, 16],
        "stages": [
            [16, 16, 64, 1, False, False, 3, 3],
            [64, 32, 256, 1, True, False, 3, 3],
            [256, 64, 512, 2, True, True, 5, 3],
            [512, 128, 1024, 1, True, True, 5, 3],
        ],
        "use_lab": True,
    },
    "B2": {
        "stem": [3, 24, 32],
        "stages": [
            [32, 32, 96, 1, False, False, 3, 4],
            [96, 64, 384, 1, True, False, 3, 4],
            [384, 128, 768, 3, True, True, 5, 4],
            [768, 256, 1536, 1, True, True, 5, 4],
        ],
        "use_lab": True,
    },
    "B4": {
        "stem": [3, 32, 48],
        "stages": [
            [48, 48, 128, 1, False, False, 3, 6],
            [128, 96, 512, 1, True, False, 3, 6],
            [512, 192, 1024, 3, True, True, 5, 6],
            [1024, 384, 2048, 1, True, True, 5, 6],
        ],
        "use_lab": False,
    },
    "B5": {
        "stem": [3, 32, 64],
        "stages": [
            [64, 64, 128, 1, False, False, 3, 6],
            [128, 128, 512, 2, True, False, 3, 6],
            [512, 256, 1024, 5, True, True, 5, 6],
            [1024, 512, 2048, 2, True, True, 5, 6],
        ],
        "use_lab": False,
    },
    "B6": {
        "stem": [3, 48, 96],
        "stages": [
            [96, 96, 192, 2, False, False, 3, 6],
            [192, 192, 512, 3, True, False, 3, 6],
            [512, 384, 1024, 6, True, True, 5, 6],
            [1024, 768, 2048, 3, True, True, 5, 6],
        ],
        "use_lab": False,
    },
}


class LearnableAffine(nn.Module):
    """LAB: y = scale * x + bias (scalar parameters)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(1))
        self.bias = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.scale * x + self.bias


class HGConvBNAct(nn.Module):
    """ConvBNAct with optional LAB (HGNet flavor, ReLU). LAB runs only
    after an activation, as in the JAX package."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 strides: int = 1, groups: int = 1, use_act: bool = True,
                 use_lab: bool = False, padding: str | None = None):
        super().__init__()
        self.cba = ConvBNAct(
            in_channels, features, kernel_size, strides=strides, groups=groups,
            act="relu" if use_act else None, padding=padding,
        )
        self.lab = LearnableAffine() if use_act and use_lab else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.cba(x)
        return x if self.lab is None else self.lab(x)


class HGLightConv(nn.Module):
    """1x1 (no act) + depthwise kxk (act)."""

    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 use_lab: bool = False):
        super().__init__()
        self.conv1 = HGConvBNAct(in_channels, features, 1, use_act=False,
                                 use_lab=use_lab)
        self.conv2 = HGConvBNAct(features, features, kernel_size,
                                 groups=features, use_act=True, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(x))


class HGStem(nn.Module):
    """The stem pads right and bottom with zeros and runs its 2x2 convs
    and its 2x2/s1 max pool VALID on that: LAB can make values negative,
    so the zero padding can win the pool."""

    def __init__(self, stem_channels: Sequence[int], use_lab: bool = False):
        super().__init__()
        cin, mid, out = stem_channels
        self.stem1 = HGConvBNAct(cin, mid, 3, strides=2, use_lab=use_lab)
        self.stem2a = HGConvBNAct(mid, mid // 2, 2, padding="VALID", use_lab=use_lab)
        self.stem2b = HGConvBNAct(mid // 2, mid, 2, padding="VALID", use_lab=use_lab)
        self.stem3 = HGConvBNAct(2 * mid, mid, 3, strides=2, use_lab=use_lab)
        self.stem4 = HGConvBNAct(mid, out, 1, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.stem1(x)
        xp = F.pad(x, (0, 1, 0, 1))
        a = self.stem2b(F.pad(self.stem2a(xp), (0, 1, 0, 1)))
        pooled = F.max_pool2d(xp, 2, stride=1)
        x = torch.cat([pooled, a], dim=1)
        return self.stem4(self.stem3(x))


class HGBlock(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 kernel_size: int = 3, layer_num: int = 6, identity: bool = False,
                 light_block: bool = True, use_lab: bool = False):
        super().__init__()
        self.identity = identity
        self.layer_num = layer_num
        for i in range(layer_num):
            cin = in_channels if i == 0 else mid_channels
            if light_block:
                layer = HGLightConv(cin, mid_channels, kernel_size, use_lab)
            else:
                layer = HGConvBNAct(cin, mid_channels, kernel_size, use_lab=use_lab)
            self.add_module(f"layer{i}", layer)
        total = in_channels + layer_num * mid_channels
        self.agg_squeeze = HGConvBNAct(total, out_channels // 2, 1, use_lab=use_lab)
        self.agg_excite = HGConvBNAct(out_channels // 2, out_channels, 1, use_lab=use_lab)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        outputs = [x]
        h = x
        for i in range(self.layer_num):
            h = getattr(self, f"layer{i}")(h)
            outputs.append(h)
        h = self.agg_excite(self.agg_squeeze(torch.cat(outputs, dim=1)))
        return h + x if self.identity else h


class HGStage(nn.Module):
    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 block_num: int, layer_num: int = 6, downsample: bool = True,
                 light_block: bool = True, kernel_size: int = 3,
                 use_lab: bool = False):
        super().__init__()
        # depthwise 3x3/s2 with no activation (so no LAB)
        self.downsample = HGConvBNAct(
            in_channels, in_channels, 3, strides=2, groups=in_channels,
            use_act=False, use_lab=use_lab,
        ) if downsample else None
        self.block_num = block_num
        for i in range(block_num):
            self.add_module(f"block{i}", HGBlock(
                in_channels if i == 0 else out_channels, mid_channels,
                out_channels, kernel_size, layer_num, identity=i > 0,
                light_block=light_block, use_lab=use_lab,
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.downsample is not None:
            x = self.downsample(x)
        for i in range(self.block_num):
            x = getattr(self, f"block{i}")(x)
        return x


class PPHGNetV2(nn.Module):
    """Returns the NHWC features at the requested stage indices. The
    stages past the last requested one hold weights (a checkpoint of the
    whole backbone loads) but do not run in inference: their output is
    unused, which XLA's dead-code pass also finds in the JAX package. In
    train mode they run, output unused, because flax's batch statistics
    move there too (the formula encoder stops at stage 2 of 4)."""

    def __init__(self, size: str = "B4", out_indices: tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        cfg = STAGE_CONFIGS[size]
        use_lab = cfg["use_lab"]
        self.out_indices = tuple(out_indices)
        self.stem = HGStem(cfg["stem"], use_lab)
        self.n_stages = len(cfg["stages"])
        for si, (cin, mid, cout, nblocks, down, light, k, nlayer) in enumerate(cfg["stages"]):
            self.add_module(f"stage{si}", HGStage(
                cin, mid, cout, nblocks, nlayer, down, light, k, use_lab,
            ))

    def forward(self, x_nhwc: torch.Tensor) -> list[torch.Tensor]:
        x = self.stem(x_nhwc.permute(0, 3, 1, 2))
        feats = []
        last = self.n_stages - 1 if self.training else max(self.out_indices)
        for si in range(last + 1):
            x = getattr(self, f"stage{si}")(x)
            if si in self.out_indices:
                feats.append(x.permute(0, 2, 3, 1))
        return feats

    @staticmethod
    def out_channels(size: str, out_indices=(1, 2, 3)) -> list[int]:
        cfg = STAGE_CONFIGS[size]
        return [cfg["stages"][i][2] for i in out_indices]
