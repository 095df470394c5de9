"""Common NN building blocks in PyTorch (NCHW, inference only).

Port of ``rapiddoc_tpu/models/common/layers.py:59-233``. Modules work on
NCHW tensors, as PyTorch's convolutions do; the models convert from the
JAX package's NHWC at their public ``forward``. Each module's
parameters are named after the flax module tree so that
``models/weights.py`` can carry the flax checkpoints over by name.
Attention stays in plain torch ops: the JAX code's einsums are not a
Pallas kernel.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn


def act_fn(name: str | None) -> Callable[[torch.Tensor], torch.Tensor]:
    if name is None:
        return lambda x: x
    table = {
        "relu": F.relu,
        "gelu": F.gelu,  # erf form, as jax.nn.gelu(approximate=False)
        "silu": F.silu,
        "hardswish": F.hardswish,  # x * relu6(x + 3) / 6, as jax.nn.hard_swish
    }
    if name not in table:
        raise ValueError(f"unknown activation {name!r}")
    return table[name]


def _pair(v) -> tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)


class BatchNorm(nn.Module):
    """Frozen-statistics batch norm, y = (x - mean) * rsqrt(var + eps) *
    scale + bias, written out so that it runs in bf16 as in fp32 on any
    device. Names follow torch's BatchNorm2d."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean.view(shape)) * mul.view(shape) + (
            self.bias.view(shape)
        )


class ConvBNAct(nn.Module):
    """Conv -> BatchNorm(frozen stats) -> activation.

    ``padding`` None means (k-1)//2 on each side; "VALID" means none; a
    sequence of (before, after) pairs per spatial dim pads explicitly."""

    def __init__(
        self,
        in_channels: int,
        features: int,
        kernel_size: int | tuple[int, int] = 3,
        strides: int | tuple[int, int] = 1,
        groups: int = 1,
        act: str | None = "relu",
        padding: str | Sequence[tuple[int, int]] | None = None,
    ):
        super().__init__()
        k = _pair(kernel_size)
        if padding is None:
            pad = [((k[0] - 1) // 2,) * 2, ((k[1] - 1) // 2,) * 2]
        elif padding == "VALID":
            pad = [(0, 0), (0, 0)]
        else:
            pad = [tuple(p) for p in padding]
        symmetric = all(a == b for a, b in pad)
        self._extra_pad = None if symmetric else (
            pad[1][0], pad[1][1], pad[0][0], pad[0][1]
        )
        self.conv = nn.Conv2d(
            in_channels, features, k, stride=_pair(strides),
            padding=(pad[0][0], pad[1][0]) if symmetric else 0,
            groups=groups, bias=False,
        )
        self.bn = BatchNorm(features)
        self.act = act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self._extra_pad is not None:
            x = F.pad(x, self._extra_pad)
        return self.act(self.bn(self.conv(x)))


class SqueezeExcite(nn.Module):
    """Classic SE: pool -> 1x1 down -> relu -> 1x1 up -> hardsigmoid -> scale."""

    def __init__(self, channels: int, reduction: int = 4):
        super().__init__()
        self.fc1 = nn.Conv2d(channels, channels // reduction, 1)
        self.fc2 = nn.Conv2d(channels // reduction, channels, 1)

    def gate(self, s: torch.Tensor) -> torch.Tensor:
        return F.hardsigmoid(s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.fc2(F.relu(self.fc1(s)))
        return x * self.gate(s)


class ClampSqueezeExcite(SqueezeExcite):
    """SE variant with clamp(0.2x + 0.5) gating (RepLKFPN flavor)."""

    def gate(self, s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(0.2 * s + 0.5, 0.0, 1.0)


def deconv2x2(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Exact ConvTranspose2d(k=2, s=2, p=0); kernel (Cin, Cout, 2, 2)."""
    return F.conv_transpose2d(x, kernel.to(x.dtype), bias.to(x.dtype), stride=2)


class Deconv2x2BNAct(nn.Module):
    """ConvTranspose(k2, s2) + BN + relu."""

    def __init__(self, in_features: int, features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(in_features, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(deconv2x2(x, self.kernel, self.bias)))


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour integer upsample of an NCHW map."""
    if scale == 1:
        return x
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def max_pool_2x2_s1_ceil(x: torch.Tensor) -> torch.Tensor:
    """MaxPool k2 s1 with ceil semantics via edge pad."""
    x = F.pad(x, (0, 1, 0, 1), mode="replicate")
    return F.max_pool2d(x, 2, stride=1)


class MHSA(nn.Module):
    """Standard multi-head self-attention over (B, N, C) sequences."""

    def __init__(self, dim: int, num_heads: int = 8):
        super().__init__()
        self.dim = dim
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        hd = self.dim // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, hd)
        q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
        attn = (q @ k.transpose(-1, -2)) * (hd ** -0.5)
        attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        out = (attn @ v).transpose(1, 2).reshape(b, n, c)
        return self.proj(out)


class TransformerBlock(nn.Module):
    """Pre-norm transformer block (LightSVTR flavor by default: SiLU MLP,
    LayerNorm eps 1e-6; UniTable's encoder takes exact GELU and 1e-5)."""

    def __init__(self, dim: int, num_heads: int = 8, mlp_ratio: float = 4.0,
                 act: str = "silu", ln_eps: float = 1e-6):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = MHSA(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.act = act_fn(act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.fc2(self.act(self.fc1(self.norm2(x))))
