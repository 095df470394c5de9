"""Torch-checkpoint -> flax-variables conversion helpers.

Copy of ``rapiddoc_tpu/engine/weights.py``. The published checkpoints
for every model family are torch/safetensors state dicts; each family's
``convert.py`` maps one onto the flax-layout tree (HWIO convs, (in, out)
dense kernels, ``scale``/``bias``/``mean``/``var`` BatchNorm leaves) that
the JAX package saves as npz, and that ``models/weights.py`` loads into
the port's torch modules. ``tests/test_torch_convert.py`` holds every
converter's tree to the JAX package's, leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np


def conv_kernel(w: Any) -> np.ndarray:
    """torch Conv2d OIHW -> flax HWIO."""
    w = np.asarray(w, dtype=np.float32)
    return np.transpose(w, (2, 3, 1, 0))


def dw_conv_kernel(w: Any) -> np.ndarray:
    """torch depthwise Conv2d (C,1,kh,kw) -> flax (kh,kw,1,C)."""
    w = np.asarray(w, dtype=np.float32)
    return np.transpose(w, (2, 3, 1, 0))


def dense_kernel(w: Any) -> np.ndarray:
    """torch Linear (out,in) -> flax (in,out)."""
    return np.ascontiguousarray(np.asarray(w, dtype=np.float32).T)


def vec(w: Any) -> np.ndarray:
    return np.asarray(w, dtype=np.float32)


class TorchDict:
    """Typed accessor over a torch state dict (values may be tensors)."""

    def __init__(self, sd: Mapping[str, Any]):
        self.sd = {k: self._np(v) for k, v in sd.items()}
        self.used: set[str] = set()

    @staticmethod
    def _np(v: Any) -> np.ndarray:
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        return np.asarray(v)

    def __call__(self, key: str) -> np.ndarray:
        self.used.add(key)
        return self.sd[key]

    def has(self, key: str) -> bool:
        return key in self.sd

    def unused(self) -> list[str]:
        return [
            k
            for k in self.sd
            if k not in self.used and not k.endswith("num_batches_tracked")
        ]


def convbn(t: TorchDict, conv_key: str, bn_key: str, *, dw: bool = False,
           conv_bias: bool = False) -> tuple[dict, dict]:
    """Build flax {conv, bn} params + batch_stats from torch keys."""
    kernel = (dw_conv_kernel if dw else conv_kernel)(t(f"{conv_key}.weight"))
    conv = {"kernel": kernel}
    if conv_bias:
        conv["bias"] = vec(t(f"{conv_key}.bias"))
    params = {
        "conv": conv,
        "bn": {
            "scale": vec(t(f"{bn_key}.weight")),
            "bias": vec(t(f"{bn_key}.bias")),
        },
    }
    stats = {
        "bn": {
            "mean": vec(t(f"{bn_key}.running_mean")),
            "var": vec(t(f"{bn_key}.running_var")),
        }
    }
    return params, stats


def plain_conv(t: TorchDict, key: str, *, dw: bool = False, bias: bool = True) -> dict:
    out = {"kernel": (dw_conv_kernel if dw else conv_kernel)(t(f"{key}.weight"))}
    if bias and t.has(f"{key}.bias"):
        out["bias"] = vec(t(f"{key}.bias"))
    return out


def se_params(t: TorchDict, conv1: str, conv2: str) -> dict:
    return {
        "fc1": plain_conv(t, conv1),
        "fc2": plain_conv(t, conv2),
    }


def layernorm(t: TorchDict, key: str) -> dict:
    return {"scale": vec(t(f"{key}.weight")), "bias": vec(t(f"{key}.bias"))}


def dense(t: TorchDict, key: str, *, bias: bool = True) -> dict:
    out = {"kernel": dense_kernel(t(f"{key}.weight"))}
    if bias and t.has(f"{key}.bias"):
        out["bias"] = vec(t(f"{key}.bias"))
    return out
