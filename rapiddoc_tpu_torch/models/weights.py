"""Flax npz checkpoints -> PyTorch state dicts.

Mirrors ``_load_variables`` (``rapiddoc_tpu/models/registry.py:25``):
an npz of flat ``params/a/b/c`` and ``batch_stats/a/b/c`` keys, float16
leaves upcast to float32. The port's modules are named after the flax
module tree, so each torch module finds its leaves by its own path, and
its type decides the layout change:

- ``nn.Conv2d``: HWIO kernel -> OIHW weight (a depthwise HW1C kernel
  becomes C1HW, which is what ``groups=C`` wants);
- ``nn.Linear``: (in, out) kernel -> (out, in) weight;
- ``BatchNorm``: ``scale``/``bias`` params and ``mean``/``var`` stats;
- ``nn.LayerNorm``: ``scale``/``bias``;
- any other parameter (the (Cin, Cout, 2, 2) deconv kernels, the DB
  head's ``final_kernel``, the CTC head's (C, V) kernel) as stored.

Files are read in place and nothing is written.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from torch import nn

from .common.layers import BatchNorm


def load_npz(path: str | Path) -> dict[str, np.ndarray]:
    """Flat ``a/b/c`` -> array dict, float16 upcast to float32."""
    with np.load(str(path), allow_pickle=False) as z:
        return {
            k: (v.astype(np.float32) if v.dtype == np.float16 else v)
            for k, v in z.items()
        }


def load_flax_into(
    model: nn.Module, flat: dict[str, np.ndarray], skip: tuple[str, ...] = ()
) -> nn.Module:
    """Load flax leaves into ``model`` and return it. Strict: raises
    KeyError if a leaf the model needs is missing, and ValueError if the
    checkpoint holds leaves no module took or the model has tensors no
    leaf filled. Modules whose path starts with one of ``skip`` are left
    as they are, and their leaves may stay unused."""
    out: dict[str, torch.Tensor] = {}
    used: set[str] = set()

    def take(key: str) -> np.ndarray:
        used.add(key)
        return flat[key]

    def put(name: str, arr: np.ndarray) -> None:
        out[name] = torch.from_numpy(np.array(arr, np.float32, order="C"))

    for path, mod in model.named_modules():
        if not path or path.startswith(skip):
            continue
        fp = "params/" + path.replace(".", "/")
        sp = "batch_stats/" + path.replace(".", "/")
        if isinstance(mod, nn.Conv2d):
            put(f"{path}.weight", take(f"{fp}/kernel").transpose(3, 2, 0, 1))
            if mod.bias is not None:
                put(f"{path}.bias", take(f"{fp}/bias"))
        elif isinstance(mod, nn.Linear):
            put(f"{path}.weight", take(f"{fp}/kernel").T)
            if mod.bias is not None:
                put(f"{path}.bias", take(f"{fp}/bias"))
        elif isinstance(mod, BatchNorm):
            put(f"{path}.weight", take(f"{fp}/scale"))
            put(f"{path}.bias", take(f"{fp}/bias"))
            put(f"{path}.running_mean", take(f"{sp}/mean"))
            put(f"{path}.running_var", take(f"{sp}/var"))
        elif isinstance(mod, nn.LayerNorm):
            put(f"{path}.weight", take(f"{fp}/scale"))
            put(f"{path}.bias", take(f"{fp}/bias"))
        else:
            for name, _ in mod.named_parameters(recurse=False):
                put(f"{path}.{name}", take(f"{fp}/{name}"))
    prefixes = tuple(
        f"{c}/{s.replace('.', '/')}" for s in skip
        for c in ("params", "batch_stats")
    )
    unused = sorted(
        k for k in flat if k not in used and not k.startswith(prefixes)
    )
    if unused:
        raise ValueError(f"checkpoint leaves no module took: {unused[:8]}")
    missing, unexpected = model.load_state_dict(out, strict=False)
    missing = [k for k in missing if not k.startswith(skip)]
    if missing or unexpected:
        raise ValueError(f"missing {missing[:8]}, unexpected {unexpected[:8]}")
    return model
