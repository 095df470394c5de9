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
- ``nn.Embedding``: the ``embedding`` table;
- ``nn.GRUCell``: flax's six gate Denses (``ir``, ``iz``, ``in``
  biased, ``hr``, ``hz`` not, ``hn`` biased) stacked into torch's
  (r, z, n) ``weight_ih``/``weight_hh``, with ``bias_ih`` the input
  gates' biases and ``bias_hh`` zero for r and z and ``hn``'s bias for n;
- any other parameter (the (Cin, Cout, 2, 2) deconv kernels, the DB
  head's ``final_kernel``, the CTC head's (C, V) kernel, the MBart
  decoder's bare ``embed_positions``, the scalar ``scale``/``bias`` of
  HGNet's ``LearnableAffine``, and the ``kernel``/``bias`` of the layout
  model's ``DenseGeneral``, which keep flax's multi-head attention
  layouts: (C, heads, head_dim) and (heads, head_dim) for q/k/v,
  (heads, head_dim, C) and (C,) for the output) as stored, the root
  module's own included.

The layout checkpoint (``layout_demo.npz``: 557 arrays, 16.8 M
parameters; or a JAX random init of the published shape, flattened) maps
onto ``models/layout/rtdetr.py``'s ``RTDETR`` this way with no table of
its own: its modules carry the flax names.

A checkpoint of several models in one file (the formula recognizer's
``encoder/…``, ``decoder/…`` and ``mem_proj/…``) is cut into one flat
dict per model with :func:`subtree`, or loaded into a torch module with
one child per model (the table stage's SLANet and UniTable) through
:func:`nest_models`. Files are read in place and
nothing is written. A model with no checkpoint gets seeded random
weights from :func:`random_init`.
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


def subtree(flat: dict[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    """The ``name/…`` leaves of ``flat``, with the prefix taken off."""
    cut = len(name) + 1
    return {k[cut:]: v for k, v in flat.items() if k.startswith(name + "/")}


def nest_models(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``model/params/…`` leaves -> ``params/model/…`` (and the same for
    ``batch_stats``), the layout of one torch module whose children are
    the checkpoint's models."""
    out = {}
    for k, v in flat.items():
        model, collection, rest = k.split("/", 2)
        out[f"{collection}/{model}/{rest}"] = v
    return out


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
        if path and path.startswith(skip):
            continue
        fp = "/".join(["params", *path.split(".")]) if path else "params"
        sp = "/".join(["batch_stats", *path.split(".")]) if path else "batch_stats"
        prefix = f"{path}." if path else ""
        if isinstance(mod, nn.Conv2d):
            put(f"{prefix}weight", take(f"{fp}/kernel").transpose(3, 2, 0, 1))
            if mod.bias is not None:
                put(f"{prefix}bias", take(f"{fp}/bias"))
        elif isinstance(mod, nn.Linear):
            put(f"{prefix}weight", take(f"{fp}/kernel").T)
            if mod.bias is not None:
                put(f"{prefix}bias", take(f"{fp}/bias"))
        elif isinstance(mod, BatchNorm):
            put(f"{prefix}weight", take(f"{fp}/scale"))
            put(f"{prefix}bias", take(f"{fp}/bias"))
            put(f"{prefix}running_mean", take(f"{sp}/mean"))
            put(f"{prefix}running_var", take(f"{sp}/var"))
        elif isinstance(mod, nn.LayerNorm):
            put(f"{prefix}weight", take(f"{fp}/scale"))
            put(f"{prefix}bias", take(f"{fp}/bias"))
        elif isinstance(mod, nn.Embedding):
            put(f"{prefix}weight", take(f"{fp}/embedding"))
        elif isinstance(mod, nn.GRUCell):
            # flax: r, z = sigmoid(i{r,z}(x) + h{r,z}(h)) with only the
            # input side biased; n = tanh(in(x) + r * hn(h)), hn biased
            gate = {g: take(f"{fp}/{g}/kernel").T for g in ("ir", "iz", "in", "hr", "hz", "hn")}
            bias = {g: take(f"{fp}/{g}/bias") for g in ("ir", "iz", "in", "hn")}
            zero = np.zeros_like(bias["hn"])
            put(f"{prefix}weight_ih", np.concatenate([gate["ir"], gate["iz"], gate["in"]]))
            put(f"{prefix}weight_hh", np.concatenate([gate["hr"], gate["hz"], gate["hn"]]))
            put(f"{prefix}bias_ih", np.concatenate([bias["ir"], bias["iz"], bias["in"]]))
            put(f"{prefix}bias_hh", np.concatenate([zero, zero, bias["hn"]]))
        else:
            for name, _ in mod.named_parameters(recurse=False):
                put(f"{prefix}{name}", take(f"{fp}/{name}"))
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


def random_init(module: nn.Module, rng: np.random.Generator) -> None:
    """Random weights from a numpy generator: 1/sqrt(fan_in) normals for
    convolutions, dense layers and embeddings (1/sqrt(hidden) for GRU
    gates), N(0, 0.02) learned positions, zero biases, identity norms,
    BatchNorm statistics and LAB affines. It does not reproduce JAX's
    initializer bits."""

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.from_numpy(
            (rng.standard_normal(tuple(t.shape), dtype=np.float32) * np.float32(std))
        ))

    with torch.no_grad():
        for mod in module.modules():
            if isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                normal(mod.weight, fan_in ** -0.5)
            elif isinstance(mod, nn.Linear):
                normal(mod.weight, mod.in_features ** -0.5)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.Embedding):
                normal(mod.weight, mod.embedding_dim ** -0.5)
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, nn.GRUCell):
                for w in (mod.weight_ih, mod.weight_hh):
                    normal(w, mod.hidden_size ** -0.5)
                mod.bias_ih.zero_()
                mod.bias_hh.zero_()
            for name in ("embed_positions", "pos_embed"):
                if isinstance(getattr(mod, name, None), nn.Parameter):
                    normal(getattr(mod, name), 0.02)
