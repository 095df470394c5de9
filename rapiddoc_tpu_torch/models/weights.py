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

``save_variables`` writes such an npz from a nested tree, as the
checkpoint converters (``tools/convert_weights.py``) do.
:func:`flax_variables` is the inverse of :func:`load_flax_into`: a
model's tensors (or, with ``grads=True``, their gradients) as that tree,
in the JAX layouts, which is how the trainers (``train/``) write their
checkpoints; :func:`init_params` gives a model flax's default
initializers in distribution, from a ``torch.Generator``.

The layout checkpoint (``layout_demo.npz``: 557 arrays, 16.8 M
parameters; or a JAX random init of the published shape, flattened) maps
onto ``models/layout/rtdetr.py``'s ``RTDETR`` this way with no table of
its own: its modules carry the flax names.

A checkpoint of several models in one file (the formula recognizer's
``encoder/…``, ``decoder/…`` and ``mem_proj/…``) is cut into one flat
dict per model with :func:`subtree`, or loaded into a torch module with
one child per model (the table stage's SLANet and UniTable) through
:func:`nest_models`. Files are read in place. A model with no checkpoint gets seeded random
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


def save_variables(variables: dict, path: str | Path, half: bool = False) -> None:
    """A nested flax-layout tree -> npz of flat ``a/b/c`` keys, as the JAX
    package's ``save_variables`` (``rapiddoc_tpu/models/registry.py:45``)
    writes it; ``half`` stores float32 leaves as float16."""
    flat = {
        k: (v.astype(np.float16) if half and v.dtype == np.float32 else v)
        for k, v in flatten(variables).items()
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path), **flat)


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


def split_models(variables: dict) -> dict:
    """The inverse of :func:`nest_models` on trees: ``{"params": {model:
    …}, "batch_stats": {model: …}}`` -> ``{model: {"params": …,
    "batch_stats": …}}``, the layout of a checkpoint of several models."""
    out: dict = {}
    for collection, models in variables.items():
        for model, tree in models.items():
            out.setdefault(model, {})[collection] = tree
    return out


def flatten(variables: dict) -> dict[str, np.ndarray]:
    """A nested tree -> flat ``a/b/c`` -> array dict (float32 arrays as
    they are)."""
    flat: dict[str, np.ndarray] = {}

    def walk(node: dict, prefix: str = "") -> None:
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, key)
            else:
                flat[key] = np.asarray(v)

    walk(variables)
    return flat


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


def flax_variables(model: nn.Module, grads: bool = False) -> dict:
    """The inverse of :func:`load_flax_into`: ``{"params": …,
    "batch_stats": …}`` as float32 numpy leaves in the JAX package's
    layouts (OIHW -> HWIO, depthwise C1HW -> HW1C, (out, in) -> (in, out),
    BatchNorm and LayerNorm ``scale``/``bias`` and ``mean``/``var``, the
    GRU's six gate Denses, every other parameter as stored). With
    ``grads`` it gives each parameter's ``.grad`` (zeros where there is
    none) under ``params`` alone. A GRU's recurrent r and z biases, which
    flax does not have, are folded into the input gates' biases (exact:
    the two are summed inside the sigmoid)."""
    params: dict = {}
    stats: dict = {}

    def arr(t: torch.Tensor | None, like: torch.Tensor) -> np.ndarray:
        if t is None:
            t = torch.zeros_like(like)
        return t.detach().to("cpu", torch.float32).numpy().copy()

    def val(t: torch.Tensor) -> np.ndarray:
        return arr(t.grad if grads else t, t)

    def node(tree: dict, path: str) -> dict:
        for part in path.split(".") if path else []:
            tree = tree.setdefault(part, {})
        return tree

    for path, mod in model.named_modules():
        p = node(params, path) if list(mod.parameters(recurse=False)) else None
        if isinstance(mod, nn.Conv2d):
            p["kernel"] = val(mod.weight).transpose(2, 3, 1, 0)
            if mod.bias is not None:
                p["bias"] = val(mod.bias)
        elif isinstance(mod, nn.Linear):
            p["kernel"] = val(mod.weight).T.copy()
            if mod.bias is not None:
                p["bias"] = val(mod.bias)
        elif isinstance(mod, BatchNorm):
            p["scale"] = val(mod.weight)
            p["bias"] = val(mod.bias)
            if not grads:
                s = node(stats, path)
                s["mean"] = arr(mod.running_mean, mod.running_mean)
                s["var"] = arr(mod.running_var, mod.running_var)
        elif isinstance(mod, nn.LayerNorm):
            p["scale"] = val(mod.weight)
            p["bias"] = val(mod.bias)
        elif isinstance(mod, nn.Embedding):
            p["embedding"] = val(mod.weight)
        elif isinstance(mod, nn.GRUCell):
            w_ih, w_hh = np.split(val(mod.weight_ih), 3), np.split(val(mod.weight_hh), 3)
            b_ih, b_hh = np.split(val(mod.bias_ih), 3), np.split(val(mod.bias_hh), 3)
            for i, g in enumerate("rzn"):
                p[f"i{g}"] = {"kernel": w_ih[i].T.copy(),
                              "bias": b_ih[i] + b_hh[i] if g != "n" else b_ih[i]}
                p[f"h{g}"] = {"kernel": w_hh[i].T.copy()}
            p["hn"]["bias"] = b_hh[2]
        elif p is not None:
            for name, t in mod.named_parameters(recurse=False):
                p[name] = val(t)
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def _flax_fan_in(shape: tuple[int, ...]) -> int:
    """flax's ``variance_scaling`` fan-in of a kernel of ``shape`` (in
    flax's layout): the second-to-last axis times the receptive field."""
    if len(shape) < 2:
        return shape[0] if shape else 1
    receptive = int(np.prod(shape)) // (shape[-2] * shape[-1])
    return shape[-2] * receptive


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers, in distribution (not JAX's bits):
    ``lecun_normal`` (a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in, the fan-in taken on the flax layout)
    for every convolution, dense and bare kernel of two or more axes,
    zeros for biases, ones and zeros for the norms' scales and biases,
    and the running statistics at 0 and 1; ``nn.Embed``'s normal of
    variance 1 / features for embeddings, ``GRUCell``'s ``lecun_normal``
    input and ``orthogonal`` recurrent kernels gate by gate, and the
    normal(0.02) of the UniTable modules' learned ``pos_embed``."""

    def lecun(t: torch.Tensor, flax_shape: tuple[int, ...]) -> None:
        std = (1.0 / _flax_fan_in(flax_shape)) ** 0.5 / 0.87962566103423978
        draw = torch.empty(t.shape, dtype=torch.float32)
        nn.init.trunc_normal_(draw, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.copy_(draw * std)

    def normal(t: torch.Tensor, std: float) -> None:
        t.copy_(torch.randn(t.shape, generator=generator) * std)

    with torch.no_grad():
        for mod in module.modules():
            done: tuple[str, ...] = ()
            if isinstance(mod, nn.Conv2d):
                o, i, kh, kw = mod.weight.shape
                lecun(mod.weight, (kh, kw, i, o))
                done = ("weight",)
            elif isinstance(mod, nn.Linear):
                lecun(mod.weight, (mod.in_features, mod.out_features))
                done = ("weight",)
            elif isinstance(mod, (nn.LayerNorm, BatchNorm)):
                mod.weight.fill_(1.0)
                done = ("weight",)
            elif isinstance(mod, nn.Embedding):
                normal(mod.weight, mod.embedding_dim ** -0.5)
                done = ("weight",)
            elif isinstance(mod, nn.GRUCell):
                h = mod.hidden_size
                for g in range(3):
                    lecun(mod.weight_ih[g * h:(g + 1) * h], (mod.input_size, h))
                    mod.weight_hh[g * h:(g + 1) * h].copy_(
                        nn.init.orthogonal_(torch.empty(h, h), generator=generator))
                done = ("weight_ih", "weight_hh")
            if isinstance(mod, BatchNorm):
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
            for name, t in mod.named_parameters(recurse=False):
                if name in done:
                    continue
                if name == "pos_embed":
                    normal(t, 0.02)
                elif t.dim() >= 2:
                    lecun(t, tuple(t.shape))
                else:
                    t.zero_()


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
