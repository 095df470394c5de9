"""PyTorch interpreter for static-graph ONNX checkpoints.

Port of ``rapiddoc_tpu/engine/onnx_jax.py``: ``OnnxTorchFunction`` is its
``OnnxJaxFunction`` (``from_file``, ``input_names``, ``preproc``, and a
call that returns numpy), and ``_Executor`` has one ``op_*`` handler for
each of that module's, If and Loop included. The published RapidDoc
models are ONNX files (layout RT-DETR family, UNet, the table and
orientation classifiers, SLANet-plus, Magika); this runs them without
the onnx package or onnxruntime.

The graph runs eagerly on ``device`` (the card unless the caller names
another), with no per-shape compile. What the JAX interpreter decides
while it traces is decided here the same way, so both give the same
values and dtypes:

- Values are numpy arrays (static: integer and bool initializers,
  Resize's scales and sizes, and everything computed only from them and
  from shapes) or tensors on the device. A handler whose inputs are all
  static runs in numpy, so Reshape/Slice/Pad targets stay host integers;
  float initializers go to the device once, when the function is built.
  A handler that needs a static value and gets a device one raises, as
  the JAX trace does.
- The JAX package runs with 64-bit types off: a value that reaches the
  device as float64 becomes float32, int64 becomes int32, and so do the
  outputs, static ones included. ``_x32`` applies that mapping; ArgMax
  and TopK return int32, and gathers index in int64 inside torch.
- Integer Div is floor division and Mod takes the divisor's sign
  (numpy's ``mod``, whatever ``fmod`` says), as in the JAX interpreter.
- TopK is a stable descending sort, so among equal values the lower
  index comes first, as ``jax.lax.top_k`` orders them.
- Resize is ``jax.image.resize``, not ONNX's Resize: half-pixel
  centres, a triangle (linear) or Keys a = -0.5 (cubic) kernel widened
  when it downsamples (antialias), weights normalised per output pixel.
  The separable weight matrices are built in numpy float32 for each
  (input, output) size, cached, and applied as products on the device;
  nearest takes jax's float32 index arithmetic, and the asymmetric
  nearest path its own host indices.
- If with a device condition reads the condition on the host (one sync)
  and runs the branch it names. Loop needs a static trip count M; its
  scan outputs are buffers of M rows, zero past the exit (not ONNX's
  truncation), carried values are cast back to their first dtype each
  step, and the exit condition is read on the host each step.

Each call is the program ``onnx`` of the FLOP accounting
(``engine/flops.py``), one signature per set of input names, shapes and
dtypes, as the JAX interpreter tracks it.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..tools.onnx_reader import OnnxModel, read_onnx_model
from . import flops
from .session import resolve_device

_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
# 64-bit types off, as the JAX package runs
_X32 = {np.dtype(np.float64): np.dtype(np.float32), np.dtype(np.int64): np.dtype(np.int32),
        np.dtype(np.uint64): np.dtype(np.uint32)}
_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float16): torch.float16,
    np.dtype(np.float64): torch.float64, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool, np.dtype(np.uint16): torch.uint16,
    np.dtype(np.uint32): torch.uint32,
}
_WIDEN = {torch.bool: torch.int32, torch.int8: torch.int32, torch.int16: torch.int32,
          torch.uint8: torch.uint32, torch.uint16: torch.uint32}


def _x32(dt) -> np.dtype:
    dt = np.dtype(dt)
    return _X32.get(dt, dt)


def _is_static(x) -> bool:
    return isinstance(x, (np.ndarray, np.generic, int, float, bool))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        raise TypeError(
            "a device value where the graph needs a static one (the JAX "
            "interpreter cannot trace this graph either)"
        )
    return np.asarray(x)


def _scalar(x):
    """The one value of a static scalar or one-element array."""
    return _np(x).reshape(-1)[0]


def _to_numpy(x) -> np.ndarray:
    """A graph output as the JAX function returns it."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    arr = np.asarray(x)
    return arr.astype(_x32(arr.dtype))


def _promote(*ts: torch.Tensor) -> list[torch.Tensor]:
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _mod(a, b):
    """numpy's mod (the divisor's sign), as jnp.mod computes it."""
    r = torch.fmod(a, b)
    return torch.where((r != 0) & ((r < 0) != (b < 0)), r + b, r)


def _binary(fn):
    def run(a, b):
        a, b = _promote(a, b)
        return fn(a, b)

    return run


def _widened(t: torch.Tensor) -> torch.Tensor:
    """``t`` in jnp.sum/prod's result dtype: bool and small integers widen
    to 32 bits (computed through int64: torch has few uint32 kernels)."""
    dt = _WIDEN.get(t.dtype)
    return t if dt is None else t.to(torch.int64)


def _narrowed(out: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return out.to(_WIDEN.get(t.dtype, t.dtype))


# ------------------------------------------------- jax.image.resize weights

def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(np.float32(0), np.float32(1) - np.abs(x))


def _keys_cubic(x: np.ndarray) -> np.ndarray:
    f32 = np.float32
    out = ((f32(1.5) * x - f32(2.5)) * x) * x + f32(1)
    out = np.where(x >= f32(1), ((f32(-0.5) * x + f32(2.5)) * x - f32(4)) * x + f32(2), out)
    return np.where(x >= f32(2), f32(0), out).astype(f32)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def resize_weights(m: int, n: int, method: str) -> np.ndarray:
    """``jax.image``'s ``compute_weight_mat`` for an axis of ``m`` pixels
    resized to ``n`` (scale n / m, no translation, antialias on), in
    float32: (m, n), the weights of output pixel j in column j."""
    f32 = np.float32
    scale = 1.0 if n == 0 else n / m
    inv_scale = 1.0 / scale
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(n, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.0) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(m, dtype=f32)[:, None]) / kernel_scale
    w = _KERNELS[method](x.astype(f32))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * float(np.finfo(np.float32).eps)),
                 w / np.where(total != 0, total, f32(1)), f32(0))
    inside = (sample_f >= f32(-0.5)) & (sample_f <= f32(m - 0.5))
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def nearest_indices(m: int, n: int) -> np.ndarray:
    """``jax.image``'s nearest source index of each of ``n`` outputs from
    ``m`` inputs: floor((j + 0.5) * m / n) in float32."""
    f32 = np.float32
    offsets = ((np.arange(n, dtype=f32) + f32(0.5)) * f32(m)) / f32(n)
    return np.floor(offsets).astype(np.int64)


class _Executor:
    """Runs an OnnxModel node list with torch on ``device``.

    Values in the environment are either numpy arrays (statically known:
    initializers that are not float, and everything derived only from
    them and from shapes) or tensors. Ops whose inputs are all static run
    in numpy so downstream Reshape/Slice/Pad targets stay concrete.
    """

    def __init__(self, model: OnnxModel, device: torch.device):
        self.model = model
        self.device = device
        self._resize_cache: dict[tuple, torch.Tensor] = {}

    # -- helpers ----------------------------------------------------------

    def run(self, params: dict, inputs: dict):
        env: dict[str, Any] = {"": None}
        env.update(params)
        env.update(inputs)
        return self._exec(self.model, env)

    def _exec(self, graph, env: dict):
        """Execute a node list against an environment (shared by the top
        graph and If/Loop subgraphs; subgraph envs overlay the outer scope
        per ONNX name-capture semantics)."""
        for node in graph.nodes:
            handler = getattr(self, f"op_{node.op_type}", None)
            if handler is None:
                raise NotImplementedError(
                    f"ONNX op {node.op_type!r} not supported "
                    f"(node {node.name!r})"
                )
            self._env = env  # current scope, for subgraph-bearing ops
            vals = handler(node, [env[i] for i in node.inputs])
            if not isinstance(vals, (tuple, list)):
                vals = (vals,)
            for out_name, val in zip(node.outputs, vals):
                if out_name:
                    env[out_name] = val
        return [env[o] for o in graph.output_names]

    def _run_subgraph(self, graph, ins, outer_env: dict):
        env = dict(outer_env)  # outer-scope capture
        env[""] = None
        for k, v in graph.initializers.items():
            env[k] = np.asarray(v)
        for name, v in zip(graph.input_names, ins):
            env[name] = v
        return self._exec(graph, env)

    def _dev(self, x) -> torch.Tensor:
        """A value on the device, as jnp.asarray puts it in the trace."""
        if isinstance(x, torch.Tensor):
            return x
        arr = np.asarray(x)
        # astype keeps a 0-d array 0-d (ascontiguousarray would not);
        # initializers read from the file are read-only views: copied
        copy = not (arr.flags.c_contiguous and arr.flags.writeable)
        arr = arr.astype(_x32(arr.dtype), order="C", copy=copy)
        return torch.from_numpy(arr).to(self.device)

    def _const(self, value, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(dtype)
        return torch.as_tensor(np.asarray(value), device=self.device).to(dtype)

    @staticmethod
    def _static_all(xs) -> bool:
        return all(_is_static(x) for x in xs if x is not None)

    def _ew(self, fn_np, fn_torch, xs):
        """Elementwise/unary-binary dispatch: numpy when fully static."""
        if all(_is_static(x) for x in xs):
            return fn_np(*[_np(x) for x in xs])
        return fn_torch(*[self._dev(x) for x in xs])

    @staticmethod
    def _shape(x) -> tuple:
        return tuple(_np(x).shape if _is_static(x) else x.shape)

    # -- tensor plumbing ---------------------------------------------------

    def op_Constant(self, node, xs):
        v = node.attrs.get("value")
        if v is None:
            if "value_float" in node.attrs:
                return np.float32(node.attrs["value_float"])
            if "value_int" in node.attrs:
                return np.int64(node.attrs["value_int"])
            if "value_ints" in node.attrs:
                return np.asarray(node.attrs["value_ints"], np.int64)
            if "value_floats" in node.attrs:
                return np.asarray(node.attrs["value_floats"], np.float32)
            raise NotImplementedError("Constant without tensor value")
        return v

    def op_Identity(self, node, xs):
        return xs[0]

    def op_Cast(self, node, xs):
        dt = _ONNX_DTYPES[node.attrs["to"]]
        x = xs[0]
        if _is_static(x):
            return _np(x).astype(dt)
        return x.to(_TORCH[_x32(dt)])

    def op_Shape(self, node, xs):
        shape = np.asarray(self._shape(xs[0]), np.int64)
        start = node.attrs.get("start", 0)
        end = node.attrs.get("end", len(shape))
        return shape[start:end]

    def op_Reshape(self, node, xs):
        x, shape = xs
        shape = [int(s) for s in _np(shape)]
        cur = list(self._shape(x))
        shape = [
            cur[i] if s == 0 and node.attrs.get("allowzero", 0) == 0 else s
            for i, s in enumerate(shape)
        ]
        if _is_static(x):
            return _np(x).reshape(shape)
        return x.reshape(shape)

    def op_Transpose(self, node, xs):
        perm = node.attrs.get("perm")
        x = xs[0]
        if _is_static(x):
            return np.transpose(_np(x), perm)
        return x.permute(*(perm if perm is not None else range(x.ndim - 1, -1, -1)))

    def op_Concat(self, node, xs):
        axis = node.attrs["axis"]
        if self._static_all(xs):
            return np.concatenate([_np(x) for x in xs], axis=axis)
        return torch.cat(_promote(*[self._dev(x) for x in xs]), dim=axis)

    def op_Split(self, node, xs):
        x = xs[0]
        axis = node.attrs.get("axis", 0)
        xs_shape = self._shape(x)
        if len(xs) > 1 and xs[1] is not None:
            sizes = [int(s) for s in _np(xs[1])]
        elif "split" in node.attrs:
            sizes = list(node.attrs["split"])
        else:
            n = len(node.outputs)
            sizes = [xs_shape[axis] // n] * n
        idx = np.cumsum(sizes)[:-1].tolist()
        if _is_static(x):
            return tuple(np.split(_np(x), idx, axis=axis))
        return tuple(torch.tensor_split(x, idx, dim=axis))

    def op_Slice(self, node, xs):
        x = xs[0]
        shape = list(self._shape(x))
        rank = len(shape)
        if len(xs) > 1:  # opset >= 10: starts/ends/axes/steps inputs
            starts = [int(v) for v in _np(xs[1])]
            ends = [int(v) for v in _np(xs[2])]
            axes = (
                [int(v) for v in _np(xs[3])]
                if len(xs) > 3 and xs[3] is not None
                else list(range(len(starts)))
            )
            steps = (
                [int(v) for v in _np(xs[4])]
                if len(xs) > 4 and xs[4] is not None
                else [1] * len(starts)
            )
        else:
            starts = list(node.attrs["starts"])
            ends = list(node.attrs["ends"])
            axes = list(node.attrs.get("axes", range(len(starts))))
            steps = [1] * len(starts)
        slices = [slice(None)] * rank
        for st, en, ax, sp in zip(starts, ends, axes, steps):
            ax = ax % rank
            slices[ax] = slice(st, en, sp)
        if _is_static(x):
            return _np(x)[tuple(slices)]
        for ax, s in enumerate(slices):
            if s == slice(None):
                continue
            start, stop, step = s.indices(shape[ax])
            if step > 0:
                x = x[(slice(None),) * ax + (slice(start, stop, step),)]
            else:  # torch slicing takes no negative step
                x = x.index_select(ax, torch.arange(start, stop, step, device=x.device))
        return x

    def op_Squeeze(self, node, xs):
        x = xs[0]
        axes = (
            [int(v) for v in _np(xs[1])]
            if len(xs) > 1 and xs[1] is not None
            else node.attrs.get("axes")
        )
        if _is_static(x):
            return np.squeeze(_np(x), tuple(axes) if axes else None)
        return x.squeeze(tuple(axes)) if axes else x.squeeze()

    def op_Unsqueeze(self, node, xs):
        x = xs[0]
        axes = (
            [int(v) for v in _np(xs[1])]
            if len(xs) > 1 and xs[1] is not None
            else list(node.attrs["axes"])
        )
        for ax in sorted(axes):
            x = np.expand_dims(_np(x), ax) if _is_static(x) else x.unsqueeze(ax)
        return x

    def op_Flatten(self, node, xs):
        x = xs[0]
        axis = node.attrs.get("axis", 1)
        shape = self._shape(x)
        lead = int(np.prod(shape[:axis])) if axis else 1
        if _is_static(x):
            return _np(x).reshape(lead, -1)
        return x.reshape(lead, -1)

    def op_Expand(self, node, xs):
        x, shape = xs
        target = [int(s) for s in _np(shape)]
        xshape = list(self._shape(x))
        # onnx Expand is bidirectional broadcast
        while len(xshape) < len(target):
            xshape.insert(0, 1)
        out = [max(a, b) for a, b in zip(xshape, target)]
        if _is_static(x):
            return np.broadcast_to(_np(x).reshape(xshape), out)
        return torch.broadcast_to(x.reshape(xshape), out)

    def op_Tile(self, node, xs):
        x, reps = xs
        reps = [int(r) for r in _np(reps)]
        if _is_static(x):
            return np.tile(_np(x), reps)
        return torch.tile(x, reps)

    def op_Range(self, node, xs):
        start, limit, delta = (int(_scalar(v)) for v in xs)
        return np.arange(start, limit, delta, np.int64)

    @staticmethod
    def _wrap(idx: torch.Tensor, n: int) -> torch.Tensor:
        idx = idx.long()
        return torch.where(idx < 0, idx + n, idx)

    def op_Gather(self, node, xs):
        x, idx = xs
        axis = node.attrs.get("axis", 0)
        if _is_static(x) and _is_static(idx):
            return np.take(_np(x), _np(idx).astype(np.int64), axis=axis)
        x, idx = self._dev(x), self._dev(idx)
        axis %= x.ndim
        flat = x.index_select(axis, self._wrap(idx, x.shape[axis]).reshape(-1))
        return flat.reshape(x.shape[:axis] + idx.shape + x.shape[axis + 1:])

    def op_GatherElements(self, node, xs):
        x, idx = self._dev(xs[0]), self._dev(xs[1])
        axis = node.attrs.get("axis", 0) % x.ndim
        return torch.gather(x, axis, self._wrap(idx, x.shape[axis]))

    def op_GatherND(self, node, xs):
        x, idx = xs
        if node.attrs.get("batch_dims", 0) != 0:
            raise NotImplementedError("GatherND batch_dims != 0")
        x = self._dev(x)
        idx = (torch.from_numpy(_np(idx).astype(np.int64)).to(self.device)
               if _is_static(idx) else idx.long())
        comps = tuple(idx[..., i] for i in range(idx.shape[-1]))
        return x[comps]

    def op_ConstantOfShape(self, node, xs):
        shape = [int(s) for s in _np(xs[0])]
        value = node.attrs.get("value")
        if value is None:
            return np.zeros(shape, np.float32)
        v = _np(value).ravel()[0]
        return np.full(shape, v, _np(value).dtype)

    def op_OneHot(self, node, xs):
        idx, depth, values = xs
        axis = node.attrs.get("axis", -1)
        depth = int(_scalar(depth))
        off, on = (_np(values) if _is_static(values) else values)
        idx = self._dev(idx).to(torch.int32)
        pos = axis % (idx.ndim + 1)
        classes = torch.arange(depth, dtype=torch.int32, device=idx.device)
        classes = classes.reshape([depth if d == pos else 1 for d in range(idx.ndim + 1)])
        # jax.nn.one_hot: float32, all zeros for an index outside [0, depth)
        oh = (idx.unsqueeze(pos) == classes).to(torch.float32)
        on, off = self._dev(on), self._dev(off)
        oh, diff = _promote(oh, on - off)
        prod, off = _promote(oh * diff, off)
        return prod + off

    def op_Where(self, node, xs):
        if self._static_all(xs):
            return np.where(_np(xs[0]), _np(xs[1]), _np(xs[2]))
        cond, a, b = (self._dev(x) for x in xs)
        a, b = _promote(a, b)
        return torch.where(cond.bool(), a, b)

    def op_Pad(self, node, xs):
        x = self._dev(xs[0])
        mode = node.attrs.get("mode", "constant")
        if len(xs) > 1:
            pads = [int(p) for p in _np(xs[1])]
            cval = float(_scalar(xs[2])) if len(xs) > 2 and xs[2] is not None else 0.0
        else:
            pads = list(node.attrs["pads"])
            cval = node.attrs.get("value", 0.0)
        rank = len(pads) // 2
        widths = [(pads[i], pads[i + rank]) for i in range(rank)]
        if mode not in ("constant", "reflect", "edge"):
            raise NotImplementedError(f"Pad mode {mode}")
        if mode == "constant":
            flat = [p for lo_hi in reversed(widths) for p in lo_hi]
            return F.pad(x, flat, value=cval)
        for ax, (lo, hi) in enumerate(widths):
            if not (lo or hi):
                continue
            n = x.shape[ax]
            pos = np.arange(-lo, n + hi)
            if mode == "edge" or n == 1:
                pos = np.clip(pos, 0, n - 1)
            else:  # numpy's reflect: mirrored about the edge pixels
                period = 2 * (n - 1)
                pos = np.abs(pos) % period
                pos = np.where(pos >= n, period - pos, pos)
            x = x.index_select(ax, torch.from_numpy(pos).to(x.device))
        return x

    # -- math --------------------------------------------------------------

    def op_Add(self, node, xs):
        return self._ew(np.add, _binary(torch.add), xs)

    def op_Sub(self, node, xs):
        return self._ew(np.subtract, _binary(torch.sub), xs)

    def op_Mul(self, node, xs):
        return self._ew(np.multiply, _binary(torch.mul), xs)

    def op_Div(self, node, xs):
        def np_div(a, b):
            if np.issubdtype(a.dtype, np.integer) and np.issubdtype(
                b.dtype, np.integer
            ):
                return a // b
            return a / b

        def torch_div(a, b):
            a, b = _promote(a, b)
            if not (a.dtype.is_floating_point or a.dtype == torch.bool):
                return torch.div(a, b, rounding_mode="floor")
            return a / b

        return self._ew(np_div, torch_div, xs)

    def op_Mod(self, node, xs):
        return self._ew(np.mod, _binary(_mod), xs)

    def op_Pow(self, node, xs):
        def torch_pow(a, b):
            if a.dtype.is_floating_point and not b.dtype.is_floating_point:
                return torch.pow(a, b)  # a float base keeps its dtype
            a, b = _promote(a, b)
            return torch.pow(a, b)

        return self._ew(np.power, torch_pow, xs)

    def op_Sqrt(self, node, xs):
        return self._ew(np.sqrt, torch.sqrt, xs)

    def op_Reciprocal(self, node, xs):
        return self._ew(lambda x: 1.0 / x, lambda x: 1.0 / x, xs)

    def op_Exp(self, node, xs):
        return self._ew(np.exp, torch.exp, xs)

    def op_Log(self, node, xs):
        return self._ew(np.log, torch.log, xs)

    def op_Erf(self, node, xs):
        return torch.erf(self._dev(xs[0]))

    def op_Tanh(self, node, xs):
        return self._ew(np.tanh, torch.tanh, xs)

    def op_Abs(self, node, xs):
        return self._ew(np.abs, torch.abs, xs)

    def op_Neg(self, node, xs):
        return self._ew(np.negative, torch.neg, xs)

    def op_Floor(self, node, xs):
        return self._ew(np.floor, torch.floor, xs)

    def op_Ceil(self, node, xs):
        return self._ew(np.ceil, torch.ceil, xs)

    def op_Round(self, node, xs):
        return self._ew(np.round, torch.round, xs)

    def op_Sign(self, node, xs):
        return self._ew(np.sign, torch.sign, xs)

    def op_Min(self, node, xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._ew(np.minimum, _binary(torch.minimum), [out, x])
        return out

    def op_Max(self, node, xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._ew(np.maximum, _binary(torch.maximum), [out, x])
        return out

    def op_Sum(self, node, xs):
        out = xs[0]
        for x in xs[1:]:
            out = self._ew(np.add, _binary(torch.add), [out, x])
        return out

    def op_Clip(self, node, xs):
        x = self._dev(xs[0])
        lo = (
            xs[1]
            if len(xs) > 1 and xs[1] is not None
            else node.attrs.get("min")
        )
        hi = (
            xs[2]
            if len(xs) > 2 and xs[2] is not None
            else node.attrs.get("max")
        )
        if lo is not None:
            x = torch.maximum(x, self._const(lo, x.dtype))
        if hi is not None:
            x = torch.minimum(x, self._const(hi, x.dtype))
        return x

    def op_Equal(self, node, xs):
        return self._ew(np.equal, _binary(torch.eq), xs)

    def op_Greater(self, node, xs):
        return self._ew(np.greater, _binary(torch.gt), xs)

    def op_GreaterOrEqual(self, node, xs):
        return self._ew(np.greater_equal, _binary(torch.ge), xs)

    def op_Less(self, node, xs):
        return self._ew(np.less, _binary(torch.lt), xs)

    def op_LessOrEqual(self, node, xs):
        return self._ew(np.less_equal, _binary(torch.le), xs)

    def op_Not(self, node, xs):
        return self._ew(np.logical_not, torch.logical_not, xs)

    def op_And(self, node, xs):
        return self._ew(np.logical_and, torch.logical_and, xs)

    def op_Or(self, node, xs):
        return self._ew(np.logical_or, torch.logical_or, xs)

    # -- activations / normalization ----------------------------------------

    def op_Relu(self, node, xs):
        return torch.relu(self._dev(xs[0]))

    def op_LeakyRelu(self, node, xs):
        x = self._dev(xs[0])
        return torch.where(x >= 0, x, node.attrs.get("alpha", 0.01) * x)

    def op_PRelu(self, node, xs):
        x, slope = self._dev(xs[0]), self._dev(xs[1])
        if slope.ndim == 1 and x.ndim == 4:  # per-channel NCHW
            slope = slope.reshape(1, -1, 1, 1)
        return torch.where(x >= 0, x, x * slope)

    def op_Sigmoid(self, node, xs):
        return torch.sigmoid(self._dev(xs[0]))

    def op_HardSigmoid(self, node, xs):
        alpha = node.attrs.get("alpha", 0.2)
        beta = node.attrs.get("beta", 0.5)
        return torch.clamp(alpha * self._dev(xs[0]) + beta, 0.0, 1.0)

    def op_HardSwish(self, node, xs):
        x = self._dev(xs[0])
        return x * torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)

    def op_Softplus(self, node, xs):
        x = self._dev(xs[0])
        return torch.logaddexp(x, torch.zeros_like(x))

    def op_Gelu(self, node, xs):
        approx = node.attrs.get("approximate", "none") == "tanh"
        return F.gelu(self._dev(xs[0]), approximate="tanh" if approx else "none")

    def op_Softmax(self, node, xs):
        axis = node.attrs.get("axis", -1)
        return torch.softmax(self._dev(xs[0]), dim=axis)

    def op_LogSoftmax(self, node, xs):
        axis = node.attrs.get("axis", -1)
        return torch.log_softmax(self._dev(xs[0]), dim=axis)

    def op_BatchNormalization(self, node, xs):
        x, scale, bias, mean, var = (self._dev(v) for v in xs[:5])
        eps = node.attrs.get("epsilon", 1e-5)
        shape = [1, -1] + [1] * (x.ndim - 2)
        inv = torch.rsqrt(var + eps)
        return (x - mean.reshape(shape)) * (inv * scale).reshape(
            shape
        ) + bias.reshape(shape)

    def op_LayerNormalization(self, node, xs):
        x = self._dev(xs[0])
        scale = self._dev(xs[1])
        bias = self._dev(xs[2]) if len(xs) > 2 and xs[2] is not None else None
        axis = node.attrs.get("axis", -1)
        eps = node.attrs.get("epsilon", 1e-5)
        mean = x.mean(dim=axis, keepdim=True)
        var = x.var(dim=axis, keepdim=True, correction=0)
        out = (x - mean) * torch.rsqrt(var + eps) * scale
        return out + bias if bias is not None else out

    def op_InstanceNormalization(self, node, xs):
        x, scale, bias = (self._dev(v) for v in xs)
        eps = node.attrs.get("epsilon", 1e-5)
        axes = tuple(range(2, x.ndim))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, correction=0)
        shape = [1, -1] + [1] * (x.ndim - 2)
        return (x - mean) * torch.rsqrt(var + eps) * scale.reshape(
            shape
        ) + bias.reshape(shape)

    # -- reductions ----------------------------------------------------------

    def _reduce(self, fn_np, fn_torch, node, xs):
        x = xs[0]
        axes = (
            tuple(int(a) for a in _np(xs[1]))
            if len(xs) > 1 and xs[1] is not None
            else (
                tuple(node.attrs["axes"])
                if "axes" in node.attrs
                else None
            )
        )
        keep = bool(node.attrs.get("keepdims", 1))
        if _is_static(x):
            return fn_np(_np(x), axis=axes, keepdims=keep)
        if axes is None:
            axes = tuple(range(x.ndim))
        return fn_torch(x, axes, keep)

    @staticmethod
    def _t_sum(x, axes, keep):
        # numpy's axis=() reduces nothing
        out = torch.sum(_widened(x), dim=axes, keepdim=keep) if axes else x
        return _narrowed(out, x)

    @staticmethod
    def _t_mean(x, axes, keep):
        if not x.dtype.is_floating_point:
            x = x.to(torch.float32)
        return x if not axes else torch.mean(x, dim=axes, keepdim=keep)

    @staticmethod
    def _t_prod(x, axes, keep):
        out = _widened(x)
        for ax in sorted((a % x.ndim for a in axes), reverse=True):
            out = torch.prod(out, dim=ax, keepdim=keep)
        return _narrowed(out, x)

    @staticmethod
    def _t_max(x, axes, keep):
        return x if not axes else torch.amax(x, dim=axes, keepdim=keep)

    @staticmethod
    def _t_min(x, axes, keep):
        return x if not axes else torch.amin(x, dim=axes, keepdim=keep)

    def op_ReduceMean(self, node, xs):
        return self._reduce(np.mean, self._t_mean, node, xs)

    def op_ReduceSum(self, node, xs):
        return self._reduce(np.sum, self._t_sum, node, xs)

    def op_ReduceMax(self, node, xs):
        return self._reduce(np.max, self._t_max, node, xs)

    def op_ReduceMin(self, node, xs):
        return self._reduce(np.min, self._t_min, node, xs)

    def op_ReduceProd(self, node, xs):
        return self._reduce(np.prod, self._t_prod, node, xs)

    def op_ArgMax(self, node, xs):
        axis = node.attrs.get("axis", 0)
        keep = bool(node.attrs.get("keepdims", 1))
        out = torch.argmax(self._dev(xs[0]), dim=axis).to(torch.int32)
        return out.unsqueeze(axis) if keep else out

    def op_TopK(self, node, xs):
        x = self._dev(xs[0])
        k = int(_scalar(xs[1]))
        axis = node.attrs.get("axis", -1)
        largest = node.attrs.get("largest", 1)
        # a stable descending sort: the lower index first among equal
        # values, as jax.lax.top_k orders them
        vals, idx = torch.sort(x if largest else -x, dim=axis, descending=True, stable=True)
        vals, idx = vals.narrow(axis, 0, k), idx.narrow(axis, 0, k)
        if not largest:
            vals = -vals
        return vals, idx.to(torch.int32)

    def op_CumSum(self, node, xs):
        axis = int(_scalar(xs[1]))
        x = self._dev(xs[0])
        # jnp.cumsum keeps an integer dtype; bool counts in int32
        return torch.cumsum(x, dim=axis, dtype=torch.int32 if x.dtype == torch.bool else x.dtype)

    # -- linear algebra -------------------------------------------------------

    def op_MatMul(self, node, xs):
        a, b = _promote(self._dev(xs[0]), self._dev(xs[1]))
        return torch.matmul(a, b)

    def op_Gemm(self, node, xs):
        a, b = _promote(self._dev(xs[0]), self._dev(xs[1]))
        if node.attrs.get("transA", 0):
            a = a.T
        if node.attrs.get("transB", 0):
            b = b.T
        out = node.attrs.get("alpha", 1.0) * (a @ b)
        if len(xs) > 2 and xs[2] is not None:
            out = out + node.attrs.get("beta", 1.0) * self._dev(xs[2])
        return out

    def op_Einsum(self, node, xs):
        return torch.einsum(node.attrs["equation"],
                            *_promote(*[self._dev(x) for x in xs]))

    # -- convolution / pooling -------------------------------------------------

    @staticmethod
    def _conv_pads(node, x_shape, k_shape, strides, dilations):
        spatial = len(k_shape) - 2
        auto = node.attrs.get("auto_pad", "NOTSET")
        if auto in ("NOTSET", ""):
            pads = node.attrs.get("pads", [0] * 2 * spatial)
            return [
                (pads[i], pads[i + spatial]) for i in range(spatial)
            ]
        if auto == "VALID":
            return [(0, 0)] * spatial
        # SAME_UPPER / SAME_LOWER
        out = []
        for i in range(spatial):
            in_sz = x_shape[2 + i]
            k = (k_shape[2 + i] - 1) * dilations[i] + 1
            o = -(-in_sz // strides[i])
            total = max(0, (o - 1) * strides[i] + k - in_sz)
            lo = total // 2
            hi = total - lo
            out.append((lo, hi) if auto == "SAME_UPPER" else (hi, lo))
        return out

    @staticmethod
    def _pad_spatial(x: torch.Tensor, pads, value: float = 0.0) -> torch.Tensor:
        """``pads`` [(lo, hi)] per spatial dim, applied with F.pad."""
        if not any(lo or hi for lo, hi in pads):
            return x
        flat = [p for lo_hi in reversed(pads) for p in lo_hi]
        return F.pad(x, flat, value=value)

    def op_Conv(self, node, xs):
        x = self._dev(xs[0])
        w = self._dev(xs[1])
        spatial = w.ndim - 2
        if spatial not in (1, 2):
            raise NotImplementedError(f"{spatial}-d Conv")
        strides = node.attrs.get("strides", [1] * spatial)
        dilations = node.attrs.get("dilations", [1] * spatial)
        groups = node.attrs.get("group", 1)
        pads = self._conv_pads(node, x.shape, w.shape, strides, dilations)
        conv = F.conv2d if spatial == 2 else F.conv1d
        if all(lo == hi >= 0 for lo, hi in pads):
            padding = [lo for lo, _ in pads]
        else:  # asymmetric (SAME_UPPER / SAME_LOWER, explicit pads)
            x, padding = self._pad_spatial(x, pads), 0
        out = conv(x, w, None, strides, padding, dilations, groups)
        if len(xs) > 2 and xs[2] is not None:
            b = self._dev(xs[2]).reshape((1, -1) + (1,) * spatial)
            out = out + b
        return out

    def op_ConvTranspose(self, node, xs):
        x = self._dev(xs[0])
        w = self._dev(xs[1])  # (Cin, Cout/groups, kH, kW)
        spatial = w.ndim - 2
        if spatial not in (1, 2):
            raise NotImplementedError(f"{spatial}-d ConvTranspose")
        strides = node.attrs.get("strides", [1] * spatial)
        dilations = node.attrs.get("dilations", [1] * spatial)
        groups = node.attrs.get("group", 1)
        if groups != 1:
            raise NotImplementedError("grouped ConvTranspose")
        pads = node.attrs.get("pads", [0] * 2 * spatial)
        out_pads = node.attrs.get("output_padding", [0] * spatial)
        conv_t = F.conv_transpose2d if spatial == 2 else F.conv_transpose1d
        # the full transposed convolution, then output_padding zeros on
        # the high side and the pads cropped from both sides
        out = conv_t(x, w, None, strides, 0, 0, 1, dilations)
        out = self._pad_spatial(out, [(-pads[i], out_pads[i] - pads[i + spatial])
                                      for i in range(spatial)])
        if len(xs) > 2 and xs[2] is not None:
            out = out + self._dev(xs[2]).reshape((1, -1) + (1,) * spatial)
        return out

    @staticmethod
    def _window(x: torch.Tensor, k, strides, dilations, kind: str) -> torch.Tensor:
        """Max or sum over windows of an already padded input (no padding,
        floor mode)."""
        spatial = len(k)
        if spatial == 2 and all(d == 1 for d in dilations):
            if kind == "max":
                return F.max_pool2d(x, k, strides)
            return F.avg_pool2d(x, k, strides, divisor_override=1)
        if spatial == 2 and kind == "max":
            return F.max_pool2d(x, k, strides, 0, dilations)
        # any other rank or dilated sums: a strided slice per kernel offset
        outs = [(x.shape[2 + i] - (k[i] - 1) * dilations[i] - 1) // strides[i] + 1
                for i in range(spatial)]
        acc = None
        for offs in np.ndindex(*k):
            sl = tuple(
                slice(o * d, o * d + (n - 1) * s + 1, s)
                for o, d, n, s in zip(offs, dilations, outs, strides)
            )
            v = x[(slice(None), slice(None)) + sl]
            acc = v if acc is None else (torch.maximum(acc, v) if kind == "max" else acc + v)
        return acc

    def _pool(self, node, xs, kind: str):
        x = self._dev(xs[0])
        k = list(node.attrs["kernel_shape"])
        spatial = len(k)
        strides = node.attrs.get("strides", [1] * spatial)
        dilations = node.attrs.get("dilations", [1] * spatial)
        pads = self._conv_pads(
            node, x.shape, [0, 0] + k, strides, dilations
        )
        ceil_mode = node.attrs.get("ceil_mode", 0)
        if ceil_mode:
            new_pads = []
            for i in range(spatial):
                in_sz = x.shape[2 + i] + pads[i][0] + pads[i][1]
                kk = (k[i] - 1) * dilations[i] + 1
                rem = (in_sz - kk) % strides[i]
                extra = (strides[i] - rem) % strides[i] if rem else 0
                new_pads.append((pads[i][0], pads[i][1] + extra))
            pads = new_pads
        fill = -math.inf if kind == "max" else 0.0
        out = self._window(self._pad_spatial(x, pads, fill), k, strides, dilations, kind)
        if kind == "avg":
            if node.attrs.get("count_include_pad", 0) or not any(
                p != (0, 0) for p in pads
            ):
                out = out / int(np.prod(k))
            else:
                ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype, device=x.device)
                counts = self._window(self._pad_spatial(ones, pads), k, strides, dilations, "avg")
                out = out / counts
        return out

    def op_MaxPool(self, node, xs):
        return self._pool(node, xs, "max")

    def op_AveragePool(self, node, xs):
        return self._pool(node, xs, "avg")

    def op_GlobalAveragePool(self, node, xs):
        x = self._dev(xs[0])
        return x.mean(dim=tuple(range(2, x.ndim)), keepdim=True)

    def op_GlobalMaxPool(self, node, xs):
        x = self._dev(xs[0])
        return x.amax(dim=tuple(range(2, x.ndim)), keepdim=True)

    # -- resize / sampling ------------------------------------------------------

    def _resize(self, x: torch.Tensor, sizes: list[int], method: str) -> torch.Tensor:
        """``jax.image.resize(x, sizes, method)``: each axis whose size
        changes, one after another."""
        if method == "nearest":
            for d, (m, n) in enumerate(zip(x.shape, sizes)):
                if m != n:
                    idx = torch.from_numpy(nearest_indices(m, n)).to(x.device)
                    x = x.index_select(d, idx)
            return x
        if not x.dtype.is_floating_point:
            x = x.to(torch.float32)
        for d, (m, n) in enumerate(zip(tuple(x.shape), sizes)):
            if m == n:
                continue
            key = (m, n, method, x.dtype, x.device)
            w = self._resize_cache.get(key)
            if w is None:
                w = torch.from_numpy(resize_weights(m, n, method)).to(x.device, x.dtype)
                self._resize_cache[key] = w
            x = torch.matmul(x.movedim(d, -1), w).movedim(-1, d)
        return x

    def op_Resize(self, node, xs):
        x = self._dev(xs[0])
        mode = node.attrs.get("mode", "nearest")
        coord = node.attrs.get("coordinate_transformation_mode", "half_pixel")
        sizes = None
        if len(xs) > 3 and xs[3] is not None:
            sizes = [int(s) for s in _np(xs[3])]
        elif len(xs) > 2 and xs[2] is not None and _np(xs[2]).size:
            scales = [float(s) for s in _np(xs[2])]
            sizes = [
                int(round(d * s)) for d, s in zip(x.shape, scales)
            ]
        if sizes is None:
            raise NotImplementedError("Resize without sizes/scales")
        if mode == "nearest":
            method = "nearest"
        elif mode == "linear":
            method = "bilinear"
        elif mode == "cubic":
            method = "bicubic"
        else:
            raise NotImplementedError(f"Resize mode {mode}")
        if mode == "nearest" and coord in ("asymmetric",):
            b, c, h, w = x.shape
            oh, ow = sizes[2], sizes[3]
            rows = (np.arange(oh) * (h / oh)).astype(np.int32)
            cols = (np.arange(ow) * (w / ow)).astype(np.int32)
            rows_t = torch.from_numpy(rows.astype(np.int64)).to(x.device)
            cols_t = torch.from_numpy(cols.astype(np.int64)).to(x.device)
            return x.index_select(2, rows_t).index_select(3, cols_t)
        return self._resize(x, sizes, method)

    def op_GridSample(self, node, xs):
        x = self._dev(xs[0])  # (N, C, H, W)
        grid = self._dev(xs[1])  # (N, Ho, Wo, 2) in [-1, 1]
        mode = node.attrs.get("mode", "bilinear")
        if mode not in ("bilinear", "linear"):
            raise NotImplementedError(f"GridSample mode {mode}")
        align = node.attrs.get("align_corners", 0)
        n, c, h, w = x.shape
        gx = grid[..., 0]
        gy = grid[..., 1]
        if align:
            fx = (gx + 1) * 0.5 * (w - 1)
            fy = (gy + 1) * 0.5 * (h - 1)
        else:
            fx = ((gx + 1) * w - 1) * 0.5
            fy = ((gy + 1) * h - 1) * 0.5
        x0 = torch.floor(fx)
        y0 = torch.floor(fy)
        wx = fx - x0
        wy = fy - y0
        flat = x.reshape(n, c, h * w)

        def sample(ix, iy):
            inb = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
            ixc = torch.clamp(ix, 0, w - 1).long()
            iyc = torch.clamp(iy, 0, h - 1).long()
            lin = (iyc * w + ixc).reshape(n, -1)
            vals = torch.gather(flat, 2, lin[:, None, :].expand(n, c, lin.shape[1]))
            vals = vals.reshape((n, c) + tuple(ix.shape[1:]))
            return vals * inb[:, None].to(x.dtype)

        v00 = sample(x0, y0)
        v01 = sample(x0 + 1, y0)
        v10 = sample(x0, y0 + 1)
        v11 = sample(x0 + 1, y0 + 1)
        wx = wx[:, None]
        wy = wy[:, None]
        return (
            v00 * (1 - wx) * (1 - wy)
            + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy
            + v11 * wx * wy
        )

    # -- control flow -----------------------------------------------------------

    def op_If(self, node, xs):
        outer = dict(self._env)
        then_g = node.attrs["then_branch"]
        else_g = node.attrs["else_branch"]
        cond = xs[0]
        if _is_static(cond):
            # only the taken branch runs, its outputs as they come
            g = then_g if bool(_np(cond)) else else_g
            return tuple(self._run_subgraph(g, [], outer))
        # a device condition: read on the host, outputs on the device
        g = then_g if bool(cond.reshape(())) else else_g
        return tuple(self._dev(o) for o in self._run_subgraph(g, [], outer))

    def op_Loop(self, node, xs):
        """ONNX Loop with the JAX interpreter's lax.while_loop semantics.

        Requires a static max trip count M. Carried values keep the dtype
        they start with. Scan outputs are stacked into length-M buffers;
        iterations past the data-dependent exit keep their zero padding —
        ONNX proper truncates to the trip count, so consumers see padded
        rows where onnxruntime would see fewer. The exit condition is
        read on the host after each step.
        """
        outer = dict(self._env)
        body = node.attrs["body"]
        m_in = xs[0] if xs else None
        cond_in = xs[1] if len(xs) > 1 else None
        if m_in is None or not _is_static(m_in):
            raise NotImplementedError(
                "Loop requires a static max trip count"
            )
        m = int(_scalar(m_in))
        carried = tuple(self._dev(c) for c in xs[2:])
        n_c = len(carried)
        n_scan = len(node.outputs) - n_c
        cond = self._dev(True if cond_in is None else cond_in).reshape(()).bool()

        def body_call(i, cond, carried):
            it = torch.tensor(i, dtype=torch.int32, device=self.device)
            outs = self._run_subgraph(body, [it, cond] + list(carried), outer)
            cond_out = outs[0]
            if cond_out is None:  # empty cond output name: run all M
                cond_out = cond
            new_carried = tuple(
                self._dev(o).to(c.dtype)
                for o, c in zip(outs[1 : 1 + n_c], carried)
            )
            scans = tuple(self._dev(o) for o in outs[1 + n_c :])
            return self._dev(cond_out).reshape(()).bool(), new_carried, scans

        bufs = None
        i = 0
        while i < m and bool(cond):
            cond, carried, scans = body_call(i, cond, carried)
            if bufs is None:
                bufs = tuple(torch.zeros((m,) + tuple(s.shape), dtype=s.dtype, device=s.device)
                             for s in scans)
            for b, v in zip(bufs, scans):
                b[i] = v
            i += 1
        if bufs is None:
            # no step ran: one body call only for the scan outputs' shapes
            _, _, scans = body_call(0, cond, carried)
            bufs = tuple(torch.zeros((m,) + tuple(s.shape), dtype=s.dtype, device=s.device)
                         for s in scans)
        assert n_scan == len(bufs)
        return tuple(carried) + tuple(bufs)


def _static_float_operands(model) -> set[str]:
    """Names feeding shape-like float inputs (Resize scales/sizes), which
    stay static on the host even though they are float initializers —
    real exports (UNET upsample paths) ship Resize scales as float32
    initializers, not graph constants. Recurses into If/Loop subgraphs:
    a branch may consume an outer-scope initializer."""
    names: set[str] = set()
    for node in model.nodes:
        if node.op_type == "Resize":
            for idx in (2, 3):
                if len(node.inputs) > idx and node.inputs[idx]:
                    names.add(node.inputs[idx])
        for v in node.attrs.values():
            if hasattr(v, "nodes"):  # subgraph attribute
                names |= _static_float_operands(v)
    return names


class OnnxTorchFunction:
    """A callable over an ONNX graph on ``device``: fn(*arrays) -> the
    graph's outputs as numpy arrays, in the dtypes the JAX package's
    ``OnnxJaxFunction`` returns.

    Float initializers go to the device once, here; integer and bool
    initializers (and float Resize operands) stay static numpy so
    Shape/Reshape/Slice chains resolve on the host.
    """

    def __init__(self, model: OnnxModel, preproc: dict | None = None,
                 device: str | torch.device | None = None):
        """`preproc` maps input name -> device-side fn applied before the
        ONNX ops, so callers ship uint8 and normalise on the device."""
        self.model = model
        self.device = resolve_device(device)
        self.executor = _Executor(model, self.device)
        self.preproc: dict[str, Callable] = preproc or {}
        self.params: dict[str, torch.Tensor] = {}
        self.static: dict[str, np.ndarray] = {}
        force_static = _static_float_operands(model)
        for k, v in model.initializers.items():
            arr = np.asarray(v)
            if np.issubdtype(arr.dtype, np.floating) and k not in force_static:
                self.params[k] = self.executor._dev(arr)
            else:
                self.static[k] = arr

    @classmethod
    def from_file(cls, path, preproc: dict | None = None,
                  device: str | torch.device | None = None) -> "OnnxTorchFunction":
        return cls(read_onnx_model(path), preproc=preproc, device=device)

    @property
    def input_names(self):
        return self.model.input_names

    def __call__(self, *arrays) -> list[np.ndarray]:
        key = tuple((n, tuple(v.shape), str(v.dtype)) if isinstance(v, torch.Tensor)
                    else (n, tuple(np.shape(v)), str(np.asarray(v).dtype))
                    for n, v in zip(self.model.input_names, arrays))
        return flops.track(getattr(self, "name", "onnx"), self._run, arrays, sig=key,
                           weights=self.params)

    def _run(self, *arrays) -> list[np.ndarray]:
        with torch.inference_mode():
            inputs = {}
            for k, v in zip(self.model.input_names, arrays):
                v = self.executor._dev(v)
                inputs[k] = self.preproc[k](v) if k in self.preproc else v
            out = self.executor.run({**self.static, **self.params}, inputs)
            return [_to_numpy(o) for o in out]
