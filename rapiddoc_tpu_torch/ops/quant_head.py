"""Int8-weight fused projection head: quantized matmul + argmax.

Port of K2, the Pallas kernel ``rapiddoc_tpu/ops/quant_head.py:50``
(``_kernel``, launched at ``:113`` by ``fused_argmax_int8``), with its
host helper ``quantize_weight_int8`` (``:41``). Greedy decode needs only
each row's argmax id and its softmax probability, so the (N, V) logits
are never written out, and the weight is stored int8 with a per-column
fp32 scale applied after the dot. The CUDA kernel is
``csrc/quant_head.cu``; its header says what bounds it on the H100 and
how its design answers that.

The wrapper takes the kernel for CUDA tensors and the plain PyTorch
version below for CPU tensors; it does no other fallback. Either way it
adds the kernel's 2·N·K·V FLOPs to an open counting pass
(``engine/flops.py``) and runs the plain version uncounted.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..engine import flops
from .build import load
from .layout import with_aligned_rows

TILE_V = 128  # vocabulary columns per tile, as in csrc/quant_head.cu
ROWS = 16  # rows per block: the mma's M, as in csrc/quant_head.cu
SMS = 132  # the H100's SMs: at most one block on each
MAX_K = 512  # the deepest x the kernel takes (the decoders' d_model), as in csrc/quant_head.cu

_VP = ctypes.c_void_p
_I = ctypes.c_int


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(K, V) float weight -> (int8 weight, float32 per-column scale),
    bit for bit as the JAX package computes them: fp32 division, round
    half to even, clip to [-127, 127]."""
    w = w.to(torch.float32)
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    q = torch.clamp(torch.round(w / scale[None, :]), -127, 127).to(torch.int8)
    return q, scale


def quant_argmax_plain(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: bf16 x times bf16(wq) in
    fp32, then ``* scale + bias``, the argmax (first maximum on ties) and
    its softmax probability in fp32. x (N, K); wq (K, V) int8; scale and
    bias (V,)."""
    xb = x.to(torch.bfloat16).float()
    wb = wq.to(torch.bfloat16).float()
    logits = (xb @ wb) * scale.float() + bias.float()
    ids = torch.argmax(logits, dim=-1)
    top = logits.gather(-1, ids[:, None])
    denom = torch.exp(logits - top).sum(-1)
    return ids.to(torch.int32), 1.0 / torch.clamp(denom, min=1e-30)


class Schedule(NamedTuple):
    """How the kernel splits the TILE_V-column vocabulary tiles of each
    16-row block between ``n_blocks`` blocks, in one launch: block b takes
    tiles b, b + n_blocks, b + 2 n_blocks, ..., at most
    ``tiles_per_block``. With several blocks each writes its triples to
    scratch and the last one to finish merges them; one block needs
    neither: it writes ids and conf itself."""

    n_blocks: int
    tiles_per_block: int

    @property
    def merge(self) -> bool:
        return self.n_blocks > 1


def schedule(n: int, v: int) -> Schedule:
    """At most one block per SM: the vocabulary tiles split between as
    many blocks as there are SMs for each 16-row block, with no empty
    block."""
    n_tiles = -(-v // TILE_V)
    row_blocks = -(-n // ROWS)
    n_blocks = max(1, min(n_tiles, SMS // row_blocks))
    return Schedule(n_blocks, -(-n_tiles // n_blocks))


def _launcher():
    lib = load("quant_head")
    fn = lib.quant_head_launch
    if fn.argtypes is None:
        if lib.quant_head_max_k() != MAX_K:
            raise RuntimeError(
                f"csrc/quant_head.cu takes K <= {lib.quant_head_max_k()}, not MAX_K = {MAX_K}"
            )
        fn.argtypes = [_VP] * 10 + [_I] * 7 + [_VP]
        fn.restype = _I
    return fn


_tickets: dict[tuple, torch.Tensor] = {}


def tickets(device: torch.device, stream: int, count: int) -> torch.Tensor:
    """Zeroed uint32 counters, one per 16-row block, kept per device and
    stream: the kernel's last block of each row block merges the blocks'
    triples and sets its counter back to zero, so launches on one stream
    reuse them in order."""
    key = (device, stream)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 64), dtype=torch.int32, device=device)
        _tickets[key] = buf
    return buf


def fused_argmax_int8(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, K) features; wq (K, V) int8; scale (V,); bias (V,).
    Returns (argmax ids (N,) int32, softmax prob of the argmax (N,) fp32).
    The kernel reads x and wq in place where their rows start on 16 bytes
    (wq from ``layout.aligned_rows``, x of depth K = 512); other layouts
    are copied so per call.

    CPU tensors take :func:`quant_argmax_plain`; CUDA tensors launch the
    kernel (x cast to bf16, scale and bias to fp32) and raise if the
    launch fails."""
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1 or bias.dim() != 1:
        raise ValueError(
            f"expected x (N, K), wq (K, V), scale (V,), bias (V,); got "
            f"{tuple(x.shape)}, {tuple(wq.shape)}, {tuple(scale.shape)}, "
            f"{tuple(bias.shape)}"
        )
    n, k = x.shape
    v = wq.shape[1]
    if wq.shape[0] != k or scale.shape[0] != v or bias.shape[0] != v:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
            f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)}"
        )
    if wq.dtype != torch.int8:
        raise ValueError(f"wq must be int8, got {wq.dtype}")
    flops.add_flops(2 * n * k * v)
    if x.device.type == "cpu":
        with flops.uncounted():
            return quant_argmax_plain(x, wq, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t.device != x.device for t in (wq, scale, bias)):
        raise ValueError("x, wq, scale and bias must be on one device")
    if k > MAX_K:
        raise ValueError(f"K = {k} exceeds the kernel's largest depth {MAX_K}")
    xb = with_aligned_rows(x, torch.bfloat16)
    wq = with_aligned_rows(wq, torch.int8)
    sf = scale.to(torch.float32).contiguous()
    bf = bias.to(torch.float32).contiguous()
    plan = schedule(n, v)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    parts = [None] * 4
    if plan.merge:
        parts = [torch.empty((plan.n_blocks, n), dtype=dt, device=x.device)
                 for dt in (torch.float32, torch.int32, torch.float32)]
        parts.append(tickets(x.device, stream, -(-n // ROWS)))
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    conf = torch.empty((n,), dtype=torch.float32, device=x.device)
    rc = _launcher()(
        xb.data_ptr(), wq.data_ptr(), sf.data_ptr(), bf.data_ptr(),
        *(p.data_ptr() if p is not None else None for p in parts[:3]),
        ids.data_ptr(), conf.data_ptr(),
        parts[3].data_ptr() if parts[3] is not None else None,
        n, k, v, xb.stride(0), wq.stride(0), plan.n_blocks, plan.tiles_per_block, stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_head kernel launch failed: CUDA error {rc}")
    fused_argmax_int8.launches += 1
    return ids, conf


fused_argmax_int8.launches = 0
