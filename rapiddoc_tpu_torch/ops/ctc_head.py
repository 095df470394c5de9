"""Fused CTC head: vocabulary projection + argmax + softmax prob per frame.

Port of K1, the Pallas kernel ``rapiddoc_tpu/ops/ctc_head.py:30``
(``_kernel``, launched at ``:90`` by ``fused_ctc_argmax``). Greedy CTC
needs only each frame's argmax id and its softmax probability, so the
(N, V) logits are never written out. The CUDA kernel is
``csrc/ctc_head.cu``; its header says what bounds it on the H100 and how
its design answers that.

The wrapper takes the kernel for CUDA tensors and the plain PyTorch
version below for CPU tensors; it does no other fallback. Either way it
adds the kernel's 2·N·C·V FLOPs to an open counting pass
(``engine/flops.py``) and runs the plain version uncounted.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..engine import flops
from .build import load
from .layout import aligned_rows, with_aligned_rows

TM = 128  # rows per block, as in csrc/ctc_head.cu
TV = 64  # vocabulary columns per tile, as in csrc/ctc_head.cu
SMS = 132  # the H100's SMs
TARGET_BLOCKS = 20 * SMS  # ten waves of two blocks per SM
MIN_TILES_PER_RANGE = 4  # a shorter range costs more in its prologue and merge than it gains
MAX_C = 256  # the widest x the kernel's shared memory holds, as in csrc/ctc_head.cu

_VP = ctypes.c_void_p
_I = ctypes.c_int


def ctc_argmax_plain(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: bf16 inputs, fp32 product
    and softmax. Ties go to the lowest index (``argmax`` returns the
    first maximum). x (N, C); kernel (C, V); bias (V,)."""
    xb = x.to(torch.bfloat16).float()
    wb = kernel.to(torch.bfloat16).float()
    logits = xb @ wb + bias.float()
    ids = torch.argmax(logits, dim=-1)
    top = logits.gather(-1, ids[:, None])
    denom = torch.exp(logits - top).sum(-1)
    return ids.to(torch.int32), 1.0 / torch.clamp(denom, min=1e-30)


class Schedule(NamedTuple):
    """How the kernel cuts the vocabulary: ``n_ranges`` contiguous ranges
    of ``tiles_per_range`` TV-column tiles, one block each per TM rows.
    Range r holds tiles r * tiles_per_range up to the next range's first
    or the last tile. One range needs no merge launch: the block writes
    ids and conf itself."""

    n_ranges: int
    tiles_per_range: int

    @property
    def merge(self) -> bool:
        return self.n_ranges > 1


def schedule(n: int, v: int) -> Schedule:
    """Enough contiguous vocabulary ranges to give the card about
    TARGET_BLOCKS blocks, none shorter than MIN_TILES_PER_RANGE tiles
    (so a vocabulary of up to that many tiles is one range) and none
    empty."""
    n_tiles = -(-v // TV)
    row_tiles = -(-n // TM)
    n_ranges = max(1, min(n_tiles, -(-TARGET_BLOCKS // row_tiles)))
    per = max(-(-n_tiles // n_ranges), min(MIN_TILES_PER_RANGE, n_tiles))
    return Schedule(-(-n_tiles // per), per)


def _launcher():
    fn = load("ctc_head").ctc_head_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 8 + [_I] * 7 + [_VP]
        fn.restype = _I
    return fn


def pad_ctc_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The (C, V) head weight in bf16 with 16-byte aligned rows, as the
    kernel reads it fastest; made once per weight by the recognizer."""
    return aligned_rows(kernel, torch.bfloat16)


def fused_ctc_argmax(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, C) features; kernel (C, V); bias (V,).
    Returns (ids (N,) int32, top softmax prob (N,) float32).

    CPU tensors take :func:`ctc_argmax_plain`; CUDA tensors launch the
    kernel (x and kernel are cast to bf16, bias to fp32) and raise if the
    launch fails. The kernel reads x and the weight in place where their
    rows start on 16 bytes (a bf16 ``kernel`` from :func:`pad_ctc_kernel`,
    x of width C = 120); other layouts are copied so per call."""
    if x.dim() != 2 or kernel.dim() != 2 or bias.dim() != 1:
        raise ValueError(
            f"expected x (N, C), kernel (C, V), bias (V,); got "
            f"{tuple(x.shape)}, {tuple(kernel.shape)}, {tuple(bias.shape)}"
        )
    n, c = x.shape
    if kernel.shape[0] != c or bias.shape[0] != kernel.shape[1]:
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, kernel "
            f"{tuple(kernel.shape)}, bias {tuple(bias.shape)}"
        )
    flops.add_flops(2 * n * c * kernel.shape[1])
    if x.device.type == "cpu":
        with flops.uncounted():
            return ctc_argmax_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("x, kernel and bias must be on one device")
    if c > MAX_C:
        raise ValueError(f"C = {c} exceeds the kernel's widest x, {MAX_C}")
    v = kernel.shape[1]
    xb = with_aligned_rows(x, torch.bfloat16)
    wb = with_aligned_rows(kernel, torch.bfloat16)
    bf = bias.to(torch.float32).contiguous()
    plan = schedule(n, v)
    parts = [None] * 3
    if plan.merge:
        parts = [torch.empty((plan.n_ranges, n), dtype=dt, device=x.device)
                 for dt in (torch.float32, torch.int32, torch.float32)]
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    conf = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        xb.data_ptr(), wb.data_ptr(), bf.data_ptr(),
        *(p.data_ptr() if p is not None else None for p in parts),
        ids.data_ptr(), conf.data_ptr(),
        n, c, v, xb.stride(0), wb.stride(0), plan.n_ranges, plan.tiles_per_range, stream,
    )
    if rc != 0:
        raise RuntimeError(f"ctc_head kernel launch failed: CUDA error {rc}")
    fused_ctc_argmax.launches += 1
    return ids, conf


fused_ctc_argmax.launches = 0


def ctc_head_decode(
    feats: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, C) neck features -> (ids (B, T), probs (B, T)) without
    materializing (B, T, vocab) logits."""
    b, t, c = feats.shape
    ids, conf = fused_ctc_argmax(feats.reshape(b * t, c), kernel, bias)
    return ids.reshape(b, t), conf.reshape(b, t)
