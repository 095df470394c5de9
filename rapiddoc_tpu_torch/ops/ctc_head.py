"""Fused CTC head: vocabulary projection + argmax + softmax prob per frame.

Port of K1, the Pallas kernel ``rapiddoc_tpu/ops/ctc_head.py:30``
(``_kernel``, launched at ``:90`` by ``fused_ctc_argmax``). Greedy CTC
needs only each frame's argmax id and its softmax probability, so the
(N, V) logits are never written out. The CUDA kernel is
``csrc/ctc_head.cu``; its header says what bounds it on the H100 and how
its design answers that.

The wrapper takes the kernel for CUDA tensors and the plain PyTorch
version below for CPU tensors; it does no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load

TV = 128  # vocabulary columns per tile, as in csrc/ctc_head.cu
TM = 64  # rows per block
TARGET_BLOCKS = 4 * 132  # about four blocks for each of the H100's SMs

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


def _splits(n: int, v: int) -> tuple[int, int]:
    """(n_splits, tiles_per_split): cut the vocabulary tiles into enough
    contiguous ranges to give the card about TARGET_BLOCKS blocks, with
    no empty range."""
    n_tiles = -(-v // TV)
    row_tiles = -(-n // TM)
    n_splits = max(1, min(n_tiles, -(-TARGET_BLOCKS // row_tiles)))
    per = -(-n_tiles // n_splits)
    return -(-n_tiles // per), per


def _launcher():
    fn = load("ctc_head").ctc_head_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 8 + [_I] * 5 + [_VP]
        fn.restype = _I
    return fn


def fused_ctc_argmax(
    x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, C) features; kernel (C, V); bias (V,).
    Returns (ids (N,) int32, top softmax prob (N,) float32).

    CPU tensors take :func:`ctc_argmax_plain`; CUDA tensors launch the
    kernel (x and kernel are cast to bf16, bias to fp32) and raise if the
    launch fails."""
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
    if x.device.type == "cpu":
        return ctc_argmax_plain(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("x, kernel and bias must be on one device")
    v = kernel.shape[1]
    xb = x.to(torch.bfloat16).contiguous()
    wb = kernel.to(torch.bfloat16).contiguous()
    bf = bias.to(torch.float32).contiguous()
    n_splits, per = _splits(n, v)
    part_m = torch.empty((n_splits, n), dtype=torch.float32, device=x.device)
    part_a = torch.empty((n_splits, n), dtype=torch.int32, device=x.device)
    part_s = torch.empty((n_splits, n), dtype=torch.float32, device=x.device)
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    conf = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        xb.data_ptr(), wb.data_ptr(), bf.data_ptr(),
        part_m.data_ptr(), part_a.data_ptr(), part_s.data_ptr(),
        ids.data_ptr(), conf.data_ptr(),
        n, c, v, n_splits, per, stream,
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
