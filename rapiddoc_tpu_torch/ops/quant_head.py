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
version below for CPU tensors; it does no other fallback.
"""
from __future__ import annotations

import ctypes

import torch

from .build import load

TILE_V = 128  # vocabulary columns per tile, as in csrc/quant_head.cu
THREADS = 256  # threads per block, as in csrc/quant_head.cu
ROW_TILES = (4, 16)  # rows per block: the formula decode's batch sizes
TARGET_BLOCKS = 2 * 132  # about two blocks for each of the H100's SMs
SMEM_LIMIT = 227 * 1024  # dynamic shared memory a block may use

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


def row_tile(n: int) -> int:
    """Rows per block: 4 for a decode batch of up to 4, else 16."""
    return ROW_TILES[0] if n <= ROW_TILES[0] else ROW_TILES[1]


def ranges(n: int, v: int) -> tuple[int, int]:
    """(n_ranges, tiles_per_range): cut the vocabulary tiles into enough
    contiguous ranges to give the card about TARGET_BLOCKS blocks, with
    no empty range."""
    n_tiles = -(-v // TILE_V)
    row_blocks = -(-n // row_tile(n))
    n_ranges = max(1, min(n_tiles, -(-TARGET_BLOCKS // row_blocks)))
    per = -(-n_tiles // n_ranges)
    return -(-n_tiles // per), per


def _launcher():
    fn = load("quant_head").quant_head_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 9 + [_I] * 6 + [_VP]
        fn.restype = _I
    return fn


def fused_argmax_int8(
    x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """x (N, K) features; wq (K, V) int8; scale (V,); bias (V,).
    Returns (argmax ids (N,) int32, softmax prob of the argmax (N,) fp32).

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
    if x.device.type == "cpu":
        return quant_argmax_plain(x, wq, scale, bias)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if any(t.device != x.device for t in (wq, scale, bias)):
        raise ValueError("x, wq, scale and bias must be on one device")
    rows = row_tile(n)
    # dynamic shared memory: x as fp32 (K x rows) and the cross-warp sums
    # (8 warps x 2 rows x TILE_V)
    smem = 4 * (k * rows + (THREADS // 32) * 2 * TILE_V)
    if smem > SMEM_LIMIT:
        raise ValueError(f"K = {k} needs {smem} bytes of shared memory > {SMEM_LIMIT}")
    xb = x.to(torch.bfloat16).contiguous()
    wqc = wq.contiguous()
    sf = scale.to(torch.float32).contiguous()
    bf = bias.to(torch.float32).contiguous()
    n_ranges, per = ranges(n, v)
    part_m = torch.empty((n_ranges, n), dtype=torch.float32, device=x.device)
    part_a = torch.empty((n_ranges, n), dtype=torch.int32, device=x.device)
    part_s = torch.empty((n_ranges, n), dtype=torch.float32, device=x.device)
    ids = torch.empty((n,), dtype=torch.int32, device=x.device)
    conf = torch.empty((n,), dtype=torch.float32, device=x.device)
    fn = _launcher()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(
        xb.data_ptr(), wqc.data_ptr(), sf.data_ptr(), bf.data_ptr(),
        part_m.data_ptr(), part_a.data_ptr(), part_s.data_ptr(),
        ids.data_ptr(), conf.data_ptr(),
        n, k, v, rows, n_ranges, per, stream,
    )
    if rc != 0:
        raise RuntimeError(f"quant_head kernel launch failed: CUDA error {rc}")
    fused_argmax_int8.launches += 1
    return ids, conf


fused_argmax_int8.launches = 0
