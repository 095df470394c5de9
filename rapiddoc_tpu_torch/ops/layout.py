"""Row layouts the fused head kernels read: 16-byte aligned rows."""
from __future__ import annotations

import torch

ROW_ALIGN_BYTES = 16  # one cp.async piece; what TMA needs of a row


def aligned_rows(w: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """A (K, V) copy of ``w`` (cast to ``dtype``) whose rows start every
    multiple of 16 bytes: a view of zero-padded (K, V_padded) storage.
    The kernels copy such rows to shared memory in 16-byte pieces; made
    once per weight, never per call."""
    dtype = dtype or w.dtype
    k, v = w.shape
    per = ROW_ALIGN_BYTES // torch.empty((), dtype=dtype).element_size()
    out = torch.zeros((k, -(-v // per) * per), dtype=dtype, device=w.device)
    out[:, :v] = w.detach()
    return out[:, :v]


def has_aligned_rows(w: torch.Tensor) -> bool:
    """Whether the 2-D ``w`` is laid out as the kernels read it: unit
    column stride, rows at least V apart, and the start and the row stride
    multiples of 16 bytes."""
    size = w.element_size()
    return (
        w.stride(1) == 1
        and w.stride(0) >= w.shape[1]
        and (w.stride(0) * size) % ROW_ALIGN_BYTES == 0
        and w.data_ptr() % ROW_ALIGN_BYTES == 0
    )


def with_aligned_rows(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` cast to ``dtype``, as it is if its rows are aligned already
    (the models' heads and activations), else an :func:`aligned_rows`
    copy: a per-call copy that only callers with other layouts pay."""
    w = w.to(dtype)
    return w if has_aligned_rows(w) else aligned_rows(w)
