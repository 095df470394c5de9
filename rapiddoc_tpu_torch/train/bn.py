"""Train-mode batch statistics for the port's models.

Counterpart of ``rapiddoc_tpu/train/bn.py``: flax threads the mutable
``batch_stats`` collection through ``apply``; here every ``BatchNorm``
keeps its running statistics as buffers and moves them itself in
``train()`` mode (``models/common/layers.BatchNorm``), so the trainers
only need the mode switched for the length of the loop.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch
from torch import nn

__all__ = ["bn_training", "frozen_stats"]


@contextmanager
def bn_training(model: nn.Module):
    """``model`` in ``train()`` mode while open; each submodule's own mode
    restored on exit."""
    modes = [(m, m.training) for m in model.modules()]
    model.train()
    try:
        yield model
    finally:
        for m, mode in modes:
            m.training = mode


@contextmanager
def frozen_stats(model: nn.Module):
    """Train-mode forwards that leave the running statistics as they were
    on entry (flax's ``apply`` with ``mutable=["batch_stats"]`` whose
    update is dropped): every ``running_*`` buffer is saved and written
    back on exit."""
    saved = [(b, b.clone()) for name, b in model.named_buffers() if name.rsplit(".", 1)[-1]
             in ("running_mean", "running_var")]
    try:
        yield model
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)
