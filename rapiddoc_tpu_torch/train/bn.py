"""Train-mode batch statistics for the port's models.

Counterpart of ``rapiddoc_tpu/train/bn.py``: flax threads the mutable
``batch_stats`` collection through ``apply``; here every ``BatchNorm``
keeps its running statistics as buffers and moves them itself in
``train()`` mode (``models/common/layers.BatchNorm``), so the trainers
only need the mode switched for the length of the loop.
"""
from __future__ import annotations

from contextlib import contextmanager

from torch import nn

__all__ = ["bn_training"]


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
