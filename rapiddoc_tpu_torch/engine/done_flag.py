"""Early exit of a batched decode loop without stalling the card.

A decode loop stops when every row is done. Reading ``done.all()`` at
once would make the host wait for each step before it queues the next,
so on the card the flag is read one step late: step s copies its flag
to pinned host memory without waiting, and the host reads it after it
has queued step s + 1. The loop then runs at most one step more than
the JAX package's ``lax.while_loop``; every caller writes only what
already stands in a finished row, so that step changes nothing. On the
CPU the flag is read at once.
"""
from __future__ import annotations

import torch


class DoneFlag:
    def __init__(self, device: torch.device):
        self.on_card = device.type == "cuda"
        if self.on_card:
            self.flags = torch.empty((2,), dtype=torch.bool, pin_memory=True)
            self.events = (torch.cuda.Event(), torch.cuda.Event())
            self.pending: int | None = None
            self.step = 0

    def finished(self, done: torch.Tensor) -> bool:
        """Call once per step after it is queued, with its ``done``
        (B,) bool; True when the loop should stop."""
        if not self.on_card:
            return bool(done.all())
        slot = self.step % 2
        self.step += 1
        self.flags[slot].copy_(done.all(), non_blocking=True)
        self.events[slot].record()
        pending, self.pending = self.pending, slot
        if pending is None:
            return False
        self.events[pending].synchronize()
        return bool(self.flags[pending])
