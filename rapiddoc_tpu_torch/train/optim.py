"""The optax transforms the trainers use, on lists of torch tensors.

``rapiddoc_tpu/train/{det,rec,orientation}.py`` step with
``optax.adam(optax.warmup_cosine_decay_schedule(0, lr, warmup, steps))``;
the later trainers (table, formula, layout, UniTable) chain
``optax.clip_by_global_norm`` before ``optax.adamw``. This module gives
the same updates, in optax's order of operations, in float32:

- ``scale_by_adam``: ``m = (1 - b1) g + b1 m``, ``v = (1 - b2) g^2 + b2 v``,
  ``u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)`` with ``t`` the
  count after the step (optax's defaults: b1 0.9, b2 0.999, eps 1e-8
  outside the square root);
- ``add_decayed_weights`` (``adamw``): ``u + wd * p``, no mask;
- ``scale_by_learning_rate``: ``-lr(count) * u``, the schedule read at the
  count *before* the step, so a warm-up from 0 makes the first update 0;
- ``apply_updates``: ``p + u``;
- ``clip_by_global_norm``: ``g`` while the global norm is below ``max``,
  else ``g / norm * max`` (not ``clip_grad_norm_``'s ``norm + 1e-6``).

The schedule is evaluated in float32 as JAX evaluates it inside the jitted
step.
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

Schedule = Callable[[int], float]
_F32 = np.float32
B1, B2, EPS = 0.9, 0.999, 1e-8  # optax.adam's defaults


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Schedule:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value``
    to ``peak_value`` over ``warmup_steps``, then cosine to ``end_value``
    at ``decay_steps``; raises as optax does when ``decay_steps -
    warmup_steps`` is not positive."""
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(
            f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={cos_steps}."
        )
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.join_schedules' boundary
            c = min(max(count, 0), warmup_steps)
            frac = _F32(1) - _F32(c) / _F32(warmup_steps)
            return float(_F32(init_value - peak_value) * frac + _F32(peak_value))
        c = _F32(min(count - warmup_steps, cos_steps))
        cosine = _F32(0.5) * (_F32(1) + np.cos(_F32(math.pi) * c / _F32(cos_steps)))
        decayed = _F32(1 - alpha) * cosine + _F32(alpha)
        return float(_F32(peak_value) * decayed)

    return schedule


def global_norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's squares."""
    return torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())


def clip_by_global_norm(grads: Sequence[torch.Tensor], max_norm: float) -> list[torch.Tensor]:
    """``optax.clip_by_global_norm(max_norm)``, on the device (no host
    read of the norm)."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


class Adam:
    """``optax.adam`` (``weight_decay=None``) or ``optax.adamw`` (a float
    ``weight_decay``), optionally after ``optax.clip_by_global_norm``
    (``max_norm``), over ``params``. ``step()`` reads each parameter's
    ``.grad`` (zero where it has none) and moves the parameters;
    :meth:`updates` gives optax's updates for given gradients without
    moving anything but the optimizer's own state."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: Schedule,
                 weight_decay: float | None = None, max_norm: float | None = None):
        self.params = [p for p in params]
        self.lr = learning_rate
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def updates(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        grads = [g.float() for g in grads]
        if self.max_norm is not None:
            grads = clip_by_global_norm(grads, self.max_norm)
        b1, b2 = B1, B2
        # update_moment: (1 - decay) * g**order + decay * moment
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        sq = torch._foreach_mul(grads, grads)
        self.nu = torch._foreach_add(torch._foreach_mul(sq, 1 - b2),
                                     torch._foreach_mul(self.nu, b2))
        t = self.count + 1
        bc1 = float(_F32(1) - _F32(b1) ** _F32(t))
        bc2 = float(_F32(1) - _F32(b2) ** _F32(t))
        mu_hat = torch._foreach_div(self.mu, bc1)
        nu_hat = torch._foreach_div(self.nu, bc2)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay is not None:
            upd = torch._foreach_add(upd, torch._foreach_mul(
                [p.float() for p in self.params], self.weight_decay))
        step_size = -1.0 * self.lr(self.count)
        self.count = t
        return torch._foreach_mul(upd, float(_F32(step_size)))

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]
        for p, u in zip(self.params, self.updates(grads)):
            p.add_(u.to(p.dtype))

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def train_step(loss_fn: Callable[..., torch.Tensor], model: torch.nn.Module, opt: Adam,
               *batch: torch.Tensor) -> torch.Tensor:
    """One step of a trainer: ``loss_fn(model, *batch)``, its gradients,
    ``opt``'s update; the loss, detached (the JAX trainers' jitted
    ``step``)."""
    opt.zero_grad()
    loss = loss_fn(model, *batch)
    loss.backward()
    opt.step()
    return loss.detach()


def adam(params: Sequence[torch.Tensor], learning_rate: Schedule, **kw) -> Adam:
    """``optax.adam(learning_rate)`` (b1 0.9, b2 0.999, eps 1e-8)."""
    return Adam(params, learning_rate, **kw)


def adamw(params: Sequence[torch.Tensor], learning_rate: Schedule,
          weight_decay: float = 1e-4, **kw) -> Adam:
    """``optax.adamw(learning_rate, weight_decay=1e-4)``, no mask."""
    return Adam(params, learning_rate, weight_decay=weight_decay, **kw)
