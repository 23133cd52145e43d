"""The reference trainer's optimizer and learning-rate schedule, without
``torch.optim``.

The reference chains ``optax.add_decayed_weights(wd)`` and
``optax.sgd(schedule, momentum, nesterov=True)`` inside its jitted step.
Per parameter ``p`` with gradient ``g`` and trace ``t``, in this order:

1. ``d = g + wd * p``
2. ``t = d + m * t``
3. ``u = -lr(count) * (d + m * t)``
4. ``p = p + u``, and only then ``count += 1``.

XLA on the CPU fuses each product that feeds a sum into one FMA (a single
rounding), and ``torch.add(a, b, alpha=s)`` computes ``a + s * b`` the same
way, so the updates equal the reference's bit for bit there.

The schedules are optax's ``linear_schedule``, ``cosine_decay_schedule(
alpha=lrf)`` and ``join_schedules`` in float32. Inside the reference's
jitted step XLA turns a division by a constant into a product with its
float32 reciprocal and fuses products into sums (``fused=True``, what the
step uses); called eagerly on a Python int, as the reference does for the
``lr`` it logs, each operation rounds on its own (``fused=False``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

f32 = np.float32


def _fma(a, b, c) -> np.float32:
    """float32 a * b + c with one rounding (the float64 product of two
    float32 values is exact)."""
    return f32(np.float64(a) * np.float64(b) + np.float64(c))


def _linear(init: float, end: float, steps: int, count: int, fused: bool) -> np.float32:
    """optax.linear_schedule(init, end, steps)(count)."""
    c = f32(min(max(count, 0), steps))
    if fused:
        frac = _fma(-c, f32(1) / f32(steps), f32(1))
        return _fma(f32(init - end), frac, f32(end))
    frac = f32(1) - c / f32(steps)
    return f32(init - end) * frac + f32(end)


def _cosine(init: float, steps: int, alpha: float, count: int, fused: bool) -> np.float32:
    """optax.cosine_decay_schedule(init, steps, alpha)(count). The cosine is
    libm's in float32, which can differ from XLA's in the last bits; near
    the end of the decay 1 + cos cancels, so the schedule can differ there
    by a few ulps (far below lr0's own rounding)."""
    c = f32(min(count, steps))
    if fused:  # XLA folds pi / steps and 0.5 * (1 - alpha) into constants
        x = c * (f32(np.pi) * (f32(1) / f32(steps)))
        cos1 = np.cos(x, dtype=np.float32) + f32(1)
        return _fma(cos1, f32(0.5) * f32(1 - alpha), f32(alpha)) * f32(init)
    decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(steps), dtype=np.float32))
    return f32(init) * (f32(1 - alpha) * decay + f32(alpha))


class LRSchedule(NamedTuple):
    """The reference's ``build_lr_schedule``: a linear warmup from 0 to
    ``lr0`` over ``warmup_steps``, then a linear (or cosine) decay to
    ``lr0 * lrf`` at ``total_steps``."""

    lr0: float
    lrf: float
    warmup_steps: int
    total_steps: int
    cos_lr: bool

    def __call__(self, count: int, fused: bool = True) -> np.float32:
        warm = max(self.warmup_steps, 1)
        if count < warm:
            return _linear(0.0, self.lr0, warm, count, fused)
        decay_steps = max(self.total_steps - self.warmup_steps, 1)
        if self.cos_lr:
            return _cosine(self.lr0, decay_steps, self.lrf, count - warm, fused)
        return _linear(self.lr0, self.lr0 * self.lrf, decay_steps, count - warm, fused)


def build_lr_schedule(lr0: float, lrf: float, warmup_steps: int, total_steps: int,
                      cos_lr: bool) -> LRSchedule:
    return LRSchedule(lr0, lrf, warmup_steps, total_steps, cos_lr)


class SGDState(NamedTuple):
    """optax's state of the chain: the momentum trace per parameter (in the
    parameters' order) and the update count."""

    trace: list
    count: int


class SGD(NamedTuple):
    """Nesterov SGD with decoupled-into-the-gradient weight decay, as the
    reference's optax chain."""

    schedule: LRSchedule
    momentum: float = 0.937
    weight_decay: float = 5e-4

    def init(self, params) -> SGDState:
        return SGDState([torch.zeros_like(p) for p in params], 0)

    @torch.no_grad()
    def update(self, params, grads, state: SGDState) -> SGDState:
        """Apply one update to ``params`` in place; return the new state."""
        neg_lr = -float(self.schedule(state.count))
        trace = []
        for p, g, t in zip(params, grads, state.trace):
            d = torch.add(g, p, alpha=self.weight_decay)
            t = torch.add(d, t, alpha=self.momentum)
            p.add_(torch.add(d, t, alpha=self.momentum), alpha=neg_lr)
            trace.append(t)
        return SGDState(trace, state.count + 1)
