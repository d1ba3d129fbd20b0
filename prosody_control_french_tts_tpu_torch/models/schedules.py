"""optax's learning-rate schedules and its scheduled Adam, for the recipes
that the JAX package trains with ``optax.adam(schedule)``.

The schedules are optax 0.2.6's, evaluated in float32 as optax evaluates
them (the step count converted to float32): ``cosine_decay_schedule``
(``init · ((1 − alpha) · ½(1 + cos(π · min(t, T) / T)) + alpha)``) and
``warmup_cosine_decay_schedule`` (a linear ramp from ``init_value`` to
``peak_value`` over ``warmup_steps``, then the cosine decay to
``end_value`` over the remaining ``decay_steps − warmup_steps``).
:class:`ScheduledAdam` is ``torch.optim.Adam`` (b1 0.9, b2 0.999, eps 1e-8
outside the square root: ``optax.adam``'s constants) whose learning rate is
set before each update from the schedule at the count of updates made so
far, which is the count optax's ``scale_by_learning_rate`` reads: the
first update uses the schedule at 0 (0 for the warm-up schedules here).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Schedule = Callable[[int], float]

_F = np.float32


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count: int) -> float:
        c = min(_F(count), _F(decay_steps))
        cosine = _F(0.5) * (_F(1) + np.cos(_F(np.pi) * c / _F(decay_steps), dtype=_F))
        return float(_F(init_value) * ((_F(1) - _F(alpha)) * cosine + _F(alpha)))

    return schedule


def linear_schedule(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    if transition_steps <= 0:
        return lambda count: float(init_value)

    def schedule(count: int) -> float:
        c = _F(min(max(count, 0), transition_steps))
        frac = _F(1) - c / _F(transition_steps)
        return float((_F(init_value) - _F(end_value)) * frac + _F(end_value))

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)
    return lambda count: warm(count) if count < warmup_steps else decay(count - warmup_steps)


class ScheduledAdam:
    """``optax.adam(schedule)``: ``step()`` sets the learning rate to
    ``schedule(count)`` and makes one Adam update."""

    def __init__(self, params, schedule: Schedule):
        self.schedule = schedule
        self.count = 0
        self.opt = torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=1e-8)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> None:
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.count)
        self.opt.step()
        self.count += 1
