"""Learning-rate schedules (multitalent_tpu/training/schedules.py:17-52).

The reference sets the LR once per epoch; the update of optimizer step
`step` uses `poly_lr(min(step // steps_per_epoch, max_epochs - 1))`, the
staircase of the JAX package's `make_poly_schedule`.

The variant trainers add the constant schedule, optax's
`cosine_onecycle_schedule` and `join_schedules` (the cycle of `_cycleAtEnd`,
variants.py:451-471), formula for formula, and the stepped poly of
`_SGD_fixedSchedule2` (variants.py:569-585).
"""
from __future__ import annotations

import math


def poly_lr(epoch, max_epochs: int, initial_lr: float = 1e-2, exponent: float = 0.9):
    """initial_lr * (1 - epoch / max_epochs) ** exponent (poly_lr.py:16-17)."""
    return initial_lr * (1 - epoch / max_epochs) ** exponent


def make_poly_schedule(initial_lr: float, max_epochs: int, steps_per_epoch: int,
                       exponent: float = 0.9):
    """step -> LR, the per-epoch poly staircase."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_epochs - 1)
        return poly_lr(epoch, max_epochs, initial_lr, exponent)

    return schedule


def make_warmup_poly_schedule(initial_lr: float, max_epochs: int, steps_per_epoch: int,
                              warmup_epochs: int = 50, exponent: float = 0.9):
    """step -> LR: initial_lr * (epoch + 1) / warmup_epochs over the first
    `warmup_epochs` epochs, then the poly staircase
    (nnUNetTrainerV2_warmup.py:38-64; schedules.py:33 of the JAX package)."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_epochs - 1)
        if epoch < warmup_epochs:
            return initial_lr * (epoch + 1) / warmup_epochs
        return poly_lr(epoch, max_epochs, initial_lr, exponent)

    return schedule


def make_constant_schedule(lr: float):
    """step -> lr."""

    def schedule(step: int) -> float:
        return lr

    return schedule


def cosine_onecycle_schedule(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                             div_factor: float = 25.0, final_div_factor: float = 1e4):
    """optax.cosine_onecycle_schedule: from peak / div_factor up to peak over
    the first int(pct_start * transition_steps) steps, down to peak /
    (div_factor * final_div_factor) at `transition_steps`, both halves cosine
    (optax's piecewise_interpolate_schedule), the last value after."""
    if transition_steps <= 0:
        raise ValueError("a onecycle schedule needs transition_steps > 0")
    bounds = (0, int(pct_start * transition_steps), int(transition_steps))
    values = (peak_value / div_factor, peak_value,
              peak_value / (div_factor * final_div_factor))

    def schedule(step: int) -> float:
        for lo, hi, start, end in zip(bounds, bounds[1:], values, values[1:]):
            if lo <= step < hi:
                pct = (step - lo) / (hi - lo)
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return schedule


def join_schedules(schedules, boundaries):
    """optax.join_schedules: the first schedule before boundaries[0], then
    each next one counted from its boundary."""

    def schedule(step: int) -> float:
        out = schedules[0](step)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = sched(step - boundary)
        return out

    return schedule


def stepped_poly_lr(epoch: int, max_epochs: int, initial_lr: float,
                    restarts=(700, 900)) -> float:
    """_SGD_fixedSchedule2's LR (variants.py:575-584): poly from
    initial_lr before restarts[0]; from each restart on, poly from the LR the
    plain poly gives at that restart."""
    start = initial_lr
    for r in restarts:
        if epoch >= r:
            start = poly_lr(r, max_epochs, initial_lr)
    return poly_lr(epoch, max_epochs, start)


def make_stepped_poly_schedule(initial_lr: float, max_epochs: int, steps_per_epoch: int,
                               restarts=(700, 900)):
    """step -> stepped_poly_lr of its epoch (the epoch capped at
    max_epochs - 1, as the poly staircase)."""

    def schedule(step: int) -> float:
        epoch = min(step // steps_per_epoch, max_epochs - 1)
        return stepped_poly_lr(epoch, max_epochs, initial_lr, restarts)

    return schedule
