"""Learning-rate schedules (multitalent_tpu/training/schedules.py:17-44).

The reference sets the LR once per epoch; the update of optimizer step
`step` uses `poly_lr(min(step // steps_per_epoch, max_epochs - 1))`, the
staircase of the JAX package's `make_poly_schedule`.
"""
from __future__ import annotations


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
