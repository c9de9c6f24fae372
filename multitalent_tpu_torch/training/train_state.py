"""The production optimizer: SGD with Nesterov momentum 0.99, coupled weight
decay 3e-5 and the gradient clipped to global norm 12
(multitalent_tpu/training/train_state.py:44-56, nnUNetTrainerV2.py:166-170,256).

The JAX package chains, in this order: clip the raw gradient by its global
norm, add weight_decay * param, Nesterov trace, scale by -LR.
`torch.nn.utils.clip_grad_norm_` followed by `torch.optim.SGD(momentum,
nesterov=True, weight_decay)` computes the same update (torch's first step
seeds the momentum buffer with the gradient, optax's trace starts at 0: the
first updates agree, g + m * g). Master weights and momentum are fp32; bf16
needs no GradScaler.
"""
from __future__ import annotations

import torch


class SGDClipped:
    """SGD + clip as one `step(lr)`; `state_dict` is the SGD state."""

    def __init__(self, params, momentum: float = 0.99, nesterov: bool = True,
                 weight_decay: float = 3e-5, clip_norm: float = 12.0):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.sgd = torch.optim.SGD(self.params, lr=0.0, momentum=momentum,
                                   nesterov=nesterov, weight_decay=weight_decay)

    def zero_grad(self) -> None:
        self.sgd.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        """Clip, then one SGD update at `lr`. Returns the gradient's global
        norm before clipping."""
        norm = torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        for group in self.sgd.param_groups:
            group["lr"] = lr
        self.sgd.step()
        return norm

    def state_dict(self) -> dict:
        return self.sgd.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.sgd.load_state_dict(state)
