"""The optimizers, each with the gradient clipped to global norm 12 first.

- `SGDClipped`, the production optimizer: SGD with Nesterov momentum 0.99 and
  coupled weight decay 3e-5 (multitalent_tpu/training/train_state.py:44-56,
  nnUNetTrainerV2.py:166-170,256). The JAX package chains, in this order:
  clip the raw gradient by its global norm, add weight_decay * param,
  Nesterov trace, scale by -LR. `torch.nn.utils.clip_grad_norm_` followed by
  `torch.optim.SGD(momentum, nesterov=True, weight_decay)` computes the same
  update (torch's first step seeds the momentum buffer with the gradient,
  optax's trace starts at 0: the first updates agree, g + m * g).
- `AdamWClipped`, the head warm-up's (train_state.py:73-85):
  `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) ->
  `add_decayed_weights` -> -LR, i.e. p -= lr * (m_hat / (sqrt(v_hat) + eps)
  + wd * p), which `torch.optim.AdamW` computes (it decays p by lr * wd
  first, then applies the same Adam step).

Each clips over the parameters it trains only, as the JAX package's masked
optimizer does (optax.multi_transform hands the inner chain the trained
leaves alone). Master weights and moments are fp32; bf16 needs no GradScaler.
"""
from __future__ import annotations

import torch


class _Clipped:
    """Clip + one torch optimizer step as `step(lr)`; `state_dict` is the
    torch optimizer's."""

    def __init__(self, params, clip_norm: float):
        self.params = [p for p in params if p.requires_grad]
        self.clip_norm = clip_norm
        self.opt: torch.optim.Optimizer | None = None

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self, lr: float) -> torch.Tensor:
        """Clip, then one update at `lr`. Returns the gradient's global norm
        before clipping."""
        norm = torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        return norm

    def state_dict(self) -> dict:
        return self.opt.state_dict()

    def load_state_dict(self, state: dict) -> None:
        self.opt.load_state_dict(state)


class SGDClipped(_Clipped):
    def __init__(self, params, momentum: float = 0.99, nesterov: bool = True,
                 weight_decay: float = 3e-5, clip_norm: float = 12.0):
        super().__init__(params, clip_norm)
        self.opt = torch.optim.SGD(self.params, lr=0.0, momentum=momentum,
                                   nesterov=nesterov, weight_decay=weight_decay)


class AdamWClipped(_Clipped):
    def __init__(self, params, weight_decay: float = 1e-2, clip_norm: float = 12.0):
        super().__init__(params, clip_norm)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)
