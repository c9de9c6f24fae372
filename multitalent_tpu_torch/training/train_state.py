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
- `AdamClipped`, the SwinUNETR trainers' (make_adam_optimizer,
  train_state.py:59-70): optax's chain clip -> `scale_by_amsgrad` ->
  `add_decayed_weights` -> -LR, written out on tensors, because
  `torch.optim.Adam(amsgrad=True)` is another rule: optax keeps the maximum
  of the bias-corrected second moment (nu_max = max(nu_max, nu_hat), then
  mu_hat / (sqrt(nu_max) + eps)), torch the maximum of the raw one, corrected
  afterwards. The weight decay is decoupled: p -= lr * (update + wd * p).

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


class AdamClipped:
    """optax.chain(clip_by_global_norm(clip), scale_by_amsgrad(b1, b2, eps),
    add_decayed_weights(wd), scale_by_learning_rate(lr)) as `step(lr)`, each
    element computed in fp32 in optax's order; `state_dict` holds the step
    count and mu, nu, nu_max of every trained parameter."""

    def __init__(self, params, weight_decay: float = 3e-5, clip_norm: float = 12.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        """Clip, then one update at `lr`. Returns the gradient's global norm
        before clipping. A parameter without a gradient counts as a zero one,
        as in optax."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        keep = norm < self.clip_norm
        self.count += 1
        one = torch.ones((), dtype=torch.float32)  # optax's 1 - decay ** count in fp32
        c1, c2 = one - (one * self.b1) ** self.count, one - (one * self.b2) ** self.count
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            g = torch.where(keep, g, g / norm * self.clip_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            update = (mu / c1) / (torch.sqrt(nu_max) + self.eps) + self.weight_decay * p
            p.add_(update * -lr)
        return norm

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu],
                "nu_max": [t.clone() for t in self.nu_max]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in ("mu", "nu", "nu_max"):
            for t, v in zip(getattr(self, name), state[name], strict=True):
                t.copy_(v)


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
