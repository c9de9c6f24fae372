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

The variant trainers' optimizers (multitalent_tpu/training/variants.py):

- `RAdam`, Ranger's (variants.py:424-448): optax's chain
  `add_decayed_weights` -> `scale_by_radam()` (b1 0.9, b2 0.999, eps 1e-8,
  threshold 5) -> -LR, without clipping. The JAX package leaves out
  Ranger's Lookahead (its slow weights would change the parameter tree), and
  the port follows it: Ranger here is RAdam with coupled weight decay.
- `SGDDecayThenClip`, `_reduceMomentumDuringTraining`'s (variants.py:593-604):
  add_decayed_weights -> clip_by_global_norm(12) -> Nesterov trace ->
  -LR, the decay before the clip (make_sgd_optimizer clips first). Its
  `momentum` may be set between steps; the trace carries over.

Each clips over the parameters it trains only, as the JAX package's masked
optimizer does (optax.multi_transform hands the inner chain the trained
leaves alone). Master weights and moments are fp32; bf16 needs no GradScaler.
Except for AdamWClipped, each computes its update as a tensor a parameter
(`updates(lr)`) and `step` adds it; `config` holds the constructor's
arguments, so `type(opt)(params, **opt.config)` builds the same optimizer
over other parameters (with `load_state_dict`, on another device).
"""
from __future__ import annotations

import math

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


class _TensorOptimizer:
    """An optimizer written out on tensors: `updates(lr)` advances the state
    by one step and returns (the gradient's global norm, the update of each
    trained parameter, None for one left as it is); `step(lr)` adds them."""

    config: dict

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        """One update at `lr`; returns the gradient's global norm before any
        clipping."""
        norm, updates = self.updates(lr)
        for p, u in zip(self.params, updates):
            if u is not None:
                p.add_(u)
        return norm

    def _grads(self) -> list[torch.Tensor]:
        """The gradients, a zero one for a parameter without (as in optax)."""
        return [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]


def _global_norm(tensors) -> torch.Tensor:
    return torch.stack([t.square().sum() for t in tensors]).sum().sqrt()


def _f32(x) -> torch.Tensor:
    """A host fp32 scalar: optax's scalar arithmetic is fp32."""
    return torch.tensor(x, dtype=torch.float32)


class AdamClipped(_TensorOptimizer):
    """optax.chain(clip_by_global_norm(clip), scale_by_amsgrad(b1, b2, eps),
    add_decayed_weights(wd), scale_by_learning_rate(lr)) as `step(lr)`, each
    element computed in fp32 in optax's order; `state_dict` holds the step
    count and mu, nu, nu_max of every trained parameter."""

    def __init__(self, params, weight_decay: float = 3e-5, clip_norm: float = 12.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.config = dict(weight_decay=weight_decay, clip_norm=clip_norm, b1=b1, b2=b2,
                           eps=eps)
        self.weight_decay, self.clip_norm = weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.nu_max = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def updates(self, lr: float):
        """Clip, then one AMSGrad update at `lr`. A parameter without a
        gradient counts as a zero one, as in optax."""
        grads = self._grads()
        norm = _global_norm(grads)
        keep = norm < self.clip_norm
        self.count += 1
        one = _f32(1.0)  # optax's 1 - decay ** count in fp32
        c1, c2 = one - (one * self.b1) ** self.count, one - (one * self.b2) ** self.count
        out = []
        for p, g, mu, nu, nu_max in zip(self.params, grads, self.mu, self.nu, self.nu_max):
            g = torch.where(keep, g, g / norm * self.clip_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            torch.maximum(nu_max, nu / c2, out=nu_max)
            update = (mu / c1) / (torch.sqrt(nu_max) + self.eps) + self.weight_decay * p
            out.append(update * -lr)
        return norm, out

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
    """Clip, then torch.optim.SGD's update (coupled weight decay, momentum
    buffer seeded with the first gradient, Nesterov), written out with its
    foreach ops so that `updates` returns what `step` adds; the torch
    optimizer keeps the hyperparameters and momentum buffers (its
    state_dict, as a reference checkpoint's). Parameters without a gradient
    are left as they are, as torch leaves them."""

    def __init__(self, params, momentum: float = 0.99, nesterov: bool = True,
                 weight_decay: float = 3e-5, clip_norm: float = 12.0):
        super().__init__(params, clip_norm)
        self.config = dict(momentum=momentum, nesterov=nesterov, weight_decay=weight_decay,
                           clip_norm=clip_norm)
        self.opt = torch.optim.SGD(self.params, lr=0.0, momentum=momentum,
                                   nesterov=nesterov, weight_decay=weight_decay)

    @torch.no_grad()
    def updates(self, lr: float):
        norm = torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        group = self.opt.param_groups[0]
        group["lr"] = lr
        live = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in live]
        if group["weight_decay"]:
            grads = torch._foreach_add(grads, live, alpha=group["weight_decay"])
        m = group["momentum"]
        bufs = []
        for p, g in zip(live, grads):
            state = self.opt.state[p]
            if state.get("momentum_buffer") is None:
                state["momentum_buffer"] = torch.clone(g).detach()
            else:
                state["momentum_buffer"].mul_(m).add_(g)
            bufs.append(state["momentum_buffer"])
        directions = torch._foreach_add(grads, bufs, alpha=m) if group["nesterov"] else bufs
        steps = dict(zip(map(id, live), torch._foreach_mul(directions, -lr)))
        return norm, [steps.get(id(p)) for p in self.params]

    @torch.no_grad()
    def step(self, lr: float) -> torch.Tensor:
        return _TensorOptimizer.step(self, lr)

    @property
    def momentum(self) -> float:
        return self.opt.param_groups[0]["momentum"]


class AdamWClipped(_Clipped):
    def __init__(self, params, weight_decay: float = 1e-2, clip_norm: float = 12.0):
        super().__init__(params, clip_norm)
        self.opt = torch.optim.AdamW(self.params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                     weight_decay=weight_decay)


class RAdam(_TensorOptimizer):
    """optax.chain(add_decayed_weights(wd), scale_by_radam(b1, b2, eps,
    eps_root=0, threshold), scale_by_learning_rate(lr)), no clipping, each
    element in fp32 in optax's order: mu and nu the moments of the decayed
    gradient, rho = rho_inf - 2 t b2^t / (1 - b2^t); the bias-corrected mu
    alone while rho < threshold, after that r mu_hat / (sqrt(nu_hat) + eps)
    with the rectification r. `state_dict` holds the count, mu and nu.

    rho and r are host scalars of the count, computed in double: optax
    computes rho in fp32 as the difference of two numbers near 2000, whose
    rounding (b2^t off by an ulp moves rho by ~0.02) sets r off by up to
    0.6% at t = 6, differently under jit and eagerly."""

    def __init__(self, params, weight_decay: float = 3e-5, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, threshold: float = 5.0):
        self.params = [p for p in params if p.requires_grad]
        self.config = dict(weight_decay=weight_decay, b1=b1, b2=b2, eps=eps,
                           threshold=threshold)
        self.weight_decay, self.b1, self.b2, self.eps = weight_decay, b1, b2, eps
        self.threshold = threshold
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def rectification(self) -> float | None:
        """r of the current count, None while rho < threshold (the update is
        mu_hat alone)."""
        ro_inf = 2.0 / (1.0 - self.b2) - 1.0
        b2t = self.b2 ** self.count
        ro = ro_inf - 2 * self.count * b2t / (1 - b2t)
        if ro < self.threshold:
            return None
        return math.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf
                         / ((ro_inf - 4.0) * (ro_inf - 2.0) * ro))

    @torch.no_grad()
    def updates(self, lr: float):
        grads = self._grads()
        norm = _global_norm(grads)
        self.count += 1
        one = _f32(1.0)
        c1, c2 = one - (one * self.b1) ** self.count, one - (one * self.b2) ** self.count
        r = self.rectification()
        out = []
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g + self.weight_decay * p
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            mu_hat = mu / c1
            update = mu_hat if r is None else r * mu_hat / (torch.sqrt(nu / c2) + self.eps)
            out.append(update * -lr)
        return norm, out

    def state_dict(self) -> dict:
        return {"count": self.count, "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu]}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for name in ("mu", "nu"):
            for t, v in zip(getattr(self, name), state[name], strict=True):
                t.copy_(v)


class SGDDecayThenClip(_TensorOptimizer):
    """optax.inject_hyperparams over chain(add_decayed_weights(wd),
    clip_by_global_norm(clip), trace(momentum, nesterov=True),
    scale_by_learning_rate(lr)): the decayed gradient clipped, then the
    Nesterov trace (starting at 0), each element in fp32. `momentum` may be
    changed between steps (the trace carries over); `state_dict` holds the
    momentum and the traces."""

    def __init__(self, params, momentum: float = 0.99, weight_decay: float = 3e-5,
                 clip_norm: float = 12.0):
        self.params = [p for p in params if p.requires_grad]
        self.config = dict(momentum=momentum, weight_decay=weight_decay, clip_norm=clip_norm)
        self.momentum, self.weight_decay, self.clip_norm = momentum, weight_decay, clip_norm
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def updates(self, lr: float):
        grads = [g + self.weight_decay * p for p, g in zip(self.params, self._grads())]
        norm = _global_norm(grads)
        keep = norm < self.clip_norm
        m = float(_f32(self.momentum))  # the injected hyperparameter is an fp32 array
        out = []
        for g, t in zip(grads, self.trace):
            g = torch.where(keep, g, g / norm * self.clip_norm)
            t.copy_(g + m * t)
            out.append((g + m * t) * -lr)
        return norm, out

    def state_dict(self) -> dict:
        return {"momentum": self.momentum, "trace": [t.clone() for t in self.trace]}

    def load_state_dict(self, state: dict) -> None:
        self.momentum = float(state["momentum"])
        for t, v in zip(self.trace, state["trace"], strict=True):
            t.copy_(v)
