"""Fine-tuning: pretrained weights and the warm-up trainers, on one GPU or several.

Counterpart of multitalent_tpu/training/warmup.py
(nnUNet_variants/pretraining/nnUNetTrainerV2_warmup.py:38-198,
run/load_pretrained_weights.py:17-61):

- `load_pretrained_weights`: every parameter of the network whose name and
  shape a pretrained state dict has takes the pretrained value, never the
  segmentation heads (`is_seg_head_param`);
- `TrainerV2WarmupLR` (nnUNetTrainerV2_warmup_increasing_lr,
  nnUNetTrainerV2_warmup): the LR ramps linearly over 50 epochs, then poly;
- `TrainerV2WarmupSegHeads` (nnUNetTrainerV2_warmupsegheads): for
  `head_warmup_epochs` (10) epochs AdamW at 3e-3, weight decay 3e-5, on the
  heads alone; then SGD over the whole network under the ramp, with a new
  optimizer state and the step counter kept. In the first phase the backbone
  has `requires_grad=False`, so autograd runs no backward through it (no
  kernel A dx, no kernel C): the backbone stays bit-equal. Its checkpoints
  carry the phase, and a resumed run restores the optimizer of that phase.
  Over several ranks the DDP wrapper is built anew at the switch (and on
  resuming into phase 2): one built in phase 1 registered the heads alone.

`TrainerV2WarmupSegHeadsResenc` (nnUNetTrainerV2_warmupsegheads_resenc) runs
the head warm-up over the residual-encoder UNet, `TrainerV2WarmupSegHeadsSwin`
(nnUNetTrainerV2_warmupsegheads_swinunetr_adam_lr5e4_ddp) over SwinUNETR,
with AMSGrad Adam at 5e-4 in phase 2. Its head is `out`: the JAX package's
predicate (`"seg" in path`, warmup.py:32-34) matches no SwinUNETR parameter,
so its phase 1 trains nothing and `load_pretrained_weights` carries the head
over; the port's `is_seg_head_param` knows `out.*`.
"""
from __future__ import annotations

from multitalent_tpu_torch.training.schedules import make_warmup_poly_schedule, poly_lr
from multitalent_tpu_torch.training.train_state import AdamWClipped, SGDClipped
from multitalent_tpu_torch.training.trainers import ResencUNetMixin, SwinUNETRMixin, TrainerV2

# the heads' parameter names: the GenericUNet's, the residual UNet's, the
# name older resenc checkpoints give its last head, and the SwinUNETR's
SEG_HEAD_PREFIXES = ("seg_outputs.", "decoder.deep_supervision_outputs.",
                     "decoder.segmentation_output.", "out.")


def is_seg_head_param(name: str) -> bool:
    """Whether a state-dict key (`module.` prefix or not) names a
    segmentation head's parameter (seg0..segN of the JAX package's UNets,
    `out` of its SwinUNETR)."""
    return name.removeprefix("module.").startswith(SEG_HEAD_PREFIXES)


def load_pretrained_weights(state_dict: dict, pretrained: dict, exclude_seg_heads: bool = True,
                            verbose: bool = False) -> dict:
    """`state_dict` with every entry that `pretrained` has at the same name and
    shape taken from `pretrained`, the heads excepted
    (load_pretrained_weights.py:17-61)."""
    merged = {}
    for k, v in state_dict.items():
        p = pretrained.get(k)
        take = (p is not None and tuple(p.shape) == tuple(v.shape)
                and not (exclude_seg_heads and is_seg_head_param(k)))
        merged[k] = p.to(v.dtype) if take else v
        if verbose:
            print("transferred:" if take else "kept random init:", k)
    return merged


class TrainerV2WarmupLR(TrainerV2):
    """The LR scales with (epoch + 1) / 50 for 50 epochs, then poly
    (nnUNetTrainerV2_warmup.py:38-64)."""

    warmup_epochs = 50

    def initialize_optimizer(self):
        return (SGDClipped(self.network.parameters(), momentum=0.99, nesterov=True,
                           weight_decay=self.weight_decay, clip_norm=12.0),
                make_warmup_poly_schedule(self.initial_lr, self.max_num_epochs,
                                          self.num_batches_per_epoch,
                                          warmup_epochs=self.warmup_epochs))

    def current_lr(self) -> float:
        e = min(self.epoch, self.max_num_epochs - 1)
        if e < self.warmup_epochs:
            return float(self.initial_lr * (e + 1) / self.warmup_epochs)
        return float(poly_lr(e, self.max_num_epochs, self.initial_lr))


class TrainerV2WarmupSegHeads(TrainerV2WarmupLR):
    """Phase 1 (epochs 0 .. head_warmup_epochs - 1): AdamW at 3e-3 on the
    heads only. Phase 2: SGD over everything under the ramp
    (nnUNetTrainerV2_warmup.py:67-198)."""

    head_warmup_epochs = 10
    head_lr = 3e-3

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.optimizer_phase = 1

    def initialize_optimizer(self):
        for name, p in self.network.named_parameters():
            p.requires_grad_(self.optimizer_phase == 2 or is_seg_head_param(name))
        if self.optimizer_phase == 1:
            return (AdamWClipped(self.network.parameters(), weight_decay=self.weight_decay),
                    lambda step: self.head_lr)
        return super().initialize_optimizer()

    def _switch_to_phase2(self) -> None:
        """A new whole-network optimizer; weights and step counter stay
        (nnUNetTrainerV2_warmup.py:111-117)."""
        self.optimizer_phase = 2
        self.optimizer, self.lr_schedule = self.initialize_optimizer()
        self._wrap_for_ranks()
        self.print_to_log_file("head warmup done: switched to SGD on all parameters")

    def on_epoch_end(self) -> bool:
        cont = super().on_epoch_end()
        if self.optimizer_phase == 1 and self.epoch + 1 >= self.head_warmup_epochs:
            self._switch_to_phase2()
        return cont

    def checkpoint_metadata(self) -> dict:
        meta = super().checkpoint_metadata()
        meta["optimizer_phase"] = self.optimizer_phase
        return meta

    def prepare_for_checkpoint(self, ckpt: dict) -> None:
        """Phase-aware resume: the optimizer state restored must be that of
        the phase the checkpoint was saved in (nnUNetTrainerV2_warmup.py:132-198)."""
        if ckpt.get("optimizer_phase", 1) == 2 and self.optimizer_phase == 1:
            self._switch_to_phase2()


class TrainerV2WarmupSegHeadsResenc(ResencUNetMixin, TrainerV2WarmupSegHeads):
    """The head warm-up over the residual-encoder UNet
    (multitalent_tpu/training/warmup.py:147-158)."""


class TrainerV2WarmupSegHeadsSwin(SwinUNETRMixin, TrainerV2WarmupSegHeads):
    """The head warm-up over a softmax SwinUNETR: phase 1 AdamW on `out.*`,
    phase 2 AdamClipped (AMSGrad) at 5e-4 under the poly schedule
    (multitalent_tpu/training/warmup.py:161-200)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 5e-4

    def initialize_optimizer(self):
        if self.optimizer_phase == 1:
            return TrainerV2WarmupSegHeads.initialize_optimizer(self)
        for p in self.network.parameters():
            p.requires_grad_(True)
        return self.adam_optimizer()
