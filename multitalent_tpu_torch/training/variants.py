"""Trainer variants: the nnU-Net trainers over other networks.

Counterpart of multitalent_tpu/training/variants.py, which holds the
reference's trainer zoo; the port has its SwinUNETR trainers so far (the
rest is ROADMAP queue 1, item 10e):

- `TrainerV2SwinUNETR` (nnUNetTrainerV2_swinunetr_adam_ddp, variants.py:
  840-885; transformers/nnUNetTrainerV2_SwinUNETR_ddp.py:53-120): the plans'
  DC+CE objective over a softmax SwinUNETR, AMSGrad Adam at 1e-3, no deep
  supervision;
- `TrainerV2SwinUNETRlr5e4` (nnUNetTrainerV2_swinunetr_adam_ddp_lr5e4,
  :888-892): the same at 5e-4.
"""
from __future__ import annotations

from multitalent_tpu_torch.training.trainers import SwinUNETRMixin, TrainerV2


class TrainerV2SwinUNETR(SwinUNETRMixin, TrainerV2):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 1e-3


class TrainerV2SwinUNETRlr5e4(TrainerV2SwinUNETR):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 5e-4
