"""Trainer variants: the nnU-Net trainers over other losses, optimizers,
schedules, networks, augmentation, supervision and dtype.

Counterpart of multitalent_tpu/training/variants.py, which holds the
reference's trainer zoo; the port has all of it. Each class keeps the JAX
class's name and registers (cli/train.TRAINERS) under the same reference
aliases:

- losses (:26-103, :372-400, :636-708), through `loss_fn` on
  training/losses.py's zoo, every sum pooled over the ranks: CE, Dice (with
  and without the background), TopK 10%, Dice + TopK, Dice + focal, GDL +
  CE, MCC + CE, squared Dice + CE, DC + CE without smoothing, MCC without
  the background, squared Dice, and the CE -> Dice transition (its weights
  through batch_extras);
- optimizers (:105-142, :402-512, :621-634): AMSGrad Adam at 3e-4, SGD at a
  constant LR, SGD momentum 0.9 / 0.95 / 0.98, Ranger (RAdam with coupled
  weight decay; Lookahead left out, as the JAX package leaves it out), the
  initial-LR ablations, and momentum 0.9 on 2D plans;
- schedules (:451-471, :514-618, :894-903): poly then one cosine cycle over
  the last 100 (or of 1200 epochs the last 200), ReduceLROnPlateau for SGD
  and Adam, the stepped poly of `_SGD_fixedSchedule2`, and the momentum
  falling from 0.99 to 0.9 over epochs 800-1000;
- SwinUNETR (:840-892; transformers/nnUNetTrainerV2_SwinUNETR_ddp.py):
  `TrainerV2SwinUNETR`, `TrainerV2SwinUNETRlr5e4`;
- architecture (:255-370, :906-922), through TrainerV2.network_overrides_for:
  norm (BN without running statistics, GN of 8 groups, FRN, none),
  activation (ReLU, GELU, Mish, LeakyReLU slope 0.2), a bias on the heads,
  3 convs a stage (at base 24 or the plans' base), all-3x3x3 kernels, fp32,
  and conv -> activation -> norm blocks (`nonlin_first`);
- augmentation (:144-205, :730-761): no augmentation, no mirroring, the
  insane / DA5 (= DA3) / DA2 presets, independent scales per axis, DA3 over
  batch norm and over the residual-encoder UNet;
- supervision and benchmarking (:207-231, :710-836): no deep supervision,
  forced batch or sample Dice, the copies, and the benchmarking trainers
  without deep supervision (their CE alone the robust CE);
- the validation export (:925-936): `_resample33`'s cubic resampling.

The JAX package hands a residual-encoder trainer's network_overrides to no
network (its initialize_network builds the resenc from the plans alone), so
`TrainerV2ResencDA3BN` trains an instance-norm network as there.

Three faults of the JAX classes are not inherited: `_SGD_fixedSchedule2`
overrides only the LR it reports, so its optax chain keeps plain poly (here
the optimizer takes the stepped LR); `_reduceMomentumDuringTraining`
swallows every exception around its momentum update (here a failure
raises); the plateau trainers' class attribute `lr_threshold` (1e-3) is
shadowed by the trainer base's instance attribute of the same name (1e-6,
the patience's LR floor), so the JAX trainers wait for improvements of
1e-6 (here `plateau_threshold`, 1e-3, as the reference's
ReduceLROnPlateau).
"""
from __future__ import annotations

from functools import partial

import numpy as np

from multitalent_tpu_torch.augment.params import get_patch_size
from multitalent_tpu_torch.training import losses as L
from multitalent_tpu_torch.training.schedules import (cosine_onecycle_schedule,
                                                      join_schedules, make_constant_schedule,
                                                      make_poly_schedule,
                                                      make_stepped_poly_schedule,
                                                      stepped_poly_lr)
from multitalent_tpu_torch.training.train_state import AdamClipped, RAdam, SGDDecayThenClip
from multitalent_tpu_torch.training.trainers import (ResencUNetMixin, SwinUNETRMixin,
                                                     TrainerV2, TrainerV2_5epochs,
                                                     TrainerV2_dummyLoad)


class TrainerV2SwinUNETR(SwinUNETRMixin, TrainerV2):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 1e-3


class TrainerV2SwinUNETRlr5e4(TrainerV2SwinUNETR):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 5e-4


# ----------------------------------------------------------------- DA variants
class TrainerV2NoDA(TrainerV2):
    """No augmentation: patches pass at the final size, center-cropped
    (variants.py:144)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        p = self.data_aug_params
        p["do_rotation"] = False
        p["p_rot"] = 0.0
        p["do_scaling"] = False
        p["p_scale"] = 0.0
        p["do_mirror"] = False
        p["do_gamma"] = False
        for key in ("p_gaussian_noise", "p_gaussian_blur", "p_brightness_mult",
                    "p_contrast", "p_lowres", "p_gamma", "p_gamma_invert"):
            p[key] = 0.0
        self.basic_generator_patch_size = np.array(self.patch_size, dtype=int)


class TrainerV2NoMirroring(TrainerV2):
    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.data_aug_params["do_mirror"] = False


class TrainerV2InsaneDA(TrainerV2):
    """Wider rotations and scaling, stronger intensity (variants.py:172)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        p = self.data_aug_params
        p["p_rot"] = 0.7
        p["scale_range"] = (0.65, 1.6)
        p["p_scale"] = 0.65
        p["p_gamma"] = 0.5
        p["p_gaussian_noise"] = 0.15
        self.basic_generator_patch_size = get_patch_size(
            self.patch_size, p["rotation_x"], p["rotation_y"], p["rotation_z"],
            p["scale_range"])


class TrainerV2DA5(TrainerV2InsaneDA):
    """The DA5 (= DA3) preset: insaneDA with more blur, brightness, contrast
    and low resolution (variants.py:191)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        p = self.data_aug_params
        p["p_gaussian_blur"] = 0.3
        p["p_brightness_mult"] = 0.3
        p["p_contrast"] = 0.3
        p["p_lowres"] = 0.35


class TrainerV2DA2(TrainerV2):
    """Independent per-axis scale, per-axis rotation probability, additive
    brightness (variants.py:730)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.data_aug_params["independent_scale_factor_for_each_axis"] = True
        self.data_aug_params["rotation_p_per_axis"] = 0.5 if self.threeD else 1.0
        self.data_aug_params["do_additive_brightness"] = True


class TrainerV2IndependentScale(TrainerV2):
    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.data_aug_params["independent_scale_factor_for_each_axis"] = True


# ----------------------------------------------------------- supervision / misc
class TrainerV2NoDeepSupervision(TrainerV2):
    """The full-resolution output alone, DC+CE of weight 1 (variants.py:207)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.deep_supervision = False

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.deep_supervision_scales = [[1.0, 1.0, 1.0]]


class TrainerV2ResencUNetDA3(ResencUNetMixin, TrainerV2DA5):
    """The residual-encoder UNet under the DA3 preset (variants.py:233)."""


class TrainerV2ForceBD(TrainerV2):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_dice = True


class TrainerV2ForceSD(TrainerV2):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.batch_dice = False


# ------------------------------------------------------- architectural variants
class TrainerV2BN(TrainerV2):
    """BatchNorm over the batch's statistics, in eval too (variants.py:255)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"norm": "batch"}


class TrainerV2GN(TrainerV2):
    """GroupNorm of 8 groups (variants.py:263)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"norm": "group"}


class TrainerV2FRN(TrainerV2):
    """Filter response norm, its TLU the activation (variants.py:271)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"norm": "frn"}


class TrainerV2NoNorm(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"norm": "none"}


class TrainerV2NoNormLR1en3(TrainerV2NoNorm):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 1e-3


class TrainerV2ReLU(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin": "relu"}


class TrainerV2GeLU(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin": "gelu"}


class TrainerV2Mish(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin": "mish"}


class TrainerV2LReLUSlope2en1(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"negative_slope": 2e-1}


class TrainerV2ReLUBiasInSegOutput(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin": "relu", "seg_output_bias": True}


class TrainerV2LReLUBiasInSegOutput(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"seg_output_bias": True}


class TrainerV2_3ConvPerStage(TrainerV2):
    """3 convs a stage at base 24 (variants.py:333)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"conv_per_stage": 3, "base_num_features": 24}


class TrainerV2_3ConvPerStageSameFilters(TrainerV2):
    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"conv_per_stage": 3}


class TrainerV2AllConv3x3(TrainerV2):
    """Every conv kernel 3 on each axis, the plans' anisotropic ones too
    (variants.py:350)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        st = plans.stage(stage)
        dim = len(st.patch_size)
        return {"conv_kernel_sizes": ((3,) * dim,) * len(st.conv_kernel_sizes)}


class TrainerV2FP32(TrainerV2):
    """fp32 compute (variants.py:362): the kernels' fp32 forms."""

    def __init__(self, plans_file, fold, output_folder=None, dataset_directory=None,
                 batch_dice=True, stage=None, unpack_data=True, deterministic=True,
                 fp16=True, seed: int = 12345, device="cuda"):
        super().__init__(plans_file, fold, output_folder, dataset_directory, batch_dice,
                         stage, unpack_data, deterministic, fp16=False, seed=seed,
                         device=device)


class TrainerV2DA3BN(TrainerV2DA5):
    """The DA3 preset over a batch-norm network (variants.py:749)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {**super().network_overrides_for(plans, stage), "norm": "batch"}


class TrainerV2ResencDA3BN(TrainerV2ResencUNetDA3):
    """Its overrides ask for batch norm, which the residual-encoder network
    never reads (as in the JAX package, variants.py:758)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {**super().network_overrides_for(plans, stage), "norm": "batch"}


# -------------------------------------------------------------- benchmark combos
class TrainerV2_2epochsDummyLoad(TrainerV2_dummyLoad):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 2


class _NoDSMixin:
    """No deep supervision (the benchmarking *noDS variants, variants.py:
    788-817): the full-resolution output alone, DC+CE, or the robust CE
    alone where `_ce_only`."""

    _ce_only = False

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.deep_supervision = False

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.deep_supervision_scales = [[1.0, 1.0, 1.0]]

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {**super().network_overrides_for(plans, stage), "deep_supervision": False}

    def loss_fn(self, outputs, targets, extras):
        fn = (partial(L.robust_cross_entropy, group=self.process_group) if self._ce_only
              else partial(L.dc_and_ce_loss, batch_dice=self.batch_dice,
                           group=self.process_group))
        return L.deep_supervision_loss(outputs, targets, fn, [1.0]), {}


class TrainerV2_5epochsNoDS(_NoDSMixin, TrainerV2_5epochs):
    pass


class TrainerV2_5epochsCEnoDS(_NoDSMixin, TrainerV2_5epochs):
    _ce_only = True


class TrainerV2_5epochsDummyCEnoDS(_NoDSMixin, TrainerV2_dummyLoad):
    _ce_only = True


class _InitialLR:
    """Sets initial_lr to the class's `lr` once the trainer is built."""

    lr: float

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = self.lr


# ---------------------------------------------------------------- loss variants
class _LossVariant(TrainerV2):
    """The deep-supervised sum of `level_loss` over the levels (the JAX
    classes' loss_fn), every sum pooled over the ranks of the process group."""

    def level_loss(self, o, t, extras: dict):
        raise NotImplementedError

    def loss_fn(self, outputs, targets, extras):
        weights = [float(w) for w in self.ds_loss_weights]
        return L.deep_supervision_loss(outputs, targets,
                                       lambda o, t: self.level_loss(o, t, extras), weights), {}

    def _dice(self, o, t, do_bg: bool = False):
        return L.soft_dice_loss(o, t, batch_dice=self.batch_dice, do_bg=do_bg,
                                group=self.process_group)

    def _ce(self, o, t):
        return L.robust_cross_entropy(o, t, group=self.process_group)


class TrainerV2LossCE(_LossVariant):
    """Cross-entropy only (variants.py:27)."""

    def level_loss(self, o, t, extras):
        return self._ce(o, t)


class TrainerV2LossDice(_LossVariant):
    """Soft Dice only, without the background (variants.py:37)."""

    def level_loss(self, o, t, extras):
        return self._dice(o, t)


class TrainerV2LossDiceBG(_LossVariant):
    def level_loss(self, o, t, extras):
        return self._dice(o, t, do_bg=True)


class TrainerV2LossTopKOnly(_LossVariant):
    """TopK-10% CE only (variants.py:55)."""

    def level_loss(self, o, t, extras):
        return L.topk_cross_entropy(o, t, k_percent=10.0, group=self.process_group)


class TrainerV2LossTopK(_LossVariant):
    """Dice + TopK-10% CE (variants.py:66)."""

    def level_loss(self, o, t, extras):
        return self._dice(o, t) + L.topk_cross_entropy(o, t, k_percent=10.0,
                                                       group=self.process_group)


class TrainerV2FocalLoss(_LossVariant):
    def level_loss(self, o, t, extras):
        return self._dice(o, t) + L.focal_ce_loss(o, t, group=self.process_group)


class TrainerV2GDL(_LossVariant):
    def level_loss(self, o, t, extras):
        return L.gdl_loss(o, t, group=self.process_group) + self._ce(o, t)


class TrainerV2LossCEGDL(TrainerV2GDL):
    """GDL + CE, as TrainerV2GDL (variants.py:637)."""


class TrainerV2LossMCC(_LossVariant):
    """MCC + CE (variants.py:372)."""

    def level_loss(self, o, t, extras):
        return L.mcc_loss(o, t, group=self.process_group) + self._ce(o, t)


class TrainerV2LossMCCnoBG(_LossVariant):
    def level_loss(self, o, t, extras):
        return L.mcc_loss(o, t, do_bg=False, group=self.process_group)


class TrainerV2LossSquaredDice(_LossVariant):
    """Squared-denominator Dice + CE (variants.py:386)."""

    def level_loss(self, o, t, extras):
        return L.squared_dice_loss(o, t, batch_dice=self.batch_dice, do_bg=False,
                                   group=self.process_group) + self._ce(o, t)


class TrainerV2LossDiceSquared(_LossVariant):
    def level_loss(self, o, t, extras):
        return L.squared_dice_loss(o, t, batch_dice=self.batch_dice, do_bg=False,
                                   group=self.process_group)


class TrainerV2LossDiceCENoSmooth(_LossVariant):
    """DC + CE with the Dice's smoothing 0 (variants.py:650)."""

    def level_loss(self, o, t, extras):
        return L.dc_and_ce_loss(o, t, batch_dice=self.batch_dice, smooth=0.0,
                                group=self.process_group)


class TrainerV2CEtoDice(_LossVariant):
    """CE alone to epoch 500, a linear CE -> Dice blend to 750, Dice alone
    after, at total weight 2 (variants.py:678); the weights of the epoch
    reach the step as tensors of batch_extras."""

    def ce_dice_weights(self) -> tuple[float, float]:
        ep = min(self.epoch, self.max_num_epochs)
        if ep <= 500:
            return 2.0, 0.0
        if ep <= 750:
            w = 2.0 / 250 * (ep - 500)
            return 2.0 - w, w
        return 0.0, 2.0

    def batch_extras(self, batch):
        w_ce, w_dc = self.ce_dice_weights()
        return {"w_ce": np.float32(w_ce), "w_dc": np.float32(w_dc)}

    def level_loss(self, o, t, extras):
        return extras["w_ce"] * self._ce(o, t) + extras["w_dc"] * self._dice(o, t)


# ----------------------------------------------------------- optimizer variants
class TrainerV2Momentum09(TrainerV2):
    def sgd_momentum(self) -> float:
        return 0.9


class TrainerV2Momentum095(TrainerV2):
    def sgd_momentum(self) -> float:
        return 0.95


class TrainerV2Momentum098(TrainerV2):
    def sgd_momentum(self) -> float:
        return 0.98


class TrainerV2Momentum09in2D(TrainerV2):
    """Momentum 0.9 for a 2D plan, 0.99 in 3D (variants.py:621)."""

    def sgd_momentum(self) -> float:
        return 0.99 if self.threeD else 0.9


class TrainerV2Adam(_InitialLR, TrainerV2):
    """AMSGrad Adam at 3e-4 under the poly staircase (variants.py:105;
    make_adam_optimizer: clip, AMSGrad, decoupled weight decay)."""

    lr = 3e-4

    def initialize_optimizer(self):
        return (AdamClipped(self.network.parameters(), weight_decay=self.weight_decay,
                            clip_norm=12.0),
                make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                   self.num_batches_per_epoch))


class TrainerV2AdamTrainerLR(TrainerV2Adam):
    """Adam at nnUNetTrainer's 3e-4 (variants.py:505)."""


class TrainerV2ConstLR(TrainerV2):
    """SGD at a constant initial_lr (variants.py:120)."""

    def initialize_optimizer(self):
        return super().initialize_optimizer()[0], make_constant_schedule(self.initial_lr)

    def current_lr(self) -> float:
        return float(self.initial_lr)


class TrainerV2Ranger(_InitialLR, TrainerV2):
    """Ranger at 3e-4 (variants.py:424): RAdam with coupled weight decay
    under the poly staircase, no clipping; Lookahead's slow weights are left
    out, as the JAX package leaves them out."""

    lr = 3e-4

    def initialize_optimizer(self):
        return (RAdam(self.network.parameters(), weight_decay=self.weight_decay),
                make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                   self.num_batches_per_epoch))


# the initial-LR ablations (variants.py:474-502)
class TrainerV2SGDlr1en1(_InitialLR, TrainerV2):
    lr = 1e-1


class TrainerV2SGDlr1en3(_InitialLR, TrainerV2):
    lr = 1e-3


class TrainerV2LossDiceLR1en3(_InitialLR, TrainerV2LossDice):
    lr = 1e-3


class TrainerV2LossDiceBGLR1en3(_InitialLR, TrainerV2LossDiceBG):
    lr = 1e-3


class TrainerV2Rangerlr1en2(TrainerV2Ranger):
    lr = 1e-2


class TrainerV2Rangerlr3en3(TrainerV2Ranger):
    lr = 3e-3


# ------------------------------------------------------------ schedule variants
class TrainerV2CycleAtEnd(TrainerV2):
    """Poly over all but the last `cycle_epochs` epochs, then one cosine
    cycle (optax's onecycle at its defaults) back up to the initial LR and
    down (variants.py:451)."""

    cycle_epochs = 100

    def initialize_optimizer(self):
        ipe = self.num_batches_per_epoch
        main_epochs = max(self.max_num_epochs - self.cycle_epochs, 1)
        schedule = join_schedules(
            [make_poly_schedule(self.initial_lr, main_epochs, ipe),
             cosine_onecycle_schedule(self.cycle_epochs * ipe, self.initial_lr)],
            [main_epochs * ipe])
        return super().initialize_optimizer()[0], schedule


class TrainerV2CycleAtEnd2(TrainerV2CycleAtEnd):
    """1200 epochs: poly over 1000, then a 200-epoch cycle (variants.py:894)."""

    cycle_epochs = 200

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 1200


class _PlateauMixin:
    """ReduceLROnPlateau on the train loss's moving average (variants.py:515;
    nnUNetTrainer's: patience 30, threshold 1e-3 absolute, factor 0.2), the
    LR floored at 1e-6; the optimizer's state persists across a reduction.
    The threshold is `plateau_threshold`: the JAX class's `lr_threshold` is
    shadowed by the base's patience floor (1e-6) and never read."""

    plateau_patience = 30
    plateau_threshold = 1e-3

    def initialize_optimizer(self):
        self.plateau_lr = float(self.initial_lr)
        self._best_ma = None
        self._worse_epochs = 0
        return self.plateau_optimizer(), lambda step: self.plateau_lr

    def maybe_update_lr(self) -> None:
        ma = self.train_loss_MA
        if ma is None:
            return
        if self._best_ma is None or ma < self._best_ma - self.plateau_threshold:
            self._best_ma = ma
            self._worse_epochs = 0
        else:
            self._worse_epochs += 1
        if self._worse_epochs > self.plateau_patience:
            self.plateau_lr = max(self.plateau_lr * 0.2, 1e-6)
            self._worse_epochs = 0
            self.print_to_log_file(f"plateau: reducing lr to {self.plateau_lr}")

    def current_lr(self) -> float:
        return self.plateau_lr


class TrainerV2SGDPlateau(_PlateauMixin, TrainerV2):
    def plateau_optimizer(self):
        return TrainerV2.initialize_optimizer(self)[0]


class TrainerV2AdamPlateau(_PlateauMixin, _InitialLR, TrainerV2):
    lr = 3e-4

    def plateau_optimizer(self):
        return AdamClipped(self.network.parameters(), weight_decay=self.weight_decay,
                           clip_norm=12.0)


class TrainerV2FixedSchedule2(TrainerV2):
    """The stepped poly (variants.py:569): poly before epoch 700, then poly
    from the LR poly gives at 700, from 900 from the LR at 900. The JAX class
    overrides only current_lr, so its optimizer keeps plain poly; here the
    optimizer takes the stepped LR."""

    def initialize_optimizer(self):
        return super().initialize_optimizer()[0], make_stepped_poly_schedule(
            self.initial_lr, self.max_num_epochs, self.num_batches_per_epoch)

    def current_lr(self) -> float:
        return stepped_poly_lr(self.epoch, self.max_num_epochs, self.initial_lr)


class TrainerV2ReduceMomentum(TrainerV2):
    """Momentum 0.99, falling linearly to 0.9 over epochs 800-1000
    (variants.py:587), on the chain decay -> clip -> Nesterov trace -> LR
    (SGDDecayThenClip) under the poly staircase; the momentum set at an
    epoch's end serves the next epoch's steps, the trace carries over. A
    failure to set it raises (the JAX class swallows every exception)."""

    def initialize_optimizer(self):
        return (SGDDecayThenClip(self.network.parameters(), momentum=0.99,
                                 weight_decay=self.weight_decay, clip_norm=12.0),
                make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                   self.num_batches_per_epoch))

    def current_momentum(self) -> float:
        if self.epoch > 800:
            return 0.99 - (0.99 - 0.9) / 200 * (self.epoch - 800)
        return 0.99

    def maybe_update_lr(self) -> None:
        super().maybe_update_lr()
        m = self.current_momentum()
        self.optimizer.momentum = m
        self.print_to_log_file(f"current momentum {m:.4f}")


# ---------------------------------------------------------- network variants
class TrainerV2ReLUConvReLUIN(TrainerV2):
    """ReLU, blocks conv -> ReLU -> InstanceNorm (variants.py:906)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin": "relu", "nonlin_first": True}


class TrainerV2LReLUConvReLUIN(TrainerV2):
    """LeakyReLU, blocks conv -> LeakyReLU -> InstanceNorm (variants.py:916)."""

    @classmethod
    def network_overrides_for(cls, plans, stage: int) -> dict:
        return {"nonlin_first": True}


class TrainerV2Resample33(TrainerV2):
    """The validation export resamples the softmax cubically in 3D
    (interpolation_order 3, force_separate_z False, interpolation_order_z 3;
    variants.py:925) unless the caller gives export kwargs."""

    def validate(self, *args, **kwargs):
        if kwargs.get("segmentation_export_kwargs") is None:
            kwargs["segmentation_export_kwargs"] = {
                "interpolation_order": 3, "force_separate_z": False,
                "interpolation_order_z": 3}
        return super().validate(*args, **kwargs)


# trainer class -> its reference names (the JAX registry's aliases)
VARIANT_ALIASES = {
    TrainerV2SwinUNETR: ("nnUNetTrainerV2_swinunetr_adam_ddp",),
    TrainerV2SwinUNETRlr5e4: ("nnUNetTrainerV2_swinunetr_adam_ddp_lr5e4",),
    TrainerV2NoDA: ("nnUNetTrainerV2_noDataAugmentation", "nnUNetTrainerV2_noDA",
                    "nnUNetTrainerNoDA"),
    TrainerV2NoMirroring: ("nnUNetTrainerV2_noMirroring",),
    TrainerV2InsaneDA: ("nnUNetTrainerV2_insaneDA",),
    TrainerV2DA5: ("nnUNetTrainerV2_DA5", "nnUNetTrainerV2_DA3"),
    TrainerV2DA2: ("nnUNetTrainerV2_DA2",),
    TrainerV2IndependentScale: ("nnUNetTrainerV2_independentScalePerAxis",),
    TrainerV2NoDeepSupervision: ("nnUNetTrainerV2_noDeepSupervision",),
    TrainerV2ResencUNetDA3: ("nnUNetTrainerV2_ResencUNet_DA3",),
    TrainerV2ForceBD: ("nnUNetTrainerV2_ForceBD",),
    TrainerV2ForceSD: ("nnUNetTrainerV2_ForceSD",),
    TrainerV2BN: ("nnUNetTrainerV2_BN",),
    TrainerV2GN: ("nnUNetTrainerV2_GN",),
    TrainerV2FRN: ("nnUNetTrainerV2_FRN",),
    TrainerV2NoNorm: ("nnUNetTrainerV2_NoNormalization",),
    TrainerV2NoNormLR1en3: ("nnUNetTrainerV2_NoNormalization_lr1en3",),
    TrainerV2ReLU: ("nnUNetTrainerV2_ReLU",),
    TrainerV2GeLU: ("nnUNetTrainerV2_GeLU",),
    TrainerV2Mish: ("nnUNetTrainerV2_Mish",),
    TrainerV2LReLUSlope2en1: ("nnUNetTrainerV2_LReLU_slope_2en1",),
    TrainerV2ReLUBiasInSegOutput: ("nnUNetTrainerV2_ReLU_biasInSegOutput",),
    TrainerV2LReLUBiasInSegOutput: ("nnUNetTrainerV2_lReLU_biasInSegOutput",),
    TrainerV2_3ConvPerStage: ("nnUNetTrainerV2_3ConvPerStage",),
    TrainerV2_3ConvPerStageSameFilters: ("nnUNetTrainerV2_3ConvPerStageSameFilters",),
    TrainerV2AllConv3x3: ("nnUNetTrainerV2_allConv3x3",),
    TrainerV2FP32: ("nnUNetTrainerV2_fp32",),
    TrainerV2DA3BN: ("nnUNetTrainerV2_DA3_BN",),
    TrainerV2ResencDA3BN: ("nnUNetTrainerV2_ResencUNet_DA3_BN",),
    TrainerV2_2epochsDummyLoad: ("nnUNetTrainerV2_2epochs_dummyLoad",),
    TrainerV2_5epochsNoDS: ("nnUNetTrainerV2_5epochs_noDS",),
    TrainerV2_5epochsCEnoDS: ("nnUNetTrainerV2_5epochs_CEnoDS",),
    TrainerV2_5epochsDummyCEnoDS: ("nnUNetTrainerV2_5epochs_dummyLoadCEnoDS",),
    TrainerV2LossCE: ("nnUNetTrainerV2_Loss_CE", "nnUNetTrainerCE"),
    TrainerV2LossDice: ("nnUNetTrainerV2_Loss_Dice",),
    TrainerV2LossDiceBG: ("nnUNetTrainerV2_Loss_DicewithBG",),
    TrainerV2LossTopKOnly: ("nnUNetTrainerV2_Loss_TopK10",),
    TrainerV2LossTopK: ("nnUNetTrainerV2_Loss_CEandTopK10", "nnUNetTrainerV2_Loss_DiceTopK10"),
    TrainerV2FocalLoss: ("nnUNetTrainerV2_focalLoss",),
    TrainerV2GDL: ("nnUNetTrainerV2_GDL",),
    TrainerV2LossCEGDL: ("nnUNetTrainerV2_Loss_CEGDL",),
    TrainerV2LossMCC: ("nnUNetTrainerV2_Loss_MCC",),
    TrainerV2LossMCCnoBG: ("nnUNetTrainerV2_Loss_MCCnoBG",),
    TrainerV2LossSquaredDice: ("nnUNetTrainerV2_Loss_DC_CE_squared",
                               "nnUNetTrainerV2_SquaredDiceCE"),
    TrainerV2LossDiceSquared: ("nnUNetTrainerV2_Loss_Dice_squared",),
    TrainerV2LossDiceCENoSmooth: ("nnUNetTrainerV2_Loss_DiceCE_noSmooth",),
    TrainerV2CEtoDice: ("nnUNetTrainerV2_graduallyTransitionFromCEToDice",),
    TrainerV2Adam: ("nnUNetTrainerV2_Adam",),
    TrainerV2AdamTrainerLR: ("nnUNetTrainerV2_Adam_nnUNetTrainerlr",),
    TrainerV2ConstLR: ("nnUNetTrainerV2_SGD_fixedSchedule", "nnUNetTrainerV2_constLR"),
    TrainerV2Momentum09: ("nnUNetTrainerV2_momentum09",),
    TrainerV2Momentum095: ("nnUNetTrainerV2_momentum095",),
    TrainerV2Momentum098: ("nnUNetTrainerV2_momentum098",),
    TrainerV2Momentum09in2D: ("nnUNetTrainerV2_momentum09in2D",),
    TrainerV2Ranger: ("nnUNetTrainerV2_Ranger_lr3en4", "nnUNetTrainerV2_Ranger"),
    TrainerV2SGDlr1en1: ("nnUNetTrainerV2_SGD_lr1en1",),
    TrainerV2SGDlr1en3: ("nnUNetTrainerV2_SGD_lr1en3",),
    TrainerV2LossDiceLR1en3: ("nnUNetTrainerV2_Loss_Dice_LR1en3",),
    TrainerV2LossDiceBGLR1en3: ("nnUNetTrainerV2_Loss_DicewithBG_LR1en3",),
    TrainerV2Rangerlr1en2: ("nnUNetTrainerV2_Ranger_lr1en2",),
    TrainerV2Rangerlr3en3: ("nnUNetTrainerV2_Ranger_lr3en3",),
    TrainerV2CycleAtEnd: ("nnUNetTrainerV2_cycleAtEnd",),
    TrainerV2CycleAtEnd2: ("nnUNetTrainerV2_cycleAtEnd2",),
    TrainerV2SGDPlateau: ("nnUNetTrainerV2_SGD_ReduceOnPlateau",),
    TrainerV2AdamPlateau: ("nnUNetTrainerV2_Adam_ReduceOnPlateau",),
    TrainerV2FixedSchedule2: ("nnUNetTrainerV2_SGD_fixedSchedule2",),
    TrainerV2ReduceMomentum: ("nnUNetTrainerV2_reduceMomentumDuringTraining",),
    TrainerV2ReLUConvReLUIN: ("nnUNetTrainerV2_ReLU_convReLUIN",),
    TrainerV2LReLUConvReLUIN: ("nnUNetTrainerV2_lReLU_convReLUIN",),
    TrainerV2Resample33: ("nnUNetTrainerV2_resample33",),
}
