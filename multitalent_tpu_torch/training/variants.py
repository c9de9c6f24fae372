"""Trainer variants: the nnU-Net trainers over other networks, augmentation,
supervision and dtype.

Counterpart of multitalent_tpu/training/variants.py, which holds the
reference's trainer zoo. The port has the variants that change only the
network, the augmentation, the supervision or the dtype; those that change
the loss, the optimizer or the schedule are ROADMAP queue 1, item 10e. Each
class keeps the JAX class's name and registers (cli/train.TRAINERS) under
the same reference aliases:

- SwinUNETR (variants.py:840-892; transformers/nnUNetTrainerV2_SwinUNETR_ddp.py):
  `TrainerV2SwinUNETR`, `TrainerV2SwinUNETRlr5e4`;
- architecture (:255-370), through TrainerV2.network_overrides_for: norm
  (BN without running statistics, GN of 8 groups, FRN, none), activation
  (ReLU, GELU, Mish, LeakyReLU slope 0.2), a bias on the heads, 3 convs a
  stage (at base 24 or the plans' base), all-3x3x3 kernels, and fp32;
- augmentation (:144-205, :730-761): no augmentation, no mirroring, the
  insane / DA5 (= DA3) / DA2 presets, independent scales per axis, DA3 over
  batch norm and over the residual-encoder UNet;
- supervision and benchmarking (:207-231, :710-836): no deep supervision,
  forced batch or sample Dice, the copies, and the benchmarking trainers
  without deep supervision (their CE alone the robust CE).

The JAX package hands a residual-encoder trainer's network_overrides to no
network (its initialize_network builds the resenc from the plans alone), so
`TrainerV2ResencDA3BN` trains an instance-norm network as there.
"""
from __future__ import annotations

from functools import partial

import numpy as np

from multitalent_tpu_torch.augment.params import get_patch_size
from multitalent_tpu_torch.training import losses as L
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
}
