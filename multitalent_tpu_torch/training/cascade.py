"""The 3d_lowres -> 3d_cascade_fullres pipeline.

Counterpart of multitalent_tpu/training/cascade.py (nnUNetTrainerV2_
CascadeFullRes.py, pyramid_augmentations.py:23-139, predict_next_stage.py:
31-46):

- `predict_next_stage` (cli/train.py runs it after 3d_lowres): the lowres
  model's labelmap of every case, without mirroring, resampled (linear, as
  a segmentation) to the next stage's grid and written as
  `<case>_segFromPrevStage.npz` (uint8) beside that stage's data; over
  several ranks each writes `sorted(cases)[rank::world_size]`;
- `TrainerV2CascadeFullRes`: the full-resolution stage, whose GenericUNet
  reads the modalities plus one-hots of the previous stage's num_classes - 1
  foreground classes. Its host sampler (`CascadePatchSampler3D`) crops the
  previous stage's labels with the patch and, in training, removes a random
  connected component of them (`remove_random_component`, scipy's
  6-connected labelling, numbered as the JAX package's native labeller
  numbers); its augmentation on the card warps the one-hots with the image,
  corrupts them by random dilation or erosion and mirrors everything
  together (augment/pipeline.make_cascade_augment_fn); its validation
  appends the one-hots of `<case>_segFromPrevStage.npz` to each case
  (inference/validation.run_cascade_validation);
- the eight variants of nnUNet_variants/cascade/*.py, which change the
  schedule or the corruption only.

The trainers' names are the JAX registry's aliases (cli/train.TRAINERS).
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
from scipy.ndimage import label as scipy_label

from multitalent_tpu_torch.augment.pipeline import (make_cascade_augment_fn,
                                                    make_cascade_val_transform_fn)
from multitalent_tpu_torch.data.dataset import load_case
from multitalent_tpu_torch.data.loader import PatchSampler3D
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.preprocessing.resampling import resample_data_or_seg
from multitalent_tpu_torch.training.trainers import RANK_SEED_STRIDE, TrainerV2
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir


def remove_random_component(seg_patch: np.ndarray, rng: np.random.RandomState,
                            p_per_label: float = 1.0,
                            max_coverage: float = 0.15) -> np.ndarray:
    """Random connected-component removal on a previous-stage label patch
    (RemoveRandomConnectedComponentFromOneHotEncodingTransform parity,
    pyramid_augmentations.py:23-63: only components covering less than
    `max_coverage` of the patch are eligible)."""
    out = seg_patch.copy()
    for c in np.unique(out):
        if c <= 0 or rng.uniform() >= p_per_label:
            continue
        mask = out == c
        if mask.mean() == 0 or mask.mean() > max_coverage:
            continue
        lmap, n = scipy_label(mask.astype(np.uint8))
        if n == 0:
            continue
        victim = rng.randint(1, n + 1)
        out[lmap == victim] = 0
    return out


class CascadePatchSampler3D(PatchSampler3D):
    """Samples (data, [gt_seg, prev_stage_seg]) patches. The previous-stage
    segmentation lives in `<case>_segFromPrevStage.npz` next to the preprocessed
    data (written by predict_next_stage) and is cropped with the same bbox;
    CC-removal corruption is applied here when `corrupt=True` (training only)."""

    def __init__(self, *args, corrupt: bool = True,
                 cc_p_per_sample: float = 0.2, cc_p_per_label: float = 1.0,
                 cc_max_coverage: float = 0.15, **kwargs):
        kwargs["has_prev_stage"] = True
        super().__init__(*args, **kwargs)
        self.corrupt = corrupt
        # RemoveRandomConnectedComponentFromOneHotEncodingTransform knobs
        # (cascade_remove_conn_comp_* in data_aug_params,
        # nnUNetTrainerV2_CascadeFullRes.py:107-109)
        self.cc_p_per_sample = cc_p_per_sample
        self.cc_p_per_label = cc_p_per_label
        self.cc_max_coverage = cc_max_coverage

    def _load_prev(self, key: str) -> np.ndarray:
        folder = os.path.dirname(self._data[key]["data_file"])
        return np.load(prev_stage_file(folder, key))["data"]  # (1, Z, Y, X)

    def _sample_patch(self, key: str, force_fg: bool):
        properties = self._properties(key)
        case_all_data = load_case(self._data[key], self.memmap_mode)
        bbox_lb = self._choose_bbox(np.array(case_all_data.shape[1:]), properties,
                                    force_fg)
        data = self._crop_pad(case_all_data[:-1], bbox_lb, self.pad_mode, 0)
        seg = self._crop_pad(case_all_data[-1:], bbox_lb, "constant", -1)
        prev = self._crop_pad(self._load_prev(key), bbox_lb, "constant", 0)
        if self.corrupt and self.rng.uniform() < self.cc_p_per_sample:
            prev[0] = remove_random_component(prev[0], self.rng,
                                              p_per_label=self.cc_p_per_label,
                                              max_coverage=self.cc_max_coverage)
        return data, np.concatenate([seg, prev.astype(np.float32)]), properties


def one_hot_prev_stage_channels(prev_seg: np.ndarray, num_fg_classes: int) -> np.ndarray:
    """(Z, Y, X) labels -> (num_fg_classes, Z, Y, X) one-hot of foreground classes
    (to_one_hot role for inference inputs)."""
    out = np.zeros((num_fg_classes, *prev_seg.shape), np.float32)
    for i in range(num_fg_classes):
        out[i] = prev_seg == (i + 1)
    return out


def prev_stage_file(folder: str, key: str) -> str:
    """The previous stage's labels of case `key` beside the stage's data."""
    return os.path.join(folder, f"{key}_segFromPrevStage.npz")


class TrainerV2CascadeFullRes(TrainerV2):
    """Stage-1 (fullres) trainer of the cascade. Network input = image modalities
    + one-hot of the previous stage's foreground classes."""

    def __init__(self, plans_file, fold, output_folder=None, dataset_directory=None,
                 batch_dice=True, stage=None, unpack_data=True, deterministic=True,
                 fp16=True, previous_trainer: str = "TrainerV2", seed: int = 12345,
                 device: str | torch.device = "cuda"):
        super().__init__(plans_file, fold, output_folder, dataset_directory, batch_dice,
                         stage, unpack_data, deterministic, fp16, seed=seed, device=device)
        self.init_args = (plans_file, fold, output_folder, dataset_directory, batch_dice,
                          stage, unpack_data, deterministic, fp16, previous_trainer)
        self.previous_trainer = previous_trainer

    @property
    def num_prev_classes(self) -> int:
        return self.num_classes - 1  # foreground classes of the previous stage

    @property
    def network_input_channels(self) -> int:
        """The modalities and the previous stage's one-hots."""
        return self.num_input_channels + self.num_prev_classes

    def initialize_network(self) -> None:
        self.network = build_unet_from_plans(
            self.plans, self.stage, num_classes=self.num_classes,
            dtype=torch.bfloat16 if self.fp16 else torch.float32,
            input_channels=self.network_input_channels)

    def get_basic_generators(self):
        """This rank's cascade samplers (corrupting in training only); the
        previous stage's segmentations must exist."""
        self.load_dataset()
        self.do_split()
        prev_file = prev_stage_file(self.folder_with_preprocessed_data, sorted(self.dataset)[0])
        if not os.path.isfile(prev_file):
            raise FileNotFoundError(
                "Cannot train the cascade: previous-stage segmentations are missing. Run "
                "3d_lowres training (which exports them via predict_next_stage) first. "
                f"Expected e.g. {prev_file}")
        dap = self.data_aug_params

        def sampler(dataset, patch_size, seed: int, corrupt: bool):
            kwargs = dict(
                cc_p_per_sample=float(dap.get("cascade_remove_conn_comp_p", 0.2)),
                cc_p_per_label=float(dap.get("cascade_remove_conn_comp_p_per_label", 1.0)),
                cc_max_coverage=float(dap.get(
                    "cascade_remove_conn_comp_max_size_percent_threshold", 0.15))
            ) if corrupt else {}
            return CascadePatchSampler3D(
                dataset, patch_size, self.patch_size, self.local_batch_size, corrupt=corrupt,
                oversample_foreground_percent=self.local_oversample, pad_mode="constant",
                seed=seed + RANK_SEED_STRIDE * self.layout.data_index, **kwargs)

        return (lambda w: sampler(self.dataset_tr, self.basic_generator_patch_size,
                                  self.seed + w, True),
                lambda w: sampler(self.dataset_val, self.patch_size, self.seed + 1000 + w,
                                  False))

    def _build_step_functions(self) -> None:
        """The cascade's augmentation and validation transform in place of
        the plain ones (joint warp, intensity on the image only, one-hot
        corruption, joint mirror)."""
        super()._build_step_functions()
        self._augment = make_cascade_augment_fn(
            self.patch_size, self.deep_supervision_scales, self.data_aug_params,
            self.num_input_channels, self.num_prev_classes)
        self._val_transform = make_cascade_val_transform_fn(
            self.patch_size, self.deep_supervision_scales, self.data_aug_params,
            self.num_input_channels, self.num_prev_classes)

    def predict_preprocessed_probabilities(self, data: np.ndarray, do_mirroring: bool = True,
                                           step_size: float = 0.5, use_gaussian: bool = True):
        """`data` must already carry the one-hot previous-stage channels appended
        (modalities + num_prev_classes channels)."""
        if data.shape[0] != self.network_input_channels:
            raise ValueError(
                f"cascade inference expects {self.num_input_channels}+{self.num_prev_classes} "
                f"channels, got {data.shape[0]} (append the one-hot previous-stage "
                "segmentation)")
        return super().predict_preprocessed_probabilities(data, do_mirroring, step_size,
                                                          use_gaussian)

    def validate(self, *args, **kwargs):
        """Validation with the previous stage's one-hots appended to each case
        (inference/validation.py:run_cascade_validation)."""
        from multitalent_tpu_torch.inference.validation import run_cascade_validation
        return run_cascade_validation(self, *args, **kwargs)


def predict_next_stage(trainer, stage_to_be_predicted_folder: str) -> list[dict]:
    """Export the lowres model's segmentation of EVERY case, resampled to the next
    stage's grid, as `<case>_segFromPrevStage.npz`
    (predict_next_stage.py:31-46). Returns one dict a case this rank wrote:
    its `predict_s`, `forwards` and `net_calls`."""
    maybe_mkdir(stage_to_be_predicted_folder)
    if getattr(trainer, "dataset", None) is None:
        trainer.load_dataset()
    timings = []
    for key in sorted(trainer.dataset)[distributed.rank()::distributed.world_size()]:
        data = np.array(load_case(trainer.dataset[key], "r"))[:-1]
        t0 = time.perf_counter()
        probs, forwards, net_calls = trainer.predict_preprocessed_probabilities(
            data, do_mirroring=False)
        seg = trainer.segmentation_of(probs)
        timings.append({"case": key, "predict_s": time.perf_counter() - t0,
                        "forwards": forwards, "net_calls": net_calls})
        target_file = os.path.join(stage_to_be_predicted_folder, f"{key}.npz")
        if os.path.isfile(target_file):
            target_shape = np.load(target_file)["data"].shape[1:]
        else:
            props = load_pickle(trainer.dataset[key]["properties_file"])
            target_shape = tuple(int(s) for s in props["size_after_resampling"])
        seg_resampled = resample_data_or_seg(
            seg[None].astype(np.float32), target_shape, is_seg=True, order=1)
        np.savez_compressed(prev_stage_file(stage_to_be_predicted_folder, key),
                            data=seg_resampled.astype(np.uint8))
        trainer.print_to_log_file(f"predicted next stage for {key}")
    distributed.barrier()
    return timings


# ------------------------------------------------------------ cascade variants
# The reference's cascade ablations tweak schedule or the prev-stage corruption
# knobs only (nnUNet_variants/cascade/*.py).

def _cascade_da(self, **updates) -> None:
    TrainerV2CascadeFullRes.setup_DA_params(self)
    self.data_aug_params.update(updates)


class TrainerV2CascadeLowerLR(TrainerV2CascadeFullRes):
    """cascade/nnUNetTrainerV2CascadeFullRes_lowerLR.py:22-28: lr 1e-3."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.initial_lr = 1e-3


class TrainerV2CascadeShorter(TrainerV2CascadeFullRes):
    """cascade/nnUNetTrainerV2CascadeFullRes_shorter.py: 500 epochs."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.max_num_epochs = 500


class TrainerV2CascadeShorterLowerLR(TrainerV2CascadeFullRes):
    """cascade/nnUNetTrainerV2CascadeFullRes_shorter_lowerLR.py."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.max_num_epochs = 500
        self.initial_lr = 1e-3


class TrainerV2CascadeNoConnComp(TrainerV2CascadeFullRes):
    """DAVariants.py:19-30: disable CC-removal corruption."""

    def setup_DA_params(self) -> None:
        _cascade_da(self, cascade_random_binary_transform_p=0.4,
                    cascade_random_binary_transform_p_per_label=1.0,
                    cascade_random_binary_transform_size=(1, 8),
                    cascade_remove_conn_comp_p=0.0,
                    cascade_remove_conn_comp_max_size_percent_threshold=0.15)


class TrainerV2CascadeSmallerBinStrel(TrainerV2CascadeFullRes):
    """DAVariants.py:33-44: structuring element range (1, 5)."""

    def setup_DA_params(self) -> None:
        _cascade_da(self, cascade_random_binary_transform_p=0.4,
                    cascade_random_binary_transform_p_per_label=1.0,
                    cascade_random_binary_transform_size=(1, 5),
                    cascade_remove_conn_comp_p=0.2,
                    cascade_remove_conn_comp_max_size_percent_threshold=0.15)


class TrainerV2CascadeEducatedGuess(TrainerV2CascadeFullRes):
    """DAVariants.py:47-58."""

    def setup_DA_params(self) -> None:
        _cascade_da(self, cascade_random_binary_transform_p=0.5,
                    cascade_random_binary_transform_p_per_label=0.5,
                    cascade_random_binary_transform_size=(1, 5),
                    cascade_remove_conn_comp_p=0.2,
                    cascade_remove_conn_comp_max_size_percent_threshold=0.10)


class TrainerV2CascadeEducatedGuess2(TrainerV2CascadeFullRes):
    """DAVariants.py:61-72: like EducatedGuess, CC removal off."""

    def setup_DA_params(self) -> None:
        _cascade_da(self, cascade_random_binary_transform_p=0.5,
                    cascade_random_binary_transform_p_per_label=0.5,
                    cascade_random_binary_transform_size=(1, 5),
                    cascade_remove_conn_comp_p=0.0,
                    cascade_remove_conn_comp_max_size_percent_threshold=0.10)


class TrainerV2CascadeEducatedGuess3(TrainerV2CascadeFullRes):
    """DAVariants.py:75-87: always corrupt, per-label p 0.33."""

    def setup_DA_params(self) -> None:
        _cascade_da(self, cascade_random_binary_transform_p=1.0,
                    cascade_random_binary_transform_p_per_label=0.33,
                    cascade_random_binary_transform_size=(1, 5),
                    cascade_remove_conn_comp_p=0.0,
                    cascade_remove_conn_comp_max_size_percent_threshold=0.10)


# the JAX registry's names of each trainer (cascade.py:94-406) -> the class
CASCADE_TRAINERS = {
    **dict.fromkeys(("TrainerV2CascadeFullRes", "nnUNetTrainerV2CascadeFullRes",
                     "nnUNetTrainerCascadeFullRes"), TrainerV2CascadeFullRes),
    **dict.fromkeys(("TrainerV2CascadeLowerLR", "nnUNetTrainerV2CascadeFullRes_lowerLR"),
                    TrainerV2CascadeLowerLR),
    **dict.fromkeys(("TrainerV2CascadeShorter", "nnUNetTrainerV2CascadeFullRes_shorter"),
                    TrainerV2CascadeShorter),
    **dict.fromkeys(("TrainerV2CascadeShorterLowerLR",
                     "nnUNetTrainerV2CascadeFullRes_shorter_lowerLR"),
                    TrainerV2CascadeShorterLowerLR),
    **dict.fromkeys(("TrainerV2CascadeNoConnComp", "nnUNetTrainerV2CascadeFullRes_noConnComp"),
                    TrainerV2CascadeNoConnComp),
    **dict.fromkeys(("TrainerV2CascadeSmallerBinStrel",
                     "nnUNetTrainerV2CascadeFullRes_smallerBinStrel"),
                    TrainerV2CascadeSmallerBinStrel),
    **dict.fromkeys(("TrainerV2CascadeEducatedGuess",
                     "nnUNetTrainerV2CascadeFullRes_EducatedGuess"),
                    TrainerV2CascadeEducatedGuess),
    **dict.fromkeys(("TrainerV2CascadeEducatedGuess2",
                     "nnUNetTrainerV2CascadeFullRes_EducatedGuess2"),
                    TrainerV2CascadeEducatedGuess2),
    **dict.fromkeys(("TrainerV2CascadeEducatedGuess3",
                     "nnUNetTrainerV2CascadeFullRes_EducatedGuess3"),
                    TrainerV2CascadeEducatedGuess3),
}
