"""The MultiTalent flagship trainers, on one GPU or data-parallel over several.

Counterpart of multitalent_tpu/training/multitalent.py:40-242: 47 sigmoid
region heads; order_seg 0 (nearest seg warping, so no label is invented);
splits_custom.pkl (5 stitched CV folds + 7 leave-one-dataset-out folds);
dataset-balanced sampling p(case) ~ 1/sqrt(cases of its dataset); the masked
multi-head BCE + batch-Dice loss over the regions each sample's dataset
annotates; region-wise online evaluation; ce / dice logged apart. The
resenc trainers (:244-272) run the same over the residual-encoder UNet, the
MedNeXt trainer (:274-294) over MedNeXt, the SwinUNETR trainer (:297-333)
over SwinUNETR with AMSGrad Adam at 5e-4.

Over several ranks (training/trainers.py) every rank samples with the same
dataset probabilities, the loss pools BCE and batch-Dice statistics over the
ranks, and the online evaluation sums tp/fp/fn over them: the loss, its
gradient and the region-wise Dice are the global batch's, under a space plan
too (each rank's slab of its data group's samples).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.tasks.multitalent import (NUM_REGIONS, build_custom_splits,
                                                     inverse_sqrt_sampling_probabilities,
                                                     valid_region_mask)
from multitalent_tpu_torch.training.losses import label_region_matrix, multitalent_ds_loss
from multitalent_tpu_torch.training.trainers import (MedNeXtMixin, ResencUNetMixin,
                                                     SwinUNETRMixin, TrainerV2)
from multitalent_tpu_torch.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.utils.task_names import convert_id_to_task_name


class MultiTalentTrainer(TrainerV2):
    inference_nonlin = "sigmoid"
    regions_class_order = list(range(NUM_REGIONS))

    def __init__(self, plans_file, fold, output_folder=None, dataset_directory=None,
                 batch_dice=True, stage=None, unpack_data=True, deterministic=True,
                 fp16=True, seed: int = 12345, device: str | torch.device = "cuda"):
        super().__init__(plans_file, fold, output_folder, dataset_directory,
                         batch_dice=True, stage=stage, unpack_data=unpack_data,
                         deterministic=deterministic, fp16=fp16, seed=seed, device=device)
        self._label_region_matrix = torch.from_numpy(label_region_matrix()).to(self.device)
        self.all_tr_ce: list[float] = []
        self.all_tr_dice: list[float] = []
        self.all_val_ce: list[float] = []
        self.all_val_dice: list[float] = []
        self._epoch_ce: list[float] = []
        self._epoch_dice: list[float] = []

    # ------------------------------------------------------------------- config
    def process_plans(self, plans) -> None:
        super().process_plans(plans)
        self.num_classes = NUM_REGIONS  # 47 region channels, no background

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.data_aug_params["order_seg"] = 0

    # ------------------------------------------------------------------- splits
    def do_split(self) -> None:
        """splits_custom.pkl (multitalent.py:79-119); building the file needs
        each source dataset's own splits_final.pkl under the preprocessing
        output directory."""
        if self.fold == "all":
            tr_keys = val_keys = list(self.dataset.keys())
        else:
            splits_file = os.path.join(self.dataset_directory, "splits_custom.pkl")
            if distributed.is_main() and not os.path.isfile(splits_file):
                self.print_to_log_file("Creating splits_custom.pkl (12 folds)...")
                keys = list(self.dataset.keys())
                per_task = {}
                task_ids = sorted({int(k.split("_")[0]) for k in keys} - {46})
                if any(k.startswith("046_") for k in keys):
                    task_ids = sorted(set(task_ids) | {17})
                for task_id in task_ids:
                    per_task[task_id] = load_pickle(os.path.join(
                        paths.preprocessing_output_dir(), convert_id_to_task_name(task_id),
                        "splits_final.pkl"))
                save_pickle(build_custom_splits(keys, per_task), splits_file)
            distributed.barrier()
            splits = load_pickle(splits_file)
            tr_keys, val_keys = splits[self.fold]["train"], splits[self.fold]["val"]
        for name, keys in (("dataset_tr", tr_keys), ("dataset_val", val_keys)):
            subset = {}
            for k in sorted(keys):
                if k in self.dataset:
                    subset[k] = self.dataset[k]
                else:
                    self.print_to_log_file(
                        f"Warning {k} is not in preprocessed folder (might be intentional)")
            setattr(self, name, subset)

    # --------------------------------------------------------------- generators
    def get_basic_generators(self):
        """Dataset-balanced sampling (multitalent.py:122-147)."""
        self.load_dataset()
        self.do_split()
        keys_tr, keys_val = sorted(self.dataset_tr), sorted(self.dataset_val)
        probs_tr = inverse_sqrt_sampling_probabilities(keys_tr)
        probs_val = inverse_sqrt_sampling_probabilities(keys_val)
        prefixes = sorted({k.split("_")[0] for k in keys_tr})
        counts = {p: sum(1 for k in keys_tr if k.startswith(p + "_")) for p in prefixes}
        self.print_to_log_file("cases per dataset train:\n", list(counts.items()))
        self.print_to_log_file("probabilities per dataset:")
        for p in prefixes:
            i = next(i for i, k in enumerate(keys_tr) if k.startswith(p + "_"))
            self.print_to_log_file(p, probs_tr[i], probs_tr[i] * counts[p])
        return (lambda w: self._sampler(self.dataset_tr, self.basic_generator_patch_size,
                                        self.seed + w, probs_tr),
                lambda w: self._sampler(self.dataset_val, self.patch_size,
                                        self.seed + 1000 + w, probs_val))

    # --------------------------------------------------------------------- loss
    def batch_extras(self, batch: dict) -> dict:
        return {"valid_region_mask": valid_region_mask(
            [p["valid_regions"] for p in batch["properties"]])}

    def loss_fn(self, outputs, targets, extras: dict):
        weights = [float(w) for w in self.ds_loss_weights]
        loss, ce, dc = multitalent_ds_loss(outputs, targets, extras["valid_region_mask"],
                                           self._label_region_matrix, weights,
                                           batch_dice=True, group=self.process_group,
                                           spaces=self.level_spaces)
        return loss, {"ce": ce.detach(), "dice": dc.detach()}

    loss_fn.takes_space = True  # pools over the space axis (trainers.space_plan_refusal)

    def on_iteration_metrics(self, aux: dict, was_train: bool) -> None:
        self._epoch_ce.append(float(aux["ce"]))
        self._epoch_dice.append(float(aux["dice"]))

    # -------------------------------------------------------------- online eval
    def eval_stats(self, outputs, targets, extras):
        """Thresholded-sigmoid tp/fp/fn per region over the valid regions only
        (multitalent.py:175-190); (47,) sums over batch and space."""
        hard = (torch.sigmoid(outputs[0].float()) > 0.5).float()
        gt = self._label_region_matrix[targets[0].long().clamp(min=0)].movedim(-1, 1)
        vmask = extras["valid_region_mask"].float()
        vb = vmask.view(*vmask.shape, *(1,) * (hard.dim() - 2))
        axes = (0,) + tuple(range(2, hard.dim()))
        return ((hard * gt * vb).sum(axes), (hard * (1 - gt) * vb).sum(axes),
                ((1 - hard) * gt * vb).sum(axes))

    def finish_online_evaluation(self) -> None:
        """Per-region global Dice, eps-clipped denominator: regions never valid
        this epoch give 0 (multitalent.py:192-207)."""
        if not self.online_eval_tp:
            return
        tp = np.sum(self.online_eval_tp, 0)
        fp = np.sum(self.online_eval_fp, 0)
        fn = np.sum(self.online_eval_fn, 0)
        dc = 2 * tp / np.clip(2 * tp + fp + fn, 1e-8, None)
        self.all_val_eval_metrics.append(float(np.mean(dc)))
        self.print_to_log_file("Average global foreground Dice:", str(list(dc)))
        self.print_to_log_file("(interpret this as an estimate for the Dice of the "
                               "different classes. This is not exact.)")
        self.online_eval_tp, self.online_eval_fp, self.online_eval_fn = [], [], []

    # ------------------------------------------------------------------ logging
    def run_training(self) -> None:
        self._epoch_ce, self._epoch_dice = [], []
        super().run_training()

    def on_epoch_end(self) -> bool:
        n_tr = self.num_batches_per_epoch
        if len(self._epoch_ce) >= n_tr:
            ce, dice = self._epoch_ce, self._epoch_dice
            self.all_tr_ce.append(float(np.mean(ce[:n_tr])))
            self.all_tr_dice.append(float(np.mean(dice[:n_tr])))
            self.all_val_ce.append(float(np.mean(ce[n_tr:])) if len(ce) > n_tr
                                   else float("nan"))
            self.all_val_dice.append(float(np.mean(dice[n_tr:])) if len(dice) > n_tr
                                     else float("nan"))
            self.print_to_log_file(f"train ce : {self.all_tr_ce[-1]:.4f} "
                                   f"train dice : {self.all_tr_dice[-1]:.4f}")
            self.print_to_log_file(f"val ce : {self.all_val_ce[-1]:.4f} "
                                   f"val dice : {self.all_val_dice[-1]:.4f}")
        self._epoch_ce, self._epoch_dice = [], []
        return super().on_epoch_end()

    def validate(self, *args, **kwargs):
        """Region-wise validation (inference/validation.py:run_multitalent_validation)."""
        from multitalent_tpu_torch.inference.validation import run_multitalent_validation
        return run_multitalent_validation(self, *args, **kwargs)


class MultiTalentTrainer2000ep(MultiTalentTrainer):
    """The 2000-epoch schedule of the released models."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 2000


class MultiTalentTrainerResenc(ResencUNetMixin, MultiTalentTrainer):
    """MultiTalent over the residual-encoder UNet (MultiTalent_trainer_resenc_ddp,
    multitalent_tpu/training/multitalent.py:244-260)."""


class MultiTalentTrainerResenc2000ep(MultiTalentTrainerResenc):
    """The 2000-epoch schedule of the released resenc models."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 2000


class MultiTalentTrainerMedNeXt(MedNeXtMixin, MultiTalentTrainer):
    """MultiTalent over MedNeXt (Multitalent_mednextt, MultiTalent_meets_mednext;
    multitalent_tpu/training/multitalent.py:274-294): the 47 sigmoid
    regions, SGD as the flagship."""


class MultiTalentTrainerSwinUNETR(SwinUNETRMixin, MultiTalentTrainer):
    """MultiTalent over SwinUNETR (MultiTalent_trainer_SwinUNETR_ddp_adam,
    multitalent_tpu/training/multitalent.py:297-333): Adam 5e-4, no deep
    supervision, the 47 sigmoid regions."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.initial_lr = 5e-4
