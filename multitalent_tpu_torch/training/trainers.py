"""The plans-driven trainer (nnUNetTrainerV2) on one GPU.

Counterpart of multitalent_tpu/training/trainers.py:TrainerV2. It subclasses
the JAX package's `NetworkTrainerBase` (numpy only: the epoch loop's
bookkeeping, logging, moving averages, patience) and replaces the flax parts:

- the network is the port's GenericUNet with deep supervision, He-initialised
  from a seeded `torch.Generator`, computing in bf16 (fp16=True) with fp32
  master weights;
- one training step: host batch -> pinned memory -> device -> augmentation
  on the card (augment/pipeline.py) -> forward (the fused conv -> norm route
  under MTTPU_FUSED_TRAIN=1, ops/fused_unet.make_train_forward) ->
  deep-supervised loss in fp32
  -> backward (through kernels A, B and C where the convs qualify) -> clip to
  global norm 12 -> SGD, Nesterov 0.99, weight decay 3e-5, poly LR per epoch;
- checkpoints in the reference layout that inference/model_restore.py reads:
  `fold_X/<name>.model` (a torch dict with state_dict, optimizer_state_dict,
  epoch, plot_stuff, best_stuff) beside a `.model.pkl` sidecar (name, init,
  plans), and plans.pkl in the output folder.

The JAX trainer's mesh plumbing has no counterpart: this trainer runs on one
device (data parallelism is ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from multitalent_tpu.augment.params import (default_2D_augmentation_params,
                                            default_3D_augmentation_params,
                                            get_patch_size)
from multitalent_tpu.data.dataset import kfold_split, load_dataset, unpack_dataset
from multitalent_tpu.data.loader import PatchSampler3D, PrefetchPipeline
from multitalent_tpu.plans import Plans, load_plans, save_plans
from multitalent_tpu.training.trainer_base import NetworkTrainerBase
from multitalent_tpu.utils.fileops import load_pickle, maybe_mkdir, save_pickle
from multitalent_tpu_torch.augment.pipeline import (ds_scales_from_pools, make_augment_fn,
                                                    make_val_transform_fn)
from multitalent_tpu_torch.models.generic_unet import GenericUNet, build_unet_from_plans
from multitalent_tpu_torch.ops.fused_unet import make_train_forward
from multitalent_tpu_torch.training.losses import (dc_and_ce_loss, deep_supervision_loss,
                                                   ds_loss_weights)
from multitalent_tpu_torch.training.schedules import make_poly_schedule, poly_lr
from multitalent_tpu_torch.training.train_state import SGDClipped


def init_weights_he(net: torch.nn.Module, generator: torch.Generator,
                    neg_slope: float = 1e-2) -> None:
    """The reference's InitWeights_He(1e-2): kaiming normal on every conv and
    transposed conv weight, zero conv biases; norms keep (1, 0)."""
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            torch.nn.init.kaiming_normal_(m.weight, a=neg_slope, generator=generator)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)


def checkpoint_file(fname: str) -> str:
    """The base class names checkpoints `.ckpt` (the JAX package's flax
    files); this trainer writes the reference's `.model`."""
    return fname[:-len(".ckpt")] + ".model" if fname.endswith(".ckpt") else fname


class TrainerV2(NetworkTrainerBase):
    """The production plans-driven trainer, on one torch device."""

    def __init__(self, plans_file, fold, output_folder=None, dataset_directory=None,
                 batch_dice=True, stage=None, unpack_data=True, deterministic=True,
                 fp16=True, seed: int = 12345, device: str | torch.device = "cuda"):
        super().__init__(deterministic, fp16)
        self.init_args = (plans_file, fold, output_folder, dataset_directory,
                          batch_dice, stage, unpack_data, deterministic, fp16)
        self.plans_file = plans_file
        self.plans: Plans | None = None
        self.fold = fold
        self.output_folder_base = output_folder
        self.output_folder = output_folder
        self.dataset_directory = dataset_directory
        self.batch_dice = batch_dice
        self.stage = stage
        self.unpack_data = unpack_data
        self.seed = seed
        self.device = torch.device(device)

        self.initial_lr = 1e-2
        self.weight_decay = 3e-5
        self.oversample_foreground_percent = 0.33

        self.online_eval_tp: list[np.ndarray] = []
        self.online_eval_fp: list[np.ndarray] = []
        self.online_eval_fn: list[np.ndarray] = []

        self.ds_loss_weights: np.ndarray | None = None
        self.data_aug_params: dict | None = None
        self.network: GenericUNet | None = None
        self.network_forward = None  # make_train_forward(network), with the step functions
        self.optimizer: SGDClipped | None = None
        self.step = 0             # optimizer steps taken
        self.step_seconds: list[float] = []  # wall time of each training step

        if output_folder is not None and fold is not None:
            self.output_folder = os.path.join(output_folder, f"fold_{fold}")

    # ----------------------------------------------------------- plans handling
    def load_plans_file(self) -> None:
        self.plans = (self.plans_file if isinstance(self.plans_file, Plans)
                      else load_plans(self.plans_file))

    def process_plans(self, plans: Plans) -> None:
        """nnUNetTrainer.process_plans (trainers.py:93)."""
        if self.stage is None:
            assert len(plans.plans_per_stage) == 1, \
                "stage must be specified for multi-stage plans"
            self.stage = list(plans.plans_per_stage.keys())[0]
        st = plans.stage(self.stage)
        self.batch_size = st.batch_size
        self.patch_size = np.array(st.patch_size, dtype=int)
        self.net_num_pool_op_kernel_sizes = st.pool_op_kernel_sizes
        self.do_dummy_2D_aug = st.do_dummy_2D_data_aug
        self.num_input_channels = plans.num_modalities
        self.num_classes = plans.num_classes + 1  # +1 background
        self.use_mask_for_norm = plans.use_mask_for_norm
        if len(self.patch_size) != 3:
            raise NotImplementedError("the port trains 3D plans only (2D: ROADMAP "
                                      "queue 1, item 10)")

    def setup_DA_params(self) -> None:
        """nnUNetTrainerV2.setup_DA_params (trainers.py:115), 3D."""
        self.deep_supervision_scales = ds_scales_from_pools(
            self.net_num_pool_op_kernel_sizes)
        p = dict(default_3D_augmentation_params)
        if self.do_dummy_2D_aug:
            p["dummy_2D"] = True
            p["elastic_deform_alpha"] = default_2D_augmentation_params.get(
                "elastic_deform_alpha")
            for k in ("rotation_x", "rotation_y", "rotation_z"):
                p[k] = default_2D_augmentation_params[k]
        p["mask_was_used_for_normalization"] = self.use_mask_for_norm
        p["scale_range"] = (0.7, 1.4)
        p["do_elastic"] = False
        p["selected_seg_channels"] = [0]
        if self.do_dummy_2D_aug:
            size = get_patch_size(self.patch_size[1:], p["rotation_x"], p["rotation_y"],
                                  p["rotation_z"], p["scale_range"])
            self.basic_generator_patch_size = np.array([self.patch_size[0], *size])
        else:
            self.basic_generator_patch_size = get_patch_size(
                self.patch_size, p["rotation_x"], p["rotation_y"], p["rotation_z"],
                p["scale_range"])
        p["patch_size_for_spatialtransform"] = self.patch_size
        self.data_aug_params = p

    # ------------------------------------------------------------------- splits
    def do_split(self) -> None:
        """splits_final.pkl, the 'all' fold and the random 80:20 fallback for
        folds past the file (trainers.py:151)."""
        if self.fold == "all":
            tr_keys = val_keys = list(self.dataset.keys())
        else:
            splits_file = os.path.join(self.dataset_directory, "splits_final.pkl")
            if not os.path.isfile(splits_file):
                self.print_to_log_file("Creating new 5-fold cross-validation split...")
                save_pickle(kfold_split(list(self.dataset.keys())), splits_file)
            splits = load_pickle(splits_file)
            if self.fold < len(splits):
                tr_keys = splits[self.fold]["train"]
                val_keys = splits[self.fold]["val"]
            else:
                self.print_to_log_file(
                    f"INFO: requested fold {self.fold} but split file has only "
                    f"{len(splits)} folds. Using random 80:20 split.")
                rnd = np.random.RandomState(seed=12345 + self.fold)
                keys = np.sort(list(self.dataset.keys()))
                idx_tr = rnd.choice(len(keys), int(len(keys) * 0.8), replace=False)
                tr_keys = [keys[i] for i in idx_tr]
                val_keys = [keys[i] for i in range(len(keys)) if i not in idx_tr]
        self.dataset_tr = {k: self.dataset[k] for k in sorted(tr_keys)}
        self.dataset_val = {k: self.dataset[k] for k in sorted(val_keys)}

    # --------------------------------------------------------------- generators
    def load_dataset(self) -> None:
        self.folder_with_preprocessed_data = os.path.join(
            self.dataset_directory, self.plans.data_identifier + f"_stage{self.stage}")
        self.dataset = load_dataset(self.folder_with_preprocessed_data)

    def _sampler(self, dataset: dict, patch_size, seed: int, probabilities=None):
        return PatchSampler3D(dataset, patch_size, self.patch_size, self.batch_size,
                              oversample_foreground_percent=self.oversample_foreground_percent,
                              pad_mode="constant", sampling_probabilities=probabilities,
                              seed=seed)

    def get_basic_generators(self):
        """Sampler factories for the training and validation pipelines
        (trainers.py:192); the training sampler draws the enlarged patch."""
        self.load_dataset()
        self.do_split()
        return (lambda w: self._sampler(self.dataset_tr, self.basic_generator_patch_size,
                                        self.seed + w),
                lambda w: self._sampler(self.dataset_val, self.patch_size,
                                        self.seed + 1000 + w))

    # ------------------------------------------------------------------ network
    def initialize_network(self) -> None:
        self.network = build_unet_from_plans(
            self.plans, self.stage, num_classes=self.num_classes,
            dtype=torch.bfloat16 if self.fp16 else torch.float32)

    def _init_state(self) -> None:
        """He init from a seeded generator, then the optimizer (the flax init
        and optax state of trainers.py:231)."""
        init_weights_he(self.network, torch.Generator().manual_seed(self.seed))
        self.network.to(self.device)
        self.optimizer = SGDClipped(self.network.parameters(), momentum=0.99,
                                    nesterov=True, weight_decay=self.weight_decay,
                                    clip_norm=12.0)
        self.lr_schedule = make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                              self.num_batches_per_epoch)
        n_params = sum(p.numel() for p in self.network.parameters())
        self.print_to_log_file(f"network initialized: {n_params:,} parameters")

    # ------------------------------------------------------------ loss plumbing
    def loss_fn(self, outputs, targets, extras: dict):
        """Deep-supervised DC+CE; returns (loss, aux metrics)."""
        weights = [float(w) for w in self.ds_loss_weights]
        loss = deep_supervision_loss(outputs, targets,
                                     partial(dc_and_ce_loss, batch_dice=self.batch_dice),
                                     weights)
        return loss, {}

    def batch_extras(self, batch: dict) -> dict:
        """Arrays derived from the host batch besides data and seg."""
        return {}

    def eval_stats(self, outputs, targets, extras):
        """Online foreground-Dice statistics: hard argmax against the
        full-resolution target, per-class tp/fp/fn over batch and space."""
        pred = outputs[0].argmax(1)
        y = targets[0].long()
        pred_oh = torch.nn.functional.one_hot(pred, self.num_classes)[..., 1:].float()
        y_oh = torch.nn.functional.one_hot(y, self.num_classes)[..., 1:].float()
        axes = tuple(range(pred_oh.dim() - 1))
        return ((pred_oh * y_oh).sum(axes), (pred_oh * (1 - y_oh)).sum(axes),
                ((1 - pred_oh) * y_oh).sum(axes))

    # ----------------------------------------------------------------- steps
    def _build_step_functions(self) -> None:
        self._augment = make_augment_fn(self.patch_size, self.deep_supervision_scales,
                                        self.data_aug_params, self.num_input_channels)
        self._val_transform = make_val_transform_fn(
            self.patch_size, self.deep_supervision_scales, self.data_aug_params,
            self.num_input_channels)
        self._aug_generator = torch.Generator(self.device).manual_seed(self.seed + 777)
        self.network_forward = make_train_forward(self.network)

    def _to_device(self, array) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(array))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    # ---------------------------------------------------------------- lifecycle
    def initialize(self, training: bool = True, force_load_plans: bool = False) -> None:
        if self.was_initialized and not force_load_plans:
            return
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device cuda requested but torch.cuda.is_available() is "
                               "False; pass device='cpu' to run the plain versions")
        if self.output_folder is not None:
            maybe_mkdir(self.output_folder)
        if self.plans is None or force_load_plans:
            self.load_plans_file()
        self.process_plans(self.plans)
        self.setup_DA_params()
        self.ds_loss_weights = ds_loss_weights(len(self.deep_supervision_scales),
                                               mask_lowest=True)
        if self.output_folder_base is not None:
            save_plans(self.plans, os.path.join(maybe_mkdir(self.output_folder_base),
                                                "plans.pkl"))
        if training and self.dataset_directory is not None:
            tr_factory, val_factory = self.get_basic_generators()
            if self.unpack_data:
                self.print_to_log_file("unpacking dataset")
                unpack_dataset(self.folder_with_preprocessed_data)
            num_threads = int(self.data_aug_params.get("num_threads", 3))
            self.tr_gen = PrefetchPipeline(tr_factory, num_workers=num_threads)
            self.val_gen = PrefetchPipeline(val_factory, num_workers=1)
            self.print_to_log_file("TRAINING KEYS:\n %s" % str(sorted(self.dataset_tr)),
                                   also_print_to_console=False)
            self.print_to_log_file("VALIDATION KEYS:\n %s" % str(sorted(self.dataset_val)),
                                   also_print_to_console=False)
        self.initialize_network()
        self._init_state()
        self._build_step_functions()
        self.was_initialized = True
        self.initialized = True

    # ---------------------------------------------------------------- iteration
    def run_iteration(self, data_generator, do_backprop: bool = True,
                      run_online_evaluation: bool = False) -> float:
        t0 = time.perf_counter()
        batch = next(data_generator)
        data, seg = self._to_device(batch["data"]), self._to_device(batch["seg"])
        extras = {k: self._to_device(v) for k, v in self.batch_extras(batch).items()}
        if do_backprop:
            data, targets = self._augment(data, seg, self._aug_generator)
            outputs = self.network_forward(data, deep_supervision=True)
            loss, aux = self.loss_fn(outputs, targets, extras)
            self.optimizer.zero_grad()
            loss.backward()
            self.optimizer.step(self.lr_schedule(self.step))
            self.step += 1
        else:
            with torch.no_grad():
                data, targets = self._val_transform(data, seg)
                outputs = self.network_forward(data, deep_supervision=True)
                loss, aux = self.loss_fn(outputs, targets, extras)
                if run_online_evaluation:
                    self.run_online_evaluation(self.eval_stats(outputs, targets, extras))
        value = float(loss.detach())  # waits for the step's device work
        self.on_iteration_metrics(aux, do_backprop)
        if do_backprop:
            self.step_seconds.append(time.perf_counter() - t0)
        return value

    def on_iteration_metrics(self, aux: dict, was_train: bool) -> None:
        """Hook for per-iteration aux-metric logging (MultiTalent ce/dice)."""

    # --------------------------------------------------------------- online eval
    def run_online_evaluation(self, stats) -> None:
        tp, fp, fn = (s.cpu().numpy() for s in stats)
        self.online_eval_tp.append(tp)
        self.online_eval_fp.append(fp)
        self.online_eval_fn.append(fn)

    def finish_online_evaluation(self) -> None:
        """Global per-class foreground Dice over the epoch (trainers.py:420)."""
        if not self.online_eval_tp:
            return
        tp = np.sum(self.online_eval_tp, 0)
        fp = np.sum(self.online_eval_fp, 0)
        fn = np.sum(self.online_eval_fn, 0)
        dc = [2 * t / (2 * t + f + n) if (2 * t + f + n) > 0 else np.nan
              for t, f, n in zip(tp, fp, fn)]
        finite = [d for d in dc if not np.isnan(d)]
        self.all_val_eval_metrics.append(float(np.mean(finite)) if finite else 0.0)
        self.print_to_log_file("Average global foreground Dice:", [np.round(d, 4) for d in dc])
        self.print_to_log_file("(interpret this as an estimate for the Dice of the "
                               "different classes. This is not exact.)")
        self.online_eval_tp, self.online_eval_fp, self.online_eval_fn = [], [], []

    # ----------------------------------------------------------------------- lr
    def current_lr(self) -> float:
        return float(poly_lr(min(self.epoch, self.max_num_epochs - 1),
                             self.max_num_epochs, self.initial_lr))

    def maybe_update_lr(self) -> None:
        # the LR is set per step from the schedule; log the next epoch's
        self.print_to_log_file("lr:", np.round(poly_lr(self.epoch + 1, self.max_num_epochs,
                                                       self.initial_lr), decimals=6))

    def on_epoch_end(self) -> bool:
        return super().on_epoch_end() and self.epoch < self.max_num_epochs

    # --------------------------------------------------------------- checkpoints
    def save_checkpoint(self, fname: str, save_optimizer: bool = True) -> None:
        """`<name>.model` + `<name>.model.pkl` in the reference layout."""
        start = time.time()
        fname = checkpoint_file(fname)
        maybe_mkdir(os.path.dirname(fname) or ".")
        meta = self.checkpoint_metadata()
        torch.save({
            "epoch": meta["epoch"],
            "state_dict": {k: v.detach().cpu() for k, v in self.network.state_dict().items()},
            "optimizer_state_dict": self.optimizer.state_dict() if save_optimizer else None,
            "plot_stuff": meta["plot_stuff"],
            "best_stuff": meta["best_stuff"],
            "step": self.step,
        }, fname)
        init = self.init_args
        if isinstance(init[0], Plans) and self.output_folder_base is not None:
            init = (os.path.join(self.output_folder_base, "plans.pkl"), *init[1:])
        save_pickle({"init": init, "name": self.__class__.__name__,
                     "class": str(self.__class__), "plans": self.plans.to_dict()},
                    fname + ".pkl")
        self.print_to_log_file(
            f"saving checkpoint... done, saving took {time.time() - start:.2f} seconds")

    def load_checkpoint(self, fname: str, train: bool = True) -> None:
        fname = checkpoint_file(fname)
        self.print_to_log_file("loading checkpoint", fname, "train=", train)
        if not self.initialized:
            self.initialize(train)
        ckpt = torch.load(fname, map_location="cpu", weights_only=False)
        self.network.load_state_dict(ckpt["state_dict"])
        if train and ckpt.get("optimizer_state_dict") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.step = int(ckpt.get("step", ckpt["epoch"] * self.num_batches_per_epoch))
        self.restore_checkpoint_metadata(ckpt)

    def _load_first(self, names, train: bool) -> None:
        for name in names:
            p = os.path.join(self.output_folder, name + ".model")
            if os.path.isfile(p):
                return self.load_checkpoint(p, train)
        raise RuntimeError(f"none of {names} (.model) in {self.output_folder}")

    def load_latest_checkpoint(self, train: bool = True) -> None:
        self._load_first(("model_final_checkpoint", "model_latest", "model_best"), train)

    def load_best_checkpoint(self, train: bool = True) -> None:
        names = ("model_final_checkpoint",) if self.fold == "all" else (
            "model_best", "model_final_checkpoint")
        self._load_first(names, train)

    def load_final_checkpoint(self, train: bool = False) -> None:
        self._load_first(("model_final_checkpoint",), train)

    # ------------------------------------------------------------------ the loop
    def run_training(self) -> None:
        """The epoch loop of trainer_base.run_training with the reference's
        checkpoint names."""
        maybe_mkdir(self.output_folder)
        if not self.was_initialized:
            self.initialize(True)
        self.save_debug_information()
        while self.epoch < self.max_num_epochs:
            self.print_to_log_file("\nepoch: ", self.epoch)
            start = time.time()
            losses = [self.run_iteration(self.tr_gen, True)
                      for _ in range(self.num_batches_per_epoch)]
            self.all_tr_losses.append(float(np.mean(losses)))
            self.print_to_log_file(f"train loss : {self.all_tr_losses[-1]:.4f}")
            val = [self.run_iteration(self.val_gen, False, True)
                   for _ in range(self.num_val_batches_per_epoch)]
            self.all_val_losses.append(float(np.mean(val)) if val else float("nan"))
            self.print_to_log_file(f"validation loss: {self.all_val_losses[-1]:.4f}")
            self.update_train_loss_MA()
            continue_training = self.on_epoch_end()
            self.epoch += 1
            self.print_to_log_file(f"This epoch took {time.time() - start:.2f} s\n")
            if not continue_training:
                break
        self.epoch -= 1
        if self.save_final_checkpoint:
            self.save_checkpoint(os.path.join(self.output_folder,
                                              "model_final_checkpoint.model"))
        self.epoch += 1
        for name in ("model_latest.model", "model_latest.model.pkl"):
            p = os.path.join(self.output_folder, name)
            if os.path.isfile(p):
                os.remove(p)
        for gen in (getattr(self, "tr_gen", None), getattr(self, "val_gen", None)):
            if hasattr(gen, "stop"):
                gen.stop()

    def validate(self, *args, **kwargs):
        raise NotImplementedError("validation of a trained fold (inference/validation.py) "
                                  "is not ported yet: ROADMAP queue 1, item 7")
