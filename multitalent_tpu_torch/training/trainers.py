"""The plans-driven trainer (nnUNetTrainerV2) on one GPU or data-parallel over several.

Counterpart of multitalent_tpu/training/trainers.py:TrainerV2. It subclasses
`NetworkTrainerBase` (training/trainer_base.py, the port's copy of the JAX
package's: the epoch loop's bookkeeping, logging, moving averages, patience)
and replaces the flax parts:

- the network is the port's GenericUNet (ResidualEncoderUNet for the
  residual-encoder trainers, `ResencUNetMixin`; SwinUNETR, without deep
  supervision and with AMSGrad Adam, for `SwinUNETRMixin`'s; MedNeXt for
  `MedNeXtMixin`'s) with deep supervision, He-initialised from a seeded
  `torch.Generator`, computing in bf16 (fp16=True) with fp32 master
  weights;
- one training step: host batch -> pinned memory -> device -> augmentation
  on the card (augment/pipeline.py) -> forward (the fused conv -> norm route
  under MTTPU_FUSED_TRAIN=1, ops/fused_unet.make_train_forward) ->
  deep-supervised loss in fp32
  -> backward (through kernels A, B and C where the convs qualify) -> clip to
  global norm 12 -> SGD, Nesterov 0.99, weight decay 3e-5, poly LR per epoch;
- checkpoints in the reference layout that inference/model_restore.py reads:
  `fold_X/<name>.model` (a torch dict with state_dict, optimizer_state_dict,
  epoch, plot_stuff, best_stuff) beside a `.model.pkl` sidecar (name, init,
  plans), and plans.pkl in the output folder;
- `validate` (inference/validation.py): every validation case through the
  sliding window on the trainer's device, the network in eval mode under
  no_grad without deep supervision.

Data parallelism (parallel/distributed.py; the counterpart of the JAX
trainer's mesh, trainers.py:274-340): when a process group is up, each rank
draws its share of the plans' global batch (`distribute_batch_size`, the
foreground-forced tail split with it) from samplers and an augmentation
stream seeded by rank, the losses pool their sums over the ranks, and the
training forward runs under DistributedDataParallel with the gradients
summed: every rank takes the update of one device with the global batch.
The heads of deep-supervision weight 0 are left out of the reducer (they get
no gradient, as in one process). Rank 0 alone writes the log, checkpoints,
plans and splits. Without a group nothing of this runs.

A global batch smaller than the rank count trains under the JAX package's
hybrid data x space plan (distributed.layout, parallel/mesh.py): the ranks
of one space group share their data group's samples. The group's first rank
draws the host batch and broadcasts it; every rank of the group runs the
same seeded augmentation on the whole (rotation-enlarged) patch, checks
that its result is the group's, and keeps its slab of the data and of every
deep-supervision target whose level splits (the JAX package fences its
augmentation to batch-only sharding the same way, mesh.py:106-147). The
network computes on slabs (halo exchanges around kernels A and B, pooled
norms) and the losses take each level's share (training/losses.py). Only
the GenericUNet and the residual-encoder UNet on the unfused route, with
instance norms and the default losses, train so; `space_plan_refusal` says
what else raises and its ROADMAP item.

A 2D plan (patch of two axes; cli/train.py's network `2d`) trains the 2D
GenericUNet on slices (PatchSampler2D) under the 2D augmentation chain;
its validation raises, as neither package predicts a 2D model (the JAX
package's sliding window tiles three axes). `network_overrides` is the JAX
package's hook (trainers.py:212-223) through which the variant trainers
(training/variants.py) swap the network's norm, activation and structure;
`deep_supervision` False trains the full-resolution output alone.

The benchmarking trainers (nnUNetTrainerV2_2epochs, _5epochs,
_5epochs_dummyLoad; multitalent_tpu/training/trainers.py:545-600) close the
module.
"""
from __future__ import annotations

import os
import time
from functools import partial

import numpy as np
import torch

from multitalent_tpu_torch.augment.params import (default_2D_augmentation_params,
                                                  default_3D_augmentation_params,
                                                  get_patch_size)
from multitalent_tpu_torch.augment.pipeline import (ds_scales_from_pools, make_augment_fn,
                                                    make_val_transform_fn)
from multitalent_tpu_torch.data.dataset import kfold_split, load_dataset, unpack_dataset
from multitalent_tpu_torch.data.loader import PatchSampler2D, PatchSampler3D, PrefetchPipeline
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.models.mednext import MedNeXt
from multitalent_tpu_torch.models.residual_unet import (BasicResidualBlock,
                                                        build_resenc_unet_from_plans)
from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
from multitalent_tpu_torch.ops.device_export import segmentation_from_regions_bits
from multitalent_tpu_torch.ops.fused_unet import make_inference_forward, make_train_forward
from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor, refuse_2d_prediction
from multitalent_tpu_torch.parallel import distributed, mesh
from multitalent_tpu_torch.plans import Plans, load_plans, save_plans
from multitalent_tpu_torch.training.losses import (dc_and_ce_loss, deep_supervision_loss,
                                                   ds_loss_weights)
from multitalent_tpu_torch.training.schedules import make_poly_schedule, poly_lr
from multitalent_tpu_torch.training.train_state import AdamClipped, SGDClipped
from multitalent_tpu_torch.training.trainer_base import NetworkTrainerBase
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir, save_pickle


# a rank's samplers and augmentation stream take the one-process seeds plus
# this times its data index (its rank, without a space axis), so the data
# groups draw different patches (the reference seeds by rank,
# nnUNetTrainerV2_DDP.py:60-63); rank 0 keeps the one-process seeds
RANK_SEED_STRIDE = 10_000


def space_plan_refusal(trainer_class, plans: Plans, stage: int) -> str | None:
    """Why `trainer_class` does not train under a plan that splits the patch
    over ranks (the space axis), with the ROADMAP item that ports it; None
    where it does."""
    where = "under a space plan (a global batch smaller than the rank count)"
    if len(plans.stage(stage).patch_size) != 3:
        return f"a 2D plan {where} is not ported: ROADMAP queue 1, item 14e"
    if issubclass(trainer_class, SwinUNETRMixin):
        return (f"SwinUNETR {where} is not ported (its windows cross the slabs' "
                f"boundaries): ROADMAP queue 1, item 14c")
    if issubclass(trainer_class, MedNeXtMixin):
        return (f"MedNeXt {where} is not ported (depthwise convs on cuDNN, GroupNorm): "
                f"ROADMAP queue 1, item 14d")
    if os.environ.get("MTTPU_FUSED_TRAIN", "0") == "1":
        return (f"MTTPU_FUSED_TRAIN=1 {where} is not ported (kernels D, E, F take whole "
                f"samples): ROADMAP queue 1, item 14b")
    norm = trainer_class.network_overrides_for(plans, stage).get("norm", "instance")
    if norm not in ("instance", "none") or not getattr(trainer_class.loss_fn, "takes_space",
                                                        False):
        return (f"{trainer_class.__name__} {where} is not ported (its norm or loss pools "
                f"nothing over the space group): ROADMAP queue 1, item 14f")
    return None


def init_weights_he(net: torch.nn.Module, generator: torch.Generator,
                    neg_slope: float = 1e-2) -> None:
    """The reference's InitWeights_He(1e-2): kaiming normal on every conv and
    transposed conv weight, zero conv biases; norms keep (1, 0), but a
    residual block's last norm starts at scale 0
    (init_last_bn_before_add_to_0, as residual_unet.py:53 of the JAX package)."""
    convs = (torch.nn.Conv3d, torch.nn.ConvTranspose3d, torch.nn.Conv2d,
             torch.nn.ConvTranspose2d)
    for m in net.modules():
        if isinstance(m, convs):
            torch.nn.init.kaiming_normal_(m.weight, a=neg_slope, generator=generator)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
        elif isinstance(m, BasicResidualBlock):
            torch.nn.init.zeros_(m.norm2.weight)


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
        # the process group of data-parallel training (None: one process)
        self.process_group = distributed.group()
        self.rank, self.world_size = distributed.rank(), distributed.world_size()
        self.ddp = None  # the training forward under DistributedDataParallel
        self.layout: distributed.Layout | None = None  # this rank's place in the plan
        self.space: mesh.Space | None = None  # this rank's slab of each sample
        self.level_spaces: list[mesh.Share] | None = None  # each output level's share

        self.initial_lr = 1e-2
        self.weight_decay = 3e-5
        self.oversample_foreground_percent = 0.33

        self.online_eval_tp: list[np.ndarray] = []
        self.online_eval_fp: list[np.ndarray] = []
        self.online_eval_fn: list[np.ndarray] = []

        self.deep_supervision = True  # False: the full-resolution output alone
        self.ds_loss_weights: np.ndarray | None = None
        self.data_aug_params: dict | None = None
        self.network: torch.nn.Module | None = None  # GenericUNet or ResidualEncoderUNet
        self.network_forward = None  # make_train_forward(network), with the step functions
        self.local_batch_size: int | None = None  # this rank's share of batch_size
        self.local_oversample: float | None = None
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
        self.classes = plans.all_classes
        self.use_mask_for_norm = plans.use_mask_for_norm
        self.threeD = len(self.patch_size) == 3

    def setup_DA_params(self) -> None:
        """nnUNetTrainerV2.setup_DA_params (trainers.py:115): 3D, or 2D with
        the in-plane rotation narrowed to +-15 degrees for a patch of aspect
        above 1.5."""
        self.deep_supervision_scales = ds_scales_from_pools(
            self.net_num_pool_op_kernel_sizes)
        if self.threeD:
            p = dict(default_3D_augmentation_params)
            if self.do_dummy_2D_aug:
                p["dummy_2D"] = True
                p["elastic_deform_alpha"] = default_2D_augmentation_params.get(
                    "elastic_deform_alpha")
                for k in ("rotation_x", "rotation_y", "rotation_z"):
                    p[k] = default_2D_augmentation_params[k]
        else:
            p = dict(default_2D_augmentation_params)
            if max(self.patch_size) / min(self.patch_size) > 1.5:
                p["rotation_x"] = (-15.0 * 2 * np.pi / 360, 15.0 * 2 * np.pi / 360)
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
            if distributed.is_main() and not os.path.isfile(splits_file):
                self.print_to_log_file("Creating new 5-fold cross-validation split...")
                save_pickle(kfold_split(list(self.dataset.keys())), splits_file)
            distributed.barrier()
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
        """This rank's sampler: its share of the global batch and of the
        foreground-forced tail, its own stream (`seed` offset by rank)."""
        cls = PatchSampler3D if self.threeD else PatchSampler2D
        return cls(dataset, patch_size, self.patch_size, self.local_batch_size,
                   oversample_foreground_percent=self.local_oversample,
                   pad_mode="constant", sampling_probabilities=probabilities,
                   seed=seed + RANK_SEED_STRIDE * self.layout.data_index)

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
    @classmethod
    def network_overrides_for(cls, plans: Plans, stage: int) -> dict:
        """The GenericUNet constructor overrides of this trainer class for
        one stage of `plans` (what network_overrides returns; model restore
        asks the class of a folder's trainer)."""
        return {}

    def network_overrides(self) -> dict:
        """GenericUNet constructor overrides of the architectural-variant
        subclasses (multitalent_tpu/training/trainers.py:212)."""
        return self.network_overrides_for(self.plans, self.stage)

    def initialize_network(self) -> None:
        self.network = build_unet_from_plans(
            self.plans, self.stage, num_classes=self.num_classes,
            dtype=torch.bfloat16 if self.fp16 else torch.float32,
            **self.network_overrides())

    def sgd_momentum(self) -> float:
        """The SGD's Nesterov momentum (the momentum variants change it)."""
        return 0.99

    def initialize_optimizer(self):
        """(optimizer, step -> LR): SGD + clip under the poly staircase
        (trainers.py:225)."""
        return (SGDClipped(self.network.parameters(), momentum=self.sgd_momentum(),
                           nesterov=True, weight_decay=self.weight_decay, clip_norm=12.0),
                make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                   self.num_batches_per_epoch))

    def init_network_weights(self, generator: torch.Generator) -> None:
        init_weights_he(self.network, generator)

    def _init_state(self) -> None:
        """The network's init from a seeded generator (He init), then the
        optimizer (the flax init and optax state of trainers.py:231)."""
        self.init_network_weights(torch.Generator().manual_seed(self.seed))
        self.network.to(self.device)
        self.optimizer, self.lr_schedule = self.initialize_optimizer()
        n_params = sum(p.numel() for p in self.network.parameters())
        self.print_to_log_file(f"network initialized: {n_params:,} parameters")

    # ------------------------------------------------------------ loss plumbing
    def loss_fn(self, outputs, targets, extras: dict):
        """Deep-supervised DC+CE over the global batch; returns (loss, aux
        metrics)."""
        weights = [float(w) for w in self.ds_loss_weights]
        loss = deep_supervision_loss(outputs, targets,
                                     partial(dc_and_ce_loss, batch_dice=self.batch_dice,
                                             group=self.process_group),
                                     weights, self.level_spaces)
        return loss, {}

    loss_fn.takes_space = True  # pools over the space axis (space_plan_refusal)

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
        self._aug_generator = torch.Generator(self.device).manual_seed(
            self.seed + 777 + RANK_SEED_STRIDE * self.layout.data_index)
        self.network_forward = make_train_forward(self.network)
        self._wrap_for_ranks()

    def _wrap_for_ranks(self) -> None:
        """The training forward under DDP when a process group is up. Built
        anew whenever the set of trained parameters changes (DDP registers
        those with requires_grad when it is built)."""
        if self.process_group is None:
            return
        self.ddp = distributed.wrap(self.network, self.network_forward, self.device,
                                    ignore=self._unused_parameters())

    def _unused_parameters(self) -> set[int]:
        """Ids of the parameters no loss reaches: the heads of the
        deep-supervision levels of weight 0 (the outputs are listed highest
        resolution first, the heads lowest first)."""
        heads = self.network.deep_supervision_heads()
        if not self.deep_supervision:  # the highest resolution's head alone
            return {id(p) for h in list(heads)[:-1] for p in h.parameters()}
        return {id(p) for i, w in enumerate(self.ds_loss_weights) if w == 0
                for p in heads[len(heads) - 1 - i].parameters()}

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
        self._plan_ranks()
        self.setup_DA_params()
        self.ds_loss_weights = ds_loss_weights(len(self.deep_supervision_scales),
                                               mask_lowest=True)
        if self.space is not None:
            self.level_spaces = self._level_spaces()
        if self.output_folder_base is not None and distributed.is_main():
            save_plans(self.plans, os.path.join(maybe_mkdir(self.output_folder_base),
                                                "plans.pkl"))
        if training and self.dataset_directory is not None:
            tr_factory, val_factory = self.get_basic_generators()
            if self.unpack_data and distributed.is_main():
                self.print_to_log_file("unpacking dataset")
                unpack_dataset(self.folder_with_preprocessed_data)
            distributed.barrier()
            num_threads = int(self.data_aug_params.get("num_threads", 3))
            if self.space is None or self.space.index == 0:  # the group's first rank draws
                self.tr_gen = PrefetchPipeline(tr_factory, num_workers=num_threads)
                self.val_gen = PrefetchPipeline(val_factory, num_workers=1)
            else:
                self.tr_gen = self.val_gen = None
            self.print_to_log_file("TRAINING KEYS:\n %s" % str(sorted(self.dataset_tr)),
                                   also_print_to_console=False)
            self.print_to_log_file("VALIDATION KEYS:\n %s" % str(sorted(self.dataset_val)),
                                   also_print_to_console=False)
        self.initialize_network()
        self._init_state()
        self._build_step_functions()
        self.was_initialized = True
        self.initialized = True

    def _plan_ranks(self) -> None:
        """This rank's place in the plan of the plans' batch and patch over
        the group's ranks (distributed.layout): its data index, its share of
        the global batch, its space axis; refuses what does not train under
        a space plan."""
        self.layout = distributed.layout(self.batch_size, self.patch_size, self.device.type)
        if self.layout is None:
            raise RuntimeError("the plan leaves this rank idle; it trains nothing")
        self.space = self.layout.space
        self.process_group = distributed.group()
        self.rank, self.world_size = distributed.rank(), distributed.world_size()
        if self.space is not None:
            refusal = space_plan_refusal(type(self), self.plans, self.stage)
            if refusal is not None:
                raise NotImplementedError(refusal)
        self.local_batch_size, self.local_oversample = distributed.rank_batch(
            self.batch_size, self.oversample_foreground_percent, self.layout.data_index,
            self.layout.data)
        if self.process_group is None:
            return
        plan, where = self.layout.plan, f"({distributed.backend()}): global batch "
        if self.space is None:
            if plan is not None and plan.ranks < plan.world:
                self.print_to_log_file(plan.description)
            self.print_to_log_file(
                f"data-parallel over {self.world_size} ranks {where}{self.batch_size}, local "
                f"batch {self.local_batch_size} on rank {self.rank}, foreground-oversample "
                f"{self.local_oversample:.3f}")
        else:
            self.print_to_log_file(
                f"{plan.description} {where}{self.batch_size}, local batch "
                f"{self.local_batch_size} on rank {self.rank} (data index "
                f"{self.layout.data_index}, space index {self.space.index}, {self.space.exchange} "
                f"exchanges), foreground-oversample {self.local_oversample:.3f}")

    def _level_spaces(self) -> list[mesh.Share]:
        """Each deep-supervision level's share of the space axis: split where
        the space size divides the level's extent along the split axis,
        whole below (mesh.Levels)."""
        ax, size = self.space.axis, self.space.size
        return [mesh.Share(self.space, round(self.patch_size[ax] * scale[ax]) % size == 0)
                for scale in self.deep_supervision_scales]

    def _space_batch(self, batch, transform):
        """Under the space axis: the group's first rank's host batch on every
        rank of the group, through `transform` (seeded alike), checked to be
        the group's; returns (this rank's slab of the data, its share of each
        target, extras)."""
        holder = [batch]
        dist = torch.distributed
        dist.broadcast_object_list(holder, src=self.space.ranks[0], group=self.space.group)
        batch = holder[0]
        data, seg = self._to_device(batch["data"]), self._to_device(batch["seg"])
        extras = {k: self._to_device(v) for k, v in self.batch_extras(batch).items()}
        data, targets = transform(data, seg)
        digest = torch.stack([data.double().sum(), *(t.double().sum() for t in targets)])
        spread = torch.stack([digest, -digest])
        dist.all_reduce(spread, op=dist.ReduceOp.MAX, group=self.space.group)
        if not torch.equal(spread[0], -spread[1]):
            raise RuntimeError("the ranks of a space group augmented their batch differently")
        targets = [share.slab(t) for share, t in zip(self.level_spaces, targets)]
        return self.space.slab(data), targets, extras

    # ---------------------------------------------------------------- iteration
    def run_iteration(self, data_generator, do_backprop: bool = True,
                      run_online_evaluation: bool = False) -> float:
        t0 = time.perf_counter()
        if do_backprop:
            def transform(data, seg):
                return self._augment(data, seg, self._aug_generator)
        else:
            transform = self._val_transform
        if self.space is None:
            batch = next(data_generator)
            data, seg = self._to_device(batch["data"]), self._to_device(batch["seg"])
            extras = {k: self._to_device(v) for k, v in self.batch_extras(batch).items()}
            with torch.no_grad():
                data, targets = transform(data, seg)
        else:
            with torch.no_grad():
                data, targets, extras = self._space_batch(
                    next(data_generator) if self.space.index == 0 else None, transform)
        if do_backprop:
            forward = self.network_forward if self.ddp is None else self.ddp
            with mesh.activated(self.space):
                outputs = self._outputs(forward(data, deep_supervision=self.deep_supervision))
            loss, aux = self.loss_fn(outputs, targets, extras)
            self.optimizer.zero_grad()
            loss.backward()
            self.optimizer.step(self.lr_schedule(self.step))
            self.step += 1
        else:
            with torch.no_grad(), mesh.activated(self.space):
                outputs = self._outputs(self.network_forward(
                    data, deep_supervision=self.deep_supervision))
                loss, aux = self.loss_fn(outputs, targets, extras)
                if run_online_evaluation:
                    self.run_online_evaluation(self.eval_stats(outputs, targets, extras))
        value = float(loss.detach())  # waits for the step's device work
        self.on_iteration_metrics(aux, do_backprop)
        if do_backprop:
            self.step_seconds.append(time.perf_counter() - t0)
        return value

    @staticmethod
    def _outputs(outputs) -> list:
        """The forward's outputs as a list of levels (one without deep
        supervision)."""
        return outputs if isinstance(outputs, (list, tuple)) else [outputs]

    def on_iteration_metrics(self, aux: dict, was_train: bool) -> None:
        """Hook for per-iteration aux-metric logging (MultiTalent ce/dice)."""

    # --------------------------------------------------------------- online eval
    def run_online_evaluation(self, stats) -> None:
        """Appends the batch's tp/fp/fn, summed over the ranks."""
        tp, fp, fn = distributed.all_reduce_sum(torch.stack(stats)).cpu().numpy()
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
        """`<name>.model` + `<name>.model.pkl` in the reference layout, the
        network's own keys (no `module.`); rank 0 writes, every rank holds
        the same weights."""
        if not distributed.is_main():
            return
        start = time.time()
        maybe_mkdir(os.path.dirname(fname) or ".")
        meta = self.checkpoint_metadata()
        torch.save({
            "state_dict": {k: v.detach().cpu() for k, v in self.network.state_dict().items()},
            "optimizer_state_dict": self.optimizer.state_dict() if save_optimizer else None,
            "step": self.step,
            # epoch, plot_stuff, best_stuff and what subclasses add
            **{k: v for k, v in meta.items()
               if k not in ("trainer_name", "trainer_bases", "init_args")},
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
        self.print_to_log_file("loading checkpoint", fname, "train=", train)
        if not self.initialized:
            self.initialize(train)
        ckpt = torch.load(fname, map_location="cpu", weights_only=False)
        self.prepare_for_checkpoint(ckpt)
        self.network.load_state_dict(ckpt["state_dict"])
        if train and ckpt.get("optimizer_state_dict") is not None:
            self.optimizer.load_state_dict(ckpt["optimizer_state_dict"])
        self.step = int(ckpt.get("step", ckpt["epoch"] * self.num_batches_per_epoch))
        self.restore_checkpoint_metadata(ckpt)

    def prepare_for_checkpoint(self, ckpt: dict) -> None:
        """Called with a loaded checkpoint before its weights and optimizer
        state are restored (the head warm-up switches its phase here)."""

    # ---------------------------------------------------------------- inference
    inference_nonlin = "softmax"
    regions_class_order = None

    @property
    def network_input_channels(self) -> int:
        """Channels of the network's input: the plans' modalities."""
        return self.num_input_channels

    def get_sliding_window_predictor(self, do_mirroring: bool = True,
                                     step_size: float = 0.5,
                                     use_gaussian: bool = True) -> SlidingWindowPredictor:
        """The tiled predictor of this trainer's plans and head on its device
        (trainers.py:464), in the sliding window's default mode (non-exact
        unless MTTPU_SW_EXACT=1, as the JAX package's)."""
        return SlidingWindowPredictor(
            tuple(int(p) for p in self.patch_size), in_channels=self.network_input_channels,
            num_classes=self.num_classes, nonlin=self.inference_nonlin,
            step_size=step_size, do_mirroring=do_mirroring, mirror_axes=(0, 1, 2),
            use_gaussian=use_gaussian, device=self.device)

    def predict_preprocessed_probabilities(self, data: np.ndarray, do_mirroring: bool = True,
                                           step_size: float = 0.5,
                                           use_gaussian: bool = True):
        """data (C, Z, Y, X) preprocessed -> (probabilities (K, Z, Y, X) on
        the device, fp32 in exact mode and fp16 otherwise, forwards run,
        network calls made).
        The network in eval mode without deep supervision, under no_grad,
        through ops/fused_unet.make_inference_forward (the fused route under
        MTTPU_FUSED_NORM=1)."""
        predictor = self.get_sliding_window_predictor(do_mirroring, step_size, use_gaussian)
        was_training = self.network.training
        self.network.eval()
        try:
            with torch.no_grad():
                probs = predictor.predict(make_inference_forward(self.network), data)
        finally:
            self.network.train(was_training)
        return probs, predictor.forwards, predictor.net_calls

    def predict_preprocessed_data_return_seg_and_softmax(
            self, data: np.ndarray, do_mirroring: bool = True, step_size: float = 0.5,
            use_gaussian: bool = True):
        """data (C, Z, Y, X) preprocessed -> (seg ZYX on the host,
        probabilities (K, Z, Y, X) on the device) (trainers.py:485)."""
        probs, _, _ = self.predict_preprocessed_probabilities(data, do_mirroring, step_size,
                                                              use_gaussian)
        return self.segmentation_of(probs), probs

    def segmentation_of(self, probs: torch.Tensor) -> np.ndarray:
        """The labelmap (ZYX, on the host) of probabilities (K, Z, Y, X): the
        argmax, or the regions' bits above 0.5 in regions_class_order."""
        if self.regions_class_order is None:
            seg = probs.argmax(0).int()
        else:
            seg = segmentation_from_regions_bits(probs > 0.5, self.regions_class_order).int()
        return seg.cpu().numpy()

    # --------------------------------------------------------------- validation
    def validate(self, do_mirroring: bool = True, use_sliding_window: bool = True,
                 step_size: float = 0.5, save_softmax: bool = True,
                 use_gaussian: bool = True, overwrite: bool = True,
                 validation_folder_name: str = "validation_raw", debug: bool = False,
                 all_in_gpu: bool = False, segmentation_export_kwargs: dict | None = None,
                 run_postprocessing_on_folds: bool = True):
        """Predict, export and evaluate every validation case
        (inference/validation.py:run_validation). A 2D plan raises
        (refuse_2d_prediction)."""
        from multitalent_tpu_torch.inference.validation import run_validation
        if not self.threeD:
            refuse_2d_prediction("TrainerV2.validate")
        return run_validation(
            self, do_mirroring=do_mirroring, use_sliding_window=use_sliding_window,
            step_size=step_size, save_softmax=save_softmax, use_gaussian=use_gaussian,
            overwrite=overwrite, validation_folder_name=validation_folder_name,
            debug=debug, all_in_gpu=all_in_gpu,
            segmentation_export_kwargs=segmentation_export_kwargs,
            run_postprocessing_on_folds=run_postprocessing_on_folds)


class ResencUNetMixin:
    """The residual-encoder UNet (models/residual_unet.py) for a trainer:
    its plans carry num_blocks_encoder / num_blocks_decoder and pools with a
    leading (1, 1, 1) stage, which the deep-supervision scales skip
    (multitalent_tpu/training/trainers.py:517-541)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.deep_supervision_scales = ds_scales_from_pools(
            self.net_num_pool_op_kernel_sizes[1:])

    def initialize_network(self) -> None:
        self.network = build_resenc_unet_from_plans(
            self.plans, self.stage, num_classes=self.num_classes,
            dtype=torch.bfloat16 if self.fp16 else torch.float32)


class SwinUNETRMixin:
    """SwinUNETR (models/swin_unetr.py) for a trainer, as the JAX package's
    SwinUNETR trainers set it up (multitalent_tpu/training/multitalent.py:
    297-333, variants.py:840-892): feature_size 48 over the plans' patch
    (divisible by 32), no deep supervision (the scales [[1, 1, 1]], one loss
    weight 1.0), the JAX module's initialisers, AMSGrad Adam with weight
    decay under the poly schedule (AdamClipped, make_adam_optimizer)."""

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.deep_supervision_scales = [[1.0, 1.0, 1.0]]

    def initialize_network(self) -> None:
        self.network = SwinUNETR(self.num_input_channels, self.num_classes,
                                 tuple(int(p) for p in self.patch_size), feature_size=48,
                                 dtype=torch.bfloat16 if self.fp16 else torch.float32)

    def init_network_weights(self, generator: torch.Generator) -> None:
        self.network.init_weights(generator)

    def adam_optimizer(self):
        return (AdamClipped(self.network.parameters(), weight_decay=self.weight_decay,
                            clip_norm=12.0),
                make_poly_schedule(self.initial_lr, self.max_num_epochs,
                                   self.num_batches_per_epoch))

    def initialize_optimizer(self):
        return self.adam_optimizer()


class MedNeXtMixin:
    """MedNeXt (models/mednext.py) for a trainer, as the JAX package's
    MultiTalentTrainerMedNeXt sets it up (multitalent_tpu/training/
    multitalent.py:274-294): n_channels 32, kernel 3, the default exp_r and
    block counts, the JAX module's init; five deep-supervision levels at
    dyadic scales whatever the plans' pools (it always halves each axis)."""

    mednext_channels = 32

    def setup_DA_params(self) -> None:
        super().setup_DA_params()
        self.deep_supervision_scales = ds_scales_from_pools([[2, 2, 2]] * 5)

    def initialize_network(self) -> None:
        self.network = MedNeXt(self.num_input_channels, n_channels=self.mednext_channels,
                               n_classes=self.num_classes,
                               dtype=torch.bfloat16 if self.fp16 else torch.float32)

    def init_network_weights(self, generator: torch.Generator) -> None:
        self.network.init_weights(generator)


class TrainerV2ResencUNet(ResencUNetMixin, TrainerV2):
    """nnUNetTrainerV2_ResencUNet; its _SimonsInit(_20fold) variants zero the
    residual blocks' last norm scale, which init_weights_he always does, so
    they resolve to this trainer as in the JAX package."""


# ----------------------------------------------------------- benchmark trainers
class TrainerV2_2epochs(TrainerV2):
    """Benchmarking trainer: 2 epochs, no validation inference, no checkpoints
    (nnUNet_variants/benchmarking/nnUNetTrainerV2_2epochs.py:27-77)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 2
        self.save_final_checkpoint = False
        self.save_best_checkpoint = False
        self.save_intermediate_checkpoints = False

    def validate(self, *args, **kwargs):
        pass


class TrainerV2_5epochs(TrainerV2_2epochs):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.max_num_epochs = 5


class _DummyBatchGen:
    """Random-tensor generator isolating device throughput from host I/O
    (benchmarking/nnUNetTrainerV2_dummyLoad.py:26-84)."""

    def __init__(self, data_shape, seg_shape, num_classes, seed=0):
        rng = np.random.RandomState(seed)
        self.batch = {
            "data": rng.randn(*data_shape).astype(np.float32),
            "seg": rng.randint(0, num_classes, seg_shape).astype(np.float32),
            "properties": [{} for _ in range(data_shape[0])],
            "keys": ["dummy"] * data_shape[0],
        }

    def __next__(self):
        return self.batch

    def __iter__(self):
        return self


class TrainerV2_dummyLoad(TrainerV2_5epochs):
    """nnUNetTrainerV2_5epochs_dummyLoad: one fixed random batch in place of
    the samplers (this rank's share of the global batch; ranks past 0 draw
    other batches)."""

    def initialize(self, training: bool = True, force_load_plans: bool = False) -> None:
        saved = self.dataset_directory
        self.dataset_directory = None  # skip real generators
        super().initialize(training, force_load_plans)
        self.dataset_directory = saved
        if training:
            b, seed = self.local_batch_size, 2 * self.layout.data_index
            data_shape = (b, self.num_input_channels, *self.basic_generator_patch_size)
            seg_shape = (b, 1, *self.basic_generator_patch_size)
            self.tr_gen = _DummyBatchGen(data_shape, seg_shape, self.num_classes, seed=seed)
            val_shape = (b, self.num_input_channels, *self.patch_size)
            val_seg = (b, 1, *self.patch_size)
            self.val_gen = _DummyBatchGen(val_shape, val_seg, self.num_classes, seed=seed + 1)
