"""Restore a model folder into GenericUNet, ResidualEncoderUNet, SwinUNETR or MedNeXt modules.

Counterpart of multitalent_tpu/inference/model_restore.py. Two layouts:

- the reference's (written by the reference, the port's trainer and
  `save_model_folder`; the released MultiTalent models ship as it):

    <model>/plans.pkl
    <model>/fold_X/model_final_checkpoint.model      torch dict with `state_dict`
    <model>/fold_X/model_final_checkpoint.model.pkl  sidecar: trainer `name`,
                                                     its `init` arguments

- the JAX package's (multitalent_tpu/training/trainer_base.py:166-182, or
  its import of a reference folder):

    <model>/fold_X/model_final_checkpoint.ckpt       flax msgpack: step, params
                                                     [, opt_state]
    <model>/fold_X/model_final_checkpoint.ckpt.pkl   sidecar: trainer_name,
                                                     trainer_bases, init_args

  read by io/flax_ckpt.py (no flax) and carried over by
  io/from_jax.generic_unet_state_dict_from_flax (or
  resenc_state_dict_from_flax, swin_unetr_state_dict_from_flax,
  mednext_state_dict_from_flax). The plans come from the sidecar's
  `init_args[0]` (a plans file or a pickled Plans) or else from
  `<model>/plans.pkl`. The sidecar may pickle the JAX package's Plans: it is
  read by `load_sidecar`, whose unpickler maps those names to the port's
  classes and refuses every name off its allow-list, so nothing of the JAX
  package is imported.

The checkpoint's keys pick the network, as the JAX package's import does
(multitalent_tpu/inference/pretrained_models.py:350-356):
`encoder.initial_conv.weight` (or `initial_conv` in a flax tree) is the
residual-encoder UNet, its block counts from the plans; a reference resenc
`.model` has its quirks undone by io/torch_convert.fabians_unet_state_dict.
`patch_embed.weight` (or `patch_embed` in a flax tree) is the SwinUNETR, its
width, depths and heads read from the weights, its window tables sized by
the plans' patch. `stem.weight` (or `stem`) is the MedNeXt, its width,
expansion ratios, block counts and kernel read from the weights. The
trainer named in the sidecar fixes the head: the MultiTalent trainers
predict 47 sigmoid regions, the others a softmax over the plans' classes.
It also fixes a GenericUNet's variant (training/variants.py): batch and
instance norm weights have the same keys, and so have the conv -> nonlin ->
norm blocks of the convReLUIN trainers, so the nearest trainer name the port
knows gives the network_overrides it is built with. A 2D plan restores
a 2D network (which nothing predicts with: inference/predict.py refuses it).
"""
from __future__ import annotations

import os
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from multitalent_tpu_torch.io import flax_ckpt
from multitalent_tpu_torch.io.from_jax import (generic_unet_state_dict_from_flax,
                                               mednext_state_dict_from_flax,
                                               resenc_state_dict_from_flax,
                                               swin_unetr_state_dict_from_flax)
from multitalent_tpu_torch.io.torch_convert import (convert_generic_unet_state_dict,
                                                   convert_mednext_state_dict,
                                                   convert_resenc_state_dict,
                                                   convert_swin_unetr_state_dict,
                                                   fabians_unet_state_dict,
                                                   load_reference_checkpoint,
                                                   mednext_block_counts,
                                                   strip_module_prefix, swin_depths)
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.models.mednext import MedNeXt
from multitalent_tpu_torch.models.residual_unet import build_resenc_unet_from_plans
from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
from multitalent_tpu_torch.plans import Plans, StagePlans, load_plans, save_plans
from multitalent_tpu_torch.tasks.multitalent import NUM_REGIONS
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir, save_pickle, subdirs

# trainers whose networks predict the 47 sigmoid regions
MULTITALENT_TRAINERS = ("MultiTalent_trainer_ddp", "MultiTalent_trainer_ddp_2000ep",
                        "MultiTalentTrainer", "MultiTalentTrainer2000ep",
                        "MultiTalent_trainer_resenc_ddp", "MultiTalent_trainer_resenc_ddp_2000ep",
                        "MultiTalent_tainer_resenc_ddp", "MultiTalentTrainerResenc",
                        "MultiTalentTrainerResenc2000ep", "MultiTalent_tainer_SwinUNETR_ddp_adam",
                        "MultiTalent_trainer_SwinUNETR_ddp_adam", "MultiTalentTrainerSwinUNETR",
                        "Multitalent_mednextt", "MultiTalent_meets_mednext",
                        "MultiTalentTrainerMedNeXt")

# what a JAX sidecar may name: the JAX package's plans classes, read as the
# port's, and the numpy names its arrays and scalars pickle with
SIDECAR_CLASSES = {("multitalent_tpu.plans", "Plans"): Plans,
                   ("multitalent_tpu.plans", "StagePlans"): StagePlans}
_NUMPY_NAMES = {("numpy", "ndarray"), ("numpy", "dtype"),
                ("numpy.core.multiarray", "_reconstruct"),
                ("numpy._core.multiarray", "_reconstruct"),
                ("numpy.core.multiarray", "scalar"), ("numpy._core.multiarray", "scalar")}


class _SidecarUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if (module, name) in SIDECAR_CLASSES:
            return SIDECAR_CLASSES[module, name]
        if (module, name) in _NUMPY_NAMES:
            return super().find_class(module, name)
        raise pickle.UnpicklingError(
            f"the sidecar names {module}.{name}, which is not on the port's allow-list")


def load_sidecar(path: str) -> dict:
    """A `.ckpt.pkl` sidecar of the JAX package, with its Plans as the port's."""
    with open(path, "rb") as f:
        return _SidecarUnpickler(f).load()


def head_of_trainer(names) -> tuple[str, str]:
    """(trainer name, "sigmoid" or "softmax") for a trainer and its bases,
    nearest first."""
    names = list(names)
    for n in names:
        if n in MULTITALENT_TRAINERS:
            return names[0], "sigmoid"
    return names[0], "softmax"


@dataclass
class RestoredModel:
    """What inference needs from a trainer: plans, stage, head, one network
    per fold (on the requested device, weights loaded)."""

    plans: Plans
    stage: int
    trainer_name: str
    inference_nonlin: str
    regions_class_order: list[int] | None
    num_classes: int
    patch_size: tuple[int, ...]
    networks: list[torch.nn.Module]  # GenericUNet, ResidualEncoderUNet, SwinUNETR or MedNeXt


def _fold_folders(model_folder: str, folds) -> list[str]:
    if isinstance(folds, (str, int)):
        folds = [folds]
    if folds is None:
        names = subdirs(model_folder, prefix="fold_", join=False)
        folds = sorted(int(f.split("_")[-1]) for f in names)
    return [os.path.join(model_folder, "all" if f == "all" else f"fold_{f}")
            for f in folds]


def _jax_plans(model_folder: str, init: tuple) -> Plans:
    """The plans of a JAX-layout folder: the sidecar's init_args[0] (a
    Plans or a plans file), else <model>/plans.pkl."""
    first = init[0] if init else None
    if isinstance(first, Plans):
        return first
    fallback = os.path.join(model_folder, "plans.pkl")
    for path in (first, fallback):
        if isinstance(path, (str, os.PathLike)) and os.path.isfile(path):
            return load_plans(path)
    raise FileNotFoundError(f"no plans for {model_folder}: the sidecar's init_args[0] "
                            f"({first!r}) is no plans file, and {fallback} is missing")


def is_resenc_state_dict(state_dict: dict) -> bool:
    """Whether a state dict (`module.` prefix or not) is the residual-encoder
    UNet's (pretrained_models.py:350 of the JAX package asks the same)."""
    return any(k.removeprefix("module.") == "encoder.initial_conv.weight" for k in state_dict)


def is_swin_unetr_state_dict(state_dict: dict) -> bool:
    """Whether a state dict (`module.` prefix or not) is the SwinUNETR's."""
    return any(k.removeprefix("module.") == "patch_embed.weight" for k in state_dict)


def is_mednext_state_dict(state_dict: dict) -> bool:
    """Whether a state dict (`module.` prefix or not) is the MedNeXt's."""
    return any(k.removeprefix("module.") == "stem.weight" for k in state_dict)


def checkpoint_state_dict(path: str, plans: Plans, stage: int) -> dict:
    """The port's state dict of a JAX `.ckpt` file (its params through
    io/from_jax.py, `plans` giving the depth or the block counts) or of a
    reference or port `.model` file (a reference resenc one through
    io/torch_convert.fabians_unet_state_dict; a SwinUNETR's and a MedNeXt's
    keys are the port's own)."""
    st = plans.stage(stage)
    if path.endswith(".model"):
        sd = strip_module_prefix(load_reference_checkpoint(path))
        if is_resenc_state_dict(sd):
            return fabians_unet_state_dict(sd, len(st.pool_op_kernel_sizes))
        return sd
    if not path.endswith(".ckpt"):
        raise ValueError(f"a checkpoint is a JAX .ckpt or a .model file, got {path!r}")
    params = flax_ckpt.load(path)["params"]
    if "initial_conv" in params:
        return resenc_state_dict_from_flax(params, st.num_blocks_encoder,
                                           st.num_blocks_decoder)
    if "patch_embed" in params:
        return swin_unetr_state_dict_from_flax(params)
    if "stem" in params:
        return mednext_state_dict_from_flax(params)
    if "enc0" not in params:
        raise ValueError(f"{path} is none of the port's networks (a GenericUNet, a "
                         "residual-encoder UNet, a SwinUNETR, a MedNeXt)")
    # the convs a stage from the tree: a variant may override the plans'
    return generic_unet_state_dict_from_flax(
        params, num_pool=len(st.pool_op_kernel_sizes),
        conv_per_stage=sum(1 for k in params["enc0"] if k.startswith("block")))


def _mednext_from_weights(state_dict: dict, num_classes: int, dtype: torch.dtype) -> MedNeXt:
    """The MedNeXt a state dict is for: input channels and width from the
    stem, the kernel from a depthwise conv, each level's expansion ratio
    from its down or up block (the bottleneck's from its first block), the
    block counts from the names."""
    stem = state_dict["stem.weight"]

    def ratio(prefix: str) -> int:
        w = state_dict[f"{prefix}.expand.weight"]
        return int(w.shape[0]) // int(w.shape[1])

    exp_r = ([ratio(f"down{lvl}") for lvl in range(4)] + [ratio("bottleneck.block0")]
             + [ratio(f"up{lvl}") for lvl in range(3, -1, -1)])
    return MedNeXt(int(stem.shape[1]), n_channels=int(stem.shape[0]), n_classes=num_classes,
                   exp_r=exp_r, block_counts=mednext_block_counts(state_dict),
                   kernel_size=int(state_dict["down0.dwconv.weight"].shape[-1]),
                   do_res_up_down="down0.res_conv.weight" in state_dict, dtype=dtype)


def network_overrides_of(names, plans: Plans, stage: int) -> dict:
    """The GenericUNet overrides of the nearest trainer of `names` (nearest
    first) that the port's variant zoo knows (a convReLUIN trainer's
    `nonlin_first` among them), {} where none is a variant: the loss,
    optimizer and schedule variants build TrainerV2's network."""
    from multitalent_tpu_torch.training.variants import VARIANT_ALIASES
    known = {n: cls for cls, aliases in VARIANT_ALIASES.items()
             for n in (cls.__name__, *aliases)}
    for n in names:
        if n in known:
            return known[n].network_overrides_for(plans, stage)
    return {}


def build_network(state_dict: dict, plans: Plans, stage: int, num_classes: int,
                  dtype: torch.dtype, overrides: dict | None = None) -> torch.nn.Module:
    """The network a state dict is for, built from the plans (a GenericUNet
    with a variant trainer's `overrides`), its weights loaded: every
    parameter the network has must be present (the reference keeps
    deep-supervision heads and unused modules, which are dropped)."""
    if is_resenc_state_dict(state_dict):
        net = build_resenc_unet_from_plans(plans, stage, num_classes, dtype=dtype)
    elif is_swin_unetr_state_dict(state_dict):
        # width, depths and heads from the weights; the patch sizes the windows
        net = SwinUNETR(plans.num_modalities, num_classes, plans.stage(stage).patch_size,
                        feature_size=int(state_dict["patch_embed.weight"].shape[0]),
                        depths=swin_depths(state_dict),
                        num_heads=tuple(int(state_dict[f"stage{s}_block0.attn.rel_pos_bias"]
                                            .shape[1]) for s in range(4)),
                        dtype=dtype)
    elif is_mednext_state_dict(state_dict):
        net = _mednext_from_weights(state_dict, num_classes, dtype)
    elif any(k.startswith("conv_blocks_context.") for k in state_dict):
        net = build_unet_from_plans(plans, stage, num_classes, dtype=dtype,
                                    **(overrides or {}))
    else:
        raise ValueError("none of the port's networks (a GenericUNet, a residual-encoder "
                         "UNet, a SwinUNETR, a MedNeXt)")
    own = net.state_dict()
    net.load_state_dict({k: v for k, v in state_dict.items() if k in own}, strict=True)
    return net


def read_model_folder(model_folder: str, folds=None,
                      checkpoint_name: str = "model_final_checkpoint"):
    """(plans, stage, fp16, trainer names nearest first, checkpoint file per
    fold) of a reference-layout or JAX-layout folder."""
    folders = _fold_folders(model_folder, folds)
    if not folders:
        raise FileNotFoundError(f"no fold folders in {model_folder}")
    models = [os.path.join(f, checkpoint_name + ".model") for f in folders]
    ckpts = [os.path.join(f, checkpoint_name + ".ckpt") for f in folders]
    if all(os.path.isfile(c) for c in models):
        info = load_pickle(models[0] + ".pkl")
        init = tuple(info.get("init", ()))
        names = [str(info["name"])]
        plans = load_plans(os.path.join(model_folder, "plans.pkl"))
        files = models
    elif all(os.path.isfile(c) for c in ckpts):
        meta = load_sidecar(ckpts[0] + ".pkl")
        init = tuple(meta.get("init_args", ()))
        names = [str(meta["trainer_name"]), *meta.get("trainer_bases", ())]
        plans = _jax_plans(model_folder, init)
        files = ckpts
    else:
        raise FileNotFoundError(
            f"missing checkpoints in {model_folder}: neither every {checkpoint_name}.model "
            f"nor every {checkpoint_name}.ckpt of {[os.path.basename(f) for f in folders]}")
    stage = init[5] if len(init) > 5 and init[5] is not None else max(plans.plans_per_stage)
    fp16 = bool(init[8]) if len(init) > 8 else True
    return plans, stage, fp16, names, files


def load_model_and_checkpoint_files(model_folder: str, folds=None,
                                    checkpoint_name: str = "model_final_checkpoint",
                                    device: str | torch.device = "cuda") -> RestoredModel:
    """Read the plans, the sidecar and every requested fold's checkpoint of a
    reference-layout or JAX-layout model folder (model_restore.py:109-148)."""
    plans, stage, fp16, names, files = read_model_folder(model_folder, folds,
                                                         checkpoint_name)
    name, nonlin = head_of_trainer(names)
    if nonlin == "sigmoid":
        num_classes, regions_class_order = NUM_REGIONS, list(range(NUM_REGIONS))
    else:
        num_classes, regions_class_order = plans.num_classes + 1, None

    dtype = torch.bfloat16 if fp16 else torch.float32
    overrides = network_overrides_of(names, plans, stage)
    networks = [build_network(checkpoint_state_dict(f, plans, stage), plans, stage,
                              num_classes, dtype, overrides).to(device).eval() for f in files]
    return RestoredModel(plans=plans, stage=stage, trainer_name=name,
                         inference_nonlin=nonlin,
                         regions_class_order=regions_class_order,
                         num_classes=num_classes,
                         patch_size=tuple(plans.stage(stage).patch_size),
                         networks=networks)


def save_model_folder(model_folder: str, plans: Plans, state_dicts: list[dict],
                      trainer_name: str, stage: int = 0, fp16: bool = True,
                      checkpoint_name: str = "model_final_checkpoint") -> None:
    """Write a reference-layout model folder (the layout read above) of
    GenericUNet, residual-encoder UNet, SwinUNETR or MedNeXt state dicts: plans.pkl,
    and per fold i a `fold_i/<checkpoint>.model` holding {"state_dict": ...}
    with its sidecar naming `trainer_name` and the reference's init arguments
    (plans_file, fold, output_folder, dataset_directory, batch_dice, stage,
    unpack_data, deterministic, fp16)."""
    plans_path = os.path.join(model_folder, "plans.pkl")
    save_plans(plans, plans_path)
    for fold, sd in enumerate(state_dicts):
        fold_dir = maybe_mkdir(os.path.join(model_folder, f"fold_{fold}"))
        ckpt = os.path.join(fold_dir, checkpoint_name + ".model")
        torch.save({"epoch": 0, "state_dict": sd}, ckpt)
        save_pickle({"name": trainer_name,
                     "init": (plans_path, fold, model_folder, None, True, stage, True,
                              True, fp16),
                     "plans": plans.to_dict()}, ckpt + ".pkl")


def save_jax_model_folder(model_folder: str, plans: Plans, state_dicts: list[dict],
                          trainer_name: str, trainer_bases=(), stage: int = 0,
                          fp16: bool = True,
                          checkpoint_name: str = "model_final_checkpoint") -> None:
    """Write a JAX-layout model folder of GenericUNet, residual-encoder UNet,
    SwinUNETR or MedNeXt state dicts, the files multitalent_tpu's trainer
    writes: per fold i `fold_i/<checkpoint>.ckpt`, flax msgpack of {"step",
    "params"} (io/flax_ckpt.dumps of io/torch_convert.
    convert_generic_unet_state_dict, convert_resenc_state_dict, which
    carries the biases, convert_swin_unetr_state_dict or
    convert_mednext_state_dict), and its
    `.ckpt.pkl` sidecar (trainer_name, trainer_bases, init_args, state_keys).
    init_args[0] is <model>/plans.pkl."""
    plans_path = os.path.join(maybe_mkdir(model_folder), "plans.pkl")
    save_plans(plans, plans_path)
    st = plans.stage(stage)
    for fold, sd in enumerate(state_dicts):
        fold_dir = maybe_mkdir(os.path.join(model_folder, f"fold_{fold}"))
        ckpt = os.path.join(fold_dir, checkpoint_name + ".ckpt")
        if is_resenc_state_dict(sd):
            params = convert_resenc_state_dict(sd, st.num_blocks_encoder, st.num_blocks_decoder)
        elif is_swin_unetr_state_dict(sd):
            params = convert_swin_unetr_state_dict(sd)
        elif is_mednext_state_dict(sd):
            params = convert_mednext_state_dict(sd)
        else:
            stage0 = {k.split(".")[3] for k in sd if k.startswith("conv_blocks_context.0.blocks.")}
            params = convert_generic_unet_state_dict(sd, len(st.pool_op_kernel_sizes),
                                                     len(stage0))
        tree = {"step": np.zeros((), np.int32), "params": params}
        flax_ckpt.save(ckpt, tree)
        save_pickle({"epoch": 0, "plot_stuff": ([], [], [], []),
                     "best_stuff": (None, None, None), "trainer_name": trainer_name,
                     "trainer_bases": [trainer_name, *trainer_bases],
                     "init_args": (plans_path, fold, model_folder, None, True, stage, True,
                                   True, fp16),
                     "state_keys": sorted(tree)}, ckpt + ".pkl")
