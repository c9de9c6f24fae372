"""Restore a reference-layout model folder into GenericUNet modules.

Counterpart of multitalent_tpu/inference/model_restore.py for the folders the
reference writes (and the released MultiTalent models ship as):

  <model>/plans.pkl
  <model>/fold_X/model_final_checkpoint.model      torch dict with `state_dict`
  <model>/fold_X/model_final_checkpoint.model.pkl  sidecar: trainer `name`,
                                                   its `init` arguments

The trainer named in the sidecar fixes the head: the MultiTalent GenericUNet
trainers predict 47 sigmoid regions, other GenericUNet trainers a softmax over
the plans' classes. The JAX package's own flax `.ckpt` files need flax and are
not read here (ROADMAP).
"""
from __future__ import annotations

import os
from dataclasses import dataclass

import torch

from multitalent_tpu_torch.io.torch_convert import load_reference_checkpoint, strip_module_prefix
from multitalent_tpu_torch.models.generic_unet import GenericUNet, build_unet_from_plans
from multitalent_tpu_torch.plans import Plans, load_plans, save_plans
from multitalent_tpu_torch.tasks.multitalent import NUM_REGIONS
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir, save_pickle, subdirs

# trainers whose network is the GenericUNet with 47 sigmoid region heads
MULTITALENT_TRAINERS = ("MultiTalent_trainer_ddp", "MultiTalent_trainer_ddp_2000ep",
                        "MultiTalentTrainer", "MultiTalentTrainer2000ep")
# trainers whose networks the port does not have yet
UNPORTED_TRAINERS = {
    "MultiTalent_trainer_resenc_ddp": "the residual-encoder UNet",
    "MultiTalent_trainer_resenc_ddp_2000ep": "the residual-encoder UNet",
    "MultiTalent_tainer_resenc_ddp": "the residual-encoder UNet",
    "MultiTalentTrainerResenc": "the residual-encoder UNet",
    "MultiTalentTrainerResenc2000ep": "the residual-encoder UNet",
    "Multitalent_mednextt": "MedNeXt",
    "MultiTalent_meets_mednext": "MedNeXt",
    "MultiTalentTrainerMedNeXt": "MedNeXt",
    "MultiTalent_tainer_SwinUNETR_ddp_adam": "SwinUNETR",
    "MultiTalent_trainer_SwinUNETR_ddp_adam": "SwinUNETR",
    "MultiTalentTrainerSwinUNETR": "SwinUNETR",
}


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
    networks: list[GenericUNet]


def _fold_folders(model_folder: str, folds) -> list[str]:
    if isinstance(folds, (str, int)):
        folds = [folds]
    if folds is None:
        names = subdirs(model_folder, prefix="fold_", join=False)
        folds = sorted(int(f.split("_")[-1]) for f in names)
    return [os.path.join(model_folder, "all" if f == "all" else f"fold_{f}")
            for f in folds]


def load_model_and_checkpoint_files(model_folder: str, folds=None,
                                    checkpoint_name: str = "model_final_checkpoint",
                                    device: str | torch.device = "cuda") -> RestoredModel:
    """Read plans.pkl, the sidecar and every requested fold's checkpoint of a
    reference-layout model folder (model_restore.py:109-148)."""
    ckpts = [os.path.join(f, checkpoint_name + ".model")
             for f in _fold_folders(model_folder, folds)]
    missing = [c for c in ckpts if not os.path.isfile(c)]
    if missing or not ckpts:
        raise FileNotFoundError(f"missing checkpoints: {missing or model_folder}")
    info = load_pickle(ckpts[0] + ".pkl")
    name = str(info["name"])
    init = tuple(info.get("init", ()))
    if name in UNPORTED_TRAINERS:
        raise NotImplementedError(
            f"trainer {name!r} uses {UNPORTED_TRAINERS[name]}, which the port does "
            "not have yet (ROADMAP queue 1, item 10)")
    plans = load_plans(os.path.join(model_folder, "plans.pkl"))
    stage = init[5] if len(init) > 5 and init[5] is not None else max(plans.plans_per_stage)
    fp16 = bool(init[8]) if len(init) > 8 else True
    if name in MULTITALENT_TRAINERS:
        nonlin, num_classes = "sigmoid", NUM_REGIONS
        regions_class_order = list(range(NUM_REGIONS))
    else:
        nonlin, num_classes, regions_class_order = "softmax", plans.num_classes + 1, None

    networks = []
    for c in ckpts:
        state_dict = strip_module_prefix(load_reference_checkpoint(c))
        if not any(k.startswith("conv_blocks_context.") for k in state_dict):
            raise NotImplementedError(
                f"{c} is not a GenericUNet checkpoint (trainer {name!r}); other "
                "networks are ROADMAP queue 1, item 10")
        net = build_unet_from_plans(plans, stage, num_classes,
                                    dtype=torch.bfloat16 if fp16 else torch.float32)
        # the reference keeps deep-supervision heads and unused lrelu modules;
        # every parameter the port's network has must be present
        net.load_state_dict({k: v for k, v in state_dict.items()
                             if k in net.state_dict()}, strict=True)
        networks.append(net.to(device).eval())
    return RestoredModel(plans=plans, stage=stage, trainer_name=name,
                         inference_nonlin=nonlin,
                         regions_class_order=regions_class_order,
                         num_classes=num_classes,
                         patch_size=tuple(plans.stage(stage).patch_size),
                         networks=networks)


def save_model_folder(model_folder: str, plans: Plans, state_dicts: list[dict],
                      trainer_name: str, stage: int = 0, fp16: bool = True,
                      checkpoint_name: str = "model_final_checkpoint") -> None:
    """Write a reference-layout model folder (the layout read above): plans.pkl,
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
