"""The SwinUNETR trainers through the port's entry points on the CPU, on a
tiny preprocessed MultiTalent task (two source datasets, one 32^3 patch a
case, export geometry and ground truth stamped), at the trainers' width
(feature_size 48):

- cli.train with each SwinUNETR trainer name the JAX package registers for
  MultiTalent and the head warm-up: one step, the validation of one case;
  for MultiTalent_trainer_SwinUNETR_ddp_adam also `-val` and
  predict_multitalent from its folder; the head warm-up from
  -pretrained_weights <a MultiTalent SwinUNETR as a JAX `.ckpt`>: the
  backbone loads the weights and stays bit for bit, only `out.*` moves;
- cli.predict -tr nnUNetTrainerV2_swinunetr_adam_ddp on a softmax folder of
  seeded weights.

(The networks and trainers against the JAX package's:
test_torch_port_swin.py, test_torch_port_swin_train*.py.)
"""
import numpy as np
import pytest
import torch

from multitalent_tpu import paths
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference.model_restore import (save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io import Geometry, Plans, read_nifti, save_plans, write_nifti
from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainerSwinUNETR
from multitalent_tpu_torch.training.train_state import AdamClipped, AdamWClipped
from multitalent_tpu_torch.training.warmup import TrainerV2WarmupSegHeadsSwin

from test_torch_port_predict import SHAPE, _phantom, _tiny_plans
from test_torch_port_validation import stamp_export_geometry
from test_training import make_preprocessed

TASK = "Task100_MultiTalent"
PATCH = [32, 32, 32]
PLANS_ID = paths.default_plans_identifier


@pytest.fixture
def task(tmp_path, monkeypatch):
    """The tiny task with 32^3 plans at batch 1, one training step an epoch
    and one validation case."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    pre, results = tmp_path / "pre", tmp_path / "results"
    monkeypatch.setenv("nnUNet_preprocessed", str(pre))
    monkeypatch.setenv("RESULTS_FOLDER", str(results))
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "1")
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "1")
    monkeypatch.setenv("MTTPU_VAL_ITERS", "1")
    ddir = pre / TASK
    for prefix, regions, labels in (("003", ("03_liver", "03_cancer"), [1, 2]),
                                    ("009", ("09_spleen",), [8])):
        make_preprocessed(ddir, n_cases=2, prefix=prefix, shape=(24, 32, 32),
                          extra_props={"valid_regions": regions, "valid_labels": labels})
    d = _tiny_plans().to_dict()
    # batch 1: a step at the trainers' width costs seconds on the CPU
    d["plans_per_stage"][0].update(patch_size=PATCH, batch_size=1)
    plans = Plans.from_dict(d)
    save_plans(plans, ddir / f"{PLANS_ID}_plans_3D.pkl")
    stamp_export_geometry(ddir)
    keys = [f"{p}_{i:03d}" for p in ("003", "009") for i in range(2)]
    save_pickle([{"train": keys, "val": ["003_001"]}] * 12, ddir / "splits_custom.pkl")
    save_pickle([{"train": keys, "val": ["003_001"]}] * 5, ddir / "splits_final.pkl")
    (tmp_path / "in").mkdir()
    write_nifti(tmp_path / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    yield tmp_path, plans, results / "nnUNet" / "3d_fullres" / TASK
    torch.set_num_threads(threads)


def _pretrained_ckpt(tmp, plans) -> tuple[str, dict]:
    """A MultiTalent SwinUNETR (47 regions) of seeded weights as a JAX-layout
    folder: its `.ckpt` and its state dict."""
    source = SwinUNETR(1, 47, PATCH)
    source.init_weights(torch.Generator().manual_seed(3))
    sd = source.state_dict()
    save_jax_model_folder(str(tmp / "jax_model"), plans, [sd], "MultiTalentTrainerSwinUNETR")
    return str(tmp / "jax_model" / "fold_0" / "model_final_checkpoint.ckpt"), sd


@pytest.mark.parametrize("name,cls", [
    ("MultiTalent_trainer_SwinUNETR_ddp_adam", MultiTalentTrainerSwinUNETR),
    ("MultiTalent_tainer_SwinUNETR_ddp_adam", MultiTalentTrainerSwinUNETR),
    ("nnUNetTrainerV2_warmupsegheads_swinunetr_adam_lr5e4_ddp", TrainerV2WarmupSegHeadsSwin)])
def test_swinunetr_trainers_train_and_validate(task, name, cls):
    tmp, plans, root = task
    warmup = cls is TrainerV2WarmupSegHeadsSwin
    extra = []
    if warmup:
        ckpt, pretrained = _pretrained_ckpt(tmp, plans)
        extra = ["-pretrained_weights", ckpt]
    trainer = train.main(["3d_fullres", name, TASK, "0", "--device", "cpu", *extra])
    assert type(trainer) is cls and isinstance(trainer.network, SwinUNETR)
    assert trainer.step == 1 and np.isfinite(trainer.all_tr_losses).all()
    assert trainer.network.feature_size == 48 and trainer.network.patch_size == (32, 32, 32)
    assert isinstance(trainer.optimizer, AdamWClipped if warmup else AdamClipped)
    model = root / f"{name}__{PLANS_ID}"
    val = model / "fold_0" / "validation_raw"
    assert {f.name for f in val.glob("*.nii.gz")} == {"003_001.nii.gz"}
    # one tile, 8 mirror combinations in the default mode's 2 calls of 4
    assert [(t["forwards"], t["net_calls"]) for t in trainer.validation_timings] == [(8, 2)]
    if warmup:
        # phase 1: the backbone is the pretrained one, bit for bit; `out` (48
        # softmax classes here, 47 regions there) started at its init and moved
        assert trainer.optimizer_phase == 1
        fresh = SwinUNETR(1, plans.num_classes + 1, PATCH)
        fresh.init_weights(torch.Generator().manual_seed(trainer.seed))
        init = fresh.state_dict()
        for k, v in trainer.network.state_dict().items():
            if k.startswith("out."):
                assert v.shape == init[k].shape and not torch.equal(v, init[k]), k
            else:
                assert torch.equal(v, pretrained[k]), k
    if name != "MultiTalent_trainer_SwinUNETR_ddp_adam":
        return
    again = train.main(["3d_fullres", name, TASK, "0", "-val", "--val_folder", "again",
                        "--device", "cpu"])
    for f in val.glob("*.nii.gz"):
        assert np.array_equal(read_nifti(f)[0],
                              read_nifti(model / "fold_0" / "again" / f.name)[0])
    assert isinstance(again.network, SwinUNETR)
    timings = predict_main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-m", str(model),
                            "--device", "cpu", "--disable_tta"])
    assert [t["case"] for t in timings] == ["case"]
    assert read_nifti(tmp / "out" / "case.nii.gz")[0].shape == SHAPE
    assert {read_nifti(tmp / "out" / "individual" / r / "case.nii.gz")[0].shape
            for r in REGIONS} == {SHAPE}


def test_predict_cli_takes_the_swinunetr_trainer(task):
    """cli.predict -tr nnUNetTrainerV2_swinunetr_adam_ddp: a softmax
    SwinUNETR folder of seeded weights predicts a labelmap of the plans'
    classes at the input's shape."""
    tmp, plans, root = task
    name = "nnUNetTrainerV2_swinunetr_adam_ddp"
    net = SwinUNETR(1, plans.num_classes + 1, PATCH)
    net.init_weights(torch.Generator().manual_seed(7))
    save_model_folder(str(root / f"{name}__{PLANS_ID}"), plans, [net.state_dict()], name,
                      fp16=False)
    timings = predict_cli.main(["-i", str(tmp / "in"), "-o", str(tmp / "out_softmax"), "-t",
                                TASK, "-tr", name, "--device", "cpu", "--disable_tta"])
    assert [t["case"] for t in timings] == ["case"]
    seg, _ = read_nifti(tmp / "out_softmax" / "case.nii.gz")
    assert seg.shape == SHAPE and set(np.unique(seg)) <= set(range(plans.num_classes + 1))
