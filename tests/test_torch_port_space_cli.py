"""The train CLI under a space plan on the CPU: `--device cpu -gpus 2` on
the synthetic task of test_torch_port_train_cli.py with its global batch
set to 1, which plans data 1 x space 2 (the patch's x, 32, split 16 a rank)
instead of refusing a rank without a sample. The two gloo ranks train,
validate (the cases split over the ranks) and write one folder that
predicts; what does not train under a space plan yet is refused before any
rank starts, naming its ROADMAP item.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.plans import Plans, save_plans
from multitalent_tpu_torch.training.trainers import space_plan_refusal

from test_torch_port_predict import _phantom, _tiny_plans
from test_torch_port_train_cli import TASK, one_thread, task  # noqa: F401 (fixtures)


def _plans_with_batch(batch: int, patch=None) -> Plans:
    d = _tiny_plans().to_dict()
    d["plans_per_stage"][0]["batch_size"] = batch
    if patch is not None:
        d["plans_per_stage"][0]["patch_size"] = list(patch)
    return Plans.from_dict(d)


@pytest.fixture
def batch_one(task, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    ddir = Path(os.environ["nnUNet_preprocessed"]) / TASK
    save_plans(_plans_with_batch(1), ddir / f"{paths.default_plans_identifier}_plans_3D.pkl")
    return task


def test_two_ranks_train_a_batch_of_one_and_the_folder_predicts(batch_one):
    tmp, model = batch_one
    assert train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cpu",
                       "-gpus", "2"]) is None  # the ranks ran apart
    fold = model / "fold_0"
    log = next(fold.glob("training_log_*.txt")).read_text()
    assert ("hybrid data x spatial parallelism over 2 ranks: batch 1 sharded 1-way, patch "
            "axis 2 (size 32) sharded 2-way") in log
    assert "space index 0, p2p exchanges" in log
    ckpt = torch.load(fold / "model_final_checkpoint.model", weights_only=False)
    assert ckpt["epoch"] == 1 and all(torch.isfinite(v).all() for v in ckpt["state_dict"].values())
    assert {f.name for f in (fold / "validation_raw").glob("*.nii.gz")} == {
        "003_001.nii.gz", "009_001.nii.gz"}
    (tmp / "in").mkdir()
    write_nifti(tmp / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    predict_main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-m", str(model), "-f", "0",
                  "--device", "cpu", "--disable_tta"])
    seg, _ = read_nifti(tmp / "out" / "case.nii.gz")
    assert seg.shape == _phantom(np.random.RandomState(0)).shape


def test_a_plan_that_idles_ranks_trains_on_the_rest(task, monkeypatch, capfd):
    """The task's batch of 2 on 3 ranks: gcd 1, and no extent of the patch
    (16, 32, 32) divides 3, so the plan trains on one rank (the JAX
    package's plan of None: one device) and the other two exit idle, with
    a WARNING; the folder is written."""
    tmp, model = task
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cpu",
                       "-gpus", "3"]) is None
    err = capfd.readouterr().err
    assert "WARNING: batch 2 not divisible over 3 ranks" in err and "2 idle" in err
    assert "rank 1 is idle under the plan" in err and "rank 2 is idle under the plan" in err
    log = next((model / "fold_0").glob("training_log_*.txt")).read_text()
    assert "data-parallel over 1 ranks (gloo): global batch 2, local batch 2 on rank 0" in log
    assert (model / "fold_0" / "model_final_checkpoint.model").is_file()


@pytest.mark.parametrize("trainer,item", [
    ("MultiTalent_trainer_SwinUNETR_ddp_adam", "14c"), ("MultiTalent_meets_mednext", "14d"),
    ("nnUNetTrainerV2_GN", "14f"), ("nnUNetTrainerV2_Loss_DiceTopK10", "14f")])
def test_what_is_not_ported_under_a_space_plan_is_refused(batch_one, trainer, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1, item {item}"):
        train.main(["3d_fullres", trainer, TASK, "0", "--device", "cpu", "-gpus", "2"])


def test_refusals_by_trainer_and_plan(monkeypatch):
    """2D plans (14e), the fused route (14b); the ported trainers none."""
    classes = train.TRAINERS
    plans = _plans_with_batch(1)
    for name in ("MultiTalent_trainer_ddp", "nnUNetTrainerV2", "MultiTalent_trainer_resenc_ddp",
                 "TrainerV2CascadeFullRes", "nnUNetTrainerV2_warmupsegheads",
                 "nnUNetTrainerV2_5epochs_dummyLoad"):
        assert space_plan_refusal(classes[name], plans, 0) is None, name
    two_d = _plans_with_batch(1, patch=(32, 32))
    assert "item 14e" in space_plan_refusal(classes["nnUNetTrainerV2"], two_d, 0)
    monkeypatch.setenv("MTTPU_FUSED_TRAIN", "1")
    assert "item 14b" in space_plan_refusal(classes["MultiTalent_trainer_ddp"], plans, 0)
