"""The port's training CLI on the CPU, end to end: a synthetic preprocessed
MultiTalent task (two source datasets, valid regions stamped) -> `cli/train.py`
with MultiTalent_trainer_ddp -> the reference-layout model folder ->
`cli/predict_multitalent.py` on a CT volume. Then a resumed run (-c), and the
options the port refuses rather than skips.
"""
import os
import pickle

import numpy as np
import pytest
import torch

from multitalent_tpu import paths
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.io import Geometry, read_nifti, save_plans, write_nifti

from test_torch_port_predict import SHAPE, _phantom, _tiny_plans
from test_training import make_preprocessed

TASK = "Task100_MultiTalent"


@pytest.fixture
def task(tmp_path, monkeypatch):
    pre, results = tmp_path / "pre", tmp_path / "results"
    monkeypatch.setenv("nnUNet_preprocessed", str(pre))
    monkeypatch.setenv("RESULTS_FOLDER", str(results))
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "1")
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("MTTPU_VAL_ITERS", "1")
    ddir = pre / TASK
    make_preprocessed(ddir, n_cases=2, prefix="003", shape=(20, 40, 36),
                      extra_props={"valid_regions": ("03_liver", "03_cancer"),
                                   "valid_labels": [1, 2]})
    make_preprocessed(ddir, n_cases=2, prefix="009", shape=(20, 40, 36),
                      extra_props={"valid_regions": ("09_spleen",), "valid_labels": [8]})
    plans = _tiny_plans()
    assert plans.data_identifier == "mtt_data"  # the folder make_preprocessed writes
    save_plans(plans, ddir / f"{paths.default_plans_identifier}_plans_3D.pkl")
    keys = [f"003_{i:03d}" for i in range(2)] + [f"009_{i:03d}" for i in range(2)]
    save_pickle([{"train": keys, "val": keys}] * 12, ddir / "splits_custom.pkl")
    model = (results / "nnUNet" / "3d_fullres" / TASK
             / f"MultiTalent_trainer_ddp__{paths.default_plans_identifier}")
    return tmp_path, model


def test_train_cli_writes_a_model_folder_that_predicts(task, monkeypatch):
    tmp, model = task
    trainer = train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0",
                          "--device", "cpu"])
    assert trainer.step == 2 and np.isfinite(trainer.all_tr_losses).all()
    assert len(trainer.all_tr_ce) == 1 and len(trainer.all_val_eval_metrics) == 1
    fold = model / "fold_0"
    assert (model / "plans.pkl").is_file()
    assert not (fold / "model_latest.model").exists()
    ckpt = torch.load(fold / "model_final_checkpoint.model", weights_only=False)
    assert {"state_dict", "optimizer_state_dict", "epoch", "plot_stuff",
            "best_stuff"} <= set(ckpt)
    assert ckpt["epoch"] == 1
    with open(fold / "model_final_checkpoint.model.pkl", "rb") as f:
        info = pickle.load(f)
    assert info["name"] == "MultiTalentTrainer" and info["init"][5] == 0 and info["init"][8]
    log = next(fold.glob("training_log_*.txt")).read_text()
    assert "validation was not run" in log

    (tmp / "in").mkdir()
    write_nifti(tmp / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    timings = predict_main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-m", str(model),
                            "-f", "0", "--device", "cpu", "--disable_tta"])
    assert [t["case"] for t in timings] == ["case"]
    seg, _ = read_nifti(tmp / "out" / "case.nii.gz")
    assert seg.shape == SHAPE
    assert len(os.listdir(tmp / "out" / "individual")) == len(REGIONS)

    # -c resumes from the final checkpoint and trains the next epoch
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "2")
    resumed = train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "-c",
                          "--device", "cpu"])
    assert resumed.step == 4 and len(resumed.all_tr_losses) == 2
    assert resumed.all_tr_losses[0] == trainer.all_tr_losses[0]


@pytest.mark.parametrize("argv,match", [
    (["-val"], "ROADMAP queue 1, item 7"),
    (["-pretrained_weights", "w.ckpt"], "ROADMAP queue 1, item 4"),
    (["-gpus", "2"], "ROADMAP queue 1, item 9"),
])
def test_train_cli_refuses_what_is_not_ported(task, argv, match):
    with pytest.raises(NotImplementedError, match=match):
        train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cpu",
                    *argv])


@pytest.mark.parametrize("name", ["MultiTalent_trainer_resenc_ddp",
                                  "MultiTalent_meets_mednext",
                                  "MultiTalent_trainer_SwinUNETR_ddp_adam"])
def test_unported_trainers_name_their_roadmap_item(task, name):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        train.main(["3d_fullres", name, TASK, "0", "--device", "cpu"])
