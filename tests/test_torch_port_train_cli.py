"""The port's training CLI on the CPU, end to end: a synthetic preprocessed
MultiTalent task (two source datasets, valid regions stamped, export
properties and gt_segmentations/) -> `cli/train.py` with
MultiTalent_trainer_ddp -> the reference-layout model folder and its
validation -> `cli/predict_multitalent.py` on a CT volume. Then a resumed run
(-c), validation alone (-val, --valbest, --val_folder), fine-tuning with
nnUNetTrainerV2_warmupsegheads from -pretrained_weights (a `.model` or a JAX
`.ckpt`, with --npz or --disable_postprocessing_on_folds), the MedNeXt
trainers' names, and the options the port refuses rather than skips.
"""
import os
import pickle
from pathlib import Path

import numpy as np
import pytest
import torch

from multitalent_tpu import paths
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference.model_restore import (save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io import Geometry, read_nifti, save_plans, write_nifti
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.models.mednext import MedNeXt
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainerMedNeXt
from multitalent_tpu_torch.training.trainers import init_weights_he
from multitalent_tpu_torch.training.warmup import TrainerV2WarmupSegHeads

from test_torch_port_predict import SHAPE, _phantom, _tiny_plans
from test_torch_port_validation import stamp_export_geometry
from test_training import make_preprocessed

TASK = "Task100_MultiTalent"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for this module's CLI runs: they are many small
    ops, which the suite's parallel workers slow down many times over when
    each runs as many threads as the host has cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def task(tmp_path, monkeypatch):
    pre, results = tmp_path / "pre", tmp_path / "results"
    monkeypatch.setenv("nnUNet_preprocessed", str(pre))
    monkeypatch.setenv("RESULTS_FOLDER", str(results))
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "1")
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("MTTPU_VAL_ITERS", "1")
    ddir = pre / TASK
    # one patch a case: a validation case is 1 tile x 8 mirror combinations
    make_preprocessed(ddir, n_cases=2, prefix="003", shape=(16, 32, 32),
                      extra_props={"valid_regions": ("03_liver", "03_cancer"),
                                   "valid_labels": [1, 2]})
    make_preprocessed(ddir, n_cases=2, prefix="009", shape=(16, 32, 32),
                      extra_props={"valid_regions": ("09_spleen",), "valid_labels": [8]})
    plans = _tiny_plans()
    assert plans.data_identifier == "mtt_data"  # the folder make_preprocessed writes
    save_plans(plans, ddir / f"{paths.default_plans_identifier}_plans_3D.pkl")
    stamp_export_geometry(ddir)
    keys = [f"003_{i:03d}" for i in range(2)] + [f"009_{i:03d}" for i in range(2)]
    save_pickle([{"train": keys, "val": ["003_001", "009_001"]}] * 12,
                ddir / "splits_custom.pkl")
    save_pickle([{"train": keys, "val": keys[:1]}] * 5, ddir / "splits_final.pkl")
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
    assert "validation was not run" not in log
    val = fold / "validation_raw"
    assert {f.name for f in val.glob("*.nii.gz")} == {"003_001.nii.gz", "009_001.nii.gz"}
    assert len(os.listdir(val / "individual")) == len(REGIONS)
    assert {f.name for f in val.glob("summary_*.json")} == {
        "summary_Task003_Liver.json", "summary_Task009_Spleen.json"}
    assert [t["forwards"] for t in trainer.validation_timings] == [8] * 2

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


def _nifti_files(folder):
    return sorted(str(p.relative_to(folder)) for p in folder.rglob("*.nii.gz"))


def test_train_cli_val_validates_the_saved_model(task):
    """-val loads model_final_checkpoint (with --valbest model_best, here
    absent, so the final one again) and validates into --val_folder: the
    same files as the validation after training."""
    _, model = task
    args = ["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cpu"]
    trained = train.main(args)
    fold = model / "fold_0"
    for folder, extra in (("validation_again", []), ("validation_best", ["--valbest"])):
        val = train.main([*args, "-val", "--val_folder", folder, *extra])
        assert val.step == trained.step and val.all_tr_losses == trained.all_tr_losses
        names = _nifti_files(fold / folder)
        assert names == _nifti_files(fold / "validation_raw") and len(names) == 2 * 48
        for name in names:
            a, _ = read_nifti(fold / folder / name)
            b, _ = read_nifti(fold / "validation_raw" / name)
            assert np.array_equal(a, b), name


@pytest.mark.parametrize("kind,flag,head_epochs", [(".model", "--npz", 1),
                                                   (".ckpt", "--disable_postprocessing_on_folds",
                                                    10)])
def test_train_cli_fine_tunes_from_pretrained_weights(task, monkeypatch, kind, flag,
                                                     head_epochs):
    """nnUNetTrainerV2_warmupsegheads -pretrained_weights: the backbone
    starts from a MultiTalent model's weights (its `.model`, or the same
    weights written as a JAX `.ckpt`) and, in the head warm-up's first
    epoch, stays there; the heads move from their init. Then it validates
    (softmax): --npz keeps the probabilities, --disable_postprocessing_on_folds
    skips postprocessing.json. With head_warmup_epochs 1 the one epoch is the
    whole warm-up: the trainer ends in phase 2, and so does its checkpoint."""
    tmp, _ = task
    plans = _tiny_plans()
    torch.manual_seed(3)
    weights = build_unet_from_plans(plans, 0, num_classes=47).state_dict()
    save = save_model_folder if kind == ".model" else save_jax_model_folder
    save(str(tmp / "pretrained"), plans, [weights], "MultiTalent_trainer_ddp")
    path = tmp / "pretrained" / "fold_0" / f"model_final_checkpoint{kind}"
    monkeypatch.setattr(TrainerV2WarmupSegHeads, "head_warmup_epochs", head_epochs)
    t = train.main(["3d_fullres", "nnUNetTrainerV2_warmupsegheads", TASK, "0",
                    "-pretrained_weights", str(path), flag, "--device", "cpu"])
    phase = 1 if head_epochs > 1 else 2
    assert type(t).__name__ == "TrainerV2WarmupSegHeads" and t.optimizer_phase == phase
    assert t.step == 2
    final = torch.load(Path(t.output_folder) / "model_final_checkpoint.model",
                       weights_only=False)
    assert final["optimizer_phase"] == phase
    fresh = build_unet_from_plans(t.plans, 0, num_classes=t.num_classes)
    init_weights_he(fresh, torch.Generator().manual_seed(t.seed))
    init = fresh.state_dict()
    for k, v in t.network.state_dict().items():
        if k.startswith("seg_outputs."):
            assert k == "seg_outputs.0.weight" or not torch.equal(v.cpu(), init[k]), k
        else:
            assert torch.equal(v.cpu(), weights[k]), k
    fold = t.output_folder
    log = next(Path(fold).glob("training_log_*.txt")).read_text()
    assert "imported pretrained backbone weights from" in log
    val = Path(fold) / "validation_raw"
    assert (val / "003_000.nii.gz").is_file() and (val / "summary.json").is_file()
    assert (val / "003_000.npz").is_file() == (flag == "--npz")
    assert (Path(fold) / "postprocessing.json").is_file() == (flag == "--npz")


@pytest.mark.parametrize("argv,match", [
    # the task's batch of 2 over 4 ranks plans data 2 x space 2, which trains
    # (test_torch_port_space_cli.py), but not on the fused route (item 14b)
    (["-gpus", "4"], "ROADMAP queue 1, item 14"),
])
def test_train_cli_refuses_what_is_not_ported(task, argv, match, monkeypatch):
    monkeypatch.setenv("MTTPU_FUSED_TRAIN", "1")
    with pytest.raises(NotImplementedError, match=match):
        train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cpu",
                    *argv])


# (the SwinUNETR trainers train: test_torch_port_swin_cli.py)
@pytest.mark.parametrize("name", ["MultiTalentTrainerMedNeXt",
                                  "MultiTalent_meets_mednext"])
def test_unported_trainers_name_their_roadmap_item(task, name, monkeypatch):
    """The MedNeXt trainer names, refused until MedNeXt was ported (item
    10b), resolve to MultiTalentTrainerMedNeXt, which trains one step,
    validates, and writes a folder that predict_multitalent restores. Its
    width is 32 channels; 8 here keep the CPU run short (the card's smoke
    run trains the 32)."""
    tmp, _ = task
    assert train.get_default_configuration("3d_fullres", TASK, name)[-1] \
        is MultiTalentTrainerMedNeXt
    assert MultiTalentTrainerMedNeXt.mednext_channels == 32
    monkeypatch.setattr(MultiTalentTrainerMedNeXt, "mednext_channels", 8)
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "1")
    trainer = train.main(["3d_fullres", name, TASK, "0", "--device", "cpu"])
    assert isinstance(trainer, MultiTalentTrainerMedNeXt) and trainer.step == 1
    assert isinstance(trainer.network, MedNeXt) and trainer.network.n_channels == 8
    assert np.isfinite(trainer.all_tr_losses).all()
    model = Path(trainer.output_folder).parent
    assert {f.name for f in (model / "fold_0" / "validation_raw").glob("*.nii.gz")} == {
        "003_001.nii.gz", "009_001.nii.gz"}
    (tmp / "in").mkdir()
    write_nifti(tmp / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    predict_main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-m", str(model), "-f", "0",
                  "--device", "cpu", "--disable_tta"])
    seg, _ = read_nifti(tmp / "out" / "case.nii.gz")
    assert seg.shape == SHAPE
    assert len(os.listdir(tmp / "out" / "individual")) == len(REGIONS)
