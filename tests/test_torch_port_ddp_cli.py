"""The train CLI on several ranks, on the CPU (`--device cpu -gpus 2`: two
gloo ranks that the CLI starts itself), end to end on the synthetic task of
test_torch_port_train_cli.py:

- training writes one folder (rank 0): checkpoint keys without `module.`,
  one log; the validation after training splits the cases over the ranks
  and writes what a one-process `-val` of the same weights writes (every
  NIfTI equal, the summaries' results equal), as does `-val -gpus 2`;
- the MultiTalent folder predicts through predict_multitalent exactly as a
  one-process folder of the same weights (`save_model_folder`) does.

(test_torch_port_ddp_launch.py: a launcher's group, the benchmarking
trainer on two ranks, the refusals.)
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference.model_restore import save_model_folder
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.utils.fileops import load_json, save_pickle

from test_torch_port_predict import _phantom, _tiny_plans
from test_torch_port_train_cli import TASK, one_thread, task  # noqa: F401 (fixtures)


@pytest.fixture
def ranks_env(task, monkeypatch):
    """The task, with one intra-op thread in every rank the CLI starts."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    return task


def _args(trainer: str, *extra: str) -> list[str]:
    return ["3d_fullres", trainer, TASK, "0", "--device", "cpu", *extra]


def _same_folders(a: Path, b: Path) -> None:
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*.nii.gz"))
    assert names and names == sorted(str(p.relative_to(b)) for p in b.rglob("*.nii.gz"))
    for name in names:
        assert np.array_equal(read_nifti(a / name)[0], read_nifti(b / name)[0]), name
    summaries = sorted(p.name for p in a.glob("summary*.json"))
    assert summaries and summaries == sorted(p.name for p in b.glob("summary*.json"))
    for name in summaries:
        assert _results(a / name) == _results(b / name), name


def _results(summary: Path) -> dict:
    """A summary's results without the predictions' paths."""
    results = load_json(summary)["results"]
    results["all"] = [{k: v for k, v in case.items() if k != "test"}
                      for case in results["all"]]
    return results


@pytest.mark.parametrize("trainer", ["MultiTalent_trainer_ddp", "nnUNetTrainerV2"])
def test_two_ranks_train_and_validate_as_one_process_would(ranks_env, trainer):
    tmp, _ = ranks_env
    ddir = Path(os.environ["nnUNet_preprocessed"]) / TASK
    keys = [f"003_{i:03d}" for i in range(2)] + [f"009_{i:03d}" for i in range(2)]
    # three validation cases for the softmax trainer: two on rank 0, one on rank 1
    save_pickle([{"train": keys, "val": keys[:3]}] * 5, ddir / "splits_final.pkl")
    assert train.main(_args(trainer, "-gpus", "2")) is None  # the ranks ran apart
    model = next((Path(os.environ["RESULTS_FOLDER"]) / "nnUNet" / "3d_fullres" / TASK).glob(
        f"{trainer}__*"))
    fold = model / "fold_0"
    ckpt = torch.load(fold / "model_final_checkpoint.model", weights_only=False)
    num_classes = 47 if trainer.startswith("MultiTalent") else 48
    fresh = build_unet_from_plans(_tiny_plans(), 0, num_classes=num_classes)
    assert list(ckpt["state_dict"]) == list(fresh.state_dict())  # no `module.`
    assert len(list(fold.glob("training_log_*.txt"))) == 1
    log = next(fold.glob("training_log_*.txt")).read_text()
    assert "data-parallel over 2 ranks (gloo)" in log

    train.main(_args(trainer, "-val", "--val_folder", "val_ranks", "-gpus", "2"))
    one = train.main(_args(trainer, "-val", "--val_folder", "val_one"))
    assert one.world_size == 1 and one.ddp is None
    _same_folders(fold / "validation_raw", fold / "val_one")
    _same_folders(fold / "val_ranks", fold / "val_one")
    if trainer.startswith("nnUNetTrainerV2"):
        assert (fold / "postprocessing.json").is_file()
        return

    # the folder predicts as a one-process folder of the same weights
    save_model_folder(str(tmp / "one_folder"), _tiny_plans(), [ckpt["state_dict"]],
                      "MultiTalent_trainer_ddp")
    (tmp / "in").mkdir()
    write_nifti(tmp / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    for folder, out in ((model, "out_ranks"), (tmp / "one_folder", "out_one")):
        predict_main(["-i", str(tmp / "in"), "-o", str(tmp / out), "-m", str(folder), "-f",
                      "0", "--device", "cpu", "--disable_tta"])
    names = sorted(str(p.relative_to(tmp / "out_one")) for p in (tmp / "out_one").rglob(
        "*.nii.gz"))
    assert len(names) == 48
    for name in names:
        assert np.array_equal(read_nifti(tmp / "out_ranks" / name)[0],
                              read_nifti(tmp / "out_one" / name)[0]), name
