"""The train CLI's other ways to several ranks, on the CPU (the task of
test_torch_port_train_cli.py):

- a launcher's group of one rank (torchrun --nproc_per_node=1: RANK=0,
  WORLD_SIZE=1) trains under the DDP wrapper bit-equal to a one-process run
  on the same batches (one sampler thread: the same batch order) and leaves
  the group;
- nnUNetTrainerV2_5epochs_dummyLoad trains its 5 epochs on two gloo ranks
  (`-gpus 2`) and writes no checkpoint;
- more ranks than cards are refused.
"""
import os
import pickle
from pathlib import Path

import pytest
import torch

from multitalent_tpu_torch.augment import params as aug_params
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.parallel import distributed

from test_torch_port_ddp_cli import _args, _same_folders, ranks_env  # noqa: F401 (fixture)
from test_torch_port_train_cli import TASK, one_thread, task  # noqa: F401 (fixtures)


def test_a_launched_group_of_one_trains_bit_equal_to_one_process(ranks_env, monkeypatch):
    """torchrun --nproc_per_node=1: the group and the DDP wrapper, the same
    weights and validation as the one-process run."""
    monkeypatch.setitem(aug_params.default_3D_augmentation_params, "num_threads", 1)
    results = Path(os.environ["RESULTS_FOLDER"])
    one = train.main(_args("MultiTalent_trainer_ddp"))
    monkeypatch.setenv("RESULTS_FOLDER", str(results.parent / "results_launched"))
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", str(distributed.free_port()))
    launched = train.main(_args("MultiTalent_trainer_ddp"))
    assert launched.ddp is not None and one.ddp is None
    assert not distributed.is_initialized()  # the CLI left the group it joined
    assert launched.all_tr_losses == one.all_tr_losses
    a, b = one.network.state_dict(), launched.network.state_dict()
    assert all(torch.equal(v, b[k]) for k, v in a.items())
    _same_folders(Path(one.output_folder) / "validation_raw",
                  Path(launched.output_folder) / "validation_raw")


def test_dummy_load_benchmark_trains_on_two_ranks(ranks_env):
    assert train.main(_args("nnUNetTrainerV2_5epochs_dummyLoad", "-gpus", "2")) is None
    fold = next((Path(os.environ["RESULTS_FOLDER"]) / "nnUNet" / "3d_fullres" / TASK).glob(
        "nnUNetTrainerV2_5epochs_dummyLoad__*")) / "fold_0"
    log = next(fold.glob("training_log_*.txt")).read_text()
    assert log.count("train loss :") == 5 and "local batch 1 on rank 0" in log
    assert not list(fold.glob("*.model")) and not (fold / "validation_raw").exists()
    with open(fold.parent / "plans.pkl", "rb") as f:
        assert pickle.load(f)["plans_per_stage"][0]["batch_size"] == 2


def test_more_ranks_than_cards_are_refused(ranks_env):
    with pytest.raises(RuntimeError, match="2 ranks need 2 cards"):
        train.main(["3d_fullres", "MultiTalent_trainer_ddp", TASK, "0", "--device", "cuda",
                    "-gpus", "2"])
