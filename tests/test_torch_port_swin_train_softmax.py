"""TrainerV2SwinUNETR (nnUNetTrainerV2_swinunetr_adam_ddp: DC+CE over a
softmax SwinUNETR, AMSGrad Adam at 1e-3) against the JAX package's on the
CPU, as test_torch_port_swin_train.py holds the MultiTalent SwinUNETR
trainer (its helpers, bounds and their reasons), here on the plans' 2
classes + background; then the port's trained weights as a JAX-layout
folder, restored by the JAX package.
"""
import jax
import pytest
import torch

from multitalent_tpu.inference.model_restore import (
    load_model_and_checkpoint_files as jax_load_model)
from multitalent_tpu.training import trainers as jax_trainers
from multitalent_tpu.training.variants import TrainerV2SwinUNETR as JaxTrainerV2SwinUNETR
from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                           save_jax_model_folder)
from multitalent_tpu_torch.io.from_jax import swin_unetr_state_dict_from_flax
from multitalent_tpu_torch.training.variants import TrainerV2SwinUNETR

from test_torch_port_swin_train import check_pair, port_init_state, trainer_pair


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port's TrainerV2SwinUNETR over three Adam steps, in
    fp32."""
    return trainer_pair(tmp_path_factory, JaxTrainerV2SwinUNETR, TrainerV2SwinUNETR, 2, False)


def test_softmax_swin_trainer_matches_jax_over_three_adam_steps(trainers):
    check_pair(trainers, 1e-3, 3)


def test_port_swin_folder_restores_in_the_jax_package(trainers, tmp_path, monkeypatch):
    """save_jax_model_folder of the port's trained SwinUNETR restores in the
    JAX package with the same params, and in the port with the same state
    dict."""
    monkeypatch.setattr(jax_trainers.TrainerV2, "_init_state", port_init_state)
    pt = trainers["pt"]
    sd = {k: v.clone() for k, v in pt.network.state_dict().items()}
    save_jax_model_folder(str(tmp_path / "w"), pt.plans, [sd], "TrainerV2SwinUNETR",
                          trainer_bases=["TrainerV2"], fp16=False)
    trainer, params = jax_load_model(str(tmp_path / "w"))
    assert type(trainer).__name__ == "TrainerV2SwinUNETR"
    back = swin_unetr_state_dict_from_flax(jax.device_get(params[0]))
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    restored = load_model_and_checkpoint_files(str(tmp_path / "w"), None, device="cpu")
    assert restored.inference_nonlin == "softmax" and restored.num_classes == 3
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)
