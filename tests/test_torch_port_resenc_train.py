"""The residual-encoder UNet's trainers, model folders and entry points on the
CPU, against the JAX package's where it has them.

- MultiTalentTrainerResenc against the JAX package's, from the same weights
  (the port's He init, carried into the JAX trainer's init by
  io/torch_convert.convert_resenc_state_dict: flax's own init of this net
  costs XLA:CPU a long compile) on the same three host batches with the
  47-region masked loss, in fp32, every augmentation off as in
  test_torch_port_train_slice.py: the losses at rtol 1e-5 and every
  parameter after step 3 at atol 2e-6 + rtol 1e-4, as that test holds the
  GenericUNet. The lowest-resolution head has loss weight 0: the port gives
  it no gradient and leaves it alone, JAX's weight decay shrinks it.
- JAX-layout folders both ways: the JAX trainer's `.ckpt` restores in the
  port with the JAX logits, and the port's save_jax_model_folder restores in
  the JAX package with equal params (biases included).
- The head warm-up's predicate over the resenc's head names.

(The entry points run in test_torch_port_resenc.py.)

The network: base 8, pools ((1,1,1), (2,2,2), (2,2,2), (1,2,2)), encoder
blocks (1, 2, 3, 2), decoder blocks (1, 1, 1), patch (8, 16, 16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.inference.model_restore import (
    load_model_and_checkpoint_files as jax_load_model)
from multitalent_tpu.models.residual_unet import ResidualEncoderUNet as JaxResencUNet
from multitalent_tpu.parallel import mesh
from multitalent_tpu.plans import Plans
from multitalent_tpu.training.multitalent import (
    MultiTalentTrainerResenc as JaxMultiTalentTrainerResenc)
from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                           save_jax_model_folder)
from multitalent_tpu_torch.io.from_jax import resenc_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_resenc_state_dict
from multitalent_tpu_torch.models.residual_unet import ResidualEncoderUNet
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainerResenc
from multitalent_tpu_torch.training.trainers import init_weights_he
from multitalent_tpu_torch.training.warmup import (TrainerV2WarmupSegHeadsResenc,
                                                   is_seg_head_param,
                                                   load_pretrained_weights)

from test_torch_port_train_slice import NO_AUG, port_plans, three_batches
from test_training import tiny_plans

NBE, NBD = (1, 2, 3, 2), (1, 1, 1)
RESENC_STAGE = dict(patch_size=[8, 16, 16], num_pool_per_axis=[2, 3, 3],
                    pool_op_kernel_sizes=[[1, 1, 1], [2, 2, 2], [2, 2, 2], [1, 2, 2]],
                    conv_kernel_sizes=[[3, 3, 3]] * 4, num_blocks_encoder=NBE,
                    num_blocks_decoder=NBD)
LOWEST_HEAD = "decoder.deep_supervision_outputs.0."


def resenc_plans() -> Plans:
    d = tiny_plans().to_dict()
    d["base_num_features"] = 8
    d["plans_per_stage"][0].update(RESENC_STAGE)
    return Plans.from_dict(d)


def port_he_init(self, rng, *args, **kwargs):
    """In place of the JAX ResidualEncoderUNet's flax init: the port's He init
    of the same network (seed 0), as the JAX param tree."""
    net = ResidualEncoderUNet(self.input_channels, self.base_num_features, self.num_classes,
                              self.pool_op_kernel_sizes, self.conv_kernel_sizes,
                              self.num_blocks_encoder, self.num_blocks_decoder,
                              dtype=torch.float32)
    init_weights_he(net, torch.Generator().manual_seed(0))
    return {"params": convert_resenc_state_dict(net.state_dict(), self.num_blocks_encoder,
                                                self.num_blocks_decoder)}


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port's MultiTalentTrainerResenc after three SGD steps
    on the same batches from the same weights, in fp32."""
    tmp = tmp_path_factory.mktemp("resenc_slice")
    mp = pytest.MonkeyPatch()
    # one device for the JAX trainer, as test_torch_port_train_slice.py
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    mp.setattr(JaxResencUNet, "init", port_he_init)
    try:
        plans = resenc_plans()
        jt = JaxMultiTalentTrainerResenc(plans, 0, str(tmp / "jax"), None, fp16=False)
        jt.initialize(True)
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        pt = MultiTalentTrainerResenc(port_plans(plans), 0, str(tmp / "port"), None,
                                      fp16=False, device="cpu")
        pt.initialize(True)
        pt.data_aug_params.update(NO_AUG)
        pt._build_step_functions()
        params = jax.device_get(jt.state.params)
        pt.network.load_state_dict(resenc_state_dict_from_flax(params, NBE, NBD))
        batches = three_batches(tmp, jt.basic_generator_patch_size)
        losses = [(jt.run_iteration(iter([b])), pt.run_iteration(iter([b]))) for b in batches]
    finally:
        mp.undo()
    return {"jt": jt, "pt": pt, "losses": np.array(losses), "tmp": tmp,
            "before": resenc_state_dict_from_flax(params, NBE, NBD),
            "jax": resenc_state_dict_from_flax(jax.device_get(jt.state.params), NBE, NBD)}


def test_multitalent_resenc_trainer_matches_jax(trainers):
    r = trainers
    np.testing.assert_allclose(r["losses"][:, 1], r["losses"][:, 0], rtol=1e-5)
    pt, port = r["pt"], r["pt"].network.state_dict()
    assert pt.step == 3 and isinstance(pt.network, ResidualEncoderUNet)
    assert len(pt.deep_supervision_scales) == len(pt.ds_loss_weights) == 3
    assert pt.ds_loss_weights[-1] == 0
    for k, v in r["jax"].items():
        if k.startswith(LOWEST_HEAD):
            assert torch.equal(port[k], r["before"][k]), k
            continue
        assert not torch.equal(v, r["before"][k]), k  # the weights moved
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)


def test_jax_trainer_checkpoint_restores_in_the_port(trainers):
    """The JAX trainer's `.ckpt` + sidecar (a pickled JAX Plans in it) as a
    model folder: the port picks the resenc by the flax tree's keys and its
    logits are the JAX network's."""
    jt, tmp = trainers["jt"], trainers["tmp"]
    jt.save_checkpoint(str(tmp / "jax" / "fold_0" / "model_final_checkpoint.ckpt"))
    restored = load_model_and_checkpoint_files(str(tmp / "jax"), [0], device="cpu")
    net = restored.networks[0]
    assert isinstance(net, ResidualEncoderUNet) and restored.inference_nonlin == "sigmoid"
    assert restored.num_classes == 47
    x = np.random.RandomState(5).randn(1, 8, 16, 16, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jt.network.apply(
        {"params": p}, v, deep_supervision=False))(jt.state.params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=1e-4, rtol=1e-3)


def test_port_jax_folder_restores_in_the_jax_package(trainers, tmp_path, monkeypatch):
    """save_jax_model_folder of the port's trained resenc (its biases moved
    off zero) restores in the JAX package with the same params, and in the
    port with the same state dict."""
    monkeypatch.setattr(JaxResencUNet, "init", port_he_init)
    pt = trainers["pt"]
    sd = {k: v.clone() for k, v in pt.network.state_dict().items()}
    assert sd["decoder.deep_supervision_outputs.2.bias"].any()
    save_jax_model_folder(str(tmp_path / "w"), pt.plans, [sd], "MultiTalentTrainerResenc",
                          trainer_bases=["MultiTalentTrainer", "TrainerV2"], fp16=False)
    trainer, params = jax_load_model(str(tmp_path / "w"))
    assert type(trainer).__name__ == "MultiTalentTrainerResenc"
    back = resenc_state_dict_from_flax(jax.device_get(params[0]), NBE, NBD)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    restored = load_model_and_checkpoint_files(str(tmp_path / "w"), None, device="cpu")
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in sd)


def test_seg_head_predicate_knows_both_networks_heads():
    """Phase 1 of the head warm-up over the resenc: only the heads train;
    load_pretrained_weights transfers the backbone and no head."""
    assert is_seg_head_param("seg_outputs.0.weight")
    assert is_seg_head_param("module.decoder.deep_supervision_outputs.1.bias")
    assert is_seg_head_param("decoder.segmentation_output.weight")
    assert not is_seg_head_param("decoder.stages.0.convs.0.conv.weight")
    trainer = TrainerV2WarmupSegHeadsResenc(port_plans(resenc_plans()), 0, None, None,
                                            device="cpu")
    trainer.initialize(training=False)
    grads = {k for k, p in trainer.network.named_parameters() if p.requires_grad}
    assert grads == {k for k in trainer.network.state_dict()
                     if k.startswith("decoder.deep_supervision_outputs.")}
    own = trainer.network.state_dict()
    pretrained = {k: v + 1 for k, v in own.items()}
    merged = load_pretrained_weights(own, pretrained)
    for k, v in merged.items():
        assert torch.equal(v, own[k] if k in grads else pretrained[k]), k
