"""Fine-tuning, the port's (training/warmup.py) against the JAX package's, on
the CPU.

- `load_pretrained_weights`: the same parameters transfer (every backbone
  parameter of the same shape; not the first conv of a network with another
  input count, never a head).
- `TrainerV2WarmupSegHeads` from the same weights on the same three host
  batches (augmentation off, as in test_torch_port_train_slice.py), fp32:
  in phase 1 (AdamW 3e-3 on the heads) the backbone stays bit-equal in both
  packages and the heads move alike; after the switch to SGD on everything,
  two more steps move every parameter alike. seg_outputs.0 (loss weight 0)
  is compared apart, as in the slice test: the port gives it no gradient, so
  AdamW leaves it alone, while the JAX package's zero gradient still lets
  weight decay shrink it by lr * wd a step.
  Tolerances: the losses rtol 1e-5; the heads after phase 1 atol 2e-6
  (Adam's first steps move each weight by about the LR, 3e-3, whatever its
  gradient's size, so only summation order differs); every parameter after
  phase 2 atol 2e-6 + rtol 1e-4 (the slice test's).
- the warm-up LR schedule equals the JAX package's; a phase-2 checkpoint
  resumes into phase 2; `find_lr` sweeps and restores the trainer.
"""
import jax
import numpy as np
import pytest
import torch

from multitalent_tpu.data.dataset import load_dataset
from multitalent_tpu.data.loader import PatchSampler3D
from multitalent_tpu.parallel import mesh
from multitalent_tpu.training.schedules import make_warmup_poly_schedule as jax_schedule
from multitalent_tpu.training.warmup import TrainerV2WarmupSegHeads as JaxWarmup
from multitalent_tpu.training.warmup import load_pretrained_weights as jax_load_pretrained
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.training.schedules import make_warmup_poly_schedule
from multitalent_tpu_torch.training.warmup import (TrainerV2WarmupSegHeads,
                                                   load_pretrained_weights)

from test_torch_port_train_slice import NO_AUG, flagship_like_plans, port_plans
from test_training import make_preprocessed


def _sd(params):
    return generic_unet_state_dict_from_flax(jax.device_get(params), num_pool=3)


def test_load_pretrained_weights_transfers_the_same_keys():
    import jax.numpy as jnp
    from multitalent_tpu.models.generic_unet import build_unet_from_plans as jax_build
    from multitalent_tpu.plans import Plans
    plans = flagship_like_plans()
    two = plans.to_dict()
    two["num_modalities"] = 2
    x1, x2 = jnp.zeros((1, 8, 16, 16, 1)), jnp.zeros((1, 8, 16, 16, 2))
    target = jax_build(plans, 0, num_classes=3).init(jax.random.PRNGKey(0), x1)["params"]
    pre = jax_build(Plans.from_dict(two), 0, num_classes=47).init(
        jax.random.PRNGKey(1), x2)["params"]
    merged_jax = _sd(jax_load_pretrained(target, pre))
    target_sd, pre_sd = _sd(target), _sd(pre)
    merged_port = load_pretrained_weights(target_sd, pre_sd)

    def transferred(merged):
        return {k for k, v in merged.items()
                if k in pre_sd and v.shape == pre_sd[k].shape and torch.equal(v, pre_sd[k])}

    got, want = transferred(merged_port), transferred(merged_jax)
    assert got == want
    assert "conv_blocks_context.0.blocks.0.conv.bias" in got
    assert "conv_blocks_context.0.blocks.0.conv.weight" not in got
    assert not any(k.startswith("seg_outputs") for k in got)
    assert len(got) == len(target_sd) - 1 - 3  # the first conv's weight, three heads


def test_warmup_schedule_matches_jax():
    ours = make_warmup_poly_schedule(1e-2, 100, 5, warmup_epochs=10)
    theirs = jax_schedule(1e-2, 100, 5, warmup_epochs=10)
    for step in (0, 4, 5, 49, 50, 51, 499, 1000):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6)


def _batches(tmp_path, patch_size):
    make_preprocessed(tmp_path, n_cases=3, prefix="case", shape=(14, 30, 30))
    sampler = PatchSampler3D(load_dataset(str(tmp_path / "mtt_data_stage0")), patch_size,
                             (8, 16, 16), 2, oversample_foreground_percent=0.5,
                             pad_mode="constant", seed=0)
    return [sampler.generate_train_batch() for _ in range(5)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("warmup")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    try:
        plans = flagship_like_plans()
        jt = JaxWarmup(plans, 0, str(tmp / "jax"), None, fp16=False)
        jt.initialize(True)
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        pt = TrainerV2WarmupSegHeads(port_plans(plans), 0, str(tmp / "port"), None,
                                     fp16=False, device="cpu")
        pt.initialize(True)
        pt.data_aug_params.update(NO_AUG)
        pt._build_step_functions()
        before = _sd(jt.state.params)
        pt.network.load_state_dict(before)
        batches = _batches(tmp, jt.basic_generator_patch_size)
        losses = [(jt.run_iteration(iter([b])), pt.run_iteration(iter([b])))
                  for b in batches[:3]]
        phase1 = {"jax": _sd(jt.state.params),
                  "port": {k: v.detach().clone() for k, v in pt.network.state_dict().items()}}
        jt._switch_to_phase2()
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        pt._switch_to_phase2()
        losses += [(jt.run_iteration(iter([b])), pt.run_iteration(iter([b])))
                   for b in batches[3:]]
        phase2 = {"jax": _sd(jt.state.params), "port": pt.network.state_dict()}
        return {"before": before, "phase1": phase1, "phase2": phase2,
                "losses": np.array(losses), "trainer": pt}
    finally:
        mp.undo()


def _heads(sd):
    return [k for k in sd if k.startswith("seg_outputs.") and k != "seg_outputs.0.weight"]


def test_phase1_trains_the_heads_alone_like_jax(runs):
    before, p1 = runs["before"], runs["phase1"]
    np.testing.assert_allclose(runs["losses"][:3, 1], runs["losses"][:3, 0], rtol=1e-5)
    backbone = [k for k in before if not k.startswith("seg_outputs.")]
    for name in ("jax", "port"):
        assert all(torch.equal(p1[name][k], before[k]) for k in backbone), name
    for k in _heads(before):
        assert not torch.equal(p1["port"][k], before[k]), k
        np.testing.assert_allclose(p1["port"][k].numpy(), p1["jax"][k].numpy(), atol=2e-6,
                                   err_msg=k)
    k = "seg_outputs.0.weight"
    assert torch.equal(p1["port"][k], before[k])
    np.testing.assert_allclose(p1["jax"][k].numpy(), before[k].numpy(), rtol=1e-6)


def test_phase2_trains_everything_like_jax(runs):
    pt, before, p2 = runs["trainer"], runs["before"], runs["phase2"]
    np.testing.assert_allclose(runs["losses"][3:, 1], runs["losses"][3:, 0], rtol=1e-5)
    assert pt.optimizer_phase == 2 and pt.step == 5
    assert all(p.requires_grad for p in pt.network.parameters())
    for k, v in p2["jax"].items():
        if k == "seg_outputs.0.weight" or k.endswith("conv.bias"):
            continue
        assert not torch.equal(p2["port"][k], before[k]), k
        np.testing.assert_allclose(p2["port"][k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)


def test_phase2_checkpoint_resumes_into_phase2(runs, tmp_path):
    pt = runs["trainer"]
    path = str(tmp_path / "model_latest.model")
    pt.save_checkpoint(path)
    fresh = TrainerV2WarmupSegHeads(pt.plans, 0, str(tmp_path / "out"), None, fp16=False,
                                    device="cpu")
    fresh.initialize(False)
    assert fresh.optimizer_phase == 1
    assert not any(p.requires_grad for n, p in fresh.network.named_parameters()
                   if not n.startswith("seg_outputs"))
    fresh.load_checkpoint(path, train=True)
    assert fresh.optimizer_phase == 2 and fresh.step == pt.step
    assert type(fresh.optimizer).__name__ == "SGDClipped"
    a, b = fresh.optimizer.state_dict()["state"], pt.optimizer.state_dict()["state"]
    # a momentum buffer for every parameter but seg_outputs.0, which has no gradient
    assert a.keys() == b.keys() and len(a) == len(list(pt.network.parameters())) - 1
    assert all(torch.equal(a[i]["momentum_buffer"], b[i]["momentum_buffer"]) for i in a)


def test_find_lr_sweeps_and_restores(tmp_path):
    from multitalent_tpu_torch.training.trainers import TrainerV2
    make_preprocessed(tmp_path, n_cases=3, prefix="case", shape=(14, 30, 30))
    t = TrainerV2(port_plans(flagship_like_plans()), 0, str(tmp_path / "out"), str(tmp_path),
                  fp16=False, device="cpu")
    t.initialize(True)
    try:
        weights = {k: v.clone() for k, v in t.network.state_dict().items()}
        optimizer, step = t.optimizer, t.step
        log_lrs, losses = t.find_lr(num_iters=4, init_value=1e-4, final_value=1e-2)
    finally:
        t.tr_gen.stop()
        t.val_gen.stop()
    assert len(losses) == len(log_lrs) >= 2 and np.isfinite(losses).all()
    np.testing.assert_allclose(log_lrs[:2], [-4.0, -3.5])
    assert t.optimizer is optimizer and t.step == step
    assert all(torch.equal(v, weights[k]) for k, v in t.network.state_dict().items())
