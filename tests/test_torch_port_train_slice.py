"""The training slice as a whole: the port's MultiTalentTrainer against the JAX
package's, on the CPU, from the same weights (carried by io/from_jax.py), on
the same three host batches, in fp32 and in bf16.

Both trainers get every augmentation probability at 0 and mirroring off (the
two packages' random streams differ): the center crop of the enlarged patch,
seg -1 -> 0 and the deep-supervision targets still run. The network is the
flagship topology at base 4 with three pools, so the DS weights are
(2/3, 1/3, 0) and both kernel routes (A and the dual B) are on the path.

Two parameters are compared apart:
- the lowest-resolution head (seg_outputs.0) has loss weight 0. The port,
  like the reference, gives it no gradient and SGD leaves it alone; JAX gives
  it a zero gradient and weight decay still shrinks it;
- the conv biases feed an instance norm, which cancels them: their gradient
  is 0 in exact arithmetic and bf16 rounding noise in bf16, different noise
  in each package (the port sums it in fp32).

Tolerances. fp32: the losses at every step rtol 1e-5, every other parameter
after step 3 atol 2e-6 + rtol 1e-4 (different summation orders, carried
forward by momentum 0.99). bf16: both packages round every activation, at
points that differ in one place (the port adds the conv bias in fp32), so
the port must be about as close to JAX's bf16 run as that run is to JAX's
own fp32 run: the losses to rtol 1e-3, and over the parameter updates of
three steps |d_port - d_jax| <= 1.5 |d_jax_bf16 - d_jax_fp32| in norm
(measured 0.89x), per tensor within 50% of the tensor's update (measured
at most 35%); the losses measured 8.8e-5 apart.
"""
import jax
import numpy as np
import pytest
import torch

from multitalent_tpu.data.dataset import load_dataset
from multitalent_tpu.data.loader import PatchSampler3D
from multitalent_tpu.parallel import mesh
from multitalent_tpu.plans import Plans
from multitalent_tpu.training.multitalent import MultiTalentTrainer as JaxMultiTalentTrainer
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.plans import Plans as PortPlans
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer

from test_training import make_preprocessed, tiny_plans

NO_AUG = {"p_rot": 0.0, "p_scale": 0.0, "p_gaussian_noise": 0.0, "p_gaussian_blur": 0.0,
          "p_brightness_mult": 0.0, "p_contrast": 0.0, "p_lowres": 0.0,
          "p_gamma_invert": 0.0, "p_gamma": 0.0, "do_mirror": False}


def flagship_like_plans() -> Plans:
    d = tiny_plans().to_dict()
    d["plans_per_stage"][0].update(
        patch_size=(8, 16, 16), num_pool_per_axis=[2, 3, 3],
        pool_op_kernel_sizes=[[1, 2, 2], [2, 2, 2], [2, 2, 2]],
        conv_kernel_sizes=[[3, 3, 3]] * 4)
    return Plans.from_dict(d)


def port_plans(plans: Plans) -> PortPlans:
    """The JAX package's plans as the port's own Plans (the port imports
    nothing of the JAX package)."""
    return PortPlans.from_dict(plans.to_dict())


def three_batches(tmp_path, patch_size):
    """Three host batches of two source datasets (valid_regions stamped)."""
    make_preprocessed(tmp_path, n_cases=3, prefix="003", shape=(14, 30, 30),
                      extra_props={"valid_regions": ("03_liver", "03_cancer"),
                                   "valid_labels": [1, 2]})
    make_preprocessed(tmp_path, n_cases=2, prefix="009", shape=(14, 30, 30),
                      extra_props={"valid_regions": ("09_spleen",), "valid_labels": [8]})
    sampler = PatchSampler3D(load_dataset(str(tmp_path / "mtt_data_stage0")), patch_size,
                             (8, 16, 16), 2, oversample_foreground_percent=0.5,
                             pad_mode="constant", seed=0)
    batches = [sampler.generate_train_batch() for _ in range(3)]
    # labels of the 009 cases are spleen (8), as the region mask says
    for b in batches:
        for j, k in enumerate(b["keys"]):
            if k.startswith("009"):
                b["seg"][j][b["seg"][j] > 0] = 8
    return batches


def run_both(tmp_path, mp, fp16: bool):
    # one device for the JAX trainer too: on the suite's 8 virtual CPU devices
    # it would shard the batch and the patch across a mesh
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    plans = flagship_like_plans()
    jt = JaxMultiTalentTrainer(plans, 0, str(tmp_path / "jax"), None, fp16=fp16)
    jt.initialize(True)
    jt.data_aug_params.update(NO_AUG)
    jt._build_step_functions()
    pt = MultiTalentTrainer(port_plans(plans), 0, str(tmp_path / "port"), None, fp16=fp16,
                            device="cpu")
    pt.initialize(True)
    pt.data_aug_params.update(NO_AUG)
    pt._build_step_functions()
    params = jax.device_get(jt.state.params)
    pt.network.load_state_dict(generic_unet_state_dict_from_flax(params, num_pool=3))
    batches = three_batches(tmp_path, jt.basic_generator_patch_size)
    losses = [(jt.run_iteration(iter([b])), pt.run_iteration(iter([b]))) for b in batches]
    ref = generic_unet_state_dict_from_flax(jax.device_get(jt.state.params), num_pool=3)
    before = generic_unet_state_dict_from_flax(params, num_pool=3)
    return {"losses": np.array(losses), "jax": ref, "before": before,
            "port": pt.network.state_dict(), "trainer": pt}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    try:
        return {fp16: run_both(tmp_path_factory.mktemp(f"slice_{fp16}"), mp, fp16)
                for fp16 in (False, True)}
    finally:
        mp.undo()


def _apart(key: str) -> bool:
    return key == "seg_outputs.0.weight" or key.endswith("conv.bias")


def test_multitalent_trainer_matches_jax_fp32(runs):
    r = runs[False]
    np.testing.assert_allclose(r["losses"][:, 1], r["losses"][:, 0], rtol=1e-5)
    pt = r["trainer"]
    assert pt.step == 3 and pt.network.kernel_launches_per_forward() == {
        "conv3d_same": 5, "conv3d_same_dual": 3}
    for k, v in r["jax"].items():
        if _apart(k):
            continue
        assert not torch.equal(v, r["before"][k]), k  # the weights moved
        np.testing.assert_allclose(r["port"][k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)
    assert torch.equal(r["port"]["seg_outputs.0.weight"], r["before"]["seg_outputs.0.weight"])


def test_multitalent_trainer_matches_jax_bf16(runs):
    r, r32 = runs[True], runs[False]
    np.testing.assert_allclose(r["losses"][:, 1], r["losses"][:, 0], rtol=1e-3)
    keys = [k for k in r["jax"] if not _apart(k)]
    d_port = torch.cat([(r["port"][k] - r["before"][k]).flatten() for k in keys])
    d_jax = torch.cat([(r["jax"][k] - r["before"][k]).flatten() for k in keys])
    d_jax32 = torch.cat([(r32["jax"][k] - r32["before"][k]).flatten() for k in keys])
    assert (d_port - d_jax).norm() <= 1.5 * (d_jax - d_jax32).norm()
    for k in keys:
        dp, dj = r["port"][k] - r["before"][k], r["jax"][k] - r["before"][k]
        assert (dp - dj).norm() <= 0.5 * dj.norm(), k
