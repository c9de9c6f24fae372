"""The space axis through the trainer on four CPU ranks: the port's
MultiTalentTrainer under two plans against the JAX package's single-device
trainer with the same global batch.

- global batch 2 on 4 ranks: data 2 x space 2 (each data group one sample,
  its patch's x split 16 -> 8 a rank), the batch-Dice and BCE sums pooled
  over every rank, the norms over each space group;
- global batch 1 on 4 ranks: data 1 x space 4, x 16 -> 4 a rank; the
  bottleneck's x extent (2) does not divide over 4, so that level is
  gathered over the space group, computed whole on every rank, and the way
  up keeps each rank's slab again (mesh.Levels).

As in test_torch_port_space_train.py (and test_torch_port_ddp.py): the ranks
start from the JAX trainer's initial weights, take their data group's rows
of the same global host batches, augmentation off, fp32; the losses of
every step within rtol 1e-5 and every parameter after step 3 within atol
2e-6 + rtol 1e-4 of the JAX trainer's (seg_outputs.0 and the conv biases
apart), the ranks bit-equal within each plan.
"""
import numpy as np
import pytest
import torch

from multitalent_tpu.parallel import mesh
from multitalent_tpu.training.multitalent import MultiTalentTrainer as JaxMultiTalentTrainer

from test_torch_port_ddp import _sd, host_batches, jax_reference, with_batch
from test_torch_port_ddp_ranks import run_ranks
from test_torch_port_space_train import excess
from test_torch_port_train_slice import NO_AUG, flagship_like_plans

PLANS = {"data2_space2": 2, "space4_gathered": 1}  # name: global batch on 4 ranks


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space_hybrid")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    try:
        plans = flagship_like_plans()
        jt = JaxMultiTalentTrainer(plans, 0, str(tmp / "jax"), None, fp16=False)
        jt.initialize(True)
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        weights = _sd(jt.state.params)
        spec, ref = {}, {}
        for name, gbs in PLANS.items():
            batches = host_batches(tmp, jt.basic_generator_patch_size, gbs, 3)
            ref[name] = jax_reference(jt, batches)
            spec[name] = {"trainer": "MultiTalentTrainer", "plans": with_batch(plans, gbs),
                          "output_folder": str(tmp / name), "aug": NO_AUG,
                          "weights": weights, "batches": batches}
        return {"jax": ref, "before": weights, "ranks": run_ranks(spec, tmp, world=4)}
    finally:
        mp.undo()


@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_matches_the_single_device_jax_trainer(runs, name):
    got = [r[name] for r in runs["ranks"]]
    ref, before = runs["jax"][name], runs["before"]
    space = 4 // PLANS[name]
    assert [g["space"][:3] for g in got] == [(r % space, space, 2) for r in range(4)]
    assert all(g["local_batch"] == 1 and g["wrapped"] for g in got)
    np.testing.assert_allclose(got[0]["losses"], ref["losses"], rtol=1e-5)
    assert excess(got[0]["weights"], ref["weights"]) <= 0
    assert torch.equal(got[0]["weights"]["seg_outputs.0.weight"],
                       before["seg_outputs.0.weight"])
    for g in got[1:]:
        assert g["losses"] == got[0]["losses"]
        assert all(torch.equal(v, g["weights"][k]) for k, v in got[0]["weights"].items())


def test_only_the_level_that_does_not_divide_is_gathered(runs):
    for r in runs["ranks"]:
        assert "gather" not in r["data2_space2"]["space"][3]
        assert r["space4_gathered"]["space"][3]["gather"] > 0
