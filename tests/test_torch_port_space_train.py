"""The space axis through the trainer on the CPU: two gloo ranks of the
port's MultiTalentTrainer at a global batch of 1 (data 1 x space 2, the
patch's x split 16 -> 8 a rank) against the JAX package's single-device
trainer with that batch, and the control that breaks them.

As in test_torch_port_ddp.py: the ranks start from the JAX trainer's initial
weights, every rank of the space group is handed its data group's rows of
the same global host batches (the group's first rank's are broadcast and
used), augmentation is off, and the JAX trainer runs on one device
(`plan_batch_sharding` patched to None): the semantics the ranks must keep,
not JAX's own hybrid plan, which drifts from it. Tolerances are
test_torch_port_ddp.py's in fp32: the losses of every step rtol 1e-5,
every parameter after step 3 atol 2e-6 + rtol 1e-4, seg_outputs.0 (loss
weight 0) and the conv biases (gradient 0 up to rounding) apart. The
ranks' losses and weights must be bit-equal to each other; the online
evaluation after training equals one process's on the same weights, its
loss to rtol 1e-5.

The control normalises each slab with its own statistics (the norms' sums
not pooled over the space group): its updates must break the parameter
bound by far.
"""
import numpy as np
import pytest
import torch

from multitalent_tpu.parallel import mesh
from multitalent_tpu.training.multitalent import MultiTalentTrainer as JaxMultiTalentTrainer

from test_torch_port_ddp import _apart, _sd, host_batches, jax_reference, with_batch
from test_torch_port_ddp_ranks import make_trainer, run_ranks
from test_torch_port_train_slice import NO_AUG, flagship_like_plans

ATOL, RTOL = 2e-6, 1e-4


def excess(weights: dict, ref: dict) -> float:
    """The largest |w - ref| - (ATOL + RTOL |ref|) over the compared
    parameters: <= 0 within the bound."""
    return max(float((weights[k] - v).abs().sub(ATOL + RTOL * v.abs()).max())
               for k, v in ref.items() if not _apart(k))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("space_train")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    try:
        plans = flagship_like_plans()
        jt = JaxMultiTalentTrainer(plans, 0, str(tmp / "jax"), None, fp16=False)
        jt.initialize(True)
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        weights = _sd(jt.state.params)
        batches = host_batches(tmp, jt.basic_generator_patch_size, 1, 4)
        ref = jax_reference(jt, batches[:3])
        base = {"trainer": "MultiTalentTrainer", "plans": with_batch(plans, 1), "aug": NO_AUG,
                "weights": weights, "batches": batches[:3]}
        spec = {"space": dict(base, output_folder=str(tmp / "space"), val_batch=batches[3]),
                "control": dict(base, output_folder=str(tmp / "control"), slab_norms=True)}
        return {"spec": spec, "jax": ref, "before": weights, "ranks": run_ranks(spec, tmp)}
    finally:
        mp.undo()


def test_space_plan_matches_the_single_device_jax_trainer(runs):
    r0, r1 = (r["space"] for r in runs["ranks"])
    ref, before = runs["jax"], runs["before"]
    assert [r0["space"][:3], r1["space"][:3]] == [(0, 2, 2), (1, 2, 2)]
    assert (r0["local_batch"], r1["local_batch"]) == (1, 1) and r0["wrapped"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    for k, v in ref["weights"].items():
        if not _apart(k):
            assert not torch.equal(v, before[k]), k  # the weights moved
    assert excess(r0["weights"], ref["weights"]) <= 0
    assert torch.equal(r0["weights"]["seg_outputs.0.weight"], before["seg_outputs.0.weight"])


def test_ranks_are_bit_equal(runs):
    r0, r1 = (r["space"] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    assert r0["val_loss"] == r1["val_loss"] and r0["online_dice"] == r1["online_dice"]
    assert all(torch.equal(v, r1["weights"][k]) for k, v in r0["weights"].items())


def test_the_ranks_exchanged_halos_and_pooled_statistics(runs):
    """Each rank sent halo planes and norm statistics; no level gathered
    (16 -> 8 -> 4 -> 2 along x all split over 2)."""
    for r in runs["ranks"]:
        sent = r["space"]["space"][3]
        assert sent["halo"] > 0 and sent["stats"] > 0 and "gather" not in sent


def test_online_evaluation_is_the_whole_sample_s(runs, tmp_path):
    run = dict(runs["spec"]["space"], weights=runs["ranks"][0]["space"]["weights"],
               output_folder=str(tmp_path))
    one = make_trainer(run)
    assert one.space is None and one.local_batch_size == 1
    val_loss = one.run_iteration(iter([run["val_batch"]]), False, True)
    one.finish_online_evaluation()
    r0 = runs["ranks"][0]["space"]
    assert r0["online_dice"] == one.all_val_eval_metrics[-1]
    np.testing.assert_allclose(r0["val_loss"], val_loss, rtol=1e-5)


def test_slab_statistics_break_the_bound(runs):
    """The control: each slab normalised with its own statistics moves the
    weights far outside the bound (by more than 100 times its atol)."""
    control = runs["ranks"][0]["control"]
    assert excess(control["weights"], runs["jax"]["weights"]) > 100 * ATOL
