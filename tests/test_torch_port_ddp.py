"""Data-parallel MultiTalent training (parallel/distributed.py) on the CPU:
two gloo ranks of the port's MultiTalentTrainer against the JAX package's
single-device trainer with the global batch.

The ranks start from the JAX trainer's initial weights (carried by
io/from_jax.py) and take their rows of the same global host batches, split
as `distribute_batch_size` splits them: global batch 2 as [1, 1], and the
uneven global batch 3 as [2, 1]. Augmentation is off (as in
test_torch_port_train_slice.py: the two packages' random streams differ).
The JAX trainer runs on one device with the whole global batch
(`plan_batch_sharding` patched to None, as run_both does there): the
semantics the port's ranks must keep, with BCE summed and batch-Dice
statistics pooled over the global batch and one update.

Tolerances are the slice test's in fp32: the losses of every step rtol 1e-5,
every parameter after step 3 atol 2e-6 + rtol 1e-4; seg_outputs.0 (loss
weight 0: the port gives it no gradient, JAX's weight decay shrinks it) and
the conv biases (gradient 0 up to rounding) are compared apart. The ranks'
losses and parameters must be bit-equal to each other. The online
evaluation's Dice after training must equal the one-process trainer's on the
same global batch and weights (tp/fp/fn are counts), its loss to rtol 1e-6.
"""
import jax
import numpy as np
import pytest
import torch

from multitalent_tpu.data.dataset import load_dataset
from multitalent_tpu.data.loader import PatchSampler3D
from multitalent_tpu.parallel import mesh
from multitalent_tpu.parallel.mesh import distribute_batch_size as jax_distribute
from multitalent_tpu.training.multitalent import MultiTalentTrainer as JaxMultiTalentTrainer
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.parallel.mesh import plan_batch_sharding
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer

from test_torch_port_ddp_ranks import make_trainer, run_ranks
from test_torch_port_train_slice import NO_AUG, flagship_like_plans, port_plans
from test_training import make_preprocessed

SPLITS = {"even": 2, "uneven": 3}  # global batch over 2 ranks: [1, 1], [2, 1]
FLAGSHIP_PATCH = (96, 192, 192)


def _sd(params):
    return generic_unet_state_dict_from_flax(jax.device_get(params), num_pool=3)


def host_batches(tmp_path, patch_size, batch_size: int, n: int, multitalent: bool = True):
    """n global host batches of `batch_size` from two source datasets
    (valid regions stamped; the 009 cases' labels are spleen, 8)."""
    if multitalent:
        make_preprocessed(tmp_path, n_cases=3, prefix="003", shape=(14, 30, 30),
                          extra_props={"valid_regions": ("03_liver", "03_cancer"),
                                       "valid_labels": [1, 2]})
        make_preprocessed(tmp_path, n_cases=2, prefix="009", shape=(14, 30, 30),
                          extra_props={"valid_regions": ("09_spleen",), "valid_labels": [8]})
    else:
        make_preprocessed(tmp_path, n_cases=3, prefix="case", shape=(14, 30, 30))
    sampler = PatchSampler3D(load_dataset(str(tmp_path / "mtt_data_stage0")), patch_size,
                             (8, 16, 16), batch_size, oversample_foreground_percent=0.5,
                             pad_mode="constant", seed=batch_size)
    batches = [sampler.generate_train_batch() for _ in range(n)]
    for b in batches:
        for j, k in enumerate(b["keys"]):
            if k.startswith("009"):
                b["seg"][j][b["seg"][j] > 0] = 8
    return batches


def with_batch(plans, batch_size: int) -> dict:
    """The plans (as a dict) with their global batch set to `batch_size`."""
    d = plans.to_dict()
    d["plans_per_stage"][0]["batch_size"] = batch_size
    return d


def jax_reference(jt, batches) -> dict:
    """The JAX trainer's losses and weights over `batches`, from its current
    state (restored after: the step donates the state it is given)."""
    start = jax.tree_util.tree_map(np.array, jt.state)
    losses = [jt.run_iteration(iter([b])) for b in batches]
    out = {"losses": np.array(losses), "weights": _sd(jt.state.params)}
    jt.state = jax.tree_util.tree_map(jax.numpy.asarray, start)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_multitalent")
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
        for name, gbs in SPLITS.items():
            batches = host_batches(tmp, jt.basic_generator_patch_size, gbs, 4)
            ref[name] = jax_reference(jt, batches[:3])
            spec[name] = {"trainer": "MultiTalentTrainer", "plans": with_batch(plans, gbs),
                          "output_folder": str(tmp / f"port_{name}"), "aug": NO_AUG,
                          "weights": weights, "batches": batches[:3], "val_batch": batches[3]}
        ranks = run_ranks(spec, tmp)
        return {"spec": spec, "jax": ref, "ranks": ranks, "before": weights}
    finally:
        mp.undo()


def _apart(key: str) -> bool:
    return key == "seg_outputs.0.weight" or key.endswith("conv.bias")


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_two_ranks_match_the_single_device_jax_trainer(runs, split):
    r0, r1 = (r[split] for r in runs["ranks"])
    ref, before = runs["jax"][split], runs["before"]
    sizes, _ = distributed.distribute_batch_size(SPLITS[split], 2)
    assert [r0["local_batch"], r1["local_batch"]] == sizes and r0["wrapped"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    for k, v in ref["weights"].items():
        if _apart(k):
            continue
        assert not torch.equal(v, before[k]), k  # the weights moved
        np.testing.assert_allclose(r0["weights"][k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)
    # the head of weight 0 is out of the reducer: no gradient, no update
    assert torch.equal(r0["weights"]["seg_outputs.0.weight"], before["seg_outputs.0.weight"])


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_ranks_are_bit_equal(runs, split):
    r0, r1 = (r[split] for r in runs["ranks"])
    assert r0["losses"] == r1["losses"]
    assert r0["val_loss"] == r1["val_loss"] and r0["online_dice"] == r1["online_dice"]
    assert all(torch.equal(v, r1["weights"][k]) for k, v in r0["weights"].items())


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_online_evaluation_is_the_global_batch_s(runs, split, tmp_path):
    """The ranks' epoch Dice (tp/fp/fn summed over the ranks) equals one
    process's on the whole validation batch with the same weights."""
    run = dict(runs["spec"][split], weights=runs["ranks"][0][split]["weights"],
               output_folder=str(tmp_path))
    one = make_trainer(run)
    assert one.ddp is None and one.local_batch_size == one.batch_size
    val_loss = one.run_iteration(iter([run["val_batch"]]), False, True)
    one.finish_online_evaluation()
    r0 = runs["ranks"][0][split]
    assert r0["online_dice"] == one.all_val_eval_metrics[-1]
    np.testing.assert_allclose(r0["val_loss"], val_loss, rtol=1e-6)


@pytest.mark.parametrize("gbs,world", [(2, 2), (3, 2), (5, 2), (4, 3), (7, 4), (8, 8)])
def test_distribute_batch_size_matches_jax(gbs, world):
    sizes, fracs = distributed.distribute_batch_size(gbs, world)
    jsizes, jfracs = jax_distribute(gbs, world)
    assert sizes == jsizes
    for o in (0.0, 0.33, 0.5, 1.0):
        assert fracs(o) == jfracs(o)


def test_five_over_two_ranks_splits_three_and_two():
    sizes, fracs = distributed.distribute_batch_size(5, 2)
    assert sizes == [3, 2]
    # the last round(5 * 0.4) = 2 samples are foreground-forced: both on rank 1
    assert fracs(0.4) == [0.0, 1.0]
    assert distributed.rank_batch(5, 0.4, 1, 2) == (2, 1.0)


@pytest.mark.parametrize("gbs,world", [(2, 3), (1, 2), (4, 8)])
def test_a_rank_without_a_sample_is_refused(gbs, world):
    """Refused until the space axis was ported (ROADMAP item 14): a global
    batch smaller than the rank count now plans data = gcd x space at the
    flagship's patch, and every rank draws its data group's samples, all of
    the global batch over the groups; a split of the batch alone still
    refuses a shard without a sample."""
    plan = plan_batch_sharding(gbs, FLAGSHIP_PATCH, world)
    d = int(np.gcd(gbs, world))
    assert (plan.data, plan.space, plan.space_axis, plan.ranks) == (d, world // d, 2, world)
    shares = [distributed.rank_batch(gbs, 0.33, plan.coords(r)[0], plan.data)
              for r in range(world)]
    assert all(b == gbs // d for b, _ in shares)
    assert sum(b for b, _ in shares[::plan.space]) == gbs
    with pytest.raises(ValueError, match="gets no sample"):
        distributed.rank_batch(gbs, 0.33, world - 1, world)


def test_one_process_takes_no_group():
    t = MultiTalentTrainer(port_plans(flagship_like_plans()), 0, None, None, fp16=False,
                           device="cpu")
    t.initialize(False)
    assert t.process_group is None and t.ddp is None and t.world_size == 1
    assert (t.local_batch_size, t.local_oversample) == (2, 0.5)
