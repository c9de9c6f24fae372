"""Data-parallel nnU-Net training on the CPU: two gloo ranks of the port's
TrainerV2 (softmax DC+CE) and of its head warm-up trainer against the JAX
package's single-device trainers with the global batch, and the
benchmarking trainers (nnUNetTrainerV2_2epochs, _5epochs,
_5epochs_dummyLoad) against the JAX package's.

As in test_torch_port_ddp.py: the ranks start from the JAX trainer's initial
weights and take their rows of the same global host batches (global batch 2
as [1, 1], 3 as [2, 1]), augmentation off, the JAX trainer on one device
(`plan_batch_sharding` patched to None). The DC+CE loss of the global batch:
CE averaged over every voxel of it, Dice with statistics pooled over it
(batch Dice) or averaged over all its samples (without). Tolerances are the
slice test's (fp32): losses rtol 1e-5, parameters after the last step atol
2e-6 + rtol 1e-4, seg_outputs.0 and the conv biases apart. The warm-up is
held as in test_torch_port_warmup.py: in phase 1 the backbone stays
bit-equal and the heads move as JAX's (atol 2e-6); after the switch (a new
DDP wrapper over every parameter) two more steps move everything as JAX's.

With batch Dice the JAX trainer's own fp32 rounding exceeds that parameter
tolerance: on the first stage's norm scales and shifts its three-step update
sits up to 4.5e-6 from an fp64 run of the same steps (the port's one-process
fp32 run: 5e-8). So each TrainerV2 parameter is held to JAX within the
slice tolerance plus that element's distance between the JAX run and an fp64
run of the port's one-process trainer, a distance itself bounded at
JAX_ROUNDING (1e-5; a semantic fault of the port's loss would break it); and
the ranks to the port's one-process fp32 run on the whole global batch
within atol 1e-7 + rtol 1e-5 (summation order only).
"""
import numpy as np
import pytest
import torch

from multitalent_tpu.parallel import mesh
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu.training.trainers import TrainerV2_2epochs as JaxTrainerV2_2epochs
from multitalent_tpu.training.trainers import TrainerV2_dummyLoad as JaxDummyLoad
from multitalent_tpu.training.warmup import TrainerV2WarmupSegHeads as JaxWarmup
from multitalent_tpu_torch.cli.train import TRAINERS
from multitalent_tpu_torch.training.trainers import (TrainerV2_2epochs, TrainerV2_5epochs,
                                                     TrainerV2_dummyLoad)

from test_torch_port_ddp import _apart, _sd, host_batches, jax_reference, with_batch
from test_torch_port_ddp_ranks import make_trainer, run_ranks, snapshot
from test_torch_port_train_slice import NO_AUG, flagship_like_plans, port_plans

# (batch dice, global batch) of the TrainerV2 runs
V2_RUNS = {"batch_dice_even": (True, 2), "batch_dice_uneven": (True, 3),
           "sample_dice_uneven": (False, 3)}
SWITCH_AT = 3  # the warm-up's phase-2 switch before this batch
JAX_ROUNDING = 1e-5  # bound on the JAX fp32 run's distance from an fp64 run


def one_process(run: dict, fp64: bool = False) -> dict:
    """The port's trainer in one process (no group) over the run's whole
    global batches; in fp64 when asked (every activation, loss and update)."""
    t = make_trainer(run)
    with pytest.MonkeyPatch.context() as m:
        if fp64:
            t.network.double()
            t.network.dtype = torch.float64
            m.setattr(torch.Tensor, "float", torch.Tensor.double)
        for batch in run["batches"]:
            t.run_iteration(iter([batch]))
    return snapshot(t)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp_trainers")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    try:
        plans = flagship_like_plans()
        spec, ref, jax_trainers = {}, {}, {}
        for name, (batch_dice, gbs) in V2_RUNS.items():
            jt = jax_trainers.get(batch_dice)
            if jt is None:
                jt = jax_trainers[batch_dice] = JaxTrainerV2(
                    plans, 0, str(tmp / f"jax_{batch_dice}"), None, batch_dice=batch_dice,
                    fp16=False)
                jt.initialize(True)
                jt.data_aug_params.update(NO_AUG)
                jt._build_step_functions()
            weights = _sd(jt.state.params)
            batches = host_batches(tmp, jt.basic_generator_patch_size, gbs, 3,
                                   multitalent=False)
            ref[name] = dict(jax_reference(jt, batches), before=weights)
            spec[name] = {"trainer": "TrainerV2", "plans": with_batch(plans, gbs),
                          "batch_dice": batch_dice, "output_folder": str(tmp / f"port_{name}"),
                          "aug": NO_AUG, "weights": weights, "batches": batches}
            ref[name]["one"] = one_process(spec[name])
            ref[name]["fp64"] = one_process(spec[name], fp64=True)

        jw = JaxWarmup(plans, 0, str(tmp / "jax_warmup"), None, fp16=False)
        jw.initialize(True)
        jw.data_aug_params.update(NO_AUG)
        jw._build_step_functions()
        weights = _sd(jw.state.params)
        batches = host_batches(tmp, jw.basic_generator_patch_size, 2, 5, multitalent=False)
        losses = [jw.run_iteration(iter([b])) for b in batches[:SWITCH_AT]]
        phase1 = _sd(jw.state.params)
        jw._switch_to_phase2()
        jw.data_aug_params.update(NO_AUG)
        jw._build_step_functions()
        losses += [jw.run_iteration(iter([b])) for b in batches[SWITCH_AT:]]
        ref["warmup"] = {"losses": np.array(losses), "phase1": phase1,
                         "weights": _sd(jw.state.params), "before": weights}
        spec["warmup"] = {"trainer": "TrainerV2WarmupSegHeads", "plans": plans.to_dict(),
                          "output_folder": str(tmp / "port_warmup"), "aug": NO_AUG,
                          "weights": weights, "batches": batches, "switch_at": SWITCH_AT}
        return {"jax": ref, "ranks": run_ranks(spec, tmp)}
    finally:
        mp.undo()


def _close(port: dict, ref: dict, before: dict) -> None:
    for k, v in ref.items():
        if _apart(k):
            continue
        assert not torch.equal(v, before[k]), k  # the weights moved
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(V2_RUNS))
def test_trainer_v2_on_two_ranks_matches_the_single_device_jax_trainer(runs, name):
    r0, r1 = (r[name] for r in runs["ranks"])
    ref = runs["jax"][name]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    for k, v in ref["weights"].items():
        if _apart(k):
            continue
        port, exact = r0["weights"][k], ref["fp64"][k].float()
        assert not torch.equal(v, ref["before"][k]), k  # the weights moved
        jax_rounding = (v - exact).abs()
        assert jax_rounding.max() <= JAX_ROUNDING, k
        assert ((port - v).abs() <= 2e-6 + 1e-4 * v.abs() + jax_rounding).all(), k
        np.testing.assert_allclose(port.numpy(), ref["one"][k].numpy(), atol=1e-7, rtol=1e-5,
                                   err_msg=k)
    assert torch.equal(r0["weights"]["seg_outputs.0.weight"],
                       ref["before"]["seg_outputs.0.weight"])
    assert r0["losses"] == r1["losses"]
    assert all(torch.equal(v, r1["weights"][k]) for k, v in r0["weights"].items())


def test_head_warmup_on_two_ranks_matches_jax_across_its_switch(runs):
    r0, r1 = (r["warmup"] for r in runs["ranks"])
    ref = runs["jax"]["warmup"]
    before = ref["before"]
    np.testing.assert_allclose(r0["losses"], ref["losses"], rtol=1e-5)
    for k, v in before.items():
        p1 = r0["phase1"][k]
        if not k.startswith("seg_outputs."):
            assert torch.equal(p1, v), k  # phase 1: the backbone is frozen
        elif k != "seg_outputs.0.weight":
            assert not torch.equal(p1, v), k
            np.testing.assert_allclose(p1.numpy(), ref["phase1"][k].numpy(), atol=2e-6,
                                       err_msg=k)
    _close(r0["weights"], ref["weights"], before)
    assert all(torch.equal(v, r1["weights"][k]) for k, v in r0["weights"].items())


def test_benchmarking_trainers_are_registered_with_the_reference_schedule(tmp_path):
    assert TRAINERS["nnUNetTrainerV2_2epochs"] is TrainerV2_2epochs
    assert TRAINERS["nnUNetTrainerV2_5epochs"] is TrainerV2_5epochs
    assert TRAINERS["nnUNetTrainerV2_5epochs_dummyLoad"] is TrainerV2_dummyLoad
    plans = flagship_like_plans()
    for port_cls, jax_cls in ((TrainerV2_2epochs, JaxTrainerV2_2epochs),
                              (TrainerV2_dummyLoad, JaxDummyLoad)):
        p = port_cls(port_plans(plans), 0, str(tmp_path / "p"), None, device="cpu")
        j = jax_cls(plans, 0, str(tmp_path / "j"), None)
        for attr in ("max_num_epochs", "save_final_checkpoint", "save_best_checkpoint",
                     "save_intermediate_checkpoints"):
            assert getattr(p, attr) == getattr(j, attr), attr
        assert p.validate() is None


def test_dummy_load_trainer_matches_jax_on_one_rank(tmp_path, monkeypatch):
    """The same fixed random batches (the reference's RandomState stream) and,
    from the same weights, the same three steps."""
    monkeypatch.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    plans = flagship_like_plans()
    jt = JaxDummyLoad(plans, 0, str(tmp_path / "jax"), None, fp16=False)
    jt.initialize(True)
    pt = TrainerV2_dummyLoad(port_plans(plans), 0, str(tmp_path / "port"), None, fp16=False,
                             device="cpu")
    pt.initialize(True)
    for gen in ("tr_gen", "val_gen"):
        a, b = getattr(jt, gen).batch, getattr(pt, gen).batch
        assert np.array_equal(a["data"], b["data"]) and np.array_equal(a["seg"], b["seg"])
    for t in (jt, pt):
        t.data_aug_params.update(NO_AUG)
        t._build_step_functions()
    before = _sd(jt.state.params)
    pt.network.load_state_dict(before)
    losses = [(jt.run_iteration(jt.tr_gen), pt.run_iteration(pt.tr_gen)) for _ in range(3)]
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    _close(pt.network.state_dict(), _sd(jt.state.params), before)
