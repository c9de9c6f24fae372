"""The optimizer and schedule variants of the port (training/variants.py,
train_state.py, schedules.py) against the JAX package's, on the CPU, and
the whole variant zoo's names and entry points.

- Each optimizer and schedule trainer's optimizer on a small parameter set
  with fixed seeded gradients (the first step's clipped, the others not)
  for 3 steps, against the optax chain the JAX class builds; the
  reduce-momentum trainer with its momentum changed between steps.
  Tolerance 1e-6 of max |param|. RAdam over 8 steps: the same through step
  5; from step 6 (rho past its threshold) its rectification is the double
  formula's, where optax's fp32 rho leaves r up to 0.6% off (its jit and
  eager paths differ by as much), so there the updates agree within 1%.
- The LR tables (the schedules at epochs 0-1199, 250 steps an epoch)
  against the LR the JAX optimizer applies at that step (read from one
  update of its chain), within fp32 rounding (1e-6 relative, 1e-6 of the
  initial LR absolute: the JAX schedules compute in fp32, the port's in
  double); the plateau trainers driven by the same train-loss sequences;
  the momentum at epochs 800, 900 and 1000.
- Three faults of the JAX classes, each shown: `_SGD_fixedSchedule2`'s
  optimizer keeps plain poly (its reported LR is the stepped one, which the
  port's optimizer applies: the two agree bit for bit before epoch 700);
  `_reduceMomentumDuringTraining` swallows a failure to set the momentum
  (the port raises); the plateau trainers' 1e-3 threshold is shadowed by
  the base's 1e-6 (a loss falling 1e-5 an epoch never plateaus there).
- Every trainer name the JAX package's variants.py registers resolves in
  the port's train CLI to the port class of the same name.
- One `cli.train ... --device cpu` run, one step, of a trainer of each
  family: a loss (Dice + TopK), an optimizer (Ranger, then -val), a
  schedule (the momentum reduction, then -c), `_lReLU_convReLUIN` with its
  restore and `cli.predict`, `_resample33` with its validation's export
  order.
"""
import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import multitalent_tpu.training.variants as jax_variants
from multitalent_tpu.plans import Plans
from multitalent_tpu.registry import TRAINERS as JAX_TRAINERS
from multitalent_tpu.registry import resolve_trainer
from multitalent_tpu.training.train_state import TrainState
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.inference import validation
from multitalent_tpu_torch.inference.model_restore import load_model_and_checkpoint_files
from multitalent_tpu_torch.io import Geometry, read_nifti, save_plans, write_nifti
from multitalent_tpu_torch.training.schedules import poly_lr
from multitalent_tpu_torch.training.train_state import RAdam, SGDClipped, SGDDecayThenClip

from test_torch_port_predict import _phantom, _tiny_plans
from test_torch_port_train_slice import port_plans
from test_torch_port_validation import stamp_export_geometry
from test_training import make_preprocessed, tiny_plans

SHAPES = {"a": (3, 4, 3, 3, 3), "b": (7,), "c": (5, 5)}
GRAD_SCALES = (1.0, 0.1, 0.5)  # global norm ~19 (clipped at 12), ~1.9, ~9.5

OPT_TRAINERS = [
    "nnUNetTrainerV2", "nnUNetTrainerV2_Adam", "nnUNetTrainerV2_Adam_nnUNetTrainerlr",
    "nnUNetTrainerV2_SGD_fixedSchedule", "nnUNetTrainerV2_constLR",
    "nnUNetTrainerV2_momentum09", "nnUNetTrainerV2_momentum095",
    "nnUNetTrainerV2_momentum098", "nnUNetTrainerV2_momentum09in2D",
    "nnUNetTrainerV2_Ranger", "nnUNetTrainerV2_Ranger_lr1en2", "nnUNetTrainerV2_Ranger_lr3en3",
    "nnUNetTrainerV2_SGD_lr1en1", "nnUNetTrainerV2_SGD_lr1en3",
    "nnUNetTrainerV2_Loss_Dice_LR1en3", "nnUNetTrainerV2_cycleAtEnd",
    "nnUNetTrainerV2_cycleAtEnd2", "nnUNetTrainerV2_SGD_ReduceOnPlateau",
    "nnUNetTrainerV2_Adam_ReduceOnPlateau", "nnUNetTrainerV2_SGD_fixedSchedule2",
    "nnUNetTrainerV2_reduceMomentumDuringTraining"]


def _plans(two_d: bool = False) -> Plans:
    if two_d:
        d = tiny_plans().to_dict()
        d["plans_per_stage"][0].update(patch_size=(8, 8), pool_op_kernel_sizes=[[2, 2]],
                                       conv_kernel_sizes=[[3, 3]] * 2)
        return Plans.from_dict(d)
    return tiny_plans()


def _pair(name: str, two_d: bool = False, ipe: int = 1):
    """The port's and the JAX package's trainer of `name` over the same
    plans (processed, not initialised), `ipe` steps an epoch; the port's
    network a ParameterDict of SHAPES."""
    plans = _plans(two_d)
    p = train.TRAINERS[name](port_plans(plans), 0, device="cpu")
    j = resolve_trainer(name)(plans, 0)
    for t, pl in ((p, port_plans(plans)), (j, plans)):
        t.process_plans(pl)
        t.num_batches_per_epoch = ipe
    rng = np.random.RandomState(0)
    p.network = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(
        rng.randn(*s).astype(np.float32) * 0.3)) for k, s in SHAPES.items()})
    return p, j


def _grads(step: int) -> dict:
    rng = np.random.RandomState(100 + step)
    return {k: (rng.randn(*s) * GRAD_SCALES[step % 3]).astype(np.float32)
            for k, s in SHAPES.items()}


def _run_both(name: str, steps: int, two_d: bool = False, between=None):
    """`steps` updates of both packages' optimizers from the same weights
    and gradients; `between(trainer, step)` runs on both trainers after each
    step. Returns the port's and the JAX parameters and the port trainer."""
    p, j = _pair(name, two_d)
    p.optimizer, p.lr_schedule = p.initialize_optimizer()
    # copies: a jax CPU array may share the numpy buffer the port updates in place
    params = {k: jnp.array(v.detach().numpy(), copy=True) for k, v in p.network.items()}
    j.state = TrainState.create(None, params, j.initialize_optimizer())
    for i in range(steps):
        g = _grads(i)
        for k, v in p.network.items():
            v.grad = torch.from_numpy(g[k])
        p.optimizer.step(p.lr_schedule(i))
        j.state = j.state.apply_gradients({k: jnp.asarray(v) for k, v in g.items()})
        if between is not None:
            between(p, i)
            between(j, i)
    return ({k: v.detach().numpy() for k, v in p.network.items()},
            {k: np.asarray(v) for k, v in j.state.params.items()}, p)


def _set_momentum_epoch(t, step):
    if step == 0:
        t.epoch = 900
        t.maybe_update_lr()


CASES = [(name, False) for name in OPT_TRAINERS] + [
    ("nnUNetTrainerV2", True), ("nnUNetTrainerV2_momentum09in2D", True)]


@pytest.mark.parametrize("name,two_d", CASES,
                         ids=[f"{n}-{'2d' if d else '3d'}" for n, d in CASES])
def test_optimizer_matches_the_optax_chain(name, two_d):
    between = _set_momentum_epoch if "reduceMomentum" in name else None
    got, ref, p = _run_both(name, 3, two_d, between)
    scale = max(np.abs(v).max() for v in ref.values())
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-6 * scale, err_msg=k)
    assert not all(np.array_equal(got[k], p0) for k, p0 in
                   zip(got, _pair(name, two_d)[0].network.values()))
    kind = {"Adam": "AdamClipped", "Ranger": "RAdam", "reduceMomentum": "SGDDecayThenClip"}
    expect = next((v for k, v in kind.items() if k in name), "SGDClipped")
    assert type(p.optimizer).__name__ == expect
    if "momentum09in2D" in name:
        assert p.optimizer.momentum == (0.9 if two_d else 0.99)


def test_radam_rectification_past_the_threshold():
    """Ranger over 8 steps: steps 1-5 (rho < 5) within 1e-6 of optax's
    chain; from step 6 the port's r is the double formula's and the updates
    within 1% of optax's (its fp32 rho)."""
    p, j = _pair("nnUNetTrainerV2_Ranger")
    opt, schedule = p.initialize_optimizer()
    tx = jax.jit(j.initialize_optimizer().update)
    params = {k: jnp.array(v.detach().numpy(), copy=True) for k, v in p.network.items()}
    state = j.initialize_optimizer().init(params)
    for i in range(8):
        g = _grads(i)
        for k, v in p.network.items():
            v.grad = torch.from_numpy(g[k])
        _, ours = opt.updates(schedule(i))
        theirs, state = tx({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        r = opt.rectification()
        assert (r is None) == (i < 5)
        if r is not None:
            b2t = 0.999 ** (i + 1)
            rho = 1999.0 - 2 * (i + 1) * b2t / (1 - b2t)
            assert r == pytest.approx(np.sqrt((rho - 4) * (rho - 2) * 1999.0
                                              / (1995.0 * 1997.0 * rho)), rel=1e-12)
        for u, k in zip(ours, SHAPES):
            ref = np.asarray(theirs[k])
            bound = (1e-6 if r is None else 1e-2) * np.abs(ref).max()
            np.testing.assert_allclose(u.numpy(), ref, rtol=0, atol=bound, err_msg=f"{i} {k}")
        for q, u in zip(opt.params, ours):
            q.data.add_(u)
        params = {k: jnp.array(v.detach().numpy(), copy=True) for k, v in p.network.items()}


# ------------------------------------------------------------------ schedules
EPOCHS = (0, 699, 700, 750, 899, 900, 999, 1100, 1199)


def _jax_lr(tx, step: int, momentum: float = 0.99) -> float:
    """The LR the JAX SGD chain applies at optimizer step `step`: one
    update of a unit gradient at a zero weight from the chain's initial
    state with its schedule's count set to `step` (the Nesterov update of
    a fresh trace is (1 + momentum) times the gradient)."""
    params = {"w": jnp.zeros((1,))}
    state = tuple(s._replace(count=jnp.asarray(step, jnp.int32))
                  if isinstance(s, optax.ScaleByScheduleState) else s
                  for s in tx.init(params))
    updates, _ = tx.update({"w": jnp.ones((1,))}, state, params)
    return float(-updates["w"][0] / np.float32(1 + momentum))


@pytest.mark.parametrize("name", ["nnUNetTrainerV2_cycleAtEnd", "nnUNetTrainerV2_cycleAtEnd2"])
def test_cycle_lr_table_matches_jax(name):
    p, j = _pair(name, ipe=250)
    _, schedule = p.initialize_optimizer()
    tx = j.initialize_optimizer()
    table = {e: schedule(e * 250) for e in EPOCHS}
    for e, lr in table.items():
        np.testing.assert_allclose(lr, _jax_lr(tx, e * 250), rtol=1e-6,
                                   atol=1e-6 * p.initial_lr, err_msg=str(e))
    main = p.max_num_epochs - p.cycle_epochs
    lr0 = p.initial_lr
    assert table[0] == lr0 and schedule(main * 250) == pytest.approx(lr0 / 25, rel=1e-12)
    peak = main + int(0.3 * p.cycle_epochs)
    assert schedule(peak * 250) == pytest.approx(lr0, rel=1e-12)
    assert schedule(p.max_num_epochs * 250) == pytest.approx(lr0 / 25 / 1e4, rel=1e-12)


def test_fixed_schedule2_lr_is_the_stepped_poly_the_jax_optimizer_ignores():
    """The port's optimizer applies the stepped poly the JAX class reports
    (current_lr): bit for bit at every epoch; the JAX optimizer applies
    plain poly, the same before epoch 700 (within fp32) and not after."""
    p, j = _pair("nnUNetTrainerV2_SGD_fixedSchedule2", ipe=250)
    _, schedule = p.initialize_optimizer()
    tx = j.initialize_optimizer()
    for e in (*range(0, 700, 7), 699, 700, 750, 899, 900, 999):
        p.epoch = j.epoch = e
        assert schedule(e * 250) == p.current_lr() == j.current_lr(), e
        jax_lr = _jax_lr(tx, e * 250)
        plain = poly_lr(e, 1000, p.initial_lr)
        np.testing.assert_allclose(jax_lr, plain, rtol=1e-6, atol=1e-6 * p.initial_lr)
        if e < 700:
            assert j.current_lr() == plain
        else:  # the JAX fault: its optimizer keeps poly, its report is stepped
            assert j.current_lr() < 0.7 * plain
    p.epoch = j.epoch = 750
    assert schedule(750 * 250) == poly_lr(750, 1000, poly_lr(700, 1000, 1e-2))


SEQUENCES = {
    # a fall of 1e-2 an epoch for 10 epochs, then flat: both reduce 31 epochs on
    "flat": [1.0 - 1e-2 * min(e, 10) for e in range(80)],
    # a fall of 1e-5 an epoch: under the 1e-3 threshold, above JAX's 1e-6
    "slow": [1.0 - 1e-5 * e for e in range(80)],
}


@pytest.mark.parametrize("seq", list(SEQUENCES))
@pytest.mark.parametrize("name", ["nnUNetTrainerV2_SGD_ReduceOnPlateau",
                                  "nnUNetTrainerV2_Adam_ReduceOnPlateau"])
def test_plateau_trainers_on_the_same_train_loss(name, seq):
    p, j = _pair(name)
    opt, schedule = p.initialize_optimizer()
    tx = j.initialize_optimizer()
    j.state = TrainState.create(None, {"w": jnp.zeros((1,))}, tx)
    ours, theirs = [], []
    for ma in SEQUENCES[seq]:
        p.train_loss_MA = j.train_loss_MA = ma
        p.maybe_update_lr()
        j.maybe_update_lr()
        ours.append(schedule(0))
        theirs.append(j.current_lr())
        assert p.current_lr() == ours[-1]
    lr0 = p.initial_lr
    assert j.lr_threshold == 1e-6 and p.plateau_threshold == 1e-3
    if seq == "flat":
        assert ours == theirs
        assert ours[40] == lr0 and ours[41] == pytest.approx(0.2 * lr0, rel=1e-15)
    else:  # the JAX fault: its threshold is the base's 1e-6
        assert set(theirs) == {lr0}
        assert ours[30] == lr0 and ours[31] == pytest.approx(0.2 * lr0, rel=1e-15)
    assert p.optimizer is None and opt is not None  # the state lives on: one optimizer


def test_momentum_reduction_epochs_and_its_failure_raises():
    p, j = _pair("nnUNetTrainerV2_reduceMomentumDuringTraining")
    p.optimizer, _ = p.initialize_optimizer()
    j.state = TrainState.create(None, {"w": jnp.zeros((1,))}, j.initialize_optimizer())
    for e, m in ((800, 0.99), (900, 0.945), (1000, 0.9)):
        p.epoch = j.epoch = e
        assert p.current_momentum() == j._current_momentum() == pytest.approx(m, abs=1e-15)
        p.maybe_update_lr()
        j.maybe_update_lr()
        assert p.optimizer.momentum == p.current_momentum()
        assert np.float32(p.optimizer.momentum) == j.state.opt_state.hyperparams["momentum"]
    # the JAX class swallows a failure to set it; the port raises
    p2, j2 = _pair("nnUNetTrainerV2_reduceMomentumDuringTraining")
    j2.maybe_update_lr()  # no state: the AttributeError is swallowed
    with pytest.raises(AttributeError):
        p2.maybe_update_lr()


def test_radam_and_decay_first_sgd_state_round_trips():
    """RAdam's and SGDDecayThenClip's state_dict load into a fresh optimizer
    and the next updates are the same."""
    for cls in (RAdam, SGDDecayThenClip, SGDClipped):
        ps = [torch.nn.Parameter(torch.ones(3)), torch.nn.Parameter(torch.ones(2))]
        opt = cls(ps)
        for i in range(2):
            for q in ps:
                q.grad = torch.full_like(q, 0.1 * (i + 1))
            opt.step(1e-2)
        qs = [torch.nn.Parameter(q.detach().clone()) for q in ps]
        other = cls(qs, **opt.config)
        other.load_state_dict(copy.deepcopy(opt.state_dict()))  # torch's shares buffers
        for a, b in ((ps, opt), (qs, other)):
            for q in a:
                q.grad = torch.full_like(q, 0.5)
        _, ua = opt.updates(1e-2)
        _, ub = other.updates(1e-2)
        assert all(torch.equal(x, y) for x, y in zip(ua, ub))


# -------------------------------------------------------------- alias coverage
def _jax_variant_names() -> list[str]:
    """Every name registered by the JAX package's variants.py: its classes'
    names and aliases, the copies' and the DDP benchmark aliases."""
    resolve_trainer("TrainerV2")
    extra = {"nnUNetTrainerV2_copy1", "nnUNetTrainerV2_copy2", "nnUNetTrainerV2_copy3",
             "nnUNetTrainerV2_copy4", "nnUNetTrainerV2_fp16", "nnUNetTrainerV2_DDP_5epochs",
             "nnUNetTrainerV2_DDP_5epochs_dummyLoad"}
    return sorted(n for n in JAX_TRAINERS.names()
                  if JAX_TRAINERS.get(n).__module__ == jax_variants.__name__ or n in extra)


@pytest.mark.parametrize("name", _jax_variant_names())
def test_every_jax_variant_name_resolves_to_the_port_class(name):
    assert name in train.TRAINERS
    assert train.TRAINERS[name].__name__ == JAX_TRAINERS.get(name).__name__


# ------------------------------------------------------------ end to end
TASK = "Task003_Liver"
CASE_SHAPE = (16, 32, 32)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def task(tmp_path, monkeypatch):
    """A 3-class softmax task of three cases (the validation case resized
    on export) with the predict CLI's plans, one step an epoch."""
    pre, results = tmp_path / "pre", tmp_path / "results"
    for k, v in {"nnUNet_preprocessed": pre, "RESULTS_FOLDER": results,
                 "MTTPU_MAX_EPOCHS": 1, "MTTPU_ITERS_PER_EPOCH": 1,
                 "MTTPU_VAL_ITERS": 1}.items():
        monkeypatch.setenv(k, str(v))
    ddir = pre / TASK
    make_preprocessed(ddir, n_cases=3, prefix="case", shape=CASE_SHAPE)
    d = _tiny_plans().to_dict()
    d.update(num_classes=2, all_classes=[1, 2])
    save_plans(port_plans(Plans.from_dict(d)),
               ddir / f"{paths.default_plans_identifier}_plans_3D.pkl")
    stamp_export_geometry(ddir, resized=("case_002",))
    keys = [f"case_{i:03d}" for i in range(3)]
    save_pickle([{"train": keys[:2], "val": keys[2:]}] * 5, ddir / "splits_final.pkl")
    return tmp_path


def _cli(name, *extra):
    return train.main(["3d_fullres", name, TASK, "0", "--device", "cpu", *extra])


def _fold(tmp, name):
    return (tmp / "results" / "nnUNet" / "3d_fullres" / TASK
            / f"{name}__{paths.default_plans_identifier}" / "fold_0")


def test_cli_trains_a_loss_variant(task):
    t = _cli("nnUNetTrainerV2_Loss_DiceTopK10")
    assert type(t).__name__ == "TrainerV2LossTopK" and t.step == 1
    assert np.isfinite(t.all_tr_losses).all()
    assert (_fold(task, "nnUNetTrainerV2_Loss_DiceTopK10") / "validation_raw"
            / "case_002.nii.gz").is_file()


def test_cli_trains_ranger_then_validates_it(task):
    t = _cli("nnUNetTrainerV2_Ranger")
    assert type(t.optimizer).__name__ == "RAdam" and t.optimizer.count == 1
    v = _cli("nnUNetTrainerV2_Ranger", "-val", "--val_folder", "again")
    fold = _fold(task, "nnUNetTrainerV2_Ranger")
    a, _ = read_nifti(fold / "validation_raw" / "case_002.nii.gz")
    b, _ = read_nifti(fold / "again" / "case_002.nii.gz")
    assert v.step == t.step and np.array_equal(a, b)


def test_cli_trains_the_momentum_reduction_and_resumes(task, monkeypatch):
    name = "nnUNetTrainerV2_reduceMomentumDuringTraining"
    t = _cli(name)
    assert type(t.optimizer).__name__ == "SGDDecayThenClip"
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "2")
    resumed = _cli(name, "-c")
    assert resumed.step == 2 and resumed.all_tr_losses[0] == t.all_tr_losses[0]
    assert resumed.optimizer.momentum == 0.99


def test_cli_trains_restores_and_predicts_lrelu_conv_relu_in(task):
    name = "nnUNetTrainerV2_lReLU_convReLUIN"
    t = _cli(name)
    assert t.network.nonlin_first and t.network.nonlin == "leaky_relu"
    model = _fold(task, name).parent
    restored = load_model_and_checkpoint_files(str(model), folds=[0], device="cpu")
    net = restored.networks[0]
    assert net.nonlin_first and net.nonlin == "leaky_relu"
    sd = t.network.state_dict()
    assert all(torch.equal(net.state_dict()[k].float(), v.cpu().float()) for k, v in sd.items())
    (task / "in").mkdir()
    ct = _phantom(np.random.RandomState(3))[1:17, 4:36, 2:34]
    write_nifti(task / "in" / "liver_000_0000.nii.gz", ct.astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.5)))
    predict_cli.main(["-i", str(task / "in"), "-o", str(task / "out"), "-t", TASK, "-m",
                      "3d_fullres", "-tr", name, "-f", "0", "--disable_tta", "--device", "cpu"])
    seg, _ = read_nifti(task / "out" / "liver_000.nii.gz")
    assert seg.shape == ct.shape and set(np.unique(seg)) <= {0, 1, 2}


def test_cli_resample33_validation_exports_cubic(task, monkeypatch):
    calls, save = [], validation.save_segmentation_nifti_from_softmax

    def spy(probs, fname, properties, order, *args):
        calls.append((os.path.basename(fname), order, args[-2], args[-1]))
        return save(probs, fname, properties, order, *args)

    monkeypatch.setattr(validation, "save_segmentation_nifti_from_softmax", spy)
    _cli("nnUNetTrainerV2_resample33")
    assert calls == [("case_002.nii.gz", 3, False, 3)]
    _cli("nnUNetTrainerV2")  # the default export: linear, z by the spacing
    assert calls[1] == ("case_002.nii.gz", 1, None, 0)
