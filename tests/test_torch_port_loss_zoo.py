"""The loss zoo of the port's variant trainers (training/losses.py) against
the JAX package's (multitalent_tpu/training/losses.py), on the CPU, in fp32.

- Each loss function in value and in its gradient with respect to the
  logits (torch autograd against jax.grad), on seeded logits (2, 3, 8, 8,
  8) and labels made with numpy: gdl_loss (and square_volumes),
  topk_cross_entropy, focal_ce_loss, dc_and_bce_loss (on one-hot targets,
  batch and sample Dice), mcc_loss (with and without the background, with
  smoothing), squared_dice_loss, soft_dice_loss and dc_and_ce_loss at
  smooth 0, dynamic_task_prioritization_loss.
- dynamic_task_prioritization_loss over 3 calls: the running Dice passed
  in and returned (a class absent from a sample, then from the batch).
- Each loss trainer's loss_fn on the same deep-supervision outputs in both
  packages, and the CE -> Dice weights at epochs 0, 500, 625, 750, 1000.
- topk_cross_entropy and gdl_loss over 2 gloo ranks (each rank a sample;
  the rank workers of tests/test_torch_port_ddp_ranks.py): the loss of the
  concatenated batch, and each rank's gradient its rows of the one-process
  gradient.

Tolerances: values rtol 1e-5; gradients 1e-5 of the largest |gradient|
(fp32, the sums taken in other orders); over the ranks 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.registry import resolve_trainer
from multitalent_tpu.training import losses as JL
from multitalent_tpu_torch.cli.train import TRAINERS
from multitalent_tpu_torch.training import losses as PL

from test_torch_port_ddp_ranks import run_loss_ranks
from test_torch_port_train_slice import port_plans
from test_training import tiny_plans

SHAPE = (2, 3, 8, 8, 8)
RTOL = 1e-5


def _inputs(seed: int = 0, shape=SHAPE):
    """Integer labels (B, *S), a cube of class 1 with a core of class 2 in
    noise, so every class is present, and logits (B, C, *S) that lean
    towards them (noise + 3 x one-hot: a network part of the way trained,
    so that no loss sits near 0 where fp32 cancellation decides it)."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, shape[1], (shape[0], *shape[2:])).astype(np.int64)
    labels[:, 2:6, 2:6, 2:6] = 1
    labels[:, 3:5, 3:5, 3:5] = 2
    logits = (rng.randn(*shape) * 2 + 3 * _onehot(labels, shape[1])).astype(np.float32)
    return logits, labels


def _onehot(labels, c):
    return np.moveaxis(np.eye(c, dtype=np.float32)[labels], -1, 1)


def _last(x):
    return np.moveaxis(x, 1, -1)


CASES = {
    "gdl": (PL.gdl_loss, JL.gdl_loss, {}),
    "gdl_square_volumes": (PL.gdl_loss, JL.gdl_loss, {"square_volumes": True}),
    "topk10": (PL.topk_cross_entropy, JL.topk_cross_entropy, {"k_percent": 10.0}),
    "topk_3": (PL.topk_cross_entropy, JL.topk_cross_entropy, {"k_percent": 3.0}),
    "focal": (PL.focal_ce_loss, JL.focal_ce_loss, {}),
    "dc_and_bce_batch": (PL.dc_and_bce_loss, JL.dc_and_bce_loss, {"batch_dice": True}),
    "dc_and_bce_sample": (PL.dc_and_bce_loss, JL.dc_and_bce_loss, {"batch_dice": False}),
    "mcc": (PL.mcc_loss, JL.mcc_loss, {}),
    "mcc_nobg": (PL.mcc_loss, JL.mcc_loss, {"do_bg": False}),
    "mcc_smooth": (PL.mcc_loss, JL.mcc_loss, {"smooth": 1e-3}),
    "squared_dice_batch": (PL.squared_dice_loss, JL.squared_dice_loss,
                           {"batch_dice": True, "do_bg": False}),
    "squared_dice_sample": (PL.squared_dice_loss, JL.squared_dice_loss,
                            {"batch_dice": False, "do_bg": True}),
    "soft_dice_smooth0": (PL.soft_dice_loss, JL.soft_dice_loss,
                          {"batch_dice": True, "do_bg": False, "smooth": 0.0}),
    "dc_and_ce_smooth0_batch": (PL.dc_and_ce_loss, JL.dc_and_ce_loss,
                                {"batch_dice": True, "smooth": 0.0}),
    "dc_and_ce_smooth0_sample": (PL.dc_and_ce_loss, JL.dc_and_ce_loss,
                                 {"batch_dice": False, "smooth": 0.0}),
}


def _port_value_grad(fn, logits, target, **kw):
    x = torch.from_numpy(logits).requires_grad_(True)
    out = fn(x, torch.from_numpy(target), **kw)
    loss = out[0] if isinstance(out, tuple) else out
    loss.backward()
    return loss.item(), x.grad.numpy()


def _jax_value_grad(fn, logits, target, **kw):
    def f(x):
        out = fn(x, jnp.asarray(target), **kw)
        return out[0] if isinstance(out, tuple) else out
    value, grad = jax.value_and_grad(f)(jnp.asarray(_last(logits)))
    return float(value), np.moveaxis(np.asarray(grad), -1, 1)


def _close(port, ref):
    (pv, pg), (rv, rg) = port, ref
    np.testing.assert_allclose(pv, rv, rtol=RTOL)
    np.testing.assert_allclose(pg, rg, rtol=0, atol=RTOL * np.abs(rg).max())


@pytest.mark.parametrize("case", list(CASES))
def test_loss_value_and_gradient_match_jax(case):
    port_fn, jax_fn, kw = CASES[case]
    logits, labels = _inputs(1)
    if case.startswith("dc_and_bce"):
        target = _onehot(labels, SHAPE[1])
        port = _port_value_grad(port_fn, logits, target, **kw)
        ref = _jax_value_grad(jax_fn, logits, _last(target), **kw)
    else:
        port = _port_value_grad(port_fn, logits, labels, **kw)
        ref = _jax_value_grad(jax_fn, logits, labels, **kw)
    _close(port, ref)


def _dtp_calls():
    """Three calls' inputs: every class present; class 2 absent from sample
    0 (its logits low); class 2 absent from the batch."""
    calls = []
    for i in range(3):
        logits, labels = _inputs(10 + i)
        if i >= 1:
            labels[0][labels[0] == 2] = 1
            logits[0, 2] = -20.0
        if i == 2:
            labels[1][labels[1] == 2] = 1
            logits[1, 2] = -20.0
        calls.append((logits, labels))
    return calls


def test_dynamic_task_prioritization_running_dice_over_three_calls():
    port_run = torch.zeros(2)
    jax_run = jnp.zeros(2)
    for i, (logits, labels) in enumerate(_dtp_calls()):
        x = torch.from_numpy(logits).requires_grad_(True)
        loss, new_port = PL.dynamic_task_prioritization_loss(x, torch.from_numpy(labels),
                                                             port_run)
        loss.backward()

        def f(z, run=jax_run, lab=labels):
            return JL.dynamic_task_prioritization_loss(z, jnp.asarray(lab), run)

        (jloss, new_jax), jgrad = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(_last(logits)))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
        np.testing.assert_allclose(new_port.numpy(), np.asarray(new_jax), rtol=RTOL, atol=1e-7)
        ref = np.moveaxis(np.asarray(jgrad), -1, 1)
        np.testing.assert_allclose(x.grad.numpy(), ref, atol=RTOL * np.abs(ref).max())
        if i == 2:  # class 2 present nowhere: its running Dice stays
            assert new_port[1] == port_run[1]
        else:
            assert torch.all(new_port != port_run)
        port_run, jax_run = new_port, new_jax
    # without update_kpi the running Dice is returned as it came
    logits, labels = _dtp_calls()[0]
    _, same = PL.dynamic_task_prioritization_loss(torch.from_numpy(logits),
                                                  torch.from_numpy(labels), port_run,
                                                  update_kpi=False)
    assert torch.equal(same, port_run)


# ------------------------------------------------------------ the trainers
LOSS_TRAINERS = ["nnUNetTrainerV2_Loss_CE", "nnUNetTrainerV2_Loss_Dice",
                 "nnUNetTrainerV2_Loss_DicewithBG", "nnUNetTrainerV2_Loss_TopK10",
                 "nnUNetTrainerV2_Loss_DiceTopK10", "nnUNetTrainerV2_focalLoss",
                 "nnUNetTrainerV2_GDL", "nnUNetTrainerV2_Loss_MCC",
                 "nnUNetTrainerV2_Loss_DC_CE_squared", "nnUNetTrainerV2_Loss_CEGDL",
                 "nnUNetTrainerV2_Loss_DiceCE_noSmooth", "nnUNetTrainerV2_Loss_MCCnoBG",
                 "nnUNetTrainerV2_Loss_Dice_squared",
                 "nnUNetTrainerV2_graduallyTransitionFromCEToDice",
                 "nnUNetTrainerV2_Loss_Dice_LR1en3", "nnUNetTrainerV2_Loss_DicewithBG_LR1en3"]


def _ds_outputs(seed: int):
    """Three deep-supervision levels (the last of weight 0) and targets."""
    outs, tgts = [], []
    for i, s in enumerate((8, 4, 2)):
        logits, labels = _inputs(seed + i, (2, 3, s, s, s))
        outs.append(logits)
        tgts.append(labels)
    return outs, tgts


def _trainers(name: str, batch_dice: bool, epoch: int = 0):
    plans = tiny_plans(num_classes=2)
    p = TRAINERS[name](port_plans(plans), 0, batch_dice=batch_dice, device="cpu")
    j = resolve_trainer(name)(plans, 0, batch_dice=batch_dice)
    for t in (p, j):
        t.ds_loss_weights = PL.ds_loss_weights(3)
        t.epoch = epoch
    return p, j


@pytest.mark.parametrize("batch_dice", [True, False])
@pytest.mark.parametrize("name", LOSS_TRAINERS)
def test_loss_trainer_loss_fn_matches_jax(name, batch_dice):
    p, j = _trainers(name, batch_dice, epoch=600)
    assert type(p).__name__ == type(j).__name__
    outs, tgts = _ds_outputs(20)
    extras = p.batch_extras({})
    xs = [torch.from_numpy(o).requires_grad_(True) for o in outs]
    loss, aux = p.loss_fn(xs, [torch.from_numpy(t) for t in tgts],
                          {k: torch.as_tensor(v) for k, v in extras.items()})
    loss.backward()

    def f(os_):
        return j.loss_fn(os_, [jnp.asarray(t) for t in tgts], j.batch_extras({}))[0]

    jloss, jgrads = jax.value_and_grad(f)([jnp.asarray(_last(o)) for o in outs])
    assert aux == {}
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=RTOL)
    for x, g in zip(xs[:2], jgrads[:2]):
        ref = np.moveaxis(np.asarray(g), -1, 1)
        np.testing.assert_allclose(x.grad.numpy(), ref, atol=RTOL * np.abs(ref).max())
    assert xs[2].grad is None  # the level of weight 0 is skipped


@pytest.mark.parametrize("epoch", [0, 500, 625, 750, 1000])
def test_ce_to_dice_weights_match_jax(epoch):
    p, j = _trainers("nnUNetTrainerV2_graduallyTransitionFromCEToDice", True, epoch)
    got, ref = p.batch_extras({}), j.batch_extras({})
    assert got.keys() == ref.keys() == {"w_ce", "w_dc"}
    assert all(got[k] == ref[k] and got[k].dtype == np.float32 for k in got)
    assert got["w_ce"] + got["w_dc"] == 2.0
    if epoch == 625:
        assert (got["w_ce"], got["w_dc"]) == (1.0, 1.0)


# -------------------------------------------------------- over two gloo ranks
@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    logits, labels = _inputs(30)
    return logits, labels, run_loss_ranks(logits, labels, tmp_path_factory.mktemp("loss_ranks"))


@pytest.mark.parametrize("loss", ["topk_cross_entropy", "gdl_loss"])
def test_loss_over_two_gloo_ranks_is_the_global_batch_loss(ranks, loss):
    logits, labels, results = ranks
    value, grad = _port_value_grad(getattr(PL, loss), logits, labels)
    for rank, r in enumerate(results):
        np.testing.assert_allclose(r[loss]["value"], value, rtol=1e-6)
        np.testing.assert_allclose(r[loss]["grad"], grad[rank:rank + 1], rtol=0,
                                   atol=1e-6 * np.abs(grad).max())
    assert results[0][loss]["value"] == results[1][loss]["value"]
