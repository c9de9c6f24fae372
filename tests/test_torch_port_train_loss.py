"""The port's losses, LR schedule, optimizer and deep-supervision outputs
against the JAX package's, on the CPU. Inputs are made with numpy and handed
to both; gradients of the losses come from jax.grad and torch autograd.

Tolerances: losses and their gradients rtol 1e-5 / atol 1e-6 (fp32 means and
sums over ~6k voxels in different orders); the optimizer over 3 steps rtol
1e-6 / atol 1e-8 (torch's clip adds 1e-6 to the norm it divides by, optax
does not: a relative difference of 1e-6 / |g| on a clipped step); the DS
logits atol 1e-4 / rtol 1e-3, as the port's UNet test holds the full-
resolution logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.tasks.multitalent import label_region_matrix as jax_label_region_matrix
from multitalent_tpu.training import losses as jl
from multitalent_tpu.training.schedules import make_poly_schedule as jax_poly_schedule
from multitalent_tpu.training.train_state import make_sgd_optimizer
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.training import losses as pl
from multitalent_tpu_torch.training.schedules import make_poly_schedule
from multitalent_tpu_torch.training.train_state import SGDClipped

TOL = dict(rtol=1e-5, atol=1e-6)


def _cl(x: np.ndarray) -> np.ndarray:
    """(B, C, *S) -> (B, *S, C)"""
    return np.moveaxis(x, 1, -1)


def _region_case(rng, shape=(2, 47, 4, 6, 6)):
    logits = (rng.randn(*shape) * 2).astype(np.float32)
    labels = rng.randint(-1, 48, (shape[0], *shape[2:])).astype(np.float32)
    valid = (rng.rand(shape[0], 47) < 0.5).astype(np.float32)
    valid[:, 5] = 0  # a region valid nowhere in the batch: Dice 0 / eps
    return logits, labels, valid


def test_label_region_matrix_and_ds_weights_match():
    np.testing.assert_array_equal(pl.label_region_matrix(), jax_label_region_matrix())
    for n in (1, 2, 5):
        np.testing.assert_array_equal(pl.ds_loss_weights(n), jl.ds_loss_weights(n))


@pytest.mark.parametrize("batch_dice", [True, False])
def test_multitalent_loss_value_and_gradient(batch_dice):
    rng = np.random.RandomState(0)
    logits, labels, valid = _region_case(rng)
    m = pl.label_region_matrix()

    def jax_fn(lg):
        return jl.multitalent_loss(lg, jnp.asarray(labels), jnp.asarray(valid),
                                   jnp.asarray(m), batch_dice=batch_dice)

    (ref, ref_ce, ref_dc), vjp = jax.vjp(jax_fn, jnp.asarray(_cl(logits)))
    (ref_grad,) = vjp((jnp.float32(1), jnp.float32(0), jnp.float32(0)))
    lg = torch.from_numpy(logits).requires_grad_()
    loss, ce, dc = pl.multitalent_loss(lg, torch.from_numpy(labels), torch.from_numpy(valid),
                                       torch.from_numpy(m), batch_dice=batch_dice)
    loss.backward()
    np.testing.assert_allclose([loss.item(), ce.item(), dc.item()],
                               [float(ref), float(ref_ce), float(ref_dc)], **TOL)
    np.testing.assert_allclose(_cl(lg.grad.numpy()), np.asarray(ref_grad), **TOL)


def test_multitalent_ds_loss_skips_weight_zero_levels():
    rng = np.random.RandomState(1)
    shapes = [(2, 47, 4, 8, 8), (2, 47, 4, 4, 4), (2, 47, 2, 2, 2)]
    cases = [_region_case(rng, s) for s in shapes]
    valid = cases[0][2]
    weights = list(pl.ds_loss_weights(3))
    m = pl.label_region_matrix()
    ref = jl.multitalent_ds_loss([jnp.asarray(_cl(c[0])) for c in cases],
                                 [jnp.asarray(c[1]) for c in cases], jnp.asarray(valid),
                                 jnp.asarray(m), weights)
    # the last level has weight 0: NaN logits there must not reach the loss
    outs = [torch.from_numpy(c[0]) for c in cases[:2]] + [torch.full(shapes[2], np.nan)]
    got = pl.multitalent_ds_loss(outs, [torch.from_numpy(c[1]) for c in cases],
                                 torch.from_numpy(valid), torch.from_numpy(m), weights)
    np.testing.assert_allclose([float(g) for g in got], [float(r) for r in ref], **TOL)


def test_dc_and_ce_deep_supervision_loss_value_and_gradient():
    rng = np.random.RandomState(2)
    logits = [rng.randn(2, 4, 4, 8, 8).astype(np.float32),
              rng.randn(2, 4, 2, 4, 4).astype(np.float32)]
    labels = [rng.randint(0, 4, (2, 4, 8, 8)).astype(np.float32),
              rng.randint(0, 4, (2, 2, 4, 4)).astype(np.float32)]
    weights = [2 / 3, 1 / 3]

    def jax_fn(l0, l1):
        return jl.deep_supervision_loss(
            [l0, l1], [jnp.asarray(t) for t in labels],
            lambda o, t: jl.dc_and_ce_loss(o, t, batch_dice=True), weights)

    ref, grads = jax.value_and_grad(jax_fn, argnums=(0, 1))(
        *(jnp.asarray(_cl(x)) for x in logits))
    lts = [torch.from_numpy(x).requires_grad_() for x in logits]
    loss = pl.deep_supervision_loss(
        lts, [torch.from_numpy(t) for t in labels],
        lambda o, t: pl.dc_and_ce_loss(o, t, batch_dice=True), weights)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), **TOL)
    for lt, g in zip(lts, grads):
        np.testing.assert_allclose(_cl(lt.grad.numpy()), np.asarray(g), **TOL)


def test_poly_schedule_matches_the_jax_staircase():
    ours, ref = make_poly_schedule(1e-2, 1000, 250), jax_poly_schedule(1e-2, 1000, 250)
    for step in (0, 249, 250, 12345, 999 * 250, 10 ** 6):
        assert np.isclose(ours(step), float(ref(jnp.asarray(step))), rtol=1e-6), step


def test_sgd_with_clip_matches_the_optax_chain():
    """clip_grad_norm_(12) + SGD(momentum 0.99, nesterov, weight decay 3e-5)
    = optax clip_by_global_norm -> add_decayed_weights -> trace(nesterov) ->
    scale by the LR, over 3 steps; the second gradient is large enough to be
    clipped."""
    rng = np.random.RandomState(3)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: (rng.randn(*v.shape) * s).astype(np.float32) for k, v in params.items()}
             for s in (0.5, 20.0, 1.0)]
    lrs = [1e-2, 1e-2, 9e-3]
    tx = make_sgd_optimizer(lambda step: jnp.asarray(lrs)[step])
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = SGDClipped(tp.values())
    for g, lr in zip(grads, lrs):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step(lr)
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-8, err_msg=k)


def test_deep_supervision_outputs_match_jax():
    """GenericUNet(deep_supervision=True): one fp32 logit map per decoder
    level, highest resolution first, each at its level's resolution."""
    pools, kernels, patch = ((1, 2, 2), (2, 2, 2), (2, 2, 2)), ((3, 3, 3),) * 4, (8, 16, 16)
    model = JaxGenericUNet(input_channels=1, base_num_features=4, num_classes=47,
                           pool_op_kernel_sizes=pools, conv_kernel_sizes=kernels,
                           deep_supervision=True, dtype=jnp.float32)
    x = np.random.RandomState(4).randn(2, *patch, 1).astype(np.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ref = model.apply({"params": params}, jnp.asarray(x))
    net = GenericUNet(1, 4, 47, pools, kernels, dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(params, num_pool=3))
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1)), deep_supervision=True)
    assert [tuple(g.shape) for g in got] == [(2, 47, 8, 16, 16), (2, 47, 8, 8, 8),
                                             (2, 47, 4, 4, 4)]
    assert len(ref) == len(got)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(_cl(g.numpy()), np.asarray(r), atol=1e-4, rtol=1e-3)
