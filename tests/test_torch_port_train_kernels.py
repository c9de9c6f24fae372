"""The backward of the port's kernel convs on the CPU: kernel C's plain version
against the JAX package's Pallas wgrad kernels (interpret mode), the dx rule
of kernel A against `conv3d_same_dx`, the autograd functions' gradient
checks, and the two repairs of the prepared-weight path (a stale cache after
an in-place update; no gradient reaching a kernel conv's weight and bias).

Tolerances: against Pallas, those of tests/test_pallas_ops.py (dw atol 2e-4,
rtol 1e-3 for the dense wgrad; atol 2e-3 through the merged path; dx atol
2e-4): fp32 on both sides, summed in different orders. Against the plain
path in the same package: rtol 1e-5, atol 1e-7 (the same fp32 arithmetic,
only the order of the dx and dw reductions differs). Gradient checks in
fp64 with torch's defaults.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from multitalent_tpu.ops import pallas_merged_conv as pmc
from multitalent_tpu.ops.packed_conv import depth_to_space_yx, pack_conv_weights
from multitalent_tpu.ops.pallas_conv import conv3d_same_dx, pallas_conv3d_same_wgrad
from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.ops import conv3d as cv


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _dhwio(dw: torch.Tensor) -> np.ndarray:
    """torch (Cout, Cin, kz, ky, kx) -> flax (kz, ky, kx, Cin, Cout)"""
    return dw.permute(2, 3, 4, 1, 0).numpy()


@pytest.mark.parametrize("shape,cout", [((2, 4, 8, 16, 5), 7), ((1, 16, 32, 32, 3), 4)])
def test_wgrad_matches_pallas_wgrad_kernel(shape, cout):
    """Kernel C (plain version through its wrapper) vs pallas_conv.py:
    _wgrad_kernel, the shapes of test_pallas_wgrad_interpret_matches_vjp."""
    rng = np.random.RandomState(11)
    x = rng.randn(*shape).astype(np.float32)
    g = rng.randn(*shape[:-1], cout).astype(np.float32)
    ref = np.asarray(pallas_conv3d_same_wgrad(jnp.asarray(x), jnp.asarray(g), interpret=True))
    got = cv.conv3d_same_wgrad(_t(x), _t(g))
    assert got.dtype == torch.float32 and got.shape == (cout, shape[-1], 3, 3, 3)
    np.testing.assert_allclose(_dhwio(got), ref, atol=2e-4, rtol=1e-3)


def test_wgrad_dual_matches_pallas_wgrad_on_the_concat():
    """Kernel C's dual form: rows [0, Ca) of dw from `a`, [Ca, Ca+Cb) from
    `b`; unequal groups catch a swapped order."""
    rng = np.random.RandomState(12)
    a = rng.randn(2, 4, 8, 16, 5).astype(np.float32)
    b = rng.randn(2, 4, 8, 16, 3).astype(np.float32)
    g = rng.randn(2, 4, 8, 16, 6).astype(np.float32)
    ref = np.asarray(pallas_conv3d_same_wgrad(jnp.concatenate([a, b], -1), jnp.asarray(g),
                                              interpret=True))
    got = cv.conv3d_same_wgrad_dual(_t(a), _t(b), _t(g))
    np.testing.assert_allclose(_dhwio(got), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("dual", [False, True])
def test_wgrad_writes_into_out(dual):
    """`out=`: the wrappers fill the caller's (NaN-filled) dw buffer, return
    it, and give what they return without one; a buffer of another shape is
    refused."""
    rng = np.random.RandomState(13)
    ins = [_t(rng.randn(1, 4, 8, 16, c).astype(np.float32)) for c in ((5, 3) if dual else (5,))]
    g = _t(rng.randn(1, 4, 8, 16, 4).astype(np.float32))
    fn = cv.conv3d_same_wgrad_dual if dual else cv.conv3d_same_wgrad
    want = fn(*ins, g)
    out = torch.full_like(want, float("nan"))
    assert fn(*ins, g, out=out) is out
    assert torch.equal(out, want)
    ref = np.asarray(pallas_conv3d_same_wgrad(jnp.concatenate([t.numpy() for t in ins], -1),
                                              jnp.asarray(g.numpy()), interpret=True))
    np.testing.assert_allclose(_dhwio(out), ref, atol=2e-4, rtol=1e-3)
    with pytest.raises(ValueError):
        fn(*ins, g, out=torch.empty(4, 7, 3, 3, 3))


def test_dx_matches_pallas_conv3d_same_dx():
    """dL/dx by kernel A on the flipped, transposed weight vs the JAX
    package's conv3d_same_dx (kernel 1 in interpret mode)."""
    rng = np.random.RandomState(13)
    g = rng.randn(1, 8, 16, 16, 8).astype(np.float32)
    w = rng.randn(3, 3, 3, 12, 8).astype(np.float32)  # DHWIO: Cin 12, Cout 8
    ref = np.asarray(conv3d_same_dx(jnp.asarray(g), jnp.asarray(w), interpret=True))
    got = cv.conv3d_same_dx(_t(g), _t(w.transpose(4, 3, 0, 1, 2)))
    assert got.shape == (1, 8, 16, 16, 12)
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("in_groups", [None, (20, 10)])
def test_wgrad_matches_the_merged_tap_backward(monkeypatch, in_groups):
    """Row 5 (pallas_merged_conv.py:_merged_wgrad_kernel): jax.grad of the
    (2,2)-packed stage-0 conv through the merged-tap backward
    (MTTPU_MERGED_BWD=1, interpret mode), as test_pallas_ops.py:171 runs it,
    against kernel C on the unpacked tensors; with in_groups the packed input
    is [group 0 | group 1], kernel C's dual form."""
    monkeypatch.setattr(pmc, "_TRAIN_INTERPRET", True)
    monkeypatch.setenv("MTTPU_MERGED_BWD", "1")
    rng = np.random.RandomState(23)
    cin, cout, f = 30, 24, (2, 2)
    x = jnp.asarray(rng.randn(1, 8, 16, 16, 4 * cin).astype(np.float32))
    w = jnp.asarray(rng.randn(3, 3, 3, cin, cout).astype(np.float32) * 0.1)
    g = jnp.asarray(rng.randn(1, 8, 16, 16, 4 * cout).astype(np.float32))

    def merged(wv):
        return pmc.conv3d_same_merged_train(x, pack_conv_weights(wv, f, in_groups), f, cin,
                                            in_groups)

    (dw_ref,) = jax.vjp(merged, w)[1](g)
    g_u = _t(depth_to_space_yx(g, f))
    if in_groups is None:
        got = cv.conv3d_same_wgrad(_t(depth_to_space_yx(x, f)), g_u)
    else:
        a = _t(depth_to_space_yx(x[..., :4 * in_groups[0]], f))
        b = _t(depth_to_space_yx(x[..., 4 * in_groups[0]:], f))
        got = cv.conv3d_same_wgrad_dual(a, b, g_u)
    np.testing.assert_allclose(_dhwio(got), np.asarray(dw_ref), atol=2e-3, rtol=1e-3)


def test_autograd_functions_pass_gradcheck():
    """Conv3dSame and Conv3dSameDual in fp64: dx, dw and db against finite
    differences."""
    gen = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64, requires_grad=True)

    x, w, b = rnd(1, 3, 4, 5, 3), rnd(2, 3, 3, 3, 3), rnd(2)
    assert torch.autograd.gradcheck(cv.conv3d_same_op, (x, w, b))
    a, bb, wd, bd = rnd(1, 3, 4, 4, 2), rnd(1, 3, 4, 4, 3), rnd(3, 5, 3, 3, 3), rnd(3)
    assert torch.autograd.gradcheck(cv.conv3d_same_dual_op, (a, bb, wd, bd))


def _flagship_reduced(dtype=torch.float32) -> GenericUNet:
    torch.manual_seed(0)
    net = GenericUNet(1, 4, 47, [[1, 2, 2], [2, 2, 2], [2, 2, 2]], [[3, 3, 3]] * 4,
                      dtype=dtype)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("bias"):
                p.normal_(0, 0.1, generator=torch.Generator().manual_seed(len(name)))
    return net


def test_in_place_weight_update_reaches_the_kernel_path():
    """Repair: the prepared-weight cache is keyed on the weight's version, so
    an in-place update (as an optimizer step makes) is seen by the next
    forward of the kernel path."""
    net = _flagship_reduced()
    x = torch.randn(1, 1, 8, 16, 16, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        net(x)  # fills the cache
        for m in net.modules():
            if isinstance(m, ConvDropoutNormNonlin) and m.kernel is not None:
                m.conv.weight.mul_(1.5).add_(0.01)
        np.testing.assert_allclose(net(x).numpy(), net(x, use_kernels=False).numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_kernel_convs_get_the_plain_paths_gradients():
    """Repair: with use_kernels=True the gradient reaches every kernel conv's
    weight and bias, equal to the plain path's; the same holds for the
    inputs (every other parameter)."""
    net = _flagship_reduced()
    x = torch.randn(2, 1, 8, 16, 16, generator=torch.Generator().manual_seed(2))

    def grads(use_kernels):
        net.zero_grad()
        net(x, use_kernels=use_kernels).square().mean().backward()
        return {k: p.grad.clone() for k, p in net.named_parameters() if p.grad is not None}

    got, ref = grads(True), grads(False)
    kernel_blocks = [n for n, m in net.named_modules()
                     if isinstance(m, ConvDropoutNormNonlin) and m.kernel is not None]
    assert len(kernel_blocks) == 8
    for name in kernel_blocks:
        for p in ("weight", "bias"):
            assert f"{name}.conv.{p}" in got, f"{name}.conv.{p}"
    assert got.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-7,
                                   err_msg=k)


def test_cpu_backward_does_not_count_as_launches():
    net = _flagship_reduced()
    before = (cv.conv3d_same.launches, cv.conv3d_same_dual.launches,
              cv.conv3d_same_wgrad.launches)
    net(torch.randn(1, 1, 8, 16, 16), deep_supervision=True)[0].sum().backward()
    assert (cv.conv3d_same.launches, cv.conv3d_same_dual.launches,
            cv.conv3d_same_wgrad.launches) == before
    # what a step launches on the card: A = 5 forward + 8 dx, B = 3, C = 8
    assert net.kernel_launches_per_step() == {"conv3d_same": 13, "conv3d_same_dual": 3,
                                              "conv3d_same_wgrad": 8}


def test_wgrad_wrappers_refuse_other_devices_without_counting():
    x = torch.zeros(1, 4, 4, 4, 8, device="meta", dtype=torch.bfloat16)
    before = cv.conv3d_same_wgrad.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cv.conv3d_same_wgrad(x, x)
    with pytest.raises(ValueError, match="unsupported device"):
        cv.conv3d_same_wgrad_dual(x, x, x)
    assert cv.conv3d_same_wgrad.launches == before
