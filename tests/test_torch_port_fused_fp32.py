"""The fp32 forms of kernels D, E and F (ops/conv3d.py:
conv3d_same_affine_fp32, conv3d_same_dual_stats_fp32; ops/fused_norm.py:
channel_stats_fp32, affine_lrelu_fp32; ops/seghead.py: seghead_fp32) on the
CPU, where each takes its plain version in fp32, against the JAX package's
Pallas kernels 6-8 built at fp32 in interpret mode (the JAX package builds
its fused kernels in the model's dtype, ops/packed_unet.py:631-656), at the
Task003 Liver net's stage-0 width (32 channels) and at ragged ones; and the
fused route taking an fp32 network under both switches.

Tolerances are tests/test_torch_port_fused_kernels.py's, fp32 on both sides:
D's output atol 3e-4, rtol 1e-3, its stats atol 1e-3, rtol 1e-4; E's stats
rtol 1e-5, atol 1e-3 and its apply atol 2e-4; F atol 2e-4, rtol 1e-3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.ops import packed_conv as pc
from multitalent_tpu.ops.pallas_conv import pallas_conv3d_same_affine
from multitalent_tpu.ops.pallas_seghead import seghead_d2s
from multitalent_tpu_torch.models.blocks import fp32_forms
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import fused_norm as fn
from multitalent_tpu_torch.ops import seghead as sg
from multitalent_tpu_torch.ops.fused_unet import (make_inference_forward, make_train_forward,
                                                  unet_forward_fused)

from test_torch_port_fused_kernels import SLOPE, _affine_inputs, _t, _torch_weight

WRAPPERS = {"conv3d_same_affine_fp32": cv.conv3d_same_affine_fp32,
            "channel_stats_fp32": fn.channel_stats_fp32,
            "affine_lrelu_fp32": fn.affine_lrelu_fp32, "seghead_fp32": sg.seghead_fp32,
            "conv3d_same_fp32": cv.conv3d_same_fp32,
            "conv3d_same_wgrad_fp32": cv.conv3d_same_wgrad_fp32}
KERNELS_BF16 = (cv.conv3d_same_affine, fn.channel_stats, fn.affine_lrelu, sg.seghead)


def _launches():
    return [w.launches for w in (*WRAPPERS.values(), *KERNELS_BF16)]


@pytest.mark.parametrize("shape,cout,affine", [
    ((2, 4, 8, 8, 32), 32, True),     # the Liver's stage 0, N=2, with the prologue
    ((2, 4, 8, 8, 32), 32, False),
    ((1, 4, 8, 16, 13), 47, True),    # odd widths
])
def test_conv3d_same_affine_fp32_matches_pallas_at_fp32(monkeypatch, shape, cout, affine):
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    x, w, b, s, t = _affine_inputs(np.random.RandomState(31), shape, cout)
    w *= 0.1
    t += 2.0  # lrelu(shift) far from 0: the halo must stay 0
    kw = dict(in_scale=jnp.asarray(s), in_shift=jnp.asarray(t)) if affine else {}
    ref_out, ref_stats = pallas_conv3d_same_affine(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), negative_slope=SLOPE,
        interpret=True, **kw)
    assert ref_out.dtype == jnp.float32
    pw = cv.prepare_conv3d_weight(_torch_weight(w), dtype=torch.float32)
    before = _launches()
    out, stats = cv.conv3d_same_affine_fp32(_t(x), pw, _t(b), _t(s) if affine else None,
                                            _t(t) if affine else None, SLOPE)
    routed = cv.conv3d_same_affine(_t(x), pw, _t(b), _t(s) if affine else None,
                                   _t(t) if affine else None, SLOPE)
    assert _launches() == before  # the plain version on the CPU, no launch counted
    assert out.dtype == stats.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3, rtol=1e-4)
    assert torch.equal(routed[0], out) and torch.equal(routed[1], stats)


@pytest.mark.parametrize("ca,cb", [(32, 32), (20, 12)])
def test_conv3d_same_dual_stats_fp32_matches_pallas_on_the_concat(monkeypatch, ca, cb):
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    rng = np.random.RandomState(32)
    a = rng.randn(2, 4, 8, 8, ca).astype(np.float32)
    b = rng.randn(2, 4, 8, 8, cb).astype(np.float32)
    w = (rng.randn(3, 3, 3, ca + cb, 32) * 0.1).astype(np.float32)
    bias = rng.randn(32).astype(np.float32)
    ref_out, ref_stats = pallas_conv3d_same_affine(
        jnp.concatenate([a, b], -1), jnp.asarray(w), bias=jnp.asarray(bias), interpret=True)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), splits=(ca, cb), dtype=torch.float32)
    out, stats = cv.conv3d_same_dual_stats_fp32(_t(a), _t(b), pw, _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3, rtol=1e-4)
    # into the caller's NaN-filled buffers
    o, st = torch.full_like(out, float("nan")), torch.full_like(stats, float("nan"))
    got = cv.conv3d_same_dual_stats_fp32(_t(a), _t(b), pw, _t(bias), out=o, stats=st)
    assert got[0] is o and got[1] is st and torch.equal(o, out) and torch.equal(st, stats)


@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 32), (1, 5, 6, 7, 30), (2, 37, 5)])
def test_kernel_e_fp32_matches_packed_conv_at_fp32(shape):
    """E's stats and its apply (the fused chain's materialize: the per-sample
    affine from the stats, lrelu) vs packed_conv.py:601-646 in fp32."""
    rng = np.random.RandomState(33)
    x = (rng.randn(*shape) * 3 + 1).astype(np.float32)
    c = shape[-1]
    w, b = (rng.rand(c) + 0.5).astype(np.float32), rng.randn(c).astype(np.float32)
    stats = fn.channel_stats_fp32(_t(x))
    ref_stats = pc.channel_stats(jnp.asarray(x))
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), rtol=1e-5, atol=1e-3)
    assert torch.equal(fn.channel_stats(_t(x)), stats)
    nvox = int(np.prod(shape[1:-1]))
    sc, sh = fn.stats_affine(stats, _t(w), _t(b), nvox=nvox)
    got = fn.affine_lrelu_fp32(_t(x), sc.contiguous(), sh.contiguous(), SLOPE)
    ref = pc.normalize_from_stats(jnp.asarray(x), ref_stats, jnp.asarray(w), jnp.asarray(b),
                                  factors=(1, 1), negative_slope=SLOPE)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    # both rounding orders of the bf16 form are the one order in fp32
    for cast_first in (True, False):
        assert torch.equal(fn.affine_lrelu(_t(x), sc.contiguous(), sh.contiguous(), SLOPE,
                                           cast_first), got)


# (C, K, prologue, bias, output dtype, input shape): the Liver's head and the
# flagship's, one output, a full output group of 8, each without the
# prologue, without a bias, with a bf16 output, and a ragged volume
SEGHEAD_FP32_CASES = [
    pytest.param(32, 3, True, True, torch.float32, (2, 4, 6, 8), id="32-3"),
    pytest.param(30, 47, True, True, torch.float32, (2, 4, 6, 8), id="30-47"),
    pytest.param(8, 1, True, True, torch.float32, (2, 4, 6, 8), id="8-1"),
    pytest.param(64, 8, True, True, torch.float32, (2, 4, 6, 8), id="64-8"),
    pytest.param(32, 3, False, True, torch.float32, (2, 4, 6, 8), id="32-3-no-prologue"),
    pytest.param(30, 47, False, True, torch.float32, (2, 4, 6, 8), id="30-47-no-prologue"),
    pytest.param(8, 1, False, False, torch.float32, (2, 4, 6, 8), id="8-1-no-prologue-no-bias"),
    pytest.param(64, 8, True, False, torch.float32, (2, 4, 6, 8), id="64-8-no-bias"),
    pytest.param(30, 47, True, True, torch.bfloat16, (2, 4, 6, 8), id="30-47-bf16-out"),
    pytest.param(32, 3, True, True, torch.float32, (2, 3, 5, 7), id="32-3-ragged"),
    pytest.param(30, 47, False, False, torch.bfloat16, (2, 3, 5, 7),
                 id="30-47-ragged-bf16-out-no-bias"),
]


@pytest.mark.parametrize("c,k,affine,with_bias,out_dtype,shape", SEGHEAD_FP32_CASES)
def test_seghead_fp32_matches_pallas_seghead_at_fp32(c, k, affine, with_bias, out_dtype, shape):
    """F's fp32 form, with the prologue and without, with a bias and
    without, to fp32 or bf16 logits, unpacked (factors (1, 1)). The Pallas
    kernel takes Y and X in blocks of 4-24 and 8-32, so a ragged volume runs
    it zero-padded to Y = X = 8 and crops its output (the head is pointwise).
    A bf16 output may round one ulp apart where the fp32 sums, taken in
    another order, straddle a rounding boundary: rtol 2^-7."""
    rng = np.random.RandomState(34)
    n, sp = shape[0], shape[1:]
    x = rng.randn(n, *sp, c).astype(np.float32)
    w = rng.randn(1, 1, 1, c, k).astype(np.float32)
    b = rng.randn(k).astype(np.float32) if with_bias else None
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    t = rng.randn(n, c).astype(np.float32)
    pad = [(0, 0), (0, 0)] + [(0, -d % 8 if d % 2 else 0) for d in sp[1:]] + [(0, 0)]
    kw = dict(in_scale=jnp.asarray(s), in_shift=jnp.asarray(t)) if affine else {}
    ref = seghead_d2s(jnp.asarray(np.pad(x, pad)), jnp.asarray(w),
                      None if b is None else jnp.asarray(b), factors=(1, 1),
                      negative_slope=SLOPE, interpret=True, **kw)
    ref = np.asarray(ref)[:, :sp[0], :sp[1], :sp[2]]
    head = _t(w[0, 0, 0].T.reshape(k, c, 1, 1, 1))
    args = (_t(x), head, None if b is None else _t(b), _t(s) if affine else None,
            _t(t) if affine else None, SLOPE, out_dtype)
    got = sg.seghead_fp32(*args)
    assert got.dtype == out_dtype and got.shape == (n, k, *sp) and got.is_contiguous()
    tol = dict(atol=2e-4, rtol=1e-3) if out_dtype == torch.float32 else dict(atol=2e-4,
                                                                             rtol=2 ** -7)
    np.testing.assert_allclose(np.moveaxis(got.float().numpy(), 1, -1), ref, **tol)
    assert torch.equal(sg.seghead(*args), got)
    w32 = sg.prepare_head_weight(head, dtype=torch.float32)
    assert w32.dtype == torch.float32 and torch.equal(w32[:k, :c], head[:, :, 0, 0, 0])
    assert not w32[k:].any() and not w32[:, c:].any()


def test_fused_route_takes_an_fp32_network_under_both_switches(monkeypatch):
    """Neither switch refuses or warns for an fp32 GenericUNet: the route
    runs (here on the plain versions) and names, through fp32_forms, only
    kernels whose fp32 wrappers exist."""
    torch.manual_seed(0)
    net = GenericUNet(1, 8, 3, [[2, 2, 2], [1, 2, 2]], [[3, 3, 3]] * 3, dtype=torch.float32)
    x = torch.randn(2, 1, 8, 16, 16)
    for switch, make in (("MTTPU_FUSED_NORM", make_inference_forward),
                         ("MTTPU_FUSED_TRAIN", make_train_forward)):
        monkeypatch.setenv(switch, "1")
        forward = make(net)
        assert forward is not net
        out = forward(x)
        assert out.dtype == torch.float32 and out.shape == (2, 3, 8, 16, 16)
        assert torch.isfinite(out).all()
        monkeypatch.delenv(switch)
    with torch.no_grad():
        np.testing.assert_allclose(unet_forward_fused(net, x).numpy(), net(x).numpy(),
                                   atol=1e-4, rtol=1e-3)
    names = {**fp32_forms(net.fused_kernel_launches_per_forward()),
             **fp32_forms(net.fused_kernel_launches_per_step())}
    assert set(names) <= set(WRAPPERS), names
    assert names["conv3d_same_affine_fp32"] > 0 and names["seghead_fp32"] == 1
