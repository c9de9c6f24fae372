"""The port's fused-chain kernels D, E and F on the CPU against the JAX
package's Pallas kernels 6-8 in interpret mode (their plain versions run here,
through the wrappers, which take them for CPU tensors), and kernel D's
autograd function against jax.grad of conv3d_same_affine_fast.

Tolerances are those of tests/test_pallas_ops.py for the same oracles, fp32
on both sides, summed in different orders:
- kernel D's output: atol 3e-4, rtol 1e-3; its stats (sums over up to 1024
  voxels of values up to ~30): rtol 1e-4 with atol 1e-3;
- kernel E: atol 2e-4 in fp32; bf16 in (fp32 stats, one cast at the end):
  one bf16 ulp (2^-8 relative) plus 1e-6;
- kernel F: atol 2e-4, rtol 1e-3;
- Conv3dSameAffine: the value rtol 1e-5, gradients atol 2e-3, rtol 1e-3.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.ops import packed_conv as pc
from multitalent_tpu.ops.fused_norm import fused_instance_norm_lrelu as jax_fused_norm
from multitalent_tpu.ops.pallas_conv import conv3d_same_affine_fast, pallas_conv3d_same_affine
from multitalent_tpu.ops.pallas_seghead import seghead_d2s
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import fused_norm as fn
from multitalent_tpu_torch.ops import seghead as sg

SLOPE = 1e-2


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _torch_weight(w_dhwio: np.ndarray) -> torch.Tensor:
    """flax (kz, ky, kx, I, O) -> torch Conv3d (O, I, kz, ky, kx)"""
    return _t(w_dhwio.transpose(4, 3, 0, 1, 2))


def _affine_inputs(rng, shape, cout):
    n, c = shape[0], shape[-1]
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(3, 3, 3, c, cout).astype(np.float32)
    b = rng.randn(cout).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    t = rng.randn(n, c).astype(np.float32)
    return x, w, b, s, t


@pytest.mark.parametrize("shape,cout", [((2, 4, 8, 16, 5), 7), ((1, 4, 8, 8, 20), 12)])
def test_conv3d_same_affine_matches_pallas_conv_affine_kernel(monkeypatch, shape, cout):
    """Kernel D vs pallas_conv.py:_conv_affine_kernel: the output and its
    stats, with the normalize prologue and without; Cin != Cout and a ragged
    C (20: one full and one partial 16-channel chunk of kernel D)."""
    # the Pallas entry routes C below 32 away from the kernel on the TPU
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    x, w, b, s, t = _affine_inputs(np.random.RandomState(13), shape, cout)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), dtype=torch.float32)
    for affine in (True, False):
        kw = dict(in_scale=jnp.asarray(s), in_shift=jnp.asarray(t)) if affine else {}
        ref_out, ref_stats = pallas_conv3d_same_affine(
            jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), negative_slope=SLOPE,
            interpret=True, **kw)
        out, stats = cv.conv3d_same_affine(_t(x), pw, _t(b), _t(s) if affine else None,
                                           _t(t) if affine else None, SLOPE)
        assert out.shape == (*shape[:4], cout) and stats.shape == (shape[0], 2, cout)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
        np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3,
                                   rtol=1e-4)


def test_conv3d_same_dual_stats_matches_pallas_on_the_concat(monkeypatch):
    """Kernel D's dual form (a decoder's first conv) vs the Pallas kernel
    without a prologue on the built concat; unequal groups catch a swapped
    [up | skip] order."""
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    rng = np.random.RandomState(14)
    a = rng.randn(2, 4, 8, 8, 6).astype(np.float32)
    b = rng.randn(2, 4, 8, 8, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 9, 5) * 0.3).astype(np.float32)
    bias = rng.randn(5).astype(np.float32)
    ref_out, ref_stats = pallas_conv3d_same_affine(
        jnp.concatenate([a, b], -1), jnp.asarray(w), bias=jnp.asarray(bias), interpret=True)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), splits=(6, 3), dtype=torch.float32)
    out, stats = cv.conv3d_same_dual_stats(_t(a), _t(b), pw, _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3, rtol=1e-4)
    swapped, _ = cv.conv3d_same_dual_stats_ref(_t(b), _t(a), _torch_weight(w), _t(bias))
    assert np.abs(swapped.numpy() - np.asarray(ref_out)).max() > 1e-2


@pytest.mark.parametrize("n", [1, 2])
def test_conv3d_same_affine_matches_pallas_at_30_channels(monkeypatch, n):
    """Kernel D at the stage-0 width (one full and one 14-channel chunk,
    which the card stages at once) vs pallas_conv3d_same_affine with a shift
    of +8: lrelu(shift) is far from 0, so a plain version that normalized the
    SAME halo would miss the Pallas kernel at every face of the volume."""
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    x, w, b, s, t = _affine_inputs(np.random.RandomState(15), (n, 4, 8, 8, 30), 30)
    w *= 0.1
    t += 8.0
    pw = cv.prepare_conv3d_weight(_torch_weight(w), dtype=torch.float32)
    ref_out, ref_stats = pallas_conv3d_same_affine(
        jnp.asarray(x), jnp.asarray(w), bias=jnp.asarray(b), in_scale=jnp.asarray(s),
        in_shift=jnp.asarray(t), negative_slope=SLOPE, interpret=True)
    out, stats = cv.conv3d_same_affine(_t(x), pw, _t(b), _t(s), _t(t), SLOPE)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("ca,cb", [(30, 30), (16, 14)])
def test_conv3d_same_dual_stats_matches_pallas_at_the_ring_widths(monkeypatch, ca, cb):
    """Kernel D's dual form at the widths the card stages two 17-32-channel
    rows at once (30 + 30) and at a full chunk beside a partial one (16 + 14),
    vs the Pallas kernel without a prologue on the built concat."""
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    rng = np.random.RandomState(16)
    a = rng.randn(2, 4, 8, 8, ca).astype(np.float32)
    b = rng.randn(2, 4, 8, 8, cb).astype(np.float32)
    w = (rng.randn(3, 3, 3, ca + cb, 30) * 0.1).astype(np.float32)
    bias = rng.randn(30).astype(np.float32)
    ref_out, ref_stats = pallas_conv3d_same_affine(
        jnp.concatenate([a, b], -1), jnp.asarray(w), bias=jnp.asarray(bias), interpret=True)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), splits=(ca, cb), dtype=torch.float32)
    out, stats = cv.conv3d_same_dual_stats(_t(a), _t(b), pw, _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("ca,cb,cout", [(16, 16, 16), (24, 40, 32), (120, 120, 120)])
def test_conv3d_same_dual_stats_matches_pallas_at_16_byte_rows(monkeypatch, ca, cb, cout):
    """Kernel D's dual form at widths whose rows take 16-byte copies (each
    input's C % 8 == 0: on the card the wgmma body or the ring, by its plan)
    vs the Pallas kernel without a prologue on the built concat, at N=2 and
    a 4x6x10 volume. The Pallas kernel takes X in blocks of 8 or 16, so it
    runs on the volume zero-padded to X = 16 (the SAME padding's zeros) and
    its output is cropped; the stats are those of the cropped output."""
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    rng = np.random.RandomState(19)
    a = rng.randn(2, 4, 6, 10, ca).astype(np.float32)
    b = rng.randn(2, 4, 6, 10, cb).astype(np.float32)
    w = (rng.randn(3, 3, 3, ca + cb, cout) * (2.0 / (27 * (ca + cb))) ** 0.5).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    cat = np.pad(np.concatenate([a, b], -1), ((0, 0),) * 3 + ((0, 6), (0, 0)))
    ref_out, _ = pallas_conv3d_same_affine(jnp.asarray(cat), jnp.asarray(w),
                                           bias=jnp.asarray(bias), interpret=True)
    ref_out = np.asarray(ref_out)[:, :, :, :10]
    ref_stats = np.stack([ref_out.sum((1, 2, 3)), (ref_out.astype(np.float64) ** 2).sum(
        (1, 2, 3))], 1)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), splits=(ca, cb), dtype=torch.float32)
    out, stats = cv.conv3d_same_dual_stats(_t(a), _t(b), pw, _t(bias))
    assert out.shape == (2, 4, 6, 10, cout) and stats.shape == (2, 2, cout)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), ref_stats, atol=1e-3, rtol=1e-4)


def test_fused_wrappers_write_into_the_callers_buffers():
    """out= and stats= of kernel D (both forms) and kernel B on the CPU: the
    plain version's result lands in the caller's NaN-filled buffers, which
    come back; a buffer of another shape is refused."""
    rng = np.random.RandomState(18)
    x = _t(rng.randn(2, 3, 4, 5, 6).astype(np.float32))
    y = _t(rng.randn(2, 3, 4, 5, 4).astype(np.float32))
    pw = cv.prepare_conv3d_weight(_t(rng.randn(7, 6, 3, 3, 3).astype(np.float32)),
                                  dtype=torch.float32)
    pw2 = cv.prepare_conv3d_weight(_t(rng.randn(7, 10, 3, 3, 3).astype(np.float32)), (6, 4),
                                   dtype=torch.float32)
    s = _t((rng.rand(2, 6) + 0.5).astype(np.float32))
    calls = {
        "d": (lambda **kw: cv.conv3d_same_affine(x, pw, None, s, s, SLOPE, **kw),
              cv.conv3d_same_affine_ref(x, cv.unprepare_conv3d_weight(pw), None, s, s, SLOPE)),
        "d_dual": (lambda **kw: cv.conv3d_same_dual_stats(x, y, pw2, **kw),
                   cv.conv3d_same_dual_stats_ref(x, y, cv.unprepare_conv3d_weight(pw2))),
    }
    for name, (call, (ref, ref_stats)) in calls.items():
        out = torch.full((2, 3, 4, 5, 7), float("nan"))
        stats = torch.full((2, 2, 7), float("nan"))
        got, got_stats = call(out=out, stats=stats)
        assert got is out and got_stats is stats, name
        assert torch.equal(out, ref) and torch.equal(stats, ref_stats), name
        with pytest.raises(ValueError):
            call(out=torch.empty(2, 3, 4, 5, 6))
    out = torch.full((2, 3, 4, 5, 7), float("nan"))
    assert cv.conv3d_same_dual(x, y, pw2, out=out) is out
    assert torch.equal(out, cv.conv3d_same_dual_ref(x, y, cv.unprepare_conv3d_weight(pw2)))


@pytest.mark.parametrize("shape", [(2, 4, 8, 8, 6), (1, 40, 24, 3), (2, 37, 5)])
def test_fused_instance_norm_matches_pallas_fused_norm(shape):
    """Kernel E (stats, then apply with the activation in fp32) vs
    fused_norm.py's two Pallas kernels (test_fused_norm_matches_reference's
    shapes and inputs)."""
    rng = np.random.RandomState(0)
    x = rng.randn(*shape).astype(np.float32) * 3 + 1
    c = shape[-1]
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    ref = jax_fused_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                         interpret=True)
    got = fn.fused_instance_norm_lrelu(_t(x), _t(scale), _t(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_fused_instance_norm_bf16_in_fp32_stats():
    rng = np.random.RandomState(1)
    x = (rng.randn(1, 16, 16, 8) * 2).astype(jnp.bfloat16)
    scale, bias = np.ones(8, np.float32), np.zeros(8, np.float32)
    ref = np.asarray(jax_fused_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                                    interpret=True), np.float32)
    got = fn.fused_instance_norm_lrelu(_t(np.asarray(x, np.float32)).to(torch.bfloat16),
                                       _t(scale), _t(bias))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    assert (err <= 2 ** -8 * np.abs(ref) + 1e-6).all(), err.max()


def test_stats_and_normalize_match_packed_conv_helpers():
    """The fused chain's stats, per-sample affine and materialize (kernel E,
    cast before the activation) vs packed_conv.py:601-646 at one phase."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 4, 6, 8, 7) * 3 + 1).astype(np.float32)
    w, b = (rng.rand(7) + 0.5).astype(np.float32), rng.randn(7).astype(np.float32)
    stats = fn.channel_stats(_t(x))
    ref_stats = pc.channel_stats(jnp.asarray(x))
    np.testing.assert_allclose(stats.numpy(), np.asarray(ref_stats), rtol=1e-5, atol=1e-3)
    sc, sh = fn.stats_affine(stats, _t(w), _t(b), nvox=4 * 6 * 8)
    ref_sc, ref_sh = pc.stats_affine(ref_stats, jnp.asarray(w), jnp.asarray(b),
                                     factors=(1, 1), nvox=4 * 6 * 8)
    np.testing.assert_allclose(sc.numpy(), np.asarray(ref_sc), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(sh.numpy(), np.asarray(ref_sh), rtol=1e-5, atol=1e-6)
    got = fn.normalize_from_stats(_t(x), stats, _t(w), _t(b), SLOPE)
    ref = pc.normalize_from_stats(jnp.asarray(x), ref_stats, jnp.asarray(w), jnp.asarray(b),
                                  factors=(1, 1), negative_slope=SLOPE)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("factors,shape,c,k", [((2, 2), (1, 8, 16, 16), 12, 5),
                                               ((1, 2), (2, 4, 12, 8), 24, 47)])
def test_seghead_matches_pallas_seghead(factors, shape, c, k):
    """Kernel F vs pallas_seghead.py:_kernel (the cases of
    test_pallas_seghead_d2s_interpret_matches_reference) with the normalize
    prologue, through space_to_depth_yx: the port reads the unpacked tensor
    and writes NCDHW, the Pallas kernel reads the packed one and writes voxel
    order."""
    rng = np.random.RandomState(12)
    n, p = shape[0], pc.nphases(factors)
    # the unpacked tensor whose (factors) packing has the case's shape
    x = rng.randn(n, shape[1], shape[2] * factors[0], shape[3] * factors[1], c
                  ).astype(np.float32)
    w = rng.randn(1, 1, 1, c, k).astype(np.float32)
    b = rng.randn(k).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    t = rng.randn(n, c).astype(np.float32)
    ref = seghead_d2s(pc.space_to_depth_yx(jnp.asarray(x), factors), jnp.asarray(w),
                      jnp.asarray(b), factors=factors, in_scale=jnp.tile(s, (1, p)),
                      in_shift=jnp.tile(t, (1, p)), negative_slope=SLOPE, interpret=True)
    head = _t(w[0, 0, 0].T.reshape(k, c, 1, 1, 1))
    got = sg.seghead(_t(x), head, _t(b), _t(s), _t(t), SLOPE, torch.float32)
    assert got.shape == (n, k, *x.shape[1:4]) and got.is_contiguous()
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               atol=2e-4, rtol=1e-3)


def test_conv3d_same_affine_autograd_matches_jax_custom_vjp():
    """Conv3dSameAffine's values and gradients w.r.t. x, w, b, scale and shift,
    gradients flowing through the stats too, vs jax.grad of
    conv3d_same_affine_fast (its custom VJP, pallas_conv.py:593-639), at the
    shapes of test_conv_affine_fast_custom_vjp_matches_autodiff; and without
    the prologue."""
    rng = np.random.RandomState(17)
    n, c, co = 2, 5, 7
    x = rng.randn(n, 4, 8, 8, c).astype(np.float32)
    w = (rng.randn(3, 3, 3, c, co) * 0.3).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    t = rng.randn(n, c).astype(np.float32)
    go = rng.randn(n, 4, 8, 8, co).astype(np.float32)
    gs = (rng.randn(n, 2, co) * 0.01).astype(np.float32)

    for affine in (True, False):
        def jax_loss(x_, w_, b_, s_, t_):
            out, stats = conv3d_same_affine_fast(x_, w_, b_, s_ if affine else None,
                                                 t_ if affine else None, SLOPE)
            return jnp.sum(out * go) + jnp.sum(stats * gs)

        args = [jnp.asarray(v) for v in (x, w, b, s, t)]
        argnums = (0, 1, 2, 3, 4) if affine else (0, 1, 2)
        val, grads = jax.value_and_grad(jax_loss, argnums=argnums)(*args)
        # w stays in the flax layout (kz, ky, kx, I, O), so its gradient
        # compares directly; the conv takes the permuted view
        leaves = [_t(v).requires_grad_(True) for v in (x, w, b, s, t)]
        xt, wt, bt, st, tt = leaves
        out, stats = cv.conv3d_same_affine_op(xt, wt.permute(4, 3, 0, 1, 2), bt,
                                              st if affine else None,
                                              tt if affine else None, SLOPE)
        loss = (out * _t(go)).sum() + (stats * _t(gs)).sum()
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
        for i, name in zip(argnums, "xwbst"):
            np.testing.assert_allclose(leaves[i].grad.numpy(), np.asarray(grads[i]),
                                       atol=2e-3, rtol=1e-3, err_msg=f"grad {name}")
        if not affine:
            assert st.grad is None and tt.grad is None


def test_fused_wrappers_count_only_kernel_launches():
    """CPU tensors take the plain versions without counting a launch; other
    devices raise, also without counting."""
    counters = (cv.conv3d_same_affine, fn.channel_stats, fn.affine_lrelu, sg.seghead)
    before = [k.launches for k in counters]
    x = torch.zeros(1, 4, 4, 4, 8)
    pw = cv.prepare_conv3d_weight(torch.zeros(8, 8, 3, 3, 3), dtype=torch.float32)
    s = torch.ones(1, 8)
    cv.conv3d_same_affine(x, pw, None, s, s)
    cv.conv3d_same_dual_stats(x, x, cv.prepare_conv3d_weight(
        torch.zeros(8, 16, 3, 3, 3), (8, 8), dtype=torch.float32))
    fn.affine_lrelu(x, s, s)
    fn.channel_stats(x)
    sg.seghead(x, torch.zeros(3, 8, 1, 1, 1), None, s, s)
    meta = x.to("meta")
    for call in (lambda: cv.conv3d_same_affine(meta, pw), lambda: fn.channel_stats(meta),
                 lambda: fn.affine_lrelu(meta, s, s),
                 lambda: sg.seghead(meta, torch.zeros(3, 8, 1, 1, 1))):
        with pytest.raises(ValueError, match="unsupported device"):
            call()
    assert [k.launches for k in counters] == before


@pytest.mark.parametrize("k,c", [(47, 30), (1, 8), (5, 12), (64, 60), (47, 69), (100, 128)])
def test_prepared_head_weight_pads_with_zeros_and_rounds_as_the_head_matrix(k, c):
    """Kernel F's weight operand: the (K, C) head matrix in bf16, rounded as
    _head_matrix rounds it, padded to (K rounded up to 16, 16/32/64/128)
    with exact zeros (padding channels meet only zero activations, padding
    rows are never stored, but a NaN there would still spread)."""
    w = _t((np.random.RandomState(k + c).randn(k, c, 1, 1, 1) * 0.3).astype(np.float32))
    got = sg.prepare_head_weight(w)
    kp, cp = -(-k // 16) * 16, sg.padded_channels(c)
    assert got.dtype == torch.bfloat16 and got.shape == (kp, cp) and cp >= c
    assert torch.equal(got[:k, :c], sg._head_matrix(w, torch.bfloat16))
    assert (got[k:] == 0).all() and (got[:, c:] == 0).all()
    assert not torch.signbit(got[k:]).any() and not torch.signbit(got[:, c:]).any()


def test_prepared_head_weight_is_built_once_per_weight_version():
    """The prepared weight is kept on the weight: a second call returns it,
    an in-place update (an optimizer step, a load_state_dict) rebuilds it
    from the new values."""
    w = torch.nn.Parameter(_t(np.random.RandomState(3).randn(47, 30, 1, 1, 1)
                              .astype(np.float32)))
    first = sg.prepared_head_weight(w, torch.device("cpu"))
    assert sg.prepared_head_weight(w, torch.device("cpu")) is first
    with torch.no_grad():
        w.mul_(-2.0)
    again = sg.prepared_head_weight(w, torch.device("cpu"))
    assert again is not first
    assert torch.equal(again, sg.prepare_head_weight(w))
    assert torch.equal(again[:47, :30], (-2.0 * first[:47, :30].float()).to(torch.bfloat16))


def test_seghead_ref_matches_pallas_seghead_at_the_flagship_widths():
    """Kernel F's plain version (the card's reference for the kernel) at the
    flagship head, 30 -> 47 channels, N = 2, with the normalize prologue, vs
    pallas_seghead.py:_kernel in interpret mode on the unpacked tensor
    (factors (1, 1))."""
    rng = np.random.RandomState(21)
    n, c, k = 2, 30, 47
    x = (rng.randn(n, 4, 8, 16, c) * 2).astype(np.float32)
    w = (rng.randn(1, 1, 1, c, k) * c ** -0.5).astype(np.float32)
    s = (rng.rand(n, c) + 0.5).astype(np.float32)
    t = rng.randn(n, c).astype(np.float32)
    ref = seghead_d2s(jnp.asarray(x), jnp.asarray(w), None, factors=(1, 1),
                      in_scale=jnp.asarray(s), in_shift=jnp.asarray(t), negative_slope=SLOPE,
                      interpret=True)
    got = sg.seghead_ref(_t(x), _t(w[0, 0, 0].T.reshape(k, c, 1, 1, 1)), None, _t(s), _t(t),
                         SLOPE, torch.float32)
    assert got.shape == (n, k, 4, 8, 16) and got.is_contiguous()
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), np.asarray(ref),
                               atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("shape", [(1, 3, 5, 7, 320), (2, 1, 3, 9, 320)])
def test_channel_stats_ref_matches_packed_conv_at_320_channels(shape):
    """Kernel E's stats' plain version (the card's reference for the kernel
    and for kernel D's split-K stats) at the deepest width, 320 channels, and
    an odd voxel count (105; 27), vs packed_conv.py:channel_stats."""
    x = (np.random.RandomState(5).randn(*shape) * 3 + 1).astype(np.float32)
    got = fn.channel_stats_ref(_t(x))
    assert got.shape == (shape[0], 2, 320)
    np.testing.assert_allclose(got.numpy(), np.asarray(pc.channel_stats(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
