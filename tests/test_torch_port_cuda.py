"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; on a machine without a card each
skips with its reason. This file imports no JAX, so it also runs where JAX is
not installed:

    python -m pytest tests/test_torch_port_cuda.py -q --noconftest -m cuda

(`--noconftest`: tests/conftest.py configures JAX for the CPU suite.)
"""
import numpy as np
import pytest
import torch

from multitalent_tpu_torch.ops import conv3d as cv

pytestmark = pytest.mark.cuda

# bf16 output of an fp32-accumulated conv vs an fp32 reference on the same
# bf16-rounded inputs: one bf16 rounding of the result (rel 2^-8) plus the
# reduction-order difference
RTOL, ATOL = 1e-2, 1e-2


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, shape, scale=1.0):
    return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))


def _assert_close(got, ref):
    err = (got.float() - ref.float()).abs().max().item()
    bound = ATOL + RTOL * ref.float().abs().max().item()
    assert err <= bound, (err, bound)


@pytest.mark.parametrize("shape,cout", [
    ((1, 6, 16, 32, 30), 30),     # stage-0 width, ragged C (2-channel loads)
    ((1, 5, 7, 19, 60), 60),      # ragged Z/Y/X
    ((2, 4, 8, 16, 120), 120),    # 8-channel loads, batch 2
    ((1, 6, 6, 6, 320), 320),     # deepest flagship stage (split K loop)
    ((1, 3, 5, 9, 13), 47),       # odd C (1-channel loads), 47 outputs
    ((1, 4, 4, 4, 64), 47),       # split K loop, odd Cout
    ((1, 2, 3, 40, 16), 16),      # flat volume: another box shape
])
def test_conv3d_same_matches_plain(device, shape, cout):
    rng = np.random.default_rng(0)
    x = _rand(rng, shape).to(device, torch.bfloat16)
    w = _rand(rng, (cout, shape[-1], 3, 3, 3), 0.1).to(device)
    b = _rand(rng, (cout,)).to(device)
    pw = cv.prepare_conv3d_weight(w)
    before = cv.conv3d_same.launches
    got = cv.conv3d_same(x, pw, b)
    torch.cuda.synchronize()
    assert cv.conv3d_same.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (*shape[:4], cout)
    ref = cv.conv3d_same_ref(x.float(), w.to(torch.bfloat16).float(), b)
    _assert_close(got, ref)


@pytest.mark.parametrize("ca,cb,cout,spatial", [
    (30, 30, 30, (4, 16, 16)),
    (20, 10, 16, (5, 9, 17)),     # unequal groups: a swapped order fails
    (60, 60, 60, (4, 8, 8)),
    (13, 7, 20, (3, 5, 6)),
])
def test_conv3d_same_dual_matches_plain(device, ca, cb, cout, spatial):
    rng = np.random.default_rng(1)
    a = _rand(rng, (1, *spatial, ca)).to(device, torch.bfloat16)
    b = _rand(rng, (1, *spatial, cb)).to(device, torch.bfloat16)
    w = _rand(rng, (cout, ca + cb, 3, 3, 3), 0.1).to(device)
    bias = _rand(rng, (cout,)).to(device)
    pw = cv.prepare_conv3d_weight(w, splits=(ca, cb))
    before = cv.conv3d_same_dual.launches
    got = cv.conv3d_same_dual(a, b, pw, bias)
    torch.cuda.synchronize()
    assert cv.conv3d_same_dual.launches == before + 1
    ref = cv.conv3d_same_dual_ref(a.float(), b.float(),
                                  w.to(torch.bfloat16).float(), bias)
    _assert_close(got, ref)


def test_wrappers_refuse_what_the_kernel_does_not_take(device):
    x = torch.zeros(1, 4, 4, 4, 16, device=device)
    pw = cv.prepare_conv3d_weight(torch.zeros(16, 16, 3, 3, 3, device=device))
    before = cv.conv3d_same.launches
    with pytest.raises(TypeError):
        cv.conv3d_same(x, pw)  # float32 input
    with pytest.raises(ValueError):
        cv.conv3d_same(x.to(torch.bfloat16).transpose(1, 2), pw)
    with pytest.raises(ValueError):
        cv.conv3d_same_dual(x.to(torch.bfloat16), x.to(torch.bfloat16), pw)
    assert cv.conv3d_same.launches == before


# kernel C: fp32 dw against the fp32 plain version on the same bf16 inputs;
# the sums over the voxels run in another order, so the bound is relative to
# max|dw| (see chip_smoke.DW_RTOL)
DW_RTOL = 1e-3


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 6, 16, 32), 30, 30),     # stage-0 width, ragged C, batch 2
    ((1, 5, 7, 19), 60, 60),      # ragged Z/Y/X
    ((1, 6, 6, 6), 320, 320),     # deepest flagship stage
    ((1, 3, 5, 9), 13, 47),       # odd C (1-channel loads), 47 outputs
])
def test_conv3d_same_wgrad_matches_plain(device, shape, cin, cout):
    rng = np.random.default_rng(2)
    x = _rand(rng, (*shape, cin)).to(device, torch.bfloat16)
    g = _rand(rng, (*shape, cout)).to(device, torch.bfloat16)
    before = cv.conv3d_same_wgrad.launches
    got = cv.conv3d_same_wgrad(x, g)
    torch.cuda.synchronize()
    assert cv.conv3d_same_wgrad.launches == before + 1
    assert got.dtype == torch.float32 and got.shape == (cout, cin, 3, 3, 3)
    ref = cv.conv3d_same_wgrad_ref(x.float(), g.float())
    assert (got - ref).abs().max().item() <= DW_RTOL * ref.abs().max().item()


@pytest.mark.parametrize("ca,cb,cout,shape", [
    (30, 30, 30, (2, 4, 16, 16)),
    (20, 10, 16, (1, 5, 9, 17)),  # unequal groups: a swapped order fails
    (13, 7, 20, (1, 3, 5, 6)),
])
def test_conv3d_same_wgrad_dual_matches_plain(device, ca, cb, cout, shape):
    rng = np.random.default_rng(3)
    a = _rand(rng, (*shape, ca)).to(device, torch.bfloat16)
    b = _rand(rng, (*shape, cb)).to(device, torch.bfloat16)
    g = _rand(rng, (*shape, cout)).to(device, torch.bfloat16)
    got = cv.conv3d_same_wgrad_dual(a, b, g)
    torch.cuda.synchronize()
    ref = cv.conv3d_same_wgrad_dual_ref(a.float(), b.float(), g.float())
    assert (got - ref).abs().max().item() <= DW_RTOL * ref.abs().max().item()


def test_training_step_through_the_kernels_matches_the_plain_path(device):
    """One forward + backward of a reduced flagship UNet in bf16 through
    kernels A, B and C: the kernels' launch counts are the per-step counts,
    and the gradients are no further from the fp32 plain path's than the bf16
    plain path's are. bf16 rounds every activation and every layer's output
    gradient, so each bf16 gradient sits ~15% (in norm) from fp32 here; the
    kernels only sum in other orders. Bounds: per parameter tensor 1.5x the
    plain bf16 path's distance, over all of them 1.25x (measured on the H100:
    at most 1.20x per tensor, 0.98-1.01x overall, two seeds). Conv biases are
    left out: the instance norm cancels them, their gradient is ~0 either
    way."""
    from multitalent_tpu_torch.models.generic_unet import GenericUNet
    pools, kernels = [[2, 2, 2], [2, 2, 2], [1, 2, 2]], [[3, 3, 3]] * 4
    torch.manual_seed(0)
    net = GenericUNet(1, 16, 47, pools, kernels, dtype=torch.bfloat16).to(device)
    net32 = GenericUNet(1, 16, 47, pools, kernels, dtype=torch.float32).to(device)
    net32.load_state_dict(net.state_dict())
    x = torch.randn(2, 1, 16, 32, 32, device=device)

    def grads(model, use_kernels):
        model.zero_grad()
        outs = model(x, use_kernels=use_kernels, deep_supervision=True)
        sum(o.square().mean() for o in outs).backward()
        return {k: p.grad.clone() for k, p in model.named_parameters()
                if p.grad is not None and not k.endswith("conv.bias")}

    counts = (cv.conv3d_same, cv.conv3d_same_dual, cv.conv3d_same_wgrad)
    before = [k.launches for k in counts]
    got = grads(net, True)
    torch.cuda.synchronize()
    per_step = net.kernel_launches_per_step()
    assert [k.launches - b for k, b in zip(counts, before)] == [
        per_step["conv3d_same"], per_step["conv3d_same_dual"], per_step["conv3d_same_wgrad"]]
    plain, ref = grads(net, False), grads(net32, False)
    assert got.keys() == plain.keys() == ref.keys()
    for k in ref:
        assert (got[k] - ref[k]).norm() <= 1.5 * (plain[k] - ref[k]).norm(), k

    def flat(g):
        return torch.cat([g[k].flatten() for k in ref])

    assert (flat(got) - flat(ref)).norm() <= 1.25 * (flat(plain) - flat(ref)).norm()


# kernel D: bf16 output of an fp32-accumulated conv, as kernel A (RTOL, ATOL);
# its stats are fp32 sums of that bf16 output in another order than the plain
# version's: relative to the sum of |terms| (STATS_RTOL). The prologue rounds
# x * scale + shift to bf16 in both; a term may round one bf16 ulp apart where
# the two fp32 results straddle a rounding boundary (FMA vs two roundings).
STATS_RTOL = 1e-3


def _stats_err(got, out_ref):
    """max |stats - plain stats| relative to the sums of |out| and out^2."""
    from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
    ref = channel_stats_ref(out_ref.float())
    scale = channel_stats_ref(out_ref.float().abs())
    return ((got - ref).abs() / (scale + 1e-6)).max().item()


@pytest.mark.parametrize("shape,cout,affine", [
    ((1, 6, 16, 32, 30), 30, True),     # stage-0 width, ragged C
    ((1, 96, 192, 192, 30), 30, True),  # the flagship's stage-0 shape
    ((2, 5, 7, 19, 60), 60, True),      # ragged Z/Y/X, batch 2
    ((2, 4, 8, 16, 120), 120, False),   # no prologue
    ((1, 6, 6, 6, 320), 320, True),     # deepest stage: split K, stats by E
    ((2, 3, 5, 9, 13), 47, True),       # odd C, 47 outputs
])
def test_conv3d_same_affine_matches_plain(device, shape, cout, affine):
    rng = np.random.default_rng(4)
    n, cin = shape[0], shape[-1]
    x = _rand(rng, shape, 2.0).to(device, torch.bfloat16)
    w = _rand(rng, (cout, cin, 3, 3, 3), 0.1).to(device)
    b = _rand(rng, (cout,)).to(device)
    sc = (_rand(rng, (n, cin)).abs() + 0.5).to(device) if affine else None
    sh = _rand(rng, (n, cin)).to(device) if affine else None
    pw = cv.prepare_conv3d_weight(w)
    before = cv.conv3d_same_affine.launches
    out, stats = cv.conv3d_same_affine(x, pw, b, sc, sh)
    torch.cuda.synchronize()
    assert cv.conv3d_same_affine.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == (*shape[:4], cout)
    assert stats.dtype == torch.float32 and stats.shape == (n, 2, cout)
    ref, _ = cv.conv3d_same_affine_ref(x.float().to(torch.bfloat16), w.to(torch.bfloat16),
                                       b, sc, sh)
    _assert_close(out, ref.float())
    # the stats are those of the kernel's own output
    assert _stats_err(stats, out) <= STATS_RTOL


@pytest.mark.parametrize("ca,cb,cout,spatial", [
    (30, 30, 30, (4, 16, 16)),
    (20, 10, 16, (5, 9, 17)),
    (320, 320, 320, (6, 12, 12)),   # split K: stats by E over the output
])
def test_conv3d_same_dual_stats_matches_plain(device, ca, cb, cout, spatial):
    rng = np.random.default_rng(5)
    a = _rand(rng, (2, *spatial, ca)).to(device, torch.bfloat16)
    b = _rand(rng, (2, *spatial, cb)).to(device, torch.bfloat16)
    w = _rand(rng, (cout, ca + cb, 3, 3, 3), 0.05).to(device)
    bias = _rand(rng, (cout,)).to(device)
    pw = cv.prepare_conv3d_weight(w, splits=(ca, cb))
    before = cv.conv3d_same_affine.launches
    out, stats = cv.conv3d_same_dual_stats(a, b, pw, bias)
    torch.cuda.synchronize()
    assert cv.conv3d_same_affine.launches == before + 1
    ref = cv.conv3d_same_dual_ref(a.float(), b.float(), w.to(torch.bfloat16).float(), bias)
    _assert_close(out, ref)
    assert _stats_err(stats, out) <= STATS_RTOL


@pytest.mark.parametrize("shape", [(1, 12, 24, 24, 30), (2, 5, 7, 9, 60), (1, 6, 6, 6, 320),
                                   (2, 3, 4, 5, 13), (1, 96, 192, 192, 30)])
def test_fused_norm_kernels_match_plain(device, shape):
    """Kernel E: stats (fp32 sums in another order: rtol 1e-4 of the sum of
    |terms|) and apply in both rounding orders (bf16 outputs, exact: the
    kernel rounds where the plain version does)."""
    from multitalent_tpu_torch.ops import fused_norm as fn
    rng = np.random.default_rng(6)
    n, c = shape[0], shape[-1]
    x = (_rand(rng, shape, 3.0) + 1).to(device, torch.bfloat16)
    before = (fn.channel_stats.launches, fn.affine_lrelu.launches)
    stats = fn.channel_stats(x)
    ref = fn.channel_stats_ref(x)
    scale = fn.channel_stats_ref(x.abs())
    assert ((stats - ref).abs() / scale).max().item() <= 1e-4
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    for cast_first in (True, False):
        got = fn.affine_lrelu(x, sc, sh, 1e-2, cast_first)
        want = fn.affine_lrelu_ref(x, sc, sh, 1e-2, cast_first)
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got, want), (got.float() - want.float()).abs().max().item()
    torch.cuda.synchronize()
    assert (fn.channel_stats.launches, fn.affine_lrelu.launches) == (before[0] + 1,
                                                                    before[1] + 2)


def test_fused_norm_kernels_take_a_2_byte_aligned_view(device):
    """A contiguous bf16 view at an odd element offset: kernel E's stats pass
    reads single channels instead of 4-byte pairs, its apply pass single
    elements instead of 16-byte vectors."""
    from multitalent_tpu_torch.ops import fused_norm as fn
    rng = np.random.default_rng(9)
    shape = (2, 5, 6, 7, 30)
    flat = _rand(rng, (1 + int(np.prod(shape)),), 3.0).to(device, torch.bfloat16)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 4 == 2
    stats = fn.channel_stats(x)
    assert ((stats - fn.channel_stats_ref(x)).abs()
            / fn.channel_stats_ref(x.abs())).max().item() <= 1e-4
    sc, sh = (_rand(rng, (2, 30)).abs() + 0.5).to(device), _rand(rng, (2, 30)).to(device)
    got = fn.affine_lrelu(x, sc, sh)
    assert torch.equal(got, fn.affine_lrelu_ref(x, sc, sh))


@pytest.mark.parametrize("shape,k,out_dtype,with_bias", [
    ((1, 8, 16, 16, 30), 47, torch.bfloat16, False),
    ((1, 96, 192, 192, 30), 47, torch.bfloat16, False),  # the flagship's stage-0 head
    ((2, 3, 5, 7, 12), 5, torch.float32, True),
])
def test_seghead_matches_plain(device, shape, k, out_dtype, with_bias):
    """Kernel F: fp32 sums of the same bf16 products in another order, one
    rounding to the output type."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(7)
    n, c = shape[0], shape[-1]
    x = _rand(rng, shape, 2.0).to(device, torch.bfloat16)
    w = _rand(rng, (k, c, 1, 1, 1), 0.3).to(device)
    b = _rand(rng, (k,)).to(device) if with_bias else None
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    before = sg.seghead.launches
    got = sg.seghead(x, w, b, sc, sh, 1e-2, out_dtype)
    torch.cuda.synchronize()
    assert sg.seghead.launches == before + 1
    assert got.dtype == out_dtype and got.shape == (n, k, *shape[1:4]) and got.is_contiguous()
    ref = sg.seghead_ref(x, w, b, sc, sh, 1e-2, torch.float32)
    _assert_close(got, ref)


def test_conv3d_same_affine_gradients_match_the_plain_composition(device):
    """Conv3dSameAffine's backward (kernels A and C plus the elementwise
    terms) against autograd through the plain composition, in bf16 on the
    card, gradients flowing through the stats too. Bounds relative to each
    gradient's max: bf16 rounds G, dY and y at the same points in both; only
    summation orders differ."""
    rng = np.random.default_rng(8)
    n, cin, cout, sp = 2, 30, 30, (6, 16, 16)
    x0 = _rand(rng, (n, *sp, cin), 2.0).to(device, torch.bfloat16)
    w0 = _rand(rng, (cout, cin, 3, 3, 3), 0.1).to(device)
    b0 = _rand(rng, (cout,), 0.1).to(device)
    s0 = (_rand(rng, (n, cin)).abs() + 0.5).to(device)
    t0 = _rand(rng, (n, cin)).to(device)
    go = _rand(rng, (n, *sp, cout)).to(device, torch.bfloat16)
    gs = _rand(rng, (n, 2, cout), 1e-3).to(device)

    def grads(fn):
        leaves = [t.clone().requires_grad_(True) for t in (x0, w0, b0, s0, t0)]
        out, stats = fn(*leaves)
        (out.float() * go.float()).sum().add_((stats * gs).sum()).backward()
        return [leaf.grad.float() for leaf in leaves]

    got = grads(lambda x, w, b, s, t: cv.conv3d_same_affine_op(x, w, b, s, t))
    ref = grads(lambda x, w, b, s, t: cv.conv3d_same_affine_ref(
        x, w.to(torch.bfloat16), b, s, t))
    for g, r, name in zip(got, ref, "xwbst"):
        assert (g - r).abs().max().item() <= 2e-2 * r.abs().max().item() + 1e-6, name
