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


def _nan_filled(shape, device):
    """An output buffer of NaN: a launch that leaves any of it unwritten fails
    the check that follows (fresh memory may already hold the right values)."""
    return torch.full(tuple(shape), float("nan"), dtype=torch.bfloat16, device=device)


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


# kernel A's body: persistent blocks on a ring of stages, weights resident or
# streamed, K split only where the tiles leave the card idle. (N, spatial,
# Cin, Cout): the flagship forward's six shapes at N=1 and N=2, the dual
# convs' dx at stages 0 and 1 (BN 64 with resident or streamed weights),
# ragged volumes where no box fits whole, and grids with fewer tiles than
# blocks (split K loops at 60, 240 and 320 channels)
A_FLAGSHIP = [(30, (96, 192, 192)), (60, (48, 96, 96)), (120, (24, 48, 48)),
              (240, (12, 24, 24)), (320, (6, 12, 12)), (320, (6, 6, 6))]
A_CASES = ([(n, sp, c, c) for n in (1, 2) for c, sp in A_FLAGSHIP]
           + [(2, (96, 192, 192), 30, 60), (2, (48, 96, 96), 60, 120)]
           + [(1, sp, c, c) for c in (30, 60, 120) for sp in ((7, 13, 11), (5, 9, 17))]
           + [(1, (4, 8, 8), 240, 240), (2, (1, 1, 1), 30, 30), (1, (3, 4, 5), 320, 320),
              (1, (4, 8, 8), 60, 60), (1, (5, 6, 7), 60, 47)])


@pytest.mark.parametrize("n,spatial,cin,cout", A_CASES)
def test_conv3d_same_body_matches_plain(device, n, spatial, cin, cout):
    """Kernel A into an output buffer filled with NaN (an unwritten voxel
    fails) against the plain version on the same bf16 input and weights, at
    phase 2's bound (chip_smoke.RTOL, ATOL)."""
    rng = np.random.default_rng(12)
    x = _rand(rng, (n, *spatial, cin)).to(device, torch.bfloat16)
    w = _rand(rng, (cout, cin, 3, 3, 3), (2 / (27 * cin)) ** 0.5).to(device)
    b = _rand(rng, (cout,), 0.1).to(device)
    out = _nan_filled((n, *spatial, cout), device)
    got = cv.conv3d_same(x, cv.prepare_conv3d_weight(w), b, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.isfinite(got).all()
    _assert_close(got, cv.conv3d_same_ref(x.float(), w.to(torch.bfloat16).float(), b))


@pytest.mark.parametrize("n,spatial,cin,cout", [
    (1, (96, 192, 192), 30, 30),   # resident weights, both chunks at once
    (2, (48, 96, 96), 60, 120),    # streamed weights, BN 64
    (1, (6, 6, 6), 320, 320),      # split K: partials and the reduce
    (1, (4, 8, 8), 60, 60),        # split K on the ring body
])
def test_conv3d_same_is_bit_equal_from_call_to_call(device, n, spatial, cin, cout):
    """No atomics: every output voxel is written by one block, or summed
    from the splits' partials in a fixed order."""
    rng = np.random.default_rng(13)
    x = _rand(rng, (n, *spatial, cin)).to(device, torch.bfloat16)
    pw = cv.prepare_conv3d_weight(_rand(rng, (cout, cin, 3, 3, 3), 0.05).to(device))
    b = _rand(rng, (cout,), 0.1).to(device)
    first, second = cv.conv3d_same(x, pw, b), cv.conv3d_same(x, pw, b)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("cin", [30, 60, 13])
def test_conv3d_same_padding_channels_stay_zero_beside_inf(device, cin):
    """Channels past the input's meet zero weight rows in shared memory; were
    they left holding another voxel's or chunk's values, an Inf there would
    turn 0 * Inf into NaN in outputs whose neighbourhood is finite. With Inf
    in voxels next to boxes' halos (and in the last channel), the kernel's
    non-finite outputs are exactly the plain version's, and the rest agree."""
    rng = np.random.default_rng(14)
    shape = (1, 9, 18, 18, cin)
    x = _rand(rng, shape).to(device, torch.bfloat16)
    for z, y, xx in ((4, 9, 9), (0, 0, 17), (8, 17, 0), (5, 8, 10)):
        x[0, z, y, xx, cin - 1] = float("inf")
        x[0, z, y, xx, 0] = float("-inf") if z % 2 else float("inf")
    w = _rand(rng, (cin, cin, 3, 3, 3), 0.1).to(device)
    got = cv.conv3d_same(x, cv.prepare_conv3d_weight(w), out=_nan_filled(shape, device))
    torch.cuda.synchronize()
    ref = cv.conv3d_same_ref(x.float(), w.to(torch.bfloat16).float())
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), finite)
    assert finite.sum() > 0.8 * finite.numel()
    _assert_close(got.float()[finite], ref[finite])


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 8, 16, 32), 30, 30),     # 30-channel rows: both chunks a block, split voxels
    ((1, 5, 7, 19), 60, 60),      # 8-byte copies of 60-channel rows, ragged
    ((2, 4, 8, 16), 120, 120),    # 16-byte copies
])
def test_conv3d_same_wgrad_is_bit_equal_from_call_to_call(device, shape, cin, cout):
    """Kernel C on the loader it shares with kernel A: two calls give
    bit-equal dw."""
    rng = np.random.default_rng(15)
    x = _rand(rng, (*shape, cin)).to(device, torch.bfloat16)
    g = _rand(rng, (*shape, cout)).to(device, torch.bfloat16)
    first = cv.conv3d_same_wgrad(x, g, out=torch.full((cout, cin, 3, 3, 3), float("nan"),
                                                      device=device))
    second = cv.conv3d_same_wgrad(x, g)
    torch.cuda.synchronize()
    assert torch.isfinite(first).all() and torch.equal(first, second)


def test_wrappers_refuse_what_the_kernel_does_not_take(device):
    """float16 input, an fp32 input with a bf16 prepared weight (the fp32
    form takes an fp32 weight), strides, a weight for other inputs; kernel
    D takes bf16 or fp32 (its fp32 form), not float16."""
    x = torch.zeros(1, 4, 4, 4, 16, device=device)
    pw = cv.prepare_conv3d_weight(torch.zeros(16, 16, 3, 3, 3, device=device))
    before = cv.conv3d_same.launches, cv.conv3d_same_fp32.launches
    with pytest.raises(TypeError):
        cv.conv3d_same(x.half(), pw)  # float16 input
    with pytest.raises(ValueError):
        cv.conv3d_same(x, pw)  # float32 input, bfloat16 weight
    with pytest.raises(ValueError):
        cv.conv3d_same(x.to(torch.bfloat16).transpose(1, 2), pw)
    with pytest.raises(ValueError):
        cv.conv3d_same_dual(x.to(torch.bfloat16), x.to(torch.bfloat16), pw)
    with pytest.raises(TypeError):
        cv.conv3d_same_affine(x.half(), cv.prepare_conv3d_weight(
            torch.zeros(16, 16, 3, 3, 3, device=device), dtype=torch.float32))
    with pytest.raises(ValueError):
        cv.conv3d_same_affine(x, pw)  # float32 input, bfloat16 weight
    assert (cv.conv3d_same.launches, cv.conv3d_same_fp32.launches) == before


# the fp32 forms of A, B and C against the fp32 plain versions (TF32 off) on
# the same inputs: both fp32 sums of 27 Cin products (A, B) or of the voxels
# (C) in other orders, bounded relative to the output's largest entry
FP32_RTOL = 1e-4


def _fp32_err(got, ref):
    return (got - ref).abs().max().item() / max(ref.abs().max().item(), 1e-30)


@pytest.mark.parametrize("n,spatial,ca,cb,cout", [
    (1, (6, 16, 32), 30, 0, 30),     # ragged C (8-byte rows)
    (2, (5, 7, 19), 32, 0, 64),      # ragged volume, batch 2
    (1, (4, 4, 4), 320, 0, 320),     # deepest stage
    (1, (3, 5, 9), 13, 0, 47),       # odd C and Cout (4-byte rows)
    (1, (9, 10, 11), 32, 32, 32),    # B: Liver stage 0's decoder
    (2, (6, 8, 8), 20, 12, 16),      # B: unequal inputs
    (1, (8, 8, 16), 60, 0, 60),      # 60 channels (8-byte rows)
    (1, (5, 9, 12), 30, 30, 30),     # B at 30 + 30 (8-byte rows)
    (1, (4, 6, 9), 13, 7, 21),       # B, odd channels (4-byte rows)
    (2, (8, 8, 8), 256, 0, 256),     # 256 @8^3: the K split and its reduce
    (2, (4, 4, 4), 256, 0, 256),
    (2, (8, 8, 8), 320, 0, 320),
    (2, (4, 4, 4), 320, 0, 320),
    (2, (8, 8, 8), 320, 320, 320),   # B at the deepest decoder, split
    (1, (9, 13, 21), 32, 0, 32),     # resident weights, ragged volume
    (1, (7, 9, 10), 32, 16, 48),     # B: unequal inputs, Cout past one column block
])
def test_fp32_forms_of_a_and_b_match_plain(device, n, spatial, ca, cb, cout):
    """Into a NaN-filled output: every element written; two calls bit-equal."""
    rng = np.random.default_rng(5)
    a = _rand(rng, (n, *spatial, ca)).to(device)
    b = _rand(rng, (n, *spatial, cb)).to(device) if cb else None
    w = _rand(rng, (cout, ca + cb, 3, 3, 3), 0.05).to(device)
    bias = _rand(rng, (cout,)).to(device)
    pw = cv.prepare_conv3d_weight(w, (ca, cb) if cb else None, torch.float32)
    out = torch.full((n, *spatial, cout), float("nan"), device=device)
    counter = cv.conv3d_same_dual_fp32 if cb else cv.conv3d_same_fp32
    before = counter.launches, cv.conv3d_same.launches, cv.conv3d_same_dual.launches
    if cb:
        got = cv.conv3d_same_dual(a, b, pw, bias, out=out)
        ref = cv.conv3d_same_dual_ref(a, b, w, bias)
    else:
        got = cv.conv3d_same(a, pw, bias, out=out)
        ref = cv.conv3d_same_ref(a, w, bias)
    torch.cuda.synchronize()
    assert got is out and got.dtype == torch.float32 and torch.isfinite(got).all()
    assert (counter.launches, cv.conv3d_same.launches, cv.conv3d_same_dual.launches) == (
        before[0] + 1, *before[1:])
    assert _fp32_err(got, ref) <= FP32_RTOL
    again = cv.conv3d_same_dual(a, b, pw, bias) if cb else cv.conv3d_same(a, pw, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("n,spatial,cin,cout", [
    (2, (6, 16, 32), 30, 60),        # a B conv's dx at the flagship's width
    (1, (8, 8, 8), 64, 32),
    (2, (4, 4, 4), 320, 640),        # the deepest B's dx: split K
])
def test_fp32_dx_runs_the_ring_body_on_the_flipped_weight(device, n, spatial, cin, cout):
    """conv3d_same_dx in fp32 (kernel A's fp32 form on the flipped,
    transposed weight, prepared each call) against torch's conv3d_input."""
    rng = np.random.default_rng(8)
    g = _rand(rng, (n, *spatial, cout)).to(device)
    w = _rand(rng, (cout, cin, 3, 3, 3), 0.05).to(device)
    out = torch.full((n, *spatial, cin), float("nan"), device=device)
    before = cv.conv3d_same_fp32.launches
    got = cv.conv3d_same_dx(g, w, out=out)
    ref = torch.nn.grad.conv3d_input((n, cin, *spatial), w, g.permute(0, 4, 1, 2, 3),
                                     padding=1).permute(0, 2, 3, 4, 1)
    torch.cuda.synchronize()
    assert got is out and cv.conv3d_same_fp32.launches == before + 1
    assert torch.isfinite(got).all() and _fp32_err(got, ref) <= FP32_RTOL


def test_fp32_ring_body_refuses_a_plan_it_cannot_run(device):
    """The C entry checks the plan it is handed: a box outside the list, an
    empty K split, resident weights with a split, too few workspace bytes."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    x = torch.zeros(1, 8, 8, 8, 64, device=device)
    pw = cv.prepare_conv3d_weight(torch.zeros(64, 64, 3, 3, 3, device=device),
                                  dtype=torch.float32)
    out = torch.empty(1, 8, 8, 8, 64, device=device)
    plan = cv.conv3d_same_fp32_plan(1, 8, 8, 8, 64, 0, 64)
    good = dict(box=plan["box"], splits=1, resident=0, stages=3, grid_p=1, ws=None, nbytes=0)

    def call(**kw):
        a = {**good, **kw}
        return lib.mt_conv3d_same_fp32(
            x.data_ptr(), None, pw.w.data_ptr(), None, out.data_ptr(), a["ws"], a["nbytes"],
            1, 8, 8, 8, 64, 0, 64, pw.coutp, *a["box"], a["splits"], a["resident"],
            a["stages"], a["grid_p"], 0, torch.cuda.current_stream(device).cuda_stream)
    assert call() == 0
    for bad in (dict(box=(4, 4, 32)), dict(splits=7), dict(splits=2, resident=1),
                dict(splits=2, nbytes=16), dict(stages=4), dict(grid_p=2)):
        assert call(**bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,spatial,ca,cb,cout", [
    (2, (6, 16, 32), 30, 0, 30),     # split voxels: partials, a second launch
    (1, (4, 4, 4), 320, 0, 320),     # one box: dw directly
    (1, (3, 5, 9), 13, 0, 47),       # odd C and Cout
    (2, (5, 9, 11), 30, 30, 30),     # dual
    (1, (4, 8, 8), 20, 10, 16),      # dual, unequal
    (1, (9, 10, 11), 32, 0, 32),     # ragged volume, 16-byte copies
    (2, (7, 9, 13), 13, 7, 21),      # dual 13 + 7, odd Cout, ragged (4-byte copies)
    (2, (4, 4, 4), 320, 0, 320),     # the Liver's deepest stage: units walked in turn
    (2, (8, 8, 8), 320, 320, 320),   # B's deepest dw: 800 tiles over the blocks
    (1, (17, 18, 40), 64, 0, 96),    # several boxes a split, 3 column blocks
    (2, (16, 16, 16), 30, 30, 30),   # dual at 30 + 30 (8-byte copies), split voxels
])
def test_fp32_form_of_c_matches_plain(device, n, spatial, ca, cb, cout):
    """Into a NaN-filled dw: every element written; two calls bit-equal;
    every launch on the wgrad ring body."""
    rng = np.random.default_rng(6)
    ins = [_rand(rng, (n, *spatial, c)).to(device) for c in (ca, cb) if c]
    g = _rand(rng, (n, *spatial, cout)).to(device)
    out = torch.full((cout, ca + cb, 3, 3, 3), float("nan"), device=device)
    fn = cv.conv3d_same_wgrad_dual if cb else cv.conv3d_same_wgrad
    plain = cv.conv3d_same_wgrad_dual_ref if cb else cv.conv3d_same_wgrad_ref
    before = (cv.conv3d_same_wgrad_fp32.launches, cv.conv3d_same_wgrad.launches,
              cv.conv3d_same_wgrad_fp32.launches_by_body["ring"])
    assert fn(*ins, g, out=out) is out
    again = fn(*ins, g)
    torch.cuda.synchronize()
    assert (cv.conv3d_same_wgrad_fp32.launches, cv.conv3d_same_wgrad.launches,
            cv.conv3d_same_wgrad_fp32.launches_by_body["ring"]) == (
        before[0] + 2, before[1], before[2] + 2)
    assert torch.isfinite(out).all() and torch.equal(out, again)
    assert _fp32_err(out, plain(*ins, g)) <= FP32_RTOL


def test_fp32_wgrad_ring_refuses_a_plan_it_cannot_run(device):
    """The C entry of C's fp32 form checks the plan it is handed (a box
    outside the list, splits that leave one empty, a grid past the units,
    too few workspace bytes, a third stage), and the library's workspace
    query answers from the host plan's rules."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    n, sp, c = 2, (16, 16, 16), 32
    x = torch.zeros(n, *sp, c, device=device)
    g = torch.zeros(n, *sp, c, device=device)
    dw = torch.empty(c, c, 3, 3, 3, device=device)
    plan = cv.conv3d_same_wgrad_fp32_plan(n, *sp, c, 0, c)
    assert plan["splits"] == 16 and plan["units"] == 64  # 16 boxes, 4 tiles
    ws = torch.empty(plan["workspace_bytes"] // 4, device=device)
    good = dict(box=plan["box"], splits=plan["splits"], grid=plan["grid"],
                stages=plan["stages"], nbytes=plan["workspace_bytes"])

    def call(**kw):
        a = {**good, **kw}
        return lib.mt_conv3d_wgrad_fp32(
            x.data_ptr(), None, g.data_ptr(), dw.data_ptr(), ws.data_ptr(), a["nbytes"],
            n, *sp, c, 0, c, *a["box"], a["splits"], a["grid"], a["stages"], 0,
            torch.cuda.current_stream(device).cuda_stream)
    assert call() == 0
    for bad in (dict(box=(4, 4, 32)), dict(splits=15), dict(splits=17), dict(grid=65),
                dict(nbytes=16), dict(stages=3)):
        assert call(**bad) != 0, bad
    torch.cuda.synchronize()
    for sizes in ((2, 128, 128, 128, 32, 0, 32), (2, 8, 8, 8, 320, 320, 320),
                  (1, 96, 192, 192, 30, 30, 30), (1, 3, 5, 9, 13, 7, 21)):
        assert lib.mt_conv3d_wgrad_fp32_workspace(*sizes) == \
            cv.conv3d_same_wgrad_fp32_workspace(*sizes), sizes


def test_fp32_training_step_through_the_fp32_forms(device):
    """One forward + backward of a reduced flagship UNet in fp32 through the
    fp32 forms of A, B and C: their launch counts are the per-step counts,
    kernels A, B and C's bf16 forms launch nowhere, and every parameter
    gradient is within 1e-3 of its largest entry of the plain fp32 path's
    (fp32 sums in other orders through ~15 layers; conv biases left out: the
    instance norm cancels them)."""
    from multitalent_tpu_torch.models.blocks import fp32_forms
    from multitalent_tpu_torch.models.generic_unet import GenericUNet
    pools, kernels = [[2, 2, 2], [2, 2, 2], [1, 2, 2]], [[3, 3, 3]] * 4
    torch.manual_seed(0)
    net = GenericUNet(1, 16, 47, pools, kernels, dtype=torch.float32).to(device)
    x = torch.randn(2, 1, 16, 32, 32, device=device)

    def grads(use_kernels):
        net.zero_grad()
        outs = net(x, use_kernels=use_kernels, deep_supervision=True)
        sum(o.square().mean() for o in outs).backward()
        return {k: p.grad.clone() for k, p in net.named_parameters()
                if p.grad is not None and not k.endswith("conv.bias")}

    counts = {"conv3d_same_fp32": cv.conv3d_same_fp32,
              "conv3d_same_dual_fp32": cv.conv3d_same_dual_fp32,
              "conv3d_same_wgrad_fp32": cv.conv3d_same_wgrad_fp32,
              "conv3d_same": cv.conv3d_same, "conv3d_same_dual": cv.conv3d_same_dual,
              "conv3d_same_wgrad": cv.conv3d_same_wgrad}
    before = {k: c.launches for k, c in counts.items()}
    got = grads(True)
    torch.cuda.synchronize()
    expect = {k: 0 for k in counts} | fp32_forms(net.kernel_launches_per_step())
    assert {k: c.launches - before[k] for k, c in counts.items()} == expect
    ref = grads(False)
    for k in ref:
        assert (got[k] - ref[k]).abs().max() <= 1e-3 * ref[k].abs().max() + 1e-7, k


def test_fused_switches_refuse_an_fp32_network_on_the_card(device, monkeypatch):
    """An fp32 GenericUNet on the card under either fused switch runs the
    fused route on the fp32 forms of D, E and F (and, backward, of A and
    C): exactly the route's per-forward and per-step counts of the fp32
    forms, no bf16 kernel launched, the logits within FP32_RTOL of the
    route's plain fp32 versions and of the unfused fp32 network, the
    training loss within 1e-4 relative of the unfused one's."""
    from multitalent_tpu_torch.models.blocks import fp32_forms
    from multitalent_tpu_torch.models.generic_unet import GenericUNet
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    from multitalent_tpu_torch.ops.fused_unet import (make_inference_forward,
                                                      make_train_forward, unet_forward_fused)
    torch.manual_seed(0)
    net = GenericUNet(1, 16, 3, [[2, 2, 2], [2, 2, 2], [1, 2, 2]], [[3, 3, 3]] * 4,
                      dtype=torch.float32).to(device)
    with torch.no_grad():
        for m in net.modules():  # norm affines off (1, 0)
            if isinstance(m, torch.nn.InstanceNorm3d) and m.weight is not None:
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.5, 0.5)
    x = torch.randn(2, 1, 16, 32, 32, device=device)
    counters = {"conv3d_same_affine_fp32": cv.conv3d_same_affine_fp32,
                "channel_stats_fp32": fn.channel_stats_fp32,
                "affine_lrelu_fp32": fn.affine_lrelu_fp32, "seghead_fp32": sg.seghead_fp32,
                "conv3d_same_fp32": cv.conv3d_same_fp32,
                "conv3d_same_dual_fp32": cv.conv3d_same_dual_fp32,
                "conv3d_same_wgrad_fp32": cv.conv3d_same_wgrad_fp32,
                "conv3d_same": cv.conv3d_same, "conv3d_same_dual": cv.conv3d_same_dual,
                "conv3d_same_wgrad": cv.conv3d_same_wgrad,
                "conv3d_same_affine": cv.conv3d_same_affine,
                "channel_stats": fn.channel_stats, "affine_lrelu": fn.affine_lrelu,
                "seghead": sg.seghead}

    def counted(fn_):
        before = {k: c.launches for k, c in counters.items()}
        result = fn_()
        torch.cuda.synchronize()
        return result, {k: c.launches - before[k] for k, c in counters.items()}

    monkeypatch.setenv("MTTPU_FUSED_NORM", "1")
    forward = make_inference_forward(net)
    monkeypatch.delenv("MTTPU_FUSED_NORM")
    got, launches = counted(lambda: forward(x))
    assert launches == {k: 0 for k in counters} | fp32_forms(
        net.fused_kernel_launches_per_forward())
    with torch.no_grad():
        plain = unet_forward_fused(net, x, use_kernels=False)
        unfused = net(x, use_kernels=False)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert _fp32_err(got, plain) <= FP32_RTOL
    assert _fp32_err(got, unfused) <= FP32_RTOL

    monkeypatch.setenv("MTTPU_FUSED_TRAIN", "1")
    train_forward = make_train_forward(net)
    monkeypatch.delenv("MTTPU_FUSED_TRAIN")

    def step():
        net.zero_grad()
        loss = sum(o.square().mean() for o in train_forward(x, deep_supervision=True))
        loss.backward()
        return loss.item()

    loss, launches = counted(step)
    assert launches == {k: 0 for k in counters} | fp32_forms(
        net.fused_kernel_launches_per_step())
    net.zero_grad()
    ref = sum(o.square().mean() for o in net(x, use_kernels=False, deep_supervision=True))
    assert abs(loss - ref.item()) <= 1e-4 * abs(ref.item())


@pytest.mark.parametrize("n,spatial,c,cout,affine", [
    (2, (16, 16, 16), 32, 32, True),    # the Liver's stage 0, N=2 (split K: E's stats)
    (2, (16, 16, 16), 32, 32, False),
    (1, (5, 7, 19), 30, 60, True),      # ragged volume, stage-0 width
    (1, (3, 5, 9), 13, 47, True),       # odd C and Cout
    (1, (4, 4, 4), 320, 320, True),     # deepest stage (split K)
    (2, (8, 8, 8), 320, 320, True),     # the Liver's 8^3 stage, N=2 (split K)
    (2, (9, 10, 11), 30, 30, True),     # ragged, 8-byte copies
    (2, (40, 40, 40), 40, 40, True),    # resident weights, 2 stages: the prologue after the barrier
    (2, (24, 40, 40), 32, 32, True),    # resident weights, 3 stages, one split: the box rows
    (2, (24, 40, 40), 32, 32, False),
])
def test_fp32_form_of_d_matches_plain(device, n, spatial, c, cout, affine):
    """Into NaN-filled out and stats, a shift of +4 so that a normalized
    halo would show at every face; two calls bit-equal; launches on its own
    count, every one on the ring body."""
    rng = np.random.default_rng(11)
    x = _rand(rng, (n, *spatial, c)).to(device)
    w = _rand(rng, (cout, c, 3, 3, 3), 0.05).to(device)
    bias = _rand(rng, (cout,)).to(device)
    s = (torch.from_numpy(rng.random((n, c)).astype(np.float32)) + 0.5).to(device)
    t = (_rand(rng, (n, c)) + 4.0).to(device)
    sc, sh = (s, t) if affine else (None, None)
    pw = cv.prepare_conv3d_weight(w, dtype=torch.float32)
    out = torch.full((n, *spatial, cout), float("nan"), device=device)
    stats = torch.full((n, 2, cout), float("nan"), device=device)
    before = (cv.conv3d_same_affine_fp32.launches, cv.conv3d_same_affine.launches,
              cv.conv3d_same_affine_fp32.launches_by_body["ring"])
    got, got_stats = cv.conv3d_same_affine(x, pw, bias, sc, sh, 1e-2, out=out, stats=stats)
    again, again_stats = cv.conv3d_same_affine(x, pw, bias, sc, sh, 1e-2)
    ref, ref_stats = cv.conv3d_same_affine_ref(x, w, bias, sc, sh, 1e-2)
    torch.cuda.synchronize()
    assert got is out and got_stats is stats
    assert (cv.conv3d_same_affine_fp32.launches, cv.conv3d_same_affine.launches,
            cv.conv3d_same_affine_fp32.launches_by_body["ring"]) == (
        before[0] + 2, before[1], before[2] + 2)
    assert torch.equal(got, again) and torch.equal(got_stats, again_stats)
    assert _fp32_err(got, ref) <= FP32_RTOL
    assert _fp32_err(got_stats, ref_stats) <= FP32_RTOL


@pytest.mark.parametrize("n,spatial,c", [(1, (8, 8, 8), 32), (2, (5, 9, 11), 13),
                                         (2, (24, 40, 40), 32)])
def test_fp32_form_of_d_keeps_its_halo_zero_under_a_large_shift(device, n, spatial, c):
    """A shift of +50 puts lrelu(shift) far from 0 at every face and padded
    voxel: the SAME halo, the boxes' overhang and the padding channels must
    stay 0, as the plain version's zero padding of the normalized input."""
    rng = np.random.default_rng(14)
    x = _rand(rng, (n, *spatial, c)).to(device)
    w = _rand(rng, (c, c, 3, 3, 3), 0.05).to(device)
    s = (torch.from_numpy(rng.random((n, c)).astype(np.float32)) + 0.5).to(device)
    t = (_rand(rng, (n, c)) + 50.0).to(device)
    pw = cv.prepare_conv3d_weight(w, dtype=torch.float32)
    got, got_stats = cv.conv3d_same_affine(x, pw, None, s, t, 1e-2)
    ref, ref_stats = cv.conv3d_same_affine_ref(x, w, None, s, t, 1e-2)
    torch.cuda.synchronize()
    assert _fp32_err(got, ref) <= FP32_RTOL and _fp32_err(got_stats, ref_stats) <= FP32_RTOL


@pytest.mark.parametrize("n,spatial,ca,cb,cout", [
    (2, (16, 16, 16), 32, 32, 32),     # the Liver's last decoder stage
    (1, (6, 9, 11), 20, 12, 16),       # unequal inputs, ragged volume
    (2, (7, 9, 13), 13, 7, 21),        # 13 + 7, odd Cout (4-byte copies)
    (2, (8, 8, 8), 320, 320, 320),     # the deepest decoder (split K)
    (2, (24, 40, 40), 30, 30, 30),     # one split: the box rows, 8-byte copies
])
def test_fp32_form_of_d_dual_matches_plain(device, n, spatial, ca, cb, cout):
    """Into NaN-filled out and stats; two calls bit-equal."""
    rng = np.random.default_rng(12)
    a = _rand(rng, (n, *spatial, ca)).to(device)
    b = _rand(rng, (n, *spatial, cb)).to(device)
    w = _rand(rng, (cout, ca + cb, 3, 3, 3), 0.05).to(device)
    bias = _rand(rng, (cout,)).to(device)
    pw = cv.prepare_conv3d_weight(w, (ca, cb), torch.float32)
    out = torch.full((n, *spatial, cout), float("nan"), device=device)
    stats = torch.full((n, 2, cout), float("nan"), device=device)
    before = cv.conv3d_same_affine_fp32.launches
    got, got_stats = cv.conv3d_same_dual_stats(a, b, pw, bias, out=out, stats=stats)
    again, again_stats = cv.conv3d_same_dual_stats(a, b, pw, bias)
    ref, ref_stats = cv.conv3d_same_dual_stats_ref(a, b, w, bias)
    torch.cuda.synchronize()
    assert got is out and got_stats is stats
    assert cv.conv3d_same_affine_fp32.launches == before + 2
    assert torch.equal(got, again) and torch.equal(got_stats, again_stats)
    assert _fp32_err(got, ref) <= FP32_RTOL and _fp32_err(got_stats, ref_stats) <= FP32_RTOL


def test_fp32_form_of_d_refuses_a_plan_it_cannot_run(device):
    """D's C entry checks its plan and workspace: one byte short of the
    plan's workspace (the stats rows), a box outside the list, a prologue
    on two inputs."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    n, sp, c = 2, (24, 40, 40), 32
    x = torch.zeros(n, *sp, c, device=device)
    s = torch.ones(n, c, device=device)
    pw = cv.prepare_conv3d_weight(torch.zeros(c, c, 3, 3, 3, device=device),
                                  dtype=torch.float32)
    out = torch.empty(n, *sp, c, device=device)
    stats = torch.empty(n, 2, c, device=device)
    plan = cv.conv3d_same_fp32_plan(n, *sp, c, 0, c, stats=True)
    assert plan["splits"] == 1 and plan["stats_bytes"] == plan["workspace_bytes"] > 0
    ws = torch.empty(plan["workspace_bytes"] // 4, device=device)
    good = dict(b=None, cb=0, box=plan["box"], nbytes=plan["workspace_bytes"])

    def call(**kw):
        a = {**good, **kw}
        return lib.mt_conv3d_same_affine_fp32(
            x.data_ptr(), a["b"], pw.w.data_ptr(), None, s.data_ptr(), s.data_ptr(), 0.01,
            out.data_ptr(), stats.data_ptr(), ws.data_ptr(), a["nbytes"], n, *sp, c, a["cb"],
            c, pw.coutp, *a["box"], 1, int(plan["resident"]), plan["stages"],
            plan["grid"][0], 0, torch.cuda.current_stream(device).cuda_stream)
    assert call() == 0
    for bad in (dict(nbytes=plan["workspace_bytes"] - 4), dict(box=(4, 4, 32)),
                dict(b=x.data_ptr(), cb=c)):
        assert call(**bad) != 0, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("shape", [(2, 16, 16, 16, 32), (1, 5, 7, 9, 30), (1, 6, 6, 6, 320),
                                   (2, 4, 6, 8, 13), (1, 3, 5, 7, 1)])
def test_fp32_form_of_e_matches_plain(device, shape):
    """Stats (two calls bit-equal) and apply, fp32 in and out."""
    from multitalent_tpu_torch.ops import fused_norm as fn
    rng = np.random.default_rng(13)
    x = (_rand(rng, shape) * 3 + 1).to(device)
    c = shape[-1]
    sc = (torch.from_numpy(rng.random((shape[0], c)).astype(np.float32)) + 0.5).to(device)
    sh = _rand(rng, (shape[0], c)).to(device)
    before = (fn.channel_stats_fp32.launches, fn.affine_lrelu_fp32.launches,
              fn.channel_stats.launches, fn.affine_lrelu.launches)
    stats, again = fn.channel_stats(x), fn.channel_stats(x)
    y = fn.affine_lrelu(x, sc, sh, 1e-2, True)
    torch.cuda.synchronize()
    assert (fn.channel_stats_fp32.launches, fn.affine_lrelu_fp32.launches,
            fn.channel_stats.launches, fn.affine_lrelu.launches) == (
        before[0] + 2, before[1] + 1, *before[2:])
    assert torch.equal(stats, again)
    assert _fp32_err(stats, fn.channel_stats_ref(x)) <= FP32_RTOL
    assert y.dtype == torch.float32
    assert _fp32_err(y, fn.affine_lrelu_ref(x, sc, sh, 1e-2, True)) <= FP32_RTOL


@pytest.mark.parametrize("shape,k,out_dtype,affine", [
    ((2, 16, 16, 16, 32), 3, torch.float32, True),    # the Liver's head
    ((1, 6, 10, 12, 30), 47, torch.float32, True),    # the flagship's, ragged tiles
    ((1, 4, 8, 9, 13), 5, torch.bfloat16, False),     # odd widths, no prologue
])
def test_fp32_form_of_f_matches_plain(device, shape, k, out_dtype, affine):
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(14)
    n, c = shape[0], shape[-1]
    x = _rand(rng, shape).to(device)
    w = _rand(rng, (k, c, 1, 1, 1), 0.3).to(device)
    bias = _rand(rng, (k,)).to(device)
    sc = (torch.from_numpy(rng.random((n, c)).astype(np.float32)) + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    pro = (sc, sh) if affine else (None, None)
    out = torch.full((n, k, *shape[1:4]), float("nan"), dtype=out_dtype, device=device)
    before = sg.seghead_fp32.launches, sg.seghead.launches
    got = sg.seghead(x, w, bias, *pro, 1e-2, out_dtype, out=out)
    ref = sg.seghead_ref(x, w, bias, *pro, 1e-2, torch.float32)
    torch.cuda.synchronize()
    assert got is out and (sg.seghead_fp32.launches, sg.seghead.launches) == (
        before[0] + 1, before[1])
    bound = FP32_RTOL if out_dtype == torch.float32 else 2 ** -8
    assert _fp32_err(got.float(), ref) <= bound


@pytest.mark.parametrize("shape,k", [
    ((2, 16, 16, 16, 32), 1),     # one output: the smallest output group
    ((2, 5, 7, 11, 32), 3),       # the Liver's head, ragged tiles, N=2
    ((3, 3, 5, 7, 8), 8),         # one full group of 8, three samples
    ((2, 6, 10, 12, 30), 47),     # the flagship's head: 4-byte copies, odd rows
    ((1, 4, 6, 9, 64), 17),       # 17 outputs: one group of 48; 64-channel rows
])
@pytest.mark.parametrize("affine", [True, False])
def test_fp32_form_of_f_persistent_body_matches_plain(device, shape, k, affine):
    """F's fp32 form (the persistent cp.async body) at every output group
    into a NaN-filled output, against the plain fp32 version; two calls
    bit-equal (each output's sum runs over the channels in order, as the
    plain loop of the older body did); an unaligned view of the input (the
    4-byte copies) gives the same bits as the aligned copy."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(15)
    n, c = shape[0], shape[-1]
    x = _rand(rng, shape).to(device)
    w = _rand(rng, (k, c, 1, 1, 1), 0.3).to(device)
    bias = _rand(rng, (k,)).to(device)
    pro = ((torch.from_numpy(rng.random((n, c)).astype(np.float32)) + 0.5).to(device),
           _rand(rng, (n, c)).to(device)) if affine else (None, None)
    out = torch.full((n, k, *shape[1:4]), float("nan"), device=device)
    got = sg.seghead_fp32(x, w, bias, *pro, 1e-2, torch.float32, out=out)
    again = sg.seghead_fp32(x, w, bias, *pro, 1e-2, torch.float32)
    flat = torch.empty(1 + x.numel(), device=device)
    view = flat[1:].view(shape)
    view.copy_(x)
    assert view.data_ptr() % 16 == 4
    unaligned = sg.seghead_fp32(view, w, bias, *pro, 1e-2, torch.float32)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert torch.equal(got, again) and torch.equal(got, unaligned)
    ref = sg.seghead_ref(x, w, bias, *pro, 1e-2, torch.float32)
    assert _fp32_err(got, ref) <= FP32_RTOL


# kernel C: fp32 dw against the fp32 plain version on the same bf16 inputs;
# the sums over the voxels run in another order, so the bound is relative to
# max|dw| (see chip_smoke.DW_RTOL)
DW_RTOL = 1e-3


@pytest.mark.parametrize("shape,cin,cout", [
    ((2, 6, 16, 32), 30, 30),     # stage-0 width, ragged C, batch 2
    ((1, 5, 7, 19), 60, 60),      # ragged Z/Y/X
    ((1, 6, 6, 6), 320, 320),     # deepest flagship stage
    ((1, 3, 5, 9), 13, 47),       # odd C (1-channel loads), 47 outputs
    ((2, 8, 16, 16), 60, 60),     # 60-channel rows (8-byte copies), batch 2
    ((2, 5, 9, 11), 30, 30),      # 30-channel rows (both chunks a block), ragged
    ((1, 4, 8, 8), 30, 60),       # 30-channel rows into 60 outputs
    ((1, 7, 6, 5), 16, 24),       # one chunk, Cout <= 32 (the BN-64 form)
    ((1, 4, 8, 8), 21, 33),       # odd Cout (1-channel g copies)
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
    (30, 20, 30, (2, 5, 9, 11)),  # unequal, both chunks a block, ragged volume
    (60, 36, 60, (1, 4, 8, 8)),   # unequal 60-channel form
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


@pytest.mark.parametrize("dual,shape,cout,direct", [
    (False, (1, 6, 6, 6, 320), 320, True),   # partials would outweigh the inputs
    (False, (2, 8, 16, 32, 30), 30, False),  # one block's worth: split the voxels
    (True, (1, 6, 12, 12, 320), 320, True),
    (True, (2, 8, 16, 32, 30), 30, False),
])
def test_conv3d_same_wgrad_write_paths(device, dual, shape, cout, direct):
    """Kernel C on each write path (dw directly, or per-split partials and
    a second launch), into a dw buffer filled with NaN: every element is
    written; two calls give bit-equal dw (no atomics)."""
    rng = np.random.default_rng(4)
    n, z, y, x, c = shape
    ins = [_rand(rng, shape).to(device, torch.bfloat16) for _ in range(2 if dual else 1)]
    g = _rand(rng, (*shape[:4], cout)).to(device, torch.bfloat16)
    ws = cv.conv3d_same_wgrad_workspace(n, z, y, x, c, c if dual else 0, cout)
    assert (ws == 0) == direct, ws
    fn = cv.conv3d_same_wgrad_dual if dual else cv.conv3d_same_wgrad
    plain = cv.conv3d_same_wgrad_dual_ref if dual else cv.conv3d_same_wgrad_ref
    out = torch.full((cout, c * len(ins), 3, 3, 3), float("nan"), device=device)
    assert fn(*ins, g, out=out) is out
    again = fn(*ins, g)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)
    ref = plain(*(t.float() for t in ins), g.float())
    assert (out - ref).abs().max().item() <= DW_RTOL * ref.abs().max().item()


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
    (320, 320, 320, (6, 12, 12)),   # split K: stats taken by the split-K reduce
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


# kernels D and B on the ring body, each into NaN-filled buffers (an unwritten
# voxel or stat fails) against the plain version at phase 2's bounds: D at
# kernel A's six flagship shapes and D's dual form and B at the five of B, at
# N=1 and N=2; ragged volumes where no box fits whole; grids with fewer tiles
# than blocks (K split: D's stats then come from kernel E)
D_CASES = ([(n, sp, c) for n in (1, 2) for c, sp in A_FLAGSHIP]
           + [(1, sp, c) for c in (30, 60, 120) for sp in ((7, 13, 11), (5, 9, 17))]
           + [(1, (4, 8, 8), 60), (1, (3, 4, 5), 320), (2, (1, 1, 1), 30)])
DUAL_CASES = ([(n, sp, (c, c)) for n in (1, 2) for c, sp in A_FLAGSHIP[:5]]
              + [(1, sp, cs) for cs in ((30, 30), (60, 60), (120, 120), (20, 10))
                 for sp in ((7, 13, 11), (5, 9, 17))]
              + [(1, (4, 8, 8), (60, 60)), (1, (3, 4, 5), (320, 320)), (2, (1, 1, 1), (20, 10))])


def _nan_stats(n, c, device):
    return torch.full((n, 2, c), float("nan"), dtype=torch.float32, device=device)


@pytest.mark.parametrize("n,spatial,c", D_CASES)
def test_conv3d_same_affine_on_the_ring_matches_plain(device, n, spatial, c):
    rng = np.random.default_rng(16)
    x = _rand(rng, (n, *spatial, c), 2.0).to(device, torch.bfloat16)
    w = _rand(rng, (c, c, 3, 3, 3), (2 / (27 * c)) ** 0.5).to(device)
    b = _rand(rng, (c,), 0.1).to(device)
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    out, stats = _nan_filled((n, *spatial, c), device), _nan_stats(n, c, device)
    got, got_stats = cv.conv3d_same_affine(x, cv.prepare_conv3d_weight(w), b, sc, sh,
                                           out=out, stats=stats)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and got_stats.data_ptr() == stats.data_ptr()
    assert torch.isfinite(got).all() and torch.isfinite(got_stats).all()
    ref, _ = cv.conv3d_same_affine_ref(x, w.to(torch.bfloat16), b, sc, sh)
    _assert_close(got, ref.float())
    assert _stats_err(got_stats, got) <= STATS_RTOL


@pytest.mark.parametrize("form", ["b", "d_dual"])
@pytest.mark.parametrize("n,spatial,cs", DUAL_CASES)
def test_conv3d_same_dual_forms_on_the_ring_match_plain(device, form, n, spatial, cs):
    """Kernel B and D's dual form; unequal inputs (20 + 10) catch a swapped
    [a | b] order or a's chunk count applied to b."""
    rng = np.random.default_rng(17)
    a = _rand(rng, (n, *spatial, cs[0])).to(device, torch.bfloat16)
    b = _rand(rng, (n, *spatial, cs[1])).to(device, torch.bfloat16)
    cout = cs[0]
    w = _rand(rng, (cout, sum(cs), 3, 3, 3), (2 / (27 * sum(cs))) ** 0.5).to(device)
    bias = _rand(rng, (cout,), 0.1).to(device)
    pw = cv.prepare_conv3d_weight(w, cs)
    out = _nan_filled((n, *spatial, cout), device)
    if form == "b":
        got = cv.conv3d_same_dual(a, b, pw, bias, out=out)
    else:
        stats = _nan_stats(n, cout, device)
        got, got_stats = cv.conv3d_same_dual_stats(a, b, pw, bias, out=out, stats=stats)
        assert got_stats.data_ptr() == stats.data_ptr()
        assert torch.isfinite(got_stats).all() and _stats_err(got_stats, got) <= STATS_RTOL
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.isfinite(got).all()
    _assert_close(got, cv.conv3d_same_dual_ref(a.float(), b.float(),
                                               w.to(torch.bfloat16).float(), bias))


# two inputs of rows narrower than 16-byte copies in a volume of two tiles:
# the ring body with its K loop split
RING_SPLIT_CASES = {("b", 2, (1, 1, 1), (20, 10)), ("d_dual", 2, (1, 1, 1), (20, 10))}


@pytest.mark.parametrize("form,n,spatial,cs", [
    ("d", 1, (96, 192, 192), (30,)),          # both chunks a stage, 3 stages, prologue ahead
    ("d", 2, (48, 96, 96), (60,)),            # streamed weights, walks cross samples
    ("d", 1, (6, 6, 6), (320,)),              # split K: stats by kernel E
    ("d", 2, (12, 24, 24), (240,)),           # 16-byte rows on the ring
    ("d_dual", 1, (96, 192, 192), (30, 30)),  # swizzled resident weights
    ("d_dual", 2, (48, 96, 96), (60, 60)),
    ("b", 1, (96, 192, 192), (30, 30)),
    ("b", 1, (12, 24, 24), (240, 240)),       # the wgmma body
    *sorted(RING_SPLIT_CASES),
])
def test_d_and_b_are_bit_equal_from_call_to_call(device, form, n, spatial, cs):
    """No atomics: every output voxel is written by one block, every stat
    added from per-block rows in a fixed order."""
    if (form, n, spatial, cs) in RING_SPLIT_CASES:
        plan = cv.conv3d_same_plan(n, *spatial, cs, cs[0], form)
        assert plan["ring"] == 1 and plan["splits"] > 1
    rng = np.random.default_rng(18)
    ins = [_rand(rng, (n, *spatial, c), 2.0).to(device, torch.bfloat16) for c in cs]
    cout = cs[0]
    pw = cv.prepare_conv3d_weight(_rand(rng, (cout, sum(cs), 3, 3, 3), 0.05).to(device),
                                  cs if len(cs) == 2 else None)
    bias = _rand(rng, (cout,), 0.1).to(device)
    affine = ((_rand(rng, (n, cs[0])).abs() + 0.5).to(device), _rand(rng, (n, cs[0])).to(device))
    call = {"d": lambda: cv.conv3d_same_affine(*ins, pw, bias, *affine),
            "d_dual": lambda: cv.conv3d_same_dual_stats(*ins, pw, bias),
            "b": lambda: (cv.conv3d_same_dual(*ins, pw, bias),)}[form]
    first, second = call(), call()
    torch.cuda.synchronize()
    for u, v in zip(first, second):
        assert torch.equal(u, v)


@pytest.mark.parametrize("c", [30, 60, 13])
@pytest.mark.parametrize("spatial", [(7, 13, 11), (5, 9, 17)])
def test_conv3d_same_affine_halo_stays_zero_under_a_large_shift(device, c, spatial):
    """The prologue leaves the SAME halo and the padding channels at 0: with
    shift = +100, lrelu(x * scale + shift) is ~100 at every voxel inside, so
    a halo voxel or padding channel that took the prologue would move the
    outputs at the volume's faces by ~100 * |w|, far past the bound. Inf in
    the raw input next to boxes' edges (and in the last channel): the
    kernel's non-finite outputs are exactly the plain version's, and every
    finite one is within bound."""
    rng = np.random.default_rng(19)
    n = 1
    x = _rand(rng, (n, *spatial, c)).to(device, torch.bfloat16)
    z, y, xx = spatial
    for vz, vy, vx in ((z // 2, y // 2, xx // 2), (0, 0, xx - 1), (z - 1, y - 1, 0)):
        x[0, vz, vy, vx, c - 1] = float("inf")
    w = _rand(rng, (c, c, 3, 3, 3), 0.1).to(device)
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = torch.full((n, c), 100.0, device=device)
    got, stats = cv.conv3d_same_affine(x, cv.prepare_conv3d_weight(w), None, sc, sh,
                                       out=_nan_filled((n, *spatial, c), device),
                                       stats=_nan_stats(n, c, device))
    torch.cuda.synchronize()
    ref, _ = cv.conv3d_same_affine_ref(x, w.to(torch.bfloat16), None, sc, sh)
    ref = ref.float()
    finite = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(got), finite)
    assert finite.sum() > 0.5 * finite.numel()
    _assert_close(got.float()[finite], ref[finite])


@pytest.mark.parametrize("form,c,spatial", [
    ("d", 30, (16, 32, 32)), ("d", 60, (7, 13, 11)), ("d", 120, (8, 16, 16)),
    ("d_dual", 30, (16, 32, 32)), ("d_dual", 60, (7, 13, 11)),
])
def test_d_keeps_samples_apart(device, form, c, spatial):
    """N=2 with sample 1's scale (D) or input (D's dual form) 10x sample 0's:
    a prologue that read the other sample's scale and shift, or stats added
    into the other sample's row, would miss the plain version by far."""
    rng = np.random.default_rng(20)
    n = 2
    w = _rand(rng, (c, c * (2 if form == "d_dual" else 1), 3, 3, 3), 0.1).to(device)
    bias = _rand(rng, (c,), 0.1).to(device)
    if form == "d":
        x = _rand(rng, (n, *spatial, c)).to(device, torch.bfloat16)
        sc = (_rand(rng, (1, c)).abs() + 0.5).to(device) * torch.tensor([[1.0], [10.0]],
                                                                          device=device)
        sh = _rand(rng, (n, c)).to(device)
        got, stats = cv.conv3d_same_affine(x, cv.prepare_conv3d_weight(w), bias, sc, sh)
        ref, ref_stats = cv.conv3d_same_affine_ref(x, w.to(torch.bfloat16), bias, sc, sh)
    else:
        gain = torch.tensor([1.0, 10.0], device=device).reshape(2, 1, 1, 1, 1)
        a, b = ((_rand(rng, (n, *spatial, c)).to(device) * gain).to(torch.bfloat16)
                for _ in range(2))
        got, stats = cv.conv3d_same_dual_stats(a, b, cv.prepare_conv3d_weight(w, (c, c)), bias)
        ref, ref_stats = cv.conv3d_same_dual_stats_ref(a.float(), b.float(),
                                                       w.to(torch.bfloat16).float(), bias)
    torch.cuda.synchronize()
    for i in range(n):  # each sample at its own scale
        _assert_close(got[i], ref[i].float())
    assert _stats_err(stats, got) <= STATS_RTOL
    # and the stats are the plain version's: each sample's sums, not the other's
    from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
    scale = channel_stats_ref(ref.float().abs())
    assert ((stats - ref_stats.float()).abs() / (scale + 1e-6)).max().item() <= 2e-2


@pytest.mark.parametrize("form,cs,spatial", [
    ("d", 30, (96, 192, 192)), ("d", 60, (48, 96, 96)),
    ("d_dual", (30, 30), (96, 192, 192)), ("d_dual", (60, 60), (48, 96, 96)),
    ("b", (30, 30), (96, 192, 192)), ("b", (60, 60), (48, 96, 96)),
])
def test_d_and_b_take_the_ring_at_30_and_60_channels(device, form, cs, spatial):
    """The plan: D (both forms) and B run the ring body at the flagship's
    stage-0 and stage-1 widths, both chunks of a 30-channel row a stage."""
    c = cs if isinstance(cs, int) else cs[0]
    plan = cv.conv3d_same_plan(1, *spatial, cs, c, form)
    assert plan["ring"] == 1 and plan["splits"] == 1
    assert plan["g"] == (2 if c == 30 else 1)


@pytest.mark.parametrize("form,cs,spatial,ring,wgmma", [
    ("d", 120, (24, 48, 48), 1, 0), ("d", 240, (12, 24, 24), 1, 0),
    ("a", 120, (24, 48, 48), 0, 1), ("b", (240, 240), (12, 24, 24), 0, 1),
    ("d_dual", (120, 120), (24, 48, 48), 0, 1), ("d_dual", (320, 320), (6, 12, 12), 0, 1),
])
def test_the_older_body_keeps_16_byte_rows_but_for_d(device, form, cs, spatial, ring, wgmma):
    """The plan at 16-byte rows with streamed weights: A, B and D's dual
    form run the wgmma body (also when K is split); D runs the ring body at
    every width."""
    c = cs if isinstance(cs, int) else cs[0]
    plan = cv.conv3d_same_plan(1, *spatial, cs, c, form)
    assert (plan["ring"], plan["wgmma"]) == (ring, wgmma)


# the wgmma body (csrc/conv3d_wgmma.cu): (form, N, spatial, input channels,
# Cout) at SwinUNETR's 48, the Liver's 64, the flagship's 120, 240 + 240 and
# 320 + 320 and the dual convs' dx 320 -> 640, ragged volumes (X 13 and 6,
# Z and Y past a 4x8x8 tile, Cout 47), a split K loop (384 + 384)
WGMMA_CASES = [
    ("a", 1, (96, 192, 192), (48,), 48), ("a", 1, (64, 64, 64), (64,), 64),
    ("a", 2, (24, 48, 48), (120,), 120), ("b", 2, (12, 24, 24), (240, 240), 240),
    ("b", 1, (6, 12, 12), (320, 320), 320), ("a", 2, (6, 12, 12), (320,), 640),
    ("b", 2, (5, 9, 13), (120, 120), 120), ("b", 1, (7, 10, 6), (64, 128), 47),
    ("a", 2, (5, 7, 13), (64,), 47), ("b", 1, (6, 12, 12), (384, 384), 384),
]


def _wgmma_call(rng, device, form, n, spatial, cs, cout):
    ins = [_rand(rng, (n, *spatial, c)).to(device, torch.bfloat16) for c in cs]
    w = _rand(rng, (cout, sum(cs), 3, 3, 3), (2 / (27 * sum(cs))) ** 0.5).to(device)
    bias = _rand(rng, (cout,), 0.1).to(device)
    pw = cv.prepare_conv3d_weight(w, cs if form == "b" else None)
    fn = cv.conv3d_same if form == "a" else cv.conv3d_same_dual
    plan = cv.conv3d_same_plan(n, *spatial, cs if form == "b" else cs[0], cout, form)
    assert plan["ring"] == 0 and plan["wgmma"] == 1, plan
    return fn, ins, w, bias, pw


@pytest.mark.parametrize("form,n,spatial,cs,cout", WGMMA_CASES)
def test_wgmma_body_matches_plain(device, form, n, spatial, cs, cout):
    """Kernel A or B on the wgmma body into an output buffer filled with NaN
    against the plain version on the same bf16 inputs and weights, at phase
    2's bound; the launch counts on the wgmma body."""
    rng = np.random.default_rng(22)
    fn, ins, w, bias, pw = _wgmma_call(rng, device, form, n, spatial, cs, cout)
    before = dict(fn.launches_by_body)
    out = _nan_filled((n, *spatial, cout), device)
    got = fn(*ins, pw, bias, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.isfinite(got).all()
    assert fn.launches_by_body == {**before, "wgmma": before["wgmma"] + 1}
    ref = (cv.conv3d_same_ref(ins[0].float(), w.to(torch.bfloat16).float(), bias)
           if form == "a" else cv.conv3d_same_dual_ref(ins[0].float(), ins[1].float(),
                                                        w.to(torch.bfloat16).float(), bias))
    _assert_close(got, ref)


@pytest.mark.parametrize("form,n,spatial,cs,cout", [WGMMA_CASES[3], WGMMA_CASES[5],
                                                     WGMMA_CASES[-1]])
def test_wgmma_body_is_bit_equal_from_call_to_call(device, form, n, spatial, cs, cout):
    """No atomics: every output voxel is written by one block, the split K
    loop's partials added in a fixed order."""
    rng = np.random.default_rng(23)
    fn, ins, _, bias, pw = _wgmma_call(rng, device, form, n, spatial, cs, cout)
    first, second = fn(*ins, pw, bias), fn(*ins, pw, bias)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


# every A and B shape of chip_smoke's phase 2 (the flagship, Liver and
# SwinUNETR nets; A's dx as C -> 2C) whose plan named conv3d_same_kernel
# before the wgmma body: (form, N, spatial, input channels, Cout)
OLDER_BODY_SHAPES = (
    [("a", n, sp, (c,), c) for c, sp, ns in (
        (120, (24, 48, 48), (1, 2)), (240, (12, 24, 24), (1, 2)), (128, (32, 32, 32), (1, 4)),
        (256, (16, 16, 16), (1, 4)), (64, (64, 64, 64), (1, 4)), (48, (96, 192, 192), (1, 2)),
        (48, (48, 96, 96), (1, 2)), (96, (24, 48, 48), (1, 2)), (192, (12, 24, 24), (1, 2)),
        (384, (6, 12, 12), (2,))) for n in ns]
    + [("b", n, sp, (c, c), c) for c, sp, ns in (
        (120, (24, 48, 48), (1, 2)), (240, (12, 24, 24), (1, 2)), (320, (6, 12, 12), (1, 2)),
        (128, (32, 32, 32), (1, 4)), (256, (16, 16, 16), (1, 4)), (320, (8, 8, 8), (1, 4)),
        (64, (64, 64, 64), (1, 4)), (48, (96, 192, 192), (1, 2)), (48, (48, 96, 96), (1, 2)),
        (96, (24, 48, 48), (1, 2)), (192, (12, 24, 24), (1, 2)), (384, (6, 12, 12), (1, 2)))
       for n in ns]
    + [("a", 2, sp, (c,), 2 * c) for c, sp in (
        (120, (24, 48, 48)), (240, (12, 24, 24)), (320, (6, 12, 12)), (48, (96, 192, 192)),
        (48, (48, 96, 96)), (96, (24, 48, 48)), (192, (12, 24, 24)), (384, (6, 12, 12)))])


def test_wgmma_body_takes_every_call_of_the_older_body(device):
    """A and B never reach conv3d_same_kernel: each of those shapes' plans
    names the wgmma body, and so does D's dual form's at B's shapes."""
    for form, n, sp, cs, cout in OLDER_BODY_SHAPES:
        plan = cv.conv3d_same_plan(n, *sp, cs if form == "b" else cs[0], cout, form)
        assert plan["ring"] == 0 and plan["wgmma"] == 1, (form, n, sp, cs, cout, plan)
        if form == "b":
            d_plan = cv.conv3d_same_plan(n, *sp, cs, cout, "d_dual")
            assert _wgmma_plan(d_plan) == _wgmma_plan(plan), (n, sp, cs, d_plan)


# D's dual form on the wgmma body: (N, spatial, input channels, Cout, K
# split) at the flagship's 120 + 120 (whole K loop), 240 + 240 at N=2
# (whole) and 320 + 320 (split), ragged volumes (Z not a multiple of 4, X
# and Y not of 8) with a whole and a split K loop, unequal inputs and an odd
# Cout (split)
def _wgmma_plan(plan: dict) -> tuple:
    """The body a plan names and, for the wgmma body, its own plan."""
    return tuple(plan[k] for k in ("ring", "wgmma", "wgmma_bn", "wgmma_splits", "wgmma_blocks",
                                   "wgmma_smem_bytes"))


D_DUAL_WGMMA_CASES = [
    (1, (24, 48, 48), (120, 120), 120, False), (2, (12, 24, 24), (240, 240), 240, False),
    (1, (6, 12, 12), (320, 320), 320, True), (2, (13, 30, 29), (64, 64), 64, False),
    (2, (5, 9, 13), (120, 120), 120, True), (1, (7, 10, 6), (64, 128), 47, True),
]


@pytest.mark.parametrize("n,spatial,cs,cout,split", D_DUAL_WGMMA_CASES)
def test_d_dual_on_the_wgmma_body_matches_plain(device, n, spatial, cs, cout, split):
    """D's dual form at 16-byte rows runs the wgmma body with B's plan: its
    stats from the epilogue (whole K loop) or the split-K reduce (split),
    into NaN-filled buffers, within STATS_RTOL of its own output's; its
    output bit-equal to kernel B's at the same inputs and against the plain
    version at phase 2's bound; two calls bit-equal; the launch counted on
    the wgmma body."""
    rng = np.random.default_rng(26)
    plan = cv.conv3d_same_plan(n, *spatial, cs, cout, "d_dual")
    assert (plan["ring"], plan["wgmma"], plan["wgmma_splits"] > 1) == (0, 1, split), plan
    assert _wgmma_plan(plan) == _wgmma_plan(cv.conv3d_same_plan(n, *spatial, cs, cout, "b"))
    a, b = (_rand(rng, (n, *spatial, c)).to(device, torch.bfloat16) for c in cs)
    w = _rand(rng, (cout, sum(cs), 3, 3, 3), (2 / (27 * sum(cs))) ** 0.5).to(device)
    bias = _rand(rng, (cout,), 0.1).to(device)
    pw = cv.prepare_conv3d_weight(w, cs)
    before = dict(cv.conv3d_same_affine.launches_by_body)
    out, stats = _nan_filled((n, *spatial, cout), device), _nan_stats(n, cout, device)
    got, got_stats = cv.conv3d_same_dual_stats(a, b, pw, bias, out=out, stats=stats)
    torch.cuda.synchronize()
    assert cv.conv3d_same_affine.launches_by_body == {**before, "wgmma": before["wgmma"] + 1}
    assert got.data_ptr() == out.data_ptr() and torch.isfinite(got_stats).all()
    assert torch.equal(got, cv.conv3d_same_dual(a, b, pw, bias))
    again, again_stats = cv.conv3d_same_dual_stats(a, b, pw, bias)
    torch.cuda.synchronize()
    assert torch.equal(again, got) and torch.equal(again_stats, got_stats)
    ref, _ = cv.conv3d_same_dual_stats_ref(a, b, w.to(torch.bfloat16), bias)
    _assert_close(got, ref.float())
    assert _stats_err(got_stats, got) <= STATS_RTOL


def test_wgmma_probe_matches_torch(device):
    """One wgmma (m64 x 64 and x 128, k16) of a TMA-staged box at a tap's
    descriptor offset, halo and far-edge tiles included, against torch
    (probes/wgmma_forms.py raises past its bound)."""
    from multitalent_tpu_torch.probes import wgmma_forms
    rows = wgmma_forms.probe(device, torch.Generator(device=device).manual_seed(0))
    assert len(rows) == 2 * len(wgmma_forms.PROBE_CASES)


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


def _seghead_case(rng, shape, k, device, with_bias=False):
    n, c = shape[0], shape[-1]
    x = _rand(rng, shape, 2.0).to(device, torch.bfloat16)
    w = _rand(rng, (k, c, 1, 1, 1), 0.3).to(device)
    b = _rand(rng, (k,)).to(device) if with_bias else None
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    return x, w, b, sc, sh


def _guarded(n, k, spatial, dtype, device):
    """A NaN-filled output (n, k, *spatial) that is the front of a longer flat
    buffer: the guard elements after it must stay NaN."""
    size = n * k * int(np.prod(spatial))
    flat = torch.full((size + 4096,), float("nan"), dtype=dtype, device=device)
    return flat[:size].view(n, k, *spatial), flat[size:]


@pytest.mark.parametrize("c,k", [(8, 47), (12, 47), (30, 47), (32, 47), (60, 47),
                                 (30, 1), (30, 5), (30, 64), (69, 47), (128, 47)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_seghead_widths_match_plain(device, c, k, out_dtype):
    """Kernel F at the widths it takes (C padded to 16, 32, 64 or 128
    channels; K rows in passes of up to 64), N = 2, a volume of S = 105
    voxels (a ragged last tile, S % 8 != 0: narrow stores), bias on, into a
    NaN-filled output whose guard after the last element stays NaN."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(c * 100 + k)
    shape = (2, 3, 5, 7, c)
    x, w, b, sc, sh = _seghead_case(rng, shape, k, device, with_bias=True)
    out, guard = _guarded(2, k, shape[1:4], out_dtype, device)
    got = sg.seghead(x, w, b, sc, sh, 1e-2, out_dtype, out=out)
    torch.cuda.synchronize()
    assert got.data_ptr() == out.data_ptr() and torch.isnan(guard).all()
    assert torch.isfinite(got).all()
    _assert_close(got, sg.seghead_ref(x, w, b, sc, sh, 1e-2, torch.float32))
    # without the prologue
    got = sg.seghead(x, w, None, None, None, 1e-2, out_dtype)
    _assert_close(got, sg.seghead_ref(x, w, None, None, None, 1e-2, torch.float32))


@pytest.mark.parametrize("shape", [(1, 4, 16, 16, 30), (2, 4, 16, 16, 30),
                                   (1, 5, 9, 13, 30), (3, 1, 1, 70, 30)])
def test_seghead_tiles_and_samples_match_plain(device, shape):
    """Kernel F's walk: S a multiple of the 64-voxel tile and 16-byte stores
    (N = 1, 2), a ragged S (585 voxels), and samples of 70 voxels whose tiles
    straddle no sample (3 samples, bf16 out)."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(11)
    x, w, b, sc, sh = _seghead_case(rng, shape, 47, device)
    out, guard = _guarded(shape[0], 47, shape[1:4], torch.bfloat16, device)
    got = sg.seghead(x, w, b, sc, sh, 1e-2, torch.bfloat16, out=out)
    torch.cuda.synchronize()
    assert torch.isnan(guard).all() and torch.isfinite(got).all()
    _assert_close(got, sg.seghead_ref(x, w, b, sc, sh, 1e-2, torch.float32))


def test_seghead_takes_a_2_byte_aligned_view(device):
    """A contiguous bf16 input at an odd element offset: kernel F copies its
    runs element by element instead of 16-byte cp.async."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(12)
    shape = (2, 3, 5, 7, 30)
    flat = _rand(rng, (1 + int(np.prod(shape)),), 2.0).to(device, torch.bfloat16)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 4 == 2
    _, w, b, sc, sh = _seghead_case(rng, shape, 47, device, with_bias=True)
    got = sg.seghead(x, w, b, sc, sh, 1e-2, torch.bfloat16)
    _assert_close(got, sg.seghead_ref(x, w, b, sc, sh, 1e-2, torch.float32))


def test_seghead_refreshes_its_prepared_weight_after_an_in_place_update(device):
    """The padded bf16 weight is built once per weight version: a second call
    reuses it, an in-place update of the weight (as an optimizer step or a
    load_state_dict makes) rebuilds it."""
    from multitalent_tpu_torch.ops import seghead as sg
    rng = np.random.default_rng(13)
    x, w, b, sc, sh = _seghead_case(rng, (1, 4, 8, 8, 30), 47, device)
    w = torch.nn.Parameter(w)
    first = sg.seghead(x, w, b, sc, sh, 1e-2, torch.float32)
    prepared = sg.prepared_head_weight(w, device)
    assert sg.prepared_head_weight(w, device) is prepared
    with torch.no_grad():
        w.mul_(-2.0)
    again = sg.seghead(x, w, b, sc, sh, 1e-2, torch.float32)
    assert sg.prepared_head_weight(w, device) is not prepared
    _assert_close(again, sg.seghead_ref(x, w.detach(), b, sc, sh, 1e-2, torch.float32))
    assert not torch.allclose(first, again)


@pytest.mark.parametrize("c", [1, 3, 8, 13, 30, 60, 240, 320])
@pytest.mark.parametrize("spatial", [(4, 6, 8), (5, 7, 9), (24, 48, 48)])
def test_channel_stats_widths_match_plain_and_repeat_bit_for_bit(device, c, spatial):
    """Kernel E's stats pass at every channel period (c / gcd(c, 8): 1, 3,
    1, 13, 15, 15, 30, 40), on runs that 16-byte vectors fit (4x6x8), that
    they do not (5x7x9: s * c % 8 != 0 but at c = 8; the pair or single
    channel form) and of many chunks (24x48x48: the partials and one
    reduce_rows launch), N = 2: within 1e-4 of the sums of |terms|, and two
    calls bit-equal."""
    from multitalent_tpu_torch.ops import fused_norm as fn
    if c >= 240 and spatial == (24, 48, 48):
        spatial = (12, 24, 24)
    rng = np.random.default_rng(c)
    x = (_rand(rng, (2, *spatial, c), 3.0) + 1).to(device, torch.bfloat16)
    first, second = fn.channel_stats(x), fn.channel_stats(x)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    err = ((first - fn.channel_stats_ref(x)).abs() / fn.channel_stats_ref(x.abs())).max()
    assert err.item() <= 1e-4


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("spatial", [(6, 12, 12), (6, 6, 6)])
def test_d_split_k_stats_by_kernel_e_at_320(device, n, spatial):
    """Kernel D at 320 channels splits its K loop and takes its stats in the
    split-K reduce, from the values it stores: within STATS_RTOL of the
    plain stats of that output."""
    rng = np.random.default_rng(17)
    c = 320
    assert cv.conv3d_same_plan(n, *spatial, c, c, "d")["splits"] > 1
    x = _rand(rng, (n, *spatial, c), 2.0).to(device, torch.bfloat16)
    w = _rand(rng, (c, c, 3, 3, 3), (2 / (27 * c)) ** 0.5).to(device)
    b = _rand(rng, (c,), 0.1).to(device)
    sc = (_rand(rng, (n, c)).abs() + 0.5).to(device)
    sh = _rand(rng, (n, c)).to(device)
    got, stats = cv.conv3d_same_affine(x, cv.prepare_conv3d_weight(w), b, sc, sh,
                                       out=_nan_filled((n, *spatial, c), device),
                                       stats=_nan_stats(n, c, device))
    torch.cuda.synchronize()
    ref, _ = cv.conv3d_same_affine_ref(x, w.to(torch.bfloat16), b, sc, sh)
    _assert_close(got, ref.float())
    assert _stats_err(stats, got) <= STATS_RTOL


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


# ---------------------------------------------------------------------------
# the probes' kernels (multitalent_tpu_torch/probes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arm", ["im2col", "tap3", "wino"])
@pytest.mark.parametrize("shape,cout", [
    ((1, 8, 16, 16, 120), 120),   # the script's parity shape
    ((2, 6, 10, 14, 30), 47),     # ragged boxes and channels, batch 2 (C % 8 != 0)
    ((1, 4, 6, 8, 13), 24),       # odd C (1-channel loads)
    ((2, 6, 10, 14, 64), 47),     # ragged tile groups and boxes, batch 2, Cout < CoutP
    ((1, 10, 12, 18, 16), 30),    # C under one chunk, Y and X past a box
    ((1, 4, 6, 8, 40), 24),       # C_P past a chunk's end (tap3: 32 + 8 channels)
])
def test_conv_arm_matches_the_direct_conv(device, arm, shape, cout):
    """The im2col, tap3 and Winograd arms against the fp32 direct conv on the
    same bf16 input (fp32 weights), the bound of probes/conv_impl_arms.py,
    into a NaN-filled buffer, on the body each arm's plan names (wgmma fed
    by TMA where C % 8 == 0, the first body otherwise), counted by body."""
    from multitalent_tpu_torch.probes import conv_impl_arms as ca
    rng = np.random.default_rng(9)
    x = _rand(rng, shape).to(device, torch.bfloat16)
    w = _rand(rng, (cout, shape[-1], 3, 3, 3), (2 / (27 * shape[-1])) ** 0.5).to(device)
    kernel = {"im2col": ca.conv3d_im2col, "tap3": ca.conv3d_tap3, "wino": ca.conv3d_wino}[arm]
    plan = {"im2col": ca.im2col_plan, "tap3": ca.tap3_plan, "wino": ca.wino_plan}[arm]
    body = plan(*shape, cout)["body"]
    assert body == ("tma" if shape[-1] % 8 == 0 else "mma_sync")
    before, by_body = kernel.launches, dict(kernel.launches_by_body)
    out = _nan_filled((*shape[:4], cout), device)
    pw = ca.prepare_arm_weight(w, arm)
    got = kernel(x, pw, out=out)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1 and got.data_ptr() == out.data_ptr()
    after = kernel.launches_by_body
    assert {k: after[k] - by_body[k] for k in after} == {k: int(k == body) for k in after}
    assert got.dtype == torch.bfloat16 and got.shape == (*shape[:4], cout)
    ref = cv.conv3d_same_ref(x.float(), w)
    assert (got.float() - ref).abs().max().item() <= ca.ATOL + ca.RTOL * ref.abs().max().item()
    if arm == "wino":
        # against its own plain version with the kernel's rounding points (U,
        # V and the output each rounded to bf16 once): both round fp32 sums
        # taken in other orders (64-channel chunks, wgmma's order) to bf16, so
        # they may differ by one bf16 ulp of the output, 2^-7 of max|ref|
        own = ca.winograd_conv3d_ref(x.float(), pw, v_dtype=torch.bfloat16)
        assert (got.float() - own).abs().max().item() <= 1e-3 + 2 ** -7 * own.abs().max().item()
        # the control: G with one row wrong breaks the bound
        bad = ca.conv3d_wino(x, ca.prepare_arm_weight(w, "wino", g=ca.G_FAULTY))
        assert (bad.float() - ref).abs().max().item() > ca.ATOL + ca.RTOL * ref.abs().max().item()


@pytest.mark.parametrize("shape,cout,body", [
    ((1, 8, 16, 16, 120), 120, "tma"),   # the script's parity shape
    ((2, 6, 10, 14, 64), 47, "tma"),     # ragged last M tile, batch 2, Cout < CoutP
    ((1, 5, 7, 9, 40), 24, "tma"),       # C under one 64-channel chunk, odd sizes
    ((2, 6, 10, 14, 30), 47, "mma_sync"),  # C % 8 != 0: the first body
    ((1, 4, 6, 8, 13), 24, "mma_sync"),
])
def test_im2col_bodies_match_the_direct_conv(device, shape, cout, body):
    """The im2col arm on the body its plan names, by C: TMA im2col loads and
    wgmma where C % 8 == 0, else the first body; into a NaN-filled buffer,
    against the fp32 direct conv, counted in launches_by_body."""
    from multitalent_tpu_torch.probes import conv_impl_arms as ca
    assert ca.im2col_plan(*shape, cout)["body"] == body
    rng = np.random.default_rng(12)
    x = _rand(rng, shape).to(device, torch.bfloat16)
    w = _rand(rng, (cout, shape[-1], 3, 3, 3), (2 / (27 * shape[-1])) ** 0.5).to(device)
    before = dict(ca.conv3d_im2col.launches_by_body)
    out = _nan_filled((*shape[:4], cout), device)
    got = ca.conv3d_im2col(x, ca.prepare_arm_weight(w, "im2col"), out=out)
    torch.cuda.synchronize()
    after = ca.conv3d_im2col.launches_by_body
    assert {k: after[k] - before[k] for k in after} == {k: int(k == body) for k in after}
    ref = cv.conv3d_same_ref(x.float(), w)
    assert (got.float() - ref).abs().max().item() <= ca.ATOL + ca.RTOL * ref.abs().max().item()


@pytest.mark.parametrize("factors,c,groups,cout", [
    ((2, 2), 30, None, 24), ((1, 2), 60, None, 24), ((2, 2), 32, (20, 12), 24),
    ((2, 2), 13, (6, 7), 30),    # odd groups: element loads
    ((2, 2), 48, (32, 16), 40),  # 16-byte copies, BN 64 with streamed weights
    ((1, 2), 60, None, 60),      # the flagship's stage-1 width
])
def test_packed_conv_matches_plain(device, factors, c, groups, cout):
    from multitalent_tpu_torch.probes import sparse_conv_arm as sc
    rng = np.random.default_rng(10)
    sizes = (c,) if groups is None else groups
    xg = torch.cat([sc.space_to_depth_yx(_rand(rng, (2, 6, 16, 12, g)), factors) for g in sizes],
                   -1).to(device, torch.bfloat16)
    w = _rand(rng, (cout, c, 3, 3, 3), 0.1).to(device)
    before = sc.packed_conv3d.launches
    out = _nan_filled((*xg.shape[:4], xg.shape[-1] // c * cout), device)
    got = sc.packed_conv3d(xg, cv.prepare_conv3d_weight(w), factors, groups, out=out)
    torch.cuda.synchronize()
    assert sc.packed_conv3d.launches == before + 1 and got.data_ptr() == out.data_ptr()
    _assert_close(got, sc.packed_conv3d_ref(xg.float(), w.to(torch.bfloat16).float(), factors,
                                            groups))


# (factors, C, Cout, unpacked (N, Z, Y, X)) where kernel A's plan has one
# split: the K split by warp groups at 30 channels (ragged X under a box),
# resident weights at 60 -> 24, streamed at 60 -> 60
PACKED_AS_A = [((2, 2), 30, 30, (1, 16, 32, 28)), ((1, 2), 60, 24, (2, 8, 16, 16)),
               ((1, 2), 60, 60, (1, 24, 48, 48))]
RING_KEYS = ("ring", "g", "resident", "ksplit", "stages", "splits", "grid_x", "blocks_per_sm",
             "smem_bytes")


@pytest.mark.parametrize("factors,c,cout,size", PACKED_AS_A)
def test_packed_conv_is_kernel_a_bit_for_bit(device, factors, c, cout, size):
    """The packed conv runs kernel A's ring plan with the K loop whole: where
    A's own plan has one split, its ring config is A's, and its output is
    space_to_depth(A(depth_to_space(x))) without bias bit for bit."""
    from multitalent_tpu_torch.probes import sparse_conv_arm as sc
    a_plan = cv.conv3d_same_plan(*size, c, cout, "a")
    plan = cv.conv3d_same_plan(*size, c, cout, "packed")
    assert a_plan["ring"] == 1 and a_plan["splits"] == 1, a_plan
    assert {k: plan[k] for k in RING_KEYS} == {k: a_plan[k] for k in RING_KEYS}
    rng = np.random.default_rng(16)
    x = _rand(rng, (*size, c)).to(device, torch.bfloat16)
    pw = cv.prepare_conv3d_weight(_rand(rng, (cout, c, 3, 3, 3), (2 / (27 * c)) ** 0.5)
                                  .to(device))
    xp = sc.space_to_depth_yx(x, factors).contiguous()
    got = sc.packed_conv3d(xp, pw, factors, out=_nan_filled((*xp.shape[:4], xp.shape[-1] //
                                                             c * cout), device))
    want = sc.space_to_depth_yx(cv.conv3d_same(x, pw), factors)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# (volume and C, tile): one x-row a run at C = 8, 24 and 128, planes of rows
# where the tile spans X (C = 200), a non-cubic volume, one run a tile where
# it spans X and Y, one block (its bulk stores in 32 KB pieces and a ragged
# last one)
ZERO_CASES = [((12, 20, 24, 8), (4, 5, 6)), ((6, 10, 14, 24), (3, 2, 7)),
              ((16, 16, 16, 128), (8, 16, 8)), ((8, 12, 16, 200), (2, 4, 16)),
              ((6, 10, 14, 24), (3, 10, 14)), ((10, 6, 8, 128), (10, 6, 8)),
              ((16, 32, 32, 128), (16, 32, 32))]


@pytest.mark.parametrize("shape,tile", ZERO_CASES)
@pytest.mark.parametrize("form", [0, 1, 2])
def test_zero_fill_forms_write_zeros_and_nothing_else(device, shape, tile, form):
    """Each form of the zero fill (form 0: the entry `zeros`, vector stores;
    1 vector stores, 2 bulk stores through mt_zeros_form) into
    a view of a NaN-filled buffer: every value of the view 0, the guard
    regions before and after it still NaN."""
    from multitalent_tpu_torch.probes import _util
    from multitalent_tpu_torch.probes import grid_overhead_probe as gp
    numel, guard = int(np.prod(shape)), 64
    buf = torch.full((guard + numel + guard,), float("nan"), dtype=torch.bfloat16, device=device)
    out = buf[guard:guard + numel].view(shape)
    if form == 0:
        before = gp.zeros.launches
        assert gp.zeros(shape, tile, device, out=out) is out
        assert gp.zeros.launches == before + 1
    else:
        _util.launch("mt_zeros_form", device, out.data_ptr(), *shape, *tile, form)
    torch.cuda.synchronize()
    assert (out == 0).all()
    assert torch.isnan(buf[:guard]).all() and torch.isnan(buf[guard + numel:]).all()


@pytest.mark.parametrize("ndots,tile,cout", [(27, (8, 16, 16), 128), (12, (4, 8, 8), 96),
                                             (5, (16, 16, 16), 128)])
def test_centern_and_zeros_match_plain(device, ndots, tile, cout):
    from multitalent_tpu_torch.probes import conv_cost_isolate as cc
    from multitalent_tpu_torch.probes import grid_overhead_probe as gp
    rng = np.random.default_rng(11)
    x = _rand(rng, (1, 16, 16, 16, 128)).to(device, torch.bfloat16)
    w = _rand(rng, (cout, 128, 3, 3, 3), 0.05).to(device)
    before = cc.centern.launches
    out = _nan_filled((1, 16, 16, 16, cout), device)
    got = cc.centern(x, cc.prepare_center_weight(w), ndots, tile, cout, out=out)
    torch.cuda.synchronize()
    assert cc.centern.launches == before + 1 and got.data_ptr() == out.data_ptr()
    _assert_close(got, cc.centern_ref(x.float(), w.to(torch.bfloat16).float(), ndots))
    # into a NaN-filled buffer: every value the fill leaves unwritten stays NaN
    before = gp.zeros.launches
    out = _nan_filled((16, 16, 16, 128), device)
    z = gp.zeros((16, 16, 16, 128), tile, device, out=out)
    torch.cuda.synchronize()
    assert gp.zeros.launches == before + 1 and z.data_ptr() == out.data_ptr()
    assert (z == 0).all()


@pytest.mark.parametrize("shape,ndots,tile,cout", [
    ((1, 16, 16, 16, 128), 1, (8, 16, 16), 128),    # one dot
    ((2, 8, 8, 16, 128), 27, (2, 4, 8), 120),       # a tile under one 256-voxel sub-tile
    ((1, 12, 12, 24, 64), 12, (6, 6, 12), 47),      # 432 voxels: 216-row sub-tiles
    ((1, 16, 24, 48, 128), 27, (8, 24, 48), 128),   # fewer tiles than SMs
    ((1, 8, 8, 8, 16), 5, (4, 8, 8), 16),           # C = 16: one k16 step
])
def test_centern_sub_tiles_match_plain(device, shape, ndots, tile, cout):
    """centern's wgmma body at tiles of other sub-tile shapes (whole,
    ragged and partial m64 products), into a NaN-filled buffer."""
    from multitalent_tpu_torch.probes import conv_cost_isolate as cc
    rng = np.random.default_rng(13)
    x = _rand(rng, shape).to(device, torch.bfloat16)
    w = _rand(rng, (cout, shape[-1], 3, 3, 3), 0.05).to(device)
    before = cc.centern.launches
    out = _nan_filled((*shape[:4], cout), device)
    got = cc.centern(x, cc.prepare_center_weight(w), ndots, tile, cout, out=out)
    torch.cuda.synchronize()
    assert cc.centern.launches == before + 1 and got.data_ptr() == out.data_ptr()
    _assert_close(got, cc.centern_ref(x.float(), w.to(torch.bfloat16).float(), ndots))
