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
