"""The port's conv kernels (ops/conv3d.py) against the JAX package's Pallas
kernels 1-3, on the CPU: Pallas in interpret mode, the port through its
wrappers, which take the plain PyTorch versions for CPU tensors (after a round
trip through the kernel's prepared weight layout).

Tolerances are the fp32 ones of tests/test_pallas_ops.py (atol=2e-4,
rtol=1e-3): both sides accumulate in fp32, in different orders.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from multitalent_tpu.ops.packed_conv import depth_to_space_yx, space_to_depth_yx
from multitalent_tpu.ops.pallas_conv import pallas_conv3d_same
from multitalent_tpu.ops.pallas_merged_conv import (pallas_packed_conv3d_merged,
                                                    pallas_packed_conv3d_merged2,
                                                    prepare_merged, prepare_merged2)
from multitalent_tpu_torch import _build
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import wgmma_layout as wl

from test_torch_port_predict import one_thread  # noqa: F401 (fixture: one intra-op thread)

ATOL, RTOL = 2e-4, 1e-3


def _torch_weight(w_dhwio: np.ndarray) -> torch.Tensor:
    """flax (kz, ky, kx, I, O) -> torch Conv3d (O, I, kz, ky, kx)"""
    return torch.from_numpy(np.ascontiguousarray(w_dhwio.transpose(4, 3, 0, 1, 2)))


def _port_conv(x: np.ndarray, w_dhwio: np.ndarray) -> np.ndarray:
    pw = cv.prepare_conv3d_weight(_torch_weight(w_dhwio), dtype=torch.float32)
    return cv.conv3d_same(torch.from_numpy(x), pw).numpy()


@pytest.mark.parametrize("shape,cout", [((1, 8, 16, 16, 8), 8), ((2, 4, 8, 8, 8), 16)])
def test_conv3d_same_matches_pallas_conv_kernel(shape, cout):
    """Kernel A vs pallas_conv.py:_conv_kernel (the shapes of
    test_pallas_conv3d_same_interpret_matches_lax)."""
    rng = np.random.RandomState(5)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(3, 3, 3, shape[-1], cout).astype(np.float32)
    ref = np.asarray(pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w), interpret=True))
    np.testing.assert_allclose(_port_conv(x, w), ref, atol=ATOL, rtol=RTOL)
    # the plain version itself, on the unprepared weight
    plain = cv.conv3d_same_ref(torch.from_numpy(x), _torch_weight(w)).numpy()
    np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape,cout", [((1, 8, 16, 16, 8), 16), ((2, 4, 8, 8, 8), 8)])
def test_conv3d_same_and_its_dx_write_into_out(shape, cout):
    """Kernel A's `out=` (chip_smoke and the card tests pass a NaN-filled
    buffer): the result lands in the caller's buffer, which comes back; so
    does dx's, against pallas_conv.py:_conv_kernel on the flipped, transposed
    weight (the rule of pallas_conv.py:conv3d_same_dx); a buffer of another
    shape is refused."""
    rng = np.random.RandomState(6)
    x = rng.randn(*shape).astype(np.float32)
    w = rng.randn(3, 3, 3, shape[-1], cout).astype(np.float32)
    pw = cv.prepare_conv3d_weight(_torch_weight(w), dtype=torch.float32)
    out = torch.full((*shape[:4], cout), float("nan"))
    got = cv.conv3d_same(torch.from_numpy(x), pw, out=out)
    ref = np.asarray(pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w), interpret=True))
    assert got is out
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
    g = rng.randn(*shape[:4], cout).astype(np.float32)
    dx_out = torch.full(shape, float("nan"))
    dx = cv.conv3d_same_dx(torch.from_numpy(g), _torch_weight(w), out=dx_out)
    w_t = np.ascontiguousarray(w[::-1, ::-1, ::-1].transpose(0, 1, 2, 4, 3))
    ref_dx = np.asarray(pallas_conv3d_same(jnp.asarray(g), jnp.asarray(w_t), interpret=True))
    assert dx is dx_out
    np.testing.assert_allclose(dx_out.numpy(), ref_dx, atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="out"):
        cv.conv3d_same(torch.from_numpy(x), pw, out=torch.empty(*shape[:4], cout + 1))


@pytest.mark.parametrize("factors,c", [((2, 2), 30), ((1, 2), 60)])
def test_conv3d_same_matches_pallas_merged_kernel(factors, c):
    """Kernel A, unpacked, vs pallas_merged_conv.py:_merged_kernel on the
    space-to-depth packed tensor, compared through depth_to_space."""
    rng = np.random.RandomState(7)
    x = rng.randn(1, 8, 16, 16, c).astype(np.float32)
    w = (rng.randn(3, 3, 3, c, c) * 0.1).astype(np.float32)
    packed = pallas_packed_conv3d_merged(space_to_depth_yx(jnp.asarray(x), factors),
                                         prepare_merged(jnp.asarray(w), factors),
                                         interpret=True)
    ref = np.asarray(depth_to_space_yx(packed, factors))
    np.testing.assert_allclose(_port_conv(x, w), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("g0,g1,cout", [(30, 30, 30), (20, 10, 16)])
def test_conv3d_same_dual_matches_pallas_merged2_kernel(g0, g1, cout):
    """Kernel B vs pallas_merged_conv.py:_merged2_kernel (the groups of
    test_merged2_conv_interpret_matches_grouped_dense); unequal groups catch
    a swapped [up | skip] order."""
    rng = np.random.RandomState(8)
    a = rng.randn(1, 8, 16, 16, g0).astype(np.float32)
    b = rng.randn(1, 8, 16, 16, g1).astype(np.float32)
    w = (rng.randn(3, 3, 3, g0 + g1, cout) * 0.1).astype(np.float32)
    f = (2, 2)
    packed = pallas_packed_conv3d_merged2(
        space_to_depth_yx(jnp.asarray(a), f), space_to_depth_yx(jnp.asarray(b), f),
        prepare_merged2(jnp.asarray(w), f, (g0, g1)), interpret=True)
    ref = np.asarray(depth_to_space_yx(packed, f))
    pw = cv.prepare_conv3d_weight(_torch_weight(w), splits=(g0, g1), dtype=torch.float32)
    got = cv.conv3d_same_dual(torch.from_numpy(a), torch.from_numpy(b), pw).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)
    plain = cv.conv3d_same_dual_ref(torch.from_numpy(a), torch.from_numpy(b),
                                    _torch_weight(w)).numpy()
    np.testing.assert_allclose(plain, ref, atol=ATOL, rtol=RTOL)
    if g0 != g1:
        swapped = cv.conv3d_same_dual_ref(torch.from_numpy(b), torch.from_numpy(a),
                                          _torch_weight(w))
        assert np.abs(swapped.numpy() - ref).max() > 1e-2


@pytest.mark.parametrize("splits", [(30,), (47,), (20, 10), (13, 3)])
def test_prepared_weight_layout_round_trips(splits):
    w = torch.randn(47, sum(splits), 3, 3, 3)
    pw = cv.prepare_conv3d_weight(w, splits, dtype=torch.float32)
    assert pw.w.shape == (sum(-(-s // 16) for s in splits), 27, 16, 64)
    assert torch.equal(cv.unprepare_conv3d_weight(pw), w)
    # the same layout as the wgmma body's B operand: each tap's k16 x 128
    # read through its descriptor from the swizzled TMA weight stage gives
    # the prepared rows back, 0 past CoutP; reassembled, the weight again
    taps = torch.stack([torch.stack([
        wl.read_b(wl.weight_stage(pw, kc, t // 9, 0, 128), wl.weight_desc(0, t % 9), 128)
        for t in range(27)]) for kc in range(pw.w.shape[0])])
    assert torch.equal(taps[..., pw.coutp:], torch.zeros_like(taps[..., pw.coutp:]))
    back = cv.PreparedWeight(taps[..., :pw.coutp].contiguous(), pw.splits, pw.cout, pw.bn)
    assert torch.equal(back.w, pw.w)
    assert torch.equal(cv.unprepare_conv3d_weight(back), w)


# the wgmma body's addressing (ops/wgmma_layout.py): the TMA halo box with its
# zero fill, then for each tap the descriptor's start, LBO and SBO read as
# wgmma reads the no-swizzle K-major A and the 128-byte-swizzled MN-major B,
# in float64; against the plain version at ragged X (6, 12, 13; Z and Y past
# a 4x8x8 tile too) and N = 2, and against the Pallas kernels in interpret
# mode at the shapes they take (X a multiple of 8; _merged2_kernel's halves
# of at most 32 channels). Cout 72 takes BN 128's second 64-column box, 0
# past CoutP.
EMULATION_EXACT = 1e-9  # float64 sums in another order


@pytest.mark.parametrize("c", [24, 40, 48])
@pytest.mark.parametrize("xd", [6, 12, 13])
def test_wgmma_addressing_matches_plain(c, xd):
    rng = np.random.RandomState(c * 100 + xd)
    cout, bn = (72, 128) if c == 40 else (20, 64)
    x = torch.from_numpy(rng.randn(2, 5, 9, xd, c))
    w = torch.from_numpy(rng.randn(cout, c, 3, 3, 3) * 0.1)
    b = torch.from_numpy(rng.randn(cout))
    pw = cv.prepare_conv3d_weight(w, dtype=torch.float64)
    got = wl.conv3d([x], pw, b, bn=bn)
    np.testing.assert_allclose(got.numpy(), cv.conv3d_same_ref(x, w, b).numpy(),
                               atol=EMULATION_EXACT, rtol=EMULATION_EXACT)


@pytest.mark.parametrize("c", [24, 40, 48])
def test_wgmma_addressing_matches_pallas_conv_kernel(c):
    """As kernel A against pallas_conv.py:_conv_kernel, N = 2."""
    rng = np.random.RandomState(c)
    cout = 72 if c == 40 else 20
    x = rng.randn(2, 6, 12, 16, c).astype(np.float32)
    w = (rng.randn(3, 3, 3, c, cout) * 0.1).astype(np.float32)
    ref = np.asarray(pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w), interpret=True))
    pw = cv.prepare_conv3d_weight(_torch_weight(w), dtype=torch.float32)
    got = wl.conv3d([torch.from_numpy(x)], pw, bn=128 if cout > 64 else 64)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("g0,g1", [(24, 40), (24, 32)])
def test_wgmma_addressing_of_the_dual_conv(g0, g1):
    """As kernel B ([a | b] chunk order, each input's odd half chunk read
    as 0 past its channels) against the plain version, N = 2, X 13; and at
    24 + 32 against pallas_merged_conv.py:_merged2_kernel."""
    rng = np.random.RandomState(g0 + g1)
    a = torch.from_numpy(rng.randn(2, 3, 9, 13, g0))
    b = torch.from_numpy(rng.randn(2, 3, 9, 13, g1))
    w = torch.from_numpy(rng.randn(30, g0 + g1, 3, 3, 3) * 0.1)
    pw = cv.prepare_conv3d_weight(w, (g0, g1), dtype=torch.float64)
    got = wl.conv3d([a, b], pw, bn=64)
    np.testing.assert_allclose(got.numpy(), cv.conv3d_same_dual_ref(a, b, w).numpy(),
                               atol=EMULATION_EXACT, rtol=EMULATION_EXACT)
    if g1 > 32:
        return
    a = rng.randn(2, 4, 8, 16, g0).astype(np.float32)
    b = rng.randn(2, 4, 8, 16, g1).astype(np.float32)
    w = (rng.randn(3, 3, 3, g0 + g1, 30) * 0.1).astype(np.float32)
    f = (2, 2)
    packed = pallas_packed_conv3d_merged2(
        space_to_depth_yx(jnp.asarray(a), f), space_to_depth_yx(jnp.asarray(b), f),
        prepare_merged2(jnp.asarray(w), f, (g0, g1)), interpret=True)
    ref = np.asarray(depth_to_space_yx(packed, f))
    pw = cv.prepare_conv3d_weight(_torch_weight(w), (g0, g1), dtype=torch.float32)
    got = wl.conv3d([torch.from_numpy(a), torch.from_numpy(b)], pw, bn=64)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)


def test_wgmma_descriptors_encode_the_body_offsets():
    """The descriptor fields round-trip, and tap (dz, dy, dx) of plane p
    moves the A operand's start by ((p + dz) * 10 + dy) * 160 + dx * 16
    bytes: one staged box serves all 27 taps."""
    d = wl.descriptor(0x1230, wl.UNIT_BYTES, wl.LINE_BYTES, wl.LAYOUT_NONE)
    assert wl.decode(d) == (0x1230, 9600, 160, 0)
    assert wl.decode(wl.weight_desc(2048, 3))[1:] == (18432, 1024, 1)
    starts = {wl.decode(wl.box_desc(0, p, t // 9, t // 3 % 3, t % 3))[0]
              for p in range(4) for t in range(27)}
    assert max(starts) + 7 * wl.LINE_BYTES + 128 <= wl.UNIT_BYTES
    assert wl.decode(wl.box_desc(0, 1, 2, 1, 2))[0] == ((1 + 2) * 10 + 1) * 160 + 2 * 16


def test_cpu_calls_do_not_count_as_launches():
    x = torch.zeros(1, 4, 4, 4, 8)
    pw = cv.prepare_conv3d_weight(torch.zeros(8, 8, 3, 3, 3), dtype=torch.float32)
    a, b = cv.conv3d_same.launches, cv.conv3d_same_dual.launches
    cv.conv3d_same(x, pw)
    cv.conv3d_same_dual(x, x, cv.prepare_conv3d_weight(
        torch.zeros(8, 16, 3, 3, 3), (8, 8), dtype=torch.float32))
    assert (cv.conv3d_same.launches, cv.conv3d_same_dual.launches) == (a, b)


def test_wrapper_refuses_other_devices_without_counting():
    x = torch.zeros(1, 4, 4, 4, 8, device="meta", dtype=torch.bfloat16)
    pw = cv.prepare_conv3d_weight(torch.zeros(8, 8, 3, 3, 3))
    before = cv.conv3d_same.launches
    with pytest.raises(ValueError, match="unsupported device"):
        cv.conv3d_same(x, pw)
    with pytest.raises(ValueError, match="unsupported device"):
        cv.conv3d_same_dual(x, x, pw)
    assert cv.conv3d_same.launches == before


def test_build_without_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    """The kernel launcher builds with nvcc at first use; without nvcc it raises
    a clear error and the wrapper's count stays unchanged."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_lib", None)
    before = cv.conv3d_same.launches
    x = torch.zeros(1, 4, 4, 4, 8, dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cv._launch("mt_conv3d_same", [x], cv.prepare_conv3d_weight(
            torch.zeros(8, 8, 3, 3, 3)), None)
    assert cv.conv3d_same.launches == before
    assert not (tmp_path / "build").exists()
