"""The host side of the fp32 ring body of kernels A and B
(csrc/conv3d_fp32.cu conv_fp32_ring_kernel, planned by
ops/conv3d.py:conv3d_same_fp32_plan), on the CPU.

The plan's choices (the box, the K splits, resident weights, ring stages,
the grid) are held to their rules at the Task003 Liver fp32 step's shapes
and the flagship's 30-channel ones. Then the body's walk is replayed in
torch exactly as the kernel addresses it: blocks (box walker, column block,
K split), each block's boxes in order, 8-channel stages of each input's halo
(zero outside the volume and past the input's channels), each stage's
27 x 8 x 32 weights read from the prepared layout of prepare_conv3d_weight
as it is (16-row chunks, each input starting a chunk), the splits' partials
added in split order after the bias. The replay must write every output
entry once a split and agree with the JAX package's Pallas conv kernel
(pallas_conv.py:_conv_kernel, fp32, interpret mode; on the concat for B) at
two volumes its block picker takes, and with the plain version in fp64 at
the others (ragged volumes, which the Pallas kernel refuses).
The body reads no other weight layout, so there is none to round-trip.

Tolerances are tests/test_torch_port_kernels.py's fp32 ones (atol 2e-4,
rtol 1e-3): both sides sum fp32 products in different orders.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from multitalent_tpu.ops.pallas_conv import pallas_conv3d_same
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import fp32_forms

ATOL, RTOL = 2e-4, 1e-3
H100_SMS = 132

# (N, spatial, Ca, Cb, Cout) of every fp32 A/B call of one Liver fp32 step
# (forwards, the A convs' dx, the B convs' dx), then the flagship's 30-channel
# A, B and B's dx at N=1: the shapes chip_smoke.py's 14a times
LIVER_STEP, FLAGSHIP = fp32_forms.STEP_SHAPES, fp32_forms.FLAGSHIP_SHAPES


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("spatial", [(128, 128, 128), (96, 192, 192), (4, 4, 4), (5, 7, 19),
                                     (2, 40, 40), (3, 9, 70), (16, 3, 33)])
def test_plan_box_wastes_fewest_voxels(spatial):
    """The box is the first of FP32_RING_BOXES with the fewest boxes a
    sample; every box holds 512 voxels, x a multiple of the thread's 8
    voxels, y 8 or 16 (a warp's 8 voxel groups are neighbouring rows)."""
    plan = cv.conv3d_same_fp32_plan(1, *spatial, 32, 0, 32, sms=H100_SMS)
    counts = [np.prod([_cdiv(s, b) for s, b in zip(spatial, box)])
              for box in cv.FP32_RING_BOXES]
    assert plan["box"] == cv.FP32_RING_BOXES[int(np.argmin(counts))]
    assert plan["boxes"] == min(counts)
    for bz, by, bx in cv.FP32_RING_BOXES:
        assert bz * by * bx == 512 and bx % 8 == 0 and by in (8, 16)


@pytest.mark.parametrize("n,spatial,ca,cb,cout", LIVER_STEP + FLAGSHIP)
def test_plan_fills_one_wave_and_fits(n, spatial, ca, cb, cout):
    """One wave at most; the K loop split only where the (box, column block)
    items leave SMs idle, into splits that are none of them empty; resident
    weights only with one split and several boxes a block; the ring and
    weights within the 227 KB a block may take."""
    plan = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=H100_SMS)
    grid_p, cols, splits = plan["grid"]
    items = plan["boxes"] * cols
    assert cols == _cdiv(cout, 32) and plan["chunks"] == _cdiv(ca, 8) + _cdiv(cb, 8)
    assert grid_p * cols * splits <= H100_SMS
    if items >= H100_SMS:
        assert splits == 1 and grid_p == min(plan["boxes"], H100_SMS // cols)
    else:
        assert grid_p == plan["boxes"]
        assert splits == _cdiv(plan["chunks"], plan["per_split"])
        assert (splits - 1) * plan["per_split"] < plan["chunks"] <= splits * plan["per_split"]
        assert items * (splits + 1) > H100_SMS or splits == plan["chunks"]
    if plan["resident"]:
        assert splits == 1 and _cdiv(plan["boxes"], grid_p) >= 2
    assert plan["smem_bytes"] <= cv.FP32_RING_SMEM_MAX and plan["stages"] in (2, 3)
    assert plan["workspace_bytes"] == (0 if splits == 1 else
                                       4 * splits * n * int(np.prod(spatial)) * cout)
    assert plan["vec"] == (4 if ca % 4 == 0 and cb % 4 == 0 else 2)


def test_plan_at_the_named_shapes():
    """32 -> 32 @128^3 N=2 (A) keeps its 110.6 KB of weights resident beside
    a 3-stage ring on all 132 SMs; B's 32+32 streams them; the deep stages
    split their K loop."""
    a = cv.conv3d_same_fp32_plan(2, 128, 128, 128, 32, 0, 32, sms=H100_SMS)
    assert (a["box"], a["grid"], a["resident"], a["stages"], a["splits"]) == (
        (8, 8, 8), (132, 1, 1), True, 3, 1)
    assert a["smem_bytes"] == 4 * (4 * 27 * 8 * 32 + 3 * 10 * 10 * 84)
    b = cv.conv3d_same_fp32_plan(2, 128, 128, 128, 32, 32, 32, sms=H100_SMS)
    assert (b["resident"], b["stages"], b["splits"]) == (False, 3, 1)
    deep = cv.conv3d_same_fp32_plan(2, 8, 8, 8, 320, 0, 320, sms=H100_SMS)
    assert deep["splits"] > 1 and deep["grid"] == (2, 10, deep["splits"])


@pytest.mark.parametrize("sizes", [(0, 4, 4, 4, 8, 0, 8), (1, 4, 4, 4, 8, -1, 8),
                                   (1, 4, 4, 4, 0, 0, 8), (1, 4, 0, 4, 8, 0, 8)])
def test_plan_refuses_sizes_that_are_not_a_conv(sizes):
    with pytest.raises(ValueError):
        cv.conv3d_same_fp32_plan(*sizes, sms=H100_SMS)


def ring_replay(ins, pw, bias, plan, affine=None):
    """The ring body's walk in torch (see the module docstring); returns the
    output, how often each entry was written in each split and, with one
    split, each box's stats row (N * boxes of a sample, 2, Cout): the sum
    and sum of squares of out after the bias over its in-volume voxels.
    `affine` (scale, shift, slope) applies kernel D's prologue to each staged
    element inside the volume and below the input's channels (fp32, the
    product and the sum rounded apart)."""
    n, z, y, x = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins]
    cout = pw.cout
    bz, by, bx = plan["box"]
    gz, gy, gx = _cdiv(z, bz), _cdiv(y, by), _cdiv(x, bx)
    grid_p, cols, splits = plan["grid"]
    chunks0 = _cdiv(cs[0], 8)
    kchunk0_b = _cdiv(cs[0], 16)
    # each input zero-padded by the halo, the boxes' overhang and its
    # channels to whole 8-channel stages
    padded = [F.pad(t, (0, _cdiv(c, 8) * 8 - c, 1, gx * bx - x + 1, 1, gy * by - y + 1,
                        1, gz * bz - z + 1)) for t, c in zip(ins, cs)]
    parts = torch.zeros(splits, n, gz * bz, gy * by, gx * bx, cols * 32, dtype=torch.float64)
    writes = torch.zeros(splits, n, gz * bz, gy * by, gx * bx, cols * 32, dtype=torch.int32)
    per = gz * gy * gx
    rows = torch.zeros(n * per, 2, cols * 32, dtype=torch.float64)
    bias64 = torch.zeros(cols * 32, dtype=torch.float64)
    if bias is not None:
        bias64[:cout] = bias.double()
    for split in range(splits):
        k0 = split * plan["per_split"]
        nk = min(plan["per_split"], plan["chunks"] - k0)
        assert nk > 0
        for cb in range(cols):
            co0 = cb * 32
            for p in range(grid_p):
                for b in range(p, plan["boxes"], grid_p):
                    nb, r = divmod(b, per)
                    z0, y0, x0 = (r // (gy * gx)) * bz, (r // gx % gy) * by, (r % gx) * bx
                    acc = torch.zeros(bz, by, bx, 32, dtype=torch.float64)
                    for k in range(k0, k0 + nk):
                        si = int(k >= chunks0)
                        j = k - chunks0 * si
                        halo = padded[si][nb, z0:z0 + bz + 2, y0:y0 + by + 2, x0:x0 + bx + 2,
                                          8 * j:8 * j + 8]
                        if affine is not None:
                            halo = _prologue(halo, affine, nb, 8 * j, cs[si],
                                             (z0 - 1, y0 - 1, x0 - 1), (z, y, x))
                        halo = halo.double()
                        kc, r0 = kchunk0_b * si + j // 2, (j % 2) * 8
                        wch = pw.w[kc, :, r0:r0 + 8, co0:co0 + 32].double()  # (27, 8, 32)
                        taps = torch.stack([halo[t // 9:t // 9 + bz, t // 3 % 3:t // 3 % 3 + by,
                                                 t % 3:t % 3 + bx] for t in range(27)])
                        acc += torch.einsum("tzyxc,tco->zyxo", taps, wch)
                    sl = (split, nb, slice(z0, z0 + bz), slice(y0, y0 + by),
                          slice(x0, x0 + bx), slice(co0, co0 + 32))
                    parts[sl] = acc
                    writes[sl] += 1
                    if splits == 1:  # the box's stats row over its in-volume voxels
                        v = (acc + bias64[co0:co0 + 32])[:z - z0, :y - y0, :x - x0]
                        rows[b, 0, co0:co0 + 32] = v.sum((0, 1, 2))
                        rows[b, 1, co0:co0 + 32] = (v * v).sum((0, 1, 2))
    parts = parts[:, :, :z, :y, :x, :cout]
    out = (torch.zeros(cout, dtype=torch.float64) if bias is None else bias.double())
    for s in range(splits):
        out = out + parts[s]
    return (out.float(), writes[:, :, :z, :y, :x, :cout],
            rows[..., :cout].float() if splits == 1 else None)


def _prologue(halo, affine, nb, c0, c, origin, volume):
    """lrelu(v * scale + shift) in fp32 of a staged halo's elements inside
    the volume and below channel c; the rest kept (0)."""
    scale, shift, slope = affine
    ch = torch.arange(c0, c0 + halo.shape[-1])
    s = torch.zeros(halo.shape[-1])
    t = torch.zeros(halo.shape[-1])
    top = min(c, c0 + halo.shape[-1])
    s[ch < c], t[ch < c] = scale[nb, c0:top].float(), shift[nb, c0:top].float()
    a = halo.float() * s + t
    act = torch.where(a >= 0, a, a * slope)
    inside = (ch < c)[None, None, None, :]
    for axis, (o, size) in enumerate(zip(origin, volume)):
        pos = torch.arange(halo.shape[axis]) + o
        shape = [1, 1, 1, 1]
        shape[axis] = -1
        inside = inside & ((pos >= 0) & (pos < size)).reshape(shape)
    return torch.where(inside, act, halo.float())


@pytest.mark.parametrize("n,spatial,ca,cb,cout,sms,pallas", [
    (1, (8, 16, 16), 32, 0, 32, 132, True),    # 16-byte rows
    (1, (4, 8, 24), 20, 12, 16, 132, True),    # B, unequal inputs
    (1, (9, 10, 11), 32, 0, 32, 132, False),   # ragged volume
    (2, (6, 16, 32), 30, 0, 30, 132, False),   # 8-byte rows, 30 channels (the flagship's)
    (1, (3, 5, 9), 13, 0, 47, 132, False),     # 4-byte rows, odd Cout, K split
    (1, (9, 10, 11), 20, 12, 16, 132, False),  # B, ragged
    (2, (4, 4, 8), 40, 24, 64, 132, False),    # B, deep: the K split and its reduce
    (2, (8, 9, 17), 16, 0, 24, 3, False),      # a few blocks walking several boxes each
])
def test_ring_replay_matches_pallas(n, spatial, ca, cb, cout, sms, pallas):
    rng = np.random.RandomState(7)
    x = rng.randn(n, *spatial, ca + cb).astype(np.float32)
    w = (rng.randn(cout, ca + cb, 3, 3, 3) * 0.1).astype(np.float32)
    bias = torch.from_numpy(rng.randn(cout).astype(np.float32))
    tw = torch.from_numpy(w)
    pw = cv.prepare_conv3d_weight(tw, (ca, cb) if cb else None, torch.float32)
    ins = [torch.from_numpy(x[..., :ca])] + ([torch.from_numpy(x[..., ca:])] if cb else [])
    plan = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=sms)
    got, writes, _ = ring_replay(ins, pw, bias, plan)
    assert torch.equal(writes, torch.ones_like(writes))
    if pallas:
        w_dhwio = np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))
        ref = np.asarray(pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w_dhwio),
                                            interpret=True)) + bias.numpy()
    else:
        ref = cv.conv3d_same_ref(torch.from_numpy(x).double(), tw.double(),
                                 bias.double()).float().numpy()
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL, rtol=RTOL)
    # the CPU wrapper (the plain version) agrees with both
    wrap = cv.conv3d_same_dual_fp32(*ins, pw, bias) if cb else cv.conv3d_same_fp32(
        ins[0], pw, bias)
    np.testing.assert_allclose(wrap.numpy(), ref, atol=ATOL, rtol=RTOL)
