"""The host side of the fp32 forms of kernels C and D on the card's ring
bodies (csrc/conv3d_fp32.cu), on the CPU.

Kernel C's fp32 form runs wgrad_fp32_ring_kernel, planned by
ops/conv3d.py:conv3d_same_wgrad_fp32_plan; D's fp32 forms run the forward
ring body with its prologue and stats, planned by conv3d_same_fp32_plan(...,
stats=True). The plans' choices are held to their rules at every C and D
shape of a Task003 Liver fp32 step and the flagship's 30-channel ones. Then
each body's walk is replayed in torch as the kernel addresses it:

- C: persistent blocks walk units (split, tile) p, p + grid, ...; a unit's
  boxes are a run of whole boxes; each stage holds the box's halo of the
  tile's 8 input channels (zero outside the volume and past the input's
  channels) and its g rows of the tile's 32 output channels; the line
  groups (FP32_WGRAD_GROUPS) each sum every group-th line inside the volume
  over the voxels inside it (whole groups of 8) and are added in group
  order at the unit's end,
  into dw or the split's partial dw, added in split order. Every dw entry
  must be written once a split.
- D: the forward ring's walk (tests/test_torch_port_fp32_ring.py), with the
  prologue lrelu(x * scale + shift) (product and sum rounded apart in fp32)
  applied to each staged element inside the volume and below the input's
  channels, and, with one K split, each box's stats row (the sum and sum of
  squares of out after the bias over its in-volume voxels) added in box
  order; with several, the stats of the reduced output.

The replays are held against the JAX package's Pallas kernels at fp32 in
interpret mode (pallas_conv.py:_wgrad_kernel, on the concat for the dual
form; _conv_affine_kernel) at volumes their block pickers take, and against
the plain versions in fp64 at ragged ones. Tolerances are
tests/test_torch_port_train_kernels.py's for dw (atol 2e-4, rtol 1e-3) and
tests/test_torch_port_fused_fp32.py's for D (out atol 3e-4, rtol 1e-3;
stats atol 1e-3, rtol 1e-4): both sides sum fp32 products in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multitalent_tpu.ops.pallas_conv import pallas_conv3d_same_affine, pallas_conv3d_same_wgrad
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
from multitalent_tpu_torch.probes import fp32_forms

from test_torch_port_fp32_ring import ring_replay

H100_SMS = 132
SLOPE = 1e-2
WGRAD_SHAPES = fp32_forms.WGRAD_STEP_SHAPES + fp32_forms.WGRAD_FLAGSHIP_SHAPES
D_SHAPES = fp32_forms.D_STEP_SHAPES + fp32_forms.FLAGSHIP_SHAPES[:2]


def _cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# kernel C's plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,spatial,ca,cb,cout", WGRAD_SHAPES)
def test_wgrad_plan_fills_one_wave_and_fits(n, spatial, ca, cb, cout):
    """The forward ring's box; the voxel axis split into runs of whole boxes
    only where the tiles leave SMs of a wave idle, none empty; at most one
    block an SM; the ring within the 227 KB a block may take, a stage large
    enough for the flush's three partial tiles; the split partials as the
    workspace."""
    plan = cv.conv3d_same_wgrad_fp32_plan(n, *spatial, ca, cb, cout, sms=H100_SMS)
    fwd = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=H100_SMS)
    assert (plan["box"], plan["boxes"], plan["vec"]) == (fwd["box"], fwd["boxes"], fwd["vec"])
    assert plan["chunks"] == _cdiv(ca, 8) + _cdiv(cb, 8) and plan["cols"] == _cdiv(cout, 32)
    tiles = plan["chunks"] * plan["cols"]
    assert plan["tiles"] == tiles and plan["units"] == tiles * plan["splits"]
    assert plan["grid"] == min(plan["units"], H100_SMS)
    if tiles >= H100_SMS:
        assert plan["splits"] == 1
    else:
        assert (plan["splits"] - 1) * plan["per_split"] < plan["boxes"] <= \
            plan["splits"] * plan["per_split"]
        assert plan["units"] <= H100_SMS
        assert tiles * (plan["splits"] + 1) > H100_SMS or plan["splits"] == plan["boxes"]
    bz, by, bx = plan["box"]
    slot = (bz + 2) * (by + 2) * ((bx + 2) * 8 + 4) + 512 * 32
    assert plan["smem_bytes"] == 4 * plan["stages"] * slot <= cv.FP32_RING_SMEM_MAX
    assert plan["stages"] == 2 and slot >= cv.FP32_WGRAD_FLUSH_FLOATS
    assert plan["workspace_bytes"] == (0 if plan["splits"] == 1 else
                                       4 * plan["splits"] * 27 * (ca + cb) * cout)
    assert plan["gvec"] == (4 if cout % 4 == 0 else 2)


def test_wgrad_plan_at_the_named_shapes():
    """32 -> 32 @128^3 N=2: 4 tiles, the voxel axis in 33 runs of 249 boxes,
    132 blocks of one unit each; the 8^3 and 4^3 stages' tiles fill the card
    alone and write dw directly; the flagship's 30 -> 30 at N=2 copies 8
    bytes at a time."""
    a = cv.conv3d_same_wgrad_fp32_plan(2, 128, 128, 128, 32, 0, 32, sms=H100_SMS)
    assert (a["box"], a["tiles"], a["splits"], a["per_split"], a["grid"]) == (
        (8, 8, 8), 4, 33, 249, 132)
    for spatial in ((8, 8, 8), (4, 4, 4)):
        deep = cv.conv3d_same_wgrad_fp32_plan(2, *spatial, 320, 0, 320, sms=H100_SMS)
        assert (deep["tiles"], deep["splits"], deep["grid"], deep["workspace_bytes"]) == (
            400, 1, 132, 0)
    flag = cv.conv3d_same_wgrad_fp32_plan(2, 96, 192, 192, 30, 30, 30, sms=H100_SMS)
    assert (flag["vec"], flag["gvec"], flag["tiles"], flag["splits"]) == (2, 2, 8, 16)


@pytest.mark.parametrize("sizes", [(0, 4, 4, 4, 8, 0, 8), (1, 4, 4, 4, 8, -1, 8),
                                   (1, 4, 4, 4, 0, 0, 8), (1, 4, 0, 4, 8, 0, 8),
                                   (1, 4, 4, 4, 8, 0, 0)])
def test_wgrad_plan_refuses_sizes_that_are_not_a_conv(sizes):
    with pytest.raises(ValueError):
        cv.conv3d_same_wgrad_fp32_plan(*sizes, sms=H100_SMS)


# ---------------------------------------------------------------------------
# kernel C's walk
# ---------------------------------------------------------------------------

def wgrad_replay(ins, g, plan):
    """The wgrad ring body's walk in torch (see the module docstring);
    returns dw and how often each entry was written in each split."""
    n, z, y, x = (int(s) for s in g.shape[:4])
    cs = [int(t.shape[-1]) for t in ins]
    cout, cin = int(g.shape[-1]), sum(cs)
    bz, by, bx = plan["box"]
    gz, gy, gx = _cdiv(z, bz), _cdiv(y, by), _cdiv(x, bx)
    per = gz * gy * gx
    cols, tiles, splits = plan["cols"], plan["tiles"], plan["splits"]
    chunks0 = _cdiv(cs[0], 8)
    padded = [F.pad(t, (0, _cdiv(c, 8) * 8 - c, 1, gx * bx - x + 1, 1, gy * by - y + 1,
                        1, gz * bz - z + 1)).double() for t, c in zip(ins, cs)]
    gpad = F.pad(g, (0, cols * 32 - cout, 0, gx * bx - x, 0, gy * by - y,
                     0, gz * bz - z)).double()
    parts = torch.zeros(splits, cout, cin, 27, dtype=torch.float64)
    writes = torch.zeros(splits, cout, cin, 27, dtype=torch.int32)
    lines = torch.arange(bz * by).reshape(bz, by)
    groups = cv.FP32_WGRAD_GROUPS
    visited = set()
    for p in range(plan["grid"]):
        for u in range(p, plan["units"], plan["grid"]):
            visited.add(u)
            split, tile = divmod(u, tiles)
            chunk, cb = divmod(tile, cols)
            si = int(chunk >= chunks0)
            j = chunk - chunks0 * si
            co0 = cb * 32
            b0 = split * plan["per_split"]
            b1 = min(plan["boxes"], b0 + plan["per_split"])
            assert b0 < b1
            acc = torch.zeros(groups, 27, 8, 32, dtype=torch.float64)
            for b in range(b0, b1):
                nb, r = divmod(b, per)
                z0, y0, x0 = (r // (gy * gx)) * bz, (r // gx % gy) * by, (r % gx) * bx
                halo = padded[si][nb, z0:z0 + bz + 2, y0:y0 + by + 2, x0:x0 + bx + 2,
                                  8 * j:8 * j + 8]
                gbox = gpad[nb, z0:z0 + bz, y0:y0 + by, x0:x0 + bx, co0:co0 + 32]
                taps = torch.stack([halo[t // 9:t // 9 + bz, t // 3 % 3:t // 3 % 3 + by,
                                         t % 3:t % 3 + bx] for t in range(27)])
                inside = ((torch.arange(bz)[:, None] + z0 < z)
                          & (torch.arange(by)[None, :] + y0 < y))
                nx8 = _cdiv(min(bx, x - x0), 8) * 8
                for grp in range(groups):
                    mask = (inside & (lines % groups == grp))[:, :, None] & (
                        torch.arange(bx) < nx8)[None, None, :]
                    acc[grp] += torch.einsum("tzyxc,zyxo->tco", taps,
                                             gbox * mask[..., None].double())
            tile_sum = acc[0]
            for grp in range(1, groups):  # in group order
                tile_sum = tile_sum + acc[grp]  # (27, 8, 32)
            c0 = 8 * j
            nci = min(8, cs[si] - c0)
            nco = min(32, cout - co0)
            off = cs[0] if si else 0
            parts[split, co0:co0 + nco, off + c0:off + c0 + nci] = \
                tile_sum[:, :nci, :nco].permute(2, 1, 0)
            writes[split, co0:co0 + nco, off + c0:off + c0 + nci] += 1
    assert visited == set(range(plan["units"]))
    dw = parts[0]
    for s in range(1, splits):
        dw = dw + parts[s]
    return dw.reshape(cout, cin, 3, 3, 3).float(), writes


def _dhwio(dw: torch.Tensor) -> np.ndarray:
    """torch (Cout, Cin, kz, ky, kx) -> the Pallas kernel's (kz, ky, kx, Cin, Cout)"""
    return dw.permute(2, 3, 4, 1, 0).numpy()


@pytest.mark.parametrize("n,spatial,ca,cb,cout,sms,pallas", [
    (1, (4, 8, 16), 32, 0, 32, 132, True),     # 16-byte copies, the voxel axis split
    (2, (4, 8, 16), 20, 12, 16, 132, True),    # dual, unequal inputs
    (1, (9, 10, 11), 32, 0, 32, 132, False),   # ragged volume: lines and voxels skipped
    (2, (6, 16, 32), 30, 0, 30, 132, False),   # 8-byte copies (the flagship's width)
    (1, (3, 5, 9), 13, 0, 47, 132, False),     # 4-byte copies, odd Cout, 2 column blocks
    (2, (7, 9, 13), 13, 7, 21, 132, False),    # dual 13 + 7, odd Cout
    (1, (4, 4, 4), 64, 0, 64, 5, False),       # more tiles than blocks: units walked in turn
    (2, (8, 9, 17), 16, 8, 24, 3, False),      # a few blocks walking split units
])
def test_wgrad_replay_matches_pallas(n, spatial, ca, cb, cout, sms, pallas):
    rng = np.random.RandomState(17)
    x = rng.randn(n, *spatial, ca + cb).astype(np.float32)
    g = rng.randn(n, *spatial, cout).astype(np.float32)
    ins = [torch.from_numpy(x[..., :ca])] + ([torch.from_numpy(x[..., ca:])] if cb else [])
    plan = cv.conv3d_same_wgrad_fp32_plan(n, *spatial, ca, cb, cout, sms=sms)
    got, writes = wgrad_replay(ins, torch.from_numpy(g), plan)
    assert torch.equal(writes, torch.ones_like(writes))
    if pallas:
        ref = np.asarray(pallas_conv3d_same_wgrad(jnp.asarray(x), jnp.asarray(g),
                                                  interpret=True))
    else:
        ref = _dhwio(cv.conv3d_same_wgrad_ref(torch.from_numpy(x).double(),
                                              torch.from_numpy(g).double()).float())
    np.testing.assert_allclose(_dhwio(got), ref, atol=2e-4, rtol=1e-3)
    # the CPU wrappers (the plain versions) agree with both
    wrap = (cv.conv3d_same_wgrad_dual_fp32(*ins, torch.from_numpy(g)) if cb else
            cv.conv3d_same_wgrad_fp32(ins[0], torch.from_numpy(g)))
    np.testing.assert_allclose(_dhwio(wrap), ref, atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------------------------
# kernel D's plan and walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,spatial,ca,cb,cout", D_SHAPES)
def test_affine_plan_adds_the_stats_workspace(n, spatial, ca, cb, cout):
    """D's plan is the forward ring's with the stats: the same box, splits,
    weights and grid; STATS' warp partials beside the ring only with one K
    split; the workspace the K partials, then the boxes' stats rows and
    reduce_rows' scratch (one split) or kernel E's stats pass's (several)."""
    plan = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=H100_SMS, stats=True)
    fwd = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=H100_SMS)
    for key in ("box", "boxes", "vec", "chunks", "splits", "per_split", "grid"):
        assert plan[key] == fwd[key], key
    assert plan["smem_bytes"] <= cv.FP32_RING_SMEM_MAX and plan["stages"] in (2, 3)
    parts = fwd["workspace_bytes"]
    per = plan["boxes"] // n
    if plan["splits"] == 1:
        assert plan["resident"] == fwd["resident"]
        rows_ws = 0 if per <= 256 else n * _cdiv(per, 256) * 2 * cout * 4
        assert plan["stats_bytes"] == 4 * n * per * 2 * cout + rows_ws
        assert plan["smem_bytes"] >= cv.FP32_RING_STATS_BYTES
    else:
        chunks = min(_cdiv(int(np.prod(spatial)) * cout * 4, 64 << 10),
                     max(1, min(256, _cdiv(512, n))))
        assert plan["stats_bytes"] == (0 if chunks <= 1 else n * chunks * 2 * cout * 4)
        assert plan["smem_bytes"] == fwd["smem_bytes"]
    assert plan["workspace_bytes"] == parts + plan["stats_bytes"]


def test_affine_plan_takes_both_prologue_paths():
    """3 ring slots (the prologue a stage ahead) at the Liver's stage 0; 2
    (the prologue after the stage's barrier) where resident weights leave
    room for two only."""
    stage0 = cv.conv3d_same_fp32_plan(2, 128, 128, 128, 32, 0, 32, sms=H100_SMS, stats=True)
    assert (stage0["resident"], stage0["stages"], stage0["splits"]) == (True, 3, 1)
    two = cv.conv3d_same_fp32_plan(2, 40, 40, 40, 40, 0, 40, sms=H100_SMS, stats=True)
    assert (two["resident"], two["stages"], two["splits"]) == (True, 2, 1)


def _affine_case(rng, n, spatial, ca, cb, cout, affine):
    x = rng.randn(n, *spatial, ca + cb).astype(np.float32)
    w = (rng.randn(cout, ca + cb, 3, 3, 3) * 0.1).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    s = (rng.rand(n, ca) + 0.5).astype(np.float32)
    t = (rng.randn(n, ca) + 2.0).astype(np.float32)  # lrelu(shift) far from 0: the halo stays 0
    return x, w, bias, (s, t) if affine else None


@pytest.mark.parametrize("n,spatial,ca,cb,cout,affine,sms,splits,pallas", [
    (2, (4, 8, 16), 32, 0, 32, True, 132, 4, True),   # the Liver's stage-0 width, K split
    (2, (4, 8, 16), 16, 0, 16, True, 2, 1, True),     # one split: the boxes' stats rows
    (1, (9, 10, 11), 13, 0, 47, True, 4, 1, False),   # ragged, odd widths
    (2, (5, 9, 11), 30, 0, 30, True, 132, 4, False),  # ragged, 8-byte copies, K split
    (2, (6, 9, 17), 20, 12, 16, False, 3, 1, False),  # the dual form
    (1, (5, 6, 7), 8, 0, 24, False, 1, 1, False),     # no prologue, stats only
])
def test_affine_replay_matches_pallas(monkeypatch, n, spatial, ca, cb, cout, affine, sms,
                                      splits, pallas):
    """D's prologue and stats on the ring's walk against the Pallas affine
    kernel at fp32 (interpret mode) or the plain version in fp64."""
    monkeypatch.setenv("MTTPU_PALLAS_MIN_CIN", "1")
    rng = np.random.RandomState(19)
    x, w, bias, aff = _affine_case(rng, n, spatial, ca, cb, cout, affine)
    tw = torch.from_numpy(w)
    pw = cv.prepare_conv3d_weight(tw, (ca, cb) if cb else None, torch.float32)
    ins = [torch.from_numpy(x[..., :ca])] + ([torch.from_numpy(x[..., ca:])] if cb else [])
    plan = cv.conv3d_same_fp32_plan(n, *spatial, ca, cb, cout, sms=sms, stats=True)
    assert plan["splits"] == splits
    affine_t = None if aff is None else (torch.from_numpy(aff[0]), torch.from_numpy(aff[1]),
                                         SLOPE)
    got, writes, rows = ring_replay(ins, pw, torch.from_numpy(bias), plan, affine_t)
    assert torch.equal(writes, torch.ones_like(writes))
    if plan["splits"] == 1:
        per = plan["boxes"] // n
        assert rows.shape == (n * per, 2, cout)
        stats = rows.reshape(n, per, 2, cout).sum(1).float()  # reduce_rows: box order
    else:
        stats = channel_stats_ref(got)  # kernel E's pass over the reduced output
    if pallas:
        kw = {} if aff is None else dict(in_scale=jnp.asarray(aff[0]),
                                         in_shift=jnp.asarray(aff[1]))
        ref, ref_stats = pallas_conv3d_same_affine(
            jnp.asarray(x), jnp.asarray(np.ascontiguousarray(w.transpose(2, 3, 4, 1, 0))),
            bias=jnp.asarray(bias), negative_slope=SLOPE, interpret=True, **kw)
        ref, ref_stats = np.asarray(ref), np.asarray(ref_stats)
    else:
        xd = [t.double() for t in ins]
        sc, sh = (None, None) if aff is None else (torch.from_numpy(aff[0]).double(),
                                                   torch.from_numpy(aff[1]).double())
        if cb:
            r, rs = cv.conv3d_same_dual_stats_ref(*xd, tw.double(), torch.from_numpy(bias))
        else:
            r, rs = cv.conv3d_same_affine_ref(xd[0], tw.double(), torch.from_numpy(bias),
                                              sc, sh, SLOPE)
        ref, ref_stats = r.float().numpy(), rs.float().numpy()
    np.testing.assert_allclose(got.numpy(), ref, atol=3e-4, rtol=1e-3)
    np.testing.assert_allclose(stats.numpy(), ref_stats, atol=1e-3, rtol=1e-4)
