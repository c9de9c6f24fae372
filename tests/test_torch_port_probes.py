"""The probes' plain versions (multitalent_tpu_torch/probes) against the
Pallas probe kernels of scripts/, on the CPU.

The scripts are loaded from their files (scripts/ is no package). Rows 9 and
10 of the TPU kernel table run their Pallas kernels in interpret mode; the
Pallas kernels of rows 11 and 12 are closures inside the scripts' main()
(conv_cost_isolate.py:48, grid_overhead_probe.py:49,68) and cannot be called
without editing the scripts, so those rows are held against numpy
transcriptions of the kernels' bodies. The kernels themselves run on the card
(tests/test_torch_port_cuda.py).
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.ops.packed_conv import space_to_depth_yx
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import conv_cost_isolate as cc
from multitalent_tpu_torch.probes import conv_impl_arms as ca
from multitalent_tpu_torch.probes import grid_overhead_probe as gp
from multitalent_tpu_torch.probes import sparse_conv_arm as sc

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _script(name: str):
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}", SCRIPTS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def arms_script():
    return _script("conv_impl_arms")


@pytest.mark.parametrize("arm", ca.ARMS)
def test_conv_arm_matches_the_pallas_arm(arms_script, arm, monkeypatch):
    """Row 9: each arm's plain version (with its prepared weight) against
    scripts/conv_impl_arms.pallas_conv3d_same in interpret mode under
    MTTPU_PALLAS_CONV_IMPL=arm, fp32 at the script's parity shape
    (1, 8, 16, 16, 120) -> 120, bound the script's 1e-3 (:362)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(ca.PARITY_SHAPE).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 120, 120)) * 0.1).astype(np.float32)  # DHWIO
    monkeypatch.setenv("MTTPU_PALLAS_CONV_IMPL", arm)
    want = np.asarray(arms_script.pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w),
                                                     interpret=True))
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    got = ca.run_arm(arm, torch.from_numpy(x), ca.prepare(wt, arm, torch.float32))
    assert np.abs(got.numpy() - want).max() < ca.PARITY_BOUND


@pytest.mark.parametrize("arm", ["im2col", "tap3"])
def test_arm_layouts_round_trip(arm):
    """The kernels' weight layouts: unpreparing gives the weight back, the
    padding is zero and each entry sits where csrc/conv_arms.cu reads it."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((47, 30, 3, 3, 3)).astype(np.float32))
    pw = ca.prepare_arm_weight(w, arm, dtype=torch.float32)
    assert torch.equal(ca.arm_weight_taps(pw), w)
    co, ci, dz, dy, dx = 5, 21, 2, 0, 1
    if arm == "im2col":
        assert pw.w.shape == (27 * 32, 128)
        assert pw.w[(dz * 9 + dy * 3 + dx) * 32 + ci, co] == w[co, ci, dz, dy, dx]
    else:
        assert pw.w.shape == (2, 9, 48, 64)
        assert pw.w[ci // 16, dz * 3 + dy, dx * 16 + ci % 16, co] == w[co, ci, dz, dy, dx]
    assert pw.w.sum() == pytest.approx(w.sum().item(), rel=1e-5)


def test_winograd_weights_and_bound():
    """U = G w G^T per axis (scripts/conv_impl_arms.py:330-336); the Winograd
    plain version with the kernel's bf16 rounding points stays within the
    arms' bound of the direct conv and the faulty G (the control) breaks it,
    as probes/conv_impl_arms.py states."""
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((8, 6, 3, 3, 3)).astype(np.float64))
    u = ca.winograd_weights(w)
    g = torch.tensor(ca.G, dtype=torch.float64)
    want = torch.einsum("au,bv,cw,oiuvw->abcio", g, g, g, w).reshape(64, 6, 8)
    assert torch.allclose(u, want)
    x = torch.from_numpy(rng.standard_normal((1, 16, 32, 32, 120), dtype=np.float32))
    x = x.to(torch.bfloat16)
    w = torch.from_numpy(rng.standard_normal((120, 120, 3, 3, 3)).astype(np.float32)
                         * (2 / (27 * 120)) ** 0.5)
    ref = cv.conv3d_same_ref(x.float(), w)
    bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
    for g, ok in ((ca.G, True), (ca.G_FAULTY, False)):
        out = ca.winograd_conv3d_ref(x.float(), ca.prepare_arm_weight(w, "wino", g=g),
                                     v_dtype=torch.bfloat16).to(torch.bfloat16)
        assert ((out.float() - ref).abs().max().item() <= bound) == ok


def test_winograd_refuses_odd_sizes():
    w = torch.zeros(4, 4, 3, 3, 3)
    with pytest.raises(ValueError, match="even"):
        ca.conv3d_wino(torch.zeros(1, 4, 5, 4, 4), ca.prepare_arm_weight(w, "wino"))


@pytest.mark.parametrize("factors,c,groups", sc.PARITY_CASES)
def test_packed_conv_matches_the_pallas_sparse_kernel(factors, c, groups):
    """Row 10: packed_conv3d's plain version against
    scripts/pallas_sparse_conv_arm.pallas_packed_conv3d_sparse in interpret
    mode at the script's three _parity_check cases (:389-412), atol 1e-4."""
    script = _script("pallas_sparse_conv_arm")
    xg, w = sc.parity_inputs(factors, c, groups, np.random.default_rng(3))
    want = script.pallas_packed_conv3d_sparse(
        jnp.asarray(xg.numpy()), jnp.asarray(w.permute(2, 3, 4, 1, 0).numpy()),
        factors=factors, in_groups=groups, interpret=True)
    got = sc.packed_conv3d(xg, cv.prepare_conv3d_weight(w, dtype=torch.float32), factors, groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=sc.PARITY_ATOL)
    x = np.random.default_rng(4).standard_normal((1, 2, 8, 6, 5), dtype=np.float32)
    assert np.array_equal(sc.space_to_depth_yx(torch.from_numpy(x), factors).numpy(),
                          np.asarray(space_to_depth_yx(jnp.asarray(x), factors)))


@pytest.mark.parametrize("factors", [(2, 2), (1, 2), (1, 1)])
@pytest.mark.parametrize("groups", [None, (20, 12), (6, 7)])
def test_packed_source_offsets_gather_the_unpacked_tensor(factors, groups):
    """The packed conv's loader mapping (csrc/conv3d_same.cu
    load_lines_packed), mirrored by packed_source_offsets: gathering the
    flattened packed tensor (each group packed by the JAX package's
    space_to_depth_yx, laid [P*g0 | P*g1 ...]) at its offsets gives the
    unpacked tensor, for every lane step the loader takes (its vpi: 1 at
    wide rows up to 8 at 4-channel rows, odd steps carrying x % fx across
    packed voxels), at sizes no 256-voxel box divides."""
    fy, fx = factors
    sizes = (30,) if groups is None else groups
    n, z, y, xd = 2, 3, 5 * fy, 7 * fx
    rng = np.random.default_rng(5)
    parts = [rng.standard_normal((n, z, y, xd, g)).astype(np.float32) for g in sizes]
    xp = torch.from_numpy(np.concatenate(
        [np.asarray(space_to_depth_yx(jnp.asarray(v), factors)) for v in parts], -1))
    want = torch.from_numpy(np.concatenate(parts, -1))
    assert torch.equal(sc.unpack(xp, factors, groups), want)
    for step in (1, 2, 3, 4, 5, 8):
        off = sc.packed_source_offsets((n, z, y, xd, sum(sizes)), factors, groups, step)
        assert torch.equal(xp.reshape(-1)[off], want), step


@pytest.mark.parametrize("groups,width", [(30, 2), (60, 4), ((20, 12), 4), ((6, 7), 1),
                                          (32, 8), (120, 8)])
def test_packed_copy_width(groups, width):
    """The packed conv's copies: the widest of 8, 4, 2 and 1 elements that
    divides every group, 4-byte copies at 30 channels and 8-byte at 60 as
    kernel A's, element loads at odd groups."""
    assert sc.packed_copy_width(groups) == width


@pytest.mark.parametrize("tile,plan", [
    ((8, 16, 16), {"form": "vector", "blocks": 432, "runs": 128, "run_bytes": 4096}),
    ((8, 32, 48), {"form": "vector", "blocks": 72, "runs": 256, "run_bytes": 12288}),
    ((96, 96, 96), {"form": "vector", "blocks": 1, "runs": 1, "run_bytes": 226492416}),
])
def test_zeros_plan_at_the_probe_tiles(tile, plan):
    """The zero fill's plan at the grid probe's three tiles of a 96^3 x 128
    bf16 volume (a voxel 256 bytes), counted by hand; every call runs the
    vector stores:
    - (8, 16, 16): 12 * 6 * 6 = 432 blocks; the tile spans 16 of X's 96, so
      a run is one x-row of 16 * 256 = 4096 bytes, 8 * 16 = 128 a block;
    - (8, 32, 48): 12 * 3 * 2 = 72 blocks; x-rows of 48 * 256 = 12288
      bytes, 8 * 32 = 256 a block;
    - (96, 96, 96): one block; the tile spans X and Y, so the whole tile is
      one run of 96^3 * 256 = 226,492,416 bytes."""
    assert gp.zeros_plan((96, 96, 96, 128), tile) == plan
    assert tile in gp.ZERO_TILES


def test_zeros_plan_merges_runs_where_the_tile_spans_x():
    """Where the tile spans X a run is a plane of the tile's rows, where it
    spans Y as well the whole tile; a tile that does not divide the volume
    is refused."""
    assert gp.zeros_plan((8, 12, 16, 24), (2, 4, 16))["runs"] == 2
    assert gp.zeros_plan((8, 12, 16, 24), (2, 4, 16))["run_bytes"] == 4 * 16 * 48
    assert gp.zeros_plan((8, 12, 16, 24), (2, 12, 16)) == {
        "form": "vector", "blocks": 4, "runs": 1, "run_bytes": 2 * 12 * 16 * 48}
    with pytest.raises(ValueError):
        gp.zeros_plan((8, 12, 16, 24), (3, 12, 16))


def _pallas_centern_body(xpad: np.ndarray, w: np.ndarray, ndots: int, block) -> np.ndarray:
    """scripts/conv_cost_isolate.py:80-87 (= grid_overhead_probe.py:103-109)
    transcribed to numpy, grid step by grid step: the center view of the
    haloed block, ndots dots into an fp32 accumulator."""
    _, zp, yp, xp16, c = xpad.shape
    z, y, xd = zp - 2, yp - 2, xp16 - 16
    bz, by, bx = block
    out = np.zeros((1, z, y, xd, w.shape[-1]), np.float32)
    for i in range(z // bz):
        for j in range(y // by):
            for k in range(xd // bx):
                xblk = xpad[0, i * bz:i * bz + bz + 2, j * by:j * by + by + 2,
                            k * bx:k * bx + bx + 16, :]
                a2 = xblk[1:1 + bz, 1:1 + by, 8:8 + bx, :].reshape(bz * by * bx, c)
                acc = np.zeros((bz * by * bx, w.shape[-1]), np.float32)
                for t in range(ndots):
                    acc += a2 @ w[t % 3, (t // 3) % 3, t % 3]
                out[0, i * bz:(i + 1) * bz, j * by:(j + 1) * by, k * bx:(k + 1) * bx] = \
                    acc.reshape(bz, by, bx, -1)
    return out


@pytest.mark.parametrize("ndots,block", [(27, (4, 8, 8)), (12, (8, 16, 8))])
def test_centern_matches_the_pallas_body(ndots, block):
    """Rows 11 and 12 (conv): centern's plain version against the numpy
    transcription of the Pallas body on a padded copy, as the scripts feed it."""
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, 16, 16, 32).astype(np.float32)
    w = (rng.randn(3, 3, 3, 32, 32) * .05).astype(np.float32)  # (3, 3, 3, C, Cout)
    xpad = np.pad(x, ((0, 0), (1, 1), (1, 1), (8, 8), (0, 0)))
    want = _pallas_centern_body(xpad, w, ndots, block)
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2)
    got = cc.centern(torch.from_numpy(x), cc.prepare_center_weight(wt, torch.float32), ndots,
                     block)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)
    with pytest.raises(ValueError, match="divide"):
        cc.centern(torch.from_numpy(x), cc.prepare_center_weight(wt, torch.float32), ndots,
                   (3, 16, 16))


@pytest.mark.parametrize("c", [8, 13, 16, 30, 40, 64, 120, 128])
def test_im2col_plan_picks_the_body_by_channels(c):
    """The im2col arm's body by C alone, as mt_conv_im2col picks it: TMA
    im2col loads and wgmma where every pixel row is 16-byte aligned (C % 8
    == 0), the first body otherwise; and what each stages a launch (the
    TMA body: a 48 KB stage a tile, tap and 64-channel chunk; the first: a
    block's [32, 27*C_P] rows and the whole weight)."""
    n, z, y, x, cout = 2, 6, 10, 14, 47
    plan = ca.im2col_plan(n, z, y, x, c, cout)
    cp = -(-c // 16) * 16
    if c % 8 == 0:  # 7 tiles of 256 voxels, each a 48 KB stage a tap and chunk
        assert plan["body"] == "tma" and plan["tiles"] == 7
        assert plan["l2_to_shared_bytes"] == 7 * 27 * -(-cp // 64) * (32768 + 16384)
    else:
        blocks = n * z * y * 1
        assert plan["body"] == "mma_sync" and plan["tiles"] == blocks
        assert plan["l2_to_shared_bytes"] == blocks * (32 * 27 * cp * 2 + 27 * cp * 256)


def test_probe_plans_at_the_timed_shapes():
    """The L2 -> shared bytes of the two redesigned bodies at the shapes the
    probes time: the im2col arm at (2, 96, 96, 96, 120) -> 120, 6,912 tiles
    of 54 stages (12.2 GB of im2col rows, 6.1 GB of weight); centern at
    96^3 x 128 in (8, 16, 16) tiles, 3,456 sub-tiles of 256 voxels, each
    reading the ndots (128, 128) weight matrices once (3.1 GB at 27 dots)."""
    plan = ca.im2col_plan(2, 96, 96, 96, 120, 120)
    assert (plan["body"], plan["tiles"], plan["stages_per_tile"]) == ("tma", 6912, 54)
    assert plan["l2_to_shared_bytes"] == 6912 * 54 * (32768 + 16384)
    for ndots in (27, 12):
        plan = cc.centern_plan(1, (96, 96, 96), 128, ndots)
        assert (plan["sub_tile"], plan["tiles"], plan["sub_tiles"], plan["grid"]) == (
            (1, 16, 16), 432, 3456, 132)
        assert plan["l2_to_shared_bytes"] == 3456 * (2 * 32768 + ndots * 32768)
    assert cc.centern_plan(1, (96, 96, 96), 128, 27, (8, 48, 96))["grid"] == 24


@pytest.mark.parametrize("arm", ["tap3", "wino"])
@pytest.mark.parametrize("c", [8, 13, 16, 30, 40, 64, 120, 128])
def test_tap3_and_wino_plans_pick_the_body_by_channels(arm, c):
    """The tap3 and Winograd arms' bodies by C alone, as mt_conv_tap3 and
    mt_conv_wino pick them: wgmma fed by TMA where every pixel row is
    16-byte aligned (C % 8 == 0), the first (mma.sync) bodies otherwise; and what
    each stages a launch at (2, 6, 10, 14) -> 47. tap3's TMA body: 2 x 2 x 2
    boxes of 4x8x8 a sample (one 128-column block), each 32-channel chunk
    three 6x10x8 x 64 B x-shifted loads and 27 weight stages of 32 x 128 x
    2 B; its first body: kernel A's box (8, 4, 8) (1 x 3 x 2 a sample, the
    first with the fewest), one 64-column block, each 16-channel chunk 480
    rows of 48 channels and 9 x 48 x 64 weights. wino's TMA body: 1 x 2 x 2
    8x8x8 boxes x 2 64-column blocks a sample, each 64-channel chunk a
    10^3 x 128 B box and 64 positions of 64 x 64 x 2 B of U; its first body:
    2 x 2 x 2 boxes of 4x8x8 a sample, one 128-column block, a slab of C_P
    channels a 6x10x10 box and 64 positions of C_P x 128 x 2 B."""
    n, z, y, x, cout = 2, 6, 10, 14, 47
    cp = -(-c // 16) * 16
    plan = (ca.tap3_plan if arm == "tap3" else ca.wino_plan)(n, z, y, x, c, cout)
    if arm == "tap3" and c % 8 == 0:
        chunks = -(-c // 32)
        assert (plan["body"], plan["tiles"], plan["stages_per_tile"], plan["grid"]) == (
            "tma", 16, 27 * chunks, 16)
        assert plan["l2_to_shared_bytes"] == 16 * chunks * (3 * 480 * 64 + 27 * 32 * 256)
    elif arm == "tap3":
        chunks = -(-c // 16)
        assert (plan["body"], plan["tiles"], plan["box"]) == ("mma_sync", 12, (8, 4, 8))
        assert plan["l2_to_shared_bytes"] == 12 * chunks * (480 * 48 + 9 * 48 * 64) * 2
    elif c % 8 == 0:
        chunks = -(-cp // 64)
        assert (plan["body"], plan["tiles"], plan["stages_per_tile"], plan["grid"]) == (
            "tma", 16, 64 * chunks, 16)
        assert plan["l2_to_shared_bytes"] == 16 * chunks * (1000 * 128 + 64 * 8192)
    else:
        assert (plan["body"], plan["tiles"], plan["stages_per_tile"]) == ("mma_sync", 16, 64)
        assert plan["l2_to_shared_bytes"] == 16 * (600 * cp * 2 + 64 * cp * 256)
    if arm == "wino":  # the 64 transform-domain GEMMs over 210 tiles, either body
        assert plan["products_flops"] == 2 * 210 * 64 * cp * 128


def test_tap3_and_wino_plans_at_the_timed_shape():
    """The bytes both arms' bodies bring from L2 into shared memory at (2, 96,
    96, 96, 120) -> 120, counted by hand. tap3's TMA body: 2 x 24 x 12 x 12 =
    6,912 boxes of 4x8x8 x 128 columns, 4 chunks of 32 channels, each
    3 x 30,720 B of x-shifted rows (2.55 GB in all) and 27 x 8,192 B of
    weights (6.12 GB): 8.66 GB. Its first body: 13,824 blocks (2 column
    blocks of 64), 8 chunks of 16 channels, each 480 x 96 B of xcat (5.10 GB)
    and 55,296 B of weights (6.12 GB): 11.21 GB. wino's TMA body: 2 x 12^3 =
    3,456 boxes of 8x8x8 x 2 column blocks = 6,912 items, 2 chunks of 64
    channels, each a 128,000 B input box (1.77 GB) and 64 x 8,192 B of U
    (7.25 GB): 9.02 GB. Its first body: 6,912 blocks, one slab of 128
    channels, a 153,600 B box (1.06 GB) and 2 MiB of U (14.50 GB): 15.56 GB.
    Winograd's own floor: 221,184 tiles x 64 x 128 x 128 x 2 flop at 989
    TFLOP/s, 0.469 ms."""
    shape = (2, 96, 96, 96, 120, 120)
    t = ca.tap3_plan(*shape)
    assert (t["body"], t["tiles"], t["stages_per_tile"], t["grid"]) == ("tma", 6912, 108, 132)
    assert t["l2_to_shared_bytes"] == 6912 * 4 * (3 * 30720 + 27 * 8192) == 8_663_334_912
    t = ca.tap3_plan(*shape, body="mma_sync")
    assert (t["tiles"], t["stages_per_tile"]) == (13824, 8)
    assert t["l2_to_shared_bytes"] == 13824 * 8 * (480 * 96 + 55296) == 11_211_374_592
    w = ca.wino_plan(*shape)
    assert (w["body"], w["tiles"], w["stages_per_tile"], w["grid"]) == ("tma", 6912, 128, 132)
    assert w["l2_to_shared_bytes"] == 6912 * 2 * (128000 + 64 * 8192) == 9_017_229_312
    w = ca.wino_plan(*shape, body="mma_sync")
    assert (w["tiles"], w["stages_per_tile"]) == (6912, 64)
    assert w["l2_to_shared_bytes"] == 6912 * (153600 + 2 * 2 ** 20) == 15_557_197_824
    assert w["products_flops"] == 221184 * 64 * 128 * 128 * 2
    assert ca.products_floor_ms(w["products_flops"]) == pytest.approx(0.469, abs=5e-4)


def _wino_in_chunks(x: torch.Tensor, pw, chunk: int = 64) -> torch.Tensor:
    """The Winograd TMA body's order in fp32: the volume cut into 8x8x8
    output boxes (4x4x4 groups of 2x2x2 tiles, zeros past the edges and the
    SAME halo), and for each box the channels in `chunk`-channel chunks: V of
    the chunk, M = V U per position, A^T of each chunk's M added into the 8
    output phases."""
    n, z, y, xd, c = (int(s) for s in x.shape)
    cp = pw.w.shape[1]
    g = [-(-s // 8) for s in (z, y, xd)]
    xp = torch.zeros(n, 8 * g[0] + 2, 8 * g[1] + 2, 8 * g[2] + 2, cp)
    xp[:, 1:z + 1, 1:y + 1, 1:xd + 1, :c] = x
    b3, a3 = ca._kron3(ca.BT, torch.float32, "cpu"), ca._kron3(ca.AT, torch.float32, "cpu")
    out = torch.zeros(n, 8 * g[0], 8 * g[1], 8 * g[2], pw.coutp)
    for nb in range(n):
        for gz in range(g[0]):
            for gy in range(g[1]):
                for gx in range(g[2]):
                    box = xp[nb, 8 * gz:8 * gz + 10, 8 * gy:8 * gy + 10, 8 * gx:8 * gx + 10]
                    d = box.unfold(0, 4, 2).unfold(1, 4, 2).unfold(2, 4, 2)  # (4,4,4,C,4,4,4)
                    phases = torch.zeros(8, 64, pw.coutp)
                    for c0 in range(0, cp, chunk):
                        v = d[:, :, :, c0:c0 + chunk].reshape(64, -1, 64) @ b3.T
                        m = torch.bmm(v.permute(2, 0, 1), pw.w[:, c0:c0 + chunk].float())
                        phases += (a3 @ m.reshape(64, -1)).reshape(8, 64, pw.coutp)
                    o = phases.reshape(2, 2, 2, 4, 4, 4, pw.coutp).permute(3, 0, 4, 1, 5, 2, 6)
                    out[nb, 8 * gz:8 * gz + 8, 8 * gy:8 * gy + 8, 8 * gx:8 * gx + 8] = \
                        o.reshape(8, 8, 8, pw.coutp)
    return out[:, :z, :y, :xd, :pw.cout]


def test_wino_chunked_order_matches_the_pallas_arm(arms_script, monkeypatch):
    """The Winograd TMA body splits K into 64-channel chunks, each chunk's
    partial M through A^T into the phases (csrc/conv_arms.cu
    wino_tma_kernel): that order, emulated in fp32 with its 8x8x8 boxes at a
    ragged even shape (Z and Y not multiples of 8, C = 72 one chunk and 8
    channels), against scripts/conv_impl_arms.pallas_conv3d_same in interpret
    mode under MTTPU_PALLAS_CONV_IMPL=wino, bound the script's 1e-3."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 10, 12, 16, 72)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, 72, 40)) * 0.1).astype(np.float32)  # DHWIO
    monkeypatch.setenv("MTTPU_PALLAS_CONV_IMPL", "wino")
    want = np.asarray(arms_script.pallas_conv3d_same(jnp.asarray(x), jnp.asarray(w),
                                                     interpret=True))
    pw = ca.prepare_arm_weight(torch.from_numpy(w).permute(4, 3, 0, 1, 2), "wino",
                               dtype=torch.float32)
    got = _wino_in_chunks(torch.from_numpy(x), pw)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() < ca.PARITY_BOUND
    whole = ca.winograd_conv3d_ref(torch.from_numpy(x), pw)
    assert (got - whole).abs().max().item() < ca.PARITY_BOUND


@pytest.mark.parametrize("tile,sub", [((8, 16, 16), (1, 16, 16)), ((8, 32, 32), (1, 8, 32)),
                                      ((8, 48, 96), (1, 8, 32)), ((2, 4, 8), (2, 4, 8)),
                                      ((6, 6, 12), (3, 6, 12)), ((4, 12, 24), (2, 4, 24)),
                                      ((96, 96, 96), (1, 8, 32)), ((1, 1, 300), (1, 1, 60))])
def test_centern_sub_tiles_take_the_fewest_products(tile, sub):
    """centern's sub-tile of a tile: a box dividing it, at most 256 voxels
    and 256 along x, taking the fewest m64 products over the tile (checked
    against every such box), then the fewest boxes."""
    got = cc.centern_sub_tiles(tile)
    assert got == sub
    assert all(t % s == 0 for t, s in zip(tile, got)) and np.prod(got) <= 256

    def cost(box):
        boxes = int(np.prod([t // s for t, s in zip(tile, box)]))
        return boxes * -(-int(np.prod(box)) // 64), boxes

    divisors = [[d for d in range(1, t + 1) if t % d == 0] for t in tile]
    every = [(a, b, c) for a in divisors[0] for b in divisors[1] for c in divisors[2]
             if a * b * c <= 256]
    assert cost(got) == min(cost(box) for box in every)


@pytest.mark.parametrize("block", [(8, 16, 16), (4, 8, 8), (16, 16, 16)])
def test_zeros_matches_the_pallas_body(block):
    """Row 12 (zeros): scripts/grid_overhead_probe.py:49-50 writes zeros into
    every (bz, by, bx, C) block; the port's plain version gives that tensor."""
    shape = (16, 16, 16, 128)
    want = np.full(shape, np.nan, np.float32)
    for i in range(0, 16, block[0]):
        for j in range(0, 16, block[1]):
            for k in range(0, 16, block[2]):
                want[i:i + block[0], j:j + block[1], k:k + block[2]] = np.zeros_like(
                    want[i:i + block[0], j:j + block[1], k:k + block[2]])
    got = gp.zeros(shape, block, "cpu")
    assert got.dtype == torch.bfloat16 and np.array_equal(got.float().numpy(), want)
    with pytest.raises(ValueError):
        gp.zeros(shape, (5, 16, 16), "cpu")


@pytest.mark.parametrize("probe", ["conv_impl_arms", "sparse_conv_arm", "conv_cost_isolate",
                                   "grid_overhead_probe", "wgrad_forms", "conv_a_forms",
                                   "wgmma_forms", "fp32_forms", "probe_bodies"])
def test_probe_entry_point_runs_on_the_cpu(probe, capsys):
    """`python -m multitalent_tpu_torch.probes.<probe> --device cpu`: the
    plain run; without --device, a machine without a card refuses."""
    mod = importlib.import_module(f"multitalent_tpu_torch.probes.{probe}")
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain run on the CPU" in out or "no card: skipping" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            mod.main([])


@pytest.mark.parametrize("kernel", ["conv3d_im2col", "conv3d_tap3", "conv3d_wino",
                                    "packed_conv3d", "centern", "zeros"])
def test_probe_kernel_writes_into_out(kernel):
    """Each probe wrapper's `out=`: the plain version lands in the caller's
    buffer (a NaN-filled one here, as chip_smoke's checks pass) and that
    buffer comes back; a buffer of another shape is refused."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 4, 8, 8, 16)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((16, 16, 3, 3, 3)) * 0.1).astype(np.float32))
    calls = {
        "conv3d_im2col": lambda out: ca.conv3d_im2col(
            x, ca.prepare_arm_weight(w, "im2col", dtype=torch.float32), out=out),
        "conv3d_tap3": lambda out: ca.conv3d_tap3(
            x, ca.prepare_arm_weight(w, "tap3", dtype=torch.float32), out=out),
        "conv3d_wino": lambda out: ca.conv3d_wino(
            x, ca.prepare_arm_weight(w, "wino", dtype=torch.float32), out=out),
        "packed_conv3d": lambda out: sc.packed_conv3d(
            sc.space_to_depth_yx(x, (2, 2)), cv.prepare_conv3d_weight(w, dtype=torch.float32),
            (2, 2), out=out),
        "centern": lambda out: cc.centern(
            x, cc.prepare_center_weight(w, torch.float32), 27, (4, 8, 8), out=out),
        "zeros": lambda out: gp.zeros((4, 8, 8, 16), (4, 8, 8), "cpu", out=out),
    }[kernel]
    want = calls(None)
    out = torch.full(want.shape, float("nan"), dtype=want.dtype)
    got = calls(out)
    assert got is out and torch.equal(got, want)
    with pytest.raises(ValueError, match="out"):
        calls(torch.empty(*want.shape[:-1], want.shape[-1] + 1, dtype=want.dtype))


def test_launch_check_refuses_a_cpu_tensor():
    """A kernel launch takes CUDA tensors only."""
    from multitalent_tpu_torch.probes import _util
    with pytest.raises(ValueError, match="CUDA tensor"):
        _util.check_tensor(torch.zeros(4, dtype=torch.bfloat16), "x")


def test_wgrad_forms_cut_the_copies_or_the_products():
    """probes/wgrad_forms.py: the copies-only form of kernel C loses its K
    loop of products, the products-only form its two copy calls, and the
    whole form is the source; the patches also take the first form's
    `load_box<THREADS>(` calls; a source without them is refused."""
    from multitalent_tpu_torch.probes import wgrad_forms as wf
    text = (Path(wf.__file__).resolve().parents[1] / "csrc" / "conv3d_wgrad.cu").read_text()
    assert wf.form_source(text, "whole") == text
    copies = wf.form_source(text, "copies")
    assert wf.K_LOOP not in copies and "ks < 0" in copies
    assert copies.count("if (false) load_") == 0
    products = wf.form_source(text, "products")
    assert products.count("if (false) load_") == 2 and wf.K_LOOP in products
    older = "  {\n    load_box<THREADS>(halo, src);\n    load_box<THREADS>(gsm, g);\n  }\n"
    assert wf.form_source(older, "products").count("if (false) load_box<THREADS>(") == 2
    with pytest.raises(ValueError):
        wf.form_source(older, "copies")
    with pytest.raises(ValueError):
        wf.form_source(text.replace("load_", "stage_"), "products")


def test_conv_a_forms_patch_the_plan():
    """probes/conv_a_forms.py: `ring_everywhere` sends every shape to kernel
    A's ring body, and the whole form is the source; a source without the
    plan's line, or another form, is refused."""
    from multitalent_tpu_torch.probes import conv_a_forms as af
    text = (Path(af.__file__).resolve().parents[1] / "csrc" / "conv3d_same.cu").read_text()
    assert af.form_source(text, "whole") == text
    ring = af.form_source(text, "ring_everywhere")
    assert af.RING not in ring and "p.ring = true;" in ring
    with pytest.raises(ValueError):
        af.form_source(text.replace("p.ring", "q.ring"), "ring_everywhere")
    with pytest.raises(ValueError):
        af.form_source(text, "n_split")


def test_conv_a_forms_read_ptxas():
    """The probe's ptxas lines: each conv kernel's template arguments,
    registers and spills from `nvcc -Xptxas -v`'s log."""
    from multitalent_tpu_torch.probes import conv_a_forms as af
    log = (
        "ptxas info    : Compiling entry function '_ZN47_GLOBAL__N__35e2_14_conv3d_same_cu_33aa"
        "41b915conv3d_a_kernelILi32ELi2ELb1ELb1EEEvNS_7AParamsE' for 'sm_90a'\n"
        "ptxas info    : Function properties for _ZN47_GLOBAL__N__x\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 111 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN48_GLOBAL__N__470b_15_conv3d_wgrad_cu_aaf5"
        "0a4719conv3d_wgrad_kernelILi2ELi64ELi1ELi2EEEvNS_7WParamsE' for 'sm_90a'\n"
        "    0 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads\n"
        "ptxas info    : Used 96 registers, used 1 barriers, 1024 bytes smem\n")
    assert af.ptxas_lines(log) == [
        "conv3d_a_kernel<32, 2, 1, 1>: Used 111 registers, 0 bytes spill stores, "
        "0 bytes spill loads",
        "conv3d_wgrad_kernel<2, 64, 1, 2>: Used 96 registers, 4 bytes spill stores, "
        "8 bytes spill loads"]


def test_wgmma_forms_patch_the_pipeline_constants():
    """probes/wgmma_forms.py --variants: each variant replaces its pipeline
    constants of csrc/conv3d_wgmma.cu and nothing else; a constant the
    source has not, once, is refused."""
    from multitalent_tpu_torch.probes import wgmma_forms as wf
    text = (Path(wf.__file__).resolve().parents[1] / "csrc" / "conv3d_wgmma.cu").read_text()
    for consts in wf.VARIANTS.values():
        patched = wf.variant_source(text, consts)
        for name, value in consts.items():
            assert f"constexpr int {name} = {value};" in patched
        assert len(patched.splitlines()) == len(text.splitlines())
    with pytest.raises(ValueError):
        wf.variant_source(text, {"NO_SUCH_CONSTANT": 1})
