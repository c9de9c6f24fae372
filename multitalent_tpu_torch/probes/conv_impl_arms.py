"""The conv-arm probe on the H100: the stride-1 SAME 3x3x3 conv by five
inner-loop strategies, each on a hand-written CUDA kernel.

Counterpart of scripts/conv_impl_arms.py, whose Pallas kernel `_conv_kernel`
(:42, pallas_call :248) computes the conv by the arm MTTPU_PALLAS_CONV_IMPL
names. Here each arm is a kernel of its own algorithm (csrc/conv_arms.cu;
what bounds each is noted there):

- 'tap', 'sum': kernel A (`ops/conv3d.conv3d_same`). On the TPU the two differ
  only in where the 27 dots accumulate (a VMEM scratch or the MXU's result
  chain); an mma.sync kernel keeps the accumulator in registers either way.
- 'im2col' (`conv3d_im2col`): one GEMM with K = 27*C over the im2col rows
  of the output voxels. Where C % 8 == 0 on wgmma fed by TMA's im2col mode
  (256 output voxels a tile, each tap's rows loaded with the tap as the
  load's offsets); else on the first body, which materialises the [32, 27*C]
  rows of 32 voxels in shared memory (`im2col_plan` says which, and
  `conv3d_im2col.launches_by_body` counts launches by body).
- 'tap3' (`conv3d_tap3`): the x taps folded into K, 9 GEMMs with K = 3*C.
  Where C % 8 == 0 on wgmma fed by TMA: the x-concatenated rows are three
  TMA loads of a 4x8x8 box's haloed rows shifted by one voxel in x, each
  (dz, dy) the same operand with its start moved; else on the first body,
  which copies them per 16-channel chunk (`tap3_plan`).
- 'wino' (`conv3d_wino`): Winograd F(2x2x2, 3x3x3); weights transformed on
  the host (G w G^T per axis in fp32, then bf16), as :330-336 does. Where
  C % 8 == 0 on wgmma fed by TMA, the transformed input built by warpgroups
  of their own; else on the first body (`wino_plan`).

Each kernel wrapper counts its launches by body in `launches_by_body`.

Plain versions: the direct conv (`ops/conv3d.conv3d_same_ref`, F.conv3d in
fp32) for im2col, tap3, tap and sum; `winograd_conv3d_ref`, the Winograd
algorithm written out in torch, for wino. Each wrapper takes its plain
version for CPU tensors only, launches its kernel for CUDA tensors (or
raises) and counts its launches in its `launches` attribute.

    python -m multitalent_tpu_torch.probes.conv_impl_arms [arm ...] [--device cpu]

checks every arm against the direct conv at (1, 8, 16, 16, 120) -> 120 (as
the script's :350-362) and, on the card, times each at the flagship's
(2, 96, 96, 96, 120) -> 120 in bf16, median of 10 launches.
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import _util

ARMS = ("tap", "sum", "im2col", "tap3", "wino")
PARITY_SHAPE = (1, 8, 16, 16, 120)  # scripts/conv_impl_arms.py:352
TIMED_SHAPE = (2, 96, 96, 96, 120)  # scripts/conv_impl_arms.py:366
# fp32 parity bound of the script (:362)
PARITY_BOUND = 1e-3
# bf16 kernels against the fp32 direct conv on the same bf16 input (fp32
# weights): ATOL + RTOL * max|ref|, as chip_smoke.py's phase 2 (one bf16
# rounding of the output and of the weights, summation order). It holds the
# Winograd kernel too, which also rounds each transformed input tile to bf16
# (B^T grows values up to 8x): with those rounding points emulated on the
# CPU (winograd_conv3d_ref with v_dtype=bfloat16, seeded N(0, 1) input of
# (1, 16, 32, 32, 120), He-scaled weights) max|d| reads 4.38e-2 of a bound of
# 7.86e-2 (mean 5.8e-3), and the control (G_FAULTY) reads 2.35, mean 0.377
RTOL, ATOL = 1e-2, 1e-2
# each arm's bodies (csrc/conv_arms.cu): "tma", wgmma fed by TMA, where
# every pixel row is 16-byte aligned (C % 8 == 0); "mma_sync", the first body
# (mma.sync on rows staged by cp.async), for other C
ARM_BODIES = ("tma", "mma_sync")
SMS = 132  # the H100 SXM's SMs: the persistent bodies' grid
PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
# the first tap3 body's 256-voxel boxes (csrc/common.cuh kBoxes, pick_box)
BOXES = ((4, 8, 8), (8, 4, 8), (8, 8, 4), (4, 4, 16), (4, 16, 4), (16, 4, 4), (2, 8, 16),
         (2, 16, 8))

# Winograd F(2x2x2, 3x3x3): G (scripts/conv_impl_arms.py:332-333), B^T
# (:99-100) and A^T (:122)
G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))
BT = ((1.0, 0.0, -1.0, 0.0), (0.0, 1.0, 1.0, 0.0), (0.0, -1.0, 1.0, 0.0), (0.0, 1.0, 0.0, -1.0))
AT = ((1.0, 1.0, 1.0, 0.0), (0.0, 1.0, -1.0, -1.0))
# the control: G with one row wrong, whose transformed weights must break
# the Winograd bound
G_FAULTY = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.25), (0.0, 0.0, 1.0))


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _kron3(m, dtype, device) -> torch.Tensor:
    """m (x) m (x) m: entry [(a*4 + b)*4 + c, (i*r + j)*r + k] = m[a,i] m[b,j] m[c,k]."""
    t = torch.tensor(m, dtype=dtype, device=device)
    return torch.kron(torch.kron(t, t), t)


@dataclass(frozen=True)
class ArmWeight:
    """A weight in one arm's kernel layout (csrc/conv_arms.cu's header):
    im2col (27*C_P, CoutP), tap3 (C_P/16, 9, 48, CoutP), wino (64, C_P,
    CoutP); C_P is Cin rounded up to 16, CoutP Cout rounded up to `bn`."""

    arm: str
    w: torch.Tensor
    cin: int
    cout: int
    bn: int

    @property
    def coutp(self) -> int:
        return int(self.w.shape[-1])


def winograd_weights(weight: torch.Tensor, g=G) -> torch.Tensor:
    """torch Conv3d weight (Cout, Cin, 3, 3, 3) -> U (64, Cin, Cout) = (G x G x
    G) w per input/output channel pair, in fp32 (fp64 for fp64 weights)."""
    acc = cv._acc_dtype(weight)
    cout, cin = int(weight.shape[0]), int(weight.shape[1])
    taps = weight.to(acc).permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    return torch.einsum("pt,tio->pio", _kron3(g, acc, weight.device), taps)


def prepare_arm_weight(weight: torch.Tensor, arm: str, g=G,
                       dtype: torch.dtype = torch.bfloat16) -> ArmWeight:
    """torch Conv3d weight (Cout, Cin, 3, 3, 3) -> the arm's kernel layout,
    rounded to `dtype` once (for wino after the transform, which runs in
    fp32 with the rows of `g`)."""
    cout, cin = int(weight.shape[0]), int(weight.shape[1])
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a 3x3x3 kernel, got {tuple(weight.shape)}")
    cp = _round_up(cin, cv.KC)
    acc = cv._acc_dtype(weight)
    if arm == "wino":
        coutp = _round_up(cout, 128)
        w = F.pad(winograd_weights(weight, g), (0, coutp - cout, 0, cp - cin))
        return ArmWeight("wino", w.to(dtype).contiguous(), cin, cout, 128)
    taps = F.pad(weight.to(acc).permute(2, 3, 4, 1, 0).reshape(27, cin, cout),
                 (0, 0, 0, cp - cin))
    if arm == "im2col":
        coutp = _round_up(cout, 128)
        w = F.pad(taps, (0, coutp - cout)).reshape(27 * cp, coutp)
        return ArmWeight("im2col", w.to(dtype).contiguous(), cin, cout, 128)
    if arm == "tap3":
        bn = cv._block_n(cout)
        coutp = _round_up(cout, bn)
        t = F.pad(taps, (0, coutp - cout)).reshape(3, 3, 3, cp // cv.KC, cv.KC, coutp)
        w = t.permute(3, 0, 1, 2, 4, 5).reshape(cp // cv.KC, 9, 3 * cv.KC, coutp)
        return ArmWeight("tap3", w.to(dtype).contiguous(), cin, cout, bn)
    raise ValueError(f"no prepared layout for arm {arm!r}")


def arm_weight_taps(pw: ArmWeight) -> torch.Tensor:
    """Inverse of prepare_arm_weight for im2col and tap3: the torch Conv3d
    weight (Cout, Cin, 3, 3, 3) in pw's dtype."""
    if pw.arm == "im2col":
        taps = pw.w.reshape(27, -1, pw.coutp)
    elif pw.arm == "tap3":
        chunks = int(pw.w.shape[0])
        taps = (pw.w.reshape(chunks, 3, 3, 3, cv.KC, pw.coutp).permute(1, 2, 3, 0, 4, 5)
                .reshape(27, chunks * cv.KC, pw.coutp))
    else:
        raise ValueError(f"arm {pw.arm!r} keeps no tap layout")
    return taps[:, :pw.cin, :pw.cout].permute(2, 1, 0).reshape(pw.cout, pw.cin, 3, 3, 3)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def winograd_conv3d_ref(x: torch.Tensor, pw: ArmWeight,
                        v_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain version of the Winograd kernel: F(2x2x2, 3x3x3) in fp32 (fp64
    for fp64 input) with the prepared U. Input tiles d (4x4x4, stride 2, SAME
    padding) become V = (B^T x B^T x B^T) d, 64 matmuls M = V U, and the
    output tiles A^T M (2x2x2), interleaved back. v_dtype rounds V to that
    type, as the kernel does (bf16). Returns x's dtype. Z, Y, X must be even."""
    acc = cv._acc_dtype(x)
    n, z, y, xd, c = (int(s) for s in x.shape)
    if z % 2 or y % 2 or xd % 2:
        raise ValueError(f"Winograd F(2,3) takes even spatial sizes, got {(z, y, xd)}")
    if pw.arm != "wino" or pw.cin != c:
        raise ValueError(f"a {pw.arm} weight for {pw.cin} channels, got {c}")
    u = pw.w.to(acc)[:, :c, :pw.cout]
    b3, a3 = _kron3(BT, acc, x.device), _kron3(AT, acc, x.device)
    xp = F.pad(x.to(acc), (0, 0, 1, 1, 1, 1, 1, 1))
    ty, tx = y // 2, xd // 2
    out = torch.empty(n, z, y, xd, pw.cout, dtype=acc, device=x.device)
    rows = max(1, (1 << 28) // (ty * tx * c * 64))  # tile rows per pass: ~1 GB of fp32 tiles
    for nb in range(n):
        for t0 in range(0, z // 2, rows):
            t1 = min(z // 2, t0 + rows)
            d = xp[nb, 2 * t0:2 * t1 + 2].unfold(0, 4, 2).unfold(1, 4, 2).unfold(2, 4, 2)
            v = d.reshape(-1, c, 64) @ b3.T  # (tiles, C, 64 positions)
            if v_dtype is not None:
                v = v.to(v_dtype).to(acc)
            m = torch.bmm(v.permute(2, 0, 1), u)  # (64, tiles, Cout)
            o = (a3 @ m.reshape(64, -1)).reshape(2, 2, 2, t1 - t0, ty, tx, pw.cout)
            out[nb, 2 * t0:2 * t1] = o.permute(3, 0, 4, 1, 5, 2, 6).reshape(
                2 * (t1 - t0), y, xd, pw.cout)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _launch_arm(name: str, x: torch.Tensor, pw: ArmWeight, arm: str,
                out: torch.Tensor | None) -> torch.Tensor:
    _util.check_tensor(x, "x")
    if pw.arm != arm or pw.cin != int(x.shape[-1]):
        raise ValueError(f"{name}: a {pw.arm} weight for {pw.cin} channels, input "
                         f"{tuple(x.shape)}")
    _util.check_tensor(pw.w, "prepared weight")
    if pw.w.device != x.device:
        raise ValueError(f"{name}: the weight is on {pw.w.device}, x on {x.device}")
    n, z, y, xd, c = (int(s) for s in x.shape)
    out = _util.out_tensor(out, (n, z, y, xd, pw.cout), x.device)
    extra = (pw.bn,) if arm == "tap3" else ()
    _util.launch(name, x.device, x.data_ptr(), pw.w.data_ptr(), out.data_ptr(), n, z, y, xd,
                 c, pw.cout, pw.coutp, *extra)
    return out


def _body(c: int, body: str | None) -> str:
    """The body an arm's C entry takes for C channels (by C alone), unless
    `body` names one."""
    return body or ("tma" if c % 8 == 0 else "mma_sync")


def im2col_plan(n: int, z: int, y: int, x: int, c: int, cout: int,
                body: str | None = None) -> dict:
    """The im2col arm's body for these sizes (as mt_conv_im2col chooses it,
    by C alone, unless `body` names one) and the bytes its copies bring from
    L2 into shared memory a launch, zeros of the halo and of padded channels
    included: the TMA body a stage of 256 voxels x 64 channels and 64 weight
    rows x 128 columns for every (tile, tap, 64-channel chunk); the first
    body the [32, 27*C_P] rows of its 32 voxels and the whole [27*C_P, 128]
    weight a block."""
    cp = _round_up(c, cv.KC)
    nblk = _round_up(cout, 128) // 128
    vox = n * z * y * x
    if _body(c, body) == "tma":
        tiles = -(-vox // 256) * nblk
        steps = 27 * -(-cp // 64)
        return {"body": "tma", "tiles": tiles, "stages_per_tile": steps,
                "grid": min(tiles, SMS),
                "l2_to_shared_bytes": tiles * steps * (256 * 128 + 64 * 128 * 2)}
    blocks = n * z * y * -(-x // 32) * nblk
    return {"body": "mma_sync", "tiles": blocks, "stages_per_tile": 27 * cp // cv.KC,
            "grid": blocks, "l2_to_shared_bytes": blocks * (32 * 27 * cp + 27 * cp * 128) * 2}


def tap3_plan(n: int, z: int, y: int, x: int, c: int, cout: int,
              body: str | None = None) -> dict:
    """The tap3 arm's body (as mt_conv_tap3 chooses it, by C alone, unless
    `body` names one) and the bytes its copies bring from L2 into shared
    memory a launch, halo and padded channels included. The TMA body: a tile
    of a 4x8x8 output box x 128 columns takes, a 32-channel chunk, three
    x-shifted loads of its 6x10x8 haloed rows (64 bytes each) and 27 weight
    stages of 32 rows x 128 columns. The first body: a block of kernel A's
    box (`BOXES`, fewest boxes) x 64 columns (32 for Cout <= 32) copies, a
    16-channel chunk, the x-concatenated rows of its box grown by 1 in z and
    y (48 channels each) and the chunk's 9 x 48 weight rows."""
    if _body(c, body) == "tma":
        coutp = _round_up(cout, cv._block_n(cout))
        tiles = n * -(-z // 4) * -(-y // 8) * -(-x // 8) * -(-coutp // 128)
        chunks = -(-c // 32)
        return {"body": "tma", "tiles": tiles, "stages_per_tile": 27 * chunks,
                "grid": min(tiles, SMS),
                "l2_to_shared_bytes": tiles * chunks * (3 * 6 * 10 * 8 * 64 + 27 * 32 * 128 * 2)}
    boxes = [-(-z // bz) * -(-y // by) * -(-x // bx) for bz, by, bx in BOXES]
    i = boxes.index(min(boxes))
    bz, by, bx = BOXES[i]
    bn = cv._block_n(cout)
    blocks = n * boxes[i] * (_round_up(cout, bn) // bn)
    chunks = -(-c // cv.KC)
    rows = (bz + 2) * (by + 2) * bx
    return {"body": "mma_sync", "tiles": blocks, "stages_per_tile": chunks, "grid": blocks,
            "box": (bz, by, bx),
            "l2_to_shared_bytes": blocks * chunks * (rows * 3 * cv.KC + 9 * 3 * cv.KC * bn) * 2}


def wino_plan(n: int, z: int, y: int, x: int, c: int, cout: int,
              body: str | None = None) -> dict:
    """The Winograd arm's body (as mt_conv_wino chooses it, by C alone,
    unless `body` names one), the bytes its copies bring from L2 into shared
    memory a launch (halo and padded channels included) and its own work:
    `products_flops`, the 64 transform-domain GEMMs over every 2x2x2 tile at
    C_P and CoutP (either body). The TMA body: a work item of 64 tiles (an
    8x8x8 output box) x 64 columns loads, a 64-channel chunk, its 10x10x10
    input box (128-byte rows) and U's 64 rows x 64 columns at each of the 64
    positions. The first body: a block of 32 tiles (a 4x8x8 box) x 128
    columns loads, a slab of up to 128 channels, its 6x10x10 input box and
    U's slab rows x 128 columns at each position."""
    cp = _round_up(c, cv.KC)
    coutp = _round_up(cout, 128)
    flops = 2 * (n * z * y * x // 8) * 64 * cp * coutp
    if _body(c, body) == "tma":
        items = n * -(-z // 8) * -(-y // 8) * -(-x // 8) * (coutp // 64)
        chunks = -(-cp // 64)
        return {"body": "tma", "tiles": items, "stages_per_tile": 64 * chunks,
                "grid": min(items, SMS), "products_flops": flops,
                "l2_to_shared_bytes": items * chunks * (10 ** 3 * 128 + 64 * 64 * 64 * 2)}
    blocks = n * -(-z // 4) * -(-y // 8) * -(-x // 8) * (coutp // 128)
    widths = [min(128, cp - c0) for c0 in range(0, cp, 128)]
    return {"body": "mma_sync", "tiles": blocks, "stages_per_tile": 64 * len(widths),
            "grid": blocks, "products_flops": flops,
            "l2_to_shared_bytes": blocks * sum(6 * 10 * 10 * w * 2 + 64 * w * 128 * 2
                                               for w in widths)}


def products_floor_ms(flops: float) -> float:
    """The least time of `flops` bf16 tensor-core operations on the H100."""
    return flops / PEAK_BF16_FLOPS * 1e3


def _counted(kernel, plan, x: torch.Tensor, pw: ArmWeight) -> None:
    kernel.launches += 1
    kernel.launches_by_body[plan(*(int(s) for s in x.shape), pw.cout)["body"]] += 1


def conv3d_im2col(x: torch.Tensor, pw: ArmWeight, out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """The im2col arm: SAME 3x3x3 conv of x (N, Z, Y, X, Cin <= 128) -> (N,
    Z, Y, X, Cout), bf16, fp32 accumulation, into `out` where given, on the
    body `im2col_plan` names. CPU tensors take the direct conv
    (conv3d_same_ref)."""
    if x.device.type == "cpu":
        return _util.into(out, cv.conv3d_same_ref(x, arm_weight_taps(pw)))
    out = _launch_arm("mt_conv_im2col", x, pw, "im2col", out)
    _counted(conv3d_im2col, im2col_plan, x, pw)
    return out


def conv3d_tap3(x: torch.Tensor, pw: ArmWeight, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The tap3 arm (x taps folded into K), on the body `tap3_plan` names.
    CPU tensors take the direct conv."""
    if x.device.type == "cpu":
        return _util.into(out, cv.conv3d_same_ref(x, arm_weight_taps(pw)))
    out = _launch_arm("mt_conv_tap3", x, pw, "tap3", out)
    _counted(conv3d_tap3, tap3_plan, x, pw)
    return out


def conv3d_wino(x: torch.Tensor, pw: ArmWeight, out: torch.Tensor | None = None
                ) -> torch.Tensor:
    """The Winograd arm, even Z, Y, X, on the body `wino_plan` names. CPU
    tensors take winograd_conv3d_ref."""
    if x.device.type == "cpu":
        return _util.into(out, winograd_conv3d_ref(x, pw))
    if any(int(s) % 2 for s in x.shape[1:4]):
        raise ValueError(f"conv3d_wino takes even spatial sizes, got {tuple(x.shape)}")
    out = _launch_arm("mt_conv_wino", x, pw, "wino", out)
    _counted(conv3d_wino, wino_plan, x, pw)
    return out


for _kernel in (conv3d_im2col, conv3d_tap3, conv3d_wino):
    _kernel.launches = 0
    _kernel.launches_by_body = dict.fromkeys(ARM_BODIES, 0)


def prepare(weight: torch.Tensor, arm: str, dtype: torch.dtype = torch.bfloat16):
    """The weight in arm's layout: kernel A's for tap and sum."""
    if arm in ("tap", "sum"):
        return cv.prepare_conv3d_weight(weight, dtype=dtype)
    return prepare_arm_weight(weight, arm, dtype=dtype)


def run_arm(arm: str, x: torch.Tensor, pw) -> torch.Tensor:
    """SAME 3x3x3 conv of x by `arm` with its prepared weight."""
    if arm in ("tap", "sum"):
        return cv.conv3d_same(x, pw)
    return {"im2col": conv3d_im2col, "tap3": conv3d_tap3, "wino": conv3d_wino}[arm](x, pw)


def kernels() -> dict:
    """This probe's kernel wrappers by name (their launch counts)."""
    return {"conv3d_im2col": conv3d_im2col, "conv3d_tap3": conv3d_tap3,
            "conv3d_wino": conv3d_wino}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m multitalent_tpu_torch.probes.conv_impl_arms",
                                 description="SAME 3x3x3 conv by arm: parity, then (card) "
                                             "timed at the flagship's packed stage-0 shape")
    ap.add_argument("arms", nargs="*", help=f"arms to run (default all: {' '.join(ARMS)})")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=10, help="timed launches per arm")
    args = ap.parse_args(argv)
    arms = args.arms or list(ARMS)
    unknown = sorted(set(arms) - set(ARMS))
    if unknown:
        ap.error(f"unknown arms {unknown}; choose from {ARMS}")
    device = _util.resolve_device(args.device)
    on_card = device.type == "cuda"
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(PARITY_SHAPE, dtype=np.float32)).to(device)
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, 120, 120)) * 0.1).astype(np.float32))
    w = w.permute(4, 3, 0, 1, 2).contiguous().to(device)  # DHWIO -> torch (O, I, D, H, W)
    results = {}
    if on_card:  # the kernels take bf16: parity on the bf16-rounded input
        x = x.to(torch.bfloat16)
    ref = cv.conv3d_same_ref(x.float(), w)
    for arm in arms:
        out = run_arm(arm, x, prepare(w, arm, x.dtype))
        err = (out.float() - ref).abs().max().item()
        bound = ATOL + RTOL * ref.abs().max().item() if on_card else PARITY_BOUND
        print(f"{arm:7s} parity maxerr {err:.2e} (bound {bound:.2e})", flush=True)
        if not err < bound:
            raise AssertionError(f"{arm}: max|d| {err:.3e} >= {bound:.3e}")
        results[arm] = {"parity_err": err, "parity_bound": bound}
    if not on_card:
        print("no card: skipping the timed A/B")
        return results
    xb = torch.from_numpy(rng.standard_normal(TIMED_SHAPE, dtype=np.float32)).to(
        device, torch.bfloat16)
    for arm in arms:
        pw = prepare(w, arm)
        ms = _util.median_ms(lambda: run_arm(arm, xb, pw), args.iters)
        print(f"{arm:7s} {ms:7.3f} ms/conv at {TIMED_SHAPE} -> 120 bf16", flush=True)
        results[arm]["ms"] = ms
    return results


if __name__ == "__main__":
    main()
