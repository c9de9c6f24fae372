"""The conv cost probe on the H100: what `ndots` GEMMs on one operand cost,
beside the real conv kernels and two yardsticks.

Counterpart of scripts/conv_cost_isolate.py. Its Pallas kernel
`centern_kernel` (:48, pallas_call :92) computes
    out = sum over t < ndots of  x @ w[t % 3, (t // 3) % 3, t % 3]
on the center view of a padded (1, 96, 96, 96, 128) bf16 volume, fp32
accumulation, in (8, 16, 16) tiles. `centern` (csrc/probe_kernels.cu) is its
kernel here, with `ndots` and the tile each block owns as parameters (the
same kernel serves probes/grid_overhead_probe.py): wgmma on sub-tiles of up
to 256 voxels of the tile, each a TMA box, the ndots weight matrices
streamed through a TMA ring (`centern_plan` gives its sub-tiles and bytes);
`centern_ref` is its plain version (fp32 matmuls in torch). The wrapper
takes the plain version for CPU tensors only, launches the kernel for CUDA
tensors (or raises) and counts launches in `centern.launches`.

The script's arms (:121-131) map to the port as:
- dense27: kernel A (`ops/conv3d.conv3d_same`) at 120 -> 120 on the packed
  stage-0 tensor's shape (1, 96, 96, 96, 120);
- center27, center12: `centern` with 27 and 12 dots;
- merged12: the packed conv (`probes/sparse_conv_arm.packed_conv3d`) at
  factors (2, 2), C = 30, on the same packed tensor;
- add216MiB, matmul8192: PyTorch calls (`a + 1` on (96, 96, 96, 128) bf16,
  an 8192^2 bf16 matmul), yardsticks of the card's bytes and operations only.

    python -m multitalent_tpu_torch.probes.conv_cost_isolate [iters] [--device cpu]

times each arm on the card (median of `iters` launches, default 20 as the
script), or runs each once through the plain versions at a 16^3 volume on
the CPU.
"""
from __future__ import annotations

import argparse
from math import prod

import numpy as np
import torch

from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import _util
from multitalent_tpu_torch.probes.sparse_conv_arm import packed_conv3d

SIZE = 96          # the probe's volume edge (scripts/conv_cost_isolate.py:41)
C = 128            # its channels (:42)
TILE = (8, 16, 16)  # its block (:43)
CPU_SIZE = 16      # the volume edge of a plain run on the CPU


def tap_of_dot(t: int) -> tuple[int, int, int]:
    """The weight tap dot t reads: (t % 3, (t // 3) % 3, t % 3) (:85)."""
    return t % 3, (t // 3) % 3, t % 3


def prepare_center_weight(weight: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """torch Conv3d weight (Cout <= 128, C, 3, 3, 3) -> the kernel's (27, C,
    128): [(dz*3 + dy)*3 + dx, ci, co], output channels zero-padded."""
    cout, cin = int(weight.shape[0]), int(weight.shape[1])
    taps = weight.permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    return torch.nn.functional.pad(taps.float(), (0, 128 - cout)).to(dtype).contiguous()


def centern_ref(x: torch.Tensor, weight: torch.Tensor, ndots: int) -> torch.Tensor:
    """Plain version: sum over t < ndots of x @ w_t in fp32 (fp64 for fp64 x),
    w_t = weight[:, :, t % 3, (t // 3) % 3, t % 3].T; x (N, Z, Y, X, C), weight
    (Cout, C, 3, 3, 3); x's dtype out."""
    acc = cv._acc_dtype(x)
    rows = x.reshape(-1, x.shape[-1]).to(acc)
    out = None
    for t in range(ndots):
        dz, dy, dx = tap_of_dot(t)
        d = rows @ weight[:, :, dz, dy, dx].T.to(acc)
        out = d if out is None else out + d
    return out.reshape(*x.shape[:4], -1).to(x.dtype)


def check_tile(shape, tile) -> None:
    """Raise unless `tile` (bz, by, bx) divides the volume `shape` (Z, Y, X)."""
    if len(tile) != 3 or any(int(s) % int(t) for s, t in zip(shape, tile)):
        raise ValueError(f"the tile {tuple(tile)} must divide the volume {tuple(shape)}")


def centern_sub_tiles(tile) -> tuple[int, int, int]:
    """The kernel's sub-tile (sz, sy, sx) of a tile (bz, by, bx): a box that
    divides the tile, of at most 256 voxels, taking the fewest m64 products
    over the tile, then the fewest boxes; of equals the first with the
    longest x, then y (csrc/probe_kernels.cu:sub_tiles)."""
    bz, by, bx = (int(t) for t in tile)
    best = None
    for sx in range(min(bx, 256), 0, -1):
        if bx % sx:
            continue
        for sy in range(min(by, 256), 0, -1):
            if by % sy or sx * sy > 256:
                continue
            for sz in range(min(bz, 256), 0, -1):
                if bz % sz or sx * sy * sz > 256:
                    continue
                boxes = (bx // sx) * (by // sy) * (bz // sz)
                key = (boxes * -(-(sx * sy * sz) // 64), boxes)
                if best is None or key < best[0]:
                    best = (key, (sz, sy, sx))
    return best[1]


def centern_plan(n: int, spatial, c: int, ndots: int, tile=TILE, sms: int = 132) -> dict:
    """What the kernel does at these sizes: its sub-tile, the sub-tiles and
    blocks of the launch (persistent blocks: at most one an SM) and the bytes
    its copies stage into shared memory (each sub-tile's voxels, 64 channels
    a box, and the ndots (C, 128) weight matrices once a sub-tile)."""
    check_tile(spatial, tile)
    sub = centern_sub_tiles(tile)
    tiles = n * prod(int(s) // int(t) for s, t in zip(spatial, tile))
    subs = tiles * prod(int(t) // s for t, s in zip(tile, sub))
    rows = prod(sub)
    return {"body": "wgmma", "sub_tile": sub, "tiles": tiles, "sub_tiles": subs,
            "grid": min(tiles, sms),
            "l2_to_shared_bytes": subs * (-(-c // 64) * rows * 128 + ndots * c * 128 * 2)}


def centern(x: torch.Tensor, w: torch.Tensor, ndots: int, tile=TILE,
            cout: int | None = None, out: torch.Tensor | None = None) -> torch.Tensor:
    """The center-view conv of x (N, Z, Y, X, C), C % 16 == 0 and <= 128,
    with w from prepare_center_weight, `ndots` dots, one block per `tile`
    (which divides the volume) -> (N, Z, Y, X, Cout) bf16, Cout = cout or
    C, written into `out` where given. CPU tensors take centern_ref."""
    n, z, y, xd, c = (int(s) for s in x.shape)
    cout = c if cout is None else int(cout)
    check_tile((z, y, xd), tile)
    if tuple(w.shape) != (27, c, 128) or cout > 128 or ndots < 1:
        raise ValueError(f"weight {tuple(w.shape)} for x {tuple(x.shape)}, Cout {cout}, "
                         f"ndots {ndots}")
    if x.device.type == "cpu":
        weight = w[:, :, :cout].permute(2, 1, 0).reshape(cout, c, 3, 3, 3)
        return _util.into(out, centern_ref(x, weight, ndots))
    _util.check_tensor(x, "x")
    _util.check_tensor(w, "prepared weight")
    if c % 16 or c > 128 or w.device != x.device:
        raise ValueError(f"centern takes C % 16 == 0 and <= 128 on one device, got {c}")
    out = _util.out_tensor(out, (n, z, y, xd, cout), x.device)
    _util.launch("mt_centern", x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), n, z, y,
                 xd, c, cout, int(ndots), *(int(t) for t in tile))
    centern.launches += 1
    return out


centern.launches = 0


def kernels() -> dict:
    return {"centern": centern}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m multitalent_tpu_torch.probes.conv_cost_isolate",
                                 description="the packed conv's cost structure: center-view "
                                             "dots beside the real kernels and yardsticks")
    ap.add_argument("iters", nargs="?", type=int, default=20, help="timed calls per arm")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = _util.resolve_device(args.device)
    on_card = device.type == "cuda"
    size = SIZE if on_card else CPU_SIZE
    dtype = torch.bfloat16 if on_card else torch.float32
    print(f"# device={torch.cuda.get_device_name(device) if on_card else 'cpu'}", flush=True)
    rng = np.random.RandomState(0)
    xinp = torch.from_numpy(rng.randn(1, size, size, size, 120).astype(np.float32)).to(
        device, dtype)
    w30 = torch.from_numpy(rng.randn(30, 30, 3, 3, 3).astype(np.float32) * .1).to(device)
    w120 = torch.from_numpy(rng.randn(120, 120, 3, 3, 3).astype(np.float32) * .05).to(device)
    x128 = torch.from_numpy(rng.randn(1, size, size, size, C).astype(np.float32)).to(
        device, dtype)
    w128 = torch.from_numpy(rng.randn(C, C, 3, 3, 3).astype(np.float32) * .05).to(device)
    pw120 = cv.prepare_conv3d_weight(w120, dtype=dtype)
    pw30 = cv.prepare_conv3d_weight(w30, dtype=dtype)
    wc = prepare_center_weight(w128, dtype)
    big = torch.ones((size, size, size, C), dtype=dtype, device=device)
    mm = torch.ones((8192, 8192) if on_card else (256, 256), dtype=dtype, device=device)
    arms = {
        "add216MiB": lambda: big + 1,
        "matmul8192": lambda: mm @ mm,
        "dense27": lambda: cv.conv3d_same(xinp, pw120),
        "center27": lambda: centern(x128, wc, 27),
        "center12": lambda: centern(x128, wc, 12),
        "merged12": lambda: packed_conv3d(xinp, pw30, (2, 2)),
    }
    results = {}
    for name, fn in arms.items():
        if not on_card:
            out = fn()
            print(f"{name}: plain run on the CPU, out {tuple(out.shape)}, max|out| "
                  f"{out.abs().max().item():.3e}", flush=True)
            continue
        ms = _util.median_ms(fn, args.iters)
        print(f"{name}: {ms:.3f} ms", flush=True)
        results[name] = ms
    return results


if __name__ == "__main__":
    main()
