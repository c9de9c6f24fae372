"""The grid-overhead probe on the H100: one kernel's time at constant work
as the tile each block owns, and so the number of blocks, changes.

Counterpart of scripts/grid_overhead_probe.py. Its Pallas kernels
`zeros_kernel` (:49, pallas_call :54; a (96, 96, 96, 128) bf16 zero fill at
blocks (8, 16, 16), (8, 32, 48) and (96, 96, 96)) and `conv_kernel` (:68,
pallas_call :123; the center-view conv of probes/conv_cost_isolate.py at
blocks (8, 16, 16), (8, 32, 32), (8, 48, 96) with 27 or 12 dots) become:

- `zeros` (csrc/probe_kernels.cu): writes the tensor's zeros tile by tile, one
  block per tile, each block by its tile's contiguous runs (`zeros_plan`)
  with 16-byte streaming stores (the C entry `mt_zeros_form` also runs bulk
  stores by the TMA unit from zeroed shared memory, for the probes'
  comparisons; on the H100 they were never faster); plain version
  `zeros_ref` (torch.zeros);
- `centern` of probes/conv_cost_isolate.py, the tile as its parameter.

On the TPU the grid runs in order on one core, so a grid step's fixed cost
adds up; on the H100 blocks run side by side on 132 SMs, and a large tile
means fewer blocks than SMs: a (96, 96, 96) tile is a grid of one block, and
the probe measures that as it is.

    python -m multitalent_tpu_torch.probes.grid_overhead_probe [iters] [--device cpu]

times every configuration on the card (median of `iters`, default 20 as the
script), or runs each once through the plain versions at a 16^3 volume on
the CPU (tiles clipped to the volume).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from multitalent_tpu_torch.probes import _util
from multitalent_tpu_torch.probes.conv_cost_isolate import (C, CPU_SIZE, SIZE, centern,
                                                            check_tile,
                                                            prepare_center_weight)

ZERO_TILES = ((8, 16, 16), (8, 32, 48), (96, 96, 96))  # scripts/grid_overhead_probe.py:52
CONV_CONFIGS = (((8, 16, 16), 27), ((8, 32, 32), 27), ((8, 48, 96), 27),
                ((8, 32, 32), 12), ((8, 48, 96), 12))  # :119-121


ZERO_FORMS = ("vector", "bulk")  # mt_zeros_form's forms 1 and 2


def zeros_plan(shape, tile) -> dict:
    """What the zero fill's kernel does at (Z, Y, X, C) by `tile`, as
    csrc/probe_kernels.cu's mt_zeros and zero_runs decide it: its form
    (always "vector"), the blocks (one a tile), the contiguous runs a block
    writes and the bytes of a run (an x-row of the tile; where the tile
    spans X the rows of a z plane of it, where it spans Y as well the whole
    tile)."""
    z, y, xd, c = (int(s) for s in shape)
    bz, by, bx = (int(t) for t in tile)
    check_tile((z, y, xd), tile)
    blocks = (z // bz) * (y // by) * (xd // bx)
    if bx < xd:
        runs, run = bz * by, bx * c * 2
    elif by < y:
        runs, run = bz, by * xd * c * 2
    else:
        runs, run = 1, bz * y * xd * c * 2
    return {"form": ZERO_FORMS[0], "blocks": blocks, "runs": runs, "run_bytes": run}


def zeros_ref(shape, dtype=torch.bfloat16, device="cpu") -> torch.Tensor:
    """Plain version of the zero fill."""
    return torch.zeros(shape, dtype=dtype, device=device)


def zeros(shape, tile, device, dtype=torch.bfloat16,
          out: torch.Tensor | None = None) -> torch.Tensor:
    """A (Z, Y, X, C) tensor of zeros, C % 8 == 0, written by one block per
    `tile` (which divides (Z, Y, X)) into `out` where given (on `device`),
    else into a new tensor. On the CPU: zeros_ref."""
    z, y, xd, c = (int(s) for s in shape)
    check_tile((z, y, xd), tile)
    if c % 8:
        raise ValueError(f"the zero fill writes 8 channels at a time, got C = {c}")
    device = torch.device(device)
    if out is not None and out.device.type != device.type:
        raise ValueError(f"out lies on {out.device}, the fill runs on {device}")
    if device.type == "cpu":
        return _util.into(out, zeros_ref(shape, dtype))
    if dtype != torch.bfloat16:
        raise TypeError(f"the zero fill writes bfloat16, got {dtype}")
    out = _util.out_tensor(out, (z, y, xd, c), device if out is None else out.device)
    _util.launch("mt_zeros", out.device, out.data_ptr(), z, y, xd, c,
                 *(int(t) for t in tile))
    zeros.launches += 1
    return out


zeros.launches = 0


def kernels() -> dict:
    return {"zeros": zeros, "centern": centern}


def _clip(tile, size: int) -> tuple[int, int, int]:
    return tuple(min(int(t), size) for t in tile)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m multitalent_tpu_torch.probes.grid_overhead_probe",
                                 description="per-block cost at constant work: zero fill and "
                                             "center-view conv by tile")
    ap.add_argument("iters", nargs="?", type=int, default=20, help="timed calls per config")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = _util.resolve_device(args.device)
    on_card = device.type == "cuda"
    size = SIZE if on_card else CPU_SIZE
    dtype = torch.bfloat16 if on_card else torch.float32
    print(f"# device={torch.cuda.get_device_name(device) if on_card else 'cpu'}", flush=True)
    rng = np.random.RandomState(0)
    results = {"zeros": [], "conv": []}

    def run(kind, what, fn, **info):
        if on_card:
            ms = _util.median_ms(fn, args.iters)
            print(f"{what}: {ms:.3f} ms", flush=True)
            results[kind].append({**info, "ms": ms})
        else:
            out = fn()
            print(f"{what}: plain run on the CPU, out {tuple(out.shape)}", flush=True)

    shape = (size, size, size, C)
    for tile in dict.fromkeys(_clip(t, size) for t in ZERO_TILES):
        grid = int(np.prod([s // t for s, t in zip(shape, tile)]))
        run("zeros", f"zeros grid={grid} block={tile}",
            lambda tile=tile: zeros(shape, tile, device, torch.bfloat16), tile=tile, grid=grid)
    x = torch.from_numpy(rng.randn(1, size, size, size, C).astype(np.float32)).to(device, dtype)
    w = prepare_center_weight(torch.from_numpy(
        rng.randn(C, C, 3, 3, 3).astype(np.float32) * .05).to(device), dtype)
    for tile, ndots in dict.fromkeys((_clip(t, size), d) for t, d in CONV_CONFIGS):
        grid = int(np.prod([s // t for s, t in zip(shape, tile)]))
        run("conv", f"conv{ndots} grid={grid} block={tile}",
            lambda tile=tile, ndots=ndots: centern(x, w, ndots, tile),
            tile=tile, grid=grid, ndots=ndots)
    return results


if __name__ == "__main__":
    main()
