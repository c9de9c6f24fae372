"""How the wgmma body of kernels A and B (`csrc/conv3d_wgmma.cu`) addresses
its operands, in plain torch, so that the CPU can check what only the card
runs.

Shared memory is a flat array of 2-byte elements addressed in bytes. The
body stages, per 16-channel K chunk, the TMA halo box of its 4x8x8 output
tile (`tma_box`: the tensor map's box of 8 channels x 10 x 10 x 6 at (c0,
x0-1, y0-1, z0-1, n), 0 outside the tensor) as two 8-channel units, and per
9 taps a weight stage (`weight_stage`: 64-column boxes of the prepared
weight's (rows, CoutP) view, written with TMA's 128-byte swizzle, 0 past
CoutP). Each wgmma reads its operands through shared-memory matrix
descriptors (start address, leading and stride byte offsets, layout):
`read_a` reads m64 x k16 of the no-swizzle K-major layout, `read_b` k16 x N
of the 128-byte-swizzled MN-major layout, as the PTX ISA's canonical
layouts define them. `conv3d` assembles the whole conv from those reads,
tap by tap with the kernel's descriptors (`box_desc`, `weight_desc`), and
stores the voxels inside the volume: the tests hold it to the plain version
and to the Pallas kernels.
"""
from __future__ import annotations

import torch

from multitalent_tpu_torch.ops.conv3d import KC, PreparedWeight

BOX = (4, 8, 8)                              # output tile (z, y, x)
HALO = tuple(b + 2 for b in BOX)             # its halo box: 6, 10, 10
UNIT = 8                                     # channels of a TMA box row (16 bytes)
LINE_BYTES = HALO[2] * UNIT * 2              # 160: one halo line, the A operand's SBO
UNIT_BYTES = HALO[0] * HALO[1] * LINE_BYTES  # 9600: one unit's box, the A operand's LBO
W_TAPS = 9                                   # taps a weight stage (one dz)
W_ROWS = W_TAPS * KC                         # 144 rows of a weight box
W_BOX_BYTES = W_ROWS * 128                   # 18432: a 64-column box, the B operand's LBO
W_ATOM_BYTES = 1024                          # 8 swizzled 128-byte rows, the B operand's SBO
LAYOUT_NONE, LAYOUT_B128 = 0, 1


def descriptor(start: int, lbo: int, sbo: int, layout: int) -> int:
    """wgmma's 64-bit shared-memory matrix descriptor: start address >> 4
    (bits 0-13), LBO >> 4 (16-29), SBO >> 4 (32-45), layout (62-63)."""
    return (((start & 0x3FFFF) >> 4) | (((lbo >> 4) & 0x3FFF) << 16)
            | (((sbo >> 4) & 0x3FFF) << 32) | (layout << 62))


def decode(desc: int) -> tuple[int, int, int, int]:
    """(start, lbo, sbo, layout) in bytes of a descriptor."""
    return ((desc & 0x3FFF) << 4, ((desc >> 16) & 0x3FFF) << 4,
            ((desc >> 32) & 0x3FFF) << 4, desc >> 62)


def box_desc(box: int, plane: int, dz: int, dy: int, dx: int) -> int:
    """The A operand of z plane `plane` of the tile, tap (dz, dy, dx), in the
    chunk staged at byte `box`: 8 y lines (SBO) of 8 x voxels (a core
    matrix), the chunk's two units LBO apart."""
    start = box + ((plane + dz) * HALO[1] + dy) * LINE_BYTES + dx * UNIT * 2
    return descriptor(start, UNIT_BYTES, LINE_BYTES, LAYOUT_NONE)


def weight_desc(stage: int, t: int) -> int:
    """The B operand of tap t (0..8) of the weight stage at byte `stage`: 16
    rows of 64 columns (two swizzle atoms, SBO), 64-column boxes LBO apart."""
    return descriptor(stage + t * KC * 128, W_BOX_BYTES, W_ATOM_BYTES, LAYOUT_B128)


def swizzle128(addr: torch.Tensor) -> torch.Tensor:
    """The 128-byte swizzle of byte addresses (from a 1024-byte-aligned
    base): the 16-byte chunk of a 128-byte row XOR the row's index mod 8."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box(x: torch.Tensor, nb: int, c0: int, z0: int, y0: int, x0: int) -> torch.Tensor:
    """The activation map's box at (c0, x0-1, y0-1, z0-1, nb) of channels-last
    x (N, Z, Y, X, C): (6, 10, 10, 8), 0 outside the tensor (the SAME halo,
    the far edges, channels at or past C)."""
    out = torch.zeros((*HALO, UNIT), dtype=x.dtype)
    _, nz, ny, nx, c = x.shape
    lo = (z0 - 1, y0 - 1, x0 - 1)
    src = [slice(max(o, 0), min(o + h, d)) for o, h, d in zip(lo, HALO, (nz, ny, nx))]
    dst = [slice(s.start - o, s.stop - o) for s, o in zip(src, lo)]
    if c0 < c and all(s.stop > s.start for s in src):
        cs = slice(c0, min(c0 + UNIT, c))
        out[dst[0], dst[1], dst[2], :cs.stop - c0] = x[nb, src[0], src[1], src[2], cs]
    return out


def stage_chunk(x: torch.Tensor, nb: int, c0: int, z0: int, y0: int, x0: int) -> torch.Tensor:
    """One chunk's staged box as the body's two TMA loads leave it:
    [unit][z][y][x][8 channels], flat (2 * UNIT_BYTES bytes)."""
    return torch.cat([tma_box(x, nb, c0 + u * UNIT, z0, y0, x0).reshape(-1) for u in (0, 1)])


def weight_stage(pw: PreparedWeight, kc: int, group: int, n0: int, bn: int) -> torch.Tensor:
    """The weight stage of chunk kc, taps [9 group, + 9), columns [n0, +
    bn): bn / 64 boxes of (144 rows, 64 columns) of the (rows, CoutP) view,
    each row's 16-byte chunks swizzled, 0 past CoutP; flat elements."""
    rows = pw.w.reshape(-1, pw.coutp)
    row0 = (kc * 27 + group * W_TAPS) * KC
    out = torch.zeros(bn // 64 * W_BOX_BYTES // 2, dtype=pw.w.dtype)
    r = torch.arange(W_ROWS).reshape(-1, 1)
    col = torch.arange(64).reshape(1, -1)
    for h in range(bn // 64):
        c = n0 + h * 64 + col
        vals = torch.where(c < pw.coutp, rows[row0 + r, c.clamp(max=pw.coutp - 1)],
                           torch.zeros((), dtype=pw.w.dtype))
        addr = swizzle128(h * W_BOX_BYTES + r * 128 + col * 2)
        out[(addr // 2).reshape(-1)] = vals.reshape(-1)
    return out


def read_a(smem: torch.Tensor, desc: int) -> torch.Tensor:
    """m64 x k16 of the no-swizzle K-major layout: a core matrix is 8 rows
    of 16 contiguous bytes (8 k), row groups along M are SBO apart, the two
    k halves LBO apart."""
    start, lbo, sbo, layout = decode(desc)
    assert layout == LAYOUT_NONE
    m = torch.arange(64).reshape(-1, 1)
    k = torch.arange(KC).reshape(1, -1)
    addr = start + (m // 8) * sbo + (m % 8) * 16 + (k // 8) * lbo + (k % 8) * 2
    return smem[addr // 2]


def read_b(smem: torch.Tensor, desc: int, n: int) -> torch.Tensor:
    """k16 x n of the 128-byte-swizzled MN-major layout: 64 contiguous
    columns (128 bytes) a k row, 8 rows an atom, k atoms SBO apart, 64-column
    blocks LBO apart, the 128-byte swizzle on every address."""
    start, lbo, sbo, layout = decode(desc)
    assert layout == LAYOUT_B128
    k = torch.arange(KC).reshape(-1, 1)
    c = torch.arange(n).reshape(1, -1)
    addr = start + (c // 64) * lbo + (c % 64) * 2 + (k % 8) * 128 + (k // 8) * sbo
    return smem[swizzle128(addr) // 2]


def conv3d(inputs: list[torch.Tensor], pw: PreparedWeight, bias: torch.Tensor | None = None,
           bn: int = 128) -> torch.Tensor:
    """Kernel A (one input) or B (two, chunks in [a | b] order) as the wgmma
    body computes it, every product read through the body's descriptors, in
    float64: (N, Z, Y, X, Cout)."""
    n, z, y, x = (int(s) for s in inputs[0].shape[:4])
    chunks = [(t, c0) for t in inputs for c0 in range(0, int(t.shape[-1]), KC)]
    out = torch.zeros((n, z, y, x, pw.cout), dtype=torch.float64)
    w = PreparedWeight(pw.w.double(), pw.splits, pw.cout, pw.bn)
    tiles = [(nb, z0, y0, x0) for nb in range(n) for z0 in range(0, z, BOX[0])
             for y0 in range(0, y, BOX[1]) for x0 in range(0, x, BOX[2])]
    for nb, z0, y0, x0 in tiles:
        for n0 in range(0, pw.cout, bn):
            acc = torch.zeros((BOX[0], 64, bn), dtype=torch.float64)
            for kc, (t, c0) in enumerate(chunks):
                box = stage_chunk(t.double(), nb, c0, z0, y0, x0)
                for g in range(3):
                    stage = weight_stage(w, kc, g, n0, bn)
                    for tap in range(W_TAPS):
                        b = read_b(stage, weight_desc(0, tap), bn)
                        for plane in range(BOX[0]):
                            a = read_a(box, box_desc(0, plane, g, tap // 3, tap % 3))
                            acc[plane] += a @ b
            # rows m = y * 8 + x of each plane; store those inside the volume
            tile = acc.reshape(BOX[0], BOX[1], BOX[2], bn)
            zs, ys, xs = min(BOX[0], z - z0), min(BOX[1], y - y0), min(BOX[2], x - x0)
            cs = min(bn, pw.cout - n0)
            out[nb, z0:z0 + zs, y0:y0 + ys, x0:x0 + xs, n0:n0 + cs] = tile[:zs, :ys, :xs, :cs]
    if bias is not None:
        out += bias.double()
    return out
