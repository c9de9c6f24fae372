"""The packed-conv probe on the H100: the stride-1 SAME 3x3x3 conv of a
space-to-depth packed tensor, read and written packed.

Counterpart of scripts/pallas_sparse_conv_arm.py, whose Pallas kernel
`_sparse_kernel` (:165, pallas_call :287) runs the conv on a tensor packed
(N, Z, Y/fy, X/fx, fy*fx*C), phase-major (py, px, c), factors (2, 2) or
(1, 2), optionally of concatenated input groups (`in_groups`, layout
[P*g0 | P*g1 | ...]), as 12 or 18 merged sparse-tap GEMMs on lane-gathered
inputs. `packed_conv3d` computes the function instead: the direct conv of
the unpacked tensor, the depth-to-space folded into its loads and the
space-to-depth into its stores, at 1x the direct conv's FLOPs. Its kernel is
kernel A's ring body with packed addresses (conv3d_a_kernel's PACKED
instantiations in csrc/conv3d_same.cu, `mt_packed_conv3d`), on kernel A's
plan at the unpacked sizes with the K loop whole
(`ops.conv3d.conv3d_same_plan(..., "packed")`): its line loader reads each
voxel's rows at their packed places (`packed_source_offsets` mirrors that
mapping and the loader's walk along x, `packed_copy_width` its copy width)
and its epilogue writes each output voxel's row at its packed place.
Its plain version, `packed_conv3d_ref`, is
space_to_depth(conv3d_same_ref(depth_to_space(x))) with the groups regrouped.
The wrapper takes it for CPU tensors only, launches the kernel for CUDA
tensors (or raises) and counts launches in `packed_conv3d.launches`.

    python -m multitalent_tpu_torch.probes.sparse_conv_arm [--device cpu]

checks the three cases of the script's `_parity_check` (:389-412) against the
direct conv in packed space and, on the card, times the kernel at the
flagship's stage 0 (unpacked (1, 96, 192, 192, 30), factors (2, 2)) and stage 1
((1, 48, 96, 96, 60), factors (1, 2)).
"""
from __future__ import annotations

import argparse
import ctypes

import numpy as np
import torch

from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import _util

# (factors, C, groups) of the script's _parity_check (:389-390), Cout 24
PARITY_CASES = (((2, 2), 30, None), ((1, 2), 60, None), ((2, 2), 32, (20, 12)))
PARITY_COUT = 24
PARITY_ATOL = 1e-4  # the script's, fp32 (:411-412)
# the flagship's stage 0 and stage 1 convs, unpacked shape and factors
TIMED_CASES = (((1, 96, 192, 192, 30), (2, 2)), ((1, 48, 96, 96, 60), (1, 2)))
# bf16 kernel vs the fp32 plain version on the same bf16 input, as
# chip_smoke.py's phase 2: ATOL + RTOL * max|ref|
RTOL, ATOL = 1e-2, 1e-2


def space_to_depth_yx(x: torch.Tensor, factors) -> torch.Tensor:
    """(N, Z, Y, X, C) -> (N, Z, Y/fy, X/fx, fy*fx*C), phase-major (py, px, c)
    (multitalent_tpu/ops/packed_conv.py:59)."""
    fy, fx = int(factors[0]), int(factors[1])
    n, z, y, xd, c = x.shape
    x = x.reshape(n, z, y // fy, fy, xd // fx, fx, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(n, z, y // fy, xd // fx, fy * fx * c)


def depth_to_space_yx(x: torch.Tensor, factors) -> torch.Tensor:
    """Inverse of space_to_depth_yx."""
    fy, fx = int(factors[0]), int(factors[1])
    n, z, yp, xp, pc = x.shape
    c = pc // (fy * fx)
    x = x.reshape(n, z, yp, xp, fy, fx, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(n, z, yp * fy, xp * fx, c)


def unpack(x_packed: torch.Tensor, factors, in_groups=None) -> torch.Tensor:
    """The unpacked (N, Z, Y, X, C) tensor, groups concatenated [g0 | g1 ...]."""
    p = int(factors[0]) * int(factors[1])
    if in_groups is None:
        return depth_to_space_yx(x_packed, factors)
    parts, base = [], 0
    for g in in_groups:
        parts.append(depth_to_space_yx(x_packed[..., base * p:(base + g) * p], factors))
        base += g
    return torch.cat(parts, -1)


def packed_copy_width(groups) -> int:
    """Elements a copy of the packed conv's loader moves: the largest of 8,
    4, 2 and 1 that divides every group's size (one group: C), so that no
    copy straddles a group (csrc/conv3d_same.cu:mt_packed_conv3d)."""
    vec = 8
    for g in (groups,) if isinstance(groups, int) else groups:
        while int(g) % vec:
            vec //= 2
    return vec


def packed_source_offsets(shape, factors, in_groups=None, step: int = 1) -> torch.Tensor:
    """int64 (N, Z, Y, X, C): the element of the flattened packed tensor that
    holds each unpacked voxel and channel (shape the unpacked (N, Z, Y, X,
    C), channels [g0 | g1 ...]), as the packed conv's line loader
    (csrc/conv3d_same.cu:load_lines_packed) finds it: channel c of the group
    at [base, base + size) of voxel (n, z, y, x) at
        vox * P * C + base * P + phase * size + (c - base),
        vox = ((n * Z + z) * Y / fy + y / fy) * X / fx + x / fx,
        phase = (y % fy) * fx + x % fx,
    the x offsets walked as a lane walks its line: from its first voxel j <
    `step` in steps of `step` voxels (the kernel's vpi), x / fx and x % fx
    carried, with no division."""
    n, z, y, xd, c = (int(s) for s in shape)
    fy, fx = int(factors[0]), int(factors[1])
    groups = (c,) if in_groups is None else tuple(int(g) for g in in_groups)
    pc = fy * fx * c
    base = np.repeat(np.cumsum((0,) + groups[:-1]), groups)
    size = np.repeat(groups, groups)
    chan = base * fy * fx + np.arange(c) - base                      # (C,)
    xq, xr = np.zeros(xd, np.int64), np.zeros(xd, np.int64)
    aq, ar = divmod(step, fx)
    for j in range(min(step, xd)):
        q, r = divmod(j, fx)
        for v in range(j, xd, step):
            xq[v], xr[v] = q, r
            q, r = q + aq, r + ar
            if r >= fx:
                q, r = q + 1, r - fx
    nz = np.arange(n)[:, None] * z + np.arange(z)                    # (N, Z)
    yq, yr = np.divmod(np.arange(y), fy)
    line = (nz[:, :, None] * (y // fy) + yq) * (xd // fx) * pc       # (N, Z, Y)
    off = (line[..., None, None] + yr[:, None, None] * fx * size
           + xq[:, None] * pc + xr[:, None] * size + chan)
    return torch.from_numpy(off.astype(np.int64))


def packed_conv3d_ref(x_packed: torch.Tensor, weight: torch.Tensor, factors,
                      in_groups=None) -> torch.Tensor:
    """Plain version: space_to_depth(conv3d_same_ref(depth_to_space(x))), the
    torch Conv3d weight (Cout, Cin, 3, 3, 3) over the unpacked channels
    [g0 | g1 ...]; fp32 sums, x's dtype out."""
    return space_to_depth_yx(cv.conv3d_same_ref(unpack(x_packed, factors, in_groups), weight),
                             factors)


def packed_conv3d(x_packed: torch.Tensor, pw: cv.PreparedWeight, factors,
                  in_groups=None, out: torch.Tensor | None = None) -> torch.Tensor:
    """The SAME 3x3x3 conv of a packed tensor (N, Z, Y/fy, X/fx, fy*fx*Cin),
    in_groups (at most 4) or one group, -> tight phase-major (N, Z, Y/fy,
    X/fx, fy*fx*Cout) bf16, into `out` where given; pw from
    prepare_conv3d_weight over the unpacked channels. CPU tensors take
    packed_conv3d_ref."""
    fy, fx = int(factors[0]), int(factors[1])
    p = fy * fx
    n, z, yp, xp, pc = (int(s) for s in x_packed.shape)
    cin = pc // p
    groups = tuple(int(g) for g in in_groups) if in_groups is not None else (cin,)
    if pc % p or sum(groups) != cin or pw.splits != (cin,):
        raise ValueError(f"packed input {tuple(x_packed.shape)} with factors {factors}, "
                         f"groups {groups} and a weight for {pw.splits} channels")
    if x_packed.device.type == "cpu":
        return _util.into(out, packed_conv3d_ref(x_packed, cv.unprepare_conv3d_weight(pw),
                                                 factors, in_groups))
    _util.check_tensor(x_packed, "x_packed")
    _util.check_tensor(pw.w, "prepared weight")
    if pw.w.device != x_packed.device or len(groups) > 4:
        raise ValueError("the weight must lie on the input's device; at most 4 groups")
    out = _util.out_tensor(out, (n, z, yp, xp, p * pw.cout), x_packed.device)
    garr = (ctypes.c_int * len(groups))(*groups)
    _util.launch("mt_packed_conv3d", x_packed.device, x_packed.data_ptr(), pw.w.data_ptr(),
                 out.data_ptr(), garr, len(groups), n, z, yp * fy, xp * fx, cin, pw.cout,
                 pw.coutp, pw.bn, fy, fx)
    packed_conv3d.launches += 1
    return out


packed_conv3d.launches = 0


def kernels() -> dict:
    return {"packed_conv3d": packed_conv3d}


def parity_inputs(factors, c, groups, rng) -> tuple[torch.Tensor, torch.Tensor]:
    """The script's parity inputs (:391-404): packed x (2, 8, 16/fy, 16/fx,
    P*C) and a torch weight (24, C, 3, 3, 3), seeded."""
    w = torch.from_numpy((rng.standard_normal((3, 3, 3, c, PARITY_COUT)) * 0.1)
                         .astype(np.float32)).permute(4, 3, 0, 1, 2).contiguous()
    sizes = (c,) if groups is None else groups
    xs = [torch.from_numpy(rng.standard_normal((2, 8, 16, 16, g)).astype(np.float32))
          for g in sizes]
    return torch.cat([space_to_depth_yx(v, factors) for v in xs], -1), w


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m multitalent_tpu_torch.probes.sparse_conv_arm",
                                 description="SAME conv of a packed tensor: parity, then "
                                             "(card) timed at the flagship's stages 0 and 1")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--iters", type=int, default=10, help="timed launches per shape")
    args = ap.parse_args(argv)
    device = _util.resolve_device(args.device)
    on_card = device.type == "cuda"
    results = {"parity": [], "timed": []}
    for factors, c, groups in PARITY_CASES:
        rng = np.random.default_rng(3)
        xg, w = parity_inputs(factors, c, groups, rng)
        xg, w = xg.to(device), w.to(device)
        if on_card:
            xg = xg.to(torch.bfloat16)
        ref = packed_conv3d_ref(xg.float(), w, factors, groups)
        pw = cv.prepare_conv3d_weight(w, dtype=torch.bfloat16 if on_card else torch.float32)
        err = (packed_conv3d(xg, pw, factors, groups).float() - ref).abs().max().item()
        bound = ATOL + RTOL * ref.abs().max().item() if on_card else PARITY_ATOL
        print(f"parity factors={factors} c={c} groups={groups}: maxerr {err:.2e} "
              f"(bound {bound:.2e})", flush=True)
        if not err <= bound:
            raise AssertionError(f"packed conv {factors} {c} {groups}: {err:.3e} > {bound:.3e}")
        results["parity"].append({"factors": factors, "c": c, "groups": groups, "err": err})
    if not on_card:
        print("no card: skipping the timed runs")
        return results
    rng = np.random.default_rng(0)
    for shape, factors in TIMED_CASES:
        c = shape[-1]
        x = space_to_depth_yx(torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                              .to(device, torch.bfloat16), factors).contiguous()
        w = torch.from_numpy((rng.standard_normal((c, c, 3, 3, 3)) * (2 / (27 * c)) ** 0.5)
                             .astype(np.float32)).to(device)
        pw = cv.prepare_conv3d_weight(w)
        ms = _util.median_ms(lambda: packed_conv3d(x, pw, factors), args.iters)
        print(f"packed conv {c}->{c} at {shape} packed {factors} -> {tuple(x.shape)}: "
              f"{ms:.3f} ms", flush=True)
        results["timed"].append({"shape": shape, "factors": factors, "ms": ms})
    return results


if __name__ == "__main__":
    main()
