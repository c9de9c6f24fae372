"""What paces the probes' kernels on the H100, and how they compare with
another checkout's build of the same C entries.

Its readings, each on the card, at the shapes the probes time:

- the im2col, tap3 and Winograd arms at (2, 96, 96, 96, 120) -> 120
  (csrc/conv_arms.cu): each TMA + wgmma body as it is, its copies-only form
  (the consumers hand every stage back without a product), its
  products-only form (nothing loaded), the Winograd body's transform-only
  form (the input boxes loaded and transformed, no weight and no product),
  and the first body (mma.sync on rows staged by cp.async) through
  `mt_conv_<arm>_form`;
- centern (csrc/probe_kernels.cu) at every (tile, ndots) configuration of
  the cost and grid probes: as it is, copies only, products only;
- the zero fill (csrc/probe_kernels.cu) at the grid probe's three tiles of
  a 96^3 x 128 bf16 volume: each form through `mt_zeros_form` (vector
  stores, bulk stores), the entry `mt_zeros` (its form by `zeros_plan`) and
  torch's `zero_`, each as a single call, queued (calls back to back
  between one event pair) and as the host's us a call, with GB/s in all and
  a block;
- the packed conv (csrc/conv3d_same.cu, kernel A's ring body) at the
  flagship's stages 0 and 1, beside kernel A on the unpacked tensor (its
  output must be A's bit for bit where A's plan has one split);
- with `--against DIR`, that checkout's conv_arms.cu, probe_kernels.cu and
  conv3d_same.cu (with the sources it links: fused_norm.cu, and
  conv3d_wgmma.cu where it has one) built into a library of its own under
  `_build/probe_bodies/`, its `mt_conv_im2col`, `mt_conv_tap3`,
  `mt_conv_wino`, `mt_centern`, `mt_zeros` and `mt_packed_conv3d` timed in
  turns with this build's (against, this, this, against; the lesser of
  each pair) and checked against the same plain version.

Each output is checked against its plain version (the fp32 direct conv,
`centern_ref`, `packed_conv3d_ref`, every value 0) within the probes'
bound; each row gives the bound, centern's ndots ceiling, the Winograd
arm's own products floor and the bytes each body stages into shared memory
(`im2col_plan`, `tap3_plan`, `wino_plan`, `centern_plan`).

    python -m multitalent_tpu_torch.probes.probe_bodies [--against DIR] [--out JSON]
        [--only zeros packed]

`--device cpu` has nothing to time and only says so.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from math import prod
from pathlib import Path

import torch

from multitalent_tpu_torch import _build
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.probes import _util
from multitalent_tpu_torch.probes import conv_cost_isolate as cc
from multitalent_tpu_torch.probes import conv_impl_arms as ca
from multitalent_tpu_torch.probes import grid_overhead_probe as gp
from multitalent_tpu_torch.probes import sparse_conv_arm as sc
from multitalent_tpu_torch.probes.conv_a_forms import host_us
from multitalent_tpu_torch.probes.wgrad_forms import queued_ms

PEAK_BF16_FLOPS = ca.PEAK_BF16_FLOPS
PEAK_HBM_BYTES = 3.35e12
MODES = ("whole", "copies", "products", "transform")
ARMS = ("im2col", "tap3", "wino")
PLANS = {"im2col": ca.im2col_plan, "tap3": ca.tap3_plan, "wino": ca.wino_plan}
# (tile, ndots) of conv_cost_isolate's center27 / center12 and the grid probe
CENTERN_CONFIGS = tuple(dict.fromkeys(((cc.TILE, 27), (cc.TILE, 12), *gp.CONV_CONFIGS)))
AGAINST_SOURCES = ("conv_arms.cu", "probe_kernels.cu", "conv3d_same.cu", "fused_norm.cu",
                   "conv3d_wgmma.cu")
AGAINST_ENTRIES = {name: _build._SIGNATURES[name] for name in (
    "mt_conv_im2col", "mt_conv_tap3", "mt_conv_wino", "mt_centern", "mt_zeros",
    "mt_packed_conv3d")}
PARTS = ("arms", "centern", "zeros", "packed")


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    """The least time of work of nbytes and bf16 tensor-core flops, and what
    sets it."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def build_against(tree: Path) -> ctypes.CDLL:
    """The other checkout's probe kernels (AGAINST_SOURCES that it has, and
    the headers beside them), one nvcc a source, linked into a library of
    their own."""
    csrc = Path(tree) / "multitalent_tpu_torch" / "csrc"
    sources = [src for src in AGAINST_SOURCES if (csrc / src).is_file()]
    texts = [p.read_bytes() for p in sorted(csrc.glob("*.cuh"))]
    texts += [(csrc / src).read_bytes() for src in sources]
    key = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + b"".join(texts)).hexdigest()[:16]
    out = _build.BUILD_DIR / "probe_bodies" / key
    lib = out / "libprobe_bodies_against.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        nvcc = [_build.find_nvcc(), *_build.NVCC_FLAGS]
        objs = [str(out / src.replace(".cu", ".o")) for src in sources]
        procs = [subprocess.Popen([*nvcc, "-I", str(csrc), "-c", "-o", obj, str(csrc / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for obj, src in zip(objs, sources)]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed for {tree}:\n" + "\n".join(logs))
        link = subprocess.run([*nvcc, "-shared", "-o", str(lib), *objs], capture_output=True,
                              text=True)
        if link.returncode:
            raise RuntimeError(f"link failed for {tree}: {link.stdout}{link.stderr}")
    loaded = ctypes.CDLL(str(lib))
    for name, (argtypes, restype) in AGAINST_ENTRIES.items():
        fn = getattr(loaded, name)
        fn.argtypes, fn.restype = argtypes, restype
    return loaded


def _call(lib: ctypes.CDLL, name: str, out: torch.Tensor, *args):
    """A launcher of C entry `name` of `lib` on the current stream that
    returns `out`."""
    def call():
        code = getattr(lib, name)(*args, torch.cuda.current_stream(out.device).cuda_stream)
        if code:
            raise RuntimeError(f"{name} failed: CUDA error {code}")
        return out
    return call


def _held(name: str, got: torch.Tensor, ref: torch.Tensor) -> float:
    err = (got.float() - ref).abs().max().item()
    bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
    if not err <= bound:
        raise AssertionError(f"{name}: max|d| {err:.3e} > {bound:.3e}")
    return err


def _timed(row: dict, calls: dict, iters: int) -> None:
    """Each call's median in turns (forward, then backward; the lesser of
    each pair) into row[name + '_ms']."""
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            ms = _util.median_ms(calls[name], iters)
            row[f"{name}_ms"] = min(ms, row.get(f"{name}_ms", ms))


def arm(name: str, device: torch.device, gen: torch.Generator, against, iters: int) -> dict:
    """Conv arm `name` at the timed shape: its TMA + wgmma body whole and by
    form, its first body, and the other build's entry, each checked."""
    lib = _build.library()
    n, z, y, xd, c = ca.TIMED_SHAPE
    x = torch.randn(ca.TIMED_SHAPE, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, 3, generator=gen, device=device) * (2.0 / (27 * c)) ** 0.5
    pw = ca.prepare_arm_weight(w, name)
    ref = cv.conv3d_same_ref(x.float(), w)
    sizes = (n, z, y, xd, c, pw.cout, pw.coutp, *((pw.bn,) if name == "tap3" else ()))
    outs = {}

    def form(body: int, mode: int):
        out = outs.setdefault((body, mode), torch.full((n, z, y, xd, pw.cout), float("nan"),
                                                       dtype=torch.bfloat16, device=device))
        return _call(lib, f"mt_conv_{name}_form", out, x.data_ptr(), pw.w.data_ptr(),
                     out.data_ptr(), *sizes, body, mode)

    calls = {"whole": form(1, 0), "first_body": form(2, 0)}
    if against is not None:
        out = torch.full_like(outs[(1, 0)], float("nan"))
        calls = {"against": _call(against, f"mt_conv_{name}", out, x.data_ptr(),
                                  pw.w.data_ptr(), out.data_ptr(), *sizes), **calls}
    row = {"kernel": f"conv3d_{name}", "at": f"{c}->{c} at {z}x{y}x{xd} N={n}"}
    for key, call in calls.items():
        row[f"{key}_err"] = _held(f"{name} {key}", call(), ref)
    del ref
    _timed(row, calls, iters)
    for mode in range(1, 4 if name == "wino" else 3):
        row[f"{MODES[mode]}_ms"] = _util.median_ms(form(1, mode), iters)
    vox = n * z * y * xd
    row["bound_ms"], row["bound_by"] = bound_ms(vox * 2 * c * 2 + 27 * c * c * 2,
                                                2 * 27 * c * c * vox)
    for key, body in (("l2_to_shared_bytes", "tma"), ("first_body_l2_to_shared_bytes",
                                                      "mma_sync")):
        plan = PLANS[name](n, z, y, xd, c, pw.cout, body)
        row[key] = plan["l2_to_shared_bytes"]
    if name == "wino":
        row["products_floor_ms"] = ca.products_floor_ms(plan["products_flops"])
    return row


def centern(device: torch.device, gen: torch.Generator, against, iters: int) -> list[dict]:
    lib = _build.library()
    n, sp, c = 1, (cc.SIZE,) * 3, cc.C
    x = torch.randn(n, *sp, c, generator=gen, device=device).to(torch.bfloat16)
    w = torch.randn(c, c, 3, 3, 3, generator=gen, device=device) * 0.05
    wc = cc.prepare_center_weight(w)
    w_bf = w.to(torch.bfloat16).float()
    vox = n * prod(sp)
    rows = []
    for tile, ndots in CENTERN_CONFIGS:
        ref = cc.centern_ref(x.float(), w_bf, ndots)
        args = (n, *sp, c, c, ndots, *tile)

        def form(mode: int, lib=lib, args=args):
            out = torch.full_like(x, float("nan"))
            return _call(lib, "mt_centern_form", out, x.data_ptr(), wc.data_ptr(),
                         out.data_ptr(), *args, mode)

        calls = {"whole": form(0)}
        if against is not None:
            out = torch.full_like(x, float("nan"))
            calls = {"against": _call(against, "mt_centern", out, x.data_ptr(), wc.data_ptr(),
                                      out.data_ptr(), *args), **calls}
        row = {"kernel": "centern", "at": f"{ndots} dots at {'x'.join(map(str, sp))}x{c} "
                                          f"tile {tile}", "ndots": ndots, "tile": list(tile)}
        for name, call in calls.items():
            row[f"{name}_err"] = _held(f"centern {row['at']} {name}", call(), ref)
        del ref
        _timed(row, calls, iters)
        for mode in (1, 2):
            row[f"{MODES[mode]}_ms"] = _util.median_ms(form(mode), iters)
        nbytes = vox * 2 * c * 2 + 27 * c * c * 2
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2 * c * c * vox)
        row["ndots_ceiling_ms"] = bound_ms(nbytes, 2 * ndots * c * c * vox)[0]
        row["share_of_ceiling"] = row["ndots_ceiling_ms"] / row["whole_ms"]
        plan = cc.centern_plan(n, sp, c, ndots, tile)
        # the first body staged a tile's voxels 128 at a time, each time
        # with the ndots weight matrices
        row.update(sub_tile=list(plan["sub_tile"]), grid=plan["grid"],
                   l2_to_shared_bytes=plan["l2_to_shared_bytes"],
                   first_body_l2_to_shared_bytes=-(-prod(tile) // 128) * plan["tiles"]
                   * (128 * c + ndots * c * 128) * 2)
        rows.append(row)
    return rows


def zeros(device: torch.device, against, iters: int) -> list[dict]:
    """The zero fill at each of the grid probe's tiles: its two forms, the
    entry, the other build's entry and torch's zero_, each into one buffer
    checked to hold only zeros, timed in turns."""
    lib = _build.library()
    shape = (cc.SIZE,) * 3 + (cc.C,)
    buf = torch.empty(shape, dtype=torch.bfloat16, device=device)
    nbytes = buf.numel() * 2
    rows = []
    for tile in gp.ZERO_TILES:
        plan = gp.zeros_plan(shape, tile)
        calls = {form: _call(lib, "mt_zeros_form", buf, buf.data_ptr(), *shape, *tile, i + 1)
                 for i, form in enumerate(gp.ZERO_FORMS)}
        calls["entry"] = _call(lib, "mt_zeros", buf, buf.data_ptr(), *shape, *tile)
        if against is not None:
            calls = {"against": _call(against, "mt_zeros", buf, buf.data_ptr(), *shape, *tile),
                     **calls}
        calls["zero_"] = buf.zero_
        for name, call in calls.items():
            buf.fill_(float("nan"))
            bad = (call() != 0).sum().item()
            if bad:
                raise AssertionError(f"zeros tile {tile} ({name}): {bad} values are not 0")
        row = {"kernel": "zeros", "at": f"{'x'.join(map(str, shape[:3]))}x{shape[3]} bf16 "
                                        f"tile {tile}", **plan}
        for order in (list(calls), list(calls)[::-1]):
            for name in order:
                for key, v in ((f"{name}_ms", _util.median_ms(calls[name], iters)),
                               (f"{name}_queued_ms", queued_ms(calls[name])),
                               (f"{name}_host_us", host_us(calls[name]))):
                    row[key] = min(v, row.get(key, v))
        for name in calls:  # GB/s queued, and for the kernels a block
            row[f"{name}_gbps"] = nbytes / row[f"{name}_queued_ms"] / 1e6
            if name != "zero_":
                row[f"{name}_gbps_per_block"] = row[f"{name}_gbps"] / plan["blocks"]
        row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 0)
        rows.append(row)
    return rows


def packed(device: torch.device, gen: torch.Generator, against, iters: int) -> list[dict]:
    """The packed conv at the sparse-conv probe's timed shapes, beside kernel
    A on the unpacked tensor and the other build's entry: each checked
    against packed_conv3d_ref, this build's bit-equal to A's where A's plan
    has one split."""
    lib = _build.library()
    rows = []
    for shape, factors in sc.TIMED_CASES:
        n, z, y, xd, c = shape
        xu = torch.randn(shape, generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn(c, c, 3, 3, 3, generator=gen, device=device) * (2.0 / (27 * c)) ** 0.5
        pw = cv.prepare_conv3d_weight(w)
        xp = sc.space_to_depth_yx(xu, factors).contiguous()
        ref = sc.packed_conv3d_ref(xp.float(), w, factors)
        fy, fx = factors
        calls = {"whole": lambda: sc.packed_conv3d(xp, pw, factors)}
        if against is not None:
            out = torch.empty_like(xp)
            calls = {"against": _call(against, "mt_packed_conv3d", out, xp.data_ptr(),
                                      pw.w.data_ptr(), out.data_ptr(), None, 0, n, z, y, xd, c,
                                      pw.cout, pw.coutp, pw.bn, fy, fx), **calls}
        calls["a_unpacked"] = lambda: cv.conv3d_same(xu, pw)
        row = {"kernel": "packed_conv3d", "at": f"{c}->{c} at {z}x{y}x{xd} N={n} packed "
                                                f"{factors}"}
        for name, call in calls.items():
            got = call()
            if name == "a_unpacked":
                got = sc.space_to_depth_yx(got, factors)
            row[f"{name}_err"] = _held(f"packed conv {row['at']} {name}", got, ref)
        row["bit_equal_to_a"] = bool(torch.equal(calls["whole"](), sc.space_to_depth_yx(
            calls["a_unpacked"](), factors)))
        a_plan = cv.conv3d_same_plan(n, z, y, xd, c, c, "a")
        if a_plan["splits"] == 1 and not row["bit_equal_to_a"]:
            raise AssertionError(f"packed conv {row['at']}: not kernel A's output")
        del ref
        _timed(row, calls, iters)
        vox = n * z * y * xd
        row["bound_ms"], row["bound_by"] = bound_ms(vox * 2 * c * 2 + 27 * c * c * 2,
                                                    2 * 27 * c * c * vox)
        row["plan"] = cv.conv3d_same_plan(n, z, y, xd, c, c, "packed")
        rows.append(row)
    return rows


def _line(row: dict) -> str:
    if row["kernel"] == "zeros":
        times = ", ".join(f"{k[:-3]} {v:.4f}" for k, v in row.items() if k.endswith("_ms")
                          and k != "bound_ms")
        rates = ", ".join(f"{k[:-len('_gbps_per_block')]} {v:.2f}" for k, v in row.items()
                          if k.endswith("_gbps_per_block"))
        hosts = ", ".join(f"{k[:-8]} {v:.1f}" for k, v in row.items() if k.endswith("_host_us"))
        return (f"zeros {row['at']}: form {row['form']}, {row['blocks']} blocks x {row['runs']} "
                f"runs of {row['run_bytes']} B; {times} ms; GB/s a block {rates}; host us a "
                f"call {hosts}; bound {row['bound_ms']:.3f} ms ({row['bound_by']})")
    if row["kernel"] == "packed_conv3d":
        times = ", ".join(f"{k[:-3]} {v:.3f}" for k, v in row.items()
                          if k.endswith("_ms") and k != "bound_ms")
        plan = {k: row["plan"][k] for k in ("g", "resident", "ksplit", "stages", "splits",
                                            "grid_x", "smem_bytes")}
        return (f"packed conv {row['at']}: {times} ms; bound {row['bound_ms']:.3f} ms "
                f"({row['bound_by']}); bit-equal to A {row['bit_equal_to_a']}; ring plan {plan}")
    floors = ("bound_ms", "ndots_ceiling_ms", "products_floor_ms")
    times = ", ".join(f"{k[:-3]} {v:.3f}" for k, v in row.items()
                      if k.endswith("_ms") and k not in floors)
    extra = (f", ndots ceiling {row['ndots_ceiling_ms']:.3f} ms "
             f"({row['share_of_ceiling']:.0%} of it), sub-tile {row['sub_tile']}, "
             f"grid {row['grid']}" if "ndots_ceiling_ms" in row else "")
    if "products_floor_ms" in row:
        extra += f", its own products floor {row['products_floor_ms']:.3f} ms"
    return (f"{row['kernel']} {row['at']}: {times} ms; bound {row['bound_ms']:.3f} ms "
            f"({row['bound_by']}){extra}; staged {row['l2_to_shared_bytes'] / 1e9:.2f} GB "
            f"(first body {row['first_body_l2_to_shared_bytes'] / 1e9:.2f} GB)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m multitalent_tpu_torch.probes.probe_bodies",
                                 description="the conv arms' and centern's bodies: whole, "
                                             "copies only, products only, beside another build")
    ap.add_argument("--against", help="another checkout, its probe kernels built as they are")
    ap.add_argument("--iters", type=int, default=10, help="timed calls a median")
    ap.add_argument("--out", help="write the rows as JSON here")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--only", nargs="+", choices=PARTS, default=PARTS,
                    help="time these kernels alone: the conv arms, centern, the zero fill, "
                         "the packed conv")
    args = ap.parse_args(argv)
    device = _util.resolve_device(args.device)
    if device.type != "cuda":
        print("no card: skipping the bodies' readings (they time CUDA kernels only)")
        return {}
    name = torch.cuda.get_device_name(device)
    print(f"# device={name}", flush=True)
    against = build_against(Path(args.against)) if args.against else None
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"device": name, "against": args.against, "rows": []}
    parts = {"arms": lambda: [arm(a, device, gen, against, args.iters) for a in ARMS],
             "centern": lambda: centern(device, gen, against, args.iters),
             "zeros": lambda: zeros(device, against, args.iters),
             "packed": lambda: packed(device, gen, against, args.iters)}
    for row in (r for part in args.only for r in parts[part]()):
        print(_line(row), flush=True)
        result["rows"].append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
