"""What paces the wgmma body of kernels A and B (csrc/conv3d_wgmma.cu) on
the H100, and whether its descriptors address what it stages.

Its readings, each on the card:

- the one-wgmma probe: one m64 x n x k16 product (n 64 and 128) of a
  TMA-staged halo box at a tap's descriptor offset, at several taps, z
  planes and tile corners (the SAME halo and the far edges included),
  against the same product in torch;
- the body's forms at the flagship's shapes that it runs (A and B at N=1 and
  2, the dual convs' dx): as it is, copies only (the consumers hand every
  stage back without a product) and products only (the producer signals
  every stage without loading it), each a median of single calls. Where
  copies and products overlap, the whole takes less than their sum;
- the host's time a call: the C entry (two or three tensor maps encoded,
  the plan, the launch), the plan and workspace query, and kernel A's
  wrapper, each over calls issued back to back;
- with `--variants`, the body with its pipeline's constants patched as text
  (VARIANTS: ring depths, taps a weight stage), each built by nvcc with the
  package's other conv sources into a library of its own under
  `_build/wgmma_variants/`, checked against the body as it is and timed
  beside it at the same shapes, in turns.

    python -m multitalent_tpu_torch.probes.wgmma_forms [--variants] [--out JSON]

`--device cpu` runs the probe's product through ops/wgmma_layout.py's
emulation of the body's staging and descriptors instead, against torch.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time
from pathlib import Path

import torch
import torch.nn.functional as F

from multitalent_tpu_torch import _build
from multitalent_tpu_torch.probes import _util

# (N, spatial, input channels, Cout) of the flagship's calls on the body:
# A and B at stages 2-4 at N=1 and the training batch, the dual convs' dx
SHAPES = ([(n, sp, (c,), c) for n in (1, 2) for c, sp in ((120, (24, 48, 48)),
                                                          (240, (12, 24, 24)))]
          + [(n, sp, (c, c), c) for n in (1, 2) for c, sp in ((120, (24, 48, 48)),
                                                              (240, (12, 24, 24)),
                                                              (320, (6, 12, 12)))]
          + [(2, sp, (c,), 2 * c) for c, sp in ((120, (24, 48, 48)), (240, (12, 24, 24)),
                                                (320, (6, 12, 12)))])
MODES = ("whole", "copies", "products")
# the probe: a (1, 6, 12, 13, 16) volume; (tap, plane, tile corner z, y, x)
PROBE_VOLUME = (6, 12, 13, 16)
PROBE_CASES = ((13, 0, (0, 0, 0)), (0, 1, (0, 0, 0)), (26, 1, (2, 8, 8)), (5, 2, (2, 0, 8)))
PROBE_BOUND = 1e-3  # fp32 sums of 16 bf16 products in another order
HOST_CALLS = 200
# the pipeline's constants of csrc/conv3d_wgmma.cu a variant patches
# (5 weight stages of BN 128 fit beside 2 boxes only)
VARIANTS = {"W_STAGES=3": {"W_STAGES": 3}, "BOX_STAGES=2": {"BOX_STAGES": 2},
            "W_STAGES=5,BOX_STAGES=2": {"W_STAGES": 5, "BOX_STAGES": 2},
            "W_TAPS=3": {"W_TAPS": 3, "W_STAGES": 12}}


def probe_reference(x: torch.Tensor, wtap: torch.Tensor, tap: int, plane: int,
                    corner: tuple) -> torch.Tensor:
    """The probe's product in torch: rows m = y * 8 + x of z plane `plane` of
    the 4x8x8 tile at `corner` of x (1, Z, Y, X, 16), shifted by tap (dz, dy,
    dx) into the zero-padded volume, times wtap (16, n)."""
    xp = F.pad(x[0].float(), (0, 0, 1, 1, 1, 1, 1, 1))
    xp = F.pad(xp, (0, 0, 0, 8, 0, 8, 0, 4))  # tiles past the volume read 0
    dz, dy, dx = tap // 9, tap // 3 % 3, tap % 3
    z0, y0, x0 = corner
    rows = xp[z0 + plane + dz, y0 + dy:y0 + dy + 8, x0 + dx:x0 + dx + 8]
    return rows.reshape(64, -1) @ wtap.float()


def probe(device: torch.device, gen: torch.Generator) -> list[dict]:
    """The one-wgmma probe at n 64 and 128 and each of PROBE_CASES (on the
    CPU: the emulation of the same product); raises past PROBE_BOUND."""
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import wgmma_layout as wl
    z, y, xd, c = PROBE_VOLUME
    rows = []
    for n in (64, 128):
        for tap, plane, corner in PROBE_CASES:
            x = torch.randn(1, z, y, xd, c, generator=gen, device=device).to(torch.bfloat16)
            w = torch.randn(128, c, 3, 3, 3, generator=gen, device=device) * 0.2
            pw = cv.prepare_conv3d_weight(w, dtype=torch.bfloat16)
            ref = probe_reference(x, pw.w[0, tap, :, :n], tap, plane, corner)
            if device.type == "cpu":
                box = wl.stage_chunk(x.float(), 0, 0, *corner)
                stage = wl.weight_stage(cv.PreparedWeight(pw.w.float(), pw.splits, pw.cout,
                                                          pw.bn), 0, tap // 9, 0, n)
                got = (wl.read_a(box, wl.box_desc(0, plane, tap // 9, tap // 3 % 3, tap % 3))
                       @ wl.read_b(stage, wl.weight_desc(0, tap % 9), n))
            else:
                got = torch.full((64, n), float("nan"), device=device)
                _util.launch("mt_wgmma_probe", device, x.data_ptr(), pw.w.data_ptr(),
                             got.data_ptr(), z, y, xd, c, pw.coutp, n, tap, plane, *corner)
            err = (got.float() - ref).abs().max().item()
            scale = ref.abs().max().item()
            if not err <= PROBE_BOUND * max(scale, 1.0):
                raise AssertionError(f"wgmma probe n{n} tap {tap} plane {plane} {corner}: "
                                     f"max|d| {err:.3e} of {scale:.3f}")
            print(f"wgmma probe m64n{n}k16 tap {tap} plane {plane} tile corner {corner}: "
                  f"max|d| {err:.3e} (|ref| {scale:.3f})")
            rows.append({"n": n, "tap": tap, "plane": plane, "corner": list(corner),
                         "err": err, "ref_max": scale})
    return rows


def _entry(ins: list[torch.Tensor], pw, cout: int, out: torch.Tensor, mode: int):
    """A call of the body's C entry in `mode` (0 whole, 1 copies, 2 products)
    and the workspace bytes it takes."""
    lib = _build.library()
    n, z, y, xd = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins] + [0]
    nbytes = lib.mt_conv3d_workspace(n, z, y, xd, cs[0], cs[1], cout, pw.coutp, pw.bn)
    ws = torch.empty(max(nbytes, 4) // 4, dtype=torch.float32, device=out.device)

    def call():
        _util.launch("mt_conv3d_wgmma", out.device, ins[0].data_ptr(),
                     ins[1].data_ptr() if len(ins) > 1 else None, pw.w.data_ptr(), None,
                     out.data_ptr(), ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cs[1], cout,
                     pw.coutp, mode)
    return call


def forms(device: torch.device, gen: torch.Generator, shapes=SHAPES) -> list[dict]:
    """Each shape's three forms, single-call medians, with the plan."""
    from multitalent_tpu_torch.ops import conv3d as cv
    rows = []
    for n, sp, cs, cout in shapes:
        ins = [torch.randn(n, *sp, c, generator=gen, device=device).to(torch.bfloat16)
               for c in cs]
        w = torch.randn(cout, sum(cs), 3, 3, 3, generator=gen, device=device) * 0.05
        pw = cv.prepare_conv3d_weight(w, cs if len(cs) == 2 else None)
        out = torch.empty((n, *sp, cout), dtype=torch.bfloat16, device=device)
        plan = cv.conv3d_same_plan(n, *sp, cs[0] if len(cs) == 1 else cs, cout,
                                   "a" if len(cs) == 1 else "b")
        row = {"at": "{}->{} at {} N={}".format("+".join(map(str, cs)), cout,
                                                "x".join(map(str, sp)), n),
               "wgmma": plan["wgmma"], "bn": plan["wgmma_bn"], "splits": plan["wgmma_splits"],
               "blocks": plan["wgmma_blocks"]}
        for mode, name in enumerate(MODES):
            row[f"{name}_ms"] = _util.median_ms(_entry(ins, pw, cout, out, mode))
        print(f"wgmma body {row['at']} (BN {row['bn']}, K splits {row['splits']}, "
              f"{row['blocks']} blocks): whole {row['whole_ms']:.3f} ms, copies only "
              f"{row['copies_ms']:.3f}, products only {row['products_ms']:.3f}")
        rows.append(row)
        del ins, out
    torch.cuda.empty_cache()
    return rows


def host_us(device: torch.device, gen: torch.Generator) -> dict:
    """The host's us a call, over HOST_CALLS calls issued back to back, at
    the flagship's A 120 -> 120 at 24x48x48 N=1: the body's C entry, the plan
    and workspace query, and kernel A's wrapper."""
    from multitalent_tpu_torch.ops import conv3d as cv
    lib = _build.library()
    n, sp, c = 1, (24, 48, 48), 120
    x = torch.randn(n, *sp, c, generator=gen, device=device).to(torch.bfloat16)
    pw = cv.prepare_conv3d_weight(torch.randn(c, c, 3, 3, 3, generator=gen, device=device))
    out = torch.empty((n, *sp, c), dtype=torch.bfloat16, device=device)
    entry = _entry([x], pw, c, out, 0)

    def query():
        lib.mt_conv3d_workspace(n, *sp, c, 0, c, pw.coutp, pw.bn)

    result = {}
    for name, fn in (("entry", entry), ("query", query),
                     ("wrapper", lambda: cv.conv3d_same(x, pw, out=out))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        result[f"{name}_us"] = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
    print(f"host us a call at {c}->{c} {'x'.join(map(str, sp))} N={n}: the body's C entry "
          f"(tensor maps, plan, launch) {result['entry_us']:.1f}, the plan and workspace "
          f"query {result['query_us']:.1f}, kernel A's wrapper {result['wrapper_us']:.1f}")
    return result


def variant_source(text: str, consts: dict) -> str:
    """conv3d_wgmma.cu with each `constexpr int NAME = value;` of consts
    replaced; raises where the source has not exactly one such line."""
    for name, value in consts.items():
        text, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};",
                          text)
        if n != 1:
            raise ValueError(f"expected one `constexpr int {name} = ...;` in the source")
    return text


def _spawn(cmd: list[str]) -> tuple[list[str], subprocess.Popen]:
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_variants(names) -> dict[str, ctypes.CDLL]:
    """The body as it is and each of VARIANTS[names], each linked with the
    package's conv3d_same.cu and fused_norm.cu (compiled once), built in
    parallel and loaded."""
    csrc = _build.CSRC
    text = (csrc / "conv3d_wgmma.cu").read_text()
    texts = {"as is": text, **{k: variant_source(text, VARIANTS[k]) for k in names}}
    shared = [csrc / "conv3d_same.cu", csrc / "fused_norm.cu"]
    key = hashlib.sha256("".join([" ".join(_build.NVCC_FLAGS), *texts.values(),
                                  *(f.read_text() for f in [*shared, csrc / "common.cuh"])])
                         .encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "wgmma_variants" / key
    out.mkdir(parents=True, exist_ok=True)
    nvcc = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc)]
    objs = [out / f"{f.stem}.o" for f in shared]
    libs = {name: out / f"libvariant{i}.so" for i, name in enumerate(texts)}
    procs = [_spawn([*nvcc, "-c", "-o", str(o), str(f)])
             for f, o in zip(shared, objs) if not o.is_file()]
    for (name, src), lib in zip(texts.items(), libs.values()):
        if not lib.is_file():
            lib.with_suffix(".cu").write_text(src)
            procs.append(_spawn([*nvcc, "-c", "-o", str(lib.with_suffix(".o")),
                                 str(lib.with_suffix(".cu"))]))
    _build._run(procs)
    _build._run([_spawn([*nvcc, "-shared", "-o", str(lib), str(lib.with_suffix(".o")),
                         *map(str, objs)]) for lib in libs.values() if not lib.is_file()])
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for entry in ("mt_conv3d_wgmma", "mt_conv3d_workspace"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        loaded[name] = lib
    return loaded


def variants(device: torch.device, gen: torch.Generator, names=tuple(VARIANTS),
             shapes=SHAPES) -> list[dict]:
    """The body as it is and each variant at each shape: checked against the
    body as it is (the same sums, in the same order but where a stage's taps
    fall), single-call medians in turns (as is, the variants, then back),
    the lesser of the two."""
    from multitalent_tpu_torch.ops import conv3d as cv
    libs = build_variants(names)
    rows = []
    for n, sp, cs, cout in shapes:
        ins = [torch.randn(n, *sp, c, generator=gen, device=device).to(torch.bfloat16)
               for c in cs]
        w = torch.randn(cout, sum(cs), 3, 3, 3, generator=gen, device=device) * 0.05
        pw = cv.prepare_conv3d_weight(w, cs if len(cs) == 2 else None)
        c2 = [int(t.shape[-1]) for t in ins] + [0]
        outs, calls = {}, {}
        for name, lib in libs.items():
            nbytes = lib.mt_conv3d_workspace(n, *sp, c2[0], c2[1], cout, pw.coutp, pw.bn)
            ws = torch.empty(max(nbytes, 4) // 4, dtype=torch.float32, device=device)
            out = torch.full((n, *sp, cout), float("nan"), dtype=torch.bfloat16, device=device)

            def call(lib=lib, ws=ws, out=out, nbytes=nbytes):
                code = lib.mt_conv3d_wgmma(
                    ins[0].data_ptr(), ins[1].data_ptr() if len(ins) > 1 else None,
                    pw.w.data_ptr(), None, out.data_ptr(), ws.data_ptr(), nbytes, n, *sp,
                    c2[0], c2[1], cout, pw.coutp, 0, torch.cuda.current_stream(device).cuda_stream)
                if code:
                    raise RuntimeError(f"variant failed: CUDA error {code}")
            call()
            outs[name], calls[name] = out, call
        ref = outs["as is"].float()
        for name, out in outs.items():
            err = (out.float() - ref).abs().max().item()
            if not err <= 1e-2 * (1 + ref.abs().max().item()):
                raise AssertionError(f"variant {name} at {sp}: max|d| {err:.3e}")
        times = {name: [] for name in libs}
        for order in (list(libs), list(libs)[::-1]):
            for name in order:
                times[name].append(_util.median_ms(calls[name]))
        row = {"at": "{}->{} at {} N={}".format("+".join(map(str, cs)), cout,
                                                "x".join(map(str, sp)), n),
               **{f"{name}_ms": min(t) for name, t in times.items()}}
        print(f"wgmma variants {row['at']}: " + ", ".join(
            f"{name} {row[f'{name}_ms']:.3f}" for name in libs) + " ms")
        rows.append(row)
        del ins, outs, calls
    torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the readings as JSON to this file")
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the pipeline's variants")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _util.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    result = {"probe": probe(device, gen)}
    if device.type == "cpu":
        text = (_build.CSRC / "conv3d_wgmma.cu").read_text()
        for consts in VARIANTS.values():
            variant_source(text, consts)
        print("plain run on the CPU: the probe's product through the emulated staging and "
              "descriptors, and the source takes every variant's patch (the forms, "
              "variants and host times are the card's only)")
        return result
    result.update(device=torch.cuda.get_device_name(0), forms=forms(device, gen),
                  host=host_us(device, gen))
    if args.variants:
        result["variants"] = variants(device, gen)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
