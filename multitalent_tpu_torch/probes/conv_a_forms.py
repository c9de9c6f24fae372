"""Kernels A (the SAME 3x3x3 conv and every dx), B (the conv over a concat)
and D (the fused conv -> norm conv, and its dual form) in the forms their
plan chooses between, timed side by side on the H100.

Builds forms of `csrc/conv3d_same.cu` of this package (or of another
checkout's, `--tree`): the source as it is, and `ring_everywhere`, where
every shape runs the ring body (as it is, A, B and D's dual form at
16-byte rows with streamed weights and a whole K loop a block run the
wgmma body of conv3d_wgmma.cu).
`--against DIR` adds another checkout's source as it is (e.g. the parent
commit's). D's dual form is also timed beside B's launch alone and B's
launch followed by kernel E's stats pass on its output (the two-launch way
to the same out and stats), its output bit-equal to B's where both run the
same body; `--only d_dual` times D's dual form alone. Each form is the
source patched as text and built by nvcc, with
fused_norm.cu (and conv3d_wgmma.cu where the checkout has it), into a
library of its own under `_build/conv_a_forms/`; every
form is checked against the plain version (D's stats too), then timed at
the kernels' phase-2 shapes of chip_smoke.py (A: the forward's six at N=1
and at the training batch, and the dual convs' dx; B: the forward's five at
N=1; D: A's six and, dual, B's five, at N=1 and at the training batch), each
as a call queued behind others (the card's time, the host's cost hidden) and
as single calls (CUDA events around one call, as chip_smoke's phase 2), in
turns (forms in order, then in reverse; the lesser of the two), with the
host's time a call: the C entry's (its plan and launch) and its workspace
query's, each over calls issued back to back. Kernel A's
output must be bit-equal to the `--against` checkout's at every A shape.
It also prints ptxas's registers and spills for the conv kernels of each
source (and kernel C's, which shares A's loader).

    python -m multitalent_tpu_torch.probes.conv_a_forms [--tree DIR] [--against DIR]
        [--only d_dual] [--out JSON]

`--device cpu` only checks that the source takes the patch: the forms exist
only as CUDA builds.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time
from math import prod
from pathlib import Path

import torch

from multitalent_tpu_torch import _build
from multitalent_tpu_torch.probes import _util
from multitalent_tpu_torch.probes.wgrad_forms import queued_ms

RING = "p.ring = c.resident || !rows16 || form.affine || (splits > 1 && form.nin == 1);"
FORMS = ("whole", "ring_everywhere")
# (N, spatial, Cin, Cout) of kernel A's launches in the flagship's forward
# (N=1) and training step (N=2: forwards, and the dual convs' dx)
A_SHAPES = [(1, (96, 192, 192), 30, 30), (1, (48, 96, 96), 60, 60), (1, (24, 48, 48), 120, 120),
            (1, (12, 24, 24), 240, 240), (1, (6, 12, 12), 320, 320), (1, (6, 6, 6), 320, 320)]
SHAPES = (A_SHAPES + [(2, sp, ci, co) for _, sp, ci, co in A_SHAPES]
          + [(2, sp, c, 2 * c) for _, sp, c, _ in A_SHAPES[:5]])
# (kernel, N, spatial, input channels, Cout) of B's and D's phase-2 shapes:
# B at the forward's five (N=1); D at A's six and its dual form at B's five,
# at N=1 and the training batch
BD_SHAPES = ([("b", 1, sp, (c, c), c) for _, sp, c, _ in A_SHAPES[:5]]
             + [("d", n, sp, (c,), c) for n in (1, 2) for _, sp, c, _ in A_SHAPES]
             + [("d_dual", n, sp, (c, c), c) for n in (1, 2) for _, sp, c, _ in A_SHAPES[:5]])
RTOL, ATOL = 1e-2, 1e-2  # chip_smoke's phase-2 bound
STATS_RTOL = 1e-3        # chip_smoke's bound on D's stats
HOST_CALLS = 50          # calls a host time is taken over
ENTRIES = ("mt_conv3d_same", "mt_conv3d_workspace", "mt_conv3d_same_dual",
           "mt_conv3d_same_affine", "mt_conv3d_same_dual_stats", "mt_conv3d_stats_workspace")


def form_source(text: str, form: str) -> str:
    """The source as `form`; raises where the source has not the one piece
    of text the form's patch replaces."""
    patches = {"whole": None, "ring_everywhere": (RING, "p.ring = true;")}
    if form not in patches:
        raise ValueError(f"form {form!r}: expected one of {tuple(patches)}")
    if patches[form] is None:
        return text
    old, new = patches[form]
    if text.count(old) != 1:
        raise ValueError(f"form {form!r}: expected one `{old}` in the source")
    return text.replace(old, new)


def _nvcc(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def build_forms(sources: dict[str, tuple[Path, str]]) -> tuple[dict, dict]:
    """{name: (csrc, form)} built in parallel (once per source text) and
    loaded; with each source's ptxas lines for kernel A's instantiations."""
    out_dir, procs, libs, ptxas = _build.BUILD_DIR / "conv_a_forms", [], {}, {}
    for name, (csrc, form) in sources.items():
        text = form_source((csrc / "conv3d_same.cu").read_text(), form)
        norm = (csrc / "fused_norm.cu").read_text()
        wgmma = csrc / "conv3d_wgmma.cu"  # the body A and B reach at 16-byte rows
        extra = [wgmma] if wgmma.is_file() else []
        key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text + norm
                              + "".join(f.read_text() for f in extra)
                              + (csrc / "common.cuh").read_text()).encode()).hexdigest()[:16]
        out = out_dir / key
        out.mkdir(parents=True, exist_ok=True)
        libs[name] = out / "libconv_a.so"
        ptxas[name] = out / "ptxas.txt"
        if libs[name].is_file():
            continue
        (out / "conv3d_same.cu").write_text(text)
        (out / "fused_norm.cu").write_text(norm)
        objs = [str(out / "conv3d_same.o"), str(out / "fused_norm.o")]
        objs += [str(out / f"{f.stem}.o") for f in extra]
        procs.append((name, out, objs, [
            _nvcc(["-I", str(csrc), "-Xptxas", "-v", "-c", "-o", objs[0],
                   str(out / "conv3d_same.cu")]),
            _nvcc(["-I", str(csrc), "-c", "-o", objs[1], str(out / "fused_norm.cu")]),
            *(_nvcc(["-I", str(csrc), "-c", "-o", obj, str(f)])
              for f, obj in zip(extra, objs[2:]))]))
    for name, out, objs, ps in procs:
        logs = [p.communicate()[0] for p in ps]
        if any(p.returncode for p in ps):
            raise RuntimeError(f"nvcc failed for {name}:\n" + "\n".join(logs))
        ptxas[name].write_text(logs[0])
        link = _nvcc(["-shared", "-o", str(libs[name]), *objs])
        if link.wait():
            raise RuntimeError(f"link failed for {name}: {link.communicate()[0]}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES:
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry]
        loaded[name] = lib
    return loaded, {name: ptxas_lines(p.read_text()) for name, p in ptxas.items()}


def ptxas_lines(log: str) -> list[str]:
    """'kernel<template arguments>: registers, spills' for each conv kernel
    ptxas compiled (`-Xptxas -v`)."""
    lines, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?"
                      r"(conv3d_a_kernel|conv3d_same_kernel|conv3d_wgrad_kernel)"
                      r"(I\w+?)EEv", line)
        if m:
            args = ", ".join(re.findall(r"L[ib](\d+)E", m.group(2)))
            entry = f"{m.group(1)}<{args}>"
        elif entry and "spill" in line:
            spill = line.split(",", 1)[1].strip()
        elif entry and "registers" in line:
            lines.append(f"{entry}: {re.search(r'Used \d+ registers', line).group(0)}, {spill}")
            entry = None
    return lines


def wgrad_ptxas(csrc: Path) -> list[str]:
    """ptxas's lines for kernel C's instantiations of csrc/conv3d_wgrad.cu,
    which shares kernel A's loader."""
    log = _nvcc(["-I", str(csrc), "-Xptxas", "-v", "-c", "-o", "/dev/null",
                 str(csrc / "conv3d_wgrad.cu")]).communicate()[0]
    return ptxas_lines(log)


def _launcher(lib: ctypes.CDLL, x: torch.Tensor, pw, bias: torch.Tensor, out: torch.Tensor):
    """A call of `lib`'s kernel A on x into out, with the workspace it asks
    for."""
    n, z, y, xd, cin = (int(s) for s in x.shape)

    def workspace() -> int:
        return lib.mt_conv3d_workspace(n, z, y, xd, cin, 0, pw.cout, pw.coutp, pw.bn)
    nbytes = workspace()
    ws = torch.empty(max(nbytes, 4) // 4, dtype=torch.float32, device=x.device)

    def call() -> torch.Tensor:
        code = lib.mt_conv3d_same(x.data_ptr(), pw.w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                                  ws.data_ptr(), nbytes, n, z, y, xd, cin, pw.cout, pw.coutp,
                                  pw.bn, torch.cuda.current_stream(x.device).cuda_stream)
        if code:
            raise RuntimeError(f"kernel A failed: CUDA error {code}")
        return out
    call.workspace = workspace
    return call


def _bd_launcher(lib: ctypes.CDLL, kernel: str, ins: list, pw, bias: torch.Tensor, affine,
                 out: torch.Tensor, stats: torch.Tensor):
    """A call of `lib`'s kernel B ("b"), D ("d", affine = (scale, shift)) or
    D's dual form ("d_dual") on ins into out (and stats), with the workspace
    it asks for."""
    n, z, y, xd = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins]
    ca, cb = cs[0], sum(cs[1:])
    size = lib.mt_conv3d_workspace if kernel == "b" else lib.mt_conv3d_stats_workspace

    def workspace() -> int:
        return size(n, z, y, xd, ca, cb, pw.cout, pw.coutp, pw.bn)
    nbytes = workspace()
    ws = torch.empty(max(nbytes, 4) // 4, dtype=torch.float32, device=out.device)
    ptrs = [t.data_ptr() for t in ins]
    sizes = (n, z, y, xd, *cs, pw.cout, pw.coutp, pw.bn)

    def call():
        stream = torch.cuda.current_stream(out.device).cuda_stream
        if kernel == "b":
            code = lib.mt_conv3d_same_dual(*ptrs, pw.w.data_ptr(), bias.data_ptr(),
                                           out.data_ptr(), ws.data_ptr(), nbytes, *sizes, stream)
        elif kernel == "d":
            code = lib.mt_conv3d_same_affine(
                *ptrs, pw.w.data_ptr(), bias.data_ptr(), affine[0].data_ptr(),
                affine[1].data_ptr(), 1e-2, out.data_ptr(), stats.data_ptr(), ws.data_ptr(),
                nbytes, *sizes, stream)
        else:
            code = lib.mt_conv3d_same_dual_stats(
                *ptrs, pw.w.data_ptr(), bias.data_ptr(), out.data_ptr(), stats.data_ptr(),
                ws.data_ptr(), nbytes, *sizes, stream)
        if code:
            raise RuntimeError(f"kernel {kernel} failed: CUDA error {code}")
        return out
    call.workspace = workspace
    return call


def d_dual_bound(cs, cout: int, spatial, n: int) -> dict:
    """D's dual form's least time on an H100 (chip_smoke.py's _affine_bound
    without the prologue): the conv's bf16 FLOPs at 989 TFLOP/s and its
    stats' 3 fp32 operations an output value at 67 TFLOP/s, or its bytes
    (bf16 inputs, weight and output once, the fp32 stats) at 3.35 TB/s."""
    vox, cin = n * prod(spatial), sum(cs)
    t_ops = (2 * 27 * cin * cout * vox / 989e12 + 3 * vox * cout / 67e12) * 1e3
    t_bytes = (vox * (cin + cout) * 2 + 27 * cin * cout * 2 + n * cout * 8) / 3.35e12 * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _b_then_stats(b_call, out: torch.Tensor, stats: torch.Tensor):
    """D's dual form as B's launch, then channel_stats on its bf16 output."""
    from multitalent_tpu_torch.ops.fused_norm import channel_stats

    def call():
        stats.copy_(channel_stats(b_call()))
        return out
    call.workspace = b_call.workspace
    return call


def host_us(fn, calls: int = HOST_CALLS) -> float:
    """The host's us a call of fn, over `calls` calls issued back to back
    (the card's queue drained before and after)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _timed_in_turns(row: dict, calls: dict) -> None:
    """Each form's queued ms, single-call ms (CUDA events around one call,
    median of 10, as chip_smoke's phase 2 times them) and the host's us a
    call and a workspace query into row: forms in order, then in reverse;
    the lesser of the two."""
    for order in (list(calls), list(calls)[::-1]):
        for name in order:
            for key, v in ((f"{name}_queued_ms", queued_ms(calls[name])),
                           (f"{name}_single_ms", _util.median_ms(calls[name])),
                           (f"{name}_host_us", host_us(calls[name])),
                           (f"{name}_workspace_us", host_us(calls[name].workspace))):
                row[key] = min(v, row.get(key, v))


def _times(row: dict, calls: dict) -> str:
    return (", ".join(f"{name} {row[f'{name}_queued_ms']:.3f} / {row[f'{name}_single_ms']:.3f}"
                      for name in calls) + " ms (queued / single call); host us a call "
            + ", ".join(f"{name} {row[f'{name}_host_us']:.1f} (workspace query "
                        f"{row[f'{name}_workspace_us']:.1f})" for name in calls))


def _time_bd(libs: dict, device: torch.device, gen: torch.Generator, only=None) -> list:
    """B and D in every form at their phase-2 shapes (`only`: one kernel's):
    each checked (into NaN-filled buffers) against the plain version, then
    timed in turns; D's dual form also beside B then E's stats pass."""
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
    rows = []
    for kernel, n, sp, cs, cout in BD_SHAPES:
        if only is not None and kernel != only:
            continue
        cin = sum(cs)
        ins = [torch.randn(n, *sp, c, generator=gen, device=device).to(torch.bfloat16)
               for c in cs]
        w = torch.randn(cout, cin, 3, 3, 3, generator=gen, device=device) * (2 / (27 * cin)) ** 0.5
        bias = torch.randn(cout, generator=gen, device=device) * 0.1
        w_bf = w.to(torch.bfloat16)
        affine = None
        if kernel == "d":
            affine = (torch.rand(n, cin, generator=gen, device=device) + 0.5,
                      torch.randn(n, cin, generator=gen, device=device))
            ref, _ = cv.conv3d_same_affine_ref(ins[0], w_bf, bias, *affine)
            pw = cv.prepare_conv3d_weight(w)
        else:
            ref = cv.conv3d_same_dual_ref(*(t.float() for t in ins), w_bf.float(), bias)
            pw = cv.prepare_conv3d_weight(w, cs)
        bound = ATOL + RTOL * ref.float().abs().max().item()
        out = torch.empty(n, *sp, cout, dtype=torch.bfloat16, device=device)
        stats = torch.empty(n, 2, cout, dtype=torch.float32, device=device)
        calls = {name: _bd_launcher(lib, kernel, ins, pw, bias, affine, out, stats)
                 for name, lib in libs.items()}
        if kernel == "d_dual":
            # the same out and stats by two launches: B (at 16-byte rows the
            # wgmma body) and kernel E's stats pass on its output; and B alone
            b_call = _bd_launcher(libs["whole"], "b", ins, pw, bias, None, out, stats)
            calls["b_then_stats"] = _b_then_stats(b_call, out, stats)
            calls["b_alone"] = b_call
        what = f"{kernel} {'+'.join(map(str, cs))}->{cout} at {'x'.join(map(str, sp))} N={n}"
        row = {"kernel": kernel, "n": n, "spatial": list(sp), "cin": list(cs), "cout": cout}
        outs = {}
        for name, call in calls.items():
            out.fill_(float("nan"))
            stats.fill_(float("nan"))
            err = (call().float() - ref.float()).abs().max().item()
            if not err <= bound:
                raise AssertionError(f"{what} ({name}): max|d| {err} > {bound}")
            outs[name] = out.clone()
            if kernel != "b" and name != "b_alone":
                sref = channel_stats_ref(out.float())
                serr = ((stats - sref).abs() / (channel_stats_ref(out.float().abs()) + 1e-6)
                        ).max().item()
                if not serr <= STATS_RTOL:
                    raise AssertionError(f"{what} ({name}): stats {serr} > {STATS_RTOL}")
        _timed_in_turns(row, calls)
        if kernel == "d_dual":
            row.update(d_dual_bound(cs, cout, sp, n))
            plan = cv.conv3d_same_plan(n, *sp, cs, cout, "d_dual")
            b_plan = cv.conv3d_same_plan(n, *sp, cs, cout, "b")
            row["body"] = "ring" if plan["ring"] else "wgmma"
            row["bit_equal_to_b"] = bool(torch.equal(outs["whole"], outs["b_alone"]))
            if plan["wgmma"] == b_plan["wgmma"] and not row["bit_equal_to_b"]:
                raise AssertionError(f"{what}: D's dual form differs from B on one body")
        print(f"{what}: {_times(row, calls)}"
              + (f"; bound {row['bound_ms']:.3f} ms ({row['bound_by']}); D's dual form on "
                 f"the {row['body']} body, bit-equal to B: {row['bit_equal_to_b']}"
                 if "bound_ms" in row else ""))
        rows.append(row)
        del ins, ref, out, calls
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    from multitalent_tpu_torch.ops import conv3d as cv
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose multitalent_tpu_torch/csrc to build the forms of")
    parser.add_argument("--against", help="another checkout, built as it is")
    parser.add_argument("--out", help="write the times as JSON to this file")
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--only", choices=("d_dual",),
                        help="time D's dual form (beside B, and B then E's stats) alone")
    args = parser.parse_args(argv)
    csrc = Path(args.tree) / "multitalent_tpu_torch" / "csrc"
    device = _util.resolve_device(args.device)
    if device.type == "cpu":
        text = (csrc / "conv3d_same.cu").read_text()
        for form in FORMS:
            form_source(text, form)
        print(f"plain run on the CPU: {csrc / 'conv3d_same.cu'} takes the patch "
              "(the forms are timed on the card only)")
        return {}
    sources = {form: (csrc, form) for form in FORMS}
    if args.against:
        sources["against"] = (Path(args.against) / "multitalent_tpu_torch" / "csrc", "whole")
    libs, ptxas = build_forms(sources)
    ptxas["kernel C"] = wgrad_ptxas(csrc)
    if args.against:
        ptxas["kernel C, against"] = wgrad_ptxas(sources["against"][0])
    for name, lines in ptxas.items():
        print(f"ptxas, {name}:" + "".join(f"\n  {line}" for line in lines))
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for n, sp, cin, cout in ([] if args.only else SHAPES):
        x = torch.randn(n, *sp, cin, generator=gen, device=device).to(torch.bfloat16)
        w = torch.randn(cout, cin, 3, 3, 3, generator=gen, device=device) * (2 / (27 * cin)) ** 0.5
        bias = torch.randn(cout, generator=gen, device=device) * 0.1
        pw = cv.prepare_conv3d_weight(w)
        ref = cv.conv3d_same_ref(x.float(), w.to(torch.bfloat16).float(), bias)
        bound = ATOL + RTOL * ref.abs().max().item()
        out = torch.empty(n, *sp, cout, dtype=torch.bfloat16, device=device)
        calls = {name: _launcher(lib, x, pw, bias, out) for name, lib in libs.items()}
        row = {"kernel": "a", "n": n, "spatial": list(sp), "cin": cin, "cout": cout}
        outs = {}
        for name, call in calls.items():
            out.fill_(float("nan"))
            err = (call().float() - ref).abs().max().item()
            if not err <= bound:
                raise AssertionError(f"kernel A ({name}) at {cin}->{cout} {sp} N={n}: "
                                     f"max|d| {err} > {bound}")
            outs[name] = out.clone()
        if "against" in outs:  # A as built against the other checkout's A
            row["bit_equal_to_against"] = bool(torch.equal(outs["whole"], outs["against"]))
            if not row["bit_equal_to_against"]:
                raise AssertionError(f"kernel A at {cin}->{cout} {sp} N={n}: the output "
                                     "differs from the --against checkout's")
        _timed_in_turns(row, calls)
        print(f"a {cin}->{cout} at {'x'.join(map(str, sp))} N={n}: {_times(row, calls)}"
              + (", bit-equal to --against" if "against" in outs else ""))
        rows.append(row)
        del x, ref, out, calls, outs
        torch.cuda.empty_cache()
    rows += _time_bd(libs, device, gen, args.only)
    result = {"tree": str(Path(args.tree).resolve()), "against": args.against,
              "device": torch.cuda.get_device_name(0), "ptxas": ptxas, "shapes": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
