"""What paces the fp32 forms of kernels A, B, C and D (the ring bodies of
csrc/conv3d_fp32.cu) and F (csrc/seghead.cu) on the H100, shape by shape,
beside another checkout's build of the same call and cuDNN's fp32
convolution (F: torch.matmul of its form without the prologue).

At every fp32 A/B call of one Task003 Liver fp32 training step at batch 2
(STEP_SHAPES: each stage's forward conv, its dx, each decoder's B and its
dx) and the flagship's 30-channel rows at N=1 (FLAGSHIP_SHAPES), at every
fp32 C call of that step (WGRAD_STEP_SHAPES) and the flagship's 30 -> 30
and 30 + 30 -> 30 dw at N=2 (WGRAD_FLAGSHIP_SHAPES), and at every D call of
its fused fp32 step (D_STEP_SHAPES: the prologue on each stage's second
conv, the dual form on each decoder's first), it reads, each on the card:

- the body's output (D's stats too) into a NaN-filled buffer against the
  plain fp32 version (TF32 off) within FP32_RTOL of the output's largest
  entry, and two calls bit-equal;
- the body's forms: as it is, copies only (each stage is staged, D's
  prologue applied, no FFMA) and products only (no stage is staged; the
  FFMAs run on what shared memory holds), each a median of single calls:
  where the copies hide behind the products, the whole takes about the
  products' time;
- the whole body and `--against DIR`'s build of the same C entry (e.g. the
  parent commit's, from a `git archive`) single and queued, in turns
  (against, this, this, against; the lesser of each pair), the other
  checkout's output within the same bound;
- cuDNN's fp32 call (TF32 off) single and queued: the convolution (B's and
  D's dual form's on the concat built beforehand; D's without its prologue
  and stats), torch.nn.grad.conv3d_weight for C; and the bound: 2 * 27 *
  Cin * Cout FLOPs a voxel at 67 TFLOP/s (D's prologue and stats added), or
  the bytes at 3.35 TB/s, the larger;
- ptxas's registers and spills of this checkout's conv kernels.

F's fp32 form (HEAD_SHAPES: the Liver's head 32 -> 3 at 128^3 N=2 with and
without the prologue, the flagship's 30 -> 47 at 96x192x192 N=1) is checked
the same way (and against the other checkout's output bit for bit: the sum
order is unchanged), then timed single and queued in turns with the other
checkout's build, beside its forms (HEAD_FORMS: csrc/seghead.cu patched as
text and built alone, as conv_a_forms builds its forms: without the
products, the copies and the stores left; without the stores, the copies
and the products left), torch.matmul of its form without the prologue and
its bound (its bytes at 3.35 TB/s or its FLOPs at 67 TFLOP/s).

    python -m multitalent_tpu_torch.probes.fp32_forms [--against DIR] [--only ab c d f]
        [--out JSON]

`--device cpu` checks the plans and the plain versions at a small volume
only: the bodies run on the card.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import re
import subprocess
from math import prod
from pathlib import Path

import torch
import torch.nn.functional as F

from multitalent_tpu_torch import _build
from multitalent_tpu_torch.probes import _util
from multitalent_tpu_torch.probes.wgrad_forms import queued_ms

# (N, spatial, Ca, Cb, Cout): one Liver fp32 step's distinct A/B calls at
# batch 2 (A at each stage, which its dx shares; B at each decoder stage; the
# dx of each B, Cout = 2 C), then the flagship's 30-channel A, B and B's dx
STEP_SHAPES = ([(2, (s,) * 3, c, 0, c) for s, c in ((128, 32), (64, 64), (32, 128), (16, 256),
                                                    (8, 320), (4, 320))]
               + [(2, (s,) * 3, c, c, c) for s, c in ((128, 32), (64, 64), (32, 128), (16, 256),
                                                      (8, 320))]
               + [(2, (s,) * 3, c, 0, 2 * c) for s, c in ((128, 32), (64, 64), (32, 128),
                                                          (16, 256), (8, 320))])
FLAGSHIP_SHAPES = [(1, (96, 192, 192), 30, 0, 30), (1, (96, 192, 192), 30, 30, 30),
                   (1, (96, 192, 192), 30, 0, 60)]
# kernel C's fp32 form (the wgrad ring body): one Liver fp32 step's distinct
# dw calls at batch 2 (each stage's convs, each decoder's B conv), then the
# flagship's 30 -> 30 and 30 + 30 -> 30 at batch 2 (8-byte copies)
WGRAD_STEP_SHAPES = ([(2, (s,) * 3, c, 0, c) for s, c in ((128, 32), (64, 64), (32, 128),
                                                         (16, 256), (8, 320), (4, 320))]
                     + [(2, (s,) * 3, c, c, c) for s, c in ((128, 32), (64, 64), (32, 128),
                                                           (16, 256), (8, 320))])
WGRAD_FLAGSHIP_SHAPES = [(2, (96, 192, 192), 30, 0, 30), (2, (96, 192, 192), 30, 30, 30)]
# kernel D's fp32 forms (the ring body with the prologue and the stats): one
# fused Liver fp32 step's D calls at batch 2, each stage's second conv (with
# the prologue) and each decoder's first (the dual form)
D_STEP_SHAPES = ([(2, (s,) * 3, c, 0, c) for s, c in ((128, 32), (64, 64), (32, 128),
                                                     (16, 256), (8, 320), (4, 320))]
                 + [(2, (s,) * 3, c, c, c) for s, c in ((128, 32), (64, 64), (32, 128),
                                                       (16, 256), (8, 320))])
# kernel F's fp32 form: (N, spatial, C, K, with the prologue)
HEAD_SHAPES = [(2, (128, 128, 128), 32, 3, True), (2, (128, 128, 128), 32, 3, False),
               (1, (96, 192, 192), 30, 47, True)]
# F's forms: (old, new) text patches of csrc/seghead.cu, each replacing
# every occurrence (the narrow and the wide output groups' loops). Without
# the products, the channel loops run no channel (the copies, the prologue
# pass of the wide groups and the stores of bias-only logits are left);
# without the stores, a logit is stored only where it equals a value no
# logit takes here, so the products stay
HEAD_FORMS = {
    "no_products": (("for (int c4 = 0; c4 < c; c4 += 4) {", "for (int c4 = 0; c4 < 0; c4 += 4) {"),
                    ("for (int ch = 0; ch < c; ++ch) {", "for (int ch = 0; ch < 0; ++ch) {")),
    "no_stores": (("if (kk < p.k) put_out(", "if (kk < p.k && acc[e] == 1234.5678f) put_out("),
                  ("if (g + 8 * i < nv) put_out(",
                   "if (g + 8 * i < nv && acc[i][e] == 1234.5678f) put_out(")),
}
MODES = ("whole", "copies", "products")
FP32_RTOL = 1e-4  # chip_smoke's 14a bound: fp32 sums of the same products in other orders
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
CPU_SPATIAL = (6, 8, 10)  # the volume of a --device cpu run


def shape_name(n: int, spatial, ca: int, cb: int, cout: int) -> str:
    cin = f"{ca}+{cb}" if cb else f"{ca}"
    return f"{cin}->{cout} @{'x'.join(map(str, spatial))} N={n}"


def bound(n: int, spatial, cin: int, cout: int, extra_flops: int = 0,
          extra_bytes: int = 0) -> dict:
    """The conv's (or its dw's) least time on an H100: its fp32 FLOPs at the
    FFMA peak or its bytes (inputs, weights and output once) at the memory
    rate; D adds its prologue's and stats' operations and bytes."""
    vox = n * prod(spatial)
    t_ops = (2 * 27 * cin * cout * vox + extra_flops) / PEAK_FP32_FLOPS * 1e3
    t_bytes = (4 * (vox * (cin + cout) + 27 * cin * cout) + extra_bytes) / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def affine_bound(n: int, spatial, ca: int, cb: int, cout: int) -> dict:
    """D's bound: the conv's, its stats (3 operations an output value, 8
    bytes a sample and channel written) and, with one input, its prologue
    (3 operations an input value, 8 bytes a sample and channel read)."""
    vox = n * prod(spatial)
    prologue = cb == 0
    return bound(n, spatial, ca + cb, cout, 3 * vox * cout + (3 * vox * ca if prologue else 0),
                 n * cout * 8 + (n * ca * 8 if prologue else 0))


def _nvcc(args: list[str]) -> subprocess.Popen:
    return subprocess.Popen([_build.find_nvcc(), *_build.NVCC_FLAGS, *args],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def ptxas_lines(csrc: Path) -> list[str]:
    """'kernel<template arguments>: registers, spills' for each conv kernel of
    csrc/conv3d_fp32.cu (`-Xptxas -v`)."""
    return parse_ptxas(_nvcc(["-I", str(csrc), "-Xptxas", "-v", "-c", "-o", "/dev/null",
                              str(csrc / "conv3d_fp32.cu")]).communicate()[0])


def parse_ptxas(log: str) -> list[str]:
    lines, entry, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function .*?(wgrad_fp32_ring_kernel|conv_fp32_ring_kernel"
                      r"|conv_fp32_kernel|wgrad_fp32_kernel)(I\w+?)?EEv", line)
        if m:
            entry = f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2) or ''))}>"
        elif entry and "spill" in line:
            spill = line.split(",", 1)[1].strip()
        elif entry and "registers" in line:
            lines.append(f"{entry}: {re.search(r'Used \d+ registers', line).group(0)}, {spill}")
            entry = None
    return lines


AGAINST_ENTRIES = ("mt_conv3d_same_fp32", "mt_conv3d_wgrad_fp32",
                   "mt_conv3d_wgrad_fp32_workspace", "mt_conv3d_same_affine_fp32",
                   "mt_conv3d_stats_fp32_workspace", "mt_seghead_fp32")
AGAINST_SOURCES = ("conv3d_fp32.cu", "fused_norm.cu", "seghead.cu")


def build_against(tree: Path) -> tuple[ctypes.CDLL, dict]:
    """The other checkout's conv3d_fp32.cu and seghead.cu (with
    fused_norm.cu, whose reduce_rows and stats pass the former calls) built
    into a library of its own under `_build/fp32_forms/`, loaded with that
    checkout's signatures of the fp32 forms' C entries (those it has)."""
    csrc = tree / "multitalent_tpu_torch" / "csrc"
    texts = [(csrc / f).read_text() for f in (*AGAINST_SOURCES, "common.cuh")]
    key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + "".join(texts)).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "fp32_forms" / key
    lib = out / "libfp32_against.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        objs = [str(out / src.replace(".cu", ".o")) for src in AGAINST_SOURCES]
        procs = [_nvcc(["-I", str(csrc), "-c", "-o", obj, str(csrc / src)])
                 for obj, src in zip(objs, AGAINST_SOURCES)]
        logs = [p.communicate()[0] for p in procs]
        if any(p.returncode for p in procs):
            raise RuntimeError(f"nvcc failed for {tree}:\n" + "\n".join(logs))
        link = _nvcc(["-shared", "-o", str(lib), *objs])
        if link.wait():
            raise RuntimeError(f"link failed for {tree}: {link.communicate()[0]}")
    spec = importlib.util.spec_from_file_location(
        "against_build", tree / "multitalent_tpu_torch" / "_build.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    loaded = ctypes.CDLL(str(lib))
    sigs = {}
    for name in AGAINST_ENTRIES:
        if name in module._SIGNATURES:
            sigs[name] = module._SIGNATURES[name]
            fn = getattr(loaded, name)
            fn.argtypes, fn.restype = sigs[name]
    return loaded, sigs


def _checked(lib: ctypes.CDLL, name: str, args: tuple, keep: tuple, result):
    """A call of the other checkout's entry `name` with args and the
    current stream, returning `result` (its output buffers); `keep` holds
    its workspace as long as the call."""
    device = keep[0].device

    def call():
        assert all(k is not None for k in keep)
        code = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
        if code:
            raise RuntimeError(f"the --against build's {name} failed: CUDA error {code}")
        return result
    return call


def _against_call(lib: ctypes.CDLL, sigs: dict, ins: list, pw, bias, out):
    """A call of the other checkout's A/B entry: the signature without a
    plan (14 arguments: a, b, w, bias, out, sizes, stream) or this one's."""
    from multitalent_tpu_torch.ops import conv3d as cv
    n, z, y, xd = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins] + [0]
    ptrs = (ins[0].data_ptr(), ins[1].data_ptr() if len(ins) > 1 else None, pw.w.data_ptr(),
            bias.data_ptr(), out.data_ptr())
    ws = torch.empty(1, device=out.device)
    if len(sigs["mt_conv3d_same_fp32"][0]) == 14:
        args = (*ptrs, n, z, y, xd, cs[0], cs[1], pw.cout, pw.coutp)
    else:
        plan = cv.conv3d_same_fp32_plan(n, z, y, xd, cs[0], cs[1], pw.cout)
        ws = torch.empty(max(plan["workspace_bytes"], 4) // 4, device=out.device)
        args = (*ptrs, ws.data_ptr(), plan["workspace_bytes"], n, z, y, xd, cs[0], cs[1],
                pw.cout, pw.coutp, *plan["box"], plan["splits"], int(plan["resident"]),
                plan["stages"], plan["grid"][0], 0)
    return _checked(lib, "mt_conv3d_same_fp32", args, (ws,), out)


def _against_wgrad(lib: ctypes.CDLL, sigs: dict, ins: list, g, dw):
    """A call of the other checkout's C entry: without a plan (14
    arguments, its workspace from its own query) or with this one's."""
    from multitalent_tpu_torch.ops import conv3d as cv
    n, z, y, xd = (int(s) for s in g.shape[:4])
    cs = [int(t.shape[-1]) for t in ins] + [0]
    cout = int(g.shape[-1])
    ptrs = (ins[0].data_ptr(), ins[1].data_ptr() if len(ins) > 1 else None, g.data_ptr(),
            dw.data_ptr())
    if len(sigs["mt_conv3d_wgrad_fp32"][0]) == 14:
        nbytes = lib.mt_conv3d_wgrad_fp32_workspace(n, z, y, xd, cs[0], cs[1], cout)
        plan_args = ()
    else:
        plan = cv.conv3d_same_wgrad_fp32_plan(n, z, y, xd, cs[0], cs[1], cout)
        nbytes = plan["workspace_bytes"]
        plan_args = (*plan["box"], plan["splits"], plan["grid"], plan["stages"], 0)
    ws = torch.empty(max(nbytes, 4) // 4, device=g.device)
    args = (*ptrs, ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cs[1], cout, *plan_args)
    return _checked(lib, "mt_conv3d_wgrad_fp32", args, (ws,), dw)


def _against_affine(lib: ctypes.CDLL, sigs: dict, ins: list, pw, bias, affine, out, stats):
    """A call of the other checkout's D entry: without a plan (20
    arguments, its workspace from mt_conv3d_stats_fp32_workspace) or with
    this one's."""
    from multitalent_tpu_torch.ops import conv3d as cv
    n, z, y, xd = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins] + [0]
    scale, shift = affine if affine else (None, None)
    if len(sigs["mt_conv3d_same_affine_fp32"][0]) == 20:
        nbytes = lib.mt_conv3d_stats_fp32_workspace(n, z, y, xd, pw.cout)
        plan_args = ()
    else:
        plan = cv.conv3d_same_fp32_plan(n, z, y, xd, cs[0], cs[1], pw.cout, stats=True)
        nbytes = plan["workspace_bytes"]
        plan_args = (*plan["box"], plan["splits"], int(plan["resident"]), plan["stages"],
                     plan["grid"][0], 0)
    ws = torch.empty(max(nbytes, 4) // 4, device=out.device)
    args = (ins[0].data_ptr(), ins[1].data_ptr() if len(ins) > 1 else None, pw.w.data_ptr(),
            bias.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), 1e-2, out.data_ptr(), stats.data_ptr(),
            ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cs[1], pw.cout, pw.coutp, *plan_args)
    return _checked(lib, "mt_conv3d_same_affine_fp32", args, (ws,), (out, stats))


def _inputs(gen, device, n, spatial, ca, cb, cout):
    ins = [torch.randn(n, *spatial, c, generator=gen, device=device) for c in (ca, cb) if c]
    w = torch.randn(cout, ca + cb, 3, 3, 3, generator=gen, device=device) * (
        2 / (27 * (ca + cb))) ** 0.5
    bias = torch.randn(cout, generator=gen, device=device) * 0.1
    return ins, w, bias


def _timed(row: dict, forms: dict, cudnn, against=None) -> None:
    """The row's times on the card: the whole body (forms[0]) and the other
    checkout's build single and queued in turns (against, this, this,
    against: the lesser of each pair), the copies-only and products-only
    forms, cuDNN's call; then the share of the bound and a printed line."""
    calls = {"whole": forms[0]}
    if against is not None:
        calls = {"against": against, **calls}
    for order in (list(calls), list(calls)[::-1]):
        for who in order:
            for key, v in ((f"{who}_ms", _util.median_ms(calls[who])),
                           (f"{who}_queued_ms", queued_ms(calls[who]))):
                row[key] = min(v, row.get(key, v))
    for mode in (1, 2):
        row[f"{MODES[mode]}_ms"] = _util.median_ms(forms[mode])
    row["cudnn_ms"] = _util.median_ms(cudnn)
    row["cudnn_queued_ms"] = queued_ms(cudnn)
    row["share_of_bound"] = row["bound_ms"] / row["whole_queued_ms"]
    plan = row["plan"]
    print(f"{row['kernel']} {row['at']}: body {row['whole_ms']:.3f} ms, queued "
          f"{row['whole_queued_ms']:.3f} ({row['share_of_bound']:.0%} of the bound "
          f"{row['bound_ms']:.3f} ms, {row['bound_by']}); copies only {row['copies_ms']:.3f}, "
          f"products only {row['products_ms']:.3f}"
          + (f"; --against {row['against_ms']:.3f}, queued {row['against_queued_ms']:.3f}"
             if against is not None else "")
          + f"; cuDNN fp32 {row['cudnn_ms']:.3f}, queued {row['cudnn_queued_ms']:.3f}; plan "
          + ", ".join(f"{k} {plan[k]}" for k in ("box", "splits", "resident", "stages", "grid")
                      if k in plan), flush=True)


def _held(name: str, got, ref) -> float:
    """got within FP32_RTOL of ref's largest entry, finite; the relative error."""
    top = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    if not (err <= FP32_RTOL * top and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max|d| {err:.3e} > {FP32_RTOL} of {top}")
    return err / max(top, 1e-30)


def _repeat(row: dict, name: str, run, buffers) -> None:
    """A second call into NaN-refilled buffers must give the first's bits."""
    first = [b.clone() for b in buffers]
    for b in buffers:
        b.fill_(float("nan"))
    run()
    row["bit_equal"] = all(torch.equal(a, b) for a, b in zip(first, buffers))
    if not row["bit_equal"]:
        raise AssertionError(f"{name}: two calls differ")


def _sms(device) -> int | None:
    return 132 if device.type == "cpu" else None


def measure(device: torch.device, gen: torch.Generator, shapes, against=None) -> list[dict]:
    """Kernels A's and B's fp32 forms: each shape's check, forms, against
    build, cuDNN and bound (above)."""
    from multitalent_tpu_torch.ops import conv3d as cv
    rows = []
    for n, sp, ca, cb, cout in shapes:
        ins, w, bias = _inputs(gen, device, n, sp, ca, cb, cout)
        pw = cv.prepare_conv3d_weight(w, (ca, cb) if cb else None, torch.float32)
        ref = (cv.conv3d_same_dual_ref(*ins, w, bias) if cb else
               cv.conv3d_same_ref(ins[0], w, bias))
        out = torch.full((n, *sp, cout), float("nan"), device=device)
        name = shape_name(n, sp, ca, cb, cout)
        forms = {0: ((lambda: cv.conv3d_same_dual(*ins, pw, bias, out=out)) if cb else
                     (lambda: cv.conv3d_same(ins[0], pw, bias, out=out)))}
        forms.update({m: (lambda m=m: cv._launch_fp32(ins, pw, bias, out, m)) for m in (1, 2)})
        row = {"kernel": "B" if cb else "A", "at": name, "n": n, "spatial": list(sp), "ca": ca,
               "cb": cb, "cout": cout,
               "plan": cv.conv3d_same_fp32_plan(n, *sp, ca, cb, cout, sms=_sms(device)),
               **bound(n, sp, ca + cb, cout)}
        row["rel_err"] = _held(f"{name} (ring body)", forms[0](), ref)
        _repeat(row, name, forms[0], [out])
        if device.type == "cpu":
            rows.append(row)
            continue
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)
        call = None
        if against is not None:
            call = _against_call(*against, ins, pw, bias, out)
            out.fill_(float("nan"))
            row["against_rel_err"] = _held(f"{name} (--against)", call(), ref)
        _timed(row, forms, lambda: F.conv3d(x_cl, w_cl, bias, padding=1), call)
        rows.append(row)
        del ins, ref, out, forms, call
        torch.cuda.empty_cache()
    return rows


def measure_wgrad(device: torch.device, gen: torch.Generator, shapes,
                  against=None) -> list[dict]:
    """Kernel C's fp32 form (the wgrad ring body): each shape's check into a
    NaN-filled dw, forms, against build, cuDNN's fp32 wgrad and bound."""
    from multitalent_tpu_torch.ops import conv3d as cv
    rows = []
    for n, sp, ca, cb, cout in shapes:
        ins = [torch.randn(n, *sp, c, generator=gen, device=device) for c in (ca, cb) if c]
        g = torch.randn(n, *sp, cout, generator=gen, device=device)
        ref = (cv.conv3d_same_wgrad_dual_ref(*ins, g) if cb else
               cv.conv3d_same_wgrad_ref(ins[0], g))
        dw = torch.full((cout, ca + cb, 3, 3, 3), float("nan"), device=device)
        name = shape_name(n, sp, ca, cb, cout)
        forms = {0: ((lambda: cv.conv3d_same_wgrad_dual(*ins, g, out=dw)) if cb else
                     (lambda: cv.conv3d_same_wgrad(ins[0], g, out=dw)))}
        forms.update({m: (lambda m=m: cv._launch_wgrad_fp32(ins, g, dw, m)) for m in (1, 2)})
        row = {"kernel": "C", "at": name, "n": n, "spatial": list(sp), "ca": ca, "cb": cb,
               "cout": cout,
               "plan": cv.conv3d_same_wgrad_fp32_plan(n, *sp, ca, cb, cout, sms=_sms(device)),
               **bound(n, sp, ca + cb, cout)}
        row["rel_err"] = _held(f"C {name}", forms[0](), ref)
        _repeat(row, f"C {name}", forms[0], [dw])
        if device.type == "cpu":
            rows.append(row)
            continue
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        g_cl = g.permute(0, 4, 1, 2, 3)
        call = None
        if against is not None:
            call = _against_wgrad(*against, ins, g, dw)
            dw.fill_(float("nan"))
            row["against_rel_err"] = _held(f"C {name} (--against)", call(), ref)
        _timed(row, forms, lambda: torch.nn.grad.conv3d_weight(
            x_cl, (cout, ca + cb, 3, 3, 3), g_cl, padding=1), call)
        rows.append(row)
        del ins, g, ref, dw, forms, call, x_cl, g_cl
        torch.cuda.empty_cache()
    return rows


def measure_affine(device: torch.device, gen: torch.Generator, shapes,
                   against=None) -> list[dict]:
    """Kernel D's fp32 forms (the ring body with the prologue, one input, or
    the dual form; the stats): each shape's check of out and stats into
    NaN-filled buffers, forms, against build, cuDNN's fp32 conv alone and
    D's bound."""
    from multitalent_tpu_torch.ops import conv3d as cv
    rows = []
    for n, sp, ca, cb, cout in shapes:
        ins, w, bias = _inputs(gen, device, n, sp, ca, cb, cout)
        affine = () if cb else ((torch.rand(n, ca, generator=gen, device=device) + 0.5),
                                torch.randn(n, ca, generator=gen, device=device))
        pw = cv.prepare_conv3d_weight(w, (ca, cb) if cb else None, torch.float32)
        if cb:
            ref, ref_stats = cv.conv3d_same_dual_stats_ref(*ins, w, bias)
        else:
            ref, ref_stats = cv.conv3d_same_affine_ref(ins[0], w, bias, *affine)
        out = torch.full((n, *sp, cout), float("nan"), device=device)
        stats = torch.full((n, 2, cout), float("nan"), device=device)
        name = shape_name(n, sp, ca, cb, cout)
        forms = {0: ((lambda: cv.conv3d_same_dual_stats(*ins, pw, bias, out=out, stats=stats))
                     if cb else (lambda: cv.conv3d_same_affine(ins[0], pw, bias, *affine,
                                                                out=out, stats=stats)))}
        forms.update({m: (lambda m=m: cv._launch_stats_fp32(
            ins, pw, bias, (*affine, 1e-2) if affine else (), out, stats, m)) for m in (1, 2)})
        row = {"kernel": "D dual" if cb else "D", "at": name, "n": n, "spatial": list(sp),
               "ca": ca, "cb": cb, "cout": cout,
               "plan": cv.conv3d_same_fp32_plan(n, *sp, ca, cb, cout, sms=_sms(device),
                                                stats=True),
               **affine_bound(n, sp, ca, cb, cout)}
        got, got_stats = forms[0]()
        row["rel_err"] = max(_held(f"D {name}", got, ref),
                             _held(f"D {name} stats", got_stats, ref_stats))
        _repeat(row, f"D {name}", forms[0], [out, stats])
        if device.type == "cpu":
            rows.append(row)
            continue
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)
        call = None
        if against is not None:
            call = _against_affine(*against, ins, pw, bias, affine, out, stats)
            out.fill_(float("nan"))
            stats.fill_(float("nan"))
            a_out, a_stats = call()
            row["against_rel_err"] = max(_held(f"D {name} (--against)", a_out, ref),
                                         _held(f"D {name} stats (--against)", a_stats,
                                               ref_stats))
        _timed(row, forms, lambda: F.conv3d(x_cl, w_cl, bias, padding=1), call)
        rows.append(row)
        del ins, ref, out, stats, forms, call, x_cl
        torch.cuda.empty_cache()
    return rows


def head_bound(n: int, spatial, c: int, k: int, prologue: bool) -> dict:
    """F's fp32 form's least time on an H100: its bytes (x read once, the
    logits written once, the scale and shift) at 3.35 TB/s or its FLOPs (2
    C K a voxel, the prologue's 4 C) at 67 TFLOP/s, the larger."""
    vox = n * prod(spatial)
    t_ops = (2 * c * k * vox + (4 * c * vox if prologue else 0)) / PEAK_FP32_FLOPS * 1e3
    t_bytes = (4 * vox * (c + k) + (8 * n * c if prologue else 0)) / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def build_head_forms() -> dict:
    """HEAD_FORMS of this checkout's csrc/seghead.cu, each built alone (in
    parallel) under `_build/fp32_forms/` and loaded."""
    text = (_build.CSRC / "seghead.cu").read_text()
    libs, procs = {}, []
    for name, patches in HEAD_FORMS.items():
        form = text
        for old, new in patches:
            if old not in form:
                raise ValueError(f"form {name!r}: no `{old}` in seghead.cu")
            form = form.replace(old, new)
        key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + form + (
            _build.CSRC / "common.cuh").read_text()).encode()).hexdigest()[:16]
        out = _build.BUILD_DIR / "fp32_forms" / f"{name}_{key}"
        libs[name] = out / "libseghead_form.so"
        if libs[name].is_file():
            continue
        out.mkdir(parents=True, exist_ok=True)
        (out / "seghead.cu").write_text(form)
        procs.append((name, _nvcc(["-I", str(_build.CSRC), "-shared", "-o", str(libs[name]),
                                   str(out / "seghead.cu")])))
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for F's form {name}:\n{log}")
    loaded = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(str(path))
        lib.mt_seghead_fp32.argtypes, lib.mt_seghead_fp32.restype = (
            _build._SIGNATURES["mt_seghead_fp32"])
        loaded[name] = lib
    return loaded


def _against_head(lib: ctypes.CDLL, x, head, bias, aff, out):
    """A call of the other checkout's F fp32 entry, or of one of this one's
    forms (the same signature)."""
    from multitalent_tpu_torch.ops import seghead as sg
    n, z, y, xd, c = (int(v) for v in x.shape)
    k = int(head.shape[0])
    w = sg.prepared_head_weight(head, x.device, torch.float32)
    args = (x.data_ptr(), None if aff[0] is None else aff[0].data_ptr(),
            None if aff[1] is None else aff[1].data_ptr(), w.data_ptr(), bias.data_ptr(),
            out.data_ptr(), 0, n, z * y * xd, c, k, int(w.shape[0]), int(w.shape[1]), 1e-2)
    return _checked(lib, "mt_seghead_fp32", args, (w,), out)


def measure_head(device: torch.device, gen: torch.Generator, shapes,
                 against=None) -> list[dict]:
    """Kernel F's fp32 form: each shape's check into a NaN-filled output and
    a bit-equal repeat, the other checkout's output bit for bit, then the
    body and the other checkout's single and queued in turns (against, this,
    this, against: the lesser of each pair), its forms without the products
    and without the stores (queued), torch.matmul of the form without the
    prologue, the share of the bound."""
    from multitalent_tpu_torch.ops import seghead as sg
    rows = []
    forms = {} if device.type == "cpu" else build_head_forms()
    for n, sp, c, k, prologue in shapes:
        x = torch.randn(n, *sp, c, generator=gen, device=device)
        head = torch.randn(k, c, 1, 1, 1, generator=gen, device=device) * (1 / c) ** 0.5
        bias = torch.randn(k, generator=gen, device=device) * 0.1
        aff = ((torch.rand(n, c, generator=gen, device=device) + 0.5,
                torch.randn(n, c, generator=gen, device=device)) if prologue else (None, None))
        ref = sg.seghead_ref(x, head, bias, *aff, 1e-2, torch.float32)
        out = torch.full((n, k, *sp), float("nan"), device=device)
        name = f"{c}->{k} @{'x'.join(map(str, sp))} N={n}" + ("" if prologue else
                                                              ", no prologue")

        def whole():
            return sg.seghead_fp32(x, head, bias, *aff, 1e-2, torch.float32, out=out)
        row = {"kernel": "F", "at": name, "n": n, "spatial": list(sp), "c": c, "k": k,
               "prologue": prologue, **head_bound(n, sp, c, k, prologue)}
        row["rel_err"] = _held(f"F {name}", whole(), ref)
        _repeat(row, f"F {name}", whole, [out])
        if device.type == "cpu":
            rows.append(row)
            continue
        mine = out.clone()
        calls = {"whole": whole}
        if against is not None:
            calls = {"against": _against_head(against[0], x, head, bias, aff, out), **calls}
            out.fill_(float("nan"))
            row["against_rel_err"] = _held(f"F {name} (--against)", calls["against"](), ref)
            row["bit_equal_to_against"] = bool(torch.equal(out, mine))
            if not row["bit_equal_to_against"]:
                raise AssertionError(f"F {name}: the output differs from --against's")
        for order in (list(calls), list(calls)[::-1]):
            for who in order:
                for key, v in ((f"{who}_ms", _util.median_ms(calls[who])),
                               (f"{who}_queued_ms", queued_ms(calls[who]))):
                    row[key] = min(v, row.get(key, v))
        for form, lib in forms.items():
            row[f"{form}_queued_ms"] = queued_ms(_against_head(lib, x, head, bias, aff, out))
        w2, xs = head.reshape(k, c), x.reshape(n, -1, c).transpose(1, 2)

        def library():
            return torch.matmul(w2, xs)
        row["matmul_ms"], row["matmul_queued_ms"] = _util.median_ms(library), queued_ms(library)
        row["share_of_bound"] = row["bound_ms"] / row["whole_queued_ms"]
        print(f"F {name}: body {row['whole_ms']:.3f} ms, queued {row['whole_queued_ms']:.3f} "
              f"({row['share_of_bound']:.0%} of the bound {row['bound_ms']:.3f} ms, "
              f"{row['bound_by']})"
              + (f"; --against {row['against_ms']:.3f}, queued {row['against_queued_ms']:.3f}, "
                 "bit-equal" if against is not None else "")
              + "".join(f"; {form} queued {row[f'{form}_queued_ms']:.3f}" for form in forms)
              + f"; torch.matmul without the prologue {row['matmul_ms']:.3f}, queued "
                f"{row['matmul_queued_ms']:.3f}", flush=True)
        rows.append(row)
        del x, ref, out, mine, calls
        torch.cuda.empty_cache()
    return rows


GROUPS = ("ab", "c", "d", "f")


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="another checkout whose C entries to time in turns")
    parser.add_argument("--only", nargs="+", choices=GROUPS, default=list(GROUPS),
                        help="the kernels to measure: A and B, C, D, F (default all)")
    parser.add_argument("--out", help="write the readings as JSON to this file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _util.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    groups = {"ab": (measure, STEP_SHAPES + FLAGSHIP_SHAPES),
              "c": (measure_wgrad, WGRAD_STEP_SHAPES + WGRAD_FLAGSHIP_SHAPES),
              "d": (measure_affine, D_STEP_SHAPES), "f": (measure_head, HEAD_SHAPES)}
    if device.type == "cpu":
        rows = []
        for key in args.only:
            fn, shapes = groups[key]
            if key == "f":
                rows += fn(device, gen, [(1, CPU_SPATIAL, *s[2:]) for s in shapes])
                continue
            rows += fn(device, gen, [(1, CPU_SPATIAL, ca, cb, co)
                                     for _, _, ca, cb, co in shapes[:1] + shapes[6:7]])
        print(f"plain run on the CPU at {CPU_SPATIAL}: " + "; ".join(
            f"{r['kernel']} {r['at']} within {r['rel_err']:.1e}" for r in rows))
        return {"shapes": rows}
    against = build_against(Path(args.against)) if args.against else None
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    result = {"device": torch.cuda.get_device_name(0), "against": args.against,
              "ptxas": ptxas_lines(csrc)}
    print("ptxas:" + "".join(f"\n  {line}" for line in result["ptxas"]))
    result["shapes"] = []
    for key in args.only:
        fn, shapes = groups[key]
        result["shapes"] += fn(device, gen, shapes, against)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
