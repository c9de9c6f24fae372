"""What paces the fp32 forms of kernels A and B (the ring body of
csrc/conv3d_fp32.cu) on the H100, shape by shape, beside another
checkout's build of the same call and cuDNN's fp32 convolution.

At every fp32 A/B call of one Task003 Liver fp32 training step at batch 2
(STEP_SHAPES: each stage's forward conv, its dx, each decoder's B and its
dx) and the flagship's 30-channel rows at N=1 (FLAGSHIP_SHAPES), it reads,
each on the card:

- the ring body's output into a NaN-filled buffer against the plain fp32
  version (TF32 off) within FP32_RTOL of the output's largest entry, and two
  calls bit-equal;
- the body's forms: as it is, copies only (each stage is staged, no FFMA)
  and products only (no stage is staged; the FFMAs run on what shared
  memory holds), each a median of single calls: where the copies hide
  behind the products, the whole takes about the products' time;
- the whole body and `--against DIR`'s build of the same C entry (e.g. the
  parent commit's, from a `git archive`) single and queued, in turns
  (against, this, this, against; the lesser of each pair), the other
  checkout's output within the same bound;
- cuDNN's fp32 convolution (TF32 off; B's on the concat built beforehand)
  single and queued, and the bound: 2 * 27 * Cin * Cout FLOPs a voxel at
  67 TFLOP/s, or the bytes at 3.35 TB/s, the larger;
- ptxas's registers and spills of this checkout's conv kernels.

    python -m multitalent_tpu_torch.probes.fp32_forms [--against DIR] [--out JSON]

`--device cpu` checks the plans and the plain versions at a small volume
only: the body runs on the card.
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
MODES = ("whole", "copies", "products")
FP32_RTOL = 1e-4  # chip_smoke's 14a bound: fp32 sums of the same products in other orders
PEAK_FP32_FLOPS, PEAK_HBM_BYTES = 67e12, 3.35e12
CPU_SPATIAL = (6, 8, 10)  # the volume of a --device cpu run


def shape_name(n: int, spatial, ca: int, cb: int, cout: int) -> str:
    cin = f"{ca}+{cb}" if cb else f"{ca}"
    return f"{cin}->{cout} @{'x'.join(map(str, spatial))} N={n}"


def bound(n: int, spatial, cin: int, cout: int) -> dict:
    """The conv's least time on an H100: its fp32 FLOPs at the FFMA peak or
    its bytes (inputs, weights and output once) at the memory rate."""
    vox = n * prod(spatial)
    t_ops = 2 * 27 * cin * cout * vox / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * (vox * (cin + cout) + 27 * cin * cout) / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
        m = re.search(r"Compiling entry function .*?(conv_fp32_ring_kernel|conv_fp32_kernel)"
                      r"(I\w+?)EEv", line)
        if m:
            entry = f"{m.group(1)}<{', '.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
        elif entry and "spill" in line:
            spill = line.split(",", 1)[1].strip()
        elif entry and "registers" in line:
            lines.append(f"{entry}: {re.search(r'Used \d+ registers', line).group(0)}, {spill}")
            entry = None
    return lines


def build_against(tree: Path) -> tuple[ctypes.CDLL, tuple]:
    """The other checkout's conv3d_fp32.cu (with fused_norm.cu, whose
    reduce_rows it calls) built into a library of its own under
    `_build/fp32_forms/`, loaded with that checkout's signature of
    mt_conv3d_same_fp32."""
    csrc = tree / "multitalent_tpu_torch" / "csrc"
    texts = [(csrc / f).read_text() for f in ("conv3d_fp32.cu", "fused_norm.cu", "common.cuh")]
    key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + "".join(texts)).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "fp32_forms" / key
    lib = out / "libfp32_against.so"
    if not lib.is_file():
        out.mkdir(parents=True, exist_ok=True)
        objs = [str(out / "conv3d_fp32.o"), str(out / "fused_norm.o")]
        procs = [_nvcc(["-I", str(csrc), "-c", "-o", obj, str(csrc / src)])
                 for obj, src in zip(objs, ("conv3d_fp32.cu", "fused_norm.cu"))]
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
    sig = module._SIGNATURES["mt_conv3d_same_fp32"]
    loaded = ctypes.CDLL(str(lib))
    loaded.mt_conv3d_same_fp32.argtypes, loaded.mt_conv3d_same_fp32.restype = sig
    return loaded, sig


def _against_call(lib: ctypes.CDLL, sig: tuple, ins: list, pw, bias, out):
    """A call of the other checkout's C entry: the signature without a plan
    (14 arguments: a, b, w, bias, out, sizes, stream) or this one's."""
    from multitalent_tpu_torch.ops import conv3d as cv
    n, z, y, xd = (int(s) for s in ins[0].shape[:4])
    cs = [int(t.shape[-1]) for t in ins] + [0]
    ptrs = (ins[0].data_ptr(), ins[1].data_ptr() if len(ins) > 1 else None, pw.w.data_ptr(),
            bias.data_ptr(), out.data_ptr())
    ws = None
    if len(sig[0]) == 14:
        args = (*ptrs, n, z, y, xd, cs[0], cs[1], pw.cout, pw.coutp)
    else:
        plan = cv.conv3d_same_fp32_plan(n, z, y, xd, cs[0], cs[1], pw.cout)
        ws = torch.empty(max(plan["workspace_bytes"], 4) // 4, device=out.device)
        args = (*ptrs, ws.data_ptr(), plan["workspace_bytes"], n, z, y, xd, cs[0], cs[1],
                pw.cout, pw.coutp, *plan["box"], plan["splits"], int(plan["resident"]),
                plan["stages"], plan["grid"][0], 0)

    def call():
        assert ws is None or ws.numel()  # the workspace lives as long as the call
        code = lib.mt_conv3d_same_fp32(*args, torch.cuda.current_stream(out.device).cuda_stream)
        if code:
            raise RuntimeError(f"the --against build failed: CUDA error {code}")
        return out
    return call


def _inputs(gen, device, n, spatial, ca, cb, cout):
    ins = [torch.randn(n, *spatial, c, generator=gen, device=device) for c in (ca, cb) if c]
    w = torch.randn(cout, ca + cb, 3, 3, 3, generator=gen, device=device) * (
        2 / (27 * (ca + cb))) ** 0.5
    bias = torch.randn(cout, generator=gen, device=device) * 0.1
    return ins, w, bias


def measure(device: torch.device, gen: torch.Generator, shapes, against=None) -> list[dict]:
    """Each shape's check, forms, against build, cuDNN and bound (above)."""
    from multitalent_tpu_torch.ops import conv3d as cv
    rows = []
    for n, sp, ca, cb, cout in shapes:
        ins, w, bias = _inputs(gen, device, n, sp, ca, cb, cout)
        pw = cv.prepare_conv3d_weight(w, (ca, cb) if cb else None, torch.float32)
        ref = (cv.conv3d_same_dual_ref(*ins, w, bias) if cb else
               cv.conv3d_same_ref(ins[0], w, bias))
        top = ref.abs().max().item()
        out = torch.full((n, *sp, cout), float("nan"), device=device)
        name = shape_name(n, sp, ca, cb, cout)

        def held(got, who):
            err = (got - ref).abs().max().item()
            if not (err <= FP32_RTOL * top and torch.isfinite(got).all()):
                raise AssertionError(f"{name} ({who}): max|d| {err:.3e} > {FP32_RTOL} of {top}")
            return err / top

        def form(mode):
            if mode == 0:  # through the wrappers (the plain version on the CPU)
                return ((lambda: cv.conv3d_same_dual(*ins, pw, bias, out=out)) if cb else
                        (lambda: cv.conv3d_same(ins[0], pw, bias, out=out)))
            return lambda: cv._launch_fp32(ins, pw, bias, out, mode)
        row = {"at": name, "n": n, "spatial": list(sp), "ca": ca, "cb": cb, "cout": cout,
               "plan": cv.conv3d_same_fp32_plan(n, *sp, ca, cb, cout,
                                                sms=132 if device.type == "cpu" else None),
               **bound(n, sp, ca + cb, cout)}
        row["rel_err"] = held(form(0)(), "ring body")
        first = out.clone()
        out.fill_(float("nan"))
        row["bit_equal"] = bool(torch.equal(form(0)(), first))
        if not row["bit_equal"]:
            raise AssertionError(f"{name}: two calls differ")
        if device.type == "cpu":
            rows.append(row)
            continue
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)

        def cudnn():
            return F.conv3d(x_cl, w_cl, bias, padding=1)
        calls = {"whole": form(0)}
        if against is not None:
            calls = {"against": _against_call(*against, ins, pw, bias, out), **calls}
            out.fill_(float("nan"))
            row["against_rel_err"] = held(calls["against"](), "--against")
        for order in (list(calls), list(calls)[::-1]):
            for who in order:
                for key, v in ((f"{who}_ms", _util.median_ms(calls[who])),
                               (f"{who}_queued_ms", queued_ms(calls[who]))):
                    row[key] = min(v, row.get(key, v))
        for mode in (1, 2):
            row[f"{MODES[mode]}_ms"] = _util.median_ms(form(mode))
        row["cudnn_ms"] = _util.median_ms(cudnn)
        row["cudnn_queued_ms"] = queued_ms(cudnn)
        row["share_of_bound"] = row["bound_ms"] / row["whole_queued_ms"]
        print(f"{name}: body {row['whole_ms']:.3f} ms, queued {row['whole_queued_ms']:.3f} "
              f"({row['share_of_bound']:.0%} of the bound {row['bound_ms']:.3f} ms, "
              f"{row['bound_by']}); copies only {row['copies_ms']:.3f}, products only "
              f"{row['products_ms']:.3f}"
              + (f"; --against {row['against_ms']:.3f}, queued {row['against_queued_ms']:.3f}"
                 if against is not None else "")
              + f"; cuDNN fp32 {row['cudnn_ms']:.3f}, queued {row['cudnn_queued_ms']:.3f}; "
              f"plan box {row['plan']['box']}, splits {row['plan']['splits']}, "
              f"{'resident' if row['plan']['resident'] else 'streamed'} weights, "
              f"{row['plan']['stages']} stages, grid {row['plan']['grid']}", flush=True)
        rows.append(row)
        del ins, ref, out, calls, first
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", help="another checkout whose C entry to time in turns")
    parser.add_argument("--out", help="write the readings as JSON to this file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = _util.resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)
    shapes = STEP_SHAPES + FLAGSHIP_SHAPES
    if device.type == "cpu":
        rows = measure(device, gen, [(1, CPU_SPATIAL, ca, cb, co)
                                     for _, _, ca, cb, co in shapes[:1] + shapes[6:7]])
        print(f"plain run on the CPU at {CPU_SPATIAL}: " + "; ".join(
            f"{r['at']} within {r['rel_err']:.1e}" for r in rows))
        return {"shapes": rows}
    against = build_against(Path(args.against)) if args.against else None
    csrc = Path(__file__).resolve().parents[1] / "csrc"
    result = {"device": torch.cuda.get_device_name(0), "against": args.against,
              "ptxas": ptxas_lines(csrc)}
    print("ptxas:" + "".join(f"\n  {line}" for line in result["ptxas"]))
    result["shapes"] = measure(device, gen, shapes, against)
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
