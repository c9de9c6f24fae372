"""Smoke run of the PyTorch/CUDA port (multitalent_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the card's name and power limit; build the CUDA kernels from
   multitalent_tpu_torch/csrc (one nvcc per source, in parallel) and time it;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship gives it, with the kernel's median time beside the plain
   version's (fp32, TF32 off) and cuDNN's bf16 op: A and B at the forward's
   shapes (N=1), then A at the training batch (N=2), each into a NaN-filled
   buffer, with the plan it took; kernel C (dw) single at A's shapes and
   dual at B's (each
   into a NaN-filled dw buffer, with its bound and write path: dw directly
   or split partials), and A in the dx role (C -> 2C channels, the dual
   convs' dx), at the training batch N=2; then the fused chain's kernels beside the unfused route they
   replace (the port's plain-torch norm + a cuDNN bf16 conv): D (prologue +
   stats) at A's shapes and its dual form at B's, each at N=1 and N=2 into
   NaN-filled output and stats buffers, with the plan it took, E's stats
   (two calls bit-equal, launches a call by torch.profiler, queued times)
   and apply passes at every norm shape, and F at the stage-0 head into a
   NaN-filled output, beside its form without the prologue and torch.mm of
   that form's function;
3. the inference path through the user's entry point: a reference-layout
   model folder of the MultiTalent flagship (GenericUNet, base 30, pools
   (2,2,2)x4 + (1,2,2), 47 sigmoid regions, patch 96x192x192, spacing
   (1.5,1,1); seeded random weights in the reference's He init) and one
   synthetic CT larger than a patch on every axis go through
   `multitalent_tpu_torch.cli.predict_multitalent.main` with mirror TTA; the
   labelmap and all 47 region NIfTIs must exist at the input's shape, and
   each kernel's launch count must equal its launches per forward times the
   forwards run;
3b. the same with MTTPU_FUSED_NORM=1 (the fused conv -> norm route, kernels
   D, E and F): exact launch counts of the fused route, every region mask
   against the unfused run's, seconds per case of both routes;
4. one tile's sigmoid probabilities through the kernels in bf16 against the
   plain versions, at the same bf16 rounding points and in fp32;
4b. the same for the fused forward, and the plain forward under
   MTTPU_PALLAS_NORM=1 (every norm on kernel E, no grad) against the default;
   both routes again with a faulty LeakyReLU slope, whose readings must break
   the bounds (controls);
5. the training path through the user's entry point: synthetic preprocessed
   MultiTalent cases of two source datasets (valid regions stamped) go
   through `multitalent_tpu_torch.cli.train.main` with MultiTalent_trainer_ddp
   at full flagship width, batch 2, bf16, deep supervision, for a few steps;
   the losses must be finite, every weight must move, the A/B/C launch counts
   must equal their per-step counts times the steps (plus the validation
   forward's A/B), one step's dw of every kernel conv must match the plain
   version on the same bf16 inputs, and the written model folder must predict
   through predict_multitalent; prints seconds per step and peak memory;
5b. the same with MTTPU_FUSED_TRAIN=1 (kernel D forward, A and C backward);
6. the probes (multitalent_tpu_torch/probes, the ports of scripts/' Pallas
   probe harnesses): each probe's entry point (`main`) as a user runs it,
   with every launch count set to 0 before and read after (each count must
   equal what the probes' arguments launch); then each probe kernel, into a
   NaN-filled output buffer, against its plain version at
   the shapes its script times (the conv arms tap/sum (kernel A), im2col,
   tap3 and wino at (2,96,96,96,120) -> 120, the Winograd kernel also
   against a control with one row of G wrong that must break its bound; the
   packed conv at the flagship's stages 0 and 1; the center-view conv and
   the zero fill at (1,96,96,96,128) by tile), each with its bound (the least
   time of its work at the card's peak rates) and its median time beside
   the plain version's and the library call's;
7. one JSON line describing every kernel (A-F and the probes'; the rows
   of A, B, C and D also list their phase-2 shapes (A's, B's and D's with
   their plans) and sum their times, and cuDNN's or the unfused route's,
   over the launches a run recorded: A over one forward (phase 4) and one
   training step (phase 5), B over one forward (phase 4), C over one step
   (phase 5), D over one fused forward (phase 4b) and one fused step (phase
   5b); E's stats row lists its six shapes and sums them over one fused
   forward (phase 4b)), then the result line.

It exits non-zero and prints no result without a CUDA device. It imports no JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from math import prod

from multitalent_tpu_torch.probes._util import median_ms as _median_ms

SEED = 0
FLAGSHIP_POOLS = ((2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))
FLAGSHIP_KERNELS = ((3, 3, 3),) * 6
PATCH = (96, 192, 192)
SPACING_ZYX = (1.5, 1.0, 1.0)
# the synthetic case: larger than a patch on every axis, on a grid slightly
# off the plans' spacing so that preprocessing resamples and the device export
# resizes back
CASE_SHAPE = (128, 256, 256)
CASE_SPACING_ZYX = (1.6, 0.9, 0.9)

# phase 2: a bf16 output from fp32 accumulation against an fp32 reference on
# the same bf16-rounded inputs and weights: one bf16 rounding of the output
# (2^-8 relative) plus summation order
RTOL, ATOL = 1e-2, 1e-2
# phase 4, |dp| of one tile's sigmoid probabilities (3.5M voxels x 47):
# kernels vs the plain versions on the same bf16 inputs and weights, rounding
# at the same points. Summation order still differs, so an activation may
# round one bf16 ulp apart and carry that through ~20 layers; the max over
# 1.6e8 values is a tail (2.96e-2 measured on the H100 before this bound)
PROB_BOUND = 5e-2
PROB_BOUND_MEAN = 2e-3
# kernels in bf16 vs the plain versions in fp32: a sanity bound on bf16
# itself, which rounds every activation of ~20 layers (2^-9 relative each);
# measured on the H100 before this bound was set: max 5.4e-2, mean 3.6e-3
PROB_BOUND_FP32_MAX = 1e-1
PROB_BOUND_FP32_MEAN = 1e-2

# (C, spatial) the flagship forward gives each kernel at patch 96x192x192
KERNEL_A_SHAPES = [(30, (96, 192, 192)), (60, (48, 96, 96)), (120, (24, 48, 48)),
                   (240, (12, 24, 24)), (320, (6, 12, 12)), (320, (6, 6, 6))]
KERNEL_B_SHAPES = [(30, (96, 192, 192)), (60, (48, 96, 96)), (120, (24, 48, 48)),
                   (240, (12, 24, 24)), (320, (6, 12, 12))]
TRAIN_BATCH = 2  # the per-GPU batch of the shipped bs4 run (BASELINE.md:11)
# kernel C: fp32 dw from fp32 accumulation against the fp32 plain version on
# the same bf16 inputs; the sum runs over up to 7.1M voxels in another order,
# so the bound is relative to max|dw| (measured 3.4e-5 of it at stage 0)
DW_RTOL = 1e-3
TRAIN_STEPS = 6         # training iterations; the first 2 are warm-up
TRAIN_CASE_SHAPE = (128, 288, 288)  # synthetic preprocessed cases
# kernel D's stats (kernel E's too): fp32 sums of the same bf16 values in
# another order, relative to the sums of |terms|
STATS_RTOL = 1e-3
# (C, spatial) of every InstanceNorm of the flagship at patch 96x192x192
NORM_SHAPES = KERNEL_A_SHAPES
# the fused vs the unfused predict CLI, region masks of one bf16 case: both
# routes round every activation to bf16, but at other points (the fused
# route rounds the raw conv output before the norm, takes the variance as
# E[x^2] - mean^2 from fp32 sums and rounds x * scale + shift before the
# activation), so voxels whose probability sits at the 0.5 threshold flip
# (measured on the H100 before these bounds were set: worst region 0.99654,
# mean 0.99915)
MASK_AGREE_MEAN = 0.998
MASK_AGREE_WORST = 0.99
# phase 4b, the fused forward's kernels vs its plain versions at the same
# rounding points: besides the summation orders of phase 4, kernel D's
# prologue contracts x * scale + shift into one FMA where the plain version
# rounds twice, so an activation may round one bf16 ulp apart at each of the
# 16 fused convs (measured on the H100 before this bound: max 3.00e-2, mean
# 2.00e-3)
FUSED_PROB_BOUND = 5e-2
FUSED_PROB_BOUND_MEAN = 3e-3
# MTTPU_PALLAS_NORM=1 vs the default norm changes the rounding order (the
# activation in fp32, then one cast; var clamped) at all 22 norms (measured
# on the H100 before this bound: max 3.21e-2, mean 2.26e-3)
PALLAS_NORM_BOUND = 6e-2
PALLAS_NORM_BOUND_MEAN = 4e-3
# controls for the two bounds above: the same route through the same kernels
# with a faulty activation, every LeakyReLU slope 1e-2 replaced by one of
# these; each reading must break its route's bounds, or they could not tell a
# faulty kernel from rounding
CONTROL_SLOPES = (0.0, 5e-3)

# phase 6, the probes at the shapes their scripts time: the conv arms
# (scripts/conv_impl_arms.py:366), the packed conv at the flagship's stages 0
# and 1, unpacked shape and factors, and the cost / grid probes' volume
ARM_SHAPE = (2, 96, 96, 96, 120)
PACKED_CASES = (((1, 96, 192, 192, 30), (2, 2)), ((1, 48, 96, 96, 60), (1, 2)))
PROBE_SHAPE = (1, 96, 96, 96, 128)
PROBE_ITERS = 10  # timed launches per configuration on the probe path
# the least time of a kernel's work on an H100 SXM at its published peaks
# (dense bf16 tensor cores, fp32 CUDA cores, HBM): the larger of its
# operations over the peak rate of their type and its bytes (each input read
# once, each output written once) over the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def phase_device() -> tuple[str, str, float]:
    import torch
    from multitalent_tpu_torch import _build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible)")
    print(smi)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({_build.library_path().name})")
    return name, smi, build_s


def _check(name: str, got, ref, bound: float) -> float:
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= bound and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max|d| {err:.3e} > {bound:.3e}")
    return err


def phase_kernels() -> dict:
    """Each kernel vs its plain version at the flagship's shapes."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"conv3d_same": [], "conv3d_same_dual": [], "conv3d_same_wgrad": [],
               "conv3d_same_dx": []}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def report(name, splits, cout, sp, n, err, bound, ms, plain_ms, cudnn_ms):
        tflops = 2 * 27 * sum(splits) * cout * n * int(torch.tensor(sp).prod()) / (ms * 1e9)
        print(f"{name} {'+'.join(map(str, splits))}->{cout} at {'x'.join(map(str, sp))} "
              f"N={n}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms "
              f"({tflops:.1f} TFLOP/s), plain fp32 {plain_ms:.3f} ms, "
              f"cuDNN bf16 {cudnn_ms:.3f} ms")
        results[name].append({"splits": splits, "cout": cout, "spatial": sp, "n": n,
                              "err": err, "ms": ms, "plain_ms": plain_ms,
                              "cudnn_bf16_ms": cudnn_ms})

    # forward: A and B at N=1, then A and B at the training batch (the
    # step's forward launches, where a block's walk crosses from one sample
    # to the next); each into a NaN-filled buffer, with its plan
    cases = [("conv3d_same", (c,), c, sp, 1) for c, sp in KERNEL_A_SHAPES]
    cases += [("conv3d_same_dual", (c, c), c, sp, 1) for c, sp in KERNEL_B_SHAPES]
    cases += [("conv3d_same", (c,), c, sp, TRAIN_BATCH) for c, sp in KERNEL_A_SHAPES]
    cases += [("conv3d_same_dual", (c, c), c, sp, TRAIN_BATCH) for c, sp in KERNEL_B_SHAPES]
    for name, splits, cout, sp, n in cases:
        cin = sum(splits)
        ins = [rnd(n, *sp, c).to(torch.bfloat16) for c in splits]
        w = rnd(cout, cin, 3, 3, 3, scale=(2.0 / (27 * cin)) ** 0.5)
        w_bf = w.to(torch.bfloat16)
        bias = rnd(cout, scale=0.1)
        pw = cv.prepare_conv3d_weight(w, splits if len(splits) == 2 else None)
        kernel = getattr(cv, name)
        plain = {"conv3d_same": cv.conv3d_same_ref,
                 "conv3d_same_dual": cv.conv3d_same_dual_ref}[name]
        ins32 = [t.float() for t in ins]
        ref = plain(*ins32, w_bf.float(), bias)
        bound = ATOL + RTOL * ref.abs().max().item()
        err = _check(f"{name} {splits}->{cout} at {sp} N={n}",
                     kernel(*ins, pw, bias, out=_nan_filled((n, *sp, cout), dev)), ref, bound)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w_bf.contiguous(memory_format=torch.channels_last_3d)
        report(name, splits, cout, sp, n, err, bound,
               _median_ms(lambda: kernel(*ins, pw, bias)),
               _median_ms(lambda: plain(*ins32, w_bf.float(), bias)),
               _median_ms(lambda: F.conv3d(x_cl, w_cl, bias.to(torch.bfloat16), padding=1)))
        _plan(results[name][-1], "a" if name == "conv3d_same" else "b")
        del ins, ins32, ref, x_cl

    # backward at the training batch: dw by kernel C (single at A's shapes,
    # dual at B's), each checked in a dw buffer filled with NaN and timed
    # beside its bound and its write path (dw directly, or per-split
    # partials and a second launch); dx of the dual convs by kernel A (C ->
    # 2C channels)
    n = TRAIN_BATCH
    cases = [(c, (c,), sp) for c, sp in KERNEL_A_SHAPES]
    cases += [(c, (c, c), sp) for c, sp in KERNEL_B_SHAPES]
    for cout, splits, sp in cases:
        ins = [rnd(n, *sp, c).to(torch.bfloat16) for c in splits]
        g = rnd(n, *sp, cout).to(torch.bfloat16)
        if len(splits) == 1:
            kernel, plain = cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_ref
        else:
            kernel, plain = cv.conv3d_same_wgrad_dual, cv.conv3d_same_wgrad_dual_ref
        ins32, g32 = [t.float() for t in ins], g.float()
        ref = plain(*ins32, g32)
        bound = DW_RTOL * ref.abs().max().item()
        shape = (cout, sum(splits), 3, 3, 3)
        out = torch.full(shape, float("nan"), device=dev)
        err = _check(f"conv3d_same_wgrad {splits}->{cout} at {sp}", kernel(*ins, g, out=out),
                     ref, bound)
        ws = cv.conv3d_same_wgrad_workspace(n, *sp, splits[0], sum(splits[1:]), cout)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        g_cl = g.permute(0, 4, 1, 2, 3)
        report("conv3d_same_wgrad", splits, cout, sp, n, err, bound,
               _median_ms(lambda: kernel(*ins, g)), _median_ms(lambda: plain(*ins32, g32)),
               _median_ms(lambda: torch.nn.grad.conv3d_weight(x_cl, shape, g_cl, padding=1)))
        results["conv3d_same_wgrad"][-1].update(
            write="direct" if ws == 0 else f"{ws // (4 * prod(shape))} splits + reduce",
            **_conv_bound(sum(splits), cout, sp, n, w_bytes=4))
        print(f"  bound {results['conv3d_same_wgrad'][-1]['bound_ms']:.3f} ms, "
              f"{results['conv3d_same_wgrad'][-1]['write']}")
        del ins, ins32, ref, x_cl, out
        if len(splits) == 2:  # dx of the dual conv: one A launch, Cout -> Ca + Cb
            w = rnd(cout, sum(splits), 3, 3, 3, scale=(2.0 / (27 * sum(splits))) ** 0.5)
            wt = w.to(torch.bfloat16).float().flip(2, 3, 4).transpose(0, 1)
            ref = cv.conv3d_same_ref(g32, wt)
            bound = ATOL + RTOL * ref.abs().max().item()
            err = _check(f"conv3d_same dx {cout}->{sum(splits)} at {sp}",
                         cv.conv3d_same_dx(g, w, out=_nan_filled((n, *sp, sum(splits)), dev)),
                         ref, bound)
            wt_cl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            report("conv3d_same_dx", (cout,), sum(splits), sp, n, err, bound,
                   _median_ms(lambda: cv.conv3d_same_dx(g, w)),
                   _median_ms(lambda: cv.conv3d_same_ref(g32, wt)),
                   _median_ms(lambda: F.conv3d(g_cl, wt_cl, padding=1)))
            _plan(results["conv3d_same_dx"][-1], "a")
            del ref
        del g, g32, g_cl
    torch.cuda.empty_cache()
    return results


def _plan(row: dict, form: str) -> None:
    """The plan of kernel A, B, D or D's dual form (`form`, as
    ops.conv3d.conv3d_same_plan takes it) at a timed shape into its row (and
    a line), with the shape's bound: which body, chunks staged at once,
    weights resident or streamed, warps a block, ring stages, K splits,
    blocks."""
    from multitalent_tpu_torch.ops import conv3d as cv
    splits, n, sp = tuple(row["splits"]), row["n"], tuple(row["spatial"])
    plan = cv.conv3d_same_plan(n, *sp, splits[0] if len(splits) == 1 else splits, row["cout"],
                               form)
    row["plan"] = plan
    row.update(_conv_bound(sum(splits), row["cout"], sp, n))
    body = ("ring body" if plan["ring"] else
            "the older body (16-byte rows, streamed weights, whole K loops)")
    print(f"  plan: {body}; ring: G {plan['g']}, weights "
          f"{'resident' if plan['resident'] else 'streamed'}, 16 warps "
          f"(groups split {'K' if plan['ksplit'] else 'N'}) x "
          f"{plan['blocks_per_sm']} block(s) an SM, {plan['stages']} stages, "
          f"{plan['smem_bytes']} B shared, K splits {plan['splits']}, {plan['grid_x']} blocks "
          f"along the tiles; bound {row['bound_ms']:.3f} ms ({row['bound_by']})")


def _stats_rel_err(stats, out) -> float:
    """max |stats - the plain version's stats of the same out| relative to
    the sums of |out| and out^2."""
    from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
    ref = channel_stats_ref(out.float())
    scale = channel_stats_ref(out.float().abs())
    return ((stats - ref).abs() / (scale + 1e-6)).max().item()


def _queued_ms(fn, iters: int = 50) -> float:
    """fn's time on the card a call when `iters` calls are queued back to back
    (CUDA events around all of them, after 3 warm-up calls): single calls of
    short kernels spread up to +-40% from run to run, queued ones far less."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_launches(fn, calls: int = 4) -> float:
    """Work items fn puts on the card a call (kernels, copies, fills), counted
    by torch.profiler over `calls` calls; fails where the profiler sees none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    if n == 0:
        raise AssertionError("torch.profiler saw no work on the card")
    return n / calls


def _stats_bound(c: int, spatial, n: int) -> dict:
    """Kernel E's stats pass: bf16 x read once, the (n, 2, c) fp32 stats
    written once; 3 fp32 operations an element (a square and two adds)."""
    vox = n * prod(spatial)
    return _bound(vox * c * 2 + n * 2 * c * 4, fp32_flops=3 * vox * c)


def _head_bound(c: int, k: int, spatial, n: int) -> dict:
    """Kernel F: bf16 x read once, bf16 logits written once; the products on
    the tensor cores (2 c k an output voxel), the prologue's 4 fp32
    operations an input element on the CUDA cores."""
    vox = n * prod(spatial)
    return _bound(vox * (c + k) * 2, bf16_flops=2 * c * k * vox, fp32_flops=4 * c * vox)


def phase_fused_kernels() -> dict:
    """The fused chain's kernels D, E and F vs their plain versions at the
    flagship's shapes, each timed beside the unfused route it replaces."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.models.blocks import instance_norm_lrelu, to_ndhwc
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    results = {"conv3d_same_affine": [], "channel_stats": [], "affine_lrelu": [],
               "seghead": []}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def ncdhw(t):
        return t.permute(0, 4, 1, 2, 3)

    def report(name, what, err, bound, ms, plain_ms, unfused_ms, unfused_what, **extra):
        print(f"{name} {what}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, unfused route ({unfused_what}) {unfused_ms:.3f} ms"
              + "".join(f", {k} {v:.3e}" if isinstance(v, float) else f", {k} {v}"
                        for k, v in extra.items()))
        results[name].append({"what": what, "err": err, "ms": ms, "plain_ms": plain_ms,
                              "unfused_ms": unfused_ms, **extra})

    # kernel D with the prologue and the stats, N=1 (inference) and 2 (training)
    for n in (1, TRAIN_BATCH):
        for c, sp in KERNEL_A_SHAPES:
            x = rnd(n, *sp, c, scale=2.0).to(torch.bfloat16)
            w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
            w_bf = w.to(torch.bfloat16)
            bias = rnd(c, scale=0.1)
            sc, sh = rnd(n, c).abs() + 0.5, rnd(n, c)
            norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
            pw = cv.prepare_conv3d_weight(w)
            out, stats = cv.conv3d_same_affine(x, pw, bias, sc, sh,
                                               out=_nan_filled((n, *sp, c), dev),
                                               stats=_nan_stats(n, c, dev))
            ref, _ = cv.conv3d_same_affine_ref(x, w_bf, bias, sc, sh)
            bound = ATOL + RTOL * ref.float().abs().max().item()
            err = _check(f"conv3d_same_affine {c}->{c} at {sp} N={n}", out, ref, bound)
            serr = _stats_rel_err(stats, out)
            if not serr <= STATS_RTOL:
                raise AssertionError(f"conv3d_same_affine stats: {serr:.3e} > {STATS_RTOL}")
            x_cl = ncdhw(x)
            w_cl = w_bf.contiguous(memory_format=torch.channels_last_3d)
            b_bf = bias.to(torch.bfloat16)
            report("conv3d_same_affine", f"{c}->{c} at {'x'.join(map(str, sp))} N={n}", err,
                   bound, _median_ms(lambda: cv.conv3d_same_affine(x, pw, bias, sc, sh)),
                   _median_ms(lambda: cv.conv3d_same_affine_ref(x, w_bf, bias, sc, sh)),
                   _median_ms(lambda: F.conv3d(instance_norm_lrelu(x_cl, norm_w, norm_b),
                                               w_cl, b_bf, padding=1)),
                   "norm + cuDNN bf16 conv",
                   unfused_kernel_a_ms=_median_ms(lambda: cv.conv3d_same(
                       to_ndhwc(instance_norm_lrelu(x_cl, norm_w, norm_b)), pw, bias)),
                   stats_rel_err=serr)
            results["conv3d_same_affine"][-1].update(splits=(c,), cout=c, spatial=sp, n=n)
            _plan(results["conv3d_same_affine"][-1], "d")
            del x, x_cl, out, ref
    # kernel D's dual form (decoders' first convs), N=1 (inference) and 2
    # (training)
    for n in (1, TRAIN_BATCH):
        for c, sp in KERNEL_B_SHAPES:
            a, b = (rnd(n, *sp, c).to(torch.bfloat16) for _ in range(2))
            w = rnd(c, 2 * c, 3, 3, 3, scale=(2.0 / (54 * c)) ** 0.5)
            w_bf = w.to(torch.bfloat16)
            bias = rnd(c, scale=0.1)
            pw = cv.prepare_conv3d_weight(w, (c, c))
            out, stats = cv.conv3d_same_dual_stats(a, b, pw, bias,
                                                   out=_nan_filled((n, *sp, c), dev),
                                                   stats=_nan_stats(n, c, dev))
            ref, _ = cv.conv3d_same_dual_stats_ref(a, b, w_bf, bias)
            bound = ATOL + RTOL * ref.float().abs().max().item()
            err = _check(f"conv3d_same_dual_stats {c}+{c}->{c} at {sp} N={n}", out, ref, bound)
            serr = _stats_rel_err(stats, out)
            if not serr <= STATS_RTOL:
                raise AssertionError(f"conv3d_same_dual_stats N={n} stats: {serr:.3e} > "
                                     f"{STATS_RTOL}")
            report("conv3d_same_affine",
                   f"dual {c}+{c}->{c} at {'x'.join(map(str, sp))} N={n}", err, bound,
                   _median_ms(lambda: cv.conv3d_same_dual_stats(a, b, pw, bias)),
                   _median_ms(lambda: cv.conv3d_same_dual_stats_ref(a, b, w_bf, bias)),
                   _median_ms(lambda: cv.conv3d_same_dual(a, b, pw, bias)),
                   "kernel B, no stats", stats_rel_err=serr)
            results["conv3d_same_affine"][-1].update(splits=(c, c), cout=c, spatial=sp, n=n)
            _plan(results["conv3d_same_affine"][-1], "d_dual")
            del a, b, out, ref
    # kernel E at every norm shape, N=1: stats (bit-equal from call to call,
    # launches a call from the profiler, queued time beside the single call's,
    # bound), then apply in both rounding orders; the unfused route is the
    # port's plain norm (stats + normalize)
    for c, sp in NORM_SHAPES:
        x = (rnd(1, *sp, c, scale=3.0) + 1).to(torch.bfloat16)
        stats = fn.channel_stats(x)
        if not torch.equal(stats, fn.channel_stats(x)):
            raise AssertionError(f"channel_stats {c} at {sp}: two calls differ")
        serr = (((stats - fn.channel_stats_ref(x)).abs()
                 / fn.channel_stats_ref(x.abs())).max().item())
        if not serr <= 1e-4:
            raise AssertionError(f"channel_stats {c} at {sp}: {serr:.3e} > 1e-4")
        per_call = _device_launches(lambda: fn.channel_stats(x))
        if not 1 <= per_call <= 2:
            raise AssertionError(f"channel_stats {c} at {sp}: {per_call} launches a call")
        norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
        x_cl = ncdhw(x)
        unfused_ms = _median_ms(lambda: instance_norm_lrelu(x_cl, norm_w, norm_b))
        what = f"{c} at {'x'.join(map(str, sp))} N=1"
        # one PyTorch call of the same function: per-channel mean and variance
        report("channel_stats", what, serr, 1e-4, _median_ms(lambda: fn.channel_stats(x)),
               _median_ms(lambda: fn.channel_stats_ref(x)), unfused_ms,
               "plain norm: stats + normalize",
               library_ms=_median_ms(lambda: torch.var_mean(x, dim=(1, 2, 3), correction=0)),
               queued_ms=_queued_ms(lambda: fn.channel_stats(x)), launches_per_call=per_call,
               **_stats_bound(c, sp, 1))
        results["channel_stats"][-1].update(c=c, spatial=sp, n=1)
        sc, sh = fn.stats_affine(stats, norm_w, norm_b, x.numel() // c)
        sc, sh = sc.contiguous(), sh.contiguous()
        for cast_first in (True, False):
            got = fn.affine_lrelu(x, sc, sh, 1e-2, cast_first)
            want = fn.affine_lrelu_ref(x, sc, sh, 1e-2, cast_first).float()
            # exact: the kernel rounds the product, the sum, the cast and the
            # activation where the plain version does
            bad = (got.float() != want).sum().item()
            err = (got.float() - want).abs().max().item()
            if bad:
                raise AssertionError(f"affine_lrelu {what}: {bad} values differ")
            report("affine_lrelu", f"{what} cast_first={cast_first}", err, 0.0,
                   _median_ms(lambda: fn.affine_lrelu(x, sc, sh, 1e-2, cast_first)),
                   _median_ms(lambda: fn.affine_lrelu_ref(x, sc, sh, 1e-2, cast_first)),
                   unfused_ms, "plain norm: stats + normalize")
        del x, x_cl, got, want
    # kernel F at the stage-0 head, N=1: raw (1, 96, 192, 192, 30) -> 47 bf16,
    # into a NaN-filled output; timed beside its form without the prologue
    # and one PyTorch call of that form's function (torch.mm of the bf16
    # (47, 30) head with the (30, S) view of raw gives F's (47, S) output)
    c, sp = KERNEL_A_SHAPES[0]
    raw = rnd(1, *sp, c, scale=2.0).to(torch.bfloat16)
    head = rnd(47, c, 1, 1, 1, scale=(1.0 / c) ** 0.5)
    sc, sh = rnd(1, c).abs() + 0.5, rnd(1, c)
    norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
    got = sg.seghead(raw, head, None, sc, sh, 1e-2, torch.bfloat16,
                     out=_nan_filled((1, 47, *sp), dev))
    ref = sg.seghead_ref(raw, head, None, sc, sh, 1e-2, torch.float32)
    bound = ATOL + RTOL * ref.abs().max().item()
    err = _check(f"seghead {c}->47 at {sp}", got, ref, bound)
    del got, ref
    plain = sg.seghead(raw, head, None, None, None, 1e-2, torch.bfloat16)
    head_mm, raw_cs = head.reshape(47, c).to(torch.bfloat16), raw.view(-1, c).t()
    mm = torch.mm(head_mm, raw_cs)
    perr = _check(f"seghead {c}->47 at {sp}, no prologue, vs torch.mm", plain,
                  mm.view(1, 47, *sp), ATOL + RTOL * mm.float().abs().max().item())
    del plain, mm
    raw_cl, head_bf = ncdhw(raw), head.to(torch.bfloat16)
    with_prologue = lambda: sg.seghead(raw, head, None, sc, sh, 1e-2, torch.bfloat16)
    no_prologue = lambda: sg.seghead(raw, head, None, None, None, 1e-2, torch.bfloat16)
    library = lambda: torch.mm(head_mm, raw_cs)
    report("seghead", f"{c}->47 at {'x'.join(map(str, sp))} N=1", err, bound,
           _median_ms(with_prologue),
           _median_ms(lambda: sg.seghead_ref(raw, head, None, sc, sh, 1e-2, torch.bfloat16)),
           _median_ms(lambda: F.conv3d(instance_norm_lrelu(raw_cl, norm_w, norm_b),
                                       head_bf).float()),
           "plain norm + cuDNN bf16 1x1x1 conv + fp32 cast",
           queued_ms=_queued_ms(with_prologue), no_prologue_ms=_median_ms(no_prologue),
           no_prologue_queued_ms=_queued_ms(no_prologue), no_prologue_err=perr,
           library_ms=_median_ms(library), library_queued_ms=_queued_ms(library),
           launches_per_call=_device_launches(with_prologue), **_head_bound(c, 47, sp, 1))
    del raw, raw_cl, raw_cs
    torch.cuda.empty_cache()
    return results


def _flagship_plans():
    from multitalent_tpu_torch.io import Plans
    return Plans.from_dict({
        "num_stages": 1, "num_modalities": 1, "modalities": {0: "CT"},
        "normalization_schemes": {0: "CT"}, "num_classes": 47,
        "all_classes": list(range(1, 48)), "base_num_features": 30,
        "use_mask_for_norm": {0: False}, "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "data_identifier": "nnUNetData_plans_v2.1",
        "preprocessor_name": "GenericPreprocessor",
        "dataset_properties": {"intensityproperties": {0: {
            "percentile_00_5": -1000.0, "percentile_99_5": 1500.0,
            "mean": 100.0, "sd": 300.0}}},
        "plans_per_stage": {0: {
            "batch_size": 2, "patch_size": list(PATCH),
            "current_spacing": list(SPACING_ZYX), "original_spacing": list(SPACING_ZYX),
            "median_patient_size_in_voxels": list(CASE_SHAPE),
            "num_pool_per_axis": [4, 5, 5],
            "pool_op_kernel_sizes": [list(p) for p in FLAGSHIP_POOLS],
            "conv_kernel_sizes": [list(k) for k in FLAGSHIP_KERNELS]}}})


def _flagship_net(plans, dtype):
    """The flagship network with seeded random weights in the reference's
    init (InitWeights_He(1e-2): kaiming normal, zero conv bias)."""
    import torch
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    torch.manual_seed(SEED)
    net = build_unet_from_plans(plans, 0, num_classes=47, dtype=dtype)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            torch.nn.init.kaiming_normal_(m.weight, a=1e-2)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    return net


def _kernel_counters() -> dict:
    """Every kernel wrapper of the port by the name its launch count goes by."""
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    from multitalent_tpu_torch.probes import (conv_impl_arms, grid_overhead_probe,
                                              sparse_conv_arm)
    return {"conv3d_same": cv.conv3d_same, "conv3d_same_dual": cv.conv3d_same_dual,
            "conv3d_same_wgrad": cv.conv3d_same_wgrad,
            "conv3d_same_affine": cv.conv3d_same_affine,
            "channel_stats": fn.channel_stats, "affine_lrelu": fn.affine_lrelu,
            "seghead": sg.seghead, **conv_impl_arms.kernels(), **sparse_conv_arm.kernels(),
            **grid_overhead_probe.kernels()}


def _run_counted(fn):
    """fn() with every kernel's launch count set to 0 just before it; returns
    (fn's result, the counts read just after)."""
    counters = _kernel_counters()
    for k in counters.values():
        k.launches = 0
    result = fn()
    return result, {name: k.launches for name, k in counters.items()}


def _expect(counts: dict, scale: int) -> dict:
    return {name: counts.get(name, 0) * scale for name in _kernel_counters()}


def _case_tiles() -> tuple[int, list[int]]:
    """Tiles of the synthetic case once resampled to the plans' spacing, and
    that shape."""
    import numpy as np
    from multitalent_tpu_torch.ops.sliding_window import compute_steps_for_sliding_window
    resampled = [int(round(s * sp / t))
                 for s, sp, t in zip(CASE_SHAPE, CASE_SPACING_ZYX, SPACING_ZYX)]
    n_tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        PATCH, resampled, 0.5)]))
    return n_tiles, resampled


def _write_main_case(workdir: str) -> None:
    """The flagship model folder and one synthetic CT case under workdir."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.inference.model_restore import save_model_folder
    from multitalent_tpu_torch.io import Geometry, write_nifti

    plans = _flagship_plans()
    net = _flagship_net(plans, torch.bfloat16)
    save_model_folder(os.path.join(workdir, "model"), plans, [net.state_dict()],
                      "MultiTalent_trainer_ddp", fp16=True)
    os.makedirs(os.path.join(workdir, "in"))
    rng = np.random.default_rng(SEED)
    ct = (rng.standard_normal(CASE_SHAPE, dtype=np.float32) * 300).astype(np.int16)
    write_nifti(os.path.join(workdir, "in", "case_0000.nii.gz"), ct,
                Geometry(spacing=CASE_SPACING_ZYX[::-1]))


def phase_main_path(workdir: str, fused: bool = False) -> dict:
    """The predict CLI on the flagship case, unfused or (MTTPU_FUSED_NORM=1)
    fused; returns launch counts, seconds per case and the output folder."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti

    model = os.path.join(workdir, "model")
    if not os.path.isdir(model):
        _write_main_case(workdir)
    n_tiles, resampled = _case_tiles()
    route = "fused" if fused else "unfused"
    net = _flagship_net(_flagship_plans(), torch.bfloat16)
    per_forward = (net.fused_kernel_launches_per_forward() if fused
                   else net.kernel_launches_per_forward())
    out = os.path.join(workdir, f"out_{route}")
    os.environ["MTTPU_FUSED_NORM"] = "1" if fused else "0"
    try:
        t0 = time.perf_counter()
        timings, launches = _run_counted(lambda: main(
            ["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "--device", "cuda"]))
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MTTPU_FUSED_NORM")

    (case,) = timings
    forwards = case["forwards"]
    if forwards != n_tiles * 8:
        raise AssertionError(f"{forwards} forwards, expected {n_tiles} tiles x 8")
    expect = _expect(per_forward, forwards)
    if launches != expect or any(launches[k] == 0 for k in per_forward):
        raise AssertionError(f"{route} launches {launches}, expected {expect}")
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    if seg.shape != CASE_SHAPE or not set(np.unique(seg).tolist()) <= set(range(47)):
        raise AssertionError(f"labelmap {seg.shape} {np.unique(seg)[:5]}")
    fg = []
    for r in REGIONS:
        mask, _ = read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))
        if mask.shape != CASE_SHAPE or not set(np.unique(mask).tolist()) <= {0, 1}:
            raise AssertionError(f"region {r}: {mask.shape}")
        fg.append(float(mask.mean()))
    print(f"main path ({route}): case {CASE_SHAPE} at spacing {CASE_SPACING_ZYX} -> "
          f"resampled {tuple(resampled)}, {n_tiles} tiles x 8 mirror combos = {forwards} "
          f"forwards; labelmap + {len(fg)} region NIfTIs at {CASE_SHAPE}, foreground share "
          f"{min(fg):.3f}..{max(fg):.3f}")
    print(f"launches ({route}): { {k: v for k, v in launches.items() if v} } = per forward "
          f"{per_forward} x {forwards}")
    print(f"seconds per case ({route}): {wall:.2f} (predict {case['predict_s']:.2f}, "
          f"export {case['export_s']:.2f}; the rest loads the model and "
          f"preprocesses on the host)")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "forwards": forwards, "out": out}


def compare_masks(unfused: dict, fused: dict) -> dict:
    """Every region mask of the fused predict CLI run against the unfused
    run's, on the same case and weights."""
    import numpy as np
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    agree = []
    for r in REGIONS:
        a, _ = read_nifti(os.path.join(fused["out"], "individual", r, "case.nii.gz"))
        b, _ = read_nifti(os.path.join(unfused["out"], "individual", r, "case.nii.gz"))
        agree.append(float(np.mean(a == b)))
    worst, mean = min(agree), float(np.mean(agree))
    print(f"fused vs unfused predict CLI, region masks: worst region {worst:.6f} (bound "
          f"{MASK_AGREE_WORST}), mean {mean:.6f} (bound {MASK_AGREE_MEAN}); seconds per "
          f"case {fused['seconds_per_case']:.2f} fused vs {unfused['seconds_per_case']:.2f} "
          f"unfused (predict {fused['predict_s']:.2f} vs {unfused['predict_s']:.2f})")
    if not (worst >= MASK_AGREE_WORST and mean >= MASK_AGREE_MEAN):
        raise AssertionError(f"fused masks disagree: worst {worst}, mean {mean}")
    return {"worst": worst, "mean": mean}


def phase_tile_probabilities() -> dict:
    """One tile's sigmoid probabilities through the kernels in bf16, against
    the plain versions at the same bf16 rounding points (only summation order
    differs) and against the plain versions in fp32 (bf16 rounding too)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _flagship_plans()
    dev = torch.device("cuda")
    net = _flagship_net(plans, torch.bfloat16).to(dev).eval()
    net32 = _flagship_net(plans, torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with torch.no_grad(), _recording("conv3d_same") as a_shapes, \
            _recording("conv3d_same_dual") as b_shapes:
        logits = net(x)
    with torch.no_grad():
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        p_kernels = torch.sigmoid(logits)
        d_bf16 = (p_kernels - torch.sigmoid(net(x, use_kernels=False))).abs()
        d_fp32 = (p_kernels - torch.sigmoid(net32(x, use_kernels=False))).abs()
    out = {"bf16_max": d_bf16.max().item(), "bf16_mean": d_bf16.mean().item(),
           "fp32_max": d_fp32.max().item(), "fp32_mean": d_fp32.mean().item(),
           "a_shapes": a_shapes, "b_shapes": b_shapes}
    print(f"tile {PATCH}: |dp| kernels bf16 vs plain bf16: max {out['bf16_max']:.3e} "
          f"(bound {PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{PROB_BOUND_MEAN}); vs plain fp32: max {out['fp32_max']:.3e} "
          f"(bound {PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} "
          f"(bound {PROB_BOUND_FP32_MEAN})")
    if not (out["bf16_max"] <= PROB_BOUND and out["bf16_mean"] <= PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN):
        raise AssertionError(f"probabilities out of bounds: {out}")
    expect = net.kernel_launches_per_forward()["conv3d_same"]
    if sum(a_shapes.values()) != expect:
        raise AssertionError(f"{sum(a_shapes.values())} kernel-A calls in one forward, "
                             f"expected {expect}")
    expect = net.kernel_launches_per_forward()["conv3d_same_dual"]
    if sum(b_shapes.values()) != expect:
        raise AssertionError(f"{sum(b_shapes.values())} kernel-B calls in one forward, "
                             f"expected {expect}")
    return out


@contextlib.contextmanager
def _slope(net, slope: float):
    """Every block's LeakyReLU slope set to `slope` (a faulty activation for
    the controls of phase 4b), restored after."""
    from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
    blocks = [m for m in net.modules() if isinstance(m, ConvDropoutNormNonlin)]
    old = [b.negative_slope for b in blocks]
    for b in blocks:
        b.negative_slope = slope
    try:
        yield
    finally:
        for b, v in zip(blocks, old):
            b.negative_slope = v


def _dp(p, q) -> tuple[float, float]:
    d = (p - q).abs()
    return d.max().item(), d.mean().item()


def phase_fused_tile_probabilities() -> dict:
    """One tile through the fused forward in bf16 against its plain versions
    at the same rounding points and against the unfused plain fp32 forward;
    then the plain forward with MTTPU_PALLAS_NORM=1 (every norm on kernel E,
    no grad) against the default; each route's bounds against controls with
    a faulty activation; and one forward's time on each route."""
    import torch
    from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _flagship_plans()
    dev = torch.device("cuda")
    net = _flagship_net(plans, torch.bfloat16).to(dev).eval()
    net32 = _flagship_net(plans, torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_shapes, \
            _recording_x(fn, "channel_stats") as e_shapes:
        logits = unet_forward_fused(net, x)
    per_forward = net.fused_kernel_launches_per_forward()
    for label, shapes, expect in (("kernel-D", d_shapes, per_forward["conv3d_same_affine"]),
                                  ("kernel-E stats", e_shapes, per_forward["channel_stats"])):
        if sum(shapes.values()) != expect:
            raise AssertionError(f"{sum(shapes.values())} {label} calls in one fused forward, "
                                 f"expected {expect}")
    if logits.dtype != torch.bfloat16 or logits.shape != (1, 47, *PATCH):
        raise AssertionError(f"fused logits {logits.dtype} {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite fused logits")
    p_fused = torch.sigmoid(logits.float())
    p_fused_plain = torch.sigmoid(unet_forward_fused(net, x, use_kernels=False).float())
    with torch.no_grad():
        p_fp32 = torch.sigmoid(net32(x, use_kernels=False))
        p_default = torch.sigmoid(net(x))
    norms = sum(1 for m in net.modules() if isinstance(m, ConvDropoutNormNonlin))

    def pallas_norm_forward():
        os.environ["MTTPU_PALLAS_NORM"] = "1"
        try:
            with torch.no_grad():
                return torch.sigmoid(net(x))
        finally:
            os.environ.pop("MTTPU_PALLAS_NORM")

    p_pallas, launches = _run_counted(pallas_norm_forward)
    if launches["channel_stats"] != norms or launches["affine_lrelu"] != norms:
        raise AssertionError(f"MTTPU_PALLAS_NORM=1: launches {launches}, {norms} norms")
    out = {"d_shapes": d_shapes, "e_shapes": e_shapes}
    out["bf16_max"], out["bf16_mean"] = _dp(p_fused, p_fused_plain)
    out["fp32_max"], out["fp32_mean"] = _dp(p_fused, p_fp32)
    out["pallas_norm_max"], out["pallas_norm_mean"] = _dp(p_pallas, p_default)
    del p_fused, p_fp32, p_pallas
    controls = []
    for slope in CONTROL_SLOPES:
        with _slope(net, slope):
            fused = _dp(torch.sigmoid(unet_forward_fused(net, x).float()), p_fused_plain)
            pallas = _dp(pallas_norm_forward(), p_default)
        controls.append({"slope": slope, "fused": fused, "pallas_norm": pallas})
    out["controls"] = controls
    del p_fused_plain, p_default
    print(f"tile {PATCH}, fused route: |dp| kernels bf16 vs plain bf16: max "
          f"{out['bf16_max']:.3e} (bound {FUSED_PROB_BOUND}), mean {out['bf16_mean']:.3e} "
          f"(bound {FUSED_PROB_BOUND_MEAN}); vs unfused plain fp32: max "
          f"{out['fp32_max']:.3e} (bound {PROB_BOUND_FP32_MAX}), mean "
          f"{out['fp32_mean']:.3e} (bound {PROB_BOUND_FP32_MEAN})")
    print(f"tile {PATCH}, MTTPU_PALLAS_NORM=1 ({norms} norms on kernel E) vs the default "
          f"norm: |dp| max {out['pallas_norm_max']:.3e} (bound {PALLAS_NORM_BOUND}), mean "
          f"{out['pallas_norm_mean']:.3e} (bound {PALLAS_NORM_BOUND_MEAN})")
    for c in controls:
        print(f"control, LeakyReLU slope {c['slope']} for 1e-2 through the same kernels: "
              f"fused route |dp| max {c['fused'][0]:.3e}, mean {c['fused'][1]:.3e}; "
              f"MTTPU_PALLAS_NORM=1 |dp| max {c['pallas_norm'][0]:.3e}, mean "
              f"{c['pallas_norm'][1]:.3e}")
    if not (out["bf16_max"] <= FUSED_PROB_BOUND and out["bf16_mean"] <= FUSED_PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN
            and out["pallas_norm_max"] <= PALLAS_NORM_BOUND
            and out["pallas_norm_mean"] <= PALLAS_NORM_BOUND_MEAN):
        raise AssertionError(f"fused probabilities out of bounds: {out}")
    for c in controls:
        (f_max, f_mean), (p_max, p_mean) = c["fused"], c["pallas_norm"]
        if not ((f_max > FUSED_PROB_BOUND or f_mean > FUSED_PROB_BOUND_MEAN)
                and (p_max > PALLAS_NORM_BOUND or p_mean > PALLAS_NORM_BOUND_MEAN)):
            raise AssertionError(f"the bounds pass a faulty activation: {c}")
    with torch.no_grad():
        out["unfused_forward_ms"] = _median_ms(lambda: net(x), iters=5)
        out["fused_forward_ms"] = _median_ms(lambda: unet_forward_fused(net, x), iters=5)
    print(f"one bf16 forward of a tile: fused {out['fused_forward_ms']:.2f} ms, unfused "
          f"{out['unfused_forward_ms']:.2f} ms (median of 5, CUDA events)")
    return out


def _write_training_task(root: str, plans) -> tuple[str, str]:
    """A preprocessed MultiTalent task of two source datasets: smooth
    z-scored CT-like volumes with a liver (+ tumour) in the Task003 cases and
    a spleen in the Task009 cases, labels in the global 1..47 space and each
    case's valid regions stamped, as Task100's preprocessing leaves them."""
    import numpy as np
    from multitalent_tpu_torch.io import save_plans
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.preprocessing.preprocessor import sample_class_locations
    from multitalent_tpu_torch.utils.fileops import save_pickle
    task = "Task100_MultiTalent"
    ddir = os.path.join(root, "preprocessed", task)
    folder = os.path.join(ddir, plans.data_identifier + "_stage0")
    os.makedirs(folder)
    rng = np.random.default_rng(SEED)
    axes = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in TRAIN_CASE_SHAPE],
                       indexing="ij")
    cases = [("003", ("03_liver", "03_cancer"), (1, 2))] * 2 + [("009", ("09_spleen",), (8,))] * 2
    keys = []
    for i, (prefix, regions, labels) in enumerate(cases):
        data = np.where(sum(a * a for a in axes) < 0.8, 0.5, -1.5).astype(np.float32)
        seg = np.zeros(TRAIN_CASE_SHAPE, np.float32)
        for label in labels:
            c = rng.uniform(-0.4, 0.4, 3)
            r = rng.uniform(0.1, 0.3, 3)
            inside = sum(((a - ci) / ri) ** 2 for a, ci, ri in zip(axes, c, r)) < 1
            seg[inside] = label
            data[inside] = rng.uniform(-1, 2)
        data += rng.standard_normal(TRAIN_CASE_SHAPE, dtype=np.float32) * 0.1
        key = f"{prefix}_{i:03d}"
        np.savez(os.path.join(folder, key + ".npz"), data=np.stack([data, seg]))
        save_pickle({"class_locations": sample_class_locations(seg, list(labels)),
                     "valid_regions": regions, "valid_labels": list(labels)},
                    os.path.join(folder, key + ".pkl"))
        keys.append(key)
    save_plans(plans, os.path.join(ddir, f"{default_plans_identifier}_plans_3D.pkl"))
    save_pickle([{"train": keys, "val": keys}] * 12, os.path.join(ddir, "splits_custom.pkl"))
    return task, ddir


def _check_dw_through_kernels(trainer) -> float:
    """One training step's dw of every kernel conv, through kernel C, against
    the plain version on the same bf16 inputs (captured from the step), on the
    trainer's forward route."""
    import torch
    from multitalent_tpu_torch.ops import conv3d as cv
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    data = torch.randn(TRAIN_BATCH, 1, *PATCH, generator=gen, device=dev)
    targets = [torch.randint(0, 48, (TRAIN_BATCH, *(int(round(p * f)) for p, f in
                                                     zip(PATCH, scale))),
                             generator=gen, device=dev).float()
               for scale in trainer.deep_supervision_scales]
    valid = torch.ones(TRAIN_BATCH, 47, device=dev)
    calls = []
    single, dual = cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual

    def rec_single(x, g):
        dw = single(x, g)
        calls.append(((x,), g, dw))
        return dw

    def rec_dual(a, b, g):
        dw = dual(a, b, g)
        calls.append(((a, b), g, dw))
        return dw

    # the wrappers count launches on the module's conv3d_same_wgrad, which is
    # the recorder for this one step; the main path's counts were read already
    rec_single.launches = 0
    cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual = rec_single, rec_dual
    try:
        with _recording("conv3d_same") as a_shapes, \
                _recording("conv3d_same_dual") as b_shapes, \
                _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_shapes:
            trainer.network.zero_grad()
            loss, _ = trainer.loss_fn(trainer.network_forward(data, deep_supervision=True),
                                      targets, {"valid_region_mask": valid})
            loss.backward()
    finally:
        cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual = single, dual
    expect = trainer.network.kernel_launches_per_step()["conv3d_same_wgrad"]
    if len(calls) != expect:
        raise AssertionError(f"{len(calls)} dw calls in one backward, expected {expect}")
    worst = 0.0
    for ins, g, dw in calls:
        plain = cv.conv3d_same_wgrad_dual_ref if len(ins) == 2 else cv.conv3d_same_wgrad_ref
        ref = plain(*(t.float() for t in ins), g.float())
        scale = ref.abs().max().item()
        err = _check(f"step dw {tuple(dw.shape)}", dw, ref, DW_RTOL * scale + 1e-12)
        worst = max(worst, err / max(scale, 1e-30))
    print(f"one step's dw of all {len(calls)} kernel convs through kernel C vs the plain "
          f"version on the same bf16 inputs: worst max|d| / max|dw| {worst:.2e} "
          f"(bound {DW_RTOL})")
    shapes = collections.Counter(_dw_key(ins, g) for ins, g, _ in calls)
    return worst, shapes, a_shapes, b_shapes, d_shapes


def _dw_key(ins, g) -> tuple:
    """(input channels, Cout, spatial, N) of one kernel C call."""
    return (tuple(int(t.shape[-1]) for t in ins), int(g.shape[-1]),
            tuple(int(s) for s in g.shape[1:4]), int(g.shape[0]))


def phase_training(workdir: str, fused: bool = False) -> dict:
    """The train CLI at full flagship width, unfused or (MTTPU_FUSED_TRAIN=1)
    fused, then a prediction from the folder it wrote."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.training.trainers import init_weights_he

    plans = _flagship_plans()
    route = "fused" if fused else "unfused"
    t0 = time.perf_counter()
    task = "Task100_MultiTalent"
    if not os.path.isdir(os.path.join(workdir, "preprocessed", task)):
        task, _ = _write_training_task(workdir, plans)
    write_s = time.perf_counter() - t0
    results = os.path.join(workdir, f"results_{route}")
    os.environ.update({"nnUNet_preprocessed": os.path.join(workdir, "preprocessed"),
                       "RESULTS_FOLDER": results,
                       "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": str(TRAIN_STEPS),
                       "MTTPU_VAL_ITERS": "1", "MTTPU_FUSED_TRAIN": "1" if fused else "0"})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", "MultiTalent_trainer_ddp", task, "0", "--device", "cuda"]))
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        net = trainer.network
        if fused:
            per_step = net.fused_kernel_launches_per_step()
            per_fwd = net.fused_kernel_launches_per_forward(differentiable=True)
        else:
            per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
        steps, val = trainer.step, trainer.num_val_batches_per_epoch
        expect = {k: a + b for (k, a), b in zip(_expect(per_step, steps).items(),
                                                _expect(per_fwd, val).values())}
        if (steps != TRAIN_STEPS or launches != expect
                or any(launches[k] == 0 for k in per_step)):
            raise AssertionError(f"{route}: {steps} steps, launches {launches}, "
                                 f"expected {expect}")
        losses = trainer.all_tr_losses + trainer.all_val_losses + trainer.all_tr_ce
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite losses {losses}")
        fresh = build_unet_from_plans(plans, 0, num_classes=47)
        init_weights_he(fresh, torch.Generator().manual_seed(trainer.seed))
        trained = net.state_dict()
        still = [k for k, v in fresh.state_dict().items()
                 if k.endswith("weight") and k != "seg_outputs.0.weight"
                 and torch.equal(v, trained[k].cpu())]
        if still:
            raise AssertionError(f"weights that did not move: {still}")
        step_s = sorted(trainer.step_seconds[2:])
        median_s = step_s[len(step_s) // 2] if len(step_s) % 2 else (
            step_s[len(step_s) // 2 - 1] + step_s[len(step_s) // 2]) / 2
        print(f"training ({route}): {steps} steps of batch {TRAIN_BATCH} at {PATCH}, bf16, "
              f"DS, host patch "
              f"{tuple(int(v) for v in trainer.basic_generator_patch_size)}; losses "
              f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
              f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
        print(f"seconds per step ({route}): median {median_s:.3f} of steps 3..{steps} "
              f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
              f"{peak_gib:.2f} GiB; cases written in {write_s:.1f} s; train CLI "
              f"{train_s:.1f} s")
        print(f"training launches ({route}): { {k: v for k, v in launches.items() if v} } "
              f"= per step {per_step} x {steps} + per forward {per_fwd} x {val} "
              f"(validation)")
        dw_worst, dw_shapes, a_shapes, b_shapes, d_shapes = _check_dw_through_kernels(trainer)
        if not fused and sum(a_shapes.values()) != per_step["conv3d_same"]:
            raise AssertionError(f"{sum(a_shapes.values())} kernel-A calls in one step, "
                                 f"expected {per_step['conv3d_same']}")
        if not fused and sum(b_shapes.values()) != per_step["conv3d_same_dual"]:
            raise AssertionError(f"{sum(b_shapes.values())} kernel-B calls in one step, "
                                 f"expected {per_step['conv3d_same_dual']}")
        if fused and sum(d_shapes.values()) != per_step["conv3d_same_affine"]:
            raise AssertionError(f"{sum(d_shapes.values())} kernel-D calls in one step, "
                                 f"expected {per_step['conv3d_same_affine']}")
    finally:
        os.environ.pop("MTTPU_FUSED_TRAIN")

    model = os.path.join(results, "nnUNet", "3d_fullres", task,
                         f"MultiTalent_trainer_ddp__{default_plans_identifier}")
    out = os.path.join(workdir, f"out_trained_{route}")
    predict_main(["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
                  "--device", "cuda", "--disable_tta"])
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    masks = [read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))[0].shape
             for r in REGIONS]
    if seg.shape != CASE_SHAPE or set(masks) != {CASE_SHAPE}:
        raise AssertionError(f"trained folder predicted {seg.shape}, masks {set(masks)}")
    print(f"the trained folder ({route}) predicts: labelmap + {len(masks)} region NIfTIs "
          f"at {CASE_SHAPE}")
    return {"launches": launches, "seconds_per_step": median_s, "peak_gib": peak_gib,
            "dw_worst_rel": dw_worst, "dw_shapes": dw_shapes, "a_shapes": a_shapes,
            "b_shapes": b_shapes, "d_shapes": d_shapes}


def _bound(nbytes: float, bf16_flops: float = 0.0, fp32_flops: float = 0.0) -> dict:
    """bound_ms and what bounds it, for work of nbytes, bf16 tensor-core
    FLOPs and fp32 CUDA-core FLOPs."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _conv_bound(cin: int, cout: int, spatial, n: int, w_bytes: int = 2) -> dict:
    """A SAME 3x3x3 conv's (or its dw's) bound: 2*27*Cin*Cout FLOPs per voxel;
    bf16 input and output (or gradient) read or written once, the weight
    (or dw, w_bytes each) once."""
    vox = n * prod(spatial)
    return _bound(vox * (cin + cout) * 2 + 27 * cin * cout * w_bytes,
                  bf16_flops=2 * 27 * cin * cout * vox)


def _wgrad_step(timed: list, step_shapes: collections.Counter) -> dict:
    """Kernel C at each phase-2 shape (ms, cuDNN's bf16 wgrad ms, bound,
    write path) and the sums of both times over one training step's launches:
    each shape weighted by its launches in the step phase 5 recorded, whose
    count is kernel_launches_per_step()'s."""
    by_key = {(tuple(r["splits"]), r["cout"], tuple(r["spatial"]), r["n"]): r for r in timed}
    if not set(step_shapes) <= set(by_key):
        raise AssertionError(f"dw shapes of a step not timed in phase 2: "
                             f"{set(step_shapes) - set(by_key)}")
    shapes = [{"at": "{}->{} at {} N={}".format("+".join(map(str, key[0])), key[1],
                                                "x".join(map(str, key[2])), key[3]),
               "ms": r["ms"], "cudnn_ms": r["cudnn_bf16_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "write": r["write"],
               "launches_per_step": step_shapes.get(key, 0)} for key, r in by_key.items()]
    step = {"step_ms": sum(k * by_key[key]["ms"] for key, k in step_shapes.items()),
            "step_cudnn_ms": sum(k * by_key[key]["cudnn_bf16_ms"]
                                 for key, k in step_shapes.items())}
    print(f"kernel C over one training step ({sum(step_shapes.values())} launches, "
          f"{sum(len(key[0]) == 1 for key in step_shapes.elements())} single, "
          f"{sum(len(key[0]) == 2 for key in step_shapes.elements())} dual): "
          f"{step['step_ms']:.3f} ms, cuDNN bf16 wgrad {step['step_cudnn_ms']:.3f} ms")
    return {"shapes": shapes, **step}


@contextlib.contextmanager
def _recording(*names):
    """Counts every call of the named kernel wrappers of ops.conv3d made
    inside by (input channels of each input, Cout, spatial, N): each wrapper
    is swapped for a recorder (on which the wrappers count their launches
    meanwhile) and put back after."""
    from multitalent_tpu_torch.ops import conv3d as cv
    kernels, shapes = {name: getattr(cv, name) for name in names}, collections.Counter()

    def recorder(kernel):
        def rec(*args, **kwargs):
            pw = next(a for a in args if isinstance(a, cv.PreparedWeight))
            shapes[(pw.splits, pw.cout, tuple(int(s) for s in args[0].shape[1:4]),
                    int(args[0].shape[0]))] += 1
            return kernel(*args, **kwargs)
        rec.launches = 0
        return rec

    for name, kernel in kernels.items():
        setattr(cv, name, recorder(kernel))
    try:
        yield shapes
    finally:
        for name, kernel in kernels.items():
            setattr(cv, name, kernel)


@contextlib.contextmanager
def _recording_x(module, name: str):
    """Counts every call of wrapper `name` of `module` made inside by (C,
    spatial, N) of its channels-last input, as _recording does for the conv
    wrappers."""
    kernel, shapes = getattr(module, name), collections.Counter()

    def rec(x, *args, **kwargs):
        shapes[(int(x.shape[-1]), tuple(int(s) for s in x.shape[1:-1]), int(x.shape[0]))] += 1
        return kernel(x, *args, **kwargs)
    rec.launches = 0
    setattr(module, name, rec)
    try:
        yield shapes
    finally:
        setattr(module, name, kernel)


def _sums(label: str, timed: list, ref_key: str, **weights: collections.Counter) -> dict:
    """A kernel's phase-2 shapes (ms, `ref_key`'s ms beside it, bound, plan)
    and the sums of both over the launches of each of `weights` (e.g.
    forward=, step=: the shapes a phase recorded, each with its count)."""
    by_key = {(tuple(r["splits"]), r["cout"], tuple(r["spatial"]), r["n"]): r for r in timed}
    missing = set().union(*weights.values()) - set(by_key)
    if missing:
        raise AssertionError(f"{label} shapes of a recorded run not timed in phase 2: {missing}")
    out = {"shapes": [{"at": "{}->{} at {} N={}".format("+".join(map(str, s[0])), s[1],
                                                        "x".join(map(str, s[2])), s[3]),
                       "ms": r["ms"], ref_key: r[ref_key], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "plan": r["plan"],
                       **{f"launches_per_{k}": w.get(s, 0) for k, w in weights.items()}}
                      for s, r in by_key.items()]}
    parts = []
    for k, w in weights.items():
        out[f"{k}_ms"] = sum(c * by_key[s]["ms"] for s, c in w.items())
        out[f"{k}_{ref_key}"] = sum(c * by_key[s][ref_key] for s, c in w.items())
        batch = "/".join(str(v) for v in sorted({s[3] for s in w}))
        parts.append(f"over one {k} ({sum(w.values())} launches, N={batch}): "
                     f"{out[f'{k}_ms']:.3f} ms, {ref_key} {out[f'{k}_{ref_key}']:.3f}")
    print(f"{label} " + "; ".join(parts))
    return out


def _stats_sums(timed: list, forward: collections.Counter) -> dict:
    """Kernel E's stats pass at each phase-2 shape (single-call and queued ms,
    launches a call, bound) and the sums of both times over one fused
    forward's calls, each shape weighted by its calls phase 4b recorded."""
    by_key = {(r["c"], tuple(r["spatial"]), r["n"]): r for r in timed}
    if not set(forward) <= set(by_key):
        raise AssertionError(f"kernel-E stats shapes of a fused forward not timed in phase 2: "
                             f"{set(forward) - set(by_key)}")
    out = {"shapes": [{"at": r["what"], "ms": r["ms"], "queued_ms": r["queued_ms"],
                       "launches_per_call": r["launches_per_call"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "calls_per_forward": forward.get(key, 0)}
                      for key, r in by_key.items()],
           "forward_ms": sum(k * by_key[key]["ms"] for key, k in forward.items()),
           "forward_queued_ms": sum(k * by_key[key]["queued_ms"] for key, k in forward.items())}
    print(f"kernel E stats over one fused forward ({sum(forward.values())} calls): "
          f"{out['forward_ms']:.3f} ms single calls, {out['forward_queued_ms']:.3f} ms queued")
    return out


def phase_probe_path() -> dict:
    """The probes' entry points as a user runs them (`python -m
    multitalent_tpu_torch.probes.<name>` is each module's main), every
    kernel's launch count set to 0 just before and read just after; each
    count must equal what the probes' own arguments launch."""
    from multitalent_tpu_torch.probes import (_util, conv_cost_isolate, conv_impl_arms,
                                              grid_overhead_probe, sparse_conv_arm)
    iters = str(PROBE_ITERS)
    t0 = time.perf_counter()
    results, launches = _run_counted(lambda: {
        "conv_impl_arms": conv_impl_arms.main(["--iters", iters]),
        "sparse_conv_arm": sparse_conv_arm.main(["--iters", iters]),
        "conv_cost_isolate": conv_cost_isolate.main([iters]),
        "grid_overhead_probe": grid_overhead_probe.main([iters])})
    wall = time.perf_counter() - t0
    timed = _util.WARMUP + PROBE_ITERS  # launches of one timed configuration
    a_arms = sum(arm in ("tap", "sum") for arm in conv_impl_arms.ARMS)
    expect = _expect({}, 0)
    expect.update({
        # conv_impl_arms: each arm one parity call and one timed run (tap and
        # sum on kernel A); conv_cost_isolate's dense27 on kernel A
        "conv3d_same": a_arms * (1 + timed) + timed,
        **{k: 1 + timed for k in conv_impl_arms.kernels()},
        # sparse_conv_arm: the parity cases, then the timed shapes;
        # conv_cost_isolate's merged12
        "packed_conv3d": len(sparse_conv_arm.PARITY_CASES)
        + len(sparse_conv_arm.TIMED_CASES) * timed + timed,
        # conv_cost_isolate's center27 and center12; the grid probe's configs
        "centern": 2 * timed + len(grid_overhead_probe.CONV_CONFIGS) * timed,
        "zeros": len(grid_overhead_probe.ZERO_TILES) * timed})
    if launches != expect:
        raise AssertionError(f"probe path launches {launches}, expected {expect}")
    names = [k for k, v in expect.items() if v]
    print(f"probe path ({wall:.1f} s): launches { {k: launches[k] for k in names} } = the "
          f"probes' parity calls + {timed} per timed configuration")
    return {"launches": launches, "results": results, "seconds": wall}


def _nan_filled(shape, dev):
    """A bf16 output buffer of NaN for a checked launch: a kernel that leaves
    any of it unwritten fails its check (a fresh buffer may hold the right
    values already, left by an earlier launch in memory the caching
    allocator hands back)."""
    import torch
    return torch.full(tuple(shape), float("nan"), dtype=torch.bfloat16, device=dev)


def _nan_stats(n: int, c: int, dev):
    """Kernel D's stats buffer (n, 2, c) fp32, filled with NaN for the same
    reason."""
    import torch
    return torch.full((n, 2, c), float("nan"), dtype=torch.float32, device=dev)


def phase_probe_kernels() -> dict:
    """Each probe kernel against its plain version at the shapes its script
    times, with its bound, its median time beside the plain version's and
    the library call's where one PyTorch call computes the same function;
    the Winograd kernel also against its control (G with one row wrong),
    which must break its bound."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.probes import conv_cost_isolate as cc
    from multitalent_tpu_torch.probes import conv_impl_arms as ca
    from multitalent_tpu_torch.probes import grid_overhead_probe as gp
    from multitalent_tpu_torch.probes import sparse_conv_arm as sc
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def report(name, what, err, bound, kernel, plain, library, work, **extra):
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        library_ms = None if library is None else _median_ms(library)
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        print(f"{name} {what}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, library {lib}; bound {work['bound_ms']:.3f} ms "
              f"({work['bound_by']})" + "".join(f", {k} {v}" for k, v in extra.items()))
        rows.setdefault(name, []).append({"what": what, "err": err, "ms": ms,
                                          "plain_ms": plain_ms, "library_ms": library_ms,
                                          **work, **extra})

    # the conv arms at (2, 96, 96, 96, 120) -> 120, against the fp32 direct
    # conv on the same bf16 input with the fp32 weight
    n, sp, c = ARM_SHAPE[0], ARM_SHAPE[1:4], ARM_SHAPE[4]
    x = rnd(*ARM_SHAPE).to(torch.bfloat16)
    w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
    x32 = x.float()
    ref = cv.conv3d_same_ref(x32, w)
    bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    cudnn = lambda: F.conv3d(x_cl, w_cl, padding=1)  # noqa: E731
    work = _conv_bound(c, c, sp, n)
    for arm, name in (("tap", "conv3d_same"), ("sum", "conv3d_same"), ("im2col", "conv3d_im2col"),
                      ("tap3", "conv3d_tap3"), ("wino", "conv3d_wino")):
        pw = ca.prepare(w, arm)
        if name == "conv3d_same":
            got = ca.run_arm(arm, x, pw)
        else:
            got = ca.kernels()[name](x, pw, out=_nan_filled((*ARM_SHAPE[:4], c), dev))
        err = _check(f"{arm} arm", got, ref, bound)
        del got
        extra = {"arm": arm}
        if arm == "wino":
            faulty = ca.prepare_arm_weight(w, "wino", g=ca.G_FAULTY)
            d = (ca.conv3d_wino(x, faulty).float() - ref).abs()
            extra.update(control_max=d.max().item(), control_mean=d.mean().item())
            if not d.max().item() > bound:
                raise AssertionError(f"the Winograd bound passes a faulty G: {extra}")
            pw32 = ca.prepare_arm_weight(w, "wino", dtype=torch.float32)
            plain = lambda: ca.winograd_conv3d_ref(x32, pw32)  # noqa: E731
        else:
            plain = lambda: cv.conv3d_same_ref(x32, w)  # noqa: E731
        report(name, f"{arm} {c}->{c} at {'x'.join(map(str, sp))} N={n}", err, bound,
               lambda: ca.run_arm(arm, x, pw), plain, cudnn, work, **extra)
    del x, x32, ref, x_cl
    torch.cuda.empty_cache()

    # the packed conv at the flagship's stage 0 and stage 1
    for shape, factors in PACKED_CASES:
        c = shape[-1]
        xp = sc.space_to_depth_yx(rnd(*shape).to(torch.bfloat16), factors).contiguous()
        w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
        pw = cv.prepare_conv3d_weight(w)
        ref = sc.packed_conv3d_ref(xp.float(), w, factors)
        bound = sc.ATOL + sc.RTOL * ref.abs().max().item()
        err = _check(f"packed conv {shape} {factors}",
                     sc.packed_conv3d(xp, pw, factors, out=_nan_filled(xp.shape, dev)), ref,
                     bound)
        x_cl = sc.depth_to_space_yx(xp, factors).permute(0, 4, 1, 2, 3)
        w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        report("packed_conv3d", f"{c}->{c} at {'x'.join(map(str, shape[1:4]))} packed "
               f"{factors}", err, bound, lambda: sc.packed_conv3d(xp, pw, factors),
               lambda: sc.packed_conv3d_ref(xp.float(), w, factors), None,
               _conv_bound(c, c, shape[1:4], shape[0]),
               cudnn_unpacked_ms=round(_median_ms(lambda: F.conv3d(x_cl, w_cl, padding=1)), 4))
        del xp, ref, x_cl
    torch.cuda.empty_cache()

    # the center-view conv and the zero fill at (1, 96, 96, 96, 128); the
    # library call of centern: one einsum over the ndots weight matrices.
    # centern's function is x @ (the sum of its ndots weight matrices): its
    # bound is that one GEMM beside its bytes (x read, out written, the
    # weight read once); the ndots GEMMs the kernel issues, at the peak rate,
    # are its form's ceiling (ndots_ceiling_ms), the probe's question
    n, sp, c = PROBE_SHAPE[0], PROBE_SHAPE[1:4], PROBE_SHAPE[4]
    x = rnd(*PROBE_SHAPE).to(torch.bfloat16)
    w = rnd(c, c, 3, 3, 3, scale=0.05)
    w_bf = w.to(torch.bfloat16)
    wc = cc.prepare_center_weight(w)
    vox = n * prod(sp)
    centern_bytes = vox * 2 * c * 2 + 27 * c * c * 2
    for tile, ndots in ((cc.TILE, 27), (cc.TILE, 12), ((8, 32, 32), 27), ((8, 48, 96), 27)):
        ref = cc.centern_ref(x.float(), w_bf.float(), ndots)
        bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
        err = _check(f"centern {ndots} dots tile {tile}",
                     cc.centern(x, wc, ndots, tile, out=_nan_filled(x.shape, dev)), ref, bound)
        stack = torch.stack([w_bf[:, :, a, b, d].T for a, b, d in
                             (cc.tap_of_dot(t) for t in range(ndots))]).contiguous()
        x2 = x.reshape(-1, c)
        ceiling = _bound(centern_bytes, bf16_flops=2 * ndots * c * c * vox)["bound_ms"]
        report("centern", f"{ndots} dots at {'x'.join(map(str, sp))}x{c} tile {tile}", err,
               bound, lambda: cc.centern(x, wc, ndots, tile),
               lambda: cc.centern_ref(x.float(), w_bf.float(), ndots),
               lambda: torch.einsum("mc,tco->mo", x2, stack),
               _bound(centern_bytes, bf16_flops=2 * c * c * vox),
               grid=prod(s // t for s, t in zip(sp, tile)), ndots_ceiling_ms=round(ceiling, 4))
        del ref
    shape = (*sp, c)
    buf = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for tile in gp.ZERO_TILES:
        got = gp.zeros(shape, tile, dev, out=buf.fill_(float("nan")))
        bad = (got != 0).sum().item()
        if got.data_ptr() != buf.data_ptr() or bad:
            raise AssertionError(f"zeros tile {tile}: {bad} values are not 0")
        report("zeros", f"{'x'.join(map(str, sp))}x{c} bf16 tile {tile}", 0.0, 0.0,
               lambda: gp.zeros(shape, tile, dev), lambda: gp.zeros_ref(shape, device=dev),
               buf.zero_, _bound(prod(shape) * 2),
               grid=prod(s // t for s, t in zip(sp, tile)))
    del x, buf, got
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    name, smi, build_s = phase_device()
    kernels = phase_kernels()
    fused_kernels = phase_fused_kernels()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_path = phase_main_path(workdir)
        main_fused = phase_main_path(workdir, fused=True)
        masks = compare_masks(main_path, main_fused)
        tile = phase_tile_probabilities()
        tile_fused = phase_fused_tile_probabilities()
        training = phase_training(workdir)
        training_fused = phase_training(workdir, fused=True)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    probe_path = phase_probe_path()
    probes = phase_probe_kernels()

    a_src = "multitalent_tpu_torch/csrc/conv3d_same.cu"
    rows = []
    for kname, src, replaces, res in (
            ("conv3d_same", a_src, ("multitalent_tpu/ops/pallas_conv.py:36",
                                    "multitalent_tpu/ops/pallas_merged_conv.py:103"),
             kernels["conv3d_same"] + kernels["conv3d_same_dx"]),
            ("conv3d_same_dual", a_src, ("multitalent_tpu/ops/pallas_merged_conv.py:251",),
             kernels["conv3d_same_dual"]),
            ("conv3d_same_wgrad", "multitalent_tpu_torch/csrc/conv3d_wgrad.cu",
             ("multitalent_tpu/ops/pallas_conv.py:199",
              "multitalent_tpu/ops/pallas_merged_conv.py:587"),
             kernels["conv3d_same_wgrad"])):
        stage0 = res[0]  # the widest shape: stage 0 at 96x192x192
        wgrad = kname == "conv3d_same_wgrad"
        # one cuDNN call computes A's and C's function on the same inputs; B's
        # needs the concat built first (its cuDNN time stays as cudnn_bf16_ms)
        library_ms = None if kname == "conv3d_same_dual" else stage0["cudnn_bf16_ms"]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces[0], "also_replaces": list(replaces[1:]),
                     "launches": training["launches"][kname],
                     "launches_predict": main_path["launches"][kname],
                     "launches_train_fused": training_fused["launches"][kname],
                     "launches_probes": probe_path["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": stage0["ms"], "plain_ms": stage0["plain_ms"],
                     **_conv_bound(sum(stage0["splits"]), stage0["cout"], stage0["spatial"],
                                   stage0["n"], w_bytes=4 if wgrad else 2),
                     "library_ms": library_ms, "cudnn_bf16_ms": stage0["cudnn_bf16_ms"],
                     "timed_at": "{}->{} at {} N={}".format(
                         "+".join(map(str, stage0["splits"])), stage0["cout"],
                         "x".join(map(str, stage0["spatial"])), stage0["n"])})
    wgrad_step = _wgrad_step(kernels["conv3d_same_wgrad"], training["dw_shapes"])
    rows[-1].update(wgrad_step)
    a_sums = _sums("kernel A", kernels["conv3d_same"] + kernels["conv3d_same_dx"],
                   "cudnn_bf16_ms", forward=tile["a_shapes"], step=training["a_shapes"])
    rows[0].update(a_sums)
    b_sums = _sums("kernel B", kernels["conv3d_same_dual"], "cudnn_bf16_ms",
                   forward=tile["b_shapes"], step=training["b_shapes"])
    rows[1].update(b_sums)
    # kernel D beside the unfused route it replaces (norm + cuDNN; for the
    # dual form kernel B, no stats), over one fused forward (N=1) and one
    # fused training step's forward (N=2)
    d_sums = _sums("kernel D", fused_kernels["conv3d_same_affine"], "unfused_ms",
                   forward=tile_fused["d_shapes"], step=training_fused["d_shapes"])
    e_sums = _stats_sums(fused_kernels["channel_stats"], tile_fused["e_shapes"])
    # the fused route's kernels: launches from the fused predict CLI run (and
    # kernel D's from the fused training run), times at the stage-0 shape (N=1,
    # C = 30 at 96x192x192); one PyTorch call computes E's stats
    # (torch.var_mean) and F without its prologue (torch.mm), none the others
    c, sp = KERNEL_A_SHAPES[0]
    vox = prod(sp)
    for kname, src, replaces, work in (
            ("conv3d_same_affine", a_src, "multitalent_tpu/ops/pallas_conv.py:326",
             _conv_bound(c, c, sp, 1)),
            ("channel_stats", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:37", _stats_bound(c, sp, 1)),
            ("affine_lrelu", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:56",
             _bound(2 * vox * c * 2, fp32_flops=4 * vox * c)),
            ("seghead", "multitalent_tpu_torch/csrc/seghead.cu",
             "multitalent_tpu/ops/pallas_seghead.py:31", _head_bound(c, 47, sp, 1))):
        res = fused_kernels[kname]
        stage0 = res[0]
        if kname == "seghead":
            extra = {k: stage0[k] for k in ("queued_ms", "no_prologue_ms",
                                            "no_prologue_queued_ms", "library_queued_ms",
                                            "launches_per_call")}
        else:
            extra = {"conv3d_same_affine": d_sums, "channel_stats": e_sums}.get(kname, {})
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": main_fused["launches"][kname],
                     "launches_train_fused": training_fused["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": stage0["ms"], "plain_ms": stage0["plain_ms"], **work,
                     "library_ms": stage0.get("library_ms"),
                     "unfused_route_ms": stage0["unfused_ms"],
                     "timed_at": stage0["what"], **extra})
    # the probes' kernels: launches from the probe path, times at the first
    # shape each was timed at in phase 6
    for kname, src, replaces in (
            ("conv3d_im2col", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("conv3d_tap3", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("conv3d_wino", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("packed_conv3d", a_src, "scripts/pallas_sparse_conv_arm.py:165"),
            ("centern", "multitalent_tpu_torch/csrc/probe_kernels.cu",
             "scripts/conv_cost_isolate.py:48"),
            ("zeros", "multitalent_tpu_torch/csrc/probe_kernels.cu",
             "scripts/grid_overhead_probe.py:49")):
        res = probes[kname]
        first = res[0]
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     **({"also_replaces": ["scripts/grid_overhead_probe.py:68"],
                         "ndots_ceiling_ms": first["ndots_ceiling_ms"]}
                        if kname == "centern" else {}),
                     "launches": probe_path["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"], "timed_at": first["what"]})
    print(f"summary: build {build_s:.1f} s; seconds per case {main_path['seconds_per_case']:.2f}"
          f" unfused, {main_fused['seconds_per_case']:.2f} fused (masks: worst region "
          f"{masks['worst']:.6f}); one forward {tile_fused['unfused_forward_ms']:.2f} ms "
          f"unfused, {tile_fused['fused_forward_ms']:.2f} ms fused; seconds per training "
          f"step {training['seconds_per_step']:.3f} unfused, "
          f"{training_fused['seconds_per_step']:.3f} fused; peak {training['peak_gib']:.2f} "
          f"GiB unfused, {training_fused['peak_gib']:.2f} GiB fused; kernel A over a forward "
          f"{a_sums['forward_ms']:.3f} ms (cuDNN {a_sums['forward_cudnn_bf16_ms']:.3f} ms), over "
          f"a step {a_sums['step_ms']:.3f} ms (cuDNN {a_sums['step_cudnn_bf16_ms']:.3f} ms); "
          f"kernel B over a forward {b_sums['forward_ms']:.3f} ms (cuDNN on the concat "
          f"{b_sums['forward_cudnn_bf16_ms']:.3f} ms), over a step {b_sums['step_ms']:.3f} ms "
          f"(cuDNN on the concat {b_sums['step_cudnn_bf16_ms']:.3f} ms); kernel D over a "
          f"fused forward "
          f"{d_sums['forward_ms']:.3f} ms (unfused route {d_sums['forward_unfused_ms']:.3f} ms), "
          f"over a fused step {d_sums['step_ms']:.3f} ms; kernel E stats over a fused "
          f"forward {e_sums['forward_ms']:.3f} ms (queued {e_sums['forward_queued_ms']:.3f} "
          f"ms); kernel F {fused_kernels['seghead'][0]['ms']:.3f} ms (torch.mm of its form "
          f"without the prologue {fused_kernels['seghead'][0]['library_ms']:.3f} ms); kernel C "
          f"over a step "
          f"{wgrad_step['step_ms']:.3f} ms (cuDNN {wgrad_step['step_cudnn_ms']:.3f} ms); "
          f"probe path "
          f"{probe_path['seconds']:.1f} s; on {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
