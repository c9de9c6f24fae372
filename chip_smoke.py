"""Smoke run of the PyTorch/CUDA port (multitalent_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the card's name and power limit; build the CUDA kernels from
   multitalent_tpu_torch/csrc (one nvcc per source, in parallel) and time it;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship gives it, with the kernel's median time beside the plain
   version's (fp32, TF32 off) and cuDNN's bf16 op: A and B at the forward's
   shapes (N=1); kernel C (dw) single at A's shapes and dual at B's, and A in
   the dx role (C -> 2C channels, the dual convs' dx), at the training
   batch N=2;
3. the inference path through the user's entry point: a reference-layout
   model folder of the MultiTalent flagship (GenericUNet, base 30, pools
   (2,2,2)x4 + (1,2,2), 47 sigmoid regions, patch 96x192x192, spacing
   (1.5,1,1); seeded random weights in the reference's He init) and one
   synthetic CT larger than a patch on every axis go through
   `multitalent_tpu_torch.cli.predict_multitalent.main` with mirror TTA; the
   labelmap and all 47 region NIfTIs must exist at the input's shape, and
   each kernel's launch count must equal its launches per forward times the
   forwards run;
4. one tile's sigmoid probabilities through the kernels in bf16 against the
   plain versions, at the same bf16 rounding points and in fp32;
5. the training path through the user's entry point: synthetic preprocessed
   MultiTalent cases of two source datasets (valid regions stamped) go
   through `multitalent_tpu_torch.cli.train.main` with MultiTalent_trainer_ddp
   at full flagship width, batch 2, bf16, deep supervision, for a few steps;
   the losses must be finite, every weight must move, the A/B/C launch counts
   must equal their per-step counts times the steps (plus the validation
   forward's A/B), one step's dw of every kernel conv must match the plain
   version on the same bf16 inputs, and the written model folder must predict
   through predict_multitalent; prints seconds per step and peak memory;
6. one JSON line describing the kernels, then the result line.

It exits non-zero and prints no result without a CUDA device. It imports no JAX.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

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


def _median_ms(fn, iters: int = 10) -> float:
    import torch
    for _ in range(2):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(sorted(times)[len(times) // 2])


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

    # forward: A and B at N=1
    cases = [("conv3d_same", (c,), c, sp) for c, sp in KERNEL_A_SHAPES]
    cases += [("conv3d_same_dual", (c, c), c, sp) for c, sp in KERNEL_B_SHAPES]
    for name, splits, cout, sp in cases:
        cin = sum(splits)
        ins = [rnd(1, *sp, c).to(torch.bfloat16) for c in splits]
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
        err = _check(f"{name} {splits}->{cout} at {sp}", kernel(*ins, pw, bias), ref, bound)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w_bf.contiguous(memory_format=torch.channels_last_3d)
        report(name, splits, cout, sp, 1, err, bound,
               _median_ms(lambda: kernel(*ins, pw, bias)),
               _median_ms(lambda: plain(*ins32, w_bf.float(), bias)),
               _median_ms(lambda: F.conv3d(x_cl, w_cl, bias.to(torch.bfloat16), padding=1)))
        del ins, ins32, ref, x_cl

    # backward at the training batch: dw by kernel C (single at A's shapes,
    # dual at B's), dx of the dual convs by kernel A (C -> 2C channels)
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
        err = _check(f"conv3d_same_wgrad {splits}->{cout} at {sp}", kernel(*ins, g), ref, bound)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        g_cl = g.permute(0, 4, 1, 2, 3)
        shape = (cout, sum(splits), 3, 3, 3)
        report("conv3d_same_wgrad", splits, cout, sp, n, err, bound,
               _median_ms(lambda: kernel(*ins, g)), _median_ms(lambda: plain(*ins32, g32)),
               _median_ms(lambda: torch.nn.grad.conv3d_weight(x_cl, shape, g_cl, padding=1)))
        del ins, ins32, ref, x_cl
        if len(splits) == 2:  # dx of the dual conv: one A launch, Cout -> Ca + Cb
            w = rnd(cout, sum(splits), 3, 3, 3, scale=(2.0 / (27 * sum(splits))) ** 0.5)
            wt = w.to(torch.bfloat16).float().flip(2, 3, 4).transpose(0, 1)
            ref = cv.conv3d_same_ref(g32, wt)
            bound = ATOL + RTOL * ref.abs().max().item()
            err = _check(f"conv3d_same dx {cout}->{sum(splits)} at {sp}",
                         cv.conv3d_same_dx(g, w), ref, bound)
            wt_cl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            report("conv3d_same_dx", (cout,), sum(splits), sp, n, err, bound,
                   _median_ms(lambda: cv.conv3d_same_dx(g, w)),
                   _median_ms(lambda: cv.conv3d_same_ref(g32, wt)),
                   _median_ms(lambda: F.conv3d(g_cl, wt_cl, padding=1)))
            del ref
        del g, g32, g_cl
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


def phase_main_path(workdir: str) -> dict:
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main
    from multitalent_tpu_torch.inference.model_restore import save_model_folder
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops.sliding_window import compute_steps_for_sliding_window

    plans = _flagship_plans()
    net = _flagship_net(plans, torch.bfloat16)
    per_forward = net.kernel_launches_per_forward()
    model = os.path.join(workdir, "model")
    save_model_folder(model, plans, [net.state_dict()], "MultiTalent_trainer_ddp",
                      fp16=True)
    os.makedirs(os.path.join(workdir, "in"))
    rng = np.random.default_rng(SEED)
    ct = (rng.standard_normal(CASE_SHAPE, dtype=np.float32) * 300).astype(np.int16)
    write_nifti(os.path.join(workdir, "in", "case_0000.nii.gz"), ct,
                Geometry(spacing=CASE_SPACING_ZYX[::-1]))
    resampled = [int(round(s * sp / t))
                 for s, sp, t in zip(CASE_SHAPE, CASE_SPACING_ZYX, SPACING_ZYX)]
    n_tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        PATCH, resampled, 0.5)]))
    out = os.path.join(workdir, "out")

    cv.conv3d_same.launches = 0
    cv.conv3d_same_dual.launches = 0
    t0 = time.perf_counter()
    timings = main(["-i", os.path.join(workdir, "in"), "-o", out, "-m", model,
                    "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = {"conv3d_same": cv.conv3d_same.launches,
                "conv3d_same_dual": cv.conv3d_same_dual.launches}

    (case,) = timings
    forwards = case["forwards"]
    if forwards != n_tiles * 8:
        raise AssertionError(f"{forwards} forwards, expected {n_tiles} tiles x 8")
    for name, n in launches.items():
        expect = per_forward[name] * forwards
        if n == 0 or n != expect:
            raise AssertionError(f"{name}: {n} launches, expected {expect}")
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    if seg.shape != CASE_SHAPE or not set(np.unique(seg).tolist()) <= set(range(47)):
        raise AssertionError(f"labelmap {seg.shape} {np.unique(seg)[:5]}")
    fg = []
    for r in REGIONS:
        mask, _ = read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))
        if mask.shape != CASE_SHAPE or not set(np.unique(mask).tolist()) <= {0, 1}:
            raise AssertionError(f"region {r}: {mask.shape}")
        fg.append(float(mask.mean()))
    print(f"main path: case {CASE_SHAPE} at spacing {CASE_SPACING_ZYX} -> resampled "
          f"{tuple(resampled)}, {n_tiles} tiles x 8 mirror combos = {forwards} forwards;"
          f" labelmap + {len(fg)} region NIfTIs at {CASE_SHAPE}, foreground share "
          f"{min(fg):.3f}..{max(fg):.3f}")
    print(f"launches: {launches} = per forward {per_forward} x {forwards}")
    print(f"seconds per case: {wall:.2f} (predict {case['predict_s']:.2f}, "
          f"export {case['export_s']:.2f}; the rest loads the model and "
          f"preprocesses on the host)")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "forwards": forwards}


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
    with torch.no_grad():
        logits = net(x)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        p_kernels = torch.sigmoid(logits)
        d_bf16 = (p_kernels - torch.sigmoid(net(x, use_kernels=False))).abs()
        d_fp32 = (p_kernels - torch.sigmoid(net32(x, use_kernels=False))).abs()
    out = {"bf16_max": d_bf16.max().item(), "bf16_mean": d_bf16.mean().item(),
           "fp32_max": d_fp32.max().item(), "fp32_mean": d_fp32.mean().item()}
    print(f"tile {PATCH}: |dp| kernels bf16 vs plain bf16: max {out['bf16_max']:.3e} "
          f"(bound {PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{PROB_BOUND_MEAN}); vs plain fp32: max {out['fp32_max']:.3e} "
          f"(bound {PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} "
          f"(bound {PROB_BOUND_FP32_MEAN})")
    if not (out["bf16_max"] <= PROB_BOUND and out["bf16_mean"] <= PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN):
        raise AssertionError(f"probabilities out of bounds: {out}")
    return out


def _write_training_task(root: str, plans) -> tuple[str, str]:
    """A preprocessed MultiTalent task of two source datasets: smooth
    z-scored CT-like volumes with a liver (+ tumour) in the Task003 cases and
    a spleen in the Task009 cases, labels in the global 1..47 space and each
    case's valid regions stamped, as Task100's preprocessing leaves them."""
    import numpy as np
    from multitalent_tpu.paths import default_plans_identifier
    from multitalent_tpu.preprocessing.preprocessor import sample_class_locations
    from multitalent_tpu_torch.io import save_plans
    from multitalent_tpu.utils.fileops import save_pickle
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
    the plain version on the same bf16 inputs (captured from the step)."""
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
        trainer.network.zero_grad()
        loss, _ = trainer.loss_fn(trainer.network(data, deep_supervision=True), targets,
                                  {"valid_region_mask": valid})
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
    return worst


def phase_training(workdir: str) -> dict:
    import numpy as np
    import torch
    from multitalent_tpu.paths import default_plans_identifier
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.training.trainers import init_weights_he

    plans = _flagship_plans()
    t0 = time.perf_counter()
    task, _ = _write_training_task(workdir, plans)
    write_s = time.perf_counter() - t0
    os.environ.update({"nnUNet_preprocessed": os.path.join(workdir, "preprocessed"),
                       "RESULTS_FOLDER": os.path.join(workdir, "results"),
                       "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": str(TRAIN_STEPS),
                       "MTTPU_VAL_ITERS": "1"})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels = (cv.conv3d_same, cv.conv3d_same_dual, cv.conv3d_same_wgrad)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    trainer = train_main(["3d_fullres", "MultiTalent_trainer_ddp", task, "0",
                          "--device", "cuda"])
    train_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    net = trainer.network
    per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
    steps, val = trainer.step, trainer.num_val_batches_per_epoch
    expect = {k: per_step[k] * steps + per_fwd.get(k, 0) * val for k in per_step}
    if steps != TRAIN_STEPS or launches != expect or 0 in launches.values():
        raise AssertionError(f"{steps} steps, launches {launches}, expected {expect}")
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
    print(f"training: {steps} steps of batch {TRAIN_BATCH} at {PATCH}, bf16, DS, host patch "
          f"{tuple(int(v) for v in trainer.basic_generator_patch_size)}; losses "
          f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
          f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
    print(f"seconds per step: median {median_s:.3f} of steps 3..{steps} "
          f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
          f"{peak_gib:.2f} GiB; cases written in {write_s:.1f} s; train CLI {train_s:.1f} s")
    print(f"training launches: {launches} = per step {per_step} x {steps} + per forward "
          f"{per_fwd} x {val} (validation)")
    dw_worst = _check_dw_through_kernels(trainer)

    model = os.path.join(workdir, "results", "nnUNet", "3d_fullres", task,
                         f"MultiTalent_trainer_ddp__{default_plans_identifier}")
    out = os.path.join(workdir, "out_trained")
    predict_main(["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
                  "--device", "cuda", "--disable_tta"])
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    masks = [read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))[0].shape
             for r in REGIONS]
    if seg.shape != CASE_SHAPE or set(masks) != {CASE_SHAPE}:
        raise AssertionError(f"trained folder predicted {seg.shape}, masks {set(masks)}")
    print(f"the trained folder predicts: labelmap + {len(masks)} region NIfTIs at "
          f"{CASE_SHAPE}")
    return {"launches": launches, "seconds_per_step": median_s, "peak_gib": peak_gib,
            "dw_worst_rel": dw_worst}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    name, smi, build_s = phase_device()
    kernels = phase_kernels()
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        main_path = phase_main_path(workdir)
        phase_tile_probabilities()
        training = phase_training(workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

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
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces[0], "also_replaces": list(replaces[1:]),
                     "launches": training["launches"][kname],
                     "launches_predict": main_path["launches"].get(kname, 0),
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": stage0["ms"], "plain_ms": stage0["plain_ms"],
                     "cudnn_bf16_ms": stage0["cudnn_bf16_ms"],
                     "timed_at": "{}->{} at {} N={}".format(
                         "+".join(map(str, stage0["splits"])), stage0["cout"],
                         "x".join(map(str, stage0["spatial"])), stage0["n"])})
    print(f"summary: build {build_s:.1f} s, {main_path['seconds_per_case']:.2f} s per "
          f"case, {training['seconds_per_step']:.3f} s per training step, peak "
          f"{training['peak_gib']:.2f} GiB, on {smi}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
