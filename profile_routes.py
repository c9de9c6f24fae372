"""Device time by kernel family on the unfused and the fused route of the
PyTorch/CUDA port, for one flagship training step and one inference forward,
the same for the SwinUNETR, and one fp32 training step of the Task003 Liver
network.

    python3 profile_routes.py [--routes all|fp32|forward] [--out PROFILE.json]

The flagship network of chip_smoke.py (full width, seeded random weights, bf16)
runs on one CUDA card under torch.profiler: one forward + backward at batch 2
with deep supervision and the MultiTalent loss (no optimizer), and one forward
of a 96x192x192 tile at batch 1, each after two untimed warm-up runs; then
the SwinUNETR of chip_smoke.py phase 11 (feature_size 48, the trainers'
init, bf16) the same way, its one output at loss weight 1. It prints the
wall time, the summed device time of the kernels and its idle
share, the device time per family (the hand-written kernels A-F, cuBLAS
GEMMs (the SwinUNETR's attention and Dense layers, 1x1x1 convs), softmax,
cuDNN convs, PyTorch's elementwise, reduction and copy kernels) and the longest
kernels, then the tile forward's time by CUDA events (single calls and
queued); then the fp32 route: nnUNetTrainerV2_fp32's network on the Liver
plans of chip_smoke.py (base 32, pools 5 x (2, 2, 2), 128^3, 3 classes,
fp32, seeded He init) at batch 2, one forward + backward with deep
supervision and the DC + CE loss, its device time split into the fp32
forms of A, B and D (the ring body, or the staged body where a checkout
still runs it), C (its wgrad ring body, or the staged wgrad kernel of an
older checkout), cuDNN and PyTorch's kernels, once with cuDNN's convs in
full fp32 (chip_smoke.py's 14b runs after 14a turned TF32 off) and once
at PyTorch's default, TF32 on for cuDNN's convs; then the same step on
the fused route (the forward through D, E and F, as MTTPU_FUSED_TRAIN=1
trains), TF32 off (`--routes fp32` profiles these steps only;
`--routes forward` the flagship's tile forward on both routes only, with
every launch of the hand-written kernels listed by name, for comparing two
checkouts in turns). --out writes the same as JSON. It takes the package and
chip_smoke from its own directory, so a copy of it in another checkout
profiles that checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _template_args(name: str, kernel: str) -> list[str] | None:
    """The template arguments of kernel<...> in a profiled name (None: not
    that kernel)."""
    if f"{kernel}<" not in name:
        return None
    return [a.strip() for a in name.split(f"{kernel}<", 1)[1].split(">", 1)[0].split(",")]


def _fp32_ring(name: str, form: str) -> bool:
    """conv_fp32_ring_kernel<DUAL[, AFFINE, STATS]> serving `form`: "A" (no
    switch), "B" (DUAL alone) or "D" (AFFINE or STATS); an older checkout's
    kernel has DUAL only."""
    args = _template_args(name, "conv_fp32_ring_kernel")
    if args is None:
        return False
    dual, affine, stats = ([a == "true" for a in args] + [False, False])[:3]
    if form == "D":
        return affine or stats
    return not (affine or stats) and dual == (form == "B")


def _is_kernel_d(name: str) -> bool:
    """Kernel D on any body: conv3d_h_kernel<BN, NIN, STATS> (the wgmma body)
    with the stats set (D's dual form), an older checkout's
    conv3d_same_kernel<NIN, BN, STATS, PACKED> with the stats set, or
    conv3d_a_kernel<BN, G, RESIDENT, KSPLIT, NIN, AFFINE, STATS> with the
    prologue or the stats set."""
    for body, flags in (("conv3d_h_kernel<", slice(2, 3)), ("conv3d_same_kernel<", slice(2, 3)),
                        ("conv3d_a_kernel<", slice(5, 7))):
        if body in name:
            args = name.split(body, 1)[1].split(">", 1)[0].split(",")
            return any(a.strip() == "true" for a in args[flags])
    return False


FAMILIES = [
    # the fp32 forms (csrc/conv3d_fp32.cu): A, B and D on the ring body by
    # its template switches, C on the wgrad ring body, the split partials'
    # reduce (A, B, D's K splits, C's voxel splits); an older checkout's
    # staged bodies: A and B on conv_fp32_kernel<false, false>, D's on
    # conv_fp32_kernel with the stats set, C's wgrad_fp32_kernel and its
    # reduce
    ("A fp32 (ring body)", lambda n: _fp32_ring(n, "A")),
    ("B fp32 (ring body)", lambda n: _fp32_ring(n, "B")),
    ("D fp32 (ring body)", lambda n: _fp32_ring(n, "D")),
    ("C fp32 (wgrad ring body)", lambda n: "wgrad_fp32_ring_kernel" in n),
    ("fp32 split reduce (A, B, C, D)", lambda n: "conv_fp32_reduce_kernel" in n),
    ("A/B fp32 (staged body)", lambda n: "conv_fp32_kernel<false, false>" in n),
    ("D fp32 (staged body)", lambda n: "conv_fp32_kernel<" in n),
    ("C fp32 (staged wgrad)", lambda n: "wgrad_fp32_kernel" in n
     or "wgrad_fp32_reduce_kernel" in n),
    ("kernel D (conv3d_same_affine)", _is_kernel_d),
    # the ring body (conv3d_a_kernel), the wgmma body (conv3d_h_kernel) and
    # the older body: A and B
    ("kernels A/B", lambda n: any(k in n for k in ("conv3d_same_kernel", "conv3d_a_kernel",
                                                   "conv3d_h_kernel"))),
    ("kernel C (wgrad)", lambda n: "conv3d_wgrad" in n or "wgrad_reduce" in n),
    # the split-K reduces: A's and B's; D's with its stats (splitk_stats_kernel)
    ("split-K reduce (A, B, D)", lambda n: "splitk_reduce" in n or "splitk_stats" in n),
    ("E stats + stats reduce (D, E)", lambda n: "channel_stats" in n or "reduce_rows" in n),
    ("kernel E apply", lambda n: "affine_lrelu" in n),
    ("kernel F", lambda n: "seghead" in n),
    # cuBLAS's GEMM kernels, not cuDNN's implicit-GEMM convs
    ("GEMMs (attention, Dense, 1x1x1 convs)", lambda n: "gemm" in n.lower() and not any(
        k in n.lower() for k in ("implicit", "fprop", "dgrad", "wgrad", "conv"))),
    ("softmax", lambda n: "softmax" in n.lower()),
    ("cuDNN / cutlass convs", lambda n: any(k in n.lower() for k in
                                            ("cudnn", "xmma", "implicit", "conv", "sm90",
                                             "cutlass", "dgrad", "wgrad_"))),
    ("reductions", lambda n: "reduce" in n.lower()),
    ("copies and casts", lambda n: "copy" in n.lower()),
    ("elementwise", lambda n: "elementwise" in n.lower()),
]


def family(name: str) -> str:
    for fam, pred in FAMILIES:
        if pred(name):
            return fam
    return "other"


def _device_rows(prof) -> list[tuple[str, float, int]]:
    """(kernel name, device ms, calls) of every kernel the profile saw."""
    rows = []
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0)
        if t and "CUDA" in str(getattr(e, "device_type", "")):
            rows.append((e.key, t / 1000.0, e.count))
    return rows


# the families of the hand-written kernels (rows listed by name with
# `every_kernel`)
OWN_FAMILIES = ("kernel D (conv3d_same_affine)", "kernels A/B", "split-K reduce (A, B, D)",
                "E stats + stats reduce (D, E)", "kernel E apply", "kernel F")


def profile_run(label: str, fn, warm: int = 2, every_kernel: bool = False) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1000
    rows = _device_rows(prof)
    total = sum(r[1] for r in rows)
    if total <= 0:
        raise RuntimeError(f"{label}: the profile holds no device time")
    fams: dict[str, float] = {}
    for name, ms, _ in rows:
        fams[family(name)] = fams.get(family(name), 0.0) + ms
    top = sorted(rows, key=lambda r: -r[1])[:12]
    print(f"== {label}: wall {wall:.1f} ms, device kernels {total:.1f} ms, idle "
          f"{max(0.0, 1 - total / wall) * 100:.1f}%")
    for fam, ms in sorted(fams.items(), key=lambda kv: -kv[1]):
        print(f"   {fam:34s} {ms:8.2f} ms {ms / total * 100:5.1f}%")
    for name, ms, count in top:
        print(f"   top: {ms:8.2f} ms x{count:4d}  {name[:110]}")
    own = sorted((r for r in rows if family(r[0]) in OWN_FAMILIES), key=lambda r: -r[1])
    if every_kernel:
        for name, ms, count in own:
            print(f"   kernel: {ms:8.3f} ms x{count:4d}  {name[:110]}")
    return {"wall_ms": wall, "device_ms": total, "families": fams,
            "top": [(n[:200], ms, c) for n, ms, c in top],
            "own_kernels": [(n[:200], ms, c) for n, ms, c in own]}


FORWARD_ITERS = 20


def time_forward(fn) -> dict:
    """fn's time on the card by CUDA events: the median over FORWARD_ITERS
    single calls (each synchronised) and the mean over FORWARD_ITERS calls
    queued back to back. A tile forward leaves the card idle 13-33% of its
    wall time, so both read the host's launch cadence too; five single calls
    spread by up to 1 ms between runs of the same code."""
    import torch

    def events():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    fn()
    torch.cuda.synchronize()
    single = []
    for _ in range(FORWARD_ITERS):
        start, end = events()
        start.record()
        fn()
        end.record()
        end.synchronize()
        single.append(start.elapsed_time(end))
    start, end = events()
    start.record()
    for _ in range(FORWARD_ITERS):
        fn()
    end.record()
    end.synchronize()
    return {"events_ms": sorted(single)[len(single) // 2],
            "queued_ms": start.elapsed_time(end) / FORWARD_ITERS}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="write the profiles as JSON to this file")
    parser.add_argument("--routes", choices=("all", "fp32", "forward"), default="all",
                        help="every route, the fp32 Liver step only, or the flagship's tile "
                             "forward on both routes only")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_routes: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    out = {"device": smi}
    if args.routes == "forward":
        out.update(flagship_and_swin(dev, forward_only=True))
    else:
        if args.routes == "all":
            out.update(flagship_and_swin(dev))
        out["step_fp32"] = fp32_step(dev)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


def fp32_step(dev) -> dict:
    """One fp32 forward + backward of the Liver network at batch 2 (see the
    module docstring) under torch.profiler, unfused (TF32 off and at the
    default) and fused (TF32 off)."""
    import torch
    from chip_smoke import LIVER_CLASSES, LIVER_PATCH, SEED, _liver_plans
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    from multitalent_tpu_torch.training.losses import (dc_and_ce_loss, deep_supervision_loss,
                                                       ds_loss_weights)
    torch.manual_seed(SEED)
    net = build_unet_from_plans(_liver_plans(), 0, num_classes=LIVER_CLASSES,
                                dtype=torch.float32).to(dev)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            torch.nn.init.kaiming_normal_(m.weight, a=1e-2)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.randn(2, 1, *LIVER_PATCH, generator=gen, device=dev)
    targets = [torch.randint(0, LIVER_CLASSES, (2, *(p >> i for p in LIVER_PATCH)),
                             generator=gen, device=dev) for i in range(net.num_pool)]
    weights = [float(w) for w in ds_loss_weights(net.num_pool)]

    def step(fused: bool = False):
        net.zero_grad(set_to_none=True)
        outs = (unet_forward_fused(net, x, deep_supervision=True, differentiable=True)
                if fused else net(x, deep_supervision=True))
        loss = deep_supervision_loss(outs, targets, dc_and_ce_loss, weights)
        loss.backward()

    result = {}
    # cuDNN's convs (the strided, transposed and first convs and their
    # gradients) in full fp32, as chip_smoke.py's 14b runs them after 14a
    # turned TF32 off, then at PyTorch's default (TF32 on for cuDNN's
    # convs), as a user's `cli.train --fp32` runs them; the hand-written
    # fp32 forms are FFMA either way
    for key, tf32 in (("cudnn_tf32_off", False), ("cudnn_tf32_default", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        torch.cuda.reset_peak_memory_stats()
        result[key] = profile_run("fp32 Liver training step (forward + backward, no "
                                  f"optimizer), batch 2, cuDNN allow_tf32={tf32}", step)
        result[key]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        print(f"   peak {result[key]['peak_gib']:.2f} GiB")
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    result["fused_tf32_off"] = profile_run(
        "fp32 Liver training step on the fused route (forward through D, E, F; backward), "
        "batch 2, cuDNN allow_tf32=False", lambda: step(fused=True))
    result["fused_tf32_off"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"   peak {result['fused_tf32_off']['peak_gib']:.2f} GiB")
    del net
    torch.cuda.empty_cache()
    return result


def flagship_and_swin(dev, forward_only: bool = False) -> dict:
    """The flagship's bf16 step and forward on both routes, then the
    SwinUNETR's; `forward_only`: the flagship's forward on both routes,
    every hand-written kernel listed."""
    import torch
    from chip_smoke import PATCH, SEED, _flagship_net, _flagship_plans, _swin_net
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    from multitalent_tpu_torch.training.losses import (ds_loss_weights, label_region_matrix,
                                                       multitalent_ds_loss)
    net = _flagship_net(_flagship_plans(), torch.bfloat16).to(dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x2 = torch.randn(2, 1, *PATCH, generator=gen, device=dev)
    x1 = x2[:1].contiguous()
    # the deep-supervision outputs: full resolution, then halved per level
    scales = [tuple(0.5 ** i for _ in range(3)) for i in range(net.num_pool)]
    targets = [torch.randint(0, 48, (2, *(int(round(p * f)) for p, f in zip(PATCH, s))),
                             generator=gen, device=dev).float() for s in scales]
    valid = torch.ones(2, 47, device=dev)
    lrm = torch.from_numpy(label_region_matrix()).to(dev)
    weights = [float(w) for w in ds_loss_weights(net.num_pool)]
    out = {}
    for route in ("unfused", "fused"):
        def fwd(x, ds, route=route):
            if route == "fused":
                return unet_forward_fused(net, x, deep_supervision=ds, differentiable=ds)
            return net(x, deep_supervision=ds)

        def step():
            net.zero_grad(set_to_none=True)
            loss, _, _ = multitalent_ds_loss(fwd(x2, True), targets, valid, lrm, weights)
            loss.backward()

        def forward():
            with torch.no_grad():
                fwd(x1, False)

        if not forward_only:
            torch.cuda.reset_peak_memory_stats()
            out[f"step_{route}"] = profile_run(
                f"training step (forward + backward, no optimizer), {route}", step)
            out[f"step_{route}"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"forward_{route}"] = profile_run(f"inference forward, {route}", forward,
                                              every_kernel=forward_only)
        timed = time_forward(forward)
        out[f"forward_{route}"].update(timed)
        print(f"   CUDA events, {FORWARD_ITERS} forwards: median {timed['events_ms']:.3f} ms a "
              f"single forward, {timed['queued_ms']:.3f} ms a forward queued back to back")
    del net
    torch.cuda.empty_cache()
    if forward_only:
        return out
    swin = _swin_net(dtype=torch.bfloat16).to(dev)

    def swin_step():
        swin.zero_grad(set_to_none=True)
        loss, _, _ = multitalent_ds_loss(swin(x2, deep_supervision=True), targets[:1], valid,
                                         lrm, [1.0])
        loss.backward()

    def swin_forward():
        with torch.no_grad():
            swin(x1)

    torch.cuda.reset_peak_memory_stats()
    out["step_swin"] = profile_run("SwinUNETR training step (forward + backward, no optimizer)",
                                   swin_step)
    out["step_swin"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    out["forward_swin"] = profile_run("SwinUNETR inference forward", swin_forward)
    timed = time_forward(swin_forward)
    out["forward_swin"].update(timed)
    print(f"   CUDA events, {FORWARD_ITERS} forwards: median {timed['events_ms']:.3f} ms a "
          f"single forward, {timed['queued_ms']:.3f} ms a forward queued back to back; step "
          f"peak {out['step_swin']['peak_gib']:.2f} GiB")
    del swin
    torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(main())
