"""Device time by kernel family on the unfused and the fused route of the
PyTorch/CUDA port, for one flagship training step and one inference forward.

    python3 profile_routes.py [--out PROFILE.json]

The flagship network of chip_smoke.py (full width, seeded random weights, bf16)
runs on one CUDA card under torch.profiler: one forward + backward at batch 2
with deep supervision and the MultiTalent loss (no optimizer), and one forward
of a 96x192x192 tile at batch 1, each after two untimed warm-up runs. It
prints the wall time, the summed device time of the kernels and its idle
share, the device time per family (the hand-written kernels A-F, cuDNN
convs, PyTorch's elementwise, reduction and copy kernels) and the longest
kernels, then the tile forward's time by CUDA events (single calls and
queued); --out writes the same as JSON. It takes the package and chip_smoke
from its own directory, so a copy of it in another checkout profiles that
checkout.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time


def _is_kernel_d(name: str) -> bool:
    """Kernel D on either body: conv3d_same_kernel<NIN, BN, STATS, PACKED>
    with the stats set (D's dual form), or conv3d_a_kernel<BN, G, RESIDENT,
    KSPLIT, NIN, AFFINE, STATS> with the prologue or the stats set."""
    for body, flags in (("conv3d_same_kernel<", slice(2, 3)), ("conv3d_a_kernel<", slice(5, 7))):
        if body in name:
            args = name.split(body, 1)[1].split(">", 1)[0].split(",")
            return any(a.strip() == "true" for a in args[flags])
    return False


FAMILIES = [
    ("kernel D (conv3d_same_affine)", _is_kernel_d),
    # the ring body (conv3d_a_kernel) and the older body: A and B
    ("kernels A/B", lambda n: "conv3d_same_kernel" in n or "conv3d_a_kernel" in n),
    ("kernel C (wgrad)", lambda n: "wgrad" in n),
    ("split-K reduce (A, D)", lambda n: "splitk_reduce" in n),
    ("E stats + stats reduce (D, E)", lambda n: "channel_stats" in n or "reduce_rows" in n),
    ("kernel E apply", lambda n: "affine_lrelu" in n),
    ("kernel F", lambda n: "seghead" in n),
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


def profile_run(label: str, fn, warm: int = 2) -> dict:
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
    return {"wall_ms": wall, "device_ms": total, "families": fams,
            "top": [(n[:200], ms, c) for n, ms, c in top]}


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
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_routes: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import PATCH, SEED, _flagship_net, _flagship_plans
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    from multitalent_tpu_torch.training.losses import (ds_loss_weights, label_region_matrix,
                                                       multitalent_ds_loss)
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
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
    out = {"device": smi}
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

        torch.cuda.reset_peak_memory_stats()
        out[f"step_{route}"] = profile_run(
            f"training step (forward + backward, no optimizer), {route}", step)
        out[f"step_{route}"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out[f"forward_{route}"] = profile_run(f"inference forward, {route}", forward)
        timed = time_forward(forward)
        out[f"forward_{route}"].update(timed)
        print(f"   CUDA events, {FORWARD_ITERS} forwards: median {timed['events_ms']:.3f} ms a "
              f"single forward, {timed['queued_ms']:.3f} ms a forward queued back to back")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
