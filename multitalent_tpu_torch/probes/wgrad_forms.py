"""What bounds kernel C (the 3x3x3 weight gradient) on the H100: its copies
into shared memory or its products.

Builds three forms of kernel C from `csrc/conv3d_wgrad.cu` of this package,
or of another checkout's package (`--tree`): the kernel as it is, its copies
alone (the K loop of products cut out) and its products alone (the copies cut
out: the products run on whatever shared memory holds). Each form is the
source patched as text and built by nvcc into a library of its own under
`_build/wgrad_forms/`; the three are timed side by side at kernel C's eleven
shapes of a flagship training step (N=2: single at kernel A's shapes, dual
at kernel B's, as chip_smoke's phase 2), each as a single call's median and
as a call queued behind others (the card's time, the host's cost hidden).
Where copies and products overlap, the whole takes less than their sum.

    python -m multitalent_tpu_torch.probes.wgrad_forms [--tree DIR] [--out JSON]

The cut forms compute wrong dw; the whole form is checked against the plain
version. `--device cpu` only checks that the source takes both patches: the
forms exist only as CUDA builds.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from pathlib import Path

import torch

from multitalent_tpu_torch import _build
from multitalent_tpu_torch.probes import _util

FORMS = ("whole", "copies", "products")
# (input channels, Cout, spatial) of kernel C's launches in a flagship step
SHAPES = ([((c,), c, sp) for c, sp in ((30, (96, 192, 192)), (60, (48, 96, 96)),
                                        (120, (24, 48, 48)), (240, (12, 24, 24)),
                                        (320, (6, 12, 12)), (320, (6, 6, 6)))]
          + [((c, c), c, sp) for c, sp in ((30, (96, 192, 192)), (60, (48, 96, 96)),
                                           (120, (24, 48, 48)), (240, (12, 24, 24)),
                                           (320, (6, 12, 12)))])
BATCH = 2
DW_RTOL = 1e-3  # the whole form against the plain version (chip_smoke's bound)
QUEUED = 20     # calls between the events of a queued timing
K_LOOP = "for (int ks = 0; ks < BM / 16; ++ks) {"
# the kernel's two copy calls (x halo and g box), e.g. `load_lines<NWARPS>(`
COPY_CALL = re.compile(r"^(\s*)(load_\w+<\w+>\()", re.M)
ENTRIES = ("mt_conv3d_wgrad", "mt_conv3d_wgrad_dual", "mt_conv3d_wgrad_workspace")


def form_source(text: str, form: str) -> str:
    """Kernel C's source as `form`; raises where the source has not the one
    K loop and two copy calls the patches cut."""
    if form == "whole":
        return text
    if form == "copies":
        if text.count(K_LOOP) != 1:
            raise ValueError(f"expected one `{K_LOOP}` in kernel C's source")
        return text.replace(K_LOOP, "for (int ks = 0; ks < 0; ++ks) {")
    if form == "products":
        patched, n = COPY_CALL.subn(r"\1if (false) \2", text)
        if n != 2:
            raise ValueError(f"expected kernel C's two copy calls, found {n}")
        return patched
    raise ValueError(f"unknown form {form!r}")


def build_forms(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The three forms of csrc/conv3d_wgrad.cu, built in parallel (once per
    source text) and loaded."""
    text = (csrc / "conv3d_wgrad.cu").read_text()
    key = hashlib.sha256((" ".join(_build.NVCC_FLAGS) + text
                          + (csrc / "common.cuh").read_text()).encode()).hexdigest()[:16]
    out = _build.BUILD_DIR / "wgrad_forms" / key
    out.mkdir(parents=True, exist_ok=True)
    nvcc, procs, libs = _build.find_nvcc(), [], {}
    for form in FORMS:
        lib = out / f"libwgrad_{form}.so"
        libs[form] = lib
        if lib.is_file():
            continue
        src = out / f"conv3d_wgrad_{form}.cu"
        src.write_text(form_source(text, form))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-shared", "-o", str(lib), str(src)]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True)))
    _build._run(procs)
    loaded = {}
    for form, path in libs.items():
        lib = ctypes.CDLL(str(path))
        for name in ENTRIES:
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = _build._SIGNATURES[name]
        loaded[form] = lib
    return loaded


def _launcher(lib: ctypes.CDLL, ins: list[torch.Tensor], g: torch.Tensor):
    """A call of `lib`'s kernel C on ins and g into a new dw (returned by
    each call), with the workspace the library asks for."""
    n, z, y, xd = (int(s) for s in g.shape[:4])
    cs, cout = [int(t.shape[-1]) for t in ins], int(g.shape[-1])
    dw = torch.empty((cout, sum(cs), 3, 3, 3), dtype=torch.float32, device=g.device)
    nbytes = lib.mt_conv3d_wgrad_workspace(n, z, y, xd, cs[0], sum(cs[1:]), cout)
    ws = torch.empty(max(nbytes, 4) // 4, dtype=torch.float32, device=g.device)

    def call() -> torch.Tensor:
        stream = torch.cuda.current_stream(g.device).cuda_stream
        if len(ins) == 1:
            code = lib.mt_conv3d_wgrad(ins[0].data_ptr(), g.data_ptr(), dw.data_ptr(),
                                       ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cout, stream)
        else:
            code = lib.mt_conv3d_wgrad_dual(ins[0].data_ptr(), ins[1].data_ptr(),
                                            g.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                                            nbytes, n, z, y, xd, cs[0], cs[1], cout, stream)
        if code:
            raise RuntimeError(f"kernel C failed: CUDA error {code}")
        return dw
    return call, nbytes


def queued_ms(fn, calls: int = QUEUED) -> float:
    """ms a call of fn with `calls` calls queued back to back."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None) -> dict:
    from multitalent_tpu_torch.ops.conv3d import conv3d_same_wgrad_dual_ref as dual_ref
    from multitalent_tpu_torch.ops.conv3d import conv3d_same_wgrad_ref as single_ref
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", default=str(Path(__file__).resolve().parents[2]),
                        help="checkout whose multitalent_tpu_torch/csrc to build")
    parser.add_argument("--out", help="write the times as JSON to this file")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    csrc = Path(args.tree) / "multitalent_tpu_torch" / "csrc"
    device = _util.resolve_device(args.device)
    if device.type == "cpu":
        text = (csrc / "conv3d_wgrad.cu").read_text()
        for form in FORMS:
            form_source(text, form)
        print(f"plain run on the CPU: {csrc / 'conv3d_wgrad.cu'} takes both patches "
              "(the forms are timed on the card only)")
        return {}
    libs = build_forms(csrc)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = []
    for splits, cout, sp in SHAPES:
        ins = [torch.randn(BATCH, *sp, c, generator=gen, device=device).to(torch.bfloat16)
               for c in splits]
        g = torch.randn(BATCH, *sp, cout, generator=gen, device=device).to(torch.bfloat16)
        row = {"splits": list(splits), "cout": cout, "spatial": list(sp), "n": BATCH}
        for form, lib in libs.items():
            call, nbytes = _launcher(lib, ins, g)
            if form == "whole":
                plain = single_ref if len(ins) == 1 else dual_ref
                ref = plain(*(t.float() for t in ins), g.float())
                err = (call() - ref).abs().max().item()
                if not err <= DW_RTOL * ref.abs().max().item():
                    raise AssertionError(f"kernel C at {splits}->{cout} {sp}: max|d| {err}")
                row["workspace_bytes"] = nbytes
                del ref
            row[f"{form}_ms"] = _util.median_ms(call)
            row[f"{form}_queued_ms"] = queued_ms(call)
        print("{}->{} at {} N={}: whole {:.3f} ({:.3f} queued), copies {:.3f} ({:.3f}), "
              "products {:.3f} ({:.3f}) ms".format(
                  "+".join(map(str, splits)), cout, "x".join(map(str, sp)), BATCH,
                  *(row[f"{f}{q}"] for f in FORMS for q in ("_ms", "_queued_ms"))))
        rows.append(row)
        del ins, g
        torch.cuda.empty_cache()
    result = {"tree": str(Path(args.tree).resolve()), "device": torch.cuda.get_device_name(0),
              "shapes": rows}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    return result


if __name__ == "__main__":
    main()
