"""Builds the package's CUDA kernels at first use and binds them with ctypes.

`nvcc` compiles every `csrc/*.cu` to an object file, all sources at once in
parallel processes, and links them into one shared library with a plain C
interface under `_build/`, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the library already there.
Nothing here runs at import time: the library is built by the first call of
`library()`, which only happens when a kernel is launched on a CUDA tensor.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    # n, z, y, x, ca, cb, cout, coutp, bn -> workspace bytes (-1: bad sizes)
    "mt_conv3d_workspace": ([_I] * 9, _L),
    # the same, and the body the launch runs into body[0] (0 ring, 1 wgmma)
    "mt_conv3d_launch_plan": ([_I] * 9 + [ctypes.POINTER(_I)], _L),
    # form (0 A, 1 B, 2 D, 3 D dual, 4 packed), n, z, y, x, ca, cb, cout, coutp,
    # bn, plan[14] -> 0 (-1: bad sizes)
    "mt_conv3d_same_plan": ([_I] * 10 + [ctypes.POINTER(_I)], _I),
    # the wgmma body alone: a, b, w, bias, out, ws, ws_bytes, n, z, y, x, ca,
    # cb, cout, coutp, mode (0 whole, 1 copies only, 2 products only), stream
    "mt_conv3d_wgmma": ([_P] * 6 + [_L] + [_I] * 9 + [_P], _I),
    # one wgmma of its staging: x, w, out, z, y, x, c, coutp, n, tap, plane,
    # z0, y0, x0, stream
    "mt_wgmma_probe": ([_P] * 3 + [_I] * 11 + [_P], _I),
    # x, w, bias, out, ws, ws_bytes, n, z, y, x, cin, cout, coutp, bn, stream
    "mt_conv3d_same": ([_P, _P, _P, _P, _P, _L] + [_I] * 8 + [_P], _I),
    # a, b, w, bias, out, ws, ws_bytes, n, z, y, x, ca, cb, cout, coutp, bn,
    # stream
    "mt_conv3d_same_dual": ([_P, _P, _P, _P, _P, _P, _L] + [_I] * 9 + [_P], _I),
    # the fp32 forms of A and B on the ring body (b null for A): a, b, w,
    # bias, out, ws, ws_bytes, n, z, y, x, ca, cb, cout, coutp, then the plan
    # (ops/conv3d.py:conv3d_same_fp32_plan): bz, by, bx, splits, resident,
    # stages, grid_p, and mode (0 whole, 1 copies only, 2 products only), stream
    "mt_conv3d_same_fp32": ([_P] * 6 + [_L] + [_I] * 16 + [_P], _I),
    # n, z, y, x, ca, cb, cout -> C's fp32 form's workspace bytes on the
    # current card (-1: bad sizes)
    "mt_conv3d_wgrad_fp32_workspace": ([_I] * 7, _L),
    # C's fp32 form (b null for the single form): a, b, g, dw, ws, ws_bytes,
    # n, z, y, x, ca, cb, cout, then the plan
    # (ops/conv3d.py:conv3d_same_wgrad_fp32_plan): bz, by, bx, splits, grid,
    # stages, and mode (0 whole, 1 copies only, 2 products only), stream
    "mt_conv3d_wgrad_fp32": ([_P] * 5 + [_L] + [_I] * 14 + [_P], _I),
    # n, z, y, x, ca, cb, cout -> workspace bytes (-1: bad sizes)
    "mt_conv3d_wgrad_workspace": ([_I] * 7, _L),
    # x, g, dw, ws, ws_bytes, n, z, y, x, cin, cout, stream
    "mt_conv3d_wgrad": ([_P, _P, _P, _P, _L] + [_I] * 6 + [_P], _I),
    # a, b, g, dw, ws, ws_bytes, n, z, y, x, ca, cb, cout, stream
    "mt_conv3d_wgrad_dual": ([_P, _P, _P, _P, _P, _L] + [_I] * 7 + [_P], _I),
    # n, z, y, x, ca, cb, cout, coutp, bn -> kernel D's workspace bytes
    "mt_conv3d_stats_workspace": ([_I] * 9, _L),
    # the same, and the body the launch runs into body[0] (0 ring, 1 wgmma)
    "mt_conv3d_stats_launch_plan": ([_I] * 9 + [ctypes.POINTER(_I)], _L),
    # x, w, bias, scale, shift, slope, out, stats, ws, ws_bytes, n, z, y, x,
    # cin, cout, coutp, bn, stream
    "mt_conv3d_same_affine": ([_P] * 5 + [_F] + [_P] * 3 + [_L] + [_I] * 8 + [_P], _I),
    # a, b, w, bias, out, stats, ws, ws_bytes, n, z, y, x, ca, cb, cout,
    # coutp, bn, stream
    "mt_conv3d_same_dual_stats": ([_P] * 7 + [_L] + [_I] * 9 + [_P], _I),
    # kernel D's fp32 form on the ring body: a, b, w, bias, scale, shift,
    # slope, out, stats, ws, ws_bytes, n, z, y, x, ca, cb, cout, coutp, then
    # the plan (ops/conv3d.py:conv3d_same_fp32_plan(..., stats=True)) as
    # mt_conv3d_same_fp32's, mode, stream
    "mt_conv3d_same_affine_fp32": ([_P] * 6 + [_F] + [_P] * 3 + [_L] + [_I] * 16 + [_P],
                                   _I),
    # n, s, c -> kernel E stats' workspace bytes (-1: bad sizes)
    "mt_channel_stats_workspace": ([_I, _L, _I], _L),
    # x, stats, ws, ws_bytes, n, s, c, stream
    "mt_channel_stats": ([_P] * 3 + [_L, _I, _L, _I, _P], _I),
    # x, y, scale, shift, n, s, c, slope, cast_first, stream
    "mt_affine_lrelu": ([_P] * 4 + [_I, _L, _I, _F, _I, _P], _I),
    # kernel E's fp32 form: the same as the two entries above (apply: no
    # cast_first, the orders coincide in fp32)
    "mt_channel_stats_fp32_workspace": ([_I, _L, _I], _L),
    "mt_channel_stats_fp32": ([_P] * 3 + [_L, _I, _L, _I, _P], _I),
    "mt_affine_lrelu_fp32": ([_P] * 4 + [_I, _L, _I, _F, _P], _I),
    # k -> the largest C kernel F takes
    "mt_seghead_max_channels": ([_I], _I),
    # x, scale, shift, w, bias, out, out_bf16, n, s, c, k, kp, slope, stream
    "mt_seghead": ([_P] * 6 + [_I, _I, _L, _I, _I, _I, _F, _P], _I),
    # kernel F's fp32 form: x, scale, shift, w, bias, out, out_bf16, n, s, c,
    # k, kp, cp, slope, stream
    "mt_seghead_fp32": ([_P] * 6 + [_I, _I, _L, _I, _I, _I, _I, _F, _P], _I),
    # the probes' kernels (probes/):
    # x, w, out, n, z, y, x, c, cout, coutp, stream (im2col, wino); tap3 adds bn
    "mt_conv_im2col": ([_P] * 3 + [_I] * 7 + [_P], _I),
    # the same, then body (1 TMA + wgmma, 2 the first), mode (0 whole, 1
    # copies only, 2 products only), stream
    "mt_conv_im2col_form": ([_P] * 3 + [_I] * 9 + [_P], _I),
    "mt_conv_tap3": ([_P] * 3 + [_I] * 8 + [_P], _I),
    # tap3's: x, w, out, n, z, y, x, c, cout, coutp, bn, body, mode, stream
    "mt_conv_tap3_form": ([_P] * 3 + [_I] * 10 + [_P], _I),
    "mt_conv_wino": ([_P] * 3 + [_I] * 7 + [_P], _I),
    # as im2col's; mode 3: the box loads and the transform only
    "mt_conv_wino_form": ([_P] * 3 + [_I] * 9 + [_P], _I),
    # x, w, out, groups, ngroups, n, z, y, x, c, cout, coutp, bn, fy, fx, stream
    "mt_packed_conv3d": ([_P] * 3 + [ctypes.POINTER(_I)] + [_I] * 11 + [_P], _I),
    # x, w, out, n, z, y, x, c, cout, ndots, bz, by, bx, stream
    "mt_centern": ([_P] * 3 + [_I] * 10 + [_P], _I),
    # the same, then mode (0 whole, 1 copies only, 2 products only), stream
    "mt_centern_form": ([_P] * 3 + [_I] * 11 + [_P], _I),
    # out, z, y, x, c, bz, by, bx, stream
    "mt_zeros": ([_P] + [_I] * 7 + [_P], _I),
    # the same, then form (1 vector stores, mt_zeros'; 2 bulk stores), stream
    "mt_zeros_form": ([_P] + [_I] * 8 + [_P], _I),
    "mt_error_string": ([_I], ctypes.c_char_p),
}


def find_nvcc() -> str:
    """nvcc from PATH, else from $CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels of multitalent_tpu_torch are "
        "built from source at first use and need the CUDA toolkit")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmt_kernels_{h.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    """Wait for every process; raise with the output of the first that failed."""
    failed = None
    for cmd, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is not None:
        cmd, code, out = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{out}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists: one nvcc
    per source, all started together, then one link. Raises RuntimeError with
    nvcc's output when a step fails."""
    out = library_path()
    if out.is_file():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build in a private directory, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
            objs.append(obj)
        _run(procs)
        lib = os.path.join(tmp, out.name)
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objs]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True))])
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
    return _lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what} failed: CUDA error {code} "
                           f"({lib.mt_error_string(code).decode()})")
