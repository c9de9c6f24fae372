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
    # x, w, bias, out, ws, ws_bytes, n, z, y, x, cin, cout, coutp, bn, stream
    "mt_conv3d_same": ([_P, _P, _P, _P, _P, _L] + [_I] * 8 + [_P], _I),
    # a, b, w, bias, out, ws, ws_bytes, n, z, y, x, ca, cb, cout, coutp, bn,
    # stream
    "mt_conv3d_same_dual": ([_P, _P, _P, _P, _P, _P, _L] + [_I] * 9 + [_P], _I),
    # n, z, y, x, ca, cb, cout -> workspace bytes (-1: bad sizes)
    "mt_conv3d_wgrad_workspace": ([_I] * 7, _L),
    # x, g, dw, ws, ws_bytes, n, z, y, x, cin, cout, stream
    "mt_conv3d_wgrad": ([_P, _P, _P, _P, _L] + [_I] * 6 + [_P], _I),
    # a, b, g, dw, ws, ws_bytes, n, z, y, x, ca, cb, cout, stream
    "mt_conv3d_wgrad_dual": ([_P, _P, _P, _P, _P, _L] + [_I] * 7 + [_P], _I),
    # n, z, y, x, ca, cb, cout, coutp, bn -> kernel D's workspace bytes
    "mt_conv3d_stats_workspace": ([_I] * 9, _L),
    # x, w, bias, scale, shift, slope, out, stats, ws, ws_bytes, n, z, y, x,
    # cin, cout, coutp, bn, stream
    "mt_conv3d_same_affine": ([_P] * 5 + [_F] + [_P] * 3 + [_L] + [_I] * 8 + [_P], _I),
    # a, b, w, bias, out, stats, ws, ws_bytes, n, z, y, x, ca, cb, cout,
    # coutp, bn, stream
    "mt_conv3d_same_dual_stats": ([_P] * 7 + [_L] + [_I] * 9 + [_P], _I),
    # n, s, c -> kernel E stats' workspace bytes (-1: bad sizes)
    "mt_channel_stats_workspace": ([_I, _L, _I], _L),
    # x, stats, ws, ws_bytes, n, s, c, stream
    "mt_channel_stats": ([_P] * 3 + [_L, _I, _L, _I, _P], _I),
    # x, y, scale, shift, n, s, c, slope, cast_first, stream
    "mt_affine_lrelu": ([_P] * 4 + [_I, _L, _I, _F, _I, _P], _I),
    # k -> the largest C kernel F takes
    "mt_seghead_max_channels": ([_I], _I),
    # x, scale, shift, w, bias, out, out_bf16, n, s, c, k, kp, slope, stream
    "mt_seghead": ([_P] * 6 + [_I, _I, _L, _I, _I, _I, _F, _P], _I),
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
