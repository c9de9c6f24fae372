"""What the probes share: the device a probe runs on, launching a kernel of
the package's library, and timing on the card with CUDA events."""
from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """The probe's device: the card unless the caller asks for the CPU. TF32 is
    turned off, so that the plain versions compute in full fp32."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the probes run on an NVIDIA GPU (torch.cuda.is_available() is "
                           "False); pass --device cpu for a run of the plain versions")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return device


def check_tensor(t: torch.Tensor, name: str) -> None:
    """A kernel's bf16 input: contiguous, 16-byte aligned, on a CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes a CUDA tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel takes a contiguous, 16-byte aligned tensor")


def out_tensor(out: torch.Tensor | None, shape, device: torch.device) -> torch.Tensor:
    """A kernel's bf16 output of `shape` on `device`: the caller's `out` (checked
    as a kernel input is), else a new tensor."""
    if out is None:
        return torch.empty(tuple(shape), dtype=torch.bfloat16, device=device)
    check_tensor(out, "out")
    if tuple(out.shape) != tuple(shape) or out.device != device:
        raise ValueError(f"out: expected {tuple(shape)} on {device}, got "
                         f"{tuple(out.shape)} on {out.device}")
    return out


def into(out: torch.Tensor | None, result: torch.Tensor) -> torch.Tensor:
    """A plain version's result, copied into the caller's `out` where one was
    given (same shape)."""
    if out is None:
        return result
    if out.shape != result.shape:
        raise ValueError(f"out: expected {tuple(result.shape)}, got {tuple(out.shape)}")
    return out.copy_(result)


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry `name` of the kernel library with args and the device's
    current stream; raise when it returns a CUDA error."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    with torch.cuda.device(device):
        code = getattr(lib, name)(*args, torch.cuda.current_stream(device).cuda_stream)
    _build.check(lib, code, name)


WARMUP = 2  # untimed calls before median_ms times any


def median_ms(fn, iters: int = 10, warmup: int = WARMUP) -> float:
    """Median over `iters` calls of fn's time on the card (CUDA events around
    each call), after `warmup` calls."""
    for _ in range(warmup):
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
