"""InstanceNorm + LeakyReLU as two passes of a hand-written Hopper kernel (E).

Counterpart of multitalent_tpu/ops/fused_norm.py (`_stats_kernel`,
`_apply_kernel`) and of the statistics helpers of
multitalent_tpu/ops/packed_conv.py:601-646 at one packing phase (the port runs
unpacked), on channels-last tensors (N, *spatial, C):

- `channel_stats` (kernel E, stats): per-sample channel sum and sum of
  squares in fp32, (N, 2, C), the convention of the fused conv's stats output;
- `affine_lrelu` (kernel E, apply): lrelu(x * scale + shift) per (sample,
  channel), in one of two rounding orders: `cast_first=True` casts to x's
  dtype before the activation (packed_conv.normalize_from_stats, the fused
  conv chain's `materialize`), `cast_first=False` applies it in fp32 and casts
  once (fused_norm.py:_apply_kernel);
- `fused_instance_norm_lrelu`: the two passes as the JAX package's
  fused_instance_norm_lrelu composes them (var clamped at 0, fp32
  activation, then the cast); it has no backward, as the JAX one has none;
- `stats_affine` and `normalize_from_stats`: the fused chain's per-sample
  scale and shift from stats (var not clamped, eps 1e-5) and the normalize
  pass that uses them.

Both kernels live in `csrc/fused_norm.cu`. Each wrapper launches its kernel
for CUDA tensors (or raises) and takes its plain PyTorch version
(`channel_stats_ref`, `affine_lrelu_ref`) only for CPU tensors; each keeps a
count of kernel launches in its `launches` attribute.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _per_sample(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, C) -> a view that broadcasts against channels-last x (N, ..., C)."""
    return v.reshape(v.shape[0], *(1,) * (x.dim() - 2), v.shape[-1])


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def channel_stats_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel E's stats pass: (N, 2, C) fp32 (fp64 for fp64
    input) per-sample channel sum and sum of squares of x (N, ..., C)
    (packed_conv.py:channel_stats)."""
    xf = x.to(_acc_dtype(x))
    axes = tuple(range(1, x.dim() - 1))
    return torch.stack((xf.sum(axes), (xf * xf).sum(axes)), dim=1)


def affine_lrelu_ref(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                     negative_slope: float = 1e-2, cast_first: bool = True) -> torch.Tensor:
    """Plain version of kernel E's apply pass: lrelu(x * scale + shift) with
    scale, shift (N, C), in x's dtype. cast_first: round x * scale + shift to
    x's dtype, then the activation on the rounded value (its product rounded
    again), as packed_conv.normalize_from_stats and the fused conv's prologue
    (pallas_conv.py:_affine_lrelu); else the activation in fp32, then one cast
    (fused_norm.py:_apply_kernel)."""
    acc = _acc_dtype(x)
    f = x.to(acc) * _per_sample(scale, x).to(acc) + _per_sample(shift, x).to(acc)
    if cast_first:
        return F.leaky_relu(f.to(x.dtype), negative_slope)
    return F.leaky_relu(f, negative_slope).to(x.dtype)


def stats_affine(stats: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                 nvox: int, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-sample (scale, shift), each (N, C), from channel stats (N, 2, C)
    over `nvox` voxels, such that x * scale + shift is the instance norm of x
    times weight plus bias (packed_conv.py:stats_affine at one phase: the
    variance E[x^2] - mean^2 is not clamped)."""
    acc = _acc_dtype(stats)
    mean = stats[:, 0] / nvox
    var = stats[:, 1] / nvox - mean * mean
    sc = weight.to(acc) * torch.rsqrt(var + eps)
    return sc, bias.to(acc) - mean * sc


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_x(x: torch.Tensor, name: str) -> None:
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous channels-last "
                         f"(N, ..., C) tensor, got {tuple(x.shape)}")


def _check_per_sample(v: torch.Tensor, name: str, x: torch.Tensor) -> None:
    n, c = int(x.shape[0]), int(x.shape[-1])
    if (v.dtype != torch.float32 or v.device != x.device or tuple(v.shape) != (n, c)
            or not v.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous float32 ({n}, {c}) tensor on "
                         f"{x.device}, got {v.dtype} {tuple(v.shape)} on {v.device}")


def channel_stats(x: torch.Tensor) -> torch.Tensor:
    """Kernel E, stats: (N, 2, C) fp32 per-sample channel sum and sum of
    squares of x (N, ..., C), deterministic; one launch where a sample is
    one chunk of the kernel's, else two (the partials, then their sum).

    CUDA tensors launch the kernel; CPU tensors take channel_stats_ref."""
    if x.device.type == "cpu":
        return channel_stats_ref(x)
    if x.device.type != "cuda":
        raise ValueError(f"channel_stats: unsupported device {x.device}")
    _check_x(x, "channel_stats")
    from multitalent_tpu_torch import _build
    lib = _build.library()
    n, c = int(x.shape[0]), int(x.shape[-1])
    s = x.numel() // max(n * c, 1)
    stats = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    if x.numel() == 0:
        return stats.zero_()
    with torch.cuda.device(x.device):
        nbytes = lib.mt_channel_stats_workspace(n, s, c)
        if nbytes < 0:
            raise ValueError(f"channel_stats: the kernel does not take {tuple(x.shape)}")
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=x.device) if nbytes else None
        code = lib.mt_channel_stats(x.data_ptr(), stats.data_ptr(),
                                    None if ws is None else ws.data_ptr(), nbytes, n, s, c,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "mt_channel_stats")
    channel_stats.launches += 1
    return stats


channel_stats.launches = 0


def affine_lrelu(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 negative_slope: float = 1e-2, cast_first: bool = True) -> torch.Tensor:
    """Kernel E, apply: lrelu(x * scale + shift) per (sample, channel) of x
    (N, ..., C), scale and shift (N, C) fp32, in the rounding order
    `cast_first` picks (see affine_lrelu_ref).

    CUDA tensors launch the kernel; CPU tensors take affine_lrelu_ref."""
    if x.device.type == "cpu":
        return affine_lrelu_ref(x, scale, shift, negative_slope, cast_first)
    if x.device.type != "cuda":
        raise ValueError(f"affine_lrelu: unsupported device {x.device}")
    _check_x(x, "affine_lrelu")
    _check_per_sample(scale, "scale", x)
    _check_per_sample(shift, "shift", x)
    from multitalent_tpu_torch import _build
    lib = _build.library()
    n, c = int(x.shape[0]), int(x.shape[-1])
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        code = lib.mt_affine_lrelu(x.data_ptr(), y.data_ptr(), scale.data_ptr(),
                                   shift.data_ptr(), n, x.numel() // (n * c), c,
                                   float(negative_slope), int(cast_first),
                                   torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "mt_affine_lrelu")
    affine_lrelu.launches += 1
    return y


affine_lrelu.launches = 0


# ---------------------------------------------------------------------------
# compositions
# ---------------------------------------------------------------------------

def normalize_from_stats(x: torch.Tensor, stats: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor, negative_slope: float = 1e-2,
                         eps: float = 1e-5, use_kernels: bool = True) -> torch.Tensor:
    """InstanceNorm + LeakyReLU of x (N, ..., C) given its channel stats:
    elementwise only, cast before the activation
    (packed_conv.py:normalize_from_stats); one kernel-E apply launch, or its
    plain version with use_kernels=False (autograd runs through that one)."""
    nvox = x.numel() // max(int(x.shape[0]) * int(x.shape[-1]), 1)
    sc, sh = stats_affine(stats, weight, bias, nvox, eps)
    apply = affine_lrelu if use_kernels else affine_lrelu_ref
    return apply(x, sc.contiguous(), sh.contiguous(), negative_slope, True)


def fused_instance_norm_lrelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                              negative_slope: float = 1e-2,
                              eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm (per-sample, per-channel over the spatial axes) + affine +
    LeakyReLU of x (N, ..., C) as multitalent_tpu/ops/fused_norm.py computes
    it: fp32 stats (kernel E, stats), var = E[x^2] - mean^2 clamped at 0,
    then lrelu((x - mean) * rstd * weight + bias) in fp32 and one cast
    (kernel E, apply). No backward."""
    n, c = int(x.shape[0]), int(x.shape[-1])
    s = x.numel() // max(n * c, 1)
    stats = channel_stats(x)
    mean = stats[:, 0] / s
    var = (stats[:, 1] / s - mean * mean).clamp_min(0.0)
    sc = torch.rsqrt(var + eps) * weight.to(stats.dtype)
    sh = bias.to(stats.dtype) - mean * sc
    return affine_lrelu(x, sc.contiguous(), sh.contiguous(), negative_slope,
                        cast_first=False)
