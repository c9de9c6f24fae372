"""The inference seg head with the last InstanceNorm + LeakyReLU in its
prologue, on a hand-written Hopper kernel (F).

Counterpart of multitalent_tpu/ops/pallas_seghead.py:seghead_d2s. The JAX
kernel fuses the 1x1x1 head with depth-to-space on the packed layout; the port
runs unpacked, so the kernel instead reads the channels-last raw conv output
(N, Z, Y, X, C) and writes the logits as a contiguous NCDHW (N, K, Z, Y, X)
tensor, the layout the sliding window consumes (ops/sliding_window.py), in
one pass. The kernel lives in `csrc/seghead.cu`.

`seghead` launches it for CUDA tensors (or raises) and takes the plain
version `seghead_ref` only for CPU tensors; `seghead.launches` counts kernel
launches. The kernel's weight operand (`prepare_head_weight`: bf16, padded
with zeros) is built once per weight version (`prepared_head_weight`).
"""
from __future__ import annotations

import torch

from multitalent_tpu_torch.ops.fused_norm import affine_lrelu_ref

KP_ROWS = 16  # the kernel's weight rows pad to a multiple of this (its mma M)


def padded_channels(c: int) -> int:
    """The kernel's padded channel count for c input channels: 16, 32, 64 or
    128, the least >= c (csrc/seghead.cu:padded_channels)."""
    for cp in (16, 32, 64, 128):
        if c <= cp:
            return cp
    raise ValueError(f"seghead: the kernel takes at most 128 channels, got {c}")


def _head_matrix(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """torch head weight (K, C, 1, 1, 1) -> (K, C), rounded to `dtype` as the
    kernel's products see it."""
    if tuple(weight.shape[2:]) != (1, 1, 1):
        raise ValueError(f"expected a 1x1x1 head, got {tuple(weight.shape)}")
    return weight.reshape(weight.shape[0], weight.shape[1]).to(dtype)


def prepare_head_weight(weight: torch.Tensor,
                        device: torch.device | None = None) -> torch.Tensor:
    """The kernel's weight operand of the head `weight` (K, C, 1, 1, 1): (KP,
    CP) bf16 on `device` (the weight's by default), the (K, C) matrix rounded
    to bf16 and padded with exact zeros to KP = K rounded up to 16 rows and CP
    = padded_channels(C) columns."""
    k, c = int(weight.shape[0]), int(weight.shape[1])
    kp = -(-k // KP_ROWS) * KP_ROWS
    w = torch.zeros((kp, padded_channels(c)), dtype=torch.bfloat16,
                    device=weight.device if device is None else device)
    w[:k, :c] = _head_matrix(weight.detach(), torch.bfloat16)
    return w


def prepared_head_weight(weight: torch.Tensor, device: torch.device) -> torch.Tensor:
    """prepare_head_weight(weight, device), built once per weight version: kept
    on the weight tensor itself, keyed by its storage, in-place version and
    the device, so an optimizer step or a load_state_dict (in-place copies
    that bump the version) rebuilds it, as models/blocks.py keeps a conv's
    prepared weight."""
    key = (weight.device, weight.data_ptr(), weight._version, torch.device(device))
    cached = getattr(weight, "_mt_seghead_prepared", None)
    if cached is None or cached[0] != key:
        cached = (key, prepare_head_weight(weight, device))
        weight._mt_seghead_prepared = cached
    return cached[1]


def seghead_ref(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
                scale: torch.Tensor | None = None, shift: torch.Tensor | None = None,
                negative_slope: float = 1e-2,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of kernel F: logits (N, K, Z, Y, X) contiguous in
    `out_dtype` of channels-last x (N, Z, Y, X, C) through the 1x1x1 head
    `weight` (K, C, 1, 1, 1) and optional bias (K,). With scale, shift (N, C)
    the input is first lrelu(x * scale + shift), cast before the activation.
    Products of the activation and the weight in x's dtype, summed in fp32,
    bias added last, one cast (pallas_seghead.py:_kernel)."""
    y = x if scale is None else affine_lrelu_ref(x, scale, shift, negative_slope, True)
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    w = _head_matrix(weight, x.dtype).to(acc)
    out = torch.einsum("nzyxc,kc->nkzyx", y.to(acc), w)
    if bias is not None:
        out = out + bias.to(acc).view(1, -1, 1, 1, 1)
    return out.to(out_dtype).contiguous()


def seghead(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
            scale: torch.Tensor | None = None, shift: torch.Tensor | None = None,
            negative_slope: float = 1e-2,
            out_dtype: torch.dtype = torch.float32,
            out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel F: the 1x1x1 seg head (with the normalize prologue when scale
    and shift are given) of channels-last x (N, Z, Y, X, C) bf16, written as
    contiguous NCDHW logits in `out_dtype` (bfloat16 or float32), into `out`
    where given (contiguous, (N, K, Z, Y, X) of out_dtype on x's device).

    CUDA tensors launch the kernel; CPU tensors take seghead_ref."""
    if x.device.type == "cpu":
        ref = seghead_ref(x, weight, bias, scale, shift, negative_slope, out_dtype)
        return ref if out is None else out.copy_(ref)
    if x.device.type != "cuda":
        raise ValueError(f"seghead: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"seghead: the kernel takes bfloat16, got {x.dtype}")
    if x.dim() != 5 or not x.is_contiguous():
        raise ValueError("seghead: the kernel takes a contiguous channels-last "
                         f"(N, Z, Y, X, C) tensor, got {tuple(x.shape)}")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"seghead: output bfloat16 or float32, got {out_dtype}")
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    n, z, y, xd, c = (int(s) for s in x.shape)
    k = int(weight.shape[0])
    if int(weight.shape[1]) != c:
        raise ValueError(f"head weight {tuple(weight.shape)} does not take {c} channels")
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (n, c)
                              or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({n}, {c}) tensor on "
                             f"{x.device}")
    if bias is not None and (bias.dtype != torch.float32 or tuple(bias.shape) != (k,)
                             or bias.device != x.device or not bias.is_contiguous()):
        raise ValueError(f"bias must be a contiguous float32 ({k},) tensor on {x.device}")
    from multitalent_tpu_torch import _build
    lib = _build.library()
    if c > lib.mt_seghead_max_channels(k):
        raise ValueError(f"seghead: the kernel takes at most "
                         f"{lib.mt_seghead_max_channels(k)} channels for {k} outputs, "
                         f"got {c}")
    w = prepared_head_weight(weight, x.device)
    if out is None:
        out = torch.empty((n, k, z, y, xd), dtype=out_dtype, device=x.device)
    elif (out.dtype != out_dtype or tuple(out.shape) != (n, k, z, y, xd)
          or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous {out_dtype} {(n, k, z, y, xd)} tensor on "
                         f"{x.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if out.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        code = lib.mt_seghead(
            x.data_ptr(), None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), n, z * y * xd, c, k, int(w.shape[0]),
            float(negative_slope), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(lib, code, "mt_seghead")
    seghead.launches += 1
    return out


seghead.launches = 0
