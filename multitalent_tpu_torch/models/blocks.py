"""ConvDropoutNormNonlin and StackedConvLayers, the reference's U-Net blocks.

Counterpart of multitalent_tpu/models/blocks.py (ConvNormAct, ConvStage), with
the reference's torch parameter names (`conv.weight/bias`,
`instnorm.weight/bias`, generic_UNet.py:28-144) so one state dict loads into
both packages through io/torch_convert.convert_generic_unet_state_dict.

Order, as in the JAX package (ops/packed_unet.py:65-73): conv + bias, then
InstanceNorm with fp32 statistics and eps 1e-5, cast to the model dtype, then
LeakyReLU(0.01). The conv runs on a hand-written kernel where one applies:

- kernel A (ops/conv3d.conv3d_same): every stride-1 3x3x3 conv with Cin >= 8;
- kernel B (ops/conv3d.conv3d_same_dual): a decoder's first conv, on the
  (up, skip) pair without building the concat.

Both go through the autograd functions of ops/conv3d.py, so a backward pass
reaches the kernels too: dx by kernel A on the flipped weight, dw by kernel C.

The rest (the Cin=1 first conv, strided convs, other kernel shapes) stays
cuDNN, as the JAX package leaves it to XLA. Activations are NCDHW tensors in
`torch.channels_last_3d` memory, so the kernels read them as NDHWC without a
copy.

The norm is plain torch by default; MTTPU_PALLAS_NORM=1 runs it on kernel
E (ops/fused_norm.py), without a backward.

bf16 rounding differs from the JAX package in one place: the kernels add the
bias in fp32 and round once, where JAX rounds the conv output to bf16 and adds
a bf16 bias (packed_unet.py:51-53).
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F
from torch import nn

from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import fused_norm

CL = torch.channels_last_3d


def to_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """NCDHW channels_last_3d -> the contiguous NDHWC view (no copy)."""
    return x.contiguous(memory_format=CL).permute(0, 2, 3, 4, 1)


def from_ndhwc(x: torch.Tensor) -> torch.Tensor:
    """Contiguous NDHWC -> NCDHW view in channels_last_3d memory."""
    return x.permute(0, 4, 1, 2, 3)


def use_pallas_norm() -> bool:
    """MTTPU_PALLAS_NORM=1 runs every norm of the plain forward on kernel E,
    as the JAX package's switch of the same name (models/blocks.py:25-31)
    runs its Pallas fused norm; off by default."""
    return os.environ.get("MTTPU_PALLAS_NORM", "0") == "1"


def instance_norm_lrelu(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        negative_slope: float = 1e-2,
                        eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm (fp32 statistics over the spatial axes) -> cast to x's
    dtype -> LeakyReLU, as multitalent_tpu/ops/packed_unet.py:65-73.

    Under MTTPU_PALLAS_NORM=1: kernel E's two passes instead
    (ops/fused_norm.fused_instance_norm_lrelu: LeakyReLU in fp32, then the
    cast). That path has no backward, as the JAX package's has none, so it
    raises while autograd is recording."""
    if use_pallas_norm():
        if torch.is_grad_enabled():
            raise RuntimeError(
                "MTTPU_PALLAS_NORM=1: kernel E (ops/fused_norm.py) has no backward, "
                "like the JAX package's fused_instance_norm_lrelu; run the forward "
                "under torch.no_grad(), or unset MTTPU_PALLAS_NORM to train (the "
                "missing backward is listed in ROADMAP.md, queue 1)")
        return from_ndhwc(fused_norm.fused_instance_norm_lrelu(
            to_ndhwc(x), weight, bias, negative_slope, eps))
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, correction=0)
    shape = (1, -1, 1, 1, 1)
    # per-channel scale first: two passes over the volume instead of four
    scale = torch.rsqrt(var + eps) * weight.float().view(shape)
    y = torch.addcmul(bias.float().view(shape), xf - mean, scale)
    return F.leaky_relu(y.to(x.dtype), negative_slope, inplace=True)


class ConvDropoutNormNonlin(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU. `in_splits` = (Ca, Cb) makes the conv
    read concat(a, b) from two tensors (kernel B)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), in_splits: tuple[int, int] | None = None,
                 negative_slope: float = 1e-2):
        super().__init__()
        kernel_size = tuple(int(k) for k in kernel_size)
        stride = tuple(int(s) for s in stride)
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride,
                              padding=tuple((k - 1) // 2 for k in kernel_size))
        self.instnorm = nn.InstanceNorm3d(out_channels, eps=1e-5, affine=True)
        self.negative_slope = negative_slope
        same3 = kernel_size == (3, 3, 3) and stride == (1, 1, 1)
        if in_splits is not None:
            if not same3 or sum(in_splits) != in_channels:
                raise ValueError("a two-input block needs a stride-1 3x3x3 conv "
                                 "over sum(in_splits) channels")
            self.kernel = "conv3d_same_dual"
        elif same3 and in_channels >= 8:
            self.kernel = "conv3d_same"
        else:
            self.kernel = None  # cuDNN
        self.in_splits = tuple(in_splits) if in_splits is not None else None
        self._prepared: tuple | None = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._prepared = None
        super()._load_from_state_dict(*args, **kwargs)

    def prepared_weight(self, dtype: torch.dtype) -> cv.PreparedWeight:
        """The conv weight in the kernel's layout and `dtype` (the model dtype;
        the CUDA kernels take bfloat16), prepared once per weight (device,
        storage, version counter, dtype) and cached: an in-place update (an
        optimizer step, a copy_ under no_grad) bumps the version and so
        prepares again; load_state_dict drops the cache."""
        w = self.conv.weight
        key = (w.device, w.data_ptr(), w._version, dtype)
        if self._prepared is None or self._prepared[0] != key:
            with torch.no_grad():
                pw = cv.prepare_conv3d_weight(w.detach(), self.in_splits, dtype)
            self._prepared = (key, pw)
        return self._prepared[1]

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        """x (N, C, Z, Y, X). For a two-input block `skip` is the second
        input. use_kernels=False runs the plain PyTorch versions of the
        kernels (the reference the kernels are checked against), on the
        same model-dtype inputs and weights the kernels see."""
        dtype = x.dtype
        w, bias = self.conv.weight, self.conv.bias
        if self.kernel == "conv3d_same_dual":
            a, b = to_ndhwc(x), to_ndhwc(skip.to(dtype))
            if use_kernels:
                out = cv.conv3d_same_dual_op(a, b, w, bias, self.prepared_weight(dtype))
            else:
                out = cv.conv3d_same_dual_ref(a, b, w.to(dtype), bias)
            out = from_ndhwc(out)
        elif self.kernel == "conv3d_same":
            if use_kernels:
                out = cv.conv3d_same_op(to_ndhwc(x), w, bias, self.prepared_weight(dtype))
            else:
                out = cv.conv3d_same_ref(to_ndhwc(x), w.to(dtype), bias)
            out = from_ndhwc(out)
        else:
            out = F.conv3d(x, self.conv.weight.to(dtype), self.conv.bias.to(dtype),
                           self.conv.stride, self.conv.padding)
        return instance_norm_lrelu(out, self.instnorm.weight, self.instnorm.bias,
                                   self.negative_slope, self.instnorm.eps)


class StackedConvLayers(nn.Module):
    """`num_convs` blocks; the first may be strided (convolutional pooling) or
    read two inputs. StackedConvLayers parity (generic_UNet.py:89-144)."""

    def __init__(self, in_channels: int, out_channels: int, num_convs: int,
                 kernel_size=(3, 3, 3), first_stride=None,
                 in_splits: tuple[int, int] | None = None):
        super().__init__()
        self.blocks = nn.Sequential(*[
            ConvDropoutNormNonlin(
                in_channels if i == 0 else out_channels, out_channels, kernel_size,
                stride=first_stride if (i == 0 and first_stride is not None)
                else (1, 1, 1),
                in_splits=in_splits if i == 0 else None)
            for i in range(num_convs)])

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, skip if i == 0 else None, use_kernels=use_kernels)
        return x
