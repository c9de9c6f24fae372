"""ConvDropoutNormNonlin and StackedConvLayers, the reference's U-Net blocks.

Counterpart of multitalent_tpu/models/blocks.py (ConvNormAct, ConvStage), with
the reference's torch parameter names (`conv.weight/bias`,
`instnorm.weight/bias`, generic_UNet.py:28-144) so one state dict loads into
both packages through io/torch_convert.convert_generic_unet_state_dict.

Order, as in the JAX package (ops/packed_unet.py:65-73): conv + bias, then
InstanceNorm with fp32 statistics and eps 1e-5, cast to the model dtype, then
LeakyReLU(0.01). The conv is a `KernelConv3d` (an nn.Conv3d, the residual
UNet's convs too), which runs on a hand-written kernel where one applies:

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


def instance_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm with fp32 statistics over the spatial axes, cast to x's
    dtype (multitalent_tpu/models/blocks.py:InstanceNorm); always plain torch."""
    xf = x.float()
    var, mean = torch.var_mean(xf, dim=(2, 3, 4), keepdim=True, correction=0)
    shape = (1, -1, 1, 1, 1)
    # per-channel scale first: two passes over the volume instead of four
    scale = torch.rsqrt(var + eps) * weight.float().view(shape)
    return torch.addcmul(bias.float().view(shape), xf - mean, scale).to(x.dtype)


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
    return F.leaky_relu(instance_norm(x, weight, bias, eps), negative_slope, inplace=True)


class KernelConv3d(nn.Conv3d):
    """nn.Conv3d (its parameters and state-dict keys) with SAME padding whose
    forward runs on a hand-written kernel where one applies (`route`):
    "conv3d_same" (A) for a stride-1 3x3x3 conv with Cin >= 8,
    "conv3d_same_dual" (B) when `in_splits` = (Ca, Cb) makes it read
    concat(a, b) from two tensors; None (cuDNN) otherwise."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), in_splits: tuple[int, int] | None = None,
                 bias: bool = True):
        kernel_size = tuple(int(k) for k in kernel_size)
        stride = tuple(int(s) for s in stride)
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding=tuple((k - 1) // 2 for k in kernel_size), bias=bias)
        same3 = kernel_size == (3, 3, 3) and stride == (1, 1, 1)
        if in_splits is not None:
            if not same3 or sum(in_splits) != in_channels:
                raise ValueError("a two-input block needs a stride-1 3x3x3 conv "
                                 "over sum(in_splits) channels")
            self.route = "conv3d_same_dual"
        elif same3 and in_channels >= 8:
            self.route = "conv3d_same"
        else:
            self.route = None  # cuDNN
        self.in_splits = tuple(in_splits) if in_splits is not None else None
        self._prepared: tuple | None = None

    def _load_from_state_dict(self, *args, **kwargs):
        self._prepared = None
        super()._load_from_state_dict(*args, **kwargs)

    def prepared_weight(self, dtype: torch.dtype) -> cv.PreparedWeight:
        """The weight in the kernel's layout and `dtype` (the model dtype;
        the CUDA kernels take bfloat16), prepared once per weight (device,
        storage, version counter, dtype) and cached: an in-place update (an
        optimizer step, a copy_ under no_grad) bumps the version and so
        prepares again; load_state_dict drops the cache."""
        w = self.weight
        key = (w.device, w.data_ptr(), w._version, dtype)
        if self._prepared is None or self._prepared[0] != key:
            with torch.no_grad():
                pw = cv.prepare_conv3d_weight(w.detach(), self.in_splits, dtype)
            self._prepared = (key, pw)
        return self._prepared[1]

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        """The conv of x (N, C, Z, Y, X) in x's dtype (of concat(x, skip)
        on route B). use_kernels=False runs the plain PyTorch versions of
        the kernels (the reference the kernels are checked against), on the
        same model-dtype inputs and weights the kernels see."""
        dtype = x.dtype
        w, bias = self.weight, self.bias
        if self.route == "conv3d_same_dual":
            a, b = to_ndhwc(x), to_ndhwc(skip.to(dtype))
            if use_kernels:
                out = cv.conv3d_same_dual_op(a, b, w, bias, self.prepared_weight(dtype))
            else:
                out = cv.conv3d_same_dual_ref(a, b, w.to(dtype), bias)
            return from_ndhwc(out)
        if self.route == "conv3d_same":
            if use_kernels:
                out = cv.conv3d_same_op(to_ndhwc(x), w, bias, self.prepared_weight(dtype))
            else:
                out = cv.conv3d_same_ref(to_ndhwc(x), w.to(dtype), bias)
            return from_ndhwc(out)
        return F.conv3d(x, w.to(dtype), None if bias is None else bias.to(dtype),
                        self.stride, self.padding)


def kernel_launches_per_forward(net: nn.Module) -> dict[str, int]:
    """Launches of each hand-written conv kernel that one forward of `net`
    makes: one for every KernelConv3d on a kernel route."""
    counts = {"conv3d_same": 0, "conv3d_same_dual": 0}
    for m in net.modules():
        if isinstance(m, KernelConv3d) and m.route is not None:
            counts[m.route] += 1
    return counts


def kernel_launches_per_step(net: nn.Module, input_conv: KernelConv3d) -> dict[str, int]:
    """Launches of each hand-written kernel that one training step (forward
    + backward) of `net` makes: every kernel conv's forward (A or B), its dx
    by kernel A (unless it is `input_conv`, which reads the network's input
    and so needs no gradient) and its dw by kernel C (single or dual form)."""
    counts = kernel_launches_per_forward(net)
    kernels = sum(counts.values())
    counts["conv3d_same"] += kernels - (input_conv.route is not None)
    counts["conv3d_same_wgrad"] = kernels
    return counts


class ConvDropoutNormNonlin(nn.Module):
    """conv -> InstanceNorm -> LeakyReLU. `in_splits` = (Ca, Cb) makes the conv
    read concat(a, b) from two tensors (kernel B). The norm is registered as
    `norm_name`: `instnorm` in the GenericUNet, `norm` in the residual UNet's
    decoder."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 stride=(1, 1, 1), in_splits: tuple[int, int] | None = None,
                 negative_slope: float = 1e-2, norm_name: str = "instnorm"):
        super().__init__()
        self.conv = KernelConv3d(in_channels, out_channels, kernel_size, stride, in_splits)
        self.norm_name = norm_name
        self.add_module(norm_name, nn.InstanceNorm3d(out_channels, eps=1e-5, affine=True))
        self.negative_slope = negative_slope

    @property
    def kernel(self) -> str | None:
        """The conv's kernel route (KernelConv3d.route)."""
        return self.conv.route

    def prepared_weight(self, dtype: torch.dtype) -> cv.PreparedWeight:
        return self.conv.prepared_weight(dtype)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        """x (N, C, Z, Y, X). For a two-input block `skip` is the second
        input. use_kernels=False runs the kernels' plain versions."""
        norm = getattr(self, self.norm_name)
        return instance_norm_lrelu(self.conv(x, skip, use_kernels=use_kernels),
                                   norm.weight, norm.bias, self.negative_slope, norm.eps)


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
