"""ConvDropoutNormNonlin and StackedConvLayers, the reference's U-Net blocks.

Counterpart of multitalent_tpu/models/blocks.py (ConvNormAct, ConvStage), with
the reference's torch parameter names (`conv.weight/bias`,
`instnorm.weight/bias`, generic_UNet.py:28-144) so one state dict loads into
both packages through io/torch_convert.convert_generic_unet_state_dict.

Order, as in the JAX package (ops/packed_unet.py:65-73): conv + bias, then
InstanceNorm with fp32 statistics and eps 1e-5, cast to the model dtype, then
LeakyReLU(0.01). The architectural variants' knobs (blocks.py:34-150 of the
JAX package, `make_norm` and `apply_nonlin`) swap the norm (`norm`:
instance, batch, group, frn, none; `normalize`) and the activation
(`nonlin`: leaky_relu, relu, gelu, mish; `activate`). Blocks of rank 2 (a
2D plan's kernel sizes) run every conv as `Conv2dSame` (an nn.Conv2d) on
cuDNN, as the JAX package runs its 2D convs as flax nn.Conv in XLA. A 3D
conv is a `KernelConv3d` (an nn.Conv3d, the residual UNet's convs too),
which runs on a hand-written kernel where one applies:

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

Under an active space axis (parallel/mesh.py: a training step whose ranks
split each sample's patch) every 3D conv computes this rank's slab: it takes
the neighbours' boundary planes its taps reach (`mesh.halo`; one a side for
a stride-1 3x3x3 conv, the left one for a stride-2 one) and keeps the
outputs of its slab. Kernels A and B run SAME over the extended slab, whose
outer planes are dropped, so their backward (A's dx, C) runs over the
extended slab too; cuDNN's convs run unpadded along the split axis. The
instance norm's statistics are the whole sample's, their sums pooled over
the space group (`mesh.space_sum`). Transposed convs, 1x1x1 heads and the
activations stay local.

`nonlin_first` (the convReLUIN variants, blocks.py:174,195-197 of the JAX
package; the reference's ConvDropoutNonlinNorm) turns a block into conv ->
activation -> norm; its conv still takes kernel A or B, its activation and
norm stay plain torch (kernel E fuses only norm -> LeakyReLU).

bf16 rounding differs from the JAX package in one place: the kernels add the
bias in fp32 and round once, where JAX rounds the conv output to bf16 and adds
a bf16 bias (packed_unet.py:51-53). An fp32 network runs the kernels' fp32
forms (ops/conv3d.py).
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch import nn

from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import fused_norm
from multitalent_tpu_torch.parallel import mesh

CL = torch.channels_last_3d

NORMS = ("instance", "batch", "group", "frn", "none")
NONLINS = ("leaky_relu", "relu", "gelu", "mish")
GROUPS = 8  # the reference's MyGroupNorm (nnUNetTrainerV2_GN.py:39)


def memory_format(x: torch.Tensor) -> torch.memory_format:
    """channels_last_3d for (N, C, Z, Y, X), channels_last for (N, C, Y, X)."""
    return CL if x.dim() == 5 else torch.channels_last


def conv_nd(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None = None,
            stride=1, padding=0) -> torch.Tensor:
    """F.conv3d or F.conv2d by x's rank."""
    return (F.conv3d if x.dim() == 5 else F.conv2d)(x, weight, bias, stride, padding)


def conv_transpose_nd(x: torch.Tensor, weight: torch.Tensor, stride) -> torch.Tensor:
    """F.conv_transpose3d or F.conv_transpose2d by x's rank, no bias."""
    return (F.conv_transpose3d if x.dim() == 5 else F.conv_transpose2d)(x, weight, None, stride)


def instance_norm_module(channels: int, ndim: int) -> nn.Module:
    """The affine InstanceNorm module of a rank-`ndim` block (its weight and
    bias; the forward is `instance_norm`)."""
    cls = nn.InstanceNorm3d if ndim == 3 else nn.InstanceNorm2d
    return cls(channels, eps=1e-5, affine=True)


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
    dtype (multitalent_tpu/models/blocks.py:InstanceNorm); always plain torch.
    Under an active space axis the statistics are the whole sample's: the
    mean from sums pooled over the space group, then the variance from the
    pooled sums of the centred squares (the two passes of var_mean)."""
    xf = x.float()
    dims = tuple(range(2, x.dim()))
    space = mesh.current()
    if space is None:
        var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    else:
        n = math.prod(x.shape[2:]) * space.size
        mean = mesh.space_sum(xf.sum(dims, keepdim=True), space) / n
        var = mesh.space_sum((xf - mean).square().sum(dims, keepdim=True), space) / n
    shape = (1, -1) + (1,) * (x.dim() - 2)
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
        if mesh.current() is not None:
            raise NotImplementedError("MTTPU_PALLAS_NORM=1: kernel E takes a whole sample; "
                                      "a slab of the space axis needs the plain norm")
        if torch.is_grad_enabled():
            raise RuntimeError(
                "MTTPU_PALLAS_NORM=1: kernel E (ops/fused_norm.py) has no backward, "
                "like the JAX package's fused_instance_norm_lrelu; run the forward "
                "under torch.no_grad(), or unset MTTPU_PALLAS_NORM to train (the "
                "missing backward is listed in ROADMAP.md, queue 1)")
        if x.dim() != 5:
            raise NotImplementedError("MTTPU_PALLAS_NORM=1: kernel E takes (N, Z, Y, X, C) "
                                      "activations; a 2D network's norms are plain torch")
        return from_ndhwc(fused_norm.fused_instance_norm_lrelu(
            to_ndhwc(x), weight, bias, negative_slope, eps))
    return F.leaky_relu(instance_norm(x, weight, bias, eps), negative_slope, inplace=True)


def batch_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """BatchNorm over (batch, spatial) with fp32 statistics of the batch in
    training and in eval alike (no running statistics), cast to x's dtype
    (multitalent_tpu/models/blocks.py:BatchNormBatchStats)."""
    xf = x.float()
    dims = (0,) + tuple(range(2, x.dim()))
    var, mean = torch.var_mean(xf, dim=dims, keepdim=True, correction=0)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    scale = torch.rsqrt(var + eps) * weight.float().view(shape)
    return torch.addcmul(bias.float().view(shape), xf - mean, scale).to(x.dtype)


def group_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               groups: int = GROUPS, eps: float = 1e-5) -> torch.Tensor:
    """flax nn.GroupNorm(num_groups=8, epsilon=1e-5, param_dtype=float32):
    per sample and group of consecutive channels, fp32 statistics over the
    spatial axes and the group's channels with flax's fast variance
    (E[x^2] - E[x]^2, clipped at 0); the result stays fp32 (flax promotes
    the input with the fp32 parameters)."""
    n, c = int(x.shape[0]), int(x.shape[1])
    if c % groups:
        raise ValueError(f"GroupNorm: {c} channels do not divide into {groups} groups")
    xg = x.float().reshape(n, groups, -1)
    mean = xg.mean(-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean, min=0.0)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    return y * weight.float().view(shape) + bias.float().view(shape)


class FRN(nn.Module):
    """Filter Response Normalization with its thresholded linear unit
    (multitalent_tpu/models/blocks.py:FRN; the reference's FRN3D):
    y = x * rsqrt(mean(x^2 over the spatial axes) + eps), then
    max(weight * y + bias, tau), in fp32, cast to x's dtype. It takes the
    place of the activation."""

    def __init__(self, channels: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.tau = nn.Parameter(torch.zeros(channels))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        nu2 = (xf * xf).mean(dim=tuple(range(2, x.dim())), keepdim=True)
        shape = (1, -1) + (1,) * (x.dim() - 2)
        y = xf * torch.rsqrt(nu2 + self.eps)
        return torch.maximum(self.weight.view(shape) * y + self.bias.view(shape),
                             self.tau.view(shape)).to(x.dtype)


def norm_module(norm: str, channels: int, ndim: int) -> nn.Module | None:
    """The parameters of a block's norm (make_norm of the JAX package); None
    for "none". Batch norm keeps no running statistics; group norm raises
    where the channels do not divide into 8 groups."""
    if norm == "instance":
        return instance_norm_module(channels, ndim)
    if norm == "batch":
        cls = nn.BatchNorm3d if ndim == 3 else nn.BatchNorm2d
        return cls(channels, eps=1e-5, affine=True, track_running_stats=False)
    if norm == "group":
        if channels % GROUPS:
            raise ValueError(f"GroupNorm: {channels} channels do not divide into {GROUPS} "
                             "groups")
        return nn.GroupNorm(GROUPS, channels, eps=1e-5)
    if norm == "frn":
        return FRN(channels)
    if norm == "none":
        return None
    raise ValueError(f"unknown norm {norm!r}: one of {NORMS}")


def activate(x: torch.Tensor, nonlin: str, negative_slope: float = 1e-2) -> torch.Tensor:
    """The JAX package's apply_nonlin: LeakyReLU, ReLU, GELU (flax's default,
    the tanh approximation), Mish (x tanh(softplus(x))), or none."""
    if nonlin == "leaky_relu":
        return F.leaky_relu(x, negative_slope)
    if nonlin == "relu":
        return F.relu(x)
    if nonlin == "gelu":
        return F.gelu(x, approximate="tanh")
    if nonlin == "mish":
        return F.mish(x)
    if nonlin == "none":
        return x
    raise ValueError(f"unknown nonlin {nonlin!r}: one of {NONLINS}")


def normalize(x: torch.Tensor, norm: str, module: nn.Module | None, nonlin: str,
              negative_slope: float = 1e-2) -> torch.Tensor:
    """A block's norm and activation after its conv (ConvNormAct of the JAX
    package): instance + LeakyReLU through instance_norm_lrelu (kernel E
    under MTTPU_PALLAS_NORM=1); FRN's TLU replaces the activation; group
    norm's fp32 result takes the activation in fp32, then x's dtype (the
    next conv's cast in the JAX package); the others cast to x's dtype
    first."""
    if norm not in ("instance", "none") and mesh.current() is not None:
        raise NotImplementedError(f"norm {norm!r} on a slab of the space axis: only the "
                                  f"instance norm pools its statistics (ROADMAP queue 1, "
                                  f"item 14f)")
    if norm == "instance" and nonlin == "leaky_relu":
        return instance_norm_lrelu(x, module.weight, module.bias, negative_slope, module.eps)
    if norm == "frn":
        return module(x)
    if norm == "instance":
        y = instance_norm(x, module.weight, module.bias, module.eps)
    elif norm == "batch":
        y = batch_norm(x, module.weight, module.bias, module.eps)
    elif norm == "group":
        return activate(group_norm(x, module.weight, module.bias, module.num_groups,
                                   module.eps), nonlin, negative_slope).to(x.dtype)
    else:
        y = x
    return activate(y, nonlin, negative_slope)


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
        """The weight in the kernel's layout and `dtype` (the model dtype:
        bf16, or fp32 for the kernels' fp32 forms), prepared once per weight (device,
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
        same model-dtype inputs and weights the kernels see. Under an active
        space axis x (and skip) are this rank's slabs, and so is the
        output."""
        space = mesh.current()
        if space is None:
            return self._conv(x, skip, use_kernels, self.padding)
        # the planes the taps reach beyond the slab: the padding's on the
        # left, on the right what the last output's window passes the slab by
        ax = space.axis
        k, s, p = self.kernel_size[ax], self.stride[ax], self.padding[ax]
        left, right = p, max(0, k - s - p)
        xe = mesh.halo(x, left, right, space)
        se = None if skip is None else mesh.halo(skip.to(x.dtype), left, right, space)
        if self.route is not None:  # SAME over the extended slab: drop its outer planes
            out = self._conv(xe, se, use_kernels, self.padding)
            return out.narrow(space.dim, left, x.shape[space.dim]).contiguous(memory_format=CL)
        padding = list(self.padding)
        padding[ax] = 0
        return self._conv(xe, se, use_kernels, tuple(padding))

    def _conv(self, x: torch.Tensor, skip: torch.Tensor | None, use_kernels: bool,
              padding) -> torch.Tensor:
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
                        self.stride, padding)


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with symmetric (k - 1) // 2 padding, on cuDNN in x's dtype:
    a 2D plan's convs (the JAX package runs them as flax nn.Conv in XLA, off
    its Pallas kernels). The forward takes KernelConv3d's arguments; a 2D
    block reads one input (the decoder concatenates before its first
    conv)."""

    route = None

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3),
                 stride=(1, 1), bias: bool = True):
        kernel_size = tuple(int(k) for k in kernel_size)
        super().__init__(in_channels, out_channels, kernel_size, tuple(int(s) for s in stride),
                         padding=tuple((k - 1) // 2 for k in kernel_size), bias=bias)

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        if skip is not None:
            raise ValueError("a 2D conv reads one input")
        return F.conv2d(x, self.weight.to(x.dtype),
                        None if self.bias is None else self.bias.to(x.dtype), self.stride,
                        self.padding)


def make_conv(in_channels: int, out_channels: int, kernel_size, stride=None,
              in_splits: tuple[int, int] | None = None, bias: bool = True) -> nn.Module:
    """The conv of a block of the kernel size's rank: KernelConv3d in 3D,
    Conv2dSame in 2D."""
    kernel_size = tuple(int(k) for k in kernel_size)
    stride = (1,) * len(kernel_size) if stride is None else tuple(int(s) for s in stride)
    if len(kernel_size) == 3:
        return KernelConv3d(in_channels, out_channels, kernel_size, stride, in_splits, bias)
    if len(kernel_size) == 2:
        return Conv2dSame(in_channels, out_channels, kernel_size, stride, bias)
    raise ValueError(f"kernel size {kernel_size}: 2D or 3D only")


def kernel_launches_per_forward(net: nn.Module) -> dict[str, int]:
    """Launches of each hand-written conv kernel that one forward of `net`
    makes: one for every KernelConv3d on a kernel route. The names are the
    bf16 kernels'; an fp32 network launches the same counts of their fp32
    forms (`fp32_forms`)."""
    counts = {"conv3d_same": 0, "conv3d_same_dual": 0}
    for m in net.modules():
        if isinstance(m, KernelConv3d) and m.route is not None:
            counts[m.route] += 1
    return counts


def kernel_launches_per_step(net: nn.Module, input_conv: nn.Module) -> dict[str, int]:
    """Launches of each hand-written kernel that one training step (forward
    + backward) of `net` makes: every kernel conv's forward (A or B), its dx
    by kernel A (unless it is `input_conv`, which reads the network's input
    and so needs no gradient) and its dw by kernel C (single or dual form)."""
    counts = kernel_launches_per_forward(net)
    kernels = sum(counts.values())
    counts["conv3d_same"] += kernels - (getattr(input_conv, "route", None) is not None)
    counts["conv3d_same_wgrad"] = kernels
    return counts


def fp32_forms(counts: dict[str, int]) -> dict[str, int]:
    """Launch counts of the kernels renamed to their fp32 forms
    (ops/conv3d.py: conv3d_same_fp32, ..., conv3d_same_affine_fp32;
    ops/fused_norm.py: channel_stats_fp32, affine_lrelu_fp32; ops/seghead.py:
    seghead_fp32), which an fp32 network launches instead."""
    return {f"{k}_fp32": v for k, v in counts.items()}


class ConvDropoutNormNonlin(nn.Module):
    """conv -> norm -> activation (InstanceNorm -> LeakyReLU by default), or
    with `nonlin_first` conv -> activation -> norm (ConvDropoutNonlinNorm).
    `in_splits` = (Ca, Cb) makes the conv read concat(a, b) from two tensors
    (kernel B). The norm is registered as `norm_name`: `instnorm` in the
    GenericUNet (whatever its kind, as the reference names it), `norm` in the
    residual UNet's decoder; a block without a norm has none."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3),
                 stride=None, in_splits: tuple[int, int] | None = None,
                 negative_slope: float = 1e-2, norm_name: str = "instnorm",
                 norm: str = "instance", nonlin: str = "leaky_relu",
                 nonlin_first: bool = False):
        super().__init__()
        self.conv = make_conv(in_channels, out_channels, kernel_size, stride, in_splits)
        self.norm_name = norm_name
        self.norm_kind = norm
        self.nonlin = nonlin
        self.nonlin_first = nonlin_first
        module = norm_module(norm, out_channels, len(tuple(kernel_size)))
        if module is not None:
            self.add_module(norm_name, module)
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
        y = self.conv(x, skip, use_kernels=use_kernels)
        norm = getattr(self, self.norm_name, None)
        if self.nonlin_first:
            # the norm then runs without an activation of its own (FRN keeps its TLU)
            return normalize(activate(y, self.nonlin, self.negative_slope), self.norm_kind,
                             norm, "none")
        return normalize(y, self.norm_kind, norm, self.nonlin, self.negative_slope)


class StackedConvLayers(nn.Module):
    """`num_convs` blocks; the first may be strided (convolutional pooling) or
    read two inputs. StackedConvLayers parity (generic_UNet.py:89-144)."""

    def __init__(self, in_channels: int, out_channels: int, num_convs: int,
                 kernel_size=(3, 3, 3), first_stride=None,
                 in_splits: tuple[int, int] | None = None, **block):
        super().__init__()
        self.blocks = nn.Sequential(*[
            ConvDropoutNormNonlin(
                in_channels if i == 0 else out_channels, out_channels, kernel_size,
                stride=first_stride if i == 0 else None,
                in_splits=in_splits if i == 0 else None, **block)
            for i in range(num_convs)])

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        for i, block in enumerate(self.blocks):
            x = block(x, skip if i == 0 else None, use_kernels=use_kernels)
        return x
