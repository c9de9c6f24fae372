"""Stride-1 SAME 3x3x3 convolutions and their gradients on hand-written
Hopper kernels.

Counterparts of the Pallas kernels of multitalent_tpu:

- `conv3d_same` (kernel A) replaces `ops/pallas_conv.py:_conv_kernel` and,
  because the port runs unpacked at the true channel count, the function of
  `ops/pallas_merged_conv.py:_merged_kernel`
  (`space_to_depth(conv3d_same(depth_to_space(x), w))`). With the flipped,
  transposed weight it also computes dL/dx (`conv3d_same_dx`, the rule of
  `pallas_conv.py:conv3d_same_dx`).
- `conv3d_same_dual` (kernel B) replaces
  `ops/pallas_merged_conv.py:_merged2_kernel`: the conv over
  `concat(a, b)` along channels, without building the concat.
- `conv3d_same_wgrad` (kernel C) replaces `ops/pallas_conv.py:_wgrad_kernel`
  and, unpacked, `ops/pallas_merged_conv.py:_merged_wgrad_kernel`: dL/dw in
  fp32. `conv3d_same_wgrad_dual` is its form for kernel B's conv.
- `conv3d_same_affine` (kernel D) replaces
  `ops/pallas_conv.py:_conv_affine_kernel`, the fused conv -> InstanceNorm
  chain's conv: `conv(lrelu(bf16(x * scale + shift))) + bias` on the
  previous conv's raw output with the SAME halo at zero, returning the
  output and its per-sample channel sum and sum of squares (N, 2, Cout).
  `conv3d_same_dual_stats` is its dual form (kernel B's conv plus the stats)
  for a decoder's first conv.

Kernels A, B and D live in `csrc/conv3d_same.cu`, kernel C in
`csrc/conv3d_wgrad.cu`. Tensors are channels-last (N, Z, Y, X, C), the layout
of the JAX package and the physical layout of a `torch.channels_last_3d`
NCDHW tensor. Weights are prepared with `prepare_conv3d_weight`.

`Conv3dSame` and `Conv3dSameDual` are the autograd functions of the two
convs: forward through A or B, dx through A, dw through C, db a sum of the
output gradient. `Conv3dSameAffine` and `Conv3dSameDualStats` are kernel D's:
forward through D, the rest as `pallas_conv.py:_affine_fast_bwd` computes it.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version (`conv3d_same_ref`, `conv3d_same_dual_ref`,
`conv3d_same_wgrad_ref`, `conv3d_same_wgrad_dual_ref`,
`conv3d_same_affine_ref`, `conv3d_same_dual_stats_ref`) only for tensors that
lie on the CPU. Each keeps a count of kernel launches in its `launches`
attribute.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from multitalent_tpu_torch.ops.fused_norm import affine_lrelu_ref, channel_stats_ref

KC = 16  # input channels per K chunk of the kernel


def _block_n(cout: int) -> int:
    """Output channels per block: 32 for the narrow stage-0 convs, else 64."""
    return 32 if cout <= 32 else 64


@dataclass(frozen=True)
class PreparedWeight:
    """Weights in the kernel's layout (kchunks, 27, 16, CoutP) bf16.

    `splits` are the input channel counts of the inputs the conv reads, in
    order ((Cin,) for kernel A, (Ca, Cb) for kernel B); each input's channels
    fill whole 16-row K chunks, zero past its count. Taps run (dz, dy, dx)
    row-major; output channels are zero-padded to a multiple of `bn`."""

    w: torch.Tensor
    splits: tuple[int, ...]
    cout: int
    bn: int

    @property
    def coutp(self) -> int:
        return int(self.w.shape[-1])


def prepare_conv3d_weight(weight: torch.Tensor, splits=None,
                          dtype=torch.bfloat16) -> PreparedWeight:
    """torch Conv3d weight (Cout, Cin, 3, 3, 3) -> the kernel's layout."""
    cout, cin = int(weight.shape[0]), int(weight.shape[1])
    if tuple(weight.shape[2:]) != (3, 3, 3):
        raise ValueError(f"expected a 3x3x3 kernel, got {tuple(weight.shape)}")
    splits = (cin,) if splits is None else tuple(int(s) for s in splits)
    if sum(splits) != cin:
        raise ValueError(f"splits {splits} do not add up to Cin={cin}")
    bn = _block_n(cout)
    coutp = -(-cout // bn) * bn
    parts, lo = [], 0
    for c in splits:
        kpad = -(-c // KC) * KC
        taps = weight[:, lo:lo + c].permute(2, 3, 4, 1, 0).reshape(27, c, cout)
        taps = F.pad(taps.to(torch.promote_types(dtype, torch.float32)),
                     (0, coutp - cout, 0, kpad - c))
        parts.append(taps.reshape(27, kpad // KC, KC, coutp).permute(1, 0, 2, 3))
        lo += c
    w = torch.cat(parts, 0).to(dtype).contiguous()
    return PreparedWeight(w=w, splits=splits, cout=cout, bn=bn)


def unprepare_conv3d_weight(pw: PreparedWeight) -> torch.Tensor:
    """Inverse of prepare_conv3d_weight: (Cout, Cin, 3, 3, 3) in pw's dtype."""
    parts, k0 = [], 0
    for c in pw.splits:
        nk = -(-c // KC)
        taps = pw.w[k0:k0 + nk].permute(1, 0, 2, 3).reshape(27, nk * KC, pw.coutp)
        parts.append(taps[:, :c, :pw.cout])
        k0 += nk
    taps = torch.cat(parts, 1)  # (27, Cin, Cout)
    return taps.permute(2, 1, 0).reshape(pw.cout, -1, 3, 3, 3)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _acc_dtype(t: torch.Tensor) -> torch.dtype:
    """The plain versions accumulate in fp32, or in fp64 for fp64 input (the
    gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def conv3d_same_ref(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel A: F.conv3d in fp32 on channels-last input
    (N, Z, Y, X, Cin) with a torch weight (Cout, Cin, 3, 3, 3); the result is
    cast to x's dtype."""
    acc = _acc_dtype(x)
    out = F.conv3d(x.permute(0, 4, 1, 2, 3).to(acc), weight.to(acc),
                   None if bias is None else bias.to(acc), padding=1)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3d_same_dual_ref(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel B: torch.cat along channels, then F.conv3d."""
    return conv3d_same_ref(torch.cat((a, b.to(a.dtype)), dim=-1), weight, bias)


def conv3d_same_affine_ref(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor | None = None,
                           scale: torch.Tensor | None = None,
                           shift: torch.Tensor | None = None,
                           negative_slope: float = 1e-2
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D (pallas_conv.py:_ref_conv_affine): with
    scale, shift (N, Cin) the input is lrelu(x * scale + shift) rounded to x's
    dtype before the activation; SAME zero padding of that; the conv in fp32
    plus bias, rounded to x's dtype; stats (N, 2, Cout) of the rounded output.
    Differentiable by autograd."""
    y = x if scale is None else affine_lrelu_ref(x, scale, shift, negative_slope, True)
    out = conv3d_same_ref(y, weight, bias)
    return out, channel_stats_ref(out)


def conv3d_same_dual_stats_ref(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor | None = None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of kernel D's dual form: kernel B's conv and its stats."""
    out = conv3d_same_dual_ref(a, b, weight, bias)
    return out, channel_stats_ref(out)


def conv3d_same_wgrad_ref(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C: dL/dw (Cout, Cin, 3, 3, 3) in fp32 of the
    SAME conv of channels-last x (N, Z, Y, X, Cin) whose output gradient is g
    (N, Z, Y, X, Cout), by torch.nn.grad.conv3d_weight."""
    acc = _acc_dtype(x)
    shape = (int(g.shape[-1]), int(x.shape[-1]), 3, 3, 3)
    return torch.nn.grad.conv3d_weight(x.permute(0, 4, 1, 2, 3).to(acc), shape,
                                       g.permute(0, 4, 1, 2, 3).to(acc), padding=1)


def conv3d_same_wgrad_dual_ref(a: torch.Tensor, b: torch.Tensor,
                               g: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel C's dual form: the wgrad on concat(a, b)."""
    return conv3d_same_wgrad_ref(torch.cat((a, b.to(a.dtype)), dim=-1), g)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_input(t: torch.Tensor, name: str, like: torch.Tensor) -> None:
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if t.dim() != 5:
        raise ValueError(f"{name}: expected (N, Z, Y, X, C), got {tuple(t.shape)}")
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous channels-last "
                         "tensor (a channels_last_3d NCDHW tensor permuted to "
                         "NDHWC)")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def _check_weight(pw: PreparedWeight, splits: tuple[int, ...],
                  x: torch.Tensor, bias: torch.Tensor | None) -> None:
    if pw.splits != splits:
        raise ValueError(f"prepared weight takes inputs of {pw.splits} "
                         f"channels, got {splits}")
    if pw.w.dtype != torch.bfloat16 or pw.w.device != x.device:
        raise ValueError("prepared weight must be bfloat16 on the input's "
                         "device")
    if not pw.w.is_contiguous() or pw.w.data_ptr() % 16:
        raise ValueError("prepared weight must be contiguous and 16-byte aligned")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != x.device
                or tuple(bias.shape) != (pw.cout,) or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous float32 ({pw.cout},) "
                             "tensor on the input's device")


def _launch(name: str, inputs: list[torch.Tensor], pw: PreparedWeight,
            bias: torch.Tensor | None) -> torch.Tensor:
    """Run C entry `name` on checked inputs; allocates the output and, for
    small grids that split the K loop, the kernel's fp32 workspace."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    out = torch.empty((n, z, y, xd, pw.cout), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        nbytes = lib.mt_conv3d_workspace(n, z, y, xd, cs[0], sum(cs[1:]), pw.cout,
                                         pw.coutp, pw.bn)
        if nbytes < 0:
            raise ValueError(f"{name}: the kernel does not take these sizes")
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev) if nbytes else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, name)(
            *(t.data_ptr() for t in inputs), pw.w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), nbytes, n, z, y, xd, *cs,
            pw.cout, pw.coutp, pw.bn, stream)
    _build.check(lib, code, name)
    return out


def conv3d_same(x: torch.Tensor, pw: PreparedWeight,
                bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: stride-1 SAME 3x3x3 conv of x (N, Z, Y, X, Cin) -> (N, Z, Y,
    X, Cout), fp32 accumulation, fp32 bias in the epilogue, bf16 out.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_ref."""
    if x.device.type == "cpu":
        return conv3d_same_ref(x, unprepare_conv3d_weight(pw), bias)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same: unsupported device {x.device}")
    _check_input(x, "x", x)
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    out = _launch("mt_conv3d_same", [x], pw, bias)
    conv3d_same.launches += 1
    return out


conv3d_same.launches = 0


def conv3d_same_dual(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                     bias: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B: conv3d_same over concat(a, b) along channels (order [a | b],
    as torch.cat((a, b), 1) in NCDHW), without building the concat.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_dual_ref."""
    if a.device.type == "cpu":
        return conv3d_same_dual_ref(a, b, unprepare_conv3d_weight(pw), bias)
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual: unsupported device {a.device}")
    _check_input(a, "a", a)
    _check_input(b, "b", a)
    if a.shape[:4] != b.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ "
                         "outside the channel axis")
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out = _launch("mt_conv3d_same_dual", [a, b], pw, bias)
    conv3d_same_dual.launches += 1
    return out


conv3d_same_dual.launches = 0


def _launch_wgrad(name: str, inputs: list[torch.Tensor], g: torch.Tensor) -> torch.Tensor:
    """Run kernel C's C entry `name`: allocates dw and the fp32 workspace of
    per-block partial sums whose size the library reports."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = g.device
    n, z, y, xd = (int(s) for s in g.shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    cout = int(g.shape[-1])
    dw = torch.empty((cout, sum(cs), 3, 3, 3), dtype=torch.float32, device=dev)
    if g.numel() == 0:
        return dw.zero_()
    with torch.cuda.device(dev):
        nbytes = lib.mt_conv3d_wgrad_workspace(n, z, y, xd, cs[0], sum(cs[1:]), cout)
        if nbytes <= 0:
            raise ValueError(f"{name}: the kernel does not take these sizes")
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, name)(
            *(t.data_ptr() for t in inputs), g.data_ptr(), dw.data_ptr(), ws.data_ptr(),
            nbytes, n, z, y, xd, *cs, cout, stream)
    _build.check(lib, code, name)
    return dw


def conv3d_same_wgrad(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel C: dL/dw (Cout, Cin, 3, 3, 3) fp32 of the stride-1 SAME 3x3x3
    conv of x (N, Z, Y, X, Cin) whose output gradient is g (N, Z, Y, X, Cout).

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_wgrad_ref."""
    if x.device.type == "cpu":
        return conv3d_same_wgrad_ref(x, g)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad: unsupported device {x.device}")
    _check_input(x, "x", x)
    _check_input(g, "g", x)
    if x.shape[:4] != g.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ "
                         "outside the channel axis")
    dw = _launch_wgrad("mt_conv3d_wgrad", [x], g)
    conv3d_same_wgrad.launches += 1
    return dw


conv3d_same_wgrad.launches = 0


def conv3d_same_wgrad_dual(a: torch.Tensor, b: torch.Tensor,
                           g: torch.Tensor) -> torch.Tensor:
    """Kernel C, dual form: dL/dw (Cout, Ca + Cb, 3, 3, 3) fp32 of kernel B's
    conv over concat(a, b), without building the concat. Its launches count
    on `conv3d_same_wgrad.launches`, as one kernel.

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_wgrad_dual_ref."""
    if a.device.type == "cpu":
        return conv3d_same_wgrad_dual_ref(a, b, g)
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad_dual: unsupported device {a.device}")
    _check_input(a, "a", a)
    _check_input(b, "b", a)
    _check_input(g, "g", a)
    if a.shape[:4] != b.shape[:4] or a.shape[:4] != g.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)} and g "
                         f"{tuple(g.shape)} differ outside the channel axis")
    dw = _launch_wgrad("mt_conv3d_wgrad_dual", [a, b], g)
    conv3d_same_wgrad.launches += 1
    return dw


def _launch_stats(name: str, inputs: list[torch.Tensor], pw: PreparedWeight,
                  bias: torch.Tensor | None, affine: tuple = ()
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Run kernel D's C entry `name`: allocates the output, the stats and the
    workspace (split-K partials, per-block stats partials) the library
    reports. `affine` is (scale, shift, slope) for the prologue."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    out = torch.empty((n, z, y, xd, pw.cout), dtype=torch.bfloat16, device=dev)
    stats = torch.empty((n, 2, pw.cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out, stats.zero_()
    with torch.cuda.device(dev):
        nbytes = lib.mt_conv3d_stats_workspace(n, z, y, xd, cs[0], sum(cs[1:]), pw.cout,
                                               pw.coutp, pw.bn)
        if nbytes <= 0:
            raise ValueError(f"{name}: the kernel does not take these sizes")
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        bias_ptr = None if bias is None else bias.data_ptr()
        if affine:
            scale, shift, slope = affine
            code = getattr(lib, name)(
                inputs[0].data_ptr(), pw.w.data_ptr(), bias_ptr,
                None if scale is None else scale.data_ptr(),
                None if shift is None else shift.data_ptr(), float(slope), out.data_ptr(),
                stats.data_ptr(), ws.data_ptr(), nbytes, n, z, y, xd, cs[0], pw.cout,
                pw.coutp, pw.bn, stream)
        else:
            code = getattr(lib, name)(
                *(t.data_ptr() for t in inputs), pw.w.data_ptr(), bias_ptr, out.data_ptr(),
                stats.data_ptr(), ws.data_ptr(), nbytes, n, z, y, xd, *cs, pw.cout,
                pw.coutp, pw.bn, stream)
    _build.check(lib, code, name)
    return out, stats


def conv3d_same_affine(x: torch.Tensor, pw: PreparedWeight,
                       bias: torch.Tensor | None = None,
                       scale: torch.Tensor | None = None,
                       shift: torch.Tensor | None = None,
                       negative_slope: float = 1e-2
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (out, stats) = (conv(lrelu(bf16(x * scale + shift))) + bias,
    its per-sample channel sum and sum of squares (N, 2, Cout) fp32) for the
    previous conv's raw output x (N, Z, Y, X, Cin) and the next norm's scale,
    shift (N, Cin) fp32; without scale and shift, conv(x) + bias and its
    stats. out is bf16, the stats are taken over its rounded values.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_affine_ref."""
    if x.device.type == "cpu":
        return conv3d_same_affine_ref(x, unprepare_conv3d_weight(pw), bias, scale, shift,
                                      negative_slope)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_affine: unsupported device {x.device}")
    _check_input(x, "x", x)
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    n, cin = int(x.shape[0]), int(x.shape[-1])
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (n, cin)
                              or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({n}, {cin}) tensor "
                             f"on {x.device}")
    out = _launch_stats("mt_conv3d_same_affine", [x], pw, bias,
                        (scale, shift, negative_slope))
    conv3d_same_affine.launches += 1
    return out


conv3d_same_affine.launches = 0


def conv3d_same_dual_stats(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                           bias: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D, dual form: kernel B's conv over concat(a, b) and the stats of
    its bf16 output, (out, stats (N, 2, Cout) fp32). Its launches count on
    `conv3d_same_affine.launches`, as one kernel.

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_dual_stats_ref."""
    if a.device.type == "cpu":
        return conv3d_same_dual_stats_ref(a, b, unprepare_conv3d_weight(pw), bias)
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual_stats: unsupported device {a.device}")
    _check_input(a, "a", a)
    _check_input(b, "b", a)
    if a.shape[:4] != b.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ "
                         "outside the channel axis")
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out = _launch_stats("mt_conv3d_same_dual_stats", [a, b], pw, bias)
    conv3d_same_affine.launches += 1
    return out


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def conv3d_same_dx(g: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """dL/dx (N, Z, Y, X, Cin) of the SAME conv with `weight` (Cout, Cin, 3,
    3, 3), given its output gradient g: kernel A on the spatially flipped,
    transposed weight, prepared in g's dtype (ops/pallas_conv.py:651-659)."""
    pw = prepare_conv3d_weight(weight.detach().flip(2, 3, 4).transpose(0, 1),
                               dtype=g.dtype)
    return conv3d_same(g, pw)


def _grad_output(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The output gradient as the kernels take it: contiguous channels-last in
    the conv's dtype (autograd may hand back other strides)."""
    return g.to(dtype).contiguous()


def _bias_grad(g: torch.Tensor) -> torch.Tensor:
    return g.to(_acc_dtype(g)).sum(dim=(0, 1, 2, 3))


class Conv3dSame(torch.autograd.Function):
    """conv3d_same with its gradient: dx by kernel A on the flipped weight,
    dw by kernel C (fp32, for the fp32 master weight), db = sum of g in fp32.
    `pw` is `weight` prepared for the forward kernel."""

    @staticmethod
    def forward(ctx, x, weight, bias, pw):
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return conv3d_same(x, pw, None if bias is None else bias.to(_acc_dtype(x)))

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        g = _grad_output(g, x.dtype)
        dx = conv3d_same_dx(g, weight) if ctx.needs_input_grad[0] else None
        dw = conv3d_same_wgrad(x, g).to(weight.dtype) if ctx.needs_input_grad[1] else None
        db = _bias_grad(g) if ctx.has_bias and ctx.needs_input_grad[2] else None
        return dx, dw, db, None


class Conv3dSameDual(torch.autograd.Function):
    """conv3d_same_dual with its gradient: one kernel-A launch gives
    d(concat(a, b)), split along channels into da and db; dw by kernel C's
    dual form."""

    @staticmethod
    def forward(ctx, a, b, weight, bias, pw):
        ctx.save_for_backward(a, b, weight)
        ctx.has_bias = bias is not None
        return conv3d_same_dual(a, b, pw,
                                None if bias is None else bias.to(_acc_dtype(a)))

    @staticmethod
    def backward(ctx, g):
        a, b, weight = ctx.saved_tensors
        g = _grad_output(g, a.dtype)
        da = db_in = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d = conv3d_same_dx(g, weight)
            ca = int(a.shape[-1])
            da, db_in = d[..., :ca].contiguous(), d[..., ca:].contiguous()
        dw = (conv3d_same_wgrad_dual(a, b, g).to(weight.dtype)
              if ctx.needs_input_grad[2] else None)
        dbias = _bias_grad(g) if ctx.has_bias and ctx.needs_input_grad[3] else None
        return da, db_in, dw, dbias, None


def _fold_stats_grad(g_out: torch.Tensor, g_stats: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """The output gradient with the stats' folded in (stats = [sum(out),
    sum(out^2)] per sample and channel): G = g_out + g_sum + 2 out g_sq, in
    fp32 (pallas_conv.py:599-601)."""
    acc = _acc_dtype(out)
    shape = (int(out.shape[0]), 1, 1, 1, int(out.shape[-1]))
    return (g_out.to(acc) + g_stats[:, 0].to(acc).reshape(shape)
            + 2.0 * out.to(acc) * g_stats[:, 1].to(acc).reshape(shape))


class Conv3dSameAffine(torch.autograd.Function):
    """conv3d_same_affine with its gradient, both outputs differentiable, as
    pallas_conv.py:_affine_fast_bwd: the stats' cotangents fold into the
    output's (G); y = lrelu(bf16(x * scale + shift)) is recomputed, not
    saved; dw by kernel C on (y, G), dY by kernel A on the flipped weight;
    db, dx, dscale and dshift are elementwise sums in plain torch (the JAX
    package leaves them to XLA). `pw` is `weight` prepared for the forward
    kernel; scale and shift may both be None (no prologue)."""

    @staticmethod
    def forward(ctx, x, weight, bias, scale, shift, pw, negative_slope):
        acc = _acc_dtype(x)
        out, stats = conv3d_same_affine(
            x, pw, None if bias is None else bias.to(acc),
            None if scale is None else scale.to(acc).contiguous(),
            None if shift is None else shift.to(acc).contiguous(), negative_slope)
        ctx.save_for_backward(x, weight, scale, shift, out)
        ctx.has_bias = bias is not None
        ctx.negative_slope = negative_slope
        return out, stats

    @staticmethod
    def backward(ctx, g_out, g_stats):
        x, weight, scale, shift, out = ctx.saved_tensors
        acc = _acc_dtype(x)
        G = _fold_stats_grad(g_out, g_stats, out)
        G16 = G.to(x.dtype).contiguous()
        dbias = G.sum(dim=(0, 1, 2, 3)) if ctx.has_bias and ctx.needs_input_grad[2] else None
        affine = scale is not None
        slope = ctx.negative_slope
        dw = None
        if ctx.needs_input_grad[1]:
            y = affine_lrelu_ref(x, scale, shift, slope, True) if affine else x
            dw = conv3d_same_wgrad(y.contiguous(), G16).to(weight.dtype)
        if not any(ctx.needs_input_grad[i] for i in (0, 3, 4)):
            return None, dw, dbias, None, None, None, None
        dY = conv3d_same_dx(G16, weight)
        if not affine:
            return dY.to(x.dtype), dw, dbias, None, None, None, None
        s = scale.to(acc).reshape(int(x.shape[0]), 1, 1, 1, -1)
        t = shift.to(acc).reshape(int(x.shape[0]), 1, 1, 1, -1)
        # y16 = cast(x s + t); lrelu'(y16) = 1 where y16 >= 0, else the slope
        y16 = (x.to(acc) * s + t).to(x.dtype)
        dy16 = torch.where(y16 >= 0, dY, dY * slope).to(acc)
        dx = (dy16 * s).to(x.dtype)
        ds = (dy16 * x.to(acc)).sum(dim=(1, 2, 3))
        dt = dy16.sum(dim=(1, 2, 3))
        return dx, dw, dbias, ds.to(scale.dtype), dt.to(shift.dtype), None, None


class Conv3dSameDualStats(torch.autograd.Function):
    """conv3d_same_dual_stats with its gradient: the stats' cotangents fold
    into the output's (G); one kernel-A launch gives d(concat(a, b)), split
    into da and db; dw by kernel C's dual form; db of the bias a sum of G."""

    @staticmethod
    def forward(ctx, a, b, weight, bias, pw):
        out, stats = conv3d_same_dual_stats(a, b, pw,
                                            None if bias is None else bias.to(_acc_dtype(a)))
        ctx.save_for_backward(a, b, weight, out)
        ctx.has_bias = bias is not None
        return out, stats

    @staticmethod
    def backward(ctx, g_out, g_stats):
        a, b, weight, out = ctx.saved_tensors
        G = _fold_stats_grad(g_out, g_stats, out)
        G16 = G.to(a.dtype).contiguous()
        da = db_in = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            d = conv3d_same_dx(G16, weight)
            ca = int(a.shape[-1])
            da, db_in = d[..., :ca].contiguous(), d[..., ca:].contiguous()
        dw = (conv3d_same_wgrad_dual(a, b, G16).to(weight.dtype)
              if ctx.needs_input_grad[2] else None)
        dbias = G.sum(dim=(0, 1, 2, 3)) if ctx.has_bias and ctx.needs_input_grad[3] else None
        return da, db_in, dw, dbias, None


def conv3d_same_op(x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None = None,
                   pw: PreparedWeight | None = None) -> torch.Tensor:
    """Differentiable kernel-A conv of channels-last x with the torch weight
    (Cout, Cin, 3, 3, 3); `pw` is that weight prepared in x's dtype (prepared
    here when not given)."""
    if pw is None:
        pw = prepare_conv3d_weight(weight.detach(), dtype=x.dtype)
    return Conv3dSame.apply(x, weight, bias, pw)


def conv3d_same_dual_op(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor | None = None,
                        pw: PreparedWeight | None = None) -> torch.Tensor:
    """Differentiable kernel-B conv over concat(a, b)."""
    if pw is None:
        pw = prepare_conv3d_weight(weight.detach(), (int(a.shape[-1]), int(b.shape[-1])),
                                   dtype=a.dtype)
    return Conv3dSameDual.apply(a, b, weight, bias, pw)


def conv3d_same_affine_op(x: torch.Tensor, weight: torch.Tensor,
                          bias: torch.Tensor | None = None,
                          scale: torch.Tensor | None = None,
                          shift: torch.Tensor | None = None,
                          negative_slope: float = 1e-2,
                          pw: PreparedWeight | None = None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable kernel-D conv: (out, stats) of channels-last x with the
    torch weight (Cout, Cin, 3, 3, 3) and the prologue's scale, shift (N,
    Cin) (or neither); `pw` is that weight prepared in x's dtype."""
    if pw is None:
        pw = prepare_conv3d_weight(weight.detach(), dtype=x.dtype)
    return Conv3dSameAffine.apply(x, weight, bias, scale, shift, pw, negative_slope)


def conv3d_same_dual_stats_op(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                              bias: torch.Tensor | None = None,
                              pw: PreparedWeight | None = None
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Differentiable kernel-D dual conv over concat(a, b): (out, stats)."""
    if pw is None:
        pw = prepare_conv3d_weight(weight.detach(), (int(a.shape[-1]), int(b.shape[-1])),
                                   dtype=a.dtype)
    return Conv3dSameDualStats.apply(a, b, weight, bias, pw)
