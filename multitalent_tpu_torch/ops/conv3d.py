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

Kernels A, B, C and D take bf16 (fp32 accumulation, bf16 out for A, B
and D) and, for the networks that compute in fp32 (`--fp32`,
nnUNetTrainerV2_fp32), fp32: each wrapper sends fp32 inputs to the kernel's
fp32 form (`conv3d_same_fp32`, `conv3d_same_dual_fp32`,
`conv3d_same_wgrad_fp32`, `conv3d_same_affine_fp32` and
`conv3d_same_dual_stats_fp32`, plain FFMA without TF32, fp32 out), which
counts its launches on its own `launches` (C's and D's also by body,
`launches_by_body`: "ring"). Every fp32 A, B and D call (each dx too) runs
the ring body of `csrc/conv3d_fp32.cu` (conv_fp32_ring_kernel, planned by
`conv3d_same_fp32_plan`, with `stats=True` for D); every fp32 C call runs
that file's wgrad ring body (wgrad_fp32_ring_kernel, planned by
`conv3d_same_wgrad_fp32_plan`).

Kernels A, B and D live in `csrc/conv3d_same.cu` (A, B and D's dual form at
16-byte rows on the wgmma body of `csrc/conv3d_wgmma.cu`), kernel C in
`csrc/conv3d_wgrad.cu`, the fp32 forms in `csrc/conv3d_fp32.cu`. Tensors are channels-last (N, Z, Y, X, C), the layout
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
lie on the CPU (the fp32 forms the same plain versions, in fp32). Each keeps
a count of kernel launches in its `launches` attribute; kernels A, B and D
(both D forms on `conv3d_same_affine`) also count them by the body that ran
each (`launches_by_body`: "ring" or "wgmma"; the probes' packed conv runs
on the ring with A's plan, `conv3d_same_plan(..., "packed")`).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import prod

import torch
import torch.nn.functional as F

from multitalent_tpu_torch.ops.fused_norm import affine_lrelu_ref, channel_stats_ref
from multitalent_tpu_torch.probes._util import into

KC = 16  # input channels per K chunk of the kernel


def _block_n(cout: int) -> int:
    """Output channels per block: 32 for the narrow stage-0 convs, else 64."""
    return 32 if cout <= 32 else 64


@dataclass(frozen=True)
class PreparedWeight:
    """Weights in the kernel's layout (kchunks, 27, 16, CoutP), bf16 (or fp32
    for the fp32 forms).

    `splits` are the input channel counts of the inputs the conv reads, in
    order ((Cin,) for kernel A, (Ca, Cb) for kernel B); each input's channels
    fill whole 16-row K chunks, zero past its count. Taps run (dz, dy, dx)
    row-major; output channels are zero-padded to a multiple of `bn`.

    The same layout is the wgmma body's B operand: viewed as (rows =
    kchunks * 27 * 16, CoutP), a TMA box of 144 rows (9 taps) by 64 columns
    with the 128-byte swizzle lands as wgmma's MN-major operand, columns past
    CoutP read as 0 (`csrc/conv3d_wgmma.cu`; `ops/wgmma_layout.py` reads it
    as the card does)."""

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
    w = weight.new_zeros((sum(-(-c // KC) for c in splits), 27, KC, coutp), dtype=dtype)
    # views, one copy a split (a kernel launch and its host cost a call of
    # conv3d_same_dx): taps (Cin, 27, Cout) of the weight, and the layout's
    # (chunk, row, tap, column)
    taps = weight.permute(1, 2, 3, 4, 0).reshape(cin, 27, cout)
    rows = w.permute(0, 2, 1, 3)
    k0 = lo = 0
    for c in splits:
        full, rem = divmod(c, KC)
        if full:
            rows[k0:k0 + full, :, :, :cout] = taps[lo:lo + full * KC].reshape(full, KC, 27, cout)
        if rem:
            rows[k0 + full, :rem, :, :cout] = taps[lo + full * KC:lo + c]
        k0, lo = k0 + -(-c // KC), lo + c
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

# the input dtypes of kernels A, B, C and D (fp32: their fp32 forms)
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def _check_input(t: torch.Tensor, name: str, like: torch.Tensor,
                 dtypes: tuple = (torch.bfloat16,)) -> None:
    if t.dtype not in dtypes or t.dtype != like.dtype:
        names = " or ".join(str(d).removeprefix("torch.") for d in dtypes)
        raise TypeError(f"{name}: the kernel takes {names} inputs of one dtype, got "
                        f"{t.dtype} (beside {like.dtype})")
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
    if pw.w.dtype != x.dtype or pw.w.device != x.device:
        raise ValueError(f"prepared weight must be {x.dtype} on the input's device, got "
                         f"{pw.w.dtype} on {pw.w.device}")
    if not pw.w.is_contiguous() or pw.w.data_ptr() % 16:
        raise ValueError("prepared weight must be contiguous and 16-byte aligned")
    if bias is not None:
        if (bias.dtype != torch.float32 or bias.device != x.device
                or tuple(bias.shape) != (pw.cout,) or not bias.is_contiguous()):
            raise ValueError(f"bias must be a contiguous float32 ({pw.cout},) "
                             "tensor on the input's device")


def _buffer(given: torch.Tensor | None, name: str, shape: tuple, dtype: torch.dtype,
            dev: torch.device) -> torch.Tensor:
    """The caller's output buffer `given`, checked, or a new one."""
    if given is None:
        return torch.empty(shape, dtype=dtype, device=dev)
    if (given.dtype != dtype or tuple(given.shape) != shape or given.device != dev
            or not given.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous {dtype} {shape} tensor on {dev}")
    return given


# the bodies of kernels A, B and D by mt_conv3d_(stats_)launch_plan's codes
BODIES = ("ring", "wgmma")


def _launch(name: str, inputs: list[torch.Tensor], pw: PreparedWeight,
            bias: torch.Tensor | None, out: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, str | None]:
    """Run C entry `name` on checked inputs into `out` (or a new output);
    allocates, for small grids that split the K loop, the kernel's fp32
    workspace. Returns the output and the body the launch ran (None: an
    empty output, nothing launched)."""
    import ctypes

    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    out = _buffer(out, "out", (n, z, y, xd, pw.cout), torch.bfloat16, dev)
    if out.numel() == 0:
        return out, None
    body = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        nbytes = lib.mt_conv3d_launch_plan(n, z, y, xd, cs[0], sum(cs[1:]), pw.cout,
                                           pw.coutp, pw.bn, ctypes.byref(body))
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
    return out, BODIES[body.value]


def _count(wrapper, body: str | None) -> None:
    """One launch of `wrapper` (kernel A, B or D, or C's or D's fp32 form) on
    `body`."""
    wrapper.launches += 1
    if body is not None:
        wrapper.launches_by_body[body] += 1


def conv3d_same(x: torch.Tensor, pw: PreparedWeight,
                bias: torch.Tensor | None = None,
                out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A: stride-1 SAME 3x3x3 conv of x (N, Z, Y, X, Cin) -> (N, Z, Y,
    X, Cout), fp32 accumulation, fp32 bias in the epilogue, bf16 out, written
    into `out` where given.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_ref."""
    if x.device.type == "cpu":
        return into(out, conv3d_same_ref(x, unprepare_conv3d_weight(pw), bias))
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same: unsupported device {x.device}")
    _check_input(x, "x", x, KERNEL_DTYPES)
    if x.dtype == torch.float32:
        return conv3d_same_fp32(x, pw, bias, out)
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    out, body = _launch("mt_conv3d_same", [x], pw, bias, out)
    _count(conv3d_same, body)
    return out


conv3d_same.launches = 0
conv3d_same.launches_by_body = dict.fromkeys(BODIES, 0)

A_PLAN_KEYS = ("ring", "g", "resident", "ksplit", "stages", "splits", "grid_x",
               "blocks_per_sm", "smem_bytes", "wgmma", "wgmma_bn", "wgmma_splits",
               "wgmma_blocks", "wgmma_smem_bytes")
# the calls a plan is asked for: kernel A, B, D, D's dual form, the packed conv
PLAN_FORMS = ("a", "b", "d", "d_dual", "packed")


def conv3d_same_plan(n: int, z: int, y: int, x: int, cin, cout: int, form: str = "a") -> dict:
    """The plan of a call of kernel A (form "a"), B ("b"), D ("d"), D's dual
    form ("d_dual") or the packed conv ("packed": A's on the ring, K whole)
    on the current card at these sizes; cin is the input's channels, or (Ca,
    Cb) for the two-input forms. Whether it runs the ring body (ring 1) or
    not (0: 16-byte rows with streamed weights and a whole K loop, or two
    inputs with a split one; the next keys then describe the ring it
    declined): input chunks staged at once (g), weights resident or
    streamed, its two 8-warp groups splitting the K chunks (ksplit) or the
    columns, ring stages, K splits (1: bf16 written directly), blocks along
    the tiles, blocks an SM and shared memory a block. Then whether it runs
    the wgmma body (wgmma 1: A, B and D's dual form where ring is 0) with
    its BN, K splits, blocks and shared memory a block. Builds the kernel
    library."""
    import ctypes

    from multitalent_tpu_torch import _build
    if form not in PLAN_FORMS:
        raise ValueError(f"form {form!r}: expected one of {PLAN_FORMS}")
    ca, cb = (cin, 0) if isinstance(cin, int) else (int(cin[0]), int(cin[1]))
    bn = _block_n(cout)
    plan = (ctypes.c_int * len(A_PLAN_KEYS))()
    if _build.library().mt_conv3d_same_plan(PLAN_FORMS.index(form), n, z, y, x, ca, cb, cout,
                                            -(-cout // bn) * bn, bn, plan) != 0:
        raise ValueError(f"form {form!r} does not take sizes {(n, z, y, x, cin, cout)}")
    return dict(zip(A_PLAN_KEYS, plan))


def conv3d_same_dual(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                     bias: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B: conv3d_same over concat(a, b) along channels (order [a | b],
    as torch.cat((a, b), 1) in NCDHW), without building the concat, written
    into `out` where given.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_dual_ref."""
    if a.device.type == "cpu":
        return into(out, conv3d_same_dual_ref(a, b, unprepare_conv3d_weight(pw), bias))
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual: unsupported device {a.device}")
    _check_input(a, "a", a, KERNEL_DTYPES)
    if a.dtype == torch.float32:
        return conv3d_same_dual_fp32(a, b, pw, bias, out)
    _check_input(b, "b", a)
    if a.shape[:4] != b.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ "
                         "outside the channel axis")
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out, body = _launch("mt_conv3d_same_dual", [a, b], pw, bias, out)
    _count(conv3d_same_dual, body)
    return out


conv3d_same_dual.launches = 0
conv3d_same_dual.launches_by_body = dict.fromkeys(BODIES, 0)


def conv3d_same_wgrad_workspace(n: int, z: int, y: int, x: int, ca: int, cb: int,
                                cout: int) -> int:
    """Bytes of fp32 workspace kernel C takes at these sizes on the current
    card (cb = 0 for the single-input form): 0 where it writes dw directly
    (one split of the voxel axis), else the per-split partials it adds in a
    second launch. Builds the kernel library."""
    from multitalent_tpu_torch import _build
    nbytes = _build.library().mt_conv3d_wgrad_workspace(n, z, y, x, ca, cb, cout)
    if nbytes < 0:
        raise ValueError(f"kernel C does not take sizes {(n, z, y, x, ca, cb, cout)}")
    return nbytes


def _launch_wgrad(name: str, inputs: list[torch.Tensor], g: torch.Tensor,
                  out: torch.Tensor | None) -> torch.Tensor:
    """Run kernel C's C entry `name` into `out` (or a new dw), with the fp32
    workspace of per-split partial sums where the library reports one; with
    none the kernel writes dw directly."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = g.device
    n, z, y, xd = (int(s) for s in g.shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    cout = int(g.shape[-1])
    shape = (cout, sum(cs), 3, 3, 3)
    if out is None:
        dw = torch.empty(shape, dtype=torch.float32, device=dev)
    elif (out.dtype != torch.float32 or tuple(out.shape) != shape or out.device != dev
          or not out.is_contiguous()):
        raise ValueError(f"out: expected a contiguous float32 {shape} tensor on {dev}")
    else:
        dw = out
    if g.numel() == 0:
        return dw.zero_()
    with torch.cuda.device(dev):
        nbytes = conv3d_same_wgrad_workspace(n, z, y, xd, cs[0], sum(cs[1:]), cout)
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev) if nbytes else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = getattr(lib, name)(
            *(t.data_ptr() for t in inputs), g.data_ptr(), dw.data_ptr(),
            None if ws is None else ws.data_ptr(), nbytes, n, z, y, xd, *cs, cout, stream)
    _build.check(lib, code, name)
    return dw


def conv3d_same_wgrad(x: torch.Tensor, g: torch.Tensor,
                      out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C: dL/dw (Cout, Cin, 3, 3, 3) fp32 of the stride-1 SAME 3x3x3
    conv of x (N, Z, Y, X, Cin) whose output gradient is g (N, Z, Y, X, Cout),
    written into `out` where given.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_wgrad_ref."""
    if x.device.type == "cpu":
        return into(out, conv3d_same_wgrad_ref(x, g))
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad: unsupported device {x.device}")
    _check_input(x, "x", x, KERNEL_DTYPES)
    if x.dtype == torch.float32:
        return conv3d_same_wgrad_fp32(x, g, out)
    _check_input(g, "g", x)
    if x.shape[:4] != g.shape[:4]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ "
                         "outside the channel axis")
    dw = _launch_wgrad("mt_conv3d_wgrad", [x], g, out)
    conv3d_same_wgrad.launches += 1
    return dw


conv3d_same_wgrad.launches = 0


def conv3d_same_wgrad_dual(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C, dual form: dL/dw (Cout, Ca + Cb, 3, 3, 3) fp32 of kernel B's
    conv over concat(a, b), without building the concat, written into `out`
    where given. Its launches count on `conv3d_same_wgrad.launches`, as one
    kernel.

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_wgrad_dual_ref."""
    if a.device.type == "cpu":
        return into(out, conv3d_same_wgrad_dual_ref(a, b, g))
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad_dual: unsupported device {a.device}")
    _check_input(a, "a", a, KERNEL_DTYPES)
    if a.dtype == torch.float32:
        return conv3d_same_wgrad_dual_fp32(a, b, g, out)
    _check_input(b, "b", a)
    _check_input(g, "g", a)
    if a.shape[:4] != b.shape[:4] or a.shape[:4] != g.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)}, b {tuple(b.shape)} and g "
                         f"{tuple(g.shape)} differ outside the channel axis")
    dw = _launch_wgrad("mt_conv3d_wgrad_dual", [a, b], g, out)
    conv3d_same_wgrad.launches += 1
    return dw


# ---------------------------------------------------------------------------
# the fp32 forms of kernels A, B and C (csrc/conv3d_fp32.cu)
# ---------------------------------------------------------------------------

def _check_fp32(inputs: list[tuple[str, torch.Tensor]]) -> None:
    first = inputs[0][1]
    for name, t in inputs:
        _check_input(t, name, first, (torch.float32,))
    if any(t.shape[:4] != first.shape[:4] for _, t in inputs):
        raise ValueError("inputs " + ", ".join(f"{n} {tuple(t.shape)}" for n, t in inputs)
                         + " differ outside the channel axis")


# the fp32 ring body of kernels A and B (csrc/conv3d_fp32.cu
# conv_fp32_ring_kernel): 512-voxel boxes (z, y, x), smallest halo first; 8
# input channels a stage, 32 output channels a block; its row padding and
# the shared memory a block may take (the C side checks the same)
FP32_RING_BOXES = ((8, 8, 8), (4, 8, 16), (4, 16, 8), (2, 16, 16), (2, 8, 32))
FP32_RING_CK = 8
FP32_RING_BN = 32
FP32_RING_SMEM_MAX = 232448


def _sm_count(sms: int | None) -> int:
    if sms is not None:
        return sms
    return torch.cuda.get_device_properties(torch.cuda.current_device()).multi_processor_count


# STATS' warp partials (8 warps x 2 x 32 floats) beside D's ring; kernel E's
# stats pass's chunking (csrc/fused_norm.cu stats_chunks) and reduce_rows'
# rows a pass, which D's stats workspace follows
FP32_RING_STATS_BYTES = 4 * 8 * 2 * FP32_RING_BN
_E_MAX_CHUNKS, _E_MIN_CHUNK_BYTES, _E_WAVE_BLOCKS, _SEG_ROWS = 256, 64 << 10, 512, 256


def _fp32_stats_workspace(n: int, z: int, y: int, x: int, cout: int, box, splits: int) -> int:
    """Bytes of D's stats workspace: with one K split the boxes' rows (N,
    boxes of a sample, 2, Cout) and reduce_rows' scratch; with several
    kernel E's fp32 stats pass's, which reads the reduced output."""
    if splits > 1:
        chunks = -(-z * y * x * cout * 4 // _E_MIN_CHUNK_BYTES)
        chunks = max(1, min(chunks, max(1, min(_E_MAX_CHUNKS, -(-_E_WAVE_BLOCKS // n)))))
        return 0 if chunks == 1 else n * chunks * 2 * cout * 4
    per = prod(-(-s // b) for s, b in zip((z, y, x), box))
    segs = -(-per // _SEG_ROWS)
    if segs > _SEG_ROWS:
        raise ValueError(f"{per} boxes a sample: more stats rows than reduce_rows adds")
    return 4 * n * per * 2 * cout + (0 if per <= _SEG_ROWS else n * segs * 2 * cout * 4)


def conv3d_same_fp32_plan(n: int, z: int, y: int, x: int, ca: int, cb: int, cout: int,
                          sms: int | None = None, stats: bool = False) -> dict:
    """The ring body's plan for kernel A's (cb 0) or B's fp32 form, or with
    `stats` D's (its prologue or its dual form), at these sizes on a card of
    `sms` SMs (default: the current card's):

    - box: the 512-voxel box (z, y, x) that wastes the fewest voxels at the
      volume's edges (the first of ties: the smallest halo); boxes: N times
      a sample's;
    - vec: floats a halo copy (4, 2 or 1: 16-, 8- or 4-byte cp.async);
    - chunks: 8-channel stages of the K loop over both inputs;
    - splits, per_split: the K loop is split over blocks only when the
      (box, 32-column block) items do not fill one wave of `sms` blocks;
    - grid: (blocks along the boxes, column blocks, splits); a block walks
      boxes p, p + grid[0], ...;
    - resident: the whole K loop's weights stay in shared memory (one split,
      at least two boxes a block, room beside a 2-stage ring), else each
      stage carries its chunk's weights;
    - stages: ring depth, 3 where it fits, else 2; smem_bytes a block (with
      `stats` and one split, STATS' warp partials too);
    - workspace_bytes: the splits' fp32 partials (0: written directly), then
      with `stats` D's stats workspace (stats_bytes): one split, the boxes'
      stats rows and reduce_rows' scratch; several, kernel E's fp32 stats
      pass over the reduced output."""
    if min(n, z, y, x, ca, cout) <= 0 or cb < 0:
        raise ValueError(f"sizes {(n, z, y, x, ca, cb, cout)} are not a conv's")
    sms = _sm_count(sms)
    per = [-(-z // bz) * -(-y // by) * -(-x // bx) for bz, by, bx in FP32_RING_BOXES]
    i = per.index(min(per))
    bz, by, bx = FP32_RING_BOXES[i]
    boxes = n * per[i]
    ck, bn = FP32_RING_CK, FP32_RING_BN
    chunks = -(-ca // ck) + -(-cb // ck)
    cols = -(-cout // bn)
    items = boxes * cols
    if items >= sms:
        splits, per_split, grid_p = 1, chunks, min(boxes, max(1, sms // cols))
    else:
        per_split = -(-chunks // min(chunks, max(1, sms // items)))
        splits, grid_p = -(-chunks // per_split), boxes
    halo = (bz + 2) * (by + 2) * ((bx + 2) * ck + 4)
    wchunk = 27 * ck * bn

    extra = FP32_RING_STATS_BYTES if stats and splits == 1 else 0

    def smem(resident: bool, stages: int) -> int:
        return 4 * ((per_split * wchunk if resident else 0)
                    + stages * (halo + (0 if resident else wchunk))) + extra

    resident = (splits == 1 and -(-boxes // grid_p) >= 2
                and smem(True, 2) <= FP32_RING_SMEM_MAX)
    stages = 3 if smem(resident, 3) <= FP32_RING_SMEM_MAX else 2
    if smem(resident, stages) > FP32_RING_SMEM_MAX:
        raise ValueError(f"no ring fits at sizes {(n, z, y, x, ca, cb, cout)}")
    vec = 4 if ca % 4 == 0 and cb % 4 == 0 else (2 if ca % 2 == 0 and cb % 2 == 0 else 1)
    parts = 0 if splits == 1 else 4 * splits * n * z * y * x * cout
    st = _fp32_stats_workspace(n, z, y, x, cout, (bz, by, bx), splits) if stats else 0
    return {"box": (bz, by, bx), "boxes": boxes, "vec": vec, "chunks": chunks,
            "splits": splits, "per_split": per_split, "grid": (grid_p, cols, splits),
            "resident": resident, "stages": stages, "smem_bytes": smem(resident, stages),
            "stats_bytes": st, "workspace_bytes": parts + st}


def _launch_fp32(inputs: list[torch.Tensor], pw: PreparedWeight,
                 bias: torch.Tensor | None, out: torch.Tensor | None, mode: int = 0
                 ) -> torch.Tensor:
    """Run the ring body (mode 0; 1 copies only, 2 products only: the
    probe's forms) on checked inputs into `out` (or a new output), with the
    workspace of its K splits' partials where the plan splits."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs] + [0]
    out = _buffer(out, "out", (n, z, y, xd, pw.cout), torch.float32, dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        plan = conv3d_same_fp32_plan(n, z, y, xd, cs[0], cs[1], pw.cout)
        nbytes = plan["workspace_bytes"]
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev) if nbytes else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mt_conv3d_same_fp32(
            inputs[0].data_ptr(), inputs[1].data_ptr() if len(inputs) > 1 else None,
            pw.w.data_ptr(), None if bias is None else bias.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cs[1],
            pw.cout, pw.coutp, *plan["box"], plan["splits"], int(plan["resident"]),
            plan["stages"], plan["grid"][0], mode, stream)
    _build.check(lib, code, "mt_conv3d_same_fp32")
    return out


def conv3d_same_fp32(x: torch.Tensor, pw: PreparedWeight,
                     bias: torch.Tensor | None = None,
                     out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel A's fp32 form: the SAME 3x3x3 conv of fp32 x (N, Z, Y, X, Cin)
    with the fp32 prepared weight, fp32 FFMA (no TF32), fp32 bias, fp32 out,
    written into `out` where given. conv3d_same sends fp32 inputs here.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_ref."""
    if x.device.type == "cpu":
        return into(out, conv3d_same_ref(x, unprepare_conv3d_weight(pw), bias))
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_fp32: unsupported device {x.device}")
    _check_fp32([("x", x)])
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    out = _launch_fp32([x], pw, bias, out)
    conv3d_same_fp32.launches += 1
    return out


conv3d_same_fp32.launches = 0


def conv3d_same_dual_fp32(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                          bias: torch.Tensor | None = None,
                          out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel B's fp32 form: conv3d_same_fp32 over concat(a, b) along
    channels, without building the concat. conv3d_same_dual sends fp32
    inputs here.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_dual_ref."""
    if a.device.type == "cpu":
        return into(out, conv3d_same_dual_ref(a, b, unprepare_conv3d_weight(pw), bias))
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual_fp32: unsupported device {a.device}")
    _check_fp32([("a", a), ("b", b)])
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out = _launch_fp32([a, b], pw, bias, out)
    conv3d_same_dual_fp32.launches += 1
    return out


conv3d_same_dual_fp32.launches = 0


# the wgrad ring body of kernel C's fp32 form (csrc/conv3d_fp32.cu
# wgrad_fp32_ring_kernel): FP32_RING_BOXES' boxes, 8 input channels by 32
# output channels by 27 taps a tile, a stage the box's halo and its 512 g
# rows of 32 channels; its 384 threads hold 5 line groups of 72 register
# tiles, whose partial tiles the flush adds through one stage, 3 tiles of
# 96 x 72 floats at a time
FP32_WGRAD_GROUPS = 5
FP32_WGRAD_FLUSH_FLOATS = 3 * 96 * 72


def conv3d_same_wgrad_fp32_plan(n: int, z: int, y: int, x: int, ca: int, cb: int, cout: int,
                                sms: int | None = None) -> dict:
    """The wgrad ring body's plan for kernel C's fp32 form (cb 0) or its dual
    form at these sizes on a card of `sms` SMs (default: the current card's);
    csrc/conv3d_fp32.cu:wgrad_plan makes the same for its workspace query:

    - box: as conv3d_same_fp32_plan's (the fewest boxes, the first of ties);
      boxes: N times a sample's;
    - vec: floats a halo copy (4, 2 or 1 by Ca % 4 / 2, Cb's alike); gvec:
      floats a g copy (by Cout % 4 / 2);
    - chunks (8-channel chunks of both inputs) x cols (32-column blocks) =
      tiles, each a block's share of dw;
    - splits, per_split: the voxel axis split into runs of whole boxes only
      where the tiles leave SMs of one wave idle (none empty); units = tiles
      x splits, walked by grid = min(units, sms) persistent blocks;
    - stages: 2 (3 stages of a 512-voxel box do not fit); smem_bytes a block;
    - workspace_bytes: the splits' partial dw (0: written directly)."""
    if min(n, z, y, x, ca, cout) <= 0 or cb < 0:
        raise ValueError(f"sizes {(n, z, y, x, ca, cb, cout)} are not a conv's")
    sms = _sm_count(sms)
    per = [-(-z // bz) * -(-y // by) * -(-x // bx) for bz, by, bx in FP32_RING_BOXES]
    i = per.index(min(per))
    bz, by, bx = FP32_RING_BOXES[i]
    boxes = n * per[i]
    ck, bn = FP32_RING_CK, FP32_RING_BN
    chunks = -(-ca // ck) + -(-cb // ck)
    cols = -(-cout // bn)
    tiles = chunks * cols
    per_split = -(-boxes // (1 if tiles >= sms else min(boxes, sms // tiles)))
    splits = -(-boxes // per_split)
    units = tiles * splits
    slot = (bz + 2) * (by + 2) * ((bx + 2) * ck + 4) + 512 * bn
    stages = 2
    if 4 * stages * slot > FP32_RING_SMEM_MAX or slot < FP32_WGRAD_FLUSH_FLOATS:
        raise ValueError(f"no wgrad ring fits at sizes {(n, z, y, x, ca, cb, cout)}")
    vec = 4 if ca % 4 == 0 and cb % 4 == 0 else (2 if ca % 2 == 0 and cb % 2 == 0 else 1)
    return {"box": (bz, by, bx), "boxes": boxes, "vec": vec,
            "gvec": 4 if cout % 4 == 0 else (2 if cout % 2 == 0 else 1), "chunks": chunks,
            "cols": cols, "tiles": tiles, "splits": splits, "per_split": per_split,
            "units": units, "grid": min(units, sms), "stages": stages,
            "smem_bytes": 4 * stages * slot,
            "workspace_bytes": 0 if splits == 1 else 4 * splits * 27 * (ca + cb) * cout}


def conv3d_same_wgrad_fp32_workspace(n: int, z: int, y: int, x: int, ca: int, cb: int,
                                     cout: int) -> int:
    """Bytes of fp32 workspace kernel C's fp32 form takes at these sizes on
    the current card (0: it writes dw directly): its plan's, by the rules
    the library's mt_conv3d_wgrad_fp32_workspace answers from too."""
    return conv3d_same_wgrad_fp32_plan(n, z, y, x, ca, cb, cout)["workspace_bytes"]


def _launch_wgrad_fp32(inputs: list[torch.Tensor], g: torch.Tensor,
                       out: torch.Tensor | None, mode: int = 0) -> tuple[torch.Tensor, bool]:
    """Run the wgrad ring body (mode 0; 1 copies only, 2 products only: the
    probe's forms) into `out` (or a new dw) with its plan's workspace.
    Returns dw and whether the body was launched (not for an empty g)."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = g.device
    n, z, y, xd = (int(s) for s in g.shape[:4])
    cs = [int(t.shape[-1]) for t in inputs] + [0]
    cout = int(g.shape[-1])
    dw = _buffer(out, "out", (cout, cs[0] + cs[1], 3, 3, 3), torch.float32, dev)
    if g.numel() == 0:
        return dw.zero_(), False
    with torch.cuda.device(dev):
        plan = conv3d_same_wgrad_fp32_plan(n, z, y, xd, cs[0], cs[1], cout)
        nbytes = plan["workspace_bytes"]
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev) if nbytes else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = lib.mt_conv3d_wgrad_fp32(
            inputs[0].data_ptr(), inputs[1].data_ptr() if len(inputs) > 1 else None,
            g.data_ptr(), dw.data_ptr(), None if ws is None else ws.data_ptr(), nbytes,
            n, z, y, xd, cs[0], cs[1], cout, *plan["box"], plan["splits"], plan["grid"],
            plan["stages"], mode, stream)
    _build.check(lib, code, "mt_conv3d_wgrad_fp32")
    return dw, True


# the bodies C's and D's fp32 forms run on (launches_by_body)
FP32_BODIES = ("ring",)


def conv3d_same_wgrad_fp32(x: torch.Tensor, g: torch.Tensor,
                           out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C's fp32 form: dL/dw (Cout, Cin, 3, 3, 3) of the SAME conv of
    fp32 x by the fp32 output gradient g, fp32 FFMA, written into `out` where
    given. conv3d_same_wgrad sends fp32 inputs here.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_wgrad_ref."""
    if x.device.type == "cpu":
        return into(out, conv3d_same_wgrad_ref(x, g))
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad_fp32: unsupported device {x.device}")
    _check_fp32([("x", x), ("g", g)])
    dw, ran = _launch_wgrad_fp32([x], g, out)
    _count(conv3d_same_wgrad_fp32, "ring" if ran else None)
    return dw


conv3d_same_wgrad_fp32.launches = 0
conv3d_same_wgrad_fp32.launches_by_body = dict.fromkeys(FP32_BODIES, 0)


def conv3d_same_wgrad_dual_fp32(a: torch.Tensor, b: torch.Tensor, g: torch.Tensor,
                                out: torch.Tensor | None = None) -> torch.Tensor:
    """Kernel C's fp32 form, dual: dL/dw (Cout, Ca + Cb, 3, 3, 3) of kernel
    B's conv over concat(a, b); its launches count on
    `conv3d_same_wgrad_fp32.launches`, as one kernel.

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_wgrad_dual_ref."""
    if a.device.type == "cpu":
        return into(out, conv3d_same_wgrad_dual_ref(a, b, g))
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_wgrad_dual_fp32: unsupported device {a.device}")
    _check_fp32([("a", a), ("b", b), ("g", g)])
    dw, ran = _launch_wgrad_fp32([a, b], g, out)
    _count(conv3d_same_wgrad_fp32, "ring" if ran else None)
    return dw


def _launch_stats(name: str, inputs: list[torch.Tensor], pw: PreparedWeight,
                  bias: torch.Tensor | None, affine: tuple = (),
                  out: torch.Tensor | None = None, stats: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor, str | None]:
    """Run kernel D's C entry `name` into `out` and `stats` (or new ones):
    allocates the workspace (split-K partials, per-block stats partials) the
    library reports. `affine` is (scale, shift, slope) for the prologue.
    Returns out, stats and the body the launch ran (None: an empty output,
    nothing launched)."""
    import ctypes

    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs]
    out = _buffer(out, "out", (n, z, y, xd, pw.cout), torch.bfloat16, dev)
    stats = _buffer(stats, "stats", (n, 2, pw.cout), torch.float32, dev)
    if out.numel() == 0:
        return out, stats.zero_(), None
    body = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        nbytes = lib.mt_conv3d_stats_launch_plan(n, z, y, xd, cs[0], sum(cs[1:]), pw.cout,
                                                 pw.coutp, pw.bn, ctypes.byref(body))
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
    return out, stats, BODIES[body.value]


def conv3d_same_affine(x: torch.Tensor, pw: PreparedWeight,
                       bias: torch.Tensor | None = None,
                       scale: torch.Tensor | None = None,
                       shift: torch.Tensor | None = None,
                       negative_slope: float = 1e-2,
                       out: torch.Tensor | None = None,
                       stats: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D: (out, stats) = (conv(lrelu(bf16(x * scale + shift))) + bias,
    its per-sample channel sum and sum of squares (N, 2, Cout) fp32) for the
    previous conv's raw output x (N, Z, Y, X, Cin) and the next norm's scale,
    shift (N, Cin) fp32; without scale and shift, conv(x) + bias and its
    stats. out is bf16, the stats are taken over its rounded values. Both are
    written into the caller's `out` and `stats` where given. fp32 x goes to
    the fp32 form (conv3d_same_affine_fp32).

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_affine_ref."""
    if x.device.type == "cpu":
        ref, ref_stats = conv3d_same_affine_ref(x, unprepare_conv3d_weight(pw), bias, scale,
                                                shift, negative_slope)
        return into(out, ref), into(stats, ref_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_affine: unsupported device {x.device}")
    _check_input(x, "x", x, KERNEL_DTYPES)
    if x.dtype == torch.float32:
        return conv3d_same_affine_fp32(x, pw, bias, scale, shift, negative_slope, out, stats)
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    _check_affine(x, scale, shift)
    out, stats, body = _launch_stats("mt_conv3d_same_affine", [x], pw, bias,
                                     (scale, shift, negative_slope), out, stats)
    _count(conv3d_same_affine, body)
    return out, stats


conv3d_same_affine.launches = 0
conv3d_same_affine.launches_by_body = dict.fromkeys(BODIES, 0)


def conv3d_same_dual_stats(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                           bias: torch.Tensor | None = None,
                           out: torch.Tensor | None = None,
                           stats: torch.Tensor | None = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D, dual form: kernel B's conv over concat(a, b) and the stats of
    its bf16 output, (out, stats (N, 2, Cout) fp32), written into the
    caller's `out` and `stats` where given. Its launches count on
    `conv3d_same_affine.launches` (and its `launches_by_body`), as one
    kernel. At 16-byte rows with streamed weights it runs kernel B's wgmma
    body with B's plan, so `out` is conv3d_same_dual's bit for bit. fp32
    inputs go to the fp32 form (conv3d_same_dual_stats_fp32).

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_dual_stats_ref."""
    if a.device.type == "cpu":
        ref, ref_stats = conv3d_same_dual_stats_ref(a, b, unprepare_conv3d_weight(pw), bias)
        return into(out, ref), into(stats, ref_stats)
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual_stats: unsupported device {a.device}")
    _check_input(a, "a", a, KERNEL_DTYPES)
    if a.dtype == torch.float32:
        return conv3d_same_dual_stats_fp32(a, b, pw, bias, out, stats)
    _check_input(b, "b", a)
    if a.shape[:4] != b.shape[:4]:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ "
                         "outside the channel axis")
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out, stats, body = _launch_stats("mt_conv3d_same_dual_stats", [a, b], pw, bias, (), out,
                                     stats)
    _count(conv3d_same_affine, body)
    return out, stats


def _check_affine(x: torch.Tensor, scale: torch.Tensor | None,
                  shift: torch.Tensor | None) -> None:
    if (scale is None) != (shift is None):
        raise ValueError("scale and shift must be given together")
    n, cin = int(x.shape[0]), int(x.shape[-1])
    for name, v in (("scale", scale), ("shift", shift)):
        if v is not None and (v.dtype != torch.float32 or tuple(v.shape) != (n, cin)
                              or v.device != x.device or not v.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 ({n}, {cin}) tensor "
                             f"on {x.device}")


# ---------------------------------------------------------------------------
# kernel D's fp32 form (csrc/conv3d_fp32.cu)
# ---------------------------------------------------------------------------

def _launch_stats_fp32(inputs: list[torch.Tensor], pw: PreparedWeight,
                       bias: torch.Tensor | None, affine: tuple, out: torch.Tensor | None,
                       stats: torch.Tensor | None, mode: int = 0
                       ) -> tuple[torch.Tensor, torch.Tensor, bool]:
    """Run kernel D's fp32 form on the ring body (mode 0; 1 copies and
    prologue only, 2 products only: the probe's forms) into `out` and
    `stats` (or new ones), with its plan's workspace (K-split partials, the
    stats rows or kernel E's stats pass's). `affine` is (scale, shift,
    slope), or () for the dual form. Returns out, stats and whether the body
    was launched (not for an empty output)."""
    from multitalent_tpu_torch import _build
    lib = _build.library()
    dev = inputs[0].device
    n, z, y, xd = (int(s) for s in inputs[0].shape[:4])
    cs = [int(t.shape[-1]) for t in inputs] + [0]
    out = _buffer(out, "out", (n, z, y, xd, pw.cout), torch.float32, dev)
    stats = _buffer(stats, "stats", (n, 2, pw.cout), torch.float32, dev)
    if out.numel() == 0:
        return out, stats.zero_(), False
    scale, shift, slope = affine if affine else (None, None, 0.0)
    with torch.cuda.device(dev):
        plan = conv3d_same_fp32_plan(n, z, y, xd, cs[0], cs[1], pw.cout, stats=True)
        nbytes = plan["workspace_bytes"]
        ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)  # never empty
        code = lib.mt_conv3d_same_affine_fp32(
            inputs[0].data_ptr(), inputs[1].data_ptr() if len(inputs) > 1 else None,
            pw.w.data_ptr(), None if bias is None else bias.data_ptr(),
            None if scale is None else scale.data_ptr(),
            None if shift is None else shift.data_ptr(), float(slope), out.data_ptr(),
            stats.data_ptr(), ws.data_ptr(), nbytes, n, z, y, xd, cs[0], cs[1], pw.cout,
            pw.coutp, *plan["box"], plan["splits"], int(plan["resident"]), plan["stages"],
            plan["grid"][0], mode, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, code, "mt_conv3d_same_affine_fp32")
    return out, stats, True


def conv3d_same_affine_fp32(x: torch.Tensor, pw: PreparedWeight,
                            bias: torch.Tensor | None = None,
                            scale: torch.Tensor | None = None,
                            shift: torch.Tensor | None = None,
                            negative_slope: float = 1e-2,
                            out: torch.Tensor | None = None,
                            stats: torch.Tensor | None = None
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's fp32 form: (out, stats) = (conv(lrelu(x * scale + shift))
    + bias, its per-sample channel sum and sum of squares (N, 2, Cout)) of
    fp32 x (N, Z, Y, X, Cin) with the fp32 prepared weight, fp32 FFMA (no
    TF32), the SAME halo at 0; without scale and shift, conv(x) + bias and
    its stats. conv3d_same_affine sends fp32 inputs here.

    CUDA tensors launch the kernel; CPU tensors take conv3d_same_affine_ref."""
    if x.device.type == "cpu":
        ref, ref_stats = conv3d_same_affine_ref(x, unprepare_conv3d_weight(pw), bias, scale,
                                                shift, negative_slope)
        return into(out, ref), into(stats, ref_stats)
    if x.device.type != "cuda":
        raise ValueError(f"conv3d_same_affine_fp32: unsupported device {x.device}")
    _check_fp32([("x", x)])
    _check_weight(pw, (int(x.shape[-1]),), x, bias)
    _check_affine(x, scale, shift)
    out, stats, ran = _launch_stats_fp32([x], pw, bias, (scale, shift, negative_slope)
                                         if scale is not None else (), out, stats)
    _count(conv3d_same_affine_fp32, "ring" if ran else None)
    return out, stats


conv3d_same_affine_fp32.launches = 0
conv3d_same_affine_fp32.launches_by_body = dict.fromkeys(FP32_BODIES, 0)


def conv3d_same_dual_stats_fp32(a: torch.Tensor, b: torch.Tensor, pw: PreparedWeight,
                                bias: torch.Tensor | None = None,
                                out: torch.Tensor | None = None,
                                stats: torch.Tensor | None = None
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel D's fp32 form, dual: kernel B's fp32 conv over concat(a, b)
    and the stats of its output. Its launches count on
    `conv3d_same_affine_fp32.launches`, as one kernel.

    CUDA tensors launch the kernel; CPU tensors take
    conv3d_same_dual_stats_ref."""
    if a.device.type == "cpu":
        ref, ref_stats = conv3d_same_dual_stats_ref(a, b, unprepare_conv3d_weight(pw), bias)
        return into(out, ref), into(stats, ref_stats)
    if a.device.type != "cuda":
        raise ValueError(f"conv3d_same_dual_stats_fp32: unsupported device {a.device}")
    _check_fp32([("a", a), ("b", b)])
    _check_weight(pw, (int(a.shape[-1]), int(b.shape[-1])), a, bias)
    out, stats, ran = _launch_stats_fp32([a, b], pw, bias, (), out, stats)
    _count(conv3d_same_affine_fp32, "ring" if ran else None)
    return out, stats


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

def conv3d_same_dx(g: torch.Tensor, weight: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """dL/dx (N, Z, Y, X, Cin) of the SAME conv with `weight` (Cout, Cin, 3,
    3, 3), given its output gradient g: kernel A on the spatially flipped,
    transposed weight, prepared in g's dtype (ops/pallas_conv.py:651-659),
    written into `out` where given."""
    pw = prepare_conv3d_weight(weight.detach().flip(2, 3, 4).transpose(0, 1),
                               dtype=g.dtype)
    return conv3d_same(g, pw, out=out)


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
