"""Stride-1 SAME 3x3x3 convolutions on hand-written Hopper kernels.

Counterparts of the Pallas kernels of multitalent_tpu:

- `conv3d_same` (kernel A) replaces `ops/pallas_conv.py:_conv_kernel` and,
  because the port runs unpacked at the true channel count, the function of
  `ops/pallas_merged_conv.py:_merged_kernel`
  (`space_to_depth(conv3d_same(depth_to_space(x), w))`).
- `conv3d_same_dual` (kernel B) replaces
  `ops/pallas_merged_conv.py:_merged2_kernel`: the conv over
  `concat(a, b)` along channels, without building the concat.

Both kernels live in `csrc/conv3d_same.cu`. Tensors are channels-last
(N, Z, Y, X, C), the layout of the JAX package and the physical layout of a
`torch.channels_last_3d` NCDHW tensor. Weights are prepared once per model
load with `prepare_conv3d_weight`.

Each wrapper launches its kernel for CUDA tensors (or raises) and uses the
plain PyTorch version (`conv3d_same_ref`, `conv3d_same_dual_ref`) only for
tensors that lie on the CPU. Each keeps a count of kernel launches in its
`launches` attribute.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

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
        taps = F.pad(taps.float(), (0, coutp - cout, 0, kpad - c))
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

def conv3d_same_ref(x: torch.Tensor, weight: torch.Tensor,
                    bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel A: F.conv3d in fp32 on channels-last input
    (N, Z, Y, X, Cin) with a torch weight (Cout, Cin, 3, 3, 3); the result is
    cast to x's dtype."""
    out = F.conv3d(x.permute(0, 4, 1, 2, 3).float(), weight.float(),
                   None if bias is None else bias.float(), padding=1)
    return out.permute(0, 2, 3, 4, 1).to(x.dtype)


def conv3d_same_dual_ref(a: torch.Tensor, b: torch.Tensor, weight: torch.Tensor,
                         bias: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of kernel B: torch.cat along channels, then F.conv3d."""
    return conv3d_same_ref(torch.cat((a, b.to(a.dtype)), dim=-1), weight, bias)


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
