"""MedNeXt: the ConvNeXt-style 3D segmentation backbone, as an nn.Module.

Counterpart of multitalent_tpu/models/mednext.py (the reference's
MedNextV1 as MultiTalent_meets_mednext.py configures it: n_channels 32,
kernel 3, exp_r = block_counts = (3, 4, 8, 8, 8, 8, 8, 4, 3)). Module names
are the JAX module's, so each parameter has its counterpart in the flax tree
(io/torch_convert.mednext_key_table):

  stem                          1x1x1 conv to n_channels
  enc{l}.block{i}, l < 4        MedNeXtBlock (plain) of stage l
  down{l}                       MedNeXtBlock (down): stride-2 depthwise conv,
                                1x1x1 stride-2 res_conv
  bottleneck.block{i}
  up{l}                         MedNeXtBlock (up): stride-2 transposed
                                depthwise conv, 1x1x1 transposed res_conv
  dec{l}.block{i}
  out{l}, l < 5                 1x1x1 deep-supervision heads; out4 reads the
                                bottleneck, out0 the full resolution

A block is depthwise k^3 conv -> per-channel GroupNorm (an InstanceNorm:
blocks.instance_norm, fp32 statistics) -> 1x1x1 expansion by exp_r -> GELU
-> 1x1x1 compression, plus the residual (the input, or its resampling in the
down and up blocks). The decoder adds each skip to the up block's output.
The forward returns [out0, out1, out2, out3, out4] with deep supervision
(highest resolution first), else out0, each in fp32.

As in the JAX module: the down blocks expand by exp_r[l] of their encoder
stage (the upstream source may use exp_r[l + 1]: ROADMAP §3); GELU is the
tanh approximation (flax's nn.gelu; the upstream nn.GELU is exact); the
transposed depthwise conv is followed by a zero pad of one voxel before each
axis, so the output is exactly twice the input. Flax runs that conv as a
correlation over the input dilated by 2 with the kernel unflipped; a
ConvTranspose3d(stride=2, padding=k//2) correlates with its weight flipped,
so the bridges flip it (io/from_jax.py). Every conv runs in `dtype` (input,
weight and bias cast to it, flax's dtype=bf16 with fp32 params); the heads'
outputs are cast to fp32.

Each stage block is recomputed in the backward
(torch.utils.checkpoint, use_reentrant=False) while the module trains, as
the JAX module remats each one. No conv routes to a hand-written kernel:
the JAX package computes all of them in XLA, outside any Pallas kernel, and
here they run on cuDNN (activations in channels_last_3d memory, which makes
PyTorch pick cuDNN for the depthwise convs) or ATen.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from multitalent_tpu_torch.models.blocks import CL, instance_norm

# flax's truncated normal (cut at 2 std) divides by this to keep the variance
TRUNC_STD = 0.87962566103423978
DEFAULT_EXP_R = (3, 4, 8, 8, 8, 8, 8, 4, 3)
DEFAULT_BLOCK_COUNTS = (3, 4, 8, 8, 8, 8, 8, 4, 3)


def _conv(x: torch.Tensor, layer: nn.Conv3d, dtype: torch.dtype) -> torch.Tensor:
    return F.conv3d(x, layer.weight.to(dtype), layer.bias.to(dtype), layer.stride,
                    layer.padding, groups=layer.groups)


def _conv_transpose_padded(x: torch.Tensor, layer: nn.ConvTranspose3d,
                           dtype: torch.dtype) -> torch.Tensor:
    """The stride-2 transposed conv (2n - 1 outputs an axis), then one zero
    voxel before each axis (2n), as the JAX module pads it."""
    y = F.conv_transpose3d(x, layer.weight.to(dtype), layer.bias.to(dtype), layer.stride,
                           layer.padding, groups=layer.groups)
    return F.pad(y, (1, 0, 1, 0, 1, 0)).contiguous(memory_format=CL)


class MedNeXtBlock(nn.Module):
    """One MedNeXt block of `mode` "plain", "down" or "up" from `in_channels`
    to `features` (plain blocks keep the width)."""

    def __init__(self, in_channels: int, features: int, exp_r: int = 4,
                 kernel_size: int = 3, do_res: bool = True, mode: str = "plain"):
        super().__init__()
        if mode not in ("plain", "down", "up"):
            raise ValueError(f"mode must be plain, down or up, got {mode!r}")
        c, k = in_channels, kernel_size
        self.mode, self.do_res = mode, do_res
        if mode == "up":
            self.dwconv = nn.ConvTranspose3d(c, c, k, stride=2, padding=k // 2, groups=c)
        else:
            self.dwconv = nn.Conv3d(c, c, k, stride=2 if mode == "down" else 1,
                                    padding=k // 2, groups=c)
        self.norm = nn.InstanceNorm3d(c, eps=1e-5, affine=True)
        self.expand = nn.Conv3d(c, exp_r * c, 1)
        self.compress = nn.Conv3d(exp_r * c, features, 1)
        if do_res and mode == "down":
            self.res_conv = nn.Conv3d(c, features, 1, stride=2)
        elif do_res and mode == "up":
            self.res_conv = nn.ConvTranspose3d(c, features, 1, stride=2)
        else:
            self.res_conv = None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (N, C, Z, Y, X) in `dtype`, channels_last_3d."""
        if self.mode == "up":
            y = _conv_transpose_padded(x, self.dwconv, dtype)
        else:
            y = _conv(x, self.dwconv, dtype)
        y = instance_norm(y, self.norm.weight, self.norm.bias, self.norm.eps)
        y = F.gelu(_conv(y, self.expand, dtype), approximate="tanh")
        y = _conv(y, self.compress, dtype)
        if not self.do_res:
            return y
        if self.mode == "down":
            res = _conv(x, self.res_conv, dtype)
        elif self.mode == "up":
            res = _conv_transpose_padded(x, self.res_conv, dtype)
        else:
            res = x
        return y + res.to(y.dtype)


class MedNeXtStage(nn.Module):
    """`num_blocks` plain blocks (block0, block1, ...), each recomputed in the
    backward while the module trains with `remat`."""

    def __init__(self, features: int, num_blocks: int, exp_r: int, kernel_size: int,
                 do_res: bool, remat: bool):
        super().__init__()
        self.remat = remat
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", MedNeXtBlock(features, features, exp_r, kernel_size,
                                                      do_res, "plain"))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        remat = self.remat and self.training and torch.is_grad_enabled()
        for i in range(self.num_blocks):
            block = getattr(self, f"block{i}")
            x = checkpoint(block, x, dtype, use_reentrant=False) if remat else block(x, dtype)
        return x


class MedNeXt(nn.Module):
    """Five-level MedNeXt with additive skips and five deep-supervision heads.
    Every extent of the input must be divisible by 16."""

    def __init__(self, in_channels: int = 1, n_channels: int = 32, n_classes: int = 2,
                 exp_r=DEFAULT_EXP_R, block_counts=DEFAULT_BLOCK_COUNTS,
                 kernel_size: int = 3, do_res: bool = True, do_res_up_down: bool = True,
                 remat: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        exp, bc = tuple(int(e) for e in exp_r), tuple(int(b) for b in block_counts)
        if len(exp) != 9 or len(bc) != 9:
            raise ValueError("MedNeXt takes nine exp_r and nine block_counts")
        self.in_channels, self.n_channels, self.num_classes = in_channels, n_channels, n_classes
        self.exp_r, self.block_counts, self.kernel_size = exp, bc, kernel_size
        self.dtype = dtype
        n, k = n_channels, kernel_size
        self.stem = nn.Conv3d(in_channels, n, 1)
        for lvl in range(4):
            c = n * 2 ** lvl
            self.add_module(f"enc{lvl}", MedNeXtStage(c, bc[lvl], exp[lvl], k, do_res, remat))
            self.add_module(f"down{lvl}", MedNeXtBlock(c, 2 * c, exp[lvl], k, do_res_up_down,
                                                       "down"))
        self.bottleneck = MedNeXtStage(n * 16, bc[4], exp[4], k, do_res, remat)
        for i, lvl in enumerate(range(3, -1, -1)):
            c = n * 2 ** lvl
            self.add_module(f"up{lvl}", MedNeXtBlock(2 * c, c, exp[5 + i], k, do_res_up_down,
                                                     "up"))
            self.add_module(f"dec{lvl}", MedNeXtStage(c, bc[5 + i], exp[5 + i], k, do_res,
                                                      remat))
        for lvl in range(5):
            self.add_module(f"out{lvl}", nn.Conv3d(n * 2 ** lvl, n_classes, 1))

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers: lecun normal (truncated at 2 std,
        variance 1 / fan-in) for every conv kernel, flax's fan-in of a
        depthwise kernel being k^3 and of a transposed one its input width,
        zero biases, norms at (1, 0)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, (nn.Conv3d, nn.ConvTranspose3d)):
                    fan_in = m.in_channels // m.groups * math.prod(m.kernel_size)
                    std = math.sqrt(1.0 / fan_in) / TRUNC_STD
                    nn.init.trunc_normal_(m.weight, 0.0, std, -2 * std, 2 * std,
                                          generator=generator)
                    m.bias.zero_()
                elif isinstance(m, nn.InstanceNorm3d):
                    m.weight.fill_(1.0)
                    m.bias.zero_()

    def deep_supervision_heads(self) -> nn.ModuleList:
        """The five heads, lowest resolution first (the forward lists its
        outputs highest resolution first)."""
        return nn.ModuleList([getattr(self, f"out{lvl}") for lvl in range(4, -1, -1)])

    def forward(self, x: torch.Tensor, *,
                deep_supervision: bool = False) -> torch.Tensor | list[torch.Tensor]:
        """x (N, C_in, Z, Y, X) -> logits (N, n_classes, Z, Y, X) fp32, or the
        five deep-supervision outputs."""
        dtype = self.dtype
        x = _conv(x.to(dtype).contiguous(memory_format=CL), self.stem, dtype)
        skips = []
        for lvl in range(4):
            x = getattr(self, f"enc{lvl}")(x, dtype)
            skips.append(x)
            x = getattr(self, f"down{lvl}")(x, dtype)
        x = self.bottleneck(x, dtype)

        def head(t: torch.Tensor, lvl: int) -> torch.Tensor:
            return _conv(t, getattr(self, f"out{lvl}"), dtype).float()

        outs = [head(x, 4)] if deep_supervision else []
        for lvl in range(3, -1, -1):
            x = getattr(self, f"up{lvl}")(x, dtype)
            x = x + skips[lvl].to(x.dtype)
            x = getattr(self, f"dec{lvl}")(x, dtype)
            if lvl > 0 and deep_supervision:
                outs.append(head(x, lvl))
        final = head(x, 0)
        return [final] + outs[::-1] if deep_supervision else final
