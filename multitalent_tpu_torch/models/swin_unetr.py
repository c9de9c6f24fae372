"""SwinUNETR: a 3D shifted-window transformer encoder with a UNETR-style conv
decoder, as an nn.Module.

Counterpart of multitalent_tpu/models/swin_unetr.py (the MONAI SwinUNETR of
the reference's MultiTalent_meets_swinunetr.py: feature_size 48, four swin
stages of depth 2 with heads (3, 6, 12, 24), window 7, patch size 2, no deep
supervision). Module names are the JAX module's, so each parameter has its
counterpart in the flax tree (io/torch_convert.swin_unetr_key_table):

  encoder0..4, encoder10        UnetrBasicBlock: conv1, norm1, conv2, norm2
                                [, res (1x1x1, no bias), res_norm]
  patch_embed                   2x2x2 stride-2 conv with bias
  stage{s}_block{b}             SwinBlock: norm1, attn.qkv, attn.rel_pos_bias,
                                attn.proj, norm2, mlp1, mlp2
  merge0..2, merge_final        PatchMerging: norm, reduction (flax's unnamed
                                LayerNorm_0 and Dense_0, no bias)
  decoder5..1                   UnetrUpBlock: up (transposed, no bias), block
  out                           1x1x1 head with bias

Routes, as in models/blocks.py: every stride-1 3x3x3 conv with Cin >= 8 runs
on kernel A (encoder0.conv2, both convs of encoder1-4 and encoder10, each
decoder's conv2: 16 a forward), each UnetrUpBlock's conv1 on kernel B over
(up, skip) without the concat (5 a forward); the backward runs dx on A and dw
on C. encoder0.conv1 (Cin = 1), patch_embed, the transposed ups, the 1x1x1
res convs and the head stay cuDNN, as the JAX package leaves them to XLA. The
up block's res conv reads the concat that kernel B avoids, so it is built for
it (one cuDNN conv on torch.cat((up, skip)), the JAX rounding exactly). The
norms are blocks.instance_norm, plain always: the JAX SwinUNETR's never take
the MTTPU_PALLAS_NORM route, and the fused switches hand only a GenericUNet
to the fused route.

The transformer half keeps its tokens as contiguous (B, D, H, W, C) tensors,
the memory of a channels_last_3d NCDHW tensor, so encoder1-4 and encoder10
read them through blocks.from_ndhwc without a copy.

The dtype flow is the JAX module's (the model dtype bf16, or fp32): flax's
LayerNorm (eps 1e-6) promotes a bf16 input with its fp32 params and returns
fp32; every Dense casts its input and params to the model dtype (kernels
(in, out), stored here as nn.Linear's (out, in)); attention takes q.k^T
accumulated in fp32, / sqrt(head_dim), + the relative-position bias, + the
shift mask (-100 off-window), softmax in fp32, cast to the model dtype, then
the product with v; GELU is the tanh approximation (flax's nn.gelu). A block
pads its tokens with zeros after norm1, so the padded tokens take part in
attention as keys, as in JAX.

The window of a stage is min(7, its extent), fixed when the network is built
for `patch_size`: the relative-position tables have (2 ws - 1)^3 rows, as the
flax params initialised on a patch do. Input extents must be the patch's.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from multitalent_tpu_torch.models.blocks import (CL, KernelConv3d, from_ndhwc, instance_norm,
                                                 kernel_launches_per_forward,
                                                 kernel_launches_per_step, to_ndhwc)

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon
MASK_OFF_WINDOW = -100.0
NEGATIVE_SLOPE = 1e-2
HE_GAIN = 2.0 / (1.0 + NEGATIVE_SLOPE ** 2)  # blocks.he_init of the JAX package
# flax's truncated normal (cut at 2 std) divides by this to keep the variance
TRUNC_STD = 0.87962566103423978


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, D, H, W, C) -> (B * nW, ws^3, C), windows in (b, d, h, w) order."""
    b, d, h, w, c = x.shape
    x = x.view(b, d // ws, ws, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, ws ** 3, c)


def window_unpartition(windows: torch.Tensor, ws: int, dims) -> torch.Tensor:
    """Inverse of window_partition: (B * nW, ws^3, C) -> (B, D, H, W, C)."""
    b, d, h, w = dims
    x = windows.view(b, d // ws, h // ws, w // ws, ws, ws, ws, -1)
    return x.permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(b, d, h, w, -1)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws^3 * ws^3,) rows of the (2 ws - 1)^3 bias table, query-major
    (multitalent_tpu/models/swin_unetr.py:67-73)."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), np.arange(ws),
                                  indexing="ij")).reshape(3, -1)
    rel = coords[:, :, None] - coords[:, None, :] + (ws - 1)
    return (rel[0] * (2 * ws - 1) ** 2 + rel[1] * (2 * ws - 1) + rel[2]).reshape(-1)


def shift_attn_mask(dims, ws: int, shift: int, device: str | torch.device = "cpu",
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(nW, ws^3, ws^3) on `device`: -100 between tokens of different regions
    of the rolled volume, 0 within one (swin_unetr.py:88-101)."""
    d, h, w = dims
    img = np.zeros((d, h, w), np.int8)
    cnt = 0
    slices = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for sd in slices:
        for sh in slices:
            for sw in slices:
                img[sd, sh, sw] = cnt
                cnt += 1
    windows = torch.from_numpy(img.reshape(d // ws, ws, h // ws, ws, w // ws, ws).transpose(
        0, 2, 4, 1, 3, 5).reshape(-1, ws ** 3)).to(device)
    off = windows[:, None, :] != windows[:, :, None]
    return torch.where(off, torch.tensor(MASK_OFF_WINDOW, dtype=dtype, device=device),
                       torch.tensor(0.0, dtype=dtype, device=device))


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """A flax Dense in `dtype`: input, kernel and bias cast to it."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def _layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """flax nn.LayerNorm with fp32 params: computed and returned in fp32."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight, norm.bias, norm.eps)


class WindowAttention(nn.Module):
    """Multi-head self-attention within windows of ws^3 tokens, with a
    learned relative-position bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, 3 * dim)
        self.rel_pos_bias = nn.Parameter(torch.zeros((2 * window_size - 1) ** 3, num_heads))
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("rel_index",
                             torch.from_numpy(relative_position_index(window_size)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None,
                dtype: torch.dtype) -> torch.Tensor:
        """x (nW * B, N, C) -> (nW * B, N, C) in `dtype`; mask (nW, N, N)."""
        nwb, n, c = x.shape
        h = self.num_heads
        q, k, v = _linear(x, self.qkv, dtype).view(nwb, n, 3, h, c // h).permute(
            2, 0, 3, 1, 4).unbind(0)
        attn = torch.matmul(q.float(), k.float().transpose(-2, -1))
        attn.div_(math.sqrt(c // h))
        bias = self.rel_pos_bias[self.rel_index].view(n, n, h).permute(2, 0, 1)
        attn = attn + bias
        if mask is not None:
            nw = mask.shape[0]
            attn = attn.view(nwb // nw, nw, h, n, n).add_(mask[None, :, None]).view(nwb, h, n, n)
        attn = attn.softmax(-1).to(dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(nwb, n, c)
        return _linear(out, self.proj, dtype)


class SwinBlock(nn.Module):
    """norm1 -> (shifted) window attention -> residual; norm2 -> MLP (4x,
    tanh GELU) -> residual. `window_size` and `shift` are the stage's
    (min(7, extent); half the window on odd blocks, 0 on even ones)."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp2 = nn.Linear(int(dim * mlp_ratio), dim)
        # the shift mask of each (padded extent, device), built once: -100 and
        # 0 are exact in bf16, which halves its memory (323 MB at stage 0 of
        # a 96x192x192 patch)
        self._masks: dict = {}

    def shift_mask(self, dims, device: torch.device) -> torch.Tensor:
        key = (tuple(dims), device)
        if key not in self._masks:
            self._masks[key] = shift_attn_mask(dims, self.window_size, self.shift, device,
                                               torch.bfloat16)
        return self._masks[key]

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, D, H, W, C) in `dtype` -> the same shape and dtype."""
        b, d, h, w, c = x.shape
        ws, shift = self.window_size, self.shift
        y = _layer_norm(x, self.norm1).to(dtype)  # the qkv Dense casts it so
        pad = [(ws - s % ws) % ws for s in (d, h, w)]
        if any(pad):
            y = F.pad(y, (0, 0, 0, pad[2], 0, pad[1], 0, pad[0]))
        dims = y.shape[1:4]
        mask = None
        if shift:
            y = torch.roll(y, (-shift,) * 3, (1, 2, 3))
            mask = self.shift_mask(dims, y.device)
        y = window_unpartition(self.attn(window_partition(y, ws), mask, dtype), ws,
                               (b, *dims))
        if shift:
            y = torch.roll(y, (shift,) * 3, (1, 2, 3))
        x = x + y[:, :d, :h, :w].to(x.dtype)
        z = F.gelu(_linear(_layer_norm(x, self.norm2), self.mlp1, dtype), approximate="tanh")
        return x + _linear(z, self.mlp2, dtype).to(x.dtype)


class PatchMerging(nn.Module):
    """2x downsampling: the 8 neighbours concatenated in (dz, dy, dx, c)
    order -> LayerNorm -> Dense(2 dim) without bias."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(8 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(8 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b, d, h, w, c = x.shape
        if d % 2 or h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2, 0, d % 2))
        d2, h2, w2 = x.shape[1:4]
        x = x.view(b, d2 // 2, 2, h2 // 2, 2, w2 // 2, 2, c).permute(
            0, 1, 3, 5, 2, 4, 6, 7).reshape(b, d2 // 2, h2 // 2, w2 // 2, 8 * c)
        return _linear(_layer_norm(x, self.norm), self.reduction, dtype)


class UnetrBasicBlock(nn.Module):
    """conv-IN-lrelu-conv-IN plus the input (projected by a 1x1x1 conv and a
    norm when the widths differ), then LeakyReLU. `in_splits` = (Ca, Cb)
    makes conv1 read concat(a, b) from two tensors (kernel B)."""

    def __init__(self, in_channels: int, features: int,
                 in_splits: tuple[int, int] | None = None):
        super().__init__()
        self.conv1 = KernelConv3d(in_channels, features, in_splits=in_splits)
        self.norm1 = nn.InstanceNorm3d(features, eps=1e-5, affine=True)
        self.conv2 = KernelConv3d(features, features)
        self.norm2 = nn.InstanceNorm3d(features, eps=1e-5, affine=True)
        if in_channels != features:
            self.res = KernelConv3d(in_channels, features, (1, 1, 1), bias=False)
            self.res_norm = nn.InstanceNorm3d(features, eps=1e-5, affine=True)
        else:
            self.res = self.res_norm = None

    def forward(self, x: torch.Tensor, skip: torch.Tensor | None = None, *,
                use_kernels: bool = True) -> torch.Tensor:
        """x (N, C, Z, Y, X) channels_last_3d; for a two-input block `skip`
        is the second input."""
        def norm(t, m):
            return instance_norm(t, m.weight, m.bias, m.eps)

        y = F.leaky_relu(norm(self.conv1(x, skip, use_kernels=use_kernels), self.norm1),
                         NEGATIVE_SLOPE, inplace=True)
        y = norm(self.conv2(y, use_kernels=use_kernels), self.norm2)
        if self.res is not None:
            r = x if skip is None else torch.cat((x, skip), 1)
            x = norm(self.res(r, use_kernels=use_kernels), self.res_norm)
        return F.leaky_relu(y + x, NEGATIVE_SLOPE, inplace=True)


class UnetrUpBlock(nn.Module):
    """2x2x2 transposed conv, then a basic block over (up, skip)."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.up = nn.ConvTranspose3d(in_channels, features, 2, 2, bias=False)
        self.block = UnetrBasicBlock(2 * features, features, in_splits=(features, features))

    def forward(self, x: torch.Tensor, skip: torch.Tensor, *,
                use_kernels: bool = True) -> torch.Tensor:
        x = F.conv_transpose3d(x, self.up.weight.to(x.dtype), None, 2)
        return self.block(x.contiguous(memory_format=CL), skip.to(x.dtype),
                          use_kernels=use_kernels)


class SwinUNETR(nn.Module):
    """forward(x (N, C_in, *patch_size)) -> full-resolution logits fp32, or
    `[logits]` with deep_supervision (the one output is the only level).
    Every extent of `patch_size` must be divisible by 32."""

    input_shape_must_be_divisible_by = 32

    def __init__(self, in_channels: int, out_channels: int, patch_size,
                 feature_size: int = 48, depths=(2, 2, 2, 2), num_heads=(3, 6, 12, 24),
                 window_size: int = 7, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        patch = tuple(int(p) for p in patch_size)
        if len(patch) != 3 or any(p % self.input_shape_must_be_divisible_by for p in patch):
            raise ValueError(f"SwinUNETR needs a 3D patch divisible by "
                             f"{self.input_shape_must_be_divisible_by}, got {patch}")
        if len(depths) != 4 or len(num_heads) != 4:
            raise ValueError("SwinUNETR has four swin stages")
        self.patch_size = patch
        self.in_channels, self.num_classes = in_channels, out_channels
        self.feature_size, self.window_size = feature_size, window_size
        self.depths, self.num_heads = tuple(depths), tuple(num_heads)
        self.dtype = dtype
        fs = feature_size
        self.encoder0 = UnetrBasicBlock(in_channels, fs)
        self.patch_embed = nn.Conv3d(in_channels, fs, 2, 2)
        dim, extent = fs, [p // 2 for p in patch]
        self.stages = []
        for s, (depth, heads) in enumerate(zip(self.depths, self.num_heads)):
            ws = min(window_size, *extent)
            names = []
            for b in range(depth):
                shift = ws // 2 if b % 2 and ws > 1 else 0
                self.add_module(f"stage{s}_block{b}", SwinBlock(dim, heads, ws, shift))
                names.append(f"stage{s}_block{b}")
            merge = f"merge{s}" if s < 3 else "merge_final"
            self.add_module(merge, PatchMerging(dim))
            self.stages.append((names, merge))
            dim, extent = 2 * dim, [-(-e // 2) for e in extent]
        self.encoder1 = UnetrBasicBlock(fs, fs)
        self.encoder2 = UnetrBasicBlock(2 * fs, 2 * fs)
        self.encoder3 = UnetrBasicBlock(4 * fs, 4 * fs)
        self.encoder4 = UnetrBasicBlock(8 * fs, 8 * fs)
        self.encoder10 = UnetrBasicBlock(16 * fs, 16 * fs)
        self.decoder5 = UnetrUpBlock(16 * fs, 8 * fs)
        self.decoder4 = UnetrUpBlock(8 * fs, 4 * fs)
        self.decoder3 = UnetrUpBlock(4 * fs, 2 * fs)
        self.decoder2 = UnetrUpBlock(2 * fs, fs)
        self.decoder1 = UnetrUpBlock(fs, fs)
        self.out = nn.Conv3d(fs, out_channels, 1)

    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers: He normal (variance 2 / (1 + 0.01^2)
        over fan-in) for the block convs and the transposed ups (flax's
        fan-in: in_channels x 8), lecun normal (truncated at 2 std) for
        patch_embed, the head and every Dense, zero biases, the
        relative-position tables truncated normal with std 0.02, norms at
        (1, 0)."""
        def lecun(w: torch.Tensor, fan_in: int) -> None:
            std = math.sqrt(1.0 / fan_in) / TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)

        with torch.no_grad():
            for name, m in self.named_modules():
                if isinstance(m, nn.ConvTranspose3d):
                    fan_in = m.in_channels * math.prod(m.kernel_size)
                    m.weight.normal_(0.0, math.sqrt(HE_GAIN / fan_in), generator=generator)
                elif isinstance(m, nn.Conv3d):
                    fan_in = m.in_channels * math.prod(m.kernel_size)
                    if name in ("patch_embed", "out"):
                        lecun(m.weight, fan_in)
                    else:
                        m.weight.normal_(0.0, math.sqrt(HE_GAIN / fan_in), generator=generator)
                elif isinstance(m, nn.Linear):
                    lecun(m.weight, m.in_features)
                elif isinstance(m, WindowAttention):
                    nn.init.trunc_normal_(m.rel_pos_bias, 0.0, 0.02, -0.04, 0.04,
                                          generator=generator)
                elif isinstance(m, (nn.LayerNorm, nn.InstanceNorm3d)):
                    m.weight.fill_(1.0)
                if isinstance(m, (nn.Conv3d, nn.Linear, nn.LayerNorm, nn.InstanceNorm3d)) \
                        and m.bias is not None:
                    m.bias.zero_()

    def deep_supervision_heads(self) -> nn.ModuleList:
        """The one segmentation head."""
        return nn.ModuleList([self.out])

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one forward makes (16 A,
        5 B)."""
        return kernel_launches_per_forward(self)

    def kernel_launches_per_step(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one training step makes
        (blocks.kernel_launches_per_step; encoder0.conv1 reads the input)."""
        return kernel_launches_per_step(self, self.encoder0.conv1)

    def forward(self, x: torch.Tensor, *, use_kernels: bool = True,
                deep_supervision: bool = False) -> torch.Tensor | list[torch.Tensor]:
        """use_kernels=False runs the kernels' plain PyTorch versions."""
        if tuple(x.shape[2:]) != self.patch_size:
            raise ValueError(f"SwinUNETR built for {self.patch_size} got {tuple(x.shape[2:])}: "
                             "its window tables are sized by the patch")
        dtype = self.dtype
        x = x.to(dtype).contiguous(memory_format=CL)
        skip0 = self.encoder0(x, use_kernels=use_kernels)
        pe = self.patch_embed
        y = to_ndhwc(F.conv3d(x, pe.weight.to(dtype), pe.bias.to(dtype), stride=2))
        hidden = []
        for names, merge in self.stages:
            for name in names:
                y = getattr(self, name)(y, dtype)
            hidden.append(y)
            y = getattr(self, merge)(y, dtype)
        enc = [block(from_ndhwc(t), use_kernels=use_kernels) for block, t in zip(
            (self.encoder1, self.encoder2, self.encoder3, self.encoder4, self.encoder10),
            (*hidden, y))]
        d = enc[4]
        for decoder, skip in zip((self.decoder5, self.decoder4, self.decoder3, self.decoder2,
                                  self.decoder1), (enc[3], enc[2], enc[1], enc[0], skip0)):
            d = decoder(d, skip, use_kernels=use_kernels)
        logits = F.conv3d(d, self.out.weight.to(dtype), self.out.bias.to(dtype)).float()
        return [logits] if deep_supervision else logits

