"""FabiansUNet: residual encoder + plain-conv decoder, as an nn.Module.

Counterpart of multitalent_tpu/models/residual_unet.py (the reference's
generic_modular_residual_UNet.py FabiansUNet as the resenc MultiTalent
trainer builds it), laid out with the reference's state-dict keys
(multitalent_tpu/io/torch_convert.py:112-125), so a reference `.model` loads
by name once io/torch_convert.fabians_unet_state_dict has undone its quirks:

  encoder.initial_conv, encoder.initial_norm
  encoder.stages.{s}.convs.{b}.conv1|norm1|conv2|norm2   BasicResidualBlock
  encoder.stages.{s}.convs.{b}.downsample_skip.0|1       1x1x1 conv (no bias), norm
  decoder.tus.{i}                                        ConvTranspose3d, no bias
  decoder.stages.{i}.convs.{b}.conv|norm                 ConvDropoutNormNonlin
  decoder.deep_supervision_outputs.{i}                   1x1x1 head with bias

Decoder stage i = 0 is the lowest resolution. The convs carry the biases of
the JAX modules (initial_conv, conv1, conv2, the decoder convs, the heads);
the reference's are bias-free and load as zeros.

Routes, as in models/blocks.py: every stride-1 3x3x3 conv with Cin >= 8 runs
on kernel A (each block's conv2, and conv1 of every block but a strided
stage's first), each decoder stage's first conv on (up, skip) on kernel B;
the Cin=1 initial conv, the strided conv1, the 1x1x1 skip, the transposed
convs and the heads stay cuDNN. The encoder's norms are plain torch always,
as the JAX block's InstanceNorm calls are; the decoder's go through
blocks.instance_norm_lrelu, so MTTPU_PALLAS_NORM=1 runs them on kernel E, as
the JAX ConvNormAct does.

Rounding in bf16, as the JAX block: norm1 -> bf16 -> LeakyReLU; norm2 ->
bf16; the skip (x, or skip_norm's bf16 output) added in bf16; LeakyReLU.

A 2D plan (kernel sizes of two axes) builds the network of rank 2: Conv2d
on cuDNN, InstanceNorm2d, ConvTranspose2d, 1x1 heads; max 320 features in
2D too, as the JAX package builds it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multitalent_tpu_torch.models.blocks import (ConvDropoutNormNonlin, conv_nd,
                                                 conv_transpose_nd, instance_norm,
                                                 instance_norm_module,
                                                 kernel_launches_per_forward,
                                                 kernel_launches_per_step, make_conv,
                                                 memory_format)
from multitalent_tpu_torch.models.generic_unet import compute_stage_features
from multitalent_tpu_torch.parallel.mesh import Levels


def _norm(x: torch.Tensor, norm: nn.Module) -> torch.Tensor:
    return instance_norm(x, norm.weight, norm.bias, norm.eps)


class BasicResidualBlock(nn.Module):
    """conv-IN-lrelu-conv-IN + projected skip, joint LeakyReLU. The trainers'
    He init (training/trainers.init_weights_he) sets norm2's scale to zero, so
    each block starts as an identity refinement."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size, stride=None,
                 negative_slope: float = 1e-2):
        super().__init__()
        stride = tuple(int(s) for s in stride) if stride is not None else (1,) * len(kernel_size)
        nd = len(stride)
        self.negative_slope = negative_slope
        self.conv1 = make_conv(in_channels, out_channels, kernel_size, stride)
        self.norm1 = instance_norm_module(out_channels, nd)
        self.conv2 = make_conv(out_channels, out_channels, kernel_size)
        self.norm2 = instance_norm_module(out_channels, nd)
        if any(s != 1 for s in stride) or in_channels != out_channels:
            self.downsample_skip = nn.Sequential(
                make_conv(in_channels, out_channels, (1,) * nd, stride, bias=False),
                instance_norm_module(out_channels, nd))
        else:
            self.downsample_skip = None

    def forward(self, x: torch.Tensor, *, use_kernels: bool = True) -> torch.Tensor:
        slope = self.negative_slope
        y = F.leaky_relu(_norm(self.conv1(x, use_kernels=use_kernels), self.norm1), slope,
                         inplace=True)
        y = _norm(self.conv2(y, use_kernels=use_kernels), self.norm2)
        if self.downsample_skip is not None:
            conv, norm = self.downsample_skip
            x = _norm(conv(x, use_kernels=use_kernels), norm)
        return F.leaky_relu(y + x, slope, inplace=True)


class ResidualStage(nn.Module):
    """`num_blocks` residual blocks; the first carries the stage's stride
    (ResidualLayer parity, conv_blocks.py:233-260)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int, kernel_size,
                 stride=None):
        super().__init__()
        self.convs = nn.ModuleList([
            BasicResidualBlock(in_channels if b == 0 else out_channels, out_channels,
                               kernel_size, stride if b == 0 else None)
            for b in range(num_blocks)])

    def forward(self, x: torch.Tensor, *, use_kernels: bool = True) -> torch.Tensor:
        for block in self.convs:
            x = block(x, use_kernels=use_kernels)
        return x


def _container(**children: nn.Module) -> nn.Module:
    """A module holding `children` under their names (the reference's
    encoder / decoder / stage attributes, for its state-dict keys)."""
    module = nn.Module()
    for name, child in children.items():
        module.add_module(name, child)
    return module


class ResidualEncoderUNet(nn.Module):
    """forward(x (N, C_in, Z, Y, X)) -> full-resolution logits fp32, or with
    deep_supervision one per decoder stage, highest resolution first.
    `pool_op_kernel_sizes` includes the leading (1, 1, 1) stage."""

    def __init__(self, input_channels: int, base_num_features: int, num_classes: int,
                 pool_op_kernel_sizes, conv_kernel_sizes, num_blocks_encoder,
                 num_blocks_decoder, max_num_features: int = 320,
                 negative_slope: float = 1e-2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        kernels = [tuple(int(k) for k in c) for c in conv_kernel_sizes]
        num_stages = len(pools)
        if len(num_blocks_encoder) != num_stages or len(num_blocks_decoder) != num_stages - 1:
            raise ValueError(f"{num_stages} stages need as many encoder block counts and one "
                             f"decoder block count fewer, got {tuple(num_blocks_encoder)}, "
                             f"{tuple(num_blocks_decoder)}")
        nd = len(kernels[0])
        if nd not in (2, 3) or any(len(k) != nd for k in kernels + pools):
            raise ValueError(f"kernels {kernels} and pools {pools}: one rank, 2 or 3")
        self.pool_op_kernel_sizes = pools
        self.num_classes = num_classes
        self.input_channels = input_channels
        self.dtype = dtype
        self.negative_slope = negative_slope
        feats = compute_stage_features(base_num_features, num_stages, max_num_features)
        self.features = feats

        self.encoder = _container(
            initial_conv=make_conv(input_channels, base_num_features, (3,) * nd),
            initial_norm=instance_norm_module(base_num_features, nd),
            stages=nn.ModuleList([
                ResidualStage(base_num_features if s == 0 else feats[s - 1], feats[s],
                              int(num_blocks_encoder[s]), kernels[s], pools[s])
                for s in range(num_stages)]))
        transp = nn.ConvTranspose3d if nd == 3 else nn.ConvTranspose2d
        head = nn.Conv3d if nd == 3 else nn.Conv2d
        tus, stages, heads = [], [], []
        for i, s in enumerate(range(num_stages - 2, -1, -1)):
            f, k = feats[s], kernels[s]
            tus.append(transp(feats[s + 1], f, pools[s + 1], pools[s + 1], bias=False))
            same3 = k == (3, 3, 3)
            stages.append(_container(convs=nn.ModuleList([
                ConvDropoutNormNonlin(2 * f if b == 0 else f, f, k,
                                      in_splits=(f, f) if b == 0 and same3 else None,
                                      negative_slope=negative_slope, norm_name="norm")
                for b in range(int(num_blocks_decoder[i]))])))
            heads.append(head(f, num_classes, 1, bias=True))
        self.decoder = _container(tus=nn.ModuleList(tus), stages=nn.ModuleList(stages),
                                  deep_supervision_outputs=nn.ModuleList(heads))

    def deep_supervision_heads(self) -> nn.ModuleList:
        """The segmentation heads, lowest resolution first (the forward lists
        its deep-supervision outputs highest resolution first)."""
        return self.decoder.deep_supervision_outputs

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one forward makes."""
        return kernel_launches_per_forward(self)

    def kernel_launches_per_step(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one training step makes
        (blocks.kernel_launches_per_step; the initial conv reads the
        network's input)."""
        return kernel_launches_per_step(self, self.encoder.initial_conv)

    def forward(self, x: torch.Tensor, *, use_kernels: bool = True,
                deep_supervision: bool = False) -> torch.Tensor | list[torch.Tensor]:
        """use_kernels=False runs the kernels' plain PyTorch versions."""
        enc, dec = self.encoder, self.decoder
        x = x.to(self.dtype)
        x = x.contiguous(memory_format=memory_format(x))
        x = F.leaky_relu(_norm(enc.initial_conv(x, use_kernels=use_kernels), enc.initial_norm),
                         self.negative_slope, inplace=True)
        # a slab's levels on the space axis: stage s > 0 strides into level s
        levels = Levels(x, self.pool_op_kernel_sizes[1:])
        skips = []
        for s, stage in enumerate(enc.stages):
            x = stage(levels.down(x, s), use_kernels=use_kernels)
            skips.append(x)
        num_dec = len(dec.stages)
        seg_outputs = []
        for i in range(num_dec):
            tu = dec.tus[i]
            x = conv_transpose_nd(x, tu.weight.to(self.dtype), tu.stride)
            x = levels.up(x.contiguous(memory_format=memory_format(x)), num_dec - 1 - i)
            skip = skips[num_dec - 1 - i]
            first, *rest = dec.stages[i].convs
            if first.kernel == "conv3d_same_dual":
                x = first(x, skip, use_kernels=use_kernels)
            else:
                x = first(torch.cat((x, skip), 1), use_kernels=use_kernels)
            for block in rest:
                x = block(x, use_kernels=use_kernels)
            if deep_supervision or i == num_dec - 1:
                head = dec.deep_supervision_outputs[i]
                seg_outputs.append(conv_nd(x, head.weight.to(self.dtype),
                                           head.bias.to(self.dtype)).float())
        if deep_supervision:
            return seg_outputs[::-1]
        return seg_outputs[-1]


def build_resenc_unet_from_plans(plans, stage: int, num_classes: int | None = None,
                                 dtype: torch.dtype = torch.bfloat16) -> ResidualEncoderUNet:
    """ResidualEncoderUNet for one stage of residual-encoder plans (the wiring
    of multitalent_tpu/models/residual_unet.build_resenc_unet_from_plans)."""
    st = plans.stage(stage)
    if st.num_blocks_encoder is None or st.num_blocks_decoder is None:
        raise ValueError("plans do not carry num_blocks_encoder / num_blocks_decoder "
                         "(not residual-encoder plans)")
    return ResidualEncoderUNet(
        input_channels=plans.num_modalities,
        base_num_features=plans.base_num_features,
        num_classes=num_classes if num_classes is not None else plans.num_classes + 1,
        pool_op_kernel_sizes=st.pool_op_kernel_sizes,
        conv_kernel_sizes=st.conv_kernel_sizes,
        num_blocks_encoder=st.num_blocks_encoder,
        num_blocks_decoder=st.num_blocks_decoder,
        dtype=dtype)
