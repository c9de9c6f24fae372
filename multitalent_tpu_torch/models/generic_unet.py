"""GenericUNet: the plans-driven plain-conv U-Net, as an nn.Module.

Counterpart of multitalent_tpu/models/generic_unet.py, laid out with the
reference Generic_UNet's state-dict keys (generic_UNet.py:156-401, and as
tests/test_torch_convert.py builds them), so a reference checkpoint loads as
it is and io/torch_convert.convert_generic_unet_state_dict maps the same
weights into the JAX package:

  conv_blocks_context.{d}        encoder stage d < num_pool (StackedConvLayers)
  conv_blocks_context.{P}        bottleneck: Sequential(StackedConvLayers of
                                 conv_per_stage-1 convs, first strided;
                                 StackedConvLayers of 1 conv)
  tu.{u}                         ConvTranspose3d, kernel = stride = pool, no bias
  conv_blocks_localization.{u}   Sequential(StackedConvLayers(2f -> f,
                                 conv_per_stage-1); StackedConvLayers(f -> f, 1))
  seg_outputs.{u}                1x1x1 Conv3d to num_classes, no bias

A 2D plan (kernel sizes of two axes) builds the same network of rank 2:
Conv2d blocks on cuDNN, ConvTranspose2d, 1x1 heads, max 480 features
(`build_unet_from_plans`, as generic_unet.py:171 of the JAX package). The
architectural variants' knobs of the JAX GenericUNet (`norm`, `nonlin`,
`negative_slope`, `seg_output_bias`, `nonlin_first`, and through the plans'
overrides `conv_per_stage`, `base_num_features`, `conv_kernel_sizes`) build
their blocks (models/blocks.py); a norm's parameters keep the `instnorm`
key. `nonlin_first` (conv -> activation -> norm) reaches the encoder and
decoder stages; the bottleneck keeps norm -> activation, as the JAX module
builds it (generic_unet.py:90-106,136 of the JAX package), where the
reference's basic_block would reorder it too.

The forward returns the full-resolution logits in fp32, or with
`deep_supervision=True` (training) one fp32 logit map per decoder level,
highest resolution first, each at its level's resolution (the JAX package's
`seg_outputs[::-1]`, generic_unet.py:110-152). Compute runs in `dtype` (bf16
for checkpoints trained with fp16, as training/multitalent.py:70-73) with
fp32 parameters, as flax's param_dtype=float32.
"""
from __future__ import annotations

import torch
from torch import nn

from multitalent_tpu_torch.models.blocks import (NONLINS, NORMS, ConvDropoutNormNonlin,
                                                 StackedConvLayers, conv_nd, conv_transpose_nd,
                                                 kernel_launches_per_forward,
                                                 kernel_launches_per_step, memory_format)
from multitalent_tpu_torch.parallel.mesh import Levels


def compute_stage_features(base_num_features: int, num_stages: int,
                           max_num_features: int) -> list[int]:
    return [min(base_num_features * 2 ** d, max_num_features) for d in range(num_stages)]


class GenericUNet(nn.Module):
    def __init__(self, input_channels: int, base_num_features: int, num_classes: int,
                 pool_op_kernel_sizes, conv_kernel_sizes, conv_per_stage: int = 2,
                 max_num_features: int = 320, dtype: torch.dtype = torch.bfloat16,
                 norm: str = "instance", nonlin: str = "leaky_relu",
                 negative_slope: float = 1e-2, seg_output_bias: bool = False,
                 nonlin_first: bool = False):
        super().__init__()
        pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        kernels = [tuple(int(k) for k in c) for c in conv_kernel_sizes]
        if conv_per_stage < 2:
            raise ValueError("GenericUNet needs conv_per_stage >= 2")
        if norm not in NORMS or nonlin not in NONLINS:
            raise ValueError(f"norm {norm!r} / nonlin {nonlin!r}: one of {NORMS} / {NONLINS}")
        ndim = len(kernels[0])
        if ndim not in (2, 3) or any(len(k) != ndim for k in kernels + pools):
            raise ValueError(f"kernels {kernels} and pools {pools}: one rank, 2 or 3")
        self.ndim = ndim
        self.num_pool = len(pools)
        self.pool_op_kernel_sizes = pools
        self.num_classes = num_classes
        self.input_channels = input_channels
        self.dtype = dtype
        self.norm, self.nonlin, self.negative_slope = norm, nonlin, negative_slope
        self.seg_output_bias = seg_output_bias
        self.nonlin_first = nonlin_first
        self.conv_per_stage = conv_per_stage
        feats = compute_stage_features(base_num_features, self.num_pool + 1,
                                       max_num_features)
        self.features = feats
        block = {"norm": norm, "nonlin": nonlin, "negative_slope": negative_slope}
        stage = {**block, "nonlin_first": nonlin_first}  # not the bottleneck's

        context = []
        for d in range(self.num_pool):
            context.append(StackedConvLayers(
                input_channels if d == 0 else feats[d - 1], feats[d], conv_per_stage,
                kernels[d], first_stride=pools[d - 1] if d > 0 else None, **stage))
        p = self.num_pool
        context.append(nn.Sequential(
            StackedConvLayers(feats[p - 1], feats[p], conv_per_stage - 1, kernels[p],
                              first_stride=pools[p - 1], **block),
            StackedConvLayers(feats[p], feats[p], 1, kernels[p], **block)))
        self.conv_blocks_context = nn.ModuleList(context)

        transp = nn.ConvTranspose3d if ndim == 3 else nn.ConvTranspose2d
        head = nn.Conv3d if ndim == 3 else nn.Conv2d
        tu, loc, seg = [], [], []
        for u in range(self.num_pool):
            f_skip = feats[p - 1 - u]
            f_below = feats[p - u]
            pool = pools[p - 1 - u]
            k = kernels[p - u]
            tu.append(transp(f_below, f_skip, pool, pool, bias=False))
            same3 = k == (3, 3, 3)
            loc.append(nn.Sequential(
                StackedConvLayers(2 * f_skip, f_skip, conv_per_stage - 1, k,
                                  in_splits=(f_skip, f_skip) if same3 else None, **stage),
                StackedConvLayers(f_skip, f_skip, 1, k, **stage)))
            seg.append(head(f_skip, num_classes, 1, bias=seg_output_bias))
        self.tu = nn.ModuleList(tu)
        self.conv_blocks_localization = nn.ModuleList(loc)
        self.seg_outputs = nn.ModuleList(seg)

    def encoder_stages(self) -> list[list[ConvDropoutNormNonlin]]:
        """The conv blocks of each encoder stage and of the bottleneck, in order."""
        stages = [list(self.conv_blocks_context[d].blocks) for d in range(self.num_pool)]
        stages.append([b for stack in self.conv_blocks_context[self.num_pool]
                       for b in stack.blocks])
        return stages

    def decoder_stages(self) -> list[list[ConvDropoutNormNonlin]]:
        """The conv blocks of each decoder stage, highest resolution last."""
        return [[b for stack in loc for b in stack.blocks]
                for loc in self.conv_blocks_localization]

    def deep_supervision_heads(self) -> nn.ModuleList:
        """The segmentation heads, lowest resolution first (the forward lists
        its deep-supervision outputs highest resolution first)."""
        return self.seg_outputs

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one forward makes."""
        return kernel_launches_per_forward(self)

    def kernel_launches_per_step(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one training step (forward
        + backward) makes (blocks.kernel_launches_per_step; the first conv
        reads the network's input)."""
        return kernel_launches_per_step(self, self.conv_blocks_context[0].blocks[0].conv)

    def fused_kernel_launches_per_forward(self, differentiable: bool = False
                                          ) -> dict[str, int]:
        """Launches of each hand-written kernel that one forward of the fused
        route (ops/fused_unet.py) makes: kernel D for every kernel conv (its
        dual form on the decoders' first convs). Inference adds kernel E's
        stats pass for every other conv (cuDNN), its apply pass for every
        materialized activation (each encoder stage and the bottleneck, each
        decoder stage but the last) and before every cuDNN conv inside a
        chain, and kernel F once; training (`differentiable`) takes those in
        plain torch."""
        blocks = [m for m in self.modules() if isinstance(m, ConvDropoutNormNonlin)]
        kernels = sum(1 for m in blocks if m.kernel is not None)
        if differentiable:
            return {"conv3d_same_affine": kernels}
        firsts = {id(s[0]) for s in self.encoder_stages() + self.decoder_stages()}
        other = [m for m in blocks if m.kernel is None]
        return {"conv3d_same_affine": kernels, "channel_stats": len(other),
                "affine_lrelu": 2 * self.num_pool + sum(1 for m in other
                                                        if id(m) not in firsts),
                "seghead": 1}

    def fused_kernel_launches_per_step(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one training step of the
        fused route makes: kernel D per kernel conv forward; its backward's dx
        by kernel A (unless it reads the network's input) and dw by kernel C."""
        kernels = self.fused_kernel_launches_per_forward(True)["conv3d_same_affine"]
        first = self.conv_blocks_context[0].blocks[0]
        return {"conv3d_same_affine": kernels,
                "conv3d_same": kernels - (first.kernel is not None),
                "conv3d_same_wgrad": kernels}

    def forward(self, x: torch.Tensor, *, use_kernels: bool = True,
                deep_supervision: bool = False) -> torch.Tensor | list[torch.Tensor]:
        """x (N, C_in, Z, Y, X), or (N, C_in, Y, X) in 2D -> full-resolution
        logits (N, K, ...) fp32, or with deep_supervision a list of logits per
        decoder level, highest resolution first. use_kernels=False runs the
        kernels' plain PyTorch versions instead."""
        x = x.to(self.dtype)
        x = x.contiguous(memory_format=memory_format(x))
        levels = Levels(x, self.pool_op_kernel_sizes)  # a slab's levels on the space axis
        skips = []
        for d in range(self.num_pool):
            x = self.conv_blocks_context[d](levels.down(x, d), use_kernels=use_kernels)
            skips.append(x)
        x = levels.down(x, self.num_pool)
        for stack in self.conv_blocks_context[self.num_pool]:
            x = stack(x, use_kernels=use_kernels)
        seg_outputs = []
        for u in range(self.num_pool):
            tu = self.tu[u]
            x = conv_transpose_nd(x, tu.weight.to(self.dtype), tu.stride)
            x = levels.up(x.contiguous(memory_format=memory_format(x)), self.num_pool - 1 - u)
            skip = skips[self.num_pool - 1 - u]
            first, rest = self.conv_blocks_localization[u]
            if first.blocks[0].kernel == "conv3d_same_dual":
                x = first(x, skip, use_kernels=use_kernels)
            else:
                x = first(torch.cat((x, skip), 1), use_kernels=use_kernels)
            x = rest(x, use_kernels=use_kernels)
            if deep_supervision or u == self.num_pool - 1:
                head = self.seg_outputs[u]
                bias = None if head.bias is None else head.bias.to(self.dtype)
                seg_outputs.append(conv_nd(x, head.weight.to(self.dtype), bias).float())
        if deep_supervision:
            return seg_outputs[::-1]
        return seg_outputs[-1]


def build_unet_from_plans(plans, stage: int, num_classes: int | None = None,
                          dtype: torch.dtype = torch.bfloat16,
                          input_channels: int | None = None, **overrides) -> GenericUNet:
    """GenericUNet for one resolution stage of a multitalent_tpu Plans object
    (the wiring of multitalent_tpu/models/generic_unet.build_unet_from_plans:
    max 320 features in 3D, 480 in 2D); `input_channels` defaults to the
    plans' modalities (the cascade's full-resolution stage adds the previous
    stage's one-hots). `overrides` are a variant trainer's network_overrides
    (norm, nonlin, negative_slope, seg_output_bias, nonlin_first,
    conv_per_stage, base_num_features, conv_kernel_sizes); `deep_supervision` among them is
    dropped, the port's deep supervision being an argument of the forward."""
    st = plans.stage(stage)
    kwargs = dict(
        input_channels=plans.num_modalities if input_channels is None else input_channels,
        base_num_features=plans.base_num_features,
        num_classes=num_classes if num_classes is not None else plans.num_classes + 1,
        pool_op_kernel_sizes=st.pool_op_kernel_sizes,
        conv_kernel_sizes=st.conv_kernel_sizes,
        conv_per_stage=plans.conv_per_stage,
        max_num_features=320 if len(st.patch_size) == 3 else 480,
        dtype=dtype)
    kwargs.update({k: v for k, v in overrides.items() if k != "deep_supervision"})
    return GenericUNet(**kwargs)
