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

The forward returns the full-resolution logits in fp32, or with
`deep_supervision=True` (training) one fp32 logit map per decoder level,
highest resolution first, each at its level's resolution (the JAX package's
`seg_outputs[::-1]`, generic_unet.py:110-152). Compute runs in `dtype` (bf16
for checkpoints trained with fp16, as training/multitalent.py:70-73) with
fp32 parameters, as flax's param_dtype=float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multitalent_tpu_torch.models.blocks import CL, ConvDropoutNormNonlin, StackedConvLayers


def compute_stage_features(base_num_features: int, num_stages: int,
                           max_num_features: int) -> list[int]:
    return [min(base_num_features * 2 ** d, max_num_features) for d in range(num_stages)]


class GenericUNet(nn.Module):
    def __init__(self, input_channels: int, base_num_features: int, num_classes: int,
                 pool_op_kernel_sizes, conv_kernel_sizes, conv_per_stage: int = 2,
                 max_num_features: int = 320, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        pools = [tuple(int(k) for k in p) for p in pool_op_kernel_sizes]
        kernels = [tuple(int(k) for k in c) for c in conv_kernel_sizes]
        if conv_per_stage < 2:
            raise ValueError("GenericUNet needs conv_per_stage >= 2")
        self.num_pool = len(pools)
        self.pool_op_kernel_sizes = pools
        self.num_classes = num_classes
        self.input_channels = input_channels
        self.dtype = dtype
        feats = compute_stage_features(base_num_features, self.num_pool + 1,
                                       max_num_features)
        self.features = feats

        context = []
        for d in range(self.num_pool):
            context.append(StackedConvLayers(
                input_channels if d == 0 else feats[d - 1], feats[d], conv_per_stage,
                kernels[d], first_stride=pools[d - 1] if d > 0 else None))
        p = self.num_pool
        context.append(nn.Sequential(
            StackedConvLayers(feats[p - 1], feats[p], conv_per_stage - 1, kernels[p],
                              first_stride=pools[p - 1]),
            StackedConvLayers(feats[p], feats[p], 1, kernels[p])))
        self.conv_blocks_context = nn.ModuleList(context)

        tu, loc, seg = [], [], []
        for u in range(self.num_pool):
            f_skip = feats[p - 1 - u]
            f_below = feats[p - u]
            pool = pools[p - 1 - u]
            k = kernels[p - u]
            tu.append(nn.ConvTranspose3d(f_below, f_skip, pool, pool, bias=False))
            same3 = k == (3, 3, 3)
            loc.append(nn.Sequential(
                StackedConvLayers(2 * f_skip, f_skip, conv_per_stage - 1, k,
                                  in_splits=(f_skip, f_skip) if same3 else None),
                StackedConvLayers(f_skip, f_skip, 1, k)))
            seg.append(nn.Conv3d(f_skip, num_classes, 1, bias=False))
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

    def _kernel_blocks(self) -> list:
        return [m for m in self.modules() if getattr(m, "kernel", None) is not None]

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one forward makes."""
        counts = {"conv3d_same": 0, "conv3d_same_dual": 0}
        for m in self._kernel_blocks():
            counts[m.kernel] += 1
        return counts

    def kernel_launches_per_step(self) -> dict[str, int]:
        """Launches of each hand-written kernel that one training step (forward
        + backward) makes: every kernel conv's forward (A or B), its dx by
        kernel A (unless it reads the network's input, which needs no
        gradient) and its dw by kernel C (single or dual form)."""
        counts = self.kernel_launches_per_forward()
        first = self.conv_blocks_context[0].blocks[0]
        dx = sum(1 for m in self._kernel_blocks() if m is not first)
        counts["conv3d_same"] += dx
        counts["conv3d_same_wgrad"] = len(self._kernel_blocks())
        return counts

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
        """x (N, C_in, Z, Y, X) -> full-resolution logits (N, K, Z, Y, X) fp32,
        or with deep_supervision a list of logits per decoder level, highest
        resolution first. use_kernels=False runs the kernels' plain PyTorch
        versions instead."""
        x = x.to(self.dtype).contiguous(memory_format=CL)
        skips = []
        for d in range(self.num_pool):
            x = self.conv_blocks_context[d](x, use_kernels=use_kernels)
            skips.append(x)
        for stack in self.conv_blocks_context[self.num_pool]:
            x = stack(x, use_kernels=use_kernels)
        seg_outputs = []
        for u in range(self.num_pool):
            tu = self.tu[u]
            x = F.conv_transpose3d(x, tu.weight.to(self.dtype), None, tu.stride)
            x = x.contiguous(memory_format=CL)
            skip = skips[self.num_pool - 1 - u]
            first, rest = self.conv_blocks_localization[u]
            if first.blocks[0].kernel == "conv3d_same_dual":
                x = first(x, skip, use_kernels=use_kernels)
            else:
                x = first(torch.cat((x, skip), 1), use_kernels=use_kernels)
            x = rest(x, use_kernels=use_kernels)
            if deep_supervision or u == self.num_pool - 1:
                head = self.seg_outputs[u]
                seg_outputs.append(F.conv3d(x, head.weight.to(self.dtype)).float())
        if deep_supervision:
            return seg_outputs[::-1]
        return seg_outputs[-1]


def build_unet_from_plans(plans, stage: int, num_classes: int | None = None,
                          dtype: torch.dtype = torch.bfloat16) -> GenericUNet:
    """GenericUNet for one resolution stage of a multitalent_tpu Plans object
    (the wiring of multitalent_tpu/models/generic_unet.build_unet_from_plans)."""
    st = plans.stage(stage)
    if len(st.patch_size) != 3:
        raise NotImplementedError("the port runs 3D plans only (2D GenericUNet: "
                                  "ROADMAP queue 1, item 10)")
    return GenericUNet(
        input_channels=plans.num_modalities,
        base_num_features=plans.base_num_features,
        num_classes=num_classes if num_classes is not None else plans.num_classes + 1,
        pool_op_kernel_sizes=st.pool_op_kernel_sizes,
        conv_kernel_sizes=st.conv_kernel_sizes,
        conv_per_stage=plans.conv_per_stage,
        dtype=dtype)
