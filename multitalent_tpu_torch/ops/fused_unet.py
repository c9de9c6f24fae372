"""The GenericUNet forward with the conv -> InstanceNorm -> LeakyReLU chains
fused into the conv kernels.

Counterpart of multitalent_tpu/ops/packed_unet.py:packed_unet_forward_fused
(:607-831) with every stage unpacked. Each stride-1 3x3x3 conv after a stage's
first reads the previous conv's RAW (pre-norm) output and applies that norm
and the activation in its prologue (kernel D); every conv on the chain hands
out the per-sample channel sums the next norm needs, so no normalize pass and
no statistics pass runs between two convs. Per stage:

- the first conv: kernel D without a prologue where the block is a kernel
  conv (stride 1, 3x3x3, Cin >= 8), its dual form on a decoder's (up, skip)
  pair, else cuDNN (the Cin=1 first conv, strided convs, other kernel
  shapes), whose statistics come from kernel E's stats pass (inference) or
  plain torch (training);
- the chain: kernel D with the prologue (a non-kernel conv there gets its
  input normalized in memory first, then cuDNN);
- `materialize`: the normalized activation in memory, only where a non-conv
  consumer needs it (skips, strided and transposed convs, the
  deep-supervision heads), by kernel E's apply pass (inference) or plain
  torch (training);
- the inference head: kernel F, with the last norm in its prologue, writing
  NCDHW logits (bf16 for a bf16 model, packed_unet.py:822, else fp32).

Training (`differentiable=True`) runs the chain through the autograd
functions of kernel D (backward by kernels A and C, as
pallas_conv.py:_affine_fast_bwd), and everything around it in plain torch with
autograd, as the JAX package leaves it to XLA; the heads are plain pointwise
convs. The inference forward runs without autograd (kernels E and F have no
backward).

The switches are the JAX package's, read where it reads them:
`make_inference_forward` (MTTPU_FUSED_NORM=1, packed_unet.py:865) and
`make_train_forward` (MTTPU_FUSED_TRAIN=1, :904); both default to the
unfused forward. The route reads the GenericUNet's own parameters, so its
state-dict keys and the weight bridges are unchanged.
"""
from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from multitalent_tpu_torch.models.blocks import CL, ConvDropoutNormNonlin, from_ndhwc, to_ndhwc
from multitalent_tpu_torch.ops import conv3d as cv
from multitalent_tpu_torch.ops import fused_norm as fn
from multitalent_tpu_torch.ops import seghead as sg


def _nvox(raw: torch.Tensor) -> int:
    return int(raw.shape[1]) * int(raw.shape[2]) * int(raw.shape[3])


class _Chain:
    """The fused chain's steps on channels-last (N, Z, Y, X, C) tensors.
    `train`: plain torch with autograd around kernel D; `use_kernels=False`:
    every kernel's plain version (the reference the kernels are held to)."""

    def __init__(self, dtype: torch.dtype, train: bool, use_kernels: bool):
        self.dtype = dtype
        self.train = train
        self.use_kernels = use_kernels

    def _plain(self) -> bool:
        return self.train or not self.use_kernels

    def stats(self, raw: torch.Tensor) -> torch.Tensor:
        return fn.channel_stats_ref(raw) if self._plain() else fn.channel_stats(raw)

    def affine(self, stats: torch.Tensor, block: ConvDropoutNormNonlin, raw: torch.Tensor):
        norm = block.instnorm
        sc, sh = fn.stats_affine(stats, norm.weight, norm.bias, _nvox(raw), norm.eps)
        return sc.contiguous(), sh.contiguous()

    def normalize(self, raw: torch.Tensor, affine, slope: float) -> torch.Tensor:
        if self._plain():
            return fn.affine_lrelu_ref(raw, *affine, slope, True)
        return fn.affine_lrelu(raw, *affine, slope, True)

    def materialize(self, raw, stats, block) -> torch.Tensor:
        """The block's normalized activation as an NCDHW channels_last_3d view."""
        norm = block.instnorm
        return from_ndhwc(fn.normalize_from_stats(raw, stats, norm.weight, norm.bias,
                                                  block.negative_slope, norm.eps,
                                                  use_kernels=not self._plain()))

    def conv(self, block: ConvDropoutNormNonlin, x: torch.Tensor, affine=None):
        """(raw out, stats) of `block`'s conv on x: the previous conv's raw
        output with the norm `affine` = (scale, shift) still to apply, or an
        activation already normalized (affine None)."""
        w, b, slope = block.conv.weight, block.conv.bias, block.negative_slope
        sc, sh = affine if affine is not None else (None, None)
        if block.kernel == "conv3d_same":
            if self.use_kernels:
                return cv.conv3d_same_affine_op(x, w, b, sc, sh, slope,
                                                block.prepared_weight(self.dtype))
            return cv.conv3d_same_affine_ref(x, w.to(self.dtype), b, sc, sh, slope)
        if affine is not None:
            x = self.normalize(x, affine, slope)
        out = F.conv3d(from_ndhwc(x), w.to(self.dtype), b.to(self.dtype), block.conv.stride,
                       block.conv.padding)
        out = to_ndhwc(out)
        return out, self.stats(out)

    def conv_dual(self, block: ConvDropoutNormNonlin, up: torch.Tensor, skip: torch.Tensor):
        """(raw out, stats) of a decoder's first conv over concat(up, skip)."""
        w, b = block.conv.weight, block.conv.bias
        if block.kernel != "conv3d_same_dual":
            return self.conv(block, torch.cat((up, skip), -1).contiguous())
        if self.use_kernels:
            return cv.conv3d_same_dual_stats_op(up, skip, w, b,
                                                block.prepared_weight(self.dtype))
        return cv.conv3d_same_dual_stats_ref(up, skip, w.to(self.dtype), b)

    def chain(self, blocks: list[ConvDropoutNormNonlin], raw, stats):
        """The stage's convs after its first: each takes the previous raw
        output with that block's norm in its prologue."""
        prev = blocks[0]
        for block in blocks[1:]:
            raw, stats = self.conv(block, raw, self.affine(stats, prev, raw))
            prev = block
        return raw, stats


def unet_forward_fused(net, x: torch.Tensor, *, deep_supervision: bool = False,
                       differentiable: bool = False, use_kernels: bool = True):
    """x (N, C_in, Z, Y, X) -> the GenericUNet's logits through the fused
    chain: inference (N, K, Z, Y, X) in bf16 for a bf16 model, else fp32; with
    `differentiable` (training) fp32 logits and autograd through kernel D;
    with `deep_supervision` one fp32 logit map per decoder level, highest
    resolution first. use_kernels=False runs every kernel's plain version."""
    if not differentiable:
        with torch.no_grad():
            return _forward(net, x, deep_supervision, False, use_kernels)
    return _forward(net, x, deep_supervision, True, use_kernels)


def _forward(net, x, deep_supervision: bool, train: bool, use_kernels: bool):
    dtype = net.dtype
    ch = _Chain(dtype, train, use_kernels)
    x_mat = x.to(dtype).contiguous(memory_format=CL)
    skips = []
    for d, blocks in enumerate(net.encoder_stages()):
        raw, stats = ch.conv(blocks[0], to_ndhwc(x_mat))
        raw, stats = ch.chain(blocks, raw, stats)
        x_mat = ch.materialize(raw, stats, blocks[-1])
        if d < net.num_pool:
            skips.append(x_mat)

    seg_outputs = []
    decoders = net.decoder_stages()
    for u, blocks in enumerate(decoders):
        tu = net.tu[u]
        up = F.conv_transpose3d(x_mat, tu.weight.to(dtype), None, tu.stride)
        raw, stats = ch.conv_dual(blocks[0], to_ndhwc(up), to_ndhwc(skips[net.num_pool - 1 - u]))
        raw, stats = ch.chain(blocks, raw, stats)
        last = u == net.num_pool - 1
        if not last or deep_supervision or train:
            x_mat = ch.materialize(raw, stats, blocks[-1])
        if deep_supervision or (last and train):
            head = net.seg_outputs[u]
            seg_outputs.append(F.conv3d(x_mat, head.weight.to(dtype)).float())
    if deep_supervision:
        return seg_outputs[::-1]
    if train:
        return seg_outputs[-1]

    # the inference head: the last norm rides kernel F's prologue
    block = decoders[-1][-1]
    sc, sh = ch.affine(stats, block, raw)
    out_dtype = dtype if dtype == torch.bfloat16 else torch.float32
    head = net.seg_outputs[net.num_pool - 1].weight
    if use_kernels:
        return sg.seghead(raw, head, None, sc, sh, block.negative_slope, out_dtype)
    return sg.seghead_ref(raw, head, None, sc, sh, block.negative_slope, out_dtype)


def make_inference_forward(net):
    """The network call of inference: the fused route under
    MTTPU_FUSED_NORM=1 (read here, once, as packed_unet.py:865 reads it),
    else the network itself."""
    if os.environ.get("MTTPU_FUSED_NORM") == "1":
        def forward(x: torch.Tensor) -> torch.Tensor:
            return unet_forward_fused(net, x)
        return forward
    return net


def make_train_forward(net):
    """The training forward (x, deep_supervision=...) -> logits: the fused
    route with autograd under MTTPU_FUSED_TRAIN=1 (packed_unet.py:904), else
    the network itself."""
    if os.environ.get("MTTPU_FUSED_TRAIN", "0") == "1":
        def forward(x: torch.Tensor, deep_supervision: bool = False):
            return unet_forward_fused(net, x, deep_supervision=deep_supervision,
                                      differentiable=True)
        return forward
    return net
