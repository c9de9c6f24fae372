"""Weight bridge: the JAX package's flax params -> the port's state dict.

`generic_unet_state_dict_from_flax` is the inverse of
multitalent_tpu/io/torch_convert.convert_generic_unet_state_dict (see that
module for the key table), `resenc_state_dict_from_flax` the inverse of the
port's io/torch_convert.convert_resenc_state_dict for the residual-encoder
UNet (`swin_unetr_state_dict_from_flax` and `mednext_state_dict_from_flax`
likewise for the SwinUNETR and the MedNeXt). They undo, once each:

- the (O, I, kz, ky, kx) -> (kz, ky, kx, I, O) transpose of conv kernels
  (torch_convert.py:30-33), and
- the (I, O, k...) -> (k..., I, O) transpose plus the spatial flip of
  transposed-conv kernels (torch_convert.py:36-42).

Input leaves are numpy arrays (jax.device_get of the params tree); the
result is a dict of float32 torch tensors for the network's load_state_dict.
"""
from __future__ import annotations

import numpy as np
import torch

from multitalent_tpu_torch.io.torch_convert import (mednext_block_counts, mednext_key_table,
                                                   resenc_key_table, swin_depths,
                                                   swin_unetr_key_table)


def _conv_weight(k: np.ndarray) -> np.ndarray:
    """(*k, I, O) -> (O, I, *k)"""
    nd = k.ndim - 2
    return np.transpose(k, (nd + 1, nd) + tuple(range(nd)))


def _transpconv_weight(k: np.ndarray) -> np.ndarray:
    """flax ConvTranspose (*k, I, O), spatially flipped -> torch (I, O, *k)"""
    nd = k.ndim - 2
    k = k[(slice(None, None, -1),) * nd]
    return np.transpose(k, (nd, nd + 1) + tuple(range(nd)))


def generic_unet_state_dict_from_flax(params: dict, num_pool: int,
                                      conv_per_stage: int = 2) -> dict:
    """Nested flax param dict of multitalent_tpu GenericUNet -> torch state
    dict with the reference Generic_UNet keys, 2D or 3D. The variants' norms
    keep the `instnorm` key: scale and bias (instance, batch, group norm) as
    weight and bias, FRN's weight, bias and tau as they are, no norm no
    entry; a head's bias where the tree has one (seg_output_bias)."""
    sd: dict[str, np.ndarray] = {}

    def block(flax_node: dict, prefix: str) -> None:
        sd[f"{prefix}.conv.weight"] = _conv_weight(np.asarray(flax_node["conv"]["kernel"]))
        sd[f"{prefix}.conv.bias"] = np.asarray(flax_node["conv"]["bias"])
        norm = flax_node.get("norm")
        if norm is None:
            return
        for torch_name, flax_name in (("weight", "weight" if "tau" in norm else "scale"),
                                      ("bias", "bias"), ("tau", "tau")):
            if flax_name in norm:
                sd[f"{prefix}.instnorm.{torch_name}"] = np.asarray(norm[flax_name])

    last = conv_per_stage - 1
    for d in range(num_pool):
        for i in range(conv_per_stage):
            block(params[f"enc{d}"][f"block{i}"], f"conv_blocks_context.{d}.blocks.{i}")
    for i in range(last):
        block(params["bottleneck"][f"block{i}"],
              f"conv_blocks_context.{num_pool}.0.blocks.{i}")
    block(params["bottleneck"][f"block{last}"],
          f"conv_blocks_context.{num_pool}.1.blocks.0")
    for u in range(num_pool):
        sd[f"tu.{u}.weight"] = _transpconv_weight(np.asarray(params[f"up{u}"]["kernel"]))
        for i in range(last):
            block(params[f"dec{u}"][f"block{i}"],
                  f"conv_blocks_localization.{u}.0.blocks.{i}")
        block(params[f"dec{u}"][f"block{last}"],
              f"conv_blocks_localization.{u}.1.blocks.0")
        sd[f"seg_outputs.{u}.weight"] = _conv_weight(np.asarray(params[f"seg{u}"]["kernel"]))
        if "bias" in params[f"seg{u}"]:
            sd[f"seg_outputs.{u}.bias"] = np.asarray(params[f"seg{u}"]["bias"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def resenc_state_dict_from_flax(params: dict, num_blocks_encoder,
                                num_blocks_decoder) -> dict:
    """Nested flax param dict of multitalent_tpu ResidualEncoderUNet -> torch
    state dict of the port's (the reference FabiansUNet's keys,
    io/torch_convert.resenc_key_table), biases included."""
    sd: dict[str, np.ndarray] = {}

    def has_skip(s: int, b: int) -> bool:
        return "skip_conv" in params[f"enc{s}"][f"block{b}"]

    for prefix, path, kind in resenc_key_table(num_blocks_encoder, num_blocks_decoder,
                                               has_skip):
        node = params
        for p in path:
            node = node[p]
        if kind == "norm":
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = node["scale"], node["bias"]
            continue
        k = np.asarray(node["kernel"])
        sd[f"{prefix}.weight"] = _transpconv_weight(k) if kind == "transp" else _conv_weight(k)
        if kind == "conv":
            sd[f"{prefix}.bias"] = node["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def swin_unetr_state_dict_from_flax(params: dict) -> dict:
    """Nested flax param dict of multitalent_tpu SwinUNETR -> torch state
    dict of the port's (models/swin_unetr.py; io/torch_convert.
    swin_unetr_key_table), the stage depths read from the tree."""
    sd: dict[str, np.ndarray] = {}

    def has_res(prefix: str) -> bool:
        node = params
        for p in prefix.split("."):
            node = node[p]
        return "res" in node

    for prefix, path, kind in swin_unetr_key_table(swin_depths(params), has_res):
        node = params
        for p in path:
            node = node[p]
        if kind == "table":
            sd[prefix] = node
            continue
        if kind == "norm":
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = node["scale"], node["bias"]
            continue
        k = np.asarray(node["kernel"])
        if kind in ("dense", "dense_nobias"):
            sd[f"{prefix}.weight"] = k.T
        else:
            sd[f"{prefix}.weight"] = (_transpconv_weight(k) if kind == "transp"
                                      else _conv_weight(k))
        if kind in ("conv", "dense"):
            sd[f"{prefix}.bias"] = node["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}


def mednext_state_dict_from_flax(params: dict, rows=None) -> dict:
    """Nested flax param dict of multitalent_tpu MedNeXt -> torch state dict
    of the port's (models/mednext.py; io/torch_convert.mednext_key_table),
    the block counts read from the tree; `rows` (e.g. io/torch_convert.
    mednext_block_rows) converts a part of it instead. The up blocks'
    depthwise kernels are flipped on the three spatial axes (flax correlates
    the dilated input with the kernel as it is, torch's ConvTranspose3d with
    it flipped) and laid out (C, 1, k, k, k); their 1x1x1 res_conv needs no
    flip."""
    sd: dict[str, np.ndarray] = {}
    if rows is None:
        names = [f"{stage}.{block}" for stage, node in params.items() for block in node]
        rows = mednext_key_table(mednext_block_counts(names), "res_conv" in params["down0"])
    for prefix, path, kind in rows:
        node = params
        for p in path:
            node = node[p]
        if kind == "norm":
            sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = node["scale"], node["bias"]
            continue
        k = np.asarray(node["kernel"])
        if kind == "transp":
            sd[f"{prefix}.weight"] = _transpconv_weight(k)
        else:
            w = _conv_weight(k)
            if kind == "dw_transp":
                w = w[(slice(None), slice(None)) + (slice(None, None, -1),) * (w.ndim - 2)]
            sd[f"{prefix}.weight"] = w
        sd[f"{prefix}.bias"] = node["bias"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C"))
            for k, v in sd.items()}
