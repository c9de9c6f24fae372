"""Reading the reference's torch checkpoints, and the state dict -> flax tree
conversion.

The port's copy of the functions of multitalent_tpu/io/torch_convert.py that
inference/model_restore.py and JAX-layout folders need:
`convert_generic_unet_state_dict` turns a GenericUNet state dict into the JAX
package's flax param tree (the inverse of
io/from_jax.generic_unet_state_dict_from_flax; both ways are bit-exact).
"""
from __future__ import annotations

import numpy as np


def strip_module_prefix(state_dict: dict) -> dict:
    """Drop the `module.` prefix DDP puts on every key
    (nnUNetTrainerV2_DDP.py:650-661)."""
    return {k[len("module."):] if k.startswith("module.") else k: v
            for k, v in state_dict.items()}


def load_reference_checkpoint(path: str):
    """Load a reference .model checkpoint file (torch serialized dict with
    'state_dict' etc., network_trainer.py:256-286)."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    return ckpt["state_dict"]


def _conv_weight(w: np.ndarray) -> np.ndarray:
    """(O, I, *k) -> (*k, I, O)"""
    nd = w.ndim - 2
    return np.transpose(w, tuple(range(2, 2 + nd)) + (1, 0))


def _transpconv_weight(w: np.ndarray) -> np.ndarray:
    """(I, O, *k) -> (*k, I, O), spatially flipped (torch's ConvTranspose
    places tap k at output offset k, flax applies the kernel mirrored)."""
    nd = w.ndim - 2
    out = np.transpose(w, tuple(range(2, 2 + nd)) + (0, 1))
    return out[(slice(None, None, -1),) * nd]


def convert_generic_unet_state_dict(state_dict: dict, num_pool: int,
                                    conv_per_stage: int = 2) -> dict:
    """Torch Generic_UNet state_dict (numpy or torch tensors) -> nested flax
    param dict of multitalent_tpu's GenericUNet (fp32 numpy leaves):

      conv_blocks_context.{d}.blocks.{i}          -> enc{d}/block{i}/{conv,norm}
      conv_blocks_context.{P}.0.blocks.{i}        -> bottleneck/block{i}
      conv_blocks_context.{P}.1.blocks.0          -> bottleneck/block{last}
      tu.{u}                                      -> up{u}
      conv_blocks_localization.{u}.0.blocks.{i}   -> dec{u}/block{i}
      conv_blocks_localization.{u}.1.blocks.0     -> dec{u}/block{last}
      seg_outputs.{u}                             -> seg{u}
    """
    sd = {k: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                        dtype=np.float32)
          for k, v in strip_module_prefix(state_dict).items()}
    params: dict = {}

    def put(path: list[str], leaf_name: str, value: np.ndarray) -> None:
        node = params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf_name] = value

    def convert_block(torch_prefix: str, flax_path: list[str]) -> None:
        put(flax_path + ["conv"], "kernel", _conv_weight(sd[f"{torch_prefix}.conv.weight"]))
        put(flax_path + ["conv"], "bias", sd[f"{torch_prefix}.conv.bias"])
        put(flax_path + ["norm"], "scale", sd[f"{torch_prefix}.instnorm.weight"])
        put(flax_path + ["norm"], "bias", sd[f"{torch_prefix}.instnorm.bias"])

    last = conv_per_stage - 1
    for d in range(num_pool):
        for i in range(conv_per_stage):
            convert_block(f"conv_blocks_context.{d}.blocks.{i}", [f"enc{d}", f"block{i}"])
    for i in range(last):
        convert_block(f"conv_blocks_context.{num_pool}.0.blocks.{i}",
                      ["bottleneck", f"block{i}"])
    convert_block(f"conv_blocks_context.{num_pool}.1.blocks.0", ["bottleneck", f"block{last}"])
    for u in range(num_pool):
        put([f"up{u}"], "kernel", _transpconv_weight(sd[f"tu.{u}.weight"]))
        for i in range(last):
            convert_block(f"conv_blocks_localization.{u}.0.blocks.{i}",
                          [f"dec{u}", f"block{i}"])
        convert_block(f"conv_blocks_localization.{u}.1.blocks.0", [f"dec{u}", f"block{last}"])
        put([f"seg{u}"], "kernel", _conv_weight(sd[f"seg_outputs.{u}.weight"]))
    return params
