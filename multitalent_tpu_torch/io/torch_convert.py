"""Reading the reference's torch checkpoints.

The port's copy of the two functions of multitalent_tpu/io/torch_convert.py
that inference/model_restore.py uses; the flax conversions stay in the JAX
package.
"""
from __future__ import annotations


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
