"""The artifacts the port reads and writes: NIfTI volumes and plans files.

Both codecs are the port's copies of the JAX package's (io/nifti.py,
plans.py); `torch_convert` reads the reference's torch checkpoints and turns
a state dict into the JAX package's flax tree, `from_jax` is the way back,
and `flax_ckpt` reads and writes the JAX package's flax checkpoints.
"""
from multitalent_tpu_torch.io.nifti import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.plans import Plans, load_plans, save_plans

__all__ = ["Geometry", "Plans", "load_plans", "read_nifti", "save_plans", "write_nifti"]
