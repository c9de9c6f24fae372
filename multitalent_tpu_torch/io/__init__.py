"""The artifacts the port reads and writes: NIfTI volumes and plans files.

Both codecs are the JAX package's framework-neutral modules, imported here
unchanged (they load no JAX); `from_jax` is the port's weight bridge.
"""
from multitalent_tpu.io.nifti import Geometry, read_nifti, write_nifti
from multitalent_tpu.plans import Plans, load_plans, save_plans

__all__ = ["Geometry", "Plans", "load_plans", "read_nifti", "save_plans", "write_nifti"]
