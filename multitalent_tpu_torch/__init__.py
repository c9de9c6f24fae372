"""multitalent_tpu_torch: the PyTorch/CUDA port of multitalent_tpu for NVIDIA Hopper.

The JAX package `multitalent_tpu` is the reference this package is held
against. The port mirrors its module names (`models/`, `ops/`, `inference/`,
`cli/`, `io/`), imports its framework-neutral modules (plans, preprocessing,
NIfTI I/O, segmentation export, the MultiTalent region table) instead of
copying them, and never imports `jax` or `flax`. Every Pallas kernel on the
ported path has a hand-written CUDA counterpart under `csrc/`, built with nvcc
at first use (`_build.py`).
"""
