"""multitalent_tpu_torch: the PyTorch/CUDA port of multitalent_tpu for NVIDIA Hopper.

The JAX package `multitalent_tpu` is the reference this package is held
against. The port mirrors its module names (`models/`, `ops/`, `inference/`,
`cli/`, `io/`, ...) and imports nothing of it: the framework-neutral modules
it needs (paths, plans, preprocessing, NIfTI I/O, segmentation export, data
loading, the MultiTalent region table, the trainer base) are copies of its
own under the same names, and it never imports `jax` or `flax`. Every Pallas
kernel of the JAX package has a hand-written CUDA counterpart under `csrc/`,
built with nvcc at first use (`_build.py`); the probe harnesses of
`scripts/` have theirs under `probes/`.
"""
