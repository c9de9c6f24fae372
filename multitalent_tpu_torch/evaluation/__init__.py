"""evaluation of the PyTorch/CUDA port (see multitalent_tpu_torch/__init__.py)."""
