"""The probe harnesses of scripts/ on the H100, one module per script.

Each module holds hand-written CUDA kernels (csrc/conv_arms.cu,
csrc/probe_kernels.cu, and kernel A's packed form in csrc/conv3d_same.cu)
with their plain PyTorch versions and a `main()` that runs as `python -m multitalent_tpu_torch.probes.<name>`,
on the card unless `--device cpu` is passed:

- `conv_impl_arms`: the SAME 3x3x3 conv by arm (tap, sum, im2col, tap3, wino);
- `sparse_conv_arm`: the conv of a space-to-depth packed tensor;
- `conv_cost_isolate`: the center-view conv cost probe and its yardsticks;
- `grid_overhead_probe`: per-block cost at fixed work (zero fill, center view).
"""
