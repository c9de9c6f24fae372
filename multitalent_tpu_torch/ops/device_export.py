"""On-device export: inverse resample + argmax or region threshold on the GPU.

Counterpart of multitalent_tpu/ops/device_export.py. The fold-summed
probabilities are resized back to the post-cropping grid
(`size_after_cropping`) on the device, so only the final segmentation
crosses to the host:

- region (sigmoid) models: resized trilinearly and thresholded at 0.5 *
  n_folds into bool masks (`device_resample_threshold_bits`);
- softmax models: resized trilinearly channel chunk by channel chunk with a
  running argmax (`device_resample_argmax`, the normal and fast modes), or
  argmaxed on the network's grid first and the labelmap resized by nearest
  neighbour (`device_argmax_resample_nearest`, the fastest mode).

`F.interpolate(mode="trilinear", align_corners=False)` computes what
`jax.image.resize(method="linear", antialias=False)` computes
(device_export.py:60-67): half-pixel centres, two-tap linear weights, edge
samples clamped, no antialiasing when an axis shrinks. The nearest resize
takes `jax.image.resize(method="nearest")`'s indices as XLA computes them,
which neither of F.interpolate's nearest modes does (see `nearest_indices`).

Cases whose inverse resampling needs the separate-z path stay on the host
(`can_export_on_device`, copied from the JAX module, which imports jax).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multitalent_tpu_torch.preprocessing.resampling import get_do_separate_z, get_lowres_axis


def can_export_on_device(properties: dict, force_separate_z=None) -> bool:
    """True when the inverse resampling for this case is the plain full-3D
    spline path (the decision logic of segmentation_export.py:84-110); the
    separate-z anisotropic path stays on host."""
    if force_separate_z is False:
        return True
    spacing_original = np.array(properties["original_spacing"])
    spacing_after = properties.get("spacing_after_resampling")
    if force_separate_z is None:
        if get_do_separate_z(spacing_original):
            return False
        if spacing_after is not None and get_do_separate_z(np.array(spacing_after)):
            return False
        return True
    # force_separate_z is True
    axis = get_lowres_axis(spacing_original)
    return axis is not None and len(axis) != 1  # degenerate -> full 3D path


def resize_linear(probs_kzyx: torch.Tensor, out_shape) -> torch.Tensor:
    """(K, Z, Y, X) -> (K, *out_shape) fp32, trilinear with half-pixel
    centres and no antialiasing."""
    out_shape = tuple(int(s) for s in out_shape)
    if tuple(probs_kzyx.shape[1:]) == out_shape:
        return probs_kzyx.float()
    return F.interpolate(probs_kzyx[None].float(), size=out_shape, mode="trilinear",
                         align_corners=False)[0]


# channels resized at a time: bounds the fp32 resize intermediate
RESIZE_CHUNK = 8


def device_resample_threshold_bits(probs_kzyx: torch.Tensor, out_shape,
                                   threshold: float = 0.5) -> torch.Tensor:
    """probs (K, Z, Y, X) on the device -> region masks (K, *out_shape) bool
    on the device."""
    k = probs_kzyx.shape[0]
    out_shape = tuple(int(s) for s in out_shape)
    masks = torch.empty((k, *out_shape), dtype=torch.bool, device=probs_kzyx.device)
    for c0 in range(0, k, RESIZE_CHUNK):
        masks[c0:c0 + RESIZE_CHUNK] = resize_linear(
            probs_kzyx[c0:c0 + RESIZE_CHUNK], out_shape) > threshold
    return masks


def segmentation_from_regions_bits(masks_kzyx: torch.Tensor,
                                   region_class_order) -> torch.Tensor:
    """Region masks (K, Z, Y, X) bool -> float32 labelmap written in
    region_class_order (later regions overwrite earlier ones, matching
    segmentation_from_probs), on the masks' device."""
    seg = torch.zeros(masks_kzyx.shape[1:], dtype=torch.float32,
                      device=masks_kzyx.device)
    for i, cls in enumerate(region_class_order):
        seg.masked_fill_(masks_kzyx[i], float(cls))
    return seg


def device_resample_argmax(probs_kzyx: torch.Tensor, out_shape) -> torch.Tensor:
    """probs (K, Z, Y, X) on the device -> labels (*out_shape) int32 on the
    device: each chunk of RESIZE_CHUNK channels resized trilinearly, its
    argmax taken, and a running argmax kept across chunks with a strict `>`,
    so that the earliest channel wins a tie, as np.argmax (and the JAX
    package, device_export.py:69-75) decide it."""
    k = probs_kzyx.shape[0]
    out_shape = tuple(int(s) for s in out_shape)
    best_val = torch.full(out_shape, -torch.inf, dtype=torch.float32, device=probs_kzyx.device)
    best_idx = torch.zeros(out_shape, dtype=torch.int32, device=probs_kzyx.device)
    for c0 in range(0, k, RESIZE_CHUNK):
        val, idx = resize_linear(probs_kzyx[c0:c0 + RESIZE_CHUNK], out_shape).max(0)
        take = val > best_val
        best_val = torch.where(take, val, best_val)
        best_idx = torch.where(take, idx.int() + c0, best_idx)
    return best_idx


def nearest_indices(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """Source index of each of n_out samples resized from n_in by
    jax.image.resize(method="nearest"). Its source reads floor((i + 0.5) *
    n_in / n_out) in fp32 (jax/_src/image/scale.py:_resize_nearest), and
    XLA compiles the division by that constant as a product with its
    reciprocal: floor((i + 0.5) * (n_in * (1 / n_out))), each operation in
    fp32 (the CPU backend's result for every size pair tried). F.interpolate
    computes neither: "nearest" takes floor(i * n_in / n_out), and
    "nearest-exact" floor((i + 0.5) * (n_in / n_out)), which picks another
    voxel at some non-integer scales (e.g. 2 -> 41, 10 -> 47)."""
    scale = np.float32(n_in) * (np.float32(1) / np.float32(n_out))
    i = torch.arange(n_out, dtype=torch.float32, device=device)
    return torch.floor((i + 0.5) * float(scale)).long()


def device_argmax_resample_nearest(probs_kzyx: torch.Tensor, out_shape) -> torch.Tensor:
    """`predict_cases_fastest` semantics (reference predict.py:442-540;
    device_export.py:126-139): argmax on the network's grid (the earliest
    channel wins a tie), then the single int32 labelmap resized to
    out_shape by nearest neighbour, on the device."""
    seg = probs_kzyx.argmax(0).int()
    for axis, n_out in enumerate(int(s) for s in out_shape):
        if seg.shape[axis] != n_out:
            seg = seg.index_select(axis, nearest_indices(seg.shape[axis], n_out, seg.device))
    return seg
