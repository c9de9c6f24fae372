"""On-device export: inverse resample + region threshold on the GPU.

Counterpart of multitalent_tpu/ops/device_export.py. The fold-summed region
probabilities are resized trilinearly back to the post-cropping grid
(`size_after_cropping`) and thresholded at 0.5 * n_folds on the device, so
only bool masks cross to the host. `F.interpolate(mode="trilinear",
align_corners=False)` computes what `jax.image.resize(method="linear",
antialias=False)` computes (device_export.py:60-67): half-pixel centres,
two-tap linear weights, edge samples clamped, no antialiasing when an axis
shrinks.

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
