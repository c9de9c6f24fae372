"""Augmentation parameter dicts and the rotation-aware enlarged-patch computation.

Parity targets: default_3D/2D_augmentation_params
(default_data_augmentation.py:39-108), get_patch_size (:111-131), and the overrides
applied by nnUNetTrainerV2.setup_DA_params (rotation +-30deg, scale (0.7, 1.4),
elastic off, nnUNetTrainerV2.py:341-391).

The port's copy of multitalent_tpu/augment/params.py.
"""
from __future__ import annotations

import numpy as np

DEG = 2.0 * np.pi / 360.0

default_3D_augmentation_params: dict = {
    "do_elastic": False,  # nnUNetTrainerV2 disables elastic deformation
    "p_eldef": 0.2,
    "do_scaling": True,
    "scale_range": (0.7, 1.4),
    "independent_scale_factor_for_each_axis": False,
    "p_scale": 0.2,
    "do_rotation": True,
    "rotation_x": (-30.0 * DEG, 30.0 * DEG),
    "rotation_y": (-30.0 * DEG, 30.0 * DEG),
    "rotation_z": (-30.0 * DEG, 30.0 * DEG),
    "rotation_p_per_axis": 1.0,
    "p_rot": 0.2,
    "random_crop": False,
    "do_gamma": True,
    "gamma_retain_stats": True,
    "gamma_range": (0.7, 1.5),
    "p_gamma": 0.3,
    "p_gamma_invert": 0.1,
    "do_mirror": True,
    "mirror_axes": (0, 1, 2),
    "dummy_2D": False,
    "mask_was_used_for_normalization": None,
    "border_mode_data": "constant",
    # intensity chain (get_moreDA_augmentation defaults)
    "p_gaussian_noise": 0.1,
    "gaussian_noise_variance": (0.0, 0.1),
    "p_gaussian_blur": 0.2,
    "p_blur_per_channel": 0.5,
    "gaussian_blur_sigma": (0.5, 1.0),
    "p_brightness_mult": 0.15,
    "brightness_mult_range": (0.75, 1.25),
    "p_contrast": 0.15,
    "contrast_range": (0.75, 1.25),
    "p_lowres": 0.25,
    "p_lowres_per_channel": 0.5,
    "lowres_zoom_range": (0.5, 1.0),
    "order_data": 1,   # on-device warp is trilinear (reference uses cubic on CPU)
    "order_seg": 1,    # MultiTalent uses 0
    "num_threads": 3,  # host prefetch threads (replaces 12 augmentation processes)
}

default_2D_augmentation_params = dict(default_3D_augmentation_params)
default_2D_augmentation_params.update({
    "rotation_x": (-180.0 * DEG, 180.0 * DEG),
    "rotation_y": (0.0, 0.0),
    "rotation_z": (0.0, 0.0),
    "mirror_axes": (0, 1),
})


def _rot_x(v, a):
    r = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]])
    return v @ r


def _rot_y(v, a):
    r = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    return v @ r


def _rot_z(v, a):
    r = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    return v @ r


def get_patch_size(final_patch_size, rot_x, rot_y, rot_z, scale_range) -> np.ndarray:
    """Enlarged sampling-patch size such that any rotation within the given ranges plus
    the strongest zoom-in still stays inside the sampled data
    (default_data_augmentation.py:111-131)."""
    if isinstance(rot_x, (tuple, list)):
        rot_x = max(np.abs(rot_x))
    if isinstance(rot_y, (tuple, list)):
        rot_y = max(np.abs(rot_y))
    if isinstance(rot_z, (tuple, list)):
        rot_z = max(np.abs(rot_z))
    rot_x, rot_y, rot_z = (min(90 * DEG, r) for r in (rot_x, rot_y, rot_z))
    coords = np.array(final_patch_size, dtype=np.float64)
    final_shape = np.copy(coords)
    if len(coords) == 3:
        final_shape = np.max(np.vstack((np.abs(_rot_x(coords, rot_x)), final_shape)), 0)
        final_shape = np.max(np.vstack((np.abs(_rot_y(coords, rot_y)), final_shape)), 0)
        final_shape = np.max(np.vstack((np.abs(_rot_z(coords, rot_z)), final_shape)), 0)
    elif len(coords) == 2:
        final_shape = np.max(np.vstack((np.abs(_rot_z(np.array([*coords, 0.0]), rot_x)[:2]),
                                        final_shape)), 0)
    final_shape /= min(scale_range)
    return final_shape.astype(int)
