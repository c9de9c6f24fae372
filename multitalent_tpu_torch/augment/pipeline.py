"""The augmentation pipeline of a training step, on the card.

Counterpart of multitalent_tpu/augment/pipeline.py (`ds_scales_from_pools`
:25, `make_augment_fn` :33-110, `make_val_transform_fn` :231-254), with the
same transform order and parameter keys (the moreDA chain,
data_augmentation_moreDA.py:41-209):

  spatial (rotation / scaling / center crop) -> noise -> blur ->
  multiplicative brightness -> [additive brightness] -> contrast ->
  low resolution -> inverted gamma -> gamma -> mirror -> zero outside the
  nonzero mask (when normalisation used it) -> seg -1 -> 0 -> DS targets

Input is the host sampler's (B, C, Z', Y', X') float32 batch already on the
device; the output data is (B, C, Z, Y, X) float32 and the targets one
(B, z, y, x) float32 label map per deep-supervision level.
"""
from __future__ import annotations

import numpy as np
import torch

from multitalent_tpu_torch.augment import intensity as I
from multitalent_tpu_torch.augment import spatial as S


def ds_scales_from_pools(pool_op_kernel_sizes) -> list[list[float]]:
    """Deep-supervision target scales: identity plus the cumulative inverse
    pool strides, the deepest level dropped (nnUNetTrainerV2.setup_DA_params)."""
    cum = np.cumprod(np.vstack(pool_op_kernel_sizes), axis=0)
    return [[1.0] * cum.shape[1]] + (1.0 / cum).tolist()[:-1]


def _uses_mask(params: dict) -> bool:
    mask_norm = params.get("mask_was_used_for_normalization")
    return bool(mask_norm) and any(bool(v) for v in dict(mask_norm).values())


def make_augment_fn(final_patch_size, ds_scales, params: dict, num_modalities: int = 1):
    """augment(data_bc, seg_b1, generator) -> (data (B, C, Z, Y, X), [targets]).
    3D patches only (the 2D pipeline is ROADMAP queue 1, item 10)."""
    final_shape = tuple(int(s) for s in final_patch_size)
    if len(final_shape) != 3:
        raise NotImplementedError("the port augments 3D patches only (2D: ROADMAP "
                                  "queue 1, item 10)")
    p = params
    ds_scales = [tuple(s) for s in ds_scales]
    gamma_range = tuple(p.get("gamma_range", (0.7, 1.5)))

    def augment(data_bc: torch.Tensor, seg_b1: torch.Tensor, generator: torch.Generator):
        data = data_bc.float()
        seg = seg_b1[:, 0].float()
        data, seg = S.spatial_augment(
            data, seg, final_shape, generator=generator,
            scale_range=tuple(p["scale_range"]), rot_x=tuple(p["rotation_x"]),
            rot_y=tuple(p["rotation_y"]), rot_z=tuple(p["rotation_z"]),
            p_rot=p.get("p_rot", 0.2), p_scale=p.get("p_scale", 0.2),
            order_seg=int(p.get("order_seg", 1)), dummy_2d=bool(p.get("dummy_2D", False)),
            rot_p_per_axis=float(p.get("rotation_p_per_axis", 1.0)),
            independent_scale=bool(p.get("independent_scale_factor_for_each_axis", False)))
        data = I.gaussian_noise(data, generator=generator, p=p.get("p_gaussian_noise", 0.1),
                                variance=tuple(p.get("gaussian_noise_variance", (0, 0.1))))
        data = I.gaussian_blur(data, generator=generator, p=p.get("p_gaussian_blur", 0.2),
                               p_per_channel=p.get("p_blur_per_channel", 0.5),
                               sigma_range=tuple(p.get("gaussian_blur_sigma", (0.5, 1.0))))
        data = I.brightness_multiplicative(
            data, generator=generator, p=p.get("p_brightness_mult", 0.15),
            mult_range=tuple(p.get("brightness_mult_range", (0.75, 1.25))))
        if p.get("do_additive_brightness", False):
            data = I.brightness_additive(
                data, generator=generator,
                p=p.get("additive_brightness_p_per_sample", 0.15),
                mu=p.get("additive_brightness_mu", 0.0),
                sigma=p.get("additive_brightness_sigma", 0.1))
        data = I.contrast_augmentation(
            data, generator=generator, p=p.get("p_contrast", 0.15),
            contrast_range=tuple(p.get("contrast_range", (0.75, 1.25))))
        data = I.simulate_low_resolution(
            data, generator=generator, p=p.get("p_lowres", 0.25),
            p_per_channel=p.get("p_lowres_per_channel", 0.5),
            zoom_range=tuple(p.get("lowres_zoom_range", (0.5, 1.0))))
        if p.get("do_gamma", True):
            data = I.gamma_augmentation(data, generator=generator,
                                        p=p.get("p_gamma_invert", 0.1),
                                        gamma_range=gamma_range, invert=True)
            data = I.gamma_augmentation(data, generator=generator, p=p.get("p_gamma", 0.3),
                                        gamma_range=gamma_range, invert=False)
        if bool(p.get("do_mirror", True)):
            data, seg = S.mirror_augment(data, seg, generator=generator,
                                         mirror_axes=tuple(p.get("mirror_axes", (0, 1, 2))))
        return _finish(data, seg, ds_scales, _uses_mask(p))

    return augment


def _finish(data, seg, ds_scales, use_mask: bool):
    if use_mask:  # MaskTransform: zero the image outside the nonzero mask
        data = torch.where((seg == -1)[:, None], torch.zeros_like(data), data)
    seg = torch.where(seg == -1, torch.zeros_like(seg), seg)  # RemoveLabelTransform
    return data, S.downsample_seg_for_ds(seg, ds_scales)


def make_val_transform_fn(final_patch_size, ds_scales, params: dict,
                          num_modalities: int = 1):
    """transform(data_bc, seg_b1) -> (data, [targets]): the validation path,
    a center crop and the label clean-up, nothing random."""
    final_shape = tuple(int(s) for s in final_patch_size)
    ds_scales = [tuple(s) for s in ds_scales]
    use_mask = _uses_mask(params)

    def transform(data_bc: torch.Tensor, seg_b1: torch.Tensor):
        data, seg = S.center_crop(data_bc.float(), seg_b1[:, 0].float(), final_shape)
        return _finish(data, seg, ds_scales, use_mask)

    return transform
