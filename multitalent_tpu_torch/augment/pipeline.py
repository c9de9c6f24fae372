"""The augmentation pipeline of a training step, on the card.

Counterpart of multitalent_tpu/augment/pipeline.py (`ds_scales_from_pools`
:25, `make_augment_fn` :33-110, `make_val_transform_fn` :231-254, and the
cascade's `make_cascade_augment_fn` :113-177 with its random binary
morphology :180-204 and `make_cascade_val_transform_fn` :207-226), with the
same transform order and parameter keys (the moreDA chain,
data_augmentation_moreDA.py:41-209):

  spatial (rotation / scaling / center crop) -> noise -> blur ->
  multiplicative brightness -> [additive brightness] -> contrast ->
  low resolution -> inverted gamma -> gamma -> mirror -> zero outside the
  nonzero mask (when normalisation used it) -> seg -1 -> 0 -> DS targets

Input is the host sampler's (B, C, Z', Y', X') float32 batch already on the
device; the output data is (B, C, Z, Y, X) float32 and the targets one
(B, z, y, x) float32 label map per deep-supervision level. A 2D patch (B, C,
Y', X') takes the 2D chain (pipeline.py:43-66): spatial_augment_2d (one
in-plane angle from rotation_x's range), the same intensity chain, mirroring
over the params' mirror axes ((0, 1) in the 2D defaults).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

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


def _spatial_fn(final_shape, p: dict):
    """spatial(data, seg, generator): the moreDA chain's spatial transform
    (rotation, scaling, center crop) of every channel of data and of seg."""
    def spatial(data: torch.Tensor, seg: torch.Tensor, generator: torch.Generator):
        if len(final_shape) == 2:
            return S.spatial_augment_2d(
                data, seg, final_shape, generator=generator,
                scale_range=tuple(p["scale_range"]), rot=tuple(p["rotation_x"]),
                p_rot=p.get("p_rot", 0.2), p_scale=p.get("p_scale", 0.2),
                order_seg=int(p.get("order_seg", 1)))
        return S.spatial_augment(
            data, seg, final_shape, generator=generator,
            scale_range=tuple(p["scale_range"]), rot_x=tuple(p["rotation_x"]),
            rot_y=tuple(p["rotation_y"]), rot_z=tuple(p["rotation_z"]),
            p_rot=p.get("p_rot", 0.2), p_scale=p.get("p_scale", 0.2),
            order_seg=int(p.get("order_seg", 1)), dummy_2d=bool(p.get("dummy_2D", False)),
            rot_p_per_axis=float(p.get("rotation_p_per_axis", 1.0)),
            independent_scale=bool(p.get("independent_scale_factor_for_each_axis", False)))

    return spatial


def _intensity_fn(p: dict):
    """intensity(data, generator): noise -> blur -> multiplicative
    brightness -> [additive brightness] -> contrast -> low resolution ->
    inverted gamma -> gamma."""
    gamma_range = tuple(p.get("gamma_range", (0.7, 1.5)))

    def intensity(data: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
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
        return data

    return intensity


def _final_shape(final_patch_size) -> tuple[int, ...]:
    final_shape = tuple(int(s) for s in final_patch_size)
    if len(final_shape) not in (2, 3):
        raise ValueError(f"patch {final_shape}: 2D or 3D only")
    return final_shape


def make_augment_fn(final_patch_size, ds_scales, params: dict, num_modalities: int = 1):
    """augment(data_bc, seg_b1, generator) -> (data (B, C, Z, Y, X), [targets]),
    or in 2D (B, C, Y, X)."""
    p = params
    ds_scales = [tuple(s) for s in ds_scales]
    spatial, intensity = _spatial_fn(_final_shape(final_patch_size), p), _intensity_fn(p)

    def augment(data_bc: torch.Tensor, seg_b1: torch.Tensor, generator: torch.Generator):
        data, seg = spatial(data_bc.float(), seg_b1[:, 0].float(), generator)
        data = intensity(data, generator)
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


def binary_morphology(onehot: torch.Tensor, do: torch.Tensor, dilate: torch.Tensor,
                      size: int) -> torch.Tensor:
    """onehot (B, C, Z, Y, X) of 0 and 1; where do[b, c], its channel dilated
    (dilate[b, c]) or eroded by a cube of `size`, as reduce_window(max or
    min, "SAME") computes it: size - 1 voxels of -inf (dilation) or +inf
    (erosion) padding an axis, (size - 1) // 2 before and the rest after, so
    an even cube is off-centre by one voxel toward the end."""
    lo = (size - 1) // 2
    pad = (lo, size - 1 - lo) * 3

    def max_pool(x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(F.pad(x, pad, value=float("-inf")), size, stride=1)

    dilated = max_pool(onehot)
    eroded = -max_pool(-onehot)
    view = do.shape + (1,) * (onehot.dim() - 2)
    return torch.where(do.view(view), torch.where(dilate.view(view), dilated, eroded), onehot)


def random_binary_morphology(onehot: torch.Tensor, generator: torch.Generator,
                             p_per_sample: float = 0.4, size: int = 3,
                             p_per_label: float = 1.0) -> torch.Tensor:
    """The JAX package's S_random_binary_morphology (pipeline.py:180-204,
    ApplyRandomBinaryOperatorTransform's two gates): per sample a draw
    against p_per_sample, per (sample, channel) one against p_per_label, then
    dilation or erosion with p 0.5 each; `size` is the structuring
    element's, fixed (the JAX package passes the midpoint of the reference's
    range)."""
    b, c = onehot.shape[:2]
    dev = generator.device
    do_sample = torch.rand(b, 1, generator=generator, device=dev) < p_per_sample
    do_label = torch.rand(b, c, generator=generator, device=dev) < p_per_label
    dilate = torch.rand(b, c, generator=generator, device=dev) < 0.5
    return binary_morphology(onehot, (do_sample & do_label).to(onehot.device),
                             dilate.to(onehot.device), size)


def _prev_one_hot(prev: torch.Tensor, num_prev_classes: int) -> torch.Tensor:
    """(B, Z, Y, X) previous-stage labels -> (B, num_prev_classes, Z, Y, X)
    float one-hots of the foreground classes (a label out of 1..n gives
    zeros, as jax.nn.one_hot)."""
    return torch.stack([prev == c for c in range(1, num_prev_classes + 1)], 1).float()


def make_cascade_augment_fn(final_patch_size, ds_scales, params: dict, num_modalities: int,
                            num_prev_classes: int):
    """augment(data_bc, seg_b2, generator) -> (data (B, C + num_prev_classes,
    Z, Y, X), [targets]) for the cascade's full-resolution stage (the JAX
    package's make_cascade_augment_fn, pipeline.py:113-177); seg_b2 holds the
    ground truth and the previous stage's labels. The previous stage's
    one-hots take the image's spatial transform (one warp of the image and
    one-hot channels together, trilinear, then thresholded at 0.5); the
    intensity chain touches the image channels only; the nonzero-mask and
    label clean-up follow; then the one-hots' random dilation or erosion
    (cascade_random_binary_transform_p, _p_per_label, and the midpoint of
    _size rounded half to even as Python rounds); then one mirror of image,
    one-hots and labels together; the DS targets last."""
    p = params
    ds_scales = [tuple(s) for s in ds_scales]
    spatial, intensity = _spatial_fn(_final_shape(final_patch_size), p), _intensity_fn(p)
    p_binary = float(p.get("cascade_random_binary_transform_p", 0.4))
    p_binary_label = float(p.get("cascade_random_binary_transform_p_per_label", 1.0))
    strel_range = tuple(p.get("cascade_random_binary_transform_size", (1, 8)))
    strel_size = max(1, int(round(sum(strel_range) / 2.0)))

    def augment(data_bc: torch.Tensor, seg_b2: torch.Tensor, generator: torch.Generator):
        c = data_bc.shape[1]
        both = torch.cat([data_bc.float(), _prev_one_hot(seg_b2[:, 1], num_prev_classes)], 1)
        both, seg = spatial(both, seg_b2[:, 0].float(), generator)
        data = intensity(both[:, :c], generator)
        if _uses_mask(p):
            data = torch.where((seg == -1)[:, None], torch.zeros_like(data), data)
        seg = torch.where(seg == -1, torch.zeros_like(seg), seg)
        prev = random_binary_morphology((both[:, c:] > 0.5).float(), generator, p_binary,
                                        strel_size, p_binary_label)
        full = torch.cat([data, prev], 1)
        if bool(p.get("do_mirror", True)):
            full, seg = S.mirror_augment(full, seg, generator=generator,
                                         mirror_axes=tuple(p.get("mirror_axes", (0, 1, 2))))
        return full, S.downsample_seg_for_ds(seg, ds_scales)

    return augment


def make_cascade_val_transform_fn(final_patch_size, ds_scales, params: dict,
                                  num_modalities: int, num_prev_classes: int):
    """transform(data_bc, seg_b2) -> (data with the previous stage's
    one-hots appended, [targets]): the validation path's center crop, no
    corruption (pipeline.py:207-226)."""
    base = make_val_transform_fn(final_patch_size, ds_scales, params, num_modalities)
    final_shape = tuple(int(s) for s in final_patch_size)

    def transform(data_bc: torch.Tensor, seg_b2: torch.Tensor):
        data, targets = base(data_bc, seg_b2[:, 0:1])
        _, prev = S.center_crop(seg_b2[:, 1], seg_b2[:, 1], final_shape)
        return torch.cat([data, _prev_one_hot(prev, num_prev_classes)], 1), targets

    return transform
