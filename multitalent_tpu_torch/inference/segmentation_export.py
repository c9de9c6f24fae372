"""Probability-map -> original-geometry segmentation export.

Parity target: nnunet/inference/segmentation_export.py:27-159
(`save_segmentation_nifti_from_softmax`): transpose back, anisotropy-aware inverse
resampling of the class/region probabilities to the pre-resampling grid, optional
resampled-softmax npz for ensembling, region thresholding or argmax, un-crop into
the original bounding box, and NIfTI write with the original spacing/origin/
direction (via our own codec instead of SimpleITK).

The port's copy of multitalent_tpu/inference/segmentation_export.py.
"""
from __future__ import annotations

import numpy as np

from multitalent_tpu_torch.io.nifti import Geometry, write_nifti
from multitalent_tpu_torch.preprocessing.resampling import (get_do_separate_z,
                                                            get_lowres_axis,
                                                            resample_data_or_seg)
from multitalent_tpu_torch.utils.fileops import save_pickle


def resample_probabilities_to_cropped_grid(probs_kzyx: np.ndarray, properties: dict,
                                           order: int = 1,
                                           force_separate_z: bool | None = None,
                                           interpolation_order_z: int = 0) -> np.ndarray:
    """Inverse-resample class probabilities from the preprocessed grid back to the
    post-cropping grid (segmentation_export.py:84-110 decision logic)."""
    shape_original_after_cropping = np.array(properties["size_after_cropping"])
    current_shape = np.array(probs_kzyx.shape[1:])
    if np.all(current_shape == shape_original_after_cropping):
        return probs_kzyx

    spacing_after = properties.get("spacing_after_resampling")
    spacing_original = np.array(properties["original_spacing"])
    if force_separate_z is None:
        if get_do_separate_z(spacing_original):
            do_separate_z, axis = True, get_lowres_axis(spacing_original)
        elif spacing_after is not None and get_do_separate_z(spacing_after):
            do_separate_z, axis = True, get_lowres_axis(spacing_after)
        else:
            do_separate_z, axis = False, None
    else:
        do_separate_z = bool(force_separate_z)
        axis = get_lowres_axis(spacing_original) if do_separate_z else None
    if axis is not None and len(axis) != 1:
        do_separate_z, axis = False, None

    return resample_data_or_seg(probs_kzyx.astype(np.float32),
                                shape_original_after_cropping, is_seg=False,
                                axis=axis, order=order,
                                do_separate_z=do_separate_z,
                                order_z=interpolation_order_z)


def segmentation_from_probs(probs_kzyx: np.ndarray, region_class_order=None) -> np.ndarray:
    if region_class_order is None:
        return probs_kzyx.argmax(0)
    seg = np.zeros(probs_kzyx.shape[1:], dtype=np.float32)
    for i, c in enumerate(region_class_order):
        seg[probs_kzyx[i] > 0.5] = c
    return seg


def uncrop_segmentation(seg_zyx: np.ndarray, properties: dict) -> np.ndarray:
    """Place the cropped-space segmentation back into the pre-cropping volume
    (segmentation_export.py:131-141)."""
    # the reference keys the pre-crop shape as original_size_of_raw_data
    # (cropping.py:66) — properties pickles from reference-preprocessed data
    # carry only that name, so it must be read first or uncropping is
    # silently skipped (caught by the 47-region export A/B test)
    bbox = properties.get("crop_bbox")
    shape_before = properties.get("original_size_of_raw_data")
    if shape_before is None:
        shape_before = properties.get("shape_before_cropping")
    if bbox is None or shape_before is None:
        return seg_zyx
    out = np.zeros(tuple(int(s) for s in shape_before), dtype=np.float32)
    sl = tuple(slice(int(lo), int(lo) + s) for (lo, _), s in zip(bbox, seg_zyx.shape))
    out[sl] = seg_zyx
    return out


def save_segmentation_nifti_from_softmax(
        segmentation_softmax: np.ndarray, out_fname: str, properties_dict: dict,
        order: int = 1, region_class_order=None, seg_postprogess_fn=None,
        seg_postprocess_args=None, resampled_npz_fname: str | None = None,
        non_postprocessed_fname: str | None = None, force_separate_z=None,
        interpolation_order_z: int = 0, verbose: bool = False) -> None:
    """The full export chain; argument surface mirrors the reference so calling code
    ports 1:1 (segmentation_export.py:27)."""
    if verbose:
        print("force_separate_z:", force_separate_z, "interpolation order:", order)
    probs = np.asarray(segmentation_softmax)

    # transpose back to the original axis order (the preprocessed grid is
    # transpose_forward'ed; export must undo it, predict.py:222-235 analog)
    tb = properties_dict.get("transpose_backward")
    if tb is not None and list(tb) != [0, 1, 2]:
        probs = probs.transpose([0] + [int(i) + 1 for i in tb])

    probs = resample_probabilities_to_cropped_grid(
        probs, properties_dict, order=order, force_separate_z=force_separate_z,
        interpolation_order_z=interpolation_order_z)

    if resampled_npz_fname is not None:
        np.savez_compressed(resampled_npz_fname, softmax=probs.astype(np.float16))
        # the reference stores the properties next to the npz for ensembling
        save_pickle(properties_dict, resampled_npz_fname[:-4] + ".pkl")

    seg_old_spacing = segmentation_from_probs(probs, region_class_order)
    seg_old_size = uncrop_segmentation(seg_old_spacing, properties_dict)

    if seg_postprogess_fn is not None:
        seg_old_size_postprocessed = seg_postprogess_fn(
            np.copy(seg_old_size), *(seg_postprocess_args or ()))
    else:
        seg_old_size_postprocessed = seg_old_size

    geom = geometry_from_properties(properties_dict)
    write_nifti(out_fname, seg_old_size_postprocessed.astype(np.uint8), geom)
    if non_postprocessed_fname is not None and seg_postprogess_fn is not None:
        write_nifti(non_postprocessed_fname, seg_old_size.astype(np.uint8), geom)


def save_segmentation_nifti(segmentation: np.ndarray, out_fname: str,
                            properties_dict: dict, order: int = 0,
                            force_separate_z=None, order_z: int = 0) -> None:
    """Fast path for already-discrete segmentations (segmentation_export.py:162):
    nearest/label-aware resize back, un-crop, write."""
    seg = np.asarray(segmentation)[None].astype(np.float32)
    shape_after_crop = np.array(properties_dict["size_after_cropping"])
    if not np.all(np.array(seg.shape[1:]) == shape_after_crop):
        spacing_original = np.array(properties_dict["original_spacing"])
        if force_separate_z is None:
            do_sep = get_do_separate_z(spacing_original)
            axis = get_lowres_axis(spacing_original) if do_sep else None
        else:
            do_sep = bool(force_separate_z)
            axis = get_lowres_axis(spacing_original) if do_sep else None
        if axis is not None and len(axis) != 1:
            do_sep, axis = False, None
        seg = resample_data_or_seg(seg, shape_after_crop, is_seg=True, axis=axis,
                                   order=order, do_separate_z=do_sep, order_z=order_z)
    seg_final = uncrop_segmentation(seg[0], properties_dict)
    write_nifti(out_fname, seg_final.astype(np.uint8),
                geometry_from_properties(properties_dict))


def geometry_from_properties(properties_dict: dict) -> Geometry | None:
    spacing = properties_dict.get("itk_spacing")
    if spacing is None:
        return None
    return Geometry(spacing=tuple(properties_dict["itk_spacing"]),
                    origin=tuple(properties_dict["itk_origin"]),
                    direction=tuple(properties_dict["itk_direction"]))
