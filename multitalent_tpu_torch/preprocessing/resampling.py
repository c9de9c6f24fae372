"""Anisotropy-aware spline resampling.

Behavioral parity target: nnunet/preprocessing/preprocessing.py:28-197
(`resample_patient` / `resample_data_or_seg`), which uses skimage.transform.resize
(cubic B-spline, pixel-center alignment, edge padding, clip-to-input-range) in-plane and
scipy map_coordinates along a highly anisotropic axis.

Implementation is different from the reference: grid resampling with tensor-product
B-splines is *separable*, so instead of per-slice Python loops we build one sparse-ish
1D interpolation matrix per axis (derived from scipy's own spline machinery, so
numerics match map_coordinates exactly) and contract them along each axis with BLAS.
This is 1-2 orders of magnitude faster on large CT volumes and bit-compatible.

The port's copy of multitalent_tpu/preprocessing/resampling.py.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
from scipy import ndimage

from multitalent_tpu_torch.paths import RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD


def _resize_coords(old_size: int, new_size: int) -> np.ndarray:
    """Pixel-center coordinate mapping used by skimage.transform.resize:
    output index i samples input coordinate (i + 0.5) * old/new - 0.5."""
    scale = old_size / new_size
    return (np.arange(new_size, dtype=np.float64) + 0.5) * scale - 0.5


@lru_cache(maxsize=256)
def _interp_matrix(old_size: int, new_size: int, order: int) -> np.ndarray:
    """(new_size, old_size) matrix W s.t. W @ v == 1D spline resize of v.

    Built by pushing the identity basis through scipy's map_coordinates with
    mode='nearest' (skimage 'edge'), guaranteeing identical numerics to the
    reference's interpolation including the spline prefilter and boundary handling.
    """
    coords = _resize_coords(old_size, new_size)[None]  # (1, new)
    eye = np.eye(old_size, dtype=np.float64)
    w = np.empty((new_size, old_size), dtype=np.float64)
    for j in range(old_size):
        w[:, j] = ndimage.map_coordinates(eye[j], coords, order=order, mode="nearest")
    return w


def _resize_nd(vol: np.ndarray, new_shape, order: int, clip: bool = True) -> np.ndarray:
    """Tensor-product spline resize of a 3D (or 2D) volume on a regular grid."""
    vol = np.asarray(vol, dtype=np.float64)
    out = vol
    for ax, (old, new) in enumerate(zip(vol.shape, new_shape)):
        if old == new:
            continue
        w = _interp_matrix(old, int(new), order)
        out = np.moveaxis(np.tensordot(w, np.moveaxis(out, ax, 0), axes=(1, 0)), 0, ax)
    if clip and order > 1:
        out = np.clip(out, vol.min(), vol.max())
    return out


def _resize_lowres_axis(vol: np.ndarray, axis: int, new_size: int, order_z: int) -> np.ndarray:
    """Resample a single (anisotropic) axis with a low interpolation order."""
    old = vol.shape[axis]
    if old == new_size:
        return vol
    w = _interp_matrix(old, new_size, order_z)
    return np.moveaxis(np.tensordot(w, np.moveaxis(np.asarray(vol, np.float64), axis, 0),
                                    axes=(1, 0)), 0, axis)


def resize_image(image: np.ndarray, new_shape, order: int = 3) -> np.ndarray:
    """Spline-resize a single 3D image (skimage.resize semantics: edge mode,
    no anti-aliasing, clip to input range)."""
    return _resize_nd(image, new_shape, order)


def resize_segmentation(segmentation: np.ndarray, new_shape, order: int = 3) -> np.ndarray:
    """Resize a label map. order==0: plain nearest resize. order>0: resize each label's
    indicator with splines and stamp labels (ascending) where the resized indicator
    >= 0.5 (parity with batchgenerators' resize_segmentation used by the reference)."""
    tpe = segmentation.dtype
    if order == 0:
        return _resize_nd(segmentation.astype(np.float64), new_shape, 0).astype(tpe)
    unique_labels = np.unique(segmentation)
    reshaped = np.zeros(tuple(int(s) for s in new_shape), dtype=tpe)
    for c in unique_labels:
        mask = (segmentation == c).astype(np.float64)
        resized = _resize_nd(mask, new_shape, order)
        reshaped[resized >= 0.5] = c
    return reshaped


def get_do_separate_z(spacing, threshold=RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD) -> bool:
    spacing = np.asarray(spacing, dtype=np.float64)
    return bool((np.max(spacing) / np.min(spacing)) > threshold)


def get_lowres_axis(spacing) -> np.ndarray:
    spacing = np.asarray(spacing, dtype=np.float64)
    return np.where(max(spacing) / spacing == 1)[0]


def resample_data_or_seg(data: np.ndarray, new_shape, is_seg: bool, axis=None, order: int = 3,
                         do_separate_z: bool = False, order_z: int = 0) -> np.ndarray:
    """Resample (C, Z, Y, X) data or seg to new spatial shape.

    If `do_separate_z`, the in-plane axes are spline-resampled at `order` while the
    anisotropic `axis` is resampled at `order_z` (typically 0/nearest) — matching
    resample_data_or_seg (preprocessing.py:109-197). With the separable formulation
    this is simply: resize the two in-plane axes at `order`, then the lowres axis at
    `order_z`; for segmentations the per-label indicator trick wraps both steps.
    """
    assert data.ndim == 4, "data must be (c, z, y, x)"
    dtype_data = data.dtype
    shape = np.array(data.shape[1:])
    new_shape = np.array([int(s) for s in new_shape])
    if np.all(shape == new_shape):
        return data

    if do_separate_z:
        assert axis is not None and len(axis) == 1, "only one anisotropic axis supported"
        ax = int(axis[0])
    else:
        ax = None

    def _resize_one(vol: np.ndarray, quantize: bool = True) -> np.ndarray:
        if ax is None:
            return _resize_nd(vol, new_shape, order)
        inplane_shape = list(new_shape)
        inplane_shape[ax] = vol.shape[ax]  # keep lowres axis, resize in-plane first
        out = _resize_nd(vol, inplane_shape, order, clip=False)
        inplane_changed = list(inplane_shape) != list(vol.shape)
        if order > 1 and inplane_changed:
            # the reference resizes in-plane SLICE BY SLICE with skimage's
            # clip=True, i.e. each slice clips to its OWN range — not the 3-D
            # volume's (preprocessing.py:147-152; measured 2.9% rel max diff
            # on an upsampled-in-plane case when clipping volume-wide). The
            # lowres axis is untouched at this point, so slice i of the
            # output only draws on slice i of the input and the per-slice
            # bounds apply exactly.
            v = np.moveaxis(np.asarray(vol, np.float64), ax, 0)
            red = tuple(range(1, v.ndim))
            lo, hi = v.min(axis=red), v.max(axis=red)
            shp = [1] * out.ndim
            shp[ax] = out.shape[ax]
            out = np.clip(out, lo.reshape(shp), hi.reshape(shp))
        if quantize and inplane_changed:
            # The reference also casts each in-plane-resized slice to the data
            # dtype (float32) before the z-pass, for every order
            # (preprocessing.py:147-155); reproduce the quantization — but only
            # on the DATA path: the seg path here resizes float per-label
            # INDICATORS in [0, 1), and casting those to an integer seg dtype
            # would truncate them to 0 before the >=0.5 stamp (the reference
            # casts the already-stamped label map, never an indicator).
            out = out.astype(dtype_data, copy=False).astype(np.float64)
        return _resize_lowres_axis(out, ax, int(new_shape[ax]), order_z)

    out_channels = []
    for c in range(data.shape[0]):
        if is_seg:
            if order == 0 and (ax is None or order_z == 0):
                out_channels.append(np.rint(_resize_one(data[c].astype(np.float64))))
            else:
                unique_labels = np.unique(data[c])
                reshaped = np.zeros(tuple(int(s) for s in new_shape), dtype=np.float64)
                for cl in unique_labels:
                    ind = _resize_one((data[c] == cl).astype(np.float64), quantize=False)
                    reshaped[ind >= 0.5] = cl
                out_channels.append(reshaped)
        else:
            out_channels.append(_resize_one(data[c]))
    return np.stack(out_channels).astype(dtype_data)


def resample_patient(data, seg, original_spacing, target_spacing, order_data: int = 3,
                     order_seg: int = 0, force_separate_z=False, order_z_data: int = 0,
                     order_z_seg: int = 0,
                     separate_z_anisotropy_threshold=RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD):
    """Resample a (C, Z, Y, X) image/seg pair from original to target spacing
    (parity: preprocessing.py:38-106, including the separate-z decision logic)."""
    assert data is not None or seg is not None
    if data is not None:
        assert data.ndim == 4
        shape = np.array(data[0].shape)
    else:
        assert seg.ndim == 4
        shape = np.array(seg[0].shape)

    original_spacing = np.asarray(original_spacing, dtype=np.float64)
    target_spacing = np.asarray(target_spacing, dtype=np.float64)
    new_shape = np.round((original_spacing / target_spacing).astype(float) * shape).astype(int)

    if force_separate_z is not None:
        do_separate_z = bool(force_separate_z)
        axis = get_lowres_axis(original_spacing) if force_separate_z else None
    else:
        if get_do_separate_z(original_spacing, separate_z_anisotropy_threshold):
            do_separate_z = True
            axis = get_lowres_axis(original_spacing)
        elif get_do_separate_z(target_spacing, separate_z_anisotropy_threshold):
            do_separate_z = True
            axis = get_lowres_axis(target_spacing)
        else:
            do_separate_z = False
            axis = None

    if axis is not None and len(axis) != 1:
        # 2 or 3 axes tie for the coarsest spacing (e.g. (0.24, 1.25, 1.25)):
        # no meaningful out-of-plane axis, resample isotropically.
        do_separate_z = False
        axis = None

    data_out = (resample_data_or_seg(data, new_shape, False, axis, order_data, do_separate_z,
                                     order_z=order_z_data) if data is not None else None)
    seg_out = (resample_data_or_seg(seg, new_shape, True, axis, order_seg, do_separate_z,
                                    order_z=order_z_seg) if seg is not None else None)
    return data_out, seg_out
