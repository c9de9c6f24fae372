"""Axis-code reorientation to RAS.

The port's copy of multitalent_tpu/utils/reorientation.py.

Parity target: nnunet/utilities/image_reorientation.py (reorient_all_images_in_
folder_to_ras via nibabel's as_closest_canonical). Implemented on our own codec:
derive the axis permutation/flips that bring the direction matrix closest to
identity in RAS space, apply them to the voxel array, and update the geometry.
"""
from __future__ import annotations

import os

import numpy as np

from multitalent_tpu_torch.io.nifti import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.utils.fileops import subfiles

_LPS_FROM_RAS = np.diag([-1.0, -1.0, 1.0])


def reorient_to_ras(array_zyx: np.ndarray, geom: Geometry):
    """Returns (array', geom') such that the voxel axes align with RAS as closely
    as possible (axis-aligned rotations/flips only, like as_closest_canonical)."""
    affine_lps = geom.affine_lps()
    affine_ras = _LPS_FROM_RAS @ affine_lps[:3, :3]
    # ITK fastest-varying is x: affine columns map (i=x, j=y, k=z_index)
    # array axes are (z, y, x) = index (k, j, i)
    # For each world axis find the dominating voxel axis and its sign.
    perm = np.argmax(np.abs(affine_ras), axis=1)  # world axis -> voxel(i,j,k)
    assert len(set(perm.tolist())) == 3, "degenerate direction matrix"
    signs = np.sign(affine_ras[np.arange(3), perm])

    # build the new array: output world order (R, A, S) = (x', y', z') with the
    # array stored (z', y', x')
    arr_axes_for_world = [2 - p for p in perm]  # voxel i->array axis 2, j->1, k->0
    out = array_zyx
    # first flip axes with negative orientation
    for world_ax in range(3):
        if signs[world_ax] < 0:
            out = np.flip(out, axis=arr_axes_for_world[world_ax])
    # then permute array axes: target order is (z'=S, y'=A, x'=R)
    out = np.transpose(out, (arr_axes_for_world[2], arr_axes_for_world[1],
                             arr_axes_for_world[0]))

    spacing = np.asarray(geom.spacing)  # (x, y, z) voxel order
    new_spacing = tuple(float(spacing[perm[w]]) for w in range(3))
    # new direction is identity in RAS = diag(-1,-1,1) in LPS
    origin_world = affine_lps[:3, 3]
    new_geom = Geometry(spacing=new_spacing, origin=tuple(origin_world),
                        direction=tuple(np.diag([-1.0, -1.0, 1.0]).reshape(-1)))
    return np.ascontiguousarray(out), new_geom


def reorient_file_to_ras(path: str) -> None:
    """In-place closest-canonical (RAS) reorientation of one NIfTI (the
    nibabel as_closest_canonical pass of Task062_NIHPancreas.py:25-28)."""
    arr, geom = read_nifti(path)
    out, new_geom = reorient_to_ras(arr, geom)
    write_nifti(path, out, new_geom)


def reorient_all_images_in_folder_to_ras(folder: str, processes: int = 4) -> None:
    for f in subfiles(folder, suffix=".nii.gz"):
        arr, geom = read_nifti(f)
        out, new_geom = reorient_to_ras(arr, geom)
        write_nifti(f, out, new_geom)
        print(f"reoriented {os.path.basename(f)}")
