"""Crop-to-nonzero and case loading.

Behavioral parity target: nnunet/preprocessing/cropping.py:23-216. Cases are lists of
per-modality NIfTI files (`<case>_0000.nii.gz`, ...) plus an optional segmentation; we
load via our own NIfTI codec (the reference uses SimpleITK), crop all channels to the
union-of-nonzero bounding box (holes filled), and write the background marker -1 into
the segmentation outside the nonzero mask. Output artifact contract is identical:
`<case>.npz` with key 'data' = stacked (data..., seg) float32 plus `<case>.pkl`
properties.

The port's copy of multitalent_tpu/preprocessing/cropping.py.
"""
from __future__ import annotations

import os
import shutil
import traceback
from pathlib import Path

import numpy as np
from scipy.ndimage import binary_fill_holes

from multitalent_tpu_torch.io.nifti import read_nifti
from multitalent_tpu_torch.utils.fileops import process_pool
from multitalent_tpu_torch.utils import load_pickle, maybe_mkdir, save_pickle, subfiles


def create_nonzero_mask(data: np.ndarray) -> np.ndarray:
    assert data.ndim in (3, 4), "data must be (C, Z, Y, X) or (C, Z, Y)"
    nonzero_mask = np.any(data != 0, axis=0)
    return binary_fill_holes(nonzero_mask)


def get_bbox_from_mask(mask: np.ndarray, outside_value=0) -> list[list[int]]:
    coords = np.where(mask != outside_value)
    return [[int(c.min()), int(c.max()) + 1] for c in coords]


def bbox_slices(bbox) -> tuple[slice, ...]:
    return tuple(slice(lo, hi) for lo, hi in bbox)


def crop_to_bbox(image: np.ndarray, bbox) -> np.ndarray:
    assert image.ndim == len(bbox)
    return image[bbox_slices(bbox)]


def crop_to_nonzero(data: np.ndarray, seg: np.ndarray | None = None, nonzero_label=-1):
    """Crop data (C,Z,Y,X) and seg to the nonzero bbox; outside-brain/body background
    in the seg (where seg==0 and mask==0) becomes `nonzero_label`."""
    nonzero_mask = create_nonzero_mask(data)
    bbox = get_bbox_from_mask(nonzero_mask, 0)

    sl = (slice(None),) + bbox_slices(bbox)
    data = data[sl]
    if seg is not None:
        seg = seg[sl]
    nonzero_mask = nonzero_mask[bbox_slices(bbox)][None]
    if seg is not None:
        seg = seg.copy()
        seg[(seg == 0) & (~nonzero_mask)] = nonzero_label
    else:
        seg = np.where(nonzero_mask, 0, nonzero_label).astype(np.int8)
    return data, seg, bbox


def get_case_identifier(case: list[str]) -> str:
    return Path(case[0]).name.split(".nii.gz")[0][:-5]


def get_case_identifier_from_npz(path: str) -> str:
    return Path(path).name[:-4]


def load_case_from_list_of_files(data_files, seg_file=None):
    """Load modalities + seg, return float32 (C,Z,Y,X) arrays and the properties dict
    (same keys as the reference so downstream pickles interoperate)."""
    assert isinstance(data_files, (list, tuple)), "case must be a list/tuple of files"
    images, geoms = [], []
    for f in data_files:
        arr, geom = read_nifti(f)
        images.append(arr.astype(np.float32))
        geoms.append(geom)
    g = geoms[0]
    properties = {
        # index order (z, y, x); ITK spacing is (x, y, z) hence the reversal
        "original_size_of_raw_data": np.array(images[0].shape),
        "original_spacing": np.array(g.spacing[::-1]),
        "list_of_data_files": list(data_files),
        "seg_file": seg_file,
        "itk_origin": tuple(g.origin),
        "itk_spacing": tuple(g.spacing),
        "itk_direction": tuple(g.direction),
    }
    data_npy = np.stack(images)
    if seg_file is not None:
        seg_arr, _ = read_nifti(seg_file)
        seg_npy = seg_arr.astype(np.float32)[None]
    else:
        seg_npy = None
    return data_npy, seg_npy, properties


class ImageCropper:
    """Finds the union-of-nonzero mask over modalities and crops all channels to it
    (reference: cropping.py:123-216)."""

    def __init__(self, num_threads: int, output_folder: str | None = None):
        self.num_threads = num_threads
        self.output_folder = output_folder
        if output_folder is not None:
            maybe_mkdir(output_folder)

    @staticmethod
    def crop(data, properties, seg=None):
        shape_before = data.shape
        data, seg, bbox = crop_to_nonzero(data, seg, nonzero_label=-1)
        properties["crop_bbox"] = bbox
        properties["classes"] = np.unique(seg)
        seg[seg < -1] = 0
        properties["size_after_cropping"] = data[0].shape
        properties["shape_before_cropping"] = shape_before[1:]
        return data, seg, properties

    @staticmethod
    def crop_from_list_of_files(data_files, seg_file=None):
        data, seg, properties = load_case_from_list_of_files(data_files, seg_file)
        return ImageCropper.crop(data, properties, seg)

    def load_crop_save(self, case, case_identifier, overwrite_existing=False):
        try:
            npz_path = os.path.join(self.output_folder, f"{case_identifier}.npz")
            pkl_path = os.path.join(self.output_folder, f"{case_identifier}.pkl")
            if not overwrite_existing and os.path.isfile(npz_path) and os.path.isfile(pkl_path):
                return
            data, seg, properties = self.crop_from_list_of_files(case[:-1], case[-1])
            all_data = np.vstack((data, seg.astype(np.float32)))
            np.savez_compressed(npz_path, data=all_data)
            save_pickle(properties, pkl_path)
        except Exception:
            print(f"Exception cropping {case_identifier}:\n{traceback.format_exc()}")
            raise

    def run_cropping(self, list_of_files, overwrite_existing=False, output_folder=None):
        if output_folder is not None:
            self.output_folder = output_folder
        gt_dir = maybe_mkdir(os.path.join(self.output_folder, "gt_segmentations"))
        for case in list_of_files:
            if case[-1] is not None:
                shutil.copy(case[-1], gt_dir)
        args = [(case, get_case_identifier(case), overwrite_existing) for case in list_of_files]
        if self.num_threads <= 1 or len(args) <= 1:
            for a in args:
                self.load_crop_save(*a)
        else:
            with process_pool(self.num_threads) as pool:
                list(pool.map(_load_crop_save_star, [(self, *a) for a in args]))

    def get_list_of_cropped_files(self):
        return subfiles(self.output_folder, suffix=".npz")

    def get_patient_identifiers_from_cropped_files(self):
        return [get_case_identifier_from_npz(p) for p in self.get_list_of_cropped_files()]

    def load_properties(self, case_identifier):
        return load_pickle(os.path.join(self.output_folder, f"{case_identifier}.pkl"))

    def save_properties(self, case_identifier, properties):
        save_pickle(properties, os.path.join(self.output_folder, f"{case_identifier}.pkl"))


def _load_crop_save_star(args):
    cropper, case, ident, overwrite = args
    cropper.load_crop_save(case, ident, overwrite)


def get_patient_identifiers_from_cropped_files(folder):
    return [get_case_identifier_from_npz(p) for p in subfiles(folder, suffix=".npz")]
