"""GenericPreprocessor and variants.

Parity target: nnunet/preprocessing/preprocessing.py:200-950. Per case:
transpose (transpose_forward) -> anisotropy-aware resample to target spacing ->
per-modality intensity normalization -> precompute `class_locations` (up to 10k random
foreground coordinates per class, RandomState(1234)) -> save float32 npz (data+seg
stacked) + properties pkl. Output artifacts are drop-in compatible with the reference's
preprocessed folders.

The port's copy of multitalent_tpu/preprocessing/preprocessor.py; the JAX
package's registry of preprocessors becomes the table `PREPROCESSORS` below.
"""
from __future__ import annotations

import os

import numpy as np

from multitalent_tpu_torch.paths import RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
from multitalent_tpu_torch.preprocessing.cropping import ImageCropper, get_case_identifier_from_npz
from multitalent_tpu_torch.preprocessing.normalization import normalize_channel
from multitalent_tpu_torch.preprocessing.resampling import resample_patient
from multitalent_tpu_torch.utils.fileops import process_pool
from multitalent_tpu_torch.utils import load_pickle, maybe_mkdir, save_pickle, subfiles

NUM_CLASS_LOCATION_SAMPLES = 10000
MIN_CLASS_LOCATION_COVERAGE = 0.01
CLASS_LOCATION_SEED = 1234


def sample_class_locations(seg: np.ndarray, all_classes, num_samples=NUM_CLASS_LOCATION_SAMPLES,
                           min_coverage=MIN_CLASS_LOCATION_COVERAGE,
                           seed=CLASS_LOCATION_SEED) -> dict:
    """Sample up to `num_samples` voxel coordinates per class (at least `min_coverage`
    of each class's voxels) for foreground-forced patch sampling during training."""
    rndst = np.random.RandomState(seed)
    class_locs = {}
    for c in all_classes:
        all_locs = np.argwhere(seg == c)
        if len(all_locs) == 0:
            class_locs[c] = []
            continue
        target = min(num_samples, len(all_locs))
        target = max(target, int(np.ceil(len(all_locs) * min_coverage)))
        class_locs[c] = all_locs[rndst.choice(len(all_locs), target, replace=False)]
    return class_locs


class GenericPreprocessor:
    def __init__(self, normalization_scheme_per_modality, use_nonzero_mask,
                 transpose_forward, intensityproperties=None):
        self.normalization_scheme_per_modality = normalization_scheme_per_modality
        self.use_nonzero_mask = use_nonzero_mask
        self.transpose_forward = list(transpose_forward)
        self.intensityproperties = intensityproperties
        self.resample_separate_z_anisotropy_threshold = RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
        self.resample_order_data = 3
        self.resample_order_seg = 1

    # --- per-case pipeline -------------------------------------------------------
    @staticmethod
    def load_cropped(cropped_output_dir, case_identifier):
        all_data = np.load(os.path.join(cropped_output_dir, f"{case_identifier}.npz"))["data"]
        data = all_data[:-1].astype(np.float32)
        seg = all_data[-1:]
        properties = load_pickle(os.path.join(cropped_output_dir, f"{case_identifier}.pkl"))
        return data, seg, properties

    def resample_and_normalize(self, data, target_spacing, properties, seg=None,
                               force_separate_z=None):
        original_spacing_transposed = np.array(properties["original_spacing"])[self.transpose_forward]
        data = np.nan_to_num(data, nan=0.0)
        data, seg = resample_patient(
            data, seg, original_spacing_transposed, target_spacing,
            order_data=self.resample_order_data, order_seg=self.resample_order_seg,
            force_separate_z=force_separate_z, order_z_data=0, order_z_seg=0,
            separate_z_anisotropy_threshold=self.resample_separate_z_anisotropy_threshold)
        if seg is not None:
            seg[seg < -1] = 0  # guard against stray labels below the background marker

        properties["size_after_resampling"] = data[0].shape
        properties["spacing_after_resampling"] = target_spacing

        assert len(self.normalization_scheme_per_modality) == len(data)
        assert len(self.use_nonzero_mask) == len(data)
        seg_last = seg[-1] if seg is not None else None
        for c in range(len(data)):
            props = self.intensityproperties[c] if self.intensityproperties is not None else None
            data[c] = normalize_channel(
                data[c], self.normalization_scheme_per_modality[c],
                bool(self.use_nonzero_mask[c]), seg_last, props)
        return data, seg, properties

    def preprocess_test_case(self, data_files, target_spacing, seg_file=None,
                             force_separate_z=None):
        data, seg, properties = ImageCropper.crop_from_list_of_files(data_files, seg_file)
        tf = [i + 1 for i in self.transpose_forward]
        data = data.transpose((0, *tf))
        seg = seg.transpose((0, *tf))
        data, seg, properties = self.resample_and_normalize(
            data, target_spacing, properties, seg, force_separate_z=force_separate_z)
        return data.astype(np.float32), seg, properties

    def _run_internal(self, target_spacing, case_identifier, output_folder_stage,
                      cropped_output_dir, force_separate_z, all_classes):
        data, seg, properties = self.load_cropped(cropped_output_dir, case_identifier)
        tf = [i + 1 for i in self.transpose_forward]
        data = data.transpose((0, *tf))
        seg = seg.transpose((0, *tf))
        data, seg, properties = self.resample_and_normalize(
            data, target_spacing, properties, seg, force_separate_z)
        all_data = np.vstack((data, seg)).astype(np.float32)
        properties["class_locations"] = sample_class_locations(all_data[-1], all_classes)
        np.savez_compressed(os.path.join(output_folder_stage, f"{case_identifier}.npz"),
                            data=all_data)
        save_pickle(properties, os.path.join(output_folder_stage, f"{case_identifier}.pkl"))

    # --- whole-dataset driver ----------------------------------------------------
    def run(self, target_spacings, input_folder_with_cropped_npz, output_folder,
            data_identifier, num_threads=8, force_separate_z=None):
        print("Initializing to run preprocessing")
        list_of_cropped_npz = subfiles(input_folder_with_cropped_npz, suffix=".npz")
        maybe_mkdir(output_folder)
        num_stages = len(target_spacings)
        if not isinstance(num_threads, (list, tuple)):
            num_threads = [num_threads] * num_stages
        dataset_props = load_pickle(
            os.path.join(input_folder_with_cropped_npz, "dataset_properties.pkl"))
        all_classes = dataset_props["all_classes"]
        for i in range(num_stages):
            output_folder_stage = maybe_mkdir(
                os.path.join(output_folder, f"{data_identifier}_stage{i}"))
            spacing = target_spacings[i]
            args = [
                (spacing, get_case_identifier_from_npz(p), output_folder_stage,
                 input_folder_with_cropped_npz, force_separate_z, all_classes)
                for p in list_of_cropped_npz
            ]
            if num_threads[i] <= 1 or len(args) <= 1:
                for a in args:
                    self._run_internal(*a)
            else:
                with process_pool(num_threads[i]) as pool:
                    list(pool.map(_run_internal_star, [(self, *a) for a in args]))


def _run_internal_star(args):
    self, *rest = args
    self._run_internal(*rest)


class Preprocessor3DDifferentResampling(GenericPreprocessor):
    """Resample data linearly (order 1) rather than cubically; separate-z uses the same
    orders (reference: preprocessing.py Preprocessor3DDifferentResampling)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.resample_order_data = 1


class Preprocessor3DBetterResampling(GenericPreprocessor):
    """Never uses separate-z resampling (force_separate_z=False always)."""

    def resample_and_normalize(self, data, target_spacing, properties, seg=None,
                               force_separate_z=False):
        return super().resample_and_normalize(data, target_spacing, properties, seg,
                                              force_separate_z=False)

    def preprocess_test_case(self, data_files, target_spacing, seg_file=None,
                             force_separate_z=False):
        return super().preprocess_test_case(data_files, target_spacing, seg_file,
                                            force_separate_z=False)


class PreprocessorFor2D(GenericPreprocessor):
    """2D configuration: only in-plane axes are resampled (the through-plane axis keeps
    the original spacing by always running the separate-z path at order_z=0)."""

    def resample_and_normalize(self, data, target_spacing, properties, seg=None,
                               force_separate_z=None):
        original_spacing_transposed = np.array(properties["original_spacing"])[self.transpose_forward]
        target = list(target_spacing)
        target[0] = float(original_spacing_transposed[0])
        return super().resample_and_normalize(data, target, properties, seg,
                                              force_separate_z=force_separate_z)


class PreprocessorNoResampling(GenericPreprocessor):
    """Keeps the native grid: the 'target spacing' is replaced per case by the
    case's own (transposed) original spacing so the resampler is an identity
    (preprocessing.py PreprocessorFor3D_NoResampling parity)."""

    def resample_and_normalize(self, data, target_spacing, properties, seg=None,
                               force_separate_z=None):
        native = np.array(properties["original_spacing"])[self.transpose_forward]
        return super().resample_and_normalize(data, list(native), properties,
                                              seg, force_separate_z)


# the preprocessor names plans store (`preprocessor_name`) -> class, with the
# reference's alias (multitalent_tpu/registry.py PREPROCESSORS)
PREPROCESSORS = {cls.__name__: cls for cls in (
    GenericPreprocessor, Preprocessor3DDifferentResampling, Preprocessor3DBetterResampling,
    PreprocessorFor2D, PreprocessorNoResampling)}
PREPROCESSORS["PreprocessorFor3D_NoResampling"] = PreprocessorNoResampling


def resolve_preprocessor(name: str) -> type:
    if name not in PREPROCESSORS:
        raise KeyError(f"Unknown preprocessor {name!r}. Registered: {sorted(PREPROCESSORS)}")
    return PREPROCESSORS[name]
