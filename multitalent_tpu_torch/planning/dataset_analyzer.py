"""Dataset fingerprint: sizes/spacings after cropping, class inventory, foreground
intensity statistics per modality, and crop size reductions.

Parity target: nnunet/experiment_planning/DatasetAnalyzer.py:27-257. Produces the
`dataset_properties.pkl` consumed by the experiment planners, with identical keys
(all_sizes, all_spacings, all_classes, modalities, intensityproperties,
size_reductions).

The port's copy of multitalent_tpu/planning/dataset_analyzer.py; its pool is the
port's `process_pool` (forked workers while CUDA is not initialised, threads
once it is), and both give the same file.
"""
from __future__ import annotations

import os

import numpy as np

from multitalent_tpu_torch.paths import default_num_threads
from multitalent_tpu_torch.preprocessing.cropping import get_patient_identifiers_from_cropped_files
from multitalent_tpu_torch.utils.fileops import process_pool
from multitalent_tpu_torch.utils import load_json, load_pickle, save_pickle

FOREGROUND_SUBSAMPLE_STRIDE = 10  # every 10th fg voxel is enough for robust percentiles


def _compute_stats(voxels) -> dict:
    if len(voxels) == 0:
        return {k: np.nan for k in
                ("median", "mean", "sd", "mn", "mx", "percentile_99_5", "percentile_00_5")}
    v = np.asarray(voxels)
    return {
        "median": np.median(v),
        "mean": np.mean(v),
        "sd": np.std(v),
        "mn": np.min(v),
        "mx": np.max(v),
        "percentile_99_5": np.percentile(v, 99.5),
        "percentile_00_5": np.percentile(v, 0.5),
    }


def _fg_voxels_for_case(args):
    folder, identifier, modality_id = args
    all_data = np.load(os.path.join(folder, identifier + ".npz"))["data"]
    mask = all_data[-1] > 0
    return all_data[modality_id][mask][::FOREGROUND_SUBSAMPLE_STRIDE]


class DatasetAnalyzer:
    def __init__(self, folder_with_cropped_data, overwrite=True,
                 num_processes=default_num_threads):
        self.folder_with_cropped_data = folder_with_cropped_data
        self.overwrite = overwrite
        self.num_processes = num_processes
        self.patient_identifiers = get_patient_identifiers_from_cropped_files(
            folder_with_cropped_data)
        assert os.path.isfile(os.path.join(folder_with_cropped_data, "dataset.json")), \
            "dataset.json needs to be in folder_with_cropped_data"
        self.intensityproperties_file = os.path.join(
            folder_with_cropped_data, "intensityproperties.pkl")

    def _props(self, identifier):
        return load_pickle(os.path.join(self.folder_with_cropped_data, identifier + ".pkl"))

    def get_classes(self) -> dict:
        return load_json(os.path.join(self.folder_with_cropped_data, "dataset.json"))["labels"]

    def get_modalities(self) -> dict[int, str]:
        mod = load_json(os.path.join(self.folder_with_cropped_data, "dataset.json"))["modality"]
        return {int(k): v for k, v in mod.items()}

    def get_sizes_and_spacings_after_cropping(self):
        sizes, spacings = [], []
        for c in self.patient_identifiers:
            props = self._props(c)
            sizes.append(props["size_after_cropping"])
            spacings.append(props["original_spacing"])
        return sizes, spacings

    def get_size_reduction_by_cropping(self) -> dict[str, float]:
        out = {}
        for p in self.patient_identifiers:
            props = self._props(p)
            out[p] = float(np.prod(props["size_after_cropping"])
                           / np.prod(props["original_size_of_raw_data"]))
        return out

    def collect_intensity_properties(self, num_modalities: int) -> dict:
        if not self.overwrite and os.path.isfile(self.intensityproperties_file):
            return load_pickle(self.intensityproperties_file)
        results: dict[int, dict] = {}
        for mod_id in range(num_modalities):
            args = [(self.folder_with_cropped_data, pid, mod_id)
                    for pid in self.patient_identifiers]
            if self.num_processes <= 1 or len(args) <= 1:
                per_case = [_fg_voxels_for_case(a) for a in args]
            else:
                with process_pool(self.num_processes) as pool:
                    per_case = list(pool.map(_fg_voxels_for_case, args))
            pooled = np.concatenate([np.asarray(v) for v in per_case]) if per_case else []
            stats = _compute_stats(pooled)
            stats["local_props"] = {
                pid: _compute_stats(v) for pid, v in zip(self.patient_identifiers, per_case)
            }
            results[mod_id] = stats
        save_pickle(results, self.intensityproperties_file)
        return results

    def analyze_dataset(self, collect_intensityproperties=True) -> dict:
        sizes, spacings = self.get_sizes_and_spacings_after_cropping()
        classes = self.get_classes()
        all_classes = [int(i) for i in classes.keys() if int(i) > 0]
        modalities = self.get_modalities()
        intensityproperties = (self.collect_intensity_properties(len(modalities))
                               if collect_intensityproperties else None)
        dataset_properties = {
            "all_sizes": sizes,
            "all_spacings": spacings,
            "all_classes": all_classes,
            "modalities": modalities,
            "intensityproperties": intensityproperties,
            "size_reductions": self.get_size_reduction_by_cropping(),
        }
        save_pickle(dataset_properties,
                    os.path.join(self.folder_with_cropped_data, "dataset_properties.pkl"))
        return dataset_properties
