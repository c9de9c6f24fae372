"""Region-based evaluation: score joint label regions instead of single labels.

Parity target: nnunet/evaluation/region_based_evaluation.py:34-… (evaluate each
region = OR of its labels across prediction and reference; used e.g. for BraTS
whole-tumor/core/enhancing and for MultiTalent's multi-label regions).

The port's copy of multitalent_tpu/evaluation/region_based_evaluation.py.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multitalent_tpu_torch.evaluation.metrics import dice
from multitalent_tpu_torch.io.nifti import read_nifti
from multitalent_tpu_torch.utils.fileops import save_json, subfiles


def get_brats_regions() -> dict:
    return {"whole tumor": (1, 2, 3), "tumor core": (2, 3), "enhancing tumor": (3,)}


def create_region_from_mask(mask: np.ndarray, join_labels: tuple) -> np.ndarray:
    return np.isin(mask, np.asarray(join_labels))


def evaluate_case(file_pred: str, file_gt: str, regions: dict) -> list[float]:
    image_gt, _ = read_nifti(file_gt)
    image_pred, _ = read_nifti(file_pred)
    results = []
    for r in regions.values():
        mask_pred = create_region_from_mask(image_pred, r)
        mask_gt = create_region_from_mask(image_gt, r)
        dc = (np.nan if (mask_gt.sum() == 0 and mask_pred.sum() == 0)
              else dice(mask_pred, mask_gt))
        results.append(dc)
    return results


def evaluate_regions(folder_predicted: str, folder_gt: str, regions: dict,
                     processes: int = 4) -> dict:
    """Per-case + mean region dice; writes summary.csv into folder_predicted."""
    region_names = list(regions.keys())
    files_pred = subfiles(folder_predicted, suffix=".nii.gz", join=False)
    files_gt = subfiles(folder_gt, suffix=".nii.gz", join=False)
    assert all(f in files_gt for f in files_pred), "missing ground-truth files"

    with ThreadPoolExecutor(max_workers=processes) as pool:
        results = list(pool.map(
            lambda f: evaluate_case(os.path.join(folder_predicted, f),
                                    os.path.join(folder_gt, f), regions),
            files_pred))

    all_results: dict = {r: [] for r in region_names}
    with open(os.path.join(folder_predicted, "summary.csv"), "w") as f:
        f.write("casename," + ",".join(region_names) + "\n")
        for case, res in zip(files_pred, results):
            f.write(case.split(".nii.gz")[0])
            for r, d in zip(region_names, res):
                f.write(f",{d}")
                all_results[r].append(d)
            f.write("\n")
        means = [float(np.nanmean(all_results[r])) for r in region_names]
        f.write("mean," + ",".join(f"{m}" for m in means) + "\n")
    return {r: float(np.nanmean(all_results[r])) for r in region_names}


def evaluate_multitalent_regions(folder_predicted_individual: str, folder_gt: str,
                                 processes: int = 4) -> dict:
    """Score every MultiTalent region's binary predictions (the
    `individual/<region>/` export of predict_MultiTalent) against region masks
    built from the global-label ground truth."""
    from multitalent_tpu_torch.tasks.multitalent import REGIONS

    out = {}
    for region, labels in REGIONS.items():
        rdir = os.path.join(folder_predicted_individual, region)
        if not os.path.isdir(rdir):
            continue
        files = subfiles(rdir, suffix=".nii.gz", join=False)

        def score(f):
            pred, _ = read_nifti(os.path.join(rdir, f))
            gt, _ = read_nifti(os.path.join(folder_gt, f))
            gt_region = create_region_from_mask(gt, labels)
            if gt_region.sum() == 0 and pred.sum() == 0:
                return np.nan
            return dice(pred > 0, gt_region)

        with ThreadPoolExecutor(max_workers=processes) as pool:
            scores = list(pool.map(score, files))
        out[region] = float(np.nanmean(scores)) if scores else np.nan
    return out
