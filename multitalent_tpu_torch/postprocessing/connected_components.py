"""Largest-connected-component postprocessing.

Parity target: nnunet/postprocessing/connected_components.py:48-460 — per-class (or
joint-region) removal of all but the largest connected component, and
`determine_postprocessing`, which tries (1) treating all foreground as one region
and (2) per-class removal on the cross-validation predictions, keeps whatever
improves foreground dice beyond a threshold, writes `postprocessing.json`, and
materializes the postprocessed validation set.

The port's copy of multitalent_tpu/postprocessing/connected_components.py;
components are labelled by `scipy.ndimage.label` (6-connected), the JAX
package's own fallback for its native labeller.
"""
from __future__ import annotations

import ast
import os
import shutil

import numpy as np
from scipy.ndimage import label as scipy_label

from multitalent_tpu_torch.evaluation.evaluator import aggregate_scores
from multitalent_tpu_torch.io.nifti import read_nifti, write_nifti
from multitalent_tpu_torch.utils.fileops import process_pool
from multitalent_tpu_torch.utils.fileops import (load_json, maybe_mkdir, save_json,
                                           subfiles)


def remove_all_but_the_largest_connected_component(
        image: np.ndarray, for_which_classes, volume_per_voxel: float,
        minimum_valid_object_size: dict | None = None):
    """For each entry of `for_which_classes` (an int class or a tuple treated as a
    joint region), keep only the largest connected object; returns
    (image, largest_removed_sizes, kept_sizes) in physical volume units."""
    if for_which_classes is None:
        for_which_classes = np.unique(image)
        for_which_classes = for_which_classes[for_which_classes > 0]
    assert 0 not in for_which_classes, "cannot remove background"

    largest_removed, kept_size = {}, {}
    for c in for_which_classes:
        if isinstance(c, (list, tuple)):
            c = tuple(c)
            mask = np.isin(image, c)
        else:
            mask = image == c
        lmap, num_objects = scipy_label(mask.astype(np.uint8))
        largest_removed[c] = None
        kept_size[c] = None
        if num_objects == 0:
            continue
        sizes = np.bincount(lmap.ravel())[1:] * volume_per_voxel  # skip background
        maximum_size = sizes.max()
        kept_size[c] = float(maximum_size)
        # every other object, or those below the minimum size, in one pass over
        # the volume (a pass per object costs minutes on a speckled mask)
        removed = np.where(sizes != maximum_size)[0]
        if minimum_valid_object_size is not None:
            removed = removed[sizes[removed] < minimum_valid_object_size[c]]
        if len(removed):
            image[np.isin(lmap, removed + 1) & mask] = 0
            largest_removed[c] = float(sizes[removed].max())
    return image, largest_removed, kept_size


def load_remove_save(input_file: str, output_file: str, for_which_classes,
                     minimum_valid_object_size=None):
    img, geom = read_nifti(input_file)
    volume_per_voxel = float(np.prod(geom.spacing))
    image, largest_removed, kept_size = remove_all_but_the_largest_connected_component(
        img.astype(np.int32), for_which_classes, volume_per_voxel,
        minimum_valid_object_size)
    write_nifti(output_file, image.astype(np.uint8), geom)
    return largest_removed, kept_size


def load_postprocessing(json_file: str):
    a = load_json(json_file)
    if "min_valid_object_sizes" in a and a["min_valid_object_sizes"] is not None:
        min_valid = ast.literal_eval(str(a["min_valid_object_sizes"]))
    else:
        min_valid = None
    for_which = [tuple(c) if isinstance(c, list) else c
                 for c in a["for_which_classes"]]
    return for_which, min_valid


def _fg_dice_from_scores(scores, classes) -> float:
    vals = [scores["mean"][str(c)]["Dice"] for c in classes]
    return float(np.nanmean(vals))


def determine_postprocessing(base: str, gt_labels_folder: str,
                             raw_subfolder_name: str = "validation_raw",
                             temp_folder: str = "temp",
                             final_subf_name: str = "validation_final",
                             processes: int = 4, dice_threshold: float = 0,
                             debug: bool = False,
                             advanced_postprocessing: bool = False,
                             pp_filename: str = "postprocessing.json") -> None:
    """Search over {merged-foreground CC removal, per-class CC removal}; keep what
    improves mean foreground Dice on the CV predictions; write postprocessing.json
    (connected_components.py:122-399, simplified to the non-'advanced' path the
    reference uses by default)."""
    raw_folder = os.path.join(base, raw_subfolder_name)
    fnames = subfiles(raw_folder, suffix=".nii.gz", join=False)
    assert len(fnames) > 0, f"no predictions found in {raw_folder}"

    # establish label set from the GT of the validation cases
    classes = set()
    for f in fnames[: min(len(fnames), 10)]:
        gt, _ = read_nifti(os.path.join(gt_labels_folder, f))
        classes.update(int(c) for c in np.unique(gt) if c != 0)
    classes = sorted(classes)

    def evaluate(folder):
        pairs = [(os.path.join(folder, f), os.path.join(gt_labels_folder, f))
                 for f in fnames]
        return aggregate_scores(pairs, labels=classes, num_threads=processes)

    pp_results = {"dc_per_class_raw": None, "dc_per_class_pp_all": None,
                  "dc_per_class_pp_per_class": None, "for_which_classes": [],
                  "min_valid_object_sizes": None}

    base_scores = evaluate(raw_folder)
    raw_dice = _fg_dice_from_scores(base_scores, classes)
    pp_results["dc_per_class_raw"] = {str(c): base_scores["mean"][str(c)]["Dice"]
                                      for c in classes}

    # candidate 1: all foreground classes as one joint region
    tmp_all = maybe_mkdir(os.path.join(base, temp_folder + "_allClasses"))
    _pool_map(processes, _lrs_star,
              [(os.path.join(raw_folder, f), os.path.join(tmp_all, f),
                (tuple(classes),), None) for f in fnames])
    scores_all = evaluate(tmp_all)
    dice_all = _fg_dice_from_scores(scores_all, classes)
    pp_results["dc_per_class_pp_all"] = {str(c): scores_all["mean"][str(c)]["Dice"]
                                         for c in classes}

    do_fg_cc = len(classes) > 1 and dice_all > raw_dice + dice_threshold
    source_folder = tmp_all if do_fg_cc else raw_folder
    if do_fg_cc:
        pp_results["for_which_classes"].append(list(classes))

    # candidate 2: per-class removal on top of the winner so far
    tmp_per_class = maybe_mkdir(os.path.join(base, temp_folder + "_perClass"))
    _pool_map(processes, _lrs_star,
              [(os.path.join(source_folder, f), os.path.join(tmp_per_class, f),
                tuple(classes), None) for f in fnames])
    scores_pc = evaluate(tmp_per_class)
    pp_results["dc_per_class_pp_per_class"] = {
        str(c): scores_pc["mean"][str(c)]["Dice"] for c in classes}
    prev_scores = scores_all if do_fg_cc else base_scores
    for c in classes:
        if (scores_pc["mean"][str(c)]["Dice"]
                > prev_scores["mean"][str(c)]["Dice"] + dice_threshold):
            pp_results["for_which_classes"].append(int(c))

    # materialize final validation set with the selected postprocessing
    final = maybe_mkdir(os.path.join(base, final_subf_name))
    if pp_results["for_which_classes"]:
        for_which = [tuple(c) if isinstance(c, list) else c
                     for c in pp_results["for_which_classes"]]
        _pool_map(processes, _lrs_star,
                  [(os.path.join(raw_folder, f), os.path.join(final, f),
                    for_which, None) for f in fnames])
        final_scores = evaluate(final)
        pp_results["dc_after_pp"] = {str(c): final_scores["mean"][str(c)]["Dice"]
                                     for c in classes}
    else:
        for f in fnames:
            shutil.copy(os.path.join(raw_folder, f), os.path.join(final, f))
        pp_results["dc_after_pp"] = pp_results["dc_per_class_raw"]

    pp_results["min_valid_object_sizes"] = None
    save_json({k: (str(v) if k == "min_valid_object_sizes" and v is not None else v)
               for k, v in pp_results.items()}, os.path.join(base, pp_filename))

    if not debug:
        shutil.rmtree(tmp_all, ignore_errors=True)
        shutil.rmtree(tmp_per_class, ignore_errors=True)


def apply_postprocessing_to_folder(input_folder: str, output_folder: str,
                                   for_which_classes,
                                   min_valid_object_size=None,
                                   num_processes: int = 4) -> None:
    maybe_mkdir(output_folder)
    fnames = subfiles(input_folder, suffix=".nii.gz", join=False)
    _pool_map(num_processes, _lrs_star,
              [(os.path.join(input_folder, f), os.path.join(output_folder, f),
                for_which_classes, min_valid_object_size) for f in fnames])


def _lrs_star(args):
    return load_remove_save(*args)


def _pool_map(processes, fn, jobs):
    if processes <= 1 or len(jobs) <= 1:
        return [fn(j) for j in jobs]
    with process_pool(processes) as pool:
        return list(pool.map(fn, jobs))
