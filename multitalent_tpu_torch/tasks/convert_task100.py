"""Task100_MultiTalent dataset assembly + the addregions pass.

Parity targets: nnunet/dataset_conversion/Task100_MultiTalent.py:218-408 (merge the
13 source tasks into one raw task: copy images under a task-id prefix, remap each
source task's labels into the global 1..47 space, write dataset.json +
cases_have_regions_labels.pkl) and Task100_MultiTalent_addregions.py:14-36 (stamp
`valid_labels`/`valid_regions` into every cropped & preprocessed case pkl so the
masked loss and the region-aware validation know what each image annotates).

Run as: python -m multitalent_tpu_torch.tasks.convert_task100 [--tasks T ...]
        python -m multitalent_tpu_torch.tasks.convert_task100 --addregions-only

The port's copy of multitalent_tpu/tasks/convert_task100.py.
"""
from __future__ import annotations

import argparse
import os
import shutil

import numpy as np

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.io.nifti import read_nifti, write_nifti
from multitalent_tpu_torch.tasks.multitalent import (GLOBAL_LABEL_NAMES, TASK_IDS,
                                                     VALID_REGIONS,
                                                     attach_region_annotations,
                                                     convert_source_segmentation,
                                                     sanity_checks)
from multitalent_tpu_torch.utils.fileops import (load_json, load_pickle, maybe_mkdir,
                                                 save_json, save_pickle, subfiles)

TARGET_TASK = "Task100_MultiTalent"


def _prefix(task: str) -> str:
    return task[4:7]  # 'Task003_Liver' -> '003'


def convert_task(task: str, target_images: str, target_labels: str) -> list[str]:
    """Copy one source task's training images/labels into the merged layout with
    remapped label values. Returns the new case identifiers."""
    src = os.path.join(paths.nnUNet_raw_data(), task)
    dataset_json = load_json(os.path.join(src, "dataset.json"))
    num_modalities = len(dataset_json["modality"])
    assert num_modalities == 1, f"{task}: MultiTalent merges CT tasks (1 modality)"
    prefix = _prefix(task)
    new_cases = []
    for tr in dataset_json["training"]:
        ident = os.path.basename(tr["image"]).split(".nii.gz")[0]
        new_ident = f"{prefix}_{ident}"
        shutil.copy(os.path.join(src, "imagesTr", f"{ident}_0000.nii.gz"),
                    os.path.join(target_images, f"{new_ident}_0000.nii.gz"))
        seg, geom = read_nifti(os.path.join(src, "labelsTr", f"{ident}.nii.gz"))
        seg_conv = convert_source_segmentation(seg.astype(np.int32), task)
        write_nifti(os.path.join(target_labels, f"{new_ident}.nii.gz"),
                    seg_conv.astype(np.uint8), geom)
        new_cases.append(new_ident)
    return new_cases


def build_task100(tasks: list[str] | None = None) -> None:
    sanity_checks()
    tasks = tasks or TASK_IDS
    out = os.path.join(paths.nnUNet_raw_data(), TARGET_TASK)
    images = maybe_mkdir(os.path.join(out, "imagesTr"))
    labels = maybe_mkdir(os.path.join(out, "labelsTr"))
    all_cases: list[str] = []
    cases_regions: dict[str, tuple] = {}
    for task in tasks:
        print(f"converting {task}")
        new_cases = convert_task(task, images, labels)
        all_cases += new_cases
        for c in new_cases:
            cases_regions[c] = VALID_REGIONS[task]
    save_json({
        "name": "MultiTalent",
        "description": "13 partially annotated CT datasets merged into one task",
        "modality": {"0": "CT"},
        "labels": {"0": "background",
                   **{str(k): v for k, v in GLOBAL_LABEL_NAMES.items()}},
        "numTraining": len(all_cases),
        "training": [{"image": f"./imagesTr/{c}.nii.gz",
                      "label": f"./labelsTr/{c}.nii.gz"} for c in all_cases],
        "test": [],
    }, os.path.join(out, "dataset.json"))
    save_pickle(cases_regions, os.path.join(out, "cases_have_regions_labels.pkl"))
    print(f"{TARGET_TASK}: {len(all_cases)} cases")


def add_regions_to_pkls(folders: list[str] | None = None) -> None:
    """Stamp valid_labels/valid_regions into every case pkl of the cropped and
    preprocessed Task100 folders (Task100_MultiTalent_addregions.py:14-36).

    A case pkl is one with its case's .npz beside it. The JAX package's copy
    also walks the preprocessed task folder itself and stamps every pkl whose
    name it does not know, which raises once the planner has put its plans
    pickle there; the port stamps the cases only."""
    if folders is None:
        folders = []
        cropped = os.path.join(paths.nnUNet_cropped_data(), TARGET_TASK)
        if os.path.isdir(cropped):
            folders.append(cropped)
        preproc = os.path.join(paths.preprocessing_output_dir(), TARGET_TASK)
        if os.path.isdir(preproc):
            for sub in sorted(os.listdir(preproc)):
                p = os.path.join(preproc, sub)
                if os.path.isdir(p) and sub.startswith("MultiTalent_data"):
                    folders.append(p)
    for folder in folders:
        n = 0
        for pkl in subfiles(folder, suffix=".pkl"):
            name = os.path.basename(pkl)[:-4]
            if not os.path.isfile(os.path.join(folder, name + ".npz")):
                continue
            props = load_pickle(pkl)
            save_pickle(attach_region_annotations(props, name), pkl)
            n += 1
        print(f"{folder}: stamped {n} case pkls")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--tasks", nargs="+", default=None,
                        help="subset of source tasks (default: all 13)")
    parser.add_argument("--addregions-only", action="store_true",
                        help="only stamp valid_labels/valid_regions into existing "
                             "cropped/preprocessed pkls")
    args = parser.parse_args(argv)
    if not args.addregions_only:
        build_task100(args.tasks)
    else:
        add_regions_to_pkls()


if __name__ == "__main__":
    main()
