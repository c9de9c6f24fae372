"""`python -m multitalent_tpu_torch.cli.convert_decathlon_task` — split Medical
Segmentation Decathlon 4D niftis into the per-modality `_0000` convention
(the port's copy of multitalent_tpu/cli/convert_decathlon_task.py).

Parity target: nnUNet_convert_decathlon_task (setup.py:30;
experiment_planning/nnUNet_convert_decathlon_task.py): MSD tasks ship one 4D
nifti per case; nnU-Net expects one 3D file per modality.
"""
from __future__ import annotations

import argparse
import os
import shutil

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.io.nifti import read_nifti, write_nifti
from multitalent_tpu_torch.utils.fileops import load_json, maybe_mkdir, save_json


def split_4d_nifti(in_file: str, out_folder: str, ident: str) -> None:
    arr, geom = read_nifti(in_file)
    if arr.ndim == 3:
        arr = arr[None]
    for m in range(arr.shape[0]):
        write_nifti(os.path.join(out_folder, f"{ident}_{m:04d}.nii.gz"),
                    arr[m], geom)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_folder", required=True,
                        help="MSD task folder (TaskXX_name with dataset.json)")
    parser.add_argument("-output_task_id", type=int, default=None,
                        help="renumber the task (e.g. 4 -> Task004_...)")
    args = parser.parse_args(argv)

    src = args.input_folder.rstrip("/")
    name = os.path.basename(src)
    assert name.startswith("Task"), "input must be a TaskXX_name folder"
    if args.output_task_id is not None:
        task_part, suffix = name.split("_", 1)
        name = f"Task{args.output_task_id:03d}_{suffix}"
    else:
        task_part, suffix = name.split("_", 1)
        name = f"Task{int(task_part[4:]):03d}_{suffix}"
    out = os.path.join(paths.nnUNet_raw_data(), name)
    images_tr = maybe_mkdir(os.path.join(out, "imagesTr"))
    labels_tr = maybe_mkdir(os.path.join(out, "labelsTr"))
    maybe_mkdir(os.path.join(out, "imagesTs"))

    dataset_json = load_json(os.path.join(src, "dataset.json"))
    for tr in dataset_json["training"]:
        ident = os.path.basename(tr["image"]).split(".nii.gz")[0]
        split_4d_nifti(os.path.join(src, "imagesTr", f"{ident}.nii.gz"),
                       images_tr, ident)
        shutil.copy(os.path.join(src, "labelsTr", f"{ident}.nii.gz"), labels_tr)
    for ts in dataset_json.get("test", []):
        ident = os.path.basename(ts).split(".nii.gz")[0]
        split_4d_nifti(os.path.join(src, "imagesTs", f"{ident}.nii.gz"),
                       os.path.join(out, "imagesTs"), ident)
    save_json(dataset_json, os.path.join(out, "dataset.json"), sort_keys=False)
    print(f"converted into {out}")


if __name__ == "__main__":
    main()
