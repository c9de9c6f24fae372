"""Raw-dataset integrity verification.

Parity target: nnunet/preprocessing/sanity_checks.py:90-249
(`verify_dataset_integrity`): every training case listed in dataset.json must have
all modality files and a label file, geometries (shape/spacing/origin/direction)
must match between modalities and labels, and label values must be the consecutive
integers declared in dataset.json.

The port's copy of multitalent_tpu/preprocessing/sanity_checks.py.
"""
from __future__ import annotations

import os

import numpy as np

from multitalent_tpu_torch.io.nifti import read_nifti
from multitalent_tpu_torch.utils.fileops import load_json, subfiles


def _geom_close(g1, g2, atol=1e-3) -> bool:
    return (np.allclose(g1.spacing, g2.spacing, atol=atol)
            and np.allclose(g1.origin, g2.origin, atol=atol)
            and np.allclose(g1.direction, g2.direction, atol=atol))


def verify_dataset_integrity(folder: str) -> None:
    print(f"Verifying dataset integrity of {folder}")
    dataset_json = load_json(os.path.join(folder, "dataset.json"))
    num_modalities = len(dataset_json["modality"])
    expected_labels = sorted(int(k) for k in dataset_json["labels"].keys())
    assert expected_labels[0] == 0, "labels must start at 0 (background)"
    assert expected_labels == list(range(len(expected_labels))), \
        f"labels must be consecutive integers, got {expected_labels}"

    label_files_seen = []
    for tr in dataset_json["training"]:
        ident = os.path.basename(tr["image"]).split(".nii.gz")[0]
        label_file = os.path.join(folder, "labelsTr", f"{ident}.nii.gz")
        assert os.path.isfile(label_file), f"missing label: {label_file}"
        label_arr, label_geom = read_nifti(label_file)
        label_files_seen.append(os.path.basename(label_file))

        present = set(np.unique(label_arr).astype(int).tolist())
        unexpected = present - set(expected_labels)
        assert not unexpected, \
            f"{ident}: unexpected label values {sorted(unexpected)}"

        for m in range(num_modalities):
            img_file = os.path.join(folder, "imagesTr", f"{ident}_{m:04d}.nii.gz")
            assert os.path.isfile(img_file), f"missing modality: {img_file}"
            img_arr, img_geom = read_nifti(img_file)
            assert img_arr.shape == label_arr.shape, \
                f"{ident}: shape mismatch {img_arr.shape} vs {label_arr.shape}"
            assert _geom_close(img_geom, label_geom), \
                f"{ident}: geometry mismatch between modality {m} and label"

    # no orphan label files
    all_labels = subfiles(os.path.join(folder, "labelsTr"), suffix=".nii.gz",
                          join=False)
    orphans = set(all_labels) - set(label_files_seen)
    assert not orphans, f"label files not referenced in dataset.json: {sorted(orphans)}"
    print("Dataset OK")
