"""dataset.json generation (nnunet/dataset_conversion/utils.py generate_dataset_json
parity): the manifest every raw task folder needs.

The port's copy of multitalent_tpu/utils/dataset_json.py."""
from __future__ import annotations

import os

from multitalent_tpu_torch.utils.fileops import save_json, subfiles


def get_identifiers_from_splitted_files(folder: str) -> list[str]:
    return sorted({f[:-12] for f in subfiles(folder, suffix=".nii.gz", join=False)})


def generate_dataset_json(output_file: str, imagesTr_dir: str,
                          imagesTs_dir: str | None, modalities: tuple[str, ...],
                          labels: dict, dataset_name: str, license: str = "hands off!",
                          dataset_description: str = "",
                          dataset_reference: str = "",
                          dataset_release: str = "0.0") -> None:
    """labels: {0: 'background', 1: ...}; modalities: ('CT',) etc."""
    train_ids = get_identifiers_from_splitted_files(imagesTr_dir)
    test_ids = (get_identifiers_from_splitted_files(imagesTs_dir)
                if imagesTs_dir is not None and os.path.isdir(imagesTs_dir) else [])
    save_json({
        "name": dataset_name,
        "description": dataset_description,
        "tensorImageSize": "4D",
        "reference": dataset_reference,
        "licence": license,
        "release": dataset_release,
        "modality": {str(i): m for i, m in enumerate(modalities)},
        "labels": {str(k): str(v) for k, v in labels.items()},
        "numTraining": len(train_ids),
        "numTest": len(test_ids),
        "training": [{"image": f"./imagesTr/{i}.nii.gz",
                      "label": f"./labelsTr/{i}.nii.gz"} for i in train_ids],
        "test": [f"./imagesTs/{i}.nii.gz" for i in test_ids],
    }, output_file, sort_keys=False)
