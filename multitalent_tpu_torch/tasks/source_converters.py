"""Converters producing the MultiTalent source tasks in nnU-Net raw layout.

The port's copy of multitalent_tpu/tasks/source_converters.py (host code).

The 13-dataset Task100 merge (tasks/convert_task100.py) presupposes its source
tasks already exist under nnUNet_raw_data. This module builds them from the
public challenge downloads, matching the reference's one-off scripts:

- Task017 AbdominalOrganSegmentation — BTCV abdomen
  (nnunet/dataset_conversion/Task017_BeyondCranialVaultAbdominalOrganSegmentation.py:23-104)
- Task018 PelvicOrganSegmentation — BTCV cervix
  (Task018_PelvicOrganSegmentation.py:22-96)
- Task055 SegTHOR (Task055_SegTHOR.py:38-108)
- Task062 NIHPancreas — TCIA Pancreas-CT
  (Task062_NIHPancreas.py:33-120; the reference first converts DICOM series
  with dicom2nifti, which is not in this image — pass the folder of
  already-converted `PANCREAS_XXXX.nii.gz` volumes; the RAS reorientation and
  the 4-case exclusion list are reproduced here)
- Task064 KiTS_labelsFixed (Task064_KiTS_labelsFixed.py:20-95)

- Task046 AbdOrgSegm2 — TCIA Pancreas-CT + BTCV images with the zenodo
  multi-organ labels (Task46_AbdOrgSegm2.py:44-186; the DICOM→NIfTI pre-step
  runs through io/dicom.py as for Task062; the label remap, the pancreas
  image→label geometry alignment, and the drop-unlabeled-images rule are
  reproduced)
- Task051 StructSeg2019 Task3 Thoracic OAR
  (Task51_StructSeg2019_Task3_Thoracic_OAR.py:8-41; the reference writes the
  folder as `Task51_...` — this rebuild uses the zero-padded
  `Task051_StructSeg2019_Task3_Thoracic_OAR` name that Task100's merge tables
  expect, `Task100_MultiTalent.py:44`)

The six Decathlon sources (Task003/006/007/008/009/010) convert through
`python -m multitalent_tpu_torch.cli.convert_decathlon_task`.

CLI: python -m multitalent_tpu_torch.cli.convert_multitalent_sources <task> <src> ...
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.utils.dataset_json import generate_dataset_json
from multitalent_tpu_torch.utils.fileops import maybe_mkdir, subdirs, subfiles


def _task_layout(task_folder_name: str, raw_data_base: str | None):
    out_base = os.path.join(raw_data_base or paths.nnUNet_raw_data(),
                            task_folder_name)
    imagestr = maybe_mkdir(os.path.join(out_base, "imagesTr"))
    imagests = maybe_mkdir(os.path.join(out_base, "imagesTs"))
    labelstr = maybe_mkdir(os.path.join(out_base, "labelsTr"))
    return out_base, imagestr, imagests, labelstr


def convert_task017_btcv_abdomen(source_dir: str,
                                 raw_data_base: str | None = None) -> str:
    """BTCV 'Multi-Atlas Labeling Beyond the Cranial Vault' RawData folder
    (Training/img, Training/label, Test/img; files img0001.nii.gz /
    label0001.nii.gz) -> Task017 with cases ABD_001 etc."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task017_AbdominalOrganSegmentation", raw_data_base)
    for p in subfiles(os.path.join(source_dir, "Training", "img"),
                      join=False, suffix="nii.gz"):
        name = f"ABD_{int(p[3:7]):03d}"
        shutil.copy(os.path.join(source_dir, "Training", "img", p),
                    os.path.join(imagestr, f"{name}_0000.nii.gz"))
        shutil.copy(os.path.join(source_dir, "Training", "label", "label" + p[3:]),
                    os.path.join(labelstr, f"{name}.nii.gz"))
    test_dir = os.path.join(source_dir, "Test", "img")
    if os.path.isdir(test_dir):
        for p in subfiles(test_dir, join=False, suffix=".nii.gz"):
            name = f"ABD_{int(p[3:7]):03d}"
            shutil.copy(os.path.join(test_dir, p),
                        os.path.join(imagests, f"{name}_0000.nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "spleen", 2: "right kidney", 3: "left kidney",
         4: "gallbladder", 5: "esophagus", 6: "liver", 7: "stomach", 8: "aorta",
         9: "inferior vena cava", 10: "portal vein and splenic vein",
         11: "pancreas", 12: "right adrenal gland", 13: "left adrenal gland"},
        "AbdominalOrganSegmentation",
        dataset_reference="https://www.synapse.org/#!Synapse:syn3193805/wiki/217789",
        dataset_description="Multi-Atlas Labeling Beyond the Cranial Vault "
                            "Abdominal Organ Segmentation")
    return out_base


def convert_task018_btcv_cervix(source_dir: str,
                                raw_data_base: str | None = None) -> str:
    """BTCV cervix RawData folder (Training/img with *-Image.nii.gz,
    Training/label with *-Mask.nii.gz, Testing/img) -> Task018."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task018_PelvicOrganSegmentation", raw_data_base)
    for p in subfiles(os.path.join(source_dir, "Training", "img"),
                      join=False, suffix="nii.gz"):
        shutil.copy(os.path.join(source_dir, "Training", "img", p),
                    os.path.join(imagestr, p[:-7] + "_0000.nii.gz"))
        # ...-Image.nii.gz pairs with ...-Mask.nii.gz; label keeps the image name
        shutil.copy(os.path.join(source_dir, "Training", "label",
                                 p[:-13] + "-Mask.nii.gz"),
                    os.path.join(labelstr, p))
    test_dir = os.path.join(source_dir, "Testing", "img")
    if os.path.isdir(test_dir):
        for p in subfiles(test_dir, join=False, suffix=".nii.gz"):
            shutil.copy(os.path.join(test_dir, p),
                        os.path.join(imagests, p[:-7] + "_0000.nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "bladder", 2: "uterus", 3: "rectum",
         4: "small bowel"},
        "PelvicOrganSegmentation",
        dataset_reference="https://www.synapse.org/#!Synapse:syn3193805/wiki/217789")
    return out_base


def convert_task055_segthor(source_dir: str,
                            raw_data_base: str | None = None) -> str:
    """SegTHOR download (train/Patient_XX/{Patient_XX.nii.gz, GT.nii.gz},
    test/*.nii.gz) -> Task055."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task055_SegTHOR", raw_data_base)
    for p in subdirs(os.path.join(source_dir, "train"), join=False):
        curr = os.path.join(source_dir, "train", p)
        shutil.copy(os.path.join(curr, p + ".nii.gz"),
                    os.path.join(imagestr, p + "_0000.nii.gz"))
        shutil.copy(os.path.join(curr, "GT.nii.gz"),
                    os.path.join(labelstr, p + ".nii.gz"))
    test_dir = os.path.join(source_dir, "test")
    if os.path.isdir(test_dir):
        for p in subfiles(test_dir, join=False, suffix=".nii.gz"):
            shutil.copy(os.path.join(test_dir, p),
                        os.path.join(imagests, p[:-7] + "_0000.nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "esophagus", 2: "heart", 3: "trachea", 4: "aorta"},
        "SegTHOR")
    return out_base


# cases the reference excludes: corrupt/mismatched label pairs
# (Task062_NIHPancreas.py:93)
TASK062_EXCLUDED = ("PANCREAS_0045", "PANCREAS_0007", "PANCREAS_0032",
                    "PANCREAS_0027")



def _ensure_pancreas_niftis(images_dir: str) -> str:
    """Accept either a folder of PANCREAS_XXXX.nii.gz volumes or the raw TCIA
    DICOM manifest tree (case/<study>/<series>/*.dcm). DICOM trees are
    converted through the vendored reader (io/dicom.py — the reference used
    dicom2nifti, Task062_NIHPancreas.py:33-60) into a `nifti_converted`
    sibling folder, reused on rerun."""
    from multitalent_tpu_torch.utils.fileops import subfiles as _subfiles
    if _subfiles(images_dir, join=False, suffix=".nii.gz"):
        return images_dir
    from multitalent_tpu_torch.io.dicom import (convert_tcia_dicom_tree,
                                          find_dicom_series_dirs)
    if not find_dicom_series_dirs(images_dir):
        raise ValueError(f"{images_dir}: neither NIfTI volumes nor DICOM "
                         "series found")
    out_dir = os.path.join(os.path.dirname(os.path.abspath(images_dir)),
                           "nifti_converted")
    existing = set(_subfiles(out_dir, join=False, suffix=".nii.gz")
                   if os.path.isdir(out_dir) else [])
    # reuse only a COMPLETE prior conversion: a run that crashed mid-way
    # leaves a partial set which must not be silently treated as done
    # (every case would then be missing from the task)
    expected = {case.name + ".nii.gz"
                for case in sorted(os.scandir(images_dir), key=lambda e: e.name)
                if case.is_dir() and find_dicom_series_dirs(case.path)}
    if not expected <= existing:
        convert_tcia_dicom_tree(images_dir, out_dir)
    return out_dir


def convert_task062_nih_pancreas(nifti_images_dir: str, labels_dir: str,
                                 raw_data_base: str | None = None,
                                 reorient: bool = True) -> str:
    """TCIA Pancreas-CT: `nifti_images_dir` holds PANCREAS_XXXX.nii.gz
    volumes OR the raw TCIA DICOM manifest tree (converted via the vendored
    reader io/dicom.py; the reference used dicom2nifti,
    Task062_NIHPancreas.py:33-60). `labels_dir` holds labelXXXX.nii.gz. Both are reoriented to closest
    canonical (RAS) like the reference's nibabel pass, and the 4 known-bad
    cases are dropped."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task062_NIHPancreas", raw_data_base)
    nifti_images_dir = _ensure_pancreas_niftis(nifti_images_dir)
    for c in subfiles(nifti_images_dir, join=False, suffix=".nii.gz"):
        casename = c[:-7]
        if casename in TASK062_EXCLUDED:
            continue
        img_out = os.path.join(imagestr, casename + "_0000.nii.gz")
        lab_out = os.path.join(labelstr, casename + ".nii.gz")
        shutil.copy(os.path.join(nifti_images_dir, c), img_out)
        # PANCREAS_0001 -> label0001
        shutil.copy(os.path.join(labels_dir, "label" + c[9:]), lab_out)
        if reorient:
            from multitalent_tpu_torch.utils.reorientation import reorient_file_to_ras
            reorient_file_to_ras(img_out)
            reorient_file_to_ras(lab_out)
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "Pancreas"}, "NIHPancreas")
    return out_base


def convert_task064_kits(source_dir: str,
                         raw_data_base: str | None = None) -> str:
    """KiTS19 (labels-fixed) data folder (case_00000/{imaging.nii.gz,
    segmentation.nii.gz}): first 210 cases train, rest test -> Task064."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task064_KiTS_labelsFixed", raw_data_base)
    all_cases = subdirs(source_dir, join=False)
    for p in all_cases[:210]:
        curr = os.path.join(source_dir, p)
        shutil.copy(os.path.join(curr, "imaging.nii.gz"),
                    os.path.join(imagestr, p + "_0000.nii.gz"))
        shutil.copy(os.path.join(curr, "segmentation.nii.gz"),
                    os.path.join(labelstr, p + ".nii.gz"))
    for p in all_cases[210:]:
        shutil.copy(os.path.join(source_dir, p, "imaging.nii.gz"),
                    os.path.join(imagests, p + "_0000.nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "Kidney", 2: "Tumor"}, "KiTS",
        dataset_description="kidney and kidney tumor segmentation")
    return out_base


# Task046 remaps the zenodo multi-organ label values onto a dense 0..8 range
# (Task46_AbdOrgSegm2.py:104-121: enumerate of the sparse {0,1,3,4,5,6,7,11,14}
# label table in declaration order)
TASK046_LABEL_REMAP = {0: 0, 1: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 11: 7, 14: 8}
TASK046_LABEL_NAMES = {0: "background", 1: "spleen", 2: "left kidney",
                       3: "gallbladder", 4: "esophagus", 5: "liver",
                       6: "stomach", 7: "pancreas", 8: "duodenum"}


def _remap_segmentation(src_path: str, out_path: str, mapping: dict) -> None:
    """Value-table label remap preserving geometry
    (Task46_AbdOrgSegm2.py:44-53)."""
    from multitalent_tpu_torch.io.nifti import read_nifti, write_nifti
    seg, geom = read_nifti(src_path)
    out = np.zeros_like(seg)
    for src, dst in mapping.items():
        out[seg == src] = dst
    write_nifti(out_path, out, geom)


def convert_task046_abdorgsegm2(pancreas_nifti_dir: str, labels_dir: str,
                                btcv_images_dirs=(),
                                raw_data_base: str | None = None) -> str:
    """AbdOrgSegm2 (zenodo 1169361 multi-organ labels over TCIA Pancreas-CT +
    BTCV images). `pancreas_nifti_dir` holds PANCREAS_XXXX.nii.gz volumes
    (DICOM series converted beforehand, as for Task062); `labels_dir` is the
    zenodo download with `label_tciapancreasct_multiorgan/label_tcia_multiorgan`
    and `label_btcv_multiorgan` subfolders of labelXXXX.nii.gz;
    `btcv_images_dirs` are folders of BTCV imgXXXX.nii.gz (e.g. the RawData
    Training/img and Test/img — the reference labeled test images too,
    Task46_AbdOrgSegm2.py:133-141). Images without a label are dropped
    (:153-158); pancreas images get their direction/origin aligned to the
    label (:19-26)."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task046_AbdOrgSegm2", raw_data_base)
    pancreas_nifti_dir = _ensure_pancreas_niftis(pancreas_nifti_dir)
    from multitalent_tpu_torch.io.nifti import Geometry, read_nifti, write_nifti

    pan_labels = os.path.join(labels_dir, "label_tciapancreasct_multiorgan",
                              "label_tcia_multiorgan")
    if not os.path.isdir(pan_labels):  # tolerate a flattened download
        pan_labels = os.path.join(labels_dir, "label_tcia_multiorgan")
    for c in subfiles(pancreas_nifti_dir, join=False, suffix=".nii.gz"):
        case = c[:-7]                               # PANCREAS_XXXX
        lab_src = os.path.join(pan_labels, "label" + c[9:])
        if not os.path.isfile(lab_src):
            continue
        lab_out = os.path.join(labelstr, case + ".nii.gz")
        _remap_segmentation(lab_src, lab_out, TASK046_LABEL_REMAP)
        # align image geometry to the label: the TCIA DICOM conversions carry
        # inconsistent direction/origin vs the hand-made labels
        img, igeom = read_nifti(os.path.join(pancreas_nifti_dir, c))
        _, lgeom = read_nifti(lab_out)
        write_nifti(os.path.join(imagestr, case + "_0000.nii.gz"), img,
                    Geometry(spacing=igeom.spacing, origin=lgeom.origin,
                             direction=lgeom.direction))

    btcv_labels = os.path.join(labels_dir, "label_btcv_multiorgan")
    for d in btcv_images_dirs:
        for c in subfiles(d, join=False, suffix=".nii.gz"):
            if not c.startswith("img"):
                continue
            case = c[:-7]                           # imgXXXX
            lab_src = os.path.join(btcv_labels, "label" + c[3:])
            if not os.path.isfile(lab_src):
                continue
            _remap_segmentation(lab_src, os.path.join(labelstr, case + ".nii.gz"),
                                TASK046_LABEL_REMAP)
            shutil.copy(os.path.join(d, c),
                        os.path.join(imagestr, case + "_0000.nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        TASK046_LABEL_NAMES, "AbdOrgSegm2",
        dataset_reference="https://zenodo.org/record/1169361",
        dataset_description="multi-organ labels over TCIA Pancreas-CT and "
                            "BTCV images")
    return out_base


def convert_task051_structseg_thoracic(source_dir: str,
                                       raw_data_base: str | None = None) -> str:
    """StructSeg2019 Task3 Thoracic OAR: per-case folders of
    {data.nii.gz, label.nii.gz} -> Task051
    (Task51_StructSeg2019_Task3_Thoracic_OAR.py:8-41)."""
    out_base, imagestr, imagests, labelstr = _task_layout(
        "Task051_StructSeg2019_Task3_Thoracic_OAR", raw_data_base)
    for c in subdirs(source_dir, join=False):
        shutil.copy(os.path.join(source_dir, c, "data.nii.gz"),
                    os.path.join(imagestr, c + "_0000.nii.gz"))
        shutil.copy(os.path.join(source_dir, c, "label.nii.gz"),
                    os.path.join(labelstr, c + ".nii.gz"))
    generate_dataset_json(
        os.path.join(out_base, "dataset.json"), imagestr, imagests, ("CT",),
        {0: "background", 1: "left lung", 2: "right lung", 3: "heart",
         4: "esophagus", 5: "trachea", 6: "spinal cord"},
        "StructSeg2019_Task3",
        dataset_reference="https://structseg2019.grand-challenge.org/")
    return out_base


CONVERTERS = {
    "Task017": convert_task017_btcv_abdomen,
    "Task018": convert_task018_btcv_cervix,
    "Task046": convert_task046_abdorgsegm2,
    "Task051": convert_task051_structseg_thoracic,
    "Task055": convert_task055_segthor,
    "Task062": convert_task062_nih_pancreas,
    "Task064": convert_task064_kits,
}
