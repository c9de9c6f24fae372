"""Task100_MultiTalent: the 13-dataset partially-labeled CT collection.

This module holds the label/region tables that define the merged task and the pure
helpers built on top of them. The tables are *facts about the public datasets* and
must match the reference bit-for-bit for label-map interoperability
(dataset_conversion/Task100_MultiTalent.py:35-215):

- 13 source tasks; each task's original labels are remapped into a global label
  space 1..47 (`TASK_LABEL_MAPS`)
- 47 *regions*, each a tuple of global labels OR-ed together (e.g. the '03_liver'
  region is labels (1, 2) = liver-without-tumor + tumor); regions are the network's
  sigmoid output channels, ordered by `REGION_OUTPUT_IDX`
- per task: which regions carry annotations (`VALID_REGIONS`) and the class order
  used when merging region channels back into a single labelmap for export
  (`REGIONS_CLASS_ORDER`)

The port's copy of multitalent_tpu/tasks/multitalent.py; `label_region_matrix` builds the table
with the port's training/losses.py.
"""
from __future__ import annotations

import numpy as np

TASK_IDS: list[str] = [
    "Task003_Liver", "Task006_Lung", "Task007_Pancreas", "Task008_HepaticVessel",
    "Task009_Spleen", "Task010_Colon", "Task017_AbdominalOrganSegmentation",
    "Task046_AbdOrgSegm2", "Task051_StructSeg2019_Task3_Thoracic_OAR",
    "Task055_SegTHOR", "Task062_NIHPancreas", "Task064_KiTS_labelsFixed",
    "Task018_PelvicOrganSegmentation",
]

# task -> (original labels, corresponding global labels)
TASK_LABEL_MAPS: dict[str, tuple[tuple[int, ...], tuple[int, ...]]] = {
    "Task003_Liver": ((1, 2), (1, 2)),
    "Task006_Lung": ((1,), (3,)),
    "Task007_Pancreas": ((1, 2), (4, 5)),
    "Task008_HepaticVessel": ((1, 2), (6, 7)),
    "Task009_Spleen": ((1,), (8,)),
    "Task010_Colon": ((1,), (9,)),
    "Task017_AbdominalOrganSegmentation": (tuple(range(1, 14)), tuple(range(10, 23))),
    "Task046_AbdOrgSegm2": (tuple(range(1, 9)), tuple(range(23, 31))),
    "Task051_StructSeg2019_Task3_Thoracic_OAR": (tuple(range(1, 7)), tuple(range(31, 37))),
    "Task055_SegTHOR": (tuple(range(1, 5)), tuple(range(37, 41))),
    "Task062_NIHPancreas": ((1,), (41,)),
    "Task064_KiTS_labelsFixed": ((1, 2), (42, 43)),
    "Task018_PelvicOrganSegmentation": (tuple(range(1, 5)), tuple(range(44, 48))),
}

GLOBAL_LABEL_NAMES: dict[int, str] = {
    1: "03_liver_wo_cancer", 2: "03_liver_tumor", 3: "06_lung_nodule",
    4: "07_pancreas_wo_cancer", 5: "07_pancreas_cancer", 6: "08_hepatic_vessel",
    7: "08_liver_cancer", 8: "09_spleen", 9: "10_colon_cancer",
    10: "17_spleen", 11: "17_right_kidney", 12: "17_left_kidney",
    13: "17_gallbladder", 14: "17_esophagus", 15: "17_liver_whole",
    16: "17_stomach", 17: "17_aorta", 18: "17_inf_vena_cava",
    19: "17_port_and_splen_vein", 20: "17_pancreas_whole",
    21: "17_right_adrenal_gland", 22: "17_left_adrenal_gland",
    23: "46_spleen", 24: "46_left_kidney", 25: "46_gallbladder",
    26: "46_esophagus", 27: "46_liver", 28: "46_stomach", 29: "46_pancreas",
    30: "46_duodenum", 31: "51_left_lung", 32: "51_right_lung", 33: "51_heart",
    34: "51_esophagus", 35: "51_bronchies", 36: "51_spinal_cord_nerve_thingy",
    37: "55_esophagus", 38: "55_heart", 39: "55_trachea", 40: "55_aorta",
    41: "62_pancreas", 42: "64_both_kidneys_wo_tumor", 43: "64_kidney_tumor",
    44: "18_bladder", 45: "18_uterus", 46: "18_rectum", 47: "18_small_bowel",
}

# region name -> tuple of global labels OR-ed into that output channel
REGIONS: dict[str, tuple[int, ...]] = {
    "03_liver": (1, 2), "03_cancer": (2,), "06_lungnodule": (3,),
    "07_pancreas": (4, 5), "07_pancreas_cancer": (5,), "08_vessel": (6,),
    "08_tumor": (7,), "09_spleen": (8,), "10_colon_cancer": (9,),
    "17_spleen": (10,), "17_right_kidney": (11,), "17_left_kidney": (12,),
    "17_gallbladder": (13,), "17_esophagus": (14,), "17_liver": (15,),
    "17_stomach": (16,), "17_aorta": (17,), "17_inf_vena_cava": (18,),
    "17_port_and_splen_vein": (19,), "17_pancreas": (20,),
    "17_right_adrenal_gland": (21,), "17_left_adrenal_gland": (22,),
    "46_spleen": (23,), "46_left_kidney": (24,), "46_gallbladder": (25,),
    "46_esophagus": (26,), "46_liver": (27,), "46_stomach": (28,),
    "46_pancreas": (29,), "46_duodenum": (30,), "51_left_lung": (31,),
    "51_right_lung": (32,), "51_heart": (33,), "51_esophagus": (34,),
    "51_bronchies": (35,), "51_spinal_cord_nerve_thingy": (36,),
    "55_esophagus": (37,), "55_heart": (38,), "55_trachea": (39,),
    "55_aorta": (40,), "62_pancreas": (41,), "64_both_kidneys": (42, 43),
    "64_kidney_tumor": (43,), "18_bladder": (44,), "18_uterus": (45,),
    "18_rectum": (46,), "18_small_bowel": (47,),
}

NUM_REGIONS = len(REGIONS)
NUM_GLOBAL_LABELS = 47

# region name -> sigmoid output channel (insertion order of REGIONS)
REGION_OUTPUT_IDX: dict[str, int] = {r: i for i, r in enumerate(REGIONS)}

# task -> regions annotated in that task's ground truth
VALID_REGIONS: dict[str, tuple[str, ...]] = {
    "Task003_Liver": ("03_liver", "03_cancer"),
    "Task006_Lung": ("06_lungnodule",),
    "Task007_Pancreas": ("07_pancreas", "07_pancreas_cancer"),
    "Task008_HepaticVessel": ("08_vessel", "08_tumor"),
    "Task009_Spleen": ("09_spleen",),
    "Task010_Colon": ("10_colon_cancer",),
    "Task017_AbdominalOrganSegmentation": (
        "17_spleen", "17_right_kidney", "17_left_kidney", "17_gallbladder",
        "17_esophagus", "17_liver", "17_stomach", "17_aorta", "17_inf_vena_cava",
        "17_port_and_splen_vein", "17_pancreas", "17_right_adrenal_gland",
        "17_left_adrenal_gland"),
    "Task046_AbdOrgSegm2": ("46_spleen", "46_left_kidney", "46_gallbladder",
                            "46_esophagus", "46_liver", "46_stomach",
                            "46_pancreas", "46_duodenum"),
    "Task051_StructSeg2019_Task3_Thoracic_OAR": (
        "51_left_lung", "51_right_lung", "51_heart", "51_esophagus",
        "51_bronchies", "51_spinal_cord_nerve_thingy"),
    "Task055_SegTHOR": ("55_esophagus", "55_heart", "55_trachea", "55_aorta"),
    "Task062_NIHPancreas": ("62_pancreas",),
    "Task064_KiTS_labelsFixed": ("64_both_kidneys", "64_kidney_tumor"),
    "Task018_PelvicOrganSegmentation": ("18_bladder", "18_uterus", "18_rectum",
                                        "18_small_bowel"),
}

# task -> global-label order used when collapsing region channels into one labelmap
REGIONS_CLASS_ORDER: dict[str, tuple[int, ...]] = {
    t: TASK_LABEL_MAPS[t][1] for t in TASK_IDS
}


def sanity_checks() -> None:
    """Cross-table consistency (Task100_MultiTalent.py:210-215): the labels reachable
    through a task's valid regions must be exactly the task's global labels."""
    for t, regions in VALID_REGIONS.items():
        labels = sorted({l for r in regions for l in REGIONS[r]})
        target = TASK_LABEL_MAPS[t][1]
        assert len(labels) == len(target), t
        assert all(l in target for l in labels), t


def label_region_matrix() -> np.ndarray:
    """(48, 47) binary matrix mapping global label -> region output channels; the
    vectorized replacement for the reference's per-region OR loops."""
    from multitalent_tpu_torch.training.losses import build_label_region_matrix
    return build_label_region_matrix(REGIONS, REGION_OUTPUT_IDX, NUM_GLOBAL_LABELS)


def valid_region_mask(valid_regions: list[tuple[str, ...]]) -> np.ndarray:
    """(B, 47) float mask from per-sample valid-region name tuples."""
    m = np.zeros((len(valid_regions), NUM_REGIONS), np.float32)
    for b, regions in enumerate(valid_regions):
        for r in regions:
            m[b, REGION_OUTPUT_IDX[r]] = 1.0
    return m


def task_of_case(case_id: str) -> str:
    """Cases are named '<task_id3digits>_<original id>'; returns e.g. '003'."""
    return case_id.split("_")[0]


def inverse_sqrt_sampling_probabilities(keys: list[str]) -> np.ndarray:
    """Dataset-balanced sampling: p(case) proportional to 1/sqrt(#cases in its source
    dataset), normalized (MultiTalent_Trainer_DDP.get_basic_generators:625-645)."""
    prefixes = [task_of_case(k) for k in keys]
    counts: dict[str, int] = {}
    for p in prefixes:
        counts[p] = counts.get(p, 0) + 1
    probs = np.array([1.0 / np.sqrt(counts[p]) for p in prefixes])
    return probs / probs.sum()


def attach_region_annotations(properties: dict, case_id: str) -> dict:
    """Stamp `valid_labels`/`valid_regions` into a case-properties dict based on the
    case's source task (Task100_MultiTalent_addregions.py:14-36)."""
    prefix = task_of_case(case_id)
    task = next(t for t in TASK_IDS if t.startswith(f"Task{prefix}"))
    properties = dict(properties)
    properties["valid_labels"] = list(TASK_LABEL_MAPS[task][1])
    properties["valid_regions"] = tuple(VALID_REGIONS[task])
    return properties


def convert_source_segmentation(seg: np.ndarray, task: str) -> np.ndarray:
    """Remap a source task's label values into the global 1..47 space
    (copy_and_convert_segmentation parity, Task100_MultiTalent.py:229-275)."""
    src, dst = TASK_LABEL_MAPS[task]
    out = np.zeros_like(seg)
    for s, d in zip(src, dst):
        out[seg == s] = d
    unexpected = set(np.unique(seg).tolist()) - set(src) - {0}
    if unexpected:
        raise ValueError(f"{task}: unexpected source labels {sorted(unexpected)}")
    return out


def build_custom_splits(keys: list[str], per_task_splits: dict[int, list[dict]],
                        seed: int = 1234) -> list[dict]:
    """The 12-fold MultiTalent split scheme (MultiTalent_Trainer_DDP.do_split:433-518):

    folds 0-4: a 5-fold CV stitched from each source dataset's own splits_final
    (`per_task_splits[task_id]`, case ids WITHOUT the task prefix). Task046 is
    special-cased: its cases that originate from Task017 follow the Task017 split,
    the genuinely-new cases (prefix '046_PAN') are dealt round-robin into the folds
    after a seeded shuffle, and Task017 *test-set* images hiding in Task046 are
    excluded. folds 5-11: leave-one-dataset-out with train == val (pseudo-'all'),
    dropping Task003 / Task017(+046_img) / Task064 / Task010 / Task007 / Task055 /
    Task008 respectively.
    """
    fivefold = [{"train": [], "val": []} for _ in range(5)]
    task_ids = sorted({int(task_of_case(k)) for k in keys})
    for task_id in task_ids:
        if task_id != 46:
            splits_t = per_task_splits[task_id]
            for f in range(5):
                fivefold[f]["train"] += ["%03.0d_" % task_id + i for i in splits_t[f]["train"]]
                fivefold[f]["val"] += ["%03.0d_" % task_id + i for i in splits_t[f]["val"]]
        else:
            remaining = [k for k in keys if k.startswith("046_PAN")]
            rs = np.random.RandomState(seed)
            rs.shuffle(remaining)
            t17 = per_task_splits[17]
            for f in range(5):
                fivefold[f]["train"] += ["%03.0d_" % 46 + i for i in t17[f]["train"]]
                fivefold[f]["val"] += ["%03.0d_" % 46 + i for i in t17[f]["val"]]
                sel_val = remaining[f::5]
                fivefold[f]["train"] += [i for i in remaining if i not in sel_val]
                fivefold[f]["val"] += sel_val

    def leave_out(*prefixes):
        kept = [k for k in keys if not any(k.startswith(p) for p in prefixes)]
        return {"train": kept, "val": kept}

    custom = [
        leave_out("003_"),
        leave_out("017_", "046_img"),  # 046_img* are Task017 images inside Task046
        leave_out("064_"),
        leave_out("010_"),
        leave_out("007_"),
        leave_out("055_"),
        leave_out("008_"),
    ]
    return fivefold + custom


sanity_checks()
