"""The experiment *plans* artifact: the single config object produced by experiment
planning and consumed by preprocessing, training and inference.

Schema-compatible with the reference plans pickle (keys as written by
experiment_planner_baseline_3DUNet.py:341-354 and the per-stage dict at :234-245;
verified against the shipped MultiTalent_plans/MultiTalent_bs4_plans_3D.pkl), so
reference-produced plans files load directly. On top of the raw dict we provide typed
accessors (`Plans`, `StagePlans`) used throughout this framework.

The port's copy of multitalent_tpu/plans.py.
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np


@dataclass
class StagePlans:
    """Per-resolution-stage configuration (reference per-stage dict)."""

    batch_size: int
    patch_size: tuple[int, ...]
    current_spacing: tuple[float, ...]
    original_spacing: tuple[float, ...]
    median_patient_size_in_voxels: tuple[int, ...]
    num_pool_per_axis: list[int]
    pool_op_kernel_sizes: list[list[int]]
    conv_kernel_sizes: list[list[int]]
    do_dummy_2D_data_aug: bool = False
    # residual-encoder (FabiansUNet) plans carry per-stage block counts
    # (reference: alternative_experiment_planning/experiment_planner_residual_3DUNet_v21.py)
    num_blocks_encoder: tuple[int, ...] | None = None
    num_blocks_decoder: tuple[int, ...] | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "StagePlans":
        nbe = d.get("num_blocks_encoder")
        nbd = d.get("num_blocks_decoder")
        return cls(
            num_blocks_encoder=tuple(int(x) for x in nbe) if nbe is not None else None,
            num_blocks_decoder=tuple(int(x) for x in nbd) if nbd is not None else None,
            batch_size=int(d["batch_size"]),
            patch_size=tuple(int(x) for x in d["patch_size"]),
            current_spacing=tuple(float(x) for x in d["current_spacing"]),
            original_spacing=tuple(float(x) for x in d["original_spacing"]),
            median_patient_size_in_voxels=tuple(
                int(x) for x in d.get("median_patient_size_in_voxels", ())
            ),
            num_pool_per_axis=[int(x) for x in d["num_pool_per_axis"]],
            pool_op_kernel_sizes=[[int(x) for x in k] for k in d["pool_op_kernel_sizes"]],
            conv_kernel_sizes=[[int(x) for x in k] for k in d["conv_kernel_sizes"]],
            do_dummy_2D_data_aug=bool(d.get("do_dummy_2D_data_aug", False)),
        )

    def to_dict(self) -> dict[str, Any]:
        d: dict[str, Any] = {}
        if self.num_blocks_encoder is not None:
            d["num_blocks_encoder"] = tuple(self.num_blocks_encoder)
        if self.num_blocks_decoder is not None:
            d["num_blocks_decoder"] = tuple(self.num_blocks_decoder)
        return d | {
            "batch_size": self.batch_size,
            "num_pool_per_axis": list(self.num_pool_per_axis),
            "patch_size": np.array(self.patch_size),
            "median_patient_size_in_voxels": np.array(self.median_patient_size_in_voxels),
            "current_spacing": np.array(self.current_spacing),
            "original_spacing": np.array(self.original_spacing),
            "do_dummy_2D_data_aug": self.do_dummy_2D_data_aug,
            "pool_op_kernel_sizes": [list(k) for k in self.pool_op_kernel_sizes],
            "conv_kernel_sizes": [list(k) for k in self.conv_kernel_sizes],
        }

    @property
    def num_stages_down(self) -> int:
        return len(self.pool_op_kernel_sizes)


@dataclass
class Plans:
    """Full plans artifact. `raw` preserves every key from a loaded reference pickle so
    round-tripping is lossless; the typed fields mirror the keys we actually consume."""

    num_stages: int
    num_modalities: int
    modalities: dict[int, str]
    normalization_schemes: dict[int, str]
    num_classes: int
    all_classes: list[int]
    base_num_features: int
    use_mask_for_norm: dict[int, bool]
    transpose_forward: list[int]
    transpose_backward: list[int]
    data_identifier: str
    plans_per_stage: dict[int, StagePlans]
    preprocessor_name: str = "GenericPreprocessor"
    conv_per_stage: int = 2
    dataset_properties: dict[str, Any] = field(default_factory=dict)
    raw: dict[str, Any] = field(default_factory=dict, repr=False)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Plans":
        return cls(
            num_stages=int(d["num_stages"]),
            num_modalities=int(d["num_modalities"]),
            modalities={int(k): v for k, v in d["modalities"].items()},
            normalization_schemes={int(k): v for k, v in d["normalization_schemes"].items()},
            num_classes=int(d["num_classes"]),
            all_classes=[int(x) for x in d["all_classes"]],
            base_num_features=int(d["base_num_features"]),
            use_mask_for_norm={int(k): bool(v) for k, v in d["use_mask_for_norm"].items()},
            transpose_forward=[int(x) for x in d["transpose_forward"]],
            transpose_backward=[int(x) for x in d["transpose_backward"]],
            data_identifier=str(d["data_identifier"]),
            plans_per_stage={
                int(k): StagePlans.from_dict(v) for k, v in d["plans_per_stage"].items()
            },
            preprocessor_name=str(d.get("preprocessor_name", "GenericPreprocessor")),
            conv_per_stage=int(d.get("conv_per_stage", 2)),
            dataset_properties=d.get("dataset_properties", {}),
            raw=dict(d),
        )

    def to_dict(self) -> dict[str, Any]:
        d = dict(self.raw)
        d.update(
            {
                "num_stages": self.num_stages,
                "num_modalities": self.num_modalities,
                "modalities": self.modalities,
                "normalization_schemes": self.normalization_schemes,
                "num_classes": self.num_classes,
                "all_classes": self.all_classes,
                "base_num_features": self.base_num_features,
                "use_mask_for_norm": self.use_mask_for_norm,
                "transpose_forward": self.transpose_forward,
                "transpose_backward": self.transpose_backward,
                "data_identifier": self.data_identifier,
                "plans_per_stage": {k: v.to_dict() for k, v in self.plans_per_stage.items()},
                "preprocessor_name": self.preprocessor_name,
                "conv_per_stage": self.conv_per_stage,
                "dataset_properties": self.dataset_properties,
            }
        )
        return d

    def stage(self, i: int) -> StagePlans:
        return self.plans_per_stage[i]


def load_plans(path: str | Path) -> Plans:
    with open(path, "rb") as f:
        d = pickle.load(f)
    return Plans.from_dict(d)


def save_plans(plans: Plans | dict[str, Any], path: str | Path) -> None:
    d = plans.to_dict() if isinstance(plans, Plans) else plans
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(d, f)
