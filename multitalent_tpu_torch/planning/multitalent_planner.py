"""MultiTalent task-specific planner and pretrained-plans transplanting.

Parity targets:
- ExperimentPlanner3D_v21_MultiTalent
  (task_specific_planner/MultiTalent/MultiTalent_planner.py:33-131): fixed target
  spacing (1.5, 1, 1), 15/8x memory budget (allows patch 96x192x192), batch size
  hardcoded to 4 (distributed across devices with --dbs), data identifier
  'MultiTalent_data', plans file 'MultiTalent_bs4_plans_3D.pkl'.
- ExperimentPlanner3D_v21_Pretrained
  (alternative_experiment_planning/experiment_planner_pretrained.py:20 and the
  MultiTalent copy): reuse a source plans file on a new dataset so architecture and
  weights transfer; only num_classes/classes/normalization stay dataset-specific.

The port's copy of multitalent_tpu/planning/multitalent_planner.py.
"""
from __future__ import annotations

import os

import numpy as np

from multitalent_tpu_torch.planning import net_topology as nt
from multitalent_tpu_torch.planning.experiment_planner import ExperimentPlanner3Dv21
from multitalent_tpu_torch.utils import load_pickle


class MultiTalentPlanner(ExperimentPlanner3Dv21):
    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        # keep 30 base features (ExperimentPlanner base default): the MultiTalent plans
        # were generated before the 32-feature bump and the shipped pkl says 30
        self.unet_base_num_features = nt.BASE_NUM_FEATURES
        self.data_identifier = "MultiTalent_data"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MultiTalent_bs4_plans_3D.pkl")
        self.fixed_batch_size = 4

    def memory_budget(self) -> float:
        return nt.MEMORY_BUDGET_3D * 15 / 8

    def get_target_spacing(self) -> np.ndarray:
        return np.array([1.5, 1.0, 1.0])

    def get_properties_for_stage(self, *args, **kwargs) -> dict:
        plan = super().get_properties_for_stage(*args, **kwargs)
        plan["batch_size"] = self.fixed_batch_size
        return plan


class PretrainedPlanner(ExperimentPlanner3Dv21):
    """Transplant an existing plans file onto a new dataset for fine-tuning: everything
    except num_classes/all_classes (and dataset bookkeeping) comes from the source
    plans, so the network topology matches the pretrained weights exactly."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder,
                 pretrained_plans_file: str, pretrained_name: str):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        assert os.path.isfile(pretrained_plans_file), pretrained_plans_file
        self.pretrained_plans_file = pretrained_plans_file
        self.pretrained_name = pretrained_name
        self.data_identifier = "MTTPUData_pretrained_" + pretrained_name
        self.plans_fname = os.path.join(
            preprocessed_output_folder,
            f"MTTPUPlans_pretrained_{pretrained_name}_plans_3D.pkl")

    def load_pretrained_plans(self) -> dict:
        num_classes = self.plans["num_classes"]
        all_classes = self.plans["all_classes"]
        source = load_pickle(self.pretrained_plans_file)
        self.plans.update({k: source[k] for k in (
            "num_stages", "num_modalities", "modalities", "normalization_schemes",
            "base_num_features", "use_mask_for_norm", "keep_only_largest_region",
            "min_region_size_per_class", "min_size_per_class", "transpose_forward",
            "transpose_backward", "plans_per_stage", "preprocessor_name",
            "conv_per_stage",
        )})
        self.plans["num_classes"] = num_classes
        self.plans["all_classes"] = all_classes
        self.plans["data_identifier"] = self.data_identifier
        self.transpose_forward = self.plans["transpose_forward"]
        self.transpose_backward = self.plans["transpose_backward"]
        self.plans_per_stage = self.plans["plans_per_stage"]
        self.preprocessor_name = self.plans["preprocessor_name"]
        self.save_my_plans()
        return self.plans

    def plan_experiment(self):
        super().plan_experiment()
        return self.load_pretrained_plans()
