"""Self-configuring experiment planners.

Parity targets: nnunet/experiment_planning/experiment_planner_baseline_3DUNet.py:32-444
(base), experiment_planner_baseline_3DUNet_v21.py:24-179 (v21, the default). Given a
dataset fingerprint, decide target spacing, axis transpose, patch size, pooling
topology, batch size, normalization schemes, and optionally a lowres cascade stage,
then write the plans pickle and drive preprocessing.

The shrink-to-fit loop reduces the patch axis that is largest relative to the median
shape until the architecture memory proxy fits the budget; it is shared by all planners
here instead of being re-stated per subclass.

The port's copy of multitalent_tpu/planning/experiment_planner.py; the JAX
package's registry of planners becomes the table of planning/planners.py.
"""
from __future__ import annotations

import os
import shutil

import numpy as np

from multitalent_tpu_torch.paths import default_num_threads
from multitalent_tpu_torch.planning import net_topology as nt
from multitalent_tpu_torch.preprocessing.cropping import get_case_identifier_from_npz
from multitalent_tpu_torch.preprocessing.preprocessor import resolve_preprocessor
from multitalent_tpu_torch.utils import load_pickle, save_pickle, subfiles


def shrink_patch_to_fit(input_patch_size, new_median_shape, current_spacing, memory_budget,
                        base_num_features, max_num_filters, num_modalities, num_classes,
                        conv_per_stage, min_feature_map_size, max_numpool, topology_fn):
    """Iteratively shrink the patch axis that exceeds the median shape the most until
    the memory proxy fits `memory_budget`. Returns the final topology tuple plus the
    final proxy value. (Shared core of get_properties_for_stage across planners.)"""
    num_pool_per_axis, pool_ops, conv_ks, new_shp, must_div = topology_fn(
        current_spacing, input_patch_size, min_feature_map_size, max_numpool)
    here = nt.compute_memory_proxy(new_shp, num_pool_per_axis, base_num_features,
                                   max_num_filters, num_modalities, num_classes,
                                   pool_ops, conv_per_stage=conv_per_stage)
    while here > memory_budget:
        axis_to_reduce = int(np.argsort(new_shp / new_median_shape)[-1])
        tmp = new_shp.copy()
        tmp[axis_to_reduce] -= must_div[axis_to_reduce]
        _, _, _, _, must_div_new = topology_fn(
            current_spacing, tmp, min_feature_map_size, max_numpool)
        new_shp[axis_to_reduce] -= must_div_new[axis_to_reduce]
        num_pool_per_axis, pool_ops, conv_ks, new_shp, must_div = topology_fn(
            current_spacing, new_shp, min_feature_map_size, max_numpool)
        here = nt.compute_memory_proxy(new_shp, num_pool_per_axis, base_num_features,
                                       max_num_filters, num_modalities, num_classes,
                                       pool_ops, conv_per_stage=conv_per_stage)
    return num_pool_per_axis, pool_ops, conv_ks, new_shp, here


def initial_isotropic_patch(current_spacing, new_median_shape) -> list[int]:
    """Starting patch: isotropic 512mm cube in voxels of `current_spacing`, clipped to
    the median shape (experiment_planner_baseline_3DUNet.py:170-180)."""
    ips = 1.0 / np.asarray(current_spacing, dtype=np.float64)
    ips = ips / ips.mean()
    ips = ips * (1.0 / ips.min()) * 512
    ips = np.round(ips).astype(int)
    return [int(min(i, j)) for i, j in zip(ips, new_median_shape)]


class ExperimentPlannerBase:
    """3D baseline planner (pool-late topology)."""

    topology = staticmethod(
        lambda spacing, patch, minfm, maxpool: nt.get_pool_and_conv_props_poolLateV2(
            patch, minfm, maxpool, spacing))

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        self.folder_with_cropped_data = folder_with_cropped_data
        self.preprocessed_output_folder = preprocessed_output_folder
        self.list_of_cropped_npz_files = subfiles(folder_with_cropped_data, suffix=".npz")
        self.preprocessor_name = "GenericPreprocessor"
        props_path = os.path.join(folder_with_cropped_data, "dataset_properties.pkl")
        assert os.path.isfile(props_path), \
            "folder_with_cropped_data must contain dataset_properties.pkl"
        self.dataset_properties = load_pickle(props_path)

        self.plans_per_stage: dict = {}
        self.plans: dict = {}
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansfixed_plans_3D.pkl")
        self.data_identifier = "MTTPUData_plans_v2.1"

        self.transpose_forward = [0, 1, 2]
        self.transpose_backward = [0, 1, 2]

        self.unet_base_num_features = nt.BASE_NUM_FEATURES
        self.unet_max_num_filters = 320
        self.unet_max_numpool = 999
        self.unet_min_batch_size = 2
        self.unet_featuremap_min_edge_length = 4

        self.target_spacing_percentile = 50
        self.anisotropy_threshold = 3
        self.how_much_of_a_patient_must_the_network_see_at_stage0 = 4
        self.batch_size_covers_max_percent_of_dataset = 0.05
        self.conv_per_stage = 2

    # --- decisions ---------------------------------------------------------------
    def memory_budget(self) -> float:
        return nt.MEMORY_BUDGET_3D

    def get_target_spacing(self) -> np.ndarray:
        spacings = self.dataset_properties["all_spacings"]
        return np.percentile(np.vstack(spacings), self.target_spacing_percentile, 0)

    def determine_normalization_scheme(self) -> dict:
        modalities = self.dataset_properties["modalities"]
        schemes = {}
        for i in range(len(modalities)):
            if modalities[i].lower() == "ct":
                schemes[i] = "CT"
            elif modalities[i] == "noNorm":
                schemes[i] = "noNorm"
            else:
                schemes[i] = "nonCT"
        return schemes

    def determine_whether_to_use_mask_for_norm(self) -> dict:
        """Use the nonzero mask for normalization only if cropping shrank cases a lot
        (BraTS-like data) and the modality is not CT."""
        modalities = self.dataset_properties["modalities"]
        use = {}
        reductions = list(self.dataset_properties["size_reductions"].values())
        for i in range(len(modalities)):
            if "CT" in modalities[i]:
                use[i] = False
            else:
                use[i] = bool(np.median(reductions) < 3 / 4.0)
        # stamp the decision into every cropped case's properties for later reuse
        for c in self.list_of_cropped_npz_files:
            ident = get_case_identifier_from_npz(c)
            pkl = os.path.join(self.folder_with_cropped_data, ident + ".pkl")
            props = load_pickle(pkl)
            props["use_nonzero_mask_for_norm"] = use
            save_pickle(props, pkl)
        return use

    def get_properties_for_stage(self, current_spacing, original_spacing, original_shape,
                                 num_cases, num_modalities, num_classes) -> dict:
        new_median_shape = np.round(
            np.asarray(original_spacing) / np.asarray(current_spacing) * original_shape
        ).astype(int)
        dataset_num_voxels = np.prod(new_median_shape, dtype=np.int64) * num_cases
        input_patch_size = initial_isotropic_patch(current_spacing, new_median_shape)

        ref = self.memory_budget()
        num_pool_per_axis, pool_ops, conv_ks, new_shp, here = shrink_patch_to_fit(
            input_patch_size, new_median_shape, current_spacing, ref,
            self.unet_base_num_features, self.unet_max_num_filters, num_modalities,
            num_classes, self.conv_per_stage, self.unet_featuremap_min_edge_length,
            self.unet_max_numpool, self.topology)

        batch_size = int(np.floor(max(ref / here, 1) * nt.DEFAULT_BATCH_SIZE_3D))
        max_batch_size = int(np.round(self.batch_size_covers_max_percent_of_dataset
                                      * dataset_num_voxels
                                      / np.prod(new_shp, dtype=np.int64)))
        max_batch_size = max(max_batch_size, self.unet_min_batch_size)
        batch_size = max(1, min(batch_size, max_batch_size))

        do_dummy_2D = (max(new_shp) / new_shp[0]) > self.anisotropy_threshold
        return {
            "batch_size": batch_size,
            "num_pool_per_axis": num_pool_per_axis,
            "patch_size": new_shp,
            "median_patient_size_in_voxels": new_median_shape,
            "current_spacing": np.asarray(current_spacing, dtype=np.float64),
            "original_spacing": np.asarray(original_spacing, dtype=np.float64),
            "do_dummy_2D_data_aug": bool(do_dummy_2D),
            "pool_op_kernel_sizes": pool_ops,
            "conv_kernel_sizes": conv_ks,
        }

    # --- main entry ----------------------------------------------------------------
    def plan_experiment(self) -> dict:
        use_mask_for_norm = self.determine_whether_to_use_mask_for_norm()
        spacings = self.dataset_properties["all_spacings"]
        sizes = self.dataset_properties["all_sizes"]
        all_classes = self.dataset_properties["all_classes"]
        modalities = self.dataset_properties["modalities"]
        num_modalities = len(modalities)

        target_spacing = self.get_target_spacing()
        new_shapes = [np.array(sp) / target_spacing * np.array(sz)
                      for sp, sz in zip(spacings, sizes)]

        # transpose so the coarsest-spacing axis comes first
        max_spacing_axis = int(np.argmax(target_spacing))
        remaining = [i for i in range(3) if i != max_spacing_axis]
        self.transpose_forward = [max_spacing_axis] + remaining
        self.transpose_backward = [self.transpose_forward.index(i) for i in range(3)]

        median_shape = np.median(np.vstack(new_shapes), 0)
        target_spacing_t = np.array(target_spacing)[self.transpose_forward]
        median_shape_t = np.array(median_shape)[self.transpose_forward]

        stages = [self.get_properties_for_stage(
            target_spacing_t, target_spacing_t, median_shape_t,
            len(self.list_of_cropped_npz_files), num_modalities, len(all_classes) + 1)]

        # add a lowres cascade stage if a fullres patch sees too little of the patient
        architecture_input_voxels = np.prod(stages[-1]["patch_size"], dtype=np.int64)
        if (np.prod(median_shape) / architecture_input_voxels
                >= self.how_much_of_a_patient_must_the_network_see_at_stage0):
            lowres_spacing = np.array(target_spacing, dtype=np.float64)
            num_voxels = np.prod(median_shape, dtype=np.float64)
            new = None
            while num_voxels > (self.how_much_of_a_patient_must_the_network_see_at_stage0
                                * architecture_input_voxels):
                max_sp = lowres_spacing.max()
                grow = (max_sp / lowres_spacing) > 2
                if np.any(grow):
                    lowres_spacing[grow] *= 1.01
                else:
                    lowres_spacing *= 1.01
                num_voxels = np.prod(target_spacing / lowres_spacing * median_shape,
                                     dtype=np.float64)
                new = self.get_properties_for_stage(
                    np.array(lowres_spacing)[self.transpose_forward], target_spacing_t,
                    median_shape_t, len(self.list_of_cropped_npz_files),
                    num_modalities, len(all_classes) + 1)
                architecture_input_voxels = np.prod(new["patch_size"], dtype=np.int64)
            if new is not None and (
                    2 * np.prod(new["median_patient_size_in_voxels"], dtype=np.int64)
                    < np.prod(stages[0]["median_patient_size_in_voxels"], dtype=np.int64)):
                stages.append(new)

        stages = stages[::-1]  # stage 0 = lowres (if present), last = fullres
        self.plans_per_stage = {i: s for i, s in enumerate(stages)}

        self.plans = {
            "num_stages": len(stages),
            "num_modalities": num_modalities,
            "modalities": modalities,
            "normalization_schemes": self.determine_normalization_scheme(),
            "dataset_properties": self.dataset_properties,
            "list_of_npz_files": self.list_of_cropped_npz_files,
            "original_spacings": spacings,
            "original_sizes": sizes,
            "preprocessed_data_folder": self.preprocessed_output_folder,
            "num_classes": len(all_classes),
            "all_classes": all_classes,
            "base_num_features": self.unet_base_num_features,
            "use_mask_for_norm": use_mask_for_norm,
            "keep_only_largest_region": None,
            "min_region_size_per_class": None,
            "min_size_per_class": None,
            "transpose_forward": self.transpose_forward,
            "transpose_backward": self.transpose_backward,
            "data_identifier": self.data_identifier,
            "plans_per_stage": self.plans_per_stage,
            "preprocessor_name": self.preprocessor_name,
            "conv_per_stage": self.conv_per_stage,
        }
        self.save_my_plans()
        return self.plans

    def save_my_plans(self):
        save_pickle(self.plans, self.plans_fname)

    def load_my_plans(self):
        self.plans = load_pickle(self.plans_fname)
        self.plans_per_stage = self.plans["plans_per_stage"]
        self.dataset_properties = self.plans["dataset_properties"]
        self.transpose_forward = self.plans["transpose_forward"]
        self.transpose_backward = self.plans["transpose_backward"]

    def run_preprocessing(self, num_threads):
        gt_dst = os.path.join(self.preprocessed_output_folder, "gt_segmentations")
        gt_src = os.path.join(self.folder_with_cropped_data, "gt_segmentations")
        if os.path.isdir(gt_dst):
            shutil.rmtree(gt_dst)
        if os.path.isdir(gt_src):
            shutil.copytree(gt_src, gt_dst)
        preprocessor_class = resolve_preprocessor(self.preprocessor_name)
        preprocessor = preprocessor_class(
            self.plans["normalization_schemes"], self.plans["use_mask_for_norm"],
            self.transpose_forward, self.plans["dataset_properties"]["intensityproperties"])
        target_spacings = [v["current_spacing"] for v in self.plans_per_stage.values()]
        if self.plans["num_stages"] > 1 and not isinstance(num_threads, (list, tuple)):
            num_threads = (default_num_threads, num_threads)
        elif self.plans["num_stages"] == 1 and isinstance(num_threads, (list, tuple)):
            num_threads = num_threads[-1]
        preprocessor.run(target_spacings, self.folder_with_cropped_data,
                         self.preprocessed_output_folder, self.plans["data_identifier"],
                         num_threads)


class ExperimentPlanner3Dv21(ExperimentPlannerBase):
    """Default 3D planner: spacing-aware pooling, anisotropy-aware target spacing,
    32 base features (parity: experiment_planner_baseline_3DUNet_v21.py:24-179)."""

    topology = staticmethod(nt.get_pool_and_conv_props)

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.1"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_plans_3D.pkl")
        self.unet_base_num_features = 32

    def memory_budget(self) -> float:
        # computed as if 30 features were used (fp16/bf16 headroom rationale)
        return nt.MEMORY_BUDGET_3D * self.unet_base_num_features / nt.BASE_NUM_FEATURES

    def get_target_spacing(self) -> np.ndarray:
        """Median spacing per axis, except for strongly anisotropic datasets where the
        coarse axis gets the 10th-percentile spacing instead (keeps thin-slice cases
        from being destroyed by interpolation)."""
        spacings = self.dataset_properties["all_spacings"]
        sizes = self.dataset_properties["all_sizes"]
        target = np.percentile(np.vstack(spacings), self.target_spacing_percentile, 0)
        target_size = np.percentile(np.vstack(sizes), self.target_spacing_percentile, 0)

        worst_axis = int(np.argmax(target))
        other_axes = [i for i in range(len(target)) if i != worst_axis]
        other_spacings = [target[i] for i in other_axes]
        other_sizes = [target_size[i] for i in other_axes]
        has_aniso_spacing = target[worst_axis] > (self.anisotropy_threshold * max(other_spacings))
        has_aniso_voxels = target_size[worst_axis] * self.anisotropy_threshold < min(other_sizes)
        if has_aniso_spacing and has_aniso_voxels:
            spacing_axis = np.vstack(spacings)[:, worst_axis]
            target_axis = np.percentile(spacing_axis, 10)
            if target_axis < max(other_spacings):
                target_axis = max(max(other_spacings), target_axis) + 1e-5
            target[worst_axis] = target_axis
        return target


class ExperimentPlanner2Dv21(ExperimentPlanner3Dv21):
    """2D configuration planner (experiment_planner_baseline_2DUNet_v21.py parity):
    slices are training samples, patches cover the in-plane axes at the 3D target
    spacing, batch size starts at 50 capped by the dataset-coverage rule, and
    PreprocessorFor2D keeps the through-plane axis unresampled."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.1_2D"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_plans_2D.pkl")
        self.preprocessor_name = "PreprocessorFor2D"
        self.unet_max_num_filters = nt.MAX_FILTERS_2D

    def memory_budget(self) -> float:
        return nt.MEMORY_BUDGET_2D * self.unet_base_num_features / nt.BASE_NUM_FEATURES

    def get_properties_for_stage(self, current_spacing, original_spacing,
                                 original_shape, num_cases, num_modalities,
                                 num_classes) -> dict:
        new_median_shape = np.round(
            np.asarray(original_spacing) / np.asarray(current_spacing)
            * original_shape).astype(int)
        dataset_num_voxels = int(np.prod(new_median_shape, dtype=np.int64)) * num_cases
        input_patch_size = [int(i) for i in new_median_shape[1:]]  # in-plane only

        ref = self.memory_budget()
        num_pool_per_axis, pool_ops, conv_ks, new_shp, here = shrink_patch_to_fit(
            input_patch_size, new_median_shape[1:], current_spacing[1:], ref,
            self.unet_base_num_features, self.unet_max_num_filters, num_modalities,
            num_classes, self.conv_per_stage, self.unet_featuremap_min_edge_length,
            self.unet_max_numpool, self.topology)

        batch_size = int(np.round(ref / here * nt.DEFAULT_BATCH_SIZE_2D))
        # cap: one batch may cover at most 5% of the dataset's (slice) entities
        max_batch = np.round(self.batch_size_covers_max_percent_of_dataset
                             * dataset_num_voxels
                             / np.prod(new_shp, dtype=np.int64)).astype(int)
        batch_size = int(max(min(batch_size, max_batch), self.unet_min_batch_size))

        return {
            "batch_size": batch_size,
            "num_pool_per_axis": num_pool_per_axis,
            "patch_size": np.asarray(new_shp, dtype=int),
            "median_patient_size_in_voxels": new_median_shape,
            "current_spacing": np.asarray(current_spacing),
            "original_spacing": np.asarray(original_spacing),
            "pool_op_kernel_sizes": pool_ops,
            "conv_kernel_sizes": conv_ks,
            "do_dummy_2D_data_aug": False,
        }

    def plan_experiment(self) -> dict:
        # 2D never cascades: disable the lowres-stage trigger
        self.how_much_of_a_patient_must_the_network_see_at_stage0 = float("inf")
        return super().plan_experiment()


class ExperimentPlannerResencV21(ExperimentPlanner3Dv21):
    """Residual-encoder (FabiansUNet) planner
    (alternative_experiment_planning/experiment_planner_residual_3DUNet_v21.py:26-131):
    pool kernels get a leading [1,1,1] stage, per-stage block counts come from the
    FabiansUNet defaults truncated to the stage count, the memory proxy is the
    residual-encoder + plain-decoder formula, batch size floors at 2."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.1"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlans_FabiansResUNet_v2.1_plans_3D.pkl")

    def get_properties_for_stage(self, current_spacing, original_spacing,
                                 original_shape, num_cases, num_modalities,
                                 num_classes) -> dict:
        new_median_shape = np.round(
            np.asarray(original_spacing) / np.asarray(current_spacing)
            * original_shape).astype(int)
        dataset_num_voxels = np.prod(new_median_shape, dtype=np.int64) * num_cases
        input_patch_size = initial_isotropic_patch(current_spacing, new_median_shape)

        def topo(shape):
            num_pool_per_axis, pools, convs, new_shp, must_div = \
                nt.get_pool_and_conv_props(current_spacing, shape,
                                           self.unet_featuremap_min_edge_length,
                                           self.unet_max_numpool)
            pools = [[1, 1, 1]] + pools
            be = nt.RESENC_BLOCKS_ENCODER[:len(pools)]
            bd = nt.RESENC_BLOCKS_DECODER[:len(pools) - 1]
            return num_pool_per_axis, pools, convs, new_shp, must_div, be, bd

        ref = nt.RESENC_BUDGET_3D
        num_pool_per_axis, pools, convs, new_shp, must_div, be, bd = topo(
            input_patch_size)
        here = nt.compute_resenc_memory_proxy(
            new_shp, self.unet_base_num_features, self.unet_max_num_filters,
            num_modalities, num_classes, pools, be, bd, 2,
            nt.RESENC_MIN_BATCH_SIZE)
        while here > ref:
            axis_to_reduce = int(np.argsort(new_shp / new_median_shape)[-1])
            tmp = new_shp.copy()
            tmp[axis_to_reduce] -= must_div[axis_to_reduce]
            _, _, _, _, must_div_new, _, _ = topo(tmp)
            new_shp[axis_to_reduce] -= must_div_new[axis_to_reduce]
            num_pool_per_axis, pools, convs, new_shp, must_div, be, bd = topo(new_shp)
            here = nt.compute_resenc_memory_proxy(
                new_shp, self.unet_base_num_features, self.unet_max_num_filters,
                num_modalities, num_classes, pools, be, bd, 2,
                nt.RESENC_MIN_BATCH_SIZE)

        batch_size = int(np.floor(max(ref / here, 1) * nt.RESENC_MIN_BATCH_SIZE))
        max_batch = np.round(self.batch_size_covers_max_percent_of_dataset
                             * dataset_num_voxels
                             / np.prod(new_shp, dtype=np.int64)).astype(int)
        batch_size = max(1, min(batch_size, max(max_batch, self.unet_min_batch_size)))
        do_dummy_2D = (max(new_shp) / new_shp[0]) > self.anisotropy_threshold

        return {
            "batch_size": batch_size,
            "num_pool_per_axis": num_pool_per_axis,
            "patch_size": np.asarray(new_shp, dtype=int),
            "median_patient_size_in_voxels": new_median_shape,
            "current_spacing": np.asarray(current_spacing),
            "original_spacing": np.asarray(original_spacing),
            "do_dummy_2D_data_aug": bool(do_dummy_2D),
            "pool_op_kernel_sizes": pools,
            "conv_kernel_sizes": convs,
            "num_blocks_encoder": tuple(be),
            "num_blocks_decoder": tuple(bd),
        }


class ExperimentPlanner11GB(ExperimentPlanner3Dv21):
    """Smaller memory target (alternative planners *_11GB etc.)."""

    # reference default targets ~8GB; scale for an 11GB card
    memory_scale = 11.0 / 8.0

    def memory_budget(self) -> float:
        return super().memory_budget() * self.memory_scale


class ExperimentPlanner32GB(ExperimentPlanner3Dv21):
    """4x memory target for very large accelerators."""

    def memory_budget(self) -> float:
        return super().memory_budget() * 4.0


class ExperimentPlanner3ConvPerStage(ExperimentPlanner3Dv21):
    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.conv_per_stage = 3
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_3cps_plans_3D.pkl")


class ExperimentPlanner16GB(ExperimentPlanner3Dv21):
    """16GB-card memory target (alternative_experiment_planning/
    experiment_planner_baseline_3DUNet_v21_16GB.py:66 — ref * 16/8.5)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.1_verybig"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_verybig_plans_3D.pkl")

    def memory_budget(self) -> float:
        return super().memory_budget() * 16.0 / 8.5


class ExperimentPlanner3Dv22(ExperimentPlanner3Dv21):
    """v2.2 (experiment_planner_baseline_3DUNet_v22.py): the v21 target-spacing
    heuristic under its own data identifier/plans name so both preprocessed
    sets can coexist."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.2"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.2_plans_3D.pkl")


class ExperimentPlanner3Dv23(ExperimentPlanner3Dv21):
    """v2.3 (experiment_planner_baseline_3DUNet_v23.py): linear (order-1) data
    resampling via Preprocessor3DDifferentResampling."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.3"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.3_plans_3D.pkl")
        self.preprocessor_name = "Preprocessor3DDifferentResampling"


class ExperimentPlannerCT2(ExperimentPlannerBase):
    """CT2 normalization ablation (normalization/experiment_planner_3DUNet_CT2.py):
    clip to the global foreground percentile range, then PER-CASE z-score."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPU_CT2"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansCT2_plans_3D.pkl")

    def determine_normalization_scheme(self) -> dict:
        modalities = self.dataset_properties["modalities"]
        return {i: ("CT2" if modalities[i].lower() == "ct" else "nonCT")
                for i in range(len(modalities))}


class ExperimentPlannerNonCT(ExperimentPlannerBase):
    """nonCT normalization everywhere, even for CT images
    (normalization/experiment_planner_3DUNet_nonCT.py)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPU_nonCT"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansnonCT_plans_3D.pkl")

    def determine_normalization_scheme(self) -> dict:
        return {i: "nonCT"
                for i in range(len(self.dataset_properties["modalities"]))}


class ExperimentPlannerAnisoAxisSpacing(ExperimentPlannerBase):
    """Baseline planner with the v21 aniso-axis 10th-percentile spacing rule
    (target_spacing/experiment_planner_baseline_3DUNet_targetSpacingForAnisoAxis.py;
    note its aniso-voxels test uses max(other_sizes), unlike v21's min)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_targetSpacingForAnisoAxis"
        self.plans_fname = os.path.join(
            preprocessed_output_folder,
            "MTTPUPlanstargetSpacingForAnisoAxis_plans_3D.pkl")

    def get_target_spacing(self) -> np.ndarray:
        spacings = self.dataset_properties["all_spacings"]
        sizes = self.dataset_properties["all_sizes"]
        target = np.percentile(np.vstack(spacings), self.target_spacing_percentile, 0)
        target_size = np.percentile(np.vstack(sizes), self.target_spacing_percentile, 0)
        worst = int(np.argmax(target))
        others = [i for i in range(len(target)) if i != worst]
        other_spacings = [target[i] for i in others]
        other_sizes = [target_size[i] for i in others]
        if (target[worst] > self.anisotropy_threshold * max(other_spacings)
                and target_size[worst] * self.anisotropy_threshold < max(other_sizes)):
            target[worst] = np.percentile(np.vstack(spacings)[:, worst], 10)
        return target


class ExperimentPlannerTrgSp2x2x2(ExperimentPlanner3Dv21):
    """Fixed (2,2,2)mm target spacing (target_spacing/..._customTargetSpacing_2x2x2.py)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_plans_v2.1_trgSp_2x2x2"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_trgSp_2x2x2_plans_3D.pkl")

    def get_target_spacing(self) -> np.ndarray:
        return np.array([2.0, 2.0, 2.0])


class ExperimentPlannerNoResampling(ExperimentPlanner3Dv21):
    """Keep every case at its native spacing
    (target_spacing/experiment_planner_baseline_3DUNet_v21_noResampling.py);
    single stage, PreprocessorFor3D_NoResampling."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.data_identifier = "MTTPUData_noRes_plans_v2.1"
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansv2.1_noRes_plans_3D.pkl")
        self.preprocessor_name = "PreprocessorFor3D_NoResampling"
        # no 3d_lowres stage when data is not resampled
        self.how_much_of_a_patient_must_the_network_see_at_stage0 = 10 ** 9


class ExperimentPlannerAllConv3x3(ExperimentPlannerBase):
    """All conv kernels forced to 3x3x3, no 1-kernels for anisotropic stages
    (pooling_and_convs/experiment_planner_baseline_3DUNet_allConv3x3.py)."""

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlansallConv3x3_plans_3D.pkl")

    def get_properties_for_stage(self, *args, **kwargs) -> dict:
        plan = super().get_properties_for_stage(*args, **kwargs)
        plan["conv_kernel_sizes"] = [[3, 3, 3]
                                     for _ in plan["conv_kernel_sizes"]]
        return plan


class ExperimentPlannerPoolBasedOnSpacing(ExperimentPlannerBase):
    """Baseline planner with the spacing-aware pooling topology
    (pooling_and_convs/experiment_planner_baseline_3DUNet_poolBasedOnSpacing.py)."""

    topology = staticmethod(nt.get_pool_and_conv_props)

    def __init__(self, folder_with_cropped_data, preprocessed_output_folder):
        super().__init__(folder_with_cropped_data, preprocessed_output_folder)
        self.plans_fname = os.path.join(preprocessed_output_folder,
                                        "MTTPUPlanspoolBasedOnSpacing_plans_3D.pkl")
