"""Crop, fingerprint, plan and preprocess raw tasks: host code, no device.

Parity target: nnunet/experiment_planning/nnUNet_plan_and_preprocess.py:27-180
(argument surface and pipeline order: verify integrity -> crop -> analyze ->
plan 3D [-> plan 2D] -> preprocess), including `-overwrite_plans` for the
pretrained-plans transplant workflow.

The port's copy of multitalent_tpu/cli/plan_and_preprocess.py, with the
planners of planning/planners.py. `main` returns each task's seconds by step
(verify, crop, analyze, plan, preprocess):

    python -m multitalent_tpu_torch.cli.plan_and_preprocess -t 3 --verify_dataset_integrity
    python -m multitalent_tpu_torch.cli.plan_and_preprocess -t 100 \\
        -pl3d ExperimentPlanner3D_v21_MultiTalent -pl2d None
"""
from __future__ import annotations

import argparse
import os
import shutil
import time

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.paths import default_num_threads
from multitalent_tpu_torch.planning.planners import resolve_planner
from multitalent_tpu_torch.utils.fileops import maybe_mkdir
from multitalent_tpu_torch.utils.task_names import convert_id_to_task_name


def crop_task(task: str, override: bool = False, num_threads: int = default_num_threads) -> None:
    """Crop all cases of a raw task into nnUNet_cropped_data/<task>
    (experiment_planning/utils.py:122 parity)."""
    from multitalent_tpu_torch.preprocessing.cropping import ImageCropper
    from multitalent_tpu_torch.utils.fileops import load_json

    raw_folder = os.path.join(paths.nnUNet_raw_data(), task)
    cropped_folder = maybe_mkdir(os.path.join(paths.nnUNet_cropped_data(), task))
    if override and os.path.isdir(cropped_folder):
        shutil.rmtree(cropped_folder)
        maybe_mkdir(cropped_folder)

    dataset_json = load_json(os.path.join(raw_folder, "dataset.json"))
    num_modalities = len(dataset_json["modality"])
    cases = []
    for tr in dataset_json["training"]:
        ident = os.path.basename(tr["image"]).split(".nii.gz")[0]
        case = [os.path.join(raw_folder, "imagesTr", f"{ident}_{m:04d}.nii.gz")
                for m in range(num_modalities)]
        case.append(os.path.join(raw_folder, "labelsTr", f"{ident}.nii.gz"))
        cases.append(case)
    ImageCropper(num_threads, cropped_folder).run_cropping(cases)
    shutil.copy(os.path.join(raw_folder, "dataset.json"), cropped_folder)


def main(argv=None) -> dict[str, dict[str, float]]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-t", "--task_ids", nargs="+", required=True,
                        help="task ids to plan and preprocess")
    parser.add_argument("-pl3d", "--planner3d", default="ExperimentPlanner3D_v21")
    parser.add_argument("-pl2d", "--planner2d", default="None",
                        help="2D planner (or 'None' to skip 2D)")
    parser.add_argument("-no_pp", action="store_true",
                        help="only plan, skip preprocessing")
    parser.add_argument("-tl", type=int, default=default_num_threads,
                        help="lowres preprocessing threads")
    parser.add_argument("-tf", type=int, default=default_num_threads,
                        help="fullres preprocessing threads")
    parser.add_argument("--verify_dataset_integrity", action="store_true")
    parser.add_argument("-overwrite_plans", default=None,
                        help="source plans file to transplant (pretrained workflow)")
    parser.add_argument("-overwrite_plans_identifier", default=None)
    args = parser.parse_args(argv)

    seconds: dict[str, dict[str, float]] = {}
    for task_id in args.task_ids:
        task = (task_id if str(task_id).startswith("Task")
                else convert_id_to_task_name(int(task_id)))
        print(f"\n\n\n{task}")
        raw_folder = os.path.join(paths.nnUNet_raw_data(), task)
        split = seconds[task] = {}
        t0 = time.perf_counter()

        def lap(step: str) -> None:
            nonlocal t0
            t = time.perf_counter()
            split[step] = split.get(step, 0.0) + t - t0
            t0 = t

        if args.verify_dataset_integrity:
            from multitalent_tpu_torch.preprocessing.sanity_checks import (
                verify_dataset_integrity)
            verify_dataset_integrity(raw_folder)
            lap("verify")

        crop_task(task, override=False, num_threads=args.tf)
        lap("crop")
        cropped = os.path.join(paths.nnUNet_cropped_data(), task)
        preprocessed = maybe_mkdir(os.path.join(paths.preprocessing_output_dir(), task))

        from multitalent_tpu_torch.planning.dataset_analyzer import DatasetAnalyzer
        DatasetAnalyzer(cropped, overwrite=False,
                        num_processes=args.tf).analyze_dataset(True)

        shutil.copy(os.path.join(cropped, "dataset_properties.pkl"), preprocessed)
        shutil.copy(os.path.join(raw_folder, "dataset.json"), preprocessed)
        lap("analyze")

        threads = (args.tl, args.tf)
        if args.planner3d != "None":
            planner_cls = resolve_planner(args.planner3d)
            if args.overwrite_plans is not None:
                planner = planner_cls(cropped, preprocessed,
                                      args.overwrite_plans,
                                      args.overwrite_plans_identifier)
            else:
                planner = planner_cls(cropped, preprocessed)
            planner.plan_experiment()
            lap("plan")
            if not args.no_pp:
                planner.run_preprocessing(threads)
                lap("preprocess")
        if args.planner2d != "None":
            planner_cls = resolve_planner(args.planner2d)
            planner = planner_cls(cropped, preprocessed)
            planner.plan_experiment()
            lap("plan")
            if not args.no_pp:
                planner.run_preprocessing(threads)
                lap("preprocess")
    return seconds


if __name__ == "__main__":
    main()
