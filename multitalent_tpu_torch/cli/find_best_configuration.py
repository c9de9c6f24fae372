"""`find_best_configuration` — cross-validate configurations, try pairwise
ensembles, pick the winner + its postprocessing, print the inference commands.

Parity target: nnunet/evaluation/model_selection/figure_out_what_to_submit.py:47-…
(nnUNet_find_best_configuration, setup.py:37).

The port's copy of multitalent_tpu/cli/find_best_configuration.py; host code.
Configurations without a model folder (2d, which the port does not train
yet, and any configuration not trained; the cascade's folder is
3d_cascade_fullres/<task>/<-ctr>__<plans>) are skipped:

    python -m multitalent_tpu_torch.cli.find_best_configuration -t TASK -m 3d_fullres -f 0
"""
from __future__ import annotations

import argparse
import os
import shutil
from itertools import combinations

import numpy as np

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli.configuration import resolve_task_name
from multitalent_tpu_torch.evaluation.evaluator import aggregate_scores
from multitalent_tpu_torch.utils.fileops import load_json, maybe_mkdir, save_json, subfiles

PREDICT = "python -m multitalent_tpu_torch.cli.predict"


def collect_cv_niftis(model_folder: str, folds, out_folder: str,
                      validation_folder: str = "validation_raw") -> bool:
    """Merge all folds' validation predictions into one folder (the reference's
    cv_niftis_raw). Returns False if any fold is missing."""
    maybe_mkdir(out_folder)
    for f in folds:
        fold_dir = os.path.join(model_folder, f"fold_{f}", validation_folder)
        if not os.path.isdir(fold_dir):
            print(f"  missing {fold_dir}")
            return False
        for p in subfiles(fold_dir, suffix=".nii.gz"):
            shutil.copy(p, out_folder)
        # saved softmax (+properties) travel too — ensembling averages them
        # (figure_out_what_to_submit consolidates the validation npz the same
        # way; without these the pairwise-ensemble stage has nothing to read)
        for suffix in (".npz", ".pkl"):
            for p in subfiles(fold_dir, suffix=suffix):
                shutil.copy(p, out_folder)
    return True


def mean_fg_dice(scores) -> float:
    return float(np.nanmean([v["Dice"] for v in scores["mean"].values()]))


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-t", "--task_name", required=True)
    parser.add_argument("-m", "--models", nargs="+",
                        default=["2d", "3d_lowres", "3d_fullres",
                                 "3d_cascade_fullres"])
    parser.add_argument("-tr", "--trainer", default="TrainerV2")
    parser.add_argument("-ctr", "--cascade_trainer", default="TrainerV2CascadeFullRes")
    parser.add_argument("-pl", "--plans_identifier", default=None)
    parser.add_argument("-f", "--folds", nargs="+", type=int,
                        default=[0, 1, 2, 3, 4])
    parser.add_argument("--disable_ensembling", action="store_true")
    args = parser.parse_args(argv)

    task = resolve_task_name(args.task_name)
    plans_identifier = args.plans_identifier or paths.default_plans_identifier
    gt_folder = os.path.join(paths.preprocessing_output_dir(), task,
                             "gt_segmentations")
    dataset_json = load_json(os.path.join(paths.preprocessing_output_dir(), task,
                                          "dataset.json"))
    labels = sorted(int(k) for k in dataset_json["labels"] if int(k) > 0)

    results: dict[str, float] = {}
    cv_folders: dict[str, str] = {}
    for model in args.models:
        trainer = args.cascade_trainer if model == "3d_cascade_fullres" else args.trainer
        model_folder = os.path.join(paths.network_training_output_dir(), model,
                                    task, trainer + "__" + plans_identifier)
        if not os.path.isdir(model_folder):
            print(f"{model}: not trained, skipping ({model_folder})")
            continue
        cv_dir = os.path.join(model_folder, "cv_niftis_raw")
        if not collect_cv_niftis(model_folder, args.folds, cv_dir):
            print(f"{model}: incomplete cross-validation, skipping")
            continue
        pairs = [(p, os.path.join(gt_folder, os.path.basename(p)))
                 for p in subfiles(cv_dir, suffix=".nii.gz")]
        scores = aggregate_scores(
            pairs, labels=labels,
            json_output_file=os.path.join(cv_dir, "summary.json"), num_threads=4)
        results[model] = mean_fg_dice(scores)
        cv_folders[model] = cv_dir
        print(f"{model}: mean foreground Dice {results[model]:.4f}")

    if not args.disable_ensembling and len(results) >= 2:
        from multitalent_tpu_torch.inference.predict import ensemble_predictions
        for m1, m2 in combinations(sorted(results), 2):
            npz1 = subfiles(cv_folders[m1], suffix=".npz")
            npz2 = subfiles(cv_folders[m2], suffix=".npz")
            if not npz1 or not npz2:
                print(f"ensemble {m1}+{m2}: no saved softmax npz (train/validate "
                      "with --npz to enable ensembling), skipping")
                continue
            ens_dir = os.path.join(paths.network_training_output_dir(),
                                   "ensembles", task, f"ensemble_{m1}__{m2}")
            ensemble_predictions([cv_folders[m1], cv_folders[m2]], ens_dir)
            pairs = [(p, os.path.join(gt_folder, os.path.basename(p)))
                     for p in subfiles(ens_dir, suffix=".nii.gz")]
            scores = aggregate_scores(
                pairs, labels=labels,
                json_output_file=os.path.join(ens_dir, "summary.json"),
                num_threads=4)
            results[f"ensemble_{m1}__{m2}"] = mean_fg_dice(scores)
            print(f"ensemble {m1}+{m2}: mean foreground Dice "
                  f"{results[f'ensemble_{m1}__{m2}']:.4f}")

    assert results, "no trained configurations found"
    winner = max(results, key=results.get)
    print(f"\nBest configuration: {winner} "
          f"(mean foreground Dice {results[winner]:.4f})")
    save_json({"results": results, "best": winner},
              os.path.join(paths.network_training_output_dir(),
                           f"model_selection_{task}.json"))

    # postprocessing for the winner (non-ensemble winners only; the reference also
    # determines it on ensembles via their cv folder)
    pp_source = cv_folders.get(winner)
    if pp_source is not None:
        from multitalent_tpu_torch.postprocessing.connected_components import (
            determine_postprocessing)
        determine_postprocessing(os.path.dirname(pp_source), gt_folder,
                                 os.path.basename(pp_source), processes=4)

    print("\nTo predict with the best configuration run:")
    if winner.startswith("ensemble"):
        m1, m2 = winner[len("ensemble_"):].split("__")
        print(f"  {PREDICT} -i INPUT -o OUT_{m1} -t {task} -m {m1} -z")
        print(f"  {PREDICT} -i INPUT -o OUT_{m2} -t {task} -m {m2} -z")
        print(f"  python -m multitalent_tpu_torch.cli.ensemble -f OUT_{m1} OUT_{m2} -o OUTPUT")
    else:
        print(f"  {PREDICT} -i INPUT -o OUTPUT -t {task} -m {winner}")


if __name__ == "__main__":
    main()
