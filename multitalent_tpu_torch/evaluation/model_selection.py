"""Model-selection utilities.

Parity targets: nnunet/evaluation/model_selection/summarize_results_in_one_json.py
(collect every trained configuration's summary.json into one overview),
rank_candidates*.py (order configurations by mean foreground Dice), and
inference/pretrained_models/collect_pretrained_models.py (zip a trained model
folder for distribution).

The port's copy of multitalent_tpu/evaluation/model_selection.py; a zipped folder
takes the port's checkpoints (`.model` + `.model.pkl`) beside the JAX layout's.
"""
from __future__ import annotations

import os
import zipfile

import numpy as np

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.utils.fileops import load_json, save_json, subdirs


def mean_fg_dice_of_summary(summary_json: str) -> float:
    res = load_json(summary_json)["results"]["mean"]
    return float(np.nanmean([v["Dice"] for v in res.values()]))


def summarize_results_in_one_json(output_file: str | None = None) -> dict:
    """Walk RESULTS/nnUNet/<network>/<task>/<trainer__plans>/fold_X/validation_*/
    summary.json and aggregate everything into one overview json."""
    base = paths.network_training_output_dir()
    overview: dict = {}
    for network in ("2d", "3d_lowres", "3d_fullres", "3d_cascade_fullres"):
        ndir = os.path.join(base, network)
        if not os.path.isdir(ndir):
            continue
        for task in subdirs(ndir, join=False):
            for model in subdirs(os.path.join(ndir, task), join=False):
                mdir = os.path.join(ndir, task, model)
                fold_dices = {}
                for fold in subdirs(mdir, prefix="fold_", join=False):
                    for val in ("validation_final", "validation_raw"):
                        sj = os.path.join(mdir, fold, val, "summary.json")
                        if os.path.isfile(sj):
                            fold_dices[fold] = mean_fg_dice_of_summary(sj)
                            break
                if fold_dices:
                    overview.setdefault(task, {})[f"{network}/{model}"] = {
                        "per_fold_mean_fg_dice": fold_dices,
                        "mean_fg_dice": float(np.mean(list(fold_dices.values()))),
                    }
    if output_file is None:
        output_file = os.path.join(base, "summary_allFolds.json")
    save_json(overview, output_file)
    return overview


def rank_candidates(task: str) -> list[tuple[str, float]]:
    """Configurations of one task ordered best-first by mean foreground Dice."""
    overview = summarize_results_in_one_json()
    entries = overview.get(task, {})
    return sorted(((name, info["mean_fg_dice"]) for name, info in entries.items()),
                  key=lambda kv: -kv[1])


def collect_pretrained_model(model_folder: str, output_zip: str,
                             folds=(0, 1, 2, 3, 4),
                             checkpoint_name: str = "model_final_checkpoint") -> None:
    """Zip a trained model folder (plans.pkl + per-fold checkpoints + postprocessing)
    for distribution (collect_pretrained_models.py role): the JAX layout's
    `.ckpt` files and the port's `.model` files."""
    with zipfile.ZipFile(output_zip, "w", zipfile.ZIP_DEFLATED) as z:
        for name in ("plans.pkl", "postprocessing.json"):
            p = os.path.join(model_folder, name)
            if os.path.isfile(p):
                z.write(p, os.path.join(os.path.basename(model_folder), name))
        for f in folds:
            fdir = os.path.join(model_folder, f"fold_{f}")
            if not os.path.isdir(fdir):
                continue
            for suffix in (".ckpt", ".ckpt.pkl", ".model", ".model.pkl"):
                p = os.path.join(fdir, checkpoint_name + suffix)
                if os.path.isfile(p):
                    z.write(p, os.path.join(os.path.basename(model_folder),
                                            f"fold_{f}",
                                            checkpoint_name + suffix))
    print(f"wrote {output_zip}")
