"""`python -m multitalent_tpu_torch.cli.consolidate_postprocessing` — merge all folds'
validation predictions and determine postprocessing on the merged CV
(nnunet/postprocessing/consolidate_postprocessing[_simple].py parity).

The port's copy of multitalent_tpu/cli/consolidate_postprocessing.py; host code:

    python -m multitalent_tpu_torch.cli.consolidate_postprocessing -t TASK [-f 0 1 2 3 4]
"""
from __future__ import annotations

import argparse
import os
import shutil

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli.configuration import resolve_task_name
from multitalent_tpu_torch.postprocessing.connected_components import (
    determine_postprocessing)
from multitalent_tpu_torch.utils.fileops import maybe_mkdir, subfiles


def consolidate_folds(model_folder: str, folds,
                      validation_folder_name: str = "validation_raw") -> str:
    cv_dir = maybe_mkdir(os.path.join(model_folder, "cv_niftis_raw"))
    for f in folds:
        src = os.path.join(model_folder, f"fold_{f}", validation_folder_name)
        assert os.path.isdir(src), f"missing {src}: validate fold {f} first"
        for p in subfiles(src, suffix=".nii.gz"):
            shutil.copy(p, cv_dir)
    return cv_dir


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-t", "--task_name", required=True)
    parser.add_argument("-m", "--model", default="3d_fullres")
    parser.add_argument("-tr", "--trainer", default="TrainerV2")
    parser.add_argument("-p", "--plans_identifier", default=None)
    parser.add_argument("-f", "--folds", nargs="+", type=int,
                        default=[0, 1, 2, 3, 4])
    parser.add_argument("-val", "--validation_folder_name",
                        default="validation_raw")
    parser.add_argument("--processes", type=int, default=4)
    args = parser.parse_args(argv)

    task = resolve_task_name(args.task_name)
    plans_identifier = args.plans_identifier or paths.default_plans_identifier
    model_folder = os.path.join(paths.network_training_output_dir(), args.model,
                                task, args.trainer + "__" + plans_identifier)
    cv_dir = consolidate_folds(model_folder, args.folds,
                               args.validation_folder_name)
    gt = os.path.join(paths.preprocessing_output_dir(), task, "gt_segmentations")
    determine_postprocessing(model_folder, gt, os.path.basename(cv_dir),
                             final_subf_name="cv_niftis_postprocessed",
                             processes=args.processes)


if __name__ == "__main__":
    main()
