"""`mttpu_determine_postprocessing` — search for beneficial largest-CC removal on
cross-validation predictions.

Parity target: nnunet/postprocessing/consolidate_postprocessing_simple.py CLI
(nnUNet_determine_postprocessing, setup.py:44).

The port's copy of multitalent_tpu/cli/determine_postprocessing.py; host code:

    python -m multitalent_tpu_torch.cli.determine_postprocessing -t TASK [-m 3d_fullres] [-f 0]
"""
from __future__ import annotations

import argparse
import os

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli.configuration import resolve_task_name
from multitalent_tpu_torch.postprocessing.connected_components import (
    determine_postprocessing)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-t", "--task_name", required=True)
    parser.add_argument("-m", "--model", default="3d_fullres")
    parser.add_argument("-tr", "--trainer", default="TrainerV2")
    parser.add_argument("-p", "--plans_identifier", default=None)
    parser.add_argument("-f", "--fold", default="0")
    parser.add_argument("-val", "--validation_folder_name", default="validation_raw")
    parser.add_argument("--processes", type=int, default=4)
    args = parser.parse_args(argv)

    task = resolve_task_name(args.task_name)
    plans_identifier = args.plans_identifier or paths.default_plans_identifier
    fold = args.fold if args.fold == "all" else f"fold_{int(args.fold)}"
    base = os.path.join(paths.network_training_output_dir(), args.model, task,
                        args.trainer + "__" + plans_identifier, fold)
    gt = os.path.join(paths.preprocessing_output_dir(), task, "gt_segmentations")
    determine_postprocessing(base, gt, args.validation_folder_name,
                             processes=args.processes)


if __name__ == "__main__":
    main()
