"""`python -m multitalent_tpu_torch.cli.export_model` — zip trained models of a
task for sharing (nnUNet_export_model_to_zip parity, setup.py:43 /
inference/pretrained_models/collect_pretrained_models.py:215-255); the port's
copy of multitalent_tpu/cli/export_model.py. The zip installs on another
machine via `cli.download_pretrained install_zip`."""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.inference.pretrained_models import export_pretrained_model
from multitalent_tpu_torch.paths import (default_cascade_trainer,
                                   default_plans_identifier, default_trainer)
from multitalent_tpu_torch.utils.task_names import convert_id_to_task_name


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Export trained models to a zip file for sharing. The "
                    "zip can be installed with "
                    "python -m multitalent_tpu_torch.cli.download_pretrained "
                    "install_zip <zip>.")
    parser.add_argument("-t", type=str, required=True,
                        help="task name or task id")
    parser.add_argument("-o", type=str, required=True,
                        help="output file name, should end with .zip")
    parser.add_argument("-m", nargs="+", required=False,
                        default=("2d", "3d_lowres", "3d_fullres",
                                 "3d_cascade_fullres"),
                        help="model configurations to export")
    parser.add_argument("-tr", type=str, default=default_trainer,
                        help=f"trainer class (default {default_trainer})")
    parser.add_argument("-trc", type=str, default=default_cascade_trainer,
                        help="cascade trainer class "
                             f"(default {default_cascade_trainer})")
    parser.add_argument("-pl", type=str, default=default_plans_identifier,
                        help="plans identifier "
                             f"(default {default_plans_identifier})")
    parser.add_argument("--disable_strict", action="store_true",
                        help="allow skipping missing configurations / "
                             "postprocessing")
    parser.add_argument("-f", nargs="+", default=["0", "1", "2", "3", "4"],
                        help="folds (default 0 1 2 3 4)")
    args = parser.parse_args(argv)

    task = args.t
    if not task.startswith("Task"):
        task = convert_id_to_task_name(int(task))
    folds = [int(f) if f != "all" else f for f in args.f]
    export_pretrained_model(task, args.o, models=tuple(args.m),
                            trainer=args.tr, cascade_trainer=args.trc,
                            plans_identifier=args.pl, folds=folds,
                            strict=not args.disable_strict)


if __name__ == "__main__":
    main()
