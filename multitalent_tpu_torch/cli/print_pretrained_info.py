"""`python -m multitalent_tpu_torch.cli.print_pretrained_info` — show a
pretrained model's properties (nnUNet_print_pretrained_model_info parity,
setup.py:39 / download_pretrained_model.py:392-405); the port's copy of
multitalent_tpu/cli/print_pretrained_info.py."""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.inference.pretrained_models import AVAILABLE_MODELS


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Use this to see the properties of a pretrained model, "
                    "especially what input modalities it requires")
    parser.add_argument("task_name", type=str,
                        help="Task name of the pretrained model. To see "
                             "available task names, run "
                             "cli.download_pretrained list")
    args = parser.parse_args(argv)
    if args.task_name not in AVAILABLE_MODELS:
        raise RuntimeError(
            "Invalid task name. This pretrained model does not exist. To "
            "see available task names, run "
            "cli.download_pretrained list")
    print(AVAILABLE_MODELS[args.task_name]["description"])


if __name__ == "__main__":
    main()
