"""Evaluate a folder of predictions against ground truth.

Counterpart of multitalent_tpu/cli/evaluate.py (nnUNet_evaluate_folder,
nnunet/evaluation/evaluator.py:446): the labelmaps of the same names in
both folders, scored per label; the summary goes to <pred>/summary.json.
Host work only.

    python -m multitalent_tpu_torch.cli.evaluate -ref GT -pred OUT -l 1 2
"""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.evaluation.evaluator import evaluate_folder


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-ref", required=True, help="folder with ground truth")
    parser.add_argument("-pred", required=True, help="folder with predictions")
    parser.add_argument("-l", "--labels", nargs="+", type=int, required=True)
    args = parser.parse_args(argv)
    return evaluate_folder(args.ref, args.pred, args.labels)


if __name__ == "__main__":
    main()
