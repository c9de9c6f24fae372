"""Average the saved probabilities of several prediction folders and export.

Counterpart of multitalent_tpu/cli/ensemble.py (nnUNet_ensemble,
nnunet/inference/ensemble_predictions.py:101): every folder holds the
`<case>.npz` and `<case>.pkl` that `cli.predict -z` writes; the mean of the
cases all folders share is exported to the output folder. Host work only.

    python -m multitalent_tpu_torch.cli.ensemble -f OUT_A OUT_B -o OUT
"""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.inference.predict import ensemble_predictions


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-f", "--folders", nargs="+", required=True,
                        help="prediction folders containing saved .npz softmax")
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("--npz", action="store_true",
                        help="(accepted for parity; merged npz are not re-saved)")
    parser.add_argument("-t", "--threads", type=int, default=2)
    args = parser.parse_args(argv)
    ensemble_predictions(args.folders, args.output_folder, num_threads=args.threads)


if __name__ == "__main__":
    main()
