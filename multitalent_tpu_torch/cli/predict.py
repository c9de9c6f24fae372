"""Folder inference with a trained model on the GPU.

Counterpart of multitalent_tpu/cli/predict.py (nnunet/inference/
predict_simple.py:25-240), with the same arguments plus --device (default
cuda; `cuda` without a usable card raises). The model folder is
RESULTS/nnUNet/<network>/<task>/<trainer>__<plans identifier>, under the
RESULTS_FOLDER the environment names:

    python -m multitalent_tpu_torch.cli.predict -i IN -o OUT -t Task003_Liver \
        -m 3d_fullres -tr TrainerV2 [--mode normal|fast|fastest] [-f 0 1] [-z]

--mode fast and fastest never keep the probabilities (no -z): fast argmaxes
the fold sum after resizing it back, fastest argmaxes on the network's grid
and resizes the labelmap by nearest neighbour. MTTPU_SW_EXACT=1 runs the
sliding window in its exact (fp32) mode, MTTPU_DEVICE_EXPORT=0 exports on
the host. `-m 3d_lowres` predicts a cascade's first stage, an ordinary model
folder at stage 0. Refused: 2d models (neither package predicts one: the
JAX sliding window tiles three axes and raises a ValueError there), and
3d_cascade_fullres ones, which read the previous stage's segmentations: the
JAX package's CLI accepts them (lowres_segmentations) but never reads them,
so it cannot predict such a folder either (a cascade validates through
`cli.train 3d_cascade_fullres ... -val`).
"""
from __future__ import annotations

import argparse
import os

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.cli.configuration import resolve_task_name
from multitalent_tpu_torch.inference.predict import predict_from_folder
from multitalent_tpu_torch.ops.sliding_window import refuse_2d_prediction


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("-i", "--input_folder", required=True)
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("-t", "--task_name", required=True)
    parser.add_argument("-tr", "--trainer_class_name", default="TrainerV2")
    parser.add_argument("-m", "--model", default="3d_fullres",
                        choices=["2d", "3d_lowres", "3d_fullres", "3d_cascade_fullres"])
    parser.add_argument("-p", "--plans_identifier", default=None)
    parser.add_argument("-f", "--folds", nargs="+", default=None,
                        help="folds to ensemble (default: all found)")
    parser.add_argument("-z", "--save_npz", action="store_true")
    parser.add_argument("--num_threads_preprocessing", type=int, default=2)
    parser.add_argument("--num_threads_nifti_save", type=int, default=2)
    parser.add_argument("--disable_tta", action="store_true")
    parser.add_argument("--overwrite_existing", type=int, default=1)
    parser.add_argument("--part_id", type=int, default=0)
    parser.add_argument("--num_parts", type=int, default=1)
    parser.add_argument("--step_size", type=float, default=0.5)
    parser.add_argument("-chk", default="model_final_checkpoint")
    parser.add_argument("--mode", default="normal", choices=["normal", "fast", "fastest"],
                        help="fast/fastest keep no probabilities (predict_simple.py "
                             "--mode parity)")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (hand-written kernels) or cpu "
                             "(their plain PyTorch versions)")
    args = parser.parse_args(argv)

    if args.model == "2d":
        refuse_2d_prediction("-m 2d")
    if args.model == "3d_cascade_fullres":
        raise NotImplementedError(
            "-m 3d_cascade_fullres: a cascade model reads the previous stage's "
            "segmentations, which the JAX package's predict CLI accepts "
            "(lowres_segmentations) but never reads, so it predicts no cascade folder "
            "either; predict the 3d_lowres model, or validate the cascade with "
            "cli.train 3d_cascade_fullres ... -val")
    task = resolve_task_name(args.task_name)
    plans_identifier = args.plans_identifier or paths.default_plans_identifier
    model_folder = os.path.join(paths.network_training_output_dir(), args.model, task,
                                args.trainer_class_name + "__" + plans_identifier)
    if not os.path.isdir(model_folder):
        raise FileNotFoundError(f"model folder not found: {model_folder}")
    folds = None
    if args.folds is not None:
        folds = [f if f == "all" else int(f) for f in args.folds]
    return predict_from_folder(
        model_folder, args.input_folder, args.output_folder, folds,
        save_npz=args.save_npz,
        num_threads_preprocessing=args.num_threads_preprocessing,
        num_threads_nifti_save=args.num_threads_nifti_save,
        part_id=args.part_id, num_parts=args.num_parts,
        tta=not args.disable_tta,
        overwrite_existing=bool(args.overwrite_existing),
        step_size=args.step_size, checkpoint_name=args.chk, mode=args.mode,
        device=args.device)


if __name__ == "__main__":
    main()
