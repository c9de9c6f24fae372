"""MultiTalent inference on the GPU: all 47 region channels, each exported as
its own binary NIfTI under <output>/individual/<region>/, plus the merged
labelmap <output>/<case>.nii.gz.

Counterpart of multitalent_tpu/cli/predict_multitalent.py, with the same
arguments plus --device (default cuda; `cuda` without a usable card raises).

    python -m multitalent_tpu_torch.cli.predict_multitalent -i IN -o OUT -m MODEL
"""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.inference.predict import predict_from_folder


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_folder", required=True)
    parser.add_argument("-o", "--output_folder", required=True)
    parser.add_argument("-m", "--model_folder", required=True,
                        help="trained MultiTalent model folder (contains fold_X)")
    parser.add_argument("-f", "--folds", nargs="+", default=None)
    parser.add_argument("-z", "--save_npz", action="store_true")
    parser.add_argument("--num_threads_preprocessing", type=int, default=2)
    parser.add_argument("--num_threads_nifti_save", type=int, default=2)
    parser.add_argument("--disable_tta", action="store_true")
    parser.add_argument("--overwrite_existing", type=int, default=1)
    parser.add_argument("--part_id", type=int, default=0)
    parser.add_argument("--num_parts", type=int, default=1)
    parser.add_argument("--step_size", type=float, default=0.5)
    parser.add_argument("-chk", default="model_final_checkpoint")
    parser.add_argument("--device", default="cuda",
                        help="torch device: cuda (hand-written kernels) or cpu "
                             "(their plain PyTorch versions)")
    args = parser.parse_args(argv)

    folds = None
    if args.folds is not None:
        folds = [f if f == "all" else int(f) for f in args.folds]
    return predict_from_folder(
        args.model_folder, args.input_folder, args.output_folder, folds,
        save_npz=args.save_npz,
        num_threads_preprocessing=args.num_threads_preprocessing,
        num_threads_nifti_save=args.num_threads_nifti_save,
        part_id=args.part_id, num_parts=args.num_parts,
        tta=not args.disable_tta,
        overwrite_existing=bool(args.overwrite_existing),
        step_size=args.step_size, checkpoint_name=args.chk,
        multitalent_regions=True, device=args.device)


if __name__ == "__main__":
    main()
