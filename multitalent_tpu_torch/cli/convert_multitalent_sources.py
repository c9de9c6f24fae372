"""CLI: build the MultiTalent source tasks from public challenge downloads
(the port's copy of multitalent_tpu/cli/convert_multitalent_sources.py).

Usage (CLI = python -m multitalent_tpu_torch.cli.convert_multitalent_sources):
  CLI Task017 /path/to/BTCV_RawData
  CLI Task062 /path/to/niftis --labels /path/to/labels
  CLI Task046 /path/to/pancreas_niftis \
      --labels /path/to/zenodo_labels --btcv-images /p/Training/img /p/Test/img
  ...

Decathlon sources (Task003/006/007/008/009/010) use
`python -m multitalent_tpu_torch.cli.convert_decathlon_task` instead.
"""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.tasks.source_converters import CONVERTERS


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("task", choices=sorted(CONVERTERS),
                    help="which source task to build")
    ap.add_argument("source", help="challenge download folder (see module doc "
                                   "of tasks/source_converters.py per task)")
    ap.add_argument("--labels", default=None,
                    help="Task062/Task046: folder with labelXXXX.nii.gz "
                         "(Task046: the zenodo multi-organ label download)")
    ap.add_argument("--btcv-images", nargs="*", default=(),
                    help="Task046 only: folders of BTCV imgXXXX.nii.gz")
    ap.add_argument("--raw_data_base", default=None,
                    help="override nnUNet_raw_data output root")
    ap.add_argument("--no-reorient", action="store_true",
                    help="Task062 only: skip the RAS reorientation pass")
    args = ap.parse_args(argv)

    fn = CONVERTERS[args.task]
    if args.task == "Task062":
        assert args.labels, "Task062 needs --labels"
        out = fn(args.source, args.labels, raw_data_base=args.raw_data_base,
                 reorient=not args.no_reorient)
    elif args.task == "Task046":
        assert args.labels, "Task046 needs --labels"
        out = fn(args.source, args.labels, btcv_images_dirs=args.btcv_images,
                 raw_data_base=args.raw_data_base)
    else:
        out = fn(args.source, raw_data_base=args.raw_data_base)
    print(f"created {out}")
    return out


if __name__ == "__main__":
    main()
