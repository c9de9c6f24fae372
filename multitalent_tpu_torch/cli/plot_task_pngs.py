"""`python -m multitalent_tpu_torch.cli.plot_task_pngs` — overlay PNG per
training case of a task (nnUNet_plot_task_pngs parity, setup.py:47 /
utilities/overlay_plots.py:191-206); the port's copy of
multitalent_tpu/cli/plot_task_pngs.py."""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.utils.overlay_plots import generate_overlays_for_task


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="Plots png overlays of the slice with the most "
                    "foreground. Note that this disregards spacing "
                    "information!")
    parser.add_argument("-t", type=str, required=True,
                        help="task name or task ID")
    parser.add_argument("-o", type=str, required=True, help="output folder")
    parser.add_argument("-num_processes", type=int, default=8,
                        help="number of processes used. Default: 8")
    parser.add_argument("-modality_idx", type=int, default=0,
                        help="modality index used (0 = _0000.nii.gz). "
                             "Default: 0")
    parser.add_argument("--use_raw", action="store_true",
                        help="use raw data instead of preprocessed")
    args = parser.parse_args(argv)
    generate_overlays_for_task(args.t, args.o, args.num_processes,
                               args.modality_idx,
                               use_preprocessed=not args.use_raw)


if __name__ == "__main__":
    main()
