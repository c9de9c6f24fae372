"""`python -m multitalent_tpu_torch.cli.download_pretrained` — pretrained model zoo
(nnUNet_download_pretrained_model / nnUNet_print_available_pretrained_models /
nnUNet_install_pretrained_model_from_zip parity, setup.py:39-42); the port's
copy of multitalent_tpu/cli/download_pretrained.py. `install_zip` of the
released Task100 zip applies its folder and sidecar fixups; the installed
folder then predicts through `cli.predict_multitalent -m <folder>`."""
from __future__ import annotations

import argparse

from multitalent_tpu_torch.inference.pretrained_models import (
    download_and_install_pretrained_model_by_name, import_reference_model_folder,
    install_model_from_zip_file, print_available_pretrained_models)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="print available pretrained models")
    d = sub.add_parser("download", help="download and install by task name")
    d.add_argument("task_name")
    z = sub.add_parser("install_zip", help="install a downloaded zip")
    z.add_argument("zip_file")
    c = sub.add_parser("import_torch", help="convert an installed reference model "
                                            "folder's torch checkpoints")
    c.add_argument("model_folder")
    c.add_argument("trainer_name")
    args = parser.parse_args(argv)
    if args.cmd == "list":
        print_available_pretrained_models()
    elif args.cmd == "download":
        download_and_install_pretrained_model_by_name(args.task_name)
    elif args.cmd == "install_zip":
        install_model_from_zip_file(args.zip_file)
    elif args.cmd == "import_torch":
        import_reference_model_folder(args.model_folder, args.trainer_name)


if __name__ == "__main__":
    main()
