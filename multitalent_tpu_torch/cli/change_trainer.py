"""`python -m multitalent_tpu_torch.cli.change_trainer` — rewrite the trainer
class name stored in a checkpoint's sidecar pkl (nnunet/inference/
change_trainer.py parity), so checkpoints restore through a different (e.g.
renamed) trainer class.

The counterpart of multitalent_tpu/cli/change_trainer.py, with one
difference: the JAX CLI writes `trainer_name` whatever the sidecar, which is
what a `.ckpt.pkl` of the JAX layout restores by, but a reference-layout
`.model.pkl` names its trainer under `name` (the key restore reads there,
inference/model_restore.read_model_folder, and the key the released zip's
fixups stamp), so on a `.model.pkl` the JAX CLI changes nothing that restore
reads. This one tells the two apart by their init arguments (`init` in a
`.model.pkl`, `init_args` in a `.ckpt.pkl`) and sets `name` or
`trainer_name` accordingly.
"""
from __future__ import annotations

import argparse
import pickle


def trainer_key(meta: dict) -> str:
    """The key a sidecar names its trainer under: `name` for the reference
    layout's `.model.pkl` (init arguments under `init`), `trainer_name` for
    the JAX layout's `.ckpt.pkl` (under `init_args`)."""
    if "init" in meta and "init_args" not in meta:
        return "name"
    if "init_args" in meta:
        return "trainer_name"
    raise ValueError("neither a reference-layout .model.pkl (init) nor a JAX-layout "
                     ".ckpt.pkl (init_args) sidecar")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint_pkl", help="path to <ckpt>.pkl sidecar")
    parser.add_argument("new_trainer_name")
    args = parser.parse_args(argv)
    with open(args.checkpoint_pkl, "rb") as f:
        meta = pickle.load(f)
    key = trainer_key(meta)
    old = meta.get(key)
    meta[key] = args.new_trainer_name
    with open(args.checkpoint_pkl, "wb") as f:
        pickle.dump(meta, f)
    print(f"{args.checkpoint_pkl}: {key} {old} -> {args.new_trainer_name}")


if __name__ == "__main__":
    main()
