"""Task id <-> task folder-name conversion (reference:
nnunet/utilities/task_name_id_conversion.py:21-64). Task folders are named
'TaskXXX_<name>'; the id is the XXX integer. Lookup scans the configured raw /
preprocessed / cropped roots for a matching folder.

The port's copy of multitalent_tpu/utils/task_names.py.
"""
from __future__ import annotations

import os

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.utils.fileops import subdirs


def convert_id_to_task_name(task_id: int) -> str:
    startswith = "Task%03.0d" % task_id
    candidates: list[str] = []
    for root_fn in (paths.get_preprocessed_dir, lambda: _maybe_raw(),
                    lambda: _maybe_cropped()):
        try:
            root = root_fn()
        except RuntimeError:
            root = None
        if root is not None and os.path.isdir(root):
            candidates += subdirs(root, prefix=startswith, join=False)
    # trained-model folders count too (task_name_id_conversion.py:37-41)
    if paths.get_results_dir() is not None:
        base = paths.network_training_output_dir()
        for m in ("2d", "3d_lowres", "3d_fullres", "3d_cascade_fullres"):
            mdir = os.path.join(base, m)
            if os.path.isdir(mdir):
                candidates += subdirs(mdir, prefix=startswith, join=False)
    unique = sorted(set(candidates))
    if len(unique) == 0:
        raise RuntimeError(
            f"Could not find a task with id {task_id}. Make sure the requested task "
            "is converted/preprocessed and the environment paths are set.")
    if len(unique) > 1:
        raise RuntimeError(f"More than one task name found for id {task_id}: {unique}")
    return unique[0]


def convert_task_name_to_id(task_name: str) -> int:
    assert task_name.startswith("Task"), task_name
    return int(task_name[4:7])


def _maybe_raw() -> str | None:
    base = paths.get_raw_data_base()
    if base is None:
        return None
    return os.path.join(base, "nnUNet_raw_data")


def _maybe_cropped() -> str | None:
    base = paths.get_raw_data_base()
    if base is None:
        return None
    return os.path.join(base, "nnUNet_cropped_data")
