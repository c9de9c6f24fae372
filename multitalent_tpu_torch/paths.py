"""Directory layout derived from environment variables.

Mirrors the reference contract (nnunet/paths.py:19-58): three roots configured via env
vars, with derived subfolders for raw, cropped, preprocessed data and trained models.
We accept both the historical nnU-Net variable names and MTTPU_* aliases.

Unlike the reference (module-level globals evaluated at import), paths are resolved
lazily through functions so tests can monkeypatch the environment.

The port's copy of multitalent_tpu/paths.py, with the two constants of
multitalent_tpu/configuration.py the port reads.
"""
from __future__ import annotations

import os
from pathlib import Path

# Identifiers (reference: nnunet/paths.py:21-27)
default_plans_identifier = "MTTPUPlansv2.1"
default_data_identifier = "MTTPUData_plans_v2.1"
default_trainer = "TrainerV2"
default_cascade_trainer = "TrainerV2CascadeFullRes"

# worker processes of the host-side data pipeline (reference: configuration.py:3)
default_num_threads = int(os.environ.get("MTTPU_def_n_proc",
                                         os.environ.get("nnUNet_def_n_proc", 8)))

# If the spacing ratio between the out-of-plane axis and the in-plane axes exceeds this,
# resampling is done separately along that axis (nearest/linear) to avoid interpolation
# artifacts in highly anisotropic CT (reference: configuration.py:4).
RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD = 3


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v:
            return v
    return None


def get_raw_data_base() -> str | None:
    return _env("nnUNet_raw_data_base", "MTTPU_raw_data_base")


def get_preprocessed_dir() -> str | None:
    return _env("nnUNet_preprocessed", "MTTPU_preprocessed")


def get_results_dir() -> str | None:
    return _env("RESULTS_FOLDER", "MTTPU_results")


def nnUNet_raw_data() -> str:
    base = get_raw_data_base()
    if base is None:
        raise RuntimeError(
            "nnUNet_raw_data_base / MTTPU_raw_data_base is not set; cannot locate raw data."
        )
    p = Path(base) / "nnUNet_raw_data"
    p.mkdir(parents=True, exist_ok=True)
    return str(p)


def nnUNet_cropped_data() -> str:
    base = get_raw_data_base()
    if base is None:
        raise RuntimeError(
            "nnUNet_raw_data_base / MTTPU_raw_data_base is not set; cannot locate cropped data."
        )
    p = Path(base) / "nnUNet_cropped_data"
    p.mkdir(parents=True, exist_ok=True)
    return str(p)


def preprocessing_output_dir() -> str:
    base = get_preprocessed_dir()
    if base is None:
        raise RuntimeError("nnUNet_preprocessed / MTTPU_preprocessed is not set.")
    Path(base).mkdir(parents=True, exist_ok=True)
    return base


def network_training_output_dir() -> str:
    base = get_results_dir()
    if base is None:
        raise RuntimeError("RESULTS_FOLDER / MTTPU_results is not set.")
    p = Path(base) / "nnUNet"
    p.mkdir(parents=True, exist_ok=True)
    return str(p)
