"""Small file/folder helpers (the reference uses batchgenerators' equivalents
throughout; these replace `subfiles`, `maybe_mkdir_p`, `save/load_pickle/json`).

The port's copy of multitalent_tpu/utils/fileops.py; `process_pool` forks
only while CUDA is not initialised.
"""
from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any


def maybe_mkdir(path: str | Path) -> str:
    Path(path).mkdir(parents=True, exist_ok=True)
    return str(path)


def subfiles(folder: str | Path, prefix: str | None = None, suffix: str | None = None,
             join: bool = True, sort: bool = True) -> list[str]:
    folder = Path(folder)
    out = []
    for p in folder.iterdir():
        if not p.is_file():
            continue
        if prefix is not None and not p.name.startswith(prefix):
            continue
        if suffix is not None and not p.name.endswith(suffix):
            continue
        out.append(str(p) if join else p.name)
    if sort:
        out.sort()
    return out


def subdirs(folder: str | Path, prefix: str | None = None, join: bool = True,
            sort: bool = True) -> list[str]:
    folder = Path(folder)
    out = []
    for p in folder.iterdir():
        if not p.is_dir():
            continue
        if prefix is not None and not p.name.startswith(prefix):
            continue
        out.append(str(p) if join else p.name)
    if sort:
        out.sort()
    return out


class _NumpyJSONEncoder(json.JSONEncoder):
    def default(self, o):
        import numpy as np

        if isinstance(o, np.integer):
            return int(o)
        if isinstance(o, np.floating):
            return float(o)
        if isinstance(o, np.ndarray):
            return o.tolist()
        if isinstance(o, (np.bool_,)):
            return bool(o)
        return super().default(o)


def save_json(obj: Any, path: str | Path, sort_keys: bool = True) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, sort_keys=sort_keys, indent=2, cls=_NumpyJSONEncoder)


def load_json(path: str | Path) -> Any:
    with open(path) as f:
        return json.load(f)


def save_pickle(obj: Any, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(obj, f)


def load_pickle(path: str | Path) -> Any:
    with open(path, "rb") as f:
        return pickle.load(f)


def process_pool(max_workers: int):
    """Worker pool for host-side parallel work (cropping, preprocessing, metric
    evaluation, CC postprocessing).

    Start-method choice is a real constraint here:
    - a child forked after CUDA was initialised cannot use CUDA, and the
      driver's threads and locks do not survive the fork;
    - spawn/forkserver re-import the caller's __main__, re-executing unguarded
      scripts (and paying a torch re-import per worker).
    So: fork while CUDA is not initialised (the plan/preprocess path — matches
    the reference's Pool-based parallelism), otherwise a thread pool (the
    workloads are numpy/scipy/BLAS-bound and release the GIL)."""
    import sys
    from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        return ThreadPoolExecutor(max_workers=max_workers)
    import multiprocessing
    return ProcessPoolExecutor(max_workers=max_workers,
                               mp_context=multiprocessing.get_context("fork"))
