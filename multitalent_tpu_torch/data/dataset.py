"""Preprocessed-dataset access: lazy case dict, npz->npy unpacking for fast memmap
reads, and the deterministic 5-fold split.

Parity targets: nnunet/training/dataloading/dataset_loading.py:58-110 (load_dataset /
unpack_dataset / delete_npy) and network_trainer.py:147-183 (KFold(5, shuffle,
random_state=12345) split).

The port's copy of multitalent_tpu/data/dataset.py.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multitalent_tpu_torch.utils import load_pickle, subfiles


def get_case_identifiers(folder: str) -> list[str]:
    # segFromPrevStage files live next to the cases but are not cases themselves
    # (dataset_loading.py:47-51)
    return [os.path.basename(f)[:-4] for f in subfiles(folder, suffix=".npz")
            if "segFromPrevStage" not in os.path.basename(f)]


def load_dataset(folder: str, num_cases_properties_loading_threshold: int = 1000) -> dict:
    """Build {case_id: {'data_file', 'properties_file' [, 'properties']}}. Properties
    are preloaded into RAM for small datasets (same threshold policy as the reference)."""
    case_identifiers = sorted(get_case_identifiers(folder))
    dataset = {}
    for c in case_identifiers:
        dataset[c] = {
            "data_file": os.path.join(folder, f"{c}.npz"),
            "properties_file": os.path.join(folder, f"{c}.pkl"),
        }
    if len(case_identifiers) <= num_cases_properties_loading_threshold:
        for c in case_identifiers:
            dataset[c]["properties"] = load_pickle(dataset[c]["properties_file"])
    return dataset


def _unpack_one(npz_path: str) -> None:
    npy_path = npz_path[:-4] + ".npy"
    if os.path.isfile(npy_path):
        return
    data = np.load(npz_path)["data"]
    np.save(npy_path, data)


def unpack_dataset(folder: str, threads: int = 8) -> None:
    """Decompress every case npz into a raw npy so the patch sampler can memmap it."""
    npzs = subfiles(folder, suffix=".npz")
    with ThreadPoolExecutor(max_workers=threads) as pool:
        list(pool.map(_unpack_one, npzs))


def delete_npy(folder: str) -> None:
    for f in subfiles(folder, suffix=".npy"):
        os.remove(f)


def load_case(entry: dict, memmap_mode: str = "r") -> np.ndarray:
    """(C+1, Z, Y, X) stacked data+seg; memmaps the unpacked npy when available."""
    npy = entry["data_file"][:-4] + ".npy"
    if os.path.isfile(npy):
        return np.load(npy, mmap_mode=memmap_mode)
    return np.load(entry["data_file"])["data"]


def kfold_split(keys: list[str], n_splits: int = 5, seed: int = 12345) -> list[dict]:
    """Deterministic shuffled K-fold over sorted case ids. Replicates
    sklearn.model_selection.KFold(shuffle=True, random_state=seed) index assignment
    exactly (verified in tests), without the dependency."""
    keys = np.array(sorted(keys))
    n = len(keys)
    idx = np.arange(n)
    np.random.RandomState(seed).shuffle(idx)
    sizes = np.full(n_splits, n // n_splits, dtype=int)
    sizes[: n % n_splits] += 1
    splits = []
    cur = 0
    for s in sizes:
        te = np.sort(idx[cur:cur + s])
        tr = np.sort(np.setdiff1d(idx, te))
        splits.append({"train": keys[tr].tolist(), "val": keys[te].tolist()})
        cur += s
    return splits
