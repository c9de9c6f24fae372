"""Segmentation overlay PNG generation.

The port's copy of multitalent_tpu/utils/overlay_plots.py: host numpy, PNGs
written with zlib (no imaging package), byte for byte the JAX package's.

Parity target: nnunet/utilities/overlay_plots.py:41-191 (`generate_overlay`:
blend the image slice with per-class colors; `plot_overlay` picks the slice with
the most foreground; folder CLI generating one PNG per case).
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.io.nifti import read_nifti
from multitalent_tpu_torch.utils.fileops import maybe_mkdir, subfiles

# default color cycle (RGB 0-255), matching the reference's hex palette intent
COLOR_CYCLE = [
    (0, 0, 0), (255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0),
    (255, 0, 255), (0, 255, 255), (255, 128, 0), (128, 0, 255), (0, 128, 255),
    (128, 255, 0), (255, 0, 128), (0, 255, 128),
]


def generate_overlay(image_2d: np.ndarray, seg_2d: np.ndarray,
                     color_cycle=COLOR_CYCLE, overlay_intensity: float = 0.6) -> np.ndarray:
    """(H, W) image + label map -> (H, W, 3) uint8 overlay."""
    img = image_2d.astype(np.float64)
    img -= img.min()
    if img.max() > 0:
        img /= img.max()
    rgb = np.stack([img * 255] * 3, axis=-1)
    for label in np.unique(seg_2d):
        if label == 0:
            continue
        color = color_cycle[int(label) % len(color_cycle)]
        mask = seg_2d == label
        rgb[mask] = (1 - overlay_intensity) * rgb[mask] + overlay_intensity * np.array(color)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def select_slice(seg_3d: np.ndarray) -> int:
    """Slice with the most foreground (plot_overlay's heuristic)."""
    fg_per_slice = (seg_3d > 0).sum(axis=(1, 2))
    return int(np.argmax(fg_per_slice)) if fg_per_slice.max() > 0 \
        else seg_3d.shape[0] // 2


def plot_overlay(image_file: str, seg_file: str, output_file: str,
                 overlay_intensity: float = 0.6) -> None:
    image, _ = read_nifti(image_file)
    seg, _ = read_nifti(seg_file)
    assert image.shape == seg.shape, "image/seg shape mismatch"
    s = select_slice(seg)
    overlay = generate_overlay(image[s], seg[s], overlay_intensity=overlay_intensity)
    _write_png(output_file, overlay)


def plot_overlay_folder(image_folder: str, seg_folder: str, output_folder: str,
                        modality: int = 0, processes: int = 4) -> None:
    maybe_mkdir(output_folder)
    segs = subfiles(seg_folder, suffix=".nii.gz", join=False)

    def run(f):
        case = f[:-7]
        img = os.path.join(image_folder, f"{case}_{modality:04d}.nii.gz")
        if not os.path.isfile(img):
            img = os.path.join(image_folder, f)
        plot_overlay(img, os.path.join(seg_folder, f),
                     os.path.join(output_folder, case + ".png"))

    with ThreadPoolExecutor(max_workers=processes) as pool:
        list(pool.map(run, segs))


def plot_overlay_preprocessed(case_npz: str, output_file: str,
                              overlay_intensity: float = 0.6,
                              modality_index: int = 0) -> None:
    """Overlay straight from a preprocessed .npz case (data[-1] is the seg
    map, negative values are the outside-mask sentinel; reference
    overlay_plots.py:110-124)."""
    data = np.load(case_npz)["data"]
    assert modality_index < data.shape[0] - 1, \
        f"modality_index {modality_index} out of range for {case_npz}"
    seg = data[-1].copy()
    seg[seg < 0] = 0
    image = data[modality_index]
    s = select_slice(seg)
    _write_png(output_file,
               generate_overlay(image[s], seg[s],
                                overlay_intensity=overlay_intensity))


def generate_overlays_for_task(task_name_or_id, output_folder: str,
                               num_processes: int = 8, modality_idx: int = 0,
                               use_preprocessed: bool = True,
                               data_identifier: str = paths.default_data_identifier) -> None:
    """One overlay PNG per training case of a task (reference
    overlay_plots.py:150-188): from the preprocessed npz stage folder
    (highest stage of `data_identifier`) or from raw imagesTr/labelsTr."""
    from multitalent_tpu_torch.utils.task_names import convert_id_to_task_name

    task = str(task_name_or_id)
    if not task.startswith("Task"):
        task = convert_id_to_task_name(int(task))
    maybe_mkdir(output_folder)
    if not use_preprocessed:
        folder = os.path.join(paths.nnUNet_raw_data(), task)
        plot_overlay_folder(os.path.join(folder, "imagesTr"),
                            os.path.join(folder, "labelsTr"),
                            output_folder, modality=modality_idx,
                            processes=num_processes)
        return
    folder = os.path.join(paths.preprocessing_output_dir(), task)
    if not os.path.isdir(folder):
        raise RuntimeError(f"run preprocessing for {task} first")
    from multitalent_tpu_torch.utils.fileops import subdirs
    stages = sorted(subdirs(folder, prefix=data_identifier + "_stage"))
    if not stages:
        raise RuntimeError(
            f"no {data_identifier}_stage* folder under {folder}; run "
            "preprocessing with the default planner first")
    stage = stages[-1]
    cases = subfiles(stage, suffix=".npz", join=False)

    def run(f):
        plot_overlay_preprocessed(
            os.path.join(stage, f),
            os.path.join(output_folder, f[:-4] + ".png"),
            modality_index=modality_idx)

    with ThreadPoolExecutor(max_workers=num_processes) as pool:
        list(pool.map(run, cases))


def _write_png(path: str, rgb: np.ndarray) -> None:
    """Minimal PNG writer (no external imaging dependency): 8-bit RGB."""
    import struct
    import zlib

    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c) & 0xFFFFFFFF)

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
