"""Folder-level inference on the GPU.

Counterpart of multitalent_tpu/inference/predict.py (`predict_cases` :67 and
`predict_from_folder` :311, same argument surface plus `device`). Per case:

1. the plans-driven preprocessor (host, numpy; preprocessing/, the port's
   copy of the JAX package's) crops, resamples and normalises the volume;
2. every fold's network runs the sliding window on the device and the fold
   probabilities are summed there; the network call is the fused conv ->
   norm route under MTTPU_FUSED_NORM=1 (ops/fused_unet.make_inference_forward);
3. for region (sigmoid) models the sum is resized back to the post-cropping
   grid and thresholded at 0.5 * n_folds on the device
   (ops/device_export.py); only bool masks come to the host. Softmax models,
   `save_npz`, and cases that need the separate-z resampling take the host
   export (inference/segmentation_export.py:
   save_segmentation_nifti_from_softmax);
4. NIfTI writing runs on host threads: `<case>.nii.gz`, plus
   `individual/<region>/<case>.nii.gz` per region with export_region_niftis.

Cases run one after another; preprocessing of later cases runs ahead on
threads, at most `num_threads_preprocessing` cases ahead of the predictor.
"""
from __future__ import annotations

import collections
import itertools
import os
import shutil
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                          read_model_folder)
from multitalent_tpu_torch.inference.segmentation_export import (
    save_segmentation_nifti, save_segmentation_nifti_from_softmax)
from multitalent_tpu_torch.ops.device_export import (can_export_on_device,
                                                     device_resample_threshold_bits,
                                                     segmentation_from_regions_bits)
from multitalent_tpu_torch.ops.fused_unet import make_inference_forward
from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor
from multitalent_tpu_torch.preprocessing.preprocessor import resolve_preprocessor
from multitalent_tpu_torch.tasks.multitalent import REGIONS
from multitalent_tpu_torch.utils.fileops import maybe_mkdir, subfiles


def resolve_device(device: str | torch.device) -> torch.device:
    """The requested device; a CUDA device without a usable card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() "
                           "is False (pass --device cpu to run the plain PyTorch "
                           "versions on the CPU)")
    return device


def check_input_folder_and_return_caseIDs(input_folder: str,
                                          expected_num_modalities: int) -> list[str]:
    """Case discovery by the `_XXXX.nii.gz` convention (predict.py:567-601;
    multitalent_tpu/inference/predict.py:29)."""
    files = subfiles(input_folder, suffix=".nii.gz", join=False)
    maybe_case_ids = sorted({f[:-12] for f in files})
    remaining = set(files)
    missing = []
    for c in maybe_case_ids:
        for mod in range(expected_num_modalities):
            expected = f"{c}_{mod:04d}.nii.gz"
            if expected not in remaining:
                missing.append(expected)
            else:
                remaining.discard(expected)
    # raised explicitly (not `assert`, which -O strips): the folder is user input
    if missing:
        raise AssertionError(f"missing modality files: {missing[:10]}")
    if remaining:
        raise AssertionError(f"unexpected files: {sorted(remaining)[:10]}")
    return maybe_case_ids


def _make_preprocess_fn(restored):
    """case files -> (data, properties) by the plans' preprocessor at the
    stage's spacing (multitalent_tpu/inference/predict.py:48)."""
    plans = restored.plans
    preprocessor_cls = resolve_preprocessor(plans.preprocessor_name)
    intensity_props = plans.dataset_properties.get("intensityproperties") \
        if plans.dataset_properties else None
    preprocessor = preprocessor_cls(
        plans.normalization_schemes,
        plans.use_mask_for_norm, plans.transpose_forward, intensity_props)
    target_spacing = plans.stage(restored.stage).current_spacing

    def preprocess(case_files):
        data, _, properties = preprocessor.preprocess_test_case(
            case_files, target_spacing)
        return data, properties

    return preprocess


def _read_ahead(pool, fn, items, depth: int):
    """fn(item) for each item, in order, computed on `pool` at most `depth`
    items ahead of the consumer: while the consumer holds result i, only
    items i+1..i+depth are submitted. (`pool.map` submits every item at
    once, so the host would hold every preprocessed case of a folder.)"""
    items = iter(items)
    pending = collections.deque(pool.submit(fn, item)
                                for item in itertools.islice(items, max(depth, 1)))
    while pending:
        result = pending.popleft().result()
        pending.extend(pool.submit(fn, item) for item in itertools.islice(items, 1))
        yield result


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def predict_cases(model: str, list_of_lists: list[list[str]],
                  output_filenames: list[str], folds, save_npz: bool = False,
                  num_threads_preprocessing: int = 2,
                  num_threads_nifti_save: int = 2, segs_from_prev_stage=None,
                  do_tta: bool = True, overwrite_existing: bool = True,
                  all_in_gpu: bool = False, step_size: float = 0.5,
                  checkpoint_name: str = "model_final_checkpoint",
                  region_class_order=None, export_region_niftis: bool = False,
                  fast_mode: str | None = None,
                  device: str | torch.device = "cuda") -> list[dict]:
    """Predict a list of cases with a fold ensemble (predict_cases parity,
    predict.py:131-292). `all_in_gpu` is accepted for parity: the volume and
    accumulators always live on the device. Returns one dict of timings per
    case predicted (seconds on the host clock, device work synchronised)."""
    if fast_mode is not None:
        raise NotImplementedError("fast/fastest modes are not ported yet (ROADMAP "
                                  "queue 1, item 4)")
    if segs_from_prev_stage is not None:
        raise NotImplementedError("cascade inference is not ported yet (ROADMAP "
                                  "queue 1, item 10)")
    assert len(list_of_lists) == len(output_filenames)
    device = resolve_device(device)

    if not overwrite_existing:
        keep = [i for i, o in enumerate(output_filenames)
                if not (os.path.isfile(o)
                        and (not save_npz or os.path.isfile(o[:-7] + ".npz")))]
        list_of_lists = [list_of_lists[i] for i in keep]
        output_filenames = [output_filenames[i] for i in keep]
    if not output_filenames:
        return []

    restored = load_model_and_checkpoint_files(model, folds, checkpoint_name, device)
    n_folds = len(restored.networks)
    forwards = [make_inference_forward(net) for net in restored.networks]
    if region_class_order is None:
        region_class_order = restored.regions_class_order
    predictor = SlidingWindowPredictor(
        restored.patch_size, in_channels=restored.plans.num_modalities,
        num_classes=restored.num_classes, nonlin=restored.inference_nonlin,
        step_size=step_size, do_mirroring=do_tta, mirror_axes=(0, 1, 2),
        device=device)

    timings = []
    futures = []
    with ThreadPoolExecutor(max_workers=num_threads_preprocessing) as prep_pool, \
            ThreadPoolExecutor(max_workers=num_threads_nifti_save) as export_pool:
        preprocessed = _read_ahead(prep_pool, _make_preprocess_fn(restored), list_of_lists,
                                   num_threads_preprocessing)
        for out_fname, (data, properties) in zip(output_filenames, preprocessed):
            t0, forwards0 = time.perf_counter(), predictor.forwards
            probs_sum = None
            for forward in forwards:
                probs = predictor.predict(forward, data)
                probs_sum = probs if probs_sum is None else probs_sum + probs
            _sync(device)
            t1 = time.perf_counter()
            maybe_mkdir(os.path.dirname(out_fname) or ".")
            case_id = os.path.basename(out_fname)[:-7]
            on_device = (region_class_order is not None and not save_npz
                         and can_export_on_device(properties))
            if on_device:
                futures += _export_on_device(
                    export_pool, probs_sum, n_folds, properties, out_fname, case_id,
                    region_class_order, export_region_niftis)
            else:
                probs_mean = (probs_sum / n_folds).cpu().numpy()
                futures += _export_on_host(
                    export_pool, probs_mean, properties, out_fname, case_id,
                    region_class_order, export_region_niftis, save_npz)
            del probs_sum
            timings.append({"case": case_id, "predict_s": t1 - t0,
                            "export_s": time.perf_counter() - t1,
                            "forwards": predictor.forwards - forwards0})
        for f in futures:
            f.result()
    return timings


def _export_on_device(pool, probs_sum, n_folds, properties, out_fname, case_id,
                      region_class_order, export_region_niftis, channels=None) -> list:
    """Resize + threshold on the device (mean > 0.5 <=> fold sum > 0.5 *
    n_folds), fetch bool masks, write the labelmap (of `channels`, all by
    default, stamped in region_class_order) and the region files."""
    tb = properties.get("transpose_backward")
    if tb is not None and list(tb) != [0, 1, 2]:
        probs_sum = probs_sum.permute(0, *[int(i) + 1 for i in tb])
    out_shape = tuple(int(s) for s in properties["size_after_cropping"])
    masks = device_resample_threshold_bits(probs_sum, out_shape,
                                           threshold=0.5 * n_folds)
    seg = segmentation_from_regions_bits(masks if channels is None else masks[channels],
                                         region_class_order).cpu().numpy()
    masks = masks.cpu().numpy()
    futures = [pool.submit(save_segmentation_nifti, seg, out_fname, properties)]
    if export_region_niftis:
        individual = maybe_mkdir(os.path.join(os.path.dirname(out_fname), "individual"))
        for i, r in zip(range(masks.shape[0]), REGIONS):
            rdir = maybe_mkdir(os.path.join(individual, r))
            futures.append(pool.submit(
                save_segmentation_nifti, masks[i].astype(np.float32),
                os.path.join(rdir, case_id + ".nii.gz"), dict(properties)))
    return futures


def _export_on_host(pool, probs_mean, properties, out_fname, case_id,
                    region_class_order, export_region_niftis, save_npz,
                    channels=None) -> list:
    """The host export chain (segmentation_export.py) on the fetched mean
    probabilities; the labelmap of `channels` (all by default)."""
    npz_fname = out_fname[:-7] + ".npz" if save_npz else None
    futures = [pool.submit(
        save_segmentation_nifti_from_softmax,
        probs_mean if channels is None else probs_mean[channels], out_fname, properties, 1,
        region_class_order, None, None, npz_fname, None, None, 0)]
    if export_region_niftis:
        individual = maybe_mkdir(os.path.join(os.path.dirname(out_fname), "individual"))
        for r, ch in zip(REGIONS, range(probs_mean.shape[0])):
            rdir = maybe_mkdir(os.path.join(individual, r))
            futures.append(pool.submit(
                save_segmentation_nifti_from_softmax, probs_mean[ch][None],
                os.path.join(rdir, case_id + ".nii.gz"), dict(properties),
                1, ((1,),)))
    return futures


def predict_from_folder(model: str, input_folder: str, output_folder: str, folds,
                        save_npz: bool = False, num_threads_preprocessing: int = 2,
                        num_threads_nifti_save: int = 2,
                        lowres_segmentations=None, part_id: int = 0,
                        num_parts: int = 1, tta: bool = True,
                        overwrite_existing: bool = True, all_in_gpu: bool = False,
                        step_size: float = 0.5,
                        checkpoint_name: str = "model_final_checkpoint",
                        multitalent_regions: bool = False,
                        mode: str = "normal",
                        device: str | torch.device = "cuda") -> list[dict]:
    """predict_from_folder parity (predict.py:603): case discovery by the
    `_XXXX.nii.gz` convention, `part_id::num_parts` sharding."""
    if lowres_segmentations is not None:
        raise NotImplementedError("cascade inference is not ported yet (ROADMAP "
                                  "queue 1, item 10)")
    device = resolve_device(device)
    maybe_mkdir(output_folder)
    plans_path = os.path.join(model, "plans.pkl")
    if os.path.isfile(plans_path):  # a JAX-trained folder keeps its plans elsewhere
        shutil.copy(plans_path, output_folder)
    expected_num_modalities = read_model_folder(model, folds, checkpoint_name)[0].num_modalities
    case_ids = check_input_folder_and_return_caseIDs(input_folder,
                                                     expected_num_modalities)
    output_files = [os.path.join(output_folder, c + ".nii.gz") for c in case_ids]
    all_files = subfiles(input_folder, suffix=".nii.gz", join=False)
    list_of_lists = [
        [os.path.join(input_folder, f) for f in all_files
         if f.startswith(c + "_") and len(f) == len(c) + 12]
        for c in case_ids
    ]
    if mode not in ("normal", "fast", "fastest"):
        raise ValueError(f"unknown mode {mode!r}")
    return predict_cases(
        model, list_of_lists[part_id::num_parts], output_files[part_id::num_parts],
        folds, save_npz, num_threads_preprocessing, num_threads_nifti_save,
        None, tta, overwrite_existing, all_in_gpu, step_size, checkpoint_name,
        export_region_niftis=multitalent_regions,
        fast_mode=None if mode == "normal" else mode, device=device)
