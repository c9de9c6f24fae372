"""Folder-level inference on the GPU.

Counterpart of multitalent_tpu/inference/predict.py (`predict_cases` :67,
`predict_cases_fast` :277, `predict_cases_fastest` :294,
`predict_from_folder` :311 and `ensemble_predictions` :356, same argument
surface plus `device`). Per case:

1. the plans-driven preprocessor (host, numpy; preprocessing/, the port's
   copy of the JAX package's) crops, resamples and normalises the volume,
   on threads that run at most `num_threads_preprocessing` cases ahead;
2. the volume goes to the device once (`SlidingWindowPredictor.begin_put`),
   every fold's network runs the sliding window on it there, and the fold
   probabilities are summed there; the network call is the fused conv ->
   norm route under MTTPU_FUSED_NORM=1 (ops/fused_unet.make_inference_forward);
3. the export (ops/device_export.py), on the device unless the case needs
   the separate-z resampling, `save_npz` asks for the probabilities or
   MTTPU_DEVICE_EXPORT=0 switches it off (predict.py:123-132): region
   (sigmoid) models are resized and thresholded at 0.5 * n_folds, softmax
   models resized and argmaxed (normal and fast modes) or argmaxed and
   resized by nearest neighbour (fastest), so only bool masks or an int
   labelmap cross to the host. Otherwise the mean probabilities come to the
   host for inference/segmentation_export.py:
   save_segmentation_nifti_from_softmax (with `<case>.npz` under save_npz);
4. NIfTI writing runs on host threads: `<case>.nii.gz`, plus
   `individual/<region>/<case>.nii.gz` per region with export_region_niftis.

Cases overlap as in the JAX package (:251-269): the previous case's export
is put on the device before this case's folds, the next case's volume is
put (from pinned memory, without blocking) while this case computes, and
the previous case's result is then fetched and written.
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
                                                     device_argmax_resample_nearest,
                                                     device_resample_argmax,
                                                     device_resample_threshold_bits,
                                                     segmentation_from_regions_bits)
from multitalent_tpu_torch.ops.fused_unet import make_inference_forward
from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor, refuse_2d_prediction
from multitalent_tpu_torch.preprocessing.preprocessor import resolve_preprocessor
from multitalent_tpu_torch.tasks.multitalent import REGIONS
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir, subfiles


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


class _Clock:
    """Seconds of the work issued between its creation and `stop()`: CUDA
    events on a CUDA device (read once that work has run), the host clock
    on the CPU, where work runs as it is issued."""

    def __init__(self, device: torch.device):
        self.events = None
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            self.events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self.events[0].record(stream)
            self.stream = stream
        self.t = [time.perf_counter()]

    def stop(self) -> None:
        if self.events is not None:
            self.events[1].record(self.stream)
        self.t.append(time.perf_counter())

    def seconds(self) -> float:
        if self.events is None:
            return self.t[1] - self.t[0]
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1]) / 1e3


def _fetch_begin(*tensors):
    """Start copying device tensors (None passes through) to the host: into
    pinned memory without blocking from a CUDA device, with an event behind
    the copies. The token goes to _fetch_finish."""
    host, event = [], None
    for t in tensors:
        if t is not None and t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
            event = torch.cuda.Event()
        host.append(t)
    if event is not None:
        event.record()
    return host, event


def _fetch_finish(token) -> list:
    """The host arrays of a _fetch_begin token, once its copies are done."""
    host, event = token
    if event is not None:
        event.synchronize()
    return [None if t is None else t.numpy() for t in host]


def _device_export_begin(probs_sum, n_folds, properties, region_class_order,
                         export_region_niftis, fast_mode=None, channels=None):
    """Put a case's export on the device and start fetching its result: the
    fold-summed probabilities (K, Z, Y, X) back in the original axis order,
    resized to `size_after_cropping`; region masks thresholded at 0.5 *
    n_folds (mean > 0.5) where the labelmap is made of regions (those of
    `channels`, all by default, stamped in region_class_order) or the
    region files are asked for; else the argmax labelmap, resized before the
    argmax or (fastest) after it (predict.py:169-177)."""
    tb = properties.get("transpose_backward")
    if tb is not None and list(tb) != [0, 1, 2]:
        probs_sum = probs_sum.permute(0, *[int(i) + 1 for i in tb])
    out_shape = tuple(int(s) for s in properties["size_after_cropping"])
    masks = None
    if region_class_order is not None or export_region_niftis:
        masks = device_resample_threshold_bits(probs_sum, out_shape, threshold=0.5 * n_folds)
    if region_class_order is not None:
        seg = segmentation_from_regions_bits(masks if channels is None else masks[channels],
                                             region_class_order)
    elif fast_mode == "fastest":
        seg = device_argmax_resample_nearest(probs_sum, out_shape)
    else:
        seg = device_resample_argmax(probs_sum, out_shape)
    return _fetch_begin(seg, masks if export_region_niftis else None)


def _device_export_write(pool, token, properties, out_fname, case_id) -> list:
    """Fetch a _device_export_begin token and write the labelmap and, where
    they were fetched, the region files, on the pool."""
    seg, masks = _fetch_finish(token)
    futures = [pool.submit(save_segmentation_nifti, seg.astype(np.float32, copy=False),
                           out_fname, properties)]
    if masks is not None:
        individual = maybe_mkdir(os.path.join(os.path.dirname(out_fname), "individual"))
        for i, r in zip(range(masks.shape[0]), REGIONS):
            rdir = maybe_mkdir(os.path.join(individual, r))
            futures.append(pool.submit(
                save_segmentation_nifti, masks[i].astype(np.float32),
                os.path.join(rdir, case_id + ".nii.gz"), dict(properties)))
    return futures


def _export_on_device(pool, probs_sum, n_folds, properties, out_fname, case_id,
                      region_class_order, export_region_niftis, channels=None) -> list:
    """The device export of one case at once: resize + threshold (or
    argmax) on the device, fetch, write."""
    return _device_export_write(
        pool, _device_export_begin(probs_sum, n_folds, properties, region_class_order,
                                   export_region_niftis, channels=channels),
        properties, out_fname, case_id)


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
    predict.py:131-292). fast_mode: None (full), "fast" (no probabilities
    kept, argmax of the resized sum: predict_cases_fast, predict.py:294) or
    "fastest" (argmax on the network's grid, the labelmap resized by nearest
    neighbour: predict_cases_fastest, predict.py:442). `all_in_gpu` is
    accepted for parity: the volume and accumulators always live on the
    device.

    Returns one dict a case: `predict_s`, the seconds of its folds' sliding
    windows (on the device's clock on a CUDA device), `export_s`, the host
    seconds its export held the case loop (NIfTI writing runs on threads
    outside it), its `forwards` (tiles x mirror combinations x folds),
    `net_calls` (network calls) and `puts` (volumes put on the device)."""
    if fast_mode not in (None, "fast", "fastest"):
        raise ValueError(f"fast_mode must be None, 'fast' or 'fastest', got {fast_mode!r}")
    if fast_mode and save_npz:
        raise ValueError("the fast modes never materialize the probabilities: no save_npz")
    if segs_from_prev_stage is not None:
        raise NotImplementedError(
            "segs_from_prev_stage: the JAX package's predict_cases accepts it and never "
            "reads it (multitalent_tpu/inference/predict.py:70), so it predicts no cascade "
            "stage from it; the port takes no previous-stage input either")
    if len(list_of_lists) != len(output_filenames):
        raise ValueError("one output file a case")
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
    if len(restored.patch_size) != 3:
        refuse_2d_prediction(f"predicting with {model}")
    n_folds = len(restored.networks)
    forwards = [make_inference_forward(net) for net in restored.networks]
    if region_class_order is None:
        region_class_order = restored.regions_class_order
    predictor = SlidingWindowPredictor(
        restored.patch_size, in_channels=restored.plans.num_modalities,
        num_classes=restored.num_classes, nonlin=restored.inference_nonlin,
        step_size=step_size, do_mirroring=do_tta, mirror_axes=(0, 1, 2),
        device=device)
    device_export = not save_npz and os.environ.get("MTTPU_DEVICE_EXPORT", "1") != "0"

    timings, futures = [], []

    def put(item):
        """The case's volume put on the device, and the put count before it."""
        puts0 = predictor.puts
        return predictor.begin_put(item[1][0]), puts0

    def run_case(item, put_token) -> dict:
        """Every fold's sliding window on the case's one device volume,
        summed on the device (fp16 in the default mode, as the JAX
        package's sum of its fp16 results)."""
        out_fname, (_, properties) = item
        (preput, puts0), counts0 = put_token, (predictor.forwards, predictor.net_calls)
        clock = _Clock(device)
        probs_sum = None
        for forward in forwards:
            probs = predictor.predict(forward, preput=preput)
            probs_sum = probs if probs_sum is None else probs_sum + probs
        clock.stop()
        timing = {"case": os.path.basename(out_fname)[:-7],
                  "forwards": predictor.forwards - counts0[0],
                  "net_calls": predictor.net_calls - counts0[1],
                  "puts": predictor.puts - puts0}
        timings.append(timing)
        return {"out": out_fname, "properties": properties, "probs": probs_sum,
                "clock": clock, "timing": timing}

    def export_begin(case):
        """The case's device export put on the device (None: the host
        export applies)."""
        t0 = time.perf_counter()
        token = None
        if device_export and can_export_on_device(case["properties"]):
            token = _device_export_begin(case["probs"], n_folds, case["properties"],
                                         region_class_order, export_region_niftis, fast_mode)
        case["timing"]["export_s"] = time.perf_counter() - t0
        return token

    def export_finish(case, token) -> None:
        t0 = time.perf_counter()
        out_fname, properties = case["out"], case["properties"]
        maybe_mkdir(os.path.dirname(out_fname) or ".")
        case_id = os.path.basename(out_fname)[:-7]
        if token is not None:
            futures.extend(_device_export_write(export_pool, token, properties, out_fname,
                                                case_id))
        else:
            probs_mean = (case.pop("probs").float() / n_folds).cpu().numpy()
            futures.extend(_export_on_host(export_pool, probs_mean, properties, out_fname,
                                           case_id, region_class_order, export_region_niftis,
                                           save_npz))
        case["timing"]["export_s"] += time.perf_counter() - t0
        case["timing"]["predict_s"] = case["clock"].seconds()

    with ThreadPoolExecutor(max_workers=num_threads_preprocessing) as prep_pool, \
            ThreadPoolExecutor(max_workers=num_threads_nifti_save) as export_pool:
        cases = zip(output_filenames, _read_ahead(prep_pool, _make_preprocess_fn(restored),
                                                  list_of_lists, num_threads_preprocessing))
        item = next(cases, None)
        next_put = put(item) if item is not None else None
        pending = None
        while item is not None:
            # the previous case's export goes on the device first, then this
            # case's folds, then the next case's put; the previous case's
            # result is fetched and written while this case computes
            token = export_begin(pending) if pending is not None else None
            current = run_case(item, next_put)
            item = next(cases, None)
            next_put = put(item) if item is not None else None
            if pending is not None:
                export_finish(pending, token)
            pending = current
        if pending is not None:
            export_finish(pending, export_begin(pending))
        for f in futures:
            f.result()
    return timings


def predict_cases_fast(model, list_of_lists, output_filenames, folds,
                       num_threads_preprocessing: int = 2,
                       num_threads_nifti_save: int = 2, do_tta: bool = True,
                       overwrite_existing: bool = False, step_size: float = 0.5,
                       checkpoint_name: str = "model_final_checkpoint",
                       device: str | torch.device = "cuda") -> list[dict]:
    """predict_cases_fast parity (predict.py:294-440): no probabilities are
    kept; the fold sum is resized and argmaxed to a labelmap on the device."""
    return predict_cases(model, list_of_lists, output_filenames, folds, save_npz=False,
                         num_threads_preprocessing=num_threads_preprocessing,
                         num_threads_nifti_save=num_threads_nifti_save, do_tta=do_tta,
                         overwrite_existing=overwrite_existing, step_size=step_size,
                         checkpoint_name=checkpoint_name, fast_mode="fast", device=device)


def predict_cases_fastest(model, list_of_lists, output_filenames, folds,
                          num_threads_preprocessing: int = 2,
                          num_threads_nifti_save: int = 2, do_tta: bool = True,
                          overwrite_existing: bool = False, step_size: float = 0.5,
                          checkpoint_name: str = "model_final_checkpoint",
                          device: str | torch.device = "cuda") -> list[dict]:
    """predict_cases_fastest parity (predict.py:442-565): argmax on the
    network's grid, then the single labelmap resized by nearest neighbour."""
    return predict_cases(model, list_of_lists, output_filenames, folds, save_npz=False,
                         num_threads_preprocessing=num_threads_preprocessing,
                         num_threads_nifti_save=num_threads_nifti_save, do_tta=do_tta,
                         overwrite_existing=overwrite_existing, step_size=step_size,
                         checkpoint_name=checkpoint_name, fast_mode="fastest", device=device)


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
        raise NotImplementedError(
            "lowres_segmentations: the JAX package's predict_from_folder accepts it and "
            "never reads it (multitalent_tpu/inference/predict.py:314), so it predicts no "
            "cascade stage from it; the port takes no previous-stage input either")
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


def ensemble_predictions(folders: list[str], output_folder: str,
                         regions_class_order=None, num_threads: int = 2) -> None:
    """Average the `<case>.npz` probabilities (written by predict with
    save_npz, on the post-cropping grid) of the cases every folder has, and
    export each mean with the properties `<case>.pkl` beside it
    (inference/ensemble_predictions.py:26-98; multitalent_tpu/inference/
    predict.py:356). Host work only."""
    maybe_mkdir(output_folder)
    patient_ids = [set(os.path.basename(p)[:-4] for p in subfiles(f, suffix=".npz"))
                   for f in folders]
    common = sorted(set.intersection(*patient_ids))
    if not common:
        raise ValueError(f"no case has a .npz in every folder of {folders}")

    def run(pid):
        probs, properties = None, None
        for f in folders:
            npz = np.load(os.path.join(f, pid + ".npz"))["softmax"].astype(np.float32)
            probs = npz if probs is None else probs + npz
            if properties is None:
                properties = load_pickle(os.path.join(f, pid + ".pkl"))
        probs /= len(folders)
        # the npz is on the post-cropping grid already: no resampling
        props = dict(properties)
        props["size_after_cropping"] = probs.shape[1:]
        save_segmentation_nifti_from_softmax(
            probs, os.path.join(output_folder, pid + ".nii.gz"), props, 1,
            regions_class_order)

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        for f in [pool.submit(run, pid) for pid in common]:
            f.result()
