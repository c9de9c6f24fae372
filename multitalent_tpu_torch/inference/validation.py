"""Cross-validation inference ("validate") for the port's trainers.

Counterpart of multitalent_tpu/inference/validation.py: sliding-window
prediction of every validation case, NIfTI export on host threads,
`aggregate_scores` against `<dataset>/gt_segmentations` and
`determine_postprocessing` (nnUNetTrainer.validate, nnUNetTrainer.py:526-681),
the cascade's (the previous stage's one-hots appended to each case), and
the MultiTalent variant (MultiTalent_Trainer_DDP.validate:129-322), which
writes all 47 region masks of every case and one labelmap per case of its
source dataset's regions, evaluated per dataset over its labels.

The region probabilities stay on the device: the predict path's export
(inference/predict.py) resizes and thresholds them there where
`can_export_on_device` holds, and fetches them for the host chain where the
case needs the separate-z resampling. Softmax models take the host chain.
The network is whatever `trainer.predict_preprocessed_probabilities` runs:
the hand-written kernels on a CUDA device (the fused conv -> norm route under
MTTPU_FUSED_NORM=1), their plain versions on the CPU; the sliding window
runs in its default (non-exact) mode unless MTTPU_SW_EXACT=1, as the JAX
package validates.

Over several ranks each rank predicts and exports
`sorted(dataset_val)[rank::world_size]` (nnUNetTrainerV2_DDP.py:495); after
a barrier rank 0 alone evaluates, writes the summaries and determines the
postprocessing, so the folder holds what one process writes.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from multitalent_tpu_torch.data.dataset import load_case
from multitalent_tpu_torch.evaluation.evaluator import aggregate_scores
from multitalent_tpu_torch.inference.predict import _export_on_device, _export_on_host
from multitalent_tpu_torch.inference.segmentation_export import (
    save_segmentation_nifti_from_softmax)
from multitalent_tpu_torch.ops.device_export import can_export_on_device
from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.postprocessing.connected_components import determine_postprocessing
from multitalent_tpu_torch.tasks.multitalent import (REGION_OUTPUT_IDX, REGIONS,
                                                     REGIONS_CLASS_ORDER, TASK_IDS,
                                                     VALID_REGIONS)
from multitalent_tpu_torch.training.cascade import one_hot_prev_stage_channels, prev_stage_file
from multitalent_tpu_torch.utils.fileops import load_pickle, maybe_mkdir, save_json, subfiles


def _validation_cases(trainer, with_prev_stage: bool = False):
    """(case id, data (C, Z, Y, X), properties) of every validation case of
    this rank, in order; `with_prev_stage` appends the one-hots of the
    previous stage's labels (`<case>_segFromPrevStage.npz`, the cascade).
    A trainer initialised without its generators (-val) splits its dataset
    here, as the reference's validate does."""
    if getattr(trainer, "dataset_val", None) is None:
        trainer.load_dataset()
        trainer.do_split()
    for k in sorted(trainer.dataset_val)[distributed.rank()::distributed.world_size()]:
        data = np.array(load_case(trainer.dataset_val[k], "r"))[:-1]
        if with_prev_stage:
            prev = np.load(prev_stage_file(trainer.folder_with_preprocessed_data, k))["data"]
            data = np.concatenate([data, one_hot_prev_stage_channels(
                prev[0], trainer.num_prev_classes)])
        yield k, data, load_pickle(trainer.dataset_val[k]["properties_file"])


def _predict(trainer, data, timings: list, case: str, **kwargs):
    """The case's probabilities on the device; its seconds, forwards and
    network calls are appended to `timings` (trainer.validation_timings; with
    trainer.validation_seconds, the prediction and export of every case, they
    are what the card's runs read)."""
    t0 = time.perf_counter()
    probs, forwards, net_calls = trainer.predict_preprocessed_probabilities(data, **kwargs)
    timings.append({"case": case, "predict_s": time.perf_counter() - t0,
                    "forwards": forwards, "net_calls": net_calls})
    return probs


def run_validation(trainer, do_mirroring: bool = True, use_sliding_window: bool = True,
                   step_size: float = 0.5, save_softmax: bool = True,
                   use_gaussian: bool = True, overwrite: bool = True,
                   validation_folder_name: str = "validation_raw",
                   debug: bool = False, all_in_gpu: bool = False,
                   segmentation_export_kwargs: dict | None = None,
                   run_postprocessing_on_folds: bool = True, with_prev_stage: bool = False):
    """Validate a softmax trainer (TrainerV2): labelmaps, `--npz`
    probabilities, summary.json, postprocessing.json; `with_prev_stage`
    feeds the cascade's input (run_cascade_validation)."""
    assert trainer.was_initialized, "must initialize trainer before validate()"
    output_folder = maybe_mkdir(os.path.join(trainer.output_folder,
                                             validation_folder_name))
    if distributed.is_main():
        save_json({
            "do_mirroring": do_mirroring, "use_sliding_window": use_sliding_window,
            "step_size": step_size, "save_softmax": save_softmax,
            "use_gaussian": use_gaussian, "overwrite": overwrite,
            "validation_folder_name": validation_folder_name,
        }, os.path.join(output_folder, "validation_args.json"))
    ek = segmentation_export_kwargs or {}
    order = int(ek.get("interpolation_order", 1))
    force_sep_z = ek.get("force_separate_z", None)
    order_z = int(ek.get("interpolation_order_z", 0))

    trainer.validation_timings = []
    t_start = time.perf_counter()
    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        for k, data, properties in _validation_cases(trainer, with_prev_stage):
            fname = os.path.join(output_folder, k + ".nii.gz")
            if not overwrite and os.path.isfile(fname):
                continue
            probs = _predict(trainer, data, trainer.validation_timings, k,
                             do_mirroring=do_mirroring, step_size=step_size,
                             use_gaussian=use_gaussian)
            npz_fname = fname[:-7] + ".npz" if save_softmax else None
            futures.append(pool.submit(
                save_segmentation_nifti_from_softmax, probs.float().cpu().numpy(), fname,
                properties, order, trainer.regions_class_order, None, None,
                npz_fname, None, force_sep_z, order_z))
        for f in futures:
            f.result()
    trainer.validation_seconds = time.perf_counter() - t_start
    distributed.barrier()  # every rank's cases are written

    gt_folder = os.path.join(trainer.dataset_directory, "gt_segmentations")
    summary = None
    if distributed.is_main() and os.path.isdir(gt_folder):
        pred_files = subfiles(output_folder, suffix=".nii.gz", join=False)
        pairs = [(os.path.join(output_folder, f), os.path.join(gt_folder, f))
                 for f in pred_files if os.path.isfile(os.path.join(gt_folder, f))]
        if pairs:
            summary = aggregate_scores(
                pairs, labels=list(trainer.classes),
                json_output_file=os.path.join(output_folder, "summary.json"),
                json_name="validation", num_threads=4)
        if run_postprocessing_on_folds and pairs:
            determine_postprocessing(
                trainer.output_folder, gt_folder, validation_folder_name,
                final_subf_name=validation_folder_name + "_postprocessed", debug=debug)
    return summary


def _task_of(case_id: str) -> str:
    prefix = case_id.split("_")[0]
    return next(t for t in TASK_IDS if t.startswith(f"Task{prefix}"))


def run_multitalent_validation(trainer, do_mirroring: bool = True,
                               use_sliding_window: bool = True,
                               step_size: float = 0.5, save_softmax: bool = False,
                               use_gaussian: bool = True, overwrite: bool = True,
                               validation_folder_name: str = "validation_raw",
                               debug: bool = False, all_in_gpu: bool = False,
                               segmentation_export_kwargs: dict | None = None,
                               run_postprocessing_on_folds: bool = False):
    """Region-wise validation: `individual/<region>/<case>.nii.gz` for all 47
    regions, `<case>.nii.gz` of the case's dataset's valid regions stamped in
    that dataset's REGIONS_CLASS_ORDER, and `summary_<task>.json` per source
    dataset over its labels. `save_softmax` is ignored, as the JAX
    package's (no npz of 47 regions)."""
    assert trainer.was_initialized
    output_folder = maybe_mkdir(os.path.join(trainer.output_folder,
                                             validation_folder_name))
    trainer.validation_timings = []
    t_start = time.perf_counter()
    futures = []
    with ThreadPoolExecutor(max_workers=2) as pool:
        for k, data, properties in _validation_cases(trainer):
            merged_fname = os.path.join(output_folder, k + ".nii.gz")
            if not overwrite and os.path.isfile(merged_fname):
                continue
            probs = _predict(trainer, data, trainer.validation_timings, k,
                             do_mirroring=do_mirroring, step_size=step_size,
                             use_gaussian=use_gaussian)
            task = _task_of(k)
            channels = [REGION_OUTPUT_IDX[r] for r in VALID_REGIONS[task]]
            class_order = tuple(REGIONS_CLASS_ORDER[task])
            if can_export_on_device(properties):
                futures += _export_on_device(pool, probs, 1, properties, merged_fname, k,
                                             class_order, True, channels=channels)
            else:
                futures += _export_on_host(pool, probs.float().cpu().numpy(), properties,
                                           merged_fname, k, class_order, True, False,
                                           channels=channels)
            del probs
        for f in futures:
            f.result()
    trainer.validation_seconds = time.perf_counter() - t_start
    distributed.barrier()  # every rank's cases are written

    gt_folder = os.path.join(trainer.dataset_directory, "gt_segmentations")
    results = {}
    if distributed.is_main() and os.path.isdir(gt_folder):
        by_task: dict[str, list[str]] = {}
        for k in sorted(trainer.dataset_val):
            by_task.setdefault(_task_of(k), []).append(k)
        for task, task_keys in by_task.items():
            pairs = [(os.path.join(output_folder, k + ".nii.gz"),
                      os.path.join(gt_folder, k + ".nii.gz")) for k in task_keys
                     if os.path.isfile(os.path.join(gt_folder, k + ".nii.gz"))]
            if not pairs:
                continue
            labels = sorted({l for r in VALID_REGIONS[task] for l in REGIONS[r]})
            results[task] = aggregate_scores(
                pairs, labels=labels,
                json_output_file=os.path.join(output_folder, f"summary_{task}.json"),
                json_name=f"validation_{task}", num_threads=4)
    return results


def run_cascade_validation(trainer, *args, **kwargs):
    """Cascade validate (nnUNetTrainerV2_CascadeFullRes.validate parity, the
    JAX package's validation.py:183-246): each case's previous-stage
    segmentation as one-hot channels appended to its modalities before the
    sliding window; the rest as run_validation."""
    return run_validation(trainer, *args, with_prev_stage=True, **kwargs)
