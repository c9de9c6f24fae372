"""Per-case and aggregate evaluation.

Parity target: nnunet/evaluation/evaluator.py:25-446 — `Evaluator` computing a
metric dict per label from test/reference label maps, `NiftiEvaluator` reading
NIfTI pairs (spacing-aware surface metrics), and `aggregate_scores` running all
case pairs (process pool) and writing summary.json with per-case results plus
per-label means. Default metric set matches the reference's default_metrics list
(evaluator.py:93-103).

The port's copy of multitalent_tpu/evaluation/evaluator.py.
"""
from __future__ import annotations

import hashlib
import inspect
import os
from datetime import datetime

import numpy as np

from multitalent_tpu_torch.evaluation.metrics import ALL_METRICS, ConfusionMatrix
from multitalent_tpu_torch.io.nifti import read_nifti
from multitalent_tpu_torch.utils.fileops import process_pool
from multitalent_tpu_torch.utils.fileops import save_json

DEFAULT_METRICS = [
    "False Positive Rate", "Dice", "Jaccard", "Precision", "Recall", "Accuracy",
    "False Omission Rate", "Negative Predictive Value", "False Negative Rate",
    "True Negative Rate", "False Discovery Rate", "Total Positives Test",
    "Total Positives Reference",
]

ADVANCED_METRICS = ["Hausdorff Distance", "Hausdorff Distance 95",
                    "Avg. Surface Distance", "Avg. Symmetric Surface Distance"]


class Evaluator:
    """Evaluates one test/reference label-map pair over a set of labels."""

    def __init__(self, test=None, reference=None, labels=None, metrics=None,
                 advanced_metrics=None, nan_for_nonexisting=True):
        self.test = None
        self.reference = None
        self.confusion_matrix = ConfusionMatrix()
        self.labels = None
        self.nan_for_nonexisting = nan_for_nonexisting
        self.result = None
        self.metrics = list(metrics) if metrics is not None else list(DEFAULT_METRICS)
        self.advanced_metrics = list(advanced_metrics) if advanced_metrics is not None else []
        if test is not None:
            self.set_test(test)
        if reference is not None:
            self.set_reference(reference)
        if labels is not None:
            self.set_labels(labels)

    def set_test(self, test):
        self.test = test

    def set_reference(self, reference):
        self.reference = reference

    def set_labels(self, labels):
        if isinstance(labels, dict):
            self.labels = {int(k) if str(k).lstrip("-").isdigit() else k: v
                           for k, v in labels.items()}
        else:
            self.labels = [l for l in labels]

    def construct_labels(self):
        if self.test is None and self.reference is None:
            raise ValueError("No test or reference segmentations.")
        if self.test is None:
            labels = np.unique(self.reference)
        elif self.reference is None:
            labels = np.unique(self.test)
        else:
            labels = np.union1d(np.unique(self.test), np.unique(self.reference))
        self.labels = [int(l) for l in labels if l != 0]

    def evaluate(self, test=None, reference=None, voxel_spacing=None, **metric_kwargs):
        if test is not None:
            self.set_test(test)
        if reference is not None:
            self.set_reference(reference)
        if self.test is None or self.reference is None:
            raise ValueError("'test' and 'reference' must both be set")
        if self.labels is None:
            self.construct_labels()

        self.result = {}
        eval_metrics = self.metrics + self.advanced_metrics
        labels = (self.labels.items() if isinstance(self.labels, dict)
                  else [(l, l) for l in self.labels])
        for label, name in labels:
            k = str(name)
            self.result[k] = {}
            if isinstance(label, (list, tuple)):
                t = np.isin(self.test, label)
                r = np.isin(self.reference, label)
            else:
                t = self.test == label
                r = self.reference == label
            self.confusion_matrix.set_test(t)
            self.confusion_matrix.set_reference(r)
            for metric in eval_metrics:
                fn = ALL_METRICS[metric]
                kwargs = dict(metric_kwargs)
                if "voxel_spacing" in inspect.signature(fn).parameters:
                    kwargs["voxel_spacing"] = voxel_spacing
                self.result[k][metric] = fn(
                    confusion_matrix=self.confusion_matrix,
                    nan_for_nonexisting=self.nan_for_nonexisting, **kwargs)
        return self.result

    def to_dict(self):
        if self.result is None:
            self.evaluate()
        return self.result


class NiftiEvaluator(Evaluator):
    def __init__(self, *args, **kwargs):
        self.test_nifti = None
        self.reference_nifti = None
        self.voxel_spacing = None
        super().__init__(*args, **kwargs)

    def set_test(self, test):
        if isinstance(test, str):
            arr, geom = read_nifti(test)
            self.test_nifti = test
            self.voxel_spacing = tuple(geom.spacing[::-1])  # (z, y, x)
            super().set_test(arr)
        else:
            super().set_test(test)

    def set_reference(self, reference):
        if isinstance(reference, str):
            arr, _ = read_nifti(reference)
            self.reference_nifti = reference
            super().set_reference(arr)
        else:
            super().set_reference(reference)

    def evaluate(self, test=None, reference=None, voxel_spacing=None, **metric_kwargs):
        if voxel_spacing is None:
            voxel_spacing = self.voxel_spacing
        return super().evaluate(test, reference, voxel_spacing, **metric_kwargs)


def run_evaluation(args):
    test, ref, evaluator, metric_kwargs = args
    evaluator.set_test(test)
    evaluator.set_reference(ref)
    if evaluator.labels is None:
        evaluator.construct_labels()
    current_scores = evaluator.evaluate(**metric_kwargs)
    if isinstance(test, str):
        current_scores["test"] = test
    if isinstance(ref, str):
        current_scores["reference"] = ref
    return current_scores


def aggregate_scores(test_ref_pairs, evaluator=NiftiEvaluator, labels=None,
                     nanmean=True, json_output_file=None, json_name="",
                     json_description="", json_author="anonymous", json_task="",
                     num_threads=2, advanced=False, **metric_kwargs):
    """Evaluate all (test, reference) pairs and aggregate
    (evaluator.py:321-401): 'all' holds per-case dicts, 'mean' per-label means."""
    if type(evaluator) == type:
        evaluator = evaluator()
    if labels is not None:
        evaluator.set_labels(labels)
    if advanced:
        evaluator.advanced_metrics = list(ADVANCED_METRICS)

    all_scores = {"all": [], "mean": {}}
    # Each job gets its OWN evaluator: run_evaluation mutates it
    # (set_test/set_reference/confusion_matrix), and process_pool degrades to a
    # thread pool once CUDA is initialised — a shared instance then races and
    # can score a case against another case's arrays (observed: gt-vs-gt
    # perfect scores flipping a CV mean nondeterministically). The reference's
    # process Pool got per-worker copies for free by pickling.
    import copy
    jobs = [(t, r, copy.deepcopy(evaluator), metric_kwargs)
            for t, r in test_ref_pairs]
    if num_threads <= 1 or len(jobs) <= 1:
        all_res = [run_evaluation(j) for j in jobs]
    else:
        with process_pool(num_threads) as pool:
            all_res = list(pool.map(run_evaluation, jobs))

    for i, case_result in enumerate(all_res):
        all_scores["all"].append(case_result)
        for label, score_dict in case_result.items():
            if label in ("test", "reference"):
                continue
            all_scores["mean"].setdefault(label, {})
            for score, value in score_dict.items():
                all_scores["mean"][label].setdefault(score, []).append(value)

    for label in all_scores["mean"]:
        for score in all_scores["mean"][label]:
            vals = np.array(all_scores["mean"][label][score], dtype=np.float64)
            agg = np.nanmean(vals) if nanmean else np.mean(vals)
            all_scores["mean"][label][score] = float(agg)

    if json_output_file is not None:
        json_dict = {
            "name": json_name,
            "description": json_description,
            "timestamp": str(datetime.today()),
            "task": json_task,
            "author": json_author,
            "results": all_scores,
            "id": hashlib.md5(
                (json_name + str(datetime.today())).encode()).hexdigest()[:12],
        }
        save_json(json_dict, json_output_file)
    return all_scores


def evaluate_folder(folder_with_gts: str, folder_with_predictions: str, labels,
                    **metric_kwargs):
    """nnUNet_evaluate_folder parity (evaluator.py:446): match filenames, aggregate,
    write summary.json into the prediction folder."""
    from multitalent_tpu_torch.utils.fileops import subfiles
    files_gt = subfiles(folder_with_gts, suffix=".nii.gz", join=False)
    files_pred = subfiles(folder_with_predictions, suffix=".nii.gz", join=False)
    assert all(f in files_gt for f in files_pred), \
        "files missing in folder_with_gts"
    assert all(f in files_pred for f in files_gt), \
        "files missing in folder_with_predictions"
    test_ref_pairs = [(os.path.join(folder_with_predictions, f),
                       os.path.join(folder_with_gts, f)) for f in files_pred]
    return aggregate_scores(
        test_ref_pairs,
        json_output_file=os.path.join(folder_with_predictions, "summary.json"),
        num_threads=4, labels=labels, **metric_kwargs)
