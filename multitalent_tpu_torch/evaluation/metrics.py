"""Segmentation metric zoo.

Parity target: nnunet/evaluation/metrics.py:25-385 — a ConfusionMatrix caching
tp/fp/tn/fn + emptiness flags, overlap metrics derived from it, and surface
metrics (Hausdorff, HD95, average surface distance) which the reference delegates
to medpy; here they are built on scipy distance transforms (the same algorithm
medpy uses: binary-erosion surface extraction + EDT lookups).

The port's copy of multitalent_tpu/evaluation/metrics.py.
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import binary_erosion, distance_transform_edt, generate_binary_structure


class ConfusionMatrix:
    def __init__(self, test=None, reference=None):
        self.tp = self.fp = self.tn = self.fn = None
        self.size = None
        self.test_empty = self.test_full = None
        self.reference_empty = self.reference_full = None
        self.test = None
        self.reference = None
        self.set_test(test)
        self.set_reference(reference)

    def set_test(self, test):
        self.test = test
        self.reset()

    def set_reference(self, reference):
        self.reference = reference
        self.reset()

    def reset(self):
        self.tp = self.fp = self.tn = self.fn = None
        self.size = None
        self.test_empty = self.test_full = None
        self.reference_empty = self.reference_full = None

    def compute(self):
        if self.test is None or self.reference is None:
            raise ValueError("'test' and 'reference' must both be set")
        assert self.test.shape == self.reference.shape, \
            f"shape mismatch {self.test.shape} vs {self.reference.shape}"
        t = self.test.astype(bool)
        r = self.reference.astype(bool)
        self.tp = int(np.sum(t & r))
        self.fp = int(np.sum(t & ~r))
        self.tn = int(np.sum(~t & ~r))
        self.fn = int(np.sum(~t & r))
        self.size = int(t.size)
        self.test_empty = not bool(t.any())
        self.test_full = bool(t.all())
        self.reference_empty = not bool(r.any())
        self.reference_full = bool(r.all())

    def get_matrix(self):
        if self.tp is None:
            self.compute()
        return self.tp, self.fp, self.tn, self.fn

    def get_size(self):
        if self.size is None:
            self.compute()
        return self.size

    def get_existence(self):
        if self.test_empty is None:
            self.compute()
        return self.test_empty, self.test_full, self.reference_empty, self.reference_full


def _cm(test, reference, confusion_matrix):
    if confusion_matrix is None:
        confusion_matrix = ConfusionMatrix(test, reference)
    return confusion_matrix


def dice(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    """2TP / (2TP + FP + FN)"""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, _, fn = cm.get_matrix()
    te, _, re, _ = cm.get_existence()
    if te and re:
        return float("nan") if nan_for_nonexisting else 0.0
    return 2.0 * tp / (2 * tp + fp + fn)


def jaccard(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    """TP / (TP + FP + FN)"""
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, _, fn = cm.get_matrix()
    te, _, re, _ = cm.get_existence()
    if te and re:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fp + fn)


def precision(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, _, _ = cm.get_matrix()
    te, _, _, _ = cm.get_existence()
    if te:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fp)


def sensitivity(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    """TP / (TP + FN) — a.k.a. recall."""
    cm = _cm(test, reference, confusion_matrix)
    tp, _, _, fn = cm.get_matrix()
    _, _, re, _ = cm.get_existence()
    if re:
        return float("nan") if nan_for_nonexisting else 0.0
    return tp / (tp + fn)


def recall(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    return sensitivity(test, reference, confusion_matrix, nan_for_nonexisting, **kwargs)


def specificity(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True, **kwargs):
    """TN / (TN + FP)"""
    cm = _cm(test, reference, confusion_matrix)
    _, fp, tn, _ = cm.get_matrix()
    _, _, _, rf = cm.get_existence()
    if rf:
        return float("nan") if nan_for_nonexisting else 0.0
    return tn / (tn + fp)


def accuracy(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, tn, fn = cm.get_matrix()
    return (tp + tn) / cm.get_size()


def fscore(test=None, reference=None, confusion_matrix=None, nan_for_nonexisting=True,
           beta=1.0, **kwargs):
    prec = precision(test, reference, confusion_matrix, nan_for_nonexisting)
    rec = recall(test, reference, confusion_matrix, nan_for_nonexisting)
    denom = beta * beta * prec + rec
    if denom == 0 or np.isnan(denom):
        return 0.0
    return (1 + beta * beta) * prec * rec / denom


def false_positive_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    s = specificity(test, reference, confusion_matrix, nan_for_nonexisting)
    return 1 - s


def false_omission_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, _, tn, fn = cm.get_matrix()
    _, tf, _, _ = cm.get_existence()
    if tf:
        return float("nan") if nan_for_nonexisting else 0.0
    return fn / (fn + tn)


def false_negative_rate(test=None, reference=None, confusion_matrix=None,
                        nan_for_nonexisting=True, **kwargs):
    return 1 - sensitivity(test, reference, confusion_matrix, nan_for_nonexisting)


def true_negative_rate(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, **kwargs):
    return specificity(test, reference, confusion_matrix, nan_for_nonexisting)


def false_discovery_rate(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, **kwargs):
    return 1 - precision(test, reference, confusion_matrix, nan_for_nonexisting)


def negative_predictive_value(test=None, reference=None, confusion_matrix=None,
                              nan_for_nonexisting=True, **kwargs):
    return 1 - false_omission_rate(test, reference, confusion_matrix, nan_for_nonexisting)


def total_positives_test(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, fp, _, _ = cm.get_matrix()
    return tp + fp


def total_negatives_test(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    _, _, tn, fn = cm.get_matrix()
    return tn + fn


def total_positives_reference(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    tp, _, _, fn = cm.get_matrix()
    return tp + fn


def total_negatives_reference(test=None, reference=None, confusion_matrix=None, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    _, fp, tn, _ = cm.get_matrix()
    return tn + fp


# ------------------------------------------------------------- surface metrics

def _surface_voxels(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    struct = generate_binary_structure(mask.ndim, connectivity)
    eroded = binary_erosion(mask, structure=struct, border_value=0)
    return mask & ~eroded


def _surface_distances(test: np.ndarray, reference: np.ndarray, voxel_spacing=None,
                       connectivity: int = 1) -> np.ndarray:
    """Distances from every test-surface voxel to the nearest reference-surface
    voxel (medpy __surface_distances algorithm)."""
    t = np.atleast_1d(test.astype(bool))
    r = np.atleast_1d(reference.astype(bool))
    if not t.any() or not r.any():
        raise RuntimeError("surface distance undefined for empty masks")
    t_surf = _surface_voxels(t, connectivity)
    r_surf = _surface_voxels(r, connectivity)
    dt = distance_transform_edt(~r_surf, sampling=voxel_spacing)
    return dt[t_surf]


def hausdorff_distance(test=None, reference=None, confusion_matrix=None,
                       nan_for_nonexisting=True, voxel_spacing=None,
                       connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    te, _, re, _ = cm.get_existence()
    if te or re:
        return float("nan") if nan_for_nonexisting else 0.0
    hd1 = _surface_distances(cm.test, cm.reference, voxel_spacing, connectivity).max()
    hd2 = _surface_distances(cm.reference, cm.test, voxel_spacing, connectivity).max()
    return float(max(hd1, hd2))


def hausdorff_distance_95(test=None, reference=None, confusion_matrix=None,
                          nan_for_nonexisting=True, voxel_spacing=None,
                          connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    te, _, re, _ = cm.get_existence()
    if te or re:
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(cm.test, cm.reference, voxel_spacing, connectivity)
    d2 = _surface_distances(cm.reference, cm.test, voxel_spacing, connectivity)
    return float(max(np.percentile(d1, 95), np.percentile(d2, 95)))


def avg_surface_distance(test=None, reference=None, confusion_matrix=None,
                         nan_for_nonexisting=True, voxel_spacing=None,
                         connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    te, _, re, _ = cm.get_existence()
    if te or re:
        return float("nan") if nan_for_nonexisting else 0.0
    return float(_surface_distances(cm.test, cm.reference, voxel_spacing,
                                    connectivity).mean())


def avg_surface_distance_symmetric(test=None, reference=None, confusion_matrix=None,
                                   nan_for_nonexisting=True, voxel_spacing=None,
                                   connectivity=1, **kwargs):
    cm = _cm(test, reference, confusion_matrix)
    te, _, re, _ = cm.get_existence()
    if te or re:
        return float("nan") if nan_for_nonexisting else 0.0
    d1 = _surface_distances(cm.test, cm.reference, voxel_spacing, connectivity)
    d2 = _surface_distances(cm.reference, cm.test, voxel_spacing, connectivity)
    return float((d1.sum() + d2.sum()) / (len(d1) + len(d2)))


ALL_METRICS = {
    "False Positive Rate": false_positive_rate,
    "Dice": dice,
    "Jaccard": jaccard,
    "Hausdorff Distance": hausdorff_distance,
    "Hausdorff Distance 95": hausdorff_distance_95,
    "Precision": precision,
    "Recall": recall,
    "Avg. Symmetric Surface Distance": avg_surface_distance_symmetric,
    "Avg. Surface Distance": avg_surface_distance,
    "Accuracy": accuracy,
    "False Omission Rate": false_omission_rate,
    "Negative Predictive Value": negative_predictive_value,
    "False Negative Rate": false_negative_rate,
    "True Negative Rate": true_negative_rate,
    "False Discovery Rate": false_discovery_rate,
    "Total Positives Test": total_positives_test,
    "Total Negatives Test": total_negatives_test,
    "Total Positives Reference": total_positives_reference,
    "Total Negatives Reference": total_negatives_reference,
}
