"""Normalized surface Dice (surface Dice at tolerance tau).

Parity target: nnunet/evaluation/surface_dice.py — fraction of both surfaces
lying within `tolerance` mm of the other surface, computed from distance
transforms with physical voxel spacing.

The port's copy of multitalent_tpu/evaluation/surface_dice.py.
"""
from __future__ import annotations

import numpy as np

from multitalent_tpu_torch.evaluation.metrics import _surface_voxels
from scipy.ndimage import distance_transform_edt


def normalized_surface_dice(test: np.ndarray, reference: np.ndarray,
                            tolerance_mm: float, spacing=None) -> float:
    t = np.atleast_1d(test.astype(bool))
    r = np.atleast_1d(reference.astype(bool))
    if not t.any() and not r.any():
        return float("nan")
    if not t.any() or not r.any():
        return 0.0
    t_surf = _surface_voxels(t)
    r_surf = _surface_voxels(r)
    dt_r = distance_transform_edt(~r_surf, sampling=spacing)
    dt_t = distance_transform_edt(~t_surf, sampling=spacing)
    t_close = (dt_r[t_surf] <= tolerance_mm).sum()
    r_close = (dt_t[r_surf] <= tolerance_mm).sum()
    return float((t_close + r_close) / (t_surf.sum() + r_surf.sum()))
