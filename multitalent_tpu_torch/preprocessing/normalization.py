"""Intensity normalization schemes (parity: GenericPreprocessor.resample_and_normalize,
nnunet/preprocessing/preprocessing.py:273-310).

- "CT":    clip to the dataset-global foreground [0.5, 99.5] percentiles, z-score with
           the global foreground mean/sd (computed by the DatasetAnalyzer).
- "CT2":   clip as above, then per-case z-score over the in-range voxels.
- "noNorm": pass through.
- default ("nonCT"): per-case z-score, optionally restricted to the nonzero mask
           (seg >= 0 marks in-mask voxels since cropping stamped -1 outside).

The port's copy of multitalent_tpu/preprocessing/normalization.py.
"""
from __future__ import annotations

import numpy as np


def normalize_channel(data_c: np.ndarray, scheme: str, use_nonzero_mask: bool,
                      seg_last: np.ndarray | None,
                      intensity_props: dict | None) -> np.ndarray:
    if scheme == "CT":
        assert intensity_props is not None, "CT normalization needs dataset intensity properties"
        lb = intensity_props["percentile_00_5"]
        ub = intensity_props["percentile_99_5"]
        out = np.clip(data_c, lb, ub)
        out = (out - intensity_props["mean"]) / intensity_props["sd"]
        if use_nonzero_mask and seg_last is not None:
            out[seg_last < 0] = 0
        return out
    if scheme == "CT2":
        assert intensity_props is not None, "CT2 normalization needs dataset intensity properties"
        lb = intensity_props["percentile_00_5"]
        ub = intensity_props["percentile_99_5"]
        in_range = (data_c > lb) & (data_c < ub)
        out = np.clip(data_c, lb, ub)
        mn, sd = out[in_range].mean(), out[in_range].std()
        out = (out - mn) / sd
        if use_nonzero_mask and seg_last is not None:
            out[seg_last < 0] = 0
        return out
    if scheme == "noNorm":
        return data_c
    # default z-score
    out = data_c.copy()
    if use_nonzero_mask and seg_last is not None:
        mask = seg_last >= 0
        vals = out[mask]
        out[mask] = (vals - vals.mean()) / (vals.std() + 1e-8)
        out[~mask] = 0
    else:
        out = (out - out.mean()) / (out.std() + 1e-8)
    return out
