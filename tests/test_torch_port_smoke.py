"""chip_smoke.py's bookkeeping on the CPU: the recorders that count a kernel
wrapper's calls by shape on the main path, and the sums that weight phase
2's times by those counts (kernel B over a forward and over a step)."""
from __future__ import annotations

import collections

import numpy as np
import pytest
import torch

import chip_smoke
from multitalent_tpu_torch.ops import conv3d as cv


def _dual_inputs(rng, n, spatial, c):
    a, b = (torch.from_numpy(rng.standard_normal((n, *spatial, c), dtype=np.float32))
            .to(torch.bfloat16) for _ in range(2))
    w = torch.from_numpy(rng.standard_normal((c, 2 * c, 3, 3, 3), dtype=np.float32)) * 0.1
    return a, b, cv.prepare_conv3d_weight(w, (c, c))


def test_recording_counts_each_wrapper_call_by_shape():
    """_recording swaps the wrapper for a recorder only inside the block,
    counts (input channels, Cout, spatial, N) of every call, and the
    recorder returns what the wrapper does."""
    rng = np.random.default_rng(0)
    one = _dual_inputs(rng, 1, (2, 4, 4), 4)
    two = _dual_inputs(rng, 2, (2, 2, 4), 2)
    kernel = cv.conv3d_same_dual
    with chip_smoke._recording("conv3d_same_dual") as shapes:
        assert cv.conv3d_same_dual is not kernel
        got = cv.conv3d_same_dual(*one)
        for _ in range(3):
            cv.conv3d_same_dual(*two)
    assert cv.conv3d_same_dual is kernel
    assert torch.equal(got, kernel(*one))
    assert shapes == collections.Counter({((4, 4), 4, (2, 4, 4), 1): 1,
                                          ((2, 2), 2, (2, 2, 4), 2): 3})


def test_sums_weight_phase_two_times_by_recorded_launches():
    """_sums: each shape's time and its reference's weighted by the launches
    each recorded run counted, per run; a recorded shape phase 2 did not
    time is refused."""
    def row(c, n, ms, ref_ms):
        return {"splits": (c, c), "cout": c, "spatial": (2, 4, 4), "n": n, "ms": ms,
                "cudnn_bf16_ms": ref_ms, "bound_ms": 0.01, "bound_by": "operations",
                "plan": {"ring": 1}}
    timed = [row(30, 1, 2.0, 3.0), row(60, 1, 1.0, 0.5), row(30, 2, 4.0, 6.0)]
    forward = collections.Counter({((30, 30), 30, (2, 4, 4), 1): 1,
                                   ((60, 60), 60, (2, 4, 4), 1): 2})
    step = collections.Counter({((30, 30), 30, (2, 4, 4), 2): 3})
    out = chip_smoke._sums("kernel B", timed, "cudnn_bf16_ms", forward=forward, step=step)
    assert out["forward_ms"] == pytest.approx(4.0)
    assert out["forward_cudnn_bf16_ms"] == pytest.approx(4.0)
    assert out["step_ms"] == pytest.approx(12.0)
    assert out["step_cudnn_bf16_ms"] == pytest.approx(18.0)
    assert [s["launches_per_step"] for s in out["shapes"]] == [0, 0, 3]
    with pytest.raises(AssertionError, match="not timed"):
        chip_smoke._sums("kernel B", timed[:2], "cudnn_bf16_ms", step=step)
