"""The port's copies of the evaluation and postprocessing modules
(multitalent_tpu_torch/evaluation/{metrics, evaluator,
region_based_evaluation}.py, postprocessing/connected_components.py) against
the JAX package's originals, on the same synthetic NIfTIs: equal per-label
metrics (timestamps and ids aside), equal postprocessing.json and written
files, equal region scores. Then the thread branch of the port's
`process_pool`, which validation takes once CUDA is initialised, must
evaluate the cases at once and not one after another.
"""
import json
import threading
import time

import numpy as np
import pytest

from multitalent_tpu.evaluation import evaluator as jeval
from multitalent_tpu.evaluation import region_based_evaluation as jregion
from multitalent_tpu.postprocessing import connected_components as jcc
from multitalent_tpu_torch.evaluation import evaluator as peval
from multitalent_tpu_torch.evaluation import region_based_evaluation as pregion
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.postprocessing import connected_components as pcc
from multitalent_tpu_torch.utils import fileops

SHAPE = (12, 20, 18)
SPACING_XYZ = (0.8, 0.9, 2.0)


def _blobs(rng, labels) -> np.ndarray:
    """A labelmap of a few ellipsoids per label, some split in pieces, so
    that connected-component removal has something to remove."""
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in SHAPE], indexing="ij")
    seg = np.zeros(SHAPE, np.uint8)
    for label in labels:
        for _ in range(rng.integers(1, 4)):
            c = rng.uniform(-0.6, 0.6, 3)
            r = rng.uniform(0.1, 0.35, 3)
            seg[sum(((a - ci) / ri) ** 2 for a, ci, ri in zip((z, y, x), c, r)) < 1] = label
    return seg


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """gt/ and pred/ with five cases of labels 1..3 (pred: gt with voxels
    flipped, and stray blobs)."""
    root = tmp_path_factory.mktemp("evaluation")
    rng = np.random.default_rng(3)
    for name in ("gt", "pred"):
        (root / name).mkdir()
    for i in range(5):
        gt = _blobs(rng, (1, 2, 3))
        pred = gt.copy()
        flip = rng.random(SHAPE) < 0.05
        pred[flip] = rng.integers(0, 4, int(flip.sum()))
        pred = np.where(_blobs(rng, (2,)) > 0, 2, pred).astype(np.uint8)
        for name, arr in (("gt", gt), ("pred", pred)):
            write_nifti(root / name / f"case_{i}.nii.gz", arr, Geometry(spacing=SPACING_XYZ))
    return root


def _pairs(root):
    return [(str(root / "pred" / f"case_{i}.nii.gz"), str(root / "gt" / f"case_{i}.nii.gz"))
            for i in range(5)]


def _without_stamps(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in ("timestamp", "id")}


@pytest.mark.parametrize("advanced", [False, True])
def test_aggregate_scores_matches_the_original(folders, tmp_path, advanced):
    kw = dict(labels=[1, 2, 3], json_name="v", num_threads=2, advanced=advanced)
    a = jeval.aggregate_scores(_pairs(folders), json_output_file=str(tmp_path / "a.json"), **kw)
    b = peval.aggregate_scores(_pairs(folders), json_output_file=str(tmp_path / "b.json"), **kw)
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    ja = json.loads((tmp_path / "a.json").read_text())
    jb = json.loads((tmp_path / "b.json").read_text())
    assert _without_stamps(ja) == _without_stamps(jb)
    assert 0 < ja["results"]["mean"]["2"]["Dice"] < 1


def test_determine_postprocessing_matches_the_original(folders, tmp_path):
    for name, cc in (("jax", jcc), ("port", pcc)):
        base = tmp_path / name
        base.mkdir()
        (base / "validation_raw").symlink_to(folders / "pred")
        cc.determine_postprocessing(str(base), str(folders / "gt"), "validation_raw",
                                    final_subf_name="validation_final", processes=2)
    a = json.loads((tmp_path / "jax" / "postprocessing.json").read_text())
    b = json.loads((tmp_path / "port" / "postprocessing.json").read_text())
    assert a == b and a["for_which_classes"], a
    for i in range(5):
        got, _ = read_nifti(tmp_path / "port" / "validation_final" / f"case_{i}.nii.gz")
        ref, _ = read_nifti(tmp_path / "jax" / "validation_final" / f"case_{i}.nii.gz")
        assert np.array_equal(got, ref)
    assert pcc.load_postprocessing(str(tmp_path / "port" / "postprocessing.json")) == \
        jcc.load_postprocessing(str(tmp_path / "jax" / "postprocessing.json"))


def test_region_based_evaluation_matches_the_original(folders, tmp_path):
    regions = {"all": (1, 2, 3), "core": (2, 3), "three": (3,)}
    for name, mod in (("jax", jregion), ("port", pregion)):
        (tmp_path / name).mkdir()
        for f in (folders / "pred").iterdir():
            (tmp_path / name / f.name).symlink_to(f)
    a = jregion.evaluate_regions(str(tmp_path / "jax"), str(folders / "gt"), regions)
    b = pregion.evaluate_regions(str(tmp_path / "port"), str(folders / "gt"), regions)
    assert a == b
    assert (tmp_path / "jax" / "summary.csv").read_text() == \
        (tmp_path / "port" / "summary.csv").read_text()


def test_multitalent_region_evaluation_matches_the_original(folders, tmp_path):
    """individual/<region>/ masks of regions whose labels are 1..3 in the
    global label space (03_liver = {1, 2}, 03_cancer = {2}, 06_lungnodule =
    {3})."""
    for region, labels in (("03_liver", (1, 2)), ("03_cancer", (2,)), ("06_lungnodule", (3,))):
        (tmp_path / region).mkdir()
        for i in range(5):
            pred, g = read_nifti(folders / "pred" / f"case_{i}.nii.gz")
            write_nifti(tmp_path / region / f"case_{i}.nii.gz",
                        np.isin(pred, labels).astype(np.uint8), g)
    a = jregion.evaluate_multitalent_regions(str(tmp_path), str(folders / "gt"))
    b = pregion.evaluate_multitalent_regions(str(tmp_path), str(folders / "gt"))
    assert a == b and set(a) == {"03_liver", "03_cancer", "06_lungnodule"}


def test_remove_all_but_the_largest_component_matches_the_original():
    rng = np.random.default_rng(7)
    seg = _blobs(rng, (1, 2, 3)).astype(np.int32)
    for classes in ([1, 2, 3], [(1, 2, 3)], [(1, 2), 3]):
        a = jcc.remove_all_but_the_largest_connected_component(seg.copy(), classes, 1.44)
        b = pcc.remove_all_but_the_largest_connected_component(seg.copy(), classes, 1.44)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:], classes


def test_remove_below_minimum_size_matches_the_original():
    """A speckled mask (many small objects) with a minimum valid object size:
    the port removes the objects in one pass, the original one at a time."""
    rng = np.random.default_rng(8)
    seg = _blobs(rng, (1, 2)).astype(np.int32)
    seg[rng.random(seg.shape) < 0.02] = 2
    for minimum in ({1: 5.0, 2: 3.0}, {1: 0.0, 2: 1e9}):
        a = jcc.remove_all_but_the_largest_connected_component(seg.copy(), [1, 2], 1.44,
                                                               minimum)
        b = pcc.remove_all_but_the_largest_connected_component(seg.copy(), [1, 2], 1.44,
                                                               minimum)
        assert np.array_equal(a[0], b[0]) and a[1:] == b[1:], minimum


def test_thread_pool_evaluates_cases_at_once(folders, monkeypatch):
    """With CUDA initialised, process_pool gives threads; aggregate_scores
    must hand them every case together (at least two evaluations in flight
    at one time), and give the same scores as one thread."""
    import torch
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    assert type(fileops.process_pool(2)).__name__ == "ThreadPoolExecutor"
    inner, state, lock = peval.run_evaluation, {"now": 0, "most": 0}, threading.Lock()

    def counted(args):
        with lock:
            state["now"] += 1
            state["most"] = max(state["most"], state["now"])
        time.sleep(0.05)
        try:
            return inner(args)
        finally:
            with lock:
                state["now"] -= 1

    monkeypatch.setattr(peval, "run_evaluation", counted)
    threaded = peval.aggregate_scores(_pairs(folders), labels=[1, 2, 3], num_threads=4)
    serial = peval.aggregate_scores(_pairs(folders), labels=[1, 2, 3], num_threads=1)
    assert state["most"] >= 2, state
    assert json.dumps(threaded, sort_keys=True) == json.dumps(serial, sort_keys=True)
