"""Validation after training, the port's against the JAX package's, on the CPU:
`MultiTalentTrainer.validate` (run_multitalent_validation) and
`TrainerV2.validate` (run_validation, softmax, --npz, determine_postprocessing)
from the same weights (the JAX trainer's init, carried by io/from_jax.py),
on the same preprocessed cases with full export properties and a
`gt_segmentations/` folder, in fp32, the JAX sliding window in its exact mode
(MTTPU_SW_EXACT=1).

The plans are the flagship-like tiny plans of test_torch_port_train_slice.py
(base 4, pools (1,2,2), (2,2,2)x2, patch 8x16x16). The validation cases are
8x16x24: 2 overlapping tiles x 8 mirror combinations each.

What must agree:
- every NIfTI of a case that needs no resize is equal (both export the same
  thresholded or argmaxed fp32 probabilities, which differ in summation order
  only);
- the resized MultiTalent case (its cropped grid 1.2x, 1.1x, 1.1x the
  preprocessed one) is resized on the host by the JAX package (scipy order 1)
  and trilinearly on the device by the port: >= 99.9% of its voxels agree in
  every region and in the labelmap (measured: every region 100%, the
  labelmap 100%);
- per-label Dice of every summary within 1e-6 (of the same masks).
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest

from multitalent_tpu.parallel import mesh
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.training.multitalent import MultiTalentTrainer as JaxMultiTalentTrainer
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer
from multitalent_tpu_torch.training.trainers import TrainerV2

from test_torch_port_train_slice import flagship_like_plans, port_plans
from test_training import make_preprocessed

CASE = (8, 16, 24)
RESIZE = (1.2, 1.1, 1.1)


def stamp_export_geometry(ddir, resized=(), margin=(1, 2, 2), identifier="mtt_data"):
    """Give every preprocessed case of `ddir` the properties the export needs
    (its cropped grid: the preprocessed one, or RESIZE times it for the cases
    in `resized`; a crop box `margin` inside the original volume; spacings
    that make the two grids the same extent) and write its ground truth,
    the preprocessed labels resized nearest to the cropped grid and uncropped,
    to `ddir/gt_segmentations/<case>.nii.gz`."""
    folder = Path(ddir) / f"{identifier}_stage0"
    gt_dir = Path(ddir) / "gt_segmentations"
    gt_dir.mkdir(exist_ok=True)
    for npz in sorted(folder.glob("*.npz")):
        key = npz.stem
        seg = np.load(npz)["data"][-1]
        shape = seg.shape
        after = tuple(int(round(s * f)) for s, f in zip(shape, RESIZE)) \
            if key in resized else shape
        spacing = tuple(s / a for s, a in zip(shape, after))  # preprocessed spacing 1
        bbox = [[m, m + a] for m, a in zip(margin, after)]
        original = tuple(a + 2 * m for a, m in zip(after, margin))
        props = load_pickle(folder / f"{key}.pkl")
        props.update(original_spacing=np.array(spacing),
                     spacing_after_resampling=np.array([1.0, 1.0, 1.0]),
                     size_after_cropping=after, crop_bbox=bbox,
                     original_size_of_raw_data=np.array(original),
                     itk_spacing=spacing[::-1], itk_origin=(0.0, 0.0, 0.0),
                     itk_direction=(1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0))
        save_pickle(props, folder / f"{key}.pkl")
        idx = [np.minimum((np.arange(a) * s) // a, s - 1) for a, s in zip(after, shape)]
        gt = np.zeros(original, np.uint8)
        gt[tuple(slice(lo, hi) for lo, hi in bbox)] = seg[np.ix_(*idx)]
        write_nifti(gt_dir / f"{key}.nii.gz", gt, Geometry(spacing=spacing[::-1]))


def multitalent_task(ddir) -> list[str]:
    """Two Task003 cases (one resized on export) and two Task009 cases
    (labels moved to the spleen's 8); the validation split: 003_000,
    003_001 and 009_000."""
    make_preprocessed(ddir, n_cases=2, prefix="003", shape=CASE,
                      extra_props={"valid_regions": ("03_liver", "03_cancer"),
                                   "valid_labels": [1, 2]})
    make_preprocessed(ddir, n_cases=2, prefix="009", shape=CASE,
                      extra_props={"valid_regions": ("09_spleen",), "valid_labels": [8]})
    folder = Path(ddir) / "mtt_data_stage0"
    for npz in folder.glob("009_*.npz"):
        data = np.load(npz)["data"]
        data[-1][data[-1] > 0] = 8
        np.savez_compressed(npz, data=data)
        props = load_pickle(folder / (npz.stem + ".pkl"))
        props["class_locations"] = {8: props["class_locations"][1]}
        save_pickle(props, folder / (npz.stem + ".pkl"))
    stamp_export_geometry(ddir, resized=("003_001",))
    keys = ["003_000", "003_001", "009_000", "009_001"]
    val = ["003_000", "003_001", "009_000"]
    save_pickle([{"train": keys, "val": val}] * 12, Path(ddir) / "splits_custom.pkl")
    return val


def _both(tmp_path, mp, jax_cls, port_cls, ddir, **validate_kwargs):
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    mp.setenv("MTTPU_SW_EXACT", "1")
    plans = flagship_like_plans()
    jt = jax_cls(plans, 0, str(tmp_path / "jax"), str(ddir), fp16=False)
    jt.initialize(True)
    pt = port_cls(port_plans(plans), 0, str(tmp_path / "port"), str(ddir), fp16=False,
                  device="cpu")
    pt.initialize(True)
    import jax
    pt.network.load_state_dict(generic_unet_state_dict_from_flax(
        jax.device_get(jt.state.params), num_pool=3))
    try:
        jax_res = jt.validate(**validate_kwargs)
        port_res = pt.validate(**validate_kwargs)
    finally:
        for t in (jt, pt):
            t.tr_gen.stop()
            t.val_gen.stop()
    return Path(jt.output_folder), Path(pt.output_folder), jax_res, port_res, pt, jt


def _labels_dice(summary: dict) -> dict:
    return {label: {m: v for m, v in scores.items()}
            for label, scores in summary["results"]["mean"].items()}


def _assert_summaries_close(a: dict, b: dict) -> None:
    da, db = _labels_dice(a), _labels_dice(b)
    assert da.keys() == db.keys()
    for label in da:
        assert da[label].keys() == db[label].keys()
        for metric in da[label]:
            x, y = da[label][metric], db[label][metric]
            assert (np.isnan(x) and np.isnan(y)) or abs(x - y) <= 1e-6, (label, metric, x, y)


@pytest.fixture(scope="module")
def multitalent(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mt_validation")
    ddir = tmp / "Task100_MultiTalent"
    val = multitalent_task(ddir)
    mp = pytest.MonkeyPatch()
    try:
        return (*_both(tmp, mp, JaxMultiTalentTrainer, MultiTalentTrainer, ddir), val)
    finally:
        mp.undo()


def test_multitalent_validation_files(multitalent):
    jdir, pdir, _, _, pt, _, val = multitalent
    out = pdir / "validation_raw"
    assert sorted(os.listdir(out / "individual")) == sorted(REGIONS)
    assert [t["case"] for t in pt.validation_timings] == val
    assert all(t["forwards"] == 2 * 8 for t in pt.validation_timings)
    for k in val:
        merged, geom = read_nifti(out / f"{k}.nii.gz")
        ref, rgeom = read_nifti(jdir / "validation_raw" / f"{k}.nii.gz")
        assert merged.shape == ref.shape and np.allclose(geom.spacing, rgeom.spacing)
        # only the case's dataset's labels are stamped
        allowed = {0, 1, 2} if k.startswith("003") else {0, 8}
        assert set(np.unique(merged).tolist()) <= allowed, (k, np.unique(merged))
    assert {f.name for f in out.glob("summary_*.json")} == {
        "summary_Task003_Liver.json", "summary_Task009_Spleen.json"}


@pytest.mark.parametrize("case", ["003_000", "009_000"])
def test_multitalent_validation_equal_without_resize(multitalent, case):
    jdir, pdir = multitalent[0], multitalent[1]
    for rel in [f"{case}.nii.gz"] + [f"individual/{r}/{case}.nii.gz" for r in REGIONS]:
        got, _ = read_nifti(pdir / "validation_raw" / rel)
        ref, _ = read_nifti(jdir / "validation_raw" / rel)
        assert np.array_equal(got, ref), rel


def test_multitalent_validation_resized_case_agrees(multitalent):
    jdir, pdir = multitalent[0], multitalent[1]
    agree = {}
    for rel in ["003_001.nii.gz"] + [f"individual/{r}/003_001.nii.gz" for r in REGIONS]:
        got, _ = read_nifti(pdir / "validation_raw" / rel)
        ref, _ = read_nifti(jdir / "validation_raw" / rel)
        assert got.shape == ref.shape
        agree[rel] = float(np.mean(got == ref))
    assert min(agree.values()) >= 0.999, sorted(agree.items(), key=lambda kv: kv[1])[:3]


@pytest.mark.parametrize("task", ["Task003_Liver", "Task009_Spleen"])
def test_multitalent_validation_summaries(multitalent, task):
    jdir, pdir, jax_res, port_res = multitalent[:4]
    a = json.loads((jdir / "validation_raw" / f"summary_{task}.json").read_text())
    b = json.loads((pdir / "validation_raw" / f"summary_{task}.json").read_text())
    assert a["name"] == b["name"] == f"validation_{task}"
    _assert_summaries_close(a, b)
    assert set(port_res) == set(jax_res) == {"Task003_Liver", "Task009_Spleen"}
    # the masks of Task009's case are equal, so its Dice is too; the resized
    # Task003 case agrees to >= 99.9%
    if task == "Task009_Spleen":
        assert np.isfinite(port_res[task]["mean"]["8"]["Dice"])


@pytest.fixture(scope="module")
def softmax(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("v2_validation")
    ddir = tmp / "Task004_Hippocampus"
    make_preprocessed(ddir, n_cases=3, prefix="case", shape=CASE)
    stamp_export_geometry(ddir)
    keys = [f"case_{i:03d}" for i in range(3)]
    save_pickle([{"train": keys, "val": keys[:2]}] * 5, ddir / "splits_final.pkl")
    mp = pytest.MonkeyPatch()
    try:
        return _both(tmp, mp, JaxTrainerV2, TrainerV2, ddir, save_softmax=True,
                     run_postprocessing_on_folds=True)
    finally:
        mp.undo()


def test_trainer_v2_validation_matches_jax(softmax):
    jdir, pdir, jax_res, port_res = softmax[:4]
    for k in ("case_000", "case_001"):
        got, _ = read_nifti(pdir / "validation_raw" / f"{k}.nii.gz")
        ref, _ = read_nifti(jdir / "validation_raw" / f"{k}.nii.gz")
        assert np.array_equal(got, ref), k
        # --npz: fp16 softmax on the cropped grid, and its properties
        a = np.load(pdir / "validation_raw" / f"{k}.npz")["softmax"]
        b = np.load(jdir / "validation_raw" / f"{k}.npz")["softmax"]
        assert a.shape == b.shape == (3, *CASE) and a.dtype == np.float16
        np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32), atol=1e-3)
        assert (pdir / "validation_raw" / f"{k}.pkl").is_file()
    _assert_summaries_close(json.loads((jdir / "validation_raw" / "summary.json").read_text()),
                            json.loads((pdir / "validation_raw" / "summary.json").read_text()))
    assert port_res["mean"].keys() == jax_res["mean"].keys() == {"1", "2"}


def test_trainer_v2_postprocessing_matches_jax(softmax):
    jdir, pdir = softmax[0], softmax[1]
    a = json.loads((jdir / "postprocessing.json").read_text())
    b = json.loads((pdir / "postprocessing.json").read_text())
    assert a["for_which_classes"] == b["for_which_classes"]
    for key in ("dc_per_class_raw", "dc_per_class_pp_all", "dc_per_class_pp_per_class",
                "dc_after_pp"):
        assert a[key].keys() == b[key].keys()
        for c in a[key]:
            assert abs(a[key][c] - b[key][c]) <= 1e-6, (key, c)
    names = sorted(os.listdir(jdir / "validation_raw_postprocessed"))
    assert names == sorted(os.listdir(pdir / "validation_raw_postprocessed"))
    for f in names:
        got, _ = read_nifti(pdir / "validation_raw_postprocessed" / f)
        ref, _ = read_nifti(jdir / "validation_raw_postprocessed" / f)
        assert np.array_equal(got, ref), f


@pytest.mark.parametrize("which", ["multitalent", "softmax"])
def test_predict_preprocessed_data_matches_jax(request, monkeypatch, which):
    """predict_preprocessed_data_return_seg_and_softmax on one validation
    case: the same segmentation (thresholded regions stamped in order, or
    argmax) and probabilities within 1e-5 (summation order)."""
    from multitalent_tpu_torch.data.dataset import load_case
    pt, jt = request.getfixturevalue(which)[4:6]
    monkeypatch.setenv("MTTPU_SW_EXACT", "1")
    key = sorted(pt.dataset_val)[0]
    data = np.array(load_case(pt.dataset_val[key]))[:-1]
    seg, probs = pt.predict_preprocessed_data_return_seg_and_softmax(data)
    jseg, jprobs = jt.predict_preprocessed_data_return_seg_and_softmax(data)
    assert seg.shape == CASE and np.array_equal(seg, np.asarray(jseg))
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-5)
