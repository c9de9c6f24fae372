"""The port's generic predict CLI (`cli.predict`), `cli.ensemble` and
`cli.evaluate` against the JAX package's predict_from_folder,
ensemble_predictions and evaluate_folder on the CPU, in the sliding window's
default (non-exact) mode; test_torch_port_predict_cli_exact.py runs the same
comparisons in the exact mode.

A tiny 3-class (softmax) TrainerV2 model folder with two folds of fp32
weights in RESULTS_FOLDER's layout (the JAX package's import of it beside
the `.model` files) and two CT cases go through both packages in every mode:
normal and fast (the device's resize + argmax export), fastest (argmax on
the network's grid, then nearest), the host export (MTTPU_DEVICE_EXPORT=0,
held to the JAX package's host export of its -z run) and -z (the host
export, probabilities kept).

Tolerances: the labelmaps agree on >= 99.9% of the voxels. The two
packages' probabilities differ by at most one bf16 ulp carried through the
fp16 accumulators (test_torch_port_sliding_window_default.py: PROB_BOUND),
so a label differs only where two classes come that close; the -z
probabilities, resampled on the host by the same code and stored as fp16,
within PROB_BOUND plus one fp16 ulp (2^-11).
"""
import json
import os

import numpy as np
import pytest
import torch

from multitalent_tpu.evaluation.evaluator import evaluate_folder as jax_evaluate_folder
from multitalent_tpu.inference import predict as jax_predict_module
from multitalent_tpu.inference.model_restore import (
    load_model_and_checkpoint_files as jax_load_model)
from multitalent_tpu.inference.predict import ensemble_predictions as jax_ensemble
from multitalent_tpu.inference.predict import predict_from_folder as jax_predict_from_folder
from multitalent_tpu.inference.pretrained_models import import_reference_model_folder
from multitalent_tpu.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.cli import ensemble as ensemble_cli
from multitalent_tpu_torch.cli import evaluate as evaluate_cli
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.inference.model_restore import save_model_folder
from multitalent_tpu_torch.inference.predict import predict_cases
from multitalent_tpu_torch.io import Geometry, Plans, read_nifti, write_nifti
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor

from test_torch_port_predict import _phantom, _tiny_plans, one_thread  # noqa: F401
from test_torch_port_sliding_window_default import PROB_BOUND

TASK = "Task003_Liver"
CASES = ("liver_000", "liver_001")
AGREE = 0.999
# the cases: z resampled from 1.6 to the plans' 1.5 (19 slices), y and x one
# patch; 2 x 1 x 1 tiles, 8 mirror combinations, 2 folds
SHAPE = (18, 32, 32)
FORWARDS = 2 * 8 * 2


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    """The model folder under <root>/results, the two cases under in/, their
    labels under gt/; `runs` caches each package's output folder a mode."""
    root = tmp_path_factory.mktemp("predict_cli")
    d = _tiny_plans().to_dict()
    d.update(num_classes=2, all_classes=[1, 2])
    plans = Plans.from_dict(d)
    sds = []
    for fold in range(2):
        torch.manual_seed(20 + fold)
        sds.append(build_unet_from_plans(plans, 0, num_classes=3).state_dict())
    model = root / "results" / "nnUNet" / "3d_fullres" / TASK / "TrainerV2__MTTPUPlansv2.1"
    save_model_folder(str(model), plans, sds, "TrainerV2", fp16=False)
    import_reference_model_folder(str(model), "TrainerV2")
    for fold in range(2):
        # the JAX import builds its trainer with fp16=True; the sidecar
        # carries the init arguments, fp16 last
        sidecar = model / f"fold_{fold}" / "model_final_checkpoint.ckpt.pkl"
        meta = load_pickle(sidecar)
        meta["init_args"] = (*meta["init_args"][:8], False)
        save_pickle(meta, sidecar)
    (root / "in").mkdir()
    (root / "gt").mkdir()
    for i, case in enumerate(CASES):
        ct = _phantom(np.random.RandomState(30 + i))[1:19, 4:36, 2:34]
        geometry = Geometry(spacing=(1.0, 1.0, 1.6))
        write_nifti(root / "in" / f"{case}_0000.nii.gz", ct.astype(np.int16), geometry)
        write_nifti(root / "gt" / f"{case}.nii.gz",
                    ((ct > -500).astype(np.uint8) + (ct > 300)).astype(np.uint8), geometry)
    return {"root": root, "model": str(model), "runs": {}}


def _env(monkeypatch, exact: bool, device_export: bool = True):
    monkeypatch.setenv("MTTPU_SW_EXACT", "1" if exact else "0")
    monkeypatch.setenv("MTTPU_DEVICE_EXPORT", "1" if device_export else "0")


def port_run(task, exact: bool, mode: str = "normal", device_export: bool = True,
             npz: bool = False):
    """The port's CLI output folder and timings of one configuration, and
    the shapes of the volumes it put on the device (a spy on begin_put)."""
    key = ("port", exact, mode, device_export, npz)
    if key not in task["runs"]:
        out = task["root"] / "_".join(map(str, key))
        args = ["-i", str(task["root"] / "in"), "-o", str(out), "-t", TASK, "-m",
                "3d_fullres", "-tr", "TrainerV2", "--mode", mode, "--device", "cpu"]
        args += ["-z"] if npz else []
        puts, begin_put = [], SlidingWindowPredictor.begin_put

        def spy(self, volume):
            puts.append(volume.shape)
            return begin_put(self, volume)

        with pytest.MonkeyPatch.context() as mp:
            _env(mp, exact, device_export)
            mp.setenv("RESULTS_FOLDER", str(task["root"] / "results"))
            mp.setattr(SlidingWindowPredictor, "begin_put", spy)
            timings = predict_cli.main(args)
        task["runs"][key] = (out, timings, puts)
    return task["runs"][key]


def jax_run(task, exact: bool, mode: str = "normal", npz: bool = False):
    """The JAX package's predict_from_folder output of one configuration.
    The runs of one sliding-window mode share one restored trainer and its
    predictor (what predict_from_folder builds anew each call), so the
    tiled program compiles once a mode, not once a run."""
    key = ("jax", exact, mode, npz)
    if key not in task["runs"]:
        out = task["root"] / "_".join(map(str, key))
        loaded = task.setdefault("jax_loaded", {})

        def load(model, folds, checkpoint_name="model_final_checkpoint"):
            if exact not in loaded:
                trainer, params = jax_load_model(model, folds, checkpoint_name)
                make = trainer.get_sliding_window_predictor
                predictors = {}

                def predictor(do_mirroring=True, step_size=0.5, use_gaussian=True):
                    args = (do_mirroring, step_size, use_gaussian)
                    if args not in predictors:
                        predictors[args] = make(*args)
                    return predictors[args]

                trainer.get_sliding_window_predictor = predictor
                loaded[exact] = (trainer, params)
            return loaded[exact]

        with pytest.MonkeyPatch.context() as mp:
            _env(mp, exact)
            mp.setattr(jax_predict_module, "load_model_and_checkpoint_files", load)
            jax_predict_from_folder(task["model"], str(task["root"] / "in"), str(out), None,
                                    save_npz=npz, mode=mode)
        task["runs"][key] = out
    return task["runs"][key]


def labels(folder, case):
    return read_nifti(os.path.join(folder, f"{case}.nii.gz"))[0]


def check_against_jax(task, exact: bool, mode: str, agree: float, prob_bound: float):
    """The port's labelmaps (and -z probabilities) of one mode against the
    JAX package's. mode "host": the port's normal mode under
    MTTPU_DEVICE_EXPORT=0, against the JAX package's -z run (whose export
    is the host's); "z": -z in both."""
    if mode in ("host", "z"):
        got, *_ = port_run(task, exact, device_export=mode != "host", npz=mode == "z")
        want = jax_run(task, exact, npz=True)
    else:
        got, *_ = port_run(task, exact, mode)
        want = jax_run(task, exact, mode)
    for case in CASES:
        a, b = labels(got, case), labels(want, case)
        assert a.shape == SHAPE and set(np.unique(a)) <= {0, 1, 2}
        assert np.mean(a == b) >= agree, (case, np.mean(a == b))
        if mode == "z":
            p = np.load(os.path.join(got, f"{case}.npz"))["softmax"].astype(np.float32)
            q = np.load(os.path.join(want, f"{case}.npz"))["softmax"].astype(np.float32)
            assert p.shape == q.shape == (3, *SHAPE)
            assert np.abs(p - q).max() <= prob_bound + 2.0 ** -11
            assert load_pickle(os.path.join(got, f"{case}.pkl"))["size_after_cropping"] == \
                load_pickle(os.path.join(want, f"{case}.pkl"))["size_after_cropping"]
        else:
            assert not os.path.exists(os.path.join(got, f"{case}.npz"))


@pytest.mark.parametrize("mode", ["normal", "fast", "fastest", "host", "z"])
def test_default_mode_matches_jax(task, mode):
    check_against_jax(task, False, mode, AGREE, PROB_BOUND)


def test_normal_and_fast_labels_are_bit_equal(task):
    """Both take the device's resize + argmax of the fold sum."""
    normal, *_ = port_run(task, False)
    fast, *_ = port_run(task, False, "fast")
    for case in CASES:
        assert np.array_equal(labels(normal, case), labels(fast, case))


@pytest.mark.parametrize("mode", ["normal", "fastest"])
def test_the_volume_is_put_once_per_case(task, mode):
    """Two folds, one put a case (the timings count them, and so does the
    spy on begin_put), every fold's tiles x mirror combinations, in chunks
    of four combinations a network call."""
    _, timings, puts = port_run(task, False, mode)
    assert [t["case"] for t in timings] == list(CASES)
    assert len(puts) == len(CASES)
    for t in timings:
        assert (t["puts"], t["forwards"], t["net_calls"]) == (1, FORWARDS, FORWARDS // 4)
        assert t["predict_s"] > 0 and t["export_s"] >= 0


def test_fast_modes_refuse_npz(task):
    for mode in ("fast", "fastest"):
        with pytest.raises(ValueError, match="save_npz"):
            predict_cases(task["model"], [[]], ["x.nii.gz"], None, save_npz=True,
                          fast_mode=mode, device="cpu")


@pytest.mark.parametrize("model", ["2d", "3d_lowres", "3d_cascade_fullres"])
def test_other_networks_raise_naming_their_item(task, model, monkeypatch):
    """2d (neither package predicts a 2D model: the JAX sliding window tiles
    three axes) and 3d_cascade_fullres (the JAX CLI never reads the
    previous stage's segmentations) raise, each naming its reason. A
    3d_lowres folder, refused until the cascade was ported (item 10c), is an
    ordinary model folder at stage 0 of a two-stage plan: the same weights
    and stage-0 plans predict what the 3d_fullres folder predicts."""
    if model != "3d_lowres":
        match = {"2d": "2D models are not predicted",
                 "3d_cascade_fullres": "lowres_segmentations"}[model]
        with pytest.raises(NotImplementedError, match=match):
            predict_cli.main(["-i", "in", "-o", "out", "-t", TASK, "-m", model,
                              "--device", "cpu"])
        return
    root = task["root"]
    d = _tiny_plans().to_dict()
    d.update(num_classes=2, all_classes=[1, 2], num_stages=2)
    full = dict(d["plans_per_stage"][0], current_spacing=[0.75, 0.5, 0.5])
    d["plans_per_stage"] = {0: d["plans_per_stage"][0], 1: full}
    sds = [torch.load(os.path.join(task["model"], f"fold_{f}", "model_final_checkpoint.model"),
                      weights_only=False)["state_dict"] for f in range(2)]
    lowres = root / "results" / "nnUNet" / "3d_lowres" / TASK / "TrainerV2__MTTPUPlansv2.1"
    save_model_folder(str(lowres), Plans.from_dict(d), sds, "TrainerV2", stage=0, fp16=False)
    _env(monkeypatch, exact=False)
    monkeypatch.setenv("RESULTS_FOLDER", str(root / "results"))
    out = root / "lowres_out"
    timings = predict_cli.main(["-i", str(root / "in"), "-o", str(out), "-t", TASK, "-m",
                                "3d_lowres", "-tr", "TrainerV2", "--device", "cpu"])
    assert [t["forwards"] for t in timings] == [FORWARDS] * len(CASES)
    full_out = port_run(task, False)[0]
    for case in CASES:
        got, g = read_nifti(out / f"{case}.nii.gz")
        ref, r = read_nifti(full_out / f"{case}.nii.gz")
        assert np.array_equal(got, ref) and vars(g) == vars(r), case


def test_ensemble_matches_jax(task):
    """cli.ensemble and the JAX package's ensemble_predictions on the same two
    -z folders (the port's prediction and the JAX package's): the same
    labelmaps, bit for bit, which agree with the port's normal ones."""
    folders = [str(port_run(task, False, npz=True)[0]), str(jax_run(task, False, npz=True))]
    ensemble_cli.main(["-f", *folders, "-o", str(task["root"] / "ens_port")])
    jax_ensemble(folders, str(task["root"] / "ens_jax"))
    normal, *_ = port_run(task, False)
    for case in CASES:
        got = labels(task["root"] / "ens_port", case)
        assert np.array_equal(got, labels(task["root"] / "ens_jax", case))
        assert np.mean(got == labels(normal, case)) >= AGREE


def test_evaluate_matches_jax(task):
    """cli.evaluate's summary of the port's prediction equals the JAX
    package's evaluate_folder's of the same folder and ground truth."""
    out, *_ = port_run(task, False)
    got = evaluate_cli.main(["-ref", str(task["root"] / "gt"), "-pred", str(out),
                             "-l", "1", "2"])
    with open(os.path.join(out, "summary.json")) as f:
        written = json.load(f)["results"]
    want = jax_evaluate_folder(str(task["root"] / "gt"), str(out), [1, 2])
    np.testing.assert_equal(got, want)  # NaN (a label never predicted) equals NaN
    np.testing.assert_equal(written["mean"], got["mean"])
    assert set(got["mean"]) == {"1", "2"} and all(
        0 <= got["mean"][k]["Dice"] <= 1 for k in ("1", "2"))
