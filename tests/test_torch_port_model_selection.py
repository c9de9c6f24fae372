"""The port's model selection and postprocessing CLIs
(cli/find_best_configuration.py, cli/determine_postprocessing.py,
cli/consolidate_postprocessing.py, evaluation/model_selection.py,
evaluation/surface_dice.py) against the JAX package's, on the CPU.

Written validation folders of two configurations (2d and 3d_fullres, softmax
saved as .npz, so the pairwise ensemble runs; the 2d one with a stray blob
that largest-component removal takes away) sit in each package's root. Each
package runs find_best_configuration with its default configurations (the
missing 3d_lowres and cascade folders are skipped), determine_postprocessing
and consolidate_postprocessing; every file they write comes out equal:
summary.json (its timestamp and id aside, paths with the roots swapped),
ensemble and postprocessed NIfTIs, model_selection_<task>.json and
postprocessing.json.
"""
import gzip
import os
import shutil
import zipfile

import numpy as np
import pytest

from multitalent_tpu.cli import consolidate_postprocessing as jconsolidate
from multitalent_tpu.cli import determine_postprocessing as jdetermine
from multitalent_tpu.cli import find_best_configuration as jfind
from multitalent_tpu.evaluation import model_selection as jms
from multitalent_tpu.evaluation.evaluator import evaluate_folder
from multitalent_tpu.evaluation.surface_dice import normalized_surface_dice as jnsd
from multitalent_tpu.io.nifti import Geometry, write_nifti
from multitalent_tpu_torch.cli import consolidate_postprocessing as pconsolidate
from multitalent_tpu_torch.cli import determine_postprocessing as pdetermine
from multitalent_tpu_torch.cli import find_best_configuration as pfind
from multitalent_tpu_torch.evaluation import model_selection as pms
from multitalent_tpu_torch.evaluation.surface_dice import normalized_surface_dice as pnsd
from multitalent_tpu_torch.utils.fileops import load_json, save_json, save_pickle

from test_inference import full_properties
from test_model_selection import SHAPE, TASK, TRAINER_DIR, _gt_seg, _softmax_for
from test_torch_port_planning import roots_env, same

PACKAGES = {"jax": (jfind, jdetermine, jconsolidate, jms),
            "port": (pfind, pdetermine, pconsolidate, pms)}
CASES = range(3)


def _write_fold(model_dir, gt, wrong: int, confidence: float, stray: bool):
    """fold_0/validation_raw of one configuration: per case the labelmap with
    `wrong` class-1 voxels flipped to background (and a stray class-1 blob
    apart from the object), its softmax .npz and properties .pkl; and the
    folder's summary.json, as the validation after training leaves it."""
    vdir = os.path.join(model_dir, "fold_0", "validation_raw")
    os.makedirs(vdir)
    for i in CASES:
        pred = _gt_seg(i)
        idx = np.argwhere(pred == 1)[:wrong]
        pred[tuple(idx.T)] = 0
        if stray:
            pred[0, 0, 7 + i % 2:] = 1
        write_nifti(os.path.join(vdir, f"case{i}.nii.gz"), pred, Geometry())
        np.savez_compressed(os.path.join(vdir, f"case{i}.npz"),
                            softmax=_softmax_for(pred, confidence).astype(np.float16))
        save_pickle(full_properties(SHAPE), os.path.join(vdir, f"case{i}.pkl"))
    evaluate_folder(gt, vdir, labels=[1, 2])


def _strip(summary: dict) -> dict:
    return {k: v for k, v in summary.items() if k not in ("timestamp", "id")}


@pytest.fixture(scope="module")
def selected(tmp_path_factory):
    base = tmp_path_factory.mktemp("selection")
    roots = {name: str(base / name) for name in PACKAGES}
    jax_root = roots["jax"]
    prep = os.path.join(jax_root, "prep", TASK)
    os.makedirs(os.path.join(prep, "gt_segmentations"))
    for i in CASES:
        write_nifti(os.path.join(prep, "gt_segmentations", f"case{i}.nii.gz"), _gt_seg(i),
                    Geometry())
    save_json({"labels": {"0": "bg", "1": "organ", "2": "lesion"}, "modality": {"0": "CT"}},
              os.path.join(prep, "dataset.json"))
    models = os.path.join(jax_root, "results", "nnUNet")
    gt = os.path.join(prep, "gt_segmentations")
    _write_fold(os.path.join(models, "3d_fullres", TASK, TRAINER_DIR), gt, 0, 0.9, False)
    _write_fold(os.path.join(models, "2d", TASK, TRAINER_DIR), gt, 6, 0.8, True)
    shutil.copytree(jax_root, roots["port"])
    with pytest.MonkeyPatch.context() as mp:
        for name, (find, determine, consolidate, _) in PACKAGES.items():
            roots_env(mp, roots[name])
            find.main(["-t", TASK, "-f", "0"])
            determine.main(["-t", TASK, "-m", "2d", "-f", "0", "--processes", "2"])
            consolidate.main(["-t", TASK, "-m", "2d", "-f", "0", "--processes", "2"])
    return roots


def _results_files(root):
    top = os.path.join(root, "results")
    return sorted(os.path.relpath(os.path.join(d, f), top)
                  for d, _, files in os.walk(top) for f in files)


def test_selection_writes_the_same_files(selected):
    files = _results_files(selected["jax"])
    assert files == _results_files(selected["port"])
    swap = (selected["port"], selected["jax"])
    kinds = {"json": 0, "nii.gz": 0}
    for rel in files:
        a, b = (os.path.join(selected[n], "results", rel) for n in ("jax", "port"))
        if rel.endswith(".json"):
            assert same(_strip(load_json(b)), _strip(load_json(a)), swap), rel
            kinds["json"] += 1
        elif rel.endswith(".nii.gz"):
            assert gzip.decompress(open(a, "rb").read()) == gzip.decompress(
                open(b, "rb").read()), rel
            kinds["nii.gz"] += 1
    assert kinds == {"json": 9, "nii.gz": 24}, kinds


def test_selection_chose_and_postprocessed(selected):
    """The winner, the ensemble and the postprocessing the files record."""
    base = os.path.join(selected["port"], "results", "nnUNet")
    sel = load_json(os.path.join(base, f"model_selection_{TASK}.json"))
    assert sel["best"] == "3d_fullres"
    assert set(sel["results"]) == {"2d", "3d_fullres", "ensemble_2d__3d_fullres"}
    ens = os.path.join(base, "ensembles", TASK, "ensemble_2d__3d_fullres")
    assert sorted(f for f in os.listdir(ens) if f.endswith(".nii.gz")) == [
        f"case{i}.nii.gz" for i in CASES]
    bad = os.path.join(base, "2d", TASK, TRAINER_DIR)
    for pp in (os.path.join(bad, "fold_0", "postprocessing.json"),
               os.path.join(bad, "postprocessing.json")):
        assert 1 in load_json(pp)["for_which_classes"], pp  # the stray blob goes
    assert os.path.isdir(os.path.join(bad, "cv_niftis_postprocessed"))


def test_summaries_and_zips_match(selected, tmp_path):
    """summarize_results_in_one_json / rank_candidates over the same results
    folder, and collect_pretrained_model of a JAX-layout folder."""
    with pytest.MonkeyPatch.context() as mp:
        overviews, ranks = [], []
        for name, (*_, ms) in PACKAGES.items():
            roots_env(mp, selected[name])
            overviews.append(ms.summarize_results_in_one_json(str(tmp_path / f"{name}.json")))
            ranks.append(ms.rank_candidates(TASK))
    assert same(overviews[1], overviews[0]) and overviews[0][TASK]
    assert ranks[0] == ranks[1] and ranks[1][0][0] == f"3d_fullres/{TRAINER_DIR}"
    model = tmp_path / "model"
    (model / "fold_0").mkdir(parents=True)
    for f in ("plans.pkl", "fold_0/model_final_checkpoint.ckpt",
              "fold_0/model_final_checkpoint.ckpt.pkl"):
        (model / f).write_bytes(f.encode())
    names = []
    for name, (*_, ms) in PACKAGES.items():
        ms.collect_pretrained_model(str(model), str(tmp_path / f"{name}.zip"), folds=(0, 1))
        names.append(sorted(zipfile.ZipFile(tmp_path / f"{name}.zip").namelist()))
    assert names[0] == names[1] and len(names[1]) == 3


@pytest.mark.parametrize("tolerance", [0.5, 1.0, 2.5])
def test_normalized_surface_dice_matches(tolerance):
    rng = np.random.default_rng(7)
    ref = np.zeros((12, 16, 14), bool)
    ref[3:9, 4:12, 3:10] = True
    test = ref ^ (rng.random(ref.shape) < 0.05)
    spacing = (2.0, 0.8, 0.8)
    a, b = jnsd(test, ref, tolerance, spacing), pnsd(test, ref, tolerance, spacing)
    assert a == b and 0.0 < b < 1.0
    empty = np.zeros_like(ref)
    assert np.isnan(pnsd(empty, empty, tolerance)) and pnsd(test, empty, tolerance) == 0.0
