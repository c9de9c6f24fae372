"""The port's Task100 build (tasks/convert_task100.py) against the JAX
package's, on the CPU.

Two tiny seeded source tasks, a Liver (labels 1, 2) and a Spleen (label 1),
are merged into Task100_MultiTalent by each package in a root of its own:
the same images, the same labels remapped into the global 1..47 space, the
same dataset.json and cases_have_regions_labels.pkl. After each package's
plan_and_preprocess with the MultiTalent planner, the port's
`--addregions-only` and the JAX package's add_regions_to_pkls over the
cropped and the preprocessed stage folder stamp the same valid_labels /
valid_regions into every case pkl. (The JAX package's `--addregions-only`
itself also walks the preprocessed task folder, where it stamps the plans
pickle and raises: the last case below shows it.)
"""
import gzip
import os
import shutil

import numpy as np
import pytest

from multitalent_tpu.cli import plan_and_preprocess as jplan
from multitalent_tpu.io import nifti as jnifti
from multitalent_tpu.tasks import convert_task100 as jconvert
from multitalent_tpu_torch.cli import plan_and_preprocess as pplan
from multitalent_tpu_torch.tasks import convert_task100 as pconvert
from multitalent_tpu_torch.utils.fileops import load_json, load_pickle

from test_torch_port_planning import roots_env, same, write_raw_task

SOURCES = {"Task003_Liver": ({0: "background", 1: "liver", 2: "cancer"},
                             ((1, 0.45), (2, 0.15)), "liver"),
           "Task009_Spleen": ({0: "background", 1: "spleen"}, ((1, 0.3),), "spleen")}
TARGET = "Task100_MultiTalent"
PACKAGES = {"jax": (jconvert, jplan), "port": (pconvert, pplan)}


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Each package: build Task100 from both sources, plan and preprocess it
    with the MultiTalent planner, then stamp the regions."""
    base = tmp_path_factory.mktemp("task100")
    roots = {name: str(base / name) for name in PACKAGES}
    for seed, (task, (labels, organs, prefix)) in enumerate(SOURCES.items()):
        write_raw_task(os.path.join(roots["jax"], "raw"), task, labels, organs, 3,
                       seed=10 + seed, prefix=prefix)
    shutil.copytree(os.path.join(roots["jax"], "raw"), os.path.join(roots["port"], "raw"))
    with pytest.MonkeyPatch.context() as mp:
        for name, (convert, plan) in PACKAGES.items():
            roots_env(mp, roots[name])
            convert.main(["--tasks", *SOURCES])
            plan.main(["-t", "100", "-pl3d", "ExperimentPlanner3D_v21_MultiTalent",
                       "-pl2d", "None", "-tf", "2"])
            if name == "port":
                convert.main(["--addregions-only"])
            else:
                convert.add_regions_to_pkls([
                    os.path.join(roots[name], "raw", "nnUNet_cropped_data", TARGET),
                    os.path.join(roots[name], "prep", TARGET, "MultiTalent_data_stage0")])
    return roots


def _task100(roots, *parts):
    return [os.path.join(root, "raw", "nnUNet_raw_data", TARGET, *parts)
            for root in roots.values()]


def test_merged_images_labels_and_manifest_match(built):
    jfolder, pfolder = _task100(built)
    for sub in ("imagesTr", "labelsTr"):
        names = sorted(os.listdir(os.path.join(jfolder, sub)))
        assert len(names) == 6 and names == sorted(os.listdir(os.path.join(pfolder, sub)))
        for n in names:
            a, b = (gzip.decompress(open(os.path.join(f, sub, n), "rb").read())
                    for f in (jfolder, pfolder))
            assert a == b, (sub, n)
    seg, _ = jnifti.read_nifti(os.path.join(pfolder, "labelsTr", "009_spleen_000.nii.gz"))
    assert set(np.unique(seg).tolist()) == {0, 8}  # Task009's spleen is global label 8
    assert load_json(os.path.join(jfolder, "dataset.json")) == load_json(
        os.path.join(pfolder, "dataset.json"))
    regions = [load_pickle(os.path.join(f, "cases_have_regions_labels.pkl"))
               for f in (jfolder, pfolder)]
    assert same(regions[1], regions[0])
    assert regions[1]["003_liver_001"] == ("03_liver", "03_cancer")


def test_region_stamps_match(built):
    """Every case pkl of the cropped folder and of the preprocessed
    MultiTalent_data stage carries the same valid_labels / valid_regions in
    both packages."""
    swap = (built["port"], built["jax"])
    folders = [os.path.join("raw", "nnUNet_cropped_data", TARGET),
               os.path.join("prep", TARGET, "MultiTalent_data_stage0")]
    stamped = 0
    for folder in folders:
        jdir, pdir = (os.path.join(root, folder) for root in built.values())
        names = sorted(n for n in os.listdir(jdir) if n.endswith(".pkl")
                       and n[:-4] not in ("dataset_properties", "intensityproperties"))
        assert names == sorted(n for n in os.listdir(pdir) if n.endswith(".pkl")
                               and n[:-4] not in ("dataset_properties", "intensityproperties"))
        for n in names:
            a, b = load_pickle(os.path.join(jdir, n)), load_pickle(os.path.join(pdir, n))
            assert same(b, a, swap), (folder, n)
            assert b["valid_regions"] == (("09_spleen",) if n.startswith("009_")
                                          else ("03_liver", "03_cancer")), n
            stamped += 1
    assert stamped == 12


def test_jax_addregions_cli_stamps_the_plans_pickle(built, tmp_path, monkeypatch):
    """The JAX package's `--addregions-only` on a planned Task100 walks the
    preprocessed task folder and fails on the plans pickle there; the port's
    leaves it alone and stamps the cases again to the same result."""
    for name in PACKAGES:
        shutil.copytree(built[name], tmp_path / name)
    roots_env(monkeypatch, str(tmp_path / "jax"))
    with pytest.raises(StopIteration):
        jconvert.main(["--addregions-only"])
    roots_env(monkeypatch, str(tmp_path / "port"))
    pconvert.main(["--addregions-only"])
    prep = os.path.join("prep", TARGET)
    for n in ("MultiTalent_bs4_plans_3D.pkl", "MultiTalent_data_stage0/003_liver_000.pkl"):
        assert same(load_pickle(os.path.join(tmp_path, "port", prep, n)),
                    load_pickle(os.path.join(built["port"], prep, n)),
                    (str(tmp_path / "port"), built["port"])), n
