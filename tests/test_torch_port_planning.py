"""The port's raw-data end (planning/, preprocessing/sanity_checks.py,
cli/plan_and_preprocess.py) against the JAX package's, on the CPU.

One seeded raw task of CT-like phantoms (6 cases of at most 40x64x64,
spacings varying from case to case, a zero border that cropping removes) goes
through each package's plan_and_preprocess in a root of its own: the
integrity verdicts, the cropped cases, dataset_properties.pkl, the plans of
five planners (every key; paths compared with the roots swapped) and the
preprocessed stages (arrays bit for bit) come out equal. A fingerprint of
large cases gives a two-stage plan, preprocessed with a thread count per
stage. The planned network, built by each package from its own plans, gives
the same logits within test_torch_port_unet.py's tolerance.
"""
import importlib
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.cli import plan_and_preprocess as jcli
from multitalent_tpu.io import nifti as jnifti
from multitalent_tpu.models.generic_unet import build_unet_from_plans as jax_build_unet
from multitalent_tpu.planning import experiment_planner as jep
from multitalent_tpu.plans import load_plans as jax_load_plans
from multitalent_tpu.preprocessing import sanity_checks as jsc
from multitalent_tpu.registry import PLANNERS as JAX_PLANNERS
from multitalent_tpu.utils import dataset_json as jdj
from multitalent_tpu_torch.cli import plan_and_preprocess as pcli
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
from multitalent_tpu_torch.planning import dataset_analyzer as pda
from multitalent_tpu_torch.planning import experiment_planner as pep
from multitalent_tpu_torch.planning.planners import PLANNERS, resolve_planner
from multitalent_tpu_torch.plans import load_plans
from multitalent_tpu_torch.preprocessing import sanity_checks as psc
from multitalent_tpu_torch.utils import dataset_json as pdj
from multitalent_tpu_torch.utils.fileops import load_pickle, save_pickle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TASK = "Task003_Liver"
LABELS = {0: "background", 1: "liver", 2: "cancer"}
EXTENT_MM = (40.0, 45.0, 45.0)                 # z, y, x of every phantom
Z_SPACINGS = (1.0, 1.25, 1.5, 2.0, 2.5, 1.75)  # one a case
XY_SPACINGS = (0.7, 0.75, 0.8, 0.85, 0.9, 0.72)
BORDER = 3  # zero voxels around the in-plane field of view, cropped away
PACKAGES = {"jax": jcli, "port": pcli}
PLANS_FILES = {  # plans file -> (data identifier, preprocessed)
    "MTTPUPlansv2.1_plans_3D.pkl": ("MTTPUData_plans_v2.1", True),
    "MTTPUPlansv2.1_plans_2D.pkl": ("MTTPUData_plans_v2.1_2D", True),
    "MTTPUPlans_FabiansResUNet_v2.1_plans_3D.pkl": ("MTTPUData_plans_v2.1", False),
    "MultiTalent_bs4_plans_3D.pkl": ("MultiTalent_data", True),
    "MTTPUPlans_pretrained_MT_plans_3D.pkl": ("MTTPUData_pretrained_MT", False),
}


def phantom(shape, rng, organs):
    """A CT-like int16 volume (HU) of `shape` and its labels: air, a body,
    and per (label, radius) an ellipsoid organ at a random centre."""
    axes = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape],
                       indexing="ij")
    ct = np.full(shape, -1000.0, np.float32)
    seg = np.zeros(shape, np.uint8)
    ct[sum(a * a for a in axes) < 0.9] = 40.0
    for label, radius in organs:
        c = rng.uniform(-0.2, 0.2, 3)
        inside = sum(((a - ci) / radius) ** 2 for a, ci in zip(axes, c)) < 1
        ct[inside], seg[inside] = 60.0 + 40 * label, label
    ct += rng.standard_normal(shape).astype(np.float32) * 15
    return ct.astype(np.int16), seg


def write_raw_task(raw_root, task, labels, organs, n_cases, seed, nifti=jnifti,
                   dataset_json=jdj, prefix="case"):
    """A raw nnU-Net task (imagesTr, labelsTr, dataset.json) of `n_cases`
    seeded phantoms whose spacings vary case by case (so resampling runs);
    the in-plane border of the image is 0, as outside a scanner's field of
    view. Returns the task folder."""
    folder = os.path.join(raw_root, "nnUNet_raw_data", task)
    for d in ("imagesTr", "labelsTr"):
        os.makedirs(os.path.join(folder, d), exist_ok=True)
    rng = np.random.default_rng(seed)
    for i in range(n_cases):
        spacing_zyx = (Z_SPACINGS[i % 6], XY_SPACINGS[i % 6], XY_SPACINGS[i % 6])
        shape = tuple(int(round(e / s)) for e, s in zip(EXTENT_MM, spacing_zyx))
        ct, seg = phantom(shape, rng, organs)
        ct[:, :BORDER], ct[:, -BORDER:], ct[:, :, :BORDER], ct[:, :, -BORDER:] = 0, 0, 0, 0
        seg[ct == 0] = 0
        geom = nifti.Geometry(spacing=spacing_zyx[::-1], origin=(1.0, -2.0, 3.0 * i))
        nifti.write_nifti(os.path.join(folder, "imagesTr", f"{prefix}_{i:03d}_0000.nii.gz"),
                          ct, geom)
        nifti.write_nifti(os.path.join(folder, "labelsTr", f"{prefix}_{i:03d}.nii.gz"),
                          seg, geom)
    dataset_json.generate_dataset_json(os.path.join(folder, "dataset.json"),
                                       os.path.join(folder, "imagesTr"), None, ("CT",),
                                       labels, task)
    return folder


def roots_env(mp, root):
    """Point every path root of both packages at `root` (read when called)."""
    mp.setenv("nnUNet_raw_data_base", os.path.join(root, "raw"))
    mp.setenv("nnUNet_preprocessed", os.path.join(root, "prep"))
    mp.setenv("RESULTS_FOLDER", os.path.join(root, "results"))


def same(a, b, swap=None) -> bool:
    """Deep equality of nested dicts, lists, tuples and numpy arrays (exact,
    dtypes and key order included); strings compared with `swap` = (port
    root, jax root) replaced."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k], swap) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(u, v, swap) for u, v in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return (type(a) is type(b) and a.shape == b.shape and a.dtype == b.dtype
                and np.array_equal(a, b, equal_nan=a.dtype.kind == "f"))
    if isinstance(a, str) and swap is not None:
        a = a.replace(*swap)
    if isinstance(a, float) and np.isnan(a):
        return type(b) is type(a) and np.isnan(b)
    return type(a) is type(b) and a == b


def run_both(roots, argv_of):
    """Each package's plan_and_preprocess in its own root."""
    with pytest.MonkeyPatch.context() as mp:
        for name, cli in PACKAGES.items():
            roots_env(mp, roots[name])
            cli.main(argv_of(name))


@pytest.fixture(scope="module")
def planned(tmp_path_factory):
    """Both packages' plan_and_preprocess of one raw task: 3D v21 + 2D v21
    preprocessed (2 fullres, 1 lowres threads), the resenc plans, the
    MultiTalent plans preprocessed, and the pretrained transplant of the
    latter's plans."""
    base = tmp_path_factory.mktemp("planning")
    roots = {name: str(base / name) for name in PACKAGES}
    write_raw_task(os.path.join(roots["jax"], "raw"), TASK, LABELS, ((1, 0.45), (2, 0.15)),
                   6, seed=3)
    shutil.copytree(os.path.join(roots["jax"], "raw"), os.path.join(roots["port"], "raw"))
    run_both(roots, lambda _: ["-t", "3", "--verify_dataset_integrity", "-pl2d",
                               "ExperimentPlanner2D_v21", "-tl", "1", "-tf", "2"])
    run_both(roots, lambda _: ["-t", "3", "-pl3d", "ExperimentPlanner3DFabiansResUNet_v21",
                               "-no_pp"])
    run_both(roots, lambda _: ["-t", TASK, "-pl3d", "ExperimentPlanner3D_v21_MultiTalent",
                               "-tf", "2"])
    run_both(roots, lambda name: [
        "-t", "3", "-pl3d", "ExperimentPlanner3D_v21_Pretrained", "-no_pp",
        "-overwrite_plans", os.path.join(roots[name], "prep", TASK,
                                         "MultiTalent_bs4_plans_3D.pkl"),
        "-overwrite_plans_identifier", "MT"])
    return roots


def _folders(roots, *parts):
    return {name: os.path.join(root, *parts) for name, root in roots.items()}


def _swap(roots):
    return (roots["port"], roots["jax"])


@pytest.mark.parametrize("fault", ["none", "missing_label", "shape_mismatch", "bad_label"])
def test_integrity_verdicts_match(tmp_path, fault):
    """verify_dataset_integrity of both packages on a good raw task and on
    three broken copies: the same verdict and message."""
    folder = write_raw_task(str(tmp_path), TASK, LABELS, ((1, 0.45), (2, 0.15)), 5, seed=1)
    label = os.path.join(folder, "labelsTr", "case_002.nii.gz")
    if fault == "missing_label":
        os.remove(label)
    elif fault in ("shape_mismatch", "bad_label"):
        seg, geom = jnifti.read_nifti(label)
        seg = seg[1:] if fault == "shape_mismatch" else np.where(seg == 2, 5, seg)
        jnifti.write_nifti(label, seg.astype(np.uint8), geom)
    verdicts = []
    for module in (jsc, psc):
        try:
            module.verify_dataset_integrity(folder)
            verdicts.append(None)
        except AssertionError as e:
            verdicts.append(str(e))
    assert verdicts[0] == verdicts[1]
    assert (verdicts[0] is None) == (fault == "none"), verdicts


def test_dataset_json_matches(tmp_path):
    """generate_dataset_json of both packages over the same imagesTr."""
    folder = write_raw_task(str(tmp_path), TASK, LABELS, ((1, 0.45),), 2, seed=2)
    out = {}
    for name, module in (("jax", jdj), ("port", pdj)):
        out[name] = str(tmp_path / f"{name}.json")
        module.generate_dataset_json(out[name], os.path.join(folder, "imagesTr"),
                                     os.path.join(folder, "imagesTs"), ("CT",), LABELS,
                                     TASK, dataset_description="d")
    assert open(out["jax"]).read() == open(out["port"]).read()


def test_cropped_cases_and_fingerprint_match(planned):
    """Cropped .npz (bit for bit) and .pkl of every case, gt_segmentations,
    intensityproperties.pkl and dataset_properties.pkl."""
    cropped = _folders(planned, "raw", "nnUNet_cropped_data", TASK)
    names = sorted(os.listdir(cropped["jax"]))
    assert names == sorted(os.listdir(cropped["port"]))
    cases = [n[:-4] for n in names if n.endswith(".npz")]
    assert len(cases) == 6
    for case in cases:
        a, b = (np.load(os.path.join(f, case + ".npz"))["data"] for f in cropped.values())
        assert same(a, b), case
        assert a.shape[2] < int(round(EXTENT_MM[1] / XY_SPACINGS[int(case[-3:])]))  # cropped
    for name in [n for n in names if n.endswith(".pkl")]:
        a, b = (load_pickle(os.path.join(f, name)) for f in cropped.values())
        assert same(b, a, _swap(planned)), name
    for name in os.listdir(os.path.join(cropped["jax"], "gt_segmentations")):
        a, b = (open(os.path.join(f, "gt_segmentations", name), "rb").read()
                for f in cropped.values())
        assert a == b, name
    props = load_pickle(os.path.join(cropped["port"], "dataset_properties.pkl"))
    assert props["all_classes"] == [1, 2] and len(props["all_sizes"]) == 6


@pytest.mark.parametrize("plans_file", sorted(PLANS_FILES))
def test_plans_match(planned, plans_file):
    """Each planner's plans pickle: every key, numpy dtypes and the order of
    plans_per_stage included."""
    prep = _folders(planned, "prep", TASK)
    jplans, pplans = (load_pickle(os.path.join(f, plans_file)) for f in prep.values())
    assert same(pplans, jplans, _swap(planned)), plans_file
    assert pplans["data_identifier"] == PLANS_FILES[plans_file][0]
    assert list(pplans["plans_per_stage"]) == list(range(pplans["num_stages"]))
    if plans_file.startswith("MultiTalent"):
        stage = pplans["plans_per_stage"][0]
        assert stage["batch_size"] == 4 and pplans["base_num_features"] == 30
        np.testing.assert_array_equal(stage["current_spacing"], [1.5, 1.0, 1.0])
    if "pretrained" in plans_file:  # the transplanted topology, this task's classes
        source = load_pickle(os.path.join(prep["port"], "MultiTalent_bs4_plans_3D.pkl"))
        assert same(pplans["plans_per_stage"], source["plans_per_stage"])
        assert pplans["num_classes"] == 2
    # the port's trainer reads the port's plans
    assert load_plans(os.path.join(prep["port"], plans_file)).num_stages == pplans["num_stages"]


@pytest.mark.parametrize("identifier", sorted({i for i, pp in PLANS_FILES.values() if pp}))
def test_preprocessed_stages_match(planned, identifier):
    """Every preprocessed case: its .npz bit for bit, its .pkl (class
    locations included) equal."""
    prep = _folders(planned, "prep", TASK)
    stages = sorted(d for d in os.listdir(prep["jax"]) if d.startswith(identifier + "_stage"))
    assert stages and stages == sorted(
        d for d in os.listdir(prep["port"]) if d.startswith(identifier + "_stage"))
    for stage in stages:
        files = sorted(os.listdir(os.path.join(prep["jax"], stage)))
        assert len(files) == 12 and files == sorted(os.listdir(os.path.join(prep["port"], stage)))
        for f in files:
            a, b = (os.path.join(p, stage, f) for p in prep.values())
            if f.endswith(".npz"):
                assert same(np.load(a)["data"], np.load(b)["data"]), (stage, f)
            else:
                assert same(load_pickle(b), load_pickle(a), _swap(planned)), (stage, f)


def test_planner_names_match_the_jax_registry():
    """resolve_planner knows every name of the JAX registry, for the class
    of the same name, and refuses others; the table imports no trainer."""
    importlib.import_module("multitalent_tpu.planning.multitalent_planner")
    assert sorted(PLANNERS) == JAX_PLANNERS.names()
    for name in JAX_PLANNERS.names():
        assert resolve_planner(name).__name__ == JAX_PLANNERS.get(name).__name__, name
    with pytest.raises(KeyError):
        resolve_planner("NoSuchPlanner")
    code = ("import sys\n"
            "from multitalent_tpu_torch.planning.planners import resolve_planner\n"
            "import multitalent_tpu_torch.cli.plan_and_preprocess\n"
            "resolve_planner('ExperimentPlanner3D_v21_MultiTalent')\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', "
            "'multitalent_tpu') or m.startswith('multitalent_tpu_torch.training')]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_forked_and_thread_pools_agree(planned, tmp_path, monkeypatch):
    """DatasetAnalyzer over 2 workers: forked (CUDA not initialised) and in
    threads (as after CUDA is initialised) write the same
    dataset_properties.pkl, equal to the JAX package's."""
    src = os.path.join(planned["jax"], "raw", "nnUNet_cropped_data", TASK)
    out = {}
    for pool in ("fork", "threads"):
        folder = str(tmp_path / pool)
        shutil.copytree(src, folder)
        with monkeypatch.context() as mp:
            if pool == "threads":
                mp.setattr(torch.cuda, "is_initialized", lambda: True)
            pda.DatasetAnalyzer(folder, overwrite=True, num_processes=2).analyze_dataset()
        out[pool] = load_pickle(os.path.join(folder, "dataset_properties.pkl"))
    assert same(out["fork"], out["threads"])
    assert same(out["fork"], load_pickle(os.path.join(src, "dataset_properties.pkl")))


def test_two_stage_plan_and_preprocessing(planned, tmp_path):
    """A fingerprint of cases 8x larger per axis: the v21 planners of both
    packages add a 3d_lowres stage, with equal plans; run_preprocessing with
    a thread count per stage and with one count (the default for the lowres
    stage) writes equal stages."""
    src = os.path.join(planned["jax"], "raw", "nnUNet_cropped_data", TASK)
    plans = {}
    for name, module, threads in (("jax", jep, (1, 2)), ("port", pep, (1, 2)),
                                  ("port_int", pep, 2)):
        cropped, prep = str(tmp_path / name / "cropped"), str(tmp_path / name / "prep")
        shutil.copytree(src, cropped)
        props = load_pickle(os.path.join(cropped, "dataset_properties.pkl"))
        props["all_sizes"] = [tuple(8 * s for s in size) for size in props["all_sizes"]]
        save_pickle(props, os.path.join(cropped, "dataset_properties.pkl"))
        planner = module.ExperimentPlanner3Dv21(cropped, prep)
        plans[name] = planner.plan_experiment()
        planner.run_preprocessing(threads)
    swap = (str(tmp_path / "port"), str(tmp_path / "jax"))
    assert plans["jax"]["num_stages"] == 2
    assert same(plans["port"], plans["jax"], swap)
    lowres, fullres = (plans["port"]["plans_per_stage"][i]["current_spacing"] for i in (0, 1))
    assert (lowres > fullres).all()
    for stage in ("MTTPUData_plans_v2.1_stage0", "MTTPUData_plans_v2.1_stage1"):
        for name in ("port", "port_int"):
            folder = {n: str(tmp_path / n / "prep" / stage) for n in ("jax", name)}
            files = sorted(os.listdir(folder["jax"]))
            assert len(files) == 12 and files == sorted(os.listdir(folder[name]))
            for f in files:
                a, b = (os.path.join(d, f) for d in folder.values())
                if f.endswith(".npz"):
                    assert same(np.load(a)["data"], np.load(b)["data"]), (stage, f)
                else:
                    assert same(load_pickle(b), load_pickle(a),
                                (str(tmp_path / name), str(tmp_path / "jax"))), (stage, f)


def test_planned_network_matches_jax(planned):
    """The GenericUNet each package builds from its own v21 plans: the JAX
    params carried into the port by the weight bridge give the same fp32
    logits (atol 1e-4, rtol 1e-3) on one seeded input."""
    plans_file = "MTTPUPlansv2.1_plans_3D.pkl"
    jplans = jax_load_plans(os.path.join(planned["jax"], "prep", TASK, plans_file))
    pplans = load_plans(os.path.join(planned["port"], "prep", TASK, plans_file))
    stage = pplans.num_stages - 1
    st = pplans.stage(stage)
    assert pplans.base_num_features == 32 and len(st.pool_op_kernel_sizes) >= 3
    model = jax_build_unet(jplans, stage, deep_supervision=False, dtype=jnp.float32)
    # the smallest input with two voxels an axis at the bottleneck
    shape = tuple(2 * int(np.prod([p[a] for p in st.pool_op_kernel_sizes])) for a in range(3))
    x = np.random.RandomState(0).randn(1, *shape, 1).astype(np.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(0), jnp.zeros_like(x))["params"])
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    net = build_unet_from_plans(pplans, stage, dtype=torch.float32).eval()
    net.load_state_dict(generic_unet_state_dict_from_flax(
        params, num_pool=len(st.pool_op_kernel_sizes)), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    assert got.shape == (1, 3, *shape)
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=1e-4, rtol=1e-3)
