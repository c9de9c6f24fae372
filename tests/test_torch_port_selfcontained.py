"""The port's own copies of the JAX package's framework-neutral modules
(multitalent_tpu_torch/{plans, paths, preprocessing, io/nifti, data,
inference/segmentation_export, tasks/multitalent, augment/params, ...})
against the originals, on the same inputs: the same files and arrays come
out. (The cascade's host code, training/cascade.py, is held to the JAX
package's in test_torch_port_cascade.py; its trainer names here.)

The port imports nothing of multitalent_tpu (test_torch_port_predict.py's
subprocess check); these cases show that the copies did not drift.
"""
import gzip
import importlib

import numpy as np
import pytest

from multitalent_tpu import paths as jpaths
from multitalent_tpu import plans as jplans
from multitalent_tpu.augment import params as jaug
from multitalent_tpu.data import dataset as jdataset
from multitalent_tpu.data import loader as jloader
from multitalent_tpu.inference import predict as jpredict
from multitalent_tpu.inference import segmentation_export as jexport
from multitalent_tpu.io import nifti as jnifti
from multitalent_tpu.preprocessing import preprocessor as jpre
from multitalent_tpu.registry import PREPROCESSORS
from multitalent_tpu.tasks import multitalent as jtask
from multitalent_tpu_torch import paths as ppaths
from multitalent_tpu_torch import plans as pplans
from multitalent_tpu_torch.augment import params as paug
from multitalent_tpu_torch.data import dataset as pdataset
from multitalent_tpu_torch.data import loader as ploader
from multitalent_tpu_torch.inference import predict as ppredict
from multitalent_tpu_torch.inference import segmentation_export as pexport
from multitalent_tpu_torch.io import nifti as pnifti
from multitalent_tpu_torch.preprocessing import preprocessor as ppre
from multitalent_tpu_torch.tasks import multitalent as ptask

from test_training import make_preprocessed

CASE_SHAPE = (14, 30, 26)          # z, y, x of the synthetic CT
CASE_SPACING_XYZ = (0.9, 0.8, 2.5)  # anisotropic: the separate-z resampling path
TARGET_SPACING = (1.5, 1.0, 1.0)


def _same(a, b) -> bool:
    """Deep equality of nested dicts, lists, tuples and numpy arrays (exact)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same(u, v) for u, v in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)
    return type(a) is type(b) and a == b


def _plans_dict() -> dict:
    return {
        "num_stages": 1, "num_modalities": 1, "modalities": {0: "CT"},
        "normalization_schemes": {0: "CT"}, "num_classes": 47,
        "all_classes": list(range(1, 48)), "base_num_features": 30,
        "use_mask_for_norm": {0: False}, "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "data_identifier": "nnUNetData_plans_v2.1",
        "preprocessor_name": "GenericPreprocessor",
        "dataset_properties": {"intensityproperties": {0: {
            "percentile_00_5": -1000.0, "percentile_99_5": 1500.0, "mean": 100.0,
            "sd": 300.0}}},
        "plans_per_stage": {0: {
            "batch_size": 2, "patch_size": np.array([96, 192, 192]),
            "current_spacing": np.array([1.5, 1.0, 1.0]),
            "original_spacing": np.array([1.5, 1.0, 1.0]),
            "median_patient_size_in_voxels": np.array([128, 256, 256]),
            "num_pool_per_axis": [4, 5, 5],
            "pool_op_kernel_sizes": [[2, 2, 2]] * 4 + [[1, 2, 2]],
            "conv_kernel_sizes": [[3, 3, 3]] * 6}}}


def _write_case(folder, nifti) -> list[str]:
    rng = np.random.default_rng(11)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, n) for n in CASE_SHAPE], indexing="ij")
    body = (zz ** 2 + yy ** 2 + xx ** 2) < 0.7
    ct = np.where(body, 40.0, -1000.0) + rng.standard_normal(CASE_SHAPE) * 30
    path = str(folder / "case_0000.nii.gz")
    nifti.write_nifti(path, ct.astype(np.int16),
                      nifti.Geometry(spacing=CASE_SPACING_XYZ, origin=(3.0, -2.0, 7.5)))
    return [path]


def _preprocess(pre_module, files):
    d = _plans_dict()
    pre = pre_module.GenericPreprocessor(
        d["normalization_schemes"], d["use_mask_for_norm"], d["transpose_forward"],
        d["dataset_properties"]["intensityproperties"])
    return pre.preprocess_test_case(files, TARGET_SPACING)


def case_plans_cross_load(tmp_path):
    """Plans saved by one package load equal in the other, as identical files."""
    d = _plans_dict()
    jplans.save_plans(jplans.Plans.from_dict(d), tmp_path / "jax.pkl")
    pplans.save_plans(pplans.Plans.from_dict(d), tmp_path / "port.pkl")
    assert (tmp_path / "jax.pkl").read_bytes() == (tmp_path / "port.pkl").read_bytes()
    for f in ("jax.pkl", "port.pkl"):
        assert _same(jplans.load_plans(tmp_path / f).to_dict(),
                     pplans.load_plans(tmp_path / f).to_dict())


def case_preprocess_test_case(tmp_path):
    """GenericPreprocessor.preprocess_test_case on a seeded synthetic NIfTI:
    bit-equal data, segmentation and properties."""
    files = _write_case(tmp_path, jnifti)
    jd, js, jp = _preprocess(jpre, files)
    pd, ps, pp = _preprocess(ppre, files)
    assert jd.shape[1:] != CASE_SHAPE  # resampled
    assert _same(jd, pd) and _same(js, ps) and _same(jp, pp)


def case_nifti_round_trip(tmp_path):
    """A volume written by each package reads back equal in both, with the
    same decompressed bytes."""
    vol = np.random.default_rng(4).integers(-1000, 2000, CASE_SHAPE).astype(np.int16)
    geom = jnifti.Geometry(spacing=CASE_SPACING_XYZ, origin=(1.0, 2.0, 3.0))
    jnifti.write_nifti(str(tmp_path / "j.nii.gz"), vol, geom)
    pnifti.write_nifti(str(tmp_path / "p.nii.gz"), vol,
                       pnifti.Geometry(spacing=CASE_SPACING_XYZ, origin=(1.0, 2.0, 3.0)))
    assert (gzip.decompress((tmp_path / "j.nii.gz").read_bytes())
            == gzip.decompress((tmp_path / "p.nii.gz").read_bytes()))
    for f in ("j.nii.gz", "p.nii.gz"):
        (a, ga), (b, gb) = jnifti.read_nifti(str(tmp_path / f)), pnifti.read_nifti(str(tmp_path / f))
        assert _same(a, b) and _same(vars(ga), vars(gb))


def case_save_segmentation_nifti(tmp_path):
    """save_segmentation_nifti and save_segmentation_nifti_from_softmax of
    the same arrays write the same volumes and headers."""
    files = _write_case(tmp_path, jnifti)
    data, _, props = _preprocess(jpre, files)
    rng = np.random.default_rng(5)
    seg = rng.integers(0, 4, data.shape[1:]).astype(np.uint8)
    probs = rng.random((3, *data.shape[1:])).astype(np.float32)
    for name, call in (
            ("seg", lambda m, out: m.save_segmentation_nifti(seg, out, props)),
            ("softmax", lambda m, out: m.save_segmentation_nifti_from_softmax(
                probs, out, props, 1, region_class_order=(1, 2, 3)))):
        call(jexport, str(tmp_path / f"{name}_jax.nii.gz"))
        call(pexport, str(tmp_path / f"{name}_port.nii.gz"))
        assert (gzip.decompress((tmp_path / f"{name}_jax.nii.gz").read_bytes())
                == gzip.decompress((tmp_path / f"{name}_port.nii.gz").read_bytes())), name


def case_patch_sampler(tmp_path):
    """PatchSampler3D with the same seed over the same preprocessed folder
    gives the same batches."""
    make_preprocessed(tmp_path, n_cases=4, shape=(14, 16, 18))
    folder = str(tmp_path / "mtt_data_stage0")
    jd, pd = jdataset.load_dataset(folder), pdataset.load_dataset(folder)
    assert _same({k: sorted(v) for k, v in jd.items()}, {k: sorted(v) for k, v in pd.items()})
    kw = dict(oversample_foreground_percent=0.33, pad_mode="constant", seed=5)
    js = jloader.PatchSampler3D(jd, (16, 18, 20), (12, 12, 12), 3, **kw)
    ps = ploader.PatchSampler3D(pd, (16, 18, 20), (12, 12, 12), 3, **kw)
    for _ in range(3):
        a, b = js.generate_train_batch(), ps.generate_train_batch()
        assert _same(a, b)
    assert _same(jdataset.kfold_split(sorted(jd)), pdataset.kfold_split(sorted(pd)))


def case_region_tables(tmp_path):
    """The MultiTalent region tables and the splits / sampling helpers."""
    for name in ("REGIONS", "REGION_OUTPUT_IDX", "NUM_GLOBAL_LABELS", "NUM_REGIONS"):
        assert _same(getattr(jtask, name), getattr(ptask, name)), name
    keys = [f"{p}_{i:03d}" for p in ("003", "009", "017") for i in range(7)]
    ids = [f"{i:03d}" for i in range(7)]
    per_task = {t: [{"train": [c for c in ids if int(c) % 5 != f],
                     "val": [c for c in ids if int(c) % 5 == f]} for f in range(5)]
                for t in (3, 9, 17)}
    assert _same(jtask.build_custom_splits(keys, per_task),
                 ptask.build_custom_splits(keys, per_task))
    valid = [("03_liver", "03_cancer"), ("09_spleen",)]
    assert _same(jtask.valid_region_mask(valid), ptask.valid_region_mask(valid))
    assert _same(jtask.inverse_sqrt_sampling_probabilities(keys),
                 ptask.inverse_sqrt_sampling_probabilities(keys))


def case_preprocessor_names(tmp_path):
    """Every preprocessor name the JAX registry resolves (aliases included)
    resolves in the port to the class of the same name."""
    importlib.import_module("multitalent_tpu.preprocessing.preprocessor")
    names = PREPROCESSORS.names()
    assert "PreprocessorFor3D_NoResampling" in names
    for name in names:
        assert ppre.resolve_preprocessor(name).__name__ == PREPROCESSORS.get(name).__name__
    with pytest.raises(KeyError):
        ppre.resolve_preprocessor("NoSuchPreprocessor")


def case_paths_and_augmentation(tmp_path):
    """Path defaults, the anisotropy threshold, augmentation defaults and the
    enlarged patch size."""
    from multitalent_tpu.configuration import RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
    assert ppaths.RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD == RESAMPLING_SEPARATE_Z_ANISO_THRESHOLD
    assert ppaths.default_plans_identifier == jpaths.default_plans_identifier
    assert _same(paug.default_3D_augmentation_params, jaug.default_3D_augmentation_params)
    assert _same(paug.default_2D_augmentation_params, jaug.default_2D_augmentation_params)
    for args in (((96, 192, 192), 0.5236, 0.5236, 0.5236, (0.7, 1.4)),
                 ((40, 56, 40), 0.26, 0.0, 0.1, (0.85, 1.25))):
        assert _same(paug.get_patch_size(*args), jaug.get_patch_size(*args))


def case_input_folder_discovery(tmp_path):
    """Case discovery by the _XXXX.nii.gz convention, and its refusals."""
    for name in ("b_0000.nii.gz", "b_0001.nii.gz", "a_0000.nii.gz", "a_0001.nii.gz"):
        (tmp_path / name).write_bytes(b"")
    assert (ppredict.check_input_folder_and_return_caseIDs(str(tmp_path), 2)
            == jpredict.check_input_folder_and_return_caseIDs(str(tmp_path), 2))
    (tmp_path / "c_0000.nii.gz").write_bytes(b"")
    for fn in (jpredict.check_input_folder_and_return_caseIDs,
               ppredict.check_input_folder_and_return_caseIDs):
        with pytest.raises(AssertionError):
            fn(str(tmp_path), 2)


def case_planning_topology(tmp_path):
    """planning/net_topology.py: the constants, both pooling schedules and
    both memory proxies on isotropic, anisotropic and 2D inputs; and the
    thread default the planners read."""
    from multitalent_tpu.configuration import default_num_threads
    from multitalent_tpu.planning import net_topology as jnt
    from multitalent_tpu_torch.planning import net_topology as pnt
    assert ppaths.default_num_threads == default_num_threads
    for name in ("BASE_NUM_FEATURES", "MEMORY_BUDGET_3D", "MEMORY_BUDGET_2D",
                 "RESENC_BUDGET_3D", "RESENC_BLOCKS_ENCODER", "RESENC_BLOCKS_DECODER"):
        assert _same(getattr(jnt, name), getattr(pnt, name)), name
    for spacing, patch in (((1.0, 0.8, 0.8), (128, 128, 128)), ((5.0, 0.7, 0.7), (24, 256, 256)),
                           ((0.8, 0.8), (320, 256))):
        args = (spacing, list(patch), 4, 999)
        jtopo, ptopo = jnt.get_pool_and_conv_props(*args), pnt.get_pool_and_conv_props(*args)
        assert _same(list(jtopo), list(ptopo))
        late = (list(patch), 4, 999, spacing)
        assert _same(list(jnt.get_pool_and_conv_props_poolLateV2(*late)),
                     list(pnt.get_pool_and_conv_props_poolLateV2(*late)))
        npool, pools = ptopo[0], ptopo[1]
        assert (jnt.compute_memory_proxy(ptopo[3], npool, 32, 320, 1, 3, pools, True)
                == pnt.compute_memory_proxy(ptopo[3], npool, 32, 320, 1, 3, pools, True))
        if len(patch) == 3:
            res = ([[1, 1, 1]] + pools, 32, 320, 1, 3)
            blocks = (pnt.RESENC_BLOCKS_ENCODER, pnt.RESENC_BLOCKS_DECODER, 2, 2)
            assert (jnt.compute_resenc_memory_proxy(ptopo[3], *res[1:], res[0], *blocks)
                    == pnt.compute_resenc_memory_proxy(ptopo[3], *res[1:], res[0], *blocks))


def case_task_name_resolution(tmp_path):
    """resolve_task_name (cli/configuration.py): a task name passes, an id
    finds its folder among the preprocessed tasks."""
    from multitalent_tpu.cli.configuration import resolve_task_name as jresolve
    from multitalent_tpu_torch.cli.configuration import resolve_task_name as presolve
    (tmp_path / "Task003_Liver").mkdir()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("nnUNet_preprocessed", str(tmp_path))
        for task in ("Task003_Liver", "3", "003"):
            assert presolve(task) == jresolve(task) == "Task003_Liver"


def case_cascade_and_mednext_trainer_names(tmp_path):
    """Every name the JAX registry gives the cascade's trainers and the
    MedNeXt trainer resolves in the port's train CLI to the class of the
    same name, and each cascade variant sets the JAX variant's augmentation
    parameters over its base's."""
    from multitalent_tpu.registry import TRAINERS as JTRAINERS
    from multitalent_tpu.training import cascade as jcascade
    from multitalent_tpu.training.multitalent import MultiTalentTrainerMedNeXt
    from multitalent_tpu_torch.cli.train import TRAINERS as PTRAINERS
    from multitalent_tpu_torch.training import cascade as pcascade
    classes = {JTRAINERS.get(n) for n in JTRAINERS.names()}
    classes = {c for c in classes if c.__module__ == jcascade.__name__} | {
        MultiTalentTrainerMedNeXt}
    names = [n for n in JTRAINERS.names() if JTRAINERS.get(n) in classes]
    assert len(classes) == 10 and len(names) == 22
    for n in names:
        assert PTRAINERS[n].__name__ == JTRAINERS.get(n).__name__, n
    with pytest.MonkeyPatch.context() as mp:
        for module in (jcascade, pcascade):
            mp.setattr(module.TrainerV2CascadeFullRes, "setup_DA_params",
                       lambda self: setattr(self, "data_aug_params", {"base": 1}))
        for cls in classes - {MultiTalentTrainerMedNeXt}:
            jt, pt = object.__new__(cls), object.__new__(getattr(pcascade, cls.__name__))
            jt.setup_DA_params()
            pt.setup_DA_params()
            assert _same(jt.data_aug_params, pt.data_aug_params), cls.__name__


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_copy_matches_the_jax_module(name, tmp_path):
    CASES[name](tmp_path)
