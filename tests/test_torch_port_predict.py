"""The port's inference main path end to end on the CPU, against the JAX
package's, plus the guarantee that the port never loads JAX.

A tiny reference-layout MultiTalent model folder (MultiTalent_trainer_ddp) and
one CT NIfTI go through the port's CLI and through the JAX package's
import_reference_model_folder + predict_from_folder (with MTTPU_SW_EXACT=1,
its fp32 sliding-window mode). Region masks must agree:

- fp32 networks: >= 99.99% of the voxels of every region (only summation
  order differs);
- bf16 networks, as the released checkpoints run: >= 99.9% on average over
  the regions and >= 99.5% in the worst one, and the port must disagree with
  the JAX package less than the JAX package's own bf16 run disagrees with its
  fp32 run. Both round every activation of the random network to bf16 (about
  1% relative error in the logits each), and a random network has many
  logits near 0, where that noise flips the threshold; measured here: worst
  region 99.79%, mean 99.94%. The two packages round at the same points: the
  conv biases are zero, as the reference's He init leaves them, so the one
  place they differ (the port adds the bias in fp32, blocks.py) does not
  enter.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from multitalent_tpu.inference.predict import predict_from_folder as jax_predict_from_folder
from multitalent_tpu.inference.pretrained_models import import_reference_model_folder
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.cli.predict_multitalent import main
from multitalent_tpu_torch.inference.model_restore import save_model_folder
from multitalent_tpu_torch.io import Geometry, Plans, read_nifti, write_nifti
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans

REPO = Path(__file__).resolve().parents[1]
SHAPE = (20, 40, 36)  # z, y, x of the input NIfTI


def _tiny_plans() -> Plans:
    return Plans.from_dict({
        "num_stages": 1, "num_modalities": 1, "modalities": {0: "CT"},
        "normalization_schemes": {0: "CT"}, "num_classes": 47,
        "all_classes": list(range(1, 48)), "base_num_features": 4,
        "use_mask_for_norm": {0: False}, "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "data_identifier": "mtt_data",
        "preprocessor_name": "GenericPreprocessor",
        "dataset_properties": {"intensityproperties": {0: {
            "percentile_00_5": -1000.0, "percentile_99_5": 1500.0,
            "mean": 100.0, "sd": 300.0}}},
        "plans_per_stage": {0: {
            "batch_size": 2, "patch_size": [16, 32, 32],
            "current_spacing": [1.5, 1.0, 1.0], "original_spacing": [1.5, 1.0, 1.0],
            "median_patient_size_in_voxels": list(SHAPE),
            "num_pool_per_axis": [2, 3, 3],
            "pool_op_kernel_sizes": [[2, 2, 2], [2, 2, 2], [1, 2, 2]],
            "conv_kernel_sizes": [[3, 3, 3]] * 4}}})


def _phantom(rng) -> np.ndarray:
    """A smooth CT-like volume: air, a body ellipsoid, a few organ-like
    ellipsoids of other densities, mild noise. Smooth inputs keep the
    networks' 0.5 crossings on thin surfaces, where bf16 rounding may flip."""
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s) for s in SHAPE], indexing="ij")
    vol = np.full(SHAPE, -1000.0)
    vol[(z / 0.9) ** 2 + (y / 0.8) ** 2 + (x / 0.9) ** 2 < 1] = 0.0
    for _ in range(4):
        c = rng.uniform(-0.4, 0.4, 3)
        r = rng.uniform(0.15, 0.35, 3)
        inside = sum(((a - ci) / ri) ** 2 for a, ci, ri in zip((z, y, x), c, r)) < 1
        vol[inside] = rng.uniform(-200, 800)
    return vol + rng.randn(*SHAPE) * 10


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """One set of weights in two model folders (bf16 and fp32 checkpoints),
    one input case, and both packages' predictions for each folder."""
    root = tmp_path_factory.mktemp("port_predict")
    plans = _tiny_plans()
    torch.manual_seed(0)
    sd = build_unet_from_plans(plans, 0, num_classes=47).state_dict()
    sd = {k: v * 0 if k.endswith("conv.bias") else v for k, v in sd.items()}
    (root / "in").mkdir()
    # x/y/z spacing (1.0, 1.0, 1.6): z resamples to the plans' 1.5 and back
    write_nifti(root / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    timings = {}
    mp = pytest.MonkeyPatch()
    mp.setenv("MTTPU_SW_EXACT", "1")
    try:
        for precision, fp16 in (("bf16", True), ("fp32", False)):
            model = str(root / f"model_{precision}")
            save_model_folder(model, plans, [sd], "MultiTalent_trainer_ddp", fp16=fp16)
            timings[precision] = main([
                "-i", str(root / "in"), "-o", str(root / f"port_{precision}"),
                "-m", model, "--device", "cpu"])
            import_reference_model_folder(model, "MultiTalent_trainer_ddp")
            # the JAX import builds its trainer with fp16=True; the sidecar it
            # wrote carries the init arguments, fp16 last
            sidecar = root / f"model_{precision}" / "fold_0" / "model_final_checkpoint.ckpt.pkl"
            meta = load_pickle(sidecar)
            meta["init_args"] = (*meta["init_args"][:8], fp16)
            save_pickle(meta, sidecar)
            jax_predict_from_folder(model, str(root / "in"), str(root / f"jax_{precision}"),
                                    None, multitalent_regions=True)
    finally:
        mp.undo()
    return root, timings


def _region_agreement(root, a: str, b: str) -> np.ndarray:
    agree = []
    for r in REGIONS:
        got, _ = read_nifti(root / a / "individual" / r / "case.nii.gz")
        ref, _ = read_nifti(root / b / "individual" / r / "case.nii.gz")
        agree.append(np.mean(got == ref))
    return np.array(agree)


def test_cli_writes_labelmap_and_every_region(case):
    root, timings = case
    assert [t["case"] for t in timings["bf16"]] == ["case"]
    # tiles of the (21, 40, 36) resampled volume: 2 x 2 x 2, 8 mirror combos
    assert timings["bf16"][0]["forwards"] == 8 * 8
    out = root / "port_bf16"
    seg, _ = read_nifti(out / "case.nii.gz")
    assert seg.shape == SHAPE and set(np.unique(seg)) <= set(range(47))
    assert len(os.listdir(out / "individual")) == len(REGIONS) == 47
    for r in REGIONS:
        mask, _ = read_nifti(out / "individual" / r / "case.nii.gz")
        assert mask.shape == SHAPE and set(np.unique(mask)) <= {0, 1}


@pytest.mark.parametrize("precision,worst,mean", [("fp32", 0.9999, 0.9999),
                                                  ("bf16", 0.995, 0.999)])
def test_cli_output_matches_jax_package(case, precision, worst, mean):
    root, _ = case
    agree = _region_agreement(root, f"port_{precision}", f"jax_{precision}")
    assert agree.min() >= worst and agree.mean() >= mean, (agree.min(), agree.mean())
    got, _ = read_nifti(root / f"port_{precision}" / "case.nii.gz")
    ref, _ = read_nifti(root / f"jax_{precision}" / "case.nii.gz")
    assert np.mean(got == ref) >= worst
    if precision == "bf16":
        # the port is closer to the JAX package than bf16 is to fp32
        own = _region_agreement(root, "jax_bf16", "jax_fp32")
        assert 1 - agree.mean() <= 1 - own.mean(), (agree.mean(), own.mean())


def test_cli_refuses_cuda_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["-i", str(tmp_path), "-o", str(tmp_path / "out"), "-m", str(tmp_path)])


def test_port_and_chip_smoke_import_no_jax():
    """Import every module of the port (the fused conv -> norm route's among
    them), chip_smoke and profile_routes, in a fresh interpreter (this process's conftest has
    loaded jax already), build the MultiTalent label -> region table, and
    confirm the JAX package's modules the port reuses are the jax-free ones."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import multitalent_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke', 'profile_routes']:\n"
        "    importlib.import_module(n)\n"
        "assert len(names) >= 28, names\n"
        "fused = ['multitalent_tpu_torch.ops.fused_unet', 'multitalent_tpu_torch.ops.fused_norm',\n"
        "         'multitalent_tpu_torch.ops.seghead']\n"
        "assert set(fused) <= set(names), names\n"
        "from multitalent_tpu_torch.training.losses import label_region_matrix\n"
        "assert label_region_matrix().shape == (48, 47)\n"
        "reused = ['multitalent_tpu.data.loader', 'multitalent_tpu.data.dataset',\n"
        "          'multitalent_tpu.augment.params', 'multitalent_tpu.tasks.multitalent',\n"
        "          'multitalent_tpu.training.trainer_base', 'multitalent_tpu.plans',\n"
        "          'multitalent_tpu.paths', 'multitalent_tpu.utils.fileops',\n"
        "          'multitalent_tpu.utils.task_names']\n"
        "missing = [m for m in reused if m not in sys.modules]\n"
        "assert not missing, missing\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok', len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("ok")
