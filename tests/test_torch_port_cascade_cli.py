"""The cascade through the port's CLIs on the CPU, end to end, on the tiny
two-stage task of test_torch_port_cascade.py (stage 0 at spacing 2, stage 1
at spacing 1, two classes):

- `cli.train 3d_lowres TrainerV2` (one epoch of one batch): the lowres
  fold's validation, then predict_next_stage writes every case's
  `<case>_segFromPrevStage.npz` at the stage-1 grid;
- `cli.train 3d_cascade_fullres TrainerV2CascadeFullRes` (one epoch of one
  batch) on those: a GenericUNet reading the image and two one-hots, its
  cascade validation; then `-val` validates the saved fold again, to the
  same NIfTIs;
- `cli.predict -m 3d_lowres` on a raw CT volume: the labelmap at the
  volume's shape and geometry;
- a one-stage plan refuses both cascade networks, as the JAX CLI does.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from multitalent_tpu import paths
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.io import Geometry, read_nifti, save_plans, write_nifti
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.training.cascade import TrainerV2CascadeFullRes

from test_torch_port_cascade import FULL, KEYS, MARGIN, two_stage_plans, write_two_stage_task
from test_torch_port_train_slice import port_plans
from test_training import tiny_plans

TASK = "Task003_Liver"


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the CLI runs (many small ops)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def task(tmp_path, monkeypatch):
    pre, results = tmp_path / "pre", tmp_path / "results"
    for k, v in (("nnUNet_preprocessed", pre), ("RESULTS_FOLDER", results),
                 ("MTTPU_MAX_EPOCHS", 1), ("MTTPU_ITERS_PER_EPOCH", 1), ("MTTPU_VAL_ITERS", 1),
                 ("MTTPU_SW_EXACT", 0)):
        monkeypatch.setenv(k, str(v))
    ddir = pre / TASK
    write_two_stage_task(ddir)
    save_plans(port_plans(two_stage_plans()),
               ddir / f"{paths.default_plans_identifier}_plans_3D.pkl")
    return tmp_path, ddir, results / "nnUNet"


def _nifti(folder: Path) -> dict:
    return {f.name: read_nifti(f)[0] for f in sorted(folder.glob("*.nii.gz"))}


def test_lowres_then_cascade_then_val_then_predict(task):
    tmp, ddir, results = task
    lowres = train.main(["3d_lowres", "TrainerV2", TASK, "0", "--device", "cpu"])
    assert lowres.stage == 0 and lowres.batch_dice and lowres.step == 1
    assert [t["case"] for t in lowres.next_stage_timings] == list(KEYS)
    stage1 = ddir / "mtt_data_stage1"
    for key in KEYS:
        prev = np.load(stage1 / f"{key}_segFromPrevStage.npz")["data"]
        assert prev.dtype == np.uint8 and prev.shape == (1, *FULL)
        assert set(np.unique(prev)) <= {0, 1, 2}
    lowres_val = results / "3d_lowres" / TASK / f"TrainerV2__{paths.default_plans_identifier}" \
        / "fold_0" / "validation_raw"
    assert set(_nifti(lowres_val)) == {f"{k}.nii.gz" for k in KEYS[1:]}

    cascade = train.main(["3d_cascade_fullres", "TrainerV2CascadeFullRes", TASK, "0",
                          "--device", "cpu"])
    assert isinstance(cascade, TrainerV2CascadeFullRes)
    assert cascade.stage == 1 and not cascade.batch_dice and cascade.step == 1
    assert isinstance(cascade.network, GenericUNet) and cascade.network.input_channels == 3
    assert np.isfinite(cascade.all_tr_losses + cascade.all_val_losses).all()
    fold = Path(cascade.output_folder)
    val = _nifti(fold / "validation_raw")
    assert set(val) == {f"{k}.nii.gz" for k in KEYS[1:]}
    assert all(v.shape == tuple(f + 2 * m for f, m in zip(FULL, MARGIN)) for v in val.values())
    assert (fold / "validation_raw" / "summary.json").is_file()

    again = train.main(["3d_cascade_fullres", "TrainerV2CascadeFullRes", TASK, "0", "-val",
                        "--val_folder", "validation_again", "--device", "cpu"])
    assert again.step == 1  # restored from the fold's final checkpoint
    again_val = _nifti(fold / "validation_again")
    assert again_val.keys() == val.keys()
    assert all(np.array_equal(again_val[k], val[k]) for k in val)

    (tmp / "in").mkdir()
    shape = (20, 36, 44)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in shape], indexing="ij")
    ct = np.where(zz ** 2 + yy ** 2 + xx ** 2 < 0.5, 2.0, -0.5) * 1.5
    geometry = Geometry(spacing=(1.0, 1.0, 1.0), origin=(3.0, -2.0, 5.0))
    write_nifti(tmp / "in" / "held_0000.nii.gz", ct.astype(np.int16), geometry)
    timings = predict_cli.main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-t", TASK,
                                "-m", "3d_lowres", "-tr", "TrainerV2", "--device", "cpu"])
    assert [t["case"] for t in timings] == ["held"]
    seg, g = read_nifti(tmp / "out" / "held.nii.gz")
    assert seg.shape == shape and set(np.unique(seg)) <= {0, 1, 2}
    assert np.allclose(g.spacing, geometry.spacing) and np.allclose(g.origin, geometry.origin)


@pytest.mark.parametrize("network", ["3d_lowres", "3d_cascade_fullres"])
def test_one_stage_plans_refuse_the_cascade(tmp_path, monkeypatch, network):
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path))
    (tmp_path / TASK).mkdir()
    save_plans(port_plans(tiny_plans()),
               tmp_path / TASK / f"{paths.default_plans_identifier}_plans_3D.pkl")
    with pytest.raises(RuntimeError, match="multi-stage plan"):
        train.get_default_configuration(network, TASK, "TrainerV2CascadeFullRes")
