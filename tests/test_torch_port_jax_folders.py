"""Model folders in the JAX package's layout (`fold_X/<name>.ckpt` flax
msgpack + `.ckpt.pkl` sidecar), read by the port without flax or the JAX
package.

- The JAX package's import of a reference folder writes a `.ckpt` and a
  sidecar whose init_args[0] is a pickled `multitalent_tpu.plans.Plans`.
  With the `.model` files and plans.pkl taken away, the port's predict CLI
  must predict from it: the same masks as from the `.model` folder of the
  same weights, and the JAX package's `predict_from_folder` masks at
  test_cli_output_matches_jax_package's fp32 tolerance (>= 99.99% of the
  voxels of every region).
- Restoring that sidecar in a fresh interpreter loads no module of
  multitalent_tpu, jax or flax; the sidecar unpickler refuses names off its
  allow-list.
- `save_jax_model_folder` writes a folder the JAX package restores.
"""
import os
import pickle
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from multitalent_tpu.inference.model_restore import (
    load_model_and_checkpoint_files as jax_load_model)
from multitalent_tpu.inference.predict import predict_from_folder as jax_predict_from_folder
from multitalent_tpu.inference.pretrained_models import import_reference_model_folder
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.cli.predict_multitalent import main
from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                           load_sidecar, save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans

from test_torch_port_predict import REPO, _phantom, _tiny_plans

CKPT = "model_final_checkpoint.ckpt"


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """One set of fp32 weights as a reference-layout folder (`ref`), the JAX
    package's import of it, moved to a folder with nothing else (`jax`),
    one input case, and the JAX package's prediction from its import (no
    mirror TTA, here and in the port's runs)."""
    root = tmp_path_factory.mktemp("jax_folders")
    plans = _tiny_plans()
    torch.manual_seed(1)
    sd = build_unet_from_plans(plans, 0, num_classes=47).state_dict()
    sd = {k: v * 0 if k.endswith("conv.bias") else v for k, v in sd.items()}
    (root / "in").mkdir()
    write_nifti(root / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(2)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    ref = root / "ref"
    save_model_folder(str(ref), plans, [sd], "MultiTalent_trainer_ddp", fp16=False)
    import_reference_model_folder(str(ref), "MultiTalent_trainer_ddp")
    sidecar = ref / "fold_0" / (CKPT + ".pkl")
    meta = load_pickle(sidecar)
    meta["init_args"] = (*meta["init_args"][:8], False)  # the JAX import writes fp16=True
    save_pickle(meta, sidecar)
    mp = pytest.MonkeyPatch()
    mp.setenv("MTTPU_SW_EXACT", "1")
    try:
        jax_predict_from_folder(str(ref), str(root / "in"), str(root / "jax_out"), None,
                                tta=False, multitalent_regions=True)
    finally:
        mp.undo()
    (root / "jax" / "fold_0").mkdir(parents=True)
    for name in (CKPT, CKPT + ".pkl"):
        shutil.copy(ref / "fold_0" / name, root / "jax" / "fold_0" / name)
    return root, sd


def _masks(folder):
    return [read_nifti(folder / "individual" / r / "case.nii.gz")[0] for r in REGIONS]


def test_the_sidecar_pickles_the_jax_plans(folders):
    root, _ = folders
    with open(root / "jax" / "fold_0" / (CKPT + ".pkl"), "rb") as f:
        raw = f.read()
    assert b"multitalent_tpu.plans" in raw and b"Plans" in raw
    meta = load_sidecar(str(root / "jax" / "fold_0" / (CKPT + ".pkl")))
    from multitalent_tpu_torch.plans import Plans
    assert type(meta["init_args"][0]) is Plans and meta["init_args"][0].base_num_features == 4


def test_predict_cli_reads_a_jax_layout_folder(folders, monkeypatch):
    root, sd = folders
    monkeypatch.setenv("MTTPU_SW_EXACT", "1")  # the JAX prediction's mode
    restored = load_model_and_checkpoint_files(str(root / "jax"), None, device="cpu")
    assert restored.inference_nonlin == "sigmoid" and restored.trainer_name == "MultiTalentTrainer"
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k].float(), sd[k]) for k in got)
    for name in ("jax", "ref"):
        main(["-i", str(root / "in"), "-o", str(root / f"port_{name}"), "-m", str(root / name),
              "--device", "cpu", "--disable_tta"])
    seg, _ = read_nifti(root / "port_jax" / "case.nii.gz")
    ref_seg, _ = read_nifti(root / "port_ref" / "case.nii.gz")
    assert np.array_equal(seg, ref_seg)
    assert all(np.array_equal(a, b) for a, b in zip(_masks(root / "port_jax"),
                                                    _masks(root / "port_ref")))


def test_jax_layout_prediction_matches_the_jax_package(folders, monkeypatch):
    root, _ = folders
    monkeypatch.setenv("MTTPU_SW_EXACT", "1")  # the JAX prediction's mode
    if not (root / "port_jax").is_dir():
        main(["-i", str(root / "in"), "-o", str(root / "port_jax"), "-m", str(root / "jax"),
              "--device", "cpu", "--disable_tta"])
    agree = np.array([np.mean(a == b) for a, b in zip(_masks(root / "port_jax"),
                                                      _masks(root / "jax_out"))])
    assert agree.min() >= 0.9999, agree.min()
    got, _ = read_nifti(root / "port_jax" / "case.nii.gz")
    ref, _ = read_nifti(root / "jax_out" / "case.nii.gz")
    assert np.mean(got == ref) >= 0.9999


def test_restoring_a_jax_sidecar_loads_no_jax_module(folders):
    """In a fresh interpreter (this one has jax and the JAX package loaded)."""
    root, _ = folders
    code = (
        "import sys\n"
        "from multitalent_tpu_torch.inference.model_restore import (\n"
        "    load_model_and_checkpoint_files, load_sidecar)\n"
        f"meta = load_sidecar({str(root / 'jax' / 'fold_0' / (CKPT + '.pkl'))!r})\n"
        "assert type(meta['init_args'][0]).__module__ == 'multitalent_tpu_torch.plans'\n"
        f"r = load_model_and_checkpoint_files({str(root / 'jax')!r}, None, device='cpu')\n"
        "assert r.num_classes == 47 and len(r.networks) == 1\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'msgpack',\n"
        "                                    'multitalent_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.startswith("ok"), proc.stdout + proc.stderr


class _RunsACommand:
    def __reduce__(self):
        return os.system, ("true",)


@pytest.mark.parametrize("payload", [_RunsACommand(), JaxTrainerV2],
                         ids=["os.system", "a JAX trainer class"])
def test_sidecar_unpickler_refuses_other_names(tmp_path, payload):
    """A name off the allow-list, of the standard library or of the JAX
    package, is refused before anything is imported or called."""
    path = tmp_path / "x.ckpt.pkl"
    path.write_bytes(pickle.dumps({"init_args": (payload,)}))
    with pytest.raises(pickle.UnpicklingError, match="allow-list"):
        load_sidecar(str(path))


def test_missing_plans_name_both_places(folders, tmp_path):
    root, _ = folders
    model = tmp_path / "m"
    (model / "fold_0").mkdir(parents=True)
    shutil.copy(root / "jax" / "fold_0" / CKPT, model / "fold_0" / CKPT)
    meta = load_pickle(root / "ref" / "fold_0" / (CKPT + ".pkl"))
    meta["init_args"] = (str(tmp_path / "gone.pkl"), *meta["init_args"][1:])
    save_pickle(meta, model / "fold_0" / (CKPT + ".pkl"))
    with pytest.raises(FileNotFoundError, match="gone.pkl.*plans.pkl"):
        load_model_and_checkpoint_files(str(model), None, device="cpu")


def test_written_jax_folder_restores_in_the_jax_package(folders, tmp_path):
    """The port's writer (flax_ckpt.dumps of the state dict through
    io/torch_convert.py) gives a folder the JAX package restores, with the
    same weights; the port reads it back the same."""
    _, sd = folders
    plans = _tiny_plans()
    save_jax_model_folder(str(tmp_path / "w"), plans, [sd], "MultiTalentTrainer",
                          trainer_bases=["TrainerV2"], fp16=False)
    trainer, params = jax_load_model(str(tmp_path / "w"))
    assert type(trainer).__name__ == "MultiTalentTrainer"
    back = generic_unet_state_dict_from_flax(jax.device_get(params[0]), num_pool=3)
    assert all(torch.equal(back[k], sd[k]) for k in back)
    restored = load_model_and_checkpoint_files(str(tmp_path / "w"), None, device="cpu")
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in got)
