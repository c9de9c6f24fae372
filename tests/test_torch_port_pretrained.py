"""The port's pretrained-model tools (inference/pretrained_models.py and the
CLIs download_pretrained, export_model, print_pretrained_info,
change_trainer) held to the JAX package's on the same inputs:

- the 27-entry table and what `list` and print_pretrained_info print;
- `install_zip` of a synthetic released Task100 tree (no 3d_fullres level,
  old trainer folder names, stale sidecar names) gives the JAX package's
  installed tree, file for file and byte for byte; `download` installs the
  same through a replaced `urlretrieve` (nothing reaches the network);
- `export_model` writes the JAX package's zip; installed, it restores and
  predicts on the CPU as the JAX package predicts from its own import;
- `import_torch` writes the JAX function's `.ckpt` bytes, and each package
  restores the other's folder with the same weights;
- `change_trainer`: the JAX CLI writes `trainer_name` into a reference
  `.model.pkl`, which restore never reads; the port's sets `name` there.
"""
import os
import pickle
import shutil
import zipfile

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from multitalent_tpu.cli import change_trainer as jax_change_trainer
from multitalent_tpu.cli import export_model as jax_export_model
from multitalent_tpu.inference import pretrained_models as jpm
from multitalent_tpu.inference.model_restore import (
    load_model_and_checkpoint_files as jax_load_model)
from multitalent_tpu.inference.predict import predict_from_folder as jax_predict_from_folder
from multitalent_tpu.io.torch_convert import convert_fabians_unet_state_dict
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import load_pickle, save_pickle
from multitalent_tpu_torch.cli import change_trainer, download_pretrained, export_model
from multitalent_tpu_torch.cli import print_pretrained_info
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference import pretrained_models as ppm
from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                           read_model_folder, save_model_folder)
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.io import flax_ckpt
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import (convert_resenc_state_dict,
                                                   fabians_unet_state_dict)
from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans

from test_torch_port_predict import _phantom, _tiny_plans
from test_torch_port_resenc import CONV_BIASES, NBD, NBE, POOLS, port_net

TASK = "Task100_MultiTalent"
PLANS_ID = "MTTPUPlansv2.1"
TRAINER = "MultiTalent_trainer_ddp"
CASCADE = "TrainerV2CascadeFullRes"  # the export's default cascade trainer
CKPT = "model_final_checkpoint"
# the released zip's trainer folders (old and misspelt names) and what the
# fixups rename them to
RELEASED = {"MultiTalent_trainer": "MultiTalent_trainer_ddp",
            "MultiTalent_tainer_resenc_ddp": "MultiTalent_trainer_resenc_ddp_2000ep",
            "MultiTalent_trainer_resenc": "MultiTalent_trainer_resenc_ddp"}


def _tree(root) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _weights(seed: int = 1) -> dict:
    torch.manual_seed(seed)
    sd = build_unet_from_plans(_tiny_plans(), 0, num_classes=47).state_dict()
    return {k: v * 0 if k.endswith("conv.bias") else v for k, v in sd.items()}


@pytest.fixture(scope="module")
def released_zip(tmp_path_factory):
    """A zip in the released Task100 layout: Task100_MultiTalent/<trainer
    folder>/fold_0/{.model, .model.pkl}, plans.pkl, no 3d_fullres level, each
    sidecar naming the folder's old trainer."""
    root = tmp_path_factory.mktemp("released")
    rng = np.random.RandomState(0)
    zpath = root / "Task100_MultiTalent.zip"
    with zipfile.ZipFile(zpath, "w") as z:
        for i, old in enumerate(RELEASED):
            base = f"{TASK}/{old}__MultiTalent_plans_{i}"
            z.writestr(f"{base}/plans.pkl", pickle.dumps({"plans": i}))
            z.writestr(f"{base}/fold_0/{CKPT}.model", rng.bytes(64))
            z.writestr(f"{base}/fold_0/{CKPT}.model.pkl",
                       pickle.dumps({"name": old, "init": ("plans.pkl", 0)}))
    return zpath


@pytest.fixture(scope="module")
def jax_installed(released_zip, tmp_path_factory):
    results = tmp_path_factory.mktemp("jax_results")
    mp = pytest.MonkeyPatch()
    mp.setenv("RESULTS_FOLDER", str(results))
    try:
        jpm.install_model_from_zip_file(str(released_zip))
    finally:
        mp.undo()
    return _tree(results)


def test_the_table_and_its_printouts_are_the_jax_package_s(capsys):
    assert ppm.AVAILABLE_MODELS == jpm.AVAILABLE_MODELS
    assert len(ppm.AVAILABLE_MODELS) == 27
    jpm.print_available_pretrained_models()
    want = capsys.readouterr().out
    download_pretrained.main(["list"])
    assert capsys.readouterr().out == want
    print_pretrained_info.main([TASK])
    assert capsys.readouterr().out == jpm.AVAILABLE_MODELS[TASK]["description"] + "\n"
    with pytest.raises(RuntimeError, match="Invalid task name"):
        print_pretrained_info.main(["Task999_Nothing"])


def test_released_zip_installs_as_the_jax_package_installs(released_zip, jax_installed,
                                                          tmp_path, monkeypatch):
    monkeypatch.setenv("RESULTS_FOLDER", str(tmp_path))
    download_pretrained.main(["install_zip", str(released_zip)])
    got = _tree(tmp_path)
    assert got == jax_installed
    # the fixups' result: the 3d_fullres level, the new names, the sidecars
    task_dir = tmp_path / "nnUNet" / "3d_fullres" / TASK
    assert not (tmp_path / "nnUNet" / TASK).exists()
    assert sorted(d.split("__")[0] for d in os.listdir(task_dir)) == sorted(RELEASED.values())
    for d in os.listdir(task_dir):
        meta = load_pickle(task_dir / d / "fold_0" / f"{CKPT}.model.pkl")
        assert meta["name"] == d.split("__")[0]


def test_download_installs_a_local_copy(released_zip, jax_installed, tmp_path, monkeypatch):
    """The fetch of `download` with urlretrieve replaced by a copy of the
    released zip: the installed tree is the JAX package's, the zip is
    removed; a failed fetch names install_zip; an unknown name raises."""
    import urllib.request
    fetched = []

    def fake_urlretrieve(url, target):
        fetched.append(url)
        shutil.copy(released_zip, target)

    monkeypatch.setenv("RESULTS_FOLDER", str(tmp_path / "r"))
    monkeypatch.setattr(urllib.request, "urlretrieve", fake_urlretrieve)
    download_pretrained.main(["download", TASK])
    assert fetched == [ppm.AVAILABLE_MODELS[TASK]["url"]]
    assert _tree(tmp_path / "r") == jax_installed

    def offline(url, target):
        raise OSError("no route to host")

    monkeypatch.setattr(urllib.request, "urlretrieve", offline)
    with pytest.raises(RuntimeError, match="install_model_from_zip_file"):
        download_pretrained.main(["download", TASK])
    with pytest.raises(ValueError, match="unknown pretrained model"):
        download_pretrained.main(["download", "Task999_Nothing"])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A results folder holding one fp32 MultiTalent model (fold 0) in the
    reference layout with its postprocessing.json and a valid ensemble's,
    and one input case."""
    root = tmp_path_factory.mktemp("trained")
    results = root / "results"
    model = results / "nnUNet" / "3d_fullres" / TASK / f"{TRAINER}__{PLANS_ID}"
    sd = _weights()
    save_model_folder(str(model), _tiny_plans(), [sd], TRAINER, fp16=False)
    (model / "postprocessing.json").write_text('{"for_which_classes": []}')
    ens = (results / "nnUNet" / "ensembles" / TASK
           / f"ensemble_3d_fullres__{TRAINER}__{PLANS_ID}--3d_fullres__{CASCADE}__{PLANS_ID}")
    ens.mkdir(parents=True)
    (ens / "postprocessing.json").write_text("{}")
    (root / "in").mkdir()
    write_nifti(root / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(2)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    return root, sd


def _masks(folder):
    return [read_nifti(folder / "individual" / r / "case.nii.gz")[0] for r in REGIONS]


def test_export_install_round_trip_predicts_as_the_jax_package(trained, tmp_path,
                                                                monkeypatch):
    root, sd = trained
    monkeypatch.setenv("RESULTS_FOLDER", str(root / "results"))
    args = ["-t", "100", "-m", "3d_fullres", "-tr", TRAINER, "-f", "0"]
    export_model.main(["-o", str(tmp_path / "port.zip"), *args])
    jax_export_model.main(["-o", str(tmp_path / "jax.zip"), *args])
    with zipfile.ZipFile(tmp_path / "port.zip") as zp, \
            zipfile.ZipFile(tmp_path / "jax.zip") as zj:
        assert zp.namelist() == zj.namelist()
        assert all(zp.read(n) == zj.read(n) for n in zp.namelist())
        names = zp.namelist()
    model_rel = os.path.join("3d_fullres", TASK, f"{TRAINER}__{PLANS_ID}")
    assert sorted(names) == sorted(
        [os.path.join(model_rel, p) for p in ("fold_0/" + CKPT + ".model",
                                              "fold_0/" + CKPT + ".model.pkl", "plans.pkl",
                                              "postprocessing.json")]
        + [os.path.join("ensembles", TASK, f"ensemble_3d_fullres__{TRAINER}__{PLANS_ID}"
                        f"--3d_fullres__{CASCADE}__{PLANS_ID}", "postprocessing.json")])

    monkeypatch.setenv("RESULTS_FOLDER", str(tmp_path / "installed"))
    download_pretrained.main(["install_zip", str(tmp_path / "port.zip")])
    original = _tree(root / "results" / "nnUNet")
    installed = _tree(tmp_path / "installed" / "nnUNet")
    assert installed == {k: v for k, v in original.items() if k in names}

    model = tmp_path / "installed" / "nnUNet" / model_rel
    monkeypatch.setenv("MTTPU_SW_EXACT", "1")  # the JAX prediction's mode
    restored = load_model_and_checkpoint_files(str(model), None, device="cpu")
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k], sd[k]) for k in got)
    predict_main(["-i", str(root / "in"), "-o", str(tmp_path / "port_out"), "-m", str(model),
                  "--device", "cpu", "--disable_tta"])
    # the JAX package predicts from its own import of the installed folder
    jax_model = tmp_path / "jax_model"
    shutil.copytree(model, jax_model)
    jpm.import_reference_model_folder(str(jax_model), TRAINER)
    sidecar = jax_model / "fold_0" / f"{CKPT}.ckpt.pkl"
    meta = load_pickle(sidecar)
    meta["init_args"] = (*meta["init_args"][:8], False)  # the JAX import writes fp16=True
    save_pickle(meta, sidecar)
    jax_predict_from_folder(str(jax_model), str(root / "in"), str(tmp_path / "jax_out"), None,
                            tta=False, multitalent_regions=True)
    agree = np.array([np.mean(a == b) for a, b in zip(_masks(tmp_path / "port_out"),
                                                      _masks(tmp_path / "jax_out"))])
    assert agree.min() >= 0.9999, agree.min()
    seg, _ = read_nifti(tmp_path / "port_out" / "case.nii.gz")
    ref, _ = read_nifti(tmp_path / "jax_out" / "case.nii.gz")
    assert np.mean(seg == ref) >= 0.9999


def _ckpt_only(src, dst) -> None:
    """The JAX-layout files of a model folder (plans.pkl, each fold's .ckpt
    and sidecar) without its .model files."""
    (dst / "fold_0").mkdir(parents=True)
    shutil.copy(src / "plans.pkl", dst / "plans.pkl")
    for name in (f"{CKPT}.ckpt", f"{CKPT}.ckpt.pkl"):
        shutil.copy(src / "fold_0" / name, dst / "fold_0" / name)


def test_import_torch_writes_the_jax_bytes_and_both_restore(trained, tmp_path):
    root, sd = trained
    model = root / "results" / "nnUNet" / "3d_fullres" / TASK / f"{TRAINER}__{PLANS_ID}"
    for name in ("port", "jax"):
        shutil.copytree(model, tmp_path / name)
    download_pretrained.main(["import_torch", str(tmp_path / "port"), TRAINER])
    jpm.import_reference_model_folder(str(tmp_path / "jax"), TRAINER)
    ckpt = os.path.join("fold_0", f"{CKPT}.ckpt")
    assert (tmp_path / "port" / ckpt).read_bytes() == (tmp_path / "jax" / ckpt).read_bytes()
    meta = load_pickle(tmp_path / "port" / (ckpt + ".pkl"))
    assert meta["trainer_name"] == TRAINER and meta["state_keys"] == ["params", "step"]
    assert meta["converted_from"].endswith(f"{CKPT}.model")

    # each package restores the other's folder (.ckpt files only)
    _ckpt_only(tmp_path / "port", tmp_path / "port_ckpt")
    _ckpt_only(tmp_path / "jax", tmp_path / "jax_ckpt")
    trainer, params = jax_load_model(str(tmp_path / "port_ckpt"))
    assert type(trainer).__name__ == "MultiTalentTrainer"
    back = generic_unet_state_dict_from_flax(jax.device_get(params[0]), num_pool=3)
    assert all(torch.equal(back[k], sd[k]) for k in back)
    restored = load_model_and_checkpoint_files(str(tmp_path / "jax_ckpt"), None, device="cpu")
    assert restored.inference_nonlin == "sigmoid"
    got = restored.networks[0].state_dict()
    assert all(torch.equal(got[k].float(), sd[k]) for k in got)


def test_import_torch_refuses_a_checkpoint_off_the_plans(trained, tmp_path):
    root, _ = trained
    model = root / "results" / "nnUNet" / "3d_fullres" / TASK / f"{TRAINER}__{PLANS_ID}"
    shutil.copytree(model, tmp_path / "m")
    wrong = {k: (v[:, :-1] if k == "conv_blocks_context.0.blocks.0.conv.weight" else v)
             for k, v in _weights().items()}
    torch.save({"epoch": 0, "state_dict": wrong}, tmp_path / "m" / "fold_0" / f"{CKPT}.model")
    with pytest.raises(AssertionError, match="shape mismatch"):
        ppm.import_reference_model_folder(str(tmp_path / "m"), TRAINER)
    assert not (tmp_path / "m" / "fold_0" / f"{CKPT}.ckpt").exists()


def test_resenc_conversion_writes_the_jax_converter_s_bytes():
    """A reference resenc state dict (bias-free convs, `module.` prefix, the
    `.all.` duplicates, the old last head name) through the import's
    converters: the flax bytes of the JAX package's converter."""
    sd = {k: v for k, v in port_net(seed=3).state_dict().items() if not k.endswith(CONV_BIASES)}
    last = f"decoder.deep_supervision_outputs.{len(NBD) - 1}"
    for suffix in ("weight", "bias"):
        sd[f"decoder.segmentation_output.{suffix}"] = sd.pop(f"{last}.{suffix}")
    sd["decoder.stages.0.convs.0.all.0.weight"] = sd["decoder.stages.0.convs.0.conv.weight"]
    sd = {f"module.{k}": v for k, v in sd.items()}
    step = np.zeros((), np.int32)
    want = serialization.to_bytes(
        {"step": step, "params": convert_fabians_unet_state_dict(sd, len(POOLS), NBE, NBD)})
    from multitalent_tpu_torch.io.torch_convert import strip_module_prefix
    got = flax_ckpt.dumps({"step": step, "params": convert_resenc_state_dict(
        fabians_unet_state_dict(strip_module_prefix(sd), len(POOLS)), NBE, NBD)})
    assert got == want


def test_change_trainer_sets_the_key_restore_reads(trained, tmp_path, capsys):
    """On a reference `.model.pkl` the JAX CLI adds `trainer_name` and leaves
    `name`, which restore reads, as it was; the port's CLI sets `name`, and
    restore then resolves the new trainer. On a `.ckpt.pkl` both set
    `trainer_name`, to the same bytes."""
    root, _ = trained
    model = root / "results" / "nnUNet" / "3d_fullres" / TASK / f"{TRAINER}__{PLANS_ID}"
    for name in ("port", "jax"):
        shutil.copytree(model, tmp_path / name)
    new = "MultiTalent_trainer_ddp_2000ep"
    sidecar = os.path.join("fold_0", f"{CKPT}.model.pkl")
    jax_change_trainer.main([str(tmp_path / "jax" / sidecar), new])
    change_trainer.main([str(tmp_path / "port" / sidecar), new])
    jax_meta = load_pickle(tmp_path / "jax" / sidecar)
    port_meta = load_pickle(tmp_path / "port" / sidecar)
    assert jax_meta["name"] == TRAINER and jax_meta["trainer_name"] == new
    assert port_meta["name"] == new and "trainer_name" not in port_meta
    assert read_model_folder(str(tmp_path / "jax"))[3] == [TRAINER]
    assert read_model_folder(str(tmp_path / "port"))[3] == [new]
    restored = load_model_and_checkpoint_files(str(tmp_path / "port"), None, device="cpu")
    assert restored.trainer_name == new and restored.inference_nonlin == "sigmoid"

    jpm.import_reference_model_folder(str(tmp_path / "jax"), TRAINER)
    ckpt_pkl = os.path.join("fold_0", f"{CKPT}.ckpt.pkl")
    shutil.copy(tmp_path / "jax" / ckpt_pkl, tmp_path / "port" / ckpt_pkl)
    jax_change_trainer.main([str(tmp_path / "jax" / ckpt_pkl), new])
    change_trainer.main([str(tmp_path / "port" / ckpt_pkl), new])
    assert (tmp_path / "jax" / ckpt_pkl).read_bytes() == (tmp_path / "port" / ckpt_pkl).read_bytes()
    with pytest.raises(ValueError, match="neither"):
        change_trainer.trainer_key({"epoch": 1})
    capsys.readouterr()
