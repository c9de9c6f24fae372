"""Pretrained model zoo: download table, zip install and export, and the
conversion of reference-trained `.model` checkpoints into the JAX package's
`.ckpt` layout.

The port's counterpart of multitalent_tpu/inference/pretrained_models.py
(host code; the names, the table and the installed trees are the JAX
module's). Parity target: nnunet/inference/pretrained_models/
download_pretrained_model.py (task -> URL table incl. the Task100_MultiTalent
zenodo zip :226-231, install from zip, and the post-install MultiTalent
folder-rename fixups :274-280). `import_reference_model_folder` writes, beside
each fold's `.model`, the `.ckpt` flax msgpack the JAX package's import
writes, byte for byte, through io/torch_convert.py's converters and
io/flax_ckpt.py (no flax), and a `.ckpt.pkl` sidecar both packages restore.
The port restores the reference layout as it is
(inference/model_restore.py), so predicting from an installed zip needs no
import.
"""
from __future__ import annotations

import os
import pickle
import shutil
import zipfile

from multitalent_tpu_torch import paths
from multitalent_tpu_torch.utils.fileops import maybe_mkdir, subdirs, subfiles

# task -> {description, url}: the reference's full 27-entry zenodo table
# (download_pretrained_model.py get_available_models) - facts about public
# artifacts, reproduced verbatim. Descriptions abbreviated to one line.
AVAILABLE_MODELS: dict[str, dict] = {
    "Task001_BrainTumour": {
        "description": "Brain Tumor Segmentation. Segmentation targets are edema, enhancing tumor and necrosis, Input modalities ar...",
        "url": "https://zenodo.org/record/4003545/files/Task001_BrainTumour.zip?download=1",
    },
    "Task002_Heart": {
        "description": "Left Atrium Segmentation. Segmentation target is the left atrium, Input modalities are 0: MRI. Also see Med...",
        "url": "https://zenodo.org/record/4003545/files/Task002_Heart.zip?download=1",
    },
    "Task003_Liver": {
        "description": "Liver and Liver Tumor Segmentation. Segmentation targets are liver and tumors, Input modalities are 0: abdo...",
        "url": "https://zenodo.org/record/4003545/files/Task003_Liver.zip?download=1",
    },
    "Task004_Hippocampus": {
        "description": "Hippocampus Segmentation. Segmentation targets posterior and anterior parts of the hippocampus, Input modal...",
        "url": "https://zenodo.org/record/4003545/files/Task004_Hippocampus.zip?download=1",
    },
    "Task005_Prostate": {
        "description": "Prostate Segmentation. Segmentation targets are peripheral and central zone, Input modalities are 0: T2, 1:...",
        "url": "https://zenodo.org/record/4485926/files/Task005_Prostate.zip?download=1",
    },
    "Task006_Lung": {
        "description": "Lung Nodule Segmentation. Segmentation target are lung nodules, Input modalities are 0: abdominal CT scan. ...",
        "url": "https://zenodo.org/record/4003545/files/Task006_Lung.zip?download=1",
    },
    "Task007_Pancreas": {
        "description": "Pancreas Segmentation. Segmentation targets are pancras and pancreas tumor, Input modalities are 0: abdomin...",
        "url": "https://zenodo.org/record/4003545/files/Task007_Pancreas.zip?download=1",
    },
    "Task008_HepaticVessel": {
        "description": "Hepatic Vessel Segmentation. Segmentation targets are hepatic vesels and liver tumors, Input modalities are...",
        "url": "https://zenodo.org/record/4003545/files/Task008_HepaticVessel.zip?download=1",
    },
    "Task009_Spleen": {
        "description": "Spleen Segmentation. Segmentation target is the spleen, Input modalities are 0: abdominal CT scan. Also see...",
        "url": "https://zenodo.org/record/4003545/files/Task009_Spleen.zip?download=1",
    },
    "Task010_Colon": {
        "description": "Colon Cancer Segmentation. Segmentation target are colon caner primaries, Input modalities are 0: CT scan. ...",
        "url": "https://zenodo.org/record/4003545/files/Task010_Colon.zip?download=1",
    },
    "Task017_AbdominalOrganSegmentation": {
        "description": "Multi-Atlas Labeling Beyond the Cranial Vault - Abdomen. Segmentation targets are thirteen different abdomi...",
        "url": "https://zenodo.org/record/4003545/files/Task017_AbdominalOrganSegmentation.zip?download=1",
    },
    "Task024_Promise": {
        "description": "Prostate MR Image Segmentation 2012. Segmentation target is the prostate, Input modalities are 0: T2. Also ...",
        "url": "https://zenodo.org/record/4003545/files/Task024_Promise.zip?download=1",
    },
    "Task027_ACDC": {
        "description": "Automatic Cardiac Diagnosis Challenge. Segmentation targets are right ventricle, left ventricular cavity an...",
        "url": "https://zenodo.org/record/4003545/files/Task027_ACDC.zip?download=1",
    },
    "Task029_LiTS": {
        "description": "Liver and Liver Tumor Segmentation Challenge. Segmentation targets are liver and liver tumors, Input modali...",
        "url": "https://zenodo.org/record/4003545/files/Task029_LITS.zip?download=1",
    },
    "Task035_ISBILesionSegmentation": {
        "description": "Longitudinal multiple sclerosis lesion segmentation Challenge. Segmentation target is MS lesions, input mod...",
        "url": "https://zenodo.org/record/4003545/files/Task035_ISBILesionSegmentation.zip?download=1",
    },
    "Task038_CHAOS_Task_3_5_Variant2": {
        "description": "CHAOS - Combined (CT-MR) Healthy Abdominal Organ Segmentation Challenge (Task 3 & 5). Segmentation targets ...",
        "url": "https://zenodo.org/record/4003545/files/Task038_CHAOS_Task_3_5_Variant2.zip?download=1",
    },
    "Task048_KiTS_clean": {
        "description": "Kidney and Kidney Tumor Segmentation Challenge. Segmentation targets kidney and kidney tumors, Input modali...",
        "url": "https://zenodo.org/record/4003545/files/Task048_KiTS_clean.zip?download=1",
    },
    "Task055_SegTHOR": {
        "description": "SegTHOR: Segmentation of THoracic Organs at Risk in CT images. Segmentation targets are aorta, esophagus, h...",
        "url": "https://zenodo.org/record/4003545/files/Task055_SegTHOR.zip?download=1",
    },
    "Task061_CREMI": {
        "description": "MICCAI Challenge on Circuit Reconstruction from Electron Microscopy Images (Synaptic Cleft segmentation tas...",
        "url": "https://zenodo.org/record/4003545/files/Task061_CREMI.zip?download=1",
    },
    "Task075_Fluo_C3DH_A549_ManAndSim": {
        "description": "Fluo-C3DH-A549-SIM and Fluo-C3DH-A549 datasets of the cell tracking challenge. Segmentation target are C3DH...",
        "url": "https://zenodo.org/record/4003545/files/Task075_Fluo_C3DH_A549_ManAndSim.zip?download=1",
    },
    "Task076_Fluo_N3DH_SIM": {
        "description": "Fluo-N3DH-SIM dataset of the cell tracking challenge. Segmentation target are N3DH cells and cell borders i...",
        "url": "https://zenodo.org/record/4003545/files/Task076_Fluo_N3DH_SIM.zip?download=1",
    },
    "Task082_BraTS2020": {
        "description": "Brain tumor segmentation challenge 2020 (BraTS) Segmentation targets are 0: background, 1: edema, 2: necros...",
        "url": ['https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2__nnUNetPlansv2.1_5fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA3_BN_BD__nnUNetPlansv2.1_bs5_5fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA4_BN__nnUNetPlansv2.1_bs5_15fold.zip?download=1', 'https://zenodo.org/record/4635763/files/Task082_nnUNetTrainerV2BraTSRegions_DA4_BN_BD__nnUNetPlansv2.1_bs5_5fold.zip?download=1'],
    },
    "Task089_Fluo-N2DH-SIM_thickborder_time": {
        "description": "Fluo-N2DH-SIM dataset of the cell tracking challenge. Segmentation target are nuclei of N2DH cells and cell...",
        "url": "https://zenodo.org/record/4003545/files/Task089_Fluo-N2DH-SIM_thickborder_time.zip?download=1",
    },
    "Task114_heart_MNMs": {
        "description": "Cardiac MRI short axis images from the M&Ms challenge 2020. Input modalities are 0: MRI See also https://ww...",
        "url": "https://zenodo.org/record/4288464/files/Task114_heart_MNMs.zip?download=1",
    },
    "Task115_COVIDSegChallenge": {
        "description": "Covid lesion segmentation in CT images. Data originates from COVID-19-20 challenge. Predicted labels are 0:...",
        "url": ['https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_DA3__nnUNetPlans_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_DA3_BN__nnUNetPlans_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet__nnUNetPlans_FabiansResUNet_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet_DA3__nnUNetPlans_FabiansResUNet_v2.1__3d_fullres__10folds.zip?download=1', 'https://zenodo.org/record/4635822/files/Task115_nnUNetTrainerV2_ResencUNet_DA3_BN__nnUNetPlans_FabiansResUNet_v2.1__3d_lowres__10folds.zip?download=1'],
    },
    "Task135_KiTS2021": {
        "description": "Kidney and kidney tumor segmentation in CT images. Data originates from KiTS2021 challenge. Predicted label...",
        "url": "https://zenodo.org/record/5126443/files/Task135_KiTS2021.zip?download=1",
    },
    "Task100_MultiTalent": {
        "description": "Pretrained models for the paper: MultiTalent: A Multi-Dataset Approach to Medical Image Segmentation Infos ...",
        "url": "https://zenodo.org/record/8297767/files/Task100_MultiTalent.zip?download=1",
    },
}


def print_available_pretrained_models() -> None:
    print("Available pretrained models:")
    for name, info in AVAILABLE_MODELS.items():
        print(f"  {name}: {info['description']}\n    {info['url']}")


def download_and_install_pretrained_model_by_name(task_name: str) -> None:
    if task_name not in AVAILABLE_MODELS:
        raise ValueError(f"unknown pretrained model {task_name!r}; "
                         f"known: {sorted(AVAILABLE_MODELS)}")
    url = AVAILABLE_MODELS[task_name]["url"]
    try:
        import urllib.request
        target = os.path.join(paths.network_training_output_dir(),
                              f"{task_name}.zip")
        print(f"downloading {url} ...")
        urllib.request.urlretrieve(url, target)
        install_model_from_zip_file(target)
        os.remove(target)
    except OSError as e:
        raise RuntimeError(
            f"Download failed ({e}). If this machine has no internet access, "
            f"download {url} elsewhere and install it with "
            "install_model_from_zip_file(<zip>).") from e


def export_pretrained_model(task_name: str, output_file: str,
                            models=("2d", "3d_lowres", "3d_fullres",
                                    "3d_cascade_fullres"),
                            trainer: str | None = None,
                            cascade_trainer: str | None = None,
                            plans_identifier: str | None = None,
                            folds=(0, 1, 2, 3, 4), strict: bool = True) -> None:
    """Zip trained models of one task for sharing — the inverse of
    install_model_from_zip_file (collect_pretrained_models.py:143-214).

    Archive paths are relative to network_training_output_dir, so the zip
    round-trips through install_model_from_zip_file on another machine.
    Per fold it packs the final checkpoint (either this framework's
    .ckpt/.ckpt.pkl pair or an imported reference .model/.model.pkl pair,
    whichever exists) plus debug.json/progress.png when present; per model
    dir plans.pkl (required) and postprocessing.json (required when strict,
    as in the reference); plus any valid ensemble postprocessing.json."""
    trainer = trainer or paths.default_trainer
    cascade_trainer = cascade_trainer or paths.default_cascade_trainer
    plans_identifier = plans_identifier or paths.default_plans_identifier
    base = paths.network_training_output_dir()
    tdir = f"{trainer}__{plans_identifier}"
    tdir_cascade = f"{cascade_trainer}__{plans_identifier}"

    def _add(z, abspath):
        z.write(abspath, os.path.relpath(abspath, base))

    with zipfile.ZipFile(output_file, "w", zipfile.ZIP_DEFLATED) as z:
        for m in models:
            to = tdir_cascade if m == "3d_cascade_fullres" else tdir
            mdir = os.path.join(base, m, task_name, to)
            if not os.path.isdir(mdir):
                if strict:
                    raise RuntimeError(
                        f"Task {task_name} is missing the model {m} "
                        f"({mdir}); use strict=False to skip")
                continue
            fold_names = [f"fold_{f}" if f != "all" else str(f)
                          for f in folds]
            missing = [f for f in fold_names
                       if not os.path.isdir(os.path.join(mdir, f))]
            assert not missing, (f"not all requested folds present for "
                                 f"{task_name} {m}: missing {missing}")
            plans = os.path.join(mdir, "plans.pkl")
            assert os.path.isfile(plans), f"plans.pkl missing in {mdir}"
            for fn in fold_names:
                fdir = os.path.join(mdir, fn)
                ck = [f"model_final_checkpoint{s}" for s in
                      (".ckpt", ".ckpt.pkl", ".model", ".model.pkl")]
                present = [c for c in ck
                           if os.path.isfile(os.path.join(fdir, c))]
                if not present:
                    raise RuntimeError(
                        f"no final checkpoint in {fdir} (looked for {ck})")
                for c in present:
                    _add(z, os.path.join(fdir, c))
                for extra in ("debug.json", "progress.png"):
                    p = os.path.join(fdir, extra)
                    if os.path.isfile(p):
                        _add(z, p)
            _add(z, plans)
            pp = os.path.join(mdir, "postprocessing.json")
            if os.path.isfile(pp):
                _add(z, pp)
            elif strict:
                raise RuntimeError(
                    f"postprocessing.json missing in {mdir}; run "
                    "cli.determine_postprocessing or use strict=False")
            else:
                print(f"WARNING: postprocessing.json missing in {mdir}")
        # valid ensembles' postprocessing (collect_pretrained_models.py:199-213)
        edir = os.path.join(base, "ensembles", task_name)
        if os.path.isdir(edir):
            valid_trainers = {trainer, cascade_trainer}
            for sub in subdirs(edir, join=False):
                body = sub[len("ensemble_"):] if sub.startswith("ensemble_") \
                    else sub
                try:
                    mb1, mb2 = body.split("--")
                    parts = [mb.split("__") for mb in (mb1, mb2)]
                    ok = all(len(p) == 3 and p[0] in models
                             and p[1] in valid_trainers
                             and p[2] == plans_identifier for p in parts)
                except ValueError:
                    ok = False
                pp = os.path.join(edir, sub, "postprocessing.json")
                if ok and os.path.isfile(pp):
                    _add(z, pp)
        else:
            print(f"No ensemble directory found for task {task_name}")
    print(f"wrote {output_file}")


def install_model_from_zip_file(zip_file: str) -> None:
    """Extract a model zip into RESULTS_FOLDER/nnUNet and apply the MultiTalent
    folder-rename fixups (download_pretrained_model.py:274-280: the released zip
    names trainer output dirs differently than the trainer expects)."""
    out_dir = paths.network_training_output_dir()
    with zipfile.ZipFile(zip_file) as z:
        z.extractall(out_dir)
    _apply_multitalent_fixups(out_dir)
    print(f"installed into {out_dir}")


def _apply_multitalent_fixups(out_dir: str) -> None:
    """Post-install fixups for the released Task100 zip
    (download_pretrained_model.py:274-295): the zip extracts to
    <out>/Task100_MultiTalent (missing the 3d_fullres level), one trainer dir
    carries a typo'd/old name, and the checkpoint sidecar pkls store stale
    trainer names."""
    src_dir = os.path.join(out_dir, "Task100_MultiTalent")
    task_dir = os.path.join(out_dir, "3d_fullres", "Task100_MultiTalent")
    if os.path.isdir(src_dir):
        maybe_mkdir(os.path.dirname(task_dir))
        shutil.copytree(src_dir, task_dir, dirs_exist_ok=True)
        shutil.rmtree(src_dir)
    if not os.path.isdir(task_dir):
        return
    renames = {
        # wrong upload trainer name in the released zip
        "MultiTalent_tainer_resenc_ddp": "MultiTalent_trainer_resenc_ddp_2000ep",
        # older release variants
        "MultiTalent_trainer": "MultiTalent_trainer_ddp",
        "MultiTalent_trainer_resenc": "MultiTalent_trainer_resenc_ddp",
    }
    for d in subdirs(task_dir, join=False):
        base = d.split("__")[0]
        if base in renames:
            new = d.replace(base, renames[base], 1)
            os.rename(os.path.join(task_dir, d), os.path.join(task_dir, new))
            print(f"renamed {d} -> {new}")
    # sidecar pkls carry old trainer names: stamp the (fixed) folder name in
    for config in subdirs(task_dir, join=False):
        for fold in subdirs(os.path.join(task_dir, config), join=False):
            pkl = os.path.join(task_dir, config, fold,
                               "model_final_checkpoint.model.pkl")
            if os.path.isfile(pkl):
                with open(pkl, "rb") as f:
                    meta = pickle.load(f)
                meta["name"] = config.split("__")[0]
                with open(pkl, "wb") as f:
                    pickle.dump(meta, f)


def import_reference_model_folder(model_folder: str, trainer_name: str,
                                  num_classes: int | None = None) -> None:
    """Convert every fold's torch checkpoint(s) in a reference-trained model
    folder into the JAX package's flax checkpoints
    (pretrained_models.py:310-377 of the JAX package).

    Requires the folder to contain plans.pkl and
    fold_X/<name>.model (the reference layout). Writes
    fold_X/<name>.ckpt (flax msgpack of {"step", "params"}, the bytes the JAX
    function writes) and its `.ckpt.pkl` sidecar (trainer_name,
    trainer_bases, init_args with <model>/plans.pkl first, state_keys,
    converted_from). A residual-encoder checkpoint (`encoder.initial_conv`)
    takes its block counts from the plans; before writing, every parameter
    of the network the trainer builds from the plans must be present with
    its shape. `num_classes` is unused, as in the JAX function."""
    import numpy as np

    from multitalent_tpu_torch.cli.train import TRAINERS
    from multitalent_tpu_torch.inference.model_restore import (head_of_trainer,
                                                               is_resenc_state_dict,
                                                               network_overrides_of)
    from multitalent_tpu_torch.io import flax_ckpt
    from multitalent_tpu_torch.io.torch_convert import (convert_generic_unet_state_dict,
                                                       convert_resenc_state_dict,
                                                       fabians_unet_state_dict,
                                                       load_reference_checkpoint,
                                                       strip_module_prefix)
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.models.residual_unet import build_resenc_unet_from_plans
    from multitalent_tpu_torch.plans import load_plans
    from multitalent_tpu_torch.tasks.multitalent import NUM_REGIONS

    plans_path = os.path.join(model_folder, "plans.pkl")
    assert os.path.isfile(plans_path), f"missing {plans_path}"
    plans = load_plans(plans_path)
    if trainer_name not in TRAINERS:
        raise KeyError(f"unknown trainer {trainer_name!r}; known: {sorted(TRAINERS)}")
    names = [trainer_name, *(c.__name__ for c in TRAINERS[trainer_name].__mro__)]
    stage = max(plans.plans_per_stage.keys())
    st = plans.stage(stage)
    num_pool = len(st.pool_op_kernel_sizes)
    heads = (NUM_REGIONS if head_of_trainer(names)[1] == "sigmoid"
             else plans.num_classes + 1)

    def convert(sd: dict) -> dict:
        if is_resenc_state_dict(sd):
            # FabiansUNet (resenc): block counts from the resenc plans
            # (MultiTalent_meets_resenc.py:72-104), its quirks undone first
            return convert_resenc_state_dict(fabians_unet_state_dict(sd, num_pool),
                                             st.num_blocks_encoder, st.num_blocks_decoder)
        return convert_generic_unet_state_dict(sd, num_pool=num_pool,
                                               conv_per_stage=plans.conv_per_stage)

    def flat(tree: dict, prefix=()) -> dict:
        out = {}
        for k, v in tree.items():
            out.update(flat(v, prefix + (k,)) if isinstance(v, dict) else {prefix + (k,): v})
        return out

    for fold_dir in subdirs(model_folder, prefix="fold_"):
        for tc in subfiles(fold_dir, suffix=".model"):
            name = os.path.basename(tc)[:-len(".model")]
            print(f"converting {fold_dir}/{name}.model ...")
            state_dict = strip_module_prefix(load_reference_checkpoint(tc))
            fold = int(os.path.basename(fold_dir).split("_")[-1])
            if is_resenc_state_dict(state_dict):
                net = build_resenc_unet_from_plans(plans, stage, heads)
            else:
                net = build_unet_from_plans(plans, stage, heads,
                                            **network_overrides_of(names, plans, stage))
            converted = convert(state_dict)
            # sanity: shapes must match the network the trainer builds
            got = flat(converted)
            for path, leaf in flat(convert(net.state_dict())).items():
                assert path in got, f"missing converted param {path}"
                assert got[path].shape == leaf.shape, \
                    f"shape mismatch at {path}: {got[path].shape} vs {leaf.shape}"
            tree = {"step": np.zeros((), np.int32), "params": converted}
            out = os.path.join(fold_dir, name + ".ckpt")
            flax_ckpt.save(out, tree)
            meta = {"epoch": 1, "plot_stuff": ([], [], [], []),
                    "best_stuff": (None, None, None), "trainer_name": trainer_name,
                    "trainer_bases": names[1:],
                    "init_args": (plans_path, fold, model_folder, None, True, stage, True,
                                  True, True),
                    "state_keys": sorted(tree.keys()), "converted_from": tc}
            with open(out + ".pkl", "wb") as f:
                pickle.dump(meta, f)
            print(f"  -> {out}")
