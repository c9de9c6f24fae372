"""The port's raw-data front end and plots held to the JAX package's on the
same synthetic inputs: io/dicom.py (both little-endian syntaxes, an
undefined-length sequence, a headerless stream), utils/reorientation.py, the
7 converters of tasks/source_converters.CONVERTERS through
cli/convert_multitalent_sources (Task062 from a DICOM tree),
cli/convert_decathlon_task (a 4D MSD task split into its modalities, a
renumbered task) and cli/plot_task_pngs with utils/overlay_plots (raw and
preprocessed). Every NIfTI array and geometry, every dataset.json and
every PNG's bytes must equal the JAX package's.
"""
import json
import os
import shutil
import struct

import numpy as np
import pytest

from multitalent_tpu.cli import convert_decathlon_task as jax_decathlon
from multitalent_tpu.cli import plot_task_pngs as jax_plot
from multitalent_tpu.io import dicom as jdicom
from multitalent_tpu.tasks import source_converters as jsc
from multitalent_tpu.utils import overlay_plots as jplots
from multitalent_tpu.utils import reorientation as jreo
from multitalent_tpu_torch.cli import convert_decathlon_task, convert_multitalent_sources
from multitalent_tpu_torch.cli import plot_task_pngs
from multitalent_tpu_torch.io import dicom as pdicom
from multitalent_tpu_torch.io.nifti import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.tasks import source_converters as psc
from multitalent_tpu_torch.utils import overlay_plots as pplots
from multitalent_tpu_torch.utils import reorientation as preo

from test_dicom import COLS, ROWS, _el_explicit, _el_implicit, _make_series

SHAPE = (4, 6, 6)
# an oblique-free but permuted, flipped direction: the converters must carry it
GEOM = Geometry(spacing=(0.8, 0.9, 2.5), origin=(-3.0, 7.0, 11.5),
                direction=(0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0))


def _vol(rng, labels=False, shape=SHAPE):
    if labels:
        return rng.randint(0, 4, shape).astype(np.uint8)
    return (rng.randn(*shape) * 100).astype(np.int16)


def _write(path, arr, geom=GEOM):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_nifti(path, arr, geom)


def _pair(rng, img, lab):
    _write(img, _vol(rng))
    _write(lab, _vol(rng, labels=True))


def _undefined_sq_slice(path, z_index, pixels) -> None:
    """An implicit-VR slice with an undefined-length sequence (one item of
    defined length, one of undefined length) before its tags."""
    item = struct.pack("<HHI", 0xFFFE, 0xE000, 4) + b"ABCD"
    open_item = (struct.pack("<HHI", 0xFFFE, 0xE000, 0xFFFFFFFF) + b"EFGH"
                 + struct.pack("<HHI", 0xFFFE, 0xE00D, 0))
    seq = (struct.pack("<HHI", 0x0008, 0x1140, 0xFFFFFFFF) + item + open_item
           + struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))

    def ds(*vals):
        s = "\\".join(f"{v:g}" for v in vals)
        return (s + " " if len(s) % 2 else s).encode()

    body = b"".join([
        seq,
        _el_implicit(0x0020, 0x0032, ds(-100.0, -80.0, 50.0 + 2.5 * z_index)),
        _el_implicit(0x0020, 0x0037, ds(1, 0, 0, 0, 1, 0)),
        _el_implicit(0x0028, 0x0010, struct.pack("<H", ROWS)),
        _el_implicit(0x0028, 0x0011, struct.pack("<H", COLS)),
        _el_implicit(0x0028, 0x0030, ds(0.75, 0.5)),
        _el_implicit(0x0028, 0x0100, struct.pack("<H", 16)),
        _el_implicit(0x7FE0, 0x0010, pixels.astype("<i2").tobytes()),
    ])
    meta = _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2\x00")
    with open(path, "wb") as f:
        f.write(b"\x00" * 128 + b"DICM" + meta + body)


def _dicom_tree(base) -> None:
    """A TCIA manifest tree: PANCREAS_0001 explicit VR, _0002 implicit,
    _0003 with undefined-length sequences, _0007 (excluded by Task062)."""
    for i, explicit in ((1, True), (2, False), (7, True)):
        _make_series(str(base / f"PANCREAS_{i:04d}" / "study" / "series"), explicit, seed=i)
    series = base / "PANCREAS_0003" / "study" / "series"
    series.mkdir(parents=True)
    raw = np.random.RandomState(3).randint(0, 3000, (5, ROWS, COLS)).astype(np.int16)
    for z in range(5):
        _undefined_sq_slice(series / f"s{z}.dcm", z, raw[z])


def _labels(folder, names, shape, rng, geom) -> None:
    for n in names:
        _write(os.path.join(folder, n), _vol(rng, labels=True, shape=shape), geom)


# task -> (source writer, CLI arguments after the source); each writer
# fills `src` with the challenge download's layout
def _task017(src, rng):
    for i in (1, 2):
        _pair(rng, src / "Training" / "img" / f"img{i:04d}.nii.gz",
              src / "Training" / "label" / f"label{i:04d}.nii.gz")
    _write(src / "Test" / "img" / "img0061.nii.gz", _vol(rng))
    return []


def _task018(src, rng):
    for c in ("Case_01", "Case_02"):
        _pair(rng, src / "Training" / "img" / f"{c}-Image.nii.gz",
              src / "Training" / "label" / f"{c}-Mask.nii.gz")
    _write(src / "Testing" / "img" / "Case_09-Image.nii.gz", _vol(rng))
    return []


def _task055(src, rng):
    for p in ("Patient_01", "Patient_02"):
        _pair(rng, src / "train" / p / f"{p}.nii.gz", src / "train" / p / "GT.nii.gz")
    _write(src / "test" / "Patient_41.nii.gz", _vol(rng))
    return []


def _task062(src, rng):
    _dicom_tree(src / "images")
    _labels(src / "labels", [f"label{i:04d}.nii.gz" for i in (1, 2, 3, 7)], (5, ROWS, COLS),
            rng, Geometry(spacing=(0.5, 0.75, 2.5)))
    return ["--labels", str(src / "labels")]


def _task064(src, rng):
    for c in ("case_00000", "case_00001", "case_00002"):
        _pair(rng, src / c / "imaging.nii.gz", src / c / "segmentation.nii.gz")
    return []


def _task046(src, rng):
    pan, labs, btcv = src / "pancreas", src / "zenodo", src / "btcv"
    _write(pan / "PANCREAS_0001.nii.gz", _vol(rng),
           Geometry(spacing=GEOM.spacing, origin=(9.0, 9.0, 9.0), direction=GEOM.direction))
    _write(pan / "PANCREAS_0099.nii.gz", _vol(rng))
    seg = np.zeros(SHAPE, np.int16)
    seg[0, 0, 0], seg[1, 1, 1], seg[2, 2, 2] = 11, 14, 3
    _write(labs / "label_tciapancreasct_multiorgan" / "label_tcia_multiorgan"
           / "label0001.nii.gz", seg)
    _write(btcv / "img0001.nii.gz", _vol(rng))
    _write(btcv / "img0061.nii.gz", _vol(rng))
    _write(labs / "label_btcv_multiorgan" / "label0001.nii.gz", _vol(rng, labels=True))
    return ["--labels", str(labs), "--btcv-images", str(btcv)]


def _task051(src, rng):
    for c in ("1", "2"):
        _pair(rng, src / c / "data.nii.gz", src / c / "label.nii.gz")
    return []


SOURCES = {"Task017": _task017, "Task018": _task018, "Task046": _task046,
           "Task051": _task051, "Task055": _task055, "Task062": _task062,
           "Task064": _task064}
SOURCE_ARG = {"Task046": "pancreas", "Task062": "images"}


def _assert_same_task(port_dir, jax_dir) -> list[str]:
    """The two raw task folders hold the same files; NIfTI arrays (dtype
    included) and geometry equal, dataset.json equal; returns the files."""
    files = sorted(os.path.relpath(os.path.join(d, f), port_dir)
                   for d, _, fs in os.walk(port_dir) for f in fs)
    want = sorted(os.path.relpath(os.path.join(d, f), jax_dir)
                  for d, _, fs in os.walk(jax_dir) for f in fs)
    assert files == want
    for f in files:
        a, b = os.path.join(port_dir, f), os.path.join(jax_dir, f)
        if f.endswith(".nii.gz"):
            (x, gx), (y, gy) = read_nifti(a), read_nifti(b)
            assert x.dtype == y.dtype and np.array_equal(x, y), f
            assert (gx.spacing, gx.origin, gx.direction) == (gy.spacing, gy.origin,
                                                              gy.direction), f
        else:
            with open(a) as fa, open(b) as fb:
                assert json.load(fa) == json.load(fb), f
    return files


def test_converters_are_the_seven_of_the_jax_package():
    assert sorted(psc.CONVERTERS) == sorted(jsc.CONVERTERS) == sorted(SOURCES)
    assert psc.TASK062_EXCLUDED == jsc.TASK062_EXCLUDED
    assert psc.TASK046_LABEL_REMAP == jsc.TASK046_LABEL_REMAP


@pytest.mark.parametrize("task", sorted(SOURCES))
def test_converter_writes_the_jax_package_s_task(task, tmp_path, capsys):
    rng = np.random.RandomState(int(task[4:]))
    src = tmp_path / "src"
    extra = SOURCES[task](src, rng)
    # each package converts its own copy (Task062/046 write a DICOM
    # conversion beside their images)
    shutil.copytree(src, tmp_path / "src_jax")
    source = str(src / SOURCE_ARG.get(task, ""))
    out = convert_multitalent_sources.main([task, source.rstrip("/"), *extra,
                                            "--raw_data_base", str(tmp_path / "port")])
    jsrc = source.replace(str(src), str(tmp_path / "src_jax")).rstrip("/")
    kwargs = {"raw_data_base": str(tmp_path / "jax")}
    if task == "Task062":
        jout = jsc.CONVERTERS[task](jsrc, str(tmp_path / "src_jax" / "labels"), **kwargs)
    elif task == "Task046":
        jout = jsc.CONVERTERS[task](jsrc, str(tmp_path / "src_jax" / "zenodo"),
                                    btcv_images_dirs=(str(tmp_path / "src_jax" / "btcv"),),
                                    **kwargs)
    else:
        jout = jsc.CONVERTERS[task](jsrc, **kwargs)
    assert os.path.basename(out) == os.path.basename(jout)
    files = _assert_same_task(out, jout)
    assert "dataset.json" in files and any(f.startswith("labelsTr") for f in files)
    if task == "Task062":
        # the excluded case is dropped, the DICOM cases reoriented to RAS
        assert not any("PANCREAS_0007" in f for f in files)
        _, geom = read_nifti(os.path.join(out, "imagesTr", "PANCREAS_0003_0000.nii.gz"))
        np.testing.assert_allclose(geom.direction_matrix(), np.diag([-1.0, -1.0, 1.0]))
    capsys.readouterr()


@pytest.mark.parametrize("explicit", [True, False], ids=["explicit", "implicit"])
def test_dicom_series_reads_as_the_jax_reader_reads(explicit, tmp_path):
    d = tmp_path / "series"
    _make_series(str(d), explicit, seed=4)
    got, want = pdicom.read_dicom_series(d), jdicom.read_dicom_series(d)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert (got[1].spacing, got[1].origin, got[1].direction) == (
        want[1].spacing, want[1].origin, want[1].direction)
    f = sorted(d.iterdir())[0]
    assert pdicom.parse_dicom_file(f) == jdicom.parse_dicom_file(f)
    # a headerless stream (no preamble, no meta group): the VR sniff
    raw = f.read_bytes()
    body = raw[132 + len(_el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.1\x00"
                                      if explicit else b"1.2.840.10008.1.2\x00")):]
    (tmp_path / "bare").write_bytes(body)
    assert pdicom.parse_dicom_file(tmp_path / "bare") == jdicom.parse_dicom_file(
        tmp_path / "bare")


def test_dicom_undefined_length_sequences_and_tree(tmp_path):
    _dicom_tree(tmp_path / "tree")
    series = tmp_path / "tree" / "PANCREAS_0003" / "study" / "series"
    for f in sorted(series.iterdir()):
        assert pdicom.parse_dicom_file(f) == jdicom.parse_dicom_file(f)
    assert pdicom.find_dicom_series_dirs(tmp_path / "tree") == \
        jdicom.find_dicom_series_dirs(tmp_path / "tree")
    got = pdicom.convert_tcia_dicom_tree(tmp_path / "tree", tmp_path / "port")
    want = jdicom.convert_tcia_dicom_tree(tmp_path / "tree", tmp_path / "jax")
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    _assert_same_task(tmp_path / "port", tmp_path / "jax")
    # an unsupported transfer syntax raises in both
    bad = tmp_path / "bad.dcm"
    bad.write_bytes(b"\x00" * 128 + b"DICM"
                    + _el_explicit(0x0002, 0x0010, b"UI", b"1.2.840.10008.1.2.4.50\x00"))
    for mod in (pdicom, jdicom):
        with pytest.raises(ValueError, match="transfer syntax"):
            mod.parse_dicom_file(bad)


@pytest.mark.parametrize("direction", [
    (1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0),
    (0.0, 1.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0, 1.0),
    (0.0, 0.0, -1.0, 1.0, 0.0, 0.0, 0.0, -1.0, 0.0),
    (0.96, 0.28, 0.0, -0.28, 0.96, 0.0, 0.0, 0.0, -1.0)],
    ids=["identity", "xy-swap", "all-permuted", "oblique"])
def test_reorientation_is_the_jax_package_s(direction, tmp_path):
    rng = np.random.RandomState(5)
    arr = _vol(rng, shape=(3, 4, 5))
    geom = Geometry(spacing=(0.7, 0.8, 2.0), origin=(1.0, -2.0, 3.0), direction=direction)
    got, want = preo.reorient_to_ras(arr, geom), jreo.reorient_to_ras(arr, geom)
    assert np.array_equal(got[0], want[0])
    assert (got[1].spacing, got[1].origin, got[1].direction) == (
        want[1].spacing, want[1].origin, want[1].direction)
    for name in ("port", "jax"):
        _write(tmp_path / name / "a.nii.gz", arr, geom)
    preo.reorient_all_images_in_folder_to_ras(str(tmp_path / "port"))
    jreo.reorient_all_images_in_folder_to_ras(str(tmp_path / "jax"))
    _assert_same_task(tmp_path / "port", tmp_path / "jax")


def _msd_task(root, rng) -> str:
    """A Decathlon download: Task05_Prostate with 4D (2-modality) images,
    3D labels, one test case."""
    src = root / "Task05_Prostate"
    cases = ("prostate_00", "prostate_01")
    four_d = (2, *SHAPE)
    for c in cases:
        _write(src / "imagesTr" / f"{c}.nii.gz", (rng.randn(*four_d) * 50).astype(np.float32))
        _write(src / "labelsTr" / f"{c}.nii.gz", _vol(rng, labels=True))
    _write(src / "imagesTs" / "prostate_03.nii.gz", (rng.randn(*four_d)).astype(np.float32))
    ds = {"name": "PROSTATE", "modality": {"0": "T2", "1": "ADC"},
          "labels": {"0": "background", "1": "PZ", "2": "TZ"}, "numTraining": 2,
          "numTest": 1, "training": [{"image": f"./imagesTr/{c}.nii.gz",
                                      "label": f"./labelsTr/{c}.nii.gz"} for c in cases],
          "test": ["./imagesTs/prostate_03.nii.gz"]}
    (src / "dataset.json").write_text(json.dumps(ds))
    return str(src)


@pytest.mark.parametrize("renumber", [[], ["-output_task_id", "105"]],
                         ids=["task-id", "renumbered"])
def test_decathlon_split_is_the_jax_package_s(renumber, tmp_path, monkeypatch, capsys):
    src = _msd_task(tmp_path, np.random.RandomState(7))
    name = "Task105_Prostate" if renumber else "Task005_Prostate"
    for label, main in (("port", convert_decathlon_task.main), ("jax", jax_decathlon.main)):
        monkeypatch.setenv("nnUNet_raw_data_base", str(tmp_path / label))
        main(["-i", src, *renumber])
    port = tmp_path / "port" / "nnUNet_raw_data" / name
    files = _assert_same_task(port, tmp_path / "jax" / "nnUNet_raw_data" / name)
    assert sorted(f for f in files if f.startswith("imagesTr")) == [
        f"imagesTr/prostate_0{i}_000{m}.nii.gz" for i in (0, 1) for m in (0, 1)]
    capsys.readouterr()


def _pngs(folder) -> dict:
    return {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder))}


def test_task_pngs_are_the_jax_package_s_bytes(tmp_path, monkeypatch):
    """Raw (imagesTr/labelsTr) and preprocessed (the stage's npz) overlays
    of one task through both CLIs: the same PNG files, byte for byte."""
    rng = np.random.RandomState(8)
    raw = tmp_path / "raw" / "nnUNet_raw_data" / "Task004_Hippocampus"
    stage = tmp_path / "prep" / "Task004_Hippocampus" / "MTTPUData_plans_v2.1_stage0"
    stage.mkdir(parents=True)
    for i, case in enumerate(("hippocampus_001", "hippocampus_002", "hippocampus_003")):
        img = rng.standard_normal((8, 9, 10)).astype(np.float32)
        seg = np.zeros((8, 9, 10), np.uint8)
        seg[2 + i:5, 2:6, 1:7 - i] = 1 + i % 2
        seg[4, 6:8, 6:9] = 5 + i  # a label past the palette's start
        _write(raw / "imagesTr" / f"{case}_0000.nii.gz", img)
        _write(raw / "labelsTr" / f"{case}.nii.gz", seg)
        data = np.stack([img, np.where(seg > 0, seg, -1).astype(np.float32)])
        np.savez(stage / f"{case}.npz", data=data)
    monkeypatch.setenv("nnUNet_raw_data_base", str(tmp_path / "raw"))
    monkeypatch.setenv("nnUNet_preprocessed", str(tmp_path / "prep"))
    for label, main in (("port", plot_task_pngs.main), ("jax", jax_plot.main)):
        main(["-t", "4", "-o", str(tmp_path / label / "raw"), "--use_raw",
              "-num_processes", "2"])
        main(["-t", "Task004_Hippocampus", "-o", str(tmp_path / label / "prep"),
              "-num_processes", "2"])
    for kind in ("raw", "prep"):
        got = _pngs(tmp_path / "port" / kind)
        assert len(got) == 3 and got == _pngs(tmp_path / "jax" / kind)
        assert all(v.startswith(b"\x89PNG\r\n\x1a\n") for v in got.values())
    # the overlay itself, off the files
    img = rng.standard_normal((9, 10))
    seg = rng.randint(0, 15, (9, 10))
    assert np.array_equal(pplots.generate_overlay(img, seg, overlay_intensity=0.4),
                          jplots.generate_overlay(img, seg, overlay_intensity=0.4))
    assert pplots.select_slice(np.zeros((4, 2, 2))) == jplots.select_slice(np.zeros((4, 2, 2)))
