"""The port's cascade (training/cascade.py, the cascade's augmentation in
augment/pipeline.py, inference/validation.run_cascade_validation) against
the JAX package's, on the CPU, on the same seeded numpy inputs.

- remove_random_component: bit-equal for the same RandomState (the port
  labels with scipy's 6-connected labelling, numbered as the JAX package's
  native labeller numbers), on a patch with several components of a label
  and a label over max_coverage; the RandomState left in the same state;
- one_hot_prev_stage_channels: exact;
- CascadePatchSampler3D: three batches of one seed bit-equal, the
  component removal on every sample;
- the random binary morphology at structuring-element sizes 3 and 4 (the
  even one off-centre, as reduce_window's "SAME" pads it), with the JAX
  package's draws replayed: exact, borders included;
- the cascade's validation transform: exact; its augmentation with
  rotation, scaling, mirroring and the random morphology off and
  deterministic brightness and contrast on: the image at rtol 1e-5 / atol
  1e-5 (fp32 means in other orders, as test_torch_port_train_augment.py),
  the one-hots and targets exact;
- predict_next_stage and run_cascade_validation on a tiny two-stage task
  (a lowres GenericUNet at spacing 2, the full-resolution one at 1 reading
  the image and two one-hots) from the JAX trainers' weights, in fp32, the
  sliding windows in their exact mode: the `<case>_segFromPrevStage.npz`
  files and the validation NIfTIs equal (the probabilities differ in
  summation order only; the labels would differ only where two classes tie).
"""
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.augment import pipeline as JP
from multitalent_tpu.augment.params import default_3D_augmentation_params
from multitalent_tpu.data.dataset import load_dataset as jax_load_dataset
from multitalent_tpu.parallel import mesh
from multitalent_tpu.plans import Plans
from multitalent_tpu.preprocessing.preprocessor import sample_class_locations
from multitalent_tpu.training import cascade as jcascade
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch.augment import pipeline as PP
from multitalent_tpu_torch.data.dataset import load_dataset
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.training import cascade as pcascade
from multitalent_tpu_torch.training.trainers import TrainerV2

from test_torch_port_train_slice import port_plans
from test_training import make_preprocessed, tiny_plans

TOL = dict(rtol=1e-5, atol=1e-5)


def _cl(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _components_patch() -> np.ndarray:
    """Three components of label 1, two of label 2, one of label 3 over
    15% of the patch."""
    seg = np.zeros((12, 14, 16), np.uint8)
    seg[1:3, 1:3, 1:3] = 1
    seg[5:7, 8:10, 2:4] = 1
    seg[9:11, 1:2, 8:12] = 1
    seg[2:4, 10:13, 6:9] = 2
    seg[8:11, 8:10, 5:7] = 2
    seg[:, :, 13:] = 3
    return seg


@pytest.mark.parametrize("seed", range(6))
def test_remove_random_component_matches_jax(seed):
    seg = _components_patch()
    rj, rp = np.random.RandomState(seed), np.random.RandomState(seed)
    ref = jcascade.remove_random_component(seg, rj, p_per_label=0.7)
    got = pcascade.remove_random_component(seg, rp, p_per_label=0.7)
    np.testing.assert_array_equal(got, ref)
    assert rj.randint(1 << 30) == rp.randint(1 << 30)
    assert (got == 3).sum() == (seg == 3).sum()  # over max_coverage: never removed


def test_one_hot_prev_stage_channels_exact():
    prev = np.random.RandomState(1).randint(0, 4, (5, 6, 7)).astype(np.uint8)
    np.testing.assert_array_equal(pcascade.one_hot_prev_stage_channels(prev, 3),
                                  jcascade.one_hot_prev_stage_channels(prev, 3))


def test_cascade_sampler_matches_jax(tmp_path):
    make_preprocessed(tmp_path, n_cases=3, shape=(10, 20, 20))
    folder = tmp_path / "mtt_data_stage0"
    rng = np.random.RandomState(2)
    for i in range(3):
        prev = np.zeros((1, 10, 20, 20), np.uint8)
        for _ in range(6):  # small blobs of labels 1 and 2
            z, y, x = rng.randint(0, 8), rng.randint(0, 17), rng.randint(0, 17)
            prev[0, z:z + 2, y:y + 3, x:x + 3] = rng.randint(1, 3)
        np.savez_compressed(folder / f"case_{i:03d}_segFromPrevStage.npz", data=prev)
    kw = dict(corrupt=True, cc_p_per_sample=1.0, oversample_foreground_percent=0.33,
              pad_mode="constant", seed=5)
    js = jcascade.CascadePatchSampler3D(jax_load_dataset(str(folder)), (12, 16, 16),
                                        (8, 12, 12), 3, **kw)
    ps = pcascade.CascadePatchSampler3D(load_dataset(str(folder)), (12, 16, 16),
                                        (8, 12, 12), 3, **kw)
    for _ in range(3):
        ref, got = js.generate_train_batch(), ps.generate_train_batch()
        assert got["keys"] == ref["keys"]
        for k in ("data", "seg"):
            assert got[k].dtype == ref[k].dtype
            np.testing.assert_array_equal(got[k], ref[k])
        assert got["seg"].shape == (3, 2, 12, 16, 16) and got["seg"][:, 1].max() > 0


@pytest.mark.parametrize("size", [3, 4])
def test_binary_morphology_matches_reduce_window(size):
    """The JAX package's S_random_binary_morphology with its draws replayed
    into the port's binary_morphology, foreground on every border."""
    rng = np.random.RandomState(size)
    onehot = (rng.rand(4, 2, 7, 8, 9) < 0.3).astype(np.float32)
    onehot[:, :, 0], onehot[:, :, :, -1] = 1.0, 1.0
    key = jax.random.PRNGKey(11)
    ref = JP.S_random_binary_morphology(key, jnp.asarray(_cl(onehot)), p_per_sample=0.8,
                                        size=size, p_per_label=0.7)
    k_do, k_lab, k_op = jax.random.split(key, 3)
    do = np.array((jax.random.uniform(k_do, (4, 1)) < 0.8)
                  & (jax.random.uniform(k_lab, (4, 2)) < 0.7))
    dilate = np.array(jax.random.bernoulli(k_op, 0.5, (4, 2)))
    assert do.any() and not do.all() and (dilate & do).any() and (~dilate & do).any()
    got = PP.binary_morphology(torch.from_numpy(onehot), torch.from_numpy(do),
                               torch.from_numpy(dilate), size)
    np.testing.assert_array_equal(_cl(got.numpy()), np.asarray(ref))


def _cascade_batch(seed=3):
    rng = np.random.RandomState(seed)
    data = rng.randn(2, 1, 12, 14, 16).astype(np.float32)
    seg = np.stack([rng.randint(-1, 3, (2, 12, 14, 16)),
                    rng.randint(0, 3, (2, 12, 14, 16))], 1).astype(np.float32)
    return data, seg


def _params(**updates) -> dict:
    p = dict(default_3D_augmentation_params, p_rot=0.0, p_scale=0.0, p_gaussian_noise=0.0,
             p_gaussian_blur=0.0, p_brightness_mult=0.0, p_contrast=0.0, p_lowres=0.0,
             p_gamma_invert=0.0, p_gamma=0.0, do_mirror=False,
             mask_was_used_for_normalization={0: True})
    p.update(updates)
    return p


def test_cascade_val_transform_matches_jax():
    data, seg = _cascade_batch()
    scales = JP.ds_scales_from_pools([[2, 2, 2], [2, 2, 2]])
    final = (8, 10, 12)
    ref_d, ref_t = JP.make_cascade_val_transform_fn(final, scales, _params(), 1, 2)(
        jnp.asarray(data), jnp.asarray(seg))
    got_d, got_t = PP.make_cascade_val_transform_fn(final, scales, _params(), 1, 2)(
        torch.from_numpy(data), torch.from_numpy(seg))
    assert got_d.shape == (2, 3, *final)
    np.testing.assert_array_equal(_cl(got_d.numpy()), np.asarray(ref_d))
    for g, r in zip(got_t, ref_t, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_cascade_augment_matches_jax_without_rotation_or_scaling():
    """Rotation, scaling, mirroring and the morphology off; brightness and
    contrast on with degenerate ranges (the same in both packages): they
    touch the image channel only, the nonzero mask zeroes the image only."""
    data, seg = _cascade_batch(4)
    scales = JP.ds_scales_from_pools([[2, 2, 2], [2, 2, 2]])
    final = (8, 10, 12)
    params = _params(p_brightness_mult=1.0, brightness_mult_range=(1.2, 1.2), p_contrast=1.0,
                     contrast_range=(0.8, 0.8), cascade_random_binary_transform_p=0.0)
    ref_d, ref_t = JP.make_cascade_augment_fn(final, scales, params, 1, 2)(
        jax.random.PRNGKey(0), jnp.asarray(data), jnp.asarray(seg))
    got_d, got_t = PP.make_cascade_augment_fn(final, scales, params, 1, 2)(
        torch.from_numpy(data), torch.from_numpy(seg), torch.Generator().manual_seed(0))
    got_d, ref_d = _cl(got_d.numpy()), np.asarray(ref_d)
    assert got_d.shape == (2, *final, 3)
    np.testing.assert_allclose(got_d[..., :1], ref_d[..., :1], **TOL)
    np.testing.assert_array_equal(got_d[..., 1:], ref_d[..., 1:])
    assert not np.array_equal(got_d[..., :1], _cl(data)[:, 2:10, 2:12, 2:14])
    for g, r in zip(got_t, ref_t, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


# ------------------------------------------------------- the two-stage task
FULL, LOW = (12, 20, 24), (6, 10, 12)
KEYS = ("case_000", "case_001", "case_002")
MARGIN = (1, 2, 2)


def two_stage_plans() -> Plans:
    d = tiny_plans().to_dict()
    st = dict(d["plans_per_stage"][0], patch_size=[8, 16, 16], num_pool_per_axis=[1, 2, 2],
              pool_op_kernel_sizes=[[1, 2, 2], [2, 2, 2]], conv_kernel_sizes=[[3, 3, 3]] * 3)
    d["num_stages"] = 2
    d["plans_per_stage"] = {0: dict(st, current_spacing=(2.0, 2.0, 2.0)),
                            1: dict(st, current_spacing=(1.0, 1.0, 1.0))}
    return Plans.from_dict(d)


def write_two_stage_task(ddir: Path, keys=KEYS, identifier: str = "mtt_data") -> None:
    """Smooth phantoms (an image of blobs, labels 1 and 2) at the
    full-resolution grid FULL (stage 1, spacing 1) and at LOW (stage 0,
    every second voxel), each stage's properties with the export geometry
    (the cropped grid FULL, MARGIN inside the original volume), the ground
    truth under gt_segmentations/ and a splits_final.pkl (val: the last
    two cases)."""
    (ddir / "gt_segmentations").mkdir(parents=True, exist_ok=True)
    zz, yy, xx = np.meshgrid(*[np.linspace(-1, 1, s) for s in FULL], indexing="ij")
    original = tuple(f + 2 * m for f, m in zip(FULL, MARGIN))
    bbox = [[m, m + f] for m, f in zip(MARGIN, FULL)]
    for i, key in enumerate(keys):
        c = 0.15 * np.array([np.sin(i), np.cos(i), np.sin(2 * i)])
        r = (zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2
        seg = (r < 0.5).astype(np.float32) + (r < 0.15)
        image = (seg * 1.5 + 0.2 * np.random.RandomState(i).randn(*FULL)).astype(np.float32)
        for stage, (d, s, spacing) in enumerate(((image[::2, ::2, ::2], seg[::2, ::2, ::2], 2.0),
                                                 (image, seg, 1.0))):
            folder = ddir / f"{identifier}_stage{stage}"
            folder.mkdir(exist_ok=True)
            np.savez_compressed(folder / f"{key}.npz", data=np.stack([d, s]))
            save_pickle({"class_locations": sample_class_locations(s, [1, 2]),
                         "original_spacing": np.array([1.0, 1.0, 1.0]),
                         "spacing_after_resampling": np.array([spacing] * 3),
                         "size_after_cropping": FULL, "size_after_resampling": s.shape,
                         "crop_bbox": bbox, "original_size_of_raw_data": np.array(original),
                         "itk_spacing": (1.0, 1.0, 1.0), "itk_origin": (0.0, 0.0, 0.0),
                         "itk_direction": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)},
                        folder / f"{key}.pkl")
        gt = np.zeros(original, np.uint8)
        gt[tuple(slice(lo, hi) for lo, hi in bbox)] = seg
        write_nifti(ddir / "gt_segmentations" / f"{key}.nii.gz", gt,
                    Geometry(spacing=(1.0, 1.0, 1.0)))
    save_pickle([{"train": list(keys[:1]), "val": list(keys[1:])}] * 5,
                ddir / "splits_final.pkl")


@pytest.fixture(scope="module")
def cascade_runs(tmp_path_factory):
    """predict_next_stage of the JAX and the port's lowres TrainerV2 (the
    JAX init's weights) into two copies of the task, then each package's
    cascade validation from the JAX copy's next-stage files."""
    tmp = tmp_path_factory.mktemp("cascade")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    mp.setenv("MTTPU_SW_EXACT", "1")
    try:
        plans = two_stage_plans()
        write_two_stage_task(tmp / "jax_task")
        shutil.copytree(tmp / "jax_task", tmp / "port_task")
        jt0 = JaxTrainerV2(plans, 0, str(tmp / "jax_lowres"), str(tmp / "jax_task"), stage=0,
                           fp16=False)
        jt0.initialize(False)
        jt0.load_dataset()
        pt0 = TrainerV2(port_plans(plans), 0, str(tmp / "port_lowres"), str(tmp / "port_task"),
                        stage=0, fp16=False, device="cpu")
        pt0.initialize(False)
        pt0.network.load_state_dict(generic_unet_state_dict_from_flax(
            jax.device_get(jt0.state.params), num_pool=2))
        jcascade.predict_next_stage(jt0, str(tmp / "jax_task" / "mtt_data_stage1"))
        timings = pcascade.predict_next_stage(pt0, str(tmp / "port_task" / "mtt_data_stage1"))

        jt1 = jcascade.TrainerV2CascadeFullRes(plans, 0, str(tmp / "jax_cascade"),
                                               str(tmp / "jax_task"), stage=1, fp16=False)
        jt1.initialize(False)
        jt1.load_dataset()
        jt1.do_split()
        pt1 = pcascade.TrainerV2CascadeFullRes(port_plans(plans), 0, str(tmp / "port_cascade"),
                                               str(tmp / "jax_task"), stage=1, fp16=False,
                                               device="cpu")
        pt1.initialize(False)
        pt1.network.load_state_dict(generic_unet_state_dict_from_flax(
            jax.device_get(jt1.state.params), num_pool=2))
        jt1.validate(save_softmax=False)
        pt1.validate(save_softmax=False)
    finally:
        mp.undo()
    return {"tmp": tmp, "timings": timings, "pt1": pt1}


def test_predict_next_stage_matches_jax(cascade_runs):
    tmp = cascade_runs["tmp"]
    assert [t["case"] for t in cascade_runs["timings"]] == list(KEYS)
    assert [t["forwards"] for t in cascade_runs["timings"]] == [1] * 3  # no mirroring
    for key in KEYS:
        name = f"mtt_data_stage1/{key}_segFromPrevStage.npz"
        ref = np.load(tmp / "jax_task" / name)["data"]
        got = np.load(tmp / "port_task" / name)["data"]
        assert got.dtype == ref.dtype == np.uint8 and got.shape == (1, *FULL)
        assert len(np.unique(got)) > 1
        np.testing.assert_array_equal(got, ref)


def test_cascade_validation_matches_jax(cascade_runs):
    tmp, pt1 = cascade_runs["tmp"], cascade_runs["pt1"]
    assert pt1.network.input_channels == 3 and pt1.num_prev_classes == 2
    assert [t["forwards"] for t in pt1.validation_timings] == [8 * 8] * 2
    jax_val, port_val = tmp / "jax_cascade" / "fold_0" / "validation_raw", \
        tmp / "port_cascade" / "fold_0" / "validation_raw"
    names = sorted(f.name for f in jax_val.glob("*.nii.gz"))
    assert names == [f"{k}.nii.gz" for k in KEYS[1:]]
    assert sorted(f.name for f in port_val.glob("*.nii.gz")) == names
    for name in names:
        (ref, rg), (got, gg) = read_nifti(jax_val / name), read_nifti(port_val / name)
        assert got.shape == tuple(f + 2 * m for f, m in zip(FULL, MARGIN))
        assert len(np.unique(got)) > 1
        np.testing.assert_array_equal(got, ref)
        assert vars(gg) == vars(rg)
    assert (port_val / "summary.json").is_file()
