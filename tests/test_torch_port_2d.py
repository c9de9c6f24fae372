"""The 2D plans in the port, on the CPU, against the JAX package.

A 2D plan's GenericUNet and residual-encoder UNet (base 8, two pools, 16^2
patches, deep supervision) carry the JAX modules' params through
io/from_jax.py (the norm affines moved off (1, 0)) and compute the same
logits in fp32; `spatial_augment_2d` resamples as the JAX function given the
JAX function's own draws; the 2D pipeline with nothing random, the 2D
trainer's augmentation settings, batch dice and sampler equal the JAX
package's; the port trains a 2D plan through the trainer and the train CLI,
restores its folders (`.model` and JAX `.ckpt`), and refuses 2D prediction
where the JAX package raises its ValueError.

Tolerances: logits atol 1e-4, rtol 1e-3 (fp32 convolutions summed in other
orders through ~10 convs with norms between them, as
tests/test_torch_port_unet.py); resampled data atol 1e-4 (bilinear weights
from fp32 coordinates computed in other orders); resampled seg: nearest
exact, bilinear-then-rounded equal on >= 99.9% of pixels (a value at .5 may
round either way); the pipeline with nothing random, settings, sampler
batches and restored weights exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.augment import pipeline as JP
from multitalent_tpu.augment import spatial as JS
from multitalent_tpu.augment.params import default_2D_augmentation_params
from multitalent_tpu.cli import configuration as jconfig
from multitalent_tpu.data import loader as jloader
from multitalent_tpu.data.dataset import load_dataset as jload_dataset
from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.models.residual_unet import ResidualEncoderUNet as JaxResencUNet
from multitalent_tpu.ops.sliding_window import SlidingWindowPredictor as JaxSlidingWindow
from multitalent_tpu.plans import Plans
from multitalent_tpu.training.trainers import TrainerV2 as JaxTrainerV2
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch import paths as ppaths
from multitalent_tpu_torch.augment import pipeline as PP
from multitalent_tpu_torch.augment import spatial as PS
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.cli import train as train_cli
from multitalent_tpu_torch.data import loader as ploader
from multitalent_tpu_torch.data.dataset import load_dataset as pload_dataset
from multitalent_tpu_torch.inference.model_restore import (checkpoint_state_dict,
                                                           load_model_and_checkpoint_files,
                                                           save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io import save_plans
from multitalent_tpu_torch.io.from_jax import (generic_unet_state_dict_from_flax,
                                               resenc_state_dict_from_flax)
from multitalent_tpu_torch.models.generic_unet import GenericUNet, build_unet_from_plans
from multitalent_tpu_torch.models.residual_unet import ResidualEncoderUNet
from multitalent_tpu_torch.training.trainers import TrainerV2, init_weights_he

from test_torch_port_train_slice import port_plans
from test_training import make_preprocessed, tiny_plans

POOLS = ((2, 2), (2, 2))
KERNELS = ((3, 3),) * 3
K = 3
PATCH = (16, 16)
TOL = dict(atol=1e-4, rtol=1e-3)


def _perturb(tree, rng):
    return {k: _perturb(v, rng) if isinstance(v, dict) else
            (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(np.float32)
            if k in ("scale", "bias") else np.asarray(v) for k, v in tree.items()}


def _x(seed=11, n=2):
    return np.random.RandomState(seed).randn(n, *PATCH, 1).astype(np.float32)


def _compare(jax_outs, port_outs):
    assert len(jax_outs) == len(port_outs) == len(POOLS)
    for r, g in zip(jax_outs, port_outs):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(np.moveaxis(g.detach().numpy(), 1, -1), np.asarray(r),
                                   **TOL)


def test_2d_generic_unet_matches_jax():
    jnet = JaxGenericUNet(input_channels=1, base_num_features=8, num_classes=K,
                          pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                          max_num_features=480, dtype=jnp.float32)
    x = _x()
    params = _perturb(jax.device_get(jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]),
                      np.random.RandomState(1))
    net = GenericUNet(1, 8, K, POOLS, KERNELS, max_num_features=480, dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(params, num_pool=len(POOLS)))
    assert isinstance(net.tu[0], torch.nn.ConvTranspose2d)
    assert net.kernel_launches_per_forward() == {"conv3d_same": 0, "conv3d_same_dual": 0}
    ref = jnet.apply({"params": params}, jnp.asarray(x), deep_supervision=True)
    got = net(torch.from_numpy(np.moveaxis(x, -1, 1)), deep_supervision=True)
    _compare(ref, got)


def test_2d_residual_unet_matches_jax():
    pools, nbe, nbd = ((1, 1),) + POOLS, (1, 2, 1), (1, 1)
    jnet = JaxResencUNet(input_channels=1, base_num_features=8, num_classes=K,
                         pool_op_kernel_sizes=pools, conv_kernel_sizes=KERNELS,
                         num_blocks_encoder=nbe, num_blocks_decoder=nbd, dtype=jnp.float32)
    x = _x(12)
    params = _perturb(jax.device_get(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]),
                      np.random.RandomState(2))
    net = ResidualEncoderUNet(1, 8, K, pools, KERNELS, nbe, nbd, dtype=torch.float32)
    net.load_state_dict(resenc_state_dict_from_flax(params, nbe, nbd))
    ref = jnet.apply({"params": params}, jnp.asarray(x), deep_supervision=True)
    got = net(torch.from_numpy(np.moveaxis(x, -1, 1)), deep_supervision=True)
    _compare(ref, got)


# ------------------------------------------------------------- augmentation
# in - final even on both axes: the warp's grid at angle 0 and scale 1
# lands on pixel centres, as the 3D path's center crop does
IN2, FINAL2 = (22, 24), (12, 14)


def _case2d(seed=0, channels=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(3, channels, *IN2).astype(np.float32),
            rng.randint(-1, 4, (3, *IN2)).astype(np.float32))


def _jax_draws(key, b, rot, scale_range, p_rot, p_scale):
    """The angle and scale of each sample as spatial_augment_2d draws them
    (spatial.py:330-339)."""
    k_rot, k_scale, k_angle, k_s = jax.random.split(key, 4)
    do_rot = jax.random.uniform(k_rot, (b,)) < p_rot
    do_scale = jax.random.uniform(k_scale, (b,)) < p_scale
    a = jnp.where(do_rot, jax.random.uniform(k_angle, (b,), minval=rot[0], maxval=rot[1]), 0.0)
    k1, k2, k3 = jax.random.split(k_s, 3)
    lo = jax.random.uniform(k1, (b,), minval=scale_range[0], maxval=1.0)
    hi = jax.random.uniform(k2, (b,), minval=1.0, maxval=scale_range[1])
    sc = jnp.where(jax.random.uniform(k3, (b,)) < 0.5, lo, hi)
    return np.asarray(a), np.asarray(jnp.where(do_scale, sc, 1.0))


@pytest.mark.parametrize("order_seg,p", [(1, 1.0), (0, 1.0), (1, 0.0), (1, 0.5)])
def test_spatial_augment_2d_matches_jax_given_its_draws(order_seg, p):
    """Every sample through map_coordinates at the JAX function's own angle
    and scale (p 0: angle 0 and scale 1, resampled all the same)."""
    data, seg = _case2d()
    key, rot, srange = jax.random.PRNGKey(5), (-0.6, 0.6), (0.7, 1.4)
    ref_d, ref_s = JS.spatial_augment_2d(key, jnp.asarray(np.moveaxis(data, 1, -1)),
                                         jnp.asarray(seg), FINAL2, scale_range=srange, rot=rot,
                                         p_rot=p, p_scale=p, order_seg=order_seg)
    angles, scales = _jax_draws(key, 3, rot, srange, p, p)
    for i in range(3):
        got_d, got_s = PS.warp_sample_2d(torch.from_numpy(data[i]), torch.from_numpy(seg[i]),
                                         FINAL2, float(angles[i]), float(scales[i]), order_seg)
        np.testing.assert_allclose(np.moveaxis(got_d.numpy(), 0, -1), np.asarray(ref_d[i]),
                                   atol=1e-4)
        if order_seg == 0:
            np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s[i]))
        else:
            assert np.mean(got_s.numpy() == np.asarray(ref_s[i])) >= 0.999
    got_d, got_s = PS.spatial_augment_2d(torch.from_numpy(data), torch.from_numpy(seg), FINAL2,
                                         generator=torch.Generator().manual_seed(0), rot=rot,
                                         scale_range=srange, p_rot=p, p_scale=p,
                                         order_seg=order_seg)
    assert got_d.shape == (3, 2, *FINAL2) and got_s.shape == (3, *FINAL2)


def test_2d_pipelines_match_jax_with_nothing_random():
    """make_augment_fn on a 2D patch with every probability 0 and no
    mirroring (the identity warp, the label clean-up, the DS targets) and
    make_val_transform_fn; then the mirror over the 2D axes (0, 1) replaying
    the JAX flips."""
    data, seg = _case2d(3, channels=1)
    params = dict(default_2D_augmentation_params, p_rot=0.0, p_scale=0.0,
                  p_gaussian_noise=0.0, p_gaussian_blur=0.0, p_brightness_mult=0.0,
                  p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0,
                  do_mirror=False, mask_was_used_for_normalization={0: True})
    scales = JP.ds_scales_from_pools([[2, 2], [2, 2]])
    assert PP.ds_scales_from_pools([[2, 2], [2, 2]]) == scales
    ref_d, ref_t = JP.make_augment_fn(FINAL2, scales, params)(
        jax.random.PRNGKey(0), jnp.asarray(data), jnp.asarray(seg[:, None]))
    got_d, got_t = PP.make_augment_fn(FINAL2, scales, params)(
        torch.from_numpy(data), torch.from_numpy(seg[:, None]), torch.Generator())
    vref_d, vref_t = JP.make_val_transform_fn(FINAL2, scales, params)(
        jnp.asarray(data), jnp.asarray(seg[:, None]))
    vgot_d, vgot_t = PP.make_val_transform_fn(FINAL2, scales, params)(
        torch.from_numpy(data), torch.from_numpy(seg[:, None]))
    for d, t, rd, rt, exact in ((got_d, got_t, ref_d, ref_t, False),
                                (vgot_d, vgot_t, vref_d, vref_t, True)):
        d = np.moveaxis(d.numpy(), 1, -1)
        if exact:
            np.testing.assert_array_equal(d, np.asarray(rd))
        else:  # the identity warp, bilinear at pixel centres
            np.testing.assert_allclose(d, np.asarray(rd), atol=1e-4)
        for g, r in zip(t, rt, strict=True):
            assert np.mean(g.numpy() == np.asarray(r)) >= 0.999
    assert tuple(params["mirror_axes"]) == (0, 1)
    key = jax.random.PRNGKey(7)
    d, s = data[:, :, :FINAL2[0], :FINAL2[1]], seg[:, :FINAL2[0], :FINAL2[1]]
    ref_d, ref_s = JS.mirror_augment(key, jnp.asarray(np.moveaxis(d, 1, -1)), jnp.asarray(s),
                                     mirror_axes=(0, 1))
    flips = np.stack([np.asarray(jax.random.uniform(k, (3,)) < 0.5)
                      for k in jax.random.split(key, 2)], 1)
    got_d, got_s = PS.mirror(torch.from_numpy(d), torch.from_numpy(s), torch.from_numpy(flips),
                             (0, 1))
    np.testing.assert_array_equal(np.moveaxis(got_d.numpy(), 1, -1), np.asarray(ref_d))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


# ------------------------------------------------------------- the trainer
def plans_2d(patch=PATCH, batch_size=2) -> Plans:
    d = tiny_plans().to_dict()
    d["plans_per_stage"] = {0: {
        "batch_size": batch_size, "patch_size": patch,
        "current_spacing": (3.0, 1.0, 1.0), "original_spacing": (3.0, 1.0, 1.0),
        "median_patient_size_in_voxels": (8, 24, 24),
        "num_pool_per_axis": [2, 2], "pool_op_kernel_sizes": [[2, 2], [2, 2]],
        "conv_kernel_sizes": [[3, 3]] * 3}}
    return Plans.from_dict(d)


def _set_up(cls, plans):
    t = cls(plans, 0)
    t.plans = plans
    t.process_plans(plans)
    t.setup_DA_params()
    return t


@pytest.mark.parametrize("patch", [(16, 16), (16, 40)])
def test_2d_trainer_settings_match_jax(patch):
    """setup_DA_params (the 2D defaults, the rotation narrowed at aspect >
    1.5), basic_generator_patch_size, the DS scales, the mirror axes and the
    CLI's batch dice of a 2D plan."""
    plans = plans_2d(patch)
    j, p = _set_up(JaxTrainerV2, plans), _set_up(TrainerV2, port_plans(plans))
    assert not p.threeD and not j.threeD
    assert set(p.data_aug_params) == set(j.data_aug_params)
    for k, v in j.data_aug_params.items():
        np.testing.assert_array_equal(np.asarray(p.data_aug_params[k], dtype=object),
                                      np.asarray(v, dtype=object), err_msg=k)
    assert tuple(p.data_aug_params["mirror_axes"]) == (0, 1)
    np.testing.assert_array_equal(p.basic_generator_patch_size, j.basic_generator_patch_size)
    assert p.deep_supervision_scales == j.deep_supervision_scales


@pytest.fixture
def task2d(tmp_path, monkeypatch):
    pre, results = tmp_path / "pre", tmp_path / "results"
    for var, path in (("nnUNet_preprocessed", pre), ("RESULTS_FOLDER", results)):
        monkeypatch.setenv(var, str(path))
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "1")
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("MTTPU_VAL_ITERS", "1")
    ddir = pre / "Task003_Liver"
    make_preprocessed(ddir, n_cases=3, shape=(6, 20, 20))
    save_plans(port_plans(plans_2d()), ddir / f"{ppaths.default_plans_identifier}_plans_2D.pkl")
    keys = [f"case_{i:03d}" for i in range(3)]
    save_pickle([{"train": keys[:2], "val": keys[2:]}] * 5, ddir / "splits_final.pkl")
    return tmp_path, ddir


def test_cli_configuration_and_sampler_of_a_2d_plan(task2d, monkeypatch):
    """get_default_configuration("2d"): the _plans_2D.pkl plans, the first
    stage, batch dice on, as the JAX CLI's; PatchSampler2D's batches equal
    the JAX sampler's."""
    tmp, ddir = task2d
    monkeypatch.setattr("multitalent_tpu.paths.preprocessing_output_dir",
                        lambda: str(tmp / "pre"))
    monkeypatch.setattr("multitalent_tpu.paths.network_training_output_dir",
                        lambda: str(tmp / "results" / "nnUNet"))
    got = train_cli.get_default_configuration("2d", "Task003_Liver", "TrainerV2")
    ref = jconfig.get_default_configuration("2d", "Task003_Liver", "TrainerV2")
    assert got[:5] == ref[:5] and got[3] is True and got[4] == 0
    assert got[0].endswith("_plans_2D.pkl") and got[-1] is TrainerV2
    folder = str(ddir / "mtt_data_stage0")
    kw = dict(oversample_foreground_percent=0.5, pad_mode="constant", seed=3)
    js = jloader.PatchSampler2D(jload_dataset(folder), (24, 24), PATCH, 2, **kw)
    ps = ploader.PatchSampler2D(pload_dataset(folder), (24, 24), PATCH, 2, **kw)
    for _ in range(3):
        jb, pb = js.generate_train_batch(), ps.generate_train_batch()
        assert jb["keys"] == pb["keys"]
        np.testing.assert_array_equal(jb["data"], pb["data"])
        np.testing.assert_array_equal(jb["seg"], pb["seg"])


def _jax_2d_value_error():
    """The JAX package's sliding window on a 2D network: begin_put pads and
    tiles three axes and raises the ValueError its train CLI's validation and
    its predict CLI reach."""
    predictor = JaxSlidingWindow(lambda p, b: b, PATCH, 1, K, mirror_axes=(0, 1))
    with pytest.raises(ValueError):
        predictor.begin_put(np.zeros((1, 6, 20, 20), np.float32))


def test_train_cli_2d_trains_writes_checkpoints_then_refuses_validation(task2d):
    """`cli.train 2d TrainerV2` trains two steps of the 2D network, writes
    its checkpoints, then reaches the validation's refusal, where the JAX
    CLI reaches its ValueError; `-pretrained_weights` and the `.model` and
    JAX `.ckpt` folders of the 2D network restore its weights; `predict -m
    2d` and prediction from the 2D folder refuse."""
    tmp, ddir = task2d
    with pytest.raises(NotImplementedError, match="2D models are not predicted"):
        train_cli.main(["2d", "TrainerV2", "Task003_Liver", "0", "--device", "cpu"])
    _jax_2d_value_error()
    model = tmp / "results" / "nnUNet" / "2d" / "Task003_Liver" / \
        f"TrainerV2__{ppaths.default_plans_identifier}"
    ckpt = model / "fold_0" / "model_final_checkpoint.model"
    assert ckpt.is_file() and (model / "plans.pkl").is_file()
    sd = torch.load(ckpt, weights_only=False)["state_dict"]
    assert sd["conv_blocks_context.0.blocks.0.conv.weight"].dim() == 4
    plans = port_plans(plans_2d())
    for folder, save in (("ref", save_model_folder), ("jax", save_jax_model_folder)):
        save(str(tmp / folder), plans, [sd], "TrainerV2", fp16=False)
        restored = load_model_and_checkpoint_files(str(tmp / folder), device="cpu")
        net = restored.networks[0]
        assert isinstance(net, GenericUNet) and net.ndim == 2 and restored.patch_size == PATCH
        for k, v in net.state_dict().items():
            assert torch.equal(v, sd[k]), (folder, k)
        ext = "model" if folder == "ref" else "ckpt"
        pre = checkpoint_state_dict(str(tmp / folder / "fold_0" / f"model_final_checkpoint.{ext}"),
                                    plans, 0)
        assert all(torch.equal(pre[k], v) for k, v in sd.items())
    with pytest.raises(NotImplementedError, match="2D models are not predicted"):
        predict_cli.main(["-i", str(tmp), "-o", str(tmp / "out"), "-t", "Task003_Liver",
                          "-m", "2d", "--device", "cpu"])
    from multitalent_tpu_torch.inference.predict import predict_cases
    with pytest.raises(NotImplementedError, match="2D models are not predicted"):
        predict_cases(str(tmp / "ref"), [[str(ddir / "x.nii.gz")]], [str(tmp / "o.nii.gz")],
                      None, device="cpu")


def test_2d_trainer_steps_and_validate_refuses(task2d):
    """The port's TrainerV2 on the 2D plan: PatchSampler2D, the 2D
    augmentation, two finite training steps of the He-initialised 2D
    network (a fresh build's init), and validate's refusal beside the JAX
    package's ValueError."""
    tmp, ddir = task2d
    t = TrainerV2(port_plans(plans_2d()), 0, str(tmp / "out"), str(ddir), device="cpu")
    t.initialize(True)
    batch = next(t.tr_gen)  # slices of the enlarged 2D patch
    assert batch["data"].shape == (2, 1, *t.basic_generator_patch_size)
    fresh = build_unet_from_plans(t.plans, 0, num_classes=t.num_classes)
    init_weights_he(fresh, torch.Generator().manual_seed(t.seed))
    assert all(torch.equal(v, fresh.state_dict()[k]) for k, v in t.network.state_dict().items())
    losses = [t.run_iteration(t.tr_gen) for _ in range(2)]
    assert np.isfinite(losses).all() and t.step == 2
    with pytest.raises(NotImplementedError, match="2D models are not predicted"):
        t.validate()
    _jax_2d_value_error()
    t.tr_gen.stop()
    t.val_gen.stop()
