"""The port's on-card augmentation against the JAX package's, on the CPU.

The two packages draw from different random streams, so each transform runs
with p = 1 and a degenerate range (its sampled value is the same in both), or
with the JAX package's own draw replayed (mirror flips, gamma values), or
through the deterministic function both share (the warp at given angles and
scales). The rotation is held to the JAX package's exact-geometry path
(map_coordinates, MTTPU_SHEAR_WARP=0), whose function the port implements.

Tolerances: resampled data atol 1e-4 (trilinear weights from fp32
coordinates computed in different orders); nearest-neighbour seg exact;
intensity transforms rtol 1e-5 / atol 1e-5 (fp32 reductions in other
orders); the pipeline with nothing random exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.augment import intensity as JI
from multitalent_tpu.augment import pipeline as JP
from multitalent_tpu.augment import spatial as JS
from multitalent_tpu.augment.params import default_3D_augmentation_params
from multitalent_tpu_torch.augment import intensity as PI
from multitalent_tpu_torch.augment import pipeline as PP
from multitalent_tpu_torch.augment import spatial as PS

IN, FINAL = (13, 17, 19), (8, 10, 12)
TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _case(seed=0, channels=2):
    rng = np.random.RandomState(seed)
    data = rng.randn(2, channels, *IN).astype(np.float32)
    seg = rng.randint(-1, 5, (2, *IN)).astype(np.float32)
    return data, seg


def _cl(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _jax_warp(d_c, s, angles, scale, order_seg):
    """The JAX package's exact-geometry warp of one sample (spatial.py:266-274)."""
    r = JS.rotation_matrix_3d(*(jnp.float32(a) for a in angles))
    center = jnp.array([(n - 1) / 2.0 for n in IN], jnp.float32)
    coords = r @ (JS._centered_grid(FINAL) * jnp.asarray(scale, jnp.float32)[:, None]) \
        + center[:, None]
    d = np.stack([np.asarray(JS._warp_volume(jnp.asarray(v), coords, 1, 0.0))
                  for v in d_c]).reshape(len(d_c), *FINAL)
    so = np.asarray(JS._warp_volume(jnp.asarray(s), coords, order_seg, -1.0))
    if order_seg != 0:
        so = np.round(so)
    return d, so.reshape(FINAL)


@pytest.mark.parametrize("order_seg", [0, 1])
def test_rotation_warp_matches_map_coordinates(order_seg):
    data, seg = _case()
    angles, scale = (0.3, -0.2, 0.45), (1.2, 1.2, 1.2)
    ref_d, ref_s = _jax_warp(data[0], seg[0], angles, scale, order_seg)
    got_d, got_s = PS.warp_sample(torch.from_numpy(data[0]), torch.from_numpy(seg[0]),
                                  FINAL, angles, scale, order_seg)
    np.testing.assert_allclose(got_d.numpy(), ref_d, atol=1e-4)
    if order_seg == 0:
        np.testing.assert_array_equal(got_s.numpy(), ref_s)
    else:  # trilinear then round: a value at .5 may round either way
        assert np.mean(got_s.numpy() == ref_s) >= 0.999


def test_scale_warp_matches_the_separable_resample():
    data, seg = _case(1)
    scale = (0.8, 0.8, 0.8)
    ref_d, ref_s = JS._scale_resample(jnp.asarray(_cl(data[:1])[0]), jnp.asarray(seg[0]),
                                      jnp.asarray(scale), IN, FINAL, 0)
    got_d, got_s = PS.warp_sample(torch.from_numpy(data[0]), torch.from_numpy(seg[0]),
                                  FINAL, (0.0, 0.0, 0.0), scale, 0)
    np.testing.assert_allclose(_cl(got_d[None].numpy())[0], np.asarray(ref_d), atol=1e-4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


@pytest.mark.parametrize("p_rot", [0.0, 1.0])
def test_spatial_augment_branches(monkeypatch, p_rot):
    """p 0: the center crop at (in - final) // 2; p_rot 1 at a fixed angle per
    axis: the rotation of every sample."""
    monkeypatch.setenv("MTTPU_SHEAR_WARP", "0")
    data, seg = _case(2)
    rot = (0.25, 0.25)
    ref_d, ref_s = JS.spatial_augment(jax.random.PRNGKey(0), jnp.asarray(_cl(data)),
                                      jnp.asarray(seg), FINAL, rot_x=rot, rot_y=rot,
                                      rot_z=rot, p_rot=p_rot, p_scale=0.0, order_seg=0)
    got_d, got_s = PS.spatial_augment(torch.from_numpy(data), torch.from_numpy(seg), FINAL,
                                      generator=_gen(), rot_x=rot, rot_y=rot, rot_z=rot,
                                      p_rot=p_rot, p_scale=0.0, order_seg=0)
    assert got_d.shape == (2, 2, *FINAL) and got_s.shape == (2, *FINAL)
    np.testing.assert_allclose(_cl(got_d.numpy()), np.asarray(ref_d), atol=1e-4)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_mirror_replays_the_jax_flips():
    data, seg = _case(3)
    d, s = data[:, :, :8, :10, :12], seg[:, :8, :10, :12]
    key = jax.random.PRNGKey(7)
    ref_d, ref_s = JS.mirror_augment(key, jnp.asarray(_cl(d)), jnp.asarray(s))
    flips = np.stack([np.asarray(jax.random.uniform(k, (2,)) < 0.5)
                      for k in jax.random.split(key, 3)], 1)
    got_d, got_s = PS.mirror(torch.from_numpy(d), torch.from_numpy(s), torch.from_numpy(flips))
    np.testing.assert_array_equal(_cl(got_d.numpy()), np.asarray(ref_d))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(ref_s))


def test_downsample_seg_for_ds():
    seg = np.random.RandomState(4).randint(0, 5, (2, 8, 16, 16)).astype(np.float32)
    scales = JP.ds_scales_from_pools([[1, 2, 2], [2, 2, 2], [2, 2, 2]])
    assert PP.ds_scales_from_pools([[1, 2, 2], [2, 2, 2], [2, 2, 2]]) == scales
    ref = JS.downsample_seg_for_ds(jnp.asarray(seg), scales)
    got = PS.downsample_seg_for_ds(torch.from_numpy(seg), scales)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name,port,jax_fn,kw", [
    ("blur", PI.gaussian_blur, JI.gaussian_blur,
     dict(p=1.0, p_per_channel=1.0, sigma_range=(0.8, 0.8))),
    ("brightness_mult", PI.brightness_multiplicative, JI.brightness_multiplicative,
     dict(p=1.0, mult_range=(1.2, 1.2))),
    ("brightness_add", PI.brightness_additive, JI.brightness_additive,
     dict(p=1.0, mu=0.3, sigma=0.0)),
    ("contrast", PI.contrast_augmentation, JI.contrast_augmentation,
     dict(p=1.0, contrast_range=(0.8, 0.8))),
    ("lowres", PI.simulate_low_resolution, JI.simulate_low_resolution,
     dict(p=1.0, p_per_channel=1.0, zoom_range=(0.6, 0.6))),
])
def test_intensity_transform_matches_jax(name, port, jax_fn, kw):
    data = _case(5)[0][:, :, :8, :10, :12]
    ref = jax_fn(jax.random.PRNGKey(0), jnp.asarray(_cl(data)), **kw)
    got = port(torch.from_numpy(data), generator=_gen(), **kw)
    np.testing.assert_allclose(_cl(got.numpy()), np.asarray(ref), err_msg=name, **TOL)
    # p = 0 leaves the data as it is
    kw0 = {**kw, "p": 0.0}
    assert torch.equal(port(torch.from_numpy(data), generator=_gen(), **kw0),
                       torch.from_numpy(data))


@pytest.mark.parametrize("invert", [False, True])
def test_gamma_matches_jax_with_its_draws(invert):
    data = _case(6)[0][:, :, :8, :10, :12]
    key, gamma_range = jax.random.PRNGKey(3), (0.7, 1.5)
    ref = JI.gamma_augmentation(key, jnp.asarray(_cl(data)), p=1.0, gamma_range=gamma_range,
                                invert=invert)
    k1, k2, k3 = jax.random.split(jax.random.split(key)[1], 3)  # _gamma_core's draws
    pick_lo = jax.random.uniform(k1, (2, 2)) < 0.5
    gamma = jnp.where(pick_lo, jax.random.uniform(k2, (2, 2), minval=gamma_range[0], maxval=1.0),
                      jax.random.uniform(k3, (2, 2), minval=1.0, maxval=gamma_range[1]))
    got = PI.gamma_transform(torch.from_numpy(data), torch.from_numpy(np.asarray(gamma)),
                             invert)
    np.testing.assert_allclose(_cl(got.numpy()), np.asarray(ref), **TOL)


def test_gaussian_noise_has_the_drawn_scale():
    """Noise draws differ between the packages: the port's noise has mean 0
    and the sampled standard deviation (here fixed at 0.3)."""
    data = torch.zeros(2, 1, 16, 32, 32)
    got = PI.gaussian_noise(data, generator=_gen(), p=1.0, variance=(0.3, 0.3))
    assert abs(got.mean().item()) < 0.01 and abs(got.std().item() - 0.3) < 0.01
    assert torch.equal(PI.gaussian_noise(data, generator=_gen(), p=0.0), data)


@pytest.mark.parametrize("mask", [False, True])
def test_pipelines_match_jax_with_nothing_random(mask):
    """make_augment_fn with every probability 0 and no mirroring, and
    make_val_transform_fn: crop, the nonzero-mask zeroing (when normalisation
    used the mask), seg -1 -> 0, the DS targets."""
    data, seg = _case(7, channels=1)
    params = dict(default_3D_augmentation_params, p_rot=0.0, p_scale=0.0,
                  p_gaussian_noise=0.0, p_gaussian_blur=0.0, p_brightness_mult=0.0,
                  p_contrast=0.0, p_lowres=0.0, p_gamma_invert=0.0, p_gamma=0.0,
                  do_mirror=False, mask_was_used_for_normalization={0: mask})
    scales = JP.ds_scales_from_pools([[2, 2, 2], [2, 2, 2]])
    final = (8, 10, 12)
    ref_d, ref_t = JP.make_augment_fn(final, scales, params)(
        jax.random.PRNGKey(0), jnp.asarray(data), jnp.asarray(seg[:, None]))
    got_d, got_t = PP.make_augment_fn(final, scales, params)(
        torch.from_numpy(data), torch.from_numpy(seg[:, None]), _gen())
    vref_d, vref_t = JP.make_val_transform_fn(final, scales, params)(
        jnp.asarray(data), jnp.asarray(seg[:, None]))
    vgot_d, vgot_t = PP.make_val_transform_fn(final, scales, params)(
        torch.from_numpy(data), torch.from_numpy(seg[:, None]))
    for d, t, rd, rt in ((got_d, got_t, ref_d, ref_t), (vgot_d, vgot_t, vref_d, vref_t)):
        np.testing.assert_array_equal(_cl(d.numpy()), np.asarray(rd))
        for g, r in zip(t, rt, strict=True):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_full_augmentation_runs_every_transform():
    """The default moreDA parameters with every probability raised to 1: all
    transforms run, the outputs keep their shapes, finite, labels valid."""
    data, seg = _case(8, channels=1)
    params = dict(default_3D_augmentation_params, order_seg=0, do_additive_brightness=True)
    for k in ("p_rot", "p_scale", "p_gaussian_noise", "p_gaussian_blur",
              "p_brightness_mult", "p_contrast", "p_lowres", "p_gamma_invert", "p_gamma",
              "additive_brightness_p_per_sample"):
        params[k] = 1.0
    scales = PP.ds_scales_from_pools([[2, 2, 2], [2, 2, 2]])
    d, t = PP.make_augment_fn(FINAL, scales, params)(
        torch.from_numpy(data), torch.from_numpy(seg[:, None]), _gen(9))
    assert d.shape == (2, 1, *FINAL) and torch.isfinite(d).all()
    assert [tuple(x.shape) for x in t] == [(2, 8, 10, 12), (2, 4, 5, 6)]
    assert set(torch.unique(t[0]).tolist()) <= set(range(5))
