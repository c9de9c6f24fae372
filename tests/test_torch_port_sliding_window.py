"""The port's sliding window and device export against the JAX package's, on
the CPU.

The predictor is held to SlidingWindowPredictor(exact=True) (fp32 all through:
max |dp| <= 1e-4); the resize + threshold to device_resample_threshold_bits,
where jax.image.resize(linear, antialias=False) and F.interpolate(trilinear,
align_corners=False) must agree for up- and down-scaling.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.ops import device_export as jde
from multitalent_tpu.ops.sliding_window import SlidingWindowPredictor as JaxPredictor
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.ops import device_export as pde
from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor

POOLS = ((2, 2, 2), (1, 2, 2))
KERNELS = ((3, 3, 3),) * 3
PATCH = (8, 16, 16)


def test_sliding_window_matches_jax_exact_mode():
    """Sigmoid, 47 heads, 8-way mirror TTA, gaussian, step 0.5, on a volume
    that is not a multiple of the patch (z below one patch: padded)."""
    model = JaxGenericUNet(input_channels=1, base_num_features=4, num_classes=47,
                           pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                           deep_supervision=False, dtype=jnp.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((1, *PATCH, 1)))["params"])
    vol = np.random.RandomState(3).randn(1, 6, 21, 19).astype(np.float32)

    def apply_fn(p, batch):
        return model.apply({"params": p}, batch, deep_supervision=False)

    jp = JaxPredictor(apply_fn, PATCH, in_channels=1, num_classes=47, nonlin="sigmoid",
                      step_size=0.5, do_mirroring=True, mirror_axes=(0, 1, 2),
                      use_gaussian=True, exact=True)
    ref = jp(params, vol)

    net = GenericUNet(1, 4, 47, POOLS, KERNELS, dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(params, len(POOLS)))
    pp = SlidingWindowPredictor(PATCH, in_channels=1, num_classes=47, nonlin="sigmoid",
                                step_size=0.5, do_mirroring=True, mirror_axes=(0, 1, 2),
                                device="cpu", exact=True)
    got = pp.predict(net.eval(), vol)
    assert got.shape == ref.shape == (47, 6, 21, 19)
    assert got.dtype == torch.float32
    # 2 x 2 tiles (z padded to one patch) x 8 mirror combinations
    assert pp.forwards == 4 * 8
    assert np.abs(got.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("in_shape,out_shape", [
    ((6, 7, 9), (11, 13, 17)),   # up-scaling
    ((11, 13, 17), (6, 7, 9)),   # down-scaling (no antialiasing on either side)
    ((8, 10, 12), (12, 7, 12)),  # mixed, one axis unchanged
])
def test_resize_threshold_matches_jax(in_shape, out_shape):
    rng = np.random.RandomState(4)
    k = 11  # not a multiple of the 8-channel chunk
    probs_zyxk = rng.rand(*in_shape, k).astype(np.float32) * 2  # a 2-fold sum
    probs_kzyx = torch.from_numpy(np.ascontiguousarray(np.moveaxis(probs_zyxk, -1, 0)))

    resized = jax.image.resize(jnp.asarray(probs_zyxk), (*out_shape, k),
                               method="linear", antialias=False)
    np.testing.assert_allclose(pde.resize_linear(probs_kzyx, out_shape).numpy(),
                               np.moveaxis(np.asarray(resized), -1, 0), atol=1e-5)

    ref = np.asarray(jde.device_resample_threshold_bits(jnp.asarray(probs_zyxk),
                                                        out_shape, threshold=1.0))
    got = pde.device_resample_threshold_bits(probs_kzyx, out_shape, threshold=1.0)
    assert got.dtype == torch.bool and tuple(got.shape) == (k, *out_shape)
    near = np.abs(np.moveaxis(np.asarray(resized), -1, 0) - 1.0) < 1e-5
    assert np.array_equal(got.numpy()[~near], ref.astype(bool)[~near])

    order = list(range(k))[::-1]
    np.testing.assert_array_equal(
        pde.segmentation_from_regions_bits(got, order).numpy(),
        jde.segmentation_from_regions_bits(got.numpy(), order))


@pytest.mark.parametrize("props,expect", [
    ({"original_spacing": (1.5, 1.0, 1.0)}, True),
    ({"original_spacing": (5.0, 0.8, 0.8)}, False),
    ({"original_spacing": (1.0, 1.0, 1.0),
      "spacing_after_resampling": (4.0, 1.0, 1.0)}, False),
])
def test_export_gate_matches_jax(props, expect):
    assert pde.can_export_on_device(props) == jde.can_export_on_device(props) == expect
