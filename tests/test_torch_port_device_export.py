"""The port's softmax device exports against the JAX package's, on the CPU:
bit-equal labels.

- `device_resample_argmax`: channel chunks of 8 resized trilinearly, a
  running argmax with a strict `>` (the earliest channel wins a tie, also
  across chunks). F.interpolate and jax.image.resize round the resized
  values differently (<= 1e-6 apart), so labels could differ only where two
  channels come that close; exact ties (equal channels, or voxels whose
  taps see equal channels) stay exact in both and go to the earliest.
- `device_argmax_resample_nearest`: argmax on the network's grid, the
  labelmap resized by jax.image.resize's nearest rule as XLA computes it,
  at non-integer scales where F.interpolate's "nearest" (and, at 2 -> 41,
  "nearest-exact") gives other labels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from multitalent_tpu.ops import device_export as jde
from multitalent_tpu_torch.ops import device_export as pde


def _probs(k: int, in_shape, seed: int) -> np.ndarray:
    """(K, Z, Y, X) fold-summed fp16 probabilities with exact ties: channel
    K-1 repeats channel 0 (across the 8-channel chunks where K > 8), and one
    corner block is equal in every channel."""
    rng = np.random.RandomState(seed)
    p = rng.rand(k, *in_shape).astype(np.float32) * 2
    p[-1] = p[0]
    p[:, :3, :3, :3] = 0.75
    return p.astype(np.float16)


def _jax_argmax(p_kzyx: np.ndarray, out_shape, fastest: bool) -> np.ndarray:
    probs = jnp.asarray(np.moveaxis(p_kzyx, 0, -1))
    fn = jde.device_argmax_resample_nearest if fastest else jde.device_resample_argmax
    return np.asarray(fn(probs, out_shape))


@pytest.mark.parametrize("k", [2, 3, 9, 17])
@pytest.mark.parametrize("in_shape,out_shape", [
    ((6, 7, 9), (11, 13, 17)),   # up-sampling
    ((11, 13, 17), (6, 7, 9)),   # down-sampling (no antialiasing in either)
    ((8, 10, 12), (12, 7, 12)),  # mixed, one axis unchanged
])
def test_resample_argmax_matches_jax(k, in_shape, out_shape):
    p = _probs(k, in_shape, seed=k)
    got = pde.device_resample_argmax(torch.from_numpy(p), out_shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == out_shape
    want = _jax_argmax(p, out_shape, fastest=False)
    np.testing.assert_array_equal(got.numpy(), want)
    # the tie between channel 0 and its copy goes to channel 0, and the
    # label K-1 never appears
    assert not (got.numpy() == k - 1).any()


@pytest.mark.parametrize("k", [2, 3, 9, 17])
@pytest.mark.parametrize("in_shape,out_shape", [
    ((7, 11, 13), (10, 17, 9)),
    ((2, 5, 10), (41, 11, 47)),
    ((12, 9, 9), (12, 6, 14)),
])
def test_argmax_resample_nearest_matches_jax(k, in_shape, out_shape):
    p = _probs(k, in_shape, seed=10 + k)
    got = pde.device_argmax_resample_nearest(torch.from_numpy(p), out_shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == out_shape
    np.testing.assert_array_equal(got.numpy(), _jax_argmax(p, out_shape, fastest=True))


@pytest.mark.parametrize("mode,n_in,n_out", [("nearest", 7, 10), ("nearest", 11, 17),
                                             ("nearest-exact", 2, 41),
                                             ("nearest-exact", 10, 47)])
def test_nearest_rule_is_not_f_interpolate(mode, n_in, n_out):
    """F.interpolate's nearest modes pick other source voxels at these
    scales; nearest_indices picks jax.image.resize's."""
    src = jnp.arange(n_in, dtype=jnp.int32)
    want = np.asarray(jax.image.resize(src, (n_out,), method="nearest"))
    np.testing.assert_array_equal(pde.nearest_indices(n_in, n_out).numpy(), want)
    theirs = F.interpolate(torch.arange(n_in, dtype=torch.float32)[None, None], size=n_out,
                           mode=mode)[0, 0].long().numpy()
    assert not np.array_equal(theirs, want)


def test_same_shape_is_a_plain_argmax():
    p = _probs(5, (4, 6, 5), seed=3)
    want = p.argmax(0)
    for fn in (pde.device_resample_argmax, pde.device_argmax_resample_nearest):
        np.testing.assert_array_equal(fn(torch.from_numpy(p), p.shape[1:]).numpy(), want)
