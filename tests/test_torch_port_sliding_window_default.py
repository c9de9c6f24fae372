"""The port's sliding window in its default (non-exact) mode against the JAX
package's, on the CPU, and its exact mode against the loop it has always
run.

The default mode is the JAX package's production mode
(SlidingWindowPredictor(exact=False), what its predict and validation run
unless MTTPU_SW_EXACT=1): fp16 volume, gaussian tail clamped to 1e-4,
`tta_chunk` mirror combinations batched a forward, bf16 probabilities,
fp16 accumulators, fp16 result. Both packages run the same fp32 network
(io/from_jax) on the same seeded volume, with packed_apply=None on the JAX
side (the port has no packed layout).

Tolerance: both round at the same points, so a probability differs only
where the two networks' fp32 logits (summation order) fall on either side
of a bf16 rounding boundary: one bf16 ulp of a probability <= 1 (2^-8),
carried into the fp16 accumulators of up to 8 overlapping tiles (an fp16
ulp, 2^-11, at each read-modify-write and at the final rounding), so
max |dp| <= 2^-8 + 9 * 2^-11 < 1e-2; argmax and threshold labels agree on
>= 99.9% of the voxels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.ops import sliding_window as jsw
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.ops.sliding_window import (SlidingWindowPredictor,
                                                      get_gaussian_importance_map,
                                                      mirror_combinations)

POOLS = ((2, 2, 2), (1, 2, 2))
KERNELS = ((3, 3, 3),) * 3
PATCH = (8, 16, 16)
PROB_BOUND = 2.0 ** -8 + 9 * 2.0 ** -11
AGREE = 0.999


def _nets(num_classes: int, seed: int):
    model = JaxGenericUNet(input_channels=1, base_num_features=4, num_classes=num_classes,
                           pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                           deep_supervision=False, dtype=jnp.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                       jnp.zeros((1, *PATCH, 1)))["params"])
    net = GenericUNet(1, 4, num_classes, POOLS, KERNELS, dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(params, len(POOLS)))
    return model, params, net.eval()


def _volume(seed: int) -> np.ndarray:
    # z below one patch (padded), y and x off the step grid: 2 x 2 tiles
    return np.random.RandomState(seed).randn(1, 6, 21, 19).astype(np.float32)


@pytest.mark.parametrize("nonlin,num_classes", [("softmax", 3), ("sigmoid", 5)])
@pytest.mark.parametrize("tta_chunk", [1, 3, 4])
def test_default_mode_matches_jax(nonlin, num_classes, tta_chunk):
    model, params, net = _nets(num_classes, seed=tta_chunk)
    vol = _volume(tta_chunk)

    def apply_fn(p, batch):
        return model.apply({"params": p}, batch, deep_supervision=False)

    jp = jsw.SlidingWindowPredictor(apply_fn, PATCH, in_channels=1, num_classes=num_classes,
                                    nonlin=nonlin, tta_chunk=tta_chunk, exact=False,
                                    packed_apply=None)
    ref = jp(params, vol)
    pp = SlidingWindowPredictor(PATCH, in_channels=1, num_classes=num_classes, nonlin=nonlin,
                                device="cpu", tta_chunk=tta_chunk, exact=False)
    got = pp.predict(net, vol)
    assert got.dtype == torch.float16 and tuple(got.shape) == ref.shape
    # 4 tiles x 8 combinations, batched tta_chunk a call, the tail at its size
    assert pp.forwards == 4 * 8 and pp.net_calls == 4 * -(-8 // tta_chunk)
    got = got.float().numpy()
    dp = np.abs(got - ref)
    assert dp.max() <= PROB_BOUND, dp.max()
    if nonlin == "softmax":
        assert np.mean(got.argmax(0) == ref.argmax(0)) >= AGREE
    else:
        assert np.mean((got > 0.5) == (ref > 0.5)) >= AGREE


def test_default_mode_differs_from_exact_mode_as_jax_does():
    """The two modes' gap in the port is the JAX package's gap. The gap
    itself is no rounding noise where the clamped tail decides a voxel's
    blend (up to 0.13 here), but the port's gap and the JAX package's agree
    within PROB_BOUND plus the exact modes' 1e-4, and the softmax labels
    the modes flip are as many in both."""
    model, params, net = _nets(3, seed=7)
    vol = _volume(7)

    def apply_fn(p, batch):
        return model.apply({"params": p}, batch, deep_supervision=False)

    out = {}
    for exact in (False, True):
        jp = jsw.SlidingWindowPredictor(apply_fn, PATCH, 1, 3, exact=exact, packed_apply=None)
        pp = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", exact=exact)
        out[exact] = (jp(params, vol), pp.predict(net, vol).float().numpy())
    gap = [out[False][k] - out[True][k] for k in (0, 1)]
    assert np.abs(gap[1] - gap[0]).max() <= PROB_BOUND + 1e-4
    gap_jax = np.mean(out[False][0].argmax(0) != out[True][0].argmax(0))
    gap_port = np.mean(out[False][1].argmax(0) != out[True][1].argmax(0))
    assert abs(gap_jax - gap_port) <= 1 - AGREE, (gap_jax, gap_port)


@pytest.mark.parametrize("exact", [False, True])
def test_gaussian_is_the_jax_package_map(exact):
    """Default mode: the map clamped to 1e-4 (sliding_window.py:124-131);
    exact mode: the raw map. Both bit-equal to the JAX package's."""
    patch = (32, 48, 40)  # large enough for a tail below 1e-4
    want = jsw.get_gaussian_importance_map(patch)
    assert want.min() < 1e-4
    if not exact:
        want = np.maximum(want, 1e-4)
    got = SlidingWindowPredictor(patch, 1, 2, device="cpu", exact=exact).gaussian
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), want)


def test_exact_mode_reads_the_switch(monkeypatch):
    monkeypatch.delenv("MTTPU_SW_EXACT", raising=False)
    assert not SlidingWindowPredictor(PATCH, 1, 2, device="cpu").exact
    monkeypatch.setenv("MTTPU_SW_EXACT", "0")
    assert not SlidingWindowPredictor(PATCH, 1, 2, device="cpu").exact
    monkeypatch.setenv("MTTPU_SW_EXACT", "1")
    assert SlidingWindowPredictor(PATCH, 1, 2, device="cpu").exact
    assert not SlidingWindowPredictor(PATCH, 1, 2, device="cpu", exact=False).exact


def _exact_loop(net, vol_czyx, patch, num_classes, nonlin):
    """The port's sliding window as it ran before its default mode was
    ported: one forward a mirror combination, fp32 throughout."""
    sp = SlidingWindowPredictor(patch, 1, num_classes, device="cpu", exact=True)
    vol, slicer = sp.begin_put(vol_czyx)
    shape = tuple(vol.shape[2:])
    acc = torch.zeros((num_classes, *shape))
    weight_sum = torch.zeros(shape)
    combos = mirror_combinations((0, 1, 2))
    g = torch.from_numpy(get_gaussian_importance_map(patch))
    g_div = g / len(combos)
    pz, py, px = patch
    for z, y, x in sp.tile_coords(shape).tolist():
        tile = vol[:, :, z:z + pz, y:y + py, x:x + px]
        total = None
        for combo in combos:
            dims = [a + 2 for a in combo]
            logits = net(torch.flip(tile, dims) if dims else tile)
            logits = torch.flip(logits, dims) if dims else logits
            probs = (torch.sigmoid(logits.float()) if nonlin == "sigmoid"
                     else torch.softmax(logits.float(), dim=1))
            total = probs if total is None else total.add_(probs)
        acc[:, z:z + pz, y:y + py, x:x + px].addcmul_(total[0], g_div)
        weight_sum[z:z + pz, y:y + py, x:x + px] += g
    out = acc / torch.where(weight_sum == 0, 1.0, weight_sum)
    return out[(slice(None),) + tuple(slicer)]


@pytest.mark.parametrize("nonlin", ["softmax", "sigmoid"])
def test_exact_mode_is_unchanged(nonlin):
    _, _, net = _nets(4, seed=11)
    vol = _volume(11)
    pp = SlidingWindowPredictor(PATCH, 1, 4, nonlin=nonlin, device="cpu", exact=True)
    with torch.no_grad():
        got = pp.predict(net, vol)
        want = _exact_loop(net, vol, PATCH, 4, nonlin)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    assert pp.forwards == pp.net_calls == 4 * 8 and pp.puts == 1


class _Recorder(torch.nn.Module):
    """The network, recording each call's batch size; raises `error` for
    batches larger than `limit`."""

    def __init__(self, net, limit=None, error=None):
        super().__init__()
        self.net, self.limit, self.error, self.batches = net, limit, error, []

    def forward(self, x):
        self.batches.append(int(x.shape[0]))
        if self.limit is not None and x.shape[0] > self.limit:
            raise self.error
        return self.net(x)


def test_chunks_batch_the_combinations_with_a_natural_tail():
    _, _, net = _nets(3, seed=3)
    rec = _Recorder(net)
    pp = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", tta_chunk=3, exact=False)
    pp.predict(rec, _volume(3))
    assert rec.batches == [3, 3, 2] * 4


def test_out_of_memory_halves_the_chunk_and_keeps_it():
    _, _, net = _nets(3, seed=5)
    vol = _volume(5)
    want = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", tta_chunk=2,
                                  exact=False).predict(net, vol)
    rec = _Recorder(net, limit=2, error=torch.cuda.OutOfMemoryError("out of memory"))
    pp = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", tta_chunk=4, exact=False)
    got = pp.predict(rec, vol)
    assert torch.equal(got, want) and pp.tta_chunk == 2
    assert rec.batches[0] == 4 and set(rec.batches[1:]) == {2}
    rec.batches.clear()
    pp.predict(rec, vol)  # the next volume starts at the size that fitted
    assert set(rec.batches) == {2}


def test_other_errors_are_not_retried():
    _, _, net = _nets(3, seed=5)
    rec = _Recorder(net, limit=2, error=RuntimeError("a fault that is no OOM"))
    pp = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", tta_chunk=4, exact=False)
    with pytest.raises(RuntimeError, match="no OOM"):
        pp.predict(rec, _volume(5))
    assert rec.batches == [4] and pp.tta_chunk == 4


def test_one_put_serves_every_fold():
    """begin_put ships the volume once (fp16 in the default mode); each
    fold's predict(preput=) reuses it and gives what predict(volume) gives."""
    _, _, net_a = _nets(3, seed=1)
    _, _, net_b = _nets(3, seed=2)
    vol = _volume(1)
    pp = SlidingWindowPredictor(PATCH, 1, 3, device="cpu", exact=False)
    token = pp.begin_put(vol)
    assert token[0].dtype == torch.float16 and pp.puts == 1
    got = [pp.predict(n, preput=token) for n in (net_a, net_b)]
    assert pp.puts == 1
    want = [pp.predict(n, vol) for n in (net_a, net_b)]
    assert pp.puts == 3
    assert all(torch.equal(g, w) for g, w in zip(got, want))
