"""The spatial ("space") axis of the port (parallel/mesh.py) on the CPU.

- The policy: the port's `plan_batch_sharding` against the JAX package's
  over the 8 CPU devices of tests/conftest.py, on the cases of
  tests/test_parallel_training.py and the flagship's global batch of 4 and
  of 2 on 8 ranks. Where the global batch is at least the rank count the
  port keeps its remainder split (the JAX policy would split 5 over 2 into
  data 1 x space 2).
- The halo exchange: two gloo ranks (tests/test_torch_port_space_ranks.py,
  jax-free) each take their slab of one sample along the split axis and
  run kernel A's conv, kernel B's conv on (up, skip), a stride-2 conv and a
  Cin=1 conv on cuDNN's route, and the instance norm, forward and backward,
  in both exchange forms (point-to-point, and the all-reduce that gloo uses
  for CUDA tensors): the slabs' outputs and input gradients put together,
  and the parameters' gradients summed over the ranks, equal one process on
  the whole tensors within fp32 rounding (atol 1e-5 + rtol 1e-4, the
  slice's bounds in fp32: the order of the sums differs).
- The networks: a GenericUNet and a residual-encoder UNet at 8 base
  features over a 8x8x24 volume (x 24 -> 12 -> 6 -> 3: the bottleneck does
  not divide over 2 and is gathered), deep-supervised, forward and
  backward on the two ranks' slabs against one process: each output and
  gradient within 1e-5 of its largest magnitude (the parameters' of the
  network's largest: a conv bias before a norm has gradient 0 up to it).
- The losses under a level's share: `multitalent_loss` and `dc_and_ce_loss`
  with and without batch Dice, on a level that splits and on one that
  computes whole, equal one process (rtol 1e-5 on the values, the same
  bounds on the logits' gradients).
"""
import jax
import numpy as np
import pytest
import torch

from multitalent_tpu.parallel.mesh import plan_batch_sharding as jax_plan
from multitalent_tpu_torch.parallel import mesh

from test_torch_port_space_ranks import nets, run_nets, run_ops, run_space_ops

FLAGSHIP = (96, 192, 192)
CASES = [(8, FLAGSHIP, 8), (4, FLAGSHIP, 8), (2, FLAGSHIP, 8), (3, (8, 16, 16), 8),
         (2, (7, 9, 11), 4), (1, FLAGSHIP, 8), (3, (7, 9, 11), 8), (1, (8, 16, 24), 2)]


@pytest.mark.parametrize("bs,patch,world", CASES)
def test_policy_matches_jax(bs, patch, world):
    """data, space, axis and the fallback as the JAX package plans them; a
    JAX plan of None (one device) is one rank here, the rest idle."""
    ours = mesh.plan_batch_sharding(bs, patch, world)
    theirs = jax_plan(bs, patch, devices=jax.devices()[:world])
    if theirs is None:
        assert (ours.data, ours.space, ours.ranks) == (1, 1, 1)
        assert "WARNING" in ours.description and f"{world - 1} idle" in ours.description
        return
    shape = dict(theirs.mesh.shape)
    assert (ours.data, ours.space) == (shape["data"], shape.get("space", 1))
    assert ours.space_axis == theirs.space_axis
    assert ("idle" in ours.description) == ("idle" in theirs.description)
    assert ours.ranks == int(np.prod(list(shape.values())))


def test_flagship_plans():
    """Batch 4 on 8 ranks: data 4 x space 2 along x (192 -> 96 a rank);
    batch 2 on 8: data 2 x space 4; rank r at (r // space, r % space)."""
    four = mesh.plan_batch_sharding(4, FLAGSHIP, 8)
    assert (four.data, four.space, four.space_axis) == (4, 2, 2)
    assert [four.coords(r) for r in range(8)] == [(r // 2, r % 2) for r in range(8)]
    two = mesh.plan_batch_sharding(2, FLAGSHIP, 8)
    assert (two.data, two.space, two.space_axis) == (2, 4, 2)


def test_remainder_split_where_the_batch_covers_the_ranks():
    """5 over 2 ranks: the port splits 3 + 2 (data-parallel), where the
    JAX policy plans data 1 x space 2 (ROADMAP queue 3)."""
    ours = mesh.plan_batch_sharding(5, FLAGSHIP, 2)
    assert (ours.data, ours.space, ours.space_axis) == (2, 1, None)
    assert dict(jax_plan(5, FLAGSHIP, devices=jax.devices()[:2]).mesh.shape) == {
        "data": 1, "space": 2}
    assert mesh.plan_batch_sharding(4, FLAGSHIP, 1) is None


def _spec(rng):
    x = rng.standard_normal((1, 8, 6, 8, 8)).astype(np.float32)
    upstream = {name: torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                for name, shape in (("A", (1, 8, 6, 8, 8)), ("B", (1, 8, 6, 8, 8)),
                                    ("strided", (1, 8, 3, 4, 4)), ("first", (1, 8, 6, 8, 8)),
                                    ("norm", (1, 8, 6, 8, 8)))}
    labels = rng.integers(0, 3, (2, 4, 6, 8))
    return {"seed": 5, "batch": 1, "forms": ("p2p", "collective"),
            "x": torch.from_numpy(x).contiguous(memory_format=torch.channels_last_3d),
            "skip": torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32)),
            "upstream": upstream,
            "norm_w": torch.from_numpy(rng.uniform(0.5, 1.5, 8).astype(np.float32)),
            "norm_b": torch.from_numpy(rng.standard_normal(8).astype(np.float32)),
            "logits": torch.from_numpy(rng.standard_normal((2, 3, 4, 6, 8)).astype(np.float32)),
            "labels": torch.from_numpy(labels),
            "valid": torch.tensor([[1.0, 1.0, 0.0], [1.0, 0.0, 1.0]]),
            "region_matrix": torch.tensor([[0.0, 0, 0], [1, 0, 1], [0, 1, 1]]),
            "volume": torch.from_numpy(rng.standard_normal((1, 1, 8, 8, 24)).astype(np.float32)),
            "volume_upstream": {name: [torch.from_numpy(rng.standard_normal(
                (1, 3, 8 >> k, 8 >> k, 24 >> k)).astype(np.float32)) for k in range(3)]
                for name in ("generic", "resenc")}}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    spec = _spec(np.random.default_rng(0))
    one = run_ops(spec, spec["x"], spec["skip"], None)
    from test_torch_port_space_ranks import run_losses
    one["nets"] = run_nets(spec, None)
    return spec, one, run_losses(spec, None), run_space_ops(
        spec, tmp_path_factory.mktemp("space_ops"), 2)


def _close(a, b):
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("form", ["p2p", "collective"])
@pytest.mark.parametrize("op", ["A", "B", "strided", "first", "norm"])
def test_slabs_match_one_process(ranks, form, op):
    spec, one, _, got = ranks
    assert [g["coords"] for g in got] == [(0, 0, 2, 2), (0, 1, 2, 2)]
    r0, r1 = (g[form][op] for g in got)
    _close(torch.cat([r0["y"], r1["y"]], 4), one[op]["y"])
    _close(torch.cat([r0["dx"], r1["dx"]], 4), one[op]["dx"])
    if op == "B":
        _close(torch.cat([r0["dskip"], r1["dskip"]], 4), one[op]["dskip"])
    for a, b, whole in zip(r0["dparams"], r1["dparams"], one[op]["dparams"]):
        _close(a + b, whole)


def test_each_rank_sends_one_plane_a_side(ranks):
    """Each rank's bytes sent, in both forms: kernels A (one input) and B
    (two) a boundary plane to its one neighbour forward and one back; the
    stride-2 conv the left plane alone (the first rank sends it forward, the
    second its gradient back); the Cin=1 conv one 1-channel plane each way;
    the norm its two pooled statistics forward and back."""
    spec, _, _, got = ranks
    plane = 8 * 6 * 8 * 4  # 8 channels x 6 x 8, fp32
    for g in got:
        for form in spec["forms"]:
            assert g[form]["sent"] == {"halo": plane * (2 + 4 + 1) + 2 * plane // 8,
                                       "stats": 4 * 8 * 4}


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("batch_dice", [True, False])
def test_losses_take_the_level_s_share(ranks, split, batch_dice):
    spec, _, whole, got = ranks
    ref = whole[(True, batch_dice)]
    r0, r1 = (g["losses"][(split, batch_dice)] for g in got)
    for key in ("multitalent", "dc_and_ce"):
        assert r0[key] == r1[key]
        np.testing.assert_allclose(r0[key], ref[key], rtol=1e-5)
    for key in ("grad", "grad_dc"):
        if split:
            _close(torch.cat([r0[key], r1[key]], 4), ref[key])
        else:
            _close(r0[key] + r1[key], ref[key])


@pytest.mark.parametrize("name", ["generic", "resenc"])
def test_networks_on_slabs_match_one_process(ranks, name):
    """Every deep-supervision output put together from the slabs (the
    levels of x 24, 12, 6 split), the input's gradient, and each
    parameter's gradient summed over the ranks (the bottleneck's convs run
    whole on both ranks, from the gathered level 2)."""
    _, one, _, got = ranks
    r0, r1 = (g["nets"][name] for g in got)
    for a, b, whole in zip(r0["ys"], r1["ys"], one["nets"][name]["ys"]):
        _close_to_scale(torch.cat([a, b], 4), whole)
    _close_to_scale(torch.cat([r0["dx"], r1["dx"]], 4), one["nets"][name]["dx"])
    whole = one["nets"][name]["dparams"]
    assert r0["dparams"].keys() == whole.keys() == set(dict(nets(0)[name].named_parameters()))
    scale = max(float(v.abs().max()) for v in whole.values())
    for k, v in whole.items():
        _close_to_scale(r0["dparams"][k] + r1["dparams"][k], v, scale)
    assert {"halo", "stats", "gather"} <= got[0]["nets_sent"].keys()


def _close_to_scale(a, b, scale=None):
    """Within 1e-5 of the reference's largest magnitude (or `scale`): the
    networks' deep sums reorder over the slabs, and a conv's bias before its
    norm has gradient 0 up to that rounding."""
    scale = float(b.abs().max()) if scale is None else scale
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5 * scale, rtol=0)
