"""The port's MedNeXt (models/mednext.py) against the JAX package's, on the CPU.

The same flax params go through io/from_jax.mednext_state_dict_from_flax
into the port; the same seeded numpy inputs go through both. fp32
throughout. The blocks' params come from the JAX module's init; the whole
net's from the port's init (the JAX module's initialisers) through
io/torch_convert.convert_mednext_state_dict, which spares XLA:CPU the
compile of the flax init.

- each block mode (plain, down, up; with and without the residual) alone:
  atol 1e-5 (a few fp32 sums in other orders);
- the whole net at n_channels 4, exp_r 2 and one block a stage, as
  tests/test_residual_unet.py builds it, on a 16^3 and a 32^3 input: the
  five deep-supervision outputs at atol 1e-4 / rtol 1e-3, as the port's
  UNet tests hold logits;
- the gradient of a loss over the five outputs with respect to every
  parameter against jax.grad: in norm, rtol 1e-3 per tensor (the biases of
  the plain and down blocks' depthwise convs, whose gradient the norm after
  them makes 0 up to rounding, below 1e-4 in both);
- the bridge both ways bit-exact, and a network built from the weights
  alone (model_restore.build_network);
- MultiTalentTrainerMedNeXt against the JAX trainer from the same weights on
  the same three host batches, as test_torch_port_resenc_train.py holds the
  resenc trainer (losses rtol 1e-5; every parameter after step 3 at atol
  2e-6 + rtol 1e-4; the head of loss weight 0, out4, unchanged in the port).
  Both trainers build the tiny net (n_channels 4, exp_r 2, one block a
  stage) in place of their 32-channel default.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.models import mednext as jmednext
from multitalent_tpu.parallel import mesh
from multitalent_tpu.training.multitalent import (
    MultiTalentTrainerMedNeXt as JaxMultiTalentTrainerMedNeXt)
from multitalent_tpu_torch.inference.model_restore import (build_network,
                                                           is_mednext_state_dict)
from multitalent_tpu_torch.io.from_jax import mednext_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_mednext_state_dict, mednext_block_rows
from multitalent_tpu_torch.models import mednext as pmednext
from multitalent_tpu_torch.training import multitalent as pmultitalent

from test_torch_port_train_slice import NO_AUG, port_plans, three_batches
from test_training import tiny_plans

TINY = dict(n_channels=4, exp_r=(2,) * 9, block_counts=(1,) * 9)


def _cl(x: np.ndarray) -> np.ndarray:
    return np.moveaxis(x, 1, -1)


def _tiny_jax(n_classes=3):
    return jmednext.MedNeXt(in_channels=1, n_classes=n_classes, remat=False,
                            dtype=jnp.float32, **TINY)


def _tiny_port(n_classes=3):
    return pmednext.MedNeXt(1, n_classes=n_classes, dtype=torch.float32, **TINY)


@pytest.mark.parametrize("mode,cin,features", [("plain", 4, 4), ("down", 4, 8), ("up", 8, 4)])
@pytest.mark.parametrize("do_res", [True, False])
def test_block_matches_jax(mode, cin, features, do_res):
    x = np.random.RandomState(1).randn(2, cin, 6, 8, 10).astype(np.float32)
    jblock = jmednext.MedNeXtBlock(features, 3, 3, do_res=do_res, mode=mode, dtype=jnp.float32)
    params = jblock.init(jax.random.PRNGKey(2), jnp.asarray(_cl(x)))["params"]
    params = jax.tree_util.tree_map(  # non-zero biases and norm params
        lambda a: a + 0.1 * np.random.RandomState(a.size).randn(*a.shape).astype(np.float32),
        params)
    ref = np.asarray(jblock.apply({"params": params}, jnp.asarray(_cl(x))))
    block = pmednext.MedNeXtBlock(cin, features, 3, 3, do_res, mode)
    block.load_state_dict(mednext_state_dict_from_flax(
        jax.device_get(params), mednext_block_rows(mode, do_res)))
    with torch.no_grad():
        got = block(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape[2:] == {"plain": (6, 8, 10), "down": (3, 4, 5),
                             "up": (12, 16, 20)}[mode]
    np.testing.assert_allclose(_cl(got), ref, atol=1e-5)


def _port_init_params(in_channels=1, n_classes=3, seed=0) -> dict:
    """The tiny net's params from the port's init, as the JAX module's tree."""
    net = pmednext.MedNeXt(in_channels, n_classes=n_classes, dtype=torch.float32, **TINY)
    net.init_weights(torch.Generator().manual_seed(seed))
    return convert_mednext_state_dict(net.state_dict())


@pytest.fixture(scope="module")
def nets():
    """The tiny JAX MedNeXt and its params (the port's init, biases and
    norms moved off their init), and the port's network loaded from them."""
    jnet = _tiny_jax()
    params = jax.device_get(jax.tree_util.tree_map(
        lambda a: a + 0.05 * np.random.RandomState(a.size % 97).randn(*a.shape).astype(
            np.float32), _port_init_params()))
    net = _tiny_port()
    net.load_state_dict(mednext_state_dict_from_flax(params))
    return jnet, params, net


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 32, 32)])
def test_network_outputs_match_jax(nets, shape):
    jnet, params, net = nets
    x = np.random.RandomState(3).randn(1, 1, *shape).astype(np.float32)
    ref = jax.jit(lambda p, v: jnet.apply({"params": p}, v))(params, jnp.asarray(_cl(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(x), deep_supervision=True)
        single = net(torch.from_numpy(x))
    assert len(got) == len(ref) == 5
    for lvl, (g, r) in enumerate(zip(got, ref)):
        assert g.shape[2:] == tuple(s // 2 ** lvl for s in shape)
        np.testing.assert_allclose(_cl(g.numpy()), np.asarray(r), atol=1e-4, rtol=1e-3,
                                   err_msg=f"out{lvl}")
    assert torch.equal(single, got[0])


def test_gradients_match_jax(nets):
    """d/dparams of sum_l mean(out_l * t_l) over the five outputs, training
    mode (the per-block recompute) against jax.grad of the same."""
    jnet, params, net = nets
    rng = np.random.RandomState(4)
    x = rng.randn(2, 1, 16, 16, 16).astype(np.float32)
    targets = [rng.randn(2, 3, *(16 // 2 ** lvl,) * 3).astype(np.float32) for lvl in range(5)]

    def jax_loss(p):
        outs = jnet.apply({"params": p}, jnp.asarray(_cl(x)))
        return sum(jnp.mean(o * jnp.asarray(_cl(t))) for o, t in zip(outs, targets))

    ref = mednext_state_dict_from_flax(jax.device_get(jax.jit(jax.grad(jax_loss))(params)))
    net.train()
    net.zero_grad()
    outs = net(torch.from_numpy(x), deep_supervision=True)
    sum((o * torch.from_numpy(t)).mean() for o, t in zip(outs, targets)).backward()
    net.eval()
    for k, p in net.named_parameters():
        if k.endswith("dwconv.bias") and not k.startswith("up"):
            # the norm right after the depthwise conv removes a per-channel
            # constant (not in the up blocks, whose zero pad the bias skips):
            # this gradient is 0 up to fp32 rounding in both
            assert p.grad.abs().max() < 1e-4 and ref[k].abs().max() < 1e-4, k
            continue
        # the bridge's weight layout applied to the gradients: same keys
        diff = float(torch.linalg.vector_norm(p.grad - ref[k]))
        assert diff <= 1e-3 * float(torch.linalg.vector_norm(ref[k])) + 1e-7, k


def test_bridge_round_trip_and_build_from_weights(nets):
    """flax -> torch -> flax bit-exact; build_network reads width, exp_r,
    block counts and kernel from the weights alone."""
    _, params, net = nets
    back = convert_mednext_state_dict(net.state_dict())
    leaves = jax.tree_util.tree_leaves_with_path(params)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for path, leaf in leaves:
        node = back
        for p in path:
            node = node[p.key]
        assert node.dtype == np.float32 and np.array_equal(node, leaf), path
    sd = net.state_dict()
    assert is_mednext_state_dict(sd) and is_mednext_state_dict({"module." + k: v
                                                                for k, v in sd.items()})
    built = build_network(sd, port_plans(tiny_plans()), 0, 3, torch.float32)
    assert isinstance(built, pmednext.MedNeXt)
    assert (built.n_channels, built.exp_r, built.block_counts, built.kernel_size) == (
        4, (2,) * 9, (1,) * 9, 3)
    assert all(torch.equal(v, sd[k]) for k, v in built.state_dict().items())


def _tiny_port_trainer_net(self):
    self.network = pmednext.MedNeXt(self.num_input_channels, n_classes=self.num_classes,
                                    dtype=torch.float32, **TINY)


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port's MultiTalentTrainerMedNeXt after three SGD
    steps on the same batches from the same weights (the port's init, in
    place of the flax init in the JAX trainer), in fp32, on the tiny net."""
    tmp = tmp_path_factory.mktemp("mednext_slice")
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    jax_mednext = jmednext.MedNeXt
    mp.setattr(jmednext, "MedNeXt", lambda **kw: jax_mednext(**{**kw, **TINY}))
    mp.setattr(jax_mednext, "init", lambda self, rng, x: {
        "params": _port_init_params(self.in_channels, self.n_classes)})
    mp.setattr(pmultitalent.MultiTalentTrainerMedNeXt, "initialize_network",
               _tiny_port_trainer_net)
    try:
        plans = tiny_plans()
        d = plans.to_dict()
        d["plans_per_stage"][0]["patch_size"] = [16, 16, 16]
        plans = type(plans).from_dict(d)
        jt = JaxMultiTalentTrainerMedNeXt(plans, 0, str(tmp / "jax"), None, fp16=False)
        jt.initialize(True)
        jt.data_aug_params.update(NO_AUG)
        jt._build_step_functions()
        pt = pmultitalent.MultiTalentTrainerMedNeXt(port_plans(plans), 0, str(tmp / "port"),
                                                    None, fp16=False, device="cpu")
        pt.initialize(True)
        pt.data_aug_params.update(NO_AUG)
        pt._build_step_functions()
        params = jax.device_get(jt.state.params)
        before = mednext_state_dict_from_flax(params)
        pt.network.load_state_dict(before)
        batches = three_batches(tmp, jt.basic_generator_patch_size)
        losses = [(jt.run_iteration(iter([b])), pt.run_iteration(iter([b]))) for b in batches]
    finally:
        mp.undo()
    return {"pt": pt, "losses": np.array(losses), "before": before,
            "jax": mednext_state_dict_from_flax(jax.device_get(jt.state.params))}


def test_multitalent_mednext_trainer_matches_jax(trainers):
    r = trainers
    np.testing.assert_allclose(r["losses"][:, 1], r["losses"][:, 0], rtol=1e-5)
    pt, port = r["pt"], r["pt"].network.state_dict()
    assert pt.step == 3 and isinstance(pt.network, pmednext.MedNeXt)
    assert pt.deep_supervision_scales == [[1.0] * 3, [0.5] * 3, [0.25] * 3, [0.125] * 3,
                                          [0.0625] * 3]
    assert list(pt.ds_loss_weights[-1:]) == [0] and pt.inference_nonlin == "sigmoid"
    moved = 0
    for k, v in r["jax"].items():
        if k.startswith("out4."):
            assert torch.equal(port[k], r["before"][k]), k
            continue
        # a weight moves in the port where it moves in JAX (the depthwise
        # bias of down3, whose 1^3 output the norm maps to its own bias, has
        # a zero gradient in both)
        jax_moved = not torch.equal(v, r["before"][k])
        assert jax_moved == (not torch.equal(port[k], r["before"][k])), k
        moved += jax_moved
        np.testing.assert_allclose(port[k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                   err_msg=k)
    assert moved >= 0.95 * (len(port) - 2)
