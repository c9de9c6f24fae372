"""The port's GenericUNet against the JAX package's, on the CPU, in fp32.

One set of flax params goes through the weight bridge (io/from_jax.py) into
the port; both networks see the same numpy input. Tolerance atol=1e-4,
rtol=1e-3: fp32 on both sides, summed in different orders through ~10 conv
layers with instance norms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.io.torch_convert import convert_generic_unet_state_dict
from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.generic_unet import GenericUNet

TOPOLOGIES = {
    # the flagship at base 4 and three pools: 3x3x3 everywhere, 47 heads
    "flagship_reduced": dict(pools=((2, 2, 2), (2, 2, 2), (1, 2, 2)),
                             kernels=((3, 3, 3),) * 4, patch=(8, 16, 16)),
    # Prostate-like anisotropic stages: (1,3,3) convs take the cuDNN route,
    # including a decoder first conv over the built concat
    "anisotropic": dict(pools=((1, 2, 2), (1, 2, 2), (2, 2, 2)),
                        kernels=((1, 3, 3), (1, 3, 3), (3, 3, 3), (3, 3, 3)),
                        patch=(4, 16, 16)),
}


def _jax_model_and_params(topo, seed=0):
    model = JaxGenericUNet(input_channels=1, base_num_features=4, num_classes=47,
                           pool_op_kernel_sizes=topo["pools"],
                           conv_kernel_sizes=topo["kernels"],
                           deep_supervision=False, dtype=jnp.float32)
    x = jnp.zeros((1, *topo["patch"], 1), jnp.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed), x)["params"])
    rng = np.random.RandomState(seed)

    def perturb(tree):  # norm affine params away from the trivial (1, 0)
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = perturb(v)
            elif k in ("scale", "bias"):
                out[k] = (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return model, perturb(params)


def _port_model(topo, params) -> GenericUNet:
    net = GenericUNet(input_channels=1, base_num_features=4, num_classes=47,
                      pool_op_kernel_sizes=topo["pools"],
                      conv_kernel_sizes=topo["kernels"], dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(
        params, num_pool=len(topo["pools"])), strict=True)
    return net.eval()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_weight_bridge_round_trips(name):
    """flax params -> port state dict -> convert_generic_unet_state_dict gives
    the same arrays: the transpose and the transposed-conv flip are undone
    exactly once."""
    topo = TOPOLOGIES[name]
    _, params = _jax_model_and_params(topo)
    sd = _port_model(topo, params).state_dict()
    back = _flat(convert_generic_unet_state_dict(sd, num_pool=len(topo["pools"])))
    ref = _flat(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_generic_unet_logits_match_jax(name):
    topo = TOPOLOGIES[name]
    model, params = _jax_model_and_params(topo)
    x = np.random.RandomState(1).randn(2, *topo["patch"], 1).astype(np.float32)
    ref = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    net = _port_model(topo, params)
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 47, *topo["patch"])
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=1e-4, rtol=1e-3)
    # the kernels' plain versions give the same logits as the kernel route
    with torch.no_grad():
        plain = net(torch.from_numpy(np.moveaxis(x, -1, 1)), use_kernels=False).numpy()
    np.testing.assert_allclose(plain, got, atol=1e-5, rtol=1e-5)


def test_kernel_routes_follow_the_reference_rules():
    net = _port_model(TOPOLOGIES["flagship_reduced"],
                      _jax_model_and_params(TOPOLOGIES["flagship_reduced"])[1])
    # kernel A: every stride-1 3x3x3 conv with Cin >= 8 except the decoders'
    # first convs (enc0.block1 has Cin 4 and stays on cuDNN); kernel B: every
    # decoder's first conv
    assert net.kernel_launches_per_forward() == {"conv3d_same": 5,
                                                 "conv3d_same_dual": 3}
    aniso = _port_model(TOPOLOGIES["anisotropic"],
                        _jax_model_and_params(TOPOLOGIES["anisotropic"])[1])
    # the (1,3,3) stages (enc0, enc1 and the last decoder) stay on cuDNN
    assert aniso.kernel_launches_per_forward() == {"conv3d_same": 4,
                                                   "conv3d_same_dual": 2}


def test_load_state_dict_drops_prepared_weights():
    topo = TOPOLOGIES["flagship_reduced"]
    _, params = _jax_model_and_params(topo)
    net = _port_model(topo, params)
    block = net.conv_blocks_context[1].blocks[1]
    first = block.prepared_weight(torch.float32)
    assert block.prepared_weight(torch.float32) is first
    sd = {k: v * 2 for k, v in net.state_dict().items()}
    net.load_state_dict(sd)
    again = block.prepared_weight(torch.float32)
    assert again is not first
    assert torch.allclose(again.w, first.w * 2)
