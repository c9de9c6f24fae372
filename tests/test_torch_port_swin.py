"""The port's SwinUNETR (models/swin_unetr.py) against the JAX package's, on
the CPU, in fp32, and AdamClipped against optax's AMSGrad chain.

The network is the trainers' topology at a small width that still shifts
and pads its windows: feature_size 12, depths (2, 2, 2, 2), heads (3, 6, 12,
24), window 7, input 64^3. Stage 0 runs at 32^3, padded to 35^3 for its 7^3
windows (shift 3); stage 3 at 4^3, where the window is 4 and the shift 2. The
port's seeded weights, every bias and norm moved off its init, go through
io/torch_convert.convert_swin_unetr_state_dict into the JAX model; both see
the same numpy input. Tolerance atol 1e-4 / rtol 1e-3, as the resenc's
(test_torch_port_resenc.py): fp32 on both sides, summed in other orders.
The blocks alone (window partition, shift mask, window attention with its
relative-position bias, the swin block, patch merging) take the same
weights' subtrees at their shapes in the network, at atol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multitalent_tpu.models import swin_unetr as jsw
from multitalent_tpu.training.train_state import make_adam_optimizer
from multitalent_tpu_torch.io.from_jax import swin_unetr_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_swin_unetr_state_dict
from multitalent_tpu_torch.models import swin_unetr as sw
from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
from multitalent_tpu_torch.training.train_state import AdamClipped

FS, K = 12, 5
PATCH = (64, 64, 64)


def port_net(dtype=torch.float32) -> SwinUNETR:
    """The port's network from seed 0, every 1-D parameter (biases, norms)
    moved off its init."""
    net = SwinUNETR(1, K, PATCH, feature_size=FS, dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    net.init_weights(gen)
    with torch.no_grad():
        for p in net.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    return net.eval()


def jax_model(**kwargs) -> jsw.SwinUNETR:
    return jsw.SwinUNETR(in_channels=1, out_channels=K, feature_size=FS, dtype=jnp.float32,
                         **kwargs)


@pytest.fixture(scope="module")
def carried():
    """The port's network, its weights as the JAX tree, one input, and the
    JAX logits of it."""
    net = port_net()
    params = convert_swin_unetr_state_dict(net.state_dict())
    x = np.random.RandomState(1).randn(1, *PATCH, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jax_model().apply({"params": p}, v))(
        params, jnp.asarray(x)))
    return {"net": net, "params": params, "x": x, "ref": ref}


def test_swin_unetr_logits_match_jax(carried):
    net = carried["net"]
    # the configuration shifts and pads: stage 0 at 32^3 in 7^3 windows
    # (padded to 35^3, shift 3), stage 3 at 4^3 in a 4^3 window (shift 2)
    assert (net.stage0_block1.window_size, net.stage0_block1.shift) == (7, 3)
    assert (net.stage0_block0.shift, net.stage3_block1.window_size,
            net.stage3_block1.shift) == (0, 4, 2)
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(carried["x"], -1, 1)))
    assert got.dtype == torch.float32 and got.shape == (1, K, *PATCH)
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), carried["ref"], atol=1e-4,
                               rtol=1e-3)


def test_swin_unetr_bridge_is_bit_exact_both_ways(carried):
    """State dict -> flax tree -> state dict is the identity, and the tree
    has the JAX module's structure and shapes (flax's init, shapes only)."""
    net, params = carried["net"], carried["params"]
    sd = net.state_dict()
    back = swin_unetr_state_dict_from_flax(params)
    assert sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
    again = convert_swin_unetr_state_dict(back)
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, params, again))
    shapes = jax.eval_shape(lambda: jax_model().init(jax.random.PRNGKey(0),
                                                     jnp.zeros((1, *PATCH, 1))))["params"]
    assert (jax.tree_util.tree_map(lambda a: tuple(a.shape), shapes)
            == jax.tree_util.tree_map(lambda a: tuple(a.shape), params))
    # PatchMerging's unnamed flax layers, the dense kernels (in, out)
    assert params["merge2"]["Dense_0"]["kernel"].shape == (8 * 4 * FS, 8 * FS)
    assert "bias" not in params["merge2"]["Dense_0"]
    assert set(params["decoder1"]["up"]) == {"kernel"} and "res" in params["decoder1"]["block"]


@pytest.mark.parametrize("dims,ws", [((35, 35, 35), 7), ((4, 4, 4), 4), ((14, 21, 7), 7)])
def test_window_partition_round_trip_matches_jax(dims, ws):
    x = np.random.RandomState(2).randn(2, *dims, 3).astype(np.float32)
    ref = np.asarray(jsw.window_partition(jnp.asarray(x), ws))
    got = sw.window_partition(torch.from_numpy(x), ws)
    assert np.array_equal(got.numpy(), ref)
    assert torch.equal(sw.window_unpartition(got, ws, (2, *dims)), torch.from_numpy(x))


@pytest.mark.parametrize("dims,ws,shift", [((35, 35, 35), 7, 3), ((4, 4, 4), 4, 2),
                                           ((14, 21, 7), 7, 3)])
def test_shift_mask_matches_jax(dims, ws, shift):
    ref = np.asarray(jsw._shift_attn_mask(dims, ws, shift))
    got = sw.shift_attn_mask(dims, ws, shift)
    assert got.dtype == torch.float32 and np.array_equal(got.numpy(), ref)
    # cached on the block in bf16, in which -100 and 0 are exact
    block = sw.SwinBlock(6, 3, ws, shift)
    cached = block.shift_mask(dims, torch.device("cpu"))
    assert cached is block.shift_mask(dims, torch.device("cpu"))
    assert np.array_equal(cached.float().numpy(), ref)


def test_window_attention_and_relative_index_match_jax(carried):
    """stage0_block1's attention on shifted windows of its padded 35^3 grid
    with the mask: the relative-position bias must take the JAX table rows."""
    ws, dims = 7, (35, 35, 35)
    rng = np.random.RandomState(3)
    nw = (35 // ws) ** 3
    x = rng.randn(nw, ws ** 3, FS).astype(np.float32)
    params = carried["params"]["stage0_block1"]["attn"]
    mask = jsw._shift_attn_mask(dims, ws, 3)
    ref = np.asarray(jax.jit(lambda p, v: jsw.WindowAttention(FS, 3, ws, jnp.float32).apply(
        {"params": p}, v, mask))(params, jnp.asarray(x)))
    attn = carried["net"].stage0_block1.attn
    with torch.no_grad():
        got = attn(torch.from_numpy(x), sw.shift_attn_mask(dims, ws, 3), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)
    index = sw.relative_position_index(ws)
    n = ws ** 3
    assert index.shape == (n * n,) and index.max() == (2 * ws - 1) ** 3 - 1
    assert (index.reshape(n, n).diagonal() == (2 * ws - 1) ** 3 // 2).all()


def test_swin_block_with_shift_and_padding_matches_jax(carried):
    x = np.random.RandomState(4).randn(1, 32, 32, 32, FS).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jsw.SwinBlock(
        FS, 3, 7, shift=True, dtype=jnp.float32).apply({"params": p}, v))(
            carried["params"]["stage0_block1"], jnp.asarray(x)))
    with torch.no_grad():
        got = carried["net"].stage0_block1(torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_patch_merging_order_matches_jax(carried):
    """The 8 neighbours in (dz, dy, dx, c) order, odd extents padded."""
    x = np.random.RandomState(5).randn(2, 5, 6, 7, FS).astype(np.float32)
    ref = np.asarray(jsw.PatchMerging(FS, jnp.float32).apply(
        {"params": carried["params"]["merge0"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = carried["net"].merge0(torch.from_numpy(x), torch.float32)
    assert got.shape == (2, 3, 3, 4, 2 * FS)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_swin_unetr_kernel_routes_and_launch_counts():
    """Kernel A for every stride-1 3x3x3 conv with Cin >= 8, kernel B for
    each up block's conv1 over (up, skip), cuDNN for the rest: 16 A and 5 B
    a forward; a step adds A's dx of all 21 and C's dw of all 21."""
    net = SwinUNETR(1, K, PATCH, feature_size=FS)
    routes = {name: m.route for name, m in net.named_modules() if hasattr(m, "route")}
    a = {n for n, r in routes.items() if r == "conv3d_same"}
    b = {n for n, r in routes.items() if r == "conv3d_same_dual"}
    decoders = ("decoder5", "decoder4", "decoder3", "decoder2", "decoder1")
    assert b == {f"{d}.block.conv1" for d in decoders}
    assert a == ({"encoder0.conv2"} | {f"{d}.block.conv2" for d in decoders}
                 | {f"encoder{i}.conv{j}" for i in (1, 2, 3, 4, 10) for j in (1, 2)})
    assert {n for n, r in routes.items() if r is None} == (
        {"encoder0.conv1", "encoder0.res"} | {f"{d}.block.res" for d in decoders})
    assert net.kernel_launches_per_forward() == {"conv3d_same": 16, "conv3d_same_dual": 5}
    assert net.kernel_launches_per_step() == {"conv3d_same": 37, "conv3d_same_dual": 5,
                                              "conv3d_same_wgrad": 21}
    assert [m for m in net.deep_supervision_heads()] == [net.out]
    with pytest.raises(ValueError, match="divisible by 32"):
        SwinUNETR(1, K, (64, 48, 64))


def test_swin_unetr_bf16_forward_and_deep_supervision_list():
    """The model dtype bf16 (the trainers' default): logits fp32 and finite;
    deep_supervision returns the one output in a list; the kernels' plain
    versions (use_kernels=False) give the same bits on the CPU."""
    net = port_net(torch.bfloat16)
    x = torch.randn(1, 1, *PATCH, generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        logits = net(x)
        (listed,) = net(x, deep_supervision=True)
        plain = net(x, use_kernels=False)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
    assert torch.equal(listed, logits) and torch.equal(plain, logits)
    with pytest.raises(ValueError, match="built for"):
        net(torch.zeros(1, 1, 32, 64, 64))


def _adam_run(steps_lr, grads, params):
    """optax's chain and AdamClipped on the same gradients; yields the max
    gap of the parameters after each step."""
    tx = make_adam_optimizer(lambda c: jnp.asarray([lr for lr in steps_lr])[c],
                             weight_decay=3e-5)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    opt = AdamClipped(tp, weight_decay=3e-5)
    gaps, norms = [], []
    for lr, g in zip(steps_lr, grads):
        updates, state = tx.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        norms.append(float(opt.step(lr)))
        gaps.append(max(float(np.abs(np.asarray(a) - b.detach().numpy()).max())
                        for a, b in zip(jp, tp)))
    return gaps, norms, tp, opt


# six steps, the LR changing: two clipped (global norm > 12), then small
# gradients, so that the bias-corrected second moment falls after rising
LRS = (1e-3, 5e-4, 2e-3, 1e-3, 7e-4, 3e-4)
SCALES = (50.0, 30.0, 0.01, 0.01, 0.02, 5.0)
SHAPES = ((4, 3), (5,), (2, 3, 3))


def _adam_case():
    rng = np.random.RandomState(0)
    params = [rng.randn(*s).astype(np.float32) * 0.1 for s in SHAPES]
    grads = [[rng.randn(*s).astype(np.float32) * sc for s in SHAPES] for sc in SCALES]
    return params, grads


def test_adam_clipped_equals_optax_amsgrad_chain():
    params, grads = _adam_case()
    gaps, norms, _, _ = _adam_run(LRS, grads, params)
    assert max(gaps) <= 1e-7, gaps
    assert norms[0] > 12 and norms[1] > 12 and norms[2] < 12  # clipped, then not

    # torch's AMSGrad keeps the maximum of the raw second moment: where
    # nu_hat falls after rising it takes another step (AdamW for the same
    # decoupled decay, clipped as torch clips)
    tp = [torch.tensor(p, requires_grad=True) for p in params]
    adamw = torch.optim.AdamW(tp, lr=LRS[0], weight_decay=3e-5, amsgrad=True)
    _, _, mine, _ = _adam_run(LRS, grads, params)
    for lr, g in zip(LRS, grads):
        for p, x in zip(tp, g):
            p.grad = torch.tensor(x)
        torch.nn.utils.clip_grad_norm_(tp, 12.0)
        for group in adamw.param_groups:
            group["lr"] = lr
        adamw.step()
    assert max(float((a - b).detach().abs().max()) for a, b in zip(tp, mine)) > 1e-5


def test_adam_clipped_state_dict_resumes_bit_equal():
    """Three steps, state_dict into a new optimizer, three more: the same
    parameters as six steps in one (the trainer's -c resume)."""
    params, grads = _adam_case()
    _, _, whole, _ = _adam_run(LRS, grads, params)
    _, _, first, opt = _adam_run(LRS[:3], grads[:3], params)
    state = opt.state_dict()
    resumed = [p.detach().clone().requires_grad_(True) for p in first]
    opt2 = AdamClipped(resumed, weight_decay=3e-5)
    opt2.load_state_dict(state)
    for lr, g in zip(LRS[3:], grads[3:]):
        for p, x in zip(resumed, g):
            p.grad = torch.tensor(x)
        opt2.step(lr)
    assert all(torch.equal(a, b) for a, b in zip(whole, resumed))
