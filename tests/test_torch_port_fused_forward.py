"""The fused conv -> InstanceNorm chain (ops/fused_unet.py) as a whole, on the
CPU, against the JAX package's packed_unet_forward_fused and against the
port's own unfused route, in fp32.

One small packable UNet (base 8, pools ((2,2,2),(1,2,2)), 3x3x3 convs) gets
its flax params carried into the port through io/from_jax.py, the norm
affines moved off (1, 0). The JAX fused forward packs its full-resolution
stages ((2, 2) space-to-depth) and runs its blocks through the XLA
compositions of its Pallas kernels on the CPU; the port runs unpacked through
its kernels' plain versions.

Tolerances: fp32 on both sides, summed in different orders through ~10
convs with instance norms between them (as tests/test_torch_port_unet.py):
logits atol 1e-4, rtol 1e-3; the training loss rtol 1e-5 and each parameter
gradient atol 1e-5 + rtol 1e-3 of the tensor's largest entry, except the conv
biases, which the instance norms cancel (their gradient is summation noise
around 0 in both packages: held to atol 1e-5 only). The CLI masks agree on
>= 99.99% of every region's voxels, as the fp32 rows of
tests/test_torch_port_predict.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.ops.packed_conv import depth_to_space_yx
from multitalent_tpu.ops.packed_unet import packed_unet_forward_fused
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference.model_restore import save_model_folder
from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
from multitalent_tpu_torch.models.generic_unet import GenericUNet, build_unet_from_plans
from multitalent_tpu_torch.ops.fused_unet import (make_inference_forward, make_train_forward,
                                                  unet_forward_fused)
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer

from test_torch_port_predict import SHAPE, _phantom, _tiny_plans
from test_torch_port_train_slice import NO_AUG, flagship_like_plans, port_plans, three_batches

POOLS = ((2, 2, 2), (1, 2, 2))
KERNELS = ((3, 3, 3),) * 3
K = 5


def _jax_model(deep_supervision: bool) -> JaxGenericUNet:
    return JaxGenericUNet(input_channels=1, base_num_features=8, num_classes=K,
                          pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                          deep_supervision=deep_supervision, dtype=jnp.float32)


@pytest.fixture(scope="module")
def weights():
    """flax params (norm affines perturbed) and the port network holding them."""
    x = jnp.zeros((1, 8, 32, 32, 1), jnp.float32)
    params = jax.device_get(_jax_model(False).init(jax.random.PRNGKey(0), x)["params"])
    rng = np.random.RandomState(3)

    def perturb(tree):
        return {k: perturb(v) if isinstance(v, dict) else
                (np.asarray(v) + rng.randn(*v.shape) * 0.3).astype(np.float32)
                if k in ("scale", "bias") else np.asarray(v) for k, v in tree.items()}
    params = perturb(params)
    net = GenericUNet(1, 8, K, POOLS, KERNELS, dtype=torch.float32)
    net.load_state_dict(generic_unet_state_dict_from_flax(params, num_pool=len(POOLS)))
    return params, net


def test_fused_inference_forward_matches_jax_fused_forward(weights):
    params, net = weights
    x = np.random.RandomState(14).randn(1, 8, 16, 16, 1).astype(np.float32)
    logits, factors = packed_unet_forward_fused(_jax_model(False), params, jnp.asarray(x),
                                                pack_max_channels=64, packed_output=True)
    assert factors != (1, 1)  # the JAX side really ran packed
    ref = np.asarray(depth_to_space_yx(logits, factors))
    xt = torch.from_numpy(np.moveaxis(x, -1, 1))
    got = unet_forward_fused(net, xt)
    assert got.dtype == torch.float32 and got.shape == (1, K, 8, 16, 16)
    assert got.is_contiguous() and not got.requires_grad
    np.testing.assert_allclose(np.moveaxis(got.numpy(), 1, -1), ref, atol=1e-4, rtol=1e-3)
    with torch.no_grad():
        unfused = net(xt)
    np.testing.assert_allclose(got.numpy(), unfused.numpy(), atol=1e-4, rtol=1e-3)
    # every kernel's plain version on the route, as chip_smoke holds the kernels to
    np.testing.assert_allclose(unet_forward_fused(net, xt, use_kernels=False).numpy(),
                               got.numpy(), atol=1e-6, rtol=1e-6)


def test_fused_training_loss_and_gradients_match_jax(weights):
    """Deep-supervision loss and parameter gradients of the differentiable
    fused forward against jax.value_and_grad of packed_unet_forward_fused
    (differentiable=True: conv3d_same_affine_fast's custom VJP)."""
    params, net = weights
    rng = np.random.RandomState(18)
    x = rng.randn(2, 8, 32, 32, 1).astype(np.float32)
    shapes = [(2, 8, 32, 32, K), (2, 4, 16, 16, K)]  # one head per decoder level
    targets = [rng.randn(*s).astype(np.float32) for s in shapes]
    ds_weights = (2 / 3, 1 / 3)
    model = _jax_model(True)

    @jax.jit
    def jax_loss(p):
        outs = packed_unet_forward_fused(model, p, jnp.asarray(x), pack_max_channels=64,
                                         deep_supervision=True, differentiable=True)
        return sum(wt * jnp.mean((o - t) ** 2) for wt, o, t in zip(ds_weights, outs, targets))

    val, grads = jax.value_and_grad(jax_loss)(params)
    ref = generic_unet_state_dict_from_flax(jax.device_get(grads), num_pool=len(POOLS))

    net.zero_grad()
    outs = unet_forward_fused(net, torch.from_numpy(np.moveaxis(x, -1, 1)),
                              deep_supervision=True, differentiable=True)
    assert [tuple(o.shape) for o in outs] == [(s[0], K, *s[1:4]) for s in shapes]
    loss = sum(wt * ((o.permute(0, 2, 3, 4, 1) - torch.from_numpy(t)) ** 2).mean()
               for wt, o, t in zip(ds_weights, outs, targets))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(val), rtol=1e-5)
    got = {k: p.grad for k, p in net.named_parameters()}
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        g = got[k].numpy()
        scale = 0.0 if k.endswith("conv.bias") else np.abs(r.numpy()).max()
        np.testing.assert_allclose(g, r.numpy(), rtol=0, atol=1e-5 + 1e-3 * scale,
                                   err_msg=k)


def test_fused_launch_counts_follow_the_route(weights):
    """Per forward: D for the 7 kernel convs (Cin >= 8 or a decoder's first
    conv), E stats for the 3 cuDNN convs (Cin=1, two strided), E apply for the
    4 materialized activations (2 encoder stages, the bottleneck, 1 decoder
    stage), F once; a step adds dx (A) and dw (C) for every D."""
    _, net = weights
    assert net.fused_kernel_launches_per_forward() == {
        "conv3d_same_affine": 7, "channel_stats": 3, "affine_lrelu": 4, "seghead": 1}
    assert net.fused_kernel_launches_per_forward(True) == {"conv3d_same_affine": 7}
    assert net.fused_kernel_launches_per_step() == {
        "conv3d_same_affine": 7, "conv3d_same": 7, "conv3d_same_wgrad": 7}


@pytest.fixture(scope="module")
def predictions(tmp_path_factory):
    """The predict CLI on one fp32 model folder, unfused and fused."""
    root = tmp_path_factory.mktemp("fused_predict")
    plans = _tiny_plans()
    torch.manual_seed(0)
    net = build_unet_from_plans(plans, 0, num_classes=47)
    with torch.no_grad():  # norm affines off (1, 0), so the prologue matters
        for name, p in net.named_parameters():
            if "instnorm" in name:
                p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 0.2)
    model = str(root / "model")
    save_model_folder(model, plans, [net.state_dict()], "MultiTalent_trainer_ddp", fp16=False)
    (root / "in").mkdir()
    write_nifti(root / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    mp = pytest.MonkeyPatch()
    try:
        for route in ("unfused", "fused"):
            mp.setenv("MTTPU_FUSED_NORM", "1" if route == "fused" else "0")
            predict_main(["-i", str(root / "in"), "-o", str(root / route), "-m", model,
                          "--device", "cpu"])
    finally:
        mp.undo()
    return root


def test_predict_cli_fused_route_matches_unfused(predictions):
    root = predictions
    for r in REGIONS:
        got, _ = read_nifti(root / "fused" / "individual" / r / "case.nii.gz")
        ref, _ = read_nifti(root / "unfused" / "individual" / r / "case.nii.gz")
        assert got.shape == ref.shape == SHAPE
        assert np.mean(got == ref) >= 0.9999, r
    seg, _ = read_nifti(root / "fused" / "case.nii.gz")
    ref, _ = read_nifti(root / "unfused" / "case.nii.gz")
    assert np.mean(seg == ref) >= 0.9999


def test_switches_default_to_the_unfused_forward(monkeypatch):
    net = GenericUNet(1, 8, K, POOLS, KERNELS, dtype=torch.float32)
    monkeypatch.delenv("MTTPU_FUSED_NORM", raising=False)
    monkeypatch.delenv("MTTPU_FUSED_TRAIN", raising=False)
    assert make_inference_forward(net) is net and make_train_forward(net) is net
    monkeypatch.setenv("MTTPU_FUSED_NORM", "1")
    monkeypatch.setenv("MTTPU_FUSED_TRAIN", "1")
    assert make_inference_forward(net) is not net and make_train_forward(net) is not net


def _trainer(tmp_path, fused: bool, monkeypatch) -> MultiTalentTrainer:
    monkeypatch.setenv("MTTPU_FUSED_TRAIN", "1" if fused else "0")
    pt = MultiTalentTrainer(port_plans(flagship_like_plans()), 0,
                            str(tmp_path / f"port_{fused}"), None, fp16=False, device="cpu")
    pt.initialize(True)
    pt.data_aug_params.update(NO_AUG)
    pt._build_step_functions()
    return pt


def test_fused_trainer_matches_unfused_trainer(tmp_path, monkeypatch):
    """Three MultiTalentTrainer steps with MTTPU_FUSED_TRAIN=1 against the
    unfused trainer from the same seeded weights on the same batches, fp32:
    losses rtol 1e-5, every parameter after step 3 atol 2e-6 + rtol 1e-4 (as
    the trainer's own parity test with JAX); the conv biases, which the norms
    cancel, to atol 1e-6."""
    ref = _trainer(tmp_path, False, monkeypatch)
    fused = _trainer(tmp_path, True, monkeypatch)
    assert ref.network_forward is ref.network and fused.network_forward is not fused.network
    batches = three_batches(tmp_path, ref.basic_generator_patch_size)
    losses = [(ref.run_iteration(iter([b])), fused.run_iteration(iter([b]))) for b in batches]
    losses = np.array(losses)
    np.testing.assert_allclose(losses[:, 1], losses[:, 0], rtol=1e-5)
    got, want = fused.network.state_dict(), ref.network.state_dict()
    for k, v in want.items():
        if k.endswith("conv.bias"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=2e-6, rtol=1e-4,
                                       err_msg=k)


def test_pallas_norm_switch_runs_kernel_e_without_grad_and_refuses_grad(monkeypatch):
    """MTTPU_PALLAS_NORM=1: every norm of the plain forward on kernel E (the
    same logits in fp32 under no_grad), and an error naming the missing
    backward while autograd records."""
    torch.manual_seed(0)
    net = GenericUNet(1, 8, K, POOLS, KERNELS, dtype=torch.float32)
    x = torch.randn(1, 1, 8, 32, 32)
    with torch.no_grad():
        ref = net(x)
    monkeypatch.setenv("MTTPU_PALLAS_NORM", "1")
    with torch.no_grad():
        got = net(x)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5, rtol=1e-4)
    with pytest.raises(RuntimeError, match="no backward"):
        net(x)
    block = next(m for m in net.modules() if isinstance(m, ConvDropoutNormNonlin))
    with pytest.raises(RuntimeError, match="ROADMAP"):
        block(torch.randn(1, 1, 4, 8, 8))
