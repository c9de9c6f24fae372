"""The port's residual-encoder UNet (FabiansUNet) against the JAX package's,
on the CPU, in fp32, and its entry points.

The network is the flagship resenc topology cut small: base 8, pools
((1,1,1), (2,2,2), (2,2,2), (1,2,2)), encoder blocks (1, 2, 3, 2), decoder
blocks (1, 1, 1), patch (8, 16, 16). The port's seeded weights, the norm and
conv biases perturbed away from their init, go through
io/torch_convert.convert_resenc_state_dict into the JAX model; both see the
same numpy input. Tolerance atol=1e-4, rtol=1e-3, as
test_torch_port_unet.py's: fp32 on both sides, summed in different orders
through ~25 conv layers with instance norms.

The entry points run once each on a tiny task: cli.train with
MultiTalent_trainer_resenc_ddp (training, validation, predict_multitalent
from its folder, then the head warm-up from its weights as a JAX `.ckpt`),
and cli.predict with -tr nnUNetTrainerV2_ResencUNet. (The trainers against
the JAX package's: test_torch_port_resenc_train.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.io.torch_convert import convert_fabians_unet_state_dict
from multitalent_tpu.models.residual_unet import ResidualEncoderUNet as JaxResencUNet
from multitalent_tpu.tasks.multitalent import REGIONS
from multitalent_tpu.utils.fileops import save_pickle
from multitalent_tpu_torch.cli import predict as predict_cli
from multitalent_tpu_torch.cli import train
from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
from multitalent_tpu_torch.inference.model_restore import (head_of_trainer,
                                                           load_model_and_checkpoint_files,
                                                           save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io import Geometry, Plans, read_nifti, save_plans, write_nifti
from multitalent_tpu_torch.io.from_jax import resenc_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import (convert_resenc_state_dict,
                                                   fabians_unet_state_dict)
from multitalent_tpu_torch.models.residual_unet import (ResidualEncoderUNet,
                                                        build_resenc_unet_from_plans)
from multitalent_tpu_torch.ops.fused_unet import make_inference_forward, make_train_forward
from multitalent_tpu_torch.training.trainers import init_weights_he
from multitalent_tpu_torch.training.warmup import is_seg_head_param

from test_torch_port_predict import SHAPE, _phantom, _tiny_plans
from test_torch_port_validation import stamp_export_geometry
from test_training import make_preprocessed

POOLS = ((1, 1, 1), (2, 2, 2), (2, 2, 2), (1, 2, 2))
KERNELS = ((3, 3, 3),) * 4
NBE, NBD = (1, 2, 3, 2), (1, 1, 1)
PATCH = (8, 16, 16)
K = 5
# the biases of the convs that are bias-free in the reference's checkpoints
CONV_BIASES = ("initial_conv.bias", "conv1.bias", "conv2.bias", ".conv.bias")
TASK = "Task100_MultiTalent"
PLANS_ID = "MTTPUPlans_FabiansResUNet_v2.1"


def port_net(seed: int = 0, perturb: bool = True) -> ResidualEncoderUNet:
    """The port's network in fp32, He-initialised from `seed`; with
    `perturb` every norm's scale and bias and every conv bias moved off its
    init (norm2's zero scale would hide the residual branch)."""
    net = ResidualEncoderUNet(1, 8, K, POOLS, KERNELS, NBE, NBD, dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed)
    init_weights_he(net, gen)
    if perturb:
        with torch.no_grad():
            for p in net.parameters():
                if p.dim() == 1:
                    p.add_(torch.randn(p.shape, generator=gen) * 0.3)
    return net.eval()


def jax_model() -> JaxResencUNet:
    return JaxResencUNet(input_channels=1, base_num_features=8, num_classes=K,
                         pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                         num_blocks_encoder=NBE, num_blocks_decoder=NBD, dtype=jnp.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        out.update(_flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {f"{prefix}{k}": np.asarray(v)})
    return out


def _input(n=2, seed=1) -> np.ndarray:
    return np.random.RandomState(seed).randn(n, *PATCH, 1).astype(np.float32)


def _port_logits(net, x, **kw):
    with torch.no_grad():
        out = net(torch.from_numpy(np.moveaxis(x, -1, 1)), **kw)
    if isinstance(out, list):
        return [np.moveaxis(o.numpy(), 1, -1) for o in out]
    return np.moveaxis(out.numpy(), 1, -1)


def test_weight_bridge_round_trips_with_biases():
    """flax tree (from the port's perturbed weights, the JAX model's own tree
    layout) -> port state dict -> flax tree, bit for bit, biases included."""
    params = convert_resenc_state_dict(port_net().state_dict(), NBE, NBD)
    x = jnp.zeros((1, *PATCH, 1))
    layout = jax.eval_shape(jax_model().init, jax.random.PRNGKey(0), x)["params"]
    assert jax.tree_util.tree_structure(params) == jax.tree_util.tree_structure(layout)
    assert all(np.any(v != 0) for k, v in _flat(params).items() if k.endswith("bias"))
    back = _flat(convert_resenc_state_dict(resenc_state_dict_from_flax(params, NBE, NBD),
                                           NBE, NBD))
    ref = _flat(params)
    assert sorted(back) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)


@pytest.mark.parametrize("pallas_norm", [False, True])
def test_resenc_logits_match_jax(pallas_norm, monkeypatch):
    """Full-resolution and deep-supervision logits against the JAX model's;
    under MTTPU_PALLAS_NORM=1 the JAX decoder runs its Pallas fused norm in
    interpret mode and the port's runs kernel E's plain version, the
    encoder's norms plain on both sides."""
    if pallas_norm:
        monkeypatch.setenv("MTTPU_PALLAS_NORM", "1")
    net = port_net()
    params = convert_resenc_state_dict(net.state_dict(), NBE, NBD)
    x = _input()
    apply = jax.jit(lambda p, v: jax_model().apply({"params": p}, v))
    ref = [np.asarray(o) for o in apply(params, jnp.asarray(x))]
    got = _port_logits(net, x, deep_supervision=True)
    assert [g.shape for g in got] == [r.shape for r in ref] == [
        (2, 8, 16, 16, K), (2, 4, 8, 8, K), (2, 2, 4, 4, K)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=1e-4, rtol=1e-3)
    full = _port_logits(net, x)
    np.testing.assert_array_equal(full, got[0])
    plain = _port_logits(net, x, use_kernels=False)
    np.testing.assert_allclose(plain, full, atol=1e-5, rtol=1e-5)


def test_reference_checkpoint_loads_as_the_jax_converter_reads_it():
    """A reference-named, bias-free resenc state dict, its last head under the
    old `decoder.segmentation_output` name and ConvDropoutNormReLU's `.all.`
    duplicates beside the canonical keys: the port's reader and the JAX
    package's convert_fabians_unet_state_dict give the same logits."""
    sd = {k: v for k, v in port_net(seed=3).state_dict().items() if not k.endswith(CONV_BIASES)}
    last = f"decoder.deep_supervision_outputs.{len(NBD) - 1}"
    for suffix in ("weight", "bias"):
        sd[f"decoder.segmentation_output.{suffix}"] = sd.pop(f"{last}.{suffix}")
    for i, n in enumerate(NBD):
        for b in range(n):
            p = f"decoder.stages.{i}.convs.{b}"
            sd[f"{p}.all.0.weight"] = sd[f"{p}.conv.weight"]
            sd[f"{p}.all.2.weight"] = sd[f"{p}.norm.weight"]
    sd = {f"module.{k}": v for k, v in sd.items()}
    net = ResidualEncoderUNet(1, 8, K, POOLS, KERNELS, NBE, NBD, dtype=torch.float32)
    net.load_state_dict(fabians_unet_state_dict(sd, len(POOLS)), strict=True)
    assert all(not v.any() for k, v in net.state_dict().items() if k.endswith(CONV_BIASES))
    params = convert_fabians_unet_state_dict(sd, len(POOLS), NBE, NBD)
    x = _input(n=1, seed=4)
    ref = np.asarray(jax.jit(lambda p, v: jax_model().apply(
        {"params": p}, v, deep_supervision=False))(params, jnp.asarray(x)))
    np.testing.assert_allclose(_port_logits(net.eval(), x), ref, atol=1e-4, rtol=1e-3)


def test_kernel_routes_and_launch_counts():
    """Kernel A on every stride-1 3x3x3 conv with Cin >= 8 (each block's conv2,
    conv1 of every block but a strided stage's first: stage 0's first block is
    stride 1), B on each decoder stage's first conv; the initial conv, the
    strided conv1 and the 1x1x1 skips on cuDNN. A step adds dx (A) and dw (C)
    of every kernel conv: none reads the network's input."""
    net = port_net(perturb=False)
    blocks = sum(NBE)
    a = blocks + (blocks - len(NBE)) + 1
    assert net.kernel_launches_per_forward() == {"conv3d_same": a, "conv3d_same_dual": 3}
    assert net.kernel_launches_per_step() == {"conv3d_same": 2 * a + 3,
                                              "conv3d_same_dual": 3,
                                              "conv3d_same_wgrad": a + 3}
    assert net.encoder.initial_conv.route is None
    assert net.encoder.stages[1].convs[0].conv1.route is None
    assert net.encoder.stages[1].convs[0].downsample_skip[0].route is None
    assert net.encoder.stages[0].convs[0].downsample_skip is None
    assert not any(m.norm2.weight.any() for m in net.modules() if hasattr(m, "norm2"))


@pytest.mark.parametrize("switch", ["MTTPU_FUSED_NORM", "MTTPU_FUSED_TRAIN"])
def test_fused_switches_leave_the_resenc_on_its_own_forward(switch, monkeypatch):
    """The fused route takes a GenericUNet only, as the JAX package's packed
    and fused routes do: under either switch the resenc's forward (and so
    its logits) is its own, and a warning names the switch."""
    net = port_net()
    x = torch.from_numpy(np.moveaxis(_input(n=1), -1, 1))
    with torch.no_grad():
        ref = net(x, deep_supervision=True)
    monkeypatch.setenv(switch, "1")
    make = make_inference_forward if switch == "MTTPU_FUSED_NORM" else make_train_forward
    with pytest.warns(UserWarning, match=f"{switch}=1: the fused route takes a GenericUNet"):
        forward = make(net)
    assert forward is net
    with torch.no_grad():
        got = forward(x, deep_supervision=True)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("name", ["MultiTalent_trainer_resenc_ddp",
                                  "MultiTalent_trainer_resenc_ddp_2000ep",
                                  "MultiTalent_tainer_resenc_ddp", "nnUNetTrainerV2_ResencUNet",
                                  "nnUNetTrainerV2_warmupsegheads_resenc"])
def test_resenc_trainers_restore_with_their_heads(name):
    head = "sigmoid" if name.startswith("MultiTalent") else "softmax"
    assert head_of_trainer([name]) == (name, head)


@pytest.mark.parametrize("name", ["MultiTalent_tainer_SwinUNETR_ddp_adam",
                                  "MultiTalent_trainer_SwinUNETR_ddp_adam",
                                  "MultiTalentTrainerSwinUNETR", "TrainerV2SwinUNETR",
                                  "nnUNetTrainerV2_swinunetr_adam_ddp",
                                  "nnUNetTrainerV2_swinunetr_adam_ddp_lr5e4",
                                  "TrainerV2WarmupSegHeadsSwin",
                                  "nnUNetTrainerV2_warmupsegheads_swinunetr_adam_lr5e4_ddp"])
def test_swinunetr_trainers_restore_with_their_heads(name):
    head = "sigmoid" if name.startswith("MultiTalent") else "softmax"
    assert head_of_trainer([name]) == (name, head)


@pytest.mark.parametrize("name", ["Multitalent_mednextt", "MultiTalent_meets_mednext",
                                  "MultiTalentTrainerMedNeXt"])
def test_mednext_and_swinunetr_still_raise_naming_item_10(name, tmp_path):
    """The MedNeXt trainers, refused until MedNeXt was ported (item 10b),
    restore: a folder under each name holds a MedNeXt with the 47 sigmoid
    regions."""
    from multitalent_tpu_torch.models.mednext import MedNeXt
    assert head_of_trainer([name]) == (name, "sigmoid")
    net = MedNeXt(1, n_channels=2, n_classes=47, exp_r=(2,) * 9, block_counts=(1,) * 9)
    save_model_folder(str(tmp_path / "m"), _tiny_plans(), [net.state_dict()], name)
    restored = load_model_and_checkpoint_files(str(tmp_path / "m"), device="cpu")
    (got,) = restored.networks
    assert isinstance(got, MedNeXt) and got.n_channels == 2
    assert (restored.inference_nonlin, restored.num_classes) == ("sigmoid", 47)
    assert restored.regions_class_order == list(range(47))


@pytest.fixture
def task(tmp_path, monkeypatch):
    """A tiny preprocessed MultiTalent task of two source datasets with the
    resenc plans under PLANS_ID, one patch a case, its export geometry and
    ground truth stamped."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # many small ops: see test_torch_port_train_cli.py
    pre, results = tmp_path / "pre", tmp_path / "results"
    monkeypatch.setenv("nnUNet_preprocessed", str(pre))
    monkeypatch.setenv("RESULTS_FOLDER", str(results))
    monkeypatch.setenv("MTTPU_MAX_EPOCHS", "1")
    monkeypatch.setenv("MTTPU_ITERS_PER_EPOCH", "2")
    monkeypatch.setenv("MTTPU_VAL_ITERS", "1")
    ddir = pre / TASK
    for prefix, regions, labels in (("003", ("03_liver", "03_cancer"), [1, 2]),
                                    ("009", ("09_spleen",), [8])):
        make_preprocessed(ddir, n_cases=2, prefix=prefix, shape=(8, 16, 16),
                          extra_props={"valid_regions": regions, "valid_labels": labels})
    d = _tiny_plans().to_dict()
    d["base_num_features"] = 8
    d["plans_per_stage"][0].update(patch_size=list(PATCH), num_pool_per_axis=[2, 3, 3],
                                   pool_op_kernel_sizes=POOLS, conv_kernel_sizes=KERNELS,
                                   num_blocks_encoder=NBE, num_blocks_decoder=NBD)
    plans = Plans.from_dict(d)
    save_plans(plans, ddir / f"{PLANS_ID}_plans_3D.pkl")
    stamp_export_geometry(ddir)
    keys = [f"{p}_{i:03d}" for p in ("003", "009") for i in range(2)]
    save_pickle([{"train": keys, "val": ["003_001", "009_001"]}] * 12,
                ddir / "splits_custom.pkl")
    save_pickle([{"train": keys, "val": keys[:1]}] * 5, ddir / "splits_final.pkl")
    (tmp_path / "in").mkdir()
    write_nifti(tmp_path / "in" / "case_0000.nii.gz",
                _phantom(np.random.RandomState(0)).astype(np.int16),
                Geometry(spacing=(1.0, 1.0, 1.6)))
    yield tmp_path, plans, results / "nnUNet" / "3d_fullres" / TASK
    torch.set_num_threads(threads)


def test_train_cli_trains_validates_and_fine_tunes_a_resenc(task):
    """MultiTalent_trainer_resenc_ddp through cli.train (two steps, the
    validation of one case a dataset), predict_multitalent from its folder,
    then nnUNetTrainerV2_warmupsegheads_resenc -pretrained_weights its
    weights as a JAX `.ckpt`: the backbone loads them and stays, the heads
    move."""
    tmp, plans, root = task
    trainer = train.main(["3d_fullres", "MultiTalent_trainer_resenc_ddp", TASK, "0",
                          "-p", PLANS_ID, "--device", "cpu"])
    assert isinstance(trainer.network, ResidualEncoderUNet) and trainer.step == 2
    assert np.isfinite(trainer.all_tr_losses + trainer.all_tr_ce).all()
    model = root / f"MultiTalent_trainer_resenc_ddp__{PLANS_ID}"
    val = model / "fold_0" / "validation_raw"
    assert {f.name for f in val.glob("*.nii.gz")} == {"003_001.nii.gz", "009_001.nii.gz"}
    assert [t["forwards"] for t in trainer.validation_timings] == [8] * 2
    timings = predict_main(["-i", str(tmp / "in"), "-o", str(tmp / "out"), "-m", str(model),
                            "--device", "cpu", "--disable_tta"])
    assert [t["case"] for t in timings] == ["case"]
    assert read_nifti(tmp / "out" / "case.nii.gz")[0].shape == SHAPE
    assert {read_nifti(tmp / "out" / "individual" / r / "case.nii.gz")[0].shape
            for r in REGIONS} == {SHAPE}

    sd = trainer.network.state_dict()
    save_jax_model_folder(str(tmp / "jax_model"), plans, [sd], "MultiTalentTrainerResenc")
    ckpt = tmp / "jax_model" / "fold_0" / "model_final_checkpoint.ckpt"
    tuned = train.main(["3d_fullres", "nnUNetTrainerV2_warmupsegheads_resenc", TASK, "0",
                        "-p", PLANS_ID, "-pretrained_weights", str(ckpt), "--device", "cpu"])
    fresh = build_resenc_unet_from_plans(plans, 0, tuned.num_classes)
    init_weights_he(fresh, torch.Generator().manual_seed(tuned.seed))
    init = fresh.state_dict()
    assert tuned.step == 2 and tuned.optimizer_phase == 1
    for k, v in tuned.network.state_dict().items():
        if is_seg_head_param(k):
            # the lowest head has loss weight 0 and stays at its init
            assert k.startswith("decoder.deep_supervision_outputs.0.") or not torch.equal(
                v, init[k]), k
        else:
            assert torch.equal(v, sd[k].to(v.dtype)), k


def test_predict_cli_takes_the_resenc_trainer(task):
    """cli.predict -tr nnUNetTrainerV2_ResencUNet -p <FabiansResUNet plans>:
    a softmax resenc folder of seeded weights predicts a labelmap of the
    plans' classes at the input's shape."""
    tmp, plans, root = task
    net = build_resenc_unet_from_plans(plans, 0, plans.num_classes + 1)
    init_weights_he(net, torch.Generator().manual_seed(7))
    model = root / f"nnUNetTrainerV2_ResencUNet__{PLANS_ID}"
    save_model_folder(str(model), plans, [net.state_dict()], "nnUNetTrainerV2_ResencUNet",
                      fp16=False)
    timings = predict_cli.main(["-i", str(tmp / "in"), "-o", str(tmp / "out_softmax"), "-t",
                                TASK, "-tr", "nnUNetTrainerV2_ResencUNet", "-p", PLANS_ID,
                                "--device", "cpu", "--disable_tta"])
    assert [t["case"] for t in timings] == ["case"]
    seg, _ = read_nifti(tmp / "out_softmax" / "case.nii.gz")
    assert seg.shape == SHAPE and set(np.unique(seg)) <= set(range(plans.num_classes + 1))
