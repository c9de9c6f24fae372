"""The trainer variants of the port (training/variants.py) on the CPU,
against the JAX package's.

- Each network knob of the architectural variants (norm: batch, group, FRN,
  none; nonlin: ReLU, GELU, Mish; LeakyReLU slope 0.2; a head bias; 3 convs
  a stage; base 24; all-3x3x3 kernels over anisotropic plans; conv ->
  nonlin -> norm blocks with ReLU and with LeakyReLU), as one case
  of a parametrized test: the port's GenericUNet against the JAX GenericUNet
  with the same overrides, 3D, base 8 (GroupNorm's 8 groups divide it), two
  pools, 8^3, deep supervision, fp32, the JAX params carried over by
  io/from_jax.py (made from a seeded init with every norm parameter and
  head bias moved off its init: the conv -> nonlin -> norm networks carry
  the same keys); batch norm also in eval mode (batch statistics there
  too).
- Every trainer name of the variants resolves in the train CLI's TRAINERS
  to the JAX class's name, and its network_overrides,
  augmentation parameters, generator patch size, initial LR, batch dice,
  fp16, deep supervision and its scales equal the JAX trainer's on the same
  plans; its network carries the overrides.
- A variant's JAX-layout `.ckpt` folder and reference-layout `.model`
  folder restore to the same network (its overrides from the trainer name,
  the weights bit-equal); the restored weights through
  io/torch_convert.py give the JAX network the same logits.
- The fused switches leave a variant network on its own forward, a conv ->
  nonlin -> norm one too (the JAX package's packed route would take it).

Tolerances: logits atol 1e-4, rtol 1e-3 (fp32 convolutions summed in other
orders through ~12 convs with norms between them, as
tests/test_torch_port_unet.py); settings and restored weights exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.models.generic_unet import GenericUNet as JaxGenericUNet
from multitalent_tpu.plans import Plans
from multitalent_tpu.registry import resolve_trainer
from multitalent_tpu_torch.cli.train import TRAINERS
from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                           save_jax_model_folder,
                                                           save_model_folder)
from multitalent_tpu_torch.io.from_jax import generic_unet_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_generic_unet_state_dict
from multitalent_tpu_torch.models.generic_unet import GenericUNet, build_unet_from_plans
from multitalent_tpu_torch.models.residual_unet import ResidualEncoderUNet
from multitalent_tpu_torch.ops.fused_unet import make_inference_forward, make_train_forward
from multitalent_tpu_torch.training.trainers import init_weights_he

from test_torch_port_train_slice import port_plans
from test_training import tiny_plans

POOLS = ((2, 2, 2), (2, 2, 2))
KERNELS = ((3, 3, 3),) * 3
ANISO = ((1, 3, 3), (3, 3, 3), (3, 3, 3))
K = 3
TOL = dict(atol=1e-4, rtol=1e-3)

KNOBS = {
    "batch": {"norm": "batch"},
    "group": {"norm": "group"},
    "frn": {"norm": "frn"},
    "none": {"norm": "none"},
    "relu": {"nonlin": "relu"},
    "gelu": {"nonlin": "gelu"},
    "mish": {"nonlin": "mish"},
    "slope": {"negative_slope": 0.2},
    "relu_bias": {"nonlin": "relu", "seg_output_bias": True},
    "3conv": {"conv_per_stage": 3},
    "3conv_base24": {"conv_per_stage": 3, "base_num_features": 24},
    "all3x3": {"conv_kernel_sizes": KERNELS},
    "nonlin_first": {"nonlin_first": True},
    "relu_nonlin_first": {"nonlin": "relu", "nonlin_first": True},
}


def _randomize(net, seed: int):
    """He init from a seed, every norm parameter and head bias moved off its
    init."""
    init_weights_he(net, torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, v in net.named_parameters():
            if ".instnorm." in k or k.startswith("seg_outputs.") and k.endswith("bias"):
                v.add_(torch.randn(v.shape, generator=gen) * 0.3)
    return net


def _nets(overrides: dict, kernels=KERNELS, seed=0):
    """The JAX GenericUNet with `overrides` and its params, which the port's
    network holds through io/from_jax.py (the params made by the port's
    seeded init through io/torch_convert.py, both ways bit-exact)."""
    kw = dict(input_channels=1, base_num_features=8, num_classes=K,
              pool_op_kernel_sizes=POOLS, conv_kernel_sizes=kernels)
    kw.update(overrides)
    jnet = JaxGenericUNet(**kw, dtype=jnp.float32)
    cps = overrides.get("conv_per_stage", 2)
    sd = _randomize(GenericUNet(**kw, dtype=torch.float32), seed).state_dict()
    params = convert_generic_unet_state_dict(sd, len(POOLS), cps)
    net = GenericUNet(**kw, dtype=torch.float32)
    carried = generic_unet_state_dict_from_flax(params, len(POOLS), cps)
    assert all(torch.equal(carried[k], v) for k, v in sd.items())
    net.load_state_dict(carried)
    x = np.random.RandomState(seed + 10).randn(2, 8, 8, 8, 1).astype(np.float32)
    return jnet, params, net, x


def _logits(net, x, deep_supervision=True):
    out = net(torch.from_numpy(np.moveaxis(x, -1, 1)), deep_supervision=deep_supervision)
    return [np.moveaxis(o.detach().numpy(), 1, -1) for o in out]


@pytest.mark.parametrize("knob", list(KNOBS))
def test_network_knob_matches_jax(knob):
    overrides = KNOBS[knob]
    kernels = ANISO if knob == "all3x3" else KERNELS
    jnet, params, net, x = _nets(overrides, kernels)
    assert (net.norm, net.nonlin) == (overrides.get("norm", "instance"),
                                      overrides.get("nonlin", "leaky_relu"))
    first = overrides.get("nonlin_first", False)
    encoder, bottleneck = net.encoder_stages()[:-1], net.encoder_stages()[-1]
    assert all(b.nonlin_first == first for st in encoder + net.decoder_stages() for b in st)
    assert not any(b.nonlin_first for b in bottleneck)  # norm -> nonlin, as the JAX module
    ref = jnet.apply({"params": params}, jnp.asarray(x), deep_supervision=True)
    for r, g in zip(ref, _logits(net, x), strict=True):
        np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if knob == "batch":  # no running statistics: eval normalizes by the batch
        for r, g in zip(ref, _logits(net.eval(), x), strict=True):
            np.testing.assert_allclose(g, np.asarray(r), **TOL)
    if knob == "frn":
        assert "conv_blocks_context.0.blocks.0.instnorm.tau" in net.state_dict()
    if knob == "none":
        assert not any(".instnorm." in k for k in net.state_dict())


def test_group_norm_refuses_channels_it_cannot_group():
    """The flagship's 30 channels do not divide into 8 groups: the JAX
    package's flax GroupNorm raises, and the port too."""
    with pytest.raises(ValueError, match="8 groups"):
        GenericUNet(1, 30, K, POOLS, KERNELS, norm="group")


# --------------------------------------------------------------- the trainers
VARIANTS = {
    "TrainerV2BN": ("nnUNetTrainerV2_BN",),
    "TrainerV2GN": ("nnUNetTrainerV2_GN",),
    "TrainerV2FRN": ("nnUNetTrainerV2_FRN",),
    "TrainerV2NoNorm": ("nnUNetTrainerV2_NoNormalization",),
    "TrainerV2NoNormLR1en3": ("nnUNetTrainerV2_NoNormalization_lr1en3",),
    "TrainerV2ReLU": ("nnUNetTrainerV2_ReLU",),
    "TrainerV2GeLU": ("nnUNetTrainerV2_GeLU",),
    "TrainerV2Mish": ("nnUNetTrainerV2_Mish",),
    "TrainerV2LReLUSlope2en1": ("nnUNetTrainerV2_LReLU_slope_2en1",),
    "TrainerV2ReLUBiasInSegOutput": ("nnUNetTrainerV2_ReLU_biasInSegOutput",),
    "TrainerV2LReLUBiasInSegOutput": ("nnUNetTrainerV2_lReLU_biasInSegOutput",),
    "TrainerV2_3ConvPerStage": ("nnUNetTrainerV2_3ConvPerStage",),
    "TrainerV2_3ConvPerStageSameFilters": ("nnUNetTrainerV2_3ConvPerStageSameFilters",),
    "TrainerV2AllConv3x3": ("nnUNetTrainerV2_allConv3x3",),
    "TrainerV2ReLUConvReLUIN": ("nnUNetTrainerV2_ReLU_convReLUIN",),
    "TrainerV2LReLUConvReLUIN": ("nnUNetTrainerV2_lReLU_convReLUIN",),
    "TrainerV2FP32": ("nnUNetTrainerV2_fp32",),
    "TrainerV2NoDA": ("nnUNetTrainerV2_noDataAugmentation", "nnUNetTrainerV2_noDA",
                      "nnUNetTrainerNoDA"),
    "TrainerV2NoMirroring": ("nnUNetTrainerV2_noMirroring",),
    "TrainerV2InsaneDA": ("nnUNetTrainerV2_insaneDA",),
    "TrainerV2DA5": ("nnUNetTrainerV2_DA5", "nnUNetTrainerV2_DA3"),
    "TrainerV2DA2": ("nnUNetTrainerV2_DA2",),
    "TrainerV2IndependentScale": ("nnUNetTrainerV2_independentScalePerAxis",),
    "TrainerV2DA3BN": ("nnUNetTrainerV2_DA3_BN",),
    "TrainerV2ResencUNetDA3": ("nnUNetTrainerV2_ResencUNet_DA3",),
    "TrainerV2ResencDA3BN": ("nnUNetTrainerV2_ResencUNet_DA3_BN",),
    "TrainerV2NoDeepSupervision": ("nnUNetTrainerV2_noDeepSupervision",),
    "TrainerV2ForceBD": ("nnUNetTrainerV2_ForceBD",),
    "TrainerV2ForceSD": ("nnUNetTrainerV2_ForceSD",),
    "TrainerV2": ("nnUNetTrainerV2_copy1", "nnUNetTrainerV2_copy2", "nnUNetTrainerV2_copy3",
                  "nnUNetTrainerV2_copy4", "nnUNetTrainerV2_fp16"),
    "TrainerV2_2epochsDummyLoad": ("nnUNetTrainerV2_2epochs_dummyLoad",),
    "TrainerV2_5epochsNoDS": ("nnUNetTrainerV2_5epochs_noDS",),
    "TrainerV2_5epochsCEnoDS": ("nnUNetTrainerV2_5epochs_CEnoDS",),
    "TrainerV2_5epochsDummyCEnoDS": ("nnUNetTrainerV2_5epochs_dummyLoadCEnoDS",),
    "TrainerV2_5epochs": ("nnUNetTrainerV2_DDP_5epochs",),
    "TrainerV2_dummyLoad": ("nnUNetTrainerV2_DDP_5epochs_dummyLoad",),
    # the loss, optimizer and schedule variants keep TrainerV2's network
    "TrainerV2LossCE": ("nnUNetTrainerV2_Loss_CE", "nnUNetTrainerCE"),
    "TrainerV2LossDice": ("nnUNetTrainerV2_Loss_Dice",),
    "TrainerV2LossDiceBG": ("nnUNetTrainerV2_Loss_DicewithBG",),
    "TrainerV2LossTopKOnly": ("nnUNetTrainerV2_Loss_TopK10",),
    "TrainerV2LossTopK": ("nnUNetTrainerV2_Loss_CEandTopK10", "nnUNetTrainerV2_Loss_DiceTopK10"),
    "TrainerV2FocalLoss": ("nnUNetTrainerV2_focalLoss",),
    "TrainerV2GDL": ("nnUNetTrainerV2_GDL",),
    "TrainerV2LossCEGDL": ("nnUNetTrainerV2_Loss_CEGDL",),
    "TrainerV2LossMCC": ("nnUNetTrainerV2_Loss_MCC",),
    "TrainerV2LossMCCnoBG": ("nnUNetTrainerV2_Loss_MCCnoBG",),
    "TrainerV2LossSquaredDice": ("nnUNetTrainerV2_Loss_DC_CE_squared",
                                 "nnUNetTrainerV2_SquaredDiceCE"),
    "TrainerV2LossDiceSquared": ("nnUNetTrainerV2_Loss_Dice_squared",),
    "TrainerV2LossDiceCENoSmooth": ("nnUNetTrainerV2_Loss_DiceCE_noSmooth",),
    "TrainerV2CEtoDice": ("nnUNetTrainerV2_graduallyTransitionFromCEToDice",),
    "TrainerV2Adam": ("nnUNetTrainerV2_Adam",),
    "TrainerV2AdamTrainerLR": ("nnUNetTrainerV2_Adam_nnUNetTrainerlr",),
    "TrainerV2ConstLR": ("nnUNetTrainerV2_SGD_fixedSchedule", "nnUNetTrainerV2_constLR"),
    "TrainerV2Momentum09": ("nnUNetTrainerV2_momentum09",),
    "TrainerV2Momentum095": ("nnUNetTrainerV2_momentum095",),
    "TrainerV2Momentum098": ("nnUNetTrainerV2_momentum098",),
    "TrainerV2Momentum09in2D": ("nnUNetTrainerV2_momentum09in2D",),
    "TrainerV2Ranger": ("nnUNetTrainerV2_Ranger_lr3en4", "nnUNetTrainerV2_Ranger"),
    "TrainerV2SGDlr1en1": ("nnUNetTrainerV2_SGD_lr1en1",),
    "TrainerV2SGDlr1en3": ("nnUNetTrainerV2_SGD_lr1en3",),
    "TrainerV2LossDiceLR1en3": ("nnUNetTrainerV2_Loss_Dice_LR1en3",),
    "TrainerV2LossDiceBGLR1en3": ("nnUNetTrainerV2_Loss_DicewithBG_LR1en3",),
    "TrainerV2Rangerlr1en2": ("nnUNetTrainerV2_Ranger_lr1en2",),
    "TrainerV2Rangerlr3en3": ("nnUNetTrainerV2_Ranger_lr3en3",),
    "TrainerV2CycleAtEnd": ("nnUNetTrainerV2_cycleAtEnd",),
    "TrainerV2CycleAtEnd2": ("nnUNetTrainerV2_cycleAtEnd2",),
    "TrainerV2SGDPlateau": ("nnUNetTrainerV2_SGD_ReduceOnPlateau",),
    "TrainerV2AdamPlateau": ("nnUNetTrainerV2_Adam_ReduceOnPlateau",),
    "TrainerV2FixedSchedule2": ("nnUNetTrainerV2_SGD_fixedSchedule2",),
    "TrainerV2ReduceMomentum": ("nnUNetTrainerV2_reduceMomentumDuringTraining",),
    "TrainerV2Resample33": ("nnUNetTrainerV2_resample33",),
}
NAMES = [(cls, name) for cls, aliases in VARIANTS.items() for name in (cls, *aliases)]


def _plans(resenc: bool = False) -> Plans:
    """Plans of base 16 with an anisotropic first stage (allConv3x3 changes
    it); the resenc trainers' with block counts and a leading (1, 1, 1)."""
    d = tiny_plans(patch=(8, 16, 16)).to_dict()
    d["base_num_features"] = 16
    st = d["plans_per_stage"][0]
    st.update(num_pool_per_axis=[1, 2, 2], pool_op_kernel_sizes=[[1, 2, 2], [2, 2, 2]],
              conv_kernel_sizes=[[1, 3, 3], [3, 3, 3], [3, 3, 3]])
    if resenc:
        st.update(pool_op_kernel_sizes=[[1, 1, 1], [1, 2, 2], [2, 2, 2]],
                  conv_kernel_sizes=[[1, 3, 3], [3, 3, 3], [3, 3, 3]],
                  num_blocks_encoder=[1, 1, 1], num_blocks_decoder=[1, 1])
    return Plans.from_dict(d)


def _set_up(cls, plans):
    t = cls(plans, 0)
    t.plans = plans
    t.process_plans(plans)
    t.setup_DA_params()
    return t


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple, np.ndarray)):
        return np.array_equal(np.asarray(a, dtype=object), np.asarray(b, dtype=object))
    return a == b


@pytest.mark.parametrize("cls_name,name", NAMES)
def test_variant_resolves_and_matches_the_jax_trainer(cls_name, name):
    port_cls, jax_cls = TRAINERS[name], resolve_trainer(name)
    assert port_cls.__name__ == jax_cls.__name__ == cls_name
    resenc = "Resenc" in cls_name
    plans = _plans(resenc)
    p, j = _set_up(port_cls, port_plans(plans)), _set_up(jax_cls, plans)
    assert _same(p.network_overrides(), j.network_overrides())
    assert _same(p.data_aug_params, j.data_aug_params)
    np.testing.assert_array_equal(p.basic_generator_patch_size, j.basic_generator_patch_size)
    for attr in ("initial_lr", "batch_dice", "fp16", "deep_supervision",
                 "deep_supervision_scales", "max_num_epochs"):
        assert _same(getattr(p, attr), getattr(j, attr)), attr
    p.initialize_network()
    net = p.network
    if resenc:
        assert isinstance(net, ResidualEncoderUNet)
        return
    over = p.network_overrides()
    assert isinstance(net, GenericUNet) and net.dtype == (torch.bfloat16 if p.fp16
                                                          else torch.float32)
    assert (net.norm, net.nonlin, net.negative_slope, net.seg_output_bias,
            net.nonlin_first) == (
        over.get("norm", "instance"), over.get("nonlin", "leaky_relu"),
        over.get("negative_slope", 1e-2), over.get("seg_output_bias", False),
        over.get("nonlin_first", False))
    convs = sum(1 for k in net.state_dict() if k.endswith(".conv.weight"))
    assert convs == (2 * len(POOLS) + 1) * over.get("conv_per_stage", 2)
    assert net.features[0] == over.get("base_num_features", 16)
    first = net.conv_blocks_context[0].blocks[0].conv.kernel_size
    assert first == ((3, 3, 3) if "conv_kernel_sizes" in over else (1, 3, 3))


RESTORED = ["nnUNetTrainerV2_GN", "TrainerV2FRN", "nnUNetTrainerV2_NoNormalization",
            "nnUNetTrainerV2_lReLU_biasInSegOutput", "nnUNetTrainerV2_3ConvPerStage",
            "nnUNetTrainerV2_allConv3x3", "nnUNetTrainerV2_fp32",
            "nnUNetTrainerV2_ReLU_convReLUIN", "TrainerV2LReLUConvReLUIN"]


@pytest.mark.parametrize("name", RESTORED)
def test_variant_folders_restore_the_same_network(tmp_path, name):
    cls = TRAINERS[name]
    plans = port_plans(_plans())
    over = cls.network_overrides_for(plans, 0)
    fp16 = name != "nnUNetTrainerV2_fp32"
    net = _randomize(build_unet_from_plans(plans, 0, num_classes=K, dtype=torch.float32,
                                           **over), 3)
    sd = net.state_dict()
    x = np.random.RandomState(9).randn(1, 8, 16, 16, 1).astype(np.float32)
    for layout, save in (("ckpt", save_jax_model_folder), ("model", save_model_folder)):
        folder = str(tmp_path / layout)
        save(folder, plans, [sd], name, fp16=fp16)
        restored = load_model_and_checkpoint_files(folder, device="cpu").networks[0]
        assert restored.dtype == (torch.bfloat16 if fp16 else torch.float32)
        assert (restored.norm, restored.nonlin, restored.seg_output_bias,
                restored.nonlin_first) == (net.norm, net.nonlin, net.seg_output_bias,
                                           net.nonlin_first)
        assert restored.state_dict().keys() == sd.keys()
        assert all(torch.equal(restored.state_dict()[k], v) for k, v in sd.items())
    # the restored weights through the bridge give the JAX network the same logits
    params = convert_generic_unet_state_dict(sd, len(plans.stage(0).pool_op_kernel_sizes),
                                             over.get("conv_per_stage", 2))
    st = plans.stage(0)
    kw = dict(input_channels=1, base_num_features=16, num_classes=K, dtype=jnp.float32,
              pool_op_kernel_sizes=tuple(map(tuple, st.pool_op_kernel_sizes)),
              conv_kernel_sizes=tuple(map(tuple, st.conv_kernel_sizes)))
    jnet = JaxGenericUNet(**{**kw, **over})
    ref = jnet.apply({"params": params}, jnp.asarray(x), deep_supervision=False)
    got = _logits(net, x, deep_supervision=True)[0]
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


@pytest.mark.parametrize("switch", ["MTTPU_FUSED_NORM", "MTTPU_FUSED_TRAIN"])
def test_fused_switch_leaves_a_variant_network_unfused(monkeypatch, switch):
    """The fused route takes what the JAX package packs: InstanceNorm and
    LeakyReLU (any slope, a head bias); a batch-norm, a ReLU or a conv ->
    LeakyReLU -> InstanceNorm network (nonlin_first, which the JAX packed
    route never checks) under the switch runs its own forward, and a warning
    says so."""
    monkeypatch.setenv(switch, "1")
    make = make_inference_forward if switch == "MTTPU_FUSED_NORM" else make_train_forward
    for over in ({"norm": "batch"}, {"nonlin": "relu"}, {"nonlin_first": True}):
        net = GenericUNet(1, 8, K, POOLS, KERNELS, dtype=torch.float32, **over)
        with pytest.warns(UserWarning, match="runs its own forward"):
            assert make(net) is net
    net = GenericUNet(1, 8, K, POOLS, KERNELS, dtype=torch.float32, negative_slope=0.2,
                      seg_output_bias=True)
    assert make(net) is not net
