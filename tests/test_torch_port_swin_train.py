"""The SwinUNETR's MultiTalent trainer, its `.ckpt` folder and the head
warm-up on the CPU, against the JAX package's.

- MultiTalentTrainerSwinUNETR (47 sigmoid regions, AMSGrad Adam at 5e-4)
  against the JAX package's, from the same weights (the port's init carried
  into the JAX trainer's state by io/torch_convert.
  convert_swin_unetr_state_dict: flax's own init of a SwinUNETR costs
  XLA:CPU a long compile), on the same three host batches, in fp32, every
  augmentation off as in test_torch_port_train_slice.py, at the trainers'
  feature_size 48 on a 32^3 patch, batch 2. Before each step the port takes
  the JAX trainer's params and optimizer state, so each step is compared
  from one state (check_pair): the loss at rtol 1e-5, the gradient (the
  first moment) at 1e-2 in norm, and at least 90% of the new parameters at
  atol 2e-6 + rtol 1e-4, as test_torch_port_resenc_train.py holds the
  resenc's, none beyond 2.5 LR. Adam's step is about g / (|g| + 1e-8), so
  an element whose gradient lies at summation-noise level takes a step of
  up to one LR either way: at a 32^3 patch the bottleneck runs at 1^3 and
  2^3 (2-6% of its gradients below 1e-8), the conv biases of the basic
  blocks feed an instance norm that cancels them (at most 1.5 LR a step in
  both), and the instance norms amplify rounding (the two packages'
  gradients differ by up to 3.8e-3 in norm). Without the resync the third
  step's loss drifts 2.6e-5 apart.
- The JAX trainer's `.ckpt` restores in the port with the JAX logits.
- The head warm-up: the JAX package's predicate ("seg" in the path) masks
  every SwinUNETR gradient to zero in phase 1, the port trains `out.*`;
  its phase 2 is AMSGrad Adam over every parameter.

(TrainerV2SwinUNETR: test_torch_port_swin_train_softmax.py.)
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multitalent_tpu.data.dataset import load_dataset
from multitalent_tpu.data.loader import PatchSampler3D
from multitalent_tpu.parallel import mesh
from multitalent_tpu.training import trainers as jax_trainers
from multitalent_tpu.training.multitalent import (
    MultiTalentTrainerSwinUNETR as JaxMultiTalentTrainerSwinUNETR)
from multitalent_tpu.training.train_state import TrainState
from multitalent_tpu.training.warmup import (
    TrainerV2WarmupSegHeadsSwin as JaxTrainerV2WarmupSegHeadsSwin)
from multitalent_tpu_torch.inference.model_restore import load_model_and_checkpoint_files
from multitalent_tpu_torch.io.from_jax import swin_unetr_state_dict_from_flax
from multitalent_tpu_torch.io.torch_convert import convert_swin_unetr_state_dict
from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainerSwinUNETR
from multitalent_tpu_torch.training.train_state import AdamClipped
from multitalent_tpu_torch.training.warmup import TrainerV2WarmupSegHeadsSwin, is_seg_head_param

from test_torch_port_train_slice import NO_AUG, port_plans
from test_training import make_preprocessed, tiny_plans

PATCH = (32, 32, 32)
STEPS = 3


def swin_plans(num_classes: int):
    return tiny_plans(batch_size=2, patch=PATCH, num_classes=num_classes)


def port_init_state(self) -> None:
    """In place of the JAX trainer's flax init (costly for a SwinUNETR on
    XLA:CPU): the port's init of the same network (seed 0) as the JAX param
    tree, with the trainer's optimizer state."""
    m = self.network
    net = SwinUNETR(m.in_channels, m.out_channels, tuple(self.patch_size),
                    feature_size=m.feature_size, depths=m.depths, num_heads=m.num_heads,
                    window_size=m.window_size, dtype=torch.float32)
    net.init_weights(torch.Generator().manual_seed(0))
    params = jax.tree_util.tree_map(jnp.asarray,
                                    convert_swin_unetr_state_dict(net.state_dict()))
    self.state = TrainState.create(m.apply, params, self.initialize_optimizer())


def host_batches(tmp_path, patch_size, regions: bool):
    """Three host batches of two source datasets; with `regions` the
    MultiTalent properties (valid regions, the 009 labels as spleen, 8)."""
    def props(names, labels):
        return {"valid_regions": names, "valid_labels": labels} if regions else None

    make_preprocessed(tmp_path, n_cases=3, prefix="003", shape=(36, 40, 40),
                      extra_props=props(("03_liver", "03_cancer"), [1, 2]))
    make_preprocessed(tmp_path, n_cases=2, prefix="009", shape=(36, 40, 40),
                      extra_props=props(("09_spleen",), [8]))
    sampler = PatchSampler3D(load_dataset(str(tmp_path / "mtt_data_stage0")), patch_size,
                             PATCH, 2, oversample_foreground_percent=0.5,
                             pad_mode="constant", seed=0)
    batches = [sampler.generate_train_batch() for _ in range(STEPS)]
    for b in batches if regions else ():
        for j, k in enumerate(b["keys"]):
            if k.startswith("009"):
                b["seg"][j][b["seg"][j] > 0] = 8
    return batches


def jax_state(jt) -> tuple[dict, dict]:
    """The JAX trainer's params and AMSGrad state (count, mu, nu, nu_max) as
    the port's state dicts."""
    opt = next(st for st in jt.state.opt_state if hasattr(st, "nu_max"))
    params = swin_unetr_state_dict_from_flax(jax.device_get(jt.state.params))
    moments = {name: swin_unetr_state_dict_from_flax(jax.device_get(getattr(opt, name)))
               for name in ("mu", "nu", "nu_max")}
    return params, {"count": int(opt.count), **moments}


def _cancelled_bias(name: str) -> bool:
    return name.endswith(("conv1.bias", "conv2.bias"))


def compare_step(before: dict, jax_after: dict, jax_mu: dict, port_after: dict,
                 port_mu: dict, lr: float) -> dict:
    """Per tensor of one step from the same state: the first moment (the
    shared history plus 0.1 of the step's gradient) as |port - jax| / |jax|
    in norm; the elements of the new parameters within atol 2e-6 + rtol 1e-4
    of the JAX trainer's, and their largest gap in LRs; the largest move in
    LRs."""
    rows = {}
    for k, v in jax_after.items():
        gap = (port_after[k] - v).abs()
        rows[k] = {"mu": float((port_mu[k] - jax_mu[k]).norm()
                               / jax_mu[k].norm().clamp_min(1e-30)),
                   "close": int((gap <= 2e-6 + 1e-4 * v.abs()).sum()), "numel": v.numel(),
                   "gap_lr": float(gap.max()) / lr,
                   "move_lr": float((port_after[k] - before[k]).abs().max()) / lr}
    return rows


def run_pair(tmp, jax_cls, port_cls, plans, regions: bool) -> dict:
    """STEPS steps of both trainers on the same host batches, the port set to
    the JAX trainer's params and optimizer state before each; each step
    compared by compare_step."""
    jt = jax_cls(plans, 0, str(tmp / "jax"), None, fp16=False)
    jt.initialize(True)
    jt.data_aug_params.update(NO_AUG)
    jt._build_step_functions()
    pt = port_cls(port_plans(plans), 0, str(tmp / "port"), None, fp16=False, device="cpu")
    pt.initialize(True)
    pt.data_aug_params.update(NO_AUG)
    pt._build_step_functions()
    names = [k for k, _ in pt.network.named_parameters()]
    losses, steps = [], []
    params, opt = jax_state(jt)
    for b in host_batches(tmp, jt.basic_generator_patch_size, regions):
        pt.network.load_state_dict(params)
        pt.optimizer.load_state_dict({"count": opt["count"], **{
            m: [opt[m][k] for k in names] for m in ("mu", "nu", "nu_max")}})
        losses.append((jt.run_iteration(iter([b])), pt.run_iteration(iter([b]))))
        before, (params, opt) = params, jax_state(jt)
        port_mu = dict(zip(names, pt.optimizer.mu))
        steps.append(compare_step(before, params, opt["mu"], pt.network.state_dict(), port_mu,
                                  jt.initial_lr))
    return {"jt": jt, "pt": pt, "losses": np.array(losses), "steps": steps, "tmp": tmp}


def trainer_pair(tmp_path_factory, jax_cls, port_cls, num_classes: int, regions: bool) -> dict:
    """run_pair with the JAX trainer on one device and the port's init."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    mp.setattr(jax_trainers.TrainerV2, "_init_state", port_init_state)
    try:
        return run_pair(tmp_path_factory.mktemp("swin"), jax_cls, port_cls,
                        swin_plans(num_classes), regions)
    finally:
        mp.undo()
        torch.set_num_threads(threads)


def check_pair(r: dict, lr: float, classes: int) -> None:
    """Every step from the JAX trainer's state: the loss at rtol 1e-5; the
    gradient (the first moment) within 1e-2 of JAX's in norm, each tensor but
    the cancelled conv biases (which move at most 1.5 LR); at least 90% of
    the new parameters at atol 2e-6 + rtol 1e-4, and none more than 2.5 LR
    away. (Measured: losses 3.1e-6 apart at most, moments 3.8e-3, 96.6-99.8%
    of the parameters within the bounds, the cancelled biases 0.62 LR.)"""
    pt = r["pt"]
    assert pt.step == STEPS and isinstance(pt.network, SwinUNETR)
    assert isinstance(pt.optimizer, AdamClipped) and pt.initial_lr == r["jt"].initial_lr == lr
    assert pt.network.feature_size == 48 and pt.network.num_classes == classes
    assert list(pt.ds_loss_weights) == [1.0] and pt.deep_supervision_scales == [[1, 1, 1]]
    np.testing.assert_allclose(r["losses"][:, 1], r["losses"][:, 0], rtol=1e-5)
    for rows in r["steps"]:
        for k, row in rows.items():
            if _cancelled_bias(k):
                assert row["move_lr"] <= 1.5, (k, row)
            else:
                assert row["mu"] <= 1e-2, (k, row)
            assert row["gap_lr"] <= 2.5, (k, row)
        close = sum(row["close"] for row in rows.values())
        assert close >= 0.9 * sum(row["numel"] for row in rows.values())


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port's MultiTalentTrainerSwinUNETR over three Adam
    steps, in fp32."""
    return trainer_pair(tmp_path_factory, JaxMultiTalentTrainerSwinUNETR,
                        MultiTalentTrainerSwinUNETR, 47, True)


def test_multitalent_swin_trainer_matches_jax_over_three_adam_steps(trainers):
    check_pair(trainers, 5e-4, 47)


def test_jax_swin_checkpoint_restores_in_the_port(trainers):
    """The JAX trainer's `.ckpt` + sidecar as a model folder: the port picks
    the SwinUNETR by the flax tree's keys, the sigmoid head by the trainer,
    and its logits are the JAX network's."""
    jt, folder = trainers["jt"], trainers["tmp"] / "jax"
    jt.save_checkpoint(str(folder / "fold_0" / "model_final_checkpoint.ckpt"))
    restored = load_model_and_checkpoint_files(str(folder), [0], device="cpu")
    net = restored.networks[0]
    assert isinstance(net, SwinUNETR) and restored.inference_nonlin == "sigmoid"
    assert restored.num_classes == 47 and net.patch_size == PATCH
    x = np.random.RandomState(5).randn(1, *PATCH, 1).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, v: jt.network.apply({"params": p}, v))(
        jt.state.params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.from_numpy(np.moveaxis(x, -1, 1))).numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1), ref, atol=1e-4, rtol=1e-3)


def test_jax_warmup_freezes_swin_while_the_port_trains_its_head(monkeypatch):
    """Phase 1 of the SwinUNETR head warm-up. The JAX package's head
    predicate ("seg" in the path) matches no SwinUNETR parameter, so its
    masked AdamW zeroes every update; the port's trains `out.*` alone and
    leaves the backbone bit-unchanged."""
    monkeypatch.setattr(mesh, "plan_batch_sharding", lambda *a, **k: None)
    monkeypatch.setattr(jax_trainers.TrainerV2, "_init_state", port_init_state)
    plans = swin_plans(2)
    jt = JaxTrainerV2WarmupSegHeadsSwin(plans, 0, None, None, fp16=False)
    jt.initialize(False)
    params = jt.state.params
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert paths and not any("seg" in p for p in paths)
    grads = jax.tree_util.tree_map(jnp.ones_like, params)
    updates, _ = jt.state.tx.update(grads, jt.state.opt_state, params)
    assert all(not np.asarray(u).any() for u in jax.tree_util.tree_leaves(updates))

    pt = TrainerV2WarmupSegHeadsSwin(port_plans(plans), 0, None, None, fp16=False,
                                     device="cpu")
    pt.initialize(False)
    trained = {k for k, p in pt.network.named_parameters() if p.requires_grad}
    assert trained == {"out.weight", "out.bias"} == {k for k in pt.network.state_dict()
                                                     if is_seg_head_param(k)}
    before = {k: v.clone() for k, v in pt.network.state_dict().items()}
    x = torch.randn(1, 1, *PATCH, generator=torch.Generator().manual_seed(1))
    loss = pt.network(x).square().mean()
    pt.optimizer.zero_grad()
    loss.backward()
    pt.optimizer.step(pt.lr_schedule(0))
    after = pt.network.state_dict()
    assert {k for k in after if not torch.equal(after[k], before[k])} == trained
    # phase 2 (after head_warmup_epochs): AMSGrad Adam over every parameter
    # at 5e-4 under the poly schedule, as the JAX package's phase 2
    pt._switch_to_phase2()
    assert isinstance(pt.optimizer, AdamClipped) and pt.optimizer_phase == 2
    assert all(p.requires_grad for p in pt.network.parameters())
    assert len(pt.optimizer.params) == len(list(pt.network.parameters()))
    assert pt.lr_schedule(0) == pytest.approx(5e-4)
