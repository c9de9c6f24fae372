"""Rank workers of the data-parallel tests (tests/test_torch_port_ddp*.py).

`parallel.distributed.spawn` starts each in its own process (gloo on the
CPU). They import torch and the port only, never jax: each rank trains the
port's trainer on its rows of the same global host batches and saves what it
saw, for the test process to hold against the JAX package's single-device
trainer. No tests here.
"""
import os

import torch

from multitalent_tpu_torch.parallel import distributed
from multitalent_tpu_torch.plans import Plans
from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer
from multitalent_tpu_torch.training.trainers import TrainerV2
from multitalent_tpu_torch.training.warmup import TrainerV2WarmupSegHeads

TRAINERS = {c.__name__: c for c in (MultiTalentTrainer, TrainerV2, TrainerV2WarmupSegHeads)}


def rows(batch: dict, rank: int, world: int) -> dict:
    """A rank's share of a global host batch: its rows under
    distribute_batch_size's split, in order."""
    sizes, _ = distributed.distribute_batch_size(len(batch["keys"]), world)
    lo = sum(sizes[:rank])
    return {k: v[lo:lo + sizes[rank]] for k, v in batch.items()}


def make_trainer(run: dict, device: str = "cpu"):
    """The run's trainer, initialised without a dataset, augmentation as the
    run says, from the run's weights."""
    t = TRAINERS[run["trainer"]](Plans.from_dict(run["plans"]), 0, run["output_folder"],
                                 None, batch_dice=run.get("batch_dice", True), fp16=False,
                                 device=device)
    t.initialize(True)
    t.data_aug_params.update(run["aug"])
    t._build_step_functions()
    t.network.load_state_dict(run["weights"])
    return t


def snapshot(t) -> dict:
    return {k: v.detach().clone() for k, v in t.network.state_dict().items()}


def train(run: dict) -> dict:
    """Train `run` on this rank: its rows of each global batch, the warm-up's
    phase switch before batch `switch_at`, then one validation batch with the
    online evaluation."""
    t = make_trainer(run)
    # a rank draws its data group's rows (its own rows without a space axis)
    index, shards = t.layout.data_index, t.layout.data
    losses, phase1 = [], None
    for i, batch in enumerate(run["batches"]):
        if i == run.get("switch_at"):
            phase1 = snapshot(t)
            t._switch_to_phase2()
        losses.append(t.run_iteration(iter([rows(batch, index, shards)])))
    out = {"losses": losses, "weights": snapshot(t), "phase1": phase1,
           "local_batch": t.local_batch_size, "wrapped": t.ddp is not None,
           "space": None if t.space is None else (t.space.index, t.space.size, t.space.axis,
                                                  dict(t.space.sent))}
    if run.get("val_batch") is not None:
        out["val_loss"] = t.run_iteration(iter([rows(run["val_batch"], index, shards)]),
                                          False, True)
        t.finish_online_evaluation()
        out["online_dice"] = t.all_val_eval_metrics[-1]
    return out


def slab_statistics(x, space):
    """In place of mesh.space_sum: this rank's own sum, scaled as the pooled
    one would be; a norm then takes each slab's own statistics (the control
    of the space tests)."""
    return x * space.size


def train_runs(spec_file: str, out_prefix: str) -> None:
    """Every run of the spec on this rank (a run with `slab_norms` set
    normalises each slab with its own statistics); saves {name: result} to
    `<out_prefix>.<rank>.pt`."""
    from multitalent_tpu_torch.parallel import mesh
    torch.set_num_threads(1)
    distributed.init_process_group("cpu")
    try:
        spec = torch.load(spec_file, weights_only=False)
        results = {}
        for name, run in spec.items():
            pooled = mesh.space_sum
            if run.get("slab_norms"):
                mesh.space_sum = slab_statistics
            try:
                results[name] = train(run)
            finally:
                mesh.space_sum = pooled
        torch.save(results, f"{out_prefix}.{distributed.rank()}.pt")
    finally:
        torch.distributed.destroy_process_group()


def loss_ranks(spec_file: str, out_prefix: str) -> None:
    """This rank's row of the spec's logits and labels through the losses of
    `LOSSES` with the process group: each loss's value and the gradient of
    its logits, saved to `<out_prefix>.<rank>.pt`."""
    from multitalent_tpu_torch.training import losses
    torch.set_num_threads(1)
    distributed.init_process_group("cpu")
    try:
        spec = torch.load(spec_file, weights_only=False)
        rank, world = distributed.rank(), distributed.world_size()
        out = {}
        for name in spec["losses"]:
            x = torch.from_numpy(spec["logits"][rank::world]).requires_grad_(True)
            loss = getattr(losses, name)(x, torch.from_numpy(spec["labels"][rank::world]),
                                         group=distributed.group())
            loss.backward()
            out[name] = {"value": loss.item(), "grad": x.grad.numpy()}
        torch.save(out, f"{out_prefix}.{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_loss_ranks(logits, labels, folder, losses=("topk_cross_entropy", "gdl_loss"),
                   world: int = 2) -> list[dict]:
    """Spawn `world` gloo ranks, rank r taking rows r, r + world, ... of
    (logits, labels), through `losses`; each rank's results."""
    spec_file, prefix = os.path.join(folder, "loss_spec.pt"), os.path.join(folder, "loss")
    torch.save({"logits": logits, "labels": labels, "losses": losses}, spec_file)
    distributed.spawn(loss_ranks, world, (spec_file, prefix))
    return [torch.load(f"{prefix}.{r}.pt", weights_only=False) for r in range(world)]


def run_ranks(spec: dict, folder, world: int = 2) -> list[dict]:
    """Spawn `world` gloo ranks over `spec`; each rank's results."""
    spec_file, prefix = os.path.join(folder, "spec.pt"), os.path.join(folder, "ranks")
    torch.save(spec, spec_file)
    distributed.spawn(train_runs, world, (spec_file, prefix))
    return [torch.load(f"{prefix}.{r}.pt", weights_only=False) for r in range(world)]
