"""Data-parallel training over ranks with torch.distributed.

Counterpart of multitalent_tpu/parallel/mesh.py. The JAX package shards the
global batch of one jitted step over a device mesh; the port runs one
process per card (NCCL; gloo on the CPU), each with its share of the global
batch, and keeps the semantics of one device with the global batch:

- `distribute_batch_size` (mesh.py:207-233): the reference's split of the
  global batch over the ranks and each rank's share of the foreground-forced
  tail;
- `global_sum`: an all-reduce (sum) whose backward hands each rank the
  gradient of its own summand. With it the loss of every rank is the loss of
  the global batch (batch-Dice statistics, BCE and CE sums pooled over the
  ranks, the counterpart of `axis_name` at JAX losses.py:141,177-183), and its
  gradient on a rank is that rank's share of the global gradient;
- `wrap` puts the network under DistributedDataParallel with a comm hook that
  sums the shares (DDP's default averages them), so every rank takes the
  global-batch gradient and, from the same weights, the same update.

A global batch smaller than the rank count takes the JAX package's spatial
("space") axis (parallel/mesh.py): `layout` plans the step
(mesh.plan_batch_sharding), forms the space groups (and, where the plan
leaves ranks idle, the group of the ranks that train, which every helper
here then uses) and gives this rank its data index and its `mesh.Space`.
A run without a process group (one process) takes none of these paths.
"""
from __future__ import annotations

import os
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from multitalent_tpu_torch.parallel import mesh


def distribute_batch_size(global_batch_size: int, num_shards: int):
    """Split a global batch over shards with the reference's remainder policy and
    per-shard foreground-oversample fractions
    (nnUNetTrainerV2_DDP.set_batch_size_and_oversample, :75-117): shard i gets
    batch//N (+1 for the first batch%N shards); with global oversample fraction o,
    the *last* o-fraction of the global batch is foreground-forced, so each shard's
    local fraction is the overlap of its sample range with that tail.

    Returns (per_shard_batch_sizes, per_shard_oversample_fn) where
    per_shard_oversample_fn(global_oversample) -> list of per-shard fractions.
    """
    base = global_batch_size // num_shards
    rem = global_batch_size % num_shards
    sizes = [base + (1 if i < rem else 0) for i in range(num_shards)]

    def oversample_fractions(global_oversample: float) -> list[float]:
        cutoff = round(global_batch_size * (1 - global_oversample))
        fracs = []
        start = 0
        for bs in sizes:
            end = start + bs
            forced = max(0, end - max(cutoff, start))
            fracs.append(forced / bs if bs else 0.0)
            start = end
        return fracs

    return sizes, oversample_fractions


def rank_batch(global_batch_size: int, oversample: float, index: int,
               shards: int) -> tuple[int, float]:
    """(local batch size, local foreground-oversample fraction) of shard
    `index` of `shards` (a rank's data index under its plan)."""
    sizes, fractions = distribute_batch_size(global_batch_size, shards)
    if sizes[index] == 0:
        raise ValueError(f"shard {index} of {shards} gets no sample of a global batch of "
                         f"{global_batch_size}; plan the ranks with `layout`")
    return sizes[index], fractions(oversample)[index]


# ----------------------------------------------------------------- the group
def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


_TRAINING = None  # the group of the ranks that train, where a plan leaves some idle


def group():
    """The group of the ranks that train: the default group unless the plan
    leaves ranks idle; None in a run without a group."""
    if not is_initialized():
        return None
    return _TRAINING if _TRAINING is not None else dist.group.WORLD


def rank() -> int:
    """This rank in `group()`."""
    return dist.get_rank(group()) if is_initialized() else 0


def world_size() -> int:
    """The ranks of `group()`."""
    return dist.get_world_size(group()) if is_initialized() else 1


def backend() -> str:
    return dist.get_backend()


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    if is_initialized():
        dist.barrier(group=group())


def launched() -> bool:
    """Whether a launcher (torchrun, torch.distributed.launch, `spawn`) started
    this process as one rank of a group."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device_type: str, backend: str | None = None,
                       device_index: int | None = None) -> torch.device:
    """Join the group that the environment describes (RANK, WORLD_SIZE,
    MASTER_ADDR, MASTER_PORT; LOCAL_RANK names the card), as torchrun and
    `spawn` leave it: NCCL on cards, gloo on the CPU unless `backend` says
    otherwise. Returns this rank's device (`device_index` overrides the
    local rank's card, e.g. for ranks that share one card)."""
    if device_type == "cuda":
        index = int(os.environ.get("LOCAL_RANK", 0)) if device_index is None else device_index
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {os.environ['RANK']} needs card {index}, but "
                               f"{torch.cuda.device_count()} card(s) are visible")
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    else:
        device = torch.device(device_type)
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    global _TRAINING
    _LAYOUTS.clear()
    _TRAINING = None
    dist.init_process_group(backend, rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]))
    return device


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(index: int, fn, world: int, port: int, args: tuple) -> None:
    os.environ.update(RANK=str(index), LOCAL_RANK=str(index), WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    fn(*args)


def spawn(fn, world: int, args: tuple = ()) -> None:
    """Run fn(*args) in `world` new processes, one a rank, with the
    environment `init_process_group` reads (a free port on localhost). Waits
    for all; raises if any rank raised or died, after stopping the others."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_entry, args=(fn, world, free_port(), args), nprocs=world,
                       join=True, start_method="spawn")


# ------------------------------------------------------------ the plan's ranks
@dataclass(frozen=True)
class Layout:
    """This rank's place under a plan: its data index of `data` (which
    samples of the global batch it draws) and its `mesh.Space` (None
    without a spatial split)."""

    plan: mesh.BatchShardingPlan | None
    data_index: int = 0
    data: int = 1
    space: mesh.Space | None = None


_LAYOUTS: dict[tuple, tuple[Layout | None, object]] = {}


def layout(global_batch_size: int, patch_size, device_type: str) -> Layout | None:
    """This rank's Layout under the plan of (global batch, patch) over the
    default group's ranks (mesh.plan_batch_sharding); None for a rank the
    plan leaves idle. The first call for a plan forms its groups, which is
    collective: every rank makes it, idle ones too, in the same order. Its
    group of training ranks is `group()` from then on. Without a group: one
    rank with the whole batch."""
    global _TRAINING
    if not is_initialized():
        return Layout(None)
    world, me = dist.get_world_size(), dist.get_rank()
    key = (int(global_batch_size), tuple(int(p) for p in patch_size), world)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = _form(mesh.plan_batch_sharding(global_batch_size, patch_size, world),
                              me, device_type)
    mine, _TRAINING = _LAYOUTS[key]
    return mine


def _form(plan: mesh.BatchShardingPlan | None, me: int, device_type: str):
    """(this rank's Layout or None if idle, the group of training ranks or
    None for the default group) of `plan`, its groups formed."""
    if plan is None:
        return Layout(None), None
    # new_group is collective over the default group: idle ranks make it too
    training = dist.new_group(list(range(plan.ranks))) if plan.ranks < plan.world else None
    groups = [dist.new_group(list(range(d * plan.space, (d + 1) * plan.space)))
              for d in range(plan.data)] if plan.space > 1 else []
    coords = plan.coords(me)
    if coords is None:
        return None, training
    d, s = coords
    space = None
    if groups:
        exchange = "p2p" if backend() == "nccl" or device_type == "cpu" else "collective"
        space = mesh.Space(groups[d], list(range(d * plan.space, (d + 1) * plan.space)), s,
                           plan.space_axis, exchange)
        # a first collective on the group, before its point-to-point exchanges
        dist.all_reduce(torch.zeros(1, device="cuda" if device_type == "cuda" else "cpu"),
                        group=groups[d])
    return Layout(plan, d, plan.data, space), training


# ------------------------------------------------------------- collectives
def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """t summed over the ranks, in place (no autograd); t as it is without a
    group."""
    if is_initialized():
        dist.all_reduce(t, group=group())
    return t


class _GlobalSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        # every rank computes the same function of the sum, so the gradient
        # of the rank's own summand is the incoming one; the ranks' shares of
        # the parameters' gradient are summed by the DDP hook
        return g, None


def global_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the ranks of `group`, differentiable: the backward
    passes each rank the gradient of its own summand."""
    return _GlobalSum.apply(x, group)


def agree(flag: bool) -> bool:
    """A decision every rank takes from all-reduced values (continue training
    or stop); raises if the ranks disagree, which would leave some waiting in
    a collective that the others never reach."""
    if not is_initialized():
        return flag
    votes = torch.tensor([float(flag), float(not flag)])
    if dist.get_backend() == "nccl":
        votes = votes.cuda()
    dist.all_reduce(votes, group=group())
    if votes.min() > 0:
        raise RuntimeError(f"the ranks disagree on whether to go on: {int(votes[0])} of "
                           f"{world_size()} say yes")
    return flag


# -------------------------------------------------------------------- DDP
def _sum_hook(group, bucket):
    """DDP comm hook: the bucket's gradients summed over the ranks (DDP's
    default hook divides by the world size first)."""
    fut = dist.all_reduce(bucket.buffer(), group=group, async_op=True).get_future()
    return fut.then(lambda f: f.value()[0])


class TrainForward(torch.nn.Module):
    """The training forward as a module, so that DDP sees a call per step:
    `forward` computes the logits from `net`'s parameters (the network
    itself, or the fused route over it)."""

    def __init__(self, net: torch.nn.Module, forward):
        super().__init__()
        self.net = net
        self.route = None if forward is net else forward

    def forward(self, x, deep_supervision: bool = False):
        return (self.route or self.net)(x, deep_supervision=deep_supervision)


def wrap(net: torch.nn.Module, forward, device: torch.device,
         ignore: set[int] = frozenset()):
    """`forward` over `net` under DistributedDataParallel on `group()`: the gradients are summed over the ranks (so each rank's loss must
    be its share of the global loss, as `global_sum` makes it); parameters
    whose id is in `ignore` (the heads no loss reaches) are left out of the
    reducer and keep no gradient; so are those without requires_grad, which
    is why a trainer that changes them builds a new wrapper."""
    from torch.nn.parallel import DistributedDataParallel as DDP
    module = TrainForward(net, forward)
    DDP._set_params_and_buffers_to_ignore_for_model(
        module, [n for n, p in module.named_parameters() if id(p) in ignore])
    ddp = DDP(module, device_ids=[device.index] if device.type == "cuda" else None,
              process_group=group())
    ddp.register_comm_hook(group(), _sum_hook)
    return ddp
