"""Hybrid data x space parallelism: the plan, and the spatial ("space") axis.

Counterpart of multitalent_tpu/parallel/mesh.py:153-204 (`plan_batch_sharding`,
`BatchShardingPlan`) and of what XLA's SPMD partitioner inserts under the
JAX package's (data, space) mesh: the halo exchanges of the convs, and the
statistics pooled over the space axis. The port runs one process a rank:

- `plan_batch_sharding(batch, patch, world)` is the JAX policy without JAX.
  Where the global batch is at least the rank count, the port keeps its
  remainder split (distributed.distribute_batch_size: 5 over 2 ranks is
  3 + 2 samples, where JAX plans data 1 x space 2; the same math in another
  decomposition). Below it: data = gcd(batch, world), space = world //
  data, split along the largest patch extent that space divides (later axes
  win ties); where no extent divides, data-parallel over gcd ranks with the
  rest idle (one rank when gcd is 1), logged as JAX logs it, with WARNING.
- `Space` is this rank's place on the space axis: rank r sits at (r //
  space, r % space), as np.reshape(devices, (data, space)) orders the JAX
  mesh. Under `activated(space)` the networks (models/blocks.py,
  generic_unet.py, residual_unet.py) compute on the rank's slab of each
  sample along the split axis:
  - `halo` extends a slab by its neighbours' boundary planes (zeros at the
    patch's true edges); its backward returns the halo planes' gradient to
    their owner, which adds it;
  - `space_sum` sums over the space group, and its backward all-reduces the
    incoming gradient too: a pooled statistic feeds every rank's slab.
    (`distributed.global_sum` hands back the local gradient instead, which
    is right only where every rank computes the same function of the sum,
    as a loss does.)
  - `Levels`: a level whose extent the space size does not divide, and every
    level below it, computes whole on every rank: its input is gathered over
    the space group (backward: summed over the group, then the rank's slab),
    and the way up keeps the slab again.

Exchanges take one of two forms (`Space.exchange`): "p2p", batched
isend/irecv with each neighbour (NCCL, and gloo on CPU tensors); or
"collective", one all-reduce of every rank's boundary planes, for gloo on
CUDA tensors: gloo's point-to-point takes CPU tensors only. The gather is an
all-reduce of the zero-padded whole (gloo has no reduce-scatter, and no
all-gather of CUDA tensors).
"""
from __future__ import annotations

import collections
import contextlib
import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

CL = torch.channels_last_3d


# -------------------------------------------------------------------- the plan
@dataclass(frozen=True)
class BatchShardingPlan:
    """How `world` ranks share one training step: `data` groups of `space`
    ranks each (the rest idle), the group's ranks splitting patch axis
    `space_axis` (None: no spatial split)."""

    world: int
    data: int
    space: int = 1
    space_axis: int | None = None
    description: str = ""

    @property
    def ranks(self) -> int:
        """The ranks that train: data x space; the others are idle."""
        return self.data * self.space

    def coords(self, rank: int) -> tuple[int, int] | None:
        """(data index, space index) of `rank`; None for an idle rank."""
        return divmod(rank, self.space) if rank < self.ranks else None


def plan_batch_sharding(global_batch_size: int, patch_size,
                        world_size: int) -> BatchShardingPlan | None:
    """The plan of one training step over `world_size` ranks; None for one
    rank (the module docstring has the policy)."""
    world, bs = int(world_size), int(global_batch_size)
    if world <= 1:
        return None
    patch = [int(p) for p in patch_size]
    if bs >= world:
        local = f"{bs // world}" + (f"-{bs // world + 1}" if bs % world else "")
        return BatchShardingPlan(world, world, description=(
            f"data-parallel over {world} ranks (local batch {local})"))
    d = math.gcd(bs, world)
    s = world // d
    candidates = [(p, ax) for ax, p in enumerate(patch) if p % s == 0]
    if candidates:
        _, ax = max(candidates)
        return BatchShardingPlan(world, d, s, ax, (
            f"hybrid data x spatial parallelism over {world} ranks: batch {bs} sharded "
            f"{d}-way, patch axis {ax} (size {patch[ax]}) sharded {s}-way (halo exchanges "
            f"around the convs)"))
    return BatchShardingPlan(world, d, description=(
        f"WARNING: batch {bs} not divisible over {world} ranks and no patch axis divides "
        f"{s}; data-parallel over {d} rank(s), {world - d} idle"))


# ------------------------------------------------------------- the space axis
class Space:
    """This rank's place on the space axis: `group` (global `ranks`, in
    order along the axis), its `index` there, the split patch `axis`, the
    exchange form, and the bytes it sent by kind ("halo", "gather",
    "stats"). `whole` is set while a level computes whole (`Levels`)."""

    def __init__(self, group, ranks: list[int], index: int, axis: int, exchange: str):
        if exchange not in ("p2p", "collective"):
            raise ValueError(f"exchange {exchange!r}: p2p or collective")
        self.group, self.ranks, self.index, self.axis = group, list(ranks), index, axis
        self.size = len(self.ranks)
        self.exchange = exchange
        self.whole = False
        self.sent: collections.Counter = collections.Counter()

    @property
    def dim(self) -> int:
        """The split axis of an (N, C, Z, Y, X) tensor."""
        return 2 + self.axis

    def slab(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's slab of a whole tensor, (N, C, Z, Y, X) or a label
        map (N, Z, Y, X), along the split axis."""
        dim = x.dim() - 3 + self.axis
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n)


_ACTIVE: Space | None = None


@contextlib.contextmanager
def activated(space: Space | None):
    """Runs the block's forward on slabs of `space` (nothing without one)."""
    global _ACTIVE
    previous, _ACTIVE = _ACTIVE, space
    try:
        yield space
    finally:
        _ACTIVE = previous
        if space is not None:
            space.whole = False


def current() -> Space | None:
    """The active space axis, None outside `activated` or inside a level that
    computes whole."""
    return None if _ACTIVE is None or _ACTIVE.whole else _ACTIVE


def _cl(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=CL) if x.dim() == 5 else x.contiguous()


def _planes(x: torch.Tensor, dim: int, start: int, width: int) -> torch.Tensor | None:
    return _cl(x.narrow(dim, start, width)) if width > 0 else None


def _swap(space: Space, to_prev, to_next, kind: str):
    """(from_prev, from_next): what the previous rank sent its next and the
    next rank its previous (the shapes of this rank's to_next and to_prev),
    zeros at the patch's edges; None where nothing goes that way."""
    i, s = space.index, space.size
    from_prev = None if to_next is None else torch.zeros_like(to_next)
    from_next = None if to_prev is None else torch.zeros_like(to_prev)
    sent = [t for t, peer in ((to_prev, i - 1), (to_next, i + 1))
            if t is not None and 0 <= peer < s]
    space.sent[kind] += sum(t.numel() * t.element_size() for t in sent)
    if space.exchange == "p2p":
        # point-to-point takes contiguous (N, C, Z, Y, X) buffers only
        wire = [None if t is None else t.contiguous() for t in (from_prev, from_next)]
        ops = []
        for peer, out, into in ((i - 1, to_prev, wire[0]), (i + 1, to_next, wire[1])):
            if not 0 <= peer < s:
                continue
            if out is not None:
                ops.append(dist.P2POp(dist.isend, out.contiguous(), space.ranks[peer],
                                      space.group))
            if into is not None:
                ops.append(dist.P2POp(dist.irecv, into, space.ranks[peer], space.group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return tuple(None if t is None else _cl(t) for t in wire)
    # one all-reduce: row r holds rank r's planes for its previous, then its next
    n_prev = 0 if to_prev is None else to_prev.numel()
    n_next = 0 if to_next is None else to_next.numel()
    ref = to_prev if to_prev is not None else to_next
    buf = ref.new_zeros(s, n_prev + n_next)
    if to_prev is not None:
        buf[i, :n_prev] = to_prev.reshape(-1)
    if to_next is not None:
        buf[i, n_prev:] = to_next.reshape(-1)
    dist.all_reduce(buf, group=space.group)
    if from_prev is not None and i > 0:
        from_prev = _cl(buf[i - 1, n_prev:].view(to_next.shape))
    if from_next is not None and i < s - 1:
        from_next = _cl(buf[i + 1, :n_prev].view(to_prev.shape))
    return from_prev, from_next


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, left: int, right: int, space: Space):
        ctx.space, ctx.left, ctx.right = space, left, right
        d, n = space.dim, x.shape[space.dim]
        # this rank's first planes are its previous rank's right halo, its
        # last planes its next rank's left halo
        from_prev, from_next = _swap(space, _planes(x, d, 0, right),
                                     _planes(x, d, n - left, left), "halo")
        return _cl(torch.cat([p for p in (from_prev, x, from_next) if p is not None], d))

    @staticmethod
    def backward(ctx, g):
        space, left, right = ctx.space, ctx.left, ctx.right
        d = space.dim
        n = g.shape[d] - left - right
        gx = _cl(g.narrow(d, left, n)).clone()
        # the halos' gradient goes back to their owners, who add it
        from_prev, from_next = _swap(space, _planes(g, d, 0, left),
                                     _planes(g, d, left + n, right), "halo")
        if from_prev is not None:
            gx.narrow(d, 0, right).add_(from_prev)
        if from_next is not None:
            gx.narrow(d, n - left, left).add_(from_next)
        return gx, None, None, None


def halo(x: torch.Tensor, left: int, right: int, space: Space) -> torch.Tensor:
    """x (N, C, Z, Y, X), this rank's slab, extended along the split axis by
    `left` planes of the previous rank's and `right` of the next rank's
    (zeros at the patch's edges), in channels_last_3d."""
    if left == 0 and right == 0:
        return x
    return _Halo.apply(x, left, right, space)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space):
        ctx.space = space
        d, n = space.dim, x.shape[space.dim]
        shape = list(x.shape)
        shape[d] = n * space.size
        whole = _cl(x.new_zeros(shape))
        whole.narrow(d, space.index * n, n).copy_(x)
        space.sent["gather"] += whole.numel() * whole.element_size()
        dist.all_reduce(whole, group=space.group)
        return whole

    @staticmethod
    def backward(ctx, g):
        space = ctx.space
        g = _cl(g).clone()
        space.sent["gather"] += g.numel() * g.element_size()
        dist.all_reduce(g, group=space.group)
        return _cl(space.slab(g)), None


class _SpaceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space: Space):
        ctx.space = space
        y = x.contiguous().clone()
        space.sent["stats"] += y.numel() * y.element_size()
        dist.all_reduce(y, group=space.group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        ctx.space.sent["stats"] += g.numel() * g.element_size()
        dist.all_reduce(g, group=ctx.space.group)
        return g, None


def space_sum(x: torch.Tensor, space: Space) -> torch.Tensor:
    """x summed over the space group; the backward sums the incoming
    gradient over the group, as every rank's slab consumes the sum."""
    return _SpaceSum.apply(x, space)


def gather(x: torch.Tensor, space: Space) -> torch.Tensor:
    """The whole tensor from every rank's slab along the split axis; the
    backward sums the gradient over the group and keeps this rank's slab."""
    return _Gather.apply(x, space)


class Levels:
    """The resolution levels of a U-Net forward under the active space axis
    (a no-op without one). `strides` are the strides into levels 1, 2, ...;
    level l computes on slabs while the space size divides its extent along
    the split axis (the patch's extent over the strides' product), and whole
    from the first level where it does not: `down(x, l)` before level l's
    first conv gathers x there, `up(x, l)` after the transposed conv into
    level l keeps this rank's slab where level l splits again."""

    def __init__(self, x: torch.Tensor, strides):
        self.space = current()
        self.whole_from = None
        if self.space is None:
            return
        ax, size = self.space.axis, self.space.size
        extent = x.shape[self.space.dim] * size
        for level, stride in enumerate(strides, 1):
            extent //= int(stride[ax])
            if extent % size:
                self.whole_from = level
                break

    def down(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if self.whole_from is not None and level == self.whole_from:
            x = gather(x, self.space)
            self.space.whole = True
        return x

    def up(self, x: torch.Tensor, level: int) -> torch.Tensor:
        if self.whole_from is not None and level == self.whole_from - 1:
            self.space.whole = False
            x = _cl(self.space.slab(x))
        return x


@dataclass(frozen=True)
class Share:
    """How one output level lies on the space axis, for the losses: `split`
    (each rank holds its slab of the level) or whole (every rank holds all
    of it)."""

    space: Space
    split: bool

    @property
    def own(self) -> float:
        """The weight of this rank's sums over its voxels: 1 on a slab; on a
        whole level the group's first rank counts them alone."""
        return 1.0 if self.split or self.space.index == 0 else 0.0

    @property
    def owner(self) -> float:
        """The weight of a value every rank of the group holds alike (a
        sample's Dice): the group's first rank counts it."""
        return 1.0 if self.space.index == 0 else 0.0

    def voxels(self, x: torch.Tensor) -> int:
        """The voxels of one channel of one sample of x, whole."""
        n = math.prod(x.shape[2:])
        return n * self.space.size if self.split else n

    def pooled(self, t: torch.Tensor) -> torch.Tensor:
        """Per-sample sums over this rank's voxels -> over the sample's
        (pooled over the group on a slab)."""
        return space_sum(t, self.space) if self.split else t

    def slab(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole target of the level."""
        return self.space.slab(t) if self.split else t
