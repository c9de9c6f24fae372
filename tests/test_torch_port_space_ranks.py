"""Rank workers of the space-axis tests (tests/test_torch_port_space*.py).

`parallel.distributed.spawn` starts each in its own process (gloo on the
CPU). They import torch and the port only, never jax: each rank takes its
slab of the spec's whole inputs along the plan's split axis, runs the convs,
norms and losses on it under the space axis (parallel/mesh.py) with the
halos exchanged in the spec's form, and saves its outputs and gradients for
the test process to hold against one process on the whole. No tests here.
"""
import os

import torch

from multitalent_tpu_torch.models.blocks import KernelConv3d, instance_norm
from multitalent_tpu_torch.models.generic_unet import GenericUNet
from multitalent_tpu_torch.models.residual_unet import ResidualEncoderUNet
from multitalent_tpu_torch.parallel import distributed, mesh
from multitalent_tpu_torch.training import losses


def modules(spec: dict) -> dict:
    """The spec's convs, seeded alike in every process."""
    torch.manual_seed(spec["seed"])
    return {"A": KernelConv3d(8, 8), "B": KernelConv3d(16, 8, in_splits=(8, 8)),
            "strided": KernelConv3d(8, 8, stride=(2, 2, 2)), "first": KernelConv3d(1, 8)}


def run_ops(spec: dict, x: torch.Tensor, skip: torch.Tensor, space) -> dict:
    """Each op of the spec on x (and skip): its output, the gradient of
    (output * the spec's upstream gradient).sum() by its inputs and
    parameters. `space` None: the whole tensors in one process; else this
    rank's slabs under the space axis."""
    out = {}
    mods = modules(spec)
    slab = (lambda t: t) if space is None else space.slab
    for name, op in (("A", lambda a, b: mods["A"](a)), ("B", lambda a, b: mods["B"](a, b)),
                     ("strided", lambda a, b: mods["strided"](a)),
                     ("first", lambda a, b: mods["first"](a[:, :1])),
                     ("norm", lambda a, b: instance_norm(a, spec["norm_w"], spec["norm_b"]))):
        a = slab(x).clone().requires_grad_(True)
        b = slab(skip).clone().requires_grad_(True)
        params = [p for p in mods.get(name, torch.nn.Module()).parameters()]
        for p in params:
            p.grad = None
        with mesh.activated(space):
            y = op(a, b)
        g = spec["upstream"][name]
        (y * slab(g)).sum().backward()
        out[name] = {"y": y.detach(), "dx": a.grad, "dskip": b.grad,
                     "dparams": [p.grad.clone() for p in params]}
    return out


def run_losses(spec: dict, space) -> dict:
    """multitalent_loss and dc_and_ce_loss on the spec's whole logits, with
    and without batch Dice, on a level that splits (this rank's slab) and on
    one that computes whole (every rank the whole): each value and the
    logits' gradient."""
    out = {}
    group = distributed.group()
    for split in (True, False):
        share = None if space is None else mesh.Share(space, split)
        part = (lambda t: t) if share is None else share.slab
        for batch_dice in (True, False):
            x = part(spec["logits"]).clone().requires_grad_(True)
            mt, _, _ = losses.multitalent_loss(
                x, part(spec["labels"]), spec["valid"], spec["region_matrix"],
                batch_dice=batch_dice, group=group, space=share)
            x2 = part(spec["logits"]).clone().requires_grad_(True)
            dc = losses.dc_and_ce_loss(x2, part(spec["labels"]), batch_dice=batch_dice,
                                       group=group, space=share)
            (mt + dc).backward()
            out[(split, batch_dice)] = {"multitalent": mt.item(), "dc_and_ce": dc.item(),
                                        "grad": x.grad, "grad_dc": x2.grad}
    return out


NET_POOLS = [[2, 2, 2]] * 3


def nets(seed: int) -> dict:
    """A GenericUNet and a residual-encoder UNet of 8 base features (kernel
    A on every stride-1 conv but the first, B on the decoders' first),
    seeded alike in every process, fp32."""
    torch.manual_seed(seed)
    return {"generic": GenericUNet(1, 8, 3, NET_POOLS, [[3, 3, 3]] * 4, dtype=torch.float32),
            "resenc": ResidualEncoderUNet(1, 8, 3, [[1, 1, 1]] + NET_POOLS, [[3, 3, 3]] * 4,
                                          (1, 1, 2, 1), (1, 1, 1), dtype=torch.float32)}


def run_nets(spec: dict, space) -> dict:
    """Each net's deep-supervised forward of the spec's whole volume (or this
    rank's slab), the gradient of sum(output_k * upstream_k) by the input
    and the parameters: a level that splits takes this rank's slab of its
    upstream gradient, a level that computes whole counts on the group's
    first rank alone."""
    out = {}
    for name, net in nets(spec["seed"]).items():
        x = spec["volume"] if space is None else space.slab(spec["volume"])
        x = x.clone().requires_grad_(True)
        with mesh.activated(space):
            ys = net(x, deep_supervision=True)
        loss = 0.0
        for y, g in zip(ys, spec["volume_upstream"][name]):
            if space is None:
                loss = loss + (y * g).sum()
            else:
                share = mesh.Share(space, y.shape[space.dim] != g.shape[space.dim])
                loss = loss + (y * share.slab(g)).sum() * share.own
        loss.backward()
        out[name] = {"ys": [y.detach() for y in ys], "dx": x.grad,
                     "dparams": {k: p.grad.clone() for k, p in net.named_parameters()
                                 if p.grad is not None}}
    return out


def space_ops(spec_file: str, out_prefix: str) -> None:
    """This rank's slab of the spec through `run_ops` and `run_losses` under
    the plan of (batch, patch) over the ranks, each exchange form of the
    spec in turn; saves {form: results} (and the space's bytes sent) to
    `<out_prefix>.<rank>.pt`."""
    torch.set_num_threads(1)
    distributed.init_process_group("cpu")
    try:
        spec = torch.load(spec_file, weights_only=False)
        layout = distributed.layout(spec["batch"], spec["x"].shape[2:], "cpu")
        space = layout.space
        results = {"coords": (layout.data_index, space.index, space.size, space.axis)}
        for form in spec["forms"]:
            space.exchange = form
            space.sent.clear()
            results[form] = run_ops(spec, spec["x"], spec["skip"], space)
            results[form]["sent"] = dict(space.sent)
        results["losses"] = run_losses(spec, space)
        space.sent.clear()
        results["nets"] = run_nets(spec, space)
        results["nets_sent"] = dict(space.sent)
        torch.save(results, f"{out_prefix}.{distributed.rank()}.pt")
    finally:
        torch.distributed.destroy_process_group()


def run_space_ops(spec: dict, folder, world: int) -> list[dict]:
    """Spawn `world` gloo ranks over `spec`; each rank's results."""
    spec_file, prefix = os.path.join(folder, "space_spec.pt"), os.path.join(folder, "space")
    torch.save(spec, spec_file)
    distributed.spawn(space_ops, world, (spec_file, prefix))
    return [torch.load(f"{prefix}.{r}.pt", weights_only=False) for r in range(world)]
