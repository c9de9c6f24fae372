"""Segmentation losses of the trainers, on NCDHW logits.

Counterpart of multitalent_tpu/training/losses.py: `multitalent_loss` (:140)
and `multitalent_ds_loss` (:189), the masked sigmoid BCE + batch-Dice loss
of the MultiTalent flagship; `dc_and_ce_loss` (:96), `robust_cross_entropy` (:84) and
`deep_supervision_loss` (:113) for TrainerV2; `ds_loss_weights` (:104).

Conventions: logits (B, C, *S) fp32 (the networks' outputs; the loss is
computed in fp32 whatever the model dtype); label maps (B, *S), integer
valued (floats from the augmentation are cast); reductions over the global
batch, so batch Dice pools its statistics over every sample of the batch.

Under data parallelism each rank holds a share of the global batch and
passes its process `group`: every sum over samples (the BCE and CE sums,
batch-Dice statistics, per-sample Dice, voxel and sample counts) is pooled
over the ranks with `parallel.distributed.global_sum` before it is used, so
every rank's loss is the global batch's and its gradient that rank's share
of the global gradient (the counterpart of `axis_name`, JAX losses.py:
141,177-183). Not the reference's DDP loss, `ce_local - dice(global)`
averaged over the ranks, which weights the BCE 1/N against the Dice.

Under the space axis (parallel/mesh.py) each rank holds its slab of every
sample of its data group, and a loss takes the level's `space`
(mesh.Share): the means over voxels divide by the whole sample's voxel
count; sums over voxels are a slab's share of the group's (on a level that
computes whole, the group's first rank counts them alone); per-sample
statistics (Dice without batch Dice) are pooled over the space group before
their ratio, and the sample's value is counted once per group. Only
`multitalent_loss` and `dc_and_ce_loss` (with their parts) take a space.

The loss zoo of the variant trainers (losses.py:207-327 of the JAX package:
`gdl_loss`, `topk_cross_entropy`, `focal_ce_loss`, `dc_and_bce_loss`,
`mcc_loss`, `squared_dice_loss`, `dynamic_task_prioritization_loss`) follows
the same rules: fp32 terms, sums pooled over the ranks of `group`. The TopK
loss stays exact over ranks: each rank takes its local top-k of the voxels'
CE, k being the share of the global voxel count, and the global top-k is
taken from the union of the ranks' candidates.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from multitalent_tpu_torch.parallel.distributed import global_sum
from multitalent_tpu_torch.tasks.multitalent import NUM_GLOBAL_LABELS, REGION_OUTPUT_IDX, REGIONS


def build_label_region_matrix(regions: dict, region_output_idx: dict,
                              num_labels: int) -> np.ndarray:
    """(num_labels + 1, num_regions) with M[l, c] = 1 iff global label l is
    part of the region of output channel c (losses.py:127)."""
    m = np.zeros((num_labels + 1, len(region_output_idx)), dtype=np.float32)
    for r, labels in regions.items():
        for lab in labels:
            m[int(lab), region_output_idx[r]] = 1.0
    return m


def label_region_matrix() -> np.ndarray:
    """The MultiTalent (48, 47) label -> region matrix
    (tasks/multitalent.py:133, built here without that module's JAX loss
    import)."""
    return build_label_region_matrix(REGIONS, REGION_OUTPUT_IDX, NUM_GLOBAL_LABELS)


def ds_loss_weights(num_outputs: int, mask_lowest: bool = True) -> np.ndarray:
    """Deep-supervision weights 1/2^i, the lowest resolution zeroed when
    `mask_lowest`, normalised to sum 1 (nnUNetTrainerV2.py:76-90)."""
    w = np.array([1 / (2 ** i) for i in range(num_outputs)])
    if mask_lowest and num_outputs > 1:
        w[-1] = 0
    return w / w.sum()


def _spatial(x: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(2, x.dim()))


def multitalent_loss(logits: torch.Tensor, labels: torch.Tensor,
                     valid_region_mask: torch.Tensor, label_region_matrix: torch.Tensor,
                     *, batch_dice: bool = True, group=None, space=None):
    """Masked sigmoid BCE + Dice over the region channels.

    logits (B, R, *S); labels (B, *S) global labels 0..L (-1 counts as 0);
    valid_region_mask (B, R), 1 where the sample's dataset annotates the
    region; label_region_matrix (L + 1, R). Returns (loss, ce, dice_sum) with
    loss = ce - dice_sum:
    - ce: the spatial mean of BCE-with-logits per (sample, valid region),
      summed;
    - dice_sum: the per-channel Dice (statistics pooled over the batch when
      `batch_dice`), summed over channels; a channel valid nowhere gives
      0 / eps = 0.
    With a process `group` the sums run over every rank's samples, with a
    `space` (mesh.Share) over every rank's slab.
    """
    logits = logits.float()
    b, r = logits.shape[:2]
    ones = (1,) * (logits.dim() - 2)
    gt = label_region_matrix[labels.long().clamp(min=0)].movedim(-1, 1)  # (B, R, *S)
    vmask = valid_region_mask.float()
    vb = vmask.view(b, r, *ones)
    axes = _spatial(logits)

    terms = logits.clamp(min=0) - logits * gt + torch.log1p(torch.exp(-logits.abs()))
    if space is None:
        bce = terms.mean(dim=axes)  # (B, R)
    else:
        bce = terms.sum(dim=axes) / space.voxels(logits)
    ce = (bce * vmask).sum()

    probs = torch.sigmoid(logits)
    tp = (probs * gt * vb).sum(dim=axes)
    fp = (probs * (1 - gt) * vb).sum(dim=axes)
    fn = ((1 - probs) * gt * vb).sum(dim=axes)
    if space is not None:
        ce = ce * space.own
        if batch_dice:
            tp, fp, fn = tp * space.own, fp * space.own, fn * space.own
        else:
            tp, fp, fn = space.pooled(torch.stack((tp, fp, fn))).unbind(0)
    if batch_dice:
        tp, fp, fn = tp.sum(0), fp.sum(0), fn.sum(0)
        if group is not None:
            tp, fp, fn, ce = global_sum(torch.cat((tp, fp, fn, ce.view(1))),
                                        group).split((r, r, r, 1))
            ce = ce[0]
    dc = 2 * tp / (2 * tp + fp + fn).clamp(min=1e-7)
    dc_sum = dc.sum()
    if group is not None and not batch_dice:
        if space is not None:
            dc_sum = dc_sum * space.owner
        ce, dc_sum = global_sum(torch.stack((ce, dc_sum)), group)
    return ce - dc_sum, ce, dc_sum


def multitalent_ds_loss(outputs, targets, valid_region_mask, label_region_matrix,
                        weights, *, batch_dice: bool = True, group=None, spaces=None):
    """Deep-supervised MultiTalent loss: the weighted sums of (loss, ce, dice)
    over the levels; levels of weight 0 are skipped, not computed. `spaces`:
    each level's mesh.Share under the space axis."""
    total = ce_total = dc_total = 0.0
    spaces = [None] * len(outputs) if spaces is None else spaces
    for w, o, t, space in zip(weights, outputs, targets, spaces):
        if w == 0:
            continue
        loss, ce, dc = multitalent_loss(o, t, valid_region_mask, label_region_matrix,
                                        batch_dice=batch_dice, group=group, space=space)
        total = total + w * loss
        ce_total = ce_total + w * ce
        dc_total = dc_total + w * dc
    return total, ce_total, dc_total


def _probs_and_targets(logits: torch.Tensor, labels: torch.Tensor,
                       nonlin: str = "softmax") -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 probabilities (softmax over the channels, or the sigmoid of each)
    and the targets: `labels` one-hot over the channels, or as they are (in
    fp32) where they already have the logits' rank (one-hot or region
    targets)."""
    x = logits.float()
    probs = torch.sigmoid(x) if nonlin == "sigmoid" else torch.softmax(x, dim=1)
    if labels.dim() == logits.dim():
        return probs, labels.float()
    return probs, F.one_hot(labels.long().clamp(min=0), probs.shape[1]).movedim(-1, 1).float()


def _global_mean(total: torch.Tensor, count: int, group) -> torch.Tensor:
    """total / count, both summed over the ranks of `group` first."""
    if group is None:
        return total / count
    total, count = global_sum(torch.stack((total, total.new_tensor(float(count)))), group)
    return total / count


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, batch_dice: bool = False,
                   do_bg: bool = True, smooth: float = 1e-5, nonlin: str = "softmax",
                   group=None, space=None) -> torch.Tensor:
    """Negative mean soft Dice of the softmax probabilities (SoftDiceLoss;
    `nonlin` "sigmoid" for region targets of the logits' rank); with a
    process `group`, over every rank's samples (batch Dice: pooled
    statistics; else the mean over all samples), with a `space`
    (mesh.Share) over every rank's slab."""
    probs, y = _probs_and_targets(logits, labels, nonlin)
    axes = _spatial(probs)
    if batch_dice:
        axes = (0,) + axes
    tp = (probs * y).sum(dim=axes)
    fp = (probs * (1 - y)).sum(dim=axes)
    fn = ((1 - probs) * y).sum(dim=axes)
    if space is not None:
        stats = torch.stack((tp, fp, fn))
        tp, fp, fn = (stats * space.own if batch_dice else space.pooled(stats)).unbind(0)
    if group is not None and batch_dice:
        tp, fp, fn = global_sum(torch.stack((tp, fp, fn)), group)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8)
    if not do_bg:
        dc = dc[1:] if batch_dice else dc[:, 1:]
    if group is not None and not batch_dice:
        weight = 1.0 if space is None else space.owner
        total, count = global_sum(torch.stack((dc.sum() * weight,
                                               dc.new_tensor(dc.numel() * weight))), group)
        return -total / count
    return -dc.mean()


def robust_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                         group=None, space=None) -> torch.Tensor:
    """Mean softmax cross-entropy over the voxels, labels below 0 counted as
    0 (losses.py:84 of the JAX package); with a process `group` the mean
    over every rank's voxels (with a `space`, its slab's share)."""
    target = labels.long().clamp(min=0)
    if group is None:
        return F.cross_entropy(logits.float(), target)
    total = F.cross_entropy(logits.float(), target, reduction="sum")
    count = total.new_tensor(target.numel())
    if space is not None:
        total, count = total * space.own, count * space.own
    total, count = global_sum(torch.stack((total, count)), group)
    return total / count


def dc_and_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, batch_dice: bool = False,
                   weight_ce: float = 1.0, weight_dice: float = 1.0,
                   smooth: float = 1e-5, group=None, space=None) -> torch.Tensor:
    """DC_and_CE_loss (aggregate 'sum'): softmax CE + (-Dice without the
    background channel); with a process `group` the CE is the mean over every
    rank's voxels; with a `space` (mesh.Share) over every rank's slab."""
    ce = robust_cross_entropy(logits, labels, group=group, space=space)
    dc = soft_dice_loss(logits, labels, batch_dice=batch_dice, do_bg=False, smooth=smooth,
                        group=group, space=space)
    return weight_ce * ce + weight_dice * dc


# ------------------------------------------------------------------ the loss zoo
def _log_p_target(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """log softmax probability of each voxel's label (B, *S), in fp32, labels
    below 0 counted as 0."""
    return -F.cross_entropy(logits.float(), labels.long().clamp(min=0), reduction="none")


def gdl_loss(logits: torch.Tensor, labels: torch.Tensor, *, smooth: float = 1e-5,
             square_volumes: bool = False, group=None) -> torch.Tensor:
    """Generalized Dice loss (losses.py:207 of the JAX package; the
    reference's GDL, dice_loss.py:25): statistics over the batch and space,
    each class weighted by 1 / its volume (or the volume squared)."""
    probs, y = _probs_and_targets(logits, labels)
    axes = (0,) + _spatial(probs)
    tp = (probs * y).sum(dim=axes)
    fp = (probs * (1 - y)).sum(dim=axes)
    fn = ((1 - probs) * y).sum(dim=axes)
    volumes = y.sum(dim=axes)
    if group is not None:
        tp, fp, fn, volumes = global_sum(torch.stack((tp, fp, fn, volumes)), group)
    w = 1 / (volumes ** 2 if square_volumes else volumes).clamp(min=1e-6)
    nom = (w * 2 * tp).sum() + smooth
    den = (w * (2 * tp + fp + fn)).sum() + smooth
    return -(nom / den)


def topk_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, k_percent: float = 10.0,
                       *, group=None) -> torch.Tensor:
    """Mean CE over the hardest k% of the voxels (TopK_loss.py:21;
    losses.py:229). With a process `group`, exact over the global batch: k
    of the global voxel count; each rank's local top min(k, its voxels) are
    gathered, the global top k taken from their union (ties in rank order),
    and each rank's loss gradient flows through its own selected voxels."""
    ce = -_log_p_target(logits, labels).flatten()
    if group is None:
        k = max(1, int(ce.numel() * k_percent / 100))
        return torch.topk(ce, k).values.mean()
    n = torch.tensor([ce.numel()], dtype=torch.int64, device=ce.device)
    dist.all_reduce(n, group=group)
    k = max(1, int(int(n) * k_percent / 100))
    local = torch.topk(ce, min(k, ce.numel())).values
    candidates = torch.full((k,), -float("inf"), device=ce.device)
    candidates[:local.numel()] = local.detach()
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    gathered = [torch.empty_like(candidates) for _ in range(world)]
    dist.all_gather(gathered, candidates, group=group)
    chosen = torch.sort(torch.cat(gathered), descending=True, stable=True).indices[:k]
    mine = chosen[(chosen >= rank * k) & (chosen < rank * k + local.numel())] - rank * k
    return global_sum(local[mine].sum(), group) / k


def focal_ce_loss(logits: torch.Tensor, labels: torch.Tensor, gamma: float = 2.0,
                  alpha: float = 0.25, *, group=None) -> torch.Tensor:
    """Multiclass focal loss, the mean over the voxels of
    -alpha (1 - p_t)^gamma log p_t (focal_loss.py:23; losses.py:240)."""
    ll = _log_p_target(logits, labels)
    pt = torch.exp(ll)
    terms = -alpha * (1 - pt) ** gamma * ll
    return _global_mean(terms.sum(), terms.numel(), group)


def dc_and_bce_loss(logits: torch.Tensor, target_onehot: torch.Tensor, *,
                    batch_dice: bool = True, smooth: float = 1e-5, group=None) -> torch.Tensor:
    """Sigmoid BCE (the mean over every element) + soft Dice of the sigmoid
    with the background channel, on one-hot or region targets of the
    logits' shape (DC_and_BCE_loss, dice_loss.py:548; losses.py:249)."""
    x = logits.float()
    y = target_onehot.float()
    bce = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
    dc = soft_dice_loss(logits, target_onehot, batch_dice=batch_dice, do_bg=True,
                        smooth=smooth, nonlin="sigmoid", group=group)
    return _global_mean(bce.sum(), bce.numel(), group) + dc


def mcc_loss(logits: torch.Tensor, labels: torch.Tensor, *, smooth: float = 0.0,
             do_bg: bool = True, group=None) -> torch.Tensor:
    """-MCC (the Matthews correlation coefficient) from soft confusion
    entries over the batch and space, each divided by the voxel count, the
    mean over the classes (the background's dropped without `do_bg`)
    (dice_loss.py:198; losses.py:262)."""
    probs, y = _probs_and_targets(logits, labels)
    axes = (0,) + _spatial(probs)
    stats = torch.stack(((probs * y).sum(dim=axes), (probs * (1 - y)).sum(dim=axes),
                         ((1 - probs) * y).sum(dim=axes),
                         ((1 - probs) * (1 - y)).sum(dim=axes)))
    voxels = probs[:, 0].numel()
    if group is not None:
        counts = stats.new_tensor([float(voxels)])
        pooled = global_sum(torch.cat((stats.flatten(), counts)), group)
        stats, voxels = pooled[:-1].view_as(stats), pooled[-1]
    tp, fp, fn, tn = stats / voxels
    nominator = tp * tn - fp * fn + smooth
    denominator = torch.sqrt((tp + fp) * (tp + fn) * (tn + fp) * (tn + fn)) + smooth
    mcc = nominator / (denominator + 1e-8)
    if not do_bg:
        mcc = mcc[1:]
    return -mcc.mean()


def squared_dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, batch_dice: bool = False,
                      do_bg: bool = True, smooth: float = 1.0, group=None) -> torch.Tensor:
    """SoftDiceLossSquared (dice_loss.py:245; losses.py:281): 2 (sum p y +
    smooth) / (sum p^2 + sum y^2 + smooth), the negative mean over the
    classes (and samples, without batch Dice)."""
    probs, y = _probs_and_targets(logits, labels)
    axes = _spatial(probs)
    if batch_dice:
        axes = (0,) + axes
    inter = (probs * y).sum(dim=axes)
    p2 = (probs ** 2).sum(dim=axes)
    y2 = (y ** 2).sum(dim=axes)
    if group is not None and batch_dice:
        inter, p2, y2 = global_sum(torch.stack((inter, p2, y2)), group)
    dc = 2 * (inter + smooth) / (p2 + y2 + smooth)
    if not do_bg:
        dc = dc[1:] if batch_dice else dc[:, 1:]
    if group is not None and not batch_dice:
        return -_global_mean(dc.sum(), dc.numel(), group)
    return -dc.mean()


def dynamic_task_prioritization_loss(logits: torch.Tensor, labels: torch.Tensor,
                                     running_dice: torch.Tensor, *, gamma: float = 2.0,
                                     smooth: float = 1.0, momentum: float = 0.97,
                                     update_kpi: bool = True, weight_ce: float = 1.0,
                                     weight_dice: float = 1.0, group=None):
    """Dynamic task prioritization DC + CE (dice_loss.py:303,347;
    losses.py:300): each foreground class's per-sample Dice weighted by
    (1 - running Dice)^gamma, normalised to sum to the class count. The
    running Dice (num_classes - 1,) is passed in and returned, never kept:
    returns (loss, new running Dice). It moves by EMA momentum 0.97 towards
    the batch's mean Dice of the samples where a class is present
    (tp + fp + fn > 50), for the classes present in some sample."""
    probs, y = _probs_and_targets(logits, labels)
    axes = _spatial(probs)
    tp = (probs * y).sum(dim=axes)[:, 1:]
    fp = (probs * (1 - y)).sum(dim=axes)[:, 1:]
    fn = ((1 - probs) * y).sum(dim=axes)[:, 1:]
    present = ((tp + fp + fn) > 50).float()
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8)
    with torch.no_grad():
        dc_sum, n_present = (dc * present).sum(0), present.sum(0)
        if group is not None:
            dc_sum, n_present = global_sum(torch.stack((dc_sum, n_present)), group)
        mean_dc = dc_sum / (n_present + 1e-6)
        running = running_dice.to(dc.device, torch.float32)
        new_running = running * momentum + (1 - momentum) * mean_dc
        if update_kpi:
            new_running = torch.where(n_present > 0, new_running, running)
        else:
            new_running = running
        weights = (1 - new_running) ** gamma
        weights = weights * (dc.shape[1] / (weights.sum() + 1e-8))
    dice_term = -_global_mean((weights * dc).sum(), dc.numel(), group)
    ce = robust_cross_entropy(logits, labels, group=group)
    return weight_ce * ce + weight_dice * dice_term, new_running


def deep_supervision_loss(outputs, targets, loss_fn, weights, spaces=None) -> torch.Tensor:
    """MultipleOutputLoss2: the weighted sum of loss_fn over the levels,
    levels of weight 0 skipped; `spaces`: each level's mesh.Share under the
    space axis, passed to loss_fn as `space`."""
    total = 0.0
    for i, (w, o, t) in enumerate(zip(weights, outputs, targets)):
        if w == 0:
            continue
        total = total + w * (loss_fn(o, t) if spaces is None else loss_fn(o, t, space=spaces[i]))
    return total
