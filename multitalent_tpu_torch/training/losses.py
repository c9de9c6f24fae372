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
"""
from __future__ import annotations

import numpy as np
import torch
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
                     *, batch_dice: bool = True, group=None):
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
    With a process `group` the sums run over every rank's samples.
    """
    logits = logits.float()
    b, r = logits.shape[:2]
    ones = (1,) * (logits.dim() - 2)
    gt = label_region_matrix[labels.long().clamp(min=0)].movedim(-1, 1)  # (B, R, *S)
    vmask = valid_region_mask.float()
    vb = vmask.view(b, r, *ones)
    axes = _spatial(logits)

    bce = (logits.clamp(min=0) - logits * gt
           + torch.log1p(torch.exp(-logits.abs()))).mean(dim=axes)  # (B, R)
    ce = (bce * vmask).sum()

    probs = torch.sigmoid(logits)
    tp = (probs * gt * vb).sum(dim=axes)
    fp = (probs * (1 - gt) * vb).sum(dim=axes)
    fn = ((1 - probs) * gt * vb).sum(dim=axes)
    if batch_dice:
        tp, fp, fn = tp.sum(0), fp.sum(0), fn.sum(0)
        if group is not None:
            tp, fp, fn, ce = global_sum(torch.cat((tp, fp, fn, ce.view(1))),
                                        group).split((r, r, r, 1))
            ce = ce[0]
    dc = 2 * tp / (2 * tp + fp + fn).clamp(min=1e-7)
    dc_sum = dc.sum()
    if group is not None and not batch_dice:
        ce, dc_sum = global_sum(torch.stack((ce, dc_sum)), group)
    return ce - dc_sum, ce, dc_sum


def multitalent_ds_loss(outputs, targets, valid_region_mask, label_region_matrix,
                        weights, *, batch_dice: bool = True, group=None):
    """Deep-supervised MultiTalent loss: the weighted sums of (loss, ce, dice)
    over the levels; levels of weight 0 are skipped, not computed."""
    total = ce_total = dc_total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if w == 0:
            continue
        loss, ce, dc = multitalent_loss(o, t, valid_region_mask, label_region_matrix,
                                        batch_dice=batch_dice, group=group)
        total = total + w * loss
        ce_total = ce_total + w * ce
        dc_total = dc_total + w * dc
    return total, ce_total, dc_total


def soft_dice_loss(logits: torch.Tensor, labels: torch.Tensor, *, batch_dice: bool = False,
                   do_bg: bool = True, smooth: float = 1e-5, group=None) -> torch.Tensor:
    """Negative mean soft Dice of the softmax probabilities (SoftDiceLoss);
    with a process `group`, over every rank's samples (batch Dice: pooled
    statistics; else the mean over all samples)."""
    probs = torch.softmax(logits.float(), dim=1)
    y = F.one_hot(labels.long().clamp(min=0), probs.shape[1]).movedim(-1, 1).float()
    axes = _spatial(probs)
    if batch_dice:
        axes = (0,) + axes
    tp = (probs * y).sum(dim=axes)
    fp = (probs * (1 - y)).sum(dim=axes)
    fn = ((1 - probs) * y).sum(dim=axes)
    if group is not None and batch_dice:
        tp, fp, fn = global_sum(torch.stack((tp, fp, fn)), group)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth + 1e-8)
    if not do_bg:
        dc = dc[1:] if batch_dice else dc[:, 1:]
    if group is not None and not batch_dice:
        total, count = global_sum(torch.stack((dc.sum(), dc.new_tensor(dc.numel()))), group)
        return -total / count
    return -dc.mean()


def robust_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                         group=None) -> torch.Tensor:
    """Mean softmax cross-entropy over the voxels, labels below 0 counted as
    0 (losses.py:84 of the JAX package); with a process `group` the mean
    over every rank's voxels."""
    target = labels.long().clamp(min=0)
    if group is None:
        return F.cross_entropy(logits.float(), target)
    total = F.cross_entropy(logits.float(), target, reduction="sum")
    total, count = global_sum(torch.stack((total, total.new_tensor(target.numel()))), group)
    return total / count


def dc_and_ce_loss(logits: torch.Tensor, labels: torch.Tensor, *, batch_dice: bool = False,
                   weight_ce: float = 1.0, weight_dice: float = 1.0,
                   smooth: float = 1e-5, group=None) -> torch.Tensor:
    """DC_and_CE_loss (aggregate 'sum'): softmax CE + (-Dice without the
    background channel); with a process `group` the CE is the mean over every
    rank's voxels."""
    ce = robust_cross_entropy(logits, labels, group=group)
    dc = soft_dice_loss(logits, labels, batch_dice=batch_dice, do_bg=False, smooth=smooth,
                        group=group)
    return weight_ce * ce + weight_dice * dc


def deep_supervision_loss(outputs, targets, loss_fn, weights) -> torch.Tensor:
    """MultipleOutputLoss2: the weighted sum of loss_fn over the levels,
    levels of weight 0 skipped."""
    total = 0.0
    for w, o, t in zip(weights, outputs, targets):
        if w == 0:
            continue
        total = total + w * loss_fn(o, t)
    return total
