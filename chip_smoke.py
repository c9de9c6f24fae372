"""Smoke run of the PyTorch/CUDA port (multitalent_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises (non-zero exit):

1. device: the card's name and power limit; build the CUDA kernels from
   multitalent_tpu_torch/csrc (one nvcc per source, in parallel) and time it;
2. each kernel against its plain PyTorch version on the card, at the shapes
   the flagship gives it, with the kernel's median time beside the plain
   version's (fp32, TF32 off) and cuDNN's bf16 op: A and B at the forward's
   shapes (N=1), then A at the training batch (N=2), each into a NaN-filled
   buffer, with the plan it took (the ring body or, at 16-byte rows with
   streamed weights, the wgmma body of csrc/conv3d_wgmma.cu: a plan of A or
   B that names neither fails the run); kernel C (dw) single at
   A's shapes and
   dual at B's (each
   into a NaN-filled dw buffer, with its bound and write path: dw directly
   or split partials), and A in the dx role (C -> 2C channels, the dual
   convs' dx), at the training batch N=2; then the fused chain's kernels beside the unfused route they
   replace (the port's plain-torch norm + a cuDNN bf16 conv): D (prologue +
   stats) at A's shapes and its dual form at B's, each at N=1 and N=2 into
   NaN-filled output and stats buffers, with the plan it took (the dual
   form on the body kernel B's plan names, its launch counted there; on
   the same body its output bit-equal to B's; two calls bit-equal; timed
   beside B alone and B then E's stats), E's stats
   (two calls bit-equal, launches a call from a captured CUDA graph, queued times)
   and apply passes at every norm shape, and F at the stage-0 head into a
   NaN-filled output, beside its form without the prologue and torch.mm of
   that form's function; "2 Liver" and "2b Liver" check and time A, B, D,
   D's dual form, E and F again at the shapes of the Task003 Liver
   3d_fullres net (32-320 channels, grids 128^3 to 4^3), at N=1 and at the
   default mode's four mirror combinations a forward (N=4); "2 SwinUNETR"
   checks and times A, B, C and A's dx again at the SwinUNETR's shapes
   (48-768 channels, 96x192x192 to 3x6x6, B up to 384+384, N=1 and 2);
3. the inference path through the user's entry point: a reference-layout
   model folder of the MultiTalent flagship (GenericUNet, base 30, pools
   (2,2,2)x4 + (1,2,2), 47 sigmoid regions, patch 96x192x192, spacing
   (1.5,1,1); seeded random weights in the reference's He init) and one
   synthetic CT larger than a patch on every axis go through
   `multitalent_tpu_torch.cli.predict_multitalent.main` with mirror TTA; the
   labelmap and all 47 region NIfTIs must exist at the input's shape, and
   each kernel's launch count must equal its launches per forward times the
   forwards run; A and B must have run the wgmma body;
3b. the same with MTTPU_FUSED_NORM=1 (the fused conv -> norm route, kernels
   D, E and F): exact launch counts of the fused route (D's dual form at
   16-byte rows on the wgmma body, its launches by body), every region mask
   against the unfused run's, seconds per case of both routes (3, 3b and
   5-5e run the sliding window's exact mode, MTTPU_SW_EXACT=1, so their
   counts and history stay comparable);
3c. the generic softmax path through `multitalent_tpu_torch.cli.predict`:
   a TrainerV2 folder of the Task003 Liver 3d_fullres plans (bench.py:
   382-383) with two folds of seeded weights, two synthetic CT cases of
   112x200x200 (18 tiles each), run in the default mode unfused and fused,
   the exact mode, `--mode fast` and `fastest`, `-z -f 0` and `-z -f 1`,
   then `cli.ensemble` of those and `cli.evaluate` against the phantoms'
   labels: exact launch counts (per-call counts x network calls), one put
   a case, normal and fast labelmaps bit-equal, fused vs unfused within
   MASK_AGREE_*, default vs exact where the gaussian clamp does not decide
   the blend; seconds per case per mode (predict on the card's clock,
   export) and one 128^3 forward at N=1 and N=4 on both routes;
4. one tile's sigmoid probabilities through the kernels in bf16 against the
   plain versions, at the same bf16 rounding points and in fp32;
4b. the same for the fused forward, and the plain forward under
   MTTPU_PALLAS_NORM=1 (every norm on kernel E, no grad) against the default;
   both routes again with a faulty LeakyReLU slope, whose readings must break
   the bounds (controls);
5. the training path through the user's entry point: synthetic preprocessed
   MultiTalent cases of two source datasets (valid regions and export
   properties stamped, gt_segmentations/) go through
   `multitalent_tpu_torch.cli.train.main` with MultiTalent_trainer_ddp at
   full flagship width, batch 2, bf16, deep supervision, for a few steps,
   then validate one case of each dataset (trainer.validate: all 47 region
   masks and the labelmap at the original shape, a finite Dice of every
   valid label in summary_Task003_Liver.json and summary_Task009_Spleen.json);
   the losses must be finite, every weight must move, the A/B/C launch counts
   must equal their per-step counts times the steps plus the per-forward
   counts times the validation batches and the validation's forwards (tiles
   x 8 mirror combinations), one step's dw of every kernel conv must match
   the plain version on the same bf16 inputs, and the written model folder
   must predict through predict_multitalent; prints seconds per step, peak
   memory, validation seconds per case and A's and B's launches by body
   (the run's and one step's);
5b. the same with MTTPU_FUSED_TRAIN=1 (kernel D forward, A and C backward)
   and its validation under MTTPU_FUSED_NORM=1 (D, E, F);
5c. `-val --val_folder validation_fused` under MTTPU_FUSED_NORM=1 on phase
   5's folder: exact D/E/F counts, masks against phase 5's validation;
5d. phase 5's weights written as a JAX-layout folder (flax `.ckpt` through
   io/flax_ckpt.py, with its sidecar) and restored on the card (timed);
   predict_multitalent from it must write what it wrote from the `.model`
   folder, bit for bit;
5e. nnUNetTrainerV2_warmupsegheads -pretrained_weights <that .ckpt> on a
   one-class downstream task for 2 steps and its validation: the backbone
   loads equal to the pretrained weights and stays bit-unchanged, the heads
   move, kernel C launches 0 times in phase 1;
6. the probes (multitalent_tpu_torch/probes, the ports of scripts/' Pallas
   probe harnesses): each probe's entry point (`main`) as a user runs it,
   with every launch count set to 0 before and read after (each count must
   equal what the probes' arguments launch); then each probe kernel, into a
   NaN-filled output buffer, against its plain version at
   the shapes its script times (the conv arms tap/sum (kernel A), im2col,
   tap3 and wino at (2,96,96,96,120) -> 120 on their TMA + wgmma bodies,
   each with its body and L2 -> shared bytes, the Winograd kernel also with
   its own products floor, against its plain version with its rounding
   points and against a control with one row of G wrong that must break its
   bound; the three arms' first bodies at C % 8 != 0, counted by body; the
   packed conv at the flagship's stages 0 and 1 on kernel A's ring body,
   bit-equal to kernel A on the unpacked tensor, with A's time there, cuDNN's
   and its ring plan; the center-view conv and the zero fill at
   (1,96,96,96,128) by tile, the fill's form, queued times beside zero_'s,
   GB/s in all and a block, and the host's us a call), each with its bound (the least
   time of its work at the card's peak rates) and its median time beside
   the plain version's and the library call's; then the wgmma body's
   readings (probes/wgmma_forms.py): one wgmma of a TMA-staged box at a
   tap's descriptor offset against torch (n 64 and 128, halo and far-edge
   tiles), the body as it is, copies only and products only at the
   flagship's shapes it runs, and the host's us a call;
8. the residual-encoder UNet (FabiansUNet) at full width, the MultiTalent
   resenc plans (the flagship's with a leading (1,1,1) pool, blocks
   (1,2,3,4,4,4) and (1,1,1,1,1)): 8a `cli.train` with
   MultiTalent_trainer_resenc_ddp on phase 5's cases (4 steps, then the
   validation of one case a dataset: finite losses, every weight moved,
   exact A/B/C counts, one step's dw through C against the plain version,
   seconds per step, peak memory, validation seconds per case); 8b
   predict_multitalent from its folder on phase 3's case (exact counts,
   seconds per case); 8c one tile's probabilities, kernels vs plain in
   bf16 and fp32, MTTPU_PALLAS_NORM=1 vs the default, and controls with a
   faulty LeakyReLU slope that must break those bounds; 8d the trained
   weights as a JAX-layout folder, restored (timed) and predicted from,
   bit-equal to 8b; 8e nnUNetTrainerV2_warmupsegheads_resenc
   -pretrained_weights that `.ckpt` on phase 5e's task (backbone
   bit-unchanged, heads moved, kernel C 0 launches); 8f `cli.predict -tr
   nnUNetTrainerV2_ResencUNet` on a phase-3c Liver case with the Liver
   plans as resenc plans (default mode, one fold, exact counts);
9. data parallelism (parallel/distributed.py): 9a `cli.train` with
   MultiTalent_trainer_ddp on phase 5's task at full flagship width, batch 2,
   as torchrun --nproc_per_node=1 starts it (RANK=0, WORLD_SIZE=1: a NCCL
   group of one, the DDP wrapper with its gradient-summing hook, the pooled
   loss), DDP_STEPS steps and the validation, beside the same run in one
   process from the same seed and batches (one sampler thread, cuDNN
   deterministic): exact A/B/C counts in both, weights, losses and every
   validation NIfTI bit-equal, the folder predicts through
   predict_multitalent; 9b two ranks started by parallel.distributed.spawn,
   sharing the card over gloo, each with one sample of the flagship's
   batch of 2 (seeded host batches, augmentation off, bf16), against one
   process with the batch: the ranks bit-equal, the losses within
   DDP_LOSS_RTOL, the weight updates within DDP_UPDATE_BOUND after step 1
   and after step DDP_STEPS, and a control whose Dice is not pooled over
   the ranks must break it at both; seconds per step and peak memory of
   each rank; 9c 9b under MTTPU_FUSED_TRAIN=1 (D, A, C) for
   FUSED_DDP_STEPS steps; 9b again over NCCL, one card a rank, where two
   cards are visible (else a line says it is skipped); 9d the space axis
   (parallel/mesh.py): two ranks sharing the card over gloo train the
   flagship at a global batch of 1 (data 1 x space 2, x 192 -> 96 a rank,
   halo exchanges through one all-reduce, gloo's point-to-point taking CPU
   tensors only), against one process with the batch: the ranks
   bit-equal, the losses within DDP_LOSS_RTOL, the updates within
   SPACE_UPDATE_BOUND, exact A/B/C counts a rank and their shapes, seconds
   per step, peak a rank and bytes exchanged a step, a control that
   normalises each slab with its own statistics breaking the bound, then
   one more forward and backward with every A, B and C shape of the slabs
   (x extended to 98, 50, 26, 14, 8, 5) against its plain version; 9d again
   over NCCL (point-to-point halos) where two cards are visible; 9d's
   ranks run in 9b's spawn, after 9b's and 9c's runs;
10. both workflows from raw NIfTIs, unfused, in the sliding window's
   default mode, at the widths the port's planners choose: one seeded raw
   set of two nnU-Net tasks (Task003_Liver, Task009_Spleen; RAW_CASES
   CT-like phantoms each at spacings that vary case by case, a zero border
   outside the field of view, one held-out Liver case). 10a:
   `cli.plan_and_preprocess -t 3 --verify_dataset_integrity` (the v21
   planner must plan the Task003 Liver network: base 32, 5 pools an axis,
   128^3), `cli.train 3d_fullres TrainerV2` for RAW_TRAIN_STEPS steps and
   fold 0's validation, `cli.consolidate_postprocessing -f 0`,
   `cli.find_best_configuration -m 3d_fullres -f 0`, `cli.predict` with the
   chosen configuration on the held-out case. 10b: `tasks.convert_task100`,
   `cli.plan_and_preprocess -t 100` with the MultiTalent planner,
   `--addregions-only`, `cli.train 3d_fullres MultiTalent_trainer_ddp -p
   MultiTalent_bs4` at the plans' batch of 4 with its validation,
   `cli.predict_multitalent` on the held-out case. Each prints what the
   planner chose, its host seconds by step (write, verify, convert, crop,
   analyze, plan, preprocess, stamp, train steps, validation, selection,
   predict), seconds per step and peak memory; a missing file that the next
   step reads, a non-finite loss, A/B/C counts off the trainer's per-step
   and per-forward counts, or a prediction off its raw case's shape or
   geometry fails the phase;
11. SwinUNETR (models/swin_unetr.py) at the trainers' width (feature_size
   48, heads (3,6,12,24), window 7) over the flagship's plans (patch
   96x192x192, batch 2, bf16, 47 regions), the sliding window's default
   mode: 11a `cli.train` with MultiTalent_trainer_SwinUNETR_ddp_adam on
   phase 5's cases (4 steps, then the validation of one case a dataset:
   finite losses, every weight moved, A/B/C counts exactly the trainer's,
   16 A and 5 B a forward, one step's dw through C against the plain
   version, seconds per step, peak memory); 11b predict_multitalent from its
   folder on phase 3's case (exact counts, shape and geometry); 11c one
   tile's probabilities, kernels vs plain in bf16 and fp32, and a control
   with the shift masks' -100 at 0 that must break the bf16 bounds, and the
   tile forward's ms; 11d its weights as a JAX-layout folder, restored
   bit-equal (timed); 11e the SwinUNETR head warm-up -pretrained_weights
   that `.ckpt` on phase 5e's task (backbone bit-unchanged, out.* moved,
   kernel C 0 launches); 11f nnUNetTrainerV2_swinunetr_adam_ddp for 2 steps
   on phase 10a's preprocessed Task003_Liver (128^3, 3 classes) and
   `cli.predict -tr` of its held-out case;
12. MedNeXt (models/mednext.py) at the MultiTalent trainer's width
   (n_channels 32, exp_r and blocks (3,4,8,8,8,8,8,4,3), five heads) over
   the flagship's plans (96x192x192, batch 2, bf16, 47 regions), default
   mode: 12a `cli.train` with MultiTalent_meets_mednext on phase 5's cases
   (3 steps, then the validation of one case a dataset: finite losses,
   every weight but out4's moved, seconds per step, peak memory), and one
   more step under torch.profiler for the depthwise convs' forward and
   backward share of its device time; 12b its `.model` folder and the same
   weights as a JAX-layout `.ckpt` folder restored bit-equal (timed), and
   predict_multitalent from the `.ckpt` folder on phase 3's case without
   mirror TTA (exact forwards, shape and geometry); 12c one tile's probabilities in bf16
   against the same network in fp32, and the tile forward's ms. Nothing of
   MedNeXt runs on a hand-written kernel: A, B and C launch 0 times in each;
13. the 3d_lowres -> 3d_cascade_fullres workflow on phase 10a's
   Task003_Liver phantoms: the v21 planner's plan of 10a as the
   full-resolution stage and a lowres stage of the planner's own stage
   properties at twice the target spacing, both preprocessed by its
   run_preprocessing from 10a's cropped data; 13a `cli.train 3d_lowres
   TrainerV2` fold 0 (3 steps, the validation, predict_next_stage of every
   case: each segFromPrevStage file at its stage-1 shape), 13b `cli.train
   3d_cascade_fullres TrainerV2CascadeFullRes` fold 0 (3 steps, the
   cascade validation), 13c `cli.predict -m 3d_lowres` of the held-out
   raw case (shape, geometry), each with exact A/B/C counts; 13d one tile
   of the cascade's network (the image and two one-hots; its first conv
   on cuDNN) through the kernels against the plain versions in bf16,
   within phase 4's bounds;
14. fp32, the 2D plans and the trainer variants: 14a the fp32 forms of
   kernels A, B and C (csrc/conv3d_fp32.cu) against their plain fp32
   versions, TF32 off, at phase 10a's Liver shapes (32->32, 32+32->32, dw
   32->32 at 128^3, N=2), each into a NaN-filled buffer, median of
   FP32_ITERS beside the plain version, cuDNN fp32 and the fp32 bound; 14b
   `cli.train 3d_fullres nnUNetTrainerV2_fp32` on 10a's plans and phantoms
   (3 steps, validation), its `.model` restored bit-equal and `cli.predict
   -tr nnUNetTrainerV2_fp32` on the held-out case, with exact launch counts
   of the fp32 forms and none of the bf16 kernels; 14c the 2D planner's plan
   of 10a's data at full width through `cli.train 2d` (checkpoints, then
   the validation's refusal) and 3 steps each of TrainerV2 and its
   residual-encoder form through the trainer API, saved and restored
   bit-equal, no hand-written kernel launched; 14d every network variant
   of VARIANT_TRAINERS (and _DA5, _noDA) 2 steps on 10a's plans with exact
   A/B/C counts, and a validation phantom's tile through the kernels
   against the plain versions within phase 4's bounds; 14a also holds the
   fp32 forms of D (and its dual form), E (stats, apply) and F (32 -> 3)
   against their plain fp32 versions at 32 channels, 128^3, N=2, with their
   bounds and library calls (torch.var_mean, torch.matmul) or, for D, the
   unfused fp32 route; 14a holds C's fp32 form (the wgrad ring body) at
   every dw shape of a Liver fp32 step and the flagship's 30 -> 30 and
   30 + 30 -> 30 at N=2 into NaN-filled dw (single and queued times,
   torch.nn.grad.conv3d_weight as its library call, the bound and its
   share, the plan, a bit-equal repeat); 14b also runs
   `nnUNetTrainerV2_fp32` under MTTPU_FUSED_TRAIN=1 and MTTPU_FUSED_NORM=1
   (3 steps, validation) and `cli.predict` under MTTPU_FUSED_NORM=1: exact
   launches of the fp32 forms of D, E, F, A and C, no bf16 kernel, labels
   against the unfused fp32 prediction, one batch's loss fused vs unfused
   on the same weights, and every D shape it launched recorded; "14a D
   shapes" then holds D's fp32 forms at each of them as 14a holds C. Every
   fp32 C and D launch of a counted run must run the ring bodies
   (`launches_by_body`);
15. the rest of the trainer zoo (training/variants.py), through the trainer
   API on 10a's plans and phantoms: 15a every loss, optimizer, schedule and
   network variant (ZOO_TRAINERS; `_momentum09in2D` on 14c's 2D plan) 2
   steps with exact A/B/C counts and finite losses; each loss variant's
   loss of step 1's outputs and targets against the same function on the
   CPU in fp32 (ZOO_LOSS_RTOL), each other trainer's update of step 2
   against its optimizer on the CPU in fp32 from the same parameters,
   state and gradients (ZOO_UPDATE_RTOL of max |update|); 15b the convReLUIN
   networks: a tile through the kernels against the plain fp32 network
   (VARIANT_FP32_RATIO), MTTPU_FUSED_NORM=1 and MTTPU_FUSED_TRAIN=1 warn and
   launch no D, E or F, and `_lReLU_convReLUIN`'s folder restored and
   `cli.predict` on the held-out case; 15c `_resample33`'s validation of
   its one case, its labels equal to a CPU export of the same
   probabilities, its export order printed; 15d the LR of the schedule
   variants and the momentum of `_reduceMomentumDuringTraining` at named
   epochs (host);
16. the released-layout install (16a, right after 3b): phase 3's folder
   zipped as the released Task100 zip, `cli.download_pretrained
   install_zip` (the fixups' folder and sidecar), predict_multitalent from
   the install (phase 3's launches, its NIfTIs byte-identical), export ->
   install round trip, `cli.change_trainer` then restore; 16b on the host:
   `cli.convert_multitalent_sources` on a synthetic download of each of the
   7 tasks (Task062 from DICOM series), `cli.convert_decathlon_task` and
   `cli.plot_task_pngs` of 10a's task; seconds by step;
7. one JSON line describing every kernel (A-F and the probes'; the rows
   of A, B, C and D also list their phase-2 shapes (A's, B's and D's with
   their plans) and sum their times, and cuDNN's or the unfused route's,
   over the launches a run recorded: A over one forward (phase 4) and one
   training step (phase 5), B over one forward (phase 4), C over one step
   (phase 5), D over one fused forward (phase 4b) and one fused step (phase
   5b); E's stats row lists its six shapes and sums them over one fused
   forward (phase 4b); A, B, D, E and F also their Liver shapes and phase
   3c's launches; A, B and C the resenc's launches of phase 8 and their
   sums over one resenc forward (8c) and step (8a); A, B and C also 9a's
   launches, `launches_ddp`, and phase 10's, `launches_raw_generic(_predict)`
   and `launches_raw_multitalent(_predict)`; A, B and C phase 11's,
   `launches_swin(_predict, _warmup, _liver, _liver_predict)`, and `swin`:
   their "2 SwinUNETR" shapes against cuDNN and the bound, summed over one
   SwinUNETR forward (11c) and step (11a)); A, B and C phase 12's
   `launches_mednext(_predict)` (0) and phase 13's
   `launches_cascade_lowres` (13a, its next-stage forwards included),
   `launches_cascade_fullres` (13b) and `launches_cascade_predict` (13c);
   every row phase 14d's `launches_variants` and phase 15a-c's
   `launches_zoo`; then the rows of the fp32
   forms of A, B and C (14a's times, 14b's launches; C's row its 14a shapes
   and their sums over one Liver fp32 step) and of D, E and F (14a's
   times, 14b's fused launches; D's row the shapes 14b's fused run
   launched and their sums over one fused step); A's and B's rows add phase 16a's
   `launches_install` and `launches_by_body` (phases 3 and 5, and one step
   of 5), D's row its launches by body (phases 3b and 5b) and its dual
   form's phase-2 shapes at 16-byte rows beside B alone and B then E's
   stats; the wgmma body's row (`conv3d_same_wgmma`) its launches in phases
   3 and 5, its phase-2 shapes with their plans, and phase 6's probe, forms
   and host times; then the result line.
   Each phase prints its seconds.

It exits non-zero and prints no result without a CUDA device. It imports no JAX.
"""
from __future__ import annotations

import collections
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from math import prod

from multitalent_tpu_torch.probes._util import median_ms as _median_ms

SEED = 0
FLAGSHIP_POOLS = ((2, 2, 2), (2, 2, 2), (2, 2, 2), (2, 2, 2), (1, 2, 2))
FLAGSHIP_KERNELS = ((3, 3, 3),) * 6
PATCH = (96, 192, 192)
SPACING_ZYX = (1.5, 1.0, 1.0)
# the synthetic case: larger than a patch on every axis, on a grid slightly
# off the plans' spacing so that preprocessing resamples and the device export
# resizes back
CASE_SHAPE = (128, 256, 256)
CASE_SPACING_ZYX = (1.6, 0.9, 0.9)

# phase 2: a bf16 output from fp32 accumulation against an fp32 reference on
# the same bf16-rounded inputs and weights: one bf16 rounding of the output
# (2^-8 relative) plus summation order
RTOL, ATOL = 1e-2, 1e-2
# phase 4, |dp| of one tile's sigmoid probabilities (3.5M voxels x 47):
# kernels vs the plain versions on the same bf16 inputs and weights, rounding
# at the same points. Summation order still differs, so an activation may
# round one bf16 ulp apart and carry that through ~20 layers; the max over
# 1.6e8 values is a tail (2.96e-2 measured on the H100 before this bound)
PROB_BOUND = 5e-2
PROB_BOUND_MEAN = 2e-3
# kernels in bf16 vs the plain versions in fp32: a sanity bound on bf16
# itself, which rounds every activation of ~20 layers (2^-9 relative each);
# measured on the H100 before this bound was set: max 5.4e-2, mean 3.6e-3
PROB_BOUND_FP32_MAX = 1e-1
PROB_BOUND_FP32_MEAN = 1e-2

# (C, spatial) the flagship forward gives each kernel at patch 96x192x192
KERNEL_A_SHAPES = [(30, (96, 192, 192)), (60, (48, 96, 96)), (120, (24, 48, 48)),
                   (240, (12, 24, 24)), (320, (6, 12, 12)), (320, (6, 6, 6))]
KERNEL_B_SHAPES = [(30, (96, 192, 192)), (60, (48, 96, 96)), (120, (24, 48, 48)),
                   (240, (12, 24, 24)), (320, (6, 12, 12))]
TRAIN_BATCH = 2  # the per-GPU batch of the shipped bs4 run (BASELINE.md:11)
# kernel C: fp32 dw from fp32 accumulation against the fp32 plain version on
# the same bf16 inputs; the sum runs over up to 7.1M voxels in another order,
# so the bound is relative to max|dw| (measured 3.4e-5 of it at stage 0)
DW_RTOL = 1e-3
TRAIN_STEPS = 6         # training iterations; the first 2 are warm-up
TRAIN_CASE_SHAPE = (128, 288, 288)  # synthetic preprocessed cases
# the split's validation cases, one a source dataset: smaller than a training
# case, still 2 x 2 x 2 tiles; their original grid is at CASE_SPACING_ZYX,
# cropped CROP_MARGIN voxels inside the volume, so the export resizes back
VAL_CASE_SHAPE = (112, 224, 224)
VAL_KEYS = ("003_001", "009_003")
CROP_MARGIN = (2, 4, 4)
# kernel D's stats (kernel E's too): fp32 sums of the same bf16 values in
# another order, relative to the sums of |terms|
STATS_RTOL = 1e-3
# (C, spatial) of every InstanceNorm of the flagship at patch 96x192x192
NORM_SHAPES = KERNEL_A_SHAPES
# the fused vs the unfused predict CLI, region masks of one bf16 case: both
# routes round every activation to bf16, but at other points (the fused
# route rounds the raw conv output before the norm, takes the variance as
# E[x^2] - mean^2 from fp32 sums and rounds x * scale + shift before the
# activation), so voxels whose probability sits at the 0.5 threshold flip
# (measured on the H100 before these bounds were set: worst region 0.99654,
# mean 0.99915)
MASK_AGREE_MEAN = 0.998
MASK_AGREE_WORST = 0.99
# phase 4b, the fused forward's kernels vs its plain versions at the same
# rounding points: besides the summation orders of phase 4, kernel D's
# prologue contracts x * scale + shift into one FMA where the plain version
# rounds twice, so an activation may round one bf16 ulp apart at each of the
# 16 fused convs (measured on the H100 before this bound: max 3.00e-2, mean
# 2.00e-3)
FUSED_PROB_BOUND = 5e-2
FUSED_PROB_BOUND_MEAN = 3e-3
# MTTPU_PALLAS_NORM=1 vs the default norm changes the rounding order (the
# activation in fp32, then one cast; var clamped) at all 22 norms (measured
# on the H100 before this bound: max 3.21e-2, mean 2.26e-3)
PALLAS_NORM_BOUND = 6e-2
PALLAS_NORM_BOUND_MEAN = 4e-3
# controls for the two bounds above: the same route through the same kernels
# with a faulty activation, every LeakyReLU slope 1e-2 replaced by one of
# these; each reading must break its route's bounds, or they could not tell a
# faulty kernel from rounding
CONTROL_SLOPES = (0.0, 5e-3)

# phases 2 / 2b (Liver shapes) and 3c: the Task003 Liver 3d_fullres plans
# (bench.py:382-383): one CT modality, patch 128^3, base 32 (at most 320),
# pools (2,2,2) x 5, 3x3x3 convs, InstanceNorm + LeakyReLU, 3 classes
# (softmax); a target spacing of (1, 0.77, 0.77) mm, near the Liver set's
LIVER_TASK = "Task003_Liver"
LIVER_PATCH = (128, 128, 128)
LIVER_POOLS = ((2, 2, 2),) * 5
LIVER_SPACING_ZYX = (1.0, 0.77, 0.77)
LIVER_CLASSES = 3
# (C, spatial) the Liver forward gives kernels A (and D) and B (and D's dual
# form), and every InstanceNorm of it
LIVER_A_SHAPES = [(32, (128,) * 3), (64, (64,) * 3), (128, (32,) * 3), (256, (16,) * 3),
                  (320, (8,) * 3), (320, (4,) * 3)]
LIVER_B_SHAPES = LIVER_A_SHAPES[:5]
LIVER_TTA_CHUNK = 4  # mirror combinations a forward in the default mode
# two synthetic CT cases, resampled to 134 x 234 x 234: 2 x 3 x 3 tiles
LIVER_CASE_SHAPE = (112, 200, 200)
LIVER_CASE_SPACING_ZYX = (1.2, 0.9, 0.9)
LIVER_CASES = ("liver_000", "liver_001")
# default (non-exact) vs exact labelmaps of one case, on the voxels where
# the default mode's clamped gaussian tail adds at most LIVER_CLAMP_LIMIT of
# the blend weight (SlidingWindowPredictor.clamp_share): there fp16 input,
# bf16 probabilities and fp16 accumulators flip the argmax only where two
# classes nearly tie (the CPU test's bound for the same comparison,
# tests/test_torch_port_predict_cli_exact.py); beyond, where a case is
# little larger than the patch (134 slices of 128: both z faces), equal tail
# weights decide the blend, as in the JAX package's default mode, and that
# share is printed
LIVER_EXACT_AGREE = 0.99
LIVER_CLAMP_LIMIT = 0.01

# phase 8: the MultiTalent resenc plans (MultiTalent_resenc_bs4_plans_3D.pkl,
# SURVEY.md:76,108; the shipped pkl is not in the repository): the
# flagship's modality, patch, spacing, base 30 (planning/
# multitalent_planner.py:32) up to 320 and 47 sigmoid regions, with the
# pools' leading (1,1,1) stage and the residual encoder's block counts
# (1,2,3,4,4,4) and (1,1,1,1,1), batch 2, bf16, deep supervision; its kernel
# shapes are the flagship's (phase 2)
RESENC_PLANS_ID = "MultiTalent_resenc_bs4"
RESENC_TRAINER = "MultiTalent_trainer_resenc_ddp"
RESENC_TRAIN_STEPS = 4  # the first 2 are warm-up
# phase 8c, |dp| of one resenc tile's sigmoid probabilities (36 kernel
# convs, 47 norms), kernels vs the plain versions in bf16 (measured on the
# H100 before these bounds: max 1.38e-2, mean 1.06e-3), and
# MTTPU_PALLAS_NORM=1 (the 5 decoder norms on kernel E) vs the default
# (max 8.8e-3, mean 4.4e-4); the controls' faulty slope 5e-3 measured max
# 3.4e-2, mean 2.9e-3 on both
RESENC_PROB_BOUND = 3e-2
RESENC_PROB_BOUND_MEAN = 2e-3
RESENC_PALLAS_NORM_BOUND = 2e-2
RESENC_PALLAS_NORM_BOUND_MEAN = 1.5e-3
# phase 8f: the Task003 Liver plans of phase 3c as the FabiansResUNet planner
# makes them (multitalent_tpu/planning/experiment_planner.py:393-470): a
# leading (1,1,1) pool, the default block counts (1,2,3,4,4,4,4,...) cut to
# its 6 stages; one fold, one case. Its kernel shapes are the Liver net's
# (phase "2 Liver")
LIVER_RESENC_PLANS_ID = "nnUNetPlans_FabiansResUNet_v2.1"
LIVER_RESENC_TRAINER = "nnUNetTrainerV2_ResencUNet"
RESENC_DEFAULT_BLOCKS = (1, 2, 3, 4, 4, 4, 4)

# phase 9: data parallelism (parallel/distributed.py). 9a: the train CLI as
# torchrun --nproc_per_node=1 starts it (a NCCL group of one and the DDP
# wrapper) for DDP_STEPS steps and the validation, beside the same run in one
# process; 9b: two ranks sharing the card over gloo, each with one sample of
# the flagship's batch of 2, against one process with the batch, from the
# same seeded weights and host batches (augmentation off), bf16, DDP_STEPS
# steps; 9c: 9b under MTTPU_FUSED_TRAIN=1 for FUSED_DDP_STEPS steps
DDP_STEPS = 3
FUSED_DDP_STEPS = 2
DDP_NO_AUG = {"p_rot": 0.0, "p_scale": 0.0, "p_gaussian_noise": 0.0, "p_gaussian_blur": 0.0,
              "p_brightness_mult": 0.0, "p_contrast": 0.0, "p_lowres": 0.0,
              "p_gamma_invert": 0.0, "p_gamma": 0.0, "do_mirror": False}
# 9b/9c: the ranks' weight updates against the one-process run's, as
# |d_ranks - d_one| / |d_one| over every weight but the conv biases (their
# gradient is bf16 rounding noise, cancelled by the norm after them) and the
# head of loss weight 0 (no gradient in either), after the first step and
# after the last, each within DDP_UPDATE_BOUND; the losses of every step
# within DDP_LOSS_RTOL. A sample's forward at N=1 rounds to bf16 at other
# points than at N=2 (other kernel plans, other summation orders), and the
# one-ulp differences carry through ~20 layers into the gradient: measured
# on the H100 before this bound, 1.73e-2 and 1.62e-2 (9b), 1.75e-2 and
# 1.64e-2 (9c), losses 3.6e-5 apart. The control (each rank's Dice on its
# own sample, not pooled) read 5.46e-2 and 5.62e-2 and must break the bound
# at both steps (the Dice is a few percent of the gradient: BCE over the
# valid regions dominates it)
DDP_UPDATE_BOUND = 3e-2
DDP_LOSS_RTOL = 1e-3
# phase 9d: the space axis (parallel/mesh.py). Two ranks sharing the card
# over gloo train the flagship's sample at a global batch of 1: data 1 x
# space 2, the patch's x split 192 -> 96 a rank, kernels A and B on slabs
# extended by one plane a side (98, 50, 26, 14, 8, 5 along x), A's dx and C
# over them; against one process with the batch of 1, bf16, augmentation
# off, DDP_STEPS steps. The updates are held as 9b's (|d_ranks - d_one| /
# |d_one| after step 1 and the last) within SPACE_UPDATE_BOUND, the losses
# within DDP_LOSS_RTOL; the control normalises each slab with its own
# statistics and must break the bound at both steps. Every A, B and C
# shape the slabs produce (one more forward and backward after training,
# without an update) is held against its plain version within phase 2's
# bounds (A, B: ATOL + RTOL max|ref|; C: DW_RTOL max|ref|). As in 9b, a
# slab's forward rounds to bf16 at other points (other kernel plans at the
# extended extents, the norms' sums pooled in another order): measured on
# the H100 (700 W) before this bound, 1.95e-2 and 1.90e-2, losses 8.9e-5
# apart; the control read 1.14e-1 and 8.11e-2 (losses 1.3e-3 apart)
SPACE_RANKS = 2
SPACE_UPDATE_BOUND = DDP_UPDATE_BOUND

# phases 10a/10b: both workflows from raw NIfTIs. One seeded raw set of two
# nnU-Net tasks, Task003_Liver (liver + tumour) and Task009_Spleen, RAW_CASES
# CT-like phantoms each (kfold_split's 5 folds) of one field of view in mm
# at spacings that vary case by case (so resampling runs), with a zero
# border outside the field of view (so cropping runs), and one held-out
# Liver case under imagesTs. Sized so that the v21 planner plans the Task003
# Liver network (base 32 to 320, 5 pools an axis, a 128^3 patch, one stage)
# and the MultiTalent planner a 128^3 patch at its batch of 4
RAW_EXTENT_MM = (192.0, 128.0, 128.0)  # z, y, x
RAW_Z_SPACINGS = (1.0, 1.0, 1.2, 2.0, 2.5)
RAW_XY_SPACINGS = (0.7, 0.75, 0.8, 0.85, 0.9)
RAW_HELD_OUT_SPACING = (1.5, 0.8, 0.8)
RAW_CASES = len(RAW_Z_SPACINGS)
RAW_BORDER = 4  # voxels in-plane outside the field of view (0 in the image)
RAW_TASKS = {"Task003_Liver": ("liver", {0: "background", 1: "liver", 2: "cancer"},
                               ((1, (0.5, 0.35, 0.45)), (2, (0.12, 0.12, 0.12)))),
             "Task009_Spleen": ("spleen", {0: "background", 1: "spleen"},
                                ((1, (0.3, 0.2, 0.15)),))}
RAW_LIVER_PLAN = {"base_num_features": 32, "num_pool_per_axis": [5, 5, 5],
                  "patch_size": [128, 128, 128]}
RAW_TRAIN_STEPS = 4  # training iterations of each workflow; the first 2 are warm-up

# phase 11: SwinUNETR (models/swin_unetr.py) at the trainers' width over the
# flagship's plans (MultiTalent_meets_swinunetr.py: feature_size 48, depths
# (2,2,2,2), heads (3,6,12,24), window 7, no deep supervision, AMSGrad Adam
# at 5e-4): patch 96x192x192, batch 2, bf16, 47 sigmoid regions, the
# sliding window's default mode; cut in steps and cases only
SWIN_TRAINER = "MultiTalent_trainer_SwinUNETR_ddp_adam"
SWIN_WARMUP_TRAINER = "nnUNetTrainerV2_warmupsegheads_swinunetr_adam_lr5e4_ddp"
SWIN_LIVER_TRAINER = "nnUNetTrainerV2_swinunetr_adam_ddp"
SWIN_TRAIN_STEPS = 4  # the first 2 are warm-up
SWIN_PER_FORWARD = {"conv3d_same": 16, "conv3d_same_dual": 5}
SWIN_PER_STEP = {"conv3d_same": 37, "conv3d_same_dual": 5, "conv3d_same_wgrad": 21}
# (C, spatial) the SwinUNETR forward gives kernel A (encoder0, encoder1-4,
# encoder10 and the decoders' conv2) and B (each up block's conv1 over C + C)
SWIN_A_SHAPES = [(48, PATCH), (48, (48, 96, 96)), (96, (24, 48, 48)), (192, (12, 24, 24)),
                 (384, (6, 12, 12)), (768, (3, 6, 6))]
SWIN_B_SHAPES = SWIN_A_SHAPES[:5]
# phase 11c, |dp| of one SwinUNETR tile's sigmoid probabilities (21 kernel
# convs; 8 swin blocks whose attention, LayerNorms and MLPs run in plain
# torch in the same dtype flow on both sides), kernels vs the plain versions
# in bf16 (measured on the H100 before these bounds: max 1.18e-2, mean
# 9.0e-4) and kernels in bf16 vs the plain versions in fp32 (max 1.83e-2,
# mean 1.69e-3); the control, the shift masks' -100 at 0 in the 4 shifted
# blocks, read max 1.53e-1, mean 8.0e-3 and must break the bf16 bounds
SWIN_PROB_BOUND = 3e-2
SWIN_PROB_BOUND_MEAN = 2e-3
SWIN_PROB_BOUND_FP32_MAX = 5e-2
SWIN_PROB_BOUND_FP32_MEAN = 5e-3

# phase 12: MedNeXt (models/mednext.py) at the MultiTalent trainer's width
# (MultiTalent_meets_mednext.py: n_channels 32, kernel 3, exp_r and block
# counts (3,4,8,8,8,8,8,4,3), five deep-supervision heads) over the
# flagship's plans: patch 96x192x192, batch 2, bf16, 47 sigmoid regions, the
# sliding window's default mode; cut in steps and cases only. No MedNeXt
# conv runs on a hand-written kernel (the JAX package computes them in XLA)
MEDNEXT_TRAINER = "MultiTalent_meets_mednext"
MEDNEXT_TRAIN_STEPS = 3  # the first 2 are warm-up; one more repeats their shapes
# phase 12c, |dp| of one MedNeXt tile's sigmoid probabilities, the network
# in bf16 against the same weights in fp32 (TF32 off): 62 blocks of bf16
# depthwise conv, norm, 1x1x1 expansion, GELU and compression in cuDNN and
# ATen, each rounding its output, where the flagship has 22 conv layers
# (its bounds, PROB_BOUND_FP32_*: 1e-1, 1e-2); the max over 1.6e8 values is
# a tail (measured on the H100 before these bounds: max 1.44e-1, mean
# 2.65e-3)
MEDNEXT_PROB_BOUND_FP32_MAX = 2.5e-1
MEDNEXT_PROB_BOUND_FP32_MEAN = 1e-2
# phase 13: the 3d_lowres -> 3d_cascade_fullres workflow on phase 10a's
# Task003_Liver phantoms: the v21 planner's plan of 10a (the Liver network,
# 128^3) is the full-resolution stage; the lowres stage is the v21
# planner's own stage properties (get_properties_for_stage, as its lowres
# loop makes them) at CASCADE_LOWRES_FACTOR times the target spacing.
# (Phantoms large enough for the planner to add the stage by its rule, a
# median of more than 4 patches at both stages, would take minutes of host
# writing, cropping and preprocessing.) Both stages are preprocessed by the
# planner's run_preprocessing from 10a's cropped data
CASCADE_LOWRES_FACTOR = 2.0
CASCADE_TRAINER = "TrainerV2CascadeFullRes"
CASCADE_TRAIN_STEPS = 3  # of each stage; the first 2 are warm-up

# phase 14, fp32 and the variants. 14a: the fp32 forms of kernels A, B and C
# against their plain fp32 versions (TF32 off) at phase 10a's Liver shapes,
# the training batch: fp32 sums of the same products in other orders,
# bounded relative to the output's largest entry
FP32_SHAPES = (("conv3d_same", (32,), 32), ("conv3d_same_dual", (32, 32), 32),
               ("conv3d_same_wgrad", (32,), 32))
FP32_SPATIAL = (128, 128, 128)
FP32_RTOL = 1e-4
FP32_ITERS = 10  # timed launches of each (the median is reported)
# 14b fused: labels of the fused fp32 route's prediction equal to the
# unfused fp32 route's on at least this share of the voxels; one batch's loss
# through both routes on the same weights within this relative bound (fp32
# sums in other orders through 22 convs)
FP32_FUSED_AGREE = 0.9999
SOURCE_SHAPE = (8, 24, 24)  # 16: each synthetic source volume (z, y, x)
FP32_FUSED_LOSS_RTOL = 1e-4
# 14b: nnUNetTrainerV2_fp32 through cli.train 3d_fullres on 10a's Liver
# plans and phantoms; 14c: the 2D planner's plan of the same data at full
# width (base 32, max 480) through the trainer API, TrainerV2 and the
# residual-encoder UNet on it; 14d: each network variant, _DA5 and _noDA on
# 10a's Liver plans, a few steps each, and one tile through the kernels
# against the plain versions within phase 4's bounds
FP32_TRAIN_STEPS = 3
TWO_D_STEPS = 3
VARIANT_STEPS = 2
# 14d's tile: the kernels' |dp| from the plain fp32 network over the plain
# bf16 path's, (max, mean) (the kernels sum in other orders, so their bf16
# result sits as far from fp32 as the plain bf16 one: 0.97-1.19 and
# 1.00-1.00 on an H100, PERF.md §6)
VARIANT_FP32_RATIO = (1.5, 1.1)
VARIANT_TRAINERS = ("nnUNetTrainerV2_BN", "nnUNetTrainerV2_GN", "nnUNetTrainerV2_FRN",
                    "nnUNetTrainerV2_NoNormalization", "nnUNetTrainerV2_ReLU",
                    "nnUNetTrainerV2_GeLU", "nnUNetTrainerV2_Mish",
                    "nnUNetTrainerV2_LReLU_slope_2en1", "nnUNetTrainerV2_ReLU_biasInSegOutput",
                    "nnUNetTrainerV2_lReLU_biasInSegOutput", "nnUNetTrainerV2_3ConvPerStage",
                    "nnUNetTrainerV2_3ConvPerStageSameFilters", "nnUNetTrainerV2_allConv3x3",
                    "nnUNetTrainerV2_DA5", "nnUNetTrainerV2_noDA")

# phase 15: the loss, optimizer, schedule and network variants (one name of
# each class of training/variants.py that 14d leaves out), 2 steps each on
# 10a's Liver plans; _momentum09in2D on 14c's 2D plan
ZOO_STEPS = 2
ZOO_TRAINERS = (
    "nnUNetTrainerV2_Loss_CE", "nnUNetTrainerV2_Loss_Dice", "nnUNetTrainerV2_Loss_DicewithBG",
    "nnUNetTrainerV2_Loss_TopK10", "nnUNetTrainerV2_Loss_DiceTopK10",
    "nnUNetTrainerV2_focalLoss", "nnUNetTrainerV2_GDL", "nnUNetTrainerV2_Loss_CEGDL",
    "nnUNetTrainerV2_Loss_MCC", "nnUNetTrainerV2_Loss_MCCnoBG",
    "nnUNetTrainerV2_Loss_DC_CE_squared", "nnUNetTrainerV2_Loss_Dice_squared",
    "nnUNetTrainerV2_Loss_DiceCE_noSmooth", "nnUNetTrainerV2_graduallyTransitionFromCEToDice",
    "nnUNetTrainerV2_Loss_Dice_LR1en3", "nnUNetTrainerV2_Loss_DicewithBG_LR1en3",
    "nnUNetTrainerV2_Adam", "nnUNetTrainerV2_Adam_nnUNetTrainerlr", "nnUNetTrainerV2_constLR",
    "nnUNetTrainerV2_momentum09", "nnUNetTrainerV2_momentum095", "nnUNetTrainerV2_momentum098",
    "nnUNetTrainerV2_Ranger", "nnUNetTrainerV2_Ranger_lr1en2", "nnUNetTrainerV2_Ranger_lr3en3",
    "nnUNetTrainerV2_SGD_lr1en1", "nnUNetTrainerV2_SGD_lr1en3", "nnUNetTrainerV2_cycleAtEnd",
    "nnUNetTrainerV2_cycleAtEnd2", "nnUNetTrainerV2_SGD_ReduceOnPlateau",
    "nnUNetTrainerV2_Adam_ReduceOnPlateau", "nnUNetTrainerV2_SGD_fixedSchedule2",
    "nnUNetTrainerV2_reduceMomentumDuringTraining", "nnUNetTrainerV2_ReLU_convReLUIN",
    "nnUNetTrainerV2_lReLU_convReLUIN", "nnUNetTrainerV2_resample33")
ZOO_2D_TRAINER = "nnUNetTrainerV2_momentum09in2D"
ZOO_PREDICTED = "nnUNetTrainerV2_lReLU_convReLUIN"
# 15a: the card's loss against the CPU's in fp32 on the same tensors
# (relative), and the card's update of step 2 against the CPU optimizer's
# from the same parameters, state and gradients (of max |update|): the same
# fp32 operations, summed in other orders
ZOO_LOSS_RTOL = 1e-4
ZOO_UPDATE_RTOL = 1e-5
# 15d: the epochs at which the schedules are printed (1000 epochs of 250
# steps, _cycleAtEnd2 1200) and the plateau trainers' train-loss moving
# average: a fall of 1e-2 an epoch for 10 epochs, then flat
ZOO_EPOCHS = (0, 10, 41, 72, 699, 700, 750, 899, 900, 999, 1100, 1199)
ZOO_MOMENTUM_EPOCHS = (800, 900, 1000)

# phase 6, the probes at the shapes their scripts time: the conv arms
# (scripts/conv_impl_arms.py:366), the packed conv at the flagship's stages 0
# and 1, unpacked shape and factors, and the cost / grid probes' volume
ARM_SHAPE = (2, 96, 96, 96, 120)
# the conv arms' first bodies (C % 8 != 0): a shape of the card tests'
FIRST_BODY_SHAPE = ((2, 6, 10, 14, 30), 47)
# the Winograd kernel against its plain version with the same rounding
# points (U, V and the output each rounded to bf16 once): the two round fp32
# sums taken in other orders (64-channel chunks, wgmma's order) to bf16, so
# they may differ by one bf16 ulp of the output, at most 2^-7 of max|ref|
WINO_SELF_RTOL, WINO_SELF_ATOL = 2.0 ** -7, 1e-3
PACKED_CASES = (((1, 96, 192, 192, 30), (2, 2)), ((1, 48, 96, 96, 60), (1, 2)))
PROBE_SHAPE = (1, 96, 96, 96, 128)
PROBE_ITERS = 10  # timed launches per configuration on the probe path
# the least time of a kernel's work on an H100 SXM at its published peaks
# (dense bf16 tensor cores, fp32 CUDA cores, HBM): the larger of its
# operations over the peak rate of their type and its bytes (each input read
# once, each output written once) over the memory rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def phase_device() -> tuple[str, str, float]:
    import torch
    from multitalent_tpu_torch import _build
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible)")
    print(smi)
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s ({_build.library_path().name})")
    return name, smi, build_s


def _check(name: str, got, ref, bound: float) -> float:
    import torch
    err = (got.float() - ref.float()).abs().max().item()
    if not (err <= bound and torch.isfinite(got).all()):
        raise AssertionError(f"{name}: max|d| {err:.3e} > {bound:.3e}")
    return err


def phase_kernels(a_shapes=KERNEL_A_SHAPES, b_shapes=KERNEL_B_SHAPES,
                  batches=(1, TRAIN_BATCH), backward: bool = True) -> dict:
    """Each kernel vs its plain version at a network's shapes (the
    flagship's by default): A at a_shapes and B at b_shapes, at each batch
    of `batches`; with `backward`, C and A's dx at the training batch."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    results = {"conv3d_same": [], "conv3d_same_dual": [], "conv3d_same_wgrad": [],
               "conv3d_same_dx": []}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def report(name, splits, cout, sp, n, err, bound, ms, plain_ms, cudnn_ms):
        tflops = 2 * 27 * sum(splits) * cout * n * int(torch.tensor(sp).prod()) / (ms * 1e9)
        print(f"{name} {'+'.join(map(str, splits))}->{cout} at {'x'.join(map(str, sp))} "
              f"N={n}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms "
              f"({tflops:.1f} TFLOP/s), plain fp32 {plain_ms:.3f} ms, "
              f"cuDNN bf16 {cudnn_ms:.3f} ms")
        results[name].append({"splits": splits, "cout": cout, "spatial": sp, "n": n,
                              "err": err, "ms": ms, "plain_ms": plain_ms,
                              "cudnn_bf16_ms": cudnn_ms})

    # forward: A and B at N=1, then A and B at the larger batch (the
    # step's forward launches or a TTA chunk's, where a block's walk crosses
    # from one sample to the next); each into a NaN-filled buffer, with its
    # plan
    cases = []
    for n in batches:
        cases += [("conv3d_same", (c,), c, sp, n) for c, sp in a_shapes]
        cases += [("conv3d_same_dual", (c, c), c, sp, n) for c, sp in b_shapes]
    for name, splits, cout, sp, n in cases:
        cin = sum(splits)
        ins = [rnd(n, *sp, c).to(torch.bfloat16) for c in splits]
        w = rnd(cout, cin, 3, 3, 3, scale=(2.0 / (27 * cin)) ** 0.5)
        w_bf = w.to(torch.bfloat16)
        bias = rnd(cout, scale=0.1)
        pw = cv.prepare_conv3d_weight(w, splits if len(splits) == 2 else None)
        kernel = getattr(cv, name)
        plain = {"conv3d_same": cv.conv3d_same_ref,
                 "conv3d_same_dual": cv.conv3d_same_dual_ref}[name]
        ins32 = [t.float() for t in ins]
        ref = plain(*ins32, w_bf.float(), bias)
        bound = ATOL + RTOL * ref.abs().max().item()
        err = _check(f"{name} {splits}->{cout} at {sp} N={n}",
                     kernel(*ins, pw, bias, out=_nan_filled((n, *sp, cout), dev)), ref, bound)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w_bf.contiguous(memory_format=torch.channels_last_3d)
        cudnn = lambda: F.conv3d(x_cl, w_cl, bias.to(torch.bfloat16), padding=1)  # noqa: E731
        report(name, splits, cout, sp, n, err, bound,
               _median_ms(lambda: kernel(*ins, pw, bias)),
               _median_ms(lambda: plain(*ins32, w_bf.float(), bias)), _median_ms(cudnn))
        _plan(results[name][-1], "a" if name == "conv3d_same" else "b",
              lambda: kernel(*ins, pw, bias), cudnn)
        del ins, ins32, ref, x_cl

    # backward at the training batch: dw by kernel C (single at A's shapes,
    # dual at B's), each checked in a dw buffer filled with NaN and timed
    # beside its bound and its write path (dw directly, or per-split
    # partials and a second launch); dx of the dual convs by kernel A (C ->
    # 2C channels)
    n = TRAIN_BATCH
    cases = [(c, (c,), sp) for c, sp in a_shapes] if backward else []
    cases += [(c, (c, c), sp) for c, sp in b_shapes] if backward else []
    for cout, splits, sp in cases:
        ins = [rnd(n, *sp, c).to(torch.bfloat16) for c in splits]
        g = rnd(n, *sp, cout).to(torch.bfloat16)
        if len(splits) == 1:
            kernel, plain = cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_ref
        else:
            kernel, plain = cv.conv3d_same_wgrad_dual, cv.conv3d_same_wgrad_dual_ref
        ins32, g32 = [t.float() for t in ins], g.float()
        ref = plain(*ins32, g32)
        bound = DW_RTOL * ref.abs().max().item()
        shape = (cout, sum(splits), 3, 3, 3)
        out = torch.full(shape, float("nan"), device=dev)
        err = _check(f"conv3d_same_wgrad {splits}->{cout} at {sp}", kernel(*ins, g, out=out),
                     ref, bound)
        ws = cv.conv3d_same_wgrad_workspace(n, *sp, splits[0], sum(splits[1:]), cout)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        g_cl = g.permute(0, 4, 1, 2, 3)
        report("conv3d_same_wgrad", splits, cout, sp, n, err, bound,
               _median_ms(lambda: kernel(*ins, g)), _median_ms(lambda: plain(*ins32, g32)),
               _median_ms(lambda: torch.nn.grad.conv3d_weight(x_cl, shape, g_cl, padding=1)))
        results["conv3d_same_wgrad"][-1].update(
            write="direct" if ws == 0 else f"{ws // (4 * prod(shape))} splits + reduce",
            **_conv_bound(sum(splits), cout, sp, n, w_bytes=4))
        print(f"  bound {results['conv3d_same_wgrad'][-1]['bound_ms']:.3f} ms, "
              f"{results['conv3d_same_wgrad'][-1]['write']}")
        del ins, ins32, ref, x_cl, out
        if len(splits) == 2:  # dx of the dual conv: one A launch, Cout -> Ca + Cb
            w = rnd(cout, sum(splits), 3, 3, 3, scale=(2.0 / (27 * sum(splits))) ** 0.5)
            wt = w.to(torch.bfloat16).float().flip(2, 3, 4).transpose(0, 1)
            ref = cv.conv3d_same_ref(g32, wt)
            bound = ATOL + RTOL * ref.abs().max().item()
            err = _check(f"conv3d_same dx {cout}->{sum(splits)} at {sp}",
                         cv.conv3d_same_dx(g, w, out=_nan_filled((n, *sp, sum(splits)), dev)),
                         ref, bound)
            wt_cl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
            cudnn = lambda: F.conv3d(g_cl, wt_cl, padding=1)  # noqa: E731
            report("conv3d_same_dx", (cout,), sum(splits), sp, n, err, bound,
                   _median_ms(lambda: cv.conv3d_same_dx(g, w)),
                   _median_ms(lambda: cv.conv3d_same_ref(g32, wt)), _median_ms(cudnn))
            # conv3d_same_dx prepares the flipped weight a call; kernel A alone
            # on that weight prepared once, single and queued, beside cuDNN's
            # call on the flipped weight
            pw_t = cv.prepare_conv3d_weight(w.flip(2, 3, 4).transpose(0, 1))
            row = results["conv3d_same_dx"][-1]
            row["prepared_ms"] = _median_ms(lambda: cv.conv3d_same(g, pw_t))
            print(f"  kernel A on the weight prepared once: {row['prepared_ms']:.3f} ms")
            _plan(row, "a", lambda: cv.conv3d_same(g, pw_t), cudnn)
            del ref
        del g, g32, g_cl
    torch.cuda.empty_cache()
    return results


def _plan(row: dict, form: str, kernel=None, cudnn=None) -> None:
    """The plan of kernel A, B, D or D's dual form (`form`, as
    ops.conv3d.conv3d_same_plan takes it) at a timed shape into its row (and
    a line), with the shape's bound: which body, chunks staged at once,
    weights resident or streamed, warps a block, ring stages, K splits,
    blocks. With `kernel` and `cudnn` (A's and B's calls), their queued
    times too: a single call's time also holds the host's work before the
    launch (tens of us for these wrappers)."""
    from multitalent_tpu_torch.ops import conv3d as cv
    splits, n, sp = tuple(row["splits"]), row["n"], tuple(row["spatial"])
    plan = cv.conv3d_same_plan(n, *sp, splits[0] if len(splits) == 1 else splits, row["cout"],
                               form)
    row["plan"] = plan
    row.update(_affine_bound(sum(splits), row["cout"], sp, n, form == "d")
               if form.startswith("d") else _conv_bound(sum(splits), row["cout"], sp, n))
    if not (plan["ring"] or plan["wgmma"]):
        raise AssertionError(f"kernel {form} at {sp} N={n}: the plan names neither body")
    body = ("ring body" if plan["ring"] else
            f"the wgmma body (TMA halo boxes, BN {plan['wgmma_bn']}, K splits "
            f"{plan['wgmma_splits']}, {plan['wgmma_blocks']} blocks, "
            f"{plan['wgmma_smem_bytes']} B shared)")
    if kernel is not None:
        row.update(queued_ms=_queued_ms(kernel), cudnn_queued_ms=_queued_ms(cudnn))
        print(f"  queued: kernel {row['queued_ms']:.3f} ms, cuDNN {row['cudnn_queued_ms']:.3f} ms")
    print(f"  plan: {body}; ring: G {plan['g']}, weights "
          f"{'resident' if plan['resident'] else 'streamed'}, 16 warps "
          f"(groups split {'K' if plan['ksplit'] else 'N'}) x "
          f"{plan['blocks_per_sm']} block(s) an SM, {plan['stages']} stages, "
          f"{plan['smem_bytes']} B shared, K splits {plan['splits']}, {plan['grid_x']} blocks "
          f"along the tiles; bound {row['bound_ms']:.3f} ms ({row['bound_by']})")


def _stats_rel_err(stats, out) -> float:
    """max |stats - the plain version's stats of the same out| relative to
    the sums of |out| and out^2."""
    from multitalent_tpu_torch.ops.fused_norm import channel_stats_ref
    ref = channel_stats_ref(out.float())
    scale = channel_stats_ref(out.float().abs())
    return ((stats - ref).abs() / (scale + 1e-6)).max().item()


def _queued_ms(fn, iters: int = 50) -> float:
    """fn's time on the card a call when `iters` calls are queued back to back
    (CUDA events around all of them, after 3 warm-up calls): single calls of
    short kernels spread up to +-40% from run to run, queued ones far less."""
    import torch
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_us(fn, calls: int = 50) -> float:
    """The host's us a call of fn over `calls` calls issued back to back,
    the card's queue drained before and after (what a single call's time
    holds beside the card's)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def _device_launches(fn) -> int:
    """Work items fn puts on the card a call (kernels, copies, fills): the
    kernel, copy and fill nodes of a CUDA graph captured from one call after
    a warm-up call, read with the driver's cuGraphGetNodes. The count is
    exact from run to run (torch.profiler's CUPTI trace once returned no
    event here); fails where the graph holds no work."""
    import ctypes
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")

    def ok(code, what):
        if code != 0:
            raise RuntimeError(f"{what} failed: CUresult {code}")

    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    count = ctypes.c_size_t(0)
    ok(cuda.cuGraphGetNodes(handle, None, ctypes.byref(count)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * count.value)()
    ok(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(count)), "cuGraphGetNodes")
    work = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        ok(cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
           "cuGraphNodeGetType")
        work += kind.value in (0, 1, 2)  # CU_GRAPH_NODE_TYPE_KERNEL, _MEMCPY, _MEMSET
    graph.reset()
    if work == 0:
        raise AssertionError("the captured call put no work on the card")
    return work


def _stats_bound(c: int, spatial, n: int) -> dict:
    """Kernel E's stats pass: bf16 x read once, the (n, 2, c) fp32 stats
    written once; 3 fp32 operations an element (a square and two adds)."""
    vox = n * prod(spatial)
    return _bound(vox * c * 2 + n * 2 * c * 4, fp32_flops=3 * vox * c)


def _head_bound(c: int, k: int, spatial, n: int) -> dict:
    """Kernel F: bf16 x read once, bf16 logits written once; the products on
    the tensor cores (2 c k an output voxel), the prologue's 4 fp32
    operations an input element on the CUDA cores."""
    vox = n * prod(spatial)
    return _bound(vox * (c + k) * 2, bf16_flops=2 * c * k * vox, fp32_flops=4 * c * vox)


def phase_fused_kernels(a_shapes=KERNEL_A_SHAPES, b_shapes=KERNEL_B_SHAPES,
                        norm_shapes=NORM_SHAPES, batches=(1, TRAIN_BATCH), norm_batches=(1,),
                        classes: int = 47) -> dict:
    """The fused chain's kernels D, E and F vs their plain versions at a
    network's shapes (the flagship's by default), each timed beside the
    unfused route it replaces: D at a_shapes and its dual form at b_shapes
    at each of `batches`, E at norm_shapes and F (C of a_shapes[0] ->
    `classes`) at each of `norm_batches`."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.models.blocks import instance_norm_lrelu, to_ndhwc
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    results = {"conv3d_same_affine": [], "channel_stats": [], "affine_lrelu": [],
               "seghead": []}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def ncdhw(t):
        return t.permute(0, 4, 1, 2, 3)

    def report(name, what, err, bound, ms, plain_ms, unfused_ms, unfused_what, **extra):
        print(f"{name} {what}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, unfused route ({unfused_what}) {unfused_ms:.3f} ms"
              + "".join(f", {k} {v:.3e}" if isinstance(v, float) else f", {k} {v}"
                        for k, v in extra.items()))
        results[name].append({"what": what, "err": err, "ms": ms, "plain_ms": plain_ms,
                              "unfused_ms": unfused_ms, **extra})

    # kernel D with the prologue and the stats, N=1 (inference) and the
    # larger batch (training, or a TTA chunk)
    for n in batches:
        for c, sp in a_shapes:
            x = rnd(n, *sp, c, scale=2.0).to(torch.bfloat16)
            w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
            w_bf = w.to(torch.bfloat16)
            bias = rnd(c, scale=0.1)
            sc, sh = rnd(n, c).abs() + 0.5, rnd(n, c)
            norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
            pw = cv.prepare_conv3d_weight(w)
            out, stats = cv.conv3d_same_affine(x, pw, bias, sc, sh,
                                               out=_nan_filled((n, *sp, c), dev),
                                               stats=_nan_stats(n, c, dev))
            ref, _ = cv.conv3d_same_affine_ref(x, w_bf, bias, sc, sh)
            bound = ATOL + RTOL * ref.float().abs().max().item()
            err = _check(f"conv3d_same_affine {c}->{c} at {sp} N={n}", out, ref, bound)
            serr = _stats_rel_err(stats, out)
            if not serr <= STATS_RTOL:
                raise AssertionError(f"conv3d_same_affine stats: {serr:.3e} > {STATS_RTOL}")
            x_cl = ncdhw(x)
            w_cl = w_bf.contiguous(memory_format=torch.channels_last_3d)
            b_bf = bias.to(torch.bfloat16)
            report("conv3d_same_affine", f"{c}->{c} at {'x'.join(map(str, sp))} N={n}", err,
                   bound, _median_ms(lambda: cv.conv3d_same_affine(x, pw, bias, sc, sh)),
                   _median_ms(lambda: cv.conv3d_same_affine_ref(x, w_bf, bias, sc, sh)),
                   _median_ms(lambda: F.conv3d(instance_norm_lrelu(x_cl, norm_w, norm_b),
                                               w_cl, b_bf, padding=1)),
                   "norm + cuDNN bf16 conv",
                   unfused_kernel_a_ms=_median_ms(lambda: cv.conv3d_same(
                       to_ndhwc(instance_norm_lrelu(x_cl, norm_w, norm_b)), pw, bias)),
                   stats_rel_err=serr)
            results["conv3d_same_affine"][-1].update(splits=(c,), cout=c, spatial=sp, n=n)
            _plan(results["conv3d_same_affine"][-1], "d")
            del x, x_cl, out, ref
    # kernel D's dual form (decoders' first convs), at the same batches: on
    # the body its plan names (at 16-byte rows with streamed weights the
    # wgmma body, with B's plan: bit-equal to kernel B's output), timed
    # beside B alone and B then E's stats pass (the two-launch way to the
    # same out and stats)
    for n in batches:
        for c, sp in b_shapes:
            a, b = (rnd(n, *sp, c).to(torch.bfloat16) for _ in range(2))
            w = rnd(c, 2 * c, 3, 3, 3, scale=(2.0 / (54 * c)) ** 0.5)
            w_bf = w.to(torch.bfloat16)
            bias = rnd(c, scale=0.1)
            pw = cv.prepare_conv3d_weight(w, (c, c))
            what = f"conv3d_same_dual_stats {c}+{c}->{c} at {sp} N={n}"
            before = dict(cv.conv3d_same_affine.launches_by_body)
            out, stats = cv.conv3d_same_dual_stats(a, b, pw, bias,
                                                   out=_nan_filled((n, *sp, c), dev),
                                                   stats=_nan_stats(n, c, dev))
            plan = cv.conv3d_same_plan(n, *sp, (c, c), c, "d_dual")
            body = "ring" if plan["ring"] else "wgmma"
            after = cv.conv3d_same_affine.launches_by_body
            if after != {**before, body: before[body] + 1}:
                raise AssertionError(f"{what}: launches by body {before} -> {after}, the "
                                     f"plan names the {body} body")
            b_plan = cv.conv3d_same_plan(n, *sp, (c, c), c, "b")
            if b_plan["wgmma"] and body != "wgmma":
                raise AssertionError(f"{what}: kernel B runs the wgmma body, D's dual form "
                                     f"not: {plan}")
            ref, _ = cv.conv3d_same_dual_stats_ref(a, b, w_bf, bias)
            bound = ATOL + RTOL * ref.float().abs().max().item()
            err = _check(what, out, ref, bound)
            serr = _stats_rel_err(stats, out)
            if not serr <= STATS_RTOL:
                raise AssertionError(f"conv3d_same_dual_stats N={n} stats: {serr:.3e} > "
                                     f"{STATS_RTOL}")
            bit_equal = bool(torch.equal(out, cv.conv3d_same_dual(a, b, pw, bias)))
            if (b_plan["ring"], b_plan["wgmma"]) == (plan["ring"], plan["wgmma"]) and not bit_equal:
                raise AssertionError(f"{what}: the output differs from kernel B's on the same "
                                     f"{body} body")
            again, again_stats = cv.conv3d_same_dual_stats(a, b, pw, bias)
            if not (torch.equal(again, out) and torch.equal(again_stats, stats)):
                raise AssertionError(f"{what}: two calls differ")
            b_call = lambda: cv.conv3d_same_dual(a, b, pw, bias)
            b_then_stats = lambda: fn.channel_stats(cv.conv3d_same_dual(a, b, pw, bias))
            d_call = lambda: cv.conv3d_same_dual_stats(a, b, pw, bias)
            report("conv3d_same_affine",
                   f"dual {c}+{c}->{c} at {'x'.join(map(str, sp))} N={n}", err, bound,
                   _median_ms(d_call),
                   _median_ms(lambda: cv.conv3d_same_dual_stats_ref(a, b, w_bf, bias)),
                   _median_ms(b_call), "kernel B, no stats", stats_rel_err=serr, body=body,
                   bit_equal_to_b=bit_equal, queued_ms=_queued_ms(d_call),
                   b_queued_ms=_queued_ms(b_call), library_ms=_median_ms(b_then_stats),
                   library_what="kernel B, then kernel E's stats pass",
                   library_queued_ms=_queued_ms(b_then_stats))
            results["conv3d_same_affine"][-1].update(splits=(c, c), cout=c, spatial=sp, n=n)
            _plan(results["conv3d_same_affine"][-1], "d_dual")
            del a, b, out, ref
    # kernel E at every norm shape, at each of norm_batches: stats (bit-equal
    # from call to call, launches a call from a captured graph, queued time beside
    # the single call's, bound), then apply in both rounding orders; the
    # unfused route is the port's plain norm (stats + normalize)
    for n in norm_batches:
        for c, sp in norm_shapes:
            x = (rnd(n, *sp, c, scale=3.0) + 1).to(torch.bfloat16)
            what = f"{c} at {'x'.join(map(str, sp))} N={n}"
            stats = fn.channel_stats(x)
            if not torch.equal(stats, fn.channel_stats(x)):
                raise AssertionError(f"channel_stats {what}: two calls differ")
            serr = (((stats - fn.channel_stats_ref(x)).abs()
                     / fn.channel_stats_ref(x.abs())).max().item())
            if not serr <= 1e-4:
                raise AssertionError(f"channel_stats {what}: {serr:.3e} > 1e-4")
            per_call = _device_launches(lambda: fn.channel_stats(x))
            if not 1 <= per_call <= 2:
                raise AssertionError(f"channel_stats {what}: {per_call} launches a call")
            norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
            x_cl = ncdhw(x)
            unfused_ms = _median_ms(lambda: instance_norm_lrelu(x_cl, norm_w, norm_b))
            # one PyTorch call of the same function: per-channel mean and variance
            report("channel_stats", what, serr, 1e-4, _median_ms(lambda: fn.channel_stats(x)),
                   _median_ms(lambda: fn.channel_stats_ref(x)), unfused_ms,
                   "plain norm: stats + normalize",
                   library_ms=_median_ms(lambda: torch.var_mean(x, dim=(1, 2, 3),
                                                                correction=0)),
                   queued_ms=_queued_ms(lambda: fn.channel_stats(x)),
                   launches_per_call=per_call, **_stats_bound(c, sp, n))
            results["channel_stats"][-1].update(c=c, spatial=sp, n=n)
            sc, sh = fn.stats_affine(stats, norm_w, norm_b, prod(sp))
            sc, sh = sc.contiguous(), sh.contiguous()
            for cast_first in (True, False):
                got = fn.affine_lrelu(x, sc, sh, 1e-2, cast_first)
                want = fn.affine_lrelu_ref(x, sc, sh, 1e-2, cast_first).float()
                # exact: the kernel rounds the product, the sum, the cast and the
                # activation where the plain version does
                bad = (got.float() != want).sum().item()
                err = (got.float() - want).abs().max().item()
                if bad:
                    raise AssertionError(f"affine_lrelu {what}: {bad} values differ")
                report("affine_lrelu", f"{what} cast_first={cast_first}", err, 0.0,
                       _median_ms(lambda: fn.affine_lrelu(x, sc, sh, 1e-2, cast_first)),
                       _median_ms(lambda: fn.affine_lrelu_ref(x, sc, sh, 1e-2, cast_first)),
                       unfused_ms, "plain norm: stats + normalize",
                       **_bound(2 * x.numel() * 2, fp32_flops=4 * x.numel()))
            del x, x_cl, got, want
    # kernel F at the stage-0 head, at each of norm_batches: raw (N, *sp, C)
    # -> `classes` bf16, into a NaN-filled output; timed beside its form
    # without the prologue and one PyTorch call of that form's function
    # (torch.mm of the bf16 (K, C) head with the (C, S) view of raw gives F's
    # (K, S) output at N=1; torch.matmul with the (N, C, S) view at N > 1)
    c, sp = a_shapes[0]
    k = classes
    for n in norm_batches:
        what = f"{c}->{k} at {'x'.join(map(str, sp))} N={n}"
        raw = rnd(n, *sp, c, scale=2.0).to(torch.bfloat16)
        head = rnd(k, c, 1, 1, 1, scale=(1.0 / c) ** 0.5)
        sc, sh = rnd(n, c).abs() + 0.5, rnd(n, c)
        norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
        got = sg.seghead(raw, head, None, sc, sh, 1e-2, torch.bfloat16,
                         out=_nan_filled((n, k, *sp), dev))
        ref = sg.seghead_ref(raw, head, None, sc, sh, 1e-2, torch.float32)
        bound = ATOL + RTOL * ref.abs().max().item()
        err = _check(f"seghead {what}", got, ref, bound)
        del got, ref
        plain = sg.seghead(raw, head, None, None, None, 1e-2, torch.bfloat16)
        head_mm = head.reshape(k, c).to(torch.bfloat16)
        raw_cs = raw.view(-1, c).t() if n == 1 else raw.view(n, -1, c).transpose(1, 2)
        mm = torch.mm(head_mm, raw_cs) if n == 1 else torch.matmul(head_mm, raw_cs)
        perr = _check(f"seghead {what}, no prologue, vs torch.mm", plain,
                      mm.view(n, k, *sp), ATOL + RTOL * mm.float().abs().max().item())
        del plain, mm
        raw_cl, head_bf = ncdhw(raw), head.to(torch.bfloat16)
        with_prologue = lambda: sg.seghead(raw, head, None, sc, sh, 1e-2, torch.bfloat16)
        no_prologue = lambda: sg.seghead(raw, head, None, None, None, 1e-2, torch.bfloat16)
        library = ((lambda: torch.mm(head_mm, raw_cs)) if n == 1
                   else (lambda: torch.matmul(head_mm, raw_cs)))
        report("seghead", what, err, bound, _median_ms(with_prologue),
               _median_ms(lambda: sg.seghead_ref(raw, head, None, sc, sh, 1e-2,
                                                 torch.bfloat16)),
               _median_ms(lambda: F.conv3d(instance_norm_lrelu(raw_cl, norm_w, norm_b),
                                           head_bf).float()),
               "plain norm + cuDNN bf16 1x1x1 conv + fp32 cast",
               queued_ms=_queued_ms(with_prologue), no_prologue_ms=_median_ms(no_prologue),
               no_prologue_queued_ms=_queued_ms(no_prologue), no_prologue_err=perr,
               library_ms=_median_ms(library), library_queued_ms=_queued_ms(library),
               launches_per_call=_device_launches(with_prologue), **_head_bound(c, k, sp, n))
        del raw, raw_cl, raw_cs
    torch.cuda.empty_cache()
    return results


def _flagship_plans():
    from multitalent_tpu_torch.io import Plans
    return Plans.from_dict({
        "num_stages": 1, "num_modalities": 1, "modalities": {0: "CT"},
        "normalization_schemes": {0: "CT"}, "num_classes": 47,
        "all_classes": list(range(1, 48)), "base_num_features": 30,
        "use_mask_for_norm": {0: False}, "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "data_identifier": "nnUNetData_plans_v2.1",
        "preprocessor_name": "GenericPreprocessor",
        "dataset_properties": {"intensityproperties": {0: {
            "percentile_00_5": -1000.0, "percentile_99_5": 1500.0,
            "mean": 100.0, "sd": 300.0}}},
        "plans_per_stage": {0: {
            "batch_size": 2, "patch_size": list(PATCH),
            "current_spacing": list(SPACING_ZYX), "original_spacing": list(SPACING_ZYX),
            "median_patient_size_in_voxels": list(CASE_SHAPE),
            "num_pool_per_axis": [4, 5, 5],
            "pool_op_kernel_sizes": [list(p) for p in FLAGSHIP_POOLS],
            "conv_kernel_sizes": [list(k) for k in FLAGSHIP_KERNELS]}}})


def _flagship_net(plans, dtype):
    """The flagship network with seeded random weights in the reference's
    init (InitWeights_He(1e-2): kaiming normal, zero conv bias)."""
    import torch
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    torch.manual_seed(SEED)
    net = build_unet_from_plans(plans, 0, num_classes=47, dtype=dtype)
    for m in net.modules():
        if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
            torch.nn.init.kaiming_normal_(m.weight, a=1e-2)
            if m.bias is not None:
                torch.nn.init.zeros_(m.bias)
    return net


def _kernel_counters() -> dict:
    """Every kernel wrapper of the port by the name its launch count goes by."""
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    from multitalent_tpu_torch.probes import (conv_impl_arms, grid_overhead_probe,
                                              sparse_conv_arm)
    return {"conv3d_same": cv.conv3d_same, "conv3d_same_dual": cv.conv3d_same_dual,
            "conv3d_same_wgrad": cv.conv3d_same_wgrad,
            "conv3d_same_fp32": cv.conv3d_same_fp32,
            "conv3d_same_dual_fp32": cv.conv3d_same_dual_fp32,
            "conv3d_same_wgrad_fp32": cv.conv3d_same_wgrad_fp32,
            "conv3d_same_affine": cv.conv3d_same_affine,
            "channel_stats": fn.channel_stats, "affine_lrelu": fn.affine_lrelu,
            "seghead": sg.seghead,
            "conv3d_same_affine_fp32": cv.conv3d_same_affine_fp32,
            "channel_stats_fp32": fn.channel_stats_fp32,
            "affine_lrelu_fp32": fn.affine_lrelu_fp32, "seghead_fp32": sg.seghead_fp32,
            **conv_impl_arms.kernels(), **sparse_conv_arm.kernels(),
            **grid_overhead_probe.kernels()}


# kernels A's, B's and D's launches by body (ops.conv3d.BODIES) in the last
# _run_counted run, and in each _recording block by wrapper name
BODY_COUNTS: dict = {}
RECORDED_BODIES: dict = {}


def _check_d_bodies(d_shapes: collections.Counter, where: str) -> dict:
    """Kernel D's launches by body in the _recording of it just made: every
    dual-form call whose plan names the wgmma body (16-byte rows, streamed
    weights) counted there, every other on the ring; at least one dual call
    there. Returns the counts (printed)."""
    from multitalent_tpu_torch.ops import conv3d as cv
    bodies = RECORDED_BODIES["conv3d_same_affine"]
    wgmma = sum(k for (splits, cout, sp, n), k in d_shapes.items() if len(splits) == 2
                and cv.conv3d_same_plan(n, *sp, splits, cout, "d_dual")["wgmma"])
    want = {"ring": sum(d_shapes.values()) - wgmma, "wgmma": wgmma}
    if bodies != want or not wgmma:
        raise AssertionError(f"{where}: kernel D's launches by body {bodies}, expected {want}")
    print(f"kernel D's launches by body ({where}): {bodies} (its dual form at 16-byte rows "
          "on the wgmma body)")
    return dict(bodies)


# the fp32 forms of C and D: every launch on the ring bodies of
# csrc/conv3d_fp32.cu (wgrad_fp32_ring_kernel, conv_fp32_ring_kernel)
FP32_RING_FORMS = ("conv3d_same_wgrad_fp32", "conv3d_same_affine_fp32")


def _check_fp32_bodies(counters: dict, where: str) -> None:
    off = {name: (counters[name].launches, dict(counters[name].launches_by_body))
           for name in FP32_RING_FORMS
           if counters[name].launches_by_body["ring"] != counters[name].launches}
    if off:
        raise AssertionError(f"{where}: fp32 C/D launches off the ring bodies {off}")


def _run_counted(fn):
    """fn() with every kernel's launch count set to 0 just before it; returns
    (fn's result, the counts read just after). Kernels A's and B's counts by
    body land in BODY_COUNTS, D's too; an fp32 C or D launch off the ring
    bodies fails."""
    counters = _kernel_counters()
    for k in counters.values():
        k.launches = 0
        if hasattr(k, "launches_by_body"):
            k.launches_by_body = dict.fromkeys(k.launches_by_body, 0)
    result = fn()
    BODY_COUNTS.clear()
    BODY_COUNTS.update({name: dict(k.launches_by_body) for name, k in counters.items()
                        if hasattr(k, "launches_by_body")})
    _check_fp32_bodies(counters, "a counted run")
    return result, {name: k.launches for name, k in counters.items()}


def _expect(counts: dict, scale: int) -> dict:
    return {name: counts.get(name, 0) * scale for name in _kernel_counters()}


def _case_tiles() -> tuple[int, list[int]]:
    """Tiles of the synthetic case once resampled to the plans' spacing, and
    that shape."""
    import numpy as np
    from multitalent_tpu_torch.ops.sliding_window import compute_steps_for_sliding_window
    resampled = [int(round(s * sp / t))
                 for s, sp, t in zip(CASE_SHAPE, CASE_SPACING_ZYX, SPACING_ZYX)]
    n_tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        PATCH, resampled, 0.5)]))
    return n_tiles, resampled


def _write_main_case(workdir: str) -> None:
    """The flagship model folder and one synthetic CT case under workdir."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.inference.model_restore import save_model_folder
    from multitalent_tpu_torch.io import Geometry, write_nifti

    plans = _flagship_plans()
    net = _flagship_net(plans, torch.bfloat16)
    save_model_folder(os.path.join(workdir, "model"), plans, [net.state_dict()],
                      "MultiTalent_trainer_ddp", fp16=True)
    os.makedirs(os.path.join(workdir, "in"))
    rng = np.random.default_rng(SEED)
    ct = (rng.standard_normal(CASE_SHAPE, dtype=np.float32) * 300).astype(np.int16)
    write_nifti(os.path.join(workdir, "in", "case_0000.nii.gz"), ct,
                Geometry(spacing=CASE_SPACING_ZYX[::-1]))


def phase_main_path(workdir: str, fused: bool = False) -> dict:
    """The predict CLI on the flagship case, unfused or (MTTPU_FUSED_NORM=1)
    fused; returns launch counts, seconds per case and the output folder."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti

    model = os.path.join(workdir, "model")
    if not os.path.isdir(model):
        _write_main_case(workdir)
    n_tiles, resampled = _case_tiles()
    route = "fused" if fused else "unfused"
    net = _flagship_net(_flagship_plans(), torch.bfloat16)
    per_forward = (net.fused_kernel_launches_per_forward() if fused
                   else net.kernel_launches_per_forward())
    out = os.path.join(workdir, f"out_{route}")
    os.environ["MTTPU_FUSED_NORM"] = "1" if fused else "0"
    try:
        t0 = time.perf_counter()
        timings, launches = _run_counted(lambda: main(
            ["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "--device", "cuda"]))
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MTTPU_FUSED_NORM")

    (case,) = timings
    forwards = case["forwards"]
    if forwards != n_tiles * 8:
        raise AssertionError(f"{forwards} forwards, expected {n_tiles} tiles x 8")
    expect = _expect(per_forward, forwards)
    if launches != expect or any(launches[k] == 0 for k in per_forward):
        raise AssertionError(f"{route} launches {launches}, expected {expect}")
    bodies = _wgmma_launched(route, ("conv3d_same_affine",) if fused
                             else ("conv3d_same", "conv3d_same_dual"))
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    if seg.shape != CASE_SHAPE or not set(np.unique(seg).tolist()) <= set(range(47)):
        raise AssertionError(f"labelmap {seg.shape} {np.unique(seg)[:5]}")
    fg = []
    for r in REGIONS:
        mask, _ = read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))
        if mask.shape != CASE_SHAPE or not set(np.unique(mask).tolist()) <= {0, 1}:
            raise AssertionError(f"region {r}: {mask.shape}")
        fg.append(float(mask.mean()))
    print(f"main path ({route}): case {CASE_SHAPE} at spacing {CASE_SPACING_ZYX} -> "
          f"resampled {tuple(resampled)}, {n_tiles} tiles x 8 mirror combos = {forwards} "
          f"forwards; labelmap + {len(fg)} region NIfTIs at {CASE_SHAPE}, foreground share "
          f"{min(fg):.3f}..{max(fg):.3f}")
    print(f"launches ({route}): { {k: v for k, v in launches.items() if v} } = per forward "
          f"{per_forward} x {forwards}")
    print(f"seconds per case ({route}): {wall:.2f} (predict {case['predict_s']:.2f}, "
          f"export {case['export_s']:.2f}; the rest loads the model and "
          f"preprocesses on the host)")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "forwards": forwards, "out": out, "launches_by_body": bodies}


def _wgmma_launched(route: str, required=("conv3d_same", "conv3d_same_dual")) -> dict:
    """Kernels A's, B's and D's launches by body in the run _run_counted just
    made (printed); each wrapper of `required` must have run the wgmma body
    (D: its dual form at 16-byte rows)."""
    bodies = {k: dict(v) for k, v in BODY_COUNTS.items()}
    if not all(bodies[k]["wgmma"] for k in required):
        raise AssertionError(f"{route}: the wgmma body was not launched: {bodies}")
    print(f"A/B/D launches by body ({route}): {bodies}")
    return bodies


def _mask_agreement(a: str, b: str, cases) -> tuple[float, float]:
    """Worst and mean share of equal voxels of the region masks
    (individual/<region>/<case>.nii.gz) of two output folders."""
    import numpy as np
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    agree = [float(np.mean(read_nifti(os.path.join(a, "individual", r, k + ".nii.gz"))[0]
                           == read_nifti(os.path.join(b, "individual", r, k + ".nii.gz"))[0]))
             for k in cases for r in REGIONS]
    return min(agree), float(np.mean(agree))


def compare_masks(unfused: dict, fused: dict) -> dict:
    """Every region mask of the fused predict CLI run against the unfused
    run's, on the same case and weights."""
    worst, mean = _mask_agreement(fused["out"], unfused["out"], ("case",))
    print(f"fused vs unfused predict CLI, region masks: worst region {worst:.6f} (bound "
          f"{MASK_AGREE_WORST}), mean {mean:.6f} (bound {MASK_AGREE_MEAN}); seconds per "
          f"case {fused['seconds_per_case']:.2f} fused vs {unfused['seconds_per_case']:.2f} "
          f"unfused (predict {fused['predict_s']:.2f} vs {unfused['predict_s']:.2f})")
    if not (worst >= MASK_AGREE_WORST and mean >= MASK_AGREE_MEAN):
        raise AssertionError(f"fused masks disagree: worst {worst}, mean {mean}")
    return {"worst": worst, "mean": mean}


@contextlib.contextmanager
def _env(**values: str):
    """The environment with `values` set inside, as it was after."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _liver_plans():
    """The Task003 Liver 3d_fullres plans (bench.py:382-383)."""
    from multitalent_tpu_torch.io import Plans
    return Plans.from_dict({
        "num_stages": 1, "num_modalities": 1, "modalities": {0: "CT"},
        "normalization_schemes": {0: "CT"}, "num_classes": LIVER_CLASSES - 1,
        "all_classes": list(range(1, LIVER_CLASSES)), "base_num_features": 32,
        "use_mask_for_norm": {0: False}, "transpose_forward": [0, 1, 2],
        "transpose_backward": [0, 1, 2], "data_identifier": "nnUNetData_plans_v2.1",
        "preprocessor_name": "GenericPreprocessor",
        "dataset_properties": {"intensityproperties": {0: {
            "percentile_00_5": -20.0, "percentile_99_5": 200.0, "mean": 100.0, "sd": 40.0}}},
        "plans_per_stage": {0: {
            "batch_size": 2, "patch_size": list(LIVER_PATCH),
            "current_spacing": list(LIVER_SPACING_ZYX),
            "original_spacing": list(LIVER_SPACING_ZYX),
            "median_patient_size_in_voxels": [432, 512, 512],
            "num_pool_per_axis": [5, 5, 5],
            "pool_op_kernel_sizes": [list(p) for p in LIVER_POOLS],
            "conv_kernel_sizes": [[3, 3, 3]] * (len(LIVER_POOLS) + 1)}}})


def _liver_case(rng):
    """A CT-like volume of LIVER_CASE_SHAPE (HU, int16) and its labels:
    air, a body, a liver (label 1) holding a lesion (label 2), mild noise."""
    import numpy as np
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32)
                            for s in LIVER_CASE_SHAPE], indexing="ij")
    ct = np.full(LIVER_CASE_SHAPE, -1000.0, np.float32)
    seg = np.zeros(LIVER_CASE_SHAPE, np.uint8)
    ct[(z / 0.95) ** 2 + (y / 0.8) ** 2 + (x / 0.9) ** 2 < 1] = 40.0
    c = rng.uniform(-0.15, 0.15, 3)
    liver = ((z - c[0]) / 0.5) ** 2 + ((y - c[1]) / 0.35) ** 2 + ((x - c[2] - 0.2) / 0.45) ** 2 < 1
    ct[liver], seg[liver] = 100.0, 1
    lesion = ((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2] - 0.25) ** 2) < 0.12 ** 2
    ct[lesion], seg[lesion] = 50.0, 2
    ct += rng.standard_normal(LIVER_CASE_SHAPE, dtype=np.float32) * 15
    return ct.astype(np.int16), seg


def _liver_tiles() -> tuple[int, list[int]]:
    """Tiles of a Liver case once resampled to the plans' spacing, and that
    shape."""
    import numpy as np
    from multitalent_tpu_torch.ops.sliding_window import compute_steps_for_sliding_window
    resampled = [int(round(s * sp / t)) for s, sp, t in
                 zip(LIVER_CASE_SHAPE, LIVER_CASE_SPACING_ZYX, LIVER_SPACING_ZYX)]
    n_tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        LIVER_PATCH, resampled, 0.5)]))
    return n_tiles, resampled


def _write_liver_task(workdir: str) -> tuple[str, object]:
    """A TrainerV2 model folder of the Liver plans with two folds of seeded
    random weights (the reference's He init), in RESULTS_FOLDER's layout,
    two synthetic cases under in/ and their labels under gt/. Returns the
    results folder and fold 0's network."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.inference.model_restore import save_model_folder
    from multitalent_tpu_torch.io import Geometry, write_nifti
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans

    plans = _liver_plans()
    nets = []
    for fold in range(2):
        torch.manual_seed(SEED + 10 + fold)
        net = build_unet_from_plans(plans, 0, num_classes=LIVER_CLASSES, dtype=torch.bfloat16)
        for m in net.modules():
            if isinstance(m, (torch.nn.Conv3d, torch.nn.ConvTranspose3d)):
                torch.nn.init.kaiming_normal_(m.weight, a=1e-2)
                if m.bias is not None:
                    torch.nn.init.zeros_(m.bias)
        nets.append(net)
    results = os.path.join(workdir, "liver_results")
    model = os.path.join(results, "nnUNet", "3d_fullres", LIVER_TASK,
                         "TrainerV2__MTTPUPlansv2.1")
    save_model_folder(model, plans, [n.state_dict() for n in nets], "TrainerV2", fp16=True)
    rng = np.random.default_rng(SEED + 10)
    for d in ("liver_in", "liver_gt"):
        os.makedirs(os.path.join(workdir, d))
    geometry = Geometry(spacing=LIVER_CASE_SPACING_ZYX[::-1])
    for case in LIVER_CASES:
        ct, seg = _liver_case(rng)
        write_nifti(os.path.join(workdir, "liver_in", f"{case}_0000.nii.gz"), ct, geometry)
        write_nifti(os.path.join(workdir, "liver_gt", f"{case}.nii.gz"), seg, geometry)
    return results, nets[0].to("cuda").eval()


def _forward_ms(forward, n: int) -> float:
    """Median ms of one no-grad forward of a (n, 1, *LIVER_PATCH) bf16 batch."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(n, 1, *LIVER_PATCH, generator=gen, device="cuda")
    with torch.no_grad():
        return _median_ms(lambda: forward(x), iters=5)


def phase_liver(workdir: str) -> dict:
    """The generic softmax inference path (`cli.predict`) at the Task003
    Liver 3d_fullres width: two folds, two cases, every mode, both routes,
    `-z` into two folders, `cli.ensemble` and `cli.evaluate`, then one
    forward's time at N=1 and N=4 on each route."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.ensemble import main as ensemble_main
    from multitalent_tpu_torch.cli.evaluate import main as evaluate_main
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    from multitalent_tpu_torch.ops.sliding_window import SlidingWindowPredictor

    results, net = _write_liver_task(workdir)
    n_tiles, resampled = _liver_tiles()
    per_call = {"unfused": net.kernel_launches_per_forward(),
                "fused": net.fused_kernel_launches_per_forward()}
    combos = 8
    runs = {}

    def run(label, route="unfused", exact=False, extra=(), folds=2):
        out = os.path.join(workdir, f"liver_{label}")
        args = ["-i", os.path.join(workdir, "liver_in"), "-o", out, "-t", LIVER_TASK,
                "-m", "3d_fullres", "-tr", "TrainerV2", "--device", "cuda", *extra]
        with _env(RESULTS_FOLDER=results, MTTPU_SW_EXACT="1" if exact else "0",
                  MTTPU_FUSED_NORM="1" if route == "fused" else "0"):
            t0 = time.perf_counter()
            timings, launches = _run_counted(lambda: predict_main(args))
            wall = time.perf_counter() - t0
        chunk = 1 if exact else LIVER_TTA_CHUNK
        calls_per_case = n_tiles * folds * -(-combos // chunk)
        if [t["case"] for t in timings] != list(LIVER_CASES):
            raise AssertionError(f"{label}: cases {[t['case'] for t in timings]}")
        for t in timings:
            if (t["forwards"], t["net_calls"], t["puts"]) != (
                    n_tiles * combos * folds, calls_per_case, 1):
                raise AssertionError(f"{label}: {t}, expected {n_tiles * combos * folds} "
                                     f"forwards in {calls_per_case} calls and one put")
        net_calls = sum(t["net_calls"] for t in timings)
        expect = _expect(per_call[route], net_calls)
        if launches != expect or any(launches[k] == 0 for k in per_call[route]):
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        segs = {}
        for case in LIVER_CASES:
            seg, _ = read_nifti(os.path.join(out, f"{case}.nii.gz"))
            if seg.shape != LIVER_CASE_SHAPE or not set(np.unique(seg).tolist()) <= {0, 1, 2}:
                raise AssertionError(f"{label} {case}: {seg.shape} {np.unique(seg)[:5]}")
            segs[case] = seg
        row = {"out": out, "segs": segs, "launches": launches, "net_calls": net_calls,
               "seconds_per_case": wall / len(LIVER_CASES),
               "predict_s": sum(t["predict_s"] for t in timings) / len(LIVER_CASES),
               "export_s": sum(t["export_s"] for t in timings) / len(LIVER_CASES)}
        print(f"Liver {label} ({route}, {'exact' if exact else 'default'} mode"
              f"{', ' + ' '.join(extra) if extra else ''}): {row['seconds_per_case']:.2f} s a "
              f"case (predict {row['predict_s']:.2f} s on the card's clock, export "
              f"{row['export_s']:.2f} s); {net_calls} network calls; launches "
              f"{ {k: v for k, v in launches.items() if v} }")
        runs[label] = row
        return row

    def agree(a, b):
        return [float(np.mean(runs[a]["segs"][c] == runs[b]["segs"][c])) for c in LIVER_CASES]

    print(f"Liver cases {LIVER_CASE_SHAPE} at spacing {LIVER_CASE_SPACING_ZYX} -> resampled "
          f"{tuple(resampled)}, {n_tiles} tiles x {combos} mirror combos x 2 folds")
    run("normal")
    run("fused", route="fused")
    run("exact", exact=True)
    run("fast", extra=("--mode", "fast"))
    run("fastest", extra=("--mode", "fastest"))
    run("z0", extra=("-z", "-f", "0"), folds=1)
    run("z1", extra=("-z", "-f", "1"), folds=1)
    ens = os.path.join(workdir, "liver_ensemble")
    ensemble_main(["-f", runs["z0"]["out"], runs["z1"]["out"], "-o", ens])
    runs["ensemble"] = {"segs": {c: read_nifti(os.path.join(ens, f"{c}.nii.gz"))[0]
                                 for c in LIVER_CASES}}
    summary = evaluate_main(["-ref", os.path.join(workdir, "liver_gt"),
                             "-pred", runs["normal"]["out"], "-l", "1", "2"])
    dice = {label: summary["mean"][str(label)]["Dice"] for label in (1, 2)}
    if len(summary["all"]) != len(LIVER_CASES) or not all(
            0.0 <= d <= 1.0 for d in dice.values()):
        raise AssertionError(f"evaluate: {len(summary['all'])} cases, Dice {dice}")

    # the voxels where the clamp decides the default mode's blend, on the
    # network's grid, taken back to the case's grid by the nearest voxel
    # (the cases are not cropped)
    share = SlidingWindowPredictor(LIVER_PATCH, 1, LIVER_CLASSES, device="cpu",
                                   exact=False).clamp_share(resampled)
    idx = [np.floor((np.arange(n) + 0.5) * (m / n)).astype(int)
           for m, n in zip(share.shape, LIVER_CASE_SHAPE)]
    decided = (share > LIVER_CLAMP_LIMIT)[np.ix_(*idx)]
    same = [runs["normal"]["segs"][c] == runs["exact"]["segs"][c] for c in LIVER_CASES]
    exact_agree = [float(s[~decided].mean()) for s in same]
    fused_agree = agree("fused", "normal")
    readings = {"default_vs_exact": [float(s.mean()) for s in same],
                "default_vs_exact_unclamped": exact_agree,
                "default_vs_exact_clamped": [float(s[decided].mean()) for s in same],
                "fastest_vs_fast": agree("fastest", "fast"),
                "fused_vs_unfused": fused_agree, "ensemble_vs_normal": agree("ensemble", "normal")}
    print("Liver labelmap agreement: " + "; ".join(
        f"{k} {', '.join(f'{v:.6f}' for v in vals)}" for k, vals in readings.items())
          + f"; {decided.mean():.4f} of the voxels clamp-decided (the clamp adds more than "
            f"{LIVER_CLAMP_LIMIT} of the blend weight); Dice of the random model vs the "
            f"phantom's labels {dice}")
    if min(exact_agree) < LIVER_EXACT_AGREE:
        raise AssertionError(f"default vs exact labelmaps where the clamp does not decide the "
                             f"blend: {exact_agree} < {LIVER_EXACT_AGREE}")
    if not all(np.array_equal(runs["normal"]["segs"][c], runs["fast"]["segs"][c])
               for c in LIVER_CASES):
        raise AssertionError("normal and fast labelmaps differ")
    if not (min(fused_agree) >= MASK_AGREE_WORST and np.mean(fused_agree) >= MASK_AGREE_MEAN):
        raise AssertionError(f"fused vs unfused labelmaps: {fused_agree}")
    if min(readings["ensemble_vs_normal"]) < MASK_AGREE_WORST:
        raise AssertionError(f"ensemble vs normal labelmaps: {readings['ensemble_vs_normal']}")

    fused_net = lambda x: unet_forward_fused(net, x)
    forward = {f"{route}_n{n}_ms": _forward_ms(fn, n)
               for route, fn in (("unfused", net), ("fused", fused_net)) for n in (1, 4)}
    print(f"Liver forward at {'x'.join(map(str, LIVER_PATCH))}: " + ", ".join(
        f"{route} N=1 {forward[f'{route}_n1_ms']:.2f} ms, N=4 {forward[f'{route}_n4_ms']:.2f} "
        f"ms ({forward[f'{route}_n4_ms'] / 4:.2f} ms a combo)" for route in ("unfused", "fused")))
    del net
    torch.cuda.empty_cache()
    return {"runs": {k: {kk: vv for kk, vv in v.items() if kk != "segs"}
                     for k, v in runs.items()},
            "agreement": readings, "clamp_decided": float(decided.mean()), "dice": dice,
            "forward": forward, "n_tiles": n_tiles}

def phase_tile_probabilities() -> dict:
    """One tile's sigmoid probabilities through the kernels in bf16, against
    the plain versions at the same bf16 rounding points (only summation order
    differs) and against the plain versions in fp32 (bf16 rounding too)."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _flagship_plans()
    dev = torch.device("cuda")
    net = _flagship_net(plans, torch.bfloat16).to(dev).eval()
    net32 = _flagship_net(plans, torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with torch.no_grad(), _recording("conv3d_same") as a_shapes, \
            _recording("conv3d_same_dual") as b_shapes:
        logits = net(x)
    with torch.no_grad():
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        p_kernels = torch.sigmoid(logits)
        d_bf16 = (p_kernels - torch.sigmoid(net(x, use_kernels=False))).abs()
        d_fp32 = (p_kernels - torch.sigmoid(net32(x, use_kernels=False))).abs()
    out = {"bf16_max": d_bf16.max().item(), "bf16_mean": d_bf16.mean().item(),
           "fp32_max": d_fp32.max().item(), "fp32_mean": d_fp32.mean().item(),
           "a_shapes": a_shapes, "b_shapes": b_shapes}
    print(f"tile {PATCH}: |dp| kernels bf16 vs plain bf16: max {out['bf16_max']:.3e} "
          f"(bound {PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{PROB_BOUND_MEAN}); vs plain fp32: max {out['fp32_max']:.3e} "
          f"(bound {PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} "
          f"(bound {PROB_BOUND_FP32_MEAN})")
    if not (out["bf16_max"] <= PROB_BOUND and out["bf16_mean"] <= PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN):
        raise AssertionError(f"probabilities out of bounds: {out}")
    expect = net.kernel_launches_per_forward()["conv3d_same"]
    if sum(a_shapes.values()) != expect:
        raise AssertionError(f"{sum(a_shapes.values())} kernel-A calls in one forward, "
                             f"expected {expect}")
    expect = net.kernel_launches_per_forward()["conv3d_same_dual"]
    if sum(b_shapes.values()) != expect:
        raise AssertionError(f"{sum(b_shapes.values())} kernel-B calls in one forward, "
                             f"expected {expect}")
    return out


@contextlib.contextmanager
def _slope(net, slope: float):
    """Every LeakyReLU slope of `net` (each module's `negative_slope`) set to
    `slope` (a faulty activation for the controls of phases 4b and 8c),
    restored after."""
    blocks = [m for m in net.modules() if hasattr(m, "negative_slope")]
    old = [b.negative_slope for b in blocks]
    for b in blocks:
        b.negative_slope = slope
    try:
        yield
    finally:
        for b, v in zip(blocks, old):
            b.negative_slope = v


def _dp(p, q) -> tuple[float, float]:
    d = (p - q).abs()
    return d.max().item(), d.mean().item()


def phase_fused_tile_probabilities() -> dict:
    """One tile through the fused forward in bf16 against its plain versions
    at the same rounding points and against the unfused plain fp32 forward;
    then the plain forward with MTTPU_PALLAS_NORM=1 (every norm on kernel E,
    no grad) against the default; each route's bounds against controls with
    a faulty activation; and one forward's time on each route."""
    import torch
    from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops.fused_unet import unet_forward_fused
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _flagship_plans()
    dev = torch.device("cuda")
    net = _flagship_net(plans, torch.bfloat16).to(dev).eval()
    net32 = _flagship_net(plans, torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_shapes, \
            _recording_x(fn, "channel_stats") as e_shapes:
        logits = unet_forward_fused(net, x)
    per_forward = net.fused_kernel_launches_per_forward()
    d_bodies = _check_d_bodies(d_shapes, "one fused tile forward")
    for label, shapes, expect in (("kernel-D", d_shapes, per_forward["conv3d_same_affine"]),
                                  ("kernel-E stats", e_shapes, per_forward["channel_stats"])):
        if sum(shapes.values()) != expect:
            raise AssertionError(f"{sum(shapes.values())} {label} calls in one fused forward, "
                                 f"expected {expect}")
    if logits.dtype != torch.bfloat16 or logits.shape != (1, 47, *PATCH):
        raise AssertionError(f"fused logits {logits.dtype} {tuple(logits.shape)}")
    if not torch.isfinite(logits).all():
        raise AssertionError("non-finite fused logits")
    p_fused = torch.sigmoid(logits.float())
    p_fused_plain = torch.sigmoid(unet_forward_fused(net, x, use_kernels=False).float())
    with torch.no_grad():
        p_fp32 = torch.sigmoid(net32(x, use_kernels=False))
        p_default = torch.sigmoid(net(x))
    norms = sum(1 for m in net.modules() if isinstance(m, ConvDropoutNormNonlin))

    def pallas_norm_forward():
        os.environ["MTTPU_PALLAS_NORM"] = "1"
        try:
            with torch.no_grad():
                return torch.sigmoid(net(x))
        finally:
            os.environ.pop("MTTPU_PALLAS_NORM")

    p_pallas, launches = _run_counted(pallas_norm_forward)
    if launches["channel_stats"] != norms or launches["affine_lrelu"] != norms:
        raise AssertionError(f"MTTPU_PALLAS_NORM=1: launches {launches}, {norms} norms")
    out = {"d_shapes": d_shapes, "e_shapes": e_shapes, "d_launches_by_body": d_bodies}
    out["bf16_max"], out["bf16_mean"] = _dp(p_fused, p_fused_plain)
    out["fp32_max"], out["fp32_mean"] = _dp(p_fused, p_fp32)
    out["pallas_norm_max"], out["pallas_norm_mean"] = _dp(p_pallas, p_default)
    del p_fused, p_fp32, p_pallas
    controls = []
    for slope in CONTROL_SLOPES:
        with _slope(net, slope):
            fused = _dp(torch.sigmoid(unet_forward_fused(net, x).float()), p_fused_plain)
            pallas = _dp(pallas_norm_forward(), p_default)
        controls.append({"slope": slope, "fused": fused, "pallas_norm": pallas})
    out["controls"] = controls
    del p_fused_plain, p_default
    print(f"tile {PATCH}, fused route: |dp| kernels bf16 vs plain bf16: max "
          f"{out['bf16_max']:.3e} (bound {FUSED_PROB_BOUND}), mean {out['bf16_mean']:.3e} "
          f"(bound {FUSED_PROB_BOUND_MEAN}); vs unfused plain fp32: max "
          f"{out['fp32_max']:.3e} (bound {PROB_BOUND_FP32_MAX}), mean "
          f"{out['fp32_mean']:.3e} (bound {PROB_BOUND_FP32_MEAN})")
    print(f"tile {PATCH}, MTTPU_PALLAS_NORM=1 ({norms} norms on kernel E) vs the default "
          f"norm: |dp| max {out['pallas_norm_max']:.3e} (bound {PALLAS_NORM_BOUND}), mean "
          f"{out['pallas_norm_mean']:.3e} (bound {PALLAS_NORM_BOUND_MEAN})")
    for c in controls:
        print(f"control, LeakyReLU slope {c['slope']} for 1e-2 through the same kernels: "
              f"fused route |dp| max {c['fused'][0]:.3e}, mean {c['fused'][1]:.3e}; "
              f"MTTPU_PALLAS_NORM=1 |dp| max {c['pallas_norm'][0]:.3e}, mean "
              f"{c['pallas_norm'][1]:.3e}")
    if not (out["bf16_max"] <= FUSED_PROB_BOUND and out["bf16_mean"] <= FUSED_PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN
            and out["pallas_norm_max"] <= PALLAS_NORM_BOUND
            and out["pallas_norm_mean"] <= PALLAS_NORM_BOUND_MEAN):
        raise AssertionError(f"fused probabilities out of bounds: {out}")
    for c in controls:
        (f_max, f_mean), (p_max, p_mean) = c["fused"], c["pallas_norm"]
        if not ((f_max > FUSED_PROB_BOUND or f_mean > FUSED_PROB_BOUND_MEAN)
                and (p_max > PALLAS_NORM_BOUND or p_mean > PALLAS_NORM_BOUND_MEAN)):
            raise AssertionError(f"the bounds pass a faulty activation: {c}")
    with torch.no_grad():
        out["unfused_forward_ms"] = _median_ms(lambda: net(x), iters=5)
        out["fused_forward_ms"] = _median_ms(lambda: unet_forward_fused(net, x), iters=5)
    print(f"one bf16 forward of a tile: fused {out['fused_forward_ms']:.2f} ms, unfused "
          f"{out['unfused_forward_ms']:.2f} ms (median of 5, CUDA events)")
    return out


def _export_properties(shape) -> tuple[dict, tuple]:
    """The export properties of a preprocessed case of `shape` at the plans'
    spacing whose original grid is at CASE_SPACING_ZYX, cropped CROP_MARGIN
    inside its volume; and the original volume's shape."""
    import numpy as np
    after = tuple(int(round(s * t / o)) for s, t, o in zip(shape, SPACING_ZYX, CASE_SPACING_ZYX))
    original = tuple(a + 2 * m for a, m in zip(after, CROP_MARGIN))
    return {"original_spacing": np.array(CASE_SPACING_ZYX),
            "spacing_after_resampling": np.array(SPACING_ZYX),
            "size_after_cropping": after,
            "crop_bbox": [[m, m + a] for m, a in zip(CROP_MARGIN, after)],
            "original_size_of_raw_data": np.array(original),
            "itk_spacing": CASE_SPACING_ZYX[::-1], "itk_origin": (0.0, 0.0, 0.0),
            "itk_direction": (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)}, original


def _write_gt(path: str, seg, props: dict) -> None:
    """The ground truth of a case: its labels resized nearest to the cropped
    grid and put back into the original volume."""
    import numpy as np
    from multitalent_tpu_torch.io import Geometry, write_nifti
    after = props["size_after_cropping"]
    idx = [np.minimum((np.arange(a) * s) // a, s - 1) for a, s in zip(after, seg.shape)]
    gt = np.zeros(tuple(int(v) for v in props["original_size_of_raw_data"]), np.uint8)
    gt[tuple(slice(lo, hi) for lo, hi in props["crop_bbox"])] = seg[np.ix_(*idx)]
    write_nifti(path, gt, Geometry(spacing=CASE_SPACING_ZYX[::-1]))


def _write_training_task(root: str, plans) -> tuple[str, str]:
    """A preprocessed MultiTalent task of two source datasets: smooth
    z-scored CT-like volumes with a liver (+ tumour) in the Task003 cases and
    a spleen in the Task009 cases, labels in the global 1..47 space and each
    case's valid regions and export properties stamped, as Task100's
    preprocessing leaves them, and gt_segmentations/. The split trains on all
    four cases and validates on VAL_KEYS, one a dataset."""
    import numpy as np
    from multitalent_tpu_torch.io import save_plans
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.preprocessing.preprocessor import sample_class_locations
    from multitalent_tpu_torch.utils.fileops import save_pickle
    task = "Task100_MultiTalent"
    ddir = os.path.join(root, "preprocessed", task)
    folder = os.path.join(ddir, plans.data_identifier + "_stage0")
    os.makedirs(folder)
    os.makedirs(os.path.join(ddir, "gt_segmentations"))
    rng = np.random.default_rng(SEED)
    cases = [("003", ("03_liver", "03_cancer"), (1, 2))] * 2 + [("009", ("09_spleen",), (8,))] * 2
    keys = []
    for i, (prefix, regions, labels) in enumerate(cases):
        key = f"{prefix}_{i:03d}"
        shape = VAL_CASE_SHAPE if key in VAL_KEYS else TRAIN_CASE_SHAPE
        axes = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in shape],
                           indexing="ij")
        data = np.where(sum(a * a for a in axes) < 0.8, 0.5, -1.5).astype(np.float32)
        seg = np.zeros(shape, np.float32)
        for label in labels:
            c = rng.uniform(-0.4, 0.4, 3)
            r = rng.uniform(0.1, 0.3, 3)
            inside = sum(((a - ci) / ri) ** 2 for a, ci, ri in zip(axes, c, r)) < 1
            seg[inside] = label
            data[inside] = rng.uniform(-1, 2)
        data += rng.standard_normal(shape, dtype=np.float32) * 0.1
        np.savez(os.path.join(folder, key + ".npz"), data=np.stack([data, seg]))
        props, _ = _export_properties(shape)
        save_pickle({"class_locations": sample_class_locations(seg, list(labels)),
                     "valid_regions": regions, "valid_labels": list(labels), **props},
                    os.path.join(folder, key + ".pkl"))
        _write_gt(os.path.join(ddir, "gt_segmentations", key + ".nii.gz"), seg, props)
        keys.append(key)
    save_plans(plans, os.path.join(ddir, f"{default_plans_identifier}_plans_3D.pkl"))
    save_pickle([{"train": keys, "val": list(VAL_KEYS)}] * 12,
                os.path.join(ddir, "splits_custom.pkl"))
    return task, ddir


def _validation_forwards() -> int:
    """Network calls of validating VAL_KEYS: tiles x 8 mirror combinations."""
    import numpy as np
    from multitalent_tpu_torch.ops.sliding_window import compute_steps_for_sliding_window
    tiles = int(np.prod([len(s) for s in compute_steps_for_sliding_window(
        PATCH, VAL_CASE_SHAPE, 0.5)]))
    return tiles * 8 * len(VAL_KEYS)


def _check_validation(folder: str, trainer) -> dict:
    """A MultiTalent validation folder: per case the labelmap of its
    dataset's labels and all 47 region masks at the original shape, and a
    finite Dice of every valid label in summary_<task>.json."""
    import numpy as np
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.utils.fileops import load_json
    _, original = _export_properties(VAL_CASE_SHAPE)
    for key, allowed in zip(VAL_KEYS, ({0, 1, 2}, {0, 8})):
        seg, _ = read_nifti(os.path.join(folder, key + ".nii.gz"))
        if seg.shape != original or not set(np.unique(seg).tolist()) <= allowed:
            raise AssertionError(f"{folder}: labelmap of {key} {seg.shape} "
                                 f"{np.unique(seg)[:5]}")
        for r in REGIONS:
            mask, _ = read_nifti(os.path.join(folder, "individual", r, key + ".nii.gz"))
            if mask.shape != original or not set(np.unique(mask).tolist()) <= {0, 1}:
                raise AssertionError(f"{folder}: region {r} of {key}: {mask.shape}")
    dice = {}
    for task, labels in (("Task003_Liver", ("1", "2")), ("Task009_Spleen", ("8",))):
        mean = load_json(os.path.join(folder, f"summary_{task}.json"))["results"]["mean"]
        dice.update({label: mean[label]["Dice"] for label in labels})
    if not all(np.isfinite(v) for v in dice.values()):
        raise AssertionError(f"{folder}: Dice {dice}")
    forwards = sum(t["forwards"] for t in trainer.validation_timings)
    if forwards != _validation_forwards():
        raise AssertionError(f"{forwards} validation forwards, expected "
                             f"{_validation_forwards()}")
    return {"dice": dice, "forwards": forwards,
            "seconds_per_case": trainer.validation_seconds / len(VAL_KEYS),
            "predict_s": [round(t["predict_s"], 3) for t in trainer.validation_timings]}


def _check_dw_through_kernels(trainer) -> float:
    """One training step's dw of every kernel conv, through kernel C, against
    the plain version on the same bf16 inputs (captured from the step), on the
    trainer's forward route."""
    import torch
    from multitalent_tpu_torch.ops import conv3d as cv
    torch.backends.cudnn.allow_tf32 = False  # the plain version in fp32, not TF32
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    data = torch.randn(TRAIN_BATCH, 1, *PATCH, generator=gen, device=dev)
    targets = [torch.randint(0, 48, (TRAIN_BATCH, *(int(round(p * f)) for p, f in
                                                     zip(PATCH, scale))),
                             generator=gen, device=dev).float()
               for scale in trainer.deep_supervision_scales]
    valid = torch.ones(TRAIN_BATCH, 47, device=dev)
    calls = []
    single, dual = cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual

    def rec_single(x, g):
        dw = single(x, g)
        calls.append(((x,), g, dw))
        return dw

    def rec_dual(a, b, g):
        dw = dual(a, b, g)
        calls.append(((a, b), g, dw))
        return dw

    # the wrappers count launches on the module's conv3d_same_wgrad, which is
    # the recorder for this one step; the main path's counts were read already
    rec_single.launches = 0
    cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual = rec_single, rec_dual
    try:
        with _recording("conv3d_same") as a_shapes, \
                _recording("conv3d_same_dual") as b_shapes, \
                _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_shapes:
            trainer.network.zero_grad()
            loss, _ = trainer.loss_fn(trainer.network_forward(data, deep_supervision=True),
                                      targets, {"valid_region_mask": valid})
            loss.backward()
    finally:
        cv.conv3d_same_wgrad, cv.conv3d_same_wgrad_dual = single, dual
    expect = trainer.network.kernel_launches_per_step()["conv3d_same_wgrad"]
    if len(calls) != expect:
        raise AssertionError(f"{len(calls)} dw calls in one backward, expected {expect}")
    worst = 0.0
    for ins, g, dw in calls:
        plain = cv.conv3d_same_wgrad_dual_ref if len(ins) == 2 else cv.conv3d_same_wgrad_ref
        ref = plain(*(t.float() for t in ins), g.float())
        scale = ref.abs().max().item()
        err = _check(f"step dw {tuple(dw.shape)}", dw, ref, DW_RTOL * scale + 1e-12)
        worst = max(worst, err / max(scale, 1e-30))
    print(f"one step's dw of all {len(calls)} kernel convs through kernel C vs the plain "
          f"version on the same bf16 inputs: worst max|d| / max|dw| {worst:.2e} "
          f"(bound {DW_RTOL})")
    shapes = collections.Counter(_dw_key(ins, g) for ins, g, _ in calls)
    return worst, shapes, a_shapes, b_shapes, d_shapes


def _dw_key(ins, g) -> tuple:
    """(input channels, Cout, spatial, N) of one kernel C call."""
    return (tuple(int(t.shape[-1]) for t in ins), int(g.shape[-1]),
            tuple(int(s) for s in g.shape[1:4]), int(g.shape[0]))


def phase_training(workdir: str, fused: bool = False) -> dict:
    """The train CLI at full flagship width, unfused or fused
    (MTTPU_FUSED_TRAIN=1, and MTTPU_FUSED_NORM=1 for its validation), with
    the validation after training, then a prediction from the folder it
    wrote."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.training.trainers import init_weights_he

    plans = _flagship_plans()
    route = "fused" if fused else "unfused"
    t0 = time.perf_counter()
    task = "Task100_MultiTalent"
    if not os.path.isdir(os.path.join(workdir, "preprocessed", task)):
        task, _ = _write_training_task(workdir, plans)
    write_s = time.perf_counter() - t0
    results = os.path.join(workdir, f"results_{route}")
    os.environ.update({"nnUNet_preprocessed": os.path.join(workdir, "preprocessed"),
                       "RESULTS_FOLDER": results,
                       "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": str(TRAIN_STEPS),
                       "MTTPU_VAL_ITERS": "1", "MTTPU_FUSED_TRAIN": "1" if fused else "0",
                       "MTTPU_FUSED_NORM": "1" if fused else "0"})
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", "MultiTalent_trainer_ddp", task, "0", "--device", "cuda",
             "-gpus", "1"]))
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

        net = trainer.network
        if fused:
            per_step = net.fused_kernel_launches_per_step()
            per_fwd = net.fused_kernel_launches_per_forward(differentiable=True)
            per_val = net.fused_kernel_launches_per_forward()
        else:
            per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
            per_val = per_fwd
        fold = trainer.output_folder
        validation = _check_validation(os.path.join(fold, "validation_raw"), trainer)
        steps, val = trainer.step, trainer.num_val_batches_per_epoch
        expect = {k: a + b + c for (k, a), b, c in zip(
            _expect(per_step, steps).items(), _expect(per_fwd, val).values(),
            _expect(per_val, validation["forwards"]).values())}
        if (steps != TRAIN_STEPS or launches != expect
                or any(launches[k] == 0 for k in (*per_step, *per_val))):
            raise AssertionError(f"{route}: {steps} steps, launches {launches}, "
                                 f"expected {expect}")
        bodies = _wgmma_launched(f"training, {route}", ("conv3d_same", "conv3d_same_affine")
                                 if fused else ("conv3d_same", "conv3d_same_dual"))
        losses = trainer.all_tr_losses + trainer.all_val_losses + trainer.all_tr_ce
        if not np.isfinite(losses).all():
            raise AssertionError(f"non-finite losses {losses}")
        fresh = build_unet_from_plans(plans, 0, num_classes=47)
        init_weights_he(fresh, torch.Generator().manual_seed(trainer.seed))
        still = _unmoved(net, fresh, keep=("seg_outputs.0.weight",))
        if still:
            raise AssertionError(f"weights that did not move: {still}")
        step_s = sorted(trainer.step_seconds[2:])
        median_s = step_s[len(step_s) // 2] if len(step_s) % 2 else (
            step_s[len(step_s) // 2 - 1] + step_s[len(step_s) // 2]) / 2
        print(f"training ({route}): {steps} steps of batch {TRAIN_BATCH} at {PATCH}, bf16, "
              f"DS, host patch "
              f"{tuple(int(v) for v in trainer.basic_generator_patch_size)}; losses "
              f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
              f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
        print(f"seconds per step ({route}): median {median_s:.3f} of steps 3..{steps} "
              f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
              f"{peak_gib:.2f} GiB; cases written in {write_s:.1f} s; train CLI "
              f"{train_s:.1f} s")
        print(f"training launches ({route}): { {k: v for k, v in launches.items() if v} } "
              f"= per step {per_step} x {steps} + per forward {per_fwd} x {val} "
              f"(validation batches) + per forward {per_val} x {validation['forwards']} "
              f"(validation of {len(VAL_KEYS)} cases of {VAL_CASE_SHAPE}, 8 tiles x 8 "
              f"mirror combinations each)")
        print(f"validation ({route}): {validation['seconds_per_case']:.2f} s per case "
              f"(predict {validation['predict_s']} s); labelmap + 47 region NIfTIs per case "
              f"at {_export_properties(VAL_CASE_SHAPE)[1]}; Dice "
              f"{ {k: round(v, 4) for k, v in validation['dice'].items()} }")
        dw_worst, dw_shapes, a_shapes, b_shapes, d_shapes = _check_dw_through_kernels(trainer)
        step_bodies = {k: RECORDED_BODIES[k] for k in ("conv3d_same", "conv3d_same_dual")}
        print(f"A/B launches by body in one step ({route}): {step_bodies}")
        if not fused and sum(a_shapes.values()) != per_step["conv3d_same"]:
            raise AssertionError(f"{sum(a_shapes.values())} kernel-A calls in one step, "
                                 f"expected {per_step['conv3d_same']}")
        if not fused and sum(b_shapes.values()) != per_step["conv3d_same_dual"]:
            raise AssertionError(f"{sum(b_shapes.values())} kernel-B calls in one step, "
                                 f"expected {per_step['conv3d_same_dual']}")
        if fused and sum(d_shapes.values()) != per_step["conv3d_same_affine"]:
            raise AssertionError(f"{sum(d_shapes.values())} kernel-D calls in one step, "
                                 f"expected {per_step['conv3d_same_affine']}")
        if fused:
            step_bodies["conv3d_same_affine"] = _check_d_bodies(d_shapes,
                                                                f"one step ({route})")
    finally:
        os.environ.pop("MTTPU_FUSED_TRAIN")
        os.environ.pop("MTTPU_FUSED_NORM")

    model = os.path.join(results, "nnUNet", "3d_fullres", task,
                         f"MultiTalent_trainer_ddp__{default_plans_identifier}")
    out = os.path.join(workdir, f"out_trained_{route}")
    predict_main(["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
                  "--device", "cuda", "--disable_tta"])
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    masks = [read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))[0].shape
             for r in REGIONS]
    if seg.shape != CASE_SHAPE or set(masks) != {CASE_SHAPE}:
        raise AssertionError(f"trained folder predicted {seg.shape}, masks {set(masks)}")
    print(f"the trained folder ({route}) predicts: labelmap + {len(masks)} region NIfTIs "
          f"at {CASE_SHAPE}")
    return {"launches": launches, "seconds_per_step": median_s, "peak_gib": peak_gib,
            "dw_worst_rel": dw_worst, "dw_shapes": dw_shapes, "a_shapes": a_shapes,
            "b_shapes": b_shapes, "d_shapes": d_shapes, "validation": validation,
            "fold": fold, "predicted": out, "task": task, "launches_by_body": bodies,
            "step_launches_by_body": step_bodies}


def phase_fused_validation(workdir: str, training: dict) -> dict:
    """The train CLI's -val on phase 5's folder with MTTPU_FUSED_NORM=1
    (kernels D, E and F): exact launch counts, every region mask against
    phase 5's validation."""
    from multitalent_tpu_torch.cli.train import main as train_main
    os.environ.update({"RESULTS_FOLDER": os.path.join(workdir, "results_unfused"),
                       "MTTPU_FUSED_NORM": "1"})
    try:
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", "MultiTalent_trainer_ddp", training["task"], "0", "-val",
             "--val_folder", "validation_fused", "--device", "cuda", "-gpus", "1"]))
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("MTTPU_FUSED_NORM")
    validation = _check_validation(os.path.join(training["fold"], "validation_fused"), trainer)
    per = trainer.network.fused_kernel_launches_per_forward()
    expect = _expect(per, validation["forwards"])
    if launches != expect or any(launches[k] == 0 for k in per):
        raise AssertionError(f"fused -val launches {launches}, expected {expect}")
    worst, mean = _mask_agreement(os.path.join(training["fold"], "validation_fused"),
                                  os.path.join(training["fold"], "validation_raw"), VAL_KEYS)
    print(f"fused -val: launches { {k: v for k, v in launches.items() if v} } = per forward "
          f"{per} x {validation['forwards']}; {validation['seconds_per_case']:.2f} s per case "
          f"(predict {validation['predict_s']} s), CLI {wall:.1f} s; region masks vs the "
          f"unfused validation: worst {worst:.6f} (bound {MASK_AGREE_WORST}), mean {mean:.6f} "
          f"(bound {MASK_AGREE_MEAN}); Dice "
          f"{ {k: round(v, 4) for k, v in validation['dice'].items()} }")
    if not (worst >= MASK_AGREE_WORST and mean >= MASK_AGREE_MEAN):
        raise AssertionError(f"fused validation masks disagree: worst {worst}, mean {mean}")
    return {"launches": launches, "validation": validation, "worst": worst, "mean": mean}


def phase_jax_folder(workdir: str, training: dict) -> dict:
    """Phase 5's trained weights as a JAX-layout folder (fold_0/*.ckpt flax
    msgpack through io/flax_ckpt.dumps and the inverse bridge, with its
    sidecar): restored on the card with the weights bit-equal, then
    predict_multitalent from it must write the masks and labelmap it wrote
    from the `.model` folder of the same weights, bit for bit."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               save_jax_model_folder)
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    plans = _flagship_plans()
    sd = torch.load(os.path.join(training["fold"], "model_final_checkpoint.model"),
                    map_location="cpu", weights_only=False)["state_dict"]
    model = os.path.join(workdir, "jax_model")
    t0 = time.perf_counter()
    save_jax_model_folder(model, plans, [sd], "MultiTalentTrainer",
                          trainer_bases=["TrainerV2", "NetworkTrainerBase"])
    write_s = time.perf_counter() - t0
    ckpt = os.path.join(model, "fold_0", "model_final_checkpoint.ckpt")
    t0 = time.perf_counter()
    restored = load_model_and_checkpoint_files(model, [0], device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = restored.networks[0].state_dict()
    if not all(torch.equal(v.cpu(), sd[k]) for k, v in got.items()):
        raise AssertionError("weights restored from the .ckpt folder differ")
    per = restored.networks[0].kernel_launches_per_forward()
    del restored, got
    out = os.path.join(workdir, "out_jax_folder")
    timings, launches = _run_counted(lambda: predict_main(
        ["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
         "--device", "cuda", "--disable_tta"]))
    n_tiles, _ = _case_tiles()
    expect = _expect(per, n_tiles)
    if timings[0]["forwards"] != n_tiles or launches != expect:
        raise AssertionError(f"JAX-layout predict launches {launches}, expected {expect}")
    for rel in ["case.nii.gz"] + [os.path.join("individual", r, "case.nii.gz") for r in REGIONS]:
        a, _ = read_nifti(os.path.join(out, rel))
        b, _ = read_nifti(os.path.join(training["predicted"], rel))
        if not np.array_equal(a, b):
            raise AssertionError(f"{rel} from the .ckpt folder differs from the .model folder's")
    print(f"JAX-layout folder: {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB .ckpt written in "
          f"{write_s:.2f} s, restored on the card in {restore_s:.2f} s; predict_multitalent "
          f"from it: labelmap + {len(REGIONS)} region masks bit-equal to the .model folder's; "
          f"launches { {k: v for k, v in launches.items() if v} } = per forward {per} x "
          f"{n_tiles}")
    return {"ckpt": ckpt, "restore_s": restore_s, "write_s": write_s, "launches": launches}


def _write_finetune_task(root: str, plans) -> tuple[str, object]:
    """A downstream task of one class for fine-tuning: the Task009 cases of
    the MultiTalent task, spleen 8 -> 1, with their ground truth; its plans
    the flagship's with one class; train on both, validate on one."""
    import numpy as np
    from multitalent_tpu_torch.io import Plans, read_nifti, save_plans, write_nifti
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.utils.fileops import load_pickle, save_pickle
    task = "Task009_Spleen"
    src = os.path.join(root, "preprocessed", "Task100_MultiTalent")
    ddir = os.path.join(root, "preprocessed", task)
    folder = os.path.join(ddir, plans.data_identifier + "_stage0")
    os.makedirs(folder)
    os.makedirs(os.path.join(ddir, "gt_segmentations"))
    keys = ["009_002", "009_003"]
    for key in keys:
        data = np.load(os.path.join(src, plans.data_identifier + "_stage0", key + ".npz"))["data"]
        data[-1][data[-1] == 8] = 1
        np.savez(os.path.join(folder, key + ".npz"), data=data)
        props = load_pickle(os.path.join(src, plans.data_identifier + "_stage0", key + ".pkl"))
        props["class_locations"] = {1: props["class_locations"][8]}
        save_pickle(props, os.path.join(folder, key + ".pkl"))
        gt, geom = read_nifti(os.path.join(src, "gt_segmentations", key + ".nii.gz"))
        write_nifti(os.path.join(ddir, "gt_segmentations", key + ".nii.gz"),
                    (gt == 8).astype(np.uint8), geom)
    one = Plans.from_dict({**plans.to_dict(), "num_classes": 1, "all_classes": [1]})
    save_plans(one, os.path.join(ddir, f"{default_plans_identifier}_plans_3D.pkl"))
    save_pickle([{"train": keys, "val": ["009_003"]}] * 5, os.path.join(ddir, "splits_final.pkl"))
    return task, one


def phase_warmup(workdir: str, jax_folder: dict) -> dict:
    """nnUNetTrainerV2_warmupsegheads -pretrained_weights <phase 5's weights
    as the JAX .ckpt>, 2 steps of the head warm-up (AdamW on the heads only)
    on a one-class downstream task, then its validation: the backbone loads
    equal to the pretrained weights and stays bit-unchanged, the heads move,
    and no backward runs through the backbone (kernel C: 0 launches; A and B
    launch only in forwards)."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.model_restore import checkpoint_state_dict
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.training.trainers import init_weights_he
    plans = _flagship_plans()
    task, one = _write_finetune_task(workdir, plans)
    os.environ.update({"RESULTS_FOLDER": os.path.join(workdir, "results_warmup"),
                       "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": "2",
                       "MTTPU_VAL_ITERS": "1"})
    t0 = time.perf_counter()
    trainer, launches = _run_counted(lambda: train_main(
        ["3d_fullres", "nnUNetTrainerV2_warmupsegheads", task, "0", "-pretrained_weights",
         jax_folder["ckpt"], "--device", "cuda", "-gpus", "1"]))
    wall = time.perf_counter() - t0
    pretrained = checkpoint_state_dict(jax_folder["ckpt"], plans, 0)
    fresh = build_unet_from_plans(one, 0, num_classes=trainer.num_classes)
    init_weights_he(fresh, torch.Generator().manual_seed(trainer.seed))
    init = fresh.state_dict()
    for k, v in trainer.network.state_dict().items():
        v = v.cpu()
        if k.startswith("seg_outputs."):
            if k != "seg_outputs.0.weight" and torch.equal(v, init[k]):
                raise AssertionError(f"head {k} did not move")
        elif not torch.equal(v, pretrained[k]):
            raise AssertionError(f"backbone {k} is not the pretrained weight")
    per = trainer.network.kernel_launches_per_forward()
    forwards = sum(t["forwards"] for t in trainer.validation_timings)
    calls = trainer.step + trainer.num_val_batches_per_epoch + forwards
    expect = _expect(per, calls)
    if trainer.step != 2 or trainer.optimizer_phase != 1 or launches != expect:
        raise AssertionError(f"warm-up: {trainer.step} steps, phase {trainer.optimizer_phase}, "
                             f"launches {launches}, expected {expect}")
    fold = trainer.output_folder
    for name in ("validation_raw/009_003.nii.gz", "validation_raw/summary.json",
                 "postprocessing.json"):
        if not os.path.isfile(os.path.join(fold, name)):
            raise AssertionError(f"warm-up run wrote no {name}")
    step_s = trainer.step_seconds
    print(f"warm-up (nnUNetTrainerV2_warmupsegheads, phase 1, -pretrained_weights .ckpt): "
          f"seconds per step {', '.join(f'{v:.3f}' for v in step_s)}; kernel C launches in "
          f"phase 1: {launches['conv3d_same_wgrad']}; launches "
          f"{ {k: v for k, v in launches.items() if v} } = per forward {per} x {calls} "
          f"({trainer.step} steps + {trainer.num_val_batches_per_epoch} validation batch + "
          f"{forwards} validation forwards); backbone bit-equal to the pretrained weights, "
          f"heads moved; validation {trainer.validation_seconds:.2f} s for 1 case; CLI "
          f"{wall:.1f} s")
    return {"launches": launches, "step_s": step_s, "wall": wall}


def _resenc_plans(plans=None):
    """`plans` (the flagship's by default) as residual-encoder plans, as the
    FabiansResUNet planner makes them: a leading (1,1,1) pool and the
    default block counts cut to the stages (the flagship's give
    RESENC_BLOCKS_ENCODER / _DECODER)."""
    from multitalent_tpu_torch.io import Plans
    d = (plans or _flagship_plans()).to_dict()
    st = d["plans_per_stage"][0]
    pools = [[1, 1, 1]] + [list(p) for p in st["pool_op_kernel_sizes"]]
    st.update(pool_op_kernel_sizes=pools,
              num_blocks_encoder=list(RESENC_DEFAULT_BLOCKS[:len(pools)]),
              num_blocks_decoder=[1] * (len(pools) - 1))
    return Plans.from_dict(d)


def _resenc_net(plans, dtype, num_classes: int = 47, seed: int = SEED):
    """The resenc network of `plans` with the trainers' He init from `seed`
    (norm2's scale 0, so each residual block starts as its skip)."""
    import torch
    from multitalent_tpu_torch.models.residual_unet import build_resenc_unet_from_plans
    from multitalent_tpu_torch.training.trainers import init_weights_he
    net = build_resenc_unet_from_plans(plans, 0, num_classes, dtype=dtype)
    init_weights_he(net, torch.Generator().manual_seed(seed))
    return net


def _unmoved(net, fresh, keep=()) -> list[str]:
    """The weights of `net` still equal to `fresh`'s (its init), but those in
    `keep`."""
    import torch
    trained = net.state_dict()
    return [k for k, v in fresh.state_dict().items()
            if k.endswith("weight") and k not in keep and torch.equal(v, trained[k].cpu())]


def phase_resenc_training(workdir: str) -> dict:
    """The train CLI with MultiTalent_trainer_resenc_ddp at full width on
    phase 5's synthetic MultiTalent cases (RESENC_TRAIN_STEPS steps, then the
    validation of one case a dataset): finite losses, every weight moved,
    exact A/B/C counts, one step's dw through kernel C against the plain
    version."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.io import save_plans
    plans = _resenc_plans()
    task = "Task100_MultiTalent"
    save_plans(plans, os.path.join(workdir, "preprocessed", task,
                                   f"{RESENC_PLANS_ID}_plans_3D.pkl"))
    results = os.path.join(workdir, "results_resenc")
    with _env(nnUNet_preprocessed=os.path.join(workdir, "preprocessed"), RESULTS_FOLDER=results,
              MTTPU_MAX_EPOCHS="1", MTTPU_ITERS_PER_EPOCH=str(RESENC_TRAIN_STEPS),
              MTTPU_VAL_ITERS="1", MTTPU_FUSED_TRAIN="0", MTTPU_FUSED_NORM="0"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", RESENC_TRAINER, task, "0", "-p", RESENC_PLANS_ID,
             "--device", "cuda", "-gpus", "1"]))
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        net = trainer.network
        per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
        print(f"resenc launches derived from the model: per forward {per_fwd}, per step "
              f"{per_step}")
        validation = _check_validation(os.path.join(trainer.output_folder, "validation_raw"),
                                       trainer)
        steps, val = trainer.step, trainer.num_val_batches_per_epoch
        expect = {k: a + b for (k, a), b in zip(
            _expect(per_step, steps).items(),
            _expect(per_fwd, val + validation["forwards"]).values())}
        if (steps != RESENC_TRAIN_STEPS or launches != expect
                or any(launches[k] == 0 for k in per_step)):
            raise AssertionError(f"resenc: {steps} steps, launches {launches}, expected {expect}")
        losses = trainer.all_tr_losses + trainer.all_val_losses + trainer.all_tr_ce
        if not np.isfinite(losses).all():
            raise AssertionError(f"resenc: non-finite losses {losses}")
        # the lowest head has loss weight 0: no gradient reaches it
        still = _unmoved(net, _resenc_net(plans, torch.float32, seed=trainer.seed),
                         keep=("decoder.deep_supervision_outputs.0.weight",))
        if still:
            raise AssertionError(f"resenc weights that did not move: {still}")
        step_s = trainer.step_seconds[2:]
        median_s = float(np.median(step_s))
        print(f"resenc training ({RESENC_TRAINER}, plans {RESENC_PLANS_ID}): {steps} steps of "
              f"batch {TRAIN_BATCH} at {PATCH}, bf16, DS ({len(trainer.ds_loss_weights)} "
              f"outputs); losses {[round(v, 4) for v in trainer.all_tr_losses]} (train), "
              f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
        print(f"resenc seconds per step: median {median_s:.3f} of steps 3..{steps} "
              f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
              f"{peak_gib:.2f} GiB; train CLI {train_s:.1f} s")
        print(f"resenc training launches: { {k: v for k, v in launches.items() if v} } = per "
              f"step {per_step} x {steps} + per forward {per_fwd} x ({val} validation batch + "
              f"{validation['forwards']} validation forwards)")
        print(f"resenc validation: {validation['seconds_per_case']:.2f} s per case (predict "
              f"{validation['predict_s']} s); Dice "
              f"{ {k: round(v, 4) for k, v in validation['dice'].items()} }")
        dw_worst, dw_shapes, a_shapes, b_shapes, _ = _check_dw_through_kernels(trainer)
    for name, shapes in (("conv3d_same", a_shapes), ("conv3d_same_dual", b_shapes)):
        if sum(shapes.values()) != per_step[name]:
            raise AssertionError(f"resenc: {sum(shapes.values())} {name} calls in one step, "
                                 f"expected {per_step[name]}")
    model = os.path.join(results, "nnUNet", "3d_fullres", task,
                         f"{RESENC_TRAINER}__{RESENC_PLANS_ID}")
    return {"launches": launches, "seconds_per_step": median_s, "step_s": trainer.step_seconds,
            "peak_gib": peak_gib, "validation": validation, "dw_worst_rel": dw_worst,
            "dw_shapes": dw_shapes, "a_shapes": a_shapes, "b_shapes": b_shapes,
            "per_forward": per_fwd, "per_step": per_step, "model": model, "plans": plans,
            "fold": trainer.output_folder}


def _predict_resenc(workdir: str, model: str, out: str, per_forward: dict) -> dict:
    """predict_multitalent from `model` on phase 3's case with mirror TTA:
    the labelmap and all 47 masks at the input's shape, exact launches."""
    import numpy as np
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    n_tiles, _ = _case_tiles()
    t0 = time.perf_counter()
    timings, launches = _run_counted(lambda: predict_main(
        ["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
         "--device", "cuda"]))
    wall = time.perf_counter() - t0
    (case,) = timings
    expect = _expect(per_forward, n_tiles * 8)
    if case["forwards"] != n_tiles * 8 or launches != expect:
        raise AssertionError(f"resenc predict: {case['forwards']} forwards, launches "
                             f"{launches}, expected {expect}")
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    masks = [read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))[0] for r in REGIONS]
    if (seg.shape != CASE_SHAPE or {m.shape for m in masks} != {CASE_SHAPE}
            or not all(set(np.unique(m).tolist()) <= {0, 1} for m in masks)):
        raise AssertionError(f"resenc predict: labelmap {seg.shape}, masks "
                             f"{ {m.shape for m in masks} }")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "forwards": case["forwards"], "out": out,
            "fg": [float(m.mean()) for m in masks]}


def phase_resenc_predict(workdir: str, training: dict) -> dict:
    """predict_multitalent from the resenc folder phase 8a wrote, on phase 3's
    case (exact mode, mirror TTA, as phase 3)."""
    res = _predict_resenc(workdir, training["model"], os.path.join(workdir, "out_resenc"),
                          training["per_forward"])
    print(f"resenc predict: {res['forwards']} forwards; labelmap + 47 region NIfTIs at "
          f"{CASE_SHAPE}, foreground share {min(res['fg']):.3f}..{max(res['fg']):.3f}; "
          f"launches { {k: v for k, v in res['launches'].items() if v} } = per forward "
          f"{training['per_forward']} x {res['forwards']}; seconds per case "
          f"{res['seconds_per_case']:.2f} (predict {res['predict_s']:.2f})")
    return res


def phase_resenc_tile() -> dict:
    """One resenc tile's sigmoid probabilities through the kernels in bf16
    against the plain versions in bf16 and in fp32, then with
    MTTPU_PALLAS_NORM=1 (the decoder's norms on kernel E) against the
    default; controls with a faulty LeakyReLU slope must break both bounds.
    The weights are the trainers' He init with every norm2 scale at 1, so
    each residual branch carries signal."""
    import torch
    from multitalent_tpu_torch.models.blocks import ConvDropoutNormNonlin
    from multitalent_tpu_torch.models.residual_unet import BasicResidualBlock
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    plans = _resenc_plans()
    dev = torch.device("cuda")
    nets = []
    for dtype in (torch.bfloat16, torch.float32):
        net = _resenc_net(plans, dtype)
        with torch.no_grad():
            for m in net.modules():
                if isinstance(m, BasicResidualBlock):
                    m.norm2.weight.fill_(1.0)
        nets.append(net.to(dev).eval())
    net, net32 = nets
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with torch.no_grad(), _recording("conv3d_same") as a_shapes, \
            _recording("conv3d_same_dual") as b_shapes:
        logits = net(x)
    per = net.kernel_launches_per_forward()
    if (sum(a_shapes.values()), sum(b_shapes.values())) != (per["conv3d_same"],
                                                           per["conv3d_same_dual"]):
        raise AssertionError(f"resenc forward: A {sum(a_shapes.values())}, B "
                             f"{sum(b_shapes.values())} calls, expected {per}")
    if logits.shape != (1, 47, *PATCH) or not torch.isfinite(logits).all():
        raise AssertionError(f"resenc logits {tuple(logits.shape)}")
    norms = sum(1 for m in net.modules() if isinstance(m, ConvDropoutNormNonlin))

    def forward(pallas: bool, use_kernels: bool = True, model=net):
        with _env(MTTPU_PALLAS_NORM="1" if pallas else "0"), torch.no_grad():
            return torch.sigmoid(model(x, use_kernels=use_kernels))

    p_kernels = torch.sigmoid(logits)
    p_plain = forward(False, use_kernels=False)
    out = {"a_shapes": a_shapes, "b_shapes": b_shapes, "norms_on_e": norms}
    out["bf16_max"], out["bf16_mean"] = _dp(p_kernels, p_plain)
    out["fp32_max"], out["fp32_mean"] = _dp(p_kernels, forward(False, False, net32))
    p_pallas, launches = _run_counted(lambda: forward(True))
    if launches["channel_stats"] != norms or launches["affine_lrelu"] != norms:
        raise AssertionError(f"resenc MTTPU_PALLAS_NORM=1: launches {launches}, {norms} norms")
    out["pallas_norm_max"], out["pallas_norm_mean"] = _dp(p_pallas, p_kernels)
    del p_pallas
    controls = []
    for slope in CONTROL_SLOPES:
        with _slope(net, slope):
            controls.append({"slope": slope, "kernels": _dp(forward(False), p_plain),
                             "pallas_norm": _dp(forward(True), p_kernels)})
    out["controls"] = controls
    print(f"resenc tile {PATCH}: |dp| kernels bf16 vs plain bf16: max {out['bf16_max']:.3e} "
          f"(bound {RESENC_PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{RESENC_PROB_BOUND_MEAN}); vs plain fp32: max {out['fp32_max']:.3e} (bound "
          f"{PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} (bound {PROB_BOUND_FP32_MEAN})")
    print(f"resenc tile, MTTPU_PALLAS_NORM=1 ({norms} decoder norms on kernel E) vs the "
          f"default: |dp| max {out['pallas_norm_max']:.3e} (bound {RESENC_PALLAS_NORM_BOUND}), "
          f"mean {out['pallas_norm_mean']:.3e} (bound {RESENC_PALLAS_NORM_BOUND_MEAN})")
    for c in controls:
        print(f"resenc control, LeakyReLU slope {c['slope']} for 1e-2: kernels vs plain |dp| "
              f"max {c['kernels'][0]:.3e}, mean {c['kernels'][1]:.3e}; MTTPU_PALLAS_NORM=1 "
              f"|dp| max {c['pallas_norm'][0]:.3e}, mean {c['pallas_norm'][1]:.3e}")
    if not (out["bf16_max"] <= RESENC_PROB_BOUND and out["bf16_mean"] <= RESENC_PROB_BOUND_MEAN
            and out["fp32_max"] <= PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= PROB_BOUND_FP32_MEAN
            and out["pallas_norm_max"] <= RESENC_PALLAS_NORM_BOUND
            and out["pallas_norm_mean"] <= RESENC_PALLAS_NORM_BOUND_MEAN):
        raise AssertionError(f"resenc probabilities out of bounds: {out}")
    for c in controls:
        (k_max, k_mean), (p_max, p_mean) = c["kernels"], c["pallas_norm"]
        if not ((k_max > RESENC_PROB_BOUND or k_mean > RESENC_PROB_BOUND_MEAN)
                and (p_max > RESENC_PALLAS_NORM_BOUND or p_mean > RESENC_PALLAS_NORM_BOUND_MEAN)):
            raise AssertionError(f"the resenc bounds pass a faulty activation: {c}")
    with torch.no_grad():
        out["forward_ms"] = _median_ms(lambda: net(x), iters=5)
    print(f"one bf16 resenc forward of a tile: {out['forward_ms']:.2f} ms (median of 5, CUDA "
          f"events)")
    del nets, net, net32
    torch.cuda.empty_cache()
    return out


def phase_resenc_jax_folder(workdir: str, training: dict, predicted: dict) -> dict:
    """The trained resenc weights as a JAX-layout folder (biases carried),
    restored on the card (timed), then predict_multitalent from it: every
    mask and the labelmap bit-equal to phase 8b's."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               save_jax_model_folder)
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    sd = torch.load(os.path.join(training["fold"], "model_final_checkpoint.model"),
                    map_location="cpu", weights_only=False)["state_dict"]
    model = os.path.join(workdir, "jax_model_resenc")
    save_jax_model_folder(model, training["plans"], [sd], "MultiTalentTrainerResenc",
                          trainer_bases=["MultiTalentTrainer", "TrainerV2", "NetworkTrainerBase"])
    ckpt = os.path.join(model, "fold_0", "model_final_checkpoint.ckpt")
    t0 = time.perf_counter()
    restored = load_model_and_checkpoint_files(model, [0], device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = restored.networks[0].state_dict()
    if sorted(got) != sorted(sd) or not all(torch.equal(v.cpu(), sd[k]) for k, v in got.items()):
        raise AssertionError("resenc weights restored from the .ckpt folder differ")
    del restored, got
    res = _predict_resenc(workdir, model, os.path.join(workdir, "out_resenc_jax"),
                          training["per_forward"])
    for rel in ["case.nii.gz"] + [os.path.join("individual", r, "case.nii.gz") for r in REGIONS]:
        if not np.array_equal(read_nifti(os.path.join(res["out"], rel))[0],
                              read_nifti(os.path.join(predicted["out"], rel))[0]):
            raise AssertionError(f"resenc {rel} from the .ckpt folder differs from the "
                                 ".model folder's")
    print(f"resenc JAX-layout folder: {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB .ckpt, restored "
          f"on the card in {restore_s:.2f} s; predict_multitalent from it: labelmap + "
          f"{len(REGIONS)} masks bit-equal to phase 8b's; launches "
          f"{ {k: v for k, v in res['launches'].items() if v} }")
    return {"ckpt": ckpt, "restore_s": restore_s, "launches": res["launches"],
            "seconds_per_case": res["seconds_per_case"]}


def phase_resenc_warmup(workdir: str, jax_folder: dict) -> dict:
    """nnUNetTrainerV2_warmupsegheads_resenc -pretrained_weights <phase 8d's
    .ckpt> on phase 5e's one-class task, 2 steps of phase 1 and its
    validation: the backbone loads equal to the pretrained weights and stays
    bit-unchanged, the heads move, kernel C launches 0 times."""
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.model_restore import checkpoint_state_dict
    from multitalent_tpu_torch.io import Plans, save_plans
    from multitalent_tpu_torch.training.warmup import is_seg_head_param
    task = "Task009_Spleen"
    plans = _resenc_plans()
    one = Plans.from_dict({**plans.to_dict(), "num_classes": 1, "all_classes": [1]})
    save_plans(one, os.path.join(workdir, "preprocessed", task,
                                 f"{RESENC_PLANS_ID}_plans_3D.pkl"))
    with _env(nnUNet_preprocessed=os.path.join(workdir, "preprocessed"),
              RESULTS_FOLDER=os.path.join(workdir, "results_resenc_warmup"),
              MTTPU_MAX_EPOCHS="1", MTTPU_ITERS_PER_EPOCH="2", MTTPU_VAL_ITERS="1"):
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", "nnUNetTrainerV2_warmupsegheads_resenc", task, "0", "-p",
             RESENC_PLANS_ID, "-pretrained_weights", jax_folder["ckpt"], "--device", "cuda",
             "-gpus", "1"]))
        wall = time.perf_counter() - t0
    pretrained = checkpoint_state_dict(jax_folder["ckpt"], plans, 0)
    init = _resenc_net(one, torch.float32, trainer.num_classes, seed=trainer.seed).state_dict()
    for k, v in trainer.network.state_dict().items():
        v = v.cpu()
        if is_seg_head_param(k):
            # the lowest head has loss weight 0: no gradient, so AdamW skips it
            if not k.startswith("decoder.deep_supervision_outputs.0.") and torch.equal(v, init[k]):
                raise AssertionError(f"resenc head {k} did not move")
        elif not torch.equal(v, pretrained[k]):
            raise AssertionError(f"resenc backbone {k} is not the pretrained weight")
    per = trainer.network.kernel_launches_per_forward()
    forwards = sum(t["forwards"] for t in trainer.validation_timings)
    calls = trainer.step + trainer.num_val_batches_per_epoch + forwards
    expect = _expect(per, calls)
    if trainer.step != 2 or trainer.optimizer_phase != 1 or launches != expect:
        raise AssertionError(f"resenc warm-up: {trainer.step} steps, phase "
                             f"{trainer.optimizer_phase}, launches {launches}, expected {expect}")
    print(f"resenc warm-up (nnUNetTrainerV2_warmupsegheads_resenc, phase 1, "
          f"-pretrained_weights .ckpt): seconds per step "
          f"{', '.join(f'{v:.3f}' for v in trainer.step_seconds)}; kernel C launches "
          f"{launches['conv3d_same_wgrad']}; launches "
          f"{ {k: v for k, v in launches.items() if v} } = per forward {per} x {calls}; "
          f"backbone bit-equal to the pretrained weights, heads moved; validation "
          f"{trainer.validation_seconds:.2f} s for 1 case; CLI {wall:.1f} s")
    return {"launches": launches, "step_s": trainer.step_seconds, "wall": wall}


def phase_resenc_liver(workdir: str) -> dict:
    """cli.predict -tr nnUNetTrainerV2_ResencUNet -p <FabiansResUNet plans>
    on one of phase 3c's Liver cases in the default mode, one fold of seeded
    weights of the Liver plans as resenc plans."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.inference.model_restore import save_model_folder
    from multitalent_tpu_torch.io import read_nifti
    plans = _resenc_plans(_liver_plans())
    net = _resenc_net(plans, torch.bfloat16, LIVER_CLASSES, seed=SEED + 20)
    results = os.path.join(workdir, "liver_results")
    model = os.path.join(results, "nnUNet", "3d_fullres", LIVER_TASK,
                         f"{LIVER_RESENC_TRAINER}__{LIVER_RESENC_PLANS_ID}")
    save_model_folder(model, plans, [net.state_dict()], LIVER_RESENC_TRAINER, fp16=True)
    case = LIVER_CASES[0]
    inp, out = os.path.join(workdir, "liver_resenc_in"), os.path.join(workdir, "liver_resenc")
    os.makedirs(inp)
    shutil.copy(os.path.join(workdir, "liver_in", f"{case}_0000.nii.gz"), inp)
    n_tiles, _ = _liver_tiles()
    per = net.kernel_launches_per_forward()
    with _env(RESULTS_FOLDER=results, MTTPU_SW_EXACT="0", MTTPU_FUSED_NORM="0"):
        t0 = time.perf_counter()
        timings, launches = _run_counted(lambda: predict_main(
            ["-i", inp, "-o", out, "-t", LIVER_TASK, "-m", "3d_fullres", "-tr",
             LIVER_RESENC_TRAINER, "-p", LIVER_RESENC_PLANS_ID, "--device", "cuda"]))
        wall = time.perf_counter() - t0
    (t,) = timings
    calls = n_tiles * -(-8 // LIVER_TTA_CHUNK)
    expect = _expect(per, t["net_calls"])
    if (t["case"], t["forwards"], t["net_calls"]) != (case, n_tiles * 8, calls) \
            or launches != expect:
        raise AssertionError(f"resenc Liver predict: {t}, launches {launches}, expected "
                             f"{expect} over {calls} calls")
    seg, _ = read_nifti(os.path.join(out, f"{case}.nii.gz"))
    if seg.shape != LIVER_CASE_SHAPE or not set(np.unique(seg).tolist()) <= {0, 1, 2}:
        raise AssertionError(f"resenc Liver labelmap {seg.shape} {np.unique(seg)[:5]}")
    print(f"resenc Liver ({LIVER_RESENC_TRAINER}, plans {LIVER_RESENC_PLANS_ID}, blocks "
          f"{plans.stage(0).num_blocks_encoder}, default mode, one fold): {wall:.2f} s for the case "
          f"(predict {t['predict_s']:.2f} s on the card's clock, export {t['export_s']:.2f} s); "
          f"{t['net_calls']} network calls of {LIVER_TTA_CHUNK} combinations; launches "
          f"{ {k: v for k, v in launches.items() if v} } = per forward {per} x "
          f"{t['net_calls']}; labels {sorted(np.unique(seg).tolist())}")
    del net
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": wall, "predict_s": t["predict_s"],
            "net_calls": t["net_calls"], "per_forward": per}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else (v[len(v) // 2 - 1] + v[len(v) // 2]) / 2


def _same_nifti_bytes(a: str, b: str) -> int:
    """The number of NIfTIs under folder a, each of whose bytes must equal
    its namesake's under b (same set of files): the gzip streams but their
    header's mtime (bytes 4-7), else the decompressed NIfTIs."""
    import gzip
    names = sorted(os.path.relpath(os.path.join(d, f), a) for d, _, fs in os.walk(a)
                   for f in fs if f.endswith(".nii.gz"))
    other = sorted(os.path.relpath(os.path.join(d, f), b) for d, _, fs in os.walk(b)
                   for f in fs if f.endswith(".nii.gz"))
    if not names or names != other:
        raise AssertionError(f"{a} and {b} hold other NIfTIs")
    for name in names:
        with open(os.path.join(a, name), "rb") as fa, open(os.path.join(b, name), "rb") as fb:
            ra, rb = fa.read(), fb.read()
        if ra[:4] + ra[8:] != rb[:4] + rb[8:] and gzip.decompress(ra) != gzip.decompress(rb):
            raise AssertionError(f"{name} differs between {a} and {b}")
    return len(names)


def phase_ddp_launched(workdir: str) -> dict:
    """9a: `cli.train 3d_fullres MultiTalent_trainer_ddp` on phase 5's task as
    torchrun --nproc_per_node=1 starts it (RANK=0, WORLD_SIZE=1: a NCCL group
    of one, the DDP wrapper and its gradient hook, the pooled loss), DDP_STEPS
    steps and the validation, beside the same run in one process (no group)
    from the same seed and batches (one sampler thread, so that both draw
    them in one order; cuDNN deterministic): exact A/B/C launch counts in
    both, the weights and every validation NIfTI bit-equal, then
    predict_multitalent from the launched run's folder. Each step's wait for
    its host batch is timed apart (one sampler thread may not keep up)."""
    import torch
    from multitalent_tpu_torch.augment.params import default_3D_augmentation_params
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.data.loader import PrefetchPipeline
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.parallel import distributed

    waits = collections.defaultdict(list)  # a pipeline's seconds waiting for its batches
    take = PrefetchPipeline.__next__

    def timed_take(pipeline):
        t0 = time.perf_counter()
        batch = take(pipeline)
        waits[id(pipeline)].append(time.perf_counter() - t0)
        return batch

    task = "Task100_MultiTalent"
    args = ["3d_fullres", "MultiTalent_trainer_ddp", task, "0", "--device", "cuda"]
    env = {"nnUNet_preprocessed": os.path.join(workdir, "preprocessed"),
           "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": str(DDP_STEPS),
           "MTTPU_VAL_ITERS": "1", "MTTPU_FUSED_TRAIN": "0", "MTTPU_FUSED_NORM": "0"}
    launcher = {"RANK": "0", "LOCAL_RANK": "0", "WORLD_SIZE": "1",
                "MASTER_ADDR": "localhost", "MASTER_PORT": str(distributed.free_port())}
    threads = default_3D_augmentation_params["num_threads"]
    deterministic = torch.backends.cudnn.deterministic
    default_3D_augmentation_params["num_threads"] = 1
    torch.backends.cudnn.deterministic = True
    PrefetchPipeline.__next__ = timed_take
    runs = {}
    try:
        for name, extra_env, extra_args in (("one process", {}, ["-gpus", "1"]),
                                            ("launched", launcher, [])):
            results = os.path.join(workdir, "results_ddp_" + name.replace(" ", "_"))
            with _env(**env, RESULTS_FOLDER=results, **extra_env):
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                trainer, launches = _run_counted(lambda: train_main(args + extra_args))
                runs[name] = {"trainer": trainer, "launches": launches, "results": results,
                              "s": time.perf_counter() - t0,
                              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    finally:
        default_3D_augmentation_params["num_threads"] = threads
        torch.backends.cudnn.deterministic = deterministic
        PrefetchPipeline.__next__ = take
    if distributed.is_initialized():
        raise AssertionError("the train CLI left its process group up")

    one, launched = runs["one process"]["trainer"], runs["launched"]["trainer"]
    with open(launched.log_file) as f:
        log = f.read()
    if launched.ddp is None or one.ddp is not None \
            or "data-parallel over 1 ranks (nccl)" not in log:
        raise AssertionError("9a: the launched run did not train under DDP over NCCL")
    net = launched.network
    per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
    validation = _check_validation(os.path.join(launched.output_folder, "validation_raw"),
                                   launched)
    for name, run in runs.items():
        t = run["trainer"]
        expect = {k: a + b + c for (k, a), b, c in zip(
            _expect(per_step, t.step).items(),
            _expect(per_fwd, t.num_val_batches_per_epoch).values(),
            _expect(per_fwd, sum(v["forwards"] for v in t.validation_timings)).values())}
        if t.step != DDP_STEPS or run["launches"] != expect \
                or any(run["launches"][k] == 0 for k in per_step):
            raise AssertionError(f"9a {name}: {t.step} steps, launches {run['launches']}, "
                                 f"expected {expect}")
    a, b = one.network.state_dict(), net.state_dict()
    moved = [k for k, v in a.items() if not torch.equal(v, b[k])]
    if moved or one.all_tr_losses != launched.all_tr_losses:
        raise AssertionError(f"9a: the launched run's weights differ from the one-process "
                             f"run's at {moved[:5]}, losses {launched.all_tr_losses} vs "
                             f"{one.all_tr_losses}")
    files = _same_nifti_bytes(os.path.join(launched.output_folder, "validation_raw"),
                              os.path.join(one.output_folder, "validation_raw"))
    model = os.path.dirname(launched.output_folder)
    out = os.path.join(workdir, "out_trained_ddp")
    predict_main(["-i", os.path.join(workdir, "in"), "-o", out, "-m", model, "-f", "0",
                  "--device", "cuda", "--disable_tta"])
    seg, _ = read_nifti(os.path.join(out, "case.nii.gz"))
    masks = {read_nifti(os.path.join(out, "individual", r, "case.nii.gz"))[0].shape
             for r in REGIONS}
    if seg.shape != CASE_SHAPE or masks != {CASE_SHAPE}:
        raise AssertionError(f"9a: the launched run's folder predicted {seg.shape}, {masks}")
    step_s, busy_s = {}, {}
    for k, r in runs.items():
        t = r["trainer"]
        step_s[k] = _median(t.step_seconds[1:])
        busy_s[k] = [s - w for s, w in zip(t.step_seconds, waits[id(t.tr_gen)])]
    print(f"9a launched (RANK=0 WORLD_SIZE=1, NCCL, DDP): {DDP_STEPS} steps of batch "
          f"{TRAIN_BATCH}, losses {[round(v, 4) for v in launched.all_tr_losses]} (train), "
          f"bit-equal to the one-process run's, as are all {len(b)} weight tensors and all "
          f"{files} validation NIfTIs; launches "
          f"{ {k: v for k, v in runs['launched']['launches'].items() if v} } in both = per "
          f"step {per_step} x {DDP_STEPS} + per forward {per_fwd} x (1 validation batch + "
          f"{validation['forwards']} validation forwards); the folder predicts "
          f"(labelmap + {len(REGIONS)} region NIfTIs at {CASE_SHAPE})")
    print("9a seconds per step (median of steps 2.." + str(DDP_STEPS) + "): " + ", ".join(
        f"{k} {step_s[k]:.3f} (steps {', '.join(f'{v:.3f}' for v in r['trainer'].step_seconds)}"
        f"; without the wait for the host batch "
        f"{', '.join(f'{v:.3f}' for v in busy_s[k])}; peak {r['peak_gib']:.2f} GiB; train "
        f"CLI {r['s']:.1f} s; validation "
        f"{r['trainer'].validation_seconds / len(VAL_KEYS):.2f} s a case)"
        for k, r in runs.items()))
    for run in runs.values():
        run.pop("trainer")
    return {"launches": runs["launched"]["launches"], "step_s": step_s,
            "busy_s": {k: _median(v[1:]) for k, v in busy_s.items()},
            "peak_gib": {k: r["peak_gib"] for k, r in runs.items()}}


def _ddp_batches(steps: int) -> list[dict]:
    """`steps` global host batches of TRAIN_BATCH at the patch size (the
    augmentation is off, so no enlarged patch), seeded: each row a body with
    a liver and a tumour of its own (Task003's regions valid, labels in the
    global 1..47 space). The rows share their valid regions, so pooling the
    Dice statistics over them differs from each row's own Dice."""
    import numpy as np
    rng = np.random.default_rng(SEED + 9)
    axes = np.meshgrid(*[np.linspace(-1, 1, n, dtype=np.float32) for n in PATCH],
                       indexing="ij")
    body = sum(a * a for a in axes) < 0.8
    rows = [(("03_liver", "03_cancer"), (1, 2), "003")] * TRAIN_BATCH
    batches = []
    for _ in range(steps):
        data = np.empty((TRAIN_BATCH, 1, *PATCH), np.float32)
        seg = np.zeros((TRAIN_BATCH, 1, *PATCH), np.float32)
        for j, (_, labels, _) in enumerate(rows):
            data[j, 0] = np.where(body, 0.5, -1.5)
            for label in labels:
                c, r = rng.uniform(-0.4, 0.4, 3), rng.uniform(0.15, 0.35, 3)
                inside = sum(((a - ci) / ri) ** 2 for a, ci, ri in zip(axes, c, r)) < 1
                seg[j, 0][inside] = label
                data[j, 0][inside] = rng.uniform(-1, 2)
            data[j, 0] += rng.standard_normal(PATCH, dtype=np.float32) * 0.1
        batches.append({"data": data, "seg": seg,
                        "properties": [{"valid_regions": v} for v, _, _ in rows],
                        "keys": [f"{p}_ddp{j}" for j, (_, _, p) in enumerate(rows)]})
    return batches


class _UnpooledDice:
    """The control of 9b: the MultiTalent loss with each rank's Dice (and
    BCE) on its own sample, not pooled over the ranks; the gradients are
    still summed by the DDP hook."""

    def loss_fn(self, outputs, targets, extras: dict):
        from multitalent_tpu_torch.training.losses import multitalent_ds_loss
        loss, ce, dc = multitalent_ds_loss(outputs, targets, extras["valid_region_mask"],
                                           self._label_region_matrix,
                                           [float(w) for w in self.ds_loss_weights])
        return loss, {"ce": ce.detach(), "dice": dc.detach()}


def _ddp_train(device, rows, batches: list, fused: bool, unpooled: bool = False,
               batch: int = TRAIN_BATCH, probe=None) -> dict:
    """The flagship's MultiTalentTrainer (no dataset; augmentation off;
    seeded He init; bf16) at global batch `batch` on `rows` of each global
    batch: losses, seconds per step, peak memory, the weights before, after
    the first step and after the last, the bytes its space axis sent;
    `probe(trainer)` after the last step, its result under "probe"."""
    import hashlib
    import torch
    from multitalent_tpu_torch.io import Plans
    from multitalent_tpu_torch.training.multitalent import MultiTalentTrainer
    cls = type("Unpooled", (_UnpooledDice, MultiTalentTrainer), {}) if unpooled \
        else MultiTalentTrainer
    plans = _flagship_plans().to_dict()
    plans["plans_per_stage"][0]["batch_size"] = batch
    with _env(MTTPU_FUSED_TRAIN="1" if fused else "0"):
        t = cls(Plans.from_dict(plans), 0, None, None, fp16=True, device=device)
        t.initialize(True)
        t.data_aug_params.update(DDP_NO_AUG)
        t._build_step_functions()
    before = {k: v.detach().cpu().clone() for k, v in t.network.state_dict().items()}
    if t.space is not None:
        t.space.sent.clear()  # the bytes of this run's steps (one Space a process and plan)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    losses, first = [], None
    for batch in batches:
        losses.append(t.run_iteration(iter([{k: v[rows] for k, v in batch.items()}])))
        if first is None:
            first = {k: v.detach().cpu().clone() for k, v in t.network.state_dict().items()}
    peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
    after = {k: v.detach().cpu() for k, v in t.network.state_dict().items()}
    digest = hashlib.sha256()
    for v in after.values():
        digest.update(v.numpy().tobytes())
    out = {"losses": losses, "step_s": list(t.step_seconds), "peak_gib": peak,
           "local_batch": t.local_batch_size, "wrapped": t.ddp is not None,
           "digest": digest.hexdigest(), "before": before, "first": first, "after": after,
           "space": None if t.space is None else {
               "index": t.space.index, "size": t.space.size, "axis": t.space.axis,
               "exchange": t.space.exchange, "sent": dict(t.space.sent),
               "per_step": t.network.kernel_launches_per_step()}}
    if probe is not None:
        out["probe"] = probe(t, {k: v[rows] for k, v in batches[0].items()})
    del t
    torch.cuda.empty_cache()
    return out


# 9b, 9c: (run, fused, unpooled, steps)
_DDP_RUNS = (("pooled", False, False, DDP_STEPS), ("control", False, True, DDP_STEPS),
             ("fused", True, False, FUSED_DDP_STEPS))


def _ddp_rank(workdir: str, backend: str) -> None:
    """One rank of 9b/9c and 9d (started by parallel.distributed.spawn): the
    runs of _DDP_RUNS on its sample of each global batch, then 9d's
    (`_space_runs`); saves their readings to workdir/ddp_<backend>_rank<r>.pt
    and workdir/space_<backend>_rank<r>.pt (rank 0 also the weights). One
    spawn serves both phases: a rank's start, its card and gloo's first
    collectives cost ~10 s."""
    import torch
    from multitalent_tpu_torch.parallel import distributed
    rank = int(os.environ["RANK"])
    device = distributed.init_process_group("cuda", backend=backend,
                                            device_index=0 if backend == "gloo" else rank)
    try:
        out, batches = {}, _ddp_batches(DDP_STEPS)
        for name, fused, unpooled, steps in _DDP_RUNS:
            run = _ddp_train(device, slice(rank, rank + 1), batches[:steps], fused, unpooled)
            if rank != 0:
                for k in ("before", "first", "after"):
                    run.pop(k)
            out[name] = run
        torch.save(out, os.path.join(workdir, f"ddp_{backend}_rank{rank}.pt"))
        torch.save(_space_runs(device, rank, batches),
                   os.path.join(workdir, f"space_{backend}_rank{rank}.pt"))
    finally:
        torch.distributed.destroy_process_group()


def _update_gap(a: dict, b: dict, before: dict) -> float:
    """|d_a - d_b| / |d_b| over every weight but the conv biases and the
    head of loss weight 0 (d: the update from `before`)."""
    import torch
    keys = [k for k in before if not k.endswith("conv.bias")
            and k != "seg_outputs.0.weight"]
    da = torch.cat([(a[k].double() - before[k].double()).flatten() for k in keys])
    db = torch.cat([(b[k].double() - before[k].double()).flatten() for k in keys])
    return ((da - db).norm() / db.norm()).item()


def phase_ddp_ranks(workdir: str, backend: str = "gloo") -> dict:
    """9b and 9c: two ranks over `backend` (gloo: both on card 0; nccl: one
    card each), each with one sample of the flagship's batch of 2, against
    one process with the batch, from the same seeded weights and host
    batches; then the control (each rank's Dice on its own sample), which
    must break DDP_UPDATE_BOUND; 9c the same under MTTPU_FUSED_TRAIN=1."""
    import torch
    from multitalent_tpu_torch.parallel import distributed
    device = torch.device("cuda", 0)
    batches = _ddp_batches(DDP_STEPS)
    one = {name: _ddp_train(device, slice(0, TRAIN_BATCH), batches[:steps], fused)
           for name, fused, steps in (("pooled", False, DDP_STEPS),
                                      ("fused", True, FUSED_DDP_STEPS))}
    del batches
    t0 = time.perf_counter()
    distributed.spawn(_ddp_rank, 2, (workdir, backend))
    spawn_s = time.perf_counter() - t0
    ranks = [torch.load(os.path.join(workdir, f"ddp_{backend}_rank{r}.pt"), weights_only=False)
             for r in (0, 1)]
    out, failed = {"spawn_s": spawn_s}, []
    for name, _, unpooled, steps in _DDP_RUNS:
        r0, r1 = ranks[0][name], ranks[1][name]
        ref = one["fused" if name == "fused" else "pooled"]
        # the ranks' losses are the global batch's, but the control's are each
        # rank's own
        if r0["digest"] != r1["digest"] or (r0["losses"] != r1["losses"]) != unpooled:
            raise AssertionError(f"9b {backend} {name}: the ranks' weights or losses differ")
        if (r0["local_batch"], r1["local_batch"]) != (1, 1) or not r0["wrapped"]:
            raise AssertionError(f"9b {backend} {name}: not one sample a rank under DDP")
        if not all(torch.equal(v, ref["before"][k]) for k, v in r0["before"].items()):
            raise AssertionError(f"9b {backend} {name}: the ranks started from other weights")
        gap1 = _update_gap(r0["first"], ref["first"], ref["before"])
        gap = _update_gap(r0["after"], ref["after"], ref["before"])
        loss_rel = max(abs(a / b - 1) for a, b in zip(r0["losses"], ref["losses"]))
        ok = min(gap1, gap) > DDP_UPDATE_BOUND if unpooled else (
            max(gap1, gap) <= DDP_UPDATE_BOUND and loss_rel <= DDP_LOSS_RTOL)
        label = {"pooled": "9b", "control": "9b control", "fused": "9c"}[name]
        print(f"{label} ({backend}, 2 ranks x 1 sample vs 1 process x {TRAIN_BATCH}, "
              f"{steps} steps, bf16{', MTTPU_FUSED_TRAIN=1' if name == 'fused' else ''}"
              f"{', Dice not pooled' if unpooled else ''}): weight updates |d_ranks - d_one| "
              f"/ |d_one| after step 1 {gap1:.3e}, after step {steps} {gap:.3e} (bound "
              f"{DDP_UPDATE_BOUND:g}, {'both must break it' if unpooled else 'within'}), "
              f"losses "
              f"{[round(v, 5) for v in r0['losses']]} vs {[round(v, 5) for v in ref['losses']]} "
              f"(max rel {loss_rel:.2e}, bound {DDP_LOSS_RTOL:g}); ranks bit-equal; seconds "
              f"per step rank 0 {', '.join(f'{v:.3f}' for v in r0['step_s'])}, rank 1 "
              f"{', '.join(f'{v:.3f}' for v in r1['step_s'])} (one process "
              f"{', '.join(f'{v:.3f}' for v in ref['step_s'])}); peak "
              f"{r0['peak_gib']:.2f}, {r1['peak_gib']:.2f} GiB a rank (one process "
              f"{ref['peak_gib']:.2f})")
        if not ok:
            failed.append(f"{label} ({backend}): update gaps {gap1:.3e}, {gap:.3e}, loss rel "
                          f"{loss_rel:.2e}")
        out[name] = {"gap1": gap1, "gap": gap, "loss_rel": loss_rel,
                     "step_s": [r0["step_s"], r1["step_s"]], "one_step_s": ref["step_s"],
                     "peak_gib": [r0["peak_gib"], r1["peak_gib"]],
                     "one_peak_gib": ref["peak_gib"]}
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _slab_statistics(x, space):
    """9d's control, in place of mesh.space_sum: each rank's own sum, scaled
    as the pooled one would be, so that a norm takes its slab's own
    statistics."""
    return x * space.size


def _space_probe(t, batch) -> dict:
    """One more forward and backward of trainer `t`'s space plan on `batch`
    (no update, no gradient sum): every call of kernels A (A's dx too), B and
    C recorded by shape, each shape's first call held against its plain
    version on the same inputs within phase 2's bounds. Returns {kernel:
    {shape: [calls, max|d|, bound]}}."""
    import torch
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.parallel import mesh
    names = ("conv3d_same", "conv3d_same_dual", "conv3d_same_wgrad", "conv3d_same_wgrad_dual")
    kernels = {name: getattr(cv, name) for name in names}
    seen = {name: {} for name in names}

    def checked(name):
        kernel, wgrad = kernels[name], "wgrad" in name

        def call(*args, **kwargs):
            out = kernel(*args, **kwargs)
            if wgrad:  # (inputs..., g)
                ins, cout = args[:-1], int(args[-1].shape[-1])
            else:  # (inputs..., pw, bias)
                i = next(i for i, a in enumerate(args) if isinstance(a, cv.PreparedWeight))
                ins, pw = args[:i], args[i]
                bias = args[i + 1] if len(args) > i + 1 else kwargs.get("bias")
                cout = pw.cout
            key = (tuple(int(a.shape[-1]) for a in ins), cout,
                   tuple(int(v) for v in ins[0].shape[1:4]), int(ins[0].shape[0]))
            row = seen[name].setdefault(key, [0, None, None])
            row[0] += 1
            if row[1] is None:
                if wgrad:
                    plain = cv.conv3d_same_wgrad_dual_ref if len(ins) == 2 \
                        else cv.conv3d_same_wgrad_ref
                    ref = plain(*(a.float() for a in ins), args[-1].float())
                    bound = DW_RTOL * ref.abs().max().item()
                else:
                    w = cv.unprepare_conv3d_weight(pw).float()
                    plain = cv.conv3d_same_dual_ref if len(ins) == 2 else cv.conv3d_same_ref
                    ref = plain(*(a.float() for a in ins), w, bias)
                    bound = ATOL + RTOL * ref.abs().max().item()
                row[1] = _check(f"9d {name} {key}", out, ref, bound)
                row[2] = bound
            return out
        call.launches = 0
        call.launches_by_body = dict.fromkeys(cv.BODIES, 0)
        return call

    # the plain versions in fp32, not TF32 (as phase 2's; a fresh rank
    # process starts with cuDNN's TF32 on)
    tf32 = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    for name in names:
        setattr(cv, name, checked(name))
    try:
        with torch.no_grad():
            data, targets, extras = t._space_batch(batch if t.space.index == 0 else None,
                                                   t._val_transform)
        with mesh.activated(t.space):
            outputs = t._outputs(t.network_forward(data, deep_supervision=True))
        loss, _ = t.loss_fn(outputs, targets, extras)
        t.network.zero_grad()
        loss.backward()
    finally:
        for name, kernel in kernels.items():
            setattr(cv, name, kernel)
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.cuda.synchronize()
    return seen


def _space_runs(device, rank: int, batches: list) -> dict:
    """9d on one rank of 9b's spawn: the flagship's sample at global batch 1
    under the space plan, counted, then the probe step; the control with
    each slab's own norm statistics. Their readings (rank 0's with the
    weights)."""
    from multitalent_tpu_torch.parallel import mesh
    out, pooled = {}, mesh.space_sum
    for name, control in (("space", False), ("control", True)):
        mesh.space_sum = _slab_statistics if control else pooled
        try:
            run, launches = _run_counted(lambda: _ddp_train(
                device, slice(0, 1), batches, False, batch=1,
                probe=None if control else _space_probe))
        finally:
            mesh.space_sum = pooled
        run["launches"] = {k: v for k, v in launches.items() if v}
        if rank != 0:
            for k in ("before", "first", "after"):
                run.pop(k)
        out[name] = run
    return out


def _shape_label(key) -> str:
    splits, cout, sp, n = key
    return f"{'+'.join(map(str, splits))}->{cout} @{'x'.join(map(str, sp))} N={n}"


def phase_space_ranks(workdir: str, backend: str = "gloo") -> dict:
    """9d: SPACE_RANKS ranks over `backend` (gloo: all on card 0; nccl: one
    card each; the ranks of 9b's spawn, `_space_runs`) trained the
    flagship's sample at global batch 1, each on its slab of the patch's x;
    against one process with the batch, from the same seeded weights and
    host batches: exact A/B/C launch counts a rank and their shapes, every
    shape against its plain version, the control with unpooled norms
    breaking SPACE_UPDATE_BOUND."""
    import torch
    device = torch.device("cuda", 0)
    one = _ddp_train(device, slice(0, 1), _ddp_batches(DDP_STEPS), False, batch=1)
    ranks = [torch.load(os.path.join(workdir, f"space_{backend}_rank{r}.pt"),
                        weights_only=False) for r in range(SPACE_RANKS)]
    out, failed = {}, []
    for name in ("space", "control"):
        r0 = ranks[0][name]
        space = r0["space"]
        if [r[name]["space"]["index"] for r in ranks] != list(range(SPACE_RANKS)) or (
                space["size"], space["axis"]) != (SPACE_RANKS, 2):
            raise AssertionError(f"9d {backend} {name}: not space {SPACE_RANKS} along x")
        if any(r[name]["digest"] != r0["digest"] or r[name]["losses"] != r0["losses"]
               for r in ranks) or not r0["wrapped"] or r0["local_batch"] != 1:
            raise AssertionError(f"9d {backend} {name}: the ranks' weights or losses differ")
        expect = {k: v * DDP_STEPS for k, v in space["per_step"].items()}
        for r in ranks:
            got = {k: r[name]["launches"].get(k, 0) for k in expect}
            if got != expect or not all(expect.values()):
                raise AssertionError(f"9d {backend} {name}: launches {r[name]['launches']}, "
                                     f"expected {expect}")
        if not all(torch.equal(v, one["before"][k]) for k, v in r0["before"].items()):
            raise AssertionError(f"9d {backend} {name}: the ranks started from other weights")
        gap1 = _update_gap(r0["first"], one["first"], one["before"])
        gap = _update_gap(r0["after"], one["after"], one["before"])
        loss_rel = max(abs(a / b - 1) for a, b in zip(r0["losses"], one["losses"]))
        control = name == "control"
        ok = min(gap1, gap) > SPACE_UPDATE_BOUND if control else (
            max(gap1, gap) <= SPACE_UPDATE_BOUND and loss_rel <= DDP_LOSS_RTOL)
        sent = {k: v / DDP_STEPS for k, v in space["sent"].items()}
        label = "9d control" if control else "9d"
        print(f"{label} ({backend}, {space['exchange']} exchanges, {SPACE_RANKS} ranks x the "
              f"slab of 1 sample along x vs 1 process x 1, {DDP_STEPS} steps, bf16"
              f"{', each slab normalised with its own statistics' if control else ''}): "
              f"weight updates |d_ranks - d_one| / |d_one| after step 1 {gap1:.3e}, after "
              f"step {DDP_STEPS} {gap:.3e} (bound {SPACE_UPDATE_BOUND:g}, "
              f"{'both must break it' if control else 'within'}), losses "
              f"{[round(v, 5) for v in r0['losses']]} vs {[round(v, 5) for v in one['losses']]} "
              f"(max rel {loss_rel:.2e}, bound {DDP_LOSS_RTOL:g}); ranks bit-equal; launches a "
              f"rank {ranks[0][name]['launches']} (= {DDP_STEPS} x {space['per_step']}); "
              f"seconds per step " + "; ".join(
                  f"rank {i} " + ", ".join(f"{v:.3f}" for v in r[name]["step_s"])
                  for i, r in enumerate(ranks))
              + f" (one process {', '.join(f'{v:.3f}' for v in one['step_s'])}); peak "
              f"{', '.join(f'{r[name]['peak_gib']:.2f}' for r in ranks)} GiB a rank (one "
              f"process {one['peak_gib']:.2f}); bytes sent a step by rank 0 "
              f"{ {k: int(v) for k, v in sent.items()} }")
        if not ok:
            failed.append(f"{label} ({backend}): update gaps {gap1:.3e}, {gap:.3e}, loss rel "
                          f"{loss_rel:.2e}")
        out[name] = {"gap1": gap1, "gap": gap, "loss_rel": loss_rel,
                     "step_s": [r[name]["step_s"] for r in ranks], "one_step_s": one["step_s"],
                     "peak_gib": [r[name]["peak_gib"] for r in ranks],
                     "one_peak_gib": one["peak_gib"], "sent_per_step": sent,
                     "launches": ranks[0][name]["launches"], "exchange": space["exchange"]}
    shapes = {}
    for kernel, rows in ranks[0]["space"]["probe"].items():
        for key, (calls, err, bound) in sorted(rows.items()):
            print(f"9d {kernel} {_shape_label(key)}: {calls} call(s) in one step on rank 0, "
                  f"max|d| {err:.3e} vs plain (bound {bound:.3e})")
            shapes.setdefault(kernel, []).append(
                {"shape": _shape_label(key), "calls": calls, "err": err, "bound": bound})
    out["shapes"] = shapes
    if failed:
        raise AssertionError("; ".join(failed))
    return out


def _raw_phantom(rng, shape, organs):
    """A CT-like int16 volume (HU) of `shape` and its labels: air, a body and
    per (label, radii) an ellipsoid organ near the centre (the later ones
    inside the first, as a tumour in its liver), mild noise; 0 outside the
    in-plane field of view."""
    import numpy as np
    z, y, x = np.meshgrid(*[np.linspace(-1, 1, s, dtype=np.float32) for s in shape],
                          indexing="ij")
    ct = np.full(shape, -1000.0, np.float32)
    seg = np.zeros(shape, np.uint8)
    ct[(z / 0.95) ** 2 + (y / 0.8) ** 2 + (x / 0.9) ** 2 < 1] = 40.0
    c = rng.uniform(-0.1, 0.1, 3)
    for label, radii in organs:
        inside = sum(((a - ci) / r) ** 2 for a, ci, r in zip((z, y, x), c, radii)) < 1
        ct[inside], seg[inside] = 60.0 + 40.0 * label, label
    ct += rng.standard_normal(shape, dtype=np.float32) * 15
    ct = ct.astype(np.int16)
    b = RAW_BORDER
    for region in ((slice(None), slice(None, b)), (slice(None), slice(-b, None)),
                   (slice(None), slice(None), slice(None, b)),
                   (slice(None), slice(None), slice(-b, None))):
        ct[region], seg[region] = 0, 0
    return ct, seg


def _write_raw_tasks(raw_base: str) -> dict:
    """RAW_TASKS as nnU-Net raw tasks (imagesTr, labelsTr, dataset.json from
    utils/dataset_json.py) under raw_base/nnUNet_raw_data, and one held-out
    Liver case under Task003's imagesTs. Returns {task: [case ids]} and the
    held-out case's image path."""
    import numpy as np
    from multitalent_tpu_torch.io import Geometry, write_nifti
    from multitalent_tpu_torch.utils.dataset_json import generate_dataset_json
    rng = np.random.default_rng(SEED + 30)
    cases, held_out = {}, None
    for task, (prefix, labels, organs) in RAW_TASKS.items():
        folder = os.path.join(raw_base, "nnUNet_raw_data", task)
        spacings = [(z, xy, xy) for z, xy in zip(RAW_Z_SPACINGS, RAW_XY_SPACINGS)]
        if task == "Task003_Liver":
            spacings.append(RAW_HELD_OUT_SPACING)
        cases[task] = []
        for i, spacing in enumerate(spacings):
            shape = tuple(int(round(e / s)) for e, s in zip(RAW_EXTENT_MM, spacing))
            ct, seg = _raw_phantom(rng, shape, organs)
            geometry = Geometry(spacing=spacing[::-1], origin=(-60.0, -70.0, 10.0 * i))
            case = f"{prefix}_{i:03d}"
            held = i == RAW_CASES
            images = os.path.join(folder, "imagesTs" if held else "imagesTr")
            os.makedirs(images, exist_ok=True)
            os.makedirs(os.path.join(folder, "labelsTr"), exist_ok=True)
            write_nifti(os.path.join(images, f"{case}_0000.nii.gz"), ct, geometry)
            if held:
                held_out = os.path.join(images, f"{case}_0000.nii.gz")
            else:
                write_nifti(os.path.join(folder, "labelsTr", f"{case}.nii.gz"), seg, geometry)
                cases[task].append(case)
        generate_dataset_json(os.path.join(folder, "dataset.json"),
                              os.path.join(folder, "imagesTr"),
                              os.path.join(folder, "imagesTs"), ("CT",), labels, task)
    return cases, held_out


def _need(*files: str) -> None:
    """Fail where a file that the next step reads is missing."""
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        raise AssertionError(f"missing: {missing}")


def _check_prediction(out_folder: str, image: str, regions=()) -> tuple:
    """The labelmap predicted for a raw image (and its region masks) has the
    raw case's shape and geometry; returns its labels and shape."""
    import numpy as np
    from multitalent_tpu_torch.io import read_nifti
    case = os.path.basename(image)[:-len("_0000.nii.gz")]
    ct, g = read_nifti(image)
    files = [os.path.join(out_folder, f"{case}.nii.gz")] + [
        os.path.join(out_folder, "individual", r, f"{case}.nii.gz") for r in regions]
    _need(*files)
    labels = None
    for f in files:
        seg, s = read_nifti(f)
        if seg.shape != ct.shape or not all(np.allclose(getattr(s, k), getattr(g, k))
                                            for k in ("spacing", "origin", "direction")):
            raise AssertionError(f"{f}: {seg.shape} {vars(s)} vs the raw case's {ct.shape} "
                                 f"{vars(g)}")
        labels = labels if labels is not None else sorted(np.unique(seg).tolist())
    return labels, ct.shape


def _train_counted(args: list, steps: int):
    """cli.train with every launch count set to 0 just before it: the
    trainer, its launches and peak memory; the launches must equal the
    trainer's per-step counts x the steps + per-forward counts x the
    validation batches + per-forward counts x the network calls of the
    validation (and of predict_next_stage after 3d_lowres), with A, B and C
    each launched; the losses finite."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    trainer, launches = _run_counted(lambda: train_main(args))
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    net = trainer.network
    per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
    calls = sum(t["net_calls"] for t in trainer.validation_timings)
    # after 3d_lowres, predict_next_stage's forwards of every case
    calls += sum(t["net_calls"] for t in getattr(trainer, "next_stage_timings", ()))
    expect = {k: a + b + c for (k, a), b, c in zip(
        _expect(per_step, trainer.step).items(),
        _expect(per_fwd, trainer.num_val_batches_per_epoch).values(),
        _expect(per_fwd, calls).values())}
    if (trainer.step != steps or launches != expect
            or any(launches[k] == 0 for k in ("conv3d_same", "conv3d_same_dual",
                                              "conv3d_same_wgrad"))):
        raise AssertionError(f"{args[1]}: {trainer.step} steps, launches {launches}, "
                             f"expected {expect}")
    losses = trainer.all_tr_losses + trainer.all_val_losses
    if not losses or not np.isfinite(losses).all():
        raise AssertionError(f"{args[1]}: losses {losses}")
    return trainer, launches, peak_gib, per_step, calls


def _steps_s(trainer) -> float:
    """Median seconds of the steps after the first two (warm-up)."""
    return _median(trainer.step_seconds[2:])


def _print_plan(label: str, plans_file: str) -> dict:
    from multitalent_tpu_torch.plans import load_plans
    plans = load_plans(plans_file)
    stages = {k: {"patch_size": list(s.patch_size), "num_pool_per_axis": s.num_pool_per_axis,
                  "batch_size": s.batch_size, "spacing": list(s.current_spacing),
                  "median_shape": list(s.median_patient_size_in_voxels)}
              for k, s in plans.plans_per_stage.items()}
    print(f"{label} planned {plans.num_stages} stage(s), base {plans.base_num_features} "
          f"features, data {plans.data_identifier}: "
          + "; ".join(f"stage {k}: patch {v['patch_size']}, pools {v['num_pool_per_axis']}, "
                      f"batch {v['batch_size']}, spacing {v['spacing']}, median shape "
                      f"{v['median_shape']}" for k, v in stages.items()))
    return {"num_stages": plans.num_stages, "base_num_features": plans.base_num_features,
            "stages": stages}


def phase_raw_generic(workdir: str) -> dict:
    """10a, the generic workflow from raw NIfTIs: write the raw set;
    `cli.plan_and_preprocess -t 3 --verify_dataset_integrity` (v21 planner);
    `cli.train 3d_fullres TrainerV2 Task003_Liver 0` for RAW_TRAIN_STEPS
    steps (splits_final.pkl made, fold 0 validated); `cli.consolidate_
    postprocessing -f 0`; `cli.find_best_configuration -m 3d_fullres -f 0`;
    `cli.predict` with the chosen configuration on the held-out raw case."""
    import torch
    from multitalent_tpu_torch.cli.consolidate_postprocessing import main as consolidate_main
    from multitalent_tpu_torch.cli.find_best_configuration import main as select_main
    from multitalent_tpu_torch.cli.plan_and_preprocess import main as plan_main
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.paths import default_plans_identifier
    from multitalent_tpu_torch.utils.fileops import load_json
    task = "Task003_Liver"
    root = os.path.join(workdir, "raw_workflows")
    env = {"nnUNet_raw_data_base": os.path.join(root, "raw"),
           "nnUNet_preprocessed": os.path.join(root, "preprocessed"),
           "RESULTS_FOLDER": os.path.join(root, "results_generic"),
           "MTTPU_MAX_EPOCHS": "1", "MTTPU_ITERS_PER_EPOCH": str(RAW_TRAIN_STEPS),
           "MTTPU_VAL_ITERS": "1", "MTTPU_SW_EXACT": "0", "MTTPU_FUSED_TRAIN": "0",
           "MTTPU_FUSED_NORM": "0"}
    seconds = {}
    with _env(**env):
        t0 = time.perf_counter()
        cases, held_out = _write_raw_tasks(env["nnUNet_raw_data_base"])
        seconds["write raw"] = time.perf_counter() - t0
        seconds.update(plan_main(["-t", "3", "--verify_dataset_integrity"])[task])
        prep = os.path.join(env["nnUNet_preprocessed"], task)
        plans_file = os.path.join(prep, f"{default_plans_identifier}_plans_3D.pkl")
        _need(plans_file, os.path.join(prep, "dataset_properties.pkl"))
        plan = _print_plan("10a, the v21 planner on Task003_Liver,", plans_file)
        fullres = plan["stages"][plan["num_stages"] - 1]
        chosen = {"base_num_features": plan["base_num_features"],
                  "num_pool_per_axis": fullres["num_pool_per_axis"],
                  "patch_size": fullres["patch_size"]}
        if chosen != RAW_LIVER_PLAN:
            raise AssertionError(f"the v21 planner chose {chosen}, not the Liver network "
                                 f"{RAW_LIVER_PLAN}")

        t0 = time.perf_counter()
        trainer, launches, peak_gib, per_step, val_calls = _train_counted(
            ["3d_fullres", "TrainerV2", task, "0", "--device", "cuda", "-gpus", "1"],
            RAW_TRAIN_STEPS)
        train_cli_s = time.perf_counter() - t0
        seconds["train steps"] = sum(trainer.step_seconds)
        seconds["validation"] = trainer.validation_seconds
        model = trainer.output_folder.rsplit(os.sep, 1)[0]
        val = os.path.join(trainer.output_folder, "validation_raw")
        _need(os.path.join(prep, "splits_final.pkl"),
              os.path.join(trainer.output_folder, "model_final_checkpoint.model"),
              os.path.join(val, "summary.json"))

        t0 = time.perf_counter()
        consolidate_main(["-t", task, "-f", "0"])
        _need(os.path.join(model, "postprocessing.json"))
        select_main(["-t", task, "-m", "3d_fullres", "-f", "0"])
        selection_file = os.path.join(env["RESULTS_FOLDER"], "nnUNet",
                                      f"model_selection_{task}.json")
        _need(selection_file)
        selection = load_json(selection_file)
        seconds["selection"] = time.perf_counter() - t0
        best = selection["best"]
        if best != "3d_fullres":
            raise AssertionError(f"find_best_configuration chose {best}")

        out = os.path.join(root, "predicted_generic")
        inp = os.path.dirname(held_out)
        t0 = time.perf_counter()
        timings, predict_launches = _run_counted(lambda: predict_main(
            ["-i", inp, "-o", out, "-t", task, "-m", best, "-f", "0", "--device", "cuda"]))
        seconds["predict"] = time.perf_counter() - t0
    per_fwd = trainer.network.kernel_launches_per_forward()
    calls = sum(t["net_calls"] for t in timings)
    if predict_launches != _expect(per_fwd, calls):
        raise AssertionError(f"10a predict: launches {predict_launches}, expected "
                             f"{_expect(per_fwd, calls)}")
    labels, shape = _check_prediction(out, held_out)
    if not set(labels) <= set(RAW_TASKS[task][1]):
        raise AssertionError(f"10a predicted labels {labels}")
    step_s = _steps_s(trainer)
    print(f"10a TrainerV2 on Task003_Liver: {trainer.step} steps of batch {trainer.batch_size} "
          f"at {tuple(int(p) for p in trainer.patch_size)}, losses "
          f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
          f"{[round(v, 4) for v in trainer.all_val_losses]} (val); seconds per step {step_s:.3f}"
          f" ({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak {peak_gib:.2f} GiB; "
          f"train CLI {train_cli_s:.1f} s; validation of {len(trainer.validation_timings)} case"
          f"(s) {trainer.validation_seconds:.2f} s ({val_calls} network calls)")
    print(f"10a launches: training { {k: v for k, v in launches.items() if v} } (a step "
          f"{per_step}); predict { {k: v for k, v in predict_launches.items() if v} } = per "
          f"forward {per_fwd} x {calls} calls; model selection {selection['results']}, best "
          f"{best}; the held-out case {os.path.basename(held_out)} predicted at {shape}, labels "
          f"{labels}")
    planning_s = sum(seconds[k] for k in ("verify", "crop", "analyze", "plan", "preprocess"))
    print("10a host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; planning + preprocessing per case {planning_s / RAW_CASES:.2f}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "predict_launches": predict_launches, "seconds": seconds,
            "seconds_per_step": step_s, "peak_gib": peak_gib, "plan": plan, "env": env,
            "cases": cases, "held_out": held_out, "per_step": per_step}


def phase_raw_multitalent(workdir: str, generic: dict) -> dict:
    """10b, the flagship from raw data, on 10a's raw set: `tasks.convert_
    task100 --tasks Task003_Liver Task009_Spleen`; `cli.plan_and_preprocess
    -t 100 -pl3d ExperimentPlanner3D_v21_MultiTalent -pl2d None`;
    `tasks.convert_task100 --addregions-only`; `cli.train 3d_fullres
    MultiTalent_trainer_ddp Task100_MultiTalent 0 -p MultiTalent_bs4` for
    RAW_TRAIN_STEPS steps at the plans' batch of 4, 47 heads, and its
    validation; `cli.predict_multitalent` on the held-out case."""
    import torch
    from multitalent_tpu_torch.cli.plan_and_preprocess import main as plan_main
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.data.dataset import kfold_split
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.tasks.convert_task100 import main as convert_main
    from multitalent_tpu_torch.utils.fileops import load_pickle, save_pickle
    task = "Task100_MultiTalent"
    root = os.path.join(workdir, "raw_workflows")
    env = {**generic["env"], "RESULTS_FOLDER": os.path.join(root, "results_multitalent")}
    seconds = {}
    with _env(**env):
        t0 = time.perf_counter()
        convert_main(["--tasks", *RAW_TASKS])
        seconds["convert"] = time.perf_counter() - t0
        raw = os.path.join(env["nnUNet_raw_data_base"], "nnUNet_raw_data", task)
        _need(os.path.join(raw, "dataset.json"),
              os.path.join(raw, "cases_have_regions_labels.pkl"))
        seconds.update(plan_main(["-t", "100", "-pl3d", "ExperimentPlanner3D_v21_MultiTalent",
                                  "-pl2d", "None"])[task])
        prep = os.path.join(env["nnUNet_preprocessed"], task)
        plans_file = os.path.join(prep, "MultiTalent_bs4_plans_3D.pkl")
        _need(plans_file)
        plan = _print_plan("10b, the MultiTalent planner on Task100_MultiTalent,", plans_file)
        t0 = time.perf_counter()
        convert_main(["--addregions-only"])
        seconds["stamp"] = time.perf_counter() - t0
        stage = os.path.join(prep, "MultiTalent_data_stage0")
        for task_cases in generic["cases"].values():
            for case in task_cases:
                key = f"{'003' if case.startswith('liver') else '009'}_{case}"
                _need(os.path.join(stage, key + ".pkl"))
                if "valid_regions" not in load_pickle(os.path.join(stage, key + ".pkl")):
                    raise AssertionError(f"{key}: no valid_regions stamped")
        # MultiTalent's do_split stitches each source task's splits_final.pkl:
        # Task003's was written by 10a's TrainerV2; Task009 was never trained
        # alone, so its file is written here with the port's kfold_split, as
        # TrainerV2 would write it
        spleen = os.path.join(env["nnUNet_preprocessed"], "Task009_Spleen")
        os.makedirs(spleen, exist_ok=True)
        save_pickle(kfold_split(generic["cases"]["Task009_Spleen"]),
                    os.path.join(spleen, "splits_final.pkl"))
        _need(os.path.join(env["nnUNet_preprocessed"], "Task003_Liver", "splits_final.pkl"))

        t0 = time.perf_counter()
        trainer, launches, peak_gib, per_step, val_calls = _train_counted(
            ["3d_fullres", "MultiTalent_trainer_ddp", task, "0", "-p", "MultiTalent_bs4",
             "--device", "cuda", "-gpus", "1"], RAW_TRAIN_STEPS)
        train_cli_s = time.perf_counter() - t0
        if trainer.batch_size != 4 or trainer.num_classes != 47:
            raise AssertionError(f"batch {trainer.batch_size}, {trainer.num_classes} heads")
        seconds["train steps"] = sum(trainer.step_seconds)
        seconds["validation"] = trainer.validation_seconds
        model = trainer.output_folder.rsplit(os.sep, 1)[0]
        _need(os.path.join(prep, "splits_custom.pkl"),
              os.path.join(trainer.output_folder, "model_final_checkpoint.model"),
              *(os.path.join(trainer.output_folder, "validation_raw", f"summary_{t}.json")
                for t in RAW_TASKS))

        out = os.path.join(root, "predicted_multitalent")
        held_out = generic["held_out"]
        t0 = time.perf_counter()
        timings, predict_launches = _run_counted(lambda: predict_main(
            ["-i", os.path.dirname(held_out), "-o", out, "-m", model, "-f", "0",
             "--device", "cuda"]))
        seconds["predict"] = time.perf_counter() - t0
    per_fwd = trainer.network.kernel_launches_per_forward()
    calls = sum(t["net_calls"] for t in timings)
    if predict_launches != _expect(per_fwd, calls):
        raise AssertionError(f"10b predict: launches {predict_launches}, expected "
                             f"{_expect(per_fwd, calls)}")
    labels, shape = _check_prediction(out, held_out, REGIONS)
    step_s = _steps_s(trainer)
    print(f"10b MultiTalent_trainer_ddp on Task100_MultiTalent: {trainer.step} steps of batch "
          f"{trainer.batch_size} at {tuple(int(p) for p in trainer.patch_size)}, "
          f"{trainer.num_classes} heads, losses {[round(v, 4) for v in trainer.all_tr_losses]} "
          f"(train), {[round(v, 4) for v in trainer.all_val_losses]} (val); seconds per step "
          f"{step_s:.3f} ({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak "
          f"{peak_gib:.2f} GiB; train CLI {train_cli_s:.1f} s; validation of "
          f"{len(trainer.validation_timings)} cases {trainer.validation_seconds:.2f} s "
          f"({val_calls} network calls)")
    print(f"10b launches: training { {k: v for k, v in launches.items() if v} } (a step "
          f"{per_step}); predict { {k: v for k, v in predict_launches.items() if v} } = per "
          f"forward {per_fwd} x {calls} calls; the held-out case predicted at {shape} with "
          f"{len(REGIONS)} region masks, labels {labels}")
    planning_s = sum(seconds[k] for k in ("crop", "analyze", "plan", "preprocess"))
    print("10b host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items())
          + f"; planning + preprocessing per case {planning_s / (2 * RAW_CASES):.2f}")
    del trainer
    torch.cuda.empty_cache()
    return {"launches": launches, "predict_launches": predict_launches, "seconds": seconds,
            "seconds_per_step": step_s, "peak_gib": peak_gib, "plan": plan,
            "per_step": per_step}


def _swin_net(num_classes: int = 47, seed: int = SEED, dtype=None, patch=PATCH):
    """SwinUNETR at the trainers' width with their init from `seed`."""
    import torch
    from multitalent_tpu_torch.models.swin_unetr import SwinUNETR
    net = SwinUNETR(1, num_classes, patch, dtype=dtype or torch.float32)
    net.init_weights(torch.Generator().manual_seed(seed))
    return net


def phase_swin_training(workdir: str) -> dict:
    """11a: cli.train with MultiTalent_trainer_SwinUNETR_ddp_adam on phase
    5's synthetic MultiTalent cases at the flagship's plans (SWIN_TRAIN_STEPS
    steps, then the validation of one case a dataset, default mode): finite
    losses, every weight moved, the A/B/C counts exactly the trainer's (16 A
    and 5 B a forward), one step's dw through kernel C against the plain
    version."""
    import numpy as np
    import torch
    task = "Task100_MultiTalent"
    results = os.path.join(workdir, "results_swin")
    with _env(nnUNet_preprocessed=os.path.join(workdir, "preprocessed"), RESULTS_FOLDER=results,
              MTTPU_MAX_EPOCHS="1", MTTPU_ITERS_PER_EPOCH=str(SWIN_TRAIN_STEPS),
              MTTPU_VAL_ITERS="1", MTTPU_SW_EXACT="0", MTTPU_FUSED_TRAIN="0",
              MTTPU_FUSED_NORM="0"):
        t0 = time.perf_counter()
        trainer, launches, peak_gib, per_step, calls = _train_counted(
            ["3d_fullres", SWIN_TRAINER, task, "0", "--device", "cuda", "-gpus", "1"],
            SWIN_TRAIN_STEPS)
        train_s = time.perf_counter() - t0
        net = trainer.network
        per_fwd = net.kernel_launches_per_forward()
        if per_fwd != SWIN_PER_FORWARD or per_step != SWIN_PER_STEP:
            raise AssertionError(f"SwinUNETR launches a forward {per_fwd}, a step {per_step}")
        validation = _check_validation(os.path.join(trainer.output_folder, "validation_raw"),
                                       trainer)
        still = _unmoved(net, _swin_net(seed=trainer.seed))
        if still:
            raise AssertionError(f"SwinUNETR weights that did not move: {still}")
        median_s = float(np.median(trainer.step_seconds[2:]))
        print(f"SwinUNETR training ({SWIN_TRAINER}): {trainer.step} steps of batch "
              f"{TRAIN_BATCH} at {PATCH}, bf16, feature_size {net.feature_size}, "
              f"{sum(p.numel() for p in net.parameters()):,} parameters; losses "
              f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
              f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
        print(f"SwinUNETR seconds per step: median {median_s:.3f} of steps 3..{trainer.step} "
              f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
              f"{peak_gib:.2f} GiB; train CLI {train_s:.1f} s")
        print(f"SwinUNETR training launches: { {k: v for k, v in launches.items() if v} } = "
              f"per step {per_step} x {trainer.step} + per forward {per_fwd} x "
              f"({trainer.num_val_batches_per_epoch} validation batch + {calls} validation "
              f"network calls)")
        print(f"SwinUNETR validation: {validation['seconds_per_case']:.2f} s per case (predict "
              f"{validation['predict_s']} s); Dice "
              f"{ {k: round(v, 4) for k, v in validation['dice'].items()} }")
        dw_worst, dw_shapes, a_shapes, b_shapes, _ = _check_dw_through_kernels(trainer)
    for name, shapes in (("conv3d_same", a_shapes), ("conv3d_same_dual", b_shapes)):
        if sum(shapes.values()) != per_step[name]:
            raise AssertionError(f"SwinUNETR: {sum(shapes.values())} {name} calls in one step, "
                                 f"expected {per_step[name]}")
    model = os.path.dirname(trainer.output_folder)
    out = {"launches": launches, "seconds_per_step": median_s, "step_s": trainer.step_seconds,
           "peak_gib": peak_gib, "validation": validation, "dw_worst_rel": dw_worst,
           "dw_shapes": dw_shapes, "a_shapes": a_shapes, "b_shapes": b_shapes,
           "per_forward": per_fwd, "per_step": per_step, "model": model,
           "fold": trainer.output_folder, "plans": trainer.plans}
    del trainer, net
    torch.cuda.empty_cache()
    return out


def phase_swin_predict(workdir: str, training: dict) -> dict:
    """11b: predict_multitalent from 11a's folder on phase 3's case, default
    mode with mirror TTA: exact launches, the labelmap and all 47 masks at
    the raw case's shape and geometry."""
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.inference.predict import REGIONS
    n_tiles, _ = _case_tiles()
    out = os.path.join(workdir, "out_swin")
    with _env(MTTPU_SW_EXACT="0", MTTPU_FUSED_NORM="0"):
        t0 = time.perf_counter()
        timings, launches = _run_counted(lambda: predict_main(
            ["-i", os.path.join(workdir, "in"), "-o", out, "-m", training["model"], "-f", "0",
             "--device", "cuda"]))
        wall = time.perf_counter() - t0
    (case,) = timings
    expect = _expect(training["per_forward"], case["net_calls"])
    if case["forwards"] != n_tiles * 8 or launches != expect:
        raise AssertionError(f"SwinUNETR predict: {case}, launches {launches}, expected {expect}")
    _, shape = _check_prediction(out, os.path.join(workdir, "in", "case_0000.nii.gz"), REGIONS)
    print(f"SwinUNETR predict ({case['forwards']} forwards in {case['net_calls']} network calls): "
          f"labelmap + {len(REGIONS)} region NIfTIs at {shape} with the case's geometry; "
          f"launches { {k: v for k, v in launches.items() if v} } = per forward "
          f"{training['per_forward']} x {case['net_calls']}; seconds per case {wall:.2f} "
          f"(predict {case['predict_s']:.2f} on the card's clock, export {case['export_s']:.2f})")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "net_calls": case["net_calls"]}


@contextlib.contextmanager
def _zero_shift_masks(net):
    """Every shifted block's cached shift mask with its -100 set to 0 (the
    control of phase 11c)."""
    import torch
    from multitalent_tpu_torch.models.swin_unetr import SwinBlock
    blocks = [m for m in net.modules() if isinstance(m, SwinBlock) and m.shift]
    saved = [b._masks for b in blocks]
    for b in blocks:
        b._masks = {k: torch.zeros_like(v) for k, v in b._masks.items()}
    try:
        yield len(blocks)
    finally:
        for b, masks in zip(blocks, saved):
            b._masks = masks


def phase_swin_tile() -> dict:
    """11c: one SwinUNETR tile's sigmoid probabilities through the kernels in
    bf16 against the plain versions in bf16 and in fp32; the control (the
    shift masks' -100 set to 0) must break the bf16 bounds. The trainers'
    init from the seed."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    net = _swin_net(dtype=torch.bfloat16).to(dev).eval()
    net32 = _swin_net(dtype=torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with torch.no_grad(), _recording("conv3d_same") as a_shapes, \
            _recording("conv3d_same_dual") as b_shapes:
        logits = net(x)
    if (sum(a_shapes.values()), sum(b_shapes.values())) != (16, 5):
        raise AssertionError(f"SwinUNETR forward: A {sum(a_shapes.values())}, B "
                             f"{sum(b_shapes.values())} calls, expected 16 and 5")
    if logits.shape != (1, 47, *PATCH) or not torch.isfinite(logits).all():
        raise AssertionError(f"SwinUNETR logits {tuple(logits.shape)}")
    with torch.no_grad():
        p_kernels = torch.sigmoid(logits)
        p_plain = torch.sigmoid(net(x, use_kernels=False))
        out = {"a_shapes": a_shapes, "b_shapes": b_shapes}
        out["bf16_max"], out["bf16_mean"] = _dp(p_kernels, p_plain)
        out["fp32_max"], out["fp32_mean"] = _dp(p_kernels, torch.sigmoid(
            net32(x, use_kernels=False)))
        with _zero_shift_masks(net) as shifted:
            out["control_max"], out["control_mean"] = _dp(torch.sigmoid(net(x)), p_plain)
        out["forward_ms"] = _median_ms(lambda: net(x), iters=5)
    print(f"SwinUNETR tile {PATCH}: |dp| kernels bf16 vs plain bf16: max {out['bf16_max']:.3e} "
          f"(bound {SWIN_PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{SWIN_PROB_BOUND_MEAN}); vs plain fp32: max {out['fp32_max']:.3e} (bound "
          f"{SWIN_PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} (bound "
          f"{SWIN_PROB_BOUND_FP32_MEAN})")
    print(f"SwinUNETR control, the shift masks of {shifted} blocks at 0 for -100: kernels vs "
          f"plain |dp| max {out['control_max']:.3e}, mean {out['control_mean']:.3e}")
    print(f"one bf16 SwinUNETR forward of a tile: {out['forward_ms']:.2f} ms (median of 5, CUDA "
          f"events)")
    if not (out["bf16_max"] <= SWIN_PROB_BOUND and out["bf16_mean"] <= SWIN_PROB_BOUND_MEAN
            and out["fp32_max"] <= SWIN_PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= SWIN_PROB_BOUND_FP32_MEAN):
        raise AssertionError(f"SwinUNETR probabilities out of bounds: {out}")
    if not (out["control_max"] > SWIN_PROB_BOUND or out["control_mean"] > SWIN_PROB_BOUND_MEAN):
        raise AssertionError(f"the SwinUNETR bounds pass a faulty shift mask: {out}")
    del net, net32, logits, p_kernels, p_plain
    torch.cuda.empty_cache()
    return out


def phase_swin_jax_folder(workdir: str, training: dict) -> dict:
    """11d: 11a's weights as a JAX-layout folder (the flax tree of
    io/torch_convert.convert_swin_unetr_state_dict), restored on the card
    (timed): every tensor bit-equal to the `.model`'s."""
    import torch
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               save_jax_model_folder)
    sd = torch.load(os.path.join(training["fold"], "model_final_checkpoint.model"),
                    map_location="cpu", weights_only=False)["state_dict"]
    model = os.path.join(workdir, "jax_model_swin")
    save_jax_model_folder(model, training["plans"], [sd], "MultiTalentTrainerSwinUNETR",
                          trainer_bases=["MultiTalentTrainer", "TrainerV2", "NetworkTrainerBase"])
    ckpt = os.path.join(model, "fold_0", "model_final_checkpoint.ckpt")
    t0 = time.perf_counter()
    restored = load_model_and_checkpoint_files(model, [0], device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = restored.networks[0].state_dict()
    if (restored.inference_nonlin != "sigmoid" or sorted(got) != sorted(sd)
            or not all(torch.equal(v.cpu(), sd[k]) for k, v in got.items())):
        raise AssertionError("SwinUNETR weights restored from the .ckpt folder differ")
    print(f"SwinUNETR JAX-layout folder: {os.path.getsize(ckpt) / 2 ** 20:.1f} MiB .ckpt, "
          f"{len(sd)} tensors restored on the card bit-equal in {restore_s:.2f} s")
    del restored, got
    torch.cuda.empty_cache()
    return {"ckpt": ckpt, "restore_s": restore_s}


def phase_swin_warmup(workdir: str, jax_folder: dict) -> dict:
    """11e: the SwinUNETR head warm-up -pretrained_weights <11d's .ckpt> on
    phase 5e's one-class task, 2 steps of phase 1 and its validation: the
    backbone loads equal to the pretrained weights and stays bit-unchanged,
    only `out.*` moves, kernel C launches 0 times."""
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.model_restore import checkpoint_state_dict
    task = "Task009_Spleen"
    with _env(nnUNet_preprocessed=os.path.join(workdir, "preprocessed"),
              RESULTS_FOLDER=os.path.join(workdir, "results_swin_warmup"), MTTPU_MAX_EPOCHS="1",
              MTTPU_ITERS_PER_EPOCH="2", MTTPU_VAL_ITERS="1", MTTPU_SW_EXACT="0"):
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", SWIN_WARMUP_TRAINER, task, "0", "-pretrained_weights",
             jax_folder["ckpt"], "--device", "cuda", "-gpus", "1"]))
        wall = time.perf_counter() - t0
    pretrained = checkpoint_state_dict(jax_folder["ckpt"], trainer.plans, 0)
    init = _swin_net(trainer.num_classes, seed=trainer.seed).state_dict()
    for k, v in trainer.network.state_dict().items():
        v = v.cpu()
        if k.startswith("out."):
            if torch.equal(v, init[k]):
                raise AssertionError(f"SwinUNETR head {k} did not move")
        elif not torch.equal(v, pretrained[k]):
            raise AssertionError(f"SwinUNETR backbone {k} is not the pretrained weight")
    per = trainer.network.kernel_launches_per_forward()
    net_calls = sum(t["net_calls"] for t in trainer.validation_timings)
    calls = trainer.step + trainer.num_val_batches_per_epoch + net_calls
    expect = _expect(per, calls)
    if trainer.step != 2 or trainer.optimizer_phase != 1 or launches != expect:
        raise AssertionError(f"SwinUNETR warm-up: {trainer.step} steps, phase "
                             f"{trainer.optimizer_phase}, launches {launches}, expected {expect}")
    print(f"SwinUNETR warm-up ({SWIN_WARMUP_TRAINER}, phase 1, -pretrained_weights .ckpt): "
          f"seconds per step {', '.join(f'{v:.3f}' for v in trainer.step_seconds)}; kernel C "
          f"launches {launches['conv3d_same_wgrad']}; launches "
          f"{ {k: v for k, v in launches.items() if v} } = per forward {per} x {calls} "
          f"({trainer.step} steps + {trainer.num_val_batches_per_epoch} validation batch + "
          f"{net_calls} validation network calls); backbone bit-equal to the pretrained "
          f"weights, out.* moved; validation {trainer.validation_seconds:.2f} s for 1 case; "
          f"CLI {wall:.1f} s")
    out = {"launches": launches, "step_s": trainer.step_seconds, "wall": wall}
    del trainer
    torch.cuda.empty_cache()
    return out


def phase_swin_liver(workdir: str, generic: dict) -> dict:
    """11f: nnUNetTrainerV2_swinunetr_adam_ddp for 2 steps on phase 10a's
    preprocessed Task003_Liver (the v21 plans of the Liver network: 128^3, 3
    classes, softmax) with fold 0's validation, then cli.predict -tr of the
    held-out raw case."""
    import torch
    from multitalent_tpu_torch.cli.predict import main as predict_main
    task = "Task003_Liver"
    env = {**generic["env"], "RESULTS_FOLDER": os.path.join(workdir, "results_swin_liver"),
           "MTTPU_ITERS_PER_EPOCH": "2"}
    out = os.path.join(workdir, "predicted_swin_liver")
    with _env(**env):
        t0 = time.perf_counter()
        trainer, launches, peak_gib, per_step, val_calls = _train_counted(
            ["3d_fullres", SWIN_LIVER_TRAINER, task, "0", "--device", "cuda", "-gpus", "1"], 2)
        train_s = time.perf_counter() - t0
        per_fwd = trainer.network.kernel_launches_per_forward()
        patch = tuple(int(p) for p in trainer.patch_size)
        classes = trainer.num_classes
        del trainer
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        timings, predict_launches = _run_counted(lambda: predict_main(
            ["-i", os.path.dirname(generic["held_out"]), "-o", out, "-t", task, "-m",
             "3d_fullres", "-tr", SWIN_LIVER_TRAINER, "-f", "0", "--device", "cuda"]))
        predict_s = time.perf_counter() - t0
    calls = sum(t["net_calls"] for t in timings)
    if predict_launches != _expect(per_fwd, calls):
        raise AssertionError(f"11f predict: launches {predict_launches}, expected "
                             f"{_expect(per_fwd, calls)}")
    labels, shape = _check_prediction(out, generic["held_out"])
    if not set(labels) <= set(range(classes)):
        raise AssertionError(f"11f predicted labels {labels}")
    print(f"SwinUNETR on Task003_Liver ({SWIN_LIVER_TRAINER}, softmax over {classes} classes, "
          f"patch {patch}): 2 steps + validation in {train_s:.1f} s ({val_calls} validation "
          f"network calls), peak {peak_gib:.2f} GiB; launches "
          f"{ {k: v for k, v in launches.items() if v} } (a step {per_step}); cli.predict of "
          f"{os.path.basename(generic['held_out'])}: {predict_s:.2f} s, {calls} calls, launches "
          f"{ {k: v for k, v in predict_launches.items() if v} }, labels {labels} at {shape}")
    return {"launches": launches, "predict_launches": predict_launches, "peak_gib": peak_gib,
            "train_s": train_s, "predict_s": predict_s}


def _mednext_net(num_classes: int = 47, seed: int = SEED, dtype=None):
    """MedNeXt at the MultiTalent trainer's width with its init from `seed`."""
    import torch
    from multitalent_tpu_torch.models.mednext import MedNeXt
    net = MedNeXt(1, n_channels=32, n_classes=num_classes, dtype=dtype or torch.float32)
    net.init_weights(torch.Generator().manual_seed(seed))
    return net


def _no_launches(label: str, launches: dict) -> None:
    if any(launches.values()):
        raise AssertionError(f"{label}: hand-written kernels launched "
                             f"{ {k: v for k, v in launches.items() if v} }, expected none")


def _depthwise_share(trainer) -> dict:
    """One training step (forward with the per-block recompute, backward,
    SGD) of the trainer's network on a seeded batch under torch.profiler:
    the device time of the depthwise convs (weights (C, 1, k, k, k)) forward
    (aten::convolution, the recompute included) and backward
    (aten::convolution_backward), each the kernels under those ops, against
    the device time of every kernel of the step, its wall time and its
    three longest kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev = trainer.device
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    data = torch.randn(TRAIN_BATCH, 1, *PATCH, generator=gen, device=dev)
    targets = [torch.randint(0, 48, (TRAIN_BATCH, *(int(round(p * f)) for p, f in
                                                     zip(PATCH, scale))),
                             generator=gen, device=dev).float()
               for scale in trainer.deep_supervision_scales]
    valid = torch.ones(TRAIN_BATCH, 47, device=dev)

    def step():
        trainer.optimizer.zero_grad()
        loss, _ = trainer.loss_fn(trainer.network_forward(data, deep_supervision=True),
                                  targets, {"valid_region_mask": valid})
        loss.backward()
        trainer.optimizer.step(trainer.lr_schedule(trainer.step))

    step()  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(e, name: str) -> float:
        t = getattr(e, name.replace("cuda", "device"), None)
        return float(t if t is not None else getattr(e, name, 0.0))

    out = {"forward_ms": 0.0, "backward_ms": 0.0, "forward_calls": 0, "backward_calls": 0,
           "wall_ms": wall_ms}
    kernels = []
    for e in prof.key_averages(group_by_input_shape=True):
        if "CUDA" in str(getattr(e, "device_type", "")):
            kernels.append((device_us(e, "self_cuda_time_total") / 1e3, e.count, e.key))
            continue
        arg = {"aten::convolution": 1, "aten::convolution_backward": 2}.get(e.key)
        shapes = e.input_shapes or []
        if arg is None or len(shapes) <= arg:
            continue
        w = shapes[arg]
        if len(w) == 5 and w[1] == 1 and w[2] > 1:
            which = "forward" if arg == 1 else "backward"
            out[f"{which}_ms"] += device_us(e, "cuda_time_total") / 1e3
            out[f"{which}_calls"] += e.count
    out["step_device_ms"] = sum(k[0] for k in kernels)
    out["top"] = [(round(ms, 1), n, name[:90]) for ms, n, name in sorted(kernels)[::-1][:3]]
    return out


def phase_mednext_training(workdir: str) -> dict:
    """12a: cli.train with MultiTalent_meets_mednext on phase 5's synthetic
    MultiTalent cases at the flagship's plans (MEDNEXT_TRAIN_STEPS steps,
    then the validation of one case a dataset, default mode): finite
    losses, every weight moved but the head of loss weight 0 (out4), no
    hand-written kernel launched; seconds per step, peak memory, and the
    depthwise convs' share of a step's device time (torch.profiler)."""
    import torch
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.models.mednext import MedNeXt
    task = "Task100_MultiTalent"
    with _env(nnUNet_preprocessed=os.path.join(workdir, "preprocessed"),
              RESULTS_FOLDER=os.path.join(workdir, "results_mednext"), MTTPU_MAX_EPOCHS="1",
              MTTPU_ITERS_PER_EPOCH=str(MEDNEXT_TRAIN_STEPS), MTTPU_VAL_ITERS="1",
              MTTPU_SW_EXACT="0", MTTPU_FUSED_TRAIN="0", MTTPU_FUSED_NORM="0"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            ["3d_fullres", MEDNEXT_TRAINER, task, "0", "--device", "cuda", "-gpus", "1"]))
        train_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    net = trainer.network
    _no_launches("MedNeXt training", launches)
    losses = trainer.all_tr_losses + trainer.all_val_losses
    if (not isinstance(net, MedNeXt) or trainer.step != MEDNEXT_TRAIN_STEPS
            or not all(v == v and abs(v) < float("inf") for v in losses)):
        raise AssertionError(f"MedNeXt training: {type(net).__name__}, {trainer.step} steps, "
                             f"losses {losses}")
    validation = _check_validation(os.path.join(trainer.output_folder, "validation_raw"),
                                   trainer)
    still = _unmoved(net, _mednext_net(seed=trainer.seed), keep=("out4.weight",))
    if still:
        raise AssertionError(f"MedNeXt weights that did not move: {still}")
    model = os.path.dirname(trainer.output_folder)
    sd = {k: v.detach().cpu() for k, v in net.state_dict().items()}
    median_s = _steps_s(trainer)
    print(f"MedNeXt training ({MEDNEXT_TRAINER}): {trainer.step} steps of batch {TRAIN_BATCH} "
          f"at {PATCH}, bf16, n_channels {net.n_channels}, exp_r {net.exp_r}, blocks "
          f"{net.block_counts}, {sum(p.numel() for p in net.parameters()):,} parameters; "
          f"losses {[round(v, 4) for v in trainer.all_tr_losses]} (train), "
          f"{[round(v, 4) for v in trainer.all_val_losses]} (val)")
    print(f"MedNeXt seconds per step: median {median_s:.3f} of steps 3..{trainer.step} "
          f"({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak memory "
          f"{peak_gib:.2f} GiB; train CLI {train_s:.1f} s; hand-written kernel launches 0")
    print(f"MedNeXt validation: {validation['seconds_per_case']:.2f} s per case (predict "
          f"{validation['predict_s']} s, {validation['forwards']} forwards); Dice "
          f"{ {k: round(v, 4) for k, v in validation['dice'].items()} }")
    dw = _depthwise_share(trainer)
    step_ms = dw["step_device_ms"]
    if step_ms > 0:
        share = (f"forward {dw['forward_ms']:.1f} ms ({100 * dw['forward_ms'] / step_ms:.1f}%, "
                 f"{dw['forward_calls']} calls with the recompute), backward "
                 f"{dw['backward_ms']:.1f} ms ({100 * dw['backward_ms'] / step_ms:.1f}%, "
                 f"{dw['backward_calls']} calls) of the step's {step_ms:.1f} ms of device time "
                 f"(wall {dw['wall_ms']:.1f} ms under the profiler); longest kernels (ms, "
                 f"calls, name) {dw['top']}")
    else:
        share = "not measured (the profiler saw no device time)"
    print(f"MedNeXt depthwise convs in one profiled training step (torch.profiler): {share}")
    out = {"launches": launches, "seconds_per_step": median_s, "step_s": trainer.step_seconds,
           "peak_gib": peak_gib, "validation": validation, "model": model,
           "fold": trainer.output_folder, "plans": trainer.plans, "state_dict": sd,
           "depthwise": dw, "train_s": train_s}
    del trainer, net
    torch.cuda.empty_cache()
    return out


def phase_mednext_predict(workdir: str, training: dict) -> dict:
    """12b: 12a's folder restored on the card (every tensor bit-equal to
    the trained weights), the same weights as a JAX-layout `.ckpt` folder
    restored (timed, bit-equal), then predict_multitalent from the `.ckpt`
    folder on phase 3's case without mirror TTA (the 8 mirror combinations
    repeat each tile's shape; phases 3, 8b and 11b predict with them): exact
    forwards, no hand-written kernel launched, the labelmap and all 47
    masks at the raw case's shape and geometry."""
    import torch
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               save_jax_model_folder)
    from multitalent_tpu_torch.inference.predict import REGIONS
    from multitalent_tpu_torch.models.mednext import MedNeXt
    sd = training["state_dict"]
    jax_model = os.path.join(workdir, "jax_model_mednext")
    save_jax_model_folder(jax_model, training["plans"], [sd], "MultiTalentTrainerMedNeXt",
                          trainer_bases=["MultiTalentTrainer", "TrainerV2", "NetworkTrainerBase"])
    restore_s = {}
    for label, folder in ((".model", training["model"]), (".ckpt", jax_model)):
        t0 = time.perf_counter()
        restored = load_model_and_checkpoint_files(folder, [0], device="cuda")
        torch.cuda.synchronize()
        restore_s[label] = time.perf_counter() - t0
        (net,) = restored.networks
        got = net.state_dict()
        if (not isinstance(net, MedNeXt) or restored.inference_nonlin != "sigmoid"
                or sorted(got) != sorted(sd)
                or not all(torch.equal(v.cpu(), sd[k]) for k, v in got.items())):
            raise AssertionError(f"MedNeXt restored from the {label} folder differs")
        del restored, net, got
    n_tiles, _ = _case_tiles()
    out = os.path.join(workdir, "out_mednext")
    with _env(MTTPU_SW_EXACT="0", MTTPU_FUSED_NORM="0"):
        t0 = time.perf_counter()
        timings, launches = _run_counted(lambda: predict_main(
            ["-i", os.path.join(workdir, "in"), "-o", out, "-m", jax_model, "-f", "0",
             "--device", "cuda", "--disable_tta"]))
        wall = time.perf_counter() - t0
    (case,) = timings
    _no_launches("MedNeXt predict", launches)
    if case["forwards"] != n_tiles:
        raise AssertionError(f"MedNeXt predict: {case}, expected {n_tiles} tiles")
    _, shape = _check_prediction(out, os.path.join(workdir, "in", "case_0000.nii.gz"), REGIONS)
    ckpt = os.path.join(jax_model, "fold_0", "model_final_checkpoint.ckpt")
    print(f"MedNeXt restore: .model folder {restore_s['.model']:.2f} s, JAX-layout .ckpt "
          f"folder ({os.path.getsize(ckpt) / 2 ** 20:.1f} MiB) {restore_s['.ckpt']:.2f} s, "
          f"{len(sd)} tensors bit-equal to the trained weights in both")
    print(f"MedNeXt predict from the .ckpt folder ({case['forwards']} forwards = {n_tiles} "
          f"tiles, no mirror TTA, in {case['net_calls']} network calls): labelmap + {len(REGIONS)} region "
          f"NIfTIs at {shape} with the case's geometry; seconds per case {wall:.2f} (predict "
          f"{case['predict_s']:.2f} on the card's clock, export {case['export_s']:.2f}); "
          f"hand-written kernel launches 0")
    return {"launches": launches, "seconds_per_case": wall, "predict_s": case["predict_s"],
            "restore_s": restore_s}


def phase_mednext_tile() -> dict:
    """12c: one MedNeXt tile's sigmoid probabilities in bf16 against the same
    network in fp32 (TF32 off), the trainer's init from the seed; the tile
    forward's ms; no hand-written kernel launched."""
    import torch
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    net = _mednext_net(dtype=torch.bfloat16).to(dev).eval()
    net32 = _mednext_net(dtype=torch.float32).to(dev).eval()
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    x = torch.randn(1, 1, *PATCH, generator=gen, device=dev)
    with torch.no_grad():
        logits, launches = _run_counted(lambda: net(x))
        _no_launches("MedNeXt tile", launches)
        if logits.shape != (1, 47, *PATCH) or not torch.isfinite(logits).all():
            raise AssertionError(f"MedNeXt logits {tuple(logits.shape)}")
        out = {}
        out["fp32_max"], out["fp32_mean"] = _dp(torch.sigmoid(logits),
                                                torch.sigmoid(net32(x)))
        out["forward_ms"] = _median_ms(lambda: net(x), iters=5)
    print(f"MedNeXt tile {PATCH}: |dp| bf16 vs fp32: max {out['fp32_max']:.3e} (bound "
          f"{MEDNEXT_PROB_BOUND_FP32_MAX}), mean {out['fp32_mean']:.3e} (bound "
          f"{MEDNEXT_PROB_BOUND_FP32_MEAN})")
    print(f"one bf16 MedNeXt forward of a tile: {out['forward_ms']:.2f} ms (median of 5, CUDA "
          f"events)")
    if not (out["fp32_max"] <= MEDNEXT_PROB_BOUND_FP32_MAX
            and out["fp32_mean"] <= MEDNEXT_PROB_BOUND_FP32_MEAN):
        raise AssertionError(f"MedNeXt probabilities out of bounds: {out}")
    del net, net32, logits
    torch.cuda.empty_cache()
    return out


def _cascade_plans(generic: dict, root: str) -> tuple[str, dict]:
    """The two-stage plan of phase 13 under root/preprocessed/Task003_Liver:
    the v21 planner on 10a's cropped Liver data, its full-resolution stage as
    10a's, a lowres stage of its own get_properties_for_stage at
    CASCADE_LOWRES_FACTOR times the target spacing; both stages
    preprocessed by its run_preprocessing. Returns the folder and the host
    seconds of planning and preprocessing."""
    import numpy as np
    from multitalent_tpu_torch.paths import default_num_threads
    from multitalent_tpu_torch.planning.planners import resolve_planner
    task = "Task003_Liver"
    cropped = os.path.join(generic["env"]["nnUNet_raw_data_base"], "nnUNet_cropped_data", task)
    prep = os.path.join(root, "preprocessed", task)
    os.makedirs(prep)
    seconds = {}
    t0 = time.perf_counter()
    planner = resolve_planner("ExperimentPlanner3D_v21")(cropped, prep)
    plans = planner.plan_experiment()
    (full,) = plans["plans_per_stage"].values()
    low = planner.get_properties_for_stage(
        np.asarray(full["current_spacing"]) * CASCADE_LOWRES_FACTOR, full["current_spacing"],
        full["median_patient_size_in_voxels"], len(planner.list_of_cropped_npz_files),
        plans["num_modalities"], plans["num_classes"] + 1)
    planner.plans_per_stage = plans["plans_per_stage"] = {0: low, 1: full}
    plans["num_stages"] = 2
    planner.save_my_plans()
    seconds["plan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    planner.run_preprocessing((default_num_threads, default_num_threads))
    seconds["preprocess"] = time.perf_counter() - t0
    return prep, seconds


def phase_cascade(workdir: str, generic: dict) -> dict:
    """13: the 3d_lowres -> 3d_cascade_fullres workflow on phase 10a's
    Task003_Liver phantoms and the two-stage plan of _cascade_plans. 13a:
    cli.train 3d_lowres TrainerV2 fold 0 (CASCADE_TRAIN_STEPS steps, the
    validation, then predict_next_stage of every case into stage 1); 13b:
    cli.train 3d_cascade_fullres TrainerV2CascadeFullRes fold 0 (as many
    steps, the cascade validation); 13c: cli.predict -m 3d_lowres of the
    held-out raw case. Exact A/B/C counts of each; every case's
    segFromPrevStage file at its stage-1 shape; the prediction at the raw
    case's shape and geometry."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.paths import default_plans_identifier
    task = "Task003_Liver"
    root = os.path.join(workdir, "cascade")
    env = {**generic["env"], "nnUNet_preprocessed": os.path.join(root, "preprocessed"),
           "RESULTS_FOLDER": os.path.join(root, "results"),
           "MTTPU_ITERS_PER_EPOCH": str(CASCADE_TRAIN_STEPS)}
    seconds = {}
    with _env(**env):
        prep, seconds = _cascade_plans(generic, root)
        plan = _print_plan("13, the two-stage Liver plan,", os.path.join(
            prep, f"{default_plans_identifier}_plans_3D.pkl"))
        if plan["num_stages"] != 2:
            raise AssertionError(f"the cascade plan has {plan['num_stages']} stages")
        runs = {}
        for label, network, trainer_name in (("13a", "3d_lowres", "TrainerV2"),
                                             ("13b", "3d_cascade_fullres", CASCADE_TRAINER)):
            # 13a's launches include its predict_next_stage forwards
            t0 = time.perf_counter()
            trainer, launches, peak_gib, per_step, calls = _train_counted(
                [network, trainer_name, task, "0", "--device", "cuda", "-gpus", "1"],
                CASCADE_TRAIN_STEPS)
            cli_s = time.perf_counter() - t0
            net = trainer.network
            next_calls = sum(t["net_calls"] for t in getattr(trainer, "next_stage_timings", ()))
            runs[label] = {
                "what": f"{network} {trainer_name}", "launches": launches,
                "peak_gib": peak_gib, "per_step": per_step,
                "per_forward": net.kernel_launches_per_forward(), "calls": calls,
                "next_calls": next_calls, "cli_s": cli_s, "steps_s": _steps_s(trainer),
                "step_s": trainer.step_seconds, "stage": trainer.stage,
                "patch": tuple(int(p) for p in trainer.patch_size),
                "input_channels": net.input_channels, "validation_s": trainer.validation_seconds,
                "val_cases": len(trainer.validation_timings),
                "next_stage_s": sum(t["predict_s"] for t in getattr(trainer,
                                                                    "next_stage_timings", ())),
                "losses": (trainer.all_tr_losses, trainer.all_val_losses)}
            if label == "13a":
                stage1 = os.path.join(prep, trainer.plans.data_identifier + "_stage1")
                shapes = {}
                for key in sorted(trainer.dataset):
                    prev = np.load(os.path.join(stage1, f"{key}_segFromPrevStage.npz"))["data"]
                    data_shape = np.load(os.path.join(stage1, f"{key}.npz"))["data"].shape[1:]
                    if prev.dtype != np.uint8 or prev.shape[1:] != data_shape:
                        raise AssertionError(f"{key}: next stage {prev.dtype} {prev.shape}, "
                                             f"stage 1 {data_shape}")
                    shapes[key] = data_shape
                runs[label]["next_stage"] = {"cases": len(shapes),
                                             "labels": sorted(np.unique(prev).tolist())}
            else:
                cascade_plans, cascade_stage = trainer.plans, trainer.stage
                _need(os.path.join(trainer.output_folder, "validation_raw", "summary.json"))
            del trainer, net
            torch.cuda.empty_cache()
        out = os.path.join(root, "predicted_lowres")
        t0 = time.perf_counter()
        timings, predict_launches = _run_counted(lambda: predict_main(
            ["-i", os.path.dirname(generic["held_out"]), "-o", out, "-t", task, "-m",
             "3d_lowres", "-tr", "TrainerV2", "-f", "0", "--device", "cuda"]))
        seconds["predict lowres"] = time.perf_counter() - t0
    calls = sum(t["net_calls"] for t in timings)
    expect = _expect(runs["13a"]["per_forward"], calls)
    if predict_launches != expect:
        raise AssertionError(f"13c predict: launches {predict_launches}, expected {expect}")
    labels, shape = _check_prediction(out, generic["held_out"])
    if not set(labels) <= {0, 1, 2}:
        raise AssertionError(f"13c predicted labels {labels}")
    tile = _cascade_tile(cascade_plans, cascade_stage)
    for label, r in runs.items():
        print(f"{label} {r['what']}: stage {r['stage']}, patch {r['patch']}, "
              f"{r['input_channels']} input channels; {CASCADE_TRAIN_STEPS} steps, losses "
              f"{[round(v, 4) for v in r['losses'][0]]} (train), "
              f"{[round(v, 4) for v in r['losses'][1]]} (val); seconds per step "
              f"{', '.join(f'{v:.3f}' for v in r['step_s'])}; peak {r['peak_gib']:.2f} GiB; "
              f"validation of {r['val_cases']} case(s) {r['validation_s']:.2f} s; CLI "
              f"{r['cli_s']:.1f} s")
        print(f"{label} launches: { {k: v for k, v in r['launches'].items() if v} } = a step "
              f"{r['per_step']} x {CASCADE_TRAIN_STEPS} + a forward {r['per_forward']} x (1 "
              f"validation batch + {r['calls'] - r['next_calls']} validation network calls"
              + (f" + {r['next_calls']} next-stage network calls" if r["next_calls"] else "")
              + ")")
    print(f"13a predict_next_stage: {runs['13a']['next_stage']['cases']} cases at the stage-1 "
          f"grid in {runs['13a']['next_stage_s']:.2f} s on the card's clock, labels "
          f"{runs['13a']['next_stage']['labels']} (last case)")
    print(f"13c cli.predict -m 3d_lowres of {os.path.basename(generic['held_out'])}: "
          f"{seconds['predict lowres']:.2f} s, {calls} network calls, launches "
          f"{ {k: v for k, v in predict_launches.items() if v} } = a forward "
          f"{runs['13a']['per_forward']} x {calls}; labels {labels} at {shape}")
    print("13 host seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"runs": runs, "predict_launches": predict_launches, "seconds": seconds,
            "plan": plan, "tile": tile}


def _cascade_tile(plans, stage: int) -> dict:
    """13d: one tile of the cascade's full-resolution network (the image and
    the previous stage's two one-hots, He init from the seed): softmax
    probabilities through the kernels in bf16 against the plain versions
    in bf16, within phase 4's bounds; the first conv (3 input channels)
    stays on cuDNN."""
    import torch
    from multitalent_tpu_torch.models.generic_unet import build_unet_from_plans
    from multitalent_tpu_torch.training.trainers import init_weights_he
    dev = torch.device("cuda")
    net = build_unet_from_plans(plans, stage, num_classes=plans.num_classes + 1,
                                input_channels=plans.num_modalities + plans.num_classes)
    init_weights_he(net, torch.Generator().manual_seed(SEED))
    net = net.to(dev).eval()
    patch = tuple(int(p) for p in plans.stage(stage).patch_size)
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    prev = torch.randint(0, plans.num_classes + 1, (1, *(p // 8 for p in patch)),
                         generator=gen, device=dev)
    prev = torch.nn.functional.interpolate(prev[:, None].float(), size=patch)[:, 0]
    x = torch.cat([torch.randn(1, 1, *patch, generator=gen, device=dev),
                   *[(prev == c)[:, None].float() for c in range(1, plans.num_classes + 1)]], 1)
    first = net.conv_blocks_context[0].blocks[0].conv
    with torch.no_grad(), _recording("conv3d_same") as a_shapes, \
            _recording("conv3d_same_dual") as b_shapes:
        p_kernels = torch.softmax(net(x), 1)
    per = net.kernel_launches_per_forward()
    if (first.route is not None or sum(a_shapes.values()) != per["conv3d_same"]
            or sum(b_shapes.values()) != per["conv3d_same_dual"]):
        raise AssertionError(f"cascade tile: first conv route {first.route}, A "
                             f"{sum(a_shapes.values())}, B {sum(b_shapes.values())}, per "
                             f"forward {per}")
    with torch.no_grad():
        p_plain = torch.softmax(net(x, use_kernels=False), 1)
    out = {}
    out["bf16_max"], out["bf16_mean"] = _dp(p_kernels, p_plain)
    print(f"13d cascade tile {patch} (input {x.shape[1]} channels, first conv "
          f"on cuDNN, {per} kernel launches): |dp| kernels vs plain bf16 max "
          f"{out['bf16_max']:.3e} (bound {PROB_BOUND}), mean {out['bf16_mean']:.3e} (bound "
          f"{PROB_BOUND_MEAN})")
    if not (out["bf16_max"] <= PROB_BOUND and out["bf16_mean"] <= PROB_BOUND_MEAN):
        raise AssertionError(f"cascade tile out of bounds: {out}")
    del net, x
    torch.cuda.empty_cache()
    return out

def _fp32_bound(cin: int, cout: int, spatial, n: int) -> dict:
    """An fp32 SAME 3x3x3 conv's (or its dw's) bound: 2*27*Cin*Cout fp32
    CUDA-core FLOPs per voxel; fp32 inputs and output read or written once."""
    vox = n * prod(spatial)
    return _bound(4 * (vox * (cin + cout) + 27 * cin * cout),
                  fp32_flops=2 * 27 * cin * cout * vox)


def phase_fp32_kernels() -> dict:
    """14a: the fp32 forms of A, B and C against their plain fp32 versions
    (TF32 off) at phase 10a's Liver shapes and the training batch, each into
    a NaN-filled buffer; the median of FP32_ITERS launches beside the plain
    version's, cuDNN's fp32 call (TF32 off; B's on the concat built
    beforehand) and the bound."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 40)
    n, sp = TRAIN_BATCH, FP32_SPATIAL
    rows = {}
    for name, splits, cout in FP32_SHAPES:
        cin = sum(splits)
        ins = [torch.randn(n, *sp, c, generator=gen, device=dev) for c in splits]
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        if name == "conv3d_same_wgrad":
            g = torch.randn(n, *sp, cout, generator=gen, device=dev)
            g_cl = g.permute(0, 4, 1, 2, 3)
            shape = (cout, cin, 3, 3, 3)
            out = torch.full(shape, float("nan"), device=dev)

            def kernel():
                return cv.conv3d_same_wgrad(*ins, g)

            def plain():
                return cv.conv3d_same_wgrad_ref(*ins, g)

            def library():
                return torch.nn.grad.conv3d_weight(x_cl, shape, g_cl, padding=1)

            got = cv.conv3d_same_wgrad(*ins, g, out=out)
        else:
            w = torch.randn(cout, cin, 3, 3, 3, generator=gen, device=dev) * (2 / (27 * cin)) ** 0.5
            bias = torch.randn(cout, generator=gen, device=dev) * 0.1
            pw = cv.prepare_conv3d_weight(w, splits if len(splits) == 2 else None, torch.float32)
            wrap = getattr(cv, name)
            ref_fn = cv.conv3d_same_dual_ref if len(splits) == 2 else cv.conv3d_same_ref
            w_cl = w.contiguous(memory_format=torch.channels_last_3d)
            out = torch.full((n, *sp, cout), float("nan"), device=dev)

            def kernel():
                return wrap(*ins, pw, bias)

            def plain():
                return ref_fn(*ins, w, bias)

            def library():
                return F.conv3d(x_cl, w_cl, bias, padding=1)

            got = wrap(*ins, pw, bias, out=out)
        ref = plain()
        err = _check(f"{name} fp32 {'+'.join(map(str, splits))}->{cout} at {sp} N={n}", got,
                     ref, FP32_RTOL * ref.abs().max().item())
        del got, ref, out
        row = {"splits": splits, "cout": cout, "spatial": sp, "n": n, "err": err,
               "rel_err": err / max(plain().abs().max().item(), 1e-30),
               "ms": _median_ms(kernel, FP32_ITERS), "plain_ms": _median_ms(plain, FP32_ITERS),
               "cudnn_fp32_ms": _median_ms(library, FP32_ITERS), **_fp32_bound(cin, cout, sp, n)}
        if name == "conv3d_same_wgrad":
            plan = cv.conv3d_same_wgrad_fp32_plan(n, *sp, splits[0], 0, cout)
            row["write"] = ("direct" if plan["splits"] == 1 else
                            f"{plan['splits']} splits + reduce")
        rows[name + "_fp32"] = row
        tflops = 2 * 27 * cin * cout * n * prod(sp) / (row["ms"] * 1e9)
        print(f"14a {name} fp32 {'+'.join(map(str, splits))}->{cout} at "
              f"{'x'.join(map(str, sp))} N={n}: max|d| {err:.3e} (relative "
              f"{row['rel_err']:.2e}, bound {FP32_RTOL:.0e}); kernel {row['ms']:.3f} ms "
              f"({tflops:.1f} TFLOP/s), plain {row['plain_ms']:.3f} ms, cuDNN fp32 "
              f"{row['cudnn_fp32_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
              f"({row['bound_by']}){', ' + row['write'] if 'write' in row else ''}")
        del ins, x_cl
    torch.cuda.empty_cache()
    rows["ab_shapes"] = _fp32_ab_shapes(gen)
    rows["wgrad_shapes"] = _fp32_wgrad_shapes(gen)
    return rows


def _fp32_timed(row: dict, kernel, library, again, buffers, what: str) -> dict:
    """A 14a row's times (single-call median of FP32_ITERS and queued, the
    library call's beside), its share of the bound, and a repeat into
    NaN-refilled buffers bit-equal to the first call."""
    import torch
    first = [b.clone() for b in buffers]
    for b in buffers:
        b.fill_(float("nan"))
    again()
    if not all(torch.equal(a, b) for a, b in zip(first, buffers)):
        raise AssertionError(f"14a {what}: two calls differ")
    row.update(bit_equal=True, ms=_median_ms(kernel, FP32_ITERS), queued_ms=_queued_ms(kernel, 20))
    if library is not None:
        row.update(library_ms=_median_ms(library, FP32_ITERS),
                   library_queued_ms=_queued_ms(library, 20))
    row["share_of_bound"] = row["bound_ms"] / row["queued_ms"]
    return row


def _fp32_wgrad_shapes(gen) -> list:
    """14a: kernel C's fp32 form (the wgrad ring body) at every dw call of
    one Liver fp32 step at batch 2 and the flagship's 30 -> 30 and 30 + 30
    -> 30 at N=2 (probes/fp32_forms.py's WGRAD_ shapes): each into a
    NaN-filled dw within FP32_RTOL of the plain fp32 version, a bit-equal
    repeat, its single-call median and queued time beside
    torch.nn.grad.conv3d_weight's (TF32 off; the dual form's on the concat
    built beforehand), the bound, the share of it and the plan."""
    import torch
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.probes.fp32_forms import WGRAD_FLAGSHIP_SHAPES, WGRAD_STEP_SHAPES
    dev = torch.device("cuda")
    rows = []
    for n, sp, ca, cb, cout in WGRAD_STEP_SHAPES + WGRAD_FLAGSHIP_SHAPES:
        splits = (ca, cb) if cb else (ca,)
        ins = [torch.randn(n, *sp, c, generator=gen, device=dev) for c in splits]
        g = torch.randn(n, *sp, cout, generator=gen, device=dev)
        dw = torch.full((cout, ca + cb, 3, 3, 3), float("nan"), device=dev)
        wrap = cv.conv3d_same_wgrad_dual if cb else cv.conv3d_same_wgrad
        ref = (cv.conv3d_same_wgrad_dual_ref if cb else cv.conv3d_same_wgrad_ref)(*ins, g)
        what = f"C {'+'.join(map(str, splits))}->{cout} at {'x'.join(map(str, sp))} N={n}"
        top = ref.abs().max().item()
        err = _check(f"14a {what}", wrap(*ins, g, out=dw), ref, FP32_RTOL * top)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        g_cl = g.permute(0, 4, 1, 2, 3)
        plan = cv.conv3d_same_wgrad_fp32_plan(n, *sp, ca, cb, cout)
        row = {"at": what, "form": "C dual" if cb else "C", "splits": list(splits),
               "cout": cout, "spatial": list(sp), "n": n, "err": err,
               "rel_err": err / max(top, 1e-30), **_fp32_bound(ca + cb, cout, sp, n),
               "plan": {k: plan[k] for k in ("box", "tiles", "splits", "grid", "stages")}}
        _fp32_timed(row, lambda: wrap(*ins, g, out=dw),
                    lambda: torch.nn.grad.conv3d_weight(x_cl, (cout, ca + cb, 3, 3, 3), g_cl,
                                                        padding=1),
                    lambda: wrap(*ins, g, out=dw), [dw], what)
        rows.append(row)
        print(f"14a {what}: max|d| {err:.3e} (relative {row['rel_err']:.2e}); wgrad ring "
              f"{row['ms']:.3f} ms, queued {row['queued_ms']:.3f} ({row['share_of_bound']:.0%} "
              f"of the bound {row['bound_ms']:.3f} ms); conv3d_weight fp32 "
              f"{row['library_ms']:.3f}, queued {row['library_queued_ms']:.3f}; bit-equal "
              f"repeat; plan {row['plan']}")
        del ins, g, dw, ref, x_cl, g_cl
    torch.cuda.empty_cache()
    step = _fp32_step_sums("kernel C's fp32 form", rows)
    return {"shapes": rows, **step}


def _fp32_step_sums(label: str, rows: list) -> dict:
    """The queued times of one Liver fp32 step's launches at batch 2 from
    the rows of its distinct shapes: each single-input shape twice (the
    stage's two convs, or an encoder's and a decoder's) except 4^3's once,
    each dual shape once; the library's and the bound beside."""
    step = [r for r in rows if r["n"] == 2 and r["spatial"][0] == r["spatial"][2]
            and r["spatial"][0] in (128, 64, 32, 16, 8, 4)]
    weight = [1 if len(r["splits"]) == 2 or r["spatial"][0] == 4 else 2 for r in step]
    out = {f"step_{k}": sum(w * r.get(k, 0.0) for w, r in zip(weight, step))
           for k in ("queued_ms", "library_queued_ms", "bound_ms")}
    out["step_launches"] = sum(weight)
    print(f"14a {label} over one Liver fp32 step ({out['step_launches']} launches): "
          f"{out['step_queued_ms']:.3f} ms queued"
          + (f", library {out['step_library_queued_ms']:.3f} ms" if out["step_library_queued_ms"]
             else "") + f", bound {out['step_bound_ms']:.3f} ms")
    return out


def phase_fp32_d_shapes(recorded: collections.Counter) -> dict:
    """14a (D shapes): kernel D's fp32 forms at every distinct D shape that
    14b's fused fp32 run launched (its recorded (input channels, Cout,
    spatial, N); single inputs with the prologue, two with none): out and
    stats into NaN-filled buffers within FP32_RTOL of the plain fp32
    version's largest entry, a bit-equal repeat, single-call median and
    queued time, the bound (D's: the conv, its stats and prologue) and its
    share, the plan; beside it cuDNN's fp32 conv alone (TF32 off; the dual
    form's on the concat built beforehand), which computes neither the
    prologue nor the stats."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 42)
    rows = []
    for splits, cout, sp, n in sorted(recorded, key=lambda k: (k[3], len(k[0]), -k[2][0])):
        ca, cb = splits[0], sum(splits[1:])
        ins = [torch.randn(n, *sp, c, generator=gen, device=dev) for c in splits]
        w = torch.randn(cout, ca + cb, 3, 3, 3, generator=gen, device=dev) * (
            2 / (27 * (ca + cb))) ** 0.5
        bias = torch.randn(cout, generator=gen, device=dev) * 0.1
        pw = cv.prepare_conv3d_weight(w, splits if cb else None, torch.float32)
        aff = () if cb else (torch.rand(n, ca, generator=gen, device=dev) + 0.5,
                             torch.randn(n, ca, generator=gen, device=dev))
        out = torch.full((n, *sp, cout), float("nan"), device=dev)
        stats = torch.full((n, 2, cout), float("nan"), device=dev)

        def kernel():
            if cb:
                return cv.conv3d_same_dual_stats(*ins, pw, bias, out=out, stats=stats)
            return cv.conv3d_same_affine(ins[0], pw, bias, *aff, out=out, stats=stats)
        got, got_stats = kernel()
        ref, ref_stats = (cv.conv3d_same_dual_stats_ref(*ins, w, bias) if cb else
                          cv.conv3d_same_affine_ref(ins[0], w, bias, *aff))
        what = (f"D{' dual' if cb else ''} {'+'.join(map(str, splits))}->{cout} at "
                f"{'x'.join(map(str, sp))} N={n}")
        top, stop = ref.abs().max().item(), ref_stats.abs().max().item()
        err = _check(f"14a {what}", got, ref, FP32_RTOL * top)
        serr = _check(f"14a {what} stats", got_stats, ref_stats, FP32_RTOL * stop)
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)
        plan = cv.conv3d_same_fp32_plan(n, *sp, ca, cb, cout, stats=True)
        row = {"at": what, "form": "D dual" if cb else "D", "splits": list(splits),
               "cout": cout, "spatial": list(sp), "n": n, "err": err,
               "rel_err": err / max(top, 1e-30), "stats_rel_err": serr / max(stop, 1e-30),
               "launches_recorded": recorded[(splits, cout, sp, n)],
               **_fp32_affine_bound(ca + cb, cout, sp, n, not cb),
               "plan": {k: plan[k] for k in ("box", "splits", "resident", "stages", "grid")}}
        _fp32_timed(row, kernel, lambda: F.conv3d(x_cl, w_cl, bias, padding=1), kernel,
                    [out, stats], what)
        row["cudnn_conv_ms"] = row.pop("library_ms")
        row["cudnn_conv_queued_ms"] = row.pop("library_queued_ms")
        rows.append(row)
        print(f"14a {what}: max|d| {err:.3e} (relative {row['rel_err']:.2e}; stats "
              f"{row['stats_rel_err']:.2e}); ring body {row['ms']:.3f} ms, queued "
              f"{row['queued_ms']:.3f} ({row['share_of_bound']:.0%} of the bound "
              f"{row['bound_ms']:.3f} ms); cuDNN fp32 conv alone {row['cudnn_conv_ms']:.3f}, "
              f"queued {row['cudnn_conv_queued_ms']:.3f}; bit-equal repeat; plan {row['plan']}")
        del ins, out, stats, got, got_stats, ref, ref_stats, x_cl, w_cl
    torch.cuda.empty_cache()
    return {"shapes": rows, **_fp32_step_sums("kernel D's fp32 forms", rows)}


def _fp32_ab_shapes(gen) -> list:
    """14a: kernels A's and B's fp32 forms (the ring body) at every fp32 A/B
    call of one Liver fp32 step at batch 2 (each stage's forward conv, which
    its dx shares, each decoder's B and B's dx) and at the flagship's
    30-channel rows at N=1 (probes/fp32_forms.py's shapes): each into a
    NaN-filled buffer within FP32_RTOL of the plain fp32 version, its
    single-call median and queued time beside cuDNN's fp32 call (TF32 off;
    B's on the concat built beforehand), the bound and the share of it."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.probes.fp32_forms import FLAGSHIP_SHAPES, STEP_SHAPES
    dev = torch.device("cuda")
    rows = []
    for n, sp, ca, cb, cout in STEP_SHAPES + FLAGSHIP_SHAPES:
        splits = (ca, cb) if cb else (ca,)
        ins = [torch.randn(n, *sp, c, generator=gen, device=dev) for c in splits]
        w = torch.randn(cout, ca + cb, 3, 3, 3, generator=gen, device=dev) * (
            2 / (27 * (ca + cb))) ** 0.5
        bias = torch.randn(cout, generator=gen, device=dev) * 0.1
        pw = cv.prepare_conv3d_weight(w, splits if cb else None, torch.float32)
        out = torch.full((n, *sp, cout), float("nan"), device=dev)
        wrap = cv.conv3d_same_dual if cb else cv.conv3d_same
        ref = (cv.conv3d_same_dual_ref if cb else cv.conv3d_same_ref)(*ins, w, bias)
        what = f"{'+'.join(map(str, splits))}->{cout} at {'x'.join(map(str, sp))} N={n}"
        err = _check(f"14a {what}", wrap(*ins, pw, bias, out=out), ref,
                     FP32_RTOL * ref.abs().max().item())
        x_cl = torch.cat(ins, -1).permute(0, 4, 1, 2, 3)
        w_cl = w.contiguous(memory_format=torch.channels_last_3d)

        def kernel():
            return wrap(*ins, pw, bias, out=out)

        def library():
            return F.conv3d(x_cl, w_cl, bias, padding=1)

        plan = cv.conv3d_same_fp32_plan(n, *sp, ca, cb, cout)
        row = {"at": what, "form": "B" if cb else "A", "splits": list(splits), "cout": cout,
               "spatial": list(sp), "n": n, "err": err,
               "rel_err": err / max(ref.abs().max().item(), 1e-30),
               "ms": _median_ms(kernel, FP32_ITERS), "queued_ms": _queued_ms(kernel, 20),
               "cudnn_fp32_ms": _median_ms(library, FP32_ITERS),
               "cudnn_fp32_queued_ms": _queued_ms(library, 20),
               **_fp32_bound(ca + cb, cout, sp, n),
               "plan": {k: plan[k] for k in ("box", "splits", "resident", "stages", "grid")}}
        row["share_of_bound"] = row["bound_ms"] / row["queued_ms"]
        rows.append(row)
        print(f"14a {'B' if cb else 'A'} fp32 {what}: max|d| {err:.3e} (relative "
              f"{row['rel_err']:.2e}); ring body {row['ms']:.3f} ms, queued "
              f"{row['queued_ms']:.3f} ({row['share_of_bound']:.0%} of the bound "
              f"{row['bound_ms']:.3f} ms); cuDNN fp32 {row['cudnn_fp32_ms']:.3f}, queued "
              f"{row['cudnn_fp32_queued_ms']:.3f}; box {plan['box']}, K splits "
              f"{plan['splits']}, {'resident' if plan['resident'] else 'streamed'} weights, "
              f"{plan['stages']} stages, grid {plan['grid']}")
        del ins, ref, out, x_cl
    torch.cuda.empty_cache()
    step = [r for r in rows if r["n"] == 2]
    print(f"14a one Liver fp32 step's {len(step)} distinct A/B shapes, once each: ring body "
          f"{sum(r['queued_ms'] for r in step):.3f} ms queued, cuDNN fp32 "
          f"{sum(r['cudnn_fp32_queued_ms'] for r in step):.3f} ms, bound "
          f"{sum(r['bound_ms'] for r in step):.3f} ms")
    return rows


def _released_zip(model: str, path: str) -> None:
    """A reference-layout model folder zipped in the released Task100 layout:
    Task100_MultiTalent/MultiTalent_trainer__<plans>/fold_X/... (no
    3d_fullres level, the trainer folder's old name, each sidecar naming the
    stale trainer `MultiTalent_trainer`)."""
    import pickle
    import zipfile
    from multitalent_tpu_torch.paths import default_plans_identifier
    base = f"Task100_MultiTalent/MultiTalent_trainer__{default_plans_identifier}"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as z:
        for d, _, files in os.walk(model):
            for f in files:
                src = os.path.join(d, f)
                name = f"{base}/{os.path.relpath(src, model)}"
                if f.endswith(".model.pkl"):
                    with open(src, "rb") as fh:
                        meta = pickle.load(fh)
                    z.writestr(name, pickle.dumps(dict(meta, name="MultiTalent_trainer")))
                else:
                    z.write(src, name)


def _files(root: str) -> dict:
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, fs in os.walk(root):
        for f in fs:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def phase_install(workdir: str, main_path: dict) -> dict:
    """16: the released-layout install on the card. Phase 3's flagship folder
    zipped as the released Task100 zip, installed by `cli.download_pretrained
    install_zip` into a fresh RESULTS_FOLDER (the fixups must leave
    3d_fullres/Task100_MultiTalent/MultiTalent_trainer_ddp__<plans> with the
    sidecar's name stamped), `cli.predict_multitalent` of phase 3's case from
    it in phase 3's mode (A and B launches as phase 3's, every NIfTI
    byte-identical to phase 3's), `cli.export_model` of it into a second zip
    installed into a second folder (the same files), `cli.change_trainer` on
    that install's sidecar (restore then names the new trainer); seconds by
    step. It runs right after phase 3b, in phase 3's state (phase 16b,
    phase_sources, runs the host steps after phase 10a)."""
    import torch
    from multitalent_tpu_torch.cli import change_trainer, download_pretrained, export_model
    from multitalent_tpu_torch.cli.predict_multitalent import main as predict_main
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               read_model_folder)
    from multitalent_tpu_torch.paths import default_plans_identifier
    seconds = {}

    def step(label, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        seconds[label] = time.perf_counter() - t0
        return result

    task_rel = os.path.join("3d_fullres", "Task100_MultiTalent",
                            f"MultiTalent_trainer_ddp__{default_plans_identifier}")
    zpath = os.path.join(workdir, "Task100_MultiTalent.zip")
    step("zip", _released_zip, os.path.join(workdir, "model"), zpath)
    first, second = (os.path.join(workdir, f"installed_{i}") for i in (1, 2))
    with _env(RESULTS_FOLDER=first):
        step("install", download_pretrained.main, ["install_zip", zpath])
    installed = os.path.join(first, "nnUNet", task_rel)
    names = read_model_folder(installed)[3]
    if (names != ["MultiTalent_trainer_ddp"]
            or os.path.isdir(os.path.join(first, "nnUNet", "Task100_MultiTalent"))):
        raise AssertionError(f"16: the fixups left {os.listdir(os.path.join(first, 'nnUNet'))}, "
                             f"sidecar names {names}")
    out = os.path.join(workdir, "out_installed")
    with _env(MTTPU_SW_EXACT="1", MTTPU_FUSED_NORM="0"):
        t0 = time.perf_counter()
        _, launches = _run_counted(lambda: predict_main(
            ["-i", os.path.join(workdir, "in"), "-o", out, "-m", installed, "--device", "cuda"]))
        seconds["predict"] = time.perf_counter() - t0
    if launches != main_path["launches"]:
        raise AssertionError(f"16a predict: launches {launches}, phase 3's "
                             f"{main_path['launches']}")
    same = _same_nifti_bytes(out, main_path["out"])
    zpath2 = os.path.join(workdir, "exported.zip")
    with _env(RESULTS_FOLDER=first):
        step("export", export_model.main, ["-t", "100", "-o", zpath2, "-m", "3d_fullres", "-tr",
                                           "MultiTalent_trainer_ddp", "-f", "0",
                                           "--disable_strict"])
    with _env(RESULTS_FOLDER=second):
        step("install again", download_pretrained.main, ["install_zip", zpath2])
    a, b = _files(os.path.join(first, "nnUNet")), _files(os.path.join(second, "nnUNet"))
    if a != b:
        raise AssertionError(f"16: export -> install changed {sorted(set(a) ^ set(b))} or "
                             "the bytes of a file")
    again = os.path.join(second, "nnUNet", task_rel)
    sidecar = os.path.join(again, "fold_0", "model_final_checkpoint.model.pkl")
    step("change_trainer", change_trainer.main, [sidecar, "MultiTalent_trainer_ddp_2000ep"])
    restored = step("restore", load_model_and_checkpoint_files, again, [0],
                    "model_final_checkpoint", "cuda")
    if (restored.trainer_name != "MultiTalent_trainer_ddp_2000ep"
            or restored.inference_nonlin != "sigmoid"):
        raise AssertionError(f"16a change_trainer: restored {restored.trainer_name} "
                             f"({restored.inference_nonlin})")
    del restored
    torch.cuda.empty_cache()
    print(f"16a install: released-layout zip of phase 3's folder ({os.path.getsize(zpath)} "
          f"bytes) installed as {task_rel}; predict_multitalent from it "
          f"{ {k: v for k, v in launches.items() if v} } (phase 3's), {same} NIfTIs "
          f"byte-identical to phase 3's; export -> install {len(a)} files equal; "
          f"change_trainer -> restore names MultiTalent_trainer_ddp_2000ep; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"launches": launches, "same_niftis": same, "seconds": seconds}


def _dicom_slice(path: str, z: int, pixels, explicit: bool) -> None:
    """One uncompressed little-endian CT slice (explicit or implicit VR), at
    z * 2.5 mm along an axial series, rescale intercept -1024."""
    import struct

    def ds(*vals) -> bytes:
        t = "\\".join(f"{v:g}" for v in vals)
        return (t + " " if len(t) % 2 else t).encode()

    def el(group, elem, vr, val):
        if not explicit:
            return struct.pack("<HHI", group, elem, len(val)) + val
        if vr == b"OW":
            return (struct.pack("<HH", group, elem) + vr + b"\0\0"
                    + struct.pack("<I", len(val)) + val)
        return struct.pack("<HH", group, elem) + vr + struct.pack("<H", len(val)) + val

    ts = b"1.2.840.10008.1.2.1\0" if explicit else b"1.2.840.10008.1.2\0"
    meta = struct.pack("<HH", 0x0002, 0x0010) + b"UI" + struct.pack("<H", len(ts)) + ts
    rows, cols = pixels.shape
    body = b"".join([
        el(0x0020, 0x0032, b"DS", ds(-100.0, -80.0, 50.0 + 2.5 * z)),
        el(0x0020, 0x0037, b"DS", ds(1, 0, 0, 0, 1, 0)),
        el(0x0028, 0x0010, b"US", struct.pack("<H", rows)),
        el(0x0028, 0x0011, b"US", struct.pack("<H", cols)),
        el(0x0028, 0x0030, b"DS", ds(0.75, 0.75)),
        el(0x0028, 0x0100, b"US", struct.pack("<H", 16)),
        el(0x0028, 0x0103, b"US", struct.pack("<H", 1)),
        el(0x0028, 0x1052, b"DS", ds(-1024.0)),
        el(0x7FE0, 0x0010, b"OW", pixels.astype("<i2").tobytes())])
    with open(path, "wb") as f:
        f.write(b"\0" * 128 + b"DICM" + meta + body)


def phase_sources(root: str, generic: dict) -> dict:
    """16b, on the host: every converter of tasks/source_converters through
    cli.convert_multitalent_sources on a synthetic download of SOURCE_SHAPE
    volumes, two cases a task (Task062's as DICOM series, one explicit and
    one implicit VR; each task's images, labels and dataset.json checked);
    cli.convert_decathlon_task of phase 10a's Liver task laid out as a
    Decathlon download (its arrays and spacing as 10a's); cli.plot_task_pngs
    of 10a's task, raw and preprocessed; host seconds by step."""
    import json
    import shutil
    import numpy as np
    from multitalent_tpu_torch.cli import convert_decathlon_task, convert_multitalent_sources
    from multitalent_tpu_torch.cli import plot_task_pngs
    from multitalent_tpu_torch.io import Geometry, read_nifti, write_nifti
    rng = np.random.default_rng(SEED + 16)
    geom = Geometry(spacing=(0.8, 0.8, 2.5))

    def vol(path, labels=False):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        arr = (rng.integers(0, 4, SOURCE_SHAPE).astype(np.uint8) if labels
               else (rng.standard_normal(SOURCE_SHAPE) * 300).astype(np.int16))
        write_nifti(path, arr, geom)

    src = os.path.join(root, "downloads")
    j = os.path.join
    for i in (1, 2):
        vol(j(src, "017", "Training", "img", f"img{i:04d}.nii.gz"))
        vol(j(src, "017", "Training", "label", f"label{i:04d}.nii.gz"), True)
        vol(j(src, "018", "Training", "img", f"Case_{i:02d}-Image.nii.gz"))
        vol(j(src, "018", "Training", "label", f"Case_{i:02d}-Mask.nii.gz"), True)
        vol(j(src, "055", "train", f"Patient_{i:02d}", f"Patient_{i:02d}.nii.gz"))
        vol(j(src, "055", "train", f"Patient_{i:02d}", "GT.nii.gz"), True)
        vol(j(src, "064", f"case_{i:05d}", "imaging.nii.gz"))
        vol(j(src, "064", f"case_{i:05d}", "segmentation.nii.gz"), True)
        vol(j(src, "051", str(i), "data.nii.gz"))
        vol(j(src, "051", str(i), "label.nii.gz"), True)
        vol(j(src, "046", "pancreas", f"PANCREAS_{i:04d}.nii.gz"))
        vol(j(src, "046", "zenodo", "label_tciapancreasct_multiorgan", "label_tcia_multiorgan",
              f"label{i:04d}.nii.gz"), True)
        vol(j(src, "046", "btcv", f"img{i:04d}.nii.gz"))
        vol(j(src, "046", "zenodo", "label_btcv_multiorgan", f"label{i:04d}.nii.gz"), True)
        series = j(src, "062", "images", f"PANCREAS_{i:04d}", "study", "series")
        os.makedirs(series)
        nz, ny, nx = SOURCE_SHAPE
        ct = rng.integers(0, 3000, (nz, ny, nx)).astype(np.int16)
        for z in range(nz):
            _dicom_slice(j(series, f"slice{z:03d}.dcm"), z, ct[z], explicit=i == 1)
        vol(j(src, "062", "labels", f"label{i:04d}.nii.gz"), True)
    args = {"Task017": [j(src, "017")], "Task018": [j(src, "018")],
            "Task046": [j(src, "046", "pancreas"), "--labels", j(src, "046", "zenodo"),
                        "--btcv-images", j(src, "046", "btcv")],
            "Task051": [j(src, "051")], "Task055": [j(src, "055")],
            "Task062": [j(src, "062", "images"), "--labels", j(src, "062", "labels")],
            "Task064": [j(src, "064")]}
    seconds, converted = {}, {}
    raw = j(root, "raw")
    for task, a in args.items():
        t0 = time.perf_counter()
        out = convert_multitalent_sources.main([task, *a, "--raw_data_base", raw])
        seconds[f"convert {task}"] = time.perf_counter() - t0
        with open(j(out, "dataset.json")) as f:
            ds = json.load(f)
        images = sorted(os.listdir(j(out, "imagesTr")))
        if ds["numTraining"] != len(images) or not images or len(
                os.listdir(j(out, "labelsTr"))) != len(images):
            raise AssertionError(f"16b {task}: {images}, dataset.json {ds['numTraining']}")
        converted[task] = len(images)
    # the Decathlon split of phase 10a's Liver task laid out as a download
    liver = j(generic["env"]["nnUNet_raw_data_base"], "nnUNet_raw_data", "Task003_Liver")
    msd = j(root, "msd", "Task03_Liver")
    cases = sorted(f[:-len("_0000.nii.gz")] for f in os.listdir(j(liver, "imagesTr")))
    for sub in ("imagesTr", "labelsTr"):
        os.makedirs(j(msd, sub))
    for c in cases:
        shutil.copy(j(liver, "imagesTr", f"{c}_0000.nii.gz"), j(msd, "imagesTr", f"{c}.nii.gz"))
        shutil.copy(j(liver, "labelsTr", f"{c}.nii.gz"), j(msd, "labelsTr", f"{c}.nii.gz"))
    with open(j(liver, "dataset.json")) as f:
        ds = json.load(f)
    ds["training"] = [{"image": f"./imagesTr/{c}.nii.gz", "label": f"./labelsTr/{c}.nii.gz"}
                      for c in cases]
    ds["test"] = []
    with open(j(msd, "dataset.json"), "w") as f:
        json.dump(ds, f)
    with _env(nnUNet_raw_data_base=j(root, "msd_raw")):
        t0 = time.perf_counter()
        convert_decathlon_task.main(["-i", msd])
        seconds["convert_decathlon_task"] = time.perf_counter() - t0
    split = j(root, "msd_raw", "nnUNet_raw_data", "Task003_Liver")
    for c in cases:
        (x, gx), (y, gy) = (read_nifti(j(d, "imagesTr", f"{c}_0000.nii.gz"))
                            for d in (split, liver))
        if not np.array_equal(x, y) or not np.allclose(gx.spacing, gy.spacing):
            raise AssertionError(f"16b convert_decathlon_task: {c} differs from 10a's")
    converted["Task003_Liver (Decathlon)"] = len(cases)
    # the overlay PNGs of 10a's task, raw and preprocessed
    for label, extra in (("raw", ["--use_raw"]), ("preprocessed", [])):
        pngs = j(root, "pngs", label)
        t0 = time.perf_counter()
        with _env(**generic["env"]):
            plot_task_pngs.main(["-t", "3", "-o", pngs, "-num_processes", "4", *extra])
        seconds[f"plot_task_pngs {label}"] = time.perf_counter() - t0
        files = os.listdir(pngs)
        if len(files) < len(cases) - 1 or not all(
                open(j(pngs, f), "rb").read(8) == b"\x89PNG\r\n\x1a\n" for f in files):
            raise AssertionError(f"16b plot_task_pngs {label}: {files}")
        converted[f"pngs {label}"] = len(files)
    print(f"16b host: converted {converted}; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in seconds.items()))
    return {"seconds": seconds, "converted": converted}


def _fp32_affine_bound(cin: int, cout: int, spatial, n: int, prologue: bool) -> dict:
    """Kernel D's fp32 form's bound: the fp32 conv's (_fp32_bound), its
    stats (3 fp32 operations an output value, 8 bytes a sample and channel
    written) and, with the prologue, x * scale + shift and the LeakyReLU (3
    operations an input value) from 8 bytes a sample and channel."""
    vox = n * prod(spatial)
    return _bound(4 * (vox * (cin + cout) + 27 * cin * cout) + n * cout * 8
                  + (n * cin * 8 if prologue else 0),
                  fp32_flops=2 * 27 * cin * cout * vox + 3 * vox * cout
                  + (3 * vox * cin if prologue else 0))


def phase_fp32_fused_kernels() -> dict:
    """14a (D, E, F): the fp32 forms of kernels D (with the prologue; its
    dual form), E (stats, apply) and F (LIVER_CLASSES outputs, the Liver's
    head) against their plain fp32 versions (TF32 off) at
    FP32_SPATIAL, the training batch, 32 channels (phase 10a's Liver stage
    0), each into NaN-filled buffers and within FP32_RTOL of the plain
    output's largest entry; the median of FP32_ITERS launches beside the
    plain version's, the bound and one PyTorch call of the same function
    where there is one (E's stats: torch.var_mean; F: torch.matmul of its
    form without the prologue, timed too). D has none: the unfused fp32
    route (the plain norm, then cuDNN's fp32 conv) stands beside it."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.models.blocks import instance_norm_lrelu
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.ops import fused_norm as fn
    from multitalent_tpu_torch.ops import seghead as sg
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    n, sp, c, k = TRAIN_BATCH, FP32_SPATIAL, 32, LIVER_CLASSES
    vox = n * prod(sp)
    where = f"at {'x'.join(map(str, sp))} N={n}"
    rows = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def nan(*shape):
        return torch.full(shape, float("nan"), device=dev)

    def held(label, got, ref) -> tuple[float, float]:
        top = ref.abs().max().item()
        err = _check(label, got, ref, FP32_RTOL * top)
        return err, err / max(top, 1e-30)

    def record(name, what, err, rel, kernel, plain, work, library=None, **extra):
        row = {"what": f"{what} {where}", "err": err, "rel_err": rel,
               "ms": _median_ms(kernel, FP32_ITERS), "plain_ms": _median_ms(plain, FP32_ITERS),
               "library_ms": None if library is None else _median_ms(library, FP32_ITERS),
               **work, **{k2: _median_ms(v, FP32_ITERS) if callable(v) else v
                          for k2, v in extra.items()}}
        rows[name] = row
        print(f"14a {name} {row['what']}: max|d| {err:.3e} (relative {rel:.2e}, bound "
              f"{FP32_RTOL:.0e}); kernel {row['ms']:.3f} ms, plain {row['plain_ms']:.3f} ms, "
              + (f"library {row['library_ms']:.3f} ms, " if library is not None else "")
              + "".join(f"{k2} {row[k2]:.3f} ms, " for k2 in extra if callable(extra[k2]))
              + f"bound {row['bound_ms']:.3f} ms ({row['bound_by']})")

    # D with the prologue and the stats; beside it the unfused fp32 route
    x = rnd(n, *sp, c, scale=2.0)
    w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
    bias = rnd(c, scale=0.1)
    sc, sh = rnd(n, c).abs() + 0.5, rnd(n, c)
    norm_w, norm_b = rnd(c).abs() + 0.5, rnd(c)
    pw = cv.prepare_conv3d_weight(w, dtype=torch.float32)
    out, stats = cv.conv3d_same_affine(x, pw, bias, sc, sh, out=nan(n, *sp, c),
                                       stats=nan(n, 2, c))
    ref, ref_stats = cv.conv3d_same_affine_ref(x, w, bias, sc, sh)
    err, rel = held(f"14a D fp32 {where}", out, ref)
    serr, srel = held(f"14a D fp32 stats {where}", stats, ref_stats)
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = w.contiguous(memory_format=torch.channels_last_3d)
    record("conv3d_same_affine_fp32", f"{c}->{c}", err, rel,
           lambda: cv.conv3d_same_affine(x, pw, bias, sc, sh),
           lambda: cv.conv3d_same_affine_ref(x, w, bias, sc, sh),
           _fp32_affine_bound(c, c, sp, n, True), stats_max_abs_err=serr,
           stats_rel_err=srel,
           unfused_route_ms=lambda: F.conv3d(instance_norm_lrelu(x_cl, norm_w, norm_b), w_cl,
                                             bias, padding=1))
    del out, ref
    # D's dual form (a decoder's first conv), beside B's fp32 form without stats
    b = rnd(n, *sp, c)
    wd = rnd(c, 2 * c, 3, 3, 3, scale=(2.0 / (54 * c)) ** 0.5)
    pwd = cv.prepare_conv3d_weight(wd, (c, c), torch.float32)
    out, stats = cv.conv3d_same_dual_stats(x, b, pwd, bias, out=nan(n, *sp, c),
                                           stats=nan(n, 2, c))
    ref, ref_stats = cv.conv3d_same_dual_stats_ref(x, b, wd, bias)
    err, rel = held(f"14a D dual fp32 {where}", out, ref)
    serr, srel = held(f"14a D dual fp32 stats {where}", stats, ref_stats)
    dual = {"err": err, "rel_err": rel, "stats_max_abs_err": serr, "stats_rel_err": srel,
            "ms": _median_ms(lambda: cv.conv3d_same_dual_stats(x, b, pwd, bias), FP32_ITERS),
            "plain_ms": _median_ms(lambda: cv.conv3d_same_dual_stats_ref(x, b, wd, bias),
                                   FP32_ITERS),
            "b_fp32_ms": _median_ms(lambda: cv.conv3d_same_dual(x, b, pwd, bias), FP32_ITERS),
            **_fp32_affine_bound(2 * c, c, sp, n, False)}
    rows["conv3d_same_affine_fp32"]["dual"] = dual
    rows["conv3d_same_affine_fp32"]["max_err"] = max(rows["conv3d_same_affine_fp32"]["err"],
                                                     dual["err"])
    print(f"14a conv3d_same_dual_stats_fp32 {c}+{c}->{c} {where}: max|d| {dual['err']:.3e} "
          f"(relative {dual['rel_err']:.2e}; stats {srel:.2e}); kernel {dual['ms']:.3f} ms, plain "
          f"{dual['plain_ms']:.3f} ms, B's fp32 form without stats {dual['b_fp32_ms']:.3f} ms, "
          f"bound {dual['bound_ms']:.3f} ms ({dual['bound_by']})")
    del out, ref, b
    # E: stats (two calls bit-equal, launches a call from a captured graph),
    # then apply
    xe = rnd(n, *sp, c, scale=3.0) + 1
    stats = fn.channel_stats(xe)
    if not torch.equal(stats, fn.channel_stats(xe)):
        raise AssertionError("14a channel_stats fp32: two calls differ")
    err, rel = held(f"14a E stats fp32 {where}", stats, fn.channel_stats_ref(xe))
    per_call = _device_launches(lambda: fn.channel_stats(xe))
    if not 1 <= per_call <= 2:
        raise AssertionError(f"14a channel_stats fp32: {per_call} launches a call")
    record("channel_stats_fp32", f"{c}", err, rel, lambda: fn.channel_stats(xe),
           lambda: fn.channel_stats_ref(xe),
           _bound(vox * c * 4 + n * 2 * c * 4, fp32_flops=3 * vox * c),
           library=lambda: torch.var_mean(xe, dim=(1, 2, 3), correction=0),
           launches_per_call=per_call, queued_ms=_queued_ms(lambda: fn.channel_stats(xe)))
    sc2, sh2 = fn.stats_affine(stats, norm_w, norm_b, prod(sp))
    sc2, sh2 = sc2.contiguous(), sh2.contiguous()
    got = fn.affine_lrelu(xe, sc2, sh2, 1e-2, True)
    want = fn.affine_lrelu_ref(xe, sc2, sh2, 1e-2, True)
    err, rel = held(f"14a E apply fp32 {where}", got, want)
    record("affine_lrelu_fp32", f"{c}", err, rel, lambda: fn.affine_lrelu(xe, sc2, sh2),
           lambda: fn.affine_lrelu_ref(xe, sc2, sh2),
           _bound(2 * vox * c * 4, fp32_flops=4 * vox * c),
           values_differing=int((got != want).sum().item()))
    del got, want, xe
    # F: the Liver's head with the prologue, into a NaN-filled output; one
    # torch.matmul computes its form without the prologue ((K, C) x (N, C, S))
    head = rnd(k, c, 1, 1, 1, scale=(1.0 / c) ** 0.5)
    hbias = rnd(k, scale=0.1)
    got = sg.seghead(x, head, hbias, sc, sh, 1e-2, torch.float32, out=nan(n, k, *sp))
    ref = sg.seghead_ref(x, head, hbias, sc, sh, 1e-2, torch.float32)
    err, rel = held(f"14a F fp32 {where}", got, ref)
    if not torch.equal(got, sg.seghead(x, head, hbias, sc, sh, 1e-2, torch.float32)):
        raise AssertionError("14a seghead fp32: two calls differ")
    bare = sg.seghead(x, head, None, None, None, 1e-2, torch.float32)
    w2, xs = head.reshape(k, c), x.reshape(n, -1, c)
    lib = torch.matmul(w2, xs.transpose(1, 2)).reshape(bare.shape)
    err2, rel2 = held(f"14a F fp32 without prologue vs torch.matmul {where}", bare, lib)
    record("seghead_fp32", f"{c}->{k}", max(err, err2), max(rel, rel2),
           lambda: sg.seghead(x, head, hbias, sc, sh, 1e-2, torch.float32),
           lambda: sg.seghead_ref(x, head, hbias, sc, sh, 1e-2, torch.float32),
           _bound(vox * (c + k) * 4, fp32_flops=2 * c * k * vox + 4 * c * vox),
           library=lambda: torch.matmul(w2, xs.transpose(1, 2)),
           no_prologue_ms=lambda: sg.seghead(x, head, None, None, None, 1e-2, torch.float32))
    del got, ref, bare, lib, x, x_cl
    torch.cuda.empty_cache()
    return rows


def _fp32_launches(per: dict, scale: int) -> dict:
    """The launches of every kernel expected from an fp32 network's per-step
    or per-forward counts x scale: on the fp32 forms of A, B and C only."""
    from multitalent_tpu_torch.models.blocks import fp32_forms
    return _expect(fp32_forms(per), scale)


def phase_fp32_training(workdir: str, generic: dict) -> dict:
    """14b: `cli.train 3d_fullres nnUNetTrainerV2_fp32 Task003_Liver 0` on
    phase 10a's plans and phantoms (FP32_TRAIN_STEPS steps, fold 0's
    validation), its `.model` restored, and `cli.predict -tr
    nnUNetTrainerV2_fp32` on the held-out raw case: the launches of the fp32
    forms of A, B and C exactly the fp32 network's per-step counts x the
    steps + per-forward counts x the validation batches and the network
    calls, the bf16 kernels launched nowhere; seconds per step, peak memory."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.model_restore import load_model_and_checkpoint_files
    from multitalent_tpu_torch.models.blocks import fp32_forms
    task, trainer_name = "Task003_Liver", "nnUNetTrainerV2_fp32"
    env = dict(generic["env"], RESULTS_FOLDER=os.path.join(workdir, "fp32_results"),
               MTTPU_ITERS_PER_EPOCH=str(FP32_TRAIN_STEPS))
    with _env(**env):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer, launches = _run_counted(lambda: train_main(
            [ "3d_fullres", trainer_name, task, "0", "--device", "cuda", "-gpus", "1"]))
        bodies = {k: BODY_COUNTS[k] for k in FP32_RING_FORMS}
        train_cli_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        net = trainer.network
        per_step, per_fwd = net.kernel_launches_per_step(), net.kernel_launches_per_forward()
        calls = sum(t["net_calls"] for t in trainer.validation_timings)
        expect = {k: a + b + c for (k, a), b, c in zip(
            _fp32_launches(per_step, trainer.step).items(),
            _fp32_launches(per_fwd, trainer.num_val_batches_per_epoch).values(),
            _fp32_launches(per_fwd, calls).values())}
        losses = trainer.all_tr_losses + trainer.all_val_losses
        if (net.dtype != torch.float32 or trainer.fp16 or trainer.step != FP32_TRAIN_STEPS
                or launches != expect or not losses or not np.isfinite(losses).all()):
            raise AssertionError(f"14b: dtype {net.dtype}, {trainer.step} steps, launches "
                                 f"{launches}, expected {expect}, losses {losses}")
        model = trainer.output_folder.rsplit(os.sep, 1)[0]
        _need(os.path.join(trainer.output_folder, "model_final_checkpoint.model"),
              os.path.join(trainer.output_folder, "validation_raw", "summary.json"))
        t0 = time.perf_counter()
        restored = load_model_and_checkpoint_files(model, [0], device="cuda")
        restore_s = time.perf_counter() - t0
        rnet = restored.networks[0]
        mismatched = [k for k, v in rnet.state_dict().items()
                      if not torch.equal(v, net.state_dict()[k])]
        if rnet.dtype != torch.float32 or mismatched:
            raise AssertionError(f"14b restore: dtype {rnet.dtype}, weights differ {mismatched}")
        out = os.path.join(workdir, "fp32_predicted")
        t0 = time.perf_counter()
        timings, predict_launches = _run_counted(lambda: predict_main(
            ["-i", os.path.dirname(generic["held_out"]), "-o", out, "-t", task, "-m",
             "3d_fullres", "-tr", trainer_name, "-f", "0", "--device", "cuda"]))
        predict_s = time.perf_counter() - t0
    pcalls = sum(t["net_calls"] for t in timings)
    if predict_launches != _fp32_launches(per_fwd, pcalls):
        raise AssertionError(f"14b predict: launches {predict_launches}, expected "
                             f"{_fp32_launches(per_fwd, pcalls)}")
    labels, shape = _check_prediction(out, generic["held_out"])
    step_s, steps = _median(trainer.step_seconds[1:]), list(trainer.step_seconds)
    print(f"14b {trainer_name} on Task003_Liver: fp32 network, {trainer.step} steps of batch "
          f"{trainer.batch_size} at {tuple(int(p) for p in trainer.patch_size)}, losses "
          f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
          f"{[round(v, 4) for v in trainer.all_val_losses]} (val); seconds per step "
          f"{step_s:.3f} ({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}); peak "
          f"{peak_gib:.2f} GiB; train CLI {train_cli_s:.1f} s with the validation of "
          f"{len(trainer.validation_timings)} case(s) ({calls} network calls, "
          f"{trainer.validation_seconds:.2f} s)")
    print(f"14b launches: training { {k: v for k, v in launches.items() if v} } (a step "
          f"{fp32_forms(per_step)}); .model restored in {restore_s:.2f} s, bit-equal; "
          f"cli.predict { {k: v for k, v in predict_launches.items() if v} } = per forward "
          f"{fp32_forms(per_fwd)} x {pcalls} calls in {predict_s:.2f} s; the held-out case "
          f"at {shape}, labels {labels}")
    del trainer, net, restored, rnet
    torch.cuda.empty_cache()
    return {"launches": launches, "predict_launches": predict_launches,
            "launches_by_body": bodies,
            "seconds_per_step": step_s, "step_s": steps, "peak_gib": peak_gib,
            "per_step": per_step, "restore_s": restore_s, "predict_s": predict_s,
            "predicted": out, "results": env["RESULTS_FOLDER"]}


def phase_fp32_fused(workdir: str, generic: dict, fp32_train: dict) -> dict:
    """14b fused: `cli.train 3d_fullres nnUNetTrainerV2_fp32 Task003_Liver 0`
    under MTTPU_FUSED_TRAIN=1 (and MTTPU_FUSED_NORM=1 for its validation) on
    phase 10a's plans and phantoms, FP32_TRAIN_STEPS steps, then `cli.predict
    -tr nnUNetTrainerV2_fp32` of the held-out case under MTTPU_FUSED_NORM=1
    from 14b's folder (the unfused run's weights): the launches exactly the
    fused route's counts on the fp32 forms (D, A, C a step; D a validation
    batch; D, E, F a validation or predict forward), no bf16 kernel; the
    labels equal to 14b's unfused fp32 prediction of the same weights on at
    least FP32_FUSED_AGREE of the voxels. Then, through the trainer API, one
    batch of the same data on the same fresh weights: the fused route's
    loss within FP32_FUSED_LOSS_RTOL of the unfused route's, and its backward
    on the fp32 forms of A and C. Every D call of the train CLI and the
    predict is recorded by shape for "14a D shapes"."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.cli.train import TRAINERS
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.io import read_nifti
    from multitalent_tpu_torch.models.blocks import fp32_forms
    from multitalent_tpu_torch.ops.fused_unet import make_train_forward
    task, trainer_name = "Task003_Liver", "nnUNetTrainerV2_fp32"
    fused = {"MTTPU_FUSED_TRAIN": "1", "MTTPU_FUSED_NORM": "1"}
    env = dict(generic["env"], RESULTS_FOLDER=os.path.join(workdir, "fp32_fused_results"),
               MTTPU_ITERS_PER_EPOCH=str(FP32_TRAIN_STEPS), **fused)
    with _env(**env):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_shapes:
            trainer, launches = _run_counted(lambda: train_main(
                ["3d_fullres", trainer_name, task, "0", "--device", "cuda", "-gpus", "1"]))
        bodies = {k: BODY_COUNTS[k] for k in FP32_RING_FORMS}
        train_cli_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        net = trainer.network
        per_step = fp32_forms(net.fused_kernel_launches_per_step())
        per_batch = fp32_forms(net.fused_kernel_launches_per_forward(True))
        per_fwd = fp32_forms(net.fused_kernel_launches_per_forward())
        calls = sum(t["net_calls"] for t in trainer.validation_timings)
        expect = {k: a + b + c for (k, a), b, c in zip(
            _expect(per_step, trainer.step).items(),
            _expect(per_batch, trainer.num_val_batches_per_epoch).values(),
            _expect(per_fwd, calls).values())}
        losses = trainer.all_tr_losses + trainer.all_val_losses
        if (net.dtype != torch.float32 or trainer.step != FP32_TRAIN_STEPS
                or launches != expect or any(launches[k] == 0 for k in (*per_step, *per_fwd))
                or not losses or not np.isfinite(losses).all()):
            raise AssertionError(f"14b fused: dtype {net.dtype}, {trainer.step} steps, "
                                 f"launches {launches}, expected {expect}, losses {losses}")
        out = os.path.join(workdir, "fp32_fused_predicted")
        t0 = time.perf_counter()
        with _env(RESULTS_FOLDER=fp32_train["results"]), \
                _recording("conv3d_same_affine", "conv3d_same_dual_stats") as d_predict:
            timings, predict_launches = _run_counted(lambda: predict_main(
                ["-i", os.path.dirname(generic["held_out"]), "-o", out, "-t", task, "-m",
                 "3d_fullres", "-tr", trainer_name, "-f", "0", "--device", "cuda"]))
        predict_s = time.perf_counter() - t0
        pcalls = sum(t["net_calls"] for t in timings)
        if predict_launches != _expect(per_fwd, pcalls):
            raise AssertionError(f"14b fused predict: launches {predict_launches}, expected "
                                 f"{_expect(per_fwd, pcalls)}")
        labels, shape = _check_prediction(out, generic["held_out"])
        case = os.path.basename(generic["held_out"])[:-len("_0000.nii.gz")] + ".nii.gz"
        mine, _ = read_nifti(os.path.join(out, case))
        theirs, _ = read_nifti(os.path.join(fp32_train["predicted"], case))
        agree = float(np.mean(mine == theirs))
        if not agree >= FP32_FUSED_AGREE:
            raise AssertionError(f"14b fused predict: labels agree with the unfused fp32 "
                                 f"prediction on {agree:.6f} < {FP32_FUSED_AGREE}")
        # one batch through both routes on the same fresh weights
        prep = os.path.join(generic["env"]["nnUNet_preprocessed"], task)
        t = TRAINERS[trainer_name](os.path.join(prep, "MTTPUPlansv2.1_plans_3D.pkl"), 0,
                                   os.path.join(workdir, "fp32_fused_batch"), prep,
                                   batch_dice=False, stage=0, device="cuda")
        t.initialize(True)
        batch = next(t.tr_gen)
        t.tr_gen.stop()
        t.val_gen.stop()
        data, targets = t._val_transform(t._to_device(batch["data"]),
                                         t._to_device(batch["seg"]))
        forward = make_train_forward(t.network)

        def fused_step():
            outs = t._outputs(forward(data, deep_supervision=t.deep_supervision))
            loss = t.loss_fn(outs, targets, {})[0]
            loss.backward()
            return loss.item()

        loss_fused, step_launches = _run_counted(fused_step)
        t.network.zero_grad()
        with torch.no_grad():
            loss_unfused = t.loss_fn(t._outputs(t.network(
                data, deep_supervision=t.deep_supervision)), targets, {})[0].item()
        rel = abs(loss_fused - loss_unfused) / abs(loss_unfused)
        per_one = _expect(fp32_forms(t.network.fused_kernel_launches_per_step()), 1)
        if step_launches != per_one or not rel <= FP32_FUSED_LOSS_RTOL:
            raise AssertionError(f"14b fused batch: loss {loss_fused} vs unfused "
                                 f"{loss_unfused} ({rel:.2e} > {FP32_FUSED_LOSS_RTOL}), "
                                 f"launches {step_launches}, expected {per_one}")
    step_s = _median(trainer.step_seconds[1:])
    print(f"14b fused {trainer_name} on Task003_Liver (MTTPU_FUSED_TRAIN=1, "
          f"MTTPU_FUSED_NORM=1): {trainer.step} steps, losses "
          f"{[round(v, 4) for v in trainer.all_tr_losses]} (train), "
          f"{[round(v, 4) for v in trainer.all_val_losses]} (val); seconds per step "
          f"{step_s:.3f} ({', '.join(f'{v:.3f}' for v in trainer.step_seconds)}; unfused fp32 "
          f"{fp32_train['seconds_per_step']:.3f}); peak {peak_gib:.2f} GiB; train CLI "
          f"{train_cli_s:.1f} s ({calls} validation network calls)")
    print(f"14b fused launches: training { {k: v for k, v in launches.items() if v} } (a "
          f"step {per_step}, a validation batch {per_batch}, a forward {per_fwd}); "
          f"cli.predict { {k: v for k, v in predict_launches.items() if v} } = {per_fwd} x "
          f"{pcalls} calls in {predict_s:.2f} s; labels {labels} at {shape}, "
          f"{agree:.6f} equal to the unfused fp32 prediction (bound {FP32_FUSED_AGREE}); "
          f"one batch on fresh weights: loss fused {loss_fused:.6f}, unfused "
          f"{loss_unfused:.6f}, relative {rel:.2e} (bound {FP32_FUSED_LOSS_RTOL:.0e})")
    del trainer, net, t
    torch.cuda.empty_cache()
    recorded = d_shapes + d_predict
    if sum(recorded.values()) != launches["conv3d_same_affine_fp32"] + \
            predict_launches["conv3d_same_affine_fp32"]:
        raise AssertionError(f"14b fused: {sum(recorded.values())} D calls recorded, "
                             f"{launches['conv3d_same_affine_fp32']} + "
                             f"{predict_launches['conv3d_same_affine_fp32']} launched")
    print(f"14b fused D shapes: {len(recorded)} distinct, "
          + ", ".join(f"{'+'.join(map(str, k[0]))}->{k[1]} @{'x'.join(map(str, k[2]))} "
                      f"N={k[3]} x{v}" for k, v in sorted(recorded.items())))
    return {"launches": launches, "predict_launches": predict_launches,
            "launches_by_body": bodies, "d_shapes": recorded,
            "seconds_per_step": step_s, "peak_gib": peak_gib, "agree": agree,
            "loss_rel": rel, "predict_s": predict_s}


def phase_2d(workdir: str, generic: dict) -> dict:
    """14c: the 2D planner (`cli.plan_and_preprocess -t 3 -pl3d None -pl2d
    ExperimentPlanner2D_v21`) on 10a's cropped Liver data at full width
    (base 32, max 480 features), into a preprocessed root of its own; then
    `cli.train 2d TrainerV2` (TWO_D_STEPS steps, its checkpoints written,
    then the validation's refusal, as the JAX CLI's ValueError), and through
    the trainer API TWO_D_STEPS steps each of TrainerV2 and
    TrainerV2ResencUNet on the 2D plan (the residual-encoder form of it: a
    leading (1, 1) pool, the default block counts), each saved and restored
    bit-equal; the 2D convs run on cuDNN: no hand-written kernel launches."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.plan_and_preprocess import main as plan_main
    from multitalent_tpu_torch.cli.train import main as train_main
    from multitalent_tpu_torch.inference.model_restore import (load_model_and_checkpoint_files,
                                                               save_model_folder)
    from multitalent_tpu_torch.io import Plans, load_plans, save_plans
    from multitalent_tpu_torch.training.trainers import TrainerV2, TrainerV2ResencUNet
    task = "Task003_Liver"
    root = os.path.join(workdir, "two_d")
    env = dict(generic["env"], nnUNet_preprocessed=os.path.join(root, "preprocessed"),
               RESULTS_FOLDER=os.path.join(root, "results"),
               MTTPU_ITERS_PER_EPOCH=str(TWO_D_STEPS))
    out = {}
    with _env(**env):
        t0 = time.perf_counter()
        plan_main(["-t", "3", "-pl3d", "None", "-pl2d", "ExperimentPlanner2D_v21"])
        out["plan_s"] = time.perf_counter() - t0
        prep = os.path.join(env["nnUNet_preprocessed"], task)
        plans_file = os.path.join(prep, "MTTPUPlansv2.1_plans_2D.pkl")
        _need(plans_file)
        plan = _print_plan("14c, the 2D planner on Task003_Liver,", plans_file)
        plans = load_plans(plans_file)
        st = plans.stage(0)
        if len(st.patch_size) != 2 or plans.base_num_features != 32:
            raise AssertionError(f"14c: the 2D planner chose {plan}")

        # the train CLI: trains, writes its checkpoints, then refuses the validation
        t0 = time.perf_counter()
        try:
            _run_counted(lambda: train_main(["2d", "TrainerV2", task, "0", "--device", "cuda",
                                             "-gpus", "1"]))
        except NotImplementedError as e:
            if "2D models are not predicted" not in str(e):
                raise
        else:
            raise AssertionError("14c: cli.train 2d validated a 2D model")
        out["train_cli_s"] = time.perf_counter() - t0
        cli_folder = os.path.join(env["RESULTS_FOLDER"], "nnUNet", "2d", task,
                                  "TrainerV2__MTTPUPlansv2.1", "fold_0")
        _need(os.path.join(cli_folder, "model_final_checkpoint.model"))

        d = plans.to_dict()
        rs = d["plans_per_stage"][0]
        pools = [[1, 1]] + [list(p) for p in rs["pool_op_kernel_sizes"]]
        rs.update(pool_op_kernel_sizes=pools,
                  num_blocks_encoder=list(RESENC_DEFAULT_BLOCKS[:len(pools)]),
                  num_blocks_decoder=[1] * (len(pools) - 1))
        resenc_file = os.path.join(prep, "MTTPUPlansv2.1_resenc_plans_2D.pkl")
        save_plans(Plans.from_dict(d), resenc_file)
        for label, cls, pfile in (("TrainerV2", TrainerV2, plans_file),
                                  ("TrainerV2ResencUNet", TrainerV2ResencUNet, resenc_file)):
            folder = os.path.join(root, "api", label)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = cls(pfile, 0, folder, prep, batch_dice=True, stage=0, device="cuda")

            def steps():
                t.initialize(True)
                losses = [t.run_iteration(t.tr_gen) for _ in range(TWO_D_STEPS)]
                t.tr_gen.stop()
                t.val_gen.stop()
                return losses

            losses, launches = _run_counted(steps)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            if (t.threeD or not np.isfinite(losses).all() or any(launches.values())):
                raise AssertionError(f"14c {label}: threeD {t.threeD}, losses {losses}, "
                                     f"launches {launches}")
            t.save_checkpoint(os.path.join(t.output_folder, "model_final_checkpoint.model"))
            restored = load_model_and_checkpoint_files(folder, [0], device="cuda").networks[0]
            sd = t.network.state_dict()
            if restored.state_dict().keys() != sd.keys() or not all(
                    torch.equal(v, sd[k]) for k, v in restored.state_dict().items()):
                raise AssertionError(f"14c {label}: the restored 2D network differs")
            n_params = sum(p.numel() for p in t.network.parameters())
            out[label] = {"step_s": _median(t.step_seconds[1:]), "peak_gib": peak,
                          "params": n_params}
            print(f"14c {label} on the 2D plan: {type(t.network).__name__} "
                  f"({n_params:,} parameters, features {t.network.features if hasattr(t.network, 'features') else '?'}), "
                  f"batch {t.batch_size} at {tuple(int(p) for p in t.patch_size)}, losses "
                  f"{[round(v, 4) for v in losses]}; seconds per step "
                  f"{out[label]['step_s']:.3f} ({', '.join(f'{v:.3f}' for v in t.step_seconds)});"
                  f" peak {peak:.2f} GiB; saved and restored bit-equal; hand-written kernel "
                  f"launches 0 (cuDNN)")
            del t, restored
    out.update(plan=plan, plans_file=plans_file, prep=prep)
    print(f"14c host seconds: 2D plan + preprocess {out['plan_s']:.2f}, cli.train 2d "
          f"{out['train_cli_s']:.2f}")
    torch.cuda.empty_cache()
    return out


def phase_variants(workdir: str, generic: dict) -> dict:
    """14d: each network variant trainer of VARIANT_TRAINERS (and _DA5 and
    _noDA) on phase 10a's Liver plans and phantoms through the trainer API:
    VARIANT_STEPS steps with every launch count set to 0 before and read
    after (A, B and C exactly the network's per-step counts x the steps),
    finite losses, then the softmax probabilities of one 128^3 tile of a
    validation phantom (the validation sampler's patch, center-cropped as
    the validation step does) through the kernels in bf16: no further from
    the plain fp32 network than the plain bf16 path is (VARIANT_FP32_RATIO:
    mean and max of |dp|), and, for a network of the flagship's two convs a
    stage, within phase 4's bounds of the plain bf16 path (with three convs
    a stage the plain bf16 path itself drifts past them: PERF.md §6)."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.train import TRAINERS
    prep = os.path.join(generic["env"]["nnUNet_preprocessed"], "Task003_Liver")
    plans_file = os.path.join(prep, "MTTPUPlansv2.1_plans_3D.pkl")
    results = {}
    for name in VARIANT_TRAINERS:
        torch.cuda.empty_cache()
        t = TRAINERS[name](plans_file, 0, os.path.join(workdir, "variants", name), prep,
                           batch_dice=False, stage=0, device="cuda")

        def steps():
            t.initialize(True)
            return [t.run_iteration(t.tr_gen) for _ in range(VARIANT_STEPS)]

        t0 = time.perf_counter()
        losses, launches = _run_counted(steps)
        batch = next(t.val_gen)
        t.tr_gen.stop()
        t.val_gen.stop()
        wall = time.perf_counter() - t0
        net = t.network
        expect = _expect(net.kernel_launches_per_step(), VARIANT_STEPS)
        if launches != expect or not np.isfinite(losses).all():
            raise AssertionError(f"14d {name}: launches {launches}, expected {expect}, "
                                 f"losses {losses}")
        two = net.conv_per_stage == 2
        dmax, dmean, ratio = _variant_tile(f"14d {name}", t, batch, plain_bounds=two)
        over = t.network_overrides()
        results[name] = {"launches": launches, "step_s": _median(t.step_seconds[1:]),
                         "dp_max": dmax, "dp_mean": dmean, "fp32_ratio": ratio}
        print(f"14d {name} ({type(t).__name__}, overrides {over}): {VARIANT_STEPS} steps, "
              f"losses {[round(v, 4) for v in losses]}, seconds per step "
              f"{', '.join(f'{v:.3f}' for v in t.step_seconds)} ({wall:.1f} s with set-up); "
              f"launches { {k: v for k, v in launches.items() if v} }; tile kernels vs plain "
              f"|dp| max {dmax:.3e}, mean {dmean:.3e} (bounds {PROB_BOUND}, "
              f"{PROB_BOUND_MEAN}{'' if two else ', not held: 3 convs a stage'}); vs the "
              f"fp32 network kernels / plain bf16 max {ratio[0]:.3f}, mean {ratio[1]:.3f} "
              f"(bounds {VARIANT_FP32_RATIO})")
        del t, net
    torch.cuda.empty_cache()
    return results


def _variant_tile(label: str, t, batch, plain_bounds: bool) -> tuple:
    """The softmax probabilities of the first sample of a validation batch
    (the validation step's crop) through trainer t's network on the kernels
    in bf16, against the plain bf16 path and the plain fp32 network: raises
    unless the kernels' |dp| from fp32 over the plain bf16 path's is within
    VARIANT_FP32_RATIO (max, mean) and, with `plain_bounds`, the kernels'
    |dp| from the plain bf16 path within phase 4's bounds. Returns (max,
    mean) |dp| from the plain bf16 path and the ratios."""
    import torch
    net = t.network
    x, _ = t._val_transform(t._to_device(batch["data"][:1]), t._to_device(batch["seg"][:1]))
    net.eval()
    with torch.no_grad():
        p_k = torch.softmax(net(x), 1)
        p_plain = torch.softmax(net(x, use_kernels=False), 1)
        net.dtype = torch.float32  # the fp32 master weights, plain fp32 compute
        p_32 = torch.softmax(net(x, use_kernels=False), 1)
        net.dtype = torch.bfloat16
    net.train()
    d, dk, dp = ((a - b).abs() for a, b in ((p_k, p_plain), (p_k, p_32), (p_plain, p_32)))
    dmax, dmean = d.max().item(), d.mean().item()
    ratio = (dk.max().item() / dp.max().item(), dk.mean().item() / dp.mean().item())
    if not (torch.isfinite(p_k).all() and ratio[0] <= VARIANT_FP32_RATIO[0]
            and ratio[1] <= VARIANT_FP32_RATIO[1]
            and (not plain_bounds or (dmax <= PROB_BOUND and dmean <= PROB_BOUND_MEAN))):
        raise AssertionError(f"{label}: tile |dp| vs plain bf16 max {dmax:.3e}, mean "
                             f"{dmean:.3e}; vs fp32 kernels / plain bf16 {ratio}")
    return dmax, dmean, ratio


def _cpu_optimizer(opt):
    """The same optimizer on the CPU (fp32) over copies of opt's parameters,
    their gradients and its state."""
    import torch
    params = []
    for p in opt.params:
        q = torch.nn.Parameter(p.detach().cpu().clone())
        q.grad = None if p.grad is None else p.grad.detach().cpu().clone()
        params.append(q)
    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.detach().cpu().clone()
        if isinstance(x, dict):
            return {k: cpu(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(v) for v in x)
        return x

    ref = type(opt)(params, **opt.config)
    ref.load_state_dict(cpu(opt.state_dict()))
    return ref


def _zoo_train(name: str, plans_file: str, prep: str, folder: str) -> tuple:
    """15a: trainer `name` on the plans, ZOO_STEPS steps through the trainer
    API with every launch count set to 0 before and read after; a loss
    variant's loss of step 1 recomputed on the CPU from the same outputs,
    targets and extras, any other trainer's update of step 2 recomputed by
    its optimizer on the CPU from the same parameters, state and gradients
    (the card's update applied as `step` applies it). Returns (the trainer,
    its pipelines stopped, and its readings)."""
    import numpy as np
    import torch
    from multitalent_tpu_torch.cli.train import TRAINERS
    from multitalent_tpu_torch.training.variants import _LossVariant
    t = TRAINERS[name](plans_file, 0, folder, prep, batch_dice=False, stage=0, device="cuda")
    checks = {}

    def install() -> None:
        loss_fn, step = t.loss_fn, t.optimizer.step

        def checked_loss(outputs, targets, extras):
            loss, aux = loss_fn(outputs, targets, extras)
            if t.step == 0 and "loss" not in checks:
                cpu = [[x.detach().cpu() for x in xs] for xs in (outputs, targets)]
                ref, _ = loss_fn(*cpu, {k: v.cpu() for k, v in extras.items()})
                checks["loss"] = (loss.item(), ref.item())
            return loss, aux

        def checked_step(lr):
            if t.step != 1:
                return step(lr)
            _, expect = _cpu_optimizer(t.optimizer).updates(lr)
            norm, got = t.optimizer.updates(lr)
            err = scale = 0.0
            for p, u, v in zip(t.optimizer.params, got, expect):
                if u is not None:
                    with torch.no_grad():
                        p.add_(u)
                    err = max(err, (u.cpu() - v).abs().max().item())
                    scale = max(scale, v.abs().max().item())
            checks["update"] = (err, scale, lr)
            return norm

        if isinstance(t, _LossVariant):
            t.loss_fn = checked_loss
        else:
            t.optimizer.step = checked_step

    def steps():
        t.initialize(True)
        install()
        return [t.run_iteration(t.tr_gen) for _ in range(ZOO_STEPS)]

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    losses, launches = _run_counted(steps)
    batch = next(t.val_gen)
    t.tr_gen.stop()
    t.val_gen.stop()
    expect = _expect(t.network.kernel_launches_per_step(), ZOO_STEPS)
    if launches != expect or not np.isfinite(losses).all():
        raise AssertionError(f"15a {name}: launches {launches}, expected {expect}, losses "
                             f"{losses}")
    # the step without a CPU check: a loss variant's second, another's first
    unchecked = t.step_seconds[1 if isinstance(t, _LossVariant) else 0]
    out = {"launches": launches, "losses": losses, "wall_s": time.perf_counter() - t0,
           "step_s": list(t.step_seconds), "unchecked_step_s": unchecked,
           "optimizer": type(t.optimizer).__name__, "lr": t.lr_schedule(0)}
    if "loss" in checks:
        card, cpu = checks["loss"]
        out["loss_rel"] = abs(card - cpu) / abs(cpu)
        if not out["loss_rel"] <= ZOO_LOSS_RTOL:
            raise AssertionError(f"15a {name}: step 1's loss {card} on the card, {cpu} on the "
                                 f"CPU")
    elif "update" in checks:
        err, scale, _ = checks["update"]
        out["update_rel"] = err / scale
        if not (scale > 0 and out["update_rel"] <= ZOO_UPDATE_RTOL):
            raise AssertionError(f"15a {name}: step 2's update off the CPU's by {err:.3e} of "
                                 f"max {scale:.3e}")
    else:
        raise AssertionError(f"15a {name}: neither check ran")
    return t, batch, out


def _zoo_conv_relu_in(t, batch, name: str) -> dict:
    """15b: a validation tile through the kernels against the plain fp32
    network; under MTTPU_FUSED_NORM=1 / MTTPU_FUSED_TRAIN=1 the forward
    builders warn and hand back the network, whose forward launches A and B
    as always and no D, E or F."""
    import warnings
    import torch
    from multitalent_tpu_torch.ops.fused_unet import make_inference_forward, make_train_forward
    net = t.network
    dmax, dmean, ratio = _variant_tile(f"15b {name}", t, batch, plain_bounds=False)
    x, _ = t._val_transform(t._to_device(batch["data"][:1]), t._to_device(batch["seg"][:1]))
    fused = {}
    for switch, make in (("MTTPU_FUSED_NORM", make_inference_forward),
                         ("MTTPU_FUSED_TRAIN", make_train_forward)):
        with _env(**{switch: "1"}), warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            forward = make(net)
        warned = any("runs its own forward" in str(w.message) for w in caught)
        net.eval()
        with torch.no_grad():
            _, launches = _run_counted(lambda: forward(x))
        net.train()
        expect = _expect(net.kernel_launches_per_forward(), 1)
        if forward is not net or not warned or launches != expect:
            raise AssertionError(f"15b {name} {switch}=1: fused route taken "
                                 f"{forward is not net}, warned {warned}, launches {launches}")
        fused[switch] = {k: v for k, v in launches.items() if v}
    return {"dp_max": dmax, "dp_mean": dmean, "fp32_ratio": ratio, "fused_switches": fused}


def _zoo_predict(t, name: str, generic: dict, results: str, workdir: str) -> dict:
    """15b: the trainer's folder (fold_0's final checkpoint) restored and
    `cli.predict -tr name` of 10a's held-out raw case, exact launches."""
    from multitalent_tpu_torch.cli.predict import main as predict_main
    from multitalent_tpu_torch.inference.model_restore import load_model_and_checkpoint_files
    t.save_checkpoint(os.path.join(t.output_folder, "model_final_checkpoint.model"))
    restored = load_model_and_checkpoint_files(t.output_folder_base, [0],
                                               device="cuda").networks[0]
    sd = t.network.state_dict()
    if not (restored.nonlin_first and restored.state_dict().keys() == sd.keys()
            and all(v.float().equal(sd[k].float()) for k, v in restored.state_dict().items())):
        raise AssertionError(f"15b {name}: the restored network differs")
    out = os.path.join(workdir, "zoo_predicted")
    t0 = time.perf_counter()
    with _env(**{**generic["env"], "RESULTS_FOLDER": results}):
        timings, launches = _run_counted(lambda: predict_main(
            ["-i", os.path.dirname(generic["held_out"]), "-o", out, "-t", "Task003_Liver",
             "-m", "3d_fullres", "-tr", name, "-f", "0", "--device", "cuda"]))
    seconds = time.perf_counter() - t0
    calls = sum(x["net_calls"] for x in timings)
    expect = _expect(restored.kernel_launches_per_forward(), calls)
    if launches != expect:
        raise AssertionError(f"15b {name} predict: launches {launches}, expected {expect}")
    labels, shape = _check_prediction(out, generic["held_out"])
    return {"predict_launches": launches, "predict_s": seconds, "labels": labels,
            "shape": shape}


def _zoo_resample33(t) -> dict:
    """15c: validation of the trainer's fold (its one case) with the
    export's probabilities and arguments recorded; the labels against the
    same export of those probabilities run again on the CPU."""
    import numpy as np
    from multitalent_tpu_torch.inference import validation
    from multitalent_tpu_torch.io import read_nifti
    save, calls = validation.save_segmentation_nifti_from_softmax, []

    def recorded(probs, fname, properties, order, *args):
        calls.append((probs.copy(), fname, properties, order, args))
        return save(probs, fname, properties, order, *args)

    validation.save_segmentation_nifti_from_softmax = recorded
    try:
        _, launches = _run_counted(lambda: t.validate(save_softmax=False,
                                                      run_postprocessing_on_folds=False))
    finally:
        validation.save_segmentation_nifti_from_softmax = save
    net_calls = sum(x["net_calls"] for x in t.validation_timings)
    expect = _expect(t.network.kernel_launches_per_forward(), net_calls)
    if len(calls) != 1 or launches != expect:
        raise AssertionError(f"15c: {len(calls)} exports, launches {launches}, expected "
                             f"{expect}")
    probs, fname, properties, order, args = calls[0]
    again = fname[:-7] + "_cpu.nii.gz"
    save(probs, again, properties, order, *args)
    a, _ = read_nifti(fname)
    b, _ = read_nifti(again)
    force_sep_z, order_z = args[-2], args[-1]
    if not (np.array_equal(a, b) and (order, force_sep_z, order_z) == (3, False, 3)):
        raise AssertionError(f"15c: labels equal {np.array_equal(a, b)}, export order "
                             f"{(order, force_sep_z, order_z)}")
    return {"export": {"interpolation_order": order, "force_separate_z": force_sep_z,
                       "interpolation_order_z": order_z}, "shape": a.shape,
            "labels": sorted(np.unique(a).tolist()), "validation_s": t.validation_seconds,
            "launches": launches}


def phase_zoo(workdir: str, generic: dict, two_d: dict) -> dict:
    """15a-15c: every trainer of ZOO_TRAINERS on 10a's Liver plans and
    phantoms (_zoo_train), ZOO_2D_TRAINER on 14c's 2D plan (no hand-written
    kernel: cuDNN), the convReLUIN networks' tile and fused switches
    (_zoo_conv_relu_in), ZOO_PREDICTED's folder through cli.predict
    (_zoo_predict), `_resample33`'s validation (_zoo_resample33)."""
    import torch
    from multitalent_tpu_torch.paths import default_plans_identifier
    prep = os.path.join(generic["env"]["nnUNet_preprocessed"], "Task003_Liver")
    plans_file = os.path.join(prep, f"{default_plans_identifier}_plans_3D.pkl")
    results = os.path.join(workdir, "zoo_results")
    runs = [(n, plans_file, prep, "3d_fullres") for n in ZOO_TRAINERS]
    runs.append((ZOO_2D_TRAINER, two_d["plans_file"], two_d["prep"], "2d"))
    out = {}
    for name, pfile, pdir, network in runs:
        folder = os.path.join(results, "nnUNet", network, "Task003_Liver",
                              f"{name}__{default_plans_identifier}")
        t, batch, r = _zoo_train(name, pfile, pdir, folder)
        if network == "2d" and (t.threeD or t.optimizer.momentum != 0.9):
            raise AssertionError(f"15a {name}: threeD {t.threeD}, momentum "
                                 f"{t.optimizer.momentum}")
        if "convReLUIN" in name:
            r.update(_zoo_conv_relu_in(t, batch, name))
        if name == ZOO_PREDICTED:
            r.update(_zoo_predict(t, name, generic, results, workdir))
        if name == "nnUNetTrainerV2_resample33":
            r["validation"] = _zoo_resample33(t)
        check = (f"loss vs CPU {r['loss_rel']:.2e}, step 1 with the CPU loss" if "loss_rel" in r
                 else f"step-2 update vs CPU {r['update_rel']:.2e} of max, step 2 with the CPU "
                      f"optimizer")
        print(f"15a {name} ({type(t).__name__}, {r['optimizer']}, lr at step 0 {r['lr']:.3g}"
              f"{', overrides ' + str(t.network_overrides()) if t.network_overrides() else ''}"
              f"): losses {[round(v, 4) for v in r['losses']]}, {check}, seconds per step "
              f"{', '.join(f'{v:.3f}' for v in r['step_s'])} ({r['wall_s']:.1f} s with set-up); "
              f"launches { {k: v for k, v in r['launches'].items() if v} }")
        if "fp32_ratio" in r:
            print(f"15b {name}: tile kernels vs plain bf16 |dp| max {r['dp_max']:.3e}, mean "
                  f"{r['dp_mean']:.3e}; vs the fp32 network kernels / plain bf16 max "
                  f"{r['fp32_ratio'][0]:.3f}, mean {r['fp32_ratio'][1]:.3f} (bounds "
                  f"{VARIANT_FP32_RATIO}); under each fused switch: warned, its own forward, "
                  f"launches {r['fused_switches']}")
        if "predict_launches" in r:
            print(f"15b {name}: restored bit-equal; cli.predict of the held-out case "
                  f"{r['predict_s']:.2f} s, shape {r['shape']}, labels {r['labels']}, launches "
                  f"{ {k: v for k, v in r['predict_launches'].items() if v} }")
        if "validation" in r:
            v = r["validation"]
            print(f"15c {name}: validation of 1 case {v['validation_s']:.2f} s, export "
                  f"{v['export']}, labels {v['labels']} at {v['shape']} equal to the CPU "
                  f"export of the same probabilities; launches "
                  f"{ {k: c for k, c in v['launches'].items() if c} }")
        out[name] = r
        del t, batch
        torch.cuda.empty_cache()
    return out


def phase_zoo_schedules(generic: dict) -> dict:
    """15d (host): the LR each schedule variant's optimizer takes at the
    first step of each of ZOO_EPOCHS (1000 epochs of 250 steps; the plateau
    trainers driven epoch by epoch by a train-loss moving average falling
    1e-2 an epoch for 10 epochs, then flat) and the momentum of the
    momentum reduction at ZOO_MOMENTUM_EPOCHS, set as each epoch ends."""
    import torch
    from multitalent_tpu_torch.cli.train import TRAINERS
    from multitalent_tpu_torch.paths import default_plans_identifier
    plans_file = os.path.join(generic["env"]["nnUNet_preprocessed"], "Task003_Liver",
                              f"{default_plans_identifier}_plans_3D.pkl")

    def trainer(name):
        t = TRAINERS[name](plans_file, 0, device="cpu")
        t.load_plans_file()
        t.process_plans(t.plans)
        t.network = torch.nn.Linear(1, 1)
        t.optimizer, t.lr_schedule = t.initialize_optimizer()
        return t

    tables = {}
    with _env(MTTPU_MAX_EPOCHS="1000", MTTPU_ITERS_PER_EPOCH="250"):
        for name in ("nnUNetTrainerV2_cycleAtEnd", "nnUNetTrainerV2_cycleAtEnd2",
                     "nnUNetTrainerV2_SGD_fixedSchedule2"):
            t = trainer(name)
            tables[name] = {e: t.lr_schedule(e * t.num_batches_per_epoch) for e in ZOO_EPOCHS}
        for name in ("nnUNetTrainerV2_SGD_ReduceOnPlateau",
                     "nnUNetTrainerV2_Adam_ReduceOnPlateau"):
            t = trainer(name)
            t.print_to_log_file = lambda *args, **kwargs: None  # a line a reduction
            table = {}
            for e in range(max(ZOO_EPOCHS) + 1):
                if e in ZOO_EPOCHS:
                    table[e] = t.lr_schedule(e * t.num_batches_per_epoch)
                t.train_loss_MA = 1.0 - 1e-2 * min(e, 10)
                t.maybe_update_lr()
            tables[name] = table
        t = trainer("nnUNetTrainerV2_reduceMomentumDuringTraining")
        momentum = {}
        for e in ZOO_MOMENTUM_EPOCHS:
            t.epoch = e
            t.maybe_update_lr()
            momentum[e] = t.optimizer.momentum
    for name, table in tables.items():
        print(f"15d {name}: LR at the epochs' first steps "
              + ", ".join(f"{e} {v:.4e}" for e, v in table.items()))
    print("15d nnUNetTrainerV2_reduceMomentumDuringTraining: momentum set at the end of "
          "epoch " + ", ".join(f"{e} {m:.4f}" for e, m in momentum.items()))
    if [round(m, 12) for m in momentum.values()] != [0.99, 0.945, 0.9]:
        raise AssertionError(f"15d momentum {momentum}")
    return {"lr": tables, "momentum": momentum}


def _bound(nbytes: float, bf16_flops: float = 0.0, fp32_flops: float = 0.0) -> dict:
    """bound_ms and what bounds it, for work of nbytes, bf16 tensor-core
    FLOPs and fp32 CUDA-core FLOPs."""
    t_ops = (bf16_flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FP32_FLOPS) * 1e3
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _conv_bound(cin: int, cout: int, spatial, n: int, w_bytes: int = 2) -> dict:
    """A SAME 3x3x3 conv's (or its dw's) bound: 2*27*Cin*Cout FLOPs per voxel;
    bf16 input and output (or gradient) read or written once, the weight
    (or dw, w_bytes each) once."""
    vox = n * prod(spatial)
    return _bound(vox * (cin + cout) * 2 + 27 * cin * cout * w_bytes,
                  bf16_flops=2 * 27 * cin * cout * vox)


def _affine_bound(cin: int, cout: int, spatial, n: int, prologue: bool) -> dict:
    """Kernel D's bound: the conv's, plus its per-sample channel stats (sum
    and sum of squares of the output in fp32: 3 operations a value, 8 bytes a
    sample and channel written) and, with the `prologue` (its single form),
    x * scale + shift and the LeakyReLU on its input (3 operations a value)
    from a scale and shift a sample and channel."""
    vox = n * prod(spatial)
    return _bound(vox * (cin + cout) * 2 + 27 * cin * cout * 2 + n * cout * 8
                  + (n * cin * 8 if prologue else 0),
                  bf16_flops=2 * 27 * cin * cout * vox,
                  fp32_flops=3 * vox * cout + (3 * vox * cin if prologue else 0))


def _wgrad_step(timed: list, step_shapes: collections.Counter, label: str = "kernel C") -> dict:
    """Kernel C at each phase-2 shape (ms, cuDNN's bf16 wgrad ms, bound,
    write path) and the sums of both times over one training step's launches:
    each shape weighted by its launches in the step phase 5 recorded, whose
    count is kernel_launches_per_step()'s."""
    by_key = {(tuple(r["splits"]), r["cout"], tuple(r["spatial"]), r["n"]): r for r in timed}
    if not set(step_shapes) <= set(by_key):
        raise AssertionError(f"dw shapes of a step not timed in phase 2: "
                             f"{set(step_shapes) - set(by_key)}")
    shapes = [{"at": "{}->{} at {} N={}".format("+".join(map(str, key[0])), key[1],
                                                "x".join(map(str, key[2])), key[3]),
               "ms": r["ms"], "cudnn_ms": r["cudnn_bf16_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "write": r["write"],
               "launches_per_step": step_shapes.get(key, 0)} for key, r in by_key.items()]
    step = {"step_ms": sum(k * by_key[key]["ms"] for key, k in step_shapes.items()),
            "step_cudnn_ms": sum(k * by_key[key]["cudnn_bf16_ms"]
                                 for key, k in step_shapes.items())}
    print(f"{label} over one training step ({sum(step_shapes.values())} launches, "
          f"{sum(len(key[0]) == 1 for key in step_shapes.elements())} single, "
          f"{sum(len(key[0]) == 2 for key in step_shapes.elements())} dual): "
          f"{step['step_ms']:.3f} ms, cuDNN bf16 wgrad {step['step_cudnn_ms']:.3f} ms")
    return {"shapes": shapes, **step}


@contextlib.contextmanager
def _recording(*names):
    """Counts every call of the named kernel wrappers of ops.conv3d made
    inside by (input channels of each input, Cout, spatial, N): each wrapper
    is swapped for a recorder (on which the wrappers count their launches
    meanwhile) and put back after."""
    from multitalent_tpu_torch.ops import conv3d as cv
    kernels, shapes = {name: getattr(cv, name) for name in names}, collections.Counter()

    def recorder(kernel):
        def rec(*args, **kwargs):
            pw = next(a for a in args if isinstance(a, cv.PreparedWeight))
            shapes[(pw.splits, pw.cout, tuple(int(s) for s in args[0].shape[1:4]),
                    int(args[0].shape[0]))] += 1
            return kernel(*args, **kwargs)
        rec.launches = 0
        rec.launches_by_body = dict.fromkeys(cv.BODIES, 0)
        return rec

    recorders = {name: recorder(kernel) for name, kernel in kernels.items()}
    for name, rec in recorders.items():
        setattr(cv, name, rec)
    try:
        yield shapes
    finally:
        for name, kernel in kernels.items():
            setattr(cv, name, kernel)
        RECORDED_BODIES.update({name: dict(rec.launches_by_body)
                                for name, rec in recorders.items()})


@contextlib.contextmanager
def _recording_x(module, name: str):
    """Counts every call of wrapper `name` of `module` made inside by (C,
    spatial, N) of its channels-last input, as _recording does for the conv
    wrappers."""
    kernel, shapes = getattr(module, name), collections.Counter()

    def rec(x, *args, **kwargs):
        shapes[(int(x.shape[-1]), tuple(int(s) for s in x.shape[1:-1]), int(x.shape[0]))] += 1
        return kernel(x, *args, **kwargs)
    rec.launches = 0
    setattr(module, name, rec)
    try:
        yield shapes
    finally:
        setattr(module, name, kernel)


def _sums(label: str, timed: list, ref_key: str, **weights: collections.Counter) -> dict:
    """A kernel's phase-2 shapes (ms, `ref_key`'s ms beside it, bound, plan)
    and the sums of both over the launches of each of `weights` (e.g.
    forward=, step=: the shapes a phase recorded, each with its count)."""
    by_key = {(tuple(r["splits"]), r["cout"], tuple(r["spatial"]), r["n"]): r for r in timed}
    missing = set().union(*weights.values()) - set(by_key)
    if missing:
        raise AssertionError(f"{label} shapes of a recorded run not timed in phase 2: {missing}")
    out = {"shapes": [{"at": "{}->{} at {} N={}".format("+".join(map(str, s[0])), s[1],
                                                        "x".join(map(str, s[2])), s[3]),
                       "ms": r["ms"], ref_key: r[ref_key], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "plan": r["plan"],
                       **{f"launches_per_{k}": w.get(s, 0) for k, w in weights.items()}}
                      for s, r in by_key.items()]}
    parts = []
    for k, w in weights.items():
        out[f"{k}_ms"] = sum(c * by_key[s]["ms"] for s, c in w.items())
        out[f"{k}_{ref_key}"] = sum(c * by_key[s][ref_key] for s, c in w.items())
        batch = "/".join(str(v) for v in sorted({s[3] for s in w}))
        parts.append(f"over one {k} ({sum(w.values())} launches, N={batch}): "
                     f"{out[f'{k}_ms']:.3f} ms, {ref_key} {out[f'{k}_{ref_key}']:.3f}")
    print(f"{label} " + "; ".join(parts))
    return out


def _timed_entry(r: dict) -> dict:
    """One shape a kernel was timed at in phase 2 or 2b, for the kernels
    line: where, its error and times, its bound."""
    at = r.get("what") or "{}->{} at {} N={}".format(
        "+".join(map(str, r["splits"])), r["cout"], "x".join(map(str, r["spatial"])), r["n"])
    keys = ("err", "ms", "plain_ms", "cudnn_bf16_ms", "unfused_ms", "library_ms", "queued_ms",
            "cudnn_queued_ms", "prepared_ms", "bound_ms", "bound_by")
    return {"at": at, **{k: r[k] for k in keys if k in r}}


def _stats_sums(timed: list, forward: collections.Counter) -> dict:
    """Kernel E's stats pass at each phase-2 shape (single-call and queued ms,
    launches a call, bound) and the sums of both times over one fused
    forward's calls, each shape weighted by its calls phase 4b recorded."""
    by_key = {(r["c"], tuple(r["spatial"]), r["n"]): r for r in timed}
    if not set(forward) <= set(by_key):
        raise AssertionError(f"kernel-E stats shapes of a fused forward not timed in phase 2: "
                             f"{set(forward) - set(by_key)}")
    out = {"shapes": [{"at": r["what"], "ms": r["ms"], "queued_ms": r["queued_ms"],
                       "launches_per_call": r["launches_per_call"], "bound_ms": r["bound_ms"],
                       "bound_by": r["bound_by"], "calls_per_forward": forward.get(key, 0)}
                      for key, r in by_key.items()],
           "forward_ms": sum(k * by_key[key]["ms"] for key, k in forward.items()),
           "forward_queued_ms": sum(k * by_key[key]["queued_ms"] for key, k in forward.items())}
    print(f"kernel E stats over one fused forward ({sum(forward.values())} calls): "
          f"{out['forward_ms']:.3f} ms single calls, {out['forward_queued_ms']:.3f} ms queued")
    return out


def phase_probe_path() -> dict:
    """The probes' entry points as a user runs them (`python -m
    multitalent_tpu_torch.probes.<name>` is each module's main), every
    kernel's launch count set to 0 just before and read just after; each
    count must equal what the probes' own arguments launch."""
    from multitalent_tpu_torch.probes import (_util, conv_cost_isolate, conv_impl_arms,
                                              grid_overhead_probe, sparse_conv_arm)
    iters = str(PROBE_ITERS)
    t0 = time.perf_counter()
    results, launches = _run_counted(lambda: {
        "conv_impl_arms": conv_impl_arms.main(["--iters", iters]),
        "sparse_conv_arm": sparse_conv_arm.main(["--iters", iters]),
        "conv_cost_isolate": conv_cost_isolate.main([iters]),
        "grid_overhead_probe": grid_overhead_probe.main([iters])})
    wall = time.perf_counter() - t0
    timed = _util.WARMUP + PROBE_ITERS  # launches of one timed configuration
    a_arms = sum(arm in ("tap", "sum") for arm in conv_impl_arms.ARMS)
    expect = _expect({}, 0)
    expect.update({
        # conv_impl_arms: each arm one parity call and one timed run (tap and
        # sum on kernel A); conv_cost_isolate's dense27 on kernel A
        "conv3d_same": a_arms * (1 + timed) + timed,
        **{k: 1 + timed for k in conv_impl_arms.kernels()},
        # sparse_conv_arm: the parity cases, then the timed shapes;
        # conv_cost_isolate's merged12
        "packed_conv3d": len(sparse_conv_arm.PARITY_CASES)
        + len(sparse_conv_arm.TIMED_CASES) * timed + timed,
        # conv_cost_isolate's center27 and center12; the grid probe's configs
        "centern": 2 * timed + len(grid_overhead_probe.CONV_CONFIGS) * timed,
        "zeros": len(grid_overhead_probe.ZERO_TILES) * timed})
    if launches != expect:
        raise AssertionError(f"probe path launches {launches}, expected {expect}")
    # the arms' probe runs C = 120: every im2col, tap3 and wino launch on
    # the TMA + wgmma body
    bodies = {k: dict(BODY_COUNTS[k]) for k in conv_impl_arms.kernels()}
    want = {k: {**dict.fromkeys(conv_impl_arms.ARM_BODIES, 0), "tma": expect[k]}
            for k in conv_impl_arms.kernels()}
    if bodies != want:
        raise AssertionError(f"probe path launches by body {bodies}, expected {want}")
    names = [k for k, v in expect.items() if v]
    print(f"probe path ({wall:.1f} s): launches { {k: launches[k] for k in names} } = the "
          f"probes' parity calls + {timed} per timed configuration; by body {bodies}")
    return {"launches": launches, "launches_by_body": bodies, "results": results,
            "seconds": wall}


def phase_wgmma_forms() -> dict:
    """The wgmma body's readings (probes/wgmma_forms.py): the one-wgmma
    probe against torch, the body as it is, copies only and products only at
    the flagship's shapes it runs, and the host's us a call."""
    import torch
    from multitalent_tpu_torch.probes import wgmma_forms as wf
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    return {"probe": wf.probe(dev, gen), "forms": wf.forms(dev, gen),
            "host": wf.host_us(dev, gen)}


def _nan_filled(shape, dev):
    """A bf16 output buffer of NaN for a checked launch: a kernel that leaves
    any of it unwritten fails its check (a fresh buffer may hold the right
    values already, left by an earlier launch in memory the caching
    allocator hands back)."""
    import torch
    return torch.full(tuple(shape), float("nan"), dtype=torch.bfloat16, device=dev)


def _nan_stats(n: int, c: int, dev):
    """Kernel D's stats buffer (n, 2, c) fp32, filled with NaN for the same
    reason."""
    import torch
    return torch.full((n, 2, c), float("nan"), dtype=torch.float32, device=dev)


def phase_probe_kernels() -> dict:
    """Each probe kernel against its plain version at the shapes its script
    times, with its bound, its median time beside the plain version's and
    the library call's where one PyTorch call computes the same function;
    the Winograd kernel also against its control (G with one row wrong),
    which must break its bound."""
    import torch
    import torch.nn.functional as F
    from multitalent_tpu_torch.ops import conv3d as cv
    from multitalent_tpu_torch.probes import conv_cost_isolate as cc
    from multitalent_tpu_torch.probes import conv_impl_arms as ca
    from multitalent_tpu_torch.probes import grid_overhead_probe as gp
    from multitalent_tpu_torch.probes import sparse_conv_arm as sc
    from multitalent_tpu_torch.probes.probe_bodies import CENTERN_CONFIGS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows = {}
    arm_plans = {"im2col": ca.im2col_plan, "tap3": ca.tap3_plan, "wino": ca.wino_plan}

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    def report(name, what, err, bound, kernel, plain, library, work, **extra):
        ms, plain_ms = _median_ms(kernel), _median_ms(plain)
        library_ms = None if library is None else _median_ms(library)
        lib = "none" if library_ms is None else f"{library_ms:.3f} ms"
        print(f"{name} {what}: max|d| {err:.3e} (bound {bound:.3e}); kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, library {lib}; bound {work['bound_ms']:.3f} ms "
              f"({work['bound_by']})" + "".join(f", {k} {v}" for k, v in extra.items()))
        rows.setdefault(name, []).append({"what": what, "err": err, "ms": ms,
                                          "plain_ms": plain_ms, "library_ms": library_ms,
                                          **work, **extra})

    # the conv arms at (2, 96, 96, 96, 120) -> 120, against the fp32 direct
    # conv on the same bf16 input with the fp32 weight
    n, sp, c = ARM_SHAPE[0], ARM_SHAPE[1:4], ARM_SHAPE[4]
    x = rnd(*ARM_SHAPE).to(torch.bfloat16)
    w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
    x32 = x.float()
    ref = cv.conv3d_same_ref(x32, w)
    bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    cudnn = lambda: F.conv3d(x_cl, w_cl, padding=1)  # noqa: E731
    work = _conv_bound(c, c, sp, n)
    for arm, name in (("tap", "conv3d_same"), ("sum", "conv3d_same"), ("im2col", "conv3d_im2col"),
                      ("tap3", "conv3d_tap3"), ("wino", "conv3d_wino")):
        pw = ca.prepare(w, arm)
        if name == "conv3d_same":
            got = ca.run_arm(arm, x, pw)
        else:
            got = ca.kernels()[name](x, pw, out=_nan_filled((*ARM_SHAPE[:4], c), dev))
        err = _check(f"{arm} arm", got, ref, bound)
        del got
        extra = {"arm": arm}
        if arm == "wino":
            faulty = ca.prepare_arm_weight(w, "wino", g=ca.G_FAULTY)
            d = (ca.conv3d_wino(x, faulty).float() - ref).abs()
            extra.update(control_max=d.max().item(), control_mean=d.mean().item())
            if not d.max().item() > bound:
                raise AssertionError(f"the Winograd bound passes a faulty G: {extra}")
            pw32 = ca.prepare_arm_weight(w, "wino", dtype=torch.float32)
            plain = lambda: ca.winograd_conv3d_ref(x32, pw32)  # noqa: E731
            # against its own plain version, U rounded as the kernel's and V
            # rounded to bf16 as the kernel rounds it
            own = ca.winograd_conv3d_ref(x32, pw, v_dtype=torch.bfloat16)
            own_bound = WINO_SELF_ATOL + WINO_SELF_RTOL * own.abs().max().item()
            extra.update(own_err=_check("wino arm vs its plain version", ca.conv3d_wino(
                x, pw, out=_nan_filled((*ARM_SHAPE[:4], c), dev)), own, own_bound),
                own_bound=own_bound)
            del own
        else:
            plain = lambda: cv.conv3d_same_ref(x32, w)  # noqa: E731
        if name != "conv3d_same":  # the body, what it stages into shared memory
            plan = arm_plans[arm](*ARM_SHAPE, c)
            extra.update(body=plan["body"], l2_to_shared_bytes=plan["l2_to_shared_bytes"])
            if arm == "wino":  # and Winograd's own floor: its 64 GEMMs at the peak
                extra["products_floor_ms"] = round(
                    ca.products_floor_ms(plan["products_flops"]), 4)
        report(name, f"{arm} {c}->{c} at {'x'.join(map(str, sp))} N={n}", err, bound,
               lambda: ca.run_arm(arm, x, pw), plain, cudnn, work, **extra)
    del x, x32, ref, x_cl
    torch.cuda.empty_cache()
    # each arm's first body, which takes C % 8 != 0
    shape, cout = FIRST_BODY_SHAPE
    x = rnd(*shape).to(torch.bfloat16)
    w = rnd(cout, shape[-1], 3, 3, 3, scale=(2.0 / (27 * shape[-1])) ** 0.5)
    ref = cv.conv3d_same_ref(x.float(), w)
    bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
    x_cl = x.permute(0, 4, 1, 2, 3)
    w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
    for arm, name in (("im2col", "conv3d_im2col"), ("tap3", "conv3d_tap3"),
                      ("wino", "conv3d_wino")):
        kernel = ca.kernels()[name]
        pw = ca.prepare_arm_weight(w, arm)
        plan = arm_plans[arm](*shape, cout)
        before = dict(kernel.launches_by_body)
        err = _check(f"{arm} arm {shape} -> {cout}",
                     kernel(x, pw, out=_nan_filled((*shape[:4], cout), dev)), ref, bound)
        if plan["body"] != "mma_sync" or kernel.launches_by_body["mma_sync"] != \
                before["mma_sync"] + 1:
            raise AssertionError(f"{arm} at {shape}: plan {plan}, launches by body "
                                 f"{kernel.launches_by_body} (before {before})")
        report(name, f"{arm} {shape[-1]}->{cout} at {'x'.join(map(str, shape[1:4]))} "
               f"N={shape[0]}", err, bound, lambda: kernel(x, pw),
               lambda: cv.conv3d_same_ref(x.float(), w), lambda: F.conv3d(x_cl, w_cl, padding=1),
               _conv_bound(shape[-1], cout, shape[1:4], shape[0]), arm=arm, body=plan["body"],
               l2_to_shared_bytes=plan["l2_to_shared_bytes"])
    del x, ref, x_cl

    # the packed conv at the flagship's stage 0 and stage 1
    for shape, factors in PACKED_CASES:
        c = shape[-1]
        xp = sc.space_to_depth_yx(rnd(*shape).to(torch.bfloat16), factors).contiguous()
        w = rnd(c, c, 3, 3, 3, scale=(2.0 / (27 * c)) ** 0.5)
        pw = cv.prepare_conv3d_weight(w)
        ref = sc.packed_conv3d_ref(xp.float(), w, factors)
        bound = sc.ATOL + sc.RTOL * ref.abs().max().item()
        err = _check(f"packed conv {shape} {factors}",
                     sc.packed_conv3d(xp, pw, factors, out=_nan_filled(xp.shape, dev)), ref,
                     bound)
        # kernel A on the unpacked tensor: the packed conv runs A's plan with
        # the K loop whole, so where A's plan has one split (both shapes) the
        # outputs agree bit for bit
        xu = sc.depth_to_space_yx(xp, factors).contiguous()
        x_cl = xu.permute(0, 4, 1, 2, 3)
        w_cl = w.to(torch.bfloat16).contiguous(memory_format=torch.channels_last_3d)
        a_plan = cv.conv3d_same_plan(*shape[:4], c, c, "a")
        plan = cv.conv3d_same_plan(*shape[:4], c, c, "packed")
        bit_equal = torch.equal(sc.packed_conv3d(xp, pw, factors),
                                sc.space_to_depth_yx(cv.conv3d_same(xu, pw), factors))
        if a_plan["splits"] != 1 or not bit_equal:
            raise AssertionError(f"packed conv {shape} {factors}: bit-equal to kernel A "
                                 f"{bit_equal}, A's plan {a_plan}")
        report("packed_conv3d", f"{c}->{c} at {'x'.join(map(str, shape[1:4]))} packed "
               f"{factors}", err, bound, lambda: sc.packed_conv3d(xp, pw, factors),
               lambda: sc.packed_conv3d_ref(xp.float(), w, factors), None,
               _conv_bound(c, c, shape[1:4], shape[0]),
               cudnn_unpacked_ms=round(_median_ms(lambda: F.conv3d(x_cl, w_cl, padding=1)), 4),
               a_unpacked_ms=round(_median_ms(lambda: cv.conv3d_same(xu, pw)), 4),
               bit_equal_to_a=bit_equal,
               plan={k: plan[k] for k in ("g", "resident", "ksplit", "stages", "splits",
                                          "grid_x", "smem_bytes")})
        del xp, xu, ref, x_cl
    torch.cuda.empty_cache()

    # the center-view conv and the zero fill at (1, 96, 96, 96, 128); the
    # library call of centern: one einsum over the ndots weight matrices.
    # centern's function is x @ (the sum of its ndots weight matrices): its
    # bound is that one GEMM beside its bytes (x read, out written, the
    # weight read once); the ndots GEMMs the kernel issues, at the peak rate,
    # are its form's ceiling (ndots_ceiling_ms), the probe's question
    n, sp, c = PROBE_SHAPE[0], PROBE_SHAPE[1:4], PROBE_SHAPE[4]
    x = rnd(*PROBE_SHAPE).to(torch.bfloat16)
    w = rnd(c, c, 3, 3, 3, scale=0.05)
    w_bf = w.to(torch.bfloat16)
    wc = cc.prepare_center_weight(w)
    vox = n * prod(sp)
    centern_bytes = vox * 2 * c * 2 + 27 * c * c * 2
    for tile, ndots in CENTERN_CONFIGS:
        ref = cc.centern_ref(x.float(), w_bf.float(), ndots)
        bound = ca.ATOL + ca.RTOL * ref.abs().max().item()
        err = _check(f"centern {ndots} dots tile {tile}",
                     cc.centern(x, wc, ndots, tile, out=_nan_filled(x.shape, dev)), ref, bound)
        stack = torch.stack([w_bf[:, :, a, b, d].T for a, b, d in
                             (cc.tap_of_dot(t) for t in range(ndots))]).contiguous()
        x2 = x.reshape(-1, c)
        ceiling = _bound(centern_bytes, bf16_flops=2 * ndots * c * c * vox)["bound_ms"]
        plan = cc.centern_plan(n, sp, c, ndots, tile)
        report("centern", f"{ndots} dots at {'x'.join(map(str, sp))}x{c} tile {tile}", err,
               bound, lambda: cc.centern(x, wc, ndots, tile),
               lambda: cc.centern_ref(x.float(), w_bf.float(), ndots),
               lambda: torch.einsum("mc,tco->mo", x2, stack),
               _bound(centern_bytes, bf16_flops=2 * c * c * vox),
               tiles=plan["tiles"], ndots_ceiling_ms=round(ceiling, 4), body=plan["body"],
               sub_tile=plan["sub_tile"], blocks=plan["grid"],
               l2_to_shared_bytes=plan["l2_to_shared_bytes"])
        rows["centern"][-1]["share_of_ceiling"] = round(ceiling / rows["centern"][-1]["ms"], 4)
        print(f"centern {ndots} dots tile {tile}: {rows['centern'][-1]['share_of_ceiling']:.1%} "
              f"of its ndots ceiling")
        del ref
    # the zero fill into one buffer (as zero_), its form by zeros_plan; the
    # queued times (iters calls between one event pair) beside single calls,
    # GB/s in all and a block (the queued rate over the blocks), and the
    # host's us a call of each
    shape = (*sp, c)
    buf = torch.empty(shape, dtype=torch.bfloat16, device=dev)
    for tile in gp.ZERO_TILES:
        got = gp.zeros(shape, tile, dev, out=buf.fill_(float("nan")))
        bad = (got != 0).sum().item()
        if got.data_ptr() != buf.data_ptr() or bad:
            raise AssertionError(f"zeros tile {tile}: {bad} values are not 0")
        plan = gp.zeros_plan(shape, tile)
        fill = lambda: gp.zeros(shape, tile, dev, out=buf)  # noqa: E731
        queued = _queued_ms(fill)
        report("zeros", f"{'x'.join(map(str, sp))}x{c} bf16 tile {tile}", 0.0, 0.0, fill,
               lambda: gp.zeros_ref(shape, device=dev), buf.zero_, _bound(prod(shape) * 2),
               grid=plan["blocks"], form=plan["form"], runs=plan["runs"],
               run_bytes=plan["run_bytes"], queued_ms=round(queued, 4),
               library_queued_ms=round(_queued_ms(buf.zero_), 4),
               gbps=round(prod(shape) * 2 / queued / 1e6, 2),
               gbps_per_block=round(prod(shape) * 2 / queued / 1e6 / plan["blocks"], 3),
               host_us=round(_host_us(fill), 2), library_host_us=round(_host_us(buf.zero_), 2))
    del x, buf, got
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    started, seconds = time.perf_counter(), {}

    def timed(label, fn, *args, **kwargs):
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        seconds[label] = round(time.perf_counter() - t0, 1)
        print(f"phase {label}: {seconds[label]} s")
        return result

    name, smi, build_s = timed("1", phase_device)
    kernels = timed("2", phase_kernels)
    fused_kernels = timed("2b", phase_fused_kernels)
    liver_kernels = timed("2 Liver", phase_kernels, LIVER_A_SHAPES, LIVER_B_SHAPES,
                          batches=(1, LIVER_TTA_CHUNK), backward=False)
    liver_fused_kernels = timed("2b Liver", phase_fused_kernels, LIVER_A_SHAPES,
                                LIVER_B_SHAPES, LIVER_A_SHAPES, batches=(1, LIVER_TTA_CHUNK),
                                norm_batches=(1, LIVER_TTA_CHUNK), classes=LIVER_CLASSES)
    swin_kernels = timed("2 SwinUNETR", phase_kernels, SWIN_A_SHAPES, SWIN_B_SHAPES)
    workdir = tempfile.mkdtemp(prefix="chip_smoke_")
    # the flagship's predict and training phases run the sliding window's
    # exact mode, as they did before the default mode was ported, so that
    # their counts, bounds and history stay comparable
    exact = {"MTTPU_SW_EXACT": "1"}
    try:
        with _env(**exact):
            main_path = timed("3", phase_main_path, workdir)
            main_fused = timed("3b", phase_main_path, workdir, fused=True)
        install = timed("16a released zip", phase_install, workdir, main_path)
        masks = compare_masks(main_path, main_fused)
        liver = timed("3c Liver", phase_liver, workdir)
        tile = timed("4", phase_tile_probabilities)
        tile_fused = timed("4b", phase_fused_tile_probabilities)
        with _env(**exact):
            training = timed("5", phase_training, workdir)
            training_fused = timed("5b", phase_training, workdir, fused=True)
            fused_val = timed("5c fused -val", phase_fused_validation, workdir, training)
            jax_folder = timed("5d JAX-layout folder", phase_jax_folder, workdir, training)
            warmup = timed("5e warm-up", phase_warmup, workdir, jax_folder)
            resenc = timed("8a resenc train", phase_resenc_training, workdir)
            resenc_predict = timed("8b resenc predict", phase_resenc_predict, workdir, resenc)
        resenc_tile = timed("8c resenc tile", phase_resenc_tile)
        with _env(**exact):
            resenc_jax = timed("8d resenc JAX-layout folder", phase_resenc_jax_folder, workdir,
                               resenc, resenc_predict)
            resenc_warmup = timed("8e resenc warm-up", phase_resenc_warmup, workdir, resenc_jax)
        resenc_liver = timed("8f resenc Liver", phase_resenc_liver, workdir)
        with _env(**exact):
            ddp_launched = timed("9a DDP launched", phase_ddp_launched, workdir)
        ddp = timed("9b-9c DDP 2 ranks gloo (and 9d's ranks)", phase_ddp_ranks, workdir)
        if torch.cuda.device_count() >= 2:
            timed("9b NCCL 2 cards", phase_ddp_ranks, workdir, "nccl")
        else:
            print(f"phase 9b over NCCL on two cards: skipped, {torch.cuda.device_count()} "
                  f"card visible")
        # 9b's spawns ran 9d's ranks too
        space = timed("9d space axis 2 ranks gloo", phase_space_ranks, workdir)
        if torch.cuda.device_count() >= SPACE_RANKS:
            timed("9d NCCL 2 cards", phase_space_ranks, workdir, "nccl")
        else:
            print(f"phase 9d over NCCL on two cards: skipped, {torch.cuda.device_count()} "
                  f"card visible")
        raw_generic = timed("10a generic workflow from raw", phase_raw_generic, workdir)
        raw_mt = timed("10b MultiTalent workflow from raw", phase_raw_multitalent, workdir,
                       raw_generic)
        swin = timed("11a SwinUNETR train", phase_swin_training, workdir)
        swin_predict = timed("11b SwinUNETR predict", phase_swin_predict, workdir, swin)
        swin_tile = timed("11c SwinUNETR tile", phase_swin_tile)
        swin_jax = timed("11d SwinUNETR JAX-layout folder", phase_swin_jax_folder, workdir, swin)
        swin_warmup = timed("11e SwinUNETR warm-up", phase_swin_warmup, workdir, swin_jax)
        swin_liver = timed("11f SwinUNETR Liver", phase_swin_liver, workdir, raw_generic)
        mednext = timed("12a MedNeXt train", phase_mednext_training, workdir)
        mednext_predict = timed("12b MedNeXt restore + predict", phase_mednext_predict, workdir,
                                mednext)
        mednext_tile = timed("12c MedNeXt tile", phase_mednext_tile)
        cascade = timed("13 cascade", phase_cascade, workdir, raw_generic)
        fp32_kernels = timed("14a fp32 kernels", phase_fp32_kernels)
        fp32_fused_kernels = timed("14a fp32 D, E, F", phase_fp32_fused_kernels)
        fp32_train = timed("14b fp32 train + predict", phase_fp32_training, workdir,
                           raw_generic)
        fp32_fused = timed("14b fused fp32 train + predict", phase_fp32_fused, workdir,
                           raw_generic, fp32_train)
        fp32_d_shapes = timed("14a fp32 D shapes", phase_fp32_d_shapes, fp32_fused["d_shapes"])
        two_d = timed("14c 2D", phase_2d, workdir, raw_generic)
        variants = timed("14d variants", phase_variants, workdir, raw_generic)
        zoo = timed("15a-c trainer zoo", phase_zoo, workdir, raw_generic, two_d)
        zoo_schedules = timed("15d schedules", phase_zoo_schedules, raw_generic)
        sources = timed("16b sources", phase_sources, os.path.join(workdir, "sources"),
                        raw_generic)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    probe_path = timed("6 probe path", phase_probe_path)
    probes = timed("6 probe kernels", phase_probe_kernels)
    wgmma = timed("6 wgmma probe and forms", phase_wgmma_forms)

    a_src = "multitalent_tpu_torch/csrc/conv3d_same.cu"
    rows = []
    for kname, src, replaces, res in (
            ("conv3d_same", a_src, ("multitalent_tpu/ops/pallas_conv.py:36",
                                    "multitalent_tpu/ops/pallas_merged_conv.py:103"),
             kernels["conv3d_same"] + kernels["conv3d_same_dx"]),
            ("conv3d_same_dual", a_src, ("multitalent_tpu/ops/pallas_merged_conv.py:251",),
             kernels["conv3d_same_dual"]),
            ("conv3d_same_wgrad", "multitalent_tpu_torch/csrc/conv3d_wgrad.cu",
             ("multitalent_tpu/ops/pallas_conv.py:199",
              "multitalent_tpu/ops/pallas_merged_conv.py:587"),
             kernels["conv3d_same_wgrad"])):
        stage0 = res[0]  # the widest shape: stage 0 at 96x192x192
        wgrad = kname == "conv3d_same_wgrad"
        # one cuDNN call computes A's and C's function on the same inputs; B's
        # needs the concat built first (its cuDNN time stays as cudnn_bf16_ms)
        library_ms = None if kname == "conv3d_same_dual" else stage0["cudnn_bf16_ms"]
        rows.append({"name": kname, "route": "cuda", "source": src,
                     "replaces": replaces[0], "also_replaces": list(replaces[1:]),
                     "launches": training["launches"][kname],
                     "launches_predict": main_path["launches"][kname],
                     "launches_train_fused": training_fused["launches"][kname],
                     "launches_probes": probe_path["launches"][kname],
                     "launches_warmup": warmup["launches"][kname],
                     "launches_ddp": ddp_launched["launches"][kname],
                     "launches_space": space["space"]["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": stage0["ms"], "plain_ms": stage0["plain_ms"],
                     **_conv_bound(sum(stage0["splits"]), stage0["cout"], stage0["spatial"],
                                   stage0["n"], w_bytes=4 if wgrad else 2),
                     "library_ms": library_ms, "cudnn_bf16_ms": stage0["cudnn_bf16_ms"],
                     "timed_at": "{}->{} at {} N={}".format(
                         "+".join(map(str, stage0["splits"])), stage0["cout"],
                         "x".join(map(str, stage0["spatial"])), stage0["n"])})
    wgrad_step = _wgrad_step(kernels["conv3d_same_wgrad"], training["dw_shapes"])
    rows[-1].update(wgrad_step)
    a_sums = _sums("kernel A", kernels["conv3d_same"] + kernels["conv3d_same_dx"],
                   "cudnn_bf16_ms", forward=tile["a_shapes"], step=training["a_shapes"])
    rows[0].update(a_sums)
    b_sums = _sums("kernel B", kernels["conv3d_same_dual"], "cudnn_bf16_ms",
                   forward=tile["b_shapes"], step=training["b_shapes"])
    rows[1].update(b_sums)
    # the resenc (phase 8): A's, B's and C's launches (R: the train CLI's 4
    # steps and validation; predict, JAX-layout predict, warm-up, Liver) and
    # their times summed over one resenc forward (8c, N=1) and step (8a, N=2)
    # at the phase-2 times of its shapes, which are the flagship's
    resenc_sums = [
        _sums("kernel A, resenc", kernels["conv3d_same"] + kernels["conv3d_same_dx"],
              "cudnn_bf16_ms", forward=resenc_tile["a_shapes"], step=resenc["a_shapes"]),
        _sums("kernel B, resenc", kernels["conv3d_same_dual"], "cudnn_bf16_ms",
              forward=resenc_tile["b_shapes"], step=resenc["b_shapes"]),
        _wgrad_step(kernels["conv3d_same_wgrad"], resenc["dw_shapes"], "kernel C, resenc")]
    for row, sums in zip(rows, resenc_sums):
        row.update(launches_raw_generic=raw_generic["launches"][row["name"]],
                   launches_raw_generic_predict=raw_generic["predict_launches"][row["name"]],
                   launches_raw_multitalent=raw_mt["launches"][row["name"]],
                   launches_raw_multitalent_predict=raw_mt["predict_launches"][row["name"]])
        row.update(launches_resenc=resenc["launches"][row["name"]],
                   launches_resenc_predict=resenc_predict["launches"][row["name"]],
                   launches_resenc_jax_folder=resenc_jax["launches"][row["name"]],
                   launches_resenc_warmup=resenc_warmup["launches"][row["name"]],
                   launches_resenc_liver=resenc_liver["launches"][row["name"]],
                   resenc={k: v for k, v in sums.items() if k != "shapes"})
    # SwinUNETR (phase 11): A's, B's and C's launches (11a's train CLI of 4
    # steps and validation, 11b's predict, 11e's warm-up, 11f's Liver train
    # CLI and predict), their times at SwinUNETR's own shapes ("2 SwinUNETR":
    # 48-768 channels, N=1 and 2) against cuDNN and the bound, and the sums
    # over one SwinUNETR forward (11c, N=1) and step (11a, N=2)
    swin_a = swin_kernels["conv3d_same"] + swin_kernels["conv3d_same_dx"]
    swin_sums = [
        _sums("kernel A, SwinUNETR", swin_a, "cudnn_bf16_ms", forward=swin_tile["a_shapes"],
              step=swin["a_shapes"]),
        _sums("kernel B, SwinUNETR", swin_kernels["conv3d_same_dual"], "cudnn_bf16_ms",
              forward=swin_tile["b_shapes"], step=swin["b_shapes"]),
        _wgrad_step(swin_kernels["conv3d_same_wgrad"], swin["dw_shapes"], "kernel C, SwinUNETR")]
    for row, timed_rows, sums in zip(rows, (swin_a, swin_kernels["conv3d_same_dual"],
                                            swin_kernels["conv3d_same_wgrad"]), swin_sums):
        kname = row["name"]
        row.update(launches_mednext=mednext["launches"][kname],
                   launches_mednext_predict=mednext_predict["launches"][kname],
                   launches_cascade_lowres=cascade["runs"]["13a"]["launches"][kname],
                   launches_cascade_fullres=cascade["runs"]["13b"]["launches"][kname],
                   launches_cascade_predict=cascade["predict_launches"][kname])
        row.update(launches_swin=swin["launches"][kname],
                   launches_swin_predict=swin_predict["launches"][kname],
                   launches_swin_warmup=swin_warmup["launches"][kname],
                   launches_swin_liver=swin_liver["launches"][kname],
                   launches_swin_liver_predict=swin_liver["predict_launches"][kname],
                   swin=sums, max_abs_err=max(row["max_abs_err"],
                                              *(r["err"] for r in timed_rows)))
    # kernel D beside the unfused route it replaces (norm + cuDNN; for the
    # dual form kernel B, no stats), over one fused forward (N=1) and one
    # fused training step's forward (N=2)
    d_sums = _sums("kernel D", fused_kernels["conv3d_same_affine"], "unfused_ms",
                   forward=tile_fused["d_shapes"], step=training_fused["d_shapes"])
    e_sums = _stats_sums(fused_kernels["channel_stats"], tile_fused["e_shapes"])
    # the fused route's kernels: launches from the fused predict CLI run (and
    # kernel D's from the fused training run), times at the stage-0 shape (N=1,
    # C = 30 at 96x192x192); one PyTorch call computes E's stats
    # (torch.var_mean) and F without its prologue (torch.mm), none the others
    c, sp = KERNEL_A_SHAPES[0]
    vox = prod(sp)
    for kname, src, replaces, work in (
            ("conv3d_same_affine", a_src, "multitalent_tpu/ops/pallas_conv.py:326",
             _affine_bound(c, c, sp, 1, prologue=True)),
            ("channel_stats", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:37", _stats_bound(c, sp, 1)),
            ("affine_lrelu", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:56",
             _bound(2 * vox * c * 2, fp32_flops=4 * vox * c)),
            ("seghead", "multitalent_tpu_torch/csrc/seghead.cu",
             "multitalent_tpu/ops/pallas_seghead.py:31", _head_bound(c, 47, sp, 1))):
        res = fused_kernels[kname]
        stage0 = res[0]
        if kname == "seghead":
            extra = {k: stage0[k] for k in ("queued_ms", "no_prologue_ms",
                                            "no_prologue_queued_ms", "library_queued_ms",
                                            "launches_per_call")}
        elif kname == "conv3d_same_affine":
            # both D forms' launches by body, and the dual form at 16-byte
            # rows (the wgmma body) beside B alone and B then E's stats
            extra = {**d_sums, "launches_by_body": {
                "predict_fused": main_fused["launches_by_body"][kname],
                "train_fused": training_fused["launches_by_body"][kname]},
                "dual_wgmma_shapes": [
                    {k: r[k] for k in ("what", "ms", "queued_ms", "unfused_ms", "b_queued_ms",
                                       "library_ms", "library_queued_ms", "bit_equal_to_b",
                                       "err", "stats_rel_err", "bound_ms", "bound_by")}
                    for r in res if r.get("body") == "wgmma"]}
        else:
            extra = {"channel_stats": e_sums}.get(kname, {})
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": main_fused["launches"][kname],
                     "launches_train_fused": training_fused["launches"][kname],
                     "launches_val_fused": fused_val["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": stage0["ms"], "plain_ms": stage0["plain_ms"], **work,
                     "library_ms": stage0.get("library_ms"),
                     "unfused_route_ms": stage0["unfused_ms"],
                     "timed_at": stage0["what"], **extra})
    # the Liver net's shapes (phases 2 and 2b at the Liver's shapes) and
    # launches (phase 3c's default-mode predict CLI: unfused for A and B,
    # fused for D, E and F)
    liver_timed = {**{k: liver_kernels[k] for k in ("conv3d_same", "conv3d_same_dual")},
                   **liver_fused_kernels}
    for row in rows:
        if row["name"] in liver_timed:
            run = "normal" if row["name"] in ("conv3d_same", "conv3d_same_dual") else "fused"
            row["launches_liver"] = liver["runs"][run]["launches"][row["name"]]
            row["liver_shapes"] = [_timed_entry(r) for r in liver_timed[row["name"]]]
            row["max_abs_err"] = max(row["max_abs_err"],
                                     *(r["err"] for r in liver_timed[row["name"]]))
    # the probes' kernels: launches from the probe path, times at the first
    # shape each was timed at in phase 6
    for kname, src, replaces in (
            ("conv3d_im2col", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("conv3d_tap3", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("conv3d_wino", "multitalent_tpu_torch/csrc/conv_arms.cu",
             "scripts/conv_impl_arms.py:42"),
            ("packed_conv3d", a_src, "scripts/pallas_sparse_conv_arm.py:165"),
            ("centern", "multitalent_tpu_torch/csrc/probe_kernels.cu",
             "scripts/conv_cost_isolate.py:48"),
            ("zeros", "multitalent_tpu_torch/csrc/probe_kernels.cu",
             "scripts/grid_overhead_probe.py:49")):
        res = probes[kname]
        first = res[0]
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     **({"also_replaces": ["scripts/grid_overhead_probe.py:68"],
                         "ndots_ceiling_ms": first["ndots_ceiling_ms"]}
                        if kname == "centern" else {}),
                     "launches": probe_path["launches"][kname],
                     "max_abs_err": max(r["err"] for r in res),
                     "ms": first["ms"], "plain_ms": first["plain_ms"],
                     "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                     "library_ms": first["library_ms"], "timed_at": first["what"]})
        if kname in ("conv3d_im2col", "conv3d_tap3", "conv3d_wino", "centern",
                     "packed_conv3d", "zeros"):
            # the redesigned bodies: every row
            keys = ("err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "body",
                    "l2_to_shared_bytes", "ndots_ceiling_ms", "share_of_ceiling", "sub_tile",
                    "tiles", "blocks", "products_floor_ms", "own_err", "own_bound",
                    "control_max", "cudnn_unpacked_ms", "a_unpacked_ms", "bit_equal_to_a",
                    "plan", "grid", "form", "runs", "run_bytes", "queued_ms",
                    "library_queued_ms", "gbps", "gbps_per_block", "host_us",
                    "library_host_us")
            rows[-1]["shapes"] = [{"at": r["what"], **{k: r[k] for k in keys if k in r}}
                                  for r in res]
            if kname in probe_path["launches_by_body"]:
                rows[-1]["launches_by_body"] = probe_path["launches_by_body"][kname]
    # the fp32 forms of A, B and C (phase 14): launches from 14b's fp32 train
    # CLI (the main path of --fp32) and its cli.predict, times at 14a's Liver
    # shapes (N=2) beside cuDNN's fp32 call (TF32 off; B's on the concat
    # built beforehand, so no library call computes its function)
    for kname, src_replaces in (
            ("conv3d_same_fp32", ("multitalent_tpu/ops/pallas_conv.py:36",
                                  "multitalent_tpu/ops/pallas_merged_conv.py:103")),
            ("conv3d_same_dual_fp32", ("multitalent_tpu/ops/pallas_merged_conv.py:251",)),
            ("conv3d_same_wgrad_fp32", ("multitalent_tpu/ops/pallas_conv.py:199",
                                        "multitalent_tpu/ops/pallas_merged_conv.py:587"))):
        r = fp32_kernels[kname]
        # A's rows on the ring body: its forwards and every dx; B's: the dual convs
        shapes = [s for s in fp32_kernels["ab_shapes"] if kname != "conv3d_same_wgrad_fp32"
                  and (s["form"] == "B") == (kname == "conv3d_same_dual_fp32")]
        rows.append({"name": kname, "route": "cuda",
                     "source": "multitalent_tpu_torch/csrc/conv3d_fp32.cu",
                     "replaces": src_replaces[0], "also_replaces": list(src_replaces[1:]),
                     "launches": fp32_train["launches"][kname],
                     "launches_predict": fp32_train["predict_launches"][kname],
                     "max_abs_err": max([r["err"]] + [s["err"] for s in shapes] + (
                         [s["err"] for s in fp32_kernels["wgrad_shapes"]["shapes"]]
                         if kname == "conv3d_same_wgrad_fp32" else [])),
                     "rel_err": r["rel_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": None if kname == "conv3d_same_dual_fp32"
                     else r["cudnn_fp32_ms"],
                     "cudnn_fp32_ms": r["cudnn_fp32_ms"],
                     **({"write": r["write"]} if "write" in r else {}),
                     "launches_fused": fp32_fused["launches"][kname],
                     **({"shapes": shapes} if shapes else {}),
                     **({"body": "wgrad_fp32_ring_kernel<DUAL>",
                         "launches_by_body": {"train": fp32_train["launches_by_body"][kname],
                                              "train_fused":
                                                  fp32_fused["launches_by_body"][kname]},
                         "shapes": fp32_kernels["wgrad_shapes"]["shapes"],
                         **{k: v for k, v in fp32_kernels["wgrad_shapes"].items()
                            if k != "shapes"}}
                        if kname == "conv3d_same_wgrad_fp32" else {}),
                     "timed_at": "{}->{} at {} N={}".format(
                         "+".join(map(str, r["splits"])), r["cout"],
                         "x".join(map(str, r["spatial"])), r["n"])})
    # the fp32 forms of D, E and F (14a's times at the Liver's stage 0, N=2;
    # launches from 14b's fused fp32 train CLI and its fused cli.predict)
    for kname, src, replaces in (
            ("conv3d_same_affine_fp32", "multitalent_tpu_torch/csrc/conv3d_fp32.cu",
             "multitalent_tpu/ops/pallas_conv.py:326"),
            ("channel_stats_fp32", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:37"),
            ("affine_lrelu_fp32", "multitalent_tpu_torch/csrc/fused_norm.cu",
             "multitalent_tpu/ops/fused_norm.py:56"),
            ("seghead_fp32", "multitalent_tpu_torch/csrc/seghead.cu",
             "multitalent_tpu/ops/pallas_seghead.py:31")):
        r = fp32_fused_kernels[kname]
        rows.append({"name": kname, "route": "cuda", "source": src, "replaces": replaces,
                     "launches": fp32_fused["launches"][kname],
                     "launches_predict": fp32_fused["predict_launches"][kname],
                     "max_abs_err": max([r.get("max_err", r["err"])] + (
                         [s["err"] for s in fp32_d_shapes["shapes"]]
                         if kname == "conv3d_same_affine_fp32" else [])),
                     "rel_err": r["rel_err"],
                     "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                     "timed_at": r["what"],
                     **({"body": "conv_fp32_ring_kernel<DUAL, AFFINE, STATS>",
                         "launches_by_body": {"train_fused":
                                              fp32_fused["launches_by_body"][kname]},
                         "shapes": fp32_d_shapes["shapes"],
                         **{k: v for k, v in fp32_d_shapes.items() if k != "shapes"}}
                        if kname == "conv3d_same_affine_fp32" else {}),
                     **{k: r[k] for k in ("unfused_route_ms", "dual", "queued_ms",
                                          "launches_per_call", "no_prologue_ms",
                                          "values_differing", "stats_max_abs_err",
                                          "stats_rel_err") if k in r}})
    for row in rows[:2]:  # A and B: phase 16a's predict from the installed zip
        row["launches_install"] = install["launches"][row["name"]]
    for row in rows:
        row["launches_variants"] = sum(v["launches"].get(row["name"], 0)
                                       for v in variants.values())
        row["launches_zoo"] = sum(r[key].get(row["name"], 0) for r in zoo.values()
                                  for key in ("launches", "predict_launches") if key in r) + sum(
            r["validation"]["launches"].get(row["name"], 0) for r in zoo.values()
            if "validation" in r)
    # the wgmma body of A and B (csrc/conv3d_wgmma.cu): its launches in
    # phases 3 (predict) and 5 (the training run and one of its steps), each
    # body's launches in A's and B's rows; times at the first flagship shape
    # it runs in phase 2 (A 120 -> 120, N=1), every phase-2 shape it ran, the
    # one-wgmma probe, its copies-only and products-only forms and the host's
    # us a call (phase 6)
    ab = ("conv3d_same", "conv3d_same_dual")
    for row in rows[:2]:
        row["launches_by_body"] = {
            "predict": main_path["launches_by_body"][row["name"]],
            "train": training["launches_by_body"][row["name"]],
            "train_step": training["step_launches_by_body"][row["name"]]}
    on_body = [(net, r) for net, res in (("flagship", kernels), ("Liver", liver_kernels),
                                         ("SwinUNETR", swin_kernels))
               for name in ("conv3d_same", "conv3d_same_dx", "conv3d_same_dual")
               for r in res.get(name, []) if r["plan"]["wgmma"]]
    first = on_body[0][1]
    rows.append({"name": "conv3d_same_wgmma", "route": "cuda",
                 "source": "multitalent_tpu_torch/csrc/conv3d_wgmma.cu",
                 "replaces": "multitalent_tpu/ops/pallas_conv.py:36",
                 "also_replaces": ["multitalent_tpu/ops/pallas_merged_conv.py:103",
                                   "multitalent_tpu/ops/pallas_merged_conv.py:251"],
                 "launches": sum(training["launches_by_body"][k]["wgmma"] for k in ab),
                 "launches_predict": sum(main_path["launches_by_body"][k]["wgmma"] for k in ab),
                 "launches_step": sum(training["step_launches_by_body"][k]["wgmma"]
                                      for k in ab),
                 "max_abs_err": max(r["err"] for _, r in on_body),
                 "ms": first["ms"], "plain_ms": first["plain_ms"],
                 "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                 "library_ms": first["cudnn_bf16_ms"], "timed_at": _timed_entry(first)["at"],
                 "shapes": [{"net": net, **_timed_entry(r), "plan": r["plan"]}
                            for net, r in on_body],
                 **wgmma})
    lr = liver["runs"]
    print("summary, Liver (phase 3c): seconds per case " + ", ".join(
        f"{k} {lr[k]['seconds_per_case']:.2f} (predict {lr[k]['predict_s']:.2f}, export "
        f"{lr[k]['export_s']:.2f})" for k in ("normal", "fused", "exact", "fast", "fastest",
                                              "z0", "z1"))
          + "; forward at 128^3 " + ", ".join(f"{k} {v:.2f} ms"
                                             for k, v in liver["forward"].items()))
    print(f"summary: build {build_s:.1f} s; seconds per case {main_path['seconds_per_case']:.2f}"
          f" unfused, {main_fused['seconds_per_case']:.2f} fused (masks: worst region "
          f"{masks['worst']:.6f}); one forward {tile_fused['unfused_forward_ms']:.2f} ms "
          f"unfused, {tile_fused['fused_forward_ms']:.2f} ms fused; seconds per training "
          f"step {training['seconds_per_step']:.3f} unfused, "
          f"{training_fused['seconds_per_step']:.3f} fused; peak {training['peak_gib']:.2f} "
          f"GiB unfused, {training_fused['peak_gib']:.2f} GiB fused; kernel A over a forward "
          f"{a_sums['forward_ms']:.3f} ms (cuDNN {a_sums['forward_cudnn_bf16_ms']:.3f} ms), over "
          f"a step {a_sums['step_ms']:.3f} ms (cuDNN {a_sums['step_cudnn_bf16_ms']:.3f} ms); "
          f"kernel B over a forward {b_sums['forward_ms']:.3f} ms (cuDNN on the concat "
          f"{b_sums['forward_cudnn_bf16_ms']:.3f} ms), over a step {b_sums['step_ms']:.3f} ms "
          f"(cuDNN on the concat {b_sums['step_cudnn_bf16_ms']:.3f} ms); kernel D over a "
          f"fused forward "
          f"{d_sums['forward_ms']:.3f} ms (unfused route {d_sums['forward_unfused_ms']:.3f} ms), "
          f"over a fused step {d_sums['step_ms']:.3f} ms; kernel E stats over a fused "
          f"forward {e_sums['forward_ms']:.3f} ms (queued {e_sums['forward_queued_ms']:.3f} "
          f"ms); kernel F {fused_kernels['seghead'][0]['ms']:.3f} ms (torch.mm of its form "
          f"without the prologue {fused_kernels['seghead'][0]['library_ms']:.3f} ms); kernel C "
          f"over a step "
          f"{wgrad_step['step_ms']:.3f} ms (cuDNN {wgrad_step['step_cudnn_ms']:.3f} ms); "
          f"probe path "
          f"{probe_path['seconds']:.1f} s; validation seconds per case "
          f"{training['validation']['seconds_per_case']:.2f} unfused (after training), "
          f"{training_fused['validation']['seconds_per_case']:.2f} fused (after training), "
          f"{fused_val['validation']['seconds_per_case']:.2f} fused (-val); .ckpt folder "
          f"restored in {jax_folder['restore_s']:.2f} s; warm-up phase-1 seconds per step "
          f"{', '.join(f'{v:.3f}' for v in warmup['step_s'])}; phase seconds {seconds}; "
          f"on {smi}")
    ra, rb, rc = resenc_sums
    print(f"summary, resenc (phase 8): seconds per training step {resenc['seconds_per_step']:.3f}"
          f" (steps {', '.join(f'{v:.3f}' for v in resenc['step_s'])}); peak "
          f"{resenc['peak_gib']:.2f} GiB; validation {resenc['validation']['seconds_per_case']:.2f}"
          f" s per case; predict {resenc_predict['seconds_per_case']:.2f} s per case (predict "
          f"{resenc_predict['predict_s']:.2f}), from the .ckpt folder "
          f"{resenc_jax['seconds_per_case']:.2f} (restored in {resenc_jax['restore_s']:.2f} s); "
          f"one tile forward {resenc_tile['forward_ms']:.2f} ms; warm-up phase-1 seconds per "
          f"step {', '.join(f'{v:.3f}' for v in resenc_warmup['step_s'])}; Liver resenc case "
          f"{resenc_liver['seconds']:.2f} s (predict {resenc_liver['predict_s']:.2f}); kernel A "
          f"over a forward {ra['forward_ms']:.3f} ms (cuDNN {ra['forward_cudnn_bf16_ms']:.3f}), "
          f"over a step {ra['step_ms']:.3f} ms (cuDNN {ra['step_cudnn_bf16_ms']:.3f}); kernel B "
          f"over a forward {rb['forward_ms']:.3f} ms (cuDNN on the concat "
          f"{rb['forward_cudnn_bf16_ms']:.3f}), over a step {rb['step_ms']:.3f} ms; kernel C "
          f"over a step {rc['step_ms']:.3f} ms (cuDNN {rc['step_cudnn_ms']:.3f}); on {smi}")
    print(f"summary, data parallelism (phase 9): launched group of one (NCCL, DDP) seconds "
          f"per step {ddp_launched['step_s']['launched']:.3f} vs one process "
          f"{ddp_launched['step_s']['one process']:.3f} (without the wait for the host batch "
          f"{ddp_launched['busy_s']['launched']:.3f} vs "
          f"{ddp_launched['busy_s']['one process']:.3f}), bit-equal; 2 ranks sharing the card "
          f"(gloo): " + "; ".join(
              f"{k} update gap after step 1 {v['gap1']:.3e}, last {v['gap']:.3e}, seconds per "
              f"step {_median(v['step_s'][0][1:]):.3f} (one process "
              f"{_median(v['one_step_s'][1:]):.3f}), peak {max(v['peak_gib']):.2f} GiB a rank"
              for k, v in ddp.items() if k != "spawn_s") + f"; ranks started and ran in "
          f"{ddp['spawn_s']:.1f} s; on {smi}")
    print("summary, both workflows from raw NIfTIs (phase 10): " + "; ".join(
        f"{label} plans {r['plan']['stages']}, base {r['plan']['base_num_features']}; host "
        f"seconds {', '.join(f'{k} {v:.2f}' for k, v in r['seconds'].items())}; seconds per "
        f"step {r['seconds_per_step']:.3f}, peak {r['peak_gib']:.2f} GiB; A/B/C a step "
        f"{r['per_step']}" for label, r in (("10a", raw_generic), ("10b", raw_mt)))
          + f"; on {smi}")
    sa, sb, sc = swin_sums
    print(f"summary, SwinUNETR (phase 11): seconds per training step "
          f"{swin['seconds_per_step']:.3f} (steps {', '.join(f'{v:.3f}' for v in swin['step_s'])});"
          f" peak {swin['peak_gib']:.2f} GiB; validation "
          f"{swin['validation']['seconds_per_case']:.2f} s per case; predict "
          f"{swin_predict['seconds_per_case']:.2f} s per case (predict "
          f"{swin_predict['predict_s']:.2f}); one tile forward {swin_tile['forward_ms']:.2f} ms; "
          f".ckpt restored in {swin_jax['restore_s']:.2f} s; warm-up phase-1 seconds per step "
          f"{', '.join(f'{v:.3f}' for v in swin_warmup['step_s'])}; Liver 2 steps + validation "
          f"{swin_liver['train_s']:.1f} s (peak {swin_liver['peak_gib']:.2f} GiB), predict "
          f"{swin_liver['predict_s']:.2f} s; kernel A over a forward {sa['forward_ms']:.3f} ms "
          f"(cuDNN {sa['forward_cudnn_bf16_ms']:.3f}), over a step {sa['step_ms']:.3f} ms (cuDNN "
          f"{sa['step_cudnn_bf16_ms']:.3f}); kernel B over a forward {sb['forward_ms']:.3f} ms "
          f"(cuDNN on the concat {sb['forward_cudnn_bf16_ms']:.3f}), over a step "
          f"{sb['step_ms']:.3f} ms; kernel C over a step {sc['step_ms']:.3f} ms (cuDNN "
          f"{sc['step_cudnn_ms']:.3f}); on {smi}")
    dw = mednext["depthwise"]
    print(f"summary, MedNeXt (phase 12): seconds per training step "
          f"{mednext['seconds_per_step']:.3f} (steps "
          f"{', '.join(f'{v:.3f}' for v in mednext['step_s'])}); peak {mednext['peak_gib']:.2f} "
          f"GiB; validation {mednext['validation']['seconds_per_case']:.2f} s per case; predict "
          f"{mednext_predict['seconds_per_case']:.2f} s per case (predict "
          f"{mednext_predict['predict_s']:.2f}); restore .model "
          f"{mednext_predict['restore_s']['.model']:.2f} s, .ckpt "
          f"{mednext_predict['restore_s']['.ckpt']:.2f} s; one tile forward "
          f"{mednext_tile['forward_ms']:.2f} ms; bf16 vs fp32 |dp| max "
          f"{mednext_tile['fp32_max']:.3e}, mean {mednext_tile['fp32_mean']:.3e}; depthwise "
          f"convs of a profiled step: forward {dw['forward_ms']:.1f} ms, backward "
          f"{dw['backward_ms']:.1f} ms of {dw['step_device_ms']:.1f} ms of device time; A/B/C "
          f"launches 0; on {smi}")
    cr = cascade["runs"]
    print("summary, cascade (phase 13): " + "; ".join(
        f"{label} patch {r['patch']}, {r['input_channels']} input channels, seconds per step "
        f"{r['steps_s']:.3f}, peak {r['peak_gib']:.2f} GiB, validation {r['validation_s']:.2f} s, "
        f"A/B/C a step {r['per_step']}" for label, r in cr.items())
          + f"; next stage {cr['13a']['next_stage_s']:.2f} s for "
          f"{cr['13a']['next_stage']['cases']} cases; 13c predict "
          f"{cascade['seconds']['predict lowres']:.2f} s; 13d tile kernels vs plain |dp| max "
          f"{cascade['tile']['bf16_max']:.3e}, mean {cascade['tile']['bf16_mean']:.3e}; host "
          f"seconds {', '.join(f'{k} {v:.2f}' for k, v in cascade['seconds'].items())}; on {smi}")
    print(f"summary, fp32 and the variants (phase 14): fp32 forms "
          + "; ".join(f"{k} {v['ms']:.3f} ms (cuDNN fp32 {v['cudnn_fp32_ms']:.3f}, bound "
                      f"{v['bound_ms']:.3f})" for k, v in fp32_kernels.items()
                      if k not in ("ab_shapes", "wgrad_shapes"))
          + f"; nnUNetTrainerV2_fp32 seconds per step {fp32_train['seconds_per_step']:.3f}, "
          f"peak {fp32_train['peak_gib']:.2f} GiB; 2D seconds per step "
          + ", ".join(f"{k} {two_d[k]['step_s']:.3f} (peak {two_d[k]['peak_gib']:.2f} GiB)"
                      for k in ("TrainerV2", "TrainerV2ResencUNet"))
          + "; variants seconds per step " + ", ".join(
              f"{k.removeprefix('nnUNetTrainerV2_')} {v['step_s']:.3f}"
              for k, v in variants.items()) + f"; on {smi}")
    print("summary, fp32 fused route (phase 14, D/E/F): "
          + "; ".join(f"{k} {v['ms']:.3f} ms (plain {v['plain_ms']:.3f}, bound "
                      f"{v['bound_ms']:.3f}"
                      + (f", library {v['library_ms']:.3f}" if v["library_ms"] is not None
                         else "")
                      + (f", unfused route {v['unfused_route_ms']:.3f}"
                         if "unfused_route_ms" in v else "") + ")"
                      for k, v in fp32_fused_kernels.items())
          + f"; fused fp32 seconds per step {fp32_fused['seconds_per_step']:.3f} (unfused "
          f"{fp32_train['seconds_per_step']:.3f}), peak {fp32_fused['peak_gib']:.2f} GiB, "
          f"labels {fp32_fused['agree']:.6f} equal, one batch's loss {fp32_fused['loss_rel']:.2e} "
          f"relative; on {smi}")
    print(f"summary, install and sources (phase 16): {install['same_niftis']} NIfTIs "
          f"byte-identical from the installed zip; seconds "
          + ", ".join(f"{k} {v:.2f}" for k, v in {**install["seconds"],
                                                   **sources["seconds"]}.items())
          + f"; converted {sources['converted']}; on {smi}")
    loss_rel = [r["loss_rel"] for r in zoo.values() if "loss_rel" in r]
    update_rel = [r["update_rel"] for r in zoo.values() if "update_rel" in r]
    print(f"summary, the trainer zoo (phase 15): {len(zoo)} trainers, {ZOO_STEPS} steps each, "
          f"seconds of the step without a CPU check " + ", ".join(
              f"{k.removeprefix('nnUNetTrainerV2_')} {v['unchecked_step_s']:.3f}"
              for k, v in zoo.items())
          + f"; loss vs CPU fp32 max {max(loss_rel):.2e} (bound {ZOO_LOSS_RTOL}); step-2 update "
          f"vs CPU fp32 max {max(update_rel):.2e} of max |update| (bound {ZOO_UPDATE_RTOL}); "
          f"A/B/C over 15a-c {rows[0]['launches_zoo']}/{rows[1]['launches_zoo']}/"
          f"{rows[2]['launches_zoo']}; 15d momentum {zoo_schedules['momentum']}; on {smi}")
    print(json.dumps({"kernels": rows}))
    # after the kernels line, whose length pushes earlier lines out of a
    # short tail of the output
    print(f"phase seconds ({time.perf_counter() - started:.1f} s in all, on {smi}): "
          + json.dumps(seconds))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
