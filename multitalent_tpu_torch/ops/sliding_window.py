"""Sliding-window tiled inference on the GPU.

Counterpart of multitalent_tpu/ops/sliding_window.py:SlidingWindowPredictor,
in both of its modes (`exact`, read from MTTPU_SW_EXACT when not given, as
:622-628; unset or "0" is the default, non-exact mode):

- default (non-exact), the JAX package's production mode and the result its
  predict and validation give unless asked otherwise: the padded volume goes
  to the device as fp16 (:717-718); the gaussian's tail is clamped to 1e-4
  (:124-131), which the fp16 accumulators can hold; `tta_chunk` mirror
  combinations are flipped and batched into one forward (:276-293, the tail
  chunk at its natural size); logits become probabilities in fp32, rounded
  to bf16 (:180-195), unflipped and summed over the tile's combinations in
  fp32; one fp32 read-modify-write a tile adds total * gaussian / n_combos
  into fp16 accumulators and the gaussian into an fp16 weight sum
  (:295-330); the blend divides in fp32, zero weights guarded, and rounds
  to fp16 (:463-470).
- exact: fp32 probabilities, fp32 accumulators and the raw (unclamped)
  gaussian; every mirror combination runs its own forward. The reference's
  aggregated_results / aggregated_nb_of_predictions (neural_network.py:
  287-428) in fp32.

Either way the result is accumulator / weight sum, and the whole padded
volume and both accumulators stay on the device, the result too. Mirror TTA
flips activations (the JAX package's weight-flip trick is a TPU economy,
packed_unet.py:152-190, not ported).

`forwards` counts tile x combination evaluations (8 a tile with full mirror
TTA, in either mode); `net_calls` counts network calls (a chunk of
combinations each); `puts` counts volumes put on the device (`begin_put`, so
a caller can put a case once and predict it with every fold).

The numpy helpers below are copied from the JAX package's module, which
imports jax and so cannot be imported here.
"""
from __future__ import annotations

import os
from itertools import combinations

import numpy as np
import torch
from scipy.ndimage import gaussian_filter


def compute_steps_for_sliding_window(patch_size, image_size, step_size: float) -> list[list[int]]:
    """Per-axis start coordinates (neural_network.py:261-285): first step at 0, last
    step flush with the image end, actual spacing <= step_size * patch (evenly
    distributed)."""
    assert all(i >= j for i, j in zip(image_size, patch_size)), \
        "image must be at least as large as the patch"
    assert 0 < step_size <= 1
    target_step_sizes_in_voxels = [i * step_size for i in patch_size]
    num_steps = [int(np.ceil((i - k) / j)) + 1
                 for i, j, k in zip(image_size, target_step_sizes_in_voxels, patch_size)]
    steps = []
    for dim in range(len(patch_size)):
        max_step_value = image_size[dim] - patch_size[dim]
        if num_steps[dim] > 1:
            actual_step_size = max_step_value / (num_steps[dim] - 1)
        else:
            actual_step_size = 1e8  # only one step at 0
        steps.append([int(np.round(actual_step_size * i)) for i in range(num_steps[dim])])
    return steps


def get_gaussian_importance_map(patch_size, sigma_scale: float = 1.0 / 8) -> np.ndarray:
    """Gaussian tile-weighting map, max-normalized, zeros clamped to the smallest
    nonzero value (neural_network.py:245-259)."""
    tmp = np.zeros(patch_size)
    center_coords = [i // 2 for i in patch_size]
    sigmas = [i * sigma_scale for i in patch_size]
    tmp[tuple(center_coords)] = 1
    g = gaussian_filter(tmp, sigmas, 0, mode="constant", cval=0)
    g = g / np.max(g)
    g = g.astype(np.float32)
    g[g == 0] = np.min(g[g != 0])
    return g


def pad_to_patch(volume_zyxc: np.ndarray, patch_size) -> tuple[np.ndarray, list[slice]]:
    """Symmetric zero-pad so every axis >= patch (pad_nd_image semantics as used by
    the tiled path); returns (padded, slicer to undo)."""
    shape = volume_zyxc.shape[:-1]
    new_shape = [max(s, p) for s, p in zip(shape, patch_size)]
    diff = [n - s for n, s in zip(new_shape, shape)]
    lo = [d // 2 for d in diff]
    hi = [d - l for d, l in zip(diff, lo)]
    pad = [(l, h) for l, h in zip(lo, hi)] + [(0, 0)]
    padded = np.pad(volume_zyxc, pad, mode="constant")
    slicer = [slice(l, l + s) for l, s in zip(lo, shape)]
    return padded, slicer


def mirror_combinations(mirror_axes: tuple[int, ...]) -> list[tuple[int, ...]]:
    """All subsets of the mirrorable spatial axes (2^m combos incl. identity)."""
    combos: list[tuple[int, ...]] = []
    for r in range(len(mirror_axes) + 1):
        combos.extend(combinations(mirror_axes, r))
    return combos




def _flip(t: torch.Tensor, combo, first: int) -> torch.Tensor:
    """t flipped along the spatial axes in `combo` (0 = z), spatial axes
    starting at dim `first`."""
    return torch.flip(t, [a + first for a in combo]) if combo else t


class SlidingWindowPredictor:
    """Tiled predictor for one network configuration.

    `net(batch)` maps (N, C, *patch) to full-resolution logits (N, K, *patch);
    a GenericUNet qualifies."""

    def __init__(self, patch_size, in_channels: int, num_classes: int,
                 nonlin: str = "softmax", step_size: float = 0.5,
                 do_mirroring: bool = True, mirror_axes: tuple[int, ...] = (0, 1, 2),
                 use_gaussian: bool = True, device: str | torch.device = "cuda",
                 tta_chunk: int = 4, exact: bool | None = None):
        if nonlin not in ("softmax", "sigmoid"):
            raise ValueError(f"nonlin must be softmax or sigmoid, got {nonlin!r}")
        if exact is None:
            exact = os.environ.get("MTTPU_SW_EXACT", "0") == "1"
        self.exact = bool(exact)
        self.patch_size = tuple(int(p) for p in patch_size)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.nonlin = nonlin
        self.step_size = step_size
        self.mirror_axes = tuple(mirror_axes) if do_mirroring else ()
        self.device = torch.device(device)
        self.tta_chunk = int(tta_chunk)
        self.use_gaussian = use_gaussian
        if use_gaussian:
            g = get_gaussian_importance_map(self.patch_size)
            if not self.exact:
                # the raw tail (~1e-11 in a large patch's corners) underflows
                # the fp16 accumulators; relative to the centre's 1.0 both
                # are 0 for blending (sliding_window.py:124-131)
                g = np.maximum(g, 1e-4)
        else:
            g = np.ones(self.patch_size, np.float32)
        self.gaussian = torch.from_numpy(g).to(self.device)
        self.forwards = 0
        self.net_calls = 0
        self.puts = 0

    def tile_coords(self, image_shape) -> np.ndarray:
        steps = compute_steps_for_sliding_window(self.patch_size, image_shape,
                                                 self.step_size)
        return np.array([(z, y, x) for z in steps[0] for y in steps[1]
                         for x in steps[2]], dtype=np.int64)

    def clamp_share(self, image_shape) -> np.ndarray:
        """(Z, Y, X) fp32 over a padded volume of image_shape: the share of a
        voxel's blend weight that the default mode's clamp adds,
        sum_t (max(g_t, 1e-4) - g_t) / sum_t max(g_t, 1e-4) over the tiles
        t covering it (raw gaussian g_t). Near 0 the clamp leaves the blend
        as the exact mode's; towards 1 (where every covering tile's raw
        weight is below 1e-4, as at the faces of a volume little larger than
        the patch) equal tail weights decide it. 0 in exact mode."""
        shape = tuple(int(s) for s in image_shape)
        if self.exact or not self.use_gaussian:
            return np.zeros(shape, np.float32)
        raw = get_gaussian_importance_map(self.patch_size)
        added = np.maximum(raw, 1e-4) - raw
        total, extra = np.zeros(shape, np.float32), np.zeros(shape, np.float32)
        pz, py, px = self.patch_size
        for z, y, x in self.tile_coords(shape).tolist():
            total[z:z + pz, y:y + py, x:x + px] += raw + added
            extra[z:z + pz, y:y + py, x:x + px] += added
        return extra / total

    def begin_put(self, volume_czyx: np.ndarray) -> tuple[torch.Tensor, list[slice]]:
        """Pad a (C, Z, Y, X) volume to at least the patch and start its copy
        to the device as (1, C, Z', Y', X'), fp32 in exact mode and fp16
        otherwise (half the bytes; the network rounds its input to its own
        dtype either way). On a CUDA device the copy leaves pinned host
        memory without blocking, so a caller can issue the next case's put
        while this case computes. Returns the token `predict(preput=)`
        takes: the device volume and the slicer that crops a result back."""
        vol = np.moveaxis(np.ascontiguousarray(volume_czyx, np.float32), 0, -1)
        padded, slicer = pad_to_patch(vol, self.patch_size)
        host = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, -1, 0)))[None]
        if not self.exact:
            host = host.half()
        if self.device.type == "cuda":
            vol_dev = host.pin_memory().to(self.device, non_blocking=True)
        else:
            vol_dev = host.to(self.device)
        self.puts += 1
        return vol_dev, slicer

    def _probabilities(self, logits: torch.Tensor) -> torch.Tensor:
        if self.nonlin == "sigmoid":
            return torch.sigmoid(logits.float())
        return torch.softmax(logits.float(), dim=1)

    @torch.no_grad()
    def predict(self, net, volume_czyx: np.ndarray | None = None,
                preput: tuple[torch.Tensor, list[slice]] | None = None) -> torch.Tensor:
        """(C, Z, Y, X) host volume, or a `begin_put` token of one ->
        probabilities (K, Z, Y, X) on the device: fp32 in exact mode, fp16
        otherwise."""
        vol, slicer = self.begin_put(volume_czyx) if preput is None else preput
        probs = self.predict_padded(net, vol)
        return probs[(slice(None),) + tuple(slicer)]

    @torch.no_grad()
    def predict_padded(self, net, vol: torch.Tensor) -> torch.Tensor:
        """(1, C, Z, Y, X) device volume, at least one patch on every axis ->
        probabilities (K, Z, Y, X) on the device."""
        if self.exact:
            return self._predict_exact(net, vol)
        chunk = min(self.tta_chunk, self._chunk_fitting_memory(vol.shape[2:]))
        while True:
            try:
                probs = self._predict_default(net, vol, chunk)
                self.tta_chunk = chunk  # a later volume does not retry a size that failed
                return probs
            except torch.cuda.OutOfMemoryError:
                # only device memory exhaustion halves the batch
                # (sliding_window.py:774-793); any other error propagates
                if chunk <= 1:
                    raise
                chunk //= 2
                print(f"# sliding window: retrying with tta_chunk={chunk}", flush=True)

    def _chunk_fitting_memory(self, padded_shape) -> int:
        """Largest TTA chunk (at most 8, halving from tta_chunk) whose working
        set and accumulators fit 80% of the card's memory: the JAX package's
        estimate (sliding_window.py:660-682) on torch.cuda.mem_get_info's
        total; the back-off in predict_padded stays the safety net."""
        chunk = max(1, min(self.tta_chunk, 8))
        if self.device.type != "cuda":
            return chunk
        budget = 0.8 * torch.cuda.mem_get_info(self.device)[1]
        vol_vox = float(np.prod(padded_shape))
        patch_vox = float(np.prod(self.patch_size))
        fixed = vol_vox * (self.num_classes * 2 + 2 + self.in_channels * 4)
        while chunk > 1:
            # one fp32 logits buffer, bf16 probabilities (flipped and
            # unflipped), ~6 live bf16 feature maps at encoder width
            work = chunk * patch_vox * (self.num_classes * 4 + self.num_classes * 2 * 2 + 360)
            if fixed + work <= budget:
                break
            chunk //= 2
        return chunk

    def _predict_default(self, net, vol: torch.Tensor, chunk: int) -> torch.Tensor:
        shape = tuple(int(s) for s in vol.shape[2:])
        acc = torch.zeros((self.num_classes, *shape), dtype=torch.float16, device=self.device)
        weight_sum = torch.zeros(shape, dtype=torch.float16, device=self.device)
        combos = mirror_combinations(self.mirror_axes)
        chunks = [combos[i:i + chunk] for i in range(0, len(combos), chunk)]
        g_div = self.gaussian / len(combos)
        pz, py, px = self.patch_size
        for z, y, x in self.tile_coords(shape).tolist():
            tile = vol[:, :, z:z + pz, y:y + py, x:x + px]
            total = None
            for part in chunks:
                batch = torch.cat([_flip(tile, c, 2) for c in part])
                probs = self._probabilities(net(batch)).to(torch.bfloat16)
                self.net_calls += 1
                self.forwards += len(part)
                # unflip, then sum the chunk in fp32, then the chunks in order
                # (sliding_window.py:289-307)
                part_total = None
                for j, c in enumerate(part):
                    u = _flip(probs[j], c, 1).float()
                    part_total = u if part_total is None else part_total + u
                total = part_total if total is None else total + part_total
            a = acc[:, z:z + pz, y:y + py, x:x + px]
            a.copy_(a.float() + total * g_div)
            w = weight_sum[z:z + pz, y:y + py, x:x + px]
            w.copy_(w.float() + self.gaussian)
        cnt = weight_sum.float()
        return (acc.float() / torch.where(cnt == 0, 1.0, cnt)).half()

    def _predict_exact(self, net, vol: torch.Tensor) -> torch.Tensor:
        shape = tuple(int(s) for s in vol.shape[2:])
        acc = torch.zeros((self.num_classes, *shape), dtype=torch.float32,
                          device=self.device)
        weight_sum = torch.zeros(shape, dtype=torch.float32, device=self.device)
        combos = mirror_combinations(self.mirror_axes)
        g_div = self.gaussian / len(combos)
        pz, py, px = self.patch_size
        for z, y, x in self.tile_coords(shape).tolist():
            tile = vol[:, :, z:z + pz, y:y + py, x:x + px]
            total = None
            for combo in combos:
                dims = [a + 2 for a in combo]
                logits = net(torch.flip(tile, dims) if dims else tile)
                self.forwards += 1
                self.net_calls += 1
                probs = self._probabilities(torch.flip(logits, dims) if dims else logits)
                total = probs if total is None else total.add_(probs)
            acc[:, z:z + pz, y:y + py, x:x + px].addcmul_(total[0], g_div)
            weight_sum[z:z + pz, y:y + py, x:x + px] += self.gaussian
        return acc / torch.where(weight_sum == 0, 1.0, weight_sum)


def refuse_2d_prediction(what: str):
    """Raise NotImplementedError for predicting with a 2D model, which
    neither package does: the JAX package's sliding window pads and tiles
    three axes (multitalent_tpu/ops/sliding_window.py:78 pad_to_patch, :716
    begin_put): its train CLI trains a 2D plan and then fails in the
    validation with a ValueError, as its predict CLI fails on a 2D model
    folder."""
    raise NotImplementedError(
        f"{what}: 2D models are not predicted: neither this port nor the JAX package it is "
        "held to predicts one (the JAX sliding window pads and tiles three axes, "
        "multitalent_tpu/ops/sliding_window.py:78,716); the 2D model trains and its "
        "checkpoints are written")
