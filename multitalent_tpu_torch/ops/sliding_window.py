"""Sliding-window tiled inference on the GPU.

Counterpart of multitalent_tpu/ops/sliding_window.py:SlidingWindowPredictor
with the semantics of its `exact=True` mode (:622-628): fp32 probabilities,
fp32 accumulators and the raw (unclamped) gaussian weights. Per tile, every
mirror combination runs a forward on the flipped tile; its sigmoid or softmax
probabilities are flipped back and summed, weighted by gaussian / n_combos,
into the accumulator, while the gaussian alone goes into the weight sum. The
result is accumulator / weight sum, as the reference's aggregated_results /
aggregated_nb_of_predictions (neural_network.py:287-428).

The whole padded volume and both accumulators stay on the device; the result
is returned there too. Mirror TTA flips activations (the JAX package's
weight-flip trick is a TPU economy, packed_unet.py:152-190, for a later PR).

The numpy helpers below are copied from the JAX package's module, which
imports jax and so cannot be imported here.
"""
from __future__ import annotations

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


class SlidingWindowPredictor:
    """Tiled predictor for one network configuration.

    `net(batch)` maps (1, C, *patch) to full-resolution logits (1, K, *patch);
    a GenericUNet qualifies. `forwards` counts the network calls made."""

    def __init__(self, patch_size, in_channels: int, num_classes: int,
                 nonlin: str = "softmax", step_size: float = 0.5,
                 do_mirroring: bool = True, mirror_axes: tuple[int, ...] = (0, 1, 2),
                 use_gaussian: bool = True, device: str | torch.device = "cuda"):
        if nonlin not in ("softmax", "sigmoid"):
            raise ValueError(f"nonlin must be softmax or sigmoid, got {nonlin!r}")
        self.patch_size = tuple(int(p) for p in patch_size)
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.nonlin = nonlin
        self.step_size = step_size
        self.mirror_axes = tuple(mirror_axes) if do_mirroring else ()
        self.device = torch.device(device)
        g = (get_gaussian_importance_map(self.patch_size) if use_gaussian
             else np.ones(self.patch_size, np.float32))
        self.gaussian = torch.from_numpy(g).to(self.device)
        self.forwards = 0

    def tile_coords(self, image_shape) -> np.ndarray:
        steps = compute_steps_for_sliding_window(self.patch_size, image_shape,
                                                 self.step_size)
        return np.array([(z, y, x) for z in steps[0] for y in steps[1]
                         for x in steps[2]], dtype=np.int64)

    def put(self, volume_czyx: np.ndarray) -> tuple[torch.Tensor, list[slice]]:
        """Pad a (C, Z, Y, X) volume to at least the patch and move it to the
        device as (1, C, Z', Y', X') fp32; returns it with the slicer that
        crops a result back to the volume."""
        vol = np.moveaxis(np.ascontiguousarray(volume_czyx, np.float32), 0, -1)
        padded, slicer = pad_to_patch(vol, self.patch_size)
        t = torch.from_numpy(np.ascontiguousarray(np.moveaxis(padded, -1, 0)))
        return t[None].to(self.device), slicer

    def _probabilities(self, logits: torch.Tensor) -> torch.Tensor:
        if self.nonlin == "sigmoid":
            return torch.sigmoid(logits.float())
        return torch.softmax(logits.float(), dim=1)

    @torch.no_grad()
    def predict(self, net, volume_czyx: np.ndarray) -> torch.Tensor:
        """(C, Z, Y, X) host volume -> probabilities (K, Z, Y, X) fp32 on the
        device."""
        vol, slicer = self.put(volume_czyx)
        probs = self.predict_padded(net, vol)
        return probs[(slice(None),) + tuple(slicer)]

    @torch.no_grad()
    def predict_padded(self, net, vol: torch.Tensor) -> torch.Tensor:
        """(1, C, Z, Y, X) device volume, at least one patch on every axis ->
        probabilities (K, Z, Y, X) fp32 on the device."""
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
                probs = self._probabilities(torch.flip(logits, dims) if dims else logits)
                total = probs if total is None else total.add_(probs)
            acc[:, z:z + pz, y:y + py, x:x + px].addcmul_(total[0], g_div)
            weight_sum[z:z + pz, y:y + py, x:x + px] += self.gaussian
        return acc / torch.where(weight_sum == 0, 1.0, weight_sum)
