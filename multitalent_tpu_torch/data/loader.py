"""Patch sampler / host-side data loader.

Parity target: DataLoader3D/2D (dataset_loading.py:155-594): random case choice with
optional per-case sampling probabilities, foreground-forced patches (oversample
fraction of the batch) centered on precomputed class_locations, crop-then-pad with
edge-padded data and -1 constant-padded segmentation.

TPU-native role: this runs on HOST threads and produces raw (possibly enlarged, for
rotation headroom) patches; all augmentation happens on DEVICE afterwards
(augment/pipeline.py), replacing the reference's 12-32 batchgenerators worker
processes. A small thread pool + prefetch queue keeps the accelerator fed.

The port's copy of multitalent_tpu/data/loader.py.
"""
from __future__ import annotations

import queue
import threading

import numpy as np

from multitalent_tpu_torch.data.dataset import load_case
from multitalent_tpu_torch.utils import load_pickle


class PatchSampler3D:
    """Yields dict batches: data (B, C, *patch) float32, seg (B, 1, *patch) float32,
    properties (list), keys (list)."""

    def __init__(self, data: dict, patch_size, final_patch_size, batch_size,
                 has_prev_stage=False, oversample_foreground_percent=0.0,
                 memmap_mode="r", pad_mode="edge", pad_sides=None,
                 sampling_probabilities=None, seed=None):
        self._data = data
        self.patch_size = np.array(patch_size, dtype=int)
        self.final_patch_size = np.array(final_patch_size, dtype=int)
        self.batch_size = batch_size
        self.has_prev_stage = has_prev_stage
        self.oversample_foreground_percent = oversample_foreground_percent
        self.memmap_mode = memmap_mode
        self.pad_mode = pad_mode
        self.list_of_keys = list(data.keys())
        self.need_to_pad = (self.patch_size - self.final_patch_size).astype(int)
        if pad_sides is not None:
            self.need_to_pad += np.array(pad_sides, dtype=int)
        self.sampling_probabilities = sampling_probabilities
        self.rng = np.random.RandomState(seed)
        first = load_case(data[self.list_of_keys[0]], memmap_mode)
        self.num_channels = first.shape[0] - 1
        self.num_seg = 2 if has_prev_stage else 1

    def _force_fg(self, batch_idx: int) -> bool:
        # last ceil(oversample% * B) samples of each batch are foreground-forced
        return batch_idx >= round(self.batch_size * (1 - self.oversample_foreground_percent))

    def _properties(self, key: str) -> dict:
        entry = self._data[key]
        if "properties" in entry:
            return entry["properties"]
        return load_pickle(entry["properties_file"])

    def _choose_bbox(self, shape: np.ndarray, properties: dict,
                     force_fg: bool) -> np.ndarray:
        """Lower-bound corner of the sampled patch (may be negative / exceed the
        case: the overhang is padded)."""
        dim = len(shape)
        need_to_pad = self.need_to_pad.copy()
        for d in range(dim):
            if need_to_pad[d] + shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - shape[d]
        lb = -(need_to_pad // 2)
        ub = shape + need_to_pad // 2 + need_to_pad % 2 - self.patch_size

        if force_fg and "class_locations" in properties:
            fg_classes = np.array([c for c, locs in properties["class_locations"].items()
                                   if len(locs) != 0])
            fg_classes = fg_classes[fg_classes > 0]
            if len(fg_classes) > 0:
                selected_class = self.rng.choice(fg_classes)
                voxels = properties["class_locations"][selected_class]
                center = voxels[self.rng.choice(len(voxels))]
                return np.maximum(lb, np.array(center) - self.patch_size // 2)
        return np.array([self.rng.randint(lb[d], ub[d] + 1) for d in range(dim)])

    def _crop_pad(self, arr: np.ndarray, bbox_lb: np.ndarray, pad_mode: str,
                  cval: float):
        """Crop channel-first `arr` to [bbox_lb, bbox_lb+patch) with padding."""
        shape = np.array(arr.shape[1:])
        bbox_ub = bbox_lb + self.patch_size
        valid_lb = np.maximum(0, bbox_lb)
        valid_ub = np.minimum(shape, bbox_ub)
        sl = (slice(None),) + tuple(slice(a, b) for a, b in zip(valid_lb, valid_ub))
        crop = np.array(arr[sl])
        pad_lo = -np.minimum(0, bbox_lb)
        pad_hi = np.maximum(bbox_ub - shape, 0)
        pad = [(0, 0)] + [(int(a), int(b)) for a, b in zip(pad_lo, pad_hi)]
        if pad_mode == "constant":
            return np.pad(crop, pad, mode="constant", constant_values=cval)
        return np.pad(crop, pad, mode=pad_mode)

    def _sample_patch(self, key: str, force_fg: bool):
        properties = self._properties(key)
        case_all_data = load_case(self._data[key], self.memmap_mode)
        bbox_lb = self._choose_bbox(np.array(case_all_data.shape[1:]), properties,
                                    force_fg)
        data = self._crop_pad(case_all_data[:-1], bbox_lb, self.pad_mode, 0)
        seg = self._crop_pad(case_all_data[-1:], bbox_lb, "constant", -1)
        return data, seg, properties

    def generate_train_batch(self) -> dict:
        selected_keys = self.rng.choice(self.list_of_keys, self.batch_size, True,
                                        self.sampling_probabilities)
        data = np.zeros((self.batch_size, self.num_channels, *self.patch_size), np.float32)
        seg = np.zeros((self.batch_size, self.num_seg, *self.patch_size), np.float32)
        case_properties = []
        for j, key in enumerate(selected_keys):
            d, s, props = self._sample_patch(key, self._force_fg(j))
            data[j] = d
            seg[j, : s.shape[0]] = s
            case_properties.append(props)
        return {"data": data, "seg": seg, "properties": case_properties,
                "keys": list(selected_keys)}

    def __iter__(self):
        return self

    def __next__(self):
        return self.generate_train_batch()


class PatchSampler2D(PatchSampler3D):
    """2D variant: samples a random slice then a 2D patch (DataLoader2D parity,
    dataset_loading.py:383-594)."""

    def _sample_patch(self, key: str, force_fg: bool):
        properties = self._properties(key)
        case_all_data = load_case(self._data[key], self.memmap_mode)
        if case_all_data.ndim == 4:
            if force_fg and "class_locations" in properties:
                fg_classes = np.array([c for c, locs in properties["class_locations"].items()
                                       if len(locs) != 0])
                fg_classes = fg_classes[fg_classes > 0]
            else:
                fg_classes = np.array([])
            if force_fg and len(fg_classes) > 0:
                selected_class = self.rng.choice(fg_classes)
                voxels = properties["class_locations"][selected_class]
                slice_ids = np.unique(np.asarray(voxels)[:, 0])
                sl_id = int(self.rng.choice(slice_ids))
            else:
                sl_id = int(self.rng.randint(case_all_data.shape[1]))
            case_all_data = case_all_data[:, sl_id]
            properties = dict(properties)
            if "class_locations" in properties:
                properties["class_locations"] = {
                    c: np.asarray(v)[np.asarray(v)[:, 0] == sl_id][:, 1:] if len(v) else v
                    for c, v in properties["class_locations"].items()
                }
        return self._sample_from_array(case_all_data, properties, force_fg)

    def _sample_from_array(self, case_all_data, properties, force_fg):
        shape = np.array(case_all_data.shape[1:])
        dim = len(shape)
        need_to_pad = self.need_to_pad.copy()
        for d in range(dim):
            if need_to_pad[d] + shape[d] < self.patch_size[d]:
                need_to_pad[d] = self.patch_size[d] - shape[d]
        lb = -(need_to_pad // 2)
        ub = shape + need_to_pad // 2 + need_to_pad % 2 - self.patch_size
        if force_fg and "class_locations" in properties:
            fg_classes = np.array([c for c, locs in properties["class_locations"].items()
                                   if len(locs) != 0])
            fg_classes = fg_classes[fg_classes > 0]
            if len(fg_classes) > 0:
                selected_class = self.rng.choice(fg_classes)
                voxels = properties["class_locations"][selected_class]
                center = voxels[self.rng.choice(len(voxels))]
                bbox_lb = np.maximum(lb, np.array(center) - self.patch_size // 2)
            else:
                bbox_lb = np.array([self.rng.randint(lb[d], ub[d] + 1) for d in range(dim)])
        else:
            bbox_lb = np.array([self.rng.randint(lb[d], ub[d] + 1) for d in range(dim)])
        bbox_ub = bbox_lb + self.patch_size
        valid_lb = np.maximum(0, bbox_lb)
        valid_ub = np.minimum(shape, bbox_ub)
        sl = (slice(None),) + tuple(slice(a, b) for a, b in zip(valid_lb, valid_ub))
        case_crop = np.array(case_all_data[sl])
        pad_lo = -np.minimum(0, bbox_lb)
        pad_hi = np.maximum(bbox_ub - shape, 0)
        pad = [(0, 0)] + [(int(a), int(b)) for a, b in zip(pad_lo, pad_hi)]
        data = np.pad(case_crop[:-1], pad, mode=self.pad_mode)
        seg = np.pad(case_crop[-1:], pad, mode="constant", constant_values=-1)
        return data, seg, properties


class PrefetchPipeline:
    """Background-thread prefetcher: N worker threads each drawing batches from a
    sampler (with distinct seeds) into a bounded queue. Replaces the reference's
    MultiThreadedAugmenter processes; here workers only do numpy patch gathering, the
    heavy augmentation runs on device."""

    def __init__(self, sampler_factory, num_workers: int = 3, queue_depth: int = 4,
                 transform=None):
        self.queue: queue.Queue = queue.Queue(maxsize=queue_depth)
        self.transform = transform
        self.stop_event = threading.Event()
        self._worker_error: BaseException | None = None
        self.workers = []
        for w in range(num_workers):
            sampler = sampler_factory(w)
            t = threading.Thread(target=self._worker, args=(sampler,), daemon=True)
            t.start()
            self.workers.append(t)

    def _worker(self, sampler):
        try:
            while not self.stop_event.is_set():
                batch = sampler.generate_train_batch()
                if self.transform is not None:
                    batch = self.transform(batch)
                while not self.stop_event.is_set():
                    try:
                        self.queue.put(batch, timeout=0.5)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # propagate to the consumer (a crashed
            # sampler — corrupt npz, bad pkl — must fail training loudly, not
            # leave __next__ polling an empty queue forever)
            self._worker_error = e
            self.stop_event.set()

    def __next__(self):
        while True:
            try:
                return self.queue.get(timeout=5.0)
            except queue.Empty:
                if self._worker_error is not None:
                    raise RuntimeError(
                        "PrefetchPipeline worker died") from self._worker_error
                if self.stop_event.is_set():
                    raise StopIteration
                continue

    def __iter__(self):
        return self

    def stop(self):
        self.stop_event.set()
