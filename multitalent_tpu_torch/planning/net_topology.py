"""Network-topology search used by the experiment planners.

Given a voxel spacing and a candidate patch size, decide per-stage pooling strides and
conv kernel sizes so that (a) axes are only pooled while they are within 2x of the
finest current spacing (pool coarse axes later), (b) feature maps never shrink below a
minimum edge length, and (c) anisotropic axes get 1-kernels until their spacing catches
up. Behavioral parity: nnunet/experiment_planning/common_utils.py:50-260.

Also hosts the architecture "memory proxy" used by the planners' patch-size fit loop
(parity: generic_UNet.py:403-442 compute_approx_vram_consumption and the class statics
at generic_UNet.py:157-171). On TPU the proxy plays the same role (a monotone surrogate
for activation memory) with HBM as the budget.

The port's copy of multitalent_tpu/planning/net_topology.py. The proxies stay the
reference's on the GPU too, so that the port's plans equal the JAX package's.
"""
from __future__ import annotations

import numpy as np

# Architecture reference constants (generic_UNet.py:157-171). The *_budget_3d value is
# the reference activation-memory proxy for a (64,192,160) patch at 30 features, batch 2.
DEFAULT_BATCH_SIZE_3D = 2
DEFAULT_BATCH_SIZE_2D = 50
BASE_NUM_FEATURES = 30
MAX_NUM_FILTERS_3D = 320
MAX_FILTERS_2D = 480
MEMORY_BUDGET_3D = 520000000
MEMORY_BUDGET_2D = 19739648


def get_shape_must_be_divisible_by(num_pool_per_axis) -> np.ndarray:
    return 2 ** np.array(num_pool_per_axis)


def pad_shape(shape, must_be_divisible_by) -> np.ndarray:
    """Round `shape` up to the next multiple of `must_be_divisible_by` per axis
    (no-op on axes already divisible)."""
    shape = np.asarray(shape)
    m = np.asarray(must_be_divisible_by)
    if m.ndim == 0:
        m = np.full(len(shape), int(m))
    return (((shape + m - 1) // m) * m).astype(int)


def get_network_numpool(patch_size, maxpool_cap=999, min_feature_map_size=4) -> list[int]:
    per_axis = np.floor(np.log2(np.asarray(patch_size) / min_feature_map_size)).astype(int)
    return [int(min(i, maxpool_cap)) for i in per_axis]


def get_pool_and_conv_props(spacing, patch_size, min_feature_map_size, max_numpool):
    """Spacing-aware pooling schedule (v21 planners; common_utils.py:89-154).

    Returns (num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, padded_patch,
    must_be_divisible_by). conv_kernel_sizes has one extra entry (bottleneck, all-3s).
    """
    dim = len(spacing)
    current_spacing = [float(s) for s in spacing]
    current_size = [float(p) for p in patch_size]
    pool_op_kernel_sizes: list[list[int]] = []
    conv_kernel_sizes: list[list[int]] = []
    num_pool_per_axis = [0] * dim

    while True:
        min_spacing = min(current_spacing)
        valid_axes = [i for i in range(dim) if current_spacing[i] / min_spacing < 2]
        # conv kernel: 3 on the largest clique of axes whose spacings are within 2x of
        # each other, 1 elsewhere (coarse axes see enough context already)
        best_partners: list[int] = []
        for a in range(dim):
            partners = [
                i for i in range(dim)
                if current_spacing[i] / current_spacing[a] < 2
                and current_spacing[a] / current_spacing[i] < 2
            ]
            if len(partners) > len(best_partners):
                best_partners = partners
        conv_kernel = [3 if i in best_partners else 1 for i in range(dim)]

        valid_axes = [i for i in valid_axes if current_size[i] >= 2 * min_feature_map_size]
        valid_axes = [i for i in valid_axes if num_pool_per_axis[i] < max_numpool]
        if len(valid_axes) == 0:
            break

        pool_kernel = [1] * dim
        for v in valid_axes:
            pool_kernel[v] = 2
            num_pool_per_axis[v] += 1
            current_spacing[v] *= 2
            current_size[v] = np.ceil(current_size[v] / 2)
        pool_op_kernel_sizes.append(pool_kernel)
        conv_kernel_sizes.append(conv_kernel)

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    padded = pad_shape(patch_size, must_be_divisible_by)
    conv_kernel_sizes.append([3] * dim)
    return num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, padded, must_be_divisible_by


def get_pool_and_conv_props_poolLateV2(patch_size, min_feature_map_size, max_numpool, spacing):
    """Pool-late schedule used by the baseline (non-v21) planner
    (common_utils.py:50-86): number of pools per axis from patch size alone; axes that
    need fewer pools skip the *early* pooling steps. Conv kernels are 1 on an axis until
    its spacing is within 2x of the coarsest original spacing."""
    dim = len(patch_size)
    reach = max(spacing)
    num_pool_per_axis = get_network_numpool(patch_size, max_numpool, min_feature_map_size)
    net_numpool = max(num_pool_per_axis)

    pool_op_kernel_sizes: list[list[int]] = []
    conv_kernel_sizes: list[list[int]] = []
    current_spacing = list(spacing)
    for p in range(net_numpool):
        reached = [current_spacing[i] / reach > 0.5 for i in range(dim)]
        pool = [2 if num_pool_per_axis[i] + p >= net_numpool else 1 for i in range(dim)]
        conv = [3] * dim if all(reached) else [3 if not reached[i] else 1 for i in range(dim)]
        pool_op_kernel_sizes.append(pool)
        conv_kernel_sizes.append(conv)
        current_spacing = [s * k for s, k in zip(current_spacing, pool)]
    conv_kernel_sizes.append([3] * dim)

    must_be_divisible_by = get_shape_must_be_divisible_by(num_pool_per_axis)
    padded = pad_shape(patch_size, must_be_divisible_by)
    return num_pool_per_axis, pool_op_kernel_sizes, conv_kernel_sizes, padded, must_be_divisible_by


def compute_memory_proxy(patch_size, num_pool_per_axis, base_num_features, max_num_features,
                         num_modalities, num_classes, pool_op_kernel_sizes,
                         deep_supervision=False, conv_per_stage=2) -> int:
    """Monotone surrogate for activation memory of the plain-conv U-Net, used by the
    planners' shrink-to-fit loop (parity: generic_UNet.py:403-442). Counts feature-map
    voxels per stage: (2*conv_per_stage + 1) maps at each encoder/decoder stage plus
    input/output maps."""
    num_pool_per_axis = np.asarray(num_pool_per_axis)
    npool = len(pool_op_kernel_sizes)
    # int64 with truncating division: the reference assigns float quotients into an int
    # array element-wise, which truncates; padded patch sizes divide exactly anyway.
    map_size = np.array(patch_size, dtype=np.int64)
    vox = np.prod(map_size, dtype=np.int64)
    total = np.int64((conv_per_stage * 2 + 1) * vox * base_num_features
                     + num_modalities * vox + num_classes * vox)
    num_feat = base_num_features
    for p in range(npool):
        map_size = (map_size / np.array(pool_op_kernel_sizes[p])).astype(np.int64)
        num_feat = min(num_feat * 2, max_num_features)
        num_blocks = (conv_per_stage * 2 + 1) if p < (npool - 1) else conv_per_stage
        total += num_blocks * np.prod(map_size, dtype=np.int64) * num_feat
        if deep_supervision and p < (npool - 2):
            total += np.prod(map_size, dtype=np.int64) * num_classes
    return int(total)


RESENC_BUDGET_3D = 1230348801.0  # FabiansUNet.use_this_for_3D_configuration
RESENC_BLOCKS_ENCODER = (1, 2, 3, 4, 4, 4, 4, 4, 4, 4, 4)
RESENC_BLOCKS_DECODER = (1, 1, 1, 1, 1, 1, 1, 1, 1, 1)
RESENC_MIN_BATCH_SIZE = 2


def compute_resenc_memory_proxy(patch_size, base_num_features, max_num_features,
                                num_modalities, num_classes, pool_op_kernel_sizes,
                                blocks_encoder, blocks_decoder, feat_mul,
                                batch_size) -> float:
    """FabiansUNet memory proxy = residual-encoder + plain-decoder terms
    (generic_modular_residual_UNet.py:210-229 + generic_modular_UNet.py:294-321):
    encoder stage p costs (blocks*2+1) activations, decoder stage (blocks+1)."""
    npool = len(pool_op_kernel_sizes) - 1
    shape = np.array(patch_size, dtype=np.float64)
    enc = ((blocks_encoder[0] * 2 + 1) * np.prod(shape) * base_num_features
           + num_modalities * np.prod(shape))
    feat = base_num_features
    for p in range(1, npool + 1):
        shape = shape / np.array(pool_op_kernel_sizes[p], dtype=np.float64)
        feat = min(feat * feat_mul, max_num_features)
        enc += (blocks_encoder[p] * 2 + 1) * np.prod(shape) * feat

    shape = np.array(patch_size, dtype=np.float64)
    dec = ((blocks_decoder[-1] + 1) * np.prod(shape) * base_num_features
           + num_classes * np.prod(shape))
    feat = base_num_features
    for p in range(1, npool):
        shape = shape / np.array(pool_op_kernel_sizes[p], dtype=np.float64)
        feat = min(feat * feat_mul, max_num_features)
        dec += (blocks_decoder[-(p + 1)] + 1) * np.prod(shape) * feat
    return float((enc + dec) * batch_size)
