"""Batched spatial augmentation on the card: rotation + scaling + center crop
in one resampling per sample, mirroring, deep-supervision seg targets.

Counterpart of multitalent_tpu/augment/spatial.py (`spatial_augment` :190,
`mirror_augment` :291, `downsample_seg_for_ds` :306, and the 2D
`spatial_augment_2d` :319). Data is (B, C, Z', Y',
X') float32, seg (B, Z', Y', X') float32 labels with -1 outside the case; the
output is cropped to `final_shape`.

Per sample, as batchgenerators' augment_spatial and the JAX package: no
rotation and no scaling -> a center crop at offsets (in - final) // 2; else
one resampling of the centered output grid mapped by R @ diag(scale), R =
Rx @ Ry @ Rz. Data is sampled trilinearly with constant 0 outside
(`F.grid_sample`, align_corners=True); seg trilinearly then rounded, or for
order 0 nearest with scipy's round-half-away-from-zero, with constant -1.
The JAX package runs the rotation as a shear-warp decomposition by default
because gathers are slow on the TPU (spatial.py:138-185); on the GPU the
gather is cheap and this is its exact-geometry path (spatial.py:266-274).

2D (`spatial_augment_2d`, data (B, C, Y', X')): one in-plane angle from
rotation_x's range and one scale for both axes, and every sample resampled
(bilinear, the output grid centered on the input), also without rotation
or scaling, as the JAX function maps every sample through
map_coordinates (spatial.py:340-355).

Random draws come from an explicit `torch.Generator` on the data's device.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rotation_matrix_3d(ax: float, ay: float, az: float, device=None) -> torch.Tensor:
    """R = Rx @ Ry @ Rz on (z, y, x) coordinates, fp32 (spatial.py:23-31)."""
    t = torch.tensor([ax, ay, az], dtype=torch.float32, device=device)
    c, s = torch.cos(t), torch.sin(t)
    one, zero = torch.ones((), device=device), torch.zeros((), device=device)
    rx = torch.stack([torch.stack([one, zero, zero]), torch.stack([zero, c[0], -s[0]]),
                      torch.stack([zero, s[0], c[0]])])
    ry = torch.stack([torch.stack([c[1], zero, s[1]]), torch.stack([zero, one, zero]),
                      torch.stack([-s[1], zero, c[1]])])
    rz = torch.stack([torch.stack([c[2], -s[2], zero]), torch.stack([s[2], c[2], zero]),
                      torch.stack([zero, zero, one])])
    return rx @ ry @ rz


def _source_coords(in_shape, final_shape, angles, scale, device) -> torch.Tensor:
    """(3, Z, Y, X) input-index coordinates of each output voxel: the
    centered output grid, scaled, rotated, re-centered on the input."""
    axes = [torch.arange(s, dtype=torch.float32, device=device) - (s - 1) / 2.0
            for s in final_shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(3, -1)
    r = rotation_matrix_3d(*angles, device=device)
    sc = torch.tensor(scale, dtype=torch.float32, device=device)
    center = torch.tensor([(s - 1) / 2.0 for s in in_shape], dtype=torch.float32,
                          device=device)
    coords = r @ (grid * sc[:, None]) + center[:, None]
    return coords.reshape(3, *final_shape)


def _trilinear(vol: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """vol (C, Z', Y', X') sampled at coords (3, Z, Y, X), 0 outside; in 2D
    vol (C, Y', X') at coords (2, Y, X), bilinear."""
    in_shape = vol.shape[1:]
    norm = [coords[i] * (2.0 / (in_shape[i] - 1)) - 1.0 for i in range(len(in_shape))]
    grid = torch.stack(norm[::-1], dim=-1)[None]  # (1, Z, Y, X, (x, y, z))
    return F.grid_sample(vol[None], grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)[0]


def _nearest(vol: torch.Tensor, coords: torch.Tensor, cval: float) -> torch.Tensor:
    """vol (Z', Y', X') at the nearest voxel of coords (3, Z, Y, X) (or a 2D
    vol at coords (2, Y, X)), rounding half away from zero (scipy's order 0,
    spatial.py:58-60), cval outside."""
    idx = (torch.sign(coords) * torch.floor(coords.abs() + 0.5)).long()
    valid = torch.ones(coords.shape[1:], dtype=torch.bool, device=vol.device)
    flat = torch.zeros(coords.shape[1:], dtype=torch.long, device=vol.device)
    for i, n in enumerate(vol.shape):
        valid &= (idx[i] >= 0) & (idx[i] < n)
        flat = flat * n + idx[i].clamp(0, n - 1)
    out = vol.reshape(-1)[flat.reshape(-1)].reshape(coords.shape[1:])
    return torch.where(valid, out, torch.full_like(out, cval))


def warp_sample(d: torch.Tensor, s: torch.Tensor, final_shape, angles, scale,
                order_seg: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """One sample: d (C, Z', Y', X'), s (Z', Y', X') resampled at the output
    grid mapped by R(angles) @ diag(scale); returns (C, *final), (*final)."""
    coords = _source_coords(d.shape[1:], tuple(final_shape), angles, scale, d.device)
    d_out = _trilinear(d, coords)
    if order_seg == 0:
        s_out = _nearest(s, coords, -1.0)
    else:
        s_out = torch.round(_trilinear(s[None] + 1.0, coords)[0] - 1.0)
    return d_out, s_out


def center_crop(d: torch.Tensor, s: torch.Tensor, final_shape):
    """Crop the last len(final_shape) axes of d and s at offsets
    (in - final) // 2."""
    sl = tuple(slice((i - f) // 2, (i - f) // 2 + f)
               for i, f in zip(s.shape[-len(final_shape):], final_shape))
    return d[(..., *sl)], s[(..., *sl)]


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def spatial_augment(data: torch.Tensor, seg: torch.Tensor, final_shape, *,
                    generator: torch.Generator, scale_range=(0.7, 1.4),
                    rot_x=(-0.5236, 0.5236), rot_y=(-0.5236, 0.5236),
                    rot_z=(-0.5236, 0.5236), p_rot: float = 0.2, p_scale: float = 0.2,
                    order_seg: int = 1, dummy_2d: bool = False,
                    rot_p_per_axis: float = 1.0, independent_scale: bool = False):
    """data (B, C, Z', Y', X'), seg (B, Z', Y', X') -> (B, C, *final),
    (B, *final). Per sample: rotation with p_rot (each axis' angle kept with
    rot_p_per_axis; in-plane only for dummy_2d), scaling with p_scale (zoom
    in and out equally likely, one factor or one per axis), else a crop."""
    b = data.shape[0]
    final_shape = tuple(int(f) for f in final_shape)
    gen = generator
    do_rot = (torch.rand(b, generator=gen, device=gen.device) < p_rot).tolist()
    do_scale = (torch.rand(b, generator=gen, device=gen.device) < p_scale).tolist()
    angles = torch.stack([_uniform(gen, b, *r) for r in (rot_x, rot_y, rot_z)], 1)
    if rot_p_per_axis < 1.0:
        angles = angles * (torch.rand(b, 3, generator=gen, device=gen.device)
                           < rot_p_per_axis)
    if dummy_2d:
        angles[:, 1:] = 0.0
    n_axes = 3 if independent_scale else 1
    lo = _uniform(gen, (b, n_axes), scale_range[0], 1.0)
    hi = _uniform(gen, (b, n_axes), 1.0, scale_range[1])
    pick_lo = torch.rand(b, n_axes, generator=gen, device=gen.device) < 0.5
    scale = torch.where(pick_lo, lo, hi).expand(b, 3).tolist()
    angles = angles.tolist()

    outs = []
    for i in range(b):
        if not (do_rot[i] or do_scale[i]):
            outs.append(center_crop(data[i], seg[i], final_shape))
            continue
        ang = angles[i] if do_rot[i] else (0.0, 0.0, 0.0)
        sc = scale[i] if do_scale[i] else (1.0, 1.0, 1.0)
        outs.append(warp_sample(data[i], seg[i], final_shape, ang, sc, order_seg))
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def warp_sample_2d(d: torch.Tensor, s: torch.Tensor, final_shape, angle: float,
                   scale: float, order_seg: int = 1) -> tuple[torch.Tensor, torch.Tensor]:
    """One 2D sample: d (C, Y', X'), s (Y', X') resampled at the centered
    output grid scaled by `scale` and rotated by `angle`, re-centered on the
    input (the warp of spatial_augment_2d, spatial.py:340-355): bilinear
    with 0 outside, seg bilinear then rounded with -1 outside (or nearest
    for order 0)."""
    dev = d.device
    axes = [torch.arange(f, dtype=torch.float32, device=dev) - (f - 1) / 2.0
            for f in final_shape]
    grid = torch.stack(torch.meshgrid(*axes, indexing="ij")).reshape(2, -1)
    t = torch.tensor(float(angle), dtype=torch.float32, device=dev)
    c, sn = torch.cos(t), torch.sin(t)
    r = torch.stack([torch.stack([c, -sn]), torch.stack([sn, c])])
    center = torch.tensor([(n - 1) / 2.0 for n in d.shape[1:]], dtype=torch.float32,
                          device=dev)
    coords = (r @ (grid * float(scale)) + center[:, None]).reshape(2, *final_shape)
    d_out = _trilinear(d, coords)
    if order_seg == 0:
        s_out = _nearest(s, coords, -1.0)
    else:
        s_out = torch.round(_trilinear(s[None] + 1.0, coords)[0] - 1.0)
    return d_out, s_out


def spatial_augment_2d(data: torch.Tensor, seg: torch.Tensor, final_shape, *,
                       generator: torch.Generator, scale_range=(0.7, 1.4),
                       rot=(-3.1416, 3.1416), p_rot: float = 0.2, p_scale: float = 0.2,
                       order_seg: int = 1):
    """data (B, C, Y', X'), seg (B, Y', X') -> (B, C, *final), (B, *final):
    per sample one in-plane angle from `rot` with p_rot, one scale (zoom in
    and out equally likely) with p_scale, and the warp (warp_sample_2d)
    always, as spatial.py:319-359."""
    b = data.shape[0]
    final_shape = tuple(int(f) for f in final_shape)
    gen, dev = generator, generator.device
    do_rot = torch.rand(b, generator=gen, device=dev) < p_rot
    do_scale = torch.rand(b, generator=gen, device=dev) < p_scale
    angle = torch.where(do_rot, _uniform(gen, b, *rot), torch.zeros(b, device=dev))
    lo = _uniform(gen, b, scale_range[0], 1.0)
    hi = _uniform(gen, b, 1.0, scale_range[1])
    scale = torch.where(torch.rand(b, generator=gen, device=dev) < 0.5, lo, hi)
    scale = torch.where(do_scale, scale, torch.ones(b, device=dev))
    outs = [warp_sample_2d(data[i], seg[i], final_shape, a, sc, order_seg)
            for i, (a, sc) in enumerate(zip(angle.tolist(), scale.tolist()))]
    return torch.stack([o[0] for o in outs]), torch.stack([o[1] for o in outs])


def mirror(data: torch.Tensor, seg: torch.Tensor, flips: torch.Tensor,
           mirror_axes=(0, 1, 2)):
    """Flip sample i along spatial axis mirror_axes[k] where flips[i, k]."""
    flips = flips.tolist()
    d_out, s_out = [], []
    for i in range(data.shape[0]):
        dims = [ax for ax, f in zip(mirror_axes, flips[i]) if f]
        d_out.append(data[i].flip([ax + 1 for ax in dims]) if dims else data[i])
        s_out.append(seg[i].flip(dims) if dims else seg[i])
    return torch.stack(d_out), torch.stack(s_out)


def mirror_augment(data: torch.Tensor, seg: torch.Tensor, *, generator: torch.Generator,
                   mirror_axes=(0, 1, 2)):
    """Random flips along each mirror axis with p 0.5, data and seg together
    (MirrorTransform)."""
    flips = torch.rand(data.shape[0], len(mirror_axes), generator=generator,
                       device=generator.device) < 0.5
    return mirror(data, seg, flips, mirror_axes)


def downsample_seg_for_ds(seg: torch.Tensor, ds_scales) -> list[torch.Tensor]:
    """Nearest-downsampled label targets per deep-supervision level: the
    scales are 1/2^k per axis, so strided slicing is exact nearest sampling."""
    out = []
    for scale in ds_scales:
        strides = [int(round(1.0 / s)) for s in scale]
        out.append(seg[(slice(None),) + tuple(slice(None, None, st) for st in strides)])
    return out
