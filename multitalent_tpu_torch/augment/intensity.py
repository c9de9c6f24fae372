"""Intensity augmentation on the card, batched per sample.

Counterpart of multitalent_tpu/augment/intensity.py:30-158 (the moreDA chain
of batchgenerators: GaussianNoise, GaussianBlur, BrightnessMultiplicative,
Brightness (additive), Contrast, SimulateLowResolution, Gamma). data is
(B, C, *S) float32; each transform draws its per-sample (and per-channel)
parameters from an explicit `torch.Generator` on the data's device and applies
itself only where its draw says so.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rand(gen: torch.Generator, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return _rand(gen, *shape) * (hi - lo) + lo


def _per_sample(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1)"""
    return x.reshape(x.shape[0], *(1,) * (ndim - 1))


def _per_channel(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B, C) -> (B, C, 1, ..., 1)"""
    return x.reshape(*x.shape[:2], *(1,) * (ndim - 2))


def _spatial(data: torch.Tensor) -> tuple[int, ...]:
    return tuple(range(2, data.dim()))


def gaussian_noise(data, *, generator, p=0.1, variance=(0.0, 0.1)):
    """Add N(0, sigma^2) noise, sigma ~ U(variance) (the reference samples
    "variance" and uses it as the scale)."""
    b = data.shape[0]
    apply = _rand(generator, b) < p
    sigma = _uniform(generator, (b,), *variance)
    noise = torch.randn(data.shape, generator=generator, device=generator.device)
    return torch.where(_per_sample(apply, data.dim()),
                       data + noise * _per_sample(sigma, data.dim()), data)


def blur_weights(sigma: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """(B, C) sigmas -> (B, C, 2 * radius + 1) normalised gaussian taps."""
    taps = torch.arange(-radius, radius + 1, dtype=torch.float32, device=sigma.device)
    w = torch.exp(-0.5 * (taps / sigma[..., None]) ** 2)
    return w / w.sum(-1, keepdim=True)


def blur(data: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Separable blur of every (sample, channel) with its taps w (B, C, K),
    reflect-padded, one axis after the other, as a shifted sum."""
    k = w.shape[-1]
    r = k // 2
    out = data
    for axis in _spatial(data):
        pad = [0, 0] * (data.dim() - 2)
        side = 2 * (data.dim() - 1 - axis)  # F.pad counts from the last axis
        pad[side:side + 2] = [r, r]
        xp = F.pad(out, pad, mode="reflect")
        acc = torch.zeros_like(out)
        for i in range(k):
            acc = acc + xp.narrow(axis, i, out.shape[axis]) * _per_channel(w[..., i],
                                                                            data.dim())
        out = acc
    return out


def gaussian_blur(data, *, generator, p=0.2, p_per_channel=0.5, sigma_range=(0.5, 1.0),
                  radius=3):
    b, c = data.shape[:2]
    apply_sample = _rand(generator, b) < p
    apply_channel = _rand(generator, b, c) < p_per_channel
    sigma = _uniform(generator, (b, c), *sigma_range)
    apply = apply_sample[:, None] & apply_channel
    if not bool(apply.any()):
        return data
    return torch.where(_per_channel(apply, data.dim()),
                       blur(data, blur_weights(sigma, radius)), data)


def brightness_multiplicative(data, *, generator, p=0.15, mult_range=(0.75, 1.25)):
    b, c = data.shape[:2]
    apply = _rand(generator, b) < p
    mult = _uniform(generator, (b, c), *mult_range)
    return torch.where(_per_sample(apply, data.dim()),
                       data * _per_channel(mult, data.dim()), data)


def brightness_additive(data, *, generator, p=0.15, mu=0.0, sigma=0.1):
    """Add a per-sample gaussian offset (the additive BrightnessTransform)."""
    b = data.shape[0]
    offs = mu + sigma * torch.randn(b, generator=generator, device=generator.device)
    apply = _rand(generator, b) < p
    return data + _per_sample(torch.where(apply, offs, torch.zeros_like(offs)), data.dim())


def contrast_augmentation(data, *, generator, p=0.15, contrast_range=(0.75, 1.25),
                          preserve_range=True):
    b, c = data.shape[:2]
    apply = _rand(generator, b) < p
    factor = _uniform(generator, (b, c), *contrast_range)
    sp = _spatial(data)
    mean = data.mean(dim=sp, keepdim=True)
    out = (data - mean) * _per_channel(factor, data.dim()) + mean
    if preserve_range:
        out = torch.clamp(out, data.amin(dim=sp, keepdim=True),
                          data.amax(dim=sp, keepdim=True))
    return torch.where(_per_sample(apply, data.dim()), out, data)


def pixelate(vol: torch.Tensor, zoom: float) -> torch.Tensor:
    """vol (C, *S) sampled at a virtual low-resolution grid of cell size
    1 / zoom (nearest), back at full resolution (intensity.py:104-127)."""
    out = vol
    z = torch.tensor(zoom, dtype=torch.float32, device=vol.device)
    for axis in range(1, vol.dim()):
        n = vol.shape[axis]
        idx = torch.arange(n, dtype=torch.float32, device=vol.device)
        cell = torch.floor(idx * z) + 0.5
        src = torch.clamp(torch.round(cell / z - 0.5), 0, n - 1).long()
        out = out.index_select(axis, src)
    return out


def simulate_low_resolution(data, *, generator, p=0.25, p_per_channel=0.5,
                            zoom_range=(0.5, 1.0)):
    b, c = data.shape[:2]
    apply_sample = _rand(generator, b) < p
    apply_channel = _rand(generator, b, c) < p_per_channel
    zoom = _uniform(generator, (b,), *zoom_range).tolist()
    apply = apply_sample[:, None] & apply_channel
    if not bool(apply.any()):
        return data
    pix = torch.stack([pixelate(data[i], zoom[i]) for i in range(b)])
    return torch.where(_per_channel(apply, data.dim()), pix, data)


def gamma_transform(data: torch.Tensor, gamma: torch.Tensor, invert: bool) -> torch.Tensor:
    """x -> ((x - min) / range) ** gamma, per (sample, channel), with the
    channel's mean and std restored (retain_stats); on -x when `invert`."""
    sp = _spatial(data)
    x = -data if invert else data
    mn_stat = x.mean(dim=sp, keepdim=True)
    sd_stat = x.std(dim=sp, keepdim=True, correction=0)
    mn = x.amin(dim=sp, keepdim=True)
    rnge = x.amax(dim=sp, keepdim=True) - mn
    eps = 1e-7
    y = torch.pow((x - mn) / (rnge + eps), _per_channel(gamma, data.dim())) * (rnge + eps) + mn
    y = ((y - y.mean(dim=sp, keepdim=True))
         / (y.std(dim=sp, keepdim=True, correction=0) + 1e-8) * sd_stat + mn_stat)
    return -y if invert else y


def gamma_augmentation(data, *, generator, p=0.3, gamma_range=(0.7, 1.5), invert=False):
    """Gamma < 1 and > 1 equally likely (GammaTransform)."""
    b, c = data.shape[:2]
    apply = _rand(generator, b) < p
    pick_lo = _rand(generator, b, c) < 0.5
    gamma = torch.where(pick_lo, _uniform(generator, (b, c), gamma_range[0], 1.0),
                        _uniform(generator, (b, c), 1.0, gamma_range[1]))
    if not bool(apply.any()):
        return data
    return torch.where(_per_sample(apply, data.dim()),
                       gamma_transform(data, gamma, invert), data)
