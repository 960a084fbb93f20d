"""Paired train-time augmentation on the device, ported from
``openess_tpu/data/augment.py``.

Per sample:
  - p=.5 horizontal flip applied consistently to every spatial tensor
  - p=.5 brightness  * U(0.8, 1.2)  on recon and/or frame (independent draws)
  - p=.5 contrast    * U(0.8, 1.2)  (torchvision ``adjust_contrast``)
  - p=.5 additive N(0, 0.05) noise

The three gates are shared by recon and frame; the factors and the noise
are drawn per image key. :func:`draw_decisions` draws everything from an
explicit ``torch.Generator``; :func:`augment_batch` applies a set of
decisions, so a caller can also pass its own (the JAX package's PRNG draws
cannot be reproduced, so a comparison feeds both sides the same decisions).
"""
from __future__ import annotations

import torch

IMAGE_KEYS = ("recon", "frame")
# spatial tensors: (key, W-axis index within the batched tensor)
_FLIP_AXES = {
    "event": 4,       # [B, T, bins, H, W] planar windows
    "recon": 2,       # [B, H, W, 3]
    "frame": 2,
    "label": 2,       # [B, H, W]
    "pl": 2,
    "superpixel": 2,
    "sam_feat": 2,    # [B, h, w, C]
}


def adjust_brightness(img, factor):
    return torch.clamp(img * factor, 0.0, 1.0)


def adjust_contrast(img, factor):
    """Blend with the mean of the grayscale image (per sample); ``img`` is
    ``[B, H, W, 3]``, ``factor`` broadcasts against it."""
    gray = 0.2989 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]
    mean = gray.mean(dim=(1, 2))[:, None, None, None]
    return torch.clamp((img - mean) * factor + mean, 0.0, 1.0)


def draw_decisions(batch: dict, generator: torch.Generator) -> dict:
    """Draw one set of augmentation decisions for ``batch`` on the
    generator's device: ``flip``/``bright``/``contrast``/``noise`` bool
    ``[B]`` and, per image key present, ``bright_factor``/
    ``contrast_factor`` ``[B]`` and ``noise_value`` (the image's shape)."""
    b = next(iter(batch.values())).shape[0]
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    d = {name: uniform(b) >= 0.5
         for name in ("flip", "bright", "contrast", "noise")}
    for key in IMAGE_KEYS:
        if key not in batch:
            continue
        d[f"bright_factor_{key}"] = 0.8 + 0.4 * uniform(b)
        d[f"contrast_factor_{key}"] = 0.8 + 0.4 * uniform(b)
        d[f"noise_value_{key}"] = 0.05 * torch.randn(
            batch[key].shape, generator=generator, device=dev
        ).to(batch[key].dtype)
    return d


def _per_sample(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return mask.to(like.device).view(-1, *([1] * (like.ndim - 1)))


def augment_batch(batch: dict, decisions: dict) -> dict:
    """Apply ``decisions`` (from :func:`draw_decisions`, or the caller's)
    to ``batch``; returns a new dict, inputs untouched."""
    out = dict(batch)
    for key, axis in _FLIP_AXES.items():
        if key in out:
            x = out[key]
            out[key] = torch.where(_per_sample(decisions["flip"], x),
                                   torch.flip(x, dims=(axis,)), x)
    for key in IMAGE_KEYS:
        if key not in out:
            continue
        img = out[key]
        f = lambda name: _per_sample(decisions[name], img).to(img.dtype)
        g = lambda name: _per_sample(decisions[name], img)
        img = torch.where(
            g("bright"),
            adjust_brightness(img, f(f"bright_factor_{key}")), img)
        img = torch.where(
            g("contrast"),
            adjust_contrast(img, f(f"contrast_factor_{key}")), img)
        img = torch.where(
            g("noise"),
            img + decisions[f"noise_value_{key}"].to(img.device, img.dtype),
            img)
        out[key] = img
    return out
