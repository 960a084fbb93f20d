"""Resize ops for NHWC tensors (the counterpart of
``openess_tpu/ops/resize.py``; ``resize_nearest`` is still to be ported).

The JAX package computes these outside any Pallas kernel, so plain PyTorch
is their port."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact torch ``interpolate(scale_factor=2, mode='nearest')`` (pixel
    repeat) of an NHWC tensor, returned as a contiguous NHWC tensor."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c
    )


def resize_bilinear(x: torch.Tensor, *, out_h: int, out_w: int,
                    align_corners: bool = False) -> torch.Tensor:
    """Bilinear resize of an NHWC tensor ``[B, H, W, C]`` to
    ``[B, out_h, out_w, C]`` with torch ``F.interpolate`` semantics for both
    ``align_corners`` conventions. The interpolation runs on an NCHW view
    (channels-last memory when ``x`` is contiguous), so no layout copy is
    made; the result is a contiguous NHWC tensor."""
    if tuple(x.shape[1:3]) == (out_h, out_w):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(out_h, out_w),
                      mode="bilinear", align_corners=align_corners)
    return y.permute(0, 2, 3, 1).contiguous()
