"""Resize ops (the part of ``openess_tpu/ops/resize.py`` on the serving
path; ``resize_bilinear`` and ``resize_nearest`` are still to be ported)."""
from __future__ import annotations

import torch


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """Exact torch ``interpolate(scale_factor=2, mode='nearest')`` (pixel
    repeat) of an NHWC tensor, returned as a contiguous NHWC tensor."""
    b, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c).reshape(
        b, 2 * h, 2 * w, c
    )
