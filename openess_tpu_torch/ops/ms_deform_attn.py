"""Multi-scale deformable attention sampling, the counterpart of
``openess_tpu/ops/ms_deform_attn.py``.

Reference: the FC-CLIP pixel decoder's CUDA op
``fc-clip/fcclip/modeling/pixel_decoder/ops/src/cuda/ms_deform_im2col_cuda.cuh``
(and its pure-torch fallback ``ops/functions/ms_deform_attn_func.py:52``):
per (query, head, level, point) a bilinear sample of the value map at a
normalized location, reduced with the attention weights.

The JAX package computes this with an XLA gather and a weighted sum, no
Pallas kernel, so plain PyTorch is its port. Sampling follows torch
``grid_sample(align_corners=False, padding_mode='zeros')``: ``pix = loc *
size - 0.5``, and a tap outside the map adds zero. Each tap is one row
gather of the ``[B*H*h*w, D]`` value table by a flat ``[B*H, Lq*P]``
index (no index is expanded to D: at 480x640 Lq is 6300 tokens, and an
int64 index as wide as the values would be ~50 MB a tap).

Shapes (as the reference op's):
  value              [B, L_in, H, D]    the levels' value tokens, flattened
  spatial_shapes     ((h_l, w_l), ...)  per level
  sampling_locations [B, L_q, H, levels, P, 2]  in [0, 1] (x, y)
  attention_weights  [B, L_q, H, levels, P]
Returns            [B, L_q, H * D] in ``value``'s dtype; the sampling and
the sums are f32.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def _bilinear_sample_zeros(table: torch.Tensor, base: torch.Tensor,
                           hh: int, ww: int, x: torch.Tensor,
                           y: torch.Tensor) -> torch.Tensor:
    """Bilinear taps with zero padding. ``table`` is ``[N * hh * ww, D]``
    f32 (the maps of N = B*H heads, row-major); ``base`` ``[N, 1]`` each
    map's first row; ``x``, ``y`` ``[N, Q]`` pixel coordinates (half-pixel
    convention already applied). Returns ``[N, Q, D]``."""
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    def tap(yi, xi):
        inside = (xi >= 0) & (xi < ww) & (yi >= 0) & (yi < hh)
        xc = xi.clamp(0, ww - 1).long()
        yc = yi.clamp(0, hh - 1).long()
        v = table[base + yc * ww + xc]  # [N, Q, D]
        return v * inside[..., None]

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    return (v00 * (1 - wx) * (1 - wy) + v01 * wx * (1 - wy)
            + v10 * (1 - wx) * wy + v11 * wx * wy)


def ms_deform_attn(value: torch.Tensor,
                   spatial_shapes: Sequence[Tuple[int, int]],
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    b, l_in, h, d = value.shape
    _, l_q, _, levels, p, _ = sampling_locations.shape
    if levels != len(spatial_shapes):
        raise ValueError(f"{levels} levels of locations for "
                         f"{len(spatial_shapes)} spatial shapes")
    if l_in != sum(hh * ww for hh, ww in spatial_shapes):
        raise ValueError(f"{l_in} value tokens do not tile {spatial_shapes}")

    out = torch.zeros((b, l_q, h, d), dtype=torch.float32,
                      device=value.device)
    offset = 0
    for li, (hh, ww) in enumerate(spatial_shapes):
        v = value[:, offset:offset + hh * ww]  # [B, hh*ww, H, D]
        offset += hh * ww
        table = v.permute(0, 2, 1, 3).float().reshape(b * h * hh * ww, d)
        base = torch.arange(b * h, device=value.device)[:, None] * (hh * ww)

        loc = sampling_locations[:, :, :, li]  # [B, L_q, H, P, 2]
        # grid_sample(align_corners=False) pixel mapping of grid=2*loc-1
        px = loc[..., 0] * ww - 0.5
        py = loc[..., 1] * hh - 0.5
        px = px.permute(0, 2, 1, 3).reshape(b * h, l_q * p)
        py = py.permute(0, 2, 1, 3).reshape(b * h, l_q * p)

        sampled = _bilinear_sample_zeros(table, base, hh, ww, px, py)
        sampled = sampled.reshape(b, h, l_q, p, d)
        w = attention_weights[:, :, :, li].permute(0, 2, 1, 3).float()
        out = out + torch.einsum("bhqpd,bhqp->bqhd", sampled, w)

    return out.reshape(b, l_q, h * d).to(value.dtype)
