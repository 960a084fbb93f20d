"""The MSDeformAttn pixel decoder of FC-CLIP, the counterpart of
``openess_tpu/models/fcclip/pixel_decoder.py``.

Reference: ``fc-clip/fcclip/modeling/pixel_decoder/msdeformattn.py:59-394``
(a deformable-DETR encoder over {res3, res4, res5} and one FPN step onto
res2) and the MSDeformAttn module ``.../ops/modules/ms_deform_attn.py:34-125``;
the sampling is ``ops/ms_deform_attn.py``.

As in the JAX module: FC-CLIP never pads its inputs (msdeformattn.py:98
builds all-False masks), so the valid ratios are 1, the padding masks are
dropped and the reference points are the pixel centres of each level; the
levels run top-down (res5, res4, res3); the LayerNorms and GroupNorms
compute in f32, the rest in ``dtype``; feature maps are NHWC.

Parameter names are the reference's (``input_proj.{i}.{0,1}``,
``transformer.level_embed``, ``transformer.encoder.layers.{i}.*``,
``adapter_1`` / ``layer_1`` with their ``norm``, ``mask_features``).
"""
from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openess_tpu_torch.models.fcclip.backbone import NHWCConv2d, ln_f32
from openess_tpu_torch.models.maskclip import CastLinear
from openess_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from openess_tpu_torch.ops.resize import resize_bilinear


# the encoder's levels, top-down (msdeformattn.py:249-256, 354-358)
LEVELS = ("res5", "res4", "res3")


@functools.lru_cache(maxsize=None)
def _position_embedding_sine_np(h, w, num_pos_feats, temperature):
    scale = 2 * math.pi
    eps = 1e-6
    y = np.arange(1, h + 1, dtype=np.float32) / (h + eps) * scale
    x = np.arange(1, w + 1, dtype=np.float32) / (w + eps) * scale
    dim_t = np.arange(num_pos_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_pos_feats)
    ones = np.ones((h, w, 1), np.float32)
    pos_x = ones * (x[None, :, None] / dim_t)  # [h, w, F]
    pos_y = ones * (y[:, None, None] / dim_t)  # [h, w, F]
    pos_x = np.stack([np.sin(pos_x[..., 0::2]), np.cos(pos_x[..., 1::2])], -1)
    pos_x = pos_x.reshape(h, w, -1)
    pos_y = np.stack([np.sin(pos_y[..., 0::2]), np.cos(pos_y[..., 1::2])], -1)
    pos_y = pos_y.reshape(h, w, -1)
    return np.concatenate([pos_y, pos_x], axis=-1)


@functools.lru_cache(maxsize=64)
def position_embedding_sine(h, w, num_pos_feats=128, temperature=10000,
                            device=None):
    """PositionEmbeddingSine(normalize=True) with no padding mask
    (position_encoding.py:32-56): ``[h, w, 2 * num_pos_feats]`` f32, y then
    x, channels last (the numpy arithmetic of the JAX function), made once
    per shape and device."""
    return torch.from_numpy(_position_embedding_sine_np(
        h, w, num_pos_feats, temperature)).to(device)


def msda_offset_bias(n_heads, n_levels, n_points) -> torch.Tensor:
    """The reference's directional grid init of ``sampling_offsets.bias``
    (ms_deform_attn.py:66-74)."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2.0 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    for i in range(n_points):
        grid[:, :, i, :] *= i + 1
    return torch.from_numpy(grid.reshape(-1).astype(np.float32))


@functools.lru_cache(maxsize=64)
def reference_points(shapes, device=None) -> torch.Tensor:
    """The levels' pixel centres in [0, 1], ``[sum h*w, 2]`` (x, y) f32."""
    refs = []
    for (h, w) in shapes:
        ry = (np.arange(h, dtype=np.float32) + 0.5) / h
        rx = (np.arange(w, dtype=np.float32) + 0.5) / w
        g = np.stack(np.meshgrid(rx, ry, indexing="xy"), axis=-1)  # [h,w,2]
        refs.append(g.reshape(-1, 2))
    return torch.from_numpy(np.concatenate(refs, axis=0)).to(device)


class MSDeformAttnModule(nn.Module):
    """The deformable attention module (ms_deform_attn.py:34-125): the
    value, offset and weight projections around the sampling op."""

    def __init__(self, d_model=256, n_levels=3, n_heads=8, n_points=4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.sampling_offsets = CastLinear(d_model,
                                           n_heads * n_levels * n_points * 2)
        self.attention_weights = CastLinear(d_model,
                                            n_heads * n_levels * n_points)
        self.value_proj = CastLinear(d_model, d_model)
        self.output_proj = CastLinear(d_model, d_model)
        with torch.no_grad():
            nn.init.zeros_(self.sampling_offsets.weight)
            self.sampling_offsets.bias.copy_(
                msda_offset_bias(n_heads, n_levels, n_points))
            nn.init.zeros_(self.attention_weights.weight)
            nn.init.zeros_(self.attention_weights.bias)

    def forward(self, query, reference_points, value_tokens, spatial_shapes):
        # query [B, Lq, C]; reference_points [B, Lq, n_levels, 2] in [0, 1];
        # value_tokens [B, Lin, C]; spatial_shapes ((h, w), ...)
        b, lq, c = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_tokens).reshape(b, -1, H, c // H)
        offsets = self.sampling_offsets(query).reshape(b, lq, H, L, P, 2)
        weights = self.attention_weights(query).reshape(b, lq, H, L * P)
        weights = torch.softmax(weights.float(), dim=-1).reshape(
            b, lq, H, L, P)
        normalizer = torch.tensor([[w, h] for (h, w) in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locations = (reference_points[:, :, None, :, None, :]
                     + offsets.float() / normalizer[None, None, None, :,
                                                    None, :])
        out = ms_deform_attn(value, tuple(spatial_shapes), locations, weights)
        return self.output_proj(out)


class MSDeformAttnEncoderLayer(nn.Module):
    """Deformable self-attention and FFN (msdeformattn.py:128-167); the
    FC-CLIP config's dropout is 0."""

    def __init__(self, d_model=256, d_ffn=1024, n_levels=3, n_heads=8,
                 n_points=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MSDeformAttnModule(d_model, n_levels, n_heads,
                                            n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = CastLinear(d_model, d_ffn)
        self.linear2 = CastLinear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, pos, reference_points, spatial_shapes):
        src = src + self.self_attn(src + pos, reference_points, src,
                                   spatial_shapes)
        src = ln_f32(self.norm1, src).to(self.dtype)
        src = src + self.linear2(F.relu(self.linear1(src)))
        return ln_f32(self.norm2, src).to(self.dtype)


class ConvNorm(NHWCConv2d):
    """detectron2's ``Conv2d`` with a GroupNorm(32) ``norm`` (no bias): the
    convolution in the input's dtype, the norm in f32."""

    def __init__(self, cin, cout, k, dtype=torch.float32):
        super().__init__(cin, cout, k, padding=k // 2, bias=False)
        self.dtype = dtype
        self.norm = nn.GroupNorm(32, cout, eps=1e-5)

    def forward(self, x):
        return group_norm_nhwc(self.norm, super().forward(x)).to(self.dtype)


def group_norm_nhwc(gn: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """``gn`` of an NHWC tensor, in f32 (a flax ``GroupNorm(dtype=f32)``)."""
    y = F.group_norm(x.permute(0, 3, 1, 2).float(), gn.num_groups, gn.weight,
                     gn.bias, gn.eps)
    return y.permute(0, 2, 3, 1)


class MSDeformAttnPixelDecoder(nn.Module):
    """The pixel decoder (msdeformattn.py:201-394). ``forward(features)``
    with the NHWC dict {res2..res5} -> ``(mask_features [B, h4, w4,
    mask_dim], [os32, os16, os8] NHWC maps)``, the FC-CLIP head's
    contract."""

    def __init__(self, in_channels: Sequence[int] = (192, 384, 768, 1536),
                 conv_dim=256, mask_dim=256, n_heads=8, dim_feedforward=1024,
                 enc_layers=6, n_points=4, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_dim = conv_dim
        channels = dict(zip(("res2", "res3", "res4", "res5"), in_channels))
        L = len(LEVELS)
        self.input_proj = nn.ModuleList(
            nn.Sequential(NHWCConv2d(channels[f], conv_dim, 1),
                          nn.GroupNorm(32, conv_dim, eps=1e-5))
            for f in LEVELS)
        self.transformer = nn.Module()
        self.transformer.level_embed = nn.Parameter(torch.randn(L, conv_dim))
        self.transformer.encoder = nn.Module()
        self.transformer.encoder.layers = nn.ModuleList(
            MSDeformAttnEncoderLayer(conv_dim, dim_feedforward, L, n_heads,
                                     n_points, dtype)
            for _ in range(enc_layers))
        # one FPN step onto res2 (norm="GN": the convs have no bias)
        self.adapter_1 = ConvNorm(channels["res2"], conv_dim, 1, dtype)
        self.layer_1 = ConvNorm(conv_dim, conv_dim, 3, dtype)
        self.mask_features = NHWCConv2d(conv_dim, mask_dim, 1)

    def encode(self, features):
        """The deformable encoder: ``(outs [os32, os16, os8] NHWC,
        shapes)``."""
        C = self.conv_dim
        level_embed = self.transformer.level_embed
        srcs, poss, shapes = [], [], []
        for proj, f in zip(self.input_proj, LEVELS):
            x = group_norm_nhwc(proj[1], proj[0](features[f])).to(self.dtype)
            srcs.append(x)
            h, w = x.shape[1], x.shape[2]
            shapes.append((h, w))
            poss.append(position_embedding_sine(h, w, C // 2,
                                                device=x.device))
        b = srcs[0].shape[0]
        src_flat = torch.cat([s.reshape(b, -1, C) for s in srcs], dim=1)
        pos_flat = torch.cat(
            [(p.reshape(1, -1, C) + level_embed[i][None, None]).to(self.dtype)
             for i, p in enumerate(poss)], dim=1).expand_as(src_flat)
        # normalized pixel-centre reference points, the same on every level
        # (get_reference_points with valid_ratios 1, msdeformattn.py:176-189)
        ref = reference_points(tuple(shapes), src_flat.device)
        ref = ref[None, :, None, :].expand(b, ref.shape[0], len(shapes), 2)

        y = src_flat
        for layer in self.transformer.encoder.layers:
            y = layer(y, pos_flat, ref, tuple(shapes))

        outs, offset = [], 0
        for (h, w) in shapes:
            outs.append(y[:, offset:offset + h * w].reshape(b, h, w, C))
            offset += h * w
        return outs

    def forward(self, features):
        outs = self.encode(features)
        lat = self.adapter_1(features["res2"])
        up = resize_bilinear(outs[-1], out_h=lat.shape[1], out_w=lat.shape[2],
                             align_corners=False).to(self.dtype)
        fused = F.relu(self.layer_1(lat + up))
        return self.mask_features(fused), outs[:3]
