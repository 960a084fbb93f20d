"""SemSegE2VID: skip decoder over the E2VID latent pyramid -> open-vocabulary
logits, ported from ``openess_tpu/models/semseg_e2vid.py`` (reference
``models/style_networks.py``, skip_connect=True, concat skips).

Module names are the reference's, so the state-dict keys are the ones
``openess_tpu/models/torch_convert.py:convert_semseg_e2vid`` reads:
``decoder_scale_1.{0..4}.model.{0,3}.*`` (INSResBlocks),
``decoder_scale_1.5.model.0.*``, ``decoder_scale_{2,3}.{0,1}.model.0.*``,
``decoder_scale_4.0.model.0.*``, ``decoder_ch256.0.*``,
``decoder_ch512.0.*``, ``linear_probe.*`` (linear probing only) and the
``text_embeddings`` buffer.
"""
from __future__ import annotations

import torch
from torch import nn

from openess_tpu_torch.models.e2vid import CastConv2d, nchw, nhwc
from openess_tpu_torch.ops.resize import upsample2x_nearest


def instance_norm(x: torch.Tensor) -> torch.Tensor:
    """torch ``InstanceNorm2d(affine=False)`` of an NCHW tensor with the
    statistics in f32 and the normalization in ``x.dtype`` (as the JAX
    package's ``_instance_norm``; exact under f32)."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    inv = torch.rsqrt(var + 1e-5).to(x.dtype)
    return (x - mean.to(x.dtype)) * inv


class InstanceNorm(nn.Module):
    def forward(self, x):
        return instance_norm(x)


def _conv3(cin, cout):
    return CastConv2d(cin, cout, 3, padding=1)


class ReLUINSConv2d(nn.Module):
    """Conv -> InstanceNorm (no affine) -> ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.model = nn.Sequential(_conv3(cin, cout), InstanceNorm(), nn.ReLU())

    def forward(self, x):
        return self.model(x)


class INSResBlock(nn.Module):
    """conv-IN-relu-conv-IN + residual."""

    def __init__(self, ch):
        super().__init__()
        self.model = nn.Sequential(
            _conv3(ch, ch), InstanceNorm(), nn.ReLU(),
            _conv3(ch, ch), InstanceNorm(),
        )

    def forward(self, x):
        return self.model(x) + x


def _up(x):
    return nchw(upsample2x_nearest(nhwc(x)))


class SemSegE2VID(nn.Module):
    """The voxel-path student head (input_c=256).

    ``forward(latent)`` takes the NHWC latent pyramid
    ``{"2": 64ch@1/2, "4": 128ch@1/4, "8": 256ch@1/8}`` and returns NHWC
    ``(logits [B, H, W, num_classes], feat256 [B, H, W, 256])``; the logits
    are the 512-d pixel features against the ``text_embeddings`` buffer,
    with ``linear_probe`` passed through one more 1x1 conv over the classes
    (the only part a linear probe trains).
    """

    def __init__(self, input_c=256, num_classes=11, text_embed_dim=512,
                 linear_probe=False):
        super().__init__()
        t = input_c
        self.decoder_scale_1 = nn.Sequential(
            *[INSResBlock(t) for _ in range(5)], ReLUINSConv2d(t, t // 2)
        )
        self.decoder_scale_2 = nn.Sequential(
            ReLUINSConv2d(t, t // 2), ReLUINSConv2d(t // 2, t // 4)
        )
        self.decoder_scale_3 = nn.Sequential(
            ReLUINSConv2d(t // 2, t // 4), ReLUINSConv2d(t // 4, t // 4)
        )
        self.decoder_scale_4 = nn.Sequential(ReLUINSConv2d(t // 4, t // 8))
        self.decoder_ch256 = nn.Sequential(CastConv2d(t // 8, 256, 1))
        self.decoder_ch512 = nn.Sequential(CastConv2d(256, text_embed_dim, 1))
        self.register_buffer(
            "text_embeddings", torch.zeros(num_classes, text_embed_dim)
        )
        self.linear_probe = (
            CastConv2d(num_classes, num_classes, 1) if linear_probe else None
        )

    def forward(self, latent: dict):
        x = self.decoder_scale_1(nchw(latent["8"]))
        x = _up(x)
        x = torch.cat([x, nchw(latent["4"]).to(x.dtype)], dim=1)
        x = self.decoder_scale_2(x)
        x = _up(x)
        x = torch.cat([x, nchw(latent["2"]).to(x.dtype)], dim=1)
        x = self.decoder_scale_3(x)
        x = _up(x)
        x = self.decoder_scale_4(x)
        feat256 = self.decoder_ch256(x)
        x512 = nhwc(self.decoder_ch512(feat256))
        logits = torch.matmul(x512, self.text_embeddings.to(x512.dtype).t())
        if self.linear_probe is not None:
            logits = nhwc(self.linear_probe(nchw(logits)))
        return logits, nhwc(feat256)
