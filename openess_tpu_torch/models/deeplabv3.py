"""DeepLabV3-ResNet50 student with the CLIP text-embedding classifier,
ported from ``openess_tpu/models/deeplabv3.py``.

The classifier is open-vocabulary: 512-d pixel features are scored against
the frozen CLIP text embeddings ``[num_classes, 512]`` (the
``classifier.text_embeddings`` buffer). ``forward`` returns NHWC
``(logits, feats)``, both resized to the input size; ``feats`` is the 256-d
ASPP output that the distillation losses read.

Module names are the reference's, so the state-dict keys are the ones
``openess_tpu/models/torch_convert.py:convert_deeplab`` reads:
``backbone.*`` (torchvision ResNet-50 names), ``classifier.ASPP.convs.{0..3}.
{0,1}`` (conv, BN), ``classifier.ASPP.convs.4.{1,2}`` (the pooling branch's
conv and BN), ``classifier.ASPP.project.{0,1}``,
``classifier.classifier.{0,1}`` (the 512-d conv and BN),
``classifier.text_embeddings`` and, under linear probing,
``linear_probe.{weight,bias}``.

Dtypes follow the flax module: parameters stay f32; every conv runs in the
compute dtype and every BatchNorm returns f32, so the ASPP features, the
text matmul (embeddings cast to f32) and both resizes are f32, and the
``linear_probe`` conv returns logits in the compute dtype. ``train`` is an
argument of ``forward``, never the module's flag (see ``models/resnet.py``):
``train=True`` normalizes with batch statistics, updates the running ones
and applies dropout (rate 0.1, elementwise, after the projection) with
draws from the ``generator`` it is given.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openess_tpu_torch.models.resnet import ResNet50, batch_norm
from openess_tpu_torch.ops.resize import resize_bilinear


def _conv(cin, cout, k=1, dilation=1):
    return nn.Conv2d(cin, cout, k, padding=dilation * (k // 2),
                     dilation=dilation, bias=False)


def _conv_bn(cin, cout, k=1, dilation=1):
    return nn.Sequential(_conv(cin, cout, k, dilation),
                         nn.BatchNorm2d(cout, eps=1e-5))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``Dropout``: each element is kept with probability
    ``1 - rate`` and scaled by ``1 / (1 - rate)``, the draws from
    ``generator`` (on ``x``'s device)."""
    if rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: a 1x1 branch, three dilated 3x3
    branches, the global-pool branch, concatenated and projected to
    ``out_channels``, then dropout."""

    def __init__(self, in_channels: int, atrous_rates: Sequence[int],
                 out_channels: int = 256, dropout_rate: float = 0.1):
        super().__init__()
        self.dropout_rate = dropout_rate
        self.convs = nn.ModuleList(
            [_conv_bn(in_channels, out_channels)]
            + [_conv_bn(in_channels, out_channels, 3, r)
               for r in atrous_rates]
            # the pool is parameter-free; it keeps the reference's
            # indices (convs.4.1 conv, convs.4.2 BN) in the state dict
            + [nn.Sequential(nn.AdaptiveAvgPool2d(1),
                             _conv(in_channels, out_channels),
                             nn.BatchNorm2d(out_channels, eps=1e-5))]
        )
        self.project = _conv_bn(5 * out_channels, out_channels)

    def forward(self, x, *, train: bool, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None):
        def cbr(x, conv, bn):
            y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                         conv.stride, conv.padding, conv.dilation)
            return F.relu(batch_norm(y, bn, train=train))

        res = [cbr(x, c[0], c[1]) for c in self.convs[:4]]
        g = x.mean(dim=(2, 3), keepdim=True)  # in x's dtype, as jnp.mean
        g = cbr(g, self.convs[4][1], self.convs[4][2])
        res.append(g.expand_as(res[0]))
        y = torch.cat(res, dim=1)
        y = cbr(y, self.project[0], self.project[1])
        if train:
            y = dropout(y, self.dropout_rate, generator)
        return y


class DeepLabHead(nn.Module):
    """ASPP -> 3x3 conv to the 512-d pixel features -> BN -> ReLU -> the
    text-embedding logits (a matmul over the channels)."""

    def __init__(self, in_channels: int, num_classes: int,
                 aspp_dilate: Sequence[int], text_embed_dim: int = 512):
        super().__init__()
        self.ASPP = ASPP(in_channels, aspp_dilate)
        self.classifier = _conv_bn(256, text_embed_dim, 3)
        self.register_buffer(
            "text_embeddings", torch.zeros(num_classes, text_embed_dim))

    def forward(self, feature, *, train: bool, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None):
        feats = self.ASPP(feature, train=train, dtype=dtype,
                          generator=generator)
        conv, bn = self.classifier[0], self.classifier[1]
        y = F.conv2d(feats.to(dtype), conv.weight.to(dtype), None,
                     conv.stride, conv.padding)
        y = F.relu(batch_norm(y, bn, train=train))
        # NCHW channels-last -> NHWC view, f32 against f32 embeddings
        logits = torch.matmul(y.permute(0, 2, 3, 1),
                              self.text_embeddings.to(y.dtype).t())
        return logits, feats.permute(0, 2, 3, 1)


class DeepLabV3TextSeg(nn.Module):
    """The recon/frame segmentation student.

    ``forward(x, train=False, generator=None)`` takes NHWC images
    ``[B, H, W, 3]`` and returns contiguous NHWC ``(logits [B, H, W, C],
    feats [B, H, W, 256])``. ``output_stride`` 8 dilates layer3 and layer4
    (ASPP rates 12/24/36); any other value dilates layer4 only (rates
    6/12/18), the reference's ``== 8`` rule. ``fold_bn`` folds the
    backbone's BNs, and only in eval; the ASPP and classifier BNs never
    fold. ``linear_probe`` adds the 1x1 class-mixing conv (with bias) on
    the resized logits.
    """

    def __init__(self, num_classes: int, output_stride: int = 16,
                 linear_probe: bool = False, fold_bn: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if output_stride == 8:
            rswd, dilate = (False, True, True), (12, 24, 36)
        else:
            rswd, dilate = (False, False, True), (6, 12, 18)
        self.dtype = dtype
        self.backbone = ResNet50(replace_stride_with_dilation=rswd,
                                 fold_bn=fold_bn, dtype=dtype)
        self.classifier = DeepLabHead(2048, num_classes, dilate)
        self.linear_probe = (nn.Conv2d(num_classes, num_classes, 1)
                             if linear_probe else None)

    def forward(self, x, train: bool = False,
                generator: Optional[torch.Generator] = None):
        h, w = x.shape[1], x.shape[2]
        feat = self.backbone(x.permute(0, 3, 1, 2), train=train)
        logits, feats = self.classifier(feat, train=train, dtype=self.dtype,
                                        generator=generator)
        logits = resize_bilinear(logits.contiguous(), out_h=h, out_w=w)
        feats = resize_bilinear(feats.contiguous(), out_h=h, out_w=w)
        if self.linear_probe is not None:
            lp = self.linear_probe
            y = F.conv2d(logits.to(self.dtype).permute(0, 3, 1, 2),
                         lp.weight.to(self.dtype), lp.bias.to(self.dtype))
            logits = y.permute(0, 2, 3, 1).contiguous()
        return logits, feats
