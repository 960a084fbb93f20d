"""Frozen self-supervised RGB frame teacher, ported from
``openess_tpu/models/image_teacher.py``.

Dilated ResNet-50 -> trainable 1x1 ``decoder_conv`` to 256-d -> bilinear
upsample (align_corners=True) to the input size -> L2-normalized per-pixel
features. State-dict keys: ``encoder.*`` (torchvision ResNet-50 names) and
``decoder_conv.{weight,bias}``.
"""
from __future__ import annotations

import torch
from torch import nn

from openess_tpu_torch.models.resnet import ResNet50
from openess_tpu_torch.ops.resize import resize_bilinear

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
_DILATION = {
    4: (True, True, True),
    8: (False, True, True),
    16: (False, False, True),
}


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """ImageNet preprocessing of ``[0, 1]`` RGB NHWC images."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


class DilationFeatureExtractor(nn.Module):
    """256-d per-pixel frame features for the frame-to-event distillation.

    ``forward(x)`` takes NHWC images ``[B, H, W, 3]`` in ``[0, 1]`` and
    returns contiguous NHWC features ``[B, H, W, model_n_out]`` in the
    compute dtype. ``output_stride`` 4 is the fully dilated trunk; 8 and 16
    keep the first one or two stage strides.

    The encoder is frozen: it always runs with inference-mode BatchNorm and
    under ``torch.no_grad``, also when the module is in train mode; only
    ``decoder_conv`` receives gradients. Parameters stay in f32 and are cast
    to the compute dtype where they are used.
    """

    def __init__(self, model_n_out=256, normalize_features=True,
                 preprocess=True, output_stride=4, fold_bn=False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.normalize_features = normalize_features
        self.preprocess = preprocess
        self.dtype = dtype
        self.encoder = ResNet50(
            replace_stride_with_dilation=_DILATION[output_stride],
            fold_bn=fold_bn, dtype=dtype,
        )
        self.decoder_conv = nn.Conv2d(2048, model_n_out, 1)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        with torch.no_grad():
            if self.preprocess:
                x = imagenet_normalize(x)
            feat = self.encoder(x.permute(0, 3, 1, 2), train=False)
        dc = self.decoder_conv
        feat = nn.functional.conv2d(
            feat.to(self.dtype), dc.weight.to(self.dtype),
            dc.bias.to(self.dtype),
        )
        feat = resize_bilinear(feat.permute(0, 2, 3, 1), out_h=h, out_w=w,
                               align_corners=True)
        if self.normalize_features:
            norm = torch.linalg.vector_norm(
                feat.float(), dim=-1, keepdim=True).clamp_min(1e-12)
            feat = feat / norm.to(feat.dtype)
        return feat
