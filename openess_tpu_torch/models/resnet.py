"""ResNet-50 trunk, ported from ``openess_tpu/models/resnet.py``.

torchvision semantics written out by hand (torchvision is not a
dependency): Bottleneck ``[3, 4, 6, 3]``, ``replace_stride_with_dilation``
with the previous-dilation rule for the first block of a dilated stage, BN
eps 1e-5, and torchvision's state-dict key names (``conv1.weight``,
``bn1.running_mean``, ``layer1.0.downsample.0.weight`` ...), which are the
keys ``openess_tpu/models/torch_convert.py:convert_resnet50`` reads.

The trunk is an inference-only feature extractor here (the frozen frame
teacher): its BatchNorms always use the running statistics, whatever the
module's train flag. Parameters stay in f32; ``dtype`` is the compute dtype.
Without ``fold_bn`` each conv runs in ``dtype`` and its BN in f32, as the
flax module does. With ``fold_bn`` every inference BN is folded into its
conv (``s = gamma / sqrt(var + eps)`` scales the kernel, ``beta - mean * s``
is the bias; folded in f32, then cast to ``dtype``), which is exact for
frozen statistics and removes the f32 round trip between every conv pair.
The folded weights are a cache beside the parameters: ``state_dict`` keeps
the unfolded keys, and the cache is dropped whenever the parameters are
loaded, moved or cast.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5


class _FoldCache(nn.Module):
    """Holds the per-(conv, bn) folded weights of the modules below it."""

    def __init__(self):
        super().__init__()
        self._folded: dict = {}
        self.register_load_state_dict_post_hook(
            lambda module, _keys: module._folded.clear()
        )

    def _apply(self, fn, *args, **kwargs):
        self._folded.clear()
        return super()._apply(fn, *args, **kwargs)

    def conv_bn(self, x, conv: nn.Conv2d, bn: nn.BatchNorm2d, *, fold: bool,
                dtype: torch.dtype):
        """conv -> inference BatchNorm of an NCHW tensor."""
        if not fold:
            y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                         conv.stride, conv.padding, conv.dilation)
            return F.batch_norm(
                y.float(), bn.running_mean.float(), bn.running_var.float(),
                bn.weight.float(), bn.bias.float(), False, 0.0, _BN_EPS,
            )
        key = id(conv)
        if key not in self._folded:
            with torch.no_grad():
                s = bn.weight.float() * torch.rsqrt(
                    bn.running_var.float() + _BN_EPS)
                w = (conv.weight.float() * s[:, None, None, None]).to(dtype)
                b = (bn.bias.float() - bn.running_mean.float() * s).to(dtype)
            self._folded[key] = (w.contiguous(
                memory_format=torch.channels_last), b)
        w, b = self._folded[key]
        return F.conv2d(x.to(dtype), w, b, conv.stride, conv.padding,
                        conv.dilation)


def _conv(cin, cout, k, stride=1, dilation=1, pad=0):
    return nn.Conv2d(cin, cout, k, stride, pad, dilation, bias=False)


class Bottleneck(nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 has_downsample=False):
        super().__init__()
        self.conv1 = _conv(inplanes, planes, 1)
        self.bn1 = nn.BatchNorm2d(planes, eps=_BN_EPS)
        self.conv2 = _conv(planes, planes, 3, stride, dilation, dilation)
        self.bn2 = nn.BatchNorm2d(planes, eps=_BN_EPS)
        self.conv3 = _conv(planes, planes * 4, 1)
        self.bn3 = nn.BatchNorm2d(planes * 4, eps=_BN_EPS)
        if has_downsample:
            self.downsample = nn.Sequential(
                _conv(inplanes, planes * 4, 1, stride),
                nn.BatchNorm2d(planes * 4, eps=_BN_EPS),
            )
        else:
            self.downsample = None

    def forward(self, x, cb):
        out = F.relu(cb(x, self.conv1, self.bn1))
        out = F.relu(cb(out, self.conv2, self.bn2))
        out = cb(out, self.conv3, self.bn3)
        identity = x
        if self.downsample is not None:
            identity = cb(x, self.downsample[0], self.downsample[1])
        return F.relu(out + identity.to(out.dtype))


class ResNet50(_FoldCache):
    """``forward(x)`` takes an NCHW image batch and returns the layer4
    feature map (NCHW, 2048 channels).

    ``replace_stride_with_dilation``: (False, False, True) is output stride
    16, (False, True, True) 8, (True, True, True) 4 (the frame teacher).
    """

    def __init__(self, replace_stride_with_dilation: Sequence[bool] = (
            False, False, True), layers: Sequence[int] = (3, 4, 6, 3),
            fold_bn: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fold_bn = fold_bn
        self.dtype = dtype
        self.conv1 = _conv(3, 64, 7, 2, 1, 3)
        self.bn1 = nn.BatchNorm2d(64, eps=_BN_EPS)
        dilation, inplanes = 1, 64
        for li, (planes, blocks) in enumerate(zip((64, 128, 256, 512),
                                                  layers)):
            stride = 1 if li == 0 else 2
            dilate = li > 0 and replace_stride_with_dilation[li - 1]
            previous_dilation = dilation
            if dilate:
                dilation *= stride
                stride = 1
            stage = []
            for bi in range(blocks):
                first = bi == 0
                stage.append(Bottleneck(
                    inplanes, planes,
                    stride=stride if first else 1,
                    dilation=previous_dilation if first else dilation,
                    has_downsample=first and (
                        stride != 1 or inplanes != planes * 4),
                ))
                if first:
                    inplanes = planes * 4
            setattr(self, f"layer{li + 1}", nn.ModuleList(stage))

    def forward(self, x):
        cb = lambda x, conv, bn: self.conv_bn(
            x, conv, bn, fold=self.fold_bn, dtype=self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(cb(x, self.conv1, self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, cb)
        return x
