"""ResNet-50 trunk, ported from ``openess_tpu/models/resnet.py``.

torchvision semantics written out by hand (torchvision is not a
dependency): Bottleneck ``[3, 4, 6, 3]``, ``replace_stride_with_dilation``
with the previous-dilation rule for the first block of a dilated stage, BN
eps 1e-5, and torchvision's state-dict key names (``conv1.weight``,
``bn1.running_mean``, ``layer1.0.downsample.0.weight`` ...), which are the
keys ``openess_tpu/models/torch_convert.py:convert_resnet50`` reads.

``forward(x, train=False)`` takes the BatchNorm mode as an argument, as the
flax module does, and never reads the module's ``training`` flag: the frozen
frame teacher always runs with ``train=False`` while its trainable
``decoder_conv`` is in train mode, and the DeepLabV3 student runs with
``train=True`` in a train step whether or not anything of it trains.
``train=True`` normalizes with the batch statistics and updates the running
ones (:func:`batch_norm`, flax's arithmetic). Parameters stay in f32;
``dtype`` is the compute dtype. Each conv runs in ``dtype`` and its BN in
f32, as the flax module does. With ``fold_bn`` and ``train=False`` every BN
is folded into its conv (``s = gamma / sqrt(var + eps)`` scales the kernel,
``beta - mean * s`` is the bias; folded in f32, then cast to ``dtype``),
which is exact for inference and removes the f32 round trip between every
conv pair. The folded weights are a cache beside the parameters, keyed on
the compute dtype and the version counters of the conv weight and the four
BN tensors, so an optimizer step, a running-statistics update, a load, a
move or a cast refolds; ``state_dict`` keeps the unfolded keys.
"""
from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-5
BN_MOMENTUM = 0.1  # PyTorch's sense: flax's momentum 0.9 keeps 0.9 of the old


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm2d, *,
               train: bool) -> torch.Tensor:
    """flax ``BatchNorm`` of an NCHW tensor on ``bn``'s parameters and
    buffers, in f32 (f64 for an f64 ``x``); returns f32 (f64).

    ``train=False`` normalizes with the running statistics. ``train=True``
    normalizes with the batch statistics, the variance biased and computed
    as ``E[x^2] - E[x]^2`` clipped at zero (flax's arithmetic; one value a
    channel gives zero variance and the output is the bias, where
    ``F.batch_norm`` raises), and updates the running statistics in place
    with the same biased variance: ``r = 0.9 r + 0.1 batch``.
    """
    acc = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(acc)
    if not train:
        return F.batch_norm(
            xf, bn.running_mean.to(acc), bn.running_var.to(acc),
            bn.weight.to(acc), bn.bias.to(acc), False, 0.0, _BN_EPS)
    dims = (0, 2, 3)
    mean = xf.mean(dim=dims)
    var = (xf.square().mean(dim=dims) - mean.square()).clamp_min(0.0)
    with torch.no_grad():
        bn.running_mean.lerp_(mean.to(bn.running_mean.dtype), BN_MOMENTUM)
        bn.running_var.lerp_(var.to(bn.running_var.dtype), BN_MOMENTUM)
    mul = torch.rsqrt(var + _BN_EPS) * bn.weight.to(acc)
    return (xf - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias.to(acc)[:, None, None]


class _FoldCache(nn.Module):
    """Holds the per-(conv, bn) folded weights of the modules below it."""

    def __init__(self):
        super().__init__()
        self._folded: dict = {}

    def _apply(self, fn, *args, **kwargs):
        self._folded.clear()
        return super()._apply(fn, *args, **kwargs)

    def conv_bn(self, x, conv: nn.Conv2d, bn: nn.BatchNorm2d, *, fold: bool,
                train: bool, dtype: torch.dtype):
        """conv -> BatchNorm of an NCHW tensor (folded when ``fold`` and
        not ``train``)."""
        if train or not fold:
            y = F.conv2d(x.to(dtype), conv.weight.to(dtype), None,
                         conv.stride, conv.padding, conv.dilation)
            return batch_norm(y, bn, train=train)
        tensors = (conv.weight, bn.weight, bn.bias, bn.running_mean,
                   bn.running_var)
        version = (dtype,) + tuple(t._version for t in tensors)
        cached = self._folded.get(id(conv))
        if cached is None or cached[0] != version:
            # the fold takes no gradient; entered only when one is being
            # taken, so a traced eval step records no grad-mode switch
            with torch.set_grad_enabled(False) if torch.is_grad_enabled() \
                    else contextlib.nullcontext():
                s = bn.weight.float() * torch.rsqrt(
                    bn.running_var.float() + _BN_EPS)
                w = (conv.weight.float() * s[:, None, None, None]).to(dtype)
                b = (bn.bias.float() - bn.running_mean.float() * s).to(dtype)
            cached = (version, w.contiguous(
                memory_format=torch.channels_last), b)
            self._folded[id(conv)] = cached
        _, w, b = cached
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
    """``forward(x, train=False)`` takes an NCHW image batch and returns the
    layer4 feature map (NCHW, 2048 channels): f32 unless folded, where it
    is in ``dtype``.

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

    def forward(self, x, train: bool = False):
        cb = lambda x, conv, bn: self.conv_bn(
            x, conv, bn, fold=self.fold_bn, train=train, dtype=self.dtype)
        x = x.contiguous(memory_format=torch.channels_last)
        x = F.relu(cb(x, self.conv1, self.bn1))
        x = F.max_pool2d(x, 3, 2, 1)
        for li in range(1, 5):
            for block in getattr(self, f"layer{li}"):
                x = block(x, cb)
        return x
