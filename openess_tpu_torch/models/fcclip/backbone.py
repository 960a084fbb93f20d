"""The CLIP ConvNeXt-Large backbone of FC-CLIP, the counterpart of
``openess_tpu/models/fcclip/backbone.py``.

Reference: ``fc-clip/fcclip/modeling/backbone/clip.py:27-237`` around
open_clip's ``convnext_large_d_320`` (a timm ConvNeXt trunk, an MLP
projection head and the CLIP text transformer). Three paths:

- :class:`ConvNeXtCLIPVisual` (``extract_features_convnext``,
  clip.py:120-130): stem and 4 stages -> {stem, res2..res5,
  clip_vis_dense}, output strides 4 to 32;
- :class:`CLIPVisualProjection` (``visual_prediction_forward_convnext``,
  clip.py:150-155): mask-pooled features -> the trunk's head norm -> the
  MLP projection -> the 768-d CLIP space;
- :class:`CLIPTextEncoder` (``encode_text``, clip.py:90-102): the text
  transformer behind the open-vocabulary classifier.

As in the JAX modules: parameters are f32 and the convolutions and linear
layers compute in ``dtype`` (weights cast per call); LayerNorms compute in
f32 (eps 1e-6 in the trunk, 1e-5 in the text tower); GELU is the exact one;
the text attention is causal, its logits and softmax f32. Feature maps are
NHWC tensors; a convolution runs on the NCHW view (cuDNN, the 7x7 depthwise
one with ``groups=dim``).

Parameter names are timm's and open_clip's, so the released weights load
with ``load_state_dict`` (``models/fcclip/convert.py``).
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openess_tpu_torch.models.e2vid import CastConv2d
from openess_tpu_torch.models.maskclip import CastLinear

# convnext_large_d_320 (open_clip): trunk depths/dims, 768-d CLIP embedding
CONVNEXT_LARGE_DEPTHS = (3, 3, 27, 3)
CONVNEXT_LARGE_DIMS = (192, 384, 768, 1536)
CLIP_EMBED_DIM = 768
CLIP_HEAD_WIDTH = 64  # the text tower's heads: width // 64 (768: 12)


def ln_f32(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """``ln`` over the last axis in f32 (a flax ``LayerNorm(dtype=f32)``:
    the result stays f32)."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class NHWCConv2d(CastConv2d):
    """``CastConv2d`` (the input's dtype, the f32 parameters cast per call)
    on an NHWC tensor: the convolution runs on its NCHW view."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class Mlp(nn.Module):
    """timm's ``Mlp``: ``fc1`` -> exact GELU -> ``fc2``."""

    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.fc1 = CastLinear(dim, hidden)
        self.fc2 = CastLinear(hidden, out)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class ConvNeXtBlock(nn.Module):
    """timm ConvNeXt block: 7x7 depthwise -> LN -> MLP(4x, GELU) -> gamma,
    plus the shortcut."""

    def __init__(self, dim: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv_dw = NHWCConv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, 4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), 1e-6))

    def forward(self, x):
        y = self.conv_dw(x)
        y = ln_f32(self.norm, y).to(self.dtype)
        y = self.mlp(y)
        return x + y * self.gamma.to(y.dtype)


class ConvNeXtStage(nn.Module):
    """An optional (LN -> 2x2/s2 conv) ``downsample`` and ``depth``
    blocks."""

    def __init__(self, in_dim: int, dim: int, depth: int, downsample: bool,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        if downsample:
            self.downsample = nn.Sequential(
                nn.LayerNorm(in_dim, eps=1e-6),
                NHWCConv2d(in_dim, dim, 2, stride=2))
        else:
            self.downsample = None
        self.blocks = nn.Sequential(
            *[ConvNeXtBlock(dim, dtype) for _ in range(depth)])

    def forward(self, x):
        if self.downsample is not None:
            x = ln_f32(self.downsample[0], x).to(self.dtype)
            x = self.downsample[1](x)
        for blk in self.blocks:
            x = blk(x)
        return x


class ConvNeXtCLIPVisual(nn.Module):
    """The ConvNeXt trunk: ``forward(x [B, H, W, 3], CLIP-normalized)`` ->
    the feature dict (extract_features_convnext, clip.py:120-130)."""

    def __init__(self, depths: Sequence[int] = CONVNEXT_LARGE_DEPTHS,
                 dims: Sequence[int] = CONVNEXT_LARGE_DIMS,
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.stem = nn.Sequential(NHWCConv2d(3, dims[0], 4, stride=4),
                                  nn.LayerNorm(dims[0], eps=1e-6))
        self.stages = nn.ModuleList(
            ConvNeXtStage(dims[max(i - 1, 0)], dim, depth, i > 0, dtype)
            for i, (dim, depth) in enumerate(zip(dims, depths)))

    def forward(self, x):
        out = {}
        x = self.stem[0](x.to(self.dtype))
        x = ln_f32(self.stem[1], x).to(self.dtype)
        out["stem"] = x  # os4
        for i, stage in enumerate(self.stages):
            x = stage(x)
            out[f"res{i + 2}"] = x  # os4, os8, os16, os32
        # norm_pre is Identity for convnext_large_d (head_norm_first False)
        out["clip_vis_dense"] = x
        return out


class CLIPVisualProjection(nn.Module):
    """``[..., trunk_dim]`` mask-pooled features -> ``[..., embed_dim]``
    CLIP space: the trunk's head LayerNorm (its average pool is trivial on
    pooled vectors) and the open_clip MLP head (fc1 -> GELU -> fc2)."""

    def __init__(self, trunk_dim: int = CONVNEXT_LARGE_DIMS[-1],
                 embed_dim: int = CLIP_EMBED_DIM, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.norm = nn.LayerNorm(trunk_dim, eps=1e-6)
        self.mlp = Mlp(trunk_dim, 2 * embed_dim, embed_dim)

    def forward(self, pooled):
        return self.mlp(ln_f32(self.norm, pooled).to(self.dtype))


class TextAttention(nn.Module):
    """``nn.MultiheadAttention``'s layout (``in_proj_weight [3C, C]``,
    ``in_proj_bias``, ``out_proj``) with the causal mask of the CLIP text
    transformer."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = CastLinear(width, width)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, x):
        b, l, c = x.shape
        hd = c // self.heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype),
                       self.in_proj_bias.to(x.dtype))
        q, k, v = qkv.split(c, dim=-1)

        def heads(t):
            return t.reshape(b, l, self.heads, hd).transpose(1, 2)

        logits = (heads(q) * (1.0 / math.sqrt(hd))).float() @ heads(
            k).float().transpose(-1, -2)
        causal = torch.ones(l, l, dtype=torch.bool, device=x.device).tril()
        logits = logits.masked_fill(~causal, -torch.inf)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (attn @ heads(v)).transpose(1, 2).reshape(b, l, c)
        return self.out_proj(out)


class TextMlp(nn.Module):
    """open_clip's ``mlp``: ``c_fc`` -> exact GELU -> ``c_proj``."""

    def __init__(self, width: int):
        super().__init__()
        self.c_fc = CastLinear(width, 4 * width)
        self.c_proj = CastLinear(4 * width, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class TextBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(width, eps=1e-5)
        self.attn = TextAttention(width, heads)
        self.ln_2 = nn.LayerNorm(width, eps=1e-5)
        self.mlp = TextMlp(width)

    def forward(self, x):
        x = x + self.attn(ln_f32(self.ln_1, x).to(self.dtype))
        return x + self.mlp(ln_f32(self.ln_2, x).to(self.dtype))


class CLIPTextEncoder(nn.Module):
    """The CLIP text transformer (convnext_large_d's text config: width
    768, 12 heads, 16 layers, vocab 49408, context 77). ``forward(tokens
    [B, context] int)`` -> the un-normalized eot-token embedding in CLIP
    space ``[B, embed_dim]`` f32, the eot being the highest token id
    (clip.py:90-102). Its ``state_dict`` is open_clip's text tower without
    the ``backbone.clip_model.`` prefix."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 768, heads: int = 12, layers: int = 16,
                 embed_dim: int = CLIP_EMBED_DIM, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width)
        self.positional_embedding = nn.Parameter(
            torch.empty(context_length, width))
        self.transformer = nn.Module()
        self.transformer.resblocks = nn.ModuleList(
            TextBlock(width, heads, dtype) for _ in range(layers))
        self.ln_final = nn.LayerNorm(width, eps=1e-5)
        self.text_projection = nn.Parameter(torch.empty(width, embed_dim))
        nn.init.normal_(self.token_embedding.weight, std=0.02)
        nn.init.normal_(self.positional_embedding, std=0.01)
        nn.init.normal_(self.text_projection, std=0.02)

    def forward(self, tokens):
        tokens = tokens.long()
        x = self.token_embedding.weight[tokens] + self.positional_embedding[
            None, :tokens.shape[1]]
        x = x.to(self.dtype)
        for blk in self.transformer.resblocks:
            x = blk(x)
        x = ln_f32(self.ln_final, x)
        eot = torch.argmax(tokens, dim=-1)
        x = x[torch.arange(x.shape[0], device=x.device), eot]
        return x @ self.text_projection
