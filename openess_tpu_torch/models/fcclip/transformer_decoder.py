"""The mask2former-style transformer decoder of FC-CLIP, the counterpart of
``openess_tpu/models/fcclip/transformer_decoder.py``.

Reference: ``fc-clip/fcclip/modeling/transformer_decoder/
fcclip_transformer_decoder.py:57-519``: MaskPooling (:57-82),
get_classification_logits (:38-54) and the MultiScaleMaskedTransformerDecoder
(:275-519), 9 (cross-attention -> self-attention -> FFN) layers over 250
learned queries cycling through the pixel decoder's 3 scales, the
cross-attention masked by the previous layer's masks.

As in the JAX module: the attention logits, softmax and mask products are
f32; a row that every key blocks gives NaN weights, set to 0 as
``jnp.nan_to_num`` does (the decoder un-blocks such queries first, so it
does not happen on the path); resizes are torch's bilinear
(``ops/resize.resize_bilinear``). Parameter names are the reference's.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from openess_tpu_torch.models.fcclip.backbone import ln_f32
from openess_tpu_torch.models.fcclip.manifest import N_LEVELS
from openess_tpu_torch.models.fcclip.pixel_decoder import (
    position_embedding_sine,
)
from openess_tpu_torch.models.maskclip import CastLinear
from openess_tpu_torch.ops.resize import resize_bilinear


def get_classification_logits(x, text_classifier, logit_scale,
                              num_templates):
    """fcclip_transformer_decoder.py:38-54. ``x [B, *, C]``;
    ``text_classifier [R, C]``, the synonym-templated class rows and a last
    void row; ``num_templates`` the group size of each output class.
    Returns ``[B, *, num_classes + 1]`` (the last column void)."""
    x = x * torch.rsqrt(x.square().sum(-1, keepdim=True) + 1e-24)
    tc = text_classifier * torch.rsqrt(
        text_classifier.square().sum(-1, keepdim=True) + 1e-24)
    scale = torch.clamp(torch.exp(logit_scale), max=100.0)
    logits = scale * (x @ tc.T)  # [B, *, R]
    groups, cur = [], 0
    for n in num_templates:
        groups.append(logits[..., cur:cur + n].amax(dim=-1))
        cur += n
    groups.append(logits[..., -1])  # void
    return torch.stack(groups, dim=-1)


def mask_pooling(x, mask):
    """MaskPooling (fcclip_transformer_decoder.py:57-82): mean pooling over
    the positive pixels of each mask. ``x [B, H, W, C]`` NHWC; ``mask [B,
    Q, h, w]`` logits, resized to x's size when they differ. Returns ``[B,
    Q, C]`` f32."""
    H, W = x.shape[1], x.shape[2]
    if tuple(mask.shape[-2:]) != (H, W):
        mask = resize_bilinear(mask.permute(0, 2, 3, 1), out_h=H, out_w=W,
                               align_corners=False).permute(0, 3, 1, 2)
    mask = (mask > 0).float()
    denorm = mask.sum(dim=(-1, -2), keepdim=True) + 1e-8
    return torch.einsum("bhwc,bqhw->bqc", x.float(), mask / denorm)


class TorchMultiheadAttention(nn.Module):
    """``nn.MultiheadAttention``'s layout (one ``in_proj_weight [3C, C]``
    over [q; k; v], ``in_proj_bias``, ``out_proj``), each stream through its
    own slice; ``attn_mask [B, H, Q, L]`` bool, True where blocked."""

    def __init__(self, d_model: int, n_heads: int):
        super().__init__()
        self.n_heads = n_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d_model, d_model))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * d_model))
        self.out_proj = CastLinear(d_model, d_model)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, q, k, v, attn_mask=None):
        C, H = q.shape[-1], self.n_heads
        w = self.in_proj_weight.to(q.dtype)
        b = self.in_proj_bias.to(q.dtype)
        qh = F.linear(q, w[:C], b[:C])
        kh = F.linear(k, w[C:2 * C], b[C:2 * C])
        vh = F.linear(v, w[2 * C:], b[2 * C:])

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], H, C // H).transpose(1, 2)

        logits = (split(qh) * (1.0 / math.sqrt(C // H))).float() @ split(
            kh).float().transpose(-1, -2)
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, -torch.inf)
        attn = torch.nan_to_num(torch.softmax(logits, dim=-1)).to(vh.dtype)
        out = (attn @ split(vh)).transpose(1, 2).reshape(q.shape[0],
                                                         q.shape[1], C)
        return self.out_proj(out)


class MLP(nn.Module):
    """The 3-layer ReLU MLP (fcclip_transformer_decoder.py:259-271)."""

    def __init__(self, hidden_dim: int, output_dim: int):
        super().__init__()
        self.layers = nn.ModuleList([CastLinear(hidden_dim, hidden_dim),
                                     CastLinear(hidden_dim, hidden_dim),
                                     CastLinear(hidden_dim, output_dim)])

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class _AttentionLayer(nn.Module):
    """One cross- or self-attention layer's weights: the attention under
    ``name`` and its LayerNorm ``norm``."""

    def __init__(self, name: str, d_model: int, n_heads: int):
        super().__init__()
        self.name = name
        self.add_module(name, TorchMultiheadAttention(d_model, n_heads))
        self.norm = nn.LayerNorm(d_model, eps=1e-5)

    def attn(self, *args, **kwargs):
        return getattr(self, self.name)(*args, **kwargs)


class _FFNLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int):
        super().__init__()
        self.linear1 = CastLinear(d_model, dim_feedforward)
        self.linear2 = CastLinear(dim_feedforward, d_model)
        self.norm = nn.LayerNorm(d_model, eps=1e-5)


class FCCLIPTransformerDecoder(nn.Module):
    """The MultiScaleMaskedTransformerDecoder's inference path.
    ``forward(x [os32, os16, os8] NHWC, mask_features [B, h4, w4, C] NHWC,
    text_classifier [R, E], num_templates)`` -> ``{"pred_logits": [B, Q,
    K+1] f32, "pred_masks": [B, Q, h4, w4] f32}``."""

    def __init__(self, hidden_dim=256, num_queries=250, n_heads=8,
                 dim_feedforward=2048, dec_layers=9, mask_dim=256,
                 clip_embedding_dim=768, dtype=torch.float32):
        super().__init__()
        C = hidden_dim
        self.dtype = dtype
        self.n_heads = n_heads
        self.num_queries = num_queries
        self.level_embed = nn.Embedding(N_LEVELS, C)
        self.query_feat = nn.Embedding(num_queries, C)
        self.query_embed = nn.Embedding(num_queries, C)
        self.decoder_norm = nn.LayerNorm(C, eps=1e-5)
        self.mask_embed = MLP(C, mask_dim)
        self.class_embed = MLP(C, clip_embedding_dim)
        self._mask_pooling_proj = nn.Sequential(nn.LayerNorm(C, eps=1e-5),
                                                CastLinear(C, C))
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1.0 / 0.07)))
        self.transformer_cross_attention_layers = nn.ModuleList(
            _AttentionLayer("multihead_attn", C, n_heads)
            for _ in range(dec_layers))
        self.transformer_self_attention_layers = nn.ModuleList(
            _AttentionLayer("self_attn", C, n_heads) for _ in range(dec_layers))
        self.transformer_ffn_layers = nn.ModuleList(
            _FFNLayer(C, dim_feedforward) for _ in range(dec_layers))

    def mask_head(self, output, mask_features, target_size=None):
        """(decoder:485-510), the mask half -> (the normed queries ``[B, Q,
        C]`` f32, mask logits, and, given ``target_size``, the next layer's
        attention mask ``[B, Q, th*tw]``, True where blocked)."""
        B = output.shape[0]
        dec = ln_f32(self.decoder_norm, output)  # [B, Q, C] f32
        me = self.mask_embed(dec.to(self.dtype))
        outputs_mask = torch.einsum("bqc,bhwc->bqhw", me.float(),
                                    mask_features.float())
        if target_size is None:
            return dec, outputs_mask, None
        th, tw = target_size
        am = resize_bilinear(outputs_mask.permute(0, 2, 3, 1), out_h=th,
                             out_w=tw, align_corners=False)
        am = am.permute(0, 3, 1, 2).reshape(B, self.num_queries, th * tw)
        return dec, outputs_mask, torch.sigmoid(am) < 0.5

    def class_head(self, dec, outputs_mask, mask_features, text_classifier,
                   num_templates):
        """(decoder:485-510), the class half -> class logits ``[B, Q, K+1]``
        f32. Only the last layer's are returned, so the decoder runs it
        once, after the last layer (the JAX module, under ``jit``, drops
        the earlier layers' as dead code)."""
        pooled = mask_pooling(mask_features, outputs_mask)
        norm, dense = self._mask_pooling_proj
        pooled = dense(ln_f32(norm, pooled).to(self.dtype))
        ce = self.class_embed((pooled + dec).to(self.dtype))
        return get_classification_logits(
            ce.float(), text_classifier.float(), self.logit_scale,
            num_templates)

    def forward(self, x: Sequence[torch.Tensor], mask_features,
                text_classifier, num_templates):
        if len(x) != N_LEVELS:
            raise ValueError(f"{len(x)} feature levels, "
                             f"{N_LEVELS} expected")
        C = self.query_feat.weight.shape[1]
        B, Q = x[0].shape[0], self.num_queries
        srcs, poss, sizes = [], [], []
        for i in range(N_LEVELS):
            h, w = x[i].shape[1], x[i].shape[2]
            sizes.append((h, w))
            # input_proj is the identity (in_channels == hidden_dim)
            srcs.append((x[i].reshape(B, h * w, C)
                         + self.level_embed.weight[i][None, None]).to(
                             self.dtype))
            pos = position_embedding_sine(h, w, C // 2, device=x[i].device)
            poss.append(pos.reshape(1, h * w, C).expand(B, h * w, C).to(
                self.dtype))

        output = self.query_feat.weight[None].expand(B, Q, C).to(self.dtype)
        qe = self.query_embed.weight[None].expand(B, Q, C).to(self.dtype)

        dec, outputs_mask, attn_mask = self.mask_head(output, mask_features,
                                                      sizes[0])
        n_layers = len(self.transformer_ffn_layers)
        for i in range(n_layers):
            li = i % N_LEVELS
            # un-block a query whose mask blocks every key (decoder:450)
            all_blocked = attn_mask.all(dim=-1, keepdim=True)
            am = attn_mask & ~all_blocked
            am = am[:, None].expand(B, self.n_heads, Q, am.shape[-1])

            # cross-attention first (decoder:452-457)
            ca = self.transformer_cross_attention_layers[i]
            output = output + ca.attn(output + qe, srcs[li] + poss[li],
                                      srcs[li], attn_mask=am)
            output = ln_f32(ca.norm, output).to(self.dtype)

            sa = self.transformer_self_attention_layers[i]
            output = output + sa.attn(output + qe, output + qe, output)
            output = ln_f32(sa.norm, output).to(self.dtype)

            ffn = self.transformer_ffn_layers[i]  # ReLU, dropout 0
            output = output + ffn.linear2(F.relu(ffn.linear1(output)))
            output = ln_f32(ffn.norm, output).to(self.dtype)

            last = i == n_layers - 1
            dec, outputs_mask, attn_mask = self.mask_head(
                output, mask_features,
                None if last else sizes[(i + 1) % N_LEVELS])

        outputs_class = self.class_head(dec, outputs_mask, mask_features,
                                        text_classifier, num_templates)
        return {"pred_logits": outputs_class, "pred_masks": outputs_mask}
