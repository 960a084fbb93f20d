"""The key and shape manifest of the released ``fcclip_cocopan.pth``,
the port's own copy of ``openess_tpu/models/fcclip/manifest.py`` (pure
Python; the port imports nothing of the JAX package).

The released FC-CLIP COCO-panoptic checkpoint is a detectron2 training
checkpoint whose ``model`` dict holds the open_clip CLIP-ConvNeXt-L
backbone (``backbone.clip_model.*``), the MSDeformAttn pixel decoder
(``sem_seg_head.pixel_decoder.*``), the mask2former-style transformer
decoder (``sem_seg_head.predictor.*``), ``void_embedding.weight`` and one
training-only buffer (``criterion.empty_weight``): 847 tensors.

:func:`released_manifest` rebuilds that dict's key names and shapes from
the architecture constants of the reference sources:

- open_clip ``convnext_large_d_320``: trunk depths (3, 3, 27, 3), dims
  (192, 384, 768, 1536), an MLP visual head to embed 768; text tower
  width 768, 12 heads, 16 layers, vocab 49408, context 77
  (``fc-clip/fcclip/modeling/backbone/clip.py:27-237``);
- the pixel decoder: conv_dim 256, mask_dim 256, 6 encoder layers, ff
  1024, 8 heads, 4 points, 3 levels, input projections built res5 -> res3
  (``modeling/pixel_decoder/msdeformattn.py:61-266``);
- the transformer decoder: hidden 256, 250 queries, 9 layers, ff 2048,
  the class_embed MLP to the 768-d CLIP space, ``_mask_pooling_proj``
  LayerNorm(256) + Linear(256, 256)
  (``modeling/transformer_decoder/fcclip_transformer_decoder.py:285-385``);
- the criterion's buffer of COCO's 133 + 1 classes
  (``modeling/criterion.py:119``).

The port's modules keep these names (``models/fcclip/convert.py``), and
``python -m openess_tpu_torch.preflight --fcclip`` checks a downloaded file
against this manifest.
"""
from __future__ import annotations

from typing import Dict, Tuple

Shape = Tuple[int, ...]

# released convnext_large_d_320 + fcclip COCO-panoptic hyperparameters
DEPTHS = (3, 3, 27, 3)
DIMS = (192, 384, 768, 1536)
EMBED_DIM = 768
TEXT_WIDTH, TEXT_HEADS, TEXT_LAYERS = 768, 12, 16
VOCAB, CONTEXT = 49408, 77
CONV_DIM = MASK_DIM = 256
ENC_LAYERS, ENC_FF = 6, 1024
DEC_LAYERS, DEC_FF = 9, 2048
N_HEADS, N_POINTS, N_LEVELS = 8, 4, 3
NUM_QUERIES = 250
COCO_CLASSES = 133

# keys of the released file that no module of the inference path holds
# (training only)
IGNORED_KEYS = ("criterion.empty_weight",)


def _linear(m, name, out, inp):
    m[name + ".weight"] = (out, inp)
    m[name + ".bias"] = (out,)


def _norm(m, name, dim):
    m[name + ".weight"] = (dim,)
    m[name + ".bias"] = (dim,)


def _mha(m, name, dim):
    m[name + ".in_proj_weight"] = (3 * dim, dim)
    m[name + ".in_proj_bias"] = (3 * dim,)
    _linear(m, name + ".out_proj", dim, dim)


def released_manifest(
    *,
    depths=DEPTHS,
    dims=DIMS,
    embed_dim=EMBED_DIM,
    text_width=TEXT_WIDTH,
    text_layers=TEXT_LAYERS,
    vocab=VOCAB,
    context=CONTEXT,
    conv_dim=CONV_DIM,
    mask_dim=MASK_DIM,
    enc_layers=ENC_LAYERS,
    enc_ff=ENC_FF,
    dec_layers=DEC_LAYERS,
    dec_ff=DEC_FF,
    n_heads=N_HEADS,
    n_points=N_POINTS,
    n_levels=N_LEVELS,
    num_queries=NUM_QUERIES,
    num_classes=COCO_CLASSES,
    include_ignored=True,
) -> Dict[str, Shape]:
    """{state-dict key: shape} of the released checkpoint's ``model`` dict."""
    m: Dict[str, Shape] = {}

    # ---- backbone.clip_model.visual.trunk (timm ConvNeXt) ----
    t = "backbone.clip_model.visual.trunk."
    m[t + "stem.0.weight"] = (dims[0], 3, 4, 4)
    m[t + "stem.0.bias"] = (dims[0],)
    _norm(m, t + "stem.1", dims[0])
    for i, depth in enumerate(depths):
        if i > 0:
            _norm(m, f"{t}stages.{i}.downsample.0", dims[i - 1])
            m[f"{t}stages.{i}.downsample.1.weight"] = (
                dims[i], dims[i - 1], 2, 2,
            )
            m[f"{t}stages.{i}.downsample.1.bias"] = (dims[i],)
        for j in range(depth):
            bp, d = f"{t}stages.{i}.blocks.{j}.", dims[i]
            m[bp + "conv_dw.weight"] = (d, 1, 7, 7)
            m[bp + "conv_dw.bias"] = (d,)
            _norm(m, bp + "norm", d)
            _linear(m, bp + "mlp.fc1", 4 * d, d)
            _linear(m, bp + "mlp.fc2", d, 4 * d)
            m[bp + "gamma"] = (d,)
    _norm(m, t + "head.norm", dims[-1])

    # ---- backbone.clip_model.visual.head (open_clip timm mlp proj) ----
    _linear(m, "backbone.clip_model.visual.head.mlp.fc1",
            2 * embed_dim, dims[-1])
    _linear(m, "backbone.clip_model.visual.head.mlp.fc2",
            embed_dim, 2 * embed_dim)

    # ---- backbone.clip_model text tower ----
    c = "backbone.clip_model."
    m[c + "token_embedding.weight"] = (vocab, text_width)
    m[c + "positional_embedding"] = (context, text_width)
    m[c + "text_projection"] = (text_width, embed_dim)
    _norm(m, c + "ln_final", text_width)
    m[c + "logit_scale"] = ()
    for i in range(text_layers):
        bp = f"{c}transformer.resblocks.{i}."
        _norm(m, bp + "ln_1", text_width)
        _norm(m, bp + "ln_2", text_width)
        _mha(m, bp + "attn", text_width)
        _linear(m, bp + "mlp.c_fc", 4 * text_width, text_width)
        _linear(m, bp + "mlp.c_proj", text_width, 4 * text_width)

    # ---- sem_seg_head.pixel_decoder (MSDeformAttn encoder) ----
    pd = "sem_seg_head.pixel_decoder."
    # input projections are built res5 -> res3 (msdeformattn.py:249-256)
    for i, inch in enumerate(dims[:0:-1][:n_levels]):
        m[f"{pd}input_proj.{i}.0.weight"] = (conv_dim, inch, 1, 1)
        m[f"{pd}input_proj.{i}.0.bias"] = (conv_dim,)
        _norm(m, f"{pd}input_proj.{i}.1", conv_dim)
    m[pd + "transformer.level_embed"] = (n_levels, conv_dim)
    for i in range(enc_layers):
        bp = f"{pd}transformer.encoder.layers.{i}."
        _linear(m, bp + "self_attn.sampling_offsets",
                n_heads * n_levels * n_points * 2, conv_dim)
        _linear(m, bp + "self_attn.attention_weights",
                n_heads * n_levels * n_points, conv_dim)
        _linear(m, bp + "self_attn.value_proj", conv_dim, conv_dim)
        _linear(m, bp + "self_attn.output_proj", conv_dim, conv_dim)
        _norm(m, bp + "norm1", conv_dim)
        _linear(m, bp + "linear1", enc_ff, conv_dim)
        _linear(m, bp + "linear2", conv_dim, enc_ff)
        _norm(m, bp + "norm2", conv_dim)
    # FPN lateral/output convs (detectron2 Conv2d with norm => bias-free)
    m[pd + "adapter_1.weight"] = (conv_dim, dims[0], 1, 1)
    _norm(m, pd + "adapter_1.norm", conv_dim)
    m[pd + "layer_1.weight"] = (conv_dim, conv_dim, 3, 3)
    _norm(m, pd + "layer_1.norm", conv_dim)
    # fc-clip overrides mask2former's 3x3 with 1x1 (msdeformattn.py:279-286)
    m[pd + "mask_features.weight"] = (mask_dim, conv_dim, 1, 1)
    m[pd + "mask_features.bias"] = (mask_dim,)

    # ---- sem_seg_head.predictor (transformer decoder) ----
    pr = "sem_seg_head.predictor."
    m[pr + "query_feat.weight"] = (num_queries, conv_dim)
    m[pr + "query_embed.weight"] = (num_queries, conv_dim)
    m[pr + "level_embed.weight"] = (n_levels, conv_dim)
    _norm(m, pr + "decoder_norm", conv_dim)
    for k in range(3):
        _linear(m, f"{pr}mask_embed.layers.{k}",
                mask_dim if k == 2 else conv_dim, conv_dim)
        _linear(m, f"{pr}class_embed.layers.{k}",
                embed_dim if k == 2 else conv_dim, conv_dim)
    _norm(m, pr + "_mask_pooling_proj.0", conv_dim)
    _linear(m, pr + "_mask_pooling_proj.1", conv_dim, conv_dim)
    m[pr + "logit_scale"] = ()
    for i in range(dec_layers):
        _mha(m, f"{pr}transformer_cross_attention_layers.{i}.multihead_attn",
             conv_dim)
        _norm(m, f"{pr}transformer_cross_attention_layers.{i}.norm", conv_dim)
        _mha(m, f"{pr}transformer_self_attention_layers.{i}.self_attn",
             conv_dim)
        _norm(m, f"{pr}transformer_self_attention_layers.{i}.norm", conv_dim)
        _linear(m, f"{pr}transformer_ffn_layers.{i}.linear1", dec_ff, conv_dim)
        _linear(m, f"{pr}transformer_ffn_layers.{i}.linear2", conv_dim, dec_ff)
        _norm(m, f"{pr}transformer_ffn_layers.{i}.norm", conv_dim)

    # ---- meta-arch extras ----
    m["void_embedding.weight"] = (1, embed_dim)
    if include_ignored:
        m["criterion.empty_weight"] = (num_classes + 1,)
    return m


def validate_state_dict(sd, *, strict_extra: bool = True) -> None:
    """Raise ``ValueError`` naming the missing, unexpected and mis-shaped
    keys if ``sd`` (a torch ``model`` state dict) does not match
    :func:`released_manifest`: run before a file is loaded, so that a wrong
    download fails with its keys named."""
    man = released_manifest()
    missing = sorted(k for k in man if k not in sd)
    extra = sorted(k for k in sd if k not in man)
    # .shape of a tensor or an array, no copy (bf16 has no numpy dtype)
    bad = sorted(
        f"{k}: got {tuple(sd[k].shape)} want {man[k]}"
        for k in man
        if k in sd and tuple(sd[k].shape) != man[k]
    )
    problems = []
    if missing:
        problems.append(f"missing {len(missing)} keys: {missing[:8]}...")
    if extra and strict_extra:
        problems.append(f"unexpected {len(extra)} keys: {extra[:8]}...")
    if bad:
        problems.append(f"shape mismatches: {bad[:8]}...")
    if problems:
        raise ValueError(
            "state dict does not match the released fcclip_cocopan manifest:\n"
            + "\n".join(problems)
        )
