"""FC-CLIP's weights into the port: the released checkpoint, and flax
parameter trees carried across.

The port's modules keep the released state dict's names
(``models/fcclip/meta.FCCLIP`` for the image path, ``backbone.CLIPTextEncoder``
for the text tower), so a released ``model`` dict that passes
``manifest.validate_state_dict`` loads with ``load_state_dict(strict=True)``
once ``criterion.empty_weight`` (training only) is dropped: the rule
``models/convert.py`` follows for E2VID, the ResNets and MaskCLIP. The
architecture is read off the weights (:func:`fcclip_arch`,
:func:`text_arch`), so a narrower model needs no flags.

:func:`fcclip_state_dict_from_jax` is the inverse of the JAX package's
``convert_state_dict``: flax trees (numpy arrays) -> the released layout
(HWIO -> OIHW, a depthwise ``[kh, kw, 1, C]`` -> ``[C, 1, kh, kw]``,
``[in, out]`` -> ``[out, in]``, ``scale`` -> ``weight``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from openess_tpu_torch.models.fcclip.backbone import (
    CLIP_HEAD_WIDTH,
    CLIPTextEncoder,
)
from openess_tpu_torch.models.fcclip.manifest import (
    IGNORED_KEYS,
    N_LEVELS,
    N_POINTS,
    validate_state_dict,
)
from openess_tpu_torch.models.fcclip.meta import FCCLIP

CLIP = "backbone.clip_model."
TRUNK = CLIP + "visual.trunk."
PIXEL = "sem_seg_head.pixel_decoder."
PRED = "sem_seg_head.predictor."


def _is_text(key: str) -> bool:
    return (key.startswith(CLIP) and not key.startswith(CLIP + "visual.")
            and key != CLIP + "logit_scale")


def fcclip_state_dicts_from_released(sd: dict) -> Tuple[dict, dict]:
    """A released ``model`` dict -> ``(image, text)`` state dicts in f32:
    the :class:`FCCLIP` keys as they are, the text tower's without the
    ``backbone.clip_model.`` prefix; ``criterion.empty_weight`` dropped."""
    image, text = {}, {}
    for k, v in sd.items():
        if k in IGNORED_KEYS:
            continue
        v = v.detach().to("cpu", torch.float32).contiguous()
        if _is_text(k):
            text[k[len(CLIP):]] = v
        else:
            image[k] = v
    return image, text


def _count(sd: dict, fmt: str) -> int:
    n = 0
    while fmt.format(n) in sd:
        n += 1
    return n


def fcclip_arch(sd: dict) -> dict:
    """The :class:`FCCLIP` arguments that fit its ``state_dict`` ``sd``:
    the trunk's depths and dims, the embedding, the decoders' widths,
    layers and queries, read off the tensors (3 levels and 4 points a head,
    as the JAX modules have them)."""
    n_stages = _count(sd, TRUNK + "stages.{}.blocks.0.gamma")
    dims = [sd[TRUNK + "stem.0.weight"].shape[0]] + [
        sd[f"{TRUNK}stages.{i}.downsample.1.weight"].shape[0]
        for i in range(1, n_stages)]
    depths = [_count(sd, f"{TRUNK}stages.{i}.blocks.{{}}.gamma")
              for i in range(n_stages)]
    enc = PIXEL + "transformer.encoder.layers.{}."
    return {
        "trunk_depths": tuple(depths), "trunk_dims": tuple(dims),
        "clip_embed_dim": sd[CLIP + "visual.head.mlp.fc2.weight"].shape[0],
        "conv_dim": sd[PIXEL + "input_proj.0.0.weight"].shape[0],
        "mask_dim": sd[PIXEL + "mask_features.weight"].shape[0],
        "num_queries": sd[PRED + "query_feat.weight"].shape[0],
        "dec_layers": _count(sd, PRED + "transformer_ffn_layers.{}.norm.weight"),
        "enc_layers": _count(sd, enc + "norm1.weight"),
        "n_heads": sd[enc.format(0) + "self_attn.attention_weights.weight"]
        .shape[0] // (N_LEVELS * N_POINTS),
        "enc_ff": sd[enc.format(0) + "linear1.weight"].shape[0],
        "dec_ff": sd[PRED + "transformer_ffn_layers.0.linear1.weight"].shape[0],
    }


def text_arch(sd: dict) -> dict:
    """The :class:`CLIPTextEncoder` arguments that fit its ``state_dict``:
    CLIP's heads of 64 channels."""
    vocab, width = sd["token_embedding.weight"].shape
    return {"vocab_size": vocab,
            "context_length": sd["positional_embedding"].shape[0],
            "width": width, "heads": max(1, width // CLIP_HEAD_WIDTH),
            "layers": _count(sd, "transformer.resblocks.{}.ln_1.weight"),
            "embed_dim": sd["text_projection"].shape[1]}


def convert_fcclip_checkpoint(path: str) -> Tuple[dict, dict]:
    """A released checkpoint file (``{"model": ...}`` or the bare dict) ->
    the ``(image, text)`` state dicts of :func:`fcclip_state_dicts_from_released`,
    the file first held to the released manifest, so that a wrong download
    fails with its keys named."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model", ckpt)
    validate_state_dict(sd)
    return fcclip_state_dicts_from_released(sd)


def build_fcclip(image_sd: dict, text_sd: dict, device,
                 dtype=torch.bfloat16) -> Tuple[FCCLIP, CLIPTextEncoder]:
    """The two state dicts -> ``(FCCLIP, CLIPTextEncoder)`` of the
    architecture they hold, loaded strictly, on ``device`` in eval mode,
    computing in ``dtype`` (built on the meta device: no weights drawn)."""
    with torch.device("meta"):
        model = FCCLIP(dtype=dtype, **fcclip_arch(image_sd))
        text = CLIPTextEncoder(dtype=dtype, **text_arch(text_sd))
    model.load_state_dict(image_sd, strict=True, assign=True)
    text.load_state_dict(text_sd, strict=True, assign=True)
    return model.to(device).eval(), text.to(device).eval()


def load_fcclip(path: str, device, dtype=torch.bfloat16
                ) -> Tuple[FCCLIP, CLIPTextEncoder]:
    """A released checkpoint file -> ``(FCCLIP, CLIPTextEncoder)`` on
    ``device`` (:func:`convert_fcclip_checkpoint`, :func:`build_fcclip`)."""
    return build_fcclip(*convert_fcclip_checkpoint(path), device, dtype)


# ---------------------------------------------------------------------------
# flax trees -> the released layout
# ---------------------------------------------------------------------------


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


class _Out(dict):
    """A state dict being filled from flax leaves."""

    def conv(self, name, p):
        self[name + ".weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in p:
            self[name + ".bias"] = _t(p["bias"])

    def dense(self, name, p):
        self[name + ".weight"] = _t(np.asarray(p["kernel"]).T)
        self[name + ".bias"] = _t(p["bias"])

    def norm(self, name, p):
        self[name + ".weight"] = _t(p["scale"])
        self[name + ".bias"] = _t(p["bias"])

    def mha(self, name, p):
        self[name + ".in_proj_weight"] = _t(np.asarray(p["in_proj_kernel"]).T)
        self[name + ".in_proj_bias"] = _t(p["in_proj_bias"])
        self.dense(name + ".out_proj", p["out_proj"])


def _numbered(tree: dict, fmt: str):
    i = 0
    while fmt.format(i) in tree:
        yield i, tree[fmt.format(i)]
        i += 1


def trunk_state_dict_from_jax(p: dict) -> dict:
    """``ConvNeXtCLIPVisual`` flax params -> the port's trunk keys."""
    sd = _Out()
    sd.conv("stem.0", p["stem_conv"])
    sd.norm("stem.1", p["stem_norm"])
    for i, st in _numbered(p, "stage_{}"):
        if "downsample_norm" in st:
            sd.norm(f"stages.{i}.downsample.0", st["downsample_norm"])
            sd.conv(f"stages.{i}.downsample.1", st["downsample_conv"])
        for j, b in _numbered(st, "block_{}"):
            bp = f"stages.{i}.blocks.{j}."
            sd.conv(bp + "conv_dw", b["conv_dw"])
            sd.norm(bp + "norm", b["norm"])
            sd.dense(bp + "mlp.fc1", b["mlp_fc1"])
            sd.dense(bp + "mlp.fc2", b["mlp_fc2"])
            sd[bp + "gamma"] = _t(b["gamma"])
    return dict(sd)


def projection_state_dict_from_jax(p: dict) -> dict:
    """``CLIPVisualProjection`` flax params -> the port's keys."""
    sd = _Out()
    sd.norm("norm", p["trunk_head_norm"])
    sd.dense("mlp.fc1", p["head_fc1"])
    sd.dense("mlp.fc2", p["head_fc2"])
    return dict(sd)


def text_state_dict_from_jax(p: dict) -> dict:
    """``CLIPTextEncoder`` flax params -> the port's keys (open_clip's)."""
    sd = _Out()
    sd["token_embedding.weight"] = _t(p["token_embedding"])
    sd["positional_embedding"] = _t(p["positional_embedding"])
    sd["text_projection"] = _t(p["text_projection"])
    sd.norm("ln_final", p["ln_final"])
    for i, b in _numbered(p, "block_{}"):
        bp = f"transformer.resblocks.{i}."
        sd.norm(bp + "ln_1", b["ln_1"])
        sd.norm(bp + "ln_2", b["ln_2"])
        sd[bp + "attn.in_proj_weight"] = _t(
            np.asarray(b["attn"]["in_proj"]["kernel"]).T)
        sd[bp + "attn.in_proj_bias"] = _t(b["attn"]["in_proj"]["bias"])
        sd.dense(bp + "attn.out_proj", b["attn"]["out_proj"])
        sd.dense(bp + "mlp.c_fc", b["mlp_fc1"])
        sd.dense(bp + "mlp.c_proj", b["mlp_fc2"])
    return dict(sd)


def pixel_decoder_state_dict_from_jax(p: dict) -> dict:
    """``MSDeformAttnPixelDecoder`` flax params -> the port's keys."""
    sd = _Out()
    for i, proj in _numbered(p, "input_proj_{}"):
        sd.conv(f"input_proj.{i}.0", proj)
        sd.norm(f"input_proj.{i}.1", p[f"input_proj_{i}_gn"])
    sd["transformer.level_embed"] = _t(p["level_embed"])
    for i, e in _numbered(p, "encoder_layer_{}"):
        bp = f"transformer.encoder.layers.{i}."
        for name in ("sampling_offsets", "attention_weights", "value_proj",
                     "output_proj"):
            sd.dense(bp + "self_attn." + name, e["self_attn"][name])
        sd.norm(bp + "norm1", e["norm1"])
        sd.dense(bp + "linear1", e["linear1"])
        sd.dense(bp + "linear2", e["linear2"])
        sd.norm(bp + "norm2", e["norm2"])
    for name in ("adapter_1", "layer_1"):
        sd.conv(name, p[name])
        sd.norm(name + ".norm", p[name + "_gn"])
    sd.conv("mask_features", p["mask_features"])
    return dict(sd)


def decoder_state_dict_from_jax(p: dict) -> dict:
    """``FCCLIPTransformerDecoder`` flax params -> the port's keys."""
    sd = _Out()
    for name in ("level_embed", "query_feat", "query_embed"):
        sd[name + ".weight"] = _t(p[name])
    sd.norm("decoder_norm", p["decoder_norm"])
    for mlp in ("mask_embed", "class_embed"):
        for k, layer in _numbered(p[mlp], "layer_{}"):
            sd.dense(f"{mlp}.layers.{k}", layer)
    sd.norm("_mask_pooling_proj.0", p["mask_pooling_proj_norm"])
    sd.dense("_mask_pooling_proj.1", p["mask_pooling_proj_dense"])
    sd["logit_scale"] = _t(p["logit_scale"])
    for i, _ in _numbered(p, "ffn_linear1_{}"):
        ca = f"transformer_cross_attention_layers.{i}."
        sa = f"transformer_self_attention_layers.{i}."
        ffn = f"transformer_ffn_layers.{i}."
        sd.mha(ca + "multihead_attn", p[f"cross_attn_{i}"])
        sd.norm(ca + "norm", p[f"cross_norm_{i}"])
        sd.mha(sa + "self_attn", p[f"self_attn_{i}"])
        sd.norm(sa + "norm", p[f"self_norm_{i}"])
        sd.dense(ffn + "linear1", p[f"ffn_linear1_{i}"])
        sd.dense(ffn + "linear2", p[f"ffn_linear2_{i}"])
        sd.norm(ffn + "norm", p[f"ffn_norm_{i}"])
    return dict(sd)


def fcclip_state_dict_from_jax(params: dict, text_params: dict
                               ) -> Dict[str, torch.Tensor]:
    """The JAX package's ``(FCCLIP params, CLIPTextEncoder params)`` ->
    the released ``model`` dict (every inference key of the manifest; no
    ``criterion.empty_weight``), f32 tensors."""
    sd: Dict[str, torch.Tensor] = {}

    def put(prefix, part):
        sd.update({prefix + k: v for k, v in part.items()})

    put(TRUNK, trunk_state_dict_from_jax(params["visual"]))
    proj = projection_state_dict_from_jax(params["visual_proj"])
    put(TRUNK + "head.", {k: v for k, v in proj.items()
                          if k.startswith("norm.")})
    put(CLIP + "visual.head.", {k: v for k, v in proj.items()
                                if k.startswith("mlp.")})
    sd[CLIP + "logit_scale"] = _t(params["clip_logit_scale"])
    put(CLIP, text_state_dict_from_jax(text_params))
    put(PIXEL, pixel_decoder_state_dict_from_jax(params["pixel_decoder"]))
    put(PRED, decoder_state_dict_from_jax(params["decoder"]))
    sd["void_embedding.weight"] = _t(params["void_embedding"])
    return sd
