"""FC-CLIP in the port (``openess_tpu_torch/models/fcclip/``,
``ops/ms_deform_attn.py``) against the JAX package's flax modules, on the
CPU at narrow widths: random weights drawn into each flax module's tree and
carried across by ``models/fcclip/convert.*_state_dict_from_jax``.

The sampling op is held at 1e-6 of its max in f32, each module at 1e-4 of
its output's max in f32 (``MODULE_REL_TOL``); the whole meta-architecture in
f32 and in bf16 (the bf16 bound is what was measured, with headroom); panoptic
and instance inference id for id; the port's manifest equals JAX's; a
full-width model built on the meta device holds exactly the manifest's 846
inference keys; a random released-layout file loads strictly and carries
the same weights bit for bit as the JAX converter's trees."""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import openess_tpu.models.fcclip as jf
from openess_tpu.models.fcclip import backbone as jbackbone
from openess_tpu.models.fcclip import convert as jconvert
from openess_tpu.models.fcclip import inference as jinference
from openess_tpu.models.fcclip import labeler as jlabeler
from openess_tpu.models.fcclip import manifest as jmanifest
from openess_tpu.models.fcclip import meta as jmeta
from openess_tpu.models.fcclip import pixel_decoder as jpixel
from openess_tpu.models.fcclip import transformer_decoder as jdecoder
from openess_tpu.ops.ms_deform_attn import ms_deform_attn as jms_deform_attn
from openess_tpu_torch.models import fcclip
from openess_tpu_torch.models.fcclip import convert, inference, manifest
from openess_tpu_torch.models.fcclip import labeler as plabeler
from openess_tpu_torch.models.fcclip import meta
from openess_tpu_torch.models.fcclip.backbone import (
    CLIPTextEncoder,
    CLIPVisualProjection,
    ConvNeXtCLIPVisual,
)
from openess_tpu_torch.models.fcclip.pixel_decoder import (
    MSDeformAttnPixelDecoder,
)
from openess_tpu_torch.models.fcclip.transformer_decoder import (
    FCCLIPTransformerDecoder,
    TorchMultiheadAttention,
    get_classification_logits,
    mask_pooling,
)
from openess_tpu_torch.ops.ms_deform_attn import ms_deform_attn
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

MSDA_REL_TOL = 1e-6    # f32, of max|out|
MODULE_REL_TOL = 1e-4  # f32, of max|out|
# The whole FC-CLIP in bf16 on both sides against each other, random
# weights: the per-pixel class scores within BF16_REL_TOL of their max
# (measured 8.56e-2: a bf16 rounding flips some of the mask thresholds that
# mask pooling and the attention masks take) and the argmax class equal on
# BF16_AGREE_MIN of the pixels (measured 0.9905, 117 of 12 288 pixels off).
BF16_REL_TOL = 0.1
BF16_AGREE_MIN = 0.985

# the narrow architecture every module test uses
DEPTHS, DIMS = (1, 2, 1, 1), (32, 32, 64, 64)
EMBED, CONV, QUERIES = 48, 64, 10
SMALL = dict(trunk_depths=DEPTHS, trunk_dims=DIMS, clip_embed_dim=EMBED,
             conv_dim=CONV, mask_dim=CONV, num_queries=QUERIES,
             dec_layers=3, enc_layers=2, n_heads=8)
# released_manifest's sizes of the same architecture (text: width 64, 2
# layers, a vocabulary that holds the test tokenizers' ids)
SMALL_MANIFEST = dict(depths=DEPTHS, dims=DIMS, embed_dim=EMBED,
                      text_width=64, text_layers=2, vocab=600, context=77,
                      conv_dim=CONV, mask_dim=CONV, enc_layers=2,
                      dec_layers=3, num_queries=QUERIES)


def draw_params(rng, variables):
    """Every leaf of a flax tree drawn anew: kernels at 1/sqrt(fan-in),
    LayerNorm/GroupNorm scales around 1, biases small, scalars (the logit
    scales) around 2.3, the rest (embeddings, gammas) at 0.5."""
    def draw(path, leaf):
        name = getattr(path[-1], "key", "")
        shape = leaf.shape
        if name == "scale":
            a = 1.0 + 0.1 * rng.normal(size=shape)
        elif name == "bias" or name == "in_proj_bias":
            a = 0.1 * rng.normal(size=shape)
        elif name in ("kernel", "in_proj_kernel"):
            a = rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
        elif leaf.ndim == 0:
            a = 2.3 + 0.1 * rng.normal(size=shape)
        else:
            a = 0.5 * rng.normal(size=shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def init_params(rng, module, *args):
    tree = jax.eval_shape(lambda: module.init(jax.random.key(0), *args))
    return draw_params(rng, tree["params"])


def rel_err(got, ref):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def highest(fn, *args, **kwargs):
    with jax.default_matmul_precision("highest"):
        return jax.tree_util.tree_map(np.asarray, fn(*args, **kwargs))


# ---------------------------------------------------------------------------
# the sampling op and the modules, f32
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spread", [0.0, 0.6], ids=["inside", "outside"])
def test_ms_deform_attn_matches_jax(spread):
    """Three levels, locations in [0, 1] or spread to [-0.6, 1.6] (out of
    range taps add zero), f32 within 1e-6 of max."""
    rng = np.random.default_rng(0)
    shapes = ((6, 8), (3, 4), (2, 2))
    B, H, D, P = 2, 4, 8, 3
    lin = sum(h * w for h, w in shapes)
    value = rng.normal(size=(B, lin, H, D)).astype(np.float32)
    loc = rng.uniform(-spread, 1 + spread,
                      size=(B, 11, H, 3, P, 2)).astype(np.float32)
    w = rng.uniform(size=(B, 11, H, 3, P)).astype(np.float32)
    ref = highest(jms_deform_attn, value, shapes, loc, w)
    got = ms_deform_attn(torch.from_numpy(value), shapes,
                         torch.from_numpy(loc), torch.from_numpy(w))
    assert rel_err(got, ref) <= MSDA_REL_TOL
    if spread:
        assert ((loc < 0) | (loc > 1)).mean() > 0.2
    # F.grid_sample computes the same taps (align_corners=False, zeros)
    v0 = torch.from_numpy(value[:, :48]).permute(0, 2, 3, 1).reshape(
        B * H, D, 6, 8)
    grid = torch.from_numpy(loc[:, :, :, 0]).permute(0, 2, 1, 3, 4).reshape(
        B * H, 11, P, 2) * 2 - 1
    gs = torch.nn.functional.grid_sample(v0, grid, mode="bilinear",
                                         padding_mode="zeros",
                                         align_corners=False)
    one = ms_deform_attn(torch.from_numpy(value[:, :48]), ((6, 8),),
                         torch.from_numpy(loc[:, :, :, :1]),
                         torch.ones(B, 11, H, 1, P))
    want = gs.sum(-1).reshape(B, H, D, 11).permute(0, 3, 1, 2).reshape(
        B, 11, H * D)
    torch.testing.assert_close(one, want, rtol=1e-5, atol=1e-5)


def test_convnext_trunk_matches_flax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    jm = jbackbone.ConvNeXtCLIPVisual(depths=DEPTHS, dims=DIMS)
    params = init_params(rng, jm, x)
    ref = highest(jax.jit(jm.apply), {"params": params}, x)
    ours = ConvNeXtCLIPVisual(DEPTHS, DIMS)
    ours.load_state_dict(convert.trunk_state_dict_from_jax(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(x))
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert rel_err(got[k], ref[k]) <= MODULE_REL_TOL, k


def test_visual_projection_matches_flax():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 7, 64)).astype(np.float32)
    jm = jbackbone.CLIPVisualProjection(trunk_dim=64, embed_dim=EMBED)
    params = init_params(rng, jm, x)
    ref = highest(jm.apply, {"params": params}, x)
    ours = CLIPVisualProjection(64, EMBED)
    ours.load_state_dict(convert.projection_state_dict_from_jax(params))
    with torch.no_grad():
        assert rel_err(ours(torch.from_numpy(x)), ref) <= MODULE_REL_TOL


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_text_encoder_matches_flax(dtype):
    """Width 128 (2 heads), 2 layers, prompts of several lengths (the eot
    at the argmax); bf16 within 2e-2 of max (measured 5e-3)."""
    rng = np.random.default_rng(3)
    tokens = np.zeros((4, 77), np.int32)
    for i, n in enumerate((3, 9, 20, 77)):
        tokens[i, :n] = rng.integers(1, 500, n)
        tokens[i, 0], tokens[i, n - 1] = 498, 599
    kw = dict(vocab_size=600, width=128, heads=2, layers=2, embed_dim=EMBED)
    jm = jbackbone.CLIPTextEncoder(**kw, dtype=getattr(jnp, dtype))
    params = init_params(rng, jbackbone.CLIPTextEncoder(**kw), tokens)
    ref = highest(jax.jit(jm.apply), {"params": params}, tokens)
    ours = CLIPTextEncoder(**kw, dtype=getattr(torch, dtype))
    ours.load_state_dict(convert.text_state_dict_from_jax(params))
    with torch.no_grad():
        got = ours(torch.from_numpy(tokens))
    tol = MODULE_REL_TOL if dtype == "float32" else 2e-2
    assert rel_err(got, ref) <= tol


def _features(rng, b, h, w):
    return {f"res{i + 2}": rng.normal(size=(b, h // s, w // s, c)).astype(
        np.float32) for i, (s, c) in enumerate(zip((4, 8, 16, 32), DIMS))}


def test_pixel_decoder_matches_flax():
    """Two encoder layers, random sampling offsets (so taps fall outside
    the maps too), the FPN step onto res2."""
    rng = np.random.default_rng(4)
    feats = _features(rng, 2, 64, 96)
    jm = jpixel.MSDeformAttnPixelDecoder(in_channels=DIMS, conv_dim=CONV,
                                         mask_dim=CONV, enc_layers=2)
    params = init_params(rng, jm, feats)
    ref_mask, ref_ms = highest(jax.jit(jm.apply), {"params": params}, feats)
    ours = MSDeformAttnPixelDecoder(in_channels=DIMS, conv_dim=CONV,
                                    mask_dim=CONV, enc_layers=2)
    ours.load_state_dict(convert.pixel_decoder_state_dict_from_jax(params))
    with torch.no_grad():
        got_mask, got_ms = ours({k: torch.from_numpy(v)
                                 for k, v in feats.items()})
    assert rel_err(got_mask, ref_mask) <= MODULE_REL_TOL
    assert len(got_ms) == len(ref_ms) == 3
    for a, b in zip(got_ms, ref_ms):
        assert rel_err(a, b) <= MODULE_REL_TOL


def test_multihead_attention_with_a_fully_blocked_row_matches_flax():
    """A query row that every key blocks: NaN weights zeroed on both
    sides, so that row is the out-projection's bias."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 5, 32)).astype(np.float32)
    k = rng.normal(size=(2, 7, 32)).astype(np.float32)
    mask = rng.uniform(size=(2, 4, 5, 7)) < 0.4
    mask[0, :, 2] = True
    jm = jdecoder.TorchMultiheadAttention(32, 4)
    params = init_params(rng, jm, q, k, k, mask)
    ref = highest(jm.apply, {"params": params}, q, k, k, mask)
    ours = TorchMultiheadAttention(32, 4)
    sd = convert._Out()
    sd.mha("m", params)
    ours.load_state_dict({kk[2:]: v for kk, v in sd.items()})
    with torch.no_grad():
        got = ours(*(torch.from_numpy(a) for a in (q, k, k, mask)))
    assert rel_err(got, ref) <= MODULE_REL_TOL
    torch.testing.assert_close(got[0, 2], ours.out_proj.bias.detach())


def _decoder_inputs(rng, b, h, w, positive=False):
    ms = [rng.normal(size=(b, h // s, w // s, CONV)).astype(np.float32)
          for s in (32, 16, 8)]
    mf = rng.normal(size=(b, h // 4, w // 4, CONV)).astype(np.float32)
    if positive:
        mf = np.abs(mf) + 0.1
    tc = rng.normal(size=(9, EMBED)).astype(np.float32)
    return ms, mf, tc, (2, 3, 1, 2)  # 4 classes over 8 rows, and a void row


@pytest.mark.parametrize("case", ["random", "all_blocked"])
def test_transformer_decoder_matches_flax(case):
    """Three layers cycling the levels, 10 queries. ``all_blocked``: every
    mask logit is negative (positive mask features, the mask MLP's last
    layer a constant -1), so every query's attention mask blocks every key
    and the decoder un-blocks them all (decoder:450)."""
    rng = np.random.default_rng(6)
    ms, mf, tc, nt = _decoder_inputs(rng, 2, 64, 96, case == "all_blocked")
    jm = jdecoder.FCCLIPTransformerDecoder(
        hidden_dim=CONV, num_queries=QUERIES, dec_layers=3, mask_dim=CONV,
        clip_embedding_dim=EMBED)
    params = draw_params(rng, jax.eval_shape(lambda: jm.init(
        jax.random.key(0), ms, mf, tc, nt))["params"])
    if case == "all_blocked":
        last = params["mask_embed"]["layer_2"]
        last["kernel"] = np.zeros_like(last["kernel"])
        last["bias"] = -np.ones_like(last["bias"])
    ref = highest(jax.jit(functools.partial(jm.apply, num_templates=nt)),
                  {"params": params}, ms, mf, tc)
    ours = FCCLIPTransformerDecoder(hidden_dim=CONV, num_queries=QUERIES,
                                    dec_layers=3, mask_dim=CONV,
                                    clip_embedding_dim=EMBED)
    ours.load_state_dict(convert.decoder_state_dict_from_jax(params))
    with torch.no_grad():
        got = ours([torch.from_numpy(a) for a in ms], torch.from_numpy(mf),
                   torch.from_numpy(tc), nt)
    for k in ("pred_logits", "pred_masks"):
        assert rel_err(got[k], ref[k]) <= MODULE_REL_TOL, k
    if case == "all_blocked":
        assert (got["pred_masks"] < 0).all()


def test_classification_logits_and_mask_pooling_match_jax():
    """Synonym max over the template groups, the void column, the scale
    clamped at 100 (a logit scale of 5); mask pooling with the os4 masks
    resized down to the os32 map."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32)
    tc = rng.normal(size=(7, 16)).astype(np.float32)
    for scale in (2.3, 5.0):
        ref = jdecoder.get_classification_logits(x, tc, scale, (1, 3, 2))
        got = get_classification_logits(torch.from_numpy(x),
                                        torch.from_numpy(tc),
                                        torch.tensor(scale), (1, 3, 2))
        assert got.shape == (2, 5, 4)
        assert rel_err(got, ref) <= 1e-6
    feat = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    masks = rng.normal(size=(2, 6, 24, 32)).astype(np.float32)
    ref = jdecoder.mask_pooling(feat, masks)
    got = mask_pooling(torch.from_numpy(feat), torch.from_numpy(masks))
    assert rel_err(got, ref) <= 1e-6


def test_prompts_and_template_folding_match_jax():
    ref = jmeta.prepare_class_names(jmeta.DSEC_USER_CLASSES)
    got = meta.prepare_class_names(meta.DSEC_USER_CLASSES)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] and got[2] == ref[2] and len(got[2]) == 504
    assert meta.VILD_PROMPT == jmeta.VILD_PROMPT
    assert meta.COCO_PANOPTIC_CLASSES == jmeta.COCO_PANOPTIC_CLASSES
    assert (meta.PIXEL_MEAN, meta.PIXEL_STD) == (jmeta.PIXEL_MEAN,
                                                 jmeta.PIXEL_STD)
    e = np.random.default_rng(8).normal(size=(3 * 14, 24)).astype(np.float32)
    assert rel_err(meta.fold_template_embeddings(torch.from_numpy(e)),
                   jmeta.fold_template_embeddings(e)) <= 1e-6


# ---------------------------------------------------------------------------
# the meta-architecture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_model():
    """JAX FCCLIP at the narrow architecture, its drawn params, and the
    port's model on the same weights (through the released layout)."""
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, size=(2, 64, 96, 3)).astype(np.float32)
    tc = rng.normal(size=(8, EMBED)).astype(np.float32)
    nt, overlap = (2, 3, 1, 2), np.array([1, 0, 1, 0], np.int32)
    params = draw_params(rng, jax.eval_shape(lambda: jmeta.FCCLIP(
        **SMALL).init(jax.random.key(0), img, tc, nt, overlap))["params"])
    text = init_params(rng, jbackbone.CLIPTextEncoder(
        vocab_size=600, width=64, heads=1, layers=2, embed_dim=EMBED),
        np.zeros((1, 77), np.int32))
    sd = convert.fcclip_state_dict_from_jax(params, text)
    f32 = jax.jit(functools.partial(jmeta.FCCLIP(**SMALL).apply,
                                    num_templates=nt))
    return dict(img=img, tc=tc, nt=nt, overlap=overlap, params=params,
                text=text, sd=sd, f32=f32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fcclip_matches_flax(small_model, dtype):
    """The whole image path: per-pixel class scores ``[B, H, W, K]`` (the
    sum over queries of class probability times mask probability), f32
    within 1e-4 of max; bf16 within ``BF16_REL_TOL`` of max and the argmax
    class equal on ``BF16_AGREE_MIN`` of the pixels."""
    m = small_model
    apply = m["f32"] if dtype == "float32" else jax.jit(functools.partial(
        jmeta.FCCLIP(**SMALL, dtype=jnp.bfloat16).apply,
        num_templates=m["nt"]))
    ref = highest(apply, {"params": m["params"]}, m["img"], m["tc"],
                  category_overlap=m["overlap"])
    image_sd, text_sd = convert.fcclip_state_dicts_from_released(m["sd"])
    model, _ = convert.build_fcclip(image_sd, text_sd, "cpu",
                                    getattr(torch, dtype))
    assert convert.fcclip_arch(image_sd) == dict(
        SMALL, enc_ff=1024, dec_ff=2048, trunk_depths=DEPTHS, trunk_dims=DIMS)
    with torch.no_grad():
        got = model(torch.from_numpy(m["img"]), torch.from_numpy(m["tc"]),
                    m["nt"], m["overlap"])
    assert got.shape == (2, 64, 96, 4) and got.dtype == torch.float32
    if dtype == "float32":
        assert rel_err(got, ref) <= MODULE_REL_TOL
    else:
        agree = (got.argmax(-1).numpy() == ref.argmax(-1)).mean()
        assert rel_err(got, ref) <= BF16_REL_TOL
        assert agree >= BF16_AGREE_MIN, agree


def test_fcclip_on_a_padded_frame_matches_the_jax_labeler_arithmetic(
        small_model):
    """A 50x70 frame in [0, 1] padded to 64x96 with the pixel mean, as the
    labeler does, then through both models in f32 and cut back: the
    per-pixel probabilities within 1e-4 of max."""
    m = small_model
    rng = np.random.default_rng(10)
    img = rng.uniform(size=(1, 50, 70, 3)).astype(np.float32)
    x = plabeler.pad_to_32(torch.from_numpy(img) * 255.0)
    assert x.shape == (1, 64, 96, 3)
    mean = np.asarray(jmeta.PIXEL_MEAN, np.float32)
    jx = np.pad(img * 255.0 - mean, ((0, 0), (0, 14), (0, 26), (0, 0))) + mean
    np.testing.assert_array_equal(x.numpy(), jx)
    ref = highest(m["f32"], {"params": m["params"]}, jx, m["tc"],
                  category_overlap=m["overlap"])[:, :50, :70]
    model, _ = convert.build_fcclip(
        *convert.fcclip_state_dicts_from_released(m["sd"]), "cpu",
        torch.float32)
    with torch.no_grad():
        got = model(x, torch.from_numpy(m["tc"]), m["nt"],
                    m["overlap"])[:, :50, :70]
    assert rel_err(got, ref) <= MODULE_REL_TOL


# ---------------------------------------------------------------------------
# panoptic and instance inference
# ---------------------------------------------------------------------------


def _panoptic_case(case):
    rng = np.random.default_rng(11)
    q, k, h, w = 12, 5, 16, 24
    cls = rng.normal(size=(q, k + 1)).astype(np.float32)
    pred = rng.normal(size=(q, h, w)).astype(np.float32) * 3
    thing = np.array([True, False, True, False, False])
    if case == "confident":
        # every query confident in its class and its mask a strip of its
        # own: the stuff classes 1, 3 and 4 recur, so later segments reuse
        # their class's first id
        cls[np.arange(q), np.arange(q) % k] = 12.0
        strips = np.arange(w)[None, None, :] // 2 == np.arange(q)[:, None,
                                                                 None]
        pred = np.where(strips, 4.0, -4.0) + 0.1 * pred
    elif case == "none":
        cls[:, -1] = 12.0  # every query void: nothing is kept
    return cls, pred, thing


@pytest.mark.parametrize("case", ["confident", "mixed", "none"])
def test_panoptic_inference_matches_jax(case):
    cls, pred, thing = _panoptic_case(case)
    ref = jinference.panoptic_inference(cls, pred, thing,
                                        object_mask_threshold=0.5)
    got = inference.panoptic_inference(torch.from_numpy(cls),
                                       torch.from_numpy(pred), thing,
                                       object_mask_threshold=0.5)
    for name in ref._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    if case == "none":
        assert not got.info_valid.any() and not got.panoptic_seg.any()
    if case == "confident":
        ids = got.segment_id[got.segment_id > 0]
        assert len(torch.unique(ids)) < len(ids)  # a stuff segment reused
        assert got.info_valid.sum() == len(torch.unique(ids))


@pytest.mark.parametrize("thing", [False, True])
def test_instance_inference_matches_jax(thing):
    cls, pred, mask = _panoptic_case("mixed")
    thing_mask = mask if thing else None
    ref = jinference.instance_inference(cls, pred, topk=7,
                                        thing_mask=thing_mask)
    got = inference.instance_inference(torch.from_numpy(cls),
                                       torch.from_numpy(pred), topk=7,
                                       thing_mask=thing_mask)
    for name in ("pred_masks", "pred_classes", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(ref.scores),
                               rtol=1e-6)


# ---------------------------------------------------------------------------
# the manifest and the released layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sizes", [{}, SMALL_MANIFEST], ids=["released",
                                                              "small"])
def test_manifest_is_jax_s(sizes):
    for ignored in (True, False):
        assert manifest.released_manifest(include_ignored=ignored, **sizes) \
            == jmanifest.released_manifest(include_ignored=ignored, **sizes)
    assert manifest.IGNORED_KEYS == jmanifest.IGNORED_KEYS


def _port_keys(model, text):
    keys = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    keys.update({convert.CLIP + k: tuple(v.shape)
                 for k, v in text.state_dict().items()})
    return keys


def test_full_width_model_on_meta_has_the_manifest_s_keys():
    """The released architecture built on the meta device (no weights
    drawn): the image model and the text tower hold exactly the manifest's
    846 inference keys, at its shapes."""
    with torch.device("meta"):
        model, text = fcclip.FCCLIP(), fcclip.CLIPTextEncoder()
    want = manifest.released_manifest(include_ignored=False)
    assert len(want) == 846
    assert _port_keys(model, text) == want
    assert convert.fcclip_arch(model.state_dict()) == dict(
        trunk_depths=(3, 3, 27, 3), trunk_dims=(192, 384, 768, 1536),
        clip_embed_dim=768, conv_dim=256, mask_dim=256, num_queries=250,
        dec_layers=9, enc_layers=6, n_heads=8, enc_ff=1024, dec_ff=2048)
    assert convert.text_arch(text.state_dict()) == dict(
        vocab_size=49408, context_length=77, width=768, heads=12, layers=16,
        embed_dim=768)


def released_fcclip(seed, sizes=SMALL_MANIFEST, scale=0.1):
    """A random ``{"model": ...}`` in the released layout at ``sizes``,
    ``criterion.empty_weight`` included (LayerNorm/GroupNorm weights around
    1, the rest around 0)."""
    g = torch.Generator().manual_seed(seed)
    sd = {}
    for k, shape in manifest.released_manifest(**sizes).items():
        t = torch.randn(shape, generator=g) * scale
        if k.endswith(".weight") and len(shape) == 1:
            t = t + 1.0
        sd[k] = t
    return {"model": sd}


def test_released_file_loads_strictly_and_is_the_jax_converter_s(tmp_path,
                                                                  monkeypatch):
    """A random file at the small manifest: the port validates it (the
    manifest's sizes patched in, as a narrow file needs), loads it with
    ``load_state_dict(strict=True)``, and the JAX converter's trees carried
    back by ``fcclip_state_dict_from_jax`` are the file's tensors bit for
    bit; a wrong shape or a missing key is refused with the key named."""
    ckpt = released_fcclip(12)
    path = tmp_path / "fcclip_small.pth"
    torch.save(ckpt, path)
    small = functools.partial(manifest.released_manifest, **SMALL_MANIFEST)
    monkeypatch.setattr(manifest, "released_manifest", small)
    image_sd, text_sd = convert.convert_fcclip_checkpoint(str(path))
    model, text = convert.build_fcclip(image_sd, text_sd, "cpu",
                                       torch.float32)
    sd = ckpt["model"]
    assert _port_keys(model, text) == {
        k: tuple(v.shape) for k, v in sd.items()
        if k not in manifest.IGNORED_KEYS}
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k
    for k, v in text.state_dict().items():
        assert torch.equal(v, sd[convert.CLIP + k]), k

    jp = {
        "visual": jconvert.convert_visual_trunk(sd, depths=DEPTHS),
        "visual_proj": jconvert.convert_visual_projection(sd),
        "pixel_decoder": jconvert.convert_pixel_decoder(sd, enc_layers=2),
        "decoder": jconvert.convert_transformer_decoder(sd, dec_layers=3),
        "void_embedding": jconvert._np(sd["void_embedding.weight"]),
        "clip_logit_scale": jconvert._np(sd["backbone.clip_model.logit_scale"]),
    }
    jt = jconvert.convert_text_encoder(sd, layers=2)
    back = convert.fcclip_state_dict_from_jax(jp, jt)
    assert sorted(back) == sorted(k for k in sd
                                  if k not in manifest.IGNORED_KEYS)
    for k, v in back.items():
        assert torch.equal(v, sd[k]), k

    bad = dict(sd)
    key = "sem_seg_head.predictor.query_embed.weight"
    bad[key] = torch.zeros(QUERIES + 1, CONV)
    with pytest.raises(ValueError, match="query_embed"):
        manifest.validate_state_dict(bad)
    del bad[key]
    with pytest.raises(ValueError, match="missing 1 keys"):
        manifest.validate_state_dict(bad)


def test_public_names_are_jax_s():
    assert set(jf.__all__) <= set(fcclip.__all__)
    for name in jf.__all__:
        assert getattr(fcclip, name) is not None
    np.testing.assert_array_equal(plabeler.USER_TO_DSEC, jlabeler.USER_TO_DSEC)
