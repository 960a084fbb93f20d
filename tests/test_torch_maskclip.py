"""MaskCLIP (``openess_tpu_torch/models/maskclip.py``) against the flax
module, its converters against ``convert_maskclip``, the remap labeler
against JAX's, and the two MaskCLIP tools (``generate_pseudo_labels``,
``eval_annotation_free``) against the JAX tools on fixture trees
(``openess_tpu/data/fixtures.py``).

The JAX package's ``MaskClipFeatureExtractor`` builds a ViT-B/16 by name
(``MaskClipViT(dtype, name="encoder")``). To run the whole extractor and
the tools at a small width, the tests put a subclass with smaller
defaults in that name's place in the JAX module (``small_jax_vit``); the
port builds the same architecture from the weights it is given
(``models/convert.maskclip_arch``: CLIP's heads of 64 channels)."""
import functools
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import openess_tpu.models.maskclip as jm
from openess_tpu.models.fcclip import labeler as jlabeler
from openess_tpu.models.torch_convert import convert_maskclip
from openess_tpu_torch import eval_annotation_free, generate_pseudo_labels
from openess_tpu_torch.models import maskclip
from openess_tpu_torch.models.convert import (
    maskclip_arch,
    maskclip_state_dict_from_jax,
    maskclip_state_dict_from_released,
)
from openess_tpu_torch.models.fcclip import labeler
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

LOGIT_REL_TOL = 1e-4   # f32, of max|logits| (measured ~7e-7)
# The tools in bf16 on both sides, random weights (36 random text rows,
# so near ties are common and a bf16 rounding flips some): the least share
# of a pseudo-label PNG's pixels equal to the JAX tool's (measured on the
# CPU: 0.9882 worst on the DDD17 tree, 0.9911 on DSEC), and the largest
# gap of a printed eval number in points (measured 0.05).
PL_AGREE_MIN = 0.97
EVAL_POINTS_TOL = 0.25


def small_jax_vit(width, layers, heads):
    class SmallViT(jm.MaskClipViT):
        embed_dim: int = width
        num_layers: int = layers
        num_heads: int = heads

    return SmallViT


def jax_params(rng, width, layers, heads, img, text):
    """Flax parameters of an extractor with ``SmallViT``, every leaf drawn
    anew (LayerNorm scales around 1)."""
    jm_vit = jm.MaskClipViT
    jm.MaskClipViT = small_jax_vit(width, layers, heads)
    try:
        variables = jax.eval_shape(
            jm.MaskClipFeatureExtractor(num_classes=text.shape[0]).init,
            jax.random.key(0), img, text)
    finally:
        jm.MaskClipViT = jm_vit
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    leaves = {}
    for path, leaf in flat:
        key = jax.tree_util.keystr(path)
        draw = rng.normal(0, 0.3 if leaf.ndim > 1 else 0.1, leaf.shape)
        if key.endswith("['scale']"):
            draw = 1.0 + draw
        leaves[key] = draw.astype(np.float32)
    return jax.tree_util.tree_map_with_path(
        lambda p, _: leaves[jax.tree_util.keystr(p)], variables["params"])


def test_encoder_layer_with_qkv_matches_flax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 10, 64)).astype(np.float32)
    layer = jm.CLIPEncoderLayer(embed_dim=64, num_heads=4)
    params = jax.eval_shape(functools.partial(layer.init, return_qkv=True),
                            jax.random.key(0), x)["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0, 0.2, a.shape).astype(np.float32), params)
    ref = jax.jit(functools.partial(layer.apply, return_qkv=True))(
        {"params": params}, x)
    full = maskclip_state_dict_from_jax({
        "encoder": {"layers_0": params, "patch_embed": {"kernel": np.zeros(
            (16, 16, 3, 64))}, "cls_token": np.zeros((1, 1, 64)),
            "pos_embed": np.zeros((1, 197, 64)),
            "ln_pre": {"scale": np.ones(64), "bias": np.zeros(64)},
            "ln_post": {"scale": np.ones(64), "bias": np.zeros(64)}},
        "proj": {"kernel": np.zeros((64, 8))}})
    ours = maskclip.CLIPEncoderLayer(64, 4)
    ours.load_state_dict({k.removeprefix("encoder.layers.0."): v
                          for k, v in full.items()
                          if k.startswith("encoder.layers.0.")})
    with torch.no_grad():
        got = ours(torch.from_numpy(x), return_qkv=True)
        plain = ours(torch.from_numpy(x))
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-5 * np.abs(b).max()
    assert plain[1:] == (None, None, None)
    torch.testing.assert_close(plain[0], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("gh,gw", [(28, 40), (30, 40), (4, 6), (14, 14)])
def test_pos_embed_resize_is_jax_image_resize_cubic(gh, gw):
    """Keys' a = -0.5 cubic with JAX's border rule, antialiased where the
    14x14 grid shrinks (4x6); ``F.interpolate(mode="bicubic")`` is not
    this (shown at 28x40)."""
    pe = np.random.default_rng(1).normal(size=(1, 197, 32)).astype(np.float32)
    ref = np.asarray(jm._resize_pos_embed(jnp.asarray(pe), gh, gw))
    got = maskclip.resize_pos_embed(torch.from_numpy(pe), gh, gw).numpy()
    assert got.shape == ref.shape == (1, 1 + gh * gw, 32)
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if (gh, gw) == (28, 40):
        grid = torch.from_numpy(pe[:, 1:]).reshape(1, 14, 14, 32).permute(
            0, 3, 1, 2)
        bicubic = torch.nn.functional.interpolate(
            grid, size=(gh, gw), mode="bicubic", align_corners=False)
        bicubic = bicubic.permute(0, 2, 3, 1).reshape(1, gh * gw, 32).numpy()
        assert np.abs(bicubic - ref[:, 1:]).max() > 0.05


@pytest.mark.parametrize("h,w", [(64, 96), (50, 70)])
def test_extractor_matches_flax_in_f32(h, w, monkeypatch):
    """2 layers, width 64, 4 heads; 64x96 and an image that is not a
    multiple of 16 (corner padding): logits and the value-path features
    within 1e-4 of their max."""
    rng = np.random.default_rng(2)
    img = rng.uniform(size=(2, h, w, 3)).astype(np.float32)
    text = rng.normal(size=(11, 512)).astype(np.float32)
    params = jax_params(rng, 64, 2, 4, img, text)
    monkeypatch.setattr(jm, "MaskClipViT", small_jax_vit(64, 2, 4))
    apply = jax.jit(functools.partial(
        jm.MaskClipFeatureExtractor(num_classes=11).apply,
        return_features=True))
    with jax.default_matmul_precision("highest"):
        ref, ref_f = apply({"params": params}, img, text)
    sd = maskclip_state_dict_from_jax(jax.tree_util.tree_map(np.asarray,
                                                             params))
    arch = dict(maskclip_arch(sd), num_heads=4)
    model = maskclip.MaskClipFeatureExtractor(**arch)
    model.load_state_dict(sd)
    with torch.no_grad():
        got, got_f = model(torch.from_numpy(img), torch.from_numpy(text),
                           return_features=True)
    assert got.shape == (2, h, w, 11) and got_f.shape == (2, -(-h // 16),
                                                          -(-w // 16), 64)
    for a, b in ((got, ref), (got_f, ref_f)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= LOGIT_REL_TOL * np.abs(b).max()


def released_maskclip(seed, width=128, layers=2, proj_4d=True, text_dim=512):
    """Random weights in the released layouts: the backbone's state dict
    under ``backbone.`` and the visual projection's ``{"proj": {"weight":
    [text_dim, width(, 1, 1)]}}``."""
    with torch.random.fork_rng():
        torch.manual_seed(seed)
        vit = maskclip.MaskClipViT(embed_dim=width, num_layers=layers,
                                   num_heads=max(1, width // 64))
        sd = {"backbone." + k: v + 0.05 * torch.randn(v.shape)
              for k, v in vit.state_dict().items()}
        proj = torch.randn(text_dim, width) * width ** -0.5
    return {"state_dict": sd}, {"proj": {"weight": proj[:, :, None, None]
                                         if proj_4d else proj}}


@pytest.mark.parametrize("proj_4d", [True, False])
def test_from_released_is_convert_maskclip_carried_across(proj_4d):
    backbone, projs = released_maskclip(3, proj_4d=proj_4d)
    got = maskclip_state_dict_from_released(backbone["state_dict"], projs)
    ref = maskclip_state_dict_from_jax(
        convert_maskclip(backbone["state_dict"], projs))
    assert sorted(got) == sorted(ref)
    for k in ref:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=0)
    model = maskclip.MaskClipFeatureExtractor(**maskclip_arch(got))
    model.load_state_dict(got)  # strict: every key, every shape
    assert maskclip_arch(got) == {"embed_dim": 128, "num_layers": 2,
                                  "num_heads": 2, "patch_size": 16,
                                  "text_embed_dim": 512}


@pytest.mark.parametrize("dataset", ["dsec", "ddd17"])
def test_maxpool_argmax_is_jax_s(dataset):
    """All 36 vocabulary channels given, ties included: DDD17 reads only
    its remap's 34."""
    remap, n = labeler.DATASET_REMAP[dataset]
    jremap, jn = jlabeler.DATASET_REMAP[dataset]
    np.testing.assert_array_equal(remap, jremap)
    assert n == jn and len(remap) == (36 if dataset == "dsec" else 34)
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 5, (2, 9, 13, 36)).astype(np.float32)
    scores[0, 0, 0, 34:] = 100.0  # unmapped in DDD17: must not win there
    got = labeler.maxpool_argmax(torch.from_numpy(scores), remap, n)
    ref = np.asarray(jlabeler.maxpool_argmax(jnp.asarray(scores), jremap, jn))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    with pytest.raises(ValueError):
        labeler.maxpool_argmax(torch.from_numpy(scores), remap, n - 1)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DSEC sequence and six DDD17 recordings (fixtures.py), the
    released-layout weights at width 128 (2 layers, 2 heads) and the text
    embeddings: the 36-entry vocabulary (``.npy``) and DDD17's 6 classes
    (``.pth``)."""
    from openess_tpu.data.fixtures import write_ddd17_dir, write_dsec_sequence

    root = tmp_path_factory.mktemp("maskclip")
    rng = np.random.default_rng(5)
    write_dsec_sequence(root / "dsec" / "train" / "zurich_city_00_a", rng)
    for i in range(6):
        write_ddd17_dir(root / "ddd17" / f"dir{i}", rng, n_imgs=2,
                        n_events=2000)
    backbone, projs = released_maskclip(6)
    torch.save(backbone, root / "ViT16_clip_backbone.pth")
    torch.save(projs, root / "ViT16_clip_weights.pth")
    np.save(root / "vocab.npy", rng.normal(size=(36, 512)).astype(np.float32))
    torch.save(torch.from_numpy(rng.normal(size=(6, 512)).astype(np.float32)),
               root / "ddd17_text.pth")
    return root


def _pl_args(root, dataset):
    shard = ["--shard", "1", "--num_shards", "4"] if dataset == "dsec" else []
    return shard + ["--root", str(root / dataset), "--dataset", dataset,
            "--teacher", "maskclip",
            "--clip_ckpt", str(root / "ViT16_clip_backbone.pth"),
            "--visual_projs", str(root / "ViT16_clip_weights.pth"),
            "--text_embeddings", str(root / "vocab.npy")]


def _pngs(root, name):
    from PIL import Image

    out = {}
    for dirpath, _, files in os.walk(root):
        if f"/{name}" in dirpath:
            for f in files:
                p = os.path.join(dirpath, f)
                out[os.path.relpath(p, root)] = np.asarray(Image.open(p))
    return out


@pytest.mark.parametrize("dataset", ["dsec", "ddd17"])
def test_pseudo_label_tool_matches_the_jax_tool(trees, dataset, monkeypatch):
    """Both tools in bf16 on one tree, the port's on the CPU: the same
    PNG names in the same places, uint8 classes of the dataset, and the
    labels equal on at least ``PL_AGREE_MIN`` of each PNG's pixels."""
    import sys

    import tools.generate_pseudo_labels as jtool

    monkeypatch.setattr(jm, "MaskClipViT", small_jax_vit(128, 2, 2))
    monkeypatch.setattr(sys, "argv", ["pl"] + _pl_args(trees, dataset)
                        + ["--out_name", "pl_jax"])
    jtool.main()
    generate_pseudo_labels.main(_pl_args(trees, dataset) + [
        "--out_name", "pl_port", "--device", "cpu"])
    ref = _pngs(trees / dataset, "pl_jax")
    got = _pngs(trees / dataset, "pl_port")
    assert len(got) == (4 if dataset == "dsec" else 12)  # DSEC: 1 of 4 shards
    assert sorted(k.replace("pl_port", "pl_jax") for k in got) == sorted(ref)
    agree = []
    for k, v in got.items():
        r = ref[k.replace("pl_port", "pl_jax")]
        assert v.dtype == np.uint8 and v.shape == r.shape
        assert v.max() < labeler.DATASET_REMAP[dataset][1]
        agree.append((v == r).mean())
    assert min(agree) >= PL_AGREE_MIN, min(agree)


def _eval_yaml(trees):
    cfg = {
        "dataset": {"name_b": "DDD17_events", "DDD17_events": {
            "dataset_path": str(trees / "ddd17"), "split_train": "train",
            "shape": [200, 346], "nr_events_data": 2,
            "fixed_duration": False, "delta_t_per_data": 50,
            "require_paired_data_train": False,
            "require_paired_data_val": False, "nr_events_window": 400,
            "event_representation": "voxel_grid", "nr_temporal_bins": 5,
            "separate_pol": True, "normalize_event": False}},
        "task": {"semseg_num_classes": 6},
        "optim": {"batch_size_b": 3},
        "clip": {"config_option": "frame2recon",
                 "maskclip_checkpoint": str(trees / "ViT16_clip_backbone.pth"),
                 "visual_projs_path": str(trees / "ViT16_clip_weights.pth"),
                 "text_embeddings_path": str(trees / "ddd17_text.pth"),
                 "superpixel_sources": "", "pl_sources": ""},
    }
    path = trees / "eval.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("source", ["recon", "frame"])
def test_eval_annotation_free_matches_the_jax_tool(trees, source,
                                                   monkeypatch, capsys):
    """The DDD17 validation recording (2 samples at batch 3: one padded
    row) through both tools in bf16: the printed per-class IoU, mIoU and
    accuracy within ``EVAL_POINTS_TOL`` points; the confusion matrix
    counts the two samples' labelled pixels once."""
    import ast
    import sys

    import tools.eval_annotation_free as jtool

    cfg = _eval_yaml(trees)
    monkeypatch.setattr(jm, "MaskClipViT", small_jax_vit(128, 2, 2))
    monkeypatch.setattr(sys, "argv", ["ev", "--settings_file", cfg,
                                      "--source", source])
    jtool.main()
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_annotation_free.main(["--settings_file", cfg, "--source",
                                     source, "--device", "cpu"])
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: round(float(v), 2) for k, v in got.items()
                       if k != "cm"}
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.data.loaders import build_datasets

    s = load_settings(cfg)
    _, val = build_datasets(s, "cpu")
    labels = val.get_batch(list(range(len(val))))["label"]
    assert len(val) == 2  # scored once each, the padded row not at all
    assert got["cm"].sum() == (labels != s.semseg_ignore_label).sum()
    assert sorted(printed) == sorted(ref)
    for k in ref:
        assert abs(printed[k] - ref[k]) <= EVAL_POINTS_TOL, (k, printed, ref)
