"""``--teacher fcclip`` of the port's offline tools
(``generate_pseudo_labels``, ``eval_annotation_free``) against the JAX
tools' ``main`` in the same process, on fixture trees
(``openess_tpu/data/fixtures.py``) and one random FC-CLIP file in the
released layout at a narrow width.

The JAX labeler builds the released architecture by name
(``FCCLIP(dtype=...)``, ``CLIPTextEncoder(dtype=...)``), converts with the
released depths and validates against the released manifest. So the JAX
side runs narrow through ``monkeypatch``: small ``FCCLIP`` and
``CLIPTextEncoder`` subclasses in ``openess_tpu.models.fcclip``'s names,
the four converters wrapped with the small depths, and
``manifest.released_manifest`` with the small sizes, so validation still
runs; the port's manifest gets the same sizes and the port reads the
architecture off the weights. Two more patches let the JAX labeler run at
all (ROADMAP Queue 3, JAX-side facts): it tokenizes each prompt as
``tok(prompt)``, which iterates a string's characters and cannot be
stacked, so the JAX ``SimpleTokenizer`` in that name takes a string as one
prompt; and its jitted text tower closes over the converter's numpy
arrays, and numpy cannot index the token embedding with a traced array,
so the wrapped ``convert_text_encoder`` returns JAX arrays. The JAX
package's files stay untouched.

Both labelers compute in bf16 by default. With random weights and random
text embeddings the vocabulary's classes come out nearly tied, so bf16
rounding alone moves 5-85 % of a noise frame's labels (the port in bf16
against itself in f32: 0.84-0.95 of the pixels equal on DDD17 fixture
frames); the tools are compared in f32 on both sides instead (the JAX
modules' dtype pinned by their ``__post_init__``, the port's labeler given
``dtype=torch.float32``), and ``test_torch_fcclip.py`` holds the model in
bf16."""
import ast
import functools
import sys
from typing import Any

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp
import openess_tpu.models.fcclip as jf
from openess_tpu.models.fcclip import convert as jconvert
from openess_tpu.models.fcclip import manifest as jmanifest
from openess_tpu_torch import eval_annotation_free, generate_pseudo_labels
from openess_tpu_torch.models.fcclip import labeler, manifest
from test_torch_fcclip import (
    DEPTHS,
    DIMS,
    EMBED,
    SMALL,
    SMALL_MANIFEST,
    released_fcclip,
)
from test_torch_fcclip_tokenizer import _merges_file, _prompt_merges
from test_torch_maskclip import _pngs
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

# Both tools in f32 (module docstring): the least share of a PNG's pixels
# equal to the JAX tool's (measured 0.9977 on a DDD17
# noise frame's near ties, 0.99999 at least on DSEC's), and the largest gap of a
# printed eval number in points (measured 0: the printed
# numbers equal).
PL_AGREE_MIN = 0.99
EVAL_POINTS_TOL = 0.05


def _f32(module):
    """A flax module's ``__post_init__`` that computes in f32 whatever
    dtype the JAX labeler asks for."""
    object.__setattr__(module, "dtype", jnp.float32)
    type(module).__mro__[1].__post_init__(module)


class JaxSmallFCCLIP(jf.FCCLIP):
    __post_init__ = _f32
    trunk_depths: Any = DEPTHS
    trunk_dims: Any = DIMS
    clip_embed_dim: int = EMBED
    conv_dim: int = SMALL["conv_dim"]
    mask_dim: int = SMALL["mask_dim"]
    num_queries: int = SMALL["num_queries"]
    dec_layers: int = SMALL["dec_layers"]
    enc_layers: int = SMALL["enc_layers"]


class JaxSmallText(jf.CLIPTextEncoder):
    __post_init__ = _f32
    vocab_size: int = SMALL_MANIFEST["vocab"]
    width: int = SMALL_MANIFEST["text_width"]
    heads: int = 1
    layers: int = SMALL_MANIFEST["text_layers"]
    embed_dim: int = EMBED


class JaxPromptTokenizer(jf.SimpleTokenizer):
    def __call__(self, texts, context_length=77):
        if isinstance(texts, str):
            return super().__call__([texts], context_length)[0]
        return super().__call__(texts, context_length)


@pytest.fixture
def narrow(monkeypatch):
    """Both packages at the narrow architecture (module docstring)."""
    small = functools.partial(jmanifest.released_manifest, **SMALL_MANIFEST)
    monkeypatch.setattr(jmanifest, "released_manifest", small)
    monkeypatch.setattr(manifest, "released_manifest", functools.partial(
        manifest.released_manifest, **SMALL_MANIFEST))
    monkeypatch.setattr(jf, "FCCLIP", JaxSmallFCCLIP)
    monkeypatch.setattr(jf, "CLIPTextEncoder", JaxSmallText)
    monkeypatch.setattr(jf, "SimpleTokenizer", JaxPromptTokenizer)
    for name, kw in (("convert_visual_trunk", {"depths": DEPTHS}),
                     ("convert_pixel_decoder",
                      {"enc_layers": SMALL["enc_layers"]}),
                     ("convert_transformer_decoder",
                      {"dec_layers": SMALL["dec_layers"]})):
        monkeypatch.setattr(jconvert, name,
                            functools.partial(getattr(jconvert, name), **kw))
    text = jconvert.convert_text_encoder
    monkeypatch.setattr(jconvert, "convert_text_encoder", lambda sd: (
        jax.tree_util.tree_map(jnp.asarray, text(
            sd, layers=SMALL_MANIFEST["text_layers"]))))
    f32 = functools.partial(labeler.build_fcclip_labeler, dtype=torch.float32)
    monkeypatch.setattr(generate_pseudo_labels, "build_fcclip_labeler", f32)
    monkeypatch.setattr(eval_annotation_free, "build_fcclip_labeler", f32)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """A DSEC sequence, six DDD17 recordings, the narrow FC-CLIP file
    (``{"model": ...}`` with ``criterion.empty_weight``) and a merges
    file."""
    from openess_tpu.data.fixtures import write_ddd17_dir, write_dsec_sequence

    root = tmp_path_factory.mktemp("fcclip_tools")
    rng = np.random.default_rng(5)
    write_dsec_sequence(root / "dsec" / "train" / "zurich_city_00_a", rng)
    for i in range(6):
        write_ddd17_dir(root / "ddd17" / f"dir{i}", rng, n_imgs=2,
                        n_events=2000)
    torch.save(released_fcclip(21, scale=0.3), root / "fcclip.pth")
    _merges_file(root / "bpe.txt.gz", _prompt_merges())
    return root


def _files(root):
    return ["--fcclip_ckpt", str(root / "fcclip.pth"),
            "--bpe_vocab", str(root / "bpe.txt.gz")]


def _pl_args(root, dataset):
    shard = ["--shard", "1", "--num_shards", "8"] if dataset == "dsec" else []
    return shard + ["--root", str(root / dataset), "--dataset", dataset,
                    "--teacher", "fcclip"] + _files(root)


@pytest.mark.parametrize("dataset", ["dsec", "ddd17"])
def test_pseudo_label_tool_matches_the_jax_tool(trees, dataset, narrow,
                                                monkeypatch):
    """The same PNG names in the same places, uint8 classes of the
    dataset, the labels equal on at least ``PL_AGREE_MIN`` of each PNG's
    pixels (480x640 DSEC frames; DDD17's 200x352 padded to 224x352)."""
    import tools.generate_pseudo_labels as jtool

    monkeypatch.setattr(sys, "argv", ["pl"] + _pl_args(trees, dataset)
                        + ["--out_name", "pl_jax"])
    jtool.main()
    generate_pseudo_labels.main(_pl_args(trees, dataset) + [
        "--out_name", "pl_port", "--device", "cpu"])
    ref = _pngs(trees / dataset, "pl_jax")
    got = _pngs(trees / dataset, "pl_port")
    assert len(got) == (2 if dataset == "dsec" else 12)  # DSEC: 1 of 8 shards
    assert sorted(k.replace("pl_port", "pl_jax") for k in got) == sorted(ref)
    agree = []
    for k, v in got.items():
        r = ref[k.replace("pl_port", "pl_jax")]
        assert v.dtype == np.uint8 and v.shape == r.shape
        assert v.max() < labeler.DATASET_REMAP[dataset][1]
        agree.append((v == r).mean())
    assert min(agree) >= PL_AGREE_MIN, min(agree)
    # the labels are not one class: the teacher's classes reach the PNGs
    assert len(np.unique(np.concatenate([v.ravel() for v in got.values()]))) > 1


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
        "clip": {"config_option": "frame2recon", "superpixel_sources": "",
                 "pl_sources": ""},
    }
    path = trees / "eval_fcclip.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("source", ["recon", "frame"])
def test_eval_annotation_free_matches_the_jax_tool(trees, source, narrow,
                                                   monkeypatch, capsys):
    """The DDD17 validation recording (2 samples at batch 3, one padded
    row) through both tools: the printed per-class IoU, mIoU and accuracy
    within ``EVAL_POINTS_TOL`` points; the confusion matrix counts the two
    samples' labelled pixels once."""
    import tools.eval_annotation_free as jtool

    cfg = _eval_yaml(trees)
    args = ["--settings_file", cfg, "--source", source, "--teacher",
            "fcclip"] + _files(trees)
    monkeypatch.setattr(sys, "argv", ["ev"] + args)
    jtool.main()
    ref = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_annotation_free.main(args + ["--device", "cpu"])
    printed = ast.literal_eval(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == {k: round(float(v), 2) for k, v in got.items()
                       if k != "cm"}
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.data.loaders import build_datasets

    s = load_settings(cfg)
    _, val = build_datasets(s, "cpu")
    labels = val.get_batch(list(range(len(val))))["label"]
    assert len(val) == 2
    assert got["cm"].sum() == (labels != s.semseg_ignore_label).sum()
    assert sorted(printed) == sorted(ref)
    for k in ref:
        assert abs(printed[k] - ref[k]) <= EVAL_POINTS_TOL, (k, printed, ref)


@pytest.mark.parametrize("tool", ["pseudo_labels", "eval"])
def test_tools_keep_the_jax_argument_checks(tool, trees, narrow, tmp_path):
    """Both files are required; a class count that is not the remap's is
    refused (``--num_classes`` / the settings' ``semseg_num_classes``)."""
    if tool == "pseudo_labels":
        main, base = generate_pseudo_labels.main, _pl_args(trees, "ddd17")
        wrong = ["--num_classes", "11"]
    else:
        cfg = yaml.safe_load(open(_eval_yaml(trees)))
        cfg["task"]["semseg_num_classes"] = 11
        path = tmp_path / "eleven.yaml"
        path.write_text(yaml.safe_dump(cfg))
        main = eval_annotation_free.main
        base = ["--settings_file", str(path), "--teacher", "fcclip"] + \
            _files(trees)
        wrong = []
    with pytest.raises(SystemExit, match="needs --fcclip_ckpt"):
        main([a for a in base if a not in _files(trees)] + ["--device", "cpu"])
    with pytest.raises(SystemExit, match="does not match"):
        main(base + wrong + ["--out_name", "never"] * (tool != "eval")
             + ["--device", "cpu"])
