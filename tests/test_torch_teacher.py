"""The frame teacher of the port against the JAX package on the CPU, f32:
``resize_bilinear`` (both ``align_corners`` conventions, forward and
gradient against the JAX custom VJP), the hand-written ResNet-50 at output
strides 4/8/16 with and without ``fold_bn``, ``DilationFeatureExtractor``
with the weights carried through ``teacher_state_dict_from_jax``, and the
round trip back through ``convert_dilation_teacher``.

Tolerances (measured: resize 1e-6, teacher features 3.4e-7 at a feature
scale of 0.22, trunk 1e-5 relative): resize 1e-5 absolute; teacher
features 1e-5 absolute (unit-norm rows); trunk 1e-4 of its max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.models.image_teacher import (
    DilationFeatureExtractor as JTeacher,
    imagenet_normalize as jnormalize,
)
from openess_tpu.models.resnet import ResNet50 as JResNet
from openess_tpu.models.torch_convert import convert_dilation_teacher
from openess_tpu.ops.resize import resize_bilinear as jresize
from openess_tpu_torch.models.convert import teacher_state_dict_from_jax
from openess_tpu_torch.models.image_teacher import (
    DilationFeatureExtractor,
    imagenet_normalize,
)
from openess_tpu_torch.models.resnet import ResNet50
from openess_tpu_torch.ops.resize import resize_bilinear
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

H, W = 48, 64


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("sizes", [((12, 16), (48, 64)), ((9, 7), (20, 31)),
                                   ((16, 24), (8, 12))], ids=str)
def test_resize_bilinear_forward_and_gradient(align, sizes):
    (h, w), (oh, ow) = sizes
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, h, w, 5)).astype(np.float32)
    g = rng.normal(size=(2, oh, ow, 5)).astype(np.float32)
    jy, vjp = jax.vjp(
        lambda a: jresize(a, out_h=oh, out_w=ow, align_corners=align),
        jnp.asarray(x))
    (jg,) = vjp(jnp.asarray(g))
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = resize_bilinear(tx, out_h=oh, out_w=ow, align_corners=align)
    assert ty.shape == (2, oh, ow, 5) and ty.is_contiguous()
    ty.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg), atol=1e-5)


def test_resize_same_size_is_identity():
    x = torch.randn(1, 4, 6, 3)
    assert resize_bilinear(x, out_h=4, out_w=6, align_corners=True) is x


def test_imagenet_normalize():
    x = np.random.default_rng(1).uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_allclose(
        imagenet_normalize(torch.from_numpy(x)).numpy(),
        np.asarray(jnormalize(jnp.asarray(x))), atol=1e-6)


def _randomize_bn(params, stats, rng):
    """Give every BatchNorm a non-trivial affine and statistics, so folding
    and the inference-mode normalization are really exercised."""
    for k in params:
        if k.startswith("bn") or k.endswith("_bn"):
            n = params[k]["scale"].shape
            params[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params[k]["bias"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif isinstance(params[k], dict) and k in stats:
            _randomize_bn(params[k], stats[k], rng)


@pytest.fixture(scope="module")
def teacher_tree():
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (1, H, W, 3)).astype(np.float32)
    v = JTeacher().init(jax.random.key(0), jnp.asarray(x))
    params = jax.tree.map(np.array, dict(v["params"]))
    stats = jax.tree.map(np.array, dict(v["batch_stats"]))
    _randomize_bn(params["encoder"], stats["encoder"], rng)
    params["decoder_conv"]["bias"] = rng.normal(
        0, 0.1, params["decoder_conv"]["bias"].shape).astype(np.float32)
    return params, stats, x


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("output_stride", [4, 8, 16])
def test_teacher_matches_jax(teacher_tree, output_stride, fold):
    params, stats, x = teacher_tree
    jm = JTeacher(output_stride=output_stride, fold_bn=fold)
    ref = np.asarray(jax.jit(
        lambda p, b, a: jm.apply({"params": p, "batch_stats": b}, a)
    )(params, stats, jnp.asarray(x)))
    tm = DilationFeatureExtractor(output_stride=output_stride, fold_bn=fold)
    tm.load_state_dict(teacher_state_dict_from_jax(params, stats), strict=True)
    tm.train()  # the encoder must stay in inference-mode BN regardless
    got = tm(torch.from_numpy(x))
    assert got.shape == (1, H, W, 256) and got.is_contiguous()
    np.testing.assert_allclose(got.detach().numpy(), ref, atol=1e-5)
    np.testing.assert_allclose(
        np.linalg.norm(got.detach().numpy(), axis=-1), 1.0, atol=1e-5)
    # only decoder_conv is reached by gradients
    got.square().mean().backward()
    grads = {n for n, p in tm.named_parameters() if p.grad is not None}
    assert grads == {"decoder_conv.weight", "decoder_conv.bias"}
    # BatchNorm statistics untouched by a train-mode forward
    sd = tm.state_dict()
    np.testing.assert_array_equal(sd["encoder.bn1.running_mean"].numpy(),
                                  stats["encoder"]["bn1"]["mean"])


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("dilation", [(False, False, True), (True, True, True)],
                         ids=["os16", "os4"])
def test_resnet50_trunk_matches_jax(teacher_tree, dilation, fold):
    params, stats, x = teacher_tree
    jm = JResNet(replace_stride_with_dilation=dilation, fold_bn=fold)
    ref = np.asarray(jax.jit(
        lambda p, b, a: jm.apply({"params": p, "batch_stats": b}, a)
    )(params["encoder"], stats["encoder"], jnp.asarray(x)))
    tm = ResNet50(replace_stride_with_dilation=dilation, fold_bn=fold)
    sd = teacher_state_dict_from_jax(params, stats)
    tm.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()
                        if k.startswith("encoder.")}, strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_fold_cache_follows_the_parameters(teacher_tree):
    """The folded weights are a cache: loading new weights drops it, and
    the state dict holds only the unfolded torchvision keys."""
    params, stats, x = teacher_tree
    tm = DilationFeatureExtractor(output_stride=16, fold_bn=True)
    tx = torch.from_numpy(x)
    before = tm(tx).detach()
    tm.load_state_dict(teacher_state_dict_from_jax(params, stats), strict=True)
    after = tm(tx).detach()
    assert (before - after).abs().max() > 1e-3
    plain = DilationFeatureExtractor(output_stride=16, fold_bn=False)
    plain.load_state_dict(tm.state_dict(), strict=True)
    np.testing.assert_allclose(plain(tx).detach().numpy(), after.numpy(),
                               atol=1e-5)
    keys = set(tm.state_dict())
    assert "encoder.layer1.0.downsample.0.weight" in keys
    assert "encoder.layer4.2.bn3.running_var" in keys
    assert not any("fold" in k for k in keys)


def test_bf16_teacher_tracks_f32(teacher_tree):
    """bf16 compute dtype with f32 parameters (folded in f32, cast last):
    measured 2.3e-3 of the unit feature norm at os 16; bound 1e-2."""
    params, stats, x = teacher_tree
    sd = teacher_state_dict_from_jax(params, stats)
    f32 = DilationFeatureExtractor(output_stride=16, fold_bn=True)
    b16 = DilationFeatureExtractor(output_stride=16, fold_bn=True,
                                   dtype=torch.bfloat16)
    f32.load_state_dict(sd)
    b16.load_state_dict(sd)
    a, b = f32(torch.from_numpy(x)), b16(torch.from_numpy(x))
    assert b.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in b16.parameters())
    assert (a - b.float()).abs().max().item() <= 1e-2


def test_round_trip_through_convert_dilation_teacher(teacher_tree):
    params, stats, _ = teacher_tree
    tm = DilationFeatureExtractor()
    tm.load_state_dict(teacher_state_dict_from_jax(params, stats), strict=True)
    sd = tm.state_dict()
    enc = {k[len("encoder."):]: v for k, v in sd.items()
           if k.startswith("encoder.")}
    p2, s2 = convert_dilation_teacher(enc, sd["decoder_conv.weight"],
                                      sd["decoder_conv.bias"])
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    for ref, got in ((params, p2), (stats, s2)):
        fr, fg = flat(ref), flat(got)
        assert fr.keys() == fg.keys()
        for k in fr:
            np.testing.assert_array_equal(np.asarray(fg[k]), fr[k], str(k))
