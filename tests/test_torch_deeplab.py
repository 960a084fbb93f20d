"""The DeepLabV3 student of the port against the JAX package on the CPU
(B = 2, 64x96, 6 classes, full ResNet-50 depth, every BatchNorm given a
random affine and random running statistics; the port-only fold and
dropout tests at 32x48): both outputs over
``output_stride`` 8/16/32 x ``fold_bn`` x train/eval, flax's BatchNorm
arithmetic and running-statistics update (also at one value a channel, the
pooling branch at B = 1), the fold after an optimizer step, dropout, the
``linear_probe`` conv, bf16, and the round trip through
``convert_deeplab``. Dropout is off on both sides in the parity tests:
flax's ``Dropout`` is replaced by an identity inside these tests only and
the port's rate is set to 0.

Tolerances, with what was measured:
- Eval, f32: 1e-4 of each output's max (measured <= 1.9e-6).
- Train, f32: 4e-3 of each output's max. Train-mode BatchNorm at random
  init is ill-conditioned in f32 on either side. Against the port's own
  f64 forward (the same function without rounding), flax's f32 outputs
  are 4.5e-4 to 1.2e-3 of the max off here and the port's 1.7e-4 to
  4.5e-4. Layer by layer, flax's batch variances (``E[x^2] - E[x]^2`` in
  f32 on XLA's CPU reductions) drift from the f64 ones 3 to 4 times as
  fast as the port's, from 2e-5 at ``bn1`` to 3e-4 at layer4. So the port
  is held to its f64 forward at 1e-3 and to flax at 4e-3.
- Running statistics after one train-mode forward of the whole model, of
  each tensor's max: 2e-3 against flax (measured <= 5e-4; flax's are up
  to 4.7e-4 from the f64 ones) and 1e-3 against the port's f64 forward
  (measured <= 1.8e-4).
- One train-mode BatchNorm alone against flax's: 1e-5 of the max for the
  output and 1e-6 absolute for the running statistics.
- bf16 compute dtype against flax in bf16, eval: 3e-2 of each output's max
  (measured 9.0e-3 to 1.6e-2: each side rounds every conv's output to
  bf16 on its own).
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.models.deeplabv3 import DeepLabV3TextSeg as JDeepLab
from openess_tpu.models.torch_convert import convert_deeplab
from openess_tpu_torch.models.convert import deeplab_state_dict_from_jax
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg, dropout
from openess_tpu_torch.models.resnet import batch_norm
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

B, H, W, C = 2, 64, 96, 6
EVAL_REL = 1e-4
TRAIN_REL = 4e-3
TRAIN_F64_REL = 1e-3
STATS_REL = 2e-3
STATS_F64_REL = 1e-3
BF16_REL = 3e-2


class _NoDropout(fnn.Module):
    rate: float = 0.0
    deterministic: bool = True

    def __call__(self, x):
        return x


@pytest.fixture(autouse=True)
def no_flax_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", _NoDropout)


def _randomize_bn(params, stats, rng):
    for k in params:
        if isinstance(params[k], dict) and "scale" in params[k]:
            n = params[k]["scale"].shape
            params[k]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            params[k]["bias"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["mean"] = rng.uniform(-0.2, 0.2, n).astype(np.float32)
            stats[k]["var"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
        elif isinstance(params[k], dict) and k in stats:
            _randomize_bn(params[k], stats[k], rng)


@pytest.fixture(scope="module")
def tree():
    """flax variables of a DeepLabV3 with ``linear_probe`` (every
    ``output_stride`` has the same tree), an input and text embeddings."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32)
    text = rng.normal(0, 0.1, (C, 512)).astype(np.float32)
    v = JDeepLab(num_classes=C, linear_probe=True).init(
        jax.random.key(0), jnp.asarray(x), jnp.asarray(text))
    params = jax.tree.map(np.array, dict(v["params"]))
    stats = jax.tree.map(np.array, dict(v["batch_stats"]))
    _randomize_bn(params, stats, rng)
    params["linear_probe"]["bias"] = rng.normal(0, 0.1, C).astype(np.float32)
    return params, stats, x, text


def _without_probe(params):
    return {k: v for k, v in params.items() if k != "linear_probe"}


def _jax_apply(params, stats, x, text, train, dtype=jnp.float32, **kw):
    m = JDeepLab(num_classes=C, dtype=dtype,
                 linear_probe="linear_probe" in params, **kw)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (logits, feats), mut = m.apply(
            variables, jnp.asarray(x), jnp.asarray(text), train=True,
            mutable=["batch_stats"])
        new = jax.tree.map(np.asarray, mut["batch_stats"])
    else:
        logits, feats = m.apply(variables, jnp.asarray(x), jnp.asarray(text))
        new = None
    return np.asarray(logits.astype(jnp.float32)), np.asarray(
        feats.astype(jnp.float32)), new


def _port(params, stats, text, dtype=torch.float32, **kw):
    m = DeepLabV3TextSeg(C, linear_probe="linear_probe" in params,
                         dtype=dtype, **kw)
    m.load_state_dict(deeplab_state_dict_from_jax(params, stats, text),
                      strict=True)
    m.classifier.ASPP.dropout_rate = 0.0
    return m


def _rel(got, ref):
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


def _np(t):
    return t.detach().double().numpy()


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
@pytest.mark.parametrize("output_stride", [8, 16, 32])
def test_deeplab_matches_flax(tree, output_stride, fold, train):
    params, stats, x, text = tree
    params = _without_probe(params)
    kw = dict(output_stride=output_stride, fold_bn=fold)
    jl, jf, jstats = _jax_apply(params, stats, x, text, train, **kw)
    m = _port(params, stats, text, **kw)
    m.train(not train)  # the module flag decides nothing
    with torch.no_grad():
        logits, feats = m(torch.from_numpy(x), train=train)
    assert logits.shape == (B, H, W, C) and feats.shape == (B, H, W, 256)
    assert logits.dtype == feats.dtype == torch.float32
    assert logits.is_contiguous() and feats.is_contiguous()
    if not train:
        assert _rel(_np(logits), jl) <= EVAL_REL
        assert _rel(_np(feats), jf) <= EVAL_REL
        sd = m.state_dict()
        np.testing.assert_array_equal(  # eval leaves the statistics alone
            sd["backbone.bn1.running_var"].numpy(),
            stats["backbone"]["bn1"]["var"])
        return
    m64 = _port(params, stats, text, dtype=torch.float64, **kw).double()
    with torch.no_grad():
        l64, f64 = m64(torch.from_numpy(x).double(), train=True)
    for got, ref, exact in ((logits, jl, l64), (feats, jf, f64)):
        assert _rel(_np(got), ref) <= TRAIN_REL
        assert _rel(_np(got), _np(exact)) <= TRAIN_F64_REL
    # the running statistics took flax's biased-variance update
    want = deeplab_state_dict_from_jax(params, jstats, text)
    exact = m64.state_dict()
    checked = 0
    for k, v in m.state_dict().items():
        if "running" in k:
            for ref, rel in ((want[k], STATS_REL), (exact[k], STATS_F64_REL)):
                scale = float(ref.abs().max())
                assert float((v.double() - ref.double()).abs().max()) \
                    <= rel * scale, k
            checked += 1
    assert checked == 2 * (53 + 7)


@pytest.mark.parametrize("shape", [(2, 1, 1, 256), (1, 1, 1, 256),
                                   (2, 8, 12, 64), (3, 5, 7, 16)], ids=str)
def test_train_batch_norm_matches_flax(shape):
    """flax's train-mode BatchNorm on one tensor: the biased variance
    normalizes and enters the running variance; one value a channel (the
    pooling branch at B = 1) gives the bias."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.3, 1.0, shape).astype(np.float32)
    c = shape[-1]
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, dtype=jnp.float32)
    ref, mut = jbn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"])
    ref = np.asarray(ref)
    bn = torch.nn.BatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = batch_norm(torch.from_numpy(x).permute(0, 3, 1, 2), bn, train=True)
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn, name).numpy(),
            np.asarray(mut["batch_stats"][key]), atol=1e-6)
    n = shape[0] * shape[1] * shape[2]
    if n == 1:
        np.testing.assert_allclose(got[0, 0, 0], bias, atol=1e-6)
        np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0,
                                   rtol=1e-6)
    else:  # the biased variance, where PyTorch's update takes n / (n - 1)
        var = x.reshape(-1, c).var(axis=0)
        np.testing.assert_allclose(bn.running_var.numpy(),
                                   0.9 * var0 + 0.1 * var, rtol=1e-5)


def test_batch_one_train_step_matches_flax(tree):
    """B = 1: the ASPP pooling branch has one value a channel, where
    ``F.batch_norm`` raises and flax returns the bias."""
    params, stats, x, text = tree
    params = _without_probe(params)
    x1 = x[:1]
    jl, jf, jstats = _jax_apply(params, stats, x1, text, True)
    m = _port(params, stats, text)
    with torch.no_grad():
        logits, feats = m(torch.from_numpy(x1), train=True)
    assert _rel(_np(logits), jl) <= TRAIN_REL
    assert _rel(_np(feats), jf) <= TRAIN_REL
    want = deeplab_state_dict_from_jax(params, jstats, text)
    got = m.state_dict()
    for k in ("classifier.ASPP.convs.4.2.running_mean",
              "classifier.ASPP.convs.4.2.running_var"):
        scale = float(want[k].abs().max())
        assert float((got[k] - want[k]).abs().max()) <= STATS_REL * scale
    var0 = stats["classifier"]["aspp"]["bn4"]["var"]
    np.testing.assert_allclose(
        got["classifier.ASPP.convs.4.2.running_var"].numpy(), 0.9 * var0,
        rtol=1e-6)


def test_fold_follows_an_optimizer_step(tree):
    """``fold_bn`` eval after a train step (new weights and new running
    statistics) equals the unfolded eval of the same state: the folded
    weights are refolded, not taken from the first eval."""
    params, stats, x, text = tree
    params = _without_probe(params)
    m = _port(params, stats, text, fold_bn=True)
    tx = torch.from_numpy(x[:, :32, :48].copy())  # the fold is size-blind
    with torch.no_grad():
        first, _ = m(tx)
    opt = torch.optim.AdamW(m.parameters(), lr=1e-3, foreach=True)
    logits, feats = m(tx, train=True)
    (logits.square().mean() + feats.mean()).backward()
    opt.step()
    with torch.no_grad():
        folded, folded_feats = m(tx)
    plain = DeepLabV3TextSeg(C, fold_bn=False)
    plain.load_state_dict(m.state_dict(), strict=True)
    with torch.no_grad():
        want, want_feats = plain(tx)
    assert float((folded - first).abs().max()) > 1e-2 * float(
        first.abs().max())
    assert _rel(_np(folded), _np(want)) <= 1e-5
    assert _rel(_np(folded_feats), _np(want_feats)) <= 1e-5
    # a running-statistics update alone refolds as well
    with torch.no_grad():
        m(tx, train=True)
        plain.load_state_dict(m.state_dict(), strict=True)
        assert _rel(_np(m(tx)[0]), _np(plain(tx)[0])) <= 1e-5


def test_fold_cache_follows_the_compute_dtype(tree):
    """A trunk folded in bf16 and then run in f32 refolds in f32."""
    params, stats, x, text = tree
    params = _without_probe(params)
    m = _port(params, stats, text, dtype=torch.bfloat16, fold_bn=True)
    tx = torch.from_numpy(x[:, :32, :48].copy())
    with torch.no_grad():
        m(tx)
        m.dtype = m.backbone.dtype = torch.float32
        folded = m(tx)[0]
    plain = _port(params, stats, text)
    with torch.no_grad():
        assert _rel(_np(folded), _np(plain(tx)[0])) <= 1e-5


def test_dropout_zeroes_a_tenth_and_scales_the_rest():
    gen = torch.Generator().manual_seed(0)
    x = torch.full((4, 256, 28, 40), 2.0)
    y = dropout(x, 0.1, gen)
    kept = y != 0
    share = 1.0 - float(kept.float().mean())
    assert abs(share - 0.1) <= 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0 / 0.9))
    again = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, again)
    assert dropout(x, 0.0, gen) is x


def test_train_forward_draws_dropout_from_the_generator(tree):
    params, stats, x, text = tree
    params = _without_probe(params)
    sd = deeplab_state_dict_from_jax(params, stats, text)
    tx = torch.from_numpy(x[:, :32, :48].copy())
    outs = []
    for seed in (0, 0, 1):
        m = DeepLabV3TextSeg(C)
        m.load_state_dict(sd, strict=True)
        with torch.no_grad():
            outs.append(m(tx, train=True,
                          generator=torch.Generator().manual_seed(seed))[1])
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])
    m = _port(params, stats, text)
    with torch.no_grad():
        off = m(tx, train=True)[1]
    # dropout acts before the bilinear upsampling: 0.1 of the ASPP
    # features are zeroed, so the outputs differ broadly
    assert float((outs[0] - off).abs().max()) > 0.1 * float(off.abs().max())


def test_linear_probe_logits_match_flax(tree):
    params, stats, x, text = tree
    for dtype, jdtype, rel in ((torch.float32, jnp.float32, EVAL_REL),
                               (torch.bfloat16, jnp.bfloat16, BF16_REL)):
        jl, jf, _ = _jax_apply(params, stats, x, text, False, dtype=jdtype)
        m = _port(params, stats, text, dtype=dtype)
        with torch.no_grad():
            logits, feats = m(torch.from_numpy(x))
        assert logits.dtype == dtype and feats.dtype == torch.float32
        assert _rel(_np(logits), jl) <= rel
        assert _rel(_np(feats), jf) <= rel


@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
def test_bf16_matches_flax_bf16(tree, fold):
    params, stats, x, text = tree
    params = _without_probe(params)
    jl, jf, _ = _jax_apply(params, stats, x, text, False,
                           dtype=jnp.bfloat16, fold_bn=fold)
    m = _port(params, stats, text, dtype=torch.bfloat16, fold_bn=fold)
    with torch.no_grad():
        logits, feats = m(torch.from_numpy(x))
    # every BatchNorm returns f32: the text matmul and the resizes are f32
    assert logits.dtype == feats.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in m.parameters())
    assert _rel(_np(logits), jl) <= BF16_REL
    assert _rel(_np(feats), jf) <= BF16_REL


def test_round_trip_through_convert_deeplab(tree):
    params, stats, _, text = tree
    m = DeepLabV3TextSeg(C, linear_probe=True)
    m.load_state_dict(deeplab_state_dict_from_jax(params, stats, text),
                      strict=True)
    sd = m.state_dict()
    p2, s2, t2 = convert_deeplab(sd)
    np.testing.assert_array_equal(t2, text)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    for ref, got in ((params, p2), (stats, s2)):
        fr, fg = flat(ref), flat(got)
        assert fr.keys() == fg.keys()
        for k in fr:
            np.testing.assert_array_equal(np.asarray(fg[k]), fr[k], str(k))
    assert "classifier.ASPP.convs.4.1.weight" in sd
    assert "classifier.classifier.1.running_var" in sd
    assert "backbone.layer4.2.bn3.running_var" in sd
