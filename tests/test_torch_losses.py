"""Every loss of the port against its JAX function on the same numpy
inputs, and the confusion matrix / mIoU / accuracy against
``openess_tpu/ops/confusion.py`` and ``metrics.py``.

Tolerances: f32 logits 1e-5 relative (measured <= 5e-7; both sides compute
in f32, the reductions differ in order); bf16 logits the same 1e-5, since
both sides upcast the same bf16 values to f32 first; gradients 1e-6
absolute on per-element gradients of a mean loss; integer confusion counts
exact, mIoU and accuracy 1e-9 (float64 on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu import losses as jl
from openess_tpu.metrics import MetricsSemseg as JMetrics
from openess_tpu.ops import confusion as jconf
from openess_tpu_torch import losses as tl
from openess_tpu_torch.metrics import MetricsSemseg
from openess_tpu_torch.ops import confusion as tconf
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

C = 6
REL = 1e-5


def _logits_labels(seed, kind):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(2, 9, 11, C)) * 3).astype(np.float32)
    labels = rng.integers(0, C, (2, 9, 11)).astype(np.int32)
    if kind == "ignore":
        labels[rng.random(labels.shape) < 0.3] = 255
    elif kind == "out_of_range":
        labels[0, :3] = C + 2
        labels[1, 0, :4] = -1
        labels[1, 1, :4] = 255
    elif kind == "all_ignored":
        labels[:] = 255
    return logits, labels


def _close(got, ref, rel=REL):
    got, ref = float(got), float(ref)
    assert np.isfinite(got)
    assert abs(got - ref) <= rel * max(abs(ref), 1e-3), (got, ref)


KINDS = ["plain", "ignore", "out_of_range", "all_ignored"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", ["cross_entropy", "dice_loss", "task_loss"])
def test_segmentation_losses(name, kind):
    logits, labels = _logits_labels(0, kind)
    kw = {} if name == "cross_entropy" else {"num_classes": C}
    ref = getattr(jl, name)(jnp.asarray(logits), jnp.asarray(labels), **kw)
    got = getattr(tl, name)(torch.from_numpy(logits),
                            torch.from_numpy(labels), **kw)
    assert got.dtype == torch.float32 and got.ndim == 0
    _close(got, ref)
    if kind == "all_ignored" and name == "cross_entropy":
        assert float(got) == 0.0


@pytest.mark.parametrize("name", ["cross_entropy", "dice_loss"])
def test_segmentation_loss_gradients(name):
    logits, labels = _logits_labels(1, "out_of_range")
    kw = {} if name == "cross_entropy" else {"num_classes": C}
    jg = jax.grad(lambda a: getattr(jl, name)(a, jnp.asarray(labels), **kw))(
        jnp.asarray(logits))
    t = torch.from_numpy(logits).requires_grad_(True)
    getattr(tl, name)(t, torch.from_numpy(labels), **kw).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg), atol=1e-6)


def test_task_loss_selects_its_terms():
    logits, labels = _logits_labels(2, "ignore")
    for sel in (("dice",), ("cross_entropy",), ()):
        ref = jl.task_loss(jnp.asarray(logits), jnp.asarray(labels),
                           num_classes=C, losses=sel)
        got = tl.task_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                           num_classes=C, losses=sel)
        _close(got, ref)


@pytest.mark.parametrize("name", ["cross_entropy", "dice_loss"])
def test_bf16_logits_compute_in_f32(name):
    logits, labels = _logits_labels(3, "ignore")
    kw = {} if name == "cross_entropy" else {"num_classes": C}
    jb = jnp.asarray(logits).astype(jnp.bfloat16)
    tb = torch.from_numpy(logits).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(jb.astype(jnp.float32)),
                                  tb.float().numpy())
    ref = getattr(jl, name)(jb, jnp.asarray(labels), **kw)
    got = getattr(tl, name)(tb, torch.from_numpy(labels), **kw)
    assert got.dtype == torch.float32
    _close(got, ref)


def test_cross_entropy_with_a_minus_inf_logit():
    """A masked (-inf) logit away from the target must not poison the loss."""
    logits, labels = _logits_labels(4, "plain")
    labels[:] = np.where(labels == 2, 3, labels)
    logits[..., 2] = -np.inf
    ref = jl.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    got = tl.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    _close(got, ref)


def test_nce_loss_value_and_gradient():
    rng = np.random.default_rng(5)
    k = rng.normal(size=(40, 16)).astype(np.float32)
    q = rng.normal(size=(40, 16)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    ref, (gk, gq) = jax.value_and_grad(
        lambda a, b: jl.nce_loss(a, b, temperature=0.07), argnums=(0, 1)
    )(jnp.asarray(k), jnp.asarray(q))
    tk = torch.from_numpy(k).requires_grad_(True)
    tq = torch.from_numpy(q).requires_grad_(True)
    got = tl.nce_loss(tk, tq, temperature=0.07)
    got.backward()
    _close(got, ref)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(gk), atol=1e-5)
    np.testing.assert_allclose(tq.grad.numpy(), np.asarray(gq), atol=1e-5)
    # bf16 inputs are upcast, not multiplied in bf16
    ref16 = jl.nce_loss(jnp.asarray(k, jnp.bfloat16), jnp.asarray(q, jnp.bfloat16))
    got16 = tl.nce_loss(tk.detach().to(torch.bfloat16),
                        tq.detach().to(torch.bfloat16))
    _close(got16, ref16, rel=1e-4)


@pytest.mark.parametrize("name", ["cosine_distill", "sym_js_div"])
def test_distillation_losses(name):
    rng = np.random.default_rng(6)
    a = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    b = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    a[0, 0, 0] = 0.0  # a zero vector: the clamped denominator
    ref = getattr(jl, name)(jnp.asarray(a), jnp.asarray(b))
    got = getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, ref)
    ref1 = getattr(jl, name)(jnp.asarray(a), jnp.asarray(b), axis=1)
    got1 = getattr(tl, name)(torch.from_numpy(a), torch.from_numpy(b), axis=1)
    _close(got1, ref1)


def _pred_label(seed):
    rng = np.random.default_rng(seed)
    pred = rng.integers(0, C, (3, 13, 17)).astype(np.int32)
    label = rng.integers(0, C, (3, 13, 17)).astype(np.int32)
    label[rng.random(label.shape) < 0.2] = 255
    return pred, label


def test_confusion_matrix_and_summaries():
    pred, label = _pred_label(7)
    ref = np.asarray(jconf.confusion_matrix(
        jnp.asarray(pred), jnp.asarray(label), num_classes=C))
    got = tconf.confusion_matrix(torch.from_numpy(pred),
                                 torch.from_numpy(label), num_classes=C)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got.sum().item() == (label != 255).sum()
    miou, per = tconf.confusion_to_iou(got.numpy())
    jmiou, jper = jconf.confusion_to_iou(ref)
    assert abs(miou - jmiou) <= 1e-9
    np.testing.assert_allclose(per, jper, atol=1e-9)
    assert abs(tconf.confusion_to_acc(got.numpy())
               - jconf.confusion_to_acc(ref)) <= 1e-9
    assert per.dtype == np.float64


def test_metrics_accumulator_matches_jax():
    names = [f"c{i}" for i in range(C)]
    jm, tm = JMetrics(C, 255, names), MetricsSemseg(C, 255, names)
    for seed in (8, 9):
        pred, label = _pred_label(seed)
        jm.update_batch(jnp.asarray(pred), jnp.asarray(label))
        tm.update_batch(torch.from_numpy(pred), torch.from_numpy(label))
    js, ts = jm.get_metrics_summary(), tm.get_metrics_summary()
    assert js.keys() == ts.keys()
    np.testing.assert_array_equal(ts["cm"], js["cm"])
    for k in js:
        if k != "cm":
            assert abs(ts[k] - js[k]) <= 1e-9, k
    tm.reset()
    assert tm.get_metrics_summary()["cm"].sum() == 0
