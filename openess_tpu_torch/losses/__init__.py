"""Training losses, ported from ``openess_tpu/losses/__init__.py``.

Layout is NHWC: logits ``[B, H, W, C]``, integer labels ``[B, H, W]``.
Every loss computes in f32 whatever the logits' dtype and returns an f32
scalar.

- :func:`task_loss`       Dice + CE combination
- :func:`dice_loss`       multi-class Dice with ignore masking
- :func:`cross_entropy`   mean CE with ignore_index
- :func:`nce_loss`        PointInfoNCE over pooled segment features
- :func:`sym_js_div`      symmetric JS divergence
- :func:`cosine_distill`  ``mean(1 - cos(a, b))`` feature distillation
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                  ignore_index: int = 255) -> torch.Tensor:
    """Mean cross-entropy over the valid pixels. Out-of-range labels
    (``< 0`` or ``>= C``) count as ignored: they leave both the numerator
    and the valid-pixel denominator. An all-ignored batch gives 0."""
    num_classes = logits.shape[-1]
    valid = (labels != ignore_index) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, safe[..., None])[..., 0]
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum() / valid.sum().clamp_min(1)


def dice_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, ignore_index: int = 255,
              smooth: float = 1.0, p: float = 2.0) -> torch.Tensor:
    """Multi-class Dice with the reference reduction: per class
    ``1 - (2 sum(pred * onehot) + s) / (sum(pred^p + onehot^p) + s)`` with
    the sums over the whole batch, then summed and divided by
    ``num_classes``. Ignored pixels are zeroed in both tensors."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    validf = valid[..., None].float()
    # a label outside [0, C) has an all-zero one-hot row
    in_range = (safe >= 0) & (safe < num_classes)
    onehot = F.one_hot(
        torch.where(in_range, safe, torch.zeros_like(safe)), num_classes
    ).float() * in_range[..., None].float() * validf
    probs = F.softmax(logits.float(), dim=-1) * validf
    axes = tuple(range(logits.ndim - 1))
    num = 2.0 * (probs * onehot).sum(dim=axes) + smooth
    den = (probs ** p + onehot ** p).sum(dim=axes) + smooth
    return (1.0 - num / den).sum() / num_classes


def task_loss(logits: torch.Tensor, labels: torch.Tensor, *,
              num_classes: int, ignore_index: int = 255,
              losses: tuple = ("dice", "cross_entropy")) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=logits.device)
    if "dice" in losses:
        total = total + dice_loss(logits, labels, num_classes=num_classes,
                                  ignore_index=ignore_index)
    if "cross_entropy" in losses:
        total = total + cross_entropy(logits, labels,
                                      ignore_index=ignore_index)
    return total


def nce_loss(k: torch.Tensor, q: torch.Tensor, *,
             temperature: float = 0.07) -> torch.Tensor:
    """PointInfoNCE: CE over ``k @ q.T / T`` with diagonal targets."""
    logits = (k.float() @ q.float().t()) / temperature
    return -torch.diagonal(F.log_softmax(logits, dim=-1)).mean()


def sym_js_div(pred: torch.Tensor, target: torch.Tensor, *,
               axis: int = -1) -> torch.Tensor:
    """``0.5 KL(sm(t) || sm(p)) + 0.5 KL(sm(p) || sm(t))`` with torch
    ``KLDivLoss('mean')`` semantics: the pointwise integrand averaged over
    all elements."""

    def kl_mean(log_p, q):
        return (q * (torch.log(q) - log_p)).mean()

    sp = F.softmax(pred.float(), dim=axis).clamp_min(1e-10)
    st = F.softmax(target.float(), dim=axis).clamp_min(1e-10)
    return 0.5 * kl_mean(torch.log(sp), st) + 0.5 * kl_mean(torch.log(st), sp)


def cosine_distill(teacher: torch.Tensor, student: torch.Tensor, *,
                   axis: int = -1) -> torch.Tensor:
    """``mean(1 - cosine_similarity)`` along ``axis`` (feature channels)."""
    t, s = teacher.float(), student.float()
    num = (t * s).sum(dim=axis)
    den = torch.linalg.vector_norm(t, dim=axis) * torch.linalg.vector_norm(
        s, dim=axis)
    return (1.0 - num / den.clamp_min(1e-8)).mean()
