"""Optimizer: per-model AdamW groups and the epoch-wise cosine schedule,
the counterpart of ``openess_tpu/training/optim.py``.

One ``torch.optim.AdamW`` with a parameter group per label
(``recon``/``frame``/``voxel`` with ``lr_recon``/``lr_frame``/``lr_voxel``),
betas (0.9, 0.999), eps 1e-8 and ``weight_decay`` on every trainable
parameter; frozen parameters are not in the optimizer. The learning rate
follows torch ``CosineAnnealingLR(T_max=num_epochs)`` stepped per epoch: it
is constant within an epoch.
"""
from __future__ import annotations

import math

import torch

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.training.build import ModelSet, trainable_labels

GROUPS = ("recon", "frame", "voxel")


def epoch_cosine_lr(lr0: float, step: int, steps_per_epoch: int,
                    num_epochs: int) -> float:
    """The learning rate at optimizer step ``step`` (0-based)."""
    epoch = min(step // max(steps_per_epoch, 1), num_epochs)
    return lr0 * 0.5 * (1.0 + math.cos(math.pi * epoch / num_epochs))


def make_optimizer(s: Settings, mset: ModelSet) -> torch.optim.AdamW:
    """AdamW over the trainable parameters of ``mset``, one group per label
    that has any. Each group carries its ``name`` and base rate ``lr0``;
    :func:`set_learning_rates` sets ``lr`` from the step."""
    labels = trainable_labels(mset, s)
    by_group: dict = {g: [] for g in GROUPS}
    for name, m in mset.modules.items():
        for pname, p in m.named_parameters():
            label = labels[f"{name}.{pname}"]
            if label != "frozen":
                by_group[label].append(p)
    lr0 = {"recon": s.lr_recon, "frame": s.lr_frame, "voxel": s.lr_voxel}
    groups = [
        {"params": ps, "lr": lr0[g], "lr0": lr0[g], "name": g}
        for g, ps in by_group.items() if ps
    ]
    return torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=s.weight_decay)


def set_learning_rates(optimizer, step: int, steps_per_epoch: int,
                       num_epochs: int) -> None:
    for g in optimizer.param_groups:
        g["lr"] = epoch_cosine_lr(g["lr0"], step, steps_per_epoch, num_epochs)
