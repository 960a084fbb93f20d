"""Confusion-matrix mIoU / accuracy, the counterpart of
``openess_tpu/ops/confusion.py``."""
from __future__ import annotations

import numpy as np
import torch


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, *,
                     num_classes: int, ignore_label: int = 255) -> torch.Tensor:
    """``[num_classes, num_classes]`` int64 confusion by ``bincount``; rows
    are the ground truth, columns the prediction. Ignored pixels are
    dropped, and so is any pair that falls outside the matrix."""
    c = num_classes
    flat = pred.reshape(-1).long() + c * label.reshape(-1).long()
    keep = (label.reshape(-1) != ignore_label) & (flat >= 0) & (flat < c * c)
    return torch.bincount(flat[keep], minlength=c * c).reshape(c, c)


def confusion_to_iou(conf) -> tuple:
    """(mean IoU %, per-class IoU %) in float64."""
    conf = np.asarray(conf, np.float64)
    diag = np.diagonal(conf)
    denom = np.clip(conf.sum(1) + conf.sum(0) - diag, 1e-12, None)
    iou = 100.0 * diag / denom
    return iou.mean(), iou


def confusion_to_acc(conf):
    """Overall pixel accuracy % in float64."""
    conf = np.asarray(conf, np.float64)
    return 100.0 * np.diagonal(conf).sum() / np.clip(conf.sum(), 1e-12, None)
