"""Semantic-segmentation metric accumulator, the counterpart of
``openess_tpu/metrics.py``."""
from __future__ import annotations

import numpy as np
import torch

from openess_tpu_torch.ops.confusion import (
    confusion_matrix,
    confusion_to_acc,
    confusion_to_iou,
)


class MetricsSemseg:
    """Accumulates a confusion matrix over batches; the summary gives
    per-class IoU, mIoU and accuracy."""

    def __init__(self, num_classes: int, ignore_label: int, class_names):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.class_names = list(class_names)
        self.reset()

    def reset(self):
        self._conf = np.zeros((self.num_classes, self.num_classes), np.int64)

    def update_batch(self, pred_lbl, gt_lbl):
        conf = confusion_matrix(
            torch.as_tensor(pred_lbl), torch.as_tensor(gt_lbl),
            num_classes=self.num_classes, ignore_label=self.ignore_label,
        )
        self._conf += conf.cpu().numpy()

    def get_metrics_summary(self) -> dict:
        miou, per_class = confusion_to_iou(self._conf)
        out = {n: float(v) for n, v in zip(self.class_names, per_class)}
        out["miou"] = float(miou)
        out["acc"] = float(confusion_to_acc(self._conf))
        out["cm"] = self._conf.copy()
        return out
