"""Label-map visualization (the part of ``openess_tpu/utils/viz.py`` the
streaming server uses; reference ``utils/viz_utils.py``)."""
from __future__ import annotations

import numpy as np


def colorize_semseg(labels: np.ndarray, color_map: np.ndarray,
                    ignore_label: int = 255) -> np.ndarray:
    """[H, W] int labels -> [H, W, 3] uint8; ignore pixels render black."""
    labels = np.asarray(labels)
    out = np.zeros((*labels.shape, 3), np.uint8)
    valid = labels != ignore_label
    safe = np.where(valid, labels, 0).astype(np.int64)
    safe = np.clip(safe, 0, len(color_map) - 1)
    out[valid] = color_map[safe[valid]]
    return out


def save_png(path, array: np.ndarray):
    """uint8 PNG writer (PIL is imported here, only when a PNG is written)."""
    from PIL import Image

    Image.fromarray(array).save(path)
