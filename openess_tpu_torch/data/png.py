"""PNG side channels of the on-disk datasets. ``PIL`` is imported only
where a file is read."""
from __future__ import annotations

import numpy as np


def read_png(path) -> np.ndarray:
    """A PNG's pixel array as stored (labels, pseudo-labels,
    superpixels)."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def read_rgb(path) -> np.ndarray:
    """An RGB or grey (repeated to 3 channels) PNG as f32 ``[H, W, 3]`` in
    [0, 1] (frames, reconstructions)."""
    arr = read_png(path).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    return arr[..., :3]


def read_png_nearest(path, w: int, h: int) -> np.ndarray:
    """A PNG resized nearest to ``w`` x ``h``, as int32."""
    from PIL import Image

    return np.asarray(Image.fromarray(read_png(path)).resize(
        (w, h), Image.NEAREST)).astype(np.int32)
