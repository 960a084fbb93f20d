"""Qualitative visualization, the counterpart of ``openess_tpu/utils/
viz.py`` (reference ``utils/viz_utils.py``).

- :func:`colorize_semseg`      label map -> RGB through a class color map;
  ignore pixels render black.
- :func:`event_image`          event tensor -> red(+)/blue(-) RGB.
- :func:`confusion_matrix_png` the raw confusion matrix with a grey
  diagonal, or the row-normalized one with class-name ticks and values.
- :func:`pca_rgb`              features -> 3-component PCA RGB.
- :func:`image_grid`           a batch of RGB images tiled on one canvas.
- :func:`save_png`             uint8 PNG writer.

Everything but :func:`confusion_matrix_png` is a numpy copy of the JAX
package's function and gives its arrays bit for bit. The confusion plots
are drawn with numpy and PIL alone (matplotlib is not needed where the port
runs), so their pixels are not matplotlib's; the matrix each one draws,
:func:`confusion_matrix_values`, is the JAX package's. PIL is imported only
where a PNG is written.
"""
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


def event_image(event_tensor: np.ndarray, separate_pol: bool = False) -> np.ndarray:
    """Voxel/histogram tensor [C, H, W] or [H, W, C] -> red(+)/blue(-) RGB."""
    ev = np.asarray(event_tensor, np.float32)
    if ev.ndim == 3 and ev.shape[-1] <= 16:  # NHWC
        ev = ev.transpose(2, 0, 1)
    if separate_pol:
        half = ev.shape[0] // 2
        pos = ev[:half].sum(0)
        neg = ev[half:].sum(0)
    else:
        summed = ev.sum(0)
        pos = np.maximum(summed, 0)
        neg = np.maximum(-summed, 0)
    h, w = pos.shape
    img = np.ones((h, w, 3), np.float32)
    scale = max(pos.max(), neg.max(), 1e-6)
    img[..., 1] -= (pos + neg) / scale
    img[..., 2] -= pos / scale
    img[..., 0] -= neg / scale
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def confusion_matrix_values(cm: np.ndarray, normalize: bool = False) -> np.ndarray:
    """The matrix :func:`confusion_matrix_png` draws: ``cm`` in f64, or
    each row divided by its sum (an empty row stays zero)."""
    cm = np.asarray(cm, np.float64)
    if normalize:
        cm = cm / np.maximum(cm.sum(axis=1, keepdims=True), 1e-12)
    return cm


# colormap anchors (RGB), interpolated linearly: matplotlib's viridis (the
# default of the raw plot) and Blues (the normalized one)
_VIRIDIS = ((68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98),
            (253, 231, 37))
_BLUES = ((247, 251, 255), (198, 219, 239), (107, 174, 214), (33, 113, 181),
          (8, 48, 107))


def _colormap(v: np.ndarray, stops) -> np.ndarray:
    stops = np.asarray(stops, np.float64)
    pos = np.linspace(0.0, 1.0, len(stops))
    rgb = np.stack([np.interp(v, pos, stops[:, c]) for c in range(3)], -1)
    return np.round(rgb).astype(np.uint8)


def confusion_matrix_png(cm: np.ndarray, path: str, *, normalize: bool = False,
                         class_names=None) -> None:
    """Plot an NxN confusion matrix to ``path``.

    ``normalize=False``: the raw matrix in viridis with a grey diagonal,
    axes "Labels" (columns) and "Predicted" (rows), as
    ``visualizeConfusionMatrix`` (viz_utils.py:76-103). ``normalize=True``:
    the row-normalized matrix in Blues with class-name ticks and each value
    written in its cell (white above half the maximum), axes "Predicted
    label" and "True label", as ``plot_confusion_matrix``
    (viz_utils.py:148-176).
    """
    from PIL import Image, ImageDraw, ImageFont

    m = confusion_matrix_values(cm, normalize)
    n = m.shape[0]
    lo, hi = float(m.min()), float(m.max())
    v = (m - lo) / (hi - lo) if hi > lo else np.zeros_like(m)
    rgb = _colormap(v, _BLUES if normalize else _VIRIDIS)
    cell = max(32, 640 // n) if normalize else max(8, 800 // n)
    font = ImageFont.load_default()
    names = ([str(c) for c in class_names]
             if normalize and class_names is not None
             else [str(i) for i in range(n)])
    probe = ImageDraw.Draw(Image.new("RGB", (1, 1)))

    def size(text):
        x0, y0, x1, y1 = probe.textbbox((0, 0), text, font=font)
        return x1 - x0, y1 - y0

    tick = max(size(s)[0] for s in names)
    line = max(size(s)[1] for s in names + ["Ag"])
    left = tick + 2 * line + 12         # y label, y ticks
    bottom = tick + 2 * line + 12       # x ticks (vertical), x label
    side = n * cell
    img = Image.new("RGB", (left + side + 10, 10 + side + bottom), "white")
    img.paste(Image.fromarray(
        np.repeat(np.repeat(rgb, cell, 0), cell, 1)), (left, 10))
    draw = ImageDraw.Draw(img)
    for i, name in enumerate(names):
        c = 10 + i * cell + cell // 2
        w, h = size(name)
        draw.text((left - 4 - w, c - h // 2), name, fill="black", font=font)
        label = Image.new("RGB", (w + 2, line + 2), "white")
        ImageDraw.Draw(label).text((0, 0), name, fill="black", font=font)
        img.paste(label.rotate(90, expand=True),
                  (left + i * cell + cell // 2 - line // 2, 14 + side))
    xlabel, ylabel = (("Predicted label", "True label") if normalize
                      else ("Labels", "Predicted"))
    w, _ = size(xlabel)
    draw.text((left + (side - w) // 2, 10 + side + tick + line + 8), xlabel,
              fill="black", font=font)
    w, _ = size(ylabel)
    label = Image.new("RGB", (w + 2, line + 2), "white")
    ImageDraw.Draw(label).text((0, 0), ylabel, fill="black", font=font)
    img.paste(label.rotate(90, expand=True), (2, 10 + (side - w) // 2))
    if normalize:
        thresh = hi / 2.0
        for i in range(n):
            for j in range(n):
                text = f"{m[i, j]:.2f}"
                w, h = size(text)
                draw.text(
                    (left + j * cell + (cell - w) // 2,
                     10 + i * cell + (cell - h) // 2), text,
                    fill="white" if m[i, j] > thresh else "black", font=font)
    else:
        draw.line((left, 10, left + side - 1, 10 + side - 1),
                  fill=(128, 128, 128), width=max(1, cell // 16))
    img.save(path)


def pca_rgb(feats: np.ndarray) -> np.ndarray:
    """[B, H, W, C] features -> [B, H, W, 3] uint8 via a 3-component PCA
    over all pixels (base_trainer_ov.py:558-565, NHWC instead of NCHW).
    Components are min-max normalized jointly so relative structure stays."""
    f = np.asarray(feats, np.float32)
    b, h, w, c = f.shape
    flat = f.reshape(-1, c)
    flat = flat - flat.mean(axis=0, keepdims=True)
    # top-3 right singular vectors via the [C, C] covariance eigensystem
    _, vecs = np.linalg.eigh(flat.T @ flat)
    proj = flat @ vecs[:, ::-1][:, :3]  # [B*H*W, 3]
    lo, hi = proj.min(), proj.max()
    proj = (proj - lo) / max(hi - lo, 1e-12)
    return (proj.reshape(b, h, w, 3) * 255).astype(np.uint8)


def image_grid(images: np.ndarray, nrow: int = 4, pad: int = 2) -> np.ndarray:
    """[N, H, W, 3] uint8 -> one [gh, gw, 3] uint8 canvas, ``nrow`` images
    per row (createRGBGrid / torchvision.utils.make_grid semantics)."""
    imgs = np.asarray(images)
    n, h, w, _ = imgs.shape
    rows = (n + nrow - 1) // nrow
    canvas = np.zeros(
        (rows * (h + pad) - pad, nrow * (w + pad) - pad, 3), np.uint8
    )
    for i in range(n):
        r, c = divmod(i, nrow)
        canvas[r * (h + pad) : r * (h + pad) + h,
               c * (w + pad) : c * (w + pad) + w] = imgs[i]
    return canvas


def save_png(path, array: np.ndarray):
    """uint8 PNG writer (PIL is imported here, only when a PNG is written)."""
    from PIL import Image

    Image.fromarray(array).save(path)
