"""The port's qualitative dumps against the JAX package's on the CPU.

- ``event_image``, ``pca_rgb`` and ``image_grid`` give the JAX package's
  arrays bit for bit (no tolerance; measured: equal).
- The confusion plots: the matrix each one draws
  (``confusion_matrix_values``) equals the one JAX's
  ``confusion_matrix_png`` computes, bit for bit; the PNGs themselves are
  drawn with PIL, not matplotlib, so only their decoding is checked.
- ``Trainer.val_epoch`` with ``vis_dir`` writes the five files the JAX
  trainer writes (``tests/test_viz.py``), on a raw-wire batch (the previews
  voxelized by K1's plain version), a grid-wire one and a histogram one
  (32x48, T = 2, 6 classes, f32).
"""
import numpy as np
import pytest
from PIL import Image

from openess_tpu.utils import viz as jviz
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.training.trainer import Trainer
from openess_tpu_torch.utils import viz

JAX_FILES = ("confusion_e000.png", "confusion_norm_e000.png",
             "semseg_pred_gt_e000.png", "event_preview_e000.png",
             "pca_latent_e000.png")


@pytest.mark.parametrize("shape,separate_pol", [
    ((5, 16, 20), False), ((10, 16, 20), True), ((16, 20, 5), False),
    ((12, 30, 2), True), ((2, 7, 9), False)])
def test_event_image_matches_jax(shape, separate_pol):
    ev = np.random.default_rng(len(shape) + shape[0]).normal(
        size=shape).astype(np.float32)
    ev[np.abs(ev) < 0.5] = 0
    np.testing.assert_array_equal(
        viz.event_image(ev, separate_pol=separate_pol),
        jviz.event_image(ev, separate_pol=separate_pol))


@pytest.mark.parametrize("shape", [(1, 8, 8, 16), (4, 12, 10, 256),
                                   (2, 5, 7, 3)])
def test_pca_rgb_matches_jax(shape):
    f = np.random.default_rng(shape[-1]).normal(size=shape).astype(
        np.float32)
    f[:, : shape[1] // 2] += 3.0
    np.testing.assert_array_equal(viz.pca_rgb(f), jviz.pca_rgb(f))


@pytest.mark.parametrize("n,nrow,pad", [(4, 2, 1), (8, 4, 2), (3, 4, 0),
                                        (5, 2, 3)])
def test_image_grid_matches_jax(n, nrow, pad):
    imgs = np.random.default_rng(n).integers(
        0, 256, (n, 6, 9, 3)).astype(np.uint8)
    np.testing.assert_array_equal(viz.image_grid(imgs, nrow, pad),
                                  jviz.image_grid(imgs, nrow, pad))


@pytest.mark.parametrize("normalize", [False, True])
def test_confusion_matrices_match_jax(tmp_path, normalize):
    cm = np.random.default_rng(3).integers(0, 100, (11, 11)).astype(np.int64)
    cm[4] = 0  # an empty row
    # the JAX function's arithmetic (utils/viz.py confusion_matrix_png)
    ref = np.asarray(cm, np.float64)
    if normalize:
        ref = ref / np.maximum(ref.sum(axis=1, keepdims=True), 1e-12)
    got = viz.confusion_matrix_values(cm, normalize)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, ref)
    path = tmp_path / "cm.png"
    viz.confusion_matrix_png(cm, str(path), normalize=normalize,
                             class_names=[f"class{i}" for i in range(11)])
    with Image.open(path) as im:
        rgb = np.asarray(im.convert("RGB"))
    assert rgb.shape[0] > 11 * 8 and rgb.shape[1] > 11 * 8
    assert len(np.unique(rgb.reshape(-1, 3), axis=0)) > 11


class _Adapter:
    def __init__(self, ds, make):
        self.ds, self.make = ds, make

    def __len__(self):
        return len(self.ds)

    def get_batch(self, idx):
        return self.make(self.ds, list(idx))


@pytest.mark.parametrize("wire", ["raw_events", "grid", "histogram"])
def test_val_epoch_writes_the_jax_files(tmp_path, wire):
    kw = dict(event_representation_b="histogram") if wire == "histogram" \
        else {}
    s = Settings(
        dataset_name_b="synthetic_events", img_size_b=(32, 48),
        semseg_num_classes=6, nr_events_data_b=2, compute_dtype="float32",
        config_option="frame2voxel", if_finetuning=True,
        if_pretraining=False, batch_size_b=2, vis_dir=str(tmp_path), **kw)
    ds = SyntheticESS(num_samples=3, height=32, width=48, num_classes=6,
                      num_windows=2, events_per_window=500)
    if wire == "raw_events":
        make = lambda d, idx: d.raw_wire_batch(idx)
    elif wire == "grid":
        make = lambda d, idx: d.voxelized_batch(idx)
    else:
        def make(d, idx):
            b = d.voxelized_batch(idx)
            b["event"] = b["event"][:, :, :2].abs()  # (neg, pos) counts
            return b
    trainer = Trainer(s, _Adapter(ds, make), _Adapter(ds, make),
                      device="cpu")
    summary = trainer.val_epoch()
    assert "miou" in summary
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(JAX_FILES)
    for name in JAX_FILES:
        with Image.open(tmp_path / name) as im:
            assert np.asarray(im).ndim == 3
    with Image.open(tmp_path / "event_preview_e000.png") as im:
        assert np.asarray(im).shape == (32, 2 * 48 + 2, 3)
