"""Dataset factory, the counterpart of ``openess_tpu/data/loaders.py``.

Datasets expose ``__len__`` and ``get_batch(indices) -> dict`` in the batch
convention of ``training/steps.py``: numpy arrays, except the grid wire's
``event`` with ``tpu.host_voxelize: false``, which is made on the device
the datasets are given and stays there. The histogram and the grid
voxelized on the host are numpy, made by the port's host C++
(``native.py``).
"""
from __future__ import annotations

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import Settings

SIDE_KEYS = ("frame", "recon", "label", "pl", "superpixel", "sam_feat")
EVENT_OPTIONS = ("recon2voxel", "frame2voxel")


def build_datasets(s: Settings, device=None):
    """``(train, val)`` datasets of the configured name. ``device`` is where
    the grid wire is voxelized: CUDA unless the caller gives another."""
    device = resolve_device(device)
    name = s.dataset_name_b
    if name.startswith("synthetic"):
        from openess_tpu_torch.data.synthetic import SyntheticESS

        h, w = int(s.img_size_b[0]), int(s.img_size_b[1])

        def make(n, seed):
            return _with_get_batch(SyntheticESS(
                num_samples=n, height=h, width=w,
                num_classes=s.semseg_num_classes,
                num_windows=s.nr_events_data_b,
                superpixel_size=s.superpixel_size, seed=seed,
            ), s, device)

        return make(32, s.seed), make(8, s.seed + 1)
    if name == "DSEC_events":
        from openess_tpu_torch.data.dsec import DSECDataset

        return (DSECDataset(s, split="train", device=device),
                DSECDataset(s, split="val", device=device))
    if name == "DDD17_events":
        from openess_tpu_torch.data.ddd17 import DDD17Dataset

        return (DDD17Dataset(s, split=s.split_train_b, device=device),
                DDD17Dataset(s, split="valid", device=device))
    raise ValueError(f"unknown dataset {name!r}")


def _with_get_batch(ds, s: Settings, device):
    """The synthetic dataset's ``get_batch``: the raw-event wire, or, on the
    grid wire (and for the options without events), its voxelized
    batch."""
    from openess_tpu_torch.training.build import VOXEL_OPTIONS

    bins = s.nr_temporal_bins_b
    if s.config_option in VOXEL_OPTIONS and s.wire_format == "raw_events":
        ds.get_batch = lambda idx: ds.raw_wire_batch(
            list(idx), num_bins=bins, t16=s.wire_t16)
    else:
        ds.get_batch = lambda idx: ds.voxelized_batch(
            list(idx), num_bins=bins, device=device)
    return ds
