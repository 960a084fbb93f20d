"""Dataset factory, the counterpart of ``openess_tpu/data/loaders.py``.

Datasets expose ``__len__`` and ``get_batch(indices) -> dict`` of numpy
arrays in the batch convention of ``training/steps.py``. Only the synthetic
dataset on the raw-event wire is ported.
"""
from __future__ import annotations

from openess_tpu_torch.config.settings import Settings


def build_datasets(s: Settings):
    """``(train, val)`` datasets of the configured name."""
    name = s.dataset_name_b
    if not name.startswith("synthetic"):
        raise NotImplementedError(
            f"dataset {name!r}: reading DSEC and DDD17 from disk is ROADMAP "
            "Queue 1 item 8 (real-data loaders); ported: synthetic_events"
        )
    if s.wire_format != "raw_events":
        raise NotImplementedError(
            "the grid wire needs the exact scatter voxelizers of "
            "ops/voxelize.py: ROADMAP Queue 1 item 9"
        )
    from openess_tpu_torch.data.synthetic import SyntheticESS

    h, w = int(s.img_size_b[0]), int(s.img_size_b[1])

    def make(n, seed):
        ds = SyntheticESS(
            num_samples=n, height=h, width=w,
            num_classes=s.semseg_num_classes,
            num_windows=s.nr_events_data_b,
            superpixel_size=s.superpixel_size, seed=seed,
        )
        ds.get_batch = lambda idx: ds.raw_wire_batch(
            list(idx), num_bins=s.nr_temporal_bins_b, t16=s.wire_t16
        )
        return ds

    return make(32, s.seed), make(8, s.seed + 1)
