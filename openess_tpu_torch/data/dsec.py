"""DSEC-Semantic read from disk: the counterpart of
``openess_tpu/data/dsec.py``.

The host reads ``events.h5`` through :class:`EventSlicer`, rectifies the
events and cuts them into ``nr_events_data`` padded windows; labels, frames,
reconstructions, pseudo-labels and superpixels are PNGs beside them.
``h5py`` and ``PIL`` are imported only where a file is read.

The event keys of a batch (:func:`event_batch`), as the JAX package
builds them:

- ``event_representation: histogram``: ``event``, planar
  ``[B, T, 2, 440, 640]`` f32 count images made on the host
  (``native.event_histogram_windows_host``), whatever the wire;
- ``tpu.wire_format: raw_events``: the C++ packer's sorted-chunk wire
  (``ev_*`` keys, ``data/device_voxelize.py``;
  ``native.chunk_events_windows_host`` on ``num_cpu_workers`` threads),
  voxelized by K1 inside the train step;
- ``grid`` with ``tpu.host_voxelize`` (the default): ``event``, planar
  ``[B, T, bins, 440, 640]`` f32 voxel windows made on the host in one
  native call (``native.voxelize_trilinear_windows_host``);
- ``grid`` with ``host_voxelize: false``: the same windows made on the
  device by K5 (:func:`voxelize_grid`); the tensor stays there, the
  trainer does not copy it back.

Several batches may be assembled at once (``data/pipeline.PrefetchLoader``):
a sequence's ``events.h5`` reads are serialized by its lock, the rest runs
in parallel.
"""
from __future__ import annotations

import os
import threading
from pathlib import Path

import numpy as np
import torch

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.device_voxelize import (
    DSEC_CROP_BOTTOM,
    DSEC_HEIGHT,
    DSEC_WIDTH,
    pack_wire_batch,
    wire_reuse_ok,
)
from openess_tpu_torch.data.event_slicer import EventSlicer
from openess_tpu_torch.data.loaders import EVENT_OPTIONS, SIDE_KEYS
from openess_tpu_torch.data.png import read_png, read_rgb
from openess_tpu_torch.native import (
    chunk_events_windows_host,
    event_histogram_windows_host,
    voxelize_trilinear_windows_host,
)
from openess_tpu_torch.ops.voxelize import normalize_nonzero
from openess_tpu_torch.ops.voxelize_mxu import voxelize_windows_trilinear_mxu

TRAIN_SEQUENCES = [
    "zurich_city_00_a", "zurich_city_01_a", "zurich_city_02_a",
    "zurich_city_04_a", "zurich_city_05_a", "zurich_city_06_a",
    "zurich_city_07_a", "zurich_city_08_a",
]
VAL_SEQUENCES = ["zurich_city_13_a", "zurich_city_14_c", "zurich_city_15_a"]


def voxelize_grid(s: Settings, x, y, p, t, valid, device) -> torch.Tensor:
    """The grid wire's voxel windows, made on ``device``: ``[B, T, K]``
    padded numpy events -> planar ``[B, T, bins, 440, 640]`` f32.

    K5 voxelizes all B * T windows in one launch at the 480x640 sensor;
    with ``normalize_event`` each window then gets the unbiased nonzero
    normalization over its full 480 rows; the bottom 40 rows are cropped.
    ``t`` (float64 us) is cast to f32 on the host, where the JAX package
    casts it at its jit boundary, before the window's first time is
    subtracted."""
    b, n_win, k = x.shape
    bins = s.nr_temporal_bins_b
    ev = [torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device)
          for a in (x, y, p, np.asarray(t, np.float32), valid)]
    g = voxelize_windows_trilinear_mxu(
        *ev, num_windows=b * n_win, num_bins=bins, height=DSEC_HEIGHT,
        width=DSEC_WIDTH).view(b * n_win, bins, DSEC_HEIGHT, DSEC_WIDTH)
    if s.normalize_event_b:
        g = normalize_nonzero(g, unbiased=True, dims=(1, 2, 3))
    g = g[:, :, :DSEC_HEIGHT - DSEC_CROP_BOTTOM]
    return g.reshape((b, n_win) + g.shape[1:])


def event_batch(s: Settings, windows, device) -> dict:
    """The event keys of a batch from its samples' padded windows: a list
    of :meth:`DSECSequence.load_events` results, ``(x, y, p, t, valid)``
    each ``[T, K]``. The wire's buffers are recycled
    (``device_voxelize.wire_reuse_ok``) only for a CUDA ``device``."""
    b, n_win = len(windows), s.nr_events_data_b
    k = windows[0][0].shape[1]
    stacked = [np.stack([w[i] for w in windows]) for i in range(5)]
    x, y, p, t, valid = (a.reshape(b * n_win, k) for a in stacked)
    H, W, ho = DSEC_HEIGHT, DSEC_WIDTH, DSEC_HEIGHT - DSEC_CROP_BOTTOM
    norm = 1 if s.normalize_event_b else 0
    workers = s.num_cpu_workers
    if s.event_representation_b == "histogram":
        g = event_histogram_windows_host(
            x, y, p, valid.sum(axis=1), H, W, norm_mode=norm,
            n_threads=workers)
        return {"event": np.ascontiguousarray(g[:, :, :ho]).reshape(
            b, n_win, 2, ho, W)}
    if s.wire_format == "raw_events":
        wire = chunk_events_windows_host(
            x, y, p, t, valid, height=H, width=W, n_threads=workers,
            reuse_buffers=wire_reuse_ok(device), t16=s.wire_t16)
        return pack_wire_batch(wire, b, n_win)
    if s.host_voxelize:
        bins = s.nr_temporal_bins_b
        g = voxelize_trilinear_windows_host(
            x, y, p, t, valid.sum(axis=1), bins, H, W,
            crop_bottom=DSEC_CROP_BOTTOM, norm_mode=norm, n_threads=workers,
            layout="chw")
        return {"event": g.reshape(b, n_win, bins, ho, W)}
    return {"event": voxelize_grid(s, *stacked, device)}


class DSECSequence:
    """One recording: the label list with its warm-up trim and
    ``skip_ratio`` subset, the events.h5 slicer, the rectify map and the
    side channels' path substitutions."""

    HEIGHT, WIDTH = DSEC_HEIGHT, DSEC_WIDTH

    def __init__(self, seq_path, mode: str, s: Settings, skip_ratio: int):
        import h5py

        self.seq_path = Path(seq_path)
        self.mode = mode
        self.s = s
        self.num_classes = s.semseg_num_classes
        remove_time_window = 250

        ts_file = self.seq_path / "semantic" / "semantic_timestamps.txt"
        self.timestamps = np.loadtxt(str(ts_file), dtype="int64")[6:]
        label_dir = (self.seq_path / "semantic" / "left"
                     / f"{self.num_classes}classes")
        labels = sorted(str(e) for e in label_dir.iterdir()
                        if e.name.endswith(".png"))
        if len(labels) != self.timestamps.size:
            raise ValueError(
                f"{label_dir}: {len(labels)} labels for "
                f"{self.timestamps.size} timestamps")

        trim = (remove_time_window // 100 + 1) * 2
        self.timestamps = self.timestamps[trim:]
        labels = labels[trim:]
        if skip_ratio != 1:
            new_len = len(labels) // skip_ratio
            self.timestamps = self.timestamps[:new_len + 1]
            labels = labels[:new_len + 1]
        self.label_paths = labels

        ev_dir = self.seq_path / "events" / "left"
        self._h5f = h5py.File(str(ev_dir / "events.h5"), "r")
        self.slicer = EventSlicer(self._h5f)
        # an h5py file is not safe for concurrent reads: the loader's
        # workers take turns here
        self._h5_lock = threading.Lock()
        with h5py.File(str(ev_dir / "rectify_map.h5"), "r") as f:
            self.rectify_map = f["rectify_map"][()]  # [480, 640, 2]

    def __len__(self):
        return self.timestamps.size

    def close(self):
        self._h5f.close()

    def load_events(self, index):
        """Padded ``(x, y, p, t, valid)``, each ``[T, K]``, rectified: the
        loaded events divided into ``nr_events_data`` equal-count windows
        (the remainder dropped), each keeping its last ``K``, or with
        ``fixed_duration`` T slices of equal duration. ``t`` stays float64
        (us); the padded tail repeats the window's last time."""
        s = self.s
        T, K = s.nr_events_data_b, s.nr_events_window_b
        ts_end = int(self.timestamps[index])

        if s.fixed_duration_b:
            delta_us = T * s.delta_t_per_data_b * 1000
            ts_start = ts_end - delta_us
            per = delta_us / T
            with self._h5_lock:
                chunks = [
                    self.slicer.get_events(int(ts_start + i * per),
                                           int(ts_start + (i + 1) * per))
                    for i in range(T)
                ]
        else:
            with self._h5_lock:
                ev = self.slicer.get_events_fixed_num(ts_end, T * K)
            n_loaded = ev["t"].size
            per = n_loaded // T
            chunks = [{k: v[i * per:(i + 1) * per] for k, v in ev.items()}
                      for i in range(T)]

        x = np.zeros((T, K), np.float32)
        y = np.zeros((T, K), np.float32)
        p = np.zeros((T, K), np.float32)
        t = np.zeros((T, K), np.float64)
        valid = np.zeros((T, K), bool)
        for i, ev in enumerate(chunks):
            if ev is None or ev["t"].size == 0:
                continue
            n = min(ev["t"].size, K)
            xi = ev["x"][-n:].astype(np.int64)
            yi = ev["y"][-n:].astype(np.int64)
            rect = self.rectify_map[yi, xi]
            x[i, :n] = rect[:, 0]
            y[i, :n] = rect[:, 1]
            p[i, :n] = ev["p"][-n:]
            t[i, :n] = ev["t"][-n:]
            t[i, n:] = t[i, n - 1]
            valid[i, :n] = True
        return x, y, p, t, valid

    def load_sample(self, index) -> dict:
        """The side channels of label ``index``."""
        s = self.s
        file_path = self.label_paths[index]
        label = read_png(file_path).astype(np.int32)
        out = {"label": label, "file_path": file_path}
        cls_dir = f"{self.num_classes}classes/"

        opt = s.config_option
        if opt in ("frame2voxel", "frame2recon"):
            fp = file_path.replace("/semantic/left/", "/images_aligned/left/")
            fp = fp.split("left/")[0] + "left/" + os.path.basename(file_path)
            out["frame"] = read_rgb(fp)
        if opt in ("recon2voxel", "frame2recon"):
            rp = file_path.replace("/semantic/left/", "/reconstructions/left/")
            rp = rp.split("left/")[0] + "left/" + os.path.basename(file_path)
            out["recon"] = read_rgb(rp)

        if self.mode == "train" and s.pl_sources:
            pp = file_path.replace("semantic/", s.pl_sources + "/")
            out["pl"] = read_png(pp.replace(cls_dir, "")).astype(np.int32)
        else:
            out["pl"] = np.ones_like(label)

        if len(s.superpixel_sources) > 1:
            sp = file_path.replace("semantic/", s.superpixel_sources + "/")
            sp = sp.replace(cls_dir, "")
            if s.superpixel_sources.split("_")[1] == "slic":
                sp = sp.replace(".png", "_slic_100.png")
            out["superpixel"] = read_png(sp).astype(np.int32)
        else:
            out["superpixel"] = np.ones_like(label)

        out["sam_feat"] = np.ones((64, 64, 256), np.float32)
        return out


class DSECDataset:
    """The sequences of a split under ``dataset_path`` (train: the
    ``TRAIN_SEQUENCES`` under ``train/`` at ``skip_ratio``; val: the
    ``VAL_SEQUENCES`` under ``test/`` at skip ratio 2) concatenated.
    ``device`` is where the grid wire is voxelized (CUDA unless given)."""

    def __init__(self, s: Settings, split: str = "train", device=None):
        self.s = s
        self.split = split
        self.device = resolve_device(device)
        root = Path(s.dataset_path_b)
        if split == "train":
            base, names, skip = root / "train", TRAIN_SEQUENCES, s.skip_ratio
        else:
            base, names, skip = root / "test", VAL_SEQUENCES, 2
        self.sequences = [
            DSECSequence(child, split, s, skip)
            for child in sorted(base.iterdir())
            if any(k in str(child) for k in names)
        ]
        if not self.sequences:
            raise FileNotFoundError(f"no DSEC {split} sequences under {base}")
        self._offsets = np.cumsum([0] + [len(q) for q in self.sequences])

    def __len__(self):
        return int(self._offsets[-1])

    def close(self):
        for q in self.sequences:
            q.close()

    def _locate(self, idx):
        si = int(np.searchsorted(self._offsets, idx, side="right") - 1)
        return self.sequences[si], idx - self._offsets[si]

    def get_batch(self, indices) -> dict:
        """Side channels stacked as numpy arrays, and the event keys of
        :func:`event_batch` (on the grid wire, a tensor on the device)."""
        needs_events = self.s.config_option in EVENT_OPTIONS
        samples, windows = [], []
        for idx in indices:
            seq, li = self._locate(int(idx))
            samples.append(seq.load_sample(li))
            if needs_events:
                windows.append(seq.load_events(li))
        batch = {k: np.stack([sm[k] for sm in samples])
                 for k in SIDE_KEYS if k in samples[0]}
        if needs_events:
            batch.update(event_batch(self.s, windows, self.device))
        return batch
