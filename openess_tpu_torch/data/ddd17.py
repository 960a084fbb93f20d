"""DDD17-Seg: the counterpart of ``openess_tpu/data/ddd17.py``.

The sensor is 260x346. Events live in memmapped files (``events.dat.t``
int64 ``[N, 1]``, ``events.dat.xyp`` int16 ``[N, 3]``) with
``index/index_{10,50,250}ms.npy`` maps from image to event index; the
labels, frames, pseudo-labels and superpixels are PNGs, and ``PIL`` is
imported only where one is read. Voxel grids are resized bilinearly
(``align_corners=True``) to 260x352 and their bottom 60 rows cropped,
giving 200x352; labels, pseudo-labels and superpixels are resized nearest
straight to 352x200.

A sample's events are the slice of the memmaps before its image
(:func:`extract_events`), split into T padded windows
(:func:`split_event_windows`). The event keys of a batch
(:func:`event_batch`), as the JAX package builds them:

- ``event_representation: histogram``, or ``tpu.wire_format: grid`` with
  ``tpu.host_voxelize`` (the default): ``event``, planar
  ``[B, T, C, 200, 352]`` f32 made on the host (:func:`host_voxelize`:
  the native count images or bilinear-in-time grids, resized and
  cropped);
- ``raw_events``: the C++ packer's sorted-chunk wire (:func:`wire_batch`),
  voxelized by K4 inside the train step (``data/device_voxelize.py``);
- ``grid`` with ``host_voxelize: false``: ``event``, planar
  ``[B, T, Cout, 200, 352]`` f32 voxel windows made on the device by K6
  (:func:`voxelize_grid`).
"""
from __future__ import annotations

import glob
import os
from os.path import basename, dirname, join

import numpy as np
import torch
import torch.nn.functional as F

from openess_tpu_torch import resolve_device
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.device_voxelize import (
    pack_wire_batch,
    wire_reuse_ok,
)
from openess_tpu_torch.data.loaders import EVENT_OPTIONS, SIDE_KEYS
from openess_tpu_torch.data.png import read_png_nearest, read_rgb
from openess_tpu_torch.native import (
    chunk_events_windows_host,
    event_histogram_windows_host,
    voxelize_bilinear_t_windows_host,
)
from openess_tpu_torch.ops.resize import resize_bilinear
from openess_tpu_torch.ops.voxelize import normalize_nonzero
from openess_tpu_torch.ops.voxelize_mxu import voxelize_windows_bilinear_t_mxu

HEIGHT, WIDTH = 260, 346
RESIZE_W = 352
CROP_BOTTOM = 60  # -> 200 rows


def get_split(dirs, split):
    """The recording directories of a split: ``train`` takes dir0 and
    dir2..dir5, ``valid`` dir1."""
    return {
        "train": [dirs[0], dirs[2], dirs[3], dirs[4], dirs[5]],
        "valid": [dirs[1]],
    }[split]


def load_dir(directory: str, t_interval: int):
    """``(index map, t memmap [N, 1] int64, xyp memmap [N, 3] int16)`` of a
    recording; the index map is the one of ``t_interval`` ms (10 or 250),
    else the 50 ms one."""
    idx_name = {10: "index_10ms.npy", 250: "index_250ms.npy"}.get(
        t_interval, "index_50ms.npy")
    img_ts_event_idx = np.load(join(directory, "index", idx_name))
    t_file = join(directory, "events.dat.t")
    n = int(os.path.getsize(t_file) / 8)
    t_events = np.memmap(t_file, dtype="int64", mode="r", shape=(n, 1))
    xyp = np.memmap(join(directory, "events.dat.xyp"), dtype="int16",
                    mode="r", shape=(n, 3))
    return img_ts_event_idx, t_events, xyp


def extract_events(t_events, xyp, img_idx, index_map, fixed_duration,
                   nr_events):
    """``[N, 4]`` int64 ``(x, y, t, p)`` rows of image ``img_idx``: the
    ``nr_events`` events before the image's event index, or, with
    ``fixed_duration``, those from the index map's start index on.
    ``t_events`` is ``[N, 1]`` int64, ``xyp`` ``[N, 3]`` int16."""
    if fixed_duration:
        _, event_idx, before = index_map[img_idx]
        before = max(int(before), 0)
    else:
        _, event_idx, _ = index_map[img_idx]
        before = max(int(event_idx) - nr_events, 0)
    event_idx = int(event_idx)
    ev = np.concatenate(
        [
            np.array(t_events[before:event_idx], dtype="int64"),
            np.array(xyp[before:event_idx], dtype="int64"),
        ],
        -1,
    )
    return ev[:, [1, 2, 0, 3]]


def split_event_windows(events, num_windows: int, window_events: int,
                        fixed_duration: bool = False):
    """One sample's ``[N, 4]`` ``(x, y, t, p)`` events -> padded per-window
    ``(x, y, p, t, valid)``, each ``[T, K]`` (f32, ``valid`` bool).

    The split is by equal event count, or by equal duration with
    ``fixed_duration``. A window keeps its last ``K`` events, its times are
    relative to its first kept event, and the padded tail repeats the last
    time."""
    T, K = num_windows, window_events
    x = np.zeros((T, K), np.float32)
    y = np.zeros((T, K), np.float32)
    p = np.zeros((T, K), np.float32)
    t = np.zeros((T, K), np.float32)
    valid = np.zeros((T, K), bool)

    n_loaded = events.shape[0]
    if fixed_duration and n_loaded:
        t_ns = events[:, 2]
        dt = int((t_ns[-1] - t_ns[0]) / T)
        bounds = [0] + [
            int(np.searchsorted(t_ns, t_ns[0] + (i + 1) * dt))
            for i in range(T)
        ]
    else:
        per = n_loaded // T
        bounds = [i * per for i in range(T + 1)]
    for i in range(T):
        seg = events[bounds[i]:min(bounds[i + 1], n_loaded)]
        n = min(seg.shape[0], K)
        if n == 0:
            continue
        seg = seg[-n:]
        x[i, :n] = seg[:, 0]
        y[i, :n] = seg[:, 1]
        t[i, :n] = seg[:, 2] - seg[0, 2]  # relative; the kernel renormalizes
        t[i, n:] = t[i, n - 1]
        p[i, :n] = seg[:, 3]
        valid[i, :n] = True
    return x, y, p, t, valid


def _flat_windows(s: Settings, windows):
    """A batch's windows stacked into ``[B * T, K]`` arrays."""
    T, B = s.nr_events_data_b, len(windows)
    K = windows[0][0].shape[1]
    return [np.stack([w[i] for w in windows]).reshape(B * T, K)
            for i in range(5)]


def wire_batch(s: Settings, windows, *, reuse_buffers: bool = False) -> dict:
    """The ``ev_*`` raw-wire keys of a batch from its samples' windows (a
    list of :func:`split_event_windows` results): packed by the C++ packer
    at the 260x346 sensor with integer coordinates on ``num_cpu_workers``
    threads, the chunk axis trimmed to the bucketed batch maximum.
    ``reuse_buffers`` hands out the packer's recycled buffers (only for a
    batch that is copied before the next call but one)."""
    x, y, p, t, valid = _flat_windows(s, windows)
    wire = chunk_events_windows_host(
        x, y, p, t.astype(np.float64), valid, height=HEIGHT, width=WIDTH,
        integer_coords=True, n_threads=s.num_cpu_workers,
        reuse_buffers=reuse_buffers, t16=s.wire_t16)
    return pack_wire_batch(wire, len(windows), s.nr_events_data_b)


def host_voxelize(s: Settings, windows) -> np.ndarray:
    """The batch's ``event`` made on the host: per window the native
    bilinear-in-time grid (``separate_pol`` as set) or, with the
    ``histogram`` representation, the 2-channel count image, each with the
    biased nonzero normalization when ``normalize_event``, in one call
    parallel across the B * T windows; then resized to 352 columns
    (``ops/resize.resize_bilinear``, ``align_corners=True``) and cropped by
    60 rows. Planar ``[B, T, C, 200, 352]`` f32."""
    T, B = s.nr_events_data_b, len(windows)
    x, y, p, t, valid = _flat_windows(s, windows)
    counts = valid.sum(axis=1)
    norm = 2 if s.normalize_event_b else 0
    if s.event_representation_b == "histogram":
        g = event_histogram_windows_host(
            x, y, p, counts, HEIGHT, WIDTH, norm_mode=norm,
            n_threads=s.num_cpu_workers).transpose(0, 2, 3, 1)
    else:
        g = voxelize_bilinear_t_windows_host(
            x, y, p, t, counts, s.nr_temporal_bins_b, HEIGHT, WIDTH,
            separate_pol=s.separate_pol_b, norm_mode=norm,
            n_threads=s.num_cpu_workers)
    g = resize_bilinear(torch.from_numpy(np.ascontiguousarray(g)),
                        out_h=HEIGHT, out_w=RESIZE_W, align_corners=True)
    g = g[:, :HEIGHT - CROP_BOTTOM].permute(0, 3, 1, 2).contiguous()
    return g.reshape((B, T) + g.shape[1:]).numpy()


def voxelize_grid(s: Settings, x, y, p, t, valid, device) -> torch.Tensor:
    """The grid wire's voxel windows, made on ``device``: ``[B, T, K]``
    padded numpy events -> planar ``[B, T, Cout, 200, 352]`` f32.

    K6 voxelizes all B * T windows in one launch at the 260x346 sensor;
    with ``normalize_event`` each window then gets the biased nonzero
    normalization; the planar grid is resized to 352 columns (bilinear,
    ``align_corners=True``) and its bottom 60 rows cropped, in the JAX
    package's order."""
    b, n_win, k = x.shape
    ev = [torch.from_numpy(np.ascontiguousarray(a).reshape(-1)).to(device)
          for a in (x, y, p, t, valid)]
    g = voxelize_windows_bilinear_t_mxu(
        *ev, num_windows=b * n_win, num_bins=s.nr_temporal_bins_b,
        height=HEIGHT, width=WIDTH, separate_pol=s.separate_pol_b)
    g = g.view(b * n_win, -1, HEIGHT, WIDTH)
    if s.normalize_event_b:
        g = normalize_nonzero(g, unbiased=False, dims=(1, 2, 3))
    g = F.interpolate(g, size=(HEIGHT, RESIZE_W), mode="bilinear",
                      align_corners=True)[:, :, :HEIGHT - CROP_BOTTOM]
    return g.reshape((b, n_win) + g.shape[1:])


def event_batch(s: Settings, windows, device) -> dict:
    """The event keys of a batch from its samples' windows (a list of
    :func:`split_event_windows` results). The wire's buffers are recycled
    (``device_voxelize.wire_reuse_ok``) only for a CUDA ``device``."""
    if s.event_representation_b == "histogram" or (
            s.wire_format != "raw_events" and s.host_voxelize):
        return {"event": host_voxelize(s, windows)}
    if s.wire_format == "raw_events":
        return wire_batch(s, windows, reuse_buffers=wire_reuse_ok(device))
    stacked = [np.stack([w[i] for w in windows]) for i in range(5)]
    return {"event": voxelize_grid(s, *stacked, device)}


def aligned_path(file_path: str, source: str, img_prefix: str) -> str:
    """The path of a side channel beside a mask, with the reference's
    naming quirk: dir0 and dir1 name files ``<prefix><n>.png``, the other
    recordings ``00<n>.png``."""
    path = file_path.replace("segmentation_masks", source)
    a = path.split("segmentation_")
    d = path.split("/")[-3]
    if d in ("dir0", "dir1"):
        path = a[0] + a[1]
        if img_prefix:
            path = path.replace(path.split("/")[-1],
                                img_prefix + path.split("/")[-1])
    else:
        path = a[0] + "00" + a[1]
    return path


class DDD17Dataset:
    """The masks of a split's recordings (``skip_ratio`` subset each) with
    their memmapped events. ``device`` is where the grid wire is voxelized
    (CUDA unless given)."""

    def __init__(self, s: Settings, split: str = "train", device=None):
        self.s = s
        self.split = split
        self.device = resolve_device(device)
        dirs = sorted(glob.glob(join(s.dataset_path_b, "dir*")))
        if len(dirs) < 6:
            raise FileNotFoundError(
                f"DDD17 needs dir0..dir5 under {s.dataset_path_b!r}, found "
                f"{len(dirs)}")
        self.dirs = get_split(dirs, split)
        self.files = []
        for d in self.dirs:
            lf = sorted(glob.glob(join(d, "segmentation_masks", "*.png")))
            if s.skip_ratio != 1:
                lf = lf[:len(lf) // s.skip_ratio + 1]
            self.files += lf
        t_interval = (s.nr_events_data_b * s.delta_t_per_data_b
                      if s.fixed_duration_b else -1)
        self.index_maps, self.event_data = {}, {}
        for d in self.dirs:
            idx_map, t_ev, xyp = load_dir(d, t_interval)
            self.index_maps[d] = idx_map
            self.event_data[d] = (t_ev, xyp)

    def __len__(self):
        return len(self.files)

    def load_sample(self, idx) -> dict:
        """The side channels of mask ``idx``: label, pseudo-label and
        superpixels resized nearest to 352x200; frame or reconstruction as
        stored."""
        s = self.s
        fp = self.files[idx]
        h_out = HEIGHT - CROP_BOTTOM
        label = read_png_nearest(fp, RESIZE_W, h_out)
        out = {"label": label, "file_path": fp}
        opt = s.config_option
        if opt in ("frame2voxel", "frame2recon"):
            out["frame"] = read_rgb(aligned_path(fp, "images_aligned", "img_"))
        if opt in ("recon2voxel", "frame2recon"):
            out["recon"] = read_rgb(fp.replace("segmentation_masks",
                                           "reconstructions"))
        if self.split == "train" and s.pl_sources:
            out["pl"] = read_png_nearest(
                aligned_path(fp, s.pl_sources, "segmentation_"),
                RESIZE_W, h_out)
        else:
            out["pl"] = np.ones_like(label)
        if len(s.superpixel_sources) > 1:
            src = ("superpixels_sam" if s.superpixel_sources == "sp_sam_rgb"
                   else s.superpixel_sources)
            sp = aligned_path(fp, src, "img_")
            if s.superpixel_sources == "sp_slic_rgb":
                sp = sp.replace(".png", "_slic_25.png")
            out["superpixel"] = read_png_nearest(sp, RESIZE_W, h_out)
        else:
            out["superpixel"] = np.ones_like(label)
        out["sam_feat"] = np.ones((64, 64, 256), np.float32)
        return out

    def load_events(self, idx):
        """Padded per-window ``(x, y, p, t, valid)`` of mask ``idx``, each
        ``[T, K]``: :func:`extract_events` then
        :func:`split_event_windows`."""
        s = self.s
        fp = self.files[idx]
        d = dirname(dirname(fp))
        img_idx = int(basename(fp).split("_")[-1].split(".")[0]) - 1
        t_ev, xyp = self.event_data[d]
        T, K = s.nr_events_data_b, s.nr_events_window_b
        events = extract_events(t_ev, xyp, img_idx, self.index_maps[d],
                                s.fixed_duration_b, T * K)
        return split_event_windows(events, T, K, s.fixed_duration_b)

    def get_batch(self, indices) -> dict:
        """Side channels stacked as numpy arrays, and the event keys of
        :func:`event_batch` (on the grid wire, a tensor on the device)."""
        needs_events = self.s.config_option in EVENT_OPTIONS
        samples = [self.load_sample(int(i)) for i in indices]
        batch = {k: np.stack([sm[k] for sm in samples])
                 for k in SIDE_KEYS if k in samples[0]}
        if needs_events:
            windows = [self.load_events(int(i)) for i in indices]
            batch.update(event_batch(self.s, windows, self.device))
        return batch
