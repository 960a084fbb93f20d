"""DDD17-Seg: the event half of ``openess_tpu/data/ddd17.py`` (numpy only).

The sensor is 260x346. Voxel grids are bilinearly resized
(``align_corners=True``) to 260x352 and the bottom 60 rows cropped, giving
200x352; ``data/device_voxelize.voxelize_wire`` does that on the device
after the K4 voxelizer. This module holds what turns a sample's raw events
into the wire: the slice of the memmapped event arrays that belongs to an
image (:func:`extract_events`), its split into T padded windows
(:func:`split_event_windows`) and the raw-wire batch assembly
(:func:`wire_batch`).

Reading a DDD17 tree from disk (the memmap files, the index maps, labels,
frames and superpixels through PIL) is not ported yet.
"""
from __future__ import annotations

import numpy as np

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.device_voxelize import pack_wire_batch
from openess_tpu_torch.ops.voxelize_chunked import (
    chunk_events_batch,
    trim_wire_chunks,
)

HEIGHT, WIDTH = 260, 346
RESIZE_W = 352
CROP_BOTTOM = 60  # -> 200 rows


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


def wire_batch(s: Settings, windows) -> dict:
    """The ``ev_*`` raw-wire keys of a batch from its samples' windows (a
    list of :func:`split_event_windows` results): packed at the 260x346
    sensor with integer coordinates, the chunk axis trimmed to the bucketed
    batch maximum."""
    if s.event_representation_b == "histogram":
        raise NotImplementedError(
            "the DDD17 event histogram is built on the host and shipped as "
            "a grid: ROADMAP Queue 1 item 9 (the grid wire)"
        )
    if s.wire_format != "raw_events":
        raise NotImplementedError(
            "the DDD17 grid wire (host_voxelize and the K6 device "
            "voxelizer): ROADMAP Queue 1 item 9"
        )
    T, B = s.nr_events_data_b, len(windows)
    K = windows[0][0].shape[1]
    stacked = [
        np.stack([w[i] for w in windows]).reshape(B * T, K) for i in range(5)
    ]
    wire = chunk_events_batch(
        stacked[0], stacked[1], stacked[2], stacked[3].astype(np.float64),
        stacked[4], height=HEIGHT, width=WIDTH, integer_coords=True,
        t16=s.wire_t16,
    )
    return pack_wire_batch(trim_wire_chunks(wire), B, T)

