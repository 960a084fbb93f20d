"""Event-file readers (own copy of ``openess_tpu/data/event_file_readers.py``,
the part the streaming server uses).

Reference: ``e2vid/utils/event_readers.py`` — a ``.txt``/``.zip`` event
stream (whitespace columns ``t x y pol``, one header line) cut into windows;
each window is an ``[N, 4]`` float64 array of ``(t, x, y, pol)`` rows.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np


def fixed_size_event_windows(
    path: str, num_events: int = 10_000, start_index: int = 0
) -> Iterator[np.ndarray]:
    """Non-overlapping windows of ``num_events`` events; the trailing
    partial chunk is emitted, as pandas' chunk iterator (the reference's
    reader) does. ``pandas`` is imported here, only when a file is read."""
    import pandas as pd

    it = pd.read_csv(
        path, sep=r"\s+", header=None, names=["t", "x", "y", "pol"],
        dtype={"t": np.float64, "x": np.int16, "y": np.int16,
               "pol": np.int16},
        engine="c", skiprows=start_index + 1, chunksize=num_events,
    )
    for chunk in it:
        yield chunk.values.astype(np.float64)
