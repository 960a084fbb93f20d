"""HDF5 event-stream slicer: own copy of ``openess_tpu/data/event_slicer.py``
(numpy only; the caller opens the file).

The reference ``EventSlicer`` contract (``ms_to_idx`` coarse lookup, then an
exact refinement inside the conservative millisecond window) with
``np.searchsorted`` on the loaded slice in place of the reference's numba
scan: the same boundaries, ``t[idx_start] >= t_start`` and
``t[idx_start - 1] < t_start``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np


def hdf5plugin_installed() -> bool:
    """Import ``hdf5plugin`` if it is installed, which registers the blosc
    filter (HDF5 filter 32001) of real DSEC ``events.h5`` files with h5py;
    return whether it is. It is optional: uncompressed and gzip files read
    without it."""
    try:
        import hdf5plugin  # noqa: F401
    except ImportError:
        return False
    return True


class EventSlicer:
    """Slices of the ``events/{p,x,y,t}`` datasets of an open DSEC
    ``events.h5`` (an ``h5py.File``) by time or by count."""

    def __init__(self, h5f):
        plugin = hdf5plugin_installed()
        self.h5f = h5f
        self.events = {k: h5f[f"events/{k}"] for k in ("p", "x", "y", "t")}
        self.ms_to_idx = np.asarray(h5f["ms_to_idx"], dtype="int64")
        self.t_offset = (int(h5f["t_offset"][()]) if "t_offset" in h5f.keys()
                         else 0)
        try:
            # probe read: fails here, loudly, when a decompression filter is
            # missing, instead of with a bare OSError mid-epoch
            self.t_final = int(self.events["t"][-1]) + self.t_offset
        except OSError as e:
            raise RuntimeError(
                f"reading {getattr(h5f, 'filename', '<h5>')} failed: real "
                "DSEC events.h5 files are blosc-compressed (HDF5 filter "
                "32001) and need the hdf5plugin package; hdf5plugin is "
                + ("installed" if plugin else "NOT installed")
                + f" in this environment. Original error: {e}"
            ) from e

    def get_start_time_us(self) -> int:
        return self.t_offset

    def get_final_time_us(self) -> int:
        return self.t_final

    def get_events(self, t_start_us: int, t_end_us: int
                   ) -> Optional[Dict[str, np.ndarray]]:
        """All events with ``t_start_us <= t < t_end_us`` (absolute us)."""
        assert t_start_us < t_end_us
        t_start_us -= self.t_offset
        t_end_us -= self.t_offset

        t_start_ms, t_end_ms = self.get_conservative_window_ms(t_start_us,
                                                               t_end_us)
        lo = self.ms2idx(t_start_ms)
        hi = self.ms2idx(t_end_ms)
        if lo is None or hi is None:
            return None

        t_slice = np.asarray(self.events["t"][lo:hi])
        i0 = int(np.searchsorted(t_slice, t_start_us, side="left"))
        i1 = int(np.searchsorted(t_slice, t_end_us, side="left"))
        out = {"t": t_slice[i0:i1] + self.t_offset}
        for k in ("p", "x", "y"):
            out[k] = np.asarray(self.events[k][lo + i0:lo + i1])
        return out

    def get_events_fixed_num(self, t_end_us: int, nr_events: int = 100000
                             ) -> Optional[Dict[str, np.ndarray]]:
        """The last ``nr_events`` events before ``t_end_us``, times relative
        to the file's ``t_offset`` as the reference returns them."""
        t_end_us -= self.t_offset
        lo_ms, hi_ms = math.floor(t_end_us / 1000), math.ceil(t_end_us / 1000)
        lo = self.ms2idx(lo_ms)
        hi = self.ms2idx(hi_ms)
        if lo is None or hi is None:
            return None
        t_slice = np.asarray(self.events["t"][lo:hi])
        end_idx = lo + int(np.searchsorted(t_slice, t_end_us, side="left"))
        start_idx = max(end_idx - nr_events, 0)
        return {k: np.asarray(self.events[k][start_idx:end_idx])
                for k in self.events}

    @staticmethod
    def get_conservative_window_ms(ts_start_us, ts_end_us) -> Tuple[int, int]:
        assert ts_end_us > ts_start_us
        return math.floor(ts_start_us / 1000), math.ceil(ts_end_us / 1000)

    def ms2idx(self, time_ms: int) -> Optional[int]:
        assert time_ms >= 0
        if time_ms >= self.ms_to_idx.size:
            return None
        return int(self.ms_to_idx[time_ms])
