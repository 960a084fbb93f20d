"""ctypes binding of the port's host C++ (``csrc/event_ops.cpp``): the
counterpart of the JAX package's native binding, with the same functions
and contracts.

- :func:`chunk_events_windows_host`: the two-phase sorted-chunk wire packer
  (the wire K1 and K4 voxelize on the card), thread-parallel across
  windows, trimmed to a bucketed chunk count, with recycled output buffers
  on request;
- :func:`voxelize_trilinear_windows_host`,
  :func:`voxelize_bilinear_t_windows_host`: the grid wire voxelized on the
  host (``tpu.host_voxelize``), one call for a batch of windows;
- :func:`event_histogram_windows_host`: the ``histogram`` representation;
- :func:`voxelize_trilinear_host`, :func:`voxelize_bilinear_t_host`,
  :func:`event_histogram_host`: one stream.

The library is built at first use (``ops/_build.build_host``) and a failed
build raises: there is no numpy fallback. The numpy chunker
(``ops/voxelize_chunked.chunk_events_batch``) and the exact scatters
(``ops/voxelize.py``) are the plain versions the tests and ``chip_smoke.py``
hold these functions to. ctypes releases the GIL inside every call.
"""
from __future__ import annotations

import ctypes
import threading

import numpy as np

from openess_tpu_torch.ops.voxelize_chunked import (
    CHUNK,
    bucket_nbc,
    num_chunks,
)

SOURCE = "event_ops.cpp"


_LIBRARY = None
_LIBRARY_LOCK = threading.Lock()


def library() -> ctypes.CDLL:
    """The host library, built and loaded once per process, with every C
    entry's argument types bound once, under a lock: the loader's workers
    reach it from several threads at once, and ctypes reads a function's
    converters without holding them, so binding ``argtypes`` again while
    another thread calls that function frees the converters it is using
    (``ArgumentError: ... 'dict' object is not callable``)."""
    global _LIBRARY
    if _LIBRARY is not None:
        return _LIBRARY
    with _LIBRARY_LOCK:
        if _LIBRARY is None:
            _LIBRARY = _bind_library()
        return _LIBRARY


def _bind_library() -> ctypes.CDLL:
    from openess_tpu_torch.ops import _build

    lib = _build.load_host(SOURCE)
    i64, i32 = ctypes.c_int64, ctypes.c_int
    nd = np.ctypeslib.ndpointer
    fp = nd(np.float32, flags="C_CONTIGUOUS")
    ip = nd(np.int64, flags="C_CONTIGUOUS")
    dp = nd(np.float64, flags="C_CONTIGUOUS")
    u8p = nd(np.uint8, flags="C_CONTIGUOUS")
    i16p = nd(np.int16, flags="C_CONTIGUOUS")
    i32p = nd(np.int32, flags="C_CONTIGUOUS")
    anyp = nd(flags="C_CONTIGUOUS")  # the f32 or uint16 time wire
    argtypes = {
        "voxelize_trilinear": [fp, fp, fp, fp, i64, i32, i32, i32, fp],
        "voxelize_trilinear_mt": [fp, fp, fp, fp, i64, i32, i32, i32, fp,
                                  i32],
        "voxelize_bilinear_t": [ip, ip, fp, ip, i64, i32, i32, i32, fp, fp],
        "voxelize_trilinear_windows": [
            fp, fp, fp, fp, ip, i64, i64, i32, i32, i32, i32, i32, fp, i32,
            i32],
        "voxelize_bilinear_t_windows": [
            fp, fp, fp, fp, ip, i64, i64, i32, i32, i32, i32, i32, fp, i32,
            i32],
        "event_histogram": [ip, ip, fp, i64, i32, i32, fp, fp],
        "chunk_events_phase_a": [
            fp, fp, fp, dp, u8p, i64, i64, i32, i32, i32, i32, i32,
            i32p, i32p, i32p, dp, fp, i32p, i32],
        "chunk_events_phase_b": [
            fp, fp, fp, dp, u8p, i64, i64, i32, i32, i32, i32, i32, i32,
            i32p, i32p, dp, fp, i16p, i16p, u8p, anyp, i32, i32],
        "time_indices_offsets": [
            ip, i64, i64, i64, ctypes.POINTER(i64), ctypes.POINTER(i64)],
        "normalize_nonzero_inplace": [fp, i64],
    }
    for name, types in argtypes.items():
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = None
    return lib


def voxelize_trilinear_host(x, y, p, t, num_bins, height, width,
                            n_threads: int = 1) -> np.ndarray:
    """DSEC's signed trilinear grid ``[num_bins, height, width]`` f32 of one
    stream, times normalized by its first and last event. ``n_threads`` > 1
    (0: every core) splits the events across threads with private grids."""
    x, y, p, t = (np.ascontiguousarray(a, np.float32) for a in (x, y, p, t))
    grid = np.zeros(num_bins * height * width, np.float32)
    lib = library()
    if n_threads == 1:
        lib.voxelize_trilinear(x, y, p, t, x.size, num_bins, height, width,
                               grid)
    else:
        lib.voxelize_trilinear_mt(x, y, p, t, x.size, num_bins, height,
                                  width, grid, n_threads)
    return grid.reshape(num_bins, height, width)


def voxelize_bilinear_t_host(x, y, p, t, num_bins, height, width,
                             separate_pol=True) -> np.ndarray:
    """DDD17's grid of one stream: integer pixels, bilinear in time, per
    polarity. ``[2 * num_bins, H, W]`` (positive bins, then negative) with
    ``separate_pol``, else their difference ``[num_bins, H, W]``."""
    xs = np.ascontiguousarray(x, np.int64)
    ys = np.ascontiguousarray(y, np.int64)
    pf = np.ascontiguousarray(p, np.float32)
    ts = np.ascontiguousarray(t, np.int64)
    size = num_bins * height * width
    pos, neg = np.zeros(size, np.float32), np.zeros(size, np.float32)
    library().voxelize_bilinear_t(xs, ys, pf, ts, xs.size, num_bins, height,
                                  width, pos, neg)
    pos = pos.reshape(num_bins, height, width)
    neg = neg.reshape(num_bins, height, width)
    return np.concatenate([pos, neg], 0) if separate_pol else pos - neg


def _as_flat_f32(a, n_win: int, k: int) -> np.ndarray:
    """``[n_win, K]`` -> flat contiguous f32 (the point where DSEC's float64
    microseconds become f32, as in the JAX package)."""
    a = np.ascontiguousarray(a, np.float32)
    if a.size != n_win * k:
        raise ValueError(f"{a.shape} is not {n_win} windows of {k}")
    return a.reshape(n_win * k)


def _windows(x, counts):
    """``(counts as int64, windows, slots a window)``; a window cannot hold
    more events than its slots (the C++ reads ``counts[w]`` of them)."""
    counts = np.ascontiguousarray(counts, np.int64)
    n_win = counts.size
    k = np.asarray(x).size // max(n_win, 1)
    if n_win and not 0 <= counts.min() <= counts.max() <= k:
        raise ValueError(f"window counts outside [0, {k}]")
    return counts, n_win, k


def voxelize_trilinear_windows_host(
    x, y, p, t, counts, num_bins, height, width, *, crop_bottom=0,
    norm_mode=0, n_threads=1, layout="nhwc",
) -> np.ndarray:
    """DSEC's trilinear grids of ``n_win`` windows in one call, parallel
    across windows. Inputs ``[n_win, K]``; window ``w`` uses its first
    ``counts[w]`` events. ``norm_mode``: 0 none, 1 the unbiased and 2 the
    biased nonzero normalization, over the window's full grid; then the
    bottom ``crop_bottom`` rows are cut. ``layout="chw"``: planar
    ``[n_win, num_bins, H - crop, W]`` (the grid wire); ``"nhwc"``:
    ``[n_win, H - crop, W, num_bins]``."""
    counts, n_win, k = _windows(x, counts)
    planar = layout == "chw"
    ho = height - crop_bottom
    out = np.zeros((n_win, num_bins, ho, width) if planar
                   else (n_win, ho, width, num_bins), np.float32)
    library().voxelize_trilinear_windows(
        *(_as_flat_f32(a, n_win, k) for a in (x, y, p, t)), counts, n_win,
        k, num_bins, height, width, crop_bottom, norm_mode, out.reshape(-1),
        n_threads, int(planar))
    return out


def voxelize_bilinear_t_windows_host(
    x, y, p, t, counts, num_bins, height, width, *, separate_pol=True,
    norm_mode=0, n_threads=1, layout="nhwc",
) -> np.ndarray:
    """DDD17's grids of ``n_win`` windows in one call, parallel across
    windows, with the windows of :func:`voxelize_trilinear_windows_host`.
    ``Cout`` is ``2 * num_bins`` (``separate_pol``: positive bins, then
    negative; normalized together) or ``num_bins`` (positive minus
    negative). ``layout="chw"``: ``[n_win, Cout, H, W]``; ``"nhwc"``:
    ``[n_win, H, W, Cout]``."""
    counts, n_win, k = _windows(x, counts)
    cout = 2 * num_bins if separate_pol else num_bins
    planar = layout == "chw"
    out = np.zeros((n_win, cout, height, width) if planar
                   else (n_win, height, width, cout), np.float32)
    library().voxelize_bilinear_t_windows(
        *(_as_flat_f32(a, n_win, k) for a in (x, y, p, t)), counts, n_win,
        k, num_bins, height, width, int(separate_pol), norm_mode,
        out.reshape(-1), n_threads, int(planar))
    return out


def normalize_nonzero_np(g: np.ndarray, norm_mode: int) -> np.ndarray:
    """The nonzero normalization of one window's grid in numpy (f32
    statistics; ``norm_mode`` 1 unbiased, 2 biased, 0 none), as the JAX
    package applies it to the histogram."""
    if norm_mode == 0:
        return g
    mask = g != 0
    if mask.sum() < (2 if norm_mode == 1 else 1):  # no spread to divide by
        return g
    vals = g[mask]
    std = vals.std(ddof=1 if norm_mode == 1 else 0)
    if not np.isfinite(std) or std == 0:
        return g
    g = g.copy()
    g[mask] = (vals - vals.mean()) / std
    return g


def event_histogram_host(x, y, p, height, width) -> np.ndarray:
    """The 2-channel count image of one stream, planar ``[2, H, W]`` f32:
    channel 0 counts the negative events, channel 1 the positive, at their
    truncated pixels."""
    xs = np.ascontiguousarray(x, np.int64)
    ys = np.ascontiguousarray(y, np.int64)
    pf = np.ascontiguousarray(p, np.float32)
    neg = np.zeros(height * width, np.float32)
    pos = np.zeros(height * width, np.float32)
    library().event_histogram(xs, ys, pf, xs.size, height, width, neg, pos)
    return np.stack([neg, pos]).reshape(2, height, width)


def event_histogram_windows_host(x, y, p, counts, height, width, *,
                                 norm_mode=0, n_threads=1) -> np.ndarray:
    """Per-window histograms: ``[n_win, K]`` inputs -> planar
    ``[n_win, 2, H, W]``, each window normalized on its own, windows spread
    over ``n_threads`` threads."""
    from concurrent.futures import ThreadPoolExecutor

    counts, n_win, k = _windows(x, counts)
    xs, ys, ps = (np.asarray(a, np.float32).reshape(n_win, k)
                  for a in (x, y, p))
    out = np.zeros((n_win, 2, height, width), np.float32)
    library()  # built before the threads start

    def one(w):
        n = int(counts[w])
        if n:
            out[w] = normalize_nonzero_np(event_histogram_host(
                xs[w, :n], ys[w, :n], ps[w, :n], height, width), norm_mode)

    if n_threads > 1 and n_win > 1:
        with ThreadPoolExecutor(max_workers=min(n_threads, n_win)) as pool:
            list(pool.map(one, range(n_win)))
    else:
        for w in range(n_win):
            one(w)
    return out


# Per-thread scratch and output buffers of the packer, two of each per
# (thread, shape): what a call returns from them stays valid until the same
# thread's call after next.
_tls = threading.local()


def _tls_buffers(group: str, key, alloc):
    cache = getattr(_tls, group, None)
    if cache is None:
        cache = {}
        setattr(_tls, group, cache)
    if cache.get("key") != key:
        cache.update(key=key, bufs=[alloc(), alloc()], i=0)
    cache["i"] ^= 1
    return cache["bufs"][cache["i"]]


def chunk_events_windows_host(
    x, y, p, t, valid, *, height, width, chunk=None, integer_coords=False,
    n_threads=1, trim=True, reuse_buffers=False, t16=False,
):
    """The sorted-chunk wire of ``[n_win, K]`` padded windows (``t``
    float64, any monotonic unit): ``(xq, yq, pq, t_rel, counts, tile_r0,
    t_range)``, bit-identical to the numpy chunker's
    (``ops/voxelize_chunked.chunk_events_batch``) ``[:, :nbc]`` slice.

    ``trim=True`` cuts the chunk axis to the batch's largest used chunk
    count, rounded up by ``bucket_nbc``; ``trim=False`` keeps the
    worst case ``num_chunks``; an int keeps that many chunks.
    ``n_threads`` threads share the windows (0: every core).

    ``reuse_buffers=True`` returns arrays from a per-thread double buffer:
    the same thread's call after next overwrites them. Only for a consumer
    that copies the batch first (an upload through pinned memory); with
    ``False`` every returned array is owned by the caller. ``t16`` is the
    v2 time wire (``t_rel`` uint16 against ``t_range``)."""
    chunk = CHUNK if chunk is None else chunk
    xs = np.ascontiguousarray(x, np.float32)
    n_win, k = xs.shape
    ys = np.ascontiguousarray(y, np.float32)
    ps = np.ascontiguousarray(p, np.float32)
    ts = np.ascontiguousarray(t, np.float64)
    vs = np.ascontiguousarray(valid, np.uint8)
    if any(a.shape != xs.shape for a in (ys, ps, ts, vs)):
        raise ValueError("x, y, p, t and valid must share one [n_win, K] "
                         "shape")
    nbc_cap = num_chunks(k, height, width=width, chunk=chunk)
    lib = library()

    n_key = (-(-height // 16)) * width
    key_pos, counts_full, r0_full, tfirst, t_range, used = _tls_buffers(
        "chunk_scratch", (n_win, n_key, nbc_cap),
        lambda: (
            np.empty((n_win, n_key + 1), np.int32),
            np.empty((n_win, nbc_cap), np.int32),
            np.empty((n_win, nbc_cap), np.int32),
            np.empty((n_win,), np.float64),
            np.empty((n_win,), np.float32),
            np.empty((n_win,), np.int32),
        ),
    )
    flat = [a.reshape(-1) for a in (xs, ys, ps, ts, vs)]
    lib.chunk_events_phase_a(
        *flat, n_win, k, height, width, chunk, nbc_cap, int(integer_coords),
        key_pos.reshape(-1), counts_full.reshape(-1), r0_full.reshape(-1),
        tfirst, t_range, used, n_threads)
    if trim is True:
        nbc = bucket_nbc(int(used.max(initial=0)), nbc_cap)
    elif trim:
        nbc = min(int(trim), nbc_cap)
    else:
        nbc = nbc_cap

    t_dtype = np.uint16 if t16 else np.float32

    def alloc_wire():
        return (np.empty((n_win, nbc, chunk), np.int16),
                np.empty((n_win, nbc, chunk), np.int16),
                np.empty((n_win, nbc, chunk), np.uint8),
                np.empty((n_win, nbc, chunk), t_dtype))

    if reuse_buffers:
        xq, yq, pq, tr = _tls_buffers(
            "chunk_wire", (n_win, nbc, chunk, t_dtype), alloc_wire)
    else:
        xq, yq, pq, tr = alloc_wire()
    lib.chunk_events_phase_b(
        *flat, n_win, k, height, width, chunk, nbc, nbc_cap,
        int(integer_coords), key_pos.reshape(-1), counts_full.reshape(-1),
        tfirst, t_range, xq.reshape(-1), yq.reshape(-1), pq.reshape(-1),
        tr.reshape(-1), int(t16), n_threads)
    # counts and r0s are always copied: the scratch group flips on every
    # call, the wire group only on reuse calls, so a view of the scratch
    # would be rewritten under a batch still held (and at nbc == nbc_cap
    # the slice is the scratch itself)
    return (xq, yq, pq, tr, counts_full[:, :nbc].copy(),
            r0_full[:, :nbc].copy(), t_range.copy())
