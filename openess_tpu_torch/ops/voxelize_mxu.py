"""The grid wire's device voxelizers: K5 (DSEC, trilinear) and K6 (DDD17,
bilinear in time), the counterparts of ``openess_tpu/ops/voxelize_mxu.py``
under the same function names and contracts.

Each takes flat ``[num_windows * K]`` padded events (``x, y, p, t`` and a
bool ``valid``) and returns the per-window grids ``[num_windows * Cout, H,
W]`` f32. On a CUDA tensor the wrapper launches its kernels from
``csrc/voxelize_grid.cu``, counting one launch of the voxelizer in
``.launches`` (under a lock: the loader's worker threads launch them); on
a CPU tensor it runs its plain version, the exact scatter
of ``ops/voxelize.py``. Any other device raises.

Both read the raw events: their passes bin them by output tile on the card
(:func:`bin_events_trilinear`, :func:`bin_events_bilinear_t`, held to
their ``_plain`` versions) and a tile-owner splat writes every cell of the
grid once, so the grid is a ``torch.empty`` and the wrappers run no
elementwise pass over the events (``splat_binned_*_plain`` are those
splats in PyTorch). K5 bins each event under its home tile and one of four
spill categories; K6's events touch one pixel, so one slot a tile.

The TPU kernels multiply one-hot matrices in bf16 on the matrix unit; the
port's kernels splat in exact f32, as K1 and K4 do. They differ from the
TPU kernels by that rounding (about 5e-3 of the grid max) and from the
plain versions by the order of the f32 sums only.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from openess_tpu_torch.ops.tile_splat import (
    TilePlan,
    event_slots,
    pixel_slots,
    reader_tiles,
    tile_plan,
)
from openess_tpu_torch.ops.voxelize import (
    _normalized_times,
    voxel_grid_bilinear_t,
    voxelize_windows_trilinear,
)

_COUNT_LOCK = threading.Lock()


def _count_launch(fn):
    with _COUNT_LOCK:
        fn.launches += 1


def _check_events(x, y, p, t, valid, num_windows: int) -> int:
    """Validate the flat event arrays; return the events per window."""
    n = x.shape[0]
    for name, a in zip("xypt", (x, y, p, t)):
        if a.dim() != 1 or a.shape[0] != n or a.device != x.device:
            raise ValueError(f"{name}: expected a flat [{n}] tensor on "
                             f"{x.device}, got {tuple(a.shape)} on {a.device}")
    if valid.dtype != torch.bool or tuple(valid.shape) != (n,) or \
            valid.device != x.device:
        raise ValueError("valid must be a flat bool tensor beside the events")
    if num_windows <= 0 or n % num_windows:
        raise ValueError(f"{n} events do not split into {num_windows} "
                         "equal windows")
    return n // num_windows


def _launch(name: str, tensors, device, *ints):
    """Launch the C entry ``name`` of ``csrc/voxelize_grid.cu`` on the
    current stream of ``device``: the tensors' device pointers, then
    ``ints``."""
    from openess_tpu_torch.ops import _build

    fn = _build.entry("voxelize_grid.cu", name,
                      *[ctypes.c_void_p] * len(tensors),
                      *[ctypes.c_int] * len(ints))
    _build.launch(fn, device, *(a.data_ptr() for a in tensors), *ints)


def _raw_events(x, y, p, t, valid):
    """The raw events as the binning passes read them: contiguous f32
    ``x, y, p, t`` (cast where they are not) and the bool ``valid``."""
    return (*(a.to(torch.float32).contiguous() for a in (x, y, p, t)),
            valid.contiguous())


def _binned_plain(xs, ys, tn, v, slot, keep, plan: TilePlan):
    """The binning passes' result from ``[NW, K]`` records ``(xs, ys, tn,
    v)``, each record's slot within its window and whether it is kept:
    ``(counts, offsets, binned)``, window ``w``'s runs in slot order from
    ``w * K``, each run in the events' own order."""
    nw, k = xs.shape
    win = torch.arange(nw, device=xs.device)[:, None]
    slot = (win * plan.slots_per_window + slot)[keep].long()
    counts = torch.bincount(slot, minlength=plan.slots(nw)).int()
    per_window = counts.view(nw, -1).long()
    offsets = (torch.cumsum(per_window, 1) - per_window
               + torch.arange(nw, device=xs.device)[:, None] * k).reshape(-1)
    order = torch.argsort(slot, stable=True)
    binned = torch.zeros((nw * k, 4), dtype=torch.float32, device=xs.device)
    binned[binned_rows(counts, offsets)[0]] = \
        torch.stack((xs, ys, tn, v), -1)[keep][order]
    return counts, offsets, binned


def bin_events_trilinear_plain(x, y, p, t, valid, *, num_windows: int,
                               plan: TilePlan):
    """K5's binning passes (count, scatter) in PyTorch, the function the
    card's passes are held to.

    Returns ``(counts, offsets, binned)``: int32 events per slot, a slot
    being ``(window, home tile, category)`` in that order
    (``ops/tile_splat.event_slots``); each slot's int64 start in
    ``binned``, window ``w``'s runs following each other in slot order
    from ``w * K``; and ``binned``, ``[num_windows * K, 4]`` f32, whose
    runs hold the kept events' ``(x, y, tn, v)``. ``tn`` is the window's
    time normalization over its valid events, ``v = 2p - 1``; padding and
    events with no corner in the frame are dropped. Rows outside the runs
    are zero here and undefined on the card; within a run the card's order
    is any order, here it is the events' own."""
    nw = num_windows
    vs = valid.reshape(nw, -1)
    xs, ys = x.float().reshape(nw, -1), y.float().reshape(nw, -1)
    tn = _normalized_times(t.reshape(nw, -1), vs, plan.channels,
                           positive_dt=True)
    v = 2.0 * p.float().reshape(nw, -1) - 1.0
    slot, keep = event_slots(xs, ys, plan)
    return _binned_plain(xs, ys, tn, v, slot, keep & vs, plan)


def binned_rows(counts, offsets):
    """The rows of ``binned`` that hold events, run by run in slot order,
    and each row's slot: ``(rows, slots)`` int64."""
    c = counts.long()
    slots = torch.repeat_interleave(
        torch.arange(c.numel(), device=c.device), c)
    start = torch.cumsum(c, 0) - c
    rows = offsets[slots] + torch.arange(slots.numel(), device=c.device) \
        - start[slots]
    return rows, slots


def splat_binned_trilinear_plain(counts, offsets, binned, *,
                                 num_windows: int,
                                 plan: TilePlan) -> torch.Tensor:
    """K5's splat pass in PyTorch: every tile adds, of the events binned at
    its own slots and at its neighbours' spill categories
    (``ops/tile_splat.reader_tiles``), the corners inside the tile. Returns
    ``[num_windows * bins, H, W]`` f32."""
    C, H, W = plan.channels, plan.height, plan.width
    rows, slot = binned_rows(counts, offsets)
    win, slot = slot // plan.slots_per_window, slot % plan.slots_per_window
    x, y, tn, v = binned[rows].unbind(-1)
    x0, y0, t0 = x.int(), y.int(), tn.int()  # trunc toward zero
    out = torch.zeros(num_windows * C * H * W, device=binned.device)
    for tile, reads in reader_tiles(slot, plan):
        ty, tx = tile // plan.tiles_x, tile % plan.tiles_x
        r0, c0 = ty * plan.rows, tx * plan.cols
        r1 = torch.clamp(r0 + plan.rows, max=H)
        c1 = torch.clamp(c0 + plan.cols, max=W)
        for dx in (0, 1):
            cx = x0 + dx
            wx = v * (1.0 - torch.abs(cx.float() - x))
            for dy in (0, 1):
                cy = y0 + dy
                wxy = wx * (1.0 - torch.abs(cy.float() - y))
                for dt in (0, 1):
                    ct = t0 + dt
                    ok = (reads & (cx >= c0) & (cx < c1) & (cy >= r0)
                          & (cy < r1) & (ct >= 0) & (ct < C))
                    wt = 1.0 - torch.abs(ct.float() - tn)
                    idx = ((win * C + ct) * H + cy) * W + cx
                    out.index_put_((idx[ok].long(),), (wxy * wt)[ok],
                                   accumulate=True)
    return out.view(num_windows * C, H, W)


def splat_binned_trilinear(counts, offsets, binned, grid, *,
                           num_windows: int, plan: TilePlan) -> None:
    """K5's splat pass on the card: the binned events into ``grid``, a
    contiguous f32 ``[num_windows * bins, H, W]`` on their card, whatever it
    holds (the tile-owner splat writes every cell once). A call here is not
    counted as a launch of K5."""
    if (grid.dtype != torch.float32 or not grid.is_contiguous()
            or tuple(grid.shape) != (num_windows * plan.channels,
                                     plan.height, plan.width)
            or grid.data_ptr() % 16):
        raise ValueError("grid must be a contiguous, 16-byte aligned f32 "
                         "[NW * bins, H, W]")
    _launch("splat_binned_trilinear", (binned, offsets, counts, grid),
            grid.device, num_windows, plan.channels, plan.height, plan.width,
            plan.rows, plan.cols, plan.pitch, plan.tiles, plan.tiles_x,
            plan.smem_bytes)


def bin_events_trilinear(x, y, p, t, valid, *, num_windows: int,
                         num_bins: int, height: int, width: int,
                         plan: TilePlan | None = None):
    """K5's binning: ``(counts, offsets, binned)`` as
    :func:`bin_events_trilinear_plain` returns them, for the tiles of
    ``tile_plan`` unless ``plan`` gives others. A CUDA tensor runs the
    card's count and scatter passes; a CPU tensor the plain version. Not
    counted as a launch of K5: :func:`voxelize_windows_trilinear_mxu` is."""
    nw = num_windows
    k = _check_events(x, y, p, t, valid, nw)
    plan = plan or tile_plan(num_bins, height, width)
    dev = x.device
    if dev.type == "cpu":
        return bin_events_trilinear_plain(x, y, p, t, valid, num_windows=nw,
                                          plan=plan)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device for K5: {dev}")
    return _bin_events("bin_events_trilinear", (x, y, p, t, valid), nw, k,
                       num_bins, plan)


def _bin_events(entry: str, events, nw: int, k: int, num_bins: int,
                plan: TilePlan):
    """Launch the binning passes ``entry`` on the card's raw events:
    ``(counts, offsets, binned)`` as the ``_plain`` versions return them."""
    dev = events[0].device
    slots = plan.slots(nw)
    # the counts, the scatter's cursors and the windows' time keys start at
    # zero: 0.8 MB at DSEC's 160 windows, one fill
    scratch = torch.zeros(2 * slots + 2 * nw, dtype=torch.int32, device=dev)
    counts = scratch[:slots]
    offsets = torch.empty(slots, dtype=torch.int64, device=dev)
    binned = torch.empty((nw * k, 4), dtype=torch.float32, device=dev)
    _launch(entry,
            (*_raw_events(*events), counts, scratch[slots:2 * slots],
             scratch[2 * slots:], offsets, binned),
            dev, nw, k, num_bins, plan.height, plan.width, plan.rows,
            plan.cols, plan.tiles_x, plan.slots_per_window,
            plan.count_smem_bytes, plan.scatter_smem_bytes)
    return counts, offsets, binned


def bilinear_t_plan(num_bins: int, height: int, width: int,
                    separate_pol: bool) -> TilePlan:
    """K6's tile plan: ``Cout`` channels (``2 * num_bins`` with
    ``separate_pol``), one binning slot a tile."""
    return tile_plan(2 * num_bins if separate_pol else num_bins, height,
                     width, categories=1)


def bin_events_bilinear_t_plain(x, y, p, t, valid, *, num_windows: int,
                                num_bins: int, plan: TilePlan):
    """K6's binning passes (count, scatter) in PyTorch, the function the
    card's passes are held to.

    Returns ``(counts, offsets, binned)`` as
    :func:`bin_events_trilinear_plain` does, a slot being ``(window,
    tile)`` (``ops/tile_splat.pixel_slots``) and a record ``(x, y, tn,
    pol)``: ``tn`` the window's time normalization over its valid events,
    in frame or not, with ``dt`` replaced by 1 only where it is 0 (DDD17's
    rule), and ``pol`` the polarity with 0 counted as -1. Padding and events
    whose float coordinates lie outside the frame are dropped."""
    nw = num_windows
    vs = valid.reshape(nw, -1)
    xs, ys = x.float().reshape(nw, -1), y.float().reshape(nw, -1)
    tn = _normalized_times(t.reshape(nw, -1), vs, num_bins,
                           positive_dt=False)
    pol = p.float().reshape(nw, -1)
    pol = torch.where(pol == 0, -1.0, pol)
    slot, keep = pixel_slots(xs, ys, plan)
    return _binned_plain(xs, ys, tn, pol, slot, keep & vs, plan)


def bin_events_bilinear_t(x, y, p, t, valid, *, num_windows: int,
                          num_bins: int, height: int, width: int,
                          separate_pol: bool = True,
                          plan: TilePlan | None = None):
    """K6's binning: ``(counts, offsets, binned)`` as
    :func:`bin_events_bilinear_t_plain` returns them, for the tiles of
    ``bilinear_t_plan`` unless ``plan`` gives others. A CUDA tensor runs
    the card's count and scatter passes; a CPU tensor the plain version.
    Not counted as a launch of K6: :func:`voxelize_windows_bilinear_t_mxu`
    is."""
    nw = num_windows
    k = _check_events(x, y, p, t, valid, nw)
    plan = plan or bilinear_t_plan(num_bins, height, width, separate_pol)
    dev = x.device
    if dev.type == "cpu":
        return bin_events_bilinear_t_plain(x, y, p, t, valid, num_windows=nw,
                                           num_bins=num_bins, plan=plan)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device for K6: {dev}")
    return _bin_events("bin_events_bilinear_t", (x, y, p, t, valid), nw, k,
                       num_bins, plan)


def splat_binned_bilinear_t_plain(counts, offsets, binned, *,
                                  num_windows: int, num_bins: int,
                                  separate_pol: bool,
                                  plan: TilePlan) -> torch.Tensor:
    """K6's splat pass in PyTorch: every tile adds, of the events binned at
    its slot, the two time corners at their pixel, kept inside the tile
    (``tile_splat.cuh``'s ``splat2_bilinear_t``). Returns ``[num_windows *
    Cout, H, W]`` f32."""
    C, H, W = num_bins, plan.height, plan.width
    cout = 2 * C if separate_pol else C
    rows, slot = binned_rows(counts, offsets)
    win, tile = slot // plan.slots_per_window, slot % plan.slots_per_window
    x, y, tn, v = binned[rows].unbind(-1)
    xi, yi, ti = x.int(), y.int(), tn.int()  # trunc toward zero
    r0 = (tile // plan.tiles_x) * plan.rows
    c0 = (tile % plan.tiles_x) * plan.cols
    ok = ((tn >= 0) & (xi >= c0) & (xi < torch.clamp(c0 + plan.cols, max=W))
          & (yi >= r0) & (yi < torch.clamp(r0 + plan.rows, max=H)))
    dts = tn - ti.float()
    if separate_pol:
        sign = torch.ones_like(v)
        ch = torch.where(v > 0, ti, ti + C)
    else:
        sign, ch = v, ti
    idx = ((win * cout + ch) * H + yi) * W + xi
    out = torch.zeros(num_windows * cout * H * W, device=binned.device)
    for dt, wt in ((0, sign * (1.0 - dts)), (1, sign * dts)):
        keep = ok & (ti + dt < C)
        out.index_put_(((idx + dt * H * W)[keep].long(),), wt[keep],
                       accumulate=True)
    return out.view(num_windows * cout, H, W)


def splat_binned_bilinear_t(counts, offsets, binned, grid, *,
                            num_windows: int, num_bins: int,
                            separate_pol: bool, plan: TilePlan) -> None:
    """K6's splat pass on the card: the binned events into ``grid``, a
    contiguous f32 ``[num_windows * Cout, H, W]`` on their card, whatever it
    holds (the tile-owner splat writes every cell once). A call here is not
    counted as a launch of K6."""
    cout = 2 * num_bins if separate_pol else num_bins
    if (grid.dtype != torch.float32 or not grid.is_contiguous()
            or tuple(grid.shape) != (num_windows * cout, plan.height,
                                     plan.width)
            or plan.channels != cout or grid.data_ptr() % 16):
        raise ValueError("grid must be a contiguous, 16-byte aligned f32 "
                         "[NW * Cout, H, W] of the plan's channels")
    _launch("splat_binned_bilinear_t", (binned, offsets, counts, grid),
            grid.device, num_windows, num_bins, int(separate_pol),
            plan.height, plan.width, plan.rows, plan.cols, plan.pitch,
            plan.tiles, plan.tiles_x, plan.smem_bytes)


def voxelize_windows_trilinear_mxu(x, y, p, t, valid, *, num_windows: int,
                                   num_bins: int, height: int,
                                   width: int) -> torch.Tensor:
    """DSEC trilinear voxelization of padded events over equal windows (K5).

    ``x, y`` f32 coordinates (fractional, may be negative), ``p`` in
    {0, 1}, ``t`` any monotonic time (cast to f32 here), ``valid`` bool;
    each flat ``[num_windows * K]``. Returns ``[num_windows * num_bins, H,
    W]`` f32, the layout of ``voxelize_windows_trilinear``.

    A CUDA tensor launches K5, the binning passes and the tile-owner
    splat, which writes every cell once (the grid is a ``torch.empty``),
    and counts one launch in ``voxelize_windows_trilinear_mxu.launches``; a
    CPU tensor runs the plain version
    :func:`ops.voxelize.voxelize_windows_trilinear`.
    """
    nw, C, H, W = num_windows, num_bins, height, width
    _check_events(x, y, p, t, valid, nw)
    dev = x.device
    if dev.type == "cpu":
        return voxelize_windows_trilinear(
            x, y, p, t, valid, num_windows=nw, num_bins=C, height=H, width=W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device for K5: {dev}")
    binning = bin_events_trilinear(
        x, y, p, t, valid, num_windows=nw, num_bins=C, height=H, width=W)
    grid = torch.empty((nw * C, H, W), dtype=torch.float32, device=dev)
    splat_binned_trilinear(*binning, grid, num_windows=nw,
                           plan=tile_plan(C, H, W))
    _count_launch(voxelize_windows_trilinear_mxu)
    return grid


voxelize_windows_trilinear_mxu.launches = 0


def voxelize_windows_bilinear_t_mxu(x, y, p, t, valid, *, num_windows: int,
                                    num_bins: int, height: int, width: int,
                                    separate_pol: bool = True
                                    ) -> torch.Tensor:
    """DDD17 voxelization of padded events over equal windows (K6):
    integer pixels, bilinear in time, polarity 0 counted as -1.

    Flat ``[num_windows * K]`` inputs; returns ``[num_windows * Cout, H,
    W]`` f32 with ``Cout = 2 * num_bins``, positive then negative, when
    ``separate_pol``, else ``num_bins`` signed: the layout of
    ``voxel_grid_bilinear_t`` over the windows.

    A CUDA tensor launches K6, the binning passes and the tile-owner
    splat, which writes every cell once (the grid is a ``torch.empty``),
    and counts one launch in ``voxelize_windows_bilinear_t_mxu.launches``;
    a CPU tensor runs the plain version
    :func:`ops.voxelize.voxel_grid_bilinear_t`. The two agree wherever the
    coordinates are integers, as DDD17's are. An event with ``x`` or ``y``
    in (-1, 0) is dropped by the binning's in-frame test on the coordinate,
    as by the TPU wrapper, and kept at pixel 0 by the exact scatter, which
    truncates first.
    """
    nw, C, H, W = num_windows, num_bins, height, width
    k = _check_events(x, y, p, t, valid, nw)
    cout = 2 * C if separate_pol else C
    dev = x.device
    if dev.type == "cpu":
        g = voxel_grid_bilinear_t(
            *(a.reshape(nw, k) for a in (x, y, p, t, valid)), num_bins=C,
            height=H, width=W, separate_pol=separate_pol)
        return g.reshape(nw * cout, H, W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device for K6: {dev}")
    plan = bilinear_t_plan(C, H, W, separate_pol)
    binning = bin_events_bilinear_t(x, y, p, t, valid, num_windows=nw,
                                    num_bins=C, height=H, width=W, plan=plan)
    grid = torch.empty((nw * cout, H, W), dtype=torch.float32, device=dev)
    splat_binned_bilinear_t(*binning, grid, num_windows=nw, num_bins=C,
                            separate_pol=separate_pol, plan=plan)
    _count_launch(voxelize_windows_bilinear_t_mxu)
    return grid


voxelize_windows_bilinear_t_mxu.launches = 0
