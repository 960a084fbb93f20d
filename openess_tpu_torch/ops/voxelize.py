"""Event stream -> dense representation, exact f32 scatters: the
counterpart of ``openess_tpu/ops/voxelize.py``.

- :func:`voxel_grid_trilinear`: DSEC's signed trilinear (x, y, t) voxel
  grid (8 corners, polarity values +-1).
- :func:`voxel_grid_bilinear_t`: DDD17's voxel grid, integer pixels,
  bilinear in time only, signed or split into positive and negative
  channel blocks.
- :func:`event_histogram`: the 2-channel (neg, pos) event count image.
- :func:`voxelize_windows_trilinear`: a padded stream cut into equal
  windows, each voxelized on its own.
- :func:`normalize_nonzero`: nonzero mean/std normalization, biased (DDD17)
  or unbiased (DSEC).

Each function takes fixed-size padded event arrays with a ``valid`` mask.
The voxelizers take any leading batch dimensions, one window per index,
and accumulate each corner with ``index_put_(accumulate=True)`` under the
JAX package's masks: corners truncated toward zero (torch ``.int()``,
which gives a fractional negative coordinate the corner pair {0, 1} with a
negative weight on corner 1), corners outside the grid dropped, times
normalized per window over the valid events only.

``voxel_grid_trilinear`` and ``voxel_grid_bilinear_t`` over windows are the
plain versions of the grid wire's kernels K5 and K6
(``ops/voxelize_mxu.py``), and what those wrappers run on a CPU tensor.
"""
from __future__ import annotations

import torch


def _masked_first_last(t: torch.Tensor, valid: torch.Tensor):
    """First and last *valid* timestamp of each window (the last axis), as
    f32 ``[..., 1]``. A window without a valid event gets ``(max, -max)``
    of f32."""
    big = torch.finfo(torch.float32).max
    tf = t.float()
    t_first = torch.where(valid, tf, big).amin(dim=-1, keepdim=True)
    t_last = torch.where(valid, tf, -big).amax(dim=-1, keepdim=True)
    return t_first, t_last


def _normalized_times(t, valid, num_bins: int, *, positive_dt: bool):
    """``(num_bins - 1) * (t - t_first) / dt`` per window (the last axis)
    over the valid events, in f32. ``dt`` is ``t_last - t_first``, replaced
    by 1 where it is not positive (``positive_dt``, DSEC's trilinear grid)
    or where it is zero (DDD17's), as each JAX function does."""
    ts = t.float()
    t_first, t_last = _masked_first_last(ts, valid)
    dt = t_last - t_first
    dt = torch.where(dt > 0 if positive_dt else dt != 0, dt, 1.0)
    return (num_bins - 1) * (ts - t_first) / dt


def _flat_windows(*arrays):
    """``[..., K]`` arrays -> ``([NB, K] arrays, leading shape)``."""
    lead = tuple(arrays[0].shape[:-1])
    k = arrays[0].shape[-1]
    return tuple(a.reshape(-1, k) for a in arrays), lead


def voxel_grid_trilinear(x, y, p, t, valid, *, num_bins: int, height: int,
                         width: int, normalize: bool = False) -> torch.Tensor:
    """Signed trilinear voxel grid (DSEC).

    ``x, y``: float event coordinates (rectified; may be fractional or
    negative); ``p``: polarity in {0, 1}; ``t``: timestamps, normalized per
    window to ``(num_bins - 1) * (t - t_first) / (t_last - t_first)`` in
    f32; ``valid``: bool, False for padding. Each ``[..., K]``; returns
    ``[..., num_bins, height, width]`` f32 with the +-1-weighted 8-corner
    contributions. ``normalize`` applies the unbiased nonzero normalization
    to each window.
    """
    C, H, W = num_bins, height, width
    (x, y, p, t, valid), lead = _flat_windows(x, y, p, t, valid)
    nb = x.shape[0]
    x, y = x.float(), y.float()
    t_norm = _normalized_times(t, valid, C, positive_dt=True)
    x0, y0, t0 = x.int(), y.int(), t_norm.int()  # trunc toward zero
    value = 2.0 * p.float() - 1.0
    win = torch.arange(nb, device=x.device)[:, None].long()

    total = torch.zeros(nb * C * H * W, dtype=torch.float32, device=x.device)
    for xlim in (x0, x0 + 1):
        wx = 1.0 - torch.abs(xlim.float() - x)
        in_x = (xlim >= 0) & (xlim < W)
        for ylim in (y0, y0 + 1):
            wy = 1.0 - torch.abs(ylim.float() - y)
            in_y = (ylim >= 0) & (ylim < H)
            for tlim in (t0, t0 + 1):
                wt = 1.0 - torch.abs(tlim.float() - t_norm)
                mask = valid & in_x & in_y & (tlim >= 0) & (tlim < C)
                idx = ((win * C + tlim) * H + ylim) * W + xlim
                total.index_put_((idx[mask],), (value * wx * wy * wt)[mask],
                                 accumulate=True)
    grid = total.view(nb, C, H, W)
    if normalize:
        grid = normalize_nonzero(grid, unbiased=True, dims=(1, 2, 3))
    return grid.reshape(lead + (C, H, W))


def voxel_grid_bilinear_t(x, y, p, t, valid, *, num_bins: int, height: int,
                          width: int, separate_pol: bool = True,
                          normalize: bool = False) -> torch.Tensor:
    """Voxel grid with bilinear binning in time only, per polarity (DDD17).

    ``x, y`` are truncated to integer pixels; ``p`` may be {0, 1} or
    {-1, 1}, zeros counting as -1. Each input ``[..., K]``; returns
    ``[..., 2 * num_bins, H, W]`` (positive then negative) with
    ``separate_pol``, else the signed difference ``[..., num_bins, H, W]``,
    f32. ``normalize`` applies the biased nonzero normalization to each
    window.
    """
    C, H, W = num_bins, height, width
    (x, y, p, t, valid), lead = _flat_windows(x, y, p, t, valid)
    nb = x.shape[0]
    xi, yi = x.int(), y.int()

    ts = _normalized_times(t, valid, C, positive_dt=False)

    pol = p.float()
    pol = torch.where(pol == 0, -1.0, pol)
    is_pos = pol == 1.0

    tis = ts.int()  # ts >= 0 for valid events, so trunc == floor
    dts = ts - tis.float()
    vals_left = torch.abs(pol) * (1.0 - dts)
    vals_right = torch.abs(pol) * dts

    in_bounds = (valid & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
                 & (ts >= 0) & (ts < C))
    win = torch.arange(nb, device=x.device)[:, None].long()
    idx_left = ((win * C + tis) * H + yi) * W + xi
    idx_right = idx_left + H * W
    left_ok = in_bounds & (tis < C)
    right_ok = in_bounds & (tis + 1 < C)

    def accum(sel):
        out = torch.zeros(nb * C * H * W, dtype=torch.float32,
                          device=x.device)
        for idx, vals, ok in ((idx_left, vals_left, left_ok),
                              (idx_right, vals_right, right_ok)):
            keep = ok & sel
            out.index_put_((idx[keep],), vals[keep], accumulate=True)
        return out.view(nb, C, H, W)

    pos, neg = accum(is_pos), accum(~is_pos)
    grid = torch.cat([pos, neg], dim=1) if separate_pol else pos - neg
    if normalize:
        grid = normalize_nonzero(grid, unbiased=False, dims=(1, 2, 3))
    return grid.reshape(lead + tuple(grid.shape[1:]))


def event_histogram(x, y, p, valid, *, height: int, width: int):
    """2-channel (neg, pos) event-count image ``[..., 2, H, W]`` f32 of
    ``[..., K]`` events at their truncated pixels; ``p`` 0 counts as
    negative."""
    H, W = height, width
    (x, y, p, valid), lead = _flat_windows(x, y, p, valid)
    nb = x.shape[0]
    xi, yi = x.int(), y.int()
    pol = p.float()
    pol = torch.where(pol == 0, -1.0, pol)
    in_bounds = valid & (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    win = torch.arange(nb, device=x.device)[:, None].long()
    out = torch.zeros(nb * 2 * H * W, dtype=torch.float32, device=x.device)
    for ch, sel in ((0, pol != 1.0), (1, pol == 1.0)):
        keep = in_bounds & sel
        idx = ((win * 2 + ch) * H + yi) * W + xi
        out.index_put_((idx[keep],), torch.ones_like(pol)[keep],
                       accumulate=True)
    return out.view(lead + (2, H, W))


def voxelize_windows_trilinear(x, y, p, t, valid, *, num_windows: int,
                               num_bins: int, height: int, width: int,
                               normalize: bool = False) -> torch.Tensor:
    """A padded event stream cut into ``num_windows`` equal windows, each
    voxelized on its own by :func:`voxel_grid_trilinear`. Flat
    ``[num_windows * K]`` inputs; returns ``[num_windows * num_bins, H,
    W]``."""
    n = x.shape[0]
    if n % num_windows:
        raise ValueError(f"{n} events do not split into {num_windows} "
                         "equal windows")
    grids = voxel_grid_trilinear(
        *(a.reshape(num_windows, -1) for a in (x, y, p, t, valid)),
        num_bins=num_bins, height=height, width=width, normalize=normalize)
    return grids.reshape(num_windows * num_bins, height, width)


def normalize_nonzero(grid: torch.Tensor, *, unbiased: bool,
                      dims=None) -> torch.Tensor:
    """Standardize the nonzero entries of ``grid`` (zeros untouched).

    ``unbiased=True`` is torch ``Tensor.std()`` (ddof=1, the DSEC flavour);
    ``unbiased=False`` is ``sqrt(E[x^2] - E[x]^2)`` (the DDD17 flavour). The
    statistics run over ``dims`` (all of them by default), so a batch of
    windows ``[N, C, H, W]`` is normalized window by window in one call with
    ``dims=(1, 2, 3)``. A grid with no nonzero entry is returned unchanged.
    """
    dims = tuple(range(grid.dim())) if dims is None else tuple(dims)
    nz = grid != 0
    cnt = nz.sum(dims, keepdim=True)
    cnt_safe = torch.clamp(cnt, min=1)
    zero = torch.zeros((), dtype=grid.dtype, device=grid.device)
    mean = torch.where(nz, grid, zero).sum(dims, keepdim=True) / cnt_safe
    if unbiased:
        var = torch.where(nz, (grid - mean) ** 2, zero).sum(
            dims, keepdim=True) / torch.clamp(cnt - 1, min=1)
    else:
        sq = torch.where(nz, grid * grid, zero).sum(
            dims, keepdim=True) / cnt_safe
        var = sq - mean * mean
    std = torch.sqrt(var)
    centered = torch.where(std > 0, (grid - mean) / std, grid - mean)
    out = torch.where(nz, centered, grid)
    return torch.where(cnt > 0, out, grid)
