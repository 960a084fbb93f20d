"""Voxel-grid post-ops (the part of ``openess_tpu/ops/voxelize.py`` on the
serving path). The exact scatter voxelizers of that module are still to be
ported."""
from __future__ import annotations

import torch


def normalize_nonzero(grid: torch.Tensor, *, unbiased: bool) -> torch.Tensor:
    """Standardize the nonzero entries of ``grid`` (zeros untouched).

    ``unbiased=True`` is torch ``Tensor.std()`` (ddof=1, the DSEC flavour);
    ``unbiased=False`` is ``sqrt(E[x^2] - E[x]^2)`` (the DDD17 flavour). An
    all-zero grid is returned unchanged.
    """
    nz = grid != 0
    cnt = nz.sum()
    cnt_safe = torch.clamp(cnt, min=1)
    zero = torch.zeros((), dtype=grid.dtype, device=grid.device)
    mean = torch.where(nz, grid, zero).sum() / cnt_safe
    if unbiased:
        var = torch.where(nz, (grid - mean) ** 2, zero).sum() / torch.clamp(
            cnt - 1, min=1
        )
    else:
        sq = torch.where(nz, grid * grid, zero).sum() / cnt_safe
        var = sq - mean * mean
    std = torch.sqrt(var)
    centered = torch.where(std > 0, (grid - mean) / std, grid - mean)
    out = torch.where(nz, centered, grid)
    return torch.where(cnt > 0, out, grid)
