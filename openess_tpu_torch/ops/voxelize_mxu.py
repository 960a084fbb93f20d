"""The grid wire's device voxelizers: K5 (DSEC, trilinear) and K6 (DDD17,
bilinear in time), the counterparts of ``openess_tpu/ops/voxelize_mxu.py``
under the same function names and contracts.

Each takes flat ``[num_windows * K]`` padded events (``x, y, p, t`` and a
bool ``valid``) and returns the per-window grids ``[num_windows * Cout, H,
W]`` f32. On a CUDA tensor the wrapper prepares the events as the JAX
wrapper does around its ``pallas_call`` (per-window time normalization over
the valid events; padding routed out of every corner) and launches its
kernel from ``csrc/voxelize_grid.cu``, counting the launch in
``.launches``. On a CPU tensor it runs its plain version, the exact scatter
of ``ops/voxelize.py``. Any other device raises.

The TPU kernels multiply one-hot matrices in bf16 on the matrix unit; the
port's kernels scatter in exact f32, as K1 and K4 do. They differ from the
TPU kernels by that rounding (about 5e-3 of the grid max) and from the
plain versions by the order of the f32 atomics only.
"""
from __future__ import annotations

import ctypes

import torch

from openess_tpu_torch.ops.voxelize import (
    _normalized_times,
    voxel_grid_bilinear_t,
    voxelize_windows_trilinear,
)

PAD = -4.0  # coordinate and time marker that no corner of the grid reaches


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


def _launch(name: str, events, grid, *ints):
    """Launch the C entry ``name`` of ``csrc/voxelize_grid.cu`` on the
    current stream over the four prepared ``[nw, k]`` f32 event arrays into
    the zero-filled ``grid``."""
    from openess_tpu_torch.ops import _build

    if not all(a.dtype == torch.float32 and a.is_contiguous()
               for a in events):
        raise ValueError("prepared events must be contiguous f32")
    fn = _build.entry("voxelize_grid.cu", name, *[ctypes.c_void_p] * 5,
                      *[ctypes.c_int] * len(ints))
    _build.launch(fn, grid.device, *(a.data_ptr() for a in events),
                  grid.data_ptr(), *ints)


def trilinear_events(x, y, p, t, valid, num_windows: int, num_bins: int):
    """The four ``[num_windows, K]`` f32 arrays K5 reads, made as the JAX
    wrapper makes them before its ``pallas_call``: ``x, y``, the normalized
    time and the value ``2p - 1``, padding carrying value 0 and the ``PAD``
    marker, outside every corner window."""
    nw, C = num_windows, num_bins
    vs = valid.reshape(nw, -1)
    tn = _normalized_times(t.reshape(nw, -1), vs, C, positive_dt=True)
    value = torch.where(vs, 2.0 * p.float().reshape(nw, -1) - 1.0, 0.0)
    return (torch.where(vs, x.float().reshape(nw, -1), PAD),
            torch.where(vs, y.float().reshape(nw, -1), PAD),
            torch.where(vs, tn, PAD), value)


def bilinear_t_events(x, y, p, t, valid, num_windows: int, num_bins: int,
                      height: int, width: int):
    """The four ``[num_windows, K]`` f32 arrays K6 reads, made as the JAX
    wrapper makes them: ``x, y``, the normalized time and the polarity
    (0 counted as -1), validity and the frame folded into the markers
    (polarity 0, ``PAD`` elsewhere)."""
    nw, C = num_windows, num_bins
    vs = valid.reshape(nw, -1)
    xs, ys = x.float().reshape(nw, -1), y.float().reshape(nw, -1)
    tn = _normalized_times(t.reshape(nw, -1), vs, C, positive_dt=False)
    pol = p.float().reshape(nw, -1)
    pol = torch.where(pol == 0, -1.0, pol)
    inb = vs & (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    return (torch.where(inb, xs, PAD), torch.where(inb, ys, PAD),
            torch.where(inb, tn, PAD), torch.where(inb, pol, 0.0))


def voxelize_windows_trilinear_mxu(x, y, p, t, valid, *, num_windows: int,
                                   num_bins: int, height: int,
                                   width: int) -> torch.Tensor:
    """DSEC trilinear voxelization of padded events over equal windows (K5).

    ``x, y`` f32 coordinates (fractional, may be negative), ``p`` in
    {0, 1}, ``t`` any monotonic time (cast to f32 here), ``valid`` bool;
    each flat ``[num_windows * K]``. Returns ``[num_windows * num_bins, H,
    W]`` f32, the layout of ``voxelize_windows_trilinear``.

    A CUDA tensor launches K5 and counts it in
    ``voxelize_windows_trilinear_mxu.launches``; a CPU tensor runs the
    plain version :func:`ops.voxelize.voxelize_windows_trilinear`.
    """
    nw, C, H, W = num_windows, num_bins, height, width
    k = _check_events(x, y, p, t, valid, nw)
    dev = x.device
    if dev.type == "cpu":
        return voxelize_windows_trilinear(
            x, y, p, t, valid, num_windows=nw, num_bins=C, height=H, width=W)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device for K5: {dev}")
    grid = torch.zeros((nw * C, H, W), dtype=torch.float32, device=dev)
    _launch("voxelize_windows_trilinear",
            trilinear_events(x, y, p, t, valid, nw, C), grid, nw, k, C, H, W)
    voxelize_windows_trilinear_mxu.launches += 1
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

    A CUDA tensor launches K6 and counts it in
    ``voxelize_windows_bilinear_t_mxu.launches``; a CPU tensor runs the
    plain version :func:`ops.voxelize.voxel_grid_bilinear_t`. The two
    agree wherever the coordinates are integers, as DDD17's are. An event
    with ``x`` or ``y`` in (-1, 0) is dropped by the kernel's in-frame test
    on the coordinate, as by the TPU wrapper, and kept at pixel 0 by the
    exact scatter, which truncates first.
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
    grid = torch.zeros((nw * cout, H, W), dtype=torch.float32, device=dev)
    _launch("voxelize_windows_bilinear_t",
            bilinear_t_events(x, y, p, t, valid, nw, C, H, W), grid,
            nw, k, C, int(separate_pol), H, W)
    voxelize_windows_bilinear_t_mxu.launches += 1
    return grid


voxelize_windows_bilinear_t_mxu.launches = 0
