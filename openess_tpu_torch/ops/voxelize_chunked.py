"""Sorted-chunk event wire and its two voxelizers: K1 (DSEC, trilinear)
and K4 (DDD17, exact pixel and bilinear in time).

Host half (numpy, bit-identical to ``openess_tpu/ops/voxelize_chunked.py``):
per window, the events are quantized to the wire (x, y int16 fixed point
x32, p uint8, t relative as f32 (v1) or uint16 against ``t_range`` (v2)),
counting-sorted by (16-row tile, x corner) and cut greedily into chunks of
at most ``CHUNK`` events whose corners fit one 16-row x 256-column block,
located by a packed ``r0 | c0 << 16`` descriptor.

Device half: :func:`voxelize_chunked_trilinear` splats the wire into
``[NW, bins, H, W]`` f32 grids. On a CUDA tensor it launches the K1 kernel
(``csrc/voxelize_chunked.cu``, replacing the TPU kernel ``_tri_kernel``), a
tile-owner splat that writes every cell of the grid once, so the grid is a
``torch.empty`` (``ops/tile_splat.py`` plans its tiles); on a CPU tensor it
runs :func:`voxelize_chunked_trilinear_plain`, the same dequantization and
the same 8 corners through ``index_put_``. Both are exact f32 splats: the
TPU kernel's bf16 multiplicands (about 5e-3 of the grid max) are not
reproduced.

:func:`voxelize_chunked_bilinear_t` is the DDD17 counterpart: integer
pixels, weights ``1 - dts`` and ``dts`` into time bins ``ti`` and ``ti + 1``,
signed by polarity or split into positive and negative channel blocks. On a
CUDA tensor it launches the K4 kernel (same source file, replacing the TPU
kernel ``_bil_kernel``), K1's tile owner with a two-corner splat, into a
``torch.empty`` grid; on a CPU tensor
:func:`voxelize_chunked_bilinear_t_plain`. Exact f32 as well: it differs
from the TPU kernel by the bf16 rounding of the two time weights (about
4e-3 relative) and from the exact scatter by f32 round-off.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from openess_tpu_torch.ops.tile_splat import TilePlan, tile_plan

FIXED_POINT = 32          # coord fixed-point scale (1/32 px)
TILE_ROWS = 16            # image rows per chunk tile
TILE_COLS = 128           # image cols per chunk tile
CHUNK = 1024              # max events per chunk
_ROWS_TRI = TILE_ROWS + 8   # per-bin row block of the padded grid
_COLS_TRI = 2 * TILE_COLS   # x-corner pair may spill one column past a tile


def num_chunks(k: int, height: int, *, width: int, chunk: int = CHUNK) -> int:
    """Worst-case chunk count for a window of ``k`` events: every chunk ends
    either full (<= ceil(k/chunk) such cuts) or at a (row-tile x col-tile)
    segment change (<= #segments)."""
    n_seg = (-(-height // TILE_ROWS)) * (((width - 1) // TILE_COLS) + 1)
    return -(-k // chunk) + n_seg + 1


# ---------------------------------------------------------------------------
# host-side chunker (numpy)
# ---------------------------------------------------------------------------


def chunk_events_window(
    x, y, p, t, valid, *, height: int, width: int, chunk: int = CHUNK,
    integer_coords: bool = False, t16: bool = False,
):
    """Sort one window's events into tile-pure chunks.

    Args: float (or integer) event coords ``x, y``, polarity ``p`` {0,1},
    timestamps ``t`` (any monotonic unit, time-sorted), bool ``valid``.

    Returns ``(xq, yq, pq, t_rel, counts, tile_r0, t_range)`` with
    ``xq/yq`` int16 fixed-point [NBC, chunk], ``pq`` uint8, ``t_rel`` f32
    (uint16 when ``t16``), ``counts``/``tile_r0`` int32 [NBC], ``t_range``
    f32 scalar. ``integer_coords`` is the DDD17 convention (drop events
    outside the frame; no corner spill).
    """
    nbc = num_chunks(x.shape[0], height, width=width, chunk=chunk)
    t_dtype = np.uint16 if t16 else np.float32
    xq_o = np.zeros((nbc, chunk), np.int16)
    yq_o = np.zeros((nbc, chunk), np.int16)
    pq_o = np.zeros((nbc, chunk), np.uint8)
    tr_o = np.zeros((nbc, chunk), t_dtype)
    counts = np.zeros((nbc,), np.int32)
    tile_r0 = np.zeros((nbc,), np.int32)

    v = np.asarray(valid, bool)
    if not v.any():
        return xq_o, yq_o, pq_o, tr_o, counts, tile_r0, np.float32(1.0)

    # window time normalization over ALL valid events (incl. dropped
    # out-of-frame ones)
    tv = np.asarray(t, np.float64)[v]
    t_first = tv.min()
    dt = tv.max() - t_first
    t_range = np.float32(dt if dt > 0 else 1.0)

    # quantize first; the fraction is quantized relative to trunc(x) and
    # clamped to +/-31/32 so the dequantized coord keeps the original
    # trunc-toward-zero corner pair (the weight function is discontinuous at
    # negative integers)
    def quant(a):
        af = np.asarray(a, np.float64)
        a0 = np.trunc(af)
        fq = np.clip(
            np.round((af - a0) * FIXED_POINT),
            -(FIXED_POINT - 1), FIXED_POINT - 1,
        )
        return np.clip(
            a0 * FIXED_POINT + fq,
            np.iinfo(np.int16).min, np.iinfo(np.int16).max,
        ).astype(np.int32)

    xq = quant(x)
    yq = quant(y)
    y0 = (np.abs(yq) // FIXED_POINT) * np.sign(yq)  # trunc toward zero

    if integer_coords:
        keep = v & (xq >= 0) & (xq < width * FIXED_POINT) & (yq >= 0) & (
            yq < height * FIXED_POINT
        )
    else:
        # keep events with any in-range corner: y0 in [-1, H-1], x corner
        # pair {x0, x0+1} intersecting [0, W)
        keep = (
            v
            & (yq > -2 * FIXED_POINT) & (yq < height * FIXED_POINT)
            & (xq > -2 * FIXED_POINT) & (xq < width * FIXED_POINT)
        )
    if not keep.any():
        return xq_o, yq_o, pq_o, tr_o, counts, tile_r0, t_range

    x0 = (np.abs(xq) // FIXED_POINT) * np.sign(xq)  # trunc toward zero
    xq, yq, y0, x0 = xq[keep], yq[keep], y0[keep], x0[keep]
    pk = np.asarray(p)[keep]
    trel = (np.asarray(t, np.float64)[keep] - t_first).astype(np.float32)
    if t16:
        # f32 op order of the C++ packer (f32 scale division, f32 product,
        # round-half-even), so the packers stay bit-identical
        tscale = np.float32(65535.0) / t_range
        trel = np.minimum(
            np.round(trel * tscale), np.float32(65535.0)
        ).astype(np.uint16)

    # sort by (16-row tile, x corner); cut greedily where the run would
    # overflow the block ([c0, c0+256) for trilinear incl. the +1 corner
    # spill; [c0, c0+128) exact for DDD17), c0 = 128-aligned floor of the
    # chunk's first x corner
    xclip = np.clip(x0, 0, width - 1)
    ytile = np.clip(y0, 0, height - 1) // TILE_ROWS
    key = ytile.astype(np.int64) * width + xclip
    order = np.argsort(key, kind="stable")
    ytile, xclip = ytile[order], xclip[order]
    x0s = x0[order]
    span = TILE_COLS if integer_coords else 2 * TILE_COLS - 1

    boundaries = [0]
    c0 = (xclip[0] // TILE_COLS) * TILE_COLS
    for i in range(1, ytile.size):
        if (
            ytile[i] != ytile[i - 1]
            or x0s[i] - c0 >= span
            or (i - boundaries[-1]) >= chunk
        ):
            boundaries.append(i)
            c0 = (xclip[i] // TILE_COLS) * TILE_COLS
    boundaries.append(ytile.size)

    xq, yq, pk, trel = xq[order], yq[order], pk[order], trel[order]
    for ci in range(len(boundaries) - 1):
        a, b = boundaries[ci], boundaries[ci + 1]
        n = b - a
        if n > chunk or ci >= nbc:
            raise AssertionError((n, ci, nbc))
        xq_o[ci, :n] = xq[a:b]
        yq_o[ci, :n] = yq[a:b]
        pq_o[ci, :n] = (pk[a:b] > 0)  # handles ±1 polarity encodings
        tr_o[ci, :n] = trel[a:b]
        counts[ci] = n
        # packed descriptor: row offset | (col offset << 16)
        tile_r0[ci] = ytile[a] * TILE_ROWS + (
            (xclip[a] // TILE_COLS) * TILE_COLS << 16
        )
    # padding chunks repeat the last tile's descriptor
    tile_r0[len(boundaries) - 1 :] = tile_r0[len(boundaries) - 2]
    return xq_o, yq_o, pq_o, tr_o, counts, tile_r0, t_range


def chunk_events_batch(x, y, p, t, valid, *, height, width, chunk=CHUNK,
                       integer_coords=False, t16=False):
    """Stack :func:`chunk_events_window` over ``[NW, K]`` inputs."""
    outs = [
        chunk_events_window(
            x[w], y[w], p[w], t[w], valid[w],
            height=height, width=width, chunk=chunk,
            integer_coords=integer_coords, t16=t16,
        )
        for w in range(x.shape[0])
    ]
    return tuple(np.stack([o[i] for o in outs]) for i in range(7))


def pad_wire_chunks(wire, nbc: int):
    """Zero-pad a chunked wire's chunk axis (axis 1 of every ``[NW, nbc,
    ...]`` array) up to ``nbc`` chunks, leaving per-window scalars
    (``t_range``, ndim 1) untouched. Padded chunks have ``counts == 0`` and
    add nothing, so the grid is bit-identical; a streaming server uses this
    to keep one wire shape across windows. No-op when the wire already has
    ``>= nbc`` chunks."""
    have = wire[0].shape[1]
    if have >= nbc:
        return wire
    pad = nbc - have
    return tuple(
        np.pad(a, ((0, 0), (0, pad)) + ((0, 0),) * (a.ndim - 2))
        if a.ndim >= 2 else a
        for a in wire
    )


# Bucketed wire widths: a trimmed chunk count is rounded UP to this ladder
# (~sqrt(2) steps), so a batch sheds the worst-case padding while the number
# of distinct wire shapes stays small.
WIRE_NBC_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128, 160, 192, 224)


def bucket_nbc(used: int, cap: int) -> int:
    """A chunk count rounded up to ``WIRE_NBC_BUCKETS``, at most ``cap``."""
    return next((min(b, cap) for b in WIRE_NBC_BUCKETS if b >= used), cap)


def trim_wire_chunks(wire):
    """Cut a chunked wire's chunk axis to the bucketed batch-max USED chunk
    count (never above its current width): what the C++ packer ships by
    default (``native.chunk_events_windows_host(trim=True)``), here as its
    plain version. Used chunks are a prefix, so nothing is lost."""
    counts = wire[4]
    used = int((counts > 0).sum(axis=1).max(initial=0))
    nbc = bucket_nbc(used, counts.shape[1])
    return tuple(
        np.ascontiguousarray(a[:, :nbc]) if a.ndim >= 2 else a for a in wire
    )


# ---------------------------------------------------------------------------
# device half: K1
# ---------------------------------------------------------------------------


def padded_grid(height: int, width: int) -> tuple[int, int]:
    """(h_pad, w_pad) of the TPU kernel's padded grid, which bounds the
    chunk blocks [r0, r0+24) x [c0, c0+256)."""
    w_pad = ((width - 1) // TILE_COLS) * TILE_COLS + _COLS_TRI
    h_pad = (-(-height // TILE_ROWS) - 1) * TILE_ROWS + _ROWS_TRI
    return h_pad, w_pad


def _check_wire(xq, yq, pq, t_rel, counts, tile_r0, t_range):
    nw, nbc, e = xq.shape
    want = {
        "xq": (xq, torch.int16, (nw, nbc, e)),
        "yq": (yq, torch.int16, (nw, nbc, e)),
        "pq": (pq, torch.uint8, (nw, nbc, e)),
        "counts": (counts, torch.int32, (nw, nbc)),
        "tile_r0": (tile_r0, torch.int32, (nw, nbc)),
        "t_range": (t_range, torch.float32, (nw,)),
    }
    for name, (a, dt, shape) in want.items():
        if a.dtype != dt or tuple(a.shape) != shape:
            raise ValueError(
                f"{name}: expected {dt} {shape}, got {a.dtype} {tuple(a.shape)}"
            )
    if t_rel.dtype not in (torch.uint16, torch.float32) or tuple(
        t_rel.shape
    ) != (nw, nbc, e):
        raise ValueError(
            f"t_rel: expected uint16 or float32 {(nw, nbc, e)}, got "
            f"{t_rel.dtype} {tuple(t_rel.shape)}"
        )
    devs = {a.device for a in (xq, yq, pq, t_rel, counts, tile_r0, t_range)}
    if len(devs) != 1:
        raise ValueError(f"wire tensors on several devices: {devs}")


def _dequant(xq, yq, pq, t_rel, t_range, num_bins):
    """The kernel's dequantization (the TPU path's ``_prep``), f32."""
    # python floats multiply an f32 tensor in f32; 1/65535 rounds to the
    # kernel's f32 constant
    x = xq.float() * (1.0 / FIXED_POINT)
    y = yq.float() * (1.0 / FIXED_POINT)
    if t_rel.dtype == torch.uint16:
        t = (t_rel.view(torch.int16).to(torch.int32) & 0xFFFF).float()
        tn = float(num_bins - 1) * t * (1.0 / 65535.0)
    else:
        rng = torch.clamp(t_range, min=1e-9)[:, None, None]
        tn = float(num_bins - 1) * t_rel / rng
    v = 2.0 * pq.float() - 1.0
    return x, y, tn, v


def voxelize_chunked_trilinear_plain(
    xq, yq, pq, t_rel, counts, tile_r0, t_range,
    *, num_bins: int, height: int, width: int,
) -> torch.Tensor:
    """K1's plain PyTorch version: the same dequantization, corners, block
    masks and f32 product order as the kernel, accumulated with
    ``index_put_(accumulate=True)``. Returns ``[NW, num_bins, H, W]`` f32."""
    _check_wire(xq, yq, pq, t_rel, counts, tile_r0, t_range)
    nw, nbc, e = xq.shape
    h_pad, w_pad = padded_grid(height, width)
    r0 = torch.clamp(tile_r0 & 0xFFFF, 0, h_pad - _ROWS_TRI)[..., None]
    c0 = torch.clamp(tile_r0 >> 16, 0, w_pad - _COLS_TRI)[..., None]
    slot = torch.arange(e, device=xq.device)
    valid = slot < counts[..., None]
    x, y, tn, v = _dequant(xq, yq, pq, t_rel, t_range, num_bins)
    x0, y0, t0 = x.int(), y.int(), tn.int()  # trunc toward zero
    win = torch.arange(nw, device=xq.device)[:, None, None]
    row_hi = torch.clamp(r0 + _ROWS_TRI, max=height)
    col_hi = torch.clamp(c0 + _COLS_TRI, max=width)
    out = torch.zeros(nw * num_bins * height * width, device=xq.device)
    for dx in (0, 1):
        cx = x0 + dx
        ok_x = valid & (cx >= c0) & (cx < col_hi) & (cx >= 0)
        wx = v * (1.0 - torch.abs(cx.float() - x))
        for dy in (0, 1):
            cy = y0 + dy
            ok_xy = ok_x & (cy >= r0) & (cy < row_hi) & (cy >= 0)
            wxy = wx * (1.0 - torch.abs(cy.float() - y))
            for dt in (0, 1):
                ct = t0 + dt
                ok = ok_xy & (ct >= 0) & (ct < num_bins)
                wt = 1.0 - torch.abs(ct.float() - tn)
                idx = ((win * num_bins + ct) * height + cy) * width + cx
                out.index_put_(
                    (idx[ok].long(),), (wxy * wt)[ok], accumulate=True
                )
    return out.view(nw, num_bins, height, width)


def _launch(name: str, wire, grid, *ints):
    """Check the CUDA wire and launch the C entry ``name`` of
    ``csrc/voxelize_chunked.cu`` on the current stream into ``grid``: 8
    device pointers, ``ints`` and the ``t16`` flag."""
    from openess_tpu_torch.ops import _build

    _check_wire(*wire)
    if not all(a.is_contiguous() for a in wire):
        raise ValueError("wire tensors must be contiguous")
    if grid.data_ptr() % 16:
        raise ValueError("grid must be 16-byte aligned: the tiles are "
                         "written in vector stores")
    fn = _build.entry("voxelize_chunked.cu", name, *[ctypes.c_void_p] * 8,
                      *[ctypes.c_int] * (len(ints) + 1))
    _build.launch(fn, grid.device, *(a.data_ptr() for a in wire),
                  grid.data_ptr(), *ints, int(wire[3].dtype == torch.uint16))


def voxelize_chunked_trilinear_into(grid, xq, yq, pq, t_rel, counts,
                                    tile_r0, t_range, *,
                                    plan: TilePlan | None = None) -> None:
    """Launch the K1 kernel on a CUDA wire into ``grid``, a contiguous f32
    ``[NW, bins, H, W]`` on the wire's card, whatever it holds: the
    tile-owner splat writes every cell once. What
    :func:`voxelize_chunked_trilinear` runs on a CUDA wire, with the tile
    of ``tile_plan`` unless ``plan`` gives another; a call here is not
    counted as a launch of K1."""
    nw, bins, height, width = grid.shape
    if (grid.dtype != torch.float32 or not grid.is_contiguous()
            or grid.device != xq.device or nw != xq.shape[0]):
        raise ValueError("grid must be a contiguous f32 [NW, bins, H, W] "
                         "beside the wire")
    h_pad, w_pad = padded_grid(height, width)
    plan = plan or tile_plan(bins, height, width)
    _launch(
        "voxelize_chunked_trilinear",
        (xq, yq, pq, t_rel, counts, tile_r0, t_range), grid,
        nw, xq.shape[1], xq.shape[2], bins, height, width,
        h_pad - _ROWS_TRI, w_pad - _COLS_TRI, plan.rows, plan.cols,
        plan.pitch, plan.tiles, plan.tiles_x, plan.smem_bytes,
    )


def voxelize_chunked_trilinear(
    xq, yq, pq, t_rel, counts, tile_r0, t_range,
    *, num_bins: int, height: int, width: int, normalize: bool = False,
) -> torch.Tensor:
    """DSEC trilinear voxelization of the chunked wire (K1).

    Args: ``xq/yq`` int16 [NW, NBC, E] fixed point, ``pq`` uint8,
    ``t_rel`` uint16 (v2) or f32 (v1), ``counts`` int32 [NW, NBC],
    ``tile_r0`` int32 [NW, NBC] packed descriptors, ``t_range`` f32 [NW].
    Returns ``[NW, num_bins, height, width]`` f32; ``normalize`` applies
    the unbiased nonzero normalization per window.

    A CUDA wire launches the K1 kernel (the tile-owner splat) and counts
    the launch in ``voxelize_chunked_trilinear.launches``; a CPU wire runs
    :func:`voxelize_chunked_trilinear_plain`.
    """
    dev = xq.device
    if dev.type == "cpu":
        grid = voxelize_chunked_trilinear_plain(
            xq, yq, pq, t_rel, counts, tile_r0, t_range,
            num_bins=num_bins, height=height, width=width,
        )
    elif dev.type == "cuda":
        # every cell is written once by the tile that owns it: no fill
        grid = torch.empty((xq.shape[0], num_bins, height, width),
                           dtype=torch.float32, device=dev)
        voxelize_chunked_trilinear_into(
            grid, xq, yq, pq, t_rel, counts, tile_r0, t_range)
        voxelize_chunked_trilinear.launches += 1
    else:
        raise ValueError(f"unsupported device for K1: {dev}")
    if normalize:
        from openess_tpu_torch.ops.voxelize import normalize_nonzero

        grid = normalize_nonzero(grid, unbiased=True, dims=(1, 2, 3))
    return grid


voxelize_chunked_trilinear.launches = 0


# ---------------------------------------------------------------------------
# device half: K4 (DDD17)
# ---------------------------------------------------------------------------


def padded_grid_bilinear(height: int, width: int) -> tuple[int, int]:
    """(h_pad, w_pad) of the TPU DDD17 kernel's padded grid, which bounds
    the chunk blocks [r0, r0+16) x [c0, c0+128)."""
    return (-(-height // TILE_ROWS) * TILE_ROWS,
            -(-width // TILE_COLS) * TILE_COLS)


def voxelize_chunked_bilinear_t_plain(
    xq, yq, pq, t_rel, counts, tile_r0, t_range,
    *, num_bins: int, height: int, width: int, separate_pol: bool = True,
) -> torch.Tensor:
    """K4's plain PyTorch version: the same dequantization, truncations,
    block masks and f32 weights as the kernel, accumulated with
    ``index_put_(accumulate=True)``. Returns ``[NW, Cout, H, W]`` f32."""
    _check_wire(xq, yq, pq, t_rel, counts, tile_r0, t_range)
    nw, nbc, e = xq.shape
    cout = 2 * num_bins if separate_pol else num_bins
    h_pad, w_pad = padded_grid_bilinear(height, width)
    r0 = torch.clamp(tile_r0 & 0xFFFF, 0, h_pad - TILE_ROWS)[..., None]
    c0 = torch.clamp(tile_r0 >> 16, 0, w_pad - TILE_COLS)[..., None]
    valid = torch.arange(e, device=xq.device) < counts[..., None]
    x, y, tn, v = _dequant(xq, yq, pq, t_rel, t_range, num_bins)
    xi, yi, ti = x.int(), y.int(), tn.int()  # trunc toward zero
    dts = tn - ti.float()
    ok = (
        valid & (tn >= 0)
        & (xi >= c0) & (xi < torch.clamp(c0 + TILE_COLS, max=width))
        & (yi >= r0) & (yi < torch.clamp(r0 + TILE_ROWS, max=height))
    )
    if separate_pol:
        sign = torch.ones_like(v)
        ch = torch.where(v > 0, ti, ti + num_bins)
    else:
        sign, ch = v, ti
    win = torch.arange(nw, device=xq.device)[:, None, None]
    idx = ((win * cout + ch) * height + yi) * width + xi
    out = torch.zeros(nw * cout * height * width, device=xq.device)
    for dt, wt in ((0, sign * (1.0 - dts)), (1, sign * dts)):
        keep = ok & (ti + dt < num_bins)
        out.index_put_(
            ((idx + dt * height * width)[keep].long(),), wt[keep],
            accumulate=True,
        )
    return out.view(nw, cout, height, width)


def voxelize_chunked_bilinear_t_into(grid, xq, yq, pq, t_rel, counts,
                                     tile_r0, t_range, *,
                                     separate_pol: bool = True) -> None:
    """Launch the K4 kernel on a CUDA wire into ``grid``, a contiguous f32
    ``[NW, Cout, H, W]`` on the wire's card (``Cout = 2 * bins`` with
    ``separate_pol``, else ``bins``), whatever it holds: the tile-owner
    splat writes every cell once. What :func:`voxelize_chunked_bilinear_t`
    runs on a CUDA wire, with the tile of ``tile_plan`` for ``Cout``
    channels; a call here is not counted as a launch of K4."""
    nw, cout, height, width = grid.shape
    if (grid.dtype != torch.float32 or not grid.is_contiguous()
            or grid.device != xq.device or nw != xq.shape[0]
            or (separate_pol and cout % 2)):
        raise ValueError("grid must be a contiguous f32 [NW, Cout, H, W] "
                         "beside the wire")
    _launch(
        "voxelize_chunked_bilinear_t",
        (xq, yq, pq, t_rel, counts, tile_r0, t_range), grid,
        nw, xq.shape[1], xq.shape[2], cout // 2 if separate_pol else cout,
        int(separate_pol), height, width,
        *_bilinear_t_constants(cout, height, width),
    )


@functools.lru_cache(maxsize=None)
def _bilinear_t_constants(cout: int, height: int, width: int) -> tuple:
    """K4's launch constants for a ``[*, cout, height, width]`` grid: the
    clamp's bounds and the tile plan. Kept per shape: the server launches
    K4 once a window, where each microsecond of the wrapper's Python is
    host latency."""
    h_pad, w_pad = padded_grid_bilinear(height, width)
    plan = tile_plan(cout, height, width)
    return (h_pad - TILE_ROWS, w_pad - TILE_COLS, plan.rows, plan.cols,
            plan.pitch, plan.tiles, plan.tiles_x, plan.smem_bytes)


def voxelize_chunked_bilinear_t(
    xq, yq, pq, t_rel, counts, tile_r0, t_range,
    *, num_bins: int, height: int, width: int, separate_pol: bool = True,
    normalize: bool = False,
) -> torch.Tensor:
    """DDD17 bilinear-in-time voxelization of the chunked wire (K4).

    The wire is K1's (packed with ``integer_coords=True``). Returns
    ``[NW, Cout, height, width]`` f32 with ``Cout = 2 * num_bins``, positive
    then negative polarity, when ``separate_pol``, else ``num_bins`` signed;
    ``normalize`` applies the biased nonzero normalization per window.

    A CUDA wire launches the K4 kernel (the tile-owner splat) and counts
    the launch in ``voxelize_chunked_bilinear_t.launches``; a CPU wire runs
    :func:`voxelize_chunked_bilinear_t_plain`.
    """
    dev = xq.device
    if dev.type == "cpu":
        grid = voxelize_chunked_bilinear_t_plain(
            xq, yq, pq, t_rel, counts, tile_r0, t_range, num_bins=num_bins,
            height=height, width=width, separate_pol=separate_pol,
        )
    elif dev.type == "cuda":
        cout = 2 * num_bins if separate_pol else num_bins
        # every cell is written once by the tile that owns it: no fill
        grid = torch.empty((xq.shape[0], cout, height, width),
                           dtype=torch.float32, device=dev)
        voxelize_chunked_bilinear_t_into(
            grid, xq, yq, pq, t_rel, counts, tile_r0, t_range,
            separate_pol=separate_pol)
        voxelize_chunked_bilinear_t.launches += 1
    else:
        raise ValueError(f"unsupported device for K4: {dev}")
    if normalize:
        from openess_tpu_torch.ops.voxelize import normalize_nonzero

        grid = normalize_nonzero(grid, unbiased=False, dims=(1, 2, 3))
    return grid


voxelize_chunked_bilinear_t.launches = 0
