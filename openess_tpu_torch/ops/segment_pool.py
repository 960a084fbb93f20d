"""K2: superpixel segment-mean pooling, the distillation hot op.

The counterpart of ``openess_tpu/ops/segment_pool.py``. Inputs are NHWC:
``feats [B, H, W, D]`` and ``seg_ids [B, H, W]`` with values in
``[0, segments_per_image)``; the batch offset ``b * segments_per_image`` is
applied here. :func:`segment_mean_pool` returns ``(means, counts)`` in the
feats dtype with ``means = sums / (counts + eps)`` computed from f32 sums
and counts and cast last; empty segments give zero rows; a global id
outside ``[0, B * segments_per_image)`` adds nothing. A per-image id
``>= segments_per_image`` is not clamped: it lands in the next image's
rows, as in the JAX package. (The JAX ``pixel_order`` argument is a TPU
layout device and has no counterpart.)

The sums and counts come from :func:`segment_pool_sums`. On CUDA tensors it
launches the K2 kernel (``csrc/segment_pool.cu``, replacing the TPU kernel
``_pool_kernel``), inside a ``torch.autograd.Function`` where autograd
records a graph; its backward is the gather ``g_sums.to(feats.dtype)[ids]``
(zero rows for skipped pixels; the JAX backward is the same plain
``take``, cast before the gather). On
CPU tensors it runs :func:`segment_pool_sums_plain`, an ``index_add_`` in
f32. :func:`segment_mean_pool` hands the kernel the image structure
(``rows_per_image``, ``segments_per_image``); :func:`pool_plan` turns it
into the kernel's blocks: each owns a range of one image's rows and sums
them into a shared-memory table of that image's segments.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from openess_tpu_torch.parallel.mesh import all_sum

LANE_FLOATS = 8           # channels of a row a lane owns (its f32 run sum)
MAX_TILE = 32 * LANE_FLOATS   # 256 channels: a warp a row
MIN_TILE = 32             # the narrowest channel tile before the window
                          # is capped
BLOCKS_PER_SM = 2         # resident blocks an SM the plan sizes for
SMEM_BUDGET = 115_712     # table bytes a block at two blocks an SM:
                          # (233 472 - 2 x 1 024 reserved) / 2
SMEM_LIMIT = 232_448      # shared memory a block can use on an H100
MIN_PART_ROWS = 1024      # fewest rows of a range when an image is split
H100_SMS = 132


@dataclasses.dataclass(frozen=True)
class PoolPlan:
    """K2's decomposition of ``rows`` feature rows of ``channels``
    channels into CUDA blocks: ``images`` images of ``rows_per_image``
    rows, image ``b``'s ids in ``[b * segments_per_image, ...)``. Block
    ``(x, y)`` sums rows :meth:`block_rows` ``(x)`` of channels
    ``[y * tile, (y + 1) * tile)`` into a shared-memory table of the ids
    :meth:`block_window` ``(x)``; an id outside it goes to device memory
    directly. ``vec`` channels a load, ``lanes`` lanes a row. The kernel
    takes every number of the split from here (``_Plan``: ``chunk``,
    ``pitch`` and ``smem_bytes`` too) and decides none itself."""

    rows: int
    channels: int
    segments: int
    rows_per_image: int
    segments_per_image: int
    vec: int
    tile: int
    window: int
    lanes: int
    parts: int

    @property
    def images(self) -> int:
        return self.rows // self.rows_per_image

    @property
    def tiles(self) -> int:
        """Channel tiles: the grid's y."""
        return -(-self.channels // self.tile)

    @property
    def blocks(self) -> int:
        """Row ranges: the grid's x, ``parts`` an image."""
        return self.images * self.parts

    @property
    def chunk(self) -> int:
        """Rows of a range (the last of an image may be shorter)."""
        return -(-self.rows_per_image // self.parts)

    @property
    def pitch(self) -> int:
        """Floats a table row takes: the tile, one more where a warp holds
        several row groups (``lanes < 32``), so that their rows start in
        different banks."""
        return self.tile + 1 if self.lanes < 32 else self.tile

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a block: the f32 table ``[window,
        pitch]`` and an int count a table row."""
        return self.window * (self.pitch + 1) * 4

    def block_rows(self, block: int) -> tuple[int, int]:
        """Rows ``[lo, hi)`` of range ``block`` (image ``block //
        parts``)."""
        img, part = divmod(block, self.parts)
        first = img * self.rows_per_image
        return (first + min(part * self.chunk, self.rows_per_image),
                first + min((part + 1) * self.chunk, self.rows_per_image))

    def block_window(self, block: int) -> tuple[int, int]:
        """Ids ``[lo, hi)`` of range ``block``'s table."""
        lo = (block // self.parts) * self.segments_per_image
        return lo, max(lo, min(lo + self.window, self.segments))


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _images(rows: int, segments: int, rows_per_image: int | None,
            segments_per_image: int | None) -> tuple[int, int]:
    """``(rows_per_image, segments_per_image)``, the whole array as one
    image when neither is given; raises unless both or neither are, or
    when the rows are not whole images."""
    if rows_per_image is None and segments_per_image is None:
        return rows, segments
    if rows_per_image is None or segments_per_image is None:
        raise ValueError("K2 takes rows_per_image and segments_per_image "
                         "together")
    if rows_per_image <= 0 or rows % rows_per_image:
        raise ValueError(f"{rows} rows are not whole images of "
                         f"{rows_per_image} rows")
    return rows_per_image, segments_per_image


def pool_plan(rows: int, channels: int, segments: int, *, elem_size: int,
              aligned: bool = True, rows_per_image: int | None = None,
              segments_per_image: int | None = None,
              sms: int = H100_SMS) -> PoolPlan:
    """K2's plan for ``[rows, channels]`` features of ``elem_size`` bytes
    (2 bf16, 4 f32) into ``segments`` ids. Without ``rows_per_image`` and
    ``segments_per_image`` the rows are one image of ``segments`` ids.

    A load is 16 bytes (``vec`` 8 bf16 or 4 f32 channels) where every row
    starts 16-byte aligned (``aligned``: the data pointer; ``channels`` a
    multiple of ``vec``), else one channel. The channel tile is the whole
    width up to ``MAX_TILE``; where a table of ``segments_per_image`` rows
    at that width passes ``SMEM_BUDGET``, the tile narrows (down to
    ``MIN_TILE``), and only then is the window capped. Each image's rows
    split into ``parts`` ranges, so that ``BLOCKS_PER_SM`` blocks an SM
    fill ``sms`` SMs once (no range shorter than ``MIN_PART_ROWS``)."""
    rows_per_image, segments_per_image = _images(
        rows, segments, rows_per_image, segments_per_image)
    if min(rows, channels, segments, segments_per_image) <= 0:
        raise ValueError(
            f"K2 plan of {rows} rows x {channels} channels into {segments} "
            f"segments ({segments_per_image} an image): every size must be "
            "positive")
    full = 16 // elem_size
    vec = full if aligned and channels % full == 0 else 1
    window = min(segments_per_image, segments)
    tiles = -(-channels // MAX_TILE)
    tile = _round_up(-(-channels // tiles), vec)
    # channels of a table row that fit (a row: the tile, maybe one float
    # of pitch, and its count)
    fit = (SMEM_BUDGET // window // 4 - 2) // vec * vec
    if tile > fit:
        narrowest = min(_round_up(min(channels, MIN_TILE), vec), tile)
        if fit >= narrowest:
            tiles = -(-channels // fit)
            tile = _round_up(-(-channels // tiles), vec)
        else:
            tile = narrowest
            window = SMEM_BUDGET // ((tile + 2) * 4)
    lanes = 1 << max(0, (-(-tile // LANE_FLOATS) - 1).bit_length())
    images = rows // rows_per_image
    want = -(-BLOCKS_PER_SM * sms // (images * (-(-channels // tile))))
    parts = max(1, min(want, -(-rows_per_image // MIN_PART_ROWS)))
    return PoolPlan(rows, channels, segments, rows_per_image,
                    segments_per_image, vec, tile, window, lanes, parts)


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def segment_pool_sums_plain(feats: torch.Tensor, ids: torch.Tensor,
                            num_segments: int, *,
                            rows_per_image: int | None = None,
                            segments_per_image: int | None = None):
    """K2's plain PyTorch version: ``(sums [S, D], counts [S])`` in f32 of
    the rows ``feats [N, D]`` keyed by ``ids [N]``; ids outside ``[0, S)``
    add nothing. Differentiable with respect to ``feats``. It takes
    :func:`segment_pool_sums`'s keywords, which change nothing of the
    function, so the two are interchangeable."""
    acc = _acc_dtype(feats.dtype)
    ids = ids.long()
    ok = (ids >= 0) & (ids < num_segments)
    safe = torch.where(ok, ids, torch.zeros_like(ids))
    rows = torch.where(ok[:, None], feats.to(acc),
                       torch.zeros((), dtype=acc, device=feats.device))
    sums = torch.zeros((num_segments, feats.shape[1]), dtype=acc,
                       device=feats.device).index_add(0, safe, rows)
    counts = torch.zeros((num_segments,), dtype=acc,
                         device=feats.device).index_add(0, safe, ok.to(acc))
    return sums, counts


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


class _Plan(ctypes.Structure):
    """``csrc/segment_pool.cu``'s ``Plan``: a :class:`PoolPlan` as the
    kernel reads it, every field of the same name."""

    _fields_ = [
        *[(f, ctypes.c_longlong) for f in ("rows", "rows_per_image",
                                           "chunk")],
        *[(f, ctypes.c_int) for f in (
            "channels", "segments", "segments_per_image", "window", "tile",
            "pitch", "vec", "lanes", "parts", "smem_bytes", "is_bf16")],
    ]


@functools.lru_cache(maxsize=64)  # a step's few shapes
def _launcher(n, d, num_segments, rows_per_image, segments_per_image,
              is_bf16, aligned, index):
    """``(entry, plan, its address)`` for K2 on ``[n, d]`` rows of one
    shape on card ``index``: made once a shape, so that a call's host work
    is two allocations, this lookup and one ctypes call of six pointers
    (the entry zeroes the outputs and launches)."""
    from openess_tpu_torch.ops import _build

    plan = pool_plan(n, d, num_segments, elem_size=2 if is_bf16 else 4,
                     aligned=aligned, rows_per_image=rows_per_image,
                     segments_per_image=segments_per_image, sms=_sms(index))
    c = _Plan(**{f: getattr(plan, f) for f, _ in _Plan._fields_[:-1]},
              is_bf16=int(is_bf16))
    fn = _build.entry("segment_pool.cu", "segment_pool_sums",
                      *[ctypes.c_void_p] * 5)
    return fn, c, ctypes.addressof(c)


def _launch(feats: torch.Tensor, ids: torch.Tensor, num_segments: int,
            rows_per_image: int | None, segments_per_image: int | None):
    from openess_tpu_torch.ops import _build

    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 takes bf16 or f32 features, got {feats.dtype}")
    if ids.dtype != torch.int32 or ids.device != feats.device:
        raise ValueError("K2 ids must be int32 on the features' device")
    if feats.ndim != 2 or ids.shape != feats.shape[:1]:
        raise ValueError(
            f"K2 takes feats [N, D] and ids [N], got {tuple(feats.shape)} "
            f"and {tuple(ids.shape)}"
        )
    if not (feats.is_contiguous() and ids.is_contiguous()):
        raise ValueError("K2 inputs must be contiguous ([N, D] pixel rows)")
    n, d = feats.shape
    dev = feats.device
    if n == 0:
        return (torch.zeros((num_segments, d), device=dev),
                torch.zeros((num_segments,), device=dev))
    # zeroed by the entry, on the stream, before the kernel
    sums = torch.empty((num_segments, d), dtype=torch.float32, device=dev)
    counts = torch.empty((num_segments,), dtype=torch.float32, device=dev)
    fn, _, plan = _launcher(n, d, num_segments, rows_per_image,
                            segments_per_image,
                            feats.dtype == torch.bfloat16,
                            feats.data_ptr() % 16 == 0, dev.index)
    _build.launch(fn, dev, feats.data_ptr(), ids.data_ptr(), sums.data_ptr(),
                  counts.data_ptr(), plan)
    segment_pool_sums.launches += 1
    return sums, counts


class _SegmentPoolSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, ids, layout):
        # layout: (num_segments, rows_per_image, segments_per_image)
        ctx.save_for_backward(ids)
        ctx.num_segments = layout[0]
        ctx.feats_dtype = feats.dtype
        sums, counts = _launch(feats, ids, *layout)
        ctx.mark_non_differentiable(counts)
        return sums, counts

    @staticmethod
    def backward(ctx, g_sums, _g_counts):
        (ids,) = ctx.saved_tensors
        s = ctx.num_segments
        # cast the small [S, D] cotangent before the full-resolution gather;
        # row S is the zero row that skipped pixels read
        g = torch.cat([g_sums.to(ctx.feats_dtype),
                       g_sums.new_zeros((1, g_sums.shape[1]),
                                        dtype=ctx.feats_dtype)])
        ids = ids.long()
        safe = torch.where((ids >= 0) & (ids < s), ids,
                           torch.full_like(ids, s))
        return g.index_select(0, safe), None, None


def segment_pool_sums(feats: torch.Tensor, ids: torch.Tensor,
                      num_segments: int, *, rows_per_image: int | None = None,
                      segments_per_image: int | None = None):
    """``(sums [S, D] f32, counts [S] f32)`` of ``feats [N, D]`` by
    ``ids [N]`` int32 (K2).

    ``rows_per_image`` and ``segments_per_image`` (given together) say that
    the rows are images of that many rows whose ids mostly lie in
    ``[b * segments_per_image, (b + 1) * segments_per_image)`` for image
    ``b``, as :func:`global_segment_ids` makes them; the result is the same
    function of the inputs either way (an id elsewhere still counts), the
    kernel only sums each image's window in shared memory. Without them the
    rows are one image of ``S`` segments.

    CUDA tensors launch the K2 kernel and count the launch in
    ``segment_pool_sums.launches``; CPU tensors run
    :func:`segment_pool_sums_plain`. Differentiable with respect to
    ``feats``; the counts carry no gradient.
    """
    _images(feats.shape[0], num_segments, rows_per_image, segments_per_image)
    kind = feats.device.type
    if kind == "cpu":
        return segment_pool_sums_plain(feats, ids, num_segments)
    if kind != "cuda":
        raise ValueError(f"unsupported device for K2: {feats.device}")
    if feats.requires_grad and torch.is_grad_enabled():
        return _SegmentPoolSums.apply(
            feats, ids, (num_segments, rows_per_image, segments_per_image))
    # no graph to record (the teacher's features, evaluation): the launch
    # alone, without the autograd Function's host work
    return _launch(feats, ids, num_segments, rows_per_image,
                   segments_per_image)


segment_pool_sums.launches = 0


def global_segment_ids(seg_ids: torch.Tensor, segments_per_image: int):
    """``[B, H, W]`` per-image ids -> flat int32 global ids ``[B*H*W]``
    (``+ b * segments_per_image``). Ids outside the global range are
    folded onto ``-1`` / ``B * S`` (both skipped) before the int32 cast."""
    b = seg_ids.shape[0]
    total = b * segments_per_image
    offs = torch.arange(b, device=seg_ids.device) * segments_per_image
    ids = seg_ids.long() + offs.view(b, *([1] * (seg_ids.ndim - 1)))
    return ids.clamp(-1, total).reshape(-1).to(torch.int32), total


def segment_mean_pool(feats: torch.Tensor, seg_ids: torch.Tensor, *,
                      segments_per_image: int, eps: float = 1e-6,
                      group=None):
    """Per-superpixel mean features ``(means [B*S, D], counts [B*S])`` in
    the feats dtype. ``feats`` must be a contiguous NHWC tensor: the kernel
    reads it as ``[B*H*W, D]`` rows. ``group``: ``feats`` and ``seg_ids``
    are this rank's band of rows of each image (spatial partitioning), and
    the f32 sums and counts are summed over the group before the means are
    taken (``parallel.all_sum``: the means feed replicated compute)."""
    b, h, w, d = feats.shape
    if tuple(seg_ids.shape) != (b, h, w):
        raise ValueError(
            f"seg_ids {tuple(seg_ids.shape)} must be {(b, h, w)} for feats "
            f"{tuple(feats.shape)}"
        )
    if not feats.is_contiguous():
        raise ValueError(
            "segment_mean_pool takes a contiguous NHWC tensor; call "
            ".contiguous() on the NHWC view where the copy is meant"
        )
    ids, total = global_segment_ids(seg_ids, segments_per_image)
    sums, counts = segment_pool_sums(
        feats.view(b * h * w, d), ids, total, rows_per_image=h * w,
        segments_per_image=segments_per_image)
    if group is not None:
        both = all_sum(torch.cat([sums, counts[:, None]], dim=1), group)
        sums, counts = both[:, :d], both[:, d]
    means = sums / (counts[:, None] + eps)
    return means.to(feats.dtype), counts.to(feats.dtype)
