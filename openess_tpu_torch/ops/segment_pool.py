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
``_pool_kernel``) inside a ``torch.autograd.Function`` whose backward is
the gather ``g_sums.to(feats.dtype)[ids]`` (zero rows for skipped pixels;
the JAX backward is the same plain ``take``, cast before the gather). On
CPU tensors it runs :func:`segment_pool_sums_plain`, an ``index_add_`` in
f32.
"""
from __future__ import annotations

import ctypes

import torch

RUN = 64  # consecutive pixel rows per block of the K2 kernel


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def segment_pool_sums_plain(feats: torch.Tensor, ids: torch.Tensor,
                            num_segments: int):
    """K2's plain PyTorch version: ``(sums [S, D], counts [S])`` in f32 of
    the rows ``feats [N, D]`` keyed by ``ids [N]``; ids outside ``[0, S)``
    add nothing. Differentiable with respect to ``feats``."""
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


def _launch(feats: torch.Tensor, ids: torch.Tensor, num_segments: int):
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
    sums = torch.zeros((num_segments, d), dtype=torch.float32, device=dev)
    counts = torch.zeros((num_segments,), dtype=torch.float32, device=dev)
    fn = _build.entry("segment_pool.cu", "segment_pool_sums",
                      *[ctypes.c_void_p] * 4, ctypes.c_longlong,
                      *[ctypes.c_int] * 4)
    _build.launch(fn, dev, feats.data_ptr(), ids.data_ptr(), sums.data_ptr(),
                  counts.data_ptr(), n, d, num_segments, RUN,
                  int(feats.dtype == torch.bfloat16))
    segment_pool_sums.launches += 1
    return sums, counts


class _SegmentPoolSums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, ids, num_segments):
        ctx.save_for_backward(ids)
        ctx.num_segments = num_segments
        ctx.feats_dtype = feats.dtype
        sums, counts = _launch(feats, ids, num_segments)
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
                      num_segments: int):
    """``(sums [S, D] f32, counts [S] f32)`` of ``feats [N, D]`` by
    ``ids [N]`` int32 (K2).

    CUDA tensors launch the K2 kernel and count the launch in
    ``segment_pool_sums.launches``; CPU tensors run
    :func:`segment_pool_sums_plain`. Differentiable with respect to
    ``feats``; the counts carry no gradient.
    """
    if feats.device.type == "cpu":
        return segment_pool_sums_plain(feats, ids, num_segments)
    if feats.device.type != "cuda":
        raise ValueError(f"unsupported device for K2: {feats.device}")
    return _SegmentPoolSums.apply(feats, ids, num_segments)


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
                      segments_per_image: int, eps: float = 1e-6):
    """Per-superpixel mean features ``(means [B*S, D], counts [B*S])`` in
    the feats dtype. ``feats`` must be a contiguous NHWC tensor: the kernel
    reads it as ``[B*H*W, D]`` rows."""
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
    sums, counts = segment_pool_sums(feats.view(b * h * w, d), ids, total)
    means = sums / (counts[:, None] + eps)
    return means.to(feats.dtype), counts.to(feats.dtype)
