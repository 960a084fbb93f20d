"""Raw-event wire -> voxel windows on the device.

Wire batch keys (the JAX package's ``data/device_voxelize.py`` contract):
  ev_x, ev_y   int16 [B, T, NBC, E]   fixed-point coords (x32)
  ev_p         uint8 [B, T, NBC, E]
  ev_t         u16|f32 [B, T, NBC, E] time rel. to the window's first event
                                      (u16 = wire v2, quantized against
                                      ev_trange; f32 = exact v1)
  ev_counts    int32 [B, T, NBC]      valid events per chunk
  ev_r0        int32 [B, T, NBC]      packed chunk descriptor:
                                      row-tile offset | (col-tile offset << 16)
  ev_trange    f32   [B, T]           window time range
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.ops.voxelize_chunked import (
    voxelize_chunked_bilinear_t,
    voxelize_chunked_trilinear,
)

WIRE_KEYS = (
    "ev_x", "ev_y", "ev_p", "ev_t", "ev_counts", "ev_r0", "ev_trange",
)
DSEC_HEIGHT, DSEC_WIDTH = 480, 640  # DSEC event sensor, before the crop
DSEC_CROP_BOTTOM = 40               # rows cut from the bottom (440 kept)


def wire_reuse_ok(device) -> bool:
    """Whether the packer may hand out its recycled wire buffers
    (``native.chunk_events_windows_host(reuse_buffers=True)``): only when
    the batch is copied before the buffers come round again. On a CUDA
    device :func:`upload_wire` and the trainer's upload copy it through
    pinned memory; on the CPU ``torch.from_numpy`` aliases it, so reuse
    stays off."""
    return torch.device(device).type == "cuda"


def pack_wire_batch(wire, batch_size: int, num_windows: int) -> dict:
    """Chunker output tuple -> the ev_* batch keys (numpy in, numpy out)."""
    xq, yq, pq, tr, counts, r0s, trange = wire
    nbc, e = xq.shape[1], xq.shape[2]
    b, t = batch_size, num_windows
    return {
        "ev_x": xq.reshape(b, t, nbc, e),
        "ev_y": yq.reshape(b, t, nbc, e),
        "ev_p": pq.reshape(b, t, nbc, e),
        "ev_t": tr.reshape(b, t, nbc, e),
        "ev_counts": counts.reshape(b, t, nbc),
        "ev_r0": r0s.reshape(b, t, nbc),
        "ev_trange": trange.reshape(b, t),
    }


def upload_wire(batch: dict, device) -> dict:
    """Host wire batch (numpy) -> tensors on ``device``. To a CUDA device
    the copy goes through pinned memory and does not block the host: it
    queues on the current stream behind the work already there."""
    device = torch.device(device)
    out = {}
    for k in WIRE_KEYS:
        t = torch.from_numpy(np.ascontiguousarray(batch[k]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[k] = t.to(device)
    return out


def voxelize_wire(s: Settings, batch: dict) -> torch.Tensor:
    """Chunked wire -> planar ``[B, T, C, H_out, W_out]`` voxel windows in
    the compute dtype, with the dataset's post-ops: DSEC is voxelized (K1)
    at the 480x640 sensor size and its bottom 40 rows cropped; DDD17 is
    voxelized (K4) at the 260x346 sensor size, resized to 352 columns
    (bilinear, ``align_corners=True``) and its bottom 60 rows cropped; the
    synthetic dataset is voxelized (K1) at ``img_size_b`` with no crop."""
    b, t, nbc, e = batch["ev_x"].shape
    args = tuple(
        batch[k].reshape((b * t,) + batch[k].shape[2:])
        for k in ("ev_x", "ev_y", "ev_p", "ev_t", "ev_counts", "ev_r0")
    ) + (batch["ev_trange"].reshape(b * t),)
    bins = s.nr_temporal_bins_b
    if s.dataset_name_b == "DDD17_events":
        from openess_tpu_torch.data.ddd17 import (
            CROP_BOTTOM,
            HEIGHT,
            RESIZE_W,
            WIDTH,
        )

        g = voxelize_chunked_bilinear_t(
            *args, num_bins=bins, height=HEIGHT, width=WIDTH,
            separate_pol=s.separate_pol_b, normalize=s.normalize_event_b,
        )  # [B*T, C, 260, 346]
        # resize, then crop, as the JAX package does; the grid stays planar
        # (ops/resize.resize_bilinear is this call on an NHWC tensor)
        g = F.interpolate(g, size=(HEIGHT, RESIZE_W), mode="bilinear",
                          align_corners=True)
        g = g[:, :, :HEIGHT - CROP_BOTTOM]
    elif s.dataset_name_b == "DSEC_events":
        g = voxelize_chunked_trilinear(
            *args, num_bins=bins, height=DSEC_HEIGHT, width=DSEC_WIDTH,
            normalize=s.normalize_event_b,
        )
        g = g[:, :, :-DSEC_CROP_BOTTOM]
    else:  # synthetic: trilinear at the configured frame size, no crop
        h, w = int(s.img_size_b[0]), int(s.img_size_b[1])
        g = voxelize_chunked_trilinear(
            *args, num_bins=bins, height=h, width=w,
            normalize=s.normalize_event_b,
        )
    if s.compute_dtype == "bfloat16":
        g = g.to(torch.bfloat16)
    return g.reshape((b, t) + g.shape[1:])
