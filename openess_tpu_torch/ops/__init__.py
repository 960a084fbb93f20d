"""Device ops. Each kernel wrapper launches its hand-written Hopper kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors."""
from openess_tpu_torch.ops.confusion import confusion_matrix
from openess_tpu_torch.ops.lstm_gates import fused_lstm_gates
from openess_tpu_torch.ops.resize import resize_bilinear, upsample2x_nearest
from openess_tpu_torch.ops.segment_pool import segment_mean_pool
from openess_tpu_torch.ops.voxelize import (
    event_histogram,
    normalize_nonzero,
    voxel_grid_bilinear_t,
    voxel_grid_trilinear,
    voxelize_windows_trilinear,
)
from openess_tpu_torch.ops.voxelize_chunked import (
    voxelize_chunked_bilinear_t,
    voxelize_chunked_trilinear,
)
from openess_tpu_torch.ops.voxelize_mxu import (
    voxelize_windows_bilinear_t_mxu,
    voxelize_windows_trilinear_mxu,
)

__all__ = [
    "confusion_matrix",
    "event_histogram",
    "fused_lstm_gates",
    "normalize_nonzero",
    "resize_bilinear",
    "segment_mean_pool",
    "upsample2x_nearest",
    "voxel_grid_bilinear_t",
    "voxel_grid_trilinear",
    "voxelize_chunked_bilinear_t",
    "voxelize_chunked_trilinear",
    "voxelize_windows_bilinear_t_mxu",
    "voxelize_windows_trilinear",
    "voxelize_windows_trilinear_mxu",
]
