"""Device ops. Each kernel wrapper launches its hand-written Hopper kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors."""
from openess_tpu_torch.ops.confusion import confusion_matrix
from openess_tpu_torch.ops.lstm_gates import fused_lstm_gates
from openess_tpu_torch.ops.resize import resize_bilinear, upsample2x_nearest
from openess_tpu_torch.ops.segment_pool import segment_mean_pool
from openess_tpu_torch.ops.voxelize import normalize_nonzero
from openess_tpu_torch.ops.voxelize_chunked import (
    voxelize_chunked_bilinear_t,
    voxelize_chunked_trilinear,
)

__all__ = [
    "confusion_matrix",
    "fused_lstm_gates",
    "normalize_nonzero",
    "resize_bilinear",
    "segment_mean_pool",
    "upsample2x_nearest",
    "voxelize_chunked_bilinear_t",
    "voxelize_chunked_trilinear",
]
