"""Device ops. Each kernel wrapper launches its hand-written Hopper kernel
on CUDA tensors and runs its plain PyTorch version on CPU tensors."""
from openess_tpu_torch.ops.lstm_gates import fused_lstm_gates
from openess_tpu_torch.ops.resize import upsample2x_nearest
from openess_tpu_torch.ops.voxelize import normalize_nonzero
from openess_tpu_torch.ops.voxelize_chunked import voxelize_chunked_trilinear

__all__ = [
    "fused_lstm_gates",
    "normalize_nonzero",
    "upsample2x_nearest",
    "voxelize_chunked_trilinear",
]
