"""PyTorch models of the serving path: E2VID and the SemSegE2VID head."""
from openess_tpu_torch.models.e2vid import (
    E2VIDReconstructor,
    E2VIDStreamingStep,
    initial_stream_state,
)
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID

__all__ = [
    "E2VIDReconstructor",
    "E2VIDStreamingStep",
    "SemSegE2VID",
    "initial_stream_state",
]
