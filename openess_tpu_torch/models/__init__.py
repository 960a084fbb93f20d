"""PyTorch models: E2VID, the SemSegE2VID head, the frame teacher and the
DeepLabV3 student."""
from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
from openess_tpu_torch.models.e2vid import (
    E2VIDReconstructor,
    E2VIDStreamingStep,
    initial_stream_state,
)
from openess_tpu_torch.models.image_teacher import DilationFeatureExtractor
from openess_tpu_torch.models.resnet import ResNet50
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID

__all__ = [
    "DeepLabV3TextSeg",
    "DilationFeatureExtractor",
    "E2VIDReconstructor",
    "E2VIDStreamingStep",
    "ResNet50",
    "SemSegE2VID",
    "initial_stream_state",
]
