"""Host utilities."""
from openess_tpu_torch.utils.profiling import (
    StepTimer,
    Timer,
    timer_summary,
    trace,
)
from openess_tpu_torch.utils.viz import colorize_semseg, event_image, save_png

__all__ = [
    "StepTimer",
    "Timer",
    "colorize_semseg",
    "event_image",
    "save_png",
    "timer_summary",
    "trace",
]
