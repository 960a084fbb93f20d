"""Section timers and device traces, the counterpart of
``openess_tpu/utils/profiling.py`` (the reference's ``e2vid/utils/
timers.py``, plus the device trace it lacks).

- :class:`Timer`     accumulating section timer on the host clock;
  :func:`timer_summary` gives calls, total and mean per section,
  :func:`reset_timers` clears them (one table per process, as in JAX).
- :func:`trace`      ``torch.profiler`` over CPU and CUDA activities,
  written as a trace TensorBoard loads
  (``torch.profiler.tensorboard_trace_handler``; no ``tensorboard``
  package needed to write it). ``record_function`` spans, such as the
  train step's ``train/<part>``, are kept in it.
- :class:`StepTimer` rolling steps per second; each tick waits for the
  device it was given (``torch.cuda.synchronize``), so a step's time is
  its device work and not its enqueue.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, List

import torch

_timers: Dict[str, List[float]] = defaultdict(list)


class Timer:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _timers[self.name].append(time.perf_counter() - self.t0)
        return False


def timer_summary() -> Dict[str, dict]:
    out = {}
    for name, vals in _timers.items():
        out[name] = {
            "calls": len(vals),
            "total_s": sum(vals),
            "mean_ms": 1e3 * sum(vals) / len(vals),
        }
    return out


def reset_timers():
    _timers.clear()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block: host ops and, when a GPU is present, its kernels,
    memsets and copies. On exit the trace is written under ``log_dir`` as
    ``<host>_<pid>.<time>.pt.trace.json`` (Chrome trace format; TensorBoard's
    PyTorch profiler plugin and ``chrome://tracing`` read it)."""
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    def __init__(self, window: int = 50, device=None):
        self.window = window
        self.device = None if device is None else torch.device(device)
        self._times: List[float] = []
        self._last = None

    def tick(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now
        return self.steps_per_sec()

    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)
