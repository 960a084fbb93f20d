"""The port's ``utils/profiling.py``, ``utils/flops.py`` and the train
entry's ``--profile`` on the CPU.

- Timers and ``StepTimer`` mirror ``tests/test_utils.py``'s JAX tests.
- ``trace`` writes a Chrome trace that holds the ``record_function`` spans.
- ``conv_flops`` and ``e2vid_window_flops`` equal the JAX package's
  exactly (integers) over a grid of shapes.
- ``count_flops`` (``FlopCounterMode``) over one latent-only E2VID window
  equals ``e2vid_window_flops(decode=False)`` exactly (measured: equal),
  and over a backward adds the two gradient convolutions of each conv.
- ``python -m openess_tpu_torch.train --profile DIR`` on the synthetic
  config run as ``frame2voxel`` (32x48, T = 2, one epoch of two steps of
  16 samples, with a log directory) writes the trace and the five visual
  dumps.
"""
import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import record_function

from openess_tpu.utils import flops as jflops
from openess_tpu_torch.models.e2vid import E2VIDReconstructor
from openess_tpu_torch.utils import flops
from openess_tpu_torch.utils.profiling import (
    StepTimer,
    Timer,
    reset_timers,
    timer_summary,
    trace,
)
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_profiling_timers():
    reset_timers()
    for _ in range(3):
        with Timer("unit_sec"):
            time.sleep(0.01)
    summ = timer_summary()
    assert summ["unit_sec"]["calls"] == 3
    assert 0.02 <= summ["unit_sec"]["total_s"] < 5.0
    assert summ["unit_sec"]["mean_ms"] == pytest.approx(
        1e3 * summ["unit_sec"]["total_s"] / 3)
    reset_timers()
    assert "unit_sec" not in timer_summary()

    st = StepTimer(window=4, device="cpu")
    assert st.steps_per_sec() == 0.0
    for _ in range(6):
        time.sleep(0.005)
        st.tick()
    assert len(st._times) == 4  # the window
    assert 0 < st.steps_per_sec() < 200


def test_trace_writes_a_trace_with_the_spans(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path)):
        with record_function("train/unit_span"):
            (x @ x).sum()
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1, os.listdir(tmp_path)
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train/unit_span" in names
    assert any(n and "mm" in n for n in names)


@pytest.mark.parametrize("px,k,cin,cout", [
    (1, 1, 1, 1), (7, 3, 5, 32), (8 * 440 * 640, 5, 5, 32),
    (123, 5, 128, 64)])
def test_conv_flops_equal_jax(px, k, cin, cout):
    assert flops.conv_flops(px, k, cin, cout) == jflops.conv_flops(
        px, k, cin, cout)


@pytest.mark.parametrize("decode", [True, False])
@pytest.mark.parametrize("b,h,w,bins,base", [
    (1, 16, 24, 5, 32), (8, 440, 640, 5, 32), (8, 200, 352, 5, 32),
    (2, 64, 96, 10, 16), (3, 30, 42, 2, 8)])
def test_e2vid_window_flops_equal_jax(b, h, w, bins, base, decode):
    kw = dict(num_bins=bins, base=base, decode=decode)
    assert flops.e2vid_window_flops(b, h, w, **kw) == \
        jflops.e2vid_window_flops(b, h, w, **kw)


@pytest.mark.parametrize("b,h,w", [(1, 16, 24), (2, 32, 48)])
def test_flop_counter_counts_one_latent_only_window(b, h, w):
    torch.manual_seed(0)
    m = E2VIDReconstructor(planar_input=True, latent_only=True)
    win = torch.randn(b, 1, 5, h, w)
    with torch.no_grad():
        got, out = flops.count_flops(m, win)
    assert out[1]["8"].shape == (b, h // 8, w // 8, 256)
    assert got == flops.e2vid_window_flops(b, h, w, decode=False)


def test_flop_counter_counts_the_backward():
    """A forward and backward of one conv: the forward, the input gradient
    and the weight gradient, each ``conv_flops``."""
    conv = torch.nn.Conv2d(4, 8, 3, padding=1)
    x = torch.randn(2, 4, 10, 12, requires_grad=True)
    got, _ = flops.count_flops(lambda: conv(x).sum().backward())
    assert got == 3 * flops.conv_flops(2 * 10 * 12, 3, 4, 8)


def test_peak_and_mfu():
    peak = flops.peak_bf16_flops("NVIDIA H100 80GB HBM3")
    assert peak == 989.4e12
    assert flops.mfu_pct(peak * 0.25, 250.0, "NVIDIA H100 80GB HBM3") == \
        pytest.approx(100.0)
    with pytest.raises(KeyError, match="no bf16 peak"):
        flops.peak_bf16_flops("Some Other Card")


def test_train_entry_profiles_and_dumps(tmp_path):
    """``--profile`` writes a trace holding the step's spans; with a log
    directory the validation epoch writes JAX's five PNGs."""
    with open(os.path.join(ROOT, "configs/synthetic_sup_only.yaml")) as f:
        text = f.read()
    for a, b in (("config_option: 'frame2recon'", "config_option: 'frame2voxel'"),
                 ("num_epochs: 2", "num_epochs: 1"),
                 ("shape: [64, 96]", "shape: [32, 48]"),
                 ("nr_events_data: 4", "nr_events_data: 2"),
                 ("nr_events_window: 2000", "nr_events_window: 300"),
                 ("batch_size_b: 4", "batch_size_b: 16"),
                 ("log: 'log/synthetic_sup_only'", f"log: '{tmp_path}/log'")):
        assert a in text, a
        text = text.replace(a, b)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-m", "openess_tpu_torch.train", "--settings_file",
         str(cfg), "--device", "cpu", "--profile", str(tmp_path / "prof")],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    files = glob.glob(str(tmp_path / "prof" / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"train/voxelize", "train/e2vid", "train/head",
            "train/optimizer"} <= names
    vis = glob.glob(str(tmp_path / "log" / "*" / "visualization" / "*.png"))
    assert sorted(os.path.basename(p) for p in vis) == sorted(
        f"{n}_e000.png" for n in ("confusion", "confusion_norm",
                                  "semseg_pred_gt", "event_preview",
                                  "pca_latent"))
    for p in vis:
        from PIL import Image

        with Image.open(p) as im:
            assert np.asarray(im).ndim == 3
