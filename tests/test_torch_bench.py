"""``python -m openess_tpu_torch.bench`` on the CPU at tiny sizes
(32x48 synthetic events, T = 2, B = 2, f32, 500 events a window, S = 1
and 2 streams): one JSON line in ``bench.py``'s form with every key, no
device metric from a CPU run (the weight draws skipped), and no run at
all without a GPU when the card is asked for (the default). The numpy baseline is ``bench.py``'s,
bit for bit."""
import json

import numpy as np
import pytest
import torch

from openess_tpu_torch import bench
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

KEYS = {
    "numpy_baseline_events_per_s", "native_host_events_per_s",
    "k5_events_per_s", "k1_events_per_s", "k5_ms", "k1_ms", "k1_windows",
    "pretrain_step_ms_b8", "pretrain_step_ms_b8_p95",
    "device_samples_per_s", "pretrain_step_ms_b8_teacher_os8",
    "eval_fwd_ms_b8", "eval_samples_per_s", "train_flops_per_step",
    "mfu_pct", "h2d_put_ms_b8", "streaming_window_ms",
    "streaming_window_p95_ms", "streaming_device_ms_s1",
    "streaming_host_pack_ms", "streaming_windows_per_s",
    "streaming_window_ms_s2", "streaming_window_p95_ms_s2",
    "streaming_device_ms_s2", "streaming_streams_at_20hz",
    "host_chunk_pack_ms_b8", "host_grid_voxelize_ms_b8",
    "host_assembly_ms_b8", "host_threads", "wire_format", "wire_t16",
    "pipeline_step_ms_b8_measured", "device_kind", "power_limit_w",
}


def test_bench_prints_one_line_with_the_keys(capsys, monkeypatch):
    s = bench.flagship_settings(
        dataset_name_b="synthetic_events", img_size_b=(32, 48),
        nr_events_data_b=2, batch_size_b=2, compute_dtype="float32",
        superpixel_size=4)
    sz = bench.Sizes(vox_windows=2, events=500, baseline_events=500,
                     streams=(1, 2), served_windows=3, steps=2,
                     pipeline_steps=2, reps=1)
    monkeypatch.setattr(bench, "flagship_settings", lambda: s)
    monkeypatch.setattr(bench, "Sizes", lambda: sz)
    # the keys are under test, not the weights: skip the seeded draws
    from openess_tpu_torch.training import build

    monkeypatch.setattr(build, "init_weights", lambda module, gen: None)
    bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "voxelize_throughput"
    assert out["unit"] == "events/s"
    extra = out["extra"]
    assert set(extra) == KEYS
    assert out["value"] == max(extra["k5_events_per_s"],
                               extra["k1_events_per_s"]) > 0
    assert out["vs_baseline"] == pytest.approx(
        out["value"] / extra["numpy_baseline_events_per_s"])
    assert extra["k1_windows"] == 4
    assert extra["train_flops_per_step"] > 0
    assert extra["device_kind"] == "cpu"
    assert extra["mfu_pct"] is None and extra["power_limit_w"] is None
    assert 0 <= extra["streaming_streams_at_20hz"] <= 2


def test_bench_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_numpy_baseline_is_bench_py_s():
    import bench as jbench

    rng = np.random.default_rng(0)
    n = 3000
    x = rng.uniform(0, 47, n).astype(np.float32)
    y = rng.uniform(0, 31, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)
    np.testing.assert_array_equal(
        bench.numpy_baseline_voxelize(x, y, p, t, 5, 32, 48),
        jbench.numpy_baseline_voxelize(x, y, p, t, 5, 32, 48))
