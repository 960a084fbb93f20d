"""The port's streaming segmentation server, as a whole, against the JAX
serving step of ``tools/serve_stream.py`` (both on the CPU, f32, the
synthetic dataset as a frame2voxel config, 2 streams, 3 windows with
carried state), and its command line.

Tolerances, measured on this comparison: the full slice differs from JAX
by at most 1.2e-2 of the logit max (0.85e-2 to 1.15e-2 over the three
windows), driven by the TPU voxelizer's bf16 multiplicands (the port's K1
is an exact f32 splat); the test allows 3e-2 and asks argmax agreement on
at least 99 % of pixels (measured 99.37 % to 99.66 %). Fed JAX's own voxel
windows, the port's model part agrees to 1.4e-5 absolute; the test allows
1e-4.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_REL_TOL = 3e-2
AGREE_MIN = 0.99
MODEL_TOL = 1e-4


def _frame2voxel_yaml(tmp_path):
    with open(os.path.join(ROOT, "configs/synthetic_sup_only.yaml")) as f:
        text = f.read()
    text = text.replace("config_option: 'frame2recon'",
                        "config_option: 'frame2voxel'")
    path = tmp_path / "synthetic_frame2voxel.yaml"
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def slice_run(tmp_path_factory):
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu.data.device_voxelize import voxelize_wire as jvox
    from openess_tpu.models.e2vid import E2VIDStreamingStep as JStep
    from openess_tpu.models.e2vid import initial_stream_state as jinit
    from openess_tpu.training.build import build_models as jbuild
    from openess_tpu.training.steps import StepBuilder
    from openess_tpu_torch.config.settings import load_settings as tload
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.models.convert import (
        e2vid_state_dict_from_jax,
        semseg_state_dict_from_jax,
    )
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows

    cfg = _frame2voxel_yaml(tmp_path_factory.mktemp("cfg"))
    S = 2
    js, ts = jload(cfg), tload(cfg)
    js.batch_size_b = S
    mset = jbuild(js, seed=0)
    sb = StepBuilder(js, mset)
    stream = JStep(num_bins=js.input_channels_b, normalize=True,
                   dtype=jnp.float32, latent_only=True)
    params = mset.params

    @jax.jit  # tools/serve_stream.py's serving step
    def jstep(carry, batch):
        window = jvox(js, batch)[:, 0]
        st, latent, _ = stream.apply(
            {"params": params["front_sensor_b"]}, carry, window
        )
        (logits, _), _ = sb._apply(
            "back_end", params, mset.batch_stats, latent,
            mset.text_embeddings, train=False,
        )
        return tuple(st), jnp.argmax(logits, axis=-1).astype(jnp.uint8), \
            logits, window

    server = StreamServer(ts, streams=S, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    server.models.e2vid.load_state_dict(
        e2vid_state_dict_from_jax(tree["front_sensor_b"]), strict=True
    )
    server.models.head.load_state_dict(
        semseg_state_dict_from_jax(tree["back_end"],
                                   np.asarray(mset.text_embeddings)),
        strict=True,
    )
    h, w = (int(v) for v in ts.img_size_b)
    jc = tuple(jinit(S, h, w))
    tc, tc_model = server.initial_state(), server.initial_state()
    out = []
    for x, y, p, t in synthetic_windows(3, 2000, server.sensor_h,
                                        server.sensor_w):
        batch = server.pack(x, y, p, t)
        jc, jlab, jlog, jwin = jstep(jc, batch)
        tc, tlab, tlog = server.step(tc, upload_wire(batch, "cpu"))
        with torch.inference_mode():
            tc_model, lat, _ = server.models.e2vid(
                tc_model, torch.from_numpy(np.array(jwin))
            )
            tlog_model, _ = server.models.head(lat)
        out.append(dict(
            jlab=np.asarray(jlab), jlog=np.asarray(jlog),
            tlab=tlab.numpy(), tlog=tlog.numpy(), tlog_model=tlog_model.numpy(),
        ))
    return dict(windows=out, jcarry=jc, tcarry=tc, S=S, hw=(h, w))


def test_serving_slice_matches_jax_step(slice_run):
    S, (h, w) = slice_run["S"], slice_run["hw"]
    for r in slice_run["windows"]:
        assert r["tlab"].dtype == np.uint8 and r["tlab"].shape == (S, h, w)
        assert r["tlog"].shape == r["jlog"].shape == (S, h, w, 6)
        scale = np.abs(r["jlog"]).max()
        assert np.abs(r["tlog"] - r["jlog"]).max() <= SLICE_REL_TOL * scale
        assert (r["tlab"] == r["jlab"]).mean() >= AGREE_MIN
    for (jh, jc), (th, tc) in zip(slice_run["jcarry"], slice_run["tcarry"]):
        assert th.shape == jh.shape and tc.shape == jc.shape


def test_serving_model_part_on_jax_windows(slice_run):
    for r in slice_run["windows"]:
        np.testing.assert_allclose(r["tlog_model"], r["jlog"], atol=MODEL_TOL)


def _cli(args, tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run(
        [sys.executable, "-m", "openess_tpu_torch.serve_stream",
         "--settings_file", _frame2voxel_yaml(tmp_path), "--synthetic", "3",
         "--window_events", "2000", *args],
        capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=300,
    )


def test_cli_serves_on_cpu_when_asked(tmp_path):
    out_dir = tmp_path / "preds"
    r = _cli(["--device", "cpu", "--out_dir", str(out_dir)], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "served 3 windows x 1 stream(s)" in r.stdout
    assert "per-stream rate" in r.stdout
    assert sorted(os.listdir(out_dir)) == [
        f"pred_{i:06d}.png" for i in range(3)
    ]


def test_cli_raises_without_gpu_unless_cpu_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    r = _cli([], tmp_path)
    assert r.returncode != 0
    assert "no CUDA device is available" in r.stderr
    assert "served" not in r.stdout


def test_bf16_server_tracks_f32(tmp_path):
    """The bf16 path (bf16 grid, bf16 model, f32 norm statistics) on the CPU
    against the f32 server with the same weights: measured 5.3e-2 to 6.8e-2
    of the logit max and 95.2 % to 95.9 % label agreement over 3 windows;
    the test allows 0.15 and 90 %."""
    import dataclasses

    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows

    s32 = load_settings(_frame2voxel_yaml(tmp_path))
    s16 = dataclasses.replace(s32, compute_dtype="bfloat16")
    f32, b16 = StreamServer(s32, 1, "cpu"), StreamServer(s16, 1, "cpu")
    c32, c16 = f32.initial_state(), b16.initial_state()
    for x, y, p, t in synthetic_windows(3, 2000, 64, 96):
        batch = f32.pack(x, y, p, t)
        c32, lab32, log32 = f32.step(c32, upload_wire(batch, "cpu"))
        c16, lab16, log16 = b16.step(c16, upload_wire(batch, "cpu"))
        assert log16.dtype == torch.bfloat16
        assert all(h.dtype == c.dtype == torch.bfloat16 for h, c in c16)
        assert torch.isfinite(log16).all()
        err = (log16.float() - log32).abs().max() / log32.abs().max()
        assert err <= 0.15
        assert (lab16 == lab32).float().mean() >= 0.90


def test_cli_serves_an_event_file(tmp_path):
    """``--events``: a ``t x y pol`` text stream with a header line, cut
    into fixed-count windows (the trailing partial window is served too)."""
    rng = np.random.default_rng(7)
    n = 4500
    t = np.sort(rng.uniform(0, 0.15, n))
    rows = np.stack([t, rng.integers(0, 96, n), rng.integers(0, 64, n),
                     rng.integers(0, 2, n)], axis=1)
    path = tmp_path / "events.txt"
    np.savetxt(path, rows, fmt=["%.6f", "%d", "%d", "%d"], header="96 64",
               comments="")
    r = _cli(["--device", "cpu", "--events", str(path)], tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "served 3 windows x 1 stream(s)" in r.stdout


def test_event_windows_and_viz_match_jax(tmp_path):
    from openess_tpu.data.event_file_readers import (
        fixed_size_event_windows as jwin,
    )
    from openess_tpu.utils.viz import colorize_semseg as jcolor
    from openess_tpu_torch.config.classes import COLOR_MAPS
    from openess_tpu_torch.data.event_file_readers import (
        fixed_size_event_windows as twin,
    )
    from openess_tpu_torch.utils.viz import colorize_semseg as tcolor

    rng = np.random.default_rng(8)
    rows = np.stack([np.sort(rng.uniform(0, 1, 250)),
                     rng.integers(0, 96, 250), rng.integers(0, 64, 250),
                     rng.integers(0, 2, 250)], axis=1)
    path = tmp_path / "ev.txt"
    np.savetxt(path, rows, fmt=["%.6f", "%d", "%d", "%d"], header="h",
               comments="")
    got, ref = list(twin(str(path), 100)), list(jwin(str(path), 100))
    assert [g.shape for g in got] == [(100, 4), (100, 4), (50, 4)]
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    labels = rng.integers(0, 11, (16, 24)).astype(np.uint8)
    labels[0, :5] = 255
    np.testing.assert_array_equal(tcolor(labels, COLOR_MAPS[11]),
                                  jcolor(labels, COLOR_MAPS[11]))


def test_server_refuses_frame2recon(tmp_path):
    """The server runs the event path only: ``frame2recon`` settings, and a
    checkpoint of a ``frame2recon`` run (DeepLabV3 students, no E2VID and
    no head), are refused with a plain message."""
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.serve_stream import StreamServer
    from openess_tpu_torch.training import checkpoint as ckpt
    from openess_tpu_torch.training.build import build_models

    recon = load_settings(
        os.path.join(ROOT, "configs/synthetic_sup_only.yaml"),
        generate_log=False)
    assert recon.config_option == "frame2recon"
    with pytest.raises(ValueError, match="no event path"):
        StreamServer(recon, device="cpu")
    mset = build_models(recon, device="cpu")
    ckpt.save_checkpoint(str(tmp_path), mset, None, 0, 0)
    voxel = load_settings(_frame2voxel_yaml(tmp_path), generate_log=False)
    with pytest.raises(ValueError, match="a frame2recon checkpoint cannot"):
        StreamServer(voxel, device="cpu", checkpoint=str(tmp_path))


def test_out_dir_pngs_are_written_outside_the_timed_latency(tmp_path,
                                                           monkeypatch):
    """``--out_dir``: each window's PNG is byte for byte what the server
    wrote before the write left the timed region (the first stream's
    labels of that window, stepped in order from a zero state, through
    ``colorize_semseg`` and ``save_png``), and no PNG write falls inside a
    window's latency: on a clock that moves only while a PNG is written,
    every latency reads 0."""
    import types

    from openess_tpu_torch import serve_stream
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        serve,
        synthetic_windows,
    )
    from openess_tpu_torch.utils import viz

    s = load_settings(_frame2voxel_yaml(tmp_path), generate_log=False)
    wins = list(synthetic_windows(3, 2000, 64, 96))
    server = StreamServer(s, 2, "cpu")
    carry, want = server.initial_state(), []
    for i, win in enumerate(wins):
        carry, labels, _ = server.step(carry,
                                       upload_wire(server.pack(*win), "cpu"))
        path = tmp_path / f"want_{i}.png"
        viz.save_png(str(path), viz.colorize_semseg(
            labels[0].numpy(), s.semseg_color_map, s.semseg_ignore_label))
        want.append(path.read_bytes())

    clock = [0.0]
    save_png = viz.save_png

    def clocked_save_png(path, rgb):
        clock[0] += 1.0
        save_png(path, rgb)

    monkeypatch.setattr(viz, "save_png", clocked_save_png)
    monkeypatch.setattr(serve_stream, "time",
                        types.SimpleNamespace(perf_counter=lambda: clock[0]))
    out = tmp_path / "served"
    r = serve(server, wins, out_dir=str(out))
    assert sorted(os.listdir(out)) == [f"pred_{i:06d}.png" for i in range(3)]
    for i in range(3):
        assert (out / f"pred_{i:06d}.png").read_bytes() == want[i], i
    assert clock[0] == 3.0
    assert r.latency_ms.tolist() == [0.0, 0.0], r.latency_ms
