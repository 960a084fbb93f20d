"""Streaming segmentation server: events in, labels out.

The PyTorch/CUDA form of ``tools/serve_stream.py``: carried ConvLSTM state
and one event window of compute per frame.

  host:   pack the window's raw events onto the sorted-chunk wire (the
          port's C++ packer, ``native.chunk_events_windows_host``)
  device: voxelize (K1; K4, resize and crop for DDD17) -> E2VID step (K3
          when tpu.e2vid_fused_gates) -> SemSegE2VID head -> argmax ->
          uint8 labels

It reports the achieved serving rate against a target label rate
(DSEC-Semantic labels arrive at ~20 Hz per camera). Input is a
``.txt``/``.zip`` event stream (``t x y pol`` rows, one header line) cut
into fixed-count windows, or ``--synthetic N`` random windows. ``--streams
S`` serves S copies of the stream batched into one step call.

Usage:
  python -m openess_tpu_torch.serve_stream --settings_file configs/<cfg>.yaml \\
      [--events events.zip | --synthetic 40] [--window_events 100000] \\
      [--streams S] [--rate_hz 20] [--out_dir preds/] [--device cuda|cpu] \\
      [--checkpoint <file or dir> | --artifact model.pt2]

Weights are random from a fixed seed unless ``--checkpoint`` names a
checkpoint of the port's trainer (``training/checkpoint.py``), whose
``front_sensor_b`` and ``back_end`` are then loaded. The server runs the
event path only: settings on ``frame2recon``, and a checkpoint of a
``frame2recon`` run (which holds DeepLabV3 students and no event path),
are refused. ``--artifact`` serves an ``export_model --streaming``
artifact in place of the live models, with the same packer, voxelizer and
timing; it was exported on ``--device`` with a batch of ``--streams``, and
it takes no ``--checkpoint``.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from openess_tpu_torch import resolve_device
from openess_tpu_torch.data.device_voxelize import (
    DSEC_HEIGHT,
    DSEC_WIDTH,
    pack_wire_batch,
    upload_wire,
    voxelize_wire,
)
from openess_tpu_torch.export_model import (
    StreamingStep,
    input_specs,
    load_artifact,
    read_meta,
)
from openess_tpu_torch.models.e2vid import initial_stream_state
from openess_tpu_torch.native import chunk_events_windows_host
from openess_tpu_torch.ops.voxelize_chunked import pad_wire_chunks
from openess_tpu_torch.training.build import build_models, serving_models


def synthetic_windows(n: int, window_events: int, sensor_h: int, sensor_w: int):
    """``n`` random ``(x, y, p, t)`` windows (seed 0), as the JAX tool
    draws them."""
    rng = np.random.default_rng(0)
    k = window_events
    for i in range(n):
        yield (
            rng.uniform(0, sensor_w - 1, k),
            rng.uniform(0, sensor_h - 1, k),
            rng.integers(0, 2, k).astype(np.float64),
            np.sort(rng.uniform(50e3 * i, 50e3 * (i + 1), k)),
        )


def file_windows(path: str, window_events: int):
    """``(x, y, p, t)`` windows of ``window_events`` events from a file."""
    from openess_tpu_torch.data.event_file_readers import (
        fixed_size_event_windows,
    )

    for win in fixed_size_event_windows(path, window_events):
        t, x, y, p = (win[:, i] for i in range(4))
        yield x, y, p, t


def sensor_shape(s, sensor_size: str = "") -> tuple[int, int]:
    """(H, W) the events are packed at: the sensor before any crop."""
    if sensor_size:
        sh, sw = (int(v) for v in sensor_size.split(","))
        return sh, sw
    if s.dataset_name_b == "DSEC_events":
        return DSEC_HEIGHT, DSEC_WIDTH
    if s.dataset_name_b == "DDD17_events":
        from openess_tpu_torch.data.ddd17 import HEIGHT, WIDTH

        return HEIGHT, WIDTH
    return tuple(int(v) for v in s.img_size_b)


class StreamServer:
    """The serving step for ``streams`` concurrent streams batched into one
    call: the live models (``export_model.StreamingStep`` over
    ``serving_models``), or a streaming artifact of ``export_model``
    (``artifact``), which carries its own weights and takes the grid the
    server voxelizes (K1, K4) in eager mode."""

    def __init__(self, s, streams: int = 1, device=None, seed: int = 0,
                 sensor_size: str = "", checkpoint: str = "",
                 artifact: str = ""):
        self.s = s
        self.streams = streams
        self.models = None
        if artifact:
            if checkpoint:
                raise ValueError("--artifact carries its weights: it takes no "
                                 "--checkpoint")
            self.device = resolve_device(device)
            self.step_fn, self.dtype = _artifact_step(artifact, streams,
                                                      self.device)
        else:
            self.models = _live_models(s, seed, device, checkpoint)
            self.device, self.dtype = self.models.device, self.models.dtype
            self.step_fn = StreamingStep(self.models)
        self.height, self.width = (int(v) for v in s.img_size_b)
        self.sensor_h, self.sensor_w = sensor_shape(s, sensor_size)
        # DDD17 events have integer pixels: packed exact, no corner spill
        self.integer_coords = (not sensor_size
                               and s.dataset_name_b == "DDD17_events")
        self.pinned_nbc = 0

    def initial_state(self):
        return initial_stream_state(
            self.streams, self.height, self.width, dtype=self.dtype,
            device=self.device,
        )

    def pack(self, x, y, p, t) -> dict:
        """One window's events, copied to every stream, on the host wire:
        the C++ packer on one thread, the chunk axis trimmed to the bucketed
        count, then zero-padded up to its high-water mark over the windows
        served so far, so the wire's shape changes only when a window needs
        more chunks than any before it."""
        S = self.streams
        xs = np.broadcast_to(x.astype(np.float32), (S, x.size))
        ys = np.broadcast_to(y.astype(np.float32), (S, y.size))
        ps = np.broadcast_to(p.astype(np.float32), (S, p.size))
        ts = np.broadcast_to(t.astype(np.float64), (S, t.size))
        va = np.ones((S, x.size), bool)
        wire = chunk_events_windows_host(
            xs, ys, ps, ts, va, height=self.sensor_h, width=self.sensor_w,
            n_threads=1, integer_coords=self.integer_coords,
            t16=self.s.wire_t16,
        )
        self.pinned_nbc = max(self.pinned_nbc, wire[0].shape[1])
        wire = pad_wire_chunks(wire, self.pinned_nbc)
        return pack_wire_batch(wire, S, 1)

    @torch.inference_mode()
    def step(self, carry, batch):
        """(carry, device wire) -> (carry, uint8 labels [S, H, W],
        logits [S, H, W, num_classes]). The grid goes to the step in f32,
        the artifacts' input type (the step casts it back to the compute
        dtype: exact)."""
        window = voxelize_wire(self.s, batch)[:, 0]  # [S, bins, H, W]
        carry, pred, logits = self.step_fn(carry, window.float())
        return carry, pred.to(torch.uint8), logits


def _live_models(s, seed, device, checkpoint):
    mset = build_models(s, seed=seed, device=device, event_path_only=True)
    if checkpoint:
        from openess_tpu_torch.training.checkpoint import (
            load_model_only,
            read_model_state,
        )

        held = read_model_state(checkpoint)
        if not {"front_sensor_b", "back_end"} <= set(held):
            raise ValueError(
                f"checkpoint {checkpoint!r} holds {sorted(held)} and no "
                "event path (front_sensor_b, back_end): a frame2recon "
                "checkpoint cannot be served")
        load_model_only(checkpoint, mset)
    return serving_models(mset)


def _artifact_step(path, streams, device):
    """The callable of a streaming artifact and its carry's dtype; refuses
    a batch artifact, one exported on another device, and a window batch
    other than ``streams`` (the carried state pins it)."""
    kind = read_meta(path)["kind"]
    if kind != "streaming":
        raise ValueError(f"{path!r} is a {kind} artifact: serving needs "
                         "export_model --streaming")
    ep, _ = load_artifact(path, device)
    specs = input_specs(ep)
    batch = specs[-1][0][0]
    if batch != streams:
        raise ValueError(f"artifact batch {batch} != --streams {streams}")
    return ep.module(), specs[0][1]


@dataclasses.dataclass
class ServeResult:
    windows: int
    streams: int
    latency_ms: np.ndarray   # per window after the first: host, end to end
    pack_ms: np.ndarray
    upload_ms: np.ndarray
    dispatch_ms: np.ndarray  # previous window's fetch + this window's step
    device_ms: np.ndarray    # step time: CUDA events, or the host clock on CPU
    carry: tuple
    labels: np.ndarray       # last window's labels [S, H, W] uint8
    logits: torch.Tensor     # last window's logits, on the device


def serve(server: StreamServer, windows, *, max_windows: int = 0,
          out_dir: str = "") -> ServeResult:
    """Serve ``windows`` (an iterable of ``(x, y, p, t)``) through
    ``server``, double-buffered: window n-1's labels are fetched after
    window n is packed and uploaded, so the host packs while the device
    computes. The first window (kernel builds, autotuning) is not timed."""
    s = server.s
    cuda = server.device.type == "cuda"
    carry = server.initial_state()
    lat, phases, dev_events, dev_host = [], [], [], []
    pending = None  # (labels on device, done event, index)

    def fetch(pend):
        """Wait for a window's labels: with ``out_dir`` copy the first
        stream's to the host, as ``(index, labels)`` for :func:`write`."""
        labels, done, idx = pend
        if out_dir:
            return idx, labels[0].cpu().numpy()
        if done is not None:
            done.synchronize()
        return None

    def write(fetched):
        """The PNG of a fetched window, written outside the timed region."""
        if fetched is None:
            return
        from openess_tpu_torch.utils.viz import colorize_semseg, save_png

        idx, labels = fetched
        os.makedirs(out_dir, exist_ok=True)
        rgb = colorize_semseg(labels, s.semseg_color_map,
                              s.semseg_ignore_label)
        save_png(os.path.join(out_dir, f"pred_{idx:06d}.png"), rgb)

    n = 0
    logits = None
    for x, y, p, t in windows:
        t0 = time.perf_counter()
        batch = server.pack(x, y, p, t)
        t1 = time.perf_counter()
        dev = upload_wire(batch, server.device)
        t2 = time.perf_counter()
        fetched = None if pending is None else fetch(pending)
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            done = torch.cuda.Event(enable_timing=True)
            start.record()
        ts = time.perf_counter()
        carry, labels, logits = server.step(carry, dev)
        if cuda:
            done.record()
        else:
            done = None
        t3 = time.perf_counter()
        write(fetched)
        pending = (labels, done, n)
        if n > 0:
            lat.append((t3 - t0) * 1e3)
            phases.append(((t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (t3 - t2) * 1e3))
            if cuda:
                dev_events.append((start, done))
            else:
                dev_host.append((t3 - ts) * 1e3)
        n += 1
        if max_windows and n >= max_windows:
            break
    if pending is not None:  # drain the last in-flight window
        write(fetch(pending))
    if not lat:
        raise SystemExit("need >= 2 windows to measure the serving rate")
    if cuda:
        torch.cuda.synchronize(server.device)
        device_ms = [a.elapsed_time(b) for a, b in dev_events]
    else:
        device_ms = dev_host
    ph = np.array(phases)
    return ServeResult(
        windows=n, streams=server.streams, latency_ms=np.array(lat),
        pack_ms=ph[:, 0], upload_ms=ph[:, 1], dispatch_ms=ph[:, 2],
        device_ms=np.array(device_ms), carry=carry,
        labels=pending[0].cpu().numpy(),
        logits=logits,
    )


def report(r: ServeResult, rate_hz: float, device: torch.device) -> list[str]:
    """The tool's two summary lines."""
    p50, p95 = np.percentile(r.latency_ms, 50), np.percentile(r.latency_ms, 95)
    budget_ms = 1e3 / rate_hz
    rate = 1e3 / p50
    cuda = device.type == "cuda"
    where = torch.cuda.get_device_name(device) if cuda else "cpu"
    return [
        f"served {r.windows} windows x {r.streams} stream(s): "
        f"p50 {p50:.1f} ms  p95 {p95:.1f} ms per window "
        f"(pack {np.median(r.pack_ms):.1f} + wire-upload "
        f"{np.median(r.upload_ms):.1f} + prev-fetch+dispatch "
        f"{np.median(r.dispatch_ms):.1f}; {'device' if cuda else 'host'} "
        f"step {np.median(r.device_ms):.2f})",
        f"per-stream rate {rate:.1f} windows/s "
        f"({r.streams * rate:.1f}/{where} aggregate); target {rate_hz:.0f} Hz "
        f"({budget_ms:.0f} ms budget) -> real-time margin "
        f"{budget_ms / p50:.2f}x {'OK' if p50 <= budget_ms else 'UNDER-RATE'}",
    ]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--settings_file", required=True)
    ap.add_argument("--events", default="",
                    help=".txt/.zip event stream (t x y pol, header line)")
    ap.add_argument("--synthetic", type=int, default=20,
                    help="serve N synthetic windows when no --events")
    ap.add_argument("--window_events", type=int, default=100_000)
    ap.add_argument("--streams", type=int, default=1,
                    help="concurrent stream copies batched per step call")
    ap.add_argument("--rate_hz", type=float, default=20.0,
                    help="target per-stream label rate (DSEC ~20 Hz)")
    ap.add_argument("--sensor_size", default="",
                    help="H,W of the event sensor before crop (default: "
                         "DSEC 480,640, else img_size)")
    ap.add_argument("--out_dir", default="",
                    help="write per-window colorized prediction PNGs here")
    ap.add_argument("--max_windows", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--checkpoint", default="",
                    help="trainer checkpoint (file, or a directory of "
                         "ckpt_*.pt) to load the models from")
    ap.add_argument("--artifact", default="",
                    help="serve an export_model --streaming .pt2 artifact "
                         "instead of the live models (exported on --device, "
                         "its batch equal to --streams)")
    args = ap.parse_args(argv)

    from openess_tpu_torch.config.settings import load_settings

    s = load_settings(args.settings_file)
    server = StreamServer(s, streams=args.streams, device=args.device,
                          sensor_size=args.sensor_size,
                          checkpoint=args.checkpoint, artifact=args.artifact)
    if args.events:
        windows = file_windows(args.events, args.window_events)
    else:
        windows = synthetic_windows(args.synthetic, args.window_events,
                                    server.sensor_h, server.sensor_w)
    r = serve(server, windows, max_windows=args.max_windows,
              out_dir=args.out_dir)
    for line in report(r, args.rate_hz, server.device):
        print(line)


if __name__ == "__main__":
    main()
