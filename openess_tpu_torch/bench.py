"""The port's headline benchmark, the counterpart of ``bench.py``. Prints
one JSON line:

    {"metric": "voxelize_throughput", "value": N, "unit": "events/s",
     "vs_baseline": N, "extra": {...}}

    python -m openess_tpu_torch.bench [--device cuda|cpu] [--seed N]

It runs the flagship configuration (``configs/pretrain/DSEC/
frame2voxel_fcclip_slic.yaml``: 480x640 sensor cropped to 440x640, 5 bins,
T = 20 windows of 100 000 events, B = 8, bf16, with K3's gates) on
synthetic data made from ``--seed``, with random weights.

- ``value``: the better of two device voxelization rates, K5 on 20 windows
  of 100 000 raw events (the JAX bench's ``bench_voxelize`` input) and K1
  on the C++-packed wire of 160 such windows (one training batch);
  ``vs_baseline`` is that rate over the numpy ``np.add.at`` voxelizer's
  (``numpy_baseline_voxelize``) timed on this host.
- ``extra``: the C++ host voxelizer's rate; the pretrain step
  (``pretrain_step_ms_b8``, p50 by CUDA events on a resident batch), with
  the teacher at output stride 8, and the eval step; the step's FLOPs
  (``utils/flops.count_flops``: its convolutions and matrix products) and
  MFU against the card's dense bf16 peak; served windows through
  ``serve_stream.StreamServer`` at S = 1, 4 and 8 streams and the most
  streams served inside the 50 ms (20 Hz) budget; the host's pack and grid
  per batch, the pinned upload, and the step fed through
  ``data/pipeline.PrefetchLoader``; the card's name and power limit.

Each phase that fails ends the run. The default ``--device cuda`` raises
without a GPU; ``--device cpu`` runs the plain versions on the host clock
and writes no device metric (``mfu_pct``, ``power_limit_w`` are null).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch

from openess_tpu_torch import resolve_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "configs/pretrain/DSEC/frame2voxel_fcclip_slic.yaml"
BUDGET_MS = 50.0  # the 20 Hz DSEC label period


@dataclasses.dataclass(frozen=True)
class Sizes:
    """What the bench runs; the defaults are the flagship's full width."""
    vox_windows: int = 20        # K5's input (bench.py bench_voxelize)
    events: int = 100_000        # per window; K1 packs one batch of them
    baseline_events: int = 200_000
    streams: tuple = (1, 4, 8)
    served_windows: int = 8      # per S, the first untimed
    steps: int = 6               # timed train steps
    pipeline_steps: int = 4
    reps: int = 3


def numpy_baseline_voxelize(x, y, p, t, C, H, W):
    """The reference-style ``np.add.at`` trilinear voxelizer (bench.py)."""
    tn = (C - 1) * (t - t[0]) / max(t[-1] - t[0], 1e-9)
    x0 = np.fix(x).astype(np.int64)
    y0 = np.fix(y).astype(np.int64)
    t0 = np.fix(tn).astype(np.int64)
    val = 2 * p - 1
    grid = np.zeros(C * H * W, np.float32)
    for xl in (x0, x0 + 1):
        for yl in (y0, y0 + 1):
            for tl in (t0, t0 + 1):
                m = ((xl < W) & (xl >= 0) & (yl < H) & (yl >= 0) & (tl >= 0)
                     & (tl < C))
                w = (val * (1 - np.abs(xl - x)) * (1 - np.abs(yl - y))
                     * (1 - np.abs(tl - tn)))
                np.add.at(grid, ((tl * H + yl) * W + xl)[m], w[m])
    return grid


def call_ms(fn, device, reps: int) -> float:
    """Milliseconds per call of ``fn`` over ``reps`` calls back to back
    after one warm-up: CUDA events on a CUDA device, the host clock
    otherwise."""
    fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def host_ms(fn, reps: int) -> float:
    """Best host-clock milliseconds of ``reps`` calls after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return min(times) * 1e3


def step_ms(fn, device, n: int) -> np.ndarray:
    """Milliseconds of each of ``n`` calls: CUDA events around each call,
    or the host clock."""
    if device.type == "cuda":
        events = []
        for _ in range(n):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            events.append((a, b))
        torch.cuda.synchronize(device)
        return np.array([a.elapsed_time(b) for a, b in events])
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return np.array(out)


def raw_events(rng, n_win: int, k: int, height: int, width: int):
    """Uniform events over the sensor, sorted f64 µs times in 50 ms."""
    x = rng.uniform(0, width - 1, (n_win, k)).astype(np.float32)
    y = rng.uniform(0, height - 1, (n_win, k)).astype(np.float32)
    p = rng.integers(0, 2, (n_win, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 5e4, (n_win, k)), axis=1)
    return x, y, p, t, np.ones((n_win, k), bool)


def bench_voxelize(rng, device, sensor, raw, bins: int, sz: Sizes) -> dict:
    """Events per second of the numpy baseline and the C++ host voxelizer
    (one thread, window by window) on bench.py's ``bench_voxelize`` input
    (``vox_windows`` windows, times sorted over all of them), of K5 on that
    input, and of K1 on the C++-packed wire of ``raw`` (one batch)."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.native import (
        chunk_events_windows_host,
        voxelize_trilinear_host,
    )
    from openess_tpu_torch.ops.voxelize_chunked import (
        voxelize_chunked_trilinear,
    )
    from openess_tpu_torch.ops.voxelize_mxu import (
        voxelize_windows_trilinear_mxu,
    )

    H, W = sensor
    C, nw, k = bins, sz.vox_windows, sz.events
    n = nw * k
    x = rng.uniform(0, W - 1, n).astype(np.float32)
    y = rng.uniform(0, H - 1, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)
    valid = np.ones(n, bool)
    nb = min(sz.baseline_events, n)
    t0 = time.perf_counter()
    numpy_baseline_voxelize(x[:nb], y[:nb], p[:nb], t[:nb], C, H, W)
    np_rate = nb / (time.perf_counter() - t0)

    native_ms = host_ms(lambda: [
        voxelize_trilinear_host(x[w * k:(w + 1) * k], y[w * k:(w + 1) * k],
                                p[w * k:(w + 1) * k], t[w * k:(w + 1) * k],
                                C, H, W)
        for w in range(nw)], sz.reps)

    args = [torch.from_numpy(a).to(device) for a in (x, y, p, t, valid)]
    k5_ms = call_ms(lambda: voxelize_windows_trilinear_mxu(
        *args, num_windows=nw, num_bins=C, height=H, width=W),
        device, sz.reps)

    wire = chunk_events_windows_host(*raw, height=H, width=W, n_threads=0,
                                     t16=True)
    d = upload_wire(dict(zip(WIRE_KEYS, wire)), device)
    k1_ms = call_ms(lambda: voxelize_chunked_trilinear(
        *(d[key] for key in WIRE_KEYS), num_bins=C, height=H, width=W),
        device, sz.reps)
    n_wire = raw[0].size
    return {
        "numpy_baseline_events_per_s": np_rate,
        "native_host_events_per_s": n / (native_ms / 1e3),
        "k5_events_per_s": n / (k5_ms / 1e3),
        "k1_events_per_s": n_wire / (k1_ms / 1e3),
        "k5_ms": k5_ms,
        "k1_ms": k1_ms,
        "k1_windows": raw[0].shape[0],
    }


def host_batch(rng, s, sensor, raw) -> dict:
    """The step's side channels (random frames, labels, superpixels, as
    bench.py makes them) and the C++-packed wire of ``raw``'s windows."""
    from openess_tpu_torch.data.device_voxelize import pack_wire_batch
    from openess_tpu_torch.native import chunk_events_windows_host

    H, W = (int(v) for v in s.img_size_b)
    B, T = s.batch_size_b, s.nr_events_data_b
    batch = {
        "frame": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "recon": rng.uniform(0, 1, (B, H, W, 3)).astype(np.float32),
        "label": rng.integers(0, s.semseg_num_classes, (B, H, W)).astype(
            np.int32),
        "pl": rng.integers(0, s.semseg_num_classes, (B, H, W)).astype(
            np.int32),
        "superpixel": rng.integers(0, s.superpixel_size, (B, H, W)).astype(
            np.int32),
        "sam_feat": rng.normal(0, 1, (B, 16, 16, 256)).astype(np.float32),
    }
    wire = chunk_events_windows_host(*raw, height=sensor[0], width=sensor[1],
                                     n_threads=0, t16=s.wire_t16)
    batch.update(pack_wire_batch(wire, B, T))
    return batch


def bench_host(s, sensor, raw, sz: Sizes) -> dict:
    """The host's event work per batch: the C++ packer (the raw-event
    wire's assembly) and the C++ grid voxelizer (the grid wire's), on
    ``min(8, cores)`` threads."""
    from openess_tpu_torch.native import (
        chunk_events_windows_host,
        voxelize_trilinear_windows_host,
    )

    x, y, p, t, valid = raw
    H, W = sensor
    nthr = min(8, os.cpu_count() or 1)
    crop = H - int(s.img_size_b[0])
    counts = np.full(x.shape[0], x.shape[1], np.int64)
    t32 = t.astype(np.float32)
    pack_ms = host_ms(lambda: chunk_events_windows_host(
        x, y, p, t, valid, height=H, width=W, n_threads=nthr,
        reuse_buffers=True, t16=s.wire_t16), sz.reps)
    grid_ms = host_ms(lambda: voxelize_trilinear_windows_host(
        x, y, p, t32, counts, s.nr_temporal_bins_b, H, W, crop_bottom=crop,
        norm_mode=0, n_threads=nthr, layout="chw"), sz.reps)
    return {"host_chunk_pack_ms_b8": pack_ms,
            "host_grid_voxelize_ms_b8": grid_ms,
            "host_assembly_ms_b8": pack_ms, "host_threads": nthr,
            "wire_format": s.wire_format, "wire_t16": bool(s.wire_t16)}


def build_step(s, device):
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder

    mset = build_models(s, seed=0, device=device)
    sb = StepBuilder(s, mset, make_optimizer(s, mset), 100)
    sb.generator.manual_seed(0)
    return sb


def bench_train(s, device, hb: dict, sz: Sizes) -> dict:
    """The pretrain step on a resident batch: its per-step time, FLOPs and
    MFU, the eval step, and the step with the teacher at output stride 8;
    then the pinned upload of the batch."""
    from openess_tpu_torch.training.trainer import to_device
    from openess_tpu_torch.utils.flops import count_flops, mfu_pct

    B = s.batch_size_b
    batch = to_device(hb, device)
    sb = build_step(s, device)
    sb.train_step(batch, 0)  # warm-up: cuDNN's algorithm choice
    flops, _ = count_flops(sb.train_step, batch, 0)
    ms = step_ms(lambda: sb.train_step(batch, 0), device, sz.steps)
    step = float(np.percentile(ms, 50))
    eval_ms = call_ms(lambda: sb.eval_step(batch), device, sz.reps)
    del sb
    sb8 = build_step(dataclasses.replace(s, teacher_os=8), device)
    sb8.train_step(batch, 0)
    os8 = float(np.percentile(
        step_ms(lambda: sb8.train_step(batch, 0), device, sz.steps), 50))
    del sb8, batch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    cuda = device.type == "cuda"

    def put():
        out = to_device(hb, device)
        if cuda:
            torch.cuda.synchronize(device)
        return out

    return {
        "pretrain_step_ms_b8": step,
        "pretrain_step_ms_b8_p95": float(np.percentile(ms, 95)),
        "device_samples_per_s": B / (step / 1e3),
        "pretrain_step_ms_b8_teacher_os8": os8,
        "eval_fwd_ms_b8": eval_ms,
        "eval_samples_per_s": B / (eval_ms / 1e3),
        "train_flops_per_step": float(flops),
        "mfu_pct": (mfu_pct(flops, step, torch.cuda.get_device_name(device))
                    if cuda else None),
        "h2d_put_ms_b8": host_ms(put, 2),
    }


def bench_streaming(s, device, sensor, sz: Sizes) -> dict:
    """Served windows through ``StreamServer`` at each S (the server's
    synthetic windows, seed 0): p50 and p95 per window (host clock, first
    packed event to the step enqueued, windows double-buffered as ``serve``
    runs them), the device step's median, and the most streams whose p50
    fits the 50 ms budget."""
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        serve,
        synthetic_windows,
    )

    out, served = {}, []
    for S in sz.streams:
        server = StreamServer(s, streams=S, device=device)
        r = serve(server, synthetic_windows(sz.served_windows, sz.events,
                                            *sensor))
        p50 = float(np.percentile(r.latency_ms, 50))
        suffix = "" if S == 1 else f"_s{S}"
        out["streaming_window_ms" + suffix] = p50
        out["streaming_window_p95_ms" + suffix] = float(
            np.percentile(r.latency_ms, 95))
        out[f"streaming_device_ms_s{S}"] = float(np.median(r.device_ms))
        if S == 1:
            out["streaming_host_pack_ms"] = float(np.median(r.pack_ms))
            out["streaming_windows_per_s"] = 1e3 / p50
        if p50 <= BUDGET_MS:
            served.append(S)
        del server, r
    out["streaming_streams_at_20hz"] = max(served, default=0)
    return out


class _PackingDataset:
    """Batches made as a raw-wire loader makes them: the side channels of
    one batch and the wire packed anew from the raw windows each call."""

    def __init__(self, s, sensor, side: dict, raw, n_batches: int, device):
        from openess_tpu_torch.data.device_voxelize import wire_reuse_ok

        self.s, self.sensor, self.side, self.raw = s, sensor, side, raw
        self.n = n_batches * s.batch_size_b
        self.reuse = wire_reuse_ok(device)

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        from openess_tpu_torch.data.device_voxelize import pack_wire_batch
        from openess_tpu_torch.native import chunk_events_windows_host

        wire = chunk_events_windows_host(
            *self.raw, height=self.sensor[0], width=self.sensor[1],
            n_threads=1, reuse_buffers=self.reuse, t16=self.s.wire_t16)
        return dict(self.side, **pack_wire_batch(
            wire, self.s.batch_size_b, self.s.nr_events_data_b))


def bench_pipeline(s, device, sensor, hb: dict, raw, sz: Sizes) -> float:
    """Milliseconds per step with the batches packed (one thread) and
    uploaded by one ``PrefetchLoader`` worker while the step before runs:
    wall time over ``pipeline_steps`` steps, from the first batch's
    arrival."""
    from openess_tpu_torch.data.pipeline import PrefetchLoader
    from openess_tpu_torch.training.trainer import to_device

    side = {k: v for k, v in hb.items() if not k.startswith("ev_")}
    n = sz.pipeline_steps
    data = _PackingDataset(s, sensor, side, raw, n, device)
    sb = build_step(s, device)
    loader = PrefetchLoader(data, s.batch_size_b, shuffle=False,
                            put_fn=lambda b: to_device(b, device),
                            device=device, num_workers=1)
    t0 = None
    for batch in loader:
        if t0 is None:
            t0 = time.perf_counter()
        sb.train_step(batch, 0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) * 1e3 / n


def card(device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU."""
    if device.type != "cuda":
        return {"device_kind": "cpu", "power_limit_w": None}
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader,nounits", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    name, limit = (v.strip() for v in out.strip().split(","))
    return {"device_kind": name, "power_limit_w": float(limit)}


def flagship_settings(**overrides):
    """The flagship YAML's settings with K3's gates, and ``overrides``."""
    from openess_tpu_torch.config.settings import load_settings

    s = load_settings(os.path.join(ROOT, FLAGSHIP))
    return dataclasses.replace(s, e2vid_fused_gates=True, **overrides)


def run(s, device, sz: Sizes, seed: int = 0) -> dict:
    """Every phase; returns the JSON object the bench prints."""
    from openess_tpu_torch.serve_stream import sensor_shape

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    sensor = sensor_shape(s)
    raw = raw_events(rng, s.batch_size_b * s.nr_events_data_b, sz.events,
                     *sensor)
    # the host first, before the card's work shares its cores
    extra = bench_host(s, sensor, raw, sz)
    vox = bench_voxelize(rng, device, sensor, raw, s.nr_temporal_bins_b, sz)
    extra.update(vox)
    hb = host_batch(rng, s, sensor, raw)
    extra.update(bench_train(s, device, hb, sz))
    extra.update(bench_streaming(s, device, sensor, sz))
    extra["pipeline_step_ms_b8_measured"] = bench_pipeline(
        s, device, sensor, hb, raw, sz)
    extra.update(card(device))
    value = max(vox["k5_events_per_s"], vox["k1_events_per_s"])
    return {"metric": "voxelize_throughput", "value": value,
            "unit": "events/s",
            "vs_baseline": value / vox["numpy_baseline_events_per_s"],
            "extra": extra}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    print(json.dumps(run(flagship_settings(), device, Sizes(),
                         seed=args.seed)))


if __name__ == "__main__":
    main()
