#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``openess_tpu_torch``) on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It builds every kernel of the port's serving path from the sources in the
checkout, holds each against its plain PyTorch version at the shapes the
serving path gives it, times both, then drives the streaming segmentation
server (``openess_tpu_torch.serve_stream``) at the full width of the
flagship configuration (``configs/pretrain/DSEC/frame2voxel_fcclip_slic.yaml``:
480x640 sensor cropped to 440x640, 5 bins, 100k events per window, the
E2VID_lightweight UNet and the SemSegE2VID head, 11 classes, bf16) with
seeded random weights, and checks what comes out. The settings are built
in code from that YAML's values with ``config_option="frame2voxel"``, since
PyYAML may be absent where the card is.

Phases: device, build, K1 vs plain, K3 vs plain, serving (S=1 with the
plain gate path, S=1 with K3, S=8 with K3; the kernels' launch counters
are zeroed before each run and read after it), an f32 reference check of
the CUDA server against the same server on the CPU, and the summary. Any
failure raises and the script exits non-zero. The last line is
``{"ok": true, "device": {...}}``; before it come a ``{"kernels": [...]}``
line and the ``nvidia-smi`` name and power limit.

No JAX and nothing of the JAX package is imported. Needs one CUDA card,
``nvcc`` (CUDA_HOME or /usr/local/cuda) and ``triton``.
"""
import concurrent.futures
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
K1_REL_TOL = 1e-5           # kernel vs plain, of max|plain|: atomics order
K3_ABS_SLACK = 1e-6         # K3: one bf16 ulp plus this near zero
K3_SHAPES = ((220, 320, 64), (110, 160, 128), (55, 80, 256))  # 440x640, B=1
REF_REL_TOL = 1e-3          # f32 server, CUDA vs CPU, of max|logits|


def flagship_settings(**overrides):
    """The flagship YAML's settings, built in code."""
    from openess_tpu_torch.config.settings import Settings

    log_dir = "log/pretrain_frame2voxel_fcclip_slic"
    s = Settings(
        dataset_name_b="DSEC_events", dataset_path_b="data/DSEC",
        img_size_b=(440, 640), nr_events_data_b=20, delta_t_per_data_b=50,
        nr_events_window_b=100000, event_representation_b="voxel_grid",
        nr_temporal_bins_b=5, semseg_num_classes=11, batch_size_b=8,
        task_loss=("dice", "cross_entropy"), log_dir=log_dir,
        ckpt_dir=os.path.join(log_dir, "checkpoints"),
        text_embeddings_path="maskclip_weights/event_ViT16_clip_text_dsec.pth",
        maskclip_checkpoint="maskclip_weights/ViT16_clip_backbone.pth",
        visual_projs_path="maskclip_weights/ViT16_clip_weights.pth",
        output_stride=32, config_option="frame2voxel", if_pretraining=True,
        superpixel_sources="sp_slic_rgb", superpixel_size=100,
        compute_dtype="bfloat16",
    )
    return dataclasses.replace(s, **overrides)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    return out.splitlines()[0]


def cuda_ms(torch, fn, flush, iters=20, warmup=3):
    """Median device milliseconds of ``fn()`` by CUDA events. Before each
    timed call the 256 MB ``flush`` buffer is zeroed: that evicts the 50 MB
    L2, and it keeps the device busy for ~0.1 ms while the host enqueues
    ``fn``'s launches, so the events time the device work and not the
    host's launch latency."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound(bytes_moved, ops, ops_per_s):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase(name):
    print(f"\n== {name}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: needs a CUDA "
              "card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.models.e2vid import initial_stream_state
    from openess_tpu_torch.ops import _build
    from openess_tpu_torch.ops import lstm_gates as k3
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        report,
        serve,
        synthetic_windows,
    )

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    phase("device")
    smi = nvidia_smi()
    print(f"nvidia-smi name, power.limit: {smi}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    print(f"allow_tf32 by default: matmul "
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn "
          f"{torch.backends.cudnn.allow_tf32}; both set to False here, so the "
          f"f32 comparisons run in full f32 (bf16 serving is unaffected)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("build")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nvcc = pool.submit(_build.build, "voxelize_chunked.cu")
        # Triton compiles one kernel per C (16 rows: the row count is
        # specialized on divisibility by 16, as at the real shapes)
        for h, w, c in K3_SHAPES:
            g = torch.zeros((1, 1, 16, 4 * c), dtype=torch.bfloat16,
                            device=dev)
            k3.fused_lstm_gates(g, torch.zeros_like(g[..., :c]))
        torch.cuda.synchronize()
        t_triton = time.perf_counter() - t0
        lib_path = nvcc.result()
    t_nvcc = time.perf_counter() - t0
    k1._kernel()
    print(f"K1 nvcc build+load {t_nvcc:.1f} s -> {lib_path}")
    with open(os.path.splitext(lib_path)[0] + ".log") as f:
        for line in f:
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())
    print(f"K3 triton compile (3 specializations) {t_triton:.1f} s")

    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    kernels = {}

    phase("K1 voxelize_chunked_trilinear vs plain (480x640, 100k ev, NW=8)")
    NW, K, H, W, BINS = 8, 100_000, 480, 640, 5
    wins = list(synthetic_windows(NW, K, H, W))
    xs, ys, ps, ts = (np.stack([w_[i] for w_ in wins]) for i in range(4))
    k1_err, k1_rows = 0.0, {}
    for t16 in (True, False):
        wire = k1.chunk_events_batch(
            xs.astype(np.float32), ys.astype(np.float32),
            ps.astype(np.float32), ts, np.ones((NW, K), bool),
            height=H, width=W, t16=t16,
        )
        d = upload_wire(dict(zip(WIRE_KEYS, wire)), dev)
        args = tuple(d[k] for k in WIRE_KEYS)
        run_k = lambda: k1.voxelize_chunked_trilinear(
            *args, num_bins=BINS, height=H, width=W)
        run_p = lambda: k1.voxelize_chunked_trilinear_plain(
            *args, num_bins=BINS, height=H, width=W)
        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        ok = err <= K1_REL_TOL * scale
        ms_k = cuda_ms(torch, run_k, flush)
        ms_p = cuda_ms(torch, run_p, flush)
        events = int(wire[4].sum())
        tbytes = 2 if t16 else 4
        nbytes = (events * (2 + 2 + 1 + tbytes) + wire[4].nbytes
                  + wire[5].nbytes + wire[6].nbytes + got.numel() * 4)
        b_ms, b_by = bound(nbytes, events * 8 * 6, F32_OPS_PER_S)
        tag = "v2 uint16" if t16 else "v1 f32"
        print(f"K1 [{tag} wire] max|kernel-plain| {err:.3e} "
              f"(max|plain| {scale:.3f}, bound {K1_REL_TOL:.0e} x max) "
              f"{'OK' if ok else 'FAIL'}; kernel_ms {ms_k:.4f} plain_ms "
              f"{ms_p:.4f} bound_ms {b_ms:.4f} ({b_by}; {events} events, "
              f"{nbytes / 1e6:.1f} MB)")
        if not ok:
            raise AssertionError(f"K1 disagrees with its plain version: {err}")
        k1_err = max(k1_err, err)
        k1_rows[t16] = (ms_k, ms_p, b_ms, b_by)
    ms_k, ms_p, b_ms, b_by = k1_rows[True]
    kernels["K1"] = dict(
        name="K1 voxelize_chunked_trilinear", route="cuda",
        source="openess_tpu_torch/csrc/voxelize_chunked.cu",
        replaces="openess_tpu/ops/voxelize_chunked.py:281",
        max_abs_err=k1_err, ms=ms_k, plain_ms=ms_p, bound_ms=b_ms,
        bound_by=b_by, library_ms=None,
        check=f"ok: max|kernel-plain| <= {K1_REL_TOL:g} x max|plain|, "
              "both time wires",
    )

    phase("K3 fused_lstm_gates forward vs plain (bf16, 440x640 ConvLSTMs)")
    gen = torch.Generator(device=dev).manual_seed(1205)
    k3_err, sums = 0.0, np.zeros(4)
    for h, w, c in K3_SHAPES:
        gates = (torch.randn((1, h, w, 4 * c), generator=gen, device=dev)
                 * 2).to(torch.bfloat16)
        pc = torch.randn((1, h, w, c), generator=gen,
                         device=dev).to(torch.bfloat16)
        hk, ck = k3.fused_lstm_gates(gates, pc)
        hp, cp = k3.fused_lstm_gates_plain(gates, pc)
        err, ulps = 0.0, 0.0
        for a, b in ((hk, hp), (ck, cp)):
            diff = (a.float() - b.float()).abs()
            mag = torch.maximum(a.float().abs(), b.float().abs())
            err = max(err, diff.max().item())
            ulps = max(ulps, (diff / (mag * 2.0 ** -7 + K3_ABS_SLACK))
                       .max().item())
        ok = ulps <= 1.0
        run_k = lambda: k3.fused_lstm_gates(gates, pc)
        run_p = lambda: k3.fused_lstm_gates_plain(gates, pc)
        # library yardstick: PyTorch's fused LSTM cell on the same gates
        # (its order is i, f, g, o; zero hidden-side gates, no biases)
        n = h * w
        lg = torch.cat([gates[..., :2 * c], gates[..., 3 * c:],
                        gates[..., 2 * c:3 * c]], -1).reshape(n, 4 * c)
        zeros = torch.zeros_like(lg)
        cx = pc.reshape(n, c)
        run_l = lambda: torch.ops.aten._thnn_fused_lstm_cell(lg, zeros, cx)
        hl, cl, _ = run_l()
        lib_err = max((hl - hp.reshape(n, c)).abs().max().item(),
                      (cl - cp.reshape(n, c)).abs().max().item())
        ms_k = cuda_ms(torch, run_k, flush)
        ms_p = cuda_ms(torch, run_p, flush)
        ms_l = cuda_ms(torch, run_l, flush)
        nbytes = n * 7 * c * 2
        b_ms, _ = bound(nbytes, n * c * 30, F32_OPS_PER_S)
        print(f"K3 [{h}x{w}x{c}] max|kernel-plain| {err:.3e} = {ulps:.3f} "
              f"bf16 ulp (bound 1 ulp + {K3_ABS_SLACK:.0e}) "
              f"{'OK' if ok else 'FAIL'}; kernel_ms {ms_k:.4f} plain_ms "
              f"{ms_p:.4f} library_ms {ms_l:.4f} (_thnn_fused_lstm_cell, "
              f"max|lib-plain| {lib_err:.3e}) bound_ms {b_ms:.4f} "
              f"({nbytes / 1e6:.1f} MB)")
        if not ok:
            raise AssertionError(f"K3 disagrees with its plain version: {ulps}")
        k3_err = max(k3_err, err)
        sums += (ms_k, ms_p, ms_l, b_ms)
    kernels["K3"] = dict(
        name="K3 fused_lstm_gates forward (3 ConvLSTMs per window)",
        route="triton", source="openess_tpu_torch/ops/lstm_gates.py",
        replaces="openess_tpu/ops/lstm_gates.py:75",
        max_abs_err=k3_err, ms=sums[0], plain_ms=sums[1], bound_ms=sums[3],
        bound_by="bytes", library_ms=sums[2],
        check="ok: |kernel-plain| <= 1 bf16 ulp + 1e-6, 3 shapes",
    )
    del flush

    phase("serving: openess_tpu_torch.serve_stream at full width, bf16")
    print("settings: the values of configs/pretrain/DSEC/frame2voxel_fcclip_"
          "slic.yaml, built in code (config_option=frame2voxel); random "
          "weights, seed 0")
    launches = {"K1": 0, "K3": 0}
    for label, fused, S, n in (
        ("S=1, plain gate path", False, 1, 20),
        ("S=1, K3 gates", True, 1, 20),
        ("S=8, K3 gates", True, 8, 5),
    ):
        s = flagship_settings(e2vid_fused_gates=fused)
        server = StreamServer(s, streams=S, device=dev)
        k1.voxelize_chunked_trilinear.launches = 0
        k3.fused_lstm_gates.launches = 0
        r = serve(server, synthetic_windows(n, 100_000, 480, 640))
        torch.cuda.synchronize()
        n1 = k1.voxelize_chunked_trilinear.launches
        n3 = k3.fused_lstm_gates.launches
        launches["K1"] += n1
        launches["K3"] += n3
        print(f"[{label}]")
        for line in report(r, 20.0, dev):
            print("  " + line)
        lat = r.latency_ms
        print(f"  p50 {np.percentile(lat, 50):.2f} ms p95 "
              f"{np.percentile(lat, 95):.2f} ms per window: pack "
              f"{np.median(r.pack_ms):.2f} upload {np.median(r.upload_ms):.2f} "
              f"device {np.median(r.device_ms):.2f} (p95 "
              f"{np.percentile(r.device_ms, 95):.2f}) ms; "
              f"launches K1 {n1} K3 {n3}; on {smi}")
        finite = bool(torch.isfinite(r.logits).all())
        want = initial_stream_state(S, 440, 640, dtype=torch.bfloat16,
                                    device=dev)
        shapes_ok = all(
            a.shape == b.shape and a.dtype == b.dtype
            for pa, pb in zip(r.carry, want) for a, b in zip(pa, pb)
        ) and len(r.carry) == len(want)
        checks = {
            "logits finite": finite,
            "logits shape": tuple(r.logits.shape) == (S, 440, 640, 11),
            "labels uint8 [S,440,640]": r.labels.dtype == np.uint8
            and r.labels.shape == (S, 440, 640),
            "labels in [0, 11)": int(r.labels.max()) < 11,
            "carried state shapes": shapes_ok,
            "K1 once per window": n1 == n,
            "K3 three per window": n3 == (3 * n if fused else 0),
        }
        print("  checks: " + ", ".join(
            f"{k} {'ok' if v else 'FAIL'}" for k, v in checks.items()))
        if not all(checks.values()):
            raise AssertionError(f"serving checks failed: {checks}")
        del server, r

    phase("serving trace: device busy time and idle share (S=1, K3 gates)")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    server = StreamServer(flagship_settings(e2vid_fused_gates=True), 1, dev)
    wins = list(synthetic_windows(7, 100_000, 480, 640))
    serve(server, wins[:2])  # warm-up: cuDNN algorithm choice
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r = serve(server, wins[2:])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side entries only (kernels, memsets, copies): the CPU ops
    # that launched them report the same device time again
    avg = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in avg) / 1e3
    n = r.windows
    if busy_ms > 0:
        print(f"device busy {busy_ms / n:.3f} ms per window over {n} windows; "
              f"wall {wall * 1e3 / n:.1f} ms per window (profiled); idle "
              f"share {1 - busy_ms / (wall * 1e3):.3f}; on {smi}")
        print("top device kernels, ms per window:")
        for e in sorted(avg, key=lambda e: -e.self_device_time_total)[:12]:
            print(f"  {e.self_device_time_total / 1e3 / n:8.3f}  "
                  f"x{e.count // n:<3d} {e.key[:90]}")
    else:
        print("device busy time: not measured (the profiler saw no device "
              "activity)")
    del server, r, prof

    phase("reference: f32 server on CUDA (K1, K3) vs on the CPU (plain)")
    s32 = flagship_settings(compute_dtype="float32", e2vid_fused_gates=True)
    gpu, cpu = (StreamServer(s32, 1, device=d) for d in (dev, "cpu"))
    cg, cc = gpu.initial_state(), cpu.initial_state()
    for i, (x, y, p, t) in enumerate(synthetic_windows(2, 100_000, 480, 640)):
        batch = gpu.pack(x, y, p, t)
        cg, lab_g, log_g = gpu.step(cg, upload_wire(batch, dev))
        cc, lab_c, log_c = cpu.step(cc, upload_wire(batch, "cpu"))
        err = (log_g.cpu() - log_c).abs().max().item()
        scale = log_c.abs().max().item()
        agree = (lab_g.cpu() == lab_c).float().mean().item()
        ok = err <= REF_REL_TOL * scale
        print(f"window {i}: max|cuda-cpu| logits {err:.3e} of max "
              f"{scale:.3f} (bound {REF_REL_TOL:.0e} x max) label "
              f"agreement {agree:.5f} {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"CUDA server disagrees with CPU: {err}")

    phase("summary")
    for key in ("K1", "K3"):
        kernels[key]["launches"] = launches[key]
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "check")
    rows = [{k: kernels[key][k] for k in order} for key in ("K1", "K3")]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
