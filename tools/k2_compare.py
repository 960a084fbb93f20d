#!/usr/bin/env python3
"""K2 (superpixel pooling, ``openess_tpu_torch/csrc/segment_pool.cu``) on
one CUDA card, at every shape a main path gives it.

Run from the root of a checkout::

    python3 tools/k2_compare.py            # check, time, bound, ablations
    python3 tools/k2_compare.py --turns    # medians only, parent/change

The shapes (``SHAPES``): the pretrain steps' ``[8,440,640,256]`` at
S = 100 an image, bf16 and f32, on block superpixels
(``chip_smoke.block_superpixels``) and on per-pixel random ids (as the
bench draws them); a model rank's band under spatial partitioning,
``[2,220,640,256]`` at S = 100 an image (the upper half of the block
superpixels), bf16 and f32; and DDD17 pretrain's ``[8,200,352,256]`` at
``superpixel_size`` 25 (5 x 5 blocks), bf16.

Each call goes through ``segment_pool_sums(rows, ids, total)`` with the
image structure as keywords where the checkout's wrapper takes them (the
call ``segment_mean_pool`` makes), else flat. Device times are CUDA events
by ``chip_smoke.cuda_ms`` behind a flush, read behind two: ``FLUSH_BYTES``
(1 GiB, ~0.35 ms of device work, done after the wrapper's host work is)
and ``SMOKE_FLUSH_BYTES`` (256 MB, ``chip_smoke.py``'s flush before K2's
redesign, ~0.09 ms: a wrapper whose host work outlasts it is charged the
difference). The default mode holds each call (and, with the image
structure, the flat call too) to ``segment_pool_sums_plain`` (counts
exact, sums within ``chip_smoke.K2_REL_TOL`` of the largest sum) and times
it beside the plain version, the library call (``index_add_`` of the f32
cast plus ``bincount``, timed only) and the byte bound as
``chip_smoke.k2_phase`` counts it. Where the source takes ``ABLATIONS``'
edits, it then times variants of it built in a temporary directory (the
text edited there; timing only, their sums are wrong): the stream and the
run partials with no table and no atomics, and the table with no final
flush; and a variant whose blocks stamp their start and end on the global
timer (``CLOCK_EDITS``): the kernel's own span (first start to last end),
the median block's end and the last block's start, beside the events
around the call.

``--turns`` times only the call at each shape: ``TURN_REPS`` readings of
the median of 20 behind each flush, and on the host's clock over
``HOST_CALLS`` calls back to back, the microseconds a call takes to
enqueue (the wrapper's host work: the loop before the final synchronize;
also on features that require a gradient, as the student's do) and the
milliseconds a call in all (after it). It prints the medians and
every reading. It uses only ``segment_pool_sums``, ``global_segment_ids``
and ``chip_smoke``'s ``block_superpixels``, ``cuda_ms`` and ``bound``,
which every checkout since K2's port has, so a copy of this file in an
older checkout times that checkout's kernel: run the two in turns (A, B,
B, A, ...) in one call to compare them. Both modes print the card's name
and power limit and a last line of JSON.
"""
import ctypes
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TURN_REPS = 5
HOST_CALLS = 200
FLUSH_BYTES = 1 << 30
SMOKE_FLUSH_BYTES = 256 << 20
# (name, B, H, W, D, segments an image, dtype, ids): the block superpixel
# grid is rows x cols blocks
SHAPES = (
    ("flagship bf16 block", 8, 440, 640, 256, 100, "bfloat16", "block"),
    ("flagship bf16 random", 8, 440, 640, 256, 100, "bfloat16", "random"),
    ("flagship f32 block", 8, 440, 640, 256, 100, "float32", "block"),
    ("flagship f32 random", 8, 440, 640, 256, 100, "float32", "random"),
    ("band bf16 block", 2, 220, 640, 256, 100, "bfloat16", "band"),
    ("band f32 block", 2, 220, 640, 256, 100, "float32", "band"),
    ("ddd17 bf16 block", 8, 200, 352, 256, 25, "bfloat16", "block"),
)
RUN_FLUSH = "    if (cur < 0) return;\n"
TABLE_FLUSH = ("  // the one flush: every touched table row into device "
               "memory\n")
# (name, [(text in csrc/segment_pool.cu, its replacement)])
ABLATIONS = (
    ("stream only (no table, no atomics)", [
        (RUN_FLUSH, RUN_FLUSH.replace(
            "return;\n",
            "return;\n    float t = 0.0f;\n#pragma unroll\n"
            "    for (int i = 0; i < kLaneFloats; ++i) t += acc[i];\n"
            "    // never true: keeps the loads and the run sums\n"
            "    if (__float_as_uint(t) == 0x7fc00123u) sums[0] = t;\n"
            "    return;\n")),
        (TABLE_FLUSH, "  return;\n" + TABLE_FLUSH),
    ]),
    ("table, no final flush", [(TABLE_FLUSH, "  return;\n" + TABLE_FLUSH)]),
)
CLOCK_BLOCKS = 8192
CLOCK_EDITS = [
    ("#include <atomic>\n", "#include <atomic>\n\n"
     f"__device__ unsigned long long k2_clock[2][{CLOCK_BLOCKS}];\n"
     "extern \"C\" int k2_times(void* host) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, k2_clock, sizeof(k2_clock));\n"
     "}\n"
     "__device__ __forceinline__ void k2_stamp(int which) {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  const unsigned b = blockIdx.x + blockIdx.y * gridDim.x;\n"
     f"  if (threadIdx.x == 0 && b < {CLOCK_BLOCKS}) "
     "k2_clock[which][b] = t;\n}\n"),
    ("  const int img = blockIdx.x / p.parts;\n",
     "  k2_stamp(0);\n  const int img = blockIdx.x / p.parts;\n"),
    ("atomicAdd(counts + base + w, (float)n);\n  }\n}\n",
     "atomicAdd(counts + base + w, (float)n);\n  }\n  __syncthreads();\n"
     "  k2_stamp(1);\n}\n"),
]


def shape_inputs(torch, dev, shape, seed=1717):
    """``(rows [N, D], ids [N] int32, total, rows a image)`` of a shape,
    made on the card from ``seed``."""
    _, B, H, W, D, S, dtype, kind = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "random":
        sp = torch.randint(0, S, (B, H, W), generator=gen, device=dev,
                           dtype=torch.int32)
    else:
        side = int(round(S ** 0.5))
        grid = (cs.block_superpixels(B, 2 * H, W, side, side)[:, :H]
                if kind == "band" else
                cs.block_superpixels(B, H, W, side, side))
        sp = torch.from_numpy(grid).to(dev)
    ids, total = k2_module().global_segment_ids(sp, S)
    rows = torch.randn((B * H * W, D), generator=gen,
                       device=dev).to(getattr(torch, dtype))
    return rows, ids, total, H * W


def k2_module():
    from openess_tpu_torch.ops import segment_pool as k2

    return k2


def calls(rows, ids, total, shape, rpi):
    """``{"call": fn[, "flat": fn]}``: the main path's call (with the
    image structure where the wrapper takes it) and, then, the flat one."""
    k2 = k2_module()
    S = shape[5]
    flat = lambda: k2.segment_pool_sums(rows, ids, total)
    if "rows_per_image" in inspect.signature(k2.segment_pool_sums).parameters:
        return {"call": lambda: k2.segment_pool_sums(
            rows, ids, total, rows_per_image=rpi, segments_per_image=S),
            "flat": flat}
    return {"call": flat}


def nbytes(rows, ids, total):
    return (rows.numel() * rows.element_size() + ids.numel() * 4
            + total * rows.shape[1] * 4 + total * 4)


def edited_source(edits):
    """``csrc/segment_pool.cu`` with ``edits`` applied, or None where the
    checkout's source lacks one of the texts (an older kernel)."""
    from openess_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "segment_pool.cu")) as f:
        text = f.read()
    for old, new in edits:
        if text.count(old) != 1:
            return None
        text = text.replace(old, new)
    return text


def variant_library(text):
    """``text`` (an edited ``segment_pool.cu``) built in a temporary
    directory and swapped in under the wrapper; returns the library."""
    from openess_tpu_torch.ops import _build

    tmp = tempfile.mkdtemp(prefix="k2_variant_")
    src = os.path.join(tmp, "segment_pool.cu")
    with open(src, "w") as f:
        f.write(text)
    out = os.path.join(tmp, "libsegment_pool.so")
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                    _build.CSRC_DIR, "-o", out, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(out)
    _build._LIBS["segment_pool.cu"] = lib
    _build.entry.cache_clear()
    k2_module()._launcher.cache_clear()
    return lib


def block_span(torch, lib, fn, blocks, flush, reps=5):
    """Medians over ``reps`` calls of ``fn`` (the timing build bound; its
    grid ``blocks`` blocks) of the events around the call and, from the
    blocks' stamps, the kernel's span, the median block's end and the last
    block's start (ms from the first block's start)."""
    got = []
    for _ in range(reps):
        stamps = np.zeros((2, CLOCK_BLOCKS), np.uint64)
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        if lib.k2_times(ctypes.c_void_p(stamps.ctypes.data)) != 0:
            raise RuntimeError("k2_times failed")
        start, end = stamps[:, :blocks].astype(np.float64)
        t0 = start.min()
        got.append((a.elapsed_time(b), (end.max() - t0) / 1e6,
                    (np.median(end) - t0) / 1e6, (start.max() - t0) / 1e6))
    return dict(zip(("events_ms", "span_ms", "median_end_ms",
                     "last_start_ms"), np.median(np.array(got), axis=0)))


def full(torch, dev, flushes):
    k2 = k2_module()
    flush, smoke_flush = flushes
    out = {}
    mains = {}
    for shape in SHAPES:
        name = shape[0]
        rows, ids, total, rpi = shape_inputs(torch, dev, shape)
        ps, pc = k2.segment_pool_sums_plain(rows, ids, total)
        scale = ps.abs().max().item()
        idl = ids.long()
        row = {}
        for tag, fn in calls(rows, ids, total, shape, rpi).items():
            sk, ck = fn()
            torch.cuda.synchronize()
            err = (sk - ps).abs().max().item()
            if err > cs.K2_REL_TOL * scale or not torch.equal(ck, pc):
                raise AssertionError(f"K2 [{name}, {tag}] disagrees with "
                                     f"its plain version: {err}")
            row[f"{tag}_ms"] = cs.cuda_ms(torch, fn, flush)
            if tag == "call":
                row["call_ms_256mb"] = cs.cuda_ms(torch, fn, smoke_flush)
            row[f"{tag}_max_abs_err"] = err
        run_p = lambda: k2.segment_pool_sums_plain(rows, ids, total)
        run_l = lambda: (torch.zeros((total, rows.shape[1]),
                                     device=dev).index_add_(
                             0, idl, rows.float()),
                         torch.bincount(idl, minlength=total))
        row["plain_ms"] = cs.cuda_ms(torch, run_p, flush, iters=5, warmup=1)
        row["library_ms"] = cs.cuda_ms(torch, run_l, flush, iters=5,
                                       warmup=1)
        b_ms, b_by = cs.bound(nbytes(rows, ids, total), rows.numel(),
                              cs.F32_OPS_PER_S)
        row.update(bound_ms=b_ms, bound_by=b_by,
                   share=b_ms / row["call_ms"])
        print(f"K2 [{name}] " + ", ".join(
            f"{k} {v:.4f}" for k, v in row.items()
            if isinstance(v, float)) + f" ({b_by}; the call at "
            f"{row['share']:.0%} of its bound)", flush=True)
        out[name] = row
        mains[name] = (rows, ids, total, shape, rpi)
    texts = [(what, edited_source(edits)) for what, edits in ABLATIONS]
    clock_text = edited_source(CLOCK_EDITS)
    if clock_text is None or any(t is None for _, t in texts):
        return out  # an older kernel: no variants
    from openess_tpu_torch.ops import _build

    kept = dict(_build._LIBS)
    out["ablations"] = {}
    for what, text in texts:
        variant_library(text)
        times = {}
        for name, (rows, ids, total, shape, rpi) in mains.items():
            fn = calls(rows, ids, total, shape, rpi)["call"]
            times[name] = cs.cuda_ms(torch, fn, flush, iters=10)
        out["ablations"][what] = times
        print(f"ablation, {what}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in times.items())
            + " (timing only)", flush=True)
    lib = variant_library(clock_text)
    lib.k2_times.argtypes = [ctypes.c_void_p]
    out["spans"] = {}
    for name, (rows, ids, total, shape, rpi) in mains.items():
        fn = calls(rows, ids, total, shape, rpi)["call"]
        plan = k2.pool_plan(rows.shape[0], rows.shape[1], total,
                            elem_size=rows.element_size(),
                            rows_per_image=rpi, segments_per_image=shape[5])
        fn()
        span = block_span(torch, lib, fn, plan.blocks * plan.tiles, flush)
        out["spans"][name] = span
        print(f"K2 [{name}] by the blocks' clocks: " + ", ".join(
            f"{k} {v:.4f}" for k, v in span.items()) + " (the kernel at "
            f"{out[name]['bound_ms'] / span['span_ms']:.0%} of its bound "
            "over its own span)", flush=True)
    _build._LIBS.clear()
    _build._LIBS.update(kept)
    _build.entry.cache_clear()
    k2._launcher.cache_clear()
    return out


def host_clock(torch, fn, n=HOST_CALLS):
    """``(us, ms)``: the host microseconds a call of ``fn`` takes to
    enqueue over ``n`` calls back to back (before the synchronize) and the
    milliseconds a call in all (after it)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return (t1 - t0) / n * 1e6, (t2 - t0) / n * 1e3


def turns(torch, dev, flushes):
    out = {}
    for shape in SHAPES:
        rows, ids, total, rpi = shape_inputs(torch, dev, shape)
        fn = calls(rows, ids, total, shape, rpi)["call"]
        got = {"ms": [cs.cuda_ms(torch, fn, flushes[0])
                      for _ in range(TURN_REPS)],
               "ms_256mb": [cs.cuda_ms(torch, fn, flushes[1])
                            for _ in range(TURN_REPS)]}
        host = [host_clock(torch, fn) for _ in range(TURN_REPS)]
        got["host_us"] = [h[0] for h in host]
        got["wall_ms"] = [h[1] for h in host]
        # the same call on features that autograd records (the student's)
        leaf = rows.detach().requires_grad_(True)
        fn_g = calls(leaf, ids, total, shape, rpi)["call"]
        got["host_us_grad"] = [host_clock(torch, fn_g)[0]
                               for _ in range(TURN_REPS)]
        del leaf, fn_g
        row = {}
        for key, vals in got.items():
            row[key] = float(np.median(vals))
            row[f"{key}_all"] = vals
        out[shape[0]] = row
        print(f"K2 [{shape[0]}] " + "; ".join(
            f"{key} {row[key]:.4f} (median of {TURN_REPS}: "
            + ", ".join(f"{v:.4f}" for v in vals) + ")"
            for key, vals in got.items()), flush=True)
        del rows, ids
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("k2_compare: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    flushes = [torch.empty(n, dtype=torch.uint8, device=dev)
               for n in (FLUSH_BYTES, SMOKE_FLUSH_BYTES)]
    out = {"device": smi}
    if "--turns" in sys.argv[1:]:
        out["turns"] = turns(torch, dev, flushes)
    else:
        out.update(full(torch, dev, flushes))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
