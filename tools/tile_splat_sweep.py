#!/usr/bin/env python3
"""The tile-owner splats of K1, K4, K5 and K6
(``openess_tpu_torch/csrc/tile_splat.cuh``) on one CUDA card: what holds
each kernel below its byte bound.

Run from the root of a checkout::

    python3 tools/tile_splat_sweep.py             # K1 and K5 (DSEC)
    python3 tools/tile_splat_sweep.py --ddd17     # K4 and K6 (DDD17)
    python3 tools/tile_splat_sweep.py --turns     # K1 and K4, parent/change

DSEC, on the flagship batch (160 windows of 100 000 events,
5 x 480 x 640): for each tile (rows x cols) it launches K1 on the batch's
sorted-chunk wire (``chip_smoke.flagship_batch``) and K5's binning and
splat on the batch's padded windows (``chip_smoke.dsec_windows``), each
checked against its plain version (1e-5 of the max), and times each by
CUDA events behind ``chip_smoke.cuda_ms``'s 256 MB flush, beside the zero
fill of the grid alone (what writing 983 MB takes). It also times K1 at
the default tile on the same wire with each chunk's events shuffled, to
tell the cost of the chunks' sorted order (neighbouring lanes on
neighbouring cells).

DDD17, on one linear-probe batch (160 windows of 32 000 integer-pixel
events, 260 x 346; ``chip_smoke.ddd17_batch`` for K4's wire and
``chip_smoke.ddd17_events`` for K6's padded windows), signed and with
separate polarities: K4 and K6's binning and splat at the default tile,
checked and timed the same way, beside the zero fill of each grid.

Both then time, to tell where the time of a tile goes, three ablated
builds of the splat core made in a temporary directory from the sources
(timing only: their grids are wrong): the shared-memory atomics replaced
by plain read-modify-writes, the corner writes dropped (weights summed in
a register), and no events at all (zero and write the tiles: the tile
write alone). It prints the card's name and power limit and a last line
of JSON with every time.

``--turns`` times K1 on the flagship batch's wire (NW = 160) and K4 as
the DDD17 server launches it, on one window (NW = 1, signed): each by CUDA
events behind the flush, K4 also on the host clock over 200 calls back to
back (the wrapper's host time included); each ``TURN_REPS`` times, medians
and all readings in the JSON. It uses only the helpers and the wrappers
that every checkout since K4's port has, so a copy of this file in an
older checkout times that checkout's kernels: run the two in turns (A, B,
B, A, ...) in one call to compare them.
"""
import ctypes
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
TILES = ((16, 128), (16, 64), (8, 128), (32, 128), (16, 256))
ATOMIC = "        atomicAdd(cell + ct * rows * pitch, wxy * wt);\n"
ATOMIC2 = (
    "  atomicAdd(cell, sign * (1.0f - dts));\n"
    "  if (ti + 1 < bins) atomicAdd(cell + rows * pitch, sign * dts);\n")
# (name, [(text in csrc/tile_splat.cuh, its replacement)]): the trilinear
# splat's edits first, then the two-corner splat's
ABLATIONS = (
    ("plain read-modify-writes", [
        (ATOMIC, "        cell[ct * rows * pitch] += wxy * wt;\n"),
        (ATOMIC2, "  cell[0] += sign * (1.0f - dts);\n"
                  "  if (ti + 1 < bins) cell[rows * pitch] += sign * dts;\n"),
    ]),
    ("no corner writes", [
        (ATOMIC, "        sink += wxy * wt;\n"),
        ("  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;\n",
         "  float sink = 0.0f;\n"
         "  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;\n"),
        ("        sink += wxy * wt;\n      }\n    }\n  }\n}\n",
         "        sink += wxy * wt;\n      }\n    }\n  }\n"
         "  if (sink != sink) acc[0] = sink;  // never: keeps the sum\n}\n"),
        (ATOMIC2, "  const float sink = sign * (1.0f - dts)\n"
                  "      + (ti + 1 < bins ? sign * dts : 0.0f);\n"
                  "  if (sink != sink) *cell = sink;  // never: keeps it\n"),
    ]),
    ("no events", [("  const int total = segs.start[segs.n];\n",
                    "  const int total = 0;\n")]),
)


def ablated_libraries(build, name, edits):
    """The voxelizers' sources built with ``edits`` applied to the splat
    core, in a temporary directory; ``{source: ctypes.CDLL}``."""
    tmp = tempfile.mkdtemp(prefix="tile_splat_")
    for f in ("voxelize_chunked.cu", "voxelize_grid.cu", "tile_splat.cuh"):
        with open(os.path.join(build.CSRC_DIR, f)) as fh:
            text = fh.read()
        if f == "tile_splat.cuh":
            for old, new in edits:
                if old not in text:
                    raise AssertionError(f"{name}: the core has changed")
                text = text.replace(old, new)
        with open(os.path.join(tmp, f), "w") as fh:
            fh.write(text)
    libs = {}
    for f in ("voxelize_chunked.cu", "voxelize_grid.cu"):
        out = os.path.join(tmp, f + ".so")
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", tmp,
                        "-o", out, os.path.join(tmp, f)], check=True,
                       capture_output=True)
        libs[f] = ctypes.CDLL(out)
    return libs


def ablations(torch, flush, runs):
    """Each of ``runs`` (``{name: fn}``) timed with each ablated core
    swapped in under the wrappers: ``{ablation: {name: ms}}``."""
    from openess_tpu_torch.ops import _build

    out = {}
    kept = dict(_build._LIBS)
    for name, edits in ABLATIONS:
        _build._LIBS.update(ablated_libraries(_build, name, edits))
        _build.entry.cache_clear()
        for fn in runs.values():
            fn()
        torch.cuda.synchronize()
        out[name] = {k: cs.cuda_ms(torch, fn, flush, iters=10)
                     for k, fn in runs.items()}
        print(f"ablated core, {name}: " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in out[name].items())
            + " (timing only)", flush=True)
    _build._LIBS.update(kept)
    _build.entry.cache_clear()
    return out


def rel_err(torch, got, ref):
    torch.cuda.synchronize()
    return (got - ref).abs().max().item() / ref.abs().max().item()


def dsec(torch, dev, flush):
    """K1 and K5 at several tiles, shuffled chunks and the ablations."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.ops import voxelize_mxu as k56
    from openess_tpu_torch.ops.tile_splat import TilePlan, tile_plan

    s = cs.flagship_settings()
    host_batch, _ = cs.flagship_batch(s, k1)
    d = upload_wire(host_batch, dev)
    wire = tuple(d[k].reshape((-1,) + d[k].shape[2:]) for k in WIRE_KEYS)
    nw, nbc, e = wire[0].shape
    kw = dict(num_bins=5, height=480, width=640)
    ref1 = k1.voxelize_chunked_trilinear_plain(*wire, **kw)
    stacked = [np.stack([w[i] for w in cs.dsec_windows(s)]) for i in range(5)]
    stacked[3] = stacked[3].astype(np.float32)
    ev = [torch.from_numpy(a.reshape(-1)).to(dev) for a in stacked]
    ref5 = k56.voxelize_windows_trilinear_mxu(
        *ev, num_windows=nw, **kw).view(nw, 5, 480, 640)
    grid = torch.empty_like(ref1)
    out = {"zero_fill_ms": cs.cuda_ms(torch, grid.zero_, flush, iters=10)}
    rows = []
    for r, c in TILES:
        plan = TilePlan(5, 480, 640, r, c)
        run1 = lambda: k1.voxelize_chunked_trilinear_into(grid, *wire,
                                                          plan=plan)
        run1()
        err1 = rel_err(torch, grid, ref1)
        ms1 = cs.cuda_ms(torch, run1, flush, iters=10)
        run_b = lambda: k56.bin_events_trilinear(*ev, num_windows=nw, **kw,
                                                 plan=plan)
        binning = run_b()
        run_s = lambda: k56.splat_binned_trilinear(
            *binning, grid.view(nw * 5, 480, 640), num_windows=nw, plan=plan)
        run_s()
        err5 = rel_err(torch, grid, ref5)
        ms_b = cs.cuda_ms(torch, run_b, flush, iters=10)
        ms_s = cs.cuda_ms(torch, run_s, flush, iters=10)
        rows.append(dict(rows=r, cols=c, smem_bytes=plan.smem_bytes,
                         k1_ms=ms1, k5_binning_ms=ms_b, k5_splat_ms=ms_s,
                         k1_rel_err=err1, k5_rel_err=err5))
        print(f"tile {r}x{c} ({plan.smem_bytes} B of shared memory): K1 "
              f"{ms1:.4f} ms; K5 binning {ms_b:.4f}, splat {ms_s:.4f} ms "
              f"(errors {err1:.1e}, {err5:.1e} of max)", flush=True)
        if max(err1, err5) > cs.K1_REL_TOL:
            raise AssertionError(f"tile {r}x{c} disagrees: {err1}, {err5}")
        del binning
    # each chunk's events in a random order: same grid, other lanes' cells
    slot = torch.arange(e, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    key = (torch.rand((nw, nbc, e), generator=gen, device=dev)
           + (slot >= wire[4][..., None]).float() * 2)
    perm = torch.argsort(key, dim=2)
    shuffled = tuple(torch.gather(a, 2, perm).contiguous()
                     for a in wire[:4]) + wire[4:]
    run = lambda: k1.voxelize_chunked_trilinear_into(grid, *shuffled)
    run()
    err = rel_err(torch, grid, ref1)
    out["k1_shuffled_ms"] = cs.cuda_ms(torch, run, flush, iters=10)
    print(f"K1, each chunk's events shuffled, 16x128: "
          f"{out['k1_shuffled_ms']:.4f} ms (error {err:.1e} of max); zero "
          f"fill of the 983 MB grid {out['zero_fill_ms']:.4f} ms")
    if err > cs.K1_REL_TOL:
        raise AssertionError(f"shuffled wire disagrees: {err}")
    out["tiles"] = rows
    plan = tile_plan(5, 480, 640)
    binning = k56.bin_events_trilinear(*ev, num_windows=nw, **kw)
    out["ablations"] = ablations(torch, flush, {
        "K1": lambda: k1.voxelize_chunked_trilinear_into(grid, *wire),
        "K5 splat": lambda: k56.splat_binned_trilinear(
            *binning, grid.view(nw * 5, 480, 640), num_windows=nw,
            plan=plan)})
    return out


def ddd17(torch, dev, flush):
    """K4 and K6 at the default tile, signed and separate, and the
    ablations."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.ops import voxelize_mxu as k56
    from openess_tpu_torch.ops.voxelize import voxel_grid_bilinear_t

    host_batch, _ = cs.ddd17_batch(cs.ddd17_probe_settings())
    d = upload_wire(host_batch, dev)
    wire = tuple(d[k].reshape((-1,) + d[k].shape[2:]) for k in WIRE_KEYS)
    nw, k = 160, 32000
    ev = [torch.from_numpy(a.reshape(-1)).to(dev)
          for a in cs.ddd17_events(np.random.default_rng(6), nw, k)]
    out, runs = {}, {}
    for separate in (False, True):
        tag = "separate" if separate else "signed"
        cout = 10 if separate else 5
        kw = dict(num_bins=5, height=260, width=346, separate_pol=separate)
        plan = k56.bilinear_t_plan(5, 260, 346, separate)
        grid4 = torch.empty((nw, cout, 260, 346), device=dev)
        grid6 = grid4.view(nw * cout, 260, 346)
        run4 = lambda g=grid4, s=separate: k1.voxelize_chunked_bilinear_t_into(
            g, *wire, separate_pol=s)
        run4()
        err4 = rel_err(torch, grid4, k1.voxelize_chunked_bilinear_t_plain(
            *wire, **kw))
        run_b = lambda kw=kw: k56.bin_events_bilinear_t(*ev, num_windows=nw,
                                                        **kw)
        binning = run_b()
        run6 = lambda b=binning, g=grid6, s=separate, p=plan: \
            k56.splat_binned_bilinear_t(*b, g, num_windows=nw, num_bins=5,
                                        separate_pol=s, plan=p)
        run6()
        err6 = rel_err(torch, grid6, voxel_grid_bilinear_t(
            *(a.view(nw, k) for a in ev), **kw).view(grid6.shape))
        times = {"K4": cs.cuda_ms(torch, run4, flush, iters=10),
                 "K6 binning": cs.cuda_ms(torch, run_b, flush, iters=10),
                 "K6 splat": cs.cuda_ms(torch, run6, flush, iters=10),
                 "zero fill": cs.cuda_ms(torch, grid4.zero_, flush,
                                         iters=10)}
        out[tag] = dict(times, k4_rel_err=err4, k6_rel_err=err6)
        print(f"[{tag}, {tuple(grid4.shape)}] " + ", ".join(
            f"{k_} {v:.4f} ms" for k_, v in times.items())
            + f" (errors {err4:.1e}, {err6:.1e} of max)", flush=True)
        if max(err4, err6) > cs.K4_REL_TOL:
            raise AssertionError(f"DDD17 [{tag}] disagrees: {err4}, {err6}")
        runs[f"K4 {tag}"] = run4
        runs[f"K6 splat {tag}"] = run6
    out["ablations"] = ablations(torch, flush, runs)
    return out


def turns(torch, dev, flush):
    """K1 at NW = 160 and K4 at NW = 1 (signed), each the median over
    ``TURN_REPS`` readings behind the flush, K4 also the host-clock time a
    call over 200 calls back to back."""
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.ops import voxelize_chunked as k1

    def wire_of(host_batch, nw=None):
        d = upload_wire(host_batch, dev)
        return tuple(d[k].reshape((-1,) + d[k].shape[2:])[:nw].contiguous()
                     for k in WIRE_KEYS)

    def wall_ms(fn, n=200):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    wire = wire_of(cs.flagship_batch(cs.flagship_settings(), k1)[0])
    run1 = lambda: k1.voxelize_chunked_trilinear(
        *wire, num_bins=5, height=480, width=640)
    k1_ms = [cs.cuda_ms(torch, run1, flush, iters=20)
             for _ in range(TURN_REPS)]
    del wire
    one = wire_of(cs.ddd17_batch(cs.ddd17_probe_settings())[0], nw=1)
    run4 = lambda: k1.voxelize_chunked_bilinear_t(
        *one, num_bins=5, height=260, width=346, separate_pol=False)
    k4_ms = [cs.cuda_ms(torch, run4, flush, iters=50)
             for _ in range(TURN_REPS)]
    k4_wall = [wall_ms(run4) for _ in range(TURN_REPS)]
    out = dict(k1_ms=float(np.median(k1_ms)),
               k4_nw1_ms=float(np.median(k4_ms)),
               k4_nw1_wall_ms=float(np.median(k4_wall)),
               k1_ms_all=k1_ms, k4_nw1_ms_all=k4_ms,
               k4_nw1_wall_ms_all=k4_wall)
    print(f"K1 at NW = 160: {out['k1_ms']:.4f} ms; K4 at NW = 1, signed: "
          f"{out['k4_nw1_ms']:.4f} ms behind the flush, "
          f"{out['k4_nw1_wall_ms']:.4f} ms a call back to back (medians of "
          f"{TURN_REPS})", flush=True)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("tile_splat_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"device": smi}
    if "--turns" in sys.argv[1:]:
        out["turns"] = turns(torch, dev, flush)
    elif "--ddd17" in sys.argv[1:]:
        out["ddd17"] = ddd17(torch, dev, flush)
    else:
        out.update(dsec(torch, dev, flush))
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
