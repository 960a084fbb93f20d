#!/usr/bin/env python3
"""The tile-owner splat of K1 and K5 (``openess_tpu_torch/csrc/tile_splat.cuh``)
on one CUDA card at several tile shapes, on the flagship DSEC batch
(160 windows of 100 000 events, 5 x 480 x 640): what holds each kernel
below its byte bound.

Run from the root of a checkout::

    python3 tools/tile_splat_sweep.py

For each tile (rows x cols) it launches K1 on the batch's sorted-chunk
wire (``chip_smoke.flagship_batch``) and K5's binning and splat on the
batch's padded windows (``chip_smoke.dsec_windows``), each checked against
its plain version (1e-5 of the max), and times each by CUDA events behind
``chip_smoke.cuda_ms``'s 256 MB flush, beside the zero fill of the grid
alone (what writing 983 MB takes). It also times K1 at the default tile
on the same wire with each chunk's events shuffled, to tell the cost of
the chunks' sorted order (neighbouring lanes on neighbouring cells), and,
to tell where the time of a tile goes, three ablated builds of the splat
core made in a temporary directory from the sources (timing only: their
grids are wrong): the shared-memory atomics replaced by plain
read-modify-writes, the corner writes dropped (weights summed in a
register), and no events at all (zero and write the tiles). It prints the
card's name and power limit and a last line of JSON with every time.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

TILES = ((16, 128), (16, 64), (8, 128), (32, 128), (16, 256))
ATOMIC = "        atomicAdd(cell + ct * rows * pitch, wxy * wt);\n"
# (name, [(text in csrc/tile_splat.cuh, its replacement)])
ABLATIONS = (
    ("plain read-modify-writes",
     [(ATOMIC, "        cell[ct * rows * pitch] += wxy * wt;\n")]),
    ("no corner writes", [
        (ATOMIC, "        sink += wxy * wt;\n"),
        ("  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;\n",
         "  float sink = 0.0f;\n"
         "  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;\n"),
        ("        sink += wxy * wt;\n      }\n    }\n  }\n}\n",
         "        sink += wxy * wt;\n      }\n    }\n  }\n"
         "  if (sink != sink) acc[0] = sink;  // never: keeps the sum\n}\n"),
    ]),
    ("no events", [("  const int total = segs.start[segs.n];\n",
                    "  const int total = 0;\n")]),
)


def ablated_libraries(build, name, edits):
    """K1's and K5's sources built with ``edits`` applied to the splat
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("tile_splat_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    from openess_tpu_torch.data.device_voxelize import WIRE_KEYS, upload_wire
    from openess_tpu_torch.ops import voxelize_chunked as k1
    from openess_tpu_torch.ops import voxelize_mxu as k56
    from openess_tpu_torch.ops.tile_splat import TilePlan

    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
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
    out = {"device": smi, "zero_fill_ms": cs.cuda_ms(
        torch, grid.zero_, flush, iters=10)}

    def rel(ref):
        torch.cuda.synchronize()
        return (grid - ref).abs().max().item() / ref.abs().max().item()

    rows = []
    for r, c in TILES:
        plan = TilePlan(5, 480, 640, r, c)
        run1 = lambda: k1.voxelize_chunked_trilinear_into(grid, *wire,
                                                          plan=plan)
        run1()
        err1 = rel(ref1)
        ms1 = cs.cuda_ms(torch, run1, flush, iters=10)
        run_b = lambda: k56.bin_events_trilinear(*ev, num_windows=nw, **kw,
                                                 plan=plan)
        binning = run_b()
        run_s = lambda: k56.splat_binned_trilinear(
            *binning, grid.view(nw * 5, 480, 640), num_windows=nw, plan=plan)
        run_s()
        err5 = rel(ref5)
        ms_b = cs.cuda_ms(torch, run_b, flush, iters=10)
        ms_s = cs.cuda_ms(torch, run_s, flush, iters=10)
        row = dict(rows=r, cols=c, smem_bytes=plan.smem_bytes, k1_ms=ms1,
                   k5_binning_ms=ms_b, k5_splat_ms=ms_s,
                   k1_rel_err=err1, k5_rel_err=err5)
        print(f"tile {r}x{c} ({plan.smem_bytes} B of shared memory): K1 "
              f"{ms1:.4f} ms; K5 binning {ms_b:.4f}, splat {ms_s:.4f} ms "
              f"(errors {err1:.1e}, {err5:.1e} of max)", flush=True)
        if max(err1, err5) > cs.K1_REL_TOL:
            raise AssertionError(f"tile {r}x{c} disagrees: {err1}, {err5}")
        rows.append(row)
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
    err = rel(ref1)
    out["k1_shuffled_ms"] = cs.cuda_ms(torch, run, flush, iters=10)
    print(f"K1, each chunk's events shuffled, 16x128: "
          f"{out['k1_shuffled_ms']:.4f} ms (error {err:.1e} of max); zero "
          f"fill of the 983 MB grid {out['zero_fill_ms']:.4f} ms; on {smi}")
    if err > cs.K1_REL_TOL:
        raise AssertionError(f"shuffled wire disagrees: {err}")
    out["tiles"] = rows

    # the ablations, at the default tile, the libraries swapped under the
    # wrappers (timing only)
    from openess_tpu_torch.ops import _build
    from openess_tpu_torch.ops.tile_splat import tile_plan

    plan = tile_plan(5, 480, 640)
    binning = k56.bin_events_trilinear(*ev, num_windows=nw, **kw)
    run1 = lambda: k1.voxelize_chunked_trilinear_into(grid, *wire)
    run5 = lambda: k56.splat_binned_trilinear(
        *binning, grid.view(nw * 5, 480, 640), num_windows=nw, plan=plan)
    out["ablations"] = {}
    kept = dict(_build._LIBS)
    for name, edits in ABLATIONS:
        _build._LIBS.update(ablated_libraries(_build, name, edits))
        _build.entry.cache_clear()
        run1()
        run5()
        torch.cuda.synchronize()
        times = dict(k1_ms=cs.cuda_ms(torch, run1, flush, iters=10),
                     k5_splat_ms=cs.cuda_ms(torch, run5, flush, iters=10))
        out["ablations"][name] = times
        print(f"ablated core, {name}: K1 {times['k1_ms']:.4f} ms, K5 splat "
              f"{times['k5_splat_ms']:.4f} ms (timing only)", flush=True)
    _build._LIBS.update(kept)
    _build.entry.cache_clear()
    print(smi)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
