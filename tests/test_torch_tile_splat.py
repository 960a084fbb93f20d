"""The tile-owner splat's Python half on the CPU: the tile plan that K1's
and K5's wrappers pass to their kernels (``ops/tile_splat.py``), the plain
version of K5's binning passes (``bin_events_trilinear_plain``) and of its
splat over the binned events, which the card's passes are held to
(``tests/test_torch_gpu.py``, ``chip_smoke.py``), and the build's hash of
the headers a kernel source includes.

Tolerance: the plain splat over the binned events against the plain grid
(and JAX's exact scatter), 1e-6 of the grid max: the same f32 products,
summed in another order.
"""
import glob
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.ops import voxelize as jvox
from openess_tpu_torch.config.settings import load_settings
from openess_tpu_torch.ops import _build
from openess_tpu_torch.ops import tile_splat as ts
from openess_tpu_torch.ops import voxelize_mxu as tmxu
from openess_tpu_torch.ops.voxelize import voxelize_windows_trilinear
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BINNED_TOL = 1e-6
# DSEC's sensor, the synthetic sizes the port's tests train at, sizes the
# GPU tests launch, and a ragged frame
SHAPES = [(480, 640), (64, 96), (32, 64), (48, 96), (37, 130), (24, 256),
          (100, 150)]


def _static_smem():
    """Shared memory the splat kernels declare statically: K1's segment
    list (an int64 base, an int start and an int4 box for each of the 256
    threads of a block, and the warps' counts) is the larger."""
    return 256 * 8 + 257 * 4 + 256 * 16 + 4 + 2 * 8 * 4


def _events(rng, nw, k, H, W, lo=-2.5):
    x = rng.uniform(lo, W + 0.5, (nw, k)).astype(np.float32)
    y = rng.uniform(lo, H + 0.5, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = 1e8 + np.sort(rng.uniform(0, 5e4, (nw, k)), axis=1)
    valid = rng.random((nw, k)) < 0.9
    return x, y, p, t.astype(np.float32), valid


def _flat(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
                 for a in arrays)


@pytest.mark.parametrize("hw", SHAPES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_plan_partitions_every_cell_once(hw):
    H, W = hw
    plan = ts.tile_plan(5, H, W)
    cover = np.zeros((H, W), np.int32)
    for tile in range(plan.tiles):
        r0, r1, c0, c1 = plan.tile_box(tile)
        assert 0 <= r0 < r1 <= H and 0 <= c0 < c1 <= W
        cover[r0:r1, c0:c1] += 1
    assert (cover == 1).all()
    assert (plan.rows, plan.cols) == (ts.TILE_ROWS, ts.TILE_COLS)
    assert plan.pitch % 4 == 0  # 16-byte rows in shared memory
    if hw == (480, 640):
        assert (plan.tiles_y, plan.tiles_x, plan.tiles) == (30, 5, 150)
        assert plan.smem_bytes == 5 * 16 * 132 * 4 == 42_240


def _config_bins():
    paths = sorted(glob.glob(os.path.join(ROOT, "configs", "**", "*.yaml"),
                             recursive=True))
    return sorted({load_settings(p).nr_temporal_bins_b for p in paths})


@pytest.mark.parametrize("bins", sorted(set(_config_bins()) | {1, 10, 20, 40}))
def test_plan_fits_shared_memory(bins):
    """The splat's accumulator plus the static segment list stays under a
    block's 232,448 B at every bin count the configs use (and beyond), and
    within the budget that leaves two blocks an SM."""
    for H, W in SHAPES:
        plan = ts.tile_plan(bins, H, W)
        assert plan.smem_bytes <= ts.TILE_SMEM_BUDGET
        assert plan.smem_bytes + _static_smem() <= ts.SMEM_LIMIT
        assert plan.scatter_smem_bytes <= ts.SMEM_LIMIT
        assert plan.cols >= 32 and plan.rows >= 1
    assert 5 in _config_bins()


def test_plan_scratch_sizes():
    plan = ts.tile_plan(5, 480, 640)
    assert plan.slots_per_window == 150 * ts.CATEGORIES
    assert plan.slots(160) == 96_000
    assert plan.count_smem_bytes == 2400 and plan.scatter_smem_bytes == 7200
    with pytest.raises(ValueError, match="empty grid"):
        ts.tile_plan(5, 0, 640)


@pytest.mark.parametrize("hw", [(480, 640), (37, 130), (100, 150)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_plain_binned_splat_equals_the_plain_grid(hw):
    """Binning and then splatting tile by tile gives the plain grid, and
    JAX's exact scatter."""
    H, W = hw
    rng = np.random.default_rng(1205)
    nw, k = 3, 3000
    x, y, p, t, valid = _events(rng, nw, k, H, W)
    valid[0] = False  # a window of padding only
    ev = _flat(x, y, p, t, valid)
    plan = ts.tile_plan(5, H, W)
    counts, offsets, binned = tmxu.bin_events_trilinear_plain(
        *ev, num_windows=nw, plan=plan)
    got = tmxu.splat_binned_trilinear_plain(counts, offsets, binned,
                                            num_windows=nw, plan=plan)
    ref = voxelize_windows_trilinear(*ev, num_windows=nw, num_bins=5,
                                     height=H, width=W)
    jref = np.asarray(jvox.voxelize_windows_trilinear(
        *(jnp.asarray(a.numpy()) for a in ev), num_windows=nw, num_bins=5,
        height=H, width=W))
    scale = ref.abs().max().item()
    assert scale > 0
    assert (got - ref).abs().max().item() <= BINNED_TOL * scale
    assert np.abs(got.numpy() - jref).max() <= BINNED_TOL * scale
    assert not got[:5].any()
    # window w's runs follow each other in slot order from w * k
    assert counts.dtype == torch.int32 and offsets.dtype == torch.int64
    assert binned.shape == (nw * k, 4)
    c, o = counts.view(nw, -1).long(), offsets.view(nw, -1)
    assert (o[:, 0] == torch.arange(nw) * k).all()
    assert (o[:, 1:] == o[:, :-1] + c[:, :-1]).all()
    assert (o[:, -1] + c[:, -1] <= (torch.arange(nw) + 1) * k).all()
    rows, _ = tmxu.binned_rows(counts, offsets)
    unused = torch.ones(nw * k, dtype=torch.bool)
    unused[rows] = False
    assert rows.unique().numel() == rows.numel() and not binned[unused].any()


def _corner_tiles(x, y, plan):
    """The set of tiles holding an in-frame corner, per event."""
    out = []
    for xe, ye in zip(x.tolist(), y.tolist()):
        x0, y0 = int(xe), int(ye)  # trunc toward zero
        tiles = {(cy // plan.rows) * plan.tiles_x + cx // plan.cols
                 for cx in (x0, x0 + 1) for cy in (y0, y0 + 1)
                 if 0 <= cx < plan.width and 0 <= cy < plan.height}
        out.append(tiles)
    return out


@pytest.mark.parametrize("hw", [(48, 96), (100, 150), (480, 640)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_each_event_is_read_by_every_tile_its_corners_touch(hw):
    """Stored once at its home slot, an event is read by its home tile and
    by the neighbours its category spills into: exactly the tiles that
    hold one of its in-frame corners. Events on the tile seams make every
    category occur that the frame's tiles allow."""
    H, W = hw
    rng = np.random.default_rng(7)
    plan = ts.tile_plan(5, H, W)
    n = 4000
    x = rng.uniform(-2.5, W + 0.5, n).astype(np.float32)
    y = rng.uniform(-2.5, H + 0.5, n).astype(np.float32)
    # a quarter on the last column or row of a tile
    seam_x = (rng.integers(1, plan.tiles_x + 1, n) * plan.cols - 1).clip(
        max=W - 1) + rng.uniform(0, 1, n)
    seam_y = (rng.integers(1, plan.tiles_y + 1, n) * plan.rows - 1).clip(
        max=H - 1) + rng.uniform(0, 1, n)
    x[: n // 4] = seam_x[: n // 4]
    y[n // 8: n // 4 + n // 8] = seam_y[n // 8: n // 4 + n // 8]
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    slot, keep = ts.event_slots(xt, yt, plan)
    want = _corner_tiles(x, y, plan)
    assert keep.tolist() == [bool(w) for w in want]
    readers = ts.reader_tiles(slot[keep], plan)
    got = [set() for _ in range(int(keep.sum()))]
    for tile, reads in readers:
        for i in torch.nonzero(reads).flatten().tolist():
            got[i].add(int(tile[i]))
    assert got == [w for w in want if w]
    cats = set((slot[keep] % ts.CATEGORIES).tolist())
    if plan.tiles_x > 1:
        assert cats == set(range(ts.CATEGORIES))
    else:  # one tile column: nothing spills right
        assert cats == {ts.CAT_INTERIOR, ts.CAT_DOWN}


def test_binning_drops_padding_and_bins_negative_coordinates_to_tile_0():
    """Padding and events with no corner in the frame are dropped; a
    fractional negative coordinate in (-1, 0) (corners {0, 1}) or (-2, -1]
    (corners {-1, 0}) goes to tile column or row 0."""
    H, W = 40, 300
    plan = ts.tile_plan(5, H, W)
    x = np.array([-0.5, -1.5, -1.0, 5.0, -2.0, W + 0.0, 5.0, 5.0, 130.5,
                  W - 0.5], np.float32)
    y = np.array([3.0, 3.0, 3.0, -0.5, 3.0, 3.0, -2.5, 3.0, -1.5,
                  H - 0.5], np.float32)
    valid = np.ones(x.size, bool)
    valid[7] = False  # padding
    p = np.ones(x.size, np.float32)
    t = np.arange(x.size, dtype=np.float32)
    counts, offsets, binned = tmxu.bin_events_trilinear_plain(
        *_flat(x, y, p, t, valid), num_windows=1, plan=plan)
    kept = [0, 1, 2, 3, 8, 9]  # 4: x0 = -2; 5: x0 = W; 6: y0 = -2
    rows, _ = tmxu.binned_rows(counts, offsets)
    np.testing.assert_array_equal(np.sort(binned[rows, 0].numpy()),
                                  np.sort(x[kept]))
    slot, _ = ts.event_slots(torch.from_numpy(x), torch.from_numpy(y), plan)
    tile = (slot // ts.CATEGORIES).numpy()
    assert tile[[0, 1, 2, 3]].tolist() == [0, 0, 0, 0]
    assert tile[8] == 1  # column tile 1, row tile 0
    assert tile[9] == plan.tiles - 1
    assert int(counts.sum()) == len(kept)
    # the splat of the binned events is the plain grid
    got = tmxu.splat_binned_trilinear_plain(counts, offsets, binned,
                                            num_windows=1, plan=plan)
    ref = voxelize_windows_trilinear(*_flat(x, y, p, t, valid),
                                     num_windows=1, num_bins=5, height=H,
                                     width=W)
    assert (got - ref).abs().max() <= BINNED_TOL * ref.abs().max()


def test_bin_events_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    ev = _flat(*_events(rng, 2, 500, 37, 130))
    kw = dict(num_windows=2, num_bins=5, height=37, width=130)
    got = tmxu.bin_events_trilinear(*ev, **kw)
    ref = tmxu.bin_events_trilinear_plain(
        *ev, num_windows=2, plan=ts.tile_plan(5, 37, 130))
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    before = tmxu.voxelize_windows_trilinear_mxu.launches
    tmxu.voxelize_windows_trilinear_mxu(*ev, **kw)
    assert tmxu.voxelize_windows_trilinear_mxu.launches == before
    m = torch.zeros(1000, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmxu.bin_events_trilinear(
            m, m, m, m, torch.ones(1000, dtype=torch.bool, device="meta"),
            **kw)


def test_library_path_hashes_the_included_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ gives the source that includes it (also
    through another header) a new library; a source that does not include
    it keeps its library. No nvcc is needed."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    (tmp_path / "a.cu").write_text('#include "outer.cuh"\nint a;\n')
    (tmp_path / "b.cu").write_text("#include <stdint.h>\nint b;\n")
    (tmp_path / "outer.cuh").write_text('#pragma once\n#include "inner.cuh"\n')
    (tmp_path / "inner.cuh").write_text("#pragma once\nint x;\n")
    assert _build._sources("a.cu") == ["a.cu", "outer.cuh", "inner.cuh"]
    assert _build._sources("b.cu") == ["b.cu"]
    a0, b0 = _build.library_path("a.cu"), _build.library_path("b.cu")
    (tmp_path / "inner.cuh").write_text("#pragma once\nint y;\n")
    assert _build.library_path("a.cu") != a0
    assert _build.library_path("b.cu") == b0
    assert os.path.basename(a0).startswith("liba_")


def test_build_passes_the_source_directory_as_an_include_path(
        tmp_path, monkeypatch):
    """nvcc gets ``-I csrc`` so that ``#include "tile_splat.cuh"``
    resolves; the command is recorded without running a compiler."""
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "nvcc_path", lambda: "nvcc")
    (tmp_path / "a.cu").write_text("int a;\n")
    seen = {}

    class Done:
        returncode, stdout, stderr = 1, "", "no compiler here"

    def run(cmd, **kw):
        seen["cmd"] = cmd
        return Done()

    monkeypatch.setattr(_build.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build("a.cu")
    cmd = seen["cmd"]
    assert cmd[cmd.index("-I") + 1] == str(tmp_path)
    assert "arch=compute_90a,code=sm_90a" in cmd
