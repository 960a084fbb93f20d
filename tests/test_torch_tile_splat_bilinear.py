"""The tile-owner splats of K4 and K6 on the CPU: their tile plan at the
DDD17 sensor, the plain versions of K6's binning passes
(``bin_events_bilinear_t_plain``) and of its splat over the binned events
(``splat_binned_bilinear_t_plain``), which the card's passes are held to
(``tests/test_torch_gpu.py``, ``chip_smoke.py``), and a pure-Python model
of K4's tile owner: which chunks each tile keeps, and in which box.

Tolerances, relative to the grid's largest value:
- the plain binned splat and the K4 model against the plain grids
  (``voxel_grid_bilinear_t``, ``voxelize_chunked_bilinear_t_plain``) and
  JAX's exact scatter: 1e-6 (the same f32 products, summed in another
  order);
- against the Pallas kernels in interpret mode: 5e-3 for K6 and 1e-2 for
  K4, the bounds of ``test_torch_voxelize_grid.py`` and
  ``test_torch_voxelize_ddd17.py`` (the TPU kernels round their time
  weights to bf16 for the matrix unit).
The binning's counts and offsets are held exactly, each run's events as a
multiset.
"""
import jax
import numpy as np
import pytest
import torch

from chip_smoke import k4_edge_wire
from openess_tpu.ops import voxelize as jvox
from openess_tpu.ops import voxelize_chunked as jvc
from openess_tpu.ops import voxelize_mxu as jmxu
from openess_tpu_torch.ops import tile_splat as ts
from openess_tpu_torch.ops import voxelize_chunked as tvc
from openess_tpu_torch.ops import voxelize_mxu as tmxu
from openess_tpu_torch.ops.voxelize import voxel_grid_bilinear_t
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

BINNED_TOL = 1e-6
K6_PALLAS_TOL = 5e-3
K4_PALLAS_TOL = 1e-2
HEIGHT, WIDTH = 260, 346
# K4's chunk block, 16 rows x 128 columns of the TPU kernel's padded grid
BLOCK_ROWS, BLOCK_COLS = tvc.TILE_ROWS, tvc.TILE_COLS


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _static_smem():
    """K1's and K4's segment list beside the accumulator (bytes)."""
    return 256 * 8 + 257 * 4 + 256 * 16 + 4 + 2 * 8 * 4


@pytest.mark.parametrize("separate_pol", [False, True],
                         ids=["signed", "separate"])
def test_plan_at_the_ddd17_sensor(separate_pol):
    """5 or 10 channels at 260x346: 17 x 3 tiles of 16 x 128, the last
    column tile 90 wide and the last row tile 4 rows, each cell in one
    tile; the accumulator (42,240 B or 84,480 B) within the 96 KB budget
    and, beside K4's segment list, within a block's shared memory; K6's
    binning has one slot a tile."""
    cout = 10 if separate_pol else 5
    plan = tmxu.bilinear_t_plan(5, HEIGHT, WIDTH, separate_pol)
    assert plan == ts.tile_plan(cout, HEIGHT, WIDTH, categories=1)
    assert (plan.rows, plan.cols, plan.tiles_y, plan.tiles_x) == \
        (16, 128, 17, 3)
    assert plan.tiles == 51 and plan.slots_per_window == 51
    assert plan.smem_bytes == cout * 16 * 132 * 4 == \
        (84_480 if separate_pol else 42_240)
    assert plan.smem_bytes <= ts.TILE_SMEM_BUDGET
    assert plan.smem_bytes + _static_smem() <= ts.SMEM_LIMIT
    assert plan.count_smem_bytes == 204 and plan.scatter_smem_bytes == 612
    cover = np.zeros((HEIGHT, WIDTH), np.int32)
    for tile in range(plan.tiles):
        r0, r1, c0, c1 = plan.tile_box(tile)
        cover[r0:r1, c0:c1] += 1
    assert (cover == 1).all()
    assert plan.tile_box(plan.tiles - 1) == (256, 260, 256, 346)
    # K4's plan is the same tile with K5's four categories (unused)
    k4 = ts.tile_plan(cout, HEIGHT, WIDTH)
    assert (k4.rows, k4.cols, k4.smem_bytes) == (16, 128, plan.smem_bytes)


# ---------------------------------------------------------------------------
# K6: binning and splat
# ---------------------------------------------------------------------------


def _k6_events(rng, nw, k, H, W, case):
    """Flat integer-pixel events, some outside the frame, 90 % valid.
    ``edges``: window 0 is padding only; window 1 has fractional negative
    coordinates and its first and last valid events outside the frame;
    window 2 holds one event (dt = 0 -> 1)."""
    x = rng.integers(-3, W + 3, (nw, k)).astype(np.float32)
    y = rng.integers(-3, H + 3, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = (1e8 + np.sort(rng.uniform(0, 5e4, (nw, k)), axis=1)).astype(
        np.float32)
    valid = rng.random((nw, k)) < 0.9
    if case == "edges":
        valid[0] = False
        x[1, :20] = rng.uniform(-0.9, -0.1, 20)
        y[1, 20:40] = rng.uniform(-0.9, -0.1, 20)
        valid[1, [0, -1]] = True
        x[1, 0], y[1, -1] = -5.0, H + 4.0
        valid[2] = False
        valid[2, 9] = True
        x[2, 9], y[2, 9] = W // 2, H // 2
    return x, y, p, t, valid


def _flat(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a).reshape(-1))
                 for a in arrays)


def _numpy_binning(x, y, p, t, valid, C, plan):
    """An independent numpy model of K6's binning: per window the counts
    and offsets of its tiles and each tile's records ``(x, y, tn, pol)``,
    sorted."""
    nw, k = x.shape
    counts = np.zeros((nw, plan.tiles), np.int64)
    offsets = np.zeros((nw, plan.tiles), np.int64)
    runs = {}
    for w in range(nw):
        v = valid[w]
        if v.any():
            tf, tl = t[w][v].min(), t[w][v].max()
            dt = np.float32(tl - tf)
            dt = np.float32(1.0) if dt == 0 else dt
            tn = np.float32(C - 1) * (t[w] - tf) / dt
        else:
            tn = np.zeros(k, np.float32)
        keep = v & (x[w] >= 0) & (x[w] < plan.width) & (y[w] >= 0) & (
            y[w] < plan.height)
        tile = ((y[w].astype(np.int64) // plan.rows) * plan.tiles_x
                + x[w].astype(np.int64) // plan.cols)
        pol = np.where(p[w] == 0, np.float32(-1.0), p[w])
        for i in range(plan.tiles):
            sel = keep & (tile == i)
            counts[w, i] = sel.sum()
            rec = np.stack([x[w][sel], y[w][sel], tn[sel], pol[sel]], -1)
            runs[w, i] = rec[np.lexsort(rec.T[::-1])]
        offsets[w] = w * k + np.cumsum(counts[w]) - counts[w]
    return counts, offsets, runs


@pytest.mark.parametrize("case", ["dense", "edges"])
@pytest.mark.parametrize("hw", [(HEIGHT, WIDTH), (37, 150), (48, 96)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_plain_binning_matches_numpy(hw, case):
    """Counts and offsets exactly as the numpy model's; each run holds its
    tile's events as a multiset: padding, events outside the frame and
    fractional negative coordinates dropped, the time range taken over
    every valid event, in frame or not."""
    H, W = hw
    C, nw, k = 5, 3, 2000
    x, y, p, t, valid = _k6_events(np.random.default_rng(7), nw, k, H, W,
                                   case)
    plan = tmxu.bilinear_t_plan(C, H, W, False)
    counts, offsets, binned = tmxu.bin_events_bilinear_t_plain(
        *_flat(x, y, p, t, valid), num_windows=nw, num_bins=C, plan=plan)
    want_c, want_o, runs = _numpy_binning(x, y, p, t, valid, C, plan)
    assert counts.dtype == torch.int32 and offsets.dtype == torch.int64
    assert binned.shape == (nw * k, 4)
    np.testing.assert_array_equal(counts.numpy().reshape(nw, -1), want_c)
    np.testing.assert_array_equal(offsets.numpy().reshape(nw, -1), want_o)
    for (w, i), rec in runs.items():
        o, n = int(want_o[w, i]), int(want_c[w, i])
        got = binned[o:o + n].numpy()
        np.testing.assert_array_equal(got[np.lexsort(got.T[::-1])], rec)
    if case == "edges":
        assert not counts[:plan.tiles].any()  # padding only
        # the out-of-frame first and last events set window 1's range
        rows, slot = tmxu.binned_rows(counts, offsets)
        tn = binned[rows[slot // plan.tiles == 1], 2]
        assert 0.0 < tn.min() and tn.max() < C - 1
        # the fractional negatives are dropped, the other events kept
        assert not (binned[rows, :2] < 0).any()
        assert int(counts[2 * plan.tiles:].sum()) == 1
        assert binned[rows[-1]].tolist()[2] == 0.0  # dt = 0 -> 1


@pytest.mark.parametrize("separate_pol", [False, True],
                         ids=["signed", "separate"])
@pytest.mark.parametrize("hw", [(HEIGHT, WIDTH), (37, 150), (48, 96)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_k6_plain_binned_splat_equals_the_plain_grid(hw, separate_pol):
    """Binning and then splatting tile by tile gives the exact scatter
    ``voxel_grid_bilinear_t`` over the windows on integer events, JAX's
    exact scatter, and JAX's Pallas kernel in interpret mode."""
    H, W = hw
    C, nw, k = 5, 3, 2000
    ev = _k6_events(np.random.default_rng(11), nw, k, H, W, "dense")
    ev[4][0] = False  # a window of padding only
    plan = tmxu.bilinear_t_plan(C, H, W, separate_pol)
    binning = tmxu.bin_events_bilinear_t_plain(
        *_flat(*ev), num_windows=nw, num_bins=C, plan=plan)
    got = tmxu.splat_binned_bilinear_t_plain(
        *binning, num_windows=nw, num_bins=C, separate_pol=separate_pol,
        plan=plan).numpy()
    kw = dict(num_bins=C, height=H, width=W, separate_pol=separate_pol)
    ref = voxel_grid_bilinear_t(*(torch.from_numpy(a) for a in ev),
                                **kw).reshape(got.shape).numpy()
    jref = np.asarray(jax.vmap(lambda a: jvox.voxel_grid_bilinear_t(
        *a, **kw))(ev)).reshape(got.shape)
    pal = np.asarray(jmxu.voxelize_windows_bilinear_t_mxu(
        *(a.reshape(-1) for a in ev), num_windows=nw, interpret=True, **kw))
    cout = 2 * C if separate_pol else C
    assert got.shape == pal.shape == (nw * cout, H, W)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= BINNED_TOL and _rel(got, jref) <= BINNED_TOL
    assert _rel(got, pal) <= K6_PALLAS_TOL
    assert not got[:cout].any()


def test_k6_binning_wrapper_runs_the_plain_version_on_the_cpu():
    """``bin_events_bilinear_t`` on CPU tensors is the plain version for
    the default plan, and the K6 wrapper counts no launch there."""
    ev = _flat(*_k6_events(np.random.default_rng(3), 2, 500, 37, 150,
                           "dense"))
    kw = dict(num_windows=2, num_bins=5, height=37, width=150)
    for sep in (False, True):
        got = tmxu.bin_events_bilinear_t(*ev, **kw, separate_pol=sep)
        ref = tmxu.bin_events_bilinear_t_plain(
            *ev, num_windows=2, num_bins=5,
            plan=tmxu.bilinear_t_plan(5, 37, 150, sep))
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    before = tmxu.voxelize_windows_bilinear_t_mxu.launches
    tmxu.voxelize_windows_bilinear_t_mxu(*ev, **kw)
    assert tmxu.voxelize_windows_bilinear_t_mxu.launches == before
    m = torch.zeros(1000, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tmxu.bin_events_bilinear_t(
            m, m, m, m, torch.ones(1000, dtype=torch.bool, device="meta"),
            **kw)


# ---------------------------------------------------------------------------
# K4: the tile owner's chunk selection
# ---------------------------------------------------------------------------


def _k4_tile_owner(wire, C, H, W, separate_pol):
    """A pure-Python model of K4's tile owner (``bil_tile_splat``): every
    tile of the plan reads every chunk of its window, keeps a chunk when
    its clamped 16 x 128 block, cut to the frame, meets the tile, and adds
    the chunk's first ``min(count, chunk)`` events inside block and tile,
    two time corners each, in f32."""
    wire_t = tuple(torch.from_numpy(np.asarray(a)) for a in wire)
    x, y, tn, v = (a.numpy() for a in tvc._dequant(
        wire_t[0], wire_t[1], wire_t[2], wire_t[3], wire_t[6], C))
    counts, desc = np.asarray(wire[4]), np.asarray(wire[5])
    nw, nbc, e = x.shape
    cout = 2 * C if separate_pol else C
    plan = ts.tile_plan(cout, H, W)
    h_pad, w_pad = tvc.padded_grid_bilinear(H, W)
    out = np.zeros((nw, cout, H, W), np.float32)
    for w in range(nw):
        for tile in range(plan.tiles):
            tr0, tr1, tc0, tc1 = plan.tile_box(tile)
            for j in range(nbc):
                n = min(int(counts[w, j]), e)
                r0 = min(max(int(desc[w, j]) & 0xFFFF, 0), h_pad - BLOCK_ROWS)
                c0 = min(max(int(desc[w, j]) >> 16, 0), w_pad - BLOCK_COLS)
                bx0, bx1 = max(c0, tc0), min(c0 + BLOCK_COLS, tc1)
                by0, by1 = max(r0, tr0), min(r0 + BLOCK_ROWS, tr1)
                if n <= 0 or bx0 >= bx1 or by0 >= by1:
                    continue
                xs, ys, t_, vs = x[w, j, :n], y[w, j, :n], tn[w, j, :n], \
                    v[w, j, :n]
                xi, yi = xs.astype(np.int32), ys.astype(np.int32)
                ti = np.trunc(t_).astype(np.int64)
                ok = ((t_ >= 0) & (xi >= bx0) & (xi < bx1) & (yi >= by0)
                      & (yi < by1) & (ti < C))
                dts = t_ - ti.astype(np.float32)
                sign = np.ones_like(vs) if separate_pol else vs
                ch = np.where(separate_pol & ~(vs > 0), C + ti, ti)
                for dt, wt in ((0, sign * (np.float32(1) - dts)),
                               (1, sign * dts)):
                    m = ok & (ti + dt < C)
                    np.add.at(out[w], (ch[m] + dt, yi[m], xi[m]), wt[m])
    return out


K4_CASES = ["shuffled", "misaligned", "beyond_clamp", "counts",
            "time_range", "ragged", "odd_width"]


@pytest.mark.parametrize("separate_pol", [False, True],
                         ids=["signed", "separate"])
@pytest.mark.parametrize("t16", [False, True], ids=["v1", "v2"])
@pytest.mark.parametrize("case", K4_CASES)
def test_k4_tile_owner_model_reproduces_the_plain_version(case, t16,
                                                          separate_pol):
    """The tile owner's chunk selection, modelled in Python, gives K4's
    plain grid on shuffled, misaligned, clamped and padded wires, and JAX's
    Pallas kernel in interpret mode."""
    wire, H, W = k4_edge_wire(np.random.default_rng(1205),
                              case.replace("_", " "), t16, nw=2, n=1500,
                              chunk=128)
    C = 5
    got = _k4_tile_owner(wire, C, H, W, separate_pol)
    kw = dict(num_bins=C, height=H, width=W, separate_pol=separate_pol)
    ref = tvc.voxelize_chunked_bilinear_t_plain(
        *(torch.from_numpy(a) for a in wire), **kw).numpy()
    pal = np.asarray(jvc.voxelize_chunked_bilinear_t(*wire, interpret=True,
                                                     **kw))
    assert got.shape == ref.shape == pal.shape
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= BINNED_TOL
    assert _rel(got, pal) <= K4_PALLAS_TOL
    if case == "misaligned":
        # some chunk's block straddles two row tiles and both keep it
        plan = ts.tile_plan(2 * C if separate_pol else C, H, W)
        r0 = np.asarray(wire[5]) & 0xFFFF
        assert ((r0 % plan.rows) != 0).any()
