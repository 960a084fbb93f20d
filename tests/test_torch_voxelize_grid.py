"""The grid wire's voxelizers against the JAX package on the CPU: the exact
scatters of ``ops/voxelize.py`` and the K5/K6 wrappers of
``ops/voxelize_mxu.py``, which on a CPU tensor run those scatters, their
plain versions.

Tolerances, relative to the grid's largest value:
- against JAX's exact XLA scatter (``voxelize_windows_trilinear``,
  ``vmap(voxel_grid_bilinear_t)``, ``event_histogram``): 1e-5 (measured 0,
  and 2.0e-7 after the nonzero normalization: the same f32 products, the
  statistics summed in another order);
- against the Pallas kernels in interpret mode
  (``voxelize_windows_*_mxu(interpret=True)``): 5e-3 (measured <= 3.4e-3:
  the TPU kernels round their one-hot operands to bf16 for the matrix unit).
The CUDA kernels are held to these plain versions on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py``).
"""
import jax
import numpy as np
import pytest
import torch

from openess_tpu.ops import voxelize as jvox
from openess_tpu.ops import voxelize_mxu as jmxu
from openess_tpu_torch.ops import voxelize as tvox
from openess_tpu_torch.ops import voxelize_mxu as tmxu
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

EXACT_TOL = 1e-5
PALLAS_TOL = 5e-3
NW, C, H, W = 2, 3, 24, 256


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


def _tri_events(rng, case):
    """Flat DSEC-like events for ``NW`` windows of 700 slots (not a
    multiple of the TPU kernel's 256-event chunk)."""
    n = NW * 700
    x = rng.uniform(-1.0, W, n).astype(np.float32)
    y = rng.uniform(-1.0, H, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (NW, n // NW)), axis=1).reshape(-1)
    t = t.astype(np.float32)
    valid = rng.random(n) < 0.9
    if case == "negative":  # fractional negative coordinates
        x[:40] = rng.uniform(-0.9, -0.1, 40)
        y[40:80] = rng.uniform(-0.9, -0.1, 40)
        x[80:100], y[80:100] = x[:20], y[40:60]
    elif case == "padding":  # window 0 holds padding only
        valid[:n // NW] = False
    elif case == "single":  # one event in window 1, none in window 0
        valid[:] = False
        valid[n // NW + 3] = True
        x[n // NW + 3], y[n // NW + 3], p[n // NW + 3] = 10.5, 7.25, 1.0
    return x, y, p, t, valid


@pytest.mark.parametrize("case", ["dense", "negative", "padding", "single"])
def test_k5_plain_matches_scatter_and_pallas(rng, case):
    ev = _tri_events(rng, case)
    kw = dict(num_windows=NW, num_bins=C, height=H, width=W)
    before = tmxu.voxelize_windows_trilinear_mxu.launches
    got = tmxu.voxelize_windows_trilinear_mxu(*_t(*ev), **kw).numpy()
    assert tmxu.voxelize_windows_trilinear_mxu.launches == before  # CPU
    ref = np.asarray(jvox.voxelize_windows_trilinear(*ev, **kw))
    pal = np.asarray(jmxu.voxelize_windows_trilinear_mxu(
        *ev, interpret=True, **kw))
    assert got.shape == ref.shape == pal.shape == (NW * C, H, W)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= EXACT_TOL
    assert _rel(got, pal) <= PALLAS_TOL
    if case == "padding":
        assert not got[:C].any()  # exact zeros
    if case == "single":
        # dt = 0 for one event: tn = 0, its mass is the sum of its weights
        assert not got[:C].any()
        assert abs(got.sum() - 1.0) <= 1e-6


@pytest.mark.parametrize("separate_pol", [True, False])
@pytest.mark.parametrize("case", ["dense", "padding", "single"])
def test_k6_plain_matches_scatter_and_pallas(rng, separate_pol, case):
    """Integer pixels, some outside the frame."""
    n = NW * 500
    x = rng.integers(-2, W + 2, n).astype(np.float32)
    y = rng.integers(-2, H + 2, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (NW, n // NW)), axis=1).reshape(-1)
    t = t.astype(np.float32)
    valid = rng.random(n) < 0.9
    if case == "padding":
        valid[:n // NW] = False
    elif case == "single":
        valid[:] = False
        valid[n // NW + 5] = True
        x[n // NW + 5], y[n // NW + 5] = 17.0, 3.0
    ev = (x, y, p, t, valid)
    kw = dict(num_windows=NW, num_bins=C, height=H, width=W,
              separate_pol=separate_pol)
    got = tmxu.voxelize_windows_bilinear_t_mxu(*_t(*ev), **kw).numpy()
    ref = np.asarray(jax.vmap(lambda a: jvox.voxel_grid_bilinear_t(
        *a, num_bins=C, height=H, width=W, separate_pol=separate_pol))(
        tuple(a.reshape(NW, -1) for a in ev))).reshape(-1, H, W)
    pal = np.asarray(jmxu.voxelize_windows_bilinear_t_mxu(
        *ev, interpret=True, **kw))
    cout = 2 * C if separate_pol else C
    assert got.shape == ref.shape == pal.shape == (NW * cout, H, W)
    assert np.abs(ref).max() > 0
    assert _rel(got, ref) <= EXACT_TOL
    assert _rel(got, pal) <= PALLAS_TOL
    if case != "dense":
        assert not got[:cout].any()
    if case == "single":  # dt = 0: all of the event's weight in bin 0
        assert abs(np.abs(got).sum() - 1.0) <= 1e-6


@pytest.mark.parametrize("normalize", [False, True])
def test_single_window_scatters_and_normalize(rng, normalize):
    """``voxel_grid_trilinear`` and ``voxel_grid_bilinear_t`` on one window
    and over leading batch dimensions, with and without the nonzero
    normalization (unbiased for DSEC, biased for DDD17)."""
    x, y, p, t, valid = _tri_events(rng, "negative")
    one = tuple(a[:700] for a in (x, y, p, t, valid))
    got = tvox.voxel_grid_trilinear(*_t(*one), num_bins=C, height=H,
                                    width=W, normalize=normalize).numpy()
    ref = np.asarray(jvox.voxel_grid_trilinear(
        *one, num_bins=C, height=H, width=W, normalize=normalize))
    assert got.shape == (C, H, W) and _rel(got, ref) <= EXACT_TOL
    batched = tvox.voxel_grid_trilinear(
        *_t(*(a.reshape(1, NW, -1) for a in (x, y, p, t, valid))),
        num_bins=C, height=H, width=W, normalize=normalize)
    assert batched.shape == (1, NW, C, H, W)
    np.testing.assert_array_equal(batched[0, 0].numpy(), got)

    xi, yi = np.trunc(x[:700]), np.trunc(y[:700])
    one = (xi, yi) + one[2:]
    for sep in (True, False):
        got = tvox.voxel_grid_bilinear_t(
            *_t(*one), num_bins=C, height=H, width=W, separate_pol=sep,
            normalize=normalize).numpy()
        ref = np.asarray(jvox.voxel_grid_bilinear_t(
            *one, num_bins=C, height=H, width=W, separate_pol=sep,
            normalize=normalize))
        assert got.shape == ref.shape and _rel(got, ref) <= EXACT_TOL


def test_event_histogram_matches_jax(rng):
    n = 900
    x = rng.integers(-2, W + 2, n).astype(np.float32)
    y = rng.integers(-2, H + 2, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    got = tvox.event_histogram(*_t(x, y, p, valid), height=H, width=W)
    ref = np.asarray(jvox.event_histogram(x, y, p, valid, height=H, width=W))
    assert got.shape == (2, H, W)
    np.testing.assert_array_equal(got.numpy(), ref)
    inb = valid & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    assert got.sum() == inb.sum()


def test_k6_wrapper_drops_fractional_negative_pixels_as_the_tpu_path(rng):
    """A JAX-side fact the port inherits: the TPU wrapper of K6 tests the
    frame on the coordinate, so an event at x or y in (-1, 0) is dropped,
    while the exact scatter truncates first and keeps it at pixel 0. The
    port's CPU path is the exact scatter; DDD17's pixels are integers, so
    no path meets the difference."""
    n = 256
    x = rng.integers(0, W, n).astype(np.float32)
    y = rng.integers(0, H, n).astype(np.float32)
    x[:4] = -0.5
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, n)).astype(np.float32)
    valid = np.ones(n, bool)
    kw = dict(num_windows=1, num_bins=C, height=H, width=W,
              separate_pol=False)
    got = tmxu.voxelize_windows_bilinear_t_mxu(*_t(x, y, p, t, valid),
                                               **kw).numpy()
    ref = np.asarray(jvox.voxel_grid_bilinear_t(
        x, y, p, t, valid, num_bins=C, height=H, width=W,
        separate_pol=False))
    pal = np.asarray(jmxu.voxelize_windows_bilinear_t_mxu(
        x, y, p, t, valid, interpret=True, **kw))
    assert _rel(got, ref) <= EXACT_TOL
    assert np.abs(got[:, :, 0]).sum() > np.abs(pal[:, :, 0]).sum()
    rest = np.ones(W, bool)
    rest[0] = False
    assert _rel(got[:, :, rest], pal[:, :, rest]) <= PALLAS_TOL


@pytest.mark.parametrize("kernel", ["K5", "K6"])
def test_prepared_events_route_padding_out_of_the_grid(rng, kernel):
    """What the CUDA kernels read: the binning passes (their plain
    versions, run on a CPU tensor) drop padding and keep each valid event
    once, with its coordinates and its time normalized per window into
    [0, C - 1]. K5 keeps every event with a corner in the frame and
    ``v = 2p - 1``; K6 keeps the events whose coordinates lie in the frame,
    as the JAX wrapper's in-frame test does, and the polarity with 0
    counted as -1."""
    x, y, p, t, valid = _tri_events(rng, "padding")
    kw = dict(num_windows=NW, num_bins=C, height=H, width=W)
    if kernel == "K5":
        counts, offsets, binned = tmxu.bin_events_trilinear(
            *_t(x, y, p, t, valid), **kw)
        keep = valid  # every valid event has a corner in the frame
    else:
        counts, offsets, binned = tmxu.bin_events_bilinear_t(
            *_t(x, y, p, t, valid), **kw)
        keep = valid & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    assert binned.shape == (NW * 700, 4) and binned.dtype == torch.float32
    assert int(counts.sum()) == int(keep.sum())
    assert not counts[:counts.numel() // NW].any()  # window 0: padding
    rows, _ = tmxu.binned_rows(counts, offsets)
    xs, ys, tn, v = binned[rows].unbind(-1)
    np.testing.assert_array_equal(np.sort(xs.numpy()), np.sort(x[keep]))
    if kernel == "K5":
        np.testing.assert_array_equal(v.abs().numpy(), 1.0)
        # the window's ends
        assert tn.min() == 0.0 and tn.max() == C - 1
    else:
        assert set(v.unique().tolist()) == {-1.0, 1.0}
        np.testing.assert_array_equal(
            np.sort(v.numpy()), np.sort(np.where(p[keep] == 0, -1.0,
                                                 p[keep])))
        assert tn.min() >= 0.0 and tn.max() <= C - 1


def test_wrappers_check_their_inputs():
    z = torch.zeros(12)
    v = torch.ones(12, dtype=torch.bool)
    kw = dict(num_windows=5, num_bins=C, height=H, width=W)
    for fn in (tmxu.voxelize_windows_trilinear_mxu,
               tmxu.voxelize_windows_bilinear_t_mxu):
        with pytest.raises(ValueError, match="equal windows"):
            fn(z, z, z, z, v, **kw)
        with pytest.raises(ValueError, match="bool"):
            fn(z, z, z, z, z, **{**kw, "num_windows": 2})
        with pytest.raises(ValueError, match="flat"):
            fn(z, z[:6], z, z, v, **{**kw, "num_windows": 2})
        m = torch.zeros(12, device="meta")
        with pytest.raises(ValueError, match="unsupported device"):
            fn(m, m, m, m, torch.ones(12, dtype=torch.bool, device="meta"),
               **{**kw, "num_windows": 2})
