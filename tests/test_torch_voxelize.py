"""The port's event wire and K1 voxelizer (openess_tpu_torch.ops.
voxelize_chunked, data.device_voxelize) against the JAX package.

- The numpy packer is bit-identical to the JAX package's.
- K1's plain version (what the wrapper runs on a CPU tensor) is an exact
  f32 splat: within 1e-4 of the grid max of the exact XLA scatter
  (``voxel_grid_trilinear``) on the same dequantized coordinates, and
  within 5e-3 of the Pallas kernel in interpret mode, whose one-hot
  matmuls round to bf16 (about 5e-3 of the grid max,
  ``openess_tpu/ops/voxelize_chunked.py`` docstring).
"""
import numpy as np
import pytest
import torch

from openess_tpu.ops import voxelize_windows_trilinear
from openess_tpu.ops import voxelize_chunked as jvc
from openess_tpu_torch.ops import voxelize_chunked as tvc
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

EXACT_TOL = 1e-4   # f32 splat vs the exact scatter, relative to grid max
PALLAS_TOL = 5e-3  # f32 splat vs the bf16-multiplying TPU kernel


def _events(rng, nw, k, H, W, lo=-1.5):
    x = rng.uniform(lo, W + 0.5, (nw, k)).astype(np.float32)
    y = rng.uniform(lo, H + 0.5, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (nw, k)), axis=1).astype(np.float32)
    valid = rng.random((nw, k)) < 0.9
    return x, y, p, t, valid


def _deq(a):
    """The packer's quantize-dequantize of a coordinate."""
    af = a.astype(np.float64)
    a0 = np.trunc(af)
    fq = np.clip(np.round((af - a0) * 32), -31, 31)
    return ((a0 * 32 + fq) / 32).astype(np.float32)


def _torch_wire(wire):
    return tuple(torch.from_numpy(np.asarray(a)) for a in wire)


def _plain(wire, C, H, W, normalize=False):
    return tvc.voxelize_chunked_trilinear(
        *_torch_wire(wire), num_bins=C, height=H, width=W, normalize=normalize,
    ).numpy()


def _interpret(wire, C, H, W, normalize=False):
    return np.asarray(jvc.voxelize_chunked_trilinear(
        *wire, num_bins=C, height=H, width=W, normalize=normalize,
        interpret=True,
    ))


def _scatter(x, y, p, t, valid, C, H, W):
    return np.stack([
        np.asarray(voxelize_windows_trilinear(
            _deq(x[w]), _deq(y[w]), p[w], t[w], valid[w],
            num_windows=1, num_bins=C, height=H, width=W,
        ))
        for w in range(x.shape[0])
    ]).reshape(x.shape[0], C, H, W)


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# ---------------------------------------------------------------------------
# packer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("integer_coords", [False, True])
def test_packer_bit_identical(rng, t16, integer_coords):
    H, W, k = 48, 130, 3000
    x, y, p, t, valid = _events(rng, 2, k, H, W, lo=-3.5)
    if integer_coords:
        x, y = np.round(x), np.round(y)
    valid[1] = False  # an empty window
    kw = dict(height=H, width=W, chunk=256, integer_coords=integer_coords,
              t16=t16)
    got = tvc.chunk_events_batch(x, y, p, t, valid, **kw)
    ref = jvc.chunk_events_batch(x, y, p, t, valid, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    for n in (got[0].shape[1], got[0].shape[1] + 5):
        for g, r in zip(tvc.pad_wire_chunks(got, n),
                        jvc.pad_wire_chunks(ref, n)):
            np.testing.assert_array_equal(g, r)


def test_packer_negative_fractional_coords():
    """Coordinates straddling every trunc-toward-zero class, incl. the
    negative fractional ones whose +1 corner carries a negative weight."""
    xs = np.array([-1.9999, -1.0001, -1.0, -0.9901, -0.5, -0.0001, 0.0,
                   0.9999, 94.9999, 95.0001, 96.4], np.float32)
    k = xs.size
    ys = np.array([-1.5, -0.25, 3.0, 7.3, -0.9, 15.99, 16.0, 31.5, 47.2,
                   -1.99, 0.5], np.float32)
    p = (np.arange(k) % 2).astype(np.float32)
    t = np.linspace(0.0, 1e5, k).astype(np.float32)
    for t16 in (False, True):
        kw = dict(height=48, width=96, chunk=64, t16=t16)
        got = tvc.chunk_events_window(xs, ys, p, t, np.ones(k, bool), **kw)
        ref = jvc.chunk_events_window(xs, ys, p, t, np.ones(k, bool), **kw)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    wire = tvc.chunk_events_batch(
        xs[None], ys[None], p[None], t[None], np.ones((1, k), bool),
        height=48, width=96, chunk=64,
    )
    got = _plain(wire, 3, 48, 96)
    ref = _scatter(xs[None], ys[None], p[None], t[None],
                   np.ones((1, k), bool), 3, 48, 96)
    assert (ref < 0).any() and (ref > 0).any()
    assert _rel(got, ref) < EXACT_TOL


# ---------------------------------------------------------------------------
# K1 plain version against the exact scatter and the Pallas kernel
# ---------------------------------------------------------------------------


def _case_uniform(rng):
    return _events(rng, 2, 4000, 48, 96), 5, 48, 96, 256


def _case_nondivisible(rng):
    return _events(rng, 2, 1500, 37, 130), 3, 37, 130, 128


def _case_dense_tile(rng):
    nw, k, W = 1, 2000, 128
    x = rng.uniform(0, W - 1, (nw, k)).astype(np.float32)
    y = rng.uniform(17, 30, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e5, (nw, k)), axis=1).astype(np.float32)
    return (x, y, p, t, np.ones((nw, k), bool)), 5, 64, W, 256


def _case_xtile_boundary(rng):
    nw, k, H, W = 1, 3000, 32, 300
    x = np.concatenate([
        rng.uniform(126.2, 129.8, (nw, k // 3)),
        rng.uniform(254.2, 257.8, (nw, k // 3)),
        rng.uniform(-1.5, W + 0.5, (nw, k - 2 * (k // 3))),
    ], axis=1).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (nw, k)), axis=1).astype(np.float32)
    return (x, y, p, t, np.ones((nw, k), bool)), 4, H, W, 256


def _case_empty_window(rng):
    ev = _events(rng, 2, 500, 32, 128)
    ev[4][0] = False
    return ev, 2, 32, 128, 128


CASES = {
    "uniform": _case_uniform,
    "nondivisible_dims": _case_nondivisible,
    "dense_single_tile": _case_dense_tile,
    "xtile_boundary": _case_xtile_boundary,
    "empty_window": _case_empty_window,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_k1_plain_matches_scatter_and_pallas(rng, case):
    (x, y, p, t, valid), C, H, W, chunk = CASES[case](rng)
    wire = tvc.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                  chunk=chunk)
    got = _plain(wire, C, H, W)
    assert got.shape == (x.shape[0], C, H, W) and got.dtype == np.float32
    assert _rel(got, _scatter(x, y, p, t, valid, C, H, W)) < EXACT_TOL
    assert _rel(got, _interpret(wire, C, H, W)) < PALLAS_TOL
    if case == "empty_window":
        assert np.abs(got[0]).max() == 0
    if case == "dense_single_tile":
        assert np.abs(got[0, :, :16]).max() == 0
        assert np.abs(got[0, :, 32:]).max() == 0


def test_k1_plain_t16_matches_f32_wire(rng):
    """v2 (uint16) time wire against the exact v1 wire: the t weight is
    linear in time, so each event's weight moves by at most (C-1)/131070;
    both are also held to the Pallas kernel on the same wire."""
    C, H, W = 5, 48, 96
    x, y, p, t, valid = _events(rng, 2, 4000, H, W)
    grids = {}
    for t16 in (False, True):
        wire = tvc.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                      chunk=256, t16=t16)
        grids[t16] = _plain(wire, C, H, W)
        assert _rel(grids[t16], _interpret(wire, C, H, W)) < PALLAS_TOL
    assert _rel(grids[True], grids[False]) < 1e-3


def test_k1_plain_normalize(rng):
    C, H, W = 3, 32, 128
    x, y, p, t, valid = _events(rng, 2, 1000, H, W)
    wire = tvc.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                  chunk=256)
    got = _plain(wire, C, H, W, normalize=True)
    for g in got:
        nz = g[g != 0]
        assert abs(nz.mean()) < 1e-5 and abs(nz.std(ddof=1) - 1.0) < 1e-5
    assert _rel(got, _interpret(wire, C, H, W, normalize=True)) < PALLAS_TOL


def test_k1_pad_wire_chunks_is_bit_identical(rng):
    H, W, C = 64, 96, 5
    x, y, p, t, valid = _events(rng, 1, 4000, H, W)
    wire = tvc.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                  t16=True)
    base = _plain(wire, C, H, W)
    padded = tvc.pad_wire_chunks(wire, wire[0].shape[1] + 3)
    np.testing.assert_array_equal(_plain(padded, C, H, W), base)


def test_k1_wrapper_checks_inputs(rng):
    """The wrapper raises on a bad wire and on a device it has no kernel
    for; it never falls back to another device."""
    x, y, p, t, valid = _events(rng, 1, 300, 32, 128)
    wire = _torch_wire(tvc.chunk_events_batch(x, y, p, t, valid, height=32,
                                              width=128, chunk=128))
    bad = (wire[0].to(torch.int32),) + wire[1:]
    with pytest.raises(ValueError, match="xq"):
        tvc.voxelize_chunked_trilinear(*bad, num_bins=2, height=32, width=128)
    meta = tuple(a.to("meta") for a in wire)
    with pytest.raises(ValueError, match="device"):
        tvc.voxelize_chunked_trilinear(*meta, num_bins=2, height=32, width=128)


# ---------------------------------------------------------------------------
# voxelize_wire: the port against the JAX package, synthetic and DSEC
# ---------------------------------------------------------------------------


def _settings(tmp_path, yaml_text):
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu_torch.config.settings import load_settings as tload

    path = tmp_path / "cfg.yaml"
    path.write_text(yaml_text)
    return jload(str(path)), tload(str(path))


@pytest.mark.parametrize("dataset", ["synthetic", "DSEC"])
def test_voxelize_wire_matches_jax(rng, tmp_path, dataset):
    from openess_tpu.data import device_voxelize as jdv
    from openess_tpu_torch.data import device_voxelize as tdv

    if dataset == "DSEC":
        with open("configs/pretrain/DSEC/frame2voxel_fcclip_slic.yaml") as f:
            text = f.read().replace("'bfloat16'", "'float32'")
        sh, sw, k, b, tw = 480, 640, 6000, 1, 2
    else:
        with open("configs/synthetic_sup_only.yaml") as f:
            text = f.read()
        sh, sw, k, b, tw = 64, 96, 2000, 2, 2
    js, ts = _settings(tmp_path, text)
    x, y, p, t, valid = _events(rng, b * tw, k, sh, sw)
    wire = tvc.chunk_events_batch(x, y, p, t, valid, height=sh, width=sw,
                                  t16=True)
    batch = tdv.pack_wire_batch(wire, b, tw)
    got = tdv.voxelize_wire(ts, tdv.upload_wire(batch, "cpu")).numpy()
    ref = np.asarray(jdv.voxelize_wire(js, batch))
    h, w = (int(v) for v in ts.img_size_b)
    assert got.shape == ref.shape == (b, tw, 5, h, w)
    assert got.dtype == np.float32
    assert _rel(got, ref) < PALLAS_TOL


@pytest.mark.parametrize("unbiased", [True, False])
def test_normalize_nonzero_matches_jax(rng, unbiased):
    from openess_tpu.ops.voxelize import normalize_nonzero as jnorm
    from openess_tpu_torch.ops.voxelize import normalize_nonzero as tnorm

    g = rng.normal(size=(3, 16, 20)).astype(np.float32)
    g[rng.random(g.shape) < 0.7] = 0.0
    got = tnorm(torch.from_numpy(g), unbiased=unbiased).numpy()
    np.testing.assert_allclose(got, np.asarray(jnorm(g, unbiased=unbiased)),
                               atol=1e-5)
    assert (got[g == 0] == 0).all()
    zero = torch.zeros(2, 4, 4)
    assert torch.equal(tnorm(zero, unbiased=unbiased), zero)


@pytest.mark.parametrize("unbiased", [True, False])
def test_normalize_nonzero_batched_is_per_window(rng, unbiased):
    """Over ``dims=(1, 2, 3)`` one call normalizes each window of a batch
    as JAX's ``normalize_nonzero`` does alone; an all-zero window stays
    zero beside the others."""
    from openess_tpu.ops.voxelize import normalize_nonzero as jnorm
    from openess_tpu_torch.ops.voxelize import normalize_nonzero as tnorm

    g = rng.normal(size=(4, 3, 16, 20)).astype(np.float32)
    g[rng.random(g.shape) < 0.7] = 0.0
    g[2] = 0.0
    got = tnorm(torch.from_numpy(g), unbiased=unbiased,
                dims=(1, 2, 3)).numpy()
    ref = np.stack([np.asarray(jnorm(w, unbiased=unbiased)) for w in g])
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert not got[2].any()


def test_upsample2x_nearest_matches_jax(rng):
    from openess_tpu.ops.resize import upsample2x_nearest as jup
    from openess_tpu_torch.ops.resize import upsample2x_nearest as tup

    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    np.testing.assert_array_equal(tup(torch.from_numpy(x)).numpy(),
                                  np.asarray(jup(x)))


def test_voxelize_wire_ddd17_is_not_ported_yet(rng):
    """The DDD17 wire used to raise here; it is voxelized now (K4, resize to
    352 columns, crop to 200 rows): ``tests/test_torch_voxelize_ddd17.py``
    holds it against the JAX package. DDD17 is read from disk now too
    (``tests/test_torch_datasets.py``); without a tree the factory says
    where it looked."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data import device_voxelize as tdv
    from openess_tpu_torch.data.loaders import build_datasets

    s = Settings(dataset_name_b="DDD17_events", img_size_b=(200, 352),
                 compute_dtype="float32")
    x, y, p, t, valid = _events(rng, 1, 100, 260, 346)
    wire = tvc.chunk_events_batch(x, y, p, t, valid, height=260, width=346,
                                  integer_coords=True)
    batch = tdv.upload_wire(tdv.pack_wire_batch(wire, 1, 1), "cpu")
    got = tdv.voxelize_wire(s, batch)
    assert got.shape == (1, 1, 5, 200, 352) and got.abs().max() > 0
    with pytest.raises(FileNotFoundError, match="DDD17.*dir0"):
        build_datasets(s, "cpu")
