"""The port's host C++ (``openess_tpu_torch/native.py`` over
``csrc/event_ops.cpp``) against the JAX package's native library and
against the port's own plain versions, at small sizes.

- The packer: bit-identical to ``openess_tpu.native.chunk_events_windows_host``
  and to the port's numpy chunker (``ops/voxelize_chunked.py``, the
  ``[:, :nbc]`` slice) for every ``integer_coords`` x ``t16`` x
  ``n_threads`` x ``trim``; its recycled buffers keep the double-buffer
  contract and its fresh ones never alias its scratch.
- The windowed voxelizers and the histogram: within 1e-6 of the max of the
  JAX package's native output (measured 0: one source, one set of flags),
  within 1e-5 of the max of the port's exact scatters (``ops/voxelize.py``;
  measured below 1e-6: the same f32 weights summed in another order, the
  times normalized with another rounding).
- The build: a missing compiler raises, with no numpy fallback; a library
  is named by its source.

Two helpers here serve every port test module, which imports them:

- :func:`jax_native`: every comparison with the JAX package's native library
  goes through it. Under pytest-xdist each worker's import of
  ``openess_tpu.native`` runs ``make`` on the same gitignored
  ``libevent_ops.so``, and a worker that loads it while another is still
  linking it keeps the numpy fallbacks for its whole life.
- the ``cores_share`` fixture (``pytestmark`` of each module): torch's
  intra-op threads, and the ``OMP_NUM_THREADS`` of the subprocesses a test
  starts, are this worker's share of the cores while the module runs. Six
  workers that each spin 8 OpenMP threads on 8 cores slow a small conv
  loop about 57-fold (10 E2VID steps at 64x96: 86.4 s against 1.5 s with 2
  threads, five busy neighbours); one process alone keeps every core.
"""
import functools
import os
import time

import numpy as np
import pytest
import torch

from openess_tpu import native as jnative
from openess_tpu_torch import native as tnative
from openess_tpu_torch.ops import _build
from openess_tpu_torch.ops import voxelize as tvox
from openess_tpu_torch.ops.voxelize_chunked import (
    chunk_events_batch,
    num_chunks,
    trim_wire_chunks,
)

NATIVE_TOL = 1e-6
NATIVE_WAIT_S = 120
SCATTER_TOL = 1e-5
WIRE_NAMES = ("xq", "yq", "pq", "t_rel", "counts", "tile_r0", "t_range")
NW, K, H, W, CHUNK = 3, 5000, 72, 130, 256


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def jax_native():
    """``openess_tpu.native`` with its C++ library loaded in this process.

    When this worker's import lost the build race (another worker was still
    linking the library, so the load failed and the module fell back to
    numpy), the load is tried again, with ``make`` and all, until the
    other worker's build has finished; then it must hold. So a test that
    names the JAX package's C++ compares with it, never with the numpy
    fallback, whose rounding differs from the ``-ffast-math`` build."""
    deadline = time.monotonic() + NATIVE_WAIT_S
    while jnative._try_load() is None and time.monotonic() < deadline:
        time.sleep(0.5)
        jnative._load_attempted = False
    assert jnative._lib is not None, (
        "the JAX package's native library (native/libevent_ops.so) did not "
        "load")
    return jnative


@pytest.fixture(scope="module")
def cores_share():
    """Torch's intra-op threads, and ``OMP_NUM_THREADS`` for subprocesses,
    at this xdist worker's share of the cores (rounded up) while the module
    runs; restored after it. Outside xdist the share is every core."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    share = max(1, -(-(os.cpu_count() or 1) // workers))
    threads, omp = torch.get_num_threads(), os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(min(threads, share))
    os.environ["OMP_NUM_THREADS"] = str(torch.get_num_threads())
    yield
    torch.set_num_threads(threads)
    if omp is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = omp


pytestmark = pytest.mark.usefixtures("cores_share")


@pytest.fixture(autouse=True)
def _jax_native_loaded():
    jax_native()


@functools.cache
def _packer_events():
    rng = np.random.default_rng(3)
    x = rng.uniform(-1.5, W + 0.5, (NW, K)).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (NW, K)).astype(np.float32)
    p = rng.integers(0, 2, (NW, K)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (NW, K)), axis=1)
    valid = rng.random((NW, K)) < 0.9
    valid[1] = False  # an empty window
    return x, y, p, t, valid


@functools.cache
def _numpy_wire(integer_coords, t16):
    return chunk_events_batch(*_packer_events(), height=H, width=W,
                              chunk=CHUNK, integer_coords=integer_coords,
                              t16=t16)


@pytest.mark.parametrize("trim", [False, True, 9])
@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("integer_coords", [False, True])
def test_packer_matches_jax_native_and_numpy(integer_coords, t16, n_threads,
                                             trim):
    kw = dict(height=H, width=W, chunk=CHUNK, integer_coords=integer_coords,
              n_threads=n_threads, trim=trim, t16=t16)
    got = tnative.chunk_events_windows_host(*_packer_events(), **kw)
    ref = jnative.chunk_events_windows_host(*_packer_events(), **kw)
    plain = _numpy_wire(integer_coords, t16)
    cap = num_chunks(K, H, width=W, chunk=CHUNK)
    nbc = got[0].shape[1]
    used = int((plain[4] > 0).sum(axis=1).max())
    if trim is True:
        assert used <= nbc < cap
        for g, q in zip(got, trim_wire_chunks(plain)):
            np.testing.assert_array_equal(g, q)
    else:
        assert nbc == (cap if trim is False else trim)
    for name, g, r, q in zip(WIRE_NAMES, got, ref, plain):
        assert g.dtype == r.dtype == q.dtype, name
        assert g.shape == r.shape, name
        np.testing.assert_array_equal(g, r, err_msg=name)
        np.testing.assert_array_equal(
            g, q[:, :nbc] if q.ndim > 1 else q, err_msg=name)
    assert got[3].dtype == (np.uint16 if t16 else np.float32)


def _small_events(rng):
    HH, WW, KK = 48, 96, 3000
    return (rng.uniform(0, WW - 1, (2, KK)).astype(np.float32),
            rng.uniform(0, HH - 1, (2, KK)).astype(np.float32),
            rng.integers(0, 2, (2, KK)).astype(np.float32),
            np.sort(rng.uniform(0, 1e5, (2, KK)), axis=1),
            np.ones((2, KK), bool)), dict(height=HH, width=WW, chunk=256,
                                          n_threads=1)


def test_packer_reuse_buffers_double_buffered():
    """``reuse_buffers=True`` recycles the outputs per (thread, shape) in
    two turns: call N's arrays survive call N + 1, equal to a fresh run's,
    and the two live turns are distinct buffers."""
    rng = np.random.default_rng(4)
    (a1, kw), (a2, _) = _small_events(rng), _small_events(rng)
    w1 = tnative.chunk_events_windows_host(*a1, reuse_buffers=True, **kw)
    w2 = tnative.chunk_events_windows_host(*a2, reuse_buffers=True, **kw)
    f1 = tnative.chunk_events_windows_host(*a1, reuse_buffers=False, **kw)
    f2 = tnative.chunk_events_windows_host(*a2, reuse_buffers=False, **kw)
    for u, v in zip(w1, f1):
        np.testing.assert_array_equal(u, v)
    for u, v in zip(w2, f2):
        np.testing.assert_array_equal(u, v)
    assert not np.shares_memory(w1[0], w2[0])
    assert not np.shares_memory(w1[4], w2[4])


@pytest.mark.parametrize("trim", [False, True])
def test_packer_fresh_buffers_never_alias_scratch(trim):
    """``reuse_buffers=False`` returns arrays the caller owns: a retained
    batch is unchanged after two more calls on the same thread, which turn
    the scratch double buffer all the way round (at ``trim=False`` the
    ``[:, :nbc]`` slice of the scratch is the scratch itself)."""
    rng = np.random.default_rng(5)
    a0, kw = _small_events(rng)
    kw["trim"] = trim
    kept = tnative.chunk_events_windows_host(*a0, **kw)
    snap = [np.array(a, copy=True) for a in kept]
    tnative.chunk_events_windows_host(*_small_events(rng)[0], **kw)
    tnative.chunk_events_windows_host(*_small_events(rng)[0], **kw)
    for name, live, ref in zip(WIRE_NAMES, kept, snap):
        np.testing.assert_array_equal(live, ref, err_msg=name)


@pytest.mark.parametrize("trim", [False, True])
def test_packer_mixed_reuse_modes_keep_a_reused_batch(trim):
    """One thread mixes ``reuse_buffers=True`` and ``False``: the scratch
    group turns on every call, the wire group only on reuse calls, so after
    a reuse call, a fresh one and another reuse call the first batch's wire
    is still its own, and its ``counts`` and ``tile_r0`` must be too."""
    rng = np.random.default_rng(6)
    a0, kw = _small_events(rng)
    kw["trim"] = trim
    first = tnative.chunk_events_windows_host(*a0, reuse_buffers=True, **kw)
    snap = [np.array(a, copy=True) for a in first]
    tnative.chunk_events_windows_host(*_small_events(rng)[0],
                                      reuse_buffers=False, **kw)
    tnative.chunk_events_windows_host(*_small_events(rng)[0],
                                      reuse_buffers=True, **kw)
    for name, live, ref in zip(WIRE_NAMES, first, snap):
        np.testing.assert_array_equal(live, ref, err_msg=name)


def _grid_events(rng, integer, nw=4, k=2500, hh=40, ww=56):
    """Padded windows of ``k`` slots, a valid prefix of 0 (window 0) to
    ``k`` events; fractional coordinates reaching past the frame, or
    integer pixels partly outside it."""
    if integer:
        x = rng.integers(-2, ww + 2, (nw, k)).astype(np.float32)
        y = rng.integers(-2, hh + 2, (nw, k)).astype(np.float32)
        t = np.sort(rng.integers(0, 10 ** 6, (nw, k)), axis=1)
    else:
        x = rng.uniform(-1.5, ww + 0.5, (nw, k)).astype(np.float32)
        y = rng.uniform(-1.5, hh + 0.5, (nw, k)).astype(np.float32)
        t = 1e7 + np.sort(rng.uniform(0, 5e4, (nw, k)), axis=1)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    counts = np.array([0, 1, k // 2, k][:nw], np.int64)
    valid = np.arange(k)[None] < counts[:, None]
    t = np.where(valid, t, np.take_along_axis(
        t, np.maximum(counts - 1, 0)[:, None], axis=1)).astype(np.float32)
    return (x, y, p, t), valid, counts, hh, ww


def _scatter_norm(g, norm_mode):
    if norm_mode == 0:
        return g
    return tvox.normalize_nonzero(g, unbiased=norm_mode == 1,
                                  dims=(1, 2, 3))


@pytest.mark.parametrize("norm_mode", [0, 1, 2])
@pytest.mark.parametrize("layout", ["chw", "nhwc"])
def test_trilinear_windows_match_jax_native_and_scatter(layout, norm_mode):
    rng = np.random.default_rng(6)
    ev, valid, counts, hh, ww = _grid_events(rng, integer=False)
    kw = dict(crop_bottom=8, norm_mode=norm_mode, n_threads=2, layout=layout)
    got = tnative.voxelize_trilinear_windows_host(*ev, counts, 5, hh, ww, **kw)
    ref = jnative.voxelize_trilinear_windows_host(*ev, counts, 5, hh, ww,
                                                  **kw)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= NATIVE_TOL
    exact = _scatter_norm(tvox.voxel_grid_trilinear(
        *(torch.from_numpy(a) for a in ev), torch.from_numpy(valid),
        num_bins=5, height=hh, width=ww), norm_mode)[:, :, :hh - 8].numpy()
    if layout == "nhwc":
        exact = exact.transpose(0, 2, 3, 1)
    assert _rel(got, exact) <= SCATTER_TOL
    assert not got[0].any()  # an empty window stays zero


@pytest.mark.parametrize("separate_pol", [True, False])
@pytest.mark.parametrize("norm_mode", [0, 1, 2])
@pytest.mark.parametrize("layout", ["chw", "nhwc"])
def test_bilinear_t_windows_match_jax_native_and_scatter(layout, norm_mode,
                                                          separate_pol):
    rng = np.random.default_rng(7)
    ev, valid, counts, hh, ww = _grid_events(rng, integer=True)
    kw = dict(separate_pol=separate_pol, norm_mode=norm_mode, n_threads=3,
              layout=layout)
    got = tnative.voxelize_bilinear_t_windows_host(*ev, counts, 5, hh, ww,
                                                   **kw)
    ref = jnative.voxelize_bilinear_t_windows_host(*ev, counts, 5, hh, ww,
                                                   **kw)
    assert got.shape == ref.shape and got.dtype == np.float32
    assert _rel(got, ref) <= NATIVE_TOL
    exact = _scatter_norm(tvox.voxel_grid_bilinear_t(
        *(torch.from_numpy(a) for a in ev), torch.from_numpy(valid),
        num_bins=5, height=hh, width=ww, separate_pol=separate_pol),
        norm_mode).numpy()
    if layout == "nhwc":
        exact = exact.transpose(0, 2, 3, 1)
    assert _rel(got, exact) <= SCATTER_TOL


@pytest.mark.parametrize("norm_mode", [0, 1, 2])
def test_histogram_windows_match_jax_native_and_scatter(norm_mode):
    """Window 1 holds one event: its nonzero entries have no spread, and
    the host normalization (the JAX package's, here as there) leaves such
    a window as it is, where ``ops/voxelize.normalize_nonzero`` (the
    device path's, as the JAX package's) subtracts the mean and zeroes
    it. The scatter is held to the other windows, window 1 to the raw
    counts."""
    rng = np.random.default_rng(8)
    ev, valid, counts, hh, ww = _grid_events(rng, integer=False)
    x, y, p, _ = ev
    got = tnative.event_histogram_windows_host(
        x, y, p, counts, hh, ww, norm_mode=norm_mode, n_threads=3)
    ref = jnative.event_histogram_windows_host(
        x, y, p, counts, hh, ww, norm_mode=norm_mode, n_threads=3)
    assert got.shape == (4, 2, hh, ww) and got.dtype == np.float32
    assert _rel(got, ref) <= NATIVE_TOL
    counts_img = tvox.event_histogram(
        *(torch.from_numpy(a) for a in (x, y, p, valid)), height=hh,
        width=ww)
    exact = _scatter_norm(counts_img, norm_mode).numpy()
    keep = [0, 2, 3]
    assert _rel(got[keep], exact[keep]) <= SCATTER_TOL
    np.testing.assert_array_equal(got[1], counts_img[1].numpy())
    if norm_mode == 0:  # counts: exact
        np.testing.assert_array_equal(got, exact)
    else:
        assert not exact[1].any()


def test_single_stream_functions_match_jax_native():
    """The one-stream entries: the trilinear grid on one thread and split
    across four (private grids, summed), the bilinear-in-time grid in both
    polarity modes and the histogram."""
    rng = np.random.default_rng(9)
    n, hh, ww = 70_000, 24, 40
    x = rng.uniform(-1, ww, n).astype(np.float32)
    y = rng.uniform(-1, hh, n).astype(np.float32)
    p = rng.integers(0, 2, n).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e5, n)).astype(np.float32)
    one = tnative.voxelize_trilinear_host(x, y, p, t, 5, hh, ww)
    assert _rel(one, jnative.voxelize_trilinear_host(x, y, p, t, 5, hh,
                                                     ww)) <= NATIVE_TOL
    four = tnative.voxelize_trilinear_host(x, y, p, t, 5, hh, ww,
                                           n_threads=4)
    assert _rel(four, jnative.voxelize_trilinear_host(
        x, y, p, t, 5, hh, ww, n_threads=4)) <= NATIVE_TOL
    assert _rel(four, one) <= SCATTER_TOL
    xi, yi = x.astype(np.int64), y.astype(np.int64)
    ti = np.sort(rng.integers(0, 10 ** 6, n))
    for sep in (True, False):
        got = tnative.voxelize_bilinear_t_host(xi, yi, p, ti, 5, hh, ww, sep)
        ref = jnative.voxelize_bilinear_t_host(xi, yi, p, ti, 5, hh, ww, sep)
        assert got.shape == ref.shape and _rel(got, ref) <= NATIVE_TOL
    np.testing.assert_array_equal(
        tnative.event_histogram_host(xi, yi, p, hh, ww),
        jnative.event_histogram_host(xi, yi, p, hh, ww))


def test_packer_buffers_are_per_thread():
    """More threads than cores pack their own windows with recycled
    buffers at once, with the interpreter switching threads as often as it
    can: each result equals the same windows packed alone, so no thread's
    double buffer is another's."""
    import sys
    import threading

    rng = np.random.default_rng(11)
    jobs = [_small_events(rng) for _ in range(12)]
    alone = [tnative.chunk_events_windows_host(*ev, **kw) for ev, kw in jobs]
    results, errors = [None] * len(jobs), []

    def run(i):
        try:
            ev, kw = jobs[i]
            for _ in range(3):
                out = tnative.chunk_events_windows_host(
                    *ev, reuse_buffers=True, **kw)
                results[i] = [np.array(a, copy=True) for a in out]
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(jobs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for got, ref in zip(results, alone):
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)


def test_inputs_are_checked_before_the_native_call():
    rng = np.random.default_rng(12)
    (x, y, p, t, v), kw = _small_events(rng)
    with pytest.raises(ValueError, match="one \\[n_win, K\\] shape"):
        tnative.chunk_events_windows_host(x, y[:, :-1], p, t, v, **kw)
    with pytest.raises(ValueError, match="window counts"):
        tnative.voxelize_trilinear_windows_host(
            x, y, p, t, np.array([10, x.shape[1] + 1]), 5, 48, 96)


def test_library_binds_once_under_concurrent_first_calls(monkeypatch):
    """Eight threads make their first call at once, as the loader's
    workers do: one of them binds the library's argument types, once, and
    every thread gets that library; then each packs a batch, equal to the
    batch packed on one thread. ctypes reads a function's converters without
    holding them, so binding ``argtypes`` again while another thread calls
    that function frees the converters in use (``ArgumentError ... 'dict'
    object is not callable`` from a raw-wire loader worker)."""
    import threading
    import time

    real, binds = tnative._bind_library, []

    def slow_bind():
        binds.append(threading.get_ident())
        time.sleep(0.2)  # every other thread arrives while this one binds
        return real()

    monkeypatch.setattr(tnative, "_LIBRARY", None)
    monkeypatch.setattr(tnative, "_bind_library", slow_bind)
    events, kw = _small_events(np.random.default_rng(13))
    ref = tnative.chunk_events_windows_host(*events, **kw)
    monkeypatch.setattr(tnative, "_LIBRARY", None)
    binds.clear()
    start, libs, wires, errors = threading.Barrier(8), [], [], []

    def work():
        try:
            start.wait()
            libs.append(tnative.library())
            wires.append(tnative.chunk_events_windows_host(*events, **kw))
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(binds) == 1 and len(libs) == 8
    assert all(lib is libs[0] for lib in libs)
    for wire in wires:
        for a, b in zip(wire, ref):
            np.testing.assert_array_equal(a, b)


@pytest.fixture
def fresh_build(tmp_path, monkeypatch):
    """An empty build directory and no library loaded in this process."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tnative, "_LIBRARY", None)
    yield tmp_path / "_build"


def test_missing_compiler_raises_and_nothing_falls_back(fresh_build,
                                                        monkeypatch,
                                                        tmp_path):
    rng = np.random.default_rng(10)
    events, kw = _small_events(rng)
    monkeypatch.setenv("CXX", str(tmp_path / "nowhere" / "c++"))
    with pytest.raises(RuntimeError, match="names no compiler"):
        tnative.chunk_events_windows_host(*events, **kw)
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("PATH", str(tmp_path / "nowhere"))
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        tnative.voxelize_trilinear_windows_host(
            *events[:4], np.array([10, 10]), 5, 48, 96)
    assert not fresh_build.exists() or not list(fresh_build.iterdir())


def test_failed_build_raises_with_the_compiler_error(fresh_build,
                                                     monkeypatch, tmp_path):
    """A source the compiler refuses: the error names the compiler and
    carries its stderr; no library is left to be loaded later."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "event_ops.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    with pytest.raises(RuntimeError, match="failed on event_ops.cpp"):
        tnative.library()
    assert not list(fresh_build.glob("*.so"))


def test_library_is_named_by_its_source(monkeypatch, tmp_path):
    """An edited source gets another library path, so a library built from
    an older source is never loaded."""
    path = _build.host_library_path("event_ops.cpp")
    assert path.startswith(_build.BUILD_DIR) and "_host_" in path
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    with open(f"{_build.CSRC_DIR}/event_ops.cpp") as f:
        (csrc / "event_ops.cpp").write_text(f.read() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    assert _build.host_library_path("event_ops.cpp") != path
