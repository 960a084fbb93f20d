"""The DDD17 branch of the port's event path against the JAX package: the
``integer_coords`` packer, K4's plain version, ``voxelize_wire`` with the
346 -> 352 resize and the 60-row crop, and the event half of
``data/ddd17.py``.

Tolerances, relative to the grid's largest value:
- K4's plain version (what the wrapper runs on a CPU tensor, and what the
  CUDA kernel is held against on the card) against the exact XLA scatter
  ``voxel_grid_bilinear_t`` on the f32 time wire: 1e-6 (measured <= 6.5e-8:
  the same f32 weights, summed in another order).
- against the Pallas kernel in interpret mode: 1e-2 (measured <= 1.9e-3:
  the TPU kernel rounds the two time weights to bf16 for its matrix unit).
- the uint16 time wire against the f32 one: 1e-3 (each event's weight moves
  by at most (bins - 1) / 131070).
"""
import numpy as np
import pytest
import torch

from openess_tpu.ops import voxelize_chunked as jvc
from openess_tpu.ops.voxelize import voxel_grid_bilinear_t
from openess_tpu_torch.ops import voxelize_chunked as tvc
from test_torch_native import cores_share, jax_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("cores_share")

EXACT_TOL = 1e-6
PALLAS_TOL = 1e-2
HEIGHT, WIDTH = 260, 346


def _events(rng, nw, k, H, W, spill=3):
    """Integer-pixel events, some outside the frame, 90 % valid."""
    x = rng.integers(-spill, W + spill, (nw, k)).astype(np.float32)
    y = rng.integers(-spill, H + spill, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.integers(0, 10 ** 6, (nw, k)), axis=1).astype(np.float32)
    valid = rng.random((nw, k)) < 0.9
    return x, y, p, t, valid


def _pack(ev, H, W, **kw):
    kw.setdefault("chunk", 256)
    return tvc.chunk_events_batch(*ev, height=H, width=W,
                                  integer_coords=True, **kw)


def _plain(wire, C, H, W, **kw):
    return tvc.voxelize_chunked_bilinear_t(
        *(torch.from_numpy(np.asarray(a)) for a in wire),
        num_bins=C, height=H, width=W, **kw).numpy()


def _interpret(wire, C, H, W, **kw):
    return np.asarray(jvc.voxelize_chunked_bilinear_t(
        *wire, num_bins=C, height=H, width=W, interpret=True, **kw))


def _scatter(ev, C, H, W, **kw):
    x, y, p, t, valid = ev
    return np.stack([
        np.asarray(voxel_grid_bilinear_t(
            x[w], y[w], p[w], t[w], valid[w], num_bins=C, height=H, width=W,
            **kw))
        for w in range(x.shape[0])
    ])


def _rel(a, b):
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-9)


# ---------------------------------------------------------------------------
# packer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("t16", [False, True])
def test_integer_packer_bit_identical_at_the_ddd17_sensor(rng, t16):
    ev = _events(rng, 3, 3000, HEIGHT, WIDTH)
    ev[4][2] = False  # an empty window
    kw = dict(height=HEIGHT, width=WIDTH, integer_coords=True, t16=t16)
    got = tvc.chunk_events_batch(*ev, **kw)
    ref = jvc.chunk_events_batch(*ev, **kw)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)
    # trimmed to the bucketed batch maximum, as the JAX loaders ship it
    from openess_tpu.native import chunk_events_windows_host

    jax_native()
    x, y, p, t, valid = ev
    ref = chunk_events_windows_host(x, y, p, t.astype(np.float64), valid,
                                    **kw)
    for g, r in zip(tvc.trim_wire_chunks(got), ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_out_of_frame_events_are_dropped_without_moving_the_time_base():
    """The first and the last event in time lie outside the frame: they are
    not packed, but ``t_first`` and ``t_range`` still span them."""
    x = np.array([-1, 5, 7, 400], np.float32)
    y = np.array([3, 3, 300, 4], np.float32)
    p = np.array([1, 0, 1, 1], np.float32)
    t = np.array([100.0, 200.0, 300.0, 500.0])
    valid = np.ones(4, bool)
    kw = dict(height=HEIGHT, width=WIDTH, integer_coords=True, chunk=64)
    got = tvc.chunk_events_window(x, y, p, t, valid, **kw)
    ref = jvc.chunk_events_window(x, y, p, t, valid, **kw)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    xq, yq, pq, trel, counts, _, t_range = got
    assert counts.sum() == 1 and t_range == np.float32(400.0)
    assert (xq[0, 0], yq[0, 0], pq[0, 0], trel[0, 0]) == (5 * 32, 3 * 32, 0,
                                                          100.0)


# ---------------------------------------------------------------------------
# K4 plain version against the exact scatter and the Pallas kernel
# ---------------------------------------------------------------------------


def _case_sensor(rng):
    return _events(rng, 2, 3000, HEIGHT, WIDTH), 5, HEIGHT, WIDTH


def _case_small_partial_tile(rng):
    return _events(rng, 2, 1500, 37, 150), 3, 37, 150


def _case_empty_window(rng):
    ev = _events(rng, 2, 400, 32, 128)
    ev[4][0] = False
    return ev, 2, 32, 128


def _case_all_out_of_frame(rng):
    ev = _events(rng, 2, 300, 32, 128)
    ev[0][0] = 128 + ev[0][0] % 5  # window 0: every event right of the frame
    return ev, 4, 32, 128


def _case_one_event(rng):
    ev = _events(rng, 2, 50, 32, 128, spill=0)
    ev[4][0] = False
    ev[4][0, 17] = True  # t_range of one event: dt = 0 -> 1
    return ev, 5, 32, 128


CASES = {
    "ddd17_sensor": _case_sensor,
    "small_partial_tile": _case_small_partial_tile,
    "empty_window": _case_empty_window,
    "all_out_of_frame": _case_all_out_of_frame,
    "one_event": _case_one_event,
}


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_plain_matches_scatter_and_pallas(rng, case, separate_pol):
    ev, C, H, W = CASES[case](rng)
    wire = _pack(ev, H, W)
    kw = dict(separate_pol=separate_pol)
    got = _plain(wire, C, H, W, **kw)
    cout = 2 * C if separate_pol else C
    assert got.shape == (ev[0].shape[0], cout, H, W)
    assert got.dtype == np.float32
    assert _rel(got, _scatter(ev, C, H, W, **kw)) < EXACT_TOL
    assert _rel(got, _interpret(wire, C, H, W, **kw)) < PALLAS_TOL
    if separate_pol:
        assert (got >= 0).all()
    if case in ("empty_window", "all_out_of_frame"):
        assert np.abs(got[0]).max() == 0 and np.abs(got[1]).max() > 0
    if case == "one_event":
        # a single event at t = t_first: all of its weight in bin 0
        assert np.abs(got[0]).sum() == 1.0 and np.abs(got[0, C:]).sum() in (
            0.0, 1.0)


@pytest.mark.parametrize("separate_pol", [False, True])
def test_k4_plain_normalize_and_t16(rng, separate_pol):
    C, H, W = 5, 48, 200
    ev = _events(rng, 2, 2500, H, W)
    kw = dict(separate_pol=separate_pol)
    grids = {}
    for t16 in (False, True):
        wire = _pack(ev, H, W, t16=t16)
        grids[t16] = _plain(wire, C, H, W, **kw)
        assert _rel(grids[t16], _interpret(wire, C, H, W, **kw)) < PALLAS_TOL
        got = _plain(wire, C, H, W, normalize=True, **kw)
        for g in got:  # the DDD17 flavour: biased std over the nonzeros
            nz = g[g != 0]
            assert abs(nz.mean()) < 1e-5 and abs(nz.std() - 1.0) < 1e-5
        assert _rel(got, _interpret(wire, C, H, W, normalize=True, **kw)) \
            < PALLAS_TOL
    assert _rel(grids[False], _scatter(ev, C, H, W, **kw)) < EXACT_TOL
    assert _rel(grids[True], grids[False]) < 1e-3


def test_k4_malformed_descriptor_drops_events_as_the_tpu_kernel(rng):
    """An event outside its chunk's 16 x 128 block adds nothing, as the TPU
    kernel's one-hots give zero there; the descriptor clamps are the TPU
    wrapper's."""
    C, H, W = 3, 40, 300
    ev = _events(rng, 1, 800, H, W, spill=0)
    wire = list(_pack(ev, H, W))
    wire[5] = wire[5].copy()
    wire[5][0, 0] = 16 | (128 << 16)      # chunk 0 claims another block
    wire[5][0, 1] = 4000 | (4000 << 16)   # far outside: clamped
    got = _plain(wire, C, H, W, separate_pol=False)
    ref = _interpret(wire, C, H, W, separate_pol=False)
    assert _rel(got, ref) < PALLAS_TOL
    assert _rel(got, _scatter(ev, C, H, W, separate_pol=False)) > 0.1


def test_k4_wrapper_checks_inputs_and_counts_no_cpu_launch(rng):
    ev = _events(rng, 1, 300, 32, 128)
    wire = tuple(torch.from_numpy(a) for a in _pack(ev, 32, 128))
    before = tvc.voxelize_chunked_bilinear_t.launches
    tvc.voxelize_chunked_bilinear_t(*wire, num_bins=2, height=32, width=128)
    assert tvc.voxelize_chunked_bilinear_t.launches == before
    bad = wire[:2] + (wire[2].to(torch.int32),) + wire[3:]
    with pytest.raises(ValueError, match="pq"):
        tvc.voxelize_chunked_bilinear_t(*bad, num_bins=2, height=32,
                                        width=128)
    meta = tuple(a.to("meta") for a in wire)
    with pytest.raises(ValueError, match="device"):
        tvc.voxelize_chunked_bilinear_t(*meta, num_bins=2, height=32,
                                        width=128)


# ---------------------------------------------------------------------------
# voxelize_wire on DDD17 settings, and the event half of data/ddd17.py
# ---------------------------------------------------------------------------


def _ddd17_settings(**kw):
    from openess_tpu.config.settings import Settings as JSettings
    from openess_tpu_torch.config.settings import Settings

    base = dict(dataset_name_b="DDD17_events", img_size_b=(200, 346),
                semseg_num_classes=6, nr_events_window_b=400,
                nr_events_data_b=2, compute_dtype="float32",
                config_option="frame2voxel")
    js = JSettings()
    for k, v in {**base, **kw}.items():
        setattr(js, k, v)
    js.__post_init__()
    return js, Settings(**{**base, **kw})


@pytest.mark.parametrize("separate_pol,normalize",
                         [(False, False), (True, True)])
def test_voxelize_wire_ddd17_matches_jax(rng, separate_pol, normalize):
    from openess_tpu.data import device_voxelize as jdv
    from openess_tpu_torch.data import device_voxelize as tdv

    js, ts = _ddd17_settings(separate_pol_b=separate_pol,
                             normalize_event_b=normalize)
    b, tw = 2, 2
    ev = _events(rng, b * tw, 2500, HEIGHT, WIDTH)
    wire = tvc.trim_wire_chunks(tvc.chunk_events_batch(
        *ev, height=HEIGHT, width=WIDTH, integer_coords=True, t16=True))
    batch = tdv.pack_wire_batch(wire, b, tw)
    got = tdv.voxelize_wire(ts, tdv.upload_wire(batch, "cpu")).numpy()
    ref = np.asarray(jdv.voxelize_wire(js, batch))
    cout = 10 if separate_pol else 5
    assert tuple(ts.img_size_b) == (200, 352)
    assert got.shape == ref.shape == (b, tw, cout, 200, 352)
    assert got.dtype == np.float32
    assert _rel(got, ref) < PALLAS_TOL


def test_voxelize_wire_ddd17_bf16_and_resize_crop_order(rng):
    """The compute-dtype cast comes last, and cropping before the resize
    would give the same rows (the resize leaves the 260 rows in place)."""
    from openess_tpu_torch.data import device_voxelize as tdv
    from openess_tpu_torch.ops.resize import resize_bilinear

    _, ts = _ddd17_settings(compute_dtype="bfloat16")
    ev = _events(rng, 1, 2000, HEIGHT, WIDTH)
    wire = tvc.chunk_events_batch(*ev, height=HEIGHT, width=WIDTH,
                                  integer_coords=True, t16=True)
    batch = tdv.upload_wire(tdv.pack_wire_batch(wire, 1, 1), "cpu")
    got = tdv.voxelize_wire(ts, batch)
    assert got.dtype == torch.bfloat16 and got.shape == (1, 1, 5, 200, 352)
    grid = tvc.voxelize_chunked_bilinear_t(
        *(batch[k][0] for k in tdv.WIRE_KEYS), num_bins=5, height=HEIGHT,
        width=WIDTH, separate_pol=False)
    nhwc = resize_bilinear(grid[:, :, :200].permute(0, 2, 3, 1), out_h=200,
                           out_w=352, align_corners=True)
    assert torch.equal(got[0], nhwc.permute(0, 3, 1, 2).bfloat16())


@pytest.fixture(scope="module")
def ddd17_tree(tmp_path_factory):
    from openess_tpu.data.fixtures import write_ddd17_dir

    root = tmp_path_factory.mktemp("ddd17")
    rng = np.random.default_rng(9)
    for i in range(6):
        write_ddd17_dir(root / f"dir{i}", rng, n_imgs=3, n_events=6000)
    return root


@pytest.mark.parametrize("fixed_duration", [False, True])
def test_event_half_of_ddd17_matches_the_jax_dataset(ddd17_tree,
                                                     fixed_duration):
    """``extract_events`` + ``split_event_windows`` give ``load_events``,
    and ``wire_batch`` the ``ev_*`` keys of ``get_batch``, on the memmapped
    files of a small DDD17 tree."""
    from openess_tpu.data.ddd17 import DDD17Dataset as JDataset
    from openess_tpu_torch.data import ddd17 as tddd

    js, ts = _ddd17_settings(
        dataset_path_b=str(ddd17_tree), fixed_duration_b=fixed_duration,
        nr_events_data_b=3, nr_events_window_b=150 if fixed_duration else 100,
        superpixel_sources="", pl_sources="")
    ds = JDataset(js, split="train")
    idxs = [0, 4]
    windows = []
    for idx in idxs:
        fp = ds.files[idx]
        d = fp.rsplit("/segmentation_masks/", 1)[0]
        img_idx = int(fp.rsplit("_", 1)[-1].split(".")[0]) - 1
        t_ev, xyp = ds.event_data[d]
        ev = tddd.extract_events(
            t_ev, xyp, img_idx, ds.index_maps[d], fixed_duration,
            ts.nr_events_data_b * ts.nr_events_window_b)
        got = tddd.split_event_windows(
            ev, ts.nr_events_data_b, ts.nr_events_window_b, fixed_duration)
        for g, r in zip(got, ds.load_events(idx)):
            assert g.dtype == r.dtype and g.shape == r.shape
            np.testing.assert_array_equal(g, r)
        assert got[4].any()
        windows.append(got)
    ref = ds.get_batch(idxs)
    got = tddd.wire_batch(ts, windows)
    keys = [k for k in ref if k.startswith("ev_")]
    assert sorted(keys) == sorted(got)
    for k in keys:
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k])


def test_ddd17_host_paths_build_without_a_file():
    """What raised before the port had its host C++ now builds: the
    histogram and ``host_voxelize`` make ``event`` on the host from windows
    made in memory, equal to the JAX dataset's ``_host_voxelize`` on the
    same windows (the native grids, then the resize and the crop: within
    5e-5 of the max, the resize's f32 source positions); the dataset still
    names the recordings it lacks."""
    from openess_tpu.data.ddd17 import DDD17Dataset as JDDD17
    from openess_tpu_torch.data import ddd17 as tddd
    from openess_tpu_torch.data.loaders import build_datasets

    _, ts = _ddd17_settings()
    with pytest.raises(FileNotFoundError, match="dir0"):
        build_datasets(ts, "cpu")
    rng = np.random.default_rng(5)
    windows = []
    for _ in range(2):
        ev = np.stack([rng.integers(-2, WIDTH + 2, 900),
                       rng.integers(-2, HEIGHT + 2, 900),
                       np.sort(rng.integers(0, 10 ** 7, 900)),
                       rng.integers(0, 2, 900)], axis=1)
        windows.append(tddd.split_event_windows(ev, 2, 400))
    for kw in (dict(event_representation_b="histogram"),
               dict(wire_format="grid", normalize_event_b=True),
               dict(wire_format="grid", separate_pol_b=True)):
        js, ts = _ddd17_settings(**kw)
        jds = JDDD17.__new__(JDDD17)
        jds.s = js
        ref = jds._host_voxelize(windows)
        got = tddd.event_batch(ts, windows, "cpu")["event"]
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == ref.shape and got.shape[-2:] == (200, 352)
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 5e-5 * np.abs(ref).max()
    assert (tddd.HEIGHT, tddd.WIDTH, tddd.RESIZE_W, tddd.CROP_BOTTOM) == (
        260, 346, 352, 60)
