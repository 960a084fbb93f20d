"""The port's datasets read from disk against the JAX package's, on the
replica trees of ``openess_tpu/data/fixtures.py`` (DSEC: two windows of 500
events; DDD17: two windows of 400), the synthetic grid wire, the dataset
factory and one grid-wire train step.

Tolerances:
- side channels (frames, labels, pseudo-labels, superpixels, SAM features)
  and the raw-wire ``ev_*`` keys: bit-identical;
- the grid wire's ``event`` (``host_voxelize: false``; the JAX package
  takes its exact XLA scatter on the CPU, the port K5's or K6's plain
  version): 1e-5 of the grid's largest value (measured 0 to 1.3e-7). On
  DDD17 this holds for the grids at the sensor size; after the 346 -> 352
  resize the bound is 5e-5 (measured 1.3e-5 to 1.5e-5): ``F.interpolate``
  computes its source positions in f32, the JAX package in f64, which
  moves them by up to 2e-5 of a pixel (the raw wire's ``voxelize_wire``
  resizes the same way);
- the grid-wire linear-probe step against ``StepBuilder`` on the same
  synthetic samples, each side on its own grid batch: loss dict 1e-5
  relative, the ``linear_probe`` gradients 3e-5 of the tensor's max and
  the updated parameters 1e-6 where ``|g|`` is above 1e-4 of the largest
  gradient, as ``tests/test_torch_finetune.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu.data.fixtures import write_ddd17_dir, write_dsec_sequence
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data import ddd17 as tddd
from openess_tpu_torch.data import dsec as tdsec
from openess_tpu_torch.data.loaders import build_datasets
from openess_tpu_torch.training.trainer import to_device
from test_torch_native import cores_share, jax_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("cores_share")

GRID_TOL = 1e-5
RESIZED_TOL = 5e-5
LOSS_REL = 1e-5
PROBE_GRAD_REL = 3e-5
UPDATE_ABS = 1e-6


def settings_pair(**kw):
    """The same settings in both packages."""
    js = JSettings()
    for k, v in kw.items():
        setattr(js, k, v)
    js.__post_init__()
    return js, Settings(**kw)


def _rel(a, b):
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _assert_batches_match(jb, tb, grid_tol=GRID_TOL):
    assert sorted(jb) == sorted(tb)
    for k in jb:
        got = tb[k].numpy() if isinstance(tb[k], torch.Tensor) else tb[k]
        assert got.shape == jb[k].shape, k
        if k == "event":
            assert np.abs(jb[k]).max() > 0
            assert _rel(got, jb[k]) <= grid_tol
        else:
            assert got.dtype == jb[k].dtype, k
            np.testing.assert_array_equal(got, jb[k], k)


# ---------------------------------------------------------------------------
# DSEC
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dsec_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("dsec")
    rng = np.random.default_rng(7)
    write_dsec_sequence(root / "train" / "zurich_city_00_a", rng)
    write_dsec_sequence(root / "test" / "zurich_city_13_a", rng)
    return root


def dsec_settings(root, **kw):
    return settings_pair(**{**dict(
        dataset_name_b="DSEC_events", dataset_path_b=str(root),
        config_option="recon2voxel", nr_events_data_b=2,
        nr_events_window_b=500, pl_sources="pl_fcclip_rgb",
        superpixel_sources="sp_sam_rgb", wire_format="grid",
        host_voxelize=False), **kw})


@pytest.mark.parametrize("kw", [
    dict(),
    dict(config_option="frame2voxel", normalize_event_b=True),
    dict(fixed_duration_b=True, delta_t_per_data_b=20),
    dict(wire_format="raw_events"),
    dict(wire_format="raw_events", wire_t16=False),
])
def test_dsec_batch_matches_jax(dsec_root, kw):
    from openess_tpu.data.dsec import DSECDataset as JDSEC

    js, ts = dsec_settings(dsec_root, **kw)
    jds, tds = JDSEC(js, "train"), tdsec.DSECDataset(ts, "train", "cpu")
    assert len(tds) == len(jds) == 10  # 16 labels less the warm-up trim
    for idx in (0, 7):
        for g, r in zip(tds.sequences[0].load_events(idx),
                        jds.sequences[0].load_events(idx)):
            assert g.dtype == r.dtype
            np.testing.assert_array_equal(g, r)
    jb, tb = jds.get_batch([0, 7]), tds.get_batch([0, 7])
    _assert_batches_match(jb, tb)
    if ts.wire_format == "grid":
        assert tuple(tb["event"].shape) == (2, 2, 5, 440, 640)
        assert tb["event"].dtype == torch.float32
    tds.close()


@pytest.mark.parametrize("kw", [
    dict(host_voxelize=True),
    dict(host_voxelize=True, config_option="frame2voxel",
         normalize_event_b=True),
    dict(event_representation_b="histogram"),
    dict(event_representation_b="histogram", wire_format="raw_events",
         normalize_event_b=True),
])
def test_dsec_host_event_batch_matches_jax(dsec_root, kw):
    """The event keys the port builds with its host C++ on a DSEC tree (the
    grid voxelized on the host, the histogram, which wins over either wire)
    against the JAX dataset's, made by the JAX package's native library
    from the same source: within 1e-6 of the max (measured 0)."""
    from openess_tpu.data.dsec import DSECDataset as JDSEC

    jax_native()
    js, ts = dsec_settings(dsec_root, **kw)
    jds, tds = JDSEC(js, "train"), tdsec.DSECDataset(ts, "train", "cpu")
    jb, tb = jds.get_batch([0, 7]), tds.get_batch([0, 7])
    _assert_batches_match(jb, tb, grid_tol=1e-6)
    c = 2 if ts.event_representation_b == "histogram" else 5
    assert tb["event"].shape == (2, 2, c, 440, 640)
    assert tb["event"].dtype == np.float32
    assert not any(k.startswith("ev_") for k in tb)
    tds.close()


def test_dsec_splits_and_skip_ratio(dsec_root):
    from openess_tpu.data.dsec import DSECDataset as JDSEC

    js, ts = dsec_settings(dsec_root, config_option="frame2recon",
                           superpixel_sources="")
    val = tdsec.DSECDataset(ts, "val", "cpu")
    assert len(val) == len(JDSEC(js, "val")) == 6  # skip 2: 10 // 2 + 1
    jb, tb = JDSEC(js, "val").get_batch([0]), val.get_batch([0])
    _assert_batches_match(jb, tb)
    assert "event" not in tb and (tb["pl"] == 1).all()
    js, ts = dsec_settings(dsec_root, skip_ratio=3)
    assert len(tdsec.DSECDataset(ts, "train", "cpu")) == len(
        JDSEC(js, "train")) == 4
    with pytest.raises(FileNotFoundError):
        tdsec.DSECDataset(
            dataclasses.replace(ts, dataset_path_b=str(dsec_root / "none")),
            "train", "cpu")


def test_dsec_slicer_matches_jax(dsec_root):
    import h5py

    from openess_tpu.data.event_slicer import EventSlicer as JSlicer
    from openess_tpu_torch.data.event_slicer import EventSlicer

    path = dsec_root / "train" / "zurich_city_00_a" / "events" / "left"
    with h5py.File(path / "events.h5", "r") as f:
        got, ref = EventSlicer(f), JSlicer(f)
        assert got.get_final_time_us() == ref.get_final_time_us()
        a, b = got.get_events(500_000, 700_000), ref.get_events(500_000,
                                                                700_000)
        assert a["t"].min() >= 500_000 and a["t"].max() < 700_000
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        a, b = (s.get_events_fixed_num(700_000, 1000) for s in (got, ref))
        assert a["t"].size == 1000 and a["t"].max() < 700_000
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
        assert got.get_events(10 ** 9, 10 ** 9 + 1) is None


def test_dsec_event_batch_is_driven_without_a_file(rng):
    """``event_batch`` turns padded windows into the batch's event keys with
    no file and no ``h5py``: the grid wire (K5's plain version) against the
    JAX package's device voxelizer, and the host branches (the grid
    voxelized on the host, the histogram) against the JAX package's native
    calls on the same windows, within 1e-6 of the max (measured 0: one
    source, one set of flags)."""
    from openess_tpu.data.dsec import _device_voxelizer
    from openess_tpu.native import (
        event_histogram_windows_host,
        voxelize_trilinear_windows_host,
    )

    jax_native()

    T, K = 3, 400
    windows = []
    for _ in range(2):
        x = rng.uniform(-1, 640, (T, K)).astype(np.float32)
        y = rng.uniform(-1, 480, (T, K)).astype(np.float32)
        p = rng.integers(0, 2, (T, K)).astype(np.float32)
        # absolute us late in a recording: the f32 cast rounds them to 8 us
        t = 1e8 + np.sort(rng.uniform(0, 5e4, (T, K)), axis=1)
        valid = rng.random((T, K)) < 0.95
        windows.append((x, y, p, t, valid))
    js, ts = settings_pair(nr_events_data_b=T, wire_format="grid",
                           host_voxelize=False)
    got = tdsec.event_batch(ts, windows, "cpu")["event"]
    stacked = [np.stack([w[i] for w in windows]).reshape(2, -1)
               for i in range(5)]
    ref = np.asarray(_device_voxelizer(T, 5, 480, 640, False, 40)(*stacked))
    assert tuple(got.shape) == ref.shape == (2, T, 5, 440, 640)
    assert _rel(got.numpy(), ref) <= GRID_TOL
    flat = [a.reshape(2 * T, K) for a in stacked]
    counts = flat[4].sum(axis=1)
    for kw, ref in (
        (dict(host_voxelize=True), voxelize_trilinear_windows_host(
            *flat[:4], counts, 5, 480, 640, crop_bottom=40, norm_mode=1,
            layout="chw").reshape(2, T, 5, 440, 640)),
        (dict(event_representation_b="histogram"),
         event_histogram_windows_host(*flat[:3], counts, 480, 640,
                                      norm_mode=1)[:, :, :440]
         .reshape(2, T, 2, 440, 640)),
    ):
        got = tdsec.event_batch(dataclasses.replace(
            ts, normalize_event_b=True, **kw), windows, "cpu")["event"]
        assert isinstance(got, np.ndarray) and got.shape == ref.shape
        assert np.abs(ref).max() > 0
        assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_grid_wire_casts_times_to_f32_before_the_window_start(rng):
    """A JAX-side fact the port keeps: the grid wire's device voxelizer
    gets DSEC's float64 microseconds and casts them to f32 (at the jit
    boundary in the JAX package, on the host in the port) before each
    window's first time is subtracted. Two minutes into a recording f32
    holds times to 8 us, so in a 5 ms window the normalized times move by
    up to 0.008 of a bin: the grid differs from one made of f64 offsets by
    about 3e-3 of its max, as much as the TPU kernel's bf16 operands."""
    T, K = 2, 20000
    x = rng.uniform(-1, 640, (1, T, K)).astype(np.float32)
    y = rng.uniform(-1, 480, (1, T, K)).astype(np.float32)
    p = rng.integers(0, 2, (1, T, K)).astype(np.float32)
    t = 1.2e8 + np.sort(rng.integers(0, 5000, (1, T, K)), axis=2).astype(
        np.float64)
    valid = np.ones((1, T, K), bool)
    _, ts = settings_pair(nr_events_data_b=T, wire_format="grid",
                          host_voxelize=False)
    got = tdsec.voxelize_grid(ts, x, y, p, t, valid, "cpu")
    same = tdsec.voxelize_grid(ts, x, y, p, t.astype(np.float32), valid,
                               "cpu")
    f64 = tdsec.voxelize_grid(ts, x, y, p, t - t[..., :1], valid, "cpu")
    assert torch.equal(got, same)
    assert 1e-3 <= _rel(got.numpy(), f64.numpy()) <= 1e-2


# ---------------------------------------------------------------------------
# DDD17
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ddd17_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddd17")
    rng = np.random.default_rng(9)
    for i in range(6):
        write_ddd17_dir(root / f"dir{i}", rng, n_imgs=3, n_events=6000)
    return root


def ddd17_settings(root, **kw):
    return settings_pair(**{**dict(
        dataset_name_b="DDD17_events", dataset_path_b=str(root),
        img_size_b=(200, 352), config_option="recon2voxel", semseg_num_classes=6,
        nr_events_data_b=2, nr_events_window_b=400,
        pl_sources="pl_fcclip_rgb", superpixel_sources="sp_sam_rgb",
        wire_format="grid", host_voxelize=False), **kw})


@pytest.mark.parametrize("kw", [
    dict(),
    dict(separate_pol_b=True, normalize_event_b=True,
         config_option="frame2voxel"),
    dict(normalize_event_b=True, fixed_duration_b=True),
    dict(wire_format="raw_events"),
])
def test_ddd17_batch_matches_jax(ddd17_root, kw):
    """Masks 0 and 4 sit in dir0 and dir3: both sides of the path quirk.
    The grids are held at the sensor size (K6's plain version on the
    loaded windows) and after the resize and crop."""
    from openess_tpu.data.ddd17 import DDD17Dataset as JDDD17
    from openess_tpu.ops.voxelize import voxel_grid_bilinear_t as jbil
    from openess_tpu_torch.ops.voxelize_mxu import (
        voxelize_windows_bilinear_t_mxu,
    )

    js, ts = ddd17_settings(ddd17_root, **kw)
    jds, tds = JDDD17(js, "train"), tddd.DDD17Dataset(ts, "train", "cpu")
    assert tds.files == jds.files and len(tds) == 15
    jb, tb = jds.get_batch([0, 4]), tds.get_batch([0, 4])
    _assert_batches_match(jb, tb, grid_tol=RESIZED_TOL)
    if ts.wire_format == "grid":
        cout = 10 if ts.separate_pol_b else 5
        assert tuple(tb["event"].shape) == (2, 2, cout, 200, 352)
        for idx in (0, 4):
            windows = tds.load_events(idx)
            for g, r in zip(windows, jds.load_events(idx)):
                np.testing.assert_array_equal(g, r)
            kw6 = dict(num_bins=5, height=260, width=346,
                       separate_pol=ts.separate_pol_b)
            got = voxelize_windows_bilinear_t_mxu(
                *(torch.from_numpy(a.reshape(-1)) for a in windows),
                num_windows=2, **kw6).numpy()
            ref = np.stack([np.asarray(jbil(*(a[i] for a in windows), **kw6))
                            for i in range(2)]).reshape(got.shape)
            assert np.abs(ref).max() > 0
            assert _rel(got, ref) <= GRID_TOL


@pytest.mark.parametrize("kw", [
    dict(host_voxelize=True),
    dict(host_voxelize=True, separate_pol_b=True, normalize_event_b=True,
         config_option="frame2voxel"),
    dict(event_representation_b="histogram"),
    dict(event_representation_b="histogram", wire_format="raw_events",
         normalize_event_b=True),
])
def test_ddd17_host_event_batch_matches_jax(ddd17_root, kw):
    """The event keys the port builds with its host C++ on a DDD17 tree
    against the JAX dataset's: the native grids or histograms at the
    sensor size within 1e-6 of the max (measured 0), and the batch after
    the 346 -> 352 resize and the crop within ``RESIZED_TOL`` (the resize
    computes its source positions in f32 here, in f64 in the JAX
    package)."""
    from openess_tpu.data.ddd17 import DDD17Dataset as JDDD17
    from openess_tpu.native import (
        event_histogram_windows_host as jhist,
        voxelize_bilinear_t_windows_host as jbil,
    )
    from openess_tpu_torch import native as tnative

    jax_native()
    js, ts = ddd17_settings(ddd17_root, **kw)
    jds, tds = JDDD17(js, "train"), tddd.DDD17Dataset(ts, "train", "cpu")
    jb, tb = jds.get_batch([0, 4]), tds.get_batch([0, 4])
    _assert_batches_match(jb, tb, grid_tol=RESIZED_TOL)
    hist = ts.event_representation_b == "histogram"
    c = 2 if hist else (10 if ts.separate_pol_b else 5)
    assert tb["event"].shape == (2, 2, c, 200, 352)
    assert not any(k.startswith("ev_") for k in tb)
    x, y, p, t, valid = (np.stack([tds.load_events(i)[j] for i in (0, 4)])
                         .reshape(4, -1) for j in range(5))
    norm = 2 if ts.normalize_event_b else 0
    if hist:
        args = (x, y, p, valid.sum(1), 260, 346)
        got = tnative.event_histogram_windows_host(*args, norm_mode=norm)
        ref = jhist(*args, norm_mode=norm)
    else:
        args = (x, y, p, t, valid.sum(1), 5, 260, 346)
        kw_ = dict(separate_pol=ts.separate_pol_b, norm_mode=norm)
        got = tnative.voxelize_bilinear_t_windows_host(*args, **kw_)
        ref = jbil(*args, **kw_)
    assert np.abs(ref).max() > 0
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_ddd17_splits_skip_ratio_and_side_channels(ddd17_root):
    from openess_tpu.data.ddd17 import DDD17Dataset as JDDD17

    js, ts = ddd17_settings(ddd17_root, config_option="frame2recon")
    val = tddd.DDD17Dataset(ts, "valid", "cpu")
    assert val.dirs == [str(ddd17_root / "dir1")] and len(val) == 3
    assert val.get_batch([0])["frame"].shape == (1, 200, 352, 3)
    assert (val.get_batch([1])["pl"] == 1).all()  # no pseudo-labels
    js, ts = ddd17_settings(ddd17_root, skip_ratio=2)
    assert len(tddd.DDD17Dataset(ts, "train", "cpu")) == len(
        JDDD17(js, "train")) == 10  # 5 dirs x (3 // 2 + 1)
    js, ts = ddd17_settings(ddd17_root, superpixel_sources="",
                            pl_sources="", config_option="frame2recon")
    _assert_batches_match(JDDD17(js, "valid").get_batch([2]),
                          tddd.DDD17Dataset(ts, "valid", "cpu")
                          .get_batch([2]))
    with pytest.raises(FileNotFoundError):
        tddd.DDD17Dataset(
            dataclasses.replace(ts, dataset_path_b=str(ddd17_root / "x")),
            "train", "cpu")


# ---------------------------------------------------------------------------
# synthetic grid wire and the factory
# ---------------------------------------------------------------------------


def test_synthetic_voxelized_batch_matches_jax():
    from openess_tpu.data.synthetic import SyntheticESS as JSynthetic
    from openess_tpu_torch.data.synthetic import SyntheticESS

    kw = dict(num_samples=3, height=32, width=48, num_windows=2)
    jb = JSynthetic(**kw).voxelized_batch([2, 0], num_bins=4)
    tb = SyntheticESS(**kw).voxelized_batch([2, 0], num_bins=4)
    assert tuple(tb["event"].shape) == (2, 2, 4, 32, 48)
    _assert_batches_match(jb, tb)


@pytest.mark.parametrize("name", ["synthetic_events", "synthetic_grid",
                                  "DSEC_events", "DDD17_events"])
def test_build_datasets_on_each_name(name, dsec_root, ddd17_root):
    from openess_tpu.data.loaders import build_datasets as jbuild

    kw = dict(dataset_name_b=name, nr_events_data_b=2,
              nr_events_window_b=300, config_option="frame2voxel",
              semseg_num_classes=6, img_size_b=(32, 48))
    if name == "synthetic_grid":
        kw.update(dataset_name_b="synthetic_events", wire_format="grid",
                  host_voxelize=False)
    elif name == "DSEC_events":
        kw.update(dataset_path_b=str(dsec_root), wire_format="grid",
                  host_voxelize=False, semseg_num_classes=11)
    elif name == "DDD17_events":
        kw.update(dataset_path_b=str(ddd17_root), wire_format="grid",
                  host_voxelize=False, img_size_b=(200, 352))
    js, ts = settings_pair(**kw)
    (jtr, jva), (ttr, tva) = jbuild(js), build_datasets(ts, "cpu")
    assert (len(ttr), len(tva)) == (len(jtr), len(jva))
    if name.startswith("synthetic"):
        _assert_batches_match(jtr.get_batch([1, 0]), ttr.get_batch([1, 0]))
    else:  # the disk datasets are held above; here, their devices
        assert ttr.device == tva.device == torch.device("cpu")
        assert ttr.get_batch([0])["event"].device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_datasets(ts)


def test_to_device_passes_device_tensors_through():
    event = torch.zeros(2, 3)
    out = to_device({"event": event, "label": np.ones((2, 3), np.int32)},
                    "cpu")
    assert out["event"] is event
    assert out["label"].dtype == torch.int32


# ---------------------------------------------------------------------------
# one grid-wire train step against StepBuilder
# ---------------------------------------------------------------------------


def test_grid_wire_linear_probe_step_matches_stepbuilder():
    """``build_datasets`` on the synthetic grid wire, then one linear-probe
    train step on each side, the port's from its own grid batch."""
    from openess_tpu.data.loaders import build_datasets as jbuild
    from openess_tpu.training.build import build_models as jbuild_models
    from openess_tpu.training.build import trainable_labels as jlabels
    from openess_tpu.training.optim import make_optimizer as joptim
    from openess_tpu.training.steps import StepBuilder as JStepBuilder
    from openess_tpu_torch.models.convert import (
        e2vid_state_dict_from_jax,
        semseg_state_dict_from_jax,
    )
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder

    js, ts = settings_pair(
        dataset_name_b="synthetic_events", img_size_b=(32, 64),
        semseg_num_classes=6, nr_events_data_b=2, compute_dtype="float32",
        data_augmentation_train=False, config_option="frame2voxel",
        if_linear_probing=True, wire_format="grid", host_voxelize=False)
    jbatch = jbuild(js)[0].get_batch([0, 1])
    tbatch = to_device(build_datasets(ts, "cpu")[0].get_batch([0, 1]), "cpu")
    assert _rel(tbatch["event"].numpy(), jbatch["event"]) <= GRID_TOL

    mset = jbuild_models(js, seed=0)
    tx = joptim(js, jlabels(mset, js), steps_per_epoch=2)
    sb = JStepBuilder(js, mset, tx)
    jb = jax.tree.map(jnp.asarray, jbatch)
    key, epoch = jax.random.key(0), jnp.asarray(0)

    def f(params):
        total, losses, _ = sb.compute_losses(params, mset.batch_stats, jb,
                                             key, epoch)
        return total, losses

    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        mset.params)
    updates, _ = tx.update(jgrads, tx.init(mset.params), mset.params)
    jprobe = jax.tree.map(np.asarray, optax.apply_updates(
        mset.params, updates)["back_end"]["linear_probe"])
    jgrad = jax.tree.map(np.asarray, jgrads["back_end"]["linear_probe"])

    text = np.asarray(mset.text_embeddings)
    tm = build_models(ts, seed=0, device="cpu")
    tm.modules["front_sensor_b"].load_state_dict(
        e2vid_state_dict_from_jax(mset.params["front_sensor_b"]))
    tm.modules["back_end"].load_state_dict(
        semseg_state_dict_from_jax(mset.params["back_end"], text))
    tsb = StepBuilder(ts, tm, make_optimizer(ts, tm), steps_per_epoch=2)
    probe = tm.modules["back_end"].linear_probe
    tsb._set_mode(True)
    total, tlosses = tsb.compute_losses(tbatch, 0)
    total.backward()
    tgrad = {"weight": probe.weight.grad.clone(),
             "bias": probe.bias.grad.clone()}
    tsb.optimizer.zero_grad()
    step_losses = tsb.train_step(tbatch, 0)
    for losses in (tlosses, step_losses):
        assert set(losses) == set(jlosses)
        for k, ref in jlosses.items():
            got = float(losses[k].detach())
            assert abs(got - float(ref)) <= LOSS_REL * abs(float(ref)), k
    # flax kernel [1, 1, in, out] <-> torch weight [out, in, 1, 1]
    ref_g = {"weight": np.transpose(jgrad["kernel"], (3, 2, 0, 1)),
             "bias": jgrad["bias"]}
    ref_p = {"weight": np.transpose(jprobe["kernel"], (3, 2, 0, 1)),
             "bias": jprobe["bias"]}
    gmax = max(np.abs(g).max() for g in ref_g.values())
    for k in ("weight", "bias"):
        assert _rel(tgrad[k].numpy(), ref_g[k]) <= PROBE_GRAD_REL, k
        mask = np.abs(ref_g[k]) > 1e-4 * gmax
        assert mask.any()
        diff = np.abs(getattr(probe, k).detach().numpy() - ref_p[k])
        assert diff[mask].max() <= UPDATE_ABS, k
