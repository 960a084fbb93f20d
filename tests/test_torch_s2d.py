"""E2VID's space-to-depth form (``tpu.e2vid_s2d``) in the port, on the CPU
in f32.

Tolerances, with what was measured:
- The port's s2d form against its standard form on the same weights
  (B = 1, T = 3, 32x40, planar and NHWC input, decode on and off; the JAX
  package's ``test_reconstructor_s2d_matches_standard``): 2e-5 absolute on
  the images and each latent (measured up to 1.4e-6).
- The port's s2d form against the JAX package's s2d form on the same
  weights: 1e-4 absolute (measured up to 1.7e-6).
- A fine-tune step with ``unfrozen_e2vid`` (32x48, T = 2, B = 2), s2d on
  against off: the loss 1e-6 relative (measured 0); E2VID's
  gradients of a fixed random projection of its latents 1e-4 of each
  tensor's max (measured 1.0e-6); E2VID's gradients of the step's
  loss, which pass the head's 16 instance norms, 1e-1 of each tensor's max
  (measured 5.6e-3: at random init the f32 backward through the
  instance norms is that ill-conditioned, as ``chip_smoke.py``'s
  fine-tune reference bounds the same tensors, CUDA against the CPU).
- The state dict, its keys and shapes, are the standard form's.
"""
import jax
import numpy as np
import pytest
import torch

from openess_tpu.models.e2vid import E2VIDReconstructor as JE2VID
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.models.convert import e2vid_state_dict_from_jax
from openess_tpu_torch.models.e2vid import E2VIDReconstructor, s2d_kernel
from openess_tpu_torch.training.build import build_models
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder
from openess_tpu_torch.training.trainer import to_device
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

B, T, H, W = 1, 3, 32, 40
STD_ABS = 2e-5
JAX_ABS = 1e-4
GRAD_REL = 1e-4
INORM_GRAD_REL = 1e-1
LOSS_REL = 1e-6


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(1205)
    x = rng.normal(size=(B, T, H, W, 5)).astype(np.float32)
    x[np.abs(x) < 0.3] = 0.0
    params = JE2VID().init(jax.random.key(0), x)
    return x, params


def _port(params, **kw):
    m = E2VIDReconstructor(**kw)
    sd = e2vid_state_dict_from_jax(params["params"])
    if kw.get("latent_only"):
        sd = {k: v for k, v in sd.items() if k in m.state_dict()}
    m.load_state_dict(sd)
    return m.eval()


def _inputs(x, planar):
    return torch.from_numpy(np.moveaxis(x, -1, 2).copy() if planar else x)


@pytest.mark.parametrize("latent_only", [False, True],
                         ids=["decode", "latent_only"])
@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
def test_s2d_matches_the_standard_form(case, planar, latent_only):
    x, params = case
    kw = dict(planar_input=planar, latent_only=latent_only)
    std, s2d = _port(params, **kw), _port(params, s2d=True, **kw)
    xi = _inputs(x, planar)
    with torch.no_grad():
        (img_a, lat_a), (img_b, lat_b) = std(xi), s2d(xi)
    for k in ("1", "2", "4", "8"):
        assert lat_b[k].shape == lat_a[k].shape
        np.testing.assert_allclose(lat_b[k].numpy(), lat_a[k].numpy(),
                                   atol=STD_ABS, err_msg=k)
    if latent_only:
        assert img_a is None and img_b is None
    else:
        np.testing.assert_allclose(img_b.numpy(), img_a.numpy(), atol=STD_ABS)


@pytest.mark.parametrize("planar", [False, True], ids=["nhwc", "planar"])
def test_s2d_matches_jax_s2d(case, planar):
    x, params = case
    xj = np.moveaxis(x, -1, 2) if planar else x
    imgs_j, lat_j = JE2VID(planar_input=planar, s2d=True).apply(params, xj)
    with torch.no_grad():
        imgs, lat = _port(params, planar_input=planar, s2d=True)(
            _inputs(x, planar))
    np.testing.assert_allclose(imgs.numpy(), np.asarray(imgs_j),
                               atol=JAX_ABS)
    for k in ("1", "2", "4", "8"):
        np.testing.assert_allclose(lat[k].numpy(), np.asarray(lat_j[k]),
                                   atol=JAX_ABS, err_msg=k)


def test_s2d_kernel_is_jax_gather(case):
    """The gathered 3x3 kernels equal the JAX package's ``_s2d_kernel``
    (transposed to OIHW), exactly."""
    from openess_tpu.models.e2vid import _s2d_kernel

    _, params = case
    p = params["params"]["step"]["unet"]
    for name, s2d_out in (("head", True), ("encoders_0/conv", False)):
        kj = np.asarray(p[name]["conv2d"]["kernel"])  # HWIO [5, 5, ci, co]
        w = torch.from_numpy(kj.transpose(3, 2, 0, 1).copy())
        ref = np.asarray(_s2d_kernel(kj, s2d_out)).transpose(3, 2, 0, 1)
        np.testing.assert_array_equal(s2d_kernel(w, s2d_out).numpy(), ref)


def _settings(**kw):
    return Settings(
        dataset_name_b="synthetic_events", img_size_b=(32, 48),
        semseg_num_classes=6, nr_events_data_b=2, compute_dtype="float32",
        data_augmentation_train=False, superpixel_size=20, batch_size_b=2,
        **kw)


SUP_ONLY = dict(if_supervised_only=True, config_option="recon2voxel")
PRETRAIN = dict(if_pretraining=True, config_option="frame2voxel",
                if_spatial_contrastive=True, if_dense_clip_supervision=True)


@pytest.mark.parametrize("kw", [SUP_ONLY, PRETRAIN],
                         ids=["sup_only", "pretrain"])
def test_build_models_takes_e2vid_s2d(kw, monkeypatch):
    """The tasks whose build once refused ``e2vid_s2d`` build, with the
    reconstructor in its s2d form and the state dict unchanged; the
    server's one-window step stays in the standard form."""
    from openess_tpu_torch.training import build

    monkeypatch.setattr(build, "init_weights", lambda module, gen: None)
    on = build_models(_settings(**kw, e2vid_s2d=True), device="cpu")
    off = build_models(_settings(**kw), device="cpu")
    assert list(on.modules) == list(off.modules)
    rec = on.modules["front_sensor_b"]
    assert rec.s2d and not off.modules["front_sensor_b"].s2d
    for name in on.modules:
        a, b = on.modules[name].state_dict(), off.modules[name].state_dict()
        assert list(a) == list(b), name
        assert all(a[k].shape == b[k].shape for k in a), name
    StepBuilder(_settings(**kw, e2vid_s2d=True), on)


def test_unfrozen_e2vid_gradients_with_and_without_s2d():
    """A fine-tune step's loss and gradients with ``unfrozen_e2vid``, s2d on
    against off, from the same seed: E2VID's gradients of a fixed random
    projection of its latents (``"1"`` to ``"8"``) to ``GRAD_REL``; those of
    the step's loss, which reach E2VID through the head's 16 instance
    norms, to ``INORM_GRAD_REL``."""
    ds = SyntheticESS(num_samples=2, height=32, width=48, num_classes=6,
                      num_windows=2)
    host = ds.raw_wire_batch([0, 1])
    out = {}
    for s2d in (False, True):
        s = _settings(if_finetuning=True, config_option="frame2voxel",
                      unfrozen_e2vid=True, e2vid_s2d=s2d)
        mset = build_models(s, seed=0, device="cpu")
        e2vid = mset.modules["front_sensor_b"]
        sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
        sb._set_mode(True)
        batch = sb._with_windows(to_device(host, "cpu"))
        total, losses = sb.compute_losses(batch, 0)
        total.backward()
        step = {k: p.grad.clone() for k, p in e2vid.named_parameters()}
        e2vid.zero_grad()
        _, latent = e2vid(batch["event"])
        gen = torch.Generator().manual_seed(3)
        sum(torch.randn(v.shape, generator=gen).mul(v).sum()
            for _, v in sorted(latent.items())).backward()
        probe = {k: p.grad.clone() for k, p in e2vid.named_parameters()}
        out[s2d] = float(losses["semseg_loss"].detach()), step, probe
    (la, sa, pa), (lb, sbg, pb) = out[False], out[True]
    assert abs(lb - la) <= LOSS_REL * abs(la)
    assert len(pa) == 14
    for grads_a, grads_b, bound in ((pa, pb, GRAD_REL),
                                    (sa, sbg, INORM_GRAD_REL)):
        for k in grads_a:
            scale = grads_a[k].abs().max().item()
            assert scale > 0, k
            err = (grads_b[k] - grads_a[k]).abs().max().item()
            assert err <= bound * scale, (k, err / scale)
