"""The training slice of the port against the JAX package on the CPU (f32,
64x96, T = 2, 6 classes): the pretrain ``frame2voxel`` step on
``SyntheticESS.raw_wire_batch([0, 1])`` with augmentation off and the
weights carried across, the optimizer and the eval step, all from one
module-scoped run of both sides (``parity``). The trainer loop and the
checkpoints are in ``test_torch_train_trainer.py``; the command lines and
the tests that need neither run in ``test_torch_train_cli.py``; both
import this module's settings helpers.

Tolerances, with what was measured:
- Loss dict on the same voxel windows (JAX's own ``voxelize_wire`` output
  fed to both sides): 1e-5 relative (measured 0 to 1e-7).
- Loss dict from the wire: 1e-3 relative (measured 1.5e-4 on the
  contrastive loss, 5e-6 on the dense loss). The looser bound is the honest
  one here: the JAX voxelizer multiplies in bf16 (about 5e-3 of the grid
  max), the port's K1 is an exact f32 splat.
- Gradients of ``decoder_ch256``/``decoder_ch512`` and the teacher's
  ``decoder_conv``: 1e-5 of each tensor's max (measured 1e-6).
- Gradients of the instance-normalized head convs: 3e-2 of each tensor's
  max. Measured: port vs JAX up to 1.2e-2, and against the port's own f64
  gradient both f32 sides are equally far off (port 1.2e-2, JAX 0.6e-2):
  at random init the f32 backward through the 16 instance norms is that
  ill-conditioned on either side, so a tighter bound would test rounding.
  The conv biases in front of an instance norm have a mathematically zero
  gradient; both sides give noise below 1e-4 of the weights' gradients.
- Parameters after one AdamW step: the first Adam update is
  ``lr * g / (|g| + eps)``, i.e. ``+-lr`` by the sign of ``g``, so they are
  compared where ``|g|`` is above the gradient noise (5e-3 for the
  instance-normalized convs, 1e-4 elsewhere): 1e-6 absolute (lr 5e-4).
  Frozen parameters stay bit-identical.
- Eval: loss 1e-5 relative, argmax agreement >= 99.9 %.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu.data.synthetic import SyntheticESS as JSynthetic
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
    teacher_state_dict_from_jax,
)
from openess_tpu_torch.training.build import build_models, trainable_labels
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder
from openess_tpu_torch.training.trainer import to_device
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, T = 64, 96, 6, 2
SAME_WINDOWS_REL = 1e-5
WIRE_REL = 1e-3
PLAIN_GRAD_REL = 1e-5
INORM_GRAD_REL = 3e-2
UPDATE_ABS = 1e-6
COMMON = dict(
    dataset_name_b="synthetic_events", img_size_b=(H, W),
    semseg_num_classes=C, nr_events_data_b=T, compute_dtype="float32",
    data_augmentation_train=False, superpixel_size=20,
)
PRETRAIN = dict(if_pretraining=True, config_option="frame2voxel",
                if_spatial_contrastive=True, if_dense_clip_supervision=True)
SUP_ONLY = dict(if_supervised_only=True, config_option="recon2voxel")


def jax_settings(**kw):
    s = JSettings()
    for k, v in {**COMMON, **kw}.items():
        setattr(s, k, v)
    s.__post_init__()
    return s


def torch_settings(**kw):
    return Settings(**{**COMMON, **kw})


def _inorm(name):
    return name.startswith("decoder_scale")


@pytest.fixture(scope="module")
def datasets():
    kw = dict(num_samples=4, height=H, width=W, num_classes=C, num_windows=T)
    return JSynthetic(**kw), SyntheticESS(**kw)



@pytest.fixture(scope="module")
def parity(datasets):
    """One pretrain frame2voxel step on both sides."""
    from openess_tpu.data.device_voxelize import voxelize_wire as jvox
    from openess_tpu.training.build import build_models as jbuild
    from openess_tpu.training.build import trainable_labels as jlabels
    from openess_tpu.training.optim import make_optimizer as joptim
    from openess_tpu.training.steps import StepBuilder as JStepBuilder
    from openess_tpu.training.steps import TrainState

    jds, tds = datasets
    js = jax_settings(**PRETRAIN)
    mset = jbuild(js, seed=0)
    tx = joptim(js, jlabels(mset, js), steps_per_epoch=2)
    sb = JStepBuilder(js, mset, tx)
    wire = jax.tree.map(jnp.asarray, jds.raw_wire_batch([0, 1]))
    windows = np.asarray(jvox(js, wire))
    jbatch = {k: v for k, v in wire.items() if not k.startswith("ev_")}
    jbatch["event"] = jnp.asarray(windows)
    params0 = jax.tree.map(np.array, mset.params)
    stats0 = jax.tree.map(np.array, mset.batch_stats)
    key, epoch = jax.random.key(0), jnp.asarray(0)

    @jax.jit
    def loss_and_grad(params, batch):
        def f(p):
            total, losses, _ = sb.compute_losses(p, mset.batch_stats, batch,
                                                 key, epoch)
            return total, losses
        return jax.value_and_grad(f, has_aux=True)(params)

    (_, jlosses), jgrads = loss_and_grad(mset.params, jbatch)
    jpred, jeval_loss = sb.make_eval_step()(mset.params, mset.batch_stats,
                                            jbatch)
    jpred, jeval_loss = np.asarray(jpred), float(jeval_loss)
    jgrads = jax.tree.map(np.asarray, jgrads)
    state = TrainState(step=jnp.asarray(0), params=mset.params,
                       batch_stats=mset.batch_stats,
                       opt_state=tx.init(mset.params))
    state, jstep_losses = sb.make_train_step()(state, jbatch, key, epoch)
    params1 = jax.tree.map(np.asarray, state.params)
    text = np.asarray(mset.text_embeddings)

    ts = torch_settings(**PRETRAIN)
    tm = build_models(ts, seed=0, device="cpu")
    tm.modules["front_sensor_b"].load_state_dict(
        e2vid_state_dict_from_jax(params0["front_sensor_b"]), strict=True)
    tm.modules["back_end"].load_state_dict(
        semseg_state_dict_from_jax(params0["back_end"], text), strict=True)
    tm.modules["model_frame"].load_state_dict(
        teacher_state_dict_from_jax(params0["model_frame"],
                                    stats0["model_frame"]), strict=True)
    frozen0 = {
        f"{name}.{k}": v.clone()
        for name in ("front_sensor_b", "model_frame")
        for k, v in tm.modules[name].state_dict().items()
        if not k.startswith("decoder_conv")
    }
    opt = make_optimizer(ts, tm)
    tsb = StepBuilder(ts, tm, opt, steps_per_epoch=2)
    twire = to_device(tds.raw_wire_batch([0, 1]), "cpu")
    tbatch = {k: v for k, v in twire.items() if not k.startswith("ev_")}
    tbatch["event"] = torch.from_numpy(windows.copy())

    tsb._set_mode(True)
    _, wire_losses = tsb.compute_losses(tsb._with_windows(twire), 0)
    wire_losses = {k: float(v.detach()) for k, v in wire_losses.items()}
    tpred, teval_loss = tsb.eval_step(tbatch)
    tsb._set_mode(True)
    total, tlosses = tsb.compute_losses(tbatch, 0)
    total.backward()
    tgrads = {
        f"{name}.{k}": p.grad.clone()
        for name, m in tm.modules.items()
        for k, p in m.named_parameters() if p.grad is not None
    }
    opt.zero_grad()
    step_losses = tsb.train_step(tbatch, 0)
    return dict(
        jlosses={k: float(v) for k, v in jlosses.items()},
        jstep_losses={k: float(v) for k, v in jstep_losses.items()},
        tlosses={k: float(v) for k, v in tlosses.items()},
        step_losses={k: float(v) for k, v in step_losses.items()},
        wire_losses=wire_losses, jgrads=jgrads, tgrads=tgrads,
        params1=params1, text=text, tm=tm, frozen0=frozen0, tsb=tsb,
        jpred=jpred, jeval_loss=jeval_loss, tpred=tpred.numpy(),
        teval_loss=float(teval_loss), ts=ts,
    )


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def test_loss_dict_matches_stepbuilder(parity):
    keys = {"contrastive_nce_loss", "dense_clip_loss", "total_loss"}
    assert set(parity["jlosses"]) == keys
    for name in ("tlosses", "step_losses"):
        assert set(parity[name]) == keys
        for k in keys:
            assert _rel(parity[name][k], parity["jlosses"][k]) \
                <= SAME_WINDOWS_REL, (name, k)
    for k in keys:
        assert _rel(parity["jstep_losses"][k], parity["jlosses"][k]) <= 1e-6


def test_loss_dict_from_the_wire(parity):
    for k, ref in parity["jlosses"].items():
        assert _rel(parity["wire_losses"][k], ref) <= WIRE_REL, k


def _jax_head_grads(parity):
    return semseg_state_dict_from_jax(parity["jgrads"]["back_end"],
                                      np.zeros_like(parity["text"]))


def test_gradients_match_stepbuilder(parity):
    jg = _jax_head_grads(parity)
    tg = parity["tgrads"]
    weight_scale = max(float(jg[k].abs().max()) for k in jg
                       if k.endswith("weight"))
    checked = 0
    for k, ref in jg.items():
        if k == "text_embeddings":
            continue
        got, scale = tg[f"back_end.{k}"], float(ref.abs().max())
        if _inorm(k) and k.endswith("bias"):
            # a bias in front of an instance norm: zero gradient, f32 noise
            assert scale <= 1e-4 * weight_scale
            assert float(got.abs().max()) <= 1e-4 * weight_scale
        else:
            rel = INORM_GRAD_REL if _inorm(k) else PLAIN_GRAD_REL
            assert float((got - ref).abs().max()) <= rel * scale, k
        checked += 1
    assert checked == 36
    dc = parity["jgrads"]["model_frame"]["decoder_conv"]
    ref_w = torch.from_numpy(dc["kernel"].transpose(3, 2, 0, 1))
    ref_b = torch.from_numpy(dc["bias"])
    for got, ref in ((tg["model_frame.decoder_conv.weight"], ref_w),
                     (tg["model_frame.decoder_conv.bias"], ref_b)):
        assert float((got - ref).abs().max()) <= PLAIN_GRAD_REL * float(
            ref.abs().max())
    # nothing frozen received a gradient
    assert not any(k.startswith(("front_sensor_b.", "model_frame.encoder."))
                   for k in tg)


def test_one_adamw_update_matches_and_frozen_stay(parity):
    tm, jg = parity["tm"], _jax_head_grads(parity)
    new = semseg_state_dict_from_jax(parity["params1"]["back_end"],
                                     parity["text"])
    compared = 0
    for k, p in tm.modules["back_end"].named_parameters():
        mask = jg[k].abs() > (5e-3 if _inorm(k) else 1e-4)
        if mask.any():
            diff = (p.detach() - new[k]).abs()[mask]
            assert float(diff.max()) <= UPDATE_ABS, k
            compared += int(mask.sum())
    assert compared > 50_000
    dc1 = parity["params1"]["model_frame"]["decoder_conv"]
    dcg = parity["jgrads"]["model_frame"]["decoder_conv"]
    w = tm.modules["model_frame"].decoder_conv.weight.detach()
    ref = torch.from_numpy(dc1["kernel"].transpose(3, 2, 0, 1))
    mask = torch.from_numpy(np.abs(dcg["kernel"]).transpose(3, 2, 0, 1) > 1e-4)
    assert mask.sum() > 1000
    assert float((w - ref).abs()[mask].max()) <= UPDATE_ABS
    # the update moved the weights by about lr
    assert float((w - ref).abs()[mask].max()) < parity["ts"].lr_frame / 100
    for name in ("front_sensor_b", "model_frame"):
        for k, v in tm.modules[name].state_dict().items():
            if f"{name}.{k}" in parity["frozen0"]:
                assert torch.equal(v, parity["frozen0"][f"{name}.{k}"]), k


def test_eval_step_matches(parity):
    assert parity["tpred"].shape == parity["jpred"].shape == (2, H, W)
    assert (parity["tpred"] == parity["jpred"]).mean() >= 0.999
    assert _rel(parity["teval_loss"], parity["jeval_loss"]) <= 1e-5
    pred, feats = parity["tsb"].viz_step(
        {"event": torch.zeros(1, T, 5, H, W)})
    assert pred.shape == (1, H, W) and feats.shape == (1, H, W, 256)


def test_trainable_labels_and_groups(parity):
    tm, ts = parity["tm"], parity["ts"]
    labels = trainable_labels(tm, ts)
    assert {v for k, v in labels.items()
            if k.startswith("front_sensor_b.")} == {"frozen"}
    assert {v for k, v in labels.items()
            if k.startswith("model_frame.encoder.")} == {"frozen"}
    assert labels["model_frame.decoder_conv.weight"] == "frame"
    assert {v for k, v in labels.items()
            if k.startswith("back_end.")} == {"voxel"}
    opt = make_optimizer(ts, tm)
    assert [g["name"] for g in opt.param_groups] == ["frame", "voxel"]
    assert [len(g["params"]) for g in opt.param_groups] == [2, 36]
    for g in opt.param_groups:
        assert g["betas"] == (0.9, 0.999) and g["eps"] == 1e-8
        assert g["weight_decay"] == ts.weight_decay
    for name, m in tm.modules.items():
        for k, p in m.named_parameters():
            assert p.requires_grad == (labels[f"{name}.{k}"] != "frozen")
