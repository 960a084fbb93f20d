"""The training slice of the port against the JAX package on the CPU (f32,
64x96, T = 2, 6 classes): the pretrain ``frame2voxel`` step on
``SyntheticESS.raw_wire_batch([0, 1])`` with augmentation off and the
weights carried across, the optimizer, the eval step, the augmentation
helpers, the trainer loop and the checkpoints.

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
import dataclasses
import glob
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu.data.synthetic import SyntheticESS as JSynthetic
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.pipeline import batch_indices
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
    teacher_state_dict_from_jax,
)
from openess_tpu_torch.training import checkpoint as ckpt
from openess_tpu_torch.training.build import (
    build_models,
    refuse_unported_mesh,
    task_from_settings,
    trainable_labels,
)
from openess_tpu_torch.training.optim import (
    epoch_cosine_lr,
    make_optimizer,
    set_learning_rates,
)
from openess_tpu_torch.training.steps import StepBuilder
from openess_tpu_torch.training.trainer import Trainer, to_device

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


@pytest.mark.parametrize("t16", [True, False])
def test_synthetic_batches_are_bit_identical(datasets, t16):
    jds, tds = datasets
    jb, tb = jds.raw_wire_batch([0, 1], t16=t16), tds.raw_wire_batch(
        [0, 1], t16=t16)
    assert jb.keys() == tb.keys()
    for k in jb:
        assert jb[k].dtype == tb[k].dtype and jb[k].shape == tb[k].shape, k
        np.testing.assert_array_equal(jb[k], tb[k], k)


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


def test_lr_schedule_at_epoch_boundaries():
    from openess_tpu.training.optim import epoch_cosine_schedule

    spe, epochs, lr0 = 3, 4, 5e-4
    ref = epoch_cosine_schedule(lr0, spe, epochs)
    for step in range(0, spe * epochs + 4):
        got = epoch_cosine_lr(lr0, step, spe, epochs)
        assert abs(got - float(ref(step))) <= 1e-9, step
    assert epoch_cosine_lr(lr0, 2, spe, epochs) == lr0
    assert epoch_cosine_lr(lr0, 3, spe, epochs) < lr0
    assert epoch_cosine_lr(lr0, spe * epochs + 100, spe, epochs) <= 1e-12
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.AdamW([{"params": [p], "lr": 1.0, "lr0": lr0}])
    set_learning_rates(opt, 2 * spe, spe, epochs)
    assert abs(opt.param_groups[0]["lr"] - lr0 * 0.5) <= 1e-12


def test_switchable_pl_takes_own_argmax_from_epoch_5(datasets):
    from openess_tpu_torch.losses import task_loss

    ts = torch_settings(**{**PRETRAIN, "if_spatial_contrastive": False},
                        if_switchable_train=True, teacher_os=16)
    tm = build_models(ts, seed=0, device="cpu")
    sb = StepBuilder(ts, tm)
    batch = sb._with_windows(to_device(datasets[1].raw_wire_batch([0]), "cpu"))
    sb._set_mode(True)
    with torch.no_grad():
        logits, _ = sb._event_path(batch)
        _, early = sb.compute_losses(batch, 4)
        _, late = sb.compute_losses(batch, 5)
    kw = dict(num_classes=C, ignore_index=ts.semseg_ignore_label)
    assert set(early) == {"dense_clip_loss", "total_loss"}
    assert float(early["dense_clip_loss"]) == pytest.approx(
        float(task_loss(logits, batch["pl"], **kw)), rel=1e-6)
    assert float(late["dense_clip_loss"]) == pytest.approx(
        float(task_loss(logits, logits.argmax(-1), **kw)), rel=1e-6)


def test_recon2voxel_pretrain_uses_the_recon_teacher(datasets):
    """``recon2voxel``: the teacher is ``model_recon`` in the ``recon``
    group and reads the reconstructions, not the frames."""
    ts = torch_settings(**{**PRETRAIN, "config_option": "recon2voxel"},
                        teacher_os=16, lr_recon=1e-3)
    tm = build_models(ts, seed=0, device="cpu")
    assert list(tm.modules) == ["front_sensor_b", "back_end", "model_recon"]
    assert tm.roles["model_recon"] == "teacher"
    opt = make_optimizer(ts, tm)
    assert {g["name"]: g["lr0"] for g in opt.param_groups} == {
        "recon": 1e-3, "voxel": ts.lr_voxel}
    sb = StepBuilder(ts, tm, opt, steps_per_epoch=2)
    batch = to_device(datasets[1].raw_wire_batch([0, 1]), "cpu")
    losses = sb.train_step(batch, 0)
    assert set(losses) == {"contrastive_nce_loss", "dense_clip_loss",
                           "total_loss"}
    other = dict(batch, frame=torch.rand_like(batch["frame"]))
    sb._set_mode(True)
    with torch.no_grad():
        _, a = sb.compute_losses(sb._with_windows(batch), 0)
        _, b = sb.compute_losses(sb._with_windows(other), 0)
        _, c = sb.compute_losses(sb._with_windows(
            dict(batch, recon=torch.rand_like(batch["recon"]))), 0)
    assert float(a["contrastive_nce_loss"]) == float(b["contrastive_nce_loss"])
    assert float(a["contrastive_nce_loss"]) != float(c["contrastive_nce_loss"])


def test_loss_falls_over_five_steps_with_augmentation(datasets):
    ts = torch_settings(**SUP_ONLY, data_augmentation_train=True)
    tm = build_models(ts, seed=0, device="cpu")
    sb = StepBuilder(ts, tm, make_optimizer(ts, tm), steps_per_epoch=2)
    batch = to_device(datasets[1].raw_wire_batch([0, 1]), "cpu")
    hist = [float(sb.train_step(batch, 0)["semseg_loss"]) for _ in range(5)]
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0], hist
    assert sb.step == 5


def test_augmentation_matches_jax_helpers_with_given_decisions(datasets):
    from openess_tpu.data import augment as jaug
    from openess_tpu_torch.data.augment import augment_batch, draw_decisions

    tb = to_device(datasets[1].raw_wire_batch([0, 1, 2]), "cpu")
    tb = {k: v for k, v in tb.items() if not k.startswith("ev_")}
    rng = np.random.default_rng(0)
    tb["event"] = torch.from_numpy(
        rng.normal(size=(3, T, 5, H, W)).astype(np.float32))
    d = draw_decisions(tb, torch.Generator().manual_seed(0))
    for name, val in (("flip", [True, False, True]),
                      ("bright", [True, True, False]),
                      ("contrast", [False, True, True]),
                      ("noise", [True, False, True])):
        d[name] = torch.tensor(val)
    assert all(0.8 <= float(v) <= 1.2 for k in ("frame", "recon")
               for v in d[f"bright_factor_{k}"])
    out = augment_batch(tb, d)
    for b in range(3):
        for key, axis in jaug._FLIP_AXES.items():
            x = tb[key][b].numpy()
            if key in jaug.IMAGE_KEYS:
                img = jnp.asarray(x)
                if d["flip"][b]:
                    img = jnp.flip(img, axis=axis)
                if d["bright"][b]:
                    img = jaug._adjust_brightness(
                        img, float(d[f"bright_factor_{key}"][b]))
                if d["contrast"][b]:
                    img = jaug._adjust_contrast(
                        img, float(d[f"contrast_factor_{key}"][b]))
                if d["noise"][b]:
                    # drawn in the output frame: added after the flip
                    img = img + d[f"noise_value_{key}"][b].numpy()
                np.testing.assert_allclose(out[key][b].numpy(),
                                           np.asarray(img), atol=1e-6)
            else:
                want = np.flip(x, axis=axis) if d["flip"][b] else x
                np.testing.assert_array_equal(out[key][b].numpy(), want)
    # inputs untouched; an all-off decision set is the identity
    off = {k: (torch.zeros(3, dtype=torch.bool) if v.dtype == torch.bool
               else v) for k, v in d.items()}
    same = augment_batch(tb, off)
    assert all(torch.equal(same[k], tb[k]) for k in tb)


def test_batch_indices_follow_the_prefetch_loader_rule():
    from openess_tpu.data.pipeline import PrefetchLoader

    class Echo:
        def __len__(self):
            return 11

        def get_batch(self, idx):
            return {"idx": np.asarray(idx)}

    for train in (True, False):
        ref = list(PrefetchLoader(
            Echo(), 4, shuffle=train, rng=np.random.default_rng(3),
            drop_last=train, pad_last=not train))
        got = list(batch_indices(11, 4, shuffle=train,
                                 rng=np.random.default_rng(3),
                                 drop_last=train, pad_last=not train))
        assert len(got) == len(ref) == (2 if train else 3)
        for (idx, valid), r in zip(got, ref):
            np.testing.assert_array_equal(idx, r["idx"])
            if train:
                assert valid is None and "valid" not in r
            else:
                np.testing.assert_array_equal(valid, r["valid"])


@pytest.mark.parametrize("kw,modules", [
    (dict(if_finetuning=True, config_option="frame2voxel"),
     ["front_sensor_b", "back_end"]),
    (dict(if_linear_probing=True, config_option="frame2voxel"),
     ["front_sensor_b", "back_end"]),
    (dict(config_option="frame2voxel"),
     ["front_sensor_b", "back_end", "model_frame"]),
    (dict(if_pretraining=True, config_option="frame2recon"),
     ["model_recon", "model_frame"]),
    (dict(if_supervised_only=True, config_option="frame2recon"),
     ["model_recon"]),
    (dict(if_finetuning=True, config_option="frame2recon"),
     ["model_recon"]),
    (dict(if_linear_probing=True, config_option="frame2recon"),
     ["model_recon"]),
], ids=["finetune-frame2voxel", "linear_probe-frame2voxel",
        "openess-frame2voxel", "pretrain-frame2recon", "sup_only-frame2recon",
        "finetune-frame2recon", "linear_probe-frame2recon"])
def test_unported_workloads_name_their_roadmap_item(kw, modules,
                                                   monkeypatch):
    """The workloads that once raised naming ROADMAP item 6 (the DeepLabV3
    student, the frame/recon workloads and UDA) build as the JAX package
    builds them, with the ``linear_probe`` conv under linear probing, and
    ``StepBuilder`` takes them; the fine-tune and the linear probe on a
    voxel option build as before. (The setting that still waits for an
    item, the mesh, raises in the tests below.) The
    structure is under test, so the weight draws are skipped."""
    from openess_tpu_torch.training import build

    monkeypatch.setattr(build, "init_weights", lambda module, gen: None)
    ts = torch_settings(**kw)
    tm = build_models(ts, device="cpu")
    assert list(tm.modules) == modules
    assert tm.task == task_from_settings(ts)
    roles = {"front_sensor_b": "e2vid", "back_end": "semseg_head"}
    for name in modules:
        want = roles.get(name)
        if want is None:
            teacher = tm.task == "pretrain" and name == "model_frame"
            want = "teacher" if teacher else "deeplab"
        assert tm.roles[name] == want, name
    probe = tm.task == "linear_probe"
    head = tm.modules.get("back_end", tm.modules.get("model_recon"))
    assert (head.linear_probe is not None) == probe
    StepBuilder(ts, tm)


YAMLS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, "configs", "**", "*.yaml"), recursive=True))
DISPATCH_KW = (SUP_ONLY, PRETRAIN, dict(if_finetuning=True),
               dict(if_linear_probing=True), {},
               dict(if_supervised_only=True, if_pretraining=True))


@pytest.mark.parametrize(
    "case", [("kw", kw) for kw in DISPATCH_KW] + [("yaml", y) for y in YAMLS],
    ids=[f"kw{i}" for i in range(len(DISPATCH_KW))] + YAMLS)
def test_task_dispatch_matches_jax(case):
    """The two packages dispatch to the same task, on six sets of flags and
    on every shipped YAML."""
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu.training.build import task_from_settings as jtask
    from openess_tpu_torch.config.settings import load_settings as tload

    kind, arg = case
    if kind == "kw":
        ts, js = torch_settings(**arg), jax_settings(**arg)
    else:
        path = os.path.join(ROOT, arg)
        ts, js = tload(path), jload(path)
    assert task_from_settings(ts) == jtask(js)


def test_trainer_refuses_model_parallelism():
    ts = torch_settings(**SUP_ONLY, mesh_model=2)
    ds = SyntheticESS(num_samples=2, height=H, width=W, num_classes=C,
                      num_windows=T)
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(ts, ds, device="cpu")


def test_trainer_refuses_more_data_shards_than_devices():
    """One device on the CPU: ``mesh_data`` 2 raises; the shipped -1 and an
    explicit 1 build."""
    ds = SyntheticESS(num_samples=2, height=H, width=W, num_classes=C,
                      num_windows=T)
    with pytest.raises(NotImplementedError, match="item 12"):
        Trainer(torch_settings(**SUP_ONLY, mesh_data=2), ds, device="cpu")
    for n in (-1, 1):
        refuse_unported_mesh(torch_settings(**SUP_ONLY, mesh_data=n), "cpu")


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two tiny sup_only epochs: 8 training samples, 5 validation samples
    (so the last validation batch is padded), batch size 4."""
    out = tmp_path_factory.mktemp("run")
    ts = torch_settings(**SUP_ONLY, batch_size_b=4, num_epochs=2,
                        data_augmentation_train=True, log_dir=str(out))
    ts.ckpt_dir = str(out / "checkpoints")
    kw = dict(height=H, width=W, num_classes=C, num_windows=T)

    def make(n, seed):
        ds = SyntheticESS(num_samples=n, seed=seed, **kw)
        ds.get_batch = lambda idx: ds.raw_wire_batch(list(idx))
        return ds

    trainer = Trainer(ts, make(8, 1205), make(5, 1206), device="cpu")
    best = trainer.training()
    return ts, trainer, best, make


def test_trainer_trains_validates_and_checkpoints(trained):
    ts, trainer, best, _ = trained
    assert np.isfinite(best["miou"]) and 0.0 <= best["miou"] <= 100.0
    # the padded sixth..eighth samples of the last batch are masked out
    assert best["cm"].sum() == 5 * H * W
    assert trainer.sb.step == 4 and trainer.steps_per_epoch == 2
    assert sorted(os.listdir(ts.ckpt_dir)) == ["ckpt_0.pt", "ckpt_1.pt"]
    lr = [g["lr"] for g in trainer.optimizer.param_groups]
    assert lr == [pytest.approx(ts.lr_voxel * 0.5)]  # epoch 1 of 2
    avg = trainer.train_epoch()
    assert set(avg) == {"semseg_loss", "total_loss"}
    assert all(np.isfinite(v) for v in avg.values())


def _fresh(ts, seed=7):
    return build_models(ts, seed=seed, device="cpu")


def _same(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return all(torch.equal(sa[n][k], sb[n][k]) for n in sa for k in sa[n])


def test_checkpoint_restores_full_model_only_partial_superset(trained,
                                                              tmp_path):
    ts, trainer, _, _ = trained
    path = ckpt.save_checkpoint(str(tmp_path), trainer.mset,
                                trainer.optimizer, trainer.sb.step, 1)
    # full, without the optimizer (the default) and with it
    m = _fresh(ts)
    opt = make_optimizer(ts, m)
    assert not _same(m, trainer.mset)
    assert ckpt.restore_checkpoint(str(tmp_path), m, opt) == (
        trainer.sb.step, 1)
    assert _same(m, trainer.mset) and not opt.state_dict()["state"]
    ckpt.restore_checkpoint(path, m, opt, restore_optimizer=True)
    got, ref = opt.state_dict()["state"], trainer.optimizer.state_dict()["state"]
    assert got.keys() == ref.keys() and len(got) == 36
    assert all(torch.equal(got[i]["exp_avg"], ref[i]["exp_avg"]) for i in got)
    # model-only
    snap = ckpt.save_model_only(str(tmp_path), trainer.mset, 1)
    assert os.path.basename(snap) == "epoch_1.pt"
    m = _fresh(ts)
    ckpt.load_model_only(snap, m)
    assert _same(m, trainer.mset)
    # partial: excluded names and mismatched shapes keep their fresh values
    m = _fresh(ts)
    fresh = {k: v.clone() for k, v in m.modules["back_end"].state_dict().items()}
    taken = ckpt.load_pretrained_params(snap, m,
                                        exclude_substrings=("decoder_ch512",))
    sd, ref = m.modules["back_end"].state_dict(), trainer.mset.modules[
        "back_end"].state_dict()
    assert torch.equal(sd["decoder_ch512.0.weight"],
                       fresh["decoder_ch512.0.weight"])
    assert torch.equal(sd["decoder_ch256.0.weight"],
                       ref["decoder_ch256.0.weight"])
    assert "back_end.decoder_ch512.0.weight" not in taken
    ts9 = dataclasses.replace(ts, semseg_num_classes=11)
    m9 = _fresh(ts9)
    taken = ckpt.load_pretrained_params(snap, m9)
    assert "back_end.text_embeddings" not in taken  # [6, 512] vs [11, 512]
    assert torch.equal(m9.modules["back_end"].state_dict()[
        "decoder_ch256.0.weight"], ref["decoder_ch256.0.weight"])
    # superset restores (extra module, extra key); a missing leaf raises
    raw = torch.load(path, weights_only=True)
    raw["models"]["model_frame"] = {"decoder_conv.weight": torch.zeros(1)}
    raw["models"]["back_end"]["dead.weight"] = torch.zeros(3)
    torch.save(raw, tmp_path / "superset.pt")
    m = _fresh(ts)
    ckpt.restore_checkpoint(str(tmp_path / "superset.pt"), m)
    assert _same(m, trainer.mset)
    del raw["models"]["back_end"]["decoder_ch256.0.bias"]
    torch.save(raw, tmp_path / "missing.pt")
    with pytest.raises(ValueError, match="missing leaf.*decoder_ch256.0.bias"):
        ckpt.restore_checkpoint(str(tmp_path / "missing.pt"), _fresh(ts))
    # only the newest three full checkpoints are kept
    for e in (2, 3, 4):
        ckpt.save_checkpoint(str(tmp_path), trainer.mset, None, 0, e)
    assert sorted(f for f in os.listdir(tmp_path) if f.startswith("ckpt_")) \
        == ["ckpt_2.pt", "ckpt_3.pt", "ckpt_4.pt"]


def test_resume_and_test_entry_point_evaluate_the_checkpoint(trained):
    ts, trainer, best, make = trained
    rs = dataclasses.replace(ts, resume_training=True,
                             resume_ckpt_file=ts.ckpt_dir)
    resumed = Trainer(rs, make(5, 1206), make(5, 1206), device="cpu")
    assert resumed.epoch == 1 and resumed.sb.step == 4
    assert _same(resumed.mset, trainer.mset)
    summary = resumed.val_epochs()
    final = trainer.val_epoch()
    np.testing.assert_array_equal(summary["cm"], final["cm"])


def test_serve_stream_serves_the_trained_checkpoint(trained):
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows

    ts, trainer, _, _ = trained
    served = StreamServer(ts, 1, device="cpu", checkpoint=ts.ckpt_dir)
    random = StreamServer(ts, 1, device="cpu")
    x, y, p, t = next(iter(synthetic_windows(1, 2000, H, W)))
    wire = upload_wire(served.pack(x, y, p, t), "cpu")
    _, labels, logits = served.step(served.initial_state(), wire)
    _, rlabels, _ = random.step(random.initial_state(), wire)
    # the trained head's labels: the same window through the trainer's own
    # modules
    sb = trainer.sb
    sb._set_mode(False)
    with torch.no_grad():
        want, _ = sb._event_path(wire)  # one window from a zero state
    np.testing.assert_allclose(logits.numpy(), want.numpy(), atol=1e-5)
    assert torch.equal(labels, want.argmax(-1).to(torch.uint8))
    assert not torch.equal(labels, rlabels)


def test_train_and_test_command_lines(tmp_path):
    """``python -m openess_tpu_torch.train`` / ``.test`` on the synthetic
    sup_only config as a frame2voxel run, one epoch, on the CPU."""
    with open(os.path.join(ROOT, "configs/synthetic_sup_only.yaml")) as f:
        text = f.read()
    text = text.replace("config_option: 'frame2recon'",
                        "config_option: 'frame2voxel'")
    text = text.replace("num_epochs: 2", "num_epochs: 1")
    text = text.replace("log: 'log/synthetic_sup_only'",
                        f"log: '{tmp_path}/log'")
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(text)
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)

    def run(mod, *args):
        return subprocess.run(
            [sys.executable, "-m", f"openess_tpu_torch.{mod}",
             "--settings_file", str(cfg), *args],
            capture_output=True, text=True, cwd=str(tmp_path), env=env,
            timeout=600)

    r = run("train", "--no_log_dir", "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'miou'" in r.stdout
    ckpt_dir = tmp_path / "log" / "checkpoints"
    assert os.listdir(ckpt_dir) == ["ckpt_0.pt"]
    r = run("test", "--checkpoint", str(ckpt_dir), "--device", "cpu")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "'miou'" in r.stdout and "'acc'" in r.stdout
    if not torch.cuda.is_available():
        r = run("train", "--no_log_dir")
        assert r.returncode != 0
        assert "no CUDA device is available" in r.stderr
