"""The downstream stages of the port against the JAX package on the CPU:
linear probe and fine-tune with ``unfrozen_e2vid`` on the event path (f32,
32x64, T = 3, 6 classes, augmentation off, weights carried across through
the converters), the checkpoint chain pretrain -> linear probe -> fine-tune,
and the DDD17 streaming server.

Tolerances, with what was measured:
- ``trainable_labels``: the JAX label tree, pushed through the converters,
  equals the port's labels key by key.
- The head with ``linear_probe`` against flax: 1e-4 absolute.
- Loss dicts on the same voxel windows: 1e-5 relative (measured <= 1.9e-7).
- Gradients of ``linear_probe`` under linear probing, and of the head's
  convs without a norm behind them in the fine-tune: 3e-5 of the tensor's
  max (measured <= 4.7e-6); the updated ``linear_probe`` parameters 1e-6
  absolute where ``|g|`` is above 1e-4 of the largest gradient (the first
  Adam step is ``lr`` times the sign of ``g``).
- E2VID's gradients in the fine-tune: every one of its 14 tensors is
  non-zero and within 5e-3 of the tensor's max of JAX's (measured 8.4e-4).
  They pass the head's 16 instance norms, whose f32 backward is
  ill-conditioned at random init on either side; the pretrain step's
  instance-normalized convs needed 3e-2 at 64x96
  (``test_torch_train.py``), this size and these tensors need less.
- The DDD17 server against the JAX streaming step: logits within 3e-2 of
  the logit max and labels agreeing on >= 99 % of pixels, as for DSEC in
  ``test_torch_serve.py`` (measured 1.1e-2 to 1.3e-2 and 99.3 % to 99.4 %:
  the TPU voxelizer rounds its time weights to bf16, K4 does not).
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu.data.synthetic import SyntheticESS as JSynthetic
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
)
from openess_tpu_torch.training import checkpoint as ckpt
from openess_tpu_torch.training.build import build_models, trainable_labels
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder
from openess_tpu_torch.training.trainer import Trainer
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, C, T = 32, 64, 6, 3
LOSS_REL = 1e-5
PROBE_GRAD_REL = 3e-5
E2VID_GRAD_REL = 5e-3
UPDATE_ABS = 1e-6
COMMON = dict(
    dataset_name_b="synthetic_events", img_size_b=(H, W),
    semseg_num_classes=C, nr_events_data_b=T, compute_dtype="float32",
    data_augmentation_train=False, config_option="frame2voxel",
)
FINETUNE = dict(if_finetuning=True, unfrozen_e2vid=True,
                e2vid_fused_gates=True)
PROBE = dict(if_linear_probing=True)
LABEL_IDS = {"frozen": 0.0, "recon": 1.0, "frame": 2.0, "voxel": 3.0}


def jax_settings(**kw):
    s = JSettings()
    for k, v in {**COMMON, **kw}.items():
        setattr(s, k, v)
    s.__post_init__()
    return s


def torch_settings(**kw):
    return Settings(**{**COMMON, **kw})


def _event_state_dicts(tree, text):
    """JAX ``front_sensor_b`` / ``back_end`` trees -> the port's keys."""
    out = {f"front_sensor_b.{k}": v for k, v in
           e2vid_state_dict_from_jax(tree["front_sensor_b"]).items()}
    out.update({f"back_end.{k}": v for k, v in
                semseg_state_dict_from_jax(tree["back_end"], text).items()})
    return out


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture(scope="module")
def windows():
    """One batch of the synthetic dataset, voxelized once by the JAX
    package: both sides train on the same windows."""
    from openess_tpu.data.device_voxelize import voxelize_wire as jvox

    ds = JSynthetic(num_samples=2, height=H, width=W, num_classes=C,
                    num_windows=T)
    wire = ds.raw_wire_batch([0, 1])
    event = np.asarray(jvox(jax_settings(**PROBE),
                            jax.tree.map(jnp.asarray, wire)))
    batch = {k: v for k, v in wire.items() if not k.startswith("ev_")}
    batch["event"] = event
    return batch


def _one_step(kw, batch):
    """One train step of the workload ``kw`` on both sides."""
    from openess_tpu.training.build import build_models as jbuild
    from openess_tpu.training.build import trainable_labels as jlabels
    from openess_tpu.training.optim import make_optimizer as joptim
    from openess_tpu.training.steps import StepBuilder as JStepBuilder

    js = jax_settings(**kw)
    mset = jbuild(js, seed=0)
    labels = jlabels(mset, js)
    tx = joptim(js, labels, steps_per_epoch=2)
    sb = JStepBuilder(js, mset, tx)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params0 = jax.tree.map(np.array, mset.params)
    text = np.asarray(mset.text_embeddings)
    key, epoch = jax.random.key(0), jnp.asarray(0)

    @jax.jit
    def loss_and_grad(params):
        def f(p):
            total, losses, _ = sb.compute_losses(p, mset.batch_stats, jbatch,
                                                 key, epoch)
            return total, losses
        return jax.value_and_grad(f, has_aux=True)(params)

    (_, jlosses), jgrads = loss_and_grad(mset.params)
    jgrads = jax.tree.map(np.asarray, jgrads)
    # the update of StepBuilder.make_train_step, applied to the gradients
    # above: one compile of the backward per workload instead of two
    updates, _ = tx.update(jgrads, tx.init(mset.params), mset.params)
    params1 = jax.tree.map(np.asarray,
                           optax.apply_updates(mset.params, updates))

    ts = torch_settings(**kw)
    tm = build_models(ts, seed=0, device="cpu")
    for name, m in tm.modules.items():
        m.load_state_dict(
            {k[len(name) + 1:]: v for k, v in
             _event_state_dicts(params0, text).items()
             if k.startswith(name + ".")}, strict=True)
    before = {f"{n}.{k}": v.clone() for n, m in tm.modules.items()
              for k, v in m.state_dict().items()}
    opt = make_optimizer(ts, tm)
    tsb = StepBuilder(ts, tm, opt, steps_per_epoch=2)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tsb._set_mode(True)
    modes = {n: m.training for n, m in tm.modules.items()}
    total, tlosses = tsb.compute_losses(tbatch, 0)
    total.backward()
    tgrads = {f"{n}.{k}": p.grad.clone() for n, m in tm.modules.items()
              for k, p in m.named_parameters() if p.grad is not None}
    opt.zero_grad()
    step_losses = tsb.train_step(tbatch, 0)
    after = {f"{n}.{k}": v.clone() for n, m in tm.modules.items()
             for k, v in m.state_dict().items()}
    zeros = np.zeros_like(text)
    return dict(
        jlosses={k: float(v) for k, v in jlosses.items()},
        tlosses={k: float(v.detach()) for k, v in tlosses.items()},
        step_losses={k: float(v) for k, v in step_losses.items()},
        jgrads=_event_state_dicts(jgrads, zeros),
        jparams1=_event_state_dicts(params1, text), tgrads=tgrads,
        before=before, after=after, modes=modes, tm=tm, ts=ts, tsb=tsb,
        jlabels=labels, jparams0=params0, text=text, jmset=mset,
    )


@pytest.fixture(scope="module")
def probe(windows):
    return _one_step(PROBE, windows)


@pytest.fixture(scope="module")
def finetune(windows):
    return _one_step(FINETUNE, windows)


# ---------------------------------------------------------------------------
# build: labels, groups, the head's linear_probe conv
# ---------------------------------------------------------------------------


def _jax_labels_by_torch_key(run):
    """The JAX label tree as ``{port key: label}``: a tree of constant
    arrays carrying each leaf's label id goes through the converters."""
    ids = jax.tree.map(
        lambda lab, p: np.full(np.shape(p), LABEL_IDS[lab], np.float32),
        run["jlabels"], run["jparams0"])
    names = {v: k for k, v in LABEL_IDS.items()}
    sd = _event_state_dicts(ids, np.zeros_like(run["text"]))
    return {k: names[float(v.flatten()[0])] for k, v in sd.items()
            if not k.endswith("text_embeddings")}


@pytest.mark.parametrize("which", ["probe", "finetune"])
def test_trainable_labels_match_the_jax_tree(which, request):
    run = request.getfixturevalue(which)
    got = trainable_labels(run["tm"], run["ts"])
    assert got == _jax_labels_by_torch_key(run)
    trainable = {k for k, v in got.items() if v != "frozen"}
    if which == "probe":
        assert trainable == {"back_end.linear_probe.weight",
                             "back_end.linear_probe.bias"}
    else:
        assert len(trainable) == len(got) == 14 + 36
    opt = make_optimizer(run["ts"], run["tm"])
    assert [g["name"] for g in opt.param_groups] == ["voxel"]
    assert len(opt.param_groups[0]["params"]) == len(trainable)
    for name, m in run["tm"].modules.items():
        for k, p in m.named_parameters():
            assert p.requires_grad == (got[f"{name}.{k}"] != "frozen")


def test_finetune_without_unfrozen_e2vid_and_frozen_backbone(finetune):
    """E2VID trains only under ``unfrozen_e2vid and if_finetuning``;
    ``frozen_backbone`` acts on the DeepLabV3 student's backbone only, so
    it changes nothing on the event path. Both as in the JAX package."""
    from openess_tpu.training.build import trainable_labels as jlabels

    for kw in (dict(if_finetuning=True),
               dict(if_finetuning=True, frozen_backbone=True),
               dict(if_finetuning=True, unfrozen_e2vid=True,
                    frozen_backbone=True),
               dict(if_supervised_only=True, unfrozen_e2vid=True)):
        ts = torch_settings(**kw)
        tm = build_models(ts, seed=0, device="cpu")
        got = trainable_labels(tm, ts)
        run = dict(finetune, jlabels=jlabels(finetune["jmset"],
                                             jax_settings(**kw)))
        assert got == _jax_labels_by_torch_key(run), kw
        trains = kw.get("unfrozen_e2vid") and kw.get("if_finetuning")
        assert {v for k, v in got.items() if k.startswith("front_sensor_b.")
                } == {"voxel" if trains else "frozen"}
        # a frozen E2VID is stored in the compute dtype, a trainable one in
        # f32 (here both f32); the head always trains here
        assert {v for k, v in got.items() if k.startswith("back_end.")
                } == {"voxel"}


def test_e2vid_storage_dtype_follows_trainability():
    frozen = build_models(torch_settings(
        if_finetuning=True, compute_dtype="bfloat16"), device="cpu")
    trains = build_models(torch_settings(
        **{**FINETUNE, "compute_dtype": "bfloat16"}), device="cpu")
    fd = {v.dtype for v in frozen.modules["front_sensor_b"].parameters()}
    td = {v.dtype for v in trains.modules["front_sensor_b"].parameters()}
    assert fd == {torch.bfloat16} and td == {torch.float32}
    assert sorted(frozen.modules["front_sensor_b"].state_dict()) == sorted(
        trains.modules["front_sensor_b"].state_dict())
    # f32 master weights, bf16 compute: the latent comes out in bf16
    win = torch.zeros(1, 2, 5, H, W, dtype=torch.bfloat16)
    _, latent = trains.modules["front_sensor_b"](win)
    assert {v.dtype for v in latent.values()} == {torch.bfloat16}


def test_head_with_linear_probe_matches_flax(probe):
    from openess_tpu.models import SemSegE2VID as JHead
    from openess_tpu_torch.models import SemSegE2VID

    rng = np.random.default_rng(5)
    latent = {k: rng.normal(size=(2, H // s, W // s, c)).astype(np.float32)
              for k, s, c in (("2", 2, 64), ("4", 4, 128), ("8", 8, 256))}
    head = JHead(input_c=256, num_classes=C, linear_probe=True)
    ref, ref_feat = head.apply(
        {"params": probe["jparams0"]["back_end"]},
        {k: jnp.asarray(v) for k, v in latent.items()},
        jnp.asarray(probe["text"]))
    thead = SemSegE2VID(input_c=256, num_classes=C, linear_probe=True)
    sd = semseg_state_dict_from_jax(probe["jparams0"]["back_end"],
                                    probe["text"])
    assert {"linear_probe.weight", "linear_probe.bias"} <= set(sd)
    assert sd["linear_probe.weight"].shape == (C, C, 1, 1)
    thead.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got, feat = thead({k: torch.from_numpy(v) for k, v in latent.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(ref_feat), atol=1e-4)


# ---------------------------------------------------------------------------
# one train step of each workload against StepBuilder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["probe", "finetune"])
def test_loss_dict_matches_stepbuilder(which, request):
    run = request.getfixturevalue(which)
    assert set(run["jlosses"]) == {"semseg_loss", "total_loss"}
    for name in ("tlosses", "step_losses"):
        assert set(run[name]) == set(run["jlosses"])
        for k, ref in run["jlosses"].items():
            assert _rel(run[name][k], ref) <= LOSS_REL, (name, k)


def test_linear_probe_trains_only_the_probe(probe):
    tg, jg = probe["tgrads"], probe["jgrads"]
    assert set(tg) == {"back_end.linear_probe.weight",
                       "back_end.linear_probe.bias"}
    gmax = max(float(jg[k].abs().max()) for k in tg)
    for k in tg:
        scale = float(jg[k].abs().max())
        assert scale > 0
        assert float((tg[k] - jg[k]).abs().max()) <= PROBE_GRAD_REL * scale
        mask = jg[k].abs() > 1e-4 * gmax
        assert mask.any()
        diff = (probe["after"][k] - probe["jparams1"][k]).abs()[mask]
        assert float(diff.max()) <= UPDATE_ABS, k
        assert not torch.equal(probe["after"][k], probe["before"][k])
    # everything else is bit for bit what it was, on both sides
    for k, v in probe["before"].items():
        if "linear_probe" not in k:
            assert torch.equal(v, probe["after"][k]), k
            assert torch.equal(v, probe["jparams1"][k]), k
    # frozen modules stay in eval mode in a train step; the head, which
    # holds the probe, trains
    assert probe["modes"] == {"front_sensor_b": False, "back_end": True}


def test_finetune_gradients_reach_e2vid_and_match_stepbuilder(finetune):
    tg, jg = finetune["tgrads"], finetune["jgrads"]
    e2vid = [k for k in jg if k.startswith("front_sensor_b.")]
    assert len(e2vid) == 14
    worst = 0.0
    for k in e2vid:
        scale = float(jg[k].abs().max())
        assert scale > 0 and float(tg[k].abs().max()) > 0, k
        rel = float((tg[k] - jg[k]).abs().max()) / scale
        worst = max(worst, rel)
        assert rel <= E2VID_GRAD_REL, (k, rel)
    # the head's convs without a norm behind them compare tightly
    for k in ("back_end.decoder_ch256.0.weight",
              "back_end.decoder_ch512.0.weight"):
        assert float((tg[k] - jg[k]).abs().max()) <= PROBE_GRAD_REL * float(
            jg[k].abs().max())
    # every parameter of both modules moved, the text embeddings did not
    for k, v in finetune["before"].items():
        moved = not torch.equal(v, finetune["after"][k])
        assert moved == (not k.endswith("text_embeddings")), k
    assert finetune["modes"] == {"front_sensor_b": True, "back_end": True}


def test_eval_and_viz_never_attach_the_latent(finetune):
    """Only a train step keeps E2VID in the graph."""
    tsb = finetune["tsb"]
    tsb._set_mode(True)
    batch = {"event": torch.zeros(1, T, 5, H, W)}
    logits, _ = tsb._event_path(batch, train=True)
    assert logits.requires_grad
    e2vid = finetune["tm"].modules["front_sensor_b"]
    (g,) = torch.autograd.grad(
        logits.sum(), e2vid.unetrecurrent.head.conv2d.bias)
    assert g.abs().max() > 0
    logits, _ = tsb._event_path(batch)
    (g,) = torch.autograd.grad(
        logits.sum(), e2vid.unetrecurrent.head.conv2d.bias,
        allow_unused=True)
    assert g is None  # detached: only the head is in the graph
    pred, loss = tsb.eval_step(dict(batch, label=torch.zeros(
        1, H, W, dtype=torch.int64)))
    assert not loss.requires_grad and pred.shape == (1, H, W)


# ---------------------------------------------------------------------------
# the stages chained through checkpoints
# ---------------------------------------------------------------------------


class _OneBatch:
    def __init__(self, batch, n):
        self.batch, self.n = batch, n

    def __len__(self):
        return self.n

    def get_batch(self, idx):
        return dict(self.batch)


def test_pretrain_checkpoint_feeds_linear_probe_and_finetune(windows,
                                                             tmp_path):
    """pretrain (bf16: E2VID stored in bf16) -> linear probe -> fine-tune
    (E2VID in f32), each stage loading the one before through
    ``Trainer``'s ``load_pretrained_weights``: shape-filtered, never the
    ``linear_probe`` conv."""
    batch = dict(windows)
    data = _OneBatch(batch, 2)
    kw = dict(batch_size_b=2, num_epochs=1, compute_dtype="bfloat16")
    pre = torch_settings(if_pretraining=True, teacher_os=16,
                         superpixel_size=20, **kw)
    pre.ckpt_dir = str(tmp_path / "pre")
    t0 = Trainer(pre, data, device="cpu", seed=0)
    t0.pretraining()
    assert os.listdir(pre.ckpt_dir) == ["ckpt_0.pt"]
    pre_sd = t0.mset.state_dict()
    assert pre_sd["front_sensor_b"][
        "unetrecurrent.head.conv2d.weight"].dtype == torch.bfloat16

    lp = torch_settings(**PROBE, load_pretrained_weights=True,
                        pretrained_file=pre.ckpt_dir, **kw)
    lp.ckpt_dir = str(tmp_path / "lp")
    fresh = build_models(lp, seed=3, device="cpu").state_dict()
    t1 = Trainer(lp, data, data, device="cpu", seed=3)
    sd = t1.mset.state_dict()
    for name in ("front_sensor_b", "back_end"):
        for k, v in sd[name].items():
            if "linear_probe" in k:  # not in the checkpoint: fresh
                assert torch.equal(v, fresh[name][k])
            else:
                assert torch.equal(v, pre_sd[name][k]), k
    t1.training()
    probe1 = t1.mset.state_dict()["back_end"]["linear_probe.weight"].clone()
    assert not torch.equal(probe1, fresh["back_end"]["linear_probe.weight"])

    ft = torch_settings(**FINETUNE, load_pretrained_weights=True,
                        pretrained_file=lp.ckpt_dir, **kw)
    t2 = Trainer(ft, data, data, device="cpu", seed=4)
    sd = t2.mset.state_dict()
    # the fine-tune's head has no linear_probe; its E2VID is f32 and holds
    # the checkpoint's bf16 values exactly
    assert not any("linear_probe" in k for k in sd["back_end"])
    w = sd["front_sensor_b"]["unetrecurrent.head.conv2d.weight"].clone()
    assert w.dtype == torch.float32
    assert torch.equal(w, pre_sd["front_sensor_b"][
        "unetrecurrent.head.conv2d.weight"].float())
    assert torch.equal(sd["back_end"]["decoder_ch256.0.weight"],
                       pre_sd["back_end"]["decoder_ch256.0.weight"])
    losses = t2.train_epoch()
    assert set(losses) == {"semseg_loss", "total_loss"}
    assert np.isfinite(losses["semseg_loss"])
    w1 = t2.mset.state_dict()["front_sensor_b"][
        "unetrecurrent.head.conv2d.weight"]
    assert not torch.equal(w1, w)
    # a linear-probe checkpoint restored into a linear-probe build keeps
    # the probe; load_pretrained_params with the exclusion does not
    again = build_models(lp, seed=9, device="cpu")
    ckpt.load_model_only(lp.ckpt_dir, again)
    assert torch.equal(again.state_dict()["back_end"]["linear_probe.weight"],
                       probe1)
    taken = ckpt.load_pretrained_params(
        lp.ckpt_dir, again, exclude_substrings=("linear_probe",))
    assert taken and not any("linear_probe" in k for k in taken)


# ---------------------------------------------------------------------------
# DDD17: settings dispatch and the streaming server
# ---------------------------------------------------------------------------

DDD17_YAML = "configs/linear_probe/DDD17/frame2voxel_fcclip_slic.yaml"


def test_shipped_ddd17_linear_probe_yaml_dispatches_to_pretrain():
    """The shipped file leaves ``if_pretraining`` true, so both packages
    dispatch it to pretrain; with it false it is a linear probe on DDD17
    at 200x352 with 6 classes."""
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu.training.build import task_from_settings as jtask
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.training.build import task_from_settings

    path = os.path.join(ROOT, DDD17_YAML)
    s = load_settings(path)
    assert task_from_settings(s) == jtask(jload(path)) == "pretrain"
    s = dataclasses.replace(s, if_pretraining=False)
    assert task_from_settings(s) == "linear_probe"
    assert tuple(s.img_size_b) == (200, 352) and s.semseg_num_classes == 6
    assert s.nr_events_window_b == 32000 and not s.separate_pol_b


@pytest.fixture(scope="module")
def ddd17_serving():
    from openess_tpu.config.settings import load_settings as jload
    from openess_tpu.data.device_voxelize import voxelize_wire as jvox
    from openess_tpu.models.e2vid import E2VIDStreamingStep as JStep
    from openess_tpu.models.e2vid import initial_stream_state as jinit
    from openess_tpu.training.build import build_models as jbuild
    from openess_tpu.training.steps import StepBuilder as JStepBuilder
    from openess_tpu_torch.config.settings import load_settings
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import StreamServer, synthetic_windows

    path = os.path.join(ROOT, DDD17_YAML)
    js, ts = jload(path), load_settings(path)
    for s in (js, ts):
        s.if_pretraining = False
        s.compute_dtype = "float32"
    js.batch_size_b = 1
    mset = jbuild(js, seed=0)
    sb = JStepBuilder(js, mset)
    stream = JStep(num_bins=js.input_channels_b, normalize=True,
                   dtype=jnp.float32, latent_only=True)
    params = mset.params

    @jax.jit  # the serving step of tools/serve_stream.py
    def jstep(carry, batch):
        window = jvox(js, batch)[:, 0]
        st, latent, _ = stream.apply(
            {"params": params["front_sensor_b"]}, carry, window)
        (logits, _), _ = sb._apply(
            "back_end", params, mset.batch_stats, latent,
            mset.text_embeddings, train=False)
        return tuple(st), jnp.argmax(logits, axis=-1).astype(jnp.uint8), \
            logits

    server = StreamServer(ts, streams=1, device="cpu")
    tree = jax.tree_util.tree_map(np.asarray, params)
    sd = _event_state_dicts(tree, np.asarray(mset.text_embeddings))
    server.models.e2vid.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in sd.items()
         if k.startswith("front_sensor_b.")}, strict=True)
    server.models.head.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in sd.items()
         if k.startswith("back_end.")}, strict=True)
    jc, tc = tuple(jinit(1, 200, 352)), server.initial_state()
    out = []
    for x, y, p, t in synthetic_windows(2, 3000, server.sensor_h,
                                        server.sensor_w):
        batch = server.pack(x, y, p, t)
        jc, jlab, jlog = jstep(jc, batch)
        tc, tlab, tlog = server.step(tc, upload_wire(batch, "cpu"))
        out.append((np.asarray(jlab), np.asarray(jlog), tlab.numpy(),
                    tlog.numpy()))
    return server, out


def test_ddd17_server_matches_the_jax_streaming_step(ddd17_serving):
    server, out = ddd17_serving
    assert (server.sensor_h, server.sensor_w) == (260, 346)
    assert server.integer_coords
    assert (server.height, server.width) == (200, 352)
    assert server.models.head.linear_probe is not None
    for jlab, jlog, tlab, tlog in out:
        assert tlab.dtype == np.uint8 and tlab.shape == (1, 200, 352)
        assert tlog.shape == jlog.shape == (1, 200, 352, 6)
        assert np.abs(tlog - jlog).max() <= 3e-2 * np.abs(jlog).max()
        assert (tlab == jlab).mean() >= 0.99
