"""The frame/recon workloads of the port against the JAX package's
``StepBuilder`` on the CPU (f32, 64x96, B = 2, 6 classes, T = 3 windows
where an event path runs; augmentation and dropout off, weights carried
across through the converters): pretrain ``frame2recon`` (with and without
SAM distillation), the fine-tune with ``frozen_backbone``, the linear
probe and ``sup_only`` on ``frame2recon``, and
(``test_torch_uda_train.py``) UDA on the three options. For each branch:
the loss dict, the gradients, one AdamW update, the BatchNorm running
statistics the step leaves, and the eval step (the viz step on one
branch of each file).

The branches' logic is under test, so every ResNet-50 of both packages
is built with one bottleneck a stage (:func:`shallow_trunks`); the full
depth is held by ``test_torch_deeplab.py`` and ``test_torch_teacher.py``.
Dropout is off on both sides: flax's ``Dropout`` is an identity inside
these tests and the port's rate is 0. The DeepLabV3 students run with
``train=True`` on both sides, so their BatchNorms take batch statistics.
Each student's bottleneck ``bn3`` scales are drawn from U(0.02, 0.06)
(:func:`_small_residual_scales`); at flax's identity init the f32 backward
of a train-mode ResNet-50 explodes on either side, and no tolerance could
tell a wrong gradient from rounding.

Tolerances, with what was measured (worst over the branches):
- Losses: 1e-4 relative (measured <= 1.8e-5).
- Gradients: each tensor's relative L2 error 6e-2, and its median over a
  branch's tensors 3e-2 (measured: medians 2.7e-5 to 1.5e-2, worst tensor
  2.5e-2, in the trunk's BNs: the f32 backward through train-mode
  BatchNorms of batch 2 on either side). The linear probe's conv, behind
  no norm, 1e-4. The head's conv biases in front of an instance norm have
  a zero gradient; both sides give noise below 1e-4 of the head's weight
  gradients (``test_torch_train.py``).
- The AdamW update: the first step is ``lr * sign(g)`` plus the weight
  decay, so the new parameters are compared where ``|g|`` is above 1e-2 of
  the tensor's max gradient: to 1e-6, except where the two gradients'
  signs differ, which at most 5e-4 of those elements may (measured
  up to 2.0e-4), and there by at most ``2 lr``. Frozen parameters stay
  bit for bit.
- Running statistics: 2e-3 of each tensor's max, as in
  ``test_torch_deeplab.py`` (measured <= 7.8e-5).
- Eval and viz steps: predictions agree on >= 99.9 % of the pixels, the
  eval loss 1e-5 relative, the viz features 1e-4 of their max.
"""
import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.data.synthetic import SyntheticESS
from openess_tpu_torch.models.convert import (
    deeplab_state_dict_from_jax,
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
    teacher_state_dict_from_jax,
)
from openess_tpu_torch.training.build import build_models, trainable_labels
from openess_tpu_torch.training.optim import make_optimizer
from openess_tpu_torch.training.steps import StepBuilder
from test_torch_deeplab import _NoDropout
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

H, W, C, T = 64, 96, 6, 3
SHALLOW = (1, 1, 1, 1)  # bottlenecks a stage of every ResNet-50 here
LOSS_REL = 1e-4
GRAD_L2_REL = 6e-2
GRAD_L2_MEDIAN = 3e-2
PROBE_GRAD_REL = 1e-4
UPDATE_ABS = 1e-6
UPDATE_MASK = 1e-2
UPDATE_FLIPS = 5e-4
STATS_REL = 2e-3
COMMON = dict(
    dataset_name_b="synthetic_events", img_size_b=(H, W),
    semseg_num_classes=C, nr_events_data_b=T, compute_dtype="float32",
    data_augmentation_train=False, superpixel_size=20, lr_recon=1e-3,
    lr_frame=1e-3, lr_voxel=1e-3,
)
RECON = dict(config_option="frame2recon")
BRANCHES = {
    "pretrain": dict(RECON, if_pretraining=True, if_spatial_contrastive=True,
                     if_dense_clip_supervision=True),
    "pretrain_sam": dict(RECON, if_pretraining=True,
                         if_spatial_contrastive=True,
                         if_dense_clip_supervision=True,
                         if_sam_distillation=True, weight_task_loss=0.5),
    "finetune_frozen_backbone": dict(RECON, if_finetuning=True,
                                     frozen_backbone=True),
    "linear_probe": dict(RECON, if_linear_probing=True),
    "sup_only": dict(RECON, if_supervised_only=True),
}


def _small_residual_scales(backbone, rng):
    """Each bottleneck's last BatchNorm scale drawn from U(0.02, 0.06), a
    step towards torchvision's ``zero_init_residual``: at flax's identity
    init the train-mode backward through the 16 residual blocks explodes,
    and the port's f32 gradients sit 2.5 to 6.6 % (L2, every tensor alike)
    from its f64 ones."""
    for key, block in backbone.items():
        if key.startswith("layer"):
            n = block["bn3"]["scale"].shape
            block["bn3"]["scale"] = rng.uniform(0.02, 0.06, n).astype(
                np.float32)


def shallow_trunks(monkeypatch):
    """Every ResNet-50 of both packages (the students' and the teacher's
    trunks) built with one bottleneck a stage, ``layers=(1, 1, 1, 1)``:
    the branches' logic is under test here, and the full depth is
    ``test_torch_deeplab.py``'s and ``test_torch_teacher.py``'s."""
    import openess_tpu.models.deeplabv3 as jdeeplab
    import openess_tpu.models.image_teacher as jteacher
    import openess_tpu_torch.models.deeplabv3 as tdeeplab
    import openess_tpu_torch.models.image_teacher as tteacher

    for module in (jdeeplab, jteacher, tdeeplab, tteacher):
        monkeypatch.setattr(module, "ResNet50", functools.partial(
            module.ResNet50, layers=SHALLOW))


def jax_settings(**kw):
    s = JSettings()
    for k, v in {**COMMON, **kw}.items():
        setattr(s, k, v)
    s.__post_init__()
    return s


def torch_settings(**kw):
    return Settings(**{**COMMON, **kw})


def batch_for(kw):
    """Two synthetic samples; the voxel options get the windows voxelized
    by the exact scatter, fed to both sides."""
    ds = SyntheticESS(num_samples=2, height=H, width=W, num_classes=C,
                      num_windows=T)
    batch = ds.voxelized_batch([0, 1])
    batch["event"] = batch["event"].numpy()
    if kw["config_option"] == "frame2recon":
        del batch["event"]
    return batch


def state_dicts(roles, tree, stats, text):
    """JAX trees -> ``{"<module>.<key>": tensor}`` with the port's keys."""
    out = {}
    for name, role in roles.items():
        if role == "e2vid":
            sd = e2vid_state_dict_from_jax(tree[name])
        elif role == "semseg_head":
            sd = semseg_state_dict_from_jax(tree[name], text)
        elif role == "teacher":
            sd = teacher_state_dict_from_jax(tree[name], stats[name])
        else:
            sd = deeplab_state_dict_from_jax(tree[name], stats[name], text)
        out.update({f"{name}.{k}": v for k, v in sd.items()})
    return out


def one_step(kw, monkeypatch, viz=False):
    """One train step of the workload ``kw`` on both sides: the losses,
    the gradients, the running statistics the step's forward leaves, the
    parameters after one AdamW update, and the eval step (and, given
    ``viz``, the viz step) on the same batch from the same start."""
    from openess_tpu.training.build import build_models as jbuild
    from openess_tpu.training.build import trainable_labels as jlabels
    from openess_tpu.training.optim import make_optimizer as joptim
    from openess_tpu.training.steps import StepBuilder as JStepBuilder

    monkeypatch.setattr(fnn, "Dropout", _NoDropout)
    shallow_trunks(monkeypatch)
    batch = batch_for(kw)
    js = jax_settings(**kw)
    mset = jbuild(js, seed=0)
    tx = joptim(js, jlabels(mset, js), steps_per_epoch=2)
    sb = JStepBuilder(js, mset, tx)
    jbatch = jax.tree.map(jnp.asarray, batch)
    params0 = jax.tree.map(np.array, mset.params)
    stats0 = jax.tree.map(np.array, mset.batch_stats)
    rng = np.random.default_rng(7)
    for name, role in mset.roles.items():
        if role == "deeplab":
            _small_residual_scales(params0[name]["backbone"], rng)
    jparams = jax.tree.map(jnp.asarray, params0)
    text = np.asarray(mset.text_embeddings)
    key, epoch = jax.random.key(0), jnp.asarray(0)

    @jax.jit
    def loss_and_grad(params):
        def f(p):
            total, losses, new_bs = sb.compute_losses(
                p, mset.batch_stats, jbatch, key, epoch)
            return total, (losses, new_bs)
        return jax.value_and_grad(f, has_aux=True)(params)

    # the update of StepBuilder.make_train_step, applied to the gradients
    # above: one compile of the backward per workload instead of two
    (_, (jlosses, jstats1)), jgrads = loss_and_grad(jparams)
    jgrads = jax.tree.map(np.asarray, jgrads)
    jstats1 = jax.tree.map(np.asarray, jstats1)
    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    params1 = jax.tree.map(np.asarray, optax.apply_updates(jparams, updates))
    pred, loss = sb.make_eval_step()(jparams, mset.batch_stats, jbatch)
    jeval = [np.asarray(pred), float(loss)]
    if viz:
        vpred, vfeat = sb.make_viz_step()(jparams, mset.batch_stats, jbatch)
        jeval += [np.asarray(vpred), np.asarray(vfeat)]
    roles = dict(mset.roles)

    ts = torch_settings(**kw)
    tm = build_models(ts, seed=0, device="cpu")
    assert dict(tm.roles) == roles
    sd0 = state_dicts(roles, params0, stats0, text)
    for name, m in tm.modules.items():
        m.load_state_dict({k[len(name) + 1:]: v for k, v in sd0.items()
                           if k.startswith(name + ".")}, strict=True)
        if roles[name] == "deeplab":
            m.classifier.ASPP.dropout_rate = 0.0
    opt = make_optimizer(ts, tm)
    tsb = StepBuilder(ts, tm, opt, steps_per_epoch=2)
    tbatch = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in batch.items()}
    start = {f"{n}.{k}": v.clone() for n, m in tm.modules.items()
             for k, v in m.state_dict().items()}
    # eval mode leaves parameters and statistics alone: the eval (and viz)
    # step first, then one train step from the same start, whose
    # gradients stay in .grad and whose forward updated the statistics
    pred, loss = tsb.eval_step(tbatch)
    teval = [pred.numpy(), float(loss)]
    if viz:
        vpred, vfeat = tsb.viz_step(tbatch)
        teval += [vpred.numpy(), vfeat.numpy()]
    step_losses = tsb.train_step(tbatch, 0)
    tgrads = {f"{n}.{k}": p.grad.clone() for n, m in tm.modules.items()
              for k, p in m.named_parameters() if p.grad is not None}
    tstats1 = {f"{n}.{k}": v.clone() for n, m in tm.modules.items()
               for k, v in m.state_dict().items() if "running" in k}
    return dict(
        kw=kw, ts=ts, tm=tm, roles=roles, text=text, stats0=stats0,
        jlosses={k: float(v) for k, v in jlosses.items()},
        step_losses={k: float(v) for k, v in step_losses.items()},
        jgrads=state_dicts(roles, jgrads, stats0, np.zeros_like(text)),
        tgrads=tgrads, start=start,
        jstats1=state_dicts(roles, params0, jstats1, text),
        tstats1=tstats1,
        params1=state_dicts(roles, params1, stats0, text),
        jeval=jeval, teval=teval, optimizer=opt,
    )


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def check_losses(run, keys):
    assert set(run["jlosses"]) == set(run["step_losses"]) == keys
    for k in keys:
        assert _rel(run["step_losses"][k], run["jlosses"][k]) <= LOSS_REL, k


def _is_param(key):
    return not (key.endswith(("running_mean", "running_var",
                              "text_embeddings", "num_batches_tracked")))


def check_gradients(run):
    """Every trainable tensor got a gradient close to JAX's; nothing
    frozen got one. Returns the number of tensors compared."""
    labels = trainable_labels(run["tm"], run["ts"])
    jg, tg = run["jgrads"], run["tgrads"]
    assert set(tg) == {k for k, v in labels.items() if v != "frozen"}
    head_scale = max((float(v.abs().max()) for k, v in jg.items()
                      if k.startswith("back_end.") and k.endswith("weight")),
                     default=0.0)
    errs = []
    for k, got in tg.items():
        ref = jg[k]
        if k.startswith("back_end.decoder_scale") and k.endswith("bias"):
            # a bias in front of an instance norm: zero gradient, f32 noise
            assert float(ref.abs().max()) <= 1e-4 * head_scale, k
            assert float(got.abs().max()) <= 1e-4 * head_scale, k
            continue
        assert float(ref.abs().max()) > 0, k
        if "linear_probe" in k:
            err = float((got - ref).abs().max() / ref.abs().max())
            assert err <= PROBE_GRAD_REL, k
        else:
            errs.append(float((got - ref).norm() / ref.norm()))
            assert errs[-1] <= GRAD_L2_REL, k
    assert not errs or float(np.median(errs)) <= GRAD_L2_MEDIAN
    return len(tg)


def check_update(run):
    """One AdamW update matches JAX's where the gradient is clear of the
    noise; frozen parameters stay bit for bit."""
    tm, jg = run["tm"], run["jgrads"]
    labels = trainable_labels(tm, run["ts"])
    lr = {g["name"]: g["lr"] for g in run["optimizer"].param_groups}
    compared = flipped = 0
    for name, m in tm.modules.items():
        for k, p in m.named_parameters():
            full = f"{name}.{k}"
            if labels[full] == "frozen":
                assert torch.equal(p.detach(), run["start"][full]), full
                continue
            g = jg[full].abs()
            mask = g > UPDATE_MASK * float(g.max())
            diff = (p.detach() - run["params1"][full]).abs()[mask]
            assert float(diff.max()) <= 2 * lr[labels[full]] + UPDATE_ABS
            compared += int(mask.sum())
            flipped += int((diff > UPDATE_ABS).sum())
    assert compared > 0
    assert flipped <= UPDATE_FLIPS * compared, (flipped, compared)
    return compared


def check_stats(run):
    """The running statistics after ``compute_losses``: JAX's new
    ``batch_stats`` for the students, the teacher's untouched."""
    checked = 0
    for k, got in run["tstats1"].items():
        name = k.split(".")[0]
        want = run["jstats1"][k]
        if run["roles"][name] == "teacher":
            assert torch.equal(got, run["start"][k]), k
            continue
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= STATS_REL * scale, k
        assert not torch.equal(got, run["start"][k]), k
        checked += 1
    return checked


@pytest.fixture(scope="module", params=list(BRANCHES))
def run(request):
    with pytest.MonkeyPatch.context() as mp:
        yield request.param, one_step(BRANCHES[request.param], mp,
                                      viz=request.param == "pretrain")


KEYS = {
    "pretrain": {"contrastive_nce_loss", "dense_clip_loss", "total_loss"},
    "pretrain_sam": {"contrastive_nce_loss", "dense_clip_loss",
                     "sam_distillation_loss", "total_loss"},
    "finetune_frozen_backbone": {"semseg_loss", "total_loss"},
    "linear_probe": {"semseg_loss", "total_loss"},
    "sup_only": {"semseg_loss", "total_loss"},
}


def test_loss_dict_matches_stepbuilder(run):
    name, r = run
    check_losses(r, KEYS[name])


def test_gradients_match_stepbuilder(run):
    name, r = run
    n = check_gradients(r)
    if name == "linear_probe":
        assert n == 2  # linear_probe.weight and .bias alone
    elif name == "finetune_frozen_backbone":
        assert not any(".backbone." in k for k in r["tgrads"])
        assert n == 2 * 7 + 7  # the head's 7 BNs (2 each) and 7 convs
    elif name.startswith("pretrain"):
        assert {k for k in r["tgrads"] if k.startswith("model_frame.")} == {
            "model_frame.decoder_conv.weight", "model_frame.decoder_conv.bias"}


def test_one_adamw_update_matches_stepbuilder(run):
    _, r = run
    check_update(r)


def student_bns(run):
    """BatchNorms of the DeepLabV3 students of a run."""
    return sum(isinstance(m, torch.nn.BatchNorm2d)
               for name, student in run["tm"].modules.items()
               if run["roles"][name] == "deeplab"
               for m in student.modules())


def test_running_statistics_match_stepbuilder(run):
    """A DeepLabV3 student takes batch statistics in every train step,
    also where none of its parameters train (the linear probe)."""
    name, r = run
    assert student_bns(r) == 17 + 7  # the shallow trunk's and the head's
    assert check_stats(r) == 2 * student_bns(r)


def test_eval_and_viz_steps_match(run):
    """The eval step on every branch; the viz step (the same forward,
    another output) on one."""
    _, r = run
    jpred, jloss, *jviz = r["jeval"]
    tpred, tloss, *tviz = r["teval"]
    assert tpred.shape == jpred.shape == (2, H, W)
    assert (tpred == jpred).mean() >= 0.999
    assert _rel(tloss, jloss) <= 1e-5
    if jviz:
        (jvpred, jvfeat), (tvpred, tvfeat) = jviz, tviz
        assert (tvpred == jvpred).mean() >= 0.999
        assert tvfeat.shape == (2, H, W, 256)
        assert np.abs(tvfeat - jvfeat).max() <= 1e-4 * np.abs(jvfeat).max()
