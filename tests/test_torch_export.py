"""The serving export of the port (``openess_tpu_torch/export_model.py``,
``serve_stream --artifact``) and K3's ``torch.library`` ops, on the CPU in
f32 at 64x96, T = 2, 6 classes, B = 2.

- The ops: ``torch.library.opcheck`` on ``lstm_gates_fwd`` and
  ``lstm_gates_bwd`` (schema, fake implementation, autograd registration,
  AOT dispatch) in f32 and bf16; ``fused_lstm_gates`` through the op
  equals the plain version bit for bit, and its gradient is the plain
  backward's.
- Against eager: the exported streaming and batch programs (the voxel
  options and ``frame2recon``), saved and loaded, against the modules they
  were traced from: labels equal, logits and carry within 1e-5 (measured
  0: the same CPU kernels in the same order). One ``--poly_batch``
  artifact serves B = 2 and B = 3.
- Against JAX: the same weights carried from the JAX package's model set
  by the converters, the artifacts against ``tools/export_model.py``'s
  ``build_streaming_fn`` over 3 windows and ``build_infer_fn``, under
  ``jax.jit``, on the same random grids: logits within 1e-4 of the max,
  at least 99 % of the labels equal (measured 1.1e-5 to 1.4e-5 of the
  max, 99.99 % to 100 % of the labels).
- The command line with ``--selfcheck`` in one subprocess, and its two
  refusals; the server on a streaming artifact against the live server
  (labels equal window by window) and its refusals.

The JAX model set is built once, the port's weights carried across once,
and each artifact exported once, in module fixtures; the weight draws of
``build_models`` are skipped where the weights are overwritten or only
the export's equality with eager is under test.
"""
import contextlib
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from openess_tpu.config.settings import Settings as JSettings
from openess_tpu_torch import export_model as em
from openess_tpu_torch.config.settings import Settings
from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
)
from openess_tpu_torch.models.e2vid import initial_stream_state
from openess_tpu_torch.ops import lstm_gates as k3
from openess_tpu_torch.training import build
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, T, B, CLASSES = 64, 96, 2, 2, 6
EAGER_ATOL = 1e-5
JAX_REL = 1e-4
JAX_AGREE = 0.99
COMMON = dict(dataset_name_b="synthetic_events", img_size_b=(H, W),
              semseg_num_classes=CLASSES, nr_events_data_b=T,
              compute_dtype="float32", batch_size_b=B,
              if_supervised_only=True)
VOXEL = dict(COMMON, config_option="frame2voxel")


def torch_settings(**kw):
    return Settings(**kw)


def jax_settings(**kw):
    s = JSettings()
    for k, v in kw.items():
        setattr(s, k, v)
    s.__post_init__()
    return s


def grids(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 0.5, shape).astype(
        np.float32)


def _gate_inputs(dtype, seed=3):
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.normal(0, 2, (2, 3, 5, 32)).astype(np.float32))
    pc = torch.from_numpy(rng.normal(0, 1, (2, 3, 5, 8)).astype(np.float32))
    return g.to(dtype), pc.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
@pytest.mark.parametrize("missing", [None, "dh", "dc_next"])
def test_ops_pass_opcheck(dtype, missing):
    """Both ops' registrations (schema, fake, autograd, AOT dispatch) on
    CPU tensors; the backward also with either gradient ``None``."""
    g, pc = _gate_inputs(dtype)
    if missing is None:
        torch.library.opcheck(torch.ops.openess_tpu_torch.lstm_gates_fwd,
                              (g.requires_grad_(), pc.requires_grad_()))
    grads = dict(dh=torch.ones_like(pc), dc_next=-torch.ones_like(pc))
    if missing:
        grads[missing] = None
    torch.library.opcheck(torch.ops.openess_tpu_torch.lstm_gates_bwd,
                          (g.detach(), pc.detach(), grads["dh"],
                           grads["dc_next"]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_fused_gates_through_the_op_equal_plain(dtype):
    """On the CPU the forward op is the plain version and its autograd
    formula the plain backward, with no kernel launch counted; the cell
    state nobody consumes reaches the backward as zero."""
    g, pc = (t.requires_grad_() for t in _gate_inputs(dtype))
    f0, b0 = k3.fused_lstm_gates.launches, k3.fused_lstm_gates_bwd.launches
    h, c = k3.fused_lstm_gates(g, pc)
    hp, cp = k3.fused_lstm_gates_plain(g.detach(), pc.detach())
    assert torch.equal(h, hp) and torch.equal(c, cp)
    dh = torch.from_numpy(grids(tuple(h.shape), seed=4)).to(dtype)
    (h.float() * dh.float()).sum().backward()
    dg, dpc = k3.fused_lstm_gates_bwd_plain(g.detach(), pc.detach(), dh, None)
    assert torch.equal(g.grad, dg) and torch.equal(pc.grad, dpc)
    assert (k3.fused_lstm_gates.launches, k3.fused_lstm_gates_bwd.launches) \
        == (f0, b0)


@contextlib.contextmanager
def _no_draws():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(build, "init_weights", lambda module, gen: None)
        yield


@pytest.fixture(scope="module")
def voxel(tmp_path_factory):
    """The JAX package's frame2voxel model set, its weights in the port's
    (K3 gates on), and the streaming and ``--poly_batch`` artifacts of the
    port's modules, saved and loaded."""
    from openess_tpu.training.build import build_models as jbuild

    out = tmp_path_factory.mktemp("export")
    js = jax_settings(**VOXEL)
    jm = jbuild(js, seed=0)
    tree = jax.tree_util.tree_map(np.asarray, jm.params)
    text = np.asarray(jm.text_embeddings)
    ts = torch_settings(**VOXEL, e2vid_fused_gates=True)
    with _no_draws():
        tm = build.build_models(ts, seed=0, device="cpu")
    tm.modules["front_sensor_b"].load_state_dict(
        e2vid_state_dict_from_jax(tree["front_sensor_b"]), strict=True)
    tm.modules["back_end"].load_state_dict(
        semseg_state_dict_from_jax(tree["back_end"], text), strict=True)
    infer, x = em.build_infer_fn(ts, tm)
    batch = em.export(infer, (x,), poly_batch=True)
    stream, ex = em.build_streaming_fn(ts, tm)
    streaming = em.export(stream, ex)
    paths = {}
    for kind, ep in (("batch", batch), ("streaming", streaming)):
        paths[kind] = str(out / f"{kind}.pt2")
        em.save_artifact(ep, paths[kind], dict(kind=kind, device="cpu"))
    return dict(js=js, jm=jm, ts=ts, infer=infer, stream=stream, paths=paths,
                batch=em.load_artifact(paths["batch"], "cpu")[0],
                streaming=em.load_artifact(paths["streaming"], "cpu")[0])


def _close(got, want, atol):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max()) <= atol


def test_streaming_artifact_equals_eager(voxel):
    """Three windows, each carry fed back to its own side; the graph holds
    one K3 node per ConvLSTM."""
    ep = voxel["streaming"]
    assert em.count_gate_nodes(ep) == 3
    run, live = ep.module(), voxel["stream"]
    sa = sl = initial_stream_state(B, H, W)
    with torch.no_grad():
        for i in range(3):
            x = torch.from_numpy(grids((B, 5, H, W), seed=i))
            sl, pl, ll = live(sl, x)
            sa, pa, la = run(sa, x)
            assert pa.dtype == torch.int32 and torch.equal(pa, pl)
            assert _close(la, ll, EAGER_ATOL)
            for a, b in zip(sa, sl):
                assert _close(a[0], b[0], EAGER_ATOL)
                assert _close(a[1], b[1], EAGER_ATOL)


@pytest.mark.parametrize("batch", [2, 3])
def test_poly_batch_artifact_equals_eager(voxel, batch):
    """One ``--poly_batch`` artifact at two batch sizes; 3 T K3 nodes."""
    ep = voxel["batch"]
    assert em.count_gate_nodes(ep) == 3 * T
    x = torch.from_numpy(grids((batch, T, 5, H, W), seed=batch))
    with torch.no_grad():
        pl, ll = voxel["infer"](x)
        pa, la = ep.module()(x)
    assert pa.shape == (batch, H, W) and pa.dtype == torch.int32
    assert torch.equal(pa, pl) and _close(la, ll, EAGER_ATOL)


def _agree(got, want):
    scale = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - np.asarray(want)).max())
    return err <= JAX_REL * scale


def test_streaming_artifact_matches_jax(voxel):
    """Against ``tools/export_model.build_streaming_fn`` over 3 windows,
    each side carrying its own states."""
    from tools.export_model import build_streaming_fn as jstreaming

    fn, (carry_spec, _) = jstreaming(voxel["js"], voxel["jm"])
    jfn = jax.jit(fn)
    jc = jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype),
                                carry_spec)
    run = voxel["streaming"].module()
    tc = initial_stream_state(B, H, W)
    for i in range(3):
        x = grids((B, 5, H, W), seed=10 + i)
        jc, jpred, jlog = jfn(jc, x)
        tc, tpred, tlog = run(tc, torch.from_numpy(x))
        assert _agree(tlog.numpy(), np.asarray(jlog))
        assert (tpred.numpy() == np.asarray(jpred)).mean() >= JAX_AGREE


def test_batch_artifact_matches_jax(voxel):
    from tools.export_model import build_infer_fn as jinfer

    fn, spec = jinfer(voxel["js"], voxel["jm"])
    x = grids(tuple(spec.shape), seed=20)
    jpred, jlog = jax.jit(fn)(x)
    tpred, tlog = voxel["batch"].module()(torch.from_numpy(x))
    assert _agree(tlog.numpy(), np.asarray(jlog))
    assert (tpred.numpy() == np.asarray(jpred)).mean() >= JAX_AGREE


@pytest.mark.parametrize("fold", [True, False])
def test_recon_artifact_equals_eager(fold):
    """``frame2recon``: the DeepLabV3 student in eval mode, its trunk
    folded (``student_fold_bn``) or not, at two batch sizes from one
    artifact; no K3 node. Its weights are the modules' own (draws
    skipped)."""
    ts = torch_settings(**COMMON, config_option="frame2recon",
                        student_fold_bn=fold)
    torch.manual_seed(0)
    with _no_draws():
        mset = build.build_models(ts, seed=0, device="cpu")
    infer, x = em.build_infer_fn(ts, mset)
    ep = em.export(infer, (x,), poly_batch=True)
    assert em.count_gate_nodes(ep) == 0
    for batch in (2, 3):
        x = torch.from_numpy(np.random.default_rng(batch).random(
            (batch, H, W, 3)).astype(np.float32))
        with torch.no_grad():
            pl, ll = infer(x)
            pa, la = ep.module()(x)
        assert torch.equal(pa, pl) and _close(la, ll, EAGER_ATOL)


def _yaml(tmp_path, option="frame2voxel"):
    with open(os.path.join(ROOT, "configs/synthetic_sup_only.yaml")) as f:
        text = f.read()
    text = text.replace("config_option: 'frame2recon'",
                        f"config_option: '{option}'")
    text = text.replace("  compute_dtype: 'float32'",
                        "  compute_dtype: 'float32'\n"
                        "  e2vid_fused_gates: True")
    path = tmp_path / f"{option}.yaml"
    path.write_text(text)
    return str(path)


def test_cli_exports_and_selfchecks(tmp_path):
    """``python -m openess_tpu_torch.export_model --streaming --selfcheck
    --device cpu`` writes the artifact, reloads it and holds it to the
    live module, and prints the summary line."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    out = tmp_path / "s.pt2"
    r = subprocess.run(
        [sys.executable, "-m", "openess_tpu_torch.export_model",
         "--settings_file", _yaml(tmp_path), "--output", str(out),
         "--streaming", "--batch_size", "1", "--selfcheck", "--device",
         "cpu"], capture_output=True, text=True, cwd=str(tmp_path), env=env,
        timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "selfcheck OK: streaming artifact" in r.stdout
    assert "lstm_gates_fwd nodes 3" in r.stdout
    assert em.read_meta(str(out))["kind"] == "streaming"


@pytest.mark.parametrize("flags,why", [
    (["--streaming", "--poly_batch"], "exclusive"),
    (["--streaming"], "requires a voxel config_option"),
], ids=["poly_batch", "frame2recon"])
def test_cli_refusals(tmp_path, flags, why):
    option = "frame2recon" if why.startswith("requires") else "frame2voxel"
    with pytest.raises(SystemExit, match=why):
        em.main(["--settings_file", _yaml(tmp_path, option), "--output",
                 str(tmp_path / "x.pt2"), "--device", "cpu", *flags])
    assert not (tmp_path / "x.pt2").exists()


def test_artifact_server_gives_the_live_labels(voxel):
    """``StreamServer`` on the streaming artifact against the live server
    on the same weights: the packer, K1's plain version and the timing are
    shared, the labels equal window by window (uint8), the logits within
    1e-5."""
    from openess_tpu_torch.data.device_voxelize import upload_wire
    from openess_tpu_torch.serve_stream import (
        StreamServer,
        serve,
        synthetic_windows,
    )

    ts = voxel["ts"]
    art = StreamServer(ts, B, device="cpu", artifact=voxel["paths"][
        "streaming"])
    with _no_draws():
        live = StreamServer(ts, B, device="cpu")
    live.models.e2vid.load_state_dict(voxel["stream"].e2vid.state_dict())
    live.models.head.load_state_dict(voxel["stream"].head.state_dict())
    ca, cl = art.initial_state(), live.initial_state()
    for win in synthetic_windows(3, 2000, H, W):
        wire = upload_wire(live.pack(*win), "cpu")
        ca, la, ga = art.step(ca, wire)
        cl, ll, gl = live.step(cl, wire)
        assert la.dtype == torch.uint8 and torch.equal(la, ll)
        assert _close(ga, gl, EAGER_ATOL)
    r = serve(art, synthetic_windows(3, 2000, H, W))
    assert r.labels.dtype == np.uint8 and r.labels.shape == (B, H, W)


@pytest.mark.parametrize("case", ["streams", "checkpoint", "device", "kind"])
def test_artifact_server_refusals(voxel, case, tmp_path):
    """A window batch other than ``--streams``, a ``--checkpoint`` beside
    the artifact, another device than the export's, a batch artifact."""
    from openess_tpu_torch.serve_stream import StreamServer

    path, kw = voxel["paths"]["streaming"], dict(streams=B, device="cpu")
    match = {"streams": "artifact batch 2 != --streams 1",
             "checkpoint": "takes no --checkpoint",
             "device": "exported on cpu and cannot serve on meta",
             "kind": "batch artifact"}[case]
    if case == "streams":
        kw["streams"] = 1
    elif case == "checkpoint":
        kw["checkpoint"] = str(tmp_path)
    elif case == "device":
        kw["device"] = "meta"
    else:
        path = voxel["paths"]["batch"]
    with pytest.raises(ValueError, match=match):
        StreamServer(voxel["ts"], artifact=path, **kw)
