"""The port's K3 gate op, E2VID and SemSegE2VID against the JAX package, in
f32 on the CPU, with flax-initialized weights carried across by
``openess_tpu_torch.models.convert``; and the weight round trip through the
JAX package's own torch converters."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.models import e2vid as je
from openess_tpu.models.semseg_e2vid import SemSegE2VID as JSemSeg
from openess_tpu.models.torch_convert import (
    convert_e2vid,
    convert_semseg_e2vid,
)
from openess_tpu.ops.lstm_gates import fused_lstm_gates as j_fused
from openess_tpu_torch.models import e2vid as te
from openess_tpu_torch.models.convert import (
    e2vid_state_dict_from_jax,
    semseg_state_dict_from_jax,
)
from openess_tpu_torch.models.semseg_e2vid import SemSegE2VID as TSemSeg
from openess_tpu_torch.ops.lstm_gates import (
    fused_lstm_gates,
    fused_lstm_gates_plain,
)
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

MODEL_TOL = 1e-4  # f32 convs: XLA CPU vs PyTorch CPU summation order
GATE_TOL = 1e-6   # the same f32 pointwise math


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _windows(rng, b, t, h, w):
    win = rng.normal(size=(b, t, 5, h, w)).astype(np.float32)
    win[np.abs(win) < 0.6] = 0.0  # sparse, like voxel grids
    return win


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def test_k3_plain_matches_pallas_and_jnp(rng):
    B, H, W, C = 2, 12, 16, 8
    gates = rng.normal(size=(B, H, W, 4 * C)).astype(np.float32) * 3
    pc = rng.normal(size=(B, H, W, C)).astype(np.float32)
    h, c = fused_lstm_gates(torch.from_numpy(gates), torch.from_numpy(pc))
    hp, cp = j_fused(jnp.asarray(gates), jnp.asarray(pc), True)
    np.testing.assert_allclose(h.numpy(), np.asarray(hp), atol=GATE_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cp), atol=GATE_TOL)
    i, f, o, g = jnp.split(jnp.asarray(gates), 4, axis=-1)
    cj = jax.nn.sigmoid(f) * pc + jax.nn.sigmoid(i) * jnp.tanh(g)
    hj = jax.nn.sigmoid(o) * jnp.tanh(cj)
    np.testing.assert_allclose(h.numpy(), np.asarray(hj), atol=GATE_TOL)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=GATE_TOL)


def test_k3_keeps_input_dtype_and_checks_inputs(rng):
    g = torch.from_numpy(rng.normal(size=(1, 4, 4, 16)).astype(np.float32))
    pc = torch.zeros(1, 4, 4, 4)
    h, c = fused_lstm_gates(g.bfloat16(), pc.bfloat16())
    assert h.dtype == c.dtype == torch.bfloat16
    hp, _ = fused_lstm_gates_plain(g.bfloat16(), pc.bfloat16())
    assert torch.equal(h, hp)
    with pytest.raises(ValueError, match="4C"):
        fused_lstm_gates(g, torch.zeros(1, 4, 4, 5))
    with pytest.raises(ValueError, match="device"):
        fused_lstm_gates(g.to("meta"), pc.to("meta"))


# ---------------------------------------------------------------------------
# E2VID
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("latent_only", [True, False])
def test_streaming_step_matches_jax(rng, fused, latent_only):
    B, T, H, W = 1, 3, 16, 24
    wins = _windows(rng, B, T, H, W)
    jstep = je.E2VIDStreamingStep(latent_only=latent_only, fused_gates=fused)
    jst = je.initial_stream_state(B, H, W)
    params = jstep.init(jax.random.key(1), jst, jnp.asarray(wins[:, 0]))
    tstep = te.E2VIDStreamingStep(latent_only=latent_only, fused_gates=fused)
    tstep.load_state_dict(
        e2vid_state_dict_from_jax(_np_tree(params["params"])), strict=True
    )
    tst = te.initial_stream_state(B, H, W)
    for ti in range(T):
        jst, jlat, jimg = jstep.apply(params, jst, jnp.asarray(wins[:, ti]))
        with torch.no_grad():
            tst, tlat, timg = tstep(tst, torch.from_numpy(wins[:, ti]))
        for (jh, jc), (th, tc) in zip(jst, tst):
            assert th.shape == jh.shape
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=MODEL_TOL)
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=MODEL_TOL)
        for k in ("1", "2", "4", "8"):
            np.testing.assert_allclose(
                tlat[k].numpy(), np.asarray(jlat[k]), atol=MODEL_TOL, err_msg=k
            )
        if latent_only:
            assert jimg is None and timg is None
        else:
            assert timg.shape == (B, H, W, 1)
            np.testing.assert_allclose(timg.numpy(), np.asarray(jimg),
                                       atol=MODEL_TOL)


@pytest.mark.parametrize("planar", [True, False])
def test_reconstructor_equals_streaming_steps(rng, planar):
    B, T, H, W = 2, 3, 16, 16
    wins = torch.from_numpy(_windows(rng, B, T, H, W))
    torch.manual_seed(0)
    rec = te.E2VIDReconstructor(planar_input=planar).eval()
    step = te.E2VIDStreamingStep().eval()
    step.load_state_dict(rec.state_dict(), strict=True)
    with torch.no_grad():
        imgs, lat = rec(wins if planar else wins.permute(0, 1, 3, 4, 2))
        st = te.initial_stream_state(B, H, W)
        for ti in range(T):
            st, slat, simg = step(st, wins[:, ti])
            torch.testing.assert_close(imgs[:, ti], simg, rtol=0, atol=1e-6)
    for k in lat:
        torch.testing.assert_close(lat[k], slat[k], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# SemSegE2VID
# ---------------------------------------------------------------------------


def _semseg_pair(rng, num_classes=11):
    H, W = 32, 48
    latent = {
        "2": rng.normal(size=(2, H // 2, W // 2, 64)).astype(np.float32),
        "4": rng.normal(size=(2, H // 4, W // 4, 128)).astype(np.float32),
        "8": rng.normal(size=(2, H // 8, W // 8, 256)).astype(np.float32),
    }
    text = rng.normal(0, 0.01, (num_classes, 512)).astype(np.float32)
    jm = JSemSeg(num_classes=num_classes)
    params = jm.init(jax.random.key(2), jax.tree_util.tree_map(jnp.asarray, latent),
                     jnp.asarray(text))
    return latent, text, jm, params


def test_semseg_matches_jax(rng):
    latent, text, jm, params = _semseg_pair(rng)
    jlog, jfeat = jm.apply(params, jax.tree_util.tree_map(jnp.asarray, latent),
                           jnp.asarray(text))
    tm = TSemSeg(num_classes=11)
    tm.load_state_dict(
        semseg_state_dict_from_jax(_np_tree(params["params"]), text), strict=True
    )
    with torch.no_grad():
        tlog, tfeat = tm({k: torch.from_numpy(v) for k, v in latent.items()})
    assert tlog.shape == (2, 32, 48, 11) and tfeat.shape == (2, 32, 48, 256)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=MODEL_TOL)
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=MODEL_TOL)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten_with_path(a)
    lb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (pa, va), (_, vb) in zip(la, lb):
        assert va.shape == vb.shape, pa
        np.testing.assert_array_equal(np.asarray(va), np.asarray(vb),
                                      err_msg=str(pa))


def test_e2vid_weights_round_trip(rng):
    win = jnp.asarray(_windows(rng, 1, 1, 16, 16)[:, 0])
    params = je.E2VIDStreamingStep().init(
        jax.random.key(3), je.initial_stream_state(1, 16, 16), win)["params"]
    sd = e2vid_state_dict_from_jax(_np_tree(params))
    te.E2VIDStreamingStep().load_state_dict(sd, strict=True)
    _assert_trees_equal(convert_e2vid(sd), _np_tree(params["step"]["unet"]))


def test_semseg_weights_round_trip(rng):
    _, text, _, params = _semseg_pair(rng, num_classes=6)
    sd = semseg_state_dict_from_jax(_np_tree(params["params"]), text)
    TSemSeg(num_classes=6).load_state_dict(sd, strict=True)
    back, back_text = convert_semseg_e2vid(sd)
    _assert_trees_equal(back, _np_tree(params["params"]))
    np.testing.assert_array_equal(back_text, text)


@pytest.mark.parametrize("seed", [0, 1205])
def test_text_embeddings_match_jax_bit_for_bit(seed):
    from openess_tpu.config.settings import Settings as JS
    from openess_tpu.training.build import load_text_embeddings as jload
    from openess_tpu_torch.config.settings import Settings as TS
    from openess_tpu_torch.training.build import load_text_embeddings as tload

    ref = np.asarray(jload(JS(), np.random.default_rng(seed)))
    got = tload(TS(), np.random.default_rng(seed))
    assert got.dtype == np.float32 and got.shape == (11, 512)
    np.testing.assert_array_equal(got, ref)
