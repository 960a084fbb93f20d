"""K3's backward in the port against the JAX package on the CPU.

The port's plain backward (``fused_lstm_gates_bwd_plain``, what the CUDA
kernel of ``csrc/lstm_gates.cu`` is held against on the card) and autograd
through the plain forward (what a CPU tensor gets) are compared with
``jax.vjp`` of the Pallas op in interpret mode and of the jnp gate path of
``ConvLSTMCell``, on the same numpy inputs and cotangents.

Tolerances: f32 within 1e-6 absolute (measured <= 6.1e-7 on gradients up to
about 5 in size: both sides do the same f32 arithmetic, only the
sigmoid/tanh implementations differ); bf16 within 2 bf16 ulp of the tensor's
largest value, ``2 * 2**-8 * max`` (measured: a rare last-bit difference,
3e-4 of that bound; the f32 results round to bf16 last on both sides).
Shapes include C that is no power of two and a single row. A missing
gradient (``None``, autograd's for an output nothing consumed) is held
against ``_vjp_bwd`` of the Pallas op with a zero cotangent. The launch
plan, which picks the kernels' instantiation, is pure Python and checked
here; the kernels themselves run only on the card
(``tests/test_torch_gpu.py``).
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.ops import lstm_gates as jlstm
from openess_tpu.ops.lstm_gates import fused_lstm_gates as jfused
from openess_tpu_torch.ops import lstm_gates as k3
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

F32_TOL = 1e-6
SHAPES = [(2, 5, 7, 8), (1, 1, 1, 12), (1, 3, 4, 20), (2, 2, 3, 64)]


def _inputs(shape, seed=1205):
    rng = np.random.default_rng(seed)
    b, h, w, c = shape
    return (
        (rng.normal(size=(b, h, w, 4 * c)) * 2).astype(np.float32),
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        rng.normal(size=(b, h, w, c)).astype(np.float32),
        rng.normal(size=(b, h, w, c)).astype(np.float32),
    )


def _jnp_gates(gates, pc):
    i, f, o, g = jnp.split(gates, 4, axis=-1)
    c = jax.nn.sigmoid(f) * pc + jax.nn.sigmoid(i) * jnp.tanh(g)
    return jax.nn.sigmoid(o) * jnp.tanh(c), c


def _jax_vjp(fn, gates, pc, dh, dc, dtype):
    args = [jnp.asarray(a, dtype) for a in (gates, pc)]
    _, vjp = jax.vjp(fn, *args)
    dg, dpc = vjp((jnp.asarray(dh, dtype), jnp.asarray(dc, dtype)))
    return (np.asarray(dg.astype(jnp.float32)),
            np.asarray(dpc.astype(jnp.float32)))


def _pallas(gates, pc):
    return jfused(gates, pc, True)  # interpret mode


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_plain_backward_matches_jax_vjp_of_the_pallas_op_f32(shape):
    gates, pc, dh, dc = _inputs(shape)
    ref = _jax_vjp(_pallas, gates, pc, dh, dc, jnp.float32)
    got = k3.fused_lstm_gates_bwd_plain(
        *(torch.from_numpy(a) for a in (gates, pc, dh, dc)))
    assert got[0].shape == gates.shape and got[1].shape == pc.shape
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        assert np.abs(g.numpy() - r).max() <= F32_TOL


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_plain_backward_matches_jax_vjp_of_the_pallas_op_bf16(shape):
    gates, pc, dh, dc = _inputs(shape, seed=7)
    ref = _jax_vjp(_pallas, gates, pc, dh, dc, jnp.bfloat16)
    got = k3.fused_lstm_gates_bwd_plain(
        *(torch.from_numpy(a).bfloat16() for a in (gates, pc, dh, dc)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        tol = 2 * 2.0 ** -8 * np.abs(r).max()
        assert np.abs(g.float().numpy() - r).max() <= tol


@pytest.mark.parametrize("shape", SHAPES[:3], ids=str)
def test_autograd_through_the_plain_forward_matches_both_jax_paths(shape):
    """What a CPU tensor gets: ``fused_lstm_gates`` is the plain forward,
    differentiable through autograd."""
    gates, pc, dh, dc = _inputs(shape, seed=3)
    tg = torch.from_numpy(gates).requires_grad_(True)
    tpc = torch.from_numpy(pc).requires_grad_(True)
    h, c = k3.fused_lstm_gates(tg, tpc)
    torch.autograd.backward((h, c), (torch.from_numpy(dh),
                                     torch.from_numpy(dc)))
    for fn in (_pallas, _jnp_gates):
        rg, rpc = _jax_vjp(fn, gates, pc, dh, dc, jnp.float32)
        assert np.abs(tg.grad.numpy() - rg).max() <= F32_TOL
        assert np.abs(tpc.grad.numpy() - rpc).max() <= F32_TOL
    # and the plain backward is that gradient
    pg, ppc = k3.fused_lstm_gates_bwd_plain(
        tg.detach(), tpc.detach(), torch.from_numpy(dh), torch.from_numpy(dc))
    assert (pg - tg.grad).abs().max() <= F32_TOL
    assert (ppc - tpc.grad).abs().max() <= F32_TOL


def test_function_backward_passes_none_and_densifies_strided_gradients(
        monkeypatch):
    """The forward op's registered autograd formula: a ``None`` gradient
    (the last window's cell state has no consumer) reaches the backward
    wrapper as ``None``, which reads it as zero, and a strided one reaches
    it as it is, for the op to make dense (``dense``, which the CUDA
    implementations apply before a launch); on CPU tensors the op is the
    plain backward. Through autograd itself, the unconsumed cell's gradient
    is not materialized either."""
    gates, pc, dh, _ = (torch.from_numpy(a) for a in _inputs((2, 3, 4, 8)))
    ctx = types.SimpleNamespace(saved_tensors=(gates, pc))
    seen = []
    wrapper = k3.fused_lstm_gates_bwd

    def spy(*args):
        seen.append(args[2:])
        return wrapper(*args)

    monkeypatch.setattr(k3, "fused_lstm_gates_bwd", spy)
    strided = dh.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not strided.is_contiguous()
    got = k3.gates_backward(ctx, strided, None)
    assert seen[-1][1] is None and seen[-1][0] is strided
    assert all(t.is_contiguous() for t in k3.dense(strided, None)[:1])
    assert k3.dense(strided, None)[1] is None
    want = k3.fused_lstm_gates_bwd_plain(gates, pc, dh, torch.zeros_like(pc))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    got = k3.gates_backward(ctx, None, dh)
    assert seen[-1][0] is None and seen[-1][1] is dh
    want = k3.fused_lstm_gates_bwd_plain(gates, pc, torch.zeros_like(pc), dh)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    g, p = gates.clone().requires_grad_(), pc.clone().requires_grad_()
    h, _ = k3.fused_lstm_gates(g, p)
    (h * dh).sum().backward()
    assert seen[-1][0] is not None and seen[-1][1] is None


@pytest.mark.parametrize("missing", ["dh", "dc_next"])
@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_plain_backward_with_a_missing_gradient_matches_jax(shape, missing):
    """``None`` for ``dh`` or ``dc_next`` is a zero cotangent of the Pallas
    op's ``_vjp_bwd`` (interpret mode)."""
    gates, pc, dh, dc = _inputs(shape, seed=11)
    zero = np.zeros_like(pc)
    cot = (zero, dc) if missing == "dh" else (dh, zero)
    ref = jlstm._vjp_bwd(True, (jnp.asarray(gates), jnp.asarray(pc)),
                         tuple(jnp.asarray(a) for a in cot))
    t = {k: torch.from_numpy(a) for k, a in
         dict(dh=dh, dc_next=dc).items()}
    t[missing] = None
    got = k3.fused_lstm_gates_bwd_plain(torch.from_numpy(gates),
                                        torch.from_numpy(pc), t["dh"],
                                        t["dc_next"])
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        assert np.abs(g.numpy() - np.asarray(r)).max() <= F32_TOL
    # and through the wrapper, which runs the plain version on the CPU
    again = k3.fused_lstm_gates_bwd(torch.from_numpy(gates),
                                    torch.from_numpy(pc), t["dh"],
                                    t["dc_next"])
    assert all(torch.equal(a, b) for a, b in zip(again, got))


# C, dtype -> (vector width, scalar instantiation)
PLANS = {(8, torch.bfloat16): (8, False), (12, torch.bfloat16): (1, True),
         (64, torch.bfloat16): (8, False), (256, torch.bfloat16): (8, False),
         (8, torch.float32): (4, False), (12, torch.float32): (4, False),
         (64, torch.float32): (4, False), (256, torch.float32): (4, False)}


@pytest.mark.parametrize("C,dtype", list(PLANS), ids=str)
def test_launch_plan(C, dtype):
    """16 bytes of channels a work item where C allows it, else the scalar
    instantiation; an unaligned tensor takes the scalar path too."""
    vec, scalar = PLANS[(C, dtype)]
    n_pixels = 8 * 110 * 160  # a train step's middle ConvLSTM level
    plan = k3.launch_plan(C, dtype, n_pixels)
    assert (plan.vec, plan.scalar) == (vec, scalar)
    assert plan.n_items == n_pixels * C // vec
    unaligned = k3.launch_plan(C, dtype, n_pixels, aligned=False)
    assert unaligned.scalar and unaligned.n_items == n_pixels * C


def test_launch_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.launch_plan(64, torch.float16, 100)
    with pytest.raises(ValueError, match="32-bit"):
        k3.launch_plan(1, torch.float32, 2 ** 31)


def test_backward_wrapper_checks_inputs_and_counts_no_cpu_launch():
    gates, pc, dh, dc = (torch.from_numpy(a) for a in _inputs((1, 2, 2, 4)))
    before = k3.fused_lstm_gates_bwd.launches
    dg, dpc = k3.fused_lstm_gates_bwd(gates, pc, dh, dc)
    assert k3.fused_lstm_gates_bwd.launches == before  # CPU: plain version
    assert dg.shape == gates.shape and dpc.shape == pc.shape
    with pytest.raises(ValueError, match="4C"):
        k3.fused_lstm_gates_bwd(gates[..., :12], pc, dh, dc)
    with pytest.raises(ValueError, match="prev_cell's shape"):
        k3.fused_lstm_gates_bwd(gates, pc, dh[:, :1], dc)
    with pytest.raises(ValueError, match="dtype"):
        k3.fused_lstm_gates_bwd(gates, pc, dh.bfloat16(), dc)
    with pytest.raises(ValueError, match="device"):
        k3.fused_lstm_gates_bwd(*(a.to("meta") for a in (gates, pc, dh, dc)))
