"""K3: the fused ConvLSTM gate pointwise tail and its backward, two CUDA C++
kernels in ``csrc/lstm_gates.cu``.

They replace the TPU kernels ``openess_tpu/ops/lstm_gates.py:_fwd_kernel``
and ``_bwd_kernel`` (reached through ``_run`` from ``fused_lstm_gates`` and
its custom VJP). From the gate conv output ``[..., 4C]`` in the reference
chunk order (i, f, o, g) and the previous cell ``[..., C]``::

    i, f, o = sigmoid(.), g = tanh(.)
    c = f * c_prev + i * g
    h = o * tanh(c)

in f32, with ``h`` and ``c`` stored in the input dtype.

The backward (only a trainable E2VID, the ``unfrozen_e2vid`` fine-tune,
reaches it) saves nothing but the forward's two inputs. From them and the
incoming ``dh``, ``dc_next`` it recomputes i, f, o, g, ``c`` and ``tanh c``
in f32 with the forward's own formulas and gives::

    dc      = dc_next + dh * o * (1 - tanh(c)^2)
    dgates  = (dc*g*i(1-i), dc*c_prev*f(1-f), dh*tanh(c)*o(1-o), dc*i*(1-g^2))
    dc_prev = dc * f

in the input dtype; a ``None`` ``dh`` or ``dc_next`` counts as zero. Both
are HBM streams; the source's note says how the kernels meet that. The
wrappers here choose each launch (:func:`launch_plan`), count it, and run
the plain versions for CPU tensors only.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def fused_lstm_gates_plain(gates: torch.Tensor, prev_cell: torch.Tensor):
    """K3's plain PyTorch version: the same f32 math, outputs in the input
    dtype."""
    C = prev_cell.shape[-1]
    g4 = gates.float()
    pc = prev_cell.float()
    i = torch.sigmoid(g4[..., :C])
    f = torch.sigmoid(g4[..., C:2 * C])
    o = torch.sigmoid(g4[..., 2 * C:3 * C])
    g = torch.tanh(g4[..., 3 * C:])
    c = f * pc + i * g
    h = o * torch.tanh(c)
    return h.to(gates.dtype), c.to(gates.dtype)


def fused_lstm_gates_bwd_plain(gates, prev_cell, dh, dc_next):
    """The backward's plain PyTorch version: ``(dgates, dprev_cell)`` with
    the same f32 math, outputs in the input dtype; ``None`` for ``dh`` or
    ``dc_next`` counts as zero."""
    C = prev_cell.shape[-1]
    g4 = gates.float()
    pc = prev_cell.float()
    dh = 0.0 if dh is None else dh.float()
    dcn = 0.0 if dc_next is None else dc_next.float()
    i = torch.sigmoid(g4[..., :C])
    f = torch.sigmoid(g4[..., C:2 * C])
    o = torch.sigmoid(g4[..., 2 * C:3 * C])
    g = torch.tanh(g4[..., 3 * C:])
    c = f * pc + i * g
    th = torch.tanh(c)
    dc = dcn + dh * o * (1.0 - th * th)
    dgates = torch.cat([
        (dc * g) * i * (1.0 - i),
        (dc * pc) * f * (1.0 - f),
        (dh * th) * o * (1.0 - o),
        (dc * i) * (1.0 - g * g),
    ], dim=-1)
    return dgates.to(gates.dtype), (dc * f).to(gates.dtype)


class LaunchPlan(NamedTuple):
    vec: int      # channels per work item: 16 bytes' worth, or 1 (scalar)
    n_items: int  # pixels x C / vec, one a thread

    @property
    def scalar(self) -> bool:
        return self.vec == 1


def launch_plan(C: int, dtype: torch.dtype, n_pixels: int, *,
                aligned: bool = True) -> LaunchPlan:
    """How the kernels of ``csrc/lstm_gates.cu`` cover ``n_pixels`` rows of
    ``C`` channels: the vector instantiation (16 bytes a work item) when
    ``C`` is a multiple of its width and every tensor is 16-byte
    ``aligned``, else the scalar one. Raises for a dtype the kernels do not
    take or a launch too large for their 32-bit item index."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"K3 kernels take float32 or bfloat16, not {dtype}")
    vec = 16 // dtype.itemsize
    if C % vec or not aligned:
        vec = 1
    n_items = n_pixels * C // vec
    if n_items >= 2 ** 31:
        raise ValueError(f"{n_pixels} x {C} values exceed the K3 kernels' "
                         "32-bit item index")
    return LaunchPlan(vec, n_items)


def _launch(name: str, prev_cell, *tensors):
    """Launch the C entry ``name`` of ``csrc/lstm_gates.cu`` over
    ``tensors`` (``None`` passes a null pointer) on the current stream."""
    from openess_tpu_torch.ops import _build

    C = prev_cell.shape[-1]
    plan = launch_plan(
        C, prev_cell.dtype, prev_cell.numel() // C,
        aligned=all(t.data_ptr() % 16 == 0 for t in tensors if t is not None))
    fn = _build.entry("lstm_gates.cu", name,
                      *[ctypes.c_void_p] * len(tensors), ctypes.c_uint,
                      *[ctypes.c_int] * 3)
    _build.launch(fn, prev_cell.device,
                  *(None if t is None else t.data_ptr() for t in tensors),
                  plan.n_items, C, _DTYPE_CODES[prev_cell.dtype], plan.vec)


def _check(gates, prev_cell, *grads):
    C = prev_cell.shape[-1]
    if gates.shape[:-1] != prev_cell.shape[:-1] or gates.shape[-1] != 4 * C:
        raise ValueError(
            f"gates {tuple(gates.shape)} must be [..., 4C] over prev_cell "
            f"{tuple(prev_cell.shape)}"
        )
    given = [t for t in (prev_cell, *grads) if t is not None]
    for t in given:
        if t.dtype != gates.dtype or t.device != gates.device:
            raise ValueError("K3 tensors must share dtype and device")
        if t.shape != prev_cell.shape:
            raise ValueError(
                f"K3 gradient {tuple(t.shape)} must have prev_cell's shape "
                f"{tuple(prev_cell.shape)}"
            )
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device for K3: {gates.device}")
    if gates.device.type == "cuda":
        if gates.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"K3 kernels take float32 or bfloat16, not {gates.dtype}")
        if not all(t.is_contiguous() for t in (gates, *given)):
            raise ValueError("K3 inputs must be contiguous (NHWC)")


def _launch_fwd(gates, prev_cell):
    h = torch.empty_like(prev_cell)
    c = torch.empty_like(prev_cell)
    _launch("lstm_gates_forward", prev_cell, gates, prev_cell, h, c)
    fused_lstm_gates.launches += 1
    return h, c


def fused_lstm_gates_bwd(gates, prev_cell, dh, dc_next):
    """``(dgates [..., 4C], dprev_cell [..., C])`` of :func:`fused_lstm_gates`
    from its two inputs and the gradients of ``hidden`` and ``cell`` (all one
    dtype; on CUDA all contiguous). Either gradient may be ``None``, read as
    zero.

    A CUDA input launches the K3 backward kernel (bf16 or f32) and counts
    the launch in ``fused_lstm_gates_bwd.launches``; a CPU input runs
    :func:`fused_lstm_gates_bwd_plain`.
    """
    _check(gates, prev_cell, dh, dc_next)
    if gates.device.type == "cpu":
        return fused_lstm_gates_bwd_plain(gates, prev_cell, dh, dc_next)
    dgates = torch.empty_like(gates)
    dpc = torch.empty_like(prev_cell)
    _launch("lstm_gates_backward", prev_cell, gates, prev_cell, dh, dc_next,
            dgates, dpc)
    fused_lstm_gates_bwd.launches += 1
    return dgates, dpc


fused_lstm_gates_bwd.launches = 0


class _FusedGates(torch.autograd.Function):
    """K3 forward with K3 backward as its gradient, for CUDA tensors. Only
    the two inputs are saved; the backward recomputes the activations."""

    @staticmethod
    def forward(ctx, gates, prev_cell):
        ctx.save_for_backward(gates, prev_cell)
        ctx.set_materialize_grads(False)
        return _launch_fwd(gates, prev_cell)

    @staticmethod
    def backward(ctx, dh, dc_next):
        gates, prev_cell = ctx.saved_tensors
        # autograd hands over None for an output nothing consumed (the last
        # window's cell state), which the kernel reads as zero, and may hand
        # over a strided view, which is made dense here
        return fused_lstm_gates_bwd(
            gates, prev_cell,
            *(None if g is None else g.contiguous() for g in (dh, dc_next)))


def fused_lstm_gates(gates: torch.Tensor, prev_cell: torch.Tensor):
    """``(hidden, cell)`` from the gate conv output ``[B, H, W, 4C]`` and
    the previous cell ``[B, H, W, C]`` (same dtype). Differentiable in both.

    A CUDA input (bf16 or f32, both tensors contiguous) launches the K3
    forward kernel and counts the launch in ``fused_lstm_gates.launches``;
    its gradient is :func:`fused_lstm_gates_bwd`. A CPU input runs
    :func:`fused_lstm_gates_plain`, differentiable through autograd.
    """
    _check(gates, prev_cell)
    if gates.device.type == "cpu":
        return fused_lstm_gates_plain(gates, prev_cell)
    return _FusedGates.apply(gates, prev_cell)


fused_lstm_gates.launches = 0
