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
are HBM streams; the source's note says how the kernels meet that.

Both are ``torch.library`` custom ops, ``openess_tpu_torch::lstm_gates_fwd``
and ``openess_tpu_torch::lstm_gates_bwd``, the backward registered as the
forward's autograd formula (saving only the forward's two inputs). Each op
has a CUDA implementation, which makes its inputs contiguous, chooses the
launch (:func:`launch_plan`) and counts it, a CPU implementation, which is
the plain version, and a fake implementation, so ``torch.export`` and other
tracers see the op as one node of the graph whatever the device: an
exported E2VID step launches the same kernels as the eager one. The
wrappers :func:`fused_lstm_gates` and :func:`fused_lstm_gates_bwd` check
shapes, dtypes and devices and call the ops.
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
    if gates.device.type == "cuda" and gates.dtype not in _DTYPE_CODES:
        raise ValueError(
            f"K3 kernels take float32 or bfloat16, not {gates.dtype}")


def dense(*tensors):
    """Each tensor made contiguous (``None`` stays ``None``): the kernels
    read NHWC rows, and autograd may hand over a strided gradient."""
    return tuple(None if t is None else t.contiguous() for t in tensors)


@torch.library.custom_op("openess_tpu_torch::lstm_gates_fwd", mutates_args=(),
                         device_types="cpu")
def lstm_gates_fwd(gates: torch.Tensor,
                   prev_cell: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's forward as an op: ``(h, c)`` in the input dtype. On the CPU,
    :func:`fused_lstm_gates_plain`."""
    return fused_lstm_gates_plain(gates, prev_cell)


@lstm_gates_fwd.register_kernel("cuda")
def _lstm_gates_fwd_cuda(gates, prev_cell):
    gates, prev_cell = dense(gates, prev_cell)
    h = torch.empty_like(prev_cell)
    c = torch.empty_like(prev_cell)
    _launch("lstm_gates_forward", prev_cell, gates, prev_cell, h, c)
    fused_lstm_gates.launches += 1
    return h, c


@lstm_gates_fwd.register_fake
def _lstm_gates_fwd_fake(gates, prev_cell):
    out = torch.empty_like(prev_cell, memory_format=torch.contiguous_format)
    return out, torch.empty_like(out)


@torch.library.custom_op("openess_tpu_torch::lstm_gates_bwd", mutates_args=(),
                         device_types="cpu")
def lstm_gates_bwd(gates: torch.Tensor, prev_cell: torch.Tensor,
                   dh: torch.Tensor | None,
                   dc_next: torch.Tensor | None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's backward as an op: ``(dgates, dprev_cell)`` in the input dtype,
    a ``None`` gradient read as zero. On the CPU,
    :func:`fused_lstm_gates_bwd_plain`."""
    return fused_lstm_gates_bwd_plain(gates, prev_cell, dh, dc_next)


@lstm_gates_bwd.register_kernel("cuda")
def _lstm_gates_bwd_cuda(gates, prev_cell, dh, dc_next):
    gates, prev_cell, dh, dc_next = dense(gates, prev_cell, dh, dc_next)
    dgates = torch.empty_like(gates)
    dpc = torch.empty_like(prev_cell)
    _launch("lstm_gates_backward", prev_cell, gates, prev_cell, dh, dc_next,
            dgates, dpc)
    fused_lstm_gates_bwd.launches += 1
    return dgates, dpc


@lstm_gates_bwd.register_fake
def _lstm_gates_bwd_fake(gates, prev_cell, dh, dc_next):
    return (torch.empty_like(gates, memory_format=torch.contiguous_format),
            torch.empty_like(prev_cell, memory_format=torch.contiguous_format))


def _save_inputs(ctx, inputs, output):
    ctx.save_for_backward(*inputs)
    # autograd then hands over None for an output nothing consumed (the
    # last window's cell state), which the kernel reads as zero
    ctx.set_materialize_grads(False)


def gates_backward(ctx, dh, dc_next):
    """The forward op's autograd formula: the backward op on the saved
    inputs; the activations are recomputed there."""
    gates, prev_cell = ctx.saved_tensors
    return fused_lstm_gates_bwd(gates, prev_cell, dh, dc_next)


lstm_gates_fwd.register_autograd(gates_backward, setup_context=_save_inputs)


def fused_lstm_gates_bwd(gates, prev_cell, dh, dc_next):
    """``(dgates [..., 4C], dprev_cell [..., C])`` of :func:`fused_lstm_gates`
    from its two inputs and the gradients of ``hidden`` and ``cell`` (all one
    dtype). Either gradient may be ``None``, read as zero.

    A CUDA input launches the K3 backward kernel (bf16 or f32) through the
    ``lstm_gates_bwd`` op and counts the launch in
    ``fused_lstm_gates_bwd.launches``; a CPU input runs
    :func:`fused_lstm_gates_bwd_plain` through the same op.
    """
    _check(gates, prev_cell, dh, dc_next)
    return lstm_gates_bwd(gates, prev_cell, dh, dc_next)


fused_lstm_gates_bwd.launches = 0


def fused_lstm_gates(gates: torch.Tensor, prev_cell: torch.Tensor):
    """``(hidden, cell)`` from the gate conv output ``[B, H, W, 4C]`` and
    the previous cell ``[B, H, W, C]`` (same dtype). Differentiable in both.

    Every input goes through the ``lstm_gates_fwd`` op: a CUDA input (bf16
    or f32) launches the K3 forward kernel and counts the launch in
    ``fused_lstm_gates.launches``, a CPU input runs
    :func:`fused_lstm_gates_plain`; the gradient is the ``lstm_gates_bwd``
    op (:func:`fused_lstm_gates_bwd`) either way.
    """
    _check(gates, prev_cell)
    return lstm_gates_fwd(gates, prev_cell)


fused_lstm_gates.launches = 0
