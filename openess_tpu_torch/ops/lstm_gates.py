"""K3 forward: the fused ConvLSTM gate pointwise tail, as a Triton kernel.

Replaces the forward TPU kernel ``openess_tpu/ops/lstm_gates.py:_fwd_kernel``
(reached through ``_run`` from ``fused_lstm_gates``). From the gate conv
output ``[..., 4C]`` in the reference chunk order (i, f, o, g) and the
previous cell ``[..., C]``::

    i, f, o = sigmoid(.), g = tanh(.)
    c = f * c_prev + i * g
    h = o * tanh(c)

in f32, with ``h`` and ``c`` stored in the input dtype.

What bounds it on an H100: it reads 5C and writes 2C values per pixel with
no reuse, so it is a pure HBM stream (at 440x640, bf16: 63 / 31.5 / 15.8 MB
for C = 64 / 128 / 256). The design is the plain one for such a pass: the
NHWC tensors are viewed as ``[rows, 4C]`` / ``[rows, C]`` rows, one program
per block of rows with a power-of-two channel block and masked edges, the
four gate slices of a row read as contiguous runs.

The backward kernel (``_bwd_kernel``) is still to be ported: only the
``unfrozen_e2vid`` fine-tuning path needs it.
"""
import functools

import torch

_BLOCK_ELEMS = 4096  # rows x channels per program
tl = None  # triton.language, bound by _triton_kernel at first launch


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


@functools.cache
def _triton_kernel():
    """Compile-on-first-use Triton kernel (``triton`` is imported here, not
    when the module is imported)."""
    global tl
    import triton
    import triton.language as tl

    @triton.jit
    def lstm_gates_fwd(g_ptr, pc_ptr, h_ptr, c_ptr, n_rows,
                       C: tl.constexpr, BLOCK_R: tl.constexpr,
                       BLOCK_C: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
        cols = tl.arange(0, BLOCK_C)
        mask = (rows[:, None] < n_rows) & (cols[None, :] < C)
        r = rows[:, None].to(tl.int64)
        g_off = r * (4 * C) + cols[None, :]
        s_off = r * C + cols[None, :]
        gi = tl.load(g_ptr + g_off, mask=mask, other=0.0).to(tl.float32)
        gf = tl.load(g_ptr + g_off + C, mask=mask, other=0.0).to(tl.float32)
        go = tl.load(g_ptr + g_off + 2 * C, mask=mask, other=0.0).to(tl.float32)
        gg = tl.load(g_ptr + g_off + 3 * C, mask=mask, other=0.0).to(tl.float32)
        pc = tl.load(pc_ptr + s_off, mask=mask, other=0.0).to(tl.float32)
        i = 1.0 / (1.0 + tl.exp(-gi))
        f = 1.0 / (1.0 + tl.exp(-gf))
        o = 1.0 / (1.0 + tl.exp(-go))
        # tanh(x) = sign(x) (1 - e^{-2|x|}) / (1 + e^{-2|x|})
        eg = tl.exp(-2.0 * tl.abs(gg))
        g = (1.0 - eg) / (1.0 + eg)
        g = tl.where(gg < 0, -g, g)
        c = f * pc + i * g
        ec = tl.exp(-2.0 * tl.abs(c))
        th = (1.0 - ec) / (1.0 + ec)
        th = tl.where(c < 0, -th, th)
        h = o * th
        tl.store(c_ptr + s_off, c.to(c_ptr.dtype.element_ty), mask=mask)
        tl.store(h_ptr + s_off, h.to(h_ptr.dtype.element_ty), mask=mask)

    return triton, lstm_gates_fwd


def fused_lstm_gates(gates: torch.Tensor, prev_cell: torch.Tensor):
    """``(hidden, cell)`` from the gate conv output ``[B, H, W, 4C]`` and
    the previous cell ``[B, H, W, C]`` (same dtype).

    A CUDA input launches the K3 Triton kernel (both tensors contiguous)
    and counts the launch in ``fused_lstm_gates.launches``; a CPU input runs
    :func:`fused_lstm_gates_plain`.
    """
    C = prev_cell.shape[-1]
    if gates.shape[:-1] != prev_cell.shape[:-1] or gates.shape[-1] != 4 * C:
        raise ValueError(
            f"gates {tuple(gates.shape)} must be [..., 4C] over prev_cell "
            f"{tuple(prev_cell.shape)}"
        )
    if gates.dtype != prev_cell.dtype or gates.device != prev_cell.device:
        raise ValueError("gates and prev_cell must share dtype and device")
    if gates.device.type == "cpu":
        return fused_lstm_gates_plain(gates, prev_cell)
    if gates.device.type != "cuda":
        raise ValueError(f"unsupported device for K3: {gates.device}")
    if not (gates.is_contiguous() and prev_cell.is_contiguous()):
        raise ValueError("K3 inputs must be contiguous (NHWC)")
    triton, kernel = _triton_kernel()
    h = torch.empty_like(prev_cell)
    c = torch.empty_like(prev_cell)
    n_rows = prev_cell.numel() // C
    block_c = triton.next_power_of_2(C)
    block_r = max(1, _BLOCK_ELEMS // block_c)
    with torch.cuda.device(gates.device):
        kernel[(triton.cdiv(n_rows, block_r),)](
            gates, prev_cell, h, c, n_rows,
            C=C, BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
    fused_lstm_gates.launches += 1
    return h, c


fused_lstm_gates.launches = 0
