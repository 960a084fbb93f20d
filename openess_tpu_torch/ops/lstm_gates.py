"""K3: the fused ConvLSTM gate pointwise tail and its backward, as two
Triton kernels.

They replace the TPU kernels ``openess_tpu/ops/lstm_gates.py:_fwd_kernel``
and ``_bwd_kernel`` (reached through ``_run`` from ``fused_lstm_gates`` and
its custom VJP). From the gate conv
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

The backward (only a trainable E2VID, the ``unfrozen_e2vid`` fine-tune,
reaches it) saves nothing but the forward's two inputs. From them and the
incoming ``dh``, ``dc_next`` it recomputes i, f, o, g, ``c`` and ``tanh c``
in f32 with the forward's own formulas and gives::

    dc      = dc_next + dh * o * (1 - tanh(c)^2)
    dgates  = (dc*g*i(1-i), dc*c_prev*f(1-f), dh*tanh(c)*o(1-o), dc*i*(1-g^2))
    dc_prev = dc * f

in the input dtype. It reads 7C and writes 5C values per pixel, again a pure
HBM stream (at 440x640, B = 8, bf16: 865 / 432 / 216 MB), and has the
forward's shape: ``[rows, 4C]`` / ``[rows, C]`` rows, one program per block
of rows, the four gate runs of a row read and written contiguously.
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


def fused_lstm_gates_bwd_plain(gates, prev_cell, dh, dc_next):
    """The backward's plain PyTorch version: ``(dgates, dprev_cell)`` with
    the same f32 math, outputs in the input dtype."""
    C = prev_cell.shape[-1]
    g4 = gates.float()
    pc = prev_cell.float()
    dh = dh.float()
    i = torch.sigmoid(g4[..., :C])
    f = torch.sigmoid(g4[..., C:2 * C])
    o = torch.sigmoid(g4[..., 2 * C:3 * C])
    g = torch.tanh(g4[..., 3 * C:])
    c = f * pc + i * g
    th = torch.tanh(c)
    dc = dc_next.float() + dh * o * (1.0 - th * th)
    dgates = torch.cat([
        (dc * g) * i * (1.0 - i),
        (dc * pc) * f * (1.0 - f),
        (dh * th) * o * (1.0 - o),
        (dc * i) * (1.0 - g * g),
    ], dim=-1)
    return dgates.to(gates.dtype), (dc * f).to(gates.dtype)


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

    @triton.jit
    def lstm_gates_bwd(g_ptr, pc_ptr, dh_ptr, dcn_ptr, dg_ptr, dpc_ptr,
                       n_rows, C: tl.constexpr, BLOCK_R: tl.constexpr,
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
        dh = tl.load(dh_ptr + s_off, mask=mask, other=0.0).to(tl.float32)
        dcn = tl.load(dcn_ptr + s_off, mask=mask, other=0.0).to(tl.float32)
        # the forward's formulas, so both agree on c and tanh(c)
        i = 1.0 / (1.0 + tl.exp(-gi))
        f = 1.0 / (1.0 + tl.exp(-gf))
        o = 1.0 / (1.0 + tl.exp(-go))
        eg = tl.exp(-2.0 * tl.abs(gg))
        g = (1.0 - eg) / (1.0 + eg)
        g = tl.where(gg < 0, -g, g)
        c = f * pc + i * g
        ec = tl.exp(-2.0 * tl.abs(c))
        th = (1.0 - ec) / (1.0 + ec)
        th = tl.where(c < 0, -th, th)
        dc = dcn + dh * o * (1.0 - th * th)
        dgi = (dc * g) * i * (1.0 - i)
        dgf = (dc * pc) * f * (1.0 - f)
        dgo = (dh * th) * o * (1.0 - o)
        dgg = (dc * i) * (1.0 - g * g)
        dt = dg_ptr.dtype.element_ty
        tl.store(dg_ptr + g_off, dgi.to(dt), mask=mask)
        tl.store(dg_ptr + g_off + C, dgf.to(dt), mask=mask)
        tl.store(dg_ptr + g_off + 2 * C, dgo.to(dt), mask=mask)
        tl.store(dg_ptr + g_off + 3 * C, dgg.to(dt), mask=mask)
        tl.store(dpc_ptr + s_off, (dc * f).to(dt), mask=mask)

    return triton, lstm_gates_fwd, lstm_gates_bwd


def _check(gates, prev_cell, *grads):
    C = prev_cell.shape[-1]
    if gates.shape[:-1] != prev_cell.shape[:-1] or gates.shape[-1] != 4 * C:
        raise ValueError(
            f"gates {tuple(gates.shape)} must be [..., 4C] over prev_cell "
            f"{tuple(prev_cell.shape)}"
        )
    for t in (prev_cell, *grads):
        if t.dtype != gates.dtype or t.device != gates.device:
            raise ValueError("K3 tensors must share dtype and device")
        if t.shape != prev_cell.shape:
            raise ValueError(
                f"K3 gradient {tuple(t.shape)} must have prev_cell's shape "
                f"{tuple(prev_cell.shape)}"
            )
    if gates.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device for K3: {gates.device}")
    if gates.device.type == "cuda" and not all(
        t.is_contiguous() for t in (gates, prev_cell, *grads)
    ):
        raise ValueError("K3 inputs must be contiguous (NHWC)")


def _grid(triton, prev_cell):
    C = prev_cell.shape[-1]
    n_rows = prev_cell.numel() // C
    block_c = triton.next_power_of_2(C)
    block_r = max(1, _BLOCK_ELEMS // block_c)
    return n_rows, block_r, block_c


def _launch_fwd(gates, prev_cell):
    triton, fwd, _ = _triton_kernel()
    h = torch.empty_like(prev_cell)
    c = torch.empty_like(prev_cell)
    n_rows, block_r, block_c = _grid(triton, prev_cell)
    with torch.cuda.device(gates.device):
        fwd[(triton.cdiv(n_rows, block_r),)](
            gates, prev_cell, h, c, n_rows, C=prev_cell.shape[-1],
            BLOCK_R=block_r, BLOCK_C=block_c, num_warps=4,
        )
    fused_lstm_gates.launches += 1
    return h, c


def fused_lstm_gates_bwd(gates, prev_cell, dh, dc_next):
    """``(dgates [..., 4C], dprev_cell [..., C])`` of :func:`fused_lstm_gates`
    from its two inputs and the gradients of ``hidden`` and ``cell`` (all one
    dtype; on CUDA all contiguous).

    A CUDA input launches the K3 backward Triton kernel and counts the
    launch in ``fused_lstm_gates_bwd.launches``; a CPU input runs
    :func:`fused_lstm_gates_bwd_plain`.
    """
    _check(gates, prev_cell, dh, dc_next)
    if gates.device.type == "cpu":
        return fused_lstm_gates_bwd_plain(gates, prev_cell, dh, dc_next)
    triton, _, bwd = _triton_kernel()
    dgates = torch.empty_like(gates)
    dpc = torch.empty_like(prev_cell)
    n_rows, block_r, block_c = _grid(triton, prev_cell)
    with torch.cuda.device(gates.device):
        bwd[(triton.cdiv(n_rows, block_r),)](
            gates, prev_cell, dh, dc_next, dgates, dpc, n_rows,
            C=prev_cell.shape[-1], BLOCK_R=block_r, BLOCK_C=block_c,
            num_warps=4,
        )
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
        # window's cell state) and may hand over a strided view: the kernel
        # takes dense tensors, so both are made dense here, in the open
        grads = [
            torch.zeros_like(prev_cell) if g is None else g.contiguous()
            for g in (dh, dc_next)
        ]
        return fused_lstm_gates_bwd(gates, prev_cell, *grads)


def fused_lstm_gates(gates: torch.Tensor, prev_cell: torch.Tensor):
    """``(hidden, cell)`` from the gate conv output ``[B, H, W, 4C]`` and
    the previous cell ``[B, H, W, C]`` (same dtype). Differentiable in both.

    A CUDA input launches the K3 Triton kernel (both tensors contiguous)
    and counts the launch in ``fused_lstm_gates.launches``; its gradient is
    :func:`fused_lstm_gates_bwd`. A CPU input runs
    :func:`fused_lstm_gates_plain`, differentiable through autograd.
    """
    _check(gates, prev_cell)
    if gates.device.type == "cpu":
        return fused_lstm_gates_plain(gates, prev_cell)
    return _FusedGates.apply(gates, prev_cell)


fused_lstm_gates.launches = 0
