"""The port's hand-written kernels against their plain versions on a CUDA
card. A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip where no card is present. They need neither JAX nor the shared
``conftest.py``, so on a card machine without JAX run them with
``python -m pytest tests/test_torch_gpu.py -q --noconftest``.
``chip_smoke.py`` makes the same comparisons at the main paths'
full-width shapes."""
import numpy as np
import pytest
import torch

from chip_smoke import K4_EDGE_CASES, k4_edge_wire, small_residual_scales
from openess_tpu_torch.ops import lstm_gates as k3
from openess_tpu_torch.ops import segment_pool as k2
from openess_tpu_torch.ops import voxelize_chunked as k1
from openess_tpu_torch.ops import voxelize_mxu as k56
from openess_tpu_torch.ops.tile_splat import tile_plan
from openess_tpu_torch.ops.voxelize import (
    voxel_grid_bilinear_t,
    voxelize_windows_trilinear,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _wire(rng, nw, k, H, W, t16):
    x = rng.uniform(-1.5, W + 0.5, (nw, k)).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (nw, k)), axis=1)
    valid = rng.random((nw, k)) < 0.9
    return k1.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                 chunk=256, t16=t16)


@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("hw", [(48, 96), (37, 130), (37, 151)])
def test_k1_kernel_matches_plain(cuda, t16, hw):
    """K1 through its wrapper and launched into a NaN-filled grid, at
    widths that take each store width of the splat (16, 8 and 4 bytes)."""
    H, W = hw
    rng = np.random.default_rng(1205)
    wire = tuple(torch.from_numpy(np.asarray(a)).to(cuda)
                 for a in _wire(rng, 3, 5000, H, W, t16))
    before = k1.voxelize_chunked_trilinear.launches
    got = k1.voxelize_chunked_trilinear(*wire, num_bins=5, height=H, width=W)
    ref = k1.voxelize_chunked_trilinear_plain(*wire, num_bins=5, height=H,
                                              width=W)
    nan = torch.full_like(ref, float("nan"))
    k1.voxelize_chunked_trilinear_into(nan, *wire)
    torch.cuda.synchronize()
    assert k1.voxelize_chunked_trilinear.launches == before + 1
    for out in (got, nan):
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 64, 96])
def test_k3_kernel_matches_plain(cuda, dtype, C):
    rng = np.random.default_rng(1205)
    g = torch.from_numpy(rng.normal(size=(2, 9, 13, 4 * C)) * 3).to(cuda, dtype)
    pc = torch.from_numpy(rng.normal(size=(2, 9, 13, C))).to(cuda, dtype)
    before = k3.fused_lstm_gates.launches
    h, c = k3.fused_lstm_gates(g, pc)
    hp, cp = k3.fused_lstm_gates_plain(g, pc)
    torch.cuda.synchronize()
    assert k3.fused_lstm_gates.launches == before + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    for a, b in ((h, hp), (c, cp)):
        mag = torch.maximum(a.float().abs(), b.float().abs())
        assert ((a.float() - b.float()).abs() <= mag * ulp + 1e-6).all()


def _assert_gradients_close(a, b, dtype):
    """bf16: one ulp of the value (both round the same f32 result). f32:
    1e-5 of the tensor's largest value: ``1 - tanh^2`` and ``1 - g^2``
    cancel, so a small gradient's error is set by its factors' size."""
    if dtype == torch.bfloat16:
        mag = torch.maximum(a.abs(), b.abs())
        assert ((a - b).abs() <= mag * 2.0 ** -7 + 1e-6).all()
    else:
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 64, 96])
def test_k3_backward_kernel_matches_plain(cuda, dtype, C):
    rng = np.random.default_rng(1205)
    shape = (2, 9, 13)
    g = torch.from_numpy(rng.normal(size=shape + (4 * C,)) * 3).to(cuda, dtype)
    pc, dh, dc = (torch.from_numpy(rng.normal(size=shape + (C,))).to(
        cuda, dtype) for _ in range(3))
    before = k3.fused_lstm_gates_bwd.launches
    got = k3.fused_lstm_gates_bwd(g, pc, dh, dc)
    ref = k3.fused_lstm_gates_bwd_plain(g, pc, dh, dc)
    torch.cuda.synchronize()
    assert k3.fused_lstm_gates_bwd.launches == before + 1
    for a, b in zip(got, ref):
        assert a.dtype == dtype and a.shape == b.shape
        _assert_gradients_close(a.float(), b.float(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_autograd_on_the_card_matches_the_cpu(cuda, dtype):
    """``fused_lstm_gates`` under autograd on CUDA (both kernels, through
    the ``autograd.Function``, with the cell's gradient missing) against
    autograd through the plain forward on the CPU."""
    rng = np.random.default_rng(3)
    C, shape = 24, (2, 5, 7)
    g0 = torch.from_numpy(rng.normal(size=shape + (4 * C,)) * 2).to(dtype)
    pc0 = torch.from_numpy(rng.normal(size=shape + (C,))).to(dtype)
    wgt = torch.from_numpy(rng.normal(size=shape + (C,))).float()
    out = {}
    fwd0 = k3.fused_lstm_gates.launches
    bwd0 = k3.fused_lstm_gates_bwd.launches
    for dev in ("cpu", cuda):
        g = g0.clone().to(dev).requires_grad_(True)
        pc = pc0.clone().to(dev).requires_grad_(True)
        h, _ = k3.fused_lstm_gates(g, pc)  # the cell gets no gradient
        (h.float() * wgt.to(dev)).sum().backward()
        out[str(dev)] = (g.grad.float().cpu(), pc.grad.float().cpu())
    assert k3.fused_lstm_gates.launches == fwd0 + 1
    assert k3.fused_lstm_gates_bwd.launches == bwd0 + 1
    for a, b in zip(*out.values()):
        _assert_gradients_close(a, b, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [8, 12, 64])
def test_k3_scalar_and_vector_instantiations_match_plain(cuda, dtype, C):
    """Both K3 kernels at a C that takes the 16-byte vector instantiation
    and one that takes the scalar one (C = 12 in bf16)."""
    rng = np.random.default_rng(C)
    shape = (3, 7, 11)
    g = torch.from_numpy(rng.normal(size=shape + (4 * C,)) * 3).to(cuda, dtype)
    pc, dh, dc = (torch.from_numpy(rng.normal(size=shape + (C,))).to(
        cuda, dtype) for _ in range(3))
    plan = k3.launch_plan(C, dtype, 3 * 7 * 11)
    assert plan.scalar == (C == 12 and dtype == torch.bfloat16)
    f0 = k3.fused_lstm_gates.launches
    b0 = k3.fused_lstm_gates_bwd.launches
    got_f = k3.fused_lstm_gates(g, pc)
    got_b = k3.fused_lstm_gates_bwd(g, pc, dh, dc)
    want_f = k3.fused_lstm_gates_plain(g, pc)
    want_b = k3.fused_lstm_gates_bwd_plain(g, pc, dh, dc)
    torch.cuda.synchronize()
    assert k3.fused_lstm_gates.launches == f0 + 1
    assert k3.fused_lstm_gates_bwd.launches == b0 + 1
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -20
    for a, b in zip(got_f, want_f):
        mag = torch.maximum(a.float().abs(), b.float().abs())
        assert ((a.float() - b.float()).abs() <= mag * ulp + 1e-6).all()
    for a, b in zip(got_b, want_b):
        _assert_gradients_close(a.float(), b.float(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("missing", ["dh", "dc_next", "both"])
def test_k3_backward_reads_a_missing_gradient_as_zero(cuda, dtype, missing):
    rng = np.random.default_rng(5)
    C, shape = 64, (2, 9, 13)
    g = torch.from_numpy(rng.normal(size=shape + (4 * C,)) * 3).to(cuda, dtype)
    pc, dh, dc = (torch.from_numpy(rng.normal(size=shape + (C,))).to(
        cuda, dtype) for _ in range(3))
    if missing in ("dh", "both"):
        dh = None
    if missing in ("dc_next", "both"):
        dc = None
    got = k3.fused_lstm_gates_bwd(g, pc, dh, dc)
    zero = torch.zeros_like(pc)
    ref = k3.fused_lstm_gates_bwd_plain(g, pc, zero if dh is None else dh,
                                        zero if dc is None else dc)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        _assert_gradients_close(a.float(), b.float(), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_convlstm_cell_under_autograd_matches_the_cpu(cuda, dtype):
    """A ``ConvLSTMCell`` with K3 gates, forward and backward on the card
    (one launch of each kernel, the cell's gradient missing), against the
    same cell on the CPU: the gradients of its input and of its gates
    conv's weight."""
    from openess_tpu_torch.models.e2vid import ConvLSTMCell

    rng = np.random.default_rng(9)
    x0 = torch.from_numpy(rng.normal(size=(2, 8, 12, 20))).float()
    h0 = torch.from_numpy(rng.normal(size=(2, 16, 12, 20))).float()
    wgt = torch.from_numpy(rng.normal(size=(2, 16, 12, 20))).float()
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    try:
        for dev in ("cpu", cuda):
            torch.manual_seed(0)  # the same weights on both devices
            c = ConvLSTMCell(8, 16, 3, fused_gates=True).to(dev)
            x = x0.clone().to(dev, dtype).requires_grad_(True)
            f0 = k3.fused_lstm_gates.launches
            b0 = k3.fused_lstm_gates_bwd.launches
            hidden, _ = c(x, (h0.to(dev, dtype), h0.to(dev, dtype)))
            (hidden.float() * wgt.to(dev)).sum().backward()
            launched = (k3.fused_lstm_gates.launches - f0,
                        k3.fused_lstm_gates_bwd.launches - b0)
            assert launched == ((1, 1) if dev == cuda else (0, 0))
            out[str(dev)] = (x.grad.float().cpu().clone(),
                             c.Gates.weight.grad.float().cpu().clone())
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(*out.values()):
        assert (a - b).abs().max() <= tol * b.abs().max()


def _int_wire(rng, nw, k, H, W, t16):
    x = rng.integers(-2, W + 2, (nw, k)).astype(np.float32)
    y = rng.integers(-2, H + 2, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (nw, k)), axis=1)
    valid = rng.random((nw, k)) < 0.9
    return k1.chunk_events_batch(x, y, p, t, valid, height=H, width=W,
                                 chunk=256, integer_coords=True, t16=t16)


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("hw", [(48, 96), (37, 150), (37, 151), (260, 346)])
def test_k4_kernel_matches_plain(cuda, t16, hw, separate_pol):
    """K4 (the tile owner) against its plain version through its wrapper
    and launched into a NaN-filled grid: every cell is written, those of
    the partial tiles at the frame's right and lower edges too."""
    H, W = hw
    rng = np.random.default_rng(1205)
    wire = tuple(torch.from_numpy(np.asarray(a)).to(cuda)
                 for a in _int_wire(rng, 3, 5000, H, W, t16))
    kw = dict(num_bins=5, height=H, width=W, separate_pol=separate_pol)
    before = k1.voxelize_chunked_bilinear_t.launches
    got = k1.voxelize_chunked_bilinear_t(*wire, **kw)
    ref = k1.voxelize_chunked_bilinear_t_plain(*wire, **kw)
    nan = torch.full_like(ref, float("nan"))
    k1.voxelize_chunked_bilinear_t_into(nan, *wire,
                                        separate_pol=separate_pol)
    torch.cuda.synchronize()
    assert k1.voxelize_chunked_bilinear_t.launches == before + 1
    assert got.shape == (3, 10 if separate_pol else 5, H, W)
    assert ref.abs().max() > 0
    for out in (got, nan):
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("case", [c.replace(" ", "_")
                                  for c in K4_EDGE_CASES])
def test_k4_tile_splat_edge_cases(cuda, case, t16, separate_pol):
    """K4 against its plain version on the wires a tile owner must not
    assume away (``chip_smoke.k4_edge_wire``), through its wrapper and
    launched into a NaN-filled grid."""
    wire, H, W = k4_edge_wire(np.random.default_rng(1205),
                              case.replace("_", " "), t16)
    wire = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in wire)
    kw = dict(num_bins=5, height=H, width=W, separate_pol=separate_pol)
    ref = k1.voxelize_chunked_bilinear_t_plain(*wire, **kw)
    got = k1.voxelize_chunked_bilinear_t(*wire, **kw)
    nan = torch.full_like(ref, float("nan"))
    before = k1.voxelize_chunked_bilinear_t.launches
    k1.voxelize_chunked_bilinear_t_into(nan, *wire,
                                        separate_pol=separate_pol)
    torch.cuda.synchronize()
    assert k1.voxelize_chunked_bilinear_t.launches == before
    assert ref.abs().max() > 0
    for out in (got, nan):
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    if case == "empty_window":
        assert not got[1].any() and not nan[1].any()


def _k1_edge_wire(rng, case, t16):
    """A K1 wire for one edge case, with its frame ``(H, W)``: chunks
    shuffled along the chunk axis, malformed and unaligned descriptors,
    all-padding chunks (``counts == 0``) past the 256 a block reads at a
    time, an empty window, a ragged 100x150 synthetic frame, or 16-event
    chunks, so that one tile meets more than 256 of them."""
    H, W = (100, 150) if case == "ragged" else (48, 96)
    chunk = 16 if case == "many_chunks" else 256
    x = rng.uniform(-1.5, W + 0.5, (3, 5000)).astype(np.float32)
    y = rng.uniform(-1.5, H + 0.5, (3, 5000)).astype(np.float32)
    p = rng.integers(0, 2, (3, 5000)).astype(np.float32)
    t = np.sort(rng.uniform(0, 1e6, (3, 5000)), axis=1)
    wire = list(k1.chunk_events_batch(x, y, p, t, rng.random((3, 5000)) < .9,
                                      height=H, width=W, chunk=chunk,
                                      t16=t16))
    nbc = wire[0].shape[1]
    if case == "shuffled":
        for w in range(3):
            perm = rng.permutation(nbc)
            for a in wire[:6]:
                a[w] = a[w][perm]
    elif case == "malformed":
        h_pad, w_pad = k1.padded_grid(H, W)
        r0 = rng.integers(-20, h_pad + 20, (3, nbc))
        c0 = rng.integers(-20, w_pad + 20, (3, nbc))
        wire[5] = ((r0 & 0xFFFF) | (c0 << 16)).astype(np.int32)
    elif case == "padding_chunks":
        wire = list(k1.pad_wire_chunks(tuple(wire), 300))
    elif case == "empty_window":
        wire[4][1] = 0
    return tuple(wire), H, W


@pytest.mark.parametrize("t16", [False, True])
@pytest.mark.parametrize("case", ["shuffled", "malformed", "padding_chunks",
                                  "empty_window", "ragged", "many_chunks"])
def test_k1_tile_splat_edge_cases(cuda, case, t16):
    """K1 against its plain version on the wires a tile owner must not
    assume away, through its wrapper and launched into a NaN-filled grid:
    every cell is written, a tile that no event touches too."""
    wire, H, W = _k1_edge_wire(np.random.default_rng(1205), case, t16)
    wire = tuple(torch.from_numpy(np.ascontiguousarray(a)).to(cuda)
                 for a in wire)
    kw = dict(num_bins=5, height=H, width=W)
    ref = k1.voxelize_chunked_trilinear_plain(*wire, **kw)
    got = k1.voxelize_chunked_trilinear(*wire, **kw)
    nan = torch.full_like(ref, float("nan"))
    before = k1.voxelize_chunked_trilinear.launches
    k1.voxelize_chunked_trilinear_into(nan, *wire)
    torch.cuda.synchronize()
    assert k1.voxelize_chunked_trilinear.launches == before
    assert ref.abs().max() > 0
    for out in (got, nan):
        assert torch.isfinite(out).all()
        assert (out - ref).abs().max() <= 1e-5 * ref.abs().max()
    if case == "empty_window":
        assert not got[1].any() and not nan[1].any()


def _sorted_within_slots(counts, offsets, binned):
    """The binned events of every run, ordered by slot, then by (x, y, tn,
    v): the card fills each run in any order."""
    rows, slot = k56.binned_rows(counts, offsets)
    b = binned[rows]
    order = torch.arange(rows.numel(), device=b.device)
    for col in (3, 2, 1, 0):
        order = order[torch.sort(b[order, col], stable=True).indices]
    order = order[torch.sort(slot[order], stable=True).indices]
    return b[order]


@pytest.mark.parametrize("hw,nw", [((48, 96), 3), ((100, 150), 3),
                                   ((37, 151), 3), ((480, 640), 8)])
def test_k5_binning_and_splat_match_plain(cuda, hw, nw):
    """K5's passes on the card: the counts and offsets exactly, each slot's
    events as a multiset, and the splat into a NaN-filled grid against the
    exact scatter (1e-5 of the max)."""
    H, W = hw
    k = 3000
    ev = tuple(a.to(cuda) for a in _grid_events(
        np.random.default_rng(1205), nw, k, H, W, "edges", False))
    plan = tile_plan(5, H, W)
    kw = dict(num_windows=nw, num_bins=5, height=H, width=W)
    counts, offsets, binned = k56.bin_events_trilinear(*ev, **kw)
    pc, po, pb = k56.bin_events_trilinear_plain(*ev, num_windows=nw,
                                                plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(counts, pc) and torch.equal(offsets, po)
    assert torch.equal(_sorted_within_slots(counts, offsets, binned),
                       _sorted_within_slots(pc, po, pb))
    grid = torch.full((nw * 5, H, W), float("nan"), device=cuda)
    k56.splat_binned_trilinear(counts, offsets, binned, grid,
                               num_windows=nw, plan=plan)
    ref = voxelize_windows_trilinear(*ev, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(grid).all() and not grid[:5].any()
    assert (grid - ref).abs().max() <= 1e-5 * ref.abs().max()


def _grid_events(rng, nw, k, H, W, case, integer):
    """Flat padded events for ``nw`` windows: fractional (K5) or integer
    (K6) coordinates reaching past the frame, 90 % valid; ``case`` adds a
    window of padding only and one window holding a single event."""
    if integer:
        x = rng.integers(-3, W + 3, (nw, k)).astype(np.float32)
        y = rng.integers(-3, H + 3, (nw, k)).astype(np.float32)
    else:
        x = rng.uniform(-1.5, W + 0.5, (nw, k)).astype(np.float32)
        y = rng.uniform(-1.5, H + 0.5, (nw, k)).astype(np.float32)
    p = rng.integers(0, 2, (nw, k)).astype(np.float32)
    t = 1e8 + np.sort(rng.uniform(0, 5e4, (nw, k)), axis=1)
    valid = rng.random((nw, k)) < 0.9
    if case == "edges":
        valid[0] = False
        valid[1] = False
        valid[1, 7] = True
        x[1, 7], y[1, 7] = W // 2 + (0 if integer else 0.25), H // 2
    return tuple(torch.from_numpy(np.asarray(a, dt).reshape(-1))
                 for a, dt in ((x, np.float32), (y, np.float32),
                               (p, np.float32), (t, np.float32),
                               (valid, bool)))


@pytest.mark.parametrize("case", ["dense", "edges"])
@pytest.mark.parametrize("hw", [(48, 96), (37, 130), (37, 151), (480, 640)])
def test_k5_kernel_matches_plain(cuda, hw, case):
    """K5 against the exact scatter on the card: 1e-5 of the grid max
    (atomics order); a window of padding only stays exactly zero."""
    H, W = hw
    nw, k = 3, 5000
    ev = tuple(a.to(cuda) for a in _grid_events(
        np.random.default_rng(1205), nw, k, H, W, case, False))
    kw = dict(num_windows=nw, num_bins=5, height=H, width=W)
    before = k56.voxelize_windows_trilinear_mxu.launches
    got = k56.voxelize_windows_trilinear_mxu(*ev, **kw)
    ref = voxelize_windows_trilinear(*ev, **kw)
    torch.cuda.synchronize()
    assert k56.voxelize_windows_trilinear_mxu.launches == before + 1
    assert got.shape == (nw * 5, H, W) and ref.abs().max() > 0
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    if case == "edges":  # the single event's weights sum to 1
        assert not got[:5].any()
        assert abs(got[5:10].sum().item()) == pytest.approx(1.0)


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("case", ["dense", "edges"])
@pytest.mark.parametrize("hw", [(48, 96), (37, 150), (37, 151), (260, 346)])
def test_k6_kernel_matches_plain(cuda, hw, case, separate_pol):
    H, W = hw
    nw, k = 3, 5000
    ev = tuple(a.to(cuda) for a in _grid_events(
        np.random.default_rng(1205), nw, k, H, W, case, True))
    kw = dict(num_bins=5, height=H, width=W, separate_pol=separate_pol)
    before = k56.voxelize_windows_bilinear_t_mxu.launches
    got = k56.voxelize_windows_bilinear_t_mxu(*ev, num_windows=nw, **kw)
    ref = voxel_grid_bilinear_t(*(a.view(nw, k) for a in ev), **kw)
    torch.cuda.synchronize()
    cout = 10 if separate_pol else 5
    assert k56.voxelize_windows_bilinear_t_mxu.launches == before + 1
    assert got.shape == (nw * cout, H, W) and ref.abs().max() > 0
    ref = ref.reshape(got.shape)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()
    if case == "edges":
        assert not got[:cout].any()
        assert got[cout:2 * cout].abs().sum().item() == pytest.approx(1.0)


@pytest.mark.parametrize("separate_pol", [False, True])
@pytest.mark.parametrize("case", ["dense", "edges"])
@pytest.mark.parametrize("hw", [(48, 96), (37, 150), (37, 151), (260, 346)])
def test_k6_binning_and_splat_match_plain(cuda, hw, case, separate_pol):
    """K6's passes on the card: the counts and offsets exactly, each
    tile's events as a multiset, and the splat into a NaN-filled grid
    against its plain version and the exact scatter (1e-5 of the max)."""
    H, W = hw
    nw, k = 3, 5000
    ev = tuple(a.to(cuda) for a in _grid_events(
        np.random.default_rng(1205), nw, k, H, W, case, True))
    plan = k56.bilinear_t_plan(5, H, W, separate_pol)
    kw = dict(num_windows=nw, num_bins=5)
    counts, offsets, binned = k56.bin_events_bilinear_t(
        *ev, **kw, height=H, width=W, separate_pol=separate_pol)
    pc, po, pb = k56.bin_events_bilinear_t_plain(*ev, **kw, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(counts, pc) and torch.equal(offsets, po)
    assert torch.equal(_sorted_within_slots(counts, offsets, binned),
                       _sorted_within_slots(pc, po, pb))
    cout = 10 if separate_pol else 5
    grid = torch.full((nw * cout, H, W), float("nan"), device=cuda)
    k56.splat_binned_bilinear_t(counts, offsets, binned, grid, **kw,
                                separate_pol=separate_pol, plan=plan)
    plain = k56.splat_binned_bilinear_t_plain(
        pc, po, pb, **kw, separate_pol=separate_pol, plan=plan)
    ref = voxel_grid_bilinear_t(*(a.view(nw, k) for a in ev), num_bins=5,
                                height=H, width=W,
                                separate_pol=separate_pol).reshape(grid.shape)
    torch.cuda.synchronize()
    assert torch.isfinite(grid).all() and ref.abs().max() > 0
    for want in (plain, ref):
        assert (grid - want).abs().max() <= 1e-5 * ref.abs().max()
    if case == "edges":
        assert not grid[:cout].any()


@pytest.mark.parametrize("dataset", ["DSEC", "DDD17"])
def test_grid_wire_on_the_card_matches_the_cpu(cuda, dataset):
    """The datasets' grid voxelizers (K5 or K6, then the crop, and on DDD17
    the resize) on the card against the CPU's plain path."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data import ddd17, dsec

    rng = np.random.default_rng(3)
    T, K = 2, 3000
    if dataset == "DSEC":
        mod, s, H, W = dsec, Settings(nr_events_data_b=T), 480, 640
    else:
        mod, H, W = ddd17, 260, 346
        s = Settings(dataset_name_b="DDD17_events", nr_events_data_b=T,
                     separate_pol_b=True, normalize_event_b=True)
    x, y, p, t, valid = (a.numpy().reshape(2, T, K) for a in _grid_events(
        rng, 2 * T, K, H, W, "dense", dataset == "DDD17"))
    out = [mod.voxelize_grid(s, x, y, p, t, valid, dev)
           for dev in ("cpu", cuda)]
    assert out[1].device.type == "cuda" and out[0].shape == out[1].shape
    assert (out[1].cpu() - out[0]).abs().max() <= 1e-5 * out[0].abs().max()


@pytest.mark.parametrize("wire", ["grid", "raw_events"])
def test_prefetch_loader_on_the_card_matches_inline(cuda, wire):
    """DSEC batches assembled by three loader workers, each on its own
    stream, against the same batches assembled in line: on the grid wire
    K5 runs inside ``get_batch`` (its grid within 1e-5 of the in-line
    one's max: the atomics' order), on the raw wire the C++ packer hands
    out its recycled buffers (``wire_reuse_ok`` on a card) and every key
    is equal. The consumer reads each batch on its own stream."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data import dsec
    from openess_tpu_torch.data.pipeline import PrefetchLoader, batch_indices
    from openess_tpu_torch.training.trainer import to_device

    rng = np.random.default_rng(4)
    n, T, K = 6, 2, 3000
    events = [a.numpy().reshape(n, T, K) for a in _grid_events(
        rng, n * T, K, 480, 640, "dense", False)]
    windows = [tuple(a[i] for a in events) for i in range(n)]
    s = Settings(nr_events_data_b=T, wire_format=wire, host_voxelize=False)

    class Windows:
        def __len__(self):
            return n

        def get_batch(self, idx):
            ws = [windows[i] for i in idx]
            out = dsec.event_batch(s, ws, cuda)
            out["label"] = np.stack([w[4] for w in ws])
            return out

    data = Windows()
    loader = PrefetchLoader(data, 2, shuffle=True,
                            rng=np.random.default_rng(0), device=cuda,
                            put_fn=lambda b: to_device(b, cuda),
                            num_workers=3)
    plan = batch_indices(n, 2, shuffle=True, rng=np.random.default_rng(0),
                         drop_last=True, pad_last=False)
    got = [{k: v.clone() for k, v in b.items()} for b in loader]
    assert len(got) == 3
    for (idx, _), batch in zip(plan, got):
        ref = to_device(data.get_batch(idx), cuda)
        assert sorted(batch) == sorted(ref)
        for k in ref:
            assert batch[k].device.type == "cuda", k
            if k == "event":
                gap = (batch[k] - ref[k]).abs().max()
                assert gap <= 1e-5 * ref[k].abs().max()
            else:
                assert torch.equal(batch[k], ref[k]), k


def test_k5_launched_from_threads_at_once_matches_plain(cuda):
    """Eight threads launch K5 at once (as the loader's workers do, each
    on its own stream, ctypes dropping the GIL), at frame sizes whose
    shared memory differs, so that ``tile_splat::allow_smem``'s table is
    read and written concurrently: every grid within 1e-5 of its plain
    version's max."""
    import threading

    sizes = [(48, 96), (37, 130), (64, 200), (100, 150), (37, 151),
             (80, 96), (120, 64), (33, 257)]
    evs = [tuple(a.to(cuda) for a in _grid_events(
        np.random.default_rng(i), 2, 3000, h, w, "dense", False))
        for i, (h, w) in enumerate(sizes)]
    got, errors = {}, []
    start = threading.Barrier(len(sizes))

    def work(i):
        h, w = sizes[i]
        try:
            stream = torch.cuda.Stream(cuda)
            with torch.cuda.stream(stream):
                start.wait()
                got[i] = k56.voxelize_windows_trilinear_mxu(
                    *evs[i], num_windows=2, num_bins=5, height=h, width=w)
            stream.synchronize()
        except Exception as e:  # noqa: BLE001 (reported below)
            errors.append(repr(e))

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(sizes))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i, (h, w) in enumerate(sizes):
        ref = voxelize_windows_trilinear(*evs[i], num_windows=2, num_bins=5,
                                         height=h, width=w)
        assert (got[i] - ref).abs().max() <= 1e-5 * ref.abs().max(), sizes[i]


def test_k3_kernel_refuses_strided_input(cuda):
    """Strided input is no longer refused: the op makes its inputs
    contiguous before the launch, so a strided view gives the contiguous
    copy's result, in one launch. A dtype the kernels do not take is still
    refused."""
    g = torch.randn(1, 4, 4, 32, device=cuda).permute(0, 2, 1, 3)
    pc = torch.randn(1, 4, 4, 8, device=cuda)
    before = k3.fused_lstm_gates.launches
    got = k3.fused_lstm_gates(g, pc)
    assert k3.fused_lstm_gates.launches == before + 1
    want = k3.fused_lstm_gates(g.contiguous(), pc)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        k3.fused_lstm_gates(g.half(), pc.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 9, 13, 7, 5), (3, 16, 33, 256, 20),
                                   (1, 31, 17, 300, 3), (2, 5, 70, 2, 4)],
                         ids=str)
def test_k2_kernel_matches_plain(cuda, dtype, shape):
    """Odd sizes: N not a multiple of the run, D odd (one bf16 channel per
    thread), D above one 256-thread tile, ids outside the range. f32 sums
    within 1e-5 of the largest sum (atomics order), counts exact."""
    b, h, w, d, s = shape
    rng = np.random.default_rng(1205)
    feats = torch.from_numpy(rng.normal(size=(b, h, w, d))).to(cuda, dtype)
    seg = rng.integers(0, s, (b, h, w))
    seg[0, 0, :3] = (-1, s + 1, 10 ** 6)
    seg = torch.from_numpy(seg).to(cuda)
    ids, total = k2.global_segment_ids(seg, s)
    rows = feats.view(-1, d)
    before = k2.segment_pool_sums.launches
    sums, counts = k2.segment_pool_sums(rows, ids, total)
    ps, pc = k2.segment_pool_sums_plain(rows, ids, total)
    torch.cuda.synchronize()
    assert k2.segment_pool_sums.launches == before + 1
    assert sums.dtype == counts.dtype == torch.float32
    assert torch.equal(counts, pc)
    assert (sums - ps).abs().max() <= 1e-5 * ps.abs().max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_mean_pool_and_gradient_on_the_card(cuda, dtype):
    """``segment_mean_pool`` on CUDA (kernel forward, gather backward)
    against the same call on the CPU (plain version, autograd)."""
    rng = np.random.default_rng(7)
    b, h, w, d, s = 2, 12, 20, 64, 6
    feats = torch.from_numpy(rng.normal(size=(b, h, w, d))).to(dtype)
    seg = torch.from_numpy(rng.integers(0, s - 1, (b, h, w)))  # one empty
    wgt = torch.from_numpy(rng.normal(size=(b * s, d))).float()
    out = {}
    for dev in ("cpu", cuda):
        f = feats.to(dev).detach().clone().requires_grad_(True)
        m, c = k2.segment_mean_pool(f, seg.to(dev), segments_per_image=s)
        (m.float() * wgt.to(dev)).sum().backward()
        out[str(dev)] = (m.detach().cpu(), c.detach().cpu(), f.grad.cpu())
    (m0, c0, g0), (m1, c1, g1) = out.values()
    assert m1.dtype == dtype and g1.dtype == dtype
    assert torch.equal(c0, c1)
    # f32: sum order only, 1e-5 of the largest value; bf16: the f32 means
    # round to bf16 last, so a value may land one bf16 ulp away
    for a, b in ((m0.float(), m1.float()), (g0.float(), g1.float())):
        if dtype == torch.bfloat16:
            assert ((a - b).abs() <= 2.0 ** -7 * a.abs().clamp_min(1e-3)).all()
        else:
            assert (a - b).abs().max() <= 1e-5 * a.abs().max()


def test_k2_kernel_refuses_what_it_cannot_take(cuda):
    rows = torch.zeros(8, 4, device=cuda)
    ids = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        k2.segment_pool_sums(rows.t().contiguous().t(), ids, 2)
    with pytest.raises(ValueError, match="int32"):
        k2.segment_pool_sums(rows, ids.long(), 2)
    with pytest.raises(ValueError, match="bf16 or f32"):
        k2.segment_pool_sums(rows.half(), ids, 2)


def test_finetune_step_with_unfrozen_e2vid_on_the_card_matches_cpu(cuda):
    """One f32 fine-tune step with ``unfrozen_e2vid`` at 32x64, T = 3 on
    CUDA (K1, K3 forward and backward under autograd) against the same step
    on the CPU (plain versions): the loss within 1e-4 relative, E2VID's
    gradients within 10 % of each tensor's largest value, and 3 + 3 launches
    of K3 per window. The gradients pass the head's instance norms, whose
    f32 backward is ill-conditioned at random init: over 13 runs on an H100
    they sat 0.3 % to 4.5 % from the CPU's, moving that much from run to run
    with the order of K1's atomics (1e-7 in the windows), and 4.1 % with
    the CPU's own windows, the plain gate path and deterministic cuDNN. K3's
    backward alone is held to 1 ulp above."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data.synthetic import SyntheticESS
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        T = 3
        s = Settings(
            dataset_name_b="synthetic_events", img_size_b=(32, 64),
            semseg_num_classes=6, nr_events_data_b=T, compute_dtype="float32",
            data_augmentation_train=False, config_option="frame2voxel",
            if_finetuning=True, unfrozen_e2vid=True, e2vid_fused_gates=True)
        ds = SyntheticESS(num_samples=2, height=32, width=64, num_classes=6,
                          num_windows=T)
        host = ds.raw_wire_batch([0, 1])
        out = {}
        fwd0 = k3.fused_lstm_gates.launches
        bwd0 = k3.fused_lstm_gates_bwd.launches
        for dev in (torch.device("cpu"), cuda):
            mset = build_models(s, seed=0, device=dev)
            sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
            sb._set_mode(True)
            total, _ = sb.compute_losses(
                sb._with_windows(to_device(host, dev)), 0)
            total.backward()
            out[dev.type] = (float(total.detach()), {
                k: p.grad.cpu() for k, p in
                mset.modules["front_sensor_b"].named_parameters()})
        assert k3.fused_lstm_gates.launches == fwd0 + 3 * T
        assert k3.fused_lstm_gates_bwd.launches == bwd0 + 3 * T
        (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
        assert abs(lg - lc) <= 1e-4 * abs(lc)
        assert len(gc) == 14
        for k in gc:
            scale = gc[k].abs().max()
            assert scale > 0, k
            assert (gg[k] - gc[k]).abs().max() <= 1e-1 * scale, k
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("fold", [False, True], ids=["plain", "fold"])
def test_deeplab_forward_on_the_card_matches_cpu(cuda, fold, train):
    """The DeepLabV3 student in f32 at 64x96, B = 2, on CUDA (cuDNN convs,
    TF32 off) against the CPU: both outputs within 1e-3 of their max, and
    the running statistics a train-mode forward leaves within 1e-3 of each
    tensor's max. Dropout off on both."""
    from openess_tpu_torch.models.deeplabv3 import DeepLabV3TextSeg
    from openess_tpu_torch.training.build import init_weights

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        m = DeepLabV3TextSeg(6, fold_bn=fold)
        init_weights(m, torch.Generator().manual_seed(0))
        gen = torch.Generator().manual_seed(1)
        with torch.no_grad():
            m.classifier.text_embeddings.normal_(0, 0.1, generator=gen)
            for mod_name, mod in m.backbone.named_modules():
                if mod_name.endswith("bn3"):
                    mod.weight.uniform_(0.02, 0.06, generator=gen)
        m.classifier.ASPP.dropout_rate = 0.0
        sd = {k: v.clone() for k, v in m.state_dict().items()}
        x = torch.rand((2, 64, 96, 3), generator=gen)
        out = {}
        for dev in (torch.device("cpu"), cuda):
            mm = DeepLabV3TextSeg(6, fold_bn=fold).to(dev)
            mm.load_state_dict(sd)
            mm.classifier.ASPP.dropout_rate = 0.0
            with torch.no_grad():
                logits, feats = mm(x.to(dev), train=train)
            out[dev.type] = (logits.cpu(), feats.cpu(), {
                k: v.cpu() for k, v in mm.state_dict().items()
                if "running" in k})
        for a, b in zip(out["cuda"][:2], out["cpu"][:2]):
            assert (a - b).abs().max() <= 1e-3 * b.abs().max()
        for k, v in out["cpu"][2].items():
            assert (out["cuda"][2][k] - v).abs().max() <= 1e-3 * v.abs().max()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def test_recon_pretrain_step_on_the_card_matches_cpu(cuda):
    """One f32 pretrain ``frame2recon`` step (DeepLabV3 student against the
    frame teacher, NCE through K2 on both features, dense CLIP, SAM
    distillation) at 64x96, B = 2 on CUDA against the CPU: every loss
    within 1e-3 relative; each gradient tensor within 6e-2 relative L2 and
    their median within 1e-2, the bounds ``test_torch_recon_train.py``
    holds the port to against JAX (the f32 backward through 60 train-mode
    BatchNorms of batch 2); K2 launched twice, on the student's f32
    features and the teacher's."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data.synthetic import SyntheticESS
    from openess_tpu_torch.training.build import build_models
    from openess_tpu_torch.training.optim import make_optimizer
    from openess_tpu_torch.training.steps import StepBuilder
    from openess_tpu_torch.training.trainer import to_device

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        s = Settings(
            dataset_name_b="synthetic_events", img_size_b=(64, 96),
            semseg_num_classes=6, nr_events_data_b=2, compute_dtype="float32",
            data_augmentation_train=False, config_option="frame2recon",
            if_pretraining=True, if_spatial_contrastive=True,
            if_dense_clip_supervision=True, if_sam_distillation=True,
            superpixel_size=20)
        ds = SyntheticESS(num_samples=2, height=64, width=96, num_classes=6,
                          num_windows=2)
        host = {k: v for k, v in ds.voxelized_batch([0, 1]).items()
                if k != "event"}
        out = {}
        for dev in (torch.device("cpu"), cuda):
            mset = build_models(s, seed=0, device=dev)
            small_residual_scales(mset)
            mset.modules["model_recon"].classifier.ASPP.dropout_rate = 0.0
            sb = StepBuilder(s, mset, make_optimizer(s, mset), 1)
            sb._set_mode(True)
            before = k2.segment_pool_sums.launches
            total, losses = sb.compute_losses(to_device(host, dev), 0)
            total.backward()
            launches = k2.segment_pool_sums.launches - before
            out[dev.type] = ({k: float(v.detach()) for k, v in
                              losses.items()},
                             {f"{n}.{k}": p.grad.cpu()
                              for n, m in mset.modules.items()
                              for k, p in m.named_parameters()
                              if p.grad is not None}, launches)
        (lc, gc, nc), (lg, gg, ng) = out["cpu"], out["cuda"]
        assert nc == 0 and ng == 2
        assert set(lc) == {"contrastive_nce_loss", "dense_clip_loss",
                           "sam_distillation_loss", "total_loss"}
        for k in lc:
            assert abs(lg[k] - lc[k]) <= 1e-3 * abs(lc[k]), k
        assert gg.keys() == gc.keys()
        errs = []
        for k in gc:
            assert gc[k].norm() > 0, k
            errs.append(float((gg[k] - gc[k]).norm() / gc[k].norm()))
            assert errs[-1] <= 6e-2, k
        assert float(np.median(errs)) <= 1e-2
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


def test_s2d_on_the_card_matches_cpu(cuda, monkeypatch):
    """E2VID's space-to-depth form in f32 with K3's gates on the card
    against the CPU's (plain gates), and against the standard form on the
    card: each latent within 1e-4 of its max (TF32 off)."""
    from openess_tpu_torch.models.e2vid import E2VIDReconstructor

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    torch.manual_seed(0)
    std = E2VIDReconstructor(planar_input=True, latent_only=True,
                             fused_gates=True)
    s2d = E2VIDReconstructor(planar_input=True, latent_only=True,
                             fused_gates=True, s2d=True)
    s2d.load_state_dict(std.state_dict())
    x = torch.randn(2, 3, 5, 64, 96)
    x[x.abs() < 0.3] = 0
    with torch.no_grad():
        _, cpu = s2d(x)
        _, gpu = s2d.to(cuda)(x.to(cuda))
        _, ref = std.to(cuda)(x.to(cuda))
    for k in cpu:
        scale = cpu[k].abs().max().item()
        assert (gpu[k].cpu() - cpu[k]).abs().max().item() <= 1e-4 * scale, k
        assert (gpu[k] - ref[k]).abs().max().item() <= 1e-4 * scale, k


def test_val_epoch_dumps_on_the_card(cuda, tmp_path):
    """``val_epoch`` with ``vis_dir`` on a raw-wire batch on the card writes
    the five PNGs; the event previews launch K1 once."""
    from openess_tpu_torch.config.settings import Settings
    from openess_tpu_torch.data.synthetic import SyntheticESS
    from openess_tpu_torch.training.trainer import Trainer

    s = Settings(dataset_name_b="synthetic_events", img_size_b=(32, 48),
                 semseg_num_classes=6, nr_events_data_b=2,
                 config_option="frame2voxel", if_finetuning=True,
                 if_pretraining=False, batch_size_b=2, vis_dir=str(tmp_path))
    ds = SyntheticESS(num_samples=2, height=32, width=48, num_classes=6,
                      num_windows=2, events_per_window=500)
    ds.get_batch = lambda idx: ds.raw_wire_batch(list(idx))
    trainer = Trainer(s, ds, ds, device=cuda)
    before = k1.voxelize_chunked_trilinear.launches
    trainer.val_epoch()
    torch.cuda.synchronize()
    # the eval step, the viz step and the previews
    assert k1.voxelize_chunked_trilinear.launches == before + 3
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"{n}_e000.png" for n in ("confusion", "confusion_norm",
                                  "semseg_pred_gt", "event_preview",
                                  "pca_latent"))


def _export_settings(dtype, **kw):
    from openess_tpu_torch.config.settings import Settings

    return Settings(dataset_name_b="synthetic_events", img_size_b=(64, 96),
                    semseg_num_classes=6, nr_events_data_b=2,
                    compute_dtype=dtype, e2vid_fused_gates=True,
                    config_option="frame2voxel", if_supervised_only=True,
                    **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_op_counts_each_launch_of_a_streaming_artifact(cuda, dtype,
                                                          tmp_path):
    """A streaming step exported on the card, saved and loaded: each call
    launches K3 three times (the op's CUDA implementation, counted as in
    eager mode), and its labels equal the eager module's over 3 windows
    with the carry fed back, its logits within 1e-5 (f32) or 1e-3 of the
    max (bf16)."""
    from openess_tpu_torch import export_model as em
    from openess_tpu_torch.training.build import build_models

    s = _export_settings(dtype, batch_size_b=2)
    module, args = em.build_streaming_fn(
        s, build_models(s, seed=0, device=cuda, event_path_only=True))
    path = str(tmp_path / "s.pt2")
    em.save_artifact(em.export(module, args), path,
                     dict(kind="streaming", device=str(cuda)))
    run = em.load_artifact(path, cuda)[0].module()
    assert em.count_gate_nodes(em.load_artifact(path, cuda)[0]) == 3
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.5, (2, 5, 64, 96)).astype(np.float32)).to(cuda)
    sl = sa = args[0]
    with torch.no_grad():
        for _ in range(3):
            sl, pl, ll = module(sl, x)
            before = k3.fused_lstm_gates.launches
            sa, pa, la = run(sa, x)
            torch.cuda.synchronize()
            assert k3.fused_lstm_gates.launches == before + 3
            assert torch.equal(pa, pl)
            tol = 1e-5 if dtype == "float32" else 1e-3 * ll.abs().max()
            assert (la.float() - ll.float()).abs().max() <= tol


def test_batch_artifact_equals_eager_on_the_card(cuda, tmp_path):
    """The batch step (T = 2) exported with a symbolic batch on the card:
    3 T K3 launches a call, labels equal to ``StepBuilder.infer``'s at
    B = 2 and 3, logits within 1e-5 (f32)."""
    from openess_tpu_torch import export_model as em
    from openess_tpu_torch.training.build import build_models

    s = _export_settings("float32", batch_size_b=2)
    module, x = em.build_infer_fn(
        s, build_models(s, seed=0, device=cuda, event_path_only=True))
    ep = em.export(module, (x,), poly_batch=True)
    run = ep.module()
    for b in (2, 3):
        x = torch.from_numpy(np.random.default_rng(b).normal(
            0, 0.5, (b, 2, 5, 64, 96)).astype(np.float32)).to(cuda)
        with torch.no_grad():
            pl, ll = module(x)
            before = k3.fused_lstm_gates.launches
            pa, la = run(x)
            torch.cuda.synchronize()
        assert k3.fused_lstm_gates.launches == before + 6
        assert torch.equal(pa, pl)
        assert (la - ll).abs().max() <= 1e-5


def test_reconstruct_label_on_the_card_matches_plain(cuda):
    """The offline reconstruction's per-label work (3 windows, 48x64) in
    f32: K3's gates (3 launches a window) against the plain gates on the
    card and against the CPU, before post-processing."""
    from openess_tpu_torch import generate_reconstructions as gr
    from openess_tpu_torch.models.e2vid import E2VIDReconstructor

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            weights = E2VIDReconstructor().state_dict()
        rng = np.random.default_rng(3)
        x = rng.uniform(0, 63, (3, 2000)).astype(np.float32)
        y = rng.uniform(0, 47, (3, 2000)).astype(np.float32)
        p = rng.integers(0, 2, (3, 2000)).astype(np.float32)
        t = np.sort(rng.uniform(0, 5e4, (3, 2000)), axis=1)
        valid = np.ones((3, 2000), bool)
        imgs = {}
        for name, dev, fused in (("k3", cuda, True), ("plain", cuda, False),
                                 ("cpu", torch.device("cpu"), False)):
            recon = gr.build_reconstructor(weights, dev, torch.float32, fused)
            before = k3.fused_lstm_gates.launches
            imgs[name], rgb = gr.reconstruct_label(recon, x, y, p, t, valid,
                                                   48, 64)
            assert k3.fused_lstm_gates.launches - before == (9 if fused
                                                            else 0)
            assert rgb.shape == (48, 64, 3) and rgb.dtype == np.uint8
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for name in ("k3", "plain"):
        assert np.abs(imgs[name] - imgs["cpu"]).max() <= 1e-4
    assert np.abs(imgs["k3"] - imgs["plain"]).max() <= 1e-5


def test_maskclip_on_the_card_matches_cpu(cuda):
    """The MaskCLIP extractor (2 layers, width 128, 2 heads) in f32 on the
    card against the CPU, on a 50x70 image (corner padding): within 1e-4
    of max|logits|; bf16 on the card finite, with the same shape."""
    from openess_tpu_torch.models.maskclip import MaskClipFeatureExtractor

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False  # the patch embedding's conv
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(1)
            model = MaskClipFeatureExtractor(embed_dim=128, num_layers=2,
                                             num_heads=2)
            img = torch.rand(2, 50, 70, 3)
            text = torch.randn(11, 512)
        with torch.no_grad():
            ref = model(img, text)
            got = model.to(cuda)(img.to(cuda), text.to(cuda)).cpu()
            bf16 = MaskClipFeatureExtractor(dtype=torch.bfloat16,
                                            embed_dim=128, num_layers=2,
                                            num_heads=2)
            bf16.load_state_dict(model.state_dict())
            half = bf16.to(cuda)(img.to(cuda), text.to(cuda))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    assert got.shape == ref.shape == (2, 50, 70, 11)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert half.dtype == torch.bfloat16 and torch.isfinite(half).all()


def _no_tf32():
    """Turn TF32 off for matmuls and cuDNN; returns the old settings."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return old


def test_ms_deform_attn_on_the_card_matches_cpu(cuda):
    """The deformable sampling in f32 at three levels, a third of the
    locations outside [0, 1]: within 1e-5 of max on the card."""
    from openess_tpu_torch.ops.ms_deform_attn import ms_deform_attn

    g = torch.Generator().manual_seed(2)
    shapes = ((12, 16), (6, 8), (3, 4))
    lin = sum(h * w for h, w in shapes)
    value = torch.randn(2, lin, 8, 32, generator=g)
    loc = torch.rand(2, 40, 8, 3, 4, 2, generator=g) * 1.6 - 0.3
    w = torch.rand(2, 40, 8, 3, 4, generator=g)
    ref = ms_deform_attn(value, shapes, loc, w)
    got = ms_deform_attn(value.to(cuda), shapes, loc.to(cuda),
                         w.to(cuda)).cpu()
    assert got.shape == (2, 40, 256)
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_fcclip_on_the_card_matches_cpu(cuda):
    """The narrow FC-CLIP (trunk dims 32-64, conv and mask dims 64, 10
    queries, 2 encoder and 3 decoder layers), its torch init perturbed, in
    f32 on the card with TF32 off against the CPU on a 64x96 image: the
    per-pixel class scores within 1e-4 of max; the text tower (width 64,
    2 layers) likewise; bf16 on the card finite."""
    from openess_tpu_torch.models.fcclip import CLIPTextEncoder, FCCLIP

    kw = dict(trunk_depths=(1, 2, 1, 1), trunk_dims=(32, 32, 64, 64),
              clip_embed_dim=48, conv_dim=64, mask_dim=64, num_queries=10,
              dec_layers=3, enc_layers=2)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        model = FCCLIP(**kw)
        text = CLIPTextEncoder(vocab_size=600, width=64, heads=1, layers=2,
                               embed_dim=48)
        for p in list(model.parameters()) + list(text.parameters()):
            p.data += 0.05 * torch.randn(p.shape)
        img = torch.rand(1, 64, 96, 3) * 255
        tokens = torch.zeros(3, 77, dtype=torch.long)
        tokens[:, :5] = torch.randint(1, 590, (3, 5))
        tokens[:, 5] = 599
    tc = torch.randn(8, 48)
    nt, overlap = (2, 3, 1, 2), np.array([1, 0, 1, 0])
    old = _no_tf32()
    try:
        with torch.no_grad():
            ref = model(img, tc, nt, overlap)
            ref_t = text(tokens)
            got = model.to(cuda)(img.to(cuda), tc.to(cuda), nt, overlap).cpu()
            got_t = text.to(cuda)(tokens.to(cuda)).cpu()
            half = FCCLIP(dtype=torch.bfloat16, **kw).to(cuda)
            half.load_state_dict(model.state_dict())
            h = half(img.to(cuda), tc.to(cuda), nt, overlap)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    assert got.shape == ref.shape == (1, 64, 96, 4)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (got_t - ref_t).abs().max() <= 1e-4 * ref_t.abs().max()
    assert h.dtype == torch.float32 and torch.isfinite(h).all()
