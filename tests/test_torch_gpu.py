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

from openess_tpu_torch.ops import lstm_gates as k3
from openess_tpu_torch.ops import segment_pool as k2
from openess_tpu_torch.ops import voxelize_chunked as k1

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
@pytest.mark.parametrize("hw", [(48, 96), (37, 130)])
def test_k1_kernel_matches_plain(cuda, t16, hw):
    H, W = hw
    rng = np.random.default_rng(1205)
    wire = tuple(torch.from_numpy(np.asarray(a)).to(cuda)
                 for a in _wire(rng, 3, 5000, H, W, t16))
    before = k1.voxelize_chunked_trilinear.launches
    got = k1.voxelize_chunked_trilinear(*wire, num_bins=5, height=H, width=W)
    ref = k1.voxelize_chunked_trilinear_plain(*wire, num_bins=5, height=H,
                                              width=W)
    torch.cuda.synchronize()
    assert k1.voxelize_chunked_trilinear.launches == before + 1
    assert (got - ref).abs().max() <= 1e-5 * ref.abs().max()


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


def test_k3_kernel_refuses_strided_input(cuda):
    g = torch.zeros(1, 4, 4, 32, device=cuda).permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="contiguous"):
        k3.fused_lstm_gates(g, torch.zeros(1, 4, 4, 8, device=cuda))


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
