"""The port's hand-written kernels against their plain versions on a CUDA
card. A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker
and skip where no card is present. They need neither JAX nor the shared
``conftest.py``, so on a card machine without JAX run them with
``python -m pytest tests/test_torch_gpu.py -q --noconftest``.
``chip_smoke.py`` makes the same comparisons at the serving path's
full-width shapes."""
import numpy as np
import pytest
import torch

from openess_tpu_torch.ops import lstm_gates as k3
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
