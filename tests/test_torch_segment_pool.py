"""K2's module (``openess_tpu_torch/ops/segment_pool.py``) against the JAX
package's ``ops/segment_pool.py`` on the CPU: the port runs its plain
version, JAX runs the Pallas kernel in interpret mode
(``segment_mean_pool_pallas``) and the XLA scatter (``segment_mean_pool``).

Tolerances: f32 means within 1e-5 of the largest mean against the Pallas
kernel at ``Precision.HIGHEST`` and against the scatter path (sum order
only); bf16 means within one bf16 ulp (2^-7 relative, 1e-6 near zero) of
the Pallas kernel's, whose default precision multiplies exact bf16 values
by exact ones and accumulates in f32, as the port does; counts exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openess_tpu.ops.segment_pool import (
    segment_mean_pool as jpool,
    segment_mean_pool_pallas as jpool_pallas,
)
from openess_tpu_torch.ops import segment_pool as k2
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

F32_REL = 1e-5
BF16_ULP = 2.0 ** -7


def _case(seed, b, h, w, d, s, *, empty=()):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(b, h, w, d)).astype(np.float32)
    choices = np.array([i for i in range(s) if i not in empty])
    seg = rng.choice(choices, size=(b, h, w)).astype(np.int32)
    return feats, seg


def _torch_pool(feats, seg, s, dtype=torch.float32):
    means, counts = k2.segment_mean_pool(
        torch.from_numpy(feats).to(dtype), torch.from_numpy(seg),
        segments_per_image=s,
    )
    return means, counts


# (b, h, w, d, segments): N = b*h*w both a multiple of the Pallas chunk and
# not; d below and above one lane tile
SHAPES = [(2, 16, 32, 8, 5), (3, 7, 11, 20, 4), (1, 33, 31, 130, 9)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_f32_matches_pallas_and_scatter(shape):
    b, h, w, d, s = shape
    feats, seg = _case(0, b, h, w, d, s, empty=(1,))
    means, counts = _torch_pool(feats, seg, s)
    assert means.shape == (b * s, d) and counts.shape == (b * s,)
    assert means.dtype == counts.dtype == torch.float32
    jm, jc = jpool_pallas(jnp.asarray(feats), jnp.asarray(seg),
                          segments_per_image=s,
                          precision=jax.lax.Precision.HIGHEST)
    xm, xc = jpool(jnp.asarray(feats), jnp.asarray(seg), segments_per_image=s)
    for ref_m, ref_c in ((jm, jc), (xm, xc)):
        ref_m, ref_c = np.asarray(ref_m), np.asarray(ref_c)
        np.testing.assert_array_equal(counts.numpy(), ref_c)
        assert np.abs(means.numpy() - ref_m).max() <= F32_REL * np.abs(
            ref_m).max()
    # the empty segment of every image is a zero row with a zero count
    assert (means.numpy()[1::s] == 0).all() and (counts.numpy()[1::s] == 0).all()


@pytest.mark.parametrize("shape", SHAPES[:2], ids=str)
def test_bf16_matches_pallas_within_one_ulp(shape):
    b, h, w, d, s = shape
    feats, seg = _case(1, b, h, w, d, s)
    means, counts = _torch_pool(feats, seg, s, torch.bfloat16)
    assert means.dtype == counts.dtype == torch.bfloat16
    jm, jc = jpool_pallas(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(seg),
                          segments_per_image=s)
    jm = np.asarray(jm.astype(jnp.float32))
    got = means.float().numpy()
    np.testing.assert_array_equal(counts.float().numpy(),
                                  np.asarray(jc.astype(jnp.float32)))
    mag = np.maximum(np.abs(got), np.abs(jm))
    assert (np.abs(got - jm) <= mag * BF16_ULP + 1e-6).all()


def test_bf16_counts_do_not_saturate():
    """The sums and counts accumulate in f32 whatever the feats dtype: a
    300-pixel segment counts 300 (a bf16 accumulator would stall at 256);
    the count is cast to bf16 only at the end."""
    feats = np.ones((1, 20, 30, 4), np.float32)
    seg = np.zeros((1, 20, 30), np.int32)
    seg[0, :10] = 1
    means, counts = _torch_pool(feats, seg, 2, torch.bfloat16)
    assert counts.float().tolist() == [300.0, 300.0]
    assert torch.allclose(means.float(), torch.ones(2, 4), atol=2 ** -8)
    # the JAX scatter path accumulates in the feats dtype and does stall,
    # which is why the port is held against it in f32 only
    _, jc = jpool(jnp.asarray(feats, jnp.bfloat16), jnp.asarray(seg),
                  segments_per_image=2)
    assert np.asarray(jc.astype(jnp.float32)).tolist() == [256.0, 256.0]


def test_ids_out_of_range_and_batch_offsets():
    """A per-image id >= segments_per_image spills into the next image's
    rows (no clamp, as in the JAX package); a global id outside
    [0, B*S) adds nothing; negative ids add nothing. Held to JAX's
    scatter path and its Pallas kernel (``segment_mean_pool`` hands the
    port's kernel the image structure, whose windows such ids leave)."""
    b, h, w, d, s = 2, 4, 6, 3, 4
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(b, h, w, d)).astype(np.float32)
    seg = rng.integers(0, s, (b, h, w)).astype(np.int32)
    seg[0, 0, 0] = s + 1        # image 0 -> global 5 = image 1's segment 1
    seg[1, 0, 0] = s            # image 1 -> global 8: outside, dropped
    seg[1, 0, 1] = -3           # global 1: image 0's segment 1 (as in JAX)
    seg[0, 0, 1] = -1           # global -1: outside, dropped
    means, counts = _torch_pool(feats, seg, s)
    gid = (seg.astype(np.int64) + np.arange(b)[:, None, None] * s).reshape(-1)
    flat = feats.reshape(-1, d)
    for g in range(b * s):
        rows = flat[gid == g]
        assert counts[g].item() == len(rows)
        want = rows.sum(0) / (len(rows) + 1e-6)
        np.testing.assert_allclose(means[g].numpy(), want, atol=1e-6)
    assert counts.sum().item() == b * h * w - 2
    xm, xc = jpool(jnp.asarray(feats), jnp.asarray(seg), segments_per_image=s)
    jm, jc = jpool_pallas(jnp.asarray(feats), jnp.asarray(seg),
                          segments_per_image=s,
                          precision=jax.lax.Precision.HIGHEST)
    for ref_m, ref_c in ((xm, xc), (jm, jc)):
        np.testing.assert_array_equal(counts.numpy(), np.asarray(ref_c))
        np.testing.assert_allclose(means.numpy(), np.asarray(ref_m),
                                   atol=1e-6)


def test_gradient_matches_jax_custom_vjp():
    b, h, w, d, s = 2, 8, 16, 6, 5
    feats, seg = _case(3, b, h, w, d, s, empty=(2,))
    wgt = np.random.default_rng(4).normal(size=(b * s, d)).astype(np.float32)

    def jloss(f):
        m, _ = jpool_pallas(f, jnp.asarray(seg), segments_per_image=s,
                            precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(m * wgt)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(feats)))
    tf = torch.from_numpy(feats).requires_grad_(True)
    m, _ = k2.segment_mean_pool(tf, torch.from_numpy(seg), segments_per_image=s)
    (m * torch.from_numpy(wgt)).sum().backward()
    assert np.abs(tf.grad.numpy() - jg).max() <= 1e-6 * max(
        1.0, np.abs(jg).max())


def test_autograd_function_backward_is_the_gather():
    """The CUDA path's backward (``_SegmentPoolSums.backward``), run here
    on CPU tensors: the cotangent is cast to the feats dtype before the
    gather and skipped pixels read a zero row."""
    ids = torch.tensor([0, 2, -1, 1, 3, 2], dtype=torch.int32)
    g = torch.arange(9, dtype=torch.float32).reshape(3, 3) + 0.3

    class Ctx:
        saved_tensors = (ids,)
        num_segments = 3
        feats_dtype = torch.bfloat16

    out, none_ids, none_s = k2._SegmentPoolSums.backward(Ctx, g, None)
    assert none_ids is None and none_s is None
    assert out.dtype == torch.bfloat16
    gb = g.to(torch.bfloat16)
    want = torch.stack([gb[0], gb[2], gb[0] * 0, gb[1], gb[0] * 0, gb[2]])
    assert torch.equal(out, want)


def test_gradcheck_plain_f64():
    rng = np.random.default_rng(5)
    feats = torch.from_numpy(rng.normal(size=(24, 3))).requires_grad_(True)
    ids = torch.from_numpy(rng.integers(-1, 5, 24).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda f: k2.segment_pool_sums_plain(f, ids, 4)[0], (feats,)
    )
    nhwc = torch.from_numpy(rng.normal(size=(2, 3, 4, 3))).requires_grad_(True)
    seg = torch.from_numpy(rng.integers(0, 3, (2, 3, 4)).astype(np.int32))
    assert torch.autograd.gradcheck(
        lambda f: k2.segment_mean_pool(f, seg, segments_per_image=3)[0],
        (nhwc,),
    )


def test_wrapper_checks_its_inputs():
    feats = torch.zeros(1, 4, 4, 8)
    seg = torch.zeros(1, 4, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        k2.segment_mean_pool(feats.permute(0, 2, 1, 3), seg.permute(0, 2, 1),
                             segments_per_image=2)
    with pytest.raises(ValueError, match="seg_ids"):
        k2.segment_mean_pool(feats, seg[:, :2], segments_per_image=2)
    with pytest.raises(ValueError, match="unsupported device"):
        k2.segment_pool_sums(torch.zeros(4, 2, device="meta"),
                             torch.zeros(4, dtype=torch.int32, device="meta"),
                             2)
    before = k2.segment_pool_sums.launches
    k2.segment_mean_pool(feats, seg, segments_per_image=2)
    assert k2.segment_pool_sums.launches == before  # CPU: no kernel launch
