"""K2's plan (``openess_tpu_torch/ops/segment_pool.pool_plan``) on the CPU:
the blocks it gives the kernel cover every row once, each inside one image,
with a table window inside that image's ids and shared memory inside a
block's limit; a model of the kernel's decomposition (each range summed
into its window's table and flushed once, every other valid id added to
the sums directly) equals the plain version; and the plan reaches the
kernel whole: ``ops/segment_pool._Plan`` lays out the fields of the
source's ``struct Plan`` in its order and types, each a number of
:class:`PoolPlan`. (``tests/test_torch_segment_pool.py`` holds
``segment_mean_pool``, which hands the kernel the image structure, to
JAX's Pallas kernel in interpret mode.)

Tolerances: the model's f32 sums within 1e-5 of the largest sum of the
plain version (another summation order), counts exact.
"""
import ctypes
import os
import re

import numpy as np
import pytest
import torch

from openess_tpu_torch.ops import segment_pool as k2
from test_torch_native import cores_share  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("cores_share")

F32_REL = 1e-5

# (name, rows, channels, segments, elem_size, image structure or None,
# aligned)
PLANS = [
    ("flagship bf16", 8 * 440 * 640, 256, 800, 2, (440 * 640, 100), True),
    ("flagship f32", 8 * 440 * 640, 256, 800, 4, (440 * 640, 100), True),
    ("flagship flat", 8 * 440 * 640, 256, 800, 2, None, True),
    ("band bf16", 2 * 220 * 640, 256, 200, 2, (220 * 640, 100), True),
    ("band flat", 2 * 220 * 640, 256, 200, 4, None, True),
    ("ddd17 spi 25", 8 * 200 * 352, 256, 200, 2, (200 * 352, 25), True),
    ("odd N", 3 * 9 * 13, 20, 15, 4, (9 * 13, 5), True),
    ("odd D", 2 * 31 * 17, 7, 6, 2, (31 * 17, 3), True),
    ("D past a tile", 31 * 17, 300, 3, 4, (31 * 17, 3), True),
    ("unaligned", 2 * 500, 64, 8, 2, (500, 4), False),
    ("spi past the width", 2 * 4000, 256, 800, 2, (4000, 400), True),
    ("spi past a narrow tile", 2 * 4000, 256, 4000, 2, (4000, 2000), True),
    ("flat, many ids", 10_000, 64, 100_000, 4, None, True),
]


def _plan(rows, channels, segments, elem, image, aligned):
    rpi, spi = image if image else (None, None)
    return k2.pool_plan(rows, channels, segments, elem_size=elem,
                        aligned=aligned, rows_per_image=rpi,
                        segments_per_image=spi)


@pytest.mark.parametrize("case", PLANS, ids=[c[0] for c in PLANS])
def test_plan_covers_each_row_once_inside_its_image(case):
    _, rows, channels, segments, elem, image, aligned = case
    p = _plan(rows, channels, segments, elem, image, aligned)
    rpi, spi = image if image else (rows, segments)
    assert (p.rows_per_image, p.segments_per_image) == (rpi, spi)
    spans = [p.block_rows(b) for b in range(p.blocks)]
    assert sorted(spans) == spans
    covered = np.zeros(rows, np.int32)
    for b, (lo, hi) in enumerate(spans):
        img = b // p.parts
        assert img * rpi <= lo <= hi <= (img + 1) * rpi  # one image
        covered[lo:hi] += 1
        wlo, whi = p.block_window(b)
        assert wlo == img * spi and wlo <= whi <= min(wlo + spi, segments)
        assert whi - wlo <= p.window
    assert (covered == 1).all()
    # the table and the tiles
    assert p.smem_bytes <= k2.SMEM_BUDGET <= k2.SMEM_LIMIT
    assert p.window >= 1 and p.tile % p.vec == 0
    assert p.tiles * p.tile >= channels > (p.tiles - 1) * p.tile
    assert p.lanes & (p.lanes - 1) == 0 and p.lanes <= 32
    assert p.lanes * k2.LANE_FLOATS >= p.tile
    assert p.vec == (16 // elem if aligned and channels % (16 // elem) == 0
                     else 1)
    # one wave of two blocks an SM where the images allow it
    if rpi >= 2 * k2.MIN_PART_ROWS * p.parts:
        assert p.blocks * p.tiles >= k2.BLOCKS_PER_SM * k2.H100_SMS


def test_plan_numbers_of_the_main_paths():
    """The flagship table: 100 segments x 256 channels in f32 (100 KB),
    two blocks an SM, 33 ranges an image; a band: 132 ranges an image;
    DDD17: 25 segments; 400 segments an image narrow the tile to 64
    channels, and 2 000 cap the window under a 32-channel tile."""
    f = _plan(*PLANS[0][1:])
    assert (f.vec, f.tile, f.window, f.lanes, f.parts) == (8, 256, 100, 32,
                                                           33)
    assert f.smem_bytes == 100 * 257 * 4 and f.blocks == 264
    assert _plan(*PLANS[3][1:]).parts == 132
    assert _plan(*PLANS[5][1:]).window == 25
    wide = _plan(*PLANS[10][1:])
    assert (wide.tile, wide.tiles, wide.window) == (64, 4, 400)
    capped = _plan(*PLANS[11][1:])
    assert capped.tile == 32 and capped.window < 2000


def emulate(plan, feats, ids):
    """The kernel's decomposition on the CPU: for each block and channel
    tile, the valid ids of its rows inside its window summed into a table
    (and counted), the others added to the sums directly; then the table's
    touched rows flushed. The counts come from the first channel tile, as
    in the kernel. Returns ``(sums, counts, rows out of their window)``."""
    n, d = feats.shape
    s = plan.segments
    sums = torch.zeros((s, d))
    counts = torch.zeros((s,))
    outside = 0
    for b in range(plan.blocks):
        lo, hi = plan.block_rows(b)
        wlo, whi = plan.block_window(b)
        rid = ids[lo:hi].long()
        valid = (rid >= 0) & (rid < s)
        inside = valid & (rid >= wlo) & (rid < whi)
        out = valid & ~inside
        for t in range(plan.tiles):
            c0, c1 = t * plan.tile, min((t + 1) * plan.tile, d)
            f = feats[lo:hi, c0:c1].float()
            table = torch.zeros((whi - wlo, c1 - c0)).index_add_(
                0, rid[inside] - wlo, f[inside])
            taken = torch.zeros((whi - wlo,)).index_add_(
                0, rid[inside] - wlo, torch.ones(int(inside.sum())))
            sums[:, c0:c1].index_add_(0, rid[out], f[out])
            touched = taken > 0
            sums[wlo:whi, c0:c1][touched] += table[touched]
            if t == 0:
                counts.index_add_(0, rid[out], torch.ones(int(out.sum())))
                counts[wlo:whi] += taken
        outside += int(out.sum())
    return sums, counts, outside


EMULATED = [
    # (name, images, rows an image, D, segments an image, dtype)
    ("images", 3, 117, 20, 7, torch.float32),
    ("odd D bf16", 2, 527, 7, 5, torch.bfloat16),
    ("ranges an image", 2, 5000, 8, 9, torch.float32),
    ("capped window", 2, 300, 40, 2000, torch.bfloat16),
]


@pytest.mark.parametrize("case", EMULATED, ids=[c[0] for c in EMULATED])
def test_emulated_decomposition_equals_plain(case):
    """Ids inside each window, a per-image id past ``segments_per_image``
    (the next image's window), ids outside the range, and the flat call
    (one image of every id) on the same rows."""
    _, b, rpi, d, spi, dtype = case
    rng = np.random.default_rng(17)
    feats = torch.from_numpy(rng.normal(size=(b * rpi, d))).to(dtype)
    seg = rng.integers(0, spi, (b, rpi))
    seg[0, :5] = (spi, spi + 1, -1, 10 ** 6, spi - 1)
    ids, total = k2.global_segment_ids(torch.from_numpy(seg), spi)
    want_s, want_c = k2.segment_pool_sums_plain(feats, ids, total)
    elem = feats.element_size()
    for image in ((rpi, spi), None):
        plan = _plan(b * rpi, d, total, elem, image, True)
        if image:
            assert plan.parts > 1 or case[0] != "ranges an image"
        got_s, got_c, outside = emulate(plan, feats, ids)
        assert torch.equal(got_c, want_c)
        assert (got_s - want_s).abs().max() <= F32_REL * want_s.abs().max()
        # image 0's ids past its window went to the sums directly
        assert outside >= (2 if image else 0)
    if case[0] == "capped window":
        assert plan.window < total and outside > 0


def test_wrapper_takes_the_image_structure_whole():
    feats = torch.zeros(12, 4)
    ids = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError, match="together"):
        k2.segment_pool_sums(feats, ids, 2, rows_per_image=6)
    with pytest.raises(ValueError, match="whole images"):
        k2.segment_pool_sums(feats, ids, 2, rows_per_image=5,
                             segments_per_image=1)
    with pytest.raises(ValueError, match="together"):
        k2.pool_plan(12, 4, 2, elem_size=4, segments_per_image=1)
    sums, counts = k2.segment_pool_sums(feats, ids, 2, rows_per_image=6,
                                        segments_per_image=1)
    assert counts.tolist() == [12.0, 0.0]
    # the plain version takes the same keywords (a step swaps it in)
    plain = k2.segment_pool_sums_plain(feats, ids, 2, rows_per_image=6,
                                       segments_per_image=1)
    assert all(torch.equal(a, b) for a, b in zip(plain, (sums, counts)))


def test_plan_struct_matches_the_kernel_source():
    src = os.path.join(os.path.dirname(k2.__file__), "..", "csrc",
                       "segment_pool.cu")
    with open(src) as f:
        text = f.read()
    body = re.search(r"struct Plan \{(.*?)\};", text, re.S).group(1)
    fields = re.findall(r"^\s*(long long|int) (\w+);", body, re.M)
    ctype = {"long long": ctypes.c_longlong, "int": ctypes.c_int}
    assert [(n, ctype[t]) for t, n in fields] == k2._Plan._fields_
    plan = _plan(*PLANS[0][1:])
    c = k2._Plan(**{n: getattr(plan, n) for _, n in fields[:-1]},
                 is_bf16=1)
    assert (c.chunk, c.pitch, c.smem_bytes) == (plan.chunk, plan.pitch,
                                                plan.smem_bytes)
