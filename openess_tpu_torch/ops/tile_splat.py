"""The tile plan of the tile-owner splats that K1 and K4
(``ops/voxelize_chunked.py``) and K5 and K6 (``ops/voxelize_mxu.py``)
launch (``csrc/tile_splat.cuh``).

One CUDA block owns one output tile of one window's ``[channels, H, W]``
f32 grid: ``rows x cols`` pixels in every channel. It accumulates every
corner that falls in its tile in shared memory and then writes the whole
tile once, zeros included, so the grid needs no zero fill and no global
atomics. :func:`tile_plan` sizes the tile from the output channels (the
time bins for K1 and K5; ``bins`` or ``2 * bins`` with ``separate_pol``
for K4 and K6), ``H`` and ``W``; the wrappers pass its numbers to the
kernels, which take no geometry of their own.

K5's and K6's events arrive unsorted, so their passes first bin them by
tile. K5 (:func:`event_slots`): each event that has a corner in the frame
goes to its *home* tile, the tile of its smallest in-frame corner, under
one of four categories by the neighbours its corners reach. The splat of a
tile reads its own four categories and, from its left, upper and
upper-left neighbours, only the categories that spill into it
(``SPILL_*``). K6 (:func:`pixel_slots`): an event touches one pixel, so it
goes to that pixel's tile, one slot a tile (``categories=1``). Every kept
event is stored once, so the binned scratch is never larger than the
events themselves: window ``w``'s runs, one per slot in slot order, start
at ``w * K``.
"""
from __future__ import annotations

import dataclasses

import torch

TILE_ROWS = 16            # the sorted-chunk wire's row tile
TILE_COLS = 128           # and its column tile
PAD_COLS = 4              # row pitch cols + 4 floats: a column's rows fall
                          # in different shared-memory banks, rows stay
                          # 16-byte aligned
TILE_SMEM_BUDGET = 96 * 1024   # accumulator bytes: at least two blocks an SM
SMEM_LIMIT = 232_448      # shared memory a block can use on an H100
CATEGORIES = 4            # interior, down, both, right (this order)
CAT_INTERIOR, CAT_DOWN, CAT_BOTH, CAT_RIGHT = range(CATEGORIES)
# the categories a neighbour's splat reads, as [first, last) of the four:
# the left neighbour's right spills, the upper one's down spills, the
# upper-left one's spills both ways
SPILL_FROM_LEFT = (CAT_BOTH, CAT_RIGHT + 1)
SPILL_FROM_UP = (CAT_DOWN, CAT_BOTH + 1)
SPILL_FROM_UP_LEFT = (CAT_BOTH, CAT_BOTH + 1)


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Tile geometry and scratch sizes for one ``(channels, height,
    width)`` grid; ``categories`` slots a tile in the binning passes (4 for
    K5, 1 for K6)."""

    channels: int
    height: int
    width: int
    rows: int
    cols: int
    categories: int = CATEGORIES

    @property
    def pitch(self) -> int:
        return self.cols + PAD_COLS

    @property
    def tiles_y(self) -> int:
        return -(-self.height // self.rows)

    @property
    def tiles_x(self) -> int:
        return -(-self.width // self.cols)

    @property
    def tiles(self) -> int:
        """Tiles a window: the splat's CUDA grid is (tiles, windows)."""
        return self.tiles_y * self.tiles_x

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of a splat block: the f32 accumulator
        ``[channels, rows, pitch]``."""
        return self.channels * self.rows * self.pitch * 4

    def tile_box(self, tile: int) -> tuple[int, int, int, int]:
        """Frame rows ``[r0, r1)`` and columns ``[c0, c1)`` of ``tile``
        (row-major over ``tiles_y x tiles_x``), cut at the ragged edge."""
        ty, tx = divmod(tile, self.tiles_x)
        r0, c0 = ty * self.rows, tx * self.cols
        return (r0, min(r0 + self.rows, self.height),
                c0, min(c0 + self.cols, self.width))

    # K5's and K6's binning scratch
    @property
    def slots_per_window(self) -> int:
        return self.tiles * self.categories

    def slots(self, num_windows: int) -> int:
        """Length of the binning's counts: one per (window, tile,
        category)."""
        return num_windows * self.slots_per_window

    @property
    def count_smem_bytes(self) -> int:
        """Dynamic shared memory of the count pass (an int per slot of a
        window); the scatter pass adds an int64 base per slot."""
        return self.slots_per_window * 4

    @property
    def scatter_smem_bytes(self) -> int:
        return self.slots_per_window * (4 + 8)


def tile_plan(channels: int, height: int, width: int, *,
              categories: int = CATEGORIES) -> TilePlan:
    """The tile of the splat for a ``[channels, height, width]`` grid:
    ``TILE_ROWS x TILE_COLS`` (the chunk wire's tile) unless its
    accumulator passes ``TILE_SMEM_BUDGET``; then the columns halve down to
    32, then the rows. Both stay powers of two, which the binning passes
    take as shifts. ``categories`` is K5's 4 or K6's 1."""
    if min(channels, height, width) <= 0:
        raise ValueError(f"empty grid: channels {channels}, {height}x{width}")
    rows, cols = TILE_ROWS, TILE_COLS
    while channels * rows * (cols + PAD_COLS) * 4 > TILE_SMEM_BUDGET:
        if cols > 32:
            cols //= 2
        elif rows > 1:
            rows //= 2
        else:
            raise ValueError(
                f"{channels} channels do not fit a shared-memory tile")
    plan = TilePlan(channels, height, width, rows, cols, categories)
    if plan.scatter_smem_bytes > SMEM_LIMIT:
        raise ValueError(f"a {height}x{width} frame has {plan.tiles} tiles, "
                         "too many for the binning passes' shared memory")
    return plan


def event_slots(x: torch.Tensor, y: torch.Tensor, plan: TilePlan):
    """Each event's slot within its window, ``home_tile * CATEGORIES +
    category``, and whether it is kept: K5's binning rule, which the CUDA
    passes apply per event.

    An event is kept when a corner pair in x and one in y meet the frame:
    ``trunc(x)`` in ``[-1, W - 1]``, tested on the float as ``-2 < x < W``
    (the corners are truncated toward zero, so ``x`` in (-1, 0) has corners
    {0, 1} and ``x`` in (-2, -1] has {-1, 0}). Its home tile holds its
    smallest in-frame corner; it spills right when both x corners are in
    the frame and the second starts the next tile column, down likewise."""
    W, H = plan.width, plan.height
    keep = (x > -2) & (x < W) & (y > -2) & (y < H)
    x0 = torch.where(keep, x, 0.0).int()  # trunc toward zero
    y0 = torch.where(keep, y, 0.0).int()
    hx, hy = x0.clamp(min=0), y0.clamp(min=0)
    tile = (hy // plan.rows) * plan.tiles_x + hx // plan.cols
    right = (x0 >= 0) & (x0 + 1 < W) & ((x0 + 1) % plan.cols == 0)
    down = (y0 >= 0) & (y0 + 1 < H) & ((y0 + 1) % plan.rows == 0)
    cat = torch.where(
        right, torch.where(down, CAT_BOTH, CAT_RIGHT),
        torch.where(down, CAT_DOWN, CAT_INTERIOR))
    return tile * CATEGORIES + cat, keep


def pixel_slots(x: torch.Tensor, y: torch.Tensor, plan: TilePlan):
    """Each event's slot within its window, the tile of its pixel
    ``(trunc y, trunc x)``, and whether it is kept: K6's binning rule
    (``categories=1``), which the CUDA passes apply per event.

    An event is kept when its float coordinates lie in the frame,
    ``0 <= x < W`` and ``0 <= y < H``: the JAX wrapper's in-frame test, so
    ``x`` or ``y`` in (-1, 0) is dropped, where the exact scatter truncates
    first and keeps it at pixel 0."""
    keep = (x >= 0) & (x < plan.width) & (y >= 0) & (y < plan.height)
    xi = torch.where(keep, x, 0.0).int()  # trunc toward zero
    yi = torch.where(keep, y, 0.0).int()
    return (yi // plan.rows) * plan.tiles_x + xi // plan.cols, keep


def reader_tiles(slot: torch.Tensor, plan: TilePlan):
    """For events binned at ``slot`` (within their window), the tiles whose
    splat reads them: ``[(tile, mask)]`` for the home tile and its right,
    lower and lower-right neighbours, ``mask`` saying which events that
    neighbour reads (the categories ``SPILL_*`` name)."""
    tile, cat = slot // CATEGORIES, slot % CATEGORIES
    tx = plan.tiles_x

    def reads(span):
        return (cat >= span[0]) & (cat < span[1])

    return [(tile, torch.ones_like(cat, dtype=torch.bool)),
            (tile + 1, reads(SPILL_FROM_LEFT)),
            (tile + tx, reads(SPILL_FROM_UP)),
            (tile + tx + 1, reads(SPILL_FROM_UP_LEFT))]
