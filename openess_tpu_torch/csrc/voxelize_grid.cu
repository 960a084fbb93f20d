// K5 and K6: the grid wire's two voxelizers, splats of raw padded events
// into full per-window grids, for Hopper (sm_90a).
//
// K5 (DSEC): replaces openess_tpu/ops/voxelize_mxu.py:_kernel (reached
// through voxelize_windows_trilinear_mxu). It computes the same function:
// each window's valid times are normalized to tn = (bins - 1) * (t - t_first)
// / dt over the window's valid events (dt = t_last - t_first, 1 unless
// positive), and an event of value v = 2p - 1 at (x, y, tn) adds
// v * wx * wy * wt to the 8 corners {x0, x0+1} x {y0, y0+1} x {t0, t0+1},
// the corners truncated toward zero (a C (int) cast, torch .int()) and
// w = 1 - |corner - coord|. A fractional negative coordinate so keeps the
// reference's corner pair {0, 1} with a negative weight on corner 1. A
// corner outside [0, W) x [0, H) x [0, bins) is dropped, as the TPU
// kernel's iota columns drop it; padding adds nothing.
//
// K5 is three passes over raw x, y, p, t (f32) and valid (bool), flat over
// nw * k event slots, with scratch from the wrapper
// (openess_tpu_torch/ops/voxelize_mxu.py) and the tile plan of
// openess_tpu_torch/ops/tile_splat.py:
//   (a) bin_count: per window, the first and last valid time (atomic max of
//       order-preserving keys) and the events per slot, a slot being
//       (window, home tile, category), in a histogram privatized in shared
//       memory. Padding and events with no corner in the frame are dropped
//       here. An event's home tile holds its smallest in-frame corner; its
//       category says whether its corners also reach the next tile column
//       (right), the next tile row (down), both, or neither (interior).
//   (b) bin_scatter: each kept event's prepared (x, y, tn, v), 16 B, goes
//       to its slot's run. Window w's runs lie in slot order from w * k,
//       so no scan crosses windows: each block scans its window's counts
//       in shared memory, ranks its events per slot there and reserves
//       each slot's part with one global atomic.
//   (c) tri_tile_splat_binned: the tile-owner splat of csrc/tile_splat.cuh
//       over the tile's own four categories and, from its left, upper and
//       upper-left neighbours, the categories that spill into it.
// Both binning passes read their block's events before they use any, so a
// thread waits for memory once.
//
// The +1 corners: an event is stored once, in its home tile, and a
// neighbour reads only the spill categories. Emitting a copy into every
// tile an event touches costs the same reads and writes (~1.07 copies at
// 16 x 128 on uniform events), but a wrapper that must size the scratch
// before the counts exist would have to allow 4 copies an event (1 GB at
// 160 windows of 100k): stored once, the scratch is at most the events.
//
// What bounds K5 on an H100: at DSEC's batch (160 windows of 100k events,
// 5 x 480 x 640) it must read 17 B a raw event slot (272 MB) and write the
// 983 MB grid: 0.375 ms of HBM traffic. Binning adds a second read of the
// raw events (the scatter), 16 B written and read again a kept event
// (~510 MB), and ~1 MB of counts and offsets: about 0.23 ms more. Its
// first design, one thread an event with 8 f32 atomicAdds in device memory
// into a zero-filled grid, behind four elementwise preparation passes in
// the wrapper, took 8.5x the bound.
//
// K6 (DDD17): replaces openess_tpu/ops/voxelize_mxu.py:_kernel_bilinear_t
// (reached through voxelize_windows_bilinear_t_mxu). It computes the same
// function: per window, the valid times normalized to tn = (bins - 1) *
// (t - t_first) / dt over the window's valid events, in frame or not (dt
// replaced by 1 only where it is 0, DDD17's rule), polarity 0 counted as
// -1; an event whose float coordinates lie in the frame (0 <= x < W,
// 0 <= y < H, the JAX wrapper's in-frame test, so x or y in (-1, 0) is
// dropped) adds, at its integer pixel (trunc x, trunc y), 1 - dts to time
// bin ti = trunc(tn) and dts = tn - ti to bin ti + 1 where that bin exists,
// signed by its polarity into `bins` channels, or unsigned into the
// positive (pol > 0) or negative block of 2 * bins channels with
// separate_pol. This is K4's splat (csrc/voxelize_chunked.cu) on raw events
// in place of the sorted-chunk wire, and its passes are K5's:
//   (a) bin_count<PixelRule>: each window's first and last valid time and
//       the events per (window, tile): an event goes to the tile of its
//       pixel, one slot a tile (ops/tile_splat.pixel_slots);
//   (b) bin_scatter<PixelRule>: each kept event's (x, y, tn, pol), 16 B,
//       to its tile's run;
//   (c) bil_tile_splat_binned: the tile-owner splat over the tile's own
//       run (an event touches one pixel, so nothing spills).
// The record is K5's float4, so one reader and one splat serve K4 and K6;
// a packed 8 B record (offset in the tile, bin, sign, dts) would save
// 82 MB of scratch traffic at DDD17's batch, ~0.025 ms.
//
// What bounds K6 on an H100: at DDD17's batch (160 x 32k events,
// 5 x 260 x 346) it must read 17 B a raw event slot (87 MB) and write the
// 288 MB grid (576 MB with separate_pol): 0.112 ms (0.198). Binning adds a
// second read of the raw events and 16 B written and read again a kept
// event: ~0.07 ms more. Its first design, one thread an event slot with
// two f32 atomicAdds into a zero-filled grid behind some 20 elementwise
// preparation passes in its wrapper, took 7-11x the bound.
//
// Both compute in f32, in the plain versions' product order; the TPU
// kernels' one-hot matrices multiplied in bf16 on the matrix unit are not
// reproduced. Offsets into the grid are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_splat.cuh"

namespace {

using tile_splat::kThreads;
using tile_splat::kWarps;
constexpr int kPerThread = 8;                  // events a thread, (a), (b)
constexpr int kSlice = kThreads * kPerThread;  // events a block
constexpr int kCategories = 4;                 // interior, down, both, right
constexpr int kRankBits = 11;                  // kSlice = 1 << kRankBits

// The frame and the tiles, for a binning rule. rows and cols are powers of
// two (the plan halves them), given as shifts.
struct TileGrid {
  int height, width, row_shift, col_shift, tiles_x;
};

// K5's binning rule. slot(): an event's slot within its window (home tile
// * 4 + category), or -1 when none of its corners is in the frame
// (ops/tile_splat.event_slots). value(): v = 2p - 1. A window's dt is
// replaced by 1 unless positive.
struct TrilinearRule {
  static constexpr bool kPositiveDt = true;
  TileGrid g;

  __device__ __forceinline__ int slot(float x, float y) const {
    if (!(x > -2.0f && x < (float)g.width && y > -2.0f &&
          y < (float)g.height))
      return -1;
    const int x0 = (int)x, y0 = (int)y;
    const int tile = (max(y0, 0) >> g.row_shift) * g.tiles_x +
                     (max(x0, 0) >> g.col_shift);
    const bool right = x0 >= 0 && x0 + 1 < g.width &&
                       ((x0 + 1) & ((1 << g.col_shift) - 1)) == 0;
    const bool down = y0 >= 0 && y0 + 1 < g.height &&
                      ((y0 + 1) & ((1 << g.row_shift) - 1)) == 0;
    const int cat = right ? (down ? 2 : 3) : (down ? 1 : 0);
    return tile * kCategories + cat;
  }
  __device__ __forceinline__ float value(float p) const {
    return 2.0f * p - 1.0f;
  }
};

// K6's: the tile of the pixel (trunc y, trunc x), one slot a tile, or -1
// unless 0 <= x < W and 0 <= y < H on the float coordinates
// (ops/tile_splat.pixel_slots); the polarity, 0 counted as -1; dt replaced
// by 1 only where it is 0.
struct PixelRule {
  static constexpr bool kPositiveDt = false;
  TileGrid g;

  __device__ __forceinline__ int slot(float x, float y) const {
    if (!(x >= 0.0f && x < (float)g.width && y >= 0.0f &&
          y < (float)g.height))
      return -1;
    return ((int)y >> g.row_shift) * g.tiles_x + ((int)x >> g.col_shift);
  }
  __device__ __forceinline__ float value(float p) const {
    return p == 0.0f ? -1.0f : p;
  }
};

// Order-preserving unsigned keys of f32, so atomicMax finds a maximum and,
// on the complemented key, a minimum; 0 stands below every key.
__device__ __forceinline__ unsigned int float_key(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned int k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// A block's kPerThread event slots of window w, read at once (one round
// trip to memory), the slots past k and the padding marked invalid.
struct RawEvents {
  float x[kPerThread], y[kPerThread], t[kPerThread], p[kPerThread];
  bool ok[kPerThread];

  __device__ __forceinline__ void load(const float* __restrict__ xs,
                                       const float* __restrict__ ys,
                                       const float* __restrict__ ts,
                                       const float* __restrict__ ps,
                                       const uint8_t* __restrict__ valid,
                                       long long base, int k) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int e = blockIdx.x * kSlice + j * kThreads + threadIdx.x;
      const bool in = e < k;
      const long long s = base + (in ? e : 0);
      ok[j] = in && valid[s];
      x[j] = xs[s];
      y[j] = ys[s];
      t[j] = ts[s];
      p[j] = ps ? ps[s] : 0.0f;
    }
  }
};

// (a) Grid (ceil(k / kSlice), nw). tkeys[2w] gets the key of window w's
// last valid time, tkeys[2w + 1] the complemented key of its first; both
// and the counts start at 0.
template <class Rule>
__global__ void __launch_bounds__(kThreads)
bin_count(const float* __restrict__ xs, const float* __restrict__ ys,
          const float* __restrict__ ts, const uint8_t* __restrict__ valid,
          int* __restrict__ counts, unsigned int* __restrict__ tkeys, int k,
          int slots, Rule rule) {
  extern __shared__ int hist[];  // slots
  __shared__ float wmin[kWarps], wmax[kWarps];
  const int w = blockIdx.y;
  RawEvents ev;
  ev.load(xs, ys, ts, nullptr, valid, (long long)w * k, k);
  for (int i = threadIdx.x; i < slots; i += kThreads) hist[i] = 0;
  __syncthreads();
  float tmin = __int_as_float(0x7f800000), tmax = -tmin;  // +inf, -inf
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    if (!ev.ok[j]) continue;
    tmin = fminf(tmin, ev.t[j]);
    tmax = fmaxf(tmax, ev.t[j]);
    const int slot = rule.slot(ev.x[j], ev.y[j]);
    if (slot >= 0) atomicAdd(&hist[slot], 1);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    tmin = fminf(tmin, __shfl_xor_sync(0xffffffffu, tmin, o));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, o));
  }
  if ((threadIdx.x & 31) == 0) {
    wmin[threadIdx.x >> 5] = tmin;
    wmax[threadIdx.x >> 5] = tmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 1; i < kWarps; ++i) {
      tmin = fminf(tmin, wmin[i]);
      tmax = fmaxf(tmax, wmax[i]);
    }
    if (tmin <= tmax) {  // the block saw a valid event
      atomicMax(&tkeys[2 * w], float_key(tmax));
      atomicMax(&tkeys[2 * w + 1], ~float_key(tmin));
    }
  }
  int* wcounts = counts + (long long)w * slots;
  for (int i = threadIdx.x; i < slots; i += kThreads)
    if (hist[i]) atomicAdd(&wcounts[i], hist[i]);
}

// out[i] = base + sum of in[:i] for i < n, over the whole block; each
// thread sums a contiguous run of ceil(n / kThreads). Ends synchronized.
__device__ __forceinline__ void block_exclusive_scan(
    const int* __restrict__ in, long long* out, int n, long long base,
    long long* warp_sums) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  long long own = 0;
  for (int i = lo; i < hi; ++i) own += in[i];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = own;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  long long run = base + incl - own;
  for (int i = 0; i < warp; ++i) run += warp_sums[i];
  for (int i = lo; i < hi; ++i) {
    out[i] = run;
    run += in[i];
  }
  __syncthreads();
}

// (b) Grid (ceil(k / kSlice), nw): each kept event's (x, y, tn, value) to
// its slot's run. A window's runs are laid out in slot order from w * k (a
// window keeps at most its k events), so every block of the window
// computes the window's offsets from the counts itself and the first one
// writes them out. A block ranks its events per slot in shared memory and
// reserves each slot's part of the run with one atomic on the cursor
// (zero on entry).
template <class Rule>
__global__ void __launch_bounds__(kThreads)
bin_scatter(const float* __restrict__ xs, const float* __restrict__ ys,
            const float* __restrict__ ps, const float* __restrict__ ts,
            const uint8_t* __restrict__ valid,
            const unsigned int* __restrict__ tkeys,
            const int* __restrict__ counts, long long* __restrict__ offsets,
            int* __restrict__ cursor, float4* __restrict__ binned, int k,
            int slots, int bins, Rule rule) {
  extern __shared__ long long run[];  // slots int64, then slots int
  int* hist = reinterpret_cast<int*>(run + slots);
  __shared__ long long warp_sums[kWarps];
  const int w = blockIdx.y;
  const long long wslot = (long long)w * slots;
  RawEvents ev;
  ev.load(xs, ys, ts, ps, valid, (long long)w * k, k);
  for (int i = threadIdx.x; i < slots; i += kThreads) hist[i] = 0;
  block_exclusive_scan(counts + wslot, run, slots, (long long)w * k,
                       warp_sums);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < slots; i += kThreads)
      offsets[wslot + i] = run[i];
  const float t_last = key_float(tkeys[2 * w]);
  const float t_first = key_float(~tkeys[2 * w + 1]);
  float dt = t_last - t_first;
  if (Rule::kPositiveDt ? !(dt > 0.0f) : dt == 0.0f) dt = 1.0f;
  const float tb = (float)(bins - 1);
  int packed[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const int slot = ev.ok[j] ? rule.slot(ev.x[j], ev.y[j]) : -1;
    packed[j] =
        slot < 0 ? -1 : (slot << kRankBits) | atomicAdd(&hist[slot], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < slots; i += kThreads)
    if (hist[i]) run[i] += atomicAdd(&cursor[wslot + i], hist[i]);
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kPerThread; ++j)
    if (packed[j] >= 0)
      binned[run[packed[j] >> kRankBits] +
             (packed[j] & ((1 << kRankBits) - 1))] =
          make_float4(ev.x[j], ev.y[j], tb * (ev.t[j] - t_first) / dt,
                      rule.value(ev.p[j]));
}

// Reads slot s of the binned events.
struct BinnedReader {
  const float4* __restrict__ ev;

  __device__ __forceinline__ void load(long long s, float& x, float& y,
                                       float& tn, float& v) const {
    const float4 e = ev[s];
    x = e.x;
    y = e.y;
    tn = e.z;
    v = e.w;
  }
};

// (c) Grid (tiles, nw): the tile-owner splat over the tile's own slots and
// its neighbours' spills.
template <int kVec>
__global__ void __launch_bounds__(kThreads, tile_splat::kBinnedSplatBlocks)
tri_tile_splat_binned(const float4* __restrict__ binned,
                      const long long* __restrict__ offsets,
                      const int* __restrict__ counts,
                      float* __restrict__ out, int bins, int height,
                      int width, int rows, int cols, int pitch, int tiles_x) {
  extern __shared__ float4 dyn_smem[];
  float* acc = reinterpret_cast<float*>(dyn_smem);
  __shared__ tile_splat::Segs<4> segs;
  const int w = blockIdx.y, tile_id = blockIdx.x;
  const int tiles = gridDim.x;
  const tile_splat::Tile tile =
      tile_splat::tile_of(tile_id, rows, cols, tiles_x, height, width);
  tile_splat::zero_tile(acc, bins * rows * pitch);
  // threads 0-3 look up one source tile's run each, [first, last]
  // category (tile_splat.SPILL_*): the own tile, left, upper, upper-left
  __shared__ long long run_lo[4], run_hi[4];
  if (threadIdx.x < 4) {
    const int i = threadIdx.x;
    const bool left = tile_id % tiles_x > 0, up = tile_id >= tiles_x;
    const bool has = i == 0 || (i == 1 && left) || (i == 2 && up) ||
                     (i == 3 && left && up);
    const int src = tile_id - (i & 1) - (i >> 1) * tiles_x;
    const int first = i == 0 ? 0 : i == 2 ? 1 : 2;
    const int last = i < 2 ? 3 : 2;
    const long long a = ((long long)w * tiles + src) * kCategories;
    run_lo[i] = has ? offsets[a + first] : 0;
    run_hi[i] = has ? offsets[a + last] + counts[a + last] : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const int4 box = make_int4(tile.c0, tile.c1, tile.r0, tile.r1);
    int n = 0, len = 0;
    for (int i = 0; i < 4; ++i) {
      if (run_hi[i] <= run_lo[i]) continue;
      segs.base[n] = run_lo[i];
      segs.start[n] = len;
      segs.box[n] = box;
      len += (int)(run_hi[i] - run_lo[i]);
      ++n;
    }
    segs.n = n;
    segs.start[n] = len;
  }
  __syncthreads();
  tile_splat::accumulate(acc, segs, BinnedReader{binned},
                         tile_splat::Trilinear{bins}, tile, rows, pitch);
  tile_splat::store_tile<kVec>(acc,
                               out + (long long)w * bins * height * width,
                               tile, bins, rows, pitch, height, width);
}

// K6's (c) Grid (tiles, nw): the tile-owner splat over the tile's own run
// (slot w * tiles + tile), two time corners an event.
template <int kVec>
__global__ void __launch_bounds__(kThreads, tile_splat::kBinnedSplatBlocks)
bil_tile_splat_binned(const float4* __restrict__ binned,
                      const long long* __restrict__ offsets,
                      const int* __restrict__ counts,
                      float* __restrict__ out, int bins, int separate_pol,
                      int height, int width, int rows, int cols, int pitch,
                      int tiles_x) {
  extern __shared__ float4 dyn_smem[];
  float* acc = reinterpret_cast<float*>(dyn_smem);
  __shared__ tile_splat::Segs<1> segs;
  const int w = blockIdx.y;
  const int channels = separate_pol ? 2 * bins : bins;
  const tile_splat::Tile tile =
      tile_splat::tile_of(blockIdx.x, rows, cols, tiles_x, height, width);
  tile_splat::zero_tile(acc, channels * rows * pitch);
  if (threadIdx.x == 0) {
    const long long slot = (long long)w * gridDim.x + blockIdx.x;
    segs.base[0] = offsets[slot];
    segs.start[0] = 0;
    segs.start[1] = counts[slot];
    segs.box[0] = make_int4(tile.c0, tile.c1, tile.r0, tile.r1);
    segs.n = 1;
  }
  __syncthreads();
  tile_splat::accumulate(acc, segs, BinnedReader{binned},
                         tile_splat::BilinearT{bins, separate_pol != 0},
                         tile, rows, pitch);
  tile_splat::store_tile<kVec>(
      acc, out + (long long)w * channels * height * width, tile, channels,
      rows, pitch, height, width);
}

// The binning passes (a) and (b) under `Rule`: x, y, p, t f32 and valid
// bool, nw * k slots each; counts and cursor (slots_w * nw int32 each) and
// tkeys (2 * nw uint32) zero on entry; offsets slots_w * nw int64; binned
// room for nw * k float4. rows and cols are powers of two.
template <class Rule>
int bin_events(const void* x, const void* y, const void* p, const void* t,
               const void* valid, void* counts, void* cursor, void* tkeys,
               void* offsets, void* binned, int nw, int k, int bins,
               int height, int width, int rows, int cols, int tiles_x,
               int slots_w, int count_smem, int scatter_smem,
               void* stream) {
  if (nw <= 0 || k <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((k + kSlice - 1) / kSlice, nw);
  const Rule rule{TileGrid{height, width, __builtin_ctz(rows),
                           __builtin_ctz(cols), tiles_x}};
  cudaError_t err = tile_splat::allow_smem(bin_count<Rule>, count_smem);
  if (err == cudaSuccess)
    err = tile_splat::allow_smem(bin_scatter<Rule>, scatter_smem);
  if (err != cudaSuccess) return (int)err;
  bin_count<Rule><<<grid, kThreads, count_smem, st>>>(
      (const float*)x, (const float*)y, (const float*)t,
      (const uint8_t*)valid, (int*)counts, (unsigned int*)tkeys, k, slots_w,
      rule);
  bin_scatter<Rule><<<grid, kThreads, scatter_smem, st>>>(
      (const float*)x, (const float*)y, (const float*)p, (const float*)t,
      (const uint8_t*)valid, (const unsigned int*)tkeys, (const int*)counts,
      (long long*)offsets, (int*)cursor, (float4*)binned, k, slots_w, bins,
      rule);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers; each entry
// launches on `stream` and returns the CUDA error (0 on success). The
// geometry (rows, cols, pitch, tiles, tiles_x) and the shared-memory bytes
// are the tile plan's (openess_tpu_torch/ops/tile_splat.py).
//
// K5's and K6's passes (a) and (b), as bin_events above; K5's slots are
// (window, tile, category), K6's (window, tile).
extern "C" int bin_events_trilinear(
    const void* x, const void* y, const void* p, const void* t,
    const void* valid, void* counts, void* cursor, void* tkeys,
    void* offsets, void* binned, int nw, int k, int bins, int height,
    int width, int rows, int cols, int tiles_x, int slots_w, int count_smem,
    int scatter_smem, void* stream) {
  return bin_events<TrilinearRule>(
      x, y, p, t, valid, counts, cursor, tkeys, offsets, binned, nw, k,
      bins, height, width, rows, cols, tiles_x, slots_w, count_smem,
      scatter_smem, stream);
}

extern "C" int bin_events_bilinear_t(
    const void* x, const void* y, const void* p, const void* t,
    const void* valid, void* counts, void* cursor, void* tkeys,
    void* offsets, void* binned, int nw, int k, int bins, int height,
    int width, int rows, int cols, int tiles_x, int slots_w, int count_smem,
    int scatter_smem, void* stream) {
  return bin_events<PixelRule>(
      x, y, p, t, valid, counts, cursor, tkeys, offsets, binned, nw, k,
      bins, height, width, rows, cols, tiles_x, slots_w, count_smem,
      scatter_smem, stream);
}

// K5's pass (c): out holds nw * bins * height * width floats, each written
// once (no fill needed).
extern "C" int splat_binned_trilinear(
    const void* binned, const void* offsets, const void* counts, void* out,
    int nw, int bins, int height, int width, int rows, int cols, int pitch,
    int tiles, int tiles_x, int smem, void* stream) {
  if (nw <= 0) return 0;
  return (int)tile_splat::with_store_vec(width, [&](auto vec) {
    auto kernel = tri_tile_splat_binned<decltype(vec)::value>;
    cudaError_t err = tile_splat::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(tiles, nw), kThreads, smem, (cudaStream_t)stream>>>(
        (const float4*)binned, (const long long*)offsets,
        (const int*)counts, (float*)out, bins, height, width, rows, cols,
        pitch, tiles_x);
    return cudaGetLastError();
  });
}

// K6's pass (c): out holds nw * channels * height * width floats
// (channels = bins, or 2 * bins with separate_pol), each written once.
extern "C" int splat_binned_bilinear_t(
    const void* binned, const void* offsets, const void* counts, void* out,
    int nw, int bins, int separate_pol, int height, int width, int rows,
    int cols, int pitch, int tiles, int tiles_x, int smem, void* stream) {
  if (nw <= 0) return 0;
  return (int)tile_splat::with_store_vec(width, [&](auto vec) {
    auto kernel = bil_tile_splat_binned<decltype(vec)::value>;
    cudaError_t err = tile_splat::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(tiles, nw), kThreads, smem, (cudaStream_t)stream>>>(
        (const float4*)binned, (const long long*)offsets,
        (const int*)counts, (float*)out, bins, separate_pol, height, width,
        rows, cols, pitch, tiles_x);
    return cudaGetLastError();
  });
}
