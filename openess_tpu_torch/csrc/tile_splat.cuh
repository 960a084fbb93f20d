// The tile-owner splat shared by K1 and K4 (csrc/voxelize_chunked.cu) and
// K5 and K6 (csrc/voxelize_grid.cu), for Hopper (sm_90a).
//
// One block owns one output tile of one window's [channels, H, W] f32
// grid: frame rows [r0, r1) and columns [c0, c1), every channel. It zeroes
// a [channels, rows, pitch] f32 accumulator in dynamic shared memory, adds
// every corner of its events that falls in its tile with shared-memory
// atomics, and then writes the whole tile once with streaming stores,
// zeros included. The grid is then written exactly once and needs neither
// a zero fill nor global atomics: what a splat must move, the events read
// and the grid written, is all the device memory it touches. The tile's
// geometry comes from the wrappers' plan
// (openess_tpu_torch/ops/tile_splat.py); the pitch is cols + 4 floats, so
// the rows of one column fall in different banks while each row stays
// 16-byte aligned.
//
// Where a tile's time goes on an H100 (tools/tile_splat_sweep.py, which
// also times ablated builds of this core): writing the tiles alone runs at
// the rate of a plain zero fill of the grid; adding the events' corners,
// with f32 shared-memory atomics (compare-and-swap loops on sm_90), and
// reading the events each cost more again, and a block's phases (zero,
// add, write) hardly overlap those of the blocks beside it. A persistent
// variant with two accumulators, whose rows left as bulk asynchronous
// copies while the next tile filled, ran slower and was not kept.
//
// The events come as segments: runs of consecutive event slots, each with
// the box of frame columns [x lo, x hi) and rows [y lo, y hi) its corners
// are kept in (the tile, cut for K1 and K4 by the chunk's block).
// accumulate() is templated on how an event slot is read (K1 and K4
// dequantize the sorted-chunk wire, K5 and K6 load their binned float4)
// and on what an event adds: Trilinear's 8 corners (K1, K5) or
// BilinearT's 2 (K4, K6).
//
// Trilinear's corner rule is the plain versions': corners {x0, x0+1} x
// {y0, y0+1} x {t0, t0+1} with the coordinates truncated toward zero (a C
// (int) cast, torch .int()), weights w = 1 - |corner - coord| multiplied as
// ((v * wx) * wy) * wt in f32, corners outside [0, bins) in time dropped.
// BilinearT's is splat2_bilinear_t's, below.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tile_splat {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks an SM that a splat's shared memory allows at the default tile,
// stated in the kernels' launch bounds: a 42 KB accumulator beside K1's
// and K4's 7 KB of segments fits 4 times in an SM's 228 KB, beside the
// binned splats' few bytes 5 times. Without them ptxas aims at the
// registers of 6 to 8 blocks (32 or 40) and spills; with them the splats
// also run faster.
constexpr int kChunkSplatBlocks = 4;
constexpr int kBinnedSplatBlocks = 5;

// The block's tile: frame rows [r0, r1), columns [c0, c1).
struct Tile {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ Tile tile_of(int tile, int rows, int cols,
                                        int tiles_x, int height, int width) {
  const int r0 = (tile / tiles_x) * rows, c0 = (tile % tiles_x) * cols;
  return Tile{r0, min(r0 + rows, height), c0, min(c0 + cols, width)};
}

// Up to kCap segments in shared memory: slots [base[i], base[i] + len) of
// the event source, where start[i] is the exclusive prefix of the lengths
// and start[n] their total; box[i] = (x lo, x hi, y lo, y hi).
template <int kCap>
struct Segs {
  long long base[kCap];
  int start[kCap + 1];
  int4 box[kCap];
  int n;
};

// K1's segments: one offer per thread. warp_* is gather_segs' scratch.
struct ChunkSegs : Segs<kThreads> {
  int warp_segs[kWarps];
  int warp_len[kWarps];
};

__device__ __forceinline__ void zero_tile(float* acc, int floats) {
  float4* a = reinterpret_cast<float4*>(acc);
  for (int i = threadIdx.x; i < floats / 4; i += kThreads)
    a[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Every thread offers at most one segment (keep implies len > 0); the kept
// ones are packed into segs in thread order. Ends with __syncthreads().
__device__ __forceinline__ void gather_segs(ChunkSegs& segs, bool keep,
                                            int len, long long base,
                                            int4 box) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned kept = __ballot_sync(0xffffffffu, keep);
  int incl = keep ? len : 0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) {
    segs.warp_segs[warp] = __popc(kept);
    segs.warp_len[warp] = incl;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int ns = 0, nl = 0;
    for (int i = 0; i < kWarps; ++i) {
      const int s = segs.warp_segs[i], l = segs.warp_len[i];
      segs.warp_segs[i] = ns;
      segs.warp_len[i] = nl;
      ns += s;
      nl += l;
    }
    segs.n = ns;
    segs.start[ns] = nl;
  }
  __syncthreads();
  if (keep) {
    const int pos = segs.warp_segs[warp] +
                    __popc(kept & ((1u << lane) - 1u));
    segs.base[pos] = base;
    segs.start[pos] = segs.warp_len[warp] + incl - len;
    segs.box[pos] = box;
  }
  __syncthreads();
}

// Adds the 8 corners of one event that fall in box to the tile's
// accumulator (rows x pitch a bin, origin (tile.r0, tile.c0)).
__device__ __forceinline__ void splat8(float* acc, float x, float y,
                                       float tn, float v, int4 box,
                                       const Tile& tile, int bins, int rows,
                                       int pitch) {
  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int cx = x0 + dx;
    if (cx < box.x || cx >= box.y) continue;
    const float wx = v * (1.0f - fabsf((float)cx - x));
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int cy = y0 + dy;
      if (cy < box.z || cy >= box.w) continue;
      const float wxy = wx * (1.0f - fabsf((float)cy - y));
      float* cell = acc + (cy - tile.r0) * pitch + (cx - tile.c0);
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const int ct = t0 + dt;
        if (ct < 0 || ct >= bins) continue;
        const float wt = 1.0f - fabsf((float)ct - tn);
        atomicAdd(cell + ct * rows * pitch, wxy * wt);
      }
    }
  }
}

// Adds one event at the integer pixel (xi, yi) = (trunc x, trunc y), if
// that lies in box, bilinearly in time (K4, K6), in the plain versions' f32
// order: nothing unless tn >= 0; ti = trunc tn, dts = tn - ti; 1 - dts in
// time bin ti and dts in ti + 1, each where that bin is below `bins`;
// signed by v into channels [0, bins), or with separate_pol unsigned into
// channel ti (v > 0) or bins + ti (otherwise) of 2 * bins.
__device__ __forceinline__ void splat2_bilinear_t(
    float* acc, float x, float y, float tn, float v, int4 box,
    const Tile& tile, int bins, bool separate_pol, int rows, int pitch) {
  if (!(tn >= 0.0f)) return;
  const int xi = (int)x, yi = (int)y;
  if (xi < box.x || xi >= box.y || yi < box.z || yi >= box.w) return;
  const int ti = (int)tn;
  if (ti >= bins) return;
  const float dts = tn - (float)ti;
  const float sign = separate_pol ? 1.0f : v;
  const int ch = (separate_pol && !(v > 0.0f)) ? bins + ti : ti;
  float* cell = acc + (ch * rows + (yi - tile.r0)) * pitch + (xi - tile.c0);
  atomicAdd(cell, sign * (1.0f - dts));
  if (ti + 1 < bins) atomicAdd(cell + rows * pitch, sign * dts);
}

// What an event adds, for accumulate(): K1's and K5's 8 corners ...
struct Trilinear {
  int bins;

  __device__ __forceinline__ void operator()(float* acc, float x, float y,
                                             float tn, float v, int4 box,
                                             const Tile& tile, int rows,
                                             int pitch) const {
    splat8(acc, x, y, tn, v, box, tile, bins, rows, pitch);
  }
};

// ... or K4's and K6's 2 (channels = bins, or 2 * bins with separate_pol).
struct BilinearT {
  int bins;
  bool separate_pol;

  __device__ __forceinline__ void operator()(float* acc, float x, float y,
                                             float tn, float v, int4 box,
                                             const Tile& tile, int rows,
                                             int pitch) const {
    splat2_bilinear_t(acc, x, y, tn, v, box, tile, bins, separate_pol, rows,
                      pitch);
  }
};

// Splats every event of segs' segments. The threads stride over the
// segments' concatenated slots; each walks its segment index forward.
template <class Reader, class Splat, int kCap>
__device__ __forceinline__ void accumulate(float* acc,
                                           const Segs<kCap>& segs,
                                           const Reader& rd,
                                           const Splat& splat,
                                           const Tile& tile, int rows,
                                           int pitch) {
  const int total = segs.start[segs.n];
  int k = 0;
  for (int g = threadIdx.x; g < total; g += kThreads) {
    while (segs.start[k + 1] <= g) ++k;
    float x, y, tn, v;
    rd.load(segs.base[k] + (g - segs.start[k]), x, y, tn, v);
    splat(acc, x, y, tn, v, segs.box[k], tile, rows, pitch);
  }
}

// The floats a grid row is stored in at a time: 4 (16 bytes) when rows are
// 16-byte aligned (W % 4 == 0; c0 and the pitch are multiples of 4), 2 when
// they are 8-byte aligned (W even, as DDD17's 346: the tile's width is then
// even too), else 1. Each splat kernel takes it as a template parameter,
// so an instantiation holds one store loop: on an H100 that ran faster,
// for each of the four kernels, than one loop choosing among the three
// widths row by row, which also took more registers.
template <int kVec>
struct StoreVec;
template <>
struct StoreVec<4> {
  using type = float4;
};
template <>
struct StoreVec<2> {
  using type = float2;
};
template <>
struct StoreVec<1> {
  using type = float;
};

// Calls launch(std::integral_constant<int, kVec>{}) with kVec the store
// width of a grid `width` floats wide; returns what launch returns.
template <class Launch>
inline cudaError_t with_store_vec(int width, Launch launch) {
  if ((width & 3) == 0) return launch(std::integral_constant<int, 4>{});
  if ((width & 1) == 0) return launch(std::integral_constant<int, 2>{});
  return launch(std::integral_constant<int, 1>{});
}

// Writes the tile's cells of every channel to the window's grid (plane
// H * W), each once, after a barrier that ends the accumulation: a warp
// takes a row of one channel at a time, its lanes the row's kVec-float
// pieces, with streaming stores. The grid must be 16-byte aligned. One
// division a row, none a cell.
template <int kVec>
__device__ __forceinline__ void store_tile(const float* acc, float* grid,
                                           const Tile& tile, int channels,
                                           int rows, int pitch, int height,
                                           int width) {
  using V = typename StoreVec<kVec>::type;
  __syncthreads();
  const int nr = tile.r1 - tile.r0, nc = tile.c1 - tile.c0;
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)height * width;
  for (int row = threadIdx.x >> 5; row < channels * nr; row += kWarps) {
    const int ct = row / nr, r = row - ct * nr;
    const float* src = acc + (ct * rows + r) * pitch;
    float* dst = grid + ct * plane + (long long)(tile.r0 + r) * width +
                 tile.c0;
    for (int c = kVec * lane; c < nc; c += 32 * kVec)
      __stcs(reinterpret_cast<V*>(dst + c),
             *reinterpret_cast<const V*>(src + c));
  }
}

// Allows `kernel` `smem` bytes of dynamic shared memory on the current
// device; returns the CUDA error. Needed whenever static and dynamic
// shared memory pass 48 KB together (K1's splat: 7 KB of segments beside a
// 41 KB tile). The attribute is set once a (kernel, device): a table
// remembers what each already allows.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem) {
  struct Allowed {
    const void* kernel;
    int device, smem;
  };
  static Allowed table[128];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* key = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < used && (table[i].kernel != key || table[i].device != dev)) ++i;
  if (i < used && smem <= table[i].smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  if (i < used) {
    table[i].smem = smem;
  } else if (used < 128) {
    table[used++] = Allowed{key, dev, smem};
  }
  return cudaSuccess;
}

}  // namespace tile_splat
