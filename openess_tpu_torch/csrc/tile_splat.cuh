// The tile-owner trilinear splat shared by K1 (csrc/voxelize_chunked.cu)
// and K5 (csrc/voxelize_grid.cu), for Hopper (sm_90a).
//
// One block owns one output tile of one window's [bins, H, W] f32 grid:
// frame rows [r0, r1) and columns [c0, c1), every bin. It zeroes a
// [bins, rows, pitch] f32 accumulator in dynamic shared memory, adds every
// corner of its events that falls in its tile with shared-memory atomics,
// and then writes the whole tile once with 16-byte streaming stores, zeros
// included. The grid is then written exactly once and needs neither a zero
// fill nor global atomics: what a splat must move, the events read and the
// grid written, is all the device memory it touches. The tile's geometry
// comes from the wrappers' plan (openess_tpu_torch/ops/tile_splat.py);
// the pitch is cols + 4 floats, so the rows of one column fall in
// different banks while each row stays 16-byte aligned.
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
// are kept in (the tile, cut for K1 by the chunk's block). accumulate()
// is templated on how an event slot is read: K1 dequantizes the
// sorted-chunk wire, K5 loads its binned, prepared float4.
//
// The corner rule is the plain versions': corners {x0, x0+1} x {y0, y0+1}
// x {t0, t0+1} with the coordinates truncated toward zero (a C (int) cast,
// torch .int()), weights w = 1 - |corner - coord| multiplied as
// ((v * wx) * wy) * wt in f32, corners outside [0, bins) in time dropped.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tile_splat {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// Splats every event of segs' segments. The threads stride over the
// segments' concatenated slots; each walks its segment index forward.
template <class Reader, int kCap>
__device__ __forceinline__ void accumulate(float* acc,
                                           const Segs<kCap>& segs,
                                           const Reader& rd,
                                           const Tile& tile, int bins,
                                           int rows, int pitch) {
  const int total = segs.start[segs.n];
  int k = 0;
  for (int g = threadIdx.x; g < total; g += kThreads) {
    while (segs.start[k + 1] <= g) ++k;
    float x, y, tn, v;
    rd.load(segs.base[k] + (g - segs.start[k]), x, y, tn, v);
    splat8(acc, x, y, tn, v, segs.box[k], tile, bins, rows, pitch);
  }
}

// Writes the tile's cells of every bin to the window's grid (plane
// H * W), each once: a warp takes a row of one bin at a time, its lanes the
// row's 16-byte pieces (streaming stores) when rows are 16-byte aligned
// (W % 4 == 0; c0 and the pitch are multiples of 4), else single floats.
// One division a row, none a cell.
__device__ __forceinline__ void store_tile(const float* acc, float* grid,
                                           const Tile& tile, int bins,
                                           int rows, int pitch, int height,
                                           int width) {
  const int nr = tile.r1 - tile.r0, nc = tile.c1 - tile.c0;
  const int lane = threadIdx.x & 31;
  const long long plane = (long long)height * width;
  for (int row = threadIdx.x >> 5; row < bins * nr; row += kWarps) {
    const int ct = row / nr, r = row - ct * nr;
    const float* src = acc + (ct * rows + r) * pitch;
    float* dst = grid + ct * plane + (long long)(tile.r0 + r) * width +
                 tile.c0;
    if ((width & 3) == 0) {
      for (int c = 4 * lane; c < nc; c += 128)
        __stcs(reinterpret_cast<float4*>(dst + c),
               *reinterpret_cast<const float4*>(src + c));
    } else {
      for (int c = lane; c < nc; c += 32) __stcs(dst + c, src[c]);
    }
  }
}

// Allows a kernel `smem` bytes of dynamic shared memory on the current
// device; returns the CUDA error. Needed whenever static and dynamic
// shared memory pass 48 KB together (K1's splat: 7 KB of segments beside a
// 41 KB tile). `allowed` is the caller's record of what each device
// already allows, so the attribute is set once a device.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int smem, int (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err == cudaSuccess && dev < 64) allowed[dev] = smem;
  return err;
}

}  // namespace tile_splat
