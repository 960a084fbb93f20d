// K1 and K4: the two voxelizers of the sorted-chunk event wire, for Hopper
// (sm_90a), both tile-owner splats of csrc/tile_splat.cuh and one kernel,
// chunk_tile_splat, templated on the splat. K1 (DSEC) is described first,
// K4 (DDD17) below it.
//
// K1: signed trilinear splat of the sorted-chunk event wire into per-window
// voxel grids.
//
// Replaces openess_tpu/ops/voxelize_chunked.py:_tri_kernel (reached through
// _call and voxelize_chunked_trilinear). It computes the same function:
// each event of a chunk adds v * wx * wy * wt to the 8 corners
// {x0, x0+1} x {y0, y0+1} x {t0, t0+1} of its dequantized coordinates, with
// the corners truncated toward zero (a C (int) cast, torch .int()) and
// w = 1 - |corner - coord|. For a fractional negative coordinate this keeps
// the reference's negative weight on the +1 corner. A corner is kept only
// inside [0, bins) x [0, H) x [0, W) and inside the chunk's block of the
// TPU kernel's padded grid, rows [r0, r0 + 24) and columns [c0, c0 + 256),
// so a malformed descriptor drops corners exactly as the TPU kernel does.
// The wire is dequantized here, fused (the TPU path's _prep pass): x, y =
// int16 / 32; tn = (bins - 1) * t * (1 / 65535) for the uint16 wire (v2) or
// (bins - 1) * t / max(t_range, 1e-9) for the f32 wire (v1); v = 2p - 1.
// All arithmetic is f32. The TPU kernel multiplies in bf16 on its matrix
// unit; that rounding is an artefact of the unit and is not reproduced.
//
// What bounds it on an H100: per 100k-event window it reads ~0.7 MB of wire
// (7 B an event) and writes a 5 x 480 x 640 f32 grid (6.1 MB); at 160
// windows ~1.1 GB, 0.33 ms of HBM traffic. Its first design (one thread an
// event, 8 f32 atomicAdds into a zero-filled grid in device memory) took
// 8x that: 128M atomics resolving in L2, behind a 983 MB zero fill.
//
// This design is the tile-owner splat of csrc/tile_splat.cuh: one block
// per (tile, window) accumulates its tile in shared memory and writes it
// once, so the grid is written once, with no fill and no global atomics.
// A block finds its events by reading its window's chunk descriptors, 256
// at a time: a chunk takes part when its clamped block, cut to the frame,
// meets the tile, and its corners are then kept in that intersection. No
// order of chunks and no alignment of r0 or c0 is assumed, so a shuffled
// wire or a malformed descriptor gives the same grid. The cost of owning
// tiles is read amplification: the chunker's blocks are 128-column aligned
// and 24 rows deep, so with 16 x 128 tiles each chunk meets 2 column tiles
// and 2 row tiles (its own, and the one below for the corner row r0 + 16):
// its events are read 4 times, ~28 B an event, 2.8 MB a window. They come
// from L2 (a window's wire is 0.7 MB, and its 150 tiles' blocks run
// together), so device memory still sees the wire about once; the price is
// the 4x work of reading and testing events, and the atomics of chunks
// sorted by x, whose lanes meet on neighbouring cells: K1 takes about half
// as long again as K5's splat of the same number of corners
// (tools/tile_splat_sweep.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_splat.cuh"

namespace {

using tile_splat::kThreads;

constexpr float kInvFixedPoint = 1.0f / 32.0f;  // FIXED_POINT = 32
constexpr int kRowsBlock = 24;                  // _ROWS_TRI
constexpr int kColsBlock = 256;                 // _COLS_TRI

// Reads slot s of the wire, dequantized.
template <bool kT16>
struct WireReader {
  const int16_t* __restrict__ xq;
  const int16_t* __restrict__ yq;
  const uint8_t* __restrict__ pq;
  const void* __restrict__ t_rel;
  float tb, rng;

  __device__ __forceinline__ void load(long long s, float& x, float& y,
                                       float& tn, float& v) const {
    x = (float)xq[s] * kInvFixedPoint;
    y = (float)yq[s] * kInvFixedPoint;
    if (kT16) {
      tn = tb * (float)((const uint16_t*)t_rel)[s] * (1.0f / 65535.0f);
    } else {
      tn = tb * ((const float*)t_rel)[s] / rng;
    }
    v = 2.0f * (float)pq[s] - 1.0f;
  }
};

// K1's and K4's kernel, one block per (tile, window) (the design above):
// it reads its window's descriptors 256 at a time and keeps each chunk
// whose clamped block, rows [r0, r0 + kBlockRows) and columns
// [c0, c0 + kBlockCols) cut to the frame, meets its tile. Splat is
// tile_splat::Trilinear for K1 (a 24 x 256 block) or tile_splat::BilinearT
// for K4 (16 x 128); channels is bins, or 2 * bins for K4 with
// separate_pol.
template <bool kT16, int kVec, class Splat, int kBlockRows, int kBlockCols>
__global__ void __launch_bounds__(kThreads, tile_splat::kChunkSplatBlocks)
chunk_tile_splat(const int16_t* __restrict__ xq,
                 const int16_t* __restrict__ yq,
                 const uint8_t* __restrict__ pq,
                 const void* __restrict__ t_rel,
                 const int32_t* __restrict__ counts,
                 const int32_t* __restrict__ desc,
                 const float* __restrict__ t_range, float* __restrict__ out,
                 Splat splat, int channels, int nbc, int chunk, int height,
                 int width, int r0_max, int c0_max, int rows, int cols,
                 int pitch, int tiles_x) {
  extern __shared__ float4 dyn_smem[];
  float* acc = reinterpret_cast<float*>(dyn_smem);
  __shared__ tile_splat::ChunkSegs segs;
  const int w = blockIdx.y;
  const tile_splat::Tile tile =
      tile_splat::tile_of(blockIdx.x, rows, cols, tiles_x, height, width);
  tile_splat::zero_tile(acc, channels * rows * pitch);
  const WireReader<kT16> rd{xq, yq, pq, t_rel, (float)(splat.bins - 1),
                            kT16 ? 0.0f : fmaxf(t_range[w], 1e-9f)};

  for (int j0 = 0; j0 < nbc; j0 += kThreads) {
    const int j = j0 + threadIdx.x;
    const long long wc = (long long)w * nbc + j;
    int n = 0;
    int4 box = make_int4(0, 0, 0, 0);
    if (j < nbc) {
      n = min(counts[wc], chunk);
      // packed descriptor: row offset | (col offset << 16), clamped as the
      // TPU wrappers clamp it (voxelize_chunked.py:498-501, 539-540)
      const int d = desc[wc];
      const int r0 = min(max(d & 0xFFFF, 0), r0_max);
      const int c0 = min(max(d >> 16, 0), c0_max);
      box = make_int4(max(c0, tile.c0), min(c0 + kBlockCols, tile.c1),
                      max(r0, tile.r0), min(r0 + kBlockRows, tile.r1));
    }
    const bool keep = n > 0 && box.x < box.y && box.z < box.w;
    tile_splat::gather_segs(segs, keep, n, wc * chunk, box);
    tile_splat::accumulate(acc, segs, rd, splat, tile, rows, pitch);
    __syncthreads();  // segs is rewritten by the next 256 chunks
  }
  tile_splat::store_tile<kVec>(
      acc, out + (long long)w * channels * height * width, tile, channels,
      rows, pitch, height, width);
}

// K4: DDD17 voxelizer, exact pixel and bilinear in time.
//
// Replaces openess_tpu/ops/voxelize_chunked.py:_bil_kernel (reached through
// _call and voxelize_chunked_bilinear_t). It computes the same function: an
// event's integer pixel (xi, yi) = trunc(x), trunc(y) gets 1 - dts in time
// bin ti = trunc(tn) and dts = tn - ti in bin ti + 1 where that bin exists.
// The weights are signed by v = 2p - 1 into `bins` channels, or, with
// separate_pol, unsigned into the positive (v > 0) or negative block of
// 2 * bins channels. An event adds nothing when tn < 0, when its slot is
// padding, when its pixel is outside the frame or outside its chunk's block
// of the TPU kernel's padded grid, rows [r0, r0 + 16) and columns
// [c0, c0 + 128): the TPU kernel's one-hots are zero there. The wire is
// dequantized here as in K1 (the TPU path's _prep pass), in f32; the TPU
// kernel rounds 1 - dts and dts to bf16 for its matrix unit, this one does
// not.
//
// What bounds it on an H100: at DDD17's batch (160 windows of 32k events,
// 5 x 260 x 346) it reads 36 MB of wire (7 B an event) and writes a 288 MB
// f32 grid (576 MB with separate_pol): 0.097 ms of HBM traffic (0.183).
// Its first design (one block per chunk, two f32 atomicAdds per event into
// a zero-filled grid in device memory) took 4x that: 10 M atomics
// resolving in L2 behind the fill.
//
// This design is K1's tile owner, chunk_tile_splat, with K4's splat
// (tile_splat::BilinearT) and K4's block: one block per (tile, window)
// keeps each chunk whose clamped block, cut to the frame, meets its tile;
// the chunk's events are kept in that intersection. No order of
// chunks and no alignment of r0 or c0 is assumed: a chunk at a misaligned
// r0 meets two row tiles, and each keeps its own rows. Events past
// min(count, chunk) are padding. The chunker's blocks are the 16 x 128
// tiles themselves (r0 on a 16-row tile, c0 128-aligned), so a well-formed
// chunk is read by exactly one tile, and every event is read once.
constexpr int kRowsBil = 16;   // TILE_ROWS
constexpr int kColsBil = 128;  // _COLS_BIL

// Launches chunk_tile_splat with the store width of `width` and the time
// wire of t16; returns the CUDA error.
template <class Splat, int kBlockRows, int kBlockCols>
int launch_chunk_splat(const void* xq, const void* yq, const void* pq,
                       const void* t_rel, const void* counts,
                       const void* desc, const void* t_range, void* out,
                       Splat splat, int channels, int nw, int nbc, int chunk,
                       int height, int width, int r0_max, int c0_max,
                       int rows, int cols, int pitch, int tiles, int tiles_x,
                       int smem, int t16, void* stream) {
  if (nw <= 0) return 0;
  return (int)tile_splat::with_store_vec(width, [&](auto vec) {
    constexpr int kVec = decltype(vec)::value;
    auto kernel =
        t16 ? chunk_tile_splat<true, kVec, Splat, kBlockRows, kBlockCols>
            : chunk_tile_splat<false, kVec, Splat, kBlockRows, kBlockCols>;
    cudaError_t err = tile_splat::allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<dim3(tiles, nw), kThreads, smem, (cudaStream_t)stream>>>(
        (const int16_t*)xq, (const int16_t*)yq, (const uint8_t*)pq, t_rel,
        (const int32_t*)counts, (const int32_t*)desc, (const float*)t_range,
        (float*)out, splat, channels, nbc, chunk, height, width, r0_max,
        c0_max, rows, cols, pitch, tiles_x);
    return cudaGetLastError();
  });
}

}  // namespace

// Plain C entry for ctypes (K1). Pointers are device pointers; out holds
// nw * bins * height * width floats, each written once (no fill needed).
// rows, cols, pitch and tiles_x are the tile plan's, smem its accumulator
// bytes (openess_tpu_torch/ops/tile_splat.py). Launches on `stream` and
// returns the CUDA error (0 on success).
extern "C" int voxelize_chunked_trilinear(
    const void* xq, const void* yq, const void* pq, const void* t_rel,
    const void* counts, const void* desc, const void* t_range, void* out,
    int nw, int nbc, int chunk, int bins, int height, int width, int r0_max,
    int c0_max, int rows, int cols, int pitch, int tiles, int tiles_x,
    int smem, int t16, void* stream) {
  return launch_chunk_splat<tile_splat::Trilinear, kRowsBlock, kColsBlock>(
      xq, yq, pq, t_rel, counts, desc, t_range, out,
      tile_splat::Trilinear{bins}, bins, nw, nbc, chunk, height, width,
      r0_max, c0_max, rows, cols, pitch, tiles, tiles_x, smem, t16, stream);
}

// Plain C entry for ctypes (K4). out holds nw * cout * height * width
// floats, cout = separate_pol ? 2 * bins : bins, each written once (no fill
// needed); the geometry and smem are the tile plan's for cout channels.
// Launches on `stream` and returns the CUDA error (0 on success).
extern "C" int voxelize_chunked_bilinear_t(
    const void* xq, const void* yq, const void* pq, const void* t_rel,
    const void* counts, const void* desc, const void* t_range, void* out,
    int nw, int nbc, int chunk, int bins, int separate_pol, int height,
    int width, int r0_max, int c0_max, int rows, int cols, int pitch,
    int tiles, int tiles_x, int smem, int t16, void* stream) {
  return launch_chunk_splat<tile_splat::BilinearT, kRowsBil, kColsBil>(
      xq, yq, pq, t_rel, counts, desc, t_range, out,
      tile_splat::BilinearT{bins, separate_pol != 0},
      separate_pol ? 2 * bins : bins, nw, nbc, chunk, height, width, r0_max,
      c0_max, rows, cols, pitch, tiles, tiles_x, smem, t16, stream);
}
