// K2: per-segment feature sums and pixel counts (superpixel pooling), for
// Hopper (sm_90a).
//
// Replaces openess_tpu/ops/segment_pool.py:_pool_kernel (reached through
// _pallas_pool_sums from segment_mean_pool_pallas). It computes the same
// function: for N pixel rows feats[n, :] (bf16 or f32) keyed by int32
// segment ids,
//     sums[s, :] = sum over {n : ids[n] == s} of feats[n, :]   (f32)
//     counts[s]  = |{n : ids[n] == s}|                          (f32)
// An id outside [0, S) adds nothing. The TPU kernel builds a [chunk, S]
// one-hot per pixel chunk and contracts it on the matrix unit because a
// scatter serialises there; on this card that would be S-fold redundant
// arithmetic, so none of its structure (lane padding of S, the sentinel
// row, the chunked grid) is carried over.
//
// What bounds it on an H100: bytes. Every feature row is read once
// (N x D x 2 B in bf16; 1.15 GB at N = 8 x 440 x 640, D = 256) and the
// output is tiny (S x D f32), so the least time is the feature stream
// over the HBM rate. The danger is the reduction: one atomic per pixel
// and channel would be N x D atomics into S x D addresses.
//
// Design: a block owns `run` consecutive pixel rows and a tile of
// channels (blockIdx.y picks the tile); a thread owns one f32 channel or
// two adjacent bf16 channels (one 4-byte load), so a warp reads
// consecutive channels of one row. Each thread keeps the running f32 sum
// of the current segment id in a register and does one atomicAdd into
// `sums` when the id changes or the run ends; the thread of channel 0 does
// the same for `counts`. Superpixels are spatially coherent, so along an image
// row the id changes rarely and the atomics drop from one per pixel to one
// per id run. Loads are started `kUnroll` rows ahead of their use to keep
// enough bytes in flight. Ids that alternate per pixel (the worst case)
// still give the right sums, one atomic per pixel.
//
// Sum order differs from a sequential sum (atomics, run partials), so the
// result agrees with the plain version to f32 rounding, not bit for bit;
// counts are sums of small integers and are exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kUnroll = 8;

// VEC consecutive channels of one row as f32.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* p, float (&out)[VEC]);
template <>
__device__ __forceinline__ void load_row<float, 1>(const float* p,
                                                   float (&out)[1]) {
  out[0] = *p;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float (&out)[1]) {
  out[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 2>(
    const __nv_bfloat16* p, float (&out)[2]) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = f.x;
  out[1] = f.y;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kMaxThreads)
segment_sums(const T* __restrict__ feats, const int32_t* __restrict__ ids,
             float* __restrict__ sums, float* __restrict__ counts,
             long long n, int d, int s, int run) {
  // first of this thread's VEC channels (d is a multiple of VEC)
  const int ch = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (ch >= d) return;
  const bool counter = (ch == 0);
  const long long lo = (long long)blockIdx.x * run;
  const long long hi = min(lo + (long long)run, n);

  int cur = -1;  // segment being accumulated; -1: none (skipped pixel)
  float acc[VEC], cnt = 0.0f;
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;

  auto flush = [&]() {
    if (cur < 0) return;
    float* row = sums + (long long)cur * d + ch;
#pragma unroll
    for (int k = 0; k < VEC; ++k) atomicAdd(row + k, acc[k]);
    if (counter) atomicAdd(counts + cur, cnt);
  };

  for (long long base = lo; base < hi; base += kUnroll) {
    int id[kUnroll];
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long p = base + u;
      if (p < hi) {
        id[u] = ids[p];
        load_row<T, VEC>(feats + p * d + ch, v[u]);
      } else {
        id[u] = -1;
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][k] = 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (id[u] != cur) {
        flush();
        cur = (id[u] >= 0 && id[u] < s) ? id[u] : -1;
        cnt = 0.0f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
      }
      if (cur >= 0) {
        cnt += 1.0f;
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
      }
    }
  }
  flush();
}

template <typename T, int VEC>
int launch(const void* feats, const void* ids, void* sums, void* counts,
           long long n, int d, int s, int run, cudaStream_t st) {
  // one thread per VEC channels, whole warps, at most kMaxThreads a block
  const int lanes = (d + VEC - 1) / VEC;
  const int threads = min(kMaxThreads, ((lanes + 31) / 32) * 32);
  const long long blocks = (n + run - 1) / run;
  const int tiles = (lanes + threads - 1) / threads;
  if (blocks > 2147483647LL || tiles > 65535) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  segment_sums<T, VEC><<<grid, threads, 0, st>>>(
      (const T*)feats, (const int32_t*)ids, (float*)sums, (float*)counts, n,
      d, s, run);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers: feats [n, d]
// row-major (bf16 when is_bf16, else f32), ids [n] int32, sums [s, d] f32
// and counts [s] f32, both zeroed by the caller. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int segment_pool_sums(const void* feats, const void* ids,
                                 void* sums, void* counts, long long n,
                                 int d, int s, int run, int is_bf16,
                                 void* stream) {
  if (n <= 0 || d <= 0 || s <= 0) return 0;
  if (run <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!is_bf16) {
    return launch<float, 1>(feats, ids, sums, counts, n, d, s, run, st);
  }
  // two bf16 channels per thread where every row stays 4-byte aligned
  if (d % 2 == 0 && (uintptr_t)feats % 4 == 0) {
    return launch<__nv_bfloat16, 2>(feats, ids, sums, counts, n, d, s, run,
                                    st);
  }
  return launch<__nv_bfloat16, 1>(feats, ids, sums, counts, n, d, s, run, st);
}
