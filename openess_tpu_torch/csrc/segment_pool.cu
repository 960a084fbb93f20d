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
// over the HBM rate. The danger is the reduction: one device-memory atomic
// per pixel and channel would be N x D atomics into S x D addresses.
//
// Design (the plan, ops/segment_pool.py:pool_plan, sets every number):
// - The rows come as images of `rows_per_image` rows whose ids lie in a
//   window of `segments_per_image` ids, [b spi, (b + 1) spi) for image b
//   (a flat call is one image of S ids). A block owns one contiguous range
//   of one image's rows and one tile of channels, and keeps a table of
//   `window` segments x the tile in f32, plus a pixel count a segment, in
//   shared memory (100 KB at 100 segments x 256 channels): every sum of
//   its range lands there, in shared memory, not in device memory.
// - The stream: each row group of `lanes` lanes (a whole warp at 256
//   channels) walks a contiguous sub-range of the block's rows; a lane
//   loads 16 bytes of a row through the read-only path (8 bf16 or 4 f32
//   channels; scalars where a row is not 16-byte aligned) and keeps 64
//   bytes a lane in flight, so a warp reads a 512-byte bf16 row in one
//   instruction. (Tried on an H100 and no faster: more rows in flight, L2
//   prefetches of the rows ahead, streaming cache hints, warps interleaved
//   over row chunks, 1024-thread blocks.)
// - Each lane keeps the running f32 sum of its channels for the current
//   id in registers and adds it to the table (shared atomics) when the id
//   changes. The table lays channel c of a row at (c % V) * (tile / V) +
//   c / V (V the channels a load), so the 32 adds of one instruction fall
//   in 32 banks (a row one float longer where a warp holds several row
//   groups). An id outside the block's window (a per-image id past
//   segments_per_image, or ids beyond a capped window) goes from its run
//   partial straight to device memory.
// - One flush a block: the table rows it touched (a nonzero count) are
//   added to `sums` and `counts` in device memory, four channels an atomic
//   (sm_90's float4 atomicAdd): blocks x touched segments x D / 4 atomics
//   in all, not one per id run and channel.
//
// Sum order differs from a sequential sum (atomics, run partials), so the
// result agrees with the plain version to f32 rounding, not bit for bit;
// counts are integers in shared memory and exact.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// K2's plan, as ops/segment_pool.py:PoolPlan decides it; the wrapper
// fills one a shape and passes its address with every launch, so every
// number of the decomposition comes from there. (Outside the anonymous
// namespace: the C entry takes it, and must keep external linkage.)
struct Plan {
  long long rows;                // images x rows_per_image
  long long rows_per_image;
  long long chunk;               // rows of a range (an image's last: fewer)
  int channels;                  // d
  int segments;                  // s: ids in [0, s) count
  int segments_per_image;        // image b's window starts at b x this
  int window;                    // table rows
  int tile;                      // channels of a block (grid y tiles them)
  int pitch;                     // floats a table row takes
  int vec;                       // channels a load: 8 bf16 / 4 f32, or 1
  int lanes;                     // lanes a row (a power of two, x 8 >= tile)
  int parts;                     // ranges an image (grid x: images x parts)
  int smem_bytes;                // window x (pitch + 1) x 4
  int is_bf16;
};

namespace {

constexpr int kThreads = 512;     // 16 warps a block
constexpr int kMinBlocks = 2;     // resident blocks an SM the plan sizes for
constexpr int kLaneFloats = 8;    // channels a lane owns in a row
constexpr int kSmemLimit = 232448;  // shared memory a block can use
constexpr int kMaxDevices = 64;

// One load of V channels of a row, kept raw in registers until it is added.
template <typename T, int V>
struct Chunk;

template <>
struct Chunk<__nv_bfloat16, 8> {
  uint4 q;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    q = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void zero() { q = make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ void add_to(float* a) const {
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // bf16 -> f32 is a shift
      a[2 * i] += __uint_as_float(w[i] << 16);
      a[2 * i + 1] += __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

template <>
struct Chunk<float, 4> {
  float4 q;
  __device__ __forceinline__ void load(const float* p) {
    q = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ void zero() {
    q = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __device__ __forceinline__ void add_to(float* a) const {
    a[0] += q.x;
    a[1] += q.y;
    a[2] += q.z;
    a[3] += q.w;
  }
};

template <>
struct Chunk<__nv_bfloat16, 1> {
  uint32_t q;
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    q = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  __device__ __forceinline__ void zero() { q = 0u; }
  __device__ __forceinline__ void add_to(float* a) const {
    a[0] += __uint_as_float(q << 16);
  }
};

template <>
struct Chunk<float, 1> {
  float q;
  __device__ __forceinline__ void load(const float* p) { q = __ldg(p); }
  __device__ __forceinline__ void zero() { q = 0.f; }
  __device__ __forceinline__ void add_to(float* a) const { a[0] += q; }
};

// a[0:V] into p[0:V] of device memory (p 16-byte aligned when V > 1)
template <int V>
__device__ __forceinline__ void global_add(float* p, const float* a) {
  if constexpr (V == 1) {
    atomicAdd(p, a[0]);
  } else {
#pragma unroll
    for (int i = 0; i < V; i += 4) {
      atomicAdd(reinterpret_cast<float4*>(p + i),
                make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]));
    }
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
segment_sums_table(const T* __restrict__ feats,
                   const int32_t* __restrict__ ids, float* __restrict__ sums,
                   float* __restrict__ counts, const Plan p) {
  constexpr int NV = kLaneFloats / V;  // loads a lane makes of a row
  // rows a lane loads ahead: 16 registers of raw loads (64 bytes in
  // flight a lane with 16-byte loads)
  constexpr int U = 64 / (NV * (int)sizeof(Chunk<T, V>));
  extern __shared__ float4 smem[];
  const int d = p.channels, s = p.segments, pitch = p.pitch;
  const int lanes = p.lanes;
  float* table = reinterpret_cast<float*>(smem);  // [window][pitch]
  int* taken = reinterpret_cast<int*>(table + p.window * pitch);  // [window]
  const int nvec = p.tile / V;

  const int img = blockIdx.x / p.parts;
  const int part = blockIdx.x - img * p.parts;
  const int c0 = blockIdx.y * p.tile;
  const int width = min(p.tile, d - c0);
  // the window's first id
  const long long base = (long long)img * p.segments_per_image;
  const int wlen =
      (int)max(0LL, min((long long)p.window, (long long)s - base));

  // this block's rows [lo, hi) of image img (PoolPlan.block_rows); this
  // row group's [glo, ghi)
  const long long first = (long long)img * p.rows_per_image;
  const long long lo =
      first + min((long long)part * p.chunk, p.rows_per_image);
  const long long hi =
      first + min((long long)(part + 1) * p.chunk, p.rows_per_image);
  const int lane = threadIdx.x & 31;
  const int gl = lane & (lanes - 1);  // lane within its row group
  const int per_warp = 32 / lanes;
  const int group = (threadIdx.x >> 5) * per_warp + lane / lanes;
  const int groups = (kThreads / 32) * per_warp;
  const long long len = hi - lo;
  const long long sub = (len + groups - 1) / groups;
  const long long glo = lo + min((long long)group * sub, len);
  const long long ghi = lo + min((long long)(group + 1) * sub, len);

  int vj[NV];  // this lane's loads: vector vj[j] (channels vj[j] * V ...)
  bool has[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    vj[j] = j * lanes + gl;
    has[j] = vj[j] * V < width;
  }
  const T* col = feats + c0;

  int cur = -1;  // segment being accumulated; -1: none (a skipped pixel)
  int cnt = 0;
  float acc[kLaneFloats];
#pragma unroll
  for (int i = 0; i < kLaneFloats; ++i) acc[i] = 0.0f;

  auto flush = [&]() {
    if (cur < 0) return;
    const long long w = cur - base;
    if (w >= 0 && w < wlen) {
      float* row = table + (int)w * pitch;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (!has[j]) continue;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          atomicAdd(row + k * nvec + vj[j], acc[j * V + k]);
        }
      }
      if (gl == 0) atomicAdd(taken + (int)w, cnt);
    } else {
      float* row = sums + (long long)cur * d + c0;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (has[j]) global_add<V>(row + vj[j] * V, &acc[j * V]);
      }
      if (gl == 0 && blockIdx.y == 0) atomicAdd(counts + cur, (float)cnt);
    }
  };

  for (int i = threadIdx.x; i < p.window * (pitch + 1); i += kThreads) {
    table[i] = 0.0f;  // the counts too: int 0 is f32 0's bits
  }
  __syncthreads();

  for (long long r = glo; r < ghi; r += U) {
    int id[U];
    Chunk<T, V> x[U][NV];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = r + u;
      const bool in = p < ghi;
      const int raw = in ? __ldg(ids + p) : -1;
      id[u] = (raw >= 0 && raw < s) ? raw : -1;
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        if (in && has[j]) {
          x[u][j].load(col + p * d + vj[j] * V);
        } else {
          x[u][j].zero();
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (id[u] != cur) {
        flush();
        cur = id[u];
        cnt = 0;
#pragma unroll
        for (int i = 0; i < kLaneFloats; ++i) acc[i] = 0.0f;
      }
      ++cnt;
#pragma unroll
      for (int j = 0; j < NV; ++j) x[u][j].add_to(&acc[j * V]);
    }
  }
  flush();

  // the one flush: every touched table row into device memory
  __syncthreads();
  const int vecs = width / V;
  for (int i = threadIdx.x; i < wlen * nvec; i += kThreads) {
    const int w = i / nvec;
    const int v = i - w * nvec;
    const int n = taken[w];
    if (n == 0 || v >= vecs) continue;
    float a[V];
#pragma unroll
    for (int k = 0; k < V; ++k) a[k] = table[w * pitch + k * nvec + v];
    global_add<V>(sums + (base + w) * d + c0 + v * V, a);
    if (v == 0 && blockIdx.y == 0) atomicAdd(counts + base + w, (float)n);
  }
}

// Lets segment_sums_table<T, V> take up to kSmemLimit bytes of dynamic
// shared memory, once a device (the attribute is the device's; setting
// the same value again is harmless, so no lock).
template <typename T, int V>
cudaError_t allow_smem() {
  static std::atomic<bool> done[kMaxDevices];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(segment_sums_table<T, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemLimit);
  if (err == cudaSuccess && dev < kMaxDevices) {
    done[dev].store(true, std::memory_order_relaxed);
  }
  return err;
}

template <typename T, int V>
int launch(const void* feats, const void* ids, void* sums, void* counts,
           const Plan& p, cudaStream_t st) {
  cudaError_t err = allow_smem<T, V>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.rows / p.rows_per_image * p.parts),
                  (unsigned)((p.channels + p.tile - 1) / p.tile));
  segment_sums_table<T, V><<<grid, kThreads, (size_t)p.smem_bytes, st>>>(
      (const T*)feats, (const int32_t*)ids, (float*)sums, (float*)counts, p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. Pointers are device pointers: feats [rows,
// channels] row-major (bf16 when is_bf16, else f32), ids [rows] int32,
// sums [segments, channels] f32 and counts [segments] f32, both zeroed
// here first; `plan` points to a Plan in host memory. Works on `stream`
// and returns a cudaError_t (0 on success).
extern "C" int segment_pool_sums(const void* feats, const void* ids,
                                 void* sums, void* counts, const Plan* plan,
                                 void* stream) {
  const Plan& p = *plan;
  if (p.channels <= 0 || p.segments <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      sums, 0, (size_t)p.segments * p.channels * sizeof(float), st);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(counts, 0, (size_t)p.segments * sizeof(float), st);
  }
  if (err != cudaSuccess || p.rows <= 0) return (int)err;
  if (p.rows_per_image <= 0 || p.rows % p.rows_per_image != 0 ||
      p.chunk <= 0 || p.chunk * p.parts < p.rows_per_image ||
      p.segments_per_image < 0 ||
      p.window < 0 || p.tile <= 0 || p.vec <= 0 || p.tile % p.vec != 0 ||
      p.pitch < p.tile || p.parts <= 0 || p.lanes <= 0 || p.lanes > 32 ||
      (p.lanes & (p.lanes - 1)) != 0 || p.lanes * kLaneFloats < p.tile ||
      (long long)p.smem_bytes < (long long)p.window * (p.pitch + 1) * 4) {
    return (int)cudaErrorInvalidValue;
  }
  const long long blocks = p.rows / p.rows_per_image * p.parts;
  if (blocks > 2147483647LL ||
      (p.channels + p.tile - 1) / p.tile > 65535 ||
      p.smem_bytes > kSmemLimit) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (p.vec > 1 && ((uintptr_t)feats % 16 != 0 ||
                    (uintptr_t)sums % 16 != 0 || p.channels % p.vec != 0)) {
    return (int)cudaErrorMisalignedAddress;
  }
  if (p.is_bf16 && p.vec == 8) {
    return launch<__nv_bfloat16, 8>(feats, ids, sums, counts, p, st);
  }
  if (p.is_bf16 && p.vec == 1) {
    return launch<__nv_bfloat16, 1>(feats, ids, sums, counts, p, st);
  }
  if (!p.is_bf16 && p.vec == 4) {
    return launch<float, 4>(feats, ids, sums, counts, p, st);
  }
  if (!p.is_bf16 && p.vec == 1) {
    return launch<float, 1>(feats, ids, sums, counts, p, st);
  }
  return (int)cudaErrorInvalidValue;
}
