// K5 and K6: the grid wire's two voxelizers, splats of raw padded f32
// events into full per-window grids, for Hopper (sm_90a). The wrapper
// (openess_tpu_torch/ops/voxelize_mxu.py) prepares the events as the TPU
// path's wrapper does around its pallas_call: per-window time normalization
// over the valid events, padding routed out of every corner. These kernels
// take those four prepared f32 arrays, flat over nw * k event slots, and a
// zero-filled f32 grid [nw, channels, height, width].
//
// K5 (tri_splat_events, DSEC): replaces openess_tpu/ops/voxelize_mxu.py:
// _kernel (reached through voxelize_windows_trilinear_mxu). It computes the
// same function: an event of value v = +-1 at (x, y, tn) adds
// v * wx * wy * wt to the 8 corners {x0, x0+1} x {y0, y0+1} x {t0, t0+1},
// the corners truncated toward zero (a C (int) cast, torch .int()) and
// w = 1 - |corner - coord|. A fractional negative coordinate so keeps the
// reference's corner pair {0, 1} with a negative weight on corner 1. A
// corner outside [0, W) x [0, H) x [0, bins) is dropped, as the TPU
// kernel's iota columns drop it. Padding (value 0) returns at once.
//
// K6 (bil_splat_events, DDD17): replaces openess_tpu/ops/voxelize_mxu.py:
// _kernel_bilinear_t (reached through voxelize_windows_bilinear_t_mxu).
// An event at integer pixel (trunc x, trunc y) adds 1 - dts to time bin
// ti = trunc(tn) and dts = tn - ti to bin ti + 1 where that bin exists,
// signed by its polarity into `bins` channels, or unsigned into the positive
// (pol > 0) or negative block of 2 * bins channels with separate_pol. It
// adds nothing unless tn >= 0, tn < bins and pol != 0, the TPU kernel's
// `ok`; the wrapper sets pol 0 and tn -4 for padding and out-of-frame
// events. This is K4's splat (csrc/voxelize_chunked.cu) on raw events in
// place of the sorted-chunk wire; with no chunk blocks to mask, the two
// kernels share no code.
//
// Both compute in f32, in the plain version's product order. The TPU
// kernels build one-hot matrices and multiply them in bf16 on the matrix
// unit, a way around scatters; these are scatters, one thread per event
// slot, with one f32 atomicAdd per corner into global memory (8 for K5, 2
// for K6). Only the order of the atomics differs from the plain version.
//
// What bounds them on an H100: K5 at DSEC's batch (160 windows of 100k
// events, 5 x 480 x 640) reads 16 B per event slot (256 MB) and writes a
// 983 MB grid: ~0.37 ms of HBM traffic at 3.35 TB/s. It issues up to 128M
// atomics; consecutive slots belong to one window, so the ~270k threads in
// flight touch ~3 windows' grids (6.1 MB each), which stay in the 50 MB L2
// where the atomics resolve. K6 at DDD17's batch (160 x 32k events,
// 5 x 260 x 346) reads 82 MB and writes 288 MB (576 MB with separate_pol),
// with 2 atomics per event. Offsets into the grid are 64-bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
tri_splat_events(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ tns, const float* __restrict__ vs,
                 float* __restrict__ out, long long n, int k, int bins,
                 int height, int width) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float v = vs[s];
  if (v == 0.0f) return;  // padding
  const float x = xs[s], y = ys[s], tn = tns[s];
  const long long plane = (long long)height * width;
  float* grid = out + (s / k) * bins * plane;
  const int x0 = (int)x, y0 = (int)y, t0 = (int)tn;
#pragma unroll
  for (int dx = 0; dx < 2; ++dx) {
    const int cx = x0 + dx;
    if (cx < 0 || cx >= width) continue;
    const float wx = v * (1.0f - fabsf((float)cx - x));
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int cy = y0 + dy;
      if (cy < 0 || cy >= height) continue;
      const float wxy = wx * (1.0f - fabsf((float)cy - y));
#pragma unroll
      for (int dt = 0; dt < 2; ++dt) {
        const int ct = t0 + dt;
        if (ct < 0 || ct >= bins) continue;
        const float wt = 1.0f - fabsf((float)ct - tn);
        atomicAdd(grid + ct * plane + (long long)cy * width + cx, wxy * wt);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bil_splat_events(const float* __restrict__ xs, const float* __restrict__ ys,
                 const float* __restrict__ tns, const float* __restrict__ pols,
                 float* __restrict__ out, long long n, int k, int bins,
                 int separate_pol, int height, int width) {
  const long long s = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (s >= n) return;
  const float tn = tns[s], pol = pols[s];
  if (!(tn >= 0.0f && tn < (float)bins && pol != 0.0f)) return;
  const int xi = (int)xs[s], yi = (int)ys[s];
  // the TPU kernel's one-hot columns span the frame only
  if (xi < 0 || xi >= width || yi < 0 || yi >= height) return;
  const int ti = (int)tn;
  const float dts = tn - (float)ti;
  const int cout = separate_pol ? 2 * bins : bins;
  const float sign = separate_pol ? 1.0f : pol;
  const int ch = (separate_pol && !(pol > 0.0f)) ? bins + ti : ti;
  const long long plane = (long long)height * width;
  float* cell = out + ((s / k) * cout + ch) * plane +
                (long long)yi * width + xi;
  atomicAdd(cell, sign * (1.0f - dts));
  if (ti + 1 < bins) atomicAdd(cell + plane, sign * dts);
}

unsigned int blocks_for(long long n) {
  return (unsigned int)((n + kThreads - 1) / kThreads);
}

}  // namespace

// Plain C entries for ctypes. Pointers are device pointers to nw * k f32
// event slots each; out must hold nw * channels * height * width zeros
// (channels = bins for K5; bins, or 2 * bins with separate_pol, for K6).
// Each launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int voxelize_windows_trilinear(
    const void* x, const void* y, const void* tn, const void* value,
    void* out, int nw, int k, int bins, int height, int width,
    void* stream) {
  const long long n = (long long)nw * k;
  if (n <= 0) return 0;
  tri_splat_events<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)tn,
      (const float*)value, (float*)out, n, k, bins, height, width);
  return (int)cudaGetLastError();
}

extern "C" int voxelize_windows_bilinear_t(
    const void* x, const void* y, const void* tn, const void* pol,
    void* out, int nw, int k, int bins, int separate_pol, int height,
    int width, void* stream) {
  const long long n = (long long)nw * k;
  if (n <= 0) return 0;
  bil_splat_events<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const float*)tn,
      (const float*)pol, (float*)out, n, k, bins, separate_pol, height,
      width);
  return (int)cudaGetLastError();
}
