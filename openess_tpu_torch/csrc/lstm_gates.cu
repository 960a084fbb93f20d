// K3: the fused ConvLSTM gate pointwise tail and its backward, for Hopper
// (sm_90a). Replaces the TPU kernels openess_tpu/ops/lstm_gates.py:
// _fwd_kernel (:75) and _bwd_kernel (:88), reached through _run from
// fused_lstm_gates and its custom VJP. The wrapper is
// openess_tpu_torch/ops/lstm_gates.py.
//
// From the gate conv output gates [N, 4C] (NHWC rows, chunk order i, f, o,
// g) and the previous cell pc [N, C], in f32:
//
//   i, f, o = sigmoid(.), g = tanh(.)
//   c = f * pc + i * g,   h = o * tanh(c)
//
// and, from the same two inputs and the incoming dh, dc_next [N, C], the
// backward recomputes i, f, o, g, c and tanh(c) with the same formulas:
//
//   dc     = dc_next + dh * o * (1 - tanh(c)^2)
//   dgates = (dc*g*i(1-i), dc*pc*f(1-f), dh*tanh(c)*o(1-o), dc*i*(1-g^2))
//   dpc    = dc * f
//
// Outputs are stored in the input dtype. A null dh or dc_next reads as
// zero (autograd's None for an output nothing consumed). Sigmoid is
// 1 / (1 + e^-x); tanh is (1 - e) / (1 + e) with e = e^(-2|x|) and the sign
// restored. The exponential is __expf (ex2.approx) and the division
// __fdividef (rcp.approx), the arithmetic of the Triton kernels these
// replaced: with expf and IEEE division the kernels issued about twice the
// instructions an element and were bound by issue, not bytes, at C = 64.
// Against PyTorch's sigmoid and tanh the results stay within one bf16 ulp
// (plus 1e-6), and in f32 within 2^-20 of the value plus 1e-6 (forward)
// and 1e-5 of the largest gradient (backward), as checked on the card.
//
// What bounds them on an H100: bytes. Neither reuses a value: the forward
// reads 5C and writes 2C values a pixel, the backward reads 7C and writes
// 5C. At 440x640, B = 8, bf16 the forward moves 505 / 252 / 126 MB for
// C = 64 / 128 / 256 (0.264 ms at 3.35 TB/s, summed), the backward 865 /
// 432 / 216 MB (0.452 ms; f32 twice that); at 200x352, B = 8 the forward
// moves 221 MB. Each element also takes 5 exponentials and 5 divisions,
// which is why their cheap forms above matter: the gain is to run HBM at
// its rate without running out of issue slots.
//
// What the design does about it: one work item is one pixel times one
// 16-byte channel group (8 bf16 or 4 f32 values), one item a thread. A
// thread issues every 16-byte load of its item (the four gate runs at
// r*4C + q*C + v, pc, and in the backward dh and dc_next) before any
// arithmetic, so 5 or 7 independent 16-byte loads are in flight; inputs are
// read once, through the read-only path without allocating in L1.
// Neighbouring threads take neighbouring channel groups of a row, then the
// next row, so each warp's loads cover whole 32-byte sectors. Math is in f32
// registers, results leave as 16-byte stores. Blocks are 256 threads; 32
// (forward) and 64 (backward) registers in bf16 and no spills let 8 and 4
// blocks share an SM, about 160 and 112 KB of loads in flight. Two items a
// thread ran no faster on an H100. A C that is not a multiple of the vector
// width, or an input not 16-byte aligned, takes the scalar instantiation
// (VEC = 1) of the same kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float x, float& out) { out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& out) {
  out = __float2bfloat16_rn(x);
}

// f32 results into a group of VEC outputs, rounded to nearest even; bf16
// pairs in one conversion.
template <typename T, int VEC>
__device__ __forceinline__ void pack(const float (&x)[VEC],
                                     Vec<T, VEC>& out) {
  if constexpr (sizeof(T) == 2 && VEC % 2 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      const __nv_bfloat162 two = __floats2bfloat162_rn(x[k], x[k + 1]);
      memcpy(&out.v[k], &two, 4);
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) from_f32(x[k], out.v[k]);
  }
}

// A read-once input: a 16-byte group through the non-coherent path without
// allocating in L1, or one element through __ldg.
template <typename T, int VEC>
__device__ __forceinline__ Vec<T, VEC> load_stream(const T* p) {
  Vec<T, VEC> out;
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 r;
    asm("ld.global.nc.L1::no_allocate.v4.b32 {%0, %1, %2, %3}, [%4];"
        : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
        : "l"(p));
    memcpy(&out, &r, 16);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) out.v[k] = __ldg(p + k);
  }
  return out;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Vec<T, VEC>& v) {
  if constexpr (sizeof(T) * VEC == 16) {
    uint4 r;
    memcpy(&r, &v, 16);
    *reinterpret_cast<uint4*>(p) = r;
  } else {
    *reinterpret_cast<Vec<T, VEC>*>(p) = v;
  }
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));  // 1 / inf is 0
}

__device__ __forceinline__ float tanh_exp(float x) {
  const float e = __expf(-2.0f * fabsf(x));
  const float t = __fdividef(1.0f - e, 1.0f + e);
  return x < 0.0f ? -t : t;
}

// Item `it` of VEC channels: offset of its run in the [N, C] tensors and of
// its i-gate run in gates [N, 4C] (row r = it / groups: r*4C + v*VEC =
// it*VEC + 3C*r).
template <int VEC>
__device__ __forceinline__ void offsets(unsigned it, int groups, int C,
                                        size_t& s, size_t& g) {
  const unsigned r = it / (unsigned)groups;
  s = (size_t)it * VEC;
  g = s + (size_t)r * (3 * (size_t)C);
}

}  // namespace

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
lstm_gates_fwd(const T* __restrict__ gates, const T* __restrict__ pc,
               T* __restrict__ h, T* __restrict__ c, unsigned n_items,
               int C) {
  const unsigned it = blockIdx.x * kThreads + threadIdx.x;
  if (it >= n_items) return;
  size_t so, go;
  offsets<VEC>(it, C / VEC, C, so, go);
  Vec<T, VEC> gv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    gv[q] = load_stream<T, VEC>(gates + go + (size_t)q * C);
  const Vec<T, VEC> pv = load_stream<T, VEC>(pc + so);
  float hf[VEC], cf[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float i = sigmoid(to_f32(gv[0].v[k]));
    const float f = sigmoid(to_f32(gv[1].v[k]));
    const float o = sigmoid(to_f32(gv[2].v[k]));
    const float g = tanh_exp(to_f32(gv[3].v[k]));
    cf[k] = f * to_f32(pv.v[k]) + i * g;
    hf[k] = o * tanh_exp(cf[k]);
  }
  Vec<T, VEC> out;
  pack<T, VEC>(cf, out);
  store<T, VEC>(c + so, out);
  pack<T, VEC>(hf, out);
  store<T, VEC>(h + so, out);
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
lstm_gates_bwd(const T* __restrict__ gates, const T* __restrict__ pc,
               const T* __restrict__ dh, const T* __restrict__ dcn,
               T* __restrict__ dgates, T* __restrict__ dpc, unsigned n_items,
               int C) {
  const unsigned it = blockIdx.x * kThreads + threadIdx.x;
  if (it >= n_items) return;
  size_t so, go;
  offsets<VEC>(it, C / VEC, C, so, go);
  Vec<T, VEC> gv[4], hv, nv;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    gv[q] = load_stream<T, VEC>(gates + go + (size_t)q * C);
  const Vec<T, VEC> pv = load_stream<T, VEC>(pc + so);
  if (dh) hv = load_stream<T, VEC>(dh + so);
  if (dcn) nv = load_stream<T, VEC>(dcn + so);
  float out[5][VEC];  // dgates' four runs, then dpc
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float i = sigmoid(to_f32(gv[0].v[k]));
    const float f = sigmoid(to_f32(gv[1].v[k]));
    const float o = sigmoid(to_f32(gv[2].v[k]));
    const float g = tanh_exp(to_f32(gv[3].v[k]));
    const float p = to_f32(pv.v[k]);
    const float th = tanh_exp(f * p + i * g);
    const float d_h = dh ? to_f32(hv.v[k]) : 0.0f;
    const float d_n = dcn ? to_f32(nv.v[k]) : 0.0f;
    const float dc = d_n + d_h * o * (1.0f - th * th);
    out[0][k] = (dc * g) * i * (1.0f - i);
    out[1][k] = (dc * p) * f * (1.0f - f);
    out[2][k] = (d_h * th) * o * (1.0f - o);
    out[3][k] = (dc * i) * (1.0f - g * g);
    out[4][k] = dc * f;
  }
  Vec<T, VEC> ov;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    pack<T, VEC>(out[q], ov);
    store<T, VEC>(dgates + go + (size_t)q * C, ov);
  }
  pack<T, VEC>(out[4], ov);
  store<T, VEC>(dpc + so, ov);
}

namespace {

unsigned blocks_for(unsigned n_items) {
  return (n_items + kThreads - 1) / kThreads;
}

struct Forward {
  template <typename T, int V>
  static int run(const void* gates, const void* prev_cell, void* h, void* c,
                 unsigned n_items, int C, cudaStream_t stream) {
    lstm_gates_fwd<T, V><<<blocks_for(n_items), kThreads, 0, stream>>>(
        (const T*)gates, (const T*)prev_cell, (T*)h, (T*)c, n_items, C);
    return (int)cudaGetLastError();
  }
};

struct Backward {
  template <typename T, int V>
  static int run(const void* gates, const void* prev_cell, const void* dh,
                 const void* dc_next, void* dgates, void* dprev_cell,
                 unsigned n_items, int C, cudaStream_t stream) {
    lstm_gates_bwd<T, V><<<blocks_for(n_items), kThreads, 0, stream>>>(
        (const T*)gates, (const T*)prev_cell, (const T*)dh,
        (const T*)dc_next, (T*)dgates, (T*)dprev_cell, n_items, C);
    return (int)cudaGetLastError();
  }
};

// Op::run<T, VEC> for the instantiation the arguments name: dtype 0 = f32,
// 1 = bf16; vec 1 (scalar) or the dtype's 16-byte width. Anything else is
// refused.
template <typename Op, typename... A>
int dispatch(int dtype, int vec, A... args) {
  if (dtype == 0 && vec == 4) return Op::template run<float, 4>(args...);
  if (dtype == 0 && vec == 1) return Op::template run<float, 1>(args...);
  if (dtype == 1 && vec == 8)
    return Op::template run<__nv_bfloat16, 8>(args...);
  if (dtype == 1 && vec == 1)
    return Op::template run<__nv_bfloat16, 1>(args...);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entries for ctypes. Device pointers to contiguous NHWC tensors of
// one dtype: gates and dgates hold n_items * vec / C rows of 4C values, the
// others rows of C. With vec > 1, C % vec == 0 and every pointer is 16-byte
// aligned (the wrapper's launch plan sees to both). dh and dc_next may be
// null. Each launches on `stream` and returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a dtype or vec it does not
// instantiate.
extern "C" int lstm_gates_forward(const void* gates, const void* prev_cell,
                                  void* h, void* c, unsigned n_items, int C,
                                  int dtype, int vec, void* stream) {
  if (n_items == 0) return 0;
  return dispatch<Forward>(dtype, vec, gates, prev_cell, h, c, n_items, C,
                           (cudaStream_t)stream);
}

extern "C" int lstm_gates_backward(const void* gates, const void* prev_cell,
                                   const void* dh, const void* dc_next,
                                   void* dgates, void* dprev_cell,
                                   unsigned n_items, int C, int dtype,
                                   int vec, void* stream) {
  if (n_items == 0) return 0;
  return dispatch<Backward>(dtype, vec, gates, prev_cell, dh, dc_next,
                            dgates, dprev_cell, n_items, C,
                            (cudaStream_t)stream);
}
