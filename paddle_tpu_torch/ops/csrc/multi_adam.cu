// Multi-tensor Adam for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/ops/pallas_kernels.py:
//   multi_tensor_adam -> _multi_adam_kernel
//
// Contract: one launch updates a whole group of parameters. For each
// element, in f32 and in this order (the _multi_adam_kernel expressions):
//   m1o = beta1 * m1 + (1 - beta1) * g
//   m2o = beta2 * m2 + (1 - beta2) * g * g
//   po  = p - lr_t * m1o / (sqrt(m2o) + eps)
// with the per-parameter lr_t (bias correction applied by the caller),
// each result rounded once to its storage dtype (f32 or bf16, parameters
// and moments independently). Products and sums use the _rn intrinsics so
// that nvcc contracts nothing into an FMA: the arithmetic is the plain
// PyTorch version's, operation for operation. Updates are in place: the
// outputs are the input tensors.
//
// Layout: the TPU kernel packs every tensor into chunk-padded (rows, 128)
// slabs, a layout its tiling needs. Here no tensor is copied: a device table
// holds each parameter's four pointers (param, grad, moment1, moment2), its
// size, its vector head (below) and the index of its first chunk; CTA b
// finds its parameter by a binary search over the chunk starts and updates
// one chunk of kChunk elements in place.
//
// Bound: bytes. Each element reads p, g, m1, m2 and writes p, m1, m2
// (28 bytes in f32) for about a dozen flops; the least time is those bytes
// over the HBM rate. To come near it every thread keeps kVecs 4-element
// vectors of each of the four tensors in flight at once: 16-byte loads and
// stores for f32 (8-byte for bf16), streaming cache hints (each byte is
// touched once), and __restrict__ on every pointer, so the loads of a batch
// issue together. A vector needs its four tensors at one phase mod 4
// elements: the table's head is the number of leading elements done one at
// a time before the first aligned vector (0-3), or -1 where the four
// tensors' phases differ and the whole tensor goes element by element (a
// view at an odd offset). Each chunk does its few elements before its first
// vector and after its last one alone, so every element is updated once.
//
// Plain C interface, loaded with ctypes (ops/multi_adam.py). The launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing
// (the caller uploads the table), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;  // elements per CTA (a multiple of 4)
constexpr int kThreads = 256;
constexpr int kVecs = 4;  // 4-element vectors of each tensor a thread keeps in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// four consecutive elements (a 16-byte f32 or 8-byte bf16 vector), streamed
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  // each element rounded to nearest even, as __float2bfloat16 rounds it
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  __stcs(reinterpret_cast<uint2*>(p), u);
}

struct Hyper {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps;
};

// the _multi_adam_kernel expressions for one element, in place
__device__ __forceinline__ void adam(const Hyper& h, float lr, float gv, float& p, float& m1,
                                     float& m2) {
  const float m1o = __fadd_rn(__fmul_rn(h.beta1, m1), __fmul_rn(h.one_minus_beta1, gv));
  const float m2o = __fadd_rn(__fmul_rn(h.beta2, m2),
                              __fmul_rn(h.one_minus_beta2, __fmul_rn(gv, gv)));
  const float upd = __fdiv_rn(__fmul_rn(lr, m1o), __fadd_rn(__fsqrt_rn(m2o), h.eps));
  p = __fsub_rn(p, upd);
  m1 = m1o;
  m2 = m2o;
}

template <typename TP, typename TG, typename TM>
__device__ __forceinline__ void adam_elems(const Hyper& h, float lr, TP* __restrict__ p,
                                           const TG* __restrict__ g, TM* __restrict__ m1,
                                           TM* __restrict__ m2, int64_t lo, int64_t hi) {
  for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
    float pv = to_f32(p[i]), a = to_f32(m1[i]), b = to_f32(m2[i]);
    adam(h, lr, to_f32(g[i]), pv, a, b);
    p[i] = from_f32<TP>(pv);
    m1[i] = from_f32<TM>(a);
    m2[i] = from_f32<TM>(b);
  }
}

// table (int64): ptrs[4 * n] (param, grad, m1, m2 per tensor), sizes[n],
// heads[n], chunk_start[n + 1] (chunk_start[n] is the total chunk count)
template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads)
multi_adam_kernel(const int64_t* __restrict__ table, const float* __restrict__ lr_t, int n,
                  Hyper h) {
  const int64_t* ptrs = table;
  const int64_t* sizes = table + 4 * (int64_t)n;
  const int64_t* heads = sizes + n;
  const int64_t* chunk_start = heads + n;
  const int64_t c = blockIdx.x;
  // the last tensor whose first chunk is <= this chunk
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= c) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  TP* __restrict__ p = reinterpret_cast<TP*>(ptrs[4 * t + 0]);
  const TG* __restrict__ g = reinterpret_cast<const TG*>(ptrs[4 * t + 1]);
  TM* __restrict__ m1 = reinterpret_cast<TM*>(ptrs[4 * t + 2]);
  TM* __restrict__ m2 = reinterpret_cast<TM*>(ptrs[4 * t + 3]);
  const int64_t size = sizes[t], head = heads[t];
  const int64_t begin = (c - chunk_start[t]) * kChunk;
  const int64_t end = begin + kChunk < size ? begin + kChunk : size;
  const float lr = lr_t[t];
  if (head < 0) {  // the four tensors' phases differ: element by element
    adam_elems(h, lr, p, g, m1, m2, begin, end);
    return;
  }
  // kChunk is a multiple of 4, so the first vector of the chunk starts at
  // begin + head
  const int64_t vbegin = begin + head < end ? begin + head : end;
  const int64_t nv = (end - vbegin) / 4, vend = vbegin + 4 * nv;
  adam_elems(h, lr, p, g, m1, m2, begin, vbegin);
  adam_elems(h, lr, p, g, m1, m2, vend, end);
  for (int64_t v0 = threadIdx.x; v0 < nv; v0 += kThreads * kVecs) {
    float pv[kVecs][4], gv[kVecs][4], a[kVecs][4], b[kVecs][4];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = vbegin + 4 * (v0 + u * kThreads);
      if (v0 + u * kThreads >= nv) continue;
      load4(p + i, pv[u]);
      load4(g + i, gv[u]);
      load4(m1 + i, a[u]);
      load4(m2 + i, b[u]);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t i = vbegin + 4 * (v0 + u * kThreads);
      if (v0 + u * kThreads >= nv) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) adam(h, lr, gv[u][e], pv[u][e], a[u][e], b[u][e]);
      store4(p + i, pv[u]);
      store4(m1 + i, a[u]);
      store4(m2 + i, b[u]);
    }
  }
}

template <typename TP, typename TG, typename TM>
cudaError_t launch_typed(const int64_t* table, const float* lr_t, int n, int64_t n_chunks,
                         const Hyper& h, cudaStream_t st) {
  multi_adam_kernel<TP, TG, TM><<<(unsigned)n_chunks, kThreads, 0, st>>>(table, lr_t, n, h);
  return cudaGetLastError();
}

template <typename TP, typename TG>
cudaError_t by_moment(int m_dtype, const int64_t* table, const float* lr_t, int n,
                      int64_t n_chunks, const Hyper& h, cudaStream_t st) {
  if (m_dtype == 0) return launch_typed<TP, TG, float>(table, lr_t, n, n_chunks, h, st);
  if (m_dtype == 1)
    return launch_typed<TP, TG, __nv_bfloat16>(table, lr_t, n, n_chunks, h, st);
  return cudaErrorInvalidValue;
}

template <typename TP>
cudaError_t by_grad(int g_dtype, int m_dtype, const int64_t* table, const float* lr_t, int n,
                    int64_t n_chunks, const Hyper& h, cudaStream_t st) {
  if (g_dtype == 0) return by_moment<TP, float>(m_dtype, table, lr_t, n, n_chunks, h, st);
  if (g_dtype == 1)
    return by_moment<TP, __nv_bfloat16>(m_dtype, table, lr_t, n, n_chunks, h, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int multi_adam_chunk_elems() { return kChunk; }

// dtypes: 0 f32, 1 bf16, for the params, the grads and both moments.
// one_minus_beta1/2 are (1 - beta) computed by the caller in double and
// rounded to f32, as a Python float constant is in the plain version.
int multi_adam(const int64_t* table, const float* lr_t, int n, int64_t n_chunks,
               int p_dtype, int g_dtype, int m_dtype, float beta1, float one_minus_beta1,
               float beta2, float one_minus_beta2, float eps, void* stream) {
  if (n <= 0 || n_chunks <= 0 || n_chunks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Hyper h{beta1, one_minus_beta1, beta2, one_minus_beta2, eps};
  if (p_dtype == 0)
    return (int)by_grad<float>(g_dtype, m_dtype, table, lr_t, n, n_chunks, h, st);
  if (p_dtype == 1)
    return (int)by_grad<__nv_bfloat16>(g_dtype, m_dtype, table, lr_t, n, n_chunks, h, st);
  return (int)cudaErrorInvalidValue;
}

const char* multi_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
