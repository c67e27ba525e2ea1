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
// size, and the index of its first chunk; CTA b finds its parameter by a
// binary search over the chunk starts and updates one chunk of 4096
// elements in place.
//
// Bound: bytes. Each element reads p, g, m1, m2 and writes p, m1, m2
// (28 bytes in f32) for about a dozen flops; the least time is those bytes
// over the HBM rate.
//
// Plain C interface, loaded with ctypes (ops/multi_adam.py). The launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing
// (the caller uploads the table), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 4096;  // elements per CTA
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// table (int64): ptrs[4 * n] (param, grad, m1, m2 per tensor), sizes[n],
// chunk_start[n + 1] (chunk_start[n] is the total chunk count)
template <typename TP, typename TG, typename TM>
__global__ void __launch_bounds__(kThreads)
multi_adam_kernel(const int64_t* __restrict__ table, const float* __restrict__ lr_t,
                  int n, float beta1, float one_minus_beta1, float beta2,
                  float one_minus_beta2, float eps) {
  const int64_t* ptrs = table;
  const int64_t* sizes = table + 4 * (int64_t)n;
  const int64_t* chunk_start = sizes + n;
  const int64_t chunk = blockIdx.x;
  // the last tensor whose first chunk is <= this chunk
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (chunk_start[mid] <= chunk) lo = mid; else hi = mid - 1;
  }
  const int t = lo;
  TP* p = reinterpret_cast<TP*>(ptrs[4 * t + 0]);
  const TG* g = reinterpret_cast<const TG*>(ptrs[4 * t + 1]);
  TM* m1 = reinterpret_cast<TM*>(ptrs[4 * t + 2]);
  TM* m2 = reinterpret_cast<TM*>(ptrs[4 * t + 3]);
  const int64_t size = sizes[t];
  const int64_t begin = (chunk - chunk_start[t]) * kChunk;
  const int64_t end = begin + kChunk < size ? begin + kChunk : size;
  const float lr = lr_t[t];
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const float gv = to_f32(g[i]);
    const float m1o = __fadd_rn(__fmul_rn(beta1, to_f32(m1[i])), __fmul_rn(one_minus_beta1, gv));
    const float m2o = __fadd_rn(__fmul_rn(beta2, to_f32(m2[i])),
                                __fmul_rn(one_minus_beta2, __fmul_rn(gv, gv)));
    const float upd = __fdiv_rn(__fmul_rn(lr, m1o), __fadd_rn(__fsqrt_rn(m2o), eps));
    p[i] = from_f32<TP>(__fsub_rn(to_f32(p[i]), upd));
    m1[i] = from_f32<TM>(m1o);
    m2[i] = from_f32<TM>(m2o);
  }
}

template <typename TP, typename TG, typename TM>
cudaError_t launch_typed(const int64_t* table, const float* lr_t, int n, int64_t n_chunks,
                         float b1, float c1, float b2, float c2, float eps, cudaStream_t st) {
  multi_adam_kernel<TP, TG, TM><<<(unsigned)n_chunks, kThreads, 0, st>>>(
      table, lr_t, n, b1, c1, b2, c2, eps);
  return cudaGetLastError();
}

template <typename TP, typename TG>
cudaError_t by_moment(int m_dtype, const int64_t* table, const float* lr_t, int n,
                      int64_t n_chunks, float b1, float c1, float b2, float c2, float eps,
                      cudaStream_t st) {
  if (m_dtype == 0) return launch_typed<TP, TG, float>(table, lr_t, n, n_chunks, b1, c1, b2, c2, eps, st);
  if (m_dtype == 1)
    return launch_typed<TP, TG, __nv_bfloat16>(table, lr_t, n, n_chunks, b1, c1, b2, c2, eps, st);
  return cudaErrorInvalidValue;
}

template <typename TP>
cudaError_t by_grad(int g_dtype, int m_dtype, const int64_t* table, const float* lr_t, int n,
                    int64_t n_chunks, float b1, float c1, float b2, float c2, float eps,
                    cudaStream_t st) {
  if (g_dtype == 0) return by_moment<TP, float>(m_dtype, table, lr_t, n, n_chunks, b1, c1, b2, c2, eps, st);
  if (g_dtype == 1)
    return by_moment<TP, __nv_bfloat16>(m_dtype, table, lr_t, n, n_chunks, b1, c1, b2, c2, eps, st);
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
  if (p_dtype == 0)
    return (int)by_grad<float>(g_dtype, m_dtype, table, lr_t, n, n_chunks, beta1,
                               one_minus_beta1, beta2, one_minus_beta2, eps, st);
  if (p_dtype == 1)
    return (int)by_grad<__nv_bfloat16>(g_dtype, m_dtype, table, lr_t, n, n_chunks, beta1,
                                       one_minus_beta1, beta2, one_minus_beta2, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* multi_adam_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
