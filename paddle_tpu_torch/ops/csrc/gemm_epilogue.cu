// Fused GEMM + bias + activation epilogue for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   gemm_bias_act        -> _gemm_epilogue_kernel (grid-pipelined k loop)
//   _gemm_bias_act_dbuf  -> _gemm_dbuf_kernel (the copy of k tile k+1
//                           overlaps the math of tile k)
// Both compute the same function bit for bit; here one kernel does both
// jobs: its k loop is a two-stage cp.async pipeline.
//
// Contract: z = x @ w + bias with an f32 accumulator, y = act(z) for
// act in {relu, gelu (erf form), tanh, sigmoid} computed on the f32 value,
// each rounded ONCE to the operand dtype. x is [m, k], w is [k, n], both
// row-major, f32 or bf16 (the same dtype); bias is [n] f32 (the wrapper
// widens other float dtypes, which is exact). z and y are [m, n] in the
// operand dtype; y is not written when act is none. Any m, n, k: ragged
// tile edges are zero-filled on load and masked on store.
//
// Bound: operations. At the main path's shapes (m 4096, k and n 512 or
// 2048) the GEMM does 2mnk flops on (mk + kn + mn) elements; at f32 SIMT
// rates (67 TFLOP/s, no tensor cores: f32 in, f32 math) that is far above
// the card's flop/byte balance. Design: a classic SIMT tile GEMM — a
// 256-thread CTA owns a 128 x 128 output tile, each thread 8 x 8 outputs
// in registers, x and w tiles of depth 16 staged through shared memory by
// cp.async into two buffers, so the load of tile k+1 is in flight while
// tile k is multiplied. FMAs are plain f32 (no TF32: the parity tolerances
// assume full f32). wgmma, TMA and tensor-core operand formats are left for
// later work.
//
// Plain C interface, loaded with ctypes (ops/gemm_epilogue.py). The
// launcher enqueues on the caller's stream, does not synchronize, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;  // 16 x 16; each thread 8 x 8 outputs

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kTanh = 3, kSigmoid = 4 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

template <int ACT> __device__ __forceinline__ float act_f32(float z) {
  if (ACT == kRelu) return fmaxf(z, 0.0f);
  if (ACT == kGelu) return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
  if (ACT == kTanh) return tanhf(z);
  if (ACT == kSigmoid) return 1.0f / (1.0f + expf(-z));
  return z;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Stage one [rows x cols] tile of a row-major [R x C] matrix (leading
// dimension C), whose top-left element is (r0, c0), into smem with row
// stride `ld`. 16-byte chunks go through cp.async when they lie wholly in
// range and are 16-byte aligned in global memory; the rest (ragged edges,
// misaligned rows) are loaded element by element, zero past the edge.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* smem, int ld, const T* g, int R, int C,
                                          int r0, int c0, int tid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = ROWS * COLS / kVec;
  for (int ch = tid; ch < kChunks; ch += kThreads) {
    const int r = ch / (COLS / kVec);
    const int c = (ch % (COLS / kVec)) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    T* dst = smem + r * ld + c;
    const T* src = g + (int64_t)gr * C + gc;
    if (gr < R && gc + kVec <= C && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src);
    } else {
      for (int e = 0; e < kVec; ++e) {
        dst[e] = (gr < R && gc + e < C) ? src[e] : from_f32<T>(0.0f);
      }
    }
  }
}

template <typename T, int ACT>
__global__ void __launch_bounds__(kThreads)
gemm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ z,
                     T* __restrict__ y, int m, int n, int k) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLdA = kBK + kVec;  // row strides padded by 16 bytes: each
  constexpr int kLdB = kBN + kVec;  // row start stays 16-byte aligned
  __shared__ __align__(16) T As[2][kBM * kLdA];
  __shared__ __align__(16) T Bs[2][kBK * kLdB];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (k + kBK - 1) / kBK;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  load_tile<T, kBM, kBK>(As[0], kLdA, x, m, k, m0, 0, tid);
  load_tile<T, kBK, kBN>(Bs[0], kLdB, w, k, n, 0, n0, tid);
  cp_async_commit();

  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tile<T, kBM, kBK>(As[cur ^ 1], kLdA, x, m, k, m0, (kt + 1) * kBK, tid);
      load_tile<T, kBK, kBN>(Bs[cur ^ 1], kLdB, w, k, n, (kt + 1) * kBK, n0, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count in step
    cp_async_wait_1();  // every group but the newest landed: tile kt is here
    __syncthreads();
    const T* a = As[cur];
    const T* b = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float av[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = to_f32(a[(ty + 16 * i) * kLdA + kk]);
#pragma unroll
      for (int j = 0; j < 8; ++j) bv[j] = to_f32(b[kk * kLdB + tx + 16 * j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the next iteration's loads overwrite the other stage
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx + 16 * j;
      if (c >= n) continue;
      const float zv = acc[i][j] + bias[c];
      const int64_t o = (int64_t)r * n + c;
      z[o] = from_f32<T>(zv);
      if (ACT != kNone) y[o] = from_f32<T>(act_f32<ACT>(zv));
    }
  }
}

template <typename T>
cudaError_t launch_typed(const void* x, const void* w, const float* bias, void* z,
                         void* y, int m, int n, int k, int act, cudaStream_t st) {
  dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* zp = static_cast<T*>(z);
  T* yp = static_cast<T*>(y);
  switch (act) {
    case kNone:
      gemm_bias_act_kernel<T, kNone><<<grid, kThreads, 0, st>>>(xp, wp, bias, zp, yp, m, n, k);
      break;
    case kRelu:
      gemm_bias_act_kernel<T, kRelu><<<grid, kThreads, 0, st>>>(xp, wp, bias, zp, yp, m, n, k);
      break;
    case kGelu:
      gemm_bias_act_kernel<T, kGelu><<<grid, kThreads, 0, st>>>(xp, wp, bias, zp, yp, m, n, k);
      break;
    case kTanh:
      gemm_bias_act_kernel<T, kTanh><<<grid, kThreads, 0, st>>>(xp, wp, bias, zp, yp, m, n, k);
      break;
    case kSigmoid:
      gemm_bias_act_kernel<T, kSigmoid><<<grid, kThreads, 0, st>>>(xp, wp, bias, zp, yp, m, n, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. act: 0 none, 1 relu, 2 gelu, 3 tanh, 4 sigmoid.
int gemm_bias_act(const void* x, const void* w, const float* bias, void* z, void* y,
                  int m, int n, int k, int dtype, int act, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  if (act != kNone && y == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    err = launch_typed<float>(x, w, bias, z, y, m, n, k, act, st);
  } else if (dtype == 1) {
    err = launch_typed<__nv_bfloat16>(x, w, bias, z, y, m, n, k, act, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}

const char* gemm_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
