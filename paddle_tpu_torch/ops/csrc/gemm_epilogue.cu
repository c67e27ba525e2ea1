// Fused GEMM + bias + activation epilogue for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   gemm_bias_act        -> _gemm_epilogue_kernel (grid-pipelined k loop)
//   _gemm_bias_act_dbuf  -> _gemm_dbuf_kernel (the copy of k tile k+1
//                           overlaps the math of tile k)
// Both compute the same function bit for bit; here one kernel does both
// jobs: its k loop is a ring of cp.async stages.
//
// Contract: z = x @ w + bias with an f32 accumulator, y = act(z) for
// act in {relu, gelu (erf form), tanh, sigmoid} computed on the f32 value,
// each rounded ONCE to the operand dtype. x is [m, k], w is [k, n], both
// row-major, f32 or bf16 (the same dtype); bias is [n] f32 (the wrapper
// widens other float dtypes, which is exact). z and y are [m, n] in the
// operand dtype; y is not written when act is none. Any m, n, k: ragged
// tile edges are zero-filled on load and masked on store, and rows that
// are not 16-byte aligned load element by element.
//
// Bound: operations. At the main path's shapes (m 4096; k, n = 512, 2048
// or 2048, 512) the GEMM does 2mnk = 8.59 GFLOP on 14.7-46 MB of operands.
// f32 accuracy on the tensor cores costs three TF32 products (3xTF32,
// tf32_mma.cuh): 3 x 8.59 GFLOP at the card's 495 TFLOP/s dense TF32 is
// 0.0521 ms, against 0.1282 ms for one f32 product on the CUDA cores
// (67 TFLOP/s) and 0.0138 ms for the bytes (3.35 TB/s). bf16 operands are
// exact in TF32, so one product per pair: 2mnk at 495 TFLOP/s. (A bf16
// m16n8k16 form, at 989 TFLOP/s, is later work: no main path runs bf16.)
//
// Accuracy: each product of 3xTF32 is within about 2^-20 relative of the
// f32 product; one TF32 product (about 2^-11) would miss the kernel's 1e-4
// tolerance against the plain f32 product at k = 2048 (the CPU emulation in
// tests/test_torch_fused_kernels.py lands outside it). The tensor
// core's f32 sums align their addends by truncation, so a sum carried in it
// over all of k drifts one way (close to the 1e-4 tolerance at FFN2 on the
// card): each 64-deep stage sums in the tensor core from 0 and joins the
// f32 accumulator by one rounded add, which keeps the error near 1e-5.
// This is why the port's no-TF32 rule (ops/registry.py), which is about
// accuracy, holds here.
//
// Design: a CTA of 8 warps owns a 128 x 64 output tile, each warp 32 x 32
// as 2 x 4 mma.sync.m16n8k8 tiles. k advances 64 a stage through two
// cp.async stages in dynamic shared memory (104 KB: two CTAs a SM), one
// __syncthreads a stage; an in-range tile with 16-byte aligned rows copies
// without per-chunk checks. x fragments come by ldmatrix (f32) and w's as
// 32-bit words; each is split hi / lo in registers (hi = the value with its
// 13 low mantissa bits masked: one logic op, where a cvt.rna costs several),
// and the next k step's fragments load while this step's products run. The
// products go in three passes over the warp's tiles, so no mma waits on the
// one before it. The x tile's rows are padded by 16 bytes and w's by 32, so
// the fragment reads (x: 8 rows x 4 words; w: 4 rows x 8 words) hit 32
// distinct banks. FFN2 (n = 512) gets 256 CTAs, FFN1 1024. Timed against
// 4 warps of 64 x 32, 128 x 128 tiles of 4 or 8 warps, 2-4 stages 32 deep
// and a persistent grid, this form was the fastest at both FFN shapes.
// wgmma (whose TF32 form reads a k-major B from shared memory, and w is
// n-major) and TMA are later work.
//
// Plain C interface, loaded with ctypes (ops/gemm_epilogue.py). The
// launcher enqueues on the caller's stream, does not synchronize, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

using tf32::from_f32;
using tf32::to_f32;

// The tile: a CTA of 8 warps (4 x 2) owns 128 x 64 outputs, each warp
// 32 x 32 as 2 x 4 mma tiles; two stages of k depth 64; two CTAs a SM.
constexpr int kWarpsM = 4, kWarpsN = 2;
constexpr int kMT = 2, kNT = 4;  // a warp's mma tiles (16 x 8 each)
constexpr int kThreads = 32 * kWarpsM * kWarpsN;
constexpr int kWM = 16 * kMT, kWN = 8 * kNT;
constexpr int kBM = kWM * kWarpsM, kBN = kWN * kWarpsN;
constexpr int kBK = 64;  // k depth of a stage
constexpr int kStages = 2;
constexpr int kMinBlocks = 2;  // CTAs a SM

// The shared-memory layout for operand type T: row strides padded so the
// fragment reads hit distinct banks, and the bytes of all stages.
template <typename T> struct Smem {
  static constexpr int kLdA = kBK + 16 / sizeof(T);  // row strides (elements)
  static constexpr int kLdB = kBN + 32 / sizeof(T);
  static constexpr int kStage = kBM * kLdA + kBK * kLdB;  // elements a stage
  static constexpr size_t kBytes = (size_t)kStages * kStage * sizeof(T);
  static_assert(kMinBlocks * (kBytes + 1024) <= 233472, "two CTAs must fit a SM");
};

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kTanh = 3, kSigmoid = 4 };

__device__ __forceinline__ float act_f32(int act, float z) {
  switch (act) {
    case kRelu: return fmaxf(z, 0.0f);
    case kGelu: return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
    case kTanh: return tanhf(z);
    case kSigmoid: return 1.0f / (1.0f + expf(-z));
    default: return z;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// One k step's fragments of a warp: A (x rows) and B (w columns), hi and lo.
struct Frags {
  uint32_t ah[kMT][4], al[kMT][4], bh[kNT][2], bl[kNT][2];
};

// The fragments of k columns [kk, kk + 8) of a stage: a is the warp's first
// x row in shared memory, b its first w column. f32 A fragments come by
// ldmatrix (8 x 4-word matrices: lane l names row (l & 7) + 8 ((l >> 3) & 1)
// and word column 4 (l >> 4), and receives (g, t) of each), bf16 ones and
// every B fragment as single elements.
template <typename T>
__device__ __forceinline__ void load_frags(Frags& f, const T* a, const T* b, int kk) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int LDA = Smem<T>::kLdA, LDB = Smem<T>::kLdB;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      tf32::split<kSplit>(to_f32(b[(kk + t + 4 * i) * LDB + j * 8 + g]), f.bh[j][i], f.bl[j][i]);
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    if constexpr (sizeof(T) == 4) {
      uint32_t r[4];
      tf32::ldmatrix_x4(r, a + (i * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDA + kk +
                         (lane >> 4) * 4);
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split<kSplit>(__uint_as_float(r[e]), f.ah[i][e], f.al[i][e]);
    } else {
      const T* ar = a + (i * 16 + g) * LDA + kk + t;
      tf32::split<kSplit>(to_f32(ar[0]), f.ah[i][0], f.al[i][0]);
      tf32::split<kSplit>(to_f32(ar[8 * LDA]), f.ah[i][1], f.al[i][1]);
      tf32::split<kSplit>(to_f32(ar[4]), f.ah[i][2], f.al[i][2]);
      tf32::split<kSplit>(to_f32(ar[8 * LDA + 4]), f.ah[i][3], f.al[i][3]);
    }
  }
}

// Stage one [ROWS x COLS] tile of a row-major [R x C] matrix whose top-left
// element is (r0, c0) into smem with row stride `ld`. A 16-byte chunk wholly
// in range and 16-byte aligned in global memory goes through cp.async (a
// row past R as a zero fill); the rest of the ragged edge and misaligned
// rows load element by element, zero past the edge.
// `inside`: the tile lies wholly in range and every row is 16-byte aligned,
// so every chunk goes straight to cp.async (the common case, decided once
// for the CTA and the stage).
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* smem, int ld, const T* g, int R, int C, int r0,
                                          int c0, int tid, bool inside) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = ROWS * COLS / kVec;
  static_assert(kChunks % kThreads == 0, "a tile is whole chunks for every thread");
  if (inside) {
#pragma unroll
    for (int ch = tid; ch < kChunks; ch += kThreads) {
      const int r = ch / (COLS / kVec), c = (ch % (COLS / kVec)) * kVec;
      cp_async16(smem + r * ld + c, g + (int64_t)(r0 + r) * C + c0 + c, true);
    }
    return;
  }
#pragma unroll
  for (int ch = tid; ch < kChunks; ch += kThreads) {
    const int r = ch / (COLS / kVec);
    const int c = (ch % (COLS / kVec)) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    T* dst = smem + r * ld + c;
    const T* src = g + (int64_t)gr * C + gc;
    if (gr >= R) {
      cp_async16(dst, g, false);
    } else if (gc + kVec <= C && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(dst, src, true);
    } else {
      for (int e = 0; e < kVec; ++e) dst[e] = gc + e < C ? src[e] : from_f32<T>(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_bias_act_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const float* __restrict__ bias, T* __restrict__ z, T* __restrict__ y,
                     int m, int n, int k, int act, bool aligned) {
  constexpr int kLdA = Smem<T>::kLdA, kLdB = Smem<T>::kLdB, kStage = Smem<T>::kStage;
  constexpr bool kSplit = tf32::needs_split<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm0 = (warp / kWarpsN) * kWM, wn0 = (warp % kWarpsN) * kWN;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int nk = (k + kBK - 1) / kBK;

  auto stage_a = [&](int s) { return smem + s * kStage; };
  auto stage_b = [&](int s) { return smem + s * kStage + kBM * kLdA; };
  const bool rows_inside = aligned && m0 + kBM <= m && n0 + kBN <= n;
  auto load_stage = [&](int s, int kt) {
    const bool inside = rows_inside && (kt + 1) * kBK <= k;
    load_tile<T, kBM, kBK>(stage_a(s), kLdA, x, m, k, m0, kt * kBK, tid, inside);
    load_tile<T, kBK, kBN>(stage_b(s), kLdB, w, k, n, kt * kBK, n0, tid, inside);
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int i = 0; i < kMT; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // tile kt has landed (this thread's copies)
    __syncthreads();               // everyone's copies, and stage kt-1 is free
    if (kt + kStages - 1 < nk) load_stage((kt + kStages - 1) % kStages, kt + kStages - 1);
    cp_async_commit();  // possibly empty: keeps the group count in step
    const T* a = stage_a(kt % kStages) + wm0 * kLdA;
    const T* b = stage_b(kt % kStages) + wn0;
    // the stage's products sum in the tensor core from 0 (its f32 sums
    // truncate), then join acc through one rounded f32 add
    float part[kMT][kNT][4];
    // the next k step's fragments load while this step's products run
    Frags f[2];
    load_frags<T>(f[0], a, b, 0);
#pragma unroll
    for (int s = 0; s < kBK / 8; ++s) {
      if (s + 1 < kBK / 8) load_frags<T>(f[(s + 1) & 1], a, b, 8 * (s + 1));
      const Frags& c = f[s & 1];
      if (s == 0) tf32::mma_tiles<kSplit, kMT, kNT, true>(part, c.ah, c.al, c.bh, c.bl);
      else tf32::mma_tiles<kSplit>(part, c.ah, c.al, c.bh, c.bl);
    }
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }
  cp_async_wait<0>();  // no copy may still be in flight when the CTA exits

  // each thread holds column pairs (c, c + 1): one 2-element store where
  // both are in range and n is even (the pair is then aligned)
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int c = n0 + wn0 + j * 8 + 2 * t;
    if (c >= n) continue;
    const bool pair = c + 1 < n && (n & 1) == 0;
    const float b0 = bias[c], b1 = c + 1 < n ? bias[c + 1] : 0.0f;
#pragma unroll
    for (int i = 0; i < kMT; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m0 + wm0 + i * 16 + g + 8 * h;
        if (r >= m) continue;
        const float z0 = acc[i][j][2 * h] + b0, z1 = acc[i][j][2 * h + 1] + b1;
        const int64_t o = (int64_t)r * n + c;
        if (pair) {
          store2(z + o, z0, z1);
          if (act != kNone) store2(y + o, act_f32(act, z0), act_f32(act, z1));
        } else {
          z[o] = from_f32<T>(z0);
          if (act != kNone) y[o] = from_f32<T>(act_f32(act, z0));
          if (c + 1 < n) {
            z[o + 1] = from_f32<T>(z1);
            if (act != kNone) y[o + 1] = from_f32<T>(act_f32(act, z1));
          }
        }
      }
    }
  }
}

// Opts the kernel into its dynamic shared memory at every launch: the
// attribute is per device, and the call is cheap.
template <typename T>
cudaError_t launch_typed(const void* xv, const void* wv, const float* bias, void* zv, void* yv,
                         int m, int n, int k, int act, cudaStream_t st) {
  const T* x = static_cast<const T*>(xv);
  const T* w = static_cast<const T*>(wv);
  constexpr size_t bytes = Smem<T>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(gemm_bias_act_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  // every row of x and w starts on 16 bytes: the in-range tiles need no checks
  const bool aligned = ((uintptr_t)x & 15) == 0 && ((uintptr_t)w & 15) == 0 &&
                       (k * sizeof(T)) % 16 == 0 && (n * sizeof(T)) % 16 == 0;
  gemm_bias_act_kernel<T><<<grid, kThreads, bytes, st>>>(x, w, bias, static_cast<T*>(zv),
                                                         static_cast<T*>(yv), m, n, k, act,
                                                         aligned);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. act: 0 none, 1 relu, 2 gelu, 3 tanh, 4 sigmoid.
int gemm_bias_act(const void* x, const void* w, const float* bias, void* z, void* y,
                  int m, int n, int k, int dtype, int act, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || act < kNone || act > kSigmoid)
    return (int)cudaErrorInvalidValue;
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
