// Quantized GEMM + dequant scale + bias + activation for Hopper (sm_90a).
//
// Replaces the Pallas kernel of paddle_tpu/ops/pallas_kernels.py:
//   quant_gemm_bias_act -> _quant_gemm_kernel (both of its operand forms)
//
// Contract: z = (x @ w) * scale + bias, y = act(z) for act in {relu, gelu
// (erf form), tanh, sigmoid}, out f32. x is [m, k], w is [k, n], both
// row-major and one byte an element:
//   int8  x int8 -> exact i32 sums, converted to f32 with __int2float_rn;
//   e4m3  x e4m3 -> f32 sums.
// scale is ONE f32 on the device (the combined per-tensor dequant factor
// x_scale * w_scale, which the caller computes on the card: no host sync),
// bias is [n] f32. The epilogue is written __fmul_rn / __fadd_rn, so nvcc
// cannot contract it into an FMA: the int8 result then equals the plain
// torch form acc.float() * scale + bias bit for bit.
//
// Bound: operations at the serving path's shapes (m 256 or 1024, k = n =
// 2048): 2mnk operations on (mk + kn) bytes in and 4mn bytes out, against
// the card's dense int8 / fp8 tensor-core rate of 1979 TOP/s. Design: a
// simple tensor-core tile GEMM. A 128-thread CTA owns a 64 x 64 output tile
// and four warps 32 x 32 each; k advances 64 bytes a tile. The next tile's
// global loads go to registers while the current tile is multiplied out of
// shared memory (one buffer, a register prefetch). x rows are copied as
// 16-byte vectors; w is stored transposed in shared memory (n-major, k
// contiguous), because the 8-bit mma takes B in column order: each thread
// reads a 4 x 4 byte block of w as four 32-bit words and transposes it with
// __byte_perm. Row strides are padded to 80 bytes, so the fragment loads
// hit 32 distinct banks.
//   int8: mma.sync m16n8k32 s8.s8 -> s32, exact;
//   e4m3: each 32-bit fragment register of four e4m3 values converts
//         exactly to two f16x2 registers (cvt.rn.f16x2.e4m3x2: every e4m3
//         value is an f16 value), and two mma.sync m16n8k16 f16 -> f32
//         products take the place of one 8-bit one. The k order inside a
//         fragment is permuted the same way in A and B, so the sum is the
//         same sum. Products are exact in f32.
// wgmma with s8 / e4m3 operands, TMA and a deeper pipeline are later work.
//
// Plain C interface, loaded with ctypes (ops/quant_gemm.py). The launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 64;         // bytes = k values per tile
constexpr int kLd = kBK + 16;   // shared row stride in bytes (20 words)
constexpr int kThreads = 128;   // 4 warps, 2 x 2, each 32 x 32 outputs

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kTanh = 3, kSigmoid = 4 };

template <int ACT> __device__ __forceinline__ float act_f32(float z) {
  if (ACT == kRelu) return fmaxf(z, 0.0f);
  if (ACT == kGelu) return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
  if (ACT == kTanh) return tanhf(z);
  if (ACT == kSigmoid) return 1.0f / (1.0f + expf(-z));
  return z;
}

__device__ __forceinline__ float acc_f32(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_f32(float v) { return v; }

// The next k tile of x and w, held in registers.
struct Prefetch {
  int4 a[2];          // x: 2 of the tile's 256 16-byte row chunks
  uint32_t b[2][4];   // w: 2 of its 256 4 x 4 byte blocks, one word per k row
};

__device__ __forceinline__ void load_tiles(Prefetch& pf, const uint8_t* __restrict__ x,
                                           const uint8_t* __restrict__ w, int M, int N,
                                           int K, int m0, int n0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 2, c = (idx & 3) * 16;
    const int gm = m0 + r, gk = k0 + c;
    pf.a[i] = (gm < M && gk < K)
                  ? *reinterpret_cast<const int4*>(x + (size_t)gm * K + gk)
                  : make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int kb = idx >> 4, nb = idx & 15;
    const int gk = k0 + kb * 4, gn = n0 + nb * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      pf.b[i][j] = (gk + j < K && gn < N)
                       ? *reinterpret_cast<const uint32_t*>(w + (size_t)(gk + j) * N + gn)
                       : 0u;
  }
}

__device__ __forceinline__ void store_tiles(const Prefetch& pf, uint8_t* As, uint8_t* Bs,
                                            int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 2, c = (idx & 3) * 16;
    *reinterpret_cast<int4*>(As + r * kLd + c) = pf.a[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int kb = idx >> 4, nb = idx & 15;
    const uint32_t* r = pf.b[i];
    // 4 x 4 byte transpose: word j of the block (k row j, n bytes 0..3)
    // becomes byte j of the words for n = 0..3
    const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
    const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
    const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
    const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
    const uint32_t c[4] = {__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                           __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632)};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(Bs + (nb * 4 + j) * kLd + kb * 4) = c[j];
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_f16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// two e4m3 values (low byte first) -> f16x2 (low half first), exact
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t out;
  const unsigned short h = (unsigned short)(v & 0xffffu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(out) : "h"(h));
  return out;
}

template <bool FP8, int ACT>
__global__ void __launch_bounds__(kThreads)
    quant_gemm_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ z, float* __restrict__ y, int M, int N, int K) {
  using Acc = typename std::conditional<FP8, float, int>::type;
  __shared__ __align__(16) uint8_t As[kBM * kLd];
  __shared__ __align__(16) uint8_t Bs[kBN * kLd];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  Acc acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = Acc(0);

  Prefetch pf;
  load_tiles(pf, x, w, M, N, K, m0, n0, 0, tid);
  for (int k0 = 0; k0 < K; k0 += kBK) {
    __syncthreads();
    store_tiles(pf, As, Bs, tid);
    __syncthreads();
    if (k0 + kBK < K) load_tiles(pf, x, w, M, N, K, m0, n0, k0 + kBK, tid);
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      // 8-bit fragments of m16n8k32: A rows g / g + 8, k bytes 4t..4t+3 and
      // 16+4t..; B column g, the same k bytes
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const uint8_t* p = As + (wm + mi * 16 + g) * kLd + kk + 4 * t;
        a[mi][0] = lds32(p);
        a[mi][1] = lds32(p + 8 * kLd);
        a[mi][2] = lds32(p + 16);
        a[mi][3] = lds32(p + 8 * kLd + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const uint8_t* p = Bs + (wn + ni * 8 + g) * kLd + kk + 4 * t;
        b[ni][0] = lds32(p);
        b[ni][1] = lds32(p + 16);
      }
      if constexpr (!FP8) {
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
      } else {
        // each 8-bit register -> (low pair, high pair) of f16x2; the first
        // m16n8k16 takes k bytes 4t..4t+3, the second 16+4t..16+4t+3
        uint32_t ah[2][8], bh[4][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            ah[mi][2 * r] = e4m3x2_to_f16x2(a[mi][r]);
            ah[mi][2 * r + 1] = e4m3x2_to_f16x2(a[mi][r] >> 16);
          }
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bh[ni][2 * r] = e4m3x2_to_f16x2(b[ni][r]);
            bh[ni][2 * r + 1] = e4m3x2_to_f16x2(b[ni][r] >> 16);
          }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) {
            // registers 0 / 1: rows g / g + 8 at k bytes 4t..; 2 / 3 at 16+4t..
            mma_f16(acc[mi][ni], ah[mi][0], ah[mi][2], ah[mi][1], ah[mi][3], bh[ni][0],
                    bh[ni][1]);
            mma_f16(acc[mi][ni], ah[mi][4], ah[mi][6], ah[mi][5], ah[mi][7], bh[ni][2],
                    bh[ni][3]);
          }
      }
    }
  }

  const float s = *scale;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = m0 + wm + mi * 16 + g + (e >> 1) * 8;
        const int col = n0 + wn + ni * 8 + 2 * t + (e & 1);
        if (row < M && col < N) {
          const float v = __fadd_rn(__fmul_rn(acc_f32(acc[mi][ni][e]), s), bias[col]);
          z[(size_t)row * N + col] = v;
          if (ACT != kNone) y[(size_t)row * N + col] = act_f32<ACT>(v);
        }
      }
}

template <bool FP8>
cudaError_t launch(const uint8_t* x, const uint8_t* w, const float* scale, const float* bias,
                   float* z, float* y, int m, int n, int k, int act, cudaStream_t st) {
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  switch (act) {
    case kNone:
      quant_gemm_kernel<FP8, kNone><<<grid, kThreads, 0, st>>>(x, w, scale, bias, z, y, m, n, k);
      break;
    case kRelu:
      quant_gemm_kernel<FP8, kRelu><<<grid, kThreads, 0, st>>>(x, w, scale, bias, z, y, m, n, k);
      break;
    case kGelu:
      quant_gemm_kernel<FP8, kGelu><<<grid, kThreads, 0, st>>>(x, w, scale, bias, z, y, m, n, k);
      break;
    case kTanh:
      quant_gemm_kernel<FP8, kTanh><<<grid, kThreads, 0, st>>>(x, w, scale, bias, z, y, m, n, k);
      break;
    case kSigmoid:
      quant_gemm_kernel<FP8, kSigmoid><<<grid, kThreads, 0, st>>>(x, w, scale, bias, z, y, m,
                                                                  n, k);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// fp8: 0 int8 x int8, 1 e4m3 x e4m3. act: 0 none, 1 relu, 2 gelu, 3 tanh,
// 4 sigmoid. k and n multiples of 16, x and w 16-byte aligned (the wrapper
// checks); any m.
int quant_gemm_bias_act(const void* x, const void* w, const float* scale, const float* bias,
                        float* z, float* y, int m, int n, int k, int fp8, int act,
                        void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || k % 16 || n % 16) return (int)cudaErrorInvalidValue;
  if (act != kNone && y == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xp = static_cast<const uint8_t*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  cudaError_t err = fp8 ? launch<true>(xp, wp, scale, bias, z, y, m, n, k, act, st)
                        : launch<false>(xp, wp, scale, bias, z, y, m, n, k, act, st);
  return (int)err;
}

const char* quant_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
