// fp8_matmul for Hopper (sm_90a): the forward and both gradient forms in one
// kernel family, the e4m3 cast done in the GEMM's producer.
//
// Replaces paddle_tpu/ops/pallas_kernels.py fp8_matmul (no pallas_call of its
// own: FLAGS_fp8_matmul's dtype policy, whose product XLA tiles) and the
// gradient jax.vjp gives it:
//   forward  out = e4m3(x) @ e4m3(y)             f32 sums, x's dtype out
//   dx       dx  = e4m3(g @ e4m3(y)^T)           summed over what x is broadcast over
//   dy       dy  = e4m3(e4m3(x)^T @ g)           summed over what y is broadcast over
// e4m3 is float8_e4m3fn rounded to nearest even, with |v| past 464 (what
// rounds past the largest finite value, 448), inf and NaN giving NaN, as
// ml_dtypes / XLA convert round (ops/quant_gemm.py e4m3_round_plain; its
// integer twin e4m3_round_twin states the rule bit by bit).
//
// Bound: the forward at the bf16 Transformer's commonest product, (4096,
// 512) @ (512, 512) bf16, moves 8.91 MB (each operand read once, the result
// written once: 0.0027 ms at 3.35 TB/s) and does 2mnk = 2.1 GFLOP, 0.0022 ms
// at the 16-bit tensor-core rate of 989 TFLOP/s, the rate at which f32 sums
// of e4m3 products are exact (wgmma's own e4m3 form keeps about 13 bits in
// its sums: quant_gemm.cu's note). The gradients at the vocab product,
// (4096, 512) @ (512, 37000): 155 GFLOP each, 0.157 ms at 989 TFLOP/s.
//
// Design: wgmma, warp-specialised, a CTA of 384 threads over a 128 x 128
// output tile and a ring of kStages stages of 64 reduction values, each
// with a full / empty mbarrier pair.
//   - Warpgroup 0, the producer, reads both operands in their own dtype
//     (f32 or bf16) with 16-byte vector loads where a row's start is
//     16-byte aligned (f32: a row of a multiple of 4 values, bf16: of 8)
//     and element loads at ragged strides and edges (zeros past them), the
//     next slices' loads in flight in registers while one is rounded and
//     stored. It rounds each value to e4m3 (cvt.rn.satfinite.e4m3x2.f32
//     after a select that turns |v| > 464 and NaN into NaN: satfinite alone
//     gives +-448), widens it to a 16-bit type (exact: every e4m3 value is
//     an f16 and a bf16 value; f16 in the forward, bf16 beside g in the
//     gradients) and stores it into the stage's tile in the 128-byte
//     swizzle. An operand whose reduction dimension is contiguous is stored
//     K-major (rows of 64 values); one whose output dimension is contiguous
//     (y in the forward, x and g in dy) is stored MN-major (atoms of 64
//     output values x 64 reduction rows), which wgmma reads through its
//     transpose bit: no byte transpose, no staging buffer in device
//     memory. The producer's instruction issue bounds the kernel (on an
//     H100, with no loads and no wgmma it still took 0.026 of its 0.031 ms
//     at (4096, 512) @ (512, 512)); each other form measured there was
//     slower: a cp.async ring of raw tiles rounded from shared memory (2x),
//     the rounding in FP32 magic-number steps (1.3x: more instructions than
//     cvt's), two producer warpgroups (the 128-register cap of 512 threads
//     spills the gradient forms). For the same reason no operand comes by
//     TMA: it would stage raw tiles in shared memory beside the rounded
//     ring (32 KB an f32 operand a stage) to speed up loads that are not
//     the limit.
//   - Warpgroups 1 and 2, the consumers, 64 output rows each, issue four
//     m64n128k16 wgmma a stage, .f32.f16.f16 in the forward, .f32.bf16.bf16
//     in the gradients (g stays bf16: its products with e4m3 values are
//     exact, the sums f32). The sums stay in the wgmma registers over the
//     whole reduction, one stage's group in flight while the next issues
//     (within the forward's f32 bar at k = 4095 on an H100; each stage
//     summed from 0 and added in f32 took 2x the time).
//   - The reduction may run over a batch of matrices as well as over k: the
//     gradient of an operand shared by a batch (dy of y broadcast over x's
//     batch: batch x m) is summed before its one rounding, as jax.vjp does.
//     Where the output has too few tiles to fill the card (dy of a weight:
//     16 tiles at 512 x 512), the reduction is split over `splits` CTAs a
//     tile, each writing its f32 sums to a workspace that split_sum_kernel
//     adds in order (then rounds and converts): two launches, one form.
//   - The epilogue stages each consumer's tile in shared memory and writes
//     it as 16- or 8-byte rows where they are aligned and in range, element
//     by element at a ragged edge; the gradients round it to e4m3 first.
// e4m3_round_kernel: the rounding alone, elementwise, dtype in = dtype out,
// for the gradients of f32 models (g in f32 is not exact in bf16: their
// products are f32 library matmuls, as XLA's dots are in the JAX package).
//
// Plain C interface, loaded with ctypes (ops/quant_gemm.py). The launchers
// enqueue on the caller's stream, do not synchronize, allocate nothing (the
// split workspace is the caller's), and return cudaGetLastError()
// (cudaErrorInvalidValue for a problem they do not take).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

// The launch's problem, shared with the host (ops/quant_gemm.py's ctypes
// structures), outside the anonymous namespace: the C entry point that takes
// it keeps external linkage.
//
// One operand as a row-major view [rows, cols] (leading dimension ld) a
// matrix: matrix (z, r) of the batch starts at p + z * sz + r * sr (z the
// output's batch index, r the reduced batch's); vec: every row start is
// 16-byte aligned
struct Operand {
  const void* p;
  long long sz, sr, ld;
  int rows, cols, vec, pad_;
};

// out [batch, rows, cols] (row stride ldo, batch stride so) = the sum over
// nr reduced matrices and kt_per stages of 64 reduction values each; with
// splits > 1, split s of the stages writes f32 sums to ws [batch, splits,
// rows, cols]
struct Problem {
  Operand a, b;
  void* out;
  void* ws;
  long long so, ldo;
  int rows, cols, ovec, batch, nr, kt_per, splits, pad_;
};

namespace {

constexpr int kBM = 128;        // output rows a CTA: two consumer warpgroups of 64
constexpr int kBN = 128;        // output columns a CTA
constexpr int kBK = 64;         // reduction values a stage: a 128-byte row of 16-bit values
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kTile = kBM * kBK * 2;  // bytes of a stage's A (or B) tile
constexpr int kAtom = 64 * kBK * 2;   // an MN-major atom: 64 output values x 64 rows

enum Form { kFwd = 0, kDx = 1, kDy = 2 };

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// wgmma operand descriptors, 128-byte swizzle (16-byte unit c of a 128-byte
// row r stored at unit c ^ (r & 7), 8-row groups 1024 bytes apart):
// K-major, rows of 64 reduction values (the leading offset is unused);
// MN-major, atoms of 64 output values x 64 reduction rows 8 KB apart (the
// leading offset: from one 64-value block of the output dimension to the
// next), 8-row groups of the reduction 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(kAtom >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}
// a k16 step within a stage, in the descriptor's 16-byte units: 32 bytes
// along a K-major row, 16 rows (2048 bytes) of an MN-major atom
template <bool MN> __device__ __forceinline__ uint64_t k16_step() { return MN ? 128 : 2; }

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// m64 x n128 x k16 with f32 sums, f16 or bf16 operands; TA / TB 1: that
// operand MN-major
template <int TA, int TB>
__device__ __forceinline__ void wgmma_f16_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}


template <int TA, int TB>
__device__ __forceinline__ void wgmma_bf16_n128(float (&d)[64], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB));
}


template <bool F16, int TA, int TB>
__device__ __forceinline__ void mma16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  if constexpr (F16) wgmma_f16_n128<TA, TB>(d, a, b, scale_d);
  else wgmma_bf16_n128<TA, TB>(d, a, b, scale_d);
}

// ---------------------------------------------------------------- rounding

// |v| past 464, inf and NaN to NaN; the rest as it is
__device__ __forceinline__ float nan_past(float v) {
  return fabsf(v) <= 464.0f ? v : __uint_as_float(0x7fffffffu);
}
// two values rounded to e4m3, as f16x2 (lo in the low half)
__device__ __forceinline__ __half2_raw e4m3_pair(float lo, float hi) {
  const __nv_fp8x2_storage_t q =
      __nv_cvt_float2_to_fp8x2(make_float2(nan_past(lo), nan_past(hi)), __NV_SATFINITE, __NV_E4M3);
  return __nv_cvt_fp8x2_to_halfraw2(q, __NV_E4M3);
}
__device__ __forceinline__ uint32_t bits(__half2_raw h) {
  return (uint32_t)h.x | ((uint32_t)h.y << 16);
}
__device__ __forceinline__ float2 e4m3_pair_f32(float lo, float hi) {
  return __half22float2(__half2(e4m3_pair(lo, hi)));
}
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// ---------------------------------------------------------------- producer

// what the producer does with an operand's values
enum Mode { kRoundF16 = 0, kRoundBf16 = 1, kCopy = 2 };

// a unit: 8 consecutive values of a row, as loaded (f32: two 16-byte words,
// bf16: one)
template <typename T> __host__ __device__ constexpr int words() {
  return sizeof(T) == 4 ? 2 : 1;
}

// values gc .. gc + 7 of row gr of a [rows, cols] view, zeros past its edges
template <typename T>
__device__ __forceinline__ void load_unit(uint4* dst, const T* __restrict__ m, long long ld,
                                          int rows, int cols, int gr, int gc, int vec) {
  constexpr int W = words<T>();
  if (gr < rows && gc + 8 <= cols && vec) {
    const uint4* src = reinterpret_cast<const uint4*>(m + gr * ld + gc);
#pragma unroll
    for (int w = 0; w < W; ++w) dst[w] = __ldg(src + w);
    return;
  }
  uint32_t e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = 0u;
    if (gr < rows && gc + j < cols) {
      if constexpr (sizeof(T) == 4)
        e[j] = __ldg(reinterpret_cast<const unsigned int*>(m + gr * ld + gc + j));
      else
        e[j] = __ldg(reinterpret_cast<const unsigned short*>(m + gr * ld + gc + j));
    }
  }
  if constexpr (sizeof(T) == 4) {
    dst[0] = make_uint4(e[0], e[1], e[2], e[3]);
    dst[1] = make_uint4(e[4], e[5], e[6], e[7]);
  } else {
    dst[0] = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16), e[4] | (e[5] << 16),
                        e[6] | (e[7] << 16));
  }
}

// value j of a loaded unit as f32 (exact)
template <typename T> __device__ __forceinline__ float value(const uint4* u, int j) {
  if constexpr (sizeof(T) == 4) {
    const uint4 w = u[j >> 2];
    const uint32_t x = (j & 3) == 0 ? w.x : (j & 3) == 1 ? w.y : (j & 3) == 2 ? w.z : w.w;
    return __uint_as_float(x);
  } else {
    const uint4 w = u[0];
    const uint32_t x = (j >> 1) == 0 ? w.x : (j >> 1) == 1 ? w.y : (j >> 1) == 2 ? w.z : w.w;
    return __uint_as_float((j & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// a loaded unit as the 8 16-bit values the tile holds
template <typename T, int MODE> __device__ __forceinline__ uint4 to16(const uint4* u) {
  if constexpr (MODE == kCopy) {
    static_assert(sizeof(T) == 2, "only bf16 operands are copied");
    return u[0];
  } else {
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = value<T>(u, 2 * i), hi = value<T>(u, 2 * i + 1);
      if constexpr (MODE == kRoundF16) {
        o[i] = bits(e4m3_pair(lo, hi));
      } else {
        const float2 r = e4m3_pair_f32(lo, hi);
        o[i] = bf16_pair(r.x, r.y);  // exact
      }
    }
    return make_uint4(o[0], o[1], o[2], o[3]);
  }
}

// where unit u (of 8 values) of a stage's operand tile lives: its row and
// first column in the operand's [rows, cols] view (offset by the tile's
// origin), and its byte offset in the swizzled tile. K-major: tile rows are
// output rows (128 of them), 8 units a row; MN-major: tile rows are the
// stage's 64 reduction rows, 16 units a row, in atoms of 64 columns.
template <bool MN> __device__ __forceinline__ void unit_at(int u, int& r, int& c, int& off) {
  if constexpr (!MN) {
    r = u >> 3;
    const int cu = u & 7;
    c = 8 * cu;
    off = r * 128 + ((cu ^ (r & 7)) << 4);
  } else {
    r = u >> 4;
    const int cu = u & 15;
    c = 8 * cu;
    off = (cu >> 3) * kAtom + r * 128 + (((cu & 7) ^ (r & 7)) << 4);
  }
}

// a register slice: 4 units a thread (half a tile's 1024)
template <int W> struct Slice {
  uint4 r[4 * W];
};

template <typename T, bool MN, int W>
__device__ __forceinline__ void load_slice(Slice<W>& s, const Operand& o, int z, int rr, int mn0,
                                           int k0, int half, int tid) {
  const T* m = static_cast<const T*>(o.p) + z * o.sz + rr * o.sr;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c, off;
    unit_at<MN>(half * 512 + tid + 128 * i, r, c, off);
    if constexpr (!MN)
      load_unit<T>(&s.r[i * W], m, o.ld, o.rows, o.cols, mn0 + r, k0 + c, o.vec);
    else
      load_unit<T>(&s.r[i * W], m, o.ld, o.rows, o.cols, k0 + r, mn0 + c, o.vec);
  }
}

template <typename T, int MODE, bool MN, int W>
__device__ __forceinline__ void store_slice(uint8_t* tile, const Slice<W>& s, int half, int tid) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r, c, off;
    unit_at<MN>(half * 512 + tid + 128 * i, r, c, off);
    *reinterpret_cast<uint4*>(tile + off) = to16<T, MODE>(&s.r[i * W]);
  }
}

// ---------------------------------------------------------------- the form

template <int FORM> struct FormTraits;
template <> struct FormTraits<kFwd> {  // x K-major, y MN-major, both rounded; f16
  static constexpr bool F16 = true, MN_A = false, MN_B = true, ROUND_OUT = false;
  static constexpr int MODE_A = kRoundF16, MODE_B = kRoundF16;
};
template <> struct FormTraits<kDx> {  // g K-major as it is, y K-major rounded; bf16
  static constexpr bool F16 = false, MN_A = false, MN_B = false, ROUND_OUT = true;
  static constexpr int MODE_A = kCopy, MODE_B = kRoundBf16;
};
template <> struct FormTraits<kDy> {  // x MN-major rounded, g MN-major as it is; bf16
  static constexpr bool F16 = false, MN_A = true, MN_B = true, ROUND_OUT = true;
  static constexpr int MODE_A = kRoundBf16, MODE_B = kCopy;
};

constexpr int kLdc = kBN + 8;  // the staged tile's row stride (floats)
constexpr size_t smem_bytes() {
  return 1024 + (size_t)kStages * 2 * kTile + (size_t)2 * 64 * kLdc * 4 + (size_t)2 * kStages * 8;
}
static_assert(smem_bytes() <= 232448, "fp8 GEMM ring too large");

// e4m3 rounding of f32 values (the gradients' epilogue)
__device__ __forceinline__ void round4(float (&v)[4]) {
  const float2 lo = e4m3_pair_f32(v[0], v[1]), hi = e4m3_pair_f32(v[2], v[3]);
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}
template <typename TO> __device__ __forceinline__ void store4(TO* dst, const float (&v)[4],
                                                              bool full, int n) {
  if constexpr (sizeof(TO) == 4) {
    if (full) {
      __stcs(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) dst[e] = v[e];
    }
  } else {
    if (full) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]));
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) dst[e] = __float2bfloat16_rn(v[e]);
    }
  }
}

template <int FORM, typename T, typename TO>
__global__ void __launch_bounds__(kThreads, 1) fp8_gemm_kernel(const Problem p) {
  using F = FormTraits<FORM>;
  constexpr int W = words<T>();
  constexpr int S = kStages;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* as = base;                                  // S A tiles
  uint8_t* bs = base + S * kTile;                      // S B tiles
  float* cs = reinterpret_cast<float*>(bs + S * kTile);  // two [64][kLdc]
  uint64_t* full = reinterpret_cast<uint64_t*>(cs + 2 * 64 * kLdc);
  uint64_t* empty = full + S;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int z = blockIdx.z / p.splits, split = blockIdx.z - z * p.splits;
  const int total = p.nr * p.kt_per;  // stages of the whole reduction
  const int per = (total + p.splits - 1) / p.splits;
  const int st0 = split * per, st1 = min(total, st0 + per);  // this CTA's stages
  const int n = st1 - st0;
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);  // the producer's threads
      mbar_init(&empty[s], 8);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // the producer: kSlices register slices in turn (a stage is A's two
    // halves, then B's), the loads of the next kSlices - 1 in flight while
    // one is rounded and stored
    constexpr int kSlices = W == 2 ? 3 : 4;
    Slice<W> sl[kSlices];
    const int n_slices = n * 4;
    auto fetch = [&](Slice<W>& s, int g) {
      const int i = g >> 2, j = g & 3;
      const int st = st0 + i, rr = st / p.kt_per, k0 = (st - rr * p.kt_per) * kBK;
      if (j < 2)
        load_slice<T, F::MN_A, W>(s, p.a, z, rr, m0, k0, j, tid);
      else
        load_slice<T, F::MN_B, W>(s, p.b, z, rr, n0, k0, j - 2, tid);
    };
    auto put = [&](const Slice<W>& s, int g) {
      const int i = g >> 2, j = g & 3, slot = i % S;
      if (j == 0) mbar_wait(&empty[slot], ((i / S) & 1) ^ 1);
      if (j < 2)
        store_slice<T, F::MODE_A, F::MN_A, W>(as + slot * kTile, s, j, tid);
      else
        store_slice<T, F::MODE_B, F::MN_B, W>(bs + slot * kTile, s, j - 2, tid);
      if (j == 3) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmma's reads
        mbar_arrive(&full[slot]);
      }
    };
#pragma unroll
    for (int u = 0; u + 1 < kSlices; ++u)
      if (u < n_slices) fetch(sl[u], u);
    for (int g = 0; g < n_slices; g += kSlices) {
      // unrolled, so every slice index is a constant and the slices stay in
      // registers
#pragma unroll
      for (int u = 0; u < kSlices; ++u) {
        if (g + u >= n_slices) break;
        const int ahead = g + u + kSlices - 1;
        if (ahead < n_slices) fetch(sl[(u + kSlices - 1) % kSlices], ahead);
        put(sl[u], g + u);
      }
    }
    return;
  }

  // consumers: 64 rows each, every column of the tile. The sums stay in the
  // wgmma registers; the first product overwrites them (scale-d 0), so no
  // other instruction defines acc. One stage's group stays in flight while
  // the next issues; stage i - 1 is released once it is done.
  const int c = wg - 1, t = tid & 127;
  constexpr int TA_ = F::MN_A ? 1 : 0, TB_ = F::MN_B ? 1 : 0;
  float acc[kBN / 2];
  for (int i = 0; i < n; ++i) {
    const int slot = i % S;
    mbar_wait(&full[slot], (i / S) & 1);
    const uint32_t a = smem_u32(as + slot * kTile + c * kAtom);  // 64 rows: 8 KB either way
    const uint32_t b = smem_u32(bs + slot * kTile);
    const uint64_t da = F::MN_A ? desc_mn(a) : desc_k(a), db = F::MN_B ? desc_mn(b) : desc_k(b);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      mma16<F::F16, TA_, TB_>(acc, da + kk * k16_step<F::MN_A>(), db + kk * k16_step<F::MN_B>(),
                              i > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
    if (i > 0 && (t & 31) == 0) mbar_arrive(&empty[(i - 1) % S]);
  }
  wgmma_wait<0>();
  pin(acc);

  // epilogue: the sums through shared memory, then out as rows of 4
  // values; a split writes its f32 sums to the workspace
  float* ct = cs + c * 64 * kLdc;
  {
    const int warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<float2*>(ct + (16 * warp + g + 8 * h) * kLdc + 8 * j + 2 * q) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  constexpr int U = kBN / 4;  // 4-value units a row
  const long long plane = (long long)p.rows * p.cols;
  for (int u = t; u < 64 * U; u += 128) {
    const int r = u / U, cc = (u % U) * 4;
    const int row = m0 + 64 * c + r, col = n0 + cc;
    if (row >= p.rows || col >= p.cols) continue;
    const float4 a4 = *reinterpret_cast<const float4*>(ct + r * kLdc + cc);
    float v[4] = {a4.x, a4.y, a4.z, a4.w};
    const bool vec = p.ovec && col + 4 <= p.cols;
    if (p.splits > 1) {
      float* ws = static_cast<float*>(p.ws) + (z * p.splits + split) * plane;
      store4<float>(ws + (long long)row * p.cols + col, v, vec, p.cols - col);
      continue;
    }
    if constexpr (F::ROUND_OUT) round4(v);
    store4<TO>(static_cast<TO*>(p.out) + z * p.so + row * p.ldo + col, v, vec, p.cols - col);
  }
}

// out [batch, rows, cols] = the splits' f32 sums [batch, splits, rows, cols]
// added in split order (then rounded to e4m3 for a gradient), 4 values a
// thread
template <typename TO, bool ROUND>
__global__ void split_sum_kernel(const float* __restrict__ ws, TO* __restrict__ out, int splits,
                                 int rows, int cols, long long so, long long ldo, int ovec,
                                 long long quads) {
  const int qpr = (cols + 3) / 4;
  const long long plane = (long long)rows * cols;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < quads;
       i += (long long)gridDim.x * blockDim.x) {
    const long long zr = i / qpr;
    const int col = (int)(i - zr * qpr) * 4;
    const long long z = zr / rows;
    const int row = (int)(zr - z * rows);
    const int n = cols - col < 4 ? cols - col : 4;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int s = 0; s < splits; ++s) {
      const float* src = ws + (z * splits + s) * plane + (long long)row * cols + col;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) v[e] += src[e];
    }
    if constexpr (ROUND) round4(v);
    store4<TO>(out + z * so + row * ldo + col, v, ovec && n == 4, n);
  }
}

template <int FORM, typename T, typename TO>
cudaError_t launch(const Problem& p, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes();
  auto kernel = fp8_gemm_kernel<FORM, T, TO>;
  // the shared-memory opt-in is per device: made at the first launch on
  // each (devices 0-63; a race only repeats it)
  static std::atomic<uint64_t> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = dev < 64 ? (uint64_t)1 << dev : 0;
  if (!(opted.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
  const dim3 grid((p.cols + kBN - 1) / kBN, (p.rows + kBM - 1) / kBM, p.batch * p.splits);
  kernel<<<grid, kThreads, bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.splits == 1) return err;
  const long long quads = (long long)p.batch * p.rows * ((p.cols + 3) / 4);
  const int threads = 256;
  const long long want = (quads + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  split_sum_kernel<TO, FormTraits<FORM>::ROUND_OUT><<<blocks, threads, 0, st>>>(
      static_cast<const float*>(p.ws), static_cast<TO*>(p.out), p.splits, p.rows, p.cols, p.so,
      p.ldo, p.ovec, quads);
  return cudaGetLastError();
}

// the rounding alone: src -> dst of the same dtype, n values
template <typename T>
__global__ void e4m3_round_kernel(const T* __restrict__ src, T* __restrict__ dst, long long n) {
  for (long long i = 2 * (blockIdx.x * (long long)blockDim.x + threadIdx.x); i < n;
       i += 2 * (long long)gridDim.x * blockDim.x) {
    float lo, hi = 0.0f;
    if constexpr (sizeof(T) == 4) {
      lo = src[i];
      if (i + 1 < n) hi = src[i + 1];
    } else {
      lo = __bfloat162float(src[i]);
      if (i + 1 < n) hi = __bfloat162float(src[i + 1]);
    }
    const float2 r = e4m3_pair_f32(lo, hi);
    if constexpr (sizeof(T) == 4) {
      dst[i] = r.x;
      if (i + 1 < n) dst[i + 1] = r.y;
    } else {
      dst[i] = __float2bfloat16_rn(r.x);
      if (i + 1 < n) dst[i + 1] = __float2bfloat16_rn(r.y);
    }
  }
}

}  // namespace

extern "C" {

// form: 0 forward, 1 dx, 2 dy; t: the operands' load type, to: the output's
// (0 f32, 1 bf16). Taken: the forward over f32 (f32 or bf16 out) or bf16
// (bf16 out) operands; dx and dy over bf16 (bf16 out). With splits > 1, ws
// holds batch * splits * rows * cols f32 values.
int fp8_gemm(const Problem* pr, int form, int t, int to, void* stream) {
  const Problem& p = *pr;
  if (p.rows <= 0 || p.cols <= 0 || p.batch <= 0 || p.splits <= 0 ||
      (long long)p.batch * p.splits > 65535 || p.nr <= 0 || p.kt_per <= 0 ||
      (p.rows + kBM - 1) / kBM > 65535 || (p.splits > 1 && p.ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (form == kFwd) {
    if (t == 0 && to == 0) return (int)launch<kFwd, float, float>(p, st);
    if (t == 0 && to == 1) return (int)launch<kFwd, float, bf16>(p, st);
    if (t == 1 && to == 1) return (int)launch<kFwd, bf16, bf16>(p, st);
  } else if (t == 1 && to == 1) {
    if (form == kDx) return (int)launch<kDx, bf16, bf16>(p, st);
    if (form == kDy) return (int)launch<kDy, bf16, bf16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype 0 f32, 1 bf16; src and dst n values each
int e4m3_round(const void* src, void* dst, long long n, int dtype, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const long long want = (n / 2 + threads) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    e4m3_round_kernel<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(src), static_cast<__nv_bfloat16*>(dst), n);
  else if (dtype == 0)
    e4m3_round_kernel<float><<<blocks, threads, 0, st>>>(static_cast<const float*>(src),
                                                         static_cast<float*>(dst), n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fp8_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
