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
// Bound, at the serving path's shapes (m 256 or 1024, k = n = 2048): bytes,
// mk + kn in and 4mn (8mn with an act) out, against 2mnk operations at the
// card's dense int8 / fp8 tensor-core rate of 1979 TOP/s (at 1024 x 2048 x
// 2048: 0.0069 ms of bytes with relu, 0.0043 ms of operations).
//
// Design: wgmma, warp-specialised. A CTA of 384 threads owns a BM x 128
// output tile (BM 128, or 64 where 128-row tiles would number at most 66,
// half of an H100 SXM's SMs) and walks k in stages of 128-byte rows
// through a ring of kStages stages in shared memory, each with a full /
// empty mbarrier pair:
//   - warpgroup 0, the producer. int8: one thread loads the stage's x tile
//     and, kStages - 1 stages ahead into a raw ring, its w tile by TMA
//     (cp.async.bulk.tensor.2d, 128-byte swizzle; the tensor maps are built
//     on the host per call, and TMA zero-fills the ragged edges of m, k and
//     n). wgmma takes 8-bit operands only K-major from shared memory, and w
//     is [k, n], N-major; so the 128 producer threads transpose the raw w
//     tile into the stage's w^T tile, K-major in the same 128-byte swizzle
//     as the x tile: 4 x 4 byte blocks read as words along a row (no bank
//     conflicts), turned by __byte_perm and stored as 16-byte units in an
//     order that spreads a warp's stores over all 8 unit positions (4-way,
//     the least for 512 bytes). Then they fence the stores for the async
//     proxy and arrive. No transposed copy of w is made per call or per
//     weight. (z^T = w^T x^T, with w^T built in registers as wgmma's A
//     operand, was the other way; it puts the transposes, as 2-byte reads,
//     on the consumers' issue slots.)
//   - warpgroups 1 and 2, the consumers: each owns 64 rows x 128 columns
//     (BM 128) or 64 x 64 (BM 64) and issues four wgmma.mma_async a stage
//     from the swizzled tiles. int8: m64nNk32 .s32.s8.s8, exact, summed in
//     the same registers over all of k, one stage's group kept in flight
//     while the next issues.
// e4m3: wgmma's own e4m3 product (m64nNk32 .f32.e4m3.e4m3) keeps about 13
// bits in its sums: on the card it was 2.6e-5 of max |z| off from a single
// 16-deep product and 1.3e-4 to 2.6e-4 at k = 2048-8192 with every
// 128-byte stage summed from 0 and added in f32, outside the form's f32
// sums and their tolerance (rtol 1e-5 of max |z|). So the producer widens
// both operands to f16 as it stores them (exact: every e4m3 value is an
// f16 value), x through its own 16-byte loads in place of TMA, and the
// consumers run m64nNk16 .f32.f16.f16, whose products are exact and whose
// sums are f32: a stage is 64 k (a 128-byte f16 row), summed from 0 and
// added to the f32 accumulator by one rounded add. Its loads go to
// register slices, the next stages' in flight while one is stored.
// The epilogue stages each consumer's tile in shared memory and writes z
// (and y) as coalesced 16-byte rows, the scale and bias applied there.
// (fp8_matmul has a kernel family of its own, fp8_gemm.cu.)
//
// Plain C interface, loaded with ctypes (ops/quant_gemm.py). The launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing,
// and returns cudaGetLastError() (or the tensor-map encoder's failure as
// cudaErrorInvalidValue).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

namespace {

constexpr int kBN = 128;        // output columns a CTA
constexpr int kBK = 128;        // k bytes a stage
constexpr int kStages = 4;
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kWtBytes = kBN * kBK;  // the w^T tile of a stage

enum Act { kNone = 0, kRelu = 1, kGelu = 2, kTanh = 3, kSigmoid = 4 };

template <int ACT> __device__ __forceinline__ float act_f32(float z) {
  if (ACT == kRelu) return fmaxf(z, 0.0f);
  if (ACT == kGelu) return 0.5f * z * (1.0f + erff(z * 0.70710678118654752f));
  if (ACT == kTanh) return tanhf(z);
  if (ACT == kSigmoid) return 1.0f / (1.0f + expf(-z));
  return z;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
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

// the box of `map` at (inner c0, outer c1) into dst, by TMA
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// wgmma operand descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (8-row groups 1024 bytes apart), starting at `addr`
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait
template <int N> __device__ __forceinline__ void pin(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
template <int N> __device__ __forceinline__ void pin(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_s8_n128(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}


__device__ __forceinline__ void wgmma_s8_n64(int (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_n128(float (&d)[64], uint64_t a, uint64_t b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_f16_n64(float (&d)[32], uint64_t a, uint64_t b,
    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}


template <int WN> __device__ __forceinline__ void wgmma8(int (&d)[WN / 2], uint64_t a, uint64_t b,
                                                        int scale_d) {
  if constexpr (WN == 128) wgmma_s8_n128(d, a, b, scale_d);
  else wgmma_s8_n64(d, a, b, scale_d);
}
template <int WN> __device__ __forceinline__ void wgmma8(float (&d)[WN / 2], uint64_t a,
                                                        uint64_t b, int scale_d) {
  if constexpr (WN == 128) wgmma_f16_n128(d, a, b, scale_d);
  else wgmma_f16_n64(d, a, b, scale_d);
}

// e4m3: rows [k0 + 8 kc, + 8) and bytes [n0 + 8 nb, + 8) of w, zeros past
// k and n
__device__ __forceinline__ void load_w8(uint2 (&r)[8], const uint8_t* __restrict__ w, int N,
                                        int K, int k0, int n0, int kc, int nb) {
  const int gn = n0 + 8 * nb;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gk = k0 + 8 * kc + i;
    r[i] = gk < K && gn < N ? __ldg(reinterpret_cast<const uint2*>(w + (size_t)gk * N + gn))
                            : make_uint2(0u, 0u);
  }
}

// two e4m3 values (low byte first) -> f16x2 (low half first), exact
__device__ __forceinline__ uint32_t e4m3x2_to_f16x2(uint32_t v) {
  uint32_t out;
  const unsigned short h = (unsigned short)(v & 0xffffu);
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(out) : "h"(h));
  return out;
}

// word e of four (runtime e in 0..3), by selects: no local-memory indexing
__device__ __forceinline__ uint32_t pick(const uint32_t (&o)[4], int e) {
  const uint32_t lo = (e & 1) ? o[1] : o[0], hi = (e & 1) ? o[3] : o[2];
  return (e & 2) ? hi : lo;
}

// int8: the stage's raw w tile (128 k rows of 128 n bytes, by TMA in the
// 128-byte swizzle: 16-byte unit c of row k at c ^ (k & 7)) transposed into
// the K-major w^T tile. Producer warp pw takes the 16-row k blocks kc = 2 pw
// and 2 pw + 1, lane l the n bytes 4 l .. 4 l + 3: each 4 x 4 byte block
// read as four words of one row (a warp reads 32 words of a row, conflict
// free) and transposed with __byte_perm; the four 16-byte units (n = 4 l +
// e, k block kc) are stored in the order e = (step + (l >> 1)) & 3, so that
// the 32 lanes of a store cover all 8 unit positions (4 ways, the least)
__device__ __forceinline__ void transpose_raw(uint8_t* wt, const uint8_t* raw, int lane,
                                              int pw) {
  const int rot = (lane >> 1) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kc = 2 * pw + h;
    uint32_t o[4][4];  // [4-row k group][n byte]
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      uint32_t a[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 16 * kc + 4 * g + j;
        const int at = k * kBK + ((((lane >> 2) ^ (k & 7)) << 4) | ((lane & 3) << 2));
        a[j] = *reinterpret_cast<const uint32_t*>(raw + at);
      }
      const uint32_t t0 = __byte_perm(a[0], a[1], 0x5140), t1 = __byte_perm(a[2], a[3], 0x5140);
      const uint32_t t2 = __byte_perm(a[0], a[1], 0x7362), t3 = __byte_perm(a[2], a[3], 0x7362);
      o[g][0] = __byte_perm(t0, t1, 0x5410);
      o[g][1] = __byte_perm(t0, t1, 0x7632);
      o[g][2] = __byte_perm(t2, t3, 0x5410);
      o[g][3] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
    for (int step = 0; step < 4; ++step) {
      const int e = (step + rot) & 3, n = 4 * lane + e;
      *reinterpret_cast<uint4*>(wt + n * kBK + ((kc ^ (n & 7)) << 4)) =
          make_uint4(pick(o[0], e), pick(o[1], e), pick(o[2], e), pick(o[3], e));
    }
  }
}

// e4m3: the 8 x 8 byte block of load_w8 transposed and widened to f16:
// row n = 8 nb + e holds k 8 kc .. 8 kc + 7 as one 16-byte unit, at unit
// kc ^ (n & 7) of its 128-byte row
__device__ __forceinline__ void store_wt_f16(uint8_t* wt, const uint2 (&r)[8], int kc, int nb) {
  uint32_t o[8][2];  // [n byte][4-row k group]
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t a0 = h ? r[4 * g].y : r[4 * g].x, a1 = h ? r[4 * g + 1].y : r[4 * g + 1].x;
      const uint32_t a2 = h ? r[4 * g + 2].y : r[4 * g + 2].x;
      const uint32_t a3 = h ? r[4 * g + 3].y : r[4 * g + 3].x;
      const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a2, a3, 0x5140);
      const uint32_t t2 = __byte_perm(a0, a1, 0x7362), t3 = __byte_perm(a2, a3, 0x7362);
      o[4 * h + 0][g] = __byte_perm(t0, t1, 0x5410);
      o[4 * h + 1][g] = __byte_perm(t0, t1, 0x7632);
      o[4 * h + 2][g] = __byte_perm(t2, t3, 0x5410);
      o[4 * h + 3][g] = __byte_perm(t2, t3, 0x7632);
    }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    *reinterpret_cast<uint4*>(wt + (8 * nb + e) * kBK + ((kc ^ e) << 4)) =
        make_uint4(e4m3x2_to_f16x2(o[e][0]), e4m3x2_to_f16x2(o[e][0] >> 16),
                   e4m3x2_to_f16x2(o[e][1]), e4m3x2_to_f16x2(o[e][1] >> 16));
}

// e4m3: the x tile's 16-byte units u = tid + 128 i (row u / 4, k bytes
// 16 (u % 4) ..), zeros past m and k
template <int U>
__device__ __forceinline__ void load_x8(uint4 (&r)[U], const uint8_t* __restrict__ x, int M,
                                        int K, int m0, int k0, int tid) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tid + 128 * i, gm = m0 + (u >> 2), gk = k0 + (u & 3) * 16;
    r[i] = gm < M && gk < K ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)gm * K + gk))
                            : make_uint4(0u, 0u, 0u, 0u);
  }
}

// e4m3: load_x8's units widened to f16 into the K-major x tile of 128-byte
// rows (64 k a row) in the 128-byte swizzle
template <int U>
__device__ __forceinline__ void store_x16(uint8_t* xs, const uint4 (&r)[U], int tid) {
#pragma unroll
  for (int i = 0; i < U; ++i) {
    const int u = tid + 128 * i, row = u >> 2, c = (u & 3) * 2;
    uint8_t* at = xs + row * kBK;
    *reinterpret_cast<uint4*>(at + ((c ^ (row & 7)) << 4)) =
        make_uint4(e4m3x2_to_f16x2(r[i].x), e4m3x2_to_f16x2(r[i].x >> 16),
                   e4m3x2_to_f16x2(r[i].y), e4m3x2_to_f16x2(r[i].y >> 16));
    *reinterpret_cast<uint4*>(at + (((c + 1) ^ (row & 7)) << 4)) =
        make_uint4(e4m3x2_to_f16x2(r[i].z), e4m3x2_to_f16x2(r[i].z >> 16),
                   e4m3x2_to_f16x2(r[i].w), e4m3x2_to_f16x2(r[i].w >> 16));
  }
}

// a consumer's columns, and the row stride of its staged tile (8 floats of
// padding: a warp's float2 rows take 2 wavefronts, the least for 256 bytes)
template <int BM> __host__ __device__ constexpr int staged_cols() {
  return BM == 128 ? kBN : kBN / 2;
}
template <int BM> __host__ __device__ constexpr int ldc() { return staged_cols<BM>() + 8; }
// the consumers' staged tiles, sharing their bytes with the int8 form's
// raw w ring (dead by the time a consumer leaves its last stage)
template <int BM> __host__ __device__ constexpr size_t staging_bytes() {
  return (size_t)2 * 64 * ldc<BM>() * 4 > (size_t)kStages * kWtBytes
             ? (size_t)2 * 64 * ldc<BM>() * 4 : (size_t)kStages * kWtBytes;
}
template <int BM> constexpr size_t smem_bytes() {
  return 1024 + (size_t)kStages * (BM * kBK + kWtBytes) + staging_bytes<BM>() +
         (size_t)3 * kStages * 8;
}
static_assert(smem_bytes<128>() <= 232448, "quant GEMM ring too large");

// z = acc * scale + bias and y = act(z), f32 [M, N]
template <bool FP8, int ACT, int BM>
__global__ void __launch_bounds__(kThreads, 1)
    quant_gemm_kernel(__grid_constant__ const CUtensorMap xmap,
                      __grid_constant__ const CUtensorMap wmap, const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ w,
                      const float* __restrict__ scale, const float* __restrict__ bias,
                      float* __restrict__ z, float* __restrict__ y, int M, int N, int K) {
  constexpr int WN = staged_cols<BM>();  // a consumer's columns
  constexpr int LDC = ldc<BM>();
  constexpr int XB = BM * kBK;  // the x tile of a stage
  constexpr int KS = FP8 ? kBK / 2 : kBK;  // k a stage (e4m3: as f16)
  using Acc = typename std::conditional<FP8, float, int>::type;
  extern __shared__ unsigned char smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* xs = base;                        // kStages x tiles
  uint8_t* wts = base + kStages * XB;        // kStages w^T tiles
  float* cs = reinterpret_cast<float*>(wts + kStages * kWtBytes);  // two [64][LDC]
  uint8_t* raw = reinterpret_cast<uint8_t*>(cs);  // int8: kStages raw w tiles
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(cs) +
                                               staging_bytes<BM>());
  uint64_t* empty = full + kStages;
  uint64_t* raw_full = empty + kStages;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * kBN;
  const int kt_n = (K + KS - 1) / KS;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], FP8 ? 128 : 128 + 1);  // the producer's threads (+ the TMA's bytes)
      mbar_init(&empty[s], 8);       // one arrival a consumer warp
      mbar_init(&raw_full[s], 1);    // int8: the raw w tile's TMA
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    if constexpr (!FP8) {
      // int8 producer: x by TMA into the ring; w by TMA into the raw ring,
      // kStages - 1 stages ahead, transposed into the ring's w^T tile
      const int lane = tid & 31, pw = tid >> 5;
      if (tid == 0)
        for (int kt = 0; kt < kStages - 1 && kt < kt_n; ++kt) {
          mbar_arrive_tx(&raw_full[kt], kWtBytes);
          tma_load(raw + kt * kWtBytes, wmap, n0, kt * KS, &raw_full[kt]);
        }
      for (int kt = 0; kt < kt_n; ++kt) {
        const int s = kt % kStages, ahead = kt + kStages - 1;
        if (tid == 0 && ahead < kt_n) {  // its slot was freed by the barrier below
          const int r = ahead % kStages;
          mbar_arrive_tx(&raw_full[r], kWtBytes);
          tma_load(raw + r * kWtBytes, wmap, n0, ahead * KS, &raw_full[r]);
        }
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);  // the consumers are done with stage s
        if (tid == 0) {
          mbar_arrive_tx(&full[s], XB);
          tma_load(xs + s * XB, xmap, kt * KS, m0, &full[s]);
        }
        mbar_wait(&raw_full[s], (kt / kStages) & 1);
        transpose_raw(wts + s * kWtBytes, raw + s * kWtBytes, lane, pw);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // for the wgmma's reads
        mbar_arrive(&full[s]);
        asm volatile("bar.sync 3, 128;\n" ::: "memory");  // every lane is done with raw slot s
      }
    } else {
      // e4m3 producer: x and w by the warpgroup's loads into kSlices
      // register slices in turn (the loads of the next kSlices - 1 stages in
      // flight while this one is stored), widened to f16 as they are stored
      const int lane = tid & 31, kc = lane & 7, nb = (lane >> 3) + 4 * (tid >> 5);
      constexpr int U = BM / 32;  // x units a thread
      // two slices where four would push the 128-row kernel past its 168
      // registers
      constexpr int kSlices = BM == 128 ? 2 : 4;
      struct Slice {
        uint2 w[8];
        uint4 x[U];
      } sl[kSlices];
      auto fetch = [&](Slice& sl, int kt) {
        load_w8(sl.w, w, N, K, kt * KS, n0, kc, nb);
        load_x8<U>(sl.x, x, M, K, m0, kt * KS, tid);
      };
      auto put = [&](const Slice& sl, int kt) {
        const int s = kt % kStages;
        mbar_wait(&empty[s], ((kt / kStages) & 1) ^ 1);
        store_x16<U>(xs + s * XB, sl.x, tid);
        store_wt_f16(wts + s * kWtBytes, sl.w, kc, nb);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive(&full[s]);
      };
  #pragma unroll
      for (int u = 0; u + 1 < kSlices; ++u)
        if (u < kt_n) fetch(sl[u], u);
      for (int kt = 0; kt < kt_n; kt += kSlices) {
        // unrolled, so every slice index is a constant and the slices stay
        // in registers
  #pragma unroll
        for (int u = 0; u < kSlices; ++u) {
          if (kt + u >= kt_n) break;
          const int ahead = kt + u + kSlices - 1;
          if (ahead < kt_n) fetch(sl[(u + kSlices - 1) % kSlices], ahead);
          put(sl[u], kt + u);
        }
      }
    }
    return;
  }

  // consumers
  const int c = wg - 1, t = tid & 127;
  const int row0 = BM == 128 ? 64 * c : 0;  // the consumer's rows and columns in the tile
  const int col0 = BM == 128 ? 0 : 64 * c;
  // int8: the first wgmma overwrites acc (scale-d 0), so no other
  // instruction defines it; e4m3: a stage's sums go to part, and acc sums
  // them in f32
  Acc acc[WN / 2];
  float part[WN / 2];
  if constexpr (FP8) {
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) {
      acc[i] = 0.0f;
      part[i] = 0.0f;
    }
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const uint64_t da = desc_sw128(smem_u32(xs + s * XB + row0 * kBK));
    const uint64_t db = desc_sw128(smem_u32(wts + s * kWtBytes + col0 * kBK));
    if constexpr (!FP8) {
      // one stage's products stay in flight while the next stage's issue:
      // stage kt - 1 is released once they are done. Nothing but wgmma
      // touches acc until the last wait (ptxas would serialize the wgmma)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk)
        wgmma8<WN>(acc, da + 2 * kk, db + 2 * kk, kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait_one();
      if (kt > 0 && (t & 31) == 0) mbar_arrive(&empty[(kt - 1) % kStages]);
    } else {
      // the stage sums from 0 in the tensor core, then joins acc in f32
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 32; ++kk) wgmma8<WN>(part, da + 2 * kk, db + 2 * kk, kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      pin(part);
#pragma unroll
      for (int i = 0; i < WN / 2; ++i) acc[i] += part[i];
      if ((t & 31) == 0) mbar_arrive(&empty[s]);
    }
  }
  if constexpr (!FP8) {
    wgmma_wait_all();
    pin(acc);
  }

  // epilogue: the raw sums through shared memory, then z (and y) out as
  // 16-byte rows with the scale and bias
  float* ct = cs + c * 64 * LDC;
  {
    const int warp = t >> 5, g = (t & 31) >> 2, q = t & 3;
#pragma unroll
    for (int j = 0; j < WN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0, v1;
        if constexpr (FP8) {
          v0 = acc[4 * j + 2 * h];
          v1 = acc[4 * j + 2 * h + 1];
        } else {
          v0 = __int2float_rn(acc[4 * j + 2 * h]);
          v1 = __int2float_rn(acc[4 * j + 2 * h + 1]);
        }
        *reinterpret_cast<float2*>(ct + (16 * warp + g + 8 * h) * LDC + 8 * j + 2 * q) =
            make_float2(v0, v1);
      }
  }
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + c) : "memory");
  constexpr int U = WN / 4;  // 16-byte units a row
  const float sc = *scale;
  for (int u = t; u < 64 * U; u += 128) {
    const int r = u / U, cc = (u % U) * 4;
    const int row = m0 + row0 + r, col = n0 + col0 + cc;
    if (row >= M || col >= N) continue;
    const float4 a = *reinterpret_cast<const float4*>(ct + r * LDC + cc);
    const float4 b = __ldg(reinterpret_cast<const float4*>(bias + col));
    float4 v;
    v.x = __fadd_rn(__fmul_rn(a.x, sc), b.x);
    v.y = __fadd_rn(__fmul_rn(a.y, sc), b.y);
    v.z = __fadd_rn(__fmul_rn(a.z, sc), b.z);
    v.w = __fadd_rn(__fmul_rn(a.w, sc), b.w);
    const size_t at = (size_t)row * N + col;
    __stcs(reinterpret_cast<float4*>(z + at), v);
    if constexpr (ACT != kNone)
      __stcs(reinterpret_cast<float4*>(y + at),
             make_float4(act_f32<ACT>(v.x), act_f32<ACT>(v.y), act_f32<ACT>(v.z),
                         act_f32<ACT>(v.w)));
  }
}

// cuTensorMapEncodeTiled, found through the CUDA runtime's entry-point
// query (the library links no libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the x operand [m, k] bytes as BM x 128-byte boxes in the 128-byte swizzle,
// zeros past its edges
bool x_map(CUtensorMap* map, const void* x, int m, int k, int bm) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)k};
  const cuuint32_t box[2] = {(cuuint32_t)kBK, (cuuint32_t)bm};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(x), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the w operand [k, n] bytes as 128 x 128-byte boxes (128 k rows of 128 n
// bytes) in the 128-byte swizzle, zeros past its edges
bool w_map(CUtensorMap* map, const void* w, int k, int n) {
  EncodeTiled enc = encoder();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t strides[1] = {(cuuint64_t)n};
  const cuuint32_t box[2] = {(cuuint32_t)kBN, (cuuint32_t)kBK};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Args {
  const uint8_t* x;
  const uint8_t* w;
  const float* scale;
  const float* bias;
  float* z;
  float* y;
  int m, n, k;
};

template <bool FP8, int ACT, int BM>
cudaError_t launch_tile(const CUtensorMap (&maps)[2], const Args& a, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<BM>();
  auto kernel = quant_gemm_kernel<FP8, ACT, BM>;
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
  const dim3 grid((a.n + kBN - 1) / kBN, (a.m + BM - 1) / BM);
  kernel<<<grid, kThreads, bytes, st>>>(maps[0], maps[1], a.x, a.w, a.scale, a.bias, a.z, a.y,
                                        a.m, a.n, a.k);
  return cudaGetLastError();
}

template <bool FP8, int BM>
cudaError_t launch_act(const CUtensorMap (&maps)[2], const Args& a, int act, cudaStream_t st) {
  switch (act) {
    case kNone: return launch_tile<FP8, kNone, BM>(maps, a, st);
    case kRelu: return launch_tile<FP8, kRelu, BM>(maps, a, st);
    case kGelu: return launch_tile<FP8, kGelu, BM>(maps, a, st);
    case kTanh: return launch_tile<FP8, kTanh, BM>(maps, a, st);
    case kSigmoid: return launch_tile<FP8, kSigmoid, BM>(maps, a, st);
    default: return cudaErrorInvalidValue;
  }
}

// 128-row tiles, or 64 where 128-row tiles would fill at most half of an
// H100 SXM's 132 SMs (on another card the choice changes only the speed)
int tile_rows(int m, int n) {
  const long tiles = (long)((m + 127) / 128) * ((n + kBN - 1) / kBN);
  return tiles <= 66 ? 64 : 128;
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
  const int bm = tile_rows(m, n);
  if ((m + bm - 1) / bm > 65535) return (int)cudaErrorInvalidValue;
  // the int8 form reads x and w by TMA; e4m3 widens both to f16 as it
  // loads them
  CUtensorMap maps[2] = {};
  if (!fp8 && !(x_map(&maps[0], x, m, k, bm) && w_map(&maps[1], w, k, n)))
    return (int)cudaErrorInvalidValue;
  const Args a = {static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(w), scale, bias,
                  z, y, m, n, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fp8)
    err = bm == 128 ? launch_act<true, 128>(maps, a, act, st)
                    : launch_act<true, 64>(maps, a, act, st);
  else
    err = bm == 128 ? launch_act<false, 128>(maps, a, act, st)
                    : launch_act<false, 64>(maps, a, act, st);
  return (int)err;
}

const char* quant_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
