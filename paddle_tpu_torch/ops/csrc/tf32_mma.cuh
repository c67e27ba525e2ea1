// f32-accurate products on Hopper's tensor cores: 3xTF32 through
// mma.sync.m16n8k8 (sm_80 and later), shared by gemm_epilogue.cu and
// flash_attention.cu.
//
// A TF32 product keeps 10 of f32's 23 mantissa bits (about 2^-11 relative),
// too coarse for the port's rule that f32 products are full f32 (the
// kernels' tolerances against their plain versions are 1e-4 and tighter).
// 3xTF32 splits each f32 operand as x = hi + lo, hi = x cut to TF32 and
// lo = x - hi (exact in f32) read as TF32, and sums
//   a_lo * b_hi + a_hi * b_lo + a_hi * b_hi
// in the f32 accumulator. The dropped a_lo * b_lo and the cut of lo leave
// about 2^-20 relative error per product. The tensor core's own f32 sums
// align their addends by truncation, so over a long k the accumulator, not
// the split, sets the error (measured on the card: within the kernels'
// tolerances at k = 2048). Operands already exact in TF32 (bf16 values, widened) need the
// hi product alone: SPLIT = false.
//
// Fragment layouts of m16n8k8 .tf32 (PTX ISA), with g = lane / 4 and
// t = lane % 4:
//   A (16 x 8, row):  a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8, f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tf32 {

// hi (and lo when SPLIT) of one operand value: hi is x with its 13 low
// mantissa bits cleared (one logic op), lo = x - hi is exact in f32 and goes
// to the mma as it is. The tensor core reads an f32 register's top 10
// mantissa bits as TF32 (truncation), so lo loses at most 2^-10 of itself,
// and |lo| < 2^-10 |x|: about 2^-20 of x a product.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);  // already a TF32 value
    lo = 0u;
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a * b, the accumulator's old value ignored
__device__ __forceinline__ void mma_first(float (&c)[4], const uint32_t (&a)[4],
                                          const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.0f));
}

// acc[i][j] += a_i * b_j over a warp's MT x NT mma tiles, to f32 accuracy
// (SPLIT) or as one exact TF32 product each; FIRST: acc = a_i * b_j. Three
// passes over the tiles, the small terms first: the MT * NT products of a
// pass are independent, so consecutive mma never wait on each other's
// accumulator.
template <bool SPLIT, int MT, int NT, bool FIRST = false>
__device__ __forceinline__ void mma_tiles(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                          const uint32_t (&al)[MT][4],
                                          const uint32_t (&bh)[NT][2],
                                          const uint32_t (&bl)[NT][2]) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if constexpr (FIRST) mma_first(acc[i][j], al[i], bh[j]);
        else mma(acc[i][j], al[i], bh[j]);
      }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) mma(acc[i][j], ah[i], bl[j]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (FIRST && !SPLIT) mma_first(acc[i][j], ah[i], bh[j]);
      else mma(acc[i][j], ah[i], bh[j]);
    }
}

// four 8 x 8 b16 matrices, i.e. 8 x 4 words each, from shared memory: lane
// l names the row address of matrix l / 8, and receives word (l / 4, l % 4)
// of each, which for 32-bit elements is an m16n8k8 A fragment when the four
// matrices are rows 0-7 / 8-15 at columns 0-3 / 4-7
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// operands of type T need the split only when they are f32
template <typename T> __host__ __device__ constexpr bool needs_split() { return sizeof(T) == 4; }

}  // namespace tf32
