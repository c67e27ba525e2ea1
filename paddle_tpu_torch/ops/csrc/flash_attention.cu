// Flash attention, forward and backward, over (b, h, t, d) operands, for
// Hopper (sm_90a). f32 or bf16 operands, f32 accumulation, any head width
// d >= 1 and any number of (b, h) pairs.
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   _flash_forward            -> _flash_kernel             (resident forward)
//   _flash_forward_streamed   -> _flash_kernel_streamed    (K/V through the grid)
//   _flash_backward           -> _flash_bwd_fused_kernel   (dQ, dK, dV in one)
//   _flash_backward_streamed  -> _flash_bwd_dq_streamed, _flash_bwd_dkv_streamed
// The TPU splits each direction into a VMEM-resident tier and a streamed one
// for t past its VMEM budget. A CTA here streams K/V (or Q/dO) tiles through
// shared memory at every length, so flash_fwd_kernel serves both forward
// tiers. The backward keeps the JAX package's two tiers: the fused kernel
// (flash_bwd_fused_kernel) where its per-key-tile dQ partials stay within 2x
// dQ (at most two 128-key tiles, d <= 64; the wrapper decides), and the
// flash_bwd_dkv_kernel + flash_bwd_dq_kernel pair everywhere else.
//
// Head widths: each kernel is built for a few padded widths DP (the forward
// 32, 64 and 128; the fused tier 64; the pair 64 and 128) and takes the
// smallest DP >= d. Columns past d are zero-filled as each tile is loaded
// (cp.async with source size 0, or element by element where rows are not
// aligned for 4-element loads): zero columns change no q k^T, give zero
// dQ / dK / dV columns, and are never stored. Outputs are (b, h, t, d)
// with row stride d. Heads wider than 128 take column blocks
// (flash_fwd_wide_kernel, flash_bwd_dkv_wide_kernel + flash_bwd_dq_wide_kernel):
// grid y (the forward) or z (the pair) is the output's 128-wide column
// block; each CTA forms the scores over all of d in 128-wide chunks, in
// chunk order, so every block sees the same p, and keeps its own 128
// columns of p v (or of dK / dV / dQ); block 0 writes lse. A CTA's shared
// memory stays that of a 128 build, whatever d is; the scores are formed
// once per column block, a cost that only heads past 128 pay. The fused
// backward tier stays at d <= 64. The (b, h) pair rides grid x (the forward: x = tile *
// b * h + bh, so the longest causal tiles of every (b, h) start first; the
// pair and the fused backward: x = bh, y = the tile, read from special
// registers, not kept live), so b * h is bounded only by grid x's 2^31 - 1
// (and t by grid y's 65535 tiles).
//
// Contract (the TPU kernel's, not the dense softmax's): s = q k^T * scale,
// causal masking aligned bottom-right (query row i sees keys up to
// i + tk - tq); out = softmax(s) v through an f32 online softmax, with p
// rounded to the operand dtype before the product with v; lse = m + log(l)
// per row, (b, h, tq) f32. A fully masked row (causal, tq > tk) gets out 0
// and lse 0. The backward recomputes p = exp(s - lse) from the saved lse,
// takes delta = rowsum(dO * O) inline from the saved output, and forms
// ds = p * (dp - delta) * scale rounded to the operand dtype; dV = p^T dO,
// dK = ds^T q, dQ = ds k, each summed in f32 and rounded once.
//
// Bound, at the training path's (16, 8, 256, 64) f32: operations. The
// forward does 4 * b * h * tq * tk * d flops (2.15 GFLOP: 0.0130 ms as
// 3xTF32 on the tensor cores at 495 TFLOP/s, 0.032 ms on the CUDA cores'
// 67 TFLOP/s) against 33.6 MB of operands (0.010 ms at 3.35 TB/s); the
// backward needs five such products, 5.37
// GFLOP: 0.0801 ms on the CUDA cores, or, f32-accurate on the tensor cores
// as 3xTF32 (tf32_mma.cuh: three TF32 products a pair, about 2^-21 relative
// error a product, inside the 1e-4 gradient tolerance where one TF32
// product, about 2^-11, is not), 3 x 5.37 GFLOP at 495 TFLOP/s = 0.0325 ms
// (causal: half the pairs, 0.0163 ms).
//
// The forward, on the tensor cores: a CTA of 4 warps owns 64 query rows,
// 16 a warp, and streams 64-key K/V tiles through a two-stage cp.async
// ring (one CTA barrier a key tile). Both products run as mma.sync m16n8k8
// (3xTF32 for f32, one exact TF32 product for bf16). A warp's 16 x 64
// scores stay in registers as C fragments: a thread holds rows g and g + 8,
// so the row max is two quad shuffles and the row sum is kept per thread
// and summed over the quad once at the end. p, rounded to the operand
// dtype, becomes the A fragment of p v with no data movement: within each
// 8-key step the k slots (t, t + 4) are taken to be keys (2t, 2t + 1),
// which is where the C fragment already holds them, and the B fragment of
// v reads the same keys. The softmax runs in base 2 (scores times
// scale * log2(e), one ex2 an exponential). Each key tile's p v part sums
// in the tensor core from 0 and joins the f32 O registers by one rounded
// add (the tensor
// core's own sums truncate and would drift over a long tk). Tiles are
// row-major with 4-element units XOR-swizzled by (row & 7): q (ldmatrix)
// and k read as fragments, and v read down its key axis, all hit 32
// distinct banks. Causal tiles past the diagonal are never loaded, and
// causal CTAs start with the longest rows.
//
// The pair: f32 products on the CUDA cores. A CTA of 256 threads owns a
// 64 x 64 tile of scores, 4 x 4 a thread. Operand tiles live in shared
// memory with rows padded by 4 elements, so the
// 16-byte (f32) or 8-byte (bf16) loads along d of 16 different rows hit
// distinct banks. The pair has no float atomics: dK/dV is one CTA per K
// tile looping over the query tiles, dQ one CTA per query tile looping over
// the K tiles, so each sum has one owner; the price is s and dp computed in
// both kernels, seven products for five.
//
// The fused backward: one CTA of 8 warps per (b * h, 128-key tile) keeps
// its K and V tiles in shared memory and streams 64-row query tiles (q, dO)
// through a two-stage cp.async ring, the next tile's O rows and lse held in
// registers ahead of use. Each (query tile, key tile) pair runs the five
// products once on the tensor cores (mma.sync m16n8k8 in three passes, as
// in gemm_epilogue.cu; f32 operands split hi / lo in registers for 3xTF32,
// the row-major side of q, dO and ds read by ldmatrix, bf16 operands exact
// in one TF32 product): s and dp (warps 2 x 4 over 64 x 128), then p and ds in
// registers, rounded to the operand dtype and staged in shared memory, then
// dV += p^T dO and dK += ds^T q (warps 4 x 2 over 128 x 64; each query
// tile's part sums in the tensor core from 0 and joins the f32 registers by
// a rounded add, since the tensor core's own sums truncate and would drift
// over a long tq) and this key tile's dQ partial ds k, written to an f32
// scratch. delta is computed once per (row, key tile) from
// the staged dO and the O rows: at most twice a row at the tier's cap. Every
// tile is row-major with its 4-element units XOR-swizzled by row, so the
// fragment reads of both orientations (a tile read as A, and transposed as
// B) are free of bank conflicts. dQ has no float atomics: the last key tile
// of each (b, h) to finish, found by an integer arrival counter, sums the
// partials in key-tile order and rounds once, so the backward repeats bit
// for bit (a second summing kernel measured a few microseconds less device
// time for one more launch a backward, on a path bound by the host's launch
// cost; PERF.md). wgmma and TMA are later work.
//
// Operands may be strided views (any (b, h, t) strides; d contiguous, rows
// aligned for 4-element loads), as the model's transposes hand them over;
// outputs are contiguous. Plain C interface, loaded with ctypes
// (ops/flash_attention.py). Each launcher enqueues on the caller's stream,
// does not synchronize, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_mma.cuh"

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;     // backward: the forward's output
  const void* dout;  // backward: dL/dout
  const float* lse;  // backward: the forward's lse, (b, h, tq) contiguous
  void* out;         // forward: (b, h, tq, d) contiguous
  float* lse_out;    // forward: (b, h, tq)
  void* dq;          // backward outputs, contiguous
  void* dk;
  void* dv;
  int64_t sq[3];  // (b, h, t) strides in elements; d is contiguous
  int64_t sk[3];
  int64_t sv[3];
  int64_t so[3];
  int64_t sdo[3];
  int b, h, tq, tk, d, causal, dtype;  // dtype: 0 f32, 1 bf16
  // every operand row loads as aligned 4-element units: d % 4 == 0, each
  // (b, h, t) stride a multiple of 4 and each pointer 4-element aligned
  int vec;
  float scale;
};

namespace {

constexpr int kBM = 64;  // query rows a tile
constexpr int kBN = 64;  // keys a tile
constexpr int kThreads = 256;   // the pair
constexpr int kFwdThreads = 128;  // the forward: 4 warps of 16 query rows
constexpr int kPLD = kBN + 4;  // row stride of the f32 p / ds tiles
constexpr int kWide = 128;  // a wide head's column block (heads past 128)
constexpr float kNegInf = -__builtin_huge_valf();

using tf32::from_f32;
using tf32::to_f32;

// 2^x by the SFU (ex2.approx: about 2^-22 relative error; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// v rounded to T and widened back
template <typename T> __device__ __forceinline__ float round_t(float v);
template <> __device__ __forceinline__ float round_t<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_t<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}


// four consecutive elements (16 bytes of f32, 8 of bf16) as f32
__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// cp.async of 4 elements; src-size 0 fills the destination with zeros
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src),
                 "n"(BYTES), "r"(n));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// columns [c, c + 4) of one operand row (`row` its first element, d its
// width) into 4 consecutive elements of shared memory; columns at or past
// d, and every column when !ok, read as zeros. vec: one cp.async of the
// whole aligned unit (source size 0 zero-fills; d % 4 == 0, so a unit is
// wholly inside d or past it); else element by element, synchronously
// (bf16 has no 2-byte cp.async), done before the barrier that follows.
template <typename T>
__device__ __forceinline__ void load_unit(T* dst, const T* row, bool ok, int c, int d, bool vec) {
  if (vec) {
    const bool live = ok && c < d;
    cp_async<(int)(4 * sizeof(T))>(dst, live ? row + c : row, live);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = ok && c + e < d ? row[c + e] : from_f32<T>(0.0f);
}

// four consecutive elements of a row from device memory as f32, zeros at
// or past column d
template <typename T>
__device__ __forceinline__ void load4_row(const T* row, int c, int d, bool vec, float (&o)[4]) {
  if (vec && c < d) {
    load4(row + c, o);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) o[e] = c + e < d ? to_f32(row[c + e]) : 0.0f;
}

// rows [r0, r0 + R) of a (t, d) operand with row stride `st` into a
// [R][D + 4] shared tile (D >= d); rows at or past t, and columns at or past
// d, read as zeros. FULL: d == D and every row aligned, so whole units copy
// by cp.async with no column test.
template <typename T, int D, int R, bool FULL>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t st, int r0, int t, int d,
                                          bool vec) {
  constexpr int G = D / 4;
  for (int g = threadIdx.x; g < R * G; g += kThreads) {
    const int r = g / G, c = (g % G) * 4;
    const bool ok = r0 + r < t;
    if constexpr (FULL) {
      const T* from = src + (ok ? (int64_t)(r0 + r) * st + c : 0);
      cp_async<(int)(4 * sizeof(T))>(dst + r * (D + 4) + c, from, ok);
    } else {
      load_unit(dst + r * (D + 4) + c, src + (ok ? (int64_t)(r0 + r) * st : 0), ok, c, d, vec);
    }
  }
}

// s[i][j] += a_row(ty*4+i) . b_row(tx+16j) over d: the 4 x 4 part of a
// 64 x 64 product of two [64][D + 4] shared tiles this thread owns
template <typename T, int D>
__device__ __forceinline__ void tile_dot(const T* a, const T* b, int tx, int ty,
                                         float (&s)[4][4]) {
  constexpr int LD = D + 4;
#pragma unroll 4
  for (int c = 0; c < D; c += 4) {
    float av[4][4], bv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(a + (ty * 4 + i) * LD + c, av[i]);
#pragma unroll
    for (int j = 0; j < 4; ++j) load4(b + (tx + 16 * j) * LD + c, bv[j]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j] = fmaf(av[i][e], bv[j][e], s[i][j]);
  }
}

// acc[i][n][e] += sum_kk p[ty*4+i][kk] * x[kk][n*64 + tx*4 + e]: a 64-row
// f32 tile times a [64][D + 4] operand tile
template <typename T, int D>
__device__ __forceinline__ void tile_pv(const float* p, const T* x, int tx, int ty,
                                        float (&acc)[4][D / 64][4]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int kk = 0; kk < kBN; kk += 4) {
    float pv[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) load4(p + (ty * 4 + i) * kPLD + kk, pv[i]);
#pragma unroll
    for (int e4 = 0; e4 < 4; ++e4) {
#pragma unroll
      for (int n = 0; n < D / 64; ++n) {
        float xv[4];
        load4(x + (kk + e4) * LD + n * 64 + tx * 4, xv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][n][e] = fmaf(pv[i][e4], xv[e], acc[i][n][e]);
      }
    }
  }
}

// acc[i][n][e] += sum_r p[r][ty*4+i] * x[r][n*64 + tx*4 + e]: the transposed
// product, for dV = p^T dO and dK = ds^T q
template <typename T, int D>
__device__ __forceinline__ void tile_ptx(const float* p, const T* x, int tx, int ty,
                                         float (&acc)[4][D / 64][4]) {
  constexpr int LD = D + 4;
#pragma unroll 2
  for (int r = 0; r < kBM; ++r) {
    float pr[4];
    load4(p + r * kPLD + ty * 4, pr);
#pragma unroll
    for (int n = 0; n < D / 64; ++n) {
      float xv[4];
      load4(x + r * LD + n * 64 + tx * 4, xv);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][n][e] = fmaf(pr[i], xv[e], acc[i][n][e]);
    }
  }
}

// rows [row0, row0 + 64) of an output with row stride ld from a thread's
// [4][D / 64][4] accumulator, rows at or past t and columns at or past cols
// dropped (FULL: ld == cols == D)
template <typename T, int D, bool FULL>
__device__ __forceinline__ void store_rows(T* dst, int row0, int t, int ld, int cols, int tx,
                                           int ty, const float (&acc)[4][D / 64][4]) {
  if constexpr (FULL) ld = D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty * 4 + i;
    if (row >= t) continue;
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 64 + tx * 4 + e;
        if (FULL || c < cols) dst[(int64_t)row * ld + c] = from_f32<T>(acc[i][n][e]);
      }
  }
}

// keys a query tile needs: all of them, or (causal) up to the tile's last
// valid row's last visible key
__device__ __forceinline__ int key_tiles(const FlashParams& p, int q0) {
  const int n = (p.tk + kBN - 1) / kBN;
  if (!p.causal) return n;
  const int last_key = min(q0 + kBM, p.tq) - 1 + (p.tk - p.tq);
  return last_key < 0 ? 0 : min(n, last_key / kBN + 1);
}

__device__ __forceinline__ bool visible(const FlashParams& p, int row, int key) {
  return row < p.tq && key < p.tk && (!p.causal || row + (p.tk - p.tq) >= key);
}

// Element (r, c) of a row-major tile of W columns (W a multiple of 32), its
// 4-element units XOR-swizzled by (r & 7): 8 consecutive rows read at one
// unit (ldmatrix, and the B fragment of q k^T), and rows 2t or 2t + 1 of an
// 8-row group read at 8 consecutive columns (the B fragment of p v), each
// hit 32 distinct banks for f32; a unit stays contiguous for cp.async.
__device__ __forceinline__ int sw(int r, int c, int w) { return r * w + (c ^ ((r & 7) << 2)); }

// rows [r0, r0 + R) of a (t, d) operand with row stride `st` into a
// swizzled [R][DP] tile; rows at or past t, and columns at or past d, read
// as zeros
template <typename T, int DP, int R, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t st, int r0, int t, int d,
                                          bool vec) {
  constexpr int G = DP / 4;
  for (int i = threadIdx.x; i < R * G; i += NT) {
    const int r = i / G, c = (i % G) * 4;
    const bool ok = r0 + r < t;
    load_unit(dst + sw(r, c, DP), src + (ok ? (int64_t)(r0 + r) * st : 0), ok, c, d, vec);
  }
}

// s = q k^T of a warp's 16 rows (from w0 of the swizzled [*][DP] tile Qs)
// and the 64 keys of the swizzled [64][DP] tile Kb, over DP columns, summed
// in the tensor core from 0
template <typename T, int DP>
__device__ __forceinline__ void qk_scores(float (&s)[1][kBN / 8][4], const T* Qs, const T* Kb,
                                          int w0) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int KN = kBN / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l names row (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4)
  // of the A fragment's four 8 x 4 matrices; for the B fragments of k, row
  // (l & 7) + 8 (l >> 4), column 4 ((l >> 3) & 1): b0, b1 of two 8-key tiles
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 4 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kk = 0; kk < DP; kk += 8) {
    uint32_t ah[1][4], al[1][4], bh[KN][2], bl[KN][2];
    if constexpr (sizeof(T) == 4) {
      uint32_t r[4];
      tf32::ldmatrix_x4(r, Qs + sw(w0 + arow, kk + acol, DP));
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split<kSplit>(__uint_as_float(r[e]), ah[0][e], al[0][e]);
#pragma unroll
      for (int j = 0; j < KN; j += 2) {
        tf32::ldmatrix_x4(r, Kb + sw(8 * j + brow, kk + bcol, DP));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split<kSplit>(__uint_as_float(r[e]), bh[j + e / 2][e & 1], bl[j + e / 2][e & 1]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32::split<kSplit>(to_f32(Qs[sw(w0 + g + 8 * (e & 1), kk + t + 4 * (e >> 1), DP)]),
                            ah[0][e], al[0][e]);
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tf32::split<kSplit>(to_f32(Kb[sw(8 * j + g, kk + t + 4 * e, DP)]), bh[j][e], bl[j][e]);
    }
    if (kk == 0) tf32::mma_tiles<kSplit, 1, KN, true>(s, ah, al, bh, bl);
    else tf32::mma_tiles<kSplit, 1, KN>(s, ah, al, bh, bl);
  }
}

// One key tile of the forward for a warp's 16 rows: the online softmax on
// the scores s of keys k0.. (C fragments: s[0][j][2h + e] is row row[h], key
// k0 + 8j + 2t + e; masked here), then o += p v over the swizzled [64][DP]
// tile Vb (DP / 8 output tiles of 8 columns), the tile's part summed from 0
template <typename T, int DP>
__device__ __forceinline__ void softmax_pv(const FlashParams& p, float (&s)[1][kBN / 8][4],
                                           float (&o)[DP / 8][4], float (&m)[2], float (&l)[2],
                                           const T* Vb, int k0, int q0, int w0,
                                           const int (&row)[2], float scale2) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int NO = DP / 8;           // 8-column tiles of a warp's output
  constexpr int NB = NO < 8 ? NO : 8;  // of them in one pass of p v
  constexpr int KN = kBN / 8;          // 8-key tiles of a key tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool edge = k0 + kBN > p.tk || q0 + w0 + 16 > p.tq ||
                    (p.causal && k0 + kBN - 1 > q0 + w0 + (p.tk - p.tq));
  float alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[0][j][2 * h + e];
        x = !edge || visible(p, row[h], k0 + 8 * j + 2 * t + e) ? x * scale2 : kNegInf;
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // a row masked so far must not poison the rescale
    alpha[h] = m[h] == kNegInf ? 0.0f : ex2(m[h] - m_new);
    m[h] = m_new;
  }
  // p (kept in s), its sum unrounded, then rounded to T for p v
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < KN; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[0][j][2 * h + e];
        const float pf = x == kNegInf ? 0.0f : ex2(x - m[h]);
        sum[h] += pf;
        x = round_t<T>(pf);
      }
#pragma unroll
  for (int h = 0; h < 2; ++h) l[h] = l[h] * alpha[h] + sum[h];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }

  // o += p v, NB output tiles a pass, the tile's part summed from 0. p is
  // the A fragment as it stands: k slots (t, t + 4) of 8-key step j are
  // keys 8j + 2t and 8j + 2t + 1, split as they are used
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += NB) {
    float part[1][NB][4];
#pragma unroll
    for (int j = 0; j < KN; ++j) {
      uint32_t ah[1][4], al[1][4], bh[NB][2], bl[NB][2];
      tf32::split<kSplit>(s[0][j][0], ah[0][0], al[0][0]);  // (g, key 2t)
      tf32::split<kSplit>(s[0][j][2], ah[0][1], al[0][1]);  // (g + 8, key 2t)
      tf32::split<kSplit>(s[0][j][1], ah[0][2], al[0][2]);  // (g, key 2t + 1)
      tf32::split<kSplit>(s[0][j][3], ah[0][3], al[0][3]);  // (g + 8, key 2t + 1)
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tf32::split<kSplit>(to_f32(Vb[sw(8 * j + 2 * t + e, 8 * (n0 + c) + g, DP)]), bh[c][e],
                              bl[c][e]);
      if (j == 0) tf32::mma_tiles<kSplit, 1, NB, true>(part, ah, al, bh, bl);
      else tf32::mma_tiles<kSplit, 1, NB>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n0 + c][e] += part[0][c][e];
  }
}

// The forward's rows row[h] of columns [c0, c0 + cols) from a warp's
// accumulator (row stride d), and (write_lse) their lse; l is summed over
// the quad first
template <typename T, int NO>
__device__ __forceinline__ void store_fwd(const FlashParams& p, T* out, float* lse,
                                          const float (&o)[NO][4], const float (&m)[2],
                                          float (&l)[2], const int (&row)[2], int c0, int cols,
                                          bool write_lse) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= p.tq) continue;
    const float denom = fmaxf(l[h], 1e-20f);
    T* orow = out + (int64_t)row[h] * p.d + c0;
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * t + e;
        if (c < cols) orow[c] = from_f32<T>(o[n][2 * h + e] / denom);
      }
    if (write_lse && t == 0)
      lse[row[h]] = m[h] == kNegInf ? 0.0f : m[h] * 0.6931471805599453f + logf(denom);
  }
}

// columns [c0, c0 + cols) of a query tile whose every row is fully masked:
// out 0, and (write_lse) lse 0
template <typename T>
__device__ __forceinline__ void store_masked_tile(const FlashParams& p, T* out, float* lse,
                                                  int q0, int c0, int cols, bool write_lse) {
  for (int i = threadIdx.x; i < kBM * cols; i += kFwdThreads) {
    const int r = i / cols;
    if (q0 + r < p.tq) out[(int64_t)(q0 + r) * p.d + c0 + i % cols] = from_f32<T>(0.0f);
  }
  if (write_lse)
    for (int r = threadIdx.x; r < kBM; r += kFwdThreads)
      if (q0 + r < p.tq) lse[q0 + r] = 0.0f;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_kernel(const FlashParams p) {
  constexpr int NO = DP / 8;  // 8-column tiles of a warp's output
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kBM * DP;      // two stages
  T* Vs = Ks + 2 * kBN * DP;  // two stages

  const int n_bh = p.b * p.h;
  const int bh = blockIdx.x % n_bh, tile = blockIdx.x / n_bh;
  const int bi = bh / p.h, hi = bh % p.h;
  // causal: the last query tiles have the most keys, so they start first
  const int n_qt = (p.tq + kBM - 1) / kBM;
  const int q0 = (p.causal ? n_qt - 1 - tile : tile) * kBM;
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  T* out = static_cast<T*>(p.out) + (int64_t)bh * p.tq * p.d;
  float* lse = p.lse_out + (int64_t)bh * p.tq;

  const int n_kt = key_tiles(p, q0);
  if (n_kt == 0) {  // every row of the tile fully masked: out 0, lse 0
    store_masked_tile(p, out, lse, q0, 0, p.d, true);
    return;
  }
  load_rows<T, DP, kBM, kFwdThreads>(Qs, q, p.sq[2], q0, p.tq, p.d, vec);
  load_rows<T, DP, kBN, kFwdThreads>(Ks, k, p.sk[2], 0, p.tk, p.d, vec);
  load_rows<T, DP, kBN, kFwdThreads>(Vs, v, p.sv[2], 0, p.tk, p.d, vec);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int w0 = warp * 16;                   // the warp's first row in the tile
  const int row[2] = {q0 + w0 + g, q0 + w0 + g + 8};  // the thread's two rows

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // the softmax runs in base 2: m and the scores are s * scale * log2(e), so
  // each exponential is one ex2; lse = m ln(2) + log(l)
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};  // l: this thread's share

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<0>();
    __syncthreads();  // tile kt is here, and every warp is done with tile kt - 1
    if (kt + 1 < n_kt) {  // the next tile's copies run under this one's math
      const int nb = (kt + 1) & 1;
      load_rows<T, DP, kBN, kFwdThreads>(Ks + nb * kBN * DP, k, p.sk[2], (kt + 1) * kBN, p.tk,
                                         p.d, vec);
      load_rows<T, DP, kBN, kFwdThreads>(Vs + nb * kBN * DP, v, p.sv[2], (kt + 1) * kBN, p.tk,
                                         p.d, vec);
    }
    cp_async_commit();
    // s = q k^T: the warp's 16 rows x 64 keys, summed over DP from 0
    float s[1][kBN / 8][4];
    qk_scores<T, DP>(s, Qs, Ks + (kt & 1) * kBN * DP, w0);
    softmax_pv<T, DP>(p, s, o, m, l, Vs + (kt & 1) * kBN * DP, kt * kBN, q0, w0, row, scale2);
  }
  cp_async_wait<0>();
  store_fwd<T, NO>(p, out, lse, o, m, l, row, 0, p.d, true);
}

// Heads wider than kWide: column blocks. The grid gains a y axis of
// ceil(d / kWide) output column blocks; each CTA computes s = q k^T over
// all of d, in kWide-wide chunks summed from 0 and added in f32 in chunk
// order (every block sees the same s, so the same p, m and l), and keeps
// its own kWide columns of p v. A two-stage ring carries steps of two
// swizzled [64][kWide] tiles: for each key tile, (q chunk c, k chunk c)
// for every c, then (v's block). Block 0 writes lse.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_wide_kernel(const FlashParams p) {
  constexpr int DP = kWide, NO = DP / 8, KN = kBN / 8;
  static_assert(kBM == kBN, "a ring stage holds a query chunk or a key tile");
  extern __shared__ __align__(16) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);  // two stages: the q chunk, or v's block
  T* Bs = As + 2 * kBM * DP;           // two stages: the k chunk

  const int n_bh = p.b * p.h;
  const int bh = blockIdx.x % n_bh, tile = blockIdx.x / n_bh;
  const int bi = bh / p.h, hi = bh % p.h;
  const int n_qt = (p.tq + kBM - 1) / kBM;
  const int q0 = (p.causal ? n_qt - 1 - tile : tile) * kBM;
  const int nc = (p.d + DP - 1) / DP, c0 = blockIdx.y * DP, cols = min(DP, p.d - c0);
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  T* out = static_cast<T*>(p.out) + (int64_t)bh * p.tq * p.d;
  float* lse = p.lse_out + (int64_t)bh * p.tq;

  const int n_kt = key_tiles(p, q0);
  if (n_kt == 0) {
    store_masked_tile(p, out, lse, q0, c0, cols, blockIdx.y == 0);
    return;
  }
  const int n_steps = n_kt * (nc + 1);
  auto issue = [&](int step) {
    const int kt = step / (nc + 1), c = step % (nc + 1);
    T* a = As + (step & 1) * kBM * DP;
    if (c < nc) {
      const int w = min(DP, p.d - c * DP);
      load_rows<T, DP, kBM, kFwdThreads>(a, q + c * DP, p.sq[2], q0, p.tq, w, vec);
      load_rows<T, DP, kBN, kFwdThreads>(Bs + (step & 1) * kBN * DP, k + c * DP, p.sk[2],
                                         kt * kBN, p.tk, w, vec);
    } else {
      load_rows<T, DP, kBN, kFwdThreads>(a, v + c0, p.sv[2], kt * kBN, p.tk, cols, vec);
    }
  };
  issue(0);
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2;
  const int w0 = warp * 16;
  const int row[2] = {q0 + w0 + g, q0 + w0 + g + 8};
  float o[NO][4], s[1][KN][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // this step's tiles are here; every warp is done with the last
    if (step + 1 < n_steps) issue(step + 1);
    cp_async_commit();
    const int kt = step / (nc + 1), c = step % (nc + 1);
    const T* a = As + (step & 1) * kBM * DP;
    if (c < nc) {
      float part[1][KN][4];
      qk_scores<T, DP>(part, a, Bs + (step & 1) * kBN * DP, w0);
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[0][j][e] = c == 0 ? part[0][j][e] : s[0][j][e] + part[0][j][e];
    } else {
      softmax_pv<T, DP>(p, s, o, m, l, a, kt * kBN, q0, w0, row, scale2);
    }
  }
  cp_async_wait<0>();
  store_fwd<T, NO>(p, out, lse, o, m, l, row, c0, cols, blockIdx.y == 0);
}

// lse and delta = rowsum(dO * O) of the query tile's rows into shared
// memory, four threads a row; rows at or past tq get 0
template <typename T, int D, bool FULL>
__device__ __forceinline__ void tile_lse_delta(const FlashParams& p, const T* o, const T* dOs,
                                               const float* lse, int q0, float* lse_s,
                                               float* delta_s) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
  float acc = 0.0f;
  if (row < p.tq) {
    const T* orow = o + (int64_t)row * p.so[2];
    for (int c = part * 4; c < D; c += 16) {
      float a[4], b[4];
      if constexpr (FULL) load4(orow + c, a);
      else load4_row(orow, c, p.d, p.vec != 0, a);
      load4(dOs + r * (D + 4) + c, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc = fmaf(a[e], b[e], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = row < p.tq ? lse[row] : 0.0f;
  }
}

// from s = q k^T and dp = dO v^T of a (query tile, key tile) pair (a
// thread's 4 x 4 of each), writes ds = p * (dp - delta) * scale (rounded to
// T) into dSs and, when Ps is not null, p (rounded to T) into Ps
template <typename T>
__device__ __forceinline__ void p_ds_tile(const FlashParams& p, const float (&s)[4][4],
                                          const float (&dp)[4][4], const float* lse_s,
                                          const float* delta_s, int q0, int k0, float* Ps,
                                          float* dSs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float L = lse_s[r], dl = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kc = tx + 16 * j;
      const float pf = visible(p, q0 + r, k0 + kc) ? expf(s[i][j] * p.scale - L) : 0.0f;
      if (Ps != nullptr) Ps[r * kPLD + kc] = round_t<T>(pf);
      dSs[r * kPLD + kc] = round_t<T>(pf * (dp[i][j] - dl) * p.scale);
    }
  }
}

// s and dp of a (query tile, key tile) pair from the four operand tiles,
// then p_ds_tile
template <typename T, int D>
__device__ __forceinline__ void tile_p_ds(const FlashParams& p, const T* Qs, const T* dOs,
                                          const T* Ks, const T* Vs, const float* lse_s,
                                          const float* delta_s, int q0, int k0, float* Ps,
                                          float* dSs) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  float s[4][4] = {}, dp[4][4] = {};
  tile_dot<T, D>(Qs, Ks, tx, ty, s);
  tile_dot<T, D>(dOs, Vs, tx, ty, dp);
  p_ds_tile<T>(p, s, dp, lse_s, delta_s, q0, k0, Ps, dSs);
}

// FULL: d == D and every operand row aligned (FlashParams.vec)
template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(const FlashParams p) {
  constexpr int LD = D + 4, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBN * LD;
  T* Qs = Vs + kBN * LD;
  T* dOs = Qs + kBM * LD;
  float* Ps = reinterpret_cast<float*>(dOs + kBM * LD);
  float* dSs = Ps + kBM * kPLD;
  float* lse_s = dSs + kBM * kPLD;
  float* delta_s = lse_s + kBM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;  // grid (b * h, key tiles)
  const int k0 = blockIdx.y * kBN;
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* o = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;

  load_tile<T, D, kBN, FULL>(Ks, k, p.sk[2], k0, p.tk, p.d, vec);
  load_tile<T, D, kBN, FULL>(Vs, v, p.sv[2], k0, p.tk, p.d, vec);
  cp_async_commit();
  // causal: query tiles before the first row that sees key k0 add nothing
  int qt = 0;
  if (p.causal) {
    const int first_row = k0 - (p.tk - p.tq);
    qt = first_row <= 0 ? 0 : first_row / kBM;
  }
  float dk[4][NC][4] = {}, dv[4][NC][4] = {};
  for (; qt * kBM < p.tq; ++qt) {
    const int q0 = qt * kBM;
    load_tile<T, D, kBM, FULL>(Qs, q, p.sq[2], q0, p.tq, p.d, vec);
    load_tile<T, D, kBM, FULL>(dOs, dout, p.sdo[2], q0, p.tq, p.d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_lse_delta<T, D, FULL>(p, o, dOs, lse, q0, lse_s, delta_s);
    __syncthreads();
    tile_p_ds<T, D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, Ps, dSs);
    __syncthreads();
    tile_ptx<T, D>(Ps, dOs, tx, ty, dv);
    tile_ptx<T, D>(dSs, Qs, tx, ty, dk);
    __syncthreads();  // the next query tile overwrites Qs, dOs, Ps, dSs
  }
  cp_async_wait<0>();  // no query tile at all: the K/V loads still land first
  T* dkp = static_cast<T*>(p.dk) + (int64_t)bh * p.tk * p.d;
  T* dvp = static_cast<T*>(p.dv) + (int64_t)bh * p.tk * p.d;
  store_rows<T, D, FULL>(dkp, k0, p.tk, p.d, p.d, tx, ty, dk);
  store_rows<T, D, FULL>(dvp, k0, p.tk, p.d, p.d, tx, ty, dv);
}

template <typename T, int D, bool FULL>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(const FlashParams p) {
  constexpr int LD = D + 4, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBM * LD;
  T* Ks = dOs + kBM * LD;
  T* Vs = Ks + kBN * LD;
  float* dSs = reinterpret_cast<float*>(Vs + kBN * LD);
  float* lse_s = dSs + kBM * kPLD;
  float* delta_s = lse_s + kBM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;  // grid (b * h, query tiles)
  // causal: the last query tiles have the most keys, so they start first
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBM;
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* o = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;

  float dq[4][NC][4] = {};
  const int n_kt = key_tiles(p, q0);
  if (n_kt > 0) {
    load_tile<T, D, kBM, FULL>(Qs, q, p.sq[2], q0, p.tq, p.d, vec);
    load_tile<T, D, kBM, FULL>(dOs, dout, p.sdo[2], q0, p.tq, p.d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_lse_delta<T, D, FULL>(p, o, dOs, lse, q0, lse_s, delta_s);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    load_tile<T, D, kBN, FULL>(Ks, k, p.sk[2], k0, p.tk, p.d, vec);
    load_tile<T, D, kBN, FULL>(Vs, v, p.sv[2], k0, p.tk, p.d, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_p_ds<T, D>(p, Qs, dOs, Ks, Vs, lse_s, delta_s, q0, k0, nullptr, dSs);
    __syncthreads();
    tile_pv<T, D>(dSs, Ks, tx, ty, dq);
    __syncthreads();  // the next key tile overwrites Ks, Vs, dSs
  }
  T* dqp = static_cast<T*>(p.dq) + (int64_t)bh * p.tq * p.d;
  store_rows<T, D, FULL>(dqp, q0, p.tq, p.d, p.d, tx, ty, dq);
}

// ---------------------------------------------------------------------------
// The pair at heads wider than kWide: column blocks, as the wide forward.
// Grid z is the output column block; s and dp walk all of d in kWide-wide
// chunks, in chunk order (every block forms the same p and ds), and each CTA
// stores its own kWide columns of dK and dV, or of dQ. delta = rowsum(dO * O)
// reads both rows from device memory over all of d.
// ---------------------------------------------------------------------------

// lse and delta of the query tile's rows, both rows read from device memory
// (four threads a row); rows at or past tq get 0
template <typename T>
__device__ __forceinline__ void tile_lse_delta_wide(const FlashParams& p, const T* o,
                                                    const T* dout, const float* lse, int q0,
                                                    float* lse_s, float* delta_s) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3, row = q0 + r;
  const bool vec = p.vec != 0;
  float acc = 0.0f;
  if (row < p.tq) {
    const T* orow = o + (int64_t)row * p.so[2];
    const T* drow = dout + (int64_t)row * p.sdo[2];
    for (int c = part * 4; c < p.d; c += 16) {
      float a[4], b[4];
      load4_row(orow, c, p.d, vec, a);
      load4_row(drow, c, p.d, vec, b);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc = fmaf(a[e], b[e], acc);
    }
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) {
    delta_s[r] = acc;
    lse_s[r] = row < p.tq ? lse[row] : 0.0f;
  }
}

// s and dp of rows q0.. and keys k0.. over all of d: each kWide chunk of q,
// dO, k and v staged in turn (Qs, dOs, Ks, Vs hold the last chunk after)
template <typename T>
__device__ __forceinline__ void wide_s_dp(const FlashParams& p, const T* q, const T* dout,
                                          const T* k, const T* v, T* Qs, T* dOs, T* Ks, T* Vs,
                                          int q0, int k0, float (&s)[4][4], float (&dp)[4][4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const bool vec = p.vec != 0;
  for (int c = 0; c * kWide < p.d; ++c) {
    const int w = min(kWide, p.d - c * kWide), at = c * kWide;
    load_tile<T, kWide, kBM, false>(Qs, q + at, p.sq[2], q0, p.tq, w, vec);
    load_tile<T, kWide, kBM, false>(dOs, dout + at, p.sdo[2], q0, p.tq, w, vec);
    load_tile<T, kWide, kBN, false>(Ks, k + at, p.sk[2], k0, p.tk, w, vec);
    load_tile<T, kWide, kBN, false>(Vs, v + at, p.sv[2], k0, p.tk, w, vec);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    tile_dot<T, kWide>(Qs, Ks, tx, ty, s);
    tile_dot<T, kWide>(dOs, Vs, tx, ty, dp);
    __syncthreads();  // the next chunk overwrites the tiles
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_wide_kernel(const FlashParams p) {
  constexpr int D = kWide, LD = D + 4, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kBN * LD;
  T* Qs = Vs + kBN * LD;
  T* dOs = Qs + kBM * LD;
  float* Ps = reinterpret_cast<float*>(dOs + kBM * LD);
  float* dSs = Ps + kBM * kPLD;
  float* lse_s = dSs + kBM * kPLD;
  float* delta_s = lse_s + kBM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;  // grid (b * h, key tiles, blocks)
  const int k0 = blockIdx.y * kBN, c0 = blockIdx.z * D, cols = min(D, p.d - c0);
  const bool last_chunk = c0 + D >= p.d, vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* o = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;

  int qt = 0;
  if (p.causal) {
    const int first_row = k0 - (p.tk - p.tq);
    qt = first_row <= 0 ? 0 : first_row / kBM;
  }
  float dk[4][NC][4] = {}, dv[4][NC][4] = {};
  for (; qt * kBM < p.tq; ++qt) {
    const int q0 = qt * kBM;
    float s[4][4] = {}, dp[4][4] = {};
    wide_s_dp<T>(p, q, dout, k, v, Qs, dOs, Ks, Vs, q0, k0, s, dp);
    if (!last_chunk) {  // this block's columns of q and dO, for dK and dV
      load_tile<T, D, kBM, false>(Qs, q + c0, p.sq[2], q0, p.tq, cols, vec);
      load_tile<T, D, kBM, false>(dOs, dout + c0, p.sdo[2], q0, p.tq, cols, vec);
      cp_async_commit();
    }
    tile_lse_delta_wide<T>(p, o, dout, lse, q0, lse_s, delta_s);
    cp_async_wait<0>();
    __syncthreads();
    p_ds_tile<T>(p, s, dp, lse_s, delta_s, q0, k0, Ps, dSs);
    __syncthreads();
    tile_ptx<T, D>(Ps, dOs, tx, ty, dv);
    tile_ptx<T, D>(dSs, Qs, tx, ty, dk);
    __syncthreads();  // the next query tile overwrites every tile
  }
  T* dkp = static_cast<T*>(p.dk) + (int64_t)bh * p.tk * p.d + c0;
  T* dvp = static_cast<T*>(p.dv) + (int64_t)bh * p.tk * p.d + c0;
  store_rows<T, D, false>(dkp, k0, p.tk, p.d, cols, tx, ty, dk);
  store_rows<T, D, false>(dvp, k0, p.tk, p.d, cols, tx, ty, dv);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_wide_kernel(const FlashParams p) {
  constexpr int D = kWide, LD = D + 4, NC = D / 64;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = Qs + kBM * LD;
  T* Ks = dOs + kBM * LD;
  T* Vs = Ks + kBN * LD;
  float* dSs = reinterpret_cast<float*>(Vs + kBN * LD);
  float* lse_s = dSs + kBM * kPLD;
  float* delta_s = lse_s + kBM;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;  // grid (b * h, query tiles, blocks)
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kBM;
  const int c0 = blockIdx.z * D, cols = min(D, p.d - c0);
  const bool last_chunk = c0 + D >= p.d, vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* o = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;

  float dq[4][NC][4] = {};
  const int n_kt = key_tiles(p, q0);
  if (n_kt > 0) tile_lse_delta_wide<T>(p, o, dout, lse, q0, lse_s, delta_s);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBN;
    float s[4][4] = {}, dp[4][4] = {};
    wide_s_dp<T>(p, q, dout, k, v, Qs, dOs, Ks, Vs, q0, k0, s, dp);
    if (!last_chunk) {  // this block's columns of k, for dQ
      load_tile<T, D, kBN, false>(Ks, k + c0, p.sk[2], k0, p.tk, cols, vec);
      cp_async_commit();
    }
    p_ds_tile<T>(p, s, dp, lse_s, delta_s, q0, k0, nullptr, dSs);
    cp_async_wait<0>();
    __syncthreads();
    tile_pv<T, D>(dSs, Ks, tx, ty, dq);
    __syncthreads();  // the next key tile overwrites Ks and dSs
  }
  T* dqp = static_cast<T*>(p.dq) + (int64_t)bh * p.tq * p.d + c0;
  store_rows<T, D, false>(dqp, q0, p.tq, p.d, cols, tx, ty, dq);
}

// ---------------------------------------------------------------------------
// The fused backward tier: one CTA per (b * h, 128-key tile), five products
// on the tensor cores (3xTF32 for f32, one exact TF32 product for bf16).
// ---------------------------------------------------------------------------

constexpr int kFD = 64;         // padded head width of the fused tier (d <= 64)
constexpr int kFBN = 128;       // keys a CTA: K and V stay resident
constexpr int kFBM = 64;        // query rows a streamed tile
constexpr int kFThreads = 256;  // 8 warps

// Element (r, c) of a row-major tile of W columns (W a multiple of 32), its
// 4-element units XOR-swizzled by row: the mma fragment reads of both
// orientations (8 rows x 4 columns, and 4 rows x 8 columns, from a row that
// is a multiple of 8) then hit 32 distinct banks for f32 and 16 distinct
// words for bf16, and a unit stays contiguous for cp.async.
__device__ __forceinline__ int swz(int r, int c, int w) {
  return r * w + (c ^ ((((r & 3) << 1) | ((r >> 2) & 1)) << 2));
}

// rows [r0, r0 + R) of a (t, d) operand with row stride `st` into a
// swizzled [R][kFD] tile; rows at or past t, and columns at or past d, read
// as zeros
// FULL: d == kFD and every row aligned (FlashParams.vec), so whole units
// copy by cp.async with no column test
template <typename T, int R, bool FULL>
__device__ __forceinline__ void load_swz(T* dst, const T* src, int64_t st, int r0, int t, int d,
                                         bool vec) {
  constexpr int G = kFD / 4;
  for (int i = threadIdx.x; i < R * G; i += kFThreads) {
    const int r = i / G, c = (i % G) * 4;
    const bool ok = r0 + r < t;
    if constexpr (FULL) {
      const T* from = src + (ok ? (int64_t)(r0 + r) * st + c : 0);
      cp_async<(int)(4 * sizeof(T))>(dst + swz(r, c, kFD), from, ok);
    } else {
      load_unit(dst + swz(r, c, kFD), src + (ok ? (int64_t)(r0 + r) * st : 0), ok, c, d, vec);
    }
  }
}

// the first query tile whose rows see key k0 (causal); 0 otherwise
__device__ __forceinline__ int first_query_tile(const FlashParams& p, int k0) {
  if (!p.causal) return 0;
  const int first_row = k0 - (p.tk - p.tq);
  return first_row <= 0 ? 0 : first_row / kFBM;
}

// acc[i][j] = A(m0 + 16i.., k) B(k, n0 + 8j..) over k in [0, K): the warp's
// (16 MT) x (8 NT) tile of a product whose operands are read through
// `a(row, k)` and `b(k, col)`, each returning an f32 operand value. The
// product sums in the tensor core from 0; a caller that carries a sum over
// several products adds it in f32 (the tensor core's sums truncate).
template <bool SPLIT, int MT, int NT, int K, typename FA, typename FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MT][NT][4], int m0, int n0, FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int k = 0; k < K; k += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tf32::split<SPLIT>(b(k + t, n0 + 8 * j + g), bh[j][0], bl[j][0]);
      tf32::split<SPLIT>(b(k + t + 4, n0 + 8 * j + g), bh[j][1], bl[j][1]);
    }
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = m0 + 16 * i + g;
      tf32::split<SPLIT>(a(r, k + t), ah[i][0], al[i][0]);
      tf32::split<SPLIT>(a(r + 8, k + t), ah[i][1], al[i][1]);
      tf32::split<SPLIT>(a(r, k + t + 4), ah[i][2], al[i][2]);
      tf32::split<SPLIT>(a(r + 8, k + t + 4), ah[i][3], al[i][3]);
    }
    if (k == 0) tf32::mma_tiles<SPLIT, MT, NT, true>(acc, ah, al, bh, bl);
    else tf32::mma_tiles<SPLIT>(acc, ah, al, bh, bl);
  }
}

// warp_mma with A an f32 swizzled [*][W] tile read in place (row m, column
// k) by ldmatrix: each lane names the 4-word unit of row (l & 7) +
// 8 ((l >> 3) & 1), column k + 4 (l >> 4), and receives (g, t) of each of
// the four 8 x 4 matrices, which is the A fragment
template <bool SPLIT, int MT, int NT, int K, int W, typename FB>
__device__ __forceinline__ void warp_mma_ldsm(float (&acc)[MT][NT][4], int m0, int n0,
                                              const float* a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1), lcol = 4 * (lane >> 4);
#pragma unroll
  for (int k = 0; k < K; k += 8) {
    uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      tf32::split<SPLIT>(b(k + t, n0 + 8 * j + g), bh[j][0], bl[j][0]);
      tf32::split<SPLIT>(b(k + t + 4, n0 + 8 * j + g), bh[j][1], bl[j][1]);
    }
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      uint32_t r[4];
      tf32::ldmatrix_x4(r, a + swz(m0 + 16 * i + lrow, k + lcol, W));
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split<SPLIT>(__uint_as_float(r[e]), ah[i][e], al[i][e]);
    }
    if (k == 0) tf32::mma_tiles<SPLIT, MT, NT, true>(acc, ah, al, bh, bl);
    else tf32::mma_tiles<SPLIT>(acc, ah, al, bh, bl);
  }
}

// acc = A B with A a row-major swizzled [*][kFD] operand tile of type T: in
// place by ldmatrix for f32, element by element for bf16
template <typename T, int MT, int NT, int K, typename FB>
__device__ __forceinline__ void warp_mma_tile(float (&acc)[MT][NT][4], int m0, int n0,
                                              const T* a, FB b) {
  constexpr bool kSplit = tf32::needs_split<T>();
  if constexpr (sizeof(T) == 4) {
    warp_mma_ldsm<kSplit, MT, NT, K, kFD>(acc, m0, n0, a, b);
  } else {
    warp_mma<kSplit, MT, NT, K>(
        acc, m0, n0, [&](int r, int c) { return to_f32(a[swz(r, c, kFD)]); }, b);
  }
}

template <int MT, int NT> __device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
}

template <int MT, int NT>
__device__ __forceinline__ void add_to(float (&acc)[MT][NT][4], const float (&x)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] += x[i][j][e];
}

// one (b, h)'s dQ: the key tiles' f32 partials (kFD wide) summed in
// key-tile order (a tile that skipped a row's query tile has none for it:
// the valid tiles of a row are a prefix), rounded once and stored at row
// stride d, the columns past d dropped. The CTA's threads each take
// 4-element units, four at a time, all their loads in flight together.
template <typename T, bool FULL>
__device__ __forceinline__ void sum_dq(const FlashParams& p, const float* __restrict__ dq_part,
                                       int bh, int tid) {
  const int d = FULL ? kFD : p.d;
  constexpr int kU = kFD / 4;  // units a row
  constexpr int kBatch = 4;
  const int nk = (p.tk + kFBN - 1) / kFBN;
  const int64_t part_stride = (int64_t)p.b * p.h * p.tq * kFD;
  const float* src = dq_part + (int64_t)bh * p.tq * kFD;
  T* dst = static_cast<T*>(p.dq) + (int64_t)bh * p.tq * d;
  for (int base = tid; base < p.tq * kU; base += kBatch * kFThreads) {
    float4 s[kBatch];
    int parts[kBatch];
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int u = base + e * kFThreads;
      parts[e] = 0;
      s[e] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (u >= p.tq * kU) continue;
      while (parts[e] < nk && first_query_tile(p, parts[e] * kFBN) <= (u / kU) / kFBM) ++parts[e];
      if (parts[e] > 0) s[e] = __ldcg(reinterpret_cast<const float4*>(src) + u);
    }
    for (int kb = 1; kb < nk; ++kb) {
#pragma unroll
      for (int e = 0; e < kBatch; ++e) {
        if (kb >= parts[e]) continue;
        const float4 v = __ldcg(reinterpret_cast<const float4*>(src + kb * part_stride) +
                                base + e * kFThreads);
        s[e].x += v.x; s[e].y += v.y; s[e].z += v.z; s[e].w += v.w;
      }
    }
#pragma unroll
    for (int e = 0; e < kBatch; ++e) {
      const int u = base + e * kFThreads;
      if (u >= p.tq * kU) continue;
      const int c = (u % kU) * 4;
      T* row = dst + (int64_t)(u / kU) * d + c;
      const float x[4] = {s[e].x, s[e].y, s[e].z, s[e].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (FULL || c + i < d) row[i] = from_f32<T>(x[i]);
    }
  }
}

// FULL: d == kFD and every operand row loads as aligned 4-element units
// (FlashParams.vec), the training path's case, built without the column
// tests and the element-by-element loads of other widths
template <typename T, bool FULL>
__global__ void __launch_bounds__(kFThreads, 1)
flash_bwd_fused_kernel(const FlashParams p, float* __restrict__ dq_part, int* arrivals) {
  constexpr bool kSplit = tf32::needs_split<T>();
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + kFBN * kFD;
  T* Qs = Vs + kFBN * kFD;      // two stages
  T* dOs = Qs + 2 * kFBM * kFD;  // two stages
  float* Ps = reinterpret_cast<float*>(dOs + 2 * kFBM * kFD);
  float* dSs = Ps + kFBM * kFBN;
  float* lse_s = dSs + kFBM * kFBN;
  float* delta_s = lse_s + kFBM;
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // grid (b * h, key tiles): every (b, h)'s first key tile (causal: the
  // one with the most query tiles) starts before any second one
  const int n_bh = gridDim.x, nk = gridDim.y;
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  const int kt = blockIdx.y, k0 = kt * kFBN;
  const int d = FULL ? kFD : p.d;  // the output rows' stride
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* o = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;
  float* dqp = dq_part + ((int64_t)kt * n_bh + bh) * p.tq * kFD;

  const int nq = (p.tq + kFBM - 1) / kFBM;
  const int qt0 = first_query_tile(p, k0);
  load_swz<T, kFBN, FULL>(Ks, k, p.sk[2], k0, p.tk, d, vec);
  load_swz<T, kFBN, FULL>(Vs, v, p.sv[2], k0, p.tk, d, vec);
  if (qt0 < nq) {
    load_swz<T, kFBM, FULL>(Qs, q, p.sq[2], qt0 * kFBM, p.tq, d, vec);
    load_swz<T, kFBM, FULL>(dOs, dout, p.sdo[2], qt0 * kFBM, p.tq, d, vec);
  }
  cp_async_commit();

  // delta = rowsum(dO * O) and lse of a query tile: four threads a row, the
  // O row and the lse of the next tile held in registers ahead of use
  const int d_row = tid >> 2, d_part = tid & 3;
  float o_pf[4][4], lse_pf = 0.0f;
  auto prefetch = [&](int qt) {
    const int row = qt * kFBM + d_row;
    const bool ok = qt < nq && row < p.tq;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (ok) {
        const T* orow = o + (int64_t)row * p.so[2];
        if constexpr (FULL) load4(orow + 4 * d_part + 16 * j, o_pf[j]);
        else load4_row(orow, 4 * d_part + 16 * j, d, vec, o_pf[j]);
      } else {
        o_pf[j][0] = o_pf[j][1] = o_pf[j][2] = o_pf[j][3] = 0.0f;
      }
    }
    lse_pf = ok ? lse[row] : 0.0f;
  };
  prefetch(qt0);

  // dK, dV: warps 4 (keys) x 2 (d), 32 x 32 each
  const int wk0 = (warp >> 1) * 32, wd0 = (warp & 1) * 32;
  float dk[2][4][4], dv[2][4][4];
  zero(dk);
  zero(dv);

  for (int qt = qt0; qt < nq; ++qt) {
    const int q0 = qt * kFBM;
    const T* Qb = Qs + ((qt - qt0) & 1) * kFBM * kFD;
    const T* dOb = dOs + ((qt - qt0) & 1) * kFBM * kFD;
    cp_async_wait<0>();
    __syncthreads();  // tile qt is here, and the previous tile is done with
    if (qt + 1 < nq) {  // the next tile's copies run under this one's math
      const int nb = (qt + 1 - qt0) & 1;
      load_swz<T, kFBM, FULL>(Qs + nb * kFBM * kFD, q, p.sq[2], q0 + kFBM, p.tq, d, vec);
      load_swz<T, kFBM, FULL>(dOs + nb * kFBM * kFD, dout, p.sdo[2], q0 + kFBM, p.tq, d, vec);
    }
    cp_async_commit();
    {
      float acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float dov[4];
        load4(dOb + swz(d_row, 4 * d_part + 16 * j, kFD), dov);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc = fmaf(o_pf[j][e], dov[e], acc);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (d_part == 0) {
        delta_s[d_row] = acc;
        lse_s[d_row] = lse_pf;
      }
    }
    prefetch(qt + 1);
    __syncthreads();

    // s = q k^T and dp = dO v^T: warps 2 (queries) x 4 (keys), 32 x 32 each
    {
      const int wq0 = (warp >> 2) * 32, wn0 = (warp & 3) * 32;
      float s[2][4][4], dp[2][4][4];
      warp_mma_tile<T, 2, 4, kFD>(s, wq0, wn0, Qb,
                                  [&](int c, int n) { return to_f32(Ks[swz(n, c, kFD)]); });
      warp_mma_tile<T, 2, 4, kFD>(dp, wq0, wn0, dOb,
                                  [&](int c, int n) { return to_f32(Vs[swz(n, c, kFD)]); });
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = wq0 + 16 * i + g + 8 * h;
          const float L = lse_s[r], dl = delta_s[r];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = wn0 + 8 * j + 2 * t;
            float pv[2], dsv[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float pf = visible(p, q0 + r, k0 + c + e)
                                   ? expf(s[i][j][2 * h + e] * p.scale - L) : 0.0f;
              pv[e] = round_t<T>(pf);
              dsv[e] = round_t<T>(pf * (dp[i][j][2 * h + e] - dl) * p.scale);
            }
            *reinterpret_cast<float2*>(Ps + swz(r, c, kFBN)) = make_float2(pv[0], pv[1]);
            *reinterpret_cast<float2*>(dSs + swz(r, c, kFBN)) = make_float2(dsv[0], dsv[1]);
          }
        }
    }
    __syncthreads();

    // dV += p^T dO, dK += ds^T q over the tile's 64 query rows, each tile's
    // part added in f32
    {
      float part[2][4][4];
      warp_mma<kSplit, 2, 4, kFBM>(
          part, wk0, wd0, [&](int key, int r) { return Ps[swz(r, key, kFBN)]; },
          [&](int r, int c) { return to_f32(dOb[swz(r, c, kFD)]); });
      add_to(dv, part);
      warp_mma<kSplit, 2, 4, kFBM>(
          part, wk0, wd0, [&](int key, int r) { return dSs[swz(r, key, kFBN)]; },
          [&](int r, int c) { return to_f32(Qb[swz(r, c, kFD)]); });
      add_to(dk, part);
    }
    // this key tile's dQ partial, ds k: warps 2 (queries) x 4 (d), 32 x 16
    {
      const int wq0 = (warp >> 2) * 32, wn0 = (warp & 3) * 16;
      float dq[2][2][4];
      warp_mma_ldsm<kSplit, 2, 2, kFBN, kFBN>(
          dq, wq0, wn0, dSs, [&](int key, int c) { return to_f32(Ks[swz(key, c, kFD)]); });
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = q0 + wq0 + 16 * i + g + 8 * h;
          if (row >= p.tq) continue;
#pragma unroll
          for (int j = 0; j < 2; ++j)
            *reinterpret_cast<float2*>(dqp + (int64_t)row * kFD + wn0 + 8 * j + 2 * t) =
                make_float2(dq[i][j][2 * h], dq[i][j][2 * h + 1]);
        }
    }
  }
  cp_async_wait<0>();  // no query tile at all: the K/V copies still land first

  T* dkp = static_cast<T*>(p.dk) + (int64_t)bh * p.tk * d;
  T* dvp = static_cast<T*>(p.dv) + (int64_t)bh * p.tk * d;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + wk0 + 16 * i + g + 8 * h;
      if (key >= p.tk) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wd0 + 8 * j + 2 * t + e;
          if (!FULL && c >= d) continue;
          const int64_t at = (int64_t)key * d + c;
          dkp[at] = from_f32<T>(dk[i][j][2 * h + e]);
          dvp[at] = from_f32<T>(dv[i][j][2 * h + e]);
        }
    }

  // the last key tile of this (b, h) to finish sums its dQ: every partial
  // is written and fenced before the count moves
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(arrivals + bh, 1) == nk - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  sum_dq<T, FULL>(p, dq_part, bh, tid);
  if (tid == 0) arrivals[bh] = 0;  // ready for the next launch on this stream
}

template <typename T> constexpr size_t fused_smem() {
  return (size_t)(2 * kFBN + 4 * kFBM) * kFD * sizeof(T) +
         (size_t)(2 * kFBM * kFBN + 2 * kFBM) * sizeof(float);
}
static_assert(fused_smem<float>() <= 232448 - 1024, "fused backward tile too large");

template <typename T, int DP> constexpr size_t fwd_smem() {
  return (size_t)(kBM + 4 * kBN) * DP * sizeof(T);
}
template <typename T, int D> constexpr size_t dkv_smem() {
  return (size_t)(2 * kBM + 2 * kBN) * (D + 4) * sizeof(T) +
         (size_t)(2 * kBM * kPLD + 2 * kBM) * sizeof(float);
}
template <typename T, int D> constexpr size_t dq_smem() {
  return (size_t)(2 * kBM + 2 * kBN) * (D + 4) * sizeof(T) +
         (size_t)(kBM * kPLD + 2 * kBM) * sizeof(float);
}

// the wide forward's ring: two stages of two [64][kWide] tiles
template <typename T> constexpr size_t fwd_wide_smem() {
  return (size_t)4 * kBM * kWide * sizeof(T);
}

// every configuration fits one CTA under the card's 227 KB
static_assert(fwd_smem<float, 128>() <= 232448, "forward tile too large");
static_assert(fwd_wide_smem<float>() <= 232448, "wide forward ring too large");
static_assert(dkv_smem<float, 128>() <= 232448, "dK/dV tile too large");

// Opt the kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// the forward's grid: its 64-row query tiles for each (b, h) pair
inline unsigned grid_x(const FlashParams& p) {
  return (unsigned)(((p.tq + kBM - 1) / kBM) * (int64_t)p.b * p.h);
}

template <typename T, int DP>
cudaError_t fwd_typed(const FlashParams& p, cudaStream_t st) {
  constexpr size_t bytes = fwd_smem<T, DP>();
  cudaError_t err = prepare(flash_fwd_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T, DP><<<grid_x(p), kFwdThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

// column blocks of a wide head (grid y of the forward, z of the pair)
inline unsigned wide_blocks(const FlashParams& p) { return (unsigned)((p.d + kWide - 1) / kWide); }

template <typename T>
cudaError_t fwd_width(const FlashParams& p, cudaStream_t st) {
  if (p.d <= 32) return fwd_typed<T, 32>(p, st);
  if (p.d <= 64) return fwd_typed<T, 64>(p, st);
  if (p.d <= 128) return fwd_typed<T, 128>(p, st);
  constexpr size_t bytes = fwd_wide_smem<T>();
  cudaError_t err = prepare(flash_fwd_wide_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_wide_kernel<T><<<dim3(grid_x(p), wide_blocks(p)), kFwdThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool FULL>
cudaError_t bwd_typed(const FlashParams& p, cudaStream_t st) {
  constexpr size_t kv_bytes = dkv_smem<T, D>();
  cudaError_t err = prepare(flash_bwd_dkv_kernel<T, D, FULL>, kv_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, D, FULL>
      <<<dim3(p.b * p.h, (p.tk + kBN - 1) / kBN), kThreads, kv_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr size_t q_bytes = dq_smem<T, D>();
  err = prepare(flash_bwd_dq_kernel<T, D, FULL>, q_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, D, FULL>
      <<<dim3(p.b * p.h, (p.tq + kBM - 1) / kBM), kThreads, q_bytes, st>>>(p);
  return cudaGetLastError();
}

// the built width D >= d; FULL where d == D and every row is aligned
template <typename T, int D>
cudaError_t bwd_full(const FlashParams& p, cudaStream_t st) {
  return p.d == D && p.vec ? bwd_typed<T, D, true>(p, st) : bwd_typed<T, D, false>(p, st);
}

// heads past kWide: the wide pair, one CTA per output column block
template <typename T>
cudaError_t bwd_wide(const FlashParams& p, cudaStream_t st) {
  constexpr size_t kv_bytes = dkv_smem<T, kWide>(), q_bytes = dq_smem<T, kWide>();
  cudaError_t err = prepare(flash_bwd_dkv_wide_kernel<T>, kv_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_wide_kernel<T>
      <<<dim3(p.b * p.h, (p.tk + kBN - 1) / kBN, wide_blocks(p)), kThreads, kv_bytes, st>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = prepare(flash_bwd_dq_wide_kernel<T>, q_bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_wide_kernel<T>
      <<<dim3(p.b * p.h, (p.tq + kBM - 1) / kBM, wide_blocks(p)), kThreads, q_bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_width(const FlashParams& p, cudaStream_t st) {
  if (p.d <= 64) return bwd_full<T, 64>(p, st);
  if (p.d <= 128) return bwd_full<T, 128>(p, st);
  return bwd_wide<T>(p, st);
}

template <typename T, bool FULL>
cudaError_t bwd_fused_typed(const FlashParams& p, float* dq_part, int* arrivals,
                            cudaStream_t st) {
  constexpr size_t bytes = fused_smem<T>();
  cudaError_t err = prepare(flash_bwd_fused_kernel<T, FULL>, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.b * p.h, (p.tk + kFBN - 1) / kFBN);
  flash_bwd_fused_kernel<T, FULL><<<grid, kFThreads, bytes, st>>>(p, dq_part, arrivals);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_fused_rows(const FlashParams& p, float* dq_part, int* arrivals,
                           cudaStream_t st) {
  return p.d == kFD && p.vec ? bwd_fused_typed<T, true>(p, dq_part, arrivals, st)
                             : bwd_fused_typed<T, false>(p, dq_part, arrivals, st);
}

// any d >= 1; the forward's grid x, its 64-row tiles x (b * h), within
// 2^31 - 1, the backward's 64-row tiles within grid y's 65535, and a wide
// head's column blocks within 65535
bool shape_ok(const FlashParams& p) {
  if (p.b <= 0 || p.h <= 0 || p.tq <= 0 || p.tk <= 0 || p.d < 1) return false;
  const int64_t q_tiles = (p.tq + kBM - 1) / kBM, k_tiles = (p.tk + kBN - 1) / kBN;
  return q_tiles * p.b * p.h <= 2147483647LL && q_tiles <= 65535 && k_tiles <= 65535 &&
         wide_blocks(p) <= 65535 && (p.dtype == 0 || p.dtype == 1);
}

}  // namespace

extern "C" {

// q, k, v (b, h, t, d), strided -> out (b, h, tq, d), lse_out (b, h, tq)
int flash_attention_fwd(const FlashParams* p, void* stream) {
  if (p == nullptr || !shape_ok(*p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return (int)fwd_width<float>(*p, st);
  return (int)fwd_width<__nv_bfloat16>(*p, st);
}

// q, k, v, o, dout (strided), lse -> dq (b, h, tq, d), dk, dv (b, h, tk, d):
// the dK/dV kernel, then the dQ kernel
int flash_attention_bwd(const FlashParams* p, void* stream) {
  if (p == nullptr || !shape_ok(*p)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return (int)bwd_width<float>(*p, st);
  return (int)bwd_width<__nv_bfloat16>(*p, st);
}

// The fused tier (d <= 64): q, k, v, o, dout (strided), lse -> dq, dk, dv, with
// dq_part an f32 scratch of ceil(tk / 128) x (b, h, tq, 64) for the key
// tiles' dQ partials. arrivals: b * h ints, all 0, which the last key tile
// of each (b, h) uses to find itself and sum dQ (and leaves at 0).
int flash_attention_bwd_fused(const FlashParams* p, float* dq_part, int* arrivals,
                              void* stream) {
  if (p == nullptr || !shape_ok(*p) || p->d > kFD || dq_part == nullptr || arrivals == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return (int)bwd_fused_rows<float>(*p, dq_part, arrivals, st);
  return (int)bwd_fused_rows<__nv_bfloat16>(*p, dq_part, arrivals, st);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
