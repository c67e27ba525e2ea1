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
// with row stride d. Heads of 129 to 512 take the wide forward
// (flash_fwd_wide_kernel, below): two groups of four warps share a
// resident query tile, each forming half of q k^T and keeping 128 output
// columns, so the scores are formed once per 256-wide column block (grid
// y). Wider heads take column blocks of 128 (flash_fwd_chunked_kernel), as
// the pair does at every d past 128 (its kernels at DP = 128 with nc > 1
// chunks, grid z): each CTA forms the scores over all of d in 128-wide
// chunks, in chunk order, so every block sees the same p, and keeps its own
// 128 columns of p v (or of dK / dV / dQ); block 0 writes lse. The fused
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
// takes delta = rowsum(dO * O) from the saved output, and forms
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
// The pair: delta = rowsum(dO * O) once per query row, by a small kernel,
// into an f32 (b, h, tq) scratch that both kernels read beside lse; then
// the five products on the tensor cores with the fused tier's helpers
// (3xTF32 mma.sync m16n8k8 for f32, one exact TF32 product for bf16; the
// swz tile layout). The pair has no float atomics: dK/dV is one CTA of 8
// warps per 64-key tile looping over 64-row query tiles, dQ one per query
// tile looping over the key tiles, so each sum has one owner; the price is
// s and dp formed in both kernels, seven products for five. Each CTA keeps
// its own side resident in shared memory (K and V, or q and dO, over every
// 128-wide chunk where that fits beside the ring: all of d up to 128, d =
// 256 in f32 and 512 in bf16; else staged beside the streamed tiles, chunk
// by chunk) and streams the other side's tiles through a cp.async ring of
// two stages (one where shared memory allows no more), one CTA barrier a
// step. s and dp stay in registers as C fragments (warps 2 x 4 over 64 x
// 64); p and ds, rounded to the operand dtype, go to f32 swizzled tiles,
// which dV = p^T dO and dK = ds^T q read transposed and dQ = ds k reads by
// ldmatrix. Each streamed tile's part sums in the tensor core from 0 and
// joins the f32 registers by a rounded add.
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
constexpr int kFwdThreads = 128;  // the forward: 4 warps of 16 query rows
constexpr int kWide = 128;  // a wide head's column block (heads past 128)
constexpr int kWideThreads = 256;  // the wide forward: two groups of 4 warps
constexpr int kWideMaxD = 512;     // the widest head whose query tile stays resident
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

// s = q k^T of a warp's 16 rows (from w0 of the swizzled [*][LD] tile Qs)
// and the 8 KN keys of the swizzled [8 KN][LD] tile Kb, over the DEPTH
// columns from c0, summed in the tensor core from 0
template <typename T, int LD, int DEPTH = LD, int KN = kBN / 8>
__device__ __forceinline__ void qk_scores(float (&s)[1][KN][4], const T* Qs, const T* Kb, int w0,
                                          int c0 = 0) {
  constexpr bool kSplit = tf32::needs_split<T>();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // ldmatrix: lane l names row (l & 7) + 8 ((l >> 3) & 1), column 4 (l >> 4)
  // of the A fragment's four 8 x 4 matrices; for the B fragments of k, row
  // (l & 7) + 8 (l >> 4), column 4 ((l >> 3) & 1): b0, b1 of two 8-key tiles
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 4 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int k8 = 0; k8 < DEPTH; k8 += 8) {
    const int kk = c0 + k8;
    uint32_t ah[1][4], al[1][4], bh[KN][2], bl[KN][2];
    if constexpr (sizeof(T) == 4) {
      uint32_t r[4];
      tf32::ldmatrix_x4(r, Qs + sw(w0 + arow, kk + acol, LD));
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split<kSplit>(__uint_as_float(r[e]), ah[0][e], al[0][e]);
#pragma unroll
      for (int j = 0; j < KN; j += 2) {
        tf32::ldmatrix_x4(r, Kb + sw(8 * j + brow, kk + bcol, LD));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split<kSplit>(__uint_as_float(r[e]), bh[j + e / 2][e & 1], bl[j + e / 2][e & 1]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        tf32::split<kSplit>(to_f32(Qs[sw(w0 + g + 8 * (e & 1), kk + t + 4 * (e >> 1), LD)]),
                            ah[0][e], al[0][e]);
#pragma unroll
      for (int j = 0; j < KN; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tf32::split<kSplit>(to_f32(Kb[sw(8 * j + g, kk + t + 4 * e, LD)]), bh[j][e], bl[j][e]);
    }
    if (k8 == 0) tf32::mma_tiles<kSplit, 1, KN, true>(s, ah, al, bh, bl);
    else tf32::mma_tiles<kSplit, 1, KN>(s, ah, al, bh, bl);
  }
}

// One key tile of the forward for a warp's 16 rows: the online softmax on
// the scores s of keys k0.. (C fragments: s[0][j][2h + e] is row row[h], key
// k0 + 8j + 2t + e; masked here), then o += p v over columns [vc0, vc0 + DP)
// of the swizzled [8 KN][VW] tile Vb (DP / 8 output tiles of 8 columns), the
// tile's part summed from 0
template <typename T, int DP, int KN = kBN / 8, int VW = DP>
__device__ __forceinline__ void softmax_pv(const FlashParams& p, float (&s)[1][KN][4],
                                           float (&o)[DP / 8][4], float (&m)[2], float (&l)[2],
                                           const T* Vb, int k0, int q0, int w0,
                                           const int (&row)[2], float scale2, int vc0 = 0) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int NO = DP / 8;           // 8-column tiles of a warp's output
  constexpr int NB = NO < 8 ? NO : 8;  // of them in one pass of p v
  constexpr int BN = 8 * KN;           // keys of the tile
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool edge = k0 + BN > p.tk || q0 + w0 + 16 > p.tq ||
                    (p.causal && k0 + BN - 1 > q0 + w0 + (p.tk - p.tq));
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
          tf32::split<kSplit>(to_f32(Vb[sw(8 * j + 2 * t + e, vc0 + 8 * (n0 + c) + g, VW)]),
                              bh[c][e], bl[c][e]);
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
  for (int i = threadIdx.x; i < kBM * cols; i += blockDim.x) {
    const int r = i / cols;
    if (q0 + r < p.tq) out[(int64_t)(q0 + r) * p.d + c0 + i % cols] = from_f32<T>(0.0f);
  }
  if (write_lse)
    for (int r = threadIdx.x; r < kBM; r += blockDim.x)
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

// a named barrier of n threads (whole warps), id 1-15 (0 is __syncthreads)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// the wide forward's shared memory at BN keys a stage: the resident query
// tile and two stages of K (DQ columns) and V (the block's 2 kWide)
template <typename T, int DQ> __host__ __device__ constexpr size_t wide_smem(int bn) {
  return ((size_t)kBM * DQ + 2 * (size_t)bn * (DQ + 2 * kWide)) * sizeof(T);
}
// keys a stage: the most of 64, 32, 16 that fit one CTA under 227 KB (f32:
// 32 at DQ = 256, 16 at 512; bf16: 64 and 32)
template <typename T, int DQ> __host__ __device__ constexpr int wide_keys() {
  return wide_smem<T, DQ>(64) <= 232448 ? 64 : wide_smem<T, DQ>(32) <= 232448 ? 32 : 16;
}
static_assert(wide_smem<float, kWideMaxD>(wide_keys<float, kWideMaxD>()) <= 232448,
              "the wide forward's widest f32 plan too large");


// Heads of 129 to kWideMaxD columns: one CTA of two groups of four warps
// per 64-row query tile (and, past 256, per 256-wide output column block,
// grid y). The query tile stays resident in shared memory for the whole
// walk; K (all DQ columns) and the block's 256 columns of V stream through
// a two-stage cp.async ring of BN-key stages. Warp w of group g owns rows
// 16w.. and output columns [128g, 128g + 128) of the block (64 registers a
// lane of O, as in the 128 build). Each group forms the partial q k^T over
// its own half of the DQ columns, summed in the tensor core from 0; once
// every warp of the group is done with the stage's K half (a named barrier
// of the group), each warp leaves its partial in that half of the K stage,
// its pair warp of the other group reads it (a named barrier of the pair),
// and both form s = s_0 + s_1, so both run the identical online softmax (the
// same s, m, l and p, bit for bit) and the scores are formed once per
// column block. Block 0's group 0 writes lse.
template <typename T, int DQ>
__global__ void __launch_bounds__(kWideThreads, 1) flash_fwd_wide_kernel(const FlashParams p) {
  constexpr int BN = wide_keys<T, DQ>(), KN = BN / 8, VW = 2 * kWide, HALF = DQ / 2;
  constexpr int RW = DQ * (int)sizeof(T) / 4;  // floats a K stage row spans
  static_assert(RW / 2 >= kBM && RW % 64 == 0, "a K half holds a group's partial scores");
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);  // [64][DQ], resident
  T* ring = Qs + kBM * DQ;             // two stages of K [BN][DQ] and V [BN][VW]

  const int n_bh = p.b * p.h;
  const int bh = blockIdx.x % n_bh, tile = blockIdx.x / n_bh;
  const int bi = bh / p.h, hi = bh % p.h;
  const int n_qt = (p.tq + kBM - 1) / kBM;
  const int q0 = (p.causal ? n_qt - 1 - tile : tile) * kBM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int grp = warp >> 2, w0 = (warp & 3) * 16;
  const int vb = blockIdx.y * VW;                                // the CTA's output columns
  const int c0 = vb + grp * kWide, cols = min(kWide, p.d - c0);  // the group's
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  T* out = static_cast<T*>(p.out) + (int64_t)bh * p.tq * p.d;
  float* lse = p.lse_out + (int64_t)bh * p.tq;

  // key stages the tile needs: all, or (causal) up to its last row's last key
  int n_st = (p.tk + BN - 1) / BN;
  if (p.causal) {
    const int last_key = min(q0 + kBM, p.tq) - 1 + (p.tk - p.tq);
    n_st = last_key < 0 ? 0 : min(n_st, last_key / BN + 1);
  }
  if (n_st == 0) {  // every row of the tile fully masked: out 0, lse 0
    store_masked_tile(p, out, lse, q0, vb, min(VW, p.d - vb), blockIdx.y == 0);
    return;
  }
  auto issue = [&](int st) {
    T* kd = ring + (st & 1) * BN * (DQ + VW);
    load_rows<T, DQ, BN, kWideThreads>(kd, k, p.sk[2], st * BN, p.tk, p.d, vec);
    load_rows<T, VW, BN, kWideThreads>(kd + BN * DQ, v + vb, p.sv[2], st * BN, p.tk, p.d - vb,
                                       vec);
  };
  load_rows<T, DQ, kBM, kWideThreads>(Qs, q, p.sq[2], q0, p.tq, p.d, vec);
  issue(0);
  cp_async_commit();

  const int row[2] = {q0 + w0 + g, q0 + w0 + g + 8};
  float o[kWide / 8][4];
#pragma unroll
  for (int n = 0; n < kWide / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  const float scale2 = p.scale * 1.4426950408889634f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<0>();
    __syncthreads();  // stage st is here; every warp is done with stage st - 1
    if (st + 1 < n_st) issue(st + 1);  // its copies run under this stage's math
    cp_async_commit();
    T* kd = ring + (st & 1) * BN * (DQ + VW);
    float s[1][KN][4];
    qk_scores<T, DQ, HALF, KN>(s, Qs, kd, w0, grp * HALF);
    // the partials meet in the K stage: element (row r, key j) of group g
    // at float j * RW + g * RW / 2 + (r ^ 8t), t = (j >> 1) & 3, which puts a
    // fragment's 32 values in 32 banks
    float* xs = reinterpret_cast<float*>(kd);
    bar_sync(1 + grp, 4 * 32);  // the group is done reading its half of K
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          xs[(8 * j + 2 * t + e) * RW + grp * (RW / 2) + ((w0 + g + 8 * h) ^ (t << 3))] =
              s[0][j][2 * h + e];
    bar_sync(3 + (warp & 3), 2 * 32);  // the pair's partials are both written
#pragma unroll
    for (int j = 0; j < KN; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x =
              xs[(8 * j + 2 * t + e) * RW + (1 - grp) * (RW / 2) + ((w0 + g + 8 * h) ^ (t << 3))];
          float& y = s[0][j][2 * h + e];
          y = grp == 0 ? y + x : x + y;  // s_0 + s_1 in both groups
        }
    softmax_pv<T, kWide, KN, VW>(p, s, o, m, l, kd + BN * DQ, st * BN, q0, w0, row, scale2,
                                 grp * kWide);
  }
  cp_async_wait<0>();
  if (cols > 0)
    store_fwd<T, kWide / 8>(p, out, lse, o, m, l, row, c0, cols, blockIdx.y == 0 && grp == 0);
}

// Heads too wide for flash_fwd_wide_kernel's resident query tile (d past
// kWideMaxD): column blocks. The grid gains a y axis of
// ceil(d / kWide) output column blocks; each CTA computes s = q k^T over
// all of d, in kWide-wide chunks summed from 0 and added in f32 in chunk
// order (every block sees the same s, so the same p, m and l), and keeps
// its own kWide columns of p v. A two-stage ring carries steps of two
// swizzled [64][kWide] tiles: for each key tile, (q chunk c, k chunk c)
// for every c, then (v's block). Block 0 writes lse.
template <typename T>
__global__ void __launch_bounds__(kFwdThreads) flash_fwd_chunked_kernel(const FlashParams p) {
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
// swizzled [R][W] tile, NT threads sharing the copies; rows at or past t,
// and columns at or past d, read as zeros. FULL: d == W and every row
// aligned (FlashParams.vec), so whole units copy by cp.async with no column
// test
template <typename T, int W, int R, bool FULL, int NT>
__device__ __forceinline__ void load_swz(T* dst, const T* src, int64_t st, int r0, int t, int d,
                                         bool vec) {
  constexpr int G = W / 4;
  for (int i = threadIdx.x; i < R * G; i += NT) {
    const int r = i / G, c = (i % G) * 4;
    const bool ok = r0 + r < t;
    if constexpr (FULL) {
      const T* from = src + (ok ? (int64_t)(r0 + r) * st + c : 0);
      cp_async<(int)(4 * sizeof(T))>(dst + swz(r, c, W), from, ok);
    } else {
      load_unit(dst + swz(r, c, W), src + (ok ? (int64_t)(r0 + r) * st : 0), ok, c, d, vec);
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

// acc = A B with A a row-major swizzled [*][W] operand tile of type T: in
// place by ldmatrix for f32, element by element for bf16
template <typename T, int MT, int NT, int K, int W, typename FB>
__device__ __forceinline__ void warp_mma_tile(float (&acc)[MT][NT][4], int m0, int n0,
                                              const T* a, FB b) {
  constexpr bool kSplit = tf32::needs_split<T>();
  if constexpr (sizeof(T) == 4) {
    warp_mma_ldsm<kSplit, MT, NT, K, W>(acc, m0, n0, a, b);
  } else {
    warp_mma<kSplit, MT, NT, K>(
        acc, m0, n0, [&](int r, int c) { return to_f32(a[swz(r, c, W)]); }, b);
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
  load_swz<T, kFD, kFBN, FULL, kFThreads>(Ks, k, p.sk[2], k0, p.tk, d, vec);
  load_swz<T, kFD, kFBN, FULL, kFThreads>(Vs, v, p.sv[2], k0, p.tk, d, vec);
  if (qt0 < nq) {
    load_swz<T, kFD, kFBM, FULL, kFThreads>(Qs, q, p.sq[2], qt0 * kFBM, p.tq, d, vec);
    load_swz<T, kFD, kFBM, FULL, kFThreads>(dOs, dout, p.sdo[2], qt0 * kFBM, p.tq, d, vec);
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
      load_swz<T, kFD, kFBM, FULL, kFThreads>(Qs + nb * kFBM * kFD, q, p.sq[2], q0 + kFBM,
                                              p.tq, d, vec);
      load_swz<T, kFD, kFBM, FULL, kFThreads>(dOs + nb * kFBM * kFD, dout, p.sdo[2],
                                              q0 + kFBM, p.tq, d, vec);
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
      warp_mma_tile<T, 2, 4, kFD, kFD>(s, wq0, wn0, Qb,
                                  [&](int c, int n) { return to_f32(Ks[swz(n, c, kFD)]); });
      warp_mma_tile<T, 2, 4, kFD, kFD>(dp, wq0, wn0, dOb,
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

// ---------------------------------------------------------------------------
// The dK/dV + dQ pair: delta once, then the five products on the tensor
// cores, with the fused tier's helpers.
// ---------------------------------------------------------------------------

constexpr int kPBM = 64;        // query rows a tile of the pair
constexpr int kPThreads = 256;  // 8 warps
constexpr size_t kSmemMax = 232448;  // the card's 227 KB a CTA

// keys a tile of the pair at the built width DP: 128 at DP = 64 (the
// fused tier's tile), 64 at DP = 128 (K and V of 128 keys would not leave
// room for the ring)
template <int DP> __host__ __device__ constexpr int pair_keys() {
  return DP == 64 ? 128 : 64;
}

// delta = rowsum(dO * O) in f32, once per query row, into (b, h, tq):
// four threads a row, each summing its 4-element units in column order,
// then the quad; grid (b * h, 64-row tiles)
template <typename T>
__global__ void __launch_bounds__(256) flash_bwd_delta_kernel(const FlashParams p,
                                                              float* __restrict__ delta) {
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  const int row = blockIdx.y * 64 + (threadIdx.x >> 2), part = threadIdx.x & 3;
  const bool vec = p.vec != 0;
  float acc = 0.0f;
  if (row < p.tq) {
    const T* orow = static_cast<const T*>(p.o) + bi * p.so[0] + hi * p.so[1] +
                    (int64_t)row * p.so[2];
    const T* drow = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1] +
                    (int64_t)row * p.sdo[2];
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
  if (part == 0 && row < p.tq) delta[(int64_t)bh * p.tq + row] = acc;
}

// Shared memory of a pair kernel. Its own side (the dK/dV kernel's K and
// V, the dQ kernel's q and dO) is resident over all nc column chunks when
// that fits beside a ring of the streamed side; otherwise each ring stage
// carries the own side's chunk too. n_ps f32 [64][BN] tiles follow (p and
// ds, or ds alone).
struct PairPlan {
  int resident, stages;
  size_t bytes;
};

template <typename T, int DP>
PairPlan pair_plan(int nc, int own_rows, int stream_rows, int n_ps) {
  const size_t row = (size_t)DP * sizeof(T), own = 2 * (size_t)nc * own_rows * row;
  const size_t ps = (size_t)n_ps * kPBM * pair_keys<DP>() * 4;
  const size_t stage = 2 * (size_t)stream_rows * row, both = stage + 2 * (size_t)own_rows * row;
  if (own + 2 * stage + ps <= kSmemMax) return {1, 2, own + 2 * stage + ps};
  if (own + stage + ps <= kSmemMax) return {1, 1, own + stage + ps};
  if (2 * both + ps <= kSmemMax) return {0, 2, 2 * both + ps};
  return {0, 1, both + ps};
}

// s = q k^T and dp = dO v^T of a 64 x BN (query, key) tile over one
// DP-wide column chunk, summed in the tensor core from 0: warps 2 (queries)
// x 4 (keys), 32 x BN / 4 each
template <typename T, int DP, int BN>
__device__ __forceinline__ void pair_s_dp(float (&s)[2][BN / 32][4],
                                          float (&dp)[2][BN / 32][4], const T* Qc,
                                          const T* dOc, const T* Kc, const T* Vc) {
  const int warp = threadIdx.x >> 5, wq0 = (warp >> 2) * 32, wn0 = (warp & 3) * (BN / 4);
  warp_mma_tile<T, 2, BN / 32, DP, DP>(s, wq0, wn0, Qc,
                                       [&](int c, int n) { return to_f32(Kc[swz(n, c, DP)]); });
  warp_mma_tile<T, 2, BN / 32, DP, DP>(dp, wq0, wn0, dOc,
                                       [&](int c, int n) { return to_f32(Vc[swz(n, c, DP)]); });
}

// the next column chunk of s and dp: summed from 0, then joined to the
// running sums in f32, in chunk order (a single chunk goes straight in)
template <typename T, int DP, int BN>
__device__ __forceinline__ void pair_chunk(float (&s)[2][BN / 32][4],
                                           float (&dp)[2][BN / 32][4], const T* Qc,
                                           const T* dOc, const T* Kc, const T* Vc, int j,
                                           int nc) {
  if (DP == 64 || nc == 1) {  // d <= DP: one chunk
    pair_s_dp<T, DP, BN>(s, dp, Qc, dOc, Kc, Vc);
    return;
  }
  float ts[2][BN / 32][4], tdp[2][BN / 32][4];
  pair_s_dp<T, DP, BN>(ts, tdp, Qc, dOc, Kc, Vc);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < BN / 32; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[i][n][e] = j == 0 ? ts[i][n][e] : s[i][n][e] + ts[i][n][e];
        dp[i][n][e] = j == 0 ? tdp[i][n][e] : dp[i][n][e] + tdp[i][n][e];
      }
}

// p = exp(s * scale - lse) and ds = p (dp - delta) scale of the warp's
// fragments, rounded to T, into the f32 swizzled [64][BN] tiles Ps (when
// not null) and dSs; L and D hold lse and delta of the thread's rows
// wq0 + 16 i + g + 8 h
template <typename T, int BN>
__device__ __forceinline__ void pair_p_ds(const FlashParams& p, const float (&s)[2][BN / 32][4],
                                          const float (&dp)[2][BN / 32][4],
                                          const float (&L)[2][2], const float (&D)[2][2],
                                          int q0, int k0, float* Ps, float* dSs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wq0 = (warp >> 2) * 32, wn0 = (warp & 3) * (BN / 4);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wq0 + 16 * i + g + 8 * h;
#pragma unroll
      for (int n = 0; n < BN / 32; ++n) {
        const int c = wn0 + 8 * n + 2 * t;
        float pv[2], dsv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float pf = visible(p, q0 + r, k0 + c + e)
                               ? expf(s[i][n][2 * h + e] * p.scale - L[i][h]) : 0.0f;
          pv[e] = round_t<T>(pf);
          dsv[e] = round_t<T>(pf * (dp[i][n][2 * h + e] - D[i][h]) * p.scale);
        }
        if (Ps != nullptr)
          *reinterpret_cast<float2*>(Ps + swz(r, c, BN)) = make_float2(pv[0], pv[1]);
        *reinterpret_cast<float2*>(dSs + swz(r, c, BN)) = make_float2(dsv[0], dsv[1]);
      }
    }
}

// lse and delta of the thread's fragment rows of the query tile at q0 (0
// past tq)
__device__ __forceinline__ void pair_rows(const FlashParams& p, const float* lse,
                                          const float* delta, int q0, float (&L)[2][2],
                                          float (&D)[2][2]) {
  const int warp = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2, wq0 = (warp >> 2) * 32;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wq0 + 16 * i + g + 8 * h;
      L[i][h] = row < p.tq ? lse[row] : 0.0f;
      D[i][h] = row < p.tq ? delta[row] : 0.0f;
    }
}

// One CTA per (b * h, BN-key tile, DP-wide output column block): dK and dV
// of its keys over every query tile (causal: from the first that sees
// them). Steps of a query tile: the nc column chunks of (q, dO) in order,
// whose s and dp sum in f32 (K / V resident, or staged beside them), then,
// when this block's chunk z is not the last, (q, dO) of chunk z again.
// After the last chunk p and ds go to shared memory; then dV += p^T dO_z and
// dK += ds^T q_z, each query tile's part summed from 0 and added in f32.
// FULL: d == DP and every operand row aligned (FlashParams.vec).
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(kPThreads, 1)
flash_bwd_dkv_kernel(const FlashParams p, const float* __restrict__ delta, int resident,
                     int stages) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int BN = pair_keys<DP>(), QT = kPBM * DP, KT = BN * DP;
  constexpr int MT = BN / 64, NTD = DP / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  const int k0 = blockIdx.y * BN;
  const int nc = FULL ? 1 : (p.d + DP - 1) / DP, z = blockIdx.z;
  const int c0 = z * DP, cols = FULL ? DP : min(DP, p.d - c0);
  const int ns = nc + (z != nc - 1);  // steps a query tile
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];
  const float* lse = p.lse + (int64_t)bh * p.tq;
  const float* dl = delta + (int64_t)bh * p.tq;

  T* own = reinterpret_cast<T*>(smem);  // resident: K chunks, then V chunks
  T* ring = own + (resident ? 2 * nc * KT : 0);
  const int stage_elems = 2 * QT + (resident ? 0 : 2 * KT);  // q, dO [, k, v]
  float* Ps = reinterpret_cast<float*>(ring + stages * stage_elems);
  float* dSs = Ps + kPBM * BN;

  const int qt0 = first_query_tile(p, k0), nq = (p.tq + kPBM - 1) / kPBM;
  const int total = (nq - qt0) * ns;
  auto width = [&](int c) { return FULL ? DP : min(DP, p.d - c * DP); };
  if (resident) {
    for (int c = 0; c < nc; ++c) {
      load_swz<T, DP, BN, FULL, kPThreads>(own + c * KT, k + c * DP, p.sk[2], k0, p.tk,
                                           width(c), vec);
      load_swz<T, DP, BN, FULL, kPThreads>(own + (nc + c) * KT, v + c * DP, p.sv[2], k0, p.tk,
                                           width(c), vec);
    }
  }
  auto issue = [&](int gs) {
    const int j = gs % ns, c = j < nc ? j : z, q0 = (qt0 + gs / ns) * kPBM;
    T* st = ring + (gs % stages) * stage_elems;
    load_swz<T, DP, kPBM, FULL, kPThreads>(st, q + c * DP, p.sq[2], q0, p.tq, width(c), vec);
    load_swz<T, DP, kPBM, FULL, kPThreads>(st + QT, dout + c * DP, p.sdo[2], q0, p.tq,
                                           width(c), vec);
    if (!resident && j < nc) {
      load_swz<T, DP, BN, FULL, kPThreads>(st + 2 * QT, k + c * DP, p.sk[2], k0, p.tk,
                                           width(c), vec);
      load_swz<T, DP, BN, FULL, kPThreads>(st + 2 * QT + KT, v + c * DP, p.sv[2], k0, p.tk,
                                           width(c), vec);
    }
  };
  if (total > 0) issue(0);
  cp_async_commit();

  // dK, dV: warps 4 (keys) x 2 (columns), BN / 4 x DP / 2 each
  const int warp = threadIdx.x >> 5, wk0 = (warp >> 1) * (BN / 4), wd0 = (warp & 1) * (DP / 2);
  float dk[MT][NTD][4], dv[MT][NTD][4], s[2][BN / 32][4], dp[2][BN / 32][4];
  zero(dk);
  zero(dv);
  for (int gs = 0; gs < total; ++gs) {
    if (stages == 1 && gs > 0) {
      __syncthreads();  // every warp is done with the one stage
      issue(gs);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // step gs is here, and every warp is done with step gs - 1
    if (stages == 2 && gs + 1 < total) issue(gs + 1);  // its copies run under this math
    cp_async_commit();
    const int j = gs % ns, q0 = (qt0 + gs / ns) * kPBM;
    const T* st = ring + (gs % stages) * stage_elems;
    if (j < nc) {
      const T* Kc = resident ? own + j * KT : st + 2 * QT;
      const T* Vc = resident ? own + (nc + j) * KT : st + 2 * QT + KT;
      pair_chunk<T, DP, BN>(s, dp, st, st + QT, Kc, Vc, j, nc);
      if (j == nc - 1) {
        float L[2][2], D[2][2];
        pair_rows(p, lse, dl, q0, L, D);
        pair_p_ds<T, BN>(p, s, dp, L, D, q0, k0, Ps, dSs);
        __syncthreads();  // p and ds are whole
      }
    }
    if (j == ns - 1) {  // st holds (q, dO) of chunk z
      const T* Qz = st;
      const T* dOz = st + QT;
      float part[MT][NTD][4];
      warp_mma<kSplit, MT, NTD, kPBM>(
          part, wk0, wd0, [&](int key, int r) { return Ps[swz(r, key, BN)]; },
          [&](int r, int c) { return to_f32(dOz[swz(r, c, DP)]); });
      add_to(dv, part);
      warp_mma<kSplit, MT, NTD, kPBM>(
          part, wk0, wd0, [&](int key, int r) { return dSs[swz(r, key, BN)]; },
          [&](int r, int c) { return to_f32(Qz[swz(r, c, DP)]); });
      add_to(dk, part);
    }
  }
  cp_async_wait<0>();  // the resident loads land before the CTA exits

  const int d = FULL ? DP : p.d;  // the outputs' row stride
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* dkp = static_cast<T*>(p.dk) + (int64_t)bh * p.tk * d + c0;
  T* dvp = static_cast<T*>(p.dv) + (int64_t)bh * p.tk * d + c0;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = k0 + wk0 + 16 * i + g + 8 * h;
      if (key >= p.tk) continue;
#pragma unroll
      for (int n = 0; n < NTD; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wd0 + 8 * n + 2 * t + e;
          if (!FULL && c >= cols) continue;
          dkp[(int64_t)key * d + c] = from_f32<T>(dk[i][n][2 * h + e]);
          dvp[(int64_t)key * d + c] = from_f32<T>(dv[i][n][2 * h + e]);
        }
    }
}

// One CTA per (b * h, 64-row query tile, DP-wide output column block): dQ
// of its rows over every BN-key tile it sees. Steps of a key tile: the nc
// column chunks of (k, v) in order (q / dO resident, or staged beside
// them), then, when this block's chunk z is not the last, k of chunk z
// again. After the last chunk ds goes to shared memory; then dQ += ds k_z,
// each key tile's part summed from 0 and added in f32.
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(kPThreads, 1)
flash_bwd_dq_kernel(const FlashParams p, const float* __restrict__ delta, int resident,
                    int stages) {
  constexpr bool kSplit = tf32::needs_split<T>();
  constexpr int BN = pair_keys<DP>(), QT = kPBM * DP, KT = BN * DP, NTQ = DP / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  const int bh = blockIdx.x, bi = bh / p.h, hi = bh % p.h;
  // causal: the last query tiles have the most keys, so they start first
  const int q0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kPBM;
  const int nc = FULL ? 1 : (p.d + DP - 1) / DP, z = blockIdx.z;
  const int c0 = z * DP, cols = FULL ? DP : min(DP, p.d - c0);
  const int ns = nc + (z != nc - 1);  // steps a key tile
  const bool vec = p.vec != 0;
  const T* q = static_cast<const T*>(p.q) + bi * p.sq[0] + hi * p.sq[1];
  const T* k = static_cast<const T*>(p.k) + bi * p.sk[0] + hi * p.sk[1];
  const T* v = static_cast<const T*>(p.v) + bi * p.sv[0] + hi * p.sv[1];
  const T* dout = static_cast<const T*>(p.dout) + bi * p.sdo[0] + hi * p.sdo[1];

  T* own = reinterpret_cast<T*>(smem);  // resident: q chunks, then dO chunks
  T* ring = own + (resident ? 2 * nc * QT : 0);
  const int stage_elems = 2 * KT + (resident ? 0 : 2 * QT);  // k, v [, q, dO]
  float* dSs = reinterpret_cast<float*>(ring + stages * stage_elems);

  // key tiles the rows see: all, or (causal) up to the last valid row's
  // last visible key
  int n_kt = (p.tk + BN - 1) / BN;
  if (p.causal) {
    const int last_key = min(q0 + kPBM, p.tq) - 1 + (p.tk - p.tq);
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / BN + 1);
  }
  const int total = n_kt * ns;
  auto width = [&](int c) { return FULL ? DP : min(DP, p.d - c * DP); };
  if (resident && total > 0) {
    for (int c = 0; c < nc; ++c) {
      load_swz<T, DP, kPBM, FULL, kPThreads>(own + c * QT, q + c * DP, p.sq[2], q0, p.tq,
                                             width(c), vec);
      load_swz<T, DP, kPBM, FULL, kPThreads>(own + (nc + c) * QT, dout + c * DP, p.sdo[2],
                                             q0, p.tq, width(c), vec);
    }
  }
  auto issue = [&](int gs) {
    const int j = gs % ns, c = j < nc ? j : z, k0 = (gs / ns) * BN;
    T* st = ring + (gs % stages) * stage_elems;
    load_swz<T, DP, BN, FULL, kPThreads>(st, k + c * DP, p.sk[2], k0, p.tk, width(c), vec);
    if (j < nc) {
      load_swz<T, DP, BN, FULL, kPThreads>(st + KT, v + c * DP, p.sv[2], k0, p.tk, width(c),
                                           vec);
      if (!resident) {
        load_swz<T, DP, kPBM, FULL, kPThreads>(st + 2 * KT, q + c * DP, p.sq[2], q0, p.tq,
                                               width(c), vec);
        load_swz<T, DP, kPBM, FULL, kPThreads>(st + 2 * KT + QT, dout + c * DP, p.sdo[2], q0,
                                               p.tq, width(c), vec);
      }
    }
  };
  if (total > 0) issue(0);
  cp_async_commit();

  float L[2][2], D[2][2];
  pair_rows(p, p.lse + (int64_t)bh * p.tq, delta + (int64_t)bh * p.tq, q0, L, D);
  // dQ: warps 2 (queries) x 4 (columns), 32 x DP / 4 each
  const int warp = threadIdx.x >> 5, wq0 = (warp >> 2) * 32, wc0 = (warp & 3) * (DP / 4);
  float dq[2][NTQ][4], s[2][BN / 32][4], dp[2][BN / 32][4];
  zero(dq);
  for (int gs = 0; gs < total; ++gs) {
    if (stages == 1 && gs > 0) {
      __syncthreads();
      issue(gs);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();
    if (stages == 2 && gs + 1 < total) issue(gs + 1);
    cp_async_commit();
    const int j = gs % ns, k0 = (gs / ns) * BN;
    const T* st = ring + (gs % stages) * stage_elems;
    if (j < nc) {
      const T* Qc = resident ? own + j * QT : st + 2 * KT;
      const T* dOc = resident ? own + (nc + j) * QT : st + 2 * KT + QT;
      pair_chunk<T, DP, BN>(s, dp, Qc, dOc, st, st + KT, j, nc);
      if (j == nc - 1) {
        pair_p_ds<T, BN>(p, s, dp, L, D, q0, k0, nullptr, dSs);
        __syncthreads();  // ds is whole
      }
    }
    if (j == ns - 1) {  // st holds k of chunk z
      const T* Kz = st;
      float part[2][NTQ][4];
      warp_mma_ldsm<kSplit, 2, NTQ, BN, BN>(
          part, wq0, wc0, dSs, [&](int key, int c) { return to_f32(Kz[swz(key, c, DP)]); });
      add_to(dq, part);
    }
  }
  cp_async_wait<0>();

  const int d = FULL ? DP : p.d;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T* dqp = static_cast<T*>(p.dq) + (int64_t)bh * p.tq * d + c0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wq0 + 16 * i + g + 8 * h;
      if (row >= p.tq) continue;
#pragma unroll
      for (int n = 0; n < NTQ; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = wc0 + 8 * n + 2 * t + e;
          if (!FULL && c >= cols) continue;
          dqp[(int64_t)row * d + c] = from_f32<T>(dq[i][n][2 * h + e]);
        }
    }
}

template <typename T> constexpr size_t fused_smem() {
  return (size_t)(2 * kFBN + 4 * kFBM) * kFD * sizeof(T) +
         (size_t)(2 * kFBM * kFBN + 2 * kFBM) * sizeof(float);
}
static_assert(fused_smem<float>() <= 232448 - 1024, "fused backward tile too large");

template <typename T, int DP> constexpr size_t fwd_smem() {
  return (size_t)(kBM + 4 * kBN) * DP * sizeof(T);
}

// the chunked forward's ring: two stages of two [64][kWide] tiles
template <typename T> constexpr size_t fwd_chunked_smem() {
  return (size_t)4 * kBM * kWide * sizeof(T);
}

// every configuration fits one CTA under the card's 227 KB
static_assert(fwd_smem<float, 128>() <= 232448, "forward tile too large");
static_assert(fwd_chunked_smem<float>() <= 232448, "chunked forward ring too large");
static_assert(4 * kPBM * 128 * sizeof(float) + 2 * kPBM * pair_keys<128>() * 4 <= kSmemMax,
              "the pair's smallest plan at DP = 128 too large");

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

template <typename T, int DQ>
cudaError_t fwd_wide(const FlashParams& p, cudaStream_t st) {
  constexpr size_t bytes = wide_smem<T, DQ>(wide_keys<T, DQ>());
  cudaError_t err = prepare(flash_fwd_wide_kernel<T, DQ>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned blocks = (unsigned)((p.d + 2 * kWide - 1) / (2 * kWide));
  flash_fwd_wide_kernel<T, DQ><<<dim3(grid_x(p), blocks), kWideThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_width(const FlashParams& p, cudaStream_t st) {
  if (p.d <= 32) return fwd_typed<T, 32>(p, st);
  if (p.d <= 64) return fwd_typed<T, 64>(p, st);
  if (p.d <= 128) return fwd_typed<T, 128>(p, st);
  if (p.d <= 2 * kWide) return fwd_wide<T, 2 * kWide>(p, st);
  if (p.d <= kWideMaxD) return fwd_wide<T, kWideMaxD>(p, st);
  constexpr size_t bytes = fwd_chunked_smem<T>();
  cudaError_t err = prepare(flash_fwd_chunked_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_chunked_kernel<T><<<dim3(grid_x(p), wide_blocks(p)), kFwdThreads, bytes, st>>>(p);
  return cudaGetLastError();
}

// The pair at the built width DP >= d (past 128: DP-wide column blocks,
// grid z): delta first, then the dK/dV kernel and the dQ kernel
template <typename T, int DP, bool FULL>
cudaError_t pair_typed(const FlashParams& p, float* delta, cudaStream_t st) {
  const int nc = (p.d + DP - 1) / DP;
  flash_bwd_delta_kernel<T><<<dim3(p.b * p.h, (p.tq + 63) / 64), 256, 0, st>>>(p, delta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int BN = pair_keys<DP>();
  const PairPlan kv = pair_plan<T, DP>(nc, BN, kPBM, 2);
  err = prepare(flash_bwd_dkv_kernel<T, DP, FULL>, kv.bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dkv_kernel<T, DP, FULL>
      <<<dim3(p.b * p.h, (p.tk + BN - 1) / BN, nc), kPThreads, kv.bytes, st>>>(
          p, delta, kv.resident, kv.stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const PairPlan qp = pair_plan<T, DP>(nc, kPBM, BN, 1);
  err = prepare(flash_bwd_dq_kernel<T, DP, FULL>, qp.bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T, DP, FULL>
      <<<dim3(p.b * p.h, (p.tq + kPBM - 1) / kPBM, nc), kPThreads, qp.bytes, st>>>(
          p, delta, qp.resident, qp.stages);
  return cudaGetLastError();
}

// DP 64 or 128 (and 128-wide blocks past it); FULL where d == DP and every
// row is aligned
template <typename T>
cudaError_t bwd_width(const FlashParams& p, float* delta, cudaStream_t st) {
  const bool full = p.vec != 0;
  if (p.d <= 64)
    return p.d == 64 && full ? pair_typed<T, 64, true>(p, delta, st)
                             : pair_typed<T, 64, false>(p, delta, st);
  if (p.d == 128 && full) return pair_typed<T, 128, true>(p, delta, st);
  return pair_typed<T, 128, false>(p, delta, st);
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

// q, k, v, o, dout (strided), lse -> dq (b, h, tq, d), dk, dv (b, h, tk, d),
// with delta an f32 scratch of (b, h, tq): the delta kernel, the dK/dV
// kernel, then the dQ kernel
int flash_attention_bwd(const FlashParams* p, float* delta, void* stream) {
  if (p == nullptr || !shape_ok(*p) || delta == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (p->dtype == 0) return (int)bwd_width<float>(*p, delta, st);
  return (int)bwd_width<__nv_bfloat16>(*p, delta, st);
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
