// Paged flash attention over a paged KV pool, for Hopper (sm_90a): f32
// pools, or int8 pools with one f32 scale per pool row.
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   paged_flash_attention with a per-slot table -> _paged_flash_decode_kernel
//   paged_flash_attention with a shared 1-D table -> _paged_flash_shared_kernel
//   the same with k_scales/v_scales (int8 pools)  -> _paged_flash_decode_quant_kernel
//                                                    _paged_flash_shared_quant_kernel
//
// Layout (the JAX package's): q is [rows, H*D]; each pool is [pool_rows, H*D]
// with pool row page_id * page_size + offset holding one token's K (or V) for
// every head; the block table maps a row's logical page p to a pool page id
// (page 0 is the scratch page: read like any other page, masked by position).
// Row r attends positions 0..pos[r] inclusive; pos[r] < 0 emits exact zeros.
//
// Bound: bytes. A query row does 2*D flops per K/V row it reads (4 bytes per
// element), so both forms sit far below the card's flop/byte balance; the
// least time is the K/V pages read up to pos over the HBM rate. The work is
// split across CTAs so that enough of them are in flight to keep HBM busy.
//
// Decode (one query row a slot), head width up to 128: paged_decode_kernel.
// One query row gives the tensor cores no rows to share, so both products
// stay on the CUDA cores and the bound is the pool bytes read. One CTA of
// 4 warps per (slot, head, split of 128 context positions): the grid is
// sized from the table's length (the host does not know pos), and a CTA
// past its slot's pos exits before any load. Each warp takes 32 positions,
// one a lane, gathered through the table position by position (so any
// page_size), and issues its K rows, then its V rows, as two cp.async
// groups of 16-byte copies (int8: the raw levels and each row's scale), all
// in flight at once: 64 KB a CTA of f32 at d = 64, so 3 CTAs an SM keep
// HBM busy; the score of lane j's key (a dot against the staged query row,
// four partial sums) and the softmax of the warp's 32 keys, (m, l) by
// shuffles, run while V lands. p v gives each lane d / 32 columns. The
// warps merge in shared memory in warp order (no single-thread phase); a
// slot whose live keys fit one split writes its output, otherwise the last
// split of each (slot, head) to finish, found by an integer arrival counter
// that it resets, merges the splits in split order: one launch, no float
// atomics, bit for bit on repeat, and nothing a CUDA graph could not
// capture. One head a CTA: a head's slice of a pool row is 256 contiguous
// bytes (two whole 128-byte lines) at GPT-2 small's widths, and the CTAs of
// a slot's heads run side by side over the same rows.
// Wider heads take paged_wide_kernel (below).
//
// Shared table (a prefill chunk's rows over one page list), head width up
// to 128: one CTA per (tile of up to 32 query rows, head, split of
// 64 * kSStages context positions), cut at the tile's max(pos).
// The CTA gathers each 64-key stage row by row through the table with
// 16-byte cp.async into a two-stage ring, so the next stage's copies run
// under this one's math (int8 levels land raw with their rows' scales and
// are dequantized into an f32 stage, one rounding, before use). q k^T and
// p v run on the tensor cores as 3xTF32 mma.sync m16n8k8 (tf32_mma.cuh)
// with the row state (m, l) and the accumulator in registers; four warps
// take 16 rows x 32 keys of each stage and merge their two key halves in
// shared memory at the end. A tile whose live keys fit one split writes its
// output; otherwise the last split of each (tile, head) to finish, found by
// an integer arrival counter that it resets, merges the splits in order
// (no second launch, no float atomics: the output repeats bit for bit).
// wgmma/TMA pipelines are left for later work.
//
// Heads past 128, either form: paged_wide_kernel, one design for any head
// width and any page size. One CTA of 8 warps per (slot, head, split of 64
// context positions) for decode, or per (32-row tile, head, split) for a
// shared table. It gathers the split's keys position by position through
// the table, so its shared memory (about 61 KB for f32 pools, 38 KB at one
// row) depends on neither page_size nor d: it walks d in 64-column chunks
// through a two-stage cp.async ring, first forming the scores chunk by chunk
// (each dot summed in chunk order), then, after one softmax a row over the
// split's 64 keys, p v chunk by chunk. f32 FMAs on the CUDA cores: a decode
// row gives the tensor cores nothing to share, and both forms are bound by
// the pool bytes they read. Splits merge in the last one to finish, as
// above: one launch, bit for bit on repeat.
//
// int8 pools: the pools hold symmetric int8 levels, one row per token for
// every head, and a [pool_rows] f32 scale pool per pool holds each row's
// scale (shared by all heads). Every kernel stages the raw levels with their
// rows' scales; the shared and wide kernels dequantize a staged chunk into
// an f32 chunk in shared memory, the decode kernel as it reads them; either
// way float(level) * scale[row] is one rounding, the plain version's exact
// value, and the f32 rows never reach device memory. A head's slice of a
// row is D contiguous bytes (64 at
// GPT-2 small's widths), loaded as 16-byte vectors when D, the row width
// and the pool's address allow. Bound: bytes, 1 byte per K/V element plus
// 4 bytes of scale per K/V row read, a quarter of the f32 pools' traffic
// (the shared form's 3xTF32 products take about as long at GPT-2 small's
// widths: its bound is the larger of the two). Everything after the rows
// are dequantized is the f32 kernel's code.
//
// Numerics kept from the Pallas kernels: scores are dot(q, k) * scale; dead
// entries are excluded by a where-mask (never an additive -1e9); the rescale
// factor alpha is pinned to 0 while m_prev = -inf (in the merge too: a split
// that saw nothing live contributes exactly 0); a row with no live entry
// writes exact zeros.
//
// Plain C interface, loaded with ctypes (ops/paged_flash.py). Each launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing
// (the caller passes the split scratch), and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

// ---------------------------------------------------------------------------
// The shared-table form on the tensor cores (head width up to kSMaxD)
// ---------------------------------------------------------------------------

constexpr int kSRows = 32;      // query rows a CTA
constexpr int kSKeys = 64;      // keys a stage
// stages a split (timed on the card at the prefill chunk: 2 beat 1 and 4); a
// chunk's context of about 640 positions spreads over 5 splits per (32-row
// tile, head), 60 CTAs at 12 heads
constexpr int kSStages = 2;
constexpr int kSThreads = 128;  // 4 warps: 2 (16 rows each) x 2 (32 keys of each stage)
constexpr int kSMaxD = 128;     // the widest head the tensor-core form takes

// Every kernel's arguments: a decode step's slots or a prefill chunk's rows
// ("rows"), each with its own table (decode) or all over one (shared)
struct PagedArgs {
  const float* q;         // [rows, H * D]
  const void* k_pool;     // [pool_rows, H * D], f32 or int8 levels
  const void* v_pool;
  const float* k_scales;  // int8: [pool_rows]
  const float* v_scales;
  const int* table;       // [rows, P] (decode) or [P] (shared)
  const int* pos;         // [rows]
  float* out;             // [rows, H * D]
  float* part_acc;        // [splits][rows][H][D]
  float* part_ml;         // [splits][rows][H][2]
  int* arrivals;          // [(slots or 32-row tiles) * H], all 0; left at 0
  int rows, H, D, P, ps, n_pool_pages, vec;
  float scale;
};

// Element (r, c) of a row-major tile of W columns (W a multiple of 32), its
// 4-element units XOR-swizzled by (r & 7): q (ldmatrix) and k read as
// fragments, and v read down its key axis, hit 32 distinct banks.
__device__ __forceinline__ int sw(int r, int c, int w) { return r * w + (c ^ ((r & 7) << 2)); }

__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, bool live, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? bytes : 0;
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// pool row of the key at context position kpos, or -1 past n_keys (a
// corrupt table entry is clamped into the pool, as the JAX gather clamps)
__device__ __forceinline__ int pool_row(const PagedArgs& a, int kpos, int n_keys) {
  if (kpos >= n_keys) return -1;
  const int entry = kpos / a.ps;
  const int page = min(max(a.table[entry], 0), a.n_pool_pages - 1);
  return page * a.ps + (kpos - entry * a.ps);
}

// Issue the copies of one stage: the 64 keys whose pool rows are rows[]
// (-1: a dead key), `head`'s slice of each; dead keys, and columns past D,
// read as zeros. f32 pools land in swizzled [64][DP] tiles; int8 pools
// land as raw levels [64][DP] with their rows' scales (dequantized later).
template <int DP>
__device__ __forceinline__ void issue_stage(const PagedArgs& a, int head, const int* rows,
                                            float* kd, float* vd, float*, float*) {
  constexpr int U = DP / 4;
  const size_t feat = (size_t)a.H * a.D;
  const float* kp = static_cast<const float*>(a.k_pool);
  const float* vp = static_cast<const float*>(a.v_pool);
#pragma unroll
  for (int n = 0; n < kSKeys * U / kSThreads; ++n) {
    const int i = threadIdx.x + n * kSThreads;
    const int j = i / U, c = (i % U) * 4;
    const bool live = rows[j] >= 0;
    const size_t at = live ? (size_t)rows[j] * feat + (size_t)head * a.D : 0;
    float* kt = kd + sw(j, c, DP);
    float* vt = vd + sw(j, c, DP);
    if (a.vec) {
      const bool ok = live && c < a.D;
      cp_async_zfill(kt, ok ? kp + at + c : kp, ok, 16);
      cp_async_zfill(vt, ok ? vp + at + c : vp, ok, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = live && c + e < a.D;
        kt[e] = ok ? kp[at + c + e] : 0.0f;
        vt[e] = ok ? vp[at + c + e] : 0.0f;
      }
    }
  }
}

template <int DP>
__device__ __forceinline__ void issue_stage(const PagedArgs& a, int head, const int* rows,
                                            int8_t* kd, int8_t* vd, float* ksc, float* vsc) {
  constexpr int U = DP / 16;
  const size_t feat = (size_t)a.H * a.D;
  const int8_t* kp = static_cast<const int8_t*>(a.k_pool);
  const int8_t* vp = static_cast<const int8_t*>(a.v_pool);
  for (int i = threadIdx.x; i < kSKeys * U; i += kSThreads) {
    const int j = i / U, c = (i % U) * 16;
    const bool live = rows[j] >= 0;
    const size_t at = live ? (size_t)rows[j] * feat + (size_t)head * a.D : 0;
    if (a.vec) {
      const bool ok = live && c < a.D;
      cp_async_zfill(kd + j * DP + c, ok ? kp + at + c : kp, ok, 16);
      cp_async_zfill(vd + j * DP + c, ok ? vp + at + c : vp, ok, 16);
    } else {
      for (int e = 0; e < 16; ++e) {
        const bool ok = live && c + e < a.D;
        kd[j * DP + c + e] = ok ? kp[at + c + e] : int8_t(0);
        vd[j * DP + c + e] = ok ? vp[at + c + e] : int8_t(0);
      }
    }
  }
  for (int j = threadIdx.x; j < kSKeys; j += kSThreads) {
    const bool live = rows[j] >= 0;
    const size_t r = live ? rows[j] : 0;
    cp_async_zfill(ksc + j, a.k_scales + r, live, 4);
    cp_async_zfill(vsc + j, a.v_scales + r, live, 4);
  }
}

// A CTA's shared memory: the query tile, the two-stage ring and, for int8
// pools, the one stage dequantized to f32
template <typename T, int DP> struct SharedSmem {
  static constexpr size_t q = (size_t)kSRows * DP * 4;
  static constexpr size_t stage = 2 * (size_t)kSKeys * DP * sizeof(T) +
                                  (sizeof(T) == 1 ? 2 * kSKeys * 4 : 0);
  static constexpr size_t deq = sizeof(T) == 1 ? 2 * (size_t)kSKeys * DP * 4 : 0;
  static constexpr size_t bytes = q + 2 * stage + deq;
};

constexpr int kSMergeChunk = 32;  // splits whose weights a merge holds at once

// 2^x by the SFU (ex2.approx: about 2^-22 relative error; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The last split's merge of a (tile, head), in the base-2 domain of the
// splits' m: per row M = max m_s and L = sum l_s 2^(m_s - M) (four threads a
// row, each over every fourth split, joined in a fixed order), then out =
// sum acc_s 2^(m_s - M) / L in split order, four columns a thread. The
// splits' weights are staged in shared memory kSMergeChunk at a time, and a
// thread's loads of four splits for all its columns are in flight together.
// `buf` holds (8 + 2 + kSMergeChunk) * 32 floats.
template <int DP>
__device__ __forceinline__ void merge_splits(const PagedArgs& a, float* buf, int row0,
                                             int n_rows, int head, int n_live) {
  constexpr int U = DP / 4, UPT = kSRows * U / kSThreads, SB = UPT >= 8 ? 2 : 4;
  const float neg_inf = -CUDART_INF_F;
  float* red = buf;                // [4][32] (m, l) pairs
  float* M = red + 8 * kSRows;     // [32]
  float* inv = M + kSRows;         // [32]
  float* wts = inv + kSRows;       // [kSMergeChunk][32]
  const int tid = threadIdx.x, r = tid % kSRows, qd = tid / kSRows;
  auto ml = [&](int s, int row) {
    return a.part_ml + (((size_t)s * a.rows + row0 + row) * a.H + head) * 2;
  };
  // this thread's share of row r: every fourth split, four loads at a time
  float mq = neg_inf, lq = 0.0f;
  if (r < n_rows) {
    for (int s0 = qd; s0 < n_live; s0 += 16) {
      float2 x[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        x[i] = s0 + 4 * i < n_live ? __ldcg(reinterpret_cast<const float2*>(ml(s0 + 4 * i, r)))
                                   : make_float2(neg_inf, 0.0f);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (x[i].x == neg_inf) continue;
        const float mn = fmaxf(mq, x[i].x);
        lq = (mq == neg_inf ? 0.0f : lq * ex2(mq - mn)) + x[i].y * ex2(x[i].x - mn);
        mq = mn;
      }
    }
  }
  red[2 * (qd * kSRows + r)] = mq;
  red[2 * (qd * kSRows + r) + 1] = lq;
  __syncthreads();
  if (qd == 0) {
    float mm = neg_inf;
#pragma unroll
    for (int i = 0; i < 4; ++i) mm = fmaxf(mm, red[2 * (i * kSRows + r)]);
    float lsum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mi = red[2 * (i * kSRows + r)];
      if (mi != neg_inf) lsum += red[2 * (i * kSRows + r) + 1] * ex2(mi - mm);
    }
    M[r] = mm;
    inv[r] = 1.0f / (lsum > 0.0f ? lsum : 1.0f);
  }
  float acc[UPT][4];
#pragma unroll
  for (int u = 0; u < UPT; ++u)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[u][e] = 0.0f;
  const bool vec4 = a.D % 4 == 0;
  for (int c0 = 0; c0 < n_live; c0 += kSMergeChunk) {
    const int nc = min(kSMergeChunk, n_live - c0);
    __syncthreads();  // M is set, and the last chunk's weights are used
    for (int i = tid; i < nc * kSRows; i += kSThreads) {
      const int s = c0 + i / kSRows, row = i % kSRows;
      const float ms = row < n_rows ? __ldcg(ml(s, row)) : neg_inf;
      wts[i] = ms == neg_inf ? 0.0f : ex2(ms - M[row]);
    }
    __syncthreads();
    for (int s0 = 0; s0 < nc; s0 += SB) {
      float4 x[SB][UPT];
#pragma unroll
      for (int i = 0; i < SB; ++i)
#pragma unroll
        for (int u = 0; u < UPT; ++u) {
          const int unit = tid + u * kSThreads, row = unit / U, c = (unit % U) * 4;
          x[i][u] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          if (s0 + i >= nc || row >= n_rows || c >= a.D) continue;
          const float* src =
              a.part_acc + (((size_t)(c0 + s0 + i) * a.rows + row0 + row) * a.H + head) * a.D + c;
          if (vec4) {
            x[i][u] = __ldcg(reinterpret_cast<const float4*>(src));
          } else {
            x[i][u].x = __ldcg(src);
            x[i][u].y = c + 1 < a.D ? __ldcg(src + 1) : 0.0f;
            x[i][u].z = c + 2 < a.D ? __ldcg(src + 2) : 0.0f;
            x[i][u].w = c + 3 < a.D ? __ldcg(src + 3) : 0.0f;
          }
        }
#pragma unroll
      for (int i = 0; i < SB; ++i)
#pragma unroll
        for (int u = 0; u < UPT; ++u) {
          const int row = (tid + u * kSThreads) / U;
          if (s0 + i >= nc || row >= n_rows) continue;
          const float w = wts[(s0 + i) * kSRows + row];
          acc[u][0] = fmaf(x[i][u].x, w, acc[u][0]);
          acc[u][1] = fmaf(x[i][u].y, w, acc[u][1]);
          acc[u][2] = fmaf(x[i][u].z, w, acc[u][2]);
          acc[u][3] = fmaf(x[i][u].w, w, acc[u][3]);
        }
    }
  }
  const size_t feat = (size_t)a.H * a.D;
#pragma unroll
  for (int u = 0; u < UPT; ++u) {
    const int unit = tid + u * kSThreads, row = unit / U, c = (unit % U) * 4;
    if (row >= n_rows) continue;
    float* dst = a.out + (size_t)(row0 + row) * feat + (size_t)head * a.D;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c + e < a.D) dst[c + e] = acc[u][e] * inv[row];
  }
}

// One CTA: rows [row0, row0 + 32) (those under `rows`), one head, keys
// [split * S, (split + 1) * S) of the table's context, S = 64 *
// stages_per_split, cut at the tile's max(pos). Warp (rh, kh) takes rows
// 16 rh.. and keys 32 kh.. of each stage: s = q k^T and p v as 3xTF32
// mma.sync m16n8k8 (p v's A fragment is p's C fragment as it stands, the k
// slots (t, t + 4) read as keys (2t, 2t + 1)), an online softmax on the C
// fragments, each stage's p v part summed from 0 and added in f32. The two
// key halves merge in shared memory at the end. A tile whose live keys fit
// one split writes its output; otherwise each split writes its unnormalized
// (acc, m, l), and the last split of the (tile, head) to finish (an integer
// arrival counter, reset after) merges them in split order, so the result
// repeats bit for bit.
template <typename T, int DP>
__global__ void __launch_bounds__(kSThreads) paged_flash_shared_tc_kernel(const PagedArgs a) {
  using Smem = SharedSmem<T, DP>;
  static_assert(2 * Smem::stage >= (10 + kSMergeChunk) * kSRows * sizeof(float) &&
                    2 * Smem::stage >= kSRows * DP * sizeof(float),
                "the ring holds the key halves' merge and the splits' merge");
  constexpr int NO = DP / 8;           // 8-column tiles of a warp's output
  constexpr int NB = NO < 4 ? NO : 4;  // of them in one pass of p v
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + Smem::q;
  float* deq = reinterpret_cast<float*>(ring + 2 * Smem::stage);
  __shared__ int pos_s[kSRows];
  __shared__ int rows_s[2][kSKeys];  // pool rows of the two ring stages' keys
  __shared__ int max_pos_s, is_last;
  __shared__ float ml_s[kSRows][2];

  const int head = blockIdx.x % a.H, tile = blockIdx.x / a.H, split = blockIdx.y;
  const int row0 = tile * kSRows, n_rows = min(kSRows, a.rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int rh = warp & 1, kh = warp >> 1;
  const size_t feat = (size_t)a.H * a.D;
  // the query tile, zeros past the tile's rows and past D: in flight while
  // the positions and the table are read
  for (int i = tid; i < kSRows * DP / 4; i += kSThreads) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const float* src = a.q + (size_t)(row0 + (r < n_rows ? r : 0)) * feat + (size_t)head * a.D;
    float* dst = Qs + sw(r, c, DP);
    if (a.vec) {
      const bool ok = r < n_rows && c < a.D;
      cp_async_zfill(dst, ok ? src + c : a.q, ok, 16);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = r < n_rows && c + e < a.D ? src[c + e] : 0.0f;
    }
  }
  cp_async_commit();
  // the pool rows of the split's first two stages (one key a thread), read
  // beside the positions; keys past the tile's max(pos) are marked dead
  // once it is known
  static_assert(kSThreads == 2 * kSKeys, "one key a thread over two stages");
  const int span = kSKeys * kSStages, k_begin = split * span;
  int first_row = pool_row(a, k_begin + tid, min(k_begin + span, a.P * a.ps));
  if (warp == 0) {
    const int pr = lane < n_rows ? a.pos[row0 + lane] : -1;
    pos_s[lane] = pr;
    int mx = pr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) max_pos_s = mx;
  }
  __syncthreads();
  const int n_keys = max_pos_s < 0 ? 0 : min(max_pos_s + 1, a.P * a.ps);
  const int n_live = (n_keys + span - 1) / span;
  if (split >= n_live) {
    if (split == 0) {  // no live key for any row of the tile: exact zeros
      for (int i = tid; i < n_rows * a.D; i += kSThreads)
        a.out[(size_t)(row0 + i / a.D) * feat + (size_t)head * a.D + i % a.D] = 0.0f;
    }
    cp_async_wait<0>();
    return;
  }
  const int k_end = min(n_keys, k_begin + span);
  const int n_st = (k_end - k_begin + kSKeys - 1) / kSKeys;

  auto stage_ptrs = [&](int buf, T*& kd, T*& vd, float*& ksc, float*& vsc) {
    unsigned char* base = ring + buf * Smem::stage;
    kd = reinterpret_cast<T*>(base);
    vd = kd + kSKeys * DP;
    ksc = reinterpret_cast<float*>(vd + kSKeys * DP);
    vsc = ksc + kSKeys;
  };
  auto issue = [&](int st) {
    T *kd, *vd;
    float *ksc, *vsc;
    stage_ptrs(st & 1, kd, vd, ksc, vsc);
    issue_stage<DP>(a, head, rows_s[st & 1], kd, vd, ksc, vsc);
    cp_async_commit();
  };
  rows_s[tid / kSKeys][tid % kSKeys] = k_begin + tid < k_end ? first_row : -1;
  __syncthreads();
  issue(0);
  if (n_st > 1) issue(1);

  const int w0 = 16 * rh, kw0 = 32 * kh;  // the warp's rows, and its keys in a stage
  // the last live position of the thread's two rows: pos, capped at the
  // table's context
  const int pr[2] = {min(pos_s[w0 + g], n_keys - 1), min(pos_s[w0 + g + 8], n_keys - 1)};
  const int arow = (lane & 7) + 8 * ((lane >> 3) & 1), acol = 4 * (lane >> 4);
  const int brow = (lane & 7) + 8 * (lane >> 4), bcol = 4 * ((lane >> 3) & 1);
  const float neg_inf = -CUDART_INF_F;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
  // the softmax runs in base 2: m and the scores are s * scale * log2(e), so
  // each exponential is one ex2 (the split's m is written in that domain)
  const float scale2 = a.scale * 1.4426950408889634f;
  float m[2] = {neg_inf, neg_inf}, l[2] = {0.0f, 0.0f};  // l: this thread's share

  for (int st = 0; st < n_st; ++st) {
    if (st + 1 < n_st) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();  // stage st is here for every thread (and the query tile)
    // the pool rows of stage st + 2, read under this stage's math; its
    // copies go out once every warp is done with this stage's buffer
    if (st + 2 < n_st && tid < kSKeys)
      rows_s[st & 1][tid] = pool_row(a, k_begin + (st + 2) * kSKeys + tid, k_end);
    const float *Kb, *Vb;
    if constexpr (kInt8) {
      T *kd, *vd;
      float *ksc, *vsc;
      stage_ptrs(st & 1, kd, vd, ksc, vsc);
      float* kf = deq;
      float* vf = deq + kSKeys * DP;
      for (int i = tid; i < kSKeys * DP; i += kSThreads) {
        const int j = i / DP, c = i % DP;
        // one rounding: the plain version's exact value
        kf[sw(j, c, DP)] = __fmul_rn((float)kd[i], ksc[j]);
        vf[sw(j, c, DP)] = __fmul_rn((float)vd[i], vsc[j]);
      }
      __syncthreads();
      Kb = kf;
      Vb = vf;
    } else {
      T *kd, *vd;
      float *ksc, *vsc;
      stage_ptrs(st & 1, kd, vd, ksc, vsc);
      Kb = kd;
      Vb = vd;
    }

    // s = q k^T: the warp's 16 rows x 32 keys, the even and the odd 8-deep
    // steps in two independent sums (half the chain of dependent mma),
    // added at the end
    float s[1][4][4], s2[1][4][4];
#pragma unroll
    for (int kk = 0; kk < DP; kk += 8) {
      float (&acc)[1][4][4] = (kk & 8) ? s2 : s;
      uint32_t ah[1][4], al[1][4], bh[4][2], bl[4][2], r[4];
      tf32::ldmatrix_x4(r, Qs + sw(w0 + arow, kk + acol, DP));
#pragma unroll
      for (int e = 0; e < 4; ++e) tf32::split<true>(__uint_as_float(r[e]), ah[0][e], al[0][e]);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        tf32::ldmatrix_x4(r, Kb + sw(kw0 + 8 * j + brow, kk + bcol, DP));
#pragma unroll
        for (int e = 0; e < 4; ++e)
          tf32::split<true>(__uint_as_float(r[e]), bh[j + e / 2][e & 1], bl[j + e / 2][e & 1]);
      }
      if (kk < 16) tf32::mma_tiles<true, 1, 4, true>(acc, ah, al, bh, bl);
      else tf32::mma_tiles<true, 1, 4>(acc, ah, al, bh, bl);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[0][j][e] += s2[0][j][e];

    // where-masked online softmax on the C fragments: s[0][j][2h + e] is
    // row w0 + g + 8h, key kpos0 + 8j + 2t + e
    const int kpos0 = k_begin + st * kSKeys + kw0;
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = neg_inf;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[0][j][2 * h + e];
          x = kpos0 + 8 * j + 2 * t + e <= pr[h] ? x * scale2 : neg_inf;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      // exp(-inf - -inf) is nan: a row that has seen nothing live yet
      // rescales by exactly 0
      alpha[h] = m[h] == neg_inf ? 0.0f : ex2(m[h] - m_new);
      m[h] = m_new;
    }
    uint32_t ph[4][1][4], pl[4][1][4];
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float pv[4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[0][j][2 * h + e];
          pv[2 * h + e] = x == neg_inf ? 0.0f : ex2(x - m[h]);
          sum[h] += pv[2 * h + e];
        }
      tf32::split<true>(pv[0], ph[j][0][0], pl[j][0][0]);  // (g, key 2t)
      tf32::split<true>(pv[2], ph[j][0][1], pl[j][0][1]);  // (g + 8, key 2t)
      tf32::split<true>(pv[1], ph[j][0][2], pl[j][0][2]);  // (g, key 2t + 1)
      tf32::split<true>(pv[3], ph[j][0][3], pl[j][0][3]);  // (g + 8, key 2t + 1)
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
#pragma unroll
    for (int n0 = 0; n0 < NO; n0 += NB) {
      float part[1][NB][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
        for (int c = 0; c < NB; ++c)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tf32::split<true>(Vb[sw(kw0 + 8 * j + 2 * t + e, 8 * (n0 + c) + g, DP)], bh[c][e],
                              bl[c][e]);
        if (j == 0) tf32::mma_tiles<true, 1, NB, true>(part, ph[j], pl[j], bh, bl);
        else tf32::mma_tiles<true, 1, NB>(part, ph[j], pl[j], bh, bl);
      }
#pragma unroll
      for (int c = 0; c < NB; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n0 + c][e] += part[0][c][e];
    }
    if (st + 2 < n_st) {  // the buffer this stage used takes stage st + 2
      __syncthreads();
      issue(st + 2);
    }
  }

  // merge the two key halves: warps kh = 1 hand (m, l, acc) to kh = 0
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  __syncthreads();  // every warp is done with the ring
  float* xo = reinterpret_cast<float*>(ring);  // [32][DP]
  if (kh == 1) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w0 + g + 8 * h;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        xo[r * DP + 8 * n + 2 * t] = o[n][2 * h];
        xo[r * DP + 8 * n + 2 * t + 1] = o[n][2 * h + 1];
      }
      if (t == 0) {
        ml_s[r][0] = m[h];
        ml_s[r][1] = l[h];
      }
    }
  }
  __syncthreads();
  const bool single = n_live == 1;
  if (kh == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w0 + g + 8 * h;
      const float m1 = ml_s[r][0], l1 = ml_s[r][1];
      const float mm = fmaxf(m[h], m1);
      const float a0 = m[h] == neg_inf ? 0.0f : ex2(m[h] - mm);
      const float a1 = m1 == neg_inf ? 0.0f : ex2(m1 - mm);
      const float lm = l[h] * a0 + l1 * a1;
      if (r >= n_rows) continue;
      const size_t i = ((size_t)split * a.rows + row0 + r) * a.H + head;
      const float inv = 1.0f / (lm > 0.0f ? lm : 1.0f);
      float* dst = single ? a.out + (size_t)(row0 + r) * feat + (size_t)head * a.D
                          : a.part_acc + i * a.D;
#pragma unroll
      for (int n = 0; n < NO; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * n + 2 * t + e;
          if (c >= a.D) continue;
          const float x = o[n][2 * h + e] * a0 + xo[r * DP + c] * a1;
          dst[c] = single ? x * inv : x;
        }
      if (!single && t == 0) {
        a.part_ml[i * 2] = mm;
        a.part_ml[i * 2 + 1] = lm;
      }
    }
  }
  if (single) return;

  // the last split of this (tile, head) to finish merges: every partial is
  // written and fenced before the count moves
  __threadfence();
  __syncthreads();
  int* counter = a.arrivals + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  merge_splits<DP>(a, reinterpret_cast<float*>(ring), row0, n_rows, head, n_live);
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// The per-slot (decode) form at head widths up to kDMaxD
// ---------------------------------------------------------------------------

constexpr int kDWarps = 4;  // timed on the card: 2 and 8 were no faster
constexpr int kDThreads = 32 * kDWarps;
constexpr int kDSplit = 32 * kDWarps;  // context positions a CTA: one a lane
constexpr int kDMaxD = 128;            // the widest head this form takes

// A CTA's shared memory: K and V rows of its 128 positions (rows padded so
// that the lane-per-row reads of a warp hit distinct banks: 4 f32 or 16
// int8 levels), int8 rows' scales, the query row and the warps' merge.
template <typename T, int DP> struct DecodeSmem {
  static constexpr int ld = sizeof(T) == 4 ? DP + 4 : DP + 16;  // elements a row
  static constexpr size_t kv = (size_t)kDSplit * ld * sizeof(T);
  static constexpr size_t scales = sizeof(T) == 1 ? 2 * kDSplit * sizeof(float) : 0;
  static constexpr size_t bytes = 2 * kv + scales + (DP + kDWarps * (DP + 2)) * sizeof(float);
};

// Issue the copies of one warp's rows (one pool row a lane, row `prow` of
// lane j, nk live rows) of one pool into dst ([32][ld]), `head`'s slice:
// 16-byte cp.async where the wrapper found every row aligned (vec), columns
// past D zero-filled; else element by element. int8 pools also copy each
// row's scale.
template <typename T, int DP>
__device__ __forceinline__ void decode_rows(const PagedArgs& a, const T* pool,
                                            const float* scales, int head, int prow, int nk,
                                            T* dst, float* sc) {
  constexpr int LD = DecodeSmem<T, DP>::ld, E = 16 / (int)sizeof(T), U = DP / E;
  const int lane = threadIdx.x & 31;
  const size_t feat = (size_t)a.H * a.D;
#pragma unroll
  for (int n = 0; n < U; ++n) {
    const int i = lane + 32 * n, j = i / U, c = (i % U) * E;
    const int r = __shfl_sync(0xffffffffu, prow, j);
    if (j >= nk) continue;
    const T* src = pool + (size_t)r * feat + (size_t)head * a.D;
    T* d = dst + j * LD + c;
    if (a.vec) {
      const bool ok = c < a.D;
      cp_async_zfill(d, ok ? src + c : pool, ok, 16);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) d[e] = c + e < a.D ? src[c + e] : T(0);
    }
  }
  if (scales != nullptr && lane < nk) cp_async_zfill(sc + lane, scales + prow, true, 4);
}

// lane j's dot of the query row with its key row, f32 (four sums, one per
// element of a 4-element unit) or int8 levels dequantized as they are read
// (float(level) * scale, one rounding: the plain version's value)
template <int DP>
__device__ __forceinline__ float decode_dot(const float* qs, const float* kr, float) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < DP; c += 4) {
    const float4 kv = *reinterpret_cast<const float4*>(kr + c);
    const float4 qv = *reinterpret_cast<const float4*>(qs + c);
    acc[0] = fmaf(qv.x, kv.x, acc[0]);
    acc[1] = fmaf(qv.y, kv.y, acc[1]);
    acc[2] = fmaf(qv.z, kv.z, acc[2]);
    acc[3] = fmaf(qv.w, kv.w, acc[3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}
template <int DP>
__device__ __forceinline__ float decode_dot(const float* qs, const int8_t* kr, float ks) {
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int c = 0; c < DP; c += 16) {
    const int4 raw = *reinterpret_cast<const int4*>(kr + c);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e & 3] = fmaf(qs[c + e], __fmul_rn((float)b[e], ks), acc[e & 3]);
  }
  return (acc[0] + acc[1]) + (acc[2] + acc[3]);
}

// the lane's DP / 32 columns of V row vr, as f32
template <int CPL>
__device__ __forceinline__ void decode_vrow(const float* vr, float, float (&v)[CPL]) {
  if constexpr (CPL == 4) {
    const float4 x = *reinterpret_cast<const float4*>(vr);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else if constexpr (CPL == 2) {
    const float2 x = *reinterpret_cast<const float2*>(vr);
    v[0] = x.x; v[1] = x.y;
  } else {
    v[0] = vr[0];
  }
}
template <int CPL>
__device__ __forceinline__ void decode_vrow(const int8_t* vr, float vs, float (&v)[CPL]) {
#pragma unroll
  for (int e = 0; e < CPL; ++e) v[e] = __fmul_rn((float)vr[e], vs);
}

// One CTA per (slot, head, split of 128 context positions), 4 warps of 32
// positions, one a lane, gathered through the slot's table position by
// position. Each warp issues its K rows, then its V rows, as two cp.async
// groups: the scores (lane j's key, a dot from shared memory) and the
// softmax run while V lands. A warp's 32 keys are one softmax step, (m, l)
// reduced by shuffles; p v has each lane own DP / 32 columns. The warps
// merge in shared memory in warp order; a split that is its slot's only one
// writes the output, otherwise the last split of the (slot, head) to
// finish (an arrival counter, reset after) merges every split in order.
// Scores and m are in the base-2 domain (s * scale * log2(e)).
template <typename T, int DP>
__global__ void __launch_bounds__(kDThreads) paged_decode_kernel(const PagedArgs a) {
  using Sm = DecodeSmem<T, DP>;
  constexpr int LD = Sm::ld, CPL = DP / 32;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + Sm::kv);
  float* ksc = reinterpret_cast<float*>(smem + 2 * Sm::kv);
  float* vsc = ksc + kDSplit;
  float* qs = reinterpret_cast<float*>(smem + 2 * Sm::kv + Sm::scales);
  float* red = qs + DP;  // [kDWarps][DP + 2]: each warp's (m, l, acc)
  __shared__ int is_last;

  const int slot = blockIdx.x / a.H, head = blockIdx.x % a.H, split = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const float neg_inf = -CUDART_INF_F;
  // the warp's positions k0.., lane j's table entry read beside pos (both
  // loads in flight at once)
  const int k0 = split * kDSplit + warp * 32, kpos = k0 + lane, entry = kpos / a.ps;
  const int page = kpos < a.P * a.ps ? a.table[(size_t)slot * a.P + entry] : 0;
  const int pos = a.pos[slot];
  const int n_keys = pos < 0 ? 0 : min(pos + 1, a.P * a.ps);
  const int n_live = (n_keys + kDSplit - 1) / kDSplit;
  const size_t feat = (size_t)a.H * a.D;
  float* out = a.out + (size_t)slot * feat + (size_t)head * a.D;
  if (split >= n_live) {  // past the slot's pos: no pool load at all
    if (split == 0)       // pos < 0: exact zeros
      for (int c = tid; c < a.D; c += kDThreads) out[c] = 0.0f;
    return;
  }
  // the warp's live positions, a prefix of nk; lane j's pool row (a corrupt
  // table entry is clamped into the pool, as the JAX gather clamps)
  const int nk = max(0, min(32, n_keys - k0));
  const int prow = lane < nk ? min(max(page, 0), a.n_pool_pages - 1) * a.ps + (kpos - entry * a.ps)
                             : 0;
  T* kw = Ks + warp * 32 * LD;
  T* vw = Vs + warp * 32 * LD;
  decode_rows<T, DP>(a, static_cast<const T*>(a.k_pool), kInt8 ? a.k_scales : nullptr, head,
                     prow, nk, kw, ksc + warp * 32);
  cp_async_commit();
  decode_rows<T, DP>(a, static_cast<const T*>(a.v_pool), kInt8 ? a.v_scales : nullptr, head,
                     prow, nk, vw, vsc + warp * 32);
  cp_async_commit();
  const float* qrow = a.q + (size_t)slot * feat + (size_t)head * a.D;
  for (int c = tid; c < DP; c += kDThreads) qs[c] = c < a.D ? qrow[c] : 0.0f;
  __syncthreads();  // the query row is staged

  const float scale2 = a.scale * 1.4426950408889634f;
  cp_async_wait<1>();
  __syncwarp();  // the warp's K rows are here
  float s = neg_inf;
  if (lane < nk) s = decode_dot<DP>(qs, kw + lane * LD, kInt8 ? ksc[warp * 32 + lane] : 0.0f) *
                     scale2;
  float m = s;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  // dead positions are where-masked: weight exactly 0
  const float p = lane < nk ? ex2(s - m) : 0.0f;
  float l = p;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);

  cp_async_wait<0>();
  __syncwarp();  // the warp's V rows are here
  float acc[CPL];
#pragma unroll
  for (int e = 0; e < CPL; ++e) acc[e] = 0.0f;
  for (int j = 0; j < nk; ++j) {
    const float pj = __shfl_sync(0xffffffffu, p, j);
    float v[CPL];
    decode_vrow<CPL>(vw + j * LD + lane * CPL, kInt8 ? vsc[warp * 32 + j] : 0.0f, v);
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[e] = fmaf(pj, v[e], acc[e]);
  }
  float* mine = red + warp * (DP + 2);
#pragma unroll
  for (int e = 0; e < CPL; ++e) mine[2 + lane * CPL + e] = acc[e];
  if (lane == 0) {
    mine[0] = nk > 0 ? m : neg_inf;
    mine[1] = l;
  }
  __syncthreads();

  // the warps merged in warp order; a warp with no live key adds exactly 0
  float M = neg_inf;
#pragma unroll
  for (int w = 0; w < kDWarps; ++w) M = fmaxf(M, red[w * (DP + 2)]);
  float wt[kDWarps], L = 0.0f;
#pragma unroll
  for (int w = 0; w < kDWarps; ++w) {
    const float mw = red[w * (DP + 2)];
    wt[w] = mw == neg_inf ? 0.0f : ex2(mw - M);
    L += red[w * (DP + 2) + 1] * wt[w];
  }
  const int c = tid;  // one column a thread (DP <= kDThreads)
  float A = 0.0f;
  if (c < a.D) {
#pragma unroll
    for (int w = 0; w < kDWarps; ++w) A += red[w * (DP + 2) + 2 + c] * wt[w];
  }
  if (n_live == 1) {
    if (c < a.D) out[c] = A / (L > 0.0f ? L : 1.0f);
    return;
  }
  const size_t i = ((size_t)split * a.rows + slot) * a.H + head;
  if (c < a.D) a.part_acc[i * a.D + c] = A;
  if (tid == 0) {
    a.part_ml[i * 2] = M;
    a.part_ml[i * 2 + 1] = L;
  }

  // the last split of this (slot, head) to finish merges: every partial is
  // written and fenced before the count moves
  __threadfence();
  __syncthreads();
  int* counter = a.arrivals + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t stride = (size_t)a.rows * a.H;  // one split's (slot, head) entries
  const size_t i0 = (size_t)slot * a.H + head;
  float Mx = neg_inf;
  for (int sp = 0; sp < n_live; ++sp) Mx = fmaxf(Mx, __ldcg(a.part_ml + (i0 + sp * stride) * 2));
  float Ls = 0.0f, As = 0.0f;
  for (int sp = 0; sp < n_live; ++sp) {
    const size_t is = i0 + sp * stride;
    const float2 ml = __ldcg(reinterpret_cast<const float2*>(a.part_ml + is * 2));
    const float w = ex2(ml.x - Mx);  // every split holds a live key: ml.x is finite
    Ls += ml.y * w;
    if (c < a.D) As += __ldcg(a.part_acc + is * a.D + c) * w;
  }
  if (c < a.D) out[c] = As / (Ls > 0.0f ? Ls : 1.0f);
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

// ---------------------------------------------------------------------------
// Heads past 128, both forms: the position-staged wide kernel
// ---------------------------------------------------------------------------

constexpr int kWKeys = 64;      // context positions a CTA (one split)
constexpr int kWCols = 64;      // columns of d a stage
constexpr int kWThreads = 256;  // 8 warps
constexpr int kWRows = 32;      // query rows a CTA of the shared form
constexpr int kWMerge = 32;     // splits whose weights the merge holds at once

// element (j, c) of a [64][kWCols] f32 stage: 16-byte units XOR-swizzled by
// (j / 4) & 7, so the reads of keys 4x + i (x = 0..7) at one unit, and of one
// key at 8 consecutive units, each hit 32 distinct banks
__device__ __forceinline__ int wsw(int j, int c) { return j * kWCols + (c ^ (((j >> 2) & 7) << 2)); }

// A CTA's dynamic shared memory: a two-stage ring of (q chunk [R][64] f32,
// K chunk [64][64]) or (V chunk [64][64]) steps, for int8 pools one
// dequantized f32 chunk, the decode form's partial p v sums, the scores
// then probabilities [R][64] and the merge's split weights (the pool rows,
// scales and row state are static)
template <typename T, int R> struct WideSmem {
  static constexpr size_t qc = (size_t)R * kWCols * 4;
  static constexpr size_t kc = (size_t)kWKeys * kWCols * sizeof(T);
  static constexpr size_t stage = qc + kc;
  static constexpr size_t deq = sizeof(T) == 1 ? (size_t)kWKeys * kWCols * 4 : 0;
  static constexpr size_t red = R == 1 ? (size_t)16 * kWCols * 4 : 0;
  static constexpr size_t bytes = 2 * stage + deq + red + (size_t)R * (kWKeys + kWMerge) * 4;
};

// Issue step `step`'s copies into `buf`: a score step (step < nch) brings
// columns [64 c, 64 c + 64) of the R query rows and of the 64 keys' K rows,
// a value step those of V; dead keys, rows past n_rows and columns past D
// read as zeros. 16-byte cp.async where the wrapper found every row aligned
// (vec), else element by element.
template <typename T, int R>
__device__ __forceinline__ void wide_issue(const PagedArgs& a, int head, int row0, int n_rows,
                                           const int* rows, unsigned char* buf, int step,
                                           int nch) {
  using Sm = WideSmem<T, R>;
  constexpr int E = 16 / (int)sizeof(T);  // elements of a 16-byte unit
  const size_t feat = (size_t)a.H * a.D;
  const bool score = step < nch;
  const int c0 = (score ? step : step - nch) * kWCols;
  const int tid = threadIdx.x;
  if (score) {
    float* qc = reinterpret_cast<float*>(buf);
    for (int i = tid; i < R * kWCols / 4; i += kWThreads) {
      const int r = i / (kWCols / 4), c = (i % (kWCols / 4)) * 4;
      const bool ok = r < n_rows;
      const float* src = a.q + (size_t)(row0 + (ok ? r : 0)) * feat + (size_t)head * a.D + c0 + c;
      float* dst = qc + r * kWCols + c;
      if (a.vec) {
        const bool live = ok && c0 + c < a.D;
        cp_async_zfill(dst, live ? src : a.q, live, 16);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) dst[e] = ok && c0 + c + e < a.D ? src[e] : 0.0f;
      }
    }
  }
  const T* pool = static_cast<const T*>(score ? a.k_pool : a.v_pool);
  T* kd = reinterpret_cast<T*>(buf + Sm::qc);
  for (int i = tid; i < kWKeys * kWCols / E; i += kWThreads) {
    const int j = i / (kWCols / E), c = (i % (kWCols / E)) * E;
    const bool live = rows[j] >= 0;
    const T* src = pool + (live ? (size_t)rows[j] * feat + (size_t)head * a.D + c0 + c : 0);
    // f32 lands swizzled for the reads; int8 lands raw for the dequantization
    T* dst = kd + (sizeof(T) == 4 ? wsw(j, c) : j * kWCols + c);
    if (a.vec) {
      const bool ok = live && c0 + c < a.D;
      cp_async_zfill(dst, ok ? src : pool, ok, 16);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[e] = live && c0 + c + e < a.D ? src[e] : T(0);
    }
  }
}

// four columns [c, c + 4) of a row of d floats in device memory, zeros past
// d, by one 16-byte load where the row allows (L2 only: another CTA wrote
// them)
__device__ __forceinline__ float4 wide_load4(const float* src, int c, int d, bool vec4) {
  if (vec4) return __ldcg(reinterpret_cast<const float4*>(src));
  return make_float4(__ldcg(src), c + 1 < d ? __ldcg(src + 1) : 0.0f,
                     c + 2 < d ? __ldcg(src + 2) : 0.0f, c + 3 < d ? __ldcg(src + 3) : 0.0f);
}

// One CTA per (slot, head, split of 64 context positions) for the decode
// form (R = 1, a table per slot), or per (32-row tile, head, split) for the
// shared form (R = 32, one table). The split's keys are gathered position
// by position through the table, so shared memory depends neither on
// page_size nor on d: the CTA walks d in 64-column chunks, first forming s
// = q k^T chunk by chunk (each thread's dots summed in chunk order), then,
// after one softmax over the split's 64 keys, p v chunk by chunk, every
// chunk's copies in flight under the previous chunk's math. f32 FMAs on the
// CUDA cores: both forms are bound by the pool bytes they read. A split
// that is its tile's only one writes the output; otherwise the last split
// of each (tile, head) to finish, found by an integer arrival counter that
// it resets, merges the splits in split order. Scores and m are in the
// base-2 domain.
template <typename T, int R>
__global__ void __launch_bounds__(kWThreads) paged_wide_kernel(const PagedArgs a) {
  using Sm = WideSmem<T, R>;
  constexpr bool kInt8 = sizeof(T) == 1;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* deq = reinterpret_cast<float*>(smem + 2 * Sm::stage);
  float* red = deq + Sm::deq / 4;  // decode: [16][64] partial p v sums
  float* S = red + Sm::red / 4;    // [R][64]: scores, then probabilities
  float* wts = S + R * kWKeys;     // the merge's [kWMerge][R] split weights
  __shared__ int rows_s[kWKeys], pos_s[R];
  __shared__ float ksc[kWKeys], vsc[kWKeys], m_s[R], l_s[R];
  __shared__ int max_pos_s, is_last;

  const int head = blockIdx.x % a.H, tile = blockIdx.x / a.H, split = blockIdx.y;
  const int row0 = tile * R, n_rows = min(R, a.rows - row0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t feat = (size_t)a.H * a.D;
  const float neg_inf = -CUDART_INF_F;
  const int* table = R == 1 ? a.table + (size_t)tile * a.P : a.table;
  if (warp == 0) {
    int mx = -1;
    for (int r = lane; r < R; r += 32) {
      const int pr = r < n_rows ? a.pos[row0 + r] : -1;
      pos_s[r] = pr;
      mx = max(mx, pr);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    if (lane == 0) max_pos_s = mx;
  }
  __syncthreads();
  const int n_keys = max_pos_s < 0 ? 0 : min(max_pos_s + 1, a.P * a.ps);
  const int n_live = (n_keys + kWKeys - 1) / kWKeys;
  if (split >= n_live) {  // past the tile's last key: no pool load at all
    if (split == 0)       // no live key for any row: exact zeros
      for (int i = tid; i < n_rows * a.D; i += kWThreads)
        a.out[(size_t)(row0 + i / a.D) * feat + (size_t)head * a.D + i % a.D] = 0.0f;
    return;
  }
  const int k_begin = split * kWKeys, nk = min(kWKeys, n_keys - k_begin);
  if (tid < kWKeys) {
    // a corrupt table entry is clamped into the pool, as the JAX gather clamps
    int prow = -1;
    if (tid < nk) {
      const int kpos = k_begin + tid, entry = kpos / a.ps;
      prow = min(max(table[entry], 0), a.n_pool_pages - 1) * a.ps + (kpos - entry * a.ps);
    }
    rows_s[tid] = prow;
    if (kInt8) {
      ksc[tid] = prow >= 0 ? a.k_scales[prow] : 0.0f;
      vsc[tid] = prow >= 0 ? a.v_scales[prow] : 0.0f;
    }
  }
  __syncthreads();
  const int nch = (a.D + kWCols - 1) / kWCols, n_steps = 2 * nch;
  wide_issue<T, R>(a, head, row0, n_rows, rows_s, ring, 0, nch);
  cp_async_commit();

  // R = 32: thread (ty, tx) takes rows 2ty, 2ty + 1 and keys 4tx.. (scores)
  // or columns 4tx.. (p v); R = 1: key tid / 4 over every fourth unit
  // (scores), or unit tid % 16 over every 16th key (p v)
  const int ty = tid >> 4, tx = tid & 15;
  float acc[2][4];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[x][e] = 0.0f;
  const float scale2 = a.scale * 1.4426950408889634f;
  const bool single = n_live == 1;

  for (int step = 0; step < n_steps; ++step) {
    cp_async_wait<0>();
    __syncthreads();  // step's chunk is here; every thread is done with the last
    if (step + 1 < n_steps) {
      wide_issue<T, R>(a, head, row0, n_rows, rows_s, ring + ((step + 1) & 1) * Sm::stage,
                       step + 1, nch);
      cp_async_commit();
    }
    unsigned char* buf = ring + (step & 1) * Sm::stage;
    const float* qc = reinterpret_cast<const float*>(buf);
    const float* kc = reinterpret_cast<const float*>(buf + Sm::qc);
    const bool score = step < nch;
    if constexpr (kInt8) {
      // one rounding, float(level) * scale[row]: the plain version's value
      const int8_t* raw = reinterpret_cast<const int8_t*>(buf + Sm::qc);
      const float* sc = score ? ksc : vsc;
      for (int i = tid; i < kWKeys * kWCols / 4; i += kWThreads) {
        const int j = i / (kWCols / 4), c = (i % (kWCols / 4)) * 4;
        const char4 x = *reinterpret_cast<const char4*>(raw + j * kWCols + c);
        *reinterpret_cast<float4*>(deq + wsw(j, c)) =
            make_float4(__fmul_rn((float)x.x, sc[j]), __fmul_rn((float)x.y, sc[j]),
                        __fmul_rn((float)x.z, sc[j]), __fmul_rn((float)x.w, sc[j]));
      }
      __syncthreads();
      kc = deq;
    }
    if (score) {
      if constexpr (R == 1) {
        const int j = tid >> 2, qq = tid & 3;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 4 * (qq + 4 * i);
          const float4 qv = *reinterpret_cast<const float4*>(qc + c);
          const float4 kv = *reinterpret_cast<const float4*>(kc + wsw(j, c));
          acc[0][i] = fmaf(qv.x, kv.x, acc[0][i]);
          acc[0][i] = fmaf(qv.y, kv.y, acc[0][i]);
          acc[0][i] = fmaf(qv.z, kv.z, acc[0][i]);
          acc[0][i] = fmaf(qv.w, kv.w, acc[0][i]);
        }
      } else {
#pragma unroll 4
        for (int c = 0; c < kWCols; c += 4) {
          const float4 q0 = *reinterpret_cast<const float4*>(qc + (2 * ty) * kWCols + c);
          const float4 q1 = *reinterpret_cast<const float4*>(qc + (2 * ty + 1) * kWCols + c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 kv = *reinterpret_cast<const float4*>(kc + wsw(4 * tx + i, c));
            acc[0][i] = fmaf(q0.x, kv.x, acc[0][i]);
            acc[0][i] = fmaf(q0.y, kv.y, acc[0][i]);
            acc[0][i] = fmaf(q0.z, kv.z, acc[0][i]);
            acc[0][i] = fmaf(q0.w, kv.w, acc[0][i]);
            acc[1][i] = fmaf(q1.x, kv.x, acc[1][i]);
            acc[1][i] = fmaf(q1.y, kv.y, acc[1][i]);
            acc[1][i] = fmaf(q1.z, kv.z, acc[1][i]);
            acc[1][i] = fmaf(q1.w, kv.w, acc[1][i]);
          }
        }
      }
      if (step + 1 < nch) continue;
      // the scores, where-masked by each row's pos, then one softmax a row
      if constexpr (R == 1) {
        const int j = tid >> 2;
        float d = (acc[0][0] + acc[0][1]) + (acc[0][2] + acc[0][3]);
        d += __shfl_xor_sync(0xffffffffu, d, 1);
        d += __shfl_xor_sync(0xffffffffu, d, 2);
        if ((tid & 3) == 0) S[j] = j < nk && k_begin + j <= pos_s[0] ? d * scale2 : neg_inf;
      } else {
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = 2 * ty + x, j = 4 * tx + i;
            S[r * kWKeys + j] = j < nk && k_begin + j <= pos_s[r] ? acc[x][i] * scale2 : neg_inf;
          }
      }
      __syncthreads();
      for (int r = warp; r < R; r += kWThreads / 32) {
        float* sr = S + r * kWKeys;
        const float s0 = sr[lane], s1 = sr[lane + 32];
        float mx = fmaxf(s0, s1);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        // dead entries weigh exactly 0; a row with none live keeps m = -inf
        const float p0 = s0 == neg_inf ? 0.0f : ex2(s0 - mx);
        const float p1 = s1 == neg_inf ? 0.0f : ex2(s1 - mx);
        float sum = p0 + p1;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
        sr[lane] = p0;
        sr[lane + 32] = p1;
        if (lane == 0) {
          m_s[r] = mx;
          l_s[r] = sum;
        }
      }
      continue;  // the next step's barrier makes S, m and l visible
    }
    // p v over columns [c0, c0 + 64): the split's unnormalized sum (or, for a
    // single split, the output)
    const int c0 = (step - nch) * kWCols;
    if constexpr (R == 1) {
      const int u = tid & 15, kg = tid >> 4;
      float o4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int j = kg; j < nk; j += 16) {
        const float pj = S[j];
        const float4 vv = *reinterpret_cast<const float4*>(kc + wsw(j, 4 * u));
        o4[0] = fmaf(pj, vv.x, o4[0]);
        o4[1] = fmaf(pj, vv.y, o4[1]);
        o4[2] = fmaf(pj, vv.z, o4[2]);
        o4[3] = fmaf(pj, vv.w, o4[3]);
      }
      *reinterpret_cast<float4*>(red + kg * kWCols + 4 * u) = make_float4(o4[0], o4[1], o4[2], o4[3]);
      __syncthreads();
      if (tid < kWCols && c0 + tid < a.D) {
        float o = 0.0f;
#pragma unroll
        for (int g = 0; g < 16; ++g) o += red[g * kWCols + tid];  // key groups in order
        const size_t i = ((size_t)split * a.rows + row0) * a.H + head;
        if (single) a.out[(size_t)row0 * feat + (size_t)head * a.D + c0 + tid] =
            o / (l_s[0] > 0.0f ? l_s[0] : 1.0f);
        else a.part_acc[i * a.D + c0 + tid] = o;
      }
    } else {
      float o[2][4];
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[x][e] = 0.0f;
      for (int j = 0; j < nk; ++j) {
        const float p0 = S[(2 * ty) * kWKeys + j], p1 = S[(2 * ty + 1) * kWKeys + j];
        const float4 vv = *reinterpret_cast<const float4*>(kc + wsw(j, 4 * tx));
        o[0][0] = fmaf(p0, vv.x, o[0][0]);
        o[0][1] = fmaf(p0, vv.y, o[0][1]);
        o[0][2] = fmaf(p0, vv.z, o[0][2]);
        o[0][3] = fmaf(p0, vv.w, o[0][3]);
        o[1][0] = fmaf(p1, vv.x, o[1][0]);
        o[1][1] = fmaf(p1, vv.y, o[1][1]);
        o[1][2] = fmaf(p1, vv.z, o[1][2]);
        o[1][3] = fmaf(p1, vv.w, o[1][3]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = 2 * ty + x;
        if (r >= n_rows) continue;
        const float inv = 1.0f / (l_s[r] > 0.0f ? l_s[r] : 1.0f);
        const size_t i = ((size_t)split * a.rows + row0 + r) * a.H + head;
        float* dst = single ? a.out + (size_t)(row0 + r) * feat + (size_t)head * a.D
                            : a.part_acc + i * a.D;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + 4 * tx + e;
          if (c < a.D) dst[c] = single ? o[x][e] * inv : o[x][e];
        }
      }
    }
  }
  if (single) return;
  if (tid < n_rows) {
    const size_t i = ((size_t)split * a.rows + row0 + tid) * a.H + head;
    a.part_ml[i * 2] = m_s[tid];
    a.part_ml[i * 2 + 1] = l_s[tid];
  }

  // the last split of this (tile, head) to finish merges: every partial is
  // written and fenced before the count moves
  __threadfence();
  __syncthreads();
  int* counter = a.arrivals + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(counter, 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t stride = (size_t)a.rows * a.H;  // one split's (row, head) entries
  auto ml = [&](int sp, int r) {
    return a.part_ml + (((size_t)row0 + r) * a.H + head + sp * stride) * 2;
  };
  // per row M = max m_s and 1 / L, L = sum l_s 2^(m_s - M): a warp a row,
  // lane k over splits k, k + 32, .., joined by the same butterfly each time
  for (int r = warp; r < n_rows; r += kWThreads / 32) {
    float mx = neg_inf;
    for (int sp = lane; sp < n_live; sp += 32) mx = fmaxf(mx, __ldcg(ml(sp, r)));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.0f;
    for (int sp = lane; sp < n_live; sp += 32) {
      const float2 x = __ldcg(reinterpret_cast<const float2*>(ml(sp, r)));
      if (x.x != neg_inf) sum += x.y * ex2(x.x - mx);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = 1.0f / (sum > 0.0f ? sum : 1.0f);
    }
  }
  // out = sum acc_s 2^(m_s - M) / L in split order, four columns a thread:
  // the weights of kWMerge splits at a time staged in shared memory, four
  // splits' loads in flight before their sums (past kWMerge splits the
  // running sum waits in out, unnormalized)
  const int U = (a.D + 3) / 4;
  const bool vec4 = a.D % 4 == 0;
  for (int s0 = 0; s0 < n_live; s0 += kWMerge) {
    const int nc = min(kWMerge, n_live - s0);
    const bool last = s0 + nc == n_live;
    __syncthreads();  // M and 1 / L are set; the last chunk's weights are used
    for (int i = tid; i < nc * R; i += kWThreads) {
      const int r = i % R;
      const float ms = r < n_rows ? __ldcg(ml(s0 + i / R, r)) : neg_inf;
      wts[i] = ms == neg_inf ? 0.0f : ex2(ms - m_s[r]);
    }
    __syncthreads();
    for (int e = tid; e < n_rows * U; e += kWThreads) {
      const int r = e / U, c = 4 * (e - r * U);
      float* dst = a.out + (size_t)(row0 + r) * feat + (size_t)head * a.D + c;
      float4 acc = s0 > 0 ? wide_load4(dst, c, a.D, vec4) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j0 = 0; j0 < nc; j0 += 4) {
        float4 x[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          x[j] = j0 + j < nc
                     ? wide_load4(a.part_acc + (((size_t)row0 + r) * a.H + head +
                                                (s0 + j0 + j) * stride) * a.D + c,
                                  c, a.D, vec4)
                     : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // 0 for a split with no live key (and past nc, where x is 0 too)
          const float w = j0 + j < nc ? wts[(j0 + j) * R + r] : 0.0f;
          acc.x = fmaf(x[j].x, w, acc.x);
          acc.y = fmaf(x[j].y, w, acc.y);
          acc.z = fmaf(x[j].z, w, acc.z);
          acc.w = fmaf(x[j].w, w, acc.w);
        }
      }
      const float f = last ? l_s[r] : 1.0f;
      acc = make_float4(acc.x * f, acc.y * f, acc.z * f, acc.w * f);
      if (vec4) {
        *reinterpret_cast<float4*>(dst) = acc;
      } else {
        dst[0] = acc.x;
        if (c + 1 < a.D) dst[1] = acc.y;
        if (c + 2 < a.D) dst[2] = acc.z;
        if (c + 3 < a.D) dst[3] = acc.w;
      }
    }
  }
  if (tid == 0) *counter = 0;  // ready for the next launch on this stream
}

// Opt the kernel into more than the default 48 KB of shared memory when a
// shape needs it: the dynamic bytes and the kernel's static arrays (under
// 2 KB in each kernel here) count against the same limit.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes + 2048 > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

// context positions one split covers: the decode kernel's 128 (D <=
// kDMaxD), the tensor-core shared kernel's kSStages 64-key stages (D <=
// kSMaxD), the wide kernel's 64 (either form, past 128)
__host__ inline int split_span(int D, bool shared) {
  if (shared) return D <= kSMaxD ? kSKeys * kSStages : kWKeys;
  return D <= kDMaxD ? kDSplit : kWKeys;
}

__host__ inline int splits_of(int P, int page_size, int D, bool shared) {
  const int span = split_span(D, shared);
  return (int)(((int64_t)P * page_size + span - 1) / span);
}

template <typename T, int DP>
cudaError_t launch_decode_warp(const PagedArgs& a, int splits, cudaStream_t st) {
  constexpr size_t bytes = DecodeSmem<T, DP>::bytes;
  cudaError_t err = prepare(paged_decode_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, DP><<<dim3(a.rows * a.H, splits), kDThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_wide(const PagedArgs& a, int groups, int splits, cudaStream_t st) {
  constexpr size_t bytes = WideSmem<T, R>::bytes;
  cudaError_t err = prepare(paged_wide_kernel<T, R>, bytes);
  if (err != cudaSuccess) return err;
  paged_wide_kernel<T, R><<<dim3(groups * a.H, splits), kWThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// D <= kDMaxD: paged_decode_kernel; wider heads: paged_wide_kernel (R = 1).
// Either merges its splits in the last one to finish (arrivals: S * H ints,
// all 0, left at 0).
template <typename T>
int launch_decode(const float* q, const T* k_pool, const T* v_pool, const float* k_scales,
                  const float* v_scales, int vec, const int* block_table, const int* pos,
                  float* out, float* part_acc, float* part_ml, int* arrivals, int S, int H,
                  int D, int P, int page_size, int pool_rows, float scale, void* stream) {
  if (S <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || P <= 0 || page_size <= 0 || pool_rows < page_size || arrivals == nullptr)
    return cudaErrorInvalidValue;
  const int splits = splits_of(P, page_size, D, false);
  if (splits > 65535 || (int64_t)S * H > 2147483647LL) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const PagedArgs a{q, k_pool, v_pool, k_scales, v_scales, block_table, pos, out, part_acc,
                    part_ml, arrivals, S, H, D, P, page_size, pool_rows / page_size, vec, scale};
  if (D > kDMaxD) return launch_wide<T, 1>(a, S, splits, st);
  if (D <= 32) return launch_decode_warp<T, 32>(a, splits, st);
  if (D <= 64) return launch_decode_warp<T, 64>(a, splits, st);
  return launch_decode_warp<T, 128>(a, splits, st);
}

template <typename T, int DP>
cudaError_t launch_shared_tc(const PagedArgs& a, int splits, cudaStream_t st) {
  constexpr size_t bytes = SharedSmem<T, DP>::bytes;
  cudaError_t err = prepare(paged_flash_shared_tc_kernel<T, DP>, bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (a.rows + kSRows - 1) / kSRows;
  paged_flash_shared_tc_kernel<T, DP><<<dim3(n_tiles * a.H, splits), kSThreads, bytes, st>>>(a);
  return cudaGetLastError();
}

// D <= kSMaxD: the tensor-core kernel; wider heads: paged_wide_kernel (R =
// 32). Either merges its splits in the last one to finish (arrivals:
// ceil(rows / 32) * H ints, all 0, left at 0).
template <typename T>
int launch_shared(const float* q, const T* k_pool, const T* v_pool, const float* k_scales,
                  const float* v_scales, int vec, const int* block_table, const int* pos,
                  float* out, float* part_acc, float* part_ml, int* arrivals, int rows, int H,
                  int D, int P, int page_size, int pool_rows, float scale, void* stream) {
  if (rows <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || P <= 0 || page_size <= 0 || pool_rows < page_size || arrivals == nullptr)
    return cudaErrorInvalidValue;
  const int splits = splits_of(P, page_size, D, true);
  if (splits > 65535) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static_assert(kSRows == kWRows, "both shared forms count arrivals by 32-row tile");
  const PagedArgs a{q, k_pool, v_pool, k_scales, v_scales, block_table, pos, out, part_acc,
                    part_ml, arrivals, rows, H, D, P, page_size, pool_rows / page_size, vec,
                    scale};
  if (D > kSMaxD) return launch_wide<T, kWRows>(a, (rows + kWRows - 1) / kWRows, splits, st);
  if (D <= 32) return launch_shared_tc<T, 32>(a, splits, st);
  if (D <= 64) return launch_shared_tc<T, 64>(a, splits, st);
  return launch_shared_tc<T, 128>(a, splits, st);
}

}  // namespace

extern "C" {

// Splits of the walk over a table of P entries, for the per-split scratch
// the caller passes (splits * rows * H * (D + 2) floats): shared = 1 for the
// shared-table form, 0 for the decode form.
int paged_flash_splits(int P, int page_size, int D, int shared) {
  return P > 0 && page_size > 0 ? splits_of(P, page_size, D, shared != 0) : 0;
}

// q [S, H*D], pools [pool_rows, H*D], block_table [S, P], pos [S] -> out [S, H*D];
// vec: the wrapper found D, H*D and both pools' addresses to allow 16-byte
// row loads; arrivals: S * H ints, all 0 (left at 0)
int paged_flash_decode(const float* q, const float* k_pool, const float* v_pool, int vec,
                       const int* block_table, const int* pos, float* out,
                       float* part_acc, float* part_ml, int* arrivals, int S, int H, int D,
                       int P, int page_size, int pool_rows, float scale, void* stream) {
  return launch_decode<float>(q, k_pool, v_pool, nullptr, nullptr, vec, block_table, pos, out,
                              part_acc, part_ml, arrivals, S, H, D, P, page_size, pool_rows,
                              scale, stream);
}

// q [rows, H*D], pools [pool_rows, H*D], block_table [P], pos [rows] -> out [rows, H*D];
// vec: the wrapper found D, H*D and both pools' addresses to allow 16-byte
// row loads; arrivals: ceil(rows / 32) * H ints, all 0 (left at 0)
int paged_flash_shared(const float* q, const float* k_pool, const float* v_pool, int vec,
                       const int* block_table, const int* pos, float* out,
                       float* part_acc, float* part_ml, int* arrivals, int rows, int H, int D,
                       int P, int page_size, int pool_rows, float scale, void* stream) {
  return launch_shared<float>(q, k_pool, v_pool, nullptr, nullptr, vec, block_table, pos, out,
                              part_acc, part_ml, arrivals, rows, H, D, P, page_size, pool_rows,
                              scale, stream);
}

// The int8 forms: int8 pools [pool_rows, H*D] and f32 scale pools
// [pool_rows]; vec: the wrapper found D, H*D and both pools' addresses to be
// multiples of 16 bytes.
int paged_flash_decode_int8(const float* q, const int8_t* k_pool, const int8_t* v_pool,
                            const float* k_scales, const float* v_scales, int vec,
                            const int* block_table, const int* pos, float* out,
                            float* part_acc, float* part_ml, int* arrivals, int S, int H, int D,
                            int P, int page_size, int pool_rows, float scale, void* stream) {
  return launch_decode<int8_t>(q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos,
                               out, part_acc, part_ml, arrivals, S, H, D, P, page_size,
                               pool_rows, scale, stream);
}

int paged_flash_shared_int8(const float* q, const int8_t* k_pool, const int8_t* v_pool,
                            const float* k_scales, const float* v_scales, int vec,
                            const int* block_table, const int* pos, float* out,
                            float* part_acc, float* part_ml, int* arrivals, int rows, int H,
                            int D, int P, int page_size, int pool_rows, float scale,
                            void* stream) {
  return launch_shared<int8_t>(q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos,
                               out, part_acc, part_ml, arrivals, rows, H, D, P, page_size,
                               pool_rows, scale, stream);
}

const char* paged_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
