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
// least time is the K/V pages read up to pos over the HBM rate. Each needed
// K/V page of a head is read once per CTA, and the page walk is split across
// CTAs so that enough of them are in flight to keep HBM busy (one CTA per
// (slot, head) gives only 96 CTAs at 8 slots x 12 heads, each walking up to
// 64 pages one after another; a prefill chunk gave 12):
//   decode: one CTA per (slot, head, split), walking the slot's table only up
//           to its pos (pages wholly past pos are never loaded);
//   shared: one CTA per (tile of up to 32 query rows, head, split); each page
//           is staged in shared memory once and reused by every row of the
//           tile, the walk stops at the tile's max(pos), and a per-row
//           offs <= pos[r] mask applies inside the page.
// A split covers `pages_per_split` consecutive table entries. Each CTA keeps
// its rows' online-softmax state (m, l, acc[D]) in shared memory and writes
// it, unnormalized, to a scratch buffer; a second kernel merges a row's
// splits (flash-decoding): M = max m_s, L = sum l_s e^(m_s - M),
// out = sum acc_s e^(m_s - M) / L.
// Scores and the P.V product are plain f32 FMAs (no tensor cores): f32 in,
// f32 out, f32 accumulation. wgmma/TMA pipelines are left for later work.
//
// int8 pools: the pools hold symmetric int8 levels, one row per token for
// every head, and a [pool_rows] f32 scale pool per pool holds each row's
// scale (shared by all heads). A CTA dequantizes its head's slice of each
// page row as it stages it in shared memory, float(level) * scale[row]:
// one rounding, the plain version's exact value, so the f32 rows never
// reach device memory. A head's slice of a row is D contiguous bytes (64 at
// GPT-2 small's widths), loaded as 16-byte vectors when D, the row width
// and the pool's address allow. Bound: bytes, 1 byte per K/V element plus
// 4 bytes of scale per K/V row read, a quarter of the f32 pools' traffic.
// Everything after the page is staged is the f32 kernel's code.
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

namespace {

constexpr int kThreads = 128;
constexpr int kSharedTile = 32;

struct Smem {
  float* q;      // [tile][D + 1]  (row stride padded: no bank conflicts)
  float* k;      // [ps][D + 1]
  float* v;      // [ps][D + 1]
  float* s;      // [tile][ps]     scores, then probabilities
  float* acc;    // [tile][D]
  float* m;      // [tile]
  float* l;      // [tile]
  float* alpha;  // [tile]
  int* pos;      // [tile]
};

__host__ __device__ inline size_t smem_floats(int tile, int D, int ps) {
  return (size_t)tile * (D + 1) + 2 * (size_t)ps * (D + 1) + (size_t)tile * ps +
         (size_t)tile * D + 3 * (size_t)tile;
}

__host__ inline size_t smem_bytes(int tile, int D, int ps) {
  return smem_floats(tile, D, ps) * sizeof(float) + (size_t)tile * sizeof(int);
}

__device__ inline Smem carve(float* base, int tile, int D, int ps) {
  Smem sm;
  sm.q = base;
  sm.k = sm.q + (size_t)tile * (D + 1);
  sm.v = sm.k + (size_t)ps * (D + 1);
  sm.s = sm.v + (size_t)ps * (D + 1);
  sm.acc = sm.s + (size_t)tile * ps;
  sm.m = sm.acc + (size_t)tile * D;
  sm.l = sm.m + tile;
  sm.alpha = sm.l + tile;
  sm.pos = reinterpret_cast<int*>(sm.alpha + tile);
  return sm;
}

// Pages row r reads: positions 0..pos[r], capped at the table's P entries.
__device__ __forceinline__ int pages_for(int pos, int ps, int P) {
  return pos < 0 ? 0 : min(P, pos / ps + 1);
}

// Stage one page's K and V rows of `head` into shared memory as f32:
// f32 pools copy, int8 pools dequantize (float(level) * scale[row]; the
// product is stored as is, so nothing contracts it). `vec`: D, the row
// width and the pools' addresses are multiples of 16 bytes, and each
// thread loads whole 16-byte vectors of levels.
__device__ __forceinline__ void stage_page(const float* __restrict__ k_pool,
                                           const float* __restrict__ v_pool, const float*,
                                           const float*, const Smem& sm, size_t base,
                                           size_t feat, int head, int D, int ps, bool,
                                           int tid, int nt) {
  for (int i = tid; i < ps * D; i += nt) {
    const int j = i / D, d = i - j * D;
    const size_t g = (base + j) * feat + (size_t)head * D + d;
    sm.k[j * (D + 1) + d] = k_pool[g];
    sm.v[j * (D + 1) + d] = v_pool[g];
  }
}

__device__ __forceinline__ void stage_page(const int8_t* __restrict__ k_pool,
                                           const int8_t* __restrict__ v_pool,
                                           const float* __restrict__ k_scales,
                                           const float* __restrict__ v_scales, const Smem& sm,
                                           size_t base, size_t feat, int head, int D, int ps,
                                           bool vec, int tid, int nt) {
  if (vec) {
    const int per_row = D / 16;
    for (int i = tid; i < ps * per_row; i += nt) {
      const int j = i / per_row, d0 = (i - j * per_row) * 16;
      const size_t g = (base + j) * feat + (size_t)head * D + d0;
      const int4 kv = *reinterpret_cast<const int4*>(k_pool + g);
      const int4 vv = *reinterpret_cast<const int4*>(v_pool + g);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kv);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vv);
      const float ks = k_scales[base + j], vs = v_scales[base + j];
      float* kd = sm.k + j * (D + 1) + d0;
      float* vd = sm.v + j * (D + 1) + d0;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        kd[e] = __fmul_rn((float)kb[e], ks);
        vd[e] = __fmul_rn((float)vb[e], vs);
      }
    }
    return;
  }
  for (int i = tid; i < ps * D; i += nt) {
    const int j = i / D, d = i - j * D;
    const size_t g = (base + j) * feat + (size_t)head * D + d;
    sm.k[j * (D + 1) + d] = __fmul_rn((float)k_pool[g], k_scales[base + j]);
    sm.v[j * (D + 1) + d] = __fmul_rn((float)v_pool[g], v_scales[base + j]);
  }
}

// One CTA: `n_rows` (<= tile) query rows starting at q row `row0`, one head,
// table entries [split * pps, (split + 1) * pps) of the page list `table`
// (P entries). Writes the rows' unnormalized state to the split scratch:
// part_acc [splits][rows][H][D], part_ml [splits][rows][H][2] = (m, l).
// A split past the tile's last needed page writes nothing: the merge never
// reads it.
template <typename T>
__device__ void paged_flash_tile(const float* __restrict__ q,
                                 const T* __restrict__ k_pool,
                                 const T* __restrict__ v_pool,
                                 const float* __restrict__ k_scales,
                                 const float* __restrict__ v_scales, bool vec,
                                 const int* __restrict__ table,
                                 const int* __restrict__ pos,
                                 float* __restrict__ part_acc,
                                 float* __restrict__ part_ml, int rows, int row0,
                                 int n_rows, int tile, int head, int split, int pps,
                                 int H, int D, int P, int ps, int n_pool_pages,
                                 float scale) {
  extern __shared__ float smem_raw[];
  const Smem sm = carve(smem_raw, tile, D, ps);
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t feat = (size_t)H * D;
  const float neg_inf = -CUDART_INF_F;

  // pages up to the tile's max(pos), capped at the table's length
  int max_pos = -1;
  for (int r = 0; r < n_rows; ++r) max_pos = max(max_pos, pos[row0 + r]);
  const int p_begin = split * pps;
  const int p_end = min(pages_for(max_pos, ps, P), p_begin + pps);
  if (p_begin >= p_end) return;

  for (int i = tid; i < tile * D; i += nt) {
    const int r = i / D, d = i - r * D;
    sm.q[r * (D + 1) + d] = r < n_rows ? q[(row0 + r) * feat + (size_t)head * D + d] : 0.f;
    sm.acc[i] = 0.f;
  }
  for (int r = tid; r < tile; r += nt) {
    sm.pos[r] = r < n_rows ? pos[row0 + r] : -1;
    sm.m[r] = neg_inf;
    sm.l[r] = 0.f;
  }
  __syncthreads();

  for (int p = p_begin; p < p_end; ++p) {
    // a corrupt table entry is clamped into the pool rather than read out of
    // bounds (the JAX gather clamps the same way)
    const int page = min(max(table[p], 0), n_pool_pages - 1);
    const size_t base = (size_t)page * ps;
    stage_page(k_pool, v_pool, k_scales, v_scales, sm, base, feat, head, D, ps, vec, tid, nt);
    __syncthreads();

    for (int i = tid; i < tile * ps; i += nt) {
      const int r = i / ps, j = i - r * ps;
      float sc = neg_inf;
      if (p * ps + j <= sm.pos[r]) {
        const float* qr = sm.q + r * (D + 1);
        const float* kj = sm.k + j * (D + 1);
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kj[d], dot);
        sc = dot * scale;
      }
      sm.s[i] = sc;
    }
    __syncthreads();

    for (int r = tid; r < tile; r += nt) {
      float* sr = sm.s + r * ps;
      const float m_prev = sm.m[r];
      float m_cur = neg_inf;
      for (int j = 0; j < ps; ++j) m_cur = fmaxf(m_cur, sr[j]);
      const float m_new = fmaxf(m_prev, m_cur);
      // exp(-inf - -inf) is nan: a row that has seen nothing live yet
      // rescales by exactly 0
      const float alpha = m_prev == neg_inf ? 0.f : expf(m_prev - m_new);
      float sum = 0.f;
      for (int j = 0; j < ps; ++j) {
        const float pj = (p * ps + j <= sm.pos[r]) ? expf(sr[j] - m_new) : 0.f;
        sr[j] = pj;
        sum += pj;
      }
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.m[r] = m_new;
      sm.alpha[r] = alpha;
    }
    __syncthreads();

    for (int i = tid; i < tile * D; i += nt) {
      const int r = i / D, d = i - r * D;
      const float* pr = sm.s + r * ps;
      float a = sm.acc[i] * sm.alpha[r];
      for (int j = 0; j < ps; ++j) a = fmaf(pr[j], sm.v[j * (D + 1) + d], a);
      sm.acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < n_rows * D; i += nt) {
    const int r = i / D, d = i - r * D;
    part_acc[(((size_t)split * rows + row0 + r) * H + head) * D + d] = sm.acc[i];
  }
  for (int r = tid; r < n_rows; r += nt) {
    float* ml = part_ml + (((size_t)split * rows + row0 + r) * H + head) * 2;
    ml[0] = sm.m[r];
    ml[1] = sm.l[r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_flash_decode_kernel(const float* q, const T* k_pool, const T* v_pool,
                              const float* k_scales, const float* v_scales, int vec,
                              const int* block_table, const int* pos, float* part_acc,
                              float* part_ml, int rows, int pps, int H, int D, int P,
                              int ps, int n_pool_pages, float scale) {
  const int slot = blockIdx.x;
  paged_flash_tile<T>(q, k_pool, v_pool, k_scales, v_scales, vec != 0,
                      block_table + (size_t)slot * P, pos, part_acc, part_ml, rows, slot, 1,
                      1, blockIdx.y, blockIdx.z, pps, H, D, P, ps, n_pool_pages, scale);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_flash_shared_kernel(const float* q, const T* k_pool, const T* v_pool,
                              const float* k_scales, const float* v_scales, int vec,
                              const int* block_table, const int* pos, float* part_acc,
                              float* part_ml, int rows, int tile, int pps, int H, int D,
                              int P, int ps, int n_pool_pages, float scale) {
  const int row0 = blockIdx.x * tile;
  paged_flash_tile<T>(q, k_pool, v_pool, k_scales, v_scales, vec != 0, block_table, pos,
                      part_acc, part_ml, rows, row0, min(tile, rows - row0), tile, blockIdx.y,
                      blockIdx.z, pps, H, D, P, ps, n_pool_pages, scale);
}

// One CTA per (row, head): merge the row's splits into the output. Only the
// splits that cover the row's own pages are read; each was written by its
// CTA (a tile's max(pos) is at least the row's pos).
__global__ void __launch_bounds__(kThreads)
    paged_flash_merge_kernel(const float* __restrict__ part_acc,
                             const float* __restrict__ part_ml,
                             const int* __restrict__ pos, float* __restrict__ out,
                             int rows, int pps, int H, int D, int P, int ps) {
  const int row = blockIdx.x, head = blockIdx.y;
  const int n_splits = (pages_for(pos[row], ps, P) + pps - 1) / pps;
  const float neg_inf = -CUDART_INF_F;
  float m_max = neg_inf;
  for (int s = 0; s < n_splits; ++s)
    m_max = fmaxf(m_max, part_ml[(((size_t)s * rows + row) * H + head) * 2]);
  float l_sum = 0.f;
  for (int s = 0; s < n_splits; ++s) {
    const float* ml = part_ml + (((size_t)s * rows + row) * H + head) * 2;
    if (ml[0] != neg_inf) l_sum += ml[1] * expf(ml[0] - m_max);
  }
  const float inv = 1.f / (l_sum > 0.f ? l_sum : 1.f);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t i = ((size_t)s * rows + row) * H + head;
      const float m = part_ml[i * 2];
      if (m != neg_inf) a = fmaf(part_acc[i * D + d], expf(m - m_max), a);
    }
    out[(size_t)row * H * D + (size_t)head * D + d] = a * inv;
  }
}

// Opt the kernel into more than the default 48 KB of dynamic shared memory
// when a shape needs it; cudaErrorInvalidValue past the card's 227 KB.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes > 48 * 1024)
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  return cudaSuccess;
}

__host__ inline int n_splits(int P, int pages_per_split) {
  return (P + pages_per_split - 1) / pages_per_split;
}

template <typename T>
int launch_decode(const float* q, const T* k_pool, const T* v_pool, const float* k_scales,
                  const float* v_scales, int vec, const int* block_table, const int* pos,
                  float* out, float* part_acc, float* part_ml, int S, int H, int D, int P,
                  int page_size, int pool_rows, int pages_per_split, float scale,
                  void* stream) {
  if (S <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || P <= 0 || page_size <= 0 || pool_rows < page_size || pages_per_split <= 0)
    return cudaErrorInvalidValue;
  const size_t bytes = smem_bytes(1, D, page_size);
  cudaError_t err = prepare(paged_flash_decode_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int splits = n_splits(P, pages_per_split);
  cudaStream_t st = (cudaStream_t)stream;
  paged_flash_decode_kernel<T><<<dim3(S, H, splits), kThreads, bytes, st>>>(
      q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos, part_acc, part_ml, S,
      pages_per_split, H, D, P, page_size, pool_rows / page_size, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_flash_merge_kernel<<<dim3(S, H), kThreads, 0, st>>>(
      part_acc, part_ml, pos, out, S, pages_per_split, H, D, P, page_size);
  return cudaGetLastError();
}

template <typename T>
int launch_shared(const float* q, const T* k_pool, const T* v_pool, const float* k_scales,
                  const float* v_scales, int vec, const int* block_table, const int* pos,
                  float* out, float* part_acc, float* part_ml, int rows, int H, int D, int P,
                  int page_size, int pool_rows, int pages_per_split, float scale,
                  void* stream) {
  if (rows <= 0 || H <= 0) return cudaSuccess;
  if (D <= 0 || P <= 0 || page_size <= 0 || pool_rows < page_size || pages_per_split <= 0)
    return cudaErrorInvalidValue;
  const int tile = rows < kSharedTile ? rows : kSharedTile;
  const size_t bytes = smem_bytes(tile, D, page_size);
  cudaError_t err = prepare(paged_flash_shared_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int n_tiles = (rows + tile - 1) / tile;
  const int splits = n_splits(P, pages_per_split);
  cudaStream_t st = (cudaStream_t)stream;
  paged_flash_shared_kernel<T><<<dim3(n_tiles, H, splits), kThreads, bytes, st>>>(
      q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos, part_acc, part_ml, rows,
      tile, pages_per_split, H, D, P, page_size, pool_rows / page_size, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_flash_merge_kernel<<<dim3(rows, H), kThreads, 0, st>>>(
      part_acc, part_ml, pos, out, rows, pages_per_split, H, D, P, page_size);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Splits of the page walk for a table of P entries (the scratch the caller
// passes holds n_splits * rows * H * (D + 2) floats).
int paged_flash_n_splits(int P, int pages_per_split) { return n_splits(P, pages_per_split); }

// q [S, H*D], pools [pool_rows, H*D], block_table [S, P], pos [S] -> out [S, H*D]
int paged_flash_decode(const float* q, const float* k_pool, const float* v_pool,
                       const int* block_table, const int* pos, float* out,
                       float* part_acc, float* part_ml, int S, int H, int D, int P,
                       int page_size, int pool_rows, int pages_per_split, float scale,
                       void* stream) {
  return launch_decode<float>(q, k_pool, v_pool, nullptr, nullptr, 0, block_table, pos, out,
                              part_acc, part_ml, S, H, D, P, page_size, pool_rows,
                              pages_per_split, scale, stream);
}

// q [rows, H*D], pools [pool_rows, H*D], block_table [P], pos [rows] -> out [rows, H*D]
int paged_flash_shared(const float* q, const float* k_pool, const float* v_pool,
                       const int* block_table, const int* pos, float* out,
                       float* part_acc, float* part_ml, int rows, int H, int D, int P,
                       int page_size, int pool_rows, int pages_per_split, float scale,
                       void* stream) {
  return launch_shared<float>(q, k_pool, v_pool, nullptr, nullptr, 0, block_table, pos, out,
                              part_acc, part_ml, rows, H, D, P, page_size, pool_rows,
                              pages_per_split, scale, stream);
}

// The int8 forms: int8 pools [pool_rows, H*D] and f32 scale pools
// [pool_rows]; vec: the wrapper found D, H*D and both pools' addresses to be
// multiples of 16 bytes.
int paged_flash_decode_int8(const float* q, const int8_t* k_pool, const int8_t* v_pool,
                            const float* k_scales, const float* v_scales, int vec,
                            const int* block_table, const int* pos, float* out,
                            float* part_acc, float* part_ml, int S, int H, int D, int P,
                            int page_size, int pool_rows, int pages_per_split, float scale,
                            void* stream) {
  return launch_decode<int8_t>(q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos,
                               out, part_acc, part_ml, S, H, D, P, page_size, pool_rows,
                               pages_per_split, scale, stream);
}

int paged_flash_shared_int8(const float* q, const int8_t* k_pool, const int8_t* v_pool,
                            const float* k_scales, const float* v_scales, int vec,
                            const int* block_table, const int* pos, float* out,
                            float* part_acc, float* part_ml, int rows, int H, int D, int P,
                            int page_size, int pool_rows, int pages_per_split, float scale,
                            void* stream) {
  return launch_shared<int8_t>(q, k_pool, v_pool, k_scales, v_scales, vec, block_table, pos,
                               out, part_acc, part_ml, rows, H, D, P, page_size, pool_rows,
                               pages_per_split, scale, stream);
}

const char* paged_flash_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
