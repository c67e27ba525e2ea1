// Fused residual-add + layer_norm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   fused_layer_norm      -> _ln_fwd_kernel
//   fused_layer_norm_grad -> _ln_bwd_kernel
//
// Forward contract over a [rows, cols] view: s = x + r in the input dtype
// (only in the residual form), mean and biased variance of s in f32,
// y = (s - mean) * rsqrt(var + eps) * scale + bias rounded once to the input
// dtype; mean and var are [rows] f32. scale / bias are [cols] f32 (the
// wrapper widens other dtypes, exactly) or null for ones / zeros.
//
// Backward contract, against the saved stats: xhat = (x - mean) * rstd,
// dxh = dy * scale, dx = rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))
// rounded to the input dtype; dscale = sum_rows dy * xhat and
// dbias = sum_rows dy in f32, with no float atomics: the same bits on every
// run.
//
// Bound: bytes. Each element costs a handful of flops against 8-16 bytes
// moved, far below the card's flop/byte balance; the least time is the
// tensors read once and written once over the HBM rate. So both kernels
// read each input once, keep the row in registers and keep many rows'
// loads in flight.
//
// Forward: one warp a row, kFwdWarps rows a CTA. A row is held as 16-byte
// vectors (4 f32 or 8 bf16 columns): lane l holds vectors l, l + 32, ...,
// NV of them, NV in {1, 2, 4, 8, 16} (f32 rows up to 128 .. 2048 columns,
// bf16 up to 256 .. 4096). Every load of the row (x, and r) is issued before
// any arithmetic. No division per element: each lane takes the mean and M2
// of its own registers in two passes, the lanes merge by Chan et al.'s
// parallel combination through shuffles (the structure of the reference's
// _welford_cols: moments a chunk, then the combination), and every lane
// takes lane 0's result, so reruns are bit for bit. The moments are taken
// of s - s[0] (exact for values within a factor of two of s[0]), so a large
// offset costs no precision. y is formed from the registers; s and y are
// written once. Rows past 16 vectors a lane run the same code over chunks of
// 16, merging each chunk's moments into the lane's, and read s (or x) back
// for y.
//
// Backward: one launch, 16 warps a CTA. CTA b takes the fixed run of rows
// [b R, b R + R); R (bwd_run) depends on rows only, never on the card, so
// the order of the sums is the same everywhere. Rows of up to kBwdRegCols
// columns a lane: a warp holds a row's x and dy in registers (read once),
// takes rstd once, c1 and c2 by warp sums, writes dx, and adds dy * xhat and
// dy into its lanes' column sums, kept in the warp's slice of shared memory
// across its rows (in registers they took a CTA to 120 registers a thread,
// one CTA an SM); the warps' sums are added in warp order into the CTA's
// [2, cols] partial in the caller's scratch. Wider rows: the CTA's warps
// share each row of the run (c1 and c2 by a CTA sum in warp order), and each
// thread adds its columns into the CTA's partial in place. The partials are
// then summed in a fixed order: the last CTA of each group of kGroup (an
// arrival counter) sums the group's partials in CTA order, and, with more
// than one group, the last group sums the group sums in group order. One
// CTA summing every partial would pull them all through one SM (1 MiB at
// 4096 x 512, longer than the kernel's bound); in groups each sum is one
// round of 16-byte loads in flight. Each counter is reset by the CTA that
// found itself last, and the kernel neither allocates nor synchronizes with
// the host, so it can be captured in a CUDA graph.
//
// Plain C interface, loaded with ctypes (ops/layer_norm.py). Each launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing
// (the caller passes the partials scratch and the counters), and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdWarps = 4;      // rows a forward CTA: one a warp
constexpr int kFwdMaxNV = 16;     // vectors a lane the forward holds at once
constexpr int kBwdWarps = 16;     // warps a backward CTA
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kBwdRegCols = 32;   // columns a lane, at most, in the backward's register form
constexpr int kRunMin = 16;       // rows a backward CTA takes, at least
constexpr int kMaxRuns = 256;     // backward CTAs, at most
constexpr int kGroup = 16;        // partials summed by the last CTA of a group
static_assert(kRunMin % kBwdWarps == 0, "a run is whole rows for every warp");
static_assert(kMaxRuns <= kGroup * kGroup, "the group sums fit one group");

// ---------------------------------------------------------------------------
// 16 bytes of T as a uint4: element access, loads and stores
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t word(const uint4& q, int w) {
  return w == 0 ? q.x : w == 1 ? q.y : w == 2 ? q.z : q.w;
}

__device__ __forceinline__ void or_word(uint4& q, int w, uint32_t v) {
  if (w == 0) q.x |= v;
  else if (w == 1) q.y |= v;
  else if (w == 2) q.z |= v;
  else q.w |= v;
}

template <typename T> __device__ __forceinline__ float elem(const uint4& q, int e);
template <> __device__ __forceinline__ float elem<float>(const uint4& q, int e) {
  return __uint_as_float(word(q, e));
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& q, int e) {
  const uint32_t u = word(q, e >> 1);
  return __uint_as_float((e & 1) ? (u & 0xffff0000u) : (u << 16));  // exact
}

// E f32 values rounded once each to T, packed
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the bits of one element; RO: read-only for the kernel's life (the
// non-coherent path), else a plain load (data this kernel wrote)
template <bool RO> __device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(RO ? __ldg(p) : *p);
}
template <bool RO> __device__ __forceinline__ uint32_t bits(const __nv_bfloat16* p) {
  const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
  return RO ? __ldg(q) : *q;
}

// columns [c, c + E) of a row: one 16-byte load where the view is
// vectorisable (vec), else element by element; columns past cols read 0
template <typename T, bool RO>
__device__ __forceinline__ uint4 load16(const T* row, int c, int cols, bool vec) {
  constexpr int E = 16 / sizeof(T);
  uint4 q = make_uint4(0u, 0u, 0u, 0u);
  if (vec) {
    if (c < cols) {
      const uint4* p = reinterpret_cast<const uint4*>(row + c);
      q = RO ? __ldg(p) : *p;
    }
  } else {
    constexpr int kPerWord = 4 / sizeof(T);
#pragma unroll
    for (int e = 0; e < E; ++e)
      if (c + e < cols)
        or_word(q, e / kPerWord, bits<RO>(row + c + e) << (8 * sizeof(T) * (e % kPerWord)));
  }
  return q;
}

template <typename T>
__device__ __forceinline__ void store16(T* row, int c, int cols, bool vec, const uint4& q) {
  constexpr int E = 16 / sizeof(T);
  if (vec) {
    if (c < cols) *reinterpret_cast<uint4*>(row + c) = q;
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) {
    if (c + e >= cols) continue;
    if constexpr (E == 4) {
      reinterpret_cast<float*>(row)[c + e] = __uint_as_float(word(q, e));
    } else {
      reinterpret_cast<unsigned short*>(row)[c + e] =
          (unsigned short)(word(q, e >> 1) >> (16 * (e & 1)));
    }
  }
}

// E f32 values of a [cols] vector (scale or bias) at columns [c, c + E);
// dflt where v is null or past cols
template <int E>
__device__ __forceinline__ void load_f32(const float* v, int c, int cols, bool vec, float dflt,
                                         float* out) {
  if (v != nullptr && vec && c < cols) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(v + c) + i);
      out[4 * i] = t.x;
      out[4 * i + 1] = t.y;
      out[4 * i + 2] = t.z;
      out[4 * i + 3] = t.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) out[e] = (v != nullptr && c + e < cols) ? __ldg(v + c + e) : dflt;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Chan et al.'s parallel combination: (cnt, mean, m2) absorbs (nb, mb, qb)
__device__ __forceinline__ void chan_merge(float& cnt, float& mean, float& m2, float nb, float mb,
                                           float qb) {
  const float tot = cnt + nb;
  if (tot > 0.0f) {
    const float d = mb - mean;
    mean += d * (nb / tot);
    m2 += qb + d * d * (cnt * nb / tot);
  }
  cnt = tot;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

struct FwdArgs {
  const void* x;
  const void* r;  // null: no residual
  const float* scale;
  const float* bias;
  void* s;
  void* y;
  float* mean;
  float* var;
  int rows, cols;
  float eps;
  bool vec;  // every row pointer 16-byte aligned and cols a multiple of E
};

// forward CTAs an SM must hold at once: 8 (32 warps, 64 registers a
// thread) up to 16 columns a lane, so 4096 rows of 512 f32 are resident in
// one wave; 4 up to 32 columns; the wider rows need their registers
template <typename T, int NV> __host__ __device__ constexpr int fwd_min_ctas() {
  return NV * (16 / (int)sizeof(T)) <= 16 ? 8 : NV * (16 / (int)sizeof(T)) <= 32 ? 4 : 1;
}

template <typename T, int NV, bool RES>
__global__ void __launch_bounds__(kFwdWarps * 32, fwd_min_ctas<T, NV>())
    ln_fwd_kernel(const FwdArgs a) {
  constexpr int E = 16 / sizeof(T);
  constexpr int kChunk = 32 * NV * E;  // columns a warp holds at once
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFwdWarps + (threadIdx.x >> 5);
  if (row >= a.rows) return;
  const int cols = a.cols;
  const int64_t base = (int64_t)row * cols;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* r = RES ? static_cast<const T*>(a.r) + base : nullptr;
  T* s = RES ? static_cast<T*>(a.s) + base : nullptr;
  T* y = static_cast<T*>(a.y) + base;
  const int n_chunks = (cols + kChunk - 1) / kChunk;

  uint4 v[NV];  // the chunk of s (or x) this lane holds
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;  // this lane's moments of s - k0
  float k0 = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk + lane * E;
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] = load16<T, true>(x, c0 + 32 * E * k, cols, a.vec);
    if constexpr (RES) {
      uint4 rv[NV];
#pragma unroll
      for (int k = 0; k < NV; ++k) rv[k] = load16<T, true>(r, c0 + 32 * E * k, cols, a.vec);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        float f[E];
#pragma unroll
        for (int e = 0; e < E; ++e) f[e] = elem<T>(v[k], e) + elem<T>(rv[k], e);
        v[k] = pack<T>(f);  // s = x + r in T, rounded once
        store16<T>(s, c0 + 32 * E * k, cols, a.vec, v[k]);
      }
    }
    if (ch == 0) k0 = __shfl_sync(kFull, elem<T>(v[0], 0), 0);  // s[0]
    // the lane's mean and M2 of this chunk: two passes over its registers
    float n = 0.0f, sum = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (c0 + 32 * E * k + e < cols) {
          sum += elem<T>(v[k], e) - k0;
          n += 1.0f;
        }
    if (n > 0.0f) {
      const float bm = sum / n;
      float bq = 0.0f;
#pragma unroll
      for (int k = 0; k < NV; ++k)
#pragma unroll
        for (int e = 0; e < E; ++e)
          if (c0 + 32 * E * k + e < cols) {
            const float d = (elem<T>(v[k], e) - k0) - bm;
            bq += d * d;
          }
      chan_merge(cnt, mean, m2, n, bm, bq);
    }
  }
  // the lanes' moments merged by the butterfly; the lanes merge in
  // different orders, so every lane takes lane 0's result
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float cb = __shfl_xor_sync(kFull, cnt, o);
    const float mb = __shfl_xor_sync(kFull, mean, o);
    const float qb = __shfl_xor_sync(kFull, m2, o);
    chan_merge(cnt, mean, m2, cb, mb, qb);
  }
  const float mu = k0 + __shfl_sync(kFull, mean, 0);
  const float var = __shfl_sync(kFull, m2, 0) / (float)cols;  // biased
  const float rstd = rsqrtf(var + a.eps);
  if (lane == 0) {
    a.mean[row] = mu;
    a.var[row] = var;
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int c0 = ch * kChunk + lane * E;
    if (n_chunks > 1) {  // only the last chunk is still in registers: read s (or x) back
#pragma unroll
      for (int k = 0; k < NV; ++k)
        v[k] = RES ? load16<T, false>(s, c0 + 32 * E * k, cols, a.vec)
                   : load16<T, true>(x, c0 + 32 * E * k, cols, a.vec);
    }
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = c0 + 32 * E * k;
      float sc[E], bi[E], f[E];
      load_f32<E>(a.scale, c, cols, a.vec, 1.0f, sc);
      load_f32<E>(a.bias, c, cols, a.vec, 0.0f, bi);
#pragma unroll
      for (int e = 0; e < E; ++e) f[e] = (elem<T>(v[k], e) - mu) * rstd * sc[e] + bi[e];
      store16<T>(y, c, cols, a.vec, pack<T>(f));
    }
  }
}

template <typename T, int NV, bool RES>
cudaError_t fwd_launch(const FwdArgs& a, cudaStream_t st) {
  ln_fwd_kernel<T, NV, RES><<<(a.rows + kFwdWarps - 1) / kFwdWarps, kFwdWarps * 32, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, bool RES>
cudaError_t fwd_typed(const FwdArgs& a, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int nv = ((a.cols + E - 1) / E + 31) / 32;  // vectors a lane
  if (nv <= 1) return fwd_launch<T, 1, RES>(a, st);
  if (nv <= 2) return fwd_launch<T, 2, RES>(a, st);
  if (nv <= 4) return fwd_launch<T, 4, RES>(a, st);
  if (nv <= 8) return fwd_launch<T, 8, RES>(a, st);
  return fwd_launch<T, kFwdMaxNV, RES>(a, st);  // past 16: chunks of 16
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

struct BwdArgs {
  const void* x;
  const float* scale;  // null: ones
  const float* mean;
  const float* var;
  const void* dy;
  void* dx;
  float* ds;
  float* db;
  float* part;   // [partial rows, 2, cols]: a CTA's, then the groups'
  int* arrivals; // [groups + 1], all 0 between launches
  int rows, cols, run;
  float eps;
  bool vec;
};

// backward CTAs an SM must hold at once: two up to 16 columns a lane (64
// registers a thread), so 4096 x 512 f32, 256 CTAs, is resident in one
// wave on 132 SMs
template <typename T, int NV> __host__ __device__ constexpr int bwd_min_ctas() {
  return NV * (16 / (int)sizeof(T)) <= 16 ? 2 : 1;
}

// rows a backward CTA takes: a function of rows alone
int bwd_run(int rows) {
  int run = rows / kMaxRuns + (rows % kMaxRuns != 0);
  if (run < kRunMin) run = kRunMin;
  return (run + kBwdWarps - 1) / kBwdWarps * kBwdWarps;
}

// E floats of shared memory at p (16-byte aligned), as float4s
template <int E> __device__ __forceinline__ void lds(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i) {
    const float4 t = reinterpret_cast<const float4*>(p)[i];
    out[4 * i] = t.x;
    out[4 * i + 1] = t.y;
    out[4 * i + 2] = t.z;
    out[4 * i + 3] = t.w;
  }
}
template <int E> __device__ __forceinline__ void sts(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < E / 4; ++i)
    reinterpret_cast<float4*>(p)[i] =
        make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
}

// Rows of up to kBwdRegCols columns a lane: a warp a row, the row in
// registers; the lane's column sums in the warp's slice of shared memory
// (registers would hold the CTA to one per SM), then the warps' sums added
// in warp order into the CTA's partial. smem: [W][2][C] sums, [C] scale.
template <typename T, int NV>
__device__ __forceinline__ void bwd_register_rows(const BwdArgs& a, float* smem, float* part,
                                                  int r0, int r1) {
  constexpr int E = 16 / sizeof(T);
  constexpr int C = 32 * NV * E;  // columns a warp holds
  constexpr int W = kBwdWarps;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cols = a.cols;
  float* sc = smem + 2 * W * C;      // 1 where scale is null or past cols
  float* acc = smem + 2 * warp * C;  // this warp's [2][C] column sums
  for (int c = tid; c < C; c += 32 * W)
    sc[c] = (a.scale != nullptr && c < cols) ? __ldg(a.scale + c) : 1.0f;
  const float zero[E] = {};
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    sts<E>(acc + (32 * k + lane) * E, zero);
    sts<E>(acc + C + (32 * k + lane) * E, zero);
  }
  __syncthreads();
  for (int row = r0 + warp; row < r1; row += W) {
    const int64_t base = (int64_t)row * cols;
    const T* x = static_cast<const T*>(a.x) + base;
    const T* dy = static_cast<const T*>(a.dy) + base;
    uint4 xv[NV], gv[NV];
#pragma unroll
    for (int k = 0; k < NV; ++k) xv[k] = load16<T, true>(x, (32 * k + lane) * E, cols, a.vec);
#pragma unroll
    for (int k = 0; k < NV; ++k) gv[k] = load16<T, true>(dy, (32 * k + lane) * E, cols, a.vec);
    const float mu = __ldg(a.mean + row);
    const float rstd = rsqrtf(__ldg(a.var + row) + a.eps);
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (32 * k + lane) * E;
      float scv[E], ds[E], db[E];
      lds<E>(sc + c, scv);
      lds<E>(acc + c, ds);
      lds<E>(acc + C + c, db);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (elem<T>(xv[k], e) - mu) * rstd;
        const float g = elem<T>(gv[k], e);
        const float dxh = g * scv[e];
        s1 += dxh;
        s2 += dxh * xh;
        ds[e] += g * xh;
        db[e] += g;
      }
      sts<E>(acc + c, ds);
      sts<E>(acc + C + c, db);
    }
    const float c1 = warp_sum(s1) / (float)cols;
    const float c2 = warp_sum(s2) / (float)cols;
    T* dx = static_cast<T*>(a.dx) + base;
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      const int c = (32 * k + lane) * E;
      float scv[E], f[E];
      lds<E>(sc + c, scv);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (elem<T>(xv[k], e) - mu) * rstd;
        f[e] = rstd * (elem<T>(gv[k], e) * scv[e] - c1 - xh * c2);
      }
      store16<T>(dx, c, cols, a.vec, pack<T>(f));
    }
  }
  __syncthreads();
  for (int i = tid; i < 2 * cols; i += 32 * W) {
    const int st = i >= cols, c = i - st * cols;
    float acc = smem[st * C + c];
#pragma unroll
    for (int w = 1; w < W; ++w) acc += smem[(2 * w + st) * C + c];
    part[i] = acc;
  }
}

// Wider rows: the CTA shares each row of its run, every thread a fixed set
// of vectors; c1 and c2 by a CTA sum in warp order; each thread adds its
// columns into the CTA's partial in place, row after row. red: [kBwdWarps][2].
template <typename T>
__device__ __forceinline__ void bwd_shared_rows(const BwdArgs& a, float* red, float* part, int r0,
                                                int r1) {
  constexpr int E = 16 / sizeof(T);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, cols = a.cols;
  const int nvec = (cols + E - 1) / E;
  for (int row = r0; row < r1; ++row) {
    const int64_t base = (int64_t)row * cols;
    const T* x = static_cast<const T*>(a.x) + base;
    const T* dy = static_cast<const T*>(a.dy) + base;
    T* dx = static_cast<T*>(a.dx) + base;
    const float mu = __ldg(a.mean + row);
    const float rstd = rsqrtf(__ldg(a.var + row) + a.eps);
    float s1 = 0.0f, s2 = 0.0f;
    for (int j = tid; j < nvec; j += kBwdThreads) {
      const uint4 xq = load16<T, true>(x, j * E, cols, a.vec);
      const uint4 gq = load16<T, true>(dy, j * E, cols, a.vec);
      float sc[E];
      load_f32<E>(a.scale, j * E, cols, a.vec, 1.0f, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (elem<T>(xq, e) - mu) * rstd;
        const float dxh = elem<T>(gq, e) * sc[e];
        s1 += dxh;
        s2 += dxh * xh;
      }
    }
    s1 = warp_sum(s1);
    s2 = warp_sum(s2);
    if (lane == 0) {
      red[2 * warp] = s1;
      red[2 * warp + 1] = s2;
    }
    __syncthreads();
    float t1 = red[0], t2 = red[1];
#pragma unroll
    for (int w = 1; w < kBwdWarps; ++w) {
      t1 += red[2 * w];
      t2 += red[2 * w + 1];
    }
    __syncthreads();  // red is written again for the next row
    const float c1 = t1 / (float)cols, c2 = t2 / (float)cols;
    for (int j = tid; j < nvec; j += kBwdThreads) {
      const int c = j * E;
      const uint4 xq = load16<T, true>(x, c, cols, a.vec);
      const uint4 gq = load16<T, true>(dy, c, cols, a.vec);
      float sc[E], f[E];
      load_f32<E>(a.scale, c, cols, a.vec, 1.0f, sc);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float xh = (elem<T>(xq, e) - mu) * rstd;
        const float g = elem<T>(gq, e);
        f[e] = rstd * (g * sc[e] - c1 - xh * c2);
        if (c + e < cols) {
          const float pds = row == r0 ? 0.0f : part[c + e];
          const float pdb = row == r0 ? 0.0f : part[cols + c + e];
          part[c + e] = pds + g * xh;
          part[cols + c + e] = pdb + g;
        }
      }
      store16<T>(dx, c, cols, a.vec, pack<T>(f));
    }
  }
}

// count [2, cols] partials from src summed in order, column by column, into
// out (a [2, cols] row) or, when out is null, into ds and db. The loads of
// all count partials are in flight at once (the sums wait on L2 latency,
// not on bytes), 16 bytes each where cols allows.
__device__ __forceinline__ void sum_partials(const BwdArgs& a, const float* src, int count,
                                             float* out) {
  const int cols = a.cols;
  const size_t stride = 2 * (size_t)cols;
  const uintptr_t ends = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(out) |
                         reinterpret_cast<uintptr_t>(a.ds) | reinterpret_cast<uintptr_t>(a.db);
  if (cols % 4 == 0 && ends % 16 == 0) {
    for (int i = 4 * threadIdx.x; i < 2 * cols; i += 4 * blockDim.x) {
      float4 acc = __ldcg(reinterpret_cast<const float4*>(src + i));
#pragma unroll
      for (int q = 1; q < kGroup; ++q)
        if (q < count) {
          const float4 t = __ldcg(reinterpret_cast<const float4*>(src + q * stride + i));
          acc.x += t.x;
          acc.y += t.y;
          acc.z += t.z;
          acc.w += t.w;
        }
      float* o = out != nullptr ? out + i : i < cols ? a.ds + i : a.db + (i - cols);
      *reinterpret_cast<float4*>(o) = acc;
    }
    return;
  }
  for (int i = threadIdx.x; i < 2 * cols; i += blockDim.x) {
    float acc = __ldcg(src + i);
#pragma unroll
    for (int q = 1; q < kGroup; ++q)
      if (q < count) acc += __ldcg(src + q * stride + i);
    if (out != nullptr) out[i] = acc;
    else if (i < cols) a.ds[i] = acc;
    else a.db[i - cols] = acc;
  }
}

template <typename T, int NV>  // NV > 0: the register form; 0: shared rows
__global__ void __launch_bounds__(kBwdThreads, bwd_min_ctas<T, NV>())
    ln_bwd_kernel(const BwdArgs a) {
  extern __shared__ float smem[];
  __shared__ bool is_last;
  const int tid = threadIdx.x, cols = a.cols, n_cta = gridDim.x;
  const int r0 = blockIdx.x * a.run;
  const int r1 = min(a.rows, r0 + a.run);
  const size_t stride = 2 * (size_t)cols;
  if constexpr (NV > 0) {
    bwd_register_rows<T, NV>(a, smem, a.part + blockIdx.x * stride, r0, r1);
  } else {
    bwd_shared_rows<T>(a, smem, a.part + blockIdx.x * stride, r0, r1);
  }

  // the last CTA of the group to finish sums the group: every partial is
  // written and fenced before the count moves
  const int n_groups = (n_cta + kGroup - 1) / kGroup;
  const int g = blockIdx.x / kGroup;
  const int count = min(kGroup, n_cta - g * kGroup);
  // one thread releases the CTA's writes (the barrier orders them before
  // its fence) and, when last, acquires the others' before the barrier
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(a.arrivals + g, 1) == count - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  const float* first = a.part + (size_t)g * kGroup * stride;
  if (n_groups == 1) {
    sum_partials(a, first, count, nullptr);
    if (tid == 0) a.arrivals[g] = 0;  // ready for the next launch on this stream
    return;
  }
  sum_partials(a, first, count, a.part + (n_cta + g) * stride);
  if (tid == 0) a.arrivals[g] = 0;
  // the last group to finish sums the groups
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    is_last = atomicAdd(a.arrivals + n_groups, 1) == n_groups - 1;
    if (is_last) __threadfence();
  }
  __syncthreads();
  if (!is_last) return;
  sum_partials(a, a.part + n_cta * stride, n_groups, nullptr);
  if (tid == 0) a.arrivals[n_groups] = 0;
}

template <typename T, int NV>
cudaError_t bwd_launch(const BwdArgs& a, int n_cta, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  // the register form: [warps][2][C] column sums and [C] scale; shared
  // rows: [warps][2] row sums
  const int smem =
      (int)sizeof(float) * (NV > 0 ? (2 * kBwdWarps + 1) * 32 * NV * E : 2 * kBwdWarps);
  if (smem > 48 * 1024) {  // the opt-in is per device: made at every launch
    const cudaError_t err = cudaFuncSetAttribute(
        ln_bwd_kernel<T, NV>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  ln_bwd_kernel<T, NV><<<n_cta, kBwdThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_typed(const BwdArgs& a, cudaStream_t st) {
  constexpr int E = 16 / sizeof(T);
  const int n_cta = (a.rows + a.run - 1) / a.run;
  const int nv = ((a.cols + E - 1) / E + 31) / 32;  // vectors a lane
  if (nv * E > kBwdRegCols) return bwd_launch<T, 0>(a, n_cta, st);
  if (nv <= 1) return bwd_launch<T, 1>(a, n_cta, st);
  if (nv <= 2) return bwd_launch<T, 2>(a, n_cta, st);
  if constexpr (E == 4) {
    if (nv <= 4) return bwd_launch<T, 4>(a, n_cta, st);
    return bwd_launch<T, 8>(a, n_cta, st);
  } else {
    return bwd_launch<T, 4>(a, n_cta, st);
  }
}

bool aligned(const void* p) { return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// dtype: 0 f32, 1 bf16. r and s null for the plain form; scale/bias may be
// null (ones / zeros).
int layer_norm_fwd(const void* x, const void* r, const float* scale, const float* bias,
                   void* s, void* y, float* mean, float* var, int rows, int cols,
                   float eps, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || (r != nullptr) != (s != nullptr) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = dtype == 0 ? 4 : 8;
  FwdArgs a{x, r, scale, bias, s, y, mean, var, rows, cols, eps,
            cols % e == 0 && aligned(x) && aligned(r) && aligned(s) && aligned(y) &&
                aligned(scale) && aligned(bias)};
  if (dtype == 0) return (int)(r ? fwd_typed<float, true>(a, st) : fwd_typed<float, false>(a, st));
  return (int)(r ? fwd_typed<__nv_bfloat16, true>(a, st) : fwd_typed<__nv_bfloat16, false>(a, st));
}

// The backward's scratch for a (rows, cols) view: returns the partials' row
// count (the caller allocates [rows, 2, cols] f32) and sets *counters to the
// arrival counters it uses. A function of the shape alone: no sync.
int layer_norm_bwd_partials(int rows, int cols, int* counters) {
  (void)cols;
  const int run = bwd_run(rows);
  const int n_cta = (rows + run - 1) / run;
  const int n_groups = (n_cta + kGroup - 1) / kGroup;
  *counters = n_groups + 1;
  return n_cta + (n_groups > 1 ? n_groups : 0);
}

int layer_norm_bwd(const void* x, const float* scale, const float* mean, const float* var,
                   const void* dy, void* dx, float* ds, float* db, float* part, int* arrivals,
                   int rows, int cols, float eps, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int e = dtype == 0 ? 4 : 8;
  BwdArgs a{x, scale, mean, var, dy, dx, ds, db, part, arrivals, rows, cols, bwd_run(rows), eps,
            cols % e == 0 && aligned(x) && aligned(dy) && aligned(dx) && aligned(scale)};
  if (dtype == 0) return (int)bwd_typed<float>(a, st);
  return (int)bwd_typed<__nv_bfloat16>(a, st);
}

const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
