// Fused residual-add + layer_norm, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of paddle_tpu/ops/pallas_kernels.py:
//   fused_layer_norm      -> _ln_fwd_kernel
//   fused_layer_norm_grad -> _ln_bwd_kernel
//
// Forward contract over a [rows, cols] view: s = x + r in the input dtype
// (only in the residual form), one-pass Welford mean and biased variance
// of s in f32, y = (s - mean) * rsqrt(var + eps) * scale + bias rounded
// once to the input dtype; mean and var are [rows] f32. scale / bias are
// [cols] f32 (the wrapper widens other dtypes, exactly) or null for ones /
// zeros.
//
// Backward contract, against the saved stats: xhat = (x - mean) * rstd,
// dxh = dy * scale, dx = rstd * (dxh - mean(dxh) - xhat * mean(dxh * xhat))
// rounded to the input dtype; dscale = sum_rows dy * xhat and
// dbias = sum_rows dy in f32.
//
// Bound: bytes. Each element costs a handful of flops against 8-16 bytes
// moved, far below the card's flop/byte balance; the least time is the
// tensors read once and written once over the HBM rate. Design: one warp
// per row (a row of 512 f32 is 16 elements a lane), the row read once for
// the Welford statistics (each lane runs its own Welford, the warp merges
// the partial moments with the parallel combination) and once more for the
// normalisation, which the L1/L2 usually serves. The TPU kernel carries
// dscale / dbias across its sequential grid in a resident output block; a
// CUDA block cannot hand a sum to the next block, so the backward writes
// per-chunk column partials (one CTA per 32 columns x 64 rows) and a second
// kernel sums each column's partials in a fixed order. No float atomics:
// the result is the same from run to run.
//
// Plain C interface, loaded with ctypes (ops/layer_norm.py). Each launcher
// enqueues on the caller's stream, does not synchronize, allocates nothing
// (the caller passes the partials scratch), and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;  // rows per CTA in the row kernels
constexpr int kPartRows = 64;  // rows per column-partial chunk
constexpr int kPartCols = 32;
constexpr int kPartThreadsY = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// s = x + r in the input dtype (an f32 add rounded once to T)
template <typename T> __device__ __forceinline__ T add_t(T a, T b) {
  return from_f32<T>(to_f32(a) + to_f32(b));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ r,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ s, T* __restrict__ y, float* __restrict__ mean_out,
              float* __restrict__ var_out, int rows, int cols, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = (int64_t)row * cols;

  // per-lane Welford over the lane's columns; the residual sum is stored
  // here, once
  float cnt = 0.0f, mean = 0.0f, m2 = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    float v;
    if (r != nullptr) {
      const T sv = add_t(x[base + c], r[base + c]);
      s[base + c] = sv;
      v = to_f32(sv);
    } else {
      v = to_f32(x[base + c]);
    }
    cnt += 1.0f;
    const float d = v - mean;
    mean += d / cnt;
    m2 += d * (v - mean);
  }
  // merge the lanes' moments (Chan et al.'s parallel combination)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float cb = __shfl_xor_sync(0xffffffffu, cnt, o);
    const float mb = __shfl_xor_sync(0xffffffffu, mean, o);
    const float qb = __shfl_xor_sync(0xffffffffu, m2, o);
    const float tot = cnt + cb;
    if (tot > 0.0f) {
      const float d = mb - mean;
      mean += d * (cb / tot);
      m2 += qb + d * d * (cnt * cb / tot);
    }
    cnt = tot;
  }
  // the lanes merged in different orders: every lane takes lane 0's result
  mean = __shfl_sync(0xffffffffu, mean, 0);
  const float var = __shfl_sync(0xffffffffu, m2, 0) / (float)cols;  // biased
  const float rstd = rsqrtf(var + eps);
  if (lane == 0) {
    mean_out[row] = mean;
    var_out[row] = var;
  }
  for (int c = lane; c < cols; c += 32) {
    const float v = to_f32(r != nullptr ? s[base + c] : x[base + c]);
    float o = (v - mean) * rstd;
    o = o * (scale != nullptr ? scale[c] : 1.0f) + (bias != nullptr ? bias[c] : 0.0f);
    y[base + c] = from_f32<T>(o);
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ mean, const float* __restrict__ var,
                 const T* __restrict__ dy, T* __restrict__ dx, int rows, int cols,
                 float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int64_t base = (int64_t)row * cols;
  const float mu = mean[row];
  const float rstd = rsqrtf(var[row] + eps);
  float s1 = 0.0f, s2 = 0.0f;
  for (int c = lane; c < cols; c += 32) {
    const float xh = (to_f32(x[base + c]) - mu) * rstd;
    const float dxh = to_f32(dy[base + c]) * (scale != nullptr ? scale[c] : 1.0f);
    s1 += dxh;
    s2 += dxh * xh;
  }
  const float c1 = warp_sum(s1) / (float)cols;
  const float c2 = warp_sum(s2) / (float)cols;
  for (int c = lane; c < cols; c += 32) {
    const float xh = (to_f32(x[base + c]) - mu) * rstd;
    const float dxh = to_f32(dy[base + c]) * (scale != nullptr ? scale[c] : 1.0f);
    dx[base + c] = from_f32<T>(rstd * (dxh - c1 - xh * c2));
  }
}

// one CTA per (32 columns, 64 rows): partial column sums of dy * xhat and dy
template <typename T>
__global__ void __launch_bounds__(kPartCols * kPartThreadsY)
ln_bwd_partials_kernel(const T* __restrict__ x, const float* __restrict__ mean,
                       const float* __restrict__ var, const T* __restrict__ dy,
                       float* __restrict__ part_ds, float* __restrict__ part_db,
                       int rows, int cols, float eps) {
  __shared__ float sds[kPartThreadsY][kPartCols];
  __shared__ float sdb[kPartThreadsY][kPartCols];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int c = blockIdx.x * kPartCols + tx;
  const int r0 = blockIdx.y * kPartRows;
  float ds = 0.0f, db = 0.0f;
  if (c < cols) {
    for (int rr = ty; rr < kPartRows; rr += kPartThreadsY) {
      const int row = r0 + rr;
      if (row >= rows) break;
      const int64_t o = (int64_t)row * cols + c;
      const float xh = (to_f32(x[o]) - mean[row]) * rsqrtf(var[row] + eps);
      const float g = to_f32(dy[o]);
      ds += g * xh;
      db += g;
    }
  }
  sds[ty][tx] = ds;
  sdb[ty][tx] = db;
  __syncthreads();
  if (ty == 0 && c < cols) {
#pragma unroll
    for (int k = 1; k < kPartThreadsY; ++k) {
      ds += sds[k][tx];
      db += sdb[k][tx];
    }
    part_ds[(int64_t)blockIdx.y * cols + c] = ds;
    part_db[(int64_t)blockIdx.y * cols + c] = db;
  }
}

// each column's chunk partials summed in chunk order
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ part_ds,
                                     const float* __restrict__ part_db,
                                     float* __restrict__ ds, float* __restrict__ db,
                                     int n_chunks, int cols) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  float a = 0.0f, b = 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    a += part_ds[(int64_t)k * cols + c];
    b += part_db[(int64_t)k * cols + c];
  }
  ds[c] = a;
  db[c] = b;
}

template <typename T>
cudaError_t fwd_typed(const void* x, const void* r, const float* scale, const float* bias,
                      void* s, void* y, float* mean, float* var, int rows, int cols,
                      float eps, cudaStream_t st) {
  const int blocks = (rows + kWarps - 1) / kWarps;
  ln_fwd_kernel<T><<<blocks, kWarps * 32, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(r), scale, bias, static_cast<T*>(s),
      static_cast<T*>(y), mean, var, rows, cols, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_typed(const void* x, const float* scale, const float* mean, const float* var,
                      const void* dy, void* dx, float* ds, float* db, float* part_ds,
                      float* part_db, int rows, int cols, float eps, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  const T* dyp = static_cast<const T*>(dy);
  ln_bwd_dx_kernel<T><<<(rows + kWarps - 1) / kWarps, kWarps * 32, 0, st>>>(
      xp, scale, mean, var, dyp, static_cast<T*>(dx), rows, cols, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_chunks = (rows + kPartRows - 1) / kPartRows;
  dim3 pgrid((cols + kPartCols - 1) / kPartCols, n_chunks);
  ln_bwd_partials_kernel<T><<<pgrid, dim3(kPartCols, kPartThreadsY), 0, st>>>(
      xp, mean, var, dyp, part_ds, part_db, rows, cols, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_bwd_reduce_kernel<<<(cols + 127) / 128, 128, 0, st>>>(part_ds, part_db, ds, db,
                                                            n_chunks, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// rows in one column-partial chunk: the caller sizes the partials scratch
// as 2 x ceil(rows / chunk) x cols f32
int layer_norm_partial_rows() { return kPartRows; }

// dtype: 0 f32, 1 bf16. r and s null for the plain form; scale/bias may be
// null (ones / zeros).
int layer_norm_fwd(const void* x, const void* r, const float* scale, const float* bias,
                   void* s, void* y, float* mean, float* var, int rows, int cols,
                   float eps, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0 || (r != nullptr) != (s != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)fwd_typed<float>(x, r, scale, bias, s, y, mean, var, rows, cols, eps, st);
  if (dtype == 1)
    return (int)fwd_typed<__nv_bfloat16>(x, r, scale, bias, s, y, mean, var, rows, cols, eps, st);
  return (int)cudaErrorInvalidValue;
}

int layer_norm_bwd(const void* x, const float* scale, const float* mean, const float* var,
                   const void* dy, void* dx, float* ds, float* db, float* part_ds,
                   float* part_db, int rows, int cols, float eps, int dtype, void* stream) {
  if (rows <= 0 || cols <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)bwd_typed<float>(x, scale, mean, var, dy, dx, ds, db, part_ds, part_db, rows,
                                 cols, eps, st);
  if (dtype == 1)
    return (int)bwd_typed<__nv_bfloat16>(x, scale, mean, var, dy, dx, ds, db, part_ds,
                                         part_db, rows, cols, eps, st);
  return (int)cudaErrorInvalidValue;
}

const char* layer_norm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
