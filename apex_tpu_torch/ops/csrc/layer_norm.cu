// LayerNorm over the rows of an (n1, n2) view, forward and backward.
//
// Replaces apex_tpu/ops/pallas_layer_norm.py: _fwd_kernel (:42) and
// _bwd_kernel (:100).
//
//   forward   mean = sum(x) / n2,  var = sum((x - mean)^2) / n2  (the shifted
//             two-pass variance, not Welford),  inv = rsqrt(var + eps),
//             y = ((x - mean) * inv) * w + b
//   backward  xhat = (x - mean) * inv,  g = dy * w,
//             dx = inv * ((g - sum(g)/n2) - xhat * (sum(g*xhat)/n2)),
//             dw = sum over rows of dy * xhat,  db = sum over rows of dy
//
// x, y, dy and dx are fp32, bf16 or fp16 (dtype code 0, 1, 2); the math,
// w, b, the saved mean and inv, dw and db are fp32.  Built with
// -fmad=false, so each multiply and add rounds on its own as in the plain
// PyTorch version; the row sums run in another order, and rsqrtf is not
// IEEE, so mean, inv and y agree with the plain version to rounding, not
// bit for bit.
//
// Bound: device-memory bytes.  Forward reads x and writes y (4 bytes an
// element in bf16), backward reads dy and x and writes dx (6 bytes); a few
// flops an element against the ~295 an H100 needs per byte.
//
// Design.  The TPU kernels hold a block of rows padded to 128 lanes in VMEM
// and mask the columns past n2.  Here one warp owns a row; for n2 <= 1024
// (BERT-base 768, BERT-large 1024) the row lives in registers, V values a
// lane with column lane + 32k, so x (and dy) are read from device memory
// once and the two passes over the row cost no second read.  Wider rows
// stream from device memory, one pass per sum.
//
// dw and db.  The TPU accumulates them across its sequential grid.  Blocks
// run in no order here, and float atomics would give other bits on every
// run, so: each warp sums its rows' dy*xhat and dy per column in registers,
// the block's 8 warps add theirs in shared memory in warp order, one
// partial row per block goes to device memory, and a second kernel sums
// the partials of each column in block order.  (Rows wider than 1024
// keep a partial row per warp in device memory instead.)  Every order is
// fixed, so the same inputs give the same bits.
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

using namespace apex_tpu_torch;

namespace {

constexpr int kWarps = kThreads / 32;   // rows in flight per block
constexpr int kMaxRegCols = 1024;       // 32 lanes x 32 values

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same total, in a fixed order
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// -- forward -----------------------------------------------------------------

template <typename T, int V>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ b, T* __restrict__ y,
                              float* __restrict__ mean,
                              float* __restrict__ inv, int n1, int n2,
                              float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n1) return;
  const T* xr = x + (long long)row * n2;
  T* yr = y + (long long)row * n2;
  const float fn = (float)n2;
  float xv[V];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    xv[k] = c < n2 ? to_f32(xr[c]) : 0.0f;
    s += xv[k];
  }
  const float mu = warp_sum(s) / fn;
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = (lane + 32 * k) < n2 ? xv[k] - mu : 0.0f;
    q += d * d;
  }
  const float iv = rsqrtf(warp_sum(q) / fn + eps);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    if (c < n2) yr[c] = from_f32<T>(((xv[k] - mu) * iv) * w[c] + b[c]);
  }
  if (lane == 0) {
    mean[row] = mu;
    inv[row] = iv;
  }
}

// rows wider than kMaxRegCols: one pass over device memory per sum
template <typename T>
__global__ void ln_fwd_stream_kernel(const T* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ b,
                                     T* __restrict__ y,
                                     float* __restrict__ mean,
                                     float* __restrict__ inv, int n1, int n2,
                                     float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n1) return;
  const T* xr = x + (long long)row * n2;
  T* yr = y + (long long)row * n2;
  const float fn = (float)n2;
  float s = 0.0f;
  for (int c = lane; c < n2; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / fn;
  float q = 0.0f;
  for (int c = lane; c < n2; c += 32) {
    const float d = to_f32(xr[c]) - mu;
    q += d * d;
  }
  const float iv = rsqrtf(warp_sum(q) / fn + eps);
  for (int c = lane; c < n2; c += 32)
    yr[c] = from_f32<T>(((to_f32(xr[c]) - mu) * iv) * w[c] + b[c]);
  if (lane == 0) {
    mean[row] = mu;
    inv[row] = iv;
  }
}

// -- backward ----------------------------------------------------------------

// Rows row0, row0 + stride, ... of one warp: dx, and the warp's column sums
// of dy*xhat and dy in gw/gb.  part_w/part_b: one partial row per block.
template <typename T, int V>
__global__ void ln_bwd_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ mean,
                              const float* __restrict__ inv,
                              T* __restrict__ dx, float* __restrict__ part_w,
                              float* __restrict__ part_b, int n1, int n2) {
  __shared__ float red[kWarps * kMaxRegCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float fn = (float)n2;
  float wv[V], gw[V], gb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    wv[k] = c < n2 ? w[c] : 0.0f;
    gw[k] = 0.0f;
    gb[k] = 0.0f;
  }
  for (int row = blockIdx.x * kWarps + warp; row < n1;
       row += gridDim.x * kWarps) {
    const long long base = (long long)row * n2;
    const float mu = mean[row], iv = inv[row];
    float dv[V], xh[V];
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      const bool in = c < n2;
      dv[k] = in ? to_f32(dy[base + c]) : 0.0f;
      xh[k] = in ? (to_f32(x[base + c]) - mu) * iv : 0.0f;
      const float g = dv[k] * wv[k];
      a1 += g;
      a2 += g * xh[k];
      gw[k] += dv[k] * xh[k];
      gb[k] += dv[k];
    }
    const float c1 = warp_sum(a1) / fn;
    const float c2 = warp_sum(a2) / fn;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < n2)
        dx[base + c] = from_f32<T>(iv * ((dv[k] * wv[k] - c1) - xh[k] * c2));
    }
  }
  // the block's partial rows: warps add in order 0..7
  float* outs[2] = {part_w + (long long)blockIdx.x * n2,
                    part_b + (long long)blockIdx.x * n2};
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < n2) red[warp * kMaxRegCols + c] = which ? gb[k] : gw[k];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n2; c += blockDim.x) {
      float s = 0.0f;
      for (int i = 0; i < kWarps; ++i) s += red[i * kMaxRegCols + c];
      outs[which][c] = s;
    }
    __syncthreads();
  }
}

// rows wider than kMaxRegCols: a partial row per warp, in device memory
template <typename T>
__global__ void ln_bwd_stream_kernel(const T* __restrict__ dy,
                                     const T* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ mean,
                                     const float* __restrict__ inv,
                                     T* __restrict__ dx,
                                     float* __restrict__ part_w,
                                     float* __restrict__ part_b, int n1,
                                     int n2) {
  const int lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const float fn = (float)n2;
  float* pw = part_w + (long long)gwarp * n2;
  float* pb = part_b + (long long)gwarp * n2;
  for (int c = lane; c < n2; c += 32) {
    pw[c] = 0.0f;
    pb[c] = 0.0f;
  }
  for (int row = gwarp; row < n1; row += gridDim.x * kWarps) {
    const long long base = (long long)row * n2;
    const float mu = mean[row], iv = inv[row];
    float a1 = 0.0f, a2 = 0.0f;
    for (int c = lane; c < n2; c += 32) {
      const float g = to_f32(dy[base + c]) * w[c];
      a1 += g;
      a2 += g * ((to_f32(x[base + c]) - mu) * iv);
    }
    const float c1 = warp_sum(a1) / fn;
    const float c2 = warp_sum(a2) / fn;
    for (int c = lane; c < n2; c += 32) {
      const float d = to_f32(dy[base + c]);
      const float xh = (to_f32(x[base + c]) - mu) * iv;
      dx[base + c] = from_f32<T>(iv * ((d * w[c] - c1) - xh * c2));
      pw[c] += d * xh;
      pb[c] += d;
    }
  }
}

// out[c] = sum over p of part[p][c], p in order: a block of 8 warps takes
// 32 columns, warp i sums the partial rows i, i+8, ..., then warp 0 adds
// the 8 sums in order.  blockIdx.y picks (part_w, dw) or (part_b, db).
__global__ void ln_colsum_kernel(const float* __restrict__ part_w,
                                 const float* __restrict__ part_b,
                                 float* __restrict__ dw,
                                 float* __restrict__ db, int parts, int n2) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* part = blockIdx.y ? part_b : part_w;
  float* out = blockIdx.y ? db : dw;
  const int c = blockIdx.x * 32 + lane;
  float s = 0.0f;
  if (c < n2)
    for (int p = warp; p < parts; p += kWarps)
      s += part[(long long)p * n2 + c];
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && c < n2) {
    float t = 0.0f;
    for (int i = 0; i < kWarps; ++i) t += red[i][lane];
    out[c] = t;
  }
}

int row_blocks(int n1) { return (n1 + kWarps - 1) / kWarps; }

template <typename T>
void fwd(const void* x, const float* w, const float* b, void* y, float* mean,
         float* inv, int n1, int n2, float eps, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const dim3 grid(row_blocks(n1)), block(kThreads);
#define APEX_LN_FWD(V)                                                     \
  ln_fwd_kernel<T, V><<<grid, block, 0, st>>>(xt, w, b, yt, mean, inv, n1, \
                                              n2, eps)
  if (n2 <= 32) APEX_LN_FWD(1);
  else if (n2 <= 64) APEX_LN_FWD(2);
  else if (n2 <= 128) APEX_LN_FWD(4);
  else if (n2 <= 256) APEX_LN_FWD(8);
  else if (n2 <= 512) APEX_LN_FWD(16);
  else if (n2 <= 768) APEX_LN_FWD(24);
  else if (n2 <= kMaxRegCols) APEX_LN_FWD(32);
  else
    ln_fwd_stream_kernel<T><<<grid, block, 0, st>>>(xt, w, b, yt, mean, inv,
                                                   n1, n2, eps);
#undef APEX_LN_FWD
}

template <typename T>
void bwd(const void* dy, const void* x, const float* w, const float* mean,
         const float* inv, void* dx, float* part_w, float* part_b,
         float* dw, float* db, int n1, int n2, int blocks, cudaStream_t st) {
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  T* dxt = static_cast<T*>(dx);
  const dim3 grid(blocks), block(kThreads);
#define APEX_LN_BWD(V)                                                  \
  ln_bwd_kernel<T, V><<<grid, block, 0, st>>>(dyt, xt, w, mean, inv, dxt, \
                                              part_w, part_b, n1, n2)
  int parts = blocks;
  if (n2 <= 32) APEX_LN_BWD(1);
  else if (n2 <= 64) APEX_LN_BWD(2);
  else if (n2 <= 128) APEX_LN_BWD(4);
  else if (n2 <= 256) APEX_LN_BWD(8);
  else if (n2 <= 512) APEX_LN_BWD(16);
  else if (n2 <= 768) APEX_LN_BWD(24);
  else if (n2 <= kMaxRegCols) APEX_LN_BWD(32);
  else {
    ln_bwd_stream_kernel<T><<<grid, block, 0, st>>>(dyt, xt, w, mean, inv,
                                                   dxt, part_w, part_b, n1,
                                                   n2);
    parts = blocks * kWarps;
  }
#undef APEX_LN_BWD
  ln_colsum_kernel<<<dim3((n2 + 31) / 32, 2), block, 0, st>>>(
      part_w, part_b, dw, db, parts, n2);
}

}  // namespace

extern "C" {

// x, y: (n1, n2) contiguous; w, b: (n2,) fp32; mean, inv: (n1,) fp32.
int apex_ln_fwd(const void* x, const float* w, const float* b, void* y,
                float* mean, float* inv, int n1, int n2, float eps, int dtype,
                cudaStream_t stream) {
  switch (dtype) {
    case 0: fwd<float>(x, w, b, y, mean, inv, n1, n2, eps, stream); break;
    case 1: fwd<__nv_bfloat16>(x, w, b, y, mean, inv, n1, n2, eps, stream);
      break;
    case 2: fwd<__half>(x, w, b, y, mean, inv, n1, n2, eps, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// part_w, part_b: scratch of n2 fp32 per partial row: `blocks` rows for
// n2 <= 1024, blocks * 8 above; dw, db: (n2,) fp32.
int apex_ln_bwd(const void* dy, const void* x, const float* w,
                const float* mean, const float* inv, void* dx, float* part_w,
                float* part_b, float* dw, float* db, int n1, int n2,
                int blocks, int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: bwd<float>(dy, x, w, mean, inv, dx, part_w, part_b, dw, db, n1,
                       n2, blocks, stream);
      break;
    case 1: bwd<__nv_bfloat16>(dy, x, w, mean, inv, dx, part_w, part_b, dw,
                               db, n1, n2, blocks, stream);
      break;
    case 2: bwd<__half>(dy, x, w, mean, inv, dx, part_w, part_b, dw, db, n1,
                        n2, blocks, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
