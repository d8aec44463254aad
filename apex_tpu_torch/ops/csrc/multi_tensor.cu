// Multi-tensor kernels over one flat fp32 buffer: scale, axpby, l2norm,
// and the l2norm's per-tensor mode.
//
// Replaces apex_tpu/ops/pallas_multi_tensor.py: _scale_kernel (:45),
// _axpby_kernel (:89) and _l2norm_kernel (:142), and the per-tensor branch
// of its multi_tensor_l2norm (:166-187, ChunkedFlatLayout.per_tensor_sqsum:
// per-chunk sums, then a segment sum; the upstream project's
// multi_tensor_l2norm_kernel.cu:117-180 writes the same per-tensor output).
//
// Bound: device-memory bytes.  Each kernel does a few flops per element,
// far below the ~20 flops/byte an H100 needs before arithmetic limits it:
//   scale   reads x, writes out          8 bytes/element
//   axpby   reads x and y, writes out   12 bytes/element
//   l2norm  reads x                      4 bytes/element (either mode)
// Design: one pass, each thread moving 16 bytes per load (float4) in a
// grid-stride loop, with a scalar loop for the n % 4 tail.  scale and
// l2norm cap the grid at 1,024 blocks (l2norm's partial sums need the
// cap).  axpby, three streams, takes a block per 256 float4s, a grid
// that covers the buffer once: on the H100 a grid of resident blocks that
// stride (1,024 of one float4 a thread, or fewer of four) ran at
// 1.06-1.08x torch.add's device time, this one at torch.add's.  Its a and
// b come as two device pointers.  The
// found-inf flag is a per-thread bool stored once as 1.0f: the OR is
// order-free, so plain stores replace the TPU's sequential (1,1) SMEM
// accumulator.  l2norm cannot carry a sum across blocks as the TPU grid
// does, so it runs two passes: per-block fp32 partial sums, then one
// block that adds the partials in a fixed order and takes the sqrt (no
// float atomics: the same bits on every run).
//
// The per-tensor mode reads a chunk table, int64 rows (tensor id, start,
// length), each tensor's chunks contiguous and in order, and `bounds`, the
// first chunk of each tensor (num_tensors + 1 entries).  A block per chunk
// writes the chunk's sum of squares (a chunk may start at any element, so
// the block peels up to three elements before its float4 run); then a
// block per tensor adds its chunks' partials, each thread a fixed stride
// of them, in a fixed tree: no float atomics, the same bits on every run.
//
// Scalars (scale, a and b) are read from device memory, so the loss
// scaler never brings a value to the host.  `out` may alias `x`.
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "common.cuh"

using namespace apex_tpu_torch;

__global__ void scale_kernel(const float* x, float* out, long long n,
                             const float* scale_p, float* flag) {
  const float s = *scale_p;
  const long long n4 = n >> 2;
  const long long stride = grid_stride();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* o4 = reinterpret_cast<float4*>(out);
  bool bad = false;
  for (long long i = global_tid(); i < n4; i += stride) {
    float4 a = x4[i];
    bad |= !finite4(a);
    a.x = a.x * s; a.y = a.y * s; a.z = a.z * s; a.w = a.w * s;
    o4[i] = a;
  }
  for (long long i = (n4 << 2) + global_tid(); i < n; i += stride) {
    const float a = x[i];
    bad |= !isfinite(a);
    out[i] = a * s;
  }
  if (bad) *flag = 1.0f;
}

// out may alias x or y: each index is read, then written, by one thread
__global__ void axpby_kernel(const float* x, const float* y, float* out,
                             long long n, const float* a_p, const float* b_p,
                             int arg_to_check, float* flag) {
  const float a = *a_p;
  const float b = *b_p;
  const bool chk_x = arg_to_check != 1;    // 0: x, 1: y, -1: both
  const bool chk_y = arg_to_check != 0;
  const long long n4 = n >> 2;
  const long long stride = grid_stride();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  const float4* y4 = reinterpret_cast<const float4*>(y);
  float4* o4 = reinterpret_cast<float4*>(out);
  bool bad = false;
  for (long long i = global_tid(); i < n4; i += stride) {
    const float4 xv = x4[i];
    const float4 yv = y4[i];
    if (chk_x) bad |= !finite4(xv);
    if (chk_y) bad |= !finite4(yv);
    float4 r;
    r.x = a * xv.x + b * yv.x;
    r.y = a * xv.y + b * yv.y;
    r.z = a * xv.z + b * yv.z;
    r.w = a * xv.w + b * yv.w;
    o4[i] = r;
  }
  for (long long i = (n4 << 2) + global_tid(); i < n; i += stride) {
    const float xv = x[i];
    const float yv = y[i];
    if (chk_x) bad |= !isfinite(xv);
    if (chk_y) bad |= !isfinite(yv);
    out[i] = a * xv + b * yv;
  }
  if (bad) *flag = 1.0f;
}

__global__ void l2norm_partial_kernel(const float* x, long long n,
                                      float* partials) {
  const long long n4 = n >> 2;
  const long long stride = grid_stride();
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float acc = 0.0f;
  for (long long i = global_tid(); i < n4; i += stride) {
    const float4 a = x4[i];
    acc += a.x * a.x;
    acc += a.y * a.y;
    acc += a.z * a.z;
    acc += a.w * a.w;
  }
  for (long long i = (n4 << 2) + global_tid(); i < n; i += stride) {
    const float a = x[i];
    acc += a * a;
  }
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = tot;
}

__global__ void l2norm_final_kernel(const float* partials, int nparts,
                                    float* out) {
  float acc = 0.0f;
  for (int i = threadIdx.x; i < nparts; i += blockDim.x) acc += partials[i];
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) *out = sqrtf(tot);
}

__global__ void l2norm_chunk_kernel(const float* x, const long long* chunks,
                                    float* partials) {
  const long long* c = chunks + 3 * (long long)blockIdx.x;
  const long long s = c[1], e = c[1] + c[2];
  long long a = (s + 3) & ~3LL;
  if (a > e) a = e;
  long long b = e & ~3LL;
  if (b < a) b = a;
  const int t = threadIdx.x;
  float acc = 0.0f;
  for (long long i = s + t; i < a; i += blockDim.x) acc += x[i] * x[i];
  for (long long i = b + t; i < e; i += blockDim.x) acc += x[i] * x[i];
  const float4* x4 = reinterpret_cast<const float4*>(x);
  for (long long i = (a >> 2) + t; i < (b >> 2); i += blockDim.x) {
    const float4 v = x4[i];
    acc += v.x * v.x;
    acc += v.y * v.y;
    acc += v.z * v.z;
    acc += v.w * v.w;
  }
  const float tot = block_sum(acc);
  if (t == 0) partials[blockIdx.x] = tot;
}

__global__ void l2norm_tensor_kernel(const float* partials,
                                     const long long* bounds, float* out) {
  const long long lo = bounds[blockIdx.x], hi = bounds[blockIdx.x + 1];
  float acc = 0.0f;
  for (long long i = lo + threadIdx.x; i < hi; i += blockDim.x)
    acc += partials[i];
  const float tot = block_sum(acc);
  if (threadIdx.x == 0) out[blockIdx.x] = tot;
}

extern "C" {

int apex_scale(const float* x, float* out, long long n, const float* scale,
               float* flag, int blocks, cudaStream_t stream) {
  scale_kernel<<<blocks, kThreads, 0, stream>>>(x, out, n, scale, flag);
  return (int)cudaGetLastError();
}

// a, b: device scalars; a block per kThreads float4s (the loop strides
// only past 2^31 - 1 blocks)
int apex_axpby(const float* x, const float* y, float* out, long long n,
               const float* a, const float* b, int arg_to_check, float* flag,
               cudaStream_t stream) {
  const long long need = ((n >> 2) + kThreads - 1) / kThreads;
  const int blocks = need < 1 ? 1 : (need > 2147483647LL ? 2147483647
                                                          : (int)need);
  axpby_kernel<<<blocks, kThreads, 0, stream>>>(x, y, out, n, a, b,
                                                arg_to_check, flag);
  return (int)cudaGetLastError();
}

// `blocks` partial sums land in `partials` (at least `blocks` floats,
// blocks <= 1024), then one 1024-thread block reduces them into *out.
int apex_l2norm(const float* x, long long n, float* partials, int blocks,
                float* out, cudaStream_t stream) {
  l2norm_partial_kernel<<<blocks, kThreads, 0, stream>>>(x, n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2norm_final_kernel<<<1, 1024, 0, stream>>>(partials, blocks, out);
  return (int)cudaGetLastError();
}

// Per-tensor sums of squares into out[num_tensors]: `nchunks` chunk
// partials land in `partials` (nchunks floats), then a block per tensor.
int apex_l2norm_per_tensor(const float* x, const long long* chunks,
                           long long nchunks, const long long* bounds,
                           int num_tensors, float* partials, float* out,
                           cudaStream_t stream) {
  l2norm_chunk_kernel<<<nchunks, kThreads, 0, stream>>>(x, chunks, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  l2norm_tensor_kernel<<<num_tensors, kThreads, 0, stream>>>(partials,
                                                            bounds, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
