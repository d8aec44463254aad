// Shared pieces of the kernels: the grid-stride index range, a block sum
// whose order is fixed (so a reduction gives the same bits on every run),
// and the conversions between fp32 and the storage types.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace apex_tpu_torch {

constexpr int kThreads = 256;

__device__ __forceinline__ long long global_tid() {
  return (long long)blockIdx.x * blockDim.x + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * blockDim.x;
}

__device__ __forceinline__ bool finite4(const float4& a) {
  return isfinite(a.x) && isfinite(a.y) && isfinite(a.z) && isfinite(a.w);
}

// Sum of `v` over the block, returned to thread 0.  Warp shuffles down,
// then warp 0 sums the per-warp totals: a fixed tree, no atomics.
// blockDim.x must be a multiple of 32 and at most 1024.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if (lane == 0) warp_tot[warp] = v;
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  v = (threadIdx.x < nwarps) ? warp_tot[lane] : 0.0f;
  if (warp == 0) {
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// fp32 <-> storage type (fp32, bf16, fp16), rounding to nearest even
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// v rounded to T and read back as fp32 (a jnp .astype(T) inside fp32 math)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace apex_tpu_torch
