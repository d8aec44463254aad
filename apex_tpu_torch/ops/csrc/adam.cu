// Fused Adam over flat fp32 buffers, in place, with the half-precision
// copy of the new parameters written in the same pass.
//
// Replaces apex_tpu/ops/pallas_adam.py::_adam_kernel (:27), with its math
// exactly (:30-48):
//   g~ = g * inv_scale          (a multiply by the reciprocal, not g/scale)
//   m  = beta1*m + (1-beta1)*g~
//   v  = beta2*v + ((1-beta2)*g~)*g~
//   denom = sqrt(v + eps) | sqrt(v) + eps
//   p  = p - step_size * (m/denom + weight_decay*p)
//   half[i] = round-to-nearest-even(p)   (optional, bf16 or fp16)
//
// Bound: device-memory bytes.  Per element it reads p, m, v, g (16 bytes)
// and writes p, m, v (12) and the half copy (2): 30 bytes for ~15 flops.
// Design: one pass with 16-byte loads (float4) of each operand in a
// grid-stride loop and a scalar tail; p, m and v are updated in place
// (the TPU kernel's input_output_aliases {1:0, 2:1, 3:2}).
//
// step_size and inv_scale are read from device memory, and `noop` is the
// loss scaler's found-inf flag: when it is non-zero every thread returns
// before touching memory (the reference Apex's noop_gmem), so a skipped
// step leaves p, m, v and the half copy bitwise unchanged with no host
// sync.  Built with -fmad=false: each multiply and add rounds on its own,
// as in the plain PyTorch version.  Returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace apex_tpu_torch;

struct AdamArgs {
  float beta1, one_minus_beta1, beta2, one_minus_beta2, eps, wd;
  bool eps_inside_sqrt;
};

__device__ __forceinline__ float adam_one(float& p, float& m, float& v,
                                          float g, float ss, float inv,
                                          const AdamArgs& a) {
  const float gs = g * inv;
  m = a.beta1 * m + a.one_minus_beta1 * gs;
  v = a.beta2 * v + a.one_minus_beta2 * gs * gs;
  const float denom = a.eps_inside_sqrt ? sqrtf(v + a.eps) : sqrtf(v) + a.eps;
  const float update = m / denom + a.wd * p;
  p = p - ss * update;
  return p;
}

struct NoHalf {};

__device__ __forceinline__ void store_half4(NoHalf*, long long, float4) {}
__device__ __forceinline__ void store_half1(NoHalf*, long long, float) {}

__device__ __forceinline__ void store_half4(__nv_bfloat16* h, long long i,
                                            float4 p) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(h);
  h2[2 * i] = __halves2bfloat162(__float2bfloat16_rn(p.x),
                                 __float2bfloat16_rn(p.y));
  h2[2 * i + 1] = __halves2bfloat162(__float2bfloat16_rn(p.z),
                                     __float2bfloat16_rn(p.w));
}
__device__ __forceinline__ void store_half1(__nv_bfloat16* h, long long i,
                                            float p) {
  h[i] = __float2bfloat16_rn(p);
}

__device__ __forceinline__ void store_half4(__half* h, long long i, float4 p) {
  __half2* h2 = reinterpret_cast<__half2*>(h);
  h2[2 * i] = __halves2half2(__float2half_rn(p.x), __float2half_rn(p.y));
  h2[2 * i + 1] = __halves2half2(__float2half_rn(p.z), __float2half_rn(p.w));
}
__device__ __forceinline__ void store_half1(__half* h, long long i, float p) {
  h[i] = __float2half_rn(p);
}

template <typename H>
__global__ void adam_kernel(float* p, float* m, float* v, const float* g,
                            H* half, long long n, const float* step_size,
                            const float* inv_scale, const float* noop,
                            AdamArgs a) {
  if (noop != nullptr && *noop != 0.0f) return;
  const float ss = *step_size;
  const float inv = *inv_scale;
  const long long n4 = n >> 2;
  const long long stride = grid_stride();
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  for (long long i = global_tid(); i < n4; i += stride) {
    float4 pv = p4[i], mv = m4[i], vv = v4[i];
    const float4 gv = g4[i];
    adam_one(pv.x, mv.x, vv.x, gv.x, ss, inv, a);
    adam_one(pv.y, mv.y, vv.y, gv.y, ss, inv, a);
    adam_one(pv.z, mv.z, vv.z, gv.z, ss, inv, a);
    adam_one(pv.w, mv.w, vv.w, gv.w, ss, inv, a);
    p4[i] = pv;
    m4[i] = mv;
    v4[i] = vv;
    store_half4(half, i, pv);
  }
  for (long long i = (n4 << 2) + global_tid(); i < n; i += stride) {
    float pv = p[i], mv = m[i], vv = v[i];
    adam_one(pv, mv, vv, g[i], ss, inv, a);
    p[i] = pv;
    m[i] = mv;
    v[i] = vv;
    store_half1(half, i, pv);
  }
}

extern "C" {

// half_kind: 0 no half copy, 1 bfloat16, 2 float16.
int apex_adam(float* p, float* m, float* v, const float* g, void* half,
              int half_kind, long long n, const float* step_size,
              const float* inv_scale, const float* noop, float beta1,
              float one_minus_beta1, float beta2, float one_minus_beta2,
              float eps, int eps_inside_sqrt, float weight_decay, int blocks,
              cudaStream_t stream) {
  const AdamArgs a{beta1, one_minus_beta1, beta2, one_minus_beta2, eps,
                   weight_decay, eps_inside_sqrt != 0};
  switch (half_kind) {
    case 0:
      adam_kernel<NoHalf><<<blocks, kThreads, 0, stream>>>(
          p, m, v, g, nullptr, n, step_size, inv_scale, noop, a);
      break;
    case 1:
      adam_kernel<__nv_bfloat16><<<blocks, kThreads, 0, stream>>>(
          p, m, v, g, static_cast<__nv_bfloat16*>(half), n, step_size,
          inv_scale, noop, a);
      break;
    case 2:
      adam_kernel<__half><<<blocks, kThreads, 0, stream>>>(
          p, m, v, g, static_cast<__half*>(half), n, step_size, inv_scale,
          noop, a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
