// LAMB stage 1 and stage 2 over flat fp32 buffers.
//
// Replaces apex_tpu/ops/pallas_lamb.py: _stage1_kernel (:30) and
// _stage2_kernel (:84), with their math exactly:
//   stage 1   g~ = g * inv_clip
//             g~ = g~ + wd*p                   (L2 mode: not adam_w_mode)
//             m  = beta1*m + beta3*g~
//             v  = beta2*v + ((1-beta2)*g~)*g~
//             u  = (m*inv_bc1) / (sqrt(v*inv_bc2) + eps)
//             u  = u + wd*p                    (adam_w_mode: decoupled)
//   stage 2   p  = p - (lr*ratio[tensor])*u,   half[i] = rn(p) (optional)
//
// Bound: device-memory bytes, a few flops per element.  Stage 1 reads g,
// p, m, v and writes u, m, v (28 bytes an element); stage 2 reads p and u
// and writes p and the half copy (14 bytes).
// Design: stage 1 is one grid-stride pass with 16-byte loads (float4) of
// each operand and a scalar tail; m and v are updated in place (the TPU
// kernel's input_output_aliases {3:1, 4:2}).  Stage 2 needs each
// element's tensor, for its trust ratio: where the TPU expands the ratios
// to a per-element buffer (a second flat read), here a block per chunk of
// the chunk table (tensor id, start, length) reads its tensor's ratio
// once.  A chunk may start at any element (the masters are dense, not
// padded per tensor), so a block peels up to three elements before its
// aligned float4 run and handles the tail one element a thread.
//
// inv_clip, inv_bc1, inv_bc2 and lr are read from device memory, and
// `noop` is the loss scaler's found-inf flag: when it is non-zero every
// thread returns before touching memory, so a skipped step leaves u, m,
// v, p and the half copy bitwise unchanged with no host sync.  Built with
// -fmad=false: each multiply and add rounds on its own, as in the plain
// PyTorch versions.  Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace apex_tpu_torch;

struct LambArgs {
  float beta1, beta2, beta3, one_minus_beta2, eps, wd;
  bool adam_w_mode;
};

__device__ __forceinline__ float lamb_one(float g, float p, float& m,
                                          float& v, float inv_clip,
                                          float inv_bc1, float inv_bc2,
                                          const LambArgs& a) {
  float gs = g * inv_clip;
  if (!a.adam_w_mode && a.wd != 0.0f) gs = gs + a.wd * p;
  m = a.beta1 * m + a.beta3 * gs;
  v = a.beta2 * v + a.one_minus_beta2 * gs * gs;
  float u = (m * inv_bc1) / (sqrtf(v * inv_bc2) + a.eps);
  if (a.adam_w_mode && a.wd != 0.0f) u = u + a.wd * p;
  return u;
}

__global__ void lamb_stage1_kernel(const float* g, const float* p, float* m,
                                   float* v, float* upd, long long n,
                                   const float* inv_clip_p,
                                   const float* inv_bc1_p,
                                   const float* inv_bc2_p, const float* noop,
                                   LambArgs a) {
  if (noop != nullptr && *noop != 0.0f) return;
  const float ic = *inv_clip_p, b1 = *inv_bc1_p, b2 = *inv_bc2_p;
  const long long n4 = n >> 2;
  const long long stride = grid_stride();
  const float4* g4 = reinterpret_cast<const float4*>(g);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* u4 = reinterpret_cast<float4*>(upd);
  for (long long i = global_tid(); i < n4; i += stride) {
    const float4 gv = g4[i], pv = p4[i];
    float4 mv = m4[i], vv = v4[i], uv;
    uv.x = lamb_one(gv.x, pv.x, mv.x, vv.x, ic, b1, b2, a);
    uv.y = lamb_one(gv.y, pv.y, mv.y, vv.y, ic, b1, b2, a);
    uv.z = lamb_one(gv.z, pv.z, mv.z, vv.z, ic, b1, b2, a);
    uv.w = lamb_one(gv.w, pv.w, mv.w, vv.w, ic, b1, b2, a);
    m4[i] = mv;
    v4[i] = vv;
    u4[i] = uv;
  }
  for (long long i = (n4 << 2) + global_tid(); i < n; i += stride) {
    float mv = m[i], vv = v[i];
    upd[i] = lamb_one(g[i], p[i], mv, vv, ic, b1, b2, a);
    m[i] = mv;
    v[i] = vv;
  }
}

struct NoHalf {};

__device__ __forceinline__ void put4(NoHalf*, long long, float4) {}
__device__ __forceinline__ void put1(NoHalf*, long long, float) {}

__device__ __forceinline__ void put4(__nv_bfloat16* h, long long i, float4 p) {
  __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(h + i);
  h2[0] = __halves2bfloat162(__float2bfloat16_rn(p.x),
                             __float2bfloat16_rn(p.y));
  h2[1] = __halves2bfloat162(__float2bfloat16_rn(p.z),
                             __float2bfloat16_rn(p.w));
}
__device__ __forceinline__ void put1(__nv_bfloat16* h, long long i, float p) {
  h[i] = __float2bfloat16_rn(p);
}

__device__ __forceinline__ void put4(__half* h, long long i, float4 p) {
  __half2* h2 = reinterpret_cast<__half2*>(h + i);
  h2[0] = __halves2half2(__float2half_rn(p.x), __float2half_rn(p.y));
  h2[1] = __halves2half2(__float2half_rn(p.z), __float2half_rn(p.w));
}
__device__ __forceinline__ void put1(__half* h, long long i, float p) {
  h[i] = __float2half_rn(p);
}

// chunks: int64 rows (tensor id, start, length), one block each.
template <typename H>
__global__ void lamb_stage2_kernel(float* p, const float* upd,
                                   const float* ratio,
                                   const long long* chunks, const float* lr_p,
                                   H* half, const float* noop) {
  if (noop != nullptr && *noop != 0.0f) return;
  const long long* c = chunks + 3 * (long long)blockIdx.x;
  const long long s = c[1], e = c[1] + c[2];
  const float step = *lr_p * ratio[c[0]];
  // [s, a) and [b, e) one element a thread; [a, b) as float4
  long long a = (s + 3) & ~3LL;
  if (a > e) a = e;
  long long b = e & ~3LL;
  if (b < a) b = a;
  const int t = threadIdx.x;
  for (long long i = s + t; i < a; i += blockDim.x) {
    const float pv = p[i] - step * upd[i];
    p[i] = pv;
    put1(half, i, pv);
  }
  for (long long i = b + t; i < e; i += blockDim.x) {
    const float pv = p[i] - step * upd[i];
    p[i] = pv;
    put1(half, i, pv);
  }
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* u4 = reinterpret_cast<const float4*>(upd);
  for (long long i = (a >> 2) + t; i < (b >> 2); i += blockDim.x) {
    float4 pv = p4[i];
    const float4 uv = u4[i];
    pv.x = pv.x - step * uv.x;
    pv.y = pv.y - step * uv.y;
    pv.z = pv.z - step * uv.z;
    pv.w = pv.w - step * uv.w;
    p4[i] = pv;
    put4(half, i << 2, pv);
  }
}

extern "C" {

int apex_lamb_stage1(const float* g, const float* p, float* m, float* v,
                     float* upd, long long n, const float* inv_clip,
                     const float* inv_bc1, const float* inv_bc2,
                     const float* noop, float beta1, float beta2, float beta3,
                     float one_minus_beta2, float eps, float weight_decay,
                     int adam_w_mode, int blocks, cudaStream_t stream) {
  const LambArgs a{beta1, beta2, beta3, one_minus_beta2, eps, weight_decay,
                   adam_w_mode != 0};
  lamb_stage1_kernel<<<blocks, kThreads, 0, stream>>>(
      g, p, m, v, upd, n, inv_clip, inv_bc1, inv_bc2, noop, a);
  return (int)cudaGetLastError();
}

// half_kind: 0 no half copy, 1 bfloat16, 2 float16.
int apex_lamb_stage2(float* p, const float* upd, const float* ratio,
                     const long long* chunks, long long nchunks,
                     const float* lr, void* half, int half_kind,
                     const float* noop, cudaStream_t stream) {
  switch (half_kind) {
    case 0:
      lamb_stage2_kernel<NoHalf><<<nchunks, kThreads, 0, stream>>>(
          p, upd, ratio, chunks, lr, nullptr, noop);
      break;
    case 1:
      lamb_stage2_kernel<__nv_bfloat16><<<nchunks, kThreads, 0, stream>>>(
          p, upd, ratio, chunks, lr, static_cast<__nv_bfloat16*>(half), noop);
      break;
    case 2:
      lamb_stage2_kernel<__half><<<nchunks, kThreads, 0, stream>>>(
          p, upd, ratio, chunks, lr, static_cast<__half*>(half), noop);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
