// BatchNorm apply, forward and backward, on NCHW: the elementwise halves of
// SyncBatchNorm (the statistics and their cross-rank combine stay torch ops).
//
// Replaces apex_tpu/ops/pallas_syncbn.py: _fwd_kernel (:59) and
// _bwd_kernel (:65).
//
//   forward   y  = ((x - mean_c) * inv_c) * w_c + b_c
//   backward  dx = (dy * w_c) * inv_c,   per (n, c) row:  sum dy,  sum dy*xhat
//             with xhat = (x - mean_c) * inv_c
//
// x, y, dy and dx are fp32, bf16 or fp16 (dtype code 0, 1, 2); the math is
// fp32 and the per-channel vectors (mean, inv = rsqrt(var + eps), w, b) are
// fp32.  inv is computed by the caller (torch.rsqrt), as the JAX wrapper
// does: rsqrtf here would not be IEEE and the result would stop matching the
// plain PyTorch version bit for bit.  Built with -fmad=false, so each
// multiply and add rounds on its own, as PyTorch's separate ops do.
//
// Bound: device-memory bytes.  A few flops per element against ~295 an H100
// needs per byte before arithmetic limits it.  Forward reads x and writes y
// (4 bytes an element in bf16), backward reads dy and x and writes dx
// (6 bytes), plus 8 bytes of row sums per (n, c) row.
//
// Design.  The TPU kernels walk (N*C, H*W) rows padded to 128 lanes, one
// block of rows per grid step.  ResNet-50's planes run from H*W = 12,544
// (the stem) down to 49 (layer4), so a block per row would leave most
// threads idle on the small planes:
// - forward: a grid-stride loop over the flat NCHW index, the channel of an
//   element being (i / HW) % C.  When HW % 4 == 0 each thread moves 4
//   elements (8 bytes in bf16, 16 in fp32), which never straddle a plane.
// - backward: one warp per (n, c) row, grid-striding over rows.  Each lane
//   sums its elements in order, then the warp adds the 32 partials with a
//   fixed shuffle tree: the same bits on every run, and no float atomics.
//   The per-channel sum over N is a second, deterministic pass left to the
//   caller (a torch sum over an (N, C) tensor), as the JAX wrapper leaves it
//   to XLA.
// Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstdint>

#include "common.cuh"

using namespace apex_tpu_torch;

namespace {

constexpr int kMaxFwdBlocks = 4096;
constexpr int kMaxBwdBlocks = 8192;
constexpr int kRowsPerBlock = kThreads / 32;    // one warp per row

// VEC elements moved as one load or store
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// I: unsigned for n < 2**31 (32-bit division per element), else 64-bit
template <typename T, int VEC, typename I>
__global__ void bn_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                              const float* __restrict__ mean,
                              const float* __restrict__ inv,
                              const float* __restrict__ w,
                              const float* __restrict__ b, I n, I hw, I C) {
  const I npacks = n / VEC;
  const I stride = (I)gridDim.x * blockDim.x;
  const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x);
  Pack<T, VEC>* yv = reinterpret_cast<Pack<T, VEC>*>(y);
  for (I i = (I)blockIdx.x * blockDim.x + threadIdx.x; i < npacks;
       i += stride) {
    const I c = (i * VEC / hw) % C;
    const float m = mean[c], s = inv[c], g = w[c], sh = b[c];
    const Pack<T, VEC> in = xv[i];
    Pack<T, VEC> out;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float t = (to_f32(in.v[k]) - m) * s;
      out.v[k] = from_f32<T>(t * g + sh);
    }
    yv[i] = out;
  }
}

template <typename T, int VEC>
__global__ void bn_bwd_rows_kernel(const T* __restrict__ dy,
                                   const T* __restrict__ x,
                                   T* __restrict__ dx,
                                   const float* __restrict__ mean,
                                   const float* __restrict__ inv,
                                   const float* __restrict__ w,
                                   float* __restrict__ sum_dy,
                                   float* __restrict__ sum_dy_xhat, int rows,
                                   int hw, int C) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int hv = hw / VEC;
  const int nwarps = gridDim.x * warps;
  for (int r = blockIdx.x * warps + (threadIdx.x >> 5); r < rows;
       r += nwarps) {
    const int c = r % C;
    const float m = mean[c], s = inv[c], g = w[c];
    const long long base = (long long)r * hv;
    const Pack<T, VEC>* dyv = reinterpret_cast<const Pack<T, VEC>*>(dy) + base;
    const Pack<T, VEC>* xv = reinterpret_cast<const Pack<T, VEC>*>(x) + base;
    Pack<T, VEC>* dxv = reinterpret_cast<Pack<T, VEC>*>(dx) + base;
    float a_dy = 0.0f, a_dyx = 0.0f;
    for (int j = lane; j < hv; j += 32) {
      const Pack<T, VEC> d = dyv[j];
      const Pack<T, VEC> xx = xv[j];
      Pack<T, VEC> o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float fd = to_f32(d.v[k]);
        o.v[k] = from_f32<T>((fd * g) * s);
        const float xhat = (to_f32(xx.v[k]) - m) * s;
        a_dy += fd;
        a_dyx += fd * xhat;
      }
      dxv[j] = o;
    }
    for (int off = 16; off > 0; off >>= 1) {
      a_dy += __shfl_down_sync(0xffffffffu, a_dy, off);
      a_dyx += __shfl_down_sync(0xffffffffu, a_dyx, off);
    }
    if (lane == 0) {
      sum_dy[r] = a_dy;
      sum_dy_xhat[r] = a_dyx;
    }
  }
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

template <typename T, int VEC>
void fwd(const void* x, void* y, const float* mean, const float* inv,
         const float* w, const float* b, long long n, int hw, int C,
         cudaStream_t stream) {
  const long long packs = n / VEC;
  const int blocks =
      (int)std::min<long long>(ceil_div(packs, kThreads), kMaxFwdBlocks);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (n <= INT_MAX) {
    bn_fwd_kernel<T, VEC, unsigned><<<blocks, kThreads, 0, stream>>>(
        xt, yt, mean, inv, w, b, (unsigned)n, (unsigned)hw, (unsigned)C);
  } else {
    bn_fwd_kernel<T, VEC, unsigned long long>
        <<<blocks, kThreads, 0, stream>>>(xt, yt, mean, inv, w, b,
                                          (unsigned long long)n,
                                          (unsigned long long)hw,
                                          (unsigned long long)C);
  }
}

template <typename T>
void fwd_dispatch(const void* x, void* y, const float* mean,
                  const float* inv, const float* w, const float* b,
                  long long n, int hw, int C, cudaStream_t stream) {
  if (hw % 4 == 0 && aligned(x, 4 * sizeof(T)) && aligned(y, 4 * sizeof(T)))
    fwd<T, 4>(x, y, mean, inv, w, b, n, hw, C, stream);
  else
    fwd<T, 1>(x, y, mean, inv, w, b, n, hw, C, stream);
}

template <typename T, int VEC>
void bwd(const void* dy, const void* x, void* dx, const float* mean,
         const float* inv, const float* w, float* sdy, float* sdyx, int rows,
         int hw, int C, cudaStream_t stream) {
  const int blocks =
      (int)std::min<long long>(ceil_div(rows, kRowsPerBlock), kMaxBwdBlocks);
  bn_bwd_rows_kernel<T, VEC><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(x),
      static_cast<T*>(dx), mean, inv, w, sdy, sdyx, rows, hw, C);
}

template <typename T>
void bwd_dispatch(const void* dy, const void* x, void* dx, const float* mean,
                  const float* inv, const float* w, float* sdy, float* sdyx,
                  int rows, int hw, int C, cudaStream_t stream) {
  const size_t a = 4 * sizeof(T);
  if (hw % 4 == 0 && aligned(dy, a) && aligned(x, a) && aligned(dx, a))
    bwd<T, 4>(dy, x, dx, mean, inv, w, sdy, sdyx, rows, hw, C, stream);
  else
    bwd<T, 1>(dy, x, dx, mean, inv, w, sdy, sdyx, rows, hw, C, stream);
}

}  // namespace

extern "C" {

// n = N*C*hw elements of x and y; dtype 0 fp32, 1 bf16, 2 fp16.
int apex_bn_fwd(const void* x, void* y, const float* mean, const float* inv,
                const float* w, const float* b, long long n, int hw, int C,
                int dtype, cudaStream_t stream) {
  switch (dtype) {
    case 0: fwd_dispatch<float>(x, y, mean, inv, w, b, n, hw, C, stream);
      break;
    case 1: fwd_dispatch<__nv_bfloat16>(x, y, mean, inv, w, b, n, hw, C,
                                        stream);
      break;
    case 2: fwd_dispatch<__half>(x, y, mean, inv, w, b, n, hw, C, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows = N*C; sum_dy and sum_dy_xhat hold one fp32 per row.
int apex_bn_bwd(const void* dy, const void* x, void* dx, const float* mean,
                const float* inv, const float* w, float* sum_dy,
                float* sum_dy_xhat, int rows, int hw, int C, int dtype,
                cudaStream_t stream) {
  switch (dtype) {
    case 0: bwd_dispatch<float>(dy, x, dx, mean, inv, w, sum_dy, sum_dy_xhat,
                                rows, hw, C, stream);
      break;
    case 1: bwd_dispatch<__nv_bfloat16>(dy, x, dx, mean, inv, w, sum_dy,
                                        sum_dy_xhat, rows, hw, C, stream);
      break;
    case 2: bwd_dispatch<__half>(dy, x, dx, mean, inv, w, sum_dy,
                                 sum_dy_xhat, rows, hw, C, stream);
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
