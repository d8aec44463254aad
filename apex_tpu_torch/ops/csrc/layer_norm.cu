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
// and mask the columns past n2.  Here a row is cut into 16-byte chunks (8
// bf16/fp16 or 4 fp32 columns) and each thread owns whole chunks of it.
//
// The forward holds each row in registers up to n2 = 8192, so x is read
// from device memory once and both sums run over the copy in hand.  Up to
// n2 = 1024 (BERT-base 768, BERT-large 1024) a warp owns a row, lane l the
// chunks l + 32k (3 chunks a lane at 768 bf16, 4 at 1024, 6 at 768 fp32);
// from 1025 to 8192 the block's 8 warps share a row, thread t the chunks
// t + 256k, and add their sums through shared memory in warp order.  Where
// a row is whole chunks and x, w, b and y are 16-byte aligned, x and y move
// as one 16-byte load or store a chunk and w and b as float4s.  Each warp
// (or block) owns rows_per_group consecutive rows: it loads its columns of
// w and b into registers once and keeps them over its rows, and issues the
// next row's loads before it sums and stores the row in hand (a register
// double buffer).  The element path (a row not whole chunks, or an operand
// off 16 bytes) gives each thread the same columns through loads of one
// element and runs the same sums in the same order, so an aligned tensor
// and a misaligned view of the same values give the same bits.  Rows wider
// than 8192 stream from device memory, one pass per sum, a warp a row.
// The host sizes the grid from (n1, n2) alone; a row's bits do not depend
// on the grid.  The forward launches with programmatic dependent launch
// and waits before its first read of x, w or b.
//
// The backward at n2 <= 1024 reads each row in 16-byte chunks where the row
// is whole chunks and every operand is 16-byte aligned (8 bf16/fp16 or 4
// fp32 columns a lane a load; 3 loads of dy and 3 of x a lane at 768 bf16),
// through a two-stage cp.async ring in shared memory, so a warp's next row
// is in flight while it sums and stores this one; g = dy*w and xhat stay in
// registers between the two passes over a row.  Other shapes take the
// element-load kernel, chosen by the host.  The host sizes the grid from
// (n1, n2) alone: rows_per_warp consecutive rows a warp, blocks of 8
// warps, at most 128 blocks.  Wider rows stream from device memory.
//
// dw and db.  The TPU accumulates them across its sequential grid.  Blocks
// run in no order here, and float atomics would give other bits on every
// run, so: each warp sums its rows' dy*xhat and dy per column in registers,
// the block's warps add theirs in shared memory in warp order, one partial
// row per block goes to device memory, and a second kernel, scheduled while
// the first finishes (programmatic dependent launch), sums the partials of
// each column with eight loads in flight a lane and fixed trees.  (Rows
// wider than 1024 keep a partial row per warp in device memory instead.)
// Every order is fixed, so the same inputs give the same bits, on any H100:
// the partial count depends on (n1, n2) alone.  One launch, with the last
// block to arrive summing the partial rows, measured slower on the H100: a
// fence and an integer ticket a block, or a cluster exchange through
// distributed shared memory, cost more than the second launch.
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

using namespace apex_tpu_torch;

namespace {

constexpr int kWarps = kThreads / 32;   // rows in flight per block
constexpr int kMaxRegCols = 1024;       // widest row a warp holds
constexpr int kMaxWideCols = 8192;      // widest row the forward holds
constexpr int kFwdMaxWarps = 8;         // warps a block of the forward
constexpr int kWideThreads = 256;       // threads that share a wide row

__device__ __forceinline__ float warp_sum(float v) {
  // xor butterfly: every lane ends with the same total, in a fixed order
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Programmatic dependent launch: a kernel of this file is scheduled while
// the kernel before it on the stream finishes and waits here, before its
// first read, until that kernel's writes are visible.  The forward lets
// the kernel after it be scheduled at once (that kernel waits in turn);
// the backward's row kernel lets ln_colsum_kernel be scheduled once each
// of its blocks is past its rows.  Each wait returns at once when the
// kernel was launched without the dependency.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_on_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// two 16-bit values a word, the lower column in the low half; the type is
// picked by a null pointer of it
__device__ __forceinline__ float lo16(uint32_t v, const __nv_bfloat16*) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi16(uint32_t v, const __nv_bfloat16*) {
  return __uint_as_float(v & 0xffff0000u);
}
__device__ __forceinline__ uint32_t bits16(float f, const __nv_bfloat16*) {
  return __bfloat16_as_ushort(from_f32<__nv_bfloat16>(f));
}
__device__ __forceinline__ float lo16(uint32_t v, const __half*) {
  return __half2float(__ushort_as_half((unsigned short)(v & 0xffffu)));
}
__device__ __forceinline__ float hi16(uint32_t v, const __half*) {
  return __half2float(__ushort_as_half((unsigned short)(v >> 16)));
}
__device__ __forceinline__ uint32_t bits16(float f, const __half*) {
  return __half_as_ushort(from_f32<__half>(f));
}
// 16 bytes of T as E floats, and E floats rounded to T as 16 bytes; element
// e of the pack is column E*j + e of chunk j.  Two-byte types:
template <typename T>
struct Pack16 {
  static constexpr int E = 8;
  __device__ static void load(const uint4& u, float* f) {
    const T* t = nullptr;
    const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = lo16(v[i], t);
      f[2 * i + 1] = hi16(v[i], t);
    }
  }
  __device__ static uint4 store(const float* f) {
    const T* t = nullptr;
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = bits16(f[2 * i], t) | bits16(f[2 * i + 1], t) << 16;
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Pack16<float> {
  static constexpr int E = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};

// -- forward -----------------------------------------------------------------

// the unsigned integer of T's size: an element's bits
template <typename T>
using Bits = std::conditional_t<sizeof(T) == 4, uint32_t, uint16_t>;

// Chunk j of a row (columns E*j .. E*j + E-1) as the 16 bytes of T it
// holds: one 16-byte load on the vector path; on the element path E loads
// of one element, zero bits (+0.0) past n2.
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_chunk(const T* row, int j, int n2) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(row) + j);
  } else {
    const Bits<T>* r = reinterpret_cast<const Bits<T>*>(row);
    uint32_t v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        const int c = 4 * j + i;
        v[i] = c < n2 ? __ldg(r + c) : 0u;
      } else {
        const int c = 8 * j + 2 * i;
        const uint32_t lo = c < n2 ? __ldg(r + c) : 0u;
        const uint32_t hi = c + 1 < n2 ? __ldg(r + c + 1) : 0u;
        v[i] = lo | hi << 16;
      }
    }
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the 16 bytes of chunk j into a row, the columns past n2 left alone
template <typename T, bool VEC>
__device__ __forceinline__ void store_chunk(T* row, int j, int n2,
                                            const uint4& u) {
  if constexpr (VEC) {
    reinterpret_cast<uint4*>(row)[j] = u;
  } else {
    Bits<T>* r = reinterpret_cast<Bits<T>*>(row);
    const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        const int c = 4 * j + i;
        if (c < n2) r[c] = v[i];
      } else {
        const int c = 8 * j + 2 * i;
        if (c < n2) r[c] = (uint16_t)(v[i] & 0xffffu);
        if (c + 1 < n2) r[c + 1] = (uint16_t)(v[i] >> 16);
      }
    }
  }
}

// the E fp32 values of chunk j's columns of w or b (0 past n2)
template <int E, bool VEC>
__device__ __forceinline__ void load_cols(const float* p, int j, int n2,
                                          float* f) {
  if constexpr (VEC) {
#pragma unroll
    for (int i = 0; i < E / 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) +
                             j * (E / 4) + i);
      f[4 * i] = v.x;
      f[4 * i + 1] = v.y;
      f[4 * i + 2] = v.z;
      f[4 * i + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int c = E * j + e;
      f[e] = c < n2 ? __ldg(p + c) : 0.0f;
    }
  }
}

// a thread's values summed in a fixed order: E running sums over its
// chunks, then a pairwise tree over the E
template <int VC, int E>
__device__ __forceinline__ float thread_sum(const float (&v)[VC][E]) {
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = v[0][e];
#pragma unroll
  for (int k = 1; k < VC; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] += v[k][e];
#pragma unroll
  for (int h = E / 2; h > 0; h >>= 1)
#pragma unroll
    for (int e = 0; e < h; ++e) acc[e] += acc[e + h];
  return acc[0];
}

// Rows of n2 <= 8192, held in registers (see the header).  WIDE false: a
// warp a row, lane l the chunks l + 32k; WIDE true (n2 > 1024): the
// block's kWideThreads threads a row, thread t the chunks t +
// kWideThreads*k, the warps' sums added through shared memory in warp
// order.  VC chunks a thread; VEC: 16-byte loads and stores.  Group g (a
// warp, or the block) takes the rows g * rows_per_group onwards; chunks a
// thread does not own hold zeros and add nothing.
template <typename T, int VC, bool VEC, bool WIDE>
__global__ void __launch_bounds__(kFwdMaxWarps * 32)
    ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ inv, int n1,
                  int n2, int rows_per_group, float eps) {
  using P = Pack16<T>;
  constexpr int E = P::E;
  constexpr int G = WIDE ? kWideThreads : 32;   // threads that share a row
  __shared__ float red[2][kWideThreads / 32];
  const int t = WIDE ? threadIdx.x : (threadIdx.x & 31);
  const int group = WIDE ? blockIdx.x
                         : blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int r0 = group * rows_per_group;
  const int r1 = min(r0 + rows_per_group, n1);
  const int nc = (n2 + E - 1) / E;
  const float fn = (float)n2;
  wait_on_primary();
  launch_dependents();
  if (r0 >= r1) return;   // WIDE: the whole block

  // v summed over the threads that share the row; slot s of `red` (the
  // two sums of a row alternate, so one barrier a sum suffices)
  auto total = [&](float v, int s) {
    v = warp_sum(v);
    if constexpr (WIDE) {
      if ((threadIdx.x & 31) == 0) red[s][threadIdx.x >> 5] = v;
      __syncthreads();
      v = red[s][0];
#pragma unroll
      for (int i = 1; i < kWideThreads / 32; ++i) v += red[s][i];
    }
    return v;
  };
  auto fetch = [&](int r, uint4 (&dst)[VC]) {
    const T* xr = x + (long long)r * n2;
#pragma unroll
    for (int k = 0; k < VC; ++k) {
      const int j = t + G * k;
      dst[k] = j < nc ? load_chunk<T, VEC>(xr, j, n2) : make_uint4(0, 0, 0, 0);
    }
  };

  uint4 cur[VC], nxt[VC];
  fetch(r0, cur);
  // this thread's columns of w and b, kept over the group's rows
  float wv[VC][E], bv[VC][E];
#pragma unroll
  for (int k = 0; k < VC; ++k) {
    const int j = t + G * k;
    if (j < nc) {
      load_cols<E, VEC>(w, j, n2, wv[k]);
      load_cols<E, VEC>(b, j, n2, bv[k]);
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) wv[k][e] = bv[k][e] = 0.0f;
    }
  }
  for (int r = r0; r < r1; ++r) {
    if (r + 1 < r1) fetch(r + 1, nxt);   // in flight while row r is summed
    float v[VC][E];
#pragma unroll
    for (int k = 0; k < VC; ++k) P::load(cur[k], v[k]);
    const float mu = total(thread_sum(v), 0) / fn;
    float sq[VC][E];
#pragma unroll
    for (int k = 0; k < VC; ++k)
#pragma unroll
      for (int e = 0; e < E; ++e) {
        v[k][e] = E * (t + G * k) + e < n2 ? v[k][e] - mu : 0.0f;
        sq[k][e] = v[k][e] * v[k][e];
      }
    const float iv = rsqrtf(total(thread_sum(sq), 1) / fn + eps);
    T* yr = y + (long long)r * n2;
#pragma unroll
    for (int k = 0; k < VC; ++k) {
      const int j = t + G * k;
      if (j < nc) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e) o[e] = (v[k][e] * iv) * wv[k][e] + bv[k][e];
        store_chunk<T, VEC>(yr, j, n2, P::store(o));
      }
    }
    if (t == 0) {
      mean[r] = mu;
      inv[r] = iv;
    }
    if (r + 1 < r1) {
#pragma unroll
      for (int k = 0; k < VC; ++k) cur[k] = nxt[k];
    }
  }
}

// rows wider than kMaxWideCols: a warp a row, one pass over device memory
// per sum; warp g takes the rows g * rows_per_group onwards
template <typename T>
__global__ void ln_fwd_stream_kernel(const T* __restrict__ x,
                                     const float* __restrict__ w,
                                     const float* __restrict__ b,
                                     T* __restrict__ y,
                                     float* __restrict__ mean,
                                     float* __restrict__ inv, int n1, int n2,
                                     int rows_per_group, float eps) {
  const int lane = threadIdx.x & 31;
  const int r0 = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
                 rows_per_group;
  const int r1 = min(r0 + rows_per_group, n1);
  const float fn = (float)n2;
  wait_on_primary();
  launch_dependents();
  for (int row = r0; row < r1; ++row) {
    const T* xr = x + (long long)row * n2;
    T* yr = y + (long long)row * n2;
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
}

// -- backward ----------------------------------------------------------------

constexpr int kBwdMaxWarps = 8;      // warps a block of the register paths
constexpr int kSumAcc = 8;           // independent sums a ln_colsum_kernel lane

// Rows of n2 <= 1024 where a row is whole 16-byte chunks and every operand
// is 16-byte aligned.  Warp v of block b takes rows_per_warp consecutive
// rows from (b * warps + v) * rows_per_warp; lane l owns the chunks
// j = l + 32k (k < VC) of a row, columns E*j .. E*j + E-1.  Each warp's
// rows come through a ring of two stages in shared memory by 16-byte
// cp.async; the first pass over a row keeps g = dy*w and xhat in registers,
// so its stage is refilled with the row after next before the row's sums
// and stores.  The warp's column sums of dy*xhat and dy stay in registers
// over its rows; at the end the block's warps add theirs in warp order and
// write one partial row of each.  Shared: 4 * warps * n2 * sizeof(T) bytes
// (two stages of dy and x), at least the 8 * warps * n2 the sums reuse it
// for.
template <typename T, int VC>
__global__ void __launch_bounds__(kBwdMaxWarps * 32, 1)
    ln_bwd_vec_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ mean,
                      const float* __restrict__ inv, T* __restrict__ dx,
                      float* __restrict__ part_w, float* __restrict__ part_b,
                      int n1, int n2, int rows_per_warp) {
  using P = Pack16<T>;
  constexpr int E = P::E;
  extern __shared__ uint4 ring[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int nc = n2 / E;
  const float fn = (float)n2;
  const uint4* dyc = reinterpret_cast<const uint4*>(dy);
  const uint4* xc = reinterpret_cast<const uint4*>(x);
  const float4* w4 = reinterpret_cast<const float4*>(w);
  uint4* dxc = reinterpret_cast<uint4*>(dx);
  uint4* mine = ring + (long long)warp * 4 * nc;  // [stage][dy, x][nc]
  const int r0 = (blockIdx.x * warps + warp) * rows_per_warp;
  const int r1 = min(r0 + rows_per_warp, n1);

  // row r into stage s: one cp.async group, empty past the warp's rows
  auto fetch = [&](int r, int s) {
    if (r < r1) {
      const long long base = (long long)r * nc;
#pragma unroll
      for (int k = 0; k < VC; ++k) {
        const int j = lane + 32 * k;
        if (j < nc) {
          cp_async16(mine + (2 * s) * nc + j, dyc + base + j);
          cp_async16(mine + (2 * s + 1) * nc + j, xc + base + j);
        }
      }
    }
    cp_async_commit();
  };

  float gw[VC][E], gb[VC][E];
#pragma unroll
  for (int k = 0; k < VC; ++k)
#pragma unroll
    for (int e = 0; e < E; ++e) gw[k][e] = gb[k][e] = 0.0f;
  wait_on_primary();
  fetch(r0, 0);
  fetch(r0 + 1, 1);
  // the statistics of the row in hand and of the next
  float mu = 0.0f, iv = 0.0f, mu_next = 0.0f, iv_next = 0.0f;
  if (r0 < r1) {
    mu = mean[r0];
    iv = inv[r0];
  }
  if (r0 + 1 < r1) {
    mu_next = mean[r0 + 1];
    iv_next = inv[r0 + 1];
  }
  int s = 0;
  for (int r = r0; r < r1; ++r, s ^= 1) {
    cp_async_wait<1>();  // this lane's copies of row r have landed
    const uint4* sdy = mine + (2 * s) * nc;
    const uint4* sx = sdy + nc;
    float g[VC][E], xh[VC][E];
    float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
    for (int k = 0; k < VC; ++k) {
      const int j = lane + 32 * k;
      if (j < nc) {
        float d[E];
        P::load(sdy[j], d);
        P::load(sx[j], xh[k]);
#pragma unroll
        for (int i = 0; i < E / 4; ++i) {
          const float4 v = __ldg(w4 + j * (E / 4) + i);
          g[k][4 * i] = v.x;
          g[k][4 * i + 1] = v.y;
          g[k][4 * i + 2] = v.z;
          g[k][4 * i + 3] = v.w;
        }
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xh[k][e] = (xh[k][e] - mu) * iv;
          g[k][e] = d[e] * g[k][e];
          a1 += g[k][e];
          a2 += g[k][e] * xh[k][e];
          gw[k][e] += d[e] * xh[k][e];
          gb[k][e] += d[e];
        }
      }
    }
    // this lane has read its own chunks of stage s: refill it
    fetch(r + 2, s);
    const float c1 = warp_sum(a1) / fn;
    const float c2 = warp_sum(a2) / fn;
    const long long base = (long long)r * nc;
#pragma unroll
    for (int k = 0; k < VC; ++k) {
      const int j = lane + 32 * k;
      if (j < nc) {
        float o[E];
#pragma unroll
        for (int e = 0; e < E; ++e)
          o[e] = iv * ((g[k][e] - c1) - xh[k][e] * c2);
        dxc[base + j] = P::store(o);
      }
    }
    mu = mu_next;
    iv = iv_next;
    if (r + 2 < r1) {
      mu_next = mean[r + 2];
      iv_next = inv[r + 2];
    }
  }
  cp_async_wait<0>();
  launch_dependents();
  __syncthreads();
  // the block's partial rows: red[0] the warps' dw sums, red[1] their db
  // sums, [warp][n2 / 4] float4s each; warps added in order 0, 1, ...
  float4* red = reinterpret_cast<float4*>(ring);
  const int n4 = n2 / 4;
#pragma unroll
  for (int k = 0; k < VC; ++k) {
    const int j = lane + 32 * k;
    if (j < nc) {
#pragma unroll
      for (int i = 0; i < E / 4; ++i) {
        const int q = j * (E / 4) + i;
        red[warp * n4 + q] = make_float4(gw[k][4 * i], gw[k][4 * i + 1],
                                         gw[k][4 * i + 2], gw[k][4 * i + 3]);
        red[(warps + warp) * n4 + q] =
            make_float4(gb[k][4 * i], gb[k][4 * i + 1], gb[k][4 * i + 2],
                        gb[k][4 * i + 3]);
      }
    }
  }
  __syncthreads();
  for (int q = threadIdx.x; q < 2 * n4; q += blockDim.x) {
    const int which = q >= n4;
    const int c4 = q - which * n4;
    const float4* col = red + which * warps * n4 + c4;
    float4 t = col[0];
    for (int i = 1; i < warps; ++i) {
      const float4 v = col[i * n4];
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    float4* out = reinterpret_cast<float4*>(which ? part_b : part_w);
    out[(long long)blockIdx.x * n4 + c4] = t;
  }
}

// Rows of n2 <= 1024 that the vector path does not take (a row not whole
// 16-byte chunks, or an operand off 16 bytes): the same rows per warp and
// partial rows, with element loads; lane l owns the columns l + 32k.
// Shared: warps * n2 floats.
template <typename T, int V>
__global__ void ln_bwd_kernel(const T* __restrict__ dy,
                              const T* __restrict__ x,
                              const float* __restrict__ w,
                              const float* __restrict__ mean,
                              const float* __restrict__ inv,
                              T* __restrict__ dx, float* __restrict__ part_w,
                              float* __restrict__ part_b, int n1, int n2,
                              int rows_per_warp) {
  extern __shared__ float red[];  // [warp][n2]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const float fn = (float)n2;
  const int r0 = (blockIdx.x * warps + warp) * rows_per_warp;
  const int r1 = min(r0 + rows_per_warp, n1);
  float wv[V], gw[V], gb[V];
  wait_on_primary();
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = lane + 32 * k;
    wv[k] = c < n2 ? w[c] : 0.0f;
    gw[k] = 0.0f;
    gb[k] = 0.0f;
  }
  for (int row = r0; row < r1; ++row) {
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
  launch_dependents();
  // the block's partial rows: warps add in order 0, 1, ...
  float* outs[2] = {part_w + (long long)blockIdx.x * n2,
                    part_b + (long long)blockIdx.x * n2};
  for (int which = 0; which < 2; ++which) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = lane + 32 * k;
      if (c < n2) red[warp * n2 + c] = which ? gb[k] : gw[k];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n2; c += blockDim.x) {
      float s = 0.0f;
      for (int i = 0; i < warps; ++i) s += red[i * n2 + c];
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

// out[c] = sum over p of part[p][c] in a fixed order: a block of 8 warps
// takes 32 columns (blockIdx.x) of part_w -> dw or part_b -> db
// (blockIdx.y); warp i adds the partial rows i, i + 8, ..., the m-th of
// them into accumulator m % 8, so each lane has eight loads in flight; the
// accumulators are added pairwise, then warp 0 adds the 8 warps' sums in
// order.
__global__ void __launch_bounds__(kThreads)
    ln_colsum_kernel(const float* __restrict__ part_w,
                     const float* __restrict__ part_b, float* __restrict__ dw,
                     float* __restrict__ db, int parts, int n2) {
  __shared__ float red[kWarps][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* part = (blockIdx.y ? part_b : part_w) + blockIdx.x * 32 + lane;
  float* out = blockIdx.y ? db : dw;
  const int c = blockIdx.x * 32 + lane;
  const long long step = (long long)kWarps * n2;
  float acc[kSumAcc];
#pragma unroll
  for (int a = 0; a < kSumAcc; ++a) acc[a] = 0.0f;
  wait_on_primary();
  launch_dependents();
  if (c < n2) {
    const float* p = part + (long long)warp * n2;
    int m = warp;  // the partial row p points at
    for (; m + (kSumAcc - 1) * kWarps < parts;
         m += kSumAcc * kWarps, p += kSumAcc * step) {
      float v[kSumAcc];
#pragma unroll
      for (int a = 0; a < kSumAcc; ++a) v[a] = p[a * step];
#pragma unroll
      for (int a = 0; a < kSumAcc; ++a) acc[a] += v[a];
    }
#pragma unroll
    for (int a = 0; a < kSumAcc; ++a)
      if (m + a * kWarps < parts) acc[a] += p[a * step];
  }
#pragma unroll
  for (int h = kSumAcc / 2; h > 0; h >>= 1)
#pragma unroll
    for (int a = 0; a < h; ++a) acc[a] += acc[a + h];
  red[warp][lane] = acc[0];
  __syncthreads();
  if (warp == 0 && c < n2) {
    float t = red[0][lane];
    for (int i = 1; i < kWarps; ++i) t += red[i][lane];
    out[c] = t;
  }
}

// Above 48 KB of shared memory a kernel must opt in, once on each device:
// `done` holds a bit per device already set (one per instantiation).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned long long& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (done >> dev & 1ull))) return e;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && dev < 64) done |= 1ull << dev;
  return e;
}

// A launch that may start while the kernel before it on the stream
// finishes (programmatic dependent launch; the kernel waits for it)
struct Early {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = {};
  Early(dim3 grid, dim3 block, size_t bytes, cudaStream_t st) {
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// The operands and launch shape of a backward row kernel.  Each launcher
// below launches its kernel with them or, given `info`, fills it with that
// kernel's resources instead.
struct Rows {
  const void* dy;
  const void* x;
  const float* w;
  const float* mean;
  const float* inv;
  void* dx;
  float* part_w;
  float* part_b;
  int n1, n2, warps, rows_per_warp, blocks;
  cudaStream_t st;
};

// out = {resident blocks per SM, threads, dynamic shared bytes, registers
// a thread, local (spill) bytes a thread} of one kernel
template <typename K>
cudaError_t kernel_info(K kernel, int threads, size_t bytes, int* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[1] = threads;
  out[2] = (int)bytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       bytes);
}

// The operands and launch shape of the forward: `blocks` blocks of
// `warps` warps, each warp (or, for 1024 < n2 <= 8192, each block) over
// `rows_per_group` consecutive rows.  The launcher launches the kernel for
// the shape or, given `info`, fills it with that kernel's resources.
struct Fwd {
  const void* x;
  const float* w;
  const float* b;
  void* y;
  float* mean;
  float* inv;
  int n1, n2, warps, rows_per_group, blocks;
  float eps;
  cudaStream_t st;
};

template <typename T, typename K>
cudaError_t launch_fwd(K kern, const Fwd& a, int* info) {
  if (info) return kernel_info(kern, a.warps * 32, 0, info);
  const Early early(dim3(a.blocks), dim3(a.warps * 32), 0, a.st);
  return cudaLaunchKernelEx(&early.cfg, kern, static_cast<const T*>(a.x),
                            a.w, a.b, static_cast<T*>(a.y), a.mean, a.inv,
                            a.n1, a.n2, a.rows_per_group, a.eps);
}

// the register kernel with vc chunks a thread (rounded up to one built)
template <typename T, bool VEC, bool WIDE>
cudaError_t fwd_rows(int vc, const Fwd& a, int* info) {
  auto go = [&](auto c) {
    return launch_fwd<T>(ln_fwd_kernel<T, decltype(c)::value, VEC, WIDE>, a,
                         info);
  };
  if (vc <= 1) return go(std::integral_constant<int, 1>());
  if (vc <= 2) return go(std::integral_constant<int, 2>());
  if (vc <= 3) return go(std::integral_constant<int, 3>());
  if (vc <= 4) return go(std::integral_constant<int, 4>());
  if constexpr (sizeof(T) == 4) {
    if (vc <= 6) return go(std::integral_constant<int, 6>());
    if (vc <= 8) return go(std::integral_constant<int, 8>());
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t fwd(const Fwd& a, int vector, int* info) {
  if (a.n2 > kMaxWideCols)
    return launch_fwd<T>(ln_fwd_stream_kernel<T>, a, info);
  constexpr int E = 16 / (int)sizeof(T);
  const int nc = (a.n2 + E - 1) / E;
  if (a.n2 > kMaxRegCols) {
    const int vc = (nc + kWideThreads - 1) / kWideThreads;
    return vector ? fwd_rows<T, true, true>(vc, a, info)
                  : fwd_rows<T, false, true>(vc, a, info);
  }
  const int vc = (nc + 31) / 32;
  return vector ? fwd_rows<T, true, false>(vc, a, info)
                : fwd_rows<T, false, false>(vc, a, info);
}

cudaError_t fwd_any(const Fwd& a, int vector, int dtype, int* info) {
  switch (dtype) {
    case 0: return fwd<float>(a, vector, info);
    case 1: return fwd<__nv_bfloat16>(a, vector, info);
    case 2: return fwd<__half>(a, vector, info);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename K>
cudaError_t launch_rows(K kern, size_t most, unsigned long long& done,
                        size_t bytes, const Rows& a, int* info) {
  const cudaError_t e = allow_smem(kern, most, done);
  if (e != cudaSuccess) return e;
  if (info) return kernel_info(kern, a.warps * 32, bytes, info);
  const Early early(dim3(a.blocks), dim3(a.warps * 32), bytes, a.st);
  return cudaLaunchKernelEx(
      &early.cfg, kern, static_cast<const T*>(a.dy),
      static_cast<const T*>(a.x), a.w, a.mean, a.inv, static_cast<T*>(a.dx),
      a.part_w, a.part_b, a.n1, a.n2, a.rows_per_warp);
}

template <typename T, int VC>
cudaError_t vec_rows(const Rows& a, int* info) {
  static unsigned long long done = 0;
  return launch_rows<T>(ln_bwd_vec_kernel<T, VC>,
                        (size_t)4 * kBwdMaxWarps * 32 * VC * 16, done,
                        (size_t)4 * a.warps * a.n2 * sizeof(T), a, info);
}

template <typename T, int V>
cudaError_t elem_rows(const Rows& a, int* info) {
  static unsigned long long done = 0;
  return launch_rows<T>(ln_bwd_kernel<T, V>,
                        (size_t)kBwdMaxWarps * 32 * V * sizeof(float), done,
                        (size_t)a.warps * a.n2 * sizeof(float), a, info);
}

template <typename T>
cudaError_t stream_rows(const Rows& a, int* info) {
  auto kern = ln_bwd_stream_kernel<T>;
  if (info) return kernel_info(kern, kThreads, 0, info);
  kern<<<a.blocks, kThreads, 0, a.st>>>(
      static_cast<const T*>(a.dy), static_cast<const T*>(a.x), a.w, a.mean,
      a.inv, static_cast<T*>(a.dx), a.part_w, a.part_b, a.n1, a.n2);
  return cudaGetLastError();
}

// the row kernel for the shape: 16-byte chunks a lane (VC) on the vector
// path, values a lane (V) on the element path, streamed above 1024
template <typename T>
cudaError_t rows(const Rows& a, int vector, int* info) {
  if (a.n2 > kMaxRegCols) return stream_rows<T>(a, info);
  if (vector) {
    const int vc = (a.n2 * (int)sizeof(T) / 16 + 31) / 32;
    if (vc <= 1) return vec_rows<T, 1>(a, info);
    if (vc <= 2) return vec_rows<T, 2>(a, info);
    if (vc <= 3) return vec_rows<T, 3>(a, info);
    if (vc <= 4) return vec_rows<T, 4>(a, info);
    if constexpr (sizeof(T) == 4) {
      if (vc <= 6) return vec_rows<T, 6>(a, info);
      return vec_rows<T, 8>(a, info);
    }
    return cudaErrorInvalidValue;
  }
  if (a.n2 <= 32) return elem_rows<T, 1>(a, info);
  if (a.n2 <= 64) return elem_rows<T, 2>(a, info);
  if (a.n2 <= 128) return elem_rows<T, 4>(a, info);
  if (a.n2 <= 256) return elem_rows<T, 8>(a, info);
  if (a.n2 <= 512) return elem_rows<T, 16>(a, info);
  if (a.n2 <= 768) return elem_rows<T, 24>(a, info);
  return elem_rows<T, 32>(a, info);
}

cudaError_t rows_any(const Rows& a, int vector, int dtype, int* info) {
  switch (dtype) {
    case 0: return rows<float>(a, vector, info);
    case 1: return rows<__nv_bfloat16>(a, vector, info);
    case 2: return rows<__half>(a, vector, info);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// x, y: (n1, n2) contiguous; w, b: (n2,) fp32; mean, inv: (n1,) fp32.
// `blocks` blocks of `warps` warps; each warp (n2 <= 1024, or above 8192)
// or each block (1024 < n2 <= 8192, where warps must be 8) takes
// `rows_per_group` consecutive rows, and the groups must cover the n1
// rows.  `vector` picks the 16-byte loads and stores, which need n2 <=
// 8192, n2 * sizeof(T) % 16 == 0 and x, w, b and y 16-byte aligned.
int apex_ln_fwd(const void* x, const float* w, const float* b, void* y,
                float* mean, float* inv, int n1, int n2, float eps,
                int vector, int warps, int rows_per_group, int blocks,
                int dtype, cudaStream_t stream) {
  const int isz = dtype == 0 ? 4 : 2;
  const bool wide = n2 > kMaxRegCols && n2 <= kMaxWideCols;
  const long long groups = wide ? blocks : (long long)blocks * warps;
  if (dtype < 0 || dtype > 2 || warps < 1 || warps > kFwdMaxWarps ||
      rows_per_group < 1 || blocks < 1 ||
      (wide && warps * 32 != kWideThreads) ||
      groups * rows_per_group < n1)
    return (int)cudaErrorInvalidValue;
  if (vector && (n2 > kMaxWideCols || (long long)n2 * isz % 16 ||
                 !aligned16(x) || !aligned16(w) || !aligned16(b) ||
                 !aligned16(y)))
    return (int)cudaErrorInvalidValue;
  const Fwd a{x,  w,  b,     y,        mean,           inv,    n1,
              n2, warps, rows_per_group, blocks, eps, stream};
  const cudaError_t e = fwd_any(a, vector, dtype, nullptr);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers a
// thread, local (spill) bytes a thread} of the kernel apex_ln_fwd launches
// for (dtype, n2, vector, warps)
int apex_ln_fwd_kernel_info(int dtype, int n2, int vector, int warps,
                            int* out) {
  const Fwd a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 0,
              n2,      warps,   1,       1,       0.0f,    nullptr};
  return (int)fwd_any(a, vector, dtype, out);
}

// part: 2 * parts * n2 fp32, the partial rows of dw then of db: parts =
// `blocks` for n2 <= 1024 and blocks * 8 above; dw, db: (n2,) fp32.  The
// row kernel runs `blocks` blocks of `warps` warps (n2 <= 1024; 8 above),
// each warp over `rows_per_warp` consecutive rows (n2 <= 1024; a grid
// stride above); `vector` picks the 16-byte path, which needs
// n2 * sizeof(T) % 16 == 0 and dy, x, w and dx 16-byte aligned.  Then
// ln_colsum_kernel sums the partial rows, scheduled while the row kernel
// finishes.
int apex_ln_bwd(const void* dy, const void* x, const float* w,
                const float* mean, const float* inv, void* dx, float* part,
                float* dw, float* db, int n1, int n2, int vector, int warps,
                int rows_per_warp, int blocks, int dtype,
                cudaStream_t stream) {
  const int isz = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || warps < 1 || warps > kBwdMaxWarps ||
      rows_per_warp < 1 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (vector && (n2 > kMaxRegCols || (long long)n2 * isz % 16 ||
                 !aligned16(dy) || !aligned16(x) || !aligned16(w) ||
                 !aligned16(dx)))
    return (int)cudaErrorInvalidValue;
  const int parts = n2 > kMaxRegCols ? blocks * kWarps : blocks;
  const Rows a{dy, x, w, mean, inv, dx, part, part + (long long)parts * n2,
               n1, n2, warps, rows_per_warp, blocks, stream};
  cudaError_t e = rows_any(a, vector, dtype, nullptr);
  if (e != cudaSuccess) return (int)e;
  const Early early(dim3((n2 + 31) / 32, 2), dim3(kThreads), 0, stream);
  return (int)cudaLaunchKernelEx(&early.cfg, ln_colsum_kernel, a.part_w,
                                 a.part_b, dw, db, parts, n2);
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers a
// thread, local (spill) bytes a thread} of the row kernel apex_ln_bwd
// launches for (dtype, n2, vector, warps)
int apex_ln_bwd_kernel_info(int dtype, int n2, int vector, int warps,
                            int* out) {
  const Rows a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 0,       n2,      warps,   1,
               1,       nullptr};
  return (int)rows_any(a, vector, dtype, out);
}

}  // extern "C"
