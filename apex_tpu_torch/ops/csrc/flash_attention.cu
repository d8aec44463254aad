// Blocked (flash) attention, forward and both backward passes, with causal,
// key-padding and segment masks and in-kernel attention dropout.
//
// Replaces apex_tpu/ops/pallas_flash_attention.py: _fwd_kernel (:154),
// _dq_kernel (:293) and _dkv_kernel (:351).
//
// Operands are (BH, T, D) contiguous, BH = B*H, in fp32, bf16 or fp16
// (dtype code 0, 1, 2), D <= 128; lse and delta are (BH, T) fp32.  Per
// (q row, k column) pair:
//
//   s     = (q . k) * scale                 fp32, products exact in fp32
//   valid = k < T, q < T, [q >= k], [kv_mask[b][k]], [seg[b][q] == seg[b][k]]
//   forward   online softmax over the k tiles: m, l from the UNdropped
//             p = exp(s - m); the value sum takes p_acc = round_T(keep ?
//             p * inv_keep : 0) (P rounded to V's dtype before P.V);
//             o = acc / l_safe (l_safe = 1 where a row has no valid key,
//             so such a row is 0), lse = m + log(l_safe)
//   dq        p = exp(s - lse), dp = dO . v (dropped and rescaled like p),
//             ds = round_T(p * (dp - delta)), dq = sum_k (ds k) * scale
//   dk, dv    dv = sum_q p_acc dO,  dk = sum_q (ds q) * scale
//
// keep = u >= rate with u the counter hash of (seed words, b*H + h, q, k)
// (pallas_flash_attention.py:71-97): the same uint32 multiplies, xors and
// logical shifts as JAX's wrapping int32 ops, 31 bits made a float by
// round-to-nearest and scaled by 2^-31.  The two seed words are read from
// device memory inside the kernel, so no step waits on the host for them.
//
// Bound.  At BERT-base (T = 128, D = 64) device-memory bytes; from T of a
// few hundred on, the tensor-core rate.  This first version does its
// products with fp32 FMAs from shared memory (about 1/15 of the bf16
// tensor-core peak), so it is bound by those FMAs: wgmma / mma.sync
// tiles are later work.
//
// Design.  The TPU grid (BH, q blocks, k blocks) runs its k axis in order
// and carries the softmax state in VMEM scratch; here that axis is a loop
// inside one block.  forward and dq: a block per (bh, 64-row q tile) that
// streams 64-row K/V tiles through shared memory; dk/dv: a block per
// (bh, 64-row k tile) that streams Q/dO tiles.  Each block writes only its
// own rows, so no output is summed across blocks and there are no atomics.
// 256 threads; a 64x64 score tile gives each thread a 4x4 micro-tile at
// rows ty + 16i, columns tx + 16j.  Tiles are fp32 in shared memory with
// an odd row stride (no bank conflicts on column reads), D padded with
// zeros to 32, 64 or 128.  Causal tiles that are all masked are skipped.
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "common.cuh"

using namespace apex_tpu_torch;

namespace {

constexpr int kTile = 64;           // rows of a q tile and of a k tile
constexpr int kSS = kTile + 1;      // row stride of a score tile
constexpr float kNeg = -1e30f;      // the masked score of the JAX kernel

struct Masks {
  const uint8_t* kv_mask;   // (B, T) key validity, or null
  const int* seg;           // (B, T) segment ids, or null
  const int* seed;          // two int32 words, or null when rate == 0
  int T, H;
  int causal;
  float scale, rate, inv_keep;
};

__device__ __forceinline__ float keep_unit(uint32_t s0, uint32_t s1,
                                           uint32_t bh, uint32_t q,
                                           uint32_t k) {
  uint32_t h = (q * 0x9E3779B9u) ^ (k * 0x85EBCA77u) ^ (bh * 0xC2B2AE3Du) ^ s0;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= s1;
  h ^= h >> 16;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return __int2float_rn((int)(h & 0x7FFFFFFFu)) * 4.656612873077393e-10f;
}

__device__ __forceinline__ bool valid_pair(const Masks& m, int b, int q,
                                           int k) {
  if (q >= m.T || k >= m.T) return false;
  if (m.causal && q < k) return false;
  const long long o = (long long)b * m.T;
  if (m.kv_mask && !m.kv_mask[o + k]) return false;
  if (m.seg && m.seg[o + q] != m.seg[o + k]) return false;
  return true;
}

__device__ __forceinline__ bool keep(const Masks& m, uint32_t s0, uint32_t s1,
                                     int bh, int q, int k) {
  return keep_unit(s0, s1, (uint32_t)bh, (uint32_t)q, (uint32_t)k) >= m.rate;
}

// rows [r0, r0 + 64) of a (T, D) slab into a (64, DP) fp32 tile, zeros past
// T and past D
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int D) {
  constexpr int DS = DP + 1;
  for (int i = threadIdx.x; i < kTile * DP; i += blockDim.x) {
    const int r = i / DP, c = i % DP;
    dst[r * DS + c] =
        (r0 + r < rows && c < D) ? to_f32(src[(long long)(r0 + r) * D + c])
                                 : 0.0f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int rows) {
  for (int i = threadIdx.x; i < kTile; i += blockDim.x)
    dst[i] = r0 + i < rows ? src[r0 + i] : 0.0f;
}

// acc[i][j] = sum_d A[ty+16i][d] * B[tx+16j][d] over the padded width
template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4], const float* A,
                                         const float* B, int ty, int tx) {
  constexpr int DS = DP + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < DP; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * DS + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * DS + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = __fmaf_rn(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_r P[r][row_i] (transposed) or P[row_i][r] times
// X[r][tx+16j]; rows row_i = ty + 16i
template <int DP, bool kTransP>
__device__ __forceinline__ void pv_tile(float (&acc)[4][DP / 16],
                                        const float* P, const float* X,
                                        int ty, int tx) {
  constexpr int DS = DP + 1;
  constexpr int NJ = DP / 16;
#pragma unroll 4
  for (int r = 0; r < kTile; ++r) {
    float p[4], x[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      p[i] = kTransP ? P[r * kSS + ty + 16 * i] : P[(ty + 16 * i) * kSS + r];
#pragma unroll
    for (int j = 0; j < NJ; ++j) x[j] = X[r * DS + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[i][j] = __fmaf_rn(p[i], x[j], acc[i][j]);
  }
}

template <typename T, int DP>
__device__ __forceinline__ void store_tile(T* dst,
                                           const float (&acc)[4][DP / 16],
                                           int r0, int rows, int D, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int c = tx + 16 * j;
      if (c < D) dst[(long long)r * D + c] = from_f32<T>(acc[i][j]);
    }
  }
}

// -- forward -----------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(256)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int D, Masks mk) {
  constexpr int DS = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * DS;
  float* Vs = Ks + kTile * DS;
  float* Ss = Vs + kTile * DS;
  float* m_s = Ss + kTile * kSS;
  float* l_s = m_s + kTile;
  float* a_s = l_s + kTile;

  const int T_ = mk.T;
  const int nq = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq, b = bh / mk.H;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long base = (long long)bh * T_ * D;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }

  load_tile<T, DP>(Qs, q + base, q0, T_, D);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    m_s[i] = kNeg;
    l_s[i] = 0.0f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  int nk = (T_ + kTile - 1) / kTile;
  if (mk.causal) nk = min(nk, q0 / kTile + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();                       // the last tile's reads are done
    load_tile<T, DP>(Ks, k + base, k0, T_, D);
    load_tile<T, DP>(Vs, v + base, k0, T_, D);
    __syncthreads();
    float s[4][4];
    dot_tile<DP>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        // a masked pair is -inf here, kNeg in the row max (as in JAX)
        Ss[r * kSS + c] = valid_pair(mk, b, q0 + r, k0 + c)
                              ? s[i][j] * mk.scale : -INFINITY;
      }
    __syncthreads();
    // online softmax: warp w owns rows 8w..8w+7, a lane columns lane, +32
    for (int rr = 0; rr < kTile / 8; ++rr) {
      const int r = warp * (kTile / 8) + rr;
      float* row = Ss + r * kSS;
      const float x0 = row[lane], x1 = row[lane + 32];
      const bool v0 = x0 != -INFINITY, v1 = x1 != -INFINITY;
      float mx = fmaxf(v0 ? x0 : kNeg, v1 ? x1 : kNeg);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(m_prev - m_new);
      const float p0 = v0 ? expf(x0 - m_new) : 0.0f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.0f;
      float ps = p0 + p1;
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      float pa0 = p0, pa1 = p1;
      if (mk.rate > 0.0f) {
        pa0 = (keep(mk, s0, s1, bh, q0 + r, k0 + lane) ? p0 : 0.0f) *
              mk.inv_keep;
        pa1 = (keep(mk, s0, s1, bh, q0 + r, k0 + lane + 32) ? p1 : 0.0f) *
              mk.inv_keep;
      }
      row[lane] = round_to<T>(pa0);
      row[lane + 32] = round_to<T>(pa1);
      __syncwarp();
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + ps;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= al;
    }
    pv_tile<DP, false>(acc, Ss, Vs, ty, tx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = l_s[ty + 16 * i];
    const float l_safe = l == 0.0f ? 1.0f : l;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] / l_safe;
  }
  store_tile<T, DP>(o + base, acc, q0, T_, D, ty, tx);
  for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
    if (q0 + i < T_) {
      const float l = l_s[i];
      lse[(long long)bh * T_ + q0 + i] = m_s[i] + logf(l == 0.0f ? 1.0f : l);
    }
  }
}

// -- dq ----------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(256)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int D,
                Masks mk) {
  constexpr int DS = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTile * DS;
  float* Ks = dOs + kTile * DS;
  float* Vs = Ks + kTile * DS;
  float* Ss = Vs + kTile * DS;
  float* lse_s = Ss + kTile * kSS;
  float* del_s = lse_s + kTile;

  const int T_ = mk.T;
  const int nq = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq, b = bh / mk.H;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long base = (long long)bh * T_ * D;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }

  load_tile<T, DP>(Qs, q + base, q0, T_, D);
  load_tile<T, DP>(dOs, dout + base, q0, T_, D);
  load_rows(lse_s, lse + (long long)bh * T_, q0, T_);
  load_rows(del_s, delta + (long long)bh * T_, q0, T_);
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.0f;

  int nk = (T_ + kTile - 1) / kTile;
  if (mk.causal) nk = min(nk, q0 / kTile + 1);
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * kTile;
    __syncthreads();
    load_tile<T, DP>(Ks, k + base, k0, T_, D);
    load_tile<T, DP>(Vs, v + base, k0, T_, D);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DP>(s, Qs, Ks, ty, tx);
    dot_tile<DP>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const float p = valid_pair(mk, b, qp, kp)
                            ? expf(s[i][j] * mk.scale - lse_s[r]) : 0.0f;
        float d = dp[i][j];
        if (mk.rate > 0.0f)
          d = (keep(mk, s0, s1, bh, qp, kp) ? d : 0.0f) * mk.inv_keep;
        Ss[r * kSS + c] = round_to<T>(p * (d - del_s[r]));
      }
    __syncthreads();
    float part[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[i][j] = 0.0f;
    pv_tile<DP, false>(part, Ss, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] += part[i][j] * mk.scale;
  }
  store_tile<T, DP>(dq + base, acc, q0, T_, D, ty, tx);
}

// -- dk, dv ------------------------------------------------------------------

template <typename T, int DP>
__global__ void __launch_bounds__(256)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int D, Masks mk) {
  constexpr int DS = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * DS;
  float* Qs = Vs + kTile * DS;
  float* dOs = Qs + kTile * DS;
  float* Ps = dOs + kTile * DS;         // [q][k]
  float* dSs = Ps + kTile * kSS;        // [q][k]
  float* lse_s = dSs + kTile * kSS;
  float* del_s = lse_s + kTile;

  const int T_ = mk.T;
  const int nt = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nt, b = bh / mk.H;
  const int kt = blockIdx.x % nt, k0 = kt * kTile;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long base = (long long)bh * T_ * D;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }

  load_tile<T, DP>(Ks, k + base, k0, T_, D);
  load_tile<T, DP>(Vs, v + base, k0, T_, D);
  float acc_k[4][NJ], acc_v[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  // causal: q tile qt sees k tile kt only when qt >= kt
  for (int qt = mk.causal ? kt : 0; qt < nt; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();
    load_tile<T, DP>(Qs, q + base, q0, T_, D);
    load_tile<T, DP>(dOs, dout + base, q0, T_, D);
    load_rows(lse_s, lse + (long long)bh * T_, q0, T_);
    load_rows(del_s, delta + (long long)bh * T_, q0, T_);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<DP>(s, Qs, Ks, ty, tx);      // rows q, columns k
    dot_tile<DP>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        const int qp = q0 + r, kp = k0 + c;
        const float p = valid_pair(mk, b, qp, kp)
                            ? expf(s[i][j] * mk.scale - lse_s[r]) : 0.0f;
        float pa = p, d = dp[i][j];
        if (mk.rate > 0.0f) {
          const bool kk = keep(mk, s0, s1, bh, qp, kp);
          pa = (kk ? p : 0.0f) * mk.inv_keep;
          d = (kk ? d : 0.0f) * mk.inv_keep;
        }
        Ps[r * kSS + c] = round_to<T>(pa);
        dSs[r * kSS + c] = round_to<T>(p * (d - del_s[r]));
      }
    __syncthreads();
    float part[4][NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) part[i][j] = 0.0f;
    pv_tile<DP, true>(acc_v, Ps, dOs, ty, tx);     // rows k
    pv_tile<DP, true>(part, dSs, Qs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc_k[i][j] += part[i][j] * mk.scale;
  }
  store_tile<T, DP>(dk + base, acc_k, k0, T_, D, ty, tx);
  store_tile<T, DP>(dv + base, acc_v, k0, T_, D, ty, tx);
}

// -- launch ------------------------------------------------------------------

constexpr size_t tile_bytes(int DP) {
  return (size_t)kTile * (DP + 1) * sizeof(float);
}
constexpr size_t score_bytes() { return (size_t)kTile * kSS * sizeof(float); }

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

template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, int D, const Masks& mk, cudaStream_t st) {
  const size_t bytes = 3 * tile_bytes(DP) + score_bytes() +
                       3 * kTile * sizeof(float);
  auto kern = flash_fwd_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nq = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nq, 256, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, D, mk);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dqp, int BH, int D,
               const Masks& mk, cudaStream_t st) {
  const size_t bytes = 4 * tile_bytes(DP) + score_bytes() +
                       2 * kTile * sizeof(float);
  auto kern = flash_dq_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nq = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nq, 256, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqp), D, mk);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dkp, void* dvp,
                int BH, int D, const Masks& mk, cudaStream_t st) {
  const size_t bytes = 4 * tile_bytes(DP) + 2 * score_bytes() +
                       2 * kTile * sizeof(float);
  auto kern = flash_dkv_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nt = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nt, 256, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dkp), static_cast<T*>(dvp), D, mk);
  return cudaGetLastError();
}

// dtype code and padded width -> one instantiation of `F`
#define APEX_FLASH_DISPATCH(F, ...)                                   \
  do {                                                                \
    const int dp = D <= 32 ? 32 : (D <= 64 ? 64 : 128);               \
    if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;          \
    switch (dtype * 3 + (dp == 32 ? 0 : (dp == 64 ? 1 : 2))) {        \
      case 0: return (int)F<float, 32>(__VA_ARGS__);                  \
      case 1: return (int)F<float, 64>(__VA_ARGS__);                  \
      case 2: return (int)F<float, 128>(__VA_ARGS__);                 \
      case 3: return (int)F<__nv_bfloat16, 32>(__VA_ARGS__);          \
      case 4: return (int)F<__nv_bfloat16, 64>(__VA_ARGS__);          \
      case 5: return (int)F<__nv_bfloat16, 128>(__VA_ARGS__);         \
      case 6: return (int)F<__half, 32>(__VA_ARGS__);                 \
      case 7: return (int)F<__half, 64>(__VA_ARGS__);                 \
      case 8: return (int)F<__half, 128>(__VA_ARGS__);                \
      default: return (int)cudaErrorInvalidValue;                     \
    }                                                                 \
  } while (0)

Masks make_masks(const uint8_t* kv_mask, const int* seg, const int* seed,
                 int T, int H, int causal, float scale, float rate,
                 float inv_keep) {
  Masks m;
  m.kv_mask = kv_mask;
  m.seg = seg;
  m.seed = seed;
  m.T = T;
  m.H = H;
  m.causal = causal;
  m.scale = scale;
  m.rate = rate;
  m.inv_keep = inv_keep;
  return m;
}

}  // namespace

extern "C" {

// q, k, v, o: (BH, T, D); lse: (BH, T) fp32; kv_mask (B, T) uint8, seg
// (B, T) int32 and seed (2,) int32 may be null (seed only when rate == 0).
int apex_flash_fwd(const void* q, const void* k, const void* v, void* o,
                   float* lse, const uint8_t* kv_mask, const int* seg,
                   const int* seed, int BH, int H, int T, int D, int causal,
                   float scale, float rate, float inv_keep, int dtype,
                   cudaStream_t stream) {
  const Masks mk = make_masks(kv_mask, seg, seed, T, H, causal, scale, rate,
                              inv_keep);
  APEX_FLASH_DISPATCH(fwd, q, k, v, o, lse, BH, D, mk, stream);
}

int apex_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dqp, const uint8_t* kv_mask, const int* seg,
                  const int* seed, int BH, int H, int T, int D, int causal,
                  float scale, float rate, float inv_keep, int dtype,
                  cudaStream_t stream) {
  const Masks mk = make_masks(kv_mask, seg, seed, T, H, causal, scale, rate,
                              inv_keep);
  APEX_FLASH_DISPATCH(dq, q, k, v, dout, lse, delta, dqp, BH, D, mk, stream);
}

int apex_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dkp, void* dvp, const uint8_t* kv_mask,
                   const int* seg, const int* seed, int BH, int H, int T,
                   int D, int causal, float scale, float rate,
                   float inv_keep, int dtype, cudaStream_t stream) {
  const Masks mk = make_masks(kv_mask, seg, seed, T, H, causal, scale, rate,
                              inv_keep);
  APEX_FLASH_DISPATCH(dkv, q, k, v, dout, lse, delta, dkp, dvp, BH, D, mk,
                      stream);
}

}  // extern "C"
