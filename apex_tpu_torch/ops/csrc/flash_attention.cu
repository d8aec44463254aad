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
// Two routes, by dtype code.  bf16 and fp16 (codes 1, 2) run all three
// passes on tensor cores: flash_fwd_mma_kernel, flash_dq_mma_kernel and
// flash_dkv_mma_kernel, mma.sync.m16n8k16 with fp32 accumulators, which is
// the JAX kernels' _dot (native half operands, fp32 accumulation; P and dS
// rounded to the type before their products).  fp32 (code 0) runs fp32
// FMAs (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel): a
// tensor-core fp32 product would be TF32, which the JAX package's
// full-precision fp32 contract rules out.
//
// Bound.  At BERT-base (T = 128, D = 64) device-memory bytes; from T of a
// few hundred on, the tensor-core rate.  The FMA kernels are bound by
// their FMAs from shared memory (16 FMAs per 8 shared loads, about 1/15
// of the bf16 tensor-core peak).  The tensor-core kernels at T = 128 are
// bound by what surrounds the products: the dropout hash and expf at
// every score, and the latency of two 64-row tiles a block.  dQ does
// three products a score (S, dP, dS K), the forward two, dK/dV four.
//
// Design, FMA kernels.  The TPU grid (BH, q blocks, k blocks) runs its k
// axis in order and carries the softmax state in VMEM scratch; here that
// axis is a loop inside one block.  forward and dq: a block per (bh,
// 64-row q tile) that streams 64-row K/V tiles through shared memory;
// dk/dv: a block per (bh, 64-row k tile) that streams Q/dO tiles.  256
// threads; a 64x64 score tile gives each thread a 4x4 micro-tile at rows
// ty + 16i, columns tx + 16j.  Tiles are fp32 in shared memory with an
// odd row stride (no bank conflicts on column reads), D padded with zeros
// to 32, 64 or 128.  Causal tiles that are all masked are skipped.
//
// Design, tensor-core kernels (the section below has the details).  The
// same grids, 4 warps a block, each warp 16 rows of the block's tile.
// The resident operands (Q for the forward, Q and dO for dQ, K and V for
// dK/dV) are read into fragments once (from shared memory each tile at
// D = 128); the streamed tiles arrive as the input type by 16-byte
// cp.async into two buffers, so the next tile's copy overlaps this tile's
// math.  Scores stay in the accumulator registers: the scale, the masks
// and the hash apply there at each element's own (q, k), the forward's
// online softmax reduces a row across the quad of lanes that holds it
// (two shuffles, no barrier), and P (dS) goes from accumulator to A
// fragment in registers.  Key validity and segment ids come into shared
// memory once a tile.  No output is summed across blocks: no atomics, the
// same bits every run.
// Each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <initializer_list>

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

// -- tensor-core kernels (bf16, fp16): forward, dQ and dK/dV ----------------
//
// A block of kWarps warps per 64-row tile; warp w owns rows 16w..16w+15.
// Products are mma.sync.m16n8k16 (bf16 or fp16 operands, fp32
// accumulators); operand tiles stream through shared memory as the input
// type, 16-byte cp.async copies into two buffers, read into fragments
// with ldmatrix (row stride DP + 8 elements: the eight 16-byte rows of an
// 8x8 matrix fall in distinct banks).  A lane holds, of each 16x8
// accumulator tile, rows g and g + 8 and columns 2t and 2t + 1 (g = lane
// / 4, t = lane % 4): frag_row and frag_col are that map, and the masks,
// the hash, lse and delta are all read through them.  That layout is also
// the A operand's, so a score tile rounded to the type and packed in
// pairs is the A fragment of the next product without leaving registers.

constexpr int kWarps = 4;
constexpr int kMmaThreads = 32 * kWarps;

__device__ __forceinline__ int frag_row(int lane, int e) {
  return (lane >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int frag_col(int lane, int j, int e) {
  return 8 * j + 2 * (lane & 3) + (e & 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (4) bytes global -> shared; the bytes past src_bytes (0 or all) are 0
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b for one 16x8x16 tile, and two fp32 values rounded to T and
// packed (the first in the low half)
template <typename T>
struct Mma;
template <>
struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};
template <>
struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
};

// The A fragment of rows 16w.. of a tile (row-major, stride S), depth
// chunk c; the B fragments of two 8-column tiles (rows n0..n0+15 of a
// row-major tile read as columns: K for Q.K^T); the B fragments of two
// 8-column tiles of a row-major tile (V for P.V, read transposed).
template <int S>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const void* tile,
                                       int r0, int c, int lane) {
  ldsm4(a, static_cast<const uint16_t*>(tile) + (r0 + (lane & 15)) * S +
               c * 16 + (lane >> 4) * 8);
}
template <int S>
__device__ __forceinline__ void frag_b_rows(uint32_t (&b)[4],
                                            const void* tile, int n0, int c,
                                            int lane) {
  ldsm4(b, static_cast<const uint16_t*>(tile) +
               (n0 + (lane & 7) + (lane >> 4) * 8) * S + c * 16 +
               ((lane >> 3) & 1) * 8);
}
template <int S>
__device__ __forceinline__ void frag_b_cols(uint32_t (&b)[4],
                                            const void* tile, int k0, int n0,
                                            int lane) {
  ldsm4_t(b, static_cast<const uint16_t*>(tile) +
                 (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                 (lane >> 4) * 8);
}

// rows [r0, r0 + 64) of a (rows, D) slab into a (64, DP + 8) tile, zeros
// past `rows` and past D: 16-byte cp.async copies when `vec` (D % 8 == 0
// and the slab 16-byte aligned), else element copies
template <typename T, int DP>
__device__ __forceinline__ void load_tile_async(T* dst, const T* src, int r0,
                                                int rows, int D, int vec) {
  constexpr int S = DP + 8, CH = DP / 8;
  if (vec) {
    for (int i = threadIdx.x; i < kTile * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool in = r0 + r < rows && c < D;
      cp_async16(dst + r * S + c, in ? src + (long long)(r0 + r) * D + c : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kTile * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP;
      dst[r * S + c] = (r0 + r < rows && c < D)
                           ? src[(long long)(r0 + r) * D + c]
                           : from_f32<T>(0.0f);
    }
  }
}

// src[r0 .. r0 + 64) (4-byte values) into dst, zeros past `rows`
__device__ __forceinline__ void load_row_async(void* dst, const void* src,
                                               int r0, int rows) {
  const int i = threadIdx.x;
  if (i < kTile) {
    const bool in = r0 + i < rows;
    cp_async4(static_cast<char*>(dst) + 4 * i,
              static_cast<const char*>(src) + (in ? 4LL * (r0 + i) : 0),
              in ? 4 : 0);
  }
}

// K/V tile kt of one (T, D) slab each, its keys' validity (k < T and
// kv_mask) and segment ids, into buffer kt & 1 of the forward's and dQ's
// K/V stream; one cp.async group
template <typename T, int DP>
__device__ __forceinline__ void load_kv_tile(T* Ks, T* Vs, int* kseg_s,
                                             uint8_t* kok_s, const T* k,
                                             const T* v, int kt, int D,
                                             int vec, const Masks& mk,
                                             long long mbase) {
  constexpr int S = DP + 8;
  const int buf = kt & 1, k0 = kt * kTile;
  load_tile_async<T, DP>(Ks + buf * kTile * S, k, k0, mk.T, D, vec);
  load_tile_async<T, DP>(Vs + buf * kTile * S, v, k0, mk.T, D, vec);
  if (mk.seg) load_row_async(kseg_s + buf * kTile, mk.seg + mbase, k0, mk.T);
  if (threadIdx.x < kTile) {
    const int kp = k0 + threadIdx.x;
    kok_s[buf * kTile + threadIdx.x] =
        kp < mk.T && (!mk.kv_mask || mk.kv_mask[mbase + kp]);
  }
  cp_async_commit();
}

// A warp's accumulators (16 rows, DP columns, times `mul`) to rows
// [r0, r0 + 16) of a (rows, D) slab: staged through the warp's own rows
// of `stage` for 16-byte stores when `vec`, else element stores.
template <typename T, int DP>
__device__ __forceinline__ void store_acc(T* dst, T* stage,
                                          const float (&acc)[DP / 8][4],
                                          const float (&div)[2], int r0,
                                          int rows, int D, int vec,
                                          int lane) {
  constexpr int S = DP + 8, CH = DP / 8;
  if (vec) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        *reinterpret_cast<uint32_t*>(stage + frag_row(lane, 2 * h) * S +
                                     frag_col(lane, n, 0)) =
            Mma<T>::pack(acc[n][2 * h] / div[h], acc[n][2 * h + 1] / div[h]);
    __syncwarp();
    for (int i = lane; i < 16 * CH; i += 32) {
      const int r = i / CH, c = (i % CH) * 8;
      if (r0 + r < rows && c < D)
        *reinterpret_cast<uint4*>(dst + (long long)(r0 + r) * D + c) =
            *reinterpret_cast<const uint4*>(stage + r * S + c);
    }
  } else {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + frag_row(lane, e), c = frag_col(lane, n, e);
        if (r < rows && c < D)
          dst[(long long)r * D + c] = from_f32<T>(acc[n][e] / div[e >> 1]);
      }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int D, int vec, Masks mk) {
  constexpr int S = DP + 8;      // row stride of a tile, elements
  constexpr int NC = DP / 16;    // depth chunks of Q.K^T
  constexpr int NT = DP / 8;     // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* Qs = reinterpret_cast<T*>(smem_mma);
  T* Ks = Qs + kTile * S;                 // two buffers each
  T* Vs = Ks + 2 * kTile * S;
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kTile * S);        // [2][64]
  uint8_t* kok_s = reinterpret_cast<uint8_t*>(kseg_s + 2 * kTile);  // [2][64]

  const int T_ = mk.T;
  const int nq = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq, b = bh / mk.H;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const long long base = (long long)bh * T_ * D, mbase = (long long)b * T_;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }
  int nk = (T_ + kTile - 1) / kTile;
  if (mk.causal) nk = min(nk, q0 / kTile + 1);

  load_tile_async<T, DP>(Qs, q + base, q0, T_, D, vec);
  load_kv_tile<T, DP>(Ks, Vs, kseg_s, kok_s, k + base, v + base, 0, D, vec,
                      mk, mbase);

  // this lane's query rows (e < 2: qa, else qb) and their segment ids
  const int qa = q0 + w0 + frag_row(lane, 0), qb = qa + 8;
  int sega = 0, segb = 0;
  if (mk.seg) {
    sega = qa < T_ ? mk.seg[mbase + qa] : 0;
    segb = qb < T_ ? mk.seg[mbase + qb] : 0;
  }
  uint32_t qf[NC][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m_r[2] = {kNeg, kNeg}, l_r[2] = {0.0f, 0.0f};

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_kv_tile<T, DP>(Ks, Vs, kseg_s, kok_s, k + base, v + base, kt + 1, D,
                          vec, mk, mbase);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) frag_a<S>(qf[c], Qs, w0, c, lane);
    }
    const int buf = kt & 1, k0 = kt * kTile;
    const T* Kb = Ks + buf * kTile * S;
    const T* Vb = Vs + buf * kTile * S;
    const int* ksg = kseg_s + buf * kTile;
    const uint8_t* kok = kok_s + buf * kTile;

    // S = Q K^T, 16 x 64 a warp
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        frag_b_rows<S>(bf, Kb, np * 16, c, lane);
        Mma<T>::run(s[2 * np], qf[c], bf[0], bf[1]);
        Mma<T>::run(s[2 * np + 1], qf[c], bf[2], bf[3]);
      }
    // scale and masks at each element's own (q, k); the row max over the
    // valid entries, from kNeg
    uint32_t ok = 0;                     // bit 4j + e: s[j][e] is valid
    float mx[2] = {kNeg, kNeg};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = frag_col(lane, j, e), h = e >> 1;
        const bool val = kok[c] && (!mk.causal || (h ? qb : qa) >= k0 + c) &&
                         (!mk.seg || (h ? segb : sega) == ksg[c]);
        s[j][e] *= mk.scale;
        if (val) {
          ok |= 1u << (4 * j + e);
          mx[h] = fmaxf(mx[h], s[j][e]);
        }
      }
    // online softmax: a row's 64 columns lie in one quad of lanes
    float alpha[2], ps[2] = {0.0f, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      alpha[h] = expf(m_r[h] - m_new);
      m_r[h] = m_new;
    }
    // l from the undropped p; P V from round_T(keep ? p * inv_keep : 0),
    // packed straight into A fragments (16 keys a chunk)
    uint32_t pf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float pa[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const float p =
            (ok >> (4 * j + e) & 1u) ? expf(s[j][e] - m_r[h]) : 0.0f;
        ps[h] += p;
        pa[e] = p;
        if (mk.rate > 0.0f)
          pa[e] = (keep(mk, s0, s1, bh, h ? qb : qa, k0 + frag_col(lane, j, e))
                       ? p : 0.0f) * mk.inv_keep;
      }
      pf[j >> 1][(j & 1) * 2] = Mma<T>::pack(pa[0], pa[1]);
      pf[j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(pa[2], pa[3]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
      ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
      l_r[h] = alpha[h] * l_r[h] + ps[h];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= alpha[e >> 1];
    // O += P V
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        frag_b_cols<S>(bf, Vb, c * 16, np * 16, lane);
        Mma<T>::run(acc[2 * np], pf[c], bf[0], bf[1]);
        Mma<T>::run(acc[2 * np + 1], pf[c], bf[2], bf[3]);
      }
    __syncthreads();                     // buffer kt & 1 is free again
  }
  // o = acc / l_safe, lse = m + log(l_safe); a row with no valid key has
  // acc = 0, l = 0, so o = 0.  The warp's rows of Qs stage the stores
  // (Q's fragments are in registers).
  const float ls[2] = {l_r[0] == 0.0f ? 1.0f : l_r[0],
                       l_r[1] == 0.0f ? 1.0f : l_r[1]};
  store_acc<T, DP>(o + base, Qs + w0 * S, acc, ls, q0 + w0, T_, D, vec,
                   lane);
  if ((lane & 3) == 0) {
    if (qa < T_) lse[(long long)bh * T_ + qa] = m_r[0] + logf(ls[0]);
    if (qb < T_) lse[(long long)bh * T_ + qb] = m_r[1] + logf(ls[1]);
  }
}

// dQ: the forward's grid and K/V stream.  Per K tile and per 32 keys, S =
// Q K^T and dP = dO V^T into fp32 accumulators; p, the dropout and dS =
// round_T(p (dp - delta)) in registers at each element's own (q, k); then
// dQ += dS K with K's B fragments read transposed from the same K tile in
// shared memory, so K comes from device memory once for both products.
// Q and dO fragments stay in registers up to D = 64; at 128 they would not
// fit beside the 16 x 128 fp32 accumulator and are re-read from shared
// memory.  dQ is scaled once, at the end, as the plain version does.
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads)
flash_dq_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int D, int vec, Masks mk) {
  constexpr int S = DP + 8;
  constexpr int NC = DP / 16;          // depth chunks of Q.K^T and dO.V^T
  constexpr int NT = DP / 8;           // 8-wide column tiles of dQ
  constexpr bool kRegQ = DP <= 64;
  constexpr int KC = 32;               // keys a step
  constexpr int NK = KC / 8;           // 8-wide score tiles a step
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* Qs = reinterpret_cast<T*>(smem_mma);
  T* dOs = Qs + kTile * S;
  T* Ks = dOs + kTile * S;                // two buffers each
  T* Vs = Ks + 2 * kTile * S;
  int* kseg_s = reinterpret_cast<int*>(Vs + 2 * kTile * S);        // [2][64]
  uint8_t* kok_s = reinterpret_cast<uint8_t*>(kseg_s + 2 * kTile);  // [2][64]

  const int T_ = mk.T;
  const int nq = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nq, b = bh / mk.H;
  const int q0 = (blockIdx.x % nq) * kTile;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const long long base = (long long)bh * T_ * D, mbase = (long long)b * T_;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }
  int nk = (T_ + kTile - 1) / kTile;
  if (mk.causal) nk = min(nk, q0 / kTile + 1);

  load_tile_async<T, DP>(Qs, q + base, q0, T_, D, vec);
  load_tile_async<T, DP>(dOs, dout + base, q0, T_, D, vec);
  load_kv_tile<T, DP>(Ks, Vs, kseg_s, kok_s, k + base, v + base, 0, D, vec,
                      mk, mbase);

  // this lane's query rows (e < 2: qa, else qb): lse, delta, segment ids
  const int qa = q0 + w0 + frag_row(lane, 0), qb = qa + 8;
  const long long sbase = (long long)bh * T_;
  const float lsa = qa < T_ ? lse[sbase + qa] : 0.0f;
  const float lsb = qb < T_ ? lse[sbase + qb] : 0.0f;
  const float dla = qa < T_ ? delta[sbase + qa] : 0.0f;
  const float dlb = qb < T_ ? delta[sbase + qb] : 0.0f;
  int sega = 0, segb = 0;
  if (mk.seg) {
    sega = qa < T_ ? mk.seg[mbase + qa] : 0;
    segb = qb < T_ ? mk.seg[mbase + qb] : 0;
  }
  uint32_t qf[kRegQ ? NC : 1][4], of[kRegQ ? NC : 1][4];
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_kv_tile<T, DP>(Ks, Vs, kseg_s, kok_s, k + base, v + base, kt + 1, D,
                          vec, mk, mbase);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kRegQ && kt == 0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        frag_a<S>(qf[kRegQ ? c : 0], Qs, w0, c, lane);
        frag_a<S>(of[kRegQ ? c : 0], dOs, w0, c, lane);
      }
    }
    const int buf = kt & 1, k0 = kt * kTile;
    const T* Kb = Ks + buf * kTile * S;
    const T* Vb = Vs + buf * kTile * S;
    const int* ksg = kseg_s + buf * kTile;
    const uint8_t* kok = kok_s + buf * kTile;
#pragma unroll 1
    for (int hk = 0; hk < kTile / KC; ++hk) {
      // S = Q K^T and dP = dO V^T, 16 x KC a warp
      float st[NK][4], dpt[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t aq[4], ao[4];
        if (kRegQ) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            aq[i] = qf[kRegQ ? c : 0][i];
            ao[i] = of[kRegQ ? c : 0][i];
          }
        } else {
          frag_a<S>(aq, Qs, w0, c, lane);
          frag_a<S>(ao, dOs, w0, c, lane);
        }
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t bf[4];
          frag_b_rows<S>(bf, Kb, hk * KC + np * 16, c, lane);
          Mma<T>::run(st[2 * np], aq, bf[0], bf[1]);
          Mma<T>::run(st[2 * np + 1], aq, bf[2], bf[3]);
          frag_b_rows<S>(bf, Vb, hk * KC + np * 16, c, lane);
          Mma<T>::run(dpt[2 * np], ao, bf[0], bf[1]);
          Mma<T>::run(dpt[2 * np + 1], ao, bf[2], bf[3]);
        }
      }
      // p = valid ? exp(s scale - lse[q]) : 0; dp dropped and rescaled by
      // the hash; dS = round_T(p (dp - delta[q])) packed into A fragments
      // (16 keys a chunk)
      uint32_t sf[NK / 2][4];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hk * KC + frag_col(lane, j, e), kp = k0 + c;
          const int h = e >> 1, qp = h ? qb : qa;
          const bool val = kok[c] && (!mk.causal || qp >= kp) &&
                           (!mk.seg || (h ? segb : sega) == ksg[c]);
          const float p =
              val ? expf(st[j][e] * mk.scale - (h ? lsb : lsa)) : 0.0f;
          float d = dpt[j][e];
          if (mk.rate > 0.0f)
            d = (keep(mk, s0, s1, bh, qp, kp) ? d : 0.0f) * mk.inv_keep;
          ds[e] = p * (d - (h ? dlb : dla));
        }
        sf[j >> 1][(j & 1) * 2] = Mma<T>::pack(ds[0], ds[1]);
        sf[j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(ds[2], ds[3]);
      }
      // dQ += dS K
#pragma unroll
      for (int c = 0; c < NK / 2; ++c)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          frag_b_cols<S>(bf, Kb, hk * KC + c * 16, np * 16, lane);
          Mma<T>::run(acc[2 * np], sf[c], bf[0], bf[1]);
          Mma<T>::run(acc[2 * np + 1], sf[c], bf[2], bf[3]);
        }
    }
    __syncthreads();                     // buffer kt & 1 is free again
  }
  // dQ times scale once; the warp's own rows of Qs stage the stores
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= mk.scale;
  const float one[2] = {1.0f, 1.0f};
  store_acc<T, DP>(dq + base, Qs + w0 * S, acc, one, q0 + w0, T_, D, vec,
                   lane);
}

// Up to D = 64, registers capped so that APEX_FLASH_DKV_BLOCKS blocks
// share an SM: three (12 warps, at most 168 registers a thread, a few
// bytes of spill at D = 64) against two without the cap.  chip_smoke.py
// builds this file again with the value 1 and times both at BERT-base's
// and BERT-large's shapes.  At D = 128 shared memory holds two blocks,
// which the uncapped registers already allow: a cap could only spill.
#ifndef APEX_FLASH_DKV_BLOCKS
#define APEX_FLASH_DKV_BLOCKS 3
#endif
template <typename T, int DP>
__global__ void __launch_bounds__(kMmaThreads,
                                  DP <= 64 ? APEX_FLASH_DKV_BLOCKS : 1)
flash_dkv_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int D, int vec, Masks mk) {
  constexpr int S = DP + 8;
  constexpr int NC = DP / 16;          // depth chunks of K.Q^T and V.dO^T
  constexpr int NT = DP / 8;           // 8-wide column tiles of dK, dV
  // K and V fragments stay in registers up to D = 64; at 128 they would
  // not fit beside the two 16 x 128 fp32 accumulators, and are re-read
  // from shared memory, and the scores go 16 queries at a time
  constexpr bool kRegKV = DP <= 64;
  constexpr int QC = DP <= 64 ? 32 : 16;   // query columns a step
  constexpr int NQ = QC / 8;               // 8-wide score tiles a step
  extern __shared__ __align__(16) unsigned char smem_mma[];
  T* Ks = reinterpret_cast<T*>(smem_mma);
  T* Vs = Ks + kTile * S;
  T* Qs = Vs + kTile * S;                 // two buffers each
  T* dOs = Qs + 2 * kTile * S;
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * kTile * S);  // [2][64]
  float* del_s = lse_s + 2 * kTile;
  int* qseg_s = reinterpret_cast<int*>(del_s + 2 * kTile);

  const int T_ = mk.T;
  const int nt = (T_ + kTile - 1) / kTile;
  const int bh = blockIdx.x / nt, b = bh / mk.H;
  const int kt = blockIdx.x % nt, k0 = kt * kTile;
  const int lane = threadIdx.x & 31, w0 = (threadIdx.x >> 5) * 16;
  const long long base = (long long)bh * T_ * D, mbase = (long long)b * T_;
  uint32_t s0 = 0, s1 = 0;
  if (mk.rate > 0.0f) {
    s0 = (uint32_t)mk.seed[0];
    s1 = (uint32_t)mk.seed[1];
  }

  // Q/dO tile qt, its lse, delta and segment ids, into buffer `buf`
  auto load_q = [&](int qt, int buf) {
    const int q0 = qt * kTile;
    load_tile_async<T, DP>(Qs + buf * kTile * S, q + base, q0, T_, D, vec);
    load_tile_async<T, DP>(dOs + buf * kTile * S, dout + base, q0, T_, D,
                           vec);
    load_row_async(lse_s + buf * kTile, lse + (long long)bh * T_, q0, T_);
    load_row_async(del_s + buf * kTile, delta + (long long)bh * T_, q0, T_);
    if (mk.seg) load_row_async(qseg_s + buf * kTile, mk.seg + mbase, q0, T_);
    cp_async_commit();
  };
  // causal: q tile qt sees k tile kt only when qt >= kt
  const int qt0 = mk.causal ? kt : 0;
  load_tile_async<T, DP>(Ks, k + base, k0, T_, D, vec);
  load_tile_async<T, DP>(Vs, v + base, k0, T_, D, vec);
  load_q(qt0, 0);

  // this lane's key rows (e < 2: ka, else kb): validity and segment ids
  const int ka = k0 + w0 + frag_row(lane, 0), kb = ka + 8;
  const bool oka = ka < T_ && (!mk.kv_mask || mk.kv_mask[mbase + ka]);
  const bool okb = kb < T_ && (!mk.kv_mask || mk.kv_mask[mbase + kb]);
  int sega = 0, segb = 0;
  if (mk.seg) {
    sega = ka < T_ ? mk.seg[mbase + ka] : 0;
    segb = kb < T_ ? mk.seg[mbase + kb] : 0;
  }
  uint32_t kf[kRegKV ? NC : 1][4], vf[kRegKV ? NC : 1][4];
  float dka[NT][4], dva[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.0f;

  for (int qt = qt0; qt < nt; ++qt) {
    const int buf = (qt - qt0) & 1, q0 = qt * kTile;
    if (qt + 1 < nt) {
      load_q(qt + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kRegKV && qt == qt0) {
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        frag_a<S>(kf[kRegKV ? c : 0], Ks, w0, c, lane);
        frag_a<S>(vf[kRegKV ? c : 0], Vs, w0, c, lane);
      }
    }
    const T* Qb = Qs + buf * kTile * S;
    const T* dOb = dOs + buf * kTile * S;
    const float* lb = lse_s + buf * kTile;
    const float* db = del_s + buf * kTile;
    const int* qsg = qseg_s + buf * kTile;
#pragma unroll 1                       // unrolled, it spills
    for (int hq = 0; hq < kTile / QC; ++hq) {
      // S^T = K Q^T and dP^T = V dO^T, 16 x QC a warp
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        uint32_t ak[4], av[4];
        if (kRegKV) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ak[i] = kf[kRegKV ? c : 0][i];
            av[i] = vf[kRegKV ? c : 0][i];
          }
        } else {
          frag_a<S>(ak, Ks, w0, c, lane);
          frag_a<S>(av, Vs, w0, c, lane);
        }
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bf[4];
          frag_b_rows<S>(bf, Qb, hq * QC + np * 16, c, lane);
          Mma<T>::run(st[2 * np], ak, bf[0], bf[1]);
          Mma<T>::run(st[2 * np + 1], ak, bf[2], bf[3]);
          frag_b_rows<S>(bf, dOb, hq * QC + np * 16, c, lane);
          Mma<T>::run(dpt[2 * np], av, bf[0], bf[1]);
          Mma<T>::run(dpt[2 * np + 1], av, bf[2], bf[3]);
        }
      }
      // p^T = valid ? exp(s^T scale - lse[q]) : 0; p_acc and dp dropped
      // and rescaled by the hash; dS^T = round_T(p (dp - delta[q])); both
      // packed into A fragments (16 queries a chunk)
      uint32_t pf[NQ / 2][4], sf[NQ / 2][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        float pa[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hq * QC + frag_col(lane, j, e), qp = q0 + c;
          const int h = e >> 1, kp = h ? kb : ka;
          const bool val = (h ? okb : oka) && qp < T_ &&
                           (!mk.causal || qp >= kp) &&
                           (!mk.seg || (h ? segb : sega) == qsg[c]);
          const float p = val ? expf(st[j][e] * mk.scale - lb[c]) : 0.0f;
          float d = dpt[j][e];
          pa[e] = p;
          if (mk.rate > 0.0f) {
            const bool kk = keep(mk, s0, s1, bh, qp, kp);
            pa[e] = (kk ? p : 0.0f) * mk.inv_keep;
            d = (kk ? d : 0.0f) * mk.inv_keep;
          }
          ds[e] = p * (d - db[c]);
        }
        pf[j >> 1][(j & 1) * 2] = Mma<T>::pack(pa[0], pa[1]);
        pf[j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(pa[2], pa[3]);
        sf[j >> 1][(j & 1) * 2] = Mma<T>::pack(ds[0], ds[1]);
        sf[j >> 1][(j & 1) * 2 + 1] = Mma<T>::pack(ds[2], ds[3]);
      }
      // dV += P_acc^T dO, dK += dS^T Q
#pragma unroll
      for (int c = 0; c < NQ / 2; ++c)
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          frag_b_cols<S>(bf, dOb, hq * QC + c * 16, np * 16, lane);
          Mma<T>::run(dva[2 * np], pf[c], bf[0], bf[1]);
          Mma<T>::run(dva[2 * np + 1], pf[c], bf[2], bf[3]);
          frag_b_cols<S>(bf, Qb, hq * QC + c * 16, np * 16, lane);
          Mma<T>::run(dka[2 * np], sf[c], bf[0], bf[1]);
          Mma<T>::run(dka[2 * np + 1], sf[c], bf[2], bf[3]);
        }
    }
    __syncthreads();                     // buffer `buf` is free again
  }
  // dK times scale once, as the plain version; the warp's own rows of Ks
  // and Vs stage the stores
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] *= mk.scale;
  const float one[2] = {1.0f, 1.0f};
  store_acc<T, DP>(dk + base, Ks + w0 * S, dka, one, k0 + w0, T_, D, vec,
                   lane);
  store_acc<T, DP>(dv + base, Vs + w0 * S, dva, one, k0 + w0, T_, D, vec,
                   lane);
}

// -- launch ------------------------------------------------------------------

// threads and dynamic shared memory of each kernel
constexpr size_t tile_bytes(int DP) {
  return (size_t)kTile * (DP + 1) * sizeof(float);
}
constexpr size_t score_bytes() { return (size_t)kTile * kSS * sizeof(float); }
constexpr size_t fwd_bytes(int DP) {
  return 3 * tile_bytes(DP) + score_bytes() + 3 * kTile * sizeof(float);
}
constexpr size_t dq_bytes(int DP) {
  return 4 * tile_bytes(DP) + score_bytes() + 2 * kTile * sizeof(float);
}
constexpr size_t dkv_bytes(int DP) {
  return 4 * tile_bytes(DP) + 2 * score_bytes() + 2 * kTile * sizeof(float);
}
// Q, two K and two V tiles of 16-bit values; two buffers of key segment
// ids and validity bytes
constexpr size_t fwd_mma_bytes(int DP) {
  return 5 * (size_t)kTile * (DP + 8) * 2 + 2 * kTile * (sizeof(int) + 1);
}
// Q, dO, two K and two V tiles; two buffers of key segment ids and
// validity bytes
constexpr size_t dq_mma_bytes(int DP) {
  return 6 * (size_t)kTile * (DP + 8) * 2 + 2 * kTile * (sizeof(int) + 1);
}
// K, V, two Q and two dO tiles; two buffers of lse, delta, segment ids
constexpr size_t dkv_mma_bytes(int DP) {
  return 6 * (size_t)kTile * (DP + 8) * 2 + 6 * kTile * sizeof(float);
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

// the tensor-core kernels' 16-byte copies: D % 8 == 0 and every slab
// 16-byte aligned
inline int vec_ok(int D, std::initializer_list<const void*> ptrs) {
  if (D % 8) return 0;
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return 0;
  return 1;
}

template <typename T, int DP>
cudaError_t fwd(const void* q, const void* k, const void* v, void* o,
                float* lse, int BH, int D, const Masks& mk, cudaStream_t st) {
  const size_t bytes = fwd_bytes(DP);
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
cudaError_t fwd_mma(const void* q, const void* k, const void* v, void* o,
                    float* lse, int BH, int D, const Masks& mk,
                    cudaStream_t st) {
  const size_t bytes = fwd_mma_bytes(DP);
  auto kern = flash_fwd_mma_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nq = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nq, kMmaThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, D,
      vec_ok(D, {q, k, v, o}), mk);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dq(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dqp, int BH, int D,
               const Masks& mk, cudaStream_t st) {
  const size_t bytes = dq_bytes(DP);
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
cudaError_t dq_mma(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dqp, int BH, int D, const Masks& mk,
                   cudaStream_t st) {
  const size_t bytes = dq_mma_bytes(DP);
  auto kern = flash_dq_mma_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nq = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nq, kMmaThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dqp), D, vec_ok(D, {q, k, v, dout, dqp}), mk);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t dkv(const void* q, const void* k, const void* v, const void* dout,
                const float* lse, const float* delta, void* dkp, void* dvp,
                int BH, int D, const Masks& mk, cudaStream_t st) {
  const size_t bytes = dkv_bytes(DP);
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

template <typename T, int DP>
cudaError_t dkv_mma(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dkp, void* dvp, int BH, int D, const Masks& mk,
                    cudaStream_t st) {
  const size_t bytes = dkv_mma_bytes(DP);
  auto kern = flash_dkv_mma_kernel<T, DP>;
  static unsigned long long done = 0;
  const cudaError_t e = allow_smem(kern, bytes, done);
  if (e != cudaSuccess) return e;
  const int nt = (mk.T + kTile - 1) / kTile;
  kern<<<BH * nt, kMmaThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dkp), static_cast<T*>(dvp), D,
      vec_ok(D, {q, k, v, dout, dkp, dvp}), mk);
  return cudaGetLastError();
}

// out = {resident blocks per SM, threads, dynamic shared bytes, registers
// a thread, local (spill) bytes a thread} of one kernel
template <typename K>
cudaError_t kernel_info(K kernel, int threads, size_t bytes, int* out) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes attr;
  e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  out[1] = threads;
  out[2] = (int)bytes;
  out[3] = attr.numRegs;
  out[4] = (int)attr.localSizeBytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, kernel, threads,
                                                       bytes);
}
template <typename T, int DP>
cudaError_t info_fwd(int* out) {
  return kernel_info(flash_fwd_kernel<T, DP>, 256, fwd_bytes(DP), out);
}
template <typename T, int DP>
cudaError_t info_fwd_mma(int* out) {
  return kernel_info(flash_fwd_mma_kernel<T, DP>, kMmaThreads,
                     fwd_mma_bytes(DP), out);
}
template <typename T, int DP>
cudaError_t info_dq(int* out) {
  return kernel_info(flash_dq_kernel<T, DP>, 256, dq_bytes(DP), out);
}
template <typename T, int DP>
cudaError_t info_dq_mma(int* out) {
  return kernel_info(flash_dq_mma_kernel<T, DP>, kMmaThreads,
                     dq_mma_bytes(DP), out);
}
template <typename T, int DP>
cudaError_t info_dkv(int* out) {
  return kernel_info(flash_dkv_kernel<T, DP>, 256, dkv_bytes(DP), out);
}
template <typename T, int DP>
cudaError_t info_dkv_mma(int* out) {
  return kernel_info(flash_dkv_mma_kernel<T, DP>, kMmaThreads,
                     dkv_mma_bytes(DP), out);
}

// dtype code and padded width -> one instantiation: F32 for fp32, F16 for
// bf16 and fp16
#define APEX_FLASH_DISPATCH(F32, F16, ...)                            \
  do {                                                                \
    const int dp = D <= 32 ? 32 : (D <= 64 ? 64 : 128);               \
    if (D < 1 || D > 128) return (int)cudaErrorInvalidValue;          \
    switch (dtype * 3 + (dp == 32 ? 0 : (dp == 64 ? 1 : 2))) {        \
      case 0: return (int)F32<float, 32>(__VA_ARGS__);                \
      case 1: return (int)F32<float, 64>(__VA_ARGS__);                \
      case 2: return (int)F32<float, 128>(__VA_ARGS__);               \
      case 3: return (int)F16<__nv_bfloat16, 32>(__VA_ARGS__);        \
      case 4: return (int)F16<__nv_bfloat16, 64>(__VA_ARGS__);        \
      case 5: return (int)F16<__nv_bfloat16, 128>(__VA_ARGS__);       \
      case 6: return (int)F16<__half, 32>(__VA_ARGS__);               \
      case 7: return (int)F16<__half, 64>(__VA_ARGS__);               \
      case 8: return (int)F16<__half, 128>(__VA_ARGS__);              \
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
  APEX_FLASH_DISPATCH(fwd, fwd_mma, q, k, v, o, lse, BH, D, mk, stream);
}

int apex_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const float* lse, const float* delta,
                  void* dqp, const uint8_t* kv_mask, const int* seg,
                  const int* seed, int BH, int H, int T, int D, int causal,
                  float scale, float rate, float inv_keep, int dtype,
                  cudaStream_t stream) {
  const Masks mk = make_masks(kv_mask, seg, seed, T, H, causal, scale, rate,
                              inv_keep);
  APEX_FLASH_DISPATCH(dq, dq_mma, q, k, v, dout, lse, delta, dqp, BH, D,
                      mk, stream);
}

int apex_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dkp, void* dvp, const uint8_t* kv_mask,
                   const int* seg, const int* seed, int BH, int H, int T,
                   int D, int causal, float scale, float rate,
                   float inv_keep, int dtype, cudaStream_t stream) {
  const Masks mk = make_masks(kv_mask, seg, seed, T, H, causal, scale, rate,
                              inv_keep);
  APEX_FLASH_DISPATCH(dkv, dkv_mma, q, k, v, dout, lse, delta, dkp, dvp, BH,
                      D, mk, stream);
}

// out[5]: see kernel_info; pass 0 forward, 1 dq, 2 dk/dv
int apex_flash_kernel_info(int pass, int dtype, int D, int* out) {
  switch (pass) {
    case 0: APEX_FLASH_DISPATCH(info_fwd, info_fwd_mma, out);
    case 1: APEX_FLASH_DISPATCH(info_dq, info_dq_mma, out);
    case 2: APEX_FLASH_DISPATCH(info_dkv, info_dkv_mma, out);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
