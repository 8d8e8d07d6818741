// Causal flash attention, forward and backward (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/flash_attention.py: the forward kernel
// `_fwd_kernel` (pallas_call at :231) and the backward's two kernels
// `_dq_kernel` (:446) and `_dkv_kernel` (:482).  Same contract: q (B, Hq,
// T, D), k/v (B, Hkv, T, D) with Hq % Hkv == 0 (query head h reads kv head
// h / (Hq / Hkv)); query t attends keys j <= t, and j > t - window when a
// window is set.  Score order: q.k * scale, then + slope_h * (j - t) (ALiBi),
// then the mask with the finite -1e30.  fp32 or bf16 in, fp32 accumulation.
// The forward writes the output in q's dtype and the fp32 logsumexp per row;
// the backward recomputes the probabilities from it.  delta = rowsum(dO * O)
// is computed by the dq kernel from the forward's output and written to a
// (B, Hq, T) fp32 scratch that the dkv kernel, launched after it on the
// same stream, reads.
// Hash dropout (rate > 0): the keep mask is the JAX package's lowbias32-style
// mixer of (query position, key position, seed + (b * Hq + h) * 0x632BE5A7)
// in uint32 arithmetic, bit for bit; the row sum l counts the probabilities
// before dropout and only the P.V and dP terms drop and rescale.
// Rounding points mirror the Pallas kernels: p (after dropout) is rounded to
// v's dtype before P.V, dS to k's dtype before dS.K and to q's dtype before
// dS^T.Q, p~ to dO's dtype before p~^T.dO.
//
// What bounds it on an H100: at GPT-2 training shapes (B 8, 12 heads,
// T 1024, D 64) the forward does 4·D flops per attended (query, key) pair
// and the backward 10·D, on 50-150 MB of operands: operations, not bytes,
// bound it, so the products must run on wgmma, fed without stalls.  What
// the design does about it: every block loops over its key (forward, dq) or
// query (dkv) tiles itself, carrying the softmax state or the dQ / dK / dV
// sums in registers, so the (T, T) score matrix never reaches device
// memory; the causal and window limits are the loop bounds, so fully masked
// tiles are never read; the dq kernel owns query rows and streams K/V, the
// dkv kernel owns key rows and streams Q/dO and sums the query heads of its
// GQA group itself, so no atomics are needed and the result is
// deterministic.  The longest walks (late queries in the forward and dq
// kernels, early keys in the dkv kernel) are scheduled first.  bf16 at
// D = 64 or 128 (GPT-2's case) runs the Hopper kernels of the second half
// of this file: on a persistent grid, a producer warpgroup keeps TMA loads
// of the streamed tiles in flight in a three-stage ring while two consumer
// warpgroups run their products on wgmma (hopper.cuh).  fp32,
// which the JAX package computes at full precision (no TF32), and D = 256
// run fp32 FMAs from shared memory, 16 outputs per thread.
//
// FMA layout: 256 threads as 16 x 16 (ty, tx).  A thread owns rows ty + 16 i
// and, for score tiles, the 64-wide columns tx + 16 j, or, for output
// accumulators, the features tx + 16 c.  Row statistics of the online
// softmax are reduced over the 16 tx lanes of a half-warp with shuffles and
// live in registers.  Shared-memory strides: operands read one row per
// half-warp (broadcast) are padded by 16 floats, operands read one row per
// lane by 1 float, so neither read conflicts.
//
// Plain C interface for ctypes; each entry returns a cudaError_t (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // tx extent: threads along columns
constexpr int kTile = 64;   // streamed tile (keys in fwd/dq, queries in dkv)
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;       // forward output (backward input)
  const void* dout;
  const float* lse;    // (B, Hq, T) forward logsumexp (backward input)
  float* delta;        // (B, Hq, T) rowsum(dO * O): the dq kernel writes it,
                       // the dkv kernel reads it
  const int* seed;     // dropout seed (device int32), or null
  const float* slopes; // (Hq,) ALiBi slopes, or null
  void* out;           // forward output (B, Hq, T, D)
  float* lse_out;      // forward logsumexp (B, Hq, T)
  void* dq;            // (B, Hq, T, D)
  void* dk;            // (B, Hkv, T, D)
  void* dv;
  int hq, hkv, t, group;
  int window;          // 0: no window
  float scale;
  int dropout;         // 0: no dropout
  uint32_t keep_below; // dropout keeps a pair iff its hash < keep_below
  float drop_scale;    // 1 / (1 - rate), rounded to fp32 once
  int batch;           // B (the persistent grids' work items)
};

__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// rows x D tile of a (., D) row-major operand into shared memory as fp32
// with row stride ld; rows at or past `valid` are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int rows, int valid) {
  for (int c = threadIdx.x; c < rows * D / 8; c += kThreads) {
    const int r = (c * 8) / D;
    const int d = (c * 8) % D;
    float x[8];
    if (r < valid) {
      load8(src + static_cast<size_t>(r) * D + d, x);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[r * ld + d + i] = x[i];
  }
}

__device__ __forceinline__ bool attends(int key, int pos, int window) {
  return key <= pos && (window <= 0 || key > pos - window);
}

// The JAX package's _keep_mask, in uint32 arithmetic.
__device__ __forceinline__ bool keep(int pos, int key, uint32_t seed,
                                     uint32_t keep_below) {
  uint32_t x = (static_cast<uint32_t>(pos) * 0x9E3779B1u) ^
               (static_cast<uint32_t>(key) * 0x85EBCA77u) ^
               (seed * 0xC2B2AE3Du);
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x < keep_below;
}

__device__ __forceinline__ uint32_t head_seed(const Params& p, int b, int h) {
  return p.dropout ? static_cast<uint32_t>(p.seed[0]) +
                         static_cast<uint32_t>(b * p.hq + h) * 0x632BE5A7u
                   : 0u;
}

// Reduce over the 16 tx lanes of a half-warp.
__device__ __forceinline__ float lanes_max(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float lanes_sum(float x) {
#pragma unroll
  for (int off = kLanes / 2; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Query rows per block: 64, or 32 at D = 256 to bound registers and
// shared memory.
template <int D>
constexpr int rows_per_block() { return D == 256 ? 32 : 64; }

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D, int BM>
constexpr size_t fwd_smem_floats() {
  return BM * (D + 16) + kTile * (D + 1) + kTile * D + BM * (kTile + 16);
}

template <typename E, int D, int BM>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int RM = BM / kLanes;     // rows per thread
  constexpr int CN = kTile / kLanes;  // score columns per thread
  constexpr int CD = D / kLanes;      // output features per thread
  constexpr int QS = D + 16, KS = D + 1, PS = kTile + 16;
  extern __shared__ float smem[];
  float* q_s = smem;              // BM x QS
  float* k_s = q_s + BM * QS;     // kTile x KS
  float* v_s = k_s + kTile * KS;  // kTile x D
  float* p_s = v_s + kTile * D;   // BM x PS

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;  // late rows first
  const int mv = min(BM, T - m0);
  const size_t bh = static_cast<size_t>(b) * p.hq + h;
  const size_t bhk = static_cast<size_t>(b) * p.hkv + h / p.group;
  const E* q = static_cast<const E*>(p.q) + (bh * T + m0) * D;
  const E* k = static_cast<const E*>(p.k) + bhk * T * D;
  const E* v = static_cast<const E*>(p.v) + bhk * T * D;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const uint32_t seed = head_seed(p, b, h);

  load_tile<E, D>(q_s, QS, q, BM, mv);
  float acc[RM][CD];
  float m_i[RM], l_i[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = m0 + mv;  // exclusive: the last row's own key
  const int kv_begin = p.window > 0 ? max(0, m0 - p.window + 1) : 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    const int nv = min(kTile, kv_end - j0);
    __syncthreads();  // the previous tile's P.V is done with v_s and p_s
    load_tile<E, D>(k_s, KS, k + static_cast<size_t>(j0) * D, kTile, nv);
    load_tile<E, D>(v_s, D, v + static_cast<size_t>(j0) * D, kTile, nv);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qd[RM], kd[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) qd[i] = q_s[(ty + kLanes * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CN; ++j) kd[j] = k_s[(tx + kLanes * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + kLanes * i;
      const int pos = m0 + r;
      bool att[CN];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int n = tx + kLanes * j;
        const int key = j0 + n;
        float x = s[i][j] * p.scale;
        if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
        att[j] = n < nv && r < mv && attends(key, pos, p.window);
        s[i][j] = att[j] ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], lanes_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int n = tx + kLanes * j;
        // -1e30 is finite: masked pairs get p = 0 explicitly
        const float pj = att[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += pj;
        float pa = pj;
        if (p.dropout)
          pa = keep(pos, j0 + n, seed, p.keep_below) ? pj * p.drop_scale : 0.f;
        p_s[r * PS + n] = round_to<E>(pa);
      }
      sum = lanes_sum(sum);
      const float alpha = expf(m_i[i] - m_new);
      m_i[i] = m_new;
      l_i[i] = l_i[i] * alpha + sum;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    for (int n = 0; n < nv; ++n) {
      float pn[RM], vn[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) pn[i] = p_s[(ty + kLanes * i) * PS + n];
#pragma unroll
      for (int c = 0; c < CD; ++c) vn[c] = v_s[n * D + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pn[i], vn[c], acc[i][c]);
    }
  }

  E* out = static_cast<E*>(p.out) + (bh * T + m0) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + kLanes * i;
    if (r >= mv) continue;
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
#pragma unroll
    for (int c = 0; c < CD; ++c)
      store(out + r * D + tx + kLanes * c, acc[i][c] / l);
    if (tx == 0) p.lse_out[bh * T + m0 + r] = m_i[i] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// backward: dQ (query rows resident, K/V streamed)
// ---------------------------------------------------------------------------

template <int D, int BM>
constexpr size_t dq_smem_floats() {
  return 2 * BM * (D + 16) + 2 * kTile * (D + 1) + BM * (kTile + 16);
}

template <typename E, int D, int BM>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Params p) {
  constexpr int RM = BM / kLanes;
  constexpr int CN = kTile / kLanes;
  constexpr int CD = D / kLanes;
  constexpr int QS = D + 16, KS = D + 1, PS = kTile + 16;
  extern __shared__ float smem[];
  float* q_s = smem;               // BM x QS
  float* do_s = q_s + BM * QS;     // BM x QS
  float* k_s = do_s + BM * QS;     // kTile x KS
  float* v_s = k_s + kTile * KS;   // kTile x KS
  float* ds_s = v_s + kTile * KS;  // BM x PS

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BM;
  const int mv = min(BM, T - m0);
  const size_t bh = static_cast<size_t>(b) * p.hq + h;
  const size_t bhk = static_cast<size_t>(b) * p.hkv + h / p.group;
  const E* k = static_cast<const E*>(p.k) + bhk * T * D;
  const E* v = static_cast<const E*>(p.v) + bhk * T * D;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const uint32_t seed = head_seed(p, b, h);

  load_tile<E, D>(q_s, QS, static_cast<const E*>(p.q) + (bh * T + m0) * D,
                  BM, mv);
  load_tile<E, D>(do_s, QS, static_cast<const E*>(p.dout) + (bh * T + m0) * D,
                  BM, mv);
  float lse[RM], delta[RM], acc[RM][CD];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + kLanes * i;
    lse[i] = r < mv ? p.lse[bh * T + m0 + r] : 0.f;
    // delta = rowsum(dO * O), over the 16 tx lanes of the row
    float part = 0.f;
    if (r < mv) {
      const size_t row = (bh * T + m0 + r) * D;
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const size_t e = row + tx + kLanes * c;
        part = fmaf(to_f32(static_cast<const E*>(p.dout)[e]),
                    to_f32(static_cast<const E*>(p.o)[e]), part);
      }
    }
    delta[i] = lanes_sum(part);
    if (r < mv && tx == 0) p.delta[bh * T + m0 + r] = delta[i];
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = m0 + mv;
  const int kv_begin = p.window > 0 ? max(0, m0 - p.window + 1) : 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    const int nv = min(kTile, kv_end - j0);
    __syncthreads();
    load_tile<E, D>(k_s, KS, k + static_cast<size_t>(j0) * D, kTile, nv);
    load_tile<E, D>(v_s, KS, v + static_cast<size_t>(j0) * D, kTile, nv);
    __syncthreads();

    float s[RM][CN], dp[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qd[RM], dod[RM], kd[CN], vd[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        qd[i] = q_s[(ty + kLanes * i) * QS + d];
        dod[i] = do_s[(ty + kLanes * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        kd[j] = k_s[(tx + kLanes * j) * KS + d];
        vd[j] = v_s[(tx + kLanes * j) * KS + d];
      }
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          s[i][j] = fmaf(qd[i], kd[j], s[i][j]);
          dp[i][j] = fmaf(dod[i], vd[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + kLanes * i;
      const int pos = m0 + r;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int n = tx + kLanes * j;
        const int key = j0 + n;
        float x = s[i][j] * p.scale;
        if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
        const bool att = n < nv && r < mv && attends(key, pos, p.window);
        const float pj = att ? expf(x - lse[i]) : 0.f;
        float dpj = dp[i][j];
        if (p.dropout)
          dpj *= keep(pos, key, seed, p.keep_below) ? p.drop_scale : 0.f;
        ds_s[r * PS + n] = round_to<E>(pj * (dpj - delta[i]) * p.scale);
      }
    }
    __syncthreads();

    for (int n = 0; n < nv; ++n) {
      float dsn[RM], kn[CD];
#pragma unroll
      for (int i = 0; i < RM; ++i) dsn[i] = ds_s[(ty + kLanes * i) * PS + n];
#pragma unroll
      for (int c = 0; c < CD; ++c) kn[c] = k_s[n * KS + tx + kLanes * c];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(dsn[i], kn[c], acc[i][c]);
    }
  }

  E* dq = static_cast<E*>(p.dq) + (bh * T + m0) * D;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = ty + kLanes * i;
    if (r >= mv) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) store(dq + r * D + tx + kLanes * c, acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// backward: dK, dV (key rows resident, Q/dO streamed, GQA group summed here)
// ---------------------------------------------------------------------------

template <int D, int BK>
constexpr size_t dkv_smem_floats() {
  return 2 * BK * (D + 16) + 2 * kTile * (D + 1) + BK * (kTile + 16) +
         2 * kTile;
}

template <typename E, int D, int BK>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Params p) {
  constexpr int RK = BK / kLanes;     // key rows per thread
  constexpr int CS = kTile / kLanes;  // streamed query columns per thread
  constexpr int CD = D / kLanes;
  constexpr int KS = D + 16, QS = D + 1, PS = kTile + 16;
  extern __shared__ float smem[];
  float* k_s = smem;                   // BK x KS
  float* v_s = k_s + BK * KS;          // BK x KS
  float* q_s = v_s + BK * KS;          // kTile x QS
  float* do_s = q_s + kTile * QS;      // kTile x QS
  float* buf = do_s + kTile * QS;      // BK x PS: p~ then dS, transposed
  float* lse_s = buf + BK * PS;        // kTile
  float* delta_s = lse_s + kTile;      // kTile

  const int tx = threadIdx.x % kLanes;
  const int ty = threadIdx.x / kLanes;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int k0 = blockIdx.x * BK;  // early keys (the longest loops) first
  const int kv = min(BK, T - k0);
  const size_t bhk = static_cast<size_t>(b) * p.hkv + hk;

  load_tile<E, D>(k_s, KS, static_cast<const E*>(p.k) + (bhk * T + k0) * D,
                  BK, kv);
  load_tile<E, D>(v_s, KS, static_cast<const E*>(p.v) + (bhk * T + k0) * D,
                  BK, kv);
  float dk[RK][CD], dv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) dk[i][c] = dv[i][c] = 0.f;

  // Queries that attend any key of this tile: t >= k0, and with a window
  // t < (last key) + window.
  const int q_end =
      p.window > 0 ? min(T, k0 + kv - 1 + p.window) : T;  // exclusive
  for (int g = 0; g < p.group; ++g) {
    const int h = hk * p.group + g;
    const size_t bh = static_cast<size_t>(b) * p.hq + h;
    const E* q = static_cast<const E*>(p.q) + bh * T * D;
    const E* dout = static_cast<const E*>(p.dout) + bh * T * D;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const uint32_t seed = head_seed(p, b, h);
    for (int i0 = k0; i0 < q_end; i0 += kTile) {
      const int nq = min(kTile, q_end - i0);
      __syncthreads();  // the previous tile's dK product is done with q_s
      load_tile<E, D>(q_s, QS, q + static_cast<size_t>(i0) * D, kTile, nq);
      load_tile<E, D>(do_s, QS, dout + static_cast<size_t>(i0) * D, kTile,
                      nq);
      if (threadIdx.x < kTile) {
        const int t = threadIdx.x;
        lse_s[t] = t < nq ? p.lse[bh * T + i0 + t] : 0.f;
        delta_s[t] = t < nq ? p.delta[bh * T + i0 + t] : 0.f;
      }
      __syncthreads();

      // transposed scores: s[key][query], dp[key][query]
      float s[RK][CS], dp[RK][CS];
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kd[RK], vd[RK], qd[CS], dod[CS];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          kd[i] = k_s[(ty + kLanes * i) * KS + d];
          vd[i] = v_s[(ty + kLanes * i) * KS + d];
        }
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          qd[j] = q_s[(tx + kLanes * j) * QS + d];
          dod[j] = do_s[(tx + kLanes * j) * QS + d];
        }
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int j = 0; j < CS; ++j) {
            s[i][j] = fmaf(kd[i], qd[j], s[i][j]);
            dp[i][j] = fmaf(vd[i], dod[j], dp[i][j]);
          }
      }

      float ds[RK][CS];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        const int r = ty + kLanes * i;
        const int key = k0 + r;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const int n = tx + kLanes * j;
          const int pos = i0 + n;
          float x = s[i][j] * p.scale;
          if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
          const bool att = r < kv && n < nq && attends(key, pos, p.window);
          const float pj = att ? expf(x - lse_s[n]) : 0.f;
          float drop = 1.f;
          if (p.dropout)
            drop = keep(pos, key, seed, p.keep_below) ? p.drop_scale : 0.f;
          buf[r * PS + n] = round_to<E>(p.dropout ? pj * drop : pj);
          const float dpj = p.dropout ? dp[i][j] * drop : dp[i][j];
          ds[i][j] = pj * (dpj - delta_s[n]) * p.scale;
        }
      }
      __syncthreads();

      for (int n = 0; n < nq; ++n) {  // dV += p~^T . dO
        float pn[RK], on[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) pn[i] = buf[(ty + kLanes * i) * PS + n];
#pragma unroll
        for (int c = 0; c < CD; ++c) on[c] = do_s[n * QS + tx + kLanes * c];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) dv[i][c] = fmaf(pn[i], on[c], dv[i][c]);
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j)
          buf[(ty + kLanes * i) * PS + tx + kLanes * j] = round_to<E>(ds[i][j]);
      __syncthreads();

      for (int n = 0; n < nq; ++n) {  // dK += dS^T . Q
        float dn[RK], qn[CD];
#pragma unroll
        for (int i = 0; i < RK; ++i) dn[i] = buf[(ty + kLanes * i) * PS + n];
#pragma unroll
        for (int c = 0; c < CD; ++c) qn[c] = q_s[n * QS + tx + kLanes * c];
#pragma unroll
        for (int i = 0; i < RK; ++i)
#pragma unroll
          for (int c = 0; c < CD; ++c) dk[i][c] = fmaf(dn[i], qn[c], dk[i][c]);
      }
    }
  }

  E* dk_out = static_cast<E*>(p.dk) + (bhk * T + k0) * D;
  E* dv_out = static_cast<E*>(p.dv) + (bhk * T + k0) * D;
#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int r = ty + kLanes * i;
    if (r >= kv) continue;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      store(dk_out + r * D + tx + kLanes * c, dk[i][c]);
      store(dv_out + r * D + tx + kLanes * c, dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at D = 64 or 128: the three kernels for Hopper (TMA ring + wgmma).
//
// The grids are persistent, one block an SM, each walking work items (128
// resident rows and the tiles they stream) in the order snake_item gives.
// A block is three warpgroups.  Warpgroup 0 is the producer: one thread
// issues every TMA load (an item's resident tile once it is free, then the
// streamed tiles into a ring of kStages buffers, each completing on its
// "full" mbarrier) and waits on each buffer's "empty" mbarrier before
// reusing it; it gives most of its registers to the consumers
// (setmaxnreg).  Warpgroups 1 and 2 are consumers, 64 rows each of an
// item's 128 resident rows.
// Tiles arrive with the 128-byte swizzle as 64-column halves (hopper.cuh),
// so every product reads its operands in their stored layout: Q.K^T,
// dO.V^T, K.Q^T and V.dO^T contract over columns (both operands K-major);
// P.V, dS.K, p~^T.dO and dS^T.Q take the probabilities from registers and
// contract over the rows of V, K, dO or Q (MN-major, the transpose bit): no
// tile is ever transposed by hand.  Scores and probabilities never leave
// registers; p / dS are rounded to bf16 where the fp32 kernels round them.
//
// Each consumer overlaps one tile's elementwise work with the tensor cores:
// a tile's scores (A products: Q.K^T; Q.K^T and dO.V^T; K.Q^T and V.dO^T)
// are issued together with the previous tile's B products (P.V; dS.K;
// p~^T.dO and dS^T.Q) and waited for alone, so the softmax (or dS) of the
// next tile runs while the B products finish.  The online softmax works in
// base 2 with scale * log2(e) folded into the score (one FFMA and one ex2
// an element on the common tile); ALiBi, the per-element mask and the
// dropout hash run only where they apply: the mask on tiles that cross the
// causal diagonal, the window's edge or T, the hash when rate > 0.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kBlockRows = 128;  // resident rows: 64 per consumer warpgroup
constexpr int kStages = 3;       // streamed-tile ring
constexpr int kConsumerWarps = 8;
// 40 + 2 x 232 = 3 x 168, the launch's registers a thread (384 threads)
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 2^x (ex2.approx.ftz: relative error below 2^-22; -inf-like inputs give 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// This thread's warpgroup, read from lane 0 so the compiler knows it is the
// same across the warp: branches on it (and on what derives from it) are not
// divergent, which wgmma needs to stay asynchronous.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, threadIdx.x / kWgThreads, 0);
}

// The dynamic shared memory, rounded up to 1024 bytes (the swizzle atom).
__device__ __forceinline__ uint8_t* smem_1024(uint8_t* raw) {
  const uint32_t a = hopper::smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

// Bytes of a rows x D bf16 tile (D / 64 halves of rows x 128 bytes).
template <int D>
constexpr int tile_bytes(int rows) { return rows * D * 2; }

// K-major descriptor of k-step kk (16 columns) over rows r0.. of a tile
// of `rows` rows.
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int rows,
                                           int r0, int kk) {
  return hopper::desc_sw128(
      tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32, 16, 1024);
}

// MN-major descriptor of k-step kk (16 rows) and column half c of a tile
// of `rows` rows.
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int rows,
                                            int c, int kk) {
  return hopper::desc_sw128(tile + c * rows * 128 + kk * 16 * 128, 16, 1024);
}

// This thread's place in its consumer warpgroup's accumulators: rows
// row0 and row0 + 8 of the warpgroup's 64, columns 8 j + col0 (+1).
struct Lane {
  int row0, col0;
  __device__ Lane() {
    const int tid = threadIdx.x % kWgThreads;
    row0 = (tid / 32) * 16 + (tid % 32) / 4;
    col0 = 2 * (tid % 4);
  }
};

// The ring as a consumer sees it: the tile at ring position `it` (a
// block's streamed tiles counted across its items) sits in stage
// it % kStages and is complete once that stage's "full" barrier finishes
// phase it / kStages; one lane a warp releases it.  Every consumer warp
// waits for every tile, also one it skips, before releasing it: the
// producer refills a stage only when both consumers released its previous
// tile, so no release can count towards the wrong phase.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  __device__ void wait(int it) const {
    hopper::mbar_wait(&full[it % kStages], (it / kStages) & 1);
  }
  __device__ void release(int it) const {
    if (threadIdx.x % 32 == 0) hopper::mbar_arrive(&empty[it % kStages]);
  }
};

template <int D>
__device__ __forceinline__ void zero(float (&a)[D / 64][8][4]) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) a[c][j][i] = 0.f;
}

template <int D>
__device__ __forceinline__ void fence_all(float (&a)[D / 64][8][4]) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c) hopper::fence_regs(a[c]);
}

// bf16 stores of a warpgroup's fp32 (64 x D) accumulator rows that lie
// below T; `scale[r]` multiplies row r.
template <int D>
__device__ __forceinline__ void store_rows(bf16* base, const int (&row)[2],
                                           int T,
                                           const float (&a)[D / 64][8][4],
                                           const float (&scale)[2],
                                           int col0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<uint32_t*>(
            base + static_cast<size_t>(row[r]) * D + c * 64 + 8 * j + col0) =
            hopper::pack_bf16(a[c][j][2 * r] * scale[r],
                              a[c][j][2 * r + 1] * scale[r]);
  }
}

// Issues acc (m64 x N) = A.B^T over D columns: A rows r0 .. r0 + 63 of a
// resident kBlockRows-row tile, B the N rows of a streamed tile.
template <int D, int N>
__device__ __forceinline__ void scores(float (&acc)[N / 8][4],
                                       const uint8_t* a, int r0,
                                       const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    hopper::wgmma_ss<N>(acc, desc_k(a, kBlockRows, r0, kk),
                        desc_k(b, N, 0, kk), kk > 0);
}

// Issues acc (m64 x D) += A.B: A (m64 x K, bf16) from registers, B the K
// rows of a streamed tile.
template <int D, int K>
__device__ __forceinline__ void accumulate(float (&acc)[D / 64][8][4],
                                           const uint32_t (&a)[K / 16][4],
                                           const uint8_t* b) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
      hopper::wgmma_rs<64>(acc[c], a[kk], desc_mn(b, K, c, kk), 1);
}

// Tiles [lo, hi) of an item's n_tiles streamed key tiles (BN keys from
// kv_begin) that query rows row_lo .. row_lo + 63 attend: none past the
// last row's key, none before the first row's window.
template <int BN>
__device__ __forceinline__ void attended_tiles(const Params& p, int row_lo,
                                               int kv_begin, int n_tiles,
                                               int& lo, int& hi) {
  hi = row_lo >= p.t ? 0 : min(n_tiles, (row_lo + 63 - kv_begin) / BN + 1);
  lo = p.window > 0 ? max(0, row_lo - p.window + 1 - kv_begin) / BN : 0;
  lo = min(lo, hi);
}

template <int D, int BN>
struct FwdSmem {
  static constexpr int kQ = tile_bytes<D>(kBlockRows);
  static constexpr int kKV = tile_bytes<D>(BN);
  static constexpr int kBars = kQ + 2 * kStages * kKV;
  static constexpr int kBytes = kBars + 64 + 1024;
};

// The persistent grids' schedule: in round k, block x takes item
// k * gridDim.x + x, or, in odd rounds, the mirror item, so that blocks
// that drew long items in one round draw short ones in the next (items
// are numbered longest first).  A block's next item's loads overlap the
// end of its current one.
__device__ __forceinline__ int snake_item(int k) {
  return k * gridDim.x + ((k & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// The forward's work item i: 128 query rows (from m0) of one (b, h), the
// latest rows (the longest walks) first.
struct FwdItem {
  int m0, h, b, kv_begin, n_tiles;
  template <int BN>
  __device__ static FwdItem at(const Params& p, int i) {
    const int n_mblocks = (p.t + kBlockRows - 1) / kBlockRows;
    const int bh = i % (p.batch * p.hq);
    FwdItem w;
    w.m0 = (n_mblocks - 1 - i / (p.batch * p.hq)) * kBlockRows;
    w.h = bh % p.hq;
    w.b = bh / p.hq;
    const int kv_end = min(p.t, w.m0 + kBlockRows);
    w.kv_begin = p.window > 0 ? max(0, w.m0 - p.window + 1) / BN * BN : 0;
    w.n_tiles = (kv_end - w.kv_begin + BN - 1) / BN;
    return w;
  }
};

__host__ __device__ inline int fwd_items(const Params& p) {
  return (p.t + kBlockRows - 1) / kBlockRows * p.batch * p.hq;
}

// Forward: each work item's key tiles (BN keys) go through the ring; its Q
// tile waits in shared memory until both consumers are past their last
// Q.K^T ("q_empty"), then the next item's Q takes its place.
template <int D, int BN>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const Params p) {
  using S = FwdSmem<D, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  uint8_t* q_s = smem;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  const Ring ring{bars + 2, bars + 2 + kStages};
  auto k_tile = [=](int s) { return smem + S::kQ + 2 * s * S::kKV; };
  auto v_tile = [=](int s) { return k_tile(s) + S::kKV; };

  const int wg = warpgroup();
  const int T = p.t;
  const int n_items = fwd_items(p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // ring position of the item's first tile
      for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
        const FwdItem w = FwdItem::at<BN>(p, i);
        const int hk = w.h / p.group;
        hopper::mbar_wait(q_empty, (k & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, S::kQ);
        for (int c = 0; c < D / 64; ++c)
          hopper::tma_load_4d(q_s + c * kBlockRows * 128, &tm_q, q_full,
                              c * 64, w.m0, w.h, w.b);
        for (int it = 0; it < w.n_tiles; ++it) {
          const int s = (g + it) % kStages;
          const int j0 = w.kv_begin + it * BN;
          hopper::mbar_wait(&ring.empty[s], (((g + it) / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&ring.full[s], 2 * S::kKV);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(k_tile(s) + c * BN * 128, &tm_k,
                                &ring.full[s], c * 64, j0, hk, w.b);
            hopper::tma_load_4d(v_tile(s) + c * BN * 128, &tm_v,
                                &ring.full[s], c * 64, j0, hk, w.b);
          }
        }
        g += w.n_tiles;
      }
    }
  } else {  // consumers
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const Lane ln;
    const float sl2 = p.scale * kLog2e;
    float o[D / 64][8][4];
    float sc[BN / 8][4];
    uint32_t pf[BN / 16][4];
    auto release_q = [&] {
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(q_empty);
    };
    int g = 0;
    for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
      const FwdItem w = FwdItem::at<BN>(p, i);
      const int h = w.h, b = w.b, kv_begin = w.kv_begin;
      const int row_lo = w.m0 + cw * 64;  // this warpgroup's first query
      const int pos[2] = {row_lo + ln.row0, row_lo + ln.row0 + 8};
      const float slope2 =
          p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
      const uint32_t seed = head_seed(p, b, h);
      int lo, hi;
      attended_tiles<BN>(p, row_lo, kv_begin, w.n_tiles, lo, hi);
      zero<D>(o);
      float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

      hopper::mbar_wait(q_full, k & 1);
      for (int it = 0; it < lo; ++it) {
        ring.wait(g + it);
        ring.release(g + it);
      }
      // One tile: its softmax in place (sc = p after dropout, fp32), then,
      // once the previous tile's P.V is done, O rescaled and this tile's P.V
      // issued -- after the next tile's scores when there is a next tile.
      // `next` is a compile-time constant, so every wgmma issue, commit and
      // wait is unconditional in each copy: ptxas serializes every wgmma of
      // a kernel whose commit groups it cannot follow through a branch.
      auto step = [&](int it, auto next) {
        const int j0 = kv_begin + it * BN;
        const bool edge = j0 + BN - 1 > row_lo ||
                          (p.window > 0 && j0 <= row_lo + 63 - p.window);
        // softmax of tile it in place (sc = p after dropout, fp32)
        float mx[2] = {kNegInf, kNegInf}, m_new[2], alpha[2];
        float sum[2] = {0.f, 0.f};
        if (!edge && p.slopes == nullptr) {  // every pair attended, no bias
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              mx[i / 2] = fmaxf(mx[i / 2], sc[j][i]);
#pragma unroll
          for (int r = 0; r < 2; ++r)
            m_new[r] = fmaxf(m_i[r], quad_max(mx[r]) * sl2);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              sc[j][i] = ex2(fmaf(sc[j][i], sl2, -m_new[i / 2]));
              sum[i / 2] += sc[j][i];
            }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i / 2;
              const int key = j0 + 8 * j + ln.col0 + (i & 1);
              float x = sc[j][i] * sl2;
              if (p.slopes != nullptr)
                x += slope2 * static_cast<float>(key - pos[r]);
              if (edge && !attends(key, pos[r], p.window)) x = kNegInf;
              sc[j][i] = x;
              mx[r] = fmaxf(mx[r], x);
            }
#pragma unroll
          for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_i[r], quad_max(mx[r]));
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              // -1e30 is finite: masked pairs get p = 0 explicitly
              const float pj = sc[j][i] > 0.5f * kNegInf
                                   ? ex2(sc[j][i] - m_new[i / 2]) : 0.f;
              sum[i / 2] += pj;
              sc[j][i] = pj;
            }
        }
        if (p.dropout) {  // l counts p before dropout; P.V takes p~
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              sc[j][i] = keep(pos[i / 2], j0 + 8 * j + ln.col0 + (i & 1), seed,
                              p.keep_below) ? sc[j][i] * p.drop_scale : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          alpha[r] = ex2(m_i[r] - m_new[r]);
          m_i[r] = m_new[r];
          l_i[r] = l_i[r] * alpha[r] + quad_sum(sum[r]);
        }

        hopper::wgmma_wait<0>();  // the previous tile's P.V
        fence_all<D>(o);
        if (it > lo) ring.release(g + it - 1);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) o[c][j][i] *= alpha[i / 2];
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hopper::frag_from_acc(pf[kk], sc, kk);
        if constexpr (decltype(next)::value) ring.wait(g + it + 1);
        if constexpr (!decltype(next)::value) release_q();
        hopper::wgmma_fence();
        if constexpr (decltype(next)::value) {
          scores<D, BN>(sc, q_s, cw * 64, k_tile((g + it + 1) % kStages));
          hopper::wgmma_commit();
        }
        accumulate<D, BN>(o, pf, v_tile((g + it) % kStages));
        hopper::wgmma_commit();
        if constexpr (decltype(next)::value) {
          hopper::wgmma_wait<1>();  // the next tile's scores; P.V runs on
          hopper::fence_regs(sc);
        }
      };
      if (lo < hi) {
        ring.wait(g + lo);
        hopper::wgmma_fence();
        scores<D, BN>(sc, q_s, cw * 64, k_tile((g + lo) % kStages));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        for (int it = lo; it + 1 < hi; ++it) step(it, std::true_type());
        step(hi - 1, std::false_type());
        hopper::wgmma_wait<0>();
        fence_all<D>(o);
        ring.release(g + hi - 1);
      } else {
        release_q();
      }
      for (int it = hi; it < w.n_tiles; ++it) {
        ring.wait(g + it);
        ring.release(g + it);
      }
      g += w.n_tiles;

      const size_t bh = static_cast<size_t>(b) * p.hq + h;
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float l = l_i[r] == 0.f ? 1.f : l_i[r];
        inv[r] = 1.f / l;
        if (ln.col0 == 0 && pos[r] < T)
          p.lse_out[bh * T + pos[r]] = m_i[r] * kLn2 + logf(l);
      }
      store_rows<D>(static_cast<bf16*>(p.out) + bh * T * D, pos, T, o, inv,
                    ln.col0);
    }
  }
}

template <int D, int BN>
struct DqSmem {
  static constexpr int kQ = tile_bytes<D>(kBlockRows);
  static constexpr int kKV = tile_bytes<D>(BN);
  static constexpr int kDelta = 2 * kQ + 2 * kStages * kKV;
  static constexpr int kBars = kDelta + kBlockRows * 4;
  static constexpr int kBytes = kBars + 64 + 1024;
};

// dQ: work items as the forward's (128 query rows of one (b, h), latest
// first, a persistent grid); Q and dO resident, K/V tiles streamed.  Each
// item's prologue computes delta = rowsum(dO * O) of its rows and writes it
// to p.delta for the dkv kernel.
template <int D, int BN>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_do,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const Params p) {
  using S = DqSmem<D, BN>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + S::kQ;
  float* delta_s = reinterpret_cast<float*>(smem + S::kDelta);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* q_full = bars;
  uint64_t* q_empty = bars + 1;
  const Ring ring{bars + 2, bars + 2 + kStages};
  auto k_tile = [=](int s) { return smem + 2 * S::kQ + 2 * s * S::kKV; };
  auto v_tile = [=](int s) { return k_tile(s) + S::kKV; };

  const int wg = warpgroup();
  const int T = p.t;
  const int n_items = fwd_items(p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ring.full[s], 1);
      hopper::mbar_init(&ring.empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 0) {
      int g = 0;  // ring position of the item's first tile
      for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
        const FwdItem w = FwdItem::at<BN>(p, i);
        const int hk = w.h / p.group;
        hopper::mbar_wait(q_empty, (k & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(q_full, 2 * S::kQ);
        for (int c = 0; c < D / 64; ++c) {
          hopper::tma_load_4d(q_s + c * kBlockRows * 128, &tm_q, q_full,
                              c * 64, w.m0, w.h, w.b);
          hopper::tma_load_4d(do_s + c * kBlockRows * 128, &tm_do, q_full,
                              c * 64, w.m0, w.h, w.b);
        }
        for (int it = 0; it < w.n_tiles; ++it) {
          const int s = (g + it) % kStages;
          const int j0 = w.kv_begin + it * BN;
          hopper::mbar_wait(&ring.empty[s], (((g + it) / kStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&ring.full[s], 2 * S::kKV);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(k_tile(s) + c * BN * 128, &tm_k,
                                &ring.full[s], c * 64, j0, hk, w.b);
            hopper::tma_load_4d(v_tile(s) + c * BN * 128, &tm_v,
                                &ring.full[s], c * 64, j0, hk, w.b);
          }
        }
        g += w.n_tiles;
      }
    }
  } else {  // consumers
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const Lane ln;
    const float sl2 = p.scale * kLog2e;
    float dq[D / 64][8][4];
    float sc[BN / 8][4], dp[BN / 8][4];
    uint32_t df[BN / 16][4];
    auto release_q = [&] {
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(q_empty);
    };
    int g = 0;
    for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
      const FwdItem w = FwdItem::at<BN>(p, i);
      const int h = w.h, b = w.b, kv_begin = w.kv_begin;
      const int row_lo = w.m0 + cw * 64;
      const size_t bh = static_cast<size_t>(b) * p.hq + h;

      {  // delta = rowsum(dO * O): two threads a row, D / 2 features each
        const int tid = threadIdx.x % kWgThreads;
        const int r = tid / 2;
        const int pos = row_lo + r;
        float acc = 0.f;
        if (pos < T) {
          const size_t off = (bh * T + pos) * D + (tid % 2) * (D / 2);
          const bf16* o_row = static_cast<const bf16*>(p.o) + off;
          const bf16* g_row = static_cast<const bf16*>(p.dout) + off;
#pragma unroll
          for (int d = 0; d < D / 2; d += 8) {
            float x[8], y[8];
            load8(o_row + d, x);
            load8(g_row + d, y);
#pragma unroll
            for (int e = 0; e < 8; ++e) acc = fmaf(x[e], y[e], acc);
          }
        }
        acc += __shfl_xor_sync(0xffffffffu, acc, 1);
        hopper::named_sync(1 + cw, kWgThreads);  // the last item's reads
        if (tid % 2 == 0) {
          delta_s[cw * 64 + r] = acc;
          if (pos < T) p.delta[bh * T + pos] = acc;
        }
        hopper::named_sync(1 + cw, kWgThreads);
      }

      const int pos[2] = {row_lo + ln.row0, row_lo + ln.row0 + 8};
      const float slope2 =
          p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
      const uint32_t seed = head_seed(p, b, h);
      float lse2[2], delta[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        lse2[r] = pos[r] < T ? p.lse[bh * T + pos[r]] * kLog2e : 0.f;
        delta[r] = delta_s[cw * 64 + ln.row0 + 8 * r];
      }
      int lo, hi;
      attended_tiles<BN>(p, row_lo, kv_begin, w.n_tiles, lo, hi);
      zero<D>(dq);
      auto issue_scores = [&](int at) {  // S = Q.K^T, dP = dO.V^T
        scores<D, BN>(sc, q_s, cw * 64, k_tile(at % kStages));
        scores<D, BN>(dp, do_s, cw * 64, v_tile(at % kStages));
        hopper::wgmma_commit();
      };

      hopper::mbar_wait(q_full, k & 1);
      for (int it = 0; it < lo; ++it) {
        ring.wait(g + it);
        ring.release(g + it);
      }
      // One tile: its dS in place (sc), then, once the previous tile's dS.K
      // is done, this tile's dS.K issued -- after the next tile's scores when
      // there is a next tile (a compile-time `next`, as in the forward).
      auto step = [&](int it, auto next) {
        const int j0 = kv_begin + it * BN;
        const bool edge = j0 + BN - 1 > row_lo ||
                          (p.window > 0 && j0 <= row_lo + 63 - p.window);
        // dS of tile it in place (sc)
        if (p.dropout) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i)
              dp[j][i] *= keep(pos[i / 2], j0 + 8 * j + ln.col0 + (i & 1),
                               seed, p.keep_below) ? p.drop_scale : 0.f;
        }
        if (!edge && p.slopes == nullptr) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i / 2;
              const float pj = ex2(fmaf(sc[j][i], sl2, -lse2[r]));
              sc[j][i] = pj * (dp[j][i] - delta[r]) * p.scale;
            }
        } else {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i / 2;
              const int key = j0 + 8 * j + ln.col0 + (i & 1);
              float x = sc[j][i] * sl2;
              if (p.slopes != nullptr)
                x += slope2 * static_cast<float>(key - pos[r]);
              const bool att = !edge || attends(key, pos[r], p.window);
              const float pj = att ? ex2(x - lse2[r]) : 0.f;
              sc[j][i] = pj * (dp[j][i] - delta[r]) * p.scale;
            }
        }

        hopper::wgmma_wait<0>();  // the previous tile's dS.K
        fence_all<D>(dq);
        if (it > lo) ring.release(g + it - 1);
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          hopper::frag_from_acc(df[kk], sc, kk);
        if constexpr (decltype(next)::value) ring.wait(g + it + 1);
        if constexpr (!decltype(next)::value) release_q();
        hopper::wgmma_fence();
        if constexpr (decltype(next)::value) issue_scores(g + it + 1);
        accumulate<D, BN>(dq, df, k_tile((g + it) % kStages));
        hopper::wgmma_commit();
        if constexpr (decltype(next)::value) {
          hopper::wgmma_wait<1>();
          hopper::fence_regs(sc);
          hopper::fence_regs(dp);
        }
      };
      if (lo < hi) {
        ring.wait(g + lo);
        hopper::wgmma_fence();
        issue_scores(g + lo);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        hopper::fence_regs(dp);
        for (int it = lo; it + 1 < hi; ++it) step(it, std::true_type());
        step(hi - 1, std::false_type());
        hopper::wgmma_wait<0>();
        fence_all<D>(dq);
        ring.release(g + hi - 1);
      } else {
        release_q();
      }
      for (int it = hi; it < w.n_tiles; ++it) {
        ring.wait(g + it);
        ring.release(g + it);
      }
      g += w.n_tiles;
      const float one[2] = {1.f, 1.f};
      store_rows<D>(static_cast<bf16*>(p.dq) + bh * T * D, pos, T, dq, one,
                    ln.col0);
    }
  }
}

// Streamed query tile of the dkv kernel: 64 at D = 64; 32 at D = 128,
// where the dK and dV sums take D registers a thread.
template <int D>
constexpr int kDkvQueries = D == 64 ? 64 : 32;

template <int D>
struct DkvSmem {
  static constexpr int BQ = kDkvQueries<D>;
  static constexpr int kK = tile_bytes<D>(kBlockRows);
  static constexpr int kQ = tile_bytes<D>(BQ);
  static constexpr int kRows = 2 * kK + 2 * kStages * kQ;  // lse, delta
  static constexpr int kBars = kRows + kStages * 2 * BQ * 4;
  static constexpr int kBytes = kBars + 64 + 1024;
};

// dK, dV: work item i is 128 key rows (K, V resident) of one (b, kv head),
// the earliest keys (the longest walks) first, on a persistent grid; the
// block streams Q / dO tiles with their lse and delta over every query
// head of the GQA group.  The producer warp stages lse (times log2 e) and
// delta beside each tile and arrives on the tile's "full" barrier with the
// TMA's transactions.
struct DkvItem {
  int k0, hk, b, per_head, n_tiles;
  template <int BQ>
  __device__ static DkvItem at(const Params& p, int i) {
    const int bh = i % (p.batch * p.hkv);
    DkvItem w;
    w.k0 = i / (p.batch * p.hkv) * kBlockRows;
    w.hk = bh % p.hkv;
    w.b = bh / p.hkv;
    const int kv = min(kBlockRows, p.t - w.k0);
    // queries that attend a key of the item: t >= k0 and, with a window,
    // t < (last key) + window
    const int q_end =
        p.window > 0 ? min(p.t, w.k0 + kv - 1 + p.window) : p.t;
    w.per_head = (q_end - w.k0 + BQ - 1) / BQ;
    w.n_tiles = p.group * w.per_head;
    return w;
  }
};

__host__ __device__ inline int dkv_items(const Params& p) {
  return (p.t + kBlockRows - 1) / kBlockRows * p.batch * p.hkv;
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v,
                       const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const Params p) {
  using S = DkvSmem<D>;
  constexpr int BQ = S::BQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_1024(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + S::kK;
  float* rows_s = reinterpret_cast<float*>(smem + S::kRows);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* kv_full = bars;
  uint64_t* kv_empty = bars + 1;
  const Ring ring{bars + 2, bars + 2 + kStages};
  auto q_tile = [=](int s) { return smem + 2 * S::kK + 2 * s * S::kQ; };
  auto do_tile = [=](int s) { return q_tile(s) + S::kQ; };
  auto lse_s = [=](int s) { return rows_s + s * 2 * BQ; };
  auto delta_s = [=](int s) { return rows_s + s * 2 * BQ + BQ; };

  const int wg = warpgroup();
  const int T = p.t;
  const int n_items = dkv_items(p);

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, kConsumerWarps);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&ring.full[s], 1 + 32);  // the TMA's arrival + a warp
      hopper::mbar_init(&ring.empty[s], kConsumerWarps);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer: warp 0
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int g = 0;  // ring position of the item's first tile
      for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
        const DkvItem w = DkvItem::at<BQ>(p, i);
        hopper::mbar_wait(kv_empty, (k & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(kv_full, 2 * S::kK);
          for (int c = 0; c < D / 64; ++c) {
            hopper::tma_load_4d(k_s + c * kBlockRows * 128, &tm_k, kv_full,
                                c * 64, w.k0, w.hk, w.b);
            hopper::tma_load_4d(v_s + c * kBlockRows * 128, &tm_v, kv_full,
                                c * 64, w.k0, w.hk, w.b);
          }
        }
        for (int it = 0; it < w.n_tiles; ++it) {
          const int s = (g + it) % kStages;
          const int h = w.hk * p.group + it / w.per_head;
          const int i0 = w.k0 + (it % w.per_head) * BQ;
          const size_t bh = static_cast<size_t>(w.b) * p.hq + h;
          hopper::mbar_wait(&ring.empty[s], (((g + it) / kStages) & 1) ^ 1);
          if (lane == 0) {
            hopper::mbar_arrive_expect_tx(&ring.full[s], 2 * S::kQ);
            for (int c = 0; c < D / 64; ++c) {
              hopper::tma_load_4d(q_tile(s) + c * BQ * 128, &tm_q,
                                  &ring.full[s], c * 64, i0, h, w.b);
              hopper::tma_load_4d(do_tile(s) + c * BQ * 128, &tm_do,
                                  &ring.full[s], c * 64, i0, h, w.b);
            }
          }
          for (int c = lane; c < BQ; c += 32) {
            const bool in = i0 + c < T;
            lse_s(s)[c] = in ? p.lse[bh * T + i0 + c] * kLog2e : 0.f;
            delta_s(s)[c] = in ? p.delta[bh * T + i0 + c] : 0.f;
          }
          hopper::mbar_arrive(&ring.full[s]);
        }
        g += w.n_tiles;
      }
    }
  } else {  // consumers
    hopper::reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const Lane ln;
    const float sl2 = p.scale * kLog2e;
    float dk[D / 64][8][4], dv[D / 64][8][4];
    float st[BQ / 8][4], dpt[BQ / 8][4];
    uint32_t pf[BQ / 16][4], df[BQ / 16][4];
    auto issue_scores = [&](int at) {  // S^T = K.Q^T, dP^T = V.dO^T
      scores<D, BQ>(st, k_s, cw * 64, q_tile(at % kStages));
      scores<D, BQ>(dpt, v_s, cw * 64, do_tile(at % kStages));
      hopper::wgmma_commit();
    };
    auto release_kv = [&] {
      if (threadIdx.x % 32 == 0) hopper::mbar_arrive(kv_empty);
    };
    int g = 0;
    for (int k = 0, i; (i = snake_item(k)) < n_items; ++k) {
      const DkvItem w = DkvItem::at<BQ>(p, i);
      const int k0 = w.k0, hk = w.hk, b = w.b, per_head = w.per_head;
      const int key_lo = k0 + cw * 64;  // this warpgroup's first key
      const int key[2] = {key_lo + ln.row0, key_lo + ln.row0 + 8};
      // a head's query tiles (it % per_head) in [lo, hi) attend a key of
      // this warpgroup: none wholly before its first key, none wholly past
      // its last key's window
      int lo = 0, hi = 0;
      if (key_lo < T) {
        lo = max(0, key_lo - BQ + 1 - k0 + BQ - 1) / BQ;
        hi = p.window > 0
                 ? min(per_head, (key_lo + 63 + p.window - 1 - k0) / BQ + 1)
                 : per_head;
        lo = min(lo, hi);
      }
      zero<D>(dk);
      zero<D>(dv);

      // One tile: p~ and dS in place, then, once the previous tile's dV and
      // dK products are done, this tile's issued -- after the next tile's
      // scores when the next tile is this head's (a compile-time `next`, as
      // in the forward).  After the item's last scores K and V are released.
      auto step = [&](int it, bool first, bool last, auto next) {
        const int s = (g + it) % kStages;
        const int h = hk * p.group + it / per_head;
        const int i0 = k0 + (it % per_head) * BQ;
        const bool edge = i0 < key_lo + 63 || i0 + BQ > T ||
                          (p.window > 0 && i0 + BQ - 1 - key_lo >= p.window);
        const float* lse = lse_s(s);
        const float* dlt = delta_s(s);
        // p~ (st) and dS (dpt) of tile it in place; rows are keys, columns
        // queries
        if (!edge && p.slopes == nullptr && !p.dropout) {
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                lse + 8 * j + ln.col0);
            const float2 d2 = *reinterpret_cast<const float2*>(
                dlt + 8 * j + ln.col0);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pj =
                  ex2(fmaf(st[j][i], sl2, -((i & 1) ? l2.y : l2.x)));
              dpt[j][i] = pj * (dpt[j][i] - ((i & 1) ? d2.y : d2.x)) * p.scale;
              st[j][i] = pj;
            }
          }
        } else {
          const float slope2 =
              p.slopes != nullptr ? p.slopes[h] * kLog2e : 0.f;
          const uint32_t seed = head_seed(p, b, h);
#pragma unroll
          for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i / 2;
              const int col = 8 * j + ln.col0 + (i & 1);
              const int pos = i0 + col;
              float x = st[j][i] * sl2;
              if (p.slopes != nullptr)
                x += slope2 * static_cast<float>(key[r] - pos);
              const bool att =
                  !edge || (pos < T && attends(key[r], pos, p.window));
              const float pj = att ? ex2(x - lse[col]) : 0.f;
              float drop = 1.f;
              if (p.dropout)
                drop = keep(pos, key[r], seed, p.keep_below) ? p.drop_scale
                                                             : 0.f;
              const float dpj = p.dropout ? dpt[j][i] * drop : dpt[j][i];
              dpt[j][i] = pj * (dpj - dlt[col]) * p.scale;  // dS
              st[j][i] = p.dropout ? pj * drop : pj;         // p~
            }
        }

        hopper::wgmma_wait<0>();  // the previous tile's dV, dK products
        fence_all<D>(dk);
        fence_all<D>(dv);
        if (!first) ring.release(g + it - 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
          hopper::frag_from_acc(pf[kk], st, kk);
          hopper::frag_from_acc(df[kk], dpt, kk);
        }
        if constexpr (decltype(next)::value) ring.wait(g + it + 1);
        if (last) release_kv();
        hopper::wgmma_fence();
        if constexpr (decltype(next)::value) issue_scores(g + it + 1);
        accumulate<D, BQ>(dv, pf, do_tile(s));
        accumulate<D, BQ>(dk, df, q_tile(s));
        hopper::wgmma_commit();
        if constexpr (decltype(next)::value) {
          hopper::wgmma_wait<1>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
        }
      };
      hopper::mbar_wait(kv_full, k & 1);
      if (lo == hi) release_kv();
      for (int gi = 0; gi < p.group; ++gi) {
        const int base = gi * per_head;
        const bool last_head = gi + 1 == p.group;
        for (int t = 0; t < lo; ++t) {
          ring.wait(g + base + t);
          ring.release(g + base + t);
        }
        if (lo < hi) {
          ring.wait(g + base + lo);
          hopper::wgmma_fence();
          issue_scores(g + base + lo);
          hopper::wgmma_wait<0>();
          hopper::fence_regs(st);
          hopper::fence_regs(dpt);
          for (int t = lo; t + 1 < hi; ++t)
            step(base + t, t == lo, false, std::true_type());
          step(base + hi - 1, hi - 1 == lo, last_head, std::false_type());
          hopper::wgmma_wait<0>();
          fence_all<D>(dk);
          fence_all<D>(dv);
          ring.release(g + base + hi - 1);
        }
        for (int t = hi; t < per_head; ++t) {
          ring.wait(g + base + t);
          ring.release(g + base + t);
        }
      }
      g += w.n_tiles;

      const size_t bhk = static_cast<size_t>(b) * p.hkv + hk;
      const float one[2] = {1.f, 1.f};
      store_rows<D>(static_cast<bf16*>(p.dk) + bhk * T * D, key, T, dk, one,
                    ln.col0);
      store_rows<D>(static_cast<bf16*>(p.dv) + bhk * T * D, key, T, dv, one,
                    ln.col0);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K, typename... Args>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t stream, const Args&... args) {
  const int smem = static_cast<int>(bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// bf16 at D = 64 or 128 runs the Hopper kernels; fp32 (no TF32: the JAX
// package's fp32 products run at full precision) and D = 256 on FMAs.
template <typename T, int D>
constexpr bool hopper_path() {
  return sizeof(T) == 2 && D <= 128;
}

constexpr int kFwdKeys = 128;  // streamed key tile of the forward
// Streamed key tile of the dq kernel: 128 at D = 64; 64 at D = 128, where
// three stages of 128 keys would not fit in shared memory.
template <int D>
constexpr int kDqKeys = D == 64 ? 128 : 64;

// SMs of the current device, read from the driver once a device.
inline cudaError_t sm_count(int* sms) {
  constexpr int kDevices = 64;
  static std::atomic<int> cached[kDevices] = {};
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kDevices)
    return cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  *sms = cached[device].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) cached[device].store(*sms, std::memory_order_relaxed);
  return err;
}

template <typename T, int D>
cudaError_t forward(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (hopper_path<T, D>()) {
    CUtensorMap tq, tk, tv;
    cudaError_t err;
    if ((err = hopper::bhtd_map(&tq, p.q, batch, p.hq, p.t, D,
                                kBlockRows)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tk, p.k, batch, p.hkv, p.t, D,
                                kFwdKeys)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tv, p.v, batch, p.hkv, p.t, D,
                                kFwdKeys)) != cudaSuccess)
      return err;
    int sms;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    const int items = fwd_items(p);
    const dim3 grid(items < sms ? items : sms);  // persistent: a block an SM
    return launch(flash_fwd_wgmma_kernel<D, kFwdKeys>, grid, kHopperThreads,
                  FwdSmem<D, kFwdKeys>::kBytes, stream, tq, tk, tv, p);
  } else {
    constexpr int BM = rows_per_block<D>();
    const dim3 grid((p.t + BM - 1) / BM, p.hq, batch);
    return launch(flash_fwd_kernel<T, D, BM>, grid, kThreads,
                  fwd_smem_floats<D, BM>() * sizeof(float), stream, p);
  }
}

template <typename T, int D>
cudaError_t backward(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (hopper_path<T, D>()) {
    CUtensorMap tq, tdo, tk, tv, tk_res, tv_res, tq_str, tdo_str;
    if ((err = hopper::bhtd_map(&tq, p.q, batch, p.hq, p.t, D,
                                kBlockRows)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tdo, p.dout, batch, p.hq, p.t, D,
                                kBlockRows)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tk, p.k, batch, p.hkv, p.t, D,
                                kDqKeys<D>)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tv, p.v, batch, p.hkv, p.t, D,
                                kDqKeys<D>)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tk_res, p.k, batch, p.hkv, p.t, D,
                                kBlockRows)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tv_res, p.v, batch, p.hkv, p.t, D,
                                kBlockRows)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tq_str, p.q, batch, p.hq, p.t, D,
                                kDkvQueries<D>)) != cudaSuccess ||
        (err = hopper::bhtd_map(&tdo_str, p.dout, batch, p.hq, p.t, D,
                                kDkvQueries<D>)) != cudaSuccess)
      return err;
    int sms;
    if ((err = sm_count(&sms)) != cudaSuccess) return err;
    const int items = fwd_items(p);
    err = launch(flash_dq_wgmma_kernel<D, kDqKeys<D>>,
                 dim3(items < sms ? items : sms), kHopperThreads,
                 DqSmem<D, kDqKeys<D>>::kBytes, stream, tq, tdo, tk, tv, p);
    if (err != cudaSuccess) return err;
    const int kitems = dkv_items(p);
    return launch(flash_dkv_wgmma_kernel<D>, dim3(kitems < sms ? kitems : sms),
                  kHopperThreads, DkvSmem<D>::kBytes, stream, tk_res, tv_res,
                  tq_str, tdo_str, p);
  } else {
    constexpr int BM = rows_per_block<D>();
    const int tiles = (p.t + BM - 1) / BM;
    err = launch(flash_dq_kernel<T, D, BM>, dim3(tiles, p.hq, batch),
                 kThreads, dq_smem_floats<D, BM>() * sizeof(float), stream,
                 p);
    if (err != cudaSuccess) return err;
    return launch(flash_dkv_kernel<T, D, BM>, dim3(tiles, p.hkv, batch),
                  kThreads, dkv_smem_floats<D, BM>() * sizeof(float), stream,
                  p);
  }
}

template <typename T>
cudaError_t dispatch(bool fwd, const Params& p, int batch, int d,
                     cudaStream_t stream) {
  switch (d) {
    case 64:
      return fwd ? forward<T, 64>(p, batch, stream)
                 : backward<T, 64>(p, batch, stream);
    case 128:
      return fwd ? forward<T, 128>(p, batch, stream)
                 : backward<T, 128>(p, batch, stream);
    case 256:
      return fwd ? forward<T, 256>(p, batch, stream)
                 : backward<T, 256>(p, batch, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

int run(bool fwd, Params& p, int batch, int d, int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  p.batch = batch;
  if (dtype == 0) return dispatch<float>(fwd, p, batch, d, st);
  if (dtype == 1) return dispatch<__nv_bfloat16>(fwd, p, batch, d, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* seed, const void* slopes, int hq, int hkv,
                   int t, int window, float scale, int dropout,
                   unsigned int keep_below, float drop_scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.seed = static_cast<const int*>(seed);
  p.slopes = static_cast<const float*>(slopes);
  p.hq = hq;
  p.hkv = hkv;
  p.t = t;
  p.group = hq / hkv;
  p.window = window;
  p.scale = scale;
  p.dropout = dropout;
  p.keep_below = keep_below;
  p.drop_scale = drop_scale;
  return p;
}

}  // namespace

// out (B, Hq, T, D) in q's dtype and lse (B, Hq, T) fp32.
extern "C" int penroz_flash_forward(
    const void* q, const void* k, const void* v, const void* seed,
    const void* slopes, void* out, void* lse, int batch, int hq, int hkv,
    int t, int d, int dtype, int window, float scale, int dropout,
    unsigned int keep_below, float drop_scale, void* stream) {
  Params p = make_params(q, k, v, seed, slopes, hq, hkv, t, window, scale,
                         dropout, keep_below, drop_scale);
  p.out = out;
  p.lse_out = static_cast<float*>(lse);
  return run(true, p, batch, d, dtype, stream);
}

// dq (B, Hq, T, D), dk/dv (B, Hkv, T, D) in the inputs' dtype: the dq
// kernel, which also writes delta = rowsum(dO * O) (B, Hq, T) fp32 from the
// forward's output `out`, then the dkv kernel, which reads it, on one
// stream.
extern "C" int penroz_flash_backward(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, const void* lse, void* delta, const void* seed,
    const void* slopes, void* dq, void* dk, void* dv, int batch, int hq,
    int hkv, int t, int d, int dtype, int window, float scale, int dropout,
    unsigned int keep_below, float drop_scale, void* stream) {
  Params p = make_params(q, k, v, seed, slopes, hq, hkv, t, window, scale,
                         dropout, keep_below, drop_scale);
  p.o = out;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return run(false, p, batch, d, dtype, stream);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
