// Causal flash attention, forward and backward (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/flash_attention.py: the forward kernel
// `_fwd_kernel` (pallas_call at :231) and the backward's two kernels
// `_dq_kernel` (:446) and `_dkv_kernel` (:482).  Same contract: q (B, Hq, T, D),
// k/v (B, Hkv, T, D) with Hq % Hkv == 0 (query head h reads kv head
// h / (Hq / Hkv)); query t attends keys j <= t, and j > t - window when a
// window is set.  Score order: q.k * scale, then + slope_h * (j - t) (ALiBi),
// then the mask with the finite -1e30.  fp32 or bf16 in, fp32 accumulation.
// The forward writes the output in q's dtype and the fp32 logsumexp per row;
// the backward recomputes the probabilities from it, with
// delta = rowsum(dO * O) computed by the caller, as the JAX package does.
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
// bound it.  What the design does about it: every block loops over its key
// (forward, dq) or query (dkv) tiles itself, carrying the softmax state or
// the dQ / dK / dV sums in registers, so the (T, T) score matrix never
// reaches device memory; the causal and window limits are the loop bounds,
// so fully masked tiles are never read; the dq kernel owns query rows and
// streams K/V, the dkv kernel owns key rows and streams Q/dO and sums the
// query heads of its GQA group itself, so no atomics are needed and the
// result is deterministic.  Heaviest tiles (late queries in the forward and
// dq kernels) are scheduled first.  bf16 at D = 64 or 128 (GPT-2's case)
// runs its products on the tensor cores (mma.sync.m16n8k16, fp32
// accumulate; the second half of this file); fp32, which the JAX package
// computes at full precision (no TF32), and D = 256 run fp32 FMAs from
// shared memory, 16 outputs per thread.  What it does not do yet: wgmma,
// ldmatrix, asynchronous tile copies (cp.async / TMA) or a pipeline that
// overlaps them with the products.
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

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 16;  // tx extent: threads along columns
constexpr int kTile = 64;   // streamed tile (keys in fwd/dq, queries in dkv)
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, Hq, T) forward logsumexp (backward input)
  const float* delta;  // (B, Hq, T) rowsum(dO * O) (backward input)
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
    delta[i] = r < mv ? p.delta[bh * T + m0 + r] : 0.f;
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
// bf16 tensor-core path (D = 64 or 128): the same three kernels with their
// products on mma.sync.m16n8k16 (bf16 in, fp32 accumulate).  Tiles live in
// shared memory as bf16; a warp owns 16 rows.  An operand read as the B
// fragment must have its contracted index contiguous, so V (forward), K (dQ)
// and Q, dO (dK, dV) are also stored transposed.  Scores come out in the
// accumulator layout, which is also the A-fragment layout of the next
// product, so p / dS go to the tensor cores from registers, rounded to bf16
// there (the same rounding points as above).  Row statistics are reduced over
// the 4 lanes that share a row.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;  // 4 warps x 16 rows
constexpr int kTcRows = 64;

// D = C + A.B for one 16x8x16 tile.  A: 4 registers of 2 bf16 (rows g and
// g + 8, columns 2t, 2t + 1 and 8 more); B: 2 registers (column g, rows 2t,
// 2t + 1 and 8 more); C: rows g and g + 8, columns 2t, 2t + 1.  g is the
// lane / 4, t the lane % 4.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0..r0+15, columns k0..k0+15 of a row-major tile.
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* x, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = x + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (k0..k0+15 x n0..n0+7) of B[k][n] = x[n][k], x row-major.
__device__ __forceinline__ void frag_b(uint32_t* b, const bf16* x, int ld,
                                       int n0, int k0, int g, int t) {
  const bf16* p = x + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// A fragment for k-step kk from an accumulator array c[n][4] (the C -> A
// layout identity), rounded to bf16.
__device__ __forceinline__ void frag_from_acc(uint32_t* a, const float (*c)[4],
                                              int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// rows x D tile of bf16 rows into shared memory, row stride ld (and, with
// xt, transposed: xt[d * ldt + r]); rows at or past `valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(bf16* x, int ld, bf16* xt,
                                               int ldt, const bf16* src,
                                               int rows, int valid) {
  for (int c = threadIdx.x; c < rows * D / 8; c += kTcThreads) {
    const int r = (c * 8) / D;
    const int d = (c * 8) % D;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      raw = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * D +
                                            d);
    if (x != nullptr) *reinterpret_cast<uint4*>(x + r * ld + d) = raw;
    if (xt != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) xt[(d + i) * ldt + r] = e[i];
    }
  }
}

// Sum or max over the 4 lanes of a row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
constexpr size_t fwd_tc_smem_bytes() {
  return sizeof(bf16) * (2 * kTcRows * (D + 8) + D * (kTile + 8));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const Params p) {
  constexpr int LD = D + 8, LDT = kTile + 8;
  constexpr int NT = kTile / 8;  // score n-tiles
  constexpr int NO = D / 8;      // output n-tiles
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // kTcRows x LD
  bf16* k_s = q_s + kTcRows * LD;             // kTile x LD
  bf16* vt_s = k_s + kTile * LD;              // D x LDT (V transposed)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int mv = min(kTcRows, T - m0);
  const size_t bh = static_cast<size_t>(b) * p.hq + h;
  const size_t bhk = static_cast<size_t>(b) * p.hkv + h / p.group;
  const bf16* k = static_cast<const bf16*>(p.k) + bhk * T * D;
  const bf16* v = static_cast<const bf16*>(p.v) + bhk * T * D;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const uint32_t seed = head_seed(p, b, h);

  load_tile_bf16<D>(q_s, LD, nullptr, 0,
                    static_cast<const bf16*>(p.q) + (bh * T + m0) * D,
                    kTcRows, mv);
  const int r0 = warp * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};  // this lane's rows in the tile
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_i[2] = {kNegInf, kNegInf}, l_i[2] = {0.f, 0.f};

  const int kv_end = m0 + mv;
  const int kv_begin = p.window > 0 ? max(0, m0 - p.window + 1) : 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    const int nv = min(kTile, kv_end - j0);
    __syncthreads();
    load_tile_bf16<D>(k_s, LD, nullptr, 0, k + static_cast<size_t>(j0) * D,
                      kTile, nv);
    load_tile_bf16<D>(nullptr, 0, vt_s, LDT, v + static_cast<size_t>(j0) * D,
                      kTile, nv);
    __syncthreads();

    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, q_s, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bb[2];
        frag_b(bb, k_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(s[n], a, bb);
      }
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i / 2];
        const int col = n * 8 + 2 * t + (i & 1);
        const int pos = m0 + r, key = j0 + col;
        float x = s[n][i] * p.scale;
        if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
        const bool att = col < nv && r < mv && attends(key, pos, p.window);
        s[n][i] = att ? x : kNegInf;
        mx[i / 2] = fmaxf(mx[i / 2], s[n][i]);
      }
    float m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) m_new[r] = fmaxf(m_i[r], quad_max(mx[r]));
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i / 2];
        const int col = n * 8 + 2 * t + (i & 1);
        // -1e30 is finite: masked pairs get p = 0 explicitly
        const float pj = s[n][i] > 0.5f * kNegInf
                             ? expf(s[n][i] - m_new[i / 2]) : 0.f;
        sum[i / 2] += pj;
        float pa = pj;
        if (p.dropout)
          pa = keep(m0 + r, j0 + col, seed, p.keep_below) ? pj * p.drop_scale
                                                          : 0.f;
        s[n][i] = pa;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float alpha = expf(m_i[r] - m_new[r]);
      m_i[r] = m_new[r];
      l_i[r] = l_i[r] * alpha + quad_sum(sum[r]);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * r] *= alpha;
        o[n][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      frag_from_acc(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bb[2];
        frag_b(bb, vt_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(o[n], a, bb);
      }
    }
  }

  bf16* out = static_cast<bf16*>(p.out) + (bh * T + m0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= mv) continue;
    const float l = l_i[r] == 0.f ? 1.f : l_i[r];
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(out + rows[r] * D + n * 8 + 2 * t) =
          pack_bf16(o[n][2 * r] / l, o[n][2 * r + 1] / l);
    if (t == 0) p.lse_out[bh * T + m0 + rows[r]] = m_i[r] + logf(l);
  }
}

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return sizeof(bf16) * (2 * kTcRows * (D + 8) + 2 * kTile * (D + 8) +
                         D * (kTile + 8));
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_tc_kernel(const Params p) {
  constexpr int LD = D + 8, LDT = kTile + 8;
  constexpr int NT = kTile / 8, NO = D / 8;
  extern __shared__ float smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);  // kTcRows x LD
  bf16* do_s = q_s + kTcRows * LD;            // kTcRows x LD
  bf16* k_s = do_s + kTcRows * LD;            // kTile x LD
  bf16* v_s = k_s + kTile * LD;               // kTile x LD
  bf16* kt_s = v_s + kTile * LD;              // D x LDT (K transposed)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;
  const int mv = min(kTcRows, T - m0);
  const size_t bh = static_cast<size_t>(b) * p.hq + h;
  const size_t bhk = static_cast<size_t>(b) * p.hkv + h / p.group;
  const bf16* k = static_cast<const bf16*>(p.k) + bhk * T * D;
  const bf16* v = static_cast<const bf16*>(p.v) + bhk * T * D;
  const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
  const uint32_t seed = head_seed(p, b, h);

  load_tile_bf16<D>(q_s, LD, nullptr, 0,
                    static_cast<const bf16*>(p.q) + (bh * T + m0) * D,
                    kTcRows, mv);
  load_tile_bf16<D>(do_s, LD, nullptr, 0,
                    static_cast<const bf16*>(p.dout) + (bh * T + m0) * D,
                    kTcRows, mv);
  const int r0 = warp * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = rows[r] < mv ? p.lse[bh * T + m0 + rows[r]] : 0.f;
    delta[r] = rows[r] < mv ? p.delta[bh * T + m0 + rows[r]] : 0.f;
  }
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int kv_end = m0 + mv;
  const int kv_begin = p.window > 0 ? max(0, m0 - p.window + 1) : 0;
  for (int j0 = kv_begin; j0 < kv_end; j0 += kTile) {
    const int nv = min(kTile, kv_end - j0);
    __syncthreads();
    load_tile_bf16<D>(k_s, LD, kt_s, LDT, k + static_cast<size_t>(j0) * D,
                      kTile, nv);
    load_tile_bf16<D>(v_s, LD, nullptr, 0, v + static_cast<size_t>(j0) * D,
                      kTile, nv);
    __syncthreads();

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a(aq, q_s, LD, r0, kk * 16, g, t);
      frag_a(ado, do_s, LD, r0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bk[2], bv[2];
        frag_b(bk, k_s, LD, n * 8, kk * 16, g, t);
        frag_b(bv, v_s, LD, n * 8, kk * 16, g, t);
        mma_bf16(s[n], aq, bk);
        mma_bf16(dp[n], ado, bv);
      }
    }

#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rows[i / 2];
        const int col = n * 8 + 2 * t + (i & 1);
        const int pos = m0 + r, key = j0 + col;
        float x = s[n][i] * p.scale;
        if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
        const bool att = col < nv && r < mv && attends(key, pos, p.window);
        const float pj = att ? expf(x - lse[i / 2]) : 0.f;
        float dpj = dp[n][i];
        if (p.dropout)
          dpj *= keep(pos, key, seed, p.keep_below) ? p.drop_scale : 0.f;
        s[n][i] = pj * (dpj - delta[i / 2]) * p.scale;  // dS
      }

#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      frag_from_acc(a, s, kk);
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        uint32_t bb[2];
        frag_b(bb, kt_s, LDT, n * 8, kk * 16, g, t);
        mma_bf16(acc[n], a, bb);
      }
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq) + (bh * T + m0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= mv) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<uint32_t*>(dq + rows[r] * D + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// Streamed query tile of the dkv kernel: 64 at D = 64, 32 at D = 128 (to
// bound registers: dK and dV accumulators are 2 x D / 2 floats a lane).
template <int D>
constexpr int kDkvTcTile = D == 64 ? 64 : 32;

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return sizeof(bf16) * (2 * kTcRows * (D + 8) + 2 * kDkvTcTile<D> * (D + 8) +
                         2 * D * (kDkvTcTile<D> + 8)) +
         sizeof(float) * 2 * kDkvTcTile<D>;
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_tc_kernel(const Params p) {
  constexpr int TQ = kDkvTcTile<D>;
  constexpr int LD = D + 8, LDT = TQ + 8;
  constexpr int NT = TQ / 8, NO = D / 8;
  extern __shared__ float smem[];
  float* lse_s = smem;                                  // TQ
  float* delta_s = lse_s + TQ;                          // TQ
  bf16* k_s = reinterpret_cast<bf16*>(delta_s + TQ);    // kTcRows x LD
  bf16* v_s = k_s + kTcRows * LD;                       // kTcRows x LD
  bf16* q_s = v_s + kTcRows * LD;                       // TQ x LD
  bf16* do_s = q_s + TQ * LD;                           // TQ x LD
  bf16* qt_s = do_s + TQ * LD;                          // D x LDT
  bf16* dot_s = qt_s + D * LDT;                         // D x LDT

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int T = p.t;
  const int k0 = blockIdx.x * kTcRows;
  const int kv = min(kTcRows, T - k0);
  const size_t bhk = static_cast<size_t>(b) * p.hkv + hk;

  load_tile_bf16<D>(k_s, LD, nullptr, 0,
                    static_cast<const bf16*>(p.k) + (bhk * T + k0) * D,
                    kTcRows, kv);
  load_tile_bf16<D>(v_s, LD, nullptr, 0,
                    static_cast<const bf16*>(p.v) + (bhk * T + k0) * D,
                    kTcRows, kv);
  const int r0 = warp * 16;
  const int rows[2] = {r0 + g, r0 + g + 8};  // key rows of this lane
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk[n][i] = dv[n][i] = 0.f;

  const int q_end = p.window > 0 ? min(T, k0 + kv - 1 + p.window) : T;
  for (int gi = 0; gi < p.group; ++gi) {
    const int h = hk * p.group + gi;
    const size_t bh = static_cast<size_t>(b) * p.hq + h;
    const bf16* q = static_cast<const bf16*>(p.q) + bh * T * D;
    const bf16* dout = static_cast<const bf16*>(p.dout) + bh * T * D;
    const float slope = p.slopes != nullptr ? p.slopes[h] : 0.f;
    const uint32_t seed = head_seed(p, b, h);
    for (int i0 = k0; i0 < q_end; i0 += TQ) {
      const int nq = min(TQ, q_end - i0);
      __syncthreads();
      load_tile_bf16<D>(q_s, LD, qt_s, LDT, q + static_cast<size_t>(i0) * D,
                        TQ, nq);
      load_tile_bf16<D>(do_s, LD, dot_s, LDT,
                        dout + static_cast<size_t>(i0) * D, TQ, nq);
      if (threadIdx.x < TQ) {
        const int c = threadIdx.x;
        lse_s[c] = c < nq ? p.lse[bh * T + i0 + c] : 0.f;
        delta_s[c] = c < nq ? p.delta[bh * T + i0 + c] : 0.f;
      }
      __syncthreads();

      // transposed scores: rows are keys, columns queries
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[n][i] = dp[n][i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ak[4], av[4];
        frag_a(ak, k_s, LD, r0, kk * 16, g, t);
        frag_a(av, v_s, LD, r0, kk * 16, g, t);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          uint32_t bq[2], bo[2];
          frag_b(bq, q_s, LD, n * 8, kk * 16, g, t);
          frag_b(bo, do_s, LD, n * 8, kk * 16, g, t);
          mma_bf16(s[n], ak, bq);
          mma_bf16(dp[n], av, bo);
        }
      }

#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rows[i / 2];
          const int col = n * 8 + 2 * t + (i & 1);
          const int key = k0 + r, pos = i0 + col;
          float x = s[n][i] * p.scale;
          if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
          const bool att = r < kv && col < nq && attends(key, pos, p.window);
          const float pj = att ? expf(x - lse_s[col]) : 0.f;
          float drop = 1.f;
          if (p.dropout)
            drop = keep(pos, key, seed, p.keep_below) ? p.drop_scale : 0.f;
          const float dpj = p.dropout ? dp[n][i] * drop : dp[n][i];
          dp[n][i] = pj * (dpj - delta_s[col]) * p.scale;  // dS
          s[n][i] = p.dropout ? pj * drop : pj;              // p~
        }

#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        uint32_t ap[4], ad[4];
        frag_from_acc(ap, s, kk);
        frag_from_acc(ad, dp, kk);
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          uint32_t bo[2], bq[2];
          frag_b(bo, dot_s, LDT, n * 8, kk * 16, g, t);
          frag_b(bq, qt_s, LDT, n * 8, kk * 16, g, t);
          mma_bf16(dv[n], ap, bo);
          mma_bf16(dk[n], ad, bq);
        }
      }
    }
  }

  bf16* dk_out = static_cast<bf16*>(p.dk) + (bhk * T + k0) * D;
  bf16* dv_out = static_cast<bf16*>(p.dv) + (bhk * T + k0) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= kv) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int off = rows[r] * D + n * 8 + 2 * t;
      *reinterpret_cast<uint32_t*>(dk_out + off) =
          pack_bf16(dk[n][2 * r], dk[n][2 * r + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + off) =
          pack_bf16(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t bytes,
                   const Params& p, cudaStream_t stream) {
  const int smem = static_cast<int>(bytes);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// bf16 at D = 64 or 128 runs on the tensor cores; fp32 (no TF32: the JAX
// package's fp32 products run at full precision) and D = 256 on FMAs.
template <typename T, int D>
constexpr bool tensor_cores() {
  return sizeof(T) == 2 && D <= 128;
}

template <typename T, int D>
cudaError_t forward(const Params& p, int batch, cudaStream_t stream) {
  if constexpr (tensor_cores<T, D>()) {
    const dim3 grid((p.t + kTcRows - 1) / kTcRows, p.hq, batch);
    return launch(flash_fwd_tc_kernel<D>, grid, kTcThreads,
                  fwd_tc_smem_bytes<D>(), p, stream);
  } else {
    constexpr int BM = rows_per_block<D>();
    const dim3 grid((p.t + BM - 1) / BM, p.hq, batch);
    return launch(flash_fwd_kernel<T, D, BM>, grid, kThreads,
                  fwd_smem_floats<D, BM>() * sizeof(float), p, stream);
  }
}

template <typename T, int D>
cudaError_t backward(const Params& p, int batch, cudaStream_t stream) {
  cudaError_t err;
  if constexpr (tensor_cores<T, D>()) {
    const int tiles = (p.t + kTcRows - 1) / kTcRows;
    err = launch(flash_dq_tc_kernel<D>, dim3(tiles, p.hq, batch), kTcThreads,
                 dq_tc_smem_bytes<D>(), p, stream);
    if (err != cudaSuccess) return err;
    return launch(flash_dkv_tc_kernel<D>, dim3(tiles, p.hkv, batch),
                  kTcThreads, dkv_tc_smem_bytes<D>(), p, stream);
  } else {
    constexpr int BM = rows_per_block<D>();
    const int tiles = (p.t + BM - 1) / BM;
    err = launch(flash_dq_kernel<T, D, BM>, dim3(tiles, p.hq, batch),
                 kThreads, dq_smem_floats<D, BM>() * sizeof(float), p,
                 stream);
    if (err != cudaSuccess) return err;
    return launch(flash_dkv_kernel<T, D, BM>, dim3(tiles, p.hkv, batch),
                  kThreads, dkv_smem_floats<D, BM>() * sizeof(float), p,
                  stream);
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
// kernel, then the dkv kernel, on one stream.
extern "C" int penroz_flash_backward(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, const void* seed, const void* slopes,
    void* dq, void* dk, void* dv, int batch, int hq, int hkv, int t, int d,
    int dtype, int window, float scale, int dropout, unsigned int keep_below,
    float drop_scale, void* stream) {
  Params p = make_params(q, k, v, seed, slopes, hq, hkv, t, window, scale,
                         dropout, keep_below, drop_scale);
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  return run(false, p, batch, d, dtype, stream);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
