// Cached attention of T new queries against a contiguous KV cache (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/decode_attention.py::decode_attention, the
// TPU kernel behind ops/attention.py::cached_attention.  Same contract:
// q (B, Hq, T, D) at absolute positions length_b - T + t attends keys
// j <= that position (optionally j > position - window) of k/v
// (B, Hkv, S_max, D); fp32 or bf16, or int8 K/V with per-token fp32 scales
// (B, Hkv, S_max, 1).  Score order: scale, then softcap·tanh(s/softcap),
// then ALiBi slope·(j - position), then the mask with the finite -1e30.
// Running max, sum and accumulator are fp32; a row with no attended key
// writes zeros.
//
// What bounds it on an H100: at decode (T = 1) every valid K/V row is read
// once and used for 4·D flops per query row, so the call is memory-bound
// (2·Hkv·L·D·itemsize bytes over 3.35 TB/s); a long prefill (T = L) is
// bound by its L²/2 score pairs instead.  What the design does about it:
// the key loop of each block stops at the last position its rows attend
// (and starts at the window's first), so traffic tracks the valid length,
// not S_max; int8 caches are read as int8 and dequantized in shared memory,
// so no full-precision cache is ever written.  What it does not do yet:
// split the key axis across blocks (flash-decoding) — at B = 1, T = 1 only
// B·Hkv blocks run, one per SM — nor use tensor cores.
//
// Layout: one block of 128 threads per (tile of 16 query rows, kv head,
// batch row).  The query group folds into rows in kv-major order, as in the
// Pallas kernel: row r of kv head h is query head h·G + r / T, token r % T.
// Each 64-key tile goes to shared memory as fp32 (K rows padded by one
// float so the column reads of the score loop are bank-conflict free),
// then: scores (one thread per (row, key)), online softmax (one warp per
// row), accumulate P·V (one thread per (row, feature)).
//
// Plain C interface for ctypes; returns a cudaError_t (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockM = 16;  // query rows per block
constexpr int kBlockN = 64;  // keys per tile (two per lane in the softmax)
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // null unless the cache is int8
  const float* v_scale;
  const int* lengths;    // (B,) valid lengths, or null: use `length`
  int length;
  const float* slopes;   // (Hq,) ALiBi slopes, or null
  void* out;
  int hkv, t, s, d, group;
  int window;            // 0: no window
  float scale;
  float softcap;         // 0: no softcap
};

// Eight consecutive elements to fp32 (16-byte loads for fp32/bf16, 8 for int8).
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

__device__ __forceinline__ void load8(const int8_t* p, float* x) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// Round an fp32 value to the query dtype (identity for fp32): int8 tiles
// dequantize as (int8 -> fp32 · scale) -> q dtype, and P is cast to the
// value dtype before the P·V product, as in the Pallas kernel.
template <typename QT>
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

__device__ __forceinline__ bool attends(int j, int pos, int window) {
  return j <= pos && (window <= 0 || j > pos - window);
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const Params p) {
  extern __shared__ float smem[];
  const int D = p.d;
  const int DK = D + 1;
  float* q_s = smem;                       // kBlockM x D
  float* k_s = q_s + kBlockM * D;          // kBlockN x (D + 1)
  float* v_s = k_s + kBlockN * DK;         // kBlockN x D
  float* p_s = v_s + kBlockN * D;          // kBlockM x kBlockN
  float* acc_s = p_s + kBlockM * kBlockN;  // kBlockM x D
  float* m_s = acc_s + kBlockM * D;        // kBlockM running max
  float* l_s = m_s + kBlockM;              // kBlockM running sum
  float* alpha_s = l_s + kBlockM;          // kBlockM rescale of this tile

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int T = p.t;
  const int rows = p.group * T;
  const int m0 = blockIdx.x * kBlockM;
  const int mv = min(kBlockM, rows - m0);
  const int len = p.lengths != nullptr ? p.lengths[b] : p.length;
  const int first = len - T;  // absolute position of query token 0

  // Token range of this block's rows; a tile that wraps past a group
  // boundary holds both t = T - 1 and t = 0.
  int t_lo = 0, t_hi = T - 1;
  if (m0 / T == (m0 + mv - 1) / T) {
    t_lo = m0 % T;
    t_hi = (m0 + mv - 1) % T;
  }
  const int kv_end = min(first + t_hi + 1, p.s);  // exclusive
  const int kv_begin = p.window > 0 ? max(0, first + t_lo - p.window + 1) : 0;

  const size_t bh = static_cast<size_t>(b) * p.hkv + h;
  const QT* q = static_cast<const QT*>(p.q) + (bh * rows + m0) * D;
  const KT* k = static_cast<const KT*>(p.k) + bh * p.s * D;
  const KT* v = static_cast<const KT*>(p.v) + bh * p.s * D;
  const float* ks = p.k_scale != nullptr ? p.k_scale + bh * p.s : nullptr;
  const float* vs = p.v_scale != nullptr ? p.v_scale + bh * p.s : nullptr;
  QT* out = static_cast<QT*>(p.out) + (bh * rows + m0) * D;

  for (int c = tid; c < mv * D / 8; c += kThreads) {
    float x[8];
    load8(q + c * 8, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) q_s[c * 8 + i] = x[i];
  }
  for (int i = tid; i < mv * D; i += kThreads) acc_s[i] = 0.f;
  if (tid < kBlockM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int j0 = kv_begin; j0 < kv_end; j0 += kBlockN) {
    const int nv = min(kBlockN, kv_end - j0);
    for (int c = tid; c < nv * D / 8; c += kThreads) {
      const int n = (c * 8) / D;
      const int d = (c * 8) % D;
      float xk[8], xv[8];
      load8(k + static_cast<size_t>(j0) * D + c * 8, xk);
      load8(v + static_cast<size_t>(j0) * D + c * 8, xv);
      if (ks != nullptr) {
        const float sk = ks[j0 + n];
        const float sv = vs[j0 + n];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xk[i] = round_to<QT>(xk[i] * sk);
          xv[i] = round_to<QT>(xv[i] * sv);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        k_s[n * DK + d + i] = xk[i];
        v_s[n * D + d + i] = xv[i];
      }
    }
    __syncthreads();

    // Scores of (row, key) pairs; keys past nv or outside the mask get -1e30.
    for (int i = tid; i < mv * kBlockN; i += kThreads) {
      const int m = i / kBlockN;
      const int n = i % kBlockN;
      float s = kNegInf;
      if (n < nv) {
        const int r = m0 + m;
        const int pos = first + r % T;
        const int j = j0 + n;
        const float* qr = q_s + m * D;
        const float* kr = k_s + n * DK;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        if (p.slopes != nullptr)
          s += p.slopes[h * p.group + r / T] * static_cast<float>(j - pos);
        if (!attends(j, pos, p.window)) s = kNegInf;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row.  -1e30 is finite, so masked keys
    // get p = 0 explicitly (a row masked so far would otherwise see
    // exp(-1e30 - -1e30) = 1).
    for (int m = warp; m < mv; m += kWarps) {
      const int pos = first + (m0 + m) % T;
      const float m_prev = m_s[m];
      const float s0 = p_s[m * kBlockN + lane];
      const float s1 = p_s[m * kBlockN + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const bool a0 = lane < nv && attends(j0 + lane, pos, p.window);
      const bool a1 = lane + 32 < nv && attends(j0 + lane + 32, pos, p.window);
      const float p0 = a0 ? expf(s0 - m_new) : 0.f;
      const float p1 = a1 ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      __syncwarp();
      p_s[m * kBlockN + lane] = round_to<QT>(p0);
      p_s[m * kBlockN + lane + 32] = round_to<QT>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[m] = m_new;
        l_s[m] = l_s[m] * alpha + sum;
        alpha_s[m] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < mv * D; i += kThreads) {
      const int m = i / D;
      const int d = i % D;
      const float* pr = p_s + m * kBlockN;
      float a = acc_s[i] * alpha_s[m];
      for (int n = 0; n < nv; ++n) a = fmaf(pr[n], v_s[n * D + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < mv * D; i += kThreads) {
    const float l = l_s[i / D];
    store(out + i, acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// Dynamic shared memory of one block: Q, K (padded), V, P, acc, m/l/alpha.
size_t smem_bytes(int d) {
  return sizeof(float) * (2 * kBlockM * d + kBlockN * (d + 1) + kBlockN * d +
                          kBlockM * kBlockN + 3 * kBlockM);
}

template <typename QT, typename KT>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  const int rows = p.group * p.t;
  const dim3 grid((rows + kBlockM - 1) / kBlockM, p.hkv, batch);
  const size_t smem = smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      decode_attention_kernel<QT, KT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decode_attention_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int penroz_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, int length, const void* slopes,
    void* out, int batch, int hq, int hkv, int t, int s, int d, int q_dtype,
    int window, float scale, float softcap, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.length = length;
  p.slopes = static_cast<const float*>(slopes);
  p.out = out;
  p.hkv = hkv;
  p.t = t;
  p.s = s;
  p.d = d;
  p.group = hq / hkv;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quantized = k_scale != nullptr;
  if (q_dtype == 0)
    return quantized ? launch<float, int8_t>(p, batch, st)
                     : launch<float, float>(p, batch, st);
  if (q_dtype == 1)
    return quantized ? launch<__nv_bfloat16, int8_t>(p, batch, st)
                     : launch<__nv_bfloat16, __nv_bfloat16>(p, batch, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
