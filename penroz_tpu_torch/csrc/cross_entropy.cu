// Softmax cross-entropy over a large vocabulary, forward and backward
// (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/cross_entropy.py: `ce_forward` (pallas_call
// at :111) and `ce_backward` (:161).  Same contract: logits (N, V) fp32 or
// bf16, int32 targets (N,).  The forward writes per-row fp32 (lse, label
// logit): lse = m + log(sum exp(x - m)) over the row's V columns, and the
// label logit x[row, max(t, 0)] as the JAX package's scan oracle reads it
// (clamped to the row, so an out-of-range target never reads past it).
// The backward writes (softmax - onehot) * scale in the logits' dtype, zero
// on rows whose target is negative (the -1 pad sentinel); `scale` is a
// device scalar (the loss cotangent over N), so the host never reads it.
//
// What bounds it on an H100: bytes.  At GPT-2 training (N 8192, V 50304,
// bf16) the forward reads 824 MB and the backward reads 824 MB and writes
// 824 MB, against about 4 flops per element.  What the design does about
// it: one block per row; each thread streams 16-byte vectors of the row
// (8 elements) with an online max / sum, so the logits are read exactly
// once per pass and no fp32 copy of (N, V) is ever written; the vocab tail
// needs no mask because a block walks exactly its row's V columns.  What it
// does not do yet: split a row across blocks or prefetch asynchronously.
//
// Plain C interface for ctypes; each entry returns a cudaError_t (0 on
// success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Merge online-softmax state (m, l) with (m2, l2).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// One block per row.  kVec: V % 8 == 0, so every row starts 16-byte aligned
// and is read in 8-element vectors.
template <typename E, bool kVec>
__global__ void __launch_bounds__(kThreads)
ce_forward_kernel(const E* logits, const int* targets, float* lse, float* ll,
                  int vocab) {
  __shared__ float m_s[kWarps], l_s[kWarps];
  const int row = blockIdx.x;
  const E* x = logits + static_cast<size_t>(row) * vocab;
  float m = kNegInf, l = 0.f;
  if (kVec) {
    for (int c = threadIdx.x; c < vocab / 8; c += kThreads) {
      float v[8];
      load8(x + c * 8, v);
      float cm = v[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) cm = fmaxf(cm, v[i]);
      const float mn = fmaxf(m, cm);
      float s = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) s += expf(v[i] - mn);
      l = l * expf(m - mn) + s;
      m = mn;
    }
  } else {
    for (int c = threadIdx.x; c < vocab; c += kThreads) {
      const float v = to_float(x[c]);
      const float mn = fmaxf(m, v);
      l = l * expf(m - mn) + expf(v - mn);
      m = mn;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, off);
    merge(m, l, m2, l2);
  }
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    m = m_s[0];
    l = l_s[0];
    for (int w = 1; w < kWarps; ++w) merge(m, l, m_s[w], l_s[w]);
    lse[row] = m + logf(l == 0.f ? 1.f : l);
    ll[row] = to_float(x[min(max(targets[row], 0), vocab - 1)]);
  }
}

template <typename E, bool kVec>
__global__ void __launch_bounds__(kThreads)
ce_backward_kernel(const E* logits, const int* targets, const float* lse,
                   const float* scale, E* grad, int vocab) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * vocab;
  const E* x = logits + base;
  E* g = grad + base;
  const int t = targets[row];
  const float sc = t >= 0 ? *scale : 0.f;  // pad rows: zero gradient
  const float L = lse[row];
  if (kVec) {
    for (int c = threadIdx.x; c < vocab / 8; c += kThreads) {
      float v[8];
      load8(x + c * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        v[i] = t >= 0 ? (expf(v[i] - L) - (c * 8 + i == t ? 1.f : 0.f)) * sc
                      : 0.f;
      store8(g + c * 8, v);
    }
  } else {
    for (int c = threadIdx.x; c < vocab; c += kThreads) {
      const float v = to_float(x[c]);
      store(g + c, t >= 0 ? (expf(v - L) - (c == t ? 1.f : 0.f)) * sc : 0.f);
    }
  }
}

template <typename E>
cudaError_t forward(const void* logits, const void* targets, void* lse,
                    void* ll, int n, int vocab, cudaStream_t stream) {
  const E* x = static_cast<const E*>(logits);
  const int* t = static_cast<const int*>(targets);
  float* lse_f = static_cast<float*>(lse);
  float* ll_f = static_cast<float*>(ll);
  if (vocab % 8 == 0)
    ce_forward_kernel<E, true><<<n, kThreads, 0, stream>>>(x, t, lse_f, ll_f,
                                                            vocab);
  else
    ce_forward_kernel<E, false><<<n, kThreads, 0, stream>>>(x, t, lse_f, ll_f,
                                                             vocab);
  return cudaGetLastError();
}

template <typename E>
cudaError_t backward(const void* logits, const void* targets, const void* lse,
                     const void* scale, void* grad, int n, int vocab,
                     cudaStream_t stream) {
  const E* x = static_cast<const E*>(logits);
  const int* t = static_cast<const int*>(targets);
  const float* lse_f = static_cast<const float*>(lse);
  const float* sc = static_cast<const float*>(scale);
  E* g = static_cast<E*>(grad);
  if (vocab % 8 == 0)
    ce_backward_kernel<E, true><<<n, kThreads, 0, stream>>>(x, t, lse_f, sc, g,
                                                             vocab);
  else
    ce_backward_kernel<E, false><<<n, kThreads, 0, stream>>>(x, t, lse_f, sc,
                                                              g, vocab);
  return cudaGetLastError();
}

}  // namespace

// lse and label logit, (N,) fp32 each.
extern "C" int penroz_ce_forward(const void* logits, const void* targets,
                                 void* lse, void* ll, int n, int vocab,
                                 int dtype, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return forward<float>(logits, targets, lse, ll, n, vocab, st);
  if (dtype == 1)
    return forward<__nv_bfloat16>(logits, targets, lse, ll, n, vocab, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// (N, V) gradient in the logits' dtype.
extern "C" int penroz_ce_backward(const void* logits, const void* targets,
                                  const void* lse, const void* scale,
                                  void* grad, int n, int vocab, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return backward<float>(logits, targets, lse, scale, grad, n, vocab, st);
  if (dtype == 1)
    return backward<__nv_bfloat16>(logits, targets, lse, scale, grad, n,
                                   vocab, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
