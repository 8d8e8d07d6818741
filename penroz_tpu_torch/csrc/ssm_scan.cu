// Chunked gated linear attention, the SSD scan (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/ssm_scan.py `gla_chunked` (pallas_call at
// :101).  Same contract: q, k (B, T, H, dk) and v (B, T, H, dv), fp32 or
// bf16, gates g (B, T, H) fp32 in (0, 1); y (B, T, H, dv) fp32.  Per chunk
// of L tokens, with la the inclusive cumsum of log(max(g, 1e-6)):
//
//   y     = e^{la} (q S0) + ((q k^T) . causal e^{la_t - la_j}) v
//   S_end = e^{la_L} S0 + (k . e^{la_L - la})^T v
//
// The ragged tail reads as g = 1, q = k = v = 0 (the Pallas wrapper's
// padding): those rows leave the carry untouched and are not written.
// Every exponent is <= 0, so each factor lies in (0, 1]; e^{la_t - la_j}
// is formed from the difference, and underflows to 0 where it should.
//
// Design.  One block per (b, h).  The Pallas grid walks the chunks on an
// "arbitrary" axis with the (dk, dv) carry in VMEM scratch; here the block
// walks them in order with the carry S in shared memory, fp32 throughout.
// A chunk's K and V (rows padded by one float against bank conflicts on
// the transposed reads), its log-gate cumsum and the carry stay in shared
// memory; queries go through in tiles of 32 rows: scores (32 x keys up to
// the tile's last row, masked and decayed), then y = e^{la} (Q S0) + A V
// straight to global memory.  Last, K is scaled by e^{la_L - la} in place
// and S = e^{la_L} S + K^T V.  Every product is fp32 FMAs out of shared
// memory, each thread holding a 4 x 2 tile of the output (rows by warp,
// columns by lane: the row operand is a broadcast, the column operand
// conflict-free).  At L = 128, dk = dv = 64 a block takes 108 KB of
// shared memory (opted in above 48 KB); at dk = dv = 128, 226 KB.
//
// What bounds it on an H100: at GPT-2 width (12 heads, dk = dv = 64,
// B 8, T 1024, fp32) the inputs and output are 101 MB (0.030 ms at
// 3.35 TB/s) and the least work, the token-sequential recurrence, 1.6
// GFLOP (0.024 ms at 67 TFLOP/s fp32): bytes, by a little.  This kernel
// runs about 20x that (PERF.md): its products read 0.75 shared-memory
// operands an FMA, its chunk loads are not overlapped with the math, and
// at B 1 it fills 12 of 132 SMs.  Not done yet: chunks split across
// blocks with a carry pass, mma.sync/wgmma for the products, TMA or
// cp.async loads overlapped with the math.
//
// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRM = 4;                 // output rows per thread
constexpr int kRN = 2;                 // output columns per thread
constexpr int kTileM = kWarps * kRM;   // 32 rows a pass (query tile)
constexpr int kTileN = 32 * kRN;       // 64 columns a pass
constexpr float kLogEps = 1e-6f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// A shared-memory matrix view: element (i, j) at p[i * si + j * sj].
struct View {
  const float* p;
  int si, sj;
};

// acc[r][c] += sum_{kk < K} A(m_r, kk) B(kk, n_c) for this thread's rows
// m_r = m0 + warp + 8 r and columns n_c = n0 + lane + 32 c.  Rows past M and
// columns past N are clamped onto the last valid one (read, never stored).
__device__ __forceinline__ void accumulate(float (&acc)[kRM][kRN], View A,
                                           View B, int m0, int M, int n0,
                                           int N, int K) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int ai[kRM], bj[kRN];
#pragma unroll
  for (int r = 0; r < kRM; ++r)
    ai[r] = min(m0 + warp + kWarps * r, M - 1) * A.si;
#pragma unroll
  for (int c = 0; c < kRN; ++c) bj[c] = min(n0 + lane + 32 * c, N - 1) * B.sj;
  for (int kk = 0; kk < K; ++kk) {
    float a[kRM], b[kRN];
#pragma unroll
    for (int r = 0; r < kRM; ++r) a[r] = A.p[ai[r] + kk * A.sj];
#pragma unroll
    for (int c = 0; c < kRN; ++c) b[c] = B.p[kk * B.si + bj[c]];
#pragma unroll
    for (int r = 0; r < kRM; ++r)
#pragma unroll
      for (int c = 0; c < kRN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__host__ __device__ inline size_t smem_floats(int L, int dk, int dv) {
  // K (L x dk+1), V (L x dv), Q tile (32 x dk), scores (32 x L), S (dk x
  // dv), la, weights (L each), scan totals (32)
  return static_cast<size_t>(L) * (dk + 1) + static_cast<size_t>(L) * dv +
         static_cast<size_t>(kTileM) * dk + static_cast<size_t>(kTileM) * L +
         static_cast<size_t>(dk) * dv + 2 * static_cast<size_t>(L) + 32;
}

struct Strides {
  long long b, t, h;  // elements; the last dim is contiguous
};

template <typename E>
__global__ void __launch_bounds__(kThreads)
gla_chunked_kernel(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, const float* __restrict__ g,
                   float* __restrict__ y, int T, int H, int dk, int dv, int L,
                   Strides qs, Strides ks, Strides vs) {
  extern __shared__ float smem[];
  const int dkp = dk + 1;
  float* Ks = smem;                 // L x dkp
  float* Vs = Ks + L * dkp;         // L x dv
  float* Qs = Vs + L * dv;          // kTileM x dk
  float* As = Qs + kTileM * dk;     // kTileM x L
  float* Ss = As + kTileM * L;      // dk x dv
  float* la = Ss + dk * dv;         // L
  float* w = la + L;                // L
  float* tot = w + L;               // 32

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const E* qb = q + b * qs.b + h * qs.h;
  const E* kb = k + b * ks.b + h * ks.h;
  const E* vb = v + b * vs.b + h * vs.h;
  const float* gb = g + (static_cast<size_t>(b) * T * H + h);
  float* yb = y + (static_cast<size_t>(b) * T * H + h) * dv;
  const size_t y_t = static_cast<size_t>(H) * dv;

  for (int i = tid; i < dk * dv; i += kThreads) Ss[i] = 0.f;
  const int nchunks = (T + L - 1) / L;
  const int per = (L + 31) / 32;    // cumsum segment per lane
  for (int ch = 0; ch < nchunks; ++ch) {
    const int c0 = ch * L;
    for (int i = tid; i < L * dk; i += kThreads) {
      const int r = i / dk, col = i % dk, t = c0 + r;
      Ks[r * dkp + col] = t < T ? to_float(kb[t * ks.t + col]) : 0.f;
    }
    for (int i = tid; i < L * dv; i += kThreads) {
      const int r = i / dv, col = i % dv, t = c0 + r;
      Vs[i] = t < T ? to_float(vb[t * vs.t + col]) : 0.f;
    }
    for (int r = tid; r < L; r += kThreads) {
      const int t = c0 + r;
      la[r] = t < T ? logf(fmaxf(gb[static_cast<size_t>(t) * H], kLogEps))
                    : 0.f;
    }
    __syncthreads();
    // inclusive cumsum of the log-gates: 32 serial segments, then their
    // totals serially, then each segment's offset
    if (tid < 32) {
      float run = 0.f;
      for (int i = tid * per; i < min((tid + 1) * per, L); ++i) {
        run += la[i];
        la[i] = run;
      }
      tot[tid] = run;
    }
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < 32; ++i) {
        const float s = tot[i];
        tot[i] = run;
        run += s;
      }
    }
    __syncthreads();
    if (tid < 32) {
      for (int i = tid * per; i < min((tid + 1) * per, L); ++i)
        la[i] += tot[tid];
    }
    __syncthreads();

    for (int t0 = 0; t0 < L; t0 += kTileM) {
      const int M = min(kTileM, L - t0);
      const int J = t0 + M;  // keys this tile can attend
      for (int i = tid; i < kTileM * dk; i += kThreads) {
        const int r = i / dk, col = i % dk, t = c0 + t0 + r;
        Qs[i] = (r < M && t < T) ? to_float(qb[t * qs.t + col]) : 0.f;
      }
      __syncthreads();
      // scores: A(i, j) = (Q_i . K_j) e^{la_{t0+i} - la_j} for j <= t0 + i
      for (int n0 = 0; n0 < J; n0 += kTileN) {
        float acc[kRM][kRN] = {};
        accumulate(acc, View{Qs, dk, 1}, View{Ks, 1, dkp}, 0, M, n0, J, dk);
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int i = warp + kWarps * r;
#pragma unroll
          for (int c = 0; c < kRN; ++c) {
            const int j = n0 + lane + 32 * c;
            if (i < M && j < J)
              As[i * L + j] = t0 + i >= j
                  ? acc[r][c] * expf(la[t0 + i] - la[j]) : 0.f;
          }
        }
      }
      __syncthreads();
      // y = e^{la} (Q S0) + A V
      for (int n0 = 0; n0 < dv; n0 += kTileN) {
        float acc[kRM][kRN] = {};
        accumulate(acc, View{Qs, dk, 1}, View{Ss, dv, 1}, 0, M, n0, dv, dk);
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const float e = expf(la[min(t0 + warp + kWarps * r, L - 1)]);
#pragma unroll
          for (int c = 0; c < kRN; ++c) acc[r][c] *= e;
        }
        accumulate(acc, View{As, L, 1}, View{Vs, dv, 1}, 0, M, n0, dv, J);
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int i = warp + kWarps * r, t = c0 + t0 + i;
#pragma unroll
          for (int c = 0; c < kRN; ++c) {
            const int n = n0 + lane + 32 * c;
            if (i < M && n < dv && t < T) yb[t * y_t + n] = acc[r][c];
          }
        }
      }
      __syncthreads();  // Qs and As are rewritten by the next tile
    }

    // carry: S = e^{la_L} S + (K e^{la_L - la})^T V
    const float last = la[L - 1];
    for (int r = tid; r < L; r += kThreads) w[r] = expf(last - la[r]);
    __syncthreads();
    for (int i = tid; i < L * dk; i += kThreads) {
      const int r = i / dk, col = i % dk;
      Ks[r * dkp + col] *= w[r];
    }
    __syncthreads();
    const float decay = expf(last);
    for (int m0 = 0; m0 < dk; m0 += kTileM) {
      for (int n0 = 0; n0 < dv; n0 += kTileN) {
        float acc[kRM][kRN];
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int m = min(m0 + warp + kWarps * r, dk - 1);
#pragma unroll
          for (int c = 0; c < kRN; ++c)
            acc[r][c] = decay * Ss[m * dv + min(n0 + lane + 32 * c, dv - 1)];
        }
        accumulate(acc, View{Ks, 1, dkp}, View{Vs, dv, 1}, m0, dk, n0, dv, L);
#pragma unroll
        for (int r = 0; r < kRM; ++r) {
          const int m = m0 + warp + kWarps * r;
#pragma unroll
          for (int c = 0; c < kRN; ++c) {
            const int n = n0 + lane + 32 * c;
            if (m < dk && n < dv) Ss[m * dv + n] = acc[r][c];
          }
        }
      }
    }
    __syncthreads();  // the next chunk overwrites K, V and la
  }
}

// -- host launcher ------------------------------------------------------------

template <typename E>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* g, void* y, int B, int T, int H, int dk,
                   int dv, int L, Strides qs, Strides ks, Strides vs,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(L, dk, dv) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gla_chunked_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gla_chunked_kernel<E><<<B * H, kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(k),
      static_cast<const E*>(v), static_cast<const float*>(g),
      static_cast<float*>(y), T, H, dk, dv, L, qs, ks, vs);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory a block takes for an L-token chunk.
extern "C" int penroz_gla_smem_bytes(int L, int dk, int dv) {
  return static_cast<int>(smem_floats(L, dk, dv) * sizeof(float));
}

// y (B, T, H, dv) fp32; strides in elements (batch, token, head) of q, k, v.
extern "C" int penroz_gla_chunked(const void* q, const void* k, const void* v,
                                  const void* g, void* y, int B, int T, int H,
                                  int dk, int dv, int L, long long qsb,
                                  long long qst, long long qsh, long long ksb,
                                  long long kst, long long ksh, long long vsb,
                                  long long vst, long long vsh, int dtype,
                                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  if (dtype == 0)
    return launch<float>(q, k, v, g, y, B, T, H, dk, dv, L, qs, ks, vs, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, g, y, B, T, H, dk, dv, L, qs, ks,
                                 vs, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
