// The cached recurrent update of a gated-SSM layer: dense and packed (sm_90a).
//
// Replaces no pallas_call: it is the port's form of the JAX package's
// `lax.scan`s in penroz_tpu/ops/ssm.py, `SSMState.update_dense` (:216) and
// `SSMState.update_packed` (:248), each one program there.  Per row and
// head, token by token, in fp32 (inputs fp32 or bf16, cast on load):
//
//   S_t = g_t * S_{t-1} + k_t (x) v_t        (dk x dv)
//   y_t = q_t . S_t                          (dv)
//
// and the post-token state goes to ring slot pa % C of the row's
// checkpoints, with key pa (the length after the token) in ckpt_pos.
//
// One launch serves both forms.  The packed form walks the (NB, 4)
// descriptors (row, q_pos0, q_valid, kv_len) of ops/kv_cache.py
// `build_descriptors` in order: slot p = blk * block_q + t is token t of
// block blk and updates its row when t < q_valid; a padding block (row -1)
// or a row past the state's batch is never read or written.  The dense
// form is the packed form with one block of T slots a row, starting at
// start[b] and taking its first count[b] tokens (all T without counts).
// A dropped slot's y is left as the caller zeroed it.
//
// Design (simple first): one thread block of 32 threads a (row, head,
// 32-column tile of dv).  Each thread keeps its column of the row's state
// in registers (dk <= 128, padded to 32, 64 or 128 with zero rows), walks
// the descriptors in order and skips other rows' blocks.  For each valid
// slot, q and k go through shared memory, v and the gate are read by each
// thread, and the column is updated and dotted with q: no reduction across
// threads.  The state is written once at the end; the ring is written for
// the last min(C, n) of the row's n slots only (a row's slots in one launch
// are consecutive positions, one span, so the earlier ones' slots are
// overwritten by the JAX scan anyway), and ckpt_pos by the (column tile 0,
// head 0) block.  S = g*S + k*v is rounded as two products and a sum, as
// the plain version's elementwise ops are; y sums over dk in order with
// fmaf.  The arithmetic of a token is the same in both forms, so a row's
// state bits do not depend on how its tokens were cut into launches.
//
// What bounds it: the bytes.  A slot reads q, k, v (H (2 dk + dv) values)
// and its gate and writes y; the state is read and written once a row and
// layer, and min(C, n) ring slots written; 2 dk dv multiply-adds a slot and
// head are far below the card's rate.  The simple design does not reach
// that bound: each slot's loads wait on the previous slot's compute (no
// prefetch), and a (row, head) has only dv / 32 blocks, so a decode step
// or a single-row prefill is latency-bound.  Not done: several blocks a
// (row, head) over slices of dk with a reduction of y, prefetching the next
// slot's q and k.
//
// The launch allocates nothing and reads no host value, so it can be
// captured in a CUDA graph (graph decode replays it).  Plain C interface
// for ctypes; the launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;  // columns of dv a thread block (one warp)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  float* y;                 // (Tp, H, dv), zeroed by the caller
  float* state;             // (B, H, dk, dv)
  float* ckpt;              // (B, C, H, dk, dv)
  int* ckpt_pos;            // (B, C)
  const int* descs;         // packed: (NB, 4); null for the dense form
  const long long* starts;  // dense: (B,) first position of each row
  const long long* counts;  // dense: (B,) tokens taken, or null (all)
  unsigned long long* runs; // or null: one added a launch that runs
  int B, NB, block_q, H, dk, dv, C;
  long long q_ts, q_hs, k_ts, k_hs, v_ts, v_hs, g_ts;
};

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// Block blk's (row, first position, valid tokens) in either form.
__device__ __forceinline__ void block_of(const Params& p, int blk, int& row,
                                         long long& pos0, int& valid) {
  if (p.descs != nullptr) {
    const int* d = p.descs + 4 * blk;
    row = d[0];
    pos0 = d[1];
    valid = min(d[2], p.block_q);
  } else {
    row = blk;
    pos0 = p.starts[blk];
    valid = p.counts != nullptr
                ? (int)min(p.counts[blk], (long long)p.block_q)
                : p.block_q;
  }
}

template <typename T, int DKP>
__global__ void __launch_bounds__(kCols)
    ssm_update_kernel(const Params p) {
  const int h = blockIdx.y, row = blockIdx.z;
  const int c = blockIdx.x * kCols + threadIdx.x;
  const bool live = c < p.dv;
  if (p.runs != nullptr && threadIdx.x == 0 &&
      blockIdx.x + blockIdx.y + blockIdx.z == 0)
    atomicAdd(p.runs, 1ull);

  // this row's slots in the launch
  int n = 0;
  for (int blk = 0; blk < p.NB; ++blk) {
    int r, valid;
    long long pos0;
    block_of(p, blk, r, pos0, valid);
    if (r == row && valid > 0) n += valid;
  }
  if (n == 0) return;

  __shared__ float sq[DKP];
  __shared__ float sk[DKP];
  const T* q = static_cast<const T*>(p.q);
  const T* k = static_cast<const T*>(p.k);
  const T* v = static_cast<const T*>(p.v);
  const long long sbase = ((long long)row * p.H + h) * p.dk * p.dv;

  float S[DKP];
#pragma unroll
  for (int i = 0; i < DKP; ++i)
    S[i] = (live && i < p.dk) ? p.state[sbase + (long long)i * p.dv + c]
                              : 0.f;

  const bool pos_writer = blockIdx.x == 0 && h == 0 && threadIdx.x == 0;
  int seen = 0;
  for (int blk = 0; blk < p.NB; ++blk) {
    int r, valid;
    long long pos0;
    block_of(p, blk, r, pos0, valid);
    if (r != row || valid <= 0) continue;
    for (int t = 0; t < valid; ++t, ++seen) {
      const long long slot = (long long)blk * p.block_q + t;
      __syncwarp();  // the previous slot's readers are done with sq, sk
      for (int i = threadIdx.x; i < DKP; i += kCols) {
        const bool in = i < p.dk;
        sq[i] = in ? load(q + slot * p.q_ts + h * p.q_hs + i) : 0.f;
        sk[i] = in ? load(k + slot * p.k_ts + h * p.k_hs + i) : 0.f;
      }
      const float vc = live ? load(v + slot * p.v_ts + h * p.v_hs + c) : 0.f;
      const float gt = p.g[slot * p.g_ts + h];
      __syncwarp();
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < DKP; ++i) {
        S[i] = __fadd_rn(__fmul_rn(gt, S[i]), __fmul_rn(sk[i], vc));
        acc = fmaf(sq[i], S[i], acc);
      }
      if (live) p.y[(slot * p.H + h) * p.dv + c] = acc;
      if (seen >= n - p.C) {
        const long long pa = pos0 + t + 1;
        const int ring = (int)(pa % p.C);
        if (live) {
          float* dst = p.ckpt +
                       ((((long long)row * p.C + ring) * p.H + h) * p.dk) *
                           p.dv + c;
#pragma unroll
          for (int i = 0; i < DKP; ++i)
            if (i < p.dk) dst[(long long)i * p.dv] = S[i];
        }
        if (pos_writer) p.ckpt_pos[(long long)row * p.C + ring] = (int)pa;
      }
    }
  }
  if (live) {
#pragma unroll
    for (int i = 0; i < DKP; ++i)
      if (i < p.dk) p.state[sbase + (long long)i * p.dv + c] = S[i];
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.dv + kCols - 1) / kCols, p.H, p.B);
  if (p.dk <= 32)
    ssm_update_kernel<T, 32><<<grid, kCols, 0, stream>>>(p);
  else if (p.dk <= 64)
    ssm_update_kernel<T, 64><<<grid, kCols, 0, stream>>>(p);
  else if (p.dk <= 128)
    ssm_update_kernel<T, 128><<<grid, kCols, 0, stream>>>(p);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 fp32, 1 bf16 (q, k and v share it; g is fp32).  descs null
// selects the dense form (starts, and counts or null).
extern "C" int penroz_ssm_update(
    const void* q, const void* k, const void* v, const void* g, void* y,
    void* state, void* ckpt, void* ckpt_pos, const void* descs,
    const void* starts, const void* counts, void* runs, int B, int NB,
    int block_q, int H, int dk, int dv, int C, long long q_ts,
    long long q_hs, long long k_ts, long long k_hs, long long v_ts,
    long long v_hs, long long g_ts, int dtype, void* stream) {
  if (B <= 0 || NB <= 0 || block_q <= 0) return cudaSuccess;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = static_cast<const float*>(g);
  p.y = static_cast<float*>(y);
  p.state = static_cast<float*>(state);
  p.ckpt = static_cast<float*>(ckpt);
  p.ckpt_pos = static_cast<int*>(ckpt_pos);
  p.descs = static_cast<const int*>(descs);
  p.starts = static_cast<const long long*>(starts);
  p.counts = static_cast<const long long*>(counts);
  p.runs = static_cast<unsigned long long*>(runs);
  p.B = B;
  p.NB = NB;
  p.block_q = block_q;
  p.H = H;
  p.dk = dk;
  p.dv = dv;
  p.C = C;
  p.q_ts = q_ts;
  p.q_hs = q_hs;
  p.k_ts = k_ts;
  p.k_hs = k_hs;
  p.v_ts = v_ts;
  p.v_hs = v_hs;
  p.g_ts = g_ts;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
