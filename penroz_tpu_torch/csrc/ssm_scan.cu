// Chunked gated linear attention, the SSD scan (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/ssm_scan.py `gla_chunked` (pallas_call at
// :101).  Same contract: q, k (B, T, H, dk) and v (B, T, H, dv), fp32 or
// bf16, any strides with a contiguous last dim; gates g (B, T, H) fp32 in
// (0, 1); y (B, T, H, dv) fp32.  With la the inclusive cumsum of
// log(max(g, 1e-6)) inside a chunk of L tokens (last token L - 1):
//
//   local_c = (K_c . e^{la_L - la})^T V_c                  (dk x dv)
//   S_c     = e^{la_L(c)} S_{c-1} + local_c,  S_{-1} = 0
//   y_c     = e^{la} (Q_c S_{c-1}) + ((Q_c K_c^T) . causal e^{la_t - la_j}) V_c
//
// The log floor is applied per token, so the algebra is exact for any
// chunk length: this kernel cuts the sequence into its own 64-token tiles,
// whatever block_t the caller's plain version uses.  The ragged tail reads
// as g = 1, q = k = v = 0 and is never written.  Every exponent is <= 0,
// so each factor lies in (0, 1].
//
// Design: chunk-parallel work with a carry pass, in one launch.  Each
// block takes one (b, h, 64-token tile) by an atomic ticket, chunk-major:
// every tile a tile waits on holds a lower ticket, so it is running or
// done and no block waits on one not yet scheduled; the ticket wraps to
// zero on the last tile, so one per-device buffer serves every launch.  A
// tile loads K, V (cp.async group 0) and Q (group 1), scans its log-gates
// with warp shuffles, computes local_c into its scratch slot and publishes
// it: a 64-bit flag holding this launch's epoch (no reset between
// launches) and the tile's la_L.  Every `stride`-th tile is a checkpoint:
// it sums its carry at once and publishes S_c instead.  A tile's carry is
// the last checkpoint's S and the locals after it, newest first, each
// times e^{sum of the later tiles' la_L}: a fixed recipe, so two launches
// give the same bits; a tile reads at most `stride` slots, and the serial
// chain runs through the checkpoints only.  The causal triangle's work is
// split evenly: warp w computes the scores of key blocks w and 7 - w
// (five 16 x 8 blocks for every warp) and stages them in shared memory
// over the K buffer; then each warp computes A V and e^{la} (Q S_{c-1})
// for its own output columns of all 64 rows, and writes y from the mma
// fragments.  The other tiles sum their carry after A V.  One launch
// rather than one kernel a pass: the slots stay in L2, no pass waits for
// a kernel boundary, and at B 1, where every tile is resident at once,
// the carry's waits overlap the tiles' own products.
//
// Tensor cores at fp32 accuracy.  Every product is mma.sync m16n8k8 tf32
// with an fp32 accumulator; an fp32 operand is split into hi = tf32(a) and
// lo = tf32(a - hi), and a.b is summed as lo.hi' + hi.lo' + hi.hi' (3xTF32,
// relative error ~2^-21; one pass keeps ~2^-11, over the 1e-4 tolerance).
// bf16 inputs are exact in tf32 (lo = 0): Q K^T then takes one pass, as a
// bf16 mma would, and each product with one decayed or carried operand
// two.  Fragment loads are conflict-free: rows of Q, K, V and the staged
// scores padded to 4 (mod 32 words, times an odd number), the carry's to
// 8, and the token axis of a product's k dimension read in the order
// (2i, 2i+1); the staged scores are stored in that order.  The main case has no branch inside its mma loops (full 64-column
// passes, each warp's pair of key blocks a template argument).
//
// Shared memory at dk = dv = 64: Q, K, V (64 x 68 floats each) and the
// carry (64 x 72), 71 KB: three blocks an SM; at dk = dv = 128, 171 KB:
// one.  Residency, not a ring inside the block, overlaps one tile's loads
// with another's products (a second buffer of Q, K, V would cut it to one).
//
// What bounds it, on an NVIDIA H100 80GB HBM3 at 700 W: at GPT-2 width
// (12 heads, dk = dv = 64, B 8, T 1024, fp32) the inputs and output are
// 101 MB, 0.030 ms at 3.35 TB/s; the tiles' products, causal blocks
// skipped, are 3.9 G multiply-adds in 3xTF32, 0.025 ms at the 320 TFLOP/s
// that mma.sync TF32 reaches on that card (scripts/torch_mma_peak.py).
// The kernel takes about 4x that, and 9x its bound at B 1 (PERF.md,
// section 6): a tile is latency-bound (scripts/torch_gla_timeline.py),
// its loads, its carry's L2 reads and its three-pass products each taking
// microseconds that three blocks an SM do not hide.  Not done: wgmma,
// persistent blocks that prefetch the next tile.
//
// Plain C interface for ctypes; the launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // tokens a tile
constexpr int kWarps = 4;             // each warp owns 16 of the tile's rows
constexpr int kThreads = 32 * kWarps;
constexpr int kPanel = 64;            // output columns a pass: 8 n-blocks
constexpr int kMaxStride = 8;         // the most slots a tile sums
constexpr float kLogEps = 1e-6f;

// Shared-memory layout (offsets in floats).  Leading dims: Q, K, V rows
// 4 x odd words, the carry's 8 x odd: every fragment load hits 32 banks.
// The K buffer also holds the tile's decayed scores (pitch lda) once every
// warp has read K.
struct Layout {
  int ldk, ldv, lds, lda;
  int q, k, v, s, la, el, w, coef, lsv, total;
};

__host__ __device__ inline Layout layout(int dk16, int dv8) {
  Layout L;
  L.ldk = dk16 + 4;
  L.ldv = dv8 + 4;
  L.lds = dv8 + 8 + 8 * ((dv8 / 8) & 1);
  L.lda = kTile + 4;
  L.q = 0;
  L.k = L.q + kTile * L.ldk;
  L.v = L.k + kTile * (L.ldk > L.lda ? L.ldk : L.lda);
  L.s = L.v + kTile * L.ldv;
  L.la = L.s + dk16 * L.lds;
  L.el = L.la + kTile;
  L.w = L.el + kTile;
  L.coef = L.w + kTile;
  L.lsv = L.coef + kMaxStride;
  L.total = L.lsv + kMaxStride;
  return L;
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* g;
  float* y;
  float* states;  // (B H, n, dk16 x dv8): local_c, or S_c at checkpoints
  // [0] the ticket (low word), then (B H, n) flags: epoch | la_L << 32
  unsigned long long* flags;
  long long qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh;
  int B, T, H, dk, dv, dk16, dv8, n, stride, epoch;
};

// -- PTX helpers ---------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// hi = tf32(x), lo = tf32(x - hi); lo = 0 where x is exact in tf32
template <bool EXACT, int N>
__device__ __forceinline__ void split(const float (&x)[N], uint32_t (&hi)[N],
                                      uint32_t (&lo)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hi[i] = EXACT ? __float_as_uint(x[i]) : tf32(x[i]);
    lo[i] = EXACT ? 0u : tf32(x[i] - __uint_as_float(hi[i]));
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b at fp32 accuracy: the small products first, then hi.hi'
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (!AX) mma(c, al, bh);
  if (!BX) mma(c, ah, bl);
  mma(c, ah, bh);
}

// acc[nb] += a b[nb] for the panel's n-blocks, b[nb] = (p[nb * nstride],
// p[nb * nstride + step]): the B fragment rows (tq, tq + 4) of n-block nb.
// FULL: all eight, with no branch between the mma, which ptxas can then
// interleave across the accumulators.
template <bool AX, bool BX, bool FULL>
__device__ __forceinline__ void mma_row(float (&acc)[8][4],
                                        const uint32_t (&ah)[4],
                                        const uint32_t (&al)[4],
                                        const float* p, int nstride, int step,
                                        int nnb) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb) {
    if (FULL || nb < nnb) {
      const float x[2] = {p[nb * nstride], p[nb * nstride + step]};
      uint32_t bh[2], bl[2];
      split<BX>(x, bh, bl);
      mma3<AX, BX>(acc[nb], ah, al, bh, bl);
    }
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A tile's flag: this launch's epoch and its la_L in one 64-bit word
__device__ __forceinline__ void publish(unsigned long long* flag, int epoch,
                                        float last) {
  const unsigned long long v =
      static_cast<unsigned long long>(__float_as_uint(last)) << 32 |
      static_cast<unsigned>(epoch);
  asm volatile("st.release.gpu.global.b64 [%0], %1;\n" ::"l"(flag), "l"(v)
               : "memory");
}

// Spin until the flag holds this epoch; its la_L.  A tile waits only on
// lower tickets, which are running or done; the bound turns a fault into a
// launch error, not a hang.
__device__ __forceinline__ float wait_for(const unsigned long long* flag,
                                          int epoch) {
  for (long long spins = 0;; ++spins) {
    unsigned long long v;
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
                 : "=l"(v)
                 : "l"(flag)
                 : "memory");
    if (static_cast<unsigned>(v) == static_cast<unsigned>(epoch))
      return __uint_as_float(static_cast<unsigned>(v >> 32));
    if (spins > (1ll << 26)) __trap();
    __nanosleep(64);
  }
}

// -- staging -------------------------------------------------------------------

// rows x d of a (token-strided) operand into dst (kTile x ld floats, d16
// columns), zero past `rows` and past d.  fp32 by cp.async (16-byte copies
// where VEC: pointer, strides and d multiples of 4); bf16 through registers.
template <typename E, bool VEC>
__device__ __forceinline__ void stage(float* dst, int ld, const E* src,
                                      long long st, int rows, int d,
                                      int d16) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(E) == 4) {
    if constexpr (VEC) {
      const int per = d16 / 4;
      for (int i = tid; i < kTile * per; i += kThreads) {
        const int r = i / per, c = (i % per) * 4;
        const bool ok = r < rows && c < d;
        cp_async16(dst + r * ld + c, ok ? src + r * st + c : src, ok);
      }
    } else {
      for (int i = tid; i < kTile * d16; i += kThreads) {
        const int r = i / d16, c = i % d16;
        const bool ok = r < rows && c < d;
        cp_async4(dst + r * ld + c, ok ? src + r * st + c : src, ok);
      }
    }
  } else {
    if constexpr (VEC) {  // 8 bf16 (16 bytes) a copy
      const int per = d16 / 8;
      for (int i = tid; i < kTile * per; i += kThreads) {
        const int r = i / per, c = (i % per) * 8;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (r < rows && c < d)
          raw = __ldg(reinterpret_cast<const uint4*>(src + r * st + c));
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
        float f[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          f[2 * j] = __uint_as_float(w[j] << 16);
          f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
        }
        float4* out = reinterpret_cast<float4*>(dst + r * ld + c);
        out[0] = make_float4(f[0], f[1], f[2], f[3]);
        out[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    } else {
      for (int i = tid; i < kTile * d16; i += kThreads) {
        const int r = i / d16, c = i % d16;
        dst[r * ld + c] =
            r < rows && c < d ? __bfloat162float(src[r * st + c]) : 0.f;
      }
    }
  }
}

// -- the carry -----------------------------------------------------------------

// S_{c-1} into Ss: the last checkpoint's inclusive state and the locals
// after it (slots j0 .. c-1), newest first, each times e^{sum of the later
// tiles' la_L}.  At a checkpoint also S_c = e^{la_L} S_{c-1} + local_c into
// its own slot, then published.  Warp 0 waits for the flags and forms the
// coefficients alone (the other warps may still be in their A V); then a
// thread sums, slot by slot, eight element chunks at a time: one L2 round
// trip a slot.
__device__ __forceinline__ void carry(const Params& p, const Layout& L,
                                      float* smem, int c, int bh,
                                      bool checkpoint, float last) {
  const int tid = threadIdx.x, n = p.n;
  const int slot_size = p.dk16 * p.dv8;
  const int cp = (c / p.stride) * p.stride - 1;  // -1: none yet
  const int j0 = max(cp, 0), m = c - j0;         // m <= stride
  float* coef = smem + L.coef;
  float* lsv = smem + L.lsv;
  unsigned long long* flags = p.flags + 1 + bh * n;
  if (tid < 32) {
    if (tid < m) lsv[tid] = wait_for(flags + j0 + tid, p.epoch);
    __syncwarp();
    if (tid == 0) {  // coef[i]: slot j0 + i's weight
      float r = 0.f;
      for (int i = m - 1; i >= 0; --i) {
        coef[i] = expf(r);
        if (j0 + i > cp) r += lsv[i];
      }
    }
  }
  __syncthreads();
  const float own = expf(last);
  const float* __restrict__ base =
      p.states + static_cast<size_t>(bh * n + j0) * slot_size;
  float* __restrict__ mine =
      p.states + static_cast<size_t>(bh * n + c) * slot_size;
  float* Ss = smem + L.s;
  constexpr int kU = 8;  // element chunks of 4 a thread holds at once
  for (int e0 = 4 * tid; e0 < slot_size; e0 += 4 * kThreads * kU) {
    float4 acc[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int i = m - 1; i >= 0; --i) {
      const float f = coef[i];
      const float* src = base + static_cast<size_t>(i) * slot_size;
      float4 x[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int e = e0 + 4 * kThreads * u;
        if (e < slot_size)
          x[u] = __ldcg(reinterpret_cast<const float4*>(src + e));
      }
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        acc[u].x += f * x[u].x;
        acc[u].y += f * x[u].y;
        acc[u].z += f * x[u].z;
        acc[u].w += f * x[u].w;
      }
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int e = e0 + 4 * kThreads * u;
      if (e >= slot_size) break;
      const int row = e / p.dv8, col = e % p.dv8;
      *reinterpret_cast<float4*>(Ss + row * L.lds + col) = acc[u];
      if (checkpoint) {
        float4* to = reinterpret_cast<float4*>(mine + e);
        const float4 loc = __ldcg(to);
        *to = make_float4(own * acc[u].x + loc.x, own * acc[u].y + loc.y,
                          own * acc[u].z + loc.z, own * acc[u].w + loc.w);
      }
    }
  }
  if (checkpoint) __threadfence();
  __syncthreads();
  if (tid == 0 && checkpoint) publish(flags + c, p.epoch, last);
}

// -- the tile's scores and outputs ----------------------------------------------

// Scores A = (Q K^T) . causal e^{la_t - la_j} of key blocks W and 7 - W
// (8 keys each) against the row blocks (16 rows) that see them: five
// blocks for every warp, so the causal triangle's work is split evenly.
// Once every warp has read K they go to As, over the K buffer, key 2t of a
// block at its column t and key 2t + 1 at t + 4: the order in which A V
// reads them as A fragments.
template <int W, bool X>
__device__ __forceinline__ void warp_scores(const Params& p, const Layout& L,
                                            float* smem) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  const float* Qs = smem + L.q;
  const float* Ks = smem + L.k;
  const float* la = smem + L.la;
  constexpr int n0 = 4 - W / 2;  // row blocks that see key block W
  const int ksteps_f = (p.dk + 7) / 8;
  float sc[5][4] = {};
  for (int ks = 0; ks < ksteps_f; ++ks) {
    uint32_t bh[2][2], bl[2][2];  // K fragments of key blocks W, 7 - W
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const float* kp = Ks + ((k ? 7 - W : W) * 8 + gq) * L.ldk + ks * 8 + tq;
      const float x[2] = {kp[0], kp[4]};
      split<X>(x, bh[k], bl[k]);
    }
#pragma unroll
    for (int u = 0; u < 5; ++u) {
      const int rb = u < n0 ? W / 2 + u : (7 - W) / 2 + u - n0;
      const float* qp = Qs + (rb * 16 + gq) * L.ldk + ks * 8 + tq;
      const float a[4] = {qp[0], qp[8 * L.ldk], qp[4], qp[8 * L.ldk + 4]};
      uint32_t ah[4], al[4];
      split<X>(a, ah, al);
      const int k = u < n0 ? 0 : 1;
      mma3<X, X>(sc[u], ah, al, bh[k], bl[k]);
    }
  }
  __syncthreads();  // every warp is done with K
  float* As = smem + L.k;
#pragma unroll
  for (int u = 0; u < 5; ++u) {
    const int kb = u < n0 ? W : 7 - W;
    const int rb = u < n0 ? W / 2 + u : (7 - W) / 2 + u - n0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = rb * 16 + gq + 8 * half;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int j = kb * 8 + 2 * tq + k;
        As[t * L.lda + kb * 8 + tq + 4 * k] =
            j <= t ? sc[u][2 * half + k] * expf(la[t] - la[j]) : 0.f;
      }
    }
  }
  __syncthreads();
}

// y = e^{la} (Q S_{c-1}) + A V: warp w takes the column blocks (8 columns)
// w and w + 4 of every 64-column pass, for all 64 rows.  A tile that is no
// checkpoint sums its carry after its first A V, so that the wait for the
// carry's flags overlaps the tile's own products.
template <bool X, bool FULL>
__device__ __forceinline__ void tile_outputs(const Params& p, const Layout& L,
                                             float* smem, int c, int bh,
                                             int rows, bool late, float last,
                                             float* yb) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const float* Qs = smem + L.q;
  const float* As = smem + L.k;
  const float* Vs = smem + L.v;
  const float* Ss = smem + L.s;
  const float* el = smem + L.el;
  const int ksteps_f = (p.dk + 7) / 8;
  const int nblocks = p.dv8 / 8;
  const size_t y_t = static_cast<size_t>(p.H) * p.dv;
  const bool pairs = (p.dv & 1) == 0;
  for (int pass = 0; pass * 8 < nblocks; ++pass) {
    const int nbs[2] = {pass * 8 + warp, pass * 8 + warp + 4};
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) ok[i] = FULL || nbs[i] < nblocks;
    // A V: each key block's V fragments split once, for the row blocks
    // that see it (every accumulator still sums its key blocks in order)
    float acc[4][2][4] = {};
#pragma unroll
    for (int kb = 0; kb < 8; ++kb) {
      const float* vp = Vs + (kb * 8 + 2 * tq) * L.ldv + gq;
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (ok[i]) {
          const float x[2] = {vp[nbs[i] * 8], vp[nbs[i] * 8 + L.ldv]};
          split<X>(x, bh[i], bl[i]);
        }
      }
#pragma unroll
      for (int rb = kb / 2; rb < 4; ++rb) {
        const float* ap = As + (rb * 16 + gq) * L.lda + kb * 8 + tq;
        const float a[4] = {ap[0], ap[8 * L.lda], ap[4], ap[8 * L.lda + 4]};
        uint32_t ah[4], al[4];
        split<false>(a, ah, al);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          if (ok[i]) mma3<false, X>(acc[rb][i], ah, al, bh[i], bl[i]);
      }
    }
    if (pass == 0 && late) carry(p, L, smem, c, bh, false, last);
    if (c > 0) {  // Q S_{c-1}: each k-step's S fragments split once
      float q_s[4][2][4] = {};
      for (int ks = 0; ks < ksteps_f; ++ks) {
        const float* sp = Ss + (ks * 8 + tq) * L.lds + gq;
        uint32_t bh[2][2], bl[2][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          if (ok[i]) {
            const float x[2] = {sp[nbs[i] * 8], sp[nbs[i] * 8 + 4 * L.lds]};
            split<false>(x, bh[i], bl[i]);
          }
        }
#pragma unroll
        for (int rb = 0; rb < 4; ++rb) {
          const float* qp = Qs + (rb * 16 + gq) * L.ldk + ks * 8 + tq;
          const float a[4] = {qp[0], qp[8 * L.ldk], qp[4],
                              qp[8 * L.ldk + 4]};
          uint32_t ah[4], al[4];
          split<X>(a, ah, al);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            if (ok[i]) mma3<X, false>(q_s[rb][i], ah, al, bh[i], bl[i]);
        }
      }
#pragma unroll
      for (int rb = 0; rb < 4; ++rb) {
        const float ea = el[rb * 16 + gq], eb = el[rb * 16 + gq + 8];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          acc[rb][i][0] += ea * q_s[rb][i][0];
          acc[rb][i][1] += ea * q_s[rb][i][1];
          acc[rb][i][2] += eb * q_s[rb][i][2];
          acc[rb][i][3] += eb * q_s[rb][i][3];
        }
      }
    }
#pragma unroll
    for (int rb = 0; rb < 4; ++rb) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = nbs[i] * 8 + 2 * tq;
        if (!ok[i] || col >= p.dv) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = rb * 16 + gq + 8 * half;
          if (r >= rows) continue;
          float* out = yb + r * y_t + col;
          const float x0 = acc[rb][i][2 * half];
          const float x1 = acc[rb][i][2 * half + 1];
          if (pairs) {
            *reinterpret_cast<float2*>(out) = make_float2(x0, x1);
          } else {
            out[0] = x0;
            if (col + 1 < p.dv) out[1] = x1;
          }
        }
      }
    }
  }
}

// -- the kernel ----------------------------------------------------------------

template <typename E, bool VEC, bool FULL>
__global__ void __launch_bounds__(kThreads, 3)
gla_chunked_kernel(const Params p) {
  constexpr bool X = sizeof(E) == 2;  // inputs exact in tf32
  extern __shared__ __align__(16) float smem[];
  __shared__ int tile_s;
  __shared__ float last_s;
  const int dk16 = p.dk16, dv8 = p.dv8;
  const Layout L = layout(dk16, dv8);
  float* Qs = smem + L.q;
  float* Ks = smem + L.k;
  float* Vs = smem + L.v;
  float* la = smem + L.la;
  float* el = smem + L.el;
  float* wt = smem + L.w;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;  // fragment row group, column
  const int BH = p.B * p.H, n = p.n;
  if (tid == 0)
    tile_s = static_cast<int>(atomicInc(reinterpret_cast<unsigned*>(p.flags),
                                        static_cast<unsigned>(BH * n - 1)));
  __syncthreads();
  const int tile = tile_s;
  const int c = tile / BH, bh = tile % BH;
  const int b = bh / p.H, h = bh % p.H;
  const int t0 = c * kTile, rows = min(kTile, p.T - t0);
  float* slot = p.states + static_cast<size_t>(bh * n + c) * (dk16 * dv8);

  const E* qb = static_cast<const E*>(p.q) + b * p.qsb + h * p.qsh + t0 * p.qst;
  const E* kb = static_cast<const E*>(p.k) + b * p.ksb + h * p.ksh + t0 * p.kst;
  const E* vb = static_cast<const E*>(p.v) + b * p.vsb + h * p.vsh + t0 * p.vst;
  stage<E, VEC>(Ks, L.ldk, kb, p.kst, rows, p.dk, dk16);
  stage<E, VEC>(Vs, L.ldv, vb, p.vst, rows, p.dv, dv8);
  cp_async_commit();
  stage<E, VEC>(Qs, L.ldk, qb, p.qst, rows, p.dk, dk16);
  cp_async_commit();

  // log-gates: two tokens a lane, an inclusive warp-shuffle scan
  if (warp == 0) {
    const float* gb = p.g + (static_cast<size_t>(b) * p.T + t0) * p.H + h;
    const int r = 2 * lane;
    const float l0 =
        r < rows ? logf(fmaxf(gb[static_cast<size_t>(r) * p.H], kLogEps))
                 : 0.f;
    const float l1 =
        r + 1 < rows
            ? logf(fmaxf(gb[static_cast<size_t>(r + 1) * p.H], kLogEps))
            : 0.f;
    float s = l0 + l1;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, s, off);
      if (lane >= off) s += o;
    }
    float excl = __shfl_up_sync(0xffffffffu, s, 1);
    if (lane == 0) excl = 0.f;
    const float a0 = excl + l0, a1 = a0 + l1;
    const float last = __shfl_sync(0xffffffffu, a1, 31);
    la[r] = a0;
    la[r + 1] = a1;
    el[r] = expf(a0);
    el[r + 1] = expf(a1);
    wt[r] = expf(last - a0);
    wt[r + 1] = expf(last - a1);
    if (lane == 0) last_s = last;
  }
  cp_async_wait<1>();
  __syncthreads();
  const float last = last_s;

  // local_c = (K . w)^T V: a warp takes 16 rows of dk by a 64-column panel
  if (c < n - 1) {
    const int mblocks = dk16 / 16;
    const int npan = (dv8 + kPanel - 1) / kPanel;
    const int ksteps_t = (rows + 7) / 8;  // token steps with any real row
    for (int task = warp; task < mblocks * npan; task += kWarps) {
      const int m0 = (task % mblocks) * 16, n0 = (task / mblocks) * kPanel;
      const int nnb = min(8, (dv8 - n0) / 8);
      float acc[8][4] = {};
      for (int ks = 0; ks < ksteps_t; ++ks) {
        const int r0 = ks * 8 + 2 * tq;  // tokens r0, r0 + 1
        const float w0 = wt[r0], w1 = wt[r0 + 1];
        const float* kp = Ks + r0 * L.ldk + m0 + gq;
        const float a[4] = {kp[0] * w0, kp[8] * w0, kp[L.ldk] * w1,
                            kp[L.ldk + 8] * w1};
        uint32_t ah[4], al[4];
        split<false>(a, ah, al);
        mma_row<false, X, FULL>(acc, ah, al, Vs + r0 * L.ldv + n0 + gq, 8,
                                L.ldv, nnb);
      }
      float* out = slot + (m0 + gq) * dv8 + n0 + 2 * tq;
#pragma unroll
      for (int nb = 0; nb < 8; ++nb) {
        if (FULL || nb < nnb) {
          *reinterpret_cast<float2*>(out + nb * 8) =
              make_float2(acc[nb][0], acc[nb][1]);
          *reinterpret_cast<float2*>(out + 8 * dv8 + nb * 8) =
              make_float2(acc[nb][2], acc[nb][3]);
        }
      }
    }
    __threadfence();
  }
  const bool checkpoint = c > 0 && c % p.stride == p.stride - 1 && c < n - 1;
  __syncthreads();
  if (tid == 0 && c < n - 1 && !checkpoint)
    publish(p.flags + 1 + bh * n + c, p.epoch, last);
  // a checkpoint publishes first: the tiles after it wait on its state
  if (checkpoint) carry(p, L, smem, c, bh, true, last);
  cp_async_wait<0>();
  __syncthreads();

  const bool late = c > 0 && !checkpoint;
  switch (warp) {
    case 0: warp_scores<0, X>(p, L, smem); break;
    case 1: warp_scores<1, X>(p, L, smem); break;
    case 2: warp_scores<2, X>(p, L, smem); break;
    default: warp_scores<3, X>(p, L, smem); break;
  }
  float* yb = p.y + ((static_cast<size_t>(b) * p.T + t0) * p.H + h) * p.dv;
  tile_outputs<X, FULL>(p, L, smem, c, bh, rows, late, last, yb);
}

// -- host launcher ---------------------------------------------------------------

int round_up(int x, int m) { return (x + m - 1) / m * m; }

size_t smem_bytes(int dk, int dv) {
  return static_cast<size_t>(layout(round_up(dk, 16), round_up(dv, 8)).total) *
         sizeof(float);
}

template <typename E, bool VEC, bool FULL>
cudaError_t launch_as(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.dk, p.dv);
  cudaError_t err = cudaFuncSetAttribute(
      gla_chunked_kernel<E, VEC, FULL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  gla_chunked_kernel<E, VEC, FULL>
      <<<p.B * p.H * p.n, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// FULL: every output panel 64 columns wide (dv a multiple of 64)
template <typename E, bool VEC>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  return p.dv8 % kPanel == 0 ? launch_as<E, VEC, true>(p, stream)
                             : launch_as<E, VEC, false>(p, stream);
}

}  // namespace

// Dynamic shared memory a block takes at dk, dv.
extern "C" int penroz_gla_smem_bytes(int dk, int dv) {
  return static_cast<int>(smem_bytes(dk, dv));
}

// y (B, T, H, dv) fp32; strides in elements (batch, token, head) of q, k,
// v; states: B H n x round_up(dk, 16) x round_up(dv, 8) fp32 scratch;
// flags: 64-bit, [0] the ticket (left at zero), then B H n flags, none
// holding `epoch` on entry; every `stride`-th tile (2 <= stride <= 8)
// publishes its inclusive state; vec: 16-byte aligned pointers and strides.
extern "C" int penroz_gla_chunked(
    const void* q, const void* k, const void* v, const void* g, void* y,
    void* states, void* flags, int B, int T, int H, int dk,
    int dv, int stride, int epoch, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, int dtype, int vec,
    void* stream) {
  if (stride < 2 || stride > kMaxStride || B * H <= 0 || T <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.g = static_cast<const float*>(g);
  p.y = static_cast<float*>(y);
  p.states = static_cast<float*>(states);
  p.flags = static_cast<unsigned long long*>(flags);
  p.qsb = qsb; p.qst = qst; p.qsh = qsh;
  p.ksb = ksb; p.kst = kst; p.ksh = ksh;
  p.vsb = vsb; p.vst = vst; p.vsh = vsh;
  p.B = B; p.T = T; p.H = H; p.dk = dk; p.dv = dv;
  p.dk16 = round_up(dk, 16);
  p.dv8 = round_up(dv, 8);
  p.n = (T + kTile - 1) / kTile;
  p.stride = stride;
  p.epoch = epoch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vec ? launch<float, true>(p, st) : launch<float, false>(p, st);
  if (dtype == 1)
    return vec ? launch<__nv_bfloat16, true>(p, st)
               : launch<__nv_bfloat16, false>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
