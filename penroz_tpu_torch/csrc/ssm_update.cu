// The cached recurrent update of a gated-SSM layer: dense and packed (sm_90a).
//
// Replaces no pallas_call: it is the port's form of the JAX package's
// `lax.scan`s in penroz_tpu/ops/ssm.py, `SSMState.update_dense` (:216) and
// `SSMState.update_packed` (:248), each one program there.  Per row and
// head, token by token, in fp32 (inputs fp32 or bf16, widened when used):
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
// What bounds it: the bytes, and the recurrence.  A slot reads q, k, v
// (H (2 dk + dv) values) and its gate and writes y; the state is read and
// written once a row and layer, and min(C, n) ring slots written; 2 dk dv
// multiply-adds a slot and head are far below the card's rate.  But a
// row's slots are one chain: slot t + 1's state needs slot t's, so a long
// row (a prefill chunk) takes n times the latency of one slot's update,
// however many bytes it moves.  The design keeps that latency short:
//
// - The tile spread over warps.  A thread block of 128 threads (4 warps)
//   takes a (row, head, 8-column tile of dv); thread (rg, c) of the 16 x 8
//   grid keeps rows rg R .. rg R + R - 1 of column c of the state in
//   registers (R = DKP / 16: 2, 4 or 8 for dk <= 32, 64, 128, padded with
//   zero rows).  A slot is then R independent updates a thread and a
//   partial dot of R terms, not a chain of dk.  A long row has H dv / 8
//   blocks (96 at H 12, dv 64: most of the 132 SMs).
// - Inputs fetched ahead.  A ring of 3 stages in shared memory, each of
//   up to P = 32 slots (fewer when no row of the launch has more: 1 for a
//   decode step) of the row's q and k (dk values), the tile's v columns
//   and the gates, filled by cp.async (16-, 8- or 4-byte units, the
//   largest that every base address and stride allows; 2-byte plain
//   copies for a bf16 operand aligned to less) two stages ahead of the one
//   computing.  bf16 stays bf16 in shared memory and is widened when used.
// - No branch between slots.  A full stage that writes no ring slot runs
//   its 32 slots unrolled, with each slot's partial dot in a register, so
//   a slot's shared loads overlap the previous slot's arithmetic.
// - y off the chain.  The partial dots go to shared memory once a stage is
//   computed, (slot, column) by (slot, column), and its P x 8 outputs are
//   summed over the 16 row groups in a fixed order (float4 loads; no
//   atomics: two launches agree bit for bit) and written.
// - The slot list built once.  The block's threads read the descriptors
//   once, in parallel, and an ordered block-wide scan keeps the row's
//   blocks (index, first row slot, first position) in shared memory with
//   the row's slot count n.  Where the row's blocks are consecutive and
//   all but the last full (every span build_descriptors cuts, every dense
//   row), slot j is the first block's slot + j; else a binary search of
//   the list finds it.
// - State and ring I/O.  The state tile arrives by cp.async (16-byte units
//   when dv % 4 == 0) beside the first stages and leaves once, as float4
//   rows; the ring takes the last min(C, n) of the row's slots only (a
//   row's slots in one launch are consecutive positions, one span, so the
//   earlier ones' ring slots are overwritten by the JAX scan anyway), as
//   stores that nothing waits on, and ckpt_pos has one writer a row (the
//   block of column tile 0 and head 0).
//
// What still bounds it (scripts/torch_ssm_update_probe.py times each
// phase of a block): each slot's shared-memory loads, and per stage the
// reduction of y and the start of the next stage's copies; not the
// bytes.
//
// S = g*S + k*v is rounded as two products and a sum (__fmul_rn,
// __fadd_rn: no contraction), as the plain version's elementwise ops are,
// so the state and ring bits equal the plain version's and do not depend
// on how a row's tokens were cut into launches; only y's summation order
// differs (fmaf over a thread's rows, then the row groups in order).
//
// The grid depends on B, H and dv only, and the launch allocates nothing
// and reads no host value, so it can be captured in a CUDA graph (graph
// decode replays it).  Plain C interface for ctypes; the launcher returns
// a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;             // 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // columns of dv a block
constexpr int kGroups = kThreads / kCols; // row groups of dk
constexpr int kSlots = 32;                // P: most slots a stage
constexpr int kStages = 3;                // stages in flight
constexpr int kFill = kThreads / kSlots;  // threads copying one slot's units
constexpr int kPartStride = kGroups + 4;  // floats a (slot, column)
constexpr int kMaxSmem = 232448;          // bytes a block may opt in to
static_assert(kThreads % kSlots == 0 && kThreads % kCols == 0 &&
                  kGroups % 4 == 0 && kSlots % 4 == 0,
              "geometry");

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
  int uq, uk, uv;           // copy units (bytes) of q, k and v
  int vec_state;            // state rows move as float4 (dv % 4 == 0)
  int ps;                   // slots a stage: kSlots, or fewer when no
                            // row can have more (a decode step: 1)
};

// Shared-memory layout (bytes): kStages stages of sq, sk (ps x DKP), sv
// (ps x kCols) in the input type and sg (ps) fp32; the partial dots (ps x
// kCols x kPartStride, a (slot, column)'s row groups side by side); the
// state tile (DKP x kCols); the scan's scratch; then the row's block list
// (cap x (block, first slot, pos0)).
struct Layout {
  int stage, qk, v, part, tile, scratch, list, bytes;
  __host__ __device__ Layout(int ps, int dkp, int sz, int cap) {
    qk = ps * dkp * sz;
    v = ps * kCols * sz;
    stage = (2 * qk + v + ps * 4 + 15) / 16 * 16;
    part = kStages * stage;
    tile = part + ps * kCols * kPartStride * 4;
    scratch = tile + dkp * kCols * 4;
    list = scratch + 2 * kWarps * 4;
    bytes = list + 3 * 4 * cap;
  }
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// R consecutive values from shared memory (R values aligned), widened.
template <int R>
__device__ __forceinline__ void load_rows(const float* s, float (&d)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const float4 x = *reinterpret_cast<const float4*>(s + j);
      d[j] = x.x;
      d[j + 1] = x.y;
      d[j + 2] = x.z;
      d[j + 3] = x.w;
    }
  } else if constexpr (R == 2) {
    const float2 x = *reinterpret_cast<const float2*>(s);
    d[0] = x.x;
    d[1] = x.y;
  } else {
    d[0] = s[0];
  }
}

template <int R>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* s,
                                          float (&d)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int j = 0; j < R; j += 4) {
      const uint2 x = *reinterpret_cast<const uint2*>(s + j);
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.x));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&x.y));
      d[j] = a.x;
      d[j + 1] = a.y;
      d[j + 2] = b.x;
      d[j + 3] = b.y;
    }
  } else if constexpr (R == 2) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(s));
    d[0] = a.x;
    d[1] = a.y;
  } else {
    d[0] = __bfloat162float(s[0]);
  }
}

// One copy unit global -> shared: cp.async of 16, 8 or 4 bytes, or a
// plain 2-byte copy (a bf16 operand aligned to less than 4 bytes).
__device__ __forceinline__ void copy_unit(void* dst, const void* src,
                                          int unit) {
  if (unit == 16)
    hopper::cp_async16(dst, src);
  else if (unit == 8)
    hopper::cp_async8(dst, src);
  else if (unit == 4)
    hopper::cp_async4(dst, src);
  else
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
}

// Block blk's (row, first position, valid tokens) in either form.
__device__ __forceinline__ void block_of(const Params& p, int blk, int& row,
                                         int& pos0, int& valid) {
  if (p.descs != nullptr) {
    const int* d = p.descs + 4 * blk;
    row = d[0];
    pos0 = d[1];
    valid = min(d[2], p.block_q);
  } else {
    row = blk;
    pos0 = (int)p.starts[blk];
    valid = p.counts != nullptr
                ? (int)min(p.counts[blk], (long long)p.block_q)
                : p.block_q;
  }
}

// Exclusive block-wide prefix sums of (a, b) in thread order, and their
// totals.  `scratch`: 2 kWarps ints.  Ends with a barrier.
__device__ __forceinline__ void block_scan2(int a, int b, int& ea, int& eb,
                                            int& ta, int& tb, int* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int ia = a, ib = b;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int xa = __shfl_up_sync(0xffffffffu, ia, o);
    const int xb = __shfl_up_sync(0xffffffffu, ib, o);
    if (lane >= o) {
      ia += xa;
      ib += xb;
    }
  }
  if (lane == 31) {
    scratch[warp] = ia;
    scratch[kWarps + warp] = ib;
  }
  __syncthreads();
  ea = ia - a;
  eb = ib - b;
  ta = tb = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int sa = scratch[w], sb = scratch[kWarps + w];
    if (w < warp) {
      ea += sa;
      eb += sb;
    }
    ta += sa;
    tb += sb;
  }
  __syncthreads();
}

template <typename T, int DKP>
__global__ void __launch_bounds__(kThreads)
    ssm_update_kernel(const Params p) {
  constexpr int R = DKP / kGroups;  // rows of dk a thread
  constexpr int sz = sizeof(T);
  static_assert(R >= 1 && DKP % kGroups == 0, "rows a thread");
  extern __shared__ __align__(16) unsigned char smem[];
  const int ps = p.ps;
  const int cap = p.descs != nullptr ? p.NB : 1;
  const Layout L(ps, DKP, sz, cap);
  float* part = reinterpret_cast<float*>(smem + L.part);
  float* tile = reinterpret_cast<float*>(smem + L.tile);
  int* scratch = reinterpret_cast<int*>(smem + L.scratch);
  int* lblk = reinterpret_cast<int*>(smem + L.list);
  int* lstart = lblk + cap;
  int* lpos = lstart + cap;

  const int tid = threadIdx.x;
  const int h = blockIdx.y, row = blockIdx.z;
  const int c0 = blockIdx.x * kCols;
  const int cl = tid % kCols, rg = tid / kCols, i0 = rg * R;
  const int width = min(kCols, p.dv - c0);
  const bool live = cl < width;
  if (p.runs != nullptr && tid == 0 &&
      blockIdx.x + blockIdx.y + blockIdx.z == 0)
    atomicAdd(p.runs, 1ull);

  // the row's blocks, in order, and its slot count n
  const int nscan = p.descs != nullptr ? p.NB : 1;
  int nl = 0, n = 0;
  for (int base = 0; base < nscan; base += kThreads) {
    const int blk = p.descs != nullptr ? base + tid : row;
    int r = -1, pos0 = 0, valid = 0;
    if (base + tid < nscan) block_of(p, blk, r, pos0, valid);
    const int m = (r == row && valid > 0) ? 1 : 0;
    int at, off, cnt, tot;
    block_scan2(m, m ? valid : 0, at, off, cnt, tot, scratch);
    if (m) {
      lblk[nl + at] = blk;
      lstart[nl + at] = n + off;
      lpos[nl + at] = pos0;
    }
    nl += cnt;
    n += tot;
  }
  __syncthreads();  // the list
  if (n == 0) return;
  const int nstages = (n + ps - 1) / ps;

  // zero the stages (the pad rows of q and k past dk, the columns of v
  // past dv stay zero: the copies write neither)
  for (int o = tid; o < kStages * L.stage / 16; o += kThreads)
    reinterpret_cast<uint4*>(smem)[o] = make_uint4(0, 0, 0, 0);

  // the state tile, zero past dk and dv
  const long long sbase = ((long long)row * p.H + h) * p.dk * p.dv;
  if (p.vec_state) {
    for (int u = tid; u < DKP * kCols / 4; u += kThreads) {
      const int i = u / (kCols / 4), c = 4 * (u % (kCols / 4));
      const bool in = i < p.dk && c < width;
      hopper::cp_async16(tile + i * kCols + c,
                         in ? p.state + sbase + (long long)i * p.dv + c0 + c
                            : p.state,
                         in);
    }
  } else {
    for (int u = tid; u < DKP * kCols; u += kThreads) {
      const int i = u / kCols, c = u % kCols;
      if (i < p.dk && c < width)
        hopper::cp_async4(tile + u, p.state + sbase + (long long)i * p.dv +
                                        c0 + c);
      else
        tile[u] = 0.f;
    }
  }
  hopper::cp_async_commit();

  // row slot j: its packed slot, and the position after it.  Linear
  // (the row's blocks consecutive, all but the last full, as
  // build_descriptors cuts a span, and every dense row) or by a binary
  // search of the list.
  bool lin = true;
  for (int e = tid; e < nl; e += kThreads)
    lin = lin && lblk[e] == lblk[0] + e && lstart[e] == e * p.block_q &&
          lpos[e] == lpos[0] + e * p.block_q;
  const bool linear = __syncthreads_and(lin);  // also: the zeroed stages
  const int slot0 = lblk[0] * p.block_q, pa0 = lpos[0] + 1;
  auto locate = [&](int j, int& slot, int& pa) {
    if (linear) {
      slot = slot0 + j;
      pa = pa0 + j;
      return;
    }
    int lo = 0, hi = nl - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (lstart[mid] <= j)
        lo = mid;
      else
        hi = mid - 1;
    }
    const int off = j - lstart[lo];
    slot = lblk[lo] * p.block_q + off;
    pa = lpos[lo] + off + 1;
  };

  // stage s's slots into its buffer: kFill threads a slot, in copy units
  const int nq = p.dk * sz / p.uq, nk = p.dk * sz / p.uk;
  const int nv = width * sz / p.uv;
  const int fi = tid / kFill, fu = tid % kFill;
  auto fill = [&](int s) {
    if (fi >= min(ps, n - s * ps)) return;
    unsigned char* st = smem + (s % kStages) * L.stage;
    int slot, pa;
    locate(s * ps + fi, slot, pa);
    const char* q = static_cast<const char*>(p.q) +
                    ((long long)slot * p.q_ts + h * p.q_hs) * sz;
    const char* k = static_cast<const char*>(p.k) +
                    ((long long)slot * p.k_ts + h * p.k_hs) * sz;
    const char* v = static_cast<const char*>(p.v) +
                    ((long long)slot * p.v_ts + h * p.v_hs + c0) * sz;
    unsigned char* to_q = st + fi * DKP * sz;
    unsigned char* to_k = to_q + L.qk;
    unsigned char* to_v = st + 2 * L.qk + fi * kCols * sz;
    for (int u = fu; u < nq; u += kFill)
      copy_unit(to_q + u * p.uq, q + u * p.uq, p.uq);
    for (int u = fu; u < nk; u += kFill)
      copy_unit(to_k + u * p.uk, k + u * p.uk, p.uk);
    for (int u = fu; u < nv; u += kFill)
      copy_unit(to_v + u * p.uv, v + u * p.uv, p.uv);
    if (fu == kFill - 1)
      hopper::cp_async4(st + 2 * L.qk + L.v + fi * 4,
                        p.g + (long long)slot * p.g_ts + h);
  };
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nstages) fill(s);
    hopper::cp_async_commit();
  }

  hopper::cp_async_wait<kStages - 1>();  // the state tile
  __syncthreads();
  float S[R];
#pragma unroll
  for (int j = 0; j < R; ++j) S[j] = tile[(i0 + j) * kCols + cl];

  const bool pos_writer = blockIdx.x == 0 && h == 0 && tid == 0;
  float* ring_base = p.ckpt + (long long)row * p.C * p.H * p.dk * p.dv +
                     ((long long)h * p.dk + i0) * p.dv + c0 + cl;
#pragma unroll 1
  for (int s = 0; s < nstages; ++s) {
    if (s + kStages - 1 < nstages) fill(s + kStages - 1);
    hopper::cp_async_commit();
    hopper::cp_async_wait<kStages - 1>();  // stage s, this thread's copies
    __syncthreads();                        // everyone's

    const unsigned char* st = smem + (s % kStages) * L.stage;
    const T* sq = reinterpret_cast<const T*>(st);
    const T* sk = reinterpret_cast<const T*>(st + L.qk);
    const T* sv = reinterpret_cast<const T*>(st + 2 * L.qk);
    const float* sg = reinterpret_cast<const float*>(st + 2 * L.qk + L.v);
    const int cnt = min(ps, n - s * ps);
    const int ring_from = n - p.C - s * ps;  // first slot the ring keeps
    // one slot: S = g S + k v on this thread's rows, its partial of y
    auto step = [&](int i) {
      const float gt = sg[i];
      const float vc = widen(sv[i * kCols + cl]);
      float kr[R], qr[R];
      load_rows<R>(sk + i * DKP + i0, kr);
      load_rows<R>(sq + i * DKP + i0, qr);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        S[j] = __fadd_rn(__fmul_rn(gt, S[j]), __fmul_rn(kr[j], vc));
        if (j % 2 == 0)
          a0 = fmaf(qr[j], S[j], a0);
        else
          a1 = fmaf(qr[j], S[j], a1);
      }
      return a0 + a1;
    };
    if (cnt == kSlots && ring_from >= kSlots) {
      // a full stage the ring keeps nothing of: no branch between slots,
      // so one slot's loads overlap the previous slot's arithmetic
      float acc[kSlots];
#pragma unroll
      for (int i = 0; i < kSlots; ++i) acc[i] = step(i);
#pragma unroll
      for (int i = 0; i < kSlots; ++i)
        part[(i * kCols + cl) * kPartStride + rg] = acc[i];
    } else {
#pragma unroll 1
      for (int i = 0; i < cnt; ++i) {
        part[(i * kCols + cl) * kPartStride + rg] = step(i);
        if (i >= ring_from) {
          int slot, pa;
          locate(s * ps + i, slot, pa);
          const int ring = pa % p.C;
          if (live) {
            float* dst = ring_base + (long long)ring * p.H * p.dk * p.dv;
#pragma unroll
            for (int j = 0; j < R; ++j)
              if (i0 + j < p.dk) dst[(long long)j * p.dv] = S[j];
          }
          if (pos_writer) p.ckpt_pos[(long long)row * p.C + ring] = pa;
        }
      }
    }
    __syncthreads();  // the partials; stage s's buffer is free

    for (int o = tid; o < cnt * kCols; o += kThreads) {
      const int i = o / kCols, c = o % kCols;
      if (c < width) {
        const float4* pt = reinterpret_cast<const float4*>(
            part + (i * kCols + c) * kPartStride);
        float4 sum = pt[0];
#pragma unroll
        for (int grp = 1; grp < kGroups / 4; ++grp) {
          const float4 x = pt[grp];
          sum.x += x.x;
          sum.y += x.y;
          sum.z += x.z;
          sum.w += x.w;
        }
        int slot, pa;
        locate(s * ps + i, slot, pa);
        p.y[((long long)slot * p.H + h) * p.dv + c0 + c] =
            (sum.x + sum.y) + (sum.z + sum.w);
      }
    }
  }

  // the state, once, through the tile
#pragma unroll
  for (int j = 0; j < R; ++j) tile[(i0 + j) * kCols + cl] = S[j];
  __syncthreads();
  if (p.vec_state) {
    for (int u = tid; u < DKP * kCols / 4; u += kThreads) {
      const int i = u / (kCols / 4), c = 4 * (u % (kCols / 4));
      if (i < p.dk && c < width)
        *reinterpret_cast<float4*>(p.state + sbase + (long long)i * p.dv +
                                   c0 + c) =
            *reinterpret_cast<const float4*>(tile + i * kCols + c);
    }
  } else {
    for (int u = tid; u < DKP * kCols; u += kThreads) {
      const int i = u / kCols, c = u % kCols;
      if (i < p.dk && c < width)
        p.state[sbase + (long long)i * p.dv + c0 + c] = tile[u];
    }
  }
}

// The largest copy unit (16, 8, 4 or 2 bytes) that divides every value.
int unit_of(std::initializer_list<long long> values) {
  for (int u : {16, 8, 4}) {
    bool ok = true;
    for (long long x : values) ok = ok && x % u == 0;
    if (ok) return u;
  }
  return 2;
}

template <typename T, int DKP>
cudaError_t launch_dkp(const Params& p, cudaStream_t stream) {
  auto kernel = ssm_update_kernel<T, DKP>;
  const Layout L(p.ps, DKP, sizeof(T), p.descs != nullptr ? p.NB : 1);
  if (L.bytes > kMaxSmem) return cudaErrorInvalidValue;
  if (L.bytes > 48 * 1024) {
    // the opt-in above 48 KB, once a device
    static bool opted[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64 || !opted[dev]) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (err != cudaSuccess) return err;
      if (dev < 64) opted[dev] = true;
    }
  }
  const dim3 grid((p.dv + kCols - 1) / kCols, p.H, p.B);
  kernel<<<grid, kThreads, L.bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(Params p, cudaStream_t stream) {
  const long long sz = sizeof(T);
  p.uq = unit_of({(long long)(uintptr_t)p.q, p.q_ts * sz, p.q_hs * sz,
                  p.dk * sz});
  p.uk = unit_of({(long long)(uintptr_t)p.k, p.k_ts * sz, p.k_hs * sz,
                  p.dk * sz});
  p.uv = unit_of({(long long)(uintptr_t)p.v, p.v_ts * sz, p.v_hs * sz,
                  p.dv * sz, kCols * sz});
  p.vec_state = p.dv % 4 == 0;
  const long long most = p.descs != nullptr
                             ? (long long)p.NB * p.block_q : p.block_q;
  p.ps = (int)(most < kSlots ? most : kSlots);
  if (p.dk <= 32) return launch_dkp<T, 32>(p, stream);
  if (p.dk <= 64) return launch_dkp<T, 64>(p, stream);
  if (p.dk <= 128) return launch_dkp<T, 128>(p, stream);
  return cudaErrorInvalidValue;
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
