// Attention of query rows against a KV cache (sm_90a): the device code
// shared by csrc/decode_attention.cu (contiguous cache) and the paged decode
// and ragged kernels of csrc/paged_attention.cu (a page table in front of a
// head-major pool).  The three differ only in where a block finds its
// sequence, its positions and its q/out rows, and how key j's cache row is
// found (the layout template argument: Contiguous, Paged, Ragged).
//
// Cached contract (Contiguous, Paged): q (B, Hq, T, D) fp32 or bf16; query
// t of sequence b sits at position len_b - T + t and attends keys j <=
// position (and j > position - window).  Ragged contract: q (1, Hq, Tp, D)
// packed, Tp = NB * T (T = block_q); descriptor b = (row, q_pos0, q_valid,
// kv_len) owns slots [b * T, (b + 1) * T), slot t sits at position q_pos0 +
// t of table row `row` and is real for t < q_valid (none when row = -1);
// the other slots write zeros.  K/V in q's dtype, or int8 with per-token
// fp32 scales, dequantized on chip as (int8 -> fp32 * scale) -> q's dtype.
// Score order: scale, softcap * tanh(s / softcap), ALiBi slope * (j -
// position), then the mask with the finite -1e30.  Running max, sum and
// accumulator are fp32; the probability is rounded to q's dtype before P.V;
// a row with no attended key writes zeros.  The query group folds into
// rows in kv-major order: row r of kv head h is query head h * G + r / T,
// token (slot) r % T.  A ragged descriptor is a sequence to the kernels:
// its key range runs from the window start of its first real slot to
// q_pos0 + q_valid, so traffic tracks the live keys, never the table's
// span; a tile with no real slot writes zeros and leaves.
//
// What bounds it on an H100, and what the design does about it:
//
// - Decode tiles (T * G < 64 rows; decode_split_kernel).  Every live K/V
//   row is read once for 4 * D flops per query row: bytes bound it
//   (1.9 us for GPT-2's 12 heads x 1024 keys in fp32).  One block per
//   (batch, kv head) would fill 12 of 132 SMs, so the key range of each
//   (batch, kv head, row tile) is cut into n_split splits of whole
//   granules (64 keys, or the fewest whole pages of at least 64 where a
//   page is not a multiple of 64 keys) sized by the wrapper from the SM
//   count (ops/kernels/decode_attention.py::split_plan), one block each.
//   Only the splits that hold a key (a prefix) stay: the others leave at
//   once.  Inside a block a group of lanes owns one key (8 elements a
//   lane), so the dot is a shuffle reduction and the scores, the online
//   softmax and P.V stay in registers; each lane group takes up to four
//   keys a pass as independent chains and streams them through a private
//   cp.async ring in shared memory, so the next pass's keys are in flight
//   while it does the math of this one.  The K/V copies are issued before
//   q is read.  The lane groups and the warps merge once at the end.  The
//   splits merge in the same launch, with no scratch and no counter: the
//   splits of a row tile are one thread-block cluster (ragged tiles: see
//   below); each block pushes its (m, l, acc) into the shared memory of
//   the blocks that merge them (distributed shared memory), and after one
//   cluster barrier each block sums its share of the output in split
//   order, so two launches give the same bits.  The
//   paged kernel reads its split's page ids into shared memory once, one
//   table lookup per page.
// - Ragged decode tiles.  A descriptor's length stays on the device, so
//   the split count and granule come from the pool's span
//   (ragged_split_plan: splits of 4 granules, as many as the longest
//   possible range needs, or more, of one granule, where few descriptors
//   leave the card idle); a shorter range keeps fewer live splits.  A
//   cluster would hold all of a tile's splits co-scheduled, mostly idle,
//   for its whole life, so ragged launches have none: the live splits
//   write their partials to global scratch, and the last of them (a
//   ticket) merges them in split order.  The last descriptors and splits
//   are dispatched first (a chunk's longest ranges, the decode rows
//   packed after it).  A tile with no real slot writes zeros and leaves; a
//   tile whose only real row is a decode step's runs the one-row instance
//   (four keys a lane group a pass); a tile of several real rows (a
//   prefill chunk's descriptor) runs a rows tile (rows_tile): 64-key
//   tiles through shared memory, whole dot products a thread, one softmax
//   a row and tile, P.V by float4s, in full fp32 on FMAs.
// - Prefill tiles (T * G >= 64 rows).  The L^2 / 2 score pairs bound it.
//   Each block owns 64 query rows (32 at D > 128 in fp32) and walks the
//   keys up to its last row's position, 64 at a time through a ring of
//   shared memory stages (cp.async, or registers for int8 tiles, which are
//   dequantized on the way), so the next tiles load while this one is
//   computed, and tiles above the diagonal are never read.  bf16 runs
//   mma.sync m16n8k16 on tensor cores (prefill_mma_kernel: 4 warps x 16
//   rows, P from registers); fp32 runs register-tiled FMAs in full fp32,
//   no TF32 (prefill_fma_kernel: each of 256 threads owns a 4 x 4 block of
//   S and 4 x D/16 of O).  Scores are exp2'd in log2 units, and a tile that
//   needs no mask, softcap or bias (all but the diagonal and window-edge
//   tiles) runs a straight-line instance of the softmax: per-element
//   branches cost more than the products.
//
// Unassigned page-table entries (-1) are clamped to page 0 before any
// address arithmetic (they back only masked positions); cache offsets are
// 64-bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <type_traits>

#include "hopper.cuh"

namespace decode_core {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kMaxSplits = 16;   // ops/kernels/decode_attention.py MAX_SPLITS
constexpr int kKeys = 64;        // keys per prefill tile
constexpr int kMmaThreads = 128;
constexpr int kFmaThreads = 256;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;  // int8 caches only
  const float* v_scale;
  const int* lengths;    // (B,) valid lengths, or null: `length`
  const float* slopes;   // (Hq,) ALiBi slopes, or null
  const int* table;      // paged: (B, pages_per_seq), -1 = unassigned
  void* out;
  long long kv_rows;     // cache rows of one (b, h) (S), or of one pool head
  int length;
  int hkv, t, d, group;
  int max_len;           // key positions: S, or pages_per_seq * page
  int page, pages_per_seq;
  int window;            // 0: no window
  float scale;
  float softcap;         // 0: no softcap
  int row_tiles, n_split, granule;
  const int* descs;      // ragged: (NB, 4) (row, q_pos0, q_valid, kv_len)
  int tp;                // ragged: packed slots NB * T
  float* part;           // ragged, split: [tile][split][tile_rows * (D + 2)]
  int* tickets;          // ragged, split: [tile], zero between launches
  int part_rows;         // the launch's tile rows
  int page_shift;        // paged: log2(page) when a power of two, else -1
  unsigned long long* runs;  // or null: one added a launch that runs
};

// Block 0's thread 0 adds one to p.runs: what ran, a replay of a captured
// launch included, where the wrapper counts what it launched.
__device__ __forceinline__ void count_run(const Params& p) {
  if (p.runs != nullptr && threadIdx.x == 0 &&
      blockIdx.x + blockIdx.y + blockIdx.z == 0)
    atomicAdd(p.runs, 1ull);
}

// Where a kernel's queries and keys live (its last template argument).
struct Contiguous {
  static constexpr bool kPaged = false, kRagged = false;
};
struct Paged {
  static constexpr bool kPaged = true, kRagged = false;
};
struct Ragged {
  static constexpr bool kPaged = true, kRagged = true;
};

// The position of a ragged slot that is not real: before every key, so it
// attends none.
constexpr int kNoPos = -(1 << 30);

// --- element conversions ----------------------------------------------------

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

__device__ __forceinline__ void unpack(float4 a, float4 b, float* x) {
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void unpack(uint4 raw, float* x) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(uint2 raw, float* x) {
  const int8_t* c = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] = static_cast<float>(c[i]);
}

// Eight consecutive elements of global memory to fp32 (16-byte loads for
// fp32/bf16, 8 for int8).
__device__ __forceinline__ void load8(const float* p, float* x) {
  unpack(reinterpret_cast<const float4*>(p)[0],
         reinterpret_cast<const float4*>(p)[1], x);
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  unpack(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void load8(const int8_t* p, float* x) {
  unpack(*reinterpret_cast<const uint2*>(p), x);
}

__device__ __forceinline__ bool attends(int j, int pos, int window) {
  return j <= pos && (window <= 0 || j > pos - window);
}

// --- sequences and key ranges -----------------------------------------------

// The sequence of grid index b for kv head h: cached, sequence b (token t
// at len_b - T + t, q/out (B, Hq, T, D)); ragged, descriptor b (slot t at
// q_pos0 + t, real for t < q_valid, q/out (1, Hq, Tp, D) with its slots
// from b * T).
struct Seq {
  int first;      // position of token / slot 0
  int valid;      // real tokens / slots
  int table_row;  // paged: the sequence's row of the block table
  size_t q0;      // element offset of row 0 of kv head h in q and out
  size_t hs;      // elements between the query heads of the group
};

template <bool RAGGED>
__device__ __forceinline__ Seq sequence(const Params& p, int b, int h) {
  Seq s;
  const int T = p.t;
  if (RAGGED) {
    const int* dsc = p.descs + 4 * b;
    const int row = dsc[0];
    s.first = dsc[1];
    s.valid = row >= 0 ? dsc[2] : 0;
    s.table_row = max(row, 0);
    s.hs = static_cast<size_t>(p.tp) * p.d;
    s.q0 = static_cast<size_t>(h) * p.group * s.hs +
           static_cast<size_t>(b) * T * p.d;
  } else {
    const int len = p.lengths != nullptr ? p.lengths[b] : p.length;
    s.first = len - T;
    s.valid = T;
    s.table_row = b;
    s.hs = static_cast<size_t>(T) * p.d;
    s.q0 = (static_cast<size_t>(b) * p.hkv + h) * p.group * s.hs;
  }
  return s;
}

// Element offset in q and out of row r (< G * T) of the sequence's kv head.
template <bool RAGGED>
__device__ __forceinline__ size_t row_offset(const Params& p, const Seq& s,
                                             int r) {
  if (!RAGGED) return s.q0 + static_cast<size_t>(r) * p.d;
  return s.q0 + static_cast<size_t>(r / p.t) * s.hs +
         static_cast<size_t>(r % p.t) * p.d;
}

// Element offset of element i (row i / D, feature i % D) of the tile whose
// first row is m0.
template <bool RAGGED>
__device__ __forceinline__ size_t out_index(const Params& p, const Seq& s,
                                            int m0, int i) {
  if (!RAGGED) return s.q0 + static_cast<size_t>(m0) * p.d + i;
  return row_offset<true>(p, s, m0 + i / p.d) + i % p.d;
}

// Zeros into rows m0 .. m0 + mv - 1 (a ragged tile with no real slot).
template <bool RAGGED, int THREADS, typename QT>
__device__ __forceinline__ void zero_rows(const Params& p, const Seq& s,
                                          int m0, int mv, QT* out) {
  for (int i = threadIdx.x; i < mv * p.d; i += THREADS)
    store(out + out_index<RAGGED>(p, s, m0, i), 0.f);
}

// Keys [kb, ke) that rows m0 .. m0 + mv of the sequence attend; a tile that
// wraps past a group boundary holds both t = T - 1 and t = 0.  Ragged, only
// real slots count, and a tile without one gets kb = ke = 0.
template <bool RAGGED>
__device__ __forceinline__ void tile_keys(const Params& p, int m0, int mv,
                                          const Seq& s, int* kb, int* ke) {
  const int T = p.t;
  int t_lo = 0, t_hi = T - 1;
  if (m0 / T == (m0 + mv - 1) / T) {
    t_lo = m0 % T;
    t_hi = (m0 + mv - 1) % T;
  }
  if (RAGGED) {
    t_hi = min(t_hi, s.valid - 1);
    if (t_hi < t_lo) {
      *kb = *ke = 0;
      return;
    }
  }
  *ke = min(s.first + t_hi + 1, p.max_len);
  *kb = p.window > 0 ? max(0, s.first + t_lo - p.window + 1) : 0;
}

// Split s of n over [kb, ke): whole granules from kb's granule on,
// ceil(span / n) keys each rounded up to a granule, clipped to [kb, ke);
// lo >= hi is an empty split.  The live splits (those with a key) are the
// first *live of them.  ops/kernels/decode_attention.py::split_ranges is
// the same arithmetic.
__device__ __forceinline__ void split_keys(int kb, int ke, int n, int granule,
                                           int s, int* lo, int* hi,
                                           int* live) {
  if (ke <= kb) {
    *lo = *hi = kb;
    *live = 0;
    return;
  }
  const int base = kb / granule * granule;
  const int span = ke - base;
  const int chunk = ((span + n - 1) / n + granule - 1) / granule * granule;
  *lo = max(kb, base + s * chunk);
  *hi = min(ke, base + (s + 1) * chunk);
  *live = (span + chunk - 1) / chunk;
}

// Page ids of keys [lo, hi) of table row b into pg (first page lo / page),
// clamped to page 0 when unassigned; the caller synchronises.
template <int THREADS>
__device__ __forceinline__ void stage_pages(const Params& p, int b, int lo,
                                            int hi, int* pg) {
  if (hi <= lo) return;
  const int p0 = lo / p.page;
  const int np = (hi - 1) / p.page - p0 + 1;
  const int* tab = p.table + static_cast<size_t>(b) * p.pages_per_seq;
  for (int i = threadIdx.x; i < np; i += THREADS)
    pg[i] = max(tab[min(p0 + i, p.pages_per_seq - 1)], 0);
}

// Cache row of key j within its (b, h) block or pool head.
template <bool PAGED>
__device__ __forceinline__ size_t cache_row(const Params& p, const int* pg,
                                            int p0, int j) {
  if (PAGED) {
    if (p.page_shift >= 0)  // no integer division on the hot path
      return static_cast<size_t>(pg[(j >> p.page_shift) - p0])
                 << p.page_shift |
             static_cast<size_t>(j & (p.page - 1));
    return static_cast<size_t>(pg[j / p.page - p0]) * p.page + j % p.page;
  }
  return static_cast<size_t>(j);
}

// First cache row of (b, h): the (b, h) block, or head h of the pool.
template <bool PAGED>
__device__ __forceinline__ size_t head_row(const Params& p, int b, int h) {
  return (PAGED ? static_cast<size_t>(h)
                : static_cast<size_t>(b) * p.hkv + h) *
         static_cast<size_t>(p.kv_rows);
}

// ---------------------------------------------------------------------------
// decode tiles: split-K over the cache, merged in the launch
// ---------------------------------------------------------------------------

// A lane's 8-element chunk of one cache row in the ring: kUnits copies of
// kUnitBytes, stored unit-major ([unit][thread]) so reads do not conflict.
template <typename KT>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int kUnits = 2, kUnitBytes = 16;
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int kUnits = 1, kUnitBytes = 16;
};
template <>
struct Chunk<int8_t> {
  static constexpr int kUnits = 1, kUnitBytes = 8;
};

template <typename KT>
__host__ __device__ constexpr int chunk_bytes() { return 8 * static_cast<int>(sizeof(KT)); }

// Keys a lane group takes at once (independent chains that hide each
// other's latency) and the ring's depth in such groups, by rows a tile:
// three or four keys a lane in flight, within the registers.
template <int R>
struct Ring {
  static constexpr int kGroup = R == 1 ? 4 : R <= 4 ? 2 : 1;
  static constexpr int kStages = kGroup == 4 ? 2 : kGroup == 2 ? 3 : 4;
};

// One key a thread: K chunks, V chunks, then (k, v) scales.
template <typename KT>
__host__ __device__ constexpr int key_bytes() {
  return 2 * chunk_bytes<KT>() * kDecodeThreads + 8 * kDecodeThreads;
}

template <typename KT>
__device__ __forceinline__ void copy_chunk(unsigned char* area, int tid,
                                           const KT* src) {
  constexpr int U = Chunk<KT>::kUnitBytes;
#pragma unroll
  for (int u = 0; u < Chunk<KT>::kUnits; ++u) {
    unsigned char* dst = area + (u * kDecodeThreads + tid) * U;
    const unsigned char* s = reinterpret_cast<const unsigned char*>(src) + u * U;
    if (U == 16)
      hopper::cp_async16(dst, s);
    else
      hopper::cp_async8(dst, s);
  }
}

__device__ __forceinline__ void read_chunk(const unsigned char* area, int tid,
                                           float* x, const float*) {
  const float4* a = reinterpret_cast<const float4*>(area);
  unpack(a[tid], a[kDecodeThreads + tid], x);
}
__device__ __forceinline__ void read_chunk(const unsigned char* area, int tid,
                                           float* x, const __nv_bfloat16*) {
  unpack(reinterpret_cast<const uint4*>(area)[tid], x);
}
__device__ __forceinline__ void read_chunk(const unsigned char* area, int tid,
                                           float* x, const int8_t*) {
  unpack(reinterpret_cast<const uint2*>(area)[tid], x);
}

// Shared memory a decode block merges in, written by the other blocks of
// its cluster at any time, so apart from the ring: every split's (max,
// sum) of each row, its share of every split's accumulator, the weights.
template <int R>
__host__ __device__ inline size_t merge_bytes(int d) {
  return sizeof(float) * (kMaxSplits * R * 2 + (R * d + kMaxSplits) +
                          R * (kMaxSplits + 1));
}

// The ring, then, reused, the warps' partials.
template <typename KT, int R>
__host__ __device__ inline size_t ring_bytes(int d) {
  const size_t ring = static_cast<size_t>(Ring<R>::kStages) *
                      Ring<R>::kGroup * key_bytes<KT>();
  const size_t warps = sizeof(float) * kDecodeWarps * R * (d + 2);
  return ring > warps ? ring : warps;
}

// Shared memory of a decode block: the ring, the merge buffers and the
// page ids.
template <typename KT, int R>
__host__ __device__ inline size_t decode_smem_bytes(int d, int pages) {
  return ring_bytes<KT, R>(d) + merge_bytes<R>(d) + sizeof(int) * pages;
}

// The ragged merge of a tile's live splits.  Clusters would hold every
// split of every tile co-scheduled, most of them idle (a descriptor's
// length is known only on the device), so each live split writes its
// partial (per row its max and sum, in log2 units, and its accumulator) to
// p.part, [acc R x D][max R][sum R] in its slot, and takes a ticket; the
// last to arrive sums the partials in split order (two launches give the
// same bits) and resets the ticket.
__device__ __forceinline__ float* partial_slot(const Params& p, int tile,
                                               int split) {
  return p.part + (static_cast<size_t>(tile) * p.n_split + split) *
                      (p.part_rows * (p.d + 2));
}

// After every thread has written its share of this split's partial: the
// ticket, and the merge if this split is the tile's last.
template <typename QT, int R, bool RAGGED>
__device__ __forceinline__ void merge_if_last(const Params& p,
                                              unsigned char* smem,
                                              const Seq& sq, int m0, int mv,
                                              int ns, int tile) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int D = p.d;
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem);
  if (tid == 0) *last = atomicAdd(p.tickets + tile, 1) == ns - 1;
  __syncthreads();
  if (!*last) return;
  __threadfence();
  // The last split: weigh each row's splits (warp w rows w, w + 4, ...;
  // lane s split s), then sum every element in split order.
  const float* base = partial_slot(p, tile, 0);
  const size_t stride = static_cast<size_t>(p.part_rows) * (D + 2);
  float* wt = reinterpret_cast<float*>(smem) + 4;  // [R][kMaxSplits]
  float* inv = wt + R * kMaxSplits;                // [R]
  for (int r = warp; r < mv; r += kDecodeWarps) {
    const float* ps = base + lane * stride;
    const float ms = lane < ns ? __ldcg(ps + R * D + r) : kNegInf;
    float mx = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = lane < ns ? exp2f(ms - mx) : 0.f;
    const float wl = lane < ns ? __ldcg(ps + R * D + R + r) * w : 0.f;
    if (lane < kMaxSplits) wt[r * kMaxSplits + lane] = w;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      sum += __shfl_sync(0xffffffffu, wl, s);
    if (lane == 0) inv[r] = 1.f / (sum == 0.f ? 1.f : sum);
  }
  __syncthreads();
  QT* out = static_cast<QT*>(p.out);
  for (int i = tid; i < mv * D; i += kDecodeThreads) {
    const int r = i / D;
    float a = 0.f;
    for (int s = 0; s < ns; ++s)
      a += __ldcg(base + s * stride + i) * wt[r * kMaxSplits + s];
    store(out + out_index<RAGGED>(p, sq, m0, i), a * inv[r]);
  }
  if (tid == 0) p.tickets[tile] = 0;
}

// A ragged decode tile's end: the warps' partials (wm, wl, wacc in shared
// memory, synchronised) merged into the output when this is the only live
// split, else into this split's partial, then merge_if_last.
template <typename QT, int R, bool RAGGED>
__device__ __forceinline__ void finish_ragged(
    const Params& p, unsigned char* smem, const Seq& sq, int m0, int mv,
    int split, int ns, int tile, const float* wm, const float* wl,
    const float* wacc) {
  const int D = p.d;
  QT* out = static_cast<QT*>(p.out);
  float* mine = ns > 1 ? partial_slot(p, tile, split) : nullptr;
  for (int i = threadIdx.x; i < mv * D; i += kDecodeThreads) {
    const int r = i / D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = exp2f(wm[w * R + r] - mx);
      sum += wl[w * R + r] * e;
      a += wacc[(w * R + r) * D + i % D] * e;
    }
    if (ns == 1) {
      store(out + out_index<RAGGED>(p, sq, m0, i),
            a / (sum == 0.f ? 1.f : sum));
      continue;
    }
    mine[i] = a;
    if (i % D == 0) {
      mine[R * D + r] = mx;
      mine[R * D + R + r] = sum;
    }
  }
  if (ns > 1) merge_if_last<QT, R, RAGGED>(p, smem, sq, m0, mv, ns, tile);
}

// One decode tile: rows m0 .. m0 + mv - 1 of (b, h), keys [kb, ke), split
// `split` of n_split (cached: a cluster of the n_split blocks; ragged: tile
// `tile`, merged through p.part by the last of its live splits).
template <typename QT, typename KT, int R, typename L>
__device__ __forceinline__ void decode_tile(const Params& p,
                                            unsigned char* smem, const Seq& sq,
                                            int h, int b, int m0, int mv,
                                            int kb, int ke, int split,
                                            int tile) {
  constexpr bool PAGED = L::kPaged;
  constexpr bool RAGGED = L::kRagged;
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int kChunk = chunk_bytes<KT>();
  constexpr int kKey = key_bytes<KT>();
  constexpr int U = Ring<R>::kGroup;
  constexpr int kRing = Ring<R>::kStages;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int T = p.t;
  const int D = p.d;
  QT* out = static_cast<QT*>(p.out);
  int lo, hi, ns;
  split_keys(kb, ke, p.n_split, p.granule, split, &lo, &hi, &ns);
  if (split >= ns) {
    // No key here.  The live splits (a prefix) merge among themselves; in a
    // cluster this block takes part only in their two cluster barriers
    // (every block started; partials pushed) and leaves.  A tile with no
    // key at all (every row before position 0) is zeros.
    if (ns == 0 && split == 0)
      zero_rows<RAGGED, kDecodeThreads>(p, sq, m0, mv, out);
    if (!RAGGED && ns > 1) {
      hopper::cluster_arrive_relaxed();
      hopper::cluster_wait();
      hopper::cluster_arrive_relaxed();
    }
    return;
  }

  // lpk lanes (a power of two) own one key, 8 elements each; kpw keys a
  // warp at a time.
  int lpk = 1;
  while (lpk * 8 < D) lpk <<= 1;
  const int kpw = 32 / lpk;
  const int grp = lane / lpk;
  const int c = lane % lpk;
  const bool active = c * 8 < D;

  const QT* q = static_cast<const QT*>(p.q);
  const size_t hrow = head_row<PAGED>(p, b, h);
  const KT* kc = static_cast<const KT*>(p.k) + hrow * D + c * 8;
  const KT* vc = static_cast<const KT*>(p.v) + hrow * D + c * 8;

  const size_t ring = ring_bytes<KT, R>(D);
  float* recv_ml = reinterpret_cast<float*>(smem + ring);  // [ns][R][2]
  int* pg = reinterpret_cast<int*>(smem + ring + merge_bytes<R>(D));
  // Other blocks of the cluster write recv_ml and after it; they wait for
  // this arrival first.
  if (!RAGGED && ns > 1) hopper::cluster_arrive_relaxed();
  float qr[R][8];
  int pos[R];
  float slope[R];
  auto load_q = [&]() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r < mv && active) {
        load8(q + row_offset<RAGGED>(p, sq, m0 + r) + c * 8, qr[r]);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) qr[r][i] = 0.f;
      }
      const int t = (m0 + r) % T;
      pos[r] = !RAGGED || t < sq.valid ? sq.first + t : kNoPos;
      slope[r] = (p.slopes != nullptr && r < mv)
                     ? p.slopes[h * p.group + (m0 + r) / T] : 0.f;
    }
  };
  const int p0 = PAGED ? lo / p.page : 0;
  if (PAGED) {
    load_q();
    stage_pages<kDecodeThreads>(p, sq.table_row, lo, hi, pg);
    __syncthreads();
  }

  // A pass: lane group grp of warp w takes keys mine + u * kDecodeWarps *
  // kpw, u < U (a warp's groups read neighbouring rows).
  const int per_pass = kDecodeWarps * kpw * U;
  const int npass = hi > lo ? (hi - lo + per_pass - 1) / per_pass : 0;
  const int mine = lo + warp * kpw + grp;
  auto issue = [&](int pass) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = mine + pass * per_pass + u * kDecodeWarps * kpw;
      if (pass < npass && j < hi && active) {
        unsigned char* st = smem + ((pass % kRing) * U + u) * kKey;
        const size_t row = cache_row<PAGED>(p, pg, p0, j);
        copy_chunk<KT>(st, tid, kc + row * D);
        copy_chunk<KT>(st + kChunk * kDecodeThreads, tid, vc + row * D);
        if (kInt8) {
          unsigned char* sc = st + 2 * kChunk * kDecodeThreads + 8 * tid;
          hopper::cp_async4(sc, p.k_scale + hrow + row);
          hopper::cp_async4(sc + 4, p.v_scale + hrow + row);
        }
      }
    }
    hopper::cp_async_commit();
  };

  float m[R], l[R], acc[R][8];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
  }

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) issue(s);
  // Contiguous: q after the first keys' copies, so its load overlaps
  // theirs (paged: before the page ids, overlapping that read).
  if (!PAGED) load_q();

  for (int pass = 0; pass < npass; ++pass) {
    issue(pass + kRing - 1);
    hopper::cp_async_wait<kRing - 1>();
    int j[U];
    bool key_ok[U];
    float kx[U][8], vx[U][8];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      j[u] = mine + pass * per_pass + u * kDecodeWarps * kpw;
      key_ok[u] = j[u] < hi;
      if (key_ok[u] && active) {
        const unsigned char* st = smem + ((pass % kRing) * U + u) * kKey;
        read_chunk(st, tid, kx[u], static_cast<const KT*>(nullptr));
        read_chunk(st + kChunk * kDecodeThreads, tid, vx[u],
                   static_cast<const KT*>(nullptr));
        if (kInt8) {
          const float2 sc = reinterpret_cast<const float2*>(
              st + 2 * kChunk * kDecodeThreads)[tid];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            kx[u][i] = round_to<QT>(kx[u][i] * sc.x);
            vx[u][i] = round_to<QT>(vx[u][i] * sc.y);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) kx[u][i] = vx[u][i] = 0.f;
      }
    }
    float dot[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float a = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) a = fmaf(qr[r][i], kx[u][i], a);
        dot[u][r] = a;
      }
    for (int off = lpk / 2; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < R; ++r)
          dot[u][r] += __shfl_xor_sync(0xffffffffu, dot[u][r], off);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      bool att[U];
      bool any = false;
      float mx = m[r];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        att[u] = key_ok[u] && r < mv && attends(j[u], pos[r], p.window);
        float x = dot[u][r] * p.scale;
        if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
        if (p.slopes != nullptr)
          x += slope[r] * static_cast<float>(j[u] - pos[r]);
        dot[u][r] = x * kLog2e;
        if (att[u]) mx = fmaxf(mx, dot[u][r]);
        any |= att[u];
      }
      if (!any) continue;
      const float alpha = exp2f(m[r] - mx);
      l[r] *= alpha;
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!att[u]) continue;
        const float pr = exp2f(dot[u][r] - mx);
        const float pv = round_to<QT>(pr);
        l[r] += pr;
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pv, vx[u][i], acc[r][i]);
      }
      m[r] = mx;
    }
  }
  hopper::cp_async_wait<0>();

  // Merge the lane groups of each warp (same feature chunk c) ...
  for (int off = lpk; off < 32; off <<= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], off);
      const float lo_ = __shfl_xor_sync(0xffffffffu, l[r], off);
      const float mx = fmaxf(m[r], mo);
      const float a = exp2f(m[r] - mx);
      const float e = exp2f(mo - mx);
      l[r] = l[r] * a + lo_ * e;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][i], off);
        acc[r][i] = acc[r][i] * a + ao * e;
      }
      m[r] = mx;
    }
  }
  // ... then the warps, through shared memory (the ring is done).
  __syncthreads();
  float* wm = reinterpret_cast<float*>(smem);  // [warp][R] max, then sum
  float* wl = wm + kDecodeWarps * R;
  float* wacc = wl + kDecodeWarps * R;         // [warp][R][D]
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (active) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
          wacc[(warp * R + r) * D + c * 8 + i] = acc[r][i];
      }
      if (c == 0) {
        wm[warp * R + r] = m[r];
        wl[warp * R + r] = l[r];
      }
    }
  }
  __syncthreads();

  if constexpr (RAGGED) {
    finish_ragged<QT, R, RAGGED>(p, smem, sq, m0, mv, split, ns, tile, wm,
                                 wl, wacc);
    return;
  }
  // One live split writes the output.  Else the row tile's live splits
  // (block rank = split) merge: element e of the tile's output (e < mv * D)
  // is merged by block e % ns: every block pushes its partial accumulator
  // of e, and its (max, sum) of every row, into the owners' shared memory
  // (remote stores), so one cluster barrier later each block merges its
  // share from local memory, in split order: two launches give the same
  // bits.
  const int per = (mv * D + ns - 1) / ns;
  float* recv = recv_ml + kMaxSplits * R * 2;  // [ns][per]
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (ns > 1) hopper::cluster_wait();
  for (int i = tid; i < mv * D; i += kDecodeThreads) {
    const int r = i / D;
    const int d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float sum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float e = exp2f(wm[w * R + r] - mx);
      sum += wl[w * R + r] * e;
      a += wacc[(w * R + r) * D + d] * e;
    }
    if (ns == 1) {
      store(out + out_index<RAGGED>(p, sq, m0, i),
            a / (sum == 0.f ? 1.f : sum));
      continue;
    }
    cluster.map_shared_rank(recv, i % ns)[split * per + i / ns] = a;
    // Every block weighs every row, so each rank gets the row's (max, sum):
    // from element d to ranks d, d + D, ... (D may be below ns).
    for (int o = d; o < ns; o += D) {
      float* ml = cluster.map_shared_rank(recv_ml, o) + (split * R + r) * 2;
      ml[0] = mx;
      ml[1] = sum;
    }
  }
  if (ns == 1) return;
  cluster.sync();

  float* wt = recv + ns * per;          // [R][kMaxSplits] weights
  float* inv = wt + R * kMaxSplits;     // [R] 1 / merged sum
  // Warp w weighs rows w, w + 4, ...: lane s takes split s; the sum runs in
  // split order.
  for (int r = warp; r < mv; r += kDecodeWarps) {
    const float ms = lane < ns ? recv_ml[(lane * R + r) * 2] : kNegInf;
    float mx = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float w = lane < ns ? exp2f(ms - mx) : 0.f;
    const float wl = lane < ns ? recv_ml[(lane * R + r) * 2 + 1] * w : 0.f;
    if (lane < ns) wt[r * kMaxSplits + lane] = w;
    float sum = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s)
      sum += __shfl_sync(0xffffffffu, wl, s);
    if (lane == 0) inv[r] = 1.f / (sum == 0.f ? 1.f : sum);
  }
  __syncthreads();
  const int rank = static_cast<int>(cluster.block_rank());
  for (int k = tid; rank + ns * k < mv * D; k += kDecodeThreads) {
    const int i = rank + ns * k;
    const int r = i / D;
    float x[kMaxSplits], w[kMaxSplits];
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) {
      x[s] = s < ns ? recv[s * per + k] : 0.f;
      w[s] = s < ns ? wt[r * kMaxSplits + s] : 0.f;
    }
    float a = 0.f;
#pragma unroll
    for (int s = 0; s < kMaxSplits; ++s) a += x[s] * w[s];
    store(out + out_index<RAGGED>(p, sq, m0, i), a * inv[r]);
  }
}

// ---------------------------------------------------------------------------
// ragged rows tiles: several real rows (a prefill chunk's descriptor)
// ---------------------------------------------------------------------------

// A decode tile spends every key's softmax on all of its rows, in each of
// the lanes that share the key, one key at a time: at 8 real rows that
// costs several times the products.  A rows tile instead walks 64-key
// tiles through shared memory as the prefill tiles do, at R rows: each row
// belongs to kTpr threads of one warp, each thread scores kKpt keys with
// whole dot products, the row's softmax runs once a tile (shuffles within
// the row's lanes), and P.V gives each thread its float4s of the row.
template <int R, int DCAP>
struct RowsTile {
  static constexpr int kTpr = kDecodeThreads / R;  // threads a row
  static constexpr int kKpt = kKeys / kTpr;        // keys a thread
  static constexpr int kNf = (DCAP + 4 * kTpr - 1) / (4 * kTpr);  // float4s
  static constexpr int kBuf = DCAP <= 64 ? 2 : 1;  // K/V stages
  static constexpr int kChunks = DCAP / 16;        // 8-element chunks a tile
};

// Floats before the page ids: Q (R x (D + 4)), P (R x 68), then kBuf
// stages of K (64 x (D + 4)) and V (64 x D), all fp32; after the page ids
// each warp's lowest and highest position.
template <int R, int DCAP>
inline size_t rows_smem_bytes(int d, int pages) {
  const size_t floats = R * (d + 4) + R * (kKeys + 4) +
                        RowsTile<R, DCAP>::kBuf * kKeys * (2 * d + 4);
  return sizeof(float) * floats + sizeof(int) * (pages + 2 * kDecodeWarps);
}

template <typename QT, typename KT, int R, int DCAP>
__device__ __forceinline__ void rows_tile(const Params& p, unsigned char* smem,
                                          const Seq& sq, int h, int b, int m0,
                                          int mv, int kb, int ke, int split,
                                          int tile) {
  using S = RowsTile<R, DCAP>;
  constexpr bool kF32 = std::is_same<KT, float>::value;
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  const int tid = threadIdx.x;
  const int T = p.t;
  const int D = p.d;
  int lo, hi, ns;
  split_keys(kb, ke, p.n_split, p.granule, split, &lo, &hi, &ns);
  if (split >= ns) return;
  const int QS = D + 4, KS = D + 4, PS = kKeys + 4;
  float* q_s = reinterpret_cast<float*>(smem);
  float* p_s = q_s + R * QS;
  float* kv_s = p_s + R * PS;
  int* pg = reinterpret_cast<int*>(kv_s + S::kBuf * kKeys * (KS + D));
  const size_t hrow = head_row<true>(p, b, h);
  const KT* kc = static_cast<const KT*>(p.k) + hrow * D;
  const KT* vc = static_cast<const KT*>(p.v) + hrow * D;
  const QT* q = static_cast<const QT*>(p.q);
  for (int i = tid; i < R * (D / 8); i += kDecodeThreads) {
    const int r = i / (D / 8);
    const int c = i % (D / 8) * 8;
    float x[8];
    if (r < mv) {
      load8(q + row_offset<true>(p, sq, m0 + r) + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) q_s[r * QS + c + e] = x[e];
  }
  stage_pages<kDecodeThreads>(p, sq.table_row, lo, hi, pg);
  const int p0 = lo / p.page;
  __syncthreads();

  // Fetch 64-key tile (j0, nv) into stage `buf` as fp32: cp.async for fp32
  // caches (keys past nv zero-filled); bf16 and int8 chunks through
  // registers, converted by `land` (int8 dequantized, rounded to q's
  // dtype).  Keys past nv read as zeros, so P.V may run over all 64.
  // Tiles move in chunks of 4 (fp32, cp.async) or 8 (through registers)
  // elements: this thread's column and first row; rows step by rstep
  // (threads beyond rstep whole rows copy nothing).
  const int cpr = D / 4;
  const int rstep = kDecodeThreads / cpr;
  const int c4 = tid % cpr * 4;
  const int r4 = tid < rstep * cpr ? tid / cpr : kKeys;
  const int cpr8 = D / 8;
  const int rstep8 = kDecodeThreads / cpr8;
  const int c8 = tid % cpr8 * 8;
  const int r8 = tid < rstep8 * cpr8 ? tid / cpr8 : kKeys;
  uint4 rk[S::kChunks], rv[S::kChunks];
  float rks[S::kChunks], rvs[S::kChunks];
  auto fetch = [&](int j0, int nv, int buf) {
    float* k_st = kv_s + buf * kKeys * (KS + D);
    float* v_st = k_st + kKeys * KS;
    if (kF32) {
      for (int n = r4; n < kKeys; n += rstep) {
        const bool ok = n < nv;
        const size_t row = ok ? cache_row<true>(p, pg, p0, j0 + n) : 0;
        hopper::cp_async16(k_st + n * KS + c4, kc + row * D + c4, ok);
        hopper::cp_async16(v_st + n * D + c4, vc + row * D + c4, ok);
      }
      hopper::cp_async_commit();
    } else {
#pragma unroll
      for (int u = 0; u < S::kChunks; ++u) {
        const int n = r8 + u * rstep8;
        const int c = c8;
        rk[u] = rv[u] = make_uint4(0u, 0u, 0u, 0u);
        rks[u] = rvs[u] = 0.f;
        if (n < nv) {
          const size_t row = cache_row<true>(p, pg, p0, j0 + n);
          if (kInt8) {
            const uint2 k2 = *reinterpret_cast<const uint2*>(kc + row * D + c);
            const uint2 v2 = *reinterpret_cast<const uint2*>(vc + row * D + c);
            rk[u] = make_uint4(k2.x, k2.y, 0u, 0u);
            rv[u] = make_uint4(v2.x, v2.y, 0u, 0u);
            rks[u] = p.k_scale[hrow + row];
            rvs[u] = p.v_scale[hrow + row];
          } else {
            rk[u] = *reinterpret_cast<const uint4*>(kc + row * D + c);
            rv[u] = *reinterpret_cast<const uint4*>(vc + row * D + c);
          }
        }
      }
    }
  };
  auto land = [&](int buf) {
    if (kF32) return;
    float* k_st = kv_s + buf * kKeys * (KS + D);
    float* v_st = k_st + kKeys * KS;
#pragma unroll
    for (int u = 0; u < S::kChunks; ++u) {
      const int n = r8 + u * rstep8;
      if (n >= kKeys) continue;
      const int c = c8;
      float xk[8], xv[8];
      if (kInt8) {
        unpack(make_uint2(rk[u].x, rk[u].y), xk);
        unpack(make_uint2(rv[u].x, rv[u].y), xv);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          xk[e] = round_to<QT>(xk[e] * rks[u]);
          xv[e] = round_to<QT>(xv[e] * rvs[u]);
        }
      } else {
        unpack(rk[u], xk);
        unpack(rv[u], xv);
      }
#pragma unroll
      for (int e = 0; e < 8; e += 4) {
        *reinterpret_cast<float4*>(k_st + n * KS + c + e) =
            make_float4(xk[e], xk[e + 1], xk[e + 2], xk[e + 3]);
        *reinterpret_cast<float4*>(v_st + n * D + c + e) =
            make_float4(xv[e], xv[e + 1], xv[e + 2], xv[e + 3]);
      }
    }
  };

  // This thread's row r (lanes c of kTpr in one warp), its keys c + kTpr j
  // of each tile and its float4s of features 4 c + 4 kTpr f.
  const int r = tid / S::kTpr;
  const int c = tid % S::kTpr;
  const int t = (m0 + r) % T;
  const int pos = r < mv && t < sq.valid ? sq.first + t : kNoPos;
  const float slope = p.slopes != nullptr && r < mv
                          ? p.slopes[h * p.group + (m0 + r) / T] : 0.f;
  // the tile's lowest and highest positions (kNoPos if a row is not real)
  int pos_lo = pos, pos_hi = pos;
#pragma unroll
  for (int off = S::kTpr; off < kDecodeThreads; off <<= 1) {
    if (off < 32) {
      pos_lo = min(pos_lo, __shfl_xor_sync(0xffffffffu, pos_lo, off));
      pos_hi = max(pos_hi, __shfl_xor_sync(0xffffffffu, pos_hi, off));
    }
  }
  int* warp_pos = pg + p.pages_per_seq + 1;  // [warp] lo, hi
  if ((tid & 31) == 0) {
    warp_pos[2 * (tid >> 5)] = pos_lo;
    warp_pos[2 * (tid >> 5) + 1] = pos_hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kDecodeWarps; ++w) {
    pos_lo = min(pos_lo, warp_pos[2 * w]);
    pos_hi = max(pos_hi, warp_pos[2 * w + 1]);
  }
  float o[S::kNf][4];
#pragma unroll
  for (int f = 0; f < S::kNf; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[f][e] = 0.f;
  float m_i = kNegInf, l_i = 0.f;
  const float sl2 = p.scale * kLog2e;

  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
  if (S::kBuf == 2 && ntiles > 0) {
    fetch(lo, min(kKeys, hi - lo), 0);
    land(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = lo + it * kKeys;
    const int nv = min(kKeys, hi - j0);
    const int buf = S::kBuf == 2 ? it & 1 : 0;
    if (S::kBuf == 2) {
      if (it + 1 < ntiles)
        fetch(j0 + kKeys, min(kKeys, hi - j0 - kKeys), buf ^ 1);
      else if (kF32)
        hopper::cp_async_commit();
      if (kF32) hopper::cp_async_wait<1>();
    } else {
      fetch(j0, nv, 0);
      land(0);
      if (kF32) hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_st = kv_s + buf * kKeys * (KS + D);
    const float* v_st = k_st + kKeys * KS;

    float sc[S::kKpt];
#pragma unroll
    for (int j = 0; j < S::kKpt; ++j) sc[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qd = *reinterpret_cast<const float4*>(q_s + r * QS + d);
#pragma unroll
      for (int j = 0; j < S::kKpt; ++j) {
        const float4 kd = *reinterpret_cast<const float4*>(
            k_st + (c + S::kTpr * j) * KS + d);
        float a = sc[j];
        a = fmaf(qd.x, kd.x, a);
        a = fmaf(qd.y, kd.y, a);
        a = fmaf(qd.z, kd.z, a);
        a = fmaf(qd.w, kd.w, a);
        sc[j] = a;
      }
    }

    // Online softmax of the row over this tile, in log2 units; a tile that
    // needs no mask, softcap or bias for any row runs the plain instance.
    auto softmax = [&](auto plain_tile_t) {
      constexpr bool kPlain = decltype(plain_tile_t)::value;
      bool att[S::kKpt];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < S::kKpt; ++j) {
        const int key = j0 + c + S::kTpr * j;
        float y;
        if (kPlain) {
          att[j] = true;
          y = sc[j] * sl2;
        } else {
          float x = sc[j] * p.scale;
          if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
          if (p.slopes != nullptr) x += slope * static_cast<float>(key - pos);
          att[j] = c + S::kTpr * j < nv && attends(key, pos, p.window);
          y = att[j] ? x * kLog2e : kNegInf;
        }
        sc[j] = y;
        mx = fmaxf(mx, y);
      }
#pragma unroll
      for (int off = S::kTpr / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < S::kKpt; ++j) {
        // -1e30 is finite: masked pairs get p = 0 explicitly
        const float pj = att[j] ? exp2f(sc[j] - m_new) : 0.f;
        sum += pj;
        p_s[r * PS + c + S::kTpr * j] = round_to<QT>(pj);
      }
#pragma unroll
      for (int off = S::kTpr / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = exp2f(m_i - m_new);
      m_i = m_new;
      l_i = l_i * alpha + sum;
#pragma unroll
      for (int f = 0; f < S::kNf; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[f][e] *= alpha;
    };
    const bool plain = nv == kKeys && j0 + kKeys - 1 <= pos_lo &&
                       (p.window <= 0 || j0 > pos_hi - p.window) &&
                       p.softcap <= 0.f && p.slopes == nullptr;
    if (plain)
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    __syncwarp();  // a row's P is written and read by its own warp

    // O += P . V over the tile's keys (keys past nv: p = 0, V rows zero).
    const int nv4 = (nv + 3) & ~3;
    for (int n = 0; n < nv4; n += 4) {
      const float4 pn = *reinterpret_cast<const float4*>(p_s + r * PS + n);
#pragma unroll
      for (int f = 0; f < S::kNf; ++f) {
        const int d = 4 * c + 4 * S::kTpr * f;
        if (d >= D) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = e == 0 ? pn.x : e == 1 ? pn.y : e == 2 ? pn.z : pn.w;
          const float4 vv =
              *reinterpret_cast<const float4*>(v_st + (n + e) * D + d);
          o[f][0] = fmaf(pe, vv.x, o[f][0]);
          o[f][1] = fmaf(pe, vv.y, o[f][1]);
          o[f][2] = fmaf(pe, vv.z, o[f][2]);
          o[f][3] = fmaf(pe, vv.w, o[f][3]);
        }
      }
    }
    if (S::kBuf == 2) land(buf ^ 1);
    __syncthreads();
  }
  if (kF32) hopper::cp_async_wait<0>();

  // One live split writes the output (rows that are not real have l = 0
  // and write zeros); several write their partials and the last merges.
  QT* out = static_cast<QT*>(p.out);
  float* mine = ns > 1 ? partial_slot(p, tile, split) : nullptr;
  if (r < mv) {
    const float inv = 1.f / (l_i == 0.f ? 1.f : l_i);
#pragma unroll
    for (int f = 0; f < S::kNf; ++f) {
      const int d = 4 * c + 4 * S::kTpr * f;
      if (d >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (ns == 1)
          store(out + row_offset<true>(p, sq, m0 + r) + d + e, o[f][e] * inv);
        else
          mine[r * D + d + e] = o[f][e];
      }
    }
    if (ns > 1 && c == 0) {
      mine[R * D + r] = m_i;
      mine[R * D + R + r] = l_i;
    }
  }
  if (ns > 1) merge_if_last<QT, R, true>(p, smem, sq, m0, mv, ns, tile);
}

// Whether row m0 is the only real row of a ragged tile (a decode
// descriptor's, when the tile does not wrap past a query head).
__device__ __forceinline__ bool single_row(const Params& p, const Seq& s,
                                           int m0, int mv) {
  const int T = p.t;
  return m0 / T == (m0 + mv - 1) / T &&
         min((m0 + mv - 1) % T, s.valid - 1) == m0 % T;
}

// Cached: grid (n_split, row_tiles * Hkv, B) in clusters of (n_split, 1,
// 1), 128 threads: block (s, rt + h * row_tiles, b) attends split s of rows
// rt * R .. rt * R + R - 1 of (b, h).  Ragged: grid (row_tiles * Hkv, NB,
// n_split), no clusters, b the descriptor; the last splits and the last
// descriptors (a prefill chunk's longest ranges, and the decode rows the
// scheduler packs after its chunks) are dispatched first.  A ragged tile
// with no real slot writes zeros and leaves; one with a single real row (a
// decode step) runs the one-row instance, which takes four keys a lane
// group at a time instead of spending R rows of math on each; one with
// several runs a rows tile.
template <typename QT, typename KT, int R, typename L, int DCAP = 0>
__global__ void __launch_bounds__(kDecodeThreads)
decode_split_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  count_run(p);
  constexpr bool RAGGED = L::kRagged;
  const int y = RAGGED ? blockIdx.x : blockIdx.y;
  const int rt = y % p.row_tiles;
  const int h = y / p.row_tiles;
  const int b = RAGGED ? gridDim.y - 1 - blockIdx.y : blockIdx.z;
  const int split = RAGGED ? gridDim.z - 1 - blockIdx.z : blockIdx.x;
  const int tile = (b * p.hkv + h) * p.row_tiles + rt;
  const int m0 = rt * R;
  const int mv = min(R, p.group * p.t - m0);
  const Seq sq = sequence<RAGGED>(p, b, h);
  int kb, ke;
  tile_keys<RAGGED>(p, m0, mv, sq, &kb, &ke);
  if constexpr (RAGGED) {
    QT* out = static_cast<QT*>(p.out);
    if (ke <= kb) {  // no real slot: zeros
      if (split == 0) zero_rows<RAGGED, kDecodeThreads>(p, sq, m0, mv, out);
      return;
    }
    if constexpr (R > 1) {
      if (single_row(p, sq, m0, mv)) {
        if (split == 0)
          zero_rows<RAGGED, kDecodeThreads>(p, sq, m0 + 1, mv - 1, out);
        decode_tile<QT, KT, 1, L>(p, smem, sq, h, b, m0, 1, kb, ke, split,
                                  tile);
      } else {
        rows_tile<QT, KT, R, DCAP>(p, smem, sq, h, b, m0, mv, kb, ke, split,
                                   tile);
      }
    } else {
      decode_tile<QT, KT, 1, L>(p, smem, sq, h, b, m0, mv, kb, ke, split,
                                tile);
    }
  } else {
    decode_tile<QT, KT, R, L>(p, smem, sq, h, b, m0, mv, kb, ke, split,
                              tile);
  }
}

// ---------------------------------------------------------------------------
// prefill tiles: shared pieces
// ---------------------------------------------------------------------------

// The block's rows, positions and keys.  Grid (Hkv, B, row tiles): the
// latest row tiles (the longest key walks) of every head are dispatched
// first.  [pos_lo, pos_hi]: the positions of the block's (real) rows.
// Ragged, a slot that is not real is computed like the others but written
// as zero, so it never holds back the unmasked fast path.
struct PrefillTile {
  int h, b, m0, mv, kb, ke, p0, pos_lo, pos_hi;
  Seq s;
};

template <int BM, bool RAGGED>
__device__ __forceinline__ PrefillTile prefill_tile(const Params& p) {
  PrefillTile tl;
  tl.h = blockIdx.x;
  tl.b = blockIdx.y;
  const int T = p.t;
  const int rows = p.group * T;
  tl.m0 = (gridDim.z - 1 - blockIdx.z) * BM;
  tl.mv = min(BM, rows - tl.m0);
  tl.s = sequence<RAGGED>(p, tl.b, tl.h);
  tile_keys<RAGGED>(p, tl.m0, tl.mv, tl.s, &tl.kb, &tl.ke);
  const bool wraps = tl.m0 / T != (tl.m0 + tl.mv - 1) / T;
  int t_hi = wraps ? T - 1 : (tl.m0 + tl.mv - 1) % T;
  if (RAGGED) t_hi = min(t_hi, tl.s.valid - 1);
  tl.pos_lo = tl.s.first + (wraps ? 0 : tl.m0 % T);
  tl.pos_hi = tl.s.first + t_hi;
  tl.p0 = p.page > 0 ? tl.kb / p.page : 0;
  return tl;
}

// Whether row r of the tile is a real query (every cached row is).
template <bool RAGGED>
__device__ __forceinline__ bool real_row(const Params& p,
                                         const PrefillTile& tl, int r) {
  return !RAGGED || (tl.m0 + r) % p.t < tl.s.valid;
}

// Whether keys [j0, j0 + nv) need no mask, softcap or bias for any row of
// the block: then a score is only its scaled dot.
__device__ __forceinline__ bool plain_tile(const Params& p,
                                           const PrefillTile& tl, int j0,
                                           int nv) {
  return nv == kKeys && j0 + kKeys - 1 <= tl.pos_lo &&
         (p.window <= 0 || j0 > tl.pos_hi - p.window) && p.softcap <= 0.f &&
         p.slopes == nullptr;
}


// Raw int8 chunks (8 elements) of one K/V tile held in registers between
// the fetch and the store into shared memory, with their scales.
template <int N>
struct Int8Stage {
  uint2 k[N], v[N];
  float ks[N], vs[N];
};

// ---------------------------------------------------------------------------
// prefill tiles, fp32: register-tiled FMAs
// ---------------------------------------------------------------------------

template <int DCAP>
struct Fma {
  static constexpr int kRows = DCAP > 128 ? 32 : 64;  // query rows a block
  static constexpr int kBuf = DCAP > 128 ? 1 : 2;     // K/V stages
  static constexpr int kRM = kRows / 16;              // rows a thread
  static constexpr int kCN = kKeys / 16;              // keys a thread
  static constexpr int kCD = DCAP / 64;               // float4 features
  static constexpr int kChunks = DCAP / 32;           // int8 chunks a thread
};

// Floats before the page ids: Q (rows x (D + 4)), kBuf x [K (64 x (D + 4)),
// V (64 x D)], P (rows x 68).
template <int DCAP>
inline size_t fma_smem_bytes(int d, int pages) {
  using S = Fma<DCAP>;
  const size_t floats = S::kRows * (d + 4) + S::kBuf * kKeys * (2 * d + 4) +
                        S::kRows * (kKeys + 4);
  return sizeof(float) * floats + sizeof(int) * pages;
}

template <typename KT, int DCAP, typename L>
__global__ void __launch_bounds__(kFmaThreads)
prefill_fma_kernel(const Params p) {
  count_run(p);
  using S = Fma<DCAP>;
  constexpr bool PAGED = L::kPaged;
  constexpr bool RAGGED = L::kRagged;
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.d;
  const int QS = D + 4, KS = D + 4, PS = kKeys + 4;
  float* q_s = reinterpret_cast<float*>(smem);
  float* kv_s = q_s + S::kRows * QS;
  float* p_s = kv_s + S::kBuf * kKeys * (KS + D);
  int* pg = reinterpret_cast<int*>(p_s + S::kRows * PS);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const PrefillTile tl = prefill_tile<S::kRows, RAGGED>(p);
  const int T = p.t;
  float* out = static_cast<float*>(p.out);
  if (RAGGED && tl.ke <= tl.kb) {  // no real slot
    zero_rows<RAGGED, kFmaThreads>(p, tl.s, tl.m0, tl.mv, out);
    return;
  }
  const size_t hrow = head_row<PAGED>(p, tl.b, tl.h);
  const KT* kc = static_cast<const KT*>(p.k) + hrow * D;
  const KT* vc = static_cast<const KT*>(p.v) + hrow * D;
  const float* q = static_cast<const float*>(p.q);

  // Tiles move in 16-byte chunks: this thread's column and first row; rows
  // step by rstep (threads beyond rstep whole rows copy nothing).
  const int cpr = D / 4;
  const int rstep = kFmaThreads / cpr;
  const int c4 = tid % cpr * 4;
  const int r4 = tid < rstep * cpr ? tid / cpr : kKeys;
  for (int r = r4; r < S::kRows; r += rstep)
    hopper::cp_async16(q_s + r * QS + c4,
                       q + row_offset<RAGGED>(p, tl.s,
                                              tl.m0 + min(r, tl.mv - 1)) + c4,
                       r < tl.mv);
  hopper::cp_async_commit();
  if (PAGED) stage_pages<kFmaThreads>(p, tl.s.table_row, tl.kb, tl.ke, pg);
  __syncthreads();

  // int8 tiles move in 8-element chunks, the same way.
  const int rstep8 = kFmaThreads / (D / 8);
  const int c8 = tid % (D / 8) * 8;
  const int r8 = tid < rstep8 * (D / 8) ? tid / (D / 8) : kKeys;

  // Fetch tile (j0, nv) into stage `buf`: fp32 by cp.async (keys past nv
  // zero-filled), int8 into registers (landed by `land`).
  Int8Stage<S::kChunks> reg;
  auto fetch = [&](int j0, int nv, int buf) {
    float* k_st = kv_s + buf * kKeys * (KS + D);
    float* v_st = k_st + kKeys * KS;
    if (!kInt8) {
      for (int n = r4; n < kKeys; n += rstep) {
        const bool ok = n < nv;
        const size_t row = ok ? cache_row<PAGED>(p, pg, tl.p0, j0 + n) : 0;
        hopper::cp_async16(k_st + n * KS + c4, kc + row * D + c4, ok);
        hopper::cp_async16(v_st + n * D + c4, vc + row * D + c4, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < S::kChunks; ++u) {
        const int n = r8 + u * rstep8;
        if (n < nv) {
          const int d = c8;
          const size_t row = cache_row<PAGED>(p, pg, tl.p0, j0 + n);
          reg.k[u] = *reinterpret_cast<const uint2*>(kc + row * D + d);
          reg.v[u] = *reinterpret_cast<const uint2*>(vc + row * D + d);
          reg.ks[u] = p.k_scale[hrow + row];
          reg.vs[u] = p.v_scale[hrow + row];
        } else {
          reg.k[u] = reg.v[u] = make_uint2(0u, 0u);
          reg.ks[u] = reg.vs[u] = 0.f;
        }
      }
    }
    hopper::cp_async_commit();
  };
  auto land = [&](int buf) {
    if (!kInt8) return;
    float* k_st = kv_s + buf * kKeys * (KS + D);
    float* v_st = k_st + kKeys * KS;
#pragma unroll
    for (int u = 0; u < S::kChunks; ++u) {
      const int n = r8 + u * rstep8;
      if (n >= kKeys) continue;
      const int d = c8;
      float xk[8], xv[8];
      unpack(reg.k[u], xk);
      unpack(reg.v[u], xv);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        k_st[n * KS + d + e] = xk[e] * reg.ks[u];
        v_st[n * D + d + e] = xv[e] * reg.vs[u];
      }
    }
  };

  int pos[S::kRM];
  float slope[S::kRM];
  float4 acc[S::kRM][S::kCD];
  float m_i[S::kRM], l_i[S::kRM];
#pragma unroll
  for (int i = 0; i < S::kRM; ++i) {
    const int r = ty + 16 * i;
    pos[i] = tl.s.first + (tl.m0 + r) % T;
    slope[i] = (p.slopes != nullptr && r < tl.mv)
                   ? p.slopes[tl.h * p.group + (tl.m0 + r) / T] : 0.f;
    m_i[i] = kNegInf;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < S::kCD; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const float sl2 = p.scale * kLog2e;

  const int ntiles = tl.ke > tl.kb ? (tl.ke - tl.kb + kKeys - 1) / kKeys : 0;
  if (S::kBuf == 2 && ntiles > 0) {
    fetch(tl.kb, min(kKeys, tl.ke - tl.kb), 0);
    land(0);
  }
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = tl.kb + it * kKeys;
    const int nv = min(kKeys, tl.ke - j0);
    const int buf = S::kBuf == 2 ? it & 1 : 0;
    if (S::kBuf == 2) {
      if (it + 1 < ntiles)
        fetch(j0 + kKeys, min(kKeys, tl.ke - j0 - kKeys), buf ^ 1);
      else
        hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      fetch(j0, nv, 0);
      land(0);
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* k_st = kv_s + buf * kKeys * (KS + D);
    const float* v_st = k_st + kKeys * KS;

    float s[S::kRM][S::kCN];
#pragma unroll
    for (int i = 0; i < S::kRM; ++i)
#pragma unroll
      for (int j = 0; j < S::kCN; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float4 qd[S::kRM], kd[S::kCN];
#pragma unroll
      for (int i = 0; i < S::kRM; ++i)
        qd[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * QS + d);
#pragma unroll
      for (int j = 0; j < S::kCN; ++j)
        kd[j] = *reinterpret_cast<const float4*>(k_st + (tx + 16 * j) * KS + d);
#pragma unroll
      for (int i = 0; i < S::kRM; ++i)
#pragma unroll
        for (int j = 0; j < S::kCN; ++j) {
          float a = s[i][j];
          a = fmaf(qd[i].x, kd[j].x, a);
          a = fmaf(qd[i].y, kd[j].y, a);
          a = fmaf(qd[i].z, kd[j].z, a);
          a = fmaf(qd[i].w, kd[j].w, a);
          s[i][j] = a;
        }
    }

    // Online softmax in log2 units (exp2); each row's 64 scores sit on the
    // 16 tx lanes of a half-warp.  A tile that needs no mask, softcap or
    // bias runs the plain instance.
    auto softmax = [&](auto plain_tile_t) {
      constexpr bool kPlain = decltype(plain_tile_t)::value;
#pragma unroll
      for (int i = 0; i < S::kRM; ++i) {
        const int r = ty + 16 * i;
        bool att[S::kCN];
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < S::kCN; ++j) {
          const int n = tx + 16 * j;
          const int key = j0 + n;
          float y;
          if (kPlain) {
            att[j] = true;
            y = s[i][j] * sl2;
          } else {
            float x = s[i][j] * p.scale;
            if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
            if (p.slopes != nullptr)
              x += slope[i] * static_cast<float>(key - pos[i]);
            att[j] = n < nv && attends(key, pos[i], p.window);
            y = att[j] ? x * kLog2e : kNegInf;
          }
          s[i][j] = y;
          mx = fmaxf(mx, y);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_i[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < S::kCN; ++j) {
          // -1e30 is finite: masked pairs get p = 0 explicitly
          const float pj = att[j] ? exp2f(s[i][j] - m_new) : 0.f;
          sum += pj;
          p_s[r * PS + tx + 16 * j] = pj;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float alpha = exp2f(m_i[i] - m_new);
        m_i[i] = m_new;
        l_i[i] = l_i[i] * alpha + sum;
#pragma unroll
        for (int c = 0; c < S::kCD; ++c) {
          acc[i][c].x *= alpha;
          acc[i][c].y *= alpha;
          acc[i][c].z *= alpha;
          acc[i][c].w *= alpha;
        }
      }
    };
    if (plain_tile(p, tl, j0, nv))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});
    __syncthreads();

    // O += P . V, four keys at a time (keys past nv have p = 0 and zero V
    // rows); a thread owns features 4 tx + 64 c.
    const int nv4 = (nv + 3) & ~3;
    for (int n0 = 0; n0 < nv4; n0 += 4) {
      float4 pn[S::kRM];
#pragma unroll
      for (int i = 0; i < S::kRM; ++i)
        pn[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * PS + n0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int c = 0; c < S::kCD; ++c) {
          const int d = 4 * tx + 64 * c;
          if (d >= D) continue;
          const float4 vv =
              *reinterpret_cast<const float4*>(v_st + (n0 + e) * D + d);
#pragma unroll
          for (int i = 0; i < S::kRM; ++i) {
            const float pe = e == 0 ? pn[i].x : e == 1 ? pn[i].y
                           : e == 2 ? pn[i].z : pn[i].w;
            acc[i][c].x = fmaf(pe, vv.x, acc[i][c].x);
            acc[i][c].y = fmaf(pe, vv.y, acc[i][c].y);
            acc[i][c].z = fmaf(pe, vv.z, acc[i][c].z);
            acc[i][c].w = fmaf(pe, vv.w, acc[i][c].w);
          }
        }
      }
    }
    if (S::kBuf == 2) land(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < S::kRM; ++i) {
    const int r = ty + 16 * i;
    if (r >= tl.mv) continue;
    const bool real = real_row<RAGGED>(p, tl, r);
    const float l = l_i[i] == 0.f ? 1.f : l_i[i];
    float* o = out + row_offset<RAGGED>(p, tl.s, tl.m0 + r);
#pragma unroll
    for (int c = 0; c < S::kCD; ++c) {
      const int d = 4 * tx + 64 * c;
      if (d < D)
        *reinterpret_cast<float4*>(o + d) =
            real ? make_float4(acc[i][c].x / l, acc[i][c].y / l,
                               acc[i][c].z / l, acc[i][c].w / l)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// prefill tiles, bf16: mma.sync on tensor cores
// ---------------------------------------------------------------------------

template <typename KT, int DCAP>
struct Mma {
  static constexpr int kChunks = DCAP / 16;  // int8 chunks a thread a tile
  // K/V stages: cp.async tiles run two ahead (one at D > 128, for shared
  // memory); int8 tiles pass through registers, one ahead.
  static constexpr int kStages =
      std::is_same<KT, int8_t>::value || DCAP > 128 ? 2 : 3;
};

// bf16 elements before the page ids: Q and the stages of K and V, each
// 64 rows x (round_up(D, 16) + 8).
template <typename KT, int DCAP>
inline size_t mma_smem_bytes(int d, int pages) {
  const size_t sd = (d + 15) / 16 * 16 + 8;
  return sizeof(__nv_bfloat16) * (1 + 2 * Mma<KT, DCAP>::kStages) * kKeys *
             sd + sizeof(int) * pages;
}

template <typename KT, int DCAP, typename L>
__global__ void __launch_bounds__(kMmaThreads)
prefill_mma_kernel(const Params p) {
  count_run(p);
  using bf16 = __nv_bfloat16;
  using S = Mma<KT, DCAP>;
  constexpr bool PAGED = L::kPaged;
  constexpr bool RAGGED = L::kRagged;
  constexpr bool kInt8 = std::is_same<KT, int8_t>::value;
  constexpr int kN = DCAP / 8;  // output n-tiles of 8 features
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = p.d;
  const int DP = (D + 15) / 16 * 16;
  const int SD = DP + 8;  // row stride: 16 bytes past a multiple of 128
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* kv_s = q_s + kKeys * SD;  // stage s: K at kv_s + 2 s 64 SD, V after
  int* pg = reinterpret_cast<int*>(kv_s + 2 * S::kStages * kKeys * SD);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const PrefillTile tl = prefill_tile<64, RAGGED>(p);
  const int T = p.t;
  bf16* out = static_cast<bf16*>(p.out);
  if (RAGGED && tl.ke <= tl.kb) {  // no real slot
    zero_rows<RAGGED, kMmaThreads>(p, tl.s, tl.m0, tl.mv, out);
    return;
  }
  const size_t hrow = head_row<PAGED>(p, tl.b, tl.h);
  const KT* kc = static_cast<const KT*>(p.k) + hrow * D;
  const KT* vc = static_cast<const KT*>(p.v) + hrow * D;
  const bf16* q = static_cast<const bf16*>(p.q);

  if (DP != D) {  // the padding columns of Q and K must read as zeros
    for (int i = tid; i < (1 + 2 * S::kStages) * kKeys * SD / 8;
         i += kMmaThreads)
      reinterpret_cast<uint4*>(q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  // Tiles move in 8-element chunks: this thread's column and first row;
  // rows step by rstep (threads beyond rstep whole rows copy nothing).
  const int cpr = D / 8;
  const int rstep = kMmaThreads / cpr;
  const int c8 = tid % cpr * 8;
  const int r8 = tid < rstep * cpr ? tid / cpr : kKeys;
  for (int r = r8; r < kKeys; r += rstep)
    hopper::cp_async16(q_s + r * SD + c8,
                       q + row_offset<RAGGED>(p, tl.s,
                                              tl.m0 + min(r, tl.mv - 1)) + c8,
                       r < tl.mv);
  hopper::cp_async_commit();
  if (PAGED) stage_pages<kMmaThreads>(p, tl.s.table_row, tl.kb, tl.ke, pg);
  __syncthreads();

  Int8Stage<S::kChunks> reg;
  auto fetch = [&](int j0, int nv, int buf) {
    bf16* k_st = kv_s + 2 * buf * kKeys * SD;
    bf16* v_st = k_st + kKeys * SD;
    if (!kInt8) {
      for (int n = r8; n < kKeys; n += rstep) {
        const bool ok = n < nv;
        const size_t row = ok ? cache_row<PAGED>(p, pg, tl.p0, j0 + n) : 0;
        hopper::cp_async16(k_st + n * SD + c8, kc + row * D + c8, ok);
        hopper::cp_async16(v_st + n * SD + c8, vc + row * D + c8, ok);
      }
    } else {
#pragma unroll
      for (int u = 0; u < S::kChunks; ++u) {
        const int n = r8 + u * rstep;
        if (n < nv) {
          const int d = c8;
          const size_t row = cache_row<PAGED>(p, pg, tl.p0, j0 + n);
          reg.k[u] = *reinterpret_cast<const uint2*>(kc + row * D + d);
          reg.v[u] = *reinterpret_cast<const uint2*>(vc + row * D + d);
          reg.ks[u] = p.k_scale[hrow + row];
          reg.vs[u] = p.v_scale[hrow + row];
        } else {
          reg.k[u] = reg.v[u] = make_uint2(0u, 0u);
          reg.ks[u] = reg.vs[u] = 0.f;
        }
      }
    }
    hopper::cp_async_commit();
  };
  auto land = [&](int buf) {
    if (!kInt8) return;
    bf16* k_st = kv_s + 2 * buf * kKeys * SD;
    bf16* v_st = k_st + kKeys * SD;
#pragma unroll
    for (int u = 0; u < S::kChunks; ++u) {
      const int n = r8 + u * rstep;
      if (n >= kKeys) continue;
      const int d = c8;
      float xk[8], xv[8];
      unpack(reg.k[u], xk);
      unpack(reg.v[u], xv);
      uint4 ok, ov;
      ok.x = hopper::pack_bf16(xk[0] * reg.ks[u], xk[1] * reg.ks[u]);
      ok.y = hopper::pack_bf16(xk[2] * reg.ks[u], xk[3] * reg.ks[u]);
      ok.z = hopper::pack_bf16(xk[4] * reg.ks[u], xk[5] * reg.ks[u]);
      ok.w = hopper::pack_bf16(xk[6] * reg.ks[u], xk[7] * reg.ks[u]);
      ov.x = hopper::pack_bf16(xv[0] * reg.vs[u], xv[1] * reg.vs[u]);
      ov.y = hopper::pack_bf16(xv[2] * reg.vs[u], xv[3] * reg.vs[u]);
      ov.z = hopper::pack_bf16(xv[4] * reg.vs[u], xv[5] * reg.vs[u]);
      ov.w = hopper::pack_bf16(xv[6] * reg.vs[u], xv[7] * reg.vs[u]);
      *reinterpret_cast<uint4*>(k_st + n * SD + d) = ok;
      *reinterpret_cast<uint4*>(v_st + n * SD + d) = ov;
    }
  };

  // This thread's two rows: warp rows g and g + 8.
  int pos[2];
  float slope[2], m_i[2], l_i[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + g + 8 * e;
    pos[e] = tl.s.first + (tl.m0 + r) % T;
    slope[e] = (p.slopes != nullptr && r < tl.mv)
                   ? p.slopes[tl.h * p.group + (tl.m0 + r) / T] : 0.f;
    m_i[e] = kNegInf;
    l_i[e] = 0.f;
  }
  float o[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[n][i] = 0.f;
  const float sl2 = p.scale * kLog2e;

  const int ntiles = tl.ke > tl.kb ? (tl.ke - tl.kb + kKeys - 1) / kKeys : 0;
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < ntiles) {
      fetch(tl.kb + s * kKeys, min(kKeys, tl.ke - tl.kb - s * kKeys), s);
      land(s);
    } else {
      hopper::cp_async_commit();
    }
  }
  for (int it = 0; it < ntiles; ++it) {
    const int j0 = tl.kb + it * kKeys;
    const int nv = min(kKeys, tl.ke - j0);
    const int buf = it % S::kStages;
    const int ahead = it + S::kStages - 1;
    if (ahead < ntiles)
      fetch(tl.kb + ahead * kKeys, min(kKeys, tl.ke - tl.kb - ahead * kKeys),
            ahead % S::kStages);
    else
      hopper::cp_async_commit();
    hopper::cp_async_wait<S::kStages - 1>();
    __syncthreads();
    const bf16* k_st = kv_s + 2 * buf * kKeys * SD;
    const bf16* v_st = k_st + kKeys * SD;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DCAP / 16; ++kk) {
      if (kk * 16 >= DP) break;
      uint32_t a[4];
      hopper::ldmatrix_x4(a, q_s + (16 * warp + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * SD +
                                 kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t bk[4];
        hopper::ldmatrix_x4(bk, k_st + (16 * jp + (lane & 7) +
                                        (lane >> 4) * 8) * SD +
                                    kk * 16 + ((lane >> 3) & 1) * 8);
        hopper::mma_16816(s[2 * jp], a, bk[0], bk[1]);
        hopper::mma_16816(s[2 * jp + 1], a, bk[2], bk[3]);
      }
    }

    // Online softmax in log2 units (exp2) of rows g (e = 0: s[.][0..1]) and
    // g + 8 (e = 1); a row's 64 scores sit on the 4 lanes of a quad.  A
    // tile that needs no mask, softcap or bias runs the plain instance.
    auto softmax = [&](auto plain_tile_t) {
      constexpr bool kPlain = decltype(plain_tile_t)::value;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float mx = kNegInf;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float y;
            if (kPlain) {
              y = s[j][2 * e + c] * sl2;
            } else {
              const int n = 8 * j + 2 * tq + c;
              const int key = j0 + n;
              float x = s[j][2 * e + c] * p.scale;
              if (p.softcap > 0.f) x = p.softcap * tanhf(x / p.softcap);
              if (p.slopes != nullptr)
                x += slope[e] * static_cast<float>(key - pos[e]);
              y = n < nv && attends(key, pos[e], p.window) ? x * kLog2e
                                                           : kNegInf;
            }
            s[j][2 * e + c] = y;
            mx = fmaxf(mx, y);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m_i[e], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            // -1e30 is finite: masked pairs get p = 0 explicitly
            const float y = s[j][2 * e + c];
            const float pj =
                kPlain || y > 0.5f * kNegInf ? exp2f(y - m_new) : 0.f;
            sum += pj;
            s[j][2 * e + c] = pj;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const float alpha = exp2f(m_i[e] - m_new);
        m_i[e] = m_new;
        l_i[e] = l_i[e] * alpha + sum;
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          o[n][2 * e] *= alpha;
          o[n][2 * e + 1] *= alpha;
        }
      }
    };
    if (plain_tile(p, tl, j0, nv))
      softmax(std::true_type{});
    else
      softmax(std::false_type{});

    // O += P . V, P rounded to bf16 from the score registers.
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      hopper::frag_from_acc(a, s, kk);
#pragma unroll
      for (int dp = 0; dp < DCAP / 16; ++dp) {
        if (dp * 16 >= DP) break;
        uint32_t bv[4];
        hopper::ldmatrix_x4_trans(bv, v_st + (16 * kk + (lane & 7) +
                                              ((lane >> 3) & 1) * 8) * SD +
                                          dp * 16 + (lane >> 4) * 8);
        hopper::mma_16816(o[2 * dp], a, bv[0], bv[1]);
        hopper::mma_16816(o[2 * dp + 1], a, bv[2], bv[3]);
      }
    }
    land(ahead % S::kStages);
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = 16 * warp + g + 8 * e;
    if (r >= tl.mv) continue;
    const bool real = real_row<RAGGED>(p, tl, r);
    const float inv = 1.f / (l_i[e] == 0.f ? 1.f : l_i[e]);
    bf16* orow = out + row_offset<RAGGED>(p, tl.s, tl.m0 + r);
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d >= D) break;
      *reinterpret_cast<uint32_t*>(orow + d) =
          real ? hopper::pack_bf16(o[n][2 * e] * inv, o[n][2 * e + 1] * inv)
               : 0u;
    }
  }
}

// ---------------------------------------------------------------------------
// host: one launch per call
// ---------------------------------------------------------------------------

#ifdef __CUDACC__

template <typename Kernel>
cudaError_t launch_kernel(Kernel kernel, dim3 grid, int threads, size_t smem,
                          const Params& p, cudaStream_t stream,
                          int cluster = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename QT, typename KT, int R, int DCAP>
cudaError_t launch_rows_dcap(const Params& p, dim3 grid, int pages,
                             cudaStream_t st) {
  const size_t rows = rows_smem_bytes<R, DCAP>(p.d, pages);
  const size_t one = decode_smem_bytes<KT, 1>(p.d, pages);
  return launch_kernel(decode_split_kernel<QT, KT, R, Ragged, DCAP>, grid,
                       kDecodeThreads, rows > one ? rows : one, p, st);
}

template <typename QT, typename KT, int R>
cudaError_t launch_ragged_rows(const Params& p, dim3 grid, int pages,
                               cudaStream_t st) {
  if (p.d <= 64) return launch_rows_dcap<QT, KT, R, 64>(p, grid, pages, st);
  if (p.d <= 128) return launch_rows_dcap<QT, KT, R, 128>(p, grid, pages, st);
  return launch_rows_dcap<QT, KT, R, 256>(p, grid, pages, st);
}

template <typename QT, typename KT, typename L>
cudaError_t launch_decode(const Params& p, int batch, int tile_rows,
                          cudaStream_t st) {
  const int pages = L::kPaged ? p.pages_per_seq + 1 : 0;
  if constexpr (L::kRagged) {
    const dim3 grid(p.row_tiles * p.hkv, batch, p.n_split);
    switch (tile_rows) {
      case 1:
        return launch_kernel(decode_split_kernel<QT, KT, 1, L>, grid,
                             kDecodeThreads,
                             decode_smem_bytes<KT, 1>(p.d, pages), p, st);
      case 4:
        return launch_ragged_rows<QT, KT, 4>(p, grid, pages, st);
      case 8:
        return launch_ragged_rows<QT, KT, 8>(p, grid, pages, st);
      default:
        return cudaErrorInvalidValue;
    }
  } else {
    const dim3 grid(p.n_split, p.row_tiles * p.hkv, batch);
    switch (tile_rows) {
      case 1:
        return launch_kernel(decode_split_kernel<QT, KT, 1, L>, grid,
                             kDecodeThreads,
                             decode_smem_bytes<KT, 1>(p.d, pages), p, st,
                             p.n_split);
      case 4:
        return launch_kernel(decode_split_kernel<QT, KT, 4, L>, grid,
                             kDecodeThreads,
                             decode_smem_bytes<KT, 4>(p.d, pages), p, st,
                             p.n_split);
      case 8:
        return launch_kernel(decode_split_kernel<QT, KT, 8, L>, grid,
                             kDecodeThreads,
                             decode_smem_bytes<KT, 8>(p.d, pages), p, st,
                             p.n_split);
      default:
        return cudaErrorInvalidValue;
    }
  }
}

template <typename KT, typename L>
cudaError_t launch_fma(const Params& p, int batch, cudaStream_t st) {
  const int pages = L::kPaged ? p.pages_per_seq + 1 : 0;
  const int rows = p.group * p.t;
  if (p.d <= 64)
    return launch_kernel(prefill_fma_kernel<KT, 64, L>,
                         dim3(p.hkv, batch, (rows + 63) / 64), kFmaThreads,
                         fma_smem_bytes<64>(p.d, pages), p, st);
  if (p.d <= 128)
    return launch_kernel(prefill_fma_kernel<KT, 128, L>,
                         dim3(p.hkv, batch, (rows + 63) / 64), kFmaThreads,
                         fma_smem_bytes<128>(p.d, pages), p, st);
  return launch_kernel(prefill_fma_kernel<KT, 256, L>,
                       dim3(p.hkv, batch, (rows + 31) / 32), kFmaThreads,
                       fma_smem_bytes<256>(p.d, pages), p, st);
}

template <typename KT, typename L>
cudaError_t launch_mma(const Params& p, int batch, cudaStream_t st) {
  const int pages = L::kPaged ? p.pages_per_seq + 1 : 0;
  const dim3 grid(p.hkv, batch, (p.group * p.t + 63) / 64);
  if (p.d <= 64)
    return launch_kernel(prefill_mma_kernel<KT, 64, L>, grid, kMmaThreads,
                         mma_smem_bytes<KT, 64>(p.d, pages), p, st);
  if (p.d <= 128)
    return launch_kernel(prefill_mma_kernel<KT, 128, L>, grid,
                         kMmaThreads, mma_smem_bytes<KT, 128>(p.d, pages), p,
                         st);
  return launch_kernel(prefill_mma_kernel<KT, 256, L>, grid, kMmaThreads,
                       mma_smem_bytes<KT, 256>(p.d, pages), p, st);
}

// One kernel launch over `batch` sequences (ragged: descriptors): decode
// tiles of `tile_rows` rows (1, 4 or 8) split n_split ways (a cluster of
// n_split blocks each), or, with tile_rows 0, prefill tiles.  q_dtype 0
// fp32, 1 bf16; int8 caches when k_scale is set.
template <typename L>
cudaError_t launch_cached(Params p, int batch, int q_dtype, int tile_rows,
                          cudaStream_t st) {
  if (p.n_split < 1 || p.n_split > kMaxSplits || p.granule < 1 ||
      tile_rows < 0)
    return cudaErrorInvalidValue;
  p.row_tiles = tile_rows > 0 ? (p.group * p.t + tile_rows - 1) / tile_rows
                              : 0;
  p.part_rows = tile_rows;
  if (L::kRagged && tile_rows > 0 && p.n_split > 1 &&
      (p.part == nullptr || p.tickets == nullptr))
    return cudaErrorInvalidValue;
  const bool int8 = p.k_scale != nullptr;
  if (q_dtype == 0) {
    if (tile_rows > 0)
      return int8 ? launch_decode<float, int8_t, L>(p, batch, tile_rows, st)
                  : launch_decode<float, float, L>(p, batch, tile_rows, st);
    return int8 ? launch_fma<int8_t, L>(p, batch, st)
                : launch_fma<float, L>(p, batch, st);
  }
  if (q_dtype == 1) {
    using bf16 = __nv_bfloat16;
    if (tile_rows > 0)
      return int8 ? launch_decode<bf16, int8_t, L>(p, batch, tile_rows, st)
                  : launch_decode<bf16, bf16, L>(p, batch, tile_rows, st);
    return int8 ? launch_mma<int8_t, L>(p, batch, st)
                : launch_mma<bf16, L>(p, batch, st);
  }
  return cudaErrorInvalidValue;
}

#endif  // __CUDACC__

}  // namespace decode_core
