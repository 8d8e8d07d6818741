// Attention over a paged KV pool, read through a block table (sm_90a): the
// paged decode kernel and the ragged (packed mixed-batch) kernel.
//
// Replaces penroz_tpu/ops/pallas/paged_attention.py::paged_decode_attention
// (:152) and penroz_tpu/ops/pallas/ragged_paged_attention.py::
// ragged_paged_attention (:161).  Both read K/V from head-major pools
// (Hkv, num_pages * P, D): logical key j of a sequence lives at pool row
// table[seq, j / P] * P + j % P.  Pools are fp32/bf16 in the query dtype, or
// int8 with (Hkv, rows, 1) fp32 per-token scales, dequantized on chip.
// Score order, as in the Pallas kernels: scale, then softcap·tanh(s/softcap),
// then ALiBi slope·(j - position), then the mask with the finite -1e30.
// Running max, sum and accumulator are fp32; a row with no attended key
// writes zeros.
//
// - Paged decode: q (B, Hq, T, D); query t of sequence b sits at position
//   len_b - T + t and attends keys j <= that position (and j > position -
//   window).  It is the contiguous decode kernel with the page table in
//   front (csrc/decode_core.cuh, PAGED = true).  What bounds it on an H100:
//   at decode every live K/V row is read once for 4·D flops per query row,
//   so bytes (each sequence's live pages once per kv head); at a long
//   prefill the L²/2 score pairs.  What the design does about it: decode
//   tiles (T·G < 64 rows) split each sequence's live key range, in whole
//   pages, across enough blocks to cover the SMs, merge the splits in the
//   same launch, keep scores in registers and stream keys through a
//   cp.async ring; each block reads its split's page ids into shared
//   memory once (one table lookup per page).  Prefill tiles run tensor
//   cores (bf16) or register-tiled FMAs (fp32) over double-buffered 64-key
//   tiles.
// - Ragged: q (1, Hq, Tp, D) packed, Tp = NB · block_q; descriptor d =
//   (row, q_pos0, q_valid, kv_len) owns packed slots [d·block_q,
//   (d+1)·block_q); slot t is query position q_pos0 + t, attending keys
//   k <= q_pos0 + t of sequence `row`.  Slots t >= q_valid and descriptors
//   with row = -1 write zeros.  One block per (tile of 16 query rows,
//   kv head, descriptor).  The query group folds into rows in kv-major
//   order, as in the Pallas kernel: row r of kv head h is query head
//   h·G + r / block_q, slot r % block_q.  What bounds it: as the paged
//   decode, bytes at decode and score pairs at prefill.  What the design
//   does: the key loop of each block stops at the last position its rows
//   attend and starts at the window's first, so traffic tracks the live
//   length, not the table's span; int8 pools are read as int8.  What it does
//   not do yet: split the key axis, overlap loads with compute, or use
//   tensor cores.
//
// Unassigned table entries (-1) are clamped to page 0 before any address
// arithmetic (they back only masked positions), and pool offsets are 64-bit.
//
// Plain C interface for ctypes; each launcher returns a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_core.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockM = 16;  // query rows per block
constexpr int kBlockN = 64;  // keys per tile (two per lane in the softmax)
constexpr int kDescCols = 4;
using decode_core::kNegInf;

struct Params {
  const void* q;
  const void* k;         // (Hkv, pool_rows, D)
  const void* v;
  const float* k_scale;  // (Hkv, pool_rows, 1), or null unless int8
  const float* v_scale;
  const int* table;      // (num_seqs, pages_per_seq)
  // Unused since the paged decode kernel moved to decode_core.cuh; kept so
  // the ragged kernel's parameter layout, which moves ptxas's schedule,
  // stays as it was until the ragged kernel's redesign drops them.
  const int* lengths;
  int length;
  const int* descs;      // ragged: (NB, 4)
  const float* slopes;   // (Hq,) ALiBi slopes, or null
  void* out;
  int hkv, d, group;
  int t;                 // block_q
  int tp;                // ragged: packed length NB · block_q
  int page, pages_per_seq;
  long long pool_rows;
  int window;            // 0: no window
  float scale;
  float softcap;         // 0: no softcap
};

using decode_core::attends;
using decode_core::load8;
using decode_core::round_to;
using decode_core::store;

// What one block attends: rows m0 .. m0 + mv of kv head h, row r at
// q_rows + (r / T) · group_stride + (r % T) · D (same for out), query
// token t = r % T at position first + t, real only for t < t_valid; keys
// [kv_begin, kv_end) of the sequence whose block-table row is `table`.
struct Tile {
  size_t q_off;         // element offset of row 0 of this kv head
  size_t group_stride;  // elements between query heads of the group
  int m0, mv, first, t_valid, kv_begin, kv_end, h;
  const int* table;
};

// Pool row of logical key j (the table entry clamped to page 0 when
// unassigned, the page index clamped to the table), in 64 bits.
__device__ __forceinline__ size_t pool_row(const Params& p, const int* table,
                                           int j) {
  const int page = min(j / p.page, p.pages_per_seq - 1);
  const int phys = max(table[page], 0);
  return static_cast<size_t>(phys) * p.page + j % p.page;
}

template <typename QT, typename KT>
__device__ void attend_tile(const Params& p, const Tile& tl, float* smem) {
  const int D = p.d;
  const int DK = D + 1;
  const int T = p.t;
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
  const int m0 = tl.m0, mv = tl.mv, first = tl.first;
  const QT* q = static_cast<const QT*>(p.q) + tl.q_off;
  QT* out = static_cast<QT*>(p.out) + tl.q_off;
  const size_t head = static_cast<size_t>(tl.h) * p.pool_rows;
  const KT* k = static_cast<const KT*>(p.k) + head * D;
  const KT* v = static_cast<const KT*>(p.v) + head * D;
  const float* ks = p.k_scale != nullptr ? p.k_scale + head : nullptr;
  const float* vs = p.v_scale != nullptr ? p.v_scale + head : nullptr;

  for (int c = tid; c < mv * D / 8; c += kThreads) {
    const int m = (c * 8) / D;
    const int d = (c * 8) % D;
    const int r = m0 + m;
    float x[8];
    load8(q + (r / T) * tl.group_stride + static_cast<size_t>(r % T) * D + d,
          x);
#pragma unroll
    for (int i = 0; i < 8; ++i) q_s[m * D + d + i] = x[i];
  }
  for (int i = tid; i < mv * D; i += kThreads) acc_s[i] = 0.f;
  if (tid < kBlockM) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  for (int j0 = tl.kv_begin; j0 < tl.kv_end; j0 += kBlockN) {
    const int nv = min(kBlockN, tl.kv_end - j0);
    for (int c = tid; c < nv * D / 8; c += kThreads) {
      const int n = (c * 8) / D;
      const int d = (c * 8) % D;
      const size_t row = pool_row(p, tl.table, j0 + n);
      float xk[8], xv[8];
      load8(k + row * D + d, xk);
      load8(v + row * D + d, xv);
      if (ks != nullptr) {
        const float sk = ks[row];
        const float sv = vs[row];
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

    // Scores of (row, key) pairs; keys past nv, outside the mask, or of a
    // padding row get -1e30.
    for (int i = tid; i < mv * kBlockN; i += kThreads) {
      const int m = i / kBlockN;
      const int n = i % kBlockN;
      float s = kNegInf;
      const int r = m0 + m;
      const int t = r % T;
      if (n < nv && t < tl.t_valid) {
        const int pos = first + t;
        const int j = j0 + n;
        const float* qr = q_s + m * D;
        const float* kr = k_s + n * DK;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], kr[d], dot);
        s = dot * p.scale;
        if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
        if (p.slopes != nullptr)
          s += p.slopes[tl.h * p.group + r / T] * static_cast<float>(j - pos);
        if (!attends(j, pos, p.window)) s = kNegInf;
      }
      p_s[i] = s;
    }
    __syncthreads();

    // Online softmax, one warp per row.  -1e30 is finite, so masked keys
    // get p = 0 explicitly (a row masked so far would otherwise see
    // exp(-1e30 - -1e30) = 1 and count phantom keys in l).
    for (int m = warp; m < mv; m += kWarps) {
      const int t = (m0 + m) % T;
      const bool row_ok = t < tl.t_valid;
      const int pos = first + t;
      const float m_prev = m_s[m];
      const float s0 = p_s[m * kBlockN + lane];
      const float s1 = p_s[m * kBlockN + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_prev, mx);
      const bool a0 = row_ok && lane < nv && attends(j0 + lane, pos, p.window);
      const bool a1 =
          row_ok && lane + 32 < nv && attends(j0 + lane + 32, pos, p.window);
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
    const int m = i / D;
    const int d = i % D;
    const int r = m0 + m;
    const float l = l_s[m];
    store(out + (r / T) * tl.group_stride + static_cast<size_t>(r % T) * D + d,
          acc_s[i] / (l == 0.f ? 1.f : l));
  }
}

// The block's token range: a tile that wraps past a group boundary holds
// both t = T - 1 and t = 0.
__device__ __forceinline__ void token_range(int m0, int mv, int T, int* t_lo,
                                            int* t_hi) {
  *t_lo = 0;
  *t_hi = T - 1;
  if (m0 / T == (m0 + mv - 1) / T) {
    *t_lo = m0 % T;
    *t_hi = (m0 + mv - 1) % T;
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
ragged_paged_kernel(const Params p) {
  extern __shared__ float smem[];
  const int dsc = blockIdx.z;
  const int h = blockIdx.y;
  const int BQ = p.t;
  const int* desc = p.descs + dsc * kDescCols;
  const int row = desc[0];
  const int q_pos0 = desc[1];
  const int q_valid = row >= 0 ? desc[2] : 0;
  Tile tl;
  tl.h = h;
  tl.m0 = blockIdx.x * kBlockM;
  tl.mv = min(kBlockM, p.group * BQ - tl.m0);
  tl.first = q_pos0;
  tl.t_valid = q_valid;
  int t_lo, t_hi;
  token_range(tl.m0, tl.mv, BQ, &t_lo, &t_hi);
  t_hi = min(t_hi, q_valid - 1);
  // A padding block (no real row) walks no key and writes zeros.
  tl.kv_end = t_lo <= t_hi ? min(q_pos0 + t_hi + 1,
                                 p.pages_per_seq * p.page) : 0;
  tl.kv_begin = p.window > 0 ? max(0, q_pos0 + t_lo - p.window + 1) : 0;
  // q (Hkv, group, Tp, D): row r of this block is query head h·G + r / BQ,
  // packed slot dsc·BQ + r % BQ.
  tl.q_off = (static_cast<size_t>(h) * p.group * p.tp +
              static_cast<size_t>(dsc) * BQ) * p.d;
  tl.group_stride = static_cast<size_t>(p.tp) * p.d;
  tl.table = p.table + static_cast<size_t>(max(row, 0)) * p.pages_per_seq;
  attend_tile<QT, KT>(p, tl, smem);
}

// Dynamic shared memory of one block: Q, K (padded), V, P, acc, m/l/alpha.
size_t smem_bytes(int d) {
  return sizeof(float) * (2 * kBlockM * d + kBlockN * (d + 1) + kBlockN * d +
                          kBlockM * kBlockN + 3 * kBlockM);
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, const Params& p, dim3 grid,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p.d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* k_scale, const void* v_scale,
                   const void* table, const void* slopes, void* out, int hq,
                   int hkv, int t, int d, int page, int pages_per_seq,
                   long long pool_rows, int window, float scale,
                   float softcap) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.slopes = static_cast<const float*>(slopes);
  p.out = out;
  p.hkv = hkv;
  p.d = d;
  p.group = hq / hkv;
  p.t = t;
  p.page = page;
  p.pages_per_seq = pages_per_seq;
  p.pool_rows = pool_rows;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  return p;
}

}  // namespace

extern "C" int penroz_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, int length,
    const void* slopes, void* out, int batch, int hq, int hkv, int t, int d,
    int page, int pages_per_seq, long long pool_rows, int q_dtype, int window,
    float scale, float softcap, int tile_rows, int n_split, int granule,
    void* stream) {
  decode_core::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.length = length;
  p.slopes = static_cast<const float*>(slopes);
  p.table = static_cast<const int*>(table);
  p.out = out;
  p.kv_rows = pool_rows;
  p.max_len = pages_per_seq * page;
  p.page = page;
  p.pages_per_seq = pages_per_seq;
  p.hkv = hkv;
  p.t = t;
  p.d = d;
  p.group = hq / hkv;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.n_split = n_split;
  p.granule = granule;
  return decode_core::launch_cached<true>(
      p, batch, q_dtype, tile_rows, static_cast<cudaStream_t>(stream));
}

extern "C" int penroz_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* descs,
    const void* slopes, void* out, int num_descs, int block_q, int hq,
    int hkv, int d, int page, int pages_per_seq, long long pool_rows,
    int q_dtype, int window, float scale, float softcap, void* stream) {
  Params p = make_params(q, k, v, k_scale, v_scale, table, slopes, out, hq,
                         hkv, block_q, d, page, pages_per_seq, pool_rows,
                         window, scale, softcap);
  p.descs = static_cast<const int*>(descs);
  p.tp = num_descs * block_q;
  const dim3 grid((p.group * block_q + kBlockM - 1) / kBlockM, hkv,
                  num_descs);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quantized = k_scale != nullptr;
  if (q_dtype == 0)
    return quantized ? launch(ragged_paged_kernel<float, int8_t>, p, grid, st)
                     : launch(ragged_paged_kernel<float, float>, p, grid, st);
  if (q_dtype == 1)
    return quantized
               ? launch(ragged_paged_kernel<__nv_bfloat16, int8_t>, p, grid,
                        st)
               : launch(ragged_paged_kernel<__nv_bfloat16, __nv_bfloat16>, p,
                        grid, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
