// Attention over a paged KV pool, read through a block table (sm_90a): the
// paged decode kernel here, the ragged (packed mixed-batch) kernel in
// csrc/ragged_paged_attention.cu.  Both instantiate the one decode core; two
// translation units, so that nvcc builds them side by side.
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
//   window).
// - Ragged: q (1, Hq, Tp, D) packed, Tp = NB · block_q; descriptor d =
//   (row, q_pos0, q_valid, kv_len) owns packed slots [d·block_q,
//   (d+1)·block_q); slot t is query position q_pos0 + t, attending keys
//   k <= q_pos0 + t (and k > position - window) of sequence `row`.  Slots
//   t >= q_valid and descriptors with row = -1 write zeros.  The query
//   group folds into rows in kv-major order, as in the Pallas kernel: row r
//   of kv head h is query head h·G + r / block_q, slot r % block_q.
//
// Both run on the decode core (csrc/decode_core.cuh: Paged and Ragged
// layouts of one set of kernels); a ragged descriptor is a sequence to it,
// with its key range [window start of its first real slot, q_pos0 +
// q_valid).  What bounds them on an H100: at decode every live K/V row is
// read once for 4·D flops per query row, so bytes (each sequence's or
// descriptor's live pages once per kv head); at a long prefill the L²/2
// score pairs.  What the design does about it: decode tiles (G·T < 64
// rows a kv head) split each key range in whole granules across blocks,
// keep scores in registers and stream keys through a cp.async ring; each
// block reads its split's page ids into shared memory once (one table
// lookup per page).  The paged decode sizes its split count from the SM
// count and merges a tile's splits in a thread-block cluster.  The ragged
// kernel's descriptors stay on the device (the wrapper reads nothing
// back, so the launch depends on shapes alone and stays capturable): its
// plan comes from the pool's span, the splits that hold no key leave at
// once, the live ones merge through scratch (the last to finish sums them
// in split order), and the longest ranges are dispatched first.  A ragged
// tile with no real slot (padding) writes zeros and leaves, a decode
// step's runs one row four keys a lane group at a time, a prefill chunk's
// several rows run 64-key tiles through shared memory with one softmax a
// row and tile.  Prefill tiles (G·T >= 64, e.g. block_q 128) run tensor
// cores (bf16 mma.sync) or register-tiled FMAs (fp32) over a ring of
// 64-key cp.async tiles, never reading tiles above a row's diagonal.
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

// log2(page) when page is a power of two, else -1 (decode_core's
// cache_row then divides).
int page_shift(int page) {
  int shift = 0;
  while ((1 << shift) < page) ++shift;
  return (1 << shift) == page ? shift : -1;
}

}  // namespace

extern "C" int penroz_paged_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* lengths, int length,
    const void* slopes, void* out, int batch, int hq, int hkv, int t, int d,
    int page, int pages_per_seq, long long pool_rows, int q_dtype, int window,
    float scale, float softcap, int tile_rows, int n_split, int granule,
    void* runs, void* stream) {
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
  p.page_shift = page_shift(page);
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
  p.runs = static_cast<unsigned long long*>(runs);
  return decode_core::launch_cached<decode_core::Paged>(
      p, batch, q_dtype, tile_rows, static_cast<cudaStream_t>(stream));
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
