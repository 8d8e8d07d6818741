// Ragged (packed mixed-batch) attention over a paged KV pool, read through a
// block table (sm_90a).  The layouts, the score order and the design are
// those of csrc/paged_attention.cu's header, which describes both kernels;
// this translation unit holds the ragged launcher alone, so that nvcc builds
// it beside the paged decode one.
//
// Replaces penroz_tpu/ops/pallas/ragged_paged_attention.py::
// ragged_paged_attention (:161).
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

extern "C" int penroz_ragged_paged_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* table, const void* descs,
    const void* slopes, void* out, int num_descs, int block_q, int hq,
    int hkv, int d, int page, int pages_per_seq, long long pool_rows,
    int q_dtype, int window, float scale, float softcap, int tile_rows,
    int n_split, int granule, void* part, void* tickets, void* runs,
    void* stream) {
  decode_core::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.slopes = static_cast<const float*>(slopes);
  p.table = static_cast<const int*>(table);
  p.descs = static_cast<const int*>(descs);
  p.out = out;
  p.kv_rows = pool_rows;
  p.max_len = pages_per_seq * page;
  p.page = page;
  p.page_shift = page_shift(page);
  p.pages_per_seq = pages_per_seq;
  p.hkv = hkv;
  p.t = block_q;
  p.tp = num_descs * block_q;
  p.d = d;
  p.group = hq / hkv;
  p.window = window;
  p.scale = scale;
  p.softcap = softcap;
  p.n_split = n_split;
  p.granule = granule;
  p.part = static_cast<float*>(part);
  p.tickets = static_cast<int*>(tickets);
  p.runs = static_cast<unsigned long long*>(runs);
  return decode_core::launch_cached<decode_core::Ragged>(
      p, num_descs, q_dtype, tile_rows, static_cast<cudaStream_t>(stream));
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
