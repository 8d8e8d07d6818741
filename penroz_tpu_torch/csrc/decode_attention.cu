// Cached attention of T new queries against a contiguous KV cache (sm_90a).
//
// Replaces penroz_tpu/ops/pallas/decode_attention.py::decode_attention (:155),
// the TPU kernel behind ops/attention.py::cached_attention.  Same contract:
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
// (2·Hkv·L·D·itemsize bytes over 3.35 TB/s: 1.9 µs at GPT-2's L 1024 in
// fp32); a long prefill (T = L) is bound by its L²/2 score pairs instead.
// What the design does about it (csrc/decode_core.cuh, shared with the
// paged kernel): decode tiles (T·G < 64 rows) split each (batch, kv head)'s
// valid key range across enough blocks to cover the SMs and merge the
// splits' partial softmax states in the same launch (one thread-block
// cluster per row tile, through distributed shared memory, in split
// order); each block keeps its scores in registers and streams its keys
// through a cp.async ring.  Prefill tiles (T·G >= 64 rows)
// run 64-row query tiles over double-buffered 64-key tiles, skipping the
// tiles above the diagonal: bf16 on tensor cores (mma.sync), fp32 on
// register-tiled FMAs.  The key loops stop at the last position a tile's
// rows attend (and start at the window's first), so traffic tracks the
// valid length, not S_max; int8 caches are read as int8 and dequantized on
// chip.
//
// Plain C interface for ctypes; returns a cudaError_t (0 on success).

#include "decode_core.cuh"

extern "C" int penroz_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* lengths, int length, const void* slopes,
    void* out, int batch, int hq, int hkv, int t, int s, int d, int q_dtype,
    int window, float scale, float softcap, int tile_rows, int n_split,
    int granule, void* runs, void* stream) {
  decode_core::Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.lengths = static_cast<const int*>(lengths);
  p.length = length;
  p.slopes = static_cast<const float*>(slopes);
  p.out = out;
  p.kv_rows = s;
  p.max_len = s;
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
  return decode_core::launch_cached<decode_core::Contiguous>(
      p, batch, q_dtype, tile_rows, static_cast<cudaStream_t>(stream));
}

extern "C" const char* penroz_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
