#!/usr/bin/env python3
"""Where a ragged launch's time goes, block by block, on one NVIDIA card.

Builds an instrumented copy of the ragged kernel
(csrc/ragged_paged_attention.cu and csrc/decode_core.cuh copied under build/ragged_timeline/, not the
package's build): thread 0 of each decode-tile block writes the
``%globaltimer`` at its start, when its key walk ends and at its end, its
SM, and ``clock64`` cycles spent in the walk's phases (one-row decode
tiles: waiting for a pass's keys, and its math; rows tiles: fetch and
wait, Q.K, softmax, P.V), to a device array set through an extra
exported setter.  For each
phase-3 ragged case named (chip_smoke.ragged_cases(), the same inputs) it
prints the launch's time (chip_smoke._time_ms, L2 flushed), then, from one
stamped launch after a flush: the span, the most blocks alive at once, and
for padding, prefill-chunk and decode descriptors the blocks' start, walk
and duration (p50 / p90 / max, µs), the longest decode descriptor's
blocks, how many blocks started in each 5 µs, and the mean cycles of each
phase a pass (decode) or a 64-key tile (rows).  ``--splits`` and
``--granule`` override the plan's split count and granule.  Decode-tile
launches only (fewer than 64 query rows a kv head).

Run from the repository root on a machine with the card:
  python3 scripts/torch_ragged_timeline.py [CASE ...] [--splits N]
                                           [--granule KEYS]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ragged_timeline")

# (text in decode_core.cuh, its stamped form): start, walk end, end, and
# the walk's phases (slots 4-7, 8 the passes or tiles, 9 the tile kind).
WALK = "  STAMP(1, gtime());\n"
TICK = "    c1 = clock64(); ph[{}] += c1 - c0; c0 = c1;\n"
STAMPS = [
    ("decode_split_kernel(const Params p) {\n",
     "decode_split_kernel(const Params p) {\n"
     "  STAMP(0, gtime()); STAMP(3, smid_());\n"),
    ("      if (split == 0) zero_rows<RAGGED, kDecodeThreads>(p, sq, m0, mv, "
     "out);\n",
     "      if (split == 0) zero_rows<RAGGED, kDecodeThreads>(p, sq, m0, mv, "
     "out);\n      STAMP(1, gtime()); STAMP(2, gtime());\n"),
    ("      hopper::cluster_arrive_relaxed();\n    }\n    return;\n",
     "      hopper::cluster_arrive_relaxed();\n    }\n  " + WALK +
     "    return;\n"),
    ("  hopper::cp_async_wait<0>();\n\n  // Merge the lane groups",
     "  hopper::cp_async_wait<0>();\n" + WALK +
     "  STAMP(4, dw); STAMP(5, clock64() - d0); STAMP(8, npass); "
     "STAMP(9, 2);\n\n  // Merge the lane groups"),
    ("  for (int pass = 0; pass < npass; ++pass) {\n"
     "    issue(pass + kRing - 1);\n    hopper::cp_async_wait<kRing - 1>();\n",
     "  long long dw = 0, d0 = clock64(), d1;\n"
     "  for (int pass = 0; pass < npass; ++pass) {\n"
     "    issue(pass + kRing - 1);\n    hopper::cp_async_wait<kRing - 1>();\n"
     "    d1 = clock64(); dw += d1 - d0; d0 = d1;\n"),
    ("  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;\n"
     "  if (S::kBuf == 2 && ntiles > 0) {",
     "  long long ph[4] = {0, 0, 0, 0}, c0 = clock64(), c1;\n"
     "  const int ntiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;\n"
     "  if (S::kBuf == 2 && ntiles > 0) {"),
    ("    const float* v_st = k_st + kKeys * KS;\n\n    float sc[S::kKpt];",
     "    const float* v_st = k_st + kKeys * KS;\n" + TICK.format(0) +
     "\n    float sc[S::kKpt];"),
    ("    // Online softmax of the row over this tile, in log2 units; a tile",
     TICK.format(1) +
     "    // Online softmax of the row over this tile, in log2 units; a tile"),
    ("    __syncwarp();  // a row's P is written and read by its own warp\n",
     "    __syncwarp();  // a row's P is written and read by its own warp\n" +
     TICK.format(2)),
    ("    if (S::kBuf == 2) land(buf ^ 1);\n    __syncthreads();\n  }\n"
     "  if (kF32) hopper::cp_async_wait<0>();",
     "    if (S::kBuf == 2) land(buf ^ 1);\n    __syncthreads();\n" +
     TICK.format(3) + "  }\n"
     "  STAMP(4, ph[0]); STAMP(5, ph[1]); STAMP(6, ph[2]); STAMP(7, ph[3]);\n"
     "  STAMP(8, ntiles); STAMP(9, 1);\n"
     "  if (kF32) hopper::cp_async_wait<0>();"),
    ("  if (split >= ns) return;\n  const int QS",
     "  if (split >= ns) {\n  " + WALK + "    return;\n  }\n  const int QS"),
    ("  if (kF32) hopper::cp_async_wait<0>();\n\n  // One live split",
     "  if (kF32) hopper::cp_async_wait<0>();\n" + WALK +
     "\n  // One live split"),
    ("                              tile);\n  }\n}\n",
     "                              tile);\n  }\n  STAMP(2, gtime());\n}\n"),
]
HEADER = """namespace decode_core {
__device__ unsigned long long* g_stamps;
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned smid_() {
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  return s;
}
#define STAMP(k, v) do { if (g_stamps != nullptr && threadIdx.x == 0) \\
  g_stamps[((size_t(blockIdx.z) * gridDim.y + blockIdx.y) * gridDim.x + \\
            blockIdx.x) * 10 + (k)] = (v); } while (0)
"""


def instrumented_library(build) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    for name in ("decode_core.cuh", "hopper.cuh",
                 "ragged_paged_attention.cu"):
        shutil.copy(os.path.join(build.CSRC_DIR, name), OUT)
    path = os.path.join(OUT, "decode_core.cuh")
    core = open(path).read()
    core = core.replace("namespace decode_core {\n", HEADER, 1)
    for old, new in STAMPS:
        if core.count(old) != 1:
            raise RuntimeError(f"stamp anchor not found once: {old!r}")
        core = core.replace(old, new)
    open(path, "w").write(core)
    with open(os.path.join(OUT, "ragged_paged_attention.cu"), "a") as f:
        f.write('\nextern "C" int penroz_set_stamps(void* p) {\n'
                '  return cudaMemcpyToSymbol(decode_core::g_stamps, &p, '
                'sizeof(p));\n}\n')
    lib = os.path.join(OUT, "libragged_timeline.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(OUT, "ragged_paged_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(proc.stderr[-4000:])
    return ctypes.CDLL(lib)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cases", nargs="*", default=["ragged_gpt2_mixed"])
    parser.add_argument("--splits", type=int, default=None)
    parser.add_argument("--granule", type=int, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import build
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.utils import bucketing
    lib = instrumented_library(build)
    fn = lib.penroz_ragged_paged_attention
    fn.argtypes, fn.restype = RPA._ARGTYPES, ctypes.c_int
    lib.penroz_set_stamps.argtypes = [ctypes.c_void_p]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    print(f"card: {torch.cuda.get_device_name(0)}")
    cases = {c["name"]: c for c in C.ragged_cases()}
    for name in args.cases:
        case = cases[name]
        Hq, Hkv, D, P, BQ = (case[k] for k in ("Hq", "Hkv", "D", "P", "BQ"))
        spans = [(i, q0, n) for i, (q0, n) in enumerate(case["spans"])]
        dtype = getattr(torch, case["dtype"])
        ends = [q0 + n for _, q0, n in spans]
        pages = -(-max(ends) // P)
        k, v, table, scales = C._random_pools(
            torch, ends, Hkv, D, P, pages, dtype, case.get("int8"),
            case["seed"])
        NB = bucketing.bucket_count(sum(-(-n // BQ) for _, _, n in spans)
                                    + case.get("padding", 0))
        descs_np, _ = KV.build_descriptors(spans, BQ, NB)
        descs = torch.as_tensor(descs_np, device="cuda")
        q = torch.randn(1, Hq, NB * BQ, D, device="cuda").to(dtype)
        plan = RPA.ragged_plan(NB, BQ, Hq, Hkv, pages, P, case.get("window"),
                               DA.sm_count(q.device))
        if plan.tile_rows == 0:
            print(f"{name}: prefill tiles, not stamped")
            continue
        ns = args.splits or plan.n_split
        granule = args.granule or plan.granule
        tiles = NB * Hkv * plan.row_tiles
        blocks = tiles * ns
        stamps = torch.zeros(blocks * 10, dtype=torch.int64, device="cuda")
        out = torch.empty_like(q)
        part = torch.empty(tiles * ns * plan.tile_rows * (D + 2),
                           device="cuda")
        tickets = torch.zeros(tiles, dtype=torch.int32, device="cuda")
        ks, vs = scales.get("k_scale"), scales.get("v_scale")
        slopes = (DA.slopes_on(A.alibi_slopes(Hq), q.device)
                  if case.get("alibi") else None)

        def launch():
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     ks.data_ptr() if ks is not None else None,
                     vs.data_ptr() if vs is not None else None,
                     table.data_ptr(), descs.data_ptr(),
                     slopes.data_ptr() if slopes is not None else None,
                     out.data_ptr(), NB, BQ, Hq, Hkv, D, P, pages, k.shape[1],
                     build.DTYPE_CODES[dtype], case.get("window") or 0,
                     D ** -0.5, float(case.get("softcap") or 0.0),
                     plan.tile_rows, ns, granule, part.data_ptr(),
                     tickets.data_ptr(), None, build.stream(q))
            if err:
                raise RuntimeError(f"launch failed: CUDA error {err}")

        lib.penroz_set_stamps(None)
        ms = C._time_ms(torch, launch, 20, flush)
        lib.penroz_set_stamps(stamps.data_ptr())
        flush.zero_()
        launch()
        torch.cuda.synchronize()
        lib.penroz_set_stamps(None)
        s = stamps.view(-1, 10).cpu().numpy().astype(np.float64)
        t0 = s[:, 0].min()
        start, walk_end, end = ((s[:, i] - t0) / 1e3 for i in range(3))
        ids = np.arange(blocks)
        b = NB - 1 - (ids // (Hkv * plan.row_tiles)) % NB  # reversed grid
        kind = np.where(descs_np[b, 0] < 0, "padding",
                        np.where(descs_np[b, 2] == 1, "decode", "chunk"))
        events = sorted([(x, 1) for x in start] + [(x, -1) for x in end])
        alive = peak = 0
        for _, e in events:
            alive += e
            peak = max(peak, alive)
        print(f"{name}: splits {ns} granule {granule} tile rows "
              f"{plan.tile_rows}, {blocks} blocks, {ms * 1e3:.1f} µs timed, "
              f"span {end.max():.1f} µs, at most {peak} alive on "
              f"{len(set(s[:, 3]))} SMs")
        for kd in ("padding", "chunk", "decode"):
            m = kind == kd
            if not m.any():
                continue

            def q3(x):
                return "/".join(f"{v:.1f}" for v in np.percentile(
                    x[m], [50, 90, 100]))
            print(f"  {kd:8s} {m.sum():5d} blocks: start {q3(start)} walk "
                  f"{q3(walk_end - start)} duration {q3(end - start)} µs "
                  f"(p50/p90/max)")
        longest = int(np.argmax(np.where(descs_np[:, 0] >= 0,
                                         descs_np[:, 1] + descs_np[:, 2], -1)))
        m = b == longest
        print(f"  longest descriptor {longest}: blocks start "
              f"{start[m].min():.1f}-{start[m].max():.1f} µs, walk up to "
              f"{(walk_end - start)[m].max():.1f} µs, end {end[m].max():.1f} "
              f"µs")
        h, _ = np.histogram(start, bins=np.arange(0, end.max() + 5, 5))
        print(f"  blocks started each 5 µs: {h.tolist()}")
        for kd, names in ((2, ("wait", "math")),
                          (1, ("fetch+wait", "Q.K", "softmax", "P.V"))):
            m = (s[:, 9] == kd) & (s[:, 8] > 0)
            if m.any():
                per = [np.mean(s[m, 4 + i] / s[m, 8]) for i in
                       range(len(names))]
                what = "pass" if kd == 2 else "64-key tile"
                print(f"  {'decode' if kd == 2 else 'rows'} tiles: {m.sum()} "
                      f"blocks, {np.mean(s[m, 8]):.2f} a block; cycles a "
                      f"{what}: " + ", ".join(
                          f"{n} {v:.0f}" for n, v in zip(names, per)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
