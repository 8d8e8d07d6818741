#!/usr/bin/env python3
"""Where a chunked-GLA launch's time goes, tile by tile, on one NVIDIA card.

Builds an instrumented copy of the kernel (csrc/ssm_scan.cu copied under
build/gla_timeline/, not the package's build, with ``build.NVCC_FLAGS``):
thread 0 of each block writes the ``%globaltimer`` at the end of each
phase of its tile, and its SM, to a device array set through an extra
exported setter.  The phases: ticket taken, K and V landed and the
log-gates scanned, local state computed and published, the carry's
flags seen, the carry summed (and a checkpoint's state published), Q
landed, scores and outputs written (warp 0's rows).  For each phase-3 GLA case named
(``chip_smoke.gla_cases()``, the same inputs) it prints the launch's
time (``chip_smoke._time_ms``, L2 flushed), then from one stamped launch
after a flush: the span, the most blocks alive at once, and each phase's
duration over the tiles (p50 / p90 / max, µs).  ``--one-pass`` builds the
copy with one TF32 pass a product in place of three (wrong to 2^-11; for
timing only), to show what the split products cost; ``--min-blocks N``
builds it with ``__launch_bounds__(128, N)`` (the kernel's is 3), and
``--stride N`` overrides ``ssm_scan.carry_stride``.

Run from the repository root on a machine with the card:
  python3 scripts/torch_gla_timeline.py [CASE ...] [--one-pass]
                                        [--min-blocks N] [--stride N]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "gla_timeline")
NSLOT = 10  # stamps a tile: phases 0-6 and 8, SM id (7)
# the phase that ends at each slot
PHASES = {1: "K V + gates", 2: "local + publish", 3: "carry flags",
          4: "carry sum", 5: "Q landed", 8: "scores + A V", 6: "outputs"}

# (text in ssm_scan.cu, its stamped form).  Slots: 0 ticket taken, 1 K, V
# and the gates in, 2 local state published, 3 the carry's flags seen, 4
# the carry summed (a checkpoint's state published), 5 Q landed, 8 scores
# and the first A V done (tiles that sum their carry after them), 6
# outputs written, 7 the SM; all as thread 0 sees them.  A tile's phases are its stamps in time order.
STAMPS = [
    ("namespace {\n\nconstexpr int kTile = 64;",
     "namespace {\n__device__ long long* g_stamps;\n__shared__ int tile_s;\n"
     "__device__ __forceinline__ long long gtime() {\n"
     "  long long t; asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));"
     " return t; }\n"
     "__device__ __forceinline__ int smid_() {\n"
     "  int s; asm volatile(\"mov.u32 %0, %smid;\" : \"=r\"(s)); return s; }\n"
     "#define STAMP(i, v) do { if (threadIdx.x == 0 && g_stamps) "
     "g_stamps[(size_t)tile_s * 10 + (i)] = (v); } while (0)\n"
     "\nconstexpr int kTile = 64;"),
    ("  __shared__ int tile_s;\n", ""),
    ("  const int tile = tile_s;\n",
     "  const int tile = tile_s;\n  STAMP(0, gtime()); STAMP(7, smid_());\n"),
    ("  cp_async_wait<1>();\n  __syncthreads();\n",
     "  cp_async_wait<1>();\n  __syncthreads();\n  STAMP(1, gtime());\n"),
    ("    publish(p.flags + 1 + bh * n + c, p.epoch, last);\n",
     "    publish(p.flags + 1 + bh * n + c, p.epoch, last);\n"
     "  STAMP(2, gtime());\n"),
    ("    if (tid < m) lsv[tid] = wait_for(flags + j0 + tid, p.epoch);\n"
     "    __syncwarp();\n",
     "    if (tid < m) lsv[tid] = wait_for(flags + j0 + tid, p.epoch);\n"
     "    __syncwarp();\n    STAMP(3, gtime());\n"),
    ("  if (tid == 0 && checkpoint) publish(flags + c, p.epoch, last);\n",
     "  if (tid == 0 && checkpoint) publish(flags + c, p.epoch, last);\n"
     "  STAMP(4, gtime());\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n\n  const bool late",
     "  cp_async_wait<0>();\n  __syncthreads();\n  STAMP(5, gtime());\n\n"
     "  const bool late"),
    ("    if (pass == 0 && late) carry(",
     "    if (pass == 0) STAMP(8, gtime());\n    if (pass == 0 && late) carry("),
    ("  tile_outputs<X, FULL>(p, L, smem, c, bh, rows, late, last, yb);\n}\n",
     "  tile_outputs<X, FULL>(p, L, smem, c, bh, rows, late, last, yb);\n"
     "  STAMP(6, gtime());\n}\n"),
    ("// Dynamic shared memory a block takes at dk, dv.\n",
     "extern \"C\" int penroz_gla_set_stamps(void* p) {\n"
     "  long long* q = static_cast<long long*>(p);\n"
     "  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &q, "
     "sizeof(q)));\n}\n\n// Dynamic shared memory a block takes at dk, dv.\n"),
]
ONE_PASS = ("  if (!AX) mma(c, al, bh);\n  if (!BX) mma(c, ah, bl);\n", "")


def build_copy(one_pass: bool, min_blocks=None):
    """The instrumented library (stamps; one TF32 pass and other launch
    bounds if asked)."""
    sys.path.insert(0, ROOT)
    from penroz_tpu_torch.ops.kernels import build
    with open(os.path.join(build.CSRC_DIR, "ssm_scan.cu")) as f:
        src = f.read()
    bounds = ("__launch_bounds__(kThreads, 3)",
              f"__launch_bounds__(kThreads, {min_blocks})")
    for old, new in STAMPS + ([ONE_PASS] if one_pass else []) + (
            [bounds] if min_blocks else []):
        if src.count(old) != 1:
            raise SystemExit(f"instrumentation point not found once: "
                             f"{old[:60]!r}")
        src = src.replace(old, new)
    shutil.rmtree(OUT, ignore_errors=True)
    os.makedirs(OUT)
    cu = os.path.join(OUT, "ssm_scan_timeline.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(OUT, "libgla_timeline.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", lib,
                           cu], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed:\n{proc.stderr}")
    return ctypes.CDLL(lib)


def _q(xs, f):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(f * len(xs)))]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("cases", nargs="*")
    parser.add_argument("--one-pass", action="store_true")
    parser.add_argument("--min-blocks", type=int, default=None)
    parser.add_argument("--stride", type=int, default=None)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    lib = build_copy(args.one_pass, args.min_blocks)
    sys.path.insert(0, ROOT)
    import chip_smoke
    from penroz_tpu_torch.ops.kernels import ssm_scan as SS
    lib.penroz_gla_set_stamps.argtypes = [ctypes.c_void_p]
    lib.penroz_cuda_error_string.argtypes = [ctypes.c_int]
    lib.penroz_cuda_error_string.restype = ctypes.c_char_p
    SS.build._LIBS["ssm_scan"] = lib  # the wrapper launches the copy
    if args.stride:
        SS.carry_stride = lambda dk, dv: args.stride
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    names = set(args.cases)
    for case in chip_smoke.gla_cases():
        if names and case["name"] not in names:
            continue
        B, T, H = case["B"], case["T"], case["H"]
        dtype = getattr(torch, case["dtype"])
        g = torch.Generator(device="cuda").manual_seed(case["seed"])
        q = (torch.randn(B, T, H, case["dk"], device="cuda", generator=g)
             * case["dk"] ** -0.5).to(dtype)
        k = torch.randn(B, T, H, case["dk"], device="cuda",
                        generator=g).to(dtype)
        v = torch.randn(B, T, H, case["dv"], device="cuda",
                        generator=g).to(dtype)
        gates = torch.sigmoid(torch.randn(B, T, H, device="cuda",
                                          generator=g))
        tiles = B * H * (-(-T // SS.KERNEL_TILE))
        lib.penroz_gla_set_stamps(None)
        fn = lambda: SS.gla_chunked(q, k, v, gates)  # noqa: E731
        ms = chip_smoke._time_ms(torch, fn, 10, flush)
        stamps = torch.zeros(tiles, NSLOT, dtype=torch.int64, device="cuda")
        lib.penroz_gla_set_stamps(stamps.data_ptr())
        flush.zero_()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        lib.penroz_gla_set_stamps(None)
        s = stamps.cpu()
        t0 = int(s[:, 0].min())
        start, end = s[:, 0] - t0, s[:, 6] - t0
        events = sorted([(int(a), 1) for a in start] +
                        [(int(b), -1) for b in end])
        alive = most = 0
        for _, d in events:
            alive += d
            most = max(most, alive)
        variant = "".join(f" ({k} {v})" for k, v in (
            ("one pass", "" if args.one_pass else None),
            ("min blocks", args.min_blocks), ("stride", args.stride)) if v)
        print(f"{case['name']}{variant}: "
              f"{ms:.4f} ms, {tiles} tiles, span "
              f"{float(end.max()) / 1e3:.1f} us, at most {most} alive, "
              f"SMs {len(set(s[:, 7].tolist()))}")
        print(f"  start us p50 {_q(start.tolist(), .5) / 1e3:.1f} max "
              f"{float(start.max()) / 1e3:.1f}")
        phases = {name: [] for name in PHASES.values()}
        for tile in range(tiles):
            st = s[tile].tolist()
            order = sorted((st[i], i) for i in PHASES if st[i])
            prev = st[0]
            for t, slot in order:
                phases[PHASES[slot]].append(t - prev)
                prev = t
        for name in PHASES.values():
            d = phases[name] or [0]
            print(f"  {name:>16}: p50 {_q(d, .5) / 1e3:7.2f} p90 "
                  f"{_q(d, .9) / 1e3:7.2f} max {max(d) / 1e3:7.2f} us "
                  f"({len(phases[name])} tiles)")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
