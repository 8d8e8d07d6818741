#!/usr/bin/env python3
"""Where a block of the recurrent-update kernel (csrc/ssm_update.cu) spends
its time, on one NVIDIA card.

Builds a copy of the kernel's source with time stamps (the SM's clock64 and
the global timer) written by thread 0 of block (0, 0, 0) -- row 0, head 0,
column tile 0, the long row of phase 3's mixed step -- at each phase: the
slot list, the state tile, and per stage the end of its fill, the data's
arrival, the end of its slots and the end of its y reduction.  Runs
chip_smoke.py's phase-3 recurrent-update cases through the wrapper with
that build and prints, per case, the kernel's device time (torch.profiler,
warm, no flush) and the stamps' durations: mean ns a stage of each phase.
The stamps sit at marked lines of the source; the script stops if one has
moved.  The build lives under build/ssm_update_probe/.

Run from the repository root on a machine with the card:
  python3 scripts/torch_ssm_update_probe.py
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(ROOT, "penroz_tpu_torch", "csrc", "ssm_update.cu")
OUT = os.path.join(ROOT, "build", "ssm_update_probe")
SLOTS = 512

HEADER = """
__device__ long long g_stamp[2][%d];
__device__ __forceinline__ long long probe_ns() {
  long long t;
  asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i) do { if (blockIdx.x + blockIdx.y + blockIdx.z == 0 && \\
    threadIdx.x == 0 && (i) < %d) { g_stamp[0][(i)] = clock64(); \\
    g_stamp[1][(i)] = probe_ns(); } } while (0)
""" % (SLOTS, SLOTS)

# (marked line, stamp placed after it); stage s's stamps are 10 + 4 s ..
STAMPS = [
    ("    atomicAdd(p.runs, 1ull);\n", "  STAMP(0);\n"),
    ("  if (n == 0) return;\n", "  STAMP(1);\n"),
    ("  hopper::cp_async_wait<kStages - 1>();  // the state tile\n"
     "  __syncthreads();\n", "  STAMP(2);\n"),
    ("    if (s + kStages - 1 < nstages) fill(s + kStages - 1);\n"
     "    hopper::cp_async_commit();\n", "    STAMP(10 + 4 * s);\n"),
    ("    __syncthreads();                        // everyone's\n",
     "    STAMP(11 + 4 * s);\n"),
    ("    __syncthreads();  // the partials; stage s's buffer is free\n",
     "    STAMP(12 + 4 * s);\n"),
    ("            (sum.x + sum.y) + (sum.z + sum.w);\n      }\n    }\n",
     "    STAMP(13 + 4 * s);\n"),
    ("  // the state, once, through the tile\n", None),
]


def probe_source() -> str:
    src = open(SOURCE).read()
    src = src.replace("namespace {\n", "namespace {\n" + HEADER, 1)
    for line, stamp in STAMPS:
        if line not in src:
            raise SystemExit(f"marked line moved: {line!r}")
        new = line + stamp if stamp else "  STAMP(3);\n" + line
        src = src.replace(line, new, 1)
    return src + """
extern "C" int probe_read(long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_stamp, sizeof(g_stamp));
}
"""


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as CS
    from penroz_tpu_torch.ops.kernels import build
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    os.makedirs(OUT, exist_ok=True)
    src_path = os.path.join(os.path.dirname(SOURCE), "_probe_ssm_update.cu")
    lib_path = os.path.join(OUT, "libssm_update_probe.so")
    with open(src_path, "w") as f:
        f.write(probe_source())
    try:
        proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                               lib_path, src_path], capture_output=True,
                              text=True)
    finally:
        os.remove(src_path)
    if proc.returncode:
        print(proc.stderr, file=sys.stderr)
        return 1
    lib = ctypes.CDLL(lib_path)
    lib.penroz_cuda_error_string.argtypes = [ctypes.c_int]
    lib.penroz_cuda_error_string.restype = ctypes.c_char_p
    real_load = build.load
    build.load = lambda name: lib if name == "ssm_update" else real_load(name)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    from torch.profiler import ProfilerActivity, profile
    buf = (ctypes.c_longlong * (2 * SLOTS))()
    for case in CS.ssm_update_cases():
        state0, q, k, v, gates, descs, starts, counts = CS._ssm_operands(
            torch, case)
        st = CS._ssm_copy(state0)

        def launch():
            if descs is not None:
                return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q,
                                     k, v, gates, descs=descs,
                                     block_q=case["block_q"])
            return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q, k,
                                 v, gates, starts=starts, counts=counts)

        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                launch()
            torch.cuda.synchronize()
        us = [r.device_time for r in prof.key_averages()
              if "ssm_update_kernel" in r.key]
        launch()
        torch.cuda.synchronize()
        if lib.probe_read(buf):
            raise SystemExit("probe_read failed")
        ns = list(buf[SLOTS:])
        t0 = ns[0]
        stages = [s for s in range((SLOTS - 10) // 4)
                  if ns[13 + 4 * s] >= t0 and ns[10 + 4 * s] >= t0
                  and ns[13 + 4 * s] - t0 < 10 ** 8]
        phases = {"copies started": (13, 10, 1), "wait for data": (10, 11, 0),
                  "slots": (11, 12, 0), "reduce y": (12, 13, 0)}
        line = []
        for name, (a, b, shift) in phases.items():
            d = [ns[b + 4 * (s + shift)] - ns[a + 4 * s] for s in stages
                 if b + 4 * (s + shift) < SLOTS
                 and ns[b + 4 * (s + shift)] >= ns[a + 4 * s]]
            line.append(f"{name} {sum(d) / len(d):.0f}" if d else
                        f"{name} -")
        print(f"{case['name']}: kernel {us[0] if us else float('nan'):.2f} "
              f"us (profiler, warm); block (0,0,0): list {ns[1] - t0} ns, "
              f"state tile {ns[2] - t0} ns, {len(stages)} stages, mean ns "
              f"a stage: " + ", ".join(line) + f"; all stages done "
              f"{ns[3] - t0} ns", flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
