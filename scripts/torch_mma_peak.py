#!/usr/bin/env python3
"""The tensor-core rate of ``mma.sync`` on one NVIDIA card: TF32 m16n8k8
and bf16 m16n8k16, fp32 accumulators, at several warps an SM.

Builds a small CUDA library under build/mma_peak/ (``build.NVCC_FLAGS``):
each warp issues ``iters`` rounds of eight independent ``mma.sync`` on
register operands (no memory traffic), on 132 x ``blocks_per_sm`` blocks.
Prints TFLOP/s (2 x M x N x K a product) from CUDA events around one
launch, after a warm-up launch.  This is the ceiling of the chunked-GLA
kernel's products (csrc/ssm_scan.cu, mma.sync m16n8k8 TF32 in 3xTF32).

Run from the repository root on a machine with the card:
  python3 scripts/torch_mma_peak.py [--iters N]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "mma_peak")

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

template <bool BF16>
__global__ void mma_loop(float* out, int iters) {
  float acc[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i)
    a[i] = __float_as_uint(threadIdx.x * 1e-3f + i) & 0xffffe000u;
  for (int i = 0; i < 2; ++i)
    b[i] = __float_as_uint(threadIdx.x * 2e-3f + i) & 0xffffe000u;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]),
              "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
              "r"(b[1]));
    }
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j)
    for (int i = 0; i < 4; ++i) s += acc[j][i];
  if (s == 1234.5f) out[0] = s;  // keep the products
}

// milliseconds of one launch (after a warm-up), or -1 on a CUDA error
extern "C" float mma_ms(int bf16, int blocks, int threads, int iters) {
  float* out;
  if (cudaMalloc(&out, 4) != cudaSuccess) return -1.f;
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  float ms = -1.f;
  for (int rep = 0; rep < 2; ++rep) {
    cudaEventRecord(e0);
    if (bf16)
      mma_loop<true><<<blocks, threads>>>(out, iters);
    else
      mma_loop<false><<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    if (cudaEventSynchronize(e1) != cudaSuccess) return -1.f;
    cudaEventElapsedTime(&ms, e0, e1);
  }
  cudaFree(out);
  return cudaGetLastError() == cudaSuccess ? ms : -1.f;
}
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=4096)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    from penroz_tpu_torch.ops.kernels import build
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "mma_peak.cu")
    with open(cu, "w") as f:
        f.write(SOURCE)
    lib_path = os.path.join(OUT, "libmma_peak.so")
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           lib_path, cu], capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"FAIL: nvcc:\n{proc.stderr}", file=sys.stderr)
        return 1
    lib = ctypes.CDLL(lib_path)
    lib.mma_ms.restype = ctypes.c_float
    lib.mma_ms.argtypes = [ctypes.c_int] * 4
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card {torch.cuda.get_device_name(0)}, {sms} SMs")
    for bf16, name, k in ((0, "tf32 m16n8k8", 8), (1, "bf16 m16n8k16", 16)):
        for warps_per_sm in (4, 8, 16, 32):
            threads = min(warps_per_sm, 8) * 32
            blocks = sms * warps_per_sm * 32 // threads
            ms = lib.mma_ms(bf16, blocks, threads, args.iters)
            if ms <= 0:
                print(f"FAIL: {name} launch failed", file=sys.stderr)
                return 1
            flop = 2.0 * 16 * 8 * k * 8 * args.iters * blocks * threads / 32
            print(f"{name}: {warps_per_sm:2d} warps an SM: {ms:.3f} ms, "
                  f"{flop / ms / 1e9:.1f} TFLOP/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
