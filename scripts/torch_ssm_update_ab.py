#!/usr/bin/env python3
"""Time chip_smoke.py's phase-3 recurrent-update rows for one source tree,
on one NVIDIA card.

The case list is always this checkout's (``chip_smoke.ssm_update_cases()``);
the kernel and the timing are those of the tree at ROOT (default: this
checkout), through its own ``chip_smoke.run_ssm_update_case``, which builds
its kernel from its sources and holds it to its plain version.  Two trees,
this one and another commit unpacked under ``build/`` (``git archive
<commit> | tar -x -C build/parent``), are compared on one card by running
this script on each in turns (A, B, B, A), each in its own process.  Prints
the build's ptxas report (registers, spills, shared memory), the card's
name and power limit, and one line a case: the phase-3 row (CUDA events
around the wrapper's call, L2 flushed first, so the y buffer's zeroing and
the launch gaps count) and the kernel's own device time (torch.profiler,
warm, no flush); ``--out`` also writes the rows as JSON lines.

Run from the repository root on a machine with the card:
  python3 scripts/torch_ssm_update_ab.py [ROOT] [--label L] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _fresh_import(root: str):
    """chip_smoke and penroz_tpu_torch of ``root``, imported anew."""
    for name in list(sys.modules):
        if name == "chip_smoke" or name.split(".")[0] == "penroz_tpu_torch":
            del sys.modules[name]
    sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


def _kernel_us(torch, smoke, case) -> float:
    """Mean device microseconds of the kernel alone over 20 warm launches
    (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    state0, q, k, v, gates, descs, starts, counts = smoke._ssm_operands(
        torch, case)
    st = smoke._ssm_copy(state0)

    def launch():
        if descs is not None:
            return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q, k,
                                 v, gates, descs=descs,
                                 block_q=case["block_q"])
        return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q, k, v,
                             gates, starts=starts, counts=counts)

    for _ in range(3):
        launch()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            launch()
        torch.cuda.synchronize()
    times = [r.device_time for r in prof.key_averages()
             if "ssm_update_kernel" in r.key]
    return times[0] if times else float("nan")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    cases = _fresh_import(HERE).ssm_update_cases()
    sys.path.remove(HERE)
    smoke = _fresh_import(root)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.chdir(root)
    from penroz_tpu_torch.ops.kernels import build
    build.build("ssm_update")
    for line in build.BUILD_LOGS.get("ssm_update", "").splitlines():
        if ("Compiling entry function" in line or "registers" in line
                or "spill" in line):
            print(f"{args.label} ptxas: {line.strip()}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"{args.label} card: {card.strip()}", flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = open(out_path, "a") if out_path else None
    try:
        for case in cases:
            row = dict(smoke.run_ssm_update_case(torch, dict(case,
                                                             flush=flush)),
                       label=args.label, root=root, card=card.strip(),
                       kernel_us=_kernel_us(torch, smoke, case))
            print(f"{args.label} {row['name']} ms {row['ms']:.4f} kernel "
                  f"{row['kernel_us']:.2f} us plain {row['plain_ms']:.4f} "
                  f"bound {row['bound_ms']:.5f} err/tol "
                  f"{row['err_over_tol']:.3f} state_err "
                  f"{row['state_err']:.3e}", flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
