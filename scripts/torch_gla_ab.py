#!/usr/bin/env python3
"""Time chip_smoke.py's phase-3 chunked-GLA rows for one source tree, on one
NVIDIA card.

The case list is always this checkout's (``chip_smoke.gla_cases()``); the
kernel and the timing are those of the tree at ROOT (default: this
checkout), through its own ``chip_smoke.run_gla_case``, which builds its
kernel from its sources and holds it to its plain version.  Two trees, this
one and another commit unpacked under ``build/`` (``git archive <commit> |
tar -x -C build/parent``), are compared on one card by running this script
on each in turns (A, B, B, A), each in its own process.  Prints one line a
case; ``--out`` also writes the rows as JSON lines.

Run from the repository root on a machine with the card:
  python3 scripts/torch_gla_ab.py [ROOT] [--label L] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("root", nargs="?", default=HERE)
    parser.add_argument("--label", default="")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    root = os.path.abspath(args.root)
    out_path = os.path.abspath(args.out) if args.out else None
    cases = _fresh_import(HERE).gla_cases()
    sys.path.remove(HERE)
    smoke = _fresh_import(root)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    os.chdir(root)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = open(out_path, "a") if out_path else None
    try:
        for case in cases:
            row = dict(smoke.run_gla_case(torch, case, flush),
                       label=args.label, root=root,
                       card=torch.cuda.get_device_name(0))
            print(f"{args.label} {row['name']} ms {row['ms']:.4f} plain "
                  f"{row['plain_ms']:.4f} bound {row['bound_ms']:.4f}",
                  flush=True)
            if out:
                out.write(json.dumps(row) + "\n")
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
