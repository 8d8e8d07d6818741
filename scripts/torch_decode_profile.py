#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch port, on one NVIDIA card.

Builds GPT-2 124M width (presets.gpt2(), random weights from seed 0) with
``penroz_tpu_torch`` on ``cuda``, warms up, then times greedy
``generate_tokens`` (128-token prompt, 128 new tokens) three ways:

- wall time of the whole call (host clock, ends in a synchronize);
- under ``torch.profiler`` (CPU + CUDA activities): device time by kernel
  name, the decode-attention kernel's share, and the device's busy share of
  the wall time (sum of kernel times / wall; kernels of one stream do not
  overlap);
- the mean kernel launches per generated token.

Prints one JSON object.  Run from the repository root on a machine with the
card:  python3 scripts/torch_decode_profile.py [--dtype bfloat16]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROMPT_LEN = 128
NEW_TOKENS = 128


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        default="float32")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from penroz_tpu_torch.models import presets
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import decode_attention as DA

    torch.backends.cuda.matmul.allow_tf32 = False
    model = NeuralNetworkModel("profile", Mapper(presets.gpt2(),
                                                 presets.ADAMW),
                               device="cuda")
    model.arch.to(getattr(torch, args.dtype))
    prompt = torch.randint(0, 50304, (PROMPT_LEN,),
                           generator=torch.Generator().manual_seed(1)
                           ).tolist()

    def run():
        out = model.generate_tokens([prompt], 1024, NEW_TOKENS,
                                     temperature=0)
        torch.cuda.synchronize()
        return out

    run()  # warm-up: kernel build, allocator, cuBLAS handles
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        run()
        walls.append(time.monotonic() - t0)
    launches0 = DA.decode_attention.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run()
        traced_wall = time.monotonic() - t0
    attn_launches = DA.decode_attention.launches - launches0
    kernels = {}
    n_kernels = 0
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels[evt.name] = kernels.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
            n_kernels += 1
    device_ms = sum(kernels.values())
    # the decode-attention launches: split decode tiles and prefill tiles
    # (csrc/decode_core.cuh)
    attn_ms = sum(v for k, v in kernels.items() if "decode_core::" in k)
    top = [(name[:100], ms) for name, ms in
           sorted(kernels.items(), key=lambda kv: -kv[1])[:8]]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "dtype": args.dtype, "prompt_tokens": len(prompt),
        "new_tokens": NEW_TOKENS,
        "wall_s": sorted(walls),
        "tokens_per_s_median": NEW_TOKENS / sorted(walls)[1],
        "traced_wall_s": traced_wall,
        "device_busy_ms": device_ms,
        "device_busy_share": device_ms / (traced_wall * 1e3),
        "decode_attention_ms": attn_ms,
        "decode_attention_share_of_device": attn_ms / device_ms
        if device_ms else None,
        "decode_attention_launches": attn_launches,
        "device_kernels_per_token": n_kernels / NEW_TOKENS,
        "top_kernels_ms": top,
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
