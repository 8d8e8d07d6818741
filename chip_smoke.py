#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``penroz_tpu_torch``) on one NVIDIA card.

Phases, each reported on lines of its own; any failure exits non-zero and
prints no result:

1. device    — the card's name and power limit (nvidia-smi) and torch's view.
2. build     — nvcc builds every CUDA kernel of the main path from the
               sources in this checkout (one nvcc per source, started
               together); prints ptxas's report of each entry function
               (registers, spills, static shared memory).
3. kernels   — each kernel against its plain PyTorch version at the shapes
               the main path gives it, with the stated tolerance; kernel,
               plain and library times (CUDA events, L2 flushed before each
               launch) and the least time the card could take (bound).
4. main path — the port's HTTP server in a thread on 127.0.0.1 serving GPT-2
               124M width (presets.gpt2(): d 768, 12 heads, 12 layers, vocab
               50304, block 1024; random weights from seed 0): POST /model/,
               greedy /generate/ twice, streamed, past block 1024 (crop +
               T=1024 re-prefill), under TURBO_QUANT_KV_CACHE=1, /decode/,
               DELETE /model/.  Kernel launch counts are reset just before
               and read just after; each generated token must have launched
               the kernel once per attention layer.  Then the cached (kernel)
               forward is held against the plain no-cache forward on the
               card.
5. result    — the kernels JSON line, the card line, then the last line
               ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py [--out results.json]
Generated files (kernel builds, checkpoints) stay inside the checkout, under
penroz_tpu_torch/_build/ and build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import shutil
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s; dense
# operations/s by input type (fp32 outside the tensor cores, bf16 tensor).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# Kernels of the main path: (name, C source, TPU kernel it replaces).
KERNELS = [("decode_attention", "penroz_tpu_torch/csrc/decode_attention.cu",
            "penroz_tpu/ops/pallas/decode_attention.py:155")]

# Tolerances against the plain version (same inputs, same dtype).  fp32 and
# int8 caches: atol 1e-4.  bf16: each version rounds every probability to
# bf16 once (relative error <= 2^-8), the kernel before normalising and the
# plain version after, and each rounds its output once, so element by
# element |out - ref| <= 2^-7 * (sum_j w_j |v_j| + |ref|), where
# sum_j w_j |v_j| is the plain version run on |v|.
FP32_ATOL = 1e-4
BF16_STEP = 2.0 ** -7
# Main-path requests: a 128-token prompt and 128 new tokens; the overflow
# request starts 20 tokens short of the block and asks for 40.
PROMPT_LEN = 128
NEW_TOKENS = 128
OVERFLOW_NEW = 40


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


# ---------------------------------------------------------------------------
# 1-2: device and build
# ---------------------------------------------------------------------------

def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say("device", f"{card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {name} x{torch.cuda.device_count()}")
    return card, name


def phase_build():
    from penroz_tpu_torch.ops.kernels import build
    t0 = time.monotonic()
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip([k[0] for k in KERNELS],
                         pool.map(build.build, [k[0] for k in KERNELS])))
    for name, path in paths.items():
        say("build", f"{name}: {os.path.relpath(path, ROOT)} in "
            f"{time.monotonic() - t0:.1f} s")
        for line in build.BUILD_LOGS.get(name, "").splitlines():
            if ("Compiling entry function" in line or "registers" in line
                    or "spill" in line):
                say("build", f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _attended_pairs(T, L, window):
    """(query, key) pairs the mask admits, and the first key any row reads."""
    pairs = 0
    first_key = L
    for t in range(T):
        pos = L - T + t
        lo = max(0, pos - window + 1) if window else 0
        pairs += pos - lo + 1
        first_key = min(first_key, lo)
    return pairs, first_key


def _time_ms(torch, fn, iters, flush):
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush, timed with CUDA events around the launch alone.  A spin kernel
    queued first keeps the device busy while the host enqueues the flush,
    the events and ``fn``, so host-side launch overhead is not timed."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(5_000_000)  # ~3 ms of device time
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def run_case(torch, case, flush):
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    F = torch.nn.functional
    B, Hq, Hkv, T, S, D, L = (case[k] for k in
                              ("B", "Hq", "Hkv", "T", "S", "D", "L"))
    dtype = getattr(torch, case["dtype"])
    window = case.get("window")
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q = torch.randn(B, Hq, T, D, device="cuda", generator=g).to(dtype)
    k = torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, Hkv, S, D, device="cuda", generator=g).to(dtype)
    kw = {"window": window, "softcap": case.get("softcap")}
    if case.get("alibi"):
        kw["alibi"] = A.alibi_slopes(Hq)
    scale_bytes = 0
    if case.get("int8"):
        state = KV.QuantKVState.create([(Hkv, D)], B, S, dtype, device="cuda")
        k, v, _ = state.append_raw(0, k, v)
        kw.update(k_scale=state.k_scale[0], v_scale=state.v_scale[0])
        scale_bytes = 4
    kernel = lambda: DA.decode_attention(q, k, v, L - T, L, **kw)  # noqa: E731
    plain = lambda: DA.decode_attention_reference(q, k, v, L - T, L,  # noqa
                                                  **kw)
    before = DA.decode_attention.launches
    out = kernel()
    torch.cuda.synchronize()
    check(DA.decode_attention.launches == before + 1,
          f"{case['name']}: launch not counted")
    ref = plain().float()
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    if case["dtype"] == "bfloat16":
        ref_abs = DA.decode_attention_reference(q, k, v.abs(), L - T, L,
                                                **kw).float()
        tol = BF16_STEP * (ref_abs + ref.abs())
        tol_text = "2^-7 * (sum w|v| + |ref|)"
    else:
        tol = torch.full_like(ref, FP32_ATOL)
        tol_text = f"atol {FP32_ATOL}"
    err_over_tol = float((diff / tol).max())
    check(bool(torch.isfinite(out).all()), f"{case['name']}: non-finite")
    check(err_over_tol <= 1.0, f"{case['name']}: max abs err {err:.3e}, "
          f"{err_over_tol:.2f} x the tolerance {tol_text}")
    iters = case.get("iters", 20)
    ms = _time_ms(torch, kernel, iters, flush)
    plain_ms = _time_ms(torch, plain, max(3, iters // 4), flush)

    library_ms = None
    if not case.get("softcap"):
        # one PyTorch call on the (dequantized) valid prefix — a yardstick
        # only; the port never calls it
        if case.get("int8"):
            kd = (k[:, :, :L].float() * kw["k_scale"][:, :, :L]).to(dtype)
            vd = (v[:, :, :L].float() * kw["v_scale"][:, :, :L]).to(dtype)
        else:
            kd, vd = k[:, :, :L], v[:, :, :L]
        pos = torch.arange(L - T, L, device="cuda")[:, None]
        key = torch.arange(L, device="cuda")[None, :]
        mask = key <= pos
        if window:
            mask &= key > pos - window
        bias = None
        if case.get("alibi"):
            slopes = torch.as_tensor(kw["alibi"], device="cuda")
            bias = slopes[:, None, None] * (key - pos).float()
            bias = bias.masked_fill(~mask, float("-inf")).to(dtype)[None]
        attn_mask = bias if bias is not None else (
            None if T == 1 and not window else mask)
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kd, vd, attn_mask=attn_mask, enable_gqa=Hq != Hkv)
        library_ms = _time_ms(torch, sdpa, iters, flush)

    pairs, first_key = _attended_pairs(T, L, window)
    itemsize = torch.empty((), dtype=dtype).element_size()
    kv_item = 1 if case.get("int8") else itemsize
    nbytes = (2 * q.numel() * itemsize
              + 2 * B * Hkv * (L - first_key) * (D * kv_item + scale_bytes))
    ops = 4 * D * pairs * B * Hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[case["dtype"]] * 1e3
    row = {"name": case["name"], "max_abs_err": err,
           "err_over_tol": err_over_tol, "tolerance": tol_text, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops}
    lib = f"{library_ms:.4f}" if library_ms is not None else "null"
    say("kernels", f"{case['name']}: err {err:.2e} ({err_over_tol:.2f} x "
        f"{tol_text}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{lib} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def kernel_cases():
    gpt2 = dict(B=1, Hq=12, Hkv=12, S=1024, D=64)
    gqa = dict(B=1, Hq=32, Hkv=8, S=1024, D=128)
    cases = []
    for dtype, tag in (("float32", ""), ("bfloat16", "_bf16")):
        cases += [
            dict(gpt2, name=f"gpt2_decode_L128{tag}", T=1, L=128),
            dict(gpt2, name=f"gpt2_decode_L1024{tag}", T=1, L=1024),
            dict(gpt2, name=f"gpt2_prefill_T128{tag}", T=128, L=128),
            dict(gpt2, name=f"gpt2_prefill_T1024{tag}", T=1024, L=1024,
                 iters=5)]
        for c in cases[-4:]:
            c["dtype"] = dtype
    cases += [
        dict(gpt2, name="gpt2_decode_L1024_int8", T=1, L=1024,
             dtype="float32", int8=True),
        dict(gpt2, name="gpt2_prefill_T1024_int8", T=1024, L=1024,
             dtype="float32", int8=True, iters=5),
        dict(gqa, name="gqa_decode_L1024", T=1, L=1024, dtype="float32"),
        dict(gqa, name="gqa_chunk_T16_L512_bf16", T=16, L=512,
             dtype="bfloat16"),
        dict(gpt2, name="gpt2_decode_window128", T=1, L=1024,
             dtype="float32", window=128),
        dict(gpt2, name="gpt2_decode_alibi", T=1, L=1024, dtype="float32",
             alibi=True),
        dict(gpt2, name="gpt2_decode_softcap30", T=1, L=1024,
             dtype="float32", softcap=30.0),
        dict(gpt2, name="gpt2_prefill_T256_window_alibi_softcap", T=256,
             L=300, dtype="float32", window=64, alibi=True, softcap=20.0,
             iters=10),
    ]
    for i, c in enumerate(cases):
        c["seed"] = i
    return cases


def phase_kernels(torch):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = {c["name"]: run_case(torch, c, flush) for c in kernel_cases()}
    del flush
    say("kernels", f"ok: {len(rows)} cases within tolerance")
    return rows


# ---------------------------------------------------------------------------
# 4: the main path over HTTP
# ---------------------------------------------------------------------------

def _post(base, path, body, method="POST", timeout=900):
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode() if body is not None
        else None, method=method, headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read().decode(), time.monotonic() - t0
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(), time.monotonic() - t0


def _stream(base, body, timeout=900):
    """(tokens, seconds to the first token line, total seconds)."""
    req = urllib.request.Request(
        base + "/generate/", data=json.dumps(dict(body, stream=True)).encode(),
        method="POST", headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    first = None
    tokens = []
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        check(resp.status == 200, f"stream status {resp.status}")
        for line in resp:
            if first is None:
                first = time.monotonic() - t0
            tokens.append(int(line))
    return tokens, first, time.monotonic() - t0


def phase_main_path(torch, device, layers, optimizer, block, vocab, card):
    """Drive the port's server; returns (stats dict, launch counts)."""
    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    try:
        rng = torch.Generator().manual_seed(1)
        prompt = torch.randint(0, vocab, (PROMPT_LEN,), generator=rng).tolist()
        long_prompt = torch.randint(0, vocab, (block - OVERFLOW_NEW // 2,),
                                    generator=rng).tolist()
        status, text, secs = _post(base, "/model/", {
            "model_id": "smoke", "layers": layers, "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        say("main_path", f"POST /model/ 200 in {secs:.2f} s")

        greedy = {"model_id": "smoke", "input": [prompt], "block_size": block,
                  "max_new_tokens": NEW_TOKENS, "temperature": 0}
        DA.decode_attention.launches = 0
        generated = 0
        status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200, f"/generate/ -> {status}: {text[:300]}")
        first = json.loads(text)["tokens"]
        generated += len(first) - PROMPT_LEN
        check(len(first) == PROMPT_LEN + NEW_TOKENS
              and first[:PROMPT_LEN] == prompt
              and all(0 <= t < vocab for t in first),
              "greedy output malformed")
        stats["greedy_request_s"] = secs
        status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200 and json.loads(text)["tokens"] == first,
              "greedy /generate/ not deterministic")
        generated += NEW_TOKENS
        stats["greedy_request_s_2"] = secs
        say("main_path", f"greedy {PROMPT_LEN}+{NEW_TOKENS}: identical twice, "
            f"{stats['greedy_request_s']:.3f} s / {secs:.3f} s per request "
            f"(checkpoint load included) on {card}")

        streamed, ttft, secs = _stream(base, greedy)
        check(streamed == first[PROMPT_LEN:], "stream != non-stream")
        generated += len(streamed)
        stats.update(stream_first_token_s=ttft, stream_request_s=secs)
        say("main_path", f"stream == non-stream; first token {ttft:.3f} s, "
            f"all {secs:.3f} s")

        over = dict(greedy, input=[long_prompt], max_new_tokens=OVERFLOW_NEW)
        status, text, secs = _post(base, "/generate/", over)
        tokens = json.loads(text)["tokens"] if status == 200 else []
        check(status == 200 and len(tokens) == len(long_prompt) + OVERFLOW_NEW,
              f"overflow /generate/ -> {status}: {text[:300]}")
        generated += OVERFLOW_NEW
        stats["overflow_request_s"] = secs
        say("main_path", f"overflow {len(long_prompt)}+{OVERFLOW_NEW} past "
            f"block {block}: crop + re-prefill ok in {secs:.3f} s")

        os.environ["TURBO_QUANT_KV_CACHE"] = "1"
        try:
            status, text, secs = _post(base, "/generate/", greedy)
        finally:
            del os.environ["TURBO_QUANT_KV_CACHE"]
        check(status == 200, f"int8 /generate/ -> {status}: {text[:300]}")
        int8 = json.loads(text)["tokens"]
        check(len(int8) == len(first) and all(0 <= t < vocab for t in int8),
              "int8 output malformed")
        generated += NEW_TOKENS
        agree = sum(a == b for a, b in zip(int8[PROMPT_LEN:],
                                           first[PROMPT_LEN:]))
        stats["int8_request_s"] = secs
        say("main_path", f"TURBO_QUANT_KV_CACHE=1: ok in {secs:.3f} s, "
            f"{agree}/{NEW_TOKENS} tokens equal to the fp32 cache's")

        # decode-only rate: the same request through the Python API, with
        # the checkpoint already loaded
        t0 = time.monotonic()
        model = NeuralNetworkModel.deserialize("smoke", device=device)
        torch.cuda.synchronize()
        stats["checkpoint_load_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        direct = model.generate_tokens([prompt], block, NEW_TOKENS,
                                       temperature=0)
        torch.cuda.synchronize()
        stats["generate_s"] = time.monotonic() - t0
        check(direct == first, "direct generate != HTTP generate")
        generated += NEW_TOKENS
        stats["tokens_per_s"] = NEW_TOKENS / stats["generate_s"]
        say("main_path", f"generate_tokens {PROMPT_LEN}+{NEW_TOKENS}: "
            f"{stats['generate_s']:.3f} s = {stats['tokens_per_s']:.1f} "
            f"tokens/s (checkpoint load {stats['checkpoint_load_s']:.2f} s "
            f"apart) on {card}")

        status, text, _ = _post(base, "/decode/", {"encoding": "byte",
                                                  "tokens": first})
        check(status == 200 and "text" in json.loads(text), "/decode/ failed")
        status, _, _ = _post(base, "/model/?model_id=smoke", None,
                             method="DELETE")
        check(status == 204, f"DELETE /model/ -> {status}")
        status, _, _ = _post(base, "/generate/", greedy)
        check(status == 404, f"/generate/ after DELETE -> {status}")
        launches = {"decode_attention": DA.decode_attention.launches}
        stats["generated_tokens"] = generated
        say("main_path", f"/decode/ 200, DELETE 204, then 404; kernel "
            f"launches {launches} for {generated} generated tokens x "
            f"{n_attn} attention layers")
        check(launches["decode_attention"] >= n_attn * generated,
              f"decode_attention launched {launches['decode_attention']} "
              f"times, expected >= {n_attn * generated}")

        # reference on the loaded weights: the cached (kernel) forward vs
        # the plain no-cache forward, both on the card
        from penroz_tpu_torch.ops import kv_cache as KV
        x = torch.tensor([prompt], device=device)
        with torch.inference_mode():
            kv = KV.create_kv_state(model.arch.kv_specs, 1, block,
                                    model.dtype, device=device)
            cached, _ = model.arch(x, kv=kv, skip_softmax=True)
            plain, _ = model.arch(x, skip_softmax=True)
        err = float((cached[-1] - plain[-1]).abs().max())
        stats["logits_max_abs_err"] = err
        check(err < 1e-3, f"cached vs plain logits differ by {err:.3e}")
        say("main_path", f"cached (kernel) vs plain forward logits: max abs "
            f"err {err:.2e} (atol 1e-3)")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="penroz_tpu_torch chip smoke")
    parser.add_argument("--out", help="also write every measurement here "
                        "(JSON)")
    args = parser.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "penroz_tpu_torch")):
        print("FAIL: penroz_tpu_torch/ is not beside chip_smoke.py; run from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: no card",
              file=sys.stderr)
        return 2
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(os.path.join(WORK, "shm"))
    os.environ["PENROZ_SHM_PATH"] = os.path.join(WORK, "shm")
    sys.path.insert(0, ROOT)
    os.chdir(WORK)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.monotonic()
    try:
        card, name = phase_device(torch)
        phase_build()
        rows = phase_kernels(torch)
        from penroz_tpu_torch.models import presets
        stats, launches = phase_main_path(
            torch, "cuda", presets.gpt2(), presets.ADAMW, block=1024,
            vocab=50304, card=card)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    main_row = rows["gpt2_decode_L1024"]
    line = {"kernels": [{
        "name": name_, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name_],
        "max_abs_err": main_row["max_abs_err"], "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"], "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}
        for name_, source, replaces in KERNELS]}
    if args.out:
        out = os.path.join(ROOT, args.out)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "cases": rows, "main_path": stats,
                       "launches": launches,
                       "seconds": time.monotonic() - t_start}, f, indent=1)
    say("done", f"{time.monotonic() - t_start:.1f} s")
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
