#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``penroz_tpu_torch``) on one NVIDIA card.

Phases, each reported on lines of its own; any failure exits non-zero and
prints no result:

1. device    — the card's name and power limit (nvidia-smi) and torch's view.
2. build     — nvcc builds every CUDA kernel of the main paths from the
               sources in this checkout (one nvcc per source, started
               together); prints ptxas's report of each entry function
               (registers, spills, static shared memory).
3. kernels   — each kernel against its plain PyTorch version at the shapes
               the main paths give it, with the stated tolerance; kernel,
               plain and library times (CUDA events, L2 flushed before each
               launch) and the least time the card could take (bound):
               decode attention (serving), flash attention forward and
               backward and cross-entropy forward and backward (training),
               in fp32 and bf16.  Then the bounds of the TPU kernels not
               ported yet, reckoned from their Pallas cost estimates.
4. serving   — the port's HTTP server in a thread on 127.0.0.1 serving GPT-2
               124M width (presets.gpt2(): d 768, 12 heads, 12 layers, vocab
               50304, block 1024; random weights from seed 0): POST /model/,
               greedy /generate/ twice, streamed, past block 1024 (crop +
               T=1024 re-prefill), under TURBO_QUANT_KV_CACHE=1, /decode/,
               DELETE /model/.  Kernel launch counts are reset just before
               and read just after; each generated token must have launched
               the decode kernel once per attention layer.  Then the cached
               (kernel) forward is held against the plain no-cache forward
               (the plain versions patched in) on the card.
5. training  — the same server trains GPT-2 124M (AdamW, bf16 compute, the
               default on the card) through PUT /train/ on a synthetic uint16
               shard: batch 8 x block 1024, step 4 (two micro-steps an
               epoch); a second PUT is a 409; /progress/ is polled until
               Trained.  Counts reset just before and read just after: each
               micro-step must launch the flash forward and backward once per
               attention layer and the cross-entropy forward and backward
               once.  Costs finite, the first near ln 50304, the last below
               it; tokens/s; then greedy /generate/ from the trained model
               twice, identical.  Then one epoch's time by kernel, under
               torch.profiler (the Python API, same shapes).
6. micro-step — one fp32 training micro-step at GPT-2 width (B 1, T 1024):
               loss and every parameter gradient through the kernels against
               the same step with the plain versions patched in.
7. result    — the kernels JSON line, the card line, then the last line
               ``{"ok": true, "device": {...}}``.

Run from the repository root:  python3 chip_smoke.py [--out results.json]
Generated files (kernel builds, checkpoints, the training shard) stay
inside the checkout, under penroz_tpu_torch/_build/ and build/chip_smoke/.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import math
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
# Cross-entropy's operations are elementwise fp32 math whatever the input
# type, so they count at the fp32 rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}

# CUDA sources, one nvcc each: (build name, path in the repo).
SOURCES = [
    ("decode_attention", "penroz_tpu_torch/csrc/decode_attention.cu"),
    ("flash_attention", "penroz_tpu_torch/csrc/flash_attention.cu"),
    ("cross_entropy", "penroz_tpu_torch/csrc/cross_entropy.cu"),
]
# Launch sites of the main paths: (name, source, TPU kernel it replaces,
# phase-3 case that stands for it).
KERNELS = [
    ("decode_attention", "penroz_tpu_torch/csrc/decode_attention.cu",
     "penroz_tpu/ops/pallas/decode_attention.py:155", "gpt2_decode_L1024"),
    ("flash_attention_fwd", "penroz_tpu_torch/csrc/flash_attention.cu",
     "penroz_tpu/ops/pallas/flash_attention.py:200",
     "flash_gpt2_B8_T1024_bf16_fwd"),
    ("flash_attention_bwd", "penroz_tpu_torch/csrc/flash_attention.cu",
     "penroz_tpu/ops/pallas/flash_attention.py:411",
     "flash_gpt2_B8_T1024_bf16_bwd"),
    ("ce_forward", "penroz_tpu_torch/csrc/cross_entropy.cu",
     "penroz_tpu/ops/pallas/cross_entropy.py:100",
     "ce_gpt2_N8192_V50304_bf16_fwd"),
    ("ce_backward", "penroz_tpu_torch/csrc/cross_entropy.cu",
     "penroz_tpu/ops/pallas/cross_entropy.py:147",
     "ce_gpt2_N8192_V50304_bf16_bwd"),
]

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
# Flash attention against its plain version: element by element within
# c * (sum |terms| + |ref|) + dS err + 1e-6, sum |terms| being the element's
# sum taken on absolute values (sum_j w_j |v_j| for the output, sum |dS| |k|
# for dq, sum |dS| |q| for dk, sum |p~| |dO| for dv); c = 2^-7 in bf16 (both
# versions round p, p~ or dS to bf16 once, at different points, and round
# the result once), c = 1e-5 in fp32 (summation order).  dS err (dq, dk):
# the same sums over the bound on each dS's error from dP - delta, which
# cancels where a row's probability sits on one key, so its fp32 error
# (2^-16 of sum |dO||v| + sum |dO||O|) is not relative to dS
# (flash_attention.flash_backward_reference).  lse: atol 1e-4.
FLASH_C = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# Cross-entropy: lse atol 1e-4, label logits exact, the gradient within one
# bf16 rounding step (rtol 2^-7) or rtol 1e-5 in fp32, atol 1e-12.
CE_RTOL = {"bfloat16": 2.0 ** -7, "float32": 1e-5}
# Training: a uint16 shard of 65536 tokens drawn from the first 1024 ids,
# so six epochs of 2 x 8192 tokens revisit it and the cost can fall.
TRAIN_TOKENS = 65536
TRAIN_VOCAB_USED = 1024
TRAIN_EPOCHS = 6
TRAIN_BATCH, TRAIN_BLOCK, TRAIN_STEP = 8, 1024, 4
# Micro-step: loss rtol 1e-5; each gradient max |diff| <= 1e-4 * max |g|
# (fp32, summation order through 12 layers).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4


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
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        paths = dict(zip([k[0] for k in SOURCES],
                         pool.map(build.build, [k[0] for k in SOURCES])))
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


def _row(name, err, err_over_tol, tol_text, ms, plain_ms, library_ms,
         nbytes, ops, peak):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    row = {"name": name, "max_abs_err": err, "err_over_tol": err_over_tol,
           "tolerance": tol_text, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops}
    lib = f"{library_ms:.4f}" if library_ms is not None else "null"
    say("kernels", f"{name}: err {err:.2e} ({err_over_tol:.3f} x "
        f"{tol_text}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms library "
        f"{lib} ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


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
    return _row(case["name"], err, err_over_tol, tol_text, ms, plain_ms,
                library_ms, nbytes, 4 * D * pairs * B * Hq,
                PEAK_OPS_PER_S[case["dtype"]])


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


def run_flash_case(torch, case, flush):
    """Flash forward and backward against the plain versions; two rows."""
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    F = torch.nn.functional
    B, Hq, Hkv, T, D = (case[k] for k in ("B", "Hq", "Hkv", "T", "D"))
    dtype = getattr(torch, case["dtype"])
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q, k, v, dout = (torch.randn(B, h, T, D, device="cuda", generator=g)
                     .to(dtype) for h in (Hq, Hkv, Hkv, Hq))
    kw = {"window": case.get("window"), "scale": case.get("scale"),
          "dropout_rate": case.get("rate", 0.0), "seed": case.get("seed")}
    if case.get("alibi"):
        kw["alibi"] = A.alibi_slopes(Hq)
    fwd_before = FA.flash_forward.launches
    bwd_before = FA.flash_backward.launches
    out, lse = FA.flash_forward(q, k, v, **kw)
    dq, dk, dv = FA.flash_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    check(FA.flash_forward.launches == fwd_before + 1
          and FA.flash_backward.launches == bwd_before + 1,
          f"{case['name']}: launches not counted")
    c = FLASH_C[case["dtype"]]
    tol_text = f"{c:.3g} * (sum|terms| + |ref|) + dS err + 1e-6"

    def worst(got, ref, terms, extra=0.0):
        check(bool(torch.isfinite(got).all()), f"{case['name']}: non-finite")
        diff = (got.float() - ref.float()).abs()
        tol = c * (terms + ref.float().abs()) + extra + 1e-6
        return float(diff.max()), float((diff / tol).max())

    ref, ref_lse = FA.flash_forward_reference(q, k, v, **kw)
    ref_abs, _ = FA.flash_forward_reference(q, k, v.abs(), **kw)
    err_f, ratio_f = worst(out, ref, ref_abs.float())
    lse_err = float((lse - ref_lse).abs().max())
    check(ratio_f <= 1.0 and lse_err <= 1e-4,
          f"{case['name']} forward: {ratio_f:.2f} x tolerance, lse err "
          f"{lse_err:.2e}")
    del ref, ref_abs
    rq, rk, rv, p_drop, ds, ds_err = FA.flash_backward_reference(
        q, k, v, out, lse, dout, terms=True, **kw)
    qg = A._group_query_heads(q, Hkv).float().abs()
    dg = A._group_query_heads(dout, Hkv).float().abs()
    ka = k.float().abs()
    ds = ds.abs_()
    bounds = (  # (sum |terms|, sum of dS's error bound times |operand|)
        (torch.einsum("bhgts,bhsd->bhgtd", ds, ka).reshape(q.shape),
         torch.einsum("bhgts,bhsd->bhgtd", ds_err, ka).reshape(q.shape)),
        (torch.einsum("bhgts,bhgtd->bhsd", ds, qg),
         torch.einsum("bhgts,bhgtd->bhsd", ds_err, qg)),
        (torch.einsum("bhgts,bhgtd->bhsd", p_drop.abs_(), dg), 0.0))
    del p_drop, ds, ds_err
    errs = [worst(a, b, *t) for a, b, t in zip((dq, dk, dv), (rq, rk, rv),
                                                bounds)]
    err_b = max(e for e, _ in errs)
    ratio_b = max(r for _, r in errs)
    check(ratio_b <= 1.0, f"{case['name']} backward: {ratio_b:.2f} x "
          f"tolerance (dq/dk/dv {[round(r, 3) for _, r in errs]})")
    del rq, rk, rv, bounds

    iters = case.get("iters", 10)
    fwd = lambda: FA.flash_forward(q, k, v, **kw)  # noqa: E731
    bwd = lambda: FA.flash_backward(q, k, v, out, lse, dout, **kw)  # noqa
    ms_f = _time_ms(torch, fwd, iters, flush)
    ms_b = _time_ms(torch, bwd, iters, flush)
    plain_f = _time_ms(torch, lambda: FA.flash_forward_reference(
        q, k, v, **kw), 3, flush)
    plain_b = _time_ms(torch, lambda: FA.flash_backward_reference(
        q, k, v, out, lse, dout, **kw), 3, flush)

    # one PyTorch call for the same function, a yardstick only: SDPA
    # (causal, or with the window/ALiBi bias as a mask; its dropout draws
    # its own numbers) and its backward
    pos = torch.arange(T, device="cuda")
    mask = None
    if kw["window"] is not None or case.get("alibi"):
        allowed = pos[None, :] <= pos[:, None]
        if kw["window"] is not None:
            allowed &= pos[None, :] > pos[:, None] - kw["window"]
        bias = torch.zeros(Hq, T, T, device="cuda")
        if case.get("alibi"):
            slopes = torch.as_tensor(kw["alibi"], device="cuda")
            bias = slopes[:, None, None] * (pos[None, :] - pos[:, None]
                                            ).float()
        mask = bias.masked_fill(~allowed, float("-inf")).to(dtype)[None]
    ql, kl, vl = (t.detach().clone().requires_grad_(True) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            ql, kl, vl, attn_mask=mask, is_causal=mask is None,
            dropout_p=kw["dropout_rate"], scale=kw["scale"],
            enable_gqa=Hq != Hkv)

    lib_f = _time_ms(torch, sdpa, iters, flush)
    lib_out = sdpa()
    lib_b = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), iters, flush)
    del lib_out

    item = torch.empty((), dtype=dtype).element_size()
    pairs = B * Hq * _attended_pairs(T, T, kw["window"])[0]
    peak = PEAK_OPS_PER_S[case["dtype"]]
    qn, kn, rows = q.numel(), k.numel(), B * Hq * T
    # forward: read q, k, v; write out and the fp32 lse.  backward: read
    # q, k, v, out, dO and lse; write dq, dk, dv.
    fwd_bytes = (2 * qn + 2 * kn) * item + 4 * rows
    bwd_bytes = (3 * qn + 2 * kn) * item + 4 * rows + (qn + 2 * kn) * item
    return [
        _row(case["name"] + "_fwd", err_f, ratio_f, tol_text, ms_f, plain_f,
             lib_f, fwd_bytes, 4 * D * pairs, peak),
        _row(case["name"] + "_bwd", err_b, ratio_b, tol_text, ms_b, plain_b,
             lib_b, bwd_bytes, 10 * D * pairs, peak)]


def run_ce_case(torch, case, flush):
    """Cross-entropy forward and backward against the plain versions."""
    from penroz_tpu_torch.ops.kernels import cross_entropy as CE
    F = torch.nn.functional
    n, v = case["N"], case["V"]
    dtype = getattr(torch, case["dtype"])
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    x = (torch.randn(n, v, device="cuda", generator=g) * 3).to(dtype)
    t = torch.randint(0, v, (n,), device="cuda", generator=g,
                      dtype=torch.int32)
    scale = torch.tensor(1.0 / n, device="cuda")
    before = (CE.ce_forward.launches, CE.ce_backward.launches)
    lse, ll = CE.ce_forward(x, t)
    grad = CE.ce_backward(x, t, lse, scale)
    torch.cuda.synchronize()
    check((CE.ce_forward.launches, CE.ce_backward.launches)
          == (before[0] + 1, before[1] + 1),
          f"{case['name']}: launches not counted")
    ref_lse, ref_ll = CE.ce_forward_reference(x, t)
    lse_err = float((lse - ref_lse).abs().max())
    ll_err = float((ll - ref_ll).abs().max())
    check(lse_err <= 1e-4 and ll_err == 0.0,
          f"{case['name']} forward: lse err {lse_err:.2e}, label logit "
          f"err {ll_err:.2e}")
    ref = CE.ce_backward_reference(x, t, ref_lse, scale).float()
    check(bool(torch.isfinite(grad).all()), f"{case['name']}: non-finite")
    diff = (grad.float() - ref).abs()
    rtol = CE_RTOL[case["dtype"]]
    err_b = float(diff.max())
    ratio = float((diff / (rtol * ref.abs() + 1e-12)).max())
    check(ratio <= 1.0, f"{case['name']} backward: {ratio:.2f} x rtol "
          f"{rtol:.3g}")
    del ref, diff
    iters = case.get("iters", 20)
    ms_f = _time_ms(torch, lambda: CE.ce_forward(x, t), iters, flush)
    ms_b = _time_ms(torch, lambda: CE.ce_backward(x, t, lse, scale), iters,
                    flush)
    plain_f = _time_ms(torch, lambda: CE.ce_forward_reference(x, t), 3,
                       flush)
    plain_b = _time_ms(torch, lambda: CE.ce_backward_reference(
        x, t, lse, scale), 3, flush)
    xl = x.detach().clone().requires_grad_(True)
    tl = t.long()
    lib_f = _time_ms(torch, lambda: F.cross_entropy(xl, tl), iters, flush)
    loss = F.cross_entropy(xl, tl)
    lib_b = _time_ms(torch, lambda: torch.autograd.grad(
        loss, (xl,), retain_graph=True), iters, flush)
    # forward: read the logits and int32 targets, write fp32 lse and label
    # logit; backward: read logits, targets, lse and the scale, write the
    # gradient; about 4 fp32 operations an element either way
    item = x.element_size()
    ops = 4 * n * v
    peak = PEAK_OPS_PER_S["float32"]
    return [
        _row(case["name"] + "_fwd", max(lse_err, ll_err),
             lse_err / 1e-4, "lse atol 1e-4, label exact", ms_f, plain_f,
             lib_f, n * v * item + 12 * n, ops, peak),
        _row(case["name"] + "_bwd", err_b, ratio,
             f"rtol {rtol:.3g}, atol 1e-12", ms_b, plain_b, lib_b,
             2 * n * v * item + 8 * n + 4, ops, peak)]


def training_cases():
    gpt2 = dict(B=8, Hq=12, Hkv=12, T=1024, D=64)
    cases = [dict(gpt2, name="flash_gpt2_B8_T1024_bf16", dtype="bfloat16"),
             dict(gpt2, name="flash_gpt2_B8_T1024_fp32", dtype="float32"),
             dict(name="flash_gqa32x8_D128_T1024_bf16", B=1, Hq=32, Hkv=8,
                  T=1024, D=128, dtype="bfloat16"),
             dict(name="flash_window128_alibi_T1024_fp32", B=1, Hq=12,
                  Hkv=12, T=1024, D=64, dtype="float32", window=128,
                  alibi=True),
             dict(name="flash_dropout0.1_B2_T1024_bf16", B=2, Hq=12, Hkv=12,
                  T=1024, D=64, dtype="bfloat16", rate=0.1),
             dict(name="flash_D256_T512_bf16", B=1, Hq=8, Hkv=4, T=512,
                  D=256, dtype="bfloat16"),
             dict(name="flash_D256_T512_fp32", B=1, Hq=8, Hkv=4, T=512,
                  D=256, dtype="float32")]
    ce = [dict(name="ce_gpt2_N8192_V50304_bf16", N=8192, V=50304,
               dtype="bfloat16"),
          dict(name="ce_gpt2_N8192_V50304_fp32", N=8192, V=50304,
               dtype="float32"),
          dict(name="ce_tail_N300_V2563_fp32", N=300, V=2563,
               dtype="float32")]
    for i, c in enumerate(cases + ce):
        c["seed"] = 100 + i
    return cases, ce


@contextlib.contextmanager
def plain_kernels():
    """Route the flash and cross-entropy dispatch to the plain versions
    for the duration (this script's comparisons only; the package has no
    such switch)."""
    from penroz_tpu_torch.ops.kernels import cross_entropy as CE
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    saved = (FA.flash_forward, FA.flash_backward, CE.ce_forward,
             CE.ce_backward)
    FA.flash_forward = FA.flash_forward_reference
    FA.flash_backward = FA.flash_backward_reference
    CE.ce_forward = CE.ce_forward_reference
    CE.ce_backward = CE.ce_backward_reference
    try:
        yield
    finally:
        (FA.flash_forward, FA.flash_backward, CE.ce_forward,
         CE.ce_backward) = saved


def phase_kernels(torch):
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = {c["name"]: run_case(torch, c, flush) for c in kernel_cases()}
    flash, ce = training_cases()
    for case in flash:
        for row in run_flash_case(torch, case, flush):
            rows[row["name"]] = row
        torch.cuda.empty_cache()
    for case in ce:
        for row in run_ce_case(torch, case, flush):
            rows[row["name"]] = row
        torch.cuda.empty_cache()
    del flush
    say("kernels", f"ok: {len(rows)} cases within tolerance")
    return rows


def unported_bounds():
    """Least card times of the TPU kernels not ported yet, reckoned from
    each Pallas kernel's own ``pl.CostEstimate`` (flops, bytes_accessed) at
    GPT-2 width (12 heads, D 64, 1024 positions) against the peaks above."""
    H, D, T, B = 12, 64, 1024, 8
    nb, bq, bt = 8, 128, 128
    cases = [  # (kernel, shape, flops, bytes, dtype of its arithmetic)
        ("paged_decode_attention (paged_attention.py:258)",
         "decode of 8 sequences x 1024 cached tokens, bf16",
         4 * B * H * T * D, (B * H * D + 2 * B * T * H * D) * 2, "bfloat16"),
        ("ragged_paged_attention (ragged_paged_attention.py:278)",
         "8 descriptors x 128 packed rows over a 1024-key span, bf16",
         4 * H * nb * bq * T * D,
         2 * H * nb * bq * D * 2 + nb * 2 * H * T * D * 2, "bfloat16"),
        ("gla_chunked (ssm_scan.py:120)",
         "B 8, T 1024, dk = dv = 64, block 128, fp32",
         4 * B * H * T * bt * 2 * D, 4 * B * H * T * D * 4, "float32")]
    out = {}
    for name, shape, ops, nbytes, dtype in cases:
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
        out[name] = {"shape": shape, "ops": ops, "bytes": nbytes,
                     "bytes_ms": t_bytes, "ops_ms": t_ops,
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations"}
        say("bounds", f"{name}, not ported: {shape}: {ops:.3e} operations "
            f"({t_ops:.5f} ms), {nbytes:.3e} bytes ({t_bytes:.5f} ms): "
            f"bound {max(t_bytes, t_ops):.5f} ms "
            f"({out[name]['bound_by']})")
    return out


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
        model = NeuralNetworkModel.deserialize("smoke", device=device,
                                               optimizer=False)
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
        # the plain no-cache forward (plain versions patched in), both on
        # the card
        from penroz_tpu_torch.ops import kv_cache as KV
        x = torch.tensor([prompt], device=device)
        with torch.inference_mode():
            kv = KV.create_kv_state(model.arch.kv_specs, 1, block,
                                    model.dtype, device=device)
            cached, _, _ = model.arch(x, kv=kv, skip_softmax=True)
            with plain_kernels():
                plain, _, _ = model.arch(x, skip_softmax=True)
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
# 5: training over HTTP
# ---------------------------------------------------------------------------

def _training_counters():
    from penroz_tpu_torch.ops.kernels import cross_entropy as CE
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    return {"flash_attention_fwd": FA.flash_forward,
            "flash_attention_bwd": FA.flash_backward,
            "ce_forward": CE.ce_forward, "ce_backward": CE.ce_backward}


def phase_training(torch, layers, optimizer, vocab, card):
    """Train GPT-2 124M over HTTP; returns (stats, launch counts)."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    os.makedirs("data", exist_ok=True)
    tokens = np.random.default_rng(0).integers(
        0, TRAIN_VOCAB_USED, TRAIN_TOKENS).astype(np.uint16)
    np.save(os.path.join("data", "smoke_000000.npy"), tokens)
    num_steps = TRAIN_BATCH // TRAIN_STEP
    micro_steps = TRAIN_EPOCHS * num_steps
    buffer = TRAIN_BATCH * TRAIN_BLOCK
    server = create_app(device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {"epochs": TRAIN_EPOCHS, "micro_steps": micro_steps,
             "tokens_per_micro_step": buffer}
    counters = _training_counters()
    try:
        status, text, secs = _post(base, "/model/", {
            "model_id": "smoke_train", "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        body = {"model_id": "smoke_train", "dataset_id": "smoke", "shard": 0,
                "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH,
                "block_size": TRAIN_BLOCK, "step_size": TRAIN_STEP}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        status, text, _ = _post(base, "/train/", body, method="PUT")
        check(status == 202, f"PUT /train/ -> {status}: {text[:300]}")
        status, text, _ = _post(base, "/train/", body, method="PUT")
        check(status == 409, f"second PUT /train/ -> {status}, not 409")
        say("training", f"PUT /train/ 202, again 409; {TRAIN_EPOCHS} epochs "
            f"x {num_steps} micro-steps of {TRAIN_BATCH} x {TRAIN_BLOCK}")
        progress = None
        while time.monotonic() - t0 < 900:
            status, text, _ = _post(base, "/progress/?model_id=smoke_train",
                                    None, method="GET")
            check(status == 200, f"/progress/ -> {status}: {text[:300]}")
            progress = json.loads(text)
            code = progress["status"]["code"]
            if code == "Error" or (code == "Trained" and len(
                    progress["progress"]) == TRAIN_EPOCHS):
                break
            time.sleep(0.5)
        check(server.join_training(timeout=300), "training thread still "
              "running")
        stats["train_request_s"] = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        check(progress["status"]["code"] == "Trained",
              f"training ended {progress['status']}")
        costs = [p["cost"] for p in progress["progress"]]
        stats["costs"] = costs
        say("training", f"Trained; costs {[round(c, 4) for c in costs]}; "
            f"launches {launches} for {micro_steps} micro-steps x {n_attn} "
            f"attention layers")
        check(all(math.isfinite(c) for c in costs), "non-finite cost")
        check(abs(costs[0] - math.log(vocab)) < 1.0,
              f"first cost {costs[0]:.3f} not near ln {vocab} = "
              f"{math.log(vocab):.3f}")
        check(costs[-1] < costs[0], "the cost did not fall")
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(launches[name] >= n_attn * micro_steps,
                  f"{name} launched {launches[name]} times, expected >= "
                  f"{n_attn * micro_steps}")
        for name in ("ce_forward", "ce_backward"):
            check(launches[name] >= micro_steps,
                  f"{name} launched {launches[name]} times, expected >= "
                  f"{micro_steps}")
        later = progress["progress"][1:]
        stats["speed_per_s"] = [p["speedPerSec"] for p in later]
        stats["epoch_s"] = [p["durationInSecs"] for p in later]
        stats["tokens_per_s"] = (num_steps * buffer * len(later)
                                 / sum(stats["epoch_s"]))
        say("training", f"epochs 2-{TRAIN_EPOCHS}: "
            f"{sum(stats['epoch_s']) / len(later):.4f} s an epoch, "
            f"{stats['tokens_per_s']:.0f} tokens/s trained (speedPerSec, "
            f"which counts one buffer an epoch: "
            f"{sum(stats['speed_per_s']) / len(later):.0f}) on {card}")

        prompt = list(range(1, 33))
        greedy = {"model_id": "smoke_train", "input": [prompt],
                  "block_size": TRAIN_BLOCK, "max_new_tokens": 32,
                  "temperature": 0}
        outs = []
        for _ in range(2):
            status, text, _ = _post(base, "/generate/", greedy)
            check(status == 200, f"/generate/ -> {status}: {text[:300]}")
            outs.append(json.loads(text)["tokens"])
        check(outs[0] == outs[1] and len(outs[0]) == 64
              and all(0 <= t < vocab for t in outs[0]),
              "greedy /generate/ of the trained model not deterministic")
        say("training", "greedy /generate/ of the trained model: identical "
            "twice")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        server.join_training(timeout=60)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


# Kernel-name fragments of the port's training kernels in a profiler trace
# (the FMA and the tensor-core variants of each flash kernel).
TRAIN_KERNEL_KEYS = {"flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
                     "flash_dkv": "flash_dkv_",
                     "ce_forward": "ce_forward_kernel",
                     "ce_backward": "ce_backward_kernel"}


def phase_train_profile(torch, layers, optimizer, vocab):
    """Where a training epoch's time goes: ``CompiledArch.train_epoch`` as
    PUT /train/ runs it above (two bf16 micro-steps of 8 x 1024, fp32
    gradient sums, one AdamW step, the update ratios).  After two warm-up
    epochs: three untraced epochs on the host clock (ending in a
    synchronize), then one under torch.profiler (CPU + CUDA): device time
    by kernel, the port's kernels' and cuBLAS's shares, the device's busy
    share of the traced wall time, and peak device memory."""
    from torch.profiler import ProfilerActivity, profile

    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    model = NeuralNetworkModel("profile", Mapper(layers, optimizer),
                               device="cuda")
    num_steps = TRAIN_BATCH // TRAIN_STEP
    g = torch.Generator(device="cuda").manual_seed(3)
    xs, ys = (torch.randint(0, vocab, (num_steps, TRAIN_BATCH, TRAIN_BLOCK),
                            device="cuda", generator=g) for _ in range(2))

    def epoch():
        cost, ratios = model.arch.train_epoch(
            model.optimizer, xs, ys, compute_dtype=torch.bfloat16,
            generator=g, with_ratios=True)
        float(cost)  # the host reads train_model makes each epoch
        ratios.tolist()
        torch.cuda.synchronize()

    for _ in range(2):
        epoch()
    walls = []
    for _ in range(3):
        t0 = time.monotonic()
        epoch()
        walls.append(time.monotonic() - t0)
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        epoch()
        traced_wall = time.monotonic() - t0
    kernels = {}
    for evt in prof.events():
        # device kernels only: user annotations such as the optimizer's
        # "Optimizer.step#AdamW.step" span kernels and would count twice
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.name):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    device_ms = sum(kernels.values())
    check(device_ms > 0, "the profiler saw no device time")
    ours = {key: sum(ms for name, ms in kernels.items() if frag in name)
            for key, frag in TRAIN_KERNEL_KEYS.items()}
    gemm_ms = sum(ms for name, ms in kernels.items()
                  if any(f in name.lower() for f in ("gemm", "cutlass",
                                                     "xmma", "nvjet")))
    tokens = num_steps * TRAIN_BATCH * TRAIN_BLOCK
    stats = {
        "epoch_wall_s": sorted(walls),
        "tokens_per_s_median": tokens / sorted(walls)[1],
        "traced_wall_s": traced_wall, "device_busy_ms": device_ms,
        "device_busy_share": device_ms / (traced_wall * 1e3),
        "kernel_ms": ours, "port_kernels_ms": sum(ours.values()),
        "port_kernels_share": sum(ours.values()) / device_ms,
        "gemm_ms": gemm_ms, "gemm_share": gemm_ms / device_ms,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "top_kernels_ms": [(n[:90], ms) for n, ms in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:12]]}
    say("profile", f"epoch (2 x 8192 tokens) {sorted(walls)[1]:.4f} s "
        f"median = {stats['tokens_per_s_median']:.0f} tokens/s; traced: "
        f"device busy {device_ms:.2f} ms of {traced_wall * 1e3:.2f} ms "
        f"({stats['device_busy_share']:.1%}); port kernels "
        f"{stats['port_kernels_ms']:.2f} ms "
        f"({stats['port_kernels_share']:.1%}: "
        + ", ".join(f"{k} {v:.2f}" for k, v in ours.items())
        + f"), cuBLAS {gemm_ms:.2f} ms ({stats['gemm_share']:.1%}); peak "
        f"{stats['peak_memory_gb']:.1f} GB")
    del model, xs, ys
    torch.cuda.empty_cache()
    return stats


# ---------------------------------------------------------------------------
# 6: one micro-step, kernels against plain
# ---------------------------------------------------------------------------

def phase_micro_step(torch, layers, optimizer, vocab):
    """fp32 loss and gradients of one micro-step at GPT-2 width (B 1,
    T 1024) through the kernels, against the same step with the plain
    versions patched in."""
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    model = NeuralNetworkModel("step", Mapper(layers, optimizer),
                               device="cuda")
    g = torch.Generator().manual_seed(2)
    x = torch.randint(0, vocab, (1, TRAIN_BLOCK), generator=g).cuda()
    y = torch.randint(0, vocab, (1, TRAIN_BLOCK), generator=g).cuda()
    params = [p for _, p in model.arch.named_parameters()]

    def step():
        _, cost, _ = model.arch(x, y, skip_softmax=True, training=True,
                                generator=torch.Generator(device="cuda"))
        return cost.detach(), torch.autograd.grad(cost, params)

    cost, grads = step()
    with plain_kernels():
        ref_cost, ref_grads = step()
    torch.cuda.synchronize()
    loss_err = abs(float(cost) - float(ref_cost))
    worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                for a, b in zip(grads, ref_grads))
    say("micro_step", f"fp32 B1 T{TRAIN_BLOCK}: loss {float(cost):.6f} vs "
        f"plain {float(ref_cost):.6f} (|diff| {loss_err:.2e}, rtol "
        f"{STEP_LOSS_RTOL}); worst gradient max|diff|/max|g| {worst:.2e} "
        f"(<= {STEP_GRAD_RTOL}) over {len(params)} parameters")
    check(loss_err <= STEP_LOSS_RTOL * abs(float(ref_cost)),
          f"micro-step loss differs by {loss_err:.3e}")
    check(worst <= STEP_GRAD_RTOL, f"micro-step gradients differ: {worst:.3e}"
          f" x max |g|")
    return {"loss": float(cost), "plain_loss": float(ref_cost),
            "loss_abs_err": loss_err, "grad_worst_rel_err": worst}


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
        bounds = unported_bounds()
        from penroz_tpu_torch.models import presets
        stats, launches = phase_main_path(
            torch, "cuda", presets.gpt2(), presets.ADAMW, block=1024,
            vocab=50304, card=card)
        train_stats, train_launches = phase_training(
            torch, presets.gpt2(), presets.ADAMW, vocab=50304, card=card)
        launches.update(train_launches)
        train_stats["profile"] = phase_train_profile(
            torch, presets.gpt2(), presets.ADAMW, vocab=50304)
        step_stats = phase_micro_step(torch, presets.gpt2(), presets.ADAMW,
                                      vocab=50304)
    except SmokeFailure as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    line = {"kernels": [{
        "name": name_, "route": "cuda", "source": source,
        "replaces": replaces, "launches": launches[name_],
        "max_abs_err": rows[case]["max_abs_err"], "ms": rows[case]["ms"],
        "plain_ms": rows[case]["plain_ms"],
        "bound_ms": rows[case]["bound_ms"],
        "bound_by": rows[case]["bound_by"],
        "library_ms": rows[case]["library_ms"]}
        for name_, source, replaces, case in KERNELS]}
    if args.out:
        out = os.path.join(ROOT, args.out)
        os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
        with open(out, "w") as f:
            json.dump({"card": card, "cases": rows,
                       "unported_bounds": bounds, "main_path": stats,
                       "training": train_stats, "micro_step": step_stats,
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
