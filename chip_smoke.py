#!/usr/bin/env python3
"""Chip smoke for the PyTorch port (``penroz_tpu_torch``) on one NVIDIA card.

Phases, each reported on lines of its own; any failure exits non-zero and
prints no result:

1. device    — the card's name and power limit (nvidia-smi) and torch's view.
2. build     — nvcc builds every CUDA kernel of the main paths from the
               sources in this checkout (one nvcc per source, started
               together, in the background: phase 3 runs each source's
               cases once it is built, the slowest source's last); prints
               ptxas's report of each entry function (registers, spills,
               static shared memory).
3. kernels   — each kernel against its plain PyTorch version at the shapes
               the main paths give it, with the stated tolerance; kernel,
               plain and library times (CUDA events, L2 flushed before each
               launch) and the least time the card could take (bound):
               decode attention (serving; also at the split-K edges: one
               key, a ragged last split, lengths 1-1024, a narrow window,
               a query with no key, which must read zeros, more splits
               than head dims; every decode case launched twice,
               bit-identical, and also timed after a read-only flush),
               flash attention
               forward and backward (training; bf16 also with a 128-token
               window and ALiBi and at T 1000, the Hopper kernels' mask
               and ragged edges) and cross-entropy forward and backward
               (training), paged decode (decode steps, its split edges,
               phase 4's prefills of 128, 1004 and 1024 tokens, and phase
               4l's phased step: 8 rows at 17-764 keys, fp32 and int8,
               as the contiguous decode kernel too),
               ragged paged attention (paged pool and continuous
               batching: the GPT-2 mixed step in fp32, bf16 and int8,
               128-row blocks, GQA, window + ALiBi + softcap, padding,
               decode rows at 1-1024 keys, D 8 at 16 splits, phase 4f's
               traffic in fp32 and int8: a prefix hit's 128-token suffix
               chunk and verify spans of 5, 2 and 3 rows, two rows
               aliasing the same 4 pages of the pool's tail; padding
               slots exactly zero, two launches bit-identical, also timed
               after a read-only flush; phase 4l's pipeline stage: the
               mixed step on every layer of a stage's view of the pools,
               layers 4-7 of 12, fp32 and int8) and chunked gated linear
               attention
               (the hybrid's SSM layers, phase 4c's shapes and B 1 x 4096;
               also held to the token-sequential oracle; two launches
               bit-identical), in fp32 and bf16; the recurrent update of
               the SSM rows (packed and dense, phase 4c's widths: a decode
               step of 8 rows, one parked, a 256-token chunk beside 7
               decode rows and a padding block, a 1024-token prefill, fp32
               and from bf16, and the mixed step at dk = dv = 128; y
               against the plain versions, the state, the ring and its
               keys equal to theirs bit for bit; two launches from one
               state bit for bit; one row's 256 slots as 1 launch, 4 of
               64 and 256 of 1, bit for bit).  Phase 4d's shapes too
               (GQA 16/8, D 128, bf16): decode at 1024 keys and the
               1000-token prefill, the paged decode and its 128- and
               1000-token prefills, a ragged mixed step, the flash
               forward and backward at T 1024; and the Gemma-2-2B decode
               (GQA 8/4, D 256, window 4096, softcap 50, 8192 keys).
               Phase 4e's shapes (MHA 16/16, D 128, bf16): decode and
               paged decode at 1024 keys, the ragged mixed step, flash
               forward and backward at 1 x 1024.  The flash rows also
               carry the host microseconds of one wrapper call.
4. serving   — the port's HTTP server in a thread on 127.0.0.1 serving GPT-2
               124M width (presets.gpt2(): d 768, 12 heads, 12 layers, vocab
               50304, block 1024; random weights from seed 0): POST /model/,
               greedy /generate/ twice (1 prefill + one 128-step chunk of
               CUDA-graph replays each; the first captures, the second
               captures nothing), streamed (chunks ramping 8 to 64),
               past block 1024 (chunks of 16 and 4, then a T=1024
               re-prefill a token), under TURBO_QUANT_KV_CACHE=1, /decode/,
               DELETE /model/ (which drops the idle decode runners).  In
               process, the eager step loop (graphs off) gives the graph
               path's tokens on each cache, and both are timed (tokens/s,
               device busy share and kernels a token under
               torch.profiler).  Kernel launch counts are reset just before
               and read just after.  The HTTP requests run under a
               torch.profiler trace (device activity only): the device must
               have run the decode kernel once per attention layer in
               every dispatched step (prefills, replays, capture warm-ups,
               overshoot included), and the wrapper must have launched it
               once per attention layer in every step that was not a
               replay.  The same requests again under PAGED_KV_CACHE=1
               (fp32, past the block, int8): the same tokens, the paged
               kernel 12 times a dispatched step and the contiguous one not
               at all.  What a device length (a
               captured step's) costs a decode launch against a host one,
               at 129 and 1024 keys.  Then the cached (kernel) forward is
               held against the plain no-cache forward (the plain versions
               patched in) on the card.
   Phases 4b and 4f-4l serve GPT-2 124M's width (d 768, 12 heads, vocab
   50304, block 1024) at SERVE_DEPTH = 4 blocks, to keep the script inside
   its time; "GPT-2 124M" there means that model, and each attention
   kernel runs 4 times a step.
4b. continuous — a server under PAGED_KV_CACHE=1
               PENROZ_CONTINUOUS_BATCHING=1 PENROZ_SCHED_MAX_ROWS=8: 8
               concurrent greedy /generate/ (prompts of 16-700 tokens, 64
               new, one streamed) and a /generate_batch/ of 4, each held
               to the request served alone and, as the gate, to the argmax
               of the plain no-cache forward over its prefix; the ragged
               kernel launches 4 times per mixed step /serving_stats/
               reports.  One request at temperature 0.8, twice: the same
               tokens both times.  Aggregate tokens/s, p50 and max latency,
               the same requests one after another, and a torch.profiler
               pass.
4f. prefix_spec — the same server and model under PAGED_KV_CACHE=1
               PENROZ_CONTINUOUS_BATCHING=1 PENROZ_SCHED_MAX_ROWS=8 (64
               prefix-cache pages, the default).  Prefix traffic, fp32 and
               int8 pages: a 512-token prefix (numpy seed 0) + suffixes of
               16-200 tokens, 64 new each; one request warms the cache,
               then 8 stream concurrently, with PENROZ_PREFIX_CACHE off,
               then on (a fresh engine each turn): tokens equal in
               both turns, 8 hits covering 8 x 512 tokens, fewer prefill
               chunks with the cache, an empty page audit and no pin
               left; TTFT p50/max and tokens/s on against off.
               Speculation traffic, PENROZ_SPEC_DECODE=1 at K 4, n-gram 3
               in the same turns: 8 concurrent greedy /generate/ (prompts
               a seeded 64-token sequence x 4, 128 new) and the same
               shape sampled (temperature 0.8, top_k 40) in one
               /generate_batch/: tokens equal on and off, verify spans
               run; random weights never copy, so each sequence's first
               token is searched until the model emits it after the
               prompt, which gives each row one draft; accept rate,
               tokens a decode step, tokens/s on against off.  One
               request with both knobs equals both off.  Every traffic:
               the ragged kernel 4 times a unified step (its count reset
               just before, read just after; the steps counted in
               process).
4g. resilience — GPT-2 124M (4 blocks) under PAGED_KV_CACHE=1
               PENROZ_CONTINUOUS_BATCHING=1 PENROZ_SCHED_MAX_ROWS=8
               PENROZ_PREFIX_CACHE=1 (the breaker's cooldown at 200 ms):
               a greedy request sets T0 and the ragged kernel's device runs
               (its run counter); decode.step:raise@1+ (utils/faults.py):
               three 500s, then 503 with Retry-After in [1, 30] and
               /readyz 503 naming the model; PENROZ_SCHED_FALLBACK=1
               answers T0 through the paged decode kernel (its runs
               counted); disarmed, after the cooldown the probe answers T0
               (ragged runs = 4 x its mixed steps), /readyz 200, 3 resets.
               Again with a shared 512-token prefix: the same tokens as
               with the cache off, a cold probe, a clean page audit, a hit
               after it.  decode.step:sleep@50: an in-flight deadline 504,
               a stream ending in "timeout" after its first tokens;
               PENROZ_SCHED_MAX_QUEUE=1 and 12 concurrent requests: 429s
               with Retry-After, every admitted request T0.  POST /profile/
               around a single-sequence /generate/ (contiguous cache) and a
               scheduler one: the Chrome trace holds the decode and ragged
               kernels and penroz/sched_mixed, a second stop 409.  A
               ByteBPE (vocab 512) on its native core, equal to the
               oracle, through /tokenize/, /generate/ and /decode/;
               /openapi.json's paths equal the route tables, /docs 200.
               PUT /train/ through the native loader stream over two
               uint16 shards (its batches equal the numpy path's), the
               flash and cross-entropy kernels counted.  Last, on a server
               of its own, shutdown under PENROZ_DRAIN_S=5 with 4 rows in
               flight: all 200, no worker thread left.
4h. qos      — GPT-2 124M, 4 rows, pages of 128, 64 prefix-cache pages,
               PENROZ_MEMLEDGER_STRICT=1 (phase 4g's checkpoint): each of
               12 prompts' greedy tokens with QoS idle (T0), one also
               through the single-sequence paged path; under
               decode.step:sleep@20, 8 batch streams of tenant "flood",
               then, once every row has emitted, 4 interactive streams of
               tenant "ui" that preempt them: every stream = T0, >= 1
               preemption, the resumes' cached tokens a positive multiple
               of 128, no pin left, a clean strict audit, every /memory/
               read during the wave partitioning the pool, interactive
               TTFT p99 below batch's, ragged runs = 4 x mixed steps,
               each X-Request-Id echoed; a preempted request's
               /trace/{id} tree and its Chrome JSON, /trace/ listing the
               wave; /metrics parsed as 0.0.4 and equal to
               /serving_stats/ (requests, preemptions, resumed tokens,
               prefix hits and misses), its TTFT _count the requests that
               emitted; a tenant quota (429 with Retry-After for flood,
               200 = T0 for ui, cleared, a tier_mb set and cleared); the
               wave again at
               PENROZ_TRACE_SAMPLE=0 (same tokens; both rates printed); a
               crash in a second engine (block 512) and its /debug/dump
               entry; / 302, /dashboard and /static/dashboard.js 200.
4j. router   — phase_router: GPT-2 124M fp32 (4g's checkpoint), pages of
               128, 64 prefix-cache pages, 8 rows a replica, strict
               ledger.  A 12-stream wave (3 families of a 256-token shared
               prefix + 16-200, 64 new, opened one after another, read
               after) on one engine gives the reference tokens T and the
               rate; then through PENROZ_SCHED_REPLICAS=3 (= T, affinity 9
               hits / 3 misses, /metrics router_* = /serving_stats/,
               audits clean, rate and device busy share against one
               engine); crashes open replica 0 (failover = T, /readyz
               200, the half-open probe readmits it), every replica open
               (503 with Retry-After, /readyz 503, failovers counted, the
               fallback = T through the paged kernel); disaggregated
               prefill with one prefill replica over the d2d and host
               transports, fp32 and int8 (= T, exports = imports = 12, no
               failure, every /memory/ read partitioning each pool, no
               blob or parked page left, hand-off ms and bytes), a
               disagg.d2d and a disagg.handoff fault (= T); one elastic
               prefill -> decode flip (a stream of each family = T).
               Ragged device runs = 4 x every replica's mixed steps.
4k. sessions — phase_sessions: GPT-2 124M fp32 (4g's checkpoint), pages of
               128, 8 rows, the prefix cache, the strict ledger, a 32 MB
               host tier, a 1024 MB disk tier and the journal under one
               temporary directory (removed at the end), a 2 s detach
               grace.  The references: 8 prompts of 384-600 tokens cold
               (H1, 64 new), then each history + 32 user tokens cold from
               an empty cache (T2).  Turn 1 with session ids (= H1, 3-5
               full pages a session, every /memory/ read partitioning the
               pool) until /sessions/ shows none in hbm (hibernating 0);
               engines reset, a byte of one disk blob flipped; turn 2
               with the same ids: every stream = T2, host and disk
               promotions ok, the flipped one counted corrupt and
               recomputed, each woken admission prefilling only the
               suffix past its session's pages, /metrics' tier_* and
               sessions_* = /serving_stats/; DELETE removes each session
               from every tier.  Turn 1 again, a journaled tier_mb, the
               registry and the engines dropped and the server created
               anew (its recovery): /sessions/ lists every disk session,
               /debug/dump's restart_recovery, the tier_mb kept, a disk
               wake = T2.  A stream dropped after 8 tokens reattached at
               from_seq=8 within the grace (contiguous sequence numbers,
               tokens = H1), another left to expire (cancelled, no page or
               pin left).  The int8 repeat for 4 sessions.  Ragged device
               runs = 4 x mixed steps in every wave.  Turn 2's TTFT by
               source tier against the cold reference, the demotion's
               export ms, bytes a session (fp32, int8) and the disk
               tier's MB/s are printed.
4l. ticks    — phase_ticks: GPT-2 124M fp32 (4g's checkpoint, read once
               for the phase), 8 rows, phase 4b's wave (8 streams, prompts
               of 16-700 tokens, 64 new) through the engine's other tick
               forms, each on a fresh engine: the phased ticks over the
               contiguous cache, fp32 and int8 (every stream = its
               single-sequence tokens, at superstep 8 in fewer dispatches
               than at 1, with chunks of 128 too; the decode kernel 4
               times a forward pass); the phased ticks over the paged pool
               (PENROZ_RAGGED_ATTENTION=0, pages of 128; = the unified
               engine's tokens, the paged decode kernel 4 times a forward
               pass, the ragged kernel never); speculation on the phased
               ticks (4f's shape, K 4, n-gram 3: on = off, an oracle
               drafter fully accepted); pipeline serving at 2 and 4 stages,
               fp32 and int8 pages, the prefix cache off (on too at 2
               stages, fp32) (= the
               unpiped tokens, the ragged kernel 4 times a block's step,
               the bubble fraction, stage_pools partitioning the pool,
               /metrics' penroz_pipe_* = /serving_stats/, a pipe.handoff
               fault's host fallback, a pipe.stage_crash's recovery); the
               legacy /generate_batch/ of 4 rows on both caches (each row
               = its single-sequence tokens, the decode kernels 4 times a
               forward pass) and as the open breaker's fallback.  Each
               engine's rate and, in a traced repeat, the device's busy
               share are printed.
4m. ssm      — phase_ssm: phase 4c's hybrid (fp32, seed 0; its checkpoint
               read once for the phase) under continuous batching, 8 rows,
               phase 4b's wave on fresh engines: the unified engine (pages
               of 128; /serving_stats/' ssm_state_bytes the same at two
               lengths and /memory/'s ssm_state, every read partitioning
               the pool), the phased ticks over the contiguous cache,
               speculation (K 4) on the unified engine, one of two
               replicas prefill-only over the d2d and the host hand-offs,
               an ssm.handoff fault (one fallback), and a legacy
               /generate_batch/ of 4 rows: every stream and row = its
               single-sequence tokens; the recurrent-update kernel 6 times
               a forward pass and the wave's attention kernel (ragged, or
               the decode kernel on the phased ticks) 6 times, the others
               never; each wave's rate.
4c. hybrid   — a server with the hybrid attention/SSM model
               (presets.hybrid_custom(768, 12, 12, vocab 50304, block 1024,
               ssm_every 2): 6 SSM and 6 attention blocks, fp32, random
               weights from seed 0): greedy /generate/ 128 + 128 twice, on
               the int8 cache, and under PAGED_KV_CACHE=1 (fp32 and int8;
               the same tokens as the contiguous cache of the same
               precision), through CUDA graphs, each equal in process to
               the eager step loop's, 6 attention and 6 recurrent-update
               launches a dispatched step (replays included, the kernels'
               run counters), graph and eager timed; where the int8 tokens first leave the fp32
               ones, and the fp32 top-1 minus top-2 logit gap there
               (recorded, not gated); /output/ on a 16-token prompt,
               whose argmax is the first greedy token of that prompt
               within ARGMAX_ATOL, and at 1 x 1024 (timed);
               in-process compute_output at 1 x 1024, its logits held to
               the same forward with the sequential oracle in place of the
               kernel; /evaluate/ at 8 x 1024 on a synthetic shard, equal
               to in-process evaluate_model; a torch.profiler pass over one
               no-cache forward at 8 x 1024.  The chunked kernel's count is
               reset just before and read just after: exactly 6 launches a
               no-cache forward, none on the cached path, none in the
               /stats/ pass at 1 x 256 (the SSM layers' differentiable
               oracle; the fp32 flash and cross-entropy kernels forward and
               backward).
4d. qwen3    — the slice's main path: a checkpoint of the published
               Qwen/Qwen3-0.6B config.json (d 1024, GQA 16/8, head_dim
               128, vocab 151936, tied embeddings; its 28 layers cut to
               QWEN3_LAYERS = 2 to keep the script's time; random bf16
               weights from seed 0, N(0, 0.02), norms 1 + N(0, 0.1))
               written here in the HF layout, two safetensors shards and
               an index; POST /import/ (timed); greedy /generate/ 128 +
               128 twice (the second captures nothing), streamed, a
               1000-token prompt, on the contiguous cache and under
               PAGED_KV_CACHE=1 (the same tokens), the decode kernels' run
               counters 2 a dispatched step; in process, graph == eager
               on both caches, tokens/s and device busy share (graph,
               paged graph, eager), the checkpoint load timed; /output/ at
               1 x 1024 (2 flash-forward launches); the card's logits at
               8 positions against the port's CPU forward of the same
               bf16 weights (QWEN3_LOGIT_FACTOR); 4 concurrent requests
               under PENROZ_CONTINUOUS_BATCHING=1 PAGED_KV_CACHE=1 (the
               ragged kernel 2 a mixed step, each token the plain
               forward's argmax, near ties excepted as stated at
               _hf_continuous); DELETE /model/.
4e. qmoe     — the same path (phase_import) for the MoE slice: the
               published Qwen/Qwen1.5-MoE-A2.7B config.json (d 2048, MHA
               16/16, 60 experts of width 1408, top-4 without
               renormalization, a shared expert of width 5632 behind its
               sigmoid gate, vocab 151936, untied head) with its 24 layers
               cut to QMOE_LAYERS = 2 (~1.76 B parameters, ~3.5 GB bf16):
               the import, greedy requests (twice) on the contiguous cache
               and one on the paged pool (each request loads the 3.5 GB
               checkpoint; the streamed and 1000-token requests are
               Qwen3's alone, the long prompt runs in process), graph ==
               eager on both (graph and paged graph timed, eager not), the
               decode kernels 2 a dispatched step, /output/ with 2 flash-forward launches, the card's
               logits against the CPU forward, 4 concurrent requests (the
               ragged kernel 2 a mixed step), DELETE.
5. training  — the same server trains GPT-2 124M (AdamW, bf16 compute, the
               default on the card) through PUT /train/ on a synthetic uint16
               shard: batch 4 x block 1024, step 2 (two micro-steps an
               epoch); a second PUT is a 409; /progress/ is polled until
               Trained.  Counts reset just before and read just after: each
               micro-step must launch the flash forward and backward once per
               attention layer and the cross-entropy forward and backward
               once.  Costs finite, the first near ln 50304, the last below
               it; tokens/s; then greedy /generate/ from the trained model
               twice, identical.  The training options on its checkpoint
               (phase_train_options): one epoch with PENROZ_REMAT=1 against
               one without (costs within REMAT_RTOL, flash forward launched
               twice as often, peak memory of each); PENROZ_TRAIN_WORKER=1
               (2 epochs in the child end Trained; a child killed mid-run
               ends Error while /generate/ answers; a checkpoint left at
               Training reads Error after a server starts); a streamed
               /generate/'s TTFT during training with
               PENROZ_DECODE_PRIORITY_MS at 1000 and at 0 (no gate).  GET /stats/ of the trained model (the
               refresh at the end of training): one entry a non-softmax
               layer and a parameter, all finite, 404 and 422; the refresh
               in process at 1 x 1024, timed, its fp32 flash and
               cross-entropy launches counted.  Then one epoch's time by
               kernel, under torch.profiler (the Python API, same shapes).
5b. moe_training — the same training path for an MoE model at GPT-2
               width (moe_train_layers: d 768, 12 heads, 1 block, vocab
               50304, block 1024; each MLP 8 experts of width 3072, top-2,
               capacity dispatch at 1.25, load-balance coefficient 0.01):
               PUT /train/ bf16 at 4 x 1024, step 2, the same launch
               counts, costs finite and falling, greedy /generate/ twice
               identical; then GET /stats/'s moe_router_fractions (1
               entry of 8 finite values, each summing to 1 within 1e-5),
               the greedy tokens again under PAGED_KV_CACHE=1, and a
               POST /dataset/ that ends failed with the datasets module
               blocked in process (this machine has it, and a download
               would reach for the network), the server still answering.
5d. ranks    — training over ranks (phase_ranks): two rank processes
               (this script with --rank-worker, torchrun's environment on
               127.0.0.1) share the card over gloo (parallel/dist.py's
               backend rule), each training GPT-2 124M (bf16 compute,
               AdamW, random weights from seed 0, one checkpoint) at 4 x
               1024, step 1, 2 epochs: data parallelism, then PENROZ_WUS,
               then PENROZ_FSDP, then evaluate_model.  This process runs
               the reference at world 1 over NCCL (8 x 1024, step 4: the
               same rows) while the ranks start, and lets them train once
               its epochs have ended.  Gates: both ranks' gathered state
               equal bit for bit; every run's costs within RANKS_RTOL of
               the reference's; WUS and FSDP parameters within RANKS_RTOL
               x |w| + lr x epochs of DP's; moment bytes a rank (and FSDP's
               parameter bytes) the replicated figure with each cut leaf
               halved; two shard files a sharded run, reassembled here
               equal to the ranks' state bit for bit; both ranks'
               evaluation equal and within RANKS_RTOL of world 1's; flash
               and cross-entropy launches a micro-step on each rank equal
               to the reference's (counts reset just before each run, read
               just after); the per-rank logs.  Recorded: tokens/s a rank
               and in all against world 1, peak memory a rank, each
               collective's seconds.  A rank that fails fails the phase.
6. micro-step — one fp32 training micro-step at GPT-2 width (B 1, T 1024):
               loss and every parameter gradient through the kernels against
               the same step with the plain versions patched in; then the
               same for phase 5b's MoE model (the load-balance loss in the
               loss, the router and expert stacks among the gradients).
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
import re
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
    ("paged_attention", "penroz_tpu_torch/csrc/paged_attention.cu"),
    ("ragged_paged_attention",
     "penroz_tpu_torch/csrc/ragged_paged_attention.cu"),
    ("ssm_scan", "penroz_tpu_torch/csrc/ssm_scan.cu"),
    ("ssm_update", "penroz_tpu_torch/csrc/ssm_update.cu"),
]
# Launch sites of the main paths: (name, source, TPU kernel it replaces,
# phase-3 case that stands for it: phase 4e's shape, Qwen1.5-MoE's MHA
# 16/16, D 128, bf16, for the four kernels its serving path runs).
KERNELS = [
    ("decode_attention", "penroz_tpu_torch/csrc/decode_attention.cu",
     "penroz_tpu/ops/pallas/decode_attention.py:155",
     "qmoe_decode_L1024_bf16"),
    ("flash_attention_fwd", "penroz_tpu_torch/csrc/flash_attention.cu",
     "penroz_tpu/ops/pallas/flash_attention.py:200",
     "flash_qmoe_T1024_bf16_fwd"),
    ("flash_attention_bwd", "penroz_tpu_torch/csrc/flash_attention.cu",
     "penroz_tpu/ops/pallas/flash_attention.py:411",
     "flash_gpt2_B4_T1024_bf16_bwd"),
    ("ce_forward", "penroz_tpu_torch/csrc/cross_entropy.cu",
     "penroz_tpu/ops/pallas/cross_entropy.py:100",
     "ce_gpt2_N4096_V50304_bf16_fwd"),
    ("ce_backward", "penroz_tpu_torch/csrc/cross_entropy.cu",
     "penroz_tpu/ops/pallas/cross_entropy.py:147",
     "ce_gpt2_N4096_V50304_bf16_bwd"),
    ("paged_decode_attention", "penroz_tpu_torch/csrc/paged_attention.cu",
     "penroz_tpu/ops/pallas/paged_attention.py:152",
     "paged_qmoe_decode_L1024_bf16"),
    ("ragged_paged_attention",
     "penroz_tpu_torch/csrc/ragged_paged_attention.cu",
     "penroz_tpu/ops/pallas/ragged_paged_attention.py:161",
     "ragged_qmoe_mixed_bf16"),
    ("gla_chunked", "penroz_tpu_torch/csrc/ssm_scan.cu",
     "penroz_tpu/ops/pallas/ssm_scan.py:74", "gla_gpt2_B8_T1024_fp32"),
    # no pallas_call: the JAX package's lax.scan of the recurrent update
    ("ssm_update", "penroz_tpu_torch/csrc/ssm_update.cu",
     "penroz_tpu/ops/ssm.py:248", "ssm_mixed_256_7_fp32"),
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
# The engine's phases (4b, 4f-4l) serve GPT-2 124M's width (d 768, 12
# heads, vocab 50304, block 1024) at this many blocks, to keep the script
# inside its time; phase 4 serves all 12.
SERVE_DEPTH = 4
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
# phase 5's micro-steps: batch 4 x block 1024, step 2 (two an epoch); the
# end of each run refreshes /stats/ on the last one, whose host histograms
# grow with the batch
TRAIN_BATCH, TRAIN_BLOCK, TRAIN_STEP = 4, 1024, 2
STATS_BATCH = 1          # phase 5's in-process /stats/ refresh
# Micro-step: loss rtol 1e-5; each gradient max |diff| <= 1e-4 * max |g|
# (fp32, summation order through 12 layers).
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_RTOL = 1e-4
# Chunked GLA against its plain version (same block_t, both fp32 math):
# element by element within GLA_C * (sum |terms| + |ref|), sum |terms| the
# plain version on |q|, |k|, |v| (every decay is positive); the two round
# the cumsum of the log-gates (|la| up to ~90 over a chunk) in another
# order, which moves a decay factor by up to ~1e-5.  Against the
# token-sequential oracle (products of gates, not exp of cumsums), gates
# above the 1e-6 log floor: GLA_SEQ_C on the same scale.
GLA_C = 1e-4
GLA_SEQ_C = 1e-3
# Tensor-core peaks a GLA row's operations bound is restated at when the
# kernel beats the fp32 FMA rate (name, FLOP/s).
GLA_TENSOR_PEAK = {"float32": ("3xTF32 tensor cores, 495 / 3 TFLOP/s",
                               495e12 / 3),
                   "bfloat16": ("bf16 tensor cores, 989 TFLOP/s", 989e12)}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# Each phase's wall time (seconds, its set-up included), reported at the
# end.
WALL: dict = {}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def timed(label, fn, /, *args, **kwargs):
    """``fn(*args, **kwargs)``, its wall time kept in WALL[label]."""
    t0 = time.monotonic()
    try:
        return fn(*args, **kwargs)
    finally:
        WALL[label] = time.monotonic() - t0


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


class Builds:
    """The kernels' nvcc builds, one a source, all started together in the
    background (phase 2); phase 3 waits for each library just before its
    first case, so that its other cases run while the slowest source (the
    ragged kernel's) still compiles."""

    def __init__(self):
        from penroz_tpu_torch.ops.kernels import build
        self.build = build
        self.t0 = time.monotonic()
        self.done = {}
        self.pool = concurrent.futures.ThreadPoolExecutor(len(SOURCES))
        self.futures = {name: self.pool.submit(self._one, name)
                        for name, _ in SOURCES}

    def _one(self, name):
        path = self.build.build(name)
        self.done[name] = time.monotonic() - self.t0
        return path

    def wait(self, *names):
        """Block until ``names`` (every source when none) are built, and
        print each one's library, build time and ptxas report once."""
        for name in names or list(self.futures):
            future = self.futures.pop(name, None)
            if future is None:
                continue
            path = future.result()   # a failed build raises here
            say("build", f"{name}: {os.path.relpath(path, ROOT)} in "
                f"{self.done[name]:.1f} s (all started together)")
            for line in self.build.BUILD_LOGS.get(name, "").splitlines():
                if ("Compiling entry function" in line
                        or "registers" in line or "spill" in line):
                    say("build", f"  {name}: {line.strip()}")
        if not self.futures:
            self.pool.shutdown()
            WALL["build"] = max(self.done.values())


def phase_build():
    """Start every source's build; returns the Builds to wait on."""
    return Builds()


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


def _time_ms(torch, fn, iters, flush, clean=False):
    """Mean device ms of ``fn`` over ``iters`` launches, each after an L2
    flush (``flush`` written, or with ``clean`` read, which leaves no dirty
    lines for ``fn``'s misses to write back), timed with CUDA events around
    the launch alone.  A spin kernel queued first keeps the device busy
    while the host enqueues the flush, the events and ``fn``, so host-side
    launch overhead is not timed."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        torch.cuda._sleep(1_500_000)  # ~1 ms of device time
        if clean:
            flush.sum()
        else:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


def _host_us(torch, fn, iters):
    """Mean host microseconds of one call of ``fn`` (a wrapper: its Python,
    its allocations, the C entry point and the launch), with a spin kernel
    queued first so that no call waits on the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # ~12 ms of device time
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return host / iters * 1e6


def _row(name, err, err_over_tol, tol_text, ms, plain_ms, library_ms,
         nbytes, ops, peak, clean_ms=None):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    row = {"name": name, "max_abs_err": err, "err_over_tol": err_over_tol,
           "tolerance": tol_text, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes": nbytes, "ops": ops}
    lib = f"{library_ms:.4f}" if library_ms is not None else "null"
    clean = ""
    if clean_ms is not None:
        row["ms_read_flush"] = clean_ms
        clean = f" (read flush {clean_ms:.4f} ms)"
    say("kernels", f"{name}: err {err:.2e} ({err_over_tol:.3f} x "
        f"{tol_text}) kernel {ms:.4f} ms{clean} plain {plain_ms:.4f} ms "
        f"library {lib} ms bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']})")
    return row


def run_case(torch, case, flush):
    """The contiguous decode kernel against its plain version; one row.
    ``lengths`` (one per sequence) instead of ``L`` passes a length tensor;
    a query before position 0 attends no key, and the kernel must write
    zeros there (the plain version averages the masked row)."""
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    F = torch.nn.functional
    B, Hq, Hkv, T, S, D = (case[k] for k in ("B", "Hq", "Hkv", "T", "S", "D"))
    lens = case.get("lengths", [case.get("L")] * B)
    L = max(lens)
    if "lengths" in case:
        length, offset = torch.tensor(lens, dtype=torch.int32,
                                      device="cuda"), 0
    else:
        length, offset = L, L - T
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
    kernel = lambda: DA.decode_attention(  # noqa: E731
        q, k, v, offset, length, **kw)
    plain = lambda: DA.decode_attention_reference(  # noqa: E731
        q, k, v, offset, length, **kw)
    before = DA.decode_attention.launches
    out = kernel()
    torch.cuda.synchronize()
    check(DA.decode_attention.launches == before + 1,
          f"{case['name']}: launch not counted")
    check(torch.equal(kernel(), out),
          f"{case['name']}: two launches differ")
    # rows before position 0: zeros from the kernel, left out of the
    # comparison with the plain version
    pos = torch.tensor(lens, device="cuda")[:, None] - T + torch.arange(
        T, device="cuda")
    empty = (pos < 0)[:, None, :, None]
    check(bool((out.masked_select(empty) == 0).all()),
          f"{case['name']}: a row with no attended key is not zero")
    ref = plain().float().masked_fill(empty, 0.0)
    diff = (out.float() - ref).abs()
    err = float(diff.max())
    if case["dtype"] == "bfloat16":
        ref_abs = DA.decode_attention_reference(q, k, _abs(v), offset,
                                                length, **kw).float()
        tol = BF16_STEP * (ref_abs + ref.abs()).masked_fill(empty, 1.0)
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
    clean_ms = _time_ms(torch, kernel, iters, flush, clean=True)
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
        key = torch.arange(L, device="cuda")[None, None, :]
        mask = key <= pos[:, :, None]                       # (B, T, L)
        if window:
            mask &= key > pos[:, :, None] - window
        bias = None
        if case.get("alibi"):
            slopes = torch.as_tensor(kw["alibi"], device="cuda")
            bias = slopes[None, :, None, None] * (
                key[:, None] - pos[:, None, :, None]).float()
            bias = bias.masked_fill(~mask[:, None], float("-inf")).to(dtype)
        attn_mask = bias if bias is not None else (
            None if T == 1 and not window and "lengths" not in case
            else mask[:, None])
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kd, vd, attn_mask=attn_mask, enable_gqa=Hq != Hkv)
        library_ms = _time_ms(torch, sdpa, max(3, iters // 4), flush)

    pairs, keys = 0, 0
    for n in lens:
        p_n, first_key = _attended_pairs(T, n, window)
        pairs += p_n
        keys += n - first_key
    itemsize = torch.empty((), dtype=dtype).element_size()
    kv_item = 1 if case.get("int8") else itemsize
    nbytes = (2 * q.numel() * itemsize
              + 2 * Hkv * keys * (D * kv_item + scale_bytes))
    return _row(case["name"], err, err_over_tol, tol_text, ms, plain_ms,
                library_ms, nbytes, 4 * D * pairs * Hq,
                PEAK_OPS_PER_S[case["dtype"]],
                clean_ms)


# the phased ticks' shared step (phase 4l): 8 rows, each at its own length
PHASED_LENGTHS = [17, 764, 300, 45, 612, 129, 256, 500]


def kernel_cases():
    gpt2 = dict(B=1, Hq=12, Hkv=12, S=1024, D=64)
    gqa = dict(B=1, Hq=32, Hkv=8, S=1024, D=128)
    qwen3 = dict(B=1, Hq=16, Hkv=8, S=1024, D=128)
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
        # the edges of the decode tiles' split: one key, a ragged last
        # split, lengths spread 1-1024, a window narrower than the splits
        # with 8 query tokens, and a query before position 0 (no key)
        dict(gpt2, name="gpt2_decode_L1", T=1, L=1, dtype="float32"),
        dict(gpt2, name="gpt2_decode_L65", T=1, L=65, dtype="float32"),
        dict(gpt2, name="gpt2_B8_lengths_1_1024", B=8, T=1,
             lengths=[1024, 700, 129, 1, 513, 900, 257, 64],
             dtype="float32"),
        dict(gpt2, name="gpt2_T8_window60", T=8, L=1000, dtype="float32",
             window=60),
        dict(gpt2, name="gpt2_no_attended_row_bf16", B=2, T=3,
             lengths=[2, 700], dtype="bfloat16"),
        # more splits (16) than head dims (8): each block sends every
        # row's (max, sum) to the ranks past D too
        dict(name="d8_gqa32x8_T4_L1024", B=1, Hq=32, Hkv=8, S=1024, D=8,
             T=4, L=1024, dtype="float32"),
        # phase 4d's Qwen3-0.6B attention (GQA 16/8, D 128, bf16): a
        # decode step at 1024 keys and the 1000-token prompt's prefill
        dict(qwen3, name="qwen3_decode_L1024_bf16", T=1, L=1024,
             dtype="bfloat16"),
        dict(qwen3, name="qwen3_prefill_T1000_bf16", T=1000, L=1000,
             dtype="bfloat16", iters=5),
        # the Gemma-2-2B attention the gemma2 import reaches: GQA 8/4,
        # D 256, a 4096-token window and softcap 50 at 8192 keys
        dict(name="gemma2_decode_L8192_window4096_softcap50_bf16", B=1,
             Hq=8, Hkv=4, S=8192, D=256, T=1, L=8192, window=4096,
             softcap=50.0, dtype="bfloat16"),
        # phase 4e's Qwen1.5-MoE-A2.7B attention (MHA 16/16, D 128,
        # bf16): a decode step at 1024 keys
        dict(B=1, Hq=16, Hkv=16, S=1024, D=128,
             name="qmoe_decode_L1024_bf16", T=1, L=1024, dtype="bfloat16"),
        # phase 4l's phased shared step over the contiguous cache: 8 rows
        # with their own lengths, fp32 and int8
        dict(gpt2, name="gpt2_phased_B8_lengths_17_764", B=8, T=1,
             lengths=PHASED_LENGTHS, dtype="float32"),
        dict(gpt2, name="gpt2_phased_B8_lengths_17_764_int8", B=8, T=1,
             lengths=PHASED_LENGTHS, dtype="float32", int8=True),
    ]
    for i, c in enumerate(cases):
        c["seed"] = i
    return cases


def _flash_inputs(torch, case):
    """q, k, v, dO on the card from the case's seed, and the options."""
    from penroz_tpu_torch.ops import attention as A
    B, Hq, Hkv, T, D = (case[k] for k in ("B", "Hq", "Hkv", "T", "D"))
    dtype = getattr(torch, case["dtype"])
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q, k, v, dout = (torch.randn(B, h, T, D, device="cuda", generator=g)
                     .to(dtype) for h in (Hq, Hkv, Hkv, Hq))
    kw = {"window": case.get("window"), "scale": case.get("scale"),
          "dropout_rate": case.get("rate", 0.0), "seed": case.get("seed")}
    if case.get("alibi"):
        kw["alibi"] = A.alibi_slopes(Hq)
    return q, k, v, dout, kw


def _flash_errors(torch, case, q, k, v, dout, kw, out, lse, grads):
    """(forward max abs err, its ratio to the tolerance, backward max abs
    err, its ratio) of a kernel's results against the plain versions;
    fails past the tolerance."""
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    c = FLASH_C[case["dtype"]]

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
    Hkv = k.shape[1]
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
    errs = [worst(a, b, *t) for a, b, t in zip(grads, (rq, rk, rv), bounds)]
    ratio_b = max(r for _, r in errs)
    check(ratio_b <= 1.0, f"{case['name']} backward: {ratio_b:.2f} x "
          f"tolerance (dq/dk/dv {[round(r, 3) for _, r in errs]})")
    return err_f, ratio_f, max(e for e, _ in errs), ratio_b


def run_flash_case(torch, case, flush):
    """Flash forward and backward against the plain versions; two rows."""
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    F = torch.nn.functional
    B, Hq, Hkv, T, D = (case[k] for k in ("B", "Hq", "Hkv", "T", "D"))
    dtype = getattr(torch, case["dtype"])
    q, k, v, dout, kw = _flash_inputs(torch, case)
    fwd_before = FA.flash_forward.launches
    bwd_before = FA.flash_backward.launches
    out, lse = FA.flash_forward(q, k, v, **kw)
    grads = FA.flash_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    check(FA.flash_forward.launches == fwd_before + 1
          and FA.flash_backward.launches == bwd_before + 1,
          f"{case['name']}: launches not counted")
    c = FLASH_C[case["dtype"]]
    tol_text = f"{c:.3g} * (sum|terms| + |ref|) + dS err + 1e-6"
    err_f, ratio_f, err_b, ratio_b = _flash_errors(
        torch, case, q, k, v, dout, kw, out, lse, grads)
    del grads

    iters = case.get("iters", 10)
    fwd = lambda: FA.flash_forward(q, k, v, **kw)  # noqa: E731
    bwd = lambda: FA.flash_backward(q, k, v, out, lse, dout, **kw)  # noqa
    ms_f = _time_ms(torch, fwd, iters, flush)
    ms_b = _time_ms(torch, bwd, iters, flush)
    host_f = _host_us(torch, fwd, 20)
    host_b = _host_us(torch, bwd, 20)
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

    lib_f = _time_ms(torch, sdpa, max(3, iters // 4), flush)
    lib_out = sdpa()
    lib_b = _time_ms(torch, lambda: torch.autograd.grad(
        lib_out, (ql, kl, vl), dout, retain_graph=True), max(3, iters // 4),
        flush)
    del lib_out

    item = torch.empty((), dtype=dtype).element_size()
    pairs = B * Hq * _attended_pairs(T, T, kw["window"])[0]
    peak = PEAK_OPS_PER_S[case["dtype"]]
    qn, kn, rows = q.numel(), k.numel(), B * Hq * T
    # forward: read q, k, v; write out and the fp32 lse.  backward: read
    # q, k, v, out, dO and lse; write dq, dk, dv.
    fwd_bytes = (2 * qn + 2 * kn) * item + 4 * rows
    bwd_bytes = (3 * qn + 2 * kn) * item + 4 * rows + (qn + 2 * kn) * item
    pair = [
        _row(case["name"] + "_fwd", err_f, ratio_f, tol_text, ms_f, plain_f,
             lib_f, fwd_bytes, 4 * D * pairs, peak),
        _row(case["name"] + "_bwd", err_b, ratio_b, tol_text, ms_b, plain_b,
             lib_b, bwd_bytes, 10 * D * pairs, peak)]
    for row, host in zip(pair, (host_f, host_b)):
        row["host_us"] = host
    say("kernels", f"{case['name']}: host per wrapper call fwd {host_f:.1f} "
        f"us bwd {host_b:.1f} us")
    return pair


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


def _random_pools(torch, lengths, Hkv, D, P, pages_per_seq, dtype, int8,
                  seed, extra_pages=4, shared=None):
    """Paged pools on the card with each sequence's live pages on shuffled
    physical pages and -1 past them; int8 pools quantized by the cache's
    own quantizer.  ``shared`` = (rows, n): those rows' first n logical
    pages alias the same n pages of the pool's tail, past the rows'
    partition of ``len(lengths) * pages_per_seq`` pages (a radix prefix
    hit's block table), the other pages shuffled within the partition.
    Returns (k, v, table, scale kwargs)."""
    from penroz_tpu_torch.ops import kv_cache as KV
    g = torch.Generator(device="cuda").manual_seed(seed)
    base = len(lengths) * pages_per_seq
    num_pages = base + extra_pages
    k = torch.randn(1, Hkv, num_pages * P, D, device="cuda", generator=g)
    v = torch.randn(1, Hkv, num_pages * P, D, device="cuda", generator=g)
    perm = torch.randperm(base if shared else num_pages, device="cuda",
                          generator=g).cpu()
    table = torch.full((len(lengths), pages_per_seq), -1, dtype=torch.int32)
    used = 0
    for r, n in enumerate(lengths):
        live = -(-n // P)
        first = shared[1] if shared and r in shared[0] else 0
        table[r, first:live] = perm[used:used + live - first]
        table[r, :first] = torch.arange(base, base + first)
        used += live - first
    table = table.cuda()
    if not int8:
        return k[0].to(dtype), v[0].to(dtype), table, {}
    qk, sk = KV._quantize_int8(k)
    qv, sv = KV._quantize_int8(v)
    return qk[0], qv[0], table, {"k_scale": sk[0], "v_scale": sv[0]}


def _abs(v):
    """|v| for the bf16 tolerance's sum w|v|: an int8 cache is widened
    first, since int8 abs() wraps -128 (which the quantizer emits from bf16
    input) to -128."""
    return v.abs() if v.is_floating_point() else v.short().abs()


def _tolerance(torch, out, ref, ref_abs_fn, dtype_name):
    """(max abs err, err / tol, tol text) of a kernel output against its
    plain version: fp32 and int8 pools atol 1e-4; bf16 2^-7 · (Σ w|v| +
    |ref|), Σ w|v| being the plain version run on |v| (ref_abs_fn)."""
    diff = (out.float() - ref.float()).abs()
    if dtype_name == "bfloat16":
        tol = BF16_STEP * (ref_abs_fn().float() + ref.float().abs())
        text = "2^-7 * (sum w|v| + |ref|)"
    else:
        tol = torch.full_like(diff, FP32_ATOL)
        text = f"atol {FP32_ATOL}"
    # a padding slot has err = tol = 0
    ratio = float((diff / tol.clamp_min(1e-30)).max())
    return float(diff.max()), ratio, text


def _live_rows(P, spans_or_lengths, window=None):
    """Key rows a kernel must read per kv head: each sequence's live pages
    (from the window's first page), once."""
    total = 0
    for first_pos, end in spans_or_lengths:
        lo = max(0, first_pos - window + 1) // P * P if window else 0
        total += -(-end // P) * P - lo
    return total


def run_paged_case(torch, case, flush):
    """The paged decode kernel against its plain version; one row."""
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    F = torch.nn.functional
    Hq, Hkv, T, D, P = (case[k] for k in ("Hq", "Hkv", "T", "D", "P"))
    lengths = case["lengths"]
    B = len(lengths)
    dtype = getattr(torch, case["dtype"])
    pages = -(-max(lengths) // P) + case.get("spare_pages", 0)
    k, v, table, scales = _random_pools(torch, lengths, Hkv, D, P, pages,
                                        dtype, case.get("int8"), case["seed"])
    g = torch.Generator(device="cuda").manual_seed(case["seed"] + 1)
    q = torch.randn(B, Hq, T, D, device="cuda", generator=g).to(dtype)
    kw = {"window": case.get("window"), "softcap": case.get("softcap")}
    if case.get("alibi"):
        kw["alibi"] = A.alibi_slopes(Hq)
    if B == 1:  # the single-sequence path passes an int length
        length, offset = lengths[0], lengths[0] - T
    else:
        length, offset = torch.tensor(lengths, dtype=torch.int32,
                                      device="cuda"), 0
    kernel = lambda: PA.paged_decode_attention(  # noqa: E731
        q, k, v, table, P, offset, length, **scales, **kw)
    plain = lambda: PA.paged_decode_attention_reference(  # noqa: E731
        q, k, v, table, P, offset, length, **scales, **kw)
    before = PA.paged_decode_attention.launches
    out = kernel()
    torch.cuda.synchronize()
    check(PA.paged_decode_attention.launches == before + 1,
          f"{case['name']}: launch not counted")
    check(torch.equal(kernel(), out),
          f"{case['name']}: two launches differ")
    check(bool(torch.isfinite(out).all()), f"{case['name']}: non-finite")
    ref = plain()
    err, ratio, text = _tolerance(
        torch, out, ref, lambda: PA.paged_decode_attention_reference(
            q, k, _abs(v), table, P, offset, length, **scales, **kw),
        case["dtype"])
    check(ratio <= 1.0, f"{case['name']}: max abs err {err:.3e}, "
          f"{ratio:.2f} x the tolerance {text}")
    iters = case.get("iters", 20)
    ms = _time_ms(torch, kernel, iters, flush)
    clean_ms = _time_ms(torch, kernel, iters, flush, clean=True)
    plain_ms = _time_ms(torch, plain, max(3, iters // 4), flush)

    library_ms = None
    if not case.get("softcap"):
        # one PyTorch call on the already-gathered (dequantized) dense view:
        # a yardstick only, which leaves the gather out
        kd, vd = PA.dequantized_views(q, k, v, table, P,
                                      scales.get("k_scale"),
                                      scales.get("v_scale"))
        L = max(lengths)
        kd, vd = kd[:, :, :L].contiguous(), vd[:, :, :L].contiguous()
        lens = torch.tensor(lengths, device="cuda")
        pos = lens[:, None] - T + torch.arange(T, device="cuda")[None, :]
        key = torch.arange(L, device="cuda")
        mask = key[None, None, :] <= pos[:, :, None]          # (B, T, L)
        if kw["window"]:
            mask &= key[None, None, :] > pos[:, :, None] - kw["window"]
        if case.get("alibi"):
            slopes = torch.as_tensor(kw["alibi"], device="cuda")
            bias = slopes[None, :, None, None] * (
                key[None, None, None, :] - pos[:, None, :, None]).float()
            attn_mask = bias.masked_fill(~mask[:, None], float("-inf")
                                         ).to(dtype)
        else:
            attn_mask = mask[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, kd, vd, attn_mask=attn_mask, enable_gqa=Hq != Hkv)
        library_ms = _time_ms(torch, sdpa, max(3, iters // 4), flush)
        del kd, vd

    item = torch.empty((), dtype=dtype).element_size()
    kv_item = 1 if case.get("int8") else item
    scale_bytes = 4 if case.get("int8") else 0
    rows = _live_rows(P, [(n - T, n) for n in lengths], kw["window"])
    pairs = sum(_attended_pairs(T, n, kw["window"])[0] for n in lengths)
    nbytes = (2 * q.numel() * item + 2 * Hkv * rows * (D * kv_item
                                                       + scale_bytes)
              + table.numel() * 4)
    return _row(case["name"], err, ratio, text, ms, plain_ms, library_ms,
                nbytes, 4 * D * pairs * Hq, PEAK_OPS_PER_S[case["dtype"]],
                clean_ms)


def run_ragged_case(torch, case, flush):
    """The ragged kernel against its plain version; one row.  ``spans``:
    (q_start, q_len) per row (row i is span i).  ``stage`` = (layers, lo,
    hi): the kernel runs on a pipeline stage's view of a cache of that
    many layers (``stage_kv_view``), every layer of [lo, hi) held to the
    plain version; the row times layer lo."""
    from penroz_tpu_torch.ops import attention as A
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.utils import bucketing
    F = torch.nn.functional
    Hq, Hkv, D, P, BQ = (case[k] for k in ("Hq", "Hkv", "D", "P", "BQ"))
    spans = [(i, q0, n) for i, (q0, n) in enumerate(case["spans"])]
    dtype = getattr(torch, case["dtype"])
    ends = [q0 + n for _, q0, n in spans]
    pages = -(-max(ends) // P)
    shared = case.get("shared")
    k, v, table, scales = _random_pools(torch, ends, Hkv, D, P, pages,
                                        dtype, case.get("int8"), case["seed"],
                                        shared=shared)
    slice_layers = []
    if case.get("stage"):
        # a pipeline stage's view of a cache of n layers: the pools of
        # layers [lo, hi), the very tensors; the row times the first
        n, lo, hi = case["stage"]
        layers = []
        for j in range(n):
            if j == lo:
                layers.append((k, v, scales))
                continue
            k_j, v_j, _, s_j = _random_pools(
                torch, ends, Hkv, D, P, pages, dtype, case.get("int8"),
                case["seed"] + 1000 * (j + 1), shared=shared)
            layers.append((k_j, v_j, s_j))
        args = ([x[0] for x in layers], [x[1] for x in layers],
                table.cpu().numpy(), P, pages)
        kv = (KV.QuantPagedKVState(*args, [x[2]["k_scale"] for x in layers],
                                   [x[2]["v_scale"] for x in layers],
                                   device="cuda")
              if case.get("int8") else KV.PagedKVState(*args, device="cuda"))
        view = KV.stage_kv_view(kv, lo, hi)
        check(all(a is b for a, b in zip(view.k, kv.k[lo:hi]))
              and view.k[0] is k and view.block_table is kv.block_table,
              f"{case['name']}: the stage view is not the pools' own")
        table = view.block_table
        slice_layers = [(view.k[j], view.v[j],
                         {"k_scale": view.k_scale[j],
                          "v_scale": view.v_scale[j]}
                         if case.get("int8") else {})
                        for j in range(1, hi - lo)]
    need = sum(-(-n // BQ) for _, _, n in spans)
    NB = bucketing.bucket_count(need + case.get("padding", 0))
    descs_np, offsets = KV.build_descriptors(spans, BQ, NB)
    descs = torch.as_tensor(descs_np, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(case["seed"] + 1)
    q = torch.randn(1, Hq, NB * BQ, D, device="cuda", generator=g).to(dtype)
    kw = {"window": case.get("window"), "softcap": case.get("softcap")}
    if case.get("alibi"):
        kw["alibi"] = A.alibi_slopes(Hq)
    kernel = lambda: RPA.ragged_paged_attention(  # noqa: E731
        q, k, v, table, P, descs, **scales, **kw)
    plain = lambda: RPA.ragged_paged_attention_reference(  # noqa: E731
        q, k, v, table, P, descs, **scales, **kw)
    before = RPA.ragged_paged_attention.launches
    out = kernel()
    torch.cuda.synchronize()
    check(RPA.ragged_paged_attention.launches == before + 1,
          f"{case['name']}: launch not counted")
    check(torch.equal(kernel(), out),
          f"{case['name']}: two launches differ")
    check(bool(torch.isfinite(out).all()), f"{case['name']}: non-finite")
    real = torch.zeros(NB * BQ, dtype=torch.bool)
    for (_, _, n), off in zip(spans, offsets):
        real[torch.as_tensor(KV.packed_slots(off, n, BQ))] = True
    check(bool((out[0][:, ~real.cuda()] == 0).all()),
          f"{case['name']}: padding slots are not zero")
    ref = plain()
    err, ratio, text = _tolerance(
        torch, out, ref, lambda: RPA.ragged_paged_attention_reference(
            q, k, _abs(v), table, P, descs, **scales, **kw), case["dtype"])
    for k_j, v_j, s_j in slice_layers:   # the stage's other layers
        e_j, r_j, _ = _tolerance(
            torch, RPA.ragged_paged_attention(q, k_j, v_j, table, P, descs,
                                              **s_j, **kw),
            RPA.ragged_paged_attention_reference(q, k_j, v_j, table, P,
                                                 descs, **s_j, **kw),
            lambda: RPA.ragged_paged_attention_reference(
                q, k_j, _abs(v_j), table, P, descs, **s_j, **kw),
            case["dtype"])
        err, ratio = max(err, e_j), max(ratio, r_j)
    check(ratio <= 1.0, f"{case['name']}: max abs err {err:.3e}, "
          f"{ratio:.2f} x the tolerance {text}")
    iters = case.get("iters", 20)
    ms = _time_ms(torch, kernel, iters, flush)
    clean_ms = _time_ms(torch, kernel, iters, flush, clean=True)
    plain_ms = _time_ms(torch, plain, max(3, iters // 4), flush)

    library_ms = None
    if not case.get("softcap"):
        # SDPA over each descriptor block against its row's already-gathered
        # dense view (the gather left out), masks as the kernel's
        row = torch.clamp(descs[:, 0], min=0).long()
        kd, vd = (x[:, :, :max(ends)].contiguous() for x in
                  PA.dequantized_views(q, k, v, table[row], P,
                                       scales.get("k_scale"),
                                       scales.get("v_scale")))
        qd = q[0].reshape(Hq, NB, BQ, D).transpose(0, 1).contiguous()
        t = torch.arange(BQ, device="cuda")
        q_abs = descs[:, 1:2] + t[None, :]
        valid = (t[None, :] < descs[:, 2:3]) & (descs[:, 0:1] >= 0)
        key = torch.arange(max(ends), device="cuda")
        mask = (key[None, None, :] <= q_abs[:, :, None]) | ~valid[:, :, None]
        if kw["window"]:
            mask &= (key[None, None, :] > q_abs[:, :, None] - kw["window"]
                     ) | ~valid[:, :, None]
        if case.get("alibi"):
            slopes = torch.as_tensor(kw["alibi"], device="cuda")
            bias = slopes[None, :, None, None] * (
                key[None, None, None, :] - q_abs[:, None, :, None]).float()
            attn_mask = bias.masked_fill(~mask[:, None], float("-inf")
                                         ).to(dtype)
        else:
            attn_mask = mask[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd, kd, vd, attn_mask=attn_mask, enable_gqa=Hq != Hkv)
        library_ms = _time_ms(torch, sdpa, max(3, iters // 4), flush)
        del kd, vd, qd

    item = torch.empty((), dtype=dtype).element_size()
    kv_item = 1 if case.get("int8") else item
    scale_bytes = 4 if case.get("int8") else 0
    rows = _live_rows(P, [(q0, q0 + n) for _, q0, n in spans], kw["window"])
    if shared:  # a page that two rows alias is read once
        rows -= (len(shared[0]) - 1) * shared[1] * P
    pairs = 0
    for _, q0, n in spans:
        for t_ in range(n):
            pos = q0 + t_
            lo = max(0, pos - kw["window"] + 1) if kw["window"] else 0
            pairs += pos - lo + 1
    nbytes = (2 * q.numel() * item + 2 * Hkv * rows * (D * kv_item
                                                       + scale_bytes)
              + descs.numel() * 4 + table.numel() * 4)
    row = _row(case["name"], err, ratio, text, ms, plain_ms, library_ms,
               nbytes, 4 * D * pairs * Hq, PEAK_OPS_PER_S[case["dtype"]],
               clean_ms)
    plan = RPA.ragged_plan(NB, BQ, Hq, Hkv, pages, P, kw["window"],
                           DA.sm_count(q.device))
    row.update(descriptors=NB, tile_rows=plan.tile_rows,
               n_split=plan.n_split)
    return row


def paged_cases():
    gpt2 = dict(Hq=12, Hkv=12, T=1, D=64, P=128)
    qwen3 = dict(Hq=16, Hkv=8, T=1, D=128, P=128)
    spread = [1024, 700, 129, 1, 513, 900, 257, 64]
    cases = [
        dict(gpt2, name="paged_gpt2_decode_L1024", lengths=[1024],
             dtype="float32"),
        dict(gpt2, name="paged_gpt2_B8_L1024_bf16", lengths=[1024] * 8,
             dtype="bfloat16"),
        dict(gpt2, name="paged_gpt2_decode_L1024_int8", lengths=[1024],
             dtype="float32", int8=True),
        dict(name="paged_gqa32x8_D128_L1024", Hq=32, Hkv=8, T=1, D=128,
             P=128, lengths=[1024], dtype="float32"),
        dict(gpt2, name="paged_gpt2_window128_alibi", lengths=[1024],
             dtype="float32", window=128, alibi=True),
        dict(gpt2, name="paged_gpt2_softcap30", lengths=[1024],
             dtype="float32", softcap=30.0),
        dict(gpt2, name="paged_gpt2_B8_ragged_unassigned", lengths=spread,
             dtype="float32", spare_pages=2),
        # the split's edges on the pool: one key, and a ragged last split
        # over pages of 16 (granules of four pages)
        dict(gpt2, name="paged_gpt2_decode_L1", lengths=[1], dtype="float32",
             spare_pages=1),
        dict(gpt2, name="paged_gpt2_L65_P16", P=16, lengths=[65],
             dtype="float32", spare_pages=3),
        dict(name="paged_d8_gqa32x8_T4_L1024", Hq=32, Hkv=8, T=4, D=8,
             P=128, lengths=[1024], dtype="float32"),
        # the prefills of phase 4's paged requests: the 128-token prompt,
        # the overflow prompt and the re-prefill of the crop past the block
        dict(gpt2, name="paged_gpt2_prefill_T128", T=128, lengths=[128],
             dtype="float32", spare_pages=7, iters=10),
        dict(gpt2, name="paged_gpt2_prefill_T1004", T=1004, lengths=[1004],
             dtype="float32", iters=5),
        dict(gpt2, name="paged_gpt2_prefill_T1024", T=1024, lengths=[1024],
             dtype="float32", iters=5),
        # phase 4d's paged requests: a decode step at 1024 keys and the
        # 128- and 1000-token prefills, GQA 16/8, D 128, bf16
        dict(qwen3, name="paged_qwen3_decode_L1024_bf16", lengths=[1024],
             dtype="bfloat16"),
        dict(qwen3, name="paged_qwen3_prefill_T128_bf16", T=128,
             lengths=[128], dtype="bfloat16", spare_pages=7, iters=10),
        dict(qwen3, name="paged_qwen3_prefill_T1000_bf16", T=1000,
             lengths=[1000], dtype="bfloat16", iters=5),
        # phase 4e's paged decode step: MHA 16/16, D 128, bf16
        dict(qwen3, Hkv=16, name="paged_qmoe_decode_L1024_bf16",
             lengths=[1024], dtype="bfloat16"),
        # phase 4l's phased shared step over the paged pool
        dict(gpt2, name="paged_gpt2_phased_B8_17_764",
             lengths=PHASED_LENGTHS, dtype="float32"),
        dict(gpt2, name="paged_gpt2_phased_B8_17_764_int8",
             lengths=PHASED_LENGTHS, dtype="float32", int8=True),
    ]
    for i, c in enumerate(cases):
        c["seed"] = 200 + i
    return cases


def ragged_cases():
    gpt2 = dict(Hq=12, Hkv=12, D=64, P=128, BQ=8)
    # one 256-token chunk from position 0 and 7 decode rows at lengths
    # spread over 100-1000: a GPT-2 mixed step of the scheduler
    mixed = [(0, 256)] + [(n - 1, 1) for n in
                          (100, 250, 400, 550, 700, 850, 1000)]
    prefix_verify = [(512, 128), (700, 5), (300, 2), (997, 3)]
    cases = [
        dict(gpt2, name="ragged_gpt2_mixed", spans=mixed, dtype="float32"),
        dict(gpt2, name="ragged_gpt2_mixed_bf16", spans=mixed,
             dtype="bfloat16"),
        dict(gpt2, name="ragged_8x128_bf16", spans=[(896, 128)] * 8,
             dtype="bfloat16", BQ=128, iters=10),
        dict(gpt2, name="ragged_gpt2_mixed_int8", spans=mixed,
             dtype="float32", int8=True),
        dict(name="ragged_gqa32x8_D128", Hq=32, Hkv=8, D=128, P=128, BQ=8,
             spans=[(0, 64), (300, 1), (600, 1), (900, 1)],
             dtype="float32"),
        dict(gpt2, name="ragged_gpt2_window_alibi_softcap", spans=mixed,
             dtype="float32", window=128, alibi=True, softcap=30.0),
        dict(gpt2, name="ragged_gpt2_padding", spans=[(99, 1), (499, 1),
                                                      (9, 3)],
             dtype="float32", padding=10),
        # seven decode rows at 1-1024 keys beside a 64-token chunk: the
        # splits of the longest range, and of ranges shorter than a split
        dict(gpt2, name="ragged_gpt2_spread_1_1024",
             spans=[(0, 64)] + [(n - 1, 1) for n in
                                (1, 65, 200, 513, 700, 1000, 1024)],
             dtype="float32"),
        # more splits (16) than head dims (8), GQA 4:1, two 8-row tiles
        dict(name="ragged_d8_gqa_16_splits", Hq=32, Hkv=8, D=8, P=128,
             BQ=4, spans=[(1021, 3)], dtype="float32"),
        # phase 4d's mixed step: a 256-token chunk of the 900-token prompt
        # beside three decode rows, GQA 16/8, D 128, bf16
        dict(name="ragged_qwen3_mixed_bf16", Hq=16, Hkv=8, D=128, P=128,
             BQ=8, spans=[(512, 256), (215, 1), (515, 1), (963, 1)],
             dtype="bfloat16"),
        # the same mixed step at phase 4e's MHA 16/16
        dict(name="ragged_qmoe_mixed_bf16", Hq=16, Hkv=16, D=128, P=128,
             BQ=8, spans=[(512, 256), (215, 1), (515, 1), (963, 1)],
             dtype="bfloat16"),
        # phase 4f's traffic: a prefix hit's 128-token suffix chunk from
        # position 512 and a 5-row verify span, both rows aliasing the same
        # 4 pages of the pool's tail (positions 0-511), beside verify spans
        # of 2 and 3 rows
        dict(gpt2, name="ragged_gpt2_prefix_verify", spans=prefix_verify,
             shared=((0, 1), 4), dtype="float32"),
        dict(gpt2, name="ragged_gpt2_prefix_verify_int8",
             spans=prefix_verify, shared=((0, 1), 4), dtype="float32",
             int8=True),
        # phase 4l's pipeline stage: the mixed step against a stage's view
        # of the pools (the second of two stages, layers [2, 4) of
        # SERVE_DEPTH, stage_kv_view), every layer of the slice held to
        # the plain version, fp32 and int8
        dict(gpt2, name="ragged_gpt2_stage_slice_2_4", spans=mixed,
             dtype="float32", stage=(SERVE_DEPTH, 2, 4)),
        dict(gpt2, name="ragged_gpt2_stage_slice_2_4_int8", spans=mixed,
             dtype="float32", int8=True, stage=(SERVE_DEPTH, 2, 4)),
    ]
    for i, c in enumerate(cases):
        c["seed"] = 300 + i
    return cases


def run_gla_case(torch, case, flush):
    """The chunked GLA kernel against its plain version (and, where
    ``sequential``, against the token-sequential oracle); one row.  No
    single PyTorch call computes this function: library_ms is null."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_scan as SS
    B, T, H, dk, dv = (case[k] for k in ("B", "T", "H", "dk", "dv"))
    dtype = getattr(torch, case["dtype"])
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    q = (torch.randn(B, T, H, dk, device="cuda", generator=g)
         * dk ** -0.5).to(dtype)
    k = torch.randn(B, T, H, dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(B, T, H, dv, device="cuda", generator=g).to(dtype)
    logits = torch.randn(B, T, H, device="cuda", generator=g)
    if case.get("below_floor"):  # sigmoid(-20) ~ 2e-9 < the 1e-6 floor
        low = torch.rand(B, T, H, device="cuda", generator=g) < 0.1
        logits = torch.where(low, -20.0, logits)
    gates = torch.sigmoid(logits)
    kernel = lambda: SS.gla_chunked(q, k, v, gates)  # noqa: E731
    plain = lambda: SS.gla_chunked_reference(q, k, v, gates)  # noqa: E731
    before = SS.gla_chunked.launches
    out = kernel()
    torch.cuda.synchronize()
    check(SS.gla_chunked.launches == before + 1,
          f"{case['name']}: launch not counted")
    check(torch.equal(kernel(), out), f"{case['name']}: two launches differ")
    check(bool(torch.isfinite(out).all()), f"{case['name']}: non-finite")
    ref = plain()
    terms = SS.gla_chunked_reference(q.abs(), k.abs(), v.abs(), gates)
    diff = (out - ref).abs()
    err = float(diff.max())
    ratio = float((diff / (GLA_C * (terms + ref.abs())).clamp_min(1e-30)
                   ).max())
    tol_text = f"{GLA_C:g} * (sum|terms| + |ref|)"
    check(ratio <= 1.0, f"{case['name']}: max abs err {err:.3e}, "
          f"{ratio:.2f} x the tolerance {tol_text}")
    seq_ratio = None
    if case.get("sequential"):
        seq = SSM.gla_full_reference(q, k, v, gates)
        seq_ratio = float(((out - seq).abs() / (
            GLA_SEQ_C * (terms + seq.abs())).clamp_min(1e-30)).max())
        check(seq_ratio <= 1.0, f"{case['name']}: {seq_ratio:.2f} x the "
              f"tolerance {GLA_SEQ_C:g} * (sum|terms| + |seq|) against the "
              f"sequential oracle")
        del seq
    del ref, terms, diff
    iters = case.get("iters", 10)
    ms = _time_ms(torch, kernel, iters, flush)
    plain_ms = _time_ms(torch, plain, 3, flush)
    # bytes: q, k, v read once, the fp32 gates read once, the fp32 output
    # written once.  operations: the least any implementation does, the
    # token-sequential recurrence (S update and q . S, 2 dk dv FMAs a token
    # and head); all of it fp32 math whatever the input type.  The chunked
    # algebra's count (causal halves of the scores) and the Pallas
    # CostEstimate's (full block_t x block_t tiles) are kept beside it.
    # The kernel's products run on tensor cores (3xTF32; a bf16 operand is
    # exact in one TF32 pass), so where it beats the fp32 FMA rate the
    # operations bound is restated at the tensor-core peak of the inputs'
    # type: 3xTF32 (495 / 3 TFLOP/s) for fp32, bf16 (989) for bf16.
    item = torch.empty((), dtype=dtype).element_size()
    rows = B * T * H
    nbytes = rows * ((2 * dk + dv) * item + 4 + 4 * dv)
    ops = 4 * rows * dk * dv
    L = SS.chunk_length(T)
    chunks = B * H * (-(-T // L))
    peak, peak_name = PEAK_OPS_PER_S["float32"], "fp32 FMA, 67 TFLOP/s"
    if ms < ops / peak * 1e3:
        peak, peak_name = GLA_TENSOR_PEAK[case["dtype"]]
    row = _row(case["name"], err, ratio, tol_text, ms, plain_ms, None,
               nbytes, ops, peak)
    row.update(
        ops_peak=peak_name,
        sequential_err_over_tol=seq_ratio,
        chunked_ops=chunks * (L * (L + 1) * (dk + dv) + 4 * L * dk * dv),
        pallas_ops=4 * chunks * L * L * (dk + dv))
    row["chunked_bound_ms"] = row["chunked_ops"] / PEAK_OPS_PER_S[
        "float32"] * 1e3
    row["pallas_bound_ms"] = row["pallas_ops"] / PEAK_OPS_PER_S[
        "float32"] * 1e3
    if seq_ratio is not None:
        say("kernels", f"{case['name']}: against the sequential oracle "
            f"{seq_ratio:.3f} x {GLA_SEQ_C:g} * (sum|terms| + |seq|)")
    return row


def gla_cases():
    gpt2 = dict(H=12, dk=64, dv=64)
    cases = [
        # /evaluate/'s shape (phase 4c) and /output/'s
        dict(gpt2, name="gla_gpt2_B8_T1024_fp32", B=8, T=1024,
             dtype="float32", sequential=True),
        dict(gpt2, name="gla_gpt2_B1_T1024_fp32", B=1, T=1024,
             dtype="float32", sequential=True),
        dict(gpt2, name="gla_gpt2_B8_T1000_fp32", B=8, T=1000,
             dtype="float32"),
        dict(gpt2, name="gla_gpt2_B8_T1024_bf16", B=8, T=1024,
             dtype="bfloat16"),
        dict(gpt2, name="gla_gpt2_B8_T1024_below_floor", B=8, T=1024,
             dtype="float32", below_floor=True),
        dict(name="gla_H32_D128_B2_T1024_fp32", B=2, T=1024, H=32, dk=128,
             dv=128, dtype="float32"),
        # many tiles of one sequence: the carry's chain of checkpoints
        dict(gpt2, name="gla_gpt2_B1_T4096_fp32", B=1, T=4096,
             dtype="float32", sequential=True),
    ]
    for i, c in enumerate(cases):
        c["seed"] = 400 + i
    return cases


# The recurrent update against its plain versions: fp32 state math in both,
# the state rounded as the same products and sums, so the state, the ring
# and its keys equal the plain ones bit for bit; y summed over dk in
# another order than the plain einsum, so |y - ref| <= SSM_C x
# (sum_k |q_k| |S_kc| + |ref|).
SSM_C = 1e-5
SSM_RING = 8


def _ssm_operands(torch, case):
    """Inputs, descriptors and a seeded starting state (live states and a
    ring keyed below each row's start) of one ssm_update case."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    H, dk, dv, B = case["H"], case["dk"], case["dv"], case["B"]
    g = torch.Generator(device="cuda").manual_seed(case["seed"])
    dtype = getattr(torch, case["dtype"])
    if case["form"] == "packed":
        descs, _ = build_descriptors(case["spans"], case["block_q"],
                                     case["blocks"])
        lead = (1, case["blocks"] * case["block_q"])
        starts = {row: s for row, s, _ in case["spans"]}
    else:
        descs = None
        lead = (B, case["T"])
        starts = dict(enumerate(case["starts"]))
    q = (torch.randn(*lead, H, dk, device="cuda", generator=g)
         * dk ** -0.5).to(dtype)
    k = torch.randn(*lead, H, dk, device="cuda", generator=g).to(dtype)
    v = torch.randn(*lead, H, dv, device="cuda", generator=g).to(dtype)
    gates = torch.sigmoid(torch.randn(*lead, H, device="cuda", generator=g)
                          + 2.0)
    state = SSM.SSMState.create([(H, dk, dv)], B, ckpt_slots=SSM_RING,
                                device="cuda")
    state.state[0].normal_(generator=g)
    state.ckpt[0].normal_(generator=g)
    pos = torch.full((B, SSM_RING), -1, dtype=torch.int32)
    for row, s in starts.items():
        for L in range(max(1, s - SSM_RING + 2), s + 1):
            pos[row, L % SSM_RING] = L
    state.ckpt_pos.copy_(pos)
    counts = (torch.tensor(case["counts"], device="cuda")
              if case.get("counts") is not None else None)
    start_t = torch.tensor([starts.get(b, 0) for b in range(B)],
                           device="cuda")
    return (state, q, k, v, gates,
            torch.from_numpy(descs).cuda() if descs is not None else None,
            start_t, counts)


def _ssm_copy(state):
    from penroz_tpu_torch.ops import ssm as SSM
    return SSM.SSMState([s.clone() for s in state.state],
                        [c.clone() for c in state.ckpt],
                        state.ckpt_pos.clone(), state.specs,
                        state.ckpt_slots)


def run_ssm_update_case(torch, case):
    """The recurrent-update kernel against its plain version (dense or
    packed): y, the state, the ring and its keys; launched twice from the
    same starting state, bit for bit; one row.  No PyTorch call computes
    this function: library_ms is null."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    state0, q, k, v, gates, descs, starts, counts = _ssm_operands(torch,
                                                                  case)
    packed = descs is not None

    def kernel(st):
        if packed:
            return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q, k,
                                 v, gates, descs=descs,
                                 block_q=case["block_q"])
        return SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, q, k, v,
                             gates, starts=starts, counts=counts)

    def plain(st):
        if packed:
            return SSM.update_packed_reference(
                st.state[0], st.ckpt[0], st.ckpt_pos, q, k, v, gates,
                descs, case["block_q"])
        return SSM.update_dense_reference(
            st.state[0], st.ckpt[0], st.ckpt_pos, q, k, v, gates, starts,
            counts)

    before = SU.ssm_update.launches
    one, two, ref = _ssm_copy(state0), _ssm_copy(state0), _ssm_copy(state0)
    y1 = kernel(one)
    y2 = kernel(two)
    torch.cuda.synchronize()
    check(SU.ssm_update.launches == before + 2,
          f"{case['name']}: launches not counted")
    for a, b in ((y1, y2), (one.state[0], two.state[0]),
                 (one.ckpt[0], two.ckpt[0]), (one.ckpt_pos, two.ckpt_pos)):
        check(torch.equal(a, b), f"{case['name']}: two launches differ")
    check(bool(torch.isfinite(y1).all()), f"{case['name']}: non-finite")
    y_ref = plain(ref)
    check(torch.equal(one.ckpt_pos, ref.ckpt_pos),
          f"{case['name']}: ring keys differ from the plain version's")
    # the dot's terms: |q| . |S_t| by the plain version on |q| and |S|
    mag = _ssm_copy(state0)
    mag.state[0].abs_()
    if packed:
        terms = SSM.update_packed_reference(
            mag.state[0], mag.ckpt[0], mag.ckpt_pos, q.abs(), k.abs(),
            v.abs(), gates, descs, case["block_q"])
    else:
        terms = SSM.update_dense_reference(
            mag.state[0], mag.ckpt[0], mag.ckpt_pos, q.abs(), k.abs(),
            v.abs(), gates, starts, counts)
    diff = (y1 - y_ref).abs()
    err = float(diff.max())
    ratio = float((diff / (SSM_C * (terms + y_ref.abs())).clamp_min(1e-30)
                   ).max())
    s_err = max(float((a - b).abs().max()) for a, b in (
        (one.state[0], ref.state[0]), (one.ckpt[0], ref.ckpt[0])))
    tol_text = f"{SSM_C:g} * (sum|q||S| + |ref|)"
    check(ratio <= 1.0, f"{case['name']}: y max abs err {err:.3e}, "
          f"{ratio:.2f} x {tol_text}")
    check(torch.equal(one.state[0], ref.state[0])
          and torch.equal(one.ckpt[0], ref.ckpt[0]),
          f"{case['name']}: state/ring differ from the plain version's "
          f"(max abs err {s_err:.3e})")
    del terms, diff, mag, two
    ms = _time_ms(torch, lambda: kernel(one), case.get("iters", 20),
                  case["flush"])
    plain_ms = _time_ms(torch, lambda: plain(ref), 2, case["flush"])
    # bytes: the valid tokens' q, k, v (input type) and fp32 gates read
    # once, their y written once (fp32), each touched row's state read and
    # written once, min(C, n) ring slots written a row, fp32.  operations:
    # 2 dk dv multiply-adds a token and head (the update and q . S), fp32.
    item = torch.empty((), dtype=q.dtype).element_size()
    H, dk, dv = case["H"], case["dk"], case["dv"]
    if packed:
        per_row = {}
        for row, _, n in case["spans"]:
            per_row[row] = per_row.get(row, 0) + n
    else:
        cnt = case.get("counts") or [case["T"]] * case["B"]
        per_row = {b: n for b, n in enumerate(cnt) if n}
    tokens = sum(per_row.values())
    plane = H * dk * dv * 4
    nbytes = (tokens * H * ((2 * dk + dv) * item + 4 + 4 * dv)
              + sum(2 * plane + min(SSM_RING, n) * plane
                    for n in per_row.values()))
    ops = 4 * tokens * H * dk * dv
    row = _row(case["name"], err, ratio, tol_text, ms, plain_ms, None,
               nbytes, ops, PEAK_OPS_PER_S["float32"])
    row.update(state_err=s_err, tokens=tokens, rows=len(per_row),
               form=case["form"])
    return row


def run_ssm_cut_case(torch, case):
    """One row's span through the recurrent-update kernel as 1 launch, as
    launches of 64 slots and of 1: the state, the ring, its keys and every
    slot's y bit for bit (the engine's superstep and chunk gates rest on
    it).  Returns a row without times."""
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    state0, q, k, v, gates, _, starts, _ = _ssm_operands(torch, case)
    T = case["T"]
    results = {}
    for cut in (T, 64, 1):
        st = _ssm_copy(state0)
        ys = [SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos,
                            q[:, t:t + cut], k[:, t:t + cut],
                            v[:, t:t + cut], gates[:, t:t + cut],
                            starts=starts + t)
              for t in range(0, T, cut)]
        torch.cuda.synchronize()
        results[cut] = (torch.cat(ys, dim=1), st)
    y, one = results[T]
    for cut in (64, 1):
        y_cut, st = results[cut]
        check(torch.equal(y_cut, y) and torch.equal(st.state[0], one.state[0])
              and torch.equal(st.ckpt[0], one.ckpt[0])
              and torch.equal(st.ckpt_pos, one.ckpt_pos),
              f"{case['name']}: {T // cut} launches of {cut} differ from 1 "
              f"launch of {T}")
    say("kernels", f"{case['name']}: 1 launch of {T}, {T // 64} of 64 and "
        f"{T} of 1 agree bit for bit (y, state, ring, keys)")
    return {"name": case["name"], "bit_equal": True,
            "launches": 1 + T // 64 + T}


def ssm_update_cases():
    """Phase 4c's widths (H 12, dk = dv = 64): a decode step of 8 rows (one
    parked, count 0), a 256-token chunk beside 7 decode rows and a padding
    block (phase 4m's mixed step), a 1024-token single-row prefill; fp32
    and from bf16 inputs; the mixed step at dk = dv = 128 (H 6, the same
    width)."""
    gpt2 = dict(H=12, dk=64, dv=64)
    decode_starts = list(PHASED_LENGTHS)
    mixed = dict(gpt2, form="packed", B=8, block_q=64, blocks=12,
                 spans=[(0, 300, 256)] + [(r, 100 + 37 * r, 1)
                                          for r in range(1, 8)])
    cases = [
        dict(gpt2, name="ssm_decode_B8_fp32", form="dense", B=8, T=1,
             starts=decode_starts, counts=[1, 1, 1, 0, 1, 1, 1, 1],
             dtype="float32"),
        dict(mixed, name="ssm_mixed_256_7_fp32", dtype="float32"),
        dict(mixed, name="ssm_mixed_256_7_bf16", dtype="bfloat16"),
        dict(gpt2, name="ssm_prefill_1024_fp32", form="dense", B=1, T=1024,
             starts=[0], dtype="float32", iters=5),
        dict(gpt2, name="ssm_prefill_1024_bf16", form="dense", B=1, T=1024,
             starts=[0], dtype="bfloat16", iters=5),
        dict(mixed, name="ssm_mixed_256_7_d128_fp32", H=6, dk=128, dv=128,
             dtype="float32"),
    ]
    for i, c in enumerate(cases):
        c["seed"] = 500 + i
    return cases


def ssm_cut_case():
    """Phase 3's cut case: the mixed step's 256-slot row alone, dense."""
    return dict(name="ssm_cut_256_fp32", H=12, dk=64, dv=64, form="dense",
                B=1, T=256, starts=[300], dtype="float32", seed=520)


def training_cases():
    # phase 5's micro-step: TRAIN_BATCH x TRAIN_BLOCK
    gpt2 = dict(B=TRAIN_BATCH, Hq=12, Hkv=12, T=TRAIN_BLOCK, D=64)
    cases = [dict(gpt2, name="flash_gpt2_B4_T1024_bf16", dtype="bfloat16"),
             dict(gpt2, name="flash_gpt2_B4_T1024_fp32", dtype="float32"),
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
    # the Hopper kernels' mask (window edge, ALiBi) and ragged-edge paths
    edges = [dict(name="flash_window128_alibi_T1024_bf16", B=1, Hq=12,
                  Hkv=12, T=1024, D=64, dtype="bfloat16", window=128,
                  alibi=True, seed=200),
             dict(gpt2, name="flash_gpt2_B4_T1000_bf16", T=1000,
                  dtype="bfloat16", seed=201),
             # phase 4d's /output/ at 1 x 1024: GQA 16/8, D 128, bf16
             dict(name="flash_qwen3_T1024_bf16", B=1, Hq=16, Hkv=8, T=1024,
                  D=128, dtype="bfloat16", seed=202),
             # phase 4e's /output/ at 1 x 1024: MHA 16/16, D 128, bf16
             dict(name="flash_qmoe_T1024_bf16", B=1, Hq=16, Hkv=16, T=1024,
                  D=128, dtype="bfloat16", seed=203)]
    ce = [dict(name="ce_gpt2_N4096_V50304_bf16", N=4096, V=50304,
               dtype="bfloat16"),
          dict(name="ce_gpt2_N4096_V50304_fp32", N=4096, V=50304,
               dtype="float32"),
          dict(name="ce_tail_N300_V2563_fp32", N=300, V=2563,
               dtype="float32")]
    for i, c in enumerate(cases + ce):
        c["seed"] = 100 + i
    return cases + edges, ce


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


def phase_kernels(torch, builds, ragged=False):
    """Phase 3's cases: each source's as soon as it is built, the fastest
    builds first; ``ragged``: the ragged kernel's alone (its source builds
    longest, so main() runs them after phase 4, which does not launch
    it).  Returns {case name: row}."""
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    rows = {}
    if ragged:
        builds.wait("ragged_paged_attention")
        for case in ragged_cases():
            rows[case["name"]] = run_ragged_case(torch, case, flush)
            torch.cuda.empty_cache()
        builds.wait()
    else:
        flash, ce = training_cases()
        builds.wait("cross_entropy")
        for case in ce:
            for row in run_ce_case(torch, case, flush):
                rows[row["name"]] = row
            torch.cuda.empty_cache()
        builds.wait("ssm_update")
        for case in ssm_update_cases():
            rows[case["name"]] = run_ssm_update_case(torch, dict(
                case, flush=flush))
            torch.cuda.empty_cache()
        cut = ssm_cut_case()
        rows[cut["name"]] = run_ssm_cut_case(torch, cut)
        builds.wait("ssm_scan")
        for case in gla_cases():
            rows[case["name"]] = run_gla_case(torch, case, flush)
            torch.cuda.empty_cache()
        builds.wait("flash_attention")
        for case in flash:
            for row in run_flash_case(torch, case, flush):
                rows[row["name"]] = row
            torch.cuda.empty_cache()
        builds.wait("decode_attention")
        rows.update((c["name"], run_case(torch, c, flush))
                    for c in kernel_cases())
        builds.wait("paged_attention")
        for case in paged_cases():
            rows[case["name"]] = run_paged_case(torch, case, flush)
            torch.cuda.empty_cache()
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


class _StepLedger:
    """Dispatched decode steps (prefills, replayed and eager steps, capture
    warm-ups, overshoot included) and the replayed ones among them, by the
    kernel they launch: the paged one under PAGED_KV_CACHE=1, else the
    contiguous one.  ``with ledger.request():`` around each request."""

    def __init__(self):
        self.steps = {"decode_attention": 0, "paged_decode_attention": 0}
        self.replayed = dict.fromkeys(self.steps, 0)

    @contextlib.contextmanager
    def request(self):
        from penroz_tpu_torch.models import decode_graphs as DG
        kernel = ("paged_decode_attention"
                  if os.environ.get("PAGED_KV_CACHE") == "1"
                  else "decode_attention")
        before = DG.dispatched_steps(), DG.STATS["replayed_steps"]
        try:
            yield
        finally:
            self.steps[kernel] += DG.dispatched_steps() - before[0]
            self.replayed[kernel] += DG.STATS["replayed_steps"] - before[1]


def _runner_stats():
    """A copy of the runners' counts (models/decode_graphs.py STATS)."""
    from penroz_tpu_torch.models import decode_graphs as DG
    return {k: list(v) if isinstance(v, list) else v
            for k, v in DG.STATS.items()}


def _decode_counters():
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    return {"decode_attention": DA.decode_attention,
            "paged_decode_attention": PA.paged_decode_attention}


def _zero_decode_counts():
    """Zero the decode wrappers' launch counts and their kernels' device
    run counters."""
    for fn in _decode_counters().values():
        fn.launches = 0
        fn.runs.reset()


def _check_launches(n_attn, ledger, what):
    """Since the counts were zeroed: the device ran each kernel once per
    attention layer in every dispatched step, replays included (the
    kernel's own run counter), and the wrapper launched it once per
    attention layer in every step that was not a replay; no other
    single-sequence kernel ran.  Returns (wrapper launches, device runs)
    by wrapper name."""
    fns = _decode_counters()
    launches = {name: fn.launches for name, fn in fns.items()}
    ran = {name: fn.runs.read() for name, fn in fns.items()}
    for name, steps in ledger.steps.items():
        eager = steps - ledger.replayed[name]
        check(ran[name] == n_attn * steps,
              f"{what}: the device ran {name}'s kernel {ran[name]} times, "
              f"expected {n_attn} x {steps} dispatched steps")
        check(launches[name] == n_attn * eager,
              f"{what}: {name} launched {launches[name]} times, expected "
              f"{n_attn} x {eager} dispatched steps that were not replays")
    return launches, ran


@contextlib.contextmanager
def _graphs(on):
    """Decode steps on the card replay captured graphs (on) or run the
    eager step (off), in this process."""
    from penroz_tpu_torch.models import decode_graphs as DG
    saved, DG._GRAPHS = DG._GRAPHS, on
    try:
        yield
    finally:
        DG._GRAPHS = saved


def _decode_timing(torch, model, prompt, block, graphs):
    """``generate_tokens`` of PROMPT_LEN + NEW_TOKENS greedy with the model
    loaded and its runner warm, graphs on or off:
    the median of three host-clock runs (each ending in a synchronize) and
    of three prefill-only runs (one new token), then one run under
    torch.profiler: device busy ms and share, device kernels a generated
    token, and the device's idle time split into gaps of at most
    GAP_SHORT_US between kernels (launch gaps, inside a graph or of
    launches queued ahead) and longer ones (the device waiting for the
    host)."""
    from torch.profiler import ProfilerActivity, profile

    def median_s(new):
        walls = []
        for _ in range(3):
            t0 = time.monotonic()
            model.generate_tokens([prompt], block, new, temperature=0)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
        return sorted(walls)[1], walls

    with _graphs(graphs):
        out = model.generate_tokens([prompt], block, NEW_TOKENS,
                                    temperature=0)
        torch.cuda.synchronize()
        wall, walls = median_s(NEW_TOKENS)
        prefill, _ = median_s(1)
        # device activity only: the host ops' events add nothing read here
        # and take seconds to parse at an eager run's count
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            model.generate_tokens([prompt], block, NEW_TOKENS, temperature=0)
            torch.cuda.synchronize()
            traced = time.monotonic() - t0
    kernels = [evt for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(evt, "is_user_annotation", False)
               and "#" not in evt.name
               and not evt.name.startswith(("Memcpy", "Memset"))]
    device_ms = sum(evt.time_range.elapsed_us() for evt in kernels) / 1e3
    gaps, end = [], None
    for start, stop in sorted((evt.time_range.start, evt.time_range.end)
                              for evt in kernels):
        if end is not None and start > end:
            gaps.append(start - end)
        end = stop if end is None else max(end, stop)
    short = [g for g in gaps if g <= GAP_SHORT_US]
    return out, {"s": wall, "walls_s": walls,
                 "tokens_per_s": NEW_TOKENS / wall, "prefill_s": prefill,
                 "traced_wall_ms": traced * 1e3,
                 "device_busy_ms": device_ms,
                 "device_busy_share": device_ms / (traced * 1e3),
                 "kernels_per_token": len(kernels) / NEW_TOKENS,
                 "idle_short_gaps_ms": sum(short) / 1e3,
                 "short_gaps": len(short),
                 "idle_long_gaps_ms": (sum(gaps) - sum(short)) / 1e3,
                 "long_gaps": len(gaps) - len(short)}


def _trace_text(t):
    return (f"device busy {t['device_busy_ms']:.2f} ms of "
            f"{t['traced_wall_ms']:.2f} ms ({t['device_busy_share']:.1%}), "
            f"idle {t['idle_short_gaps_ms']:.2f} ms in {t['short_gaps']} "
            f"gaps <= {GAP_SHORT_US:.0f} us and "
            f"{t['idle_long_gaps_ms']:.2f} ms in {t['long_gaps']} longer; "
            f"{t['kernels_per_token']:.1f} kernels a token")


def phase_main_path(torch, device, layers, optimizer, block, vocab, card):
    """Drive the port's server; returns (stats dict, launch counts)."""
    from penroz_tpu_torch.models import decode_graphs as DG
    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    ledger = _StepLedger()
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
        DG.reset()
        _zero_decode_counts()
        generated = 0
        http = _StepLedger()
        with http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200, f"/generate/ -> {status}: {text[:300]}")
        first = json.loads(text)["tokens"]
        generated += len(first) - PROMPT_LEN
        check(len(first) == PROMPT_LEN + NEW_TOKENS
              and first[:PROMPT_LEN] == prompt
              and all(0 <= t < vocab for t in first),
              "greedy output malformed")
        # one prefill, then one 128-step chunk (127 kept), after the
        # capture's warm-up steps
        check(DG.STATS["captures"] == 1 and http.steps[
            "decode_attention"] == 1 + NEW_TOKENS + DG.WARMUP_STEPS,
              f"first request: {DG.STATS}, {http.steps}")
        stats.update(greedy_request_s=secs,
                     first_request_capture_s=DG.STATS["capture_s"][0])
        before = http.steps["decode_attention"]
        with http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200 and json.loads(text)["tokens"] == first,
              "greedy /generate/ not deterministic")
        check(DG.STATS["captures"] == 1, "the second request on the "
              "same key captured again")
        check(http.steps["decode_attention"] - before == 1 + NEW_TOKENS,
              "the second request did not dispatch 1 prefill + one "
              f"{NEW_TOKENS}-step chunk")
        generated += NEW_TOKENS
        stats["greedy_request_s_2"] = secs
        say("main_path", f"greedy {PROMPT_LEN}+{NEW_TOKENS}: identical "
            f"twice, {stats['greedy_request_s']:.3f} s (capture "
            f"{stats['first_request_capture_s']:.3f} s of it) / "
            f"{secs:.3f} s (nothing captured) per request (checkpoint "
            f"load included); 1 prefill + one {NEW_TOKENS}-step chunk "
            f"each, on {card}")

        with http.request():
            streamed, ttft, secs = _stream(base, greedy)
        check(streamed == first[PROMPT_LEN:], "stream != non-stream")
        generated += len(streamed)
        stats.update(stream_first_token_s=ttft, stream_request_s=secs)
        say("main_path", f"stream == non-stream; first token "
            f"{ttft:.3f} s, all {secs:.3f} s")

        over = dict(greedy, input=[long_prompt],
                    max_new_tokens=OVERFLOW_NEW)
        with http.request():
            status, text, secs = _post(base, "/generate/", over)
        tokens = json.loads(text)["tokens"] if status == 200 else []
        check(status == 200
              and len(tokens) == len(long_prompt) + OVERFLOW_NEW,
              f"overflow /generate/ -> {status}: {text[:300]}")
        generated += OVERFLOW_NEW
        stats["overflow_request_s"] = secs
        say("main_path", f"overflow {len(long_prompt)}+{OVERFLOW_NEW} "
            f"past block {block}: chunks of 16 and 4 (the room left), "
            f"then a re-prefill a token, ok in {secs:.3f} s")

        with _env({"TURBO_QUANT_KV_CACHE": "1"}), http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200, f"int8 /generate/ -> {status}: {text[:300]}")
        int8 = json.loads(text)["tokens"]
        check(len(int8) == len(first)
              and all(0 <= t < vocab for t in int8),
              "int8 output malformed")
        generated += NEW_TOKENS
        agree = sum(a == b for a, b in zip(int8[PROMPT_LEN:],
                                           first[PROMPT_LEN:]))
        stats["int8_request_s"] = secs
        say("main_path", f"TURBO_QUANT_KV_CACHE=1: ok in {secs:.3f} s, "
            f"{agree}/{NEW_TOKENS} tokens equal to the fp32 cache's")
        wrapper, ran = _check_launches(n_attn, http,
                                       "HTTP, contiguous caches")
        da_launches = ran["decode_attention"]
        say("main_path", f"HTTP requests: the device ran the decode kernel "
            f"{da_launches} times (its run counter), {n_attn} a dispatched "
            f"step {http.steps}, {http.replayed} of them replays; the "
            f"wrapper launched it {wrapper['decode_attention']} times, "
            f"{n_attn} a step that was not a replay")

        _zero_decode_counts()

        # in process, the checkpoint loaded once: graph path == HTTP, the
        # eager step loop == the graph path on each cache; decode rates
        t0 = time.monotonic()
        model = NeuralNetworkModel.deserialize("smoke", device=device,
                                               optimizer=False)
        torch.cuda.synchronize()
        stats["checkpoint_load_s"] = time.monotonic() - t0
        for name, env, body, want in (
                ("contiguous", {}, greedy, first),
                ("overflow", {}, over, tokens),
                ("int8", {"TURBO_QUANT_KV_CACHE": "1"}, greedy, int8)):
            for graphs in (True, False):
                with _env(env), _graphs(graphs), ledger.request():
                    got = model.generate_tokens(
                        body["input"], block, body["max_new_tokens"],
                        temperature=0)
                check(got == want, f"{name}: generate_tokens with graphs "
                      f"{'on' if graphs else 'off'} != the HTTP graph "
                      f"path's tokens")
                generated += body["max_new_tokens"]
        timing = {}
        for mode, graphs in (("graph", True), ("eager", False)):
            with ledger.request():
                out, timing[mode] = _decode_timing(torch, model, prompt,
                                                   block, graphs)
            check(out == first, f"{mode} timing run != the HTTP tokens")
            generated += 5 * NEW_TOKENS + 3
        stats["decode"] = timing
        stats["tokens_per_s"] = timing["graph"]["tokens_per_s"]
        stats["eager_tokens_per_s"] = timing["eager"]["tokens_per_s"]
        for mode in ("graph", "eager"):
            t = timing[mode]
            say("main_path", f"generate_tokens {PROMPT_LEN}+{NEW_TOKENS} "
                f"{mode}: {t['s']:.4f} s = {t['tokens_per_s']:.1f} tokens/s "
                f"(median of 3; prefill alone {t['prefill_s']:.4f} s); "
                f"traced: {_trace_text(t)}, on {card}")
        say("main_path", "graph path == eager step loop on the contiguous "
            "fp32, overflow and int8 caches (in process, exact tokens)")
        _check_launches(n_attn, ledger, "in process, contiguous caches")

        paged_stats, paged_launches = _paged_single_sequence(
            torch, base, model, greedy, over, first, tokens, int8, n_attn,
            card)
        stats.update(paged_stats)
        launches = {"decode_attention": da_launches,
                    "paged_decode_attention": paged_launches}
        stats["dispatched_steps"] = {"http": dict(http.steps),
                                     "http_replayed": dict(http.replayed),
                                     "in_process": dict(ledger.steps)}
        stats["runner_stats"] = _runner_stats()
        stats["split_plan"] = _split_plan_cost(torch)

        status, text, _ = _post(base, "/decode/", {"encoding": "byte",
                                                  "tokens": first})
        check(status == 200 and "text" in json.loads(text), "/decode/ failed")
        stats["idle_runner_bytes"] = [r.nbytes for r in DG._IDLE.values()]
        status, _, _ = _post(base, "/model/?model_id=smoke", None,
                             method="DELETE")
        check(status == 204, f"DELETE /model/ -> {status}")
        check(not DG._IDLE, "DELETE /model/ left idle decode runners")
        status, _, _ = _post(base, "/generate/", greedy)
        check(status == 404, f"/generate/ after DELETE -> {status}")
        stats["generated_tokens"] = generated
        say("main_path", f"/decode/ 200, DELETE 204 (dropped "
            f"{len(stats['idle_runner_bytes'])} idle runners of "
            f"{stats['idle_runner_bytes']} bytes), then 404; the HTTP "
            f"requests ran the decode kernels {launches} times on the "
            f"device ({generated} tokens kept in the phase)")

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
        DG.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


def _paged_single_sequence(torch, base, model, greedy, over, first,
                           over_tokens, int8_tokens, n_attn, card):
    """Phase 4's requests again under PAGED_KV_CACHE=1 (fp32, past the
    block, int8 with TURBO_QUANT_KV_CACHE=1): the same greedy tokens as
    the contiguous cache's, through the paged kernel, which the device
    runs 12 times a dispatched step (a profiler trace of the HTTP
    requests); in process, the eager step loop's tokens equal the graph
    path's.  The counts are reset just before and read just after.
    Returns (stats, the paged kernel's runs in the HTTP requests)."""
    stats = {}
    http, ledger = _StepLedger(), _StepLedger()
    _zero_decode_counts()
    with _env({"PAGED_KV_CACHE": "1"}):
        with http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200 and json.loads(text)["tokens"] == first,
              f"paged /generate/ -> {status}: tokens differ from the "
              f"contiguous cache's")
        stats["paged_request_s"] = secs
        with http.request():
            status, text, secs = _post(base, "/generate/", over)
        check(status == 200
              and json.loads(text)["tokens"] == over_tokens,
              f"paged overflow /generate/ -> {status}: tokens differ "
              f"from the contiguous cache's")
        stats["paged_overflow_request_s"] = secs
        with _env({"TURBO_QUANT_KV_CACHE": "1"}), http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200
              and json.loads(text)["tokens"] == int8_tokens,
              f"int8 paged /generate/ -> {status}: tokens differ from "
              f"the contiguous int8 cache's")
        stats["paged_int8_request_s"] = secs
        wrapper, ran = _check_launches(n_attn, http, "HTTP, paged pool")
        launches = ran["paged_decode_attention"]
        _zero_decode_counts()
        for name, env, body, want in (
                ("paged", {}, greedy, first),
                ("paged overflow", {}, over, over_tokens),
                ("int8 paged", {"TURBO_QUANT_KV_CACHE": "1"}, greedy,
                 int8_tokens)):
            for graphs in (True, False):
                with _env(env), _graphs(graphs), ledger.request():
                    got = model.generate_tokens(
                        body["input"], body["block_size"],
                        body["max_new_tokens"], temperature=0)
                check(got == want, f"{name}: generate_tokens with graphs "
                      f"{'on' if graphs else 'off'} != the HTTP tokens")
        with ledger.request():
            _, timing = _decode_timing(torch, model, greedy["input"][0],
                                       greedy["block_size"], graphs=True)
    _check_launches(n_attn, ledger, "in process, paged pool")
    stats.update(paged_decode=timing, paged_tokens_per_s=timing[
        "tokens_per_s"], paged_dispatched_steps={
            "http": dict(http.steps), "http_replayed": dict(http.replayed),
            "in_process": dict(ledger.steps)})
    say("main_path", f"PAGED_KV_CACHE=1: greedy, overflow past the block and "
        f"int8 tokens equal the contiguous cache's, graph == eager in "
        f"process; generate_tokens {timing['s']:.4f} s = "
        f"{timing['tokens_per_s']:.1f} tokens/s, device busy "
        f"{timing['device_busy_share']:.1%}, on {card}; HTTP requests: the "
        f"device ran the paged kernel {launches} times (its run counter) "
        f"for {http.steps['paged_decode_attention']} dispatched steps x "
        f"{n_attn} layers, {http.replayed['paged_decode_attention']} of "
        f"them replays; the wrapper launched it "
        f"{wrapper['paged_decode_attention']} times")
    return stats, launches


# A device idle gap between two kernels up to this long is launch latency
# (inside a graph, or of launches queued ahead); a longer one is the device
# waiting for the host.
GAP_SHORT_US = 20.0
# Keys a decode step attends at the split-plan measurement (item: a device
# length plans its splits over the whole block).
PLAN_LENGTHS = (129, 1024)


def _split_plan_cost(torch):
    """What a device length costs one decode-kernel launch: GPT-2's decode
    step (12 heads, D 64, fp32, block 1024) timed with an int length (the
    plan covers the valid keys) and with the (1,) device length a captured
    step passes (the plan covers the block), contiguous and paged (pages
    of 128), at PLAN_LENGTHS; L2 flushed before each launch."""
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    g = torch.Generator(device="cuda").manual_seed(7)
    H, D, S, P = 12, 64, 1024, 128
    q = torch.randn(1, H, 1, D, device="cuda", generator=g)
    k, v = (torch.randn(1, H, S, D, device="cuda", generator=g)
            for _ in range(2))
    flat_k, flat_v = (t[0].contiguous() for t in (k, v))  # (H, S, D)
    table = torch.arange(S // P, dtype=torch.int32, device="cuda")[None]
    flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")
    out = {}
    for L in PLAN_LENGTHS:
        dev_len = torch.tensor([L], dtype=torch.int32, device="cuda")
        row = {}
        for name, fn in (
                ("contiguous", lambda n: DA.decode_attention(
                    q, k, v, L - 1, n)),
                ("paged", lambda n: PA.paged_decode_attention(
                    q, flat_k, flat_v, table, P, L - 1, n))):
            host_ms = _time_ms(torch, lambda: fn(L), 50, flush)
            device_ms = _time_ms(torch, lambda: fn(dev_len), 50, flush)
            err = float((fn(L) - fn(dev_len)).abs().max())
            check(err <= FP32_ATOL, f"{name} L {L}: host and device lengths "
                  f"differ by {err:.2e}")
            plans = [DA.plan_for(1, H, H, 1, n, S, None,
                                 P if name == "paged" else None,
                                 DA.sm_count(q.device))
                     for n in (L, dev_len)]
            row[name] = {"host_length_ms": host_ms,
                         "device_length_ms": device_ms,
                         "host_plan": plans[0]._asdict(),
                         "device_plan": plans[1]._asdict()}
            say("main_path", f"split plan, {name} L {L}: int length "
                f"{host_ms:.4f} ms ({plans[0].n_split} splits), device "
                f"length {device_ms:.4f} ms ({plans[1].n_split} splits over "
                f"the block)")
        out[str(L)] = row
    del flush
    return out


# ---------------------------------------------------------------------------
# 4b: continuous batching over HTTP
# ---------------------------------------------------------------------------

CB_PROMPT_LENS = (16, 64, 128, 200, 256, 300, 500, 700)
CB_NEW_TOKENS = 64
CB_BATCH_ROWS = 4
CB_ENV = {"PAGED_KV_CACHE": "1", "PENROZ_CONTINUOUS_BATCHING": "1",
          "PENROZ_SCHED_MAX_ROWS": "8"}
# A generated token passes the argmax check when its logit is within this
# of the top logit of the plain no-cache forward over its prefix (fp32).
ARGMAX_ATOL = 1e-4


@contextlib.contextmanager
def _env(values):
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_continuous_batching(torch, layers, optimizer, block, vocab, card,
                              device="cuda"):
    """GPT-2 124M under PAGED_KV_CACHE=1 PENROZ_CONTINUOUS_BATCHING=1
    PENROZ_SCHED_MAX_ROWS=8 (superstep 8, chunk 256, the defaults): 8
    concurrent greedy /generate/ requests (prompts of CB_PROMPT_LENS
    tokens, numpy seed 0 ids, 64 new tokens; one streamed), then one
    /generate_batch/ of 4 rows.  Each result is held against the same
    request served alone (single sequence, paged; exact matches counted)
    and, as the gate, each generated token must be the argmax of the plain
    no-cache forward over its prefix within ARGMAX_ATOL.  The ragged
    kernel must launch once per attention layer per mixed step that
    /serving_stats/ reports, and some tick must mix prefill and decode
    rows.  Counts are reset just before the traffic and read just after."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in CB_PROMPT_LENS]
    bodies = [{"model_id": "smoke_cb", "input": [p], "block_size": block,
               "max_new_tokens": CB_NEW_TOKENS, "temperature": 0}
              for p in prompts]
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    try:
        status, text, _ = _post(base, "/model/", {
            "model_id": "smoke_cb", "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        # the same requests alone, one after another (single sequence)
        alone = []
        with _env({"PAGED_KV_CACHE": "1"}):
            t0 = time.monotonic()
            for body in bodies:
                status, text, _ = _post(base, "/generate/", body)
                check(status == 200, f"/generate/ alone -> {status}: "
                      f"{text[:300]}")
                alone.append(json.loads(text)["tokens"])
            stats["sequential_s"] = time.monotonic() - t0
        stats["sequential_tokens_per_s"] = (
            len(bodies) * CB_NEW_TOKENS / stats["sequential_s"])

        with _env(CB_ENV):
            # warm-up: the engine loads the model at its first request
            status, text, _ = _post(base, "/generate/", dict(
                bodies[0], max_new_tokens=2))
            check(status == 200, f"warm-up -> {status}: {text[:300]}")
            engine_stats = json.loads(_post(base, "/serving_stats/", None,
                                            method="GET")[1])
            steps_before = sum(t["superstep"]
                               for t in engine_stats["tick_timeline"])
            dispatches_before = engine_stats["dispatches_total"]
            for fn in (RPA.ragged_paged_attention, PA.paged_decode_attention,
                       DA.decode_attention):
                fn.launches = 0
            results = [None] * len(bodies)
            latency = [None] * len(bodies)

            def fire(i):
                if i == 3:  # one streamed request (_stream checks its 200)
                    toks, _, secs = _stream(base, bodies[i])
                    out = prompts[i] + toks
                else:
                    status, text, secs = _post(base, "/generate/",
                                               bodies[i])
                    out = json.loads(text)["tokens"] if status == 200 else []
                if len(out) == len(prompts[i]) + CB_NEW_TOKENS:
                    results[i] = out
                latency[i] = secs

            t0 = time.monotonic()
            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(len(bodies))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            stats["concurrent_s"] = time.monotonic() - t0
            check(all(r is not None for r in results),
                  "a concurrent request failed or came back short")
            status, text, secs = _post(base, "/generate_batch/", {
                "model_id": "smoke_cb", "inputs": prompts[:CB_BATCH_ROWS],
                "block_size": block, "max_new_tokens": CB_NEW_TOKENS,
                "temperature": 0})
            check(status == 200, f"/generate_batch/ -> {status}: "
                  f"{text[:300]}")
            batch = json.loads(text)["sequences"]
            check([len(b) for b in batch] == [len(p) + CB_NEW_TOKENS for p
                                              in prompts[:CB_BATCH_ROWS]],
                  "/generate_batch/ returned short sequences")
            stats["batch_request_s"] = secs
            status, text, _ = _post(base, "/serving_stats/", None,
                                    method="GET")
            launches = {"ragged_paged_attention":
                        RPA.ragged_paged_attention.launches,
                        "paged_decode_attention":
                        PA.paged_decode_attention.launches,
                        "decode_attention": DA.decode_attention.launches}
            # sampled continuous batching (temperature 0.8, its own
            # engine): the same request twice draws the same tokens, since
            # each (row, position) has its own key, through the ragged kernel
            sampled = []
            for _ in range(2):
                status_s, text_s, _ = _post(base, "/generate/", dict(
                    bodies[2], temperature=0.8))
                check(status_s == 200, f"sampled /generate/ -> {status_s}: "
                      f"{text_s[:300]}")
                sampled.append(json.loads(text_s)["tokens"])
            n_p = len(prompts[2])
            check(all(len(t) == n_p + CB_NEW_TOKENS and t[:n_p] == prompts[2]
                      and all(0 <= x < vocab for x in t[n_p:])
                      for t in sampled), "a sampled result is malformed")
            check(sampled[0] == sampled[1],
                  "the same sampled request drew different tokens")
            check(RPA.ragged_paged_attention.launches
                  > launches["ragged_paged_attention"],
                  "the sampled requests did not launch the ragged kernel")
            stats["sampled_differs_from_greedy"] = (
                sampled[0] != results[2])
            say("continuous", f"temperature 0.8: two runs of one request "
                f"drew the same {CB_NEW_TOKENS} tokens "
                f"({'not ' if not stats['sampled_differs_from_greedy'] else ''}"
                f"different from greedy)")
        check(status == 200, f"/serving_stats/ -> {status}")
        serving = json.loads(text)
        timeline = serving["tick_timeline"]
        ticks = serving["dispatches_total"] - dispatches_before
        check(len(timeline) == serving["dispatches_total"],
              f"tick timeline holds {len(timeline)} of "
              f"{serving['dispatches_total']} ticks")
        steps = sum(t["superstep"] for t in timeline) - steps_before
        mixed = [t for t in timeline
                 if t["prefill_rows"] > 0 and t["decode_rows"] > 0]
        stats.update(
            concurrent_tokens_per_s=(len(bodies) * CB_NEW_TOKENS
                                     / stats["concurrent_s"]),
            latency_s=latency,
            latency_p50_s=float(np.median(latency)),
            latency_max_s=max(latency), ticks=ticks, mixed_steps=steps,
            mixed_ticks=len(mixed),
            max_superstep=max(t["superstep"] for t in timeline),
            decode_tokens=serving["decode_tokens"],
            decode_steps=serving["decode_steps"],
            dispatch_ms=[t["dispatch_ms"] for t in timeline])
        outputs = results + batch
        references = alone + alone[:CB_BATCH_ROWS]
        stats["exact_matches"] = sum(a == b for a, b in
                                     zip(outputs, references))
        say("continuous", f"8 concurrent /generate/ (one streamed) + a "
            f"/generate_batch/ of {CB_BATCH_ROWS}: {ticks} unified ticks, "
            f"{steps} mixed steps (superstep <= {stats['max_superstep']}), "
            f"{len(mixed)} ticks mixing prefill and decode rows; "
            f"{stats['exact_matches']}/{len(outputs)} results equal to the "
            f"request served alone")
        say("continuous", f"concurrent: {stats['concurrent_s']:.3f} s, "
            f"{stats['concurrent_tokens_per_s']:.1f} tokens/s, latency p50 "
            f"{stats['latency_p50_s']:.3f} s max "
            f"{stats['latency_max_s']:.3f} s; the same 8 one after another: "
            f"{stats['sequential_s']:.3f} s, "
            f"{stats['sequential_tokens_per_s']:.1f} tokens/s; batch of "
            f"{CB_BATCH_ROWS}: {stats['batch_request_s']:.3f} s, on {card}")

        # the gate: every generated token is the argmax (within
        # ARGMAX_ATOL) of the plain no-cache forward over its prefix
        model = DS.get_engine("smoke_cb", block, 0, None,
                              device=server.device)._model
        worst = 0.0
        with torch.inference_mode(), plain_kernels():
            for out in outputs:
                n_prompt = len(out) - CB_NEW_TOKENS
                check(out[:n_prompt] in prompts, "a result lost its prompt")
                x = torch.tensor([out[:-1]], device=device)
                acts, _, _ = model.arch(x, skip_softmax=True)
                logits = acts[-1][0, n_prompt - 1:].float()
                gen = torch.tensor(out[n_prompt:], device=device)
                gap = logits.max(-1).values - logits.gather(
                    -1, gen[:, None])[:, 0]
                worst = max(worst, float(gap.max()))
        stats["argmax_worst_gap"] = worst
        say("continuous", f"every generated token is the argmax of the "
            f"plain no-cache forward over its prefix: worst gap to the top "
            f"logit {worst:.2e} (<= {ARGMAX_ATOL})")
        check(worst <= ARGMAX_ATOL, f"a generated token is {worst:.3e} below "
              f"the top logit of the plain forward")
        say("continuous", f"kernel launches {launches} for {steps} mixed "
            f"steps x {n_attn} attention layers")
        check(launches["ragged_paged_attention"] == n_attn * steps,
              f"ragged_paged_attention launched "
              f"{launches['ragged_paged_attention']} times, expected "
              f"{n_attn * steps}")
        check(launches["paged_decode_attention"] == 0
              and launches["decode_attention"] == 0,
              "a single-sequence kernel launched under continuous batching")
        check(mixed, "no tick mixed prefill and decode rows")
        stats.update(_profile_continuous(torch, base, bodies, model,
                                         device))
        say("continuous", f"loaded model, the same 8 one after another "
            f"(single sequence, paged): {stats['loaded_sequential_s']:.3f} "
            f"s = {stats['loaded_sequential_tokens_per_s']:.1f} tokens/s; "
            f"the 8 concurrent again under torch.profiler: device busy "
            f"{stats['profile_device_ms']:.2f} ms of "
            f"{stats['profile_wall_ms']:.2f} ms "
            f"({stats['profile_busy_share']:.1%}), ragged kernel "
            f"{stats['profile_ragged_ms']:.2f} ms, cuBLAS "
            f"{stats['profile_gemm_ms']:.2f} ms, on {card}")
    finally:
        DS.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches["ragged_paged_attention"]


def _device_kernel_ms(torch, prof):
    """Device ms by kernel name in a torch.profiler trace: device kernels
    only (user annotations such as the optimizer's
    "Optimizer.step#AdamW.step" span kernels and would count twice)."""
    kernels = {}
    for evt in prof.events():
        if (evt.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(evt, "is_user_annotation", False)
                and "#" not in evt.name):
            kernels[evt.name] = kernels.get(evt.name, 0.0) + \
                evt.time_range.elapsed_us() / 1e3
    return kernels


def _profile_continuous(torch, base, bodies, model, device):
    """Where the continuous-batching time goes: the 8 requests one after
    another through generate_tokens with the model already loaded (the
    single-sequence decode rate, without the per-request checkpoint load
    of the HTTP path), then the 8 concurrent requests again under
    torch.profiler: the device's busy share of the wall time, and the
    ragged kernel's and cuBLAS's device ms."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    with _env({"PAGED_KV_CACHE": "1"}):
        t0 = time.monotonic()
        for body in bodies:
            model.generate_tokens(body["input"], body["block_size"],
                                  body["max_new_tokens"], temperature=0)
        if device != "cpu":
            torch.cuda.synchronize()
        out["loaded_sequential_s"] = time.monotonic() - t0
    out["loaded_sequential_tokens_per_s"] = (
        len(bodies) * CB_NEW_TOKENS / out["loaded_sequential_s"])
    done = [False] * len(bodies)

    def fire(i):
        status, text, _ = _post(base, "/generate/", bodies[i])
        done[i] = status == 200 and len(json.loads(text)["tokens"]) == (
            len(bodies[i]["input"][0]) + CB_NEW_TOKENS)

    with _env(CB_ENV), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        out["profile_wall_ms"] = (time.monotonic() - t0) * 1e3
    check(all(done), "a profiled request failed or came back short")
    kernels = _device_kernel_ms(torch, prof)
    device_ms = sum(kernels.values())
    check(device == "cpu" or device_ms > 0, "the profiler saw no device time")
    out.update(
        profile_device_ms=device_ms,
        profile_busy_share=device_ms / out["profile_wall_ms"],
        profile_ragged_ms=sum(ms for n, ms in kernels.items()
                              if "decode_core::Ragged" in n),
        profile_gemm_ms=sum(ms for n, ms in kernels.items()
                            if any(f in n.lower() for f in (
                                "gemm", "cutlass", "xmma", "nvjet"))),
        profile_top_kernels_ms=[(n[:90], ms) for n, ms in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]])
    return out


# ---------------------------------------------------------------------------
# 4f: the radix prefix cache and speculative decoding over HTTP
# ---------------------------------------------------------------------------

# Prefix traffic: a shared 512-token prefix (numpy seed 0) and a distinct
# suffix a request; one request warms the cache, then the wave of 8 runs
# concurrently, each streamed (its first line is its time to first token).
PF_PREFIX_LEN = 512
PF_WARM_SUFFIX = 24
PF_SUFFIX_LENS = (16, 40, 64, 90, 120, 150, 180, 200)
PF_NEW_TOKENS = 64
# Speculation traffic: 8 requests, each prompt a 64-token sequence S
# (numpy seed 1, one a request) repeated 4 times, 128 new tokens; the knobs
# at their defaults (K 4, n-gram 3); sampled at temperature 0.8, top_k 40.
# Random weights never copy their context, so the drafter, which needs the
# trailing 3-gram of prompt + output to have occurred before, would find
# nothing: S[0] is set to the token the model itself emits after S x 4
# (a fixed point, searched with one-token requests), so every row's first
# decode step has a draft, S[1:5].
SPEC_PERIOD, SPEC_REPEATS, SPEC_NEW_TOKENS = 64, 4, 128
SPEC_TEMPERATURE, SPEC_TOP_K = 0.8, 40
SPEC_SEARCH_ROUNDS = 32


# Each traffic runs knob off, then on (a fresh engine each turn), and both
# turns' tokens must be equal.
TURNS = ("off", "on")


def _merge_turns(rows):
    """One row from a knob setting's turns: a number that differs between
    them is their mean; ``turns`` keeps every turn."""
    out = {}
    for key, value in rows[0].items():
        values = [r[key] for r in rows]
        if all(v == value for v in values):
            out[key] = value
        elif all(isinstance(v, (int, float)) for v in values):
            out[key] = sum(values) / len(values)
        else:
            out[key] = values
    out["turns"] = rows
    return out


@contextlib.contextmanager
def _mixed_steps():
    """Count the unified steps every engine runs (the ``n`` of each
    ``decode_mixed_step`` block) for the duration: ``{"steps": N}``."""
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    real = NeuralNetworkModel.decode_mixed_step
    count = {"steps": 0}

    def counted(self, kv, descs, *args, **kwargs):
        count["steps"] += len(descs)
        return real(self, kv, descs, *args, **kwargs)

    NeuralNetworkModel.decode_mixed_step = counted
    try:
        yield count
    finally:
        NeuralNetworkModel.decode_mixed_step = real


def _wave(base, bodies):
    """The bodies as concurrent streamed /generate/ requests: (full
    sequences, seconds to each first token, wall seconds)."""
    out = [None] * len(bodies)
    ttft = [None] * len(bodies)

    def fire(i):
        toks, first, _ = _stream(base, bodies[i])
        out[i] = bodies[i]["input"][0] + toks
        ttft[i] = first

    t0 = time.monotonic()
    threads = [threading.Thread(target=fire, args=(i,))
               for i in range(len(bodies))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.monotonic() - t0
    check(all(o is not None for o in out), "a wave request failed")
    return out, ttft, wall


def _drafting_prompts(base, body, vocab, sampling):
    """8 prompts S x 4 whose first emitted token (greedy, or the row's
    positional draw when ``sampling`` has a temperature: rows are taken
    in order by one /generate_batch/) is S[0], so each row's history ends
    in a 3-gram seen before.  One-token batches probe S[0] <- the token
    emitted; a row still moving after 4 probes starts over from a new
    seeded S."""
    import numpy as np
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, vocab, SPEC_PERIOD).tolist() for _ in range(8)]
    moves = [0] * 8
    for _ in range(SPEC_SEARCH_ROUNDS):
        prompts = [s * SPEC_REPEATS for s in seqs]
        status, text, _ = _post(base, "/generate_batch/", dict(
            body, inputs=prompts, max_new_tokens=1, **sampling))
        check(status == 200, f"/generate_batch/ -> {status}: {text[:300]}")
        firsts = [seq[-1] for seq in json.loads(text)["sequences"]]
        if all(s[0] == t for s, t in zip(seqs, firsts)):
            return prompts
        for i, t in enumerate(firsts):
            if seqs[i][0] != t:
                moves[i] += 1
                if moves[i] % 4 == 0:
                    seqs[i] = rng.integers(0, vocab, SPEC_PERIOD).tolist()
                else:
                    seqs[i][0] = t
    raise SmokeFailure(f"no drafting prompts in {SPEC_SEARCH_ROUNDS} "
                       f"rounds ({sampling})")


def phase_prefix_spec(torch, layers, optimizer, block, vocab, card,
                      device="cuda"):
    """GPT-2 124M fp32 under PAGED_KV_CACHE=1 PENROZ_CONTINUOUS_BATCHING=1
    PENROZ_SCHED_MAX_ROWS=8, prefix-cache pages at their default (64).

    Prefix traffic, fp32 and int8 pages, cache off then on (each on a
    fresh engine): a warm request (the prefix + its own suffix, 2 new
    tokens), then the wave of 8.  Gates: each request's tokens equal
    between cache on and off; the wave's 8 hits cover 8 x 512 tokens; the
    cache-on wave runs fewer prefill chunks; no page leaked and no pin
    left (``page_audit()``); the ragged kernel launches once per attention
    layer per unified step.  Speculation traffic, PENROZ_SPEC_DECODE=1 at
    its defaults against off: 8 concurrent greedy /generate/ and the same
    prompts sampled in one /generate_batch/ (rows taken in order, so each
    (row, position) key is the same in both runs): equal tokens,
    verify spans run; one prefix-traffic request with both knobs on equals
    both off.  Counts are reset just before each traffic and read just
    after."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, vocab, PF_PREFIX_LEN).tolist()
    warm_prompt = prefix + rng.integers(0, vocab, PF_WARM_SUFFIX).tolist()
    prompts = [prefix + rng.integers(0, vocab, n).tolist()
               for n in PF_SUFFIX_LENS]
    body = {"model_id": "smoke_pf", "block_size": block, "temperature": 0}
    bodies = [dict(body, input=[p], max_new_tokens=PF_NEW_TOKENS)
              for p in prompts]
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {"prefix": {}, "spec": {}}
    launches = 0

    def engine_stats():
        status, text, _ = _post(base, "/serving_stats/", None, method="GET")
        check(status == 200, f"/serving_stats/ -> {status}")
        engines = json.loads(text)["engines"]
        check(len(engines) == 1, f"{len(engines)} engines, expected 1")
        return engines[0]

    def counted(run):
        """Run ``run()`` with the ragged count zeroed just before and read
        just after; check it against the unified steps run."""
        nonlocal launches
        RPA.ragged_paged_attention.launches = 0
        with _mixed_steps() as count:
            result = run()
        n = RPA.ragged_paged_attention.launches
        check(n == n_attn * count["steps"], f"ragged_paged_attention "
              f"launched {n} times for {count['steps']} unified steps x "
              f"{n_attn} attention layers")
        launches += n
        return result, count["steps"]

    try:
        status, text, _ = _post(base, "/model/", {
            "model_id": "smoke_pf", "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        for dtype, quant in (("fp32", "0"), ("int8", "1")):
            outs, turns = [], {"off": [], "on": []}
            for cache in TURNS:
                DS.reset()  # an engine sizes its pool when it is built
                env = dict(CB_ENV, PENROZ_PREFIX_CACHE=
                           "1" if cache == "on" else "0",
                           TURBO_QUANT_KV_CACHE=quant)
                with _env(env):
                    status, text, _ = _post(base, "/generate/", dict(
                        body, input=[warm_prompt], max_new_tokens=2))
                    check(status == 200, f"warm-up -> {status}: "
                          f"{text[:300]}")
                    before = engine_stats()
                    (out, ttft, wall), steps = counted(
                        lambda: _wave(base, bodies))
                    after = engine_stats()
                    engine = DS.get_engine("smoke_pf", block, 0, None,
                                           device=server.device)
                    cache_obj = engine._prefix_cache
                    row = {
                        "ttft_p50_s": float(np.median(ttft)),
                        "ttft_max_s": max(ttft), "wall_s": wall,
                        "tokens_per_s": len(bodies) * PF_NEW_TOKENS / wall,
                        "prefill_chunks": after["prefill_chunks"]
                        - before["prefill_chunks"], "mixed_steps": steps}
                    if cache == "on":
                        pc, pc0 = after["prefix_cache"], before["prefix_cache"]
                        row.update(hits=pc["hits"] - pc0["hits"],
                                   hit_tokens=pc["hit_tokens"]
                                   - pc0["hit_tokens"],
                                   misses=pc["misses"] - pc0["misses"],
                                   cached_pages=pc["cached_pages"],
                                   audit=cache_obj.page_audit(),
                                   pins=sum(nd.refs for nd in
                                            cache_obj.iter_nodes()))
                        check(row["hits"] == len(bodies)
                              and row["misses"] == 0 and row["hit_tokens"]
                              == len(bodies) * PF_PREFIX_LEN,
                              f"{dtype}: the wave hit {row['hits']} times "
                              f"for {row['hit_tokens']} tokens, expected "
                              f"8 x 512")
                        check(not row["audit"] and row["pins"] == 0,
                              f"{dtype}: page audit {row['audit']}, "
                              f"{row['pins']} pins left")
                    else:
                        check(after["prefix_cache"] is None
                              and cache_obj is None,
                              "a prefix cache with PENROZ_PREFIX_CACHE=0")
                outs.append(out)
                turns[cache].append(row)
            on, off = (_merge_turns(turns[c]) for c in ("on", "off"))
            stats["prefix"][f"{dtype}_on"] = on
            stats["prefix"][f"{dtype}_off"] = off
            same = sum(all(o[i] == outs[0][i] for o in outs)
                       for i in range(len(bodies)))
            say("prefix", f"{dtype}: the wave of 8 (512-token prefix + "
                f"16-200, {PF_NEW_TOKENS} new), cache on / off: TTFT p50 {on['ttft_p50_s']:.4f} / "
                f"{off['ttft_p50_s']:.4f} s, max {on['ttft_max_s']:.4f} / "
                f"{off['ttft_max_s']:.4f} s; {on['tokens_per_s']:.1f} / "
                f"{off['tokens_per_s']:.1f} tokens/s; prefill chunks "
                f"{on['prefill_chunks']} / {off['prefill_chunks']}; hits "
                f"{on['hits']} covering {on['hit_tokens']} tokens, "
                f"{on['cached_pages']} pages cached; {same}/8 equal in "
                f"both turns; on {card}")
            check(same == len(bodies), f"{dtype}: {len(bodies) - same} "
                  f"requests differ between prefix cache on and off")
            check(max(r["prefill_chunks"] for r in turns["on"])
                  < min(r["prefill_chunks"] for r in turns["off"]),
                  f"{dtype}: the cache did not cut the prefill chunks")

        # speculation: off, then on, each on a fresh engine
        sampling = {"temperature": SPEC_TEMPERATURE, "top_k": SPEC_TOP_K}
        DS.reset()
        with _env(dict(CB_ENV, PENROZ_SPEC_DECODE="0",
                       PENROZ_PREFIX_CACHE="0", TURBO_QUANT_KV_CACHE="0")):
            spec_prompts = _drafting_prompts(base, body, vocab, {})
            sampled_prompts = _drafting_prompts(base, body, vocab, sampling)
        spec_bodies = [dict(body, input=[p], max_new_tokens=SPEC_NEW_TOKENS)
                       for p in spec_prompts]
        spec_out, turns = [], {"off": [], "on": []}
        for spec in TURNS:
            DS.reset()
            with _env(dict(CB_ENV, PENROZ_SPEC_DECODE=
                           "1" if spec == "on" else "0",
                           PENROZ_PREFIX_CACHE="0",
                           TURBO_QUANT_KV_CACHE="0")):
                status, text, _ = _post(base, "/generate/", dict(
                    spec_bodies[0], max_new_tokens=2))
                check(status == 200, f"warm-up -> {status}: {text[:300]}")
                before = engine_stats()
                (out, ttft, wall), steps = counted(
                    lambda: _wave(base, spec_bodies))
                after = engine_stats()

                def batch():
                    status, text, secs = _post(base, "/generate_batch/", dict(
                        body, inputs=sampled_prompts,
                        max_new_tokens=SPEC_NEW_TOKENS, **sampling))
                    check(status == 200, f"sampled /generate_batch/ -> "
                          f"{status}: {text[:300]}")
                    return json.loads(text)["sequences"], secs
                (sampled, sampled_s), _ = counted(batch)
                sampled_stats = [e for e in json.loads(_post(
                    base, "/serving_stats/", None, method="GET")[1])[
                    "engines"] if e["temperature"] > 0][0]
            drafted = (after["spec_drafted_tokens"]
                       - before["spec_drafted_tokens"])
            accepted = (after["spec_accepted_tokens"]
                        - before["spec_accepted_tokens"])
            tokens = after["decode_tokens"] - before["decode_tokens"]
            dsteps = after["decode_steps"] - before["decode_steps"]
            turns[spec].append({
                "tokens_per_s": len(spec_bodies) * SPEC_NEW_TOKENS / wall,
                "wall_s": wall, "ttft_p50_s": float(np.median(ttft)),
                "verify_steps": after["spec_verify_steps"]
                - before["spec_verify_steps"],
                "drafted": drafted, "accepted": accepted,
                "accept_rate": accepted / drafted if drafted else None,
                "tokens_per_decode_step": tokens / dsteps,
                "mixed_steps": steps, "sampled_s": sampled_s,
                "sampled_verify_steps": sampled_stats["spec_verify_steps"],
                "sampled_accept_rate": sampled_stats["spec_accept_rate"]})
            spec_out.append((out, sampled))
        on, off = (_merge_turns(turns[c]) for c in ("on", "off"))
        stats["spec"] = {"on": on, "off": off}
        greedy_same = sum(all(o[0][i] == spec_out[0][0][i] for o in spec_out)
                          for i in range(8))
        sampled_same = sum(all(o[1][i] == spec_out[0][1][i]
                               for o in spec_out) for i in range(8))
        say("spec", f"8 concurrent ({SPEC_PERIOD} tokens x {SPEC_REPEATS}, "
            f"{SPEC_NEW_TOKENS} new) speculation on / off: "
            f"{on['tokens_per_s']:.1f} / {off['tokens_per_s']:.1f} tokens/s, "
            f"{on['tokens_per_decode_step']:.3f} / "
            f"{off['tokens_per_decode_step']:.3f} tokens a decode step, "
            f"{on['mixed_steps']} / {off['mixed_steps']} unified steps; "
            f"{on['verify_steps']} verify spans, accept rate "
            f"{on['accept_rate']}; greedy {greedy_same}/8 equal, sampled "
            f"{sampled_same}/8 equal (accept rate "
            f"{on['sampled_accept_rate']}), both turns; on {card}")
        check(greedy_same == 8, "greedy tokens differ with speculation on")
        check(sampled_same == 8, "sampled tokens differ with speculation on")
        check(spec_out[0][1] != spec_out[0][0], "sampling drew the greedy "
              "tokens")
        check(all(r["verify_steps"] > 0 and r["sampled_verify_steps"] > 0
                  for r in turns["on"]), "no verify span ran")
        check(all(r["verify_steps"] == 0 for r in turns["off"]),
              "a verify span with speculation off")

        # both knobs together: the first speculation request again, after
        # one that registers its pages, against both off
        DS.reset()
        with _env(dict(CB_ENV, PENROZ_SPEC_DECODE="1",
                       PENROZ_PREFIX_CACHE="1", TURBO_QUANT_KV_CACHE="0")):
            def both():
                results = []
                for b in (dict(spec_bodies[0], max_new_tokens=2),
                          spec_bodies[0]):
                    status, text, _ = _post(base, "/generate/", b)
                    check(status == 200, f"/generate/ -> {status}: "
                          f"{text[:300]}")
                    results.append(json.loads(text)["tokens"])
                return results[-1]
            got, _ = counted(both)
            both_stats = engine_stats()
        check(both_stats["prefix_cache"]["hits"] == 1,
              "the combined request missed the prefix cache")
        check(both_stats["spec_verify_steps"] > 0,
              "the combined request ran no verify span")
        check(got == spec_out[0][0][0],
              "prefix cache + speculation differ from both off")
        stats["both"] = {"verify_steps": both_stats["spec_verify_steps"],
                         "hits": both_stats["prefix_cache"]["hits"]}
        say("spec", f"prefix cache + speculation on one request: equal to "
            f"both off ({both_stats['spec_verify_steps']} verify spans, "
            f"{both_stats['prefix_cache']['hit_tokens']} tokens hit); "
            f"ragged launches in this phase {launches}")
    finally:
        DS.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


# ---------------------------------------------------------------------------
# 4c: the hybrid attention/SSM model over HTTP
# ---------------------------------------------------------------------------

HYBRID = dict(d=768, heads=12, depth=12, vocab=50304, block=1024,
              ssm_every=2)
OUTPUT_PROMPT_LEN = 16
EVAL_BATCH, EVAL_BLOCK, EVAL_EPOCHS = 8, 1024, 2
# compute_output's logits at 1 x 1024 with the kernel against the same
# forward with the sequential oracle in its place (fp32, 12 layers; the
# two GLA forms differ by ~1e-6 relative, GLA_SEQ_C bounds them)
HYBRID_LOGITS_ATOL = 1e-3


@contextlib.contextmanager
def sequential_gla():
    """Route the no-cache SSM forward to the token-sequential oracle for
    the duration (this script's comparison only; the package has no such
    switch)."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_scan as SS
    saved = SS.gla_chunked
    SS.gla_chunked = lambda q, k, v, g, block_t=None: \
        SSM.gla_full_reference(q, k, v, g)
    try:
        yield
    finally:
        SS.gla_chunked = saved


def phase_hybrid(torch, optimizer, card, device="cuda"):
    """The hybrid attention/SSM model over HTTP and in process; returns
    (stats, launches of the chunked GLA kernel in this phase)."""
    import numpy as np

    from penroz_tpu_torch.models import decode_graphs as DG
    from penroz_tpu_torch.models import presets
    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import ssm_scan as SS
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    layers = presets.hybrid_custom(**HYBRID)
    vocab, block = HYBRID["vocab"], HYBRID["block"]
    with torch.device("meta"):
        arch = CompiledArch(layers)
    n_ssm, n_attn = len(arch.ssm_layers), len(arch.attn_layers)
    check((n_ssm, n_attn) == (6, 6), f"hybrid has {n_ssm} ssm and {n_attn} "
          f"attention layers, not 6 and 6")
    rng = np.random.default_rng(0)
    os.makedirs("data", exist_ok=True)
    np.save(os.path.join("data", "hybrid_000000.npy"), rng.integers(
        0, vocab, EVAL_BATCH * EVAL_BLOCK * EVAL_EPOCHS + 1).astype(np.uint16))
    prompt = rng.integers(0, vocab, PROMPT_LEN).tolist()
    long_input = rng.integers(0, vocab, (1, block)).tolist()
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    forwards = 0
    try:
        status, text, _ = _post(base, "/model/", {
            "model_id": "smoke_hybrid", "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        DG.reset()
        SS.gla_chunked.launches = 0
        _zero_decode_counts()
        SU.ssm_update.launches = 0
        SU.ssm_update.runs.reset()
        http, ledger = _StepLedger(), _StepLedger()
        greedy = {"model_id": "smoke_hybrid", "input": [prompt],
                  "block_size": block, "max_new_tokens": NEW_TOKENS,
                  "temperature": 0}
        tokens = {}
        caches = (("contiguous", {}), ("again", {}),
                  ("int8", {"TURBO_QUANT_KV_CACHE": "1"}),
                  ("paged", {"PAGED_KV_CACHE": "1"}),
                  ("paged_int8", {"PAGED_KV_CACHE": "1",
                                  "TURBO_QUANT_KV_CACHE": "1"}))
        for name, env in caches:
            with _env(env), http.request():
                status, text, secs = _post(base, "/generate/", greedy)
            check(status == 200, f"hybrid {name} /generate/ -> "
                  f"{status}: {text[:300]}")
            tokens[name] = json.loads(text)["tokens"]
            stats[f"generate_{name}_s"] = secs
        http_counts, ran = _check_launches(n_attn, http, "hybrid, HTTP")
        # the recurrent update: once an ssm layer in every dispatched step
        # (prefills, replays, warm-ups), launched by the wrapper in every
        # step that was not a replay
        steps = sum(http.steps.values())
        eager_steps = steps - sum(http.replayed.values())
        ssm_ran, ssm_launched = SU.ssm_update.runs.read(), \
            SU.ssm_update.launches
        check(ssm_ran == n_ssm * steps, f"hybrid, HTTP: the device ran the "
              f"recurrent update {ssm_ran} times, expected {n_ssm} x "
              f"{steps} dispatched steps")
        check(ssm_launched == n_ssm * eager_steps, f"hybrid, HTTP: "
              f"ssm_update launched {ssm_launched} times, expected {n_ssm} "
              f"x {eager_steps} steps that were not replays")
        stats["ssm_update"] = {"ran": ssm_ran, "launched": ssm_launched,
                               "steps": steps}
        _zero_decode_counts()
        first = tokens["contiguous"]
        check(len(first) == PROMPT_LEN + NEW_TOKENS and first[:PROMPT_LEN]
              == prompt and all(0 <= t < vocab for t in first),
              "hybrid greedy output malformed")
        check(tokens["again"] == first, "hybrid greedy not deterministic")
        check(tokens["paged"] == first,
              "hybrid paged tokens differ from the contiguous cache's")
        check(tokens["paged_int8"] == tokens["int8"],
              "hybrid int8 paged tokens differ from the int8 cache's")
        agree = sum(a == b for a, b in zip(tokens["int8"][PROMPT_LEN:],
                                           first[PROMPT_LEN:]))
        stats["int8_tokens_equal_fp32"] = agree
        # in process: the eager step loop's tokens == the graph path's
        model = NeuralNetworkModel.deserialize("smoke_hybrid", device=device,
                                               optimizer=False)
        for name, env in caches[2:]:
            with _env(env), _graphs(False), ledger.request():
                got = model.generate_tokens([prompt], block, NEW_TOKENS,
                                            temperature=0)
            check(got == tokens[name], f"hybrid {name}: the eager step "
                  f"loop's tokens != the graph path's")
        timing = {}
        for mode, graphs in (("graph", True), ("eager", False)):
            with ledger.request():
                out, timing[mode] = _decode_timing(torch, model, prompt,
                                                   block, graphs)
            check(out == first, f"hybrid {mode} timing run != HTTP tokens")
        stats["decode"] = timing
        stats["tokens_per_s"] = timing["graph"]["tokens_per_s"]
        stats["eager_tokens_per_s"] = timing["eager"]["tokens_per_s"]
        check(SS.gla_chunked.launches == 0,
              "the chunked kernel launched on the cached path")
        _check_launches(n_attn, ledger, "hybrid, in process")
        stats.update(decode_ran=dict(ran), decode_launches=http_counts,
                     dispatched_steps={"http": dict(http.steps),
                                       "http_replayed": dict(http.replayed),
                                       "in_process": dict(ledger.steps)},
                     runner_stats=_runner_stats())
        say("hybrid", f"greedy {PROMPT_LEN}+{NEW_TOKENS}: identical twice, "
            f"paged == contiguous, paged int8 == int8, int8 "
            f"{agree}/{NEW_TOKENS} equal to fp32, the eager step loop == "
            f"the graph path on int8, paged and paged int8 "
            f"(contiguous: the timing runs); "
            f"{stats['generate_contiguous_s']:.3f} s a request (checkpoint "
            f"load included); the chunked kernel not launched (the cached "
            f"recurrent update instead); HTTP requests: the device ran the "
            f"decode kernels {ran} times (their run counters), {n_attn} a "
            f"dispatched step ({http.steps}, {http.replayed} of them "
            f"replays), the "
            f"wrappers launched them {http_counts} times; the recurrent "
            f"update ran {ssm_ran} times, {n_ssm} a dispatched step, "
            f"launched {ssm_launched}, on {card}")
        for mode in ("graph", "eager"):
            t = timing[mode]
            say("hybrid", f"generate_tokens {PROMPT_LEN}+{NEW_TOKENS} "
                f"{mode}: {t['s']:.4f} s = {t['tokens_per_s']:.1f} tokens/s "
                f"(median of 3; prefill alone {t['prefill_s']:.4f} s); "
                f"traced: {_trace_text(t)}")

        # /output/ on a short prompt: its argmax is the first greedy token
        short = prompt[:OUTPUT_PROMPT_LEN]
        status, text, _ = _post(base, "/generate/", dict(
            greedy, input=[short], max_new_tokens=1))
        check(status == 200, f"/generate/ 1 token -> {status}")
        tok = json.loads(text)["tokens"][-1]
        status, text, secs = _post(base, "/output/", {
            "model_id": "smoke_hybrid", "input": [short]})
        forwards += 1
        check(status == 200, f"/output/ -> {status}: {text[:300]}")
        body = json.loads(text)
        probs = np.asarray(body["output"], np.float64)
        check(probs.shape == (1, vocab) and body["cost"] is None
              and np.isfinite(probs).all(), "/output/ malformed")
        gap = float(np.log(probs.max()) - np.log(probs[0, tok]))
        stats.update(output_request_s=secs, output_argmax_gap=gap)
        say("hybrid", f"/output/ {OUTPUT_PROMPT_LEN} tokens in {secs:.3f} "
            f"s: the first greedy token is its argmax within {gap:.2e} "
            f"(<= {ARGMAX_ATOL}) in log-probability")
        check(gap <= ARGMAX_ATOL, f"/output/'s argmax is {gap:.3e} above "
              f"the first greedy token")
        # /output/ at 1 x block: the chunked kernel at B 1 on every ssm layer
        status, text, secs = _post(base, "/output/", {
            "model_id": "smoke_hybrid", "input": long_input})
        forwards += 1
        check(status == 200, f"/output/ 1 x {block} -> {status}: "
              f"{text[:300]}")
        probs = np.asarray(json.loads(text)["output"], np.float64)
        check(probs.shape == (1, vocab) and np.isfinite(probs).all(),
              f"/output/ 1 x {block} malformed")
        stats["output_long_request_s"] = secs
        say("hybrid", f"/output/ 1 x {block} tokens in {secs:.3f} s "
            f"(checkpoint load included)")

        # in-process compute_output at 1 x 1024, kernel vs sequential oracle
        # where the int8 cache's greedy tokens first leave the fp32 ones,
        # and how close the fp32 logits' top two were there (recorded only)
        diverge = next((i for i, (a, b) in enumerate(zip(
            tokens["int8"][PROMPT_LEN:], first[PROMPT_LEN:])) if a != b), None)
        stats["int8_first_divergence"] = diverge
        if diverge is not None:
            prefix = torch.tensor([first[:PROMPT_LEN + diverge]],
                                  device=device)
            with torch.inference_mode():
                acts, _, _ = model.arch(prefix, skip_softmax=True)
            forwards += 1
            top2 = torch.topk(acts[-1][0, -1].float(), 2).values
            stats["int8_divergence_fp32_gap"] = float(top2[0] - top2[1])
            del acts
            say("hybrid", f"int8 vs fp32 greedy tokens: first difference at "
                f"generated index {diverge}; fp32 top-1 minus top-2 logit "
                f"there {stats['int8_divergence_fp32_gap']:.3e}")
        else:
            say("hybrid", "int8 vs fp32 greedy tokens: no difference")
        t0 = time.monotonic()
        out, _ = model.compute_output(long_input)
        torch.cuda.synchronize()
        stats["compute_output_s"] = time.monotonic() - t0
        forwards += 1
        x = torch.tensor(long_input, device=device)
        with torch.inference_mode():
            kernel_acts, _, _ = model.arch(x, skip_softmax=True)
            forwards += 1
            t0 = time.monotonic()
            with sequential_gla():
                plain_acts, _, _ = model.arch(x, skip_softmax=True)
            torch.cuda.synchronize()
            stats["sequential_forward_s"] = time.monotonic() - t0
        err = float((kernel_acts[-1] - plain_acts[-1]).abs().max())
        last = torch.softmax(plain_acts[-1][:, -1].float(), dim=-1)
        out_err = float((torch.tensor(out, device=device) - last).abs().max())
        stats.update(logits_max_abs_err=err, output_max_abs_err=out_err)
        del kernel_acts, plain_acts
        say("hybrid", f"compute_output 1 x {block}: {stats['compute_output_s']:.3f} "
            f"s; logits with the kernel vs the sequential oracle: max abs "
            f"err {err:.2e} (atol {HYBRID_LOGITS_ATOL}), its softmax "
            f"{out_err:.2e}; the oracle's forward "
            f"{stats['sequential_forward_s']:.3f} s")
        check(err <= HYBRID_LOGITS_ATOL, f"hybrid logits differ from the "
              f"sequential oracle's by {err:.3e}")
        check(out_err <= HYBRID_LOGITS_ATOL, "compute_output differs from "
              "the sequential oracle's softmax")

        # /evaluate/ at 8 x 1024 against in-process evaluate_model
        evaluate = {"model_id": "smoke_hybrid", "dataset_id": "hybrid",
                    "shard": 0, "epochs": EVAL_EPOCHS,
                    "batch_size": EVAL_BATCH, "block_size": EVAL_BLOCK,
                    "step_size": EVAL_BATCH}
        status, text, secs = _post(base, "/evaluate/", evaluate)
        forwards += EVAL_EPOCHS
        check(status == 200, f"/evaluate/ -> {status}: {text[:300]}")
        cost = json.loads(text)["cost"]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        local = model.evaluate_model("hybrid", None, 0, EVAL_EPOCHS,
                                     EVAL_BATCH, EVAL_BLOCK, EVAL_BATCH)
        stats["evaluate_s"] = time.monotonic() - t0
        forwards += EVAL_EPOCHS
        stats.update(evaluate_request_s=secs, evaluate_cost=cost,
                     evaluate_cost_local=local,
                     evaluate_tokens_per_s=(EVAL_EPOCHS * EVAL_BATCH
                                            * EVAL_BLOCK / stats["evaluate_s"]))
        say("hybrid", f"/evaluate/ {EVAL_EPOCHS} x {EVAL_BATCH} x "
            f"{EVAL_BLOCK}: cost {cost:.6f} in {secs:.3f} s (in process "
            f"{local:.6f}, {stats['evaluate_s']:.3f} s = "
            f"{stats['evaluate_tokens_per_s']:.0f} tokens/s) on {card}")
        check(math.isfinite(cost) and abs(cost - math.log(vocab)) < 1.0,
              f"/evaluate/ cost {cost} not near ln {vocab}")
        check(abs(cost - local) <= 1e-6 * abs(local),
              f"/evaluate/ {cost} != evaluate_model {local}")
        launches = SS.gla_chunked.launches
        say("hybrid", f"chunked GLA launches {launches} for {forwards} "
            f"no-cache forwards x {n_ssm} ssm layers")
        check(launches == n_ssm * forwards, f"gla_chunked launched "
              f"{launches} times, expected {n_ssm * forwards}")
        stats["gla_launches"] = launches
        stats["stats_pass"] = _hybrid_stats_pass(torch, model, rng, vocab)
        check(SS.gla_chunked.launches == launches,
              "the /stats/ pass launched the chunked kernel")
        stats.update(_profile_hybrid(torch, model, vocab, device))
        say("hybrid", f"one no-cache forward at {EVAL_BATCH} x {EVAL_BLOCK} "
            f"under torch.profiler: device busy {stats['profile_device_ms']:.2f} "
            f"ms of {stats['profile_wall_ms']:.2f} ms "
            f"({stats['profile_busy_share']:.1%}); chunked GLA "
            f"{stats['profile_gla_ms']:.2f} ms, flash "
            f"{stats['profile_flash_ms']:.2f} ms, cuBLAS "
            f"{stats['profile_gemm_ms']:.2f} ms, on {card}")
        status, _, _ = _post(base, "/model/?model_id=smoke_hybrid", None,
                             method="DELETE")
        check(status == 204, f"DELETE /model/ -> {status}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


HYBRID_STATS_SHAPE = (1, 256)


def _hybrid_stats_pass(torch, model, rng, vocab):
    """The hybrid's /stats/ pass (``_compute_stats``) on the card at
    HYBRID_STATS_SHAPE: its SSM layers take the differentiable sequential
    oracle (the chunked kernel has no backward), its attention layers the
    fp32 flash kernels, forward and backward, and the cost the
    cross-entropy kernels; every number finite."""
    counters = _training_counters()
    before = {name: fn.launches for name, fn in counters.items()}
    x, y = (rng.integers(0, vocab, HYBRID_STATS_SHAPE) for _ in range(2))
    t0 = time.monotonic()
    doc = model._compute_stats(x, y)
    secs = time.monotonic() - t0
    counts = {name: fn.launches - before[name]
              for name, fn in counters.items()}
    n_attn = len(model.arch.attn_layers)
    check(counts == {"flash_attention_fwd": n_attn,
                     "flash_attention_bwd": n_attn, "ce_forward": 1,
                     "ce_backward": 1},
          f"hybrid /stats/ pass launches {counts}")
    _check_stats_doc(doc, model)
    say("hybrid", f"/stats/ pass at {HYBRID_STATS_SHAPE}: {secs:.3f} s, "
        f"launches {counts} (GLA by its differentiable oracle), every "
        f"number finite")
    return {"s": secs, "launches": counts}


def _check_stats_doc(doc, model):
    """A /stats/ document: one entry a non-softmax top-level layer, one a
    parameter, every number in it finite."""
    from penroz_tpu_torch.ops import modules as M
    n_layers = sum(not isinstance(m, M.Softmax) for m in model.arch.layers)
    check(isinstance(doc, dict) and len(doc["layers"]) == n_layers
          and len(doc["weights"]) == len(model.arch.param_order),
          f"/stats/ document has {len(doc['layers'])} layers and "
          f"{len(doc['weights'])} weights, not {n_layers} and "
          f"{len(model.arch.param_order)}")

    def numbers(v):
        if isinstance(v, dict):
            for x in v.values():
                yield from numbers(x)
        elif isinstance(v, list):
            for x in v:
                yield from numbers(x)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v

    check(all(math.isfinite(v) for v in numbers(doc)),
          "a /stats/ number is not finite")


def _profile_hybrid(torch, model, vocab, device):
    """Where a no-cache hybrid forward's time goes (the /evaluate/ shape,
    with its cost): after a warm-up, one forward on the host clock and one
    under torch.profiler (device ms by kernel, the busy share)."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator(device=device).manual_seed(4)
    x, y = (torch.randint(0, vocab, (EVAL_BATCH, EVAL_BLOCK), device=device,
                          generator=g) for _ in range(2))

    def forward():
        with torch.inference_mode():
            _, cost, _ = model.arch(x, y, skip_softmax=True)
        float(cost)

    forward()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    forward()
    out = {"forward_wall_ms": (time.monotonic() - t0) * 1e3}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        forward()
        out["profile_wall_ms"] = (time.monotonic() - t0) * 1e3
    kernels = _device_kernel_ms(torch, prof)
    device_ms = sum(kernels.values())
    check(device_ms > 0, "the profiler saw no device time")
    out.update(
        profile_device_ms=device_ms,
        profile_busy_share=device_ms / out["profile_wall_ms"],
        profile_gla_ms=sum(ms for n, ms in kernels.items()
                           if "gla_chunked_kernel" in n),
        profile_flash_ms=sum(ms for n, ms in kernels.items()
                             if "flash_fwd_" in n),
        profile_gemm_ms=sum(ms for n, ms in kernels.items()
                            if any(f in n.lower() for f in (
                                "gemm", "cutlass", "xmma", "nvjet"))),
        profile_top_kernels_ms=[(n[:90], ms) for n, ms in sorted(
            kernels.items(), key=lambda kv: -kv[1])[:10]])
    return out


# ---------------------------------------------------------------------------
# 4d, 4e: HuggingFace checkpoints at Qwen3-0.6B and Qwen1.5-MoE-A2.7B width,
# imported over HTTP
# ---------------------------------------------------------------------------

# The published Qwen/Qwen3-0.6B config.json (its architecture keys), its
# 28 layers cut to QWEN3_LAYERS (14 at first, 4 with phase 4j, 2 with
# phase 4k) so the whole script stays within 950 s;
# every width is the published one.
QWEN3_CONFIG = {
    "architectures": ["Qwen3ForCausalLM"], "attention_bias": False,
    "attention_dropout": 0.0, "bos_token_id": 151643,
    "eos_token_id": 151645, "head_dim": 128, "hidden_act": "silu",
    "hidden_size": 1024, "initializer_range": 0.02,
    "intermediate_size": 3072, "max_position_embeddings": 40960,
    "max_window_layers": 28, "model_type": "qwen3",
    "num_attention_heads": 16, "num_hidden_layers": 28,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-06, "rope_scaling": None,
    "rope_theta": 1000000, "sliding_window": None,
    "tie_word_embeddings": True, "torch_dtype": "bfloat16",
    "use_cache": True, "use_sliding_window": False, "vocab_size": 151936}
# The published Qwen/Qwen1.5-MoE-A2.7B config.json (its architecture keys),
# its 24 layers cut to QMOE_LAYERS so the import fits the script's time;
# every width is the published one.
QMOE_CONFIG = {
    "architectures": ["Qwen2MoeForCausalLM"], "attention_dropout": 0.0,
    "bos_token_id": 151643, "decoder_sparse_step": 1,
    "eos_token_id": 151643, "hidden_act": "silu", "hidden_size": 2048,
    "initializer_range": 0.02, "intermediate_size": 5632,
    "max_position_embeddings": 8192, "max_window_layers": 21,
    "model_type": "qwen2_moe", "moe_intermediate_size": 1408,
    "norm_topk_prob": False, "num_attention_heads": 16,
    "num_experts": 60, "num_experts_per_tok": 4, "num_hidden_layers": 24,
    "num_key_value_heads": 16, "output_router_logits": False,
    "rms_norm_eps": 1e-06, "rope_theta": 1000000.0,
    "router_aux_loss_coef": 0.001, "shared_expert_intermediate_size": 5632,
    "sliding_window": 32768, "tie_word_embeddings": False,
    "torch_dtype": "bfloat16", "use_cache": True,
    "use_sliding_window": False, "vocab_size": 151936}
QWEN3_LAYERS = 2
QMOE_LAYERS = 2
# The imported checkpoints: phase name, model id, config as written, title.
HF_MODELS = {
    "qwen3": dict(config=dict(QWEN3_CONFIG, num_hidden_layers=QWEN3_LAYERS),
                  title="Qwen3-0.6B",
                  dir="hf_qwen3_0.6b"),
    "qmoe": dict(config=dict(QMOE_CONFIG, num_hidden_layers=QMOE_LAYERS),
                 title="Qwen1.5-MoE-A2.7B", dir="hf_qwen1.5_moe_a2.7b"),
}
QWEN3_SHARDS = 2
QWEN3_BLOCK = 1024
QWEN3_LONG_PROMPT = 1000
QWEN3_LONG_NEW = 24
QWEN3_CB_PROMPT_LENS = (16, 200, 500, 900)
QWEN3_CB_NEW = 64
# The card's logits against the port's CPU forward of the same bf16
# weights: at 8 positions spread over the 128-token prompt.  Tolerance:
# each bf16 forward rounds its activations at the same points and deviates
# from the fp32 forward of those weights by rounding alone; the CPU's
# deviation e_cpu is measured here (its bf16 forward against its fp32
# forward).  The card's kernels round once more (the attention kernels'
# probabilities to bf16 before P.V, FLASH_C's reasoning), so its deviation
# is allowed twice e_cpu, and the two bf16 forwards may differ by
# e_cpu + 2 e_cpu = QWEN3_LOGIT_FACTOR * e_cpu.
QWEN3_REF_POSITIONS = 8
QWEN3_LOGIT_FACTOR = 3.0


def _hf_tensors(cfg):
    """(HF key, shape, kind) of every tensor of a Qwen3 (tied embeddings:
    no lm_head; q/k norms) or a Qwen2-MoE (q/k/v biases; each layer's
    router, experts, shared expert and its gate; an lm_head) checkpoint,
    in the HF layout."""
    moe = cfg["model_type"] == "qwen2_moe"
    d = cfg["hidden_size"]
    heads, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = cfg.get("head_dim") or d // heads
    out = [("model.embed_tokens.weight", (cfg["vocab_size"], d), "normal")]
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        out += [(f"{p}.input_layernorm.weight", (d,), "norm"),
                (f"{p}.self_attn.q_proj.weight", (heads * hd, d), "normal"),
                (f"{p}.self_attn.k_proj.weight", (kv * hd, d), "normal"),
                (f"{p}.self_attn.v_proj.weight", (kv * hd, d), "normal"),
                (f"{p}.self_attn.o_proj.weight", (d, heads * hd), "normal")]
        if moe:
            out += [(f"{p}.self_attn.{n}_proj.bias", (w * hd,), "normal")
                    for n, w in (("q", heads), ("k", kv), ("v", kv))]
        else:
            out += [(f"{p}.self_attn.q_norm.weight", (hd,), "norm"),
                    (f"{p}.self_attn.k_norm.weight", (hd,), "norm")]
        out.append((f"{p}.post_attention_layernorm.weight", (d,), "norm"))
        mlps = [(f"{p}.mlp", cfg["intermediate_size"])]
        if moe:
            out.append((f"{p}.mlp.gate.weight", (cfg["num_experts"], d),
                        "normal"))
            mlps = [(f"{p}.mlp.experts.{e}", cfg["moe_intermediate_size"])
                    for e in range(cfg["num_experts"])]
            mlps.append((f"{p}.mlp.shared_expert",
                         cfg["shared_expert_intermediate_size"]))
        for m, inter in mlps:
            out += [(f"{m}.gate_proj.weight", (inter, d), "normal"),
                    (f"{m}.up_proj.weight", (inter, d), "normal"),
                    (f"{m}.down_proj.weight", (d, inter), "normal")]
        if moe:
            out.append((f"{p}.mlp.shared_expert_gate.weight", (1, d),
                        "normal"))
    out.append(("model.norm.weight", (d,), "norm"))
    if not cfg["tie_word_embeddings"]:
        out.append(("lm_head.weight", (cfg["vocab_size"], d), "normal"))
    return out


def _write_safetensors(torch, path, tensors):
    """A safetensors file of bf16 CPU tensors: the 8-byte little-endian
    header length, the JSON header (padded to 8 bytes), the raw bytes."""
    header, offset = {}, 0
    for name, t in tensors:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": "BF16", "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, t in tensors:
            f.write(t.view(torch.int16).numpy().tobytes())


def write_hf_checkpoint(torch, path, cfg, seed=0, device="cuda"):
    """A checkpoint of config ``cfg`` from ``seed``: config.json (the
    published values, the depth as given), the weights as BF16
    safetensors in QWEN3_SHARDS shards with a model.safetensors.index.json.
    Projections, biases and the embedding ~ N(0, initializer_range) (the
    config's 0.02, as HF initializes them), norm weights ~ 1 + N(0, 0.1);
    drawn on the card from one generator.  Returns the bytes written."""
    os.makedirs(path, exist_ok=True)
    specs = _hf_tensors(cfg)
    sizes = [math.prod(shape) * 2 for _, shape, _ in specs]
    total = sum(sizes)
    groups, acc = [[]], 0
    for spec, size in zip(specs, sizes):
        if acc >= total * len(groups) / QWEN3_SHARDS \
                and len(groups) < QWEN3_SHARDS:
            groups.append([])
        groups[-1].append(spec)
        acc += size
    g = torch.Generator(device=device).manual_seed(seed)
    std = cfg["initializer_range"]
    weight_map = {}
    for n, group in enumerate(groups):
        fname = f"model-{n + 1:05d}-of-{len(groups):05d}.safetensors"
        tensors = []
        for name, shape, kind in group:
            t = torch.randn(shape, generator=g, device=device)
            t = t * std if kind == "normal" else 1.0 + 0.1 * t
            tensors.append((name, t.to(torch.bfloat16).cpu()))
        _write_safetensors(torch, os.path.join(path, fname), tensors)
        weight_map.update(dict.fromkeys((name for name, _ in tensors),
                                        fname))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f, indent=1)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    return total


def phase_import(torch, card, tag, device="cuda"):
    """A HuggingFace checkpoint of HF_MODELS[tag] (Qwen3-0.6B at
    QWEN3_LAYERS, or Qwen1.5-MoE-A2.7B at QMOE_LAYERS; full widths, random
    bf16 weights from seed 0, written here in the HF layout) through
    POST /import/,
    served on the contiguous and paged caches, under continuous batching
    and by /output/, then deleted.  Returns (stats, {kernel: device runs
    or launches in this phase})."""
    import numpy as np

    from penroz_tpu_torch.models import decode_graphs as DG
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    hf = HF_MODELS[tag]
    cfg = hf["config"]
    vocab, n_attn = cfg["vocab_size"], cfg["num_hidden_layers"]
    block = QWEN3_BLOCK
    stats, launches = {}, {}
    ckpt = os.path.join(WORK, hf["dir"])
    t0 = time.monotonic()
    stats["checkpoint_bytes"] = write_hf_checkpoint(torch, ckpt, cfg,
                                                    device=device)
    stats["write_s"] = time.monotonic() - t0
    say(tag, f"wrote the {hf['title']}-shaped checkpoint, {n_attn} layers "
        f"({stats['checkpoint_bytes'] / 1e9:.3f} GB bf16, {QWEN3_SHARDS} "
        f"shards + index) in {stats['write_s']:.2f} s")
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, vocab, PROMPT_LEN).tolist()
    long_prompt = rng.integers(0, vocab, QWEN3_LONG_PROMPT).tolist()
    server = create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    try:
        status, text, secs = _post(base, "/import/", {
            "hf_repo_id": ckpt, "model_id": tag})
        check(status == 200, f"POST /import/ -> {status}: {text[:300]}")
        stats["import_s"] = secs
        status, text, _ = _post(base, f"/progress/?model_id={tag}", None,
                                method="GET")
        check(status == 200 and json.loads(text)["status"]["code"]
              == "Imported", f"/progress/ after the import: {text[:300]}")
        say(tag, f"POST /import/ 200 in {secs:.2f} s (read, remap, "
            f"bf16 cast, to the card, checkpoint written), status "
            f"Imported, on {card}")

        greedy = {"model_id": tag, "input": [prompt],
                  "block_size": block, "max_new_tokens": NEW_TOKENS,
                  "temperature": 0}
        DG.reset()
        _zero_decode_counts()
        http = _StepLedger()
        with http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200, f"/generate/ -> {status}: {text[:300]}")
        first = json.loads(text)["tokens"]
        check(len(first) == PROMPT_LEN + NEW_TOKENS
              and first[:PROMPT_LEN] == prompt
              and all(0 <= t < vocab for t in first),
              f"{tag} greedy output malformed")
        check(DG.STATS["captures"] == 1 and http.steps["decode_attention"]
              == 1 + NEW_TOKENS + DG.WARMUP_STEPS,
              f"first request: {DG.STATS}, {http.steps}")
        stats["greedy_request_s"] = secs
        with http.request():
            status, text, secs = _post(base, "/generate/", greedy)
        check(status == 200 and json.loads(text)["tokens"] == first,
              f"{tag} greedy /generate/ not deterministic")
        check(DG.STATS["captures"] == 1,
              f"the second {tag} request captured again")
        stats["greedy_request_s_2"] = secs
        long_body = dict(greedy, input=[long_prompt],
                         max_new_tokens=QWEN3_LONG_NEW)
        # Qwen3's only: each request of the MoE model loads its 3.5 GB
        # checkpoint (cut for the script's time; its long prompt runs in
        # process below, the graph path against the eager step loop)
        long_tokens, more = None, ""
        if tag != "qmoe":
            with http.request():
                streamed, ttft, secs = _stream(base, greedy)
            check(streamed == first[PROMPT_LEN:],
                  f"{tag} stream != non-stream")
            stats.update(stream_first_token_s=ttft, stream_request_s=secs)
            with http.request():
                status, text, secs = _post(base, "/generate/", long_body)
            long_tokens = json.loads(text)["tokens"] if status == 200 else []
            check(len(long_tokens) == QWEN3_LONG_PROMPT + QWEN3_LONG_NEW
                  and long_tokens[:QWEN3_LONG_PROMPT] == long_prompt,
                  f"{tag} {QWEN3_LONG_PROMPT}-token prompt -> {status}: "
                  f"{text[:300]}")
            stats["long_prompt_request_s"] = secs
            more = (f", streamed (first token {ttft:.3f} s), "
                    f"{QWEN3_LONG_PROMPT}+{QWEN3_LONG_NEW} in {secs:.3f} s")
        wrapper, ran = _check_launches(n_attn, http, f"{tag} HTTP, "
                                       "contiguous cache")
        launches["decode_attention"] = ran["decode_attention"]
        say(tag, f"greedy {PROMPT_LEN}+{NEW_TOKENS} twice (identical; "
            f"{stats['greedy_request_s']:.3f} s with the capture, "
            f"{stats['greedy_request_s_2']:.3f} s without, checkpoint load "
            f"included){more}; the device ran the "
            f"decode kernel {ran['decode_attention']} times = {n_attn} x "
            f"{http.steps['decode_attention']} dispatched steps, the wrapper "
            f"launched it {wrapper['decode_attention']} times")

        _zero_decode_counts()
        http_p = _StepLedger()
        with _env({"PAGED_KV_CACHE": "1"}):
            with http_p.request():
                status, text, secs = _post(base, "/generate/", greedy)
            check(status == 200 and json.loads(text)["tokens"] == first,
                  f"{tag} paged /generate/ -> {status}: tokens differ from "
                  f"the contiguous cache's")
            stats["paged_request_s"] = secs
            # Qwen3's only: each request of the MoE model loads its 3.5 GB
            # checkpoint (cut for the script's time; its paged tokens are
            # held in process below too)
            paged_what = "greedy"
            if tag != "qmoe":
                with http_p.request():
                    streamed, _, _ = _stream(base, greedy)
                check(streamed == first[PROMPT_LEN:],
                      f"{tag} paged stream != the contiguous tokens")
                with http_p.request():
                    status, text, _ = _post(base, "/generate/", long_body)
                check(status == 200 and json.loads(text)["tokens"]
                      == long_tokens, f"{tag} paged long prompt: tokens "
                      "differ from the contiguous cache's")
                paged_what = (f"greedy, streamed, {QWEN3_LONG_PROMPT}-token "
                              f"prompt")
        wrapper, ran = _check_launches(n_attn, http_p, f"{tag} HTTP, paged "
                                       "pool")
        launches["paged_decode_attention"] = ran["paged_decode_attention"]
        say(tag, f"PAGED_KV_CACHE=1: the contiguous cache's tokens "
            f"({paged_what}); the "
            f"device ran the paged kernel {ran['paged_decode_attention']} "
            f"times = {n_attn} x {http_p.steps['paged_decode_attention']} "
            f"dispatched steps")

        # in process: the eager step loop gives the graph path's tokens on
        # both caches; decode rates with the model loaded
        _zero_decode_counts()
        ledger = _StepLedger()
        t0 = time.monotonic()
        model = NeuralNetworkModel.deserialize(tag, device=device,
                                               optimizer=False)
        torch.cuda.synchronize()
        stats["checkpoint_load_s"] = time.monotonic() - t0
        check(model.dtype == torch.bfloat16, f"imported dtype {model.dtype}")
        for name, env, body, want in (
                ("contiguous", {}, greedy, first),
                ("long prompt", {}, long_body, long_tokens),
                ("paged", {"PAGED_KV_CACHE": "1"}, greedy, first)):
            for graphs in (True, False):
                with _env(env), _graphs(graphs), ledger.request():
                    got = model.generate_tokens(
                        body["input"], block, body["max_new_tokens"],
                        temperature=0)
                if want is None:    # no HTTP reference: the graph path's
                    want = got
                    check(len(got) == QWEN3_LONG_PROMPT + QWEN3_LONG_NEW
                          and got[:QWEN3_LONG_PROMPT] == long_prompt,
                          f"{tag} {name}: generate_tokens output malformed")
                check(got == want, f"{tag} {name}: generate_tokens with "
                      f"graphs {'on' if graphs else 'off'} != the HTTP "
                      f"tokens")
        timing = {}
        for name, env in (("graph", {}), ("paged_graph",
                                          {"PAGED_KV_CACHE": "1"})):
            with _env(env), ledger.request():
                out, timing[name] = _decode_timing(torch, model, prompt,
                                                   block, graphs=True)
            check(out == first, f"{tag} {name} timing run != the HTTP "
                  f"tokens")
        if tag != "qmoe":   # the MoE model's eager rate: cut for the time
            with ledger.request():
                out, timing["eager"] = _decode_timing(torch, model, prompt,
                                                      block, graphs=False)
            check(out == first, f"{tag} eager timing run != the HTTP "
                  f"tokens")
            stats["eager_tokens_per_s"] = timing["eager"]["tokens_per_s"]
        _check_launches(n_attn, ledger, f"{tag} in process")
        stats["decode"] = timing
        stats["tokens_per_s"] = timing["graph"]["tokens_per_s"]
        stats["paged_tokens_per_s"] = timing["paged_graph"]["tokens_per_s"]
        say(tag, f"checkpoint load (deserialize to the card) "
            f"{stats['checkpoint_load_s']:.2f} s; graph == eager in process "
            f"on the contiguous and paged caches and the long prompt")
        for name, t in timing.items():
            say(tag, f"generate_tokens {PROMPT_LEN}+{NEW_TOKENS} {name}: "
                f"{t['s']:.4f} s = {t['tokens_per_s']:.1f} tokens/s (median "
                f"of 3; prefill alone {t['prefill_s']:.4f} s); traced: "
                f"{_trace_text(t)}, on {card}")

        # /output/ at 1 x 1024: the flash forward, once per layer
        FA.flash_forward.launches = 0
        out_input = rng.integers(0, vocab, (1, block)).tolist()
        status, text, secs = _post(base, "/output/", {
            "model_id": tag, "input": out_input})
        launches["flash_attention_fwd"] = FA.flash_forward.launches
        check(status == 200, f"/output/ -> {status}: {text[:300]}")
        probs = np.asarray(json.loads(text)["output"], np.float64)
        check(probs.shape == (1, vocab) and np.isfinite(probs).all()
              and abs(probs.sum() - 1.0) < 1e-2,
              f"/output/ returned shape {probs.shape}, sum {probs.sum()}")
        check(launches["flash_attention_fwd"] == n_attn,
              f"/output/ launched the flash forward "
              f"{launches['flash_attention_fwd']} times, not {n_attn}")
        stats["output_1x1024_request_s"] = secs
        say(tag, f"/output/ 1 x {block}: softmax over {vocab} sums to "
            f"{probs.sum():.4f}, {n_attn} flash-forward launches, "
            f"{secs:.3f} s (checkpoint load included)")

        stats.update(_hf_cpu_reference(torch, model, tag, prompt, device))
        tol = stats["logits_tolerance"]
        say(tag, f"card vs CPU bf16 forward of the same weights at "
            f"{QWEN3_REF_POSITIONS} positions: max abs err "
            f"{stats['logits_max_abs_err']:.4e} (tolerance {tol:.4e} = "
            f"{QWEN3_LOGIT_FACTOR:g} x the CPU bf16 forward's "
            f"{stats['cpu_bf16_vs_fp32']:.4e} from its fp32 forward; "
            f"logits up to {stats['logits_max_abs']:.3f}); top-1 equal at "
            f"{stats['top1_equal']}/{QWEN3_REF_POSITIONS}")
        check(stats["logits_max_abs_err"] <= tol,
              f"card vs CPU logits differ by "
              f"{stats['logits_max_abs_err']:.3e} > {tol:.3e}")
        del model
        torch.cuda.empty_cache()

        cb_stats, launches["ragged_paged_attention"] = _hf_continuous(
            torch, base, tag, n_attn, vocab, block, tol, device)
        stats["continuous"] = cb_stats

        status, _, _ = _post(base, f"/model/?model_id={tag}", None,
                             method="DELETE")
        check(status == 204, f"DELETE /model/ -> {status}")
        check(_post(base, "/generate/", greedy)[0] == 404,
              "/generate/ after DELETE is not a 404")
        say(tag, f"DELETE /model/ 204, then 404; runs and launches in "
            f"this phase {launches}")
    finally:
        DS.reset()
        DG.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
        shutil.rmtree(ckpt, ignore_errors=True)
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


def _hf_cpu_reference(torch, model, tag, prompt, device):
    """The card's no-cache forward (the flash kernel) against the port's
    CPU forward of the same bf16 weights at QWEN3_REF_POSITIONS positions
    of ``prompt``, and the CPU fp32 forward of those weights, which sets
    the tolerance (QWEN3_LOGIT_FACTOR)."""
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    T = len(prompt)
    at = [round(i * (T - 1) / (QWEN3_REF_POSITIONS - 1))
          for i in range(QWEN3_REF_POSITIONS)]
    x = torch.tensor([prompt])
    with torch.inference_mode():
        card, _, _ = model.arch(x.to(device), skip_softmax=True)
        card = card[-1][0, at].float().cpu()
    t0 = time.monotonic()
    cpu_model = NeuralNetworkModel.deserialize(tag, device="cpu",
                                               optimizer=False)
    with torch.inference_mode():
        bf16, _, _ = cpu_model.arch(x, skip_softmax=True)
        bf16 = bf16[-1][0, at].float()
        for p in cpu_model.arch.parameters():
            p.data = p.data.float()
        fp32, _, _ = cpu_model.arch(x, skip_softmax=True)
        fp32 = fp32[-1][0, at]
    cpu_s = time.monotonic() - t0
    e_cpu = float((bf16 - fp32).abs().max())
    return {"logits_max_abs_err": float((card - bf16).abs().max()),
            "card_vs_cpu_fp32": float((card - fp32).abs().max()),
            "cpu_bf16_vs_fp32": e_cpu,
            "logits_tolerance": QWEN3_LOGIT_FACTOR * e_cpu,
            "logits_max_abs": float(fp32.abs().max()),
            "top1_equal": int((card.argmax(-1) == bf16.argmax(-1)).sum()),
            "reference_positions": at, "cpu_reference_s": cpu_s}


def _hf_continuous(torch, base, tag, n_attn, vocab, block, logit_tol,
                   device):
    """4 concurrent greedy /generate/ under PAGED_KV_CACHE=1
    PENROZ_CONTINUOUS_BATCHING=1 (prompts of QWEN3_CB_PROMPT_LENS tokens,
    QWEN3_CB_NEW new): the ragged kernel once per attention layer per
    mixed step, and every generated token the argmax of the plain no-cache
    forward over its prefix (bf16, the plain attention patched in) within
    ARGMAX_ATOL, or, where the plain forward's two best logits lie closer
    than 2 x ``logit_tol`` (two bf16 forwards' logits may each be off by
    ``logit_tol``), within 2 x ``logit_tol``.  Returns (stats, ragged
    kernel launches)."""
    import numpy as np

    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import decode_scheduler as DS

    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, vocab, n).tolist()
               for n in QWEN3_CB_PROMPT_LENS]
    bodies = [{"model_id": tag, "input": [p], "block_size": block,
               "max_new_tokens": QWEN3_CB_NEW, "temperature": 0}
              for p in prompts]
    stats = {}
    with _env(CB_ENV):
        status, text, _ = _post(base, "/generate/", dict(
            bodies[0], max_new_tokens=2))
        check(status == 200, f"{tag} continuous warm-up -> {status}: "
              f"{text[:300]}")
        serving = json.loads(_post(base, "/serving_stats/", None,
                                   method="GET")[1])
        steps_before = sum(t["superstep"] for t in serving["tick_timeline"])
        for fn in (RPA.ragged_paged_attention, PA.paged_decode_attention,
                   DA.decode_attention):
            fn.launches = 0
        results = [None] * len(bodies)

        def fire(i):
            status, text, secs = _post(base, "/generate/", bodies[i])
            out = json.loads(text)["tokens"] if status == 200 else []
            if len(out) == len(prompts[i]) + QWEN3_CB_NEW:
                results[i] = (out, secs)

        t0 = time.monotonic()
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        stats["concurrent_s"] = time.monotonic() - t0
        ragged = RPA.ragged_paged_attention.launches
        single = (PA.paged_decode_attention.launches
                  + DA.decode_attention.launches)
        serving = json.loads(_post(base, "/serving_stats/", None,
                                   method="GET")[1])
    check(all(r is not None for r in results),
          f"a {tag} concurrent request failed or came back short")
    steps = sum(t["superstep"] for t in serving["tick_timeline"]) \
        - steps_before
    check(ragged == n_attn * steps, f"{tag}: the ragged kernel launched "
          f"{ragged} times, expected {n_attn} x {steps} mixed steps")
    check(single == 0, "a single-sequence kernel launched under continuous "
          "batching")
    model = DS.get_engine(tag, block, 0, None, device=device)._model
    gaps, near_ties = [], 0
    with torch.inference_mode(), plain_kernels():
        for (out, _), prompt in zip(results, prompts):
            n = len(prompt)
            check(out[:n] == prompt, f"a {tag} result lost its prompt")
            x = torch.tensor([out[:-1]], device=device)
            acts, _, _ = model.arch(x, skip_softmax=True)
            logits = acts[-1][0, n - 1:].float()
            top2 = logits.topk(2, dim=-1).values
            gen = torch.tensor(out[n:], device=device)
            gap = top2[:, 0] - logits.gather(-1, gen[:, None])[:, 0]
            tie = (top2[:, 0] - top2[:, 1]) <= 2 * logit_tol
            near_ties += int(tie.sum())
            bound = torch.where(tie, torch.full_like(gap, 2 * logit_tol),
                                torch.full_like(gap, ARGMAX_ATOL))
            check(bool((gap <= bound).all()), f"{tag} continuous: a token "
                  f"{float((gap - bound).max()):.3e} past its bound below "
                  f"the top logit of the plain forward")
            gaps.append(gap)
    gaps = torch.cat(gaps)
    stats.update(
        tokens_per_s=len(bodies) * QWEN3_CB_NEW / stats["concurrent_s"],
        latency_s=[secs for _, secs in results], mixed_steps=steps,
        argmax_exact=int((gaps <= ARGMAX_ATOL).sum()),
        tokens=int(gaps.numel()), near_ties=near_ties,
        worst_gap=float(gaps.max()))
    say(tag, f"continuous batching: {len(bodies)} concurrent requests "
        f"(prompts {QWEN3_CB_PROMPT_LENS}, {QWEN3_CB_NEW} new) in "
        f"{stats['concurrent_s']:.3f} s = {stats['tokens_per_s']:.1f} "
        f"tokens/s; {steps} mixed steps, {ragged} ragged launches; "
        f"{stats['argmax_exact']}/{stats['tokens']} tokens the plain "
        f"forward's argmax within {ARGMAX_ATOL}, {near_ties} near ties "
        f"(top-2 within {2 * logit_tol:.3e}), worst gap "
        f"{stats['worst_gap']:.3e}")
    return stats, ragged


# ---------------------------------------------------------------------------
# 5: training over HTTP
# ---------------------------------------------------------------------------

def _training_counters():
    from penroz_tpu_torch.ops.kernels import cross_entropy as CE
    from penroz_tpu_torch.ops.kernels import flash_attention as FA
    return {"flash_attention_fwd": FA.flash_forward,
            "flash_attention_bwd": FA.flash_backward,
            "ce_forward": CE.ce_forward, "ce_backward": CE.ce_backward}


def phase_training(torch, layers, optimizer, vocab, card,
                   model_id="smoke_train", tag="training", then=None):
    """Train ``layers`` (GPT-2 124M; phase 5b's MoE model) over HTTP, then
    ``then(base, model_id, outs)`` while the server runs, with the trained
    model's greedy tokens; returns (stats, launch counts)."""
    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    _write_train_shard()
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
            "model_id": model_id, "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        body = {"model_id": model_id, "dataset_id": "smoke", "shard": 0,
                "epochs": TRAIN_EPOCHS, "batch_size": TRAIN_BATCH,
                "block_size": TRAIN_BLOCK, "step_size": TRAIN_STEP}
        for fn in counters.values():
            fn.launches = 0
        t0 = time.monotonic()
        status, text, _ = _post(base, "/train/", body, method="PUT")
        check(status == 202, f"PUT /train/ -> {status}: {text[:300]}")
        status, text, _ = _post(base, "/train/", body, method="PUT")
        check(status == 409, f"second PUT /train/ -> {status}, not 409")
        say(tag, f"PUT /train/ 202, again 409; {TRAIN_EPOCHS} epochs "
            f"x {num_steps} micro-steps of {TRAIN_BATCH} x {TRAIN_BLOCK}")
        progress = None
        while time.monotonic() - t0 < 900:
            status, text, _ = _post(base, f"/progress/?model_id={model_id}",
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
        say(tag, f"Trained; costs {[round(c, 4) for c in costs]}; "
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
        say(tag, f"epochs 2-{TRAIN_EPOCHS}: "
            f"{sum(stats['epoch_s']) / len(later):.4f} s an epoch, "
            f"{stats['tokens_per_s']:.0f} tokens/s trained (speedPerSec, "
            f"which counts one buffer an epoch: "
            f"{sum(stats['speed_per_s']) / len(later):.0f}) on {card}")

        prompt = list(range(1, 33))
        greedy = {"model_id": model_id, "input": [prompt],
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
        say(tag, "greedy /generate/ of the trained model: identical "
            "twice")
        if then is not None:
            stats.update(then(base, model_id, outs[0]))
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        server.join_training(timeout=60)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats, launches


# Phase 5's training options: rematerialization, the worker process and
# decode priority, on phase 5's trained GPT-2 124M checkpoint (bf16
# micro-steps of TRAIN_BATCH x TRAIN_BLOCK).  A remat epoch's cost equals
# the plain epoch's within REMAT_RTOL (the same bf16 forward replayed on
# the same inputs, whose products need not round alike run to run).
REMAT_RTOL = 2.0 ** -8
OPTS_WORKER_EPOCHS = 2
OPTS_TTFT_EPOCHS = 120
OPTS_TTFT_PROMPT, OPTS_TTFT_NEW = 32, 8
# The HTTP runs train a small GPT (d 256, 4 heads, 4 blocks, vocab
# TRAIN_VOCAB_USED, block TRAIN_BLOCK) at 2 x TRAIN_BLOCK, two micro-steps
# an epoch: the end of a run refreshes /stats/ (numpy histograms of every
# weight and activation, ~16 s for GPT-2 124M), which the worker and the
# priority runs would pay three times.
OPTS_LAYERS = dict(d=256, heads=4, depth=4, vocab=TRAIN_VOCAB_USED,
                   block=TRAIN_BLOCK)
OPTS_BATCH, OPTS_STEP = 2, 1


def phase_train_options(torch, vocab, card, model_id="smoke_train"):
    """(a) PENROZ_REMAT=1 in process: one epoch from phase 5's checkpoint
    with and without remat on the same micro-batches and seeds: costs
    within REMAT_RTOL, the flash forward launched twice as often, peak
    device memory and epoch time of each.  On a small GPT (OPTS_LAYERS,
    created here): (b) PENROZ_TRAIN_WORKER=1 over HTTP:
    a 2-epoch run in the child process ends Trained; a long run whose
    child is killed ends Error with the JAX package's message while
    /generate/ still answers; a checkpoint left at Training reads Error
    after a server starts (the orphan sweep).  (c) A streamed /generate/
    during an in-process training run, PENROZ_DECODE_PRIORITY_MS at 1000
    and then at 0, and after it: each one's time to first token
    (recorded, no gate).  Returns stats."""
    import numpy as np

    from penroz_tpu_torch.models import model as model_mod
    from penroz_tpu_torch.models.model import (NeuralNetworkModel,
                                               train_compute_dtype)
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    stats = {}
    counters = _training_counters()
    rng = np.random.default_rng(7)
    num_steps = TRAIN_BATCH // TRAIN_STEP
    xs = torch.as_tensor(rng.integers(0, TRAIN_VOCAB_USED, (
        num_steps, TRAIN_BATCH, TRAIN_BLOCK)), device="cuda")
    ys = torch.roll(xs, -1, dims=-1)
    runs = {}
    for remat in (False, True):
        model = NeuralNetworkModel.deserialize(model_id, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(0)
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        cost, _ = model.arch.train_epoch(
            model.optimizer, xs, ys,
            compute_dtype=train_compute_dtype(model.device), generator=gen,
            with_ratios=False, remat=remat)
        cost = float(cost)
        torch.cuda.synchronize()
        runs[remat] = {"cost": cost, "s": time.monotonic() - t0,
                       "peak_bytes": torch.cuda.max_memory_allocated(),
                       "launches": {k: fn.launches
                                    for k, fn in counters.items()}}
        del model
        torch.cuda.empty_cache()
    plain, remat = runs[False], runs[True]
    rel = abs(remat["cost"] - plain["cost"]) / abs(plain["cost"])
    fwd = (plain["launches"]["flash_attention_fwd"],
           remat["launches"]["flash_attention_fwd"])
    stats["remat"] = {"plain": plain, "remat": remat, "cost_rel_diff": rel}
    say("train_options", f"PENROZ_REMAT=1 epoch ({num_steps} bf16 "
        f"micro-steps of {TRAIN_BATCH} x {TRAIN_BLOCK}): cost "
        f"{remat['cost']:.6f} vs plain {plain['cost']:.6f} (rel {rel:.2e}, "
        f"<= {REMAT_RTOL:g}); flash forward launches {fwd[1]} vs {fwd[0]}; "
        f"peak {remat['peak_bytes'] / 1e9:.2f} GB vs "
        f"{plain['peak_bytes'] / 1e9:.2f} GB; {remat['s']:.3f} s vs "
        f"{plain['s']:.3f} s (first epochs of fresh loads) on {card}")
    check(rel <= REMAT_RTOL, f"remat cost differs by {rel:.3e}")
    check(fwd[1] == 2 * fwd[0] > 0, f"flash forward launches {fwd}: not "
          f"doubled under remat")
    check(remat["launches"]["flash_attention_bwd"]
          == plain["launches"]["flash_attention_bwd"],
          "remat changed the backward's launches")

    from penroz_tpu_torch.models import presets
    model_id = "smoke_opts"
    body = {"model_id": model_id, "dataset_id": "smoke", "shard": 0,
            "epochs": OPTS_WORKER_EPOCHS, "batch_size": OPTS_BATCH,
            "block_size": TRAIN_BLOCK, "step_size": OPTS_STEP}

    def progress():
        status, text, _ = _post(base, f"/progress/?model_id={model_id}",
                                None, method="GET")
        check(status == 200, f"/progress/ -> {status}")
        return json.loads(text)

    def wait(codes, at_least=0, timeout=600):
        t0 = time.monotonic()
        while time.monotonic() - t0 < timeout:
            p = progress()
            if p["status"]["code"] in codes and len(
                    p["progress"]) >= at_least:
                return p
            time.sleep(0.2)
        raise SmokeFailure(f"/progress/ never reached {codes}")

    def ttft():
        t0 = time.monotonic()
        toks, first, _ = _stream(base, {
            "model_id": model_id, "input": [list(range(1, 1 +
                                                       OPTS_TTFT_PROMPT))],
            "block_size": TRAIN_BLOCK, "max_new_tokens": OPTS_TTFT_NEW,
            "temperature": 0})
        check(len(toks) == OPTS_TTFT_NEW, "a /generate/ came back short")
        return first, time.monotonic() - t0

    server = create_app(device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    try:
        status, text, _ = _post(base, "/model/", {
            "model_id": model_id, "layers": presets.gpt2_custom(
                **OPTS_LAYERS), "optimizer": presets.ADAMW})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        with _env({"PENROZ_TRAIN_WORKER": "1"}):
            t0 = time.monotonic()
            status, text, _ = _post(base, "/train/", body, method="PUT")
            check(status == 202, f"worker PUT /train/ -> {status}: {text}")
            check(server.join_training(timeout=300), "worker run still on")
            stats["worker_run_s"] = time.monotonic() - t0
            done = progress()
            check(done["status"]["code"] == "Trained" and len(
                done["progress"]) == OPTS_WORKER_EPOCHS,
                f"the worker's run ended {done['status']} with "
                f"{len(done['progress'])} epochs")
            say("train_options", f"PENROZ_TRAIN_WORKER=1: {OPTS_WORKER_EPOCHS}"
                f" epochs in the child ended Trained in "
                f"{stats['worker_run_s']:.1f} s (its start, the checkpoint "
                f"load and the run), costs "
                f"{[round(p['cost'], 4) for p in done['progress']]}")
            status, text, _ = _post(base, "/train/",
                                    dict(body, epochs=100000), method="PUT")
            check(status == 202, f"worker PUT /train/ -> {status}")
            wait({"Training"})
            proc = model_mod._TRAIN_WORKERS.get(model_id)
            check(proc is not None, "no live worker to kill")
            proc.kill()
            check(server.join_training(timeout=300), "killed run still on")
            dead = progress()["status"]
        check(dead["code"] == "Error" and dead["message"].startswith(
            "Training worker died (rc="), f"a killed worker left {dead}")
        t_first, t_all = ttft()
        say("train_options", f"a worker killed mid-run: status {dead}; "
            f"/generate/ then answered ({t_all:.3f} s)")
        checkpoint.patch_meta(model_id, {"status": {"code": "Training",
                                                    "message": "x"}})
        probe = create_app(device="cuda")
        probe.server_close()
        swept = checkpoint.peek_tree(model_id)["status"]
        check(swept == {"code": "Error", "message":
                        "Training interrupted by server restart"},
              f"the orphan sweep left {swept}")
        say("train_options", f"a checkpoint left at Training reads {swept} "
            f"after a server starts")
        stats["worker"] = {"killed_status": dead, "swept_status": swept}

        # (c) a /generate/ during training, the priority window on, then off
        idle = ttft()
        status, _, _ = _post(base, "/train/", dict(
            body, epochs=OPTS_TTFT_EPOCHS), method="PUT")
        check(status == 202, f"PUT /train/ -> {status}")
        wait({"Training"})
        times = {"idle": idle}
        for cap in ("1000", "0"):
            with _env({"PENROZ_DECODE_PRIORITY_MS": cap}):
                times[cap] = ttft()
        p = progress()
        check(p["status"]["code"] == "Training",
              "training ended before both requests")
        check(server.join_training(timeout=600), "training still running")
        check(progress()["status"]["code"] == "Trained", "the run failed")
        stats["ttft_s"] = {k: v[0] for k, v in times.items()}
        say("train_options", f"TTFT of a streamed /generate/ "
            f"({OPTS_TTFT_PROMPT} + {OPTS_TTFT_NEW}): idle {idle[0]:.4f} s; "
            f"during training, PENROZ_DECODE_PRIORITY_MS=1000 "
            f"{times['1000'][0]:.4f} s, =0 {times['0'][0]:.4f} s (no gate) "
            f"on {card}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        server.join_training(timeout=60)
        checkpoint.join_flushes()
    return stats


# Phase 5b's model: GPT-2 width (d 768, 12 heads, vocab 50304, block
# 1024) at 1 block whose MLP is a ``moe`` layer: 8 experts of width
# 3072, top-2, capacity dispatch at 1.25, load-balance coefficient 0.01
# (1 block keeps the script inside its time).
MOE_TRAIN = dict(d=768, heads=12, depth=1, vocab=50304, block=1024)
MOE_ARGS = dict(num_experts=8, top_k=2, intermediate_size=3072,
                dispatch="capacity", capacity_factor=1.25,
                aux_loss_coef=0.01)


def moe_train_layers():
    """presets.gpt2_custom at MOE_TRAIN with each block's MLP a ``moe``."""
    from penroz_tpu_torch.models import presets
    d = MOE_TRAIN["d"]
    layers = presets.gpt2_custom(**MOE_TRAIN)
    for entry in layers:
        if "residual" in entry:
            entry["residual"][1] = {"sequential": [
                {"layernorm": {"normalized_shape": d}},
                {"moe": dict(MOE_ARGS, in_features=d)}]}
    return layers


@contextlib.contextmanager
def _blocked(module):
    """``import module`` raises ModuleNotFoundError in this process for
    the duration."""
    saved = sys.modules.get(module)
    sys.modules[module] = None
    try:
        yield
    finally:
        if saved is None:
            del sys.modules[module]
        else:
            sys.modules[module] = saved


def _moe_after_training(base, model_id, tokens):
    """Phase 5b's checks on the trained MoE model, the server running:
    GET /stats/ carries ``moe_router_fractions``, one entry a ``moe``
    layer of num_experts finite values summing to 1 (within 1e-5); the
    greedy tokens again under PAGED_KV_CACHE=1; a POST /dataset/ ends
    ``failed`` with a ModuleNotFoundError, and the server still answers.
    The ``datasets`` module is blocked in this process (the server runs
    in it) for the request: the card's machine has one, and a download
    through it would reach for the network."""
    status, text, _ = _post(base, f"/stats/?model_id={model_id}", None,
                            method="GET")
    check(status == 200, f"/stats/ -> {status}: {text[:300]}")
    routing = json.loads(text).get("moe_router_fractions") or {}
    E = MOE_ARGS["num_experts"]
    check(len(routing) == MOE_TRAIN["depth"]
          and all(len(v) == E and all(math.isfinite(x) for x in v)
                  and abs(sum(v) - 1.0) <= 1e-5 for v in routing.values()),
          f"moe_router_fractions malformed: {routing}")
    say("moe_training", "GET /stats/: moe_router_fractions "
        + "; ".join(f"{k.split('.')[1]}: max {max(v):.3f} min {min(v):.3f}"
                    for k, v in routing.items()))
    prompt, new = tokens[:32], len(tokens) - 32
    with _env({"PAGED_KV_CACHE": "1"}):
        status, text, _ = _post(base, "/generate/", {
            "model_id": model_id, "input": [prompt],
            "block_size": MOE_TRAIN["block"], "max_new_tokens": new,
            "temperature": 0})
    check(status == 200 and json.loads(text)["tokens"] == tokens,
          f"paged /generate/ of the trained MoE model -> {status}: tokens "
          f"differ from the contiguous cache's")
    with _env({"PENROZ_DOWNLOAD_RETRIES": "2",
               "PENROZ_DOWNLOAD_BACKOFF_S": "0.1"}), _blocked("datasets"):
        status, text, _ = _post(base, "/dataset/", {
            "dataset_id": "smoke_download", "encoding": "byte",
            "path": "penroz/none", "split": "train", "shard_size": 1024})
        check(status == 202, f"POST /dataset/ -> {status}: {text[:300]}")
        t0, download = time.monotonic(), None
        while time.monotonic() - t0 < 60:
            doc = json.loads(_post(base, "/dataset/?dataset_id="
                                   "smoke_download", None, method="GET")[1])
            download = doc["download"]
            if download and download["state"] != "downloading":
                break
            time.sleep(0.1)
    check(download is not None and download["state"] == "failed"
          and download["error"].startswith("ModuleNotFoundError")
          and doc["files"] == [],
          f"POST /dataset/ without datasets ended {download}")
    check(_post(base, "/healthz", None, method="GET")[0] == 200,
          "the server stopped answering after the failed download")
    say("moe_training", f"greedy tokens equal on the paged cache; POST "
        f"/dataset/ 202, then {download['state']} after "
        f"{download['attempts']} attempts ({download['error'][:60]}); "
        f"/healthz still 200")
    return {"moe_router_fractions": routing, "dataset_download": download}


def phase_stats(torch, card):
    """GET /stats/ of the model phase 5 trained (refreshed at the end of
    training from its last TRAIN_BATCH x TRAIN_BLOCK micro-batch): one
    entry a non-softmax top-level layer and one a parameter, every number
    finite; an unknown model 404, no model_id 422.  Then the refresh in
    process on a STATS_BATCH x TRAIN_BLOCK batch, timed (the instrumented
    pass, then the host histograms, which grow with the batch), with its
    launches counted just around it: fp32 (the
    parameters' dtype), the flash forward and backward once per attention
    layer, cross-entropy forward and backward once."""
    import numpy as np

    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.serve.app import create_app
    from penroz_tpu_torch.utils import checkpoint

    server = create_app(device="cuda")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    stats = {}
    try:
        status, text, secs = _post(base, "/stats/?model_id=smoke_train",
                                   None, method="GET")
        check(status == 200, f"/stats/ -> {status}: {text[:300]}")
        doc = json.loads(text)
        model = NeuralNetworkModel.deserialize("smoke_train", device="cuda",
                                               optimizer=False)
        _check_stats_doc(doc, model)
        stats["request_s"] = secs
        status, _, _ = _post(base, "/stats/?model_id=nope", None,
                             method="GET")
        check(status == 404, f"/stats/ of an unknown model -> {status}")
        status, _, _ = _post(base, "/stats/", None, method="GET")
        check(status == 422, f"/stats/ without model_id -> {status}")
        say("stats", f"GET /stats/ 200 in {secs:.3f} s: "
            f"{len(doc['layers'])} layers, {len(doc['weights'])} weights, "
            f"all finite; unknown model 404, no model_id 422")

        rng = np.random.default_rng(5)
        x, y = (rng.integers(0, TRAIN_VOCAB_USED, (STATS_BATCH, TRAIN_BLOCK))
                for _ in range(2))
        counters = _training_counters()
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.monotonic()
        acts, _, _ = model.arch.stats_grads(
            *(torch.as_tensor(a, device=model.device) for a in (x, y)))
        torch.cuda.synchronize()
        stats["pass_s"] = time.monotonic() - t0
        del acts
        t0 = time.monotonic()
        local = model._compute_stats(x, y)
        stats["refresh_s"] = time.monotonic() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        n_attn = len(model.arch.attn_layers)
        check(launches == {name: 2 * (n_attn if "flash" in name else 1)
                           for name in counters},
              f"two /stats/ passes launched {launches}")
        _check_stats_doc(local, model)
        stats["launches_a_pass"] = {k: v // 2 for k, v in launches.items()}
        say("stats", f"refresh in process at {STATS_BATCH} x {TRAIN_BLOCK} "
            f"fp32: {stats['refresh_s']:.3f} s (the instrumented pass "
            f"{stats['pass_s']:.3f} s, the rest host histograms); a pass "
            f"launches {stats['launches_a_pass']}, on {card}")
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    return stats


# Kernel-name fragments of the port's training kernels in a profiler trace
# (the FMA and the tensor-core variants of each flash kernel).
TRAIN_KERNEL_KEYS = {"flash_fwd": "flash_fwd_", "flash_dq": "flash_dq_",
                     "flash_dkv": "flash_dkv_",
                     "ce_forward": "ce_forward_kernel",
                     "ce_backward": "ce_backward_kernel"}


def phase_train_profile(torch, layers, optimizer, vocab):
    """Where a training epoch's time goes: ``CompiledArch.train_epoch`` as
    PUT /train/ runs it above (two bf16 micro-steps of 4 x 1024, fp32
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
    kernels = _device_kernel_ms(torch, prof)
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
# 5d: training over ranks
# ---------------------------------------------------------------------------

# Phase 5d: RANKS_WORLD rank processes on the one card (parallel/dist.py's
# backend rule picks gloo: NCCL refuses two ranks on one device), each
# training GPT-2 124M (AdamW, bf16 compute) at RANKS_BATCH x TRAIN_BLOCK,
# step RANKS_STEP, for RANKS_EPOCHS epochs from one checkpoint: data
# parallelism, then PENROZ_WUS (ZeRO-1), then PENROZ_FSDP (ZeRO-3), then
# evaluate_model.  They read the rows one process reads at RANKS_WORLD x
# RANKS_BATCH, step RANKS_STEP x RANKS_WORLD^2: the reference, run at
# world 1 over NCCL.
RANKS_WORLD = 2
RANKS_BATCH, RANKS_STEP, RANKS_EPOCHS = 4, 1, 2
RANKS_MODES = (("dp", {}), ("wus", {"PENROZ_WUS": "1"}),
               ("fsdp", {"PENROZ_FSDP": "1"}))
# Costs against the reference, and the WUS and FSDP parameters against
# DP's: rtol 2^-7, one rounding step of the bf16 compute (a rank's
# products run at half the reference's rows, so cuBLAS may order their
# sums otherwise, and every activation is rounded to bf16); parameters
# also atol lr x epochs, the most AdamW moves an element in that many
# steps (what a near-zero gradient whose sign the rounding flips costs).
RANKS_RTOL = 2.0 ** -7
RANKS_TIMEOUT_S = 420


def _free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _tensor_digest(t) -> str:
    """dtype, shape and SHA-256 of the bytes of a tensor (bit equality)."""
    import hashlib

    import torch
    t = torch.as_tensor(t).detach().to("cpu").contiguous()
    h = hashlib.sha256(f"{t.dtype}{tuple(t.shape)}".encode())
    h.update(t.reshape(-1).view(torch.uint8).numpy().data)
    return h.hexdigest()


def _state_digests(params: dict, leaves: dict | None = None) -> dict:
    """Digests of a training state: ``p:{key}`` a parameter, ``o:{i}`` an
    optimizer leaf (hashed on 4 threads: hashlib lets go of the GIL)."""
    named = {f"p:{k}": v for k, v in params.items()}
    named.update({f"o:{i}": v for i, v in (leaves or {}).items()})
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        return dict(zip(named, pool.map(_tensor_digest, named.values())))


def _ranks_run(spec, batch, step) -> dict:
    return {"dataset_id": "smoke", "shard": 0, "epochs": RANKS_EPOCHS,
            "batch_size": batch, "block_size": spec["block"],
            "step_size": step}


def _held_expected(replicas) -> dict:
    """Bytes of parameters and moments a rank would hold with every leaf
    replicated, and with each leaf the rule cuts held as 1/world."""
    world = replicas.world
    out = {"params_replicated": 0, "moments_replicated": 0, "params_cut": 0,
           "moments_cut": 0, "leaves_whole": 0}
    for k in replicas.keys:
        numel = math.prod(replicas.shapes[k])
        own = replicas.shards[k] if replicas.stage else replicas.params[k]
        state = replicas.optimizer.state[own]
        moment_size = sum(v.element_size() for name, v in state.items()
                          if name != "step" and hasattr(v, "element_size"))
        param_size = replicas.params[k].element_size()
        cut = replicas.dims[k] is not None
        share = numel // world if cut else numel
        out["leaves_whole"] += not cut
        out["params_replicated"] += numel * param_size
        out["moments_replicated"] += numel * moment_size
        out["params_cut"] += share * param_size
        out["moments_cut"] += share * moment_size
    return out


def rank_worker(spec) -> int:
    """One rank of phase 5d (``chip_smoke.py --rank-worker SPEC``, started by
    phase_ranks with torchrun's environment): DP, WUS and FSDP runs from
    the checkpoint ``ranks_init``, then evaluate_model; its report goes to
    ``spec["report"] % rank``.  Any failure exits non-zero."""
    import gc

    import torch
    sys.path.insert(0, ROOT)
    os.chdir(spec["work"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cudnn.allow_tf32 = False
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.parallel import dist
    from penroz_tpu_torch.utils import checkpoint
    check(dist.initialize(timeout_s=RANKS_TIMEOUT_S),
          "MASTER_ADDR / WORLD_SIZE not picked up")
    cuda = spec["device"] == "cuda"
    rank = dist.process_index()
    sampled = os.environ.get("PENROZ_SMOKE_SAMPLER_DIR")
    if sampled:     # under scripts/smoke_sampler.py: sample this rank too
        sys.path.insert(0, os.path.join(ROOT, "scripts"))
        import smoke_sampler
        sampled = smoke_sampler.sample_main_thread(
            os.path.join(sampled, f"smoke_sampler_rank{rank}.txt"))
    report = {"rank": rank, "world": dist.process_count(),
              "backend": dist.backend(), "runs": {},
              "joined_s": time.time() - spec["started"]}
    counters = _training_counters()
    lr = spec["lr"]
    dp_params = None

    def load(mode):
        t0 = time.monotonic()
        model = NeuralNetworkModel.deserialize("ranks_init",
                                               device=spec["device"])
        model.model_id = f"ranks_{mode}"
        return model, time.monotonic() - t0

    # set up while phase_ranks runs the reference: the first run's model,
    # and torch.optim's first-use imports (a throwaway AdamW); then wait
    # until its epochs have ended
    loaded = load(RANKS_MODES[0][0])
    torch.optim.AdamW([torch.zeros(1, requires_grad=True)])
    _wait_for_file(spec["go"], RANKS_TIMEOUT_S)
    report["go_s"] = time.time() - spec["started"]
    for mode, env in RANKS_MODES:
        model, load_s = loaded or load(mode)
        loaded = None
        with _env(env):
            for fn in counters.values():
                fn.launches = 0
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.monotonic()
            model.train_model(**_ranks_run(spec, RANKS_BATCH, RANKS_STEP))
            if cuda:
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            launches = {k: fn.launches for k, fn in counters.items()}
        check(model.status["code"] == "Trained",
              f"rank {rank} {mode}: {model.status}")
        replicas = model._replicas
        replicas.release()          # stage 3: the layout between steps
        entry = {"load_s": load_s, "wall_s": wall, "stage": replicas.stage,
                 "launches": launches,
                 "stats_refreshed": model.stats is not None,
                 "peak_bytes": (torch.cuda.max_memory_allocated()
                                if cuda else None),
                 "held": replicas.held_bytes(),
                 "expected": _held_expected(replicas),
                 "collective_s": dict(replicas.clock.seconds),
                 "collective_calls": dict(replicas.clock.calls),
                 "progress": [[p["cost"], p["durationInSecs"]]
                              for p in model.progress]}
        t0 = time.monotonic()
        params, leaves = replicas.gather_state()
        # DP's gate is the parameters; a sharded run's state is held to
        # its reassembled shard files, the optimizer leaves too
        entry["digests"] = _state_digests(
            params, leaves if replicas.stage else None)
        entry["gather_s"] = time.monotonic() - t0
        if dp_params is None:
            dp_params = params
        else:
            worst, excess = 0.0, -math.inf
            for k, w in params.items():
                ref = dp_params[k].float()
                diff = (w.float() - ref).abs()
                worst = max(worst, float(diff.max()))
                excess = max(excess, float((diff - RANKS_RTOL * ref.abs()
                                            - lr * RANKS_EPOCHS).max()))
            entry["param_max_abs_diff_vs_dp"] = worst
            entry["param_excess_vs_dp"] = excess
        report["runs"][mode] = entry
        del model, replicas, params, leaves
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    model = NeuralNetworkModel.deserialize("ranks_dp", device=spec["device"],
                                           optimizer=False)
    for fn in counters.values():
        fn.launches = 0
    report["evaluate"] = model.evaluate_model(
        "smoke", None, 0, RANKS_EPOCHS, RANKS_BATCH, spec["block"],
        RANKS_STEP)
    report["evaluate_launches"] = {k: fn.launches
                                   for k, fn in counters.items()}
    # the shm copies are what phase_ranks reads; the durable copies'
    # flushes end before the rank does
    checkpoint.join_flushes(timeout=120)
    report["done_s"] = time.time() - spec["started"]
    with open(spec["report"] % rank, "w") as f:
        json.dump(report, f)
    dist.shutdown()
    if sampled:
        sampled()
    return 0


def _wait_for_file(path, timeout_s):
    """Wait until ``path`` exists; fail past ``timeout_s``."""
    deadline = time.monotonic() + timeout_s
    while not os.path.exists(path):
        check(time.monotonic() < deadline, f"no {path} after {timeout_s} s")
        time.sleep(0.05)


def _rank_out(rank):
    """Where rank ``rank``'s output goes (phase 5d)."""
    return os.path.join(os.getcwd(), f"rank{rank}.out")


def _start_rank_pair(spec) -> list:
    """Start RANKS_WORLD rank processes (torchrun's environment on a free
    127.0.0.1 port); their outputs go to ``rank{r}.out``."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("MASTER_", "WORLD_SIZE", "RANK",
                                 "LOCAL_RANK", "LOCAL_WORLD_SIZE"))}
    base.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                WORLD_SIZE=str(RANKS_WORLD),
                LOCAL_WORLD_SIZE=str(RANKS_WORLD),
                PENROZ_LOG_DIR=spec["logs"])
    procs = []
    for rank in range(RANKS_WORLD):
        with open(_rank_out(rank), "w") as out:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-worker",
                 json.dumps(spec)],
                env=dict(base, RANK=str(rank), LOCAL_RANK=str(rank)),
                cwd=spec["work"], stdout=out, stderr=subprocess.STDOUT))
    return procs


def _finish_rank_pair(procs, spec, deadline) -> list:
    """Wait for the rank processes until ``deadline`` (monotonic); a rank
    that fails or outlives it fails the phase, and every rank still
    running is killed.  Returns each rank's report."""
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(
                    c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
    finally:
        _kill(procs)
    for rank, p in enumerate(procs):
        with open(_rank_out(rank), errors="replace") as f:
            tail = f.read()[-3000:]
        check(p.returncode == 0, f"rank {rank} exited {p.returncode} "
              f"(killed at the phase's {RANKS_TIMEOUT_S} s if -9):\n{tail}")
    reports = []
    for rank in range(RANKS_WORLD):
        with open(spec["report"] % rank) as f:
            reports.append(json.load(f))
    return reports


def _ranks_reference(torch, spec, counters) -> dict:
    """World 1 over NCCL (gloo without a card), in this process, while the
    rank processes ``procs`` start and load (host work): the collectives
    on the card, then the reference run at RANKS_WORLD x RANKS_BATCH, step
    RANKS_STEP x RANKS_WORLD^2.  The ranks' ``go`` file is written when
    its last epoch has ended, so no rank trains beside its epochs; its
    end-of-run /stats/ refresh and checkpoint (host work) overlap the
    ranks' first run."""
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.parallel import dist
    cuda = spec["device"] == "cuda"
    out = {}
    with _env({"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(_free_port()),
               "WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
               "LOCAL_WORLD_SIZE": "1"}):
        check(dist.initialize(timeout_s=120), "world 1 not joined")
        try:
            out["backend"] = dist.backend()
            check(out["backend"] == ("nccl" if cuda else "gloo"),
                  f"world 1 joined over {out['backend']}")
            x = torch.arange(8, dtype=torch.float32, device=spec["device"])
            check(torch.equal(dist.all_reduce_sum_(x.clone()), x)
                  and torch.equal(dist.all_gather(x), x[None]),
                  "world-1 all_reduce / all_gather changed the tensor")
            flat = torch.ones(spec["n_params"], dtype=torch.float32,
                              device=spec["device"])
            clock = dist.CollectiveClock()
            clock.run("all_reduce", dist.all_reduce_sum_, flat)
            clock.run("all_reduce", dist.all_reduce_sum_, flat)
            out["all_reduce_s"] = clock.seconds["all_reduce"] / 2
            del flat
            model = NeuralNetworkModel.deserialize("ranks_init",
                                                   device=spec["device"])
            model.model_id = "ranks_ref"
            epochs_done = threading.Event()

            def release_the_pair():
                while not epochs_done.wait(0.02):
                    if len(model.progress) == RANKS_EPOCHS:
                        break
                with open(spec["go"], "w"):
                    pass

            releaser = threading.Thread(target=release_the_pair, daemon=True)
            releaser.start()
            for fn in counters.values():
                fn.launches = 0
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            try:
                model.train_model(**_ranks_run(
                    spec, RANKS_WORLD * RANKS_BATCH,
                    RANKS_STEP * RANKS_WORLD ** 2))
            finally:
                epochs_done.set()
                releaser.join()
            out["launches"] = {k: fn.launches for k, fn in counters.items()}
            out["peak_bytes"] = (torch.cuda.max_memory_allocated()
                                 if cuda else None)
            check(model.status["code"] == "Trained",
                  f"reference run: {model.status}")
            out["stats_refreshed"] = model.stats is not None
            out["progress"] = [[p["cost"], p["durationInSecs"]]
                               for p in model.progress]
            del model
        finally:
            dist.shutdown()
    return out


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()


def phase_ranks(torch, layers, optimizer, card, device="cuda",
                block=TRAIN_BLOCK, tag="ranks"):
    """Phase 5d: training over ranks (see RANKS_WORLD).  Gates: the ranks
    over gloo; after DP (and WUS, FSDP) both ranks' gathered parameters
    and optimizer leaves equal bit for bit; every run's costs within
    RANKS_RTOL of the reference's; WUS and FSDP parameters within RANKS_RTOL
    x |w| + lr x epochs of DP's; each rank's moment bytes (and FSDP's
    parameter bytes) the replicated figure with every cut leaf halved;
    two shard files a sharded run, which this process reassembles
    (the port's deserialize) into the ranks' gathered state bit for bit;
    both ranks' evaluation equal, and within RANKS_RTOL of the DP model's
    at world 1; flash and cross-entropy launches a micro-step on each rank
    equal to the reference's (the master's end-of-run /stats/ pass, one
    micro-step's launches, counted on it); per-rank logs.  Recorded:
    tokens/s a rank and in aggregate against world 1, peak memory a rank,
    the seconds of each collective.  Returns (stats, launches)."""
    import gc

    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import (CompiledArch,
                                               NeuralNetworkModel)
    from penroz_tpu_torch.utils import checkpoint

    cuda = device == "cuda"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    _write_train_shard()
    init = NeuralNetworkModel("ranks_init", Mapper(layers, optimizer),
                              device=device, seed=0)
    n_params = sum(p.numel() for p in init.arch.parameters())
    init.serialize()
    del init
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    logs = os.path.join(os.getcwd(), "rank_logs")
    shutil.rmtree(logs, ignore_errors=True)
    spec = {"device": device, "block": block, "work": os.getcwd(),
            "logs": logs, "report": os.path.join(os.getcwd(),
                                                 "ranks_report%d.json"),
            "lr": optimizer["adamw"]["lr"], "n_params": n_params}
    spec["go"] = os.path.join(os.getcwd(), "ranks_go")
    if os.path.exists(spec["go"]):
        os.remove(spec["go"])
    t0 = time.monotonic()
    spec["started"] = time.time()
    procs = _start_rank_pair(spec)
    try:
        ref = _ranks_reference(torch, spec, _training_counters())
        ref_s = time.monotonic() - t0
        reports = _finish_rank_pair(procs, spec, t0 + RANKS_TIMEOUT_S)
    finally:
        _kill(procs)
    pair_s = time.monotonic() - t0
    # the DP model's evaluation at world 1, at the reference's batch
    dp = NeuralNetworkModel.deserialize("ranks_dp", device=device,
                                        optimizer=False)
    ref["evaluate"] = dp.evaluate_model(
        "smoke", None, 0, RANKS_EPOCHS, RANKS_WORLD * RANKS_BATCH, block,
        RANKS_STEP)
    del dp
    stats = {"world": RANKS_WORLD, "pair_s": pair_s, "reference_s": ref_s,
             "reference": ref}
    master, other = reports[0], reports[1]
    for r, report in enumerate(reports):
        check(report["rank"] == r and report["world"] == RANKS_WORLD
              and report["backend"] == "gloo", f"rank {r}: "
              f"{report['rank']}/{report['world']} over {report['backend']}")
    say(tag, f"{RANKS_WORLD} ranks over {master['backend']} on one card, "
        f"world 1 over {ref['backend']}: the ranks joined at "
        f"{max(r['joined_s'] for r in reports):.1f} s, the reference "
        f"ended at {ref_s:.1f} s (the ranks went at "
        f"{max(r['go_s'] for r in reports):.1f} s), the ranks at "
        f"{max(r['done_s'] for r in reports):.1f} s")

    # replicas: every run ends with the ranks' gathered state equal
    for mode, _ in RANKS_MODES:
        a, b = (rep["runs"][mode]["digests"] for rep in reports)
        check(a == b, f"{mode}: the ranks' gathered state differs: "
              f"{sorted(k for k in a if a[k] != b.get(k))[:8]}")
    say(tag, "both ranks equal bit for bit: DP's parameters, WUS's and "
        "FSDP's parameters and optimizer leaves")

    # costs against the reference
    ref_costs = [c for c, _ in ref["progress"]]
    check(len(ref_costs) == RANKS_EPOCHS and all(
        math.isfinite(c) for c in ref_costs), f"reference costs {ref_costs}")
    for mode, _ in RANKS_MODES:
        costs = [c for c, _ in master["runs"][mode]["progress"]]
        check(other["runs"][mode]["progress"] == [],
              f"{mode}: rank 1 recorded progress")
        rel = [abs(c - w) / abs(w) for c, w in zip(costs, ref_costs)]
        check(len(costs) == RANKS_EPOCHS and max(rel) <= RANKS_RTOL,
              f"{mode} costs {costs} against the reference's {ref_costs}: "
              f"relative {rel} > {RANKS_RTOL:g}")
        stats.setdefault("cost_rel_diff", {})[mode] = rel
    say(tag, f"costs against world 1 at {RANKS_WORLD * RANKS_BATCH} x "
        f"{block} step {RANKS_STEP * RANKS_WORLD ** 2} {ref_costs}: "
        + ", ".join(f"{m} {max(v):.3g}" for m, v in
                    stats["cost_rel_diff"].items())
        + f" relative (<= {RANKS_RTOL:g})")
    for mode in ("wus", "fsdp"):
        for report in reports:
            entry = report["runs"][mode]
            check(entry["param_excess_vs_dp"] <= 0, f"{mode} rank "
                  f"{report['rank']}: parameters leave DP's by "
                  f"{entry['param_max_abs_diff_vs_dp']:.3g}")
    say(tag, "WUS, FSDP parameters against DP's: max |diff| "
        + ", ".join(f"{m} {master['runs'][m]['param_max_abs_diff_vs_dp']:.3g}"
                    for m in ("wus", "fsdp"))
        + f" (<= {RANKS_RTOL:g} |w| + {spec['lr'] * RANKS_EPOCHS:g})")

    # bytes each rank holds
    for report in reports:
        for mode, _ in RANKS_MODES:
            entry = report["runs"][mode]
            held, want = entry["held"], entry["expected"]
            moments = want["moments_cut" if mode != "dp"
                           else "moments_replicated"]
            params = want["params_cut" if mode == "fsdp"
                          else "params_replicated"]
            check(held == {"params": params, "moments": moments},
                  f"{mode} rank {report['rank']} holds {held}, expected "
                  f"params {params}, moments {moments}")
    dp_want = master["runs"]["dp"]["expected"]
    say(tag, f"bytes a rank holds: moments DP {dp_want['moments_replicated']}"
        f", WUS {master['runs']['wus']['held']['moments']}, FSDP "
        f"{master['runs']['fsdp']['held']['moments']}; parameters DP "
        f"{dp_want['params_replicated']}, FSDP "
        f"{master['runs']['fsdp']['held']['params']} "
        f"({master['runs']['fsdp']['expected']['leaves_whole']} leaves "
        f"whole)")

    # the shard files, reassembled here
    for mode in ("wus", "fsdp"):
        model_id = f"ranks_{mode}"
        check(checkpoint._shard_indices(model_id) == list(range(RANKS_WORLD)),
              f"{model_id}: shard files of ranks "
              f"{checkpoint._shard_indices(model_id)}")
        t0 = time.monotonic()
        loaded = NeuralNetworkModel.deserialize(model_id, device="cpu")
        stats.setdefault("reassemble_s", {})[mode] = time.monotonic() - t0
        state = loaded.state_dict()
        want = master["runs"][mode]["digests"]
        got = _state_digests(
            {k[2:]: state[k[2:]] for k in want if k.startswith("p:")},
            {int(k[2:]): loaded._opt_leaves[int(k[2:])] for k in want
             if k.startswith("o:")})
        check(got == want, f"{model_id}: the reassembled state differs from "
              f"the ranks': {sorted(k for k in want if got[k] != want[k])[:8]}")
        del loaded, state
    say(tag, f"WUS and FSDP: {RANKS_WORLD} shard files each, reassembled "
        f"here equal to the ranks' state bit for bit ("
        + ", ".join(f"{m} {s:.1f} s" for m, s in
                    stats["reassemble_s"].items()) + ")")

    # evaluation
    evals = [r["evaluate"] for r in reports]
    check(evals[0] == evals[1] and abs(evals[0] - ref["evaluate"])
          <= RANKS_RTOL * abs(ref["evaluate"]),
          f"evaluation over ranks {evals}, at world 1 {ref['evaluate']}")
    say(tag, f"evaluate_model: both ranks {evals[0]:.6f}, world 1 "
        f"{ref['evaluate']:.6f}")

    # launches a micro-step
    micro = RANKS_EPOCHS * max(1, RANKS_BATCH // (RANKS_STEP * RANKS_WORLD))
    ref_micro = RANKS_EPOCHS * max(1, RANKS_WORLD * RANKS_BATCH // (
        RANKS_STEP * RANKS_WORLD ** 2))
    check(ref["stats_refreshed"], "the reference refreshed no /stats/")
    per = {k: n / (ref_micro + 1) for k, n in ref["launches"].items()}
    if cuda:
        check(per == {k: float(n_attn if "flash" in k else 1) for k in per},
              f"the reference launched {ref['launches']} in {ref_micro} "
              f"micro-steps and one /stats/ pass")
    launches = dict(ref["launches"])
    for report in reports:
        for mode, _ in RANKS_MODES:
            entry = report["runs"][mode]
            passes = micro + (1 if entry["stats_refreshed"] else 0)
            check(entry["stats_refreshed"] == (report["rank"] == 0),
                  f"{mode} rank {report['rank']}: /stats/ refreshed "
                  f"{entry['stats_refreshed']}")
            check(entry["launches"] == {k: int(v * passes)
                                        for k, v in per.items()},
                  f"{mode} rank {report['rank']} launched "
                  f"{entry['launches']} in {micro} micro-steps; a "
                  f"micro-step of the reference launches {per}")
            for k, n in entry["launches"].items():
                launches[k] += n
        for k, n in report["evaluate_launches"].items():
            launches[k] += n
    say(tag, f"launches a micro-step on each rank = the reference's {per} "
        f"({micro} micro-steps a run; the master's /stats/ pass counted)")

    # per-rank logs
    for rank in range(RANKS_WORLD):
        path = os.path.join(logs, f"penroz_rank{rank}.log")
        check(os.path.exists(path), f"no {path}")
        with open(path, errors="replace") as f:
            text = f.read()
        check(f"[rank{rank}/{RANKS_WORLD}]" in text and
              f"Per-rank logging for process {rank}/{RANKS_WORLD}" in text
              and "over 2 ranks (ZeRO stage 3)" in text,
              f"{path} lacks the rank tag, the banner or the runs")
    say(tag, f"per-rank logs {logs}/penroz_rank{{0..{RANKS_WORLD - 1}}}.log")

    # recorded: rates, memory, collectives
    tokens_epoch = micro // RANKS_EPOCHS * RANKS_BATCH * block
    ref_dur = ref["progress"][-1][1]
    stats["reference_tokens_per_s"] = RANKS_WORLD * tokens_epoch / ref_dur
    stats["reference_peak_gb"] = (ref["peak_bytes"] or 0) / 1e9
    for mode, _ in RANKS_MODES:
        dur = master["runs"][mode]["progress"][-1][1]
        row = {"tokens_per_s_rank": tokens_epoch / dur,
               "tokens_per_s": RANKS_WORLD * tokens_epoch / dur,
               "peak_gb": [(r["runs"][mode]["peak_bytes"] or 0) / 1e9
                           for r in reports],
               "collective_s": master["runs"][mode]["collective_s"],
               "collective_calls": master["runs"][mode]["collective_calls"],
               "wall_s": [r["runs"][mode]["wall_s"] for r in reports],
               "load_s": [r["runs"][mode]["load_s"] for r in reports],
               "gather_s": [r["runs"][mode]["gather_s"] for r in reports]}
        stats[mode] = row
        say(tag, f"{mode}: {row['tokens_per_s_rank']:.0f} tokens/s a rank, "
            f"{row['tokens_per_s']:.0f} in all (world 1: "
            f"{stats['reference_tokens_per_s']:.0f}; epoch {RANKS_EPOCHS}); "
            f"peak {', '.join(f'{g:.2f}' for g in row['peak_gb'])} GB "
            f"(world 1 {stats['reference_peak_gb']:.2f}); collectives "
            + ", ".join(f"{k} {v:.3f} s / {row['collective_calls'][k]}"
                        for k, v in row["collective_s"].items())
            + f"; load {max(row['load_s']):.1f} s, train_model "
            f"{max(row['wall_s']):.1f} s, gather and digest "
            f"{max(row['gather_s']):.1f} s on {card}")
    say(tag, f"NCCL all_reduce at world 1 of {n_params} fp32: "
        f"{ref['all_reduce_s'] * 1e3:.2f} ms")
    stats["ranks"] = [{mode: {k: v for k, v in entry.items()
                              if k != "digests"}
                       for mode, entry in r["runs"].items()}
                      for r in reports]
    return stats, launches


# ---------------------------------------------------------------------------
# 6: one micro-step, kernels against plain
# ---------------------------------------------------------------------------

def phase_micro_step(torch, layers, optimizer, vocab, tag="micro_step"):
    """fp32 loss and gradients of one micro-step at GPT-2 width (B 1,
    T 1024) through the kernels, against the same step with the plain
    versions patched in (a training forward: the MoE layers' load-balance
    loss rides in the loss, and the router and expert stacks get their
    gradients through it)."""
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
    say(tag, f"fp32 B1 T{TRAIN_BLOCK}: loss {float(cost):.6f} vs "
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

# ---------------------------------------------------------------------------
# 4g: fault tolerance, the rest of the REST surface, the host data path
# ---------------------------------------------------------------------------

# GPT-2 124M under continuous batching over the paged pool with the prefix
# cache on; the breaker's cooldown cut from 1000 ms to 200 ms so that the
# phase need not wait a second for each probe.
RES_ENV = dict(CB_ENV, PENROZ_PREFIX_CACHE="1",
               PENROZ_BREAKER_COOLDOWN_MS="200")
RES_PROMPT_LEN, RES_NEW_TOKENS = 16, 64
RES_SUFFIXES = (16, 40)          # after phase 4f's 512-token prefix
RES_QUEUE_REQUESTS = 12          # > 8 rows + a queue of 1
# Deadlines under decode.step:sleep@50: 64 new tokens take at least 9
# blocks (a prefill block, then 8 of up to 8 steps), so 450 ms; an
# in-flight deadline of 150 ms and a streamed one of 400 ms (after the
# first block's token) both expire before the request ends.
RES_SLEEP_MS, RES_INFLIGHT_MS, RES_STREAM_MS = 50, 150, 400
RES_DRAIN_REQUESTS = 4
RES_BPE_VOCAB = 512
RES_TRAIN = dict(epochs=2, batch_size=2, step_size=1)   # at the block
RES_SHARD_TOKENS = 3000          # two shards; 4 micro-steps wrap them
RES_WORDS = ("the", "quick", "brown", "fox", "jumps", "over", "lazy",
             "dog", "héllo", "wörld", "naïve", "café", "日本語", "テキスト",
             "42", "1999", "shells", "sea", "ñandú", "emoji😀")


def _request(base, path, body=None, method="POST", timeout=900):
    """(status, headers, text) of one request."""
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode() if body is not None
        else None, method=method, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _kernel_counters():
    """Every main-path kernel wrapper, by name."""
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    return {**_decode_counters(), **_training_counters(),
            "ragged_paged_attention": RPA.ragged_paged_attention}


def phase_resilience(torch, layers, optimizer, block, vocab, card,
                     device="cuda"):
    """GPT-2 124M (fp32, paged, continuous batching, prefix cache on):
    the breaker (3 crashes, 503 + Retry-After, /readyz, the fallback
    through the paged kernel, the probe that closes it; again under a
    shared prefix, whose reset leaves a clean audit), deadlines (an
    in-flight 504, a stream's ``timeout`` line), the bounded queue (429),
    a /profile/ capture (the decode and ragged kernels and the
    ``penroz/sched_mixed`` range in its trace), the ``bpe:`` tokenizer on
    its native core, /openapi.json and /docs, training through the native
    loader, then the graceful drain on a server of its own.  Returns
    (stats, counts of the phase: the decode kernels' device runs, the
    other kernels' launches).  ``device="cpu"`` rehearses it
    at a toy size through the plain versions (no kernel counts)."""
    import numpy as np

    from penroz_tpu_torch.data import bpe, loaders
    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.utils import checkpoint, faults, native_build

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(0)
    p0 = rng.integers(0, vocab, RES_PROMPT_LEN).tolist()
    prefix = np.random.default_rng(0).integers(0, vocab,
                                               PF_PREFIX_LEN).tolist()
    pair = [prefix + rng.integers(0, vocab, n).tolist()
            for n in RES_SUFFIXES]
    body = {"model_id": "smoke_res", "block_size": block, "temperature": 0,
            "max_new_tokens": RES_NEW_TOKENS}
    gen = lambda prompt, **kw: dict(body, input=[prompt], **kw)  # noqa: E731
    counters = _kernel_counters()
    totals = dict.fromkeys(counters, 0)
    stats = {}

    device_counted = _decode_counters()

    def harvest():
        """Add the counts since the last harvest to the phase's totals and
        zero them: the decode kernels' device runs (replays included, as
        phase 4 counts them), the other wrappers' launches."""
        for name, fn in counters.items():
            if name in device_counted:
                totals[name] += fn.runs.read()
                fn.runs.reset()
            else:
                totals[name] += fn.launches
            fn.launches = 0

    def tokens(result, what):
        status, _, text = result
        check(status == 200, f"{what} -> {status}: {text[:300]}")
        out = json.loads(text)["tokens"]
        check(len(out) >= RES_NEW_TOKENS, f"{what}: short result")
        return out

    def readyz():
        status, _, text = _request(base, "/readyz", None, "GET")
        return status, json.loads(text)

    def engine_stats():
        status, _, text = _request(base, "/serving_stats/", None, "GET")
        check(status == 200, f"/serving_stats/ -> {status}")
        engines = json.loads(text)["engines"]
        check(len(engines) == 1, f"{len(engines)} engines, expected 1")
        return engines[0]

    def arm(spec):
        faults.reset()
        if spec:
            os.environ[faults.ENV] = spec
        else:
            os.environ.pop(faults.ENV, None)

    def breaker_cycle(prompt, ref, what):
        """Three crashed requests, the 503, /readyz, the fallback, the
        probe; returns the probe's mixed steps and the ragged kernel's
        device runs over it."""
        arm("decode.step:raise@1+")
        crashed = [_request(base, "/generate/", gen(prompt))[0]
                   for _ in range(3)]
        check(crashed == [500] * 3, f"{what}: crashed requests answered "
              f"{crashed}, expected three 500s")
        status, headers, text = _request(base, "/generate/", gen(prompt))
        retry = headers.get("Retry-After")
        check(status == 503 and retry is not None and 1 <= int(retry) <= 30,
              f"{what}: the fourth request answered {status} with "
              f"Retry-After {retry}: {text[:200]}")
        ready = readyz()
        check(ready == (503, {"ready": False, "draining": False,
                              "breaker_open_engines": ["smoke_res"],
                              "stuck_engines": []}),
              f"{what}: /readyz with the breaker open: {ready}")
        fallback = None
        if what == "breaker":
            harvest()
            _zero_decode_counts()
            ledger = _StepLedger()
            with _env({DS.FALLBACK_ENV: "1"}), ledger.request():
                fallback = tokens(_request(base, "/generate/", gen(prompt)),
                                  "fallback /generate/")
            if on_card:
                _, paged_runs = _check_launches(n_attn, ledger, "fallback")
                check(paged_runs["paged_decode_attention"] > 0,
                      "the fallback ran no paged decode kernel")
                stats["fallback_paged_runs"] = paged_runs[
                    "paged_decode_attention"]
            check(fallback == ref, "the fallback's tokens differ from the "
                  "scheduler's")
            stats["fallback_steps"] = ledger.steps["paged_decode_attention"]
        arm(None)
        time.sleep(0.25)                 # the 200 ms cooldown
        RPA.ragged_paged_attention.runs.reset()
        with _mixed_steps() as count:
            probe = tokens(_request(base, "/generate/", gen(prompt)),
                           f"{what} probe")
        runs = RPA.ragged_paged_attention.runs.read()
        check(probe == ref, f"{what}: the probe's tokens differ")
        check(not on_card or runs == n_attn * count["steps"] > 0,
              f"{what}: the ragged kernel ran {runs} times for "
              f"{count['steps']} mixed steps x {n_attn} layers")
        check(readyz()[0] == 200, f"{what}: /readyz after the probe")
        return count["steps"], runs

    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    _zero_decode_counts()
    for fn in counters.values():
        fn.launches = 0
    try:
        status, _, text = _request(base, "/model/", {
            "model_id": "smoke_res", "layers": layers,
            "optimizer": optimizer})
        check(status == 200, f"POST /model/ -> {status}: {text[:300]}")
        # the shared-prefix pair without the cache: the references
        DS.reset()
        with _env(dict(RES_ENV, PENROZ_PREFIX_CACHE="0")):
            refs = [tokens(_request(base, "/generate/", gen(p)), "ref")
                    for p in pair]
        DS.reset()
        with _env(RES_ENV):
            # -- the breaker ------------------------------------------------
            t0 = time.monotonic()
            RPA.ragged_paged_attention.runs.reset()
            with _mixed_steps() as count:
                ref0 = tokens(_request(base, "/generate/", gen(p0)), "T0")
            runs0 = RPA.ragged_paged_attention.runs.read()
            check(not on_card or runs0 == n_attn * count["steps"] > 0,
                  f"T0: the ragged kernel "
                  f"ran {runs0} times for {count['steps']} mixed steps")
            steps, runs = breaker_cycle(p0, ref0, "breaker")
            es = engine_stats()
            check(es["engine_resets"] == 3 and es["crashes_total"] == 3
                  # the 503 and the fallback's request, shed at the door
                  and not es["breaker_open"] and es["breaker_rejections"] == 2
                  and es["consecutive_crashes"] == 0,
                  f"breaker counters: {es}")
            stats["breaker"] = {"T0_ragged_runs": runs0,
                                "T0_mixed_steps": count["steps"],
                                "probe_mixed_steps": steps,
                                "probe_ragged_runs": runs,
                                "s": time.monotonic() - t0}
            say("resilience", f"breaker: 3 x 500, 503 with Retry-After, "
                f"/readyz 503 naming smoke_res, fallback 200 = T0 through "
                f"the paged kernel ({stats.get('fallback_paged_runs')} "
                f"runs), "
                f"probe 200 = T0 (ragged kernel {runs} runs = {n_attn} x "
                f"{steps} mixed steps), 3 resets, "
                f"{stats['breaker']['s']:.1f} s")
            # -- again under a shared prefix ---------------------------------
            t0 = time.monotonic()
            got = [tokens(_request(base, "/generate/", gen(p)), "pair")
                   for p in pair]
            check(got == refs, "the shared-prefix pair's tokens differ "
                  "from the cache-off references")
            check(engine_stats()["prefix_cache"]["hits"] >= 1,
                  "the pair's second request did not hit the cache")
            breaker_cycle(pair[1], refs[1], "prefix breaker")
            engine = DS.get_engine("smoke_res", block, 0, None,
                                   device=server.device)
            cache = engine._prefix_cache
            pc = cache.stats()
            check(pc["hits"] == 0 and pc["misses"] == 1,
                  f"the probe after the reset was not a cold prefill: {pc}")
            check(cache.page_audit() == [] and all(
                nd.refs == 0 for nd in cache.iter_nodes()),
                "the rebuilt prefix cache leaked a page or a pin")
            again = tokens(_request(base, "/generate/", gen(pair[1])),
                           "pair again")
            check(again == refs[1] and cache.stats()["hits"] == 1,
                  "the pair's request after the reset did not hit again")
            stats["prefix_breaker_s"] = time.monotonic() - t0
            say("resilience", f"prefix breaker: same tokens as the "
                f"cache-off references, cold probe, clean audit, hit "
                f"again; {stats['prefix_breaker_s']:.1f} s")

            # -- deadlines and the bounded queue -----------------------------
            t0 = time.monotonic()
            arm(f"decode.step:sleep@{RES_SLEEP_MS}")
            status, _, text = _request(base, "/generate/",
                                       gen(p0, timeout_ms=RES_INFLIGHT_MS))
            check(status == 504 and "Deadline" in text,
                  f"an in-flight deadline answered {status}: {text[:200]}")
            status, _, text = _request(base, "/generate/", gen(
                p0, stream=True, timeout_ms=RES_STREAM_MS))
            lines = text.split()
            check(status == 200 and lines[-1] == "timeout"
                  and len(lines) >= 2
                  and [int(t) for t in lines[:-1]]
                  == ref0[RES_PROMPT_LEN:RES_PROMPT_LEN + len(lines) - 1],
                  f"the stream's deadline: {status} {lines[-3:]}")
            stats["stream_tokens_before_timeout"] = len(lines) - 1
            results = [None] * RES_QUEUE_REQUESTS

            def fire(i):
                results[i] = _request(base, "/generate/", gen(p0))

            with _env({DS.MAX_QUEUE_ENV: "1"}):
                threads = [threading.Thread(target=fire, args=(i,))
                           for i in range(RES_QUEUE_REQUESTS)]
                for th in threads:
                    th.start()
                for th in threads:
                    th.join(timeout=600)
            arm(None)
            shed = [r for r in results if r is not None and r[0] == 429]
            admitted = [r for r in results if r is not None and r[0] == 200]
            check(len(shed) + len(admitted) == RES_QUEUE_REQUESTS and shed,
                  f"the bounded queue answered "
                  f"{[r and r[0] for r in results]}")
            check(all(1 <= int(r[1].get("Retry-After", 0)) <= 30
                      for r in shed), "a 429 without a Retry-After")
            check(all(json.loads(r[2])["tokens"] == ref0 for r in admitted),
                  "an admitted request's tokens differ from T0")
            stats["queue"] = {"shed_429": len(shed),
                              "admitted": len(admitted),
                              "s": time.monotonic() - t0}
            say("resilience", f"deadlines: in-flight 504, stream "
                f"'timeout' after {stats['stream_tokens_before_timeout']} "
                f"token(s); queue of 1: {len(shed)} x 429, "
                f"{len(admitted)} x 200 = T0; {stats['queue']['s']:.1f} s")

            # -- /profile/ ---------------------------------------------------
            t0 = time.monotonic()
            log_dir = os.path.join(WORK, "profile_resilience")
            status, _, text = _request(base, "/profile/", {
                "action": "start", "log_dir": log_dir})
            check(status == 200, f"/profile/ start -> {status}: {text}")
            with _env({"PAGED_KV_CACHE": "0",
                       "PENROZ_CONTINUOUS_BATCHING": "0"}):
                single = tokens(_request(base, "/generate/", gen(p0)),
                                "profiled single-sequence /generate/")
            sched = tokens(_request(base, "/generate/", gen(p0)),
                           "profiled scheduler /generate/")
            status, _, text = _request(base, "/profile/", {"action": "stop"})
            check(status == 200, f"/profile/ stop -> {status}: {text}")
            check(_request(base, "/profile/", {"action": "stop"})[0] == 409,
                  "a second stop did not answer 409")
            traces = [f for f in os.listdir(log_dir) if f.endswith(".json")]
            check(len(traces) == 1, f"trace files: {traces}")
            with open(os.path.join(log_dir, traces[0])) as f:
                events = json.load(f)["traceEvents"]
            names = [e.get("name", "") for e in events]
            kernels = {
                "decode": sum("decode_core::Contiguous" in n for n in names),
                "ragged": sum("decode_core::Ragged" in n for n in names),
                "sched_mixed": names.count("penroz/sched_mixed")}
            check(kernels["sched_mixed"] and (not on_card or all(
                kernels.values())), f"the trace misses a kernel or range: "
                f"{kernels}")
            check(sched == ref0 and len(single) == len(ref0),
                  "a profiled request's tokens")
            stats["profile"] = dict(kernels, events=len(events),
                                    s=time.monotonic() - t0)
            say("resilience", f"/profile/: trace of {len(events)} events "
                f"holds {kernels['decode']} contiguous decode and "
                f"{kernels['ragged']} ragged kernel runs and "
                f"{kernels['sched_mixed']} penroz/sched_mixed ranges; "
                f"a second stop 409")

            # -- the bpe: tokenizer ------------------------------------------
            t0 = time.monotonic()
            wrng = np.random.default_rng(0)
            text = " ".join(RES_WORDS[i] for i in
                            wrng.integers(0, len(RES_WORDS), 4000))
            model = bpe.ByteBPE.train_from_text(text, RES_BPE_VOCAB)
            check(model.native and native_build.loaded().get("penroz_bpe"),
                  "the native BPE core did not load")
            check(model.merges == bpe._py_train(text.encode(),
                                                len(model.merges)),
                  "the native core's merges differ from the oracle's")
            ids = model.encode(text)
            check(ids == bpe._PyEncoder(model.merges).encode(text.encode()),
                  "the native core's ids differ from the oracle's")
            path = os.path.join(WORK, "smoke_bpe.json")
            model.save(path)
            status, _, out = _request(base, "/tokenize/", {
                "encoding": f"bpe:{path}", "text": text[:400]})
            check(status == 200 and json.loads(out)["tokens"] == (
                model.encode(text[:400]) + [model.eot_token]),
                f"/tokenize/ bpe: -> {status}")
            # ids below RES_BPE_VOCAB, all in GPT-2's vocabulary (the
            # modulo only matters to a toy-vocabulary rehearsal)
            prompt_ids = [t % vocab for t in json.loads(out)["tokens"][:64]]
            generated = tokens(_request(base, "/generate/", gen(
                prompt_ids, max_new_tokens=RES_NEW_TOKENS)),
                "/generate/ of a bpe prompt")
            status, _, out = _request(base, "/decode/", {
                "encoding": f"bpe:{path}", "tokens": generated})
            check(status == 200 and isinstance(json.loads(out)["text"], str),
                  f"/decode/ bpe: -> {status}")
            stats["bpe"] = {"merges": len(model.merges), "ids": len(ids),
                            "s": time.monotonic() - t0}
            say("resilience", f"bpe: native core, {len(model.merges)} "
                f"merges and {len(ids)} ids equal to the oracle's, "
                f"/tokenize/ and /generate/ through bpe:")

            # -- /openapi.json and /docs -------------------------------------
            status, _, out = _request(base, "/openapi.json", None, "GET")
            spec = json.loads(out)
            routes = {(m, p) for m, table in (
                ("get", app_mod._GET), ("post", app_mod._POST),
                ("put", app_mod._PUT), ("delete", app_mod._DELETE))
                for p in table}
            check(status == 200 and {(m, p) for p, ops in
                                     spec["paths"].items()
                                     for m in ops} == routes,
                  "/openapi.json's paths differ from the route tables")
            check(_request(base, "/docs", None, "GET")[0] == 200,
                  "/docs did not answer 200")
            DS.reset()

        # -- training through the native loader ------------------------------
        t0 = time.monotonic()
        os.makedirs("data", exist_ok=True)
        drng = np.random.default_rng(1)
        for i in range(2):
            np.save(os.path.join("data", f"smoke_res_{i:06d}.npy"),
                    drng.integers(0, TRAIN_VOCAB_USED,
                                  RES_SHARD_TOKENS).astype(np.uint16))
        buffer = RES_TRAIN["batch_size"] * block
        native = loaders.Loader("smoke_res", buffer_size=buffer)
        batches = [native.next_batch() for _ in range(5)]
        check(native._stream is not None
              and native_build.loaded().get("penroz_loader"),
              "the native loader stream did not load")
        with _env({loaders.NATIVE_LOADER_ENV: "0"}):
            plain = loaders.Loader("smoke_res", buffer_size=buffer)
            for (x, y), (xp, yp) in zip(batches, (plain.next_batch()
                                                  for _ in range(5))):
                check(np.array_equal(x, xp) and np.array_equal(y, yp),
                      "a native batch differs from the numpy path's")
        streams = []
        real = loaders.Loader._native_stream

        def counted(self, files):
            out = real(self, files)
            streams.append(out is not None)
            return out

        loaders.Loader._native_stream = counted
        harvest()
        try:
            train = dict(RES_TRAIN, block_size=block, model_id="smoke_res",
                         dataset_id="smoke_res", shard=0)
            status, _, text = _request(base, "/train/", train, "PUT")
            check(status == 202, f"PUT /train/ -> {status}: {text[:300]}")
            check(server.join_training(timeout=600), "training still runs")
        finally:
            loaders.Loader._native_stream = real
        status, _, text = _request(
            base, "/progress/?model_id=smoke_res", None, "GET")
        progress = json.loads(text)
        check(progress["status"]["code"] == "Trained",
              f"training ended {progress['status']}")
        costs = [p["cost"] for p in progress["progress"]]
        check(all(math.isfinite(c) for c in costs), "a non-finite cost")
        micro = RES_TRAIN["epochs"] * (buffer // (
            RES_TRAIN["step_size"] * block))
        train_launches = {n: counters[n].launches for n in
                          _training_counters()}
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(not on_card or train_launches[name] >= n_attn * micro,
                  f"{name} launched {train_launches[name]} times, expected "
                  f">= {n_attn} x {micro}")
        for name in ("ce_forward", "ce_backward"):
            check(not on_card or train_launches[name] >= micro,
                  f"{name} launched {train_launches[name]} times, expected "
                  f">= {micro}")
        check(streams and all(streams),
              "training did not read through the native stream")
        stats["training"] = {"micro_steps": micro, "costs": costs,
                             "launches": train_launches,
                             "s": time.monotonic() - t0}
        say("resilience", f"training: {micro} micro-steps through the "
            f"native stream (numpy batches equal), launches "
            f"{train_launches}, costs {[round(c, 4) for c in costs]}")
    finally:
        arm(None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        server.join_training(timeout=60)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")

    # -- the graceful drain, on a server of its own ----------------------------
    t0 = time.monotonic()
    before = {t for t in threading.enumerate()
              if t.name.startswith("penroz-sched")}
    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    results = [None] * RES_DRAIN_REQUESTS
    try:
        with _env(dict(RES_ENV, PENROZ_DRAIN_S="5")):
            arm(f"decode.step:sleep@{RES_SLEEP_MS}")

            def fire(i):
                results[i] = _request(base, "/generate/", gen(p0))

            threads = [threading.Thread(target=fire, args=(i,))
                       for i in range(RES_DRAIN_REQUESTS)]
            for th in threads:
                th.start()
            deadline = time.monotonic() + 300
            while time.monotonic() < deadline:
                status, _, text = _request(base, "/serving_stats/", None,
                                           "GET")
                if json.loads(text)["active_rows"] >= RES_DRAIN_REQUESTS:
                    break
                time.sleep(0.01)
            check(time.monotonic() < deadline, "the drain's rows were "
                  "never all admitted")
            t_shut = time.monotonic()
            server.shutdown()
            stats["drain_shutdown_s"] = time.monotonic() - t_shut
            for th in threads:
                th.join(timeout=60)
    finally:
        arm(None)
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    outs = [tokens(r, "a drained request") if r else None for r in results]
    check(all(o is not None and o == outs[0] for o in outs),
          "a drained request failed or its tokens differ")
    left = {t for t in threading.enumerate()
            if t.name.startswith("penroz-sched")} - before
    check(not left, f"worker threads outlived the drain: {left}")
    stats["drain_s"] = time.monotonic() - t0
    say("resilience", f"drain: {RES_DRAIN_REQUESTS} rows in flight "
        f"finished 200 during a {stats['drain_shutdown_s']:.2f} s shutdown, "
        f"no worker thread left")
    harvest()
    for name in ("ragged_paged_attention", "paged_decode_attention",
                 "decode_attention", "flash_attention_fwd",
                 "flash_attention_bwd", "ce_forward", "ce_backward"):
        check(not on_card or totals[name] > 0,
              f"{name} was launched no time in the phase")
    stats["seconds"] = time.monotonic() - t_phase
    say("resilience", f"{stats['seconds']:.1f} s; counts {totals} (the "
        f"decode kernels' device runs) on {card}")
    return stats, totals


# -- phase 4h: observability, multi-tenant QoS with preemption, the ledger ----

# GPT-2 124M under continuous batching over 4 rows of the paged pool (pages
# of 128), the prefix cache's 64 pages holding what preemption evicts, the
# ledger's strict audit at every retirement, preemption and recovery.
QOS_ENV = dict(CB_ENV, PENROZ_SCHED_MAX_ROWS="4", PENROZ_KV_PAGE_SIZE="128",
               PENROZ_PREFIX_CACHE="1", PENROZ_PREFIX_CACHE_PAGES="64",
               PENROZ_MEMLEDGER_STRICT="1")
QOS_PAGE = 128
# 8 batch prompts of tenant "flood", the longest first (the earliest
# admitted are the victims, and each holds at least one full page), and 4
# interactive prompts of tenant "ui".
QOS_BATCH_LENS = (300, 260, 220, 180, 140, 100, 64, 200)
QOS_UI_LENS = (16, 32, 48, 64)
QOS_BATCH_NEW, QOS_UI_NEW = 128, 32
QOS_SLEEP_MS = 20           # a block's stall: rows still decode when ui comes
QOS_CRASH_BLOCK = 512       # the second engine's block size
# one 0.0.4 exposition line
_EXPOSITION = re.compile(
    r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.e+-]+|\+Inf|NaN))$')


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


def _qos_call(base, path, body=None, method=None, rid=None, timeout=900):
    """(status, headers, text) of one request, redirects not followed."""
    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode() if body is not None
        else None, method=method or ("POST" if body is not None else "GET"),
        headers=headers)
    try:
        with urllib.request.build_opener(_NoRedirect).open(
                req, timeout=timeout) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()


def _qos_stream(base, body, rid, started=None):
    """A streamed /generate/ with its own X-Request-Id: (tokens, echoed
    id, seconds to the first token).  ``started`` is set at the first."""
    req = urllib.request.Request(
        base + "/generate/", data=json.dumps(dict(body, stream=True)).encode(),
        method="POST", headers={"Content-Type": "application/json",
                                "X-Request-Id": rid})
    t0 = time.monotonic()
    first, tokens = None, []
    with urllib.request.urlopen(req, timeout=900) as resp:
        check(resp.status == 200, f"stream {rid}: status {resp.status}")
        echoed = resp.headers.get("X-Request-Id")
        for line in resp:
            if first is None:
                first = time.monotonic() - t0
                if started is not None:
                    started.set()
            tokens.append(int(line))
    return tokens, echoed, first


def _pct(values, q):
    values = sorted(values)
    return values[min(len(values) - 1, int(q * len(values)))]


def phase_qos(torch, layers, optimizer, block, vocab, card, device="cuda",
              model_id="smoke_res"):
    """GPT-2 124M (fp32, paged, 4 rows, prefix cache on, strict ledger):
    reference tokens with QoS idle; a wave of 8 batch streams of tenant
    ``flood`` into which 4 interactive streams of tenant ``ui`` arrive
    once every row has emitted, and preempt (every token equal to the
    reference, the resumes from whole cached pages, no pin left, the
    ledger polled whole throughout, interactive TTFT p99 below batch's);
    the same wave untraced; a tenant quota's 429; the traces, ``/metrics``
    against ``/serving_stats/``, a crash's flight record, the dashboard's
    routes.  Reuses phase 4g's checkpoint when it is there.  Returns
    (stats, counts of the phase: the ragged and paged decode kernels'
    device runs)."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve import memledger, qos
    from penroz_tpu_torch.serve import metrics as serve_metrics
    from penroz_tpu_torch.utils import checkpoint, faults, tracing

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(14)
    batch = [rng.integers(0, vocab, n).tolist() for n in QOS_BATCH_LENS]
    ui = [rng.integers(0, vocab, n).tolist() for n in QOS_UI_LENS]
    stats = {}

    def body(prompt, new, **kw):
        return dict({"model_id": model_id, "block_size": block,
                     "temperature": 0, "input": [prompt],
                     "max_new_tokens": new}, **kw)

    def ok_tokens(result, what):
        status, headers, text = result
        check(status == 200, f"{what} -> {status}: {text[:300]}")
        return json.loads(text)["tokens"]

    def serving():
        return json.loads(_qos_call(base, "/serving_stats/")[2])

    def arm(spec):
        faults.reset()
        if spec:
            os.environ[faults.ENV] = spec
        else:
            os.environ.pop(faults.ENV, None)

    for fn in (RPA.ragged_paged_attention, PA.paged_decode_attention):
        fn.runs.reset()
        fn.launches = 0
    totals = {"ragged_paged_attention": 0, "paged_decode_attention": 0}
    DS.reset()
    serve_metrics.reset()
    tracing.reset()
    qos.reset()
    memledger.reset()
    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    try:
        with _env(QOS_ENV):
            if _qos_call(base, f"/progress/?model_id={model_id}")[0] != 200:
                status, _, text = _qos_call(base, "/model/", {
                    "model_id": model_id, "layers": layers,
                    "optimizer": optimizer})
                check(status == 200, f"POST /model/ -> {status}: {text}")

            # -- reference tokens, QoS idle, one request at a time -----------
            t0 = time.monotonic()
            ref = {("b", i): ok_tokens(_qos_call(base, "/generate/", body(
                p, QOS_BATCH_NEW)), "T0") for i, p in enumerate(batch)}
            ref.update({("u", i): ok_tokens(_qos_call(base, "/generate/", body(
                p, QOS_UI_NEW)), "T0") for i, p in enumerate(ui)})
            with _env({"PENROZ_CONTINUOUS_BATCHING": "0"}):
                single = ok_tokens(_qos_call(base, "/generate/", body(
                    ui[0], QOS_UI_NEW)), "single-sequence /generate/")
            check(single == ref[("u", 0)], "the single-sequence paged "
                  "/generate/ differs from the engine's T0")
            totals["paged_decode_attention"] += (
                PA.paged_decode_attention.runs.read())
            check(not on_card or totals["paged_decode_attention"]
                  >= n_attn * QOS_UI_NEW,
                  f"the paged decode kernel ran "
                  f"{totals['paged_decode_attention']} times")
            stats["reference_s"] = time.monotonic() - t0

            def wave(tag):
                """8 batch streams; 4 interactive ones once every row has
                emitted; the ledger polled throughout.  Returns (tokens by
                key, client TTFT by class, wall s, ledger snapshots,
                mixed steps, ragged device runs)."""
                out, ttft = {}, {"batch": [], "interactive": []}
                firsts = [threading.Event() for _ in batch]
                errors, snaps, stop = [], [], threading.Event()

                def fire(key, prompt, new, extra, started):
                    rid = f"{tag}-{key[0]}{key[1]}"
                    try:
                        toks, echoed, first = _qos_stream(
                            base, body(prompt, new, **extra), rid, started)
                        check(echoed == rid, f"{rid}: X-Request-Id {echoed}")
                        out[key] = prompt + toks
                        ttft["interactive" if key[0] == "u"
                             else "batch"].append(first)
                    except Exception as e:  # noqa: BLE001 — checked below
                        errors.append(f"{rid}: {e!r}")

                def poll():
                    while not stop.is_set():
                        status, _, text = _qos_call(base, "/memory/")
                        snaps.append(json.loads(text) if status == 200
                                     else {"status": status})
                        time.sleep(0.01)

                arm(f"decode.step:sleep@{QOS_SLEEP_MS}")
                RPA.ragged_paged_attention.runs.reset()
                poller = threading.Thread(target=poll)
                t0 = time.monotonic()
                with _mixed_steps() as count:
                    poller.start()
                    threads = [threading.Thread(target=fire, args=(
                        ("b", i), p, QOS_BATCH_NEW,
                        {"priority": "batch", "tenant": "flood"}, firsts[i]))
                        for i, p in enumerate(batch)]
                    for th in threads:
                        th.start()
                    rows = int(QOS_ENV["PENROZ_SCHED_MAX_ROWS"])
                    deadline = time.monotonic() + 600
                    while (sum(e.is_set() for e in firsts) < rows
                           and time.monotonic() < deadline):
                        time.sleep(0.002)
                    check(sum(e.is_set() for e in firsts) >= rows,
                          f"{tag}: {rows} batch rows never emitted")
                    ui_threads = [threading.Thread(target=fire, args=(
                        ("u", i), p, QOS_UI_NEW,
                        {"priority": "interactive", "tenant": "ui"}, None))
                        for i, p in enumerate(ui)]
                    for th in ui_threads:
                        th.start()
                    for th in threads + ui_threads:
                        th.join(timeout=600)
                    wall = time.monotonic() - t0
                    stop.set()
                    poller.join(timeout=60)
                arm(None)
                runs = RPA.ragged_paged_attention.runs.read()
                check(not errors, f"{tag}: {errors}")
                return out, ttft, wall, snaps, count["steps"], runs

            # -- the traced wave ---------------------------------------------
            out, ttft, wall, snaps, steps, runs = wave("w1")
            totals["ragged_paged_attention"] += runs
            bad = [k for k in ref if out.get(k) != ref[k]]
            check(not bad, f"wave 1: tokens differ from T0 for {bad}")
            check(not on_card or runs == n_attn * steps > 0,
                  f"wave 1: the ragged kernel ran {runs} times for {steps} "
                  f"mixed steps x {n_attn} layers")
            s1 = serving()
            (eng,) = s1["engines"]
            check(s1["preemptions_total"] >= 1, "no preemption in wave 1")
            cached = s1["preempted_resume_cached_tokens"]
            check(cached >= QOS_PAGE and cached % QOS_PAGE == 0,
                  f"resumed cached tokens {cached}")
            engine = DS._live_engines()[0]
            check(all(nd.refs == 0 for nd in
                      engine._prefix_cache.iter_nodes()),
                  "a radix pin outlived the wave")
            check(engine._ledger.audit("phase 4h") == []
                  and eng["memory"]["audit_failures"] == 0
                  and not s1["breaker_open"] and s1["crashes_total"] == 0,
                  "the strict audit or the engine failed")
            check(len(snaps) >= 5 and all(
                "engines" in m and all(
                    sum(e["pool_pages"].values()) == e["pool_pages_total"]
                    and min(e["pool_pages"].values()) >= 0
                    for e in m["engines"]) for m in snaps),
                f"a /memory/ snapshot does not partition the pool "
                f"({len(snaps)} read)")
            check(any(e["pool_pages"]["row"] for m in snaps
                      for e in m["engines"]), "the poller saw no row pages")
            p99 = s1["ttft_ms_p99_by_class"]
            check(p99["interactive"] < p99["batch"],
                  f"interactive TTFT p99 {p99['interactive']} ms is not "
                  f"below batch's {p99['batch']} ms")
            produced = sum(len(out[k]) - len(p) for k, p in
                           [(("b", i), p) for i, p in enumerate(batch)]
                           + [(("u", i), p) for i, p in enumerate(ui)])
            stats["wave_traced"] = {
                "s": wall, "tokens": produced, "rate": produced / wall,
                "mixed_steps": steps, "ragged_runs": runs,
                "preemptions": s1["preemptions_total"],
                "resume_cached_tokens": cached,
                "ttft_ms_p99_by_class": p99,
                "itl_ms_p50": s1["itl_ms_p50"], "itl_ms_p99": s1["itl_ms_p99"],
                "client_ttft_s": {c: {"p50": _pct(v, 0.5), "max": max(v)}
                                  for c, v in ttft.items()},
                "ledger_snapshots": len(snaps),
                "peak_preempted_pages": max(
                    e["pool_pages"]["preempted"] for m in snaps
                    for e in m["engines"])}
            say("qos", f"wave 1 (traced): {produced} tokens in {wall:.3f} s "
                f"= {produced / wall:.1f} tokens/s, every stream = T0; "
                f"{s1['preemptions_total']} preemptions resumed {cached} "
                f"cached tokens; TTFT p99 interactive {p99['interactive']} "
                f"ms < batch {p99['batch']} ms; ITL p50/p99 "
                f"{s1['itl_ms_p50']}/{s1['itl_ms_p99']} ms; {len(snaps)} "
                f"/memory/ reads whole; ragged {runs} runs = {n_attn} x "
                f"{steps} mixed steps")

            # -- traces of the wave ------------------------------------------
            listed = json.loads(_qos_call(base, "/trace/?limit=50")[2])
            ids = {t["request_id"] for t in listed["traces"]}
            check({f"w1-{k[0]}{k[1]}" for k in ref} <= ids,
                  "/trace/ does not list the wave")
            preempted = [t["request_id"] for t in listed["traces"]
                         if t["request_id"].startswith("w1-b")
                         and t["retire_reason"] == "max_new_tokens"]
            tree = None
            for rid in preempted:
                doc = json.loads(_qos_call(base, f"/trace/{rid}")[2])
                names = [c["name"] for c in doc["root"]["children"]]
                if "preempt" in names:
                    tree = (rid, doc, names)
                    break
            check(tree is not None, "no trace holds a preempt span")
            rid, doc, names = tree
            k = names.index("preempt")
            after = names[k + 1:]
            kids = doc["root"]["children"]
            check(names[:k][:1] == ["queue"] and "prefill" in names[:k]
                  and "decode" in names[:k]
                  and any(c["name"] == "prefill_chunk"
                          for c in kids[names.index("prefill")]["children"])
                  and after[:2] == ["capacity_pressure", "queue"]
                  and "prefill" in after and "decode" in after,
                  f"{rid}'s span tree: {names}")
            match = [c for c in kids[k + 1:] if c["name"] == "prefix_match"]
            check(match and match[0]["meta"]["matched_tokens"] >= QOS_PAGE,
                  f"{rid}: the resume's prefix match {match}")
            check(doc["meta"]["retire_reason"] == "max_new_tokens",
                  f"{rid}: {doc['meta']}")
            chrome = json.loads(_qos_call(
                base, f"/trace/{rid}?format=chrome")[2])["traceEvents"]
            check(chrome and all(e["ph"] == "X" and e["pid"] == rid
                                 for e in chrome), "chrome trace events")
            stats["preempted_trace"] = {"request_id": rid, "spans": names,
                                        "chrome_events": len(chrome)}
            say("qos", f"trace of {rid}: {' > '.join(names)}; "
                f"{len(chrome)} Chrome events")

            # -- /metrics against /serving_stats/ ----------------------------
            def scrape():
                """/metrics parsed line by line as 0.0.4: {series: value}
                and the line count."""
                status, headers, text = _qos_call(base, "/metrics")
                check(status == 200 and "version=0.0.4" in headers.get(
                    "Content-Type", ""), f"/metrics -> {status}")
                lines = text.rstrip("\n").split("\n")
                bad = [ln for ln in lines if not _EXPOSITION.match(ln)]
                check(not bad, f"/metrics lines that do not parse: "
                               f"{bad[:3]}")
                return {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                        for ln in lines if not ln.startswith("#")}, len(lines)

            series, stats["metrics_lines"] = scrape()
            s1 = serving()
            (eng,) = s1["engines"]
            pc = eng["prefix_cache"]
            pairs = {
                'penroz_requests_total{outcome="completed"}':
                    eng["completed"],
                "penroz_preemptions_total": s1["preemptions_total"],
                "penroz_preempted_resume_cached_tokens_total":
                    s1["preempted_resume_cached_tokens"],
                "penroz_prefix_cache_hits_total": pc["hits"],
                "penroz_prefix_cache_misses_total": pc["misses"],
                "penroz_decode_tokens_total": s1["decode_tokens"],
                "penroz_dispatches_total": s1["dispatches_total"],
                'penroz_class_admissions_total{priority="interactive"}':
                    eng["admissions_by_class"]["interactive"]}
            diff = {k: (series.get(k), v) for k, v in pairs.items()
                    if series.get(k) != v}
            check(not diff, f"/metrics differs from /serving_stats/: {diff}")
            emitted = eng["admissions"] - s1["preemptions_total"]
            check(series["penroz_ttft_ms_count"] == emitted
                  == series['penroz_ttft_ms_bucket{le="+Inf"}'],
                  f"TTFT count {series['penroz_ttft_ms_count']}, requests "
                  f"that emitted {emitted}")

            # -- the quota ---------------------------------------------------
            t0 = time.monotonic()
            check(_qos_call(base, "/tenants/flood/quota",
                            {"tokens_per_s": 1}, "PUT")[0] == 200,
                  "PUT /tenants/flood/quota")
            first = ok_tokens(_qos_call(base, "/generate/", body(
                batch[6], QOS_BATCH_NEW, tenant="flood")), "flood in quota")
            check(first == ref[("b", 6)], "the in-quota flood request's "
                  "tokens")
            status, headers, text = _qos_call(base, "/generate/", body(
                batch[6], QOS_BATCH_NEW, tenant="flood"), rid="over-quota")
            retry = int(headers.get("Retry-After", 0))
            check(status == 429 and retry >= 1
                  and headers.get("X-Request-Id") == "over-quota",
                  f"the over-quota request: {status}, Retry-After {retry}")
            check(ok_tokens(_qos_call(base, "/generate/", body(
                ui[1], QOS_UI_NEW, tenant="ui")), "ui under flood's quota")
                  == ref[("u", 1)], "the ui request's tokens")
            tenants = json.loads(_qos_call(base, "/tenants/")[2])["tenants"]
            check(tenants["rejections"] == {"flood": 1}
                  and tenants["overrides"] == {"flood": 1.0},
                  f"/tenants/: {tenants}")
            series, _ = scrape()
            shed = (series.get(
                'penroz_quota_rejections_total{tenant="flood"}'),
                series.get('penroz_requests_total{outcome="quota"}'))
            check(shed == (1, 1) and serving()["quota_rejections"] == 1,
                  f"the quota shed in /metrics {shed} and /serving_stats/")
            check(_qos_call(base, "/tenants/flood/quota",
                            {"tokens_per_s": None}, "PUT")[0] == 200,
                  "clearing the override")
            check(ok_tokens(_qos_call(base, "/generate/", body(
                batch[6], QOS_BATCH_NEW, tenant="flood")), "flood cleared")
                  == ref[("b", 6)], "flood after the override cleared")
            status, _, text = _qos_call(base, "/tenants/flood/quota",
                                        {"tokens_per_s": None, "tier_mb": 8},
                                        "PUT")
            check(status == 200 and json.loads(text)["tier_bytes"] == 8e6,
                  f"the tier_mb override: {status} {text}")
            status, _, text = _qos_call(base, "/tenants/flood/quota",
                                        {"tokens_per_s": None,
                                         "tier_mb": None}, "PUT")
            check(status == 200 and json.loads(text)["tier_bytes"] == 0,
                  f"clearing the tier_mb override: {status} {text}")
            stats["quota"] = {"retry_after": retry,
                              "s": time.monotonic() - t0}
            say("qos", f"quota: flood 200, then 429 Retry-After {retry}; "
                f"ui 200 = T0; cleared: flood 200 = T0")

            # -- the same wave untraced --------------------------------------
            with _env({"PENROZ_TRACE_SAMPLE": "0"}):
                tracing.reset()
                out2, _, wall2, _, steps2, runs2 = wave("w2")
                check(tracing.completed(10) == [] and tracing.live() == [],
                      "a trace was made at PENROZ_TRACE_SAMPLE=0")
            totals["ragged_paged_attention"] += runs2
            bad = [k for k in ref if out2.get(k) != ref[k]]
            check(not bad, f"wave 2 (untraced): tokens differ for {bad}")
            check(not on_card or runs2 == n_attn * steps2 > 0,
                  f"wave 2: ragged runs {runs2}, mixed steps {steps2}")
            stats["wave_untraced"] = {"s": wall2, "tokens": produced,
                                      "rate": produced / wall2,
                                      "mixed_steps": steps2,
                                      "ragged_runs": runs2}
            say("qos", f"wave 2 (PENROZ_TRACE_SAMPLE=0): {produced} tokens "
                f"in {wall2:.3f} s = {produced / wall2:.1f} tokens/s "
                f"(traced {produced / wall:.1f}), every stream = T0")

            # -- a crash in a second engine, and its flight record -----------
            # the second block raises: the first (the prefill) leaves the
            # row pages for the recorder to see
            arm("decode.step:raise@2")
            status, headers, text = _qos_call(base, "/generate/", dict(
                body(ui[2], QOS_UI_NEW), block_size=QOS_CRASH_BLOCK),
                rid="doomed")
            arm(None)
            check(status == 500 and json.loads(text)["request_id"]
                  == "doomed", f"the crashed request: {status} {text[:200]}")
            dump = json.loads(_qos_call(base, "/debug/dump")[2])
            entry = dump["entries"][-1]
            check(dump["recorded"] == 1 and entry["reason"] == "engine_crash"
                  and entry["block_size"] == QOS_CRASH_BLOCK
                  and entry["ledger"]["pool_pages"]["row"] >= 1
                  and "doomed" in entry["recent_traces"]["live"],
                  f"/debug/dump: {json.dumps(dump)[:600]}")
            mem = json.loads(_qos_call(base, "/memory/")[2])
            check(mem["flight_records"] == 1 and len(mem["engines"]) == 2,
                  f"/memory/ after the crash: {mem['flight_records']}")
            if on_card:
                used = sum(v for k, v in mem["hbm_bytes"].items()
                           if k != "adapter_host_cache")
                check(used <= torch.cuda.memory_allocated(),
                      f"the ledger's {used} bytes exceed the "
                      f"{torch.cuda.memory_allocated()} allocated")
                stats["ledger_bytes"] = used
                stats["memory_allocated"] = torch.cuda.memory_allocated()

            # -- the dashboard -----------------------------------------------
            status, headers, _ = _qos_call(base, "/")
            check(status == 302 and headers.get("Location") == "/dashboard",
                  f"/ -> {status}")
            for path in ("/dashboard", "/static/dashboard.js"):
                check(_qos_call(base, path)[0] == 200, f"{path}")
            DS.reset()
    finally:
        arm(None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    for name, n in totals.items():
        check(not on_card or n > 0, f"{name} ran no time in the phase")
    stats["seconds"] = time.monotonic() - t_phase
    say("qos", f"{stats['seconds']:.1f} s; device runs {totals} on {card}")
    return stats, totals


# ---------------------------------------------------------------------------
# 4i: multi-tenant LoRA adapters
# ---------------------------------------------------------------------------

# GPT-2 124M under continuous batching over the paged pool (pages of 128)
# with the prefix cache on, 8 rows; three adapters: a1 every projection
# at rank 16, a2 the first half of the blocks' projections at rank 4 (both B
# random, from seeds 1 and 2), a3 every projection at rank 8 with B zero
# (the base model exactly).
LORA_ENV = dict(CB_ENV, PENROZ_KV_PAGE_SIZE="128", PENROZ_PREFIX_CACHE="1",
                PENROZ_PREFIX_CACHE_PAGES="64")
LORA_ADAPTERS = {"a1": dict(rank=16, init="random", seed=1),
                 "a2": dict(rank=4, init="random", seed=2,
                            blocks=SERVE_DEPTH // 2),
                 "a3": dict(rank=8, init="zeros", seed=3)}
# The wave: 12 streams, 3 each for a1, a2, a3 and the base model, each a
# shared 256-token prefix and its own 64-300 tokens, 64 new tokens.
LORA_PREFIX_LEN = 256
LORA_SUFFIX_LENS = (64, 300, 120, 240, 80, 280, 160, 200, 100, 260, 140,
                    220)
LORA_WAVE_NEW = 64
# Adapter training: rank 8 at 4 x 1024, step 4 (one micro-step an
# epoch), 2 epochs, on phase 5's synthetic shard.
LORA_TRAIN = dict(epochs=2, batch_size=4, block_size=1024, step_size=4)


def _write_train_shard():
    """Phase 5's synthetic uint16 shard, ``data/smoke_000000.npy`` (numpy
    seed 0): the same bytes whichever phase writes it."""
    import numpy as np
    os.makedirs("data", exist_ok=True)
    tokens = np.random.default_rng(0).integers(
        0, TRAIN_VOCAB_USED, TRAIN_TOKENS).astype(np.uint16)
    np.save(os.path.join("data", "smoke_000000.npy"), tokens)


def _file_digest(path):
    import hashlib
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def phase_lora(torch, layers, optimizer, block, vocab, card, device="cuda",
               model_id="smoke_res"):
    """GPT-2 124M fp32 (phase 4g's checkpoint, created when absent) with
    three LoRA adapters: ``/adapters/`` (create, list, detail, a duplicate
    409); single-sequence greedy /generate/ of PROMPT_LEN + NEW_TOKENS with
    each adapter on the contiguous cache and the paged pool, the decode
    kernels' device runs 12 a dispatched step, graph == eager in process,
    a3 (B zero) = the base tokens T0, a1 the argmax (within ARGMAX_ATOL) of
    the card's no-cache forward with the weights merged, a base request
    after a1 = T0; one engine serving the 12-stream wave of a1, a2, a3
    and base rows (each stream = its adapter's single-sequence tokens, the
    ragged kernel 12 a mixed step, prefix hits only inside a namespace,
    3 live adapters, the ``lora_*`` series of ``/metrics`` = those of
    ``/serving_stats/``, ``/memory/``'s ``lora_pack`` = the pack's bytes),
    the same prompts as base rows (the rate without adapters), the wave
    again under PENROZ_LORA_MAX_LIVE=2; ``PUT /train/`` of adapter t1
    (flash and cross-entropy launches a micro-step, the base checkpoint
    unchanged, finite costs, t1 served); one fp32 micro-step's factor
    gradients through the kernels against the plain versions.  Returns
    (stats, counts of the phase: the decode and ragged kernels' device
    runs, the training kernels' launches).  ``device="cpu"`` rehearses it
    at a toy size through the plain versions (no kernel counts)."""
    import numpy as np

    from penroz_tpu_torch.models import lora
    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import adapters
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve import memledger
    from penroz_tpu_torch.serve import metrics as serve_metrics
    from penroz_tpu_torch.utils import checkpoint

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        arch = CompiledArch(layers)
    n_attn = len(arch.attn_layers)
    blocks = [i for i, entry in enumerate(layers) if "residual" in entry]
    rng = np.random.default_rng(15)
    prompt = rng.integers(0, vocab, PROMPT_LEN).tolist()
    prefix = rng.integers(0, vocab, LORA_PREFIX_LEN).tolist()
    wave_prompts = [prefix + rng.integers(0, vocab, n).tolist()
                    for n in LORA_SUFFIX_LENS]
    wave_ids = [("a1", "a2", "a3", None)[i % 4]
                for i in range(len(wave_prompts))]
    counters = _kernel_counters()
    device_counted = dict(_decode_counters(),
                          ragged_paged_attention=RPA.ragged_paged_attention)
    totals = dict.fromkeys(counters, 0)
    stats = {}

    def harvest():
        """Add the counts since the last harvest to the phase's totals and
        zero them: device runs of the decode and ragged kernels, launches
        of the others."""
        for name, fn in counters.items():
            if name in device_counted:
                totals[name] += fn.runs.read()
                fn.runs.reset()
            else:
                totals[name] += fn.launches
            fn.launches = 0

    def call(path, body=None, method=None):
        status, _, text = _qos_call(base, path, body, method)
        return status, (json.loads(text) if text else None)

    def gen(p, new, aid=None):
        body = {"model_id": model_id, "input": [p], "block_size": block,
                "max_new_tokens": new, "temperature": 0}
        if aid is not None:
            body["adapter_id"] = aid
        status, out = call("/generate/", body)
        check(status == 200, f"/generate/ ({aid}) -> {status}: {out}")
        return out["tokens"]

    DS.reset()
    adapters.REGISTRY.reset()
    serve_metrics.reset()
    harvest()
    for name in totals:
        totals[name] = 0
    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    try:
        if call(f"/progress/?model_id={model_id}")[0] != 200:
            status, out = call("/model/", {"model_id": model_id,
                                           "layers": layers,
                                           "optimizer": optimizer})
            check(status == 200, f"POST /model/ -> {status}: {out}")
        for aid in list(LORA_ADAPTERS) + ["t1"]:
            call(f"/adapters/?adapter_id={aid}", method="DELETE")

        # -- the lifecycle ------------------------------------------------
        t0 = time.monotonic()
        for aid, spec in LORA_ADAPTERS.items():
            body = {"model_id": model_id, "adapter_id": aid,
                    "rank": spec["rank"], "init": spec["init"],
                    "seed": spec["seed"]}
            if "blocks" in spec:
                body["targets"] = [f"layers.{i}."
                                   for i in blocks[:spec["blocks"]]]
            status, out = call("/adapters/", body)
            check(status == 200 and out["config"]["rank"] == spec["rank"],
                  f"POST /adapters/ {aid} -> {status}: {out}")
        status, out = call("/adapters/", {"model_id": model_id,
                                          "adapter_id": "a1"})
        check(status == 409, f"a duplicate POST /adapters/ -> {status}")
        status, out = call("/adapters/")
        listed = {a["adapter_id"]: a for a in out["adapters"]}
        check(status == 200 and set(LORA_ADAPTERS) <= set(listed),
              f"GET /adapters/ -> {status}: {sorted(listed)}")
        status, out = call("/adapters/?adapter_id=a1")
        check(status == 200 and out["rank"] == 16 and out["alpha"] == 32.0
              and out["status"]["code"] == "Created",
              f"GET /adapters/?adapter_id=a1 -> {status}: {out}")
        trees = {}
        for aid in LORA_ADAPTERS:
            entry = adapters.REGISTRY.acquire(aid, model_id)
            trees[aid] = (entry.params, entry.config)
            adapters.REGISTRY.release(entry)
        stats["targets"] = {aid: len([k for k in t[0] if k.endswith("A")])
                            for aid, t in trees.items()}
        stats["lifecycle_s"] = time.monotonic() - t0
        say("lora", f"/adapters/: a1, a2, a3 created ({stats['targets']} "
            f"targeted projections), listed, a1's detail, a duplicate 409; "
            f"{stats['lifecycle_s']:.1f} s")

        # -- single-sequence /generate/, both caches ------------------------
        model = NeuralNetworkModel.deserialize(model_id, device=device,
                                               optimizer=False)
        single = {}
        for cache, env in (("contiguous", {"PAGED_KV_CACHE": "0"}),
                           ("paged", {"PAGED_KV_CACHE": "1",
                                      "PENROZ_KV_PAGE_SIZE": "128"})):
            with _env(dict(env, PENROZ_CONTINUOUS_BATCHING="0")):
                harvest()
                _zero_decode_counts()
                ledger = _StepLedger()
                out = {}
                with ledger.request():
                    out[None] = gen(prompt, NEW_TOKENS)
                for aid in ("a1", "a2", "a3"):
                    with ledger.request():
                        out[aid] = gen(prompt, NEW_TOKENS, aid)
                with ledger.request():
                    after = gen(prompt, NEW_TOKENS)
                if on_card:
                    _check_launches(n_attn, ledger, f"lora {cache}")
                harvest()
                check(after == out[None], f"{cache}: a base request after "
                      f"a1 differs from T0")
                check(out["a3"] == out[None], f"{cache}: a3 (B zero) "
                      f"differs from T0")
                check(out["a1"] != out[None] and out["a2"] != out[None],
                      f"{cache}: a random adapter served the base tokens")
                # in process: the eager step loop gives the graphs' tokens
                with _graphs(False):
                    for aid in ("a1", "a2", "a3"):
                        eager = lora.bind_model(model, *trees[aid]) \
                            .generate_tokens([prompt], block, NEW_TOKENS,
                                             temperature=0)
                        check(eager == out[aid], f"{cache}: {aid}'s graph "
                              f"tokens differ from the eager step loop's")
                harvest()
                single[cache] = out
                say("lora", f"{cache}: T0, a1, a2, a3 (= T0), base after "
                    f"a1 (= T0) over HTTP, graph == eager in process; "
                    f"decode kernel runs "
                    f"{n_attn} a dispatched step ({ledger.steps})")
        # a1 against the card's no-cache forward of the merged weights
        merged = lora.merge_weights(dict(model.arch.named_parameters()),
                                    *trees["a1"])
        merged = {k: v.to(device) for k, v in merged.items()}
        worst = 0.0
        with torch.inference_mode():
            for cache, out in single.items():
                seq = out["a1"]
                x = torch.tensor([seq[:-1]], device=device)
                acts, _, _ = torch.func.functional_call(
                    model.arch, merged, (x,), {"skip_softmax": True})
                logits = acts[-1][0, PROMPT_LEN - 1:].float()
                picked = torch.tensor(seq[PROMPT_LEN:], device=device)
                gap = logits.max(-1).values - logits.gather(
                    -1, picked[:, None])[:, 0]
                worst = max(worst, float(gap.max()))
        harvest()
        stats["a1_argmax_worst_gap"] = worst
        stats["single_caches_agree"] = {
            aid: single["contiguous"][aid] == single["paged"][aid]
            for aid in (None, "a1", "a2", "a3")}
        say("lora", f"a1's tokens are the argmax of the merged weights' "
            f"forward: worst gap {worst:.2e} (<= {ARGMAX_ATOL}); caches "
            f"agree {stats['single_caches_agree']}")
        check(worst <= ARGMAX_ATOL, f"an a1 token is {worst:.3e} below the "
              f"top logit of the merged weights' forward")
        if on_card:
            timing = {}
            for aid in (None, "a1"):
                bound = (model if aid is None
                         else lora.bind_model(model, *trees[aid]))
                _, timing[aid or "base"] = _decode_timing(
                    torch, bound, prompt, block, True)
            harvest()
            stats["decode"] = timing
            say("lora", f"graph decode, contiguous cache: base "
                f"{timing['base']['tokens_per_s']:.1f} tokens/s, a1 "
                f"{timing['a1']['tokens_per_s']:.1f} (rank 16, every "
                f"projection); a1 {_trace_text(timing['a1'])} on {card}")

        # -- the mixed engine ---------------------------------------------
        with _env(LORA_ENV):
            refs = []
            for p, aid in zip(wave_prompts, wave_ids):
                bound = (model if aid is None
                         else lora.bind_model(model, *trees[aid]))
                refs.append(bound.generate_tokens([p], block, LORA_WAVE_NEW,
                                                  temperature=0))
            harvest()

            def wave(ids, tag):
                """The 12 streams at once on a fresh engine: (tokens, wall
                s, mixed steps, ragged device runs, engine)."""
                DS.reset()
                serve_metrics.reset()
                engine = DS.get_engine(model_id, block, 0, None,
                                       device=server.device)
                seen = []
                cache = engine._prefix_cache
                real_match, real_insert = cache.match, cache.insert
                page_ns = {}

                def match(tokens, limit=None, namespace=None):
                    nodes = real_match(tokens, limit, namespace)
                    seen.append((namespace, [page_ns.get(nd.page)
                                             for nd in nodes]))
                    return nodes

                def insert(tokens, limit=None, namespace=None):
                    created = real_insert(tokens, limit, namespace)
                    for _, page in created:
                        page_ns[page] = namespace
                    return created

                cache.match, cache.insert = match, insert
                harvest()
                results, errors = [None] * len(ids), []

                def fire(i):
                    try:
                        results[i] = gen(wave_prompts[i], LORA_WAVE_NEW,
                                         ids[i])
                    except BaseException as e:  # noqa: BLE001
                        errors.append(e)

                with _mixed_steps() as steps:
                    threads = [threading.Thread(target=fire, args=(i,))
                               for i in range(len(ids))]
                    t0 = time.monotonic()
                    for t in threads:
                        t.start()
                    for t in threads:
                        t.join(900)
                    wall = time.monotonic() - t0
                check(not errors, f"{tag}: {errors[:1]}")
                runs = RPA.ragged_paged_attention.runs.read()
                harvest()
                check(not on_card or runs == n_attn * steps["steps"],
                      f"{tag}: the ragged kernel ran {runs} times, expected "
                      f"{n_attn} x {steps['steps']} mixed steps")
                crossed = [(ns, pages) for ns, pages in seen
                           if any(p != ns for p in pages)]
                check(not crossed, f"{tag}: prefix pages matched across "
                      f"namespaces: {crossed[:2]}")
                hits = sum(1 for _, pages in seen if pages)
                return results, wall, steps["steps"], runs, engine, hits

            # the same prompts, every row base: the rate without adapters
            base_out, base_wall, base_steps, _, _, _ = wave(
                [None] * len(wave_prompts), "base wave")
            out, wall, n_steps, runs, engine, hits = wave(wave_ids,
                                                          "lora wave")
            for i, (got, want, p) in enumerate(zip(out, refs,
                                                   wave_prompts)):
                check(got == want, f"stream {i} ({wave_ids[i]}): the "
                      f"engine's tokens differ from the single-sequence "
                      f"path's")
                if wave_ids[i] is None:
                    check(base_out[i] == want, f"base wave stream {i}")
            s = json.loads(_qos_call(base, "/serving_stats/")[2])
            (eng,) = s["engines"]
            check(eng["lora_active_adapters"] == 3 and s[
                "lora_active_adapters"] == 3, f"lora_active_adapters "
                f"{eng['lora_active_adapters']}")
            want_tokens = {aid: 3 * LORA_WAVE_NEW for aid in LORA_ADAPTERS}
            check(s["lora_adapter_tokens"] == want_tokens, f"lora_adapter_"
                  f"tokens {s['lora_adapter_tokens']}")
            status, headers, text = _qos_call(base, "/metrics")
            lines = text.rstrip("\n").split("\n")
            check(status == 200 and all(_EXPOSITION.match(ln)
                                        for ln in lines), "/metrics")
            series = {ln.rsplit(" ", 1)[0]: float(ln.rsplit(" ", 1)[1])
                      for ln in lines if not ln.startswith("#")}
            pairs = {"penroz_lora_live_adapters": s["lora_active_adapters"]}
            pairs.update({f'penroz_lora_adapter_tokens_total{{adapter_id='
                          f'"{aid}"}}': n
                          for aid, n in s["lora_adapter_tokens"].items()})
            diff = {k: (series.get(k), v) for k, v in pairs.items()
                    if series.get(k) != v}
            check(not diff, f"/metrics' lora series differ from "
                  f"/serving_stats/: {diff}")
            mem = json.loads(_qos_call(base, "/memory/")[2])
            pack_bytes = sum(t.numel() * t.element_size()
                             for ent in engine._lora_pack.values()
                             for t in ent.values())
            check(mem["engines"][0]["hbm_bytes"]["lora_pack"] == pack_bytes
                  == mem["hbm_bytes"]["lora_pack"] > 0,
                  f"/memory/ lora_pack {mem['hbm_bytes']['lora_pack']} != "
                  f"the pack's {pack_bytes} bytes")
            check(mem["hbm_bytes"]["adapter_host_cache"]
                  == adapters.REGISTRY.cache_bytes() > 0,
                  "/memory/ adapter_host_cache")
            new = LORA_WAVE_NEW * len(wave_prompts)
            stats["wave"] = {
                "s": wall, "tokens_per_s": new / wall, "mixed_steps":
                    n_steps, "ragged_runs": runs, "prefix_hits": hits,
                "base_s": base_wall, "base_tokens_per_s": new / base_wall,
                "base_mixed_steps": base_steps, "lora_pack_bytes":
                    pack_bytes, "adapter_host_cache_bytes":
                    mem["hbm_bytes"]["adapter_host_cache"]}
            say("lora", f"wave of 12 (a1, a2, a3, base x 3; 256-token "
                f"prefix + 64-300, 64 new): every stream = its adapter's "
                f"single-sequence tokens; {new / wall:.1f} tokens/s with "
                f"adapters against {new / base_wall:.1f} on the same "
                f"prompts without ({wall:.3f} / {base_wall:.3f} s, "
                f"{n_steps} / {base_steps} mixed steps); ragged runs "
                f"{runs} = {n_attn} x {n_steps}; {hits} prefix hits, none "
                f"across namespaces; 3 live adapters; /metrics = "
                f"/serving_stats/; lora_pack {pack_bytes} bytes on {card}")
            with _env({lora.MAX_LIVE_ENV: "2"}):
                out2, wall2, steps2, _, engine2, _ = wave(
                    wave_ids, "lora wave, 2 live slots")
            check(out2 == refs, "under PENROZ_LORA_MAX_LIVE=2 a stream "
                  "differs from the single-sequence tokens")
            check(engine2.live_adapters == 2, "2 live slots")
            stats["wave_max_live_2"] = {"s": wall2, "mixed_steps": steps2,
                                        "tokens_per_s": new / wall2}
            say("lora", f"the wave under PENROZ_LORA_MAX_LIVE=2: every "
                f"stream complete and equal, {new / wall2:.1f} tokens/s, "
                f"{steps2} mixed steps")
            DS.reset()

        # -- adapter training ---------------------------------------------
        _write_train_shard()
        src = checkpoint.source_path(model_id)
        before = _file_digest(src)
        train = dict({"model_id": model_id, "dataset_id": "smoke",
                      "shard": 0, "adapter": {"adapter_id": "t1",
                                              "rank": 8}}, **LORA_TRAIN)
        micro_steps = LORA_TRAIN["epochs"] * (
            LORA_TRAIN["batch_size"] // LORA_TRAIN["step_size"])
        harvest()
        t0 = time.monotonic()
        status, out = call("/train/", train, "PUT")
        check(status == 202, f"PUT /train/ with an adapter -> {status}: "
              f"{out}")
        detail = None
        while time.monotonic() - t0 < 600:
            status, detail = call("/adapters/?adapter_id=t1")
            if status == 200 and detail["status"]["code"] in ("Trained",
                                                              "Error"):
                break
            time.sleep(0.2)
        check(server.join_training(timeout=300), "training still running")
        launches = {name: counters[name].launches for name in
                    _training_counters()}
        harvest()
        check(detail["status"]["code"] == "Trained",
              f"adapter training ended {detail['status']}")
        costs = [p["cost"] for p in detail["progress"]]
        check(len(costs) == LORA_TRAIN["epochs"]
              and all(math.isfinite(c) for c in costs),
              f"adapter training costs {costs}")
        if on_card:
            for name, per in (("flash_attention_fwd", n_attn),
                              ("flash_attention_bwd", n_attn),
                              ("ce_forward", 1), ("ce_backward", 1)):
                check(launches[name] == per * micro_steps,
                      f"adapter training: {name} launched "
                      f"{launches[name]} times, expected {per} x "
                      f"{micro_steps} micro-steps")
        check(_file_digest(checkpoint.source_path(model_id)) == before,
              "the base checkpoint changed under adapter training")
        epoch_s = [p["durationInSecs"] for p in detail["progress"]]
        tokens = LORA_TRAIN["batch_size"] * LORA_TRAIN["block_size"]
        stats["training"] = {"costs": costs, "epoch_s": epoch_s,
                             "launches": launches,
                             "request_s": time.monotonic() - t0,
                             "tokens_per_s": tokens / epoch_s[-1]}
        served_t1 = gen(prompt[:16], 16, "t1")
        check(len(served_t1) == len(prompt[:16]) + 16, "t1 served")
        say("lora", f"PUT /train/ adapter t1 (rank 8, every projection) "
            f"at {LORA_TRAIN['batch_size']} x {LORA_TRAIN['block_size']}, "
            f"{micro_steps} micro-steps: costs "
            f"{[round(c, 4) for c in costs]}, launches {launches}, the "
            f"base checkpoint unchanged, t1 served; epoch 2 "
            f"{epoch_s[-1]:.4f} s = {tokens / epoch_s[-1]:.0f} tokens/s "
            f"on {card}")

        # -- one fp32 micro-step's factor gradients: kernels vs plain ------
        g = torch.Generator().manual_seed(3)
        x = torch.randint(0, vocab, (1, block), generator=g).to(device)
        y = torch.randint(0, vocab, (1, block), generator=g).to(device)
        leaves = {k: lora.as_tensor(v).to(device).requires_grad_(True)
                  for k, v in trees["a1"][0].items()}
        binding = lora.bind(leaves, trees["a1"][1], device)
        base_params = {k: p.detach()
                       for k, p in model.arch.named_parameters()}

        def step():
            with torch.enable_grad():
                _, cost, _ = torch.func.functional_call(
                    model.arch, base_params, (x, y),
                    {"skip_softmax": True, "training": True,
                     "generator": torch.Generator(device=device),
                     "adapter": binding})
                return cost.detach(), torch.autograd.grad(
                    cost, list(leaves.values()))

        cost, grads = step()
        with plain_kernels():
            ref_cost, ref_grads = step()
        harvest()
        loss_err = abs(float(cost) - float(ref_cost))
        worst = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                    for a, b in zip(grads, ref_grads))
        stats["micro_step"] = {"loss": float(cost),
                               "plain_loss": float(ref_cost),
                               "loss_abs_err": loss_err,
                               "grad_worst_rel_err": worst}
        say("lora", f"fp32 adapter micro-step B1 T{block}: loss "
            f"{float(cost):.6f} vs plain {float(ref_cost):.6f}; worst "
            f"factor gradient max|diff|/max|g| {worst:.2e} (<= "
            f"{STEP_GRAD_RTOL}) over {len(leaves)} factors")
        check(loss_err <= STEP_LOSS_RTOL * abs(float(ref_cost)),
              f"adapter micro-step loss differs by {loss_err:.3e}")
        check(worst <= STEP_GRAD_RTOL, f"adapter micro-step factor "
              f"gradients differ: {worst:.3e} x max |g|")
        del model, merged, leaves, grads, ref_grads
        for aid in list(LORA_ADAPTERS) + ["t1"]:
            call(f"/adapters/?adapter_id={aid}", method="DELETE")
        DS.reset()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        server.join_training(timeout=60)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    for name, n in totals.items():
        check(not on_card or n > 0, f"{name} ran no time in the phase")
    stats["seconds"] = time.monotonic() - t_phase
    say("lora", f"{stats['seconds']:.1f} s; device runs and launches "
        f"{totals} on {card}")
    return stats, totals


# ---------------------------------------------------------------------------
# 4j: the replica router and disaggregated prefill
# ---------------------------------------------------------------------------

ROUTER_ENV = dict(CB_ENV, PENROZ_PREFIX_CACHE="1",
                  PENROZ_PREFIX_CACHE_PAGES="64", PENROZ_MEMLEDGER_STRICT="1",
                  TURBO_QUANT_KV_CACHE="0")
ROUTER_PAGE = 128
# The wave: 3 prompt families of 4 streams, each a shared 256-token prefix
# and its own 16-200 tokens, 64 new tokens, submitted one after another
# from one thread (the family order A B C A B C ...) and read afterwards.
ROUTER_PREFIX_LEN = 256
ROUTER_SUFFIX_LENS = (16, 200, 48, 120, 64, 180, 96, 32, 150, 80, 24, 110)
ROUTER_NEW = 64
ROUTER_FAMILIES = 3
ROUTER_REPLICAS = 3
ROUTER_SHORT = 16        # a crash request's prompt: no whole page, no
#                          fingerprint, so placement goes by load alone
# The device's busy share: a torch.profiler trace of this window of a wave,
# this long after its last submission (a whole wave's trace takes longer
# to process than the wave itself)
ROUTER_BUSY_DELAY_S = 0.2
ROUTER_BUSY_WINDOW_S = 1.0


def _rates(tokens_per_s, wall, steps, load_s, busy):
    """A profiled wave's figures: its rate, and the device's busy ms and
    share of the traced window (None off the card)."""
    busy_ms, window_ms = busy or (None, None)
    return {"tokens_per_s": tokens_per_s, "wall_s": wall,
            "mixed_steps": steps, "load_s": load_s, "busy_ms": busy_ms,
            "window_ms": window_ms,
            "busy_share": busy_ms / window_ms if busy else None}


def _share(figures):
    share = figures["busy_share"]
    return "not measured" if share is None else f"{share:.1%}"


def phase_router(torch, layers, optimizer, block, vocab, card, device="cuda",
                 model_id="smoke_res"):
    """GPT-2 124M fp32 (phase 4g's checkpoint, created when absent), pages
    of 128, 64 prefix-cache pages, 8 rows a replica, strict ledger: (a) the
    12-stream wave on ONE engine, its tokens T, rate and device busy share
    (a torch.profiler window of a repeat) the yardstick; (b) the same wave,
    measured the same way, through PENROZ_SCHED_REPLICAS=3 (every stream = T,
    affinity 9 hits / 3 misses with each family on one replica, /metrics'
    router_* = /serving_stats/, clean audits); (c) crashes open replica
    0's breaker, the next requests fail over (= T), /readyz 200, a
    half-open probe readmits replica 0 (= T), then every breaker open: a
    503 with Retry-After in [1, 30], /readyz 503, failovers counted, and
    PENROZ_SCHED_FALLBACK=1 serving the request through the paged decode
    kernel (= T); (d) PENROZ_DISAGG_PREFILL=1 with one prefill replica,
    affinity off so every request takes the hand-off: the wave over the
    d2d and the host transport on fp32 and on int8 pages (= T, and = the
    single-engine int8 wave), exports = imports = 12, no failure, every
    /memory/ read during a wave partitioning each pool with its transit
    pages, no blob in shm or page parked after; one disagg.d2d fault
    (falls back to host) and one disagg.handoff fault (monolithic), each
    = T; (e) PENROZ_DISAGG_ELASTIC=1 with two prefill replicas and bounds
    that flip one to decode: one role change, a stream of each family = T
    after it, clean audits.
    Every wave's ragged device runs = the attention layers x the mixed
    steps of every replica.  Returns (stats, the phase's counts: the
    ragged and paged kernels' device runs).  ``device="cpu"`` rehearses
    it at a toy size through the plain versions (no kernel counts)."""
    import glob

    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve import metrics as serve_metrics
    from penroz_tpu_torch.serve import router as router_mod
    from penroz_tpu_torch.utils import checkpoint, faults

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(16)
    prefixes = [rng.integers(0, vocab, ROUTER_PREFIX_LEN).tolist()
                for _ in range(ROUTER_FAMILIES)]
    prompts = [prefixes[i % ROUTER_FAMILIES]
               + rng.integers(0, vocab, n).tolist()
               for i, n in enumerate(ROUTER_SUFFIX_LENS)]
    short = rng.integers(0, vocab, ROUTER_SHORT).tolist()
    totals = {"ragged_paged_attention": 0, "paged_decode_attention": 0}
    stats = {}
    env_a = dict(ROUTER_ENV, PENROZ_KV_PAGE_SIZE=str(ROUTER_PAGE),
                 PENROZ_SCHED_REPLICAS="1")
    stats["marks"] = {}

    def mark(part):
        stats["marks"][part] = round(time.monotonic() - t_phase, 1)

    def harvest():
        totals["ragged_paged_attention"] += RPA.ragged_paged_attention.runs \
            .read()
        totals["paged_decode_attention"] += PA.paged_decode_attention.runs \
            .read()
        for fn in (RPA.ragged_paged_attention, PA.paged_decode_attention):
            fn.runs.reset()
            fn.launches = 0

    def call(path, body=None, method=None):
        status, headers, text = _qos_call(base, path, body, method)
        try:
            out = json.loads(text) if text else None
        except ValueError:
            out = text
        return status, headers, out

    def body(p):
        return {"model_id": model_id, "input": [p], "block_size": block,
                "max_new_tokens": ROUTER_NEW, "temperature": 0}

    def arm(spec):
        faults.reset()
        if spec:
            os.environ[faults.ENV] = spec
        else:
            os.environ.pop(faults.ENV, None)

    def gen(p, what):
        status, _, out = call("/generate/", body(p))
        check(status == 200, f"{what}: /generate/ -> {status}: {out}")
        return out["tokens"]

    def sstats():
        status, _, out = call("/serving_stats/")
        check(status == 200, f"/serving_stats/ -> {status}")
        return out

    def wave(tag, profiled=False, poll_memory=False):
        """The 12 streams, opened one after another from this thread (the
        submissions in order), then read: (sequences, wall s, mixed steps,
        (device busy ms, window ms) or None, /memory/ reads).  ``profiled``
        traces the card's activity over ROUTER_BUSY_WINDOW_S from
        ROUTER_BUSY_DELAY_S after the last submission: the busy share of
        the wave's steady state, at a fraction of a whole trace's cost
        (the trace's processing stalls the workers, so a traced wave's
        own rate is not kept)."""
        harvest()
        mem_reads = []
        stop = threading.Event()

        def poll():
            while not stop.is_set():
                status, _, out = call("/memory/")
                if status == 200:
                    mem_reads.append(out)
                time.sleep(0.1)

        poller = threading.Thread(target=poll, daemon=True)
        busy = None
        with _mixed_steps() as steps:
            if poll_memory:
                poller.start()
            t0 = time.monotonic()
            resps = []
            for p in prompts:
                req = urllib.request.Request(
                    base + "/generate/",
                    data=json.dumps(dict(body(p), stream=True)).encode(),
                    method="POST",
                    headers={"Content-Type": "application/json"})
                resps.append(urllib.request.urlopen(req, timeout=900))
            if profiled and on_card:
                from torch.profiler import ProfilerActivity, profile
                time.sleep(ROUTER_BUSY_DELAY_S)
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    tw = time.monotonic()
                    time.sleep(ROUTER_BUSY_WINDOW_S)
                    torch.cuda.synchronize()
                    window_ms = (time.monotonic() - tw) * 1e3
                busy = (sum(_device_kernel_ms(torch, prof).values()),
                        window_ms)
                check(busy[0] > 0, f"{tag}: the profiler saw no device "
                      f"time")
            outs = []
            for p, resp in zip(prompts, resps):
                with resp:
                    check(resp.status == 200, f"{tag}: status {resp.status}")
                    outs.append(p + [int(line) for line in resp])
            if on_card:
                torch.cuda.synchronize()
            wall = time.monotonic() - t0
            stop.set()
            if poll_memory:
                poller.join(30)
        runs = RPA.ragged_paged_attention.runs.read()
        harvest()
        check(not on_card or runs == n_attn * steps["steps"] > 0,
              f"{tag}: the ragged kernel ran {runs} times for "
              f"{steps['steps']} mixed steps x {n_attn} layers")
        for i, seq in enumerate(outs):
            check(len(seq) == len(prompts[i]) + ROUTER_NEW,
                  f"{tag}: stream {i} came back short")
        return outs, wall, steps["steps"], busy, mem_reads

    def rate(wall):
        return len(prompts) * ROUTER_NEW / wall

    def group():
        engine = DS.get_engine(model_id, block, 0, None,
                               device=server.device)
        check(isinstance(engine, router_mod.EngineRouter)
              and len(engine.replicas) == ROUTER_REPLICAS,
              f"PENROZ_SCHED_REPLICAS={ROUTER_REPLICAS} did not give a "
              f"{ROUTER_REPLICAS}-replica router: {engine!r}")
        return engine

    def audit(router, what):
        for e in router.replicas:
            problems = e._ledger.audit(what)
            check(not problems, f"{what}: replica {e.replica}'s audit: "
                  f"{problems}")
            check(not e._transit_rows, f"{what}: replica {e.replica} "
                  f"still parks rows {sorted(e._transit_rows)}")
        blobs = glob.glob(os.path.join(checkpoint.SHM_PATH, "**",
                                       "pageblob_*"), recursive=True)
        check(not blobs, f"{what}: page blobs left in shm: {blobs[:3]}")

    def exposition(name, **labels):
        text = _qos_call(base, "/metrics")[2]
        want = name + ("{" + ",".join(f'{k}="{v}"' for k, v in
                                      labels.items()) + "}" if labels
                       else "")
        for line in text.splitlines():
            if line.startswith(want + " "):
                return float(line.split()[-1])
        return 0.0

    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    DS.reset()
    harvest()
    for name in totals:
        totals[name] = 0
    try:
        if call(f"/progress/?model_id={model_id}")[0] != 200:
            status, _, out = call("/model/", {"model_id": model_id,
                                              "layers": layers,
                                              "optimizer": optimizer})
            check(status == 200, f"POST /model/ -> {status}: {out}")

        # -- (a) one engine: the reference tokens T -------------------------
        with _env(env_a):
            DS.reset()
            t0 = time.monotonic()
            engine = DS.get_engine(model_id, block, 0, None,
                                   device=server.device)
            load_s = time.monotonic() - t0
            T, wall, steps, _, _ = wave("one engine")
            again, _, _, busy, _ = wave("one engine, traced", profiled=True)
            check(again == T, "(a): the traced repeat differs from T")
            check(engine._ledger.audit("router (a)") == [],
                  "(a): the audit failed")
        stats["one_engine"] = _rates(rate(wall), wall, steps, load_s, busy)
        mark("a")
        say("router", f"(a) one engine: 12 streams x {ROUTER_NEW} new, "
            f"{rate(wall):.1f} tokens/s ({wall:.3f} s, {steps} mixed "
            f"steps); device busy {_share(stats['one_engine'])} of a "
            f"{ROUTER_BUSY_WINDOW_S} s window traced in a repeat (prefixes "
            f"cached); engine load "
            f"{load_s:.2f} s, on {card}")

        # -- (b) three replicas behind the router ---------------------------
        env_b = dict(env_a, PENROZ_SCHED_REPLICAS=str(ROUTER_REPLICAS),
                     PENROZ_ENGINE_MAX_CRASHES="2",
                     PENROZ_BREAKER_COOLDOWN_MS="100000")
        with _env(env_b):
            DS.reset()
            serve_metrics.reset()
            t0 = time.monotonic()
            router = group()
            load_s = time.monotonic() - t0
            out, wall, steps, _, _ = wave("three replicas")
            for i, (got, want) in enumerate(zip(out, T)):
                check(got == want, f"(b): stream {i} differs from T")
            s = sstats()
            per = [e.stats() for e in router.replicas]
            fam_replicas = []
            for f in range(ROUTER_FAMILIES):
                fps = router._fingerprints(prefixes[f] + [0])
                fam_replicas.append(router._affinity_target(fps))
            check((s["router_affinity_hits"], s["router_affinity_misses"])
                  == (9, 3) and s["router_replicas"] == ROUTER_REPLICAS,
                  f"(b): affinity {s['router_affinity_hits']} hits / "
                  f"{s['router_affinity_misses']} misses, expected 9 / 3")
            admitted = sorted(p["admissions"] for p in per)
            check(sum(admitted) == len(prompts)
                  and all(n % 4 == 0 for n in admitted),
                  f"(b): admissions by replica {admitted}: a family split")
            metr = {"hit": exposition("penroz_router_affinity_total",
                                      outcome="hit"),
                    "miss": exposition("penroz_router_affinity_total",
                                       outcome="miss"),
                    "failovers": exposition("penroz_router_failovers_total")}
            check(metr == {"hit": s["router_affinity_hits"],
                           "miss": s["router_affinity_misses"],
                           "failovers": s["router_failovers"]},
                  f"(b): /metrics router_* {metr} != /serving_stats/")
            audit(router, "router (b)")
            again, _, _, busy, _ = wave("three replicas, traced",
                                        profiled=True)
            check(again == T, "(b): the traced repeat differs from T")
            stats["replicas"] = dict(
                _rates(rate(wall), wall, steps, load_s, busy),
                admissions=[p["admissions"] for p in per],
                dispatches_by_replica=[p["dispatches_total"] for p in per],
                family_replicas=fam_replicas)
            one = stats["one_engine"]
            say("router", f"(b) {ROUTER_REPLICAS} replicas: every stream = "
                f"T, affinity 9 hits / 3 misses (families on replicas "
                f"{fam_replicas}), /metrics = /serving_stats/, audits "
                f"clean; {rate(wall):.1f} tokens/s = "
                f"{rate(wall) / one['tokens_per_s']:.2f} x (a) ({steps} "
                f"mixed steps over the replicas), device busy "
                f"{_share(stats['replicas'])} against (a)'s "
                f"{_share(one)}; group load {load_s:.2f} s")
            mark("b")

            # -- (c) failover, the probe, every breaker open ----------------
            t0 = time.monotonic()
            r0 = router.replicas[0]
            arm("decode.step:raise@1+")
            crashed = [call("/generate/", body(short))[0] for _ in range(2)]
            arm(None)
            check(crashed == [500, 500] and r0._breaker_open,
                  f"(c): crashes answered {crashed}, replica 0 breaker "
                  f"{r0._breaker_open}")
            fam = [i for i in range(len(prompts))
                   if i % ROUTER_FAMILIES == fam_replicas.index(0)] \
                if 0 in fam_replicas else [0, 3]
            for i in fam:
                check(gen(prompts[i], "(c) failover") == T[i],
                      f"(c): stream {i} after replica 0 opened differs "
                      f"from T")
            status, _, ready = call("/readyz")
            check(status == 200, f"(c): /readyz with one replica open: "
                  f"{status} {ready}")
            done0 = r0.stats()["completed"]
            with _env({"PENROZ_BREAKER_COOLDOWN_MS": "0",
                       router_mod.AFFINITY_ENV: "0"}):
                check(gen(prompts[0], "(c) probe") == T[0],
                      "(c): the probe's tokens differ from T")
            check(not r0._breaker_open
                  and r0.stats()["completed"] == done0 + 1,
                  "(c): the probe did not readmit replica 0")
            with _env({"PENROZ_ENGINE_MAX_CRASHES": "1",
                       router_mod.AFFINITY_ENV: "0"}):
                arm("decode.step:raise@1+")
                crashed = [call("/generate/", body(short))[0]
                           for _ in range(ROUTER_REPLICAS)]
                status, headers, out = call("/generate/", body(prompts[0]))
                retry = headers.get("Retry-After")
                check(crashed == [500] * ROUTER_REPLICAS and status == 503
                      and retry is not None and 1 <= int(retry) <= 30,
                      f"(c): every replica open: crashes {crashed}, then "
                      f"{status} Retry-After {retry}: {out}")
                status, _, ready = call("/readyz")
                check(status == 503
                      and ready["breaker_open_engines"] == [model_id],
                      f"(c): /readyz with every replica open: {status} "
                      f"{ready}")
                s = sstats()
                check(s["router_failovers"] >= 1 and s[
                    "router_failovers"] == exposition(
                        "penroz_router_failovers_total"),
                      f"(c): router_failovers {s['router_failovers']}")
                harvest()
                with _env({DS.FALLBACK_ENV: "1"}):
                    fallback = gen(prompts[0], "(c) fallback")
                arm(None)
                paged_runs = PA.paged_decode_attention.runs.read()
                harvest()
            check(fallback == T[0], "(c): the fallback's tokens differ "
                  "from T")
            check(not on_card or paged_runs > 0,
                  "(c): the fallback ran no paged decode kernel")
            mark("c")
            stats["failover"] = {"failovers": s["router_failovers"],
                                 "retry_after": int(retry),
                                 "fallback_paged_runs": paged_runs,
                                 "s": time.monotonic() - t0}
            say("router", f"(c) crashes opened replica 0; failover 200 = "
                f"T, /readyz 200; the half-open probe readmitted it (= T); "
                f"every replica open: 503 Retry-After {retry}, /readyz "
                f"503, {s['router_failovers']} failovers (= /metrics); "
                f"PENROZ_SCHED_FALLBACK=1 = T through the paged kernel "
                f"({paged_runs} device runs); "
                f"{stats['failover']['s']:.1f} s")

        # -- (d) disaggregated prefill ----------------------------------------
        env_d = dict(env_a, PENROZ_SCHED_REPLICAS=str(ROUTER_REPLICAS),
                     PENROZ_DISAGG_PREFILL="1",
                     PENROZ_DISAGG_PREFILL_REPLICAS="1",
                     PENROZ_ROUTER_AFFINITY="0")
        disagg = {}
        refs = {"fp32": T}
        refs_rate = {"fp32": stats["one_engine"]["tokens_per_s"]}
        for pages in ("fp32", "int8"):
            quant = {"TURBO_QUANT_KV_CACHE": "1" if pages == "int8" else "0"}
            if pages == "int8":
                with _env(dict(env_a, **quant)):
                    DS.reset()
                    DS.get_engine(model_id, block, 0, None,
                                  device=server.device)
                    refs["int8"], wall, _, _, _ = wave("one engine int8")
                refs_rate["int8"] = rate(wall)
                disagg["int8_one_engine_tokens_per_s"] = rate(wall)
            with _env(dict(env_d, **quant)):
                DS.reset()
                serve_metrics.reset()
                router = group()
                check([e.role for e in router.replicas]
                      == ["prefill"] + ["decode"] * (ROUTER_REPLICAS - 1),
                      f"(d): roles {[e.role for e in router.replicas]}")
                for transport in ("d2d", "host"):
                    tag = f"{pages}/{transport}"
                    before = [(e.stats()["disagg_exports"],
                               e.stats()["disagg_imports"],
                               e.stats()["disagg_handoff_failures"])
                              for e in router.replicas]
                    with _env({DS.DISAGG_TRANSPORT_ENV: transport}):
                        out, wall, steps, _, mem = wave(
                            f"disagg {tag}", poll_memory=True)
                    for i, (got, want) in enumerate(zip(out, refs[pages])):
                        check(got == want, f"(d) {tag}: stream {i} differs "
                              f"from the one-engine {pages} wave")
                    after = [(e.stats()["disagg_exports"],
                              e.stats()["disagg_imports"],
                              e.stats()["disagg_handoff_failures"])
                             for e in router.replicas]
                    exports, imports, failures = (
                        sum(a[k] - b[k] for a, b in zip(after, before))
                        for k in range(3))
                    check(exports == imports == len(prompts)
                          and failures == 0,
                          f"(d) {tag}: {exports} exports, {imports} imports, "
                          f"{failures} failures")
                    check(router.replicas[0].stats()["completed"] == 0,
                          f"(d) {tag}: the prefill replica decoded")
                    transit_seen = 0
                    for snap in mem:
                        for entry in snap["engines"]:
                            pools = entry["pool_pages"]
                            check(sum(pools.values())
                                  == entry["pool_pages_total"]
                                  and min(pools.values()) >= 0,
                                  f"(d) {tag}: a /memory/ read does not "
                                  f"partition replica {entry['replica']}'s "
                                  f"pool: {pools}")
                            transit_seen = max(transit_seen,
                                               pools["transit"])
                    audit(router, f"router (d) {tag}")
                    disagg[tag] = {"tokens_per_s": rate(wall),
                                   "wall_s": wall, "mixed_steps": steps,
                                   "memory_reads": len(mem),
                                   "max_transit_pages": transit_seen}
                    say("router", f"(d) disaggregated, {tag}: = T, "
                        f"{exports} exports = imports, no failure, "
                        f"{len(mem)} /memory/ reads partition every pool "
                        f"(transit up to {transit_seen} pages), no blob or "
                        f"parked page; {rate(wall):.1f} tokens/s = "
                        f"{rate(wall) / refs_rate[pages]:.2f} x one "
                        f"engine, {rate(wall) / stats['replicas']['tokens_per_s']:.2f}"
                        f" x (b) ({steps} mixed steps, /memory/ polled "
                        f"every 100 ms)")
                s = sstats()
                snap = serve_metrics.DISAGG_HANDOFF_BYTES.hist.snapshot()
                nbytes = snap["sum"] / max(1, snap["count"])
                disagg[f"{pages}_handoff_ms_p50"] = s["disagg_handoff_ms_p50"]
                disagg[f"{pages}_handoff_ms_p99"] = s["disagg_handoff_ms_p99"]
                disagg[f"{pages}_handoff_bytes_mean"] = nbytes
                mark(f"d_{pages}")
                say("router", f"(d) {pages}: hand-off p50 "
                    f"{s['disagg_handoff_ms_p50']} ms, p99 "
                    f"{s['disagg_handoff_ms_p99']} ms (both transports), "
                    f"{nbytes:.0f} bytes a hand-off")
                if pages == "fp32":
                    for spec, what in (("disagg.d2d:raise@1", "d2d"),
                                       ("disagg.handoff:raise@1",
                                        "handoff")):
                        before = sstats()
                        arm(spec)
                        got = gen(prompts[1], f"(d) {what} fault")
                        arm(None)
                        after = sstats()
                        check(got == T[1], f"(d) a {what} fault: tokens "
                              f"differ from T")
                        moved = {k: after[k] - before[k] for k in (
                            "disagg_exports", "disagg_imports",
                            "disagg_handoff_failures")}
                        want = {"disagg_exports": 1 if what == "d2d" else 0,
                                "disagg_imports": 1 if what == "d2d" else 0,
                                "disagg_handoff_failures": 1}
                        check(moved == want, f"(d) a {what} fault moved "
                              f"{moved}, expected {want}")
                        audit(router, f"router (d) {what} fault")
                    mark("d_faults")
                    say("router", "(d) a disagg.d2d fault re-sent through "
                        "the host blob (= T, 1 import); a disagg.handoff "
                        "fault re-prefilled monolithically on a decode "
                        "replica (= T, no import); audits clean")
        stats["disagg"] = disagg

        # -- (e) one elastic flip ---------------------------------------------
        # shrink on any backlog, never grow: exactly one flip, down to
        # the one-prefill floor
        env_e = dict(env_d, PENROZ_DISAGG_PREFILL_REPLICAS="2",
                     PENROZ_DISAGG_ELASTIC="1",
                     PENROZ_DISAGG_REBALANCE_DOWN="1e12",
                     PENROZ_DISAGG_REBALANCE_UP="1e13",
                     PENROZ_DISAGG_REBALANCE_COOLDOWN_MS="0")
        with _env(env_e):
            DS.reset()
            serve_metrics.reset()
            router = group()
            check([e.role for e in router.replicas]
                  == ["prefill", "prefill", "decode"],
                  f"(e): roles {[e.role for e in router.replicas]}")
            check(gen(prompts[0], "(e) first") == T[0],
                  "(e): the first request differs from T")
            deadline = time.monotonic() + 60
            while (sorted(e.role for e in router.replicas)
                   != ["decode", "decode", "prefill"]):
                check(time.monotonic() < deadline,
                      f"(e): no flip: {[e.role for e in router.replicas]}")
                time.sleep(0.005)
            # one stream of each family after the flip
            for i in range(ROUTER_FAMILIES):
                check(gen(prompts[i], "(e)") == T[i],
                      f"(e): stream {i} after the flip differs from T")
            s = sstats()
            check(s["disagg_role_changes"] == 1
                  and router.role_changes_requested == 1
                  and exposition("penroz_disagg_role_changes_total") == 1,
                  f"(e): {s['disagg_role_changes']} role changes")
            audit(router, "router (e)")
            stats["elastic"] = {"roles": [e.role for e in router.replicas]}
            mark("e")
            say("router", f"(e) elastic: one prefill -> decode flip "
                f"(roles {stats['elastic']['roles']}), a stream of each "
                f"family after it = T, audits clean")
        router = engine = None
        DS.reset()
    finally:
        arm(None)
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    for name, n in totals.items():
        check(not on_card or n > 0, f"{name} ran no time in the phase")
    stats["seconds"] = time.monotonic() - t_phase
    say("router", f"{stats['seconds']:.1f} s (at the end of each part: "
        f"{stats['marks']}); device runs {totals} on {card}")
    return stats, totals


# ---------------------------------------------------------------------------
# 4k: session hibernation, the journal's restart recovery, resumable streams
# ---------------------------------------------------------------------------

SESS_ENV = dict(CB_ENV, PENROZ_PREFIX_CACHE="1",
                PENROZ_PREFIX_CACHE_PAGES="64", PENROZ_MEMLEDGER_STRICT="1",
                TURBO_QUANT_KV_CACHE="0",
                PENROZ_TIER_HOST_MB=str(96 * SERVE_DEPTH // 12),
                PENROZ_TIER_DISK_MB="1024", PENROZ_STREAM_DETACH_MS="2000")
SESS_PAGE = 128
# Turn 1: 8 chat sessions, each its own prompt; with 64 new tokens each
# history holds 3-5 full pages (28-47 MB of fp32 KV at GPT-2 124M's 12
# blocks, a third of it at SERVE_DEPTH 4), so the host tier (96 MB at 12
# blocks, scaled with the depth) keeps two or three and the rest spill to
# disk.
SESS_PROMPT_LENS = (384, 600, 450, 520, 400, 580, 480, 560)
SESS_NEW = 64
SESS_USER = 32           # the user tokens a second turn adds
SESS_INT8 = 4            # sessions of the int8 repeat
SESS_STREAM_K = 8        # tokens a streaming client reads before it drops


def _drop_stream(base, body, rid):
    """A streamed /generate/ whose client reads SESS_STREAM_K token lines
    and then resets the connection (SO_LINGER 0): the server's next
    writes fail.  Returns the tokens read."""
    import socket
    host, port = base.split("//")[1].split(":")
    sock = socket.create_connection((host, int(port)), timeout=900)
    data = json.dumps(dict(body, stream=True)).encode()
    sock.sendall(b"POST /generate/ HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"X-Request-Id: {rid}\r\nContent-Length: {len(data)}"
                   f"\r\n\r\n".encode() + data)
    f = sock.makefile("rb")
    status = f.readline().split()
    check(len(status) > 1 and status[1] == b"200",
          f"stream {rid}: status line {status}")
    while f.readline() not in (b"\r\n", b""):
        pass
    got = [int(f.readline()) for _ in range(SESS_STREAM_K)]
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    f.close()
    sock.close()
    return got


def _copy_alternatives(torch, nbytes, reps=5):
    """What a demotion's device-to-host copy of ``nbytes`` costs the
    worker: the synchronous pageable ``.cpu()`` that ``export_pages`` runs,
    against a pinned buffer's non-blocking copy (the host's enqueue time,
    and the time until an event after it completes).  Medians, ms."""
    x = torch.empty(nbytes // 4, device="cuda")
    pinned = torch.empty(nbytes // 4, pin_memory=True)
    out = {"bytes": nbytes, "pageable": [], "pinned_enqueue": [],
           "pinned_done": []}
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        x.cpu()
        out["pageable"].append((time.monotonic() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        pinned.copy_(x, non_blocking=True)
        out["pinned_enqueue"].append((time.monotonic() - t0) * 1e3)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        out["pinned_done"].append((time.monotonic() - t0) * 1e3)
    for key in ("pageable", "pinned_enqueue", "pinned_done"):
        out[key] = round(sorted(out[key])[reps // 2], 3)
    return out


def phase_sessions(torch, layers, optimizer, block, vocab, card,
                   device="cuda", model_id="smoke_res"):
    """GPT-2 124M fp32 (phase 4g's checkpoint, created when absent), pages
    of 128, 8 rows, the prefix cache on, the strict ledger, a 96 MB host
    tier and a 1024 MB disk tier and the journal under one temporary
    directory, a 2 s detach grace.  (a) The references: turn 1's 8 prompts
    cold (H1), then turn 2's (each H1 history + 32 user tokens) cold from
    an empty cache (T2).  (b) Turn 1 with session ids s0-s7 (= H1), every
    /memory/ read partitioning the pool, until /sessions/ shows none in
    hbm (then hibernating 0); engines reset; one disk blob's byte flipped.
    (c) Turn 2 with the same ids: every stream = T2, host and disk
    promotions ok, the flipped blob counted corrupt and recomputed, each
    woken admission prefilling only the suffix past its session's pages,
    /metrics' tier_* and sessions_* = /serving_stats/.  (d) Every session
    deleted (gone from every tier); turn 1 again; a journaled tier_mb;
    the registry and the engines dropped and a server created anew
    (create_app's recovery): /sessions/ lists every disk session,
    /debug/dump has restart_recovery, the tier_mb survived, a disk wake =
    T2.  (e) A stream dropped after SESS_STREAM_K tokens reattached
    within the grace (contiguous sequence numbers, the tokens = H1), a
    second one left to expire (cancelled, no page or pin left).  (f) The
    int8 repeat of (a)-(c) for SESS_INT8 sessions.  Every wave's ragged
    device runs = the attention layers x the mixed steps.  Prints turn 2's
    TTFT by source tier against the cold reference's, the demotion's
    export ms, bytes a session in both dtypes and the disk tier's write
    and read MB/s.  Returns (stats, the phase's counts: the ragged
    kernel's device runs).  ``device="cpu"`` rehearses it at a toy size
    through the plain versions (no kernel counts)."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve import journal, qos, streams, tierstore
    from penroz_tpu_torch.serve import metrics as serve_metrics
    from penroz_tpu_torch.utils import checkpoint

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(17)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SESS_PROMPT_LENS]
    users = [rng.integers(0, vocab, SESS_USER).tolist() for _ in prompts]
    state_dir = os.path.join(WORK, "sessions")
    shutil.rmtree(state_dir, ignore_errors=True)
    env = dict(SESS_ENV, PENROZ_KV_PAGE_SIZE=str(SESS_PAGE),
               PENROZ_TIER_DISK_PATH=os.path.join(state_dir, "tier"),
               PENROZ_JOURNAL_PATH=os.path.join(state_dir, "journal.wal"))
    totals = {"ragged_paged_attention": 0}
    stats = {"marks": {}}
    timing = {"export_ms": [], "write": [0, 0.0], "read": [0, 0.0],
              "admissions": {}, "fetch_ms": {}, "import_ms": []}

    def mark(part):
        stats["marks"][part] = round(time.monotonic() - t_phase, 1)

    def harvest():
        totals["ragged_paged_attention"] += \
            RPA.ragged_paged_attention.runs.read()
        RPA.ragged_paged_attention.runs.reset()
        RPA.ragged_paged_attention.launches = 0

    def call(path, body=None, method=None):
        status, headers, text = _qos_call(box["base"], path, body, method)
        try:
            return status, json.loads(text) if text else None
        except ValueError:
            return status, text

    def body(p, sid=None):
        out = {"model_id": model_id, "input": [p], "block_size": block,
               "max_new_tokens": SESS_NEW, "temperature": 0}
        if sid is not None:
            out["session_id"] = sid
        return out

    def sessions():
        status, out = call("/sessions/")
        check(status == 200, f"/sessions/ -> {status}")
        return out

    def exposition():
        text = _qos_call(box["base"], "/metrics")[2]
        out = {}
        for line in text.splitlines():
            if line.startswith(("penroz_tier", "penroz_session")):
                name, value = line.rsplit(" ", 1)
                out[name] = float(value)
        return out

    def wave(tag, bodies, rids=None, poll_memory=False):
        """Stream every body at once (one connection each, opened one
        after another, each read on a thread of its own): (sequences,
        TTFT s each from the wave's start, /memory/ reads).  The ragged
        kernel's device runs = layers x mixed steps."""
        harvest()
        mem_reads, stop = [], threading.Event()

        def poll():
            while not stop.is_set():
                status, out = call("/memory/")
                if status == 200:
                    mem_reads.append(out)
                time.sleep(0.05)

        poller = threading.Thread(target=poll, daemon=True)
        with _mixed_steps() as steps:
            if poll_memory:
                poller.start()
            t0 = time.monotonic()
            resps = []
            for i, b in enumerate(bodies):
                req = urllib.request.Request(
                    box["base"] + "/generate/",
                    data=json.dumps(dict(b, stream=True)).encode(),
                    method="POST", headers={
                        "Content-Type": "application/json",
                        "X-Request-Id": (rids[i] if rids
                                         else f"{tag}-{i}")})
                resps.append(urllib.request.urlopen(req, timeout=900))
            def read(b, resp):
                with resp:
                    toks, first = [], None
                    for line in resp:
                        if first is None:
                            first = time.monotonic() - t0
                        toks.append(int(line))
                    return resp.status, b["input"][0] + toks, first

            with concurrent.futures.ThreadPoolExecutor(len(resps)) as pool:
                done = list(pool.map(read, bodies, resps))
            for status, _, _ in done:
                check(status == 200, f"{tag}: status {status}")
            outs = [seq for _, seq, _ in done]
            ttft = [first for _, _, first in done]
            if on_card:
                torch.cuda.synchronize()
            stop.set()
            if poll_memory:
                poller.join(30)
        runs = RPA.ragged_paged_attention.runs.read()
        harvest()
        check(not on_card or runs == n_attn * steps["steps"] > 0,
              f"{tag}: the ragged kernel ran {runs} times for "
              f"{steps['steps']} mixed steps x {n_attn} layers")
        for i, seq in enumerate(outs):
            check(len(seq) == len(bodies[i]["input"][0]) + SESS_NEW,
                  f"{tag}: stream {i} came back short")
        for snap in mem_reads:
            for entry in snap["engines"]:
                pools = entry["pool_pages"]
                check(sum(pools.values()) == entry["pool_pages_total"]
                      and min(pools.values()) >= 0,
                      f"{tag}: a /memory/ read does not partition the "
                      f"pool: {pools}")
        return outs, ttft, mem_reads

    def settled(n):
        """Wait until ``n`` sessions are resident and none is in hbm (every
        demotion ran); the ledger then holds no hibernating page."""
        deadline = time.monotonic() + 120
        while True:
            s = sessions()
            if s["sessions_resident"] == n and s["sessions_by_tier"][
                    "hbm"] == 0:
                break
            check(time.monotonic() < deadline, f"demotions never settled: "
                  f"{s['sessions_by_tier']}")
            time.sleep(0.02)
        status, mem = call("/memory/")
        check(status == 200 and mem["pool_pages"]["hibernating"] == 0,
              f"hibernating pages after the demotions: {mem['pool_pages']}")
        return {r["session_id"]: r for r in s["sessions"]}

    def fresh_engines():
        DS.reset()
        DS.get_engine(model_id, block, 0, None, device=box["server"].device)

    # instrumentation of the phase's own figures (in process, undone at
    # the end): the demotion's export (the worker's stall), the disk
    # tier's writes and reads, each admission's cached tokens
    real_export = KV.PagedKVState.export_pages
    real_save, real_load = checkpoint.save_tier_blob, \
        checkpoint.load_tier_blob
    real_begin = DS.DecodeEngine._begin_prefill
    real_publish = streams.StreamSession.publish
    real_fetch = tierstore.TierStore.fetch
    real_import = KV.PagedKVState.import_pages

    def timed_export(self, pages, length, device=False):
        t0 = time.monotonic()
        out = real_export(self, pages, length, device=device)
        timing["export_ms"].append((time.monotonic() - t0) * 1e3)
        return out

    def timed_io(real, key):
        def run(sid, *args):
            t0 = time.monotonic()
            out = real(sid, *args)
            timing[key][0] += checkpoint.tier_blob_nbytes(sid)
            timing[key][1] += time.monotonic() - t0
            return out
        return run

    def timed_fetch(self, sid):
        rec = self.get(sid)
        t0 = time.monotonic()
        out = real_fetch(self, sid)
        if out is not None:
            timing["fetch_ms"].setdefault(rec.tier, []).append(
                (time.monotonic() - t0) * 1e3)
        return out

    def timed_import(self, pages, blob, blob_offset=0):
        t0 = time.monotonic()
        out = real_import(self, pages, blob, blob_offset=blob_offset)
        if on_card:
            torch.cuda.synchronize()
        timing["import_ms"].append((time.monotonic() - t0) * 1e3)
        return out

    def recorded_begin(self, row, req, slot=None):
        real_begin(self, row, req, slot)
        state = self._rows[row]
        if state is not None and req.request_id is not None:
            timing["admissions"][req.request_id] = state.prefilled

    # a stream's publishing from SESS_STREAM_K on waits for the test's
    # client (in process, the engine's pace gated on the stream's state)
    gates, closed = {}, set()

    def gated_publish(self, kind, value):
        until = gates.get(self.request_id)
        if until is not None and self._next_seq >= SESS_STREAM_K:
            deadline = time.monotonic() + 60
            while not until(self):
                check(time.monotonic() < deadline,
                      f"stream {self.request_id}: its gate never opened")
                time.sleep(0.002)
        real_publish(self, kind, value)

    KV.PagedKVState.export_pages = timed_export
    checkpoint.save_tier_blob = timed_io(real_save, "write")
    checkpoint.load_tier_blob = timed_io(real_load, "read")
    DS.DecodeEngine._begin_prefill = recorded_begin
    streams.StreamSession.publish = gated_publish
    tierstore.TierStore.fetch = timed_fetch
    KV.PagedKVState.import_pages = timed_import
    box = {}

    def serve():
        box["server"] = app_mod.create_app(device=device)
        box["thread"] = threading.Thread(
            target=box["server"].serve_forever, daemon=True)
        box["thread"].start()
        box["base"] = "http://%s:%d" % box["server"].server_address[:2]

    def stop_server():
        box["server"].shutdown()
        box["server"].server_close()
        box["thread"].join(timeout=30)
        check(not box["thread"].is_alive(), "server thread did not stop")

    try:
        with _env(env):
            tierstore.reset()
            journal.reset()
            streams.reset()
            qos.reset()
            serve()
            DS.reset()
            harvest()
            totals["ragged_paged_attention"] = 0
            if call(f"/progress/?model_id={model_id}")[0] != 200:
                status, out = call("/model/", {"model_id": model_id,
                                               "layers": layers,
                                               "optimizer": optimizer})
                check(status == 200, f"POST /model/ -> {status}: {out}")
            results = {}
            for dtype, n in (("fp32", len(prompts)), ("int8", SESS_INT8)):
                os.environ["TURBO_QUANT_KV_CACHE"] = \
                    "1" if dtype == "int8" else "0"
                ids = [f"{dtype}-s{i}" for i in range(n)]
                # -- (a) the references: turn 1 and turn 2 cold --------------
                fresh_engines()
                H1, ttft1, _ = wave(f"{dtype} cold turn 1",
                                    [body(p) for p in prompts[:n]])
                P2 = [h + u for h, u in zip(H1, users)]
                fresh_engines()
                T2, ttft_cold, _ = wave(f"{dtype} cold turn 2",
                                        [body(p) for p in P2])
                mark(f"{dtype}_references")
                # -- (b) turn 1 with sessions --------------------------------
                fresh_engines()
                got, _, mem = wave(f"{dtype} turn 1",
                                   [body(p, sid) for p, sid in
                                    zip(prompts[:n], ids)],
                                   poll_memory=True)
                check(got == H1, f"{dtype}: turn 1 with sessions differs "
                      f"from turn 1 without")
                listing = settled(n)
                kv_len = {sid: (len(h) - 1) // SESS_PAGE * SESS_PAGE
                          for sid, h in zip(ids, H1)}
                for sid in ids:
                    check(listing[sid]["tokens"] == kv_len[sid],
                          f"{sid}: {listing[sid]['tokens']} tokens "
                          f"hibernated, expected {kv_len[sid]}")
                tiers = {sid: listing[sid]["tier"] for sid in ids}
                nbytes = [listing[sid]["nbytes"] for sid in ids
                          if tiers[sid] == "host"]
                disk = [sid for sid in ids if tiers[sid] == "disk"]
                corrupt = None
                if dtype == "fp32":
                    check(len(disk) >= 2 and "host" in tiers.values(),
                          f"fp32 tiers after turn 1: {tiers}")
                    corrupt = disk[-1]
                    path = checkpoint.tier_blob_path(corrupt)
                    raw = bytearray(open(path, "rb").read())
                    raw[len(raw) // 2] ^= 0xFF
                    with open(path, "wb") as f:
                        f.write(raw)
                mark(f"{dtype}_turn1")
                # -- (c) turn 2 wakes every session --------------------------
                fresh_engines()
                serve_metrics.reset()
                before = call("/serving_stats/")[1]
                promos = dict(tierstore.TIERS.promotions)
                timing["admissions"].clear()
                rids = [f"{dtype}-turn2-{i}" for i in range(n)]
                got, ttft2, _ = wave(f"{dtype} turn 2",
                                     [body(p, sid) for p, sid in
                                      zip(P2, ids)], rids=rids,
                                     poll_memory=True)
                for i, (g, w) in enumerate(zip(got, T2)):
                    check(g == w, f"{dtype} turn 2: stream {i} ({tiers[ids[i]]}"
                          f" tier) differs from T2")
                for rid, sid in zip(rids, ids):
                    want = 0 if sid == corrupt else kv_len[sid]
                    check(timing["admissions"].get(rid) == want,
                          f"{sid}: turn 2 aliased "
                          f"{timing['admissions'].get(rid)} tokens, expected "
                          f"{want} (prefill only past the session's pages)")
                moved = {k: v - promos.get(k, 0)
                         for k, v in tierstore.TIERS.promotions.items()
                         if v != promos.get(k, 0)}
                want = {(tiers[sid], "ok") for sid in ids if sid != corrupt}
                check(set(k for k in moved if k[1] == "ok") == want,
                      f"{dtype} turn 2 promotions {moved}, expected ok from "
                      f"{want}")
                if dtype == "fp32":
                    check(moved.get(("disk", "corrupt")) == 1
                          and {"host", "disk"} <= {t for t, _ in want},
                          f"fp32 turn 2 promotions {moved}")
                listing2 = settled(n)
                after = call("/serving_stats/")[1]
                metr = exposition()
                check(metr.get("penroz_tier_corrupt_blobs_total", 0)
                      == after["tier_corrupt_blobs"]
                      - before["tier_corrupt_blobs"]
                      == (1 if dtype == "fp32" else 0),
                      f"{dtype}: corrupt blobs {metr} / {after}")
                for outcome, n_after in after["tier_promotions"].items():
                    n_metric = sum(v for k, v in metr.items() if k.startswith(
                        "penroz_tier_promotions_total{") and
                        f'outcome="{outcome}"' in k)
                    check(n_metric == n_after
                          - before["tier_promotions"][outcome],
                          f"{dtype}: {outcome} promotions /metrics "
                          f"{n_metric} != /serving_stats/")
                for t, n_after in after["tier_demotions"].items():
                    check(metr.get(f'penroz_tier_demotions_total{{tier="{t}"}}',
                                   0) == n_after
                          - before["tier_demotions"][t],
                          f"{dtype}: {t} demotions /metrics != "
                          f"/serving_stats/")
                check(metr["penroz_sessions_hibernated_total"]
                      == after["sessions_hibernated"] == n
                      and metr["penroz_sessions_resident"]
                      == after["sessions_resident"],
                      f"{dtype}: sessions_* /metrics {metr} != "
                      f"/serving_stats/")
                for t in ("hbm", "host", "disk"):
                    pages = sum(r["pages"] for r in listing2.values()
                                if r["tier"] == t)
                    check(metr[f'penroz_tier_pages{{tier="{t}"}}'] == pages,
                          f"{dtype}: tier_pages {t} != /sessions/")
                results[dtype] = {
                    "ttft_cold_s": ttft_cold, "ttft_turn2_s": ttft2,
                    "tiers": [tiers[sid] for sid in ids],
                    "corrupt": corrupt, "promotions": {
                        f"{t}/{o}": v for (t, o), v in moved.items()},
                    "bytes_a_session": [listing[sid]["nbytes"]
                                        for sid in ids],
                    "host_bytes_a_session": nbytes}
                mark(f"{dtype}_turn2")
                say("sessions", f"{dtype}: turn 1 = H1 with {n} sessions "
                    f"(tiers {results[dtype]['tiers']}); turn 2 = T2 for "
                    f"every stream, promotions {results[dtype]['promotions']}"
                    f", each woken admission prefilled only its suffix; "
                    f"/metrics = /serving_stats/; on {card}")
                for sid in ids:
                    status, out = call(f"/sessions/{sid}", method="DELETE")
                    check(status == 200 and out["deleted"] is True,
                          f"DELETE {sid} -> {status} {out}")
                    check(not os.path.exists(checkpoint.tier_blob_path(sid)),
                          f"DELETE {sid} left its disk blob")
                status, out = call(f"/sessions/{ids[0]}", method="DELETE")
                check(out == {"session_id": ids[0], "deleted": False},
                      f"a second DELETE -> {out}")
                check(sessions()["sessions_resident"] == 0,
                      f"{dtype}: sessions left after DELETE")
                if dtype == "int8":
                    break
                # -- (d) the restart ------------------------------------------
                fresh_engines()
                got, _, _ = wave("fp32 turn 1 again",
                                 [body(p, sid) for p, sid in
                                  zip(prompts, ids)])
                check(got == H1, "fp32 turn 1 again differs from H1")
                listing = settled(len(ids))
                disk = sorted(sid for sid in ids
                              if listing[sid]["tier"] == "disk")
                status, _ = call("/tenants/acme/quota",
                                 {"tokens_per_s": None, "tier_mb": 512},
                                 method="PUT")
                check(status == 200, f"PUT tier_mb -> {status}")
                DS.reset()
                stop_server()
                with tierstore.TIERS._lock:       # what a kill -9 leaves
                    tierstore.TIERS._sessions.clear()
                    tierstore.TIERS._host.clear()
                    tierstore.TIERS._index.clear()
                journal.JOURNAL.close()
                journal.reset()
                qos.reset()
                t0 = time.monotonic()
                serve()                           # create_app recovers
                recover_s = time.monotonic() - t0
                listing = {r["session_id"]: r["tier"]
                           for r in sessions()["sessions"]}
                check(listing == {sid: "disk" for sid in disk},
                      f"after the restart /sessions/ lists {listing}, "
                      f"expected the disk sessions {disk}")
                dump = call("/debug/dump")[1]["restart_recovery"]
                check(dump.get("sessions_recovered") == len(disk)
                      and dump.get("sessions_volatile")
                      == len(ids) - len(disk),
                      f"restart_recovery {dump}")
                quota = call("/tenants/")[1]["tenants"]["tier_overrides"]
                check(quota == {"acme": 512.0},
                      f"the journaled tier_mb did not survive: {quota}")
                i = ids.index(disk[0])
                got, _, _ = wave("fp32 disk wake after the restart",
                                 [body(P2[i])])
                check(got == [T2[i]], "the disk wake after the restart "
                      "differs from T2")
                check(tierstore.TIERS.promotions.get(("disk", "ok"), 0) >= 1,
                      "the wake after the restart was no disk promotion")
                stats["restart"] = dict(dump, recover_s=recover_s)
                mark("restart")
                say("sessions", f"restart: {len(disk)} disk sessions "
                    f"recovered from the journal ({dump['records_replayed']}"
                    f" records, {dump['replay_ms']} ms), "
                    f"{dump['sessions_volatile']} host ones dropped; "
                    f"restart_recovery in /debug/dump, tier_mb kept, a disk "
                    f"wake = T2")
                # -- (e) resumable streams -------------------------------------
                # the client drops; a few events later the server's write
                # fails and detaches the stream, before its end
                rid = "sess-reattach"
                gates[rid] = lambda s: s.request_id in closed and (
                    s._next_seq < SESS_STREAM_K + 4
                    or s.snapshot()["detached"])
                first = _drop_stream(box["base"], body(prompts[1]), rid)
                closed.add(rid)
                deadline = time.monotonic() + 60
                while not (streams.STREAMS.get(rid)
                           and streams.STREAMS.get(rid).snapshot()["terminal"]):
                    check(time.monotonic() < deadline,
                          "the detached stream did not decode to its end")
                    time.sleep(0.01)
                status, _, text = _qos_call(
                    box["base"],
                    f"/generate/{rid}/stream?from_seq={SESS_STREAM_K}")
                check(status == 200, f"reattach -> {status}: {text}")
                lines = [ln.split(":", 1) for ln in text.split()]
                check([int(s) for s, _ in lines]
                      == list(range(SESS_STREAM_K, SESS_NEW + 1))
                      and lines[-1][1] == "done",
                      f"reattach sequence numbers {[s for s, _ in lines]}")
                check(first + [int(v) for _, v in lines[:-1]]
                      == H1[1][len(prompts[1]):],
                      "the reattached stream differs from the reference")
                rid = "sess-expire"
                gates[rid] = lambda s: s.request_id in closed and (
                    s._next_seq < SESS_STREAM_K + 4 or s.expired)
                _drop_stream(box["base"], body(prompts[2]), rid)
                closed.add(rid)
                deadline = time.monotonic() + 60
                while streams.STREAMS.stats()["expired"] < 1 or any(
                        e.active_rows for e in DS._live_engines()):
                    check(time.monotonic() < deadline,
                          "the expired stream's row was not cancelled")
                    time.sleep(0.01)
                for e in DS._live_engines():
                    check(e._ledger.audit("sessions (e)") == [],
                          "the expired row left the audit unbalanced")
                    pools = e.memory_snapshot()["pool_pages"]
                    check(pools["row"] == pools["prefix_pinned"]
                          == pools["hibernating"] == 0,
                          f"the expired row left pages: {pools}")
                st = streams.STREAMS.stats()
                check((st["detaches"], st["resumes"], st["expired"])
                      == (2, 1, 1), f"stream counters {st}")
                stats["streams"] = st
                mark("streams")
                say("sessions", f"a stream dropped after {SESS_STREAM_K} "
                    f"tokens reattached at from_seq={SESS_STREAM_K} within "
                    f"the 2 s grace (sequence numbers contiguous, tokens = "
                    f"H1); a second left to expire was cancelled, no page "
                    f"or pin left")
                for sid in disk:
                    call(f"/sessions/{sid}", method="DELETE")
            stats["waves"] = results
        DS.reset()
    finally:
        KV.PagedKVState.export_pages = real_export
        checkpoint.save_tier_blob, checkpoint.load_tier_blob = \
            real_save, real_load
        DS.DecodeEngine._begin_prefill = real_begin
        streams.StreamSession.publish = real_publish
        tierstore.TierStore.fetch = real_fetch
        KV.PagedKVState.import_pages = real_import
        if "thread" in box and box["thread"].is_alive():
            stop_server()
        tierstore.reset()
        journal.reset()
        streams.reset()
        qos.reset()
        shutil.rmtree(state_dir, ignore_errors=True)
        checkpoint.join_flushes()
    check(not on_card or totals["ragged_paged_attention"] > 0,
          "the ragged kernel ran no time in the phase")

    def ms(values, q):
        return round(_pct(values, q) * 1e3, 3) if values else None

    for dtype, r in stats["waves"].items():
        by_tier = {}
        for t, v in zip(r["tiers"], r["ttft_turn2_s"]):
            by_tier.setdefault(t, []).append(v)
        r["ttft_ms"] = {"cold": (ms(r["ttft_cold_s"], 0.5),
                                 ms(r["ttft_cold_s"], 1.0))}
        r["ttft_ms"].update({t: (ms(v, 0.5), ms(v, 1.0))
                             for t, v in by_tier.items()})
        say("sessions", f"{dtype} turn-2 TTFT p50/max ms by source tier "
            f"{r['ttft_ms']} (cold = the reference wave; a corrupt blob's "
            f"session is in its tier's group); bytes a session "
            f"{r['bytes_a_session']} (host: payload, disk: file); on {card}")
    exp = [v / 1e3 for v in timing["export_ms"]]
    stats["demotion_export_ms"] = (ms(exp, 0.5), ms(exp, 0.99), len(exp))
    stats["wake_fetch_ms"] = {t: (ms([v / 1e3 for v in vs], 0.5),
                                  ms([v / 1e3 for v in vs], 1.0), len(vs))
                              for t, vs in timing["fetch_ms"].items()}
    imp = [v / 1e3 for v in timing["import_ms"]]
    stats["wake_import_ms"] = (ms(imp, 0.5), ms(imp, 1.0), len(imp))
    if on_card:
        stats["demotion_copy_ms"] = _copy_alternatives(
            torch, max(max(r["bytes_a_session"])
                       for r in stats["waves"].values()))
        say("sessions", f"a session's largest export ({stats['demotion_copy_ms']['bytes']}"
            f" bytes) to the host, ms (median of 5): synchronous pageable "
            f"{stats['demotion_copy_ms']['pageable']}, pinned non-blocking "
            f"enqueue {stats['demotion_copy_ms']['pinned_enqueue']} and "
            f"done {stats['demotion_copy_ms']['pinned_done']}; on {card}")
    say("sessions", f"wake: blob fetch ms p50/max by tier "
        f"{stats['wake_fetch_ms']} (disk: read + CRC), import ms p50/max "
        f"{stats['wake_import_ms']} (copied to the card, synchronized), "
        f"all in the worker's admission before the first mixed step")
    stats["disk_write_mb_s"] = (timing["write"][0] / timing["write"][1] / 1e6
                                if timing["write"][1] else None)
    stats["disk_read_mb_s"] = (timing["read"][0] / timing["read"][1] / 1e6
                               if timing["read"][1] else None)
    stats["seconds"] = time.monotonic() - t_phase
    say("sessions", f"demotion export ms p50 {stats['demotion_export_ms'][0]}"
        f" p99 {stats['demotion_export_ms'][1]} ({len(exp)} demotions, a "
        f"synchronous copy to the host on the worker); disk tier write "
        f"{stats['disk_write_mb_s']} MB/s, read {stats['disk_read_mb_s']} "
        f"MB/s (warm page cache); {stats['seconds']:.1f} s (at the end of "
        f"each part: {stats['marks']}); device runs {totals} on {card}")
    return stats, totals


# ---------------------------------------------------------------------------
# 4l: the engine's other tick forms (phased, pipelined) and legacy batches
# ---------------------------------------------------------------------------

TICKS_ENV = dict(CB_ENV, PENROZ_KV_PAGE_SIZE="128", PENROZ_PREFIX_CACHE="0",
                 PENROZ_MEMLEDGER_STRICT="1", TURBO_QUANT_KV_CACHE="0",
                 PENROZ_SPEC_DECODE="0", PENROZ_SCHED_SUPERSTEP="8",
                 PENROZ_PREFILL_CHUNK="256", PENROZ_RAGGED_ATTENTION="1",
                 PENROZ_SERVE_PIPE_STAGES="1")
# phase 4b's wave: 8 greedy requests of these prompt lengths, 64 new each
TICKS_LENS = CB_PROMPT_LENS
TICKS_NEW = CB_NEW_TOKENS
TICKS_STAGES = (2, 4)
TICKS_SMALL_CHUNK = 128      # against PENROZ_PREFILL_CHUNK's default 256
# the legacy /generate_batch/: 4 of the wave's prompts (16-700 tokens)
TICKS_LEGACY_ROWS = (0, 3, 6, 7)


def phase_ticks(torch, layers, optimizer, block, vocab, card, device="cuda",
                model_id="smoke_res"):
    """GPT-2 124M fp32 (phase 4g's checkpoint, created when absent), 8
    rows, phase 4b's wave (8 concurrent streamed greedy /generate/,
    prompts of TICKS_LENS tokens, numpy seed 0, 64 new each) through the
    engine's other tick forms, each on a fresh engine:

    (a) the phased ticks over the contiguous cache (continuous batching
        without PAGED_KV_CACHE), fp32 and int8: every stream = that
        prompt's single-sequence tokens on the same cache (T_c, in
        process); superstep 1 and PENROZ_PREFILL_CHUNK=128 give the same
        tokens, superstep 8 in fewer dispatches; the decode kernel's
        device runs = 12 x the engine's forward passes (shared and fused
        steps, chunks, verify spans).
    (b) the phased ticks over the paged pool (PENROZ_RAGGED_ATTENTION=0,
        pages of 128): every stream = the unified engine's (T_u, the same
        wave unified); the paged decode kernel's runs = 12 x forward
        passes, the ragged kernel's none.
    (c) speculation on the phased contiguous ticks (phase 4f's wave: 8
        prompts S x 4 searched so that each row drafts, 128 new;
        PENROZ_SPEC_DECODE=1, K 4, n-gram 3): spec on = spec off, verify
        spans run; an oracle drafter (the spec-off continuation) is fully
        accepted.
    (d) pipeline serving, PENROZ_SERVE_PIPE_STAGES 2 and 4 over the 12
        blocks, fp32 and int8 pages, the prefix cache off (and on at 2
        stages, fp32): every
        stream = the unpiped engine's (T_u, and its int8 repeat); the
        ragged kernel's runs = 12 x the blocks' steps; the bubble
        fraction; /memory/'s stage_pools partition the pool; a pipe.handoff
        fault gives one host fallback and the same tokens; a
        pipe.stage_crash recovers the group and the next request = T_u;
        /metrics' penroz_pipe_* = /serving_stats/.
    (e) the legacy /generate_batch/ (continuous batching off) of 4 of the
        prompts, contiguous and paged: each row = its single-sequence
        tokens, the decode kernels' runs = 12 x (prefill + steps); with the
        breaker open (one crash, PENROZ_ENGINE_MAX_CRASHES=1) and
        PENROZ_SCHED_FALLBACK=1 the batch is answered by the legacy path
        with the same rows.

    Prints each engine's wave rate and the device's busy share over the
    wave's first ROUTER_BUSY_WINDOW_S (phased contiguous, phased paged,
    unified, piped S 2 and 4: torch.profiler's device trace of that
    window, parsed after the wave's clock stops), the bubble fractions and
    a host bounce of a hand-off's activations.  Returns (stats, the phase's
    device runs of the three kernels).  ``device="cpu"`` rehearses it at a
    toy size through the plain versions (no kernel counts)."""
    import numpy as np

    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import paged_attention as PA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.serve import spec_decode
    from penroz_tpu_torch.utils import checkpoint, faults

    t_phase = time.monotonic()
    on_card = device != "cpu"
    with torch.device("meta"):
        n_attn = len(CompiledArch(layers).attn_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in TICKS_LENS]
    spec_new = SPEC_NEW_TOKENS
    kernels = {"decode_attention": DA.decode_attention,
               "paged_decode_attention": PA.paged_decode_attention,
               "ragged_paged_attention": RPA.ragged_paged_attention}
    totals = dict.fromkeys(kernels, 0)
    stats = {"marks": {}, "rates": {}}

    def mark(part):
        stats["marks"][part] = round(time.monotonic() - t_phase, 1)

    def runs():
        """Each kernel's device runs since the last call (then zeroed)."""
        out = {}
        for name, fn in kernels.items():
            out[name] = fn.runs.read()
            totals[name] += out[name]
            fn.runs.reset()
            fn.launches = 0
        return out

    def arm(spec):
        faults.reset()
        if spec:
            os.environ[faults.ENV] = spec
        else:
            os.environ.pop(faults.ENV, None)

    def call(path, body=None, method=None):
        status, _, text = _qos_call(base, path, body, method)
        try:
            return status, json.loads(text) if text else None
        except ValueError:
            return status, text

    def body(p, n=TICKS_NEW):
        return {"model_id": model_id, "input": [p], "block_size": block,
                "max_new_tokens": n, "temperature": 0}

    def wave(tag, ps=prompts, n=TICKS_NEW, kernel=None, profiled=False):
        """The streams on a fresh engine of the current knobs, opened one
        after another and then read: (sequences, the engine's stats, the
        kernels' runs, (busy ms, window ms) or None).  ``kernel``: the
        attention kernel whose device runs must be 12 x the engine's
        forward passes (the others none)."""
        DS.reset()
        engine = DS.get_engine(model_id, block, 0, None,
                               device=server.device)
        check(engine is not None, f"{tag}: no engine")
        runs()
        busy = None
        prof = None
        if profiled and on_card:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.monotonic()
        resps = []
        for p in ps:
            req = urllib.request.Request(
                base + "/generate/",
                data=json.dumps(dict(body(p, n), stream=True)).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            resps.append(urllib.request.urlopen(req, timeout=900))
        window_ms = None
        if prof is not None:
            # the trace's first ROUTER_BUSY_WINDOW_S from the submissions;
            # its events are parsed after the wave's clock stops
            time.sleep(max(0.0, ROUTER_BUSY_WINDOW_S
                           - (time.monotonic() - t0)))
            torch.cuda.synchronize()
            window_ms = (time.monotonic() - t0) * 1e3
            prof.__exit__(None, None, None)
        outs = []
        for p, resp in zip(ps, resps):
            with resp:
                check(resp.status == 200, f"{tag}: status {resp.status}")
                outs.append(p + [int(line) for line in resp])
        if on_card:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        if prof is not None:
            busy = (sum(_device_kernel_ms(torch, prof).values()),
                    min(window_ms, wall * 1e3))
            check(busy[0] > 0, f"{tag}: the profiler saw no device time")
        counts = runs()
        st = engine.stats()
        passes = engine._forward_passes
        for i, seq in enumerate(outs):
            check(len(seq) == len(ps[i]) + n, f"{tag}: stream {i} came "
                  f"back short")
        if kernel is not None and on_card:
            want = {name: (n_attn * passes if name == kernel else 0)
                    for name in kernels}
            check(counts == want and passes > 0,
                  f"{tag}: device runs {counts} for {passes} forward passes "
                  f"x {n_attn} layers, expected {want}")
        stats["rates"][tag] = {
            "tokens_per_s": len(ps) * n / wall, "wall_s": wall,
            "forward_passes": passes, "dispatches": st["dispatches_total"]}
        if busy:
            stats["rates"][tag].update(busy_ms=busy[0], window_ms=busy[1],
                                       busy_share=busy[0] / busy[1])
        return outs, st, counts, busy

    def same(tag, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                first = next(j for j, (a, b) in enumerate(zip(g, w))
                             if a != b)
                raise SmokeFailure(
                    f"{tag}: stream {i} diverges at token {first} "
                    f"({g[first]} against {w[first]})")

    def singles(ps, n=TICKS_NEW):
        """Each prompt through the single-sequence path (in process, the
        function /generate/ runs), on the cache the knobs select."""
        model = NeuralNetworkModel.deserialize(model_id, device=device,
                                               optimizer=False)
        return [model.generate_tokens([p], block, n, temperature=0)
                for p in ps]

    # the checkpoint is read once for the phase: every engine and legacy
    # batch of it gets that model (serving never writes to its weights)
    real_load = NeuralNetworkModel.deserialize.__func__
    loaded = {}

    def load_once(cls, mid, device=None, **kwargs):
        key = (mid, str(device))
        if key not in loaded:
            loaded[key] = real_load(cls, mid, device=device, **kwargs)
        return loaded[key]

    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    real_spec = spec_decode.propose
    NeuralNetworkModel.deserialize = classmethod(load_once)
    try:
        with _env(TICKS_ENV):
            if call(f"/progress/?model_id={model_id}")[0] != 200:
                status, out = call("/model/", {"model_id": model_id,
                                               "layers": layers,
                                               "optimizer": optimizer})
                check(status == 200, f"POST /model/ -> {status}: {out}")
            # -- (a) phased ticks over the contiguous cache ------------------
            os.environ["PAGED_KV_CACHE"] = "0"
            phased = {}
            for dtype in ("fp32", "int8"):
                os.environ["TURBO_QUANT_KV_CACHE"] = \
                    "1" if dtype == "int8" else "0"
                ref = singles(prompts)
                runs()
                tag = f"phased contiguous {dtype}"
                got, st8, _, _ = wave(tag, kernel="decode_attention",
                                      profiled=dtype == "fp32")
                same(tag, got, ref)
                with _env({"PENROZ_SCHED_SUPERSTEP": "1"}):
                    got1, st1, _, _ = wave(f"{tag}, superstep 1",
                                           kernel="decode_attention")
                same(f"{tag}, superstep 1", got1, ref)
                check(max(t["superstep"] for t in st8["tick_timeline"]) > 1
                      and st8["dispatches_total"] < st1["dispatches_total"],
                      f"{tag}: superstep 8 ran {st8['dispatches_total']} "
                      f"dispatches, superstep 1 {st1['dispatches_total']}")
                small = f"{tag}, chunks of {TICKS_SMALL_CHUNK}"
                with _env({"PENROZ_PREFILL_CHUNK": str(TICKS_SMALL_CHUNK)}):
                    got128, st128, _, _ = wave(small,
                                               kernel="decode_attention")
                same(small, got128, ref)
                check(st128["prefill_chunks"] > st8["prefill_chunks"],
                      f"{small}: no more chunks than at the default")
                check(not any(t["unified"] for t in st8["tick_timeline"]),
                      f"{tag}: a unified tick")
                phased[dtype] = {"dispatches_ss8": st8["dispatches_total"],
                                 "dispatches_ss1": st1["dispatches_total"],
                                 "prefill_chunks": st8["prefill_chunks"],
                                 "prefill_chunks_128":
                                     st128["prefill_chunks"]}
                say("ticks", f"(a) {tag}: 8 streams = the single-sequence "
                    f"tokens at superstep 8 ({st8['dispatches_total']} "
                    f"dispatches), 1 ({st1['dispatches_total']}) and chunks "
                    f"of {TICKS_SMALL_CHUNK}; decode kernel runs = {n_attn} "
                    f"x forward passes")
                if dtype == "fp32":
                    T_c = ref
            stats["phased_contiguous"] = phased
            mark("a")
            # -- (c) speculation on the phased ticks -------------------------
            os.environ["TURBO_QUANT_KV_CACHE"] = "0"
            tag = "phased speculation"
            spec_prompts = _drafting_prompts(base, {
                "model_id": model_id, "block_size": block,
                "temperature": 0}, vocab, {})
            off, _, _, _ = wave(f"{tag} off", spec_prompts, spec_new,
                                kernel="decode_attention")
            with _env({"PENROZ_SPEC_DECODE": "1", "PENROZ_SPEC_K": "4",
                       "PENROZ_SPEC_NGRAM": "3"}):
                on, st_on, _, _ = wave(f"{tag} on", spec_prompts, spec_new,
                                       kernel="decode_attention")
                same(f"{tag} on", on, off)
                check(st_on["spec_verify_steps"] > 0,
                      f"{tag}: no verify span ran")

                def oracle(history, k, ngram):
                    for seq in off:
                        if (len(history) < len(seq)
                                and history == seq[:len(history)]):
                            return seq[len(history):len(history) + k]
                    return []

                spec_decode.propose = oracle
                try:
                    orc, st_orc, _, _ = wave(f"{tag} oracle", spec_prompts,
                                             spec_new,
                                             kernel="decode_attention")
                finally:
                    spec_decode.propose = real_spec
                same(f"{tag} oracle", orc, off)
                check(st_orc["spec_accept_rate"] == 1.0,
                      f"{tag}: the oracle's accept rate is "
                      f"{st_orc['spec_accept_rate']}")
            stats["speculation"] = {
                "verify_steps": st_on["spec_verify_steps"],
                "accept_rate": st_on["spec_accept_rate"],
                "oracle_tokens_per_decode_step":
                    st_orc["tokens_per_decode_step"]}
            say("ticks", f"(c) {tag}: on = off ({st_on['spec_verify_steps']}"
                f" verify spans, accept rate {st_on['spec_accept_rate']}); "
                f"the oracle drafter fully accepted, "
                f"{st_orc['tokens_per_decode_step']} tokens a decode step")
            mark("c")
            # -- (b) phased ticks over the paged pool ------------------------
            os.environ["PAGED_KV_CACHE"] = "1"
            T_u, _, _, _ = wave("unified", kernel="ragged_paged_attention",
                                profiled=True)
            with _env({"PENROZ_RAGGED_ATTENTION": "0"}):
                tag = "phased paged"
                got, st, _, _ = wave(tag, kernel="paged_decode_attention",
                                     profiled=True)
                same(tag, got, T_u)
                check(not any(t["unified"] for t in st["tick_timeline"]),
                      f"{tag}: a unified tick")
            say("ticks", f"(b) phased paged: 8 streams = the unified "
                f"engine's; paged decode kernel runs = {n_attn} x forward "
                f"passes, the ragged kernel's 0")
            mark("b")
            # -- (d) pipeline serving ----------------------------------------
            os.environ["TURBO_QUANT_KV_CACHE"] = "1"
            T_u8, _, _, _ = wave("unified int8",
                                 kernel="ragged_paged_attention")
            pipe = {}
            for S in TICKS_STAGES:
                os.environ["PENROZ_SERVE_PIPE_STAGES"] = str(S)
                for dtype, want in (("fp32", T_u), ("int8", T_u8)):
                    os.environ["TURBO_QUANT_KV_CACHE"] = \
                        "1" if dtype == "int8" else "0"
                    # the prefix cache on only at 2 stages in fp32 (the
                    # matrix cut for the script's time)
                    for prefix in (("0", "1") if (S, dtype) == (
                            TICKS_STAGES[0], "fp32") else ("0",)):
                        os.environ["PENROZ_PREFIX_CACHE"] = prefix
                        tag = (f"piped S {S} {dtype}"
                               f"{', prefix cache' if prefix == '1' else ''}")
                        got, st, _, _ = wave(
                            tag, kernel="ragged_paged_attention",
                            profiled=dtype == "fp32" and prefix == "0")
                        same(tag, got, want)
                        check(st["pipe_stages"] == S and st["pipe_ticks"] > 0
                              and st["pipe_handoffs"] > 0,
                              f"{tag}: the pipeline did not run: {st}")
                        pipe[tag] = {k: st[k] for k in (
                            "pipe_ticks", "pipe_bubble_fraction",
                            "pipe_stage_busy", "pipe_handoffs",
                            "pipe_microblocks")}
                os.environ["PENROZ_PREFIX_CACHE"] = "0"
                os.environ["TURBO_QUANT_KV_CACHE"] = "0"
                tag = f"piped S {S} fp32"
                # /memory/: the stages' pools partition the pool
                status, mem = call("/memory/")
                check(status == 200, f"/memory/ -> {status}")
                entry = mem["engines"][0]
                pools = entry["stage_pools"]
                kv_bytes = (entry["hbm_bytes"]["kv_values"]
                            + entry["hbm_bytes"]["kv_scales"])
                check(len(pools) == S
                      and sum(p["kv_layers"] for p in pools) == n_attn
                      and sum(p["kv_pool_bytes"] for p in pools) == kv_bytes
                      and all(p["pool_pages"] == entry["pool_pages_total"]
                              for p in pools),
                      f"{tag}: stage_pools do not partition the pool: "
                      f"{pools} against {kv_bytes} bytes")
                # /metrics' penroz_pipe_* against /serving_stats/
                text = _qos_call(base, "/metrics")[2]
                exp = {}
                for line in text.splitlines():
                    if line.startswith("penroz_pipe"):
                        name, value = line.rsplit(" ", 1)
                        exp[name] = float(value)
                status, agg = call("/serving_stats/")
                ticks = exp["penroz_pipe_ticks"]
                check(exp["penroz_pipe_stages"] == agg["pipe_stages"] == S
                      and ticks == agg["pipe_ticks"] > 0
                      and round(exp["penroz_pipe_bubble_ticks"]
                                / (ticks * S), 4)
                      == agg["pipe_bubble_fraction"]
                      and exp['penroz_pipe_handoffs{path="device"}']
                      + exp['penroz_pipe_handoffs{path="host"}']
                      == agg["pipe_handoffs"]
                      and exp['penroz_pipe_handoffs{path="host"}']
                      == agg["pipe_handoff_host_fallbacks"],
                      f"{tag}: /metrics {exp} against /serving_stats/ "
                      f"{ {k: agg[k] for k in agg if k.startswith('pipe')} }")
                say("ticks", f"(d) piped S {S}: every stream = the unpiped "
                    f"engine's (fp32 and int8 pages, prefix cache off and "
                    f"on); bubble fraction "
                    f"{pipe[tag]['pipe_bubble_fraction']}, stage busy "
                    f"{pipe[tag]['pipe_stage_busy']}; stage_pools "
                    f"partition the pool; /metrics = /serving_stats/")
            # the faults, at 2 stages
            os.environ["PENROZ_SERVE_PIPE_STAGES"] = "2"
            DS.reset()
            engine = DS.get_engine(model_id, block, 0, None,
                                   device=server.device)
            arm("pipe.handoff:raise@1")
            status, out = call("/generate/", body(prompts[0]))
            arm(None)
            st = engine.stats()
            check(status == 200 and out["tokens"] == T_u[0]
                  and st["pipe_handoff_host_fallbacks"] == 1
                  and st["crashes_total"] == 0,
                  f"pipe.handoff: {status}, host fallbacks "
                  f"{st['pipe_handoff_host_fallbacks']}, crashes "
                  f"{st['crashes_total']}")
            arm("pipe.stage_crash:raise@1")
            status, _ = call("/generate/", body(prompts[0]))
            arm(None)
            check(status == 500, f"pipe.stage_crash answered {status}")
            deadline = time.monotonic() + 60
            while engine.stats()["engine_resets"] < 1:
                check(time.monotonic() < deadline, "no recovery")
                time.sleep(0.01)
            status, out = call("/generate/", body(prompts[0]))
            st = engine.stats()
            check(status == 200 and out["tokens"] == T_u[0]
                  and st["crashes_total"] == st["engine_resets"] == 1
                  and st["pipe_stages"] == 2,
                  f"after pipe.stage_crash: {status}, {st['crashes_total']} "
                  f"crashes, {st['engine_resets']} resets")
            # a hand-off's activations through the host (the fault's path):
            # a mixed step's (1, 64, 768) fp32 hidden states
            h = torch.randn(1, 64, 768, device=device)
            bounce = []
            for _ in range(20):
                if on_card:
                    torch.cuda.synchronize()
                t0 = time.monotonic()
                torch.from_numpy(h.cpu().numpy()).to(h.device)
                if on_card:
                    torch.cuda.synchronize()
                bounce.append((time.monotonic() - t0) * 1e3)
            stats["handoff_host_bounce_ms_p50"] = sorted(bounce)[10]
            stats["pipeline"] = pipe
            say("ticks", f"(d) a pipe.handoff fault: 1 host fallback, the "
                f"same tokens (a host bounce of a (1, 64, 768) fp32 "
                f"hand-off: {stats['handoff_host_bounce_ms_p50']:.3f} ms "
                f"p50; the device hand-off passes the tensor); a "
                f"pipe.stage_crash: 500, the group recovered, the next "
                f"request = T_u")
            os.environ["PENROZ_SERVE_PIPE_STAGES"] = "1"
            mark("d")
            # -- (e) the legacy /generate_batch/ -----------------------------
            rows = [prompts[i] for i in TICKS_LEGACY_ROWS]
            T_rows = [T_c[i] for i in TICKS_LEGACY_ROWS]
            calls = {"batches": 0, "steps": 0}
            real_batched = NeuralNetworkModel.generate_tokens_batched
            real_step = NeuralNetworkModel._batched_step

            def counted_batched(self, *args, **kwargs):
                calls["batches"] += 1
                return real_batched(self, *args, **kwargs)

            def counted_step(self, *args, **kwargs):
                calls["steps"] += 1
                return real_step(self, *args, **kwargs)

            NeuralNetworkModel.generate_tokens_batched = counted_batched
            NeuralNetworkModel._batched_step = counted_step
            try:
                legacy = {}
                for paged, kernel in (("0", "decode_attention"),
                                      ("1", "paged_decode_attention")):
                    os.environ["PAGED_KV_CACHE"] = paged
                    ref = singles(rows) if paged == "1" else T_rows
                    tag = ("legacy batch, "
                           f"{'paged' if paged == '1' else 'contiguous'}")
                    with _env({"PENROZ_CONTINUOUS_BATCHING": "0"}):
                        runs()
                        calls.update(batches=0, steps=0)
                        t0 = time.monotonic()
                        status, out = call("/generate_batch/", dict(
                            body(rows[0]), inputs=rows))
                        wall = time.monotonic() - t0
                        counts = runs()
                    check(status == 200, f"{tag}: {status}: {out}")
                    same(tag, out["sequences"], ref)
                    passes = calls["batches"] + calls["steps"]
                    want = {name: (n_attn * passes if name == kernel else 0)
                            for name in kernels}
                    check(not on_card or (counts == want and passes > 0),
                          f"{tag}: device runs {counts} for {passes} "
                          f"forward passes, expected {want}")
                    legacy[tag] = {"wall_s": wall, "forward_passes": passes}
                # the breaker's fallback: one crash opens it, the next batch
                # is shed to the legacy path
                with _env({"PENROZ_ENGINE_MAX_CRASHES": "1",
                           "PENROZ_BREAKER_COOLDOWN_MS": "600000",
                           "PENROZ_SCHED_FALLBACK": "1"}):
                    DS.reset()
                    arm("decode.step:raise@1+")
                    status, _ = call("/generate_batch/", dict(
                        body(rows[0]), inputs=rows))
                    check(status == 500, f"the crashing batch: {status}")
                    calls.update(batches=0, steps=0)
                    status, out = call("/generate_batch/", dict(
                        body(rows[0]), inputs=rows))
                    arm(None)
                    check(DS.breaker_open_engines() == [model_id]
                          and calls["batches"] == 1,
                          f"the fallback did not take the legacy path: "
                          f"{DS.breaker_open_engines()}, {calls}")
                    check(status == 200, f"the fallback batch: {status}")
                    same("legacy fallback", out["sequences"], ref)
                    DS.reset()
            finally:
                NeuralNetworkModel.generate_tokens_batched = real_batched
                NeuralNetworkModel._batched_step = real_step
            stats["legacy"] = legacy
            say("ticks", f"(e) legacy /generate_batch/ of {len(rows)} rows: "
                f"each = its single-sequence tokens on the contiguous and "
                f"paged caches ({legacy}); the breaker's fallback answered "
                f"the batch through the legacy path, the same rows")
            mark("e")
    finally:
        NeuralNetworkModel.deserialize = classmethod(real_load)
        spec_decode.propose = real_spec
        arm(None)
        DS.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    for name, n in totals.items():
        check(not on_card or n > 0, f"{name} ran no time in the phase")
    stats["seconds"] = time.monotonic() - t_phase
    for tag, r in stats["rates"].items():
        if "busy_share" in r:
            say("ticks", f"{tag}: {r['tokens_per_s']:.1f} tokens/s "
                f"({r['wall_s']:.3f} s, {r['forward_passes']} forward "
                f"passes, {r['dispatches']} dispatches); device busy "
                f"{_share(r)} of its first {r['window_ms']:.0f} ms, on "
                f"{card}")
    say("ticks", f"{stats['seconds']:.1f} s; device runs {totals} on {card}")
    return stats, totals


# ---------------------------------------------------------------------------
# 4m: the hybrid's rows on every engine path
# ---------------------------------------------------------------------------

SSM_ENV = dict(CB_ENV, PENROZ_KV_PAGE_SIZE="128", PENROZ_PREFIX_CACHE="0",
               PENROZ_MEMLEDGER_STRICT="1", TURBO_QUANT_KV_CACHE="0",
               PENROZ_SPEC_DECODE="0", PENROZ_SCHED_SUPERSTEP="8",
               PENROZ_PREFILL_CHUNK="256", PENROZ_RAGGED_ATTENTION="1",
               PENROZ_SERVE_PIPE_STAGES="1", PENROZ_SCHED_REPLICAS="1",
               PENROZ_DISAGG_PREFILL="0")
# phase 4b's wave: 8 greedy requests of these prompt lengths, 64 new each
SSM_LENS = CB_PROMPT_LENS
SSM_NEW = CB_NEW_TOKENS
SSM_LEGACY_ROWS = TICKS_LEGACY_ROWS


def phase_ssm(torch, optimizer, card, device="cuda", model_id="smoke_ssm"):
    """Phase 4c's full-width hybrid (``hybrid_custom(768, 12, 12, vocab
    50304, block 1024, ssm_every 2)``, fp32, seed 0; 6 attention and 6
    ssm layers) under continuous batching, 8 rows, phase 4b's wave (8
    concurrent streamed greedy /generate/, prompts of SSM_LENS tokens,
    numpy seed 0, 64 new), each on a fresh engine: the unified engine
    (pages of 128), the phased ticks over the contiguous cache,
    speculation (PENROZ_SPEC_DECODE=1, K 4) on the unified engine, one of
    two replicas prefill-only over the d2d and the host hand-offs, an
    ``ssm.handoff`` fault on the host hand-off, and a legacy
    /generate_batch/ of 4 of the prompts (continuous batching off).

    Gates: every stream and row = its prompt's single-sequence tokens (in
    process, contiguous cache, graph decode); in every wave the
    recurrent-update kernel's device runs = 6 x the engines' forward
    passes and the wave's attention kernel's (ragged, or the contiguous
    decode kernel on the phased ticks) the same, the others none; during
    the unified wave ``ssm_state_bytes`` is the same at two lengths and
    equals ``/memory/``'s ``ssm_state``, whose page states partition the
    pool; exports = imports = 8 on both transports; the fault's hand-off
    falls back (one failure) with the same tokens.  Returns (stats, the
    phase's wrapper launches of the recurrent-update kernel).
    ``device="cpu"`` rehearses it at a toy size through the plain
    versions (no kernel counts)."""
    import numpy as np

    from penroz_tpu_torch.models import presets
    from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel
    from penroz_tpu_torch.ops.kernels import decode_attention as DA
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    from penroz_tpu_torch.serve import app as app_mod
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.utils import checkpoint, faults

    t_phase = time.monotonic()
    on_card = device != "cpu"
    layers = presets.hybrid_custom(**HYBRID)
    vocab, block = HYBRID["vocab"], HYBRID["block"]
    with torch.device("meta"):
        arch = CompiledArch(layers)
    n_ssm, n_attn = len(arch.ssm_layers), len(arch.attn_layers)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n).tolist() for n in SSM_LENS]
    kernels = {"ssm_update": SU.ssm_update,
               "decode_attention": DA.decode_attention,
               "ragged_paged_attention": RPA.ragged_paged_attention}
    stats = {"rates": {}, "marks": {}}
    launched = [0]

    def runs():
        out = {}
        for name, fn in kernels.items():
            out[name] = fn.runs.read() if on_card else 0
            if name == "ssm_update":
                launched[0] += fn.launches
            fn.runs.reset()
            fn.launches = 0
        return out

    def call(path, body=None, method=None):
        status, _, text = _qos_call(base, path, body, method)
        try:
            return status, json.loads(text) if text else None
        except ValueError:
            return status, text

    def same(tag, got, want):
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                first = next(j for j, (a, b) in enumerate(zip(g, w))
                             if a != b)
                raise SmokeFailure(
                    f"{tag}: stream {i} diverges at token {first} "
                    f"({g[first]} against {w[first]})")

    def wave(tag, attention, during=None):
        """The 8 streams on fresh engines of the current knobs: opened one
        after another, ``during()`` called while they run, then read.
        Returns (sequences, each engine's stats, what ``during``
        returned)."""
        DS.reset()
        target = DS.get_engine(model_id, block, 0, None,
                               device=server.device)
        engines = list(getattr(target, "replicas", [target]))
        runs()
        t0 = time.monotonic()
        resps = []
        for p in prompts:
            req = urllib.request.Request(
                base + "/generate/", data=json.dumps({
                    "model_id": model_id, "input": [p], "block_size": block,
                    "max_new_tokens": SSM_NEW, "temperature": 0,
                    "stream": True}).encode(),
                method="POST", headers={"Content-Type": "application/json"})
            resps.append(urllib.request.urlopen(req, timeout=900))
        seen = during() if during is not None else None
        outs = []
        for p, resp in zip(prompts, resps):
            with resp:
                check(resp.status == 200, f"{tag}: status {resp.status}")
                outs.append(p + [int(line) for line in resp])
        if on_card:
            torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = runs()
        passes = sum(e._forward_passes for e in engines)
        if on_card:
            want = {name: (n_ssm * passes if name == "ssm_update"
                           else n_attn * passes if name == attention else 0)
                    for name in kernels}
            check(counts == want and passes > 0, f"{tag}: device runs "
                  f"{counts} for {passes} forward passes, expected {want}")
        st = [e.stats() for e in engines]
        stats["rates"][tag] = {"tokens_per_s": len(prompts) * SSM_NEW / wall,
                               "wall_s": wall, "forward_passes": passes,
                               "dispatches": sum(s["dispatches_total"]
                                                 for s in st)}
        say("ssm", f"{tag}: 8 streams = the single-sequence tokens, "
            f"{len(prompts) * SSM_NEW / wall:.1f} tokens/s, {passes} "
            f"forward passes; device runs {counts} = {n_ssm} and "
            f"{n_attn} x passes")
        return outs, st, seen

    # the checkpoint is read once for the phase (serving never writes it)
    real_load = NeuralNetworkModel.deserialize.__func__
    loaded = {}

    def load_once(cls, mid, device=None, **kwargs):
        key = (mid, str(device))
        if key not in loaded:
            loaded[key] = real_load(cls, mid, device=device, **kwargs)
        return loaded[key]

    server = app_mod.create_app(device=device)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % server.server_address[:2]
    NeuralNetworkModel.deserialize = classmethod(load_once)
    try:
        with _env(SSM_ENV):
            status, out = call("/model/", {"model_id": model_id,
                                           "layers": layers,
                                           "optimizer": optimizer})
            check(status == 200, f"POST /model/ -> {status}: {out}")
            with _env({"PAGED_KV_CACHE": "0"}):
                model = NeuralNetworkModel.deserialize(
                    model_id, device=device, optimizer=False)
                t0 = time.monotonic()
                ref = [model.generate_tokens([p], block, SSM_NEW,
                                             temperature=0) for p in prompts]
                stats["single_s"] = time.monotonic() - t0
            runs()
            stats["marks"]["refs"] = round(time.monotonic() - t_phase, 1)

            # -- the unified engine, polled while its rows grow ------------
            def poll():
                reads = []
                for _ in range(2):
                    _, st = call("/serving_stats/")
                    _, mem = call("/memory/")
                    eng = next(e for e in st["engines"]
                               if e["model_id"] == model_id)
                    entry = next(e for e in mem["engines"]
                                 if e["model_id"] == model_id)
                    check(sum(entry["pool_pages"].values())
                          == entry["pool_pages_total"],
                          f"/memory/ pages {entry['pool_pages']} do not "
                          f"partition {entry['pool_pages_total']}")
                    check(entry["hbm_bytes"]["ssm_state"]
                          == eng["ssm_state_bytes"] > 0,
                          f"/memory/ ssm_state {entry['hbm_bytes']} != "
                          f"ssm_state_bytes {eng['ssm_state_bytes']}")
                    reads.append((eng["ssm_state_bytes"],
                                  eng["decode_tokens"], eng["ssm_rows"]))
                    time.sleep(0.3)
                return reads

            got, st, reads = wave("unified", "ragged_paged_attention", poll)
            same("unified", got, ref)
            check(reads[0][0] == reads[1][0] and reads[1][1] > reads[0][1],
                  f"ssm_state_bytes across two lengths: {reads}")
            stats["unified"] = {"ssm_state_bytes": reads[0][0],
                                "polls": reads,
                                "ssm_rows_max": max(r[2] for r in reads)}
            say("ssm", f"unified: ssm_state_bytes {reads[0][0]} at "
                f"{reads[0][1]} and {reads[1][1]} decoded tokens; /memory/ "
                f"partitions the pool and its ssm_state equals it")
            # -- the phased ticks over the contiguous cache ------------------
            with _env({"PAGED_KV_CACHE": "0"}):
                got, st, _ = wave("phased contiguous", "decode_attention")
            same("phased contiguous", got, ref)
            check(not any(t["unified"] for t in st[0]["tick_timeline"]),
                  "phased contiguous: a unified tick")
            # -- speculation on the unified engine ---------------------------
            with _env({"PENROZ_SPEC_DECODE": "1", "PENROZ_SPEC_K": "4",
                       "PENROZ_SPEC_NGRAM": "3"}):
                got, st, _ = wave("unified speculation",
                                  "ragged_paged_attention")
            same("unified speculation", got, ref)
            stats["spec"] = {k: st[0][k] for k in (
                "spec_verify_steps", "spec_drafted_tokens",
                "spec_accepted_tokens")}
            stats["marks"]["waves"] = round(time.monotonic() - t_phase, 1)
            # -- disaggregated prefill: d2d, host, an ssm.handoff fault ------
            disagg = {"PENROZ_SCHED_REPLICAS": "2",
                      "PENROZ_DISAGG_PREFILL": "1",
                      "PENROZ_DISAGG_PREFILL_REPLICAS": "1"}
            stats["disagg"] = {}
            for transport, spec in (("d2d", None), ("host", None),
                                    ("host", "ssm.handoff:raise@1")):
                tag = f"disaggregated {transport}" + (
                    ", ssm.handoff fault" if spec else "")
                faults.reset()
                env = dict(disagg, PENROZ_DISAGG_TRANSPORT=transport)
                if spec:
                    env[faults.ENV] = spec
                with _env(env):
                    got, st, _ = wave(tag, "ragged_paged_attention")
                    os.environ.pop(faults.ENV, None)
                faults.reset()
                same(tag, got, ref)
                exports = sum(s["disagg_exports"] for s in st)
                imports = sum(s["disagg_imports"] for s in st)
                failures = sum(s["disagg_handoff_failures"] for s in st)
                check([s["role"] for s in st] == ["prefill", "decode"],
                      f"{tag}: roles {[s['role'] for s in st]}")
                want = (7, 1) if spec else (8, 0)
                check((imports, failures) == want,
                      f"{tag}: {imports} imports and {failures} failures, "
                      f"expected {want}")
                stats["disagg"][tag] = {"exports": exports,
                                        "imports": imports,
                                        "failures": failures}
                say("ssm", f"{tag}: {exports} exports, {imports} imports, "
                    f"{failures} failures")
            stats["marks"]["disagg"] = round(time.monotonic() - t_phase, 1)
            # -- the legacy /generate_batch/ ---------------------------------
            rows = [prompts[i] for i in SSM_LEGACY_ROWS]
            with _env({"PENROZ_CONTINUOUS_BATCHING": "0",
                       "PAGED_KV_CACHE": "0"}):
                DS.reset()
                runs()
                t0 = time.monotonic()
                status, out = call("/generate_batch/", {
                    "model_id": model_id, "inputs": rows,
                    "block_size": block, "max_new_tokens": SSM_NEW,
                    "temperature": 0})
                legacy_s = time.monotonic() - t0
                counts = runs()
            check(status == 200, f"/generate_batch/ -> {status}: {out}")
            same("legacy /generate_batch/", out["sequences"],
                 [ref[i] for i in SSM_LEGACY_ROWS])
            check(not on_card or counts["ssm_update"] > 0,
                  "legacy /generate_batch/: the recurrent update never ran")
            stats["legacy"] = {"s": legacy_s, "runs": counts}
            say("ssm", f"legacy /generate_batch/ of {len(rows)} rows: each "
                f"= its single-sequence tokens in {legacy_s:.3f} s; device "
                f"runs {counts}")
        status, _ = call(f"/model/?model_id={model_id}", method="DELETE")
        check(status == 204, f"DELETE /model/ -> {status}")
    finally:
        NeuralNetworkModel.deserialize = classmethod(real_load)
        DS.reset()
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        checkpoint.join_flushes()
    check(not thread.is_alive(), "server thread did not stop")
    stats["seconds"] = time.monotonic() - t_phase
    say("ssm", f"ok on {card}: phase {stats['seconds']:.1f} s")
    return stats, launched[0]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="penroz_tpu_torch chip smoke")
    parser.add_argument("--out", help="also write every measurement here "
                        "(JSON)")
    parser.add_argument("--rank-worker", help=argparse.SUPPRESS)
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
    if args.rank_worker:
        # one rank of phase 5d, started by phase_ranks
        return rank_worker(json.loads(args.rank_worker))
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
        card, name = timed("device", phase_device, torch)
        builds = phase_build()
        rows = timed("kernels", phase_kernels, torch, builds)
        from penroz_tpu_torch.models import presets
        gpt2 = dict(block=1024, vocab=50304, card=card)
        stats, launches = timed("main_path", phase_main_path, torch, "cuda",
                                presets.gpt2(), presets.ADAMW, **gpt2)
        rows.update(timed("kernels_ragged", phase_kernels, torch, builds,
                          ragged=True))
        # the engine's phases: GPT-2 width at SERVE_DEPTH blocks
        serve = presets.gpt2_custom(768, 12, SERVE_DEPTH)
        cb_stats, launches["ragged_paged_attention"] = timed(
            "continuous", phase_continuous_batching, torch, serve,
            presets.ADAMW, **gpt2)
        pf_stats, pf_launches = timed("prefix_spec", phase_prefix_spec,
                                      torch, serve, presets.ADAMW, **gpt2)
        launches["ragged_paged_attention"] += pf_launches
        res_stats, res_launches = timed("resilience", phase_resilience,
                                        torch, serve, presets.ADAMW, **gpt2)
        qos_stats, qos_launches = timed("qos", phase_qos, torch, serve,
                                        presets.ADAMW, **gpt2)
        lora_stats, lora_launches = timed("lora", phase_lora, torch, serve,
                                          presets.ADAMW, **gpt2)
        router_stats, router_launches = timed(
            "router", phase_router, torch, serve, presets.ADAMW, **gpt2)
        sess_stats, sess_launches = timed(
            "sessions", phase_sessions, torch, serve, presets.ADAMW, **gpt2)
        ticks_stats, ticks_launches = timed(
            "ticks", phase_ticks, torch, serve, presets.ADAMW, **gpt2)
        hybrid_stats, launches["gla_chunked"] = timed(
            "hybrid", phase_hybrid, torch, presets.ADAMW, card)
        ssm_stats, ssm_launches = timed("ssm", phase_ssm, torch,
                                        presets.ADAMW, card)
        launches["ssm_update"] = hybrid_stats["ssm_update"]["launched"]
        qwen3_stats, qwen3_launches = timed("qwen3", phase_import, torch,
                                            card, "qwen3")
        qmoe_stats, qmoe_launches = timed("qmoe", phase_import, torch, card,
                                          "qmoe")
        train_stats, train_launches = timed(
            "training", phase_training, torch, presets.gpt2(), presets.ADAMW,
            vocab=50304, card=card)
        launches.update(train_launches)
        train_stats["stats"] = timed("stats", phase_stats, torch, card)
        train_stats["profile"] = timed(
            "profile", phase_train_profile, torch, presets.gpt2(),
            presets.ADAMW, vocab=50304)
        train_stats["options"] = timed("train_options", phase_train_options,
                                       torch, vocab=50304, card=card)
        moe_layers = moe_train_layers()
        moe_stats, moe_launches = timed(
            "moe_training", phase_training, torch, moe_layers, presets.ADAMW,
            vocab=50304, card=card, model_id="smoke_moe", tag="moe_training",
            then=_moe_after_training)
        # each kernel's count over every main path that ran it (each
        # phase zeroes the counts before its traffic, reads them after)
        phase_launches = {"gpt2_and_hybrid": dict(launches),
                          "ssm": {"ssm_update": ssm_launches},
                          "prefix_spec": {"ragged_paged_attention":
                                          pf_launches},
                          "qwen3": qwen3_launches, "qmoe": qmoe_launches,
                          "moe_training": moe_launches,
                          "resilience": res_launches,
                          "qos": qos_launches, "lora": lora_launches,
                          "router": router_launches,
                          "sessions": sess_launches,
                          "ticks": ticks_launches}
        for extra in (qwen3_launches, qmoe_launches, moe_launches,
                      res_launches, qos_launches, lora_launches,
                      router_launches, sess_launches, ticks_launches,
                      {"ssm_update": ssm_launches}):
            for name_, n in extra.items():
                launches[name_] += n
        ranks_stats, ranks_launches = timed(
            "ranks", phase_ranks, torch, presets.gpt2(), presets.ADAMW, card)
        phase_launches["ranks"] = ranks_launches
        for name_, n in ranks_launches.items():
            launches[name_] += n
        step_stats = timed("micro_step", phase_micro_step, torch,
                           presets.gpt2(), presets.ADAMW, vocab=50304)
        moe_step_stats = timed("moe_micro_step", phase_micro_step, torch,
                               moe_layers, presets.ADAMW, vocab=50304,
                               tag="moe_micro_step")
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
                       "main_path": stats,
                       "continuous_batching": cb_stats,
                       "prefix_spec": pf_stats,
                       "resilience": res_stats,
                       "qos": qos_stats, "lora": lora_stats,
                       "router": router_stats, "sessions": sess_stats,
                       "ticks": ticks_stats,
                       "hybrid": hybrid_stats, "ssm": ssm_stats,
                       "qwen3": qwen3_stats,
                       "qmoe": qmoe_stats, "phase_launches": phase_launches,
                       "training": train_stats, "micro_step": step_stats,
                       "moe_training": moe_stats,
                       "moe_micro_step": moe_step_stats,
                       "ranks": ranks_stats,
                       "launches": launches, "phase_s": WALL,
                       "seconds": time.monotonic() - t_start}, f, indent=1)
    say("done", f"{time.monotonic() - t_start:.1f} s; each phase's wall "
        f"time: " + ", ".join(f"{k} {v:.1f} s" for k, v in WALL.items()))
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
