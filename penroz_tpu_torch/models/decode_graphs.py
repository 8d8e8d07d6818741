"""Multi-step decode dispatch for the single-sequence ``/generate/`` path
(the torch form of the JAX package's ``CompiledArch.decode_chunk``, one
``lax.scan`` of up to ``PENROZ_DECODE_CHUNK`` decode-and-sample steps a
dispatch).

A :class:`DecodeRunner` owns static buffers: a copy of the model's
parameters (a request copies its loaded weights in, device to device), a
KV cache of ``block_size`` positions (and the hybrid's ``ssm`` child), the
last token, the cache position, a chunk's token buffer and its step index,
and the sampling seed, temperature and key offset as device scalars.  Its
decode step reads every position from the device (ops/kv_cache.py
``StepPositions``), writes the caches in place and its token into the
chunk buffer, so on ``cuda`` one step is captured into a
``torch.cuda.CUDAGraph`` (after a warm-up on a side stream, once a runner)
and a dispatch of ``chunk`` steps is ``chunk`` replays with no read of the
device between them.  On the CPU the same step runs eagerly: that is what
the CPU tests run.  On the card the eager step is the reference the graphs
are held against: the chip script and the ``cuda`` tests set
:data:`_GRAPHS` to False in process.  A capture or replay failure raises;
nothing falls back to the eager step.

Sampling: greedy is ``argmax``; otherwise the counter-based Gumbel-max
draw of ``CompiledArch._sample_packed``, keyed by the request's seed, row
0 and the sampled token's index in the whole context, so the tokens do
not depend on the chunk size or on capture.

A runner for a LoRA adapter (models/lora.py ``bind_model``) also owns fp32
factor buffers for the adapter's targeted projections, rank-padded to
``PENROZ_LORA_MAX_RANK``, which each request fills before its prefill; its
steps apply them as the bound delta (``Ctx.adapter``).

Runners are process-wide, keyed by the model's layers and parameter
dtypes, the device, the cache class (int8, paged and its page size, the
SSM checkpoint ring), the block size, the sampling mode (greedy, top-k
with its k, or full), graphs on or off, and the adapter's targeted
projections and padded rank (none for a base request, whose runner never
carries factors): capture is paid once per key
and process, not per request (the counterpart of the JAX package's
process-wide jit cache).  A request holds its runner for its whole
generation; up to :data:`RUNNERS_PER_KEY` concurrent requests on one key
get runners of their own, later ones wait.  One idle runner a key is
kept, and the idle runners together hold at most :data:`IDLE_SHARE` of
the device's memory (the least recently used dropped first); deleting a
model drops them all (:func:`drop_idle`).

The kernel wrappers count the launches they make, not the ones a capture
records, so a replay moves no count: what a replay ran is counted by the
kernels themselves on the device (ops/kernels/build.py ``RunCounter``).
"""

from __future__ import annotations

import collections
import contextlib
import copy
import json
import os
import threading
import time

import torch

from penroz_tpu_torch.models import lora
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops import ssm as ssm_ops

# Whether steps on ``cuda`` replay a captured graph (False: the eager step,
# the reference the graphs are held against in process).
_GRAPHS = True
# Two overlapping requests on one layout decode side by side; a third waits.
RUNNERS_PER_KEY = 2
# The share of the device's memory that idle runners may hold together.
IDLE_SHARE = 0.1
# Eager steps on a side stream before a capture: first-use caches (kernel
# builds, SM counts, ALiBi slopes) and cuBLAS's workspaces.
WARMUP_STEPS = 2

# Process-wide counts: captures and their seconds (warm-up included), the
# eager warm-up steps (real launches), the prefills, and the steps
# replayed or run eagerly by chunk dispatches.
STATS = {"captures": 0, "capture_s": [], "warmup_steps": 0, "prefills": 0,
         "replayed_steps": 0, "eager_steps": 0}

_STATS_LOCK = threading.Lock()
_COND = threading.Condition()
_IDLE: "collections.OrderedDict[tuple, DecodeRunner]" = \
    collections.OrderedDict()
_ALIVE: dict = {}  # key -> runners alive (idle or held)


def graphs_enabled(device) -> bool:
    """Whether decode steps on ``device`` replay a captured graph."""
    return torch.device(device).type == "cuda" and _GRAPHS


def _device_bytes(device) -> int:
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def _held_bytes(*objs) -> int:
    """Bytes of the tensors that ``objs`` hold as attributes, alone or in
    lists."""
    total = 0
    for obj in objs:
        for value in vars(obj).values():
            for t in value if isinstance(value, list) else (value,):
                if isinstance(t, torch.Tensor):
                    total += t.numel() * t.element_size()
    return total


class DecodeRunner:
    """Static buffers and one decode-and-sample step (see the module
    note); ``graph`` is the captured step on ``cuda``, else None."""

    def __init__(self, arch, dtype, block_size: int, greedy: bool, top_k,
                 device, graphs: bool, lora_shape=None):
        self.device = torch.device(device)
        self.arch = copy.deepcopy(arch).requires_grad_(False)
        # LoRA: fp32 factor buffers {prefix: (A (R, in), B (out, R), scale)}
        # that every step reads, filled by each request (zero past its
        # rank); None for a base runner
        self.adapter = None
        if lora_shape is not None:
            prefixes, R = lora_shape
            dims = {p: (m.in_features, m.out_features)
                    for p, m in self.arch.named_modules() if p in prefixes}
            f32 = dict(dtype=torch.float32, device=self.device)
            self.adapter = {p: (torch.zeros(R, dims[p][0], **f32),
                                torch.zeros(dims[p][1], R, **f32),
                                torch.zeros((), **f32))
                            for p in prefixes}
        self.kv = KV.create_kv_state(arch.kv_specs, 1, block_size, dtype,
                                     device=self.device,
                                     ssm_specs=arch.ssm_specs)
        self.greedy, self.top_k = greedy, top_k

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.int64, device=self.device)

        self.tok = zeros(1, 1)          # the token the next step feeds
        self.pos = zeros(1)             # its cache position
        self.step_idx = zeros(1)        # its slot in ``out``
        self.out = zeros(1, block_size)  # a chunk's tokens
        self.seed = zeros()
        self.temp = torch.ones((), dtype=torch.float32, device=self.device)
        self.key_base = zeros(1)        # context index of cache position 0
        self.graph = None
        if graphs:
            self._capture()
        self.nbytes = _held_bytes(self, self.kv, *(
            [self.kv.ssm] if self.kv.ssm is not None else [])) + sum(
            t.numel() * t.element_size()
            for t in self.arch.state_dict().values()) + sum(
            t.numel() * t.element_size()
            for ent in (self.adapter or {}).values() for t in ent)

    # -- the step -----------------------------------------------------------

    def _sample(self, logits, key):
        """(1,) next token from (1, V) logits; ``key`` (1,) the new token's
        index in the whole context."""
        if self.greedy:
            return torch.argmax(logits.to(torch.float32), dim=-1)
        return self.arch._sample_packed(logits, self.seed,
                                        torch.zeros_like(key), key,
                                        self.temp, self.top_k)

    def _step(self):
        """Feed ``tok`` at ``pos``, sample, write the token at ``step_idx``
        of ``out`` and advance both indices — all on the device."""
        positions = KV.step_positions(self.pos, 1, 1)
        self.kv.at_positions(positions)
        try:
            acts, _, _ = self.arch(self.tok, kv=self.kv, skip_softmax=True,
                                   pos_offset=positions.index.view(1, 1),
                                   adapter=self.adapter)
        finally:
            self.kv.at_positions(None)
        logits = acts[-1]
        if logits.ndim == 3:
            logits = logits[:, -1, :]
        tok = self._sample(logits, self.key_base + self.pos + 1).view(1, 1)
        self.tok.copy_(tok)
        self.out.index_copy_(1, self.step_idx, tok)
        self.step_idx.add_(1)
        self.pos.add_(1)

    def _capture(self):
        """Warm up on a side stream, then capture one step (thread-local
        capture mode: other threads' work is not disturbed).  The cache is
        scratch here; every request starts with a prefill that resets
        it."""
        t0 = time.monotonic()
        self.kv.reset()
        self.kv.reserve(WARMUP_STEPS + 1)
        self.pos.zero_()
        self.step_idx.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self._step()
        torch.cuda.current_stream(self.device).synchronize()
        self.graph = graph
        with _STATS_LOCK:
            STATS["captures"] += 1
            STATS["warmup_steps"] += WARMUP_STEPS
            STATS["capture_s"].append(time.monotonic() - t0)

    # -- a request ----------------------------------------------------------

    def start(self, arch, seed, temp: float, adapter=None):
        """Take a request: copy its weights in (device to device), its
        adapter's factors (``(params, config)``, models/lora.py: rank
        zero-padded to the buffers'), its sampling seed (a device scalar,
        or None when greedy) and its temperature."""
        dst = self.arch.state_dict()
        for key, src in arch.state_dict().items():
            dst[key].copy_(src)
        if self.adapter is not None:
            params, config = adapter
            s = lora.scale(config)
            for prefix, (a, b, scale) in self.adapter.items():
                src_a = lora.as_tensor(params[f"{prefix}.lora_A"])
                src_b = lora.as_tensor(params[f"{prefix}.lora_B"])
                r = src_a.shape[0]
                a.zero_()
                b.zero_()
                a[:r].copy_(src_a)
                b[:, :r].copy_(src_b)
                scale.fill_(s)
        if seed is not None:
            self.seed.copy_(seed)
        self.temp.fill_(float(temp))

    def prefill(self, feed: list, key_base: int):
        """Reset the cache and feed ``feed`` eagerly (host positions);
        the sampled token becomes ``tok``, at ``pos`` = len(feed).
        ``key_base``: the context index of ``feed[0]``.  Returns ``tok``."""
        self.kv.reset()
        x = torch.tensor([feed], dtype=torch.int64, device=self.device)
        acts, _, _ = self.arch(x, kv=self.kv, skip_softmax=True,
                               adapter=self.adapter)
        logits = acts[-1]
        if logits.ndim == 3:
            logits = logits[:, -1, :]
        self.key_base.fill_(int(key_base))
        key = self.key_base + len(feed)
        self.tok.copy_(self._sample(logits, key).view(1, 1))
        self.pos.fill_(len(feed))
        with _STATS_LOCK:
            STATS["prefills"] += 1
        return self.tok

    def decode(self, chunk: int):
        """Dispatch ``chunk`` steps (replays on ``cuda`` with graphs, else
        eager steps) and mirror the host length; returns the (1, chunk)
        tokens, on the device."""
        self.kv.reserve(self.kv.length + chunk)
        self.step_idx.zero_()
        if self.graph is not None:
            for _ in range(chunk):
                self.graph.replay()
            counter = "replayed_steps"
        else:
            for _ in range(chunk):
                self._step()
            counter = "eager_steps"
        with _STATS_LOCK:
            STATS[counter] += chunk
        self.kv.advanced(chunk)
        return self.out[:, :chunk]

    def to_host(self, toks):
        """Start copying device tokens to the host without waiting:
        ``(host tensor, event)``; read the tensor after ``event``
        synchronizes (None on the CPU, where the copy is done)."""
        if self.device.type != "cuda":
            return toks.clone(), None
        host = torch.empty(toks.shape, dtype=toks.dtype, pin_memory=True)
        host.copy_(toks, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event


def lora_shape(adapter):
    """``(targeted prefixes, padded rank)`` of an adapter ``(params,
    config)`` (None without one): what an adapter runner's factor buffers
    and captured step depend on.  Ranks pad to ``PENROZ_LORA_MAX_RANK``,
    so adapters that target the same projections share runners."""
    if adapter is None:
        return None
    params, config = adapter
    prefixes = tuple(k[:-len(".lora_A")] for k in params
                     if k.endswith(".lora_A"))
    return prefixes, max(lora.max_rank(), int(config["rank"]))


def runner_key(arch, block_size: int, greedy: bool, top_k, device,
               adapter=None) -> tuple:
    """What a runner's buffers and captured step depend on: a runner
    captured without factors never replays for an adapter, nor one with
    them for a base request."""
    paged = KV.paged_enabled()
    return (json.dumps(arch.layers_dsl, sort_keys=True),
            tuple(str(t.dtype) for t in arch.state_dict().values()),
            str(torch.device(device)), int(block_size),
            KV.turbo_quant_enabled(), paged,
            KV.default_page_size() if paged else None,
            ssm_ops.ckpt_slots_default() if arch.ssm_specs else None,
            lora_shape(adapter),
            "greedy" if greedy else ("top_k", int(top_k))
            if top_k is not None else "full",
            graphs_enabled(device))


@contextlib.contextmanager
def runner(arch, dtype, block_size: int, greedy: bool, top_k, device,
           adapter=None):
    """Hold a runner for ``arch``'s key for the duration (built, and on
    ``cuda`` captured, when none is idle and fewer than
    :data:`RUNNERS_PER_KEY` are alive; else wait for one); ``dtype``: the
    cache's, the parameters'; ``adapter``: the request's ``(params,
    config)`` or None."""
    key = runner_key(arch, block_size, greedy, top_k, device, adapter)
    with _COND:
        while True:
            held = _IDLE.pop(key, None)
            if held is not None:
                break
            if _ALIVE.get(key, 0) < RUNNERS_PER_KEY:
                _ALIVE[key] = _ALIVE.get(key, 0) + 1
                held = None
                break
            _COND.wait()
    if held is None:
        try:
            # plain tensors (not inference tensors), usable in any mode
            with torch.inference_mode(False), torch.no_grad():
                held = DecodeRunner(arch, dtype, block_size, greedy, top_k,
                                    device, graphs=graphs_enabled(device),
                                    lora_shape=lora_shape(adapter))
        except BaseException:
            _drop(key)
            raise
    try:
        yield held
    except GeneratorExit:  # a generation abandoned between dispatches
        _release(key, held)
        raise
    except BaseException:
        _drop(key)  # it may have stopped mid-step: build a fresh one
        raise
    else:
        _release(key, held)


def _drop(key):
    with _COND:
        _ALIVE[key] -= 1
        if not _ALIVE[key]:
            del _ALIVE[key]
        _COND.notify_all()


def _release(key, held):
    """Keep ``held`` idle, unless its key has an idle runner already; then
    drop the least recently used idle runners until they hold at most
    :data:`IDLE_SHARE` of the device's memory."""
    with _COND:
        if key in _IDLE:
            _ALIVE[key] -= 1
            _IDLE.move_to_end(key)
        else:
            _IDLE[key] = held
        budget = IDLE_SHARE * _device_bytes(held.device)
        while _IDLE and sum(r.nbytes for r in _IDLE.values()) > budget:
            oldest, _ = _IDLE.popitem(last=False)
            _ALIVE[oldest] -= 1
        for k in [k for k, n in _ALIVE.items() if not n]:
            del _ALIVE[k]
        _COND.notify_all()


def drop_idle():
    """Drop every idle runner (a deleted model's weights may be in one)."""
    with _COND:
        for key in _IDLE:
            _ALIVE[key] -= 1
            if not _ALIVE[key]:
                del _ALIVE[key]
        _IDLE.clear()
        _COND.notify_all()


def dispatched_steps() -> int:
    """Steps the runners have run in this process, each launching the
    cached attention kernel once per attention layer: prefills, replayed
    and eager steps, and capture warm-ups."""
    with _STATS_LOCK:
        return (STATS["prefills"] + STATS["replayed_steps"]
                + STATS["eager_steps"] + STATS["warmup_steps"])


def reset():
    """Drop every idle runner and zero :data:`STATS` (tests, and between
    the chip script's phases)."""
    drop_idle()
    with _STATS_LOCK:
        STATS.update(captures=0, capture_s=[], warmup_steps=0, prefills=0,
                     replayed_steps=0, eager_steps=0)
