"""Continuous-batching decode scheduler: concurrent /generate/ and
/generate_batch/ requests share one in-flight batch over a multi-row KV
cache (counterpart of penroz_tpu/serve/decode_scheduler.py).

Per ``(model, block_size, temperature, top_k)`` one :class:`DecodeEngine`
owns a fixed-capacity batch (``PENROZ_SCHED_MAX_ROWS``, default 8) whose
rows own static page ranges of one paged pool (``PAGED_KV_CACHE=1``) or
their own rows of a contiguous cache, and a worker thread that:

- admits queued requests into free rows at block boundaries, each row in a
  PREFILLING phase whose prompt is cut into chunks of
  ``PENROZ_PREFILL_CHUNK`` tokens (default 256) with a power-of-two tail;
- over the paged pool runs every tick as ONE unified block
  (``_tick_unified``): the host plans
  up to ``PENROZ_SCHED_SUPERSTEP`` steps (default 8) in which each
  prefilling row runs one chunk a step and each decoding row one token a
  step, packs every step's spans into descriptor blocks, and runs the block
  through ``NeuralNetworkModel.decode_mixed_step`` — each attention layer
  launches the ragged paged-attention kernel once a step, the plan goes to
  the device in one copy and the samples come back in one read;
- replays the sampled block on the host: first tokens of finished
  prefills, decode tokens, retirement on the stop token, ``max_new_tokens``
  or a full row; a retired row's slot is free for the next admission.

With ``PENROZ_PREFIX_CACHE=1`` the pool grows by
``PENROZ_PREFIX_CACHE_PAGES`` pages (default 64) past the rows' static
partition, and a :class:`~penroz_tpu_torch.ops.kv_cache.RadixPrefixCache`
hands them out: an admission matches its prompt's longest cached
whole-page prefix, aliases those pages into its row's block table (pinned
until retirement) and prefills only the suffix; a finished prefill copies
its new full pages into the tail and registers them.  With
``PENROZ_SPEC_DECODE=1`` a decoding row with a prompt-lookup draft
(serve/spec_decode.py) runs one K+1-row verify span at the block's first
step, and its replay emits the accepted draft tokens plus the model's
next one; the host length then skips the rejected positions, which the
next span overwrites.

Greedy outputs equal the single-sequence path's token for token (the same
positions, the same cached attention), with or without a prefix hit or
speculation.  Temperature > 0 draws each (row, position) with a
positional key, so a stream does not depend on packing, superstep, chunk
split, a prefix hit or speculation.

The JAX package's asyncio event plumbing becomes threads: a request
carries a callback that the worker calls with ``("token", id)``, then
``("done", None)`` or ``("error", exc)``; :func:`run_request` and
:func:`start_stream` bridge it to a ``queue.Queue`` per request for the
``ThreadingHTTPServer`` handlers.  Only the worker thread touches the
engine's tensors.

Fault tolerance (the JAX package's contract, with its defaults):

- **Deadlines**: a request's ``timeout_ms``, capped by
  ``PENROZ_REQ_TIMEOUT_MS`` (which also gives a deadline to requests that
  set none; both off by default).  A queued request past it is shed
  before any prefill; an admitted one retires at the next block boundary
  after it (a prefill chunk's or a token's), and its stream ends with a
  ``("timeout", DeadlineExceeded)`` event (HTTP 504, or a ``timeout``
  line after the tokens already streamed).
- **Bounded queue**: ``PENROZ_SCHED_MAX_QUEUE`` waiting requests (0, the
  default, is unbounded); ``submit`` refuses the next with
  :class:`QueueFullError` (429) and a Retry-After of the queue's rough
  drain time.
- **Circuit breaker**: ``PENROZ_ENGINE_MAX_CRASHES`` (default 3)
  consecutive crashed ticks open it; while open, ``submit`` refuses with
  :class:`CircuitOpenError` (503, Retry-After the remaining cooldown)
  until ``PENROZ_BREAKER_COOLDOWN_MS`` (default 1000) has passed, then
  admits exactly one probe.  A request that completes resets the count
  and closes the breaker; a probe that fails, times out or is cancelled
  re-arms the cooldown.  ``PENROZ_SCHED_FALLBACK=1`` lets the HTTP layer
  serve ``/generate/`` on the single-sequence path instead of the 503.
- **Drain**: ``shutdown(drain_s=...)`` (``PENROZ_DRAIN_S``, default 5 s,
  for :func:`drain_and_shutdown`) stops admission and lets the rows in
  flight finish before the worker stops.
- **Watchdog**: :meth:`DecodeEngine.stuck` is True while one tick has
  run longer than ``PENROZ_TICK_WATCHDOG_MS`` (0, the default, is off).
- **Admission window**: ``PENROZ_SCHED_ADMIT_MS`` (default 0) holds an
  idle engine's first admission that long, so that a burst shares its
  first block.

:func:`breaker_open_engines`, :func:`stuck_engines` and :func:`draining`
back ``GET /readyz``.  The fault sites ``decode.step``,
``decode.prefill_chunk`` and ``decode.verify`` (utils/faults.py) fire
before each block's dispatch, as in the JAX package.

Multi-tenant QoS (serve/qos.py): a request carries a ``priority``
(``interactive``, ``standard`` or ``batch``) and a ``tenant``.  The
admission queue is a :class:`~penroz_tpu_torch.serve.qos.WFQueue`
(deficit-weighted round robin over ``(tenant, class)`` sub-queues); a
tenant whose token bucket is empty is refused at ``submit`` with
:class:`TenantQuotaExceeded` (429 + Retry-After), and
``PENROZ_QOS_MAX_QUEUE_<CLASS>`` bounds one class's queue.  With the
prefix cache on and the batch full, a queued ``interactive`` request
preempts the lowest-class, longest-running decode row
(``PENROZ_QOS_PREEMPT``, default 1): the victim's history goes into the
radix cache (its uncached pages copied, the chain pinned), its row frees
with no terminal event, and it requeues at the head of its sub-queue;
its resume admission aliases the pinned pages back and prefills only the
rest, so greedy tokens equal an unpreempted run's.  The fault site
``qos.preempt`` fires before any mutation.

Observability: fixed-bucket histograms (utils/metrics.py: TTFT, ITL,
queue wait, chunk stall, tick time, tokens per dispatch, TTFT and queue
wait per class) per engine and mirrored process-wide into
serve/metrics.py (``GET /metrics``); a per-request span tree
(utils/tracing.py: queue, prefill, prefix_match, prefill_chunk, decode,
decode_step, preempt, resume, recovery, ``retire_reason``) when the
request carries a trace; the capacity ledger and flight recorder
(serve/memledger.py, ``GET /memory/``, ``GET /debug/dump``; with
``PENROZ_MEMLEDGER_STRICT=1`` every retirement, preemption and crash
recovery audits the page partition).  :func:`serving_stats` backs
``GET /serving_stats/`` under the JAX package's key names.

Replicas (serve/router.py): ``PENROZ_SCHED_REPLICAS=N`` (N > 1) makes
:func:`get_engine` hand back an ``EngineRouter`` over N engines of one
key, each with its own pool, radix cache, worker thread and breaker, all
on the one device.  With ``PENROZ_DISAGG_PREFILL=1`` the first replicas
take the ``prefill`` role: a finished prompt's row leaves through the
hand-off seam (:meth:`DecodeEngine._export_handoff`) instead of emitting,
its KV pages travel to a ``decode`` replica over the ``d2d`` transport
(``PENROZ_DISAGG_TRANSPORT``, default; device planes, the source row
parked under the ledger's ``transit`` state until the importer acks,
``PENROZ_DISAGG_ACK_TIMEOUT_MS`` at most) or the ``host`` one (a CRC page
blob in shm), and the decode replica imports them and emits the first
token the prefill replica sampled.  Every failure of the seam falls back
greedy-identically: a refused d2d import re-sends through the host blob,
a failed export or import re-prefills monolithically on a decode replica.
A cross-engine call never runs under the caller's own condition lock:
the worker hands off after the block's replay releases it, and an
importer's acks go out after its admission does, so two workers never
wait on each other's locks.

The phased ticks (JAX ``_tick``'s other form): over the contiguous cache,
or the paged pool with ``PENROZ_RAGGED_ATTENTION=0``, a tick runs the
prefill chunks of one step boundary (one a boundary while rows decode, more
under the ``PENROZ_SCHED_MAX_STALL_MS`` budget; each through
``NeuralNetworkModel.decode_prefill_chunk`` on its row's view), then either
one shared step (``decode_step_batched``; rows with a speculative draft
verify first, ``decode_verify_row`` and ``rollback_row``) or one fused
superstep of up to ``PENROZ_SCHED_SUPERSTEP`` steps
(``decode_superstep``: the active mask, stop tokens and budgets on the
device), whose every step launches the cache's decode kernel (contiguous
or paged) once a layer with the rows' own lengths.  Speculation on the
phased ticks serves greedy engines, as in the JAX package.

Pipeline-parallel serving (``PENROZ_SERVE_PIPE_STAGES=S``, S > 1, over the
paged pool's unified ticks; ignored with a warning otherwise): the model's
modules split into S stages (``NeuralNetworkModel.serve_pipeline``), the
active rows into ``PENROZ_SERVE_PIPE_BLOCKS`` micro-blocks (at least S),
each planned as a mixed block; a pipeline tick walks the stages last to
first and moves each block one stage (``decode_pipe_stage`` against the
stage's slice of the pools), so S blocks keep S stages busy.  The fault
sites ``pipe.handoff`` (the activations bounce through the host, counted)
and ``pipe.stage_crash`` (a tick crash: the whole group recovers) fire in
it.  While LoRA adapters are live the engine serves unpiped.

Hybrid and pure-SSM models (``ssm`` layers) take the same engine: their
rows carry the cache's recurrent ``ssm`` child (ops/ssm.py), updated by
one launch of the recurrent-update kernel a layer and a forward pass
(packed in a unified block, dense on the phased ticks, where a parked row
is left out of it), zeroed when a row is recycled, rolled back through
its checkpoint ring after a speculative verify and handed off with the
row's pages.  ``PENROZ_PREFIX_CACHE=1`` is ignored for them with a warning
(a recurrent state cannot be rebuilt from shared prefix pages), and with
it preemption and hibernation; a pipeline stage partition refuses them,
so the engine serves unpiped.  The fault sites ``ssm.scan`` (before each
mixed and shared-step dispatch) and ``ssm.handoff`` (inside both hand-off
exports) fire only for such models.
Not ported (refused by :func:`unported_serving_options`, HTTP 400):
serving meshes (``PENROZ_SERVE_MESH``).

Session hibernation (serve/tierstore.py): a request's ``session_id``
parks its prompt and generated tokens' KV at retirement
(:meth:`DecodeEngine._maybe_hibernate`: inserted into the radix cache and
pinned under a hold, the ledger's ``hibernating`` pages); the worker's
loop tail demotes one pending session a tick to the host tier
(:meth:`DecodeEngine._process_demotions`, ``export_pages``); an admission
whose prompt's whole pages match a hibernated session's wakes it
(:meth:`DecodeEngine._promote_session`: the blob's pages imported into
fresh radix slots, aliased like a radix hit), with or without a
``session_id``.  The fault sites ``tier.demote`` and ``tier.promote`` fire
before either mutates anything.  :func:`start_stream` registers the
request's resumable stream (serve/streams.py); the journal
(serve/journal.py) records the tiers' state.

LoRA adapters (models/lora.py, serve/adapters.py): a request's
``adapter`` takes one of ``PENROZ_LORA_MAX_LIVE`` live slots (a slot
holding the same adapter generation is shared), whose factors stack into
one pack on the device, rebuilt when the slot set changes; every packed
token of a block carries its row's slot (``lora_slots``), so prefill
chunks, decode steps and verify spans of different adapters, and base
rows, share one mixed step.  When every slot holds another adapter with
rows in flight, the request requeues at the head until one frees.  The
radix cache namespaces pages by adapter generation (a preempted row
resumes in its own), crash recovery rebuilds the slot tables with the
pool, and a model reload flushes them and the registry's entries of the
model.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from penroz_tpu_torch.models import lora as lora_mod
from penroz_tpu_torch.models import model as model_mod
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
from penroz_tpu_torch.serve import adapters as adapters_mod
from penroz_tpu_torch.serve import (journal, memledger, qos, spec_decode,
                                    streams, tierstore)
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.serve.qos import TenantQuotaExceeded
from penroz_tpu_torch.utils import (bucketing, checkpoint, faults,
                                    profiling)
from penroz_tpu_torch.utils import metrics as metrics_util

log = logging.getLogger(__name__)

ENABLE_ENV = "PENROZ_CONTINUOUS_BATCHING"
MAX_ROWS_ENV = "PENROZ_SCHED_MAX_ROWS"
MAX_ENGINES_ENV = "PENROZ_SCHED_MAX_ENGINES"
PREFILL_CHUNK_ENV = "PENROZ_PREFILL_CHUNK"
SUPERSTEP_ENV = "PENROZ_SCHED_SUPERSTEP"
RAGGED_ENV = "PENROZ_RAGGED_ATTENTION"
REQ_TIMEOUT_ENV = "PENROZ_REQ_TIMEOUT_MS"
MAX_QUEUE_ENV = "PENROZ_SCHED_MAX_QUEUE"
MAX_CRASHES_ENV = "PENROZ_ENGINE_MAX_CRASHES"
BREAKER_COOLDOWN_ENV = "PENROZ_BREAKER_COOLDOWN_MS"
FALLBACK_ENV = "PENROZ_SCHED_FALLBACK"
ADMIT_MS_ENV = "PENROZ_SCHED_ADMIT_MS"
TICK_WATCHDOG_ENV = "PENROZ_TICK_WATCHDOG_MS"
DRAIN_S_ENV = "PENROZ_DRAIN_S"
TICK_TIMELINE_ENV = "PENROZ_TICK_TIMELINE"
REPLICAS_ENV = "PENROZ_SCHED_REPLICAS"
MAX_STALL_MS_ENV = "PENROZ_SCHED_MAX_STALL_MS"
PIPE_STAGES_ENV = "PENROZ_SERVE_PIPE_STAGES"
PIPE_BLOCKS_ENV = "PENROZ_SERVE_PIPE_BLOCKS"
# Disaggregated prefill's hand-off transport: "d2d" (device planes handed
# over in process, the default: every replica of a group lives here) or
# "host" (the CRC page-blob codec, also the fallback when d2d fails).
DISAGG_TRANSPORT_ENV = "PENROZ_DISAGG_TRANSPORT"
DISAGG_ACK_TIMEOUT_ENV = "PENROZ_DISAGG_ACK_TIMEOUT_MS"

# Scheduler features of the JAX package this port does not have yet:
# (variable, predicate on its value that selects the feature, what).
_UNPORTED_SERVING_ENV = (
    ("PENROZ_SERVE_MESH", lambda v: v == "1", "a serving mesh"),
)

# Tick-timeline entries served per /serving_stats/ payload (the ring
# itself holds PENROZ_TICK_TIMELINE entries, default 256).
_TIMELINE_SERVE = 120
# Window of the recent tokens/s rate (and the ledger's burn rate), seconds.
_TPS_WINDOW_S = 30.0


def _rate(num, den):
    return (num / den) if den else None


class QueueFullError(RuntimeError):
    """The admission queue is at ``PENROZ_SCHED_MAX_QUEUE``: the request is
    shed (429).  ``retry_after`` (seconds) is the queue's rough drain
    time: its depth times the recent tick median, in [1, 30]."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = int(retry_after)


class CircuitOpenError(RuntimeError):
    """The engine's circuit breaker is open after repeated crashes (503, or
    the single-sequence path under ``PENROZ_SCHED_FALLBACK=1``).
    ``retry_after`` is the remaining cooldown, rounded up (seconds)."""

    def __init__(self, msg: str, retry_after: int = 1):
        super().__init__(msg)
        self.retry_after = int(retry_after)


class DeadlineExceeded(RuntimeError):
    """A request's deadline expired (504).  ``phase`` is ``"queued"`` (shed
    before its prefill started) or ``"inflight"`` (its row retired at a
    block boundary)."""

    def __init__(self, phase: str, detail: str):
        super().__init__(detail)
        self.phase = phase


def enabled() -> bool:
    return os.environ.get(ENABLE_ENV, "0") == "1"


def fallback_enabled() -> bool:
    return os.environ.get(FALLBACK_ENV, "0") == "1"


def _env_int(name: str, default: int, lo: int = 1) -> int:
    try:
        return max(lo, int(os.environ.get(name, str(default))))
    except ValueError:
        log.warning("Unparseable %s=%r; using default %d", name,
                    os.environ.get(name), default)
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, str(default))))
    except ValueError:
        log.warning("Unparseable %s=%r; using %s", name,
                    os.environ.get(name), default)
        return default


def _max_rows() -> int:
    return _env_int(MAX_ROWS_ENV, 8)


def _max_queue() -> int:
    """Admission queue bound (0: unbounded)."""
    return _env_int(MAX_QUEUE_ENV, 0, lo=0)


def _max_crashes() -> int:
    return _env_int(MAX_CRASHES_ENV, 3)


def _breaker_cooldown_ms() -> float:
    return _env_float(BREAKER_COOLDOWN_ENV, 1000.0)


def _drain_s() -> float:
    return _env_float(DRAIN_S_ENV, 5.0)


def _admit_ms() -> float:
    return _env_float(ADMIT_MS_ENV, 0.0)


def _watchdog_ms() -> float:
    return _env_float(TICK_WATCHDOG_ENV, 0.0)


def _effective_timeout_ms(timeout_ms) -> float | None:
    """A request's deadline budget: its ``timeout_ms`` capped by the
    server-wide ``PENROZ_REQ_TIMEOUT_MS``, which also applies to requests
    that set none.  None: no deadline (both off, the default)."""
    cap = _env_float(REQ_TIMEOUT_ENV, 0.0)
    t = float(timeout_ms) if timeout_ms else 0.0
    if cap > 0:
        t = min(t, cap) if t > 0 else cap
    return t if t > 0 else None


def _max_engines() -> int:
    return _env_int(MAX_ENGINES_ENV, 4)


def _prefill_chunk() -> int:
    return _env_int(PREFILL_CHUNK_ENV, 256)


def ragged_enabled() -> bool:
    """The unified ragged tick over the paged pool (on unless
    ``PENROZ_RAGGED_ATTENTION=0``, which keeps the phased ticks)."""
    return os.environ.get(RAGGED_ENV, "1") != "0"


def _max_stall_ms() -> float:
    """The phased ticks' prefill budget a step boundary while rows decode
    (0: one chunk)."""
    return _env_float(MAX_STALL_MS_ENV, 0.0)


def _pipe_stages() -> int:
    """Pipeline stages of one serving group (1: off)."""
    return _env_int(PIPE_STAGES_ENV, 1)


def _pipe_blocks(stages: int) -> int:
    """Micro-blocks a pipeline tick splits the rows into: at least
    ``stages``, so every stage can be busy once the pipeline fills."""
    return max(int(stages), _env_int(PIPE_BLOCKS_ENV, stages))


def _superstep_max() -> int:
    """Unified steps per dispatch (1: one step a tick)."""
    return _env_int(SUPERSTEP_ENV, 8)


def _timeline_len() -> int:
    """Tick-timeline entries an engine keeps (its ring's length)."""
    return _env_int(TICK_TIMELINE_ENV, 256)


def _replicas() -> int:
    """Engine replicas per (model, config) key: more than 1 routes
    acquisition through serve/router.py; 1 (the default) is the
    single-engine registry."""
    return _env_int(REPLICAS_ENV, 1)


def _disagg_transport() -> str:
    """The hand-off transport of disaggregated prefill: ``d2d`` (the
    default) or ``host``."""
    v = os.environ.get(DISAGG_TRANSPORT_ENV, "d2d").strip().lower()
    if v not in ("d2d", "host"):
        log.warning("Unknown %s=%r; using d2d", DISAGG_TRANSPORT_ENV, v)
        return "d2d"
    return v


def _ack_timeout_s() -> float:
    """How long an exporter row stays parked awaiting the importer's d2d
    ack before its pages are reaped (the importer owns the request's
    stream by then, so a lost ack must not hold pages forever)."""
    return _env_float(DISAGG_ACK_TIMEOUT_ENV, 10000.0) / 1000.0


def unported_serving_options() -> None:
    """Raise ValueError (HTTP 400) naming the knob when continuous batching
    is on with a scheduler feature the port does not have."""
    if not enabled():
        return
    for name, selects, what in _UNPORTED_SERVING_ENV:
        value = os.environ.get(name)
        if value is not None and selects(value):
            raise ValueError(f"{name}={value!r} selects {what}, which "
                             f"penroz_tpu_torch does not support yet")


def eligible(prompt: list[int], block_size: int, max_new_tokens: int) -> bool:
    """A request the scheduler serves losslessly: a non-empty prompt that
    fits its row with all its new tokens (the scheduler has no overflow
    crop; other requests take the single-sequence path)."""
    return (len(prompt) >= 1 and max_new_tokens >= 1
            and len(prompt) + max_new_tokens <= block_size)


class Request:
    """One generation request in flight through an engine.

    ``on_event(kind, value)`` is called FROM THE WORKER THREAD with
    ``("token", int)`` per generated token (the stop token included), then
    ``("done", None)``, ``("error", exc)`` or ``("timeout",
    DeadlineExceeded)``.  Setting ``cancelled`` retires the row at the
    next block boundary.

    ``priority`` (an SLO class, serve/qos.py; ``standard`` when None, a
    ValueError for an unknown one) and ``tenant`` (``default`` when None)
    route it through the fair queue and the quota buckets.  ``handoff``
    is set by a prefill replica after an export (the d2d planes or the
    blob id, the KV length, the first token, the export's start, the
    exporter's ack) and consumed by the decode replica's admission.
    ``request_id`` is its ``X-Request-Id``; ``trace`` (utils/tracing.py)
    its span tree, or None when sampled out — every recording site is
    None-guarded.  ``adapter`` (serve/adapters.py ``AdapterEntry``, pinned
    by the caller until the request's last event) routes the row through
    that adapter's live slot; its id is the tenant when ``tenant`` is
    None.  ``session_id`` hibernates its KV at retirement
    (serve/tierstore.py); ``stream`` is its resumable stream
    (serve/streams.py) when :func:`start_stream` submitted it."""

    __slots__ = ("prompt", "max_new_tokens", "stop_token", "on_event",
                 "cancelled", "enqueue_t", "deadline", "request_id",
                 "trace", "priority", "tenant", "resume_history",
                 "resume_produced", "resume_nodes", "preempted", "adapter",
                 "handoff", "session_id", "stream")

    def __init__(self, prompt, max_new_tokens, stop_token, on_event,
                 timeout_ms=None, request_id=None, trace=None,
                 priority=None, tenant=None, adapter=None, session_id=None):
        self.prompt = [int(t) for t in prompt]
        self.max_new_tokens = int(max_new_tokens)
        self.stop_token = stop_token
        self.on_event = on_event
        self.cancelled = False
        self.enqueue_t = time.monotonic()
        self.priority = qos.validate_priority(priority)
        self.adapter = adapter
        self.tenant = qos.tenant_of(
            tenant, adapter.adapter_id if adapter is not None else None)
        # Preempt-to-prefix-cache resume state: the full history (prompt +
        # emitted tokens) is the resume admission's effective prompt, and
        # ``resume_nodes`` pin the cached pages until its prefix match
        # re-pins them.
        self.resume_history = None
        self.resume_produced = 0
        self.resume_nodes: list = []
        self.preempted = 0
        self.handoff = None
        self.session_id = session_id
        self.stream = None
        self.request_id = request_id
        self.trace = trace
        budget = _effective_timeout_ms(timeout_ms)
        self.deadline = (self.enqueue_t + budget / 1000.0
                         if budget is not None else None)

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (now or time.monotonic()) >= self.deadline)


class _Row:
    __slots__ = ("req", "produced", "prefilling", "prefilled", "chunks",
                 "chunk_idx", "history", "prefix_nodes", "admit_t",
                 "resumed", "last_emit_t", "sp_prefill", "sp_decode",
                 "transit", "session_wake")

    def __init__(self, req: Request):
        self.req = req
        self.produced = 0
        # admission time ranks preemption victims (longest-running first);
        # a resumed row skips TTFT (its first token shipped before the
        # preempt)
        self.admit_t = time.monotonic()
        self.resumed = False
        # the admission woke a hibernated session: its TTFT also goes to
        # the session-resume histogram
        self.session_wake = False
        # a hand-off row whose pages are in flight (a parked exporter row
        # awaiting its ack, an importer row mid-import): the ledger's
        # ``transit`` state, never planned into a block
        self.transit = False
        # inter-token latency anchor, and the row's open trace spans
        self.last_emit_t = None
        self.sp_prefill = None
        self.sp_decode = None
        # PREFILLING phase: ``prefilled`` is the row's valid KV length so
        # far; ``chunks`` the pow-2-tailed plan over the prompt.
        self.prefilling = True
        self.prefilled = 0
        self.chunks: list = []
        self.chunk_idx = 0
        # prompt + every emitted token, in order
        self.history = list(req.prompt)
        # radix nodes aliased into the row's table, pinned until retirement
        self.prefix_nodes: list = []


class DecodeEngine:
    """Per-(model, block_size, sampling) continuous-batching engine over
    the paged pool.  The worker thread owns the KV state, the host-side
    per-row lengths (authoritative) and last tokens; ``submit`` only
    queues.  ``replica`` is its index in a serve/router.py group (0 alone)
    and ``role`` its disaggregation role (``decode``, or ``prefill``: a
    finished prompt leaves through ``_handoff_sink``)."""

    def __init__(self, model_id: str, block_size: int, temperature, top_k,
                 capacity: int | None = None, device=None, replica: int = 0,
                 role: str = "decode"):
        self.model_id = model_id
        self.block_size = int(block_size)
        self.temperature = temperature
        self.top_k = top_k
        self.capacity = capacity or _max_rows()
        self.greedy = temperature is None or float(temperature) == 0.0
        self._device = device
        # router-owned replicas are no eviction victims: the router owns
        # their lifecycle
        self.replica = int(replica)
        self._router_owned = False
        self.role = role
        self._handoff_sink = None
        # the d2d free-after-ack protocol: rows whose planes shipped park
        # in _transit_rows until the importer's ack lands in _acks (from
        # the importer's thread); _outbox holds the block's finished
        # prefills until its replay releases the lock, _ack_out an
        # importer's acks until its admission does; _requested_role is
        # the elastic rebalancer's pending flip
        self._transit_rows: dict = {}
        self._acks: list = []
        self._outbox: list = []
        self._ack_out: list = []
        self._requested_role = None
        self._disagg_role_changes = 0
        self._disagg_exports = 0
        self._disagg_imports = 0
        self._disagg_handoff_failures = 0
        self._h_handoff = metrics_util.Hist()
        self._model = NeuralNetworkModel.deserialize(model_id, device=device,
                                                     optimizer=False)
        self._model.arch.check_positions(self.block_size, "block_size")
        self._ckpt_stamp_v = self._ckpt_stamp()
        # Pipeline-parallel serving: the stage partition of the unified
        # ragged ticks (micro-blocks are slices of the mixed plan), so it
        # needs the paged pool and the ragged path; the counters are the
        # JAX package's.
        self._pipe = None
        self._pipe_ticks = 0
        self._pipe_bubble_ticks = 0
        self._pipe_stage_busy: collections.Counter = collections.Counter()
        self._pipe_handoffs = 0
        self._pipe_handoff_host_fallbacks = 0
        self._pipe_lora_warned = False
        stages = _pipe_stages()
        if stages > 1:
            if not (KV.paged_enabled() and ragged_enabled()):
                log.warning(
                    "%s=%d ignored: pipeline serving rides the unified "
                    "ragged dispatch (%s=1 + %s=1)", PIPE_STAGES_ENV,
                    stages, KV.PAGED_ENV, RAGGED_ENV)
            else:
                try:
                    self._pipe = self._model.serve_pipeline(stages)
                except ValueError as e:
                    log.warning("%s=%d ignored: %s", PIPE_STAGES_ENV,
                                stages, e)
        # the radix prefix cache's reserved pool tail (page-granular: the
        # paged pool only; preemption and hibernation ride it).  A model
        # with recurrent rows gets none: a radix match aliases pages, and
        # the matching row's recurrent state cannot be rebuilt from them.
        self._has_ssm = bool(self._model.arch.ssm_specs)
        self._extra_pages = 0
        if KV.prefix_cache_enabled():
            if self._has_ssm:
                log.warning(
                    "%s=1 ignored: arch has %d SSM layer(s); recurrent row "
                    "state cannot be rebuilt from shared prefix pages",
                    KV.PREFIX_CACHE_ENV, len(self._model.arch.ssm_specs))
            elif KV.paged_enabled():
                self._extra_pages = KV.prefix_cache_pages()
            else:
                log.warning("%s=1 ignored: prefix-KV sharing is "
                            "page-granular and needs %s=1",
                            KV.PREFIX_CACHE_ENV, KV.PAGED_ENV)
        self._prefix_cache = None
        self._lengths = np.zeros(self.capacity, np.int32)
        self._last_tok = np.zeros(self.capacity, np.int32)
        self._rows: list = [None] * self.capacity
        # mixed-adapter serving (models/lora.py): up to PENROZ_LORA_MAX_LIVE
        # adapters hold live slots stacked into one pack; slot _max_live is
        # the all-zero base slot
        self._max_live = lora_mod.max_live()
        self._adapter_tokens: dict = {}
        # the capacity ledger (serve/memledger.py) derives page ownership
        # from the structures below; it outlives state reallocations
        self._ledger = memledger.MemoryLedger(self)
        self._alloc_state()

        # the admission queue: deficit-weighted round robin over (tenant,
        # class) sub-queues; every use holds _cond
        self._pending = qos.WFQueue()
        self._cond = threading.Condition()
        self._shutdown = False
        self._draining = False

        # circuit breaker (under _cond: submit runs on handler threads,
        # crashes and retirements on the worker)
        self._breaker_open = False
        self._breaker_open_t = 0.0
        self._probe_inflight = False
        self._crashes = 0          # consecutive, since the last completion
        # the tick watchdog: when the running tick started (None between
        # ticks) and whether this stuck episode was logged
        self._dispatch_t0 = None
        self._watchdog_fired = False
        # Positional sampling keys (temperature > 0) derive from this seed.
        self._seed = 0

        # metrics (written by the worker thread only)
        self._admissions = 0
        self._completed = 0
        self._decode_steps = 0
        self._decode_tokens = 0
        self._decode_time_s = 0.0
        self._prefill_chunks = 0
        self._dispatches = 0
        # forward passes the engine ran: a unified block's steps, the phased
        # ticks' shared and fused steps, prefill chunks and verify spans
        self._forward_passes = 0
        self._chunks_between_steps = 0
        self._max_chunks_between_steps = 0
        self._occupancy_sum = 0.0
        # (monotonic s, decode tokens) per block, the last _TPS_WINDOW_S
        self._token_window: collections.deque = collections.deque()
        self._spec_verify_steps = 0
        self._spec_drafted_tokens = 0
        self._spec_accepted_tokens = 0
        self._crashes_total = 0
        self._engine_resets = 0
        self._queue_rejections = 0
        self._breaker_rejections = 0
        self._deadline_timeouts = 0
        # QoS accounting: sheds by a tenant's quota, preemptions and the
        # tokens their resumes restored from the cache, admissions per
        # class, emitted tokens per tenant
        self._quota_rejections = 0
        self._preemptions = 0
        self._resume_cached_tokens = 0
        # session hibernation: hibernations and blob promotions this
        # engine ran, and the TTFT of the admissions that woke a session
        self._sessions_hibernated = 0
        self._session_promotions = 0
        self._h_resume_ttft = metrics_util.Hist()
        self._class_admissions = collections.Counter()
        self._tenant_tokens: dict = {}
        # Latency distributions (utils/metrics.py Hist, the JAX package's
        # buckets), mirrored process-wide into serve/metrics.py:
        # enqueue -> first token, enqueue -> admission, the decode batch's
        # stall per block from prefill chunks (0 in a unified block, where
        # chunks ride the decode dispatch), the per-row host emission gap,
        # the tick's wall time, and TTFT / queue wait per class.
        self._h_ttft = metrics_util.Hist()
        self._h_queue_wait = metrics_util.Hist()
        self._h_chunk_stall = metrics_util.Hist()
        self._h_itl = metrics_util.Hist()
        self._h_tick = metrics_util.Hist()
        self._h_ttft_cls = {c: metrics_util.Hist() for c in qos.PRIORITIES}
        self._h_queue_wait_cls = {c: metrics_util.Hist()
                                  for c in qos.PRIORITIES}
        self._h_tokens_per_dispatch = metrics_util.Hist(
            metrics_util.TOKENS_PER_DISPATCH_BUCKETS)
        self._tick_timeline: collections.deque = collections.deque(
            maxlen=_timeline_len())

        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"penroz-sched-{model_id}-{self.block_size}-{self.replica}")
        self._thread.start()

    def _alloc_state(self):
        """(Re)allocate the engine's KV cache from scratch (a paged pool with
        the static per-row page partition under ``PAGED_KV_CACHE=1``, else
        a contiguous cache, fp32 or int8), and the radix prefix cache over
        the pool's tail (pages ``[capacity * pages_per_seq,
        num_pool_pages)``, which the partition never touches) — at
        construction and after a failed tick, whose KV and prefix state
        are presumed corrupt (a pipeline group's every stage: the stages
        run on views of this one cache)."""
        old_cache = self._prefix_cache
        self._kv = (KV.create_kv_state(self._model.arch.kv_specs,
                                       self.capacity, self.block_size,
                                       self._model.dtype,
                                       device=self._model.device,
                                       ssm_specs=self._model.arch.ssm_specs,
                                       extra_pool_pages=self._extra_pages)
                    .with_static_table()
                    .with_lengths(np.zeros(self.capacity, np.int32)))
        self._prefix_cache = None
        if self._extra_pages > 0:
            base = self.capacity * self._kv.pages_per_seq
            self._prefix_cache = KV.RadixPrefixCache(
                range(base, self._kv.num_pool_pages), self._kv.page_size)
        self._lengths[:] = 0
        self._last_tok[:] = 0
        self._rows = [None] * self.capacity
        # the adapter tables too: every row re-parks on the base slot and
        # the pack drops (admission binds live adapters again from their
        # pinned entries)
        self._slot_entries: list = [None] * self._max_live
        self._row_adapter = np.full(self.capacity, self._max_live, np.int32)
        self._lora_pack = None
        # hibernation holds: session id -> the pinned radix chain awaiting
        # demotion (the ledger's ``hibernating`` pages).  The pool they
        # lived in is gone, so the holds die here and the store drops this
        # engine's hbm-tier records; host and disk copies survive.
        self._hib_holds: dict = {}
        self._hib_pending: collections.deque = collections.deque()
        tierstore.TIERS.drop_owner(id(self), "engine_reset")
        # the dying cache's underflow count carries into the ledger's
        self._ledger.on_realloc(old_cache)

    # -- public surface -----------------------------------------------------

    def _queue_retry_after(self) -> int:
        """Retry-After of a queue shed: the queued work's rough drain time
        (depth x the recent tick p50, 50 ms before any tick), in [1, 30] s.
        Callers hold _cond."""
        tick_ms = self._h_tick.quantile(0.5) or 50.0
        return int(min(30, max(1, math.ceil(
            len(self._pending) * tick_ms / 1000.0))))

    def _shed_span(self, req: Request, reason: str):
        """A shed request never reaches a row; its trace still carries the
        queue wait (enqueue -> shed) and the typed reason."""
        if req.trace is not None:
            sp = req.trace.span("queue", t0=req.enqueue_t)
            req.trace.end(sp)
            req.trace.event("shed", reason=reason)

    def submit(self, req: Request):
        """Queue ``req`` or refuse it now (a bounded queue, an exhausted
        tenant quota, an open breaker, a draining engine), so that the
        client gets a typed answer at once instead of a stalled
        connection."""
        with self._cond:
            if self._shutdown or self._draining:
                raise RuntimeError("decode engine is shut down")
            if self._breaker_open:
                cooldown_s = _breaker_cooldown_ms() / 1000.0
                now = time.monotonic()
                remaining_s = self._breaker_open_t + cooldown_s - now
                if self._probe_inflight or remaining_s > 0:
                    self._breaker_rejections += 1
                    serve_metrics.BREAKER_REJECTIONS.inc()
                    serve_metrics.REQUESTS.inc(outcome="breaker_open")
                    if req.trace is not None:
                        req.trace.event("shed", reason="breaker_open")
                    raise CircuitOpenError(
                        f"engine {self.model_id}: circuit breaker open "
                        f"after {self._crashes} consecutive crashes",
                        retry_after=min(30, max(1, math.ceil(
                            max(0.0, remaining_s)))))
                # half-open: this request is the one probe; its completion
                # closes the breaker (_retire), its failure re-arms the
                # cooldown (_probe_failed)
                self._probe_inflight = True
            # an exhausted bucket sheds THIS tenant's new admissions; rows
            # in flight, anyone's, are never touched (a hand-off arrival
            # was admitted and charged on its prefill replica)
            if req.handoff is None:
                try:
                    qos.QUOTAS.admit(req.tenant)
                except TenantQuotaExceeded:
                    self._quota_rejections += 1
                    serve_metrics.QUOTA_REJECTIONS.inc(tenant=req.tenant)
                    serve_metrics.REQUESTS.inc(outcome="quota")
                    self._shed_span(req, "quota")
                    self._probe_failed()
                    raise
            # the class's bound when PENROZ_QOS_MAX_QUEUE_<CLASS> is set
            # (0: unbounded), else the aggregate PENROZ_SCHED_MAX_QUEUE
            cls_bound = qos.class_queue_bound(req.priority)
            if cls_bound is not None:
                full = (cls_bound and self._pending.class_depth(
                    req.priority) >= cls_bound)
                bound_desc = f"{cls_bound} {req.priority} waiting"
            else:
                max_queue = _max_queue()
                full = max_queue and len(self._pending) >= max_queue
                bound_desc = f"{max_queue} waiting"
            if full:
                self._queue_rejections += 1
                serve_metrics.QUEUE_REJECTIONS.inc()
                serve_metrics.REQUESTS.inc(outcome="queue_full")
                self._shed_span(req, "queue_full")
                self._probe_failed()
                raise QueueFullError(
                    f"engine {self.model_id}: admission queue full "
                    f"({bound_desc})",
                    retry_after=self._queue_retry_after())
            self._pending.push(req)
            if req.trace is not None:
                # from here every terminal path (retirement, purge, crash
                # recovery, shutdown) runs through this engine, which
                # finishes the trace
                req.trace.owned = True
            self._cond.notify_all()

    def shutdown(self, timeout: float = 10.0, drain_s: float = 0.0) -> bool:
        """Stop the engine; True iff the worker thread joined.  With
        ``drain_s > 0`` admission stops first and the rows in flight get
        that long to finish; what is still in flight then fails."""
        if drain_s > 0:
            with self._cond:
                self._draining = True
                self._cond.notify_all()
            deadline = time.monotonic() + drain_s
            while self.active_rows and time.monotonic() < deadline:
                time.sleep(0.01)
            if self.active_rows:
                log.warning("Decode engine %s: %d row(s) still in flight "
                            "after a %.1f s drain; failing them",
                            self.model_id, self.active_rows, drain_s)
        with self._cond:
            self._shutdown = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            log.error("Decode engine %s: worker thread failed to join "
                      "within %.1fs", self.model_id, timeout)
            return False
        # hbm-tier sessions die with the pool; demoted host and disk copies
        # wake on the next engine by content
        self._drop_hib_holds()
        tierstore.TIERS.drop_owner(id(self), "engine_shutdown")
        return True

    @property
    def active_rows(self) -> int:
        return sum(1 for r in self._rows if r is not None)

    @property
    def queue_depth(self) -> int:
        return len(self._pending)

    @property
    def live_adapters(self) -> int:
        return sum(1 for e in self._slot_entries if e is not None)

    def idle(self) -> bool:
        return self.active_rows == 0 and not self._pending

    def stuck(self) -> bool:
        """The watchdog's verdict, computed when read: True while the
        worker has been inside one tick longer than
        ``PENROZ_TICK_WATCHDOG_MS`` (0: off).  The first read of a stuck
        episode logs it."""
        limit = _watchdog_ms()
        t0 = self._dispatch_t0
        if limit <= 0 or t0 is None:
            return False
        elapsed_ms = (time.monotonic() - t0) * 1000.0
        if elapsed_ms < limit:
            return False
        if not self._watchdog_fired:
            self._watchdog_fired = True
            log.warning("Decode engine %s watchdog: a tick has run for "
                        "%.0f ms (limit %.0f ms)", self.model_id,
                        elapsed_ms, limit)
        return True

    def _round_q(self, hist: metrics_util.Hist, q: float):
        v = hist.quantile(q)
        return round(v, 3) if v is not None else None

    def stats(self) -> dict:
        """The engine's observability accessor (JAX key names): every
        aggregate (``serving_stats()``) and scrape reads through here.  The
        ``histograms`` key carries the raw bucket snapshots the aggregation
        merges; the HTTP layer drops it from ``/serving_stats/``, as the
        JAX service's response schema does."""
        now = time.monotonic()
        window = [(t, n) for t, n in list(self._token_window)
                  if now - t <= _TPS_WINDOW_S]
        span = (now - window[0][0]) if window else 0.0
        recent = sum(n for _, n in window)
        tps = recent / span if span > 0.2 else (
            self._decode_tokens / self._decode_time_s
            if self._decode_time_s > 0 else 0.0)
        timeline = list(self._tick_timeline)[-_TIMELINE_SERVE:][::-1]
        active = self.active_rows
        tpd = self._h_tokens_per_dispatch.snapshot()
        with self._cond:
            by_class = self._pending.class_depths()
        return {
            "histograms": {
                "ttft_ms": self._h_ttft.snapshot(),
                "itl_ms": self._h_itl.snapshot(),
                "queue_wait_ms": self._h_queue_wait.snapshot(),
                "chunk_stall_ms": self._h_chunk_stall.snapshot(),
                "tick_ms": self._h_tick.snapshot(),
                "tokens_per_dispatch": tpd,
                "ttft_ms_by_class": {
                    c: h.snapshot() for c, h in self._h_ttft_cls.items()},
                "queue_wait_ms_by_class": {
                    c: h.snapshot()
                    for c, h in self._h_queue_wait_cls.items()},
                "handoff_ms": self._h_handoff.snapshot(),
                "session_resume_ttft_ms": self._h_resume_ttft.snapshot(),
            },
            "model_id": self.model_id,
            "block_size": self.block_size,
            "temperature": 0.0 if self.greedy else float(self.temperature),
            "top_k": self.top_k,
            "capacity": self.capacity,
            "replica": self.replica,
            "mesh_devices": 1,
            "role": self.role,
            "disagg_exports": self._disagg_exports,
            "disagg_imports": self._disagg_imports,
            "disagg_handoff_failures": self._disagg_handoff_failures,
            "disagg_handoff_ms_p50": self._round_q(self._h_handoff, 0.5),
            "disagg_handoff_ms_p99": self._round_q(self._h_handoff, 0.99),
            "disagg_transport": _disagg_transport(),
            "disagg_role_changes": self._disagg_role_changes,
            "ssm_rows": active if self._has_ssm else 0,
            "ssm_state_bytes": (int(self._kv.ssm.nbytes())
                                if getattr(self._kv, "ssm", None) is not None
                                else 0),
            "pipe_stages": (self._pipe.stages if self._pipe is not None
                            else 1),
            "pipe_microblocks": (_pipe_blocks(self._pipe.stages)
                                 if self._pipe is not None else 0),
            "pipe_ticks": self._pipe_ticks,
            "pipe_bubble_fraction": (
                round(self._pipe_bubble_ticks
                      / (self._pipe_ticks * self._pipe.stages), 4)
                if self._pipe is not None and self._pipe_ticks else None),
            "pipe_stage_busy": {str(s): int(c) for s, c
                                in sorted(self._pipe_stage_busy.items())},
            "pipe_handoffs": self._pipe_handoffs,
            "pipe_handoff_host_fallbacks":
                self._pipe_handoff_host_fallbacks,
            "active_rows": active,
            "queue_depth": self.queue_depth,
            "occupancy": active / self.capacity,
            "occupancy_avg": (self._occupancy_sum / self._decode_steps
                              if self._decode_steps else 0.0),
            "superstep": _superstep_max(),
            "dispatches_total": self._dispatches,
            "tokens_per_dispatch_avg": (round(tpd["sum"] / tpd["count"], 3)
                                        if tpd["count"] else None),
            "tokens_per_dispatch_p50": self._round_q(
                self._h_tokens_per_dispatch, 0.5),
            "ttft_ms_p99": self._round_q(self._h_ttft, 0.99),
            "itl_ms_p50": self._round_q(self._h_itl, 0.5),
            "itl_ms_p99": self._round_q(self._h_itl, 0.99),
            "tick_ms_p50": self._round_q(self._h_tick, 0.5),
            "tick_ms_p99": self._round_q(self._h_tick, 0.99),
            "admission_latency_ms_p50": self._round_q(self._h_ttft, 0.5),
            "queue_wait_ms_p99": self._round_q(self._h_queue_wait, 0.99),
            "prefill_chunk_stall_ms_p99": self._round_q(self._h_chunk_stall,
                                                        0.99),
            "decode_steps": self._decode_steps,
            "decode_tokens": self._decode_tokens,
            "decode_tokens_per_sec": round(tps, 2),
            "tokens_per_decode_step": round(
                self._decode_tokens / self._decode_steps, 3)
            if self._decode_steps else 0.0,
            "admissions": self._admissions,
            "completed": self._completed,
            "prefill_chunks": self._prefill_chunks,
            "prefill_max_chunks_between_steps":
                self._max_chunks_between_steps,
            "kv_pool_capacity_drops": self._ledger.pool_capacity_drops,
            "unpin_underflows": self._ledger.unpin_underflows,
            "memory": self._ledger.snapshot(),
            "crashes_total": self._crashes_total,
            "engine_resets": self._engine_resets,
            "consecutive_crashes": self._crashes,
            "breaker_open": self._breaker_open,
            "stuck": self.stuck(),
            "queue_rejections": self._queue_rejections,
            "deadline_timeouts": self._deadline_timeouts,
            "breaker_rejections": self._breaker_rejections,
            "quota_rejections": self._quota_rejections,
            "preemptions": self._preemptions,
            "preempted_resume_cached_tokens": self._resume_cached_tokens,
            "sessions_hibernated": self._sessions_hibernated,
            "session_promotions": self._session_promotions,
            "session_resume_ttft_ms_p50": self._round_q(self._h_resume_ttft,
                                                        0.5),
            "session_resume_ttft_ms_p99": self._round_q(self._h_resume_ttft,
                                                        0.99),
            "queue_depth_by_class": by_class,
            "admissions_by_class": {
                c: self._class_admissions[c] for c in qos.PRIORITIES},
            "tenant_tokens": dict(self._tenant_tokens),
            "ttft_ms_p99_by_class": {
                c: self._round_q(h, 0.99)
                for c, h in self._h_ttft_cls.items()},
            "queue_wait_ms_p99_by_class": {
                c: self._round_q(h, 0.99)
                for c, h in self._h_queue_wait_cls.items()},
            "prefix_cache": (self._prefix_cache.stats()
                             if self._prefix_cache is not None else None),
            "lora_active_adapters": self.live_adapters,
            "lora_rows": sum(
                1 for i, r in enumerate(self._rows)
                if r is not None
                and int(self._row_adapter[i]) != self._max_live),
            "lora_adapter_tokens": dict(self._adapter_tokens),
            "spec_decode": self._spec_on(),
            "spec_verify_steps": self._spec_verify_steps,
            "spec_drafted_tokens": self._spec_drafted_tokens,
            "spec_accepted_tokens": self._spec_accepted_tokens,
            "spec_accept_rate": _rate(self._spec_accepted_tokens,
                                      self._spec_drafted_tokens),
            "tick_timeline": [
                {"age_s": round(now - e["t"], 3),
                 **{k: v for k, v in e.items() if k != "t"}}
                for e in timeline],
        }

    def memory_snapshot(self) -> dict:
        """The engine's capacity-ledger view (``GET /memory/``)."""
        return self._ledger.snapshot()

    # -- worker -------------------------------------------------------------

    def _run(self):
        while True:
            with self._cond:
                # a draining engine admits nothing: its queue waits for
                # the shutdown, which fails it.  Rows parked awaiting a d2d
                # ack turn the wait timed, so an overdue ack is reaped.
                while (not self._shutdown
                       and (not self._pending or self._draining)
                       and not self._acks and self._requested_role is None
                       and not self._hib_pending
                       and self.active_rows == len(self._transit_rows)):
                    if self._transit_rows:
                        self._cond.wait(timeout=0.05)
                        if self._ack_overdue():
                            break
                    else:
                        self._cond.wait()
                if self._shutdown:
                    break
            try:
                self._drain_acks()
                self._maybe_flip_role()
                # admission and the block's replay mutate the rows and the
                # radix tree under _cond, so a ledger snapshot (which takes
                # it) sees a block boundary's state, never a torn one
                try:
                    with self._cond:
                        self._purge_expired()
                        self._coalesce_burst()
                        self._admit()
                finally:
                    self._send_acks()
                ticked = self._tick()
                # a hibernated session goes down a tier only after the
                # tick served live traffic
                self._process_demotions()
                if not ticked and self._transit_rows:
                    # every live row is parked: wait for an ack, not spin
                    with self._cond:
                        if not self._acks and not self._shutdown:
                            self._cond.wait(timeout=0.05)
            except Exception as exc:  # noqa: BLE001 — fail requests, not thread
                log.exception("Decode engine %s failed a tick", self.model_id)
                # count the crash, then the postmortem, BEFORE the failure
                # and the reset throw the pre-crash state away
                self._record_crash()
                memledger.FLIGHT_RECORDER.record(self, "engine_crash",
                                                 error=repr(exc))
                with self._cond:
                    crashed = self._fail_all(exc, crashed=True)
                self._send_acks()
                try:
                    # the KV and prefix state are presumed corrupt: the next
                    # request runs on a pool and a radix tree built anew
                    self._engine_resets += 1
                    serve_metrics.ENGINE_RESETS.inc()
                    t_crash = time.monotonic()
                    with self._cond:
                        self._alloc_state()
                    # recovery must hand back a provably clean pool
                    if memledger.strict():
                        self._ledger.audit("crash_recovery")
                    for trace in crashed:
                        sp = trace.span("recovery", t0=t_crash,
                                        resets=self._engine_resets)
                        trace.end(sp)
                        trace.finish("error")
                    log.warning("Decode engine %s reset after crash %d "
                                "(consecutive %d)", self.model_id,
                                self._crashes_total, self._crashes)
                except Exception:  # noqa: BLE001 — the engine is unusable
                    log.exception("Decode engine %s reset failed; shutting "
                                  "it down", self.model_id)
                    memledger.FLIGHT_RECORDER.record(self, "reset_failed")
                    for trace in crashed:
                        trace.finish("error")
                    with self._cond:
                        self._breaker_open = True
                        self._breaker_open_t = time.monotonic()
                        self._shutdown = True
                    break
        self._fail_all(RuntimeError("decode engine shut down"))
        self._send_acks()

    def _record_crash(self):
        serve_metrics.ENGINE_CRASHES.inc()
        with self._cond:
            self._crashes += 1
            self._crashes_total += 1
            if self._crashes >= _max_crashes() and not self._breaker_open:
                self._breaker_open = True
                self._breaker_open_t = time.monotonic()
                log.error("Decode engine %s: circuit breaker OPEN after %d "
                          "consecutive crashes (next probe in %.0f ms)",
                          self.model_id, self._crashes,
                          _breaker_cooldown_ms())
                memledger.FLIGHT_RECORDER.record(self, "circuit_open")

    def _probe_failed(self):
        """The probe ended without completing (crash, deadline, cancel,
        shed): the breaker stays open and its cooldown starts again.
        Callers hold _cond."""
        if self._probe_inflight:
            self._probe_inflight = False
            self._breaker_open_t = time.monotonic()

    def _purge_expired(self):
        """Shed queued requests whose deadline passed (504 before any
        prefill) and drop cancelled ones (a client that went away must not
        cost a prefill)."""
        now = time.monotonic()
        with self._cond:
            if not self._pending:
                return
            removed = self._pending.purge(
                lambda r: r.cancelled or r.expired(now))
        for req in removed:
            self._drop_queued(req)

    def _drop_queued(self, req: Request):
        """A cancelled or expired request that never reached a row: its
        resume pins go, its trace ends, an expired one answers 504."""
        self._release_resume(req)
        self._discard_handoff(req)
        with self._cond:
            if self._breaker_open:
                self._probe_failed()
        if req.cancelled:
            serve_metrics.REQUESTS.inc(outcome="cancelled")
            self._finish_trace(req, "cancelled")
            return
        self._deadline_timeouts += 1
        serve_metrics.DEADLINE_TIMEOUTS.inc()
        serve_metrics.REQUESTS.inc(outcome="timeout")
        if req.trace is not None:
            sp = req.trace.span("queue", t0=req.enqueue_t)
            req.trace.end(sp)
        self._finish_trace(req, "timeout")
        self._deliver(req, "timeout", DeadlineExceeded(
            "queued", "request deadline expired while queued "
            "(before prefill started)"))

    @staticmethod
    def _finish_trace(req: Request, reason: str):
        if req.trace is not None:
            req.trace.finish(reason)

    def _coalesce_burst(self):
        """With ``PENROZ_SCHED_ADMIT_MS`` > 0 and no row in flight, wait up
        to that long after the first arrival, so that a burst shares its
        first block instead of trickling in."""
        admit_ms = _admit_ms()
        if admit_ms <= 0 or self.active_rows:
            return
        with self._cond:
            first_t = self._pending.oldest_enqueue_t()
            if first_t is None:
                return
            deadline = first_t + admit_ms / 1000.0
            while (len(self._pending) < self.capacity
                   and not self._shutdown
                   and time.monotonic() < deadline):
                self._cond.wait(timeout=max(deadline - time.monotonic(),
                                            0.001))

    def _free_row(self):
        for i, r in enumerate(self._rows):
            if r is None:
                return i
        return None

    def _admit(self):
        while True:
            row = self._free_row()
            req = None
            if row is None:
                row, req = self._try_preempt()
                if row is None:
                    return
            if req is None:
                with self._cond:
                    if self._draining or not self._pending:
                        return
                    req = self._pending.pop()
                if req is None:
                    return
            if req.cancelled or req.expired():
                self._drop_queued(req)
                continue
            if self.active_rows == 0:
                self._maybe_reload()
            slot = self._adapter_slot(req)
            if slot is None:
                # every live slot holds another adapter with rows in
                # flight: requeue at the head (FIFO kept) and admit no more
                # this tick; a slot frees when its last row retires
                with self._cond:
                    self._pending.push_front(req)
                return
            if req.handoff is not None:
                self._admit_handoff(row, req, slot)
                continue
            self._begin_prefill(row, req, slot)

    # -- preemption (to the prefix cache; the resume recomputes nothing) ----

    def _try_preempt(self):
        """With the batch full and an ``interactive`` request queued, evict
        the lowest-class longest-running decode row into the radix prefix
        cache and hand its row to the interactive request specifically
        (fair-queue order would hand it back to the flood).  Returns
        ``(row, request)`` or ``(None, None)``."""
        if not qos.preempt_enabled() or self._prefix_cache is None:
            return None, None
        with self._cond:
            if (self._draining
                    or self._pending.class_depth("interactive") == 0):
                return None, None
        victim = self._preempt_victim()
        if victim is None:
            return None, None
        self._preempt_row(victim)
        with self._cond:
            req = self._pending.pop_class("interactive")
        return victim, req

    def _preempt_victim(self):
        """The victim row: a class below ``interactive`` (an interactive
        row is never preempted), decode phase only (a prefilling row has
        produced nothing a client waits on), ``batch`` before
        ``standard``, then the earliest admission."""
        best = best_rank = None
        for i, state in enumerate(self._rows):
            if state is None or state.prefilling:
                continue
            pri = state.req.priority
            if pri == "interactive":
                continue
            rank = (0 if pri == "batch" else 1, state.admit_t)
            if best_rank is None or rank < best_rank:
                best, best_rank = i, rank
        return best

    def _preempt_row(self, row: int):
        """Evict one decode row into the radix prefix cache: its pages are
        already pool-resident, so eviction inserts its history into the
        tree, copies the pages the tree lacks and frees the row.  The
        request requeues at the head of its sub-queue holding the pinned
        chain; the resume admission's prefix match aliases it back.  The
        ``qos.preempt`` fault site fires before any mutation, and a crash
        anywhere here fails the tick, whose reset rebuilds the pool and
        the cache, so no pin outlives the state it guards."""
        faults.check("qos.preempt")
        state = self._rows[row]
        req = state.req
        t0 = time.monotonic()
        # a decode row holds KV for len(history) - 1 tokens (the newest
        # token's KV is written by the step that feeds it): insert the
        # full pages below that
        kv_len = int(self._lengths[row])
        ns = self._prefix_ns(req)   # a resume matches in its own namespace
        created = self._prefix_cache.insert(state.history, limit=kv_len,
                                            namespace=ns)
        if created:
            S = self._kv.pages_per_seq
            self._kv.copy_pages([row * S + b for b, _ in created],
                                [page for _, page in created])
        # pin the whole cached chain until the resume re-pins it: LRU
        # eviction must not recycle these pages while the request waits
        nodes = self._prefix_cache.chain(state.history, limit=kv_len,
                                         namespace=ns)
        self._prefix_cache.pin(nodes)
        cached = len(nodes) * self._prefix_cache.page_size
        # free the row without a terminal event: the stream stays open
        self._rows[row] = None
        self._lengths[row] = 0
        self._last_tok[row] = 0
        self._row_adapter[row] = self._max_live
        self._release_prefix(row, state)
        self._kv.reset_row(row)
        req.resume_history = list(state.history)
        req.resume_produced = state.produced
        req.resume_nodes = nodes
        req.preempted += 1
        # the resume's queue wait starts at the preempt (the deadline stays
        # anchored at the original enqueue)
        req.enqueue_t = t0
        self._preemptions += 1
        serve_metrics.PREEMPTIONS.inc()
        self._ledger.note_pressure()
        if req.trace is not None:
            req.trace.end(state.sp_prefill)
            req.trace.end(state.sp_decode, produced=state.produced)
            sp = req.trace.span("preempt", t0=t0, cached_tokens=cached,
                                produced=state.produced)
            req.trace.end(sp)
            req.trace.event("capacity_pressure", reason="preempted",
                            cached_tokens=cached)
        with self._cond:
            self._pending.push_front(req)
        log.info("Decode engine %s: preempted row %d (%s/%s, %d produced, "
                 "%d tokens cached) for a queued interactive request",
                 self.model_id, row, req.tenant, req.priority,
                 state.produced, cached)
        if memledger.strict():
            self._ledger.audit("preempt")

    def _release_resume(self, req: Request):
        """Drop a preempted request's resume pins (its resume admission, a
        deadline purge, a cancellation, an engine failure)."""
        if req.resume_nodes:
            if self._prefix_cache is not None:
                self._prefix_cache.unpin(req.resume_nodes)
            req.resume_nodes = []

    # -- adapter slots (mixed-adapter batches, models/lora.py) ---------------

    def _adapter_slot(self, req: Request):
        """``req``'s slot: the base slot for a plain row, a live slot
        holding the same adapter generation (uid), else a free one, else
        one whose adapter has no row in flight (the pack rebuilt on the
        device once, here); None when every slot holds another adapter
        with rows in flight."""
        if req.adapter is None:
            return self._max_live
        for s, e in enumerate(self._slot_entries):
            if e is not None and e.uid == req.adapter.uid:
                return s
        in_flight = {int(self._row_adapter[i])
                     for i, r in enumerate(self._rows) if r is not None}
        # a free slot before an idle one (the JAX engine takes the first
        # of either): reclaiming an idle adapter's slot while another is
        # empty would drop it from the pack for nothing
        for s in sorted(range(self._max_live),
                        key=lambda s: self._slot_entries[s] is not None):
            if self._slot_entries[s] is None or s not in in_flight:
                self._slot_entries[s] = req.adapter
                self._rebuild_pack()
                return s
        return None

    def _rebuild_pack(self):
        self._lora_pack = lora_mod.build_pack(
            [e.params if e is not None else None
             for e in self._slot_entries],
            [e.config if e is not None else None
             for e in self._slot_entries],
            self._max_live, device=self._model.device)

    @staticmethod
    def _prefix_ns(req: Request):
        """The row's radix namespace: its adapter's load generation (a
        retrained or recreated adapter never aliases its predecessor's
        pages); None, shared, for base rows."""
        return req.adapter.uid if req.adapter is not None else None

    def _begin_prefill(self, row: int, req: Request, slot: int | None = None):
        """Claim ``row`` for ``req`` in the PREFILLING phase: match the
        radix prefix cache, alias the matched pages into the row's block
        table (pinned), and plan chunks over the rest of the prompt; the
        device work runs in the unified ticks.

        A preempted request resumes through this path: its effective
        prompt is its full history, whose KV the preempt pinned into the
        tree; the match aliases those pages back, and the final chunk
        samples at the position the unpreempted step would have."""
        state = _Row(req)
        resumed = req.resume_history is not None
        if resumed:
            state.resumed = True
            state.history = list(req.resume_history)
            state.produced = req.resume_produced
        eff_prompt = state.history   # == req.prompt for a fresh admission
        self._row_adapter[row] = (slot if slot is not None
                                  else self._max_live)
        trace = req.trace
        if trace is not None:
            # the queue span (enqueue -> now) is the queue wait observed
            # below
            sp = trace.span("queue", t0=req.enqueue_t)
            trace.end(sp)
            if req.adapter is not None:
                trace.event("adapter_slot", adapter_id=req.adapter.adapter_id,
                            slot=int(self._row_adapter[row]))
        if self._prefix_cache is not None:
            # at most len - 1 tokens: the final chunk must feed one real
            # token to produce the first sample; pages hold K/V of one
            # adapter generation's weights, so the match stays in the
            # row's namespace
            nodes = self._prefix_cache.match(eff_prompt,
                                             limit=len(eff_prompt) - 1,
                                             namespace=self._prefix_ns(req))
            # a hibernated session covering more of the prompt than the
            # radix cache does imports its blob's pages first
            try:
                nodes = self._promote_session(state, req, eff_prompt, nodes)
            except BaseException:
                # the request left the queue but has no row yet: park it,
                # so that crash recovery's _fail_all answers its client
                self._rows[row] = state
                raise
            if nodes:
                self._prefix_cache.pin(nodes)
                state.prefix_nodes = nodes
                state.prefilled = len(nodes) * self._prefix_cache.page_size
                serve_metrics.PREFIX_HITS.inc()
            else:
                serve_metrics.PREFIX_MISSES.inc()
            if trace is not None:
                trace.event("prefix_match", matched_tokens=state.prefilled,
                            pages=len(nodes))
            # rebuilt on a miss too: no stale alias survives
            self._kv.with_row_prefix(row, [nd.page for nd in nodes])
        if resumed:
            # the row's own pins now hold the pages: drop the preempt's
            # hold and credit the tokens the resume did not recompute
            self._resume_cached_tokens += state.prefilled
            serve_metrics.RESUME_CACHED_TOKENS.inc(state.prefilled)
            self._release_resume(req)
            req.resume_history = None
            req.resume_produced = 0
            if trace is not None:
                sp = trace.span("resume", cached_tokens=state.prefilled,
                                produced=state.produced)
                trace.end(sp)
        if getattr(self._kv, "ssm", None) is not None:
            # a recycled row's recurrent state is its last occupant's: no
            # mask hides it, as one hides a K/V row's stale tail
            self._kv.ssm.reset_row(row)
        state.chunks = bucketing.chunk_plan(len(eff_prompt) - state.prefilled,
                                            _prefill_chunk())
        self._rows[row] = state
        # a quota bills the compute this admission runs (a matched prefix
        # costs nothing)
        qos.QUOTAS.charge(req.tenant, len(eff_prompt) - state.prefilled)
        self._class_admissions[req.priority] += 1
        serve_metrics.CLASS_ADMISSIONS.inc(priority=req.priority)
        self._lengths[row] = state.prefilled
        self._last_tok[row] = 0
        self._admissions += 1
        wait_ms = (time.monotonic() - req.enqueue_t) * 1000.0
        self._h_queue_wait.observe(wait_ms)
        self._h_queue_wait_cls[req.priority].observe(wait_ms)
        serve_metrics.QUEUE_WAIT_MS.observe(wait_ms)
        serve_metrics.QUEUE_WAIT_BY_CLASS.observe(wait_ms,
                                                  priority=req.priority)
        if trace is not None:
            state.sp_prefill = trace.span(
                "prefill", prompt_tokens=len(eff_prompt),
                cached_tokens=state.prefilled, chunks=len(state.chunks))

    def _promote_session(self, state: _Row, req: Request, eff_prompt,
                         nodes: list) -> list:
        """Wake a hibernated session for this admission (JAX
        ``_promote_session``), by content: a session hibernated on another
        replica, or before an engine reset, wakes here too.  When the
        radix cache already covers the session's depth the wake costs
        nothing (``tier="hbm"``); a host or disk blob is imported into
        freshly inserted radix slots and the chain walked again, which the
        caller pins and aliases like any radix hit; an unreadable blob is
        dropped by the store and the admission recomputes.  The
        ``tier.promote`` fault site fires before any mutation.  Returns
        the radix chain to alias."""
        if (req.adapter is not None or self._prefix_cache is None
                or not tierstore.TIERS.resident_sessions()):
            return nodes
        P = self._prefix_cache.page_size
        rec, depth = tierstore.TIERS.match(
            eff_prompt, model_id=self.model_id,
            model_stamp=self._ckpt_stamp_v, page_size=P,
            quantized=self._kv.quantized)
        if rec is None:
            return nodes
        if depth <= len(nodes):
            # the pages are still in this radix cache (hibernating here,
            # or demoted and not yet evicted)
            state.session_wake = True
            tierstore.TIERS.note_promotion("hbm", "ok")
            return nodes
        if rec.tier == "hbm":
            # hibernating on another replica whose demotion has not run:
            # its pages exist only in that engine's pool
            return nodes
        sid, tier = rec.session_id, rec.tier
        faults.check("tier.promote")
        blob = tierstore.TIERS.fetch(sid)
        if blob is None:
            return nodes
        created = self._prefix_cache.insert(eff_prompt, limit=depth * P)
        if created:
            self._kv.import_pages([page for _, page in created], blob,
                                  blob_offset=created[0][0])
        out = self._prefix_cache.chain(eff_prompt,
                                       limit=len(eff_prompt) - 1)
        state.session_wake = True
        self._session_promotions += 1
        tierstore.TIERS.note_promotion(
            tier, "ok" if len(out) >= depth else "partial")
        if req.trace is not None:
            req.trace.event("session_promote", session_id=sid, tier=tier,
                            imported_pages=len(created), depth_pages=depth)
        return out

    def _tick(self) -> bool:
        """One scheduler tick in the form the cache selects (JAX
        ``_tick``): the unified ragged block over the paged pool, else the
        phased tick — this boundary's prefill chunks, then one shared step
        or one fused superstep (``_plan_superstep`` decides), timed and
        logged into the tick timeline as a unit.  False when there was
        nothing to run."""
        if self._unified():
            return self._tick_unified()
        if self._next_prefill_row() is None and not self._decoding_rows():
            return False
        prefill_rows = sum(1 for r in self._rows
                           if r is not None and r.prefilling)
        chunks0 = self._prefill_chunks
        verify_rows = shared_rows = emitted = steps = 0
        t0 = time.monotonic()
        self._dispatch_t0 = t0
        try:
            with profiling.span("penroz/sched_tick"):
                self._prefill_tick()
                # finished prefills of a prefill replica hand off with the
                # lock released
                self._flush_outbox()
                if self._decoding_rows():
                    n = self._plan_superstep()
                    if n > 1:
                        shared_rows, emitted = self._superstep(n)
                        steps = n
                    else:
                        verify_rows, shared_rows, emitted = self._step()
                        steps = 1
        finally:
            self._dispatch_t0 = None
            self._watchdog_fired = False
        self._record_tick(t0, prefill_chunks=self._prefill_chunks - chunks0,
                          verify_rows=verify_rows, shared_rows=shared_rows,
                          emitted=emitted, superstep=steps, unified=False,
                          prefill_rows=prefill_rows, decode_rows=shared_rows,
                          pipe_ticks=0, pipe_bubbles=0)
        return True

    def _record_tick(self, t0: float, **entry):
        """One tick's wall time into the histograms, and its composition
        into the tick timeline."""
        dur_ms = (time.monotonic() - t0) * 1000.0
        self._h_tick.observe(dur_ms)
        serve_metrics.TICK_MS.observe(dur_ms)
        self._tick_timeline.append({
            "t": t0, "dispatch_ms": round(dur_ms, 3),
            "occupancy": round(self.active_rows / self.capacity, 4),
            **entry})

    def _unified(self) -> bool:
        """The unified ragged tick is the paged pool's; the contiguous
        cache, or ``PENROZ_RAGGED_ATTENTION=0``, keeps the phased one."""
        return isinstance(self._kv, KV.PagedKVState) and ragged_enabled()

    def _tick_unified(self) -> bool:
        """One unified tick: plan an n-step mixed block, run it as ONE
        ``decode_mixed_step`` round trip, replay the samples — or, in a
        pipeline group, plan micro-blocks and run them through the stage
        schedule (``_pipeline_dispatch``).  Host-only terminal conditions
        (deadline, cancel) are seen at the block boundary.  False when
        there was nothing to plan."""
        t0 = time.monotonic()
        self._dispatch_t0 = t0
        try:
            with profiling.span("penroz/sched_tick"):
                if self._pipe is not None and self._lora_pack is None:
                    plans = self._plan_mixed_blocks()
                    if not plans:
                        return False
                    comp = self._pipeline_dispatch(plans)
                    superstep = max(p["n"] for p in plans)
                else:
                    if self._pipe is not None and not self._pipe_lora_warned:
                        self._pipe_lora_warned = True
                        log.warning(
                            "pipeline serving suspended while LoRA "
                            "adapters are live: stage re-keying does not "
                            "thread the adapter pack")
                    plan = self._plan_mixed()
                    if plan is None:
                        return False
                    comp = self._mixed_dispatch(plan)
                    superstep = plan["n"]
        finally:
            self._dispatch_t0 = None
            self._watchdog_fired = False
        self._record_tick(t0, prefill_chunks=comp["prefill_chunks"],
                          verify_rows=comp["verify_rows"],
                          shared_rows=comp["decode_rows"],
                          emitted=comp["emitted"], superstep=superstep,
                          unified=True, prefill_rows=comp["prefill_rows"],
                          decode_rows=comp["decode_rows"],
                          pipe_ticks=comp.get("pipe_ticks", 0),
                          pipe_bubbles=comp.get("pipe_bubbles", 0))
        return True

    def _plan_mixed(self, rows=None):
        """Host-side plan of one unified block (JAX ``_plan_mixed``) over
        ``rows`` (``(index, _Row)`` pairs; every live row when None):
        simulate every row's next ``PENROZ_SCHED_SUPERSTEP`` steps — a
        prefilling row runs one chunk a step and parks at its final chunk
        (whose sample is its first token, shipped at this block's
        boundary), a drafted row runs one ``(len, K+1)`` verify span at
        step 0 and parks (only the host can plan its next draft), a
        decoding row runs one token a step until its budget or its row is
        spent — and pack each step's spans into descriptor arrays (the
        step count takes the pow-2 floor, the descriptor count the pow-2
        ceiling)."""
        if rows is None:
            rows = [(i, r) for i, r in enumerate(self._rows)
                    if r is not None and not r.transit]
        if not rows:
            return None
        block_q = RPA.default_block_q()
        n_max = max(1, _superstep_max())
        drafts = dict(self._plan_drafts(
            [i for i, state in rows if not state.prefilling]))
        sim = {i: {"mode": ("prefill" if state.prefilling
                            else "verify" if i in drafts else "decode"),
                   "len": int(self._lengths[i]), "chunk": state.chunk_idx,
                   "produced": state.produced}
               for i, state in rows}
        steps = []
        blocks_per_step = []
        for _ in range(n_max):
            spans, ops = [], []
            for i, state in rows:
                st = sim[i]
                if st["mode"] == "prefill":
                    size = state.chunks[st["chunk"]]
                    final = st["chunk"] + 1 >= len(state.chunks)
                    spans.append((i, st["len"], size))
                    ops.append(("chunk", i, state, st["len"], size, final,
                                len(spans) - 1))
                    st["len"] += size
                    st["chunk"] += 1
                    if final:
                        st["mode"] = "parked"
                        st["produced"] += 1
                elif st["mode"] == "verify":
                    draft = drafts[i]
                    spans.append((i, st["len"], len(draft) + 1))
                    ops.append(("verify", i, state, draft, len(spans) - 1))
                    st["mode"] = "parked"
                elif st["mode"] == "decode":
                    if (st["produced"] < state.req.max_new_tokens
                            and st["len"] < self.block_size):
                        spans.append((i, st["len"], 1))
                        ops.append(("decode", i, state, len(spans) - 1))
                        st["len"] += 1
                        st["produced"] += 1
            if not ops:
                break
            steps.append((spans, ops))
            blocks_per_step.append(
                sum(-(-q_len // block_q) for _, _, q_len in spans))
        if not steps:
            return None
        n = bucketing.clamp_pow2_floor(len(steps), hi=n_max)
        steps = steps[:n]
        NB = bucketing.bucket_count(max(blocks_per_step[:n]))
        Tp = NB * block_q
        descs = np.zeros((n, NB, 4), np.int32)
        tok_lit = np.zeros((n, Tp), np.int32)
        tok_src = np.full((n, Tp), -1, np.int32)
        positions = np.zeros((n, Tp), np.int32)
        sample_slot = np.full((n, self.capacity), -1, np.int32)
        row_ids = np.full((n, Tp), -1, np.int32)
        lora_slots = np.full((n, Tp), self._max_live, np.int32)
        verify = [[] for _ in range(n)]
        replay = []
        for s, (spans, ops) in enumerate(steps):
            d, offsets = KV.build_descriptors(spans, block_q, NB)
            descs[s] = d
            step_ops = []
            for op in ops:
                kind, i, state, span_idx = op[0], op[1], op[2], op[-1]
                q_start, q_len = spans[span_idx][1], spans[span_idx][2]
                slots = KV.packed_slots(offsets[span_idx], q_len, block_q)
                positions[s, slots] = q_start + np.arange(q_len)
                row_ids[s, slots] = i
                lora_slots[s, slots] = int(self._row_adapter[i])
                if kind == "chunk":
                    _, _, _, start, size, final, _ = op
                    tok_lit[s, slots] = state.history[start:start + size]
                    if final:
                        sample_slot[s, i] = slots[-1]
                    step_ops.append(("chunk", i, state, size,
                                     int(slots[-1]) if final else None))
                elif kind == "verify":
                    draft = op[3]
                    tok_lit[s, slots] = ([int(self._last_tok[i])]
                                         + [int(t) for t in draft])
                    verify[s] += [int(sl) for sl in slots]
                    step_ops.append(("verify", i, state, draft,
                                     [int(sl) for sl in slots]))
                else:
                    tok_src[s, slots[0]] = i
                    sample_slot[s, i] = slots[0]
                    step_ops.append(("decode", i, state, int(slots[0])))
            replay.append(step_ops)
        verify_slots = None
        V = max(len(v) for v in verify)
        if V:
            verify_slots = np.full((n, V), -1, np.int32)
            for s, v in enumerate(verify):
                verify_slots[s, :len(v)] = v
        return {"n": n, "descs": descs, "tok_lit": tok_lit,
                "tok_src": tok_src, "positions": positions,
                "sample_slot": sample_slot, "row_ids": row_ids,
                "lora_slots": lora_slots, "verify_slots": verify_slots,
                "replay": replay}

    def _mixed_dispatch(self, plan) -> dict:
        """Run the planned block as ONE ``decode_mixed_step`` and replay its
        (n, Tp) samples.  The fault sites fire first, as in the JAX
        package: ``decode.step`` on every block, ``decode.prefill_chunk``
        on a block with a chunk, ``decode.verify`` on one with a verify
        span."""
        self._check_block_faults([plan])
        if self._has_ssm:
            faults.check("ssm.scan")
        t0 = time.monotonic()
        self._forward_passes += plan["n"]
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_mixed"):
            arr, self._kv = self._model.decode_mixed_step(
                self._kv, plan["descs"], plan["tok_lit"], plan["tok_src"],
                plan["positions"], plan["sample_slot"], self._last_tok,
                seed=self._seed, temperature=self.temperature,
                top_k=self.top_k, row_ids=plan["row_ids"],
                verify_slots=plan["verify_slots"], lora=self._lora_pack,
                lora_slots=plan["lora_slots"])
        t1 = time.monotonic()
        with self._cond:    # the replay's mutations, as one to the ledger
            comp = self._replay_block(plan, arr, t0, t1)
        # the block's finished prefills hand off with the lock released:
        # placement takes the decode replicas' locks
        self._flush_outbox()
        return comp

    @staticmethod
    def _check_block_faults(plans):
        """The fault sites of a block's dispatch, before it: ``decode.step``
        always, ``decode.prefill_chunk`` with a chunk, ``decode.verify``
        with a verify span."""
        faults.check("decode.step")
        kinds = {op[0] for p in plans for ops in p["replay"] for op in ops}
        if "chunk" in kinds:
            faults.check("decode.prefill_chunk")
        if "verify" in kinds:
            faults.check("decode.verify")

    def _replay_block(self, plan, arr, t0, t1) -> dict:
        """Replay the block's samples step-major through the per-token
        retirement path; rows retired mid-block (stop token, budget) are
        skipped for the rest of it.  A verify span emits its accepted
        draft tokens and the model's token after them, stopping at a
        retirement.  Host lengths stay authoritative: a verify row's length
        moves past the accepted run only, so its rejected positions are
        never attended and the next span overwrites them."""
        n, replay = plan["n"], plan["replay"]
        rows_of = lambda kind: {op[1] for ops in replay for op in ops  # noqa: E731
                                if op[0] == kind}
        prefill_rows, decode_rows = rows_of("chunk"), rows_of("decode")
        verify_rows = rows_of("verify")
        for i in decode_rows | verify_rows:
            state = self._rows[i]
            if state is not None and state.req.trace is not None:
                sp = state.req.trace.span("decode_step", t0=t0,
                                          parent=state.sp_decode,
                                          superstep=n)
                state.req.trace.end(sp, t1=t1)
        emitted = 0         # decode-path tokens
        emitted_total = 0   # every token out of this dispatch
        chunks_run = 0
        steps_decode = 0
        for s, ops in enumerate(replay):
            if any(op[0] in ("decode", "verify") for op in ops):
                steps_decode += 1
            for op in ops:
                kind, i, state = op[0], op[1], op[2]
                if self._rows[i] is not state:
                    continue    # retired mid-block
                if kind == "chunk":
                    size, final_slot = op[3], op[4]
                    req = state.req
                    if req.cancelled:
                        self._retire(i, notify=False, reason="cancelled")
                        continue
                    if req.expired():
                        self._timeout_row(i, state, "during prefill")
                        continue
                    if req.trace is not None:
                        sp = req.trace.span(
                            "prefill_chunk", t0=t0, parent=state.sp_prefill,
                            size=size, start=state.prefilled)
                        req.trace.end(sp, t1=t1)
                    state.prefilled += size
                    state.chunk_idx += 1
                    self._prefill_chunks += 1
                    serve_metrics.PREFILL_CHUNKS.inc()
                    self._lengths[i] = state.prefilled
                    chunks_run += 1
                    if final_slot is not None:
                        emitted_total += 1
                        self._finish_prefill(i, state,
                                             int(arr[s, final_slot]))
                elif kind == "decode":
                    slot = op[3]
                    self._lengths[i] += 1
                    tok = int(arr[s, slot])
                    self._last_tok[i] = tok
                    emitted += 1
                    emitted_total += 1
                    self._emit_token(i, state, tok)
                else:   # verify
                    draft, slots = op[3], op[4]
                    out = [int(arr[s, sl]) for sl in slots]
                    accepted = spec_decode.accept_length(draft, out)
                    self._spec_verify_steps += 1
                    self._spec_drafted_tokens += len(draft)
                    self._spec_accepted_tokens += accepted
                    serve_metrics.SPEC_DRAFTED.inc(len(draft))
                    serve_metrics.SPEC_ACCEPTED.inc(accepted)
                    self._lengths[i] += accepted + 1
                    for tok in out[:accepted + 1]:
                        self._last_tok[i] = tok
                        emitted += 1
                        emitted_total += 1
                        self._emit_token(i, state, tok)
                        if self._rows[i] is not state:
                            break
        self._account_decode(t0, steps_decode, len(decode_rows | verify_rows),
                             emitted)
        if chunks_run and steps_decode:
            # the chunks rode the decode dispatch: the decode batch stalled
            # 0 ms for them
            self._h_chunk_stall.observe(0.0)
            serve_metrics.CHUNK_STALL_MS.observe(0.0)
        self._record_dispatch(emitted_total)
        return {"prefill_chunks": chunks_run,
                "prefill_rows": len(prefill_rows),
                "decode_rows": len(decode_rows),
                "verify_rows": len(verify_rows),
                "emitted": emitted_total}

    def _record_dispatch(self, emitted: int):
        """One decode-path device round trip (a unified block, a shared
        step, a verify span or a fused superstep) and its tokens."""
        self._dispatches += 1
        self._h_tokens_per_dispatch.observe(float(emitted))
        serve_metrics.DISPATCHES.inc()
        serve_metrics.TOKENS_PER_DISPATCH.observe(float(emitted))

    # -- pipeline-parallel serving (PENROZ_SERVE_PIPE_STAGES) ---------------

    def _plan_mixed_blocks(self) -> list:
        """The live rows dealt round robin into ``PENROZ_SERVE_PIPE_BLOCKS``
        micro-blocks (at most one a row), each planned as a mixed block;
        fewer live rows than stages leave bubbles the counters report."""
        rows = [(i, r) for i, r in enumerate(self._rows)
                if r is not None and not r.transit]
        if not rows:
            return []
        m = min(_pipe_blocks(self._pipe.stages), len(rows))
        plans = [self._plan_mixed(rows[b::m]) for b in range(m)]
        return [p for p in plans if p is not None]

    def _pipeline_dispatch(self, plans: list) -> dict:
        """Run the micro-blocks through the stage schedule (JAX
        ``_pipeline_dispatch``) and replay each through the retirement
        path.  The unit of work is (block, step, stage): one
        ``decode_pipe_stage`` over the block's step against the stage's
        view of the pools.  A block's step needs its previous step's
        samples at stage 0, so a block sits in one stage at a time; a
        pipeline tick walks the stages last to first and moves at most one
        block a stage, so S blocks keep S stages busy.  ``bubbles`` counts
        the idle stage-ticks (fill, drain, too few blocks): the bubble
        fraction is bubbles / (ticks x S).  The ``pipe.handoff`` fault
        bounces a hand-off's activations through the host (same values;
        ``pipe_handoff_host_fallbacks``); ``pipe.stage_crash`` fails the
        tick, whose recovery rebuilds the whole group's cache."""
        self._check_block_faults(plans)
        pipe = self._pipe
        S = pipe.stages
        t0 = time.monotonic()
        last_local = self._last_tok.copy()
        blocks = [{"plan": p, "step": 0, "stage": 0, "h": None,
                   "arr": np.full(p["tok_lit"].shape, -1, np.int64)}
                  for p in plans]
        live = set(range(len(blocks)))
        ticks = bubbles = 0
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_pipeline"):
            while live:
                ran = 0
                for s in reversed(range(S)):
                    b = next((b for b in sorted(live)
                              if blocks[b]["stage"] == s), None)
                    if b is None:
                        continue
                    st = blocks[b]
                    plan, i = st["plan"], st["step"]
                    faults.check("pipe.stage_crash")
                    if s == 0:
                        src = plan["tok_src"][i]
                        x = np.where(src >= 0,
                                     last_local[np.clip(src, 0, None)],
                                     plan["tok_lit"][i])
                    else:
                        x = st["h"]
                    slots = plan["sample_slot"][i]
                    if plan["verify_slots"] is not None:
                        slots = np.concatenate([slots,
                                                plan["verify_slots"][i]])
                    lo, hi = pipe.kv_bounds[s]
                    out, view = self._model.decode_pipe_stage(
                        pipe, s, KV.stage_kv_view(self._kv, lo, hi), x,
                        plan["descs"][i], plan["positions"][i],
                        plan["row_ids"][i], seed=self._seed,
                        temperature=self.temperature, top_k=self.top_k,
                        slots=slots[slots >= 0])
                    self._kv = KV.merge_stage_kv(self._kv, lo, hi, view)
                    ran += 1
                    self._pipe_stage_busy[s] += 1
                    if s < S - 1:
                        self._pipe_handoffs += 1
                        try:
                            faults.check("pipe.handoff")
                        except faults.InjectedFault:
                            # a fault mid-transfer: the activations go
                            # through the host instead, the same values
                            out = torch.from_numpy(out.cpu().numpy()).to(
                                out.device)
                            self._pipe_handoff_host_fallbacks += 1
                        st["h"] = out
                        st["stage"] = s + 1
                        continue
                    st["arr"][i] = out
                    sslot = plan["sample_slot"][i]
                    upd = np.nonzero(sslot >= 0)[0]
                    last_local[upd] = out[sslot[upd]]
                    st["h"] = None
                    st["step"] += 1
                    st["stage"] = 0
                    if st["step"] >= plan["n"]:
                        live.discard(b)
                ticks += 1
                bubbles += S - ran
        t1 = time.monotonic()
        self._pipe_ticks += ticks
        self._pipe_bubble_ticks += bubbles
        self._forward_passes += sum(p["n"] for p in plans)
        comp = dict.fromkeys(("prefill_chunks", "prefill_rows",
                              "decode_rows", "verify_rows", "emitted"), 0)
        with self._cond:
            for st in blocks:
                part = self._replay_block(st["plan"], st["arr"], t0, t1)
                for k in comp:
                    comp[k] += part[k]
        self._flush_outbox()
        comp["pipe_ticks"] = ticks
        comp["pipe_bubbles"] = bubbles
        return comp

    # -- the phased ticks (the contiguous cache, PENROZ_RAGGED_ATTENTION=0) -

    def _next_prefill_row(self):
        """The prefilling row enqueued first (FIFO over rows, so a long
        early prompt is not starved by later arrivals), or None."""
        best = None
        for i, r in enumerate(self._rows):
            if r is None or not r.prefilling or r.transit:
                continue
            if best is None or (r.req.enqueue_t
                                < self._rows[best].req.enqueue_t):
                best = i
        return best

    def _decoding_rows(self) -> list[int]:
        """Rows past their prefill: the shared step's real participants
        (prefilling, free and transit rows ride along parked)."""
        return [i for i, r in enumerate(self._rows)
                if r is not None and not r.prefilling and not r.transit]

    def _prefill_tick(self):
        """This step boundary's prefill chunks: one while rows decode (the
        stall bound), more while under ``PENROZ_SCHED_MAX_STALL_MS``; one
        a loop with an idle decode batch, so admission stays responsive.
        The decode batch's stall is observed."""
        if self._next_prefill_row() is None:
            return
        budget_ms = _max_stall_ms()
        stalling = bool(self._decoding_rows())
        t0 = time.monotonic()
        while True:
            row = self._next_prefill_row()
            if row is None:
                break
            self._run_prefill_chunk(row)
            if not stalling:
                break
            self._chunks_between_steps += 1
            if (time.monotonic() - t0) * 1000.0 >= budget_ms:
                break
        if stalling:
            stall_ms = (time.monotonic() - t0) * 1000.0
            self._h_chunk_stall.observe(stall_ms)
            serve_metrics.CHUNK_STALL_MS.observe(stall_ms)

    def _run_prefill_chunk(self, row: int):
        """One chunk of row ``row``'s prompt through its view of the cache
        (``decode_prefill_chunk``); the last chunk's sample is the
        request's next token."""
        state = self._rows[row]
        req = state.req
        with self._cond:
            if req.cancelled:
                self._retire(row, notify=False, reason="cancelled")
                return
            if req.expired():
                self._timeout_row(row, state, "during prefill")
                return
        faults.check("decode.prefill_chunk")
        size = state.chunks[state.chunk_idx]
        start = state.prefilled
        sp = (req.trace.span("prefill_chunk", parent=state.sp_prefill,
                             size=size, start=start)
              if req.trace is not None else None)
        # the history is the effective prompt for the whole PREFILLING
        # phase (tokens append only after it)
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_prefill_chunk"):
            tok, self._kv = self._model.decode_prefill_chunk(
                self._kv, row, state.history[start:start + size], start,
                seed=self._seed, temperature=self.temperature,
                top_k=self.top_k, lora=self._lora_pack,
                adapter_slot=int(self._row_adapter[row]))
        self._forward_passes += 1
        with self._cond:
            if req.trace is not None:
                req.trace.end(sp)
            state.prefilled += size
            state.chunk_idx += 1
            self._prefill_chunks += 1
            serve_metrics.PREFILL_CHUNKS.inc()
            # the row parks its shared-step writes at its next position
            self._lengths[row] = state.prefilled
            if state.chunk_idx >= len(state.chunks):
                self._finish_prefill(row, state, tok)

    def _step(self):
        """One phased decode step: a verify span for every row with a
        draft, then one shared step for the rest (which the verified rows
        ride parked: their write lands at their next position, always
        overwritten).  One decode step either way.  Returns
        ``(verify_rows, shared_rows, emitted)``."""
        faults.check("decode.step")
        t0 = time.monotonic()
        self._max_chunks_between_steps = max(
            self._max_chunks_between_steps, self._chunks_between_steps)
        self._chunks_between_steps = 0
        active = self._decoding_rows()
        emitted = 0
        plan = self._plan_drafts(active)
        for row, draft in plan:
            emitted += self._verify_row(row, draft)
        drafted = {row for row, _ in plan}
        normal = [i for i in self._decoding_rows() if i not in drafted]
        if normal:
            emitted += self._shared_step(normal)
        self._account_decode(t0, 1, len(active), emitted)
        return len(plan), len(normal), emitted

    def _account_decode(self, t0: float, steps: int, rows: int,
                        emitted: int):
        """Decode steps, tokens, time and occupancy of one dispatch since
        ``t0``, and the recent-rate window."""
        now = time.monotonic()
        self._decode_steps += steps
        self._decode_tokens += emitted
        serve_metrics.DECODE_TOKENS.inc(emitted)
        self._decode_time_s += now - t0
        self._occupancy_sum += steps * rows / self.capacity
        self._token_window.append((now, emitted))
        while (self._token_window
               and now - self._token_window[0][0] > _TPS_WINDOW_S):
            self._token_window.popleft()

    def _shared_step(self, rows: list[int]) -> int:
        """One batched decode+sample step over every row
        (``decode_step_batched``), emitting for ``rows``; returns the
        tokens emitted.  The other rows ride parked: a recurrent state
        takes only ``rows``' tokens."""
        if self._has_ssm:
            faults.check("ssm.scan")
        active = np.zeros(self.capacity, bool)
        active[rows] = True
        t0 = time.monotonic()
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_step"):
            arr, self._kv = self._model.decode_step_batched(
                self._kv, self._last_tok, self._lengths, seed=self._seed,
                temperature=self.temperature, top_k=self.top_k,
                lora=self._lora_pack, row_adapter=self._row_adapter,
                active=active)
        self._forward_passes += 1
        t1 = time.monotonic()
        emitted = 0
        with self._cond:
            for i in rows:
                state = self._rows[i]
                if state.req.trace is not None:
                    sp = state.req.trace.span("decode_step", t0=t0,
                                              parent=state.sp_decode)
                    state.req.trace.end(sp, t1=t1)
                self._lengths[i] += 1
                tok = int(arr[i])
                self._last_tok[i] = tok
                emitted += 1
                self._emit_token(i, state, tok)
        self._record_dispatch(emitted)
        return emitted

    def _plan_superstep(self) -> int:
        """Fused steps for this tick: more than 1 only when the host has
        nothing to do at the boundaries it would skip — no prefilling
        row, no queued request, no speculative draft — clamped to the
        largest need of a row (its budget, its room) and floored to a
        power of two (at most ``PENROZ_SCHED_SUPERSTEP``).  Deadlines and
        cancellations are seen at the superstep's boundary."""
        n = _superstep_max()
        if n <= 1 or self._next_prefill_row() is not None:
            return 1
        with self._cond:
            if self._pending:
                return 1
        rows = self._decoding_rows()
        if self._spec_on() and self._plan_drafts(rows):
            return 1
        need = 1
        for i in rows:
            state = self._rows[i]
            need = max(need, min(state.req.max_new_tokens - state.produced,
                                 self.block_size - int(self._lengths[i])))
        return bucketing.clamp_pow2_floor(need, hi=n)

    def _superstep(self, n: int) -> tuple[int, int]:
        """One fused n-step dispatch (``decode_superstep``) replayed step
        major through the per-token retirement path: the host retires each
        row on the token the device's mask stopped at (both run the same
        rule on the same inputs).  n decode steps, one dispatch.  Returns
        ``(rows, tokens emitted)``."""
        faults.check("decode.step")
        if self._has_ssm:
            faults.check("ssm.scan")
        t0 = time.monotonic()
        self._max_chunks_between_steps = max(
            self._max_chunks_between_steps, self._chunks_between_steps)
        self._chunks_between_steps = 0
        rows = self._decoding_rows()
        states = {i: self._rows[i] for i in rows}
        active = np.zeros(self.capacity, bool)
        stop = np.full(self.capacity, -1, np.int64)
        remaining = np.zeros(self.capacity, np.int64)
        for i in rows:
            req = states[i].req
            active[i] = True
            stop[i] = -1 if req.stop_token is None else int(req.stop_token)
            remaining[i] = req.max_new_tokens - states[i].produced
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_superstep"):
            toks, emit, lens, self._kv = self._model.decode_superstep(
                self._kv, self._last_tok, self._lengths, active, stop,
                remaining, self._seed, n, temperature=self.temperature,
                top_k=self.top_k, lora=self._lora_pack,
                row_adapter=self._row_adapter)
        self._forward_passes += n
        t1 = time.monotonic()
        emitted = 0
        with self._cond:
            for i in rows:
                state = states[i]
                if state.req.trace is not None:
                    sp = state.req.trace.span("decode_step", t0=t0,
                                              parent=state.sp_decode,
                                              superstep=n)
                    state.req.trace.end(sp, t1=t1)
            for s in range(n):
                for i in rows:
                    # a row retired earlier in the replay (or its slot
                    # reused) is skipped for the rest of the block
                    if not emit[s, i] or self._rows[i] is not states[i]:
                        continue
                    self._lengths[i] += 1
                    tok = int(toks[s, i])
                    self._last_tok[i] = tok
                    emitted += 1
                    self._emit_token(i, states[i], tok)
            for i in rows:
                if self._rows[i] is states[i] and int(
                        self._lengths[i]) != int(lens[i]):
                    raise RuntimeError(
                        f"superstep length drift on row {i}: host "
                        f"{int(self._lengths[i])} != device {int(lens[i])}")
        self._account_decode(t0, n, len(rows), emitted)
        self._record_dispatch(emitted)
        return len(rows), emitted

    def _verify_row(self, row: int, draft: list[int]) -> int:
        """One verify span of row ``row`` (``decode_verify_row``: the last
        token and the draft, sampled at every position): emit the longest
        matching prefix of the draft and the model's token after it, and
        roll the row back past the rejected positions.  Returns the tokens
        emitted (at least 1)."""
        faults.check("decode.verify")
        state = self._rows[row]
        start = int(self._lengths[row])
        tokens = [int(self._last_tok[row])] + [int(t) for t in draft]
        sp = (state.req.trace.span("verify", parent=state.sp_decode,
                                   drafted=len(draft))
              if state.req.trace is not None else None)
        with model_mod.decode_priority(), \
                profiling.span("penroz/sched_verify"):
            out, self._kv = self._model.decode_verify_row(
                self._kv, row, tokens, start, seed=self._seed,
                temperature=self.temperature, top_k=self.top_k,
                lora=self._lora_pack,
                adapter_slot=int(self._row_adapter[row]))
        self._forward_passes += 1
        accepted = spec_decode.accept_length(draft, out)
        emitted = 0
        with self._cond:
            if state.req.trace is not None:
                state.req.trace.end(sp, accepted=accepted,
                                    rollback_to=start + accepted + 1)
            self._spec_verify_steps += 1
            self._spec_drafted_tokens += len(draft)
            self._spec_accepted_tokens += accepted
            serve_metrics.SPEC_DRAFTED.inc(len(draft))
            serve_metrics.SPEC_ACCEPTED.inc(accepted)
            # K+1 positions were written; only the first accepted + 1 fed
            # what greedy decoding feeds (the model's own token's K/V is
            # written by the next step that feeds it)
            new_len = start + accepted + 1
            self._kv.rollback_row(row, new_len)
            self._lengths[row] = new_len
            for tok in out[:accepted + 1]:
                self._last_tok[row] = tok
                emitted += 1
                self._emit_token(row, state, tok)
                if self._rows[row] is not state:
                    break   # retired mid-acceptance, as a plain step stops
        self._record_dispatch(emitted)
        return emitted

    def _finish_prefill(self, row: int, state: _Row, first: int):
        """Final chunk done: its sample is the request's next token (its
        first, or a resumed request's next).

        On a disaggregated prefill replica this is the hand-off seam: the
        row goes to the outbox, which ships its pages to a decode replica
        once the replay releases the lock; the first token travels inside
        the hand-off and is emitted after the import, once.  Rows that
        cannot hand off (one new token, a resumed row, a cancelled one)
        join this engine's decode batch."""
        req = state.req
        if (self.role == "prefill" and self._handoff_sink is not None
                and req.handoff is None and req.max_new_tokens > 1
                and not state.resumed and not req.cancelled
                and isinstance(self._kv, KV.PagedKVState)):
            self._outbox.append((row, state, first))
            return
        self._finish_prefill_local(row, state, first)

    def _finish_prefill_local(self, row: int, state: _Row, first: int):
        """Emit the first token and join the decode batch on THIS engine
        (JAX ``_finish_prefill_local``); also the last resort of a hand-off
        that cannot leave it.  Callers hold _cond."""
        state.prefilling = False
        self._lengths[row] = state.prefilled  # == len(effective prompt)
        self._last_tok[row] = first
        req = state.req
        ttft_ms = (time.monotonic() - req.enqueue_t) * 1000.0
        if not state.resumed:
            # a resumed row's first token shipped before the preempt
            self._h_ttft.observe(ttft_ms)
            self._h_ttft_cls[req.priority].observe(ttft_ms)
            serve_metrics.TTFT_MS.observe(ttft_ms)
            serve_metrics.TTFT_BY_CLASS.observe(ttft_ms,
                                                priority=req.priority)
            if state.session_wake:
                # a woken session's TTFT also goes to its own histogram:
                # warm against cold reads straight off /metrics
                self._h_resume_ttft.observe(ttft_ms)
                serve_metrics.SESSION_RESUME_TTFT_MS.observe(ttft_ms)
        if req.trace is not None:
            req.trace.end(state.sp_prefill)
            state.sp_prefill = None
            state.sp_decode = req.trace.span("decode",
                                             ttft_ms=round(ttft_ms, 3))
        self._register_prefix(row, state)
        self._emit_token(row, state, first)

    def _register_prefix(self, row: int, state: _Row):
        """Copy the finished prompt's new full pages into the cache's tail
        and hang them on the radix tree (JAX ``_register_prefix``); the
        aliased blocks already live there, so only the blocks this row
        prefilled are copied."""
        if self._prefix_cache is None:
            return
        created = self._prefix_cache.insert(
            state.req.prompt, namespace=self._prefix_ns(state.req))
        if created:
            S = self._kv.pages_per_seq
            self._kv.copy_pages([row * S + b for b, _ in created],
                                [page for _, page in created])

    def _release_prefix(self, row: int, state):
        """Unpin the row's aliased radix pages and restore its static
        table: the slot's next occupant must not write through the shared
        entries."""
        if state is None or not state.prefix_nodes:
            return
        self._prefix_cache.unpin(state.prefix_nodes)
        state.prefix_nodes = []
        self._kv.restore_row_table(row)

    # -- disaggregated prefill (export / hand-off / import) -----------------

    def _audit(self, where: str):
        if memledger.strict():
            self._ledger.audit(where)

    def _flush_outbox(self):
        """Hand off the block's finished prefills (worker thread, _cond NOT
        held: placement takes the decode replicas' locks); a row that
        cannot leave joins this engine's decode batch."""
        while self._outbox:
            row, state, first = self._outbox.pop(0)
            if self._rows[row] is not state:
                continue
            if not self._export_handoff(row, state, first):
                with self._cond:
                    self._finish_prefill_local(row, state, first)

    def _free_handoff_row(self, row: int, state: _Row):
        """Release a row whose request left through the hand-off seam (an
        acked or host-staged export, a monolithic requeue): no terminal
        event, the stream finishes on the other replica.  Callers hold
        _cond."""
        self._rows[row] = None
        self._lengths[row] = 0
        self._last_tok[row] = 0
        self._row_adapter[row] = self._max_live
        self._release_prefix(row, state)
        self._kv.reset_row(row)

    def _end_prefill_span(self, state: _Row):
        if state.req.trace is not None:
            state.req.trace.end(state.sp_prefill)
            state.sp_prefill = None

    def _export_failed(self, transport: str, what: str, exc: Exception):
        self._disagg_handoff_failures += 1
        serve_metrics.DISAGG_HANDOFFS.inc(outcome="export_failed",
                                          transport=transport)
        log.warning("engine %s[%d]: hand-off %s failed (%s)", self.model_id,
                    self.replica, what, exc)

    def _export_handoff(self, row: int, state: _Row, first: int) -> bool:
        """Prefill replica: ship the finished row's KV pages to a decode
        replica through ``_handoff_sink`` — device planes over the d2d
        transport by default, the host page blob otherwise and whenever
        d2d fails.  True when the row left this engine (shipped, parked
        awaiting the ack, or requeued monolithic); False: the caller
        decodes it here.  The fault site and the export work come before
        any mutation, so a failure leaves the row intact."""
        t0 = time.monotonic()
        try:
            # disagg.handoff's first ordinal: a crash mid-export
            faults.check("disagg.handoff")
        except Exception as e:  # noqa: BLE001 — fall back, greedy-identical
            self._export_failed(_disagg_transport(), "export", e)
            return self._requeue_monolithic(row, state)
        if _disagg_transport() == "d2d":
            if self._export_handoff_d2d(row, state, first, t0):
                return True
            # nothing shipped: the same hand-off re-stages host-side
        return self._export_handoff_host(row, state, first, t0)

    def _export_handoff_host(self, row: int, state: _Row, first: int,
                             t0: float) -> bool:
        """The host transport: stage the row's pages as a CRC page blob in
        shm and hand its id to a decode replica; the row frees once the
        sink accepts (the staged blob is the copy, nothing to ack)."""
        req = state.req
        blob_id = (f"{self.model_id}-{self.replica}-{id(req):x}"
                   f"-{self._dispatches}")
        try:
            if self._has_ssm:
                # a crash mid-export with a recurrent plane in the blob
                faults.check("ssm.handoff")
            kv_len = int(state.prefilled)
            blob = self._kv.export_row_pages(row, kv_len)
            blob["first_token"] = int(first)
            checkpoint.save_page_blob(blob_id, blob)
        except Exception as e:  # noqa: BLE001
            checkpoint.delete_page_blob(blob_id)
            req.handoff = None
            self._export_failed("host", "export", e)
            return self._requeue_monolithic(row, state)
        with self._cond:
            # the prompt's pages feed THIS replica's radix tree too, so a
            # repeat prefills warm here wherever it decodes
            self._register_prefix(row, state)
        req.handoff = {"transport": "host", "blob_id": blob_id,
                       "kv_len": kv_len, "first_token": int(first), "t0": t0}
        if not self._ship(state, "host"):
            checkpoint.delete_page_blob(blob_id)
            return False
        serve_metrics.DISAGG_HANDOFF_BYTES.observe(
            checkpoint.page_blob_nbytes(blob))
        if req.trace is not None:
            req.trace.event("handoff_export", blob_id=blob_id,
                            kv_len=kv_len, replica=self.replica,
                            transport="host")
        with self._cond:
            self._free_handoff_row(row, state)
            self._audit("disagg.export")
        return True

    def _export_handoff_d2d(self, row: int, state: _Row, first: int,
                            t0: float) -> bool:
        """The d2d transport: gather the row's page planes on the device
        and hand them to the importer in process (no host copy, no CRC).
        The row does NOT free: it parks under the ledger's ``transit``
        state until the importer acks (free-after-ack), so a refused
        import re-sends the same pages host-side.  False, the row intact,
        when the transport fails before the sink accepts."""
        req = state.req
        try:
            # disagg.d2d's exporter-side ordinal (the importer has the
            # other)
            faults.check("disagg.d2d")
            if self._has_ssm:
                faults.check("ssm.handoff")
            kv_len = int(state.prefilled)
            blob = self._kv.export_row_pages(row, kv_len, device=True)
            blob["first_token"] = int(first)
        except Exception as e:  # noqa: BLE001 — re-stage host-side
            self._export_failed("d2d", "d2d export", e)
            return False
        with self._cond:
            self._register_prefix(row, state)
        req.handoff = {"transport": "d2d", "planes": blob, "kv_len": kv_len,
                       "first_token": int(first), "t0": t0,
                       "ack": self._make_ack(row, state)}
        if not self._ship(state, "d2d"):
            return False
        serve_metrics.DISAGG_HANDOFF_BYTES.observe(
            checkpoint.page_blob_nbytes(blob))
        if req.trace is not None:
            req.trace.event("handoff_export", kv_len=kv_len,
                            replica=self.replica, transport="d2d")
        with self._cond:
            state.transit = True
            self._transit_rows[row] = {"state": state, "first": int(first),
                                       "t0": t0, "t": time.monotonic()}
        return True

    def _ship(self, state: _Row, transport: str) -> bool:
        """Offer the request to the sink (router placement on a decode
        replica); on a refusal its hand-off is withdrawn and counted."""
        req = state.req
        try:
            self._handoff_sink(req)
        except Exception as e:  # noqa: BLE001 — every decode replica refused
            req.handoff = None
            self._export_failed(transport, "placement", e)
            return False
        self._disagg_exports += 1
        self._end_prefill_span(state)
        return True

    def _make_ack(self, row: int, state: _Row):
        """The importer's verdict on a d2d hand-off: recorded for this
        (exporting) engine's worker, which frees the parked row (ok) or
        re-sends it host-side (refused) at its next loop boundary.  Called
        by the importer with no lock of its own held."""
        def ack(ok: bool):
            with self._cond:
                self._acks.append((row, state, bool(ok)))
                self._cond.notify_all()
        return ack

    def _send_acks(self):
        """Deliver the acks this importer's admission produced, its own
        lock released."""
        while self._ack_out:
            ack, ok = self._ack_out.pop(0)
            ack(ok)

    def _ack_overdue(self) -> bool:
        deadline = _ack_timeout_s()
        now = time.monotonic()
        return any(now - e["t"] > deadline
                   for e in self._transit_rows.values())

    def _drain_acks(self):
        """Exporter side of free-after-ack, at loop boundaries: an acked row
        frees; a refused one re-sends the same hand-off through the host
        blob from its intact pages (nothing was emitted); an overdue one
        frees without touching the stream, which the importer owns."""
        if not self._transit_rows and not self._acks:
            return
        with self._cond:
            acks, self._acks = self._acks, []
        for row, state, ok in acks:
            entry = self._transit_rows.get(row)
            if (entry is None or entry["state"] is not state
                    or self._rows[row] is not state):
                continue
            with self._cond:
                del self._transit_rows[row]
                state.transit = False
                if ok:
                    self._free_handoff_row(row, state)
                    self._audit("disagg.export")
                    continue
            # the importer counted the failure; re-send from the source
            log.warning("engine %s[%d]: d2d import refused for row %d; "
                        "re-staging through the host blob codec",
                        self.model_id, self.replica, row)
            if not self._export_handoff_host(row, state, entry["first"],
                                             entry["t0"]):
                with self._cond:
                    self._finish_prefill_local(row, state, entry["first"])
        deadline = _ack_timeout_s()
        now = time.monotonic()
        for row in [r for r, e in self._transit_rows.items()
                    if now - e["t"] > deadline]:
            state = self._transit_rows[row]["state"]
            with self._cond:
                del self._transit_rows[row]
                state.transit = False
                if self._rows[row] is not state:
                    continue
                self._disagg_handoff_failures += 1
                serve_metrics.DISAGG_HANDOFFS.inc(outcome="ack_timeout",
                                                  transport="d2d")
                log.warning("engine %s[%d]: d2d hand-off ack overdue for "
                            "row %d; releasing the parked source pages",
                            self.model_id, self.replica, row)
                self._free_handoff_row(row, state)
                self._audit("disagg.export")

    def request_role(self, role: str):
        """Ask the worker to flip this replica's role at its next drain
        boundary (elastic rebalancing, serve/router.py).  The flip waits
        for the parked d2d exports' acks; queued and in-flight requests
        are untouched, only where later finished prefills go changes."""
        if role not in ("prefill", "decode"):
            raise ValueError(f"unknown disaggregation role {role!r}")
        with self._cond:
            if role == self.role:
                self._requested_role = None
                return
            self._requested_role = role
            self._cond.notify_all()

    def _maybe_flip_role(self):
        """Apply a pending role flip at a drain boundary: every parked
        export acked first, and the ``disagg.rebalance`` fault site before
        the mutation, so an injected crash leaves the roles consistent and
        the flip retries at the next boundary."""
        target = self._requested_role
        if target is None:
            return
        if target == self.role:
            with self._cond:
                self._requested_role = None
            return
        if self._transit_rows:
            return
        faults.check("disagg.rebalance")
        with self._cond:
            self.role = target
            self._requested_role = None
        self._disagg_role_changes += 1
        serve_metrics.DISAGG_ROLE_CHANGES.inc()
        self._audit("disagg.rebalance")
        log.info("engine %s[%d]: role -> %s (elastic rebalance)",
                 self.model_id, self.replica, target)

    def _requeue_monolithic(self, row: int, state: _Row) -> bool:
        """The export failed before anything shipped: push the request back
        through the router, so a decode replica prefills it from scratch
        (greedy-identical, nothing was emitted).  False keeps it here."""
        sink = self._handoff_sink
        req = state.req
        req.handoff = None
        if sink is None:
            return False
        try:
            sink(req)
        except Exception:  # noqa: BLE001 — no decode replica: decode here
            return False
        self._end_prefill_span(state)
        if req.trace is not None:
            req.trace.event("handoff_fallback", replica=self.replica)
        with self._cond:
            self._free_handoff_row(row, state)
            self._audit("disagg.fallback")
        return True

    def _discard_handoff(self, req: Request):
        """A hand-off that will never be imported (its request dropped or
        failed while queued): reclaim its blob, or release the exporter's
        parked pages."""
        h, req.handoff = req.handoff, None
        if h is None:
            return
        if h["transport"] == "host":
            checkpoint.delete_page_blob(h["blob_id"])
        elif h.get("ack") is not None:
            self._ack_out.append((h["ack"], True))

    def _abandon_import_row(self, row: int):
        """Return a half-imported hand-off row to the pool (nothing was
        emitted)."""
        self._rows[row] = None
        self._lengths[row] = 0
        self._last_tok[row] = 0
        self._row_adapter[row] = self._max_live
        self._kv.reset_row(row)

    def _import_failed(self, row: int, req: Request, transport: str,
                       exc: Exception, then: str):
        self._disagg_handoff_failures += 1
        serve_metrics.DISAGG_HANDOFFS.inc(outcome="import_failed",
                                          transport=transport)
        self._abandon_import_row(row)
        if req.trace is not None:
            req.trace.event("handoff_import_failed", reason=str(exc),
                            replica=self.replica, transport=transport)
        self._audit("disagg.import_failed")
        log.warning("engine %s[%d]: hand-off import failed (%s); %s",
                    self.model_id, self.replica, exc, then)

    def _admit_handoff(self, row: int, req: Request, slot: int | None):
        """Decode replica: admit a hand-off arrival straight into the
        decode phase — import its pages into the row, emit the first token
        the prefill replica sampled, join the decode batch.  A d2d
        transport failure refuses the hand-off back to the exporter (which
        re-sends host-side); any other failure re-prefills monolithically
        here (nothing was emitted yet).  While the import runs the row is
        ``transit`` to the ledger.  Callers hold _cond."""
        h, req.handoff = req.handoff, None
        transport = h.get("transport", "host")
        ack = h.get("ack")
        state = _Row(req)
        state.transit = True
        state.prefilling = False
        self._row_adapter[row] = (slot if slot is not None
                                  else self._max_live)
        trace = req.trace
        if trace is not None:
            sp = trace.span("queue", t0=req.enqueue_t)
            trace.end(sp)
        self._rows[row] = state
        self._lengths[row] = 0
        try:
            # disagg.handoff's second ordinal: a crash mid-import
            faults.check("disagg.handoff")
            kv_len = int(h["kv_len"])
            self._lengths[row] = kv_len
            state.prefilled = kv_len
            if transport == "d2d":
                try:
                    # disagg.d2d's importer-side ordinal
                    faults.check("disagg.d2d")
                    self._kv.import_row_pages(row, h["planes"])
                except Exception as e:  # noqa: BLE001 — refuse it back
                    self._import_failed(row, req, "d2d", e,
                                        "refusing back to the exporter")
                    if ack is not None:
                        self._ack_out.append((ack, False))
                    return
            else:
                self._kv.import_row_pages(
                    row, checkpoint.load_page_blob(h["blob_id"]))
            first = int(h["first_token"])
        except Exception as e:  # noqa: BLE001 — re-prefill here
            if transport == "host":
                checkpoint.delete_page_blob(h["blob_id"])
            self._import_failed(row, req, transport, e,
                                "re-prefilling monolithically")
            if ack is not None:
                # this replica keeps the request: the exporter's parked
                # pages are dead weight
                self._ack_out.append((ack, True))
            self._begin_prefill(row, req, slot)
            return
        if transport == "host":
            checkpoint.delete_page_blob(h["blob_id"])
        state.transit = False
        self._last_tok[row] = first
        self._disagg_imports += 1
        self._admissions += 1
        self._class_admissions[req.priority] += 1
        serve_metrics.CLASS_ADMISSIONS.inc(priority=req.priority)
        now = time.monotonic()
        wait_ms = (now - req.enqueue_t) * 1000.0
        self._h_queue_wait.observe(wait_ms)
        self._h_queue_wait_cls[req.priority].observe(wait_ms)
        serve_metrics.QUEUE_WAIT_MS.observe(wait_ms)
        serve_metrics.QUEUE_WAIT_BY_CLASS.observe(wait_ms,
                                                  priority=req.priority)
        # TTFT anchored at the ORIGINAL enqueue: the hand-off is part of
        # the first token's wait
        ttft_ms = wait_ms
        self._h_ttft.observe(ttft_ms)
        self._h_ttft_cls[req.priority].observe(ttft_ms)
        serve_metrics.TTFT_MS.observe(ttft_ms)
        serve_metrics.TTFT_BY_CLASS.observe(ttft_ms, priority=req.priority)
        handoff_ms = (now - h["t0"]) * 1000.0
        self._h_handoff.observe(handoff_ms)
        serve_metrics.DISAGG_HANDOFF_MS.observe(handoff_ms)
        serve_metrics.DISAGG_HANDOFFS.inc(outcome="ok", transport=transport)
        if ack is not None:
            self._ack_out.append((ack, True))
        if trace is not None:
            trace.event("handoff_import", kv_len=int(h["kv_len"]),
                        handoff_ms=round(handoff_ms, 3), replica=self.replica,
                        transport=transport)
            state.sp_decode = trace.span("decode", ttft_ms=round(ttft_ms, 3))
        # the router's fingerprint index points here now: make it true
        self._register_prefix(row, state)
        self._emit_token(row, state, first)
        self._audit("disagg.import")

    # -- speculative decoding (PENROZ_SPEC_DECODE=1) -------------------------

    def _spec_on(self) -> bool:
        """Speculation applies to greedy engines, and to sampling engines
        on the unified ticks: their block samples with positional keys, so
        verifying a point-mass draft by its longest matching prefix is
        exact rejection sampling (serve/spec_decode.py).  The phased ticks
        keep the JAX package's greedy-only rule."""
        return spec_decode.enabled() and (self.greedy or self._unified())

    def _plan_drafts(self, rows: list[int]) -> list[tuple[int, list[int]]]:
        """(row, draft) pairs for this block's verify spans.  A draft is
        capped by the request's remaining budget - 1 (the model's token
        after the draft covers the last position) and by
        ``block_size - 1 - length``, so a span never writes past the row."""
        if not rows or not self._spec_on():
            return []
        k, n = spec_decode.draft_k(), spec_decode.ngram()
        plan = []
        for i in rows:
            state = self._rows[i]
            cap = min(k, state.req.max_new_tokens - state.produced - 1,
                      self.block_size - 1 - int(self._lengths[i]))
            if cap < 1:
                continue
            draft = spec_decode.propose(state.history, cap, n)
            if draft:
                plan.append((i, draft))
        return plan

    def _emit_token(self, row: int, state: _Row, tok: int):
        state.produced += 1
        state.history.append(tok)
        # the row's host emission gap: inside a multi-step block the block's
        # tokens leave together, so ITL is bursty (the JAX definition)
        now = time.monotonic()
        if state.last_emit_t is not None:
            itl_ms = (now - state.last_emit_t) * 1000.0
            self._h_itl.observe(itl_ms)
            serve_metrics.ITL_MS.observe(itl_ms)
        state.last_emit_t = now
        req = state.req
        if req.adapter is not None:
            aid = req.adapter.adapter_id
            self._adapter_tokens[aid] = self._adapter_tokens.get(aid, 0) + 1
            serve_metrics.LORA_TOKENS.inc(adapter_id=aid)
        tenant = req.tenant
        self._tenant_tokens[tenant] = self._tenant_tokens.get(tenant, 0) + 1
        serve_metrics.TENANT_TOKENS.inc(tenant=tenant)
        qos.QUOTAS.charge(tenant, 1)
        self._deliver(req, "token", tok)
        if req.cancelled:
            self._retire(row, notify=False, reason="cancelled")
        elif req.stop_token is not None and tok == req.stop_token:
            self._retire(row, reason="stop_token")
        elif state.produced >= req.max_new_tokens:
            self._retire(row, reason="max_new_tokens")
        elif req.expired():
            self._timeout_row(row, state, f"after {state.produced} "
                                          f"generated token(s)")
        elif self._lengths[row] >= self.block_size:
            # Defensive: eligibility admits only prompt + max_new <= block,
            # so this is a real pool-capacity truncation — count it.
            dropped = req.max_new_tokens - state.produced
            KV.record_pool_drop(dropped, context=f"scheduler row hit "
                                                 f"block_size="
                                                 f"{self.block_size}")
            self._ledger.note_pool_drop(dropped)
            if req.trace is not None:
                req.trace.event("capacity_pressure", reason="pool_capacity",
                                dropped_tokens=dropped)
            self._retire(row, reason="pool_capacity")

    def _timeout_row(self, row: int, state: _Row, when: str):
        """Retire a row whose deadline passed; the tokens so far were
        delivered, and the request ends with a timeout event."""
        self._deadline_timeouts += 1
        serve_metrics.DEADLINE_TIMEOUTS.inc()
        self._retire(row, notify=False, reason="timeout")
        self._deliver(state.req, "timeout", DeadlineExceeded(
            "inflight", f"request deadline expired {when}"))

    # -- session hibernation (serve/tierstore.py) ---------------------------

    _HIBERNATE_REASONS = ("stop_token", "max_new_tokens", "pool_capacity")

    def _maybe_hibernate(self, row: int, state: _Row, reason: str):
        """At a completed retirement, park a ``session_id`` request's
        prompt and generated tokens' KV: insert the history's full pages
        into the radix cache (the pages it lacks copied from the row's,
        still live), pin the chain under a hold and register the session
        with the tier store.  The worker's demotion pass exports it later;
        the retirement exports nothing.  Adapter rows are not hibernated
        (their pages hold the adapter's K/V), as in the JAX package."""
        req = state.req
        sid = req.session_id
        if (sid is None or reason not in self._HIBERNATE_REASONS
                or req.adapter is not None or self._prefix_cache is None):
            return
        P = self._prefix_cache.page_size
        pages = int(self._lengths[row]) // P
        if pages <= 0:
            return
        kv_len = pages * P
        created = self._prefix_cache.insert(state.history, limit=kv_len)
        if created:
            S = self._kv.pages_per_seq
            self._kv.copy_pages([row * S + b for b, _ in created],
                                [page for _, page in created])
        nodes = self._prefix_cache.chain(state.history, limit=kv_len)
        if len(nodes) * P < kv_len:
            # the radix region ran out mid-insert: a partial session could
            # not resume, so the cached prefix stays a plain radix entry
            return
        ok = tierstore.TIERS.register(
            sid, tenant=req.tenant, model_id=self.model_id,
            model_stamp=self._ckpt_stamp_v,
            tokens=tuple(state.history[:kv_len]), kv_len=kv_len,
            page_size=P, quantized=self._kv.quantized,
            nbytes=kv_len * self._kv._row_bytes(), owner=id(self),
            replica=self.replica)
        if not ok:
            # the tenant's tier quota refused it; nothing was pinned
            return
        # a re-registered id replaced its old record: release its hold
        old = self._hib_holds.pop(sid, None)
        if old is not None:
            self._prefix_cache.unpin(old["nodes"])
        self._prefix_cache.pin(nodes)
        self._hib_holds[sid] = {"nodes": nodes, "kv_len": kv_len}
        self._hib_pending.append(sid)
        self._sessions_hibernated += 1
        if req.trace is not None:
            req.trace.event("session_hibernate", session_id=sid,
                            kv_len=kv_len, pages=pages)

    def _process_demotions(self):
        """Worker loop tail: demote one pending hibernated session a tick
        to the host tier (JAX ``_process_demotions``).  The radix copy
        stays, unpinned and evictable, so an early wake is free.  The
        ``tier.demote`` fault site fires before the export; a crash fails
        the tick, whose reset drops the holds and this engine's hbm-tier
        records."""
        if not self._hib_pending:
            return
        with self._cond:
            sid = self._hib_pending.popleft()
            hold = self._hib_holds.get(sid)
            if hold is None:
                return
            rec = tierstore.TIERS.get(sid)
            if rec is None or rec.tier != "hbm" or rec.owner != id(self):
                # deleted through the API, or replaced, while it waited:
                # release the pin, the pages age out of the radix cache
                del self._hib_holds[sid]
                self._prefix_cache.unpin(hold["nodes"])
                return
        faults.check("tier.demote")
        # only this thread writes the pool, and the hold keeps the pages
        # pinned: the export needs no lock
        blob = self._kv.export_pages([nd.page for nd in hold["nodes"]],
                                     hold["kv_len"])
        with self._cond:
            del self._hib_holds[sid]
            self._prefix_cache.unpin(hold["nodes"])
        # a spill to disk may follow: outside the engine's lock
        tierstore.TIERS.demote_to_host(sid, blob)
        # pages went from a hold back to plain cache residency while a
        # host copy appeared: the books must balance
        self._audit("tier.demote")

    def _drop_hib_holds(self):
        """Release every pending hibernation pin (a reload, a shutdown):
        the radix cache is about to be cleared or abandoned."""
        if self._prefix_cache is not None:
            for hold in self._hib_holds.values():
                self._prefix_cache.unpin(hold["nodes"])
        self._hib_holds = {}
        self._hib_pending.clear()

    def _retire(self, row: int, notify: bool = True,
                reason: str = "completed"):
        state = self._rows[row]
        if state is not None:
            self._maybe_hibernate(row, state, reason)
        self._rows[row] = None
        self._lengths[row] = 0
        self._last_tok[row] = 0
        self._row_adapter[row] = self._max_live
        self._release_prefix(row, state)
        self._kv.reset_row(row)
        self._completed += 1
        if state is not None and state.req.trace is not None:
            trace = state.req.trace
            trace.end(state.sp_prefill)
            trace.end(state.sp_decode, produced=state.produced)
            trace.finish(reason)
        serve_metrics.REQUESTS.inc(
            outcome=("completed" if reason in ("stop_token",
                                               "max_new_tokens",
                                               "pool_capacity")
                     else reason))
        with self._cond:
            if notify:
                # a completed request is the engine's health signal: it
                # zeroes the crash count and closes an open breaker (while
                # open, only the probe runs)
                self._crashes = 0
                self._probe_inflight = False
                if self._breaker_open:
                    self._breaker_open = False
                    log.info("Decode engine %s: circuit breaker closed "
                             "(probe request completed)", self.model_id)
            elif self._breaker_open:
                self._probe_failed()
        if notify and state is not None:
            self._deliver(state.req, "done", None)
        # every page handed back here must balance; after the delivery, so
        # that a failed audit crashes the tick instead of hanging a client
        if memledger.strict():
            self._ledger.audit("retire")

    def _deliver(self, req: Request, kind: str, value):
        try:
            req.on_event(kind, value)
        except Exception:  # noqa: BLE001 — a dead consumer must not kill the batch
            log.exception("Decode scheduler consumer callback failed")
            req.cancelled = True

    def _fail_all(self, exc: Exception, crashed: bool = False) -> list:
        """Fail every in-flight and queued request.  Returns the rows'
        traces: with ``crashed`` they carry an ``engine_crash`` event and
        stay open for the caller's recovery span (else finished here)."""
        open_traces = []
        for i, state in enumerate(self._rows):
            if state is not None:
                # a row parked awaiting a d2d ack handed its request to
                # the importer, which owns every terminal path for it now:
                # release the source copy without touching the stream
                entry = self._transit_rows.get(i)
                handed_off = entry is not None and entry["state"] is state
                self._rows[i] = None
                self._lengths[i] = 0
                self._last_tok[i] = 0
                self._row_adapter[i] = self._max_live
                try:
                    self._release_prefix(i, state)
                except Exception:  # noqa: BLE001 — the device may be what
                    # failed; the reset rebuilds the pool and the cache
                    log.exception("Failed to restore row %d block table", i)
                if handed_off:
                    continue
                serve_metrics.REQUESTS.inc(outcome="error")
                trace = state.req.trace
                if trace is not None:
                    trace.end(state.sp_prefill)
                    trace.end(state.sp_decode, produced=state.produced)
                    if crashed:
                        trace.event("engine_crash", error=str(exc))
                        open_traces.append(trace)
                    else:
                        trace.finish("error")
                self._deliver(state.req, "error", exc)
        with self._cond:
            self._transit_rows.clear()
            self._acks.clear()
            self._outbox.clear()
            pending = self._pending.drain()
            self._probe_failed()
        for req in pending:
            self._release_resume(req)
            self._discard_handoff(req)
            serve_metrics.REQUESTS.inc(outcome="error")
            self._finish_trace(req, "error")
            self._deliver(req, "error", exc)
        return open_traces

    # -- model staleness ----------------------------------------------------

    def _ckpt_stamp(self):
        try:
            return os.path.getmtime(checkpoint.source_path(self.model_id))
        except OSError:
            return None

    def _maybe_reload(self):
        """With no row in flight, pick up a newer checkpoint (a /train/
        that finished since the engine loaded it)."""
        stamp = self._ckpt_stamp()
        if stamp == self._ckpt_stamp_v:
            return
        try:
            self._model = NeuralNetworkModel.deserialize(
                self.model_id, device=self._device, optimizer=False)
            self._ckpt_stamp_v = stamp
            if self._prefix_cache is not None:
                # cached K/V of the old weights must not serve the new
                # ones; no row is in flight, and a queued preempted
                # request gives up its hold (its resume prefills anew)
                with self._cond:
                    for req in self._pending:
                        req.resume_nodes = []
                # hibernation holds' pages vanish with the cache: release
                # them and drop this engine's hbm-tier records (demoted
                # copies stay; their stale stamp drops them at match time)
                self._drop_hib_holds()
                tierstore.TIERS.drop_owner(id(self), "model_reload")
                self._prefix_cache.clear()
            # the same for adapters: the live slots and the registry hold
            # factors whose base just changed; a reloaded entry gets a new
            # uid, which retires its prefix namespace too
            self._slot_entries = [None] * self._max_live
            self._lora_pack = None
            adapters_mod.REGISTRY.invalidate_model(self.model_id)
            log.info("Decode engine reloaded model %s (checkpoint changed; "
                     "prefix cache and adapter slots flushed)",
                     self.model_id)
        except KeyError:
            log.warning("Decode engine %s: checkpoint vanished; serving "
                        "cached weights", self.model_id)


# ---------------------------------------------------------------------------
# Engine registry
# ---------------------------------------------------------------------------

_ENGINES: dict = {}
_REG_LOCK = threading.Lock()
_DRAINING = False


def _engine_key(model_id, block_size, temperature, top_k, device):
    greedy = temperature is None or float(temperature) == 0.0
    return (model_id, int(block_size), 0.0 if greedy else float(temperature),
            int(top_k) if top_k is not None else None, str(device))


def get_engine(model_id, block_size, temperature, top_k, device=None):
    """Engine lookup/creation (deserializes the model on a miss).  Returns
    None when the registry is at capacity with no idle engine, or while
    the server drains (a shutdown must not start engines); the caller
    takes the single-sequence path.  Raises KeyError for an unknown model
    (HTTP 404).  With ``PENROZ_SCHED_REPLICAS`` > 1 the answer is the
    replica group's ``EngineRouter`` (serve/router.py), which has the same
    ``submit``."""
    if _DRAINING:
        return None
    if _replicas() > 1:
        from penroz_tpu_torch.serve import router as router_mod
        return router_mod.get_router(model_id, block_size, temperature,
                                     top_k, device=device)
    key = _engine_key(model_id, block_size, temperature, top_k, device)
    with _REG_LOCK:
        engine = _ENGINES.get(key)
        if engine is not None and not engine._shutdown:
            return engine
        if engine is not None:
            del _ENGINES[key]
        if len(_ENGINES) >= _max_engines():
            # a router owns its replicas' lifecycle: never a victim here
            victim = next((k for k, e in _ENGINES.items()
                           if e.idle() and not e._router_owned), None)
            if victim is None:
                log.warning("Decode engine registry full (%d) with no idle "
                            "engine; request falls back to the "
                            "single-sequence path", len(_ENGINES))
                return None
            _ENGINES.pop(victim).shutdown(timeout=5.0)
        engine = DecodeEngine(model_id, block_size, temperature, top_k,
                              device=device)
        _ENGINES[key] = engine
        return engine


def reset():
    """Shut every engine down and clear the registry, the routers first
    (tests)."""
    global _DRAINING
    from penroz_tpu_torch.serve import router as router_mod
    router_mod.clear()
    with _REG_LOCK:
        engines = list(_ENGINES.values())
        _ENGINES.clear()
    _DRAINING = False
    for engine in engines:
        engine.shutdown(timeout=5.0)


def draining() -> bool:
    return _DRAINING


def _live_engines() -> list:
    with _REG_LOCK:
        return [e for e in _ENGINES.values() if not e._shutdown]


def _group_rule(verdict) -> list[str]:
    """The models a verdict marks unservable: a standalone engine's when
    it holds; a router's replica group's only when it holds for EVERY
    replica (one healthy replica keeps the model serving)."""
    out, groups = set(), {}
    for e in _live_engines():
        if e._router_owned:
            groups.setdefault(e.model_id, []).append(verdict(e))
        elif verdict(e):
            out.add(e.model_id)
    out.update(m for m, vals in groups.items() if all(vals))
    return sorted(out)


def breaker_open_engines() -> list[str]:
    """The models whose engine (or every replica of whose group) has its
    breaker open: the scheduler path cannot serve them (``/readyz``
    answers 503)."""
    return _group_rule(lambda e: e._breaker_open)


def stuck_engines() -> list[str]:
    """The models whose engine's worker (every replica's, for a group)
    has been inside one tick longer than ``PENROZ_TICK_WATCHDOG_MS``
    (``/readyz`` answers 503)."""
    return _group_rule(lambda e: e.stuck())


def drain_and_shutdown(drain_s: float | None = None) -> bool:
    """Graceful shutdown: mark the registry draining (``/readyz`` turns not
    ready, engines stop admitting), give the rows in flight up to
    ``drain_s`` (default ``PENROZ_DRAIN_S``) to finish, then join every
    worker thread.  True iff every thread joined."""
    global _DRAINING
    _DRAINING = True
    if drain_s is None:
        drain_s = _drain_s()
    from penroz_tpu_torch.serve import router as router_mod
    router_mod.clear()
    with _REG_LOCK:
        engines = list(_ENGINES.values())
        _ENGINES.clear()
    ok = True
    try:
        for engine in engines:
            ok = engine.shutdown(timeout=10.0, drain_s=drain_s) and ok
    finally:
        # the registry is empty: a server created later in this process
        # serves again
        _DRAINING = False
    return ok


def _merged_q(per: list[dict], name: str, q: float, cls=None):
    """Quantile over the engines' merged histogram snapshots (a class's,
    when ``cls`` is given)."""
    snaps = [p["histograms"][name] if cls is None
             else p["histograms"][name][cls] for p in per]
    v = metrics_util.quantile_of(metrics_util.merge_snapshots(snaps), q)
    return round(v, 3) if v is not None else None


def _pipe_bubble_agg(per: list[dict]):
    """The bubble fraction over every piped engine, each weighted by its
    stage-ticks (pipe_ticks x stages); None before any pipeline tick."""
    num = den = 0.0
    for p in per:
        ticks, frac = p["pipe_ticks"], p["pipe_bubble_fraction"]
        if ticks and frac is not None:
            w = ticks * p["pipe_stages"]
            num += frac * w
            den += w
    return round(num / den, 4) if den else None


def serving_stats() -> dict:
    """Scheduler observability — the /serving_stats/ payload, the JAX
    package's key names for what this scheduler does.  Percentiles merge
    the engines' bucket snapshots, never raw samples; the router and
    disaggregation fields add up the replica groups."""
    from penroz_tpu_torch.serve import router as router_mod
    router = router_mod.stats_totals()
    tiers = tierstore.TIERS.stats()
    per = [e.stats() for e in _live_engines()]
    capacity = sum(p["capacity"] for p in per)
    active = sum(p["active_rows"] for p in per)
    decode_steps = sum(p["decode_steps"] for p in per)
    decode_tokens = sum(p["decode_tokens"] for p in per)
    timeline = sorted((t for p in per for t in p["tick_timeline"]),
                      key=lambda e: e["age_s"])[:_TIMELINE_SERVE]
    pc = [p["prefix_cache"] for p in per if p["prefix_cache"] is not None]
    pc_lookups = sum(c["hits"] + c["misses"] for c in pc)
    spec_drafted = sum(p["spec_drafted_tokens"] for p in per)
    spec_accepted = sum(p["spec_accepted_tokens"] for p in per)
    tpd = metrics_util.merge_snapshots(
        [p["histograms"]["tokens_per_dispatch"] for p in per])
    tenant_tokens: dict = {}
    adapter_tokens: dict = {}
    for p in per:
        for tenant, n in p["tenant_tokens"].items():
            tenant_tokens[tenant] = tenant_tokens.get(tenant, 0) + n
        for aid, n in p["lora_adapter_tokens"].items():
            adapter_tokens[aid] = adapter_tokens.get(aid, 0) + n
    return {
        "continuous_batching_enabled": enabled(),
        "engines": per,
        "capacity": capacity,
        "active_rows": active,
        "queue_depth": sum(p["queue_depth"] for p in per),
        "queue_rejections": sum(p["queue_rejections"] for p in per),
        "deadline_timeouts": sum(p["deadline_timeouts"] for p in per),
        "quota_rejections": sum(p["quota_rejections"] for p in per),
        "preemptions_total": sum(p["preemptions"] for p in per),
        "preempted_resume_cached_tokens": sum(
            p["preempted_resume_cached_tokens"] for p in per),
        "queue_depth_by_class": {
            c: sum(p["queue_depth_by_class"][c] for p in per)
            for c in qos.PRIORITIES},
        "tenant_tokens": tenant_tokens,
        "ttft_ms_p99_by_class": {
            c: _merged_q(per, "ttft_ms_by_class", 0.99, c)
            for c in qos.PRIORITIES},
        "queue_wait_ms_p99_by_class": {
            c: _merged_q(per, "queue_wait_ms_by_class", 0.99, c)
            for c in qos.PRIORITIES},
        "queue_wait_ms_p99": _merged_q(per, "queue_wait_ms", 0.99),
        "breaker_open": any(p["breaker_open"] for p in per),
        "crashes_total": sum(p["crashes_total"] for p in per),
        "engine_resets": sum(p["engine_resets"] for p in per),
        "draining": _DRAINING,
        "batch_occupancy": (active / capacity) if capacity else 0.0,
        "decode_tokens_per_sec": round(
            sum(p["decode_tokens_per_sec"] for p in per), 2),
        "admission_latency_ms_p50": _merged_q(per, "ttft_ms", 0.5),
        "ttft_ms_p99": _merged_q(per, "ttft_ms", 0.99),
        "itl_ms_p50": _merged_q(per, "itl_ms", 0.5),
        "itl_ms_p99": _merged_q(per, "itl_ms", 0.99),
        "tick_ms_p50": _merged_q(per, "tick_ms", 0.5),
        "tick_ms_p99": _merged_q(per, "tick_ms", 0.99),
        "tick_timeline": timeline,
        "prefill_chunk_stall_ms_p99": _merged_q(per, "chunk_stall_ms",
                                                0.99),
        "prefix_cache_hit_rate": _rate(sum(c["hits"] for c in pc),
                                       pc_lookups),
        "prefix_cache_evicted_pages": sum(c["evicted_pages"] for c in pc),
        "lora_active_adapters": sum(p["lora_active_adapters"] for p in per),
        "lora_rows": sum(p["lora_rows"] for p in per),
        "lora_adapter_tokens": adapter_tokens,
        "spec_decode_enabled": spec_decode.enabled(),
        "spec_drafted_tokens": spec_drafted,
        "spec_accepted_tokens": spec_accepted,
        "spec_accept_rate": _rate(spec_accepted, spec_drafted),
        "tokens_per_decode_step": round(
            decode_tokens / decode_steps, 3) if decode_steps else 0.0,
        "decode_steps": decode_steps,
        "decode_tokens": decode_tokens,
        "dispatches_total": sum(p["dispatches_total"] for p in per),
        "tokens_per_dispatch_avg": (round(tpd["sum"] / tpd["count"], 3)
                                    if tpd["count"] else None),
        "tokens_per_dispatch_p50": _merged_q(per, "tokens_per_dispatch",
                                             0.5),
        "kv_pool_capacity_drops": KV.pool_drop_count(),
        "unpin_underflows": KV.unpin_underflow_count(),
        # replica router: 0 replicas = no router live
        "router_replicas": router["replicas"],
        "router_affinity_hits": router["affinity_hits"],
        "router_affinity_misses": router["affinity_misses"],
        "router_affinity_hit_rate": _rate(
            router["affinity_hits"],
            router["affinity_hits"] + router["affinity_misses"]),
        "router_failovers": router["failovers"],
        "disagg_prefill_replicas": router["prefill_replicas"],
        "disagg_exports": sum(p["disagg_exports"] for p in per),
        "disagg_imports": sum(p["disagg_imports"] for p in per),
        "disagg_handoff_failures": sum(
            p["disagg_handoff_failures"] for p in per),
        "disagg_handoff_ms_p50": _merged_q(per, "handoff_ms", 0.5),
        "disagg_handoff_ms_p99": _merged_q(per, "handoff_ms", 0.99),
        "disagg_transport": _disagg_transport(),
        "disagg_role_changes": sum(p["disagg_role_changes"] for p in per),
        "ssm_rows": sum(p["ssm_rows"] for p in per),
        "ssm_state_bytes": sum(p["ssm_state_bytes"] for p in per),
        # pipeline groups: the widest, and the stage-tick-weighted bubble
        "pipe_stages": max((p["pipe_stages"] for p in per), default=1),
        "pipe_ticks": sum(p["pipe_ticks"] for p in per),
        "pipe_bubble_fraction": _pipe_bubble_agg(per),
        "pipe_handoffs": sum(p["pipe_handoffs"] for p in per),
        "pipe_handoff_host_fallbacks": sum(
            p["pipe_handoff_host_fallbacks"] for p in per),
        # the session tiers: the store is process-wide, the counters under
        # it sum the engines
        "sessions_resident": tiers["sessions_resident"],
        "sessions_by_tier": tiers["sessions_by_tier"],
        "tier_bytes": tiers["tier_bytes"],
        "tier_promotions": tiers["tier_promotions"],
        "tier_demotions": tiers["tier_demotions"],
        "tier_corrupt_blobs": tiers["tier_corrupt_blobs"],
        "sessions_hibernated": sum(p["sessions_hibernated"] for p in per),
        "session_promotions": sum(p["session_promotions"] for p in per),
        "session_resume_ttft_ms_p50": _merged_q(per, "session_resume_ttft_ms",
                                                0.5),
        "session_resume_ttft_ms_p99": _merged_q(per, "session_resume_ttft_ms",
                                                0.99),
        # crash durability: the journal's counters, the last restart
        # recovery, the resumable streams
        "journal": journal.JOURNAL.stats(),
        "restart_recovery": tiers["restart_recovery"],
        "streams": streams.STREAMS.stats(),
        "engines_stuck": len(stuck_engines()),
    }


# ---------------------------------------------------------------------------
# Thread request surface (serve/app.py)
# ---------------------------------------------------------------------------

def _queued_request(prompt, max_new_tokens, stop_token, timeout_ms=None,
                    request_id=None, trace=None, priority=None,
                    tenant=None, adapter=None, session_id=None):
    events: queue.Queue = queue.Queue()
    req = Request(prompt, max_new_tokens, stop_token,
                  lambda kind, value: events.put((kind, value)),
                  timeout_ms=timeout_ms, request_id=request_id, trace=trace,
                  priority=priority, tenant=tenant, adapter=adapter,
                  session_id=session_id)
    return req, events


def next_event(req: Request, events: queue.Queue, timeout=None):
    """The next ``(kind, value)`` of ``req`` (a stream's events carry their
    sequence number first, dropped here); on ``timeout`` (seconds) the
    request is cancelled and TimeoutError raised."""
    try:
        event = events.get(timeout=timeout)
    except queue.Empty:
        req.cancelled = True
        raise TimeoutError(f"no scheduler event within {timeout} s")
    return event[-2:]


def collect(req: Request, events: queue.Queue, timeout=None) -> list[int]:
    """Wait for ``req``'s full sequence (prompt + generated, the
    ``generate_tokens`` contract); re-raise its error or its
    DeadlineExceeded.  ``timeout`` bounds each wait for the next event
    (None: no bound)."""
    tokens = list(req.prompt)
    while True:
        kind, value = next_event(req, events, timeout)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens
        else:
            raise value


def run_request(engine: DecodeEngine, prompt, max_new_tokens, stop_token,
                timeout=None, timeout_ms=None, **fields) -> list[int]:
    """Submit one request (deadline ``timeout_ms``; ``fields``:
    ``request_id``, ``trace``, ``priority``, ``tenant``, ``session_id``,
    ``adapter``, whose registry pin the caller holds) and wait for its
    full sequence (:func:`collect`).  A shed request raises at once."""
    req, events = submit_request(engine, prompt, max_new_tokens, stop_token,
                                 timeout_ms, **fields)
    return collect(req, events, timeout)


def submit_request(engine: DecodeEngine, prompt, max_new_tokens, stop_token,
                   timeout_ms=None, **fields):
    """Submit one request (``fields`` as for :func:`run_request`) without
    waiting; returns ``(req, events)`` for :func:`next_event` and
    :func:`collect`.  A shed request raises here, before any event."""
    req, events = _queued_request(prompt, max_new_tokens, stop_token,
                                  timeout_ms, **fields)
    engine.submit(req)
    return req, events


def start_stream(engine: DecodeEngine, prompt, max_new_tokens, stop_token,
                 timeout_ms=None, **fields):
    """Submit a streaming request (``fields`` as for :func:`run_request`);
    returns ``(req, events)``.  Its events go through a resumable
    :class:`~penroz_tpu_torch.serve.streams.StreamSession` (``req.stream``,
    registered under the request id): ``events`` carries ``(seq, kind,
    value)``, which :func:`next_event` reads as ``(kind, value)``.  The
    caller calls ``req.stream.try_detach()`` when its client goes away
    (a grace instead of a cancel with ``PENROZ_STREAM_DETACH_MS`` > 0,
    else it cancels the request) and ``req.stream.release()`` when it has
    read the end.  A shed request raises here, before any event."""
    req, events = _queued_request(prompt, max_new_tokens, stop_token,
                                  timeout_ms, **fields)
    rid = req.request_id or f"req-{id(req):x}"
    req.stream = streams.STREAMS.register(rid, req)
    req.stream.attach_initial(events)
    req.on_event = req.stream.publish
    try:
        engine.submit(req)
    except Exception:
        streams.STREAMS.discard(rid)
        raise
    return req, events
