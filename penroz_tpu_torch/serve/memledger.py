"""Page-granularity capacity ledger and engine crash flight recorder
(counterpart of penroz_tpu/serve/memledger.py).

Every page of an engine's paged KV pool is attributed to exactly ONE owner
state:

- ``free``             — unassigned pages of the static per-row partition
- ``row``              — pages a live decode row's KV occupies (attributed
                         onward to its request's tenant)
- ``prefix_pinned``    — radix prefix-cache pages aliased by a live row
                         (refs > 0; eviction-proof)
- ``prefix_evictable`` — cached prefix pages no row pins (LRU-evictable on
                         the next insert)
- ``preempted``        — cache pages pinned by a QUEUED preempted request's
                         resume hold (serve/qos.py preemption: the
                         zero-recompute resume guarantee)
- ``reserved``         — the prefix-cache region's unallocated tail (the
                         radix free list)
- ``transit``          — pages of a disaggregated-prefill hand-off row in
                         flight: a prefill replica's row parked until the
                         importer's d2d ack, a decode replica's row
                         mid-import (serve/router.py)

- ``hibernating``      — radix pages pinned by a session hibernation hold
                         awaiting its background demotion
                         (serve/tierstore.py)

A byte ledger covers the rest of the engine's device memory (the K/V
pools, or a contiguous cache's buffers, their int8 scales, the block
table, the LoRA pack, the model's parameters and buffers; a pipeline
group's pool bytes also by stage, ``stage_pools``), read from the port's
own tensors, and the
process-wide host components: the adapter registry's cache
(``adapter_host_cache``) and the session tiers' blobs in host RAM and on
disk (``host_tier``, ``disk_tier``, from the tier store); live rows'
pages are attributed to their tenant and, for adapter rows, to their
adapter (``adapter_pages``).  ``ssm_state`` is the recurrent state of a
hybrid or pure-SSM model's rows (the cache's ``ssm`` child: constant
whatever the rows' lengths).

The ledger does NOT shadow-count at mutation sites:
:meth:`MemoryLedger.snapshot` *derives* ownership from the authoritative
structures (row table, host lengths, prefix pins, the radix tree, queued
resume holds), so the report cannot drift from the state it describes.
:meth:`MemoryLedger.audit` hunts drift between independently derived
views: with ``PENROZ_MEMLEDGER_STRICT=1`` every retirement, preemption and
crash recovery re-proves

    owned + free == pool capacity, zero orphan owners,
    every radix refcount == the pins derivable from live rows, queued
    resume holds and hibernation holds

and raises :class:`LedgerAuditError` on the first violation.

The **flight recorder** is the postmortem half: on every engine crash,
circuit-breaker opening and watchdog firing, the engine's pre-crash ledger
snapshot, tick-timeline tail, per-class and per-tenant queue depths and
recent trace ids land in a bounded process-wide ring served by
``GET /debug/dump``.

Surfaces: ``GET /memory/`` (serve/app.py), ``penroz_pool_pages{state}``,
``penroz_tenant_kv_pages{tenant}``, ``penroz_hbm_bytes{component}``, the
high-water marks and a token-burn-rate time-to-exhaustion estimate on
``GET /metrics``, per-engine ``memory`` blocks in ``/serving_stats/``, and
the dashboard's memory panel.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

from penroz_tpu_torch.ops import kv_cache as KV

log = logging.getLogger(__name__)

ENABLE_ENV = "PENROZ_MEMLEDGER"
STRICT_ENV = "PENROZ_MEMLEDGER_STRICT"
DUMP_RING_ENV = "PENROZ_DEBUG_DUMP_RING"
DUMP_TICKS_ENV = "PENROZ_DEBUG_DUMP_TICKS"

#: Every pool page is in exactly one of these states; their sum is the
#: pool capacity (the audited invariant).  The JAX package's names.
PAGE_STATES = ("free", "row", "prefix_pinned", "prefix_evictable",
               "preempted", "reserved", "transit", "hibernating")

#: Fixed keys of the per-engine byte ledger (``hbm_bytes``); the aggregate
#: adds the process-wide host components.
BYTE_COMPONENTS = ("kv_values", "kv_scales", "kv_block_table",
                   "lora_pack", "params", "ssm_state")
_HOST_COMPONENTS = ("adapter_host_cache", "host_tier", "disk_tier")
PORTED_COMPONENTS = (*BYTE_COMPONENTS, *_HOST_COMPONENTS)

#: Sliding window of the token-burn-rate estimate (the scheduler's
#: tokens/s window).
_BURN_WINDOW_S = 30.0


def enabled() -> bool:
    """Ledger and flight recorder on by default; ``PENROZ_MEMLEDGER=0`` is
    the kill switch (snapshots degrade to empty, the recorder drops)."""
    return os.environ.get(ENABLE_ENV, "1") != "0"


def strict() -> bool:
    """Leak-sanitizer mode: audit at every retirement, preemption and crash
    recovery, and RAISE on a violation."""
    return os.environ.get(STRICT_ENV, "0") == "1"


def _env_i(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        log.warning("Unparseable %s=%r; using default %d", name,
                    os.environ.get(name), default)
        return default


def ported(values: dict, keys) -> dict:
    """``values`` restricted to ``keys`` (the labelled gauges' series)."""
    return {k: values.get(k, 0) for k in keys}


class LedgerAuditError(AssertionError):
    """A strict-mode audit found leaked or orphaned pages, or a refcount
    that disagrees with the derivable pin set."""


def _module_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in (*module.parameters(), *module.buffers()))


class MemoryLedger:
    """One engine's slice of the capacity ledger, owned by its
    :class:`~penroz_tpu_torch.serve.decode_scheduler.DecodeEngine`;
    ``snapshot`` and ``audit`` take the engine's condition lock (an RLock,
    so seams that already hold it may call them)."""

    def __init__(self, engine):
        self._engine = engine
        # Engine-scoped pool-capacity retirements (the process-wide mirror
        # is KV.record_pool_drop / pool_drop_count()).
        self.pool_capacity_drops = 0
        self.dropped_tokens = 0
        # Capacity-pressure events: pool-capacity truncations and QoS
        # preemptions (both say the pool is too small for the load).
        self.pressure_events = 0
        self.audit_failures = 0
        # Unpin underflows per prefix-cache INSTANCE; crash recovery
        # replaces the cache, so retired instances' counts carry over.
        self._underflow_carry = 0
        self.high_water: dict = {}

    @property
    def unpin_underflows(self) -> int:
        cache = self._engine._prefix_cache
        live = cache.unpin_underflows if cache is not None else 0
        return self._underflow_carry + live

    def note_pool_drop(self, tokens: int):
        self.pool_capacity_drops += 1
        self.dropped_tokens += max(0, int(tokens))
        self.pressure_events += 1

    def note_pressure(self):
        self.pressure_events += 1

    def on_realloc(self, old_cache):
        """Crash recovery replaced the engine state: fold the dying prefix
        cache's counters into the lifetime carry."""
        if old_cache is not None:
            self._underflow_carry += old_cache.unpin_underflows

    # -- the snapshot walk ---------------------------------------------------

    def _resume_pages(self) -> set:
        """Pages held by QUEUED preempted requests' resume pins (the caller
        holds the engine lock)."""
        return {nd.page for req in self._engine._pending
                for nd in req.resume_nodes}

    def _hib_pages(self) -> set:
        """Pages pinned by hibernation holds awaiting demotion."""
        return {nd.page for hold in self._engine._hib_holds.values()
                for nd in hold["nodes"]}

    def snapshot(self) -> dict:
        """Derive the ownership map from the engine's structures.
        Consistent from the worker thread or with the engine quiescent;
        concurrent HTTP reads see torn-but-valid state (as ``stats()``)."""
        with self._engine._cond:
            return self._snapshot_locked()

    def _snapshot_locked(self) -> dict:
        e = self._engine
        kv = e._kv
        paged = isinstance(kv, KV.PagedKVState)
        states = dict.fromkeys(PAGE_STATES, 0)
        tenant_pages: dict = {}
        adapter_pages: dict = {}
        page_size = total = 0
        hbm = dict.fromkeys(BYTE_COMPONENTS, 0)
        if enabled() and paged:
            page_size = kv.page_size
            total = kv.num_pool_pages
            resume_pages = self._resume_pages()
            row_pages = transit_pages = 0
            for i, state in enumerate(e._rows):
                if state is None:
                    continue
                used = -(-int(e._lengths[i]) // page_size)   # ceil
                owned = max(0, used - len(state.prefix_nodes))
                if state.transit:
                    transit_pages += owned
                else:
                    row_pages += owned
                tenant = state.req.tenant
                tenant_pages[tenant] = tenant_pages.get(tenant, 0) + owned
                if state.req.adapter is not None:
                    aid = state.req.adapter.adapter_id
                    adapter_pages[aid] = adapter_pages.get(aid, 0) + owned
            cache = e._prefix_cache
            hib_pages = self._hib_pages()
            pinned = evictable = preempted = reserved = cache_pages = 0
            hibernating = 0
            if cache is not None:
                cache_pages = cache.capacity_pages
                reserved = cache.free_pages
                for nd in cache.iter_nodes():
                    if nd.page in resume_pages:
                        preempted += 1
                    elif nd.page in hib_pages:
                        hibernating += 1
                    elif nd.refs > 0:
                        pinned += 1
                    else:
                        evictable += 1
            states.update({
                "row": row_pages,
                "transit": transit_pages,
                "free": (total - cache_pages) - row_pages - transit_pages,
                "prefix_pinned": pinned,
                "prefix_evictable": evictable,
                "preempted": preempted,
                "reserved": reserved,
                "hibernating": hibernating,
            })
        if enabled():
            # the byte ledger covers the contiguous caches too
            hbm.update(kv.hbm_components())
            hbm["lora_pack"] = lora_pack_bytes(e._lora_pack)
            hbm["params"] = _module_bytes(e._model.arch)
        # High-water marks: per-state peaks and the pages in use.
        for key, v in [*states.items(), ("used", total - states["free"])]:
            if key != "free":
                self.high_water[key] = max(self.high_water.get(key, 0), v)
        return {
            "paged": paged,
            "page_size": page_size,
            "pool_pages_total": total,
            "pool_pages": states,
            "tenant_pages": tenant_pages,
            "adapter_pages": adapter_pages,
            "stage_pools": self._stage_pools_locked(),
            "hbm_bytes": hbm,
            "high_water_pages": dict(self.high_water),
            "time_to_exhaustion_s": self._time_to_exhaustion(
                states["free"], page_size),
            "kv_pool_capacity_drops": self.pool_capacity_drops,
            "unpin_underflows": self.unpin_underflows,
            "pressure_events": self.pressure_events,
            "audit_failures": self.audit_failures,
        }

    def _stage_pools_locked(self) -> list:
        """A pipeline group's pool by stage: stage ``s`` holds attention
        layers ``kv_bounds[s]`` of the pool, so its pool bytes are its
        slices' over the SAME page partition (every stage sees every
        logical page, in its own layers).  Empty for an unpiped engine."""
        e = self._engine
        pipe = e._pipe
        if pipe is None or not isinstance(e._kv, KV.PagedKVState) \
                or not enabled():
            return []
        return [{"stage": s, "kv_layers": hi - lo,
                 "pool_pages": e._kv.num_pool_pages,
                 "kv_pool_bytes": KV.stage_pool_bytes(e._kv, lo, hi)}
                for s, (lo, hi) in enumerate(pipe.kv_bounds)]

    def _time_to_exhaustion(self, free_pages: int, page_size: int):
        """Free row-region KV tokens over the recent token burn rate; None
        when idle (no rate, no estimate: a quiet engine never looks
        exhausted)."""
        if page_size <= 0:
            return None
        now = time.monotonic()
        window = [(t, n) for t, n in list(self._engine._token_window)
                  if now - t <= _BURN_WINDOW_S]
        span = (now - window[0][0]) if window else 0.0
        if span <= 0.2:
            return None
        rate = sum(n for _, n in window) / span
        if rate <= 0:
            return None
        return round(free_pages * page_size / rate, 1)

    # -- the leak sanitizer --------------------------------------------------

    def audit(self, where: str) -> list[str]:
        """Re-derive every ownership claim two independent ways and
        compare.  Returns the violations; in strict mode a non-empty list
        raises :class:`LedgerAuditError` (the engine treats that as the
        corruption it is)."""
        e = self._engine
        with e._cond:
            problems = self._audit_locked()
        if problems:
            self.audit_failures += 1
            msg = (f"memory-ledger audit failed at {where} "
                   f"(engine {e.model_id}): " + "; ".join(problems))
            if strict():
                raise LedgerAuditError(msg)
            log.warning(msg)
        return problems

    def _audit_locked(self) -> list[str]:
        e = self._engine
        if not enabled():
            return []
        problems: list[str] = []
        cache = e._prefix_cache
        if cache is not None:
            problems.extend(f"radix: {p}" for p in cache.page_audit())
            # A node's refs must equal the pins derivable from live rows'
            # prefix_nodes plus queued resume holds: an unpaired pin or
            # unpin shows up here as a mismatch instead of silent drift.
            expected: collections.Counter = collections.Counter()
            holders: list = []
            for state in e._rows:
                if state is not None:
                    holders.extend(state.prefix_nodes)
            for req in e._pending:
                holders.extend(req.resume_nodes)
            for hold in e._hib_holds.values():
                holders.extend(hold["nodes"])
            for nd in holders:
                expected[id(nd)] += 1
            in_tree = set()
            for nd in cache.iter_nodes():
                in_tree.add(id(nd))
                want = expected.get(id(nd), 0)
                if nd.refs != want:
                    problems.append(f"node page {nd.page}: refs={nd.refs} "
                                    f"but {want} derivable pin(s)")
            orphans = [nid for nid in expected if nid not in in_tree]
            if orphans:
                problems.append(f"{len(orphans)} pinned node(s) no longer "
                                f"in the tree (orphan pins)")
        snap = self._snapshot_locked()
        states = snap["pool_pages"]
        owned = sum(states.values())
        if owned != snap["pool_pages_total"]:
            problems.append(f"page states sum to {owned} != pool capacity "
                            f"{snap['pool_pages_total']} ({states})")
        for s, n in states.items():
            if n < 0:
                problems.append(f"negative page count {s}={n}")
        # a pipeline group: every stage sees the whole page partition, and
        # the stages' pool bytes tile the pool's exactly
        for entry in snap["stage_pools"]:
            if entry["pool_pages"] != snap["pool_pages_total"]:
                problems.append(
                    f"stage {entry['stage']}: pool_pages="
                    f"{entry['pool_pages']} != pool capacity "
                    f"{snap['pool_pages_total']}")
        if snap["stage_pools"]:
            stage_bytes = sum(en["kv_pool_bytes"]
                              for en in snap["stage_pools"])
            kv_bytes = (snap["hbm_bytes"]["kv_values"]
                        + snap["hbm_bytes"]["kv_scales"])
            if stage_bytes != kv_bytes:
                problems.append(f"stage pool bytes sum to {stage_bytes} != "
                                f"kv pool HBM {kv_bytes}")
        return problems


# ---------------------------------------------------------------------------
# Flight recorder (GET /debug/dump)
# ---------------------------------------------------------------------------


class FlightRecorder:
    """Bounded process-wide ring of pre-crash engine snapshots.

    ``record`` runs in the crashing worker thread BEFORE the engine fails
    its requests and reallocates its state; every capture step is
    best-effort (a partial entry with the reason beats no entry)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, _env_i(DUMP_RING_ENV, 8)))
        self.recorded = 0

    def record(self, engine, reason: str, error: str | None = None):
        if not enabled():
            return
        entry = {
            "unix_ts": time.time(),
            "reason": reason,
            "error": error,
            "model_id": engine.model_id,
            "block_size": engine.block_size,
        }
        try:
            now = time.monotonic()
            ticks = list(engine._tick_timeline)[-max(
                1, _env_i(DUMP_TICKS_ENV, 32)):]
            with engine._cond:
                by_class = engine._pending.class_depths()
                by_tenant = engine._pending.tenant_depths()
            entry.update({
                "crashes_total": engine._crashes_total,
                "engine_resets": engine._engine_resets,
                "active_rows": engine.active_rows,
                "queue_depth": engine.queue_depth,
                "ledger": engine._ledger.snapshot(),
                "tick_timeline": [
                    {"age_s": round(now - t["t"], 3),
                     **{k: v for k, v in t.items() if k != "t"}}
                    for t in ticks],
                "queue_depth_by_class": by_class,
                "queue_depth_by_tenant": by_tenant,
                "recent_traces": _recent_trace_ids(),
            })
        except Exception:  # noqa: BLE001 — a postmortem must not crash the crash path
            log.exception("Flight recorder: partial capture for %s (%s)",
                          engine.model_id, reason)
            entry["partial"] = True
        with self._lock:
            self._ring.append(entry)
            self.recorded += 1
        log.warning("Flight recorder: captured %s for engine %s "
                    "(GET /debug/dump)", reason, engine.model_id)

    def dump(self) -> dict:
        with self._lock:
            return {"capacity": self._ring.maxlen,
                    "recorded": self.recorded,
                    "entries": list(self._ring)}

    def reset(self):
        with self._lock:
            self._ring = collections.deque(
                maxlen=max(1, _env_i(DUMP_RING_ENV, 8)))
            self.recorded = 0


FLIGHT_RECORDER = FlightRecorder()


def _recent_trace_ids(limit: int = 16) -> dict:
    """Request ids of recently completed and live traces: the keys a
    postmortem follows into ``GET /trace/{id}``."""
    from penroz_tpu_torch.utils import tracing
    done = [t.request_id for t in tracing.completed(limit=limit)]
    live = [t.request_id for t in tracing.live()]
    return {"completed": done, "live": live[:limit]}


# ---------------------------------------------------------------------------
# Cross-engine aggregation (GET /memory/, /metrics gauges)
# ---------------------------------------------------------------------------


def _engine_snapshots() -> list[tuple]:
    """(engine, snapshot) pairs over the live registry."""
    from penroz_tpu_torch.serve import decode_scheduler as ds
    return [(e, e.memory_snapshot()) for e in ds._live_engines()]


def lora_pack_bytes(pack) -> int:
    """Device bytes of an engine's LoRA pack (models/lora.py)."""
    if not pack:
        return 0
    return sum(t.numel() * t.element_size()
               for ent in pack.values() for t in ent.values())


def _byte_totals(per: list[dict]) -> dict:
    from penroz_tpu_torch.serve import adapters as adapters_mod
    from penroz_tpu_torch.serve import tierstore
    out = {k: sum(p["hbm_bytes"].get(k, 0) for p in per)
           for k in BYTE_COMPONENTS}
    out["adapter_host_cache"] = adapters_mod.REGISTRY.cache_bytes()
    # the session tiers' blobs: process-wide, like the adapter cache
    out.update(tierstore.TIERS.tier_bytes())
    return out


def memory_stats() -> dict:
    """The ``GET /memory/`` payload: per-engine ledger snapshots, the
    cross-engine totals and the process-wide counters (the JAX package's
    keys)."""
    from penroz_tpu_torch.ops import kv_cache as KV
    from penroz_tpu_torch.serve import decode_scheduler as ds
    per = [dict(snap, model_id=e.model_id, block_size=e.block_size,
                capacity=e.capacity, replica=e.replica, role=e.role,
                disagg_transport=ds._disagg_transport())
           for e, snap in _engine_snapshots()]
    pool = {s: sum(p["pool_pages"][s] for p in per) for s in PAGE_STATES}
    tenant: dict = {}
    hwm: dict = {}
    for p in per:
        for t, n in p["tenant_pages"].items():
            tenant[t] = tenant.get(t, 0) + n
        for s, n in p["high_water_pages"].items():
            hwm[s] = hwm.get(s, 0) + n
    ttes = [p["time_to_exhaustion_s"] for p in per
            if p["time_to_exhaustion_s"] is not None]
    return {
        "memledger_enabled": enabled(),
        "engines": per,
        "pool_pages": pool,
        "tenant_pages": tenant,
        "hbm_bytes": _byte_totals(per),
        "high_water_pages": hwm,
        "time_to_exhaustion_s": min(ttes) if ttes else None,
        "kv_pool_capacity_drops": KV.pool_drop_count(),
        "unpin_underflows": KV.unpin_underflow_count(),
        "pressure_events": sum(p["pressure_events"] for p in per),
        "audit_failures": sum(p["audit_failures"] for p in per),
        "flight_records": FLIGHT_RECORDER.recorded,
    }


def pool_page_totals() -> dict:
    """penroz_pool_pages{state} gauge callback."""
    per = [snap for _, snap in _engine_snapshots()]
    return {s: sum(p["pool_pages"][s] for p in per) for s in PAGE_STATES}


def pool_page_hwm_totals() -> dict:
    """penroz_pool_pages_hwm{state} gauge callback."""
    out: dict = {}
    for _, snap in _engine_snapshots():
        for s, n in snap["high_water_pages"].items():
            out[s] = out.get(s, 0) + n
    return out


def tenant_page_totals() -> dict:
    """penroz_tenant_kv_pages{tenant} gauge callback."""
    out: dict = {}
    for _, snap in _engine_snapshots():
        for t, n in snap["tenant_pages"].items():
            out[t] = out.get(t, 0) + n
    return out


def hbm_byte_totals() -> dict:
    """penroz_hbm_bytes{component} gauge callback."""
    return _byte_totals([snap for _, snap in _engine_snapshots()])


def min_time_to_exhaustion():
    """penroz_kv_time_to_exhaustion_s gauge callback: the most-pressed
    engine's estimate; None (absent series) when no engine has a burn
    rate."""
    ttes = [snap["time_to_exhaustion_s"] for _, snap in _engine_snapshots()
            if snap["time_to_exhaustion_s"] is not None]
    return min(ttes) if ttes else None


def reset():
    """Test hook: drop the flight-recorder ring (per-engine ledgers die with
    their engines via decode_scheduler.reset())."""
    FLIGHT_RECORDER.reset()
