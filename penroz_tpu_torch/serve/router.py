"""Front-of-house router over N engine replicas of one model (counterpart
of penroz_tpu/serve/router.py).

``PENROZ_SCHED_REPLICAS=N`` (N > 1) turns one (model, config) registry key
into a replica GROUP: N independent
:class:`~penroz_tpu_torch.serve.decode_scheduler.DecodeEngine` workers,
each with its own paged pool, radix prefix cache, worker thread and
circuit breaker, all on the one device.  The router is what
``decode_scheduler.get_engine`` hands back for the group; it has the
engine's ``submit``, so serve/app.py's request paths are unchanged.

Placement, in order:

1. **Prefix affinity**: a page-granularity fingerprint index maps prompt
   prefixes to the replica that served them last, the one whose radix
   cache holds those pages, so a repeated-prefix family lands where its
   KV already lives.  ``PENROZ_ROUTER_AFFINITY=0`` turns steering off;
   the index is bounded (``PENROZ_ROUTER_AFFINITY_INDEX`` entries, LRU).
   Fingerprints are over prompt tokens only, as in the JAX package, so an
   adapter request may be steered at a replica whose cache holds the same
   tokens under the base namespace: that costs a cache miss there, never
   a wrong page, because the radix cache keys pages by namespace.
2. **Half-open probes**: a replica whose breaker cooldown has passed is
   offered the next admission (the probe); its success closes the
   breaker, its failure re-arms the cooldown.
3. **Least-loaded within the request's class**: queued prompt TOKENS of
   ``req.priority`` first (``WFQueue.class_tokens``), then the class's
   queue depth, total load and replica index (deterministic placement).
4. Replicas still cooling down go last, so when the whole group is open
   the client gets the engine's own ``CircuitOpenError`` and Retry-After.

**Pipeline groups are one replica** (``PENROZ_SERVE_PIPE_STAGES=S``,
S >= 2): a stage-partitioned engine is still ONE ``DecodeEngine`` whose
stages run inside its tick loop, so the router places requests, counts
load and trips breakers per group.  A stage crash is that engine's crash:
its recovery rebuilds the whole group's cache (``_alloc_state``), and the
group's breaker decides when it takes traffic again.

Failover: a replica that refuses (breaker open, queue full, draining) is
skipped and the next candidate tried; the client sees an error only when
EVERY replica refuses.  A tenant-quota shed is re-raised at once: the
buckets are process-wide, so no sibling would answer differently.

**Disaggregated prefill** (``PENROZ_DISAGG_PREFILL=1``, the paged pool,
N >= 2): the first ``PENROZ_DISAGG_PREFILL_REPLICAS`` replicas (default 1,
at most N - 1) run prefill only.  Fresh admissions steer to them (an
affinity hit still wins); when one finishes a prompt it hands the request
to :meth:`EngineRouter._place_handoff`, which places the import on the
affinity-preferred decode replica and records that placement in the
fingerprint index.  Decode replicas are the monolithic fallback: if every
prefill replica refuses, or a hand-off fails, a decode replica runs the
request whole, greedy-identically.  With the flag off the roles, the sink
and the phase steering are absent.

**Elastic roles** (``PENROZ_DISAGG_ELASTIC=1``): :meth:`maybe_rebalance`,
on the submit path and held back by ``PENROZ_DISAGG_REBALANCE_COOLDOWN_MS``,
compares the prefill backlog (queued prompt tokens on prefill replicas)
with decode occupancy and asks one replica to flip role when the ratio
crosses ``PENROZ_DISAGG_REBALANCE_UP`` or falls under ``_DOWN``, within
``PENROZ_DISAGG_PREFILL_MIN``/``_MAX`` and at least one of each role.  The
engine applies the flip at a drain boundary; an affinity entry pointing at
a replica that became prefill-role ages out at lookup
(``outcome="stale_role"``).

**Session steering**: a prompt with no live affinity entry whose
whole-page prefix matches a hibernated session (serve/tierstore.py) is
steered at the replica that hibernated it, whose radix cache holds the
pages while the session is still in the hbm tier and often after
(``outcome="session_steer"``).  The steer is a hint: a home replica that
is breaker-open, draining, shut down or prefill-role is skipped
(``session_redirect``), and placement wakes the session elsewhere from
its host or disk blob.

Locks: the router's lock guards its index and counters only and is never
held while an engine's condition is taken, so a worker thread placing a
hand-off (``_place_handoff``) and a handler thread submitting cannot
deadlock.
"""

from __future__ import annotations

import collections
import logging
import math
import os
import threading
import time

from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.serve import decode_scheduler as ds
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.serve import qos, tierstore
from penroz_tpu_torch.serve.qos import TenantQuotaExceeded

log = logging.getLogger(__name__)

AFFINITY_ENV = "PENROZ_ROUTER_AFFINITY"
AFFINITY_INDEX_ENV = "PENROZ_ROUTER_AFFINITY_INDEX"
DISAGG_ENV = "PENROZ_DISAGG_PREFILL"
DISAGG_REPLICAS_ENV = "PENROZ_DISAGG_PREFILL_REPLICAS"
DISAGG_ELASTIC_ENV = "PENROZ_DISAGG_ELASTIC"
DISAGG_PREFILL_MIN_ENV = "PENROZ_DISAGG_PREFILL_MIN"
DISAGG_PREFILL_MAX_ENV = "PENROZ_DISAGG_PREFILL_MAX"
# Hysteresis over the prefill-backlog / decode-occupancy ratio: grow the
# prefill pool above UP, shrink it below DOWN; the cooldown bounds the
# flip rate outright.
REBALANCE_UP_ENV = "PENROZ_DISAGG_REBALANCE_UP"
REBALANCE_DOWN_ENV = "PENROZ_DISAGG_REBALANCE_DOWN"
REBALANCE_COOLDOWN_ENV = "PENROZ_DISAGG_REBALANCE_COOLDOWN_MS"


def _affinity_enabled() -> bool:
    return os.environ.get(AFFINITY_ENV, "1") != "0"


def _affinity_index_cap() -> int:
    return ds._env_int(AFFINITY_INDEX_ENV, 4096)


def _disagg_requested() -> bool:
    return os.environ.get(DISAGG_ENV, "0") == "1"


def _elastic_enabled() -> bool:
    return os.environ.get(DISAGG_ELASTIC_ENV, "0") == "1"


def _expected_roles(n: int) -> list:
    """The role of each replica of an N-replica group under the current
    environment.  Disaggregation needs one replica of each role and the
    paged pool (export and import read through the block table); anything
    else is the flat all-decode group, with a warning."""
    if not _disagg_requested():
        return ["decode"] * n
    if n < 2:
        log.warning("%s=1 needs PENROZ_SCHED_REPLICAS >= 2 (got %d); "
                    "disaggregation disabled", DISAGG_ENV, n)
        return ["decode"] * n
    if not KV.paged_enabled():
        log.warning("%s=1 needs PAGED_KV_CACHE=1 (page export and import "
                    "read through the block table); disaggregation "
                    "disabled", DISAGG_ENV)
        return ["decode"] * n
    k = min(max(1, ds._env_int(DISAGG_REPLICAS_ENV, 1)), n - 1)
    return ["prefill"] * k + ["decode"] * (n - k)


class EngineRouter:
    """One replica group's router.  Thread-safe: ``submit`` may be called
    from any number of handler threads at once, ``_place_handoff`` from the
    prefill replicas' workers."""

    def __init__(self, model_id, block_size, temperature, top_k, n: int,
                 device=None):
        self.model_id = model_id
        self.block_size = int(block_size)
        self.temperature = temperature
        self.top_k = top_k
        self.greedy = temperature is None or float(temperature) == 0.0
        key = ds._engine_key(model_id, block_size, temperature, top_k,
                             device)
        roles = _expected_roles(n)
        self.disagg = "prefill" in roles
        self.replicas: list = []
        for i in range(n):
            engine = ds.DecodeEngine(model_id, block_size, temperature,
                                     top_k, device=device, replica=i,
                                     role=roles[i])
            engine._router_owned = True
            if self.disagg:
                # on EVERY replica: an elastic flip can make any of them
                # prefill-role, and the engine exports only while it is
                engine._handoff_sink = self._place_handoff
            with ds._REG_LOCK:
                # the replicas live in the one engine registry under the
                # group key and their index: serving_stats, /memory/,
                # reset and drain_and_shutdown see them with no new
                # plumbing
                ds._ENGINES[key + (i,)] = engine
            self.replicas.append(engine)
        self._lock = threading.Lock()
        # prefix fingerprint -> replica index, LRU-bounded
        self._affinity: collections.OrderedDict = collections.OrderedDict()
        self.affinity_hits = 0
        self.affinity_misses = 0
        self.affinity_stale_roles = 0
        # hibernated-session wakes steered at their home replica, and those
        # redirected because the home could not take them
        self.session_steers = 0
        self.session_redirects = 0
        self.failovers = 0
        # elastic bookkeeping: the last flip request's time (cooldown; the
        # first flip waits for none, whenever the clock's origin) and the
        # flips asked for
        self._last_rebalance_t = -math.inf
        self.role_changes_requested = 0

    # -- prefix affinity ----------------------------------------------------

    def _fingerprints(self, prompt) -> list:
        """Rolling page-aligned prefix fingerprints, shortest first:
        ``fps[k-1]`` covers the prompt's first ``k`` full pages, the
        granularity at which the radix cache shares KV."""
        if not (_affinity_enabled() and KV.paged_enabled()
                and KV.prefix_cache_enabled()):
            return []
        page = KV.default_page_size()
        fps, h = [], 0
        for k in range(len(prompt) // page):
            h = hash((h, tuple(prompt[k * page:(k + 1) * page])))
            fps.append(h)
        return fps

    def _affinity_target(self, fps):
        """The replica that last served the deepest matching prefix.  Under
        disaggregation an entry pointing at a replica that has since become
        prefill-role is stale: it ages out here (``stale_role``) and the
        scan goes on to shorter prefixes."""
        with self._lock:
            for fp in reversed(fps):
                idx = self._affinity.get(fp)
                if idx is None:
                    continue
                if (self.disagg and idx < len(self.replicas)
                        and self.replicas[idx].role != "decode"):
                    del self._affinity[fp]
                    self.affinity_stale_roles += 1
                    serve_metrics.ROUTER_AFFINITY.inc(outcome="stale_role")
                    continue
                self._affinity.move_to_end(fp)
                return idx
        return None

    def _session_target(self, req):
        """The home replica of a hibernated session whose whole-page prefix
        the prompt matches (JAX ``_session_target``), or None.  A home that
        is shut down, draining, breaker-open or prefill-role is not
        steered at (a redirect): placement goes on, and the wake imports
        the session's blob wherever it lands.  The session's home is kept
        across a role flip (the replica may flip back)."""
        if not (KV.paged_enabled() and KV.prefix_cache_enabled()):
            return None
        rec = tierstore.TIERS.placement(req.prompt, model_id=self.model_id,
                                        page_size=KV.default_page_size())
        if rec is None or rec.replica is None:
            return None
        idx = int(rec.replica)
        if not 0 <= idx < len(self.replicas):
            return None
        e = self.replicas[idx]
        if (e._shutdown or e._draining or e._breaker_open
                or (self.disagg and e.role != "decode")):
            with self._lock:
                self.session_redirects += 1
            serve_metrics.ROUTER_AFFINITY.inc(outcome="session_redirect")
            return None
        with self._lock:
            self.session_steers += 1
        serve_metrics.ROUTER_AFFINITY.inc(outcome="session_steer")
        return idx

    def _remember(self, fps, idx: int):
        cap = _affinity_index_cap()
        with self._lock:
            for fp in fps:
                self._affinity[fp] = idx
                self._affinity.move_to_end(fp)
            while len(self._affinity) > cap:
                self._affinity.popitem(last=False)

    # -- placement ----------------------------------------------------------

    def _candidates(self, req, target, pool=None) -> list:
        """The replicas to try, in order (see the module docstring).
        ``pool`` restricts them (a hand-off places on decode replicas
        only).  Each replica's queue is read under its own condition, with
        the router's lock not held."""
        now = time.monotonic()
        cooldown_s = ds._breaker_cooldown_ms() / 1000.0
        healthy, probes, cooling = [], [], []
        for e in (self.replicas if pool is None else pool):
            if e._shutdown or e._draining:
                continue
            if e._breaker_open:
                if (now >= e._breaker_open_t + cooldown_s
                        and not e._probe_inflight):
                    probes.append(e)
                else:
                    cooling.append(e)
                continue
            healthy.append(e)

        def load(e):
            with e._cond:
                cls_tokens = e._pending.class_tokens(req.priority)
                cls_depth = e._pending.class_depth(req.priority)
                total = e.active_rows + len(e._pending)
            return (cls_tokens, cls_depth, total, e.replica)

        if self.disagg and pool is None:
            # phase steering: fresh admissions land on prefill replicas;
            # healthy decode replicas follow as the monolithic fallback
            healthy.sort(key=lambda e: (0 if e.role == "prefill" else 1,
                                        *load(e)))
        else:
            healthy.sort(key=load)
        order = []
        if target is not None and target < len(self.replicas):
            te = self.replicas[target]
            if te in healthy:
                healthy.remove(te)
                order.append(te)
        return order + probes + healthy + cooling

    def _try_order(self, req, order):
        """Submit to the first replica of ``order`` that accepts; returns
        it.  Raises the last refusal when every one refuses."""
        last_exc = None
        for pos, engine in enumerate(order):
            try:
                engine.submit(req)
            except TenantQuotaExceeded:
                raise   # process-wide buckets: every sibling says the same
            except RuntimeError as exc:
                # CircuitOpenError, QueueFullError, a draining replica:
                # refusals at the door, the request never started
                last_exc = exc
                if pos + 1 < len(order):
                    with self._lock:
                        self.failovers += 1
                    serve_metrics.ROUTER_FAILOVERS.inc()
                continue
            return engine
        raise last_exc

    # -- elastic roles ------------------------------------------------------

    @staticmethod
    def _role_of(e) -> str:
        """The role that counts for rebalancing: a pending flip counts as
        applied, so one burst cannot stack flips on several replicas."""
        return e._requested_role or e.role

    @staticmethod
    def _queued_tokens(e) -> int:
        with e._cond:
            return sum(e._pending.class_tokens(c) for c in qos.PRIORITIES)

    def maybe_rebalance(self):
        """Elastic prefill/decode split: ask ONE replica to flip role when
        the prefill backlog over decode occupancy crosses a threshold
        (grow the prefill pool on a burst, hand replicas back to decode as
        it drains), within the bounds and one of each role.  The engine
        applies the flip at its next drain boundary.  Returns the engine a
        flip was requested on, or None."""
        if not (self.disagg and _elastic_enabled()):
            return None
        now = time.monotonic()
        cooldown_s = ds._env_float(REBALANCE_COOLDOWN_ENV, 2000.0) / 1000.0
        with self._lock:
            if now - self._last_rebalance_t < cooldown_s:
                return None
        live = [e for e in self.replicas if not e._shutdown]
        prefill = [e for e in live if self._role_of(e) == "prefill"]
        decode = [e for e in live if self._role_of(e) == "decode"]
        if not prefill or not decode:
            return None
        backlog = sum(self._queued_tokens(e) for e in prefill)
        occ = (sum(e.active_rows for e in decode)
               / max(1, sum(e.capacity for e in decode)))
        # the floor keeps an idle decode pool from dividing by zero (any
        # backlog over idle decode replicas is extreme prefill pressure)
        ratio = backlog / max(occ, 1e-3)
        up = ds._env_float(REBALANCE_UP_ENV, 4096.0)
        down = ds._env_float(REBALANCE_DOWN_ENV, 64.0)
        n = len(live)
        lo = min(max(1, ds._env_int(DISAGG_PREFILL_MIN_ENV, 1)), n - 1)
        hi = min(max(lo, ds._env_int(DISAGG_PREFILL_MAX_ENV, n - 1)), n - 1)
        victim, target = None, None
        if ratio > up and len(prefill) < hi and len(decode) > 1:
            # the least busy decode replica joins the prefill pool
            victim = min(decode, key=lambda e: (e.active_rows
                                                + len(e._pending),
                                                e.replica))
            target = "prefill"
        elif ratio < down and len(prefill) > lo:
            # the emptiest prefill replica goes back to decoding
            victim = min(prefill, key=lambda e: (len(e._pending), e.replica))
            target = "decode"
        if victim is None:
            return None
        with self._lock:
            self._last_rebalance_t = now
            self.role_changes_requested += 1
        log.info("router %s: elastic rebalance -> replica %d to %s "
                 "(backlog=%d tokens, decode occupancy=%.2f)",
                 self.model_id, victim.replica, target, backlog, occ)
        victim.request_role(target)
        return victim

    def submit(self, req):
        """Place ``req`` on a replica; raises only when every live replica
        refuses (the last refusal, its Retry-After intact)."""
        self.maybe_rebalance()
        fps = self._fingerprints(req.prompt)
        target = self._affinity_target(fps) if fps else None
        if target is None and fps:
            # no live affinity entry (evicted, or aged out by a role
            # flip): a hibernated session still knows its home
            target = self._session_target(req)
        order = self._candidates(req, target)
        if not order:
            raise RuntimeError("decode engine is shut down")
        engine = self._try_order(req, order)
        if fps:
            hit = target is not None and engine is self.replicas[target]
            with self._lock:
                if hit:
                    self.affinity_hits += 1
                else:
                    self.affinity_misses += 1
            serve_metrics.ROUTER_AFFINITY.inc(outcome="hit" if hit
                                              else "miss")
            if not (self.disagg and engine.role == "prefill"):
                # a prefill replica is a waypoint: the hand-off's decode
                # placement writes the index (_place_handoff)
                self._remember(fps, engine.replica)

    def _place_handoff(self, req):
        """Decode-side placement of a prefill replica's finished request:
        with ``req.handoff`` set the decode replica imports its pages, with
        it None (a failed hand-off) the request prefills there whole.  The
        affinity-preferred decode replica first, then the least loaded; a
        placement records fingerprint -> replica.  Raises when every decode
        replica refuses (the caller keeps the request)."""
        decode = [e for e in self.replicas if e.role == "decode"]
        fps = self._fingerprints(req.prompt)
        target = self._affinity_target(fps) if fps else None
        if target is not None and self.replicas[target].role != "decode":
            target = None
        order = self._candidates(req, target, pool=decode)
        if not order:
            raise RuntimeError("no decode replica accepting hand-offs")
        engine = self._try_order(req, order)
        if fps:
            self._remember(fps, engine.replica)


# ---------------------------------------------------------------------------
# Router registry (beside decode_scheduler._ENGINES, the same lifecycle)
# ---------------------------------------------------------------------------

_ROUTERS: dict = {}
_ROUTER_LOCK = threading.Lock()


def _roles_ok(router: EngineRouter, n: int) -> bool:
    """A cached router's roles still hold: exactly the expected startup
    split, or, under elastic disaggregation, any split the rebalancer
    drifted to (both roles still present)."""
    roles = [e.role for e in router.replicas]
    expected = _expected_roles(n)
    if roles == expected:
        return True
    return (_elastic_enabled() and router.disagg
            and "prefill" in expected
            and "prefill" in roles and "decode" in roles)


def get_router(model_id, block_size, temperature, top_k,
               device=None) -> EngineRouter:
    """Look up or create the replica group's router.  A router whose
    replica count no longer matches ``PENROZ_SCHED_REPLICAS``, whose roles
    no longer hold, or one of whose engines was shut down is rebuilt (its
    old engines go from the registry)."""
    n = ds._replicas()
    key = ds._engine_key(model_id, block_size, temperature, top_k, device)
    with _ROUTER_LOCK:
        router = _ROUTERS.get(key)
        if (router is not None and len(router.replicas) == n
                and _roles_ok(router, n)
                and not any(e._shutdown for e in router.replicas)):
            return router
        if router is not None:
            _retire(key, router)
        router = EngineRouter(model_id, block_size, temperature, top_k, n,
                              device=device)
        _ROUTERS[key] = router
        return router


def _retire(key, router: EngineRouter):
    """Drop a stale router's replicas from the engine registry and stop
    them (their pools and models must not outlive the group)."""
    with ds._REG_LOCK:
        for i, e in enumerate(router.replicas):
            if ds._ENGINES.get(key + (i,)) is e:
                del ds._ENGINES[key + (i,)]
    for e in router.replicas:
        e.shutdown(timeout=5.0)


def stats_totals() -> dict:
    """Cross-router totals for /serving_stats/ (``replicas`` counts live
    engines; 0: no router live)."""
    with _ROUTER_LOCK:
        routers = list(_ROUTERS.values())
    return {
        "replicas": sum(sum(1 for e in r.replicas if not e._shutdown)
                        for r in routers),
        "prefill_replicas": sum(
            sum(1 for e in r.replicas
                if not e._shutdown and e.role == "prefill")
            for r in routers),
        "affinity_hits": sum(r.affinity_hits for r in routers),
        "affinity_misses": sum(r.affinity_misses for r in routers),
        "failovers": sum(r.failovers for r in routers),
    }


def clear():
    """Drop every router (decode_scheduler.reset and drain_and_shutdown,
    which shut the engines themselves down)."""
    with _ROUTER_LOCK:
        _ROUTERS.clear()
