"""SLO-tiered multi-tenant QoS (counterpart of penroz_tpu/serve/qos.py):
priority classes, weighted fair admission, and per-tenant token-rate
quotas.

The two host-side policy pieces the scheduler composes into SLO
isolation:

- :class:`WFQueue` — the admission queue as per-``(tenant, class)``
  sub-queues drained by deficit-weighted round robin.  Each sub-queue earns
  ``weight(class)`` pops per scheduling round, so an interactive trickle
  keeps draining at its weighted share however deep a batch tenant's
  backlog grows.  Every mutation happens under the engine's condition lock
  (the class itself takes no lock).
- :class:`QuotaManager` — a token bucket per tenant id over *emitted +
  prefilled* tokens.  An exhausted bucket 429s that tenant's NEW admissions
  (with a refill-derived ``Retry-After``) while its in-flight rows run to
  completion; other tenants never see the shed.

Knobs::

    PENROZ_QOS_WEIGHTS             interactive:8,standard:4,batch:1
    PENROZ_QOS_MAX_QUEUE_<CLASS>   per-class queue bound (0 = unbounded)
    PENROZ_SCHED_MAX_QUEUE         aggregate bound (when no class bound)
    PENROZ_QOS_TENANT_TOKENS_PER_S default tenant token rate (0 = unlimited)
    PENROZ_QOS_PREEMPT             1 (default) = interactive arrivals may
                                   preempt lower-class rows (scheduler-side)

Per-tenant rate overrides arrive via ``PUT /tenants/{id}/quota`` and live
only in :data:`QUOTAS` (process state, not env).  Tenant identity is the
explicit ``tenant`` field when given, else the request's LoRA adapter id,
else ``"default"``.  A tenant's residency cap over the hibernated-session
tiers (serve/tierstore.py) is ``PENROZ_QOS_TENANT_TIER_MB`` (0, the
default, is unlimited), overridden by the ``tier_mb`` of that PUT.
"""

from __future__ import annotations

import collections
import math
import os
import threading
import time

PRIORITIES = ("interactive", "standard", "batch")
DEFAULT_PRIORITY = "standard"
DEFAULT_TENANT = "default"

WEIGHTS_ENV = "PENROZ_QOS_WEIGHTS"
_DEFAULT_WEIGHTS = {"interactive": 8, "standard": 4, "batch": 1}
CLASS_QUEUE_ENVS = {
    cls: f"PENROZ_QOS_MAX_QUEUE_{cls.upper()}" for cls in PRIORITIES}
TENANT_RATE_ENV = "PENROZ_QOS_TENANT_TOKENS_PER_S"
TENANT_TIER_ENV = "PENROZ_QOS_TENANT_TIER_MB"
PREEMPT_ENV = "PENROZ_QOS_PREEMPT"


def validate_priority(priority) -> str:
    if priority is None:
        return DEFAULT_PRIORITY
    if priority not in PRIORITIES:
        raise ValueError(
            f"priority must be one of {PRIORITIES}, got {priority!r}")
    return priority


def tenant_of(tenant, adapter=None) -> str:
    """Tenant identity: the explicit field, else the adapter id, else the
    shared default."""
    if tenant:
        return str(tenant)
    if adapter:
        return str(adapter)
    return DEFAULT_TENANT


def weights() -> dict:
    """Per-class DRR weights from ``PENROZ_QOS_WEIGHTS`` (unlisted classes
    keep their defaults; junk entries are ignored, never fatal — a typo in
    an env var must not take serving down)."""
    out = dict(_DEFAULT_WEIGHTS)
    spec = os.environ.get(WEIGHTS_ENV, "")
    for part in spec.split(","):
        part = part.strip()
        if not part or ":" not in part:
            continue
        cls, _, w = part.partition(":")
        cls = cls.strip()
        try:
            w = int(w)
        except ValueError:
            continue
        if cls in _DEFAULT_WEIGHTS and w >= 1:
            out[cls] = w
    return out


def class_queue_bound(cls: str) -> int | None:
    """Per-class queue bound, or None when only the aggregate bound (the
    pre-QoS ``PENROZ_SCHED_MAX_QUEUE``) applies.  0 = explicitly unbounded."""
    raw = os.environ.get(CLASS_QUEUE_ENVS[cls])
    if raw is None:
        return None
    try:
        return max(0, int(raw))
    except ValueError:
        return None


def preempt_enabled() -> bool:
    return os.environ.get(PREEMPT_ENV, "1") == "1"


class WFQueue:
    """Per-(tenant, class) sub-queues drained by deficit round robin with
    unit cost: on each visit a sub-queue's deficit grows by its class
    weight and every pop spends 1, so over a full rotation each active
    sub-queue is served proportionally to its weight.  With only default
    traffic (one sub-queue) this degrades to the exact FIFO it replaced."""

    def __init__(self):
        self._queues: dict = {}          # (tenant, cls) -> deque[Request]
        self._active: list = []          # rotation order of non-empty keys
        self._deficits: dict = {}
        self._cursor = 0
        self._len = 0
        self._class_depth = collections.Counter()
        self._class_tokens = collections.Counter()

    def __len__(self) -> int:
        return self._len

    def __bool__(self) -> bool:
        return self._len > 0

    def class_depth(self, cls: str) -> int:
        return self._class_depth[cls]

    def class_tokens(self, cls: str) -> int:
        """Queued PROMPT tokens of ``cls``: the replica router's
        within-class load signal (one queued 100k-token prompt is more wait
        than five 20-token ones, which equal queue depths would deny)."""
        return self._class_tokens[cls]

    def class_depths(self) -> dict:
        return {cls: self._class_depth[cls] for cls in PRIORITIES}

    def tenant_depths(self) -> dict:
        """Queued requests per tenant (flight-recorder postmortems: WHOSE
        work was waiting when the engine died)."""
        depths: dict = {}
        for (tenant, _cls), dq in self._queues.items():
            if dq:
                depths[tenant] = depths.get(tenant, 0) + len(dq)
        return depths

    def _key(self, req):
        return (req.tenant, req.priority)

    def _activate(self, key):
        if key not in self._deficits:
            self._deficits[key] = 0
            self._active.append(key)

    def push(self, req) -> None:
        key = self._key(req)
        dq = self._queues.get(key)
        if dq is None:
            dq = self._queues[key] = collections.deque()
        dq.append(req)
        self._activate(key)
        self._len += 1
        self._class_depth[req.priority] += 1
        self._class_tokens[req.priority] += len(req.prompt)

    def push_front(self, req) -> None:
        """Head-requeue (preemption resume):
        the request must be the next one served from its sub-queue."""
        key = self._key(req)
        dq = self._queues.get(key)
        if dq is None:
            dq = self._queues[key] = collections.deque()
        dq.appendleft(req)
        self._activate(key)
        self._len += 1
        self._class_depth[req.priority] += 1
        self._class_tokens[req.priority] += len(req.prompt)

    def _retire_key(self, idx, key):
        self._active.pop(idx)
        self._deficits.pop(key, None)
        self._queues.pop(key, None)
        if self._cursor > idx:
            self._cursor -= 1

    def _take(self, idx, key):
        req = self._queues[key].popleft()
        self._len -= 1
        self._class_depth[req.priority] -= 1
        self._class_tokens[req.priority] -= len(req.prompt)
        if not self._queues[key]:
            self._retire_key(idx, key)
        return req

    def pop(self):
        """Next request by DRR order (None when empty)."""
        wts = None
        while self._active:
            if self._cursor >= len(self._active):
                self._cursor = 0
            key = self._active[self._cursor]
            if not self._queues.get(key):
                self._retire_key(self._cursor, key)
                continue
            if self._deficits[key] >= 1:
                self._deficits[key] -= 1
                return self._take(self._cursor, key)
            if wts is None:
                wts = weights()
            self._deficits[key] += wts.get(key[1], 1)
            self._cursor += 1
        return None

    def pop_class(self, cls: str):
        """Oldest queued request of ``cls`` across tenants (the preemption
        admit path pulls the waiting interactive request specifically —
        DRR order would happily hand the freed row to the flood)."""
        best_idx, best_key, best_t = None, None, None
        for idx, key in enumerate(self._active):
            if key[1] != cls:
                continue
            dq = self._queues.get(key)
            if not dq:
                continue
            t = dq[0].enqueue_t
            if best_t is None or t < best_t:
                best_idx, best_key, best_t = idx, key, t
        if best_key is None:
            return None
        return self._take(best_idx, best_key)

    def oldest_enqueue_t(self):
        """Earliest head-of-queue enqueue time (burst-coalescing probe)."""
        heads = [dq[0].enqueue_t for dq in self._queues.values() if dq]
        return min(heads) if heads else None

    def purge(self, should_drop) -> list:
        """Remove (and return, in FIFO order per sub-queue) every queued
        request for which ``should_drop(req)`` is true."""
        dropped = []
        for key in list(self._queues):
            dq = self._queues[key]
            keep = collections.deque()
            for req in dq:
                if should_drop(req):
                    dropped.append(req)
                    self._len -= 1
                    self._class_depth[req.priority] -= 1
                    self._class_tokens[req.priority] -= len(req.prompt)
                else:
                    keep.append(req)
            if keep:
                self._queues[key] = keep
            else:
                idx = self._active.index(key) if key in self._deficits else -1
                if idx >= 0:
                    self._retire_key(idx, key)
                else:
                    self._queues.pop(key, None)
        return dropped

    def drain(self) -> list:
        """Remove and return everything (engine failure path)."""
        out = []
        for key in list(self._queues):
            out.extend(self._queues[key])
        self._queues.clear()
        self._active.clear()
        self._deficits.clear()
        self._cursor = 0
        self._len = 0
        self._class_depth.clear()
        self._class_tokens.clear()
        return out

    def __iter__(self):
        for dq in self._queues.values():
            yield from dq


class TenantQuotaExceeded(RuntimeError):
    """Raised at submit when the tenant's token bucket is exhausted;
    carries the refill-derived ``Retry-After`` hint."""

    def __init__(self, tenant: str, retry_after: int):
        super().__init__(
            f"tenant {tenant!r} token quota exhausted; "
            f"retry in ~{retry_after}s")
        self.tenant = tenant
        self.retry_after = int(retry_after)


class _Bucket:
    __slots__ = ("tokens", "last")

    def __init__(self, tokens: float, last: float):
        self.tokens = tokens
        self.last = last


class QuotaManager:
    """Per-tenant token buckets over emitted + prefilled tokens.

    Rate 0 (the default) disables quota for that tenant entirely — no
    bucket state is even kept, so the pre-QoS deployment pays nothing.
    Burst capacity is one second of rate; :meth:`charge` may drive a
    bucket negative (in-flight rows finish their work), which simply
    extends the refill time the next admission's 429 reports."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buckets: dict[str, _Bucket] = {}
        self._overrides: dict[str, float] = {}
        self._tier_overrides: dict[str, float] = {}
        self.rejections = collections.Counter()   # tenant -> shed count
        self.charged = collections.Counter()      # tenant -> tokens charged

    def _env_rate(self) -> float:
        try:
            return max(0.0, float(os.environ.get(TENANT_RATE_ENV, "0")))
        except ValueError:
            return 0.0

    def rate_for(self, tenant: str) -> float:
        with self._lock:
            if tenant in self._overrides:
                return self._overrides[tenant]
        return self._env_rate()

    def set_rate(self, tenant: str, rate: float | None) -> None:
        """Admin override (``PUT /tenants/{id}/quota``); None clears it
        back to the env default."""
        with self._lock:
            if rate is None:
                self._overrides.pop(tenant, None)
            else:
                self._overrides[tenant] = max(0.0, float(rate))
            self._buckets.pop(tenant, None)   # re-seed at the new burst

    def overrides(self) -> dict:
        with self._lock:
            return dict(self._overrides)

    def _env_tier_mb(self) -> float:
        try:
            return max(0.0, float(os.environ.get(TENANT_TIER_ENV, "0")))
        except ValueError:
            return 0.0

    def tier_bytes_for(self, tenant: str) -> float:
        """The tenant's hibernated-KV residency cap in bytes (the tier
        store's admission); 0 is unlimited."""
        with self._lock:
            if tenant in self._tier_overrides:
                return self._tier_overrides[tenant] * 1e6
        return self._env_tier_mb() * 1e6

    def set_tier_mb(self, tenant: str, mb: float | None) -> None:
        """Override of the tier residency cap (``PUT /tenants/{id}/quota``);
        None clears it back to the environment's default."""
        with self._lock:
            if mb is None:
                self._tier_overrides.pop(tenant, None)
            else:
                self._tier_overrides[tenant] = max(0.0, float(mb))

    def tier_overrides(self) -> dict:
        with self._lock:
            return dict(self._tier_overrides)

    def _refill(self, tenant: str, rate: float, now: float) -> _Bucket:
        # Callers hold self._lock.
        burst = max(rate, 1.0)
        b = self._buckets.get(tenant)
        if b is None:
            b = self._buckets[tenant] = _Bucket(burst, now)
            return b
        b.tokens = min(burst, b.tokens + (now - b.last) * rate)
        b.last = now
        return b

    def admit(self, tenant: str, now: float | None = None) -> None:
        """Gate a new admission; raises :class:`TenantQuotaExceeded` when
        the bucket is non-positive.  In-flight work is never touched."""
        rate = self.rate_for(tenant)
        if rate <= 0:
            return
        if now is None:
            now = time.monotonic()
        with self._lock:
            b = self._refill(tenant, rate, now)
            if b.tokens > 0:
                return
            retry = max(1, math.ceil((1.0 - b.tokens) / rate))
            self.rejections[tenant] += 1
        raise TenantQuotaExceeded(tenant, min(retry, 60))

    def charge(self, tenant: str, n: int, now: float | None = None) -> None:
        """Debit ``n`` tokens (prefilled or emitted); may go negative."""
        if n <= 0:
            return
        rate = self.rate_for(tenant)
        if rate <= 0:
            return
        if now is None:
            now = time.monotonic()
        with self._lock:
            b = self._refill(tenant, rate, now)
            b.tokens -= n
            self.charged[tenant] += n

    def stats(self) -> dict:
        with self._lock:
            return {
                "overrides": dict(self._overrides),
                "tier_overrides": dict(self._tier_overrides),
                "rejections": dict(self.rejections),
                "charged": dict(self.charged),
            }

    def reset(self) -> None:
        with self._lock:
            self._buckets.clear()
            self._overrides.clear()
            self._tier_overrides.clear()
            self.rejections.clear()
            self.charged.clear()


QUOTAS = QuotaManager()


def reset() -> None:
    """Test hook: clear process-wide quota state."""
    QUOTAS.reset()
