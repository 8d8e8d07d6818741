"""Hierarchical KV tier store: session hibernation below the radix cache
(counterpart of penroz_tpu/serve/tierstore.py).

The radix prefix cache (ops/kv_cache.py) keeps whole-page KV of recent
prompts in a reserved region of the paged pool; device memory is the
scarcest tier, and chat traffic is many sessions idle between turns.  This
module adds two tiers under it:

    radix cache (device)  ->  host-RAM blobs  ->  disk blobs
                              (PENROZ_TIER_HOST_MB,  (PENROZ_TIER_DISK_PATH,
                               default 64)            PENROZ_TIER_DISK_MB,
                                                      default 256)

A hibernated session's life (serve/decode_scheduler.py drives it):

1. **Hibernate**: a retirement carrying a ``session_id`` inserts the row's
   prompt and generated tokens into the radix cache and pins the chain
   under a hold (the ledger's ``hibernating`` pages); registration here is
   host bookkeeping, the retirement exports nothing.
2. **Demote**: the engine's worker, at its loop tail, exports one pending
   session's pages to a host blob (``export_pages``), unpins the hold (the
   pages stay in the radix cache, evictable) and the tier becomes
   ``host``.  Past the host cap the least recently used host blobs spill
   to disk (the CRC container of utils/checkpoint.py); past the disk cap
   the least recently used sessions are dropped.
3. **Promote on match**: an admission whose prompt's page fingerprints hit
   a session imports the blob's pages into fresh radix slots
   (``import_pages``) and aliases them like a radix hit; the rest of the
   prompt chunk-prefills.  Matching is by content, so no ``session_id``
   is needed to wake, and a session wakes on any replica and, from the
   disk tier, after ``decode_scheduler.reset()``.

The store is process-wide: every engine and replica registers into and
promotes from it.  A session carries its model's checkpoint stamp; after a
reload it is dropped at match time, never served.  A disk blob that fails
its CRC is a miss (``penroz_tier_corrupt_blobs_total``) and the admission
recomputes.  A tenant's residency cap (``PENROZ_QOS_TENANT_TIER_MB``, or a
``PUT /tenants/{id}/quota`` override) evicts that tenant's oldest sessions
first and refuses a session that cannot fit alone.

Durability: with ``PENROZ_JOURNAL_PATH`` set (serve/journal.py) every
register, demote, promote and drop appends a record, and :meth:`recover`
(once, when the app is created) replays the journal, checks each disk
session's blob header and model stamp, re-admits what passes, applies the
journaled quota overrides and sweeps unreferenced blobs and torn
temporary files.  Device and host copies die with the process; only the
disk tier outlives it.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

HOST_MB_ENV = "PENROZ_TIER_HOST_MB"
DISK_MB_ENV = "PENROZ_TIER_DISK_MB"

_DEFAULT_HOST_MB = 64.0
_DEFAULT_DISK_MB = 256.0

TIERS_ALL = ("hbm", "host", "disk")

#: Promotion outcomes (the ``penroz_tier_promotions_total`` outcome label
#: values): ``ok`` full wake, ``partial`` radix alloc exhausted mid-import,
#: ``stale`` model stamp changed since hibernation, ``corrupt`` disk blob
#: failed CRC, ``miss`` blob vanished.
OUTCOMES = ("ok", "partial", "stale", "corrupt", "miss")


def _env_mb(name: str, default: float) -> float:
    try:
        return max(0.0, float(os.environ.get(name, default)))
    except ValueError:
        return float(default)


def host_cap_bytes() -> int:
    return int(_env_mb(HOST_MB_ENV, _DEFAULT_HOST_MB) * 1e6)


def disk_cap_bytes() -> int:
    return int(_env_mb(DISK_MB_ENV, _DEFAULT_DISK_MB) * 1e6)


class _Session:
    """One hibernated session's residency record.  ``tier`` names the
    DEEPEST copy ("hbm" = pinned radix pages awaiting demotion, "host" =
    blob in the host cache, "disk" = blob on disk); the radix cache may
    still hold the pages after demotion, which just makes resume cheaper.
    ``owner`` identifies the engine holding the pinned pages while tier
    is "hbm" (``id(engine)``) — a crash/reset of that engine drops the
    record via :meth:`TierStore.drop_owner` because the pages died with
    the pool."""

    __slots__ = ("session_id", "tenant", "model_id", "model_stamp",
                 "tokens", "kv_len", "page_size", "quantized", "nbytes",
                 "tier", "owner", "replica", "created", "last_use", "fps")

    def __init__(self, session_id, tenant, model_id, model_stamp, tokens,
                 kv_len, page_size, quantized, nbytes, owner, replica, fps):
        self.session_id = session_id
        self.tenant = tenant
        self.model_id = model_id
        self.model_stamp = model_stamp
        self.tokens = tokens
        self.kv_len = int(kv_len)
        self.page_size = int(page_size)
        self.quantized = bool(quantized)
        self.nbytes = int(nbytes)
        self.tier = "hbm"
        self.owner = owner
        self.replica = replica
        self.created = time.time()
        self.last_use = self.created
        self.fps = fps

    @property
    def pages(self) -> int:
        return self.kv_len // self.page_size


def _fingerprints(tokens, page_size: int, max_pages: int) -> list:
    """Rolling page-aligned prefix fingerprints, shortest first —
    ``fps[k-1]`` covers the first ``k`` full pages.  Same hash chain as
    the router's affinity index (serve/router.py), so both indexes agree
    on what "the same prefix" means."""
    fps, h = [], 0
    for k in range(min(max_pages, len(tokens) // page_size)):
        h = hash((h, tuple(int(t) for t in
                           tokens[k * page_size:(k + 1) * page_size])))
        fps.append(h)
    return fps


class TierStore:
    """Process-wide registry of hibernated sessions + the host/disk blob
    tiers.  Thread-safe: engine workers (register/demote/promote) and API
    threads (list/delete) interleave freely.  Holds no engine references
    — engines push state in and look content up, so the store survives
    any engine's crash, reload, or ``decode_scheduler.reset()``."""

    def __init__(self):
        self._lock = threading.RLock()
        # session_id -> _Session, LRU order (move_to_end on touch)
        self._sessions: collections.OrderedDict = collections.OrderedDict()
        # session_id -> host-tier blob dict (pinned host RAM)
        self._host: dict = {}
        # (model_id, page_size, quantized, fp) -> {session_id: depth}
        # One entry per covered page depth per session: a prompt that
        # agrees with a session for only k of its pages still finds it.
        self._index: dict = {}
        self.hibernated = 0              # lifetime registrations
        self.demotions = collections.Counter()    # tier -> count
        self.promotions = collections.Counter()   # (tier, outcome) -> count
        self.corrupt_blobs = 0
        self.drops = collections.Counter()        # reason -> count
        self.last_recovery: dict = {}    # recover() summary (startup)
        self._replaying = False          # recover() must not re-journal

    # -- write-ahead journal --------------------------------------------------

    def _journal(self, kind: str, **fields):
        """Best-effort WAL append for one registry mutation (no-op while
        the journal is disabled or recovery itself is replaying)."""
        from penroz_tpu_torch.serve import journal
        if self._replaying or not journal.JOURNAL.enabled():
            return
        journal.JOURNAL.append(kind, **fields)

    def _maybe_compact_locked(self):
        from penroz_tpu_torch.serve import journal
        if self._replaying:
            return
        # Cheap live-count upper bound first; the snapshot walk only runs
        # when the dead ratio actually trips.
        if journal.JOURNAL.should_compact(self._live_record_count_locked()):
            journal.JOURNAL.compact(self._snapshot_records_locked())

    def _live_record_count_locked(self) -> int:
        from penroz_tpu_torch.serve import qos
        return (len(self._sessions) + len(qos.QUOTAS.overrides())
                + len(qos.QUOTAS.tier_overrides()))

    def _snapshot_records_locked(self) -> list:
        """The current registry + override state as journal records — what
        compaction rewrites the log down to.  Adapter registrations are
        re-derived from their (already durable) checkpoints."""
        from penroz_tpu_torch.serve import qos
        from penroz_tpu_torch.utils import checkpoint
        recs = []
        for r in self._sessions.values():
            recs.append({"t": "register", "ts": r.created,
                         "session_id": r.session_id, "tenant": r.tenant,
                         "model_id": r.model_id,
                         "model_stamp": r.model_stamp,
                         "tokens": [int(t) for t in r.tokens],
                         "kv_len": r.kv_len, "page_size": r.page_size,
                         "quantized": r.quantized, "nbytes": r.nbytes,
                         "replica": r.replica, "tier": r.tier})
        now = time.time()
        for tenant, rate in qos.QUOTAS.overrides().items():
            recs.append({"t": "quota", "ts": now, "tenant": tenant,
                         "rate": rate})
        for tenant, mb in qos.QUOTAS.tier_overrides().items():
            recs.append({"t": "quota", "ts": now, "tenant": tenant,
                         "tier_mb": mb})
        for aid in checkpoint.list_adapter_ids():
            recs.append({"t": "adapter", "ts": now, "adapter_id": aid})
        return recs

    # -- registration / demotion --------------------------------------------

    def _index_add(self, rec: _Session):
        for depth, fp in enumerate(rec.fps, start=1):
            key = (rec.model_id, rec.page_size, rec.quantized, fp)
            self._index.setdefault(key, {})[rec.session_id] = depth

    def _index_remove(self, rec: _Session):
        for fp in rec.fps:
            key = (rec.model_id, rec.page_size, rec.quantized, fp)
            bucket = self._index.get(key)
            if bucket is not None:
                bucket.pop(rec.session_id, None)
                if not bucket:
                    del self._index[key]

    def _tenant_bytes_locked(self, tenant: str) -> int:
        return sum(r.nbytes for r in self._sessions.values()
                   if r.tenant == tenant)

    def register(self, session_id: str, *, tenant, model_id, model_stamp,
                 tokens, kv_len, page_size, quantized, nbytes, owner,
                 replica) -> bool:
        """Record a freshly hibernated session (tier "hbm": the engine
        still holds its pinned radix pages).  Re-registering an existing
        ``session_id`` replaces it — a multi-turn session's next
        retirement supersedes the previous hibernation.  Enforces the
        tenant's tier quota by evicting that tenant's LRU sessions;
        returns False (nothing registered) when even that cannot fit the
        new session."""
        from penroz_tpu_torch.serve import qos
        tokens = tuple(int(t) for t in tokens)
        pages = int(kv_len) // int(page_size)
        if pages < 1:
            return False
        fps = _fingerprints(tokens, int(page_size), pages)
        with self._lock:
            old = self._sessions.get(session_id)
            if old is not None:
                self._drop_locked(old, "replaced")
            cap = qos.QUOTAS.tier_bytes_for(tenant)
            if cap > 0:
                if int(nbytes) > cap:
                    self.drops["quota_refused"] += 1
                    return False
                while (self._tenant_bytes_locked(tenant) + int(nbytes) > cap):
                    victim = next((r for r in self._sessions.values()
                                   if r.tenant == tenant), None)
                    if victim is None:
                        break
                    self._drop_locked(victim, "quota")
            rec = _Session(session_id, tenant, model_id, model_stamp,
                           tokens, kv_len, page_size, quantized, nbytes,
                           owner, replica, fps)
            self._sessions[session_id] = rec
            self._index_add(rec)
            self.hibernated += 1
            self._journal("register", session_id=session_id, tenant=tenant,
                          model_id=model_id, model_stamp=model_stamp,
                          tokens=[int(t) for t in tokens],
                          kv_len=int(kv_len), page_size=int(page_size),
                          quantized=bool(quantized), nbytes=int(nbytes),
                          replica=replica)
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.SESSIONS_HIBERNATED.inc()
        return True

    def demote_to_host(self, session_id: str, blob: dict) -> bool:
        """Land a demoted session's blob in the host tier (the engine
        worker just ran ``export_pages`` off the hot path) and rebalance
        the lower tiers: host-cap overflow spills LRU host blobs to disk,
        disk-cap overflow drops LRU disk sessions."""
        from penroz_tpu_torch.serve import metrics as serve_metrics
        from penroz_tpu_torch.utils import checkpoint
        with self._lock:
            rec = self._sessions.get(session_id)
            if rec is None or rec.tier != "hbm":
                return False
            rec.tier = "host"
            rec.owner = None
            rec.nbytes = checkpoint.page_blob_nbytes(blob)
            self._host[session_id] = blob
            self.demotions["host"] += 1
            serve_metrics.TIER_DEMOTIONS.inc(tier="host")
            self._journal("demote", session_id=session_id, tier="host",
                          nbytes=rec.nbytes)
            self._enforce_caps_locked()
        return True

    def _tier_bytes_locked(self, tier: str) -> int:
        return sum(r.nbytes for r in self._sessions.values()
                   if r.tier == tier)

    def _lru_locked(self, tier: str):
        return next((r for r in self._sessions.values() if r.tier == tier),
                    None)

    def _enforce_caps_locked(self):
        from penroz_tpu_torch.serve import metrics as serve_metrics
        from penroz_tpu_torch.utils import checkpoint
        host_cap = host_cap_bytes()
        while self._tier_bytes_locked("host") > host_cap:
            rec = self._lru_locked("host")
            if rec is None:
                break
            blob = self._host.pop(rec.session_id)
            try:
                checkpoint.save_tier_blob(rec.session_id, blob)
            except OSError:
                log.warning("disk-tier write failed; dropping session %s",
                            rec.session_id, exc_info=True)
                self._drop_locked(rec, "disk_write_failed")
                continue
            rec.tier = "disk"
            rec.nbytes = checkpoint.tier_blob_nbytes(rec.session_id)
            self.demotions["disk"] += 1
            serve_metrics.TIER_DEMOTIONS.inc(tier="disk")
            self._journal("demote", session_id=rec.session_id, tier="disk",
                          nbytes=rec.nbytes)
        disk_cap = disk_cap_bytes()
        while self._tier_bytes_locked("disk") > disk_cap:
            rec = self._lru_locked("disk")
            if rec is None:
                break
            self._drop_locked(rec, "disk_cap")

    # -- lookup / promotion --------------------------------------------------

    def match(self, tokens, *, model_id, model_stamp, page_size, quantized,
              min_pages: int = 1):
        """Deepest hibernated session agreeing with ``tokens``' whole-page
        prefix: returns ``(record, depth_pages)`` or ``(None, 0)``.  The
        usable token count is capped at ``len(tokens) - 1`` (the radix
        match rule: one real token must remain to produce first-sample
        logits).  Sessions hibernated under a different model stamp
        (weights reloaded since) are dropped on sight — stale KV is never
        served.  Fingerprint candidates are verified token-for-token, so
        a hash collision degrades to a miss, not a wrong alias."""
        if not self._sessions:
            return None, 0
        P = int(page_size)
        max_pages = max(0, (len(tokens) - 1) // P)
        if max_pages < min_pages:
            return None, 0
        toks = tuple(int(t) for t in tokens)
        fps = _fingerprints(toks, P, max_pages)
        with self._lock:
            for depth in range(len(fps), max(0, min_pages - 1), -1):
                key = (model_id, P, bool(quantized), fps[depth - 1])
                bucket = self._index.get(key)
                if not bucket:
                    continue
                for sid in list(bucket):
                    rec = self._sessions.get(sid)
                    if rec is None:
                        bucket.pop(sid, None)
                        continue
                    if rec.model_stamp != model_stamp:
                        self.note_promotion(rec.tier, "stale")
                        self._drop_locked(rec, "stale_model")
                        continue
                    span = depth * P
                    if rec.kv_len >= span and rec.tokens[:span] == toks[:span]:
                        self.touch(sid)
                        self._journal("promote", session_id=sid,
                                      tier=rec.tier, depth=depth)
                        return rec, depth
            return None, 0

    def placement(self, tokens, *, model_id, page_size: int):
        """Router-side placement hint: the deepest token-verified resident
        session for ``tokens``' whole-page prefix, with NO side effects —
        no LRU touch, no promotion counters, no stamp fence (the router
        does not know each replica's checkpoint stamp; the engine-side
        promote still enforces it).  Both quantization variants are
        scanned — steering is per-model, not per-pool-layout.  Returns
        the record or None."""
        P = int(page_size)
        max_pages = max(0, (len(tokens) - 1) // P)
        if max_pages < 1 or not self._sessions:
            return None
        toks = tuple(int(t) for t in tokens)
        fps = _fingerprints(toks, P, max_pages)
        with self._lock:
            for depth in range(len(fps), 0, -1):
                for quantized in (False, True):
                    key = (model_id, P, quantized, fps[depth - 1])
                    bucket = self._index.get(key)
                    if not bucket:
                        continue
                    span = depth * P
                    for sid in bucket:
                        rec = self._sessions.get(sid)
                        if (rec is not None and rec.kv_len >= span
                                and rec.tokens[:span] == toks[:span]):
                            return rec
            return None

    def fetch(self, session_id: str):
        """The session's blob for promotion, or None (with the record
        dropped and the corrupt/miss counters bumped) when the copy is
        unreadable.  Tier "hbm" has no blob yet — the pages only exist in
        the owning engine's radix cache — so a cross-replica wake before
        demotion completes is also a None (the caller recomputes)."""
        from penroz_tpu_torch.serve import metrics as serve_metrics
        from penroz_tpu_torch.utils import checkpoint
        with self._lock:
            rec = self._sessions.get(session_id)
            if rec is None:
                return None
            if rec.tier == "hbm":
                return None
            if rec.tier == "host":
                return self._host.get(session_id)
            try:
                return checkpoint.load_tier_blob(session_id)
            except ValueError:
                self.corrupt_blobs += 1
                serve_metrics.TIER_CORRUPT.inc()
                self.note_promotion("disk", "corrupt")
                self._drop_locked(rec, "corrupt")
                return None
            except KeyError:
                self.note_promotion("disk", "miss")
                self._drop_locked(rec, "blob_missing")
                return None

    def note_promotion(self, tier: str, outcome: str):
        from penroz_tpu_torch.serve import metrics as serve_metrics
        with self._lock:
            self.promotions[(tier, outcome)] += 1
        serve_metrics.TIER_PROMOTIONS.inc(tier=tier, outcome=outcome)

    def touch(self, session_id: str):
        with self._lock:
            rec = self._sessions.get(session_id)
            if rec is not None:
                rec.last_use = time.time()
                self._sessions.move_to_end(session_id)

    # -- removal -------------------------------------------------------------

    def _drop_locked(self, rec: _Session, reason: str):
        from penroz_tpu_torch.utils import checkpoint
        self._sessions.pop(rec.session_id, None)
        self._host.pop(rec.session_id, None)
        if rec.tier == "disk":
            checkpoint.delete_tier_blob(rec.session_id)
        self._index_remove(rec)
        self.drops[reason] += 1
        self._journal("drop", session_id=rec.session_id, reason=reason)
        self._maybe_compact_locked()

    def drop(self, session_id: str, reason: str = "api") -> bool:
        """Evict one session from every tier (``DELETE /sessions/{id}``).
        A tier-"hbm" record's pinned pages are released by the owning
        engine when its demotion queue reaches the now-unregistered id."""
        with self._lock:
            rec = self._sessions.get(session_id)
            if rec is None:
                return False
            self._drop_locked(rec, reason)
            return True

    def drop_owner(self, owner, reason: str = "engine_reset") -> int:
        """Drop every tier-"hbm" session pinned by engine ``owner`` — its
        pool (and the pinned pages) just died in a crash-recovery
        reallocation, reload, or shutdown.  Host/disk-tier sessions
        survive: their bytes left HBM already."""
        with self._lock:
            victims = [r for r in self._sessions.values()
                       if r.tier == "hbm" and r.owner == owner]
            for rec in victims:
                self._drop_locked(rec, reason)
            return len(victims)

    # -- restart recovery ----------------------------------------------------

    def recover(self) -> dict:
        """Rebuild the registry after a process restart: replay the
        journal into final per-session states, cross-check the survivors
        against the disk tier (blob exists + container header validates
        + model stamp is still current), re-admit what checks out, apply
        journaled quota overrides, and sweep everything unreferenced —
        orphan atomic-write temp files AND finished blobs no record
        claims.  Called once from ``create_app()`` before routes are
        built; idempotent and a cheap no-op when the journal is off.

        Only disk-tier sessions recover: HBM pages and the pinned
        host-RAM cache died with the process.  Recovered records carry
        ``owner=None, replica=None`` so the router's steer-to-home
        degrades to normal placement when the home replica no longer
        exists."""
        from penroz_tpu_torch.serve import journal
        from penroz_tpu_torch.serve import metrics as serve_metrics
        from penroz_tpu_torch.serve import qos
        from penroz_tpu_torch.utils import checkpoint
        t0 = time.monotonic()
        summary = {
            "journal_enabled": journal.JOURNAL.enabled(),
            "records_replayed": 0, "bad_records": 0, "truncated_bytes": 0,
            "replay_errors": 0, "sessions_recovered": 0,
            "sessions_volatile": 0, "sessions_stale": 0,
            "sessions_blob_missing": 0, "sessions_blob_corrupt": 0,
            "quota_overrides_replayed": 0, "adapter_records_seen": 0,
            "blobs_swept": 0, "temp_files_swept": 0, "replay_ms": 0.0,
        }
        records: list = []
        if journal.JOURNAL.enabled():
            # A SIGKILL mid-compaction can strand the rewrite temp.
            try:
                os.remove(f"{journal.journal_path()}.compact.tmp")
            except OSError:
                pass
            try:
                records = journal.JOURNAL.replay()
            except Exception:  # noqa: BLE001 — recovery must never crash startup
                summary["replay_errors"] += 1
                log.warning("journal replay failed; recovering to an "
                            "empty registry", exc_info=True)
            summary["records_replayed"] = len(records)
            summary["bad_records"] = journal.JOURNAL.bad_records
            summary["truncated_bytes"] = journal.JOURNAL.truncated_bytes
        # Fold the record stream into final per-session state (last write
        # wins; promote = LRU touch so recovered eviction order matches).
        finals: collections.OrderedDict = collections.OrderedDict()
        quota_rate: dict = {}
        quota_tier: dict = {}
        for rec in records:
            kind = rec.get("t")
            sid = rec.get("session_id")
            if kind == "register" and sid:
                finals.pop(sid, None)
                finals[sid] = dict(rec)
            elif kind == "demote" and sid in finals:
                finals[sid]["tier"] = rec.get("tier", "host")
                finals[sid]["nbytes"] = rec.get(
                    "nbytes", finals[sid].get("nbytes", 0))
            elif kind == "promote" and sid in finals:
                finals.move_to_end(sid)
            elif kind == "drop" and sid:
                finals.pop(sid, None)
            elif kind == "quota" and rec.get("tenant") is not None:
                if "rate" in rec:
                    quota_rate[rec["tenant"]] = rec["rate"]
                if "tier_mb" in rec:
                    quota_tier[rec["tenant"]] = rec["tier_mb"]
            elif kind == "adapter":
                summary["adapter_records_seen"] += 1
        with self._lock:
            self._replaying = True
            try:
                for sid, rec in finals.items():
                    if sid in self._sessions:
                        continue   # live (warm, in-process) record wins
                    if rec.get("tier", "hbm") != "disk":
                        summary["sessions_volatile"] += 1
                        continue
                    try:
                        self._recover_one_locked(rec, summary)
                    except Exception:  # noqa: BLE001 — skip, never crash
                        log.warning("could not recover session %r", sid,
                                    exc_info=True)
            finally:
                self._replaying = False
            referenced = [r.session_id for r in self._sessions.values()
                          if r.tier == "disk"]
        for tenant, rate in quota_rate.items():
            qos.QUOTAS.set_rate(tenant, rate)
            summary["quota_overrides_replayed"] += 1
        for tenant, mb in quota_tier.items():
            qos.QUOTAS.set_tier_mb(tenant, mb)
            summary["quota_overrides_replayed"] += 1
        # A failed replay means the reference set is unknown: sweep only
        # the (always-safe) atomic-write temps, never finished blobs —
        # a transient replay error must not destroy recoverable sessions.
        summary.update(checkpoint.sweep_tier_orphans(
            None if summary["replay_errors"] else referenced))
        if summary["sessions_recovered"]:
            serve_metrics.SESSIONS_RECOVERED.inc(
                summary["sessions_recovered"])
        summary["replay_ms"] = round((time.monotonic() - t0) * 1000.0, 3)
        self.last_recovery = summary
        with self._lock:
            self._maybe_compact_locked()
        if summary["sessions_recovered"] or summary["bad_records"]:
            log.info("restart recovery: %(sessions_recovered)d session(s) "
                     "restored, %(sessions_stale)d stale, "
                     "%(sessions_blob_missing)d missing, "
                     "%(sessions_blob_corrupt)d corrupt, "
                     "%(bad_records)d bad journal record(s) "
                     "(%(truncated_bytes)d torn bytes)", summary)
        return summary

    def _recover_one_locked(self, rec: dict, summary: dict):
        """Admit one journal-final disk-tier session if its blob and
        model stamp survive scrutiny (caller holds the lock with
        ``_replaying`` set; counted drops here re-journal explicitly so
        the next replay skips them)."""
        from penroz_tpu_torch.serve import journal
        from penroz_tpu_torch.utils import checkpoint
        sid = rec["session_id"]

        def _dead(counter: str, reason: str, delete_blob: bool):
            summary[counter] += 1
            if delete_blob:
                checkpoint.delete_tier_blob(sid)
            self.drops[reason] += 1
            if journal.JOURNAL.enabled():
                journal.JOURNAL.append("drop", session_id=sid, reason=reason)

        if not os.path.exists(checkpoint.tier_blob_path(sid)):
            _dead("sessions_blob_missing", "recover_blob_missing", False)
            return
        if not checkpoint.validate_tier_blob(sid):
            self.corrupt_blobs += 1
            _dead("sessions_blob_corrupt", "recover_blob_corrupt", True)
            return
        model_id = rec.get("model_id")
        try:
            current_stamp = os.path.getmtime(
                checkpoint.source_path(model_id))
        except OSError:
            current_stamp = None
        if current_stamp is None or rec.get("model_stamp") != current_stamp:
            _dead("sessions_stale", "recover_stale_model", True)
            return
        tokens = tuple(int(t) for t in rec.get("tokens", ()))
        kv_len = int(rec.get("kv_len", 0))
        page_size = int(rec.get("page_size", 0) or 0)
        if page_size < 1 or kv_len // page_size < 1:
            _dead("sessions_blob_corrupt", "recover_bad_record", True)
            return
        fps = _fingerprints(tokens, page_size, kv_len // page_size)
        sess = _Session(sid, rec.get("tenant"), model_id,
                        rec.get("model_stamp"), tokens, kv_len, page_size,
                        rec.get("quantized", False),
                        checkpoint.tier_blob_nbytes(sid), None, None, fps)
        sess.tier = "disk"
        sess.created = float(rec.get("ts") or sess.created)
        self._sessions[sid] = sess
        self._index_add(sess)
        summary["sessions_recovered"] += 1

    # -- introspection -------------------------------------------------------

    def get(self, session_id: str):
        with self._lock:
            return self._sessions.get(session_id)

    def resident_sessions(self) -> int:
        return len(self._sessions)

    def sessions_by_tier(self) -> dict:
        with self._lock:
            out = {t: 0 for t in TIERS_ALL}
            for rec in self._sessions.values():
                out[rec.tier] += 1
            return out

    def pages_by_tier(self) -> dict:
        with self._lock:
            out = {t: 0 for t in TIERS_ALL}
            for rec in self._sessions.values():
                out[rec.tier] += rec.pages
            return out

    def tier_bytes(self) -> dict:
        """Bytes held OUTSIDE the paged pool, per lower tier (tier-"hbm"
        sessions live in pool pages the memledger already counts as
        ``hibernating``, so they are excluded here — no double count)."""
        with self._lock:
            return {"host_tier": self._tier_bytes_locked("host"),
                    "disk_tier": self._tier_bytes_locked("disk")}

    def list_sessions(self) -> list:
        now = time.time()
        with self._lock:
            return [{
                "session_id": r.session_id,
                "tenant": r.tenant,
                "model_id": r.model_id,
                "tier": r.tier,
                "tokens": r.kv_len,
                "pages": r.pages,
                "nbytes": r.nbytes,
                "replica": r.replica,
                "age_s": max(0.0, now - r.created),
                "idle_s": max(0.0, now - r.last_use),
            } for r in self._sessions.values()]

    def stats(self) -> dict:
        with self._lock:
            promos: collections.Counter = collections.Counter()
            for (_, outcome), n in self.promotions.items():
                promos[outcome] += n
            return {
                "sessions_resident": len(self._sessions),
                "sessions_by_tier": {t: sum(1 for r in self._sessions.values()
                                            if r.tier == t)
                                     for t in TIERS_ALL},
                "tier_bytes": {"host_tier": self._tier_bytes_locked("host"),
                               "disk_tier": self._tier_bytes_locked("disk")},
                "tier_promotions": {o: promos.get(o, 0) for o in OUTCOMES},
                "tier_demotions": {t: self.demotions.get(t, 0)
                                   for t in ("host", "disk")},
                "tier_corrupt_blobs": self.corrupt_blobs,
                "restart_recovery": dict(self.last_recovery),
            }

    def reset(self):
        """Test/bench hook: drop every session (disk files included) and
        zero the lifetime counters."""
        with self._lock:
            for rec in list(self._sessions.values()):
                self._drop_locked(rec, "reset")
            self._sessions.clear()
            self._host.clear()
            self._index.clear()
            self.hibernated = 0
            self.demotions.clear()
            self.promotions.clear()
            self.corrupt_blobs = 0
            self.drops.clear()
            self.last_recovery = {}
            self._replaying = False


TIERS = TierStore()


def reset() -> None:
    TIERS.reset()
