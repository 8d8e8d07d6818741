"""Serving-side LoRA adapter registry, the ``/adapters/`` surface
(counterpart of penroz_tpu/serve/adapters.py).

Between the adapter checkpoints on disk (utils/checkpoint.py) and the
engines' live slots (serve/decode_scheduler.py, models/lora.py):

- an LRU host cache of decoded adapter trees (``PENROZ_LORA_HOST_CACHE``
  entries, default 16): a popular adapter is read from its CRC-checked
  checkpoint once, not per request;
- refcount pins: a request holds its entry from admission to its last
  event, and a pinned entry is never evicted;
- load states: the first request for an uncached adapter loads it on its
  own thread; a concurrent request meanwhile gets
  :class:`AdapterLoadingError` (HTTP 409 naming the adapter), an unknown
  or unloadable one a ValueError (HTTP 400 naming it);
- generation uids: each load gets a fresh ``uid``; engines key slot reuse
  and the radix prefix-cache namespace on it, so a retrained or recreated
  adapter under the same id never serves stale factors or aliases the
  pages its previous generation wrote;
- the ``lora.load`` fault site (utils/faults.py) before every load.

``DELETE /adapters/`` and adapter training drop an entry; ``DELETE
/model/`` and an engine's model reload flush every adapter of the model.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading

from penroz_tpu_torch.utils import checkpoint, faults

log = logging.getLogger(__name__)

HOST_CACHE_ENV = "PENROZ_LORA_HOST_CACHE"


class AdapterLoadingError(RuntimeError):
    """Another request is loading this adapter (HTTP 409)."""


def _host_cache() -> int:
    try:
        return max(1, int(os.environ.get(HOST_CACHE_ENV, "16")))
    except ValueError:
        log.warning("Unparseable %s=%r; using default 16", HOST_CACHE_ENV,
                    os.environ.get(HOST_CACHE_ENV))
        return 16


class AdapterEntry:
    """One cached adapter generation, immutable once loaded: ``params``
    maps ``<prefix>.lora_A``/``lora_B`` to fp32 CPU tensors."""

    __slots__ = ("adapter_id", "model_id", "config", "params", "uid",
                 "state", "refs", "last_use")

    def __init__(self, adapter_id: str, uid: int):
        self.adapter_id = adapter_id
        self.model_id = None
        self.config = None
        self.params = None
        self.uid = uid
        self.state = "loading"
        self.refs = 0
        self.last_use = 0


class AdapterRegistry:
    def __init__(self):
        self._entries: dict[str, AdapterEntry] = {}
        self._lock = threading.Lock()
        self._uid = itertools.count(1)
        self._clock = itertools.count(1)

    # -- the request path ---------------------------------------------------

    def acquire(self, adapter_id: str,
                model_id: str | None = None) -> AdapterEntry:
        """Pin and return the adapter's entry, loading its checkpoint on a
        miss (disk I/O: call it on a request thread).  ValueError for an
        unknown, mismatched or unloadable adapter (HTTP 400 naming it);
        :class:`AdapterLoadingError` while another caller loads it (409)."""
        with self._lock:
            entry = self._entries.get(adapter_id)
            if entry is not None and entry.state == "ready":
                self._check_model(entry, model_id)
                entry.refs += 1
                entry.last_use = next(self._clock)
                return entry
            if entry is not None:
                raise AdapterLoadingError(
                    f"adapter {adapter_id!r} is still loading; retry "
                    f"shortly")
            entry = self._entries[adapter_id] = AdapterEntry(
                adapter_id, next(self._uid))
        try:
            faults.check("lora.load")
            blob = checkpoint.load_adapter(adapter_id)
            entry.model_id = blob.get("model_id")
            entry.config = blob.get("config") or {}
            entry.params = dict(blob.get("params") or {})
            if not entry.params:
                raise ValueError("checkpoint holds no adapter params")
            from penroz_tpu_torch.models import lora
            rank = int(entry.config.get("rank") or 0)
            if rank > lora.max_rank():
                # refused here (a typed 400), not in the engine's tick: the
                # pack pads ranks to PENROZ_LORA_MAX_RANK
                raise ValueError(
                    f"rank {rank} exceeds {lora.MAX_RANK_ENV}="
                    f"{lora.max_rank()}; raise the knob or recreate the "
                    f"adapter at a smaller rank")
        except KeyError:
            with self._lock:
                self._entries.pop(adapter_id, None)
            raise ValueError(
                f"unknown adapter {adapter_id!r} — POST /adapters/ or "
                f"train it first")
        except Exception as e:  # noqa: BLE001 — a typed, descriptive 400
            with self._lock:
                self._entries.pop(adapter_id, None)
            raise ValueError(
                f"adapter {adapter_id!r} failed to load: "
                f"{type(e).__name__}: {e}")
        with self._lock:
            self._check_model(entry, model_id, drop_on_mismatch=True)
            entry.state = "ready"
            entry.refs += 1
            entry.last_use = next(self._clock)
            self._evict_over_capacity()
        return entry

    def _check_model(self, entry: AdapterEntry, model_id,
                     drop_on_mismatch: bool = False):
        if model_id is not None and entry.model_id != model_id:
            if drop_on_mismatch:
                self._entries.pop(entry.adapter_id, None)
            raise ValueError(
                f"adapter {entry.adapter_id!r} belongs to model "
                f"{entry.model_id!r}, not {model_id!r}")

    def release(self, entry: AdapterEntry):
        with self._lock:
            entry.refs = max(0, entry.refs - 1)

    def _evict_over_capacity(self):
        """Drop the least recently used unpinned entries over the cap
        (the caller holds the lock); pinned entries may overflow it."""
        cap = _host_cache()
        while len(self._entries) > cap:
            victims = [e for e in self._entries.values()
                       if e.refs == 0 and e.state == "ready"]
            if not victims:
                log.warning("Adapter host cache over capacity (%d > %d) "
                            "with every entry pinned", len(self._entries),
                            cap)
                return
            victim = min(victims, key=lambda e: e.last_use)
            del self._entries[victim.adapter_id]

    # -- invalidation -------------------------------------------------------

    def invalidate(self, adapter_id: str):
        """Drop the entry (delete, retrain): the next acquire reloads under
        a fresh uid.  Rows in flight keep their slot's factors."""
        with self._lock:
            self._entries.pop(adapter_id, None)

    def invalidate_model(self, model_id: str):
        """Flush every cached adapter of ``model_id`` (``DELETE /model/``,
        an engine's model reload)."""
        with self._lock:
            for aid in [aid for aid, e in self._entries.items()
                        if e.model_id == model_id]:
                del self._entries[aid]

    def reset(self):
        with self._lock:
            self._entries.clear()

    # -- introspection ------------------------------------------------------

    def cached_ids(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def cache_bytes(self) -> int:
        """Host bytes of every cached adapter's factors: the ledger's
        ``adapter_host_cache`` (serve/memledger.py)."""
        with self._lock:
            return sum(int(t.numel()) * t.element_size()
                       for e in self._entries.values()
                       for t in (e.params or {}).values()
                       if hasattr(t, "element_size"))

    def entry_state(self, adapter_id: str) -> dict | None:
        with self._lock:
            e = self._entries.get(adapter_id)
            if e is None:
                return None
            return {"state": e.state, "refs": e.refs, "uid": e.uid}


REGISTRY = AdapterRegistry()


def _summary(adapter_id: str, tree: dict) -> dict:
    cfg = tree.get("config") or {}
    return {"adapter_id": adapter_id, "model_id": tree.get("model_id"),
            "rank": cfg.get("rank"), "alpha": cfg.get("alpha"),
            "targets": cfg.get("targets"), "status": tree.get("status")}


def list_adapters() -> list[dict]:
    """``GET /adapters/``: every adapter checkpoint, from its header alone,
    with its host-cache state."""
    out = []
    for aid in checkpoint.list_adapter_ids():
        try:
            tree = checkpoint.peek_adapter_tree(aid)
        except (KeyError, ValueError):
            continue
        out.append(dict(_summary(aid, tree),
                        cache=REGISTRY.entry_state(aid)))
    return out


def adapter_detail(adapter_id: str) -> dict:
    """``GET /adapters/?adapter_id=``: one adapter with its training
    progress.  :raises KeyError: unknown adapter (HTTP 404)."""
    tree = checkpoint.peek_adapter_tree(adapter_id)
    return dict(_summary(adapter_id, tree),
                progress=tree.get("progress") or [],
                cache=REGISTRY.entry_state(adapter_id))


def delete_model_adapters(model_id: str) -> list[str]:
    """``DELETE /model/``'s rider: flush the model's cached adapters and
    remove their checkpoints (an adapter never serves without its base,
    and a blob left behind would come back under a recreated model of the
    same id).  Returns the deleted ids."""
    REGISTRY.invalidate_model(model_id)
    deleted = []
    for aid in checkpoint.list_adapter_ids():
        try:
            if checkpoint.peek_adapter_tree(aid).get("model_id") != model_id:
                continue
        except (KeyError, ValueError):
            continue
        REGISTRY.invalidate(aid)
        checkpoint.delete_adapter(aid)
        deleted.append(aid)
    return deleted
