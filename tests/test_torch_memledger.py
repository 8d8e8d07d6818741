"""The port's capacity ledger and flight recorder (serve/memledger.py)
against the JAX package's, on the CPU.

- The page partition sums to the pool's capacity with no negative state,
  read from another thread all through admissions, prefix hits, a
  preemption, retirements and a crash; the strict audit
  (``PENROZ_MEMLEDGER_STRICT=1``, on in this suite) re-proves it inside
  the worker at every retirement, preemption and recovery.
- The strict audit raises on a corrupted refcount with the JAX package's
  message, and a lenient one counts the failure.
- ``/memory/``'s keys (top level, per engine, page states, byte
  components) equal the JAX package's ``memory_stats()``.
- ``/debug/dump`` after an injected crash holds the recorder entry with
  the pre-crash ledger and the trace ids."""

import json
import queue
import sys
import threading
import time
import urllib.request

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import memledger as jmemledger
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import memledger
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults as tfaults
from penroz_tpu_torch.utils import tracing

BLOCK = 16
WAIT_S = 120.0


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1"),
                        ("PENROZ_PREFIX_CACHE_PAGES", "8"),
                        ("PENROZ_MEMLEDGER_STRICT", "1")):
        monkeypatch.setenv(name, value)
    for name in ("TURBO_QUANT_KV_CACHE", "PENROZ_SPEC_DECODE",
                 tfaults.ENV, "PENROZ_MEMLEDGER"):
        monkeypatch.delenv(name, raising=False)
    tfaults.reset()
    jfaults.reset()
    memledger.reset()
    jmemledger.reset()
    tracing.reset()
    model = JModel("ledger", JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), {"sgd": {"lr": 0.1}}))
    model.serialize(sync_flush=True)
    yield model
    DS.reset()
    JDS.reset()
    tfaults.reset()
    jfaults.reset()
    memledger.reset()
    jmemledger.reset()


def _start(engine, prompt, n, **fields):
    events = queue.Queue()
    req = DS.Request(prompt, n, None,
                     lambda kind, value: events.put((kind, value)), **fields)
    engine.submit(req)
    return req, events


def _first_token(events):
    kind, value = events.get(timeout=WAIT_S)
    assert kind == "token", (kind, value)
    return value


def test_partition_sums_to_capacity_throughout(jmodel, monkeypatch):
    """A poller reads the ledger all through the traffic, with the
    interpreter switching threads every microsecond: every snapshot's
    states sum to the pool's capacity (a read torn by the worker's radix
    insert would not); the pages a live row owns, the pins and the
    preempted hold show up where they belong."""
    monkeypatch.setenv(DS.SUPERSTEP_ENV, "1")
    monkeypatch.setenv(tfaults.ENV, "decode.step:sleep@15")
    engine = DS.get_engine("ledger", BLOCK, 0.0, None, device="cpu")
    snaps, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            snaps.append(engine.memory_snapshot())
            time.sleep(0.002)

    poller = threading.Thread(target=poll)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    poller.start()
    try:
        # two cold rows, then a prefix hit on the first's prompt
        a = _start(engine, [1, 2, 3, 4, 5, 6, 7, 8, 9], 6, tenant="x")
        b = _start(engine, [3, 1, 4, 1, 5], 5, tenant="y")
        DS.collect(*a, timeout=WAIT_S)
        DS.collect(*b, timeout=WAIT_S)
        DS.run_request(engine, [1, 2, 3, 4, 5, 6, 7, 8, 2], 4, None,
                       timeout=WAIT_S)
        # a full batch of batch-class rows, then an interactive preemption
        held = [_start(engine, [7, 7, 7, 7, 7, i], 8, priority="batch")
                for i in range(engine.capacity)]
        for _, events in held:
            _first_token(events)
        DS.run_request(engine, [9, 9], 3, None, timeout=WAIT_S,
                       priority="interactive")
        for req, events in held:
            DS.collect(req, events, timeout=WAIT_S)
        # a crash: every row fails, the reset hands back a clean pool
        monkeypatch.setenv(tfaults.ENV, "decode.step:raise@1")
        tfaults.reset()
        with pytest.raises(tfaults.InjectedFault):
            DS.run_request(engine, [4, 4, 4], 3, None, timeout=WAIT_S)
    finally:
        stop.set()
        poller.join(WAIT_S)
        sys.setswitchinterval(switch)
    assert not poller.is_alive()
    monkeypatch.delenv(tfaults.ENV)
    assert len(snaps) > 20
    for snap in snaps:
        states = snap["pool_pages"]
        assert sum(states.values()) == snap["pool_pages_total"], states
        assert min(states.values()) >= 0, states
        assert states["transit"] == states["hibernating"] == 0
    seen = lambda s: any(snap["pool_pages"][s] for snap in snaps)  # noqa: E731
    assert all(seen(s) for s in ("row", "prefix_evictable"))
    assert any(snap["tenant_pages"].get("x") for snap in snaps)
    stats = engine.stats()
    assert stats["preemptions"] >= 1 and stats["engine_resets"] == 1
    assert engine._ledger.audit("test") == [] and not stats["breaker_open"]
    final = engine.memory_snapshot()
    assert final["pool_pages"]["free"] == (final["pool_pages_total"]
                                           - engine._prefix_cache
                                           .capacity_pages)
    assert final["audit_failures"] == 0
    assert final["high_water_pages"]["used"] > 0
    kv = final["hbm_bytes"]
    assert kv["kv_values"] > 0 and kv["params"] > 0 and kv["kv_scales"] == 0


def _corrupt_and_audit(side, monkeypatch):
    """A settled engine with cached prefix pages; one node's refcount is
    bumped by hand.  Returns (lenient problems, strict error text)."""
    if side == "torch":
        engine = DS.DecodeEngine("ledger", BLOCK, 0.0, None, capacity=2,
                                 device="cpu")
        DS.run_request(engine, [1, 2, 3, 4, 5, 6, 7, 8, 9], 2, None,
                       timeout=WAIT_S)
        error = memledger.LedgerAuditError
    else:
        engine = JDS.DecodeEngine("ledger", BLOCK, 0.0, None, capacity=2)
        events = queue.Queue()
        engine.submit(JDS.Request([1, 2, 3, 4, 5, 6, 7, 8, 9], 2, None,
                                  lambda k, v: events.put((k, v))))
        while events.get(timeout=WAIT_S)[0] != "done":
            pass
        error = jmemledger.LedgerAuditError
    try:
        node = sorted(engine._prefix_cache.iter_nodes(),
                      key=lambda nd: nd.page)[0]
        node.refs += 1
        monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "0")
        lenient = engine._ledger.audit("probe")
        failures = engine.memory_snapshot()["audit_failures"]
        monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
        with pytest.raises(error) as exc:
            engine._ledger.audit("probe")
        node.refs -= 1
        assert engine._ledger.audit("probe") == []
        return lenient, failures, str(exc.value)
    finally:
        engine.shutdown(timeout=WAIT_S)


def test_strict_audit_raises_on_corrupted_refcount(jmodel, monkeypatch):
    ours = _corrupt_and_audit("torch", monkeypatch)
    ref = _corrupt_and_audit("jax", monkeypatch)
    assert ours[0] == ref[0] and len(ours[0]) == 1
    assert "refs=1 but 0 derivable pin(s)" in ours[0][0]
    assert ours[1] == ref[1] == 1
    assert ours[2] == ref[2]


def _keys(d):
    return {k: sorted(v) if isinstance(v, dict) else None
            for k, v in d.items()}


def test_memory_keys_match_jax(jmodel):
    DS.get_engine("ledger", BLOCK, 0.0, None, device="cpu")
    JDS.get_engine("ledger", BLOCK, 0.0, None)
    ours, ref = memledger.memory_stats(), jmemledger.memory_stats()
    assert _keys(ours) == _keys(ref)
    assert _keys(ours["engines"][0]) == _keys(ref["engines"][0])
    assert ours["pool_pages"] == ref["pool_pages"]
    assert (ours["engines"][0]["pool_pages_total"]
            == ref["engines"][0]["pool_pages_total"])
    assert ours["hbm_bytes"].keys() == ref["hbm_bytes"].keys()
    assert ours["hbm_bytes"]["kv_block_table"] > 0


def test_debug_dump_holds_the_crash(jmodel, monkeypatch):
    """``GET /debug/dump`` after an injected crash: the recorder entry
    holds the pre-crash ledger (the crashed row's pages), the queue
    depths and the crashed request's trace id; ``/memory/`` counts it.
    The dump also carries the restart recovery that ``create_app`` ran."""
    from penroz_tpu_torch.serve.app import create_app
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv(tfaults.ENV, "decode.step:raise@2")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address[:2]

    def get(path, body=None, rid=None):
        req = urllib.request.Request(
            base + path, data=json.dumps(body).encode() if body else None,
            method="POST" if body else "GET",
            headers={"Content-Type": "application/json",
                     **({"X-Request-Id": rid} if rid else {})})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    try:
        status, body = get("/generate/", {
            "model_id": "ledger", "input": [[1, 2, 3, 4, 5, 6, 7]],
            "block_size": BLOCK, "max_new_tokens": 6, "temperature": 0},
            rid="doomed-1")
        assert status == 500 and body["request_id"] == "doomed-1"
        status, dump = get("/debug/dump")
        assert status == 200 and dump["recorded"] == 1
        # create_app ran the restart recovery: with no journal it
        # replayed nothing and recovered nothing
        recovery = dump["restart_recovery"]
        assert recovery["journal_enabled"] is False
        assert recovery["records_replayed"] == 0
        assert recovery["sessions_recovered"] == 0
        (entry,) = dump["entries"]
        assert entry["reason"] == "engine_crash"
        assert "InjectedFault" in entry["error"]
        assert entry["model_id"] == "ledger" and entry["crashes_total"] == 1
        assert entry["ledger"]["pool_pages"]["row"] == 2    # 7 + 1 tokens
        assert entry["queue_depth_by_class"] == {
            "interactive": 0, "standard": 0, "batch": 0}
        assert entry["recent_traces"]["live"] == ["doomed-1"]
        assert entry["tick_timeline"]
        status, mem = get("/memory/")
        assert status == 200 and mem["flight_records"] == 1
        assert mem["engines"][0]["pool_pages"]["row"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)
