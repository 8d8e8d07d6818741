"""The port's replica router and disaggregated prefill (serve/router.py)
against the JAX package's, on the same weights: each test drives the same
prompts under the same knobs through the JAX router and the port's on the
CPU, and holds the port to the JAX greedy tokens and, where the traffic
fixes them, to its counters (affinity hits and misses, failovers, exports
and imports, role changes).  Every wait carries its own timeout, so a hung
worker fails one test."""

import glob
import os
import queue
import threading
import time

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.serve import router as JR
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import memledger, qos
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.serve import router as R
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
MODEL = "routed"
FAMILY = [[1, 2, 3, 4, 5, 6, 7, 8],
          [1, 2, 3, 4, 5, 6, 7, 8, 9],
          [11, 12]]


@pytest.fixture
def jmodel(workdir, monkeypatch):
    """A toy GPT written by the JAX package, read by both (one shm dir)."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel(MODEL, JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture(autouse=True)
def _registries(monkeypatch):
    """Fresh engine and router registries, fault and QoS state, per test,
    in both packages."""
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    yield
    DS.reset()
    JDS.reset()
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()


class _Collector:
    def __init__(self, prompt):
        self.q = queue.Queue()
        self.tokens = list(prompt)

    def on_event(self, kind, value):
        self.q.put((kind, value))

    def result(self, timeout=WAIT_S):
        while True:
            kind, value = self.q.get(timeout=timeout)
            if kind == "token":
                self.tokens.append(value)
            elif kind == "done":
                return self.tokens
            else:
                raise value


def _submit(router, prompt, max_new, pkg=DS):
    collector = _Collector(prompt)
    router.submit(pkg.Request(prompt, max_new, None, collector.on_event))
    return collector


def _routers(monkeypatch, n):
    """The production seam in both packages: get_engine hands back a
    router when PENROZ_SCHED_REPLICAS > 1."""
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", str(n))
    ours = DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu")
    ref = JDS.get_engine(MODEL, BLOCK, 0.0, None)
    assert isinstance(ours, R.EngineRouter)
    assert isinstance(ref, JR.EngineRouter)
    assert len(ours.replicas) == len(ref.replicas) == n
    return ours, ref


def _both(ours, ref, prompts, max_new=5):
    """Submit ``prompts`` one after another to each router (each waits
    for its result); returns both packages' token lists."""
    got = [_submit(ours, p, max_new).result() for p in prompts]
    want = [_submit(ref, p, max_new, JDS).result() for p in prompts]
    return got, want


def _counters(router):
    per = [e.stats() for e in router.replicas]
    return {"hits": router.affinity_hits, "misses": router.affinity_misses,
            "failovers": router.failovers,
            "exports": sum(p["disagg_exports"] for p in per),
            "imports": sum(p["disagg_imports"] for p in per),
            "failures": sum(p["disagg_handoff_failures"] for p in per),
            "completed": [p["completed"] for p in per],
            "roles": [e.role for e in router.replicas]}


def _assert_no_leaks():
    """Every pool page owned, nothing in transit, no blob left in shm."""
    for entry in memledger.memory_stats()["engines"]:
        pools = entry["pool_pages"]
        assert pools["transit"] == 0, pools
        assert sum(pools.values()) == entry["pool_pages_total"]
    assert glob.glob(os.path.join(tckpt.SHM_PATH, "**", "pageblob_*"),
                     recursive=True) == []


def _prefix_env(monkeypatch):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")


def _disagg_env(monkeypatch, prefill_replicas="1"):
    _prefix_env(monkeypatch)
    monkeypatch.setenv(R.DISAGG_ENV, "1")
    monkeypatch.setenv(R.DISAGG_REPLICAS_ENV, prefill_replicas)


def _wait_for_roles(router, want):
    deadline = time.monotonic() + WAIT_S
    while sorted(e.role for e in router.replicas) != sorted(want):
        assert time.monotonic() < deadline, [e.role for e in router.replicas]
        time.sleep(0.005)


# -- flat routing --------------------------------------------------------------

@pytest.mark.parametrize("replicas,affinity", [(1, "1"), (2, "1"), (2, "0"),
                                               (3, "1"), (3, "0")])
def test_router_greedy_parity_matrix(jmodel, monkeypatch, replicas,
                                     affinity):
    """Replicas 1-3 x affinity on/off over the prefix-cached paged pool:
    the JAX router's tokens and, with the requests sequential, its
    affinity counters and per-replica completions."""
    _prefix_env(monkeypatch)
    monkeypatch.setenv(R.AFFINITY_ENV, affinity)
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", str(replicas))
    ours = DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu")
    ref = JDS.get_engine(MODEL, BLOCK, 0.0, None)
    prompts = FAMILY + [FAMILY[0] + [13, 14]]
    want = [jmodel.generate_tokens([p], BLOCK, 5, temperature=0.0)
            for p in prompts]
    got, jax_got = _both(ours, ref, prompts)
    assert got == jax_got == want
    stats = DS.serving_stats()
    assert stats["router_replicas"] == (replicas if replicas > 1 else 0)
    if replicas > 1:
        assert _counters(ours) == _counters(ref)
        if affinity == "1":
            assert (ours.affinity_hits, ours.affinity_misses) == (2, 1)
        assert stats["router_affinity_hits"] == ours.affinity_hits


def test_router_prefix_affinity_steers_family_to_one_replica(
        jmodel, monkeypatch):
    """A family sharing two leading pages lands on one replica: the first
    request is the miss, the rest hits, as in the JAX router; the
    counters reach /serving_stats/ and /metrics."""
    _prefix_env(monkeypatch)
    ours, ref = _routers(monkeypatch, 2)
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    family = [shared + tail for tail in ([9], [10, 11], [12], [13])]
    before = serve_metrics.ROUTER_AFFINITY.value(outcome="hit")
    got, want = _both(ours, ref, family)
    assert got == want
    assert (ours.affinity_hits, ours.affinity_misses) == (3, 1)
    assert _counters(ours) == _counters(ref)
    assert sorted(_counters(ours)["completed"]) == [0, 4]
    stats = DS.serving_stats()
    assert stats["router_affinity_hit_rate"] == pytest.approx(0.75)
    assert serve_metrics.ROUTER_AFFINITY.value(outcome="hit") == before + 3


def test_router_failover_then_probe_readmission(jmodel, monkeypatch):
    """Crashes open replica 0's breaker; the next requests fail over to
    replica 1 (tokens intact, failovers counted); the model stays ready;
    after the cooldown the half-open probe readmits replica 0.  The same
    counters as the JAX router's."""
    _prefix_env(monkeypatch)
    prompt = [1, 2, 3]
    base = jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    monkeypatch.setenv("PENROZ_ENGINE_MAX_CRASHES", "2")
    monkeypatch.setenv("PENROZ_BREAKER_COOLDOWN_MS", "100000")
    ours, ref = _routers(monkeypatch, 2)
    for router, pkg, flt in ((ours, DS, faults), (ref, JDS, jfaults)):
        monkeypatch.setenv(flt.ENV, "decode.step:raise@1,decode.step:raise@2")
        for _ in range(2):
            with pytest.raises(flt.InjectedFault):
                _submit(router, prompt, 5, pkg).result()
        monkeypatch.delenv(flt.ENV)
        assert router.replicas[0].stats()["breaker_open"] is True
        assert MODEL not in pkg.breaker_open_engines()
        for _ in range(2):
            assert _submit(router, prompt, 5, pkg).result() == base
    # an open replica is ordered last, so the healthy one takes the
    # requests without a refusal to pass over
    assert ours.failovers == ref.failovers == 0
    assert [e.stats()["completed"] for e in ours.replicas] == [0, 2]
    monkeypatch.setenv("PENROZ_BREAKER_COOLDOWN_MS", "0")
    for router, pkg in ((ours, DS), (ref, JDS)):
        assert _submit(router, prompt, 5, pkg).result() == base
        s0 = router.replicas[0].stats()
        assert s0["completed"] == 1 and s0["breaker_open"] is False
    assert _counters(ours) == _counters(ref)


def test_router_all_replicas_open_surfaces_circuit_error(jmodel,
                                                         monkeypatch):
    """Only with EVERY replica's breaker open is the model unready and the
    client refused (CircuitOpenError, Retry-After in [1, 30])."""
    _prefix_env(monkeypatch)
    monkeypatch.setenv("PENROZ_ENGINE_MAX_CRASHES", "1")
    monkeypatch.setenv("PENROZ_BREAKER_COOLDOWN_MS", "100000")
    ours, ref = _routers(monkeypatch, 2)
    for router, pkg, flt in ((ours, DS, faults), (ref, JDS, jfaults)):
        monkeypatch.setenv(flt.ENV, "decode.step:raise@1,decode.step:raise@2")
        with pytest.raises(flt.InjectedFault):
            _submit(router, [1, 2, 3], 5, pkg).result()
        assert pkg.breaker_open_engines() == []
        with pytest.raises(flt.InjectedFault):
            _submit(router, [1, 2, 3], 5, pkg).result()
        assert pkg.breaker_open_engines() == [MODEL]
        with pytest.raises(pkg.CircuitOpenError) as err:
            _submit(router, [1, 2, 3], 5, pkg)
        assert 1 <= err.value.retry_after <= 30
        monkeypatch.delenv(flt.ENV)
    # the refused submit passed over one open replica to the next
    assert ours.failovers == ref.failovers == 1
    assert DS.serving_stats()["router_failovers"] == 1


def test_router_scoring_counts_queued_prefill_tokens():
    """Least-loaded placement ranks by the class's queued prompt TOKENS
    before its queue depth: two 100-token prompts outweigh five 3-token
    ones, in both routers."""
    for pkg, mod in ((DS, R), (JDS, JR)):
        class _FakeEngine:
            def __init__(self, replica):
                self.replica = replica
                self.role = "decode"
                self._shutdown = self._draining = False
                self._breaker_open = self._probe_inflight = False
                self._breaker_open_t = 0.0
                self._cond = threading.Condition()
                self._pending = (qos if pkg is DS else jqos).WFQueue()
                self.active_rows = 0

        def req(n):
            return pkg.Request(list(range(1, n + 1)), 1, None,
                               lambda *a: None)

        router = object.__new__(mod.EngineRouter)
        router.replicas = [_FakeEngine(0), _FakeEngine(1)]
        router.disagg = False
        few_huge, many_tiny = router.replicas
        for _ in range(2):
            few_huge._pending.push(req(100))
        for _ in range(5):
            many_tiny._pending.push(req(3))
        assert few_huge._pending.class_tokens("standard") == 200
        order = router._candidates(req(4), target=None)
        assert [e.replica for e in order] == [1, 0]


def test_router_replicas_visible_in_stats_and_memory(jmodel, monkeypatch):
    """Each replica appears in /serving_stats/ and /memory/ with its index
    and role, a 1-device mesh, and a pool whose states partition it."""
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    ours, ref = _routers(monkeypatch, 2)
    got, want = _both(ours, ref, [[1, 2, 3]], 4)
    assert got == want
    for stats in (DS.serving_stats(), JDS.serving_stats()):
        assert [(e["replica"], e["mesh_devices"], e["role"])
                for e in stats["engines"]] == [(0, 1, "decode"),
                                               (1, 1, "decode")]
    mem = memledger.memory_stats()
    assert [(e["replica"], e["role"]) for e in mem["engines"]] == \
        [(0, "decode"), (1, "decode")]
    _assert_no_leaks()


# -- disaggregated prefill ---------------------------------------------------

@pytest.mark.parametrize("transport", ["d2d", "host"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("superstep", ["1", "8"])
def test_router_disagg_greedy_parity_matrix(jmodel, monkeypatch, int8,
                                            superstep, transport):
    """Disaggregated prefill over both transports, fp32 and int8 pages:
    the JAX router's tokens, every request through export and import,
    the prefill replica emitting nothing, and nothing left in transit or
    shm.  Affinity is off, so no prefix hit steers a request past the
    prefill replica."""
    _disagg_env(monkeypatch)
    monkeypatch.setenv(R.AFFINITY_ENV, "0")
    monkeypatch.setenv(DS.DISAGG_TRANSPORT_ENV, transport)
    monkeypatch.setenv("PENROZ_SCHED_SUPERSTEP", superstep)
    if int8:
        monkeypatch.setenv("TURBO_QUANT_KV_CACHE", "1")
    ours, ref = _routers(monkeypatch, 2)
    assert [e.role for e in ours.replicas] == ["prefill", "decode"]
    got, want = _both(ours, ref, FAMILY)
    assert got == want
    c = _counters(ours)
    assert c == _counters(ref)
    assert c["exports"] == c["imports"] == len(FAMILY)
    assert c["failures"] == 0 and c["completed"] == [0, len(FAMILY)]
    stats = DS.serving_stats()
    assert stats["disagg_prefill_replicas"] == 1
    assert stats["disagg_exports"] == stats["disagg_imports"] == 3
    assert stats["disagg_handoff_ms_p99"] is not None
    assert stats["disagg_transport"] == transport
    assert [e["role"] for e in stats["engines"]] == ["prefill", "decode"]
    _assert_no_leaks()


def test_router_disagg_off_keeps_flat_routing(jmodel, monkeypatch):
    """Without PENROZ_DISAGG_PREFILL every replica decodes, no sink is
    installed and the disaggregation counters stay 0."""
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    ours, ref = _routers(monkeypatch, 2)
    assert [e.role for e in ours.replicas] == ["decode", "decode"]
    assert all(e._handoff_sink is None for e in ours.replicas)
    assert ours.disagg is False
    got, want = _both(ours, ref, [[1, 2, 3]], 4)
    assert got == want
    stats = DS.serving_stats()
    assert stats["disagg_prefill_replicas"] == 0
    assert stats["disagg_exports"] == stats["disagg_imports"] == 0


@pytest.mark.parametrize("spec", ["disagg.handoff:raise@1",
                                  "disagg.handoff:raise@2",
                                  "disagg.d2d:raise@1",
                                  "disagg.d2d:raise@2"],
                         ids=["export", "import", "d2d-export", "d2d-import"])
def test_router_disagg_fault_paths(jmodel, monkeypatch, spec):
    """Each fault of the seam: disagg.handoff mid-export (@1) or
    mid-import (@2) re-prefills monolithically on the decode replica (no
    import); disagg.d2d at the exporter's gather (@1) or the importer's
    scatter (@2, refused back) re-sends through the host blob (one
    import).  Tokens and counters equal the JAX router's; nothing
    leaks."""
    _disagg_env(monkeypatch)
    prompt = [1, 2, 3, 4, 5, 6, 7]
    ours, ref = _routers(monkeypatch, 2)
    monkeypatch.setenv(faults.ENV, spec)
    got = _submit(ours, prompt, 5).result()
    monkeypatch.setenv(jfaults.ENV, spec)
    assert got == _submit(ref, prompt, 5, JDS).result() == \
        jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    c = _counters(ours)
    assert c == _counters(ref)
    assert c["failures"] == 1 and c["completed"] == [0, 1]
    assert c["imports"] == (0 if spec.startswith("disagg.handoff") else 1)
    _assert_no_leaks()


def test_router_disagg_d2d_midstream_fallback_parity(jmodel, monkeypatch):
    """A d2d failure in the middle of a hand-off stream (the site's third
    ordinal: the second hand-off's gather) downgrades only that hand-off
    to the host blob; its neighbours stay d2d."""
    _disagg_env(monkeypatch)
    prompts = [[1, 2, 3, 4, 5], [6, 7, 8], [9, 10, 11, 12]]
    ours, ref = _routers(monkeypatch, 2)
    monkeypatch.setenv(faults.ENV, "disagg.d2d:raise@3")
    monkeypatch.setenv(jfaults.ENV, "disagg.d2d:raise@3")
    before = serve_metrics.DISAGG_HANDOFFS.value(outcome="ok",
                                                 transport="host")
    got, want = _both(ours, ref, prompts)
    assert got == want
    c = _counters(ours)
    assert c == _counters(ref)
    assert c["exports"] == c["imports"] == 3 and c["failures"] == 1
    assert serve_metrics.DISAGG_HANDOFFS.value(
        outcome="ok", transport="host") == before + 1
    _assert_no_leaks()


def test_router_disagg_drain_finishes_inflight_export(jmodel, monkeypatch):
    """Draining a prefill replica lets its in-flight export land on the
    decode replica: the client gets the full greedy output."""
    _disagg_env(monkeypatch)
    monkeypatch.setenv(faults.ENV, "disagg.handoff:sleep@300")
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    base = jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", "2")
    router = DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu")
    r0, r1 = router.replicas
    collector = _submit(router, prompt, 5)
    deadline = time.monotonic() + WAIT_S
    while r0.active_rows == 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert r0.active_rows == 1
    assert r0.shutdown(timeout=WAIT_S, drain_s=WAIT_S) is True
    assert r0.stats()["disagg_exports"] == 1
    assert collector.result() == base
    assert r1.stats()["disagg_imports"] == 1


def test_router_disagg_ack_timeout_reaps_parked_pages(jmodel, monkeypatch):
    """A d2d ack that never comes: the exporter frees its parked pages
    after PENROZ_DISAGG_ACK_TIMEOUT_MS and counts an ``ack_timeout``; the
    importer still serves the request."""
    _disagg_env(monkeypatch)
    monkeypatch.setenv(DS.DISAGG_ACK_TIMEOUT_ENV, "50")
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", "2")
    ours = DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu")
    exporter = ours.replicas[0]
    monkeypatch.setattr(exporter, "_make_ack",
                        lambda row, state: (lambda ok: None))
    prompt = [1, 2, 3, 4, 5, 6, 7]
    assert _submit(ours, prompt, 5).result() == \
        jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    deadline = time.monotonic() + WAIT_S
    while exporter.active_rows and time.monotonic() < deadline:
        time.sleep(0.01)
    assert exporter.active_rows == 0
    assert exporter.stats()["disagg_handoff_failures"] == 1
    assert serve_metrics.DISAGG_HANDOFFS.value(outcome="ack_timeout",
                                               transport="d2d") >= 1
    _assert_no_leaks()


# -- elastic roles -------------------------------------------------------------

def test_router_affinity_stale_role_entry_ages_out(jmodel, monkeypatch):
    """An index entry pointing at a replica that flipped to prefill ages
    out at lookup (``stale_role``); the repeat prompt decodes elsewhere
    with the JAX tokens."""
    _disagg_env(monkeypatch)
    ours, ref = _routers(monkeypatch, 3)
    shared = [1, 2, 3, 4, 5, 6, 7, 8]
    before = serve_metrics.ROUTER_AFFINITY.value(outcome="stale_role")
    for router, pkg in ((ours, DS), (ref, JDS)):
        assert [e.role for e in router.replicas] == \
            ["prefill", "decode", "decode"]
        assert _submit(router, shared + [9], 5, pkg).result() == \
            jmodel.generate_tokens([shared + [9]], BLOCK, 5,
                                   temperature=0.0)
        with router._lock:
            warm = set(router._affinity.values())
        assert warm and warm <= {1, 2}
        victim = router.replicas[min(warm)]
        done = victim.stats()["completed"]
        victim.request_role("prefill")
        _wait_for_roles(router, ["prefill", "prefill", "decode"])
        assert _submit(router, shared + [10], 5, pkg).result() == \
            jmodel.generate_tokens([shared + [10]], BLOCK, 5,
                                   temperature=0.0)
        assert router.affinity_stale_roles >= 1
        with router._lock:
            assert victim.replica not in set(router._affinity.values())
        assert victim.stats()["completed"] == done
    assert _counters(ours) == _counters(ref)
    assert serve_metrics.ROUTER_AFFINITY.value(outcome="stale_role") > before
    _assert_no_leaks()


def test_router_elastic_shrink_flips_idle_prefill_to_decode(jmodel,
                                                            monkeypatch):
    """With the backlog ratio under PENROZ_DISAGG_REBALANCE_DOWN the
    submit path asks the emptiest prefill replica to flip to decode; the
    flip lands at a drain boundary, is counted, keeps one prefill replica
    and keeps the cached router."""
    _disagg_env(monkeypatch, prefill_replicas="2")
    monkeypatch.setenv(R.DISAGG_ELASTIC_ENV, "1")
    monkeypatch.setenv(R.REBALANCE_COOLDOWN_ENV, "0")
    monkeypatch.setenv(R.REBALANCE_DOWN_ENV, "1000000000")
    ours, ref = _routers(monkeypatch, 3)
    before = serve_metrics.DISAGG_ROLE_CHANGES.value()
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    base = jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    for router, pkg in ((ours, DS), (ref, JDS)):
        assert [e.role for e in router.replicas] == \
            ["prefill", "prefill", "decode"]
        assert _submit(router, prompt, 5, pkg).result() == base
        assert router.role_changes_requested == 1
        _wait_for_roles(router, ["prefill", "decode", "decode"])
    assert DS.serving_stats()["disagg_role_changes"] == 1
    assert serve_metrics.DISAGG_ROLE_CHANGES.value() == before + 1
    assert DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu") is ours
    assert [e.role for e in ours.replicas] == [e.role for e in ref.replicas]
    _assert_no_leaks()


def test_engine_role_flip_chaos_retries_and_audits_clean(jmodel,
                                                         monkeypatch):
    """A ``disagg.rebalance`` crash mid-flip fires before the mutation: the
    roles stay consistent through the crash recovery, the strict audit is
    clean, and the flip retries at the next boundary."""
    _disagg_env(monkeypatch)
    monkeypatch.setenv(faults.ENV, "disagg.rebalance:raise@1")
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", "2")
    router = DS.get_engine(MODEL, BLOCK, 0.0, None, device="cpu")
    r0, r1 = router.replicas
    before = serve_metrics.DISAGG_ROLE_CHANGES.value()
    r1.request_role("prefill")
    _wait_for_roles(router, ["prefill", "prefill"])
    assert r1.stats()["disagg_role_changes"] == 1
    assert r1.stats()["crashes_total"] == 1
    assert serve_metrics.DISAGG_ROLE_CHANGES.value() == before + 1
    assert r1._requested_role is None
    _assert_no_leaks()
    r1.request_role("decode")
    _wait_for_roles(router, ["prefill", "decode"])
    prompt = [1, 2, 3, 4, 5]
    assert _submit(router, prompt, 5).result() == \
        jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)


def test_router_disagg_prefill_breakers_open_decode_serves_monolithic(
        jmodel, monkeypatch):
    """Every prefill replica's breaker open: the model stays ready and the
    decode replica serves requests whole (no import), the JAX tokens."""
    _disagg_env(monkeypatch)
    monkeypatch.setenv("PENROZ_ENGINE_MAX_CRASHES", "2")
    monkeypatch.setenv("PENROZ_BREAKER_COOLDOWN_MS", "100000")
    prompt = [1, 2, 3, 4, 5]
    base = jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0.0)
    ours, ref = _routers(monkeypatch, 2)
    for router, pkg, flt in ((ours, DS, faults), (ref, JDS, jfaults)):
        monkeypatch.setenv(flt.ENV, "decode.prefill_chunk:raise@1,"
                                    "decode.prefill_chunk:raise@2")
        for _ in range(2):
            with pytest.raises(flt.InjectedFault):
                _submit(router, prompt, 5, pkg).result()
        assert router.replicas[0].stats()["breaker_open"] is True
        assert MODEL not in pkg.breaker_open_engines()
        assert _submit(router, prompt, 5, pkg).result() == base
    c = _counters(ours)
    assert c == _counters(ref)
    assert c["completed"] == [0, 1] and c["imports"] == 0


def test_serving_stats_router_fields_documented_and_jax_named(jmodel,
                                                              monkeypatch):
    """The router and disaggregation fields of ``/serving_stats/`` that the
    OpenAPI response documents are in the port's payload, aggregate and
    per engine, under the JAX package's names."""
    from penroz_tpu_torch.serve import openapi, schemas
    _disagg_env(monkeypatch)
    ours, ref = _routers(monkeypatch, 2)
    got, want = _both(ours, ref, [FAMILY[0]])
    assert got == want
    agg, ref_agg = DS.serving_stats(), JDS.serving_stats()
    doc = openapi.serving_stats_schema()["properties"]
    for name, _, _ in schemas.SERVING_STATS_FIELDS:
        assert name in agg and name in ref_agg and name in doc, name
        assert agg[name] == ref_agg[name] or name.endswith(("_p50", "_p99")
                                                           ), name
    engine_doc = doc["engines"]["items"]["properties"]
    for name, _, _ in schemas.SERVING_STATS_ENGINE_FIELDS:
        assert name in engine_doc, name
        for a, b in zip(agg["engines"], ref_agg["engines"]):
            assert name in a and name in b, name


def test_dropped_queued_handoff_releases_its_blob_or_pages(jmodel,
                                                           monkeypatch):
    """A hand-off that will never be imported (its request cancelled while
    queued, or failed with the engine): a host hand-off's staged blob is
    deleted, a d2d one's exporter is acked so it frees its parked
    pages."""
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    engine = DS.DecodeEngine(MODEL, BLOCK, 0.0, None, device="cpu",
                             capacity=1)
    try:
        tckpt.save_page_blob("queued", {"k": [], "v": []})
        acks = []
        for handoff in ({"transport": "host", "blob_id": "queued"},
                        {"transport": "d2d", "ack": acks.append}):
            req = DS.Request([1, 2, 3], 4, None, lambda *a: None)
            req.handoff = handoff
            engine._discard_handoff(req)
            assert req.handoff is None
        engine._send_acks()
        assert acks == [True]
        with pytest.raises(KeyError):
            tckpt.load_page_blob("queued")
    finally:
        assert engine.shutdown(timeout=WAIT_S)
