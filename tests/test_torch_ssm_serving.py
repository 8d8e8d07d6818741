"""The port's engine serving hybrid (attention + ``ssm``) and pure-SSM models,
the cases of tests/test_ssm_serving.py on the port, each greedy stream held
to the JAX package's tokens (its single-sequence tokens, which its own
engine equals; the first case runs the JAX engine too): concurrent rows,
slot recycling, speculation over contiguous and paged caches x int8 x
superstep with an oracle drafter and with an always-wrong one (every verify
rolls the ring back), the prefix cache and the pipeline stages refused with
a warning, ``ssm.scan`` crash recovery, the disaggregated hand-off carrying
the recurrent state, the ``ssm.handoff`` fallback, and ``GET /memory/``'s
``ssm_state`` constant while a row grows.  Beyond those: chunked prompts of
several rows at once on the unified and the phased ticks (a row mid-prefill
rides the shared step parked, its recurrent state untouched), and the same
on both engines with a model whose recurrent branch moves greedy tokens
(the JAX engine's rows that prefilled beside a decoding one leave their
single-sequence tokens).  Every wait carries its own timeout."""

import json
import queue
import threading
import time
import urllib.request

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import memledger, qos, spec_decode
from penroz_tpu_torch.serve import router as router_mod
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
REP_PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]
WAIT_S = 120.0
_KNOBS = ("PAGED_KV_CACHE", "PENROZ_KV_PAGE_SIZE", "PENROZ_RAGGED_ATTENTION",
          "TURBO_QUANT_KV_CACHE", "PENROZ_SCHED_SUPERSTEP",
          "PENROZ_PREFILL_CHUNK", "PENROZ_SPEC_DECODE", "PENROZ_SPEC_NGRAM",
          "PENROZ_PREFIX_CACHE", "PENROZ_PREFIX_CACHE_PAGES",
          "PENROZ_SERVE_PIPE_STAGES", "PENROZ_CONTINUOUS_BATCHING",
          DS.REPLICAS_ENV, DS.DISAGG_TRANSPORT_ENV, router_mod.DISAGG_ENV,
          router_mod.DISAGG_REPLICAS_ENV, faults.ENV)


def _layers(ssm_every):
    return jpresets.hybrid_custom(d=32, heads=4, depth=2, vocab=64,
                                  block=BLOCK, dropout=0.0,
                                  ssm_every=ssm_every)


@pytest.fixture(autouse=True)
def env(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    for mod in (faults, jfaults, qos, memledger):
        mod.reset()
    yield monkeypatch
    DS.reset()
    JDS.reset()
    faults.reset()
    jfaults.reset()


def _model(model_id, ssm_every):
    """The JAX model (serialized) and its greedy single-sequence tokens."""
    jm = JModel(model_id, JMapper(_layers(ssm_every), SGD))
    jm.serialize(sync_flush=True)
    return jm


@pytest.fixture
def hybrid(env):
    return _model("schedhyb", 2)


@pytest.fixture
def pure(env):
    return _model("schedpure", 1)


def _jax_tokens(jm, prompt, n):
    return jm.generate_tokens([prompt], BLOCK, n, temperature=0.0)


@pytest.fixture
def make_engine():
    engines = []

    def build(model_id, capacity=2, pkg="torch"):
        mod = DS if pkg == "torch" else JDS
        kwargs = {"capacity": capacity}
        if pkg == "torch":
            kwargs["device"] = "cpu"
        engine = mod.DecodeEngine(model_id, BLOCK, 0.0, None, **kwargs)
        engines.append(engine)
        return engine

    yield build
    for engine in engines:
        engine.shutdown(timeout=WAIT_S)


class _Collector:
    def __init__(self, prompt):
        self.q = queue.Queue()
        self.tokens = list(prompt)
        self.received = 0

    def on_event(self, kind, value):
        self.q.put((kind, value))

    def next_token(self):
        kind, value = self.q.get(timeout=WAIT_S)
        assert kind == "token", (kind, value)
        self.tokens.append(value)
        self.received += 1

    def result(self):
        while True:
            kind, value = self.q.get(timeout=WAIT_S)
            if kind == "token":
                self.tokens.append(value)
                self.received += 1
            elif kind == "done":
                return self.tokens
            else:
                raise value


def _submit(target, prompt, max_new, pkg="torch"):
    mod = DS if pkg == "torch" else JDS
    c = _Collector(prompt)
    target.submit(mod.Request(prompt, max_new, None, c.on_event))
    return c


def _settled(engine):
    deadline = time.monotonic() + WAIT_S
    while engine._dispatch_t0 is not None or engine.active_rows:
        assert time.monotonic() < deadline, "the engine never settled"
        time.sleep(0.005)
    return engine


# -- parity through the engine ----------------------------------------------

def test_hybrid_concurrent_parity_and_state_bytes(hybrid, make_engine):
    """Two overlapping greedy requests equal the JAX tokens (single
    sequence and engine); ``ssm_state_bytes`` is the same after a 2-token
    and a 10-token stream and is the ledger's ``ssm_state``."""
    p1, p2 = [1, 2, 3], [5]
    base1, base2 = _jax_tokens(hybrid, p1, 10), _jax_tokens(hybrid, p2, 2)
    jengine = make_engine("schedhyb", pkg="jax")
    j1, j2 = _submit(jengine, p1, 10, "jax"), _submit(jengine, p2, 2, "jax")
    assert (j1.result(), j2.result()) == (base1, base2)
    engine = make_engine("schedhyb")
    c1, c2 = _submit(engine, p1, 10), _submit(engine, p2, 2)
    assert c2.result() == base2
    bytes_short = engine.stats()["ssm_state_bytes"]
    assert c1.result() == base1
    stats = _settled(engine).stats()
    assert stats["ssm_state_bytes"] == bytes_short > 0
    assert stats["ssm_rows"] == 0
    assert engine._ledger.snapshot()["hbm_bytes"]["ssm_state"] == bytes_short


def test_pure_ssm_slot_recycling_parity(pure, make_engine):
    """A capacity-2 pure-SSM engine serves 4 requests: a recycled row's
    state is zeroed before its prompt."""
    prompts = [[1, 2, 3], [5], [7, 8], [9, 10, 11, 12]]
    bases = [_jax_tokens(pure, p, 5) for p in prompts]
    engine = make_engine("schedpure")
    collectors = [_submit(engine, p, 5) for p in prompts]
    assert [c.result() for c in collectors] == bases
    stats = _settled(engine).stats()
    assert stats["completed"] == 4
    assert stats["ssm_state_bytes"] > 0


@pytest.mark.parametrize("superstep", ["1", "8"])
@pytest.mark.parametrize("int8", [0, 1], ids=["fp32", "int8"])
@pytest.mark.parametrize("paged_prefix", [0, 1], ids=["contiguous",
                                                      "paged_prefix"])
def test_hybrid_spec_parity_matrix(hybrid, make_engine, env, paged_prefix,
                                   int8, superstep):
    """Speculation with an oracle drafter over contiguous and paged caches
    (a prefix cache asked for and refused) x int8 x superstep: fully
    accepted, the JAX tokens."""
    if paged_prefix:
        env.setenv("PAGED_KV_CACHE", "1")
        env.setenv("PENROZ_KV_PAGE_SIZE", "4")
        env.setenv("PENROZ_PREFIX_CACHE", "1")
        env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    if int8:
        env.setenv("TURBO_QUANT_KV_CACHE", "1")
    env.setenv(DS.SUPERSTEP_ENV, superstep)
    env.setenv("PENROZ_SPEC_DECODE", "1")
    base = _jax_tokens(hybrid, REP_PROMPT, 6)

    def oracle(history, k, n):
        if len(history) < len(base) and history == base[:len(history)]:
            return [int(t) for t in base[len(history):len(history) + k]]
        return []

    env.setattr(spec_decode, "propose", oracle)
    engine = make_engine("schedhyb")
    assert _submit(engine, REP_PROMPT, 6).result() == base
    assert _submit(engine, REP_PROMPT, 6).result() == base
    stats = _settled(engine).stats()
    assert stats["spec_verify_steps"] > 0
    assert stats["spec_accept_rate"] == 1.0
    assert stats["ssm_state_bytes"] > 0
    assert stats["prefix_cache"] is None


@pytest.mark.parametrize("paged", [0, 1], ids=["contiguous", "paged"])
def test_hybrid_adversarial_drafter_exact_rollback(hybrid, make_engine, env,
                                                   paged):
    """A drafter whose first token is always wrong: every verify rolls
    the recurrent state back through its ring, and the stream is still
    the JAX tokens."""
    if paged:
        env.setenv("PAGED_KV_CACHE", "1")
        env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    env.setenv("PENROZ_SPEC_DECODE", "1")
    env.setenv("PENROZ_SPEC_NGRAM", "1")
    base = _jax_tokens(hybrid, REP_PROMPT, 6)

    def wrong(history, k, n):
        nxt = base[len(history)] if len(history) < len(base) else 0
        return [(int(nxt) + 1) % 64] * min(k, 2)

    env.setattr(spec_decode, "propose", wrong)
    engine = make_engine("schedhyb")
    assert _submit(engine, REP_PROMPT, 6).result() == base
    stats = _settled(engine).stats()
    assert stats["spec_drafted_tokens"] > 0
    assert stats["spec_accepted_tokens"] == 0


@pytest.mark.parametrize("cache", ["unified", "phased_contiguous",
                                   "phased_paged"])
def test_hybrid_chunked_rows_together(hybrid, make_engine, env, cache):
    """Three prompts cut into 4-token chunks, admitted together: a row
    mid-prefill rides the others' shared steps parked (its recurrent
    state untouched) or shares the unified block with them; every stream
    is the JAX tokens."""
    if cache != "phased_contiguous":
        env.setenv("PAGED_KV_CACHE", "1")
        env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    if cache == "phased_paged":
        env.setenv("PENROZ_RAGGED_ATTENTION", "0")
    env.setenv("PENROZ_PREFILL_CHUNK", "4")
    jobs = [([1, 2, 3], 9), ([7, 5, 9, 11, 4, 4, 2, 8, 30, 17], 5),
            ([5, 6, 5, 6, 5, 6], 7)]
    bases = [_jax_tokens(hybrid, p, n) for p, n in jobs]
    engine = make_engine("schedhyb", capacity=3)
    with engine._cond:
        collectors = []
        for p, n in jobs:
            c = _Collector(p)
            engine._pending.push(DS.Request(p, n, None, c.on_event))
            collectors.append(c)
        engine._cond.notify_all()
    assert [c.result() for c in collectors] == bases
    stats = _settled(engine).stats()
    assert stats["prefill_chunks"] > len(jobs)


def _wide(x):
    """The DSL with every normal init at std 0.3: at the presets' 0.02 the
    toy's recurrent branch moves no greedy token."""
    if isinstance(x, dict):
        return {k: ({"mean": 0.0, "std": 0.3} if k == "normal" else _wide(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_wide(v) for v in x]
    return x


def _push_together(engine, mod, jobs):
    """Admit ``jobs`` ((prompt, max_new) pairs) in one tick."""
    with engine._cond:
        collectors = []
        for p, n in jobs:
            c = _Collector(p)
            engine._pending.push(mod.Request(p, n, None, c.on_event))
            collectors.append(c)
        engine._cond.notify_all()
    return collectors


# A 3-token prompt decodes from the first tick while a 10-token and a
# 6-token prompt prefill in 4-token chunks over the next ticks.
PARKED_JOBS = [([1, 2, 3], 9), ([7, 5, 9, 11, 4, 4, 2, 8, 30, 17], 5),
               ([5, 6, 5, 6, 5, 6], 7)]


def test_row_mid_prefill_beside_decoding_rows_both_engines(env, make_engine):
    """The phased contiguous ticks with 4-token chunks, on a hybrid whose
    recurrent branch moves greedy tokens (every normal init at std 0.3,
    seed 0): the 10- and 6-token prompts prefill over several ticks while
    the 3-token one decodes.  The port parks a row mid-prefill in the
    shared step, and every stream is its single-sequence tokens.  The JAX
    engine's shared step advances every row: its row that decodes from
    the first tick keeps its tokens, and the two that prefilled beside it
    leave theirs by the second new token (index 11 and 7: 3 against 35, 5
    against 7)."""
    env.setenv("PENROZ_PREFILL_CHUNK", "4")
    jm = JModel("schedwide", JMapper(_wide(_layers(2)), SGD))
    jm.serialize(sync_flush=True)
    bases = [_jax_tokens(jm, p, n) for p, n in PARKED_JOBS]
    engine = make_engine("schedwide", capacity=3)
    got = [c.result() for c in _push_together(engine, DS, PARKED_JOBS)]
    assert got == bases
    assert _settled(engine).stats()["prefill_chunks"] > len(PARKED_JOBS)
    jengine = make_engine("schedwide", capacity=3, pkg="jax")
    jgot = [c.result() for c in _push_together(jengine, JDS, PARKED_JOBS)]
    assert jgot[0] == bases[0]
    for row in (1, 2):
        prompt = PARKED_JOBS[row][0]
        first = next((i for i, (a, b) in enumerate(zip(jgot[row],
                                                       bases[row]))
                      if a != b), None)
        assert first is not None and first <= len(prompt) + 1, (row, first)


# -- feature gating -----------------------------------------------------------

def test_prefix_cache_refused_for_ssm_arch(hybrid, make_engine, env):
    """PENROZ_PREFIX_CACHE=1 on an SSM arch warns and stays off."""
    env.setenv("PAGED_KV_CACHE", "1")
    env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    env.setenv("PENROZ_PREFIX_CACHE", "1")
    env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    warnings = []
    env.setattr(DS.log, "warning",
                lambda msg, *args, **kw: warnings.append(
                    msg % tuple(args) if args else msg))
    engine = make_engine("schedhyb")
    assert any("SSM" in m for m in warnings), warnings
    assert engine._prefix_cache is None
    assert engine._extra_pages == 0
    base = _jax_tokens(hybrid, REP_PROMPT, 4)
    assert _submit(engine, REP_PROMPT, 4).result() == base
    assert engine.stats()["prefix_cache"] is None


def test_pipeline_stages_fall_back_for_ssm_arch(hybrid, make_engine, env):
    """PENROZ_SERVE_PIPE_STAGES on an SSM arch: the engine serves unpiped,
    with the JAX tokens."""
    env.setenv("PAGED_KV_CACHE", "1")
    env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    env.setenv("PENROZ_RAGGED_ATTENTION", "1")
    env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    base = _jax_tokens(hybrid, [1, 2, 3], 5)
    engine = make_engine("schedhyb")
    assert engine._pipe is None
    assert _submit(engine, [1, 2, 3], 5).result() == base


# -- fault injection ----------------------------------------------------------

@pytest.mark.parametrize("paged", [0, 1], ids=["phased", "unified"])
def test_ssm_scan_crash_recovers_with_parity(hybrid, make_engine, env,
                                             paged):
    """An ``ssm.scan`` crash fails the request in flight, the engine
    resets, and the next request gets the JAX tokens, under the strict
    ledger audit."""
    if paged:
        env.setenv("PAGED_KV_CACHE", "1")
        env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    prompt = [1, 2, 3]
    base = _jax_tokens(hybrid, prompt, 6)
    env.setenv(faults.ENV, "ssm.scan:raise@1")
    engine = make_engine("schedhyb")
    with pytest.raises(faults.InjectedFault):
        _submit(engine, prompt, 6).result()
    env.delenv(faults.ENV)
    faults.reset()
    assert _submit(engine, prompt, 6).result() == base
    stats = _settled(engine).stats()
    assert stats["crashes_total"] == 1
    assert stats["engine_resets"] == 1
    assert stats["ssm_state_bytes"] > 0


def test_pure_ssm_scan_crash_recovers(pure, make_engine, env):
    """The same recovery on a pure-SSM arch (no K/V pool at all)."""
    prompt = [7, 8, 9]
    base = _jax_tokens(pure, prompt, 5)
    env.setenv(faults.ENV, "ssm.scan:raise@1")
    engine = make_engine("schedpure")
    with pytest.raises(faults.InjectedFault):
        _submit(engine, prompt, 5).result()
    env.delenv(faults.ENV)
    faults.reset()
    assert _submit(engine, prompt, 5).result() == base
    assert _settled(engine).stats()["engine_resets"] == 1


# -- disaggregated hand-off ---------------------------------------------------

def _disagg_router(env, model_id, transport=None):
    env.setenv("PAGED_KV_CACHE", "1")
    env.setenv("PENROZ_KV_PAGE_SIZE", "4")
    env.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    env.setenv(router_mod.DISAGG_ENV, "1")
    env.setenv(router_mod.DISAGG_REPLICAS_ENV, "1")
    env.setenv(DS.REPLICAS_ENV, "2")
    if transport:
        env.setenv(DS.DISAGG_TRANSPORT_ENV, transport)
    router = DS.get_engine(model_id, BLOCK, 0.0, None, device="cpu")
    assert isinstance(router, router_mod.EngineRouter)
    return router


@pytest.mark.parametrize("transport", ["d2d", "host"])
@pytest.mark.parametrize("which", ["hybrid", "pure"])
def test_disagg_handoff_carries_recurrent_state(env, transport, which,
                                                request):
    """A request prefilled on the prefill replica decodes on the decode
    replica with the JAX tokens: the hand-off carried the recurrent state
    (for a pure-SSM row, the whole payload)."""
    jm = request.getfixturevalue(which)
    model_id = jm.model_id
    prompt = [1, 2, 3, 4, 5, 6, 7, 8]
    base = _jax_tokens(jm, prompt, 5)
    router = _disagg_router(env, model_id, transport)
    assert [e.role for e in router.replicas] == ["prefill", "decode"]
    assert _submit(router, prompt, 5).result() == base
    per = [_settled(e).stats() for e in router.replicas]
    assert sum(p["disagg_exports"] for p in per) == 1
    assert sum(p["disagg_imports"] for p in per) == 1
    assert sum(p["disagg_handoff_failures"] for p in per) == 0


def test_hybrid_ssm_handoff_fault_falls_back_with_parity(hybrid, env):
    """An ``ssm.handoff`` crash mid-export falls back to a monolithic
    prefill on the decode replica, with the JAX tokens."""
    env.setenv(faults.ENV, "ssm.handoff:raise@1")
    prompt = [1, 2, 3, 4, 5, 6, 7]
    base = _jax_tokens(hybrid, prompt, 5)
    router = _disagg_router(env, "schedhyb", "host")
    assert _submit(router, prompt, 5).result() == base
    per = [_settled(e).stats() for e in router.replicas]
    assert sum(p["disagg_handoff_failures"] for p in per) == 1
    assert sum(p["disagg_imports"] for p in per) == 0
    assert per[1]["completed"] == 1


# -- GET /memory/: the state does not grow ------------------------------------

def test_memory_endpoint_ssm_state_constant_while_length_grows(hybrid, env):
    """``GET /memory/``'s ``ssm_state`` (the engine's and the aggregate's)
    is the same at two lengths of a live row."""
    from penroz_tpu_torch.serve.app import create_app
    env.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    env.setenv(faults.ENV, "decode.step:sleep@120")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        engine = DS.get_engine("schedhyb", BLOCK, 0.0, None, device="cpu")
        collector = _submit(engine, [1, 2, 3], 10)

        def row_len():
            with engine._cond:
                return max(int(n) for n in engine._lengths)

        def poll():
            with urllib.request.urlopen(f"http://{host}:{port}/memory/",
                                        timeout=60) as resp:
                body = json.loads(resp.read())
            entry = next(e for e in body["engines"]
                         if e["model_id"] == "schedhyb")
            return (entry["hbm_bytes"]["ssm_state"],
                    body["hbm_bytes"]["ssm_state"])

        collector.next_token()
        len1, first = row_len(), poll()
        assert first[0] > 0 and first[1] == first[0]
        while collector.received < 6:
            collector.next_token()
        len2, second = row_len(), poll()
        assert len2 > len1
        assert second == first
        env.delenv(faults.ENV)
        faults.reset()
        collector.result()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
