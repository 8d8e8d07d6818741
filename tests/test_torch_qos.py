"""The port's multi-tenant QoS (serve/qos.py and the engine's fair queue,
quotas and preemption) against the JAX package's, on the CPU.

- ``WFQueue``: the same random push / push_front / pop / pop_class /
  purge sequences give the same pops under the default and custom
  ``PENROZ_QOS_WEIGHTS``.
- ``QuotaManager``: the same admits and charges under a patched clock give
  the same sheds, Retry-After values and stats.
- Preemption: a ``batch`` row evicted for a queued ``interactive`` request
  resumes greedy token-identical to the unpreempted run and to the JAX
  engine's run of the same scenario (fp32 and int8 pages, superstep 1 and
  8), with the same ``preemptions`` and ``preempted_resume_cached_tokens``
  and no pin left.
- A per-class bound sheds only its class; a quota only its tenant; an
  injected ``qos.preempt`` crash recovers with no leaked pin;
  ``PENROZ_QOS_PREEMPT=0`` queues instead of preempting.
- ``GET /tenants/`` and ``PUT /tenants/{id}/quota`` answer as the JAX
  app's handlers do, ``tier_mb`` (the session tiers' residency cap)
  included.

Toy size: a 2-layer d-32 GPT, block 16, pages of 4 tokens, 16 cache
pages (the JAX suite's ``_preempt_env``)."""

import asyncio
import json
import queue
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import qos
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults as tfaults

BLOCK = 16
WAIT_S = 120.0
PA, PB = [1, 2, 3, 4, 5, 6], [9, 10]


@pytest.fixture(autouse=True)
def _qos_state():
    for mod in (qos, jqos):
        mod.reset()
    tfaults.reset()
    jfaults.reset()
    yield
    for mod in (qos, jqos):
        mod.reset()
    tfaults.reset()
    jfaults.reset()


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel("qos", JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), {"sgd": {"lr": 0.1}}))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def preempt_env(monkeypatch):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "16")
    for name in ("TURBO_QUANT_KV_CACHE", "PENROZ_SPEC_DECODE",
                 qos.PREEMPT_ENV, qos.TENANT_RATE_ENV, tfaults.ENV):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.fixture
def engines():
    built = []

    def build(side, *args, **kwargs):
        if side == "torch":
            engine = DS.DecodeEngine(*args, device="cpu", **kwargs)
        else:
            engine = JDS.DecodeEngine(*args, **kwargs)
        built.append(engine)
        return engine

    yield build
    for engine in built:
        engine.shutdown(timeout=WAIT_S)


class _Handle:
    """A request's events on a thread queue (either package's Request)."""

    def __init__(self, side, prompt, max_new, **fields):
        self.q = queue.Queue()
        self.prompt = list(prompt)
        cls = DS.Request if side == "torch" else JDS.Request
        self.req = cls(prompt, max_new, None,
                       lambda kind, value: self.q.put((kind, value)),
                       **fields)
        self.tokens = []

    def wait_tokens(self, n):
        while len(self.tokens) < n:
            kind, value = self.q.get(timeout=WAIT_S)
            assert kind == "token", (kind, value)
            self.tokens.append(value)

    def result(self):
        while True:
            kind, value = self.q.get(timeout=WAIT_S)
            if kind == "token":
                self.tokens.append(value)
            elif kind == "done":
                return self.prompt + self.tokens
            else:
                raise value


def _submit(engine, side, prompt, max_new, **fields):
    handle = _Handle(side, prompt, max_new, **fields)
    engine.submit(handle.req)
    return handle


def _pins(cache) -> int:
    return sum(nd.refs for nd in cache.iter_nodes())


# -- WFQueue and QuotaManager against the JAX package's ----------------------

class _Req:
    def __init__(self, i, tenant, priority, t):
        self.i, self.tenant, self.priority = i, tenant, priority
        self.prompt = [0] * (1 + i % 3)
        self.enqueue_t = t


@pytest.mark.parametrize("weights", [None, "interactive:3,batch:2",
                                     "standard:7,junk,batch:x"])
@pytest.mark.parametrize("seed", range(4))
def test_wfqueue_pops_match_jax(monkeypatch, weights, seed):
    if weights is None:
        monkeypatch.delenv(qos.WEIGHTS_ENV, raising=False)
    else:
        monkeypatch.setenv(qos.WEIGHTS_ENV, weights)
    assert qos.weights() == jqos.weights()
    rng = np.random.default_rng(seed)
    ours, ref = qos.WFQueue(), jqos.WFQueue()
    reqs = []
    for step in range(300):
        op = rng.choice(["push", "push", "push", "front", "pop", "pop",
                         "cls", "purge"])
        if op in ("push", "front"):
            r = _Req(len(reqs), f"t{rng.integers(3)}",
                     qos.PRIORITIES[rng.integers(3)], float(step))
            reqs.append(r)
            for q in (ours, ref):
                (q.push if op == "push" else q.push_front)(r)
        elif op == "pop":
            a, b = ours.pop(), ref.pop()
            assert (a and a.i) == (b and b.i)
        elif op == "cls":
            cls = qos.PRIORITIES[rng.integers(3)]
            a, b = ours.pop_class(cls), ref.pop_class(cls)
            assert (a and a.i) == (b and b.i)
        else:
            k = int(rng.integers(2, 5))
            assert ([r.i for r in ours.purge(lambda r: r.i % k == 0)]
                    == [r.i for r in ref.purge(lambda r: r.i % k == 0)])
        assert len(ours) == len(ref)
        assert ours.class_depths() == ref.class_depths()
        assert ours.tenant_depths() == ref.tenant_depths()
        assert ours.oldest_enqueue_t() == ref.oldest_enqueue_t()
    assert [r.i for r in ours.drain()] == [r.i for r in ref.drain()]


@pytest.mark.parametrize("rate", ["0", "0.5", "3"])
def test_quota_retry_after_matches_jax(monkeypatch, rate):
    monkeypatch.setenv(qos.TENANT_RATE_ENV, rate)
    rng = np.random.default_rng(int(float(rate) * 10))
    ours, ref = qos.QuotaManager(), jqos.QuotaManager()
    now = 100.0
    for step in range(200):
        now += float(rng.uniform(0, 2.0))
        tenant = f"t{rng.integers(3)}"
        op = rng.integers(4)
        if op == 0:
            got = []
            for mgr, exc in ((ours, qos.TenantQuotaExceeded),
                             (ref, jqos.TenantQuotaExceeded)):
                try:
                    mgr.admit(tenant, now=now)
                    got.append(None)
                except exc as e:
                    got.append((e.tenant, e.retry_after, str(e)))
            assert got[0] == got[1]
        elif op in (1, 2):
            n = int(rng.integers(0, 9))
            ours.charge(tenant, n, now=now)
            ref.charge(tenant, n, now=now)
        elif step % 5 == 0:
            r = [None, 0.0, 0.2, 2.0][int(rng.integers(4))]
            ours.set_rate(tenant, r)
            ref.set_rate(tenant, r)
        assert ours.stats() == ref.stats()
        assert ours.rate_for(tenant) == ref.rate_for(tenant)


# -- preemption: parity with the JAX engine and the unpreempted run ----------

def _hold_dispatch(engine, n):
    """Hold the engine's ``n``-th block at its dispatch until the returned
    event is set: a request submitted meanwhile is seen at the boundary
    after that block, the same one in either engine."""
    real = engine._model.decode_mixed_step
    calls, started, release = [0], threading.Event(), threading.Event()

    def held(*args, **kwargs):
        calls[0] += 1
        if calls[0] == n:
            started.set()
            assert release.wait(WAIT_S)
        return real(*args, **kwargs)

    engine._model.decode_mixed_step = held
    return started, release


def _preempt_scenario(side, build, max_a=10):
    """A ``batch`` request holds the only row; an ``interactive`` one
    arrives during its first decode block and preempts it at that block's
    end.  Returns (tokens A, tokens B, stats, pins left)."""
    engine = build(side, "qos", BLOCK, 0.0, None, capacity=1)
    started, release = _hold_dispatch(engine, 2)
    a = _submit(engine, side, PA, max_a, priority="batch", tenant="flood")
    assert started.wait(WAIT_S)     # the victim's first decode block
    b = _submit(engine, side, PB, 4, priority="interactive", tenant="ui")
    release.set()
    got_b, got_a = b.result(), a.result()
    stats = engine.stats()
    assert engine.active_rows == 0
    return got_a, got_b, stats, _pins(engine._prefix_cache)


@pytest.mark.parametrize("int8", [0, 1], ids=["fp32", "int8"])
@pytest.mark.parametrize("superstep", [1, 8])
def test_preempt_resume_parity(jmodel, preempt_env, engines, int8,
                               superstep):
    """The counterpart of the JAX suite's preemption matrix: both engines
    preempt once, resume from whole cached pages, release every pin, and
    emit the unpreempted greedy tokens."""
    preempt_env.setenv(DS.SUPERSTEP_ENV, str(superstep))
    if int8:
        preempt_env.setenv("TURBO_QUANT_KV_CACHE", "1")
    base_a = jmodel.generate_tokens([PA], BLOCK, 10, temperature=0.0)
    base_b = jmodel.generate_tokens([PB], BLOCK, 4, temperature=0.0)
    got = {side: _preempt_scenario(side, engines)
           for side in ("jax", "torch")}
    for side, (tok_a, tok_b, stats, pins) in got.items():
        assert (tok_a, tok_b) == (base_a, base_b), side
        assert stats["preemptions"] == 1, side
        assert stats["completed"] == 2 and pins == 0, side
        assert stats["admissions_by_class"] == {
            "interactive": 1, "standard": 0, "batch": 2}, side
    cached = {side: got[side][2]["preempted_resume_cached_tokens"]
              for side in got}
    # the victim's KV at the preempt: the prompt, then one block of
    # min(superstep, 8) decode steps; its whole pages resume cached
    assert cached["torch"] == cached["jax"] == (
        (len(PA) + min(superstep, 8)) // 4 * 4)
    assert (got["torch"][2]["tenant_tokens"]
            == got["jax"][2]["tenant_tokens"] == {"flood": 10, "ui": 4})


def test_sampled_request_survives_preemption(jmodel, preempt_env, engines):
    """A sampled row is preempted like a greedy one (as in the JAX engine);
    its resume keeps the stream whole: the full budget, in the vocabulary,
    its prefix before the preempt unchanged."""
    preempt_env.setenv(DS.SUPERSTEP_ENV, "1")
    preempt_env.setenv(tfaults.ENV, "decode.step:sleep@40")
    engine = engines("torch", "qos", BLOCK, 0.8, None, capacity=1)
    a = _submit(engine, "torch", PA, 10, priority="batch")
    a.wait_tokens(2)
    head = list(a.tokens)
    b = _submit(engine, "torch", PB, 4, priority="interactive")
    assert len(b.result()) == len(PB) + 4
    seq = a.result()
    assert len(seq) == len(PA) + 10 and seq[len(PA):len(PA) + 2] == head
    assert all(0 <= t < 64 for t in seq)
    assert engine.stats()["preemptions"] == 1
    assert _pins(engine._prefix_cache) == 0


def test_preempt_off_queues_instead(jmodel, preempt_env, engines):
    """``PENROZ_QOS_PREEMPT=0``: the interactive request waits for the row;
    no preemption, the same tokens."""
    preempt_env.setenv(qos.PREEMPT_ENV, "0")
    preempt_env.setenv(DS.SUPERSTEP_ENV, "1")
    base_a = jmodel.generate_tokens([PA], BLOCK, 6, temperature=0.0)
    base_b = jmodel.generate_tokens([PB], BLOCK, 4, temperature=0.0)
    preempt_env.setenv(tfaults.ENV, "decode.step:sleep@30")
    engine = engines("torch", "qos", BLOCK, 0.0, None, capacity=1)
    a = _submit(engine, "torch", PA, 6, priority="batch")
    a.wait_tokens(1)
    b = _submit(engine, "torch", PB, 4, priority="interactive")
    assert a.result() == base_a and b.result() == base_b
    stats = engine.stats()
    assert stats["preemptions"] == 0
    assert stats["preempted_resume_cached_tokens"] == 0


def test_preempt_crash_recovers_with_no_leaked_pins(jmodel, preempt_env,
                                                    engines):
    """A crash injected at ``qos.preempt`` fails the tick before any
    mutation; the reset rebuilds the pool and the cache, no pin survives,
    and both requests replay greedy-identical."""
    preempt_env.setenv(DS.SUPERSTEP_ENV, "1")
    base_a = jmodel.generate_tokens([PA], BLOCK, 8, temperature=0.0)
    base_b = jmodel.generate_tokens([PB], BLOCK, 4, temperature=0.0)
    preempt_env.setenv(tfaults.ENV,
                       "qos.preempt:raise@1,decode.step:sleep@40")
    engine = engines("torch", "qos", BLOCK, 0.0, None, capacity=1)
    a = _submit(engine, "torch", PA, 8, priority="batch")
    a.wait_tokens(1)
    b = _submit(engine, "torch", PB, 4, priority="interactive")
    for handle in (a, b):
        with pytest.raises(tfaults.InjectedFault):
            handle.result()
    preempt_env.delenv(tfaults.ENV)
    tfaults.reset()
    stats = engine.stats()
    assert stats["crashes_total"] == 1 and stats["engine_resets"] == 1
    assert stats["preemptions"] == 0
    assert _pins(engine._prefix_cache) == 0
    assert _submit(engine, "torch", PA, 8,
                   priority="batch").result() == base_a
    assert _submit(engine, "torch", PB, 4,
                   priority="interactive").result() == base_b


def test_class_bound_and_quota_shed_only_their_target(jmodel, preempt_env,
                                                      engines):
    """``PENROZ_QOS_MAX_QUEUE_BATCH=1`` sheds the second queued batch
    request while an interactive one still queues; an exhausted tenant is
    refused while another tenant is served, with the same tokens."""
    preempt_env.setenv(qos.PREEMPT_ENV, "0")
    preempt_env.setenv(DS.SUPERSTEP_ENV, "1")
    preempt_env.setenv("PENROZ_QOS_MAX_QUEUE_BATCH", "1")
    preempt_env.setenv(DS.MAX_QUEUE_ENV, "8")
    base = {tuple(p): jmodel.generate_tokens([p], BLOCK, 3, temperature=0.0)
            for p in ([1, 2, 3], [5], [9, 10])}
    preempt_env.setenv(tfaults.ENV, "decode.step:sleep@40")
    engine = engines("torch", "qos", BLOCK, 0.0, None, capacity=1)
    ca = _submit(engine, "torch", [1, 2, 3], 3)
    ca.wait_tokens(1)
    cb = _submit(engine, "torch", [5], 3, priority="batch")
    with pytest.raises(DS.QueueFullError, match="batch") as exc:
        _submit(engine, "torch", [6], 3, priority="batch")
    assert exc.value.retry_after >= 1
    ci = _submit(engine, "torch", [9, 10], 3, priority="interactive")
    assert ca.result() == base[(1, 2, 3)]
    assert cb.result() == base[(5,)]
    assert ci.result() == base[(9, 10)]
    assert engine.stats()["queue_rejections"] == 1
    # the quota: a near-zero refill makes the second admission certain
    preempt_env.delenv(tfaults.ENV)
    preempt_env.setenv(qos.TENANT_RATE_ENV, "0.05")
    assert _submit(engine, "torch", [1, 2, 3], 3,
                   tenant="noisy").result() == base[(1, 2, 3)]
    with pytest.raises(qos.TenantQuotaExceeded) as exc:
        _submit(engine, "torch", [1, 2, 3], 3, tenant="noisy")
    assert exc.value.tenant == "noisy" and exc.value.retry_after >= 1
    assert _submit(engine, "torch", [1, 2, 3], 3,
                   tenant="victim").result() == base[(1, 2, 3)]
    stats = engine.stats()
    assert stats["quota_rejections"] == 1
    assert qos.QUOTAS.stats()["charged"] == {"noisy": 6, "victim": 6}
    assert qos.QUOTAS.stats()["rejections"] == {"noisy": 1}


# -- /tenants/ against the JAX app -------------------------------------------

def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"null")


def _serve_jax():
    from aiohttp import web

    from penroz_tpu.serve import app as app_mod
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app_mod.create_app())
    started = threading.Event()
    box = {}

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(WAIT_S)

    def close():
        asyncio.run_coroutine_threadsafe(runner.cleanup(),
                                         loop).result(WAIT_S)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(WAIT_S)
        loop.close()

    return f"http://127.0.0.1:{box['port']}", close


def test_tenant_routes_match_jax(workdir, monkeypatch):
    from penroz_tpu_torch.serve.app import create_app
    monkeypatch.delenv(qos.TENANT_RATE_ENV, raising=False)
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    ours = "http://%s:%d" % srv.server_address[:2]
    ref, close = _serve_jax()
    steps = [("PUT", "/tenants/acme/quota", {"tokens_per_s": 2.5}),
             ("PUT", "/tenants/zeta/quota", {"tokens_per_s": 0}),
             ("GET", "/tenants/", None),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": None}),
             ("GET", "/tenants/", None),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": -1}),
             ("PUT", "/tenants/acme/quota", {}),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": "x"}),
             # the tier residency cap (the session tiers' quota)
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": 1,
                                             "tier_mb": 64}),
             ("GET", "/tenants/", None),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": 1}),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": 1,
                                             "tier_mb": -1}),
             ("PUT", "/tenants/acme/quota", {"tokens_per_s": None,
                                             "tier_mb": None}),
             ("GET", "/tenants/", None)]
    try:
        for i, (method, path, body) in enumerate(steps):
            qos.reset()
            jqos.reset()
            for m, p, b in steps[:i]:
                if m == "PUT":
                    _call(ours, m, p, b)
                    _call(ref, m, p, b)
            got, want = _call(ours, method, path, body), _call(ref, method,
                                                                path, body)
            assert got[0] == want[0], (path, body, got, want)
            if got[0] == 200:
                assert got[1] == want[1], (path, body)
        status, body = _call(ours, "PUT", "/tenants/acme/quota",
                             {"tokens_per_s": 1, "tier_mb": 64})
        assert status == 200 and body["tier_bytes"] == 64e6
    finally:
        close()
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)
