"""Multi-tenant LoRA serving in the port against the JAX package: mixed
adapters and base rows in one continuous-batching engine (greedy tokens
equal to the JAX bound model's for each adapter, over prefix cache on/off
x speculation on/off x chunked/one-shot prefill, pages of 4), the prefix
namespaces by adapter generation, more adapters than live slots, crash
recovery, a preempted adapter row, the ``/adapters/`` routes and the
``adapter_id(s)`` fields (statuses and bodies equal to the JAX app's),
``PUT /train/`` with an ``adapter``, the ``lora_*`` series, the ledger's
bytes and the tenant fallback.  The JAX oracles are computed once per
module; every wait carries its own timeout."""

import asyncio
import json
import queue
import shutil
import threading
import time
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models import lora as jlora
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import adapters as jadapters
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.models import decode_graphs, lora
from penroz_tpu_torch.serve import adapters, memledger, qos, spec_decode
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 120.0
TENANTS = {"tenA": (4, 11), "tenB": (2, 22)}     # rank, seed
JOBS = [("tenA", [1, 2, 1, 2, 1, 2]), (None, [5, 6, 5, 6]),
        ("tenB", [7, 8, 7, 8, 7])]
MAX_NEW = 5


def _layers():
    """The conftest ``toy_gpt_layers`` stack (d 32, 4 heads, vocab 64)."""
    d, vocab = 32, 64
    return ([{"summation": [
                {"embedding": {"num_embeddings": vocab, "embedding_dim": d}},
                {"position": {"num_embeddings": BLOCK, "embedding_dim": d}}]}]
            + [{"residual": [
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 3 * d}},
                    {"attention": {"num_heads": 4, "dropout": 0.0}},
                    {"linear": {"in_features": d, "out_features": d}}]},
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 4 * d}},
                    {"gelu": {}},
                    {"linear": {"in_features": 4 * d, "out_features": d}}]}]}
               for _ in range(2)]
            + [{"layernorm": {"normalized_shape": d}},
               {"linear": {"in_features": d, "out_features": vocab,
                           "bias": False}},
               {"softmaxlast": {"dim": -1}}])


@pytest.fixture(scope="module")
def ref():
    """The JAX model, each tenant's adapter tree, and the bound models'
    greedy tokens of every job (the oracles), computed once."""
    jm = JModel("mtgpt", JMapper(_layers(), SGD))
    trees = {}
    for aid, (rank, seed) in TENANTS.items():
        cfg = jlora.validate_config({"rank": rank})
        trees[aid] = (jlora.init_params(jm.arch, cfg, seed=seed,
                                        init="random"), cfg)
    oracles = {}
    for aid, prompt in JOBS + [("tenA", [1, 2, 3]), ("tenB", [1, 2, 3]),
                               (None, [1, 2, 3])]:
        model = jm if aid is None else jlora.bind_model(jm, *trees[aid])
        oracles[(aid, tuple(prompt))] = model.generate_tokens(
            [prompt], BLOCK, MAX_NEW, temperature=0.0)
    return {"jm": jm, "trees": trees, "oracles": oracles}


@pytest.fixture
def served(workdir, monkeypatch, ref):
    """The model's checkpoint and both tenants' adapters on disk (shared
    by the two packages), fresh registries and engines."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name in ("PENROZ_SPEC_DECODE", "PENROZ_PREFIX_CACHE",
                 "PENROZ_PREFILL_CHUNK", "TURBO_QUANT_KV_CACHE",
                 lora.MAX_LIVE_ENV, faults.ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    ref["jm"].serialize(sync_flush=True)
    for aid, (params, cfg) in ref["trees"].items():
        lora.save_adapter(aid, "mtgpt", cfg, params, {"code": "Created"},
                          sync_flush=True)
    for mod in (adapters, jadapters):
        mod.REGISTRY.reset()
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()
    serve_metrics.reset()
    yield {aid: adapters.REGISTRY.acquire(aid, "mtgpt") for aid in TENANTS}
    DS.reset()
    JDS.reset()
    decode_graphs.reset()
    for mod in (adapters, jadapters):
        mod.REGISTRY.reset()
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()
    tckpt.join_flushes()


@pytest.fixture
def make_engine():
    built = []

    def build(*args, side="torch", **kwargs):
        engine = (DS.DecodeEngine(*args, device="cpu", **kwargs)
                  if side == "torch" else JDS.DecodeEngine(*args, **kwargs))
        built.append(engine)
        return engine

    yield build
    for engine in built:
        engine.shutdown(timeout=WAIT_S)


class _Collector:
    def __init__(self, prompt):
        self.q = queue.Queue()
        self.tokens = list(prompt)

    def on_event(self, kind, value):
        self.q.put((kind, value))

    def result(self):
        while True:
            kind, value = self.q.get(timeout=WAIT_S)
            if kind == "token":
                self.tokens.append(value)
            elif kind == "done":
                return self.tokens
            else:
                raise value


def _submit(engine, prompt, max_new=MAX_NEW, adapter=None, side="torch",
            **fields):
    collector = _Collector(prompt)
    cls = DS.Request if side == "torch" else JDS.Request
    engine.submit(cls(prompt, max_new, None, collector.on_event,
                      adapter=adapter, **fields))
    return collector


def _want(ref, aid, prompt):
    return ref["oracles"][(aid, tuple(prompt))]


# ---------------------------------------------------------------------------
# The mixed batch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["nocache", "prefix"])
@pytest.mark.parametrize("spec", [False, True], ids=["nospec", "spec"])
@pytest.mark.parametrize("chunked", [False, True],
                         ids=["oneshot", "chunked"])
def test_mixed_adapter_parity_matrix(ref, served, make_engine, monkeypatch,
                                     prefix_cache, spec, chunked):
    """Adapters A, B and the base model in one engine, two waves: each
    row's greedy tokens are the JAX bound model's for its adapter, and
    the stats count the live adapters and each adapter's tokens."""
    if prefix_cache:
        monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
        monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "16")
    if spec:
        monkeypatch.setenv("PENROZ_SPEC_DECODE", "1")
        corpus = [_want(ref, aid, p) for aid, p in JOBS]

        def oracle_drafter(history, k, n):
            for seq in corpus:
                if len(history) < len(seq) and history == seq[:len(history)]:
                    return [int(t) for t in seq[len(history):len(history)
                                                + k]]
            return []

        monkeypatch.setattr(spec_decode, "propose", oracle_drafter)
    if chunked:
        monkeypatch.setenv("PENROZ_PREFILL_CHUNK", "4")
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=3)
    for wave in range(2):
        rows = [(aid, p, _submit(engine, p, adapter=served.get(aid)))
                for aid, p in JOBS]
        for aid, p, c in rows:
            assert c.result() == _want(ref, aid, p), (wave, aid)
    stats = engine.stats()
    assert stats["lora_active_adapters"] == 2
    assert stats["lora_rows"] == 0
    assert stats["lora_adapter_tokens"] == {"tenA": 2 * MAX_NEW,
                                            "tenB": 2 * MAX_NEW}
    assert stats["tenant_tokens"] == {"tenA": 2 * MAX_NEW,
                                      "default": 2 * MAX_NEW,
                                      "tenB": 2 * MAX_NEW}
    if spec:
        assert stats["spec_drafted_tokens"] > 0
    if prefix_cache:
        assert stats["prefix_cache"]["hits"] > 0
    assert engine._ledger.audit("test") == []


def test_lora_stats_match_jax_engine(ref, served, make_engine, monkeypatch):
    """The same mixed traffic through a JAX engine and the port's: the
    same tokens and the same ``lora_*`` stats, per engine and in
    ``serving_stats()``."""
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "16")
    monkeypatch.setenv("PENROZ_PREFILL_CHUNK", "4")
    jentries = {aid: jadapters.REGISTRY.acquire(aid, "mtgpt")
                for aid in TENANTS}
    got = {}
    for side, entries, mod in (("jax", jentries, JDS),
                               ("torch", served, DS)):
        engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=3,
                             side=side)
        rows = [_submit(engine, p, adapter=entries.get(aid), side=side)
                for aid, p in JOBS]
        tokens = [c.result() for c in rows]
        holder = [(aid, p, _submit(engine, p, max_new=8,
                                   adapter=entries.get(aid), side=side))
                  for aid, p in JOBS[:1]]
        tokens += [c.result() for _, _, c in holder]
        with mod._REG_LOCK:
            mod._ENGINES[("x",)] = engine
        agg = mod.serving_stats()
        with mod._REG_LOCK:
            del mod._ENGINES[("x",)]
        got[side] = (tokens, engine.stats(), agg)
    assert got["torch"][0] == got["jax"][0]
    for key in ("lora_active_adapters", "lora_rows", "lora_adapter_tokens",
                "tenant_tokens"):
        assert got["torch"][1][key] == got["jax"][1][key], key
        assert got["torch"][2][key] == got["jax"][2][key], key


def test_prefix_pages_never_cross_adapter_ids_or_generations(
        ref, served, make_engine, monkeypatch):
    """Base, A, base, A on one prompt: the adapter misses the base pages
    and hits only its own; an adapter reloaded under a new uid (retrained
    or recreated) misses its previous generation's pages."""
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "16")
    prompt = [1, 2, 3, 4, 5, 6, 7, 8, 9]   # two full pages
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=2)
    hits = []
    for adapter in (None, served["tenA"], None, served["tenA"]):
        _submit(engine, prompt, 3, adapter=adapter).result()
        hits.append(engine._prefix_cache.hits)
    assert hits == [0, 0, 1, 2]
    adapters.REGISTRY.invalidate("tenA")
    fresh = adapters.REGISTRY.acquire("tenA", "mtgpt")
    assert fresh.uid != served["tenA"].uid
    _submit(engine, prompt, 3, adapter=fresh).result()
    assert engine._prefix_cache.hits == 2
    _submit(engine, prompt, 3, adapter=fresh).result()
    assert engine._prefix_cache.hits == 3
    assert engine._ledger.audit("test") == []


def test_more_adapters_than_live_slots_all_complete(ref, served, make_engine,
                                                    monkeypatch):
    """With one live slot and three adapters in flight the later ones
    requeue at the head until the slot frees; every request completes
    with its own adapter's tokens, never a wrong-adapter forward."""
    monkeypatch.setenv(lora.MAX_LIVE_ENV, "1")
    params, cfg = ref["trees"]["tenA"]
    lora.save_adapter("tenC", "mtgpt", cfg, params, {"code": "Created"},
                      sync_flush=True)
    tenc = adapters.REGISTRY.acquire("tenC", "mtgpt")
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=4)
    rows = [(aid, _submit(engine, [1, 2, 3], adapter=entry))
            for aid, entry in (("tenA", served["tenA"]),
                               ("tenB", served["tenB"]), ("tenC", tenc),
                               (None, None))]
    for aid, c in rows:
        want = _want(ref, "tenA" if aid == "tenC" else aid, [1, 2, 3])
        assert c.result() == want, aid
    assert engine.stats()["lora_active_adapters"] == 1


def test_crash_recovery_rebuilds_adapter_row_tables(ref, served,
                                                    make_engine,
                                                    monkeypatch):
    monkeypatch.setenv(faults.ENV, "decode.step:raise@1")
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=2)
    c1 = _submit(engine, [1, 2, 3], 6, adapter=served["tenA"])
    c2 = _submit(engine, [5], 6)
    for c in (c1, c2):
        with pytest.raises(faults.InjectedFault):
            c.result()
    monkeypatch.delenv(faults.ENV)
    faults.reset()
    deadline = time.monotonic() + WAIT_S
    while engine.stats()["engine_resets"] < 1 \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    assert engine._lora_pack is None
    assert all(int(s) == engine._max_live for s in engine._row_adapter)
    assert all(e is None for e in engine._slot_entries)
    assert _submit(engine, [1, 2, 3], adapter=served["tenA"]).result() \
        == _want(ref, "tenA", [1, 2, 3])


def test_preempted_adapter_row_resumes_with_its_adapter(ref, served,
                                                        make_engine,
                                                        monkeypatch):
    """An adapter row of class ``batch`` holding the only row is preempted
    by an interactive base request during its first decode block; it
    resumes from its own namespace's pages (cached tokens > 0) with its
    adapter's tokens, and its tenant is its adapter id."""
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "16")
    monkeypatch.setenv(DS.SUPERSTEP_ENV, "1")
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=1)
    real = engine._model.decode_mixed_step
    calls, started, release = [0], threading.Event(), threading.Event()

    def held(*args, **kwargs):
        calls[0] += 1
        if calls[0] == 3:
            started.set()
            assert release.wait(WAIT_S)
        return real(*args, **kwargs)

    engine._model.decode_mixed_step = held
    prompt = [1, 2, 1, 2, 1, 2]
    a = _submit(engine, prompt, adapter=served["tenA"], priority="batch")
    assert started.wait(WAIT_S)
    b = _submit(engine, [5, 6, 5, 6], priority="interactive")
    release.set()
    assert b.result() == _want(ref, None, [5, 6, 5, 6])
    assert a.result() == _want(ref, "tenA", prompt)
    stats = engine.stats()
    assert stats["preemptions"] == 1
    # its KV at the preempt: two prefill chunks (4 + 2) and one decode
    # step, 7 tokens; one whole page resumes cached
    assert stats["preempted_resume_cached_tokens"] == 4
    assert stats["tenant_tokens"] == {"tenA": MAX_NEW, "default": MAX_NEW}
    assert stats["lora_adapter_tokens"] == {"tenA": MAX_NEW}
    assert engine._ledger.audit("test") == []


def test_tenant_falls_back_to_the_adapter_id():
    assert qos.tenant_of(None, "a1") == jqos.tenant_of(None, "a1") == "a1"
    assert qos.tenant_of("t", "a1") == jqos.tenant_of("t", "a1") == "t"
    assert qos.tenant_of(None, None) == jqos.tenant_of(None, None) \
        == "default"


# ---------------------------------------------------------------------------
# HTTP: the port's server and the JAX app on the same calls
# ---------------------------------------------------------------------------

def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            raw = resp.read()
            status = resp.status
    except urllib.error.HTTPError as e:
        raw, status = e.read(), e.code
    try:
        body = json.loads(raw) if raw else None
    except json.JSONDecodeError:
        body = raw.decode()
    if isinstance(body, dict):
        body.pop("request_id", None)
    return status, body


def _serve_jax():
    from aiohttp import web

    from penroz_tpu.serve import app as app_mod
    app_mod.model_locks.clear()
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


def _serve_torch():
    from penroz_tpu_torch.serve.app import create_app
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]

    def close():
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)
        assert srv.join_training(timeout=WAIT_S)

    return f"http://{host}:{port}", close


def _both(workdir, script):
    """``script(base, registry)`` against the JAX app, then, on a wiped
    models dir, against the port's server; returns both results."""
    out = {}
    for side, serve, registry in (
            ("jax", _serve_jax, jadapters.REGISTRY),
            ("torch", _serve_torch, adapters.REGISTRY)):
        for folder in (workdir / "models", workdir / "shm" / "models"):
            shutil.rmtree(folder, ignore_errors=True)
        for mod in (adapters, jadapters):
            mod.REGISTRY.reset()
        base, close = serve()
        try:
            out[side] = script(base, registry)
        finally:
            close()
            DS.reset()
            JDS.reset()
            tckpt.join_flushes()
    return out


def _model(base, model_id="mtgpt"):
    assert _call(base, "POST", "/model/", {
        "model_id": model_id, "layers": _layers(), "optimizer": SGD})[0] \
        == 200


def test_adapters_http_lifecycle_matches_jax(served, workdir):
    def script(base, registry):
        _model(base)
        _model(base, "other")
        calls = [
            ("POST", "/adapters/", {"model_id": "mtgpt", "adapter_id": "t1",
                                    "rank": 4, "init": "random",
                                    "seed": 3}),
            ("POST", "/adapters/", {"model_id": "mtgpt",
                                    "adapter_id": "t1"}),
            ("POST", "/adapters/", {"model_id": "ghost",
                                    "adapter_id": "t2"}),
            ("POST", "/adapters/", {"model_id": "mtgpt", "adapter_id": "t3",
                                    "rank": 4096}),
            ("POST", "/adapters/", {"model_id": "mtgpt", "adapter_id": "t4",
                                    "init": "gaussian"}),
            ("POST", "/adapters/", {"model_id": "mtgpt", "adapter_id": "t5",
                                    "targets": ["nomatch"]}),
            ("POST", "/adapters/", {"model_id": "mtgpt"}),
            ("POST", "/adapters/", {"model_id": "other", "adapter_id": "o1",
                                    "rank": 2, "targets": ["layers.4"]}),
            ("GET", "/adapters/", None),
            ("GET", "/adapters/?adapter_id=t1", None),
            ("GET", "/adapters/?adapter_id=nope", None),
            ("DELETE", "/adapters/?adapter_id=t1", None),
            ("DELETE", "/adapters/?adapter_id=t1", None),
            ("DELETE", "/adapters/", None),
            ("GET", "/adapters/", None),
            ("DELETE", "/model/?model_id=other", None),
            ("GET", "/adapters/", None),
        ]
        return [_call(base, m, p, b) for m, p, b in calls]

    got = _both(workdir, script)
    for i, (j, t) in enumerate(zip(got["jax"], got["torch"])):
        assert t[0] == j[0], (i, t, j)
        if t[0] in (200, 204, 404, 409) or i == 3:
            assert t[1] == j[1], (i, t, j)
        else:
            assert "detail" in t[1], (i, t)


@pytest.mark.parametrize("batching", ["0", "1"], ids=["single", "sched"])
def test_adapter_fields_errors_match_jax(served, workdir, monkeypatch,
                                         batching):
    """An unknown ``adapter_id`` 400 naming it (both routes), every bad
    row of ``adapter_ids`` named in one 400, a length mismatch 400, and
    a 409 while another request loads the adapter: the JAX app's
    statuses and bodies."""
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", batching)

    def gen(**kw):
        return dict({"model_id": "mtgpt", "input": [[1, 2, 3]],
                     "block_size": BLOCK, "max_new_tokens": 3,
                     "temperature": 0.0}, **kw)

    def batch(**kw):
        return dict({"model_id": "mtgpt", "inputs": [[1, 2], [3, 4], [5, 6]],
                     "block_size": BLOCK, "max_new_tokens": 3,
                     "temperature": 0.0}, **kw)

    def script(base, registry):
        _model(base)
        out = [_call(base, "POST", "/adapters/", {
            "model_id": "mtgpt", "adapter_id": "ok", "rank": 2})[0]]
        out.append(_call(base, "POST", "/generate/",
                         gen(adapter_id="ghost")))
        out.append(_call(base, "POST", "/generate_batch/",
                         batch(adapter_ids=["bad1", "ok", "bad1"])))
        out.append(_call(base, "POST", "/generate_batch/",
                         batch(adapter_ids=["ok"])))
        out.append(_call(base, "POST", "/generate_batch/",
                         batch(adapter_id="bad2")))
        _call(base, "POST", "/adapters/", {"model_id": "mtgpt",
                                           "adapter_id": "slowy"})
        monkeypatch.setenv(faults.ENV, "lora.load:sleep@500")
        holder = threading.Thread(target=lambda: registry.acquire(
            "slowy", "mtgpt"))
        holder.start()
        time.sleep(0.15)
        out.append(_call(base, "POST", "/generate/",
                         gen(adapter_id="slowy")))
        out.append(_call(base, "POST", "/generate_batch/",
                         batch(adapter_ids=[None, "slowy", None])))
        holder.join(WAIT_S)
        monkeypatch.delenv(faults.ENV)
        for mod in (faults, jfaults):
            mod.reset()
        return out

    got = _both(workdir, script)
    for i, (j, t) in enumerate(zip(got["jax"], got["torch"])):
        assert t == j, (i, t, j)


def test_delete_model_flushes_its_adapters(served, workdir):
    base, close = _serve_torch()
    try:
        _model(base, "other")
        for model_id, aid in (("mtgpt", "mine"), ("other", "theirs")):
            assert _call(base, "POST", "/adapters/", {
                "model_id": model_id, "adapter_id": aid, "rank": 2})[0] \
                == 200
        adapters.REGISTRY.acquire("mine", "mtgpt")
        assert _call(base, "DELETE", "/model/?model_id=mtgpt")[0] == 204
        assert tckpt.list_adapter_ids() == ["theirs"]
        assert adapters.REGISTRY.cached_ids() == []
        _, body = _call(base, "GET", "/adapters/")
        assert [a["adapter_id"] for a in body["adapters"]] == ["theirs"]
    finally:
        close()


@pytest.mark.parametrize("batching", ["0", "1"], ids=["single", "sched"])
def test_api_trained_adapter_roundtrips_and_serves(served, workdir,
                                                   toy_shards, monkeypatch,
                                                   batching):
    """``PUT /train/`` with an ``adapter``: 202 naming it, a 409 while it
    trains, ``GET /adapters/?adapter_id=`` going Trained with one progress
    entry an epoch, the base model's status untouched, and the adapter
    serving on /generate/ (streamed too) what the JAX bound model
    generates from the trained factors; a bad adapter config is a 400 or
    422 before the 202."""
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", batching)
    base, close = _serve_torch()
    try:
        train = {"model_id": "mtgpt", "device": "cpu",
                 "dataset_id": toy_shards, "shard": 0, "epochs": 2,
                 "batch_size": 2, "block_size": 8, "step_size": 1,
                 "adapter": {"adapter_id": "ft", "rank": 2}}
        status, body = _call(base, "PUT", "/train/", train)
        assert status == 202, body
        assert body["message"] == ("Training for adapter ft on model mtgpt "
                                   "started asynchronously.")
        deadline = time.monotonic() + WAIT_S
        while time.monotonic() < deadline:
            status, body = _call(base, "GET", "/adapters/?adapter_id=ft")
            if status == 200 and body["status"]["code"] in ("Trained",
                                                            "Error"):
                break
            time.sleep(0.1)
        assert body["status"]["code"] == "Trained", body
        assert [p["epoch"] for p in body["progress"]] == [1, 2]
        assert body["rank"] == 2 and body["alpha"] == 4.0
        assert _call(base, "GET", "/progress/?model_id=mtgpt")[1][
            "status"]["code"] == "Created"
        blob = tckpt.load_adapter("ft")
        params = {k: v.numpy() for k, v in blob["params"].items()}
        want = jlora.bind_model(JModel.deserialize("mtgpt"), params,
                                blob["config"]).generate_tokens(
            [[1, 2, 3]], BLOCK, 4, temperature=0.0)
        gen = {"model_id": "mtgpt", "input": [[1, 2, 3]],
               "block_size": BLOCK, "max_new_tokens": 4,
               "temperature": 0.0, "adapter_id": "ft"}
        status, body = _call(base, "POST", "/generate/", gen)
        assert status == 200 and body["tokens"] == want, body
        status, text = _call(base, "POST", "/generate/",
                             dict(gen, stream=True))
        assert status == 200
        assert [int(t) for t in str(text).split()] == want[3:]
        for adapter, code in (({"adapter_id": "bad", "rank": 4096}, 400),
                              ({"rank": 2}, 422),
                              ({"adapter_id": "bad", "rank": "x"}, 422)):
            status, body = _call(base, "PUT", "/train/",
                                 dict(train, adapter=adapter))
            assert status == code, body
        assert "bad" not in tckpt.list_adapter_ids()
    finally:
        close()


def test_lora_metrics_and_ledger_bytes(ref, served, make_engine,
                                       monkeypatch):
    """``/metrics``' ``lora_*`` series equal ``serving_stats()``'s, and the
    ledger's ``lora_pack`` is the pack's bytes, its ``adapter_host_cache``
    the registry's, its ``adapter_pages`` the adapter rows' pages."""
    from test_torch_metrics import parse_exposition
    engine = DS.get_engine("mtgpt", BLOCK, 0.0, None, device="cpu")
    rows = [_submit(engine, p, adapter=served.get(aid)) for aid, p in JOBS]
    for c in rows:
        c.result()
    got = parse_exposition(serve_metrics.render())
    stats = DS.serving_stats()
    assert got["penroz_lora_live_adapters"] == stats[
        "lora_active_adapters"] == 2
    for aid, n in stats["lora_adapter_tokens"].items():
        assert got[f'penroz_lora_adapter_tokens_total{{adapter_id="{aid}"}}'] \
            == n == MAX_NEW
    mem = memledger.memory_stats()
    R, L = lora.max_rank(), lora.max_live()
    want = sum((L + 1) * (R * i + o * R + 1) * 4
               for _, i, o in lora.target_linears(engine._model.arch))
    assert mem["engines"][0]["hbm_bytes"]["lora_pack"] == want \
        == mem["hbm_bytes"]["lora_pack"]
    assert got['penroz_hbm_bytes{component="lora_pack"}'] == want
    assert mem["hbm_bytes"]["adapter_host_cache"] \
        == adapters.REGISTRY.cache_bytes() > 0
    # an adapter row's pages while it runs
    hold = threading.Event()
    real = engine._model.decode_mixed_step
    seen = []

    def held(*args, **kwargs):
        seen.append(memledger.memory_stats()["engines"][0]["adapter_pages"])
        return real(*args, **kwargs)

    engine._model.decode_mixed_step = held
    _submit(engine, [1, 2, 3, 4, 5, 6], adapter=served["tenB"]).result()
    hold.set()
    assert {"tenB": 2} in seen


def test_adapter_takes_a_free_slot_before_an_idle_one(served, make_engine):
    """A new adapter takes an empty live slot while one exists, and never
    the slot of an idle adapter then, so the idle one stays live (the
    JAX engine takes the first slot that is empty or idle)."""
    engine = make_engine("mtgpt", BLOCK, 0.0, None, capacity=3)

    def slot(aid):
        req = DS.Request([1, 2], 1, None, lambda *a: None,
                         adapter=served[aid])
        with engine._cond:
            return engine._adapter_slot(req)

    assert slot("tenA") == 0            # idle: no row of tenA in flight
    assert slot("tenB") == 1
    assert slot("tenA") == 0
    assert engine.live_adapters == 2
