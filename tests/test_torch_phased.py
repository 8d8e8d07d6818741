"""The port's phased ticks (continuous batching over the contiguous cache,
and over the paged pool with ``PENROZ_RAGGED_ATTENTION=0``) against the
JAX package on the same weights: the greedy tokens of concurrent requests
equal the JAX single-sequence and phased-engine tokens and the port's
single-sequence ones, at superstep 1 and 8, with chunked prefill, fp32
and int8, with an adapter row; speculation gives the spec-off tokens (an
oracle drafter is fully accepted); sampled runs are deterministic.  Every
wait carries its own timeout."""

import time

import pytest

from penroz_tpu.models import lora as jlora
from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.models import lora
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve import adapters, qos, spec_decode
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 32
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 120.0
JOBS = [([1, 2, 3], 12), ([7, 5, 9, 11, 4, 4, 2, 8, 30, 17], 8),
        ([5, 6, 5, 6, 5, 6], 10)]
CACHES = {"contiguous": {},
          "paged": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "4",
                    "PENROZ_RAGGED_ATTENTION": "0"}}
_KNOBS = ("PAGED_KV_CACHE", "PENROZ_KV_PAGE_SIZE", "PENROZ_RAGGED_ATTENTION",
          "TURBO_QUANT_KV_CACHE", "PENROZ_SCHED_SUPERSTEP",
          "PENROZ_PREFILL_CHUNK", "PENROZ_SPEC_DECODE", "PENROZ_PREFIX_CACHE",
          "PENROZ_SERVE_PIPE_STAGES", lora.MAX_LIVE_ENV, faults.ENV)


def _layers():
    return jpresets.gpt2_custom(d=32, heads=4, depth=2, vocab=64,
                                block=BLOCK)


@pytest.fixture(scope="module")
def oracles():
    """The JAX model and its greedy single-sequence tokens of every job,
    fp32 and int8, computed once (the model is rebuilt from its seed)."""
    import os
    jm = JModel("phased", JMapper(_layers(), SGD))
    out = {}
    saved = os.environ.get("TURBO_QUANT_KV_CACHE")
    try:
        for int8 in (False, True):
            os.environ["TURBO_QUANT_KV_CACHE"] = "1" if int8 else "0"
            out[int8] = [jm.generate_tokens([p], BLOCK, n, temperature=0.0)
                         for p, n in JOBS]
    finally:
        if saved is None:
            os.environ.pop("TURBO_QUANT_KV_CACHE", None)
        else:
            os.environ["TURBO_QUANT_KV_CACHE"] = saved
    return {"jm": jm, "tokens": out}


@pytest.fixture
def env(workdir, monkeypatch, oracles):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    oracles["jm"].serialize(sync_flush=True)
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()
    yield monkeypatch
    DS.reset()
    JDS.reset()


@pytest.fixture
def make_engine():
    engines = []

    def build(pkg, *args, **kwargs):
        if pkg == "torch":
            kwargs["device"] = "cpu"
        engine = (DS if pkg == "torch" else JDS).DecodeEngine(*args, **kwargs)
        engines.append(engine)
        return engine

    yield build
    for engine in engines:
        engine.shutdown(timeout=WAIT_S)


class _Collector:
    def __init__(self, prompt):
        import queue
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


def _settled(engine):
    """Wait until the worker has left the tick that delivered the last
    ``done`` (its counters are written after the delivery)."""
    deadline = time.monotonic() + WAIT_S
    while engine._dispatch_t0 is not None or engine.active_rows:
        assert time.monotonic() < deadline, "the engine never settled"
        time.sleep(0.005)
    return engine


def _overlapping(pkg, engine, jobs, **fields):
    """Submit every job while the worker is held (one admission boundary),
    then collect each sequence."""
    mod = DS if pkg == "torch" else JDS
    collectors = []
    with engine._cond:
        for prompt, n in jobs:
            c = _Collector(prompt)
            engine._pending.push(mod.Request(prompt, n, None, c.on_event,
                                             **fields))
            collectors.append(c)
        engine._cond.notify_all()
    out = [c.result() for c in collectors]
    _settled(engine)
    return out


def _setup(env, cache, int8=False, superstep="8", chunk="4"):
    for name, value in CACHES[cache].items():
        env.setenv(name, value)
    env.setenv("TURBO_QUANT_KV_CACHE", "1" if int8 else "0")
    env.setenv("PENROZ_SCHED_SUPERSTEP", superstep)
    env.setenv("PENROZ_PREFILL_CHUNK", chunk)


@pytest.mark.parametrize("superstep,chunk", [("1", "4"), ("8", "256"),
                                             ("8", "4")])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("cache", list(CACHES))
def test_phased_greedy_matches_jax(env, oracles, make_engine, cache, int8,
                                   superstep, chunk):
    _setup(env, cache, int8, superstep, chunk)
    want = oracles["tokens"][int8]
    engine = make_engine("torch", "phased", BLOCK, 0.0, None, capacity=3)
    assert not engine._unified()
    assert engine._kv.quantized == int8
    assert _overlapping("torch", engine, JOBS) == want
    model = NeuralNetworkModel.deserialize("phased", device="cpu")
    assert [model.generate_tokens([p], BLOCK, n, temperature=0)
            for p, n in JOBS] == want
    stats = engine.stats()
    timeline = stats["tick_timeline"]
    assert timeline and not any(t["unified"] for t in timeline)
    assert stats["completed"] == stats["admissions"] == len(JOBS)
    assert stats["decode_tokens"] == sum(n for _, n in JOBS) - len(JOBS)
    assert max(t["superstep"] for t in timeline) <= int(superstep)
    if superstep == "8":
        assert max(t["superstep"] for t in timeline) > 1
    if chunk == "4":
        # the long prompt prefills in chunks between decode steps
        assert stats["prefill_chunks"] > len(JOBS)
        assert stats["prefill_max_chunks_between_steps"] >= 1
    assert stats["memory"]["paged"] == (cache == "paged")
    assert stats["memory"]["hbm_bytes"]["kv_values"] > 0
    # a retired row's slot serves the next request
    assert DS.run_request(engine, JOBS[1][0], JOBS[1][1], None,
                          timeout=WAIT_S) == want[1]


@pytest.mark.parametrize("cache", list(CACHES))
def test_phased_engine_matches_jax_engine(env, make_engine, cache):
    """The JAX phased engine and the port's, on the same knobs, give the
    same tokens and the same tick accounting."""
    _setup(env, cache, superstep="8", chunk="4")
    got = {}
    for pkg in ("jax", "torch"):
        engine = make_engine(pkg, "phased", BLOCK, 0.0, None, capacity=3)
        got[pkg] = (_overlapping(pkg, engine, JOBS), {
            k: engine.stats()[k] for k in (
                "prefill_chunks", "decode_tokens", "completed",
                "dispatches_total", "decode_steps")})
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("cache", list(CACHES))
def test_phased_speculation(env, oracles, make_engine, monkeypatch, cache):
    """Prompt-lookup speculation on the phased ticks gives the spec-off
    tokens; an oracle drafter (the greedy continuation itself) is fully
    accepted, each verify span emitting its draft and one more."""
    _setup(env, cache, superstep="8", chunk="4")
    want = oracles["tokens"][False]
    env.setenv("PENROZ_SPEC_DECODE", "1")
    engine = make_engine("torch", "phased", BLOCK, 0.0, None, capacity=3)
    assert _overlapping("torch", engine, JOBS) == want
    assert engine.stats()["spec_decode"] is True

    def oracle(history, k, n):
        for seq in want:
            if len(history) < len(seq) and history == seq[:len(history)]:
                return seq[len(history):len(history) + k]
        return []

    monkeypatch.setattr(spec_decode, "propose", oracle)
    engine = make_engine("torch", "phased", BLOCK, 0.0, None, capacity=3)
    assert _overlapping("torch", engine, JOBS) == want
    stats = engine.stats()
    assert stats["spec_verify_steps"] > 0
    assert stats["spec_accept_rate"] == 1.0
    assert stats["tokens_per_decode_step"] > 1.0


def test_phased_adapter_row(env, oracles, make_engine):
    """An adapter row and a base row share the phased ticks: each gets its
    own model's tokens (the JAX bound model's for the adapter)."""
    _setup(env, "contiguous", superstep="8", chunk="4")
    cfg = jlora.validate_config({"rank": 4})
    params = jlora.init_params(oracles["jm"].arch, cfg, seed=3,
                               init="random")
    lora.save_adapter("a1", "phased", cfg, params, {"code": "Created"},
                      sync_flush=True)
    adapters.REGISTRY.reset()
    entry = adapters.REGISTRY.acquire("a1", "phased")
    try:
        prompt, n = JOBS[0]
        want = jlora.bind_model(oracles["jm"], params, cfg).generate_tokens(
            [prompt], BLOCK, n, temperature=0.0)
        engine = make_engine("torch", "phased", BLOCK, 0.0, None,
                             capacity=3)
        collectors = []
        with engine._cond:
            for adapter in (entry, None):
                c = _Collector(prompt)
                engine._pending.push(DS.Request(prompt, n, None, c.on_event,
                                                adapter=adapter))
                collectors.append(c)
            engine._cond.notify_all()
        got = [c.result() for c in collectors]
        assert got == [want, oracles["tokens"][False][0]]
        assert engine.stats()["lora_adapter_tokens"] == {"a1": n}
    finally:
        adapters.REGISTRY.release(entry)
        adapters.REGISTRY.reset()


@pytest.mark.parametrize("cache", list(CACHES))
def test_phased_sampling_is_deterministic(env, make_engine, cache):
    """Temperature 0.8: the same streams on two fresh engines, and the
    same as the unified engine's (the same positional keys)."""
    _setup(env, cache, superstep="8", chunk="4")
    runs = []
    for _ in range(2):
        engine = make_engine("torch", "phased", BLOCK, 0.8, 20, capacity=3)
        runs.append(_overlapping("torch", engine, JOBS))
    assert runs[0] == runs[1]
    assert all(len(s) == len(p) + n for s, (p, n) in zip(runs[0], JOBS))
    if cache == "paged":
        env.setenv("PENROZ_RAGGED_ATTENTION", "1")
        engine = make_engine("torch", "phased", BLOCK, 0.8, 20, capacity=3)
        assert engine._unified()
        assert _overlapping("torch", engine, JOBS) == runs[0]
