"""Pipeline-parallel serving in the port (``PENROZ_SERVE_PIPE_STAGES``)
against the JAX package (mirrors tests/test_pipeline_serving.py): the
stage partition of the presets, greedy tokens of S in {1, 2, 3} across
prefix cache, int8 pages, superstep and speculation equal to the unpiped
port engine's and the JAX piped engine's, positional sampling unchanged
by the pipeline, the ledger's ``stage_pools`` against JAX's, mid-flight
admission, the drain, the hand-off fault, the stage crash, the warning
off the paged pool, the adapter exclusion, and the ``pipe_*`` stats equal
to JAX's for the same workload.  A stage shares the model's parameter
tensors and its KV view aliases the pools.  Every wait carries its own
timeout."""

import logging
import queue
import time

import pytest
import torch

from penroz_tpu.models import lora as jlora
from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.parallel import pipeline as jpipeline
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.models import lora, presets
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.parallel import pipeline
from penroz_tpu_torch.serve import adapters, qos, spec_decode
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 120.0
REP_PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]
PB = [5, 6, 5, 6]
_KNOBS = ("PAGED_KV_CACHE", "PENROZ_KV_PAGE_SIZE", "PENROZ_RAGGED_ATTENTION",
          "TURBO_QUANT_KV_CACHE", "PENROZ_SCHED_SUPERSTEP",
          "PENROZ_PREFILL_CHUNK", "PENROZ_SPEC_DECODE", "PENROZ_SPEC_NGRAM",
          "PENROZ_PREFIX_CACHE", "PENROZ_PREFIX_CACHE_PAGES",
          "PENROZ_SERVE_PIPE_STAGES", "PENROZ_SERVE_PIPE_BLOCKS",
          lora.MAX_LIVE_ENV, faults.ENV)


def _layers():
    """Three repeated blocks (so three stages each own one)."""
    return jpresets.gpt2_custom(d=32, heads=4, depth=3, vocab=64,
                                block=BLOCK)


@pytest.fixture(scope="module")
def jm():
    return JModel("pipegpt", JMapper(_layers(), SGD))


@pytest.fixture
def pipe_env(workdir, monkeypatch, jm):
    """Paged pool (pages of 4) with the ragged unified ticks, the strict
    ledger, the model's checkpoint shared by both packages."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name in _KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    jm.serialize(sync_flush=True)
    for mod in (faults, jfaults, qos, jqos):
        mod.reset()
    yield monkeypatch
    DS.reset()
    JDS.reset()
    for mod in (faults, jfaults):
        mod.reset()


@pytest.fixture
def make_engine():
    engines = []

    def build(*args, pkg="torch", **kwargs):
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
        self.q = queue.Queue()
        self.tokens = list(prompt)
        self.received = 0

    def on_event(self, kind, value):
        self.q.put((kind, value))

    def result(self, timeout=WAIT_S):
        deadline = time.monotonic() + timeout
        while True:
            kind, value = self.q.get(
                timeout=max(deadline - time.monotonic(), 0.1))
            if kind == "token":
                self.tokens.append(value)
                self.received += 1
            elif kind == "done":
                return self.tokens
            else:
                raise value

    def wait_tokens(self, n):
        deadline = time.monotonic() + WAIT_S
        while self.received < n:
            assert time.monotonic() < deadline, "request never decoded"
            try:
                kind, value = self.q.get(timeout=1.0)
            except queue.Empty:
                continue
            assert kind == "token", kind
            self.tokens.append(value)
            self.received += 1


def _submit(engine, prompt, max_new, pkg="torch", **fields):
    collector = _Collector(prompt)
    engine.submit((DS if pkg == "torch" else JDS).Request(
        prompt, max_new, None, collector.on_event, **fields))
    return collector


def _oracle(bases):
    def propose(history, k, n):
        for base in bases:
            if len(history) < len(base) and history == base[:len(history)]:
                return [int(t) for t in base[len(history):len(history) + k]]
        return []
    return propose


@pytest.mark.parametrize("stages", [1, 2, 3, 4])
@pytest.mark.parametrize("layers", [
    presets.gpt2(), _layers(), presets.gpt2_custom(d=32, heads=4, depth=7,
                                                   vocab=64, block=16)],
    ids=["gpt2", "depth3", "depth7"])
def test_serve_stage_bounds_match_jax(layers, stages):
    assert pipeline.pipeline_block_range(layers) == \
        jpipeline.pipeline_block_range(layers)
    try:
        want = jpipeline.serve_stage_bounds(layers, stages)
    except ValueError as exc:
        with pytest.raises(ValueError, match="repeated block"):
            pipeline.serve_stage_bounds(layers, stages)
        assert "repeated block" in str(exc)
        return
    assert pipeline.serve_stage_bounds(layers, stages) == want


def test_stages_share_parameters_and_pools(pipe_env):
    """A stage runs the model's own modules (the same parameter storage,
    nothing copied) and its KV view holds the pools' own tensors."""
    model = NeuralNetworkModel.deserialize("pipegpt", device="cpu")
    pipe = model.serve_pipeline(3)
    assert pipe.kv_bounds == [(0, 1), (1, 2), (2, 3)]
    ptrs = {p.data_ptr() for p in model.arch.parameters()}
    stage_params = [p for s in range(3) for p in pipe.stage_parameters(s)]
    assert {p.data_ptr() for p in stage_params} == ptrs
    assert len(stage_params) == len(list(model.arch.parameters()))
    kv = KV.create_kv_state(model.arch.kv_specs, 2, BLOCK, device="cpu")
    for s, (lo, hi) in enumerate(pipe.kv_bounds):
        view = KV.stage_kv_view(kv, lo, hi)
        assert all(a is b for a, b in zip(view.k, kv.k[lo:hi]))
    with pytest.raises(ValueError, match="repeated block"):
        model.serve_pipeline(4)


MATRIX = ([(2, prefix, int8, "8", spec) for prefix in (0, 1)
           for int8 in (0, 1) for spec in (0, 1)]
          + [(2, 0, 0, "1", 1), (2, 1, 1, "1", 0), (3, 0, 0, "8", 0),
             (3, 1, 1, "8", 1), (1, 0, 0, "8", 0), (1, 1, 1, "1", 1)])


@pytest.mark.parametrize("stages,prefix,int8,superstep,spec", MATRIX)
def test_pipe_greedy_parity_matrix(pipe_env, jm, make_engine, stages,
                                   prefix, int8, superstep, spec):
    """Greedy streams under PENROZ_SERVE_PIPE_STAGES equal the unpiped
    tokens (JAX's single-sequence ones) across prefix cache x int8 pages
    x superstep x speculation (oracle drafts: the verify spans ride the
    pipeline)."""
    if prefix:
        pipe_env.setenv("PENROZ_PREFIX_CACHE", "1")
        pipe_env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    pipe_env.setenv("TURBO_QUANT_KV_CACHE", str(int8))
    pipe_env.setenv("PENROZ_SCHED_SUPERSTEP", superstep)
    base_a = jm.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    base_b = jm.generate_tokens([PB], BLOCK, 5, temperature=0.0)
    if spec:
        pipe_env.setenv("PENROZ_SPEC_DECODE", "1")
        pipe_env.setattr(spec_decode, "propose", _oracle([base_a, base_b]))
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", str(stages))
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    ca, cb = _submit(engine, REP_PROMPT, 6), _submit(engine, PB, 5)
    assert ca.result() == base_a
    assert cb.result() == base_b
    stats = engine.stats()
    assert stats["pipe_stages"] == stages
    if stages > 1:
        assert stats["pipe_ticks"] > 0
        assert stats["pipe_microblocks"] >= stages
        assert set(stats["pipe_stage_busy"]) == {str(s)
                                                 for s in range(stages)}
        assert stats["pipe_handoffs"] > 0
        assert stats["pipe_handoff_host_fallbacks"] == 0
        assert 0.0 <= stats["pipe_bubble_fraction"] <= 1.0
    else:
        assert stats["pipe_ticks"] == 0
        assert stats["pipe_bubble_fraction"] is None
    if spec:
        assert stats["spec_verify_steps"] > 0
        assert stats["spec_accept_rate"] == 1.0


@pytest.mark.parametrize("stages", [2, 3])
def test_pipe_stats_match_jax(pipe_env, make_engine, stages):
    """The same workload through the JAX piped engine and the port's: the
    same tokens and the same pipeline counters."""
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", str(stages))
    keys = ("pipe_stages", "pipe_microblocks", "pipe_ticks",
            "pipe_bubble_fraction", "pipe_stage_busy", "pipe_handoffs",
            "pipe_handoff_host_fallbacks", "completed", "decode_tokens")
    got = {}
    for pkg in ("jax", "torch"):
        engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2,
                             pkg=pkg)
        collectors = []
        with engine._cond:
            for prompt, n in ((REP_PROMPT, 6), (PB, 5)):
                c = _Collector(prompt)
                engine._pending.push((DS if pkg == "torch" else JDS).Request(
                    prompt, n, None, c.on_event))
                collectors.append(c)
            engine._cond.notify_all()
        tokens = [c.result() for c in collectors]
        deadline = time.monotonic() + WAIT_S
        while engine._dispatch_t0 is not None or engine.active_rows:
            assert time.monotonic() < deadline, "the engine never settled"
            time.sleep(0.005)
        stats = engine.stats()
        got[pkg] = (tokens, {k: stats[k] for k in keys},
                    [{k: p[k] for k in ("stage", "kv_layers", "pool_pages",
                                        "kv_pool_bytes")}
                     for p in stats["memory"]["stage_pools"]])
    assert got["torch"] == got["jax"]


def test_pipe_sampling_equals_unpiped(pipe_env, make_engine):
    """Temperature > 0: the positional draws make the piped stream (with
    oracle drafts verified in it) equal the unpiped spec-off one."""
    probe = make_engine("pipegpt", BLOCK, 0.8, 4, capacity=2)
    base = _submit(probe, REP_PROMPT, 6).result()
    probe.shutdown()
    pipe_env.setenv("PENROZ_SPEC_DECODE", "1")
    pipe_env.setattr(spec_decode, "propose", _oracle([base]))
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    engine = make_engine("pipegpt", BLOCK, 0.8, 4, capacity=2)
    assert _submit(engine, REP_PROMPT, 6).result() == base
    stats = engine.stats()
    assert stats["pipe_ticks"] > 0
    assert stats["spec_accept_rate"] == 1.0


def test_pipe_unpiped_engine_reports_empty_stage_pools(pipe_env,
                                                       make_engine):
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    _submit(engine, [1, 2, 3], 3).result()
    assert engine.stats()["memory"]["stage_pools"] == []


def test_pipe_mid_flight_admission(pipe_env, jm, make_engine):
    """A row admitted while another is mid-flight through the stages joins
    a later micro-block; both streams stay standalone-identical."""
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    pipe_env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    base_a = jm.generate_tokens([REP_PROMPT], BLOCK, 8, temperature=0.0)
    base_b = jm.generate_tokens([PB], BLOCK, 5, temperature=0.0)
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    ca = _submit(engine, REP_PROMPT, 8)
    ca.wait_tokens(2)
    cb = _submit(engine, PB, 5)
    assert cb.result() == base_b
    assert ca.result() == base_a
    assert engine.stats()["completed"] == 2


def test_pipe_drain_finishes_inflight_blocks(pipe_env, jm, make_engine):
    """shutdown(drain_s=...) lets the in-flight micro-blocks finish: every
    token arrives, greedy-identical."""
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    base = jm.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    pipe_env.setenv(faults.ENV, "decode.step:sleep@40")
    pipe_env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    c = _submit(engine, REP_PROMPT, 6)
    c.wait_tokens(1)
    assert engine.shutdown(timeout=30.0, drain_s=30.0) is True
    assert c.result(timeout=5) == base
    assert engine.stats()["pipe_ticks"] > 0


def test_pipe_handoff_fault_host_restage_parity(pipe_env, jm, make_engine):
    """A pipe.handoff fault is contained: the activations go through the
    host, the fallback counter ticks, nothing crashes, the tokens hold."""
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    base = jm.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    pipe_env.setenv(faults.ENV, "pipe.handoff:raise@2")
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    assert _submit(engine, REP_PROMPT, 6).result() == base
    stats = engine.stats()
    assert stats["pipe_handoff_host_fallbacks"] == 1
    assert stats["pipe_handoffs"] > 1
    assert stats["crashes_total"] == 0


def test_pipe_stage_crash_recovers_whole_group(pipe_env, jm, make_engine):
    """A pipe.stage_crash fails the tick: the waiting request fails typed,
    the recovery rebuilds the whole group's cache (strict audit clean),
    and the next request is greedy-identical, still piped."""
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    base = jm.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    pipe_env.setenv(faults.ENV, "pipe.stage_crash:raise@1")
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    with pytest.raises(faults.InjectedFault):
        _submit(engine, REP_PROMPT, 6).result()
    pipe_env.delenv(faults.ENV)
    faults.reset()
    assert _submit(engine, REP_PROMPT, 6).result() == base
    stats = engine.stats()
    assert stats["crashes_total"] == stats["engine_resets"] == 1
    assert stats["breaker_open"] is False
    assert stats["pipe_stages"] == 2 and stats["pipe_ticks"] > 0
    assert [p["stage"] for p in stats["memory"]["stage_pools"]] == [0, 1]
    assert engine.active_rows == 0


@pytest.mark.parametrize("env", [{"PAGED_KV_CACHE": "0"},
                                 {"PENROZ_RAGGED_ATTENTION": "0"}])
def test_pipe_stages_without_paged_ragged_warn_and_disable(
        pipe_env, jm, make_engine, caplog, env):
    """PENROZ_SERVE_PIPE_STAGES without the paged pool and the unified
    ticks is ignored with a warning: the engine serves unpiped."""
    for name, value in env.items():
        pipe_env.setenv(name, value)
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    base = jm.generate_tokens([REP_PROMPT], BLOCK, 4, temperature=0.0)
    with caplog.at_level(logging.WARNING):
        engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    assert any("PENROZ_SERVE_PIPE_STAGES=2 ignored" in r.getMessage()
               for r in caplog.records)
    assert _submit(engine, REP_PROMPT, 4).result() == base
    stats = engine.stats()
    assert stats["pipe_stages"] == 1 and stats["pipe_ticks"] == 0


def test_pipe_suspended_while_adapters_live(pipe_env, jm, make_engine,
                                            caplog):
    """A live adapter suspends the pipeline (one warning): the adapter
    row and the base row get their own tokens through the unpiped
    unified block."""
    cfg = jlora.validate_config({"rank": 4})
    params = jlora.init_params(jm.arch, cfg, seed=5, init="random")
    lora.save_adapter("a1", "pipegpt", cfg, params, {"code": "Created"},
                      sync_flush=True)
    adapters.REGISTRY.reset()
    entry = adapters.REGISTRY.acquire("a1", "pipegpt")
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "2")
    want_a = jlora.bind_model(jm, params, cfg).generate_tokens(
        [REP_PROMPT], BLOCK, 5, temperature=0.0)
    want_b = jm.generate_tokens([PB], BLOCK, 5, temperature=0.0)
    try:
        engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
        with caplog.at_level(logging.WARNING):
            ca = _submit(engine, REP_PROMPT, 5, adapter=entry)
            cb = _submit(engine, PB, 5)
            assert ca.result() == want_a and cb.result() == want_b
        warned = [r for r in caplog.records
                  if "pipeline serving suspended" in r.getMessage()]
        assert len(warned) == 1
        assert engine.stats()["pipe_ticks"] == 0
    finally:
        adapters.REGISTRY.release(entry)
        adapters.REGISTRY.reset()


def test_pipe_kernel_path_is_the_ragged_wrapper(pipe_env, jm, make_engine,
                                                monkeypatch):
    """Every stage's attention layer runs the ragged wrapper against its
    own pool slice: one call a layer a micro-block step."""
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA
    calls = []
    real = RPA.ragged_paged_attention

    def counted(q, flat_k, *args, **kwargs):
        calls.append(flat_k.data_ptr())
        return real(q, flat_k, *args, **kwargs)

    monkeypatch.setattr(RPA, "ragged_paged_attention", counted)
    pipe_env.setenv("PENROZ_SERVE_PIPE_STAGES", "3")
    engine = make_engine("pipegpt", BLOCK, 0.0, None, capacity=2)
    steps = []
    real_stage = NeuralNetworkModel.decode_pipe_stage

    def stage(self, pipe, s, *args, **kwargs):
        steps.append(s)
        return real_stage(self, pipe, s, *args, **kwargs)

    monkeypatch.setattr(NeuralNetworkModel, "decode_pipe_stage", stage)
    _submit(engine, REP_PROMPT, 4).result()
    assert len(calls) == len(steps) > 0
    pools = {a.data_ptr() for a in engine._kv.k}
    assert set(calls) == pools
    torch.testing.assert_close(torch.tensor(sorted(set(steps))),
                               torch.tensor([0, 1, 2]))
