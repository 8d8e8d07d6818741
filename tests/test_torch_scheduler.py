"""The port's continuous-batching engine (unified ragged ticks over the
paged pool) against the JAX package's single-sequence generation, on the
same weights: greedy tokens must be identical for every row, whatever the
superstep, the prefill chunk and the pool's dtype.  Every wait on a result
carries its own timeout, so a hung worker fails one test."""

import time

import numpy as np
import pytest
import torch

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models.model import CompiledArch
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt

BLOCK = 32
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
PROMPT_A = [1, 2, 3]
PROMPT_B = [7, 5, 9, 11, 4, 4, 2, 8, 30, 17]


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel("sched", JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def paged_env(monkeypatch):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.delenv("TURBO_QUANT_KV_CACHE", raising=False)


@pytest.fixture
def make_engine():
    engines = []

    def build(*args, **kwargs):
        engine = DS.DecodeEngine(*args, device="cpu", **kwargs)
        engines.append(engine)
        return engine

    yield build
    for engine in engines:
        assert engine.shutdown(timeout=WAIT_S)


def _overlapping(engine, prompts, new_tokens):
    """Submit every request while the worker is held, so all are admitted
    at one boundary and their prefill and decode overlap; returns each
    request's full sequence."""
    handles = []
    with engine._cond:
        for prompt, n in zip(prompts, new_tokens):
            req, events = DS._queued_request(prompt, n, None)
            engine._pending.push(req)
            handles.append((req, events))
        engine._cond.notify_all()
    return [DS.collect(req, events, WAIT_S) for req, events in handles]


def _mixed_ticks(engine):
    return [e for e in engine.stats()["tick_timeline"]
            if e["unified"] and e["prefill_rows"] > 0
            and e["decode_rows"] > 0]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("chunk", ["2", "16"])
@pytest.mark.parametrize("superstep", ["1", "8"])
def test_engine_greedy_matches_jax_generate(jmodel, paged_env, make_engine,
                                            monkeypatch, superstep, chunk,
                                            int8):
    if int8:
        monkeypatch.setenv("TURBO_QUANT_KV_CACHE", "1")
    monkeypatch.setenv(DS.SUPERSTEP_ENV, superstep)
    monkeypatch.setenv(DS.PREFILL_CHUNK_ENV, chunk)
    want_a = jmodel.generate_tokens([PROMPT_A], BLOCK, 12, temperature=0.0)
    want_b = jmodel.generate_tokens([PROMPT_B], BLOCK, 8, temperature=0.0)
    engine = make_engine("sched", BLOCK, 0.0, None, capacity=2)
    assert engine._kv.quantized == int8
    got_a, got_b = _overlapping(engine, [PROMPT_A, PROMPT_B], [12, 8])
    assert got_a == want_a
    assert got_b == want_b
    stats = engine.stats()
    assert stats["tick_timeline"] and all(
        e["unified"] for e in stats["tick_timeline"])
    assert stats["completed"] == stats["admissions"] == 2
    assert stats["decode_tokens"] == 12 + 8 - 2   # first tokens: prefill
    if chunk == "2":
        # row B is still prefilling while row A decodes
        assert _mixed_ticks(engine)
    assert max(e["superstep"] for e in stats["tick_timeline"]) <= int(
        superstep)
    # a later request reuses a retired row's pages
    assert DS.run_request(engine, PROMPT_B, 8, None, timeout=WAIT_S) == want_b


def test_mixed_tick_and_stop_token(jmodel, paged_env, make_engine,
                                   monkeypatch):
    """A request admitted while another decodes shares its ticks (prefill
    and decode rows in one unified block); a stop token retires its row
    mid-block with the stop token included, as generate_tokens does."""
    monkeypatch.setenv(DS.SUPERSTEP_ENV, "1")
    want_a = jmodel.generate_tokens([PROMPT_A], BLOCK, 20, temperature=0.0)
    want_b = jmodel.generate_tokens([PROMPT_B], BLOCK, 6, temperature=0.0)
    engine = make_engine("sched", BLOCK, 0.0, None, capacity=2)
    req_a, events_a = DS.start_stream(engine, PROMPT_A, 20, None)
    first = DS.next_event(req_a, events_a, WAIT_S)
    assert first == ("token", want_a[3])
    assert DS.run_request(engine, PROMPT_B, 6, None, timeout=WAIT_S) == want_b
    rest = []
    while True:
        kind, value = DS.next_event(req_a, events_a, WAIT_S)
        if kind == "done":
            break
        rest.append(value)
    assert [first[1]] + rest == want_a[3:]
    assert _mixed_ticks(engine)
    stop = want_b[len(PROMPT_B) + 2]
    got = DS.run_request(engine, PROMPT_B, 6, stop, timeout=WAIT_S)
    assert got == want_b[:want_b.index(stop, len(PROMPT_B)) + 1]


def _sampled(make_engine, superstep, monkeypatch):
    monkeypatch.setenv(DS.SUPERSTEP_ENV, superstep)
    engine = make_engine("sched", BLOCK, 0.8, None, capacity=2)
    out = _overlapping(engine, [PROMPT_A, PROMPT_B], [12, 8])
    assert engine.shutdown(timeout=WAIT_S)
    return out


def test_sampled_tokens_deterministic_and_superstep_invariant(
        jmodel, paged_env, make_engine, monkeypatch):
    """Temperature 0.8: positional keys make each (row, position) draw the
    same token in two runs and under superstep 1 and 8."""
    runs = [_sampled(make_engine, s, monkeypatch) for s in ("8", "8", "1")]
    assert runs[0] == runs[1] == runs[2]
    greedy_a = jmodel.generate_tokens([PROMPT_A], BLOCK, 12, temperature=0.0)
    assert runs[0][0] != greedy_a  # it did sample


def test_sample_packed_distribution():
    """Gumbel-max over the positional hash draws from softmax(logits /
    temp) (and from the renormalised top-k): the empirical frequencies of
    20000 (row, position) keys lie within 0.02 of the probabilities (five
    standard deviations); the same keys draw the same tokens."""
    logits = torch.tensor([2.0, 1.0, 0.5, 0.0, -1.0, 0.3, 1.5, -0.2])
    n = 20000
    rows = torch.arange(n) % 7
    pos = torch.arange(n) // 7
    batch = logits.expand(n, -1)
    for temp, top_k in ((1.0, None), (0.7, None), (1.0, 3)):
        toks = CompiledArch._sample_packed(batch, 0, rows, pos, temp, top_k)
        again = CompiledArch._sample_packed(batch, 0, rows, pos, temp, top_k)
        assert torch.equal(toks, again)
        probs = torch.softmax(logits / temp, -1)
        if top_k is not None:
            keep = torch.topk(logits, top_k).indices
            probs = torch.zeros_like(probs).scatter(
                0, keep, torch.softmax(logits[keep] / temp, -1))
        freq = torch.bincount(toks, minlength=8).float() / n
        assert float((freq - probs).abs().max()) < 0.02, (temp, top_k)
    other = CompiledArch._sample_packed(batch, 1, rows, pos, 1.0, None)
    assert not torch.equal(other, toks)


def test_eligibility_and_unported_options(monkeypatch):
    assert DS.eligible([1, 2], 8, 6) and not DS.eligible([1, 2], 8, 7)
    assert not DS.eligible([], 8, 1) and not DS.eligible([1], 8, 0)
    monkeypatch.setenv(DS.ENABLE_ENV, "1")
    # the contiguous cache (the phased ticks) is served
    monkeypatch.delenv("PAGED_KV_CACHE", raising=False)
    DS.unported_serving_options()
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    DS.unported_serving_options()
    for name, value in (("PENROZ_SERVE_MESH", "1"),):
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=name):
            DS.unported_serving_options()
        monkeypatch.delenv(name)
    # replicas, disaggregated prefill, resumable streams, the journal, the
    # session tiers (and its tenant quota), the phased ticks and pipeline
    # serving are ported
    for name, value in (("PENROZ_RAGGED_ATTENTION", "0"),
                        ("PENROZ_SERVE_PIPE_STAGES", "2"),
                        ("PENROZ_SERVE_PIPE_BLOCKS", "4"),
                        ("PENROZ_SCHED_REPLICAS", "2"),
                        ("PENROZ_DISAGG_PREFILL", "1"),
                        ("PENROZ_STREAM_DETACH_MS", "500"),
                        ("PENROZ_STREAM_REPLAY", "64"),
                        ("PENROZ_JOURNAL_PATH", "journal.log"),
                        ("PENROZ_TIER_HOST_MB", "64"),
                        ("PENROZ_TIER_DISK_MB", "0.5"),
                        ("PENROZ_QOS_TENANT_TIER_MB", "64")):
        monkeypatch.setenv(name, value)
        DS.unported_serving_options()
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", "1")
    DS.unported_serving_options()
    # the prefix cache and speculation are ported
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_SPEC_DECODE", "1")
    DS.unported_serving_options()
    # the overload knobs at the values that leave their feature off
    for name, value in (("PENROZ_REQ_TIMEOUT_MS", "0"),
                        ("PENROZ_SCHED_MAX_QUEUE", "0"),
                        ("PENROZ_SCHED_FALLBACK", "0"),
                        ("PENROZ_SCHED_ADMIT_MS", "0"),
                        ("PENROZ_TICK_WATCHDOG_MS", "0")):
        monkeypatch.setenv(name, value)
    DS.unported_serving_options()


def test_crash_fails_requests_and_resets(jmodel, paged_env, make_engine,
                                         monkeypatch):
    """A failed tick fails its requests with the error and reallocates the
    pool; the next request is greedy-identical."""
    want = jmodel.generate_tokens([PROMPT_A], BLOCK, 5, temperature=0.0)
    engine = make_engine("sched", BLOCK, 0.0, None, capacity=2)
    real = engine._model.decode_mixed_step
    calls = {"n": 0}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("injected")
        return real(*args, **kwargs)

    monkeypatch.setattr(engine._model, "decode_mixed_step", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        DS.run_request(engine, PROMPT_A, 5, None, timeout=WAIT_S)
    assert DS.run_request(engine, PROMPT_A, 5, None, timeout=WAIT_S) == want
    stats = engine.stats()
    assert stats["crashes_total"] == stats["engine_resets"] == 1
    assert np.all(engine._lengths == 0)


def test_tick_timeline_length_knob(jmodel, paged_env, make_engine,
                                   monkeypatch):
    """``PENROZ_TICK_TIMELINE=16`` bounds an engine's tick timeline to 16
    entries, as it bounds the JAX engine's, for the same request."""
    from penroz_tpu.serve import decode_scheduler as JDS
    monkeypatch.setenv("PENROZ_TICK_TIMELINE", "16")
    monkeypatch.setenv("PENROZ_SCHED_SUPERSTEP", "1")   # a tick a token
    want = jmodel.generate_tokens([PROMPT_A], BLOCK, 24, temperature=0.0)
    ours = make_engine("sched", BLOCK, 0.0, None, capacity=2)
    ref = JDS.DecodeEngine("sched", BLOCK, 0.0, None, capacity=2)
    try:
        assert DS.run_request(ours, PROMPT_A, 24, None,
                              timeout=WAIT_S) == want
        done = []
        ref.submit(JDS.Request(PROMPT_A, 24, None,
                               lambda kind, value: done.append(kind)))
        deadline = time.monotonic() + WAIT_S
        while "done" not in done and time.monotonic() < deadline:
            time.sleep(0.01)
        assert "done" in done
        assert ours.stats()["dispatches_total"] > 16
        assert (len(ours.stats()["tick_timeline"])
                == len(ref.stats()["tick_timeline"]) == 16)
    finally:
        ref.shutdown(timeout=WAIT_S)
