"""The port's speculative decoding (serve/spec_decode.py, verify spans in
the continuous-batching engine's unified block) against the JAX
package's: the prompt-lookup drafter and ``accept_length`` on random
histories, and greedy engine tokens with ``PENROZ_SPEC_DECODE=1`` against
JAX ``generate_tokens`` on the same weights — with and without the prefix
cache, on fp32 and int8 pages, one-shot and chunked prefill; a wrong
drafter, a stop token inside an accepted draft, an admission while a row
verifies; sampled tokens equal to speculation off; and the
``/serving_stats/`` keys against the JAX package's."""

import queue

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import spec_decode as jspec
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import spec_decode
from penroz_tpu_torch.utils import checkpoint as tckpt

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
REP_PROMPT = [1, 2, 3, 1, 2, 3, 1, 2]   # repetitive text: 2 pages of 4


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel("spec", JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def spec_env(monkeypatch):
    """Paged pool, speculation on with the 1-gram matcher (toy streams lock
    into short cycles, so they draft early), prefix cache off."""
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_SPEC_DECODE", "1")
    monkeypatch.setenv("PENROZ_SPEC_NGRAM", "1")
    for name in ("TURBO_QUANT_KV_CACHE", "PENROZ_PREFIX_CACHE",
                 "PENROZ_SPEC_K", "PENROZ_PREFILL_CHUNK",
                 "PENROZ_SCHED_SUPERSTEP"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


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


def _oracle_drafter(bases):
    """Draft the exact continuation of whichever expected sequence the
    history is a prefix of: full acceptance, so verify spans provably run
    and emit several tokens each."""
    def propose(history, k, n):
        for base in bases:
            if len(history) < len(base) and history == base[:len(history)]:
                return [int(t) for t in base[len(history):len(history) + k]]
        return []
    return propose


def _overlapping(engine, prompts, new_tokens, stop=None):
    handles = []
    with engine._cond:
        for prompt, n in zip(prompts, new_tokens):
            req, events = DS._queued_request(prompt, n, stop)
            engine._pending.push(req)
            handles.append((req, events))
        engine._cond.notify_all()
    return [DS.collect(req, events, WAIT_S) for req, events in handles]


# -- the drafter against the JAX package's -----------------------------------

@settings(max_examples=200, deadline=None)
@given(history=st.lists(st.integers(0, 4), max_size=40),
       k=st.integers(0, 9), n=st.integers(1, 4),
       out=st.lists(st.integers(0, 4), max_size=10))
def test_drafter_matches_jax(history, k, n, out):
    draft = spec_decode.propose(history, k, n)
    assert draft == jspec.propose(history, k, n)
    assert len(draft) <= max(k, 0)
    assert len(draft) & (len(draft) - 1) == 0      # 0 or a power of two
    assert spec_decode.accept_length(draft, out) == jspec.accept_length(
        draft, out)
    assert spec_decode.accept_length(out, out) == len(out)


def test_spec_knobs(spec_env):
    assert spec_decode.enabled() and spec_decode.ngram() == 1
    assert spec_decode.draft_k() == 4
    spec_env.setenv("PENROZ_SPEC_K", "x")
    assert spec_decode.draft_k() == 4 == jspec.draft_k()
    spec_env.setenv("PENROZ_SPEC_K", "0")
    assert spec_decode.draft_k() == 1 == jspec.draft_k()
    spec_env.delenv("PENROZ_SPEC_NGRAM")
    assert spec_decode.ngram() == 3 == jspec.ngram()


# -- the engine against the JAX package's generation -------------------------

@pytest.mark.parametrize("chunk", ["16", "2"])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("prefix", [False, True], ids=["noprefix", "prefix"])
def test_spec_parity_matrix(jmodel, spec_env, make_engine, prefix, int8,
                            chunk):
    """Greedy tokens with speculation on equal JAX ``generate_tokens``
    over prefix cache off/on, fp32/int8 pages and one-shot/chunked
    prefill, with the verify path provably engaged (oracle drafts, every
    draft accepted, more than one token a decode step); the second
    request is a prefix hit when the cache is on."""
    if prefix:
        spec_env.setenv("PENROZ_PREFIX_CACHE", "1")
        spec_env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    if int8:
        spec_env.setenv("TURBO_QUANT_KV_CACHE", "1")
    spec_env.setenv("PENROZ_PREFILL_CHUNK", chunk)
    want = jmodel.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    spec_env.setattr(spec_decode, "propose", _oracle_drafter([want]))
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, REP_PROMPT, 6, None, timeout=WAIT_S) == want
    assert DS.run_request(engine, REP_PROMPT, 6, None, timeout=WAIT_S) == want
    stats = engine.stats()
    assert stats["spec_decode"] is True
    assert stats["spec_verify_steps"] > 0
    assert stats["spec_drafted_tokens"] > 0
    assert stats["spec_accept_rate"] == 1.0
    assert stats["tokens_per_decode_step"] > 1.0
    assert any(t["verify_rows"] > 0 for t in stats["tick_timeline"])
    if prefix:
        assert stats["prefix_cache"]["hits"] == 1
        assert engine._prefix_cache.page_audit() == []
    else:
        assert stats["prefix_cache"] is None


def test_spec_real_drafter_parity(jmodel, spec_env, make_engine):
    """The prompt-lookup drafter itself (1-gram), three rows at once: the
    streams equal JAX's whatever the accept rate, and it drafted.  One
    step a block, so every generated token is a chance to draft (a
    decoding row is planned again only at a block boundary)."""
    spec_env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    prompts = [[1, 2, 3, 1, 2], REP_PROMPT, [5, 6, 5, 6, 5]]
    want = [jmodel.generate_tokens([p], BLOCK, n, temperature=0.0)
            for p, n in zip(prompts, (11, 8, 10))]
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=4)
    assert _overlapping(engine, prompts, (11, 8, 10)) == want
    stats = engine.stats()
    assert stats["spec_drafted_tokens"] > 0
    assert 0.0 <= stats["spec_accept_rate"] <= 1.0


def test_spec_wrong_drafter_keeps_parity(jmodel, spec_env, make_engine):
    """An always-wrong drafter costs speed, never tokens: no draft token
    is accepted and each verify span emits the model's one token."""
    want = jmodel.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)

    def wrong(history, k, n):
        nxt = want[len(history)] if len(history) < len(want) else 0
        return [(int(nxt) + 1) % 64] * min(k, 2)

    spec_env.setattr(spec_decode, "propose", wrong)
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, REP_PROMPT, 6, None, timeout=WAIT_S) == want
    stats = engine.stats()
    # a verify span a token but the last, which has no budget to draft
    assert stats["spec_verify_steps"] == 4
    assert stats["spec_drafted_tokens"] > 0
    assert stats["spec_accepted_tokens"] == 0
    assert stats["spec_accept_rate"] == 0.0
    assert stats["tokens_per_decode_step"] == pytest.approx(1.0)


def _stop_inside_first_draft(jmodel, new_tokens):
    """(prompt, greedy sequence, stop token) such that the stop token's
    first generated occurrence lies strictly inside the first draft: the
    oracle's first draft is generated tokens 1-4 (token 0 comes from the
    prefill), so a generated token j in 1-3 not among tokens 0..j-1 stops
    the plain path inside it, with accepted tokens after it."""
    for start in range(1, 40):
        prompt = [start, start + 1, start + 2, start, start + 1]
        seq = jmodel.generate_tokens([prompt], BLOCK, new_tokens,
                                     temperature=0.0)
        gen = seq[len(prompt):]
        for j in (1, 2, 3):
            if gen[j] not in gen[:j]:
                return prompt, seq, gen[j], j
    raise AssertionError("no prompt puts a new token inside the first draft")


def test_spec_stop_token_inside_accepted_draft(jmodel, spec_env,
                                               make_engine):
    """A stop token inside an accepted draft retires the row where the
    plain path stops: the accepted tokens after it are discarded.  The
    stop token is chosen so that its first occurrence is inside the first
    verified draft, not before it (the JAX suite's version of this test
    picks one that the prefill's own token already hits)."""
    prompt, seq, stop, j = _stop_inside_first_draft(jmodel, 8)
    want = jmodel.generate_tokens([prompt], BLOCK, 8, temperature=0.0,
                                  stop_token=stop)
    assert want == seq[:len(prompt) + j + 1]
    spec_env.setattr(spec_decode, "propose", _oracle_drafter([seq]))
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, prompt, 8, stop, timeout=WAIT_S) == want
    stats = engine.stats()
    assert stats["spec_verify_steps"] == 1
    assert stats["spec_accepted_tokens"] == stats["spec_drafted_tokens"] == 4
    assert stats["decode_tokens"] == j       # emission stopped at the stop
    assert engine.active_rows == 0 and not engine._lengths.any()


def test_spec_admission_mid_verify(jmodel, spec_env, make_engine):
    """A row admitted while another advances through verify spans: its
    prefill chunks share the verifying row's blocks, and both keep their
    streams."""
    spec_env.setenv("PENROZ_PREFILL_CHUNK", "2")
    pa, pb = REP_PROMPT, [5, 6, 5, 6, 7, 9]
    want_a = jmodel.generate_tokens([pa], BLOCK, 7, temperature=0.0)
    want_b = jmodel.generate_tokens([pb], BLOCK, 5, temperature=0.0)
    spec_env.setattr(spec_decode, "propose",
                     _oracle_drafter([want_a, want_b]))
    spec_env.setenv("PENROZ_SPEC_K", "1")   # A verifies for several blocks
    # and each of its verify blocks takes 50 ms more, so A is still
    # verifying when B arrives however loaded the host is
    spec_env.setenv("PENROZ_FAULT_INJECT", "decode.verify:sleep@50")
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    req_a, events_a = DS.start_stream(engine, pa, 7, None)
    got_a = list(pa)
    while len(got_a) < len(pa) + 2:          # A provably mid-generation
        kind, value = DS.next_event(req_a, events_a, WAIT_S)
        assert kind == "token"
        got_a.append(value)
    assert DS.run_request(engine, pb, 5, None, timeout=WAIT_S) == want_b
    assert DS.collect(req_a, events_a, WAIT_S)[len(pa):] == \
        want_a[len(got_a):]
    assert got_a == want_a[:len(got_a)]
    stats = engine.stats()
    assert stats["completed"] == 2
    assert any(t["verify_rows"] > 0 and t["prefill_rows"] > 0
               for t in stats["tick_timeline"])


def test_spec_sampled_equals_spec_off(jmodel, spec_env, make_engine):
    """Temperature 0.8, top_k 8: every (row, position) is one positional
    draw, so speculation on (the oracle of the spec-off draws: every draft
    accepted; the real drafter; a wrong drafter: every draft rejected)
    emits the stream speculation off emits."""
    prompts, counts = [REP_PROMPT, [4, 9, 4, 9]], (8, 10)
    spec_env.setenv("PENROZ_SPEC_DECODE", "0")
    off = _overlapping(make_engine("spec", BLOCK, 0.8, 8, capacity=2),
                       prompts, counts)
    greedy = [jmodel.generate_tokens([p], BLOCK, n, temperature=0.0)
              for p, n in zip(prompts, counts)]
    assert off != greedy            # it did sample
    spec_env.setenv("PENROZ_SPEC_DECODE", "1")
    real_propose = spec_decode.propose
    for drafter, rate in ((_oracle_drafter(off), 1.0), (real_propose, None),
                          (lambda h, k, n: [63] * min(k, 2), 0.0)):
        spec_env.setattr(spec_decode, "propose", drafter)
        engine = make_engine("spec", BLOCK, 0.8, 8, capacity=2)
        assert _overlapping(engine, prompts, counts) == off
        stats = engine.stats()
        assert stats["spec_decode"] is True
        if rate is not None:
            assert stats["spec_verify_steps"] > 0
            assert stats["spec_accept_rate"] == rate


def test_prefix_and_spec_together(jmodel, spec_env, make_engine):
    """Both knobs at once with the real drafter (one step a block): a
    miss and a hit on the same prompt equal JAX's stream."""
    spec_env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    spec_env.setenv("PENROZ_PREFIX_CACHE", "1")
    spec_env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    spec_env.setenv("PENROZ_PREFILL_CHUNK", "4")
    want = jmodel.generate_tokens([REP_PROMPT], BLOCK, 7, temperature=0.0)
    engine = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    for _ in range(2):
        assert DS.run_request(engine, REP_PROMPT, 7, None,
                              timeout=WAIT_S) == want
    stats = engine.stats()
    assert stats["prefix_cache"]["hits"] == 1
    assert stats["spec_drafted_tokens"] > 0


# -- /serving_stats/ against the JAX package's -------------------------------

def test_serving_stats_keys_match_jax(jmodel, spec_env, make_engine):
    """The per-engine and aggregate keys this slice adds carry the JAX
    package's names and defaults; for the same requests and drafter the
    prefix cache's stats and the speculation counters are the JAX
    engine's."""
    spec_env.setenv("PENROZ_PREFIX_CACHE", "1")
    spec_env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    spec_env.setenv("PENROZ_PREFILL_CHUNK", "4")
    want = jmodel.generate_tokens([REP_PROMPT], BLOCK, 6, temperature=0.0)
    oracle = _oracle_drafter([want])
    spec_env.setattr(spec_decode, "propose", oracle)
    spec_env.setattr(jspec, "propose", oracle)
    ours = make_engine("spec", BLOCK, 0.0, None, capacity=2)
    ref = JDS.DecodeEngine("spec", BLOCK, 0.0, None, capacity=2)
    try:
        for _ in range(2):
            assert DS.run_request(ours, REP_PROMPT, 6, None,
                                  timeout=WAIT_S) == want
            events = queue.Queue()
            ref.submit(JDS.Request(REP_PROMPT, 6, None,
                                   lambda kind, value: events.put(kind)))
            kinds = []
            while not kinds or kinds[-1] == "token":
                kinds.append(events.get(timeout=WAIT_S))
            assert kinds == ["token"] * 6 + ["done"]
        a, b = ours.stats(), ref.stats()
    finally:
        ref.shutdown(timeout=WAIT_S)
    new_keys = ("prefix_cache", "spec_decode", "spec_verify_steps",
                "spec_drafted_tokens", "spec_accepted_tokens",
                "spec_accept_rate", "tokens_per_decode_step")
    for key in new_keys:
        assert key in b
    assert set(a) <= set(b) | {"tick_timeline"}
    assert a["prefix_cache"] == b["prefix_cache"]
    for key in new_keys[1:-1]:
        assert a[key] == b[key], key
    agg, ref_agg = DS.serving_stats(), JDS.serving_stats()
    for key in ("prefix_cache_hit_rate", "prefix_cache_evicted_pages",
                "spec_decode_enabled", "spec_drafted_tokens",
                "spec_accepted_tokens", "spec_accept_rate",
                "tokens_per_decode_step"):
        assert key in agg and key in ref_agg, key
    spec_env.setenv("PENROZ_SPEC_DECODE", "0")
    spec_env.setenv("PENROZ_PREFIX_CACHE", "0")
    off = make_engine("spec", BLOCK, 0.0, None, capacity=2).stats()
    assert off["prefix_cache"] is None and off["spec_decode"] is False
    assert off["spec_accept_rate"] is None and off["spec_verify_steps"] == 0
