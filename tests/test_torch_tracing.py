"""The port's request tracing (utils/tracing.py and the engine's trace
sites) against the JAX package's, on the CPU.

- ``new_request_id`` accepts and rejects the same client ids (1-64
  characters, each alphanumeric or one of ``.``, ``_``, ``-``, after
  stripping), hypothesis over random strings.
- The same traffic through both engines (a 2-layer d-64 GPT, pages of 4,
  the prefix cache on) gives each request the same span-name tree, the
  same event names and the same ``retire_reason``; times are not
  compared.  The Chrome rendering holds one complete event per span.
- At ``PENROZ_TRACE_SAMPLE=0`` no trace is made and the tokens equal the
  traced run's."""

import queue

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import tracing as jtracing
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import tracing

BLOCK = 32
WAIT_S = 120.0
PREFIX = [1, 2, 3, 4, 5, 6, 7, 8, 9]


@settings(max_examples=150, deadline=None)
@given(st.one_of(st.none(), st.text(max_size=70),
                 st.text(alphabet="ab.-_Z9 \t/é", max_size=70)))
def test_new_request_id_matches_jax(supplied):
    ours, ref = tracing.new_request_id(supplied), jtracing.new_request_id(
        supplied)
    echoed = ours == (supplied or "").strip()
    assert echoed == (ref == (supplied or "").strip())
    if not echoed:      # a fresh id: 32 hex digits in both
        assert len(ours) == len(ref) == 32 and int(ours, 16) >= 0


@pytest.mark.parametrize("supplied,echo", [
    ("abc-DEF_1.2", True), ("  padded  ", True), ("x" * 64, True),
    ("x" * 65, False), ("", False), ("has space", False), ("a/b", False),
    ("a:b", False),
    # str.isalnum, the JAX package's test, takes any Unicode letter
    ("ünï", True)])
def test_request_id_rule(supplied, echo):
    assert (tracing.new_request_id(supplied) == supplied.strip()) == echo
    assert (jtracing.new_request_id(supplied) == supplied.strip()) == echo


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1"),
                        ("PENROZ_PREFIX_CACHE_PAGES", "8")):
        monkeypatch.setenv(name, value)
    for name in ("TURBO_QUANT_KV_CACHE", "PENROZ_SPEC_DECODE",
                 "PENROZ_FAULT_INJECT", "PENROZ_TRACE_SAMPLE"):
        monkeypatch.delenv(name, raising=False)
    tracing.reset()
    jtracing.reset()
    model = JModel("traced", JMapper(jpresets.gpt2_custom(
        d=64, heads=4, depth=2, vocab=64, block=BLOCK), {"sgd": {"lr": 0.1}}))
    model.serialize(sync_flush=True)
    yield model
    tracing.reset()
    jtracing.reset()


def _run(side, engine, prompt, max_new, stop, rid):
    """One request to completion; returns (tokens, trace or None)."""
    mod, ds = (tracing, DS) if side == "torch" else (jtracing, JDS)
    trace = mod.maybe_trace(rid, route="/generate/")
    events = queue.Queue()
    req = ds.Request(prompt, max_new, stop,
                     lambda kind, value: events.put((kind, value)),
                     request_id=rid, trace=trace)
    engine.submit(req)
    tokens = list(prompt)
    while True:
        kind, value = events.get(timeout=WAIT_S)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens, trace
        else:
            raise value


def _names(span):
    return [span["name"], [_names(c) for c in span.get("children", [])]]


def _traffic(side, stop):
    """A cold prompt, a prefix hit, a stop token, a one-token request."""
    engine = (DS.DecodeEngine("traced", BLOCK, 0.0, None, capacity=2,
                              device="cpu") if side == "torch"
              else JDS.DecodeEngine("traced", BLOCK, 0.0, None, capacity=2))
    try:
        return [_run(side, engine, prompt, n, s, f"{side}-{i}")
                for i, (prompt, n, s) in enumerate((
                    (PREFIX, 6, None), (PREFIX + [11, 12], 12, None),
                    (PREFIX, 6, stop), ([5, 4], 1, None)))]
    finally:
        engine.shutdown(timeout=WAIT_S)


@pytest.mark.parametrize("superstep", ["1", "8"])
def test_span_trees_match_jax(jmodel, monkeypatch, superstep):
    monkeypatch.setenv("PENROZ_SCHED_SUPERSTEP", superstep)
    base = jmodel.generate_tokens([PREFIX], BLOCK, 6, temperature=0)
    stop = base[len(PREFIX) + 2]
    ours, ref = _traffic("torch", stop), _traffic("jax", stop)
    assert [t for t, _ in ours] == [t for t, _ in ref]
    for (_, a), (_, b) in zip(ours, ref):
        da, db = a.to_dict(), b.to_dict()
        assert _names(da["root"]) == _names(db["root"])
        assert da["meta"] == db["meta"] and da["finished"] and db["finished"]
        assert a.summary().keys() == b.summary().keys()
        chrome = a.to_chrome()["traceEvents"]
        assert len(chrome) == a.summary()["spans"]
        assert all(e["ph"] == "X" and e["pid"] == a.request_id
                   for e in chrome)
    reasons = [t.meta["retire_reason"] for _, t in ours]
    assert reasons == ["max_new_tokens", "max_new_tokens", "stop_token",
                       "max_new_tokens"]
    assert ours[1][1].to_dict()["root"]["children"][1]["meta"] == {
        "matched_tokens": 8, "pages": 2}
    assert [t.request_id for t in tracing.completed(10)] == [
        f"torch-{i}" for i in (3, 2, 1, 0)]
    assert tracing.get("torch-1") is ours[1][1] and tracing.live() == []


def test_sample_zero_traces_nothing_same_tokens(jmodel, monkeypatch):
    traced = _traffic("torch", None)
    tracing.reset()
    monkeypatch.setenv("PENROZ_TRACE_SAMPLE", "0")
    untraced = _traffic("torch", None)
    assert [t for t, _ in untraced] == [t for t, _ in traced]
    assert all(trace is None for _, trace in untraced)
    assert tracing.completed(10) == [] and tracing.live() == []
