"""The port's radix prefix cache (ops/kv_cache.py ``RadixPrefixCache``, the
pool's ``with_row_prefix``/``restore_row_table``/``copy_pages``) against the
JAX package's, and its continuous-batching engine with
``PENROZ_PREFIX_CACHE=1`` against the JAX package's single-sequence
generation on the same weights: greedy tokens must be identical on a
miss, a hit, a repeat hit and a re-match after eviction, on fp32 and int8
pages, whatever the prefill chunk.  Toy size: block 16, pages of 4 tokens,
8 cache pages, chunks of 4 (the JAX suite's ``prefix_env``)."""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.utils import checkpoint as tckpt

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
PREFIX = [1, 2, 3, 4, 5, 6, 7, 8]          # 2 full pages of 4


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel("prefix", JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def prefix_env(monkeypatch):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    monkeypatch.setenv("PENROZ_PREFILL_CHUNK", "4")
    monkeypatch.delenv("TURBO_QUANT_KV_CACHE", raising=False)
    monkeypatch.delenv("PENROZ_SPEC_DECODE", raising=False)
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


def _no_pins(cache):
    return all(nd.refs == 0 for nd in cache.iter_nodes())


# -- the radix tree against the JAX package's --------------------------------

_TOKENS = st.lists(st.integers(0, 2), min_size=0, max_size=9)
_OPS = st.lists(st.one_of(
    st.tuples(st.just("match"), _TOKENS, st.one_of(st.none(),
                                                   st.integers(0, 9))),
    st.tuples(st.just("insert"), _TOKENS, st.one_of(st.none(),
                                                    st.integers(0, 9))),
    st.tuples(st.just("chain"), _TOKENS, st.none()),
    st.tuples(st.just("pin"), _TOKENS, st.none()),
    st.tuples(st.just("unpin"), st.just([]), st.none()),
    st.tuples(st.just("clear"), st.just([]), st.none())),
    min_size=1, max_size=40)


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(ops=_OPS)
def test_radix_cache_matches_jax(ops):
    """Random sequences of match/insert/chain/pin/unpin/clear over pages of
    2 tokens from a 3-token alphabet and a 4-page region (so chains share
    prefixes and eviction runs): the same pages, the same new blocks, the
    same stats, free lists, refcounts and page audit after every op."""
    ours = KV.RadixPrefixCache(range(10, 14), 2)
    ref = JKV.RadixPrefixCache(list(range(10, 14)), 2)
    pinned = []     # (ours, ref) node chains pinned, in order
    for op, tokens, limit in ops:
        if op in ("match", "chain", "pin"):
            fn = "match" if op == "pin" else op
            a = getattr(ours, fn)(tokens, limit=limit)
            b = getattr(ref, fn)(tokens, limit=limit)
            assert [n.page for n in a] == [n.page for n in b]
            if op == "pin":
                ours.pin(a)
                ref.pin(b)
                pinned.append((a, b))
        elif op == "insert":
            assert ours.insert(tokens, limit=limit) == ref.insert(
                tokens, limit=limit)
        elif op == "unpin":
            if pinned:
                a, b = pinned.pop(0)
                ours.unpin(a)
                ref.unpin(b)
            else:  # an unpaired unpin clamps at zero and is counted
                a = ours.chain([0, 0, 0, 0])
                b = ref.chain([0, 0, 0, 0])
                ours.unpin(a)
                ref.unpin(b)
                assert ours.unpin_underflows == ref.unpin_underflows
        else:
            if pinned:      # a reload happens with no row in flight
                continue
            ours.clear()
            ref.clear()
        assert ours.stats() == ref.stats()
        assert ours._free == ref._free
        assert ours.page_audit() == ref.page_audit() == []
        assert sorted((n.page, n.refs) for n in ours.iter_nodes()) == \
            sorted((n.page, n.refs) for n in ref.iter_nodes())


def test_radix_insert_never_evicts_its_own_chain():
    """A 2-page region and a 3-page prompt: insert stops at the region's
    size instead of recycling a page of the chain it is building; pinned
    pages survive an insert that needs room; an unpinned leaf goes first."""
    cache = KV.RadixPrefixCache([5, 6], 2)
    assert cache.insert([1, 1, 2, 2, 3, 3]) == [(0, 5), (1, 6)]
    nodes = cache.match([1, 1, 2, 2, 9])
    cache.pin(nodes)
    assert cache.insert([4, 4]) == []          # everything is pinned
    cache.unpin(nodes)
    assert cache.insert([4, 4]) == [(0, 6)]    # the LRU leaf [2, 2] goes
    assert cache.stats()["evicted_pages"] == 1
    assert [n.page for n in cache.match([1, 1, 2, 2])] == [5]
    assert cache.page_audit() == []
    cache.unpin(nodes[:1])
    cache.unpin(nodes[:1])
    assert cache.unpin_underflows == 2


def test_prefix_cache_knobs(monkeypatch):
    monkeypatch.delenv("PENROZ_PREFIX_CACHE", raising=False)
    assert not KV.prefix_cache_enabled()
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    assert KV.prefix_cache_enabled()
    for raw, want in (("12", 12), ("0", 0), ("-3", 64), ("x", 64)):
        monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", raw)
        assert KV.prefix_cache_pages() == want == JKV.prefix_cache_pages()


# -- the pool against the JAX package's --------------------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_pool_prefix_ops_match_jax(monkeypatch, int8):
    """``create_kv_state(extra_pool_pages=…)`` sizes the pool past the
    partition; ``with_row_prefix``, ``copy_pages`` (values and int8
    scales) and ``restore_row_table`` give the JAX package's block table
    and pools on the same numpy pools."""
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    specs = [(2, 8), (2, 8)]
    batch, max_len, extra = 3, 16, 5
    ours = KV.create_kv_state(specs, batch, max_len, quantized=int8,
                              paged=True, device="cpu",
                              extra_pool_pages=extra).with_static_table()
    ref = JKV.create_kv_state(specs, batch, max_len, quantized=int8,
                              paged=True,
                              extra_pool_pages=extra).with_static_table()
    assert ours.num_pool_pages == ref.num_pool_pages == batch * 4 + extra
    rng = np.random.default_rng(0)
    names = ["k", "v"] + (["k_scale", "v_scale"] if int8 else [])
    for name in names:
        pools = []
        for a in getattr(ref, name):
            if a.dtype == jnp.int8:
                x = rng.integers(-128, 128, a.shape).astype(np.int8)
            else:
                x = rng.standard_normal(a.shape).astype(np.float32)
            pools.append(x)
        setattr(ref, name, [jnp.asarray(x) for x in pools])
        setattr(ours, name, [torch.from_numpy(x.copy()) for x in pools])

    def same():
        np.testing.assert_array_equal(ours.table, np.asarray(ref.block_table))
        np.testing.assert_array_equal(ours.block_table.numpy(),
                                      np.asarray(ref.block_table))
        for name in names:
            for a, b in zip(getattr(ours, name), getattr(ref, name)):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    shared = [12, 15]
    ours.with_row_prefix(1, shared)
    ref = ref.with_row_prefix(1, shared)
    same()
    ours.copy_pages([4, 5, 9], [13, 14, 16])
    ref = ref.copy_pages([4, 5, 9], [13, 14, 16])
    same()
    ours.copy_pages([], [])
    ours.restore_row_table(1)
    ref = ref.restore_row_table(1)
    same()
    with pytest.raises(ValueError, match="pages_per_seq"):
        ours.with_row_prefix(0, range(5))
    with pytest.raises(ValueError, match="equal-length"):
        ours.copy_pages([1], [])


# -- the engine against the JAX package's generation -------------------------

@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("chunk", ["16", "2"])
def test_prefix_hit_miss_parity(jmodel, prefix_env, make_engine, int8,
                                chunk):
    """Miss, hit on another suffix, repeat hit: every stream equal to JAX
    ``generate_tokens``; the hits alias the shared prefix's two pages
    (``hit_tokens`` counts the prefill they skip) and prefill fewer
    chunks; no page leaks and no pin outlives its row."""
    if int8:
        prefix_env.setenv("TURBO_QUANT_KV_CACHE", "1")
    prefix_env.setenv("PENROZ_PREFILL_CHUNK", chunk)
    px, py = PREFIX + [9, 10], PREFIX + [11]
    want_x = jmodel.generate_tokens([px], BLOCK, 4, temperature=0.0)
    want_y = jmodel.generate_tokens([py], BLOCK, 4, temperature=0.0)
    engine = make_engine("prefix", BLOCK, 0.0, None, capacity=2)
    assert engine._kv.quantized == int8
    assert engine._kv.num_pool_pages == 2 * 4 + 8
    assert DS.run_request(engine, px, 4, None, timeout=WAIT_S) == want_x
    chunks_miss = engine.stats()["prefill_chunks"]
    assert DS.run_request(engine, py, 4, None, timeout=WAIT_S) == want_y
    assert DS.run_request(engine, px, 4, None, timeout=WAIT_S) == want_x
    stats = engine.stats()
    pc = stats["prefix_cache"]
    assert pc["misses"] == 1 and pc["hits"] == 2, pc
    assert pc["hit_tokens"] == 16
    assert pc["hit_rate"] == pytest.approx(2 / 3)
    assert pc["cached_pages"] == 2 and pc["capacity_pages"] == 8
    # a hit prefills its suffix only: one chunk of 1 and one of 2 tokens
    assert stats["prefill_chunks"] == chunks_miss + 2
    cache = engine._prefix_cache
    assert cache.page_audit() == [] and _no_pins(cache)
    # retired rows are back on their own partition
    np.testing.assert_array_equal(
        engine._kv.table, np.arange(8, dtype=np.int32).reshape(2, 4))


def test_prefix_hits_share_pages_concurrently(jmodel, prefix_env,
                                              make_engine):
    """Two rows in flight at once alias the same cached pages (their
    tables name the same tail pages, pinned twice) and keep their
    streams."""
    px, py = PREFIX + [9, 10, 11], PREFIX + [12]
    want_x = jmodel.generate_tokens([px], BLOCK, 5, temperature=0.0)
    want_y = jmodel.generate_tokens([py], BLOCK, 6, temperature=0.0)
    engine = make_engine("prefix", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, PREFIX + [1], 1, None,
                          timeout=WAIT_S)[:9] == PREFIX + [1]   # warm
    seen = []
    real = engine._model.decode_mixed_step

    def spy(kv, *args, **kwargs):
        seen.append(kv.table[:, :2].copy())
        return real(kv, *args, **kwargs)

    prefix_env.setattr(engine._model, "decode_mixed_step", spy)
    handles = []
    with engine._cond:
        for prompt, n in ((px, 5), (py, 6)):
            req, events = DS._queued_request(prompt, n, None)
            engine._pending.push(req)
            handles.append((req, events))
        engine._cond.notify_all()
    got = [DS.collect(req, events, WAIT_S) for req, events in handles]
    assert got == [want_x, want_y]
    tail = [nd.page for nd in engine._prefix_cache.chain(PREFIX)]
    assert len(tail) == 2 and min(tail) >= 2 * 4
    assert any((t == tail).all() for t in seen)
    assert engine.stats()["prefix_cache"]["hits"] == 2
    assert _no_pins(engine._prefix_cache)


def test_prefix_eviction_then_rematch_parity(jmodel, prefix_env,
                                             make_engine):
    """A 4-page region churned by three distinct 2-page prefixes until the
    first is LRU-evicted; resubmitted, it is prefilled and registered
    again, token-identical."""
    prefix_env.setenv("PENROZ_PREFIX_CACHE_PAGES", "4")
    pa = PREFIX + [9]
    want_a = jmodel.generate_tokens([pa], BLOCK, 4, temperature=0.0)
    engine = make_engine("prefix", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, pa, 4, None, timeout=WAIT_S) == want_a
    for j in range(3):
        p = [20 + j] * 8 + [j]
        want = jmodel.generate_tokens([p], BLOCK, 3, temperature=0.0)
        assert DS.run_request(engine, p, 3, None, timeout=WAIT_S) == want
    pc = engine.stats()["prefix_cache"]
    assert pc["evicted_pages"] > 0, pc
    assert not engine._prefix_cache.chain(PREFIX)      # evicted
    assert DS.run_request(engine, pa, 4, None, timeout=WAIT_S) == want_a
    assert len(engine._prefix_cache.chain(PREFIX)) == 2  # registered again
    pc = engine.stats()["prefix_cache"]
    assert pc["capacity_pages"] == 4 and pc["cached_pages"] == 4
    assert engine._prefix_cache.page_audit() == []
    assert DS.run_request(engine, pa, 4, None, timeout=WAIT_S) == want_a
    assert engine.stats()["prefix_cache"]["hits"] == 1


def test_prefix_crash_rebuilds_an_empty_cache(jmodel, prefix_env,
                                              make_engine):
    """A tick that raises while a row aliases cached pages fails its
    request; the rebuilt engine has an empty cache with no pins, its rows
    on their own partition, and the next requests are greedy-identical."""
    want = jmodel.generate_tokens([PREFIX + [9]], BLOCK, 5,
                                  temperature=0.0)
    engine = make_engine("prefix", BLOCK, 0.0, None, capacity=2)
    assert DS.run_request(engine, PREFIX + [9], 5, None,
                          timeout=WAIT_S) == want
    old = engine._prefix_cache
    assert old.cached_pages == 2
    real = engine._model.decode_mixed_step
    calls = {"n": 0}
    pinned = {}

    def flaky(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            pinned["refs"] = [nd.refs for nd in old.iter_nodes()]
            raise RuntimeError("injected")
        return real(*args, **kwargs)

    prefix_env.setattr(engine._model, "decode_mixed_step", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        DS.run_request(engine, PREFIX + [9], 5, None, timeout=WAIT_S)
    assert pinned["refs"] == [1, 1]      # the row held the cached pages
    deadline = time.monotonic() + WAIT_S   # the error reaches us first
    while engine._prefix_cache is old or engine._lengths.any():
        assert time.monotonic() < deadline, "the engine was not rebuilt"
        time.sleep(0.01)
    cache = engine._prefix_cache
    assert cache.cached_pages == 0 and cache.page_audit() == []
    assert _no_pins(cache) and _no_pins(old)
    np.testing.assert_array_equal(
        engine._kv.table, np.arange(8, dtype=np.int32).reshape(2, 4))
    stats = engine.stats()
    assert stats["crashes_total"] == stats["engine_resets"] == 1
    assert DS.run_request(engine, PREFIX + [9], 5, None,
                          timeout=WAIT_S) == want
    assert DS.run_request(engine, PREFIX + [9], 5, None,
                          timeout=WAIT_S) == want
    assert engine.stats()["prefix_cache"]["hits"] == 1
