"""Multi-step decode dispatch (``PENROZ_DECODE_CHUNK``) of the port's
single-sequence ``/generate/`` path against the JAX package's, on the CPU,
where the runner (models/decode_graphs.py) runs its step eagerly:

- ``_decode_chunk_size`` equal to JAX's over a grid;
- the dispatches of tests/test_model.py's chunk tests: 96 tokens at budget
  128 are one 128-step chunk; 11 tokens at budget 16 one 16-step chunk
  (overshoot discarded); the stream ramps (8, then 16, ...) and equals the
  batch; the same chunk lists as the JAX package's;
- greedy tokens equal to the JAX package's on the contiguous, int8, paged
  and int8 paged caches, for GPT and the hybrid, across the overflow crop,
  also at block 4;
- appends at device positions leave the same K/V, int8 scales, paged
  pools, SSM state and checkpoint ring as appends at the host length;
- sampled tokens deterministic for a seed and the same at
  ``PENROZ_DECODE_CHUNK`` 1 and 16;
- concurrent requests on one runner key: two interleaved streams, each
  with a runner of its own, and three threads (the third waits for a
  runner), every output equal to the request served alone;
- the idle pool: one runner a key, bounded by bytes, emptied when a model
  is deleted.

Small models (d 32, 2 layers, vocab 64, block 16), fp32; greedy tokens
are compared exactly."""

import threading

import numpy as np
import pytest
import torch

from penroz_tpu.models import model as jmodel
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu_torch.models import decode_graphs as DG
from penroz_tpu_torch.models import model as tmodel
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops import ssm as SSM

PROMPT = [1, 2, 3, 4, 5]
MODELS = {
    "gpt": presets.gpt2_custom(d=32, heads=4, depth=2, vocab=64, block=16),
    "hybrid": presets.hybrid_custom(d=32, heads=4, depth=2, vocab=64,
                                    block=16),
}
CACHES = {"contiguous": {}, "int8": {"TURBO_QUANT_KV_CACHE": "1"},
          "paged": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "4"},
          "int8_paged": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "4",
                         "TURBO_QUANT_KV_CACHE": "1"}}


@pytest.fixture(autouse=True)
def fresh_runners():
    DG.reset()
    yield
    DG.reset()


def _pair(layers, optimizer):
    jm = JModel("j", JMapper(layers, optimizer))
    tm = from_jax_state_dict(jm.state_dict(), layers, optimizer,
                             device="cpu")
    return jm, tm


def _count_chunks(monkeypatch, jm=None):
    """Record the chunk of every decode dispatch, the port's and (given a
    JAX model) the JAX package's."""
    port, jax_calls = [], []
    real = DG.DecodeRunner.decode

    def decode(self, chunk):
        port.append(chunk)
        return real(self, chunk)

    monkeypatch.setattr(DG.DecodeRunner, "decode", decode)
    if jm is not None:
        jreal = type(jm.arch).decode_chunk

        def jdecode(self, *a, chunk, **kw):
            jax_calls.append(chunk)
            return jreal(self, *a, chunk=chunk, **kw)

        monkeypatch.setattr(type(jm.arch), "decode_chunk", jdecode)
    return port, jax_calls


def test_decode_chunk_size_equals_jax(monkeypatch):
    for remaining in range(1, 300, 7):
        for cap in range(1, 260, 5):
            assert tmodel._decode_chunk_size(remaining, cap) == \
                jmodel._decode_chunk_size(remaining, cap), (remaining, cap)
    for value in ("1", "16", "128", "0"):
        monkeypatch.setenv("PENROZ_DECODE_CHUNK", value)
        assert tmodel._chunk_budget() == jmodel._chunk_budget()


def test_generate_dispatch_count(toy_optimizer, monkeypatch):
    """96 tokens at budget 128: one prefill and ONE 128-step chunk (33
    overshot steps discarded), as in the JAX package.  (The position
    table holds the block: a block_size past it is refused.)"""
    layers = presets.gpt2_custom(d=32, heads=4, depth=2, vocab=64,
                                 block=256)
    jm, tm = _pair(layers, toy_optimizer)
    port, jax_calls = _count_chunks(monkeypatch, jm)
    monkeypatch.setenv("PENROZ_DECODE_CHUNK", "128")
    tokens = tm.generate_tokens([[1, 2]], block_size=256, max_new_tokens=96,
                                temperature=0.0)
    assert len(tokens) == 98
    assert port == [128]
    assert tokens == jm.generate_tokens([[1, 2]], block_size=256,
                                        max_new_tokens=96, temperature=0.0)
    assert jax_calls == port


def test_generate_tail_overshoot_chunking(toy_optimizer, monkeypatch):
    """11 new tokens at budget 16: one 16-step chunk, 6 discarded; the
    stream ramps 8, then 2, and equals the batch.  (A 64-row position
    table: a block_size past the table is refused.)"""
    monkeypatch.setenv("PENROZ_DECODE_CHUNK", "16")
    layers = presets.gpt2_custom(d=32, heads=4, depth=2, vocab=64, block=64)
    jm, tm = _pair(layers, toy_optimizer)
    port, jax_calls = _count_chunks(monkeypatch, jm)
    batch = tm.generate_tokens([[1, 2]], block_size=64, max_new_tokens=11,
                               temperature=0.0)
    assert len(batch) == 13 and port == [16]
    stream = list(tm.generate_tokens_stream([[1, 2]], block_size=64,
                                            max_new_tokens=11,
                                            temperature=0.0))
    assert stream == batch[2:]
    assert port == [16, 8, 2]
    assert jm.generate_tokens([[1, 2]], block_size=64, max_new_tokens=11,
                              temperature=0.0) == batch
    assert list(jm.generate_tokens_stream([[1, 2]], block_size=64,
                                          max_new_tokens=11,
                                          temperature=0.0)) == stream
    assert jax_calls == port


@pytest.mark.parametrize("cache", sorted(CACHES))
@pytest.mark.parametrize("name", sorted(MODELS))
def test_greedy_tokens_match_jax(name, cache, toy_optimizer, monkeypatch):
    """Across the overflow crop at block 16 (5 + 30 tokens: chunks cut by
    the room left, then one re-prefill a token) and at block 4."""
    for key, value in CACHES[cache].items():
        monkeypatch.setenv(key, value)
    jm, tm = _pair(MODELS[name], toy_optimizer)
    for block, new in ((16, 30), (4, 10)):
        want = jm.generate_tokens(PROMPT, block, new, temperature=0)
        assert tm.generate_tokens(PROMPT, block, new, temperature=0) == want
        assert list(tm.generate_tokens_stream(PROMPT, block, new,
                                              temperature=0)) == want[5:]


def _states(kind):
    """An empty 2-layer state of ``kind`` with a 3-slot SSM child."""
    specs = [(2, 8), (2, 8)]
    if kind == "paged":
        st = KV.PagedKVState.create(specs, 1, 16, page_size=4)
    elif kind == "int8_paged":
        st = KV.QuantPagedKVState.create(specs, 1, 16, page_size=4)
    elif kind == "int8":
        st = KV.QuantKVState.create(specs, 1, 16)
    else:
        st = KV.KVState.create(specs, 1, 16)
    st.ssm = SSM.SSMState.create([(2, 4, 4)], 1, ckpt_slots=3)
    return st


@pytest.mark.parametrize("T", [1, 3])
@pytest.mark.parametrize("kind", ["contiguous", "int8", "paged",
                                  "int8_paged"])
def test_device_position_appends_equal_host_appends(kind, T):
    host, dev = _states(kind), _states(kind)
    g = torch.Generator().manual_seed(5)
    for step in range(4):  # lengths 0, T, 2T, 3T
        L = host.length
        kv = [torch.randn(1, 2, T, 8, generator=g) for _ in range(4)]
        q, k, v = (torch.randn(1, T, 2, 4, generator=g) for _ in range(3))
        gate = torch.rand(1, T, 2, generator=g)
        positions = KV.step_positions(torch.tensor([L]), T, 1)
        dev.reserve(L + T)
        dev.at_positions(positions)
        for layer in range(2):
            if kind.endswith("paged"):
                _, _, h_len = host.append_rows(layer, *kv[2 * layer:][:2])
                _, _, d_len = dev.append_rows(layer, *kv[2 * layer:][:2])
            elif kind == "int8":
                _, _, h_len = host.append_raw(layer, *kv[2 * layer:][:2])
                _, _, d_len = dev.append_raw(layer, *kv[2 * layer:][:2])
            else:
                _, _, h_len = host.append(layer, *kv[2 * layer:][:2])
                _, _, d_len = dev.append(layer, *kv[2 * layer:][:2])
            assert d_len.tolist() == [h_len] == [L + T]
        y_host = host.ssm.update_dense(0, q, k, v, gate, L)
        y_dev = dev.ssm.update_dense(0, q, k, v, gate,
                                     positions.index.view(1, T))
        dev.at_positions(None)
        host.advanced(T)
        dev.advanced(T)
        assert torch.equal(y_host, y_dev)
    names = ["k", "v"] + (["k_scale", "v_scale"] if host.quantized else [])
    for name in names:
        for a, b in zip(getattr(host, name), getattr(dev, name)):
            assert torch.equal(a, b), name
    if kind.endswith("paged"):
        assert np.array_equal(host.table, dev.table)
        assert torch.equal(host.block_table, dev.block_table)
    for a, b in zip((*host.ssm.state, *host.ssm.ckpt, host.ssm.ckpt_pos),
                    (*dev.ssm.state, *dev.ssm.ckpt, dev.ssm.ckpt_pos)):
        assert torch.equal(a, b)
    assert dev.length == host.length == 4 * T


@pytest.mark.parametrize("top_k", [None, 5], ids=["full", "top_k"])
def test_sampled_tokens_deterministic_and_chunk_invariant(
        toy_gpt_layers, toy_optimizer, monkeypatch, top_k):
    jm = JModel("j", JMapper(toy_gpt_layers, toy_optimizer))
    runs = {}
    for budget in ("1", "16", "16"):
        monkeypatch.setenv("PENROZ_DECODE_CHUNK", budget)
        tm = from_jax_state_dict(jm.state_dict(), toy_gpt_layers,
                                 toy_optimizer, device="cpu")
        out = tm.generate_tokens(PROMPT, 16, 20, temperature=0.8,
                                 top_k=top_k)
        runs.setdefault(budget, []).append(out)
        streamed = list(tm.generate_tokens_stream(PROMPT, 16, 20,
                                                  temperature=0.8,
                                                  top_k=top_k))
        assert len(streamed) == 20  # the model's second request
    assert runs["16"][0] == runs["16"][1] == runs["1"][0]
    assert len(runs["1"][0]) == 25
    greedy = tm.generate_tokens(PROMPT, 16, 20, temperature=0)
    assert runs["1"][0] != greedy  # sampling, not argmax


def _models(layers, optimizer, n):
    """``n`` port models on one runner key (same layers and dtypes),
    each with weights of its own."""
    return [tmodel.NeuralNetworkModel(f"m{i}", Mapper(layers, optimizer),
                                      device="cpu", seed=i)
            for i in range(n)]


def test_two_interleaved_requests_on_one_key(toy_gpt_layers, toy_optimizer,
                                             monkeypatch):
    monkeypatch.setenv("PENROZ_DECODE_CHUNK", "4")
    a, b = _models(toy_gpt_layers, toy_optimizer, 2)
    want_a = a.generate_tokens(PROMPT, 16, 24, temperature=0)[5:]
    want_b = b.generate_tokens(PROMPT, 16, 24, temperature=0)[5:]
    assert want_a != want_b
    it_a = a.generate_tokens_stream(PROMPT, 16, 24, temperature=0)
    it_b = b.generate_tokens_stream(PROMPT, 16, 24, temperature=0)
    got_a, got_b = [next(it_a)], [next(it_b)]  # both hold a runner now
    assert sum(DG._ALIVE.values()) == 2 and not DG._IDLE
    for x, y in zip(it_a, it_b):
        got_a.append(x)
        got_b.append(y)
    assert got_a == want_a and got_b == want_b
    assert next(it_b, None) is None  # zip left b at its last yield
    # one idle runner a key is kept; the other was dropped
    assert len(DG._IDLE) == 1 and sum(DG._ALIVE.values()) == 1


def test_three_threads_on_one_key(toy_gpt_layers, toy_optimizer,
                                  monkeypatch):
    """More concurrent requests than runners a key: the third waits."""
    monkeypatch.setenv("PENROZ_DECODE_CHUNK", "2")
    models = _models(toy_gpt_layers, toy_optimizer, 3)
    want = [m.generate_tokens(PROMPT, 16, 20, temperature=0)
            for m in models]
    got = [None] * 3
    start = threading.Barrier(3)

    def run(i):
        start.wait()
        got[i] = models[i].generate_tokens(PROMPT, 16, 20, temperature=0)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert got == want
    assert sum(DG._ALIVE.values()) <= DG.RUNNERS_PER_KEY


def test_abandoned_generation_returns_its_runner(toy_gpt_layers,
                                                 toy_optimizer):
    """A stop token abandons the pending chunk; the runner goes back to
    the pool and serves the next request."""
    (tm,) = _models(toy_gpt_layers, toy_optimizer, 1)
    free = tm.generate_tokens(PROMPT, 16, 20, temperature=0)
    stop = free[8]
    got = tm.generate_tokens(PROMPT, 16, 20, temperature=0, stop_token=stop)
    assert got == free[:free.index(stop, 5) + 1]
    assert sum(DG._ALIVE.values()) == 1 and len(DG._IDLE) == 1
    assert tm.generate_tokens(PROMPT, 16, 20, temperature=0) == free


def test_idle_runners_bounded_by_bytes(toy_gpt_layers, toy_optimizer,
                                       monkeypatch):
    """Idle runners hold at most IDLE_SHARE of the device's memory
    together: with room for one, a second key's runner evicts the first
    (least recently used); with room for none, nothing is kept."""
    (tm,) = _models(toy_gpt_layers, toy_optimizer, 1)
    want = tm.generate_tokens(PROMPT, 16, 20, temperature=0)
    (runner,) = DG._IDLE.values()
    monkeypatch.setattr(DG, "_device_bytes",
                        lambda device: runner.nbytes / DG.IDLE_SHARE)
    tm.generate_tokens(PROMPT, 16, 20, temperature=0.5, top_k=3)
    (key,) = DG._IDLE
    assert "top_k" in key[-2] and sum(DG._ALIVE.values()) == 1
    monkeypatch.setattr(DG, "_device_bytes", lambda device: 0)
    assert tm.generate_tokens(PROMPT, 16, 20, temperature=0) == want
    assert not DG._IDLE and not DG._ALIVE


def test_delete_drops_idle_runners(toy_gpt_layers, toy_optimizer,
                                   tmp_path, monkeypatch):
    """An idle runner holds the weights of the last request it served:
    deleting a model drops every idle runner."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tmodel.checkpoint, "SHM_PATH", str(tmp_path))
    (tm,) = _models(toy_gpt_layers, toy_optimizer, 1)
    tm.generate_tokens(PROMPT, 16, 8, temperature=0)
    assert len(DG._IDLE) == 1
    tmodel.NeuralNetworkModel.delete("m0")
    assert not DG._IDLE and not DG._ALIVE
