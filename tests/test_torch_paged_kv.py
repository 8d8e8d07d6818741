"""The port's paged KV pools, descriptor builders and bucketing against the
JAX package's, on seeded spans: pools, block tables and lengths after the
same append sequences (exact: the same scatters of the same values)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.utils import bucketing as JB
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops.kernels import paged_attention as PA
from penroz_tpu_torch.utils import bucketing as TB

SPECS = [(2, 8), (2, 8)]


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 9, 31, 64, 100])
def test_bucketing_matches_jax(n):
    for lo, hi in ((1, None), (1, 8), (2, 4), (1, 1)):
        assert TB.clamp_pow2_floor(n, lo, hi) == JB.clamp_pow2_floor(n, lo, hi)
    for minimum in (1, 3, 8):
        assert TB.bucket_count(n, minimum) == JB.bucket_count(n, minimum)
    for chunk in (2, 16, 256):
        assert TB.chunk_plan(n, chunk) == JB.chunk_plan(n, chunk)


def _spans(rng, rows, max_len, count):
    """Seeded (row, q_start, q_len) spans, one per distinct row."""
    picked = rng.choice(rows, size=count, replace=False)
    spans = []
    for row in picked:
        q_start = int(rng.integers(0, max_len - 1))
        q_len = int(rng.integers(1, 12))
        spans.append((int(row), q_start, q_len))
    return spans


@pytest.mark.parametrize("seed", range(4))
def test_descriptors_and_slots_match_jax(seed):
    rng = np.random.default_rng(seed)
    spans = _spans(rng, 6, 40, 4)
    for block_q in (1, 4, 8):
        need = sum(-(-n // block_q) for _, _, n in spans)
        nb = TB.bucket_count(need)
        td, toff = TKV.build_descriptors(spans, block_q, nb)
        jd, joff = JKV.build_descriptors(spans, block_q, nb)
        np.testing.assert_array_equal(td, np.asarray(jd))
        assert toff == joff
        for (_, _, n), off in zip(spans, toff):
            np.testing.assert_array_equal(
                TKV.packed_slots(off, n, block_q),
                np.asarray(JKV.packed_slots(off, n, block_q)))
        with pytest.raises(ValueError, match="num_blocks"):
            TKV.build_descriptors(spans, block_q, need - 1)


def _assert_state_equal(t, j):
    assert t.next_free == int(j.next_free)
    assert t.assigned_pages == int(j.assigned_pages)
    np.testing.assert_array_equal(t.table, np.asarray(j.block_table))
    np.testing.assert_array_equal(t.block_table.numpy(),
                                  np.asarray(j.block_table))
    np.testing.assert_array_equal(np.asarray(t.length),
                                  np.asarray(j.length))
    pools = [(t.k, j.k), (t.v, j.v)]
    if t.quantized:
        pools += [(t.k_scale, j.k_scale), (t.v_scale, j.v_scale)]
    for tp, jp in pools:
        for a, b in zip(tp, jp):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_append_rows_matches_jax(int8):
    """Single-sequence-style appends (scalar length, bump allocator): the
    same prefill and decode steps give the same pools and tables."""
    rng = np.random.default_rng(11)
    tcls = TKV.QuantPagedKVState if int8 else TKV.PagedKVState
    jcls = JKV.QuantPagedKVState if int8 else JKV.PagedKVState
    t = tcls.create(SPECS, 2, 18, torch.float32, page_size=4)
    j = jcls.create(SPECS, 2, 18, jnp.float32, page_size=4)
    assert t.max_len == j.max_len == 20
    assert t.num_pool_pages == j.num_pool_pages
    for T in (6, 1, 1, 3, 1, 5):
        for layer in range(len(SPECS)):
            k = rng.normal(size=(2, 2, T, 8)).astype(np.float32)
            v = rng.normal(size=(2, 2, T, 8)).astype(np.float32)
            _, _, tlen = t.append_rows(layer, torch.as_tensor(k),
                                       torch.as_tensor(v))
            _, _, jlen = j.append_rows(layer, jnp.asarray(k),
                                       jnp.asarray(v))
            assert tlen == int(jlen)
        assert t.advanced(T) is t
        j = j.advanced(T)
        _assert_state_equal(t, j)
    assert t.memory_bytes() == j.memory_bytes()
    assert t.assigned_bytes() == j.assigned_bytes()
    assert t.logical_bytes() == j.logical_bytes()
    # dense views through the table, as the attention references read them
    tk = PA.gather_pages(t.k[0], t.block_table, t.page_size)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(j._gather(j.k[0])))
    assert t.reset() is t
    j = j.reset()
    _assert_state_equal(t, j)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_ragged_append_rows_matches_jax(int8):
    """Ragged (B,) lengths: each row writes at its own position, across a
    page boundary."""
    rng = np.random.default_rng(12)
    tcls = TKV.QuantPagedKVState if int8 else TKV.PagedKVState
    jcls = JKV.QuantPagedKVState if int8 else JKV.PagedKVState
    t = tcls.create(SPECS, 3, 16, torch.float32, page_size=4)
    j = jcls.create(SPECS, 3, 16, jnp.float32, page_size=4)
    t.with_static_table().with_lengths([3, 7, 0])
    j = j.with_static_table().with_lengths(jnp.asarray([3, 7, 0]))
    _assert_state_equal(t, j)
    for T in (2, 1, 3):
        for layer in range(len(SPECS)):
            k = rng.normal(size=(3, 2, T, 8)).astype(np.float32)
            t.append_rows(layer, torch.as_tensor(k), torch.as_tensor(k * 2))
            j.append_rows(layer, jnp.asarray(k), jnp.asarray(k * 2))
        t.advanced(T)
        j = j.advanced(T)
        _assert_state_equal(t, j)
    t.reset_row(1)
    j = j.reset_row(1)
    _assert_state_equal(t, j)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_append_packed_matches_jax(int8):
    """Packed mixed batches over the static partition: the same scatter
    rows (padding slots and positions past max_len dropped), pools and
    lengths after each step."""
    rng = np.random.default_rng(13)
    tcls = TKV.QuantPagedKVState if int8 else TKV.PagedKVState
    jcls = JKV.QuantPagedKVState if int8 else JKV.PagedKVState
    rows, max_len, block_q = 4, 16, 4
    t = tcls.create(SPECS, rows, max_len, torch.float32, page_size=4)
    j = jcls.create(SPECS, rows, max_len, jnp.float32, page_size=4)
    t.with_static_table().with_lengths(np.zeros(rows, np.int32))
    j = j.with_static_table().with_lengths(jnp.zeros(rows, jnp.int32))
    steps = [
        [(0, 0, 7), (1, 0, 3)],                 # two prefill chunks
        [(0, 7, 1), (1, 3, 5), (2, 0, 2)],      # decode + chunks
        [(3, 13, 6), (0, 8, 1)],                # row 3 runs past max_len
    ]
    dropped = 0
    for spans in steps:
        need = sum(-(-n // block_q) for _, _, n in spans)
        nb = TB.bucket_count(need + 1)          # at least one padding block
        descs, _ = TKV.build_descriptors(spans, block_q, nb)
        trows = t.packed_rows(descs, block_q)
        jrows = j.packed_rows(jnp.asarray(descs), block_q)
        np.testing.assert_array_equal(trows, np.asarray(jrows))
        dropped += int((trows == t.k[0].shape[1]).sum())
        index = t.packed_index(trows)
        for layer in range(len(SPECS)):
            k = rng.normal(size=(1, 2, nb * block_q, 8)).astype(np.float32)
            v = rng.normal(size=(1, 2, nb * block_q, 8)).astype(np.float32)
            t.append_packed(layer, torch.as_tensor(k), torch.as_tensor(v),
                            index)
            j.append_packed(layer, jnp.asarray(k), jnp.asarray(v), jrows)
        tl = t.lengths_after_packed(descs)
        jl = j.lengths_after_packed(jnp.asarray(descs))
        np.testing.assert_array_equal(tl, np.asarray(jl))
        t.with_lengths(tl)
        j = j.with_lengths(jl)
        _assert_state_equal(t, j)
    assert dropped > 0
    assert int(t.length[3]) == 19 > t.max_len


def test_pool_drop_count_and_guards():
    TKV.reset_pool_drop_count()
    t = TKV.PagedKVState.create([(1, 8)], 1, 8, page_size=4)
    t.append_rows(0, torch.ones(1, 1, 8, 8), torch.ones(1, 1, 8, 8))
    t.advanced(8)
    assert TKV.pool_drop_count() == 0
    t.append_rows(0, torch.ones(1, 1, 2, 8), torch.ones(1, 1, 2, 8))
    assert TKV.pool_drop_count() == 2
    TKV.reset_pool_drop_count()
    with pytest.raises(ValueError, match="pool_pages"):
        TKV.PagedKVState.create([(1, 8)], 2, 8, page_size=4, pool_pages=3)
    with pytest.raises(ValueError, match="ragged"):
        t.reset_row(0)


def test_create_kv_state_paged_layouts(monkeypatch):
    monkeypatch.setenv(TKV.PAGED_ENV, "1")
    monkeypatch.setenv(TKV.PAGE_SIZE_ENV, "16")
    monkeypatch.delenv(TKV.TURBO_QUANT_ENV, raising=False)
    state = TKV.create_kv_state([(2, 8)], 1, 40)
    assert type(state) is TKV.PagedKVState and state.page_size == 16
    assert tuple(state.k[0].shape) == (2, 48, 8)
    assert tuple(state.block_table.shape) == (1, 3)
    assert state.block_table.dtype == torch.int32
    monkeypatch.setenv(TKV.TURBO_QUANT_ENV, "1")
    state = TKV.create_kv_state([(2, 8)], 1, 40)
    assert type(state) is TKV.QuantPagedKVState and state.quantized
    assert state.k[0].dtype == torch.int8
    assert tuple(state.k_scale[0].shape) == (2, 48, 1)
    monkeypatch.setenv(TKV.PAGE_SIZE_ENV, "zero")
    assert TKV.default_page_size() == 128
