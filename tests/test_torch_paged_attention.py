"""The port's plain paged-decode and ragged paged-attention versions against
the JAX package's Pallas kernels in interpret mode, on the same pools,
block tables and queries (fp32, atol 1e-5: both sum in fp32, in different
orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.ops.pallas import paged_attention as JPA
from penroz_tpu.ops.pallas import ragged_paged_attention as JRPA
from penroz_tpu_torch.ops import attention as TA
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops.kernels import paged_attention as TPA
from penroz_tpu_torch.ops.kernels import ragged_paged_attention as TRPA

ATOL = 1e-5
P = 8        # page size
PAGES = 6    # pages per sequence
D = 32


def _pools(rng, hkv, num_pages, int8):
    shape = (hkv, num_pages * P, D)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, (hkv, num_pages * P, 1)).astype(
            np.float32)
        vs = rng.uniform(0.005, 0.02, (hkv, num_pages * P, 1)).astype(
            np.float32)
        return k, v, ks, vs
    return (rng.normal(size=shape).astype(np.float32),
            rng.normal(size=shape).astype(np.float32), None, None)


def _table(rng, rows, live_pages, num_pages):
    """Each row's live pages on distinct shuffled physical pages; the rest
    of the row is -1 (unassigned)."""
    perm = rng.permutation(num_pages)
    table = np.full((rows, PAGES), -1, np.int32)
    used = 0
    for r, n in enumerate(live_pages):
        table[r, :n] = perm[used:used + n]
        used += n
    return table


def _opts(case, hq):
    kw = {}
    if case.get("window"):
        kw["window"] = case["window"]
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(hq)
    if case.get("softcap"):
        kw["softcap"] = case["softcap"]
    if case.get("scale"):
        kw["scale"] = case["scale"]
    return kw


def _both(arrays):
    """(jax arrays, torch tensors) of the same numpy arrays (None kept)."""
    j = [None if a is None else jnp.asarray(a) for a in arrays]
    t = [None if a is None else torch.as_tensor(a) for a in arrays]
    return j, t


DECODE_CASES = [
    dict(name="T1_ragged", T=1, hq=4, hkv=4, lengths=[13, 37]),
    dict(name="T3_ragged", T=3, hq=4, hkv=4, lengths=[9, 44]),
    dict(name="gqa_4_2", T=2, hq=4, hkv=2, lengths=[17, 30]),
    dict(name="scalar_length", T=2, hq=4, hkv=2, lengths=29),
    dict(name="window", T=2, hq=4, hkv=2, lengths=[26, 41], window=10),
    dict(name="alibi", T=1, hq=4, hkv=2, lengths=[19, 33], alibi=True),
    dict(name="softcap_scale", T=2, hq=4, hkv=4, lengths=[11, 40],
         softcap=5.0, scale=0.3),
    dict(name="int8", T=1, hq=4, hkv=2, lengths=[22, 35], int8=True),
    dict(name="int8_window_alibi", T=3, hq=4, hkv=2, lengths=[15, 46],
         int8=True, window=12, alibi=True),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: c["name"])
def test_paged_decode_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(len(case["name"]))
    B, T, hq, hkv = 2, case["T"], case["hq"], case["hkv"]
    lengths = case["lengths"]
    per_row = np.broadcast_to(np.asarray(lengths), (B,))
    live = [-(-int(n) // P) for n in per_row]
    num_pages = 2 * PAGES
    k, v, ks, vs = _pools(rng, hkv, num_pages, case.get("int8"))
    table = _table(rng, B, live, num_pages)
    assert (table == -1).any()
    q = rng.normal(size=(B, hq, T, D)).astype(np.float32)
    (jq, jk, jv, jks, jvs, jt), (tq, tk, tv, tks, tvs, tt) = _both(
        [q, k, v, ks, vs, table])
    if np.ndim(lengths):
        jlen = jnp.asarray(lengths, jnp.int32)
        tlen = torch.tensor(lengths, dtype=torch.int32)
        offset = 0
    else:
        jlen = tlen = lengths
        offset = lengths - T
    kw = _opts(case, hq)
    want = JPA.paged_decode_attention(jq, jk, jv, jt, P, offset, jlen,
                                      k_scale=jks, v_scale=jvs,
                                      interpret=True, **kw)
    got = TPA.paged_decode_attention(tq, tk, tv, tt, P, offset, tlen,
                                     k_scale=tks, v_scale=tvs, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the attention entry point routes CPU tensors to the same plain version
    same = TA.paged_cached_attention(tq, tk, tv, tt, P, offset, tlen,
                                     k_scale=tks, v_scale=tvs, **kw)
    assert torch.equal(same, got)


BQ = 4
# A prefill chunk of row 0 (three descriptor blocks, the last partial), a
# second chunk of row 2, decode steps of rows 1 and 3, then padding.
SPANS = [(0, 5, 11), (1, 20, 1), (2, 8, 4), (3, 30, 1)]
NB = 10


def _ragged_case(rng, hq, hkv, int8):
    num_pages = 4 * PAGES
    k, v, ks, vs = _pools(rng, hkv, num_pages, int8)
    live = [-(-(q0 + n) // P) for _, q0, n in SPANS]
    table = _table(rng, len(SPANS), live, num_pages)
    jdescs, offsets = JKV.build_descriptors(SPANS, BQ, NB)
    tdescs, toffsets = TKV.build_descriptors(SPANS, BQ, NB)
    np.testing.assert_array_equal(tdescs, np.asarray(jdescs))
    assert toffsets == offsets
    q = rng.normal(size=(1, hq, NB * BQ, D)).astype(np.float32)
    return q, k, v, ks, vs, table, tdescs, offsets


RAGGED_CASES = [
    dict(name="mha", hq=4, hkv=4),
    dict(name="gqa_4_2", hq=4, hkv=2),
    dict(name="window", hq=4, hkv=2, window=6),
    dict(name="alibi_softcap_scale", hq=4, hkv=4, alibi=True, softcap=8.0,
         scale=0.25),
    dict(name="int8", hq=4, hkv=2, int8=True),
    dict(name="int8_window_alibi", hq=4, hkv=2, int8=True, window=5,
         alibi=True),
]


@pytest.mark.parametrize("case", RAGGED_CASES, ids=lambda c: c["name"])
def test_ragged_plain_matches_jax_kernel(case):
    rng = np.random.default_rng(100 + len(case["name"]))
    hq, hkv = case["hq"], case["hkv"]
    q, k, v, ks, vs, table, descs, offsets = _ragged_case(
        rng, hq, hkv, case.get("int8"))
    (jq, jk, jv, jks, jvs, jt, jd), (tq, tk, tv, tks, tvs, tt, td) = _both(
        [q, k, v, ks, vs, table, descs])
    kw = _opts(case, hq)
    want = np.asarray(JRPA.ragged_paged_attention(
        jq, jk, jv, jt, P, jd, k_scale=jks, v_scale=jvs, interpret=True,
        **kw))
    got = TRPA.ragged_paged_attention(tq, tk, tv, tt, P, td, k_scale=tks,
                                      v_scale=tvs, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    # padding slots — padding descriptors and t >= q_valid — are exactly 0
    real = np.zeros(NB * BQ, bool)
    for (_, _, n), off in zip(SPANS, offsets):
        real[TKV.packed_slots(off, n, BQ)] = True
    assert (~real).sum() > 0
    assert np.all(got[0][:, ~real] == 0.0)
    assert np.all(want[0][:, ~real] == 0.0)
    same = TA.ragged_paged_cached_attention(tq, tk, tv, tt, P, td,
                                            k_scale=tks, v_scale=tvs, **kw)
    assert torch.equal(same, torch.as_tensor(got))


def test_ragged_equals_paged_decode_per_span():
    """Each span of a packed batch attends as its own paged call would:
    the ragged plain version, span by span, equals the paged plain version
    at that row's length (the unified step computes what sequential
    per-phase attention computes)."""
    rng = np.random.default_rng(7)
    hq, hkv = 4, 2
    q, k, v, _, _, table, descs, offsets = _ragged_case(rng, hq, hkv, False)
    tq, tk, tv, tt = (torch.as_tensor(a) for a in (q, k, v, table))
    packed = TRPA.ragged_paged_attention(tq, tk, tv, tt, P,
                                         torch.as_tensor(descs))
    for (row, q0, n), off in zip(SPANS, offsets):
        slots = torch.as_tensor(TKV.packed_slots(off, n, BQ))
        qs = tq[:, :, slots]                           # (1, hq, n, D)
        one = TPA.paged_decode_attention(qs, tk, tv, tt[row:row + 1], P,
                                         q0, q0 + n)
        torch.testing.assert_close(packed[:, :, slots], one, atol=ATOL,
                                   rtol=0)


def test_wrappers_count_only_kernel_launches():
    """A CPU tensor runs the plain version and launches nothing."""
    rng = np.random.default_rng(3)
    q, k, v, _, _, table, descs, _ = _ragged_case(rng, 4, 4, False)
    before = (TPA.paged_decode_attention.launches,
              TRPA.ragged_paged_attention.launches)
    TRPA.ragged_paged_attention(*(torch.as_tensor(a) for a in (q, k, v)),
                                torch.as_tensor(table), P,
                                torch.as_tensor(descs))
    assert (TPA.paged_decode_attention.launches,
            TRPA.ragged_paged_attention.launches) == before
    assert TRPA.default_block_q() == JRPA.default_block_q()
    assert TRPA.DESC_COLS == JRPA.DESC_COLS
