"""The decode kernels' split-K algorithm on the CPU.

The CUDA decode tiles (csrc/decode_core.cuh) cut each (sequence, kv head,
row tile)'s key range into splits (``split_plan``, ``split_ranges``),
compute each split's (max, sum, P·V) and merge them in split order inside
the launch.  The kernels run only on the card; their algorithm runs here
as ``decode_attention_split_reference`` and
``paged_decode_attention_split_reference``, held to the JAX package's jnp
paths (``cached_attention``, ``paged_cached_attention``) from numpy seeds
at atol 1e-5 in fp32, at the edges of the cut."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import attention as JA
from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu_torch.ops import attention as TA
from penroz_tpu_torch.ops.kernels import decode_attention as DA
from penroz_tpu_torch.ops.kernels import paged_attention as PA

ATOL = 1e-5


def _contiguous(seed, B, Hq, Hkv, T, S, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, T, D)).astype(np.float32)
    k = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    v = rng.normal(size=(B, Hkv, S, D)).astype(np.float32)
    return q, k, v


def _jax_cached(q, k, v, length, T, **kw):
    offset = 0 if np.ndim(length) else length - T
    return np.asarray(JA.cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(offset, jnp.int32), jnp.asarray(length, jnp.int32),
        platform="cpu", **kw))


def _split(q, k, v, length, sms, **kw):
    t_len = (torch.as_tensor(length, dtype=torch.int32) if np.ndim(length)
             else length)
    t_kw = {n: (torch.as_tensor(np.array(a)) if n.endswith("_scale")
                else a) for n, a in kw.items()}
    return DA.decode_attention_split_reference(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), 0,
        t_len, sms=sms, **t_kw).numpy()


CONTIGUOUS = [
    dict(name="L1", B=1, Hq=2, Hkv=2, T=1, S=64, D=64, length=1),
    dict(name="L65_ragged_last_split", B=1, Hq=2, Hkv=2, T=1, S=128, D=64,
         length=65),
    dict(name="L1024_16_splits", B=1, Hq=4, Hkv=4, T=1, S=1024, D=32,
         length=1024),
    dict(name="window", B=1, Hq=2, Hkv=2, T=4, S=512, D=32, length=500,
         window=70),
    dict(name="alibi", B=1, Hq=4, Hkv=2, T=1, S=300, D=32, length=300,
         alibi=True),
    dict(name="softcap", B=1, Hq=2, Hkv=2, T=2, S=300, D=32, length=290,
         softcap=5.0),
    dict(name="window_alibi_softcap_scale", B=2, Hq=4, Hkv=2, T=3, S=256,
         D=40, length=[100, 250], window=40, alibi=True, softcap=3.0,
         scale=0.2),
    dict(name="B8_lengths_1_to_1024", B=8, Hq=2, Hkv=2, T=1, S=1024, D=16,
         length=[1, 1024, 65, 512, 129, 900, 2, 333]),
    dict(name="gqa_32x8", B=1, Hq=32, Hkv=8, T=1, S=1024, D=32,
         length=1024),
    dict(name="gqa_32x8_T2_two_row_tiles", B=1, Hq=32, Hkv=8, T=2, S=300,
         D=16, length=300),
    # more splits (16) than head dims (8), two 8-row tiles a kv head
    dict(name="D8_gqa_32x8_T4_16_splits", B=1, Hq=32, Hkv=8, T=4, S=1024,
         D=8, length=1024),
]


@pytest.mark.parametrize("case", CONTIGUOUS, ids=lambda c: c["name"])
def test_split_reference_matches_jax_cached_attention(case):
    """The split-and-merge of the contiguous decode tiles equals the jnp
    oracle, with the splits a 132-SM card gets."""
    q, k, v = _contiguous(len(case["name"]), case["B"], case["Hq"],
                          case["Hkv"], case["T"], case["S"], case["D"])
    kw = {n: case[n] for n in ("window", "softcap", "scale") if n in case}
    if case.get("alibi"):
        kw["alibi"] = JA.alibi_slopes(case["Hq"])
    length = (np.asarray(case["length"], np.int32)
              if isinstance(case["length"], list) else case["length"])
    plan = DA.plan_for(case["B"], case["Hq"], case["Hkv"], case["T"],
                       torch.as_tensor(length) if np.ndim(length) else length,
                       case["S"], kw.get("window"), None, 132)
    assert plan.tile_rows > 0
    want = _jax_cached(q, k, v, length, case["T"], **kw)
    got = _split(q, k, v, length, 132, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_split_reference_int8_scales():
    """int8 K/V with per-token scales, dequantized as the kernel does."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, S, D, T = 2, 4, 2, 256, 32, 1
    state = JKV.QuantKVState.create([(Hkv, D)], B, S, jnp.float32)
    seeded = jnp.asarray(rng.normal(size=(B, Hkv, 200, D)).astype(np.float32))
    qk, qv, _ = state.append_raw(0, seeded, seeded * 0.5 + 1.0)
    q = rng.normal(size=(B, Hq, T, D)).astype(np.float32)
    kw = dict(k_scale=np.asarray(state.k_scale[0]),
              v_scale=np.asarray(state.v_scale[0]))
    want = _jax_cached(q, np.asarray(qk), np.asarray(qv), 200, T,
                       k_scale=state.k_scale[0], v_scale=state.v_scale[0])
    got = _split(q, np.asarray(qk), np.asarray(qv), 200, 132, **kw)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_split_wholly_outside_window_merges_to_nothing():
    """With more splits than the window needs, the early splits of the
    range hold no key the late rows attend (max -1e30, sum 0): merged,
    they change nothing."""
    q, k, v = _contiguous(3, 1, 2, 2, 8, 512, 32)
    length, T, window = 500, 8, 60
    want = _jax_cached(q, k, v, length, T, window=window)
    first = length - T
    kb, ke = DA.tile_keys(0, 8, T, first, 512, window)
    plan = DA.SplitPlan(8, 1, 16, 4)
    ranges = DA.split_ranges(kb, ke, plan.n_split, plan.granule)
    # row t = 7 attends keys (first + 7 - 60, first + 7]: the first split
    # lies wholly before that, and some splits are empty
    lo, hi = ranges[0]
    assert hi <= first + 7 - window + 1 and lo < hi
    assert any(hi <= lo for lo, hi in ranges)
    got = DA.split_attend(torch.as_tensor(q), torch.as_tensor(k),
                          torch.as_tensor(v), [length], plan, 512,
                          window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_row_with_no_attended_key_writes_zeros():
    """A query before position 0 (length < T) attends no key: the kernels
    write zeros there (the jnp oracle averages the masked row instead);
    the other rows equal the oracle."""
    q, k, v = _contiguous(5, 2, 2, 2, 3, 64, 32)
    lengths = np.asarray([2, 40], np.int32)
    want = _jax_cached(q, k, v, lengths, 3)
    got = _split(q, k, v, lengths, 132)
    assert not got[0, :, 0].any()
    np.testing.assert_allclose(got[0, :, 1:], want[0, :, 1:], atol=ATOL)
    np.testing.assert_allclose(got[1], want[1], atol=ATOL)


def _pools(rng, hkv, num_pages, P, D, int8):
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


PAGED = [
    dict(name="P16_T1", lengths=[300], hq=4, hkv=4, T=1, P=16, pages=20),
    dict(name="P128_L1024", lengths=[1024], hq=2, hkv=2, T=1, P=128,
         pages=9),
    dict(name="B8_spread_unassigned", lengths=[1, 700, 129, 1, 513, 900,
                                                257, 64],
         hq=2, hkv=2, T=1, P=64, pages=16),
    dict(name="gqa_32x8", lengths=[1024], hq=32, hkv=8, T=1, P=128, pages=9),
    dict(name="int8_window_alibi", lengths=[300, 45], hq=4, hkv=2, T=2,
         P=16, pages=20, int8=True, window=40, alibi=True),
    dict(name="softcap_P24", lengths=[200, 17], hq=2, hkv=2, T=1, P=24,
         pages=10, softcap=4.0),
]


@pytest.mark.parametrize("case", PAGED, ids=lambda c: c["name"])
def test_paged_split_reference_matches_jax(case):
    """The paged decode tiles' split-and-merge (whole pages a split, -1
    table entries past each sequence) equals the JAX package's paged jnp
    path."""
    rng = np.random.default_rng(len(case["name"]))
    lengths, P, pps = case["lengths"], case["P"], case["pages"]
    B, T, hq, hkv, D = len(lengths), case["T"], case["hq"], case["hkv"], 32
    num_pages = B * pps + 2
    k, v, ks, vs = _pools(rng, hkv, num_pages, P, D, case.get("int8"))
    table = np.full((B, pps), -1, np.int32)
    perm, used = rng.permutation(num_pages), 0
    for r, n in enumerate(lengths):
        live = -(-n // P)
        table[r, :live] = perm[used:used + live]
        used += live
    assert (table == -1).any()
    q = rng.normal(size=(B, hq, T, D)).astype(np.float32)
    kw = {n: case[n] for n in ("window", "softcap") if n in case}
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(hq)
    jlen = jnp.asarray(lengths, jnp.int32)
    want = np.asarray(JA.paged_cached_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
        P, 0, jlen, platform="cpu",
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), **kw))
    t = [None if a is None else torch.as_tensor(a)
         for a in (q, k, v, ks, vs, table)]
    got = PA.paged_decode_attention_split_reference(
        t[0], t[1], t[2], t[5], P, 0, torch.tensor(lengths, dtype=torch.int32),
        k_scale=t[3], v_scale=t[4], sms=132, **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("kb,ke,n,granule", [
    (0, 1, 16, 64), (0, 65, 2, 64), (0, 1024, 16, 64), (5, 65, 3, 64),
    (130, 1000, 7, 128), (440, 500, 8, 16), (0, 1024, 64, 16),
    (7, 7, 4, 64), (63, 64, 5, 64)])
def test_split_ranges_cover_each_key_once(kb, ke, n, granule):
    """Every key of [kb, ke) falls in exactly one split, no split reaches
    past ke or before kb, and split boundaries sit on granules."""
    ranges = DA.split_ranges(kb, ke, n, granule)
    assert len(ranges) == n
    seen = np.zeros(max(ke, 1), np.int64)
    for lo, hi in ranges:
        if hi <= lo:
            continue
        assert kb <= lo and hi <= ke
        assert lo == kb or lo % granule == 0
        seen[lo:hi] += 1
    assert (seen[kb:ke] == 1).all() and not seen[:kb].any()


@pytest.mark.parametrize("args,want", [
    # GPT-2 decode at L 1024: 16 splits of 64 keys (192 blocks)
    ((1, 12, 1, 1024), (1, 1, 16, 64)),
    # pages of 128: half pages, 16 splits
    ((1, 12, 1, 1024, None, 128), (1, 1, 16, 64)),
    # pages of 48: two whole pages a granule
    ((1, 12, 1, 960, None, 48), (1, 1, 10, 96)),
    # GQA 32 x 8: four rows a tile
    ((1, 8, 4, 1024), (4, 1, 16, 64)),
    # a wide batch needs fewer splits: 96 tiles, 3 splits
    ((8, 12, 1, 1024), (1, 1, 3, 64)),
    # a window bounds the splits by the keys a tile attends
    ((1, 12, 1, 1024, 128), (1, 1, 2, 64)),
    # pages of 16: granules of four pages
    ((1, 2, 1, 1024, None, 16), (1, 1, 16, 64)),
    # 12 rows: two tiles of 8
    ((1, 2, 12, 512), (8, 2, 8, 64)),
    # GQA 4:1 with T 4: 16 rows, two tiles of 8, 16 splits
    ((1, 8, 16, 1024), (8, 2, 16, 64)),
    # 64 rows: prefill tiles
    ((1, 12, 64, 1024), (0, 0, 1, 64)),
])
def test_split_plan(args, want):
    assert tuple(DA.split_plan(*args)) == want
    plan = DA.split_plan(*args)
    assert 1 <= plan.n_split <= DA.MAX_SPLITS


def test_split_plan_fills_the_card():
    """At decode the grid covers every SM at least once (or holds as many
    blocks as clusters of MAX_SPLITS allow) while each split keeps a
    granule of keys."""
    for batch, hkv, L in ((1, 12, 1024), (1, 8, 4096), (2, 4, 2048),
                          (8, 12, 1024)):
        plan = DA.split_plan(batch, hkv, 1, L, sm_count=132)
        assert (batch * hkv * plan.n_split
                >= min(132, batch * hkv * DA.MAX_SPLITS))
        assert plan.n_split * plan.granule <= L
