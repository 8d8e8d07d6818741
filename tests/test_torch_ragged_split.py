"""The ragged kernel's split-K algorithm on the CPU.

The CUDA ragged kernel (csrc/ragged_paged_attention.cu on csrc/decode_core.cuh)
treats each descriptor ``(row, q_pos0, q_valid, kv_len)`` as a sequence of the
decode core: its key range runs from the window start of its first real slot to
``q_pos0 + q_valid``, is cut into the splits of ``ragged_split_plan`` (sized
from the pool's span, since the descriptors stay on the device) by
``split_ranges``, and the splits merge in split order.  The kernel runs only on
the card; its algorithm runs here as
``ragged_paged_attention_split_reference``, held to the JAX package's Pallas
``ragged_paged_attention`` in interpret mode and to the port's plain version
from numpy seeds, fp32, at atol 1e-5 (all sum in fp32, in different orders)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops.pallas import ragged_paged_attention as JRPA
from penroz_tpu_torch.ops import attention as TA
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops.kernels import decode_attention as DA
from penroz_tpu_torch.ops.kernels import ragged_paged_attention as TRPA
from penroz_tpu_torch.utils import bucketing

ATOL = 1e-5
SMS = 132


def _inputs(seed, spans, BQ, hq, hkv, D, P, pages, int8=False, padding=0):
    """Pools with each row's live pages on shuffled physical pages (-1 past
    them), descriptors of ``spans`` ((q_start, q_len) per row) padded to a
    power of two, and packed queries."""
    rng = np.random.default_rng(seed)
    num_pages = len(spans) * pages + 2
    shape = (hkv, num_pages * P, D)
    if int8:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.02, shape[:2] + (1,)).astype(np.float32)
        vs = rng.uniform(0.005, 0.02, shape[:2] + (1,)).astype(np.float32)
    else:
        k = rng.normal(size=shape).astype(np.float32)
        v = rng.normal(size=shape).astype(np.float32)
        ks = vs = None
    table = np.full((len(spans), pages), -1, np.int32)
    perm, used = rng.permutation(num_pages), 0
    for r, (q0, n) in enumerate(spans):
        live = -(-(q0 + n) // P)
        table[r, :live] = perm[used:used + live]
        used += live
    need = sum(-(-n // BQ) for _, n in spans)
    NB = bucketing.bucket_count(need + padding)
    descs, offsets = TKV.build_descriptors(
        [(r, q0, n) for r, (q0, n) in enumerate(spans)], BQ, NB)
    q = rng.normal(size=(1, hq, NB * BQ, D)).astype(np.float32)
    return q, k, v, ks, vs, table, descs, offsets


CASES = [
    # decode rows from 1 key to the pool's span (256) and a 13-token chunk
    # whose second block has q_valid 5 < block_q; 4 splits of 64 keys (few
    # descriptors: the splits fill the card)
    dict(name="lengths_1_to_span", spans=[(0, 1), (16, 1), (63, 1), (64, 1),
                                          (199, 1), (255, 1), (40, 13)],
         BQ=8, hq=2, hkv=2, D=32, P=16, pages=16, splits=4),
    # 64 descriptors fill the card: splits of 4 granules (256 keys), so a
    # range of up to 256 keys is one split and the longest runs four
    dict(name="many_descriptors_walk_granules",
         spans=[(0, 200)] + [(n - 1, 1) for n in (1, 255, 257, 600, 1000,
                                                  1024)],
         BQ=8, hq=4, hkv=4, D=16, P=128, pages=8, padding=30, splits=4,
         granule=256),
    dict(name="padding_descriptors", spans=[(99, 1), (9, 3)], BQ=8, hq=4,
         hkv=4, D=32, P=16, pages=8, padding=10),
    # G 4 and block_q 3: 8-row tiles hold slots of three query heads
    dict(name="gqa_tiles_wrap_heads", spans=[(30, 1), (5, 3), (70, 2)],
         BQ=3, hq=8, hkv=2, D=32, P=8, pages=16),
    # 48 rows, a 50-key window: splits of 64 keys and more, wider than it
    dict(name="window_narrower_than_split", spans=[(200, 8), (150, 1),
                                                   (10, 5)],
         BQ=8, hq=12, hkv=2, D=16, P=16, pages=16, window=50, splits=2),
    dict(name="alibi_softcap_scale", spans=[(90, 30), (200, 1)], BQ=8, hq=4,
         hkv=2, D=32, P=16, pages=16, alibi=True, softcap=6.0, scale=0.2),
    # more splits (16) than head dims (8), GQA 4:1, two 8-row tiles
    dict(name="D8_gqa_16_splits", spans=[(1021, 3)], BQ=4, hq=32, hkv=8,
         D=8, P=64, pages=16, splits=16),
    dict(name="int8_scales", spans=[(40, 20), (150, 1), (7, 1)], BQ=8, hq=4,
         hkv=2, D=32, P=16, pages=12, int8=True),
    dict(name="int8_window_alibi", spans=[(40, 20), (150, 1)], BQ=4, hq=4,
         hkv=4, D=32, P=16, pages=12, int8=True, window=30, alibi=True),
    # 64 rows and more: prefill tiles (no split)
    dict(name="prefill_block_q_64", spans=[(30, 100), (150, 1)], BQ=64,
         hq=2, hkv=2, D=32, P=16, pages=12, splits=1),
    dict(name="prefill_gqa_block_q_32_wraps", spans=[(30, 40), (150, 1)],
         BQ=32, hq=4, hkv=2, D=32, P=16, pages=12, splits=1),
]


def _kwargs(case):
    kw = {n: case[n] for n in ("window", "softcap", "scale") if n in case}
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(case["hq"])
    return kw


@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_ragged_split_reference_matches_jax_and_plain(case):
    """The split-and-merge of the ragged kernel equals the Pallas kernel
    (interpret mode) and the port's plain version; padding slots are
    exactly zero in all three."""
    q, k, v, ks, vs, table, descs, offsets = _inputs(
        len(case["name"]), case["spans"], case["BQ"], case["hq"],
        case["hkv"], case["D"], case["P"], case["pages"], case.get("int8"),
        case.get("padding", 0))
    NB = descs.shape[0]
    kw = _kwargs(case)
    plan = TRPA.ragged_plan(NB, case["BQ"], case["hq"], case["hkv"],
                            case["pages"], case["P"], kw.get("window"), SMS)
    if "splits" in case:
        assert plan.n_split == case["splits"], plan
    if "granule" in case:
        assert plan.granule == case["granule"], plan
    t = [None if a is None else torch.as_tensor(a)
         for a in (q, k, v, ks, vs, table, descs)]
    got = TRPA.ragged_paged_attention_split_reference(
        t[0], t[1], t[2], t[5], case["P"], t[6], k_scale=t[3],
        v_scale=t[4], sms=SMS, **kw).numpy()
    want = np.asarray(JRPA.ragged_paged_attention(
        *(None if a is None else jnp.asarray(a)
          for a in (q, k, v, table)), case["P"], jnp.asarray(descs),
        k_scale=None if ks is None else jnp.asarray(ks),
        v_scale=None if vs is None else jnp.asarray(vs), interpret=True,
        **kw))
    plain = TRPA.ragged_paged_attention_reference(
        t[0], t[1], t[2], t[5], case["P"], t[6], k_scale=t[3], v_scale=t[4],
        **kw).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, plain, atol=ATOL)
    real = np.zeros(NB * case["BQ"], bool)
    for (_, n), off in zip(case["spans"], offsets):
        real[TKV.packed_slots(off, n, case["BQ"])] = True
    assert (~real).any()
    assert not got[0][:, ~real].any()


def test_all_padding_descriptors_write_zeros():
    """A call whose every descriptor is padding (row -1) writes zeros."""
    q, k, v, _, _, table, _, _ = _inputs(1, [(5, 3)], 8, 4, 2, 32, 16, 4)
    descs = np.zeros((q.shape[2] // 8, 4), np.int32)
    descs[:, 0] = -1
    got = TRPA.ragged_paged_attention_split_reference(
        *(torch.as_tensor(a) for a in (q, k, v, table)), 16,
        torch.as_tensor(descs), sms=SMS)
    assert got.shape == q.shape and not got.any()


@pytest.mark.parametrize("args,want", [
    # the GPT-2 mixed step (64 descriptors, 12 heads, block_q 8, pages of
    # 128, 1024 keys): splits of 4 granules, 4 for the longest range
    ((64, 12, 8, 1024, None, 128), (8, 1, 4, 256)),
    # one descriptor: as many 64-key splits as fill the card
    ((1, 12, 8, 1024, None, 128), (8, 1, 16, 64)),
    # a 128-key window bounds the range a tile attends: one split
    ((64, 12, 8, 1024, 128, 128), (8, 1, 1, 256)),
    # GQA 32 x 8 at block_q 8: four 8-row tiles a kv head
    ((16, 8, 32, 1024, None, 128), (8, 4, 4, 256)),
    # a short pool: one split walks it all
    ((64, 12, 8, 256, None, 16), (8, 1, 1, 256)),
    # pages of 48: granules of two pages; 8192 keys: the 16-split cap
    ((64, 12, 8, 4032, None, 48), (8, 1, 11, 384)),
    ((64, 2, 8, 8192, None, 64), (8, 1, 16, 256)),
    # block_q 128: prefill tiles
    ((8, 12, 128, 1024, None, 128), (0, 0, 1, 64)),
])
def test_ragged_split_plan(args, want):
    assert tuple(DA.ragged_split_plan(*args)) == want


@pytest.mark.parametrize("max_len,granule", [(1024, 64), (4032, 96),
                                             (300, 64), (64, 64)])
def test_ragged_plan_bounds_the_longest_walk(max_len, granule):
    """However few descriptors a call has, no split of the longest range a
    pool holds walks more than RAGGED_WALK granules (below the 16-split
    cap), and a range of up to RAGGED_WALK granules is one split when
    the card is full."""
    page = 48 if granule == 96 else 64
    for nb in (1, 8, 64, 512):
        plan = DA.ragged_split_plan(nb, 12, 8, max_len, None, page)
        widest = max(hi - lo for lo, hi in DA.split_ranges(
            0, max_len, plan.n_split, plan.granule))
        assert widest <= DA.RAGGED_WALK * granule
        assert 1 <= plan.n_split <= DA.MAX_SPLITS
        short = DA.split_ranges(0, DA.RAGGED_WALK * granule, plan.n_split,
                                plan.granule)
        if plan.granule > granule:
            assert sum(hi > lo for lo, hi in short) == 1


@pytest.mark.parametrize("m0,mv,T,first,valid,window,want", [
    (0, 8, 8, 100, 1, None, (0, 101)),      # a decode descriptor
    (8, 8, 8, 100, 1, None, (0, 101)),      # the next query head's slot 0
    (0, 8, 8, 0, 0, None, (0, 0)),          # padding (row -1)
    (0, 8, 3, 30, 2, None, (0, 32)),        # wraps heads: slots 0-1 real
    (4, 4, 8, 200, 5, 50, (155, 205)),      # slots 4-4 real in a window
    (4, 4, 8, 200, 4, 50, (0, 0)),          # slots 4-7, none real
])
def test_ragged_tile_keys(m0, mv, T, first, valid, window, want):
    assert DA.tile_keys(m0, mv, T, first, 10 ** 6, window, valid) == want
