"""Per-row KV state of the port's four caches (contiguous and paged, fp32
and int8) against the JAX package's on the same seeded data: ragged
per-row appends after ``with_lengths``, a prefill chunk through
``row_view``/``merge_row``, ``rollback_row`` and ``reset_row``, and a
pipeline stage's ``stage_kv_view``/``merge_stage_kv`` — the same arrays,
exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu_torch.ops import kv_cache as TKV

SPECS = [(2, 8), (2, 8), (2, 8)]
BATCH, MAX_LEN, PAGE = 3, 16, 4
LENGTHS = [3, 0, 12]
VARIANTS = {
    "fp32": (JKV.KVState, TKV.KVState, {}),
    "int8": (JKV.QuantKVState, TKV.QuantKVState, {}),
    "paged_fp32": (JKV.PagedKVState, TKV.PagedKVState, {"page_size": PAGE}),
    "paged_int8": (JKV.QuantPagedKVState, TKV.QuantPagedKVState,
                   {"page_size": PAGE}),
}


def _planes(kv):
    names = ("k", "v", "k_scale", "v_scale") if kv.quantized else ("k", "v")
    return {name: [np.asarray(a) for a in getattr(kv, name)]
            for name in names}


def _assert_same(jkv, tkv):
    jp, tp = _planes(jkv), _planes(tkv)
    assert jp.keys() == tp.keys()
    for name in jp:
        for ja, ta in zip(jp[name], tp[name]):
            np.testing.assert_array_equal(ta, ja, err_msg=name)
    np.testing.assert_array_equal(np.asarray(tkv.length),
                                  np.asarray(jkv.length))


def _new(rng, batch, T):
    return [(rng.standard_normal((batch, h, T, d)).astype(np.float32),
             rng.standard_normal((batch, h, T, d)).astype(np.float32))
            for h, d in SPECS]


def _append(kv, layer, k, v, jax_side):
    conv = jnp.asarray if jax_side else torch.from_numpy
    if isinstance(kv, (JKV.PagedKVState, TKV.PagedKVState)):
        return kv.append_rows(layer, conv(k), conv(v))
    if kv.quantized:
        return kv.append_raw(layer, conv(k), conv(v))
    return kv.append(layer, conv(k), conv(v))


def _pair(variant):
    jcls, tcls, kw = VARIANTS[variant]
    jkv = jcls.create(SPECS, BATCH, MAX_LEN, **kw).with_static_table()
    tkv = tcls.create(SPECS, BATCH, MAX_LEN, device="cpu",
                      **kw).with_static_table()
    return jkv.with_lengths(LENGTHS), tkv.with_lengths(LENGTHS)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_row_ops_match_jax(variant):
    rng = np.random.default_rng(0)
    jkv, tkv = _pair(variant)
    # a ragged step: every row appends 2 tokens at its own length
    for layer, (k, v) in enumerate(_new(rng, BATCH, 2)):
        _append(jkv, layer, k, v, True)
        _append(tkv, layer, k, v, False)
    jkv, tkv = jkv.advanced(2), tkv.advanced(2)
    _assert_same(jkv, tkv)
    # a prefill chunk of row 1 at length 2 through its batch-1 view
    jview, tview = jkv.row_view(1, 2), tkv.row_view(1, 2)
    assert int(np.asarray(tview.length)) == int(np.asarray(jview.length))
    for layer, (k, v) in enumerate(_new(rng, 1, 3)):
        _append(jview, layer, k, v, True)
        _append(tview, layer, k, v, False)
    jkv, tkv = jkv.merge_row(1, jview), tkv.merge_row(1, tview)
    _assert_same(jkv, tkv)
    # the speculative rollback and a retired row
    jkv, tkv = jkv.rollback_row(2, 13), tkv.rollback_row(2, 13)
    _assert_same(jkv, tkv)
    jkv, tkv = jkv.reset_row(0), tkv.reset_row(0)
    _assert_same(jkv, tkv)
    with pytest.raises(ValueError, match="with_lengths"):
        TKV.create_kv_state(SPECS, BATCH, MAX_LEN, paged=False,
                            quantized=False).rollback_row(0, 1)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_row_view_aliases_the_rows(variant):
    """A row view writes the row in place: its tensors are the parent's
    storage (contiguous) or the very pools (paged); ``merge_row`` then
    copies nothing."""
    _, tkv = _pair(variant)
    view = tkv.row_view(2, 5)
    for mine, theirs in zip(tkv.k, view.k):
        if isinstance(tkv, TKV.PagedKVState):
            assert theirs is mine
        else:
            assert theirs.data_ptr() == mine[2:3].data_ptr()


@pytest.mark.parametrize("variant", ["paged_fp32", "paged_int8"])
def test_stage_views_match_jax(variant):
    """A stage's view holds layers [1, 3) of the same pools (no copy) and
    shares the table and lengths; a packed append through it, folded back
    with ``merge_stage_kv``, gives JAX's arrays."""
    rng = np.random.default_rng(1)
    jkv, tkv = _pair(variant)
    jview, tview = JKV.stage_kv_view(jkv, 1, 3), TKV.stage_kv_view(tkv, 1, 3)
    assert [t is p for t, p in zip(tview.k, tkv.k[1:3])] == [True, True]
    assert tview.block_table is tkv.block_table
    assert tview.ragged_lengths is tkv.ragged_lengths
    descs, _ = TKV.build_descriptors([(0, 3, 2), (2, 12, 3)], 4, 2)
    jrows, trows = jview.packed_rows(descs, 4), tview.packed_rows(descs, 4)
    np.testing.assert_array_equal(trows, np.asarray(jrows))
    for layer in range(2):
        k = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
        v = rng.standard_normal((1, 2, 8, 8)).astype(np.float32)
        jview.append_packed(layer, jnp.asarray(k), jnp.asarray(v), jrows)
        tview.append_packed(layer, torch.from_numpy(k), torch.from_numpy(v),
                            trows)
    jkv = JKV.merge_stage_kv(jkv, 1, 3, jview)
    tkv = TKV.merge_stage_kv(tkv, 1, 3, tview)
    _assert_same(jkv, tkv)
    assert TKV.stage_pool_bytes(tkv, 0, 1) + TKV.stage_pool_bytes(
        tkv, 1, 3) == sum(tkv.hbm_components()[c]
                          for c in ("kv_values", "kv_scales"))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_insert_row_with_the_ssm_child_matches_jax(variant):
    """``insert_row`` of a prefilled batch-1 cache (its buffers, scales and
    recurrent child), then ``rollback_row``, ``row_view``/``merge_row`` and
    ``reset_row`` on a cache with an ``ssm`` child: the same K/V planes,
    lengths and recurrent states as the JAX package's."""
    from penroz_tpu.ops import ssm as jssm
    from penroz_tpu_torch.ops import ssm as tssm
    jcls, tcls, kw = VARIANTS[variant]
    ssm_specs = [(2, 4, 4)]
    rng = np.random.default_rng(5)
    jkv, tkv = _pair(variant)
    jkv.ssm = jssm.SSMState.create(ssm_specs, BATCH, ckpt_slots=4)
    tkv.ssm = tssm.SSMState.create(ssm_specs, BATCH, ckpt_slots=4)
    jsrc = jcls.create(SPECS, 1, MAX_LEN, **kw).with_static_table()
    tsrc = tcls.create(SPECS, 1, MAX_LEN, device="cpu",
                       **kw).with_static_table()
    jsrc.ssm = jssm.SSMState.create(ssm_specs, 1, ckpt_slots=4)
    tsrc.ssm = tssm.SSMState.create(ssm_specs, 1, ckpt_slots=4)
    for layer, (k, v) in enumerate(_new(rng, 1, 5)):
        _append(jsrc, layer, k, v, True)
        _append(tsrc, layer, k, v, False)
    jsrc, tsrc = jsrc.advanced(5), tsrc.advanced(5)
    q, k, v = (rng.standard_normal((1, 5, 2, 4)).astype(np.float32)
               for _ in range(3))
    g = rng.uniform(0.1, 0.9, (1, 5, 2)).astype(np.float32)
    jsrc.ssm.update_dense(0, *(jnp.asarray(a) for a in (q, k, v, g)), 0)
    tsrc.ssm.update_dense(0, *(torch.from_numpy(a) for a in (q, k, v, g)),
                          0)
    jkv = jkv.insert_row(1, jsrc)
    tkv = tkv.insert_row(1, tsrc)
    _assert_same(jkv, tkv)

    def same_ssm():
        for a, b in zip((*tkv.ssm.state, *tkv.ssm.ckpt, tkv.ssm.ckpt_pos),
                        (*jkv.ssm.state, *jkv.ssm.ckpt, jkv.ssm.ckpt_pos)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)

    same_ssm()
    jkv, tkv = jkv.rollback_row(1, 3), tkv.rollback_row(1, 3)
    _assert_same(jkv, tkv)
    same_ssm()
    jview, tview = jkv.row_view(1, 3), tkv.row_view(1, 3)
    q, k, v = (rng.standard_normal((1, 2, 2, 4)).astype(np.float32)
               for _ in range(3))
    g = rng.uniform(0.1, 0.9, (1, 2, 2)).astype(np.float32)
    jview.ssm.update_dense(0, *(jnp.asarray(a) for a in (q, k, v, g)), 3)
    tview.ssm.update_dense(0, *(torch.from_numpy(a) for a in (q, k, v, g)),
                           3)
    jkv, tkv = jkv.merge_row(1, jview), tkv.merge_row(1, tview)
    same_ssm()
    jkv, tkv = jkv.reset_row(1), tkv.reset_row(1)
    _assert_same(jkv, tkv)
    same_ssm()
