"""The port's gated linear attention (SSD scan) against the JAX package's,
on the CPU: the chunked plain version against the JAX Pallas kernel in
interpret mode and its jnp twin, the sequential oracle and ``gla_full``'s
dispatch, ``SSMState.update_dense`` (outputs, state, checkpoint ring,
``nbytes``) and the ``ssm`` child of every KV cache variant.

Tolerances: the chunk algebra against the JAX package's, rtol = atol =
2e-5 (the JAX package's own kernel-vs-reference tolerance,
tests/test_ssm.py); the sequential forms, the same fp32 recurrence in the
same token order, 1e-6; chunked against sequential 2e-5 (exp of cumsums
of log-gates against products of gates)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.ops import ssm as jssm
from penroz_tpu.ops.pallas import ssm_scan as jscan
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops import ssm as tssm
from penroz_tpu_torch.ops.kernels import ssm_scan as tscan


def _inputs(B, T, H, dk, dv, seed=0, below_floor=False):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, dk)).astype(np.float32)
    k = rng.normal(size=(B, T, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, T, H, dv)).astype(np.float32)
    g = rng.uniform(0.05, 0.98, size=(B, T, H)).astype(np.float32)
    if below_floor:  # gates under the 1e-6 log floor: the chunked forms clamp
        g[rng.random(g.shape) < 0.2] = 1e-9
    return q, k, v, g


def _t(arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("below_floor", [False, True],
                         ids=["gates", "gates_below_floor"])
@pytest.mark.parametrize("T", [13, 16, 24])
def test_chunked_reference_matches_jax(T, below_floor):
    """The port's plain version == the JAX Pallas kernel (interpret mode)
    and its jnp twin, the padded tail of T 13 included."""
    arrays = _inputs(2, T, 3, 8, 4, seed=T, below_floor=below_floor)
    got = tscan.gla_chunked_reference(*_t(arrays), block_t=8).numpy()
    for want in (jscan.gla_chunked(*_j(arrays), block_t=8, interpret=True),
                 jscan.gla_chunked_reference(*_j(arrays), block_t=8)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_chunked_wrapper_on_cpu_runs_the_plain_version():
    arrays = _t(_inputs(1, 20, 2, 4, 4, seed=5))
    before = tscan.gla_chunked.launches
    out = tscan.gla_chunked(*arrays, block_t=8)
    assert tscan.gla_chunked.launches == before
    assert out.dtype == torch.float32 and out.shape == (1, 20, 2, 4)
    torch.testing.assert_close(out, tscan.gla_chunked_reference(
        *arrays, block_t=8), rtol=0, atol=0)
    # bf16 inputs are read as fp32; the output stays fp32
    q, k, v, g = arrays
    out16 = tscan.gla_chunked(q.bfloat16(), k.bfloat16(), v.bfloat16(), g,
                              block_t=8)
    ref16 = tscan.gla_chunked_reference(q.bfloat16().float(),
                                        k.bfloat16().float(),
                                        v.bfloat16().float(), g, block_t=8)
    assert out16.dtype == torch.float32
    torch.testing.assert_close(out16, ref16, rtol=0, atol=0)


@pytest.mark.parametrize("T,block_t", [(8, 8), (24, 8), (13, 8), (16, 16),
                                       (5, 128)])
def test_chunked_matches_sequential(T, block_t):
    arrays = _t(_inputs(2, T, 3, 4, 4, seed=T))
    torch.testing.assert_close(
        tscan.gla_chunked_reference(*arrays, block_t=block_t),
        tssm.gla_full_reference(*arrays), rtol=2e-5, atol=2e-5)


def test_sequential_oracle_and_dispatch_match_jax():
    """``gla_full_reference`` == JAX's; ``gla_full`` on the CPU runs it with
    and without ``training``, and its gradient equals JAX's."""
    arrays = _inputs(2, 11, 2, 4, 6, seed=9)
    want = np.asarray(jssm.gla_full_reference(*_j(arrays)))
    for training in (False, True):
        got = tssm.gla_full(*_t(arrays), training=training)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    q, k, v, g = _t(arrays)
    q.requires_grad_(True)
    tssm.gla_full(q, k, v, g, training=True).sum().backward()
    jq, jk, jv, jg = _j(arrays)
    jgrad = jax.grad(lambda x: jssm.gla_full(x, jk, jv, jg,
                                             training=True).sum())(jq)
    np.testing.assert_allclose(q.grad.numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)


def _same_state(tstate, jstate):
    assert tstate.specs == jstate.specs
    assert tstate.ckpt_slots == jstate.ckpt_slots
    np.testing.assert_array_equal(tstate.ckpt_pos.numpy(),
                                  np.asarray(jstate.ckpt_pos))
    for a, b in zip((*tstate.state, *tstate.ckpt),
                    (*jstate.state, *jstate.ckpt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)


def test_update_dense_two_chunks_match_full_recompute_and_jax():
    """The cached scan fed in two chunks == the uncached oracle; its state,
    checkpoint ring (10 tokens over 4 slots: wrapped) and ``nbytes`` equal
    the JAX state's after the same updates."""
    B, T, H, dk, dv, cut = 2, 10, 2, 4, 3, 6
    arrays = _inputs(B, T, H, dk, dv, seed=1)
    specs = [(H, dk, dv), (1, 2, 2)]
    tstate = tssm.SSMState.create(specs, B, ckpt_slots=4)
    jstate = jssm.SSMState.create(specs, B, ckpt_slots=4)
    assert tstate.nbytes() == jstate.nbytes()
    ys = []
    for lo, hi in ((0, cut), (cut, T)):
        part = [a[:, lo:hi] for a in arrays]
        ys.append(tstate.update_dense(0, *_t(part), start=lo))
        jstate.update_dense(0, *_j(part), start=lo)
    torch.testing.assert_close(torch.cat(ys, dim=1),
                               tssm.gla_full_reference(*_t(arrays)),
                               rtol=1e-5, atol=1e-5)
    _same_state(tstate, jstate)
    assert tstate.nbytes() == jstate.nbytes()


def test_reset_and_reset_row():
    B, H, dk, dv = 2, 1, 2, 2
    state = tssm.SSMState.create([(H, dk, dv)], B, ckpt_slots=2)
    state.update_dense(0, *_t(_inputs(B, 3, H, dk, dv)), start=0)
    assert bool((state.ckpt_pos >= 0).all())
    state.reset_row(1)
    assert bool((state.state[0][1] == 0).all())
    assert bool((state.ckpt[0][1] == 0).all())
    assert bool((state.ckpt_pos[1] == -1).all())
    assert bool((state.state[0][0] != 0).any())
    state.reset()
    assert not any(bool(t.any()) for t in (*state.state, *state.ckpt))
    assert bool((state.ckpt_pos == -1).all())


@pytest.mark.parametrize("env", [{}, {"TURBO_QUANT_KV_CACHE": "1"},
                                 {"PAGED_KV_CACHE": "1"},
                                 {"PAGED_KV_CACHE": "1",
                                  "TURBO_QUANT_KV_CACHE": "1"}],
                         ids=["contiguous", "int8", "paged", "int8_paged"])
@pytest.mark.parametrize("kv_specs", [[(2, 8)], []], ids=["hybrid", "pure"])
def test_kv_states_carry_the_ssm_child(monkeypatch, env, kv_specs):
    """``create_kv_state(..., ssm_specs=...)`` attaches the recurrent child
    to every variant (a pure-SSM model's cache has no K/V layers),
    ``memory_bytes`` counts its ``nbytes`` (K/V bytes as the JAX cache's)
    and ``reset`` empties it."""
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    ssm_specs = [(2, 4, 4)]
    t = TKV.create_kv_state(kv_specs, 1, 16, ssm_specs=ssm_specs)
    j = JKV.create_kv_state(kv_specs, 1, 16, ssm_specs=ssm_specs)
    assert type(t).__name__ == type(j).__name__
    assert len(t.k) == len(kv_specs)
    assert t.ssm.nbytes() == j.ssm.nbytes()
    assert t.memory_bytes() == j.memory_bytes() + j.ssm.nbytes()
    assert t.logical_bytes() == j.logical_bytes()
    t.ssm.update_dense(0, *_t(_inputs(1, 3, 2, 4, 4)), start=0)
    t.advanced(3)
    t.reset()
    assert t.length == 0 and not bool(t.ssm.state[0].any())
    assert bool((t.ssm.ckpt_pos == -1).all())
    assert TKV.create_kv_state(kv_specs, 1, 16).ssm is None


# -- the row contract and the scheduler's update forms -----------------------

def _seeded_pair(specs, B, C, seed=3):
    """A port state and a JAX state holding the same seeded rows (states,
    ring and keys)."""
    rng = np.random.default_rng(seed)
    t = tssm.SSMState.create(specs, B, ckpt_slots=C)
    state = [rng.normal(size=s.shape).astype(np.float32) for s in t.state]
    ckpt = [rng.normal(size=c.shape).astype(np.float32) for c in t.ckpt]
    pos = np.full((B, C), -1, np.int32)
    for b in range(B):   # lengths 5..5+C-1 in their slots, one slot empty
        for L in range(5, 5 + C - 1):
            pos[b, L % C] = L
    for dst, src in zip((*t.state, *t.ckpt), (*state, *ckpt)):
        dst.copy_(torch.from_numpy(src))
    t.ckpt_pos.copy_(torch.from_numpy(pos))
    j = jssm.SSMState([jnp.asarray(a) for a in state],
                      [jnp.asarray(a) for a in ckpt], jnp.asarray(pos),
                      specs, C)
    return t, j


SPECS = [(2, 4, 3), (1, 2, 2)]


@pytest.mark.parametrize("new_length", [0, 6, 8, 3, 11],
                         ids=["zero", "hit", "hit_last", "miss", "future"])
def test_rollback_row_matches_jax(new_length):
    """The ring rewind: zeros at 0, the checkpoint keyed ``new_length`` when
    a slot holds it, the state kept otherwise; later keys dropped."""
    t, j = _seeded_pair(SPECS, 3, 4)
    t.rollback_row(1, new_length)
    j = j.rollback_row(1, new_length)
    _same_state(t, j)


def test_row_view_merge_and_insert_match_jax():
    """``row_view`` writes through (its update lands in the row); a copied
    view merges back; ``insert_row`` copies a batch-1 state, ring
    included; ``reset_row`` zeroes one row: each as the JAX state."""
    t, j = _seeded_pair(SPECS, 3, 4)
    arrays = _inputs(1, 3, 2, 4, 3, seed=5)
    view = t.row_view(2, 9)
    view.update_dense(0, *_t(arrays), start=9)
    t.merge_row(2, view)
    jv = j.row_view(2, 9)
    jv.update_dense(0, *_j(arrays), start=9)
    j = j.merge_row(2, jv)
    _same_state(t, j)
    src_t, src_j = _seeded_pair(SPECS, 1, 4, seed=9)
    copy = tssm.SSMState([s.clone() for s in src_t.state],
                         [c.clone() for c in src_t.ckpt],
                         src_t.ckpt_pos.clone(), SPECS, 4)
    t.insert_row(0, copy)
    j = j.insert_row(0, src_j)
    _same_state(t, j)
    t.reset_row(1)
    j = j.reset_row(1)
    _same_state(t, j)
    with pytest.raises(ValueError, match="specs"):
        t.insert_row(0, tssm.SSMState.create([(1, 2, 2)], 1))


def test_export_import_rows_and_all_match_jax():
    """The hand-off blob: live states only (the importer's ring starts
    empty), as host tensors or device planes; the whole-batch pair too."""
    t, j = _seeded_pair(SPECS, 3, 4)
    blob = t.export_row_pages(1, length=7)
    jblob = j.export_row_pages(1, 7)
    assert blob["specs"] == jblob["specs"]
    for a, b in zip(blob["state"], jblob["state"]):
        np.testing.assert_array_equal(a.numpy(), b)
    dev = t.export_row(2, device=True)
    assert all(p.device == t.device for p in dev["state"])
    t.import_row_pages(0, blob)
    j = j.import_row_pages(0, jblob)
    _same_state(t, j)
    whole, jwhole = t.export_all(), j.export_all()
    t2, j2 = _seeded_pair(SPECS, 3, 4, seed=11)
    t2.import_all(whole)
    j2 = j2.import_all(jwhole)
    _same_state(t2, j2)


def test_update_dense_per_row_start_matches_jax():
    """A (B,) start: each row checkpoints at its own lengths."""
    B, T, H, dk, dv = 3, 5, 2, 4, 3
    arrays = _inputs(B, T, H, dk, dv, seed=4)
    t, j = _seeded_pair([(H, dk, dv)], B, 4)
    start = np.array([0, 7, 12], np.int64)
    y = t.update_dense(0, *_t(arrays), start=torch.from_numpy(start))
    jy = j.update_dense(0, *_j(arrays), start=jnp.asarray(start))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    _same_state(t, j)


def test_update_dense_counts_leave_padding_out():
    """``count[b]`` tokens of row b: its state and ring equal a batch-1
    update of those tokens alone, y is 0 past them, and a row of count 0
    is untouched."""
    B, T, H, dk, dv = 3, 6, 2, 4, 3
    arrays = _inputs(B, T, H, dk, dv, seed=6)
    t, _ = _seeded_pair([(H, dk, dv)], B, 4)
    before = [s.clone() for s in (*t.state, *t.ckpt, t.ckpt_pos)]
    counts = torch.tensor([6, 2, 0])
    y = t.update_dense(0, *_t(arrays), start=torch.tensor([3, 4, 5]),
                       count=counts)
    for b in range(B):
        n = int(counts[b])
        alone = tssm.SSMState([before[0][b:b + 1].clone()],
                              [before[1][b:b + 1].clone()],
                              before[2][b:b + 1].clone(), [(H, dk, dv)], 4)
        ya = alone.update_dense(0, *_t([a[b:b + 1, :n] for a in arrays]),
                                start=3 + b) if n else None
        if n:
            torch.testing.assert_close(y[b:b + 1, :n], ya, rtol=0, atol=0)
        assert not bool(y[b, n:].any())
        torch.testing.assert_close(t.state[0][b], alone.state[0][0])
        torch.testing.assert_close(t.ckpt[0][b], alone.ckpt[0][0])
        torch.testing.assert_close(t.ckpt_pos[b], alone.ckpt_pos[0])


def test_update_packed_matches_jax():
    """The packed scan over a layout with a row spanning two blocks, a
    partly valid block, a padding block and a decode step, against JAX's
    (y compared at the valid slots: the port leaves 0 at a dropped one,
    the JAX scan computes it and drops its write)."""
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    H, dk, dv, block_q = 2, 4, 3, 4
    spans = [(1, 5, 6), (0, 9, 1), (2, 0, 3)]  # row 1 over two blocks
    descs, _ = build_descriptors(spans, block_q, 5)  # block 4: padding
    Tp = 5 * block_q
    arrays = _inputs(1, Tp, H, dk, dv, seed=7)
    t, j = _seeded_pair([(H, dk, dv), (1, 2, 2)], 3, 4)
    y = t.update_packed(0, *_t(arrays), torch.from_numpy(descs), block_q)
    jy = j.update_packed(0, *_j(arrays), jnp.asarray(descs), block_q)
    valid = np.zeros(Tp, bool)
    for blk, (row, _, n, _) in enumerate(descs):
        if row >= 0:
            valid[blk * block_q:blk * block_q + n] = True
    np.testing.assert_allclose(y.numpy()[0, valid], np.asarray(jy)[0, valid],
                               rtol=1e-5, atol=1e-5)
    assert not bool(y[0, torch.from_numpy(~valid)].any())
    _same_state(t, j)


def test_packed_equals_dense_bit_for_bit():
    """A row's prompt cut into packed chunks leaves the same state bits as
    one dense update (the same arithmetic a token)."""
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    H, dk, dv, T = 2, 4, 3, 11
    arrays = _inputs(1, T, H, dk, dv, seed=8)
    dense = tssm.SSMState.create([(H, dk, dv)], 1, ckpt_slots=4)
    y_dense = dense.update_dense(0, *_t(arrays), start=0)
    packed = tssm.SSMState.create([(H, dk, dv)], 2, ckpt_slots=4)
    ys = []
    for lo, hi in ((0, 5), (5, T)):
        descs, _ = build_descriptors([(1, lo, hi - lo)], 4, 2)
        part = [np.zeros((1, 8) + a.shape[2:], np.float32) for a in arrays]
        for p, a in zip(part, arrays):
            p[0, :hi - lo] = a[0, lo:hi]
        y = packed.update_packed(0, *_t(part), torch.from_numpy(descs), 4)
        ys.append(y[:, :hi - lo])
    torch.testing.assert_close(torch.cat(ys, 1), y_dense, rtol=0, atol=0)
    torch.testing.assert_close(packed.state[0][1], dense.state[0][0],
                               rtol=0, atol=0)
    torch.testing.assert_close(packed.ckpt[0][1], dense.ckpt[0][0],
                               rtol=0, atol=0)


def test_ring_after_a_256_slot_span_matches_jax():
    """A 256-token packed span over 8 ring slots: the ring holds the last
    8 positions' states, as the JAX scan leaves it."""
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    H, dk, dv = 1, 4, 2
    descs, _ = build_descriptors([(0, 3, 256)], 64, 4)
    arrays = _inputs(1, 256, H, dk, dv, seed=12)
    t = tssm.SSMState.create([(H, dk, dv)], 2, ckpt_slots=8)
    j = jssm.SSMState.create([(H, dk, dv)], 2, ckpt_slots=8)
    y = t.update_packed(0, *_t(arrays), torch.from_numpy(descs), 64)
    jy = j.update_packed(0, *_j(arrays), jnp.asarray(descs), 64)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)
    assert sorted(t.ckpt_pos[0].tolist()) == list(range(252, 260))
    _same_state(t, j)
