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
