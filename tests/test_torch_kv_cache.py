"""The port's contiguous KV caches against the JAX package's: int8
quantization bit for bit, and the buffers after several appends."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu_torch.ops import kv_cache as TKV


def _jax_view(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_bit_exact(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 9, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                       # amax 0 -> scale 1
    x[0, 0, 1] = np.arange(16) - 7.5       # exact .5 quotients
    x[1, 2, 3, :] = 127.0 * np.linspace(-1, 1, 16)
    jx = jnp.asarray(x).astype(dtype)
    tx = (torch.as_tensor(x).to(torch.bfloat16) if dtype == "bfloat16"
          else torch.as_tensor(x))
    jq, js = JKV._quantize_int8(jx)
    tq, ts = TKV._quantize_int8(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        _jax_view(TKV._dequantize_int8(tq, ts, tx.dtype)),
        np.asarray(JKV._dequantize_int8(jq, js, jx.dtype)))


def test_quant_state_append_raw_matches_jax():
    rng = np.random.default_rng(1)
    specs = [(2, 8), (2, 8)]
    jstate = JKV.QuantKVState.create(specs, 1, 12, jnp.float32)
    tstate = TKV.QuantKVState.create(specs, 1, 12, torch.float32)
    for T in (3, 1, 2, 1):
        for layer in range(2):
            k = rng.normal(size=(1, 2, T, 8)).astype(np.float32)
            v = rng.normal(size=(1, 2, T, 8)).astype(np.float32)
            jk, jv, jlen = jstate.append_raw(layer, jnp.asarray(k),
                                             jnp.asarray(v))
            tk, tv, tlen = tstate.append_raw(layer, torch.as_tensor(k),
                                             torch.as_tensor(v))
            assert int(jlen) == tlen
        jstate = jstate.advanced(T)
        assert tstate.advanced(T) is tstate
        assert int(jstate.length) == tstate.length
    for layer in range(2):
        for jbuf, tbuf in ((jstate.k, tstate.k), (jstate.v, tstate.v),
                           (jstate.k_scale, tstate.k_scale),
                           (jstate.v_scale, tstate.v_scale)):
            np.testing.assert_array_equal(tbuf[layer].numpy(),
                                          np.asarray(jbuf[layer]))
    assert tstate.memory_bytes() == jstate.memory_bytes()
    assert tstate.logical_bytes() == jstate.logical_bytes()
    # append = append_raw + dequantize (the raw path's oracle)
    k_full, _, _ = tstate.append(0, torch.ones(1, 2, 1, 8),
                                 torch.ones(1, 2, 1, 8))
    assert torch.equal(k_full, TKV._dequantize_int8(
        tstate.k[0], tstate.k_scale[0], torch.float32))


def test_kv_state_append_reset_and_bytes_match_jax():
    rng = np.random.default_rng(2)
    jstate = JKV.KVState.create([(2, 4)], 2, 6, jnp.float32)
    tstate = TKV.KVState.create([(2, 4)], 2, 6, torch.float32)
    for T in (2, 3):
        k = rng.normal(size=(2, 2, T, 4)).astype(np.float32)
        jk, _, jlen = jstate.append(0, jnp.asarray(k), jnp.asarray(k + 1))
        tk, tv, tlen = tstate.append(0, torch.as_tensor(k),
                                     torch.as_tensor(k + 1))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        assert int(jlen) == tlen
        jstate, tstate = jstate.advanced(T), tstate.advanced(T)
    assert tstate.length == int(jstate.length) == 5
    assert tstate.memory_bytes() == jstate.memory_bytes()
    assert tstate.logical_bytes() == jstate.logical_bytes()
    with pytest.raises(ValueError, match="capacity"):
        tstate.append(0, torch.zeros(2, 2, 2, 4), torch.zeros(2, 2, 2, 4))
    assert tstate.reset().length == 0


def test_create_kv_state_honours_env(monkeypatch):
    monkeypatch.delenv(TKV.TURBO_QUANT_ENV, raising=False)
    monkeypatch.delenv(TKV.PAGED_ENV, raising=False)
    assert type(TKV.create_kv_state([(1, 8)], 1, 4)) is TKV.KVState
    monkeypatch.setenv(TKV.TURBO_QUANT_ENV, "1")
    state = TKV.create_kv_state([(1, 8)], 1, 4)
    assert isinstance(state, TKV.QuantKVState) and state.quantized
    assert state.k[0].dtype == torch.int8
    monkeypatch.setenv(TKV.PAGED_ENV, "1")
    state = TKV.create_kv_state([(1, 8)], 1, 4)
    assert type(state) is TKV.QuantPagedKVState
    monkeypatch.setenv(TKV.TURBO_QUANT_ENV, "0")
    assert type(TKV.create_kv_state([(1, 8)], 1, 4)) is TKV.PagedKVState
