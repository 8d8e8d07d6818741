"""The port's attention math against the JAX package's: the plain cached
attention against the jnp oracle AND the Pallas decode kernel (interpret
mode), and RoPE.  Inputs come from a numpy seed and go through both.

Tolerances: atol 2e-5 for fp32 caches and 3e-5 for int8 caches (the Pallas
kernel tests' own, tests/test_attention.py), 1e-6 for RoPE."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import attention as JA
from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.ops.pallas import decode_attention as JDA
from penroz_tpu_torch.ops import attention as TA

B, HQ, HKV, D, S = 2, 4, 2, 64, 256


def _cache(seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    v = rng.normal(size=(B, HKV, S, D)).astype(np.float32)
    return rng, k, v


def _both(q, k, v, offset, length, **kw):
    """(port plain, JAX jnp oracle, JAX Pallas interpret) outputs."""
    t_len = (torch.as_tensor(length) if isinstance(length, np.ndarray)
             else length)
    t_kw = {n: (torch.as_tensor(np.array(a)) if n.endswith("_scale")
                else a) for n, a in kw.items()}
    port = TA.cached_attention(torch.as_tensor(q), torch.as_tensor(k),
                               torch.as_tensor(v), offset, t_len, **t_kw)
    j_args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
              jnp.asarray(offset, jnp.int32), jnp.asarray(length, jnp.int32))
    oracle = JA.cached_attention(*j_args, platform="cpu", **kw)
    kernel = JDA.decode_attention(*j_args, block_k=128, interpret=True, **kw)
    return port.numpy(), np.asarray(oracle), np.asarray(kernel)


@pytest.mark.parametrize("offset,T", [(0, 8), (5, 1), (100, 4), (255, 1),
                                      (0, 1)])
def test_cached_attention_matches_jax_grid(offset, T):
    rng, k, v = _cache(2)
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    port, oracle, kernel = _both(q, k, v, offset, offset + T)
    np.testing.assert_allclose(port, oracle, atol=2e-5)
    np.testing.assert_allclose(port, kernel, atol=2e-5)


def test_cached_attention_per_row_lengths():
    rng, k, v = _cache(5)
    T = 2
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    lengths = np.asarray([37, 201], np.int32)
    port, oracle, kernel = _both(q, k, v, 0, lengths)
    np.testing.assert_allclose(port, oracle, atol=2e-5)
    np.testing.assert_allclose(port, kernel, atol=2e-5)


@pytest.mark.parametrize("feature", [
    {"window": 3}, {"window": 70}, {"alibi": "slopes"}, {"softcap": 5.0},
    {"scale": 0.3}, {"window": 16, "alibi": "slopes", "softcap": 2.0}],
    ids=["window3", "window70", "alibi", "softcap", "scale", "combined"])
def test_cached_attention_features(feature):
    rng, k, v = _cache(7)
    T, offset = 4, 100
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    kw = dict(feature)
    if "alibi" in kw:
        kw["alibi"] = JA.alibi_slopes(HQ)
        np.testing.assert_array_equal(TA.alibi_slopes(HQ), kw["alibi"])
    port, oracle, kernel = _both(q, k, v, offset, offset + T, **kw)
    np.testing.assert_allclose(port, oracle, atol=2e-5)
    np.testing.assert_allclose(port, kernel, atol=2e-5)


@pytest.mark.parametrize("offset,T", [(199, 1), (100, 4), (0, 8)])
def test_cached_attention_int8_cache(offset, T):
    rng = np.random.default_rng(11)
    state = JKV.QuantKVState.create([(HKV, D)], B, S, jnp.float32)
    seeded = jnp.asarray(rng.normal(size=(B, HKV, 200, D)).astype(np.float32))
    qk, qv, _ = state.append_raw(0, seeded, seeded * 0.5 + 1.0)
    q = rng.normal(size=(B, HQ, T, D)).astype(np.float32)
    port, oracle, kernel = _both(
        q, np.array(qk), np.array(qv), offset, offset + T,
        k_scale=state.k_scale[0], v_scale=state.v_scale[0])
    np.testing.assert_allclose(port, oracle, atol=3e-5)
    np.testing.assert_allclose(port, kernel, atol=3e-5)


def test_cached_attention_rejects_unpaired_scales():
    z = torch.zeros(1, 1, 4, 8)
    with pytest.raises(ValueError, match="together"):
        TA.cached_attention(z[:, :, :1], z, z, 0, 1, k_scale=z[..., :1])


def test_causal_reference_matches_jax():
    rng = np.random.default_rng(3)
    T = 12
    q = rng.normal(size=(B, HQ, T, 16)).astype(np.float32)
    k = rng.normal(size=(B, HKV, T, 16)).astype(np.float32)
    v = rng.normal(size=(B, HKV, T, 16)).astype(np.float32)
    for kw in ({}, {"window": 4, "alibi": JA.alibi_slopes(HQ)},
               {"softcap": 3.0, "scale": 0.2}):
        ref = JA.causal_attention_reference(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), **kw)
        out = TA.causal_attention_reference(torch.as_tensor(q),
                                            torch.as_tensor(k),
                                            torch.as_tensor(v), **kw)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


_LLAMA3 = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
           "high_freq_factor": 4.0, "original_max_position_embeddings": 64}


@pytest.mark.parametrize("scaling,rotary_dim", [
    (None, None), (_LLAMA3, None), ({"rope_type": "linear", "factor": 4.0},
                                    None), (None, 8)],
    ids=["plain", "llama3", "linear", "partial"])
def test_apply_rope_matches_jax(scaling, rotary_dim):
    rng = np.random.default_rng(4)
    q = rng.normal(size=(B, HQ, 6, 32)).astype(np.float32)
    k = rng.normal(size=(B, HKV, 6, 32)).astype(np.float32)
    jq, jk = JA.apply_rope(jnp.asarray(q), jnp.asarray(k), 10000.0,
                           jnp.asarray(3), scaling=scaling,
                           rotary_dim=rotary_dim)
    tq, tk = TA.apply_rope(torch.as_tensor(q), torch.as_tensor(k), 10000.0,
                           3, scaling=scaling, rotary_dim=rotary_dim)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), atol=1e-6)
