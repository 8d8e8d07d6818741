"""The port's flash attention on the CPU (its plain version, which the CUDA
kernels are held to on the card) against the JAX package's Pallas flash
kernel run in interpret mode, as tests/test_attention.py runs it: forward
output and logsumexp, and the gradients through the port's
``torch.autograd.Function`` against ``jax.vjp``.  The dropout keep-mask
equals the JAX oracle's bit for bit.

Shapes: B=1, T=S=256, D=64, Pallas blocks 128.  Tolerance (fp32 both
sides, the same algorithm summed in another order: blockwise online
softmax against whole rows): atol 2e-5 on outputs and logsumexp, 5e-5 on
gradients, whose entries sum up to 256 products.  The bf16 cases (the
type in which the CUDA kernels are held to the plain version on the card)
have their own bound, in their test's docstring."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import attention as JA
from penroz_tpu.ops.pallas import flash_attention as JFA
from penroz_tpu_torch.ops import attention as TA
from penroz_tpu_torch.ops.kernels import flash_attention as FA

T, D = 256, 64

CASES = {
    "mha": dict(hq=2, hkv=2),
    "gqa": dict(hq=4, hkv=2),
    "window64": dict(hq=2, hkv=2, window=64),
    "alibi": dict(hq=4, hkv=2, alibi=True),
    "scale": dict(hq=2, hkv=2, scale=0.3),
    "dropout": dict(hq=2, hkv=1, rate=0.1, seed=1234),
}


def _inputs(hq, hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, hq, T, D)).astype(np.float32)
    k = rng.normal(size=(1, hkv, T, D)).astype(np.float32)
    v = rng.normal(size=(1, hkv, T, D)).astype(np.float32)
    g = rng.normal(size=(1, hq, T, D)).astype(np.float32)
    return q, k, v, g


def _options(case):
    alibi = JA.alibi_slopes(case["hq"]) if case.get("alibi") else None
    return dict(window=case.get("window"), alibi=alibi,
                scale=case.get("scale")), case.get("rate", 0.0), \
        case.get("seed")


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_matches_pallas_interpret(name):
    case = CASES[name]
    q, k, v, g = _inputs(case["hq"], case["hkv"])
    opts, rate, seed = _options(case)
    jseed = jnp.asarray(seed or 0, jnp.int32)

    def jfn(q_, k_, v_):
        return JFA.flash_attention(q_, k_, v_, causal=True, block_q=128,
                                   block_k=128, dropout_rate=rate,
                                   seed=jseed, interpret=True, **opts)

    jout, vjp = jax.vjp(jfn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(g))
    _, jlse = JFA._flash_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), True, 128, 128,
        dropout_rate=rate, seed=jseed, interpret=True, return_lse=True,
        **opts)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = FA.flash_attention(tq, tk, tv, dropout_rate=rate, seed=seed,
                             **opts)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.as_tensor(g))
    _, lse = FA.flash_forward(tq.detach(), tk.detach(), tv.detach(),
                              dropout_rate=rate, seed=seed, **opts)

    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=0)
    for got, want, what in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5,
                                   rtol=0, err_msg=what)


@pytest.mark.parametrize("seed,b,h,heads", [
    (0, 0, 0, 1), (1234, 0, 1, 2), (2 ** 31 - 5, 3, 7, 16),
    (-17, 1, 0, 4)])
def test_keep_mask_equals_jax_bit_for_bit(seed, b, h, heads):
    want = JFA.dropout_keep_mask_reference(jnp.asarray(seed, jnp.int32), b, h,
                                           heads, 64, 96, 0.1)
    got = TA.dropout_keep_mask_reference(seed, b, h, heads, 64, 96, 0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    full = TA.dropout_keep_mask(torch.tensor(seed, dtype=torch.int32),
                                b + 1, heads, 64, 0.1, "cpu")
    np.testing.assert_array_equal(full[b, h].numpy(), np.asarray(want)[:, :64])
    assert TA.keep_threshold(0.0) == 2 ** 32 - 1
    assert TA.keep_threshold(0.25) == 3 * 2 ** 30


def test_dropout_kernel_path_uses_the_hash_mask():
    """With dropout the plain version's output equals attention with the
    JAX oracle's mask applied to the normalised probabilities."""
    q, k, v, _ = _inputs(2, 2, seed=5)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    out, _ = FA.flash_forward(tq, tk, tv, dropout_rate=0.2, seed=99)
    keep = np.stack([np.asarray(JFA.dropout_keep_mask_reference(
        jnp.asarray(99, jnp.int32), 0, h, 2, T, T, 0.2)) for h in range(2)])
    s = np.einsum("htd,hsd->hts", q[0], k[0]) / np.sqrt(D)
    s = np.where(np.tril(np.ones((T, T), bool)), s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("hts,hsd->htd", np.where(keep, p / 0.8, 0.0), v[0])
    np.testing.assert_allclose(out[0].numpy(), want, atol=2e-5)


def test_causal_attention_dispatch_and_softcap_reference():
    q, k, v, _ = _inputs(2, 2, seed=6)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    before = FA.flash_forward.launches
    out = TA.causal_attention(tq, tk, tv)
    ref = TA.causal_attention_reference(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=2e-5)
    assert FA.flash_forward.launches == before  # CPU: the plain version
    capped = TA.causal_attention(tq, tk, tv, softcap=5.0)
    np.testing.assert_allclose(
        capped.numpy(), TA.causal_attention_reference(
            tq, tk, tv, softcap=5.0).numpy(), atol=1e-6)
    assert "softcap_reference" in TA._WARNED_ONCE


def _bf16(a):
    """numpy fp32 -> (torch bf16, jax bf16): the same rounded values."""
    return (torch.as_tensor(a).to(torch.bfloat16),
            jnp.asarray(a).astype(jnp.bfloat16))


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("name", ["mha", "gqa"])
def test_flash_bf16_matches_pallas_interpret(name):
    """bf16 inputs through the port's plain version (forward, and the
    backward through the autograd Function) and the Pallas kernels in
    interpret mode, which round at the same points (p to bf16 before P·V,
    dS and p~ to bf16 before their products, each result once).  The
    backward runs both on the port's forward output and logsumexp, so both
    compute the same delta.  Element by element, each side within one bf16
    rounding of p, p~ or dS (relative 2^-8) and of its result:
    |got - want| <= 2^-7 * (sum|terms| + |want|) + dS err + 1e-6, sum|terms|
    the element's sum taken on absolute values (sum_j w_j |v_j| for the
    output, sum |dS||k| for dq, sum |dS||q| for dk, sum |p~||dO| for dv)
    and dS err the fp32 error bound of dP - delta
    (flash_backward_reference's ``terms``); lse atol 1e-4."""
    case = CASES[name]
    hq, hkv = case["hq"], case["hkv"]
    (tq, jq), (tk, jk), (tv, jv), (tg, jg) = map(_bf16, _inputs(hq, hkv))
    _, jlse = JFA._flash_forward(jq, jk, jv, True, 128, 128, interpret=True,
                                 return_lse=True)
    jout = JFA._flash_forward(jq, jk, jv, True, 128, 128, interpret=True)

    q, k, v = (t.clone().requires_grad_(True) for t in (tq, tk, tv))
    out = FA.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), tg)
    _, lse = FA.flash_forward(tq, tk, tv)
    ref_abs, _ = FA.flash_forward_reference(tq, tk, tv.abs())

    c = 2.0 ** -7

    def within(got, want, terms, extra=0.0):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        bound = c * (terms + np.abs(want)) + extra + 1e-6
        assert np.all(np.abs(got - want) <= bound), \
            float(np.max(np.abs(got - want) / bound))

    assert out.dtype == torch.bfloat16
    within(out.detach().float().numpy(), _f32(jout),
           ref_abs.float().numpy())
    np.testing.assert_allclose(lse.numpy(), _f32(jlse), atol=1e-4, rtol=0)

    jout_port = jnp.asarray(out.detach().float().numpy()).astype(
        jnp.bfloat16)
    jgrads = JFA._flash_backward(jq, jk, jv, jout_port,
                                 jnp.asarray(lse.numpy()), jg, True, 128,
                                 128, 0.0, None, interpret=True)
    *_, p_drop, ds, ds_err = FA.flash_backward_reference(
        tq, tk, tv, out.detach(), lse, tg, terms=True)
    qg = TA._group_query_heads(tq, hkv).float().abs()
    dg = TA._group_query_heads(tg, hkv).float().abs()
    ka = tk.float().abs()
    terms = (
        (torch.einsum("bhgts,bhsd->bhgtd", ds.abs(), ka).reshape(tq.shape),
         torch.einsum("bhgts,bhsd->bhgtd", ds_err, ka).reshape(tq.shape)),
        (torch.einsum("bhgts,bhgtd->bhsd", ds.abs(), qg),
         torch.einsum("bhgts,bhgtd->bhsd", ds_err, qg)),
        (torch.einsum("bhgts,bhgtd->bhsd", p_drop.abs(), dg),
         torch.zeros(())))
    for got, want, (term, extra) in zip(grads, jgrads, terms):
        assert got.dtype == torch.bfloat16
        within(got.float().numpy(), _f32(want), term.numpy(), extra.numpy())
