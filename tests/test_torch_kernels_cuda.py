"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: every test skips (from a fixture, never at import)
where there is no card.  Run on a machine with one:

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py imports JAX, which that machine
lacks.)

Tolerances (the same inputs in the same dtype, summed in another order):
fp32 and int8-cache atol 1e-4.  bf16: each version rounds every
probability to bf16 once (relative error <= 2^-8), the kernel before
normalising and the plain version after, and each rounds its output once,
so element by element |out - ref| <= 2^-7 * (sum_j w_j |v_j| + |ref|);
sum_j w_j |v_j| is the plain version run on |v|."""

import numpy as np
import pytest
import torch

from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops.kernels import decode_attention as DA

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernel, no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _inputs(dev, B, Hq, Hkv, T, S, D, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, Hq, T, D, generator=g).to(dev, dtype)
    k = torch.randn(B, Hkv, S, D, generator=g).to(dev, dtype)
    v = torch.randn(B, Hkv, S, D, generator=g).to(dev, dtype)
    return q, k, v


def _compare(out, q, k, v, offset, length, **kw):
    """The kernel's output against the plain version on the same inputs."""
    ref = DA.decode_attention_reference(q, k, v, offset, length, **kw)
    if q.dtype != torch.bfloat16:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        return
    ref_abs = DA.decode_attention_reference(q, k, v.abs(), offset, length,
                                            **kw).float()
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -7 * (ref_abs + ref.float().abs())
    worst = float((err / tol).max())
    assert worst <= 1.0, (f"max abs err {float(err.max()):.3e} is {worst:.2f}"
                          f" x the bf16 tolerance")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,S,D,L", [
    (1, 12, 12, 1, 256, 64, 1), (1, 12, 12, 1, 256, 64, 200),
    (2, 4, 2, 5, 130, 32, 77), (1, 4, 1, 64, 64, 128, 64),
    (1, 2, 2, 3, 40, 256, 40), (1, 8, 2, 17, 100, 8, 60)])
def test_kernel_matches_plain(dev, dtype, B, Hq, Hkv, T, S, D, L):
    q, k, v = _inputs(dev, B, Hq, Hkv, T, S, D, dtype)
    before = DA.decode_attention.launches
    out = DA.decode_attention(q, k, v, L - T, L)
    torch.cuda.synchronize()
    assert DA.decode_attention.launches == before + 1
    _compare(out, q, k, v, L - T, L)


@pytest.mark.parametrize("kw", [
    {"window": 1}, {"window": 9}, {"alibi": "slopes"}, {"softcap": 3.0},
    {"scale": 0.2}, {"window": 20, "alibi": "slopes", "softcap": 2.0}],
    ids=["window1", "window9", "alibi", "softcap", "scale", "combined"])
def test_kernel_features(dev, kw):
    from penroz_tpu_torch.ops.attention import alibi_slopes
    q, k, v = _inputs(dev, 2, 8, 4, 6, 150, 64, torch.float32, seed=1)
    kw = dict(kw)
    if "alibi" in kw:
        kw["alibi"] = alibi_slopes(8)
    out = DA.decode_attention(q, k, v, 94, 100, **kw)
    _compare(out, q, k, v, 94, 100, **kw)


def test_kernel_per_row_lengths(dev):
    q, k, v = _inputs(dev, 3, 4, 2, 2, 90, 64, torch.float32, seed=2)
    lengths = torch.tensor([2, 50, 90], dtype=torch.int32, device=dev)
    out = DA.decode_attention(q, k, v, 0, lengths)
    _compare(out, q, k, v, 0, lengths)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernel_int8_cache(dev, dtype):
    q, k, v = _inputs(dev, 1, 4, 2, 3, 128, 64, dtype, seed=3)
    state = KV.QuantKVState.create([(2, 64)], 1, 128, dtype, device=dev)
    qk, qv, length = state.append_raw(0, k[:, :, :70], v[:, :, :70] * 0.5)
    scales = {"k_scale": state.k_scale[0], "v_scale": state.v_scale[0]}
    out = DA.decode_attention(q, qk, qv, length - 3, length, **scales)
    _compare(out, q, qk, qv, length - 3, length, **scales)


def test_kernel_rejects_what_it_cannot_take(dev):
    q, k, v = _inputs(dev, 1, 2, 2, 1, 16, 64, torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        DA.decode_attention(q[..., :60].contiguous(), k[..., :60].contiguous(),
                            v[..., :60].contiguous(), 0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        DA.decode_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                            v, 0, 1)
    with pytest.raises(ValueError, match="float16|dtype"):
        DA.decode_attention(q.half(), k.half(), v.half(), 0, 1)
    with pytest.raises(ValueError, match="length"):
        DA.decode_attention(q, k, v, 16, 17)
    with pytest.raises(ValueError, match="cuda|device"):
        DA.decode_attention(q, k.cpu(), v, 0, 1)


def test_kernel_gpt2_decode_shape(dev):
    """GPT-2 124M decode: B=1, 12 heads, D=64, cache full at S=1024."""
    q, k, v = _inputs(dev, 1, 12, 12, 1, 1024, 64, torch.float32)
    out = DA.decode_attention(q, k, v, 1023, 1024)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert np.isfinite(out.float().cpu().numpy()).all()


# ---------------------------------------------------------------------------
# flash attention and cross-entropy (training slice)
#
# The flash kernels are held to their plain version element by element at
# c * (sum |terms| + |ref|) + dS err + 1e-6, where sum |terms| is the product
# the element sums taken on absolute values (sum_j w_j |v_j| for the output,
# sum |dS| |k| for dq, sum |dS| |q| for dk, sum |p~| |dO| for dv): c = 2^-7
# in bf16 (both versions round p, p~ or dS to bf16 once, at different
# points, and round the output once), c = 1e-5 in fp32 (summation order);
# dS err (dq, dk) carries the fp32 error of dP - delta, which cancels where
# a row's probability sits on one key (flash_backward_reference's bound).
# Cross-entropy: lse atol 1e-4, label logits exact, the gradient one bf16
# rounding step (rtol 2^-7) or rtol 1e-5 in fp32, atol 1e-12.
# ---------------------------------------------------------------------------

from penroz_tpu_torch.ops import attention as TA  # noqa: E402
from penroz_tpu_torch.ops.kernels import cross_entropy as CE  # noqa: E402
from penroz_tpu_torch.ops.kernels import flash_attention as FA  # noqa: E402


def _bound(terms, ref, dtype, extra=0.0):
    c = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    return c * (terms + ref.float().abs()) + extra + 1e-6


def _worst(out, ref, terms, dtype, extra=0.0):
    return float(((out.float() - ref.float()).abs()
                  / _bound(terms, ref, dtype, extra)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("B,Hq,Hkv,T,D,kw", [
    (2, 4, 4, 200, 64, {}),
    (1, 8, 2, 130, 128, {}),
    (1, 4, 2, 96, 256, {}),
    (1, 4, 4, 150, 64, {"window": 33, "alibi": True}),
    (2, 2, 1, 100, 64, {"dropout_rate": 0.1, "seed": 77, "scale": 0.2}),
], ids=["mha", "gqa_d128", "d256", "window_alibi", "dropout_scale"])
def test_flash_kernels_match_plain(dev, dtype, B, Hq, Hkv, T, D, kw):
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi"] = TA.alibi_slopes(Hq)
    q, k, v = _inputs(dev, B, Hq, Hkv, T, T, D, dtype, seed=5)
    dout = torch.randn(B, Hq, T, D, device=dev).to(dtype)
    before = (FA.flash_forward.launches, FA.flash_backward.launches)
    out, lse = FA.flash_forward(q, k, v, **kw)
    dq, dk, dv = FA.flash_backward(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert (FA.flash_forward.launches, FA.flash_backward.launches) == (
        before[0] + 1, before[1] + 1)
    ref, ref_lse = FA.flash_forward_reference(q, k, v, **kw)
    ref_abs, _ = FA.flash_forward_reference(q, k, v.abs(), **kw)
    assert _worst(out, ref, ref_abs.float(), dtype) <= 1.0
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    rq, rk, rv, p_drop, ds, ds_err = FA.flash_backward_reference(
        q, k, v, out, lse, dout, terms=True, **kw)
    qg = TA._group_query_heads(q, Hkv).float().abs()
    dg = TA._group_query_heads(dout, Hkv).float().abs()
    ka = k.float().abs()
    bounds = ((torch.einsum("bhgts,bhsd->bhgtd", ds.abs(), ka)
               .reshape(q.shape),
               torch.einsum("bhgts,bhsd->bhgtd", ds_err, ka)
               .reshape(q.shape)),
              (torch.einsum("bhgts,bhgtd->bhsd", ds.abs(), qg),
               torch.einsum("bhgts,bhgtd->bhsd", ds_err, qg)),
              (torch.einsum("bhgts,bhgtd->bhsd", p_drop.abs(), dg), 0.0))
    for got, want, (term, extra) in zip((dq, dk, dv), (rq, rk, rv), bounds):
        assert got.dtype == dtype
        assert _worst(got, want, term, dtype, extra) <= 1.0


def test_flash_autograd_and_rejections(dev):
    q, k, v = _inputs(dev, 1, 4, 2, 64, 64, 64, torch.float32, seed=6)
    q.requires_grad_(True)
    out = TA.causal_attention(q, k, v)
    (grad,) = torch.autograd.grad(out.sum(), (q,))
    ref = FA.flash_backward_reference(q.detach(), k, v, out.detach(),
                                      FA.flash_forward(q.detach(), k, v)[1],
                                      torch.ones_like(out))[0]
    torch.testing.assert_close(grad, ref, atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_forward(q[..., :32].detach().contiguous(),
                         k[..., :32].contiguous(), v[..., :32].contiguous())
    with pytest.raises(ValueError, match="float16|dtype"):
        FA.flash_forward(q.detach().half(), k.half(), v.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("n,v", [(64, 50304), (37, 301), (8, 2560)])
def test_ce_kernels_match_plain(dev, dtype, n, v):
    g = torch.Generator(device="cpu").manual_seed(n)
    x = (torch.randn(n, v, generator=g) * 3).to(dev, dtype)
    t = torch.randint(0, v, (n,), generator=g, dtype=torch.int32).to(dev)
    t[-1] = -1
    before = (CE.ce_forward.launches, CE.ce_backward.launches)
    lse, ll = CE.ce_forward(x, t)
    scale = torch.tensor(0.5 / n, device=dev)
    grad = CE.ce_backward(x, t, lse, scale)
    torch.cuda.synchronize()
    assert (CE.ce_forward.launches, CE.ce_backward.launches) == (
        before[0] + 1, before[1] + 1)
    ref_lse, ref_ll = CE.ce_forward_reference(x, t)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)
    torch.testing.assert_close(ll, ref_ll, atol=0, rtol=0)
    ref = CE.ce_backward_reference(x, t, ref_lse, scale)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    assert grad.dtype == dtype and not grad[-1].any()
    torch.testing.assert_close(grad.float(), ref.float(), rtol=rtol,
                               atol=1e-12)


def test_training_step_launches_every_kernel(dev):
    """One bf16 training epoch of a small GPT on the card goes through the
    flash and cross-entropy kernels: 2 layers x 2 micro-steps."""
    from penroz_tpu_torch.models import presets
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    layers = presets.gpt2_custom(d=128, heads=2, depth=2, vocab=512,
                                 block=64)
    model = NeuralNetworkModel("cuda-train", Mapper(layers, presets.ADAMW),
                               device=dev)
    x = torch.randint(0, 512, (2, 2, 64), device=dev)
    before = (FA.flash_forward.launches, FA.flash_backward.launches,
              CE.ce_forward.launches, CE.ce_backward.launches)
    cost, ratios = model.arch.train_epoch(
        model.optimizer, x, torch.roll(x, -1, -1),
        compute_dtype=torch.bfloat16,
        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    after = (FA.flash_forward.launches, FA.flash_backward.launches,
             CE.ce_forward.launches, CE.ce_backward.launches)
    assert [a - b for a, b in zip(after, before)] == [4, 4, 2, 2]
    assert bool(torch.isfinite(cost)) and abs(float(cost) - np.log(512)) < 1
    assert ratios.shape == (len(model.arch.param_order),)
