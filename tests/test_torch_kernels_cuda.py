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


def _abs(v):
    """|v| for the bf16 tolerance's sum w|v|: an int8 cache is widened
    first, since int8 abs() wraps -128 (which the quantizer emits from bf16
    input) to -128."""
    return v.to(torch.int16).abs() if v.dtype == torch.int8 else v.abs()


def _compare(out, q, k, v, offset, length, **kw):
    """The kernel's output against the plain version on the same inputs."""
    ref = DA.decode_attention_reference(q, k, v, offset, length, **kw)
    if q.dtype != torch.bfloat16:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        return
    ref_abs = DA.decode_attention_reference(q, k, _abs(v), offset, length,
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


PHASED_LENGTHS = [17, 764, 300, 45, 612, 129, 256, 500]


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_kernel_phased_step_lengths(dev, int8):
    """The phased ticks' shared step: 8 rows with their own lengths
    (17-764) over a contiguous cache of 1024, GPT-2's 12 x 64 heads."""
    q, k, v = _inputs(dev, 8, 12, 12, 1, 1024, 64, torch.float32, seed=11)
    scales = {}
    if int8:
        k, ks = KV._quantize_int8(k)
        v, vs = KV._quantize_int8(v)
        scales = {"k_scale": ks, "v_scale": vs}
    lengths = torch.tensor(PHASED_LENGTHS, dtype=torch.int32, device=dev)
    out = DA.decode_attention(q, k, v, 0, lengths, **scales)
    _compare(out, q, k, v, 0, lengths, **scales)


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


# The decode tiles' split-K edges, at the card's own split plan: one key, a
# ragged last split, lengths 1-1024, a window narrower than the splits with
# several query tokens, GQA 32 x 8, ALiBi + softcap, int8 scales, the
# largest tile (eight rows, D 256) in a 16-block cluster, and D 8 in
# 16-block clusters (more splits than head dims).  Each is
# held to the plain version and to the split reference (the same cut and
# merge in plain PyTorch, on the CPU).
@pytest.mark.parametrize("case", [
    dict(B=1, Hq=12, Hkv=12, T=1, S=1024, D=64, lengths=[1]),
    dict(B=1, Hq=12, Hkv=12, T=1, S=1024, D=64, lengths=[65]),
    dict(B=8, Hq=12, Hkv=12, T=1, S=1024, D=64,
         lengths=[1024, 700, 129, 1, 513, 900, 257, 64]),
    dict(B=1, Hq=12, Hkv=12, T=8, S=1024, D=64, lengths=[1000], window=60),
    dict(B=1, Hq=32, Hkv=8, T=1, S=1024, D=128, lengths=[1024]),
    dict(B=2, Hq=8, Hkv=4, T=3, S=600, D=64, lengths=[600, 77],
         alibi=True, softcap=5.0),
    dict(B=1, Hq=12, Hkv=12, T=1, S=1024, D=64, lengths=[1000], int8=True),
    dict(B=1, Hq=8, Hkv=1, T=1, S=1024, D=256, lengths=[1024]),
    dict(B=1, Hq=32, Hkv=8, T=4, S=1024, D=8, lengths=[1024]),
    dict(B=1, Hq=32, Hkv=8, T=2, S=1024, D=8, lengths=[1000], int8=True),
], ids=["L1", "L65", "B8_lengths_1_1024", "T8_window60", "gqa_32x8",
        "alibi_softcap", "int8", "rows8_D256_16_splits",
        "D8_gqa_T4_16_splits", "D8_gqa_int8_16_splits"])
def test_kernel_split_edges(dev, case):
    B, T = case["B"], case["T"]
    q, k, v = _inputs(dev, B, case["Hq"], case["Hkv"], T, case["S"],
                      case["D"], torch.float32, seed=4)
    kw = {key: case[key] for key in ("window", "softcap") if key in case}
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(case["Hq"])
    if case.get("int8"):
        state = KV.QuantKVState.create([(case["Hkv"], case["D"])], B,
                                       case["S"], torch.float32, device=dev)
        k, v, _ = state.append_raw(0, k, v)
        kw.update(k_scale=state.k_scale[0], v_scale=state.v_scale[0])
    length = torch.tensor(case["lengths"], dtype=torch.int32, device=dev)
    out = DA.decode_attention(q, k, v, 0, length, **kw)
    _compare(out, q, k, v, 0, length, **kw)
    cpu = {key: (val.cpu() if isinstance(val, torch.Tensor) else val)
           for key, val in kw.items()}
    split = DA.decode_attention_split_reference(
        q.cpu(), k.cpu(), v.cpu(), 0, length.cpu(), sms=DA.sm_count(dev),
        **cpu)
    torch.testing.assert_close(out.cpu(), split, atol=1e-4, rtol=0)


def test_kernel_row_with_no_attended_key_is_zero(dev):
    """A query before position 0 (length < T) attends no key: zeros, also
    where a whole row tile lies before position 0 (T 16: 8-row tiles)."""
    for dtype, T, first_len in ((torch.float32, 3, 2),
                                (torch.bfloat16, 3, 2),
                                (torch.float32, 16, 4),
                                (torch.bfloat16, 16, 4)):
        q, k, v = _inputs(dev, 2, 4, 2, T, 64, 64, dtype, seed=6)
        lengths = torch.tensor([first_len, 40], dtype=torch.int32,
                               device=dev)
        out = DA.decode_attention(q, k, v, 0, lengths)
        assert not out[0, :, :T - first_len].any()
        split = DA.decode_attention_split_reference(
            q.cpu(), k.cpu(), v.cpu(), 0, lengths.cpu(),
            sms=DA.sm_count(dev))
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(out.float().cpu(), split.float(),
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_kernels_two_launches_are_bit_identical(dev, dtype):
    """The splits merge in a fixed order: the same inputs give the same
    bits, launch after launch, contiguous and paged."""
    q, k, v = _inputs(dev, 1, 12, 12, 1, 1024, 64, dtype, seed=7)
    outs = [DA.decode_attention(q, k, v, 1023, 1024) for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    pk, pv, table, _ = _paged_pools(dev, [1024, 300], 12, 64, 128, 9, dtype,
                                    False)
    q2 = torch.randn(2, 12, 1, 64, device=dev).to(dtype)
    lens = torch.tensor([1024, 300], dtype=torch.int32, device=dev)
    outs = [PA.paged_decode_attention(q2, pk, pv, table, 128, 0, lens)
            for _ in range(3)]
    assert all(torch.equal(outs[0], o) for o in outs[1:])


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


def _check_flash(dev, dtype, B, Hq, Hkv, T, D, kw, seed=5):
    """Forward and backward kernels against the plain versions, each
    element within its bound; returns the kernels' results."""
    kw = dict(kw)
    if kw.pop("alibi", False):
        kw["alibi"] = TA.alibi_slopes(Hq)
    q, k, v = _inputs(dev, B, Hq, Hkv, T, T, D, dtype, seed=seed)
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
    return (q, k, v, dout, kw), (out, lse, dq, dk, dv)


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
    _check_flash(dev, dtype, B, Hq, Hkv, T, D, kw)


# The bf16 Hopper kernels (TMA ring + wgmma, D 64 and 128): the ragged edges
# of their 128-row blocks and 128-, 64- or 32-row streamed tiles (T 1 to
# 1000), GQA, windows that skip and mask whole tiles with ALiBi, dropout,
# and the same tolerances as above.
@pytest.mark.parametrize("B,Hq,Hkv,T,D,kw", [
    (1, 2, 2, 1, 64, {}),
    (2, 2, 1, 127, 64, {}),
    (1, 4, 4, 129, 64, {}),
    (1, 4, 2, 1000, 64, {}),
    (2, 4, 2, 130, 128, {}),
    (1, 8, 2, 257, 128, {}),
    (1, 4, 2, 1000, 64, {"window": 200, "alibi": True}),
    (1, 4, 2, 520, 128, {"window": 100, "alibi": True}),
    (1, 4, 4, 300, 64, {"dropout_rate": 0.1, "seed": 5}),
    (1, 4, 2, 300, 128, {"dropout_rate": 0.2, "seed": 6, "alibi": True}),
], ids=["T1", "T127_gqa", "T129", "T1000_gqa", "T130_d128", "gqa4_d128",
        "window_alibi_T1000", "window_alibi_d128", "dropout",
        "dropout_alibi_d128"])
def test_flash_hopper_kernels_match_plain(dev, B, Hq, Hkv, T, D, kw):
    _check_flash(dev, torch.bfloat16, B, Hq, Hkv, T, D, kw, seed=T)


@pytest.mark.parametrize("D", [64, 128])
def test_flash_hopper_kernels_are_deterministic_and_write_delta(dev, D):
    """Two launches give the same bits (no atomics), and the delta the dq
    kernel writes is rowsum(dO * O) within 1e-5 of the row's sum of
    |dO * O| (fp32 sums in another order)."""
    (q, k, v, dout, kw), first = _check_flash(
        dev, torch.bfloat16, 2, 8, 2, 1000, D,
        {"window": 300, "alibi": True, "dropout_rate": 0.1, "seed": 9})
    out, lse = FA.flash_forward(q, k, v, **kw)
    dq, dk, dv = FA.flash_backward(q, k, v, out, lse, dout, **kw)
    for a, b in zip(first, (out, lse, dq, dk, dv)):
        assert torch.equal(a, b)
    args = FA._kernel_args(q, k, v, kw["window"], kw["alibi"], None,
                           kw["dropout_rate"], kw["seed"])
    *grads, delta = FA._launch_backward(q, k, v, out, dout, lse, args)
    for a, b in zip(grads, (dq, dk, dv)):
        assert torch.equal(a, b)
    prod = dout.float() * out.float()
    assert delta.shape == (2, 8, 1000) and delta.dtype == torch.float32
    assert bool(((delta - prod.sum(-1)).abs()
                 <= 1e-5 * prod.abs().sum(-1)).all())


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


# ---------------------------------------------------------------------------
# paged decode and ragged paged attention (continuous-batching slice): the
# same tolerances as the contiguous decode kernel above; padding slots of
# the ragged kernel must be exactly zero.
# ---------------------------------------------------------------------------

from penroz_tpu_torch.ops.kernels import paged_attention as PA  # noqa: E402
from penroz_tpu_torch.ops.kernels import ragged_paged_attention as RPA  # noqa: E402,E501


def _paged_pools(dev, lengths, Hkv, D, P, pages_per_seq, dtype, int8,
                 seed=0):
    """Pools with each sequence's live pages on shuffled physical pages and
    -1 past them; int8 pools quantized by the cache's own quantizer."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    num_pages = len(lengths) * pages_per_seq + 3
    rows = num_pages * P
    k = torch.randn(1, Hkv, rows, D, generator=g).to(dev, dtype)
    v = torch.randn(1, Hkv, rows, D, generator=g).to(dev, dtype)
    perm = torch.randperm(num_pages, generator=g).tolist()
    table = torch.full((len(lengths), pages_per_seq), -1, dtype=torch.int32)
    used = 0
    for r, n in enumerate(lengths):
        live = -(-n // P)
        table[r, :live] = torch.tensor(perm[used:used + live])
        used += live
    table = table.to(dev)
    if not int8:
        return k[0], v[0], table, {}
    qk, sk = KV._quantize_int8(k)
    qv, sv = KV._quantize_int8(v)
    return qk[0], qv[0], table, {"k_scale": sk[0], "v_scale": sv[0]}


def _check_close(out, ref, ref_abs):
    if out.dtype != torch.bfloat16:
        torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
        return
    err = (out.float() - ref.float()).abs()
    tol = 2.0 ** -7 * (ref_abs.float() + ref.float().abs())
    assert bool((err <= tol).all()), float((err - tol).max())


@pytest.mark.parametrize("case", [
    dict(lengths=[1024], Hq=12, Hkv=12, T=1, D=64, P=128, dtype="float32"),
    dict(lengths=[700, 1024, 3, 130], Hq=12, Hkv=12, T=1, D=64, P=128,
         dtype="bfloat16"),
    dict(lengths=[37, 90], Hq=8, Hkv=2, T=3, D=128, P=8, dtype="float32"),
    dict(lengths=[300, 41], Hq=4, Hkv=4, T=2, D=64, P=16, dtype="float32",
         int8=True),
    dict(lengths=[300, 41], Hq=4, Hkv=4, T=2, D=64, P=16, dtype="bfloat16",
         int8=True),
    dict(lengths=[500, 77], Hq=4, Hkv=2, T=4, D=64, P=32, dtype="float32",
         window=50, alibi=True, softcap=5.0),
    dict(lengths=[64, 129], Hq=2, Hkv=1, T=1, D=256, P=8, dtype="bfloat16",
         scale=0.1),
    dict(lengths=[1004], Hq=12, Hkv=12, T=1004, D=64, P=128,
         dtype="float32"),
    dict(lengths=[1024], Hq=12, Hkv=12, T=1024, D=64, P=128,
         dtype="float32"),
    dict(lengths=[1], Hq=12, Hkv=12, T=1, D=64, P=128, dtype="float32"),
    dict(lengths=[65, 1000, 16], Hq=12, Hkv=12, T=1, D=64, P=16,
         dtype="float32"),
    dict(lengths=[1024, 700, 129, 1, 513, 900, 257, 64], Hq=12, Hkv=12,
         T=1, D=64, P=128, dtype="bfloat16"),
    dict(lengths=[300], Hq=8, Hkv=2, T=64, D=128, P=16, dtype="bfloat16"),
    dict(lengths=[1024], Hq=32, Hkv=8, T=4, D=8, P=128, dtype="float32"),
    # the phased ticks' shared step over the paged pool
    dict(lengths=PHASED_LENGTHS, Hq=12, Hkv=12, T=1, D=64, P=128,
         dtype="float32"),
    dict(lengths=PHASED_LENGTHS, Hq=12, Hkv=12, T=1, D=64, P=128,
         dtype="float32", int8=True),
], ids=["gpt2_L1024", "gpt2_B4_ragged_bf16", "gqa_d128_p8", "int8",
        "int8_bf16", "window_alibi_softcap", "d256_scale_bf16",
        "gpt2_prefill_T1004", "gpt2_prefill_T1024", "L1", "L65_P16",
        "B8_spread_bf16", "gqa_prefill_tile_bf16", "D8_gqa_T4_16_splits",
        "B8_phased_17_764", "B8_phased_17_764_int8"])
def test_paged_decode_kernel_matches_plain(dev, case):
    dtype = getattr(torch, case["dtype"])
    lengths, T, P = case["lengths"], case["T"], case["P"]
    pages = -(-max(lengths) // P) + 1
    k, v, table, scales = _paged_pools(dev, lengths, case["Hkv"], case["D"],
                                       P, pages, dtype, case.get("int8"))
    g = torch.Generator(device="cpu").manual_seed(9)
    q = torch.randn(len(lengths), case["Hq"], T, case["D"],
                    generator=g).to(dev, dtype)
    kw = {key: case[key] for key in ("window", "softcap", "scale")
          if key in case}
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(case["Hq"])
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = PA.paged_decode_attention.launches
    out = PA.paged_decode_attention(q, k, v, table, P, 0, lens, **scales,
                                    **kw)
    torch.cuda.synchronize()
    assert PA.paged_decode_attention.launches == before + 1
    ref = PA.paged_decode_attention_reference(q, k, v, table, P, 0, lens,
                                              **scales, **kw)
    ref_abs = PA.paged_decode_attention_reference(q, k, _abs(v), table, P,
                                                  0, lens, **scales, **kw)
    _check_close(out, ref, ref_abs)
    plan = DA.split_plan(len(lengths), case["Hkv"],
                         case["Hq"] // case["Hkv"] * T, pages * P,
                         kw.get("window"), P, DA.sm_count(dev))
    if plan.tile_rows:  # the split reference: the same cut and merge
        cpu = {key: (val.cpu() if isinstance(val, torch.Tensor) else val)
               for key, val in {**scales, **kw}.items()}
        split = PA.paged_decode_attention_split_reference(
            q.cpu(), k.cpu(), v.cpu(), table.cpu(), P, 0, lens.cpu(),
            sms=DA.sm_count(dev), **cpu)
        _check_close(out.cpu(), split, ref_abs.cpu())
    if len(lengths) == 1:  # scalar length: the single-sequence path
        out = PA.paged_decode_attention(q, k, v, table, P, lengths[0] - T,
                                        lengths[0], **scales, **kw)
        _check_close(out, ref, ref_abs)


def _ragged_case(dev, spans, NB, BQ, Hq, Hkv, D, P, dtype, int8, seed=0):
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    lengths = [q0 + n for _, q0, n in spans]
    pages = -(-max(lengths) // P) + 1
    k, v, table, scales = _paged_pools(dev, lengths, Hkv, D, P, pages, dtype,
                                       int8, seed)
    descs, offsets = build_descriptors(
        [(i, q0, n) for i, (_, q0, n) in enumerate(spans)], BQ, NB)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    q = torch.randn(1, Hq, NB * BQ, D, generator=g).to(dev, dtype)
    return q, k, v, table, scales, torch.as_tensor(descs, device=dev)


@pytest.mark.parametrize("case", [
    dict(spans=[(0, 0, 256)] + [(i, 100 * i + 50, 1) for i in range(1, 8)],
         NB=64, BQ=8, Hq=12, Hkv=12, D=64, P=128, dtype="float32"),
    dict(spans=[(0, 0, 256)] + [(i, 100 * i + 50, 1) for i in range(1, 8)],
         NB=64, BQ=8, Hq=12, Hkv=12, D=64, P=128, dtype="bfloat16"),
    dict(spans=[(0, 40, 20), (1, 7, 1), (2, 0, 5)], NB=8, BQ=8, Hq=8,
         Hkv=2, D=128, P=8, dtype="float32"),
    dict(spans=[(0, 40, 20), (1, 7, 1)], NB=8, BQ=4, Hq=4, Hkv=4, D=64,
         P=16, dtype="float32", int8=True),
    dict(spans=[(0, 90, 30), (1, 200, 1)], NB=16, BQ=8, Hq=4, Hkv=2, D=64,
         P=16, dtype="float32", window=40, alibi=True, softcap=6.0),
    # decode rows from 1 to 1024 keys beside a 64-token chunk
    dict(spans=[(0, 0, 64)] + [(i, n - 1, 1) for i, n in enumerate(
        (1, 64, 65, 300, 513, 1000, 1024), 1)], NB=16, BQ=8, Hq=12, Hkv=12,
         D=64, P=128, dtype="float32"),
    dict(spans=[(0, 0, 64)] + [(i, n - 1, 1) for i, n in enumerate(
        (1, 64, 65, 300, 513, 1000, 1024), 1)], NB=16, BQ=8, Hq=12, Hkv=12,
         D=64, P=16, dtype="bfloat16", int8=True),
    # more splits (16) than head dims (8), GQA 4:1, two 8-row tiles
    dict(spans=[(0, 1021, 3)], NB=1, BQ=4, Hq=32, Hkv=8, D=8, P=128,
         dtype="float32"),
    # every descriptor padding
    dict(spans=[(0, 40, 5)], NB=8, BQ=8, Hq=12, Hkv=12, D=64, P=128,
         dtype="float32", all_padding=True),
    # block_q 128: prefill tiles on tensor cores, and on FMAs in fp32
    dict(spans=[(0, 896, 128), (1, 500, 100), (2, 1000, 1)], NB=4, BQ=128,
         Hq=32, Hkv=8, D=128, P=128, dtype="bfloat16"),
    dict(spans=[(0, 896, 128), (1, 500, 100), (2, 1000, 1)], NB=4, BQ=128,
         Hq=32, Hkv=8, D=128, P=128, dtype="float32"),
], ids=["gpt2_mixed", "gpt2_mixed_bf16", "gqa_p8", "int8",
        "window_alibi_softcap", "spread_1_1024", "spread_int8_bf16_p16",
        "D8_gqa_16_splits", "all_padding", "bq128_gqa32x8_D128_bf16",
        "bq128_gqa32x8_D128_fp32"])
def test_ragged_kernel_matches_plain(dev, case):
    dtype = getattr(torch, case["dtype"])
    q, k, v, table, scales, descs = _ragged_case(
        dev, case["spans"], case["NB"], case["BQ"], case["Hq"], case["Hkv"],
        case["D"], case["P"], dtype, case.get("int8"))
    if case.get("all_padding"):
        descs = torch.zeros_like(descs)
        descs[:, 0] = -1
    kw = {key: case[key] for key in ("window", "softcap") if key in case}
    if case.get("alibi"):
        kw["alibi"] = TA.alibi_slopes(case["Hq"])
    before = RPA.ragged_paged_attention.launches
    out = RPA.ragged_paged_attention(q, k, v, table, case["P"], descs,
                                     **scales, **kw)
    torch.cuda.synchronize()
    assert RPA.ragged_paged_attention.launches == before + 1
    # two launches on the same inputs give the same bits
    assert torch.equal(RPA.ragged_paged_attention(
        q, k, v, table, case["P"], descs, **scales, **kw), out)
    ref = RPA.ragged_paged_attention_reference(q, k, v, table, case["P"],
                                               descs, **scales, **kw)
    ref_abs = RPA.ragged_paged_attention_reference(
        q, k, _abs(v), table, case["P"], descs, **scales, **kw)
    _check_close(out, ref, ref_abs)
    # the split reference: the same cut and merge
    cpu = {key: (val.cpu() if isinstance(val, torch.Tensor) else val)
           for key, val in {**scales, **kw}.items()}
    split = RPA.ragged_paged_attention_split_reference(
        q.cpu(), k.cpu(), v.cpu(), table.cpu(), case["P"], descs.cpu(),
        sms=DA.sm_count(dev), **cpu)
    _check_close(out.cpu(), split, ref_abs.cpu())
    # padding slots (row -1 descriptors, t >= q_valid) are exactly zero
    d = descs.cpu()
    t = torch.arange(case["BQ"])
    pad = ((t[None, :] >= d[:, 2:3]) | (d[:, 0:1] < 0)).reshape(-1)
    assert pad.any()
    assert torch.all(out[0][:, pad.to(dev)] == 0)


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_ragged_kernel_on_a_stage_pool_slice(dev, int8):
    """A pipeline stage's attention runs the ragged kernel on its view of
    the pools (``stage_kv_view``: layers [1, 3) of 4, the same tensors):
    every layer of the slice against the plain version, at the GPT-2 mixed
    step."""
    spans = [(0, 0, 256)] + [(i, 100 * i + 50, 1) for i in range(1, 8)]
    pools = [_ragged_case(dev, spans, 64, 8, 12, 12, 64, 128, torch.float32,
                          int8, seed=layer) for layer in range(4)]
    q, _, _, table, _, descs = pools[0]
    args = ([p[1] for p in pools], [p[2] for p in pools],
            table.cpu().numpy(), 128, table.shape[1])
    kv = (KV.QuantPagedKVState(*args, [p[4]["k_scale"] for p in pools],
                               [p[4]["v_scale"] for p in pools], device=dev)
          if int8 else KV.PagedKVState(*args, device=dev))
    view = KV.stage_kv_view(kv, 1, 3)
    for j, layer in enumerate(range(1, 3)):
        assert view.k[j] is kv.k[layer]
        scales = ({"k_scale": view.k_scale[j], "v_scale": view.v_scale[j]}
                  if int8 else {})
        out = RPA.ragged_paged_attention(q, view.k[j], view.v[j],
                                         view.block_table, 128, descs,
                                         **scales)
        ref = RPA.ragged_paged_attention_reference(
            q, view.k[j], view.v[j], view.block_table, 128, descs, **scales)
        _check_close(out, ref, ref)


def test_paged_kernels_reject_what_they_cannot_take(dev):
    q, k, v, table, _, descs = _ragged_case(
        dev, [(0, 0, 5)], 2, 4, 4, 4, 64, 8, torch.float32, False)
    with pytest.raises(ValueError, match="int32"):
        RPA.ragged_paged_attention(q, k, v, table.long(), 8, descs)
    with pytest.raises(ValueError, match="multiple"):
        RPA.ragged_paged_attention(q[:, :, :7].contiguous(), k, v, table, 8,
                                   descs)
    with pytest.raises(ValueError, match="length"):
        PA.paged_decode_attention(q[:, :, :2].contiguous(), k, v, table, 8,
                                  0, 1)
    with pytest.raises(ValueError, match="cuda|device"):
        PA.paged_decode_attention(q[:, :, :1].contiguous(), k.cpu(), v,
                                  table, 8, 0, 1)


# ---------------------------------------------------------------------------
# chunked gated linear attention (hybrid attention/SSM slice).  Against the
# plain version with the same block_t: element by element within
# 1e-4 * (sum |terms| + |ref|), sum |terms| being the plain version run on
# |q|, |k|, |v| (every decay is positive): both compute in fp32 from the same
# inputs, but their cumsums of the log-gates round in another order (|la|
# up to ~90 over a chunk), which moves each decay factor by up to ~1e-5.
# Against the token-sequential oracle (products of gates, not exp of
# cumsums): 1e-3 on the same scale, gates above the 1e-6 log floor.
# ---------------------------------------------------------------------------

from penroz_tpu_torch.ops import ssm as SSM  # noqa: E402
from penroz_tpu_torch.ops.kernels import ssm_scan as SS  # noqa: E402


def _gla_inputs(dev, B, T, H, dk, dv, dtype, below_floor=False, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(B, T, H, dk, generator=g) * dk ** -0.5
    k = torch.randn(B, T, H, dk, generator=g)
    v = torch.randn(B, T, H, dv, generator=g)
    logits = torch.randn(B, T, H, generator=g)
    if below_floor:  # sigmoid(-20) ~ 2e-9, under the 1e-6 log floor
        logits[torch.rand(B, T, H, generator=g) < 0.1] = -20.0
    return (q.to(dev, dtype), k.to(dev, dtype), v.to(dev, dtype),
            torch.sigmoid(logits).to(dev))


def _gla_worst(out, ref, q, k, v, g, block_t, c):
    terms = SS.gla_chunked_reference(q.abs(), k.abs(), v.abs(), g, block_t)
    err = (out - ref).abs()
    return float((err / (c * (terms + ref.abs())).clamp_min(1e-30)).max())


@pytest.mark.parametrize("B,T,H,dk,dv,block_t,dtype,below_floor", [
    (8, 1024, 12, 64, 64, 128, torch.float32, False),   # /evaluate/'s shape
    (1, 1024, 12, 64, 64, 128, torch.float32, False),   # /output/'s shape
    (8, 1000, 12, 64, 64, 128, torch.float32, False),   # ragged tail
    (8, 1024, 12, 64, 64, 128, torch.bfloat16, False),
    (2, 1024, 12, 64, 64, 128, torch.float32, True),
    (2, 1024, 32, 128, 128, 128, torch.float32, False),
    (2, 13, 3, 8, 4, 8, torch.float32, False),
    (1, 5, 2, 8, 8, 128, torch.float32, False),
    (1, 300, 2, 32, 96, 64, torch.bfloat16, False),
    (1, 4096, 12, 64, 64, 128, torch.float32, False),
    (4, 4096, 12, 64, 64, 128, torch.float32, False),
    (1, 512, 4, 128, 128, 256, torch.float32, False),
    (1, 100, 3, 8, 5, 8, torch.float32, False),
    (2, 77, 3, 12, 20, 128, torch.bfloat16, False)],
    ids=["gpt2_B8_T1024", "gpt2_B1_T1024", "gpt2_T1000", "gpt2_bf16",
         "below_floor", "H32_D128", "tiny_tail", "T5", "dk32_dv96_bf16",
         "gpt2_B1_T4096", "tiles_outnumber_resident", "D128_block_t256",
         "odd_dv_scalar_copies", "bf16_scalar_copies"])
def test_gla_kernel_matches_plain(dev, B, T, H, dk, dv, block_t, dtype,
                                  below_floor):
    """Also: two launches give the same bits (the carry's recipe is fixed);
    B 1 x 4096 walks 64 tiles of one sequence through seven checkpoints;
    B 4 x 4096 has 3072 tiles, several times the blocks the card holds at
    once; D 128 at block_t 256 (the kernel's tiles do not depend on
    block_t) was refused for shared memory before the kernel's redesign;
    odd or unaligned widths take the element-wise copies."""
    q, k, v, g = _gla_inputs(dev, B, T, H, dk, dv, dtype, below_floor)
    before = SS.gla_chunked.launches
    out = SS.gla_chunked(q, k, v, g, block_t=block_t)
    again = SS.gla_chunked(q, k, v, g, block_t=block_t)
    torch.cuda.synchronize()
    assert SS.gla_chunked.launches == before + 2
    assert torch.equal(out, again)
    assert out.dtype == torch.float32 and out.shape == (B, T, H, dv)
    assert bool(torch.isfinite(out).all())
    ref = SS.gla_chunked_reference(q, k, v, g, block_t)
    assert _gla_worst(out, ref, q, k, v, g, block_t, 1e-4) <= 1.0
    if not below_floor and T >= 1000:
        seq = SSM.gla_full_reference(q, k, v, g)
        assert _gla_worst(out, seq, q, k, v, g, block_t, 1e-3) <= 1.0


def test_gla_kernel_takes_strided_views_and_ssm_layer_launches_it(dev):
    """q, k, v as GatedSSM slices them out of the fused projection (token
    stride = the fused width); the no-cache inference forward of a
    GatedSSM launches the kernel once, training the oracle."""
    from penroz_tpu_torch.ops.modules import Ctx, GatedSSM
    B, T, H, d = 2, 200, 4, 32
    fused = torch.randn(B, T, H * (3 * d + 1), device=dev)
    q = fused[..., :H * d].reshape(B, T, H, d)
    k = fused[..., H * d:2 * H * d].reshape(B, T, H, d)
    v = fused[..., 2 * H * d:3 * H * d].reshape(B, T, H, d)
    g = torch.sigmoid(fused[..., 3 * H * d:]).reshape(B, T, H)
    out = SS.gla_chunked(q, k, v, g)
    ref = SS.gla_chunked_reference(q, k, v, g)
    assert _gla_worst(out, ref, q, k, v, g, 128, 1e-4) <= 1.0
    layer = GatedSSM(H, d)
    before = SS.gla_chunked.launches
    with torch.no_grad():
        y = layer(fused, Ctx())
        y_train = layer(fused, Ctx(training=True))
    torch.cuda.synchronize()
    assert SS.gla_chunked.launches == before + 1
    assert _gla_worst(y.reshape(B, T, H, d), y_train.reshape(B, T, H, d),
                      q * d ** -0.5, k, v, g, 128, 1e-3) <= 1.0


def test_gla_kernel_rejects_what_it_cannot_take(dev):
    q, k, v, g = _gla_inputs(dev, 1, 16, 2, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="fp32"):
        SS.gla_chunked(q, k, v, g.double())
    with pytest.raises(ValueError, match="dtype"):
        SS.gla_chunked(q, k.bfloat16(), v, g)
    with pytest.raises(ValueError, match="contiguous"):
        SS.gla_chunked(torch.randn(1, 16, 2, 16, device=dev)[..., ::2], k, v,
                       g)
    with pytest.raises(ValueError, match="shape|expected"):
        SS.gla_chunked(q, k, v[:, :8], g)
    big = _gla_inputs(dev, 1, 256, 1, 256, 256, torch.float32)
    with pytest.raises(ValueError, match="shared memory"):
        SS.gla_chunked(*big, block_t=256)


# -- multi-step decode through CUDA graphs --------------------------------

from penroz_tpu_torch.models import decode_graphs as DG  # noqa: E402
from penroz_tpu_torch.models import presets  # noqa: E402
from penroz_tpu_torch.models.dsl import Mapper  # noqa: E402
from penroz_tpu_torch.models.model import NeuralNetworkModel  # noqa: E402

GRAPH_CACHES = {"contiguous": {}, "int8": {"TURBO_QUANT_KV_CACHE": "1"},
                "paged": {"PAGED_KV_CACHE": "1", "PENROZ_KV_PAGE_SIZE": "16"}}


@pytest.mark.parametrize("cache", sorted(GRAPH_CACHES))
@pytest.mark.parametrize("family", ["gpt", "hybrid"])
def test_graph_decode_equals_eager_steps(dev, monkeypatch, family, cache):
    """The captured step replayed chunk by chunk gives the eager step
    loop's greedy tokens (graphs off), across the overflow crop, and top-k
    sampled tokens; a second request captures nothing.  The kernel's run
    counter shows the device ran it once per attention layer in every
    dispatched step, replays included; the wrapper counts only the steps
    that were not replays."""
    for key, value in GRAPH_CACHES[cache].items():
        monkeypatch.setenv(key, value)
    monkeypatch.setenv("PENROZ_DECODE_CHUNK", "16")
    build = presets.gpt2_custom if family == "gpt" else presets.hybrid_custom
    layers = build(d=128, heads=2, depth=2, vocab=256, block=64)
    model = NeuralNetworkModel("g", Mapper(layers, presets.ADAMW),
                               device="cuda")
    n_attn = len(model.arch.attn_layers)
    prompt = list(range(1, 40))
    counter = (PA.paged_decode_attention if cache == "paged"
               else DA.decode_attention)
    DG.reset()
    runs = {}
    for graphs in (True, False):
        monkeypatch.setattr(DG, "_GRAPHS", graphs)
        model._generator = model._new_generator()  # the same request seed
        launched, ran = counter.launches, counter.runs.read()
        steps, replayed = DG.dispatched_steps(), DG.STATS["replayed_steps"]
        runs[graphs] = [model.generate_tokens(prompt, 64, 40, temperature=0),
                        model.generate_tokens(prompt, 64, 40,
                                              temperature=0.8, top_k=8)]
        steps = DG.dispatched_steps() - steps
        replayed = DG.STATS["replayed_steps"] - replayed
        assert (replayed > 0) == graphs
        assert counter.runs.read() - ran == n_attn * steps
        assert counter.launches - launched == n_attn * (steps - replayed)
    assert runs[True] == runs[False]
    assert DG.STATS["captures"] == 2  # greedy and top-k, once each
    monkeypatch.setattr(DG, "_GRAPHS", True)
    model.generate_tokens(prompt, 64, 40, temperature=0)
    assert DG.STATS["captures"] == 2
    DG.reset()


def test_run_counter_counts_replays(dev):
    """A captured decode launch adds nothing to the wrapper's count; each
    replay adds one to the kernel's run counter."""
    q, k, v = _inputs(dev, 1, 2, 2, 1, 64, 64, torch.float32)
    length = torch.tensor([40], dtype=torch.int32, device=dev)
    DA.decode_attention(q, k, v, 39, length)  # first use, outside capture
    torch.cuda.synchronize()
    launched = DA.decode_attention.launches
    ran = DA.decode_attention.runs.read()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = DA.decode_attention(q, k, v, 39, length)
    assert DA.decode_attention.launches == launched
    assert DA.decode_attention.runs.read() == ran
    for _ in range(3):
        graph.replay()
    assert DA.decode_attention.runs.read() == ran + 3
    assert DA.decode_attention.launches == launched
    _compare(out, q, k, v, 39, length)


# -- the recurrent update (csrc/ssm_update.cu) -------------------------------

def _ssm_state(dev, B, H, dk, dv, C, seed):
    from penroz_tpu_torch.ops import ssm as SSM
    g = torch.Generator(device="cpu").manual_seed(seed)
    st = SSM.SSMState.create([(H, dk, dv)], B, ckpt_slots=C, device=dev)
    st.state[0].copy_(torch.randn(st.state[0].shape, generator=g))
    st.ckpt[0].copy_(torch.randn(st.ckpt[0].shape, generator=g))
    return st


def _ssm_copy(st):
    from penroz_tpu_torch.ops import ssm as SSM
    return SSM.SSMState([s.clone() for s in st.state],
                        [c.clone() for c in st.ckpt], st.ckpt_pos.clone(),
                        st.specs, st.ckpt_slots)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", ["packed", "dense", "dense_counts"])
def test_ssm_update_kernel_matches_plain(dev, form, dtype):
    """The recurrent-update kernel against its plain version: the state,
    the ring and its keys bit for bit (the same rounding a token), y
    within 1e-5 relative (summed over dk in another order), 0 at every
    dropped slot; a packed layout with a row over two blocks, a partly
    valid block and a padding block; dense with per-row starts and counts
    (a parked row left untouched); two launches bit for bit."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    B, H, dk, dv, C = 4, 3, 64, 48, 8
    g = torch.Generator(device="cpu").manual_seed(7)
    if form == "packed":
        descs, _ = build_descriptors([(1, 5, 70), (0, 9, 1), (3, 0, 20)],
                                     64, 5)
        descs = torch.from_numpy(descs).to(dev)
        lead = (1, 5 * 64)
    else:
        lead = (B, 37)
    q, k, v = (torch.randn(*lead, H, d, generator=g).to(dev, dtype)
               for d in (dk, dk, dv))
    gates = torch.sigmoid(torch.randn(*lead, H, generator=g) + 2).to(dev)
    starts = torch.tensor([0, 11, 40, 3], device=dev)
    counts = (torch.tensor([37, 5, 0, 20], device=dev)
              if form == "dense_counts" else None)
    st = _ssm_state(dev, B, H, dk, dv, C, 3)
    outs = []
    for _ in range(2):
        run = _ssm_copy(st)
        if form == "packed":
            y = SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos, q, k,
                              v, gates, descs=descs, block_q=64)
        else:
            y = SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos, q, k,
                              v, gates, starts=starts, counts=counts)
        torch.cuda.synchronize()
        outs.append((y, run))
    (y, run), (y2, run2) = outs
    assert torch.equal(y, y2) and torch.equal(run.state[0], run2.state[0])
    assert torch.equal(run.ckpt[0], run2.ckpt[0])
    ref = _ssm_copy(st)
    if form == "packed":
        want = SSM.update_packed_reference(ref.state[0], ref.ckpt[0],
                                           ref.ckpt_pos, q, k, v, gates,
                                           descs, 64)
    else:
        want = SSM.update_dense_reference(ref.state[0], ref.ckpt[0],
                                          ref.ckpt_pos, q, k, v, gates,
                                          starts, counts)
    _ssm_assert_matches(y, run, want, ref)


def _ssm_assert_matches(y, run, want, ref):
    """The state, the ring and its keys equal to the plain version's, y
    within 1e-5 relative and 0 exactly where the plain version's is."""
    assert torch.equal(run.ckpt_pos, ref.ckpt_pos)
    assert torch.equal(run.state[0], ref.state[0])
    assert torch.equal(run.ckpt[0], ref.ckpt[0])
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(y == 0, want == 0)


def _ssm_inputs(dev, lead, H, dk, dv, dtype, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = (torch.randn(*lead, H, dk, generator=g) * dk ** -0.5).to(dev, dtype)
    k, v = (torch.randn(*lead, H, d, generator=g).to(dev, dtype)
            for d in (dk, dv))
    gates = torch.sigmoid(torch.randn(*lead, H, generator=g) + 2).to(dev)
    return q, k, v, gates


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("dk,dv", [(32, 48), (64, 64), (128, 128)])
@pytest.mark.parametrize("form", ["dense", "packed"])
def test_ssm_update_kernel_stage_edges(dev, form, dk, dv, dtype):
    """The redesign's edges (P = 16 slots a stage, 3 stages in flight, a
    ring of C = 8): dense rows of n = P - 1, P, P + 1, n < C, n = 53 (four
    stages, more than P x stages) and a row with count 0; packed, a row of
    70 slots over two blocks of 64, a partly valid block, a padding block
    and a block of a row past the state's batch (never read or written).
    The state, the ring and its keys bit for bit."""
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    from penroz_tpu_torch.ops.kv_cache import build_descriptors
    H, C = 3, 8
    if form == "dense":
        B, T = 6, 53
        lead = (B, T)
        counts = torch.tensor([15, 16, 17, 5, 53, 0], device=dev)
        starts = torch.tensor([0, 9, 30, 2, 100, 7], device=dev)
    else:
        B = 4
        descs, _ = build_descriptors([(1, 5, 70), (0, 9, 17), (B, 3, 30),
                                      (3, 0, 5)], 64, 6)
        descs = torch.from_numpy(descs).to(dev)
        lead = (1, 6 * 64)
    q, k, v, gates = _ssm_inputs(dev, lead, H, dk, dv, dtype, 11)
    st = _ssm_state(dev, B, H, dk, dv, C, 5)
    run, ref = _ssm_copy(st), _ssm_copy(st)
    if form == "dense":
        y = SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos, q, k, v,
                          gates, starts=starts, counts=counts)
        want = SSM.update_dense_reference(ref.state[0], ref.ckpt[0],
                                          ref.ckpt_pos, q, k, v, gates,
                                          starts, counts)
    else:
        y = SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos, q, k, v,
                          gates, descs=descs, block_q=64)
        want = SSM.update_packed_reference(ref.state[0], ref.ckpt[0],
                                           ref.ckpt_pos, q, k, v, gates,
                                           descs, 64)
    torch.cuda.synchronize()
    _ssm_assert_matches(y, run, want, ref)
    untouched = [5] if form == "dense" else [2]
    for b in untouched:
        assert torch.equal(run.state[0][b], st.state[0][b])
        assert torch.equal(run.ckpt[0][b], st.ckpt[0][b])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_ssm_update_kernel_cuts_agree_bit_for_bit(dev, dtype):
    """One row's 256-slot span as 1 launch, 4 launches of 64 and 256 of 1:
    the state, the ring, its keys and every slot's y bit for bit."""
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    H, dk, dv, C, T, start = 12, 64, 64, 8, 256, 300
    q, k, v, gates = _ssm_inputs(dev, (1, T), H, dk, dv, dtype, 21)
    st = _ssm_state(dev, 1, H, dk, dv, C, 9)
    results = []
    for cut in (T, 64, 1):
        run = _ssm_copy(st)
        ys = [SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos,
                            q[:, t:t + cut], k[:, t:t + cut],
                            v[:, t:t + cut], gates[:, t:t + cut],
                            starts=torch.tensor([start + t], device=dev))
              for t in range(0, T, cut)]
        torch.cuda.synchronize()
        results.append((torch.cat(ys, dim=1), run))
    (y, one), rest = results[0], results[1:]
    for y_cut, run in rest:
        assert torch.equal(run.state[0], one.state[0])
        assert torch.equal(run.ckpt[0], one.ckpt[0])
        assert torch.equal(run.ckpt_pos, one.ckpt_pos)
        assert torch.equal(y_cut, y)


def test_ssm_update_kernel_graph_replay_equals_eager(dev):
    """A CUDA-graph capture of the dense form (a decode step of 4 rows,
    one parked): its replay equals an eager launch bit for bit; the
    capture counts no launch, each replay one run."""
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    B, H, dk, dv, C = 4, 12, 64, 64, 8
    q, k, v, gates = _ssm_inputs(dev, (B, 1), H, dk, dv, torch.float32, 31)
    starts = torch.tensor([17, 0, 400, 63], device=dev)
    counts = torch.tensor([1, 1, 0, 1], device=dev)
    st = _ssm_state(dev, B, H, dk, dv, C, 13)
    eager, warm, graphed = _ssm_copy(st), _ssm_copy(st), _ssm_copy(st)

    def step(run):
        return SU.ssm_update(run.state[0], run.ckpt[0], run.ckpt_pos, q, k,
                             v, gates, starts=starts, counts=counts)

    y_eager = step(eager)
    step(warm)  # first use (build, run counter) outside the capture
    torch.cuda.synchronize()
    launched, ran = SU.ssm_update.launches, SU.ssm_update.runs.read()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        y = step(graphed)
    assert SU.ssm_update.launches == launched
    assert torch.equal(graphed.state[0], st.state[0])  # nothing ran yet
    graph.replay()
    torch.cuda.synchronize()
    assert SU.ssm_update.runs.read() == ran + 1
    assert torch.equal(y, y_eager)
    assert torch.equal(graphed.state[0], eager.state[0])
    assert torch.equal(graphed.ckpt[0], eager.ckpt[0])
    assert torch.equal(graphed.ckpt_pos, eager.ckpt_pos)


def test_ssm_update_kernel_rejects_what_it_cannot_take(dev):
    from penroz_tpu_torch.ops import ssm as SSM
    from penroz_tpu_torch.ops.kernels import ssm_update as SU
    st = SSM.SSMState.create([(2, 160, 8)], 1, device=dev)
    x = torch.zeros(1, 1, 2, 160, device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, x, x,
                      torch.zeros(1, 1, 2, 8, device=dev),
                      torch.ones(1, 1, 2, device=dev),
                      starts=torch.zeros(1, device=dev))
    st = SSM.SSMState.create([(2, 16, 8)], 1, device=dev)
    x = torch.zeros(1, 3, 2, 16, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="dtype"):
        SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, x, x,
                      torch.zeros(1, 3, 2, 8, device=dev,
                                  dtype=torch.float16),
                      torch.ones(1, 3, 2, device=dev),
                      starts=torch.zeros(1, device=dev))
    nb = SU.MAX_BLOCKS + 1  # the row's block list lives in shared memory
    x = torch.zeros(1, nb, 2, 16, device=dev)
    with pytest.raises(ValueError, match="descriptor blocks"):
        SU.ssm_update(st.state[0], st.ckpt[0], st.ckpt_pos, x, x,
                      torch.zeros(1, nb, 2, 8, device=dev),
                      torch.ones(1, nb, 2, device=dev),
                      descs=torch.full((nb, 4), -1, device=dev), block_q=1)
