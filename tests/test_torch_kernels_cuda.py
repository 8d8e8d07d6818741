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
