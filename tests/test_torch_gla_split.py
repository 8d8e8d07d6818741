"""The chunked-GLA kernel's decomposition and arithmetic on the CPU.

The CUDA kernel (csrc/ssm_scan.cu) cuts the sequence into 64-token tiles
and computes them in parallel: local states, a carry pass through every
``carry_stride``-th tile's inclusive state, then the outputs, with every
matrix product in 3xTF32 on tensor cores.  It runs only on the card; its
decomposition runs here as ``gla_chunked_parallel_reference``, held from
numpy seeds to the JAX package's Pallas ``gla_chunked`` in interpret mode
and to its ``gla_chunked_reference`` (all fp32, summing in other orders and
over other chunk lengths, which the log floor per token leaves exact):
element by element within ``C · (Σ|terms| + |ref|)``, C = 1e-5, Σ|terms|
being the port's plain version on |q|, |k|, |v| (every decay is positive).

The products' arithmetic: TF32 rounding (10 mantissa bits, to nearest) is
emulated in PyTorch; at GPT-2 width 3xTF32 meets the kernel's unchanged
tolerance against the plain version, 1e-4 · (Σ|terms| + |ref|), and one
TF32 pass does not — the reason the kernel pays for three products.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops.pallas import ssm_scan as JSS
from penroz_tpu_torch.ops.kernels import ssm_scan as SS

C_JAX = 1e-5
C_KERNEL = 1e-4  # chip_smoke.GLA_C and the cuda tests' tolerance


def _inputs(seed, B, T, H, dk, dv, below_floor=False):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(B, T, H, dk)) * dk ** -0.5).astype(np.float32)
    k = rng.normal(size=(B, T, H, dk)).astype(np.float32)
    v = rng.normal(size=(B, T, H, dv)).astype(np.float32)
    logits = rng.normal(size=(B, T, H)).astype(np.float32)
    if below_floor:  # sigmoid(-20) ~ 2e-9, under the 1e-6 log floor
        logits[rng.random((B, T, H)) < 0.1] = -20.0
    g = (1.0 / (1.0 + np.exp(-logits.astype(np.float64)))).astype(np.float32)
    return q, k, v, g


def _worst(out, ref, q, k, v, g, c):
    """max over elements of |out - ref| / (c (Σ|terms| + |ref|))."""
    terms = SS.gla_chunked_reference(q.abs(), k.abs(), v.abs(), g)
    err = (out - ref).abs()
    return float((err / (c * (terms + ref.abs())).clamp_min(1e-30)).max())


CASES = [
    # block_t 8 with sub-chunks of 4 and 8; T a multiple of neither
    dict(name="tail_sub4", T=37, dk=8, dv=8, block_t=8, sub=4, stride=2),
    dict(name="tail_sub8", T=37, dk=8, dv=8, block_t=8, sub=8, stride=2),
    # T < 8: one chunk, cut to 8 by the Pallas wrapper
    dict(name="T5_sub4", T=5, dk=8, dv=8, block_t=8, sub=4, stride=2),
    dict(name="T5_sub8", T=5, dk=8, dv=8, block_t=8, sub=8, stride=3),
    # gates under the 1e-6 log floor
    dict(name="below_floor_sub4", T=40, dk=8, dv=8, block_t=8, sub=4,
         stride=3, below_floor=True),
    dict(name="below_floor_sub8", T=45, dk=8, dv=8, block_t=8, sub=8,
         stride=2, below_floor=True),
    # dk != dv, many chunks through several checkpoints
    dict(name="dk16_dv8_sub4", T=61, dk=16, dv=8, block_t=8, sub=4,
         stride=3),
    dict(name="dk8_dv24_sub8", T=50, dk=8, dv=24, block_t=8, sub=8,
         stride=4),
    dict(name="dk8_dv24_sub4_stride8", T=70, dk=8, dv=24, block_t=8, sub=4,
         stride=8),
]
for _i, _c in enumerate(CASES):
    _c["seed"] = 100 + _i


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_parallel_twin_matches_pallas_kernel(case):
    B, H = 2, 3
    q, k, v, g = _inputs(case["seed"], B, case["T"], H, case["dk"],
                         case["dv"], case.get("below_floor"))
    jargs = tuple(jnp.asarray(a) for a in (q, k, v, g))
    pallas = torch.from_numpy(np.array(JSS.gla_chunked(
        *jargs, block_t=case["block_t"], interpret=True)))
    jref = torch.from_numpy(np.array(JSS.gla_chunked_reference(
        *jargs, block_t=case["block_t"])))
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    twin = SS.gla_chunked_parallel_reference(
        tq, tk, tv, tg, sub_chunk=case["sub"], stride=case["stride"])
    assert twin.shape == pallas.shape == (B, case["T"], H, case["dv"])
    assert twin.dtype == torch.float32
    assert _worst(twin, pallas, tq, tk, tv, tg, C_JAX) <= 1.0
    assert _worst(twin, jref, tq, tk, tv, tg, C_JAX) <= 1.0


@pytest.mark.parametrize("stride", [2, 3, 5, 8, 16])
def test_parallel_twin_does_not_depend_on_the_carry_stride(stride):
    """The carry recipe changes only the summation order."""
    tq, tk, tv, tg = (torch.from_numpy(a)
                      for a in _inputs(7, 1, 150, 2, 8, 16))
    ref = SS.gla_chunked_reference(tq, tk, tv, tg, block_t=8)
    twin = SS.gla_chunked_parallel_reference(tq, tk, tv, tg, sub_chunk=4,
                                             stride=stride)
    assert _worst(twin, ref, tq, tk, tv, tg, C_JAX) <= 1.0


def test_parallel_twin_rejects_a_stride_below_two():
    tq, tk, tv, tg = (torch.from_numpy(a) for a in _inputs(0, 1, 8, 1, 8, 8))
    with pytest.raises(ValueError, match="stride"):
        SS.gla_chunked_parallel_reference(tq, tk, tv, tg, stride=1)


def test_tf32_round_keeps_ten_mantissa_bits_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 2 ** -12,
                      -(1.0 + 3 * 2 ** -11), 1.0 + 2 ** -23, 0.0])
    want = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                         -(1.0 + 2 ** -9), 1.0, 0.0])
    got = SS.tf32_round(x)
    assert torch.equal(got, want)
    assert (got.view(torch.int32) & 0x1FFF == 0).all()


@pytest.mark.parametrize("T,seed,dtype", [
    (64, 0, torch.float32), (200, 1, torch.float32),
    (256, 2, torch.float32), (200, 3, torch.bfloat16)])
def test_three_tf32_passes_meet_the_kernel_tolerance_and_one_does_not(
        T, seed, dtype):
    """GPT-2 width (12 heads, dk = dv = 64) at small T, the kernel's tiles
    and carry stride: 3xTF32 products stay within the kernel's tolerance
    against the plain version, one TF32 pass leaves it."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(seed, 1, T, 12, 64,
                                                       64))
    q, k, v = (t.to(dtype) for t in (q, k, v))
    ref = SS.gla_chunked_reference(q, k, v, g)
    stride = SS.carry_stride(64, 64)
    three = SS.gla_chunked_parallel_reference(q, k, v, g, stride=stride,
                                              products="3xtf32")
    one = SS.gla_chunked_parallel_reference(q, k, v, g, stride=stride,
                                            products="tf32")
    assert _worst(three, ref, q, k, v, g, C_KERNEL) <= 1.0
    assert _worst(one, ref, q, k, v, g, C_KERNEL) > 1.0


def test_carry_stride_and_tile():
    assert SS.KERNEL_TILE == 64
    assert SS.carry_stride(64, 64) == 8
    assert SS.carry_stride(32, 96) == 8
    assert SS.carry_stride(64, 128) == 4
    assert SS.carry_stride(128, 128) == 4
