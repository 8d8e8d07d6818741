"""The port's cross-entropy on the CPU (the plain versions the CUDA kernels
are held to on the card) against the JAX package: ``ce_forward`` /
``ce_backward`` against its Pallas kernels in interpret mode and its jnp
scan oracle, and ``fused_cross_entropy_mean`` value and gradient against
``losses.fused_cross_entropy_mean`` under ``jax.grad``.

Shapes as in tests/test_losses.py: exact block tiling, padded rows plus a
vocab tail chunk, rows padded to the block.  Tolerances: fp32 forward
rtol/atol 1e-5 (the same fp32 math summed in another order); the gradient
atol 1e-6 in fp32 and one bf16 rounding step (rtol 2^-7, atol 1e-6) in
bf16, where both sides round the same fp32 value once."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.ops import losses as JL
from penroz_tpu.ops.pallas import cross_entropy as JCE
from penroz_tpu_torch.ops import losses as TL
from penroz_tpu_torch.ops.kernels import cross_entropy as CE

BF16_RTOL = 2.0 ** -7


def _to_torch(a, dtype):
    t = torch.tensor(np.asarray(a, np.float32))
    return t.to(torch.bfloat16) if dtype == jnp.bfloat16 else t


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("n,v,dtype", [
    (16, 1024, jnp.float32),
    (40, 2048 + 512, jnp.bfloat16),
    (300, 1536, jnp.float32),
    (40, 2048 + 512, jnp.float32),
    (300, 1536, jnp.bfloat16),
])
def test_ce_forward_backward_match_pallas_interpret(n, v, dtype):
    rng = np.random.default_rng(7)
    logits = jnp.asarray(rng.normal(size=(n, v)) * 3, dtype)
    targets = rng.integers(0, v, (n,)).astype(np.int32)
    targets[-1] = -1  # a padded row: no loss, zero gradient
    jt = jnp.asarray(targets)
    lse_k, ll_k = JCE.ce_forward(logits, jt, block_n=8, block_v=512,
                                 interpret=True)
    lse_j, ll_j = JL._jnp_forward(logits, jt, 64)
    x, t = _to_torch(logits, dtype), torch.as_tensor(targets)
    lse, ll = CE.ce_forward(x, t)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_k), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(lse), np.asarray(lse_j), rtol=1e-5,
                               atol=1e-5)
    # the Pallas kernel reads no label on a -1 row; the scan reads column 0
    np.testing.assert_allclose(_np(ll)[:-1], np.asarray(ll_k)[:-1],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(ll), np.asarray(ll_j), rtol=1e-6,
                               atol=1e-6)

    scale = jnp.asarray(0.37, jnp.float32)
    dx_k = JCE.ce_backward(logits, jt, lse_k, scale, block_n=8, block_v=512,
                           interpret=True)
    dx = CE.ce_backward(x, t, lse, torch.tensor(0.37))
    assert dx.dtype == x.dtype
    rtol = BF16_RTOL if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_np(dx), np.asarray(dx_k, np.float32),
                               rtol=rtol, atol=1e-6)
    assert not dx[-1].any()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["fp32", "bf16"])
def test_fused_mean_value_and_grad_match_jax(dtype):
    rng = np.random.default_rng(1)
    logits = jnp.asarray(rng.normal(size=(2, 96, 257)), dtype)
    targets = rng.integers(0, 257, (2, 96)).astype(np.int32)
    jloss, jgrad = jax.value_and_grad(
        lambda z: JL.fused_cross_entropy_mean(z, jnp.asarray(targets), 64))(
        logits)
    x = _to_torch(logits, dtype).requires_grad_(True)
    loss = TL.fused_cross_entropy_mean(x, torch.as_tensor(targets))
    (grad,) = torch.autograd.grad(loss * 2.0, (x,))
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    assert grad.dtype == x.dtype and grad.shape == x.shape
    rtol = BF16_RTOL if dtype == jnp.bfloat16 else 1e-5
    np.testing.assert_allclose(_np(grad) / 2.0, np.asarray(jgrad, np.float32),
                               rtol=rtol, atol=1e-7)


def test_fused_mean_equals_torch_cross_entropy():
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 77, generator=g, requires_grad=True)
    t = torch.randint(0, 77, (3, 5), generator=g)
    loss = TL.fused_cross_entropy_mean(x, t)
    want = torch.nn.functional.cross_entropy(x.reshape(-1, 77), t.reshape(-1))
    torch.testing.assert_close(loss, want, rtol=1e-6, atol=1e-6)
    (grad,) = torch.autograd.grad(loss, (x,))
    (wgrad,) = torch.autograd.grad(want, (x,))
    torch.testing.assert_close(grad, wgrad, rtol=1e-5, atol=1e-7)


def test_pad_rows_sentinel():
    x = torch.ones(5, 3)
    t = torch.arange(5, dtype=torch.int32)
    xp, tp, chunks = CE.pad_rows(x, t, 4)
    assert chunks == 2 and xp.shape == (8, 3)
    assert tp.tolist() == [0, 1, 2, 3, 4, -1, -1, -1]
    assert not xp[5:].any()
