"""Causal flash attention with its gradient: the CUDA kernels' wrappers and
their plain PyTorch versions.

Replaces penroz_tpu/ops/pallas/flash_attention.py: ``_flash_forward``
(``flash_attention``) and ``_flash_backward`` (its dq and dkv kernels).  The
kernels (csrc/flash_attention.cu) never write the (T, T) score matrix; the
backward recomputes the probabilities from the forward's logsumexp.  Its
source note says what bounds them on the card and what the design does.

:func:`flash_forward` and :func:`flash_backward` launch the kernels for
CUDA tensors and raise on anything they cannot take; for CPU tensors they
run :func:`flash_forward_reference` / :func:`flash_backward_reference`,
which round where the kernels round (p to v's dtype before P·V, dS to k's
and q's dtype, p̃ to dO's dtype).  :func:`flash_attention` is the
``torch.autograd.Function`` over the two: its backward launches the dq and
dkv kernels.  Nothing falls back from the card to the plain version.

Layouts are the JAX package's: q (B, Hq, T, D), k/v (B, Hkv, T, D), lse
(B, Hq, T, 1) fp32.  The dkv kernel sums the query heads of a GQA group
itself in fp32 (the JAX package sums per-head results outside).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from penroz_tpu_torch.ops import attention as A
from penroz_tpu_torch.ops.kernels import build
from penroz_tpu_torch.ops.kernels.decode_attention import slopes_on

HEAD_DIMS = (64, 128, 256)
_COUNT_LOCK = threading.Lock()
_P, _I, _F, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                  ctypes.c_uint)
_FWD_ARGTYPES = [_P] * 7 + [_I] * 7 + [_F, _I, _U, _F, _P]
_BWD_ARGTYPES = [_P] * 12 + [_I] * 7 + [_F, _I, _U, _F, _P]


def _seed_tensor(seed, device) -> torch.Tensor:
    """The dropout seed as an int32 scalar on ``device`` (0 when None).  A
    Python int is written by a fill on the device, not copied from the host,
    so the call does not wait for the device."""
    if seed is None:
        seed = 0
    if isinstance(seed, int):
        return torch.full((), seed, dtype=torch.int32, device=device)
    return torch.as_tensor(seed, dtype=torch.int32, device=device).reshape(())


def _scores(q, k, window, alibi, scale):
    """fp32 masked scores (B, Hkv, G, T, T) and the mask (T, T)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    qg = A._group_query_heads(q, Hkv).float()
    s = torch.einsum("bhgtd,bhsd->bhgts", qg, k.float()) * scale
    pos = torch.arange(T, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= pos[None, :] > pos[:, None] - int(window)
    if alibi is not None:
        s = s + A._alibi_bias(alibi, pos[:, None], pos[None, :], Hkv)
    return torch.where(mask, s, A._NEG_INF), mask


def _drop_factor(q, k, seed, rate):
    """(B, Hkv, G, T, T) fp32 ``keep / (1 - rate)`` from the hash mask, or
    None without dropout."""
    if rate <= 0.0:
        return None
    B, Hq, T, _ = q.shape
    keep = A.dropout_keep_mask(_seed_tensor(seed, q.device), B, Hq, T, rate,
                               q.device)
    factor = float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))
    return torch.where(keep, factor, 0.0).reshape(
        B, k.shape[1], Hq // k.shape[1], T, T)


def flash_forward_reference(q, k, v, window: Optional[int] = None,
                            alibi=None, scale: Optional[float] = None,
                            dropout_rate: float = 0.0, seed=None):
    """Plain PyTorch version of the forward kernel: (out, lse).

    The row sum counts the probabilities before dropout; the dropped,
    rescaled probabilities are rounded to v's dtype before P·V, and the
    fp32 result is divided by the row sum and rounded to q's dtype."""
    B, Hq, T, D = q.shape
    sm_scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    s, mask = _scores(q, k, window, alibi, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, 1.0, l)
    drop = _drop_factor(q, k, seed, dropout_rate)
    p_acc = p if drop is None else p * drop
    acc = torch.einsum("bhgts,bhsd->bhgtd", p_acc.to(v.dtype).float(),
                       v.float())
    out = (acc / l_safe).to(q.dtype).reshape(B, Hq, T, D)
    lse = (m + torch.log(l_safe)).reshape(B, Hq, T, 1)
    return out, lse


# Bound on the fp32 error of dP and delta (each a sum of D <= 128 products,
# at most D * 2^-23 <= 2^-16 of the sum of their magnitudes even with
# truncating accumulation, as tensor cores may do).
DP_ERR = 2.0 ** -16


def flash_backward_reference(q, k, v, out, lse, dout,
                             window: Optional[int] = None, alibi=None,
                             scale: Optional[float] = None,
                             dropout_rate: float = 0.0, seed=None,
                             terms: bool = False):
    """Plain PyTorch version of the dq and dkv kernels: (dq, dk, dv), with
    delta = rowsum(dO·O) in fp32.  dK and dV are summed over each GQA
    group in fp32 before rounding.

    ``terms=True`` also returns, for the on-card comparison's error bound,
    fp32 tensors (B, Hkv, G, T, T): p̃, dS, and the bound on dS's error
    from the fp32 error of dP - delta, ``DP_ERR * p * scale *
    (sum|dO||v| + sum|dO||O|)`` (dP - delta cancels where a row's
    probability sits on one key, so this term is not relative to dS)."""
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    sm_scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    s, mask = _scores(q, k, window, alibi, sm_scale)
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, -1, T, 1)), 0.0)
    drop = _drop_factor(q, k, seed, dropout_rate)
    dog = A._group_query_heads(dout, Hkv).float()
    dp = torch.einsum("bhgtd,bhsd->bhgts", dog, v.float())
    if drop is not None:
        dp = dp * drop
    delta = (dout.float() * out.float()).sum(dim=-1).reshape(B, Hkv, -1, T, 1)
    ds = p * (dp - delta) * sm_scale
    p_drop = p if drop is None else p * drop
    qg = A._group_query_heads(q, Hkv).float()
    dq = torch.einsum("bhgts,bhsd->bhgtd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhgts,bhgtd->bhsd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bhgts,bhgtd->bhsd", p_drop.to(dout.dtype).float(), dog)
    grads = (dq.reshape(B, Hq, T, D).to(q.dtype), dk.to(k.dtype),
             dv.to(v.dtype))
    if not terms:
        return grads
    del s, dp, dq, dk, dv
    dp_abs = torch.einsum("bhgtd,bhsd->bhgts", dog.abs(), v.float().abs())
    if drop is not None:
        dp_abs = dp_abs * drop
    delta_abs = (dout.float().abs() * out.float().abs()).sum(dim=-1)
    ds_err = (dp_abs + delta_abs.reshape(B, Hkv, -1, T, 1)) \
        * (p * (DP_ERR * sm_scale))
    return grads + (p_drop, ds, ds_err)


def _check(name, t, device, dtype, shape):
    build.check_operand("flash_attention", name, t, device, dtype, shape)


def _kernel_args(q, k, v, window, alibi, scale, dropout_rate, seed):
    """Checks shared by both kernels; returns the scalar launch arguments
    (slopes, seed tensor, hq, hkv, t, d, dtype code, window, scale,
    dropout, keep threshold, drop scale)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError("flash_attention: q and k/v must be 4-D")
    B, Hq, T, D = q.shape
    Hkv = k.shape[1]
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_attention: q dtype {q.dtype} not in "
                         f"{sorted(map(str, build.DTYPE_CODES))}")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"flash_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if T < 1:
        raise ValueError("flash_attention: empty sequence")
    _check("q", q, q.device, q.dtype, (B, Hq, T, D))
    _check("k", k, q.device, q.dtype, (B, Hkv, T, D))
    _check("v", v, q.device, q.dtype, (B, Hkv, T, D))
    if window is not None and int(window) < 1:
        raise ValueError(f"flash_attention: window must be >= 1, got "
                         f"{window}")
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"flash_attention: dropout rate {dropout_rate} not "
                         f"in [0, 1)")
    slopes = None
    if alibi is not None:
        slopes = slopes_on(alibi, q.device)
        if slopes.numel() != Hq:
            raise ValueError(f"flash_attention: {slopes.numel()} ALiBi "
                             f"slopes for {Hq} query heads")
    seed_t = _seed_tensor(seed, q.device)
    sm_scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    dropout = dropout_rate > 0.0
    return (slopes.data_ptr() if slopes is not None else None, seed_t,
            Hq, Hkv, T, D, build.DTYPE_CODES[q.dtype],
            int(window) if window is not None else 0, sm_scale, int(dropout),
            A.keep_threshold(dropout_rate) if dropout else 0,
            1.0 / (1.0 - dropout_rate) if dropout else 1.0)


def _launch_forward(q, k, v, args):
    (slopes, seed_t, Hq, Hkv, T, D, code, window, sm_scale, dropout,
     keep_below, drop_scale) = args
    lib = build.load("flash_attention")
    fn = build.function(lib, "penroz_flash_forward", _FWD_ARGTYPES)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], Hq, T, 1, dtype=torch.float32,
                      device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), seed_t.data_ptr(),
             slopes, out.data_ptr(), lse.data_ptr(), q.shape[0], Hq, Hkv, T,
             D, code, window, sm_scale, dropout, keep_below, drop_scale,
             build.stream(q))
    build.check(lib, err, "flash_attention forward")
    return out, lse


def _launch_backward(q, k, v, out, dout, lse, args):
    """(dq, dk, dv, delta): the dq kernel writes delta = rowsum(dO·O)
    (B, Hq, T) fp32 into a scratch that the dkv kernel reads."""
    (slopes, seed_t, Hq, Hkv, T, D, code, window, sm_scale, dropout,
     keep_below, drop_scale) = args
    lib = build.load("flash_attention")
    fn = build.function(lib, "penroz_flash_backward", _BWD_ARGTYPES)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
             seed_t.data_ptr(), slopes, dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), q.shape[0], Hq, Hkv, T, D, code, window,
             sm_scale, dropout, keep_below, drop_scale, build.stream(q))
    build.check(lib, err, "flash_attention backward")
    return dq, dk, dv, delta


def flash_forward(q, k, v, window: Optional[int] = None, alibi=None,
                  scale: Optional[float] = None, dropout_rate: float = 0.0,
                  seed=None):
    """(out, lse); CUDA tensors launch the forward kernel, CPU tensors run
    :func:`flash_forward_reference`.  The kernel takes fp32 or bf16,
    D in (64, 128, 256), Hq % Hkv == 0 and any T, and raises on anything
    else."""
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, window=window, alibi=alibi,
                                       scale=scale, dropout_rate=dropout_rate,
                                       seed=seed)
    args = _kernel_args(q, k, v, window, alibi, scale, dropout_rate, seed)
    out, lse = _launch_forward(q, k, v, args)
    with _COUNT_LOCK:
        flash_forward.launches += 1
    return out, lse


flash_forward.launches = 0


def flash_backward(q, k, v, out, lse, dout, window: Optional[int] = None,
                   alibi=None, scale: Optional[float] = None,
                   dropout_rate: float = 0.0, seed=None):
    """(dq, dk, dv); CUDA tensors launch the dq and the dkv kernel (one
    count for the pair), CPU tensors run :func:`flash_backward_reference`.
    On the card the dq kernel computes delta = rowsum(dO·O) from ``out``
    itself (the JAX package computes it outside its kernels)."""
    if q.device.type == "cpu":
        return flash_backward_reference(q, k, v, out, lse, dout,
                                        window=window, alibi=alibi,
                                        scale=scale,
                                        dropout_rate=dropout_rate, seed=seed)
    args = _kernel_args(q, k, v, window, alibi, scale, dropout_rate, seed)
    _check("out", out, q.device, q.dtype, q.shape)
    _check("dout", dout, q.device, q.dtype, q.shape)
    _check("lse", lse, q.device, torch.float32, q.shape[:3] + (1,))
    dq, dk, dv, _ = _launch_backward(q, k, v, out, dout, lse, args)
    with _COUNT_LOCK:
        flash_backward.launches += 1
    return dq, dk, dv


flash_backward.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seed, window, alibi, scale, dropout_rate):
        out, lse = flash_forward(q, k, v, window=window, alibi=alibi,
                                 scale=scale, dropout_rate=dropout_rate,
                                 seed=seed)
        ctx.save_for_backward(q, k, v, out, lse, seed)
        ctx.options = (window, alibi, scale, dropout_rate)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, seed = ctx.saved_tensors
        window, alibi, scale, dropout_rate = ctx.options
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout.contiguous(),
                                    window=window, alibi=alibi, scale=scale,
                                    dropout_rate=dropout_rate, seed=seed)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, window: Optional[int] = None, alibi=None,
                    scale: Optional[float] = None, dropout_rate: float = 0.0,
                    seed=None):
    """Causal attention with the flash backward (JAX ``flash_attention``,
    causal only).  q: (B, Hq, T, D); k, v: (B, Hkv, T, D); ``seed``: int32
    dropout seed (int or scalar tensor), used when ``dropout_rate`` > 0."""
    seed_t = _seed_tensor(seed, q.device) if dropout_rate > 0.0 else None
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), seed_t, window, alibi,
                                 scale, float(dropout_rate))
