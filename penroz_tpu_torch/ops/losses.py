"""Fused softmax cross-entropy mean (counterpart of penroz_tpu/ops/losses.py
``fused_cross_entropy_mean``).

A ``torch.autograd.Function`` whose forward saves only the logits in their
own dtype, the targets and the per-row fp32 logsumexp, and whose backward
writes the gradient in the logits' dtype: the (N, V) logits are never
upcast to an fp32 copy.  Both passes go through ops/kernels/cross_entropy.py
(CUDA kernels for CUDA tensors, the plain row-chunked version for CPU
tensors).
"""

from __future__ import annotations

import torch

from penroz_tpu_torch.ops.kernels import cross_entropy as CE


class _FusedCrossEntropyMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        v = logits.shape[-1]
        n = targets.numel()
        x2d = logits.reshape(-1, v).contiguous()
        t1d = targets.reshape(-1).to(torch.int32).contiguous()
        lse, ll = CE.ce_forward(x2d, t1d)
        ctx.save_for_backward(x2d, t1d, lse)
        ctx.logits_shape = logits.shape
        ctx.n = n
        return (lse - ll).sum() / n

    @staticmethod
    def backward(ctx, gbar):
        x2d, t1d, lse = ctx.saved_tensors
        scale = (gbar.float() / ctx.n).contiguous()
        grad = CE.ce_backward(x2d, t1d, lse, scale)
        return grad.reshape(ctx.logits_shape), None


def fused_cross_entropy_mean(logits, targets):
    """Mean integer-label CE over all leading dims of ``logits`` (..., V);
    ``targets`` (...,) int.  Equal, with fp32 accumulation, to
    ``F.cross_entropy(logits.float(), targets)`` over the flattened rows."""
    return _FusedCrossEntropyMean.apply(logits, targets)
