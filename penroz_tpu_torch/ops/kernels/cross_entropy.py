"""Softmax cross-entropy over a large vocabulary: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replaces penroz_tpu/ops/pallas/cross_entropy.py ``ce_forward`` and
``ce_backward``.  The kernels (csrc/cross_entropy.cu) are bound by bytes:
they read the logits once per pass in their own dtype and never write an
fp32 copy of them; the source note says how.

:func:`ce_forward` and :func:`ce_backward` launch the kernels for CUDA
tensors and raise on anything they cannot take; for CPU tensors they run
:func:`ce_forward_reference` / :func:`ce_backward_reference`, the port of
the JAX package's row-chunked scan oracle (penroz_tpu/ops/losses.py
``_jnp_forward``/``_jnp_backward``, with ``pad_rows`` and the -1 target
sentinel).  Nothing falls back from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from penroz_tpu_torch.ops.kernels import build

_COUNT_LOCK = threading.Lock()
_P, _I = ctypes.c_void_p, ctypes.c_int
_FWD_ARGTYPES = [_P] * 4 + [_I] * 3 + [_P]
_BWD_ARGTYPES = [_P] * 5 + [_I] * 3 + [_P]
# Rows per plain-version chunk (the JAX oracle's _CHUNK_ROWS).
CHUNK_ROWS = 512


def pad_rows(x2d, t1d, chunk: int):
    """Pad rows to a multiple of ``chunk``; padded targets get the -1
    sentinel (no loss, zero gradient).  Returns (x, t, num_chunks)."""
    n = x2d.shape[0]
    num_chunks = max(1, -(-n // chunk))
    pad = num_chunks * chunk - n
    if pad:
        x2d = torch.cat([x2d, x2d.new_zeros(pad, x2d.shape[1])])
        t1d = torch.cat([t1d, t1d.new_full((pad,), -1)])
    return x2d, t1d, num_chunks


def ce_forward_reference(x2d, t1d, chunk_rows: int = CHUNK_ROWS):
    """Per-row (lse, label logit), fp32 (N, 1) each, computed in fp32 one
    row chunk at a time; the label logit is read at ``max(t, 0)`` (clamped
    to the row, as the kernel does)."""
    xp, tp, num_chunks = pad_rows(x2d, t1d, chunk_rows)
    lse, ll = [], []
    for c in range(num_chunks):
        x = xp[c * chunk_rows:(c + 1) * chunk_rows].float()
        t = tp[c * chunk_rows:(c + 1) * chunk_rows].long()
        m = x.amax(dim=-1)
        lse.append(m + torch.log(torch.exp(x - m[:, None]).sum(dim=-1)))
        safe_t = t.clamp(0, x.shape[1] - 1)
        ll.append(torch.gather(x, 1, safe_t[:, None])[:, 0])
    n = x2d.shape[0]
    return (torch.cat(lse)[:n].reshape(-1, 1),
            torch.cat(ll)[:n].reshape(-1, 1))


def ce_backward_reference(x2d, t1d, lse, scale, chunk_rows: int = CHUNK_ROWS):
    """``(softmax - onehot) * scale`` in the logits' dtype, zero on rows
    whose target is negative; ``scale`` is a scalar tensor."""
    xp, tp, num_chunks = pad_rows(x2d, t1d, chunk_rows)
    v = xp.shape[-1]
    pad = xp.shape[0] - x2d.shape[0]
    lp = torch.cat([lse, lse.new_zeros(pad, 1)]) if pad else lse
    cols = torch.arange(v, device=x2d.device)
    grads = []
    for c in range(num_chunks):
        rows = slice(c * chunk_rows, (c + 1) * chunk_rows)
        x = xp[rows].float()
        t = tp[rows].long()
        p = torch.exp(x - lp[rows])
        onehot = (cols[None, :] == t.clamp(min=0)[:, None]).float()
        valid = (t >= 0)[:, None]
        grads.append(torch.where(valid, (p - onehot) * scale, 0.0)
                     .to(x2d.dtype))
    return torch.cat(grads)[:x2d.shape[0]]


def _check_inputs(x2d, t1d):
    if x2d.device.type != "cuda":
        raise ValueError(f"cross_entropy: unsupported device {x2d.device}")
    if x2d.ndim != 2 or t1d.shape != x2d.shape[:1]:
        raise ValueError(f"cross_entropy: logits (N, V) and targets (N,) "
                         f"expected, got {tuple(x2d.shape)} and "
                         f"{tuple(t1d.shape)}")
    if x2d.dtype not in build.DTYPE_CODES:
        raise ValueError(f"cross_entropy: logits dtype {x2d.dtype} not in "
                         f"{sorted(map(str, build.DTYPE_CODES))}")
    if x2d.shape[0] < 1 or x2d.shape[1] < 1:
        raise ValueError("cross_entropy: empty logits")
    build.check_operand("cross_entropy", "logits", x2d, x2d.device,
                        x2d.dtype, x2d.shape)
    build.check_operand("cross_entropy", "targets", t1d, x2d.device,
                        torch.int32, x2d.shape[:1])


def _launch_forward(x2d, t1d):
    n, v = x2d.shape
    lib = build.load("cross_entropy")
    fn = build.function(lib, "penroz_ce_forward", _FWD_ARGTYPES)
    lse = torch.empty(n, 1, dtype=torch.float32, device=x2d.device)
    ll = torch.empty(n, 1, dtype=torch.float32, device=x2d.device)
    err = fn(x2d.data_ptr(), t1d.data_ptr(), lse.data_ptr(), ll.data_ptr(),
             n, v, build.DTYPE_CODES[x2d.dtype], build.stream(x2d))
    build.check(lib, err, "cross_entropy forward")
    return lse, ll


def _launch_backward(x2d, t1d, lse, scale):
    n, v = x2d.shape
    lib = build.load("cross_entropy")
    fn = build.function(lib, "penroz_ce_backward", _BWD_ARGTYPES)
    grad = torch.empty_like(x2d)
    err = fn(x2d.data_ptr(), t1d.data_ptr(), lse.data_ptr(), scale.data_ptr(),
             grad.data_ptr(), n, v, build.DTYPE_CODES[x2d.dtype],
             build.stream(x2d))
    build.check(lib, err, "cross_entropy backward")
    return grad


def ce_forward(x2d, t1d):
    """Per-row (lse, label logit), fp32 (N, 1) each.  CUDA tensors launch
    the forward kernel (fp32 or bf16 logits (N, V), int32 targets (N,),
    contiguous); CPU tensors run :func:`ce_forward_reference`."""
    if x2d.device.type == "cpu":
        return ce_forward_reference(x2d, t1d)
    _check_inputs(x2d, t1d)
    out = _launch_forward(x2d, t1d)
    with _COUNT_LOCK:
        ce_forward.launches += 1
    return out


ce_forward.launches = 0


def ce_backward(x2d, t1d, lse, scale):
    """(N, V) gradient in the logits' dtype; ``scale`` is a scalar fp32
    tensor on the logits' device (never read on the host).  CUDA tensors
    launch the backward kernel; CPU tensors run
    :func:`ce_backward_reference`."""
    if x2d.device.type == "cpu":
        return ce_backward_reference(x2d, t1d, lse, scale)
    _check_inputs(x2d, t1d)
    for name, t, shape in (("lse", lse, (x2d.shape[0], 1)),
                           ("scale", scale, ())):
        build.check_operand("cross_entropy", name, t, x2d.device,
                            torch.float32, shape)
    grad = _launch_backward(x2d, t1d, lse, scale)
    with _COUNT_LOCK:
        ce_backward.launches += 1
    return grad


ce_backward.launches = 0
