"""The cached recurrent update of the gated-SSM layers: the CUDA kernel's
wrapper (csrc/ssm_update.cu).

It replaces no ``pallas_call``: it is the port's form of the JAX package's
one-program ``lax.scan``s, ``SSMState.update_dense`` and
``SSMState.update_packed`` (penroz_tpu/ops/ssm.py:216, :248), whose plain
versions (loops over the tokens, ops/ssm.py ``update_dense_reference`` and
``update_packed_reference``) take CPU tensors.  Both forms are one launch:
the packed form walks the unified block's (NB, 4) descriptors, the dense
form is one block of T slots a row at its own start, taking its first
``count[b]`` tokens.  The state, the ring and its keys are updated in
place; y is returned.  Nothing falls back from the card to the plain
version: a CUDA tensor the kernel cannot take is a ValueError.

The kernel gives a (row, head, 8-column tile of dv) four warps, each
thread a few rows of dk of one column of the state, and feeds them slots
fetched ahead by cp.async; it takes any strides and alignment of q, k and
v (the copy unit follows them), dk <= ``MAX_DK`` and a packed layout of at
most ``MAX_BLOCKS`` descriptor blocks (the row's block list lives in
shared memory).  Its state and ring bits equal the plain version's.

``ssm_update.launches`` counts the launches this wrapper made (a launch
recorded by a graph capture is not one); ``ssm_update.runs`` (a device
counter) the launches that ran, replays of a captured launch included.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from penroz_tpu_torch.ops.kernels import build

MAX_DK = 128
MAX_BLOCKS = 8192

_LOCK = threading.Lock()
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# q, k, v, g, y, state, ckpt, ckpt_pos, descs, starts, counts, runs;
# B, NB, block_q, H, dk, dv, C; (token, head) strides of q, k, v, token
# stride of g; dtype code; stream
_ARGTYPES = [_P] * 12 + [_I] * 7 + [_L] * 7 + [_I, _P]


def _tokens(t, n: int, H: int):
    """(n, H, d) view (a copy only when the leading dims do not flatten),
    its last dim contiguous."""
    t = t.reshape(n, H, t.shape[-1])
    return t if t.stride(-1) == 1 else t.contiguous()


def _check(state, ckpt, ckpt_pos, q, k, v, g):
    dev = state.device
    if dev.type != "cuda":
        raise ValueError(f"ssm_update: unsupported device {dev}")
    B, H, dk, dv = state.shape
    C = ckpt_pos.shape[1]
    if dk > MAX_DK:
        raise ValueError(f"ssm_update: head_dim {dk} > {MAX_DK}")
    build.check_operand("ssm_update", "state", state, dev, torch.float32,
                        (B, H, dk, dv))
    build.check_operand("ssm_update", "ckpt", ckpt, dev, torch.float32,
                        (B, C, H, dk, dv))
    build.check_operand("ssm_update", "ckpt_pos", ckpt_pos, dev,
                        torch.int32, (B, C))
    if q.dtype not in build.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"ssm_update: q, k, v must share a dtype in "
                         f"{sorted(map(str, build.DTYPE_CODES))}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    lead = tuple(q.shape[:2])
    if tuple(q.shape[2:]) != (H, dk) or tuple(k.shape) != lead + (H, dk) \
            or tuple(v.shape) != lead + (H, dv) \
            or tuple(g.shape) != lead + (H,):
        raise ValueError(f"ssm_update: q, k {lead + (H, dk)}, v "
                         f"{lead + (H, dv)} and g {lead + (H,)} expected, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}, {tuple(g.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v), ("g", g)):
        if t.device != dev:
            raise ValueError(f"ssm_update: {name} is on {t.device}, not "
                             f"{dev}")


def _launch(state, ckpt, ckpt_pos, q, k, v, g, descs, starts, counts,
            NB: int, block_q: int):
    B, H, dk, dv = state.shape
    n = q.shape[0] * q.shape[1]
    qf, kf, vf = (_tokens(t, n, H) for t in (q, k, v))
    gf = g.reshape(n, H).to(torch.float32).contiguous()
    y = torch.zeros((n, H, dv), dtype=torch.float32, device=state.device)
    lib = build.load("ssm_update")
    fn = build.function(lib, "penroz_ssm_update", _ARGTYPES)
    ptr = (lambda t: t.data_ptr() if t is not None else None)  # noqa: E731
    err = fn(qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), gf.data_ptr(),
             y.data_ptr(), state.data_ptr(), ckpt.data_ptr(),
             ckpt_pos.data_ptr(), ptr(descs), ptr(starts), ptr(counts),
             ssm_update.runs.pointer(state.device), B, NB, block_q, H, dk,
             dv, ckpt_pos.shape[1], qf.stride(0), qf.stride(1), kf.stride(0),
             kf.stride(1), vf.stride(0), vf.stride(1), gf.stride(0),
             build.DTYPE_CODES[q.dtype], build.stream(state))
    build.check(lib, err, "ssm_update")
    if not torch.cuda.is_current_stream_capturing():  # else recorded
        with _LOCK:
            ssm_update.launches += 1
    return y


def ssm_update(state, ckpt, ckpt_pos, q, k, v, g, *, starts=None,
               counts=None, descs=None, block_q=None):
    """One launch of the recurrent update on the card.  Dense form
    (``descs`` None): B rows of T tokens, row b from position ``starts[b]``
    ((B,) int64), its first ``counts[b]`` tokens ((B,), or None for all T);
    returns y (B, T, H, dv).  Packed form: q, k, v, g (1, Tp, ...),
    ``descs`` (NB, 4) int32 with Tp = NB x ``block_q``; returns y (1, Tp,
    H, dv).  y is fp32, 0 at a dropped token."""
    _check(state, ckpt, ckpt_pos, q, k, v, g)
    B, T = q.shape[0], q.shape[1]
    dev = state.device
    if descs is None:
        if B != state.shape[0]:
            raise ValueError(f"ssm_update: {B} rows of input for a state "
                             f"of {state.shape[0]}")
        starts = starts.to(dev, torch.int64).contiguous()
        if counts is not None:
            counts = counts.to(dev, torch.int64).contiguous()
        NB, block_q = B, T
    else:
        NB, block_q = int(descs.shape[0]), int(block_q)
        if NB > MAX_BLOCKS:
            raise ValueError(f"ssm_update: {NB} descriptor blocks > "
                             f"{MAX_BLOCKS}")
        if B != 1 or T != NB * block_q:
            raise ValueError(f"ssm_update: packed input {(B, T)} != "
                             f"(1, {NB} x {block_q})")
        descs = descs.to(dev, torch.int32).contiguous()
    y = _launch(state, ckpt, ckpt_pos, q, k, v, g, descs, starts, counts,
                NB, block_q)
    return y.view(B, T, *y.shape[1:])


ssm_update.launches = 0
ssm_update.runs = build.RunCounter()
