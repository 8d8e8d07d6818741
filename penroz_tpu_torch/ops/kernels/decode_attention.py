"""Cached (decode/prefill) attention: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces penroz_tpu/ops/pallas/decode_attention.py::decode_attention.  The
kernel (csrc/decode_attention.cu) is memory-bound at decode — it reads each
valid K/V row once — and bounds its key loop by the valid length, not the
cache capacity; its source note says what the design does and does not do
yet.

:func:`decode_attention` launches the kernel for CUDA tensors and raises on
anything it cannot take; for CPU tensors it runs
:func:`decode_attention_reference`, the jnp oracle's semantics in PyTorch
(penroz_tpu/ops/attention.py ``cached_attention``).  Nothing falls back
from the card to the plain version.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import numpy as np
import torch

from penroz_tpu_torch.ops import attention as A
from penroz_tpu_torch.ops.kernels import build

_COUNT_LOCK = threading.Lock()
_SLOPES: dict = {}  # (slopes bytes, device) -> device tensor
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p])


def normalize_lengths(length, batch: int, device=None) -> torch.Tensor:
    """(B,) int32 valid lengths from a scalar (broadcast) or (B,) input —
    the shared ragged-length contract of the kernel and its plain
    version."""
    total = torch.as_tensor(length, dtype=torch.int32,
                            device=device).reshape(-1)
    if total.shape[0] == 1 and batch > 1:
        total = total.expand(batch)
    if total.shape[0] != batch:
        raise ValueError(f"length must be scalar or (B,); got "
                         f"{total.shape[0]} lengths for batch {batch}")
    return total


def decode_attention_reference(q, k_full, v_full, offset, length,
                               k_scale=None, v_scale=None,
                               window: Optional[int] = None,
                               alibi=None, scale: Optional[float] = None,
                               softcap: Optional[float] = None):
    """Plain PyTorch cached attention — the jnp oracle of
    penroz_tpu/ops/attention.py ``cached_attention`` line for line.

    A scalar ``length`` places the queries at ``offset + [0, T)``; a
    tensor ``length`` (any size, like the oracle) gives per-sequence
    lengths and ignores ``offset``."""
    if k_scale is not None:
        k_full = (k_full.to(torch.float32) * k_scale).to(q.dtype)
        v_full = (v_full.to(torch.float32) * v_scale).to(q.dtype)
    B, Hq, T, D = q.shape
    S = k_full.shape[2]
    num_kv_heads = k_full.shape[1]
    qg = A._group_query_heads(q, num_kv_heads)
    key_idx = torch.arange(S, dtype=torch.int32, device=q.device)
    if isinstance(length, torch.Tensor) and length.ndim >= 1:
        lengths = normalize_lengths(length, B, device=q.device)
        q_pos = (lengths[:, None] - T) + torch.arange(
            T, dtype=torch.int32, device=q.device)
        mask = key_idx[None, None, :] <= q_pos[:, :, None]  # (B, T, S)
        if window is not None:
            mask &= key_idx[None, None, :] > q_pos[:, :, None] - int(window)
        bias = (None if alibi is None
                else A._alibi_bias(alibi, q_pos[:, :, None],
                                   key_idx[None, None, :], num_kv_heads))
        mask = mask[:, None, None]  # (B, 1, 1, T, S)
    else:
        q_pos = int(offset) + torch.arange(T, dtype=torch.int32,
                                           device=q.device)
        mask = key_idx[None, :] <= q_pos[:, None]  # (T, S)
        if window is not None:
            mask &= key_idx[None, :] > q_pos[:, None] - int(window)
        bias = (None if alibi is None
                else A._alibi_bias(alibi, q_pos[:, None], key_idx[None, :],
                                   num_kv_heads))
    out = A._attend(qg, k_full, v_full, mask, bias=bias, scale=scale,
                    softcap=softcap)
    return out.reshape(B, Hq, T, D)


def slopes_on(alibi, device) -> torch.Tensor:
    arr = np.ascontiguousarray(alibi, np.float32)
    key = (arr.tobytes(), str(device))
    t = _SLOPES.get(key)
    if t is None:
        t = _SLOPES[key] = torch.as_tensor(arr, device=device)
    return t


def decode_attention(q, k_full, v_full, offset, length, k_scale=None,
                     v_scale=None, window: Optional[int] = None, alibi=None,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None):
    """Cached attention; CUDA tensors launch the kernel, CPU tensors run
    :func:`decode_attention_reference`.

    q (B, Hq, T, D) fp32 or bf16; k_full/v_full (B, Hkv, S, D) in q's
    dtype, or int8 with ``k_scale``/``v_scale`` (B, Hkv, S, 1) fp32.
    ``length``: int, or a (B,) int32 tensor on q's device (the queries
    sit at ``length - T + t``; ``offset`` is then implied).  The kernel
    takes any S, 1 <= T <= S and D <= 256 with D % 8 == 0, and raises on
    anything else."""
    if q.device.type == "cpu":
        return decode_attention_reference(
            q, k_full, v_full, offset, length, k_scale=k_scale,
            v_scale=v_scale, window=window, alibi=alibi, scale=scale,
            softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.ndim != 4 or k_full.ndim != 4:
        raise ValueError("decode_attention: q and k/v must be 4-D")
    B, Hq, T, D = q.shape
    Hkv, S = k_full.shape[1], k_full.shape[2]
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"decode_attention: q dtype {q.dtype} not in "
                         f"{sorted(map(str, build.DTYPE_CODES))}")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"decode_attention: head dim {D} must be a "
                         f"multiple of 8 in [8, 256]")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"decode_attention: Hq={Hq} not a multiple of "
                         f"Hkv={Hkv}")
    if not 1 <= T <= S:
        raise ValueError(f"decode_attention: need 1 <= T={T} <= S={S}")
    kv_shape = (B, Hkv, S, D)
    quantized = k_scale is not None
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    kv_dtype = torch.int8 if quantized else q.dtype
    check = build.check_operand
    check("decode_attention", "q", q, q.device, q.dtype, (B, Hq, T, D))
    check("decode_attention", "k", k_full, q.device, kv_dtype, kv_shape)
    check("decode_attention", "v", v_full, q.device, kv_dtype, kv_shape)
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check("decode_attention", name, t, q.device, torch.float32,
                  (B, Hkv, S, 1))
    lengths_ptr, length_int = None, 0
    if isinstance(length, torch.Tensor):
        lengths = normalize_lengths(length, B, device=q.device).contiguous()
        lengths_ptr = lengths.data_ptr()
    else:
        length_int = int(length)
        if not T <= length_int <= S:
            raise ValueError(f"decode_attention: need T={T} <= "
                             f"length={length_int} <= S={S}")
    if window is not None and int(window) < 1:
        raise ValueError(f"decode_attention: window must be >= 1, "
                         f"got {window}")
    if softcap is not None and float(softcap) <= 0.0:
        raise ValueError(f"decode_attention: softcap must be > 0, "
                         f"got {softcap}")
    slopes = None
    if alibi is not None:
        slopes = slopes_on(alibi, q.device)
        if slopes.numel() != Hq:
            raise ValueError(f"decode_attention: {slopes.numel()} ALiBi "
                             f"slopes for {Hq} query heads")
    sm_scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)

    lib = build.load("decode_attention")
    fn = build.function(lib, "penroz_decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 lengths_ptr, length_int,
                 slopes.data_ptr() if slopes is not None else None,
                 out.data_ptr(), B, Hq, Hkv, T, S, D,
                 build.DTYPE_CODES[q.dtype],
                 int(window) if window is not None else 0, sm_scale,
                 float(softcap) if softcap is not None else 0.0,
                 build.stream(q))
    build.check(lib, err, "decode_attention")
    with _COUNT_LOCK:
        decode_attention.launches += 1
    return out


decode_attention.launches = 0
