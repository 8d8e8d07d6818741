"""Paged decode attention: the CUDA kernel's wrapper and its plain PyTorch
version.

Replaces penroz_tpu/ops/pallas/paged_attention.py::paged_decode_attention.
The kernel (csrc/paged_attention.cu) is the contiguous decode kernel
(csrc/decode_core.cuh) with a block-table indirection: key j of sequence b
is pool row ``block_table[b, j // page_size] * page_size + j % page_size``,
each split of a decode tile covering whole pages
(:func:`~penroz_tpu_torch.ops.kernels.decode_attention.split_plan`); its
source note says what bounds it and what the design does about that.

:func:`paged_decode_attention` launches the kernel for CUDA tensors and
raises on anything it cannot take; for CPU tensors it runs
:func:`paged_decode_attention_reference`, the JAX package's oracle (gather
the dense view through the table, then the cached-attention oracle).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from penroz_tpu_torch.ops.kernels import build
from penroz_tpu_torch.ops.kernels import decode_attention as DA

_COUNT_LOCK = threading.Lock()
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 2)


def gather_pages(flat, block_table, page_size: int, rows_of=None):
    """Dense ``(N, Hkv, pages_per_seq * page_size, ·)`` view of the pool
    ``flat`` (Hkv, pool_rows, ·) through the table rows ``block_table``
    (N, pages_per_seq); unassigned pages (-1) read page 0, behind the
    mask."""
    max_len = block_table.shape[1] * page_size
    pos = torch.arange(max_len, device=flat.device)
    phys = torch.clamp(block_table[:, pos // page_size].to(torch.int64),
                       min=0)
    rows = phys * page_size + pos % page_size          # (N, max_len)
    return flat[:, rows].transpose(0, 1)


def dequantized_views(q, flat_k, flat_v, block_table, page_size: int,
                      k_scale=None, v_scale=None):
    """Gathered K/V views in q's dtype (int8 pools dequantized after the
    gather, as the JAX oracle does)."""
    k_full = gather_pages(flat_k, block_table, page_size)
    v_full = gather_pages(flat_v, block_table, page_size)
    if k_scale is not None:
        k_full = (k_full.to(torch.float32) * gather_pages(
            k_scale, block_table, page_size)).to(q.dtype)
        v_full = (v_full.to(torch.float32) * gather_pages(
            v_scale, block_table, page_size)).to(q.dtype)
    return k_full, v_full


def paged_decode_attention_reference(q, flat_k, flat_v, block_table,
                                     page_size: int, offset, length,
                                     k_scale=None, v_scale=None,
                                     window: Optional[int] = None,
                                     alibi=None, scale: Optional[float] = None,
                                     softcap: Optional[float] = None):
    """Plain PyTorch paged attention — the JAX package's fallback and
    oracle (penroz_tpu/ops/attention.py ``paged_cached_attention``): the
    dense view through the table, then the cached-attention oracle."""
    k_full, v_full = dequantized_views(q, flat_k, flat_v, block_table,
                                       page_size, k_scale, v_scale)
    return DA.decode_attention_reference(q, k_full, v_full, offset, length,
                                         window=window, alibi=alibi,
                                         scale=scale, softcap=softcap)


def paged_decode_attention_split_reference(
        q, flat_k, flat_v, block_table, page_size: int, offset, length,
        k_scale=None, v_scale=None, window: Optional[int] = None, alibi=None,
        scale: Optional[float] = None, softcap: Optional[float] = None,
        sms: int = 132):
    """:func:`paged_decode_attention` as its decode tiles compute it, in
    plain PyTorch on the CPU: the dense view through the table, then the
    same split plan (whole pages a split) and split-and-merge as the
    contiguous kernel's (:func:`~penroz_tpu_torch.ops.kernels.
    decode_attention.split_attend`).  For the tests; nothing on the main
    path calls it."""
    k_full, v_full = dequantized_views(q, flat_k, flat_v, block_table,
                                       page_size, k_scale, v_scale)
    B, Hq, T, _ = q.shape
    max_len = block_table.shape[1] * page_size
    plan = DA.plan_for(B, Hq, flat_k.shape[0], T, length, max_len, window,
                       page_size, sms)
    lengths = DA.normalize_lengths(length, B).tolist()
    return DA.split_attend(q, k_full, v_full, lengths, plan, max_len,
                           window=window, alibi=alibi, scale=scale,
                           softcap=softcap)


def check_pools(kernel: str, q, flat_k, flat_v, block_table, page_size: int,
                k_scale, v_scale):
    """Validate the paged operands both kernels share; returns
    ``(Hkv, pool_rows, D, group, quantized)``."""
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{kernel}: q dtype {q.dtype} not in "
                         f"{sorted(map(str, build.DTYPE_CODES))}")
    if flat_k.ndim != 3:
        raise ValueError(f"{kernel}: pools must be (Hkv, rows, D)")
    Hq, D = q.shape[1], q.shape[3]
    Hkv, rows = flat_k.shape[0], flat_k.shape[1]
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"{kernel}: head dim {D} must be a multiple of 8 "
                         f"in [8, 256]")
    if Hkv < 1 or Hq % Hkv:
        raise ValueError(f"{kernel}: Hq={Hq} not a multiple of Hkv={Hkv}")
    if page_size < 1 or block_table.ndim != 2:
        raise ValueError(f"{kernel}: need page_size >= 1 and a 2-D table")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together")
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else q.dtype
    check = build.check_operand
    check(kernel, "k", flat_k, q.device, kv_dtype, (Hkv, rows, D))
    check(kernel, "v", flat_v, q.device, kv_dtype, (Hkv, rows, D))
    if quantized:
        for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
            check(kernel, name, t, q.device, torch.float32, (Hkv, rows, 1))
    check(kernel, "block_table", block_table, q.device, torch.int32,
          tuple(block_table.shape))
    return Hkv, rows, D, Hq // Hkv, quantized


def options(kernel: str, q, window, alibi, scale, softcap):
    """(window, slopes tensor or None, sm_scale, softcap) as the kernels
    take them, validated."""
    if window is not None and int(window) < 1:
        raise ValueError(f"{kernel}: window must be >= 1, got {window}")
    if softcap is not None and float(softcap) <= 0.0:
        raise ValueError(f"{kernel}: softcap must be > 0, got {softcap}")
    slopes = None
    if alibi is not None:
        slopes = DA.slopes_on(alibi, q.device)
        if slopes.numel() != q.shape[1]:
            raise ValueError(f"{kernel}: {slopes.numel()} ALiBi slopes for "
                             f"{q.shape[1]} query heads")
    sm_scale = float(scale) if scale is not None else 1.0 / (q.shape[3]
                                                              ** 0.5)
    return (int(window) if window is not None else 0, slopes, sm_scale,
            float(softcap) if softcap is not None else 0.0)


def paged_decode_attention(q, flat_k, flat_v, block_table, page_size: int,
                           offset, length, k_scale=None, v_scale=None,
                           window: Optional[int] = None, alibi=None,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None):
    """Cached attention over a paged pool; CUDA tensors launch the kernel,
    CPU tensors run :func:`paged_decode_attention_reference`.

    q (B, Hq, T, D) fp32 or bf16; flat_k/flat_v (Hkv, pool_rows, D) in q's
    dtype, or int8 with ``k_scale``/``v_scale`` (Hkv, pool_rows, 1) fp32;
    block_table (B, pages_per_seq) int32 (-1 = unassigned).  ``length``:
    int, or a (B,) int32 tensor on q's device; the queries sit at
    ``length - T + t`` (``offset`` is then implied)."""
    if q.device.type == "cpu":
        return paged_decode_attention_reference(
            q, flat_k, flat_v, block_table, page_size, offset, length,
            k_scale=k_scale, v_scale=v_scale, window=window, alibi=alibi,
            scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    if q.ndim != 4:
        raise ValueError("paged_decode_attention: q must be 4-D")
    name = "paged_decode_attention"
    B, Hq, T, D = q.shape
    Hkv, rows, _, _, quantized = check_pools(
        name, q, flat_k, flat_v, block_table, page_size, k_scale, v_scale)
    pages_per_seq = block_table.shape[1]
    if block_table.shape[0] != B:
        raise ValueError(f"{name}: table has {block_table.shape[0]} rows "
                         f"for batch {B}")
    build.check_operand(name, "q", q, q.device, q.dtype, (B, Hq, T, D))
    max_len = pages_per_seq * page_size
    lengths_ptr, length_int = None, 0
    if isinstance(length, torch.Tensor):
        lengths = DA.normalize_lengths(length, B,
                                       device=q.device).contiguous()
        lengths_ptr = lengths.data_ptr()
    else:
        length_int = int(length)
        if not T <= length_int <= max_len:
            raise ValueError(f"{name}: need T={T} <= length={length_int} "
                             f"<= {max_len}")
    win, slopes, sm_scale, cap = options(name, q, window, alibi, scale,
                                         softcap)
    plan = DA.plan_for(B, Hq, Hkv, T, length, max_len, window,
                       int(page_size), DA.sm_count(q.device))
    lib = build.load("paged_attention")
    fn = build.function(lib, "penroz_paged_decode_attention", _ARGTYPES)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), flat_k.data_ptr(), flat_v.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 block_table.data_ptr(), lengths_ptr, length_int,
                 slopes.data_ptr() if slopes is not None else None,
                 out.data_ptr(), B, Hq, Hkv, T, D, int(page_size),
                 pages_per_seq, rows, build.DTYPE_CODES[q.dtype], win,
                 sm_scale, cap, plan.tile_rows, plan.n_split, plan.granule,
                 paged_decode_attention.runs.pointer(q.device),
                 build.stream(q))
    build.check(lib, err, name)
    if not torch.cuda.is_current_stream_capturing():  # else recorded
        with _COUNT_LOCK:
            paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.runs = build.RunCounter()
