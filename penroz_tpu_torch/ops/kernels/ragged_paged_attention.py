"""Ragged paged attention — one dispatch over a packed mixed batch: the CUDA
kernel's wrapper and its plain PyTorch version.

Replaces penroz_tpu/ops/pallas/ragged_paged_attention.py::
ragged_paged_attention.  The packed query axis is cut into ``block_q``-token
blocks, each with a descriptor ``(row, q_pos0, q_valid, kv_len)``: its
sequence, the position of its first query token, how many of its slots are
real, and the row's valid length after the current append.  A decode step
is one descriptor with ``q_valid = 1``; a prefill chunk is
``ceil(chunk / block_q)`` descriptors — side by side in one launch;
padding slots and ``row = -1`` descriptors come back zero.

The kernel (csrc/ragged_paged_attention.cu on csrc/decode_core.cuh) treats
each descriptor as a sequence of the paged decode core, with the key range
[window start of its first real slot, ``q_pos0 + q_valid``).  What bounds
it on an H100: bytes at a decode descriptor (its live pages read once a kv
head), score pairs at a long chunk.  What the design does: below 64 query
rows a kv head (``G * block_q``; the default block_q 8) each descriptor's
range is split in whole granules so that the longest decode row no longer
walks its keys alone; the plan comes from the pool's span
(:func:`~penroz_tpu_torch.ops.kernels.decode_attention.ragged_split_plan`),
since the descriptors stay on the device — the wrapper reads nothing back
and the launch depends only on shapes.  Splits that hold no key leave at
once; the live ones write partials to a scratch buffer and the last of
them (a ticket in a per-device buffer the kernel leaves zero) merges them
in split order.  A decode step's tile runs one row, a prefill chunk's
descriptor a tile of its rows over 64-key tiles, a padding tile writes
zeros and leaves.  From 64 rows (e.g. ``PENROZ_RAGGED_BLOCK_Q=128``) it
runs 64-row prefill tiles on tensor cores (bf16) or register-tiled FMAs
(fp32).

:func:`ragged_paged_attention` launches the kernel for CUDA tensors and
raises on anything it cannot take; ``ragged_paged_attention.launches``
counts what it launched, ``ragged_paged_attention.runs`` (a device
counter the kernel adds to) what ran; for CPU tensors it runs
:func:`ragged_paged_attention_reference`, the JAX package's sequential
oracle (penroz_tpu/ops/attention.py).
:func:`ragged_paged_attention_split_reference` runs the kernel's split and
merge in plain PyTorch for the tests.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from penroz_tpu_torch.ops import attention as A
from penroz_tpu_torch.ops.kernels import build
from penroz_tpu_torch.ops.kernels import decode_attention as DA
from penroz_tpu_torch.ops.kernels import paged_attention as PA

#: Descriptor columns: (row, q_pos0, q_valid, kv_len).  ``row = -1`` marks
#: a padding descriptor (q_valid = 0); its output block is zero.
DESC_COLS = 4
DEFAULT_BLOCK_Q = 8

_COUNT_LOCK = threading.Lock()
_TICKETS: dict = {}  # device index -> int32 zeros the kernel leaves zero
_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
             + [ctypes.c_longlong] + [ctypes.c_int] * 2
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3
             + [ctypes.c_void_p] * 4)


def default_block_q() -> int:
    """Packed query tokens per descriptor block (``PENROZ_RAGGED_BLOCK_Q``,
    default 8, as in the JAX package)."""
    raw = os.environ.get("PENROZ_RAGGED_BLOCK_Q", str(DEFAULT_BLOCK_Q))
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_BLOCK_Q
    return n if n >= 1 else DEFAULT_BLOCK_Q


def ragged_paged_attention_reference(q, flat_k, flat_v, block_table,
                                     page_size: int, descs, k_scale=None,
                                     v_scale=None,
                                     window: Optional[int] = None,
                                     alibi=None, scale: Optional[float] = None,
                                     softcap: Optional[float] = None):
    """Plain PyTorch attention of a PACKED mixed batch — the JAX package's
    sequential oracle line for line: each descriptor's dense KV view
    through the table, the per-token causal mask, and padding slots
    (row = -1 or t >= q_valid) zeroed."""
    _, Hq, Tp, D = q.shape
    Hkv = flat_k.shape[0]
    group = Hq // Hkv
    NB = descs.shape[0]
    BQ = Tp // NB
    max_len = block_table.shape[1] * page_size
    descs = descs.to(device=q.device, dtype=torch.int32)
    row = torch.clamp(descs[:, 0], min=0).to(torch.int64)
    k_dense, v_dense = PA.dequantized_views(q, flat_k, flat_v,
                                            block_table[row], page_size,
                                            k_scale, v_scale)
    # (1, Hq, Tp, D) -> (NB, Hkv, group, BQ, D): one "batch" entry per
    # descriptor block (kv-major head order: reshape + transpose).
    qg = q[0].reshape(Hkv, group, NB, BQ, D).permute(2, 0, 1, 3, 4)
    t = torch.arange(BQ, dtype=torch.int32, device=q.device)
    q_abs = descs[:, 1:2] + t[None, :]                    # (NB, BQ)
    valid_q = (t[None, :] < descs[:, 2:3]) & (descs[:, 0:1] >= 0)
    k_idx = torch.arange(max_len, dtype=torch.int32, device=q.device)
    mask = valid_q[:, :, None] & (k_idx[None, None, :] <= q_abs[:, :, None])
    if window is not None:
        mask &= k_idx[None, None, :] > q_abs[:, :, None] - int(window)
    bias = (None if alibi is None
            else A._alibi_bias(alibi, q_abs[:, :, None],
                               k_idx[None, None, :], Hkv))
    out = A._attend(qg, k_dense, v_dense, mask[:, None, None], bias=bias,
                    scale=scale, softcap=softcap)
    # Fully masked padding slots softmax to uniform in _attend; zero them
    # as the kernel does (l = 0 -> output 0).
    out = out * valid_q[:, None, None, :, None].to(out.dtype)
    return out.permute(1, 2, 0, 3, 4).reshape(1, Hq, Tp, D)


def ragged_plan(num_descs: int, block_q: int, hq: int, hkv: int,
                pages_per_seq: int, page_size: int, window: Optional[int],
                sms: int) -> DA.SplitPlan:
    """The kernel's tiling of one call, from shapes and the pool's span
    only."""
    return DA.ragged_split_plan(num_descs, hkv, (hq // hkv) * block_q,
                                pages_per_seq * page_size, window, page_size,
                                sms)


def _tickets(device, n: int) -> torch.Tensor:
    """At least ``n`` int32 merge tickets on ``device``, zero: the last split
    of each tile resets its ticket, so one buffer serves every launch on
    the device's stream."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    with _COUNT_LOCK:
        t = _TICKETS.get(index)
        if t is None or t.numel() < n:
            t = _TICKETS[index] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                              device=device)
        return t


def ragged_paged_attention_split_reference(q, flat_k, flat_v, block_table,
                                           page_size: int, descs,
                                           k_scale=None, v_scale=None,
                                           window: Optional[int] = None,
                                           alibi=None,
                                           scale: Optional[float] = None,
                                           softcap: Optional[float] = None,
                                           sms: int = 132):
    """:func:`ragged_paged_attention` as the kernel cuts it, in plain
    PyTorch on the CPU: each descriptor a sequence at ``q_pos0`` with
    ``q_valid`` real slots (none at ``row = -1``), its dense view through
    the table, the plan of :func:`ragged_plan` for a card of ``sms`` SMs,
    and the decode tiles' split-and-merge
    (:func:`~penroz_tpu_torch.ops.kernels.decode_attention.split_attend`).
    Prefill tiles (64 rows and more) walk their keys in one block: one
    split of 64-row tiles.  For the tests; nothing on the main path calls
    it."""
    _, Hq, Tp, D = q.shape
    Hkv = flat_k.shape[0]
    NB = descs.shape[0]
    BQ = Tp // NB
    max_len = block_table.shape[1] * page_size
    descs = descs.to(device=q.device, dtype=torch.int32)
    row = torch.clamp(descs[:, 0], min=0).to(torch.int64)
    k_dense, v_dense = PA.dequantized_views(q, flat_k, flat_v,
                                            block_table[row], page_size,
                                            k_scale, v_scale)
    plan = ragged_plan(NB, BQ, Hq, Hkv, block_table.shape[1], page_size,
                       window, sms)
    if plan.tile_rows == 0:
        rows = (Hq // Hkv) * BQ
        plan = DA.SplitPlan(DA.PREFILL_ROWS, -(-rows // DA.PREFILL_ROWS), 1,
                            plan.granule)
    valid = torch.where(descs[:, 0] >= 0, descs[:, 2], 0).tolist()
    qd = q[0].reshape(Hq, NB, BQ, D).transpose(0, 1)    # (NB, Hq, BQ, D)
    out = DA.split_attend(qd, k_dense, v_dense,
                          (descs[:, 1] + BQ).tolist(), plan, max_len,
                          window=window, alibi=alibi, scale=scale,
                          softcap=softcap, valid=valid)
    return out.transpose(0, 1).reshape(1, Hq, Tp, D)


def ragged_paged_attention(q, flat_k, flat_v, block_table, page_size: int,
                           descs, k_scale=None, v_scale=None,
                           window: Optional[int] = None, alibi=None,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None):
    """Unified mixed-batch attention over a paged pool; CUDA tensors launch
    the kernel, CPU tensors run :func:`ragged_paged_attention_reference`.

    q (1, Hq, Tp, D) packed in descriptor order, Tp = NB · block_q;
    flat_k/flat_v (Hkv, pool_rows, D) in q's dtype, or int8 with
    ``k_scale``/``v_scale`` (Hkv, pool_rows, 1) fp32; block_table
    (B, pages_per_seq) int32; descs (NB, 4) int32 on q's device.  The
    output is packed like q; padding slots are zero."""
    if q.device.type == "cpu":
        return ragged_paged_attention_reference(
            q, flat_k, flat_v, block_table, page_size, descs,
            k_scale=k_scale, v_scale=v_scale, window=window, alibi=alibi,
            scale=scale, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"ragged_paged_attention: unsupported device "
                         f"{q.device}")
    name = "ragged_paged_attention"
    if q.ndim != 4 or q.shape[0] != 1:
        raise ValueError(f"{name}: q must be (1, Hq, Tp, D)")
    _, Hq, Tp, D = q.shape
    NB = descs.shape[0] if descs.ndim == 2 else 0
    if NB == 0 or Tp % NB:
        raise ValueError(f"{name}: packed length {Tp} must be a positive "
                         f"multiple of the descriptor count {NB}")
    block_q = Tp // NB
    Hkv, rows, _, _, quantized = PA.check_pools(
        name, q, flat_k, flat_v, block_table, page_size, k_scale, v_scale)
    build.check_operand(name, "q", q, q.device, q.dtype, (1, Hq, Tp, D))
    build.check_operand(name, "descs", descs, q.device, torch.int32,
                        (NB, DESC_COLS))
    win, slopes, sm_scale, cap = PA.options(name, q, window, alibi, scale,
                                            softcap)
    plan = ragged_plan(NB, block_q, Hq, Hkv, block_table.shape[1],
                       int(page_size), window, DA.sm_count(q.device))
    lib = build.load("ragged_paged_attention")
    fn = build.function(lib, "penroz_ragged_paged_attention", _ARGTYPES)
    out = torch.empty_like(q)
    part = tickets = None
    if plan.tile_rows and plan.n_split > 1:
        # each split's partial, merged by the tile's last live split
        tiles = NB * Hkv * plan.row_tiles
        part = torch.empty(tiles * plan.n_split * plan.tile_rows * (D + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, tiles)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), flat_k.data_ptr(), flat_v.data_ptr(),
                 k_scale.data_ptr() if quantized else None,
                 v_scale.data_ptr() if quantized else None,
                 block_table.data_ptr(), descs.data_ptr(),
                 slopes.data_ptr() if slopes is not None else None,
                 out.data_ptr(), NB, block_q, Hq, Hkv, D, int(page_size),
                 block_table.shape[1], rows, build.DTYPE_CODES[q.dtype],
                 win, sm_scale, cap, plan.tile_rows, plan.n_split,
                 plan.granule, part.data_ptr() if part is not None else None,
                 tickets.data_ptr() if tickets is not None else None,
                 ragged_paged_attention.runs.pointer(q.device),
                 build.stream(q))
    build.check(lib, err, name)
    with _COUNT_LOCK:
        ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
ragged_paged_attention.runs = build.RunCounter()
