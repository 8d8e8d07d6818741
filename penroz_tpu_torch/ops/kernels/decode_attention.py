"""Cached (decode/prefill) attention: the CUDA kernel's wrapper, its plain
PyTorch version and the split-K plan the two share.

Replaces penroz_tpu/ops/pallas/decode_attention.py::decode_attention.  The
kernel (csrc/decode_attention.cu, device code in csrc/decode_core.cuh) is
memory-bound at decode — it reads each valid K/V row once — and
score-bound at a long prefill; its source note says what the design does
about each.  At decode (T·G < 64 query rows a kv head) :func:`split_plan`
cuts each (batch, kv head, row tile)'s key range into splits that cover
the card's SMs, one block each, merged inside the same launch;
:func:`split_ranges` is the cut, shared by the kernel (the same
arithmetic in C) and :func:`decode_attention_split_reference`, which runs
the split-and-merge algorithm in plain PyTorch for the tests.
:func:`ragged_split_plan` is the ragged kernel's plan (from the pool's
span: its descriptors stay on the device), and :func:`split_attend` with
``valid`` its split reference's core.

:func:`decode_attention` launches the kernel for CUDA tensors and raises on
anything it cannot take; for CPU tensors it runs
:func:`decode_attention_reference`, the jnp oracle's semantics in PyTorch
(penroz_tpu/ops/attention.py ``cached_attention``).  Nothing falls back
from the card to the plain version.  ``decode_attention.launches`` counts
the launches the wrapper makes (none while a graph is captured),
``decode_attention.runs`` the launches that ran, replays included.
"""

from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from penroz_tpu_torch.ops import attention as A
from penroz_tpu_torch.ops.kernels import build

_COUNT_LOCK = threading.Lock()
_SLOPES: dict = {}  # (slopes bytes, device) -> device tensor
_SM_COUNT: dict = {}  # device index -> multiprocessor count
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] + [ctypes.c_void_p] * 2
             + [ctypes.c_int] * 8 + [ctypes.c_float] * 2
             + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)

# The kernels' finite mask value.
NEG_INF = -1e30
# Query rows a kv head (T * G) from which the kernels run prefill tiles
# (64-row tiles over 64-key tiles) instead of split decode tiles.
PREFILL_ROWS = 64
# Keys a split covers at least (whole pages on a pool of smaller pages), and
# the most splits a row tile takes: its blocks form one thread-block
# cluster, of at most 16 on an H100 (csrc/decode_core.cuh kMaxSplits).
SPLIT_GRANULE = 64
MAX_SPLITS = 16
# Blocks a decode launch aims for: two per SM, so every SM has one while
# another waits on memory.
BLOCKS_PER_SM = 2
# Granules a split of a ragged descriptor's key range walks at least (its
# split granule), and at most over the longest range the pool allows
# (ragged_split_plan).
RAGGED_WALK = 4


class SplitPlan(NamedTuple):
    """How one launch tiles its work.  ``tile_rows`` query rows (1, 4 or
    8) per decode tile, ``row_tiles`` of them per (batch, kv head), each
    key range cut into ``n_split`` splits of whole ``granule``s; a
    ``tile_rows`` of 0 selects the prefill tiles (no split)."""
    tile_rows: int
    row_tiles: int
    n_split: int
    granule: int


def split_plan(batch: int, hkv: int, rows: int, max_len: int,
               window: Optional[int] = None,
               page_size: Optional[int] = None,
               sm_count: int = 132) -> SplitPlan:
    """The kernels' tiling for ``rows`` = T * G query rows a kv head over at
    most ``max_len`` keys.  At decode (``rows < PREFILL_ROWS``) each
    (batch, kv head, row tile)'s key range is cut into enough splits for
    ``BLOCKS_PER_SM`` blocks an SM, at most ``MAX_SPLITS`` and at most one
    per granule of the keys a tile can attend.  A granule is 64 keys, or,
    on a pool whose pages are not a multiple of 64 keys, the fewest whole
    pages that hold 64."""
    granule = (SPLIT_GRANULE
               if page_size is None or page_size % SPLIT_GRANULE == 0
               else page_size * -(-SPLIT_GRANULE // page_size))
    if rows >= PREFILL_ROWS:
        return SplitPlan(0, 0, 1, granule)
    tile_rows = 1 if rows == 1 else 4 if rows <= 4 else 8
    row_tiles = -(-rows // tile_rows)
    want = -(-BLOCKS_PER_SM * sm_count // (batch * hkv * row_tiles))
    most = _granules(rows, max_len, window, granule)
    return SplitPlan(tile_rows, row_tiles,
                     max(1, min(want, most, MAX_SPLITS)), granule)


def _granules(rows: int, max_len: int, window: Optional[int],
              granule: int) -> int:
    """Granules of the keys a tile of ``rows`` query rows can attend: the
    most splits it can use."""
    span = max_len if window is None else min(max_len, int(window) + rows - 1)
    return -(-max(span, 1) // granule)


def ragged_split_plan(num_descs: int, hkv: int, rows: int, max_len: int,
                      window: Optional[int] = None,
                      page_size: Optional[int] = None,
                      sm_count: int = 132) -> SplitPlan:
    """The ragged kernel's tiling for ``rows`` = G * block_q query rows a
    kv head and descriptor over a pool of ``max_len`` keys a sequence.  A
    descriptor's length stays on the device (the wrapper reads nothing
    back), so the plan comes from shapes and the pool's span.  Where
    :func:`split_plan`'s count for filling the card is the larger (few
    descriptors), it stands.  Else splits are whole ``RAGGED_WALK``
    granules, as many as the longest range needs: a range of up to
    ``RAGGED_WALK`` granules (a prefill chunk's, a short decode row's) runs
    in one block with no merge, a longer one in splits of that many
    granules; the splits that hold no key leave at once."""
    plan = split_plan(num_descs, hkv, rows, max_len, window, page_size,
                      sm_count)
    if plan.tile_rows == 0:
        return plan
    walk = -(-_granules(rows, max_len, window, plan.granule) // RAGGED_WALK)
    if plan.n_split > walk:
        return plan
    return plan._replace(n_split=min(walk, MAX_SPLITS),
                         granule=plan.granule * RAGGED_WALK)


def tile_keys(m0: int, mv: int, T: int, first: int, max_len: int,
              window: Optional[int] = None,
              valid: Optional[int] = None) -> tuple:
    """Keys [kb, ke) that rows m0 .. m0 + mv - 1 attend when token 0 sits at
    ``first`` (a tile that wraps past a query head holds every token).
    With ``valid`` (a ragged descriptor's real slots) only tokens below it
    count, and a tile without one gets (0, 0)."""
    t_lo, t_hi = 0, T - 1
    if m0 // T == (m0 + mv - 1) // T:
        t_lo, t_hi = m0 % T, (m0 + mv - 1) % T
    if valid is not None:
        t_hi = min(t_hi, valid - 1)
        if t_hi < t_lo:
            return 0, 0
    ke = min(first + t_hi + 1, max_len)
    kb = max(0, first + t_lo - int(window) + 1) if window else 0
    return kb, ke


def split_ranges(kb: int, ke: int, n_split: int, granule: int) -> list:
    """The ``n_split`` key ranges [lo, hi) of [kb, ke): whole granules from
    kb's granule on, ceil(span / n_split) keys each rounded up to a granule,
    clipped to [kb, ke); lo >= hi is an empty split.  csrc/decode_core.cuh
    ``split_keys`` is the same arithmetic."""
    if ke <= kb:
        return [(kb, kb)] * n_split
    base = kb // granule * granule
    per = -(-(ke - base) // n_split)
    chunk = -(-per // granule) * granule
    return [(max(kb, base + s * chunk), min(ke, base + (s + 1) * chunk))
            for s in range(n_split)]


def sm_count(device) -> int:
    """Multiprocessors of a CUDA ``device``, read once per device."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    n = _SM_COUNT.get(index)
    if n is None:
        n = _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return n


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


def plan_for(batch: int, hq: int, hkv: int, t: int, length, max_len: int,
             window: Optional[int], page_size: Optional[int],
             sms: int) -> SplitPlan:
    """:func:`split_plan` of one call: an int ``length`` bounds the keys,
    per-sequence lengths on the device only ``max_len``."""
    if not isinstance(length, torch.Tensor):
        max_len = int(length)
    return split_plan(batch, hkv, (hq // hkv) * t, max_len, window, page_size,
                      sms)


def split_attend(q, k_full, v_full, lengths, plan: SplitPlan, max_len: int,
                 window: Optional[int] = None, alibi=None,
                 scale: Optional[float] = None,
                 softcap: Optional[float] = None, valid=None):
    """The decode tiles' algorithm in plain PyTorch: for each (sequence, row
    tile) the key range of :func:`tile_keys` cut by :func:`split_ranges`,
    each split's (max, sum, P·V) of its attended keys (probabilities
    rounded to q's dtype before P·V), merged in split order.  k_full/v_full
    (B, Hkv, S, D) in q's dtype; ``lengths`` one int per sequence.
    ``valid`` (ragged descriptors): per sequence, the tokens that are real;
    the others attend nothing and come back zero."""
    if plan.tile_rows == 0:
        raise ValueError("split_attend: the plan selects prefill tiles")
    B, Hq, T, D = q.shape
    Hkv = k_full.shape[1]
    G = Hq // Hkv
    rows = G * T
    R = plan.tile_rows
    sm_scale = float(scale) if scale is not None else 1.0 / (D ** 0.5)
    qf = q.float().reshape(B, Hkv, rows, D)
    kf, vf = k_full.float(), v_full.float()
    slopes = (None if alibi is None else torch.as_tensor(
        np.asarray(alibi, np.float32)).reshape(Hkv, G))
    neg = torch.tensor(NEG_INF)
    out = torch.zeros(B, Hkv, rows, D)
    for b in range(B):
        first = int(lengths[b]) - T
        n_valid = T if valid is None else int(valid[b])
        for m0 in range(0, rows, R):
            mv = min(R, rows - m0)
            r = torch.arange(m0, m0 + mv)
            pos = first + r % T
            real = (r % T < n_valid)[:, None]
            kb, ke = tile_keys(m0, mv, T, first, max_len, window,
                               None if valid is None else n_valid)
            parts = []
            for lo, hi in split_ranges(kb, ke, plan.n_split, plan.granule):
                if hi <= lo:
                    parts.append((torch.full((Hkv, mv), NEG_INF),
                                  torch.zeros(Hkv, mv),
                                  torch.zeros(Hkv, mv, D)))
                    continue
                j = torch.arange(lo, hi)
                s = torch.einsum("hrd,hnd->hrn", qf[b, :, m0:m0 + mv],
                                 kf[b, :, lo:hi]) * sm_scale
                if softcap is not None:
                    s = float(softcap) * torch.tanh(s / float(softcap))
                if slopes is not None:
                    s = s + slopes[:, r // T][..., None] * (
                        j[None, :] - pos[:, None]).float()
                att = (j[None, :] <= pos[:, None]) & real
                if window is not None:
                    att &= j[None, :] > pos[:, None] - int(window)
                s = torch.where(att, s, neg)
                m = s.amax(-1)
                p = torch.where(att, torch.exp(s - m[..., None]), 0.0)
                acc = p.to(q.dtype).float() @ vf[b, :, lo:hi]
                parts.append((m, p.sum(-1), acc))
            mx = torch.stack([m for m, _, _ in parts]).amax(0)
            total = torch.zeros(Hkv, mv)
            merged = torch.zeros(Hkv, mv, D)
            for m, l, acc in parts:
                e = torch.exp(m - mx)
                total = total + l * e
                merged = merged + acc * e[..., None]
            out[b, :, m0:m0 + mv] = merged / torch.where(
                total == 0, 1.0, total)[..., None]
    return out.reshape(B, Hq, T, D).to(q.dtype)


def decode_attention_split_reference(q, k_full, v_full, offset, length,
                                     k_scale=None, v_scale=None,
                                     window: Optional[int] = None,
                                     alibi=None,
                                     scale: Optional[float] = None,
                                     softcap: Optional[float] = None,
                                     sms: int = 132):
    """:func:`decode_attention` as its decode tiles compute it, in plain
    PyTorch on the CPU: the same :func:`split_plan` for a card of ``sms``
    SMs, then :func:`split_attend`.  For the tests; nothing on the main path
    calls it.  Queries sit at ``length - T + t`` (``offset`` is implied)."""
    if k_scale is not None:
        k_full = (k_full.to(torch.float32) * k_scale).to(q.dtype)
        v_full = (v_full.to(torch.float32) * v_scale).to(q.dtype)
    B, Hq, T, _ = q.shape
    S = k_full.shape[2]
    plan = plan_for(B, Hq, k_full.shape[1], T, length, S, window, None, sms)
    lengths = normalize_lengths(length, B).tolist()
    return split_attend(q, k_full, v_full, lengths, plan, S, window=window,
                        alibi=alibi, scale=scale, softcap=softcap)


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
    plan = plan_for(B, Hq, Hkv, T, length, S, window, None,
                    sm_count(q.device))

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
                 plan.tile_rows, plan.n_split, plan.granule,
                 decode_attention.runs.pointer(q.device),
                 build.stream(q))
    build.check(lib, err, "decode_attention")
    if not torch.cuda.is_current_stream_capturing():  # else recorded
        with _COUNT_LOCK:
            decode_attention.launches += 1
    return out


decode_attention.launches = 0
decode_attention.runs = build.RunCounter()
