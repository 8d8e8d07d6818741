"""Attention math: RoPE, ALiBi, the causal (no-cache) reference and cached
attention (counterpart of penroz_tpu/ops/attention.py), and the hash
dropout mask of the flash kernels (penroz_tpu/ops/pallas/flash_attention.py
``_keep_mask``).

GQA is computed by viewing the query heads as ``(kv_heads, group)`` in
kv-major order and contracting against un-expanded K/V.  Layouts follow the
JAX package at every public function: q (B, Hq, T, D), k/v (B, Hkv, S, D).

Every attention path goes through a hand-written CUDA kernel for CUDA
tensors and its plain PyTorch version for CPU tensors:
:func:`cached_attention` (contiguous cache) through
ops/kernels/decode_attention.py, :func:`paged_cached_attention` (paged
pool) through ops/kernels/paged_attention.py,
:func:`ragged_paged_cached_attention` (packed mixed batches of the
continuous-batching scheduler) through ops/kernels/ragged_paged_attention.py
and :func:`causal_attention` (training, and the no-cache forward) through
ops/kernels/flash_attention.py.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

import numpy as np
import torch

log = logging.getLogger(__name__)

_NEG_INF = -1e30
_MASK32 = 0xFFFFFFFF
_HEAD_SEED_PRIME = 0x632BE5A7

# One-shot fallback signals, as in the JAX package (warned once per process).
_WARNED_ONCE: set = set()


def _warn_once(key: str, msg: str, *args):
    if key in _WARNED_ONCE:
        return
    _WARNED_ONCE.add(key)
    log.warning(msg, *args)


# ---------------------------------------------------------------------------
# Hash dropout: the flash kernels' keep mask, bit for bit
# ---------------------------------------------------------------------------

def _mul32(x, c: int):
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32): split in 16-bit
    halves so no intermediate leaves int64 (torch has no wrapping uint32
    multiply on every device)."""
    hi = ((x >> 16) * c) & _MASK32
    return ((hi << 16) + (x & 0xFFFF) * c) & _MASK32


def keep_threshold(rate: float) -> int:
    """A pair is kept iff its uint32 hash is below this (the JAX package's
    ``min(int((1 - rate) * 2^32), 2^32 - 1)``)."""
    return min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)


def _keep_mask(q_pos, k_pos, seed, rate: float):
    """Boolean keep-mask (True = keep) from the lowbias32-style position
    hash; ``q_pos``/``k_pos``/``seed`` are broadcastable int64 tensors in
    [0, 2^32), ``seed`` already mixed with the (batch, head) index."""
    x = (_mul32(q_pos, 0x9E3779B1) ^ _mul32(k_pos, 0x85EBCA77)
         ^ _mul32(seed, 0xC2B2AE3D))
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x < keep_threshold(rate)


def head_seed(seed, index):
    """``seed + index * 0x632BE5A7`` with int32 wrap-around, as uint32 in
    int64 (``seed``: int32 scalar tensor or int; ``index``: int tensor of
    ``b * Hq + h``)."""
    s = torch.as_tensor(seed, dtype=torch.int64) & _MASK32
    return (s.to(index.device) + index.to(torch.int64) * _HEAD_SEED_PRIME) \
        & _MASK32


def dropout_keep_mask_reference(seed, b: int, h: int, num_heads: int, T: int,
                                S: int, rate: float):
    """(T, S) keep-mask the kernels generate for batch ``b``, head ``h``."""
    q_pos = torch.arange(T, dtype=torch.int64)[:, None]
    k_pos = torch.arange(S, dtype=torch.int64)[None, :]
    seed_bh = head_seed(seed, torch.tensor(b * num_heads + h))
    return _keep_mask(q_pos, k_pos, seed_bh, rate)


def dropout_keep_mask(seed, B: int, Hq: int, T: int, rate: float, device):
    """(B, Hq, T, T) keep-mask of every (batch, head) at once."""
    pos = torch.arange(T, dtype=torch.int64, device=device)
    index = torch.arange(B * Hq, device=device).reshape(B, Hq, 1, 1)
    return _keep_mask(pos[:, None], pos[None, :], head_seed(seed, index), rate)


def _llama3_scale_inv_freq(inv_freq, scaling: dict):
    """Llama-3.1 frequency rescaling (HF ``_compute_llama3_parameters``):
    long-wavelength components divide by ``factor``, short ones pass
    through, and a smooth ramp interpolates between the two bands."""
    factor = float(scaling["factor"])
    low = float(scaling.get("low_freq_factor", 1.0))
    high = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling["original_max_position_embeddings"])
    wavelen = 2.0 * np.pi / inv_freq
    smooth = (orig / wavelen - low) / (high - low)
    smoothed = (1.0 - smooth) / factor * inv_freq + smooth * inv_freq
    scaled = torch.where(wavelen > orig / low, inv_freq / factor, inv_freq)
    is_medium = (wavelen <= orig / low) & (wavelen >= orig / high)
    return torch.where(is_medium, smoothed, scaled)


def rope_cos_sin(head_dim: int, theta: float, offset, length: int, dtype,
                 scaling: Optional[dict] = None, device=None):
    """cos/sin tables of shape (length, head_dim) starting at ``offset`` —
    or (B, length, head_dim) when ``offset`` is a (B,) tensor (each
    sequence rotates from its own position), or per-token positions when
    ``offset`` is (B, length).

    ``scaling``: an HF ``rope_scaling`` dict — ``rope_type='linear'``
    divides the inverse frequencies by the factor, otherwise the llama3
    band rescaling applies."""
    inv_freq = 1.0 / (theta ** (torch.arange(0, head_dim, 2,
                                             dtype=torch.float32,
                                             device=device) / head_dim))
    if scaling:
        rope_type = (scaling.get("rope_type") or scaling.get("type")
                     or "default")
        if rope_type == "linear":
            inv_freq = inv_freq / float(scaling["factor"])
        else:
            inv_freq = _llama3_scale_inv_freq(inv_freq, scaling)
    steps = torch.arange(length, dtype=torch.float32, device=device)
    offset = torch.as_tensor(offset, device=device)
    if offset.ndim == 2:
        if offset.shape[1] != length:
            raise ValueError(f"per-token offset length {offset.shape[1]} "
                             f"!= sequence length {length}")
        t = offset.to(torch.float32)
    elif offset.ndim >= 1:
        t = offset.to(torch.float32)[:, None] + steps
    else:
        t = offset.to(torch.float32) + steps
    freqs = t[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, theta: float, offset, scaling: Optional[dict] = None,
               rotary_dim: Optional[int] = None):
    """Apply rotary embeddings to (B, H, T, D) query/key tensors;
    ``rotary_dim`` < D rotates only the leading feature dims (partial
    rotary, GPT-NeoX ``rotary_pct``)."""
    head_dim = q.shape[-1]
    width = head_dim if rotary_dim is None or rotary_dim >= head_dim \
        else rotary_dim
    cos, sin = rope_cos_sin(width, theta, offset, q.shape[2], q.dtype,
                            scaling=scaling, device=q.device)
    # (L, rd) -> (1, 1, L, rd); (B, L, rd) -> (B, 1, L, rd)
    cos, sin = ((cos[:, None], sin[:, None]) if cos.ndim == 3
                else (cos[None, None], sin[None, None]))
    if width == head_dim:
        return (q * cos + _rotate_half(q) * sin,
                k * cos + _rotate_half(k) * sin)
    q_rot, q_pass = q[..., :width], q[..., width:]
    k_rot, k_pass = k[..., :width], k[..., width:]
    q_rot = q_rot * cos + _rotate_half(q_rot) * sin
    k_rot = k_rot * cos + _rotate_half(k_rot) * sin
    return torch.cat([q_rot, q_pass], dim=-1), torch.cat([k_rot, k_pass],
                                                         dim=-1)


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Per-head ALiBi slopes (Press et al. 2022, the HF ``build_alibi_
    tensor`` closed form): geometric sequence ``2^(-8/n)`` powers for
    power-of-two head counts, interleaved from the next power of two
    otherwise."""

    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]

    if math.log2(num_heads).is_integer():
        return np.asarray(pow2(num_heads), np.float32)
    closest = 2 ** int(math.floor(math.log2(num_heads)))
    extra = pow2(2 * closest)[0::2][:num_heads - closest]
    return np.asarray(pow2(closest) + extra, np.float32)


def _alibi_bias(slopes, q_pos, k_pos, num_kv_heads: int):
    """(…, Hkv, G, T, S) additive logit bias ``slope_h · (k - q)``;
    ``q_pos``/``k_pos`` (T, S)-broadcastable, or (B, T, S) ragged."""
    rel = (k_pos - q_pos).to(torch.float32)
    s = torch.as_tensor(np.asarray(slopes, np.float32),
                        device=rel.device).reshape(num_kv_heads, -1)
    if rel.ndim == 3:  # ragged: (B, T, S) -> (B, Hkv, G, T, S)
        return s[None, :, :, None, None] * rel[:, None, None]
    return s[:, :, None, None] * rel  # (Hkv, G, T, S)


def _group_query_heads(q, num_kv_heads: int):
    """(B, Hq, T, D) -> (B, Hkv, G, T, D) where G = Hq // Hkv."""
    B, Hq, T, D = q.shape
    return q.reshape(B, num_kv_heads, Hq // num_kv_heads, T, D)


def _attend(q, k, v, mask, bias=None, scale=None, softcap=None,
            dropout_rate=0.0, generator=None):
    """Masked softmax attention with grouped query heads.

    q: (B, Hkv, G, T, D); k, v: (B, Hkv, S, D); ``mask`` broadcastable to
    (B, Hkv, G, T, S) with True = attend.  Scores are fp32 (the JAX
    package pins HIGHEST precision for fp32 inputs; the card's fp32
    matmuls must run without TF32 to match).  Softcap ``c·tanh(s/c)``
    comes after the scale and before the bias and mask.  Dropout (rate > 0
    with a ``generator``) keeps each probability with probability
    ``1 - rate`` and rescales it, as the JAX reference's Bernoulli draw
    does (same distribution, different numbers)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    logits = torch.einsum("bhgtd,bhsd->bhgts", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    if bias is not None:
        logits = logits + bias
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if dropout_rate > 0.0 and generator is not None:
        keep = torch.rand(probs.shape, generator=generator,
                          device=probs.device) < 1.0 - dropout_rate
        probs = torch.where(keep, probs / (1.0 - dropout_rate), 0.0)
    return torch.einsum("bhgts,bhsd->bhgtd", probs.to(v.dtype), v)


def causal_attention_reference(q, k, v, dropout_rate=0.0, generator=None,
                               window: Optional[int] = None,
                               alibi: Optional[np.ndarray] = None,
                               scale: Optional[float] = None,
                               softcap: Optional[float] = None):
    """Plain causal attention. q: (B, Hq, T, D); k, v: (B, Hkv, T, D).

    ``window``: query t attends keys in ``(t - window, t]``; ``alibi``:
    per-query-head slopes of a linear position bias."""
    B, Hq, T, D = q.shape
    num_kv_heads = k.shape[1]
    qg = _group_query_heads(q, num_kv_heads)
    q_pos = torch.arange(T, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - int(window)
    bias = (None if alibi is None
            else _alibi_bias(alibi, q_pos, k_pos, num_kv_heads))
    out = _attend(qg, k, v, mask, bias=bias, scale=scale, softcap=softcap,
                  dropout_rate=dropout_rate, generator=generator)
    return out.reshape(B, Hq, T, D)


def causal_attention(q, k, v, dropout_rate=0.0, seed=None, generator=None,
                     window: Optional[int] = None,
                     alibi: Optional[np.ndarray] = None,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None):
    """Causal self-attention (training and the no-cache forward), with a
    gradient.  q: (B, Hq, T, D); k, v: (B, Hkv, T, D).

    Goes to the flash kernels (ops/kernels/flash_attention.py: CUDA
    tensors launch them or raise, CPU tensors run their plain version),
    with hash dropout from the int32 ``seed`` when ``dropout_rate`` > 0.
    A logit ``softcap`` goes to :func:`causal_attention_reference` with a
    one-time warning, the JAX package's rule: the flash backward has no
    capped variant; its dropout draws from ``generator``."""
    if softcap is not None:
        _warn_once("softcap_reference",
                   "logit softcap: flash kernel unavailable for the "
                   "training/prefill path (no capped-gradient backward); "
                   "using the O(T^2) reference")
        return causal_attention_reference(q, k, v, dropout_rate, generator,
                                          window=window, alibi=alibi,
                                          scale=scale, softcap=softcap)
    from penroz_tpu_torch.ops.kernels import flash_attention as fa
    return fa.flash_attention(q, k, v, window=window, alibi=alibi,
                              scale=scale, dropout_rate=dropout_rate,
                              seed=seed)


def cached_attention(q, k_full, v_full, offset, length,
                     k_scale=None, v_scale=None,
                     window: Optional[int] = None,
                     alibi: Optional[np.ndarray] = None,
                     scale: Optional[float] = None,
                     softcap: Optional[float] = None):
    """Attention of T new queries over a preallocated KV cache.

    q: (B, Hq, T, D) at positions ``offset + [0, T)``; k_full/v_full:
    (B, Hkv, S_max, D) after the current append; ``length`` = offset + T
    valid entries, an int or a (B,) tensor of per-sequence lengths.  With
    ``k_scale``/``v_scale`` (B, Hkv, S_max, 1) the cache is int8.

    CUDA tensors go to the hand-written kernel (or raise); CPU tensors to
    its plain version — see ops/kernels/decode_attention.py."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together "
                         "(int8 caches carry scales for both streams)")
    from penroz_tpu_torch.ops.kernels import decode_attention as da
    return da.decode_attention(q, k_full, v_full, offset, length,
                               k_scale=k_scale, v_scale=v_scale,
                               window=window, alibi=alibi, scale=scale,
                               softcap=softcap)


def paged_cached_attention(q, flat_k, flat_v, block_table, page_size: int,
                           offset, length, k_scale=None, v_scale=None,
                           window: Optional[int] = None,
                           alibi: Optional[np.ndarray] = None,
                           scale: Optional[float] = None,
                           softcap: Optional[float] = None):
    """Cached attention over a paged KV pool (block-table indirection).

    q: (B, Hq, T, D); flat_k/flat_v: (Hkv, pool_rows, D) head-major pools
    (int8 with ``k_scale``/``v_scale`` (Hkv, pool_rows, 1)); block_table
    (B, pages_per_seq) int32.  CUDA tensors go to the paged kernel (or
    raise); CPU tensors to its plain version — see
    ops/kernels/paged_attention.py."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together "
                         "(int8 pools carry scales for both streams)")
    from penroz_tpu_torch.ops.kernels import paged_attention as pa
    return pa.paged_decode_attention(q, flat_k, flat_v, block_table,
                                     page_size, offset, length,
                                     k_scale=k_scale, v_scale=v_scale,
                                     window=window, alibi=alibi, scale=scale,
                                     softcap=softcap)


def ragged_paged_cached_attention(q, flat_k, flat_v, block_table,
                                  page_size: int, descs, k_scale=None,
                                  v_scale=None,
                                  window: Optional[int] = None,
                                  alibi: Optional[np.ndarray] = None,
                                  scale: Optional[float] = None,
                                  softcap: Optional[float] = None):
    """Unified mixed-batch attention over a paged pool (the continuous-
    batching path): prefill chunks and decode steps of many rows in one
    launch.  CUDA tensors go to the ragged kernel (or raise); CPU tensors
    to its plain version — see ops/kernels/ragged_paged_attention.py."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale must be passed together "
                         "(int8 pools carry scales for both streams)")
    from penroz_tpu_torch.ops.kernels import ragged_paged_attention as rpa
    return rpa.ragged_paged_attention(q, flat_k, flat_v, block_table,
                                      page_size, descs, k_scale=k_scale,
                                      v_scale=v_scale, window=window,
                                      alibi=alibi, scale=scale,
                                      softcap=softcap)
