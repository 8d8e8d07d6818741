"""Contiguous KV caches for autoregressive decoding (counterpart of
penroz_tpu/ops/kv_cache.py ``KVState``/``QuantKVState``/``create_kv_state``).

Per-layer (B, Hkv, S_max, D) buffers preallocated once per generation; a
single valid ``length`` shared by all layers advances once per model step.
The JAX states are functional pytrees that return new states; these update
their buffers and length IN PLACE (``append`` writes a slice, ``advanced``
and ``reset`` move the length and return ``self``), which is what eager
PyTorch wants — no copy of the cache per step.

``TURBO_QUANT_KV_CACHE=1`` selects the int8 cache with per-token scales;
the attention consumer reads the raw int8 buffers and dequantizes per tile
inside the kernel.  The paged pool (``PAGED_KV_CACHE=1``) is not ported
yet.
"""

from __future__ import annotations

import logging
import os

import torch

log = logging.getLogger(__name__)

TURBO_QUANT_ENV = "TURBO_QUANT_KV_CACHE"
PAGED_ENV = "PAGED_KV_CACHE"


def turbo_quant_enabled() -> bool:
    return os.environ.get(TURBO_QUANT_ENV, "0") == "1"


def paged_enabled() -> bool:
    return os.environ.get(PAGED_ENV, "0") == "1"


def _quantize_int8(t):
    """Per-token int8 quantization: scale = amax over head dim / 127
    (0 → 1), round half to even, clip to [-128, 127] — bit for bit the
    JAX package's."""
    abs_max = torch.amax(torch.abs(t), dim=-1, keepdim=True)
    scale = abs_max / 127.0
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(t / scale), -128, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize_int8(q, scale, dtype):
    return (q.to(torch.float32) * scale).to(dtype)


class KVState:
    """Preallocated KV buffers: per-layer (B, Hkv, S_max, D), updated in
    place.  ``length`` is a host int: the contiguous path never needs a
    device read to know where to write."""

    quantized = False

    def __init__(self, k, v, length: int = 0):
        self.k = list(k)
        self.v = list(v)
        self._length = int(length)

    @property
    def length(self) -> int:
        return self._length

    @classmethod
    def create(cls, specs, batch: int, max_len: int, dtype=torch.float32,
               device=None):
        """``specs``: per-attention-layer (num_kv_heads, head_dim)."""
        k = [torch.zeros((batch, h, max_len, d), dtype=dtype, device=device)
             for h, d in specs]
        v = [torch.zeros((batch, h, max_len, d), dtype=dtype, device=device)
             for h, d in specs]
        return cls(k, v, 0)

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] if self.k else 0

    def _slot(self, new):
        start, stop = self._length, self._length + new.shape[2]
        if stop > self.max_len:
            raise ValueError(f"KV append of {new.shape[2]} token(s) at "
                             f"length {start} exceeds capacity "
                             f"{self.max_len}")
        return slice(start, stop)

    def append(self, layer_idx: int, k_new, v_new):
        """Write new K/V at the current length; return the full buffers and
        the length after the append.  Does NOT advance ``length`` — the
        model advances it once per step (``advanced``) after every layer
        has appended."""
        slot = self._slot(k_new)
        self.k[layer_idx][:, :, slot] = k_new
        self.v[layer_idx][:, :, slot] = v_new
        return self.k[layer_idx], self.v[layer_idx], slot.stop

    def advanced(self, num_tokens: int):
        """Advance the valid length by ``num_tokens`` (in place)."""
        self._length += int(num_tokens)
        return self

    def reset(self):
        """Empty the cache (in place; stale rows are never attended)."""
        self._length = 0
        return self

    def memory_bytes(self) -> int:
        """Bytes of the K/V value buffers (int8 scales not included, as in
        the JAX package)."""
        return sum(a.numel() * a.element_size() for a in (*self.k, *self.v))

    def logical_bytes(self) -> int:
        """Bytes an unquantized cache of the same shape would occupy."""
        return self.memory_bytes()


class QuantKVState(KVState):
    """Int8 KV buffers with per-token fp32 scales (TurboQuant)."""

    quantized = True

    def __init__(self, k, v, length, k_scale, v_scale,
                 out_dtype=torch.float32):
        super().__init__(k, v, length)
        self.k_scale = list(k_scale)
        self.v_scale = list(v_scale)
        self.out_dtype = out_dtype

    @classmethod
    def create(cls, specs, batch: int, max_len: int, dtype=torch.float32,
               device=None):
        def zeros(h, d, dt):
            return torch.zeros((batch, h, max_len, d), dtype=dt,
                               device=device)
        k = [zeros(h, d, torch.int8) for h, d in specs]
        v = [zeros(h, d, torch.int8) for h, d in specs]
        ks = [zeros(h, 1, torch.float32) for h, _ in specs]
        vs = [zeros(h, 1, torch.float32) for h, _ in specs]
        return cls(k, v, 0, ks, vs, out_dtype=dtype)

    def append_raw(self, layer_idx: int, k_new, v_new):
        """Quantize + store; return the RAW int8 buffers and the new length.
        The consumer passes the scales to ``cached_attention`` so that
        dequantization happens per tile inside the kernel — no
        full-precision copy of the cache is ever made."""
        slot = self._slot(k_new)
        qk, sk = _quantize_int8(k_new)
        qv, sv = _quantize_int8(v_new)
        for buf, new in ((self.k, qk), (self.v, qv),
                         (self.k_scale, sk), (self.v_scale, sv)):
            buf[layer_idx][:, :, slot] = new
        return self.k[layer_idx], self.v[layer_idx], slot.stop

    def append(self, layer_idx: int, k_new, v_new):
        """Store + return the dequantized full cache (the oracle of
        :meth:`append_raw`; the decode path uses the raw variant)."""
        qk, qv, new_length = self.append_raw(layer_idx, k_new, v_new)
        return (_dequantize_int8(qk, self.k_scale[layer_idx], self.out_dtype),
                _dequantize_int8(qv, self.v_scale[layer_idx], self.out_dtype),
                new_length)

    def logical_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.out_dtype).element_size()
        return sum(a.numel() * itemsize for a in (*self.k, *self.v))


def create_kv_state(specs, batch: int, max_len: int, dtype=torch.float32,
                    quantized: bool | None = None, paged: bool | None = None,
                    device=None) -> KVState:
    """Factory honouring ``TURBO_QUANT_KV_CACHE=1``.  ``PAGED_KV_CACHE=1``
    raises: the paged pool and its kernels are still to be ported
    (ROADMAP.md)."""
    if quantized is None:
        quantized = turbo_quant_enabled()
    if paged is None:
        paged = paged_enabled()
    if paged:
        raise NotImplementedError(
            f"{PAGED_ENV}=1: the paged KV pool is not ported to "
            "penroz_tpu_torch yet (ROADMAP.md, Queue 1)")
    if quantized:
        log.info("TurboQuant KV cache enabled (%s=1)", TURBO_QUANT_ENV)
        return QuantKVState.create(specs, batch, max_len, dtype, device)
    return KVState.create(specs, batch, max_len, dtype, device)
