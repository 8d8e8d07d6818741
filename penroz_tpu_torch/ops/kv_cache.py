"""KV caches for autoregressive decoding (counterpart of
penroz_tpu/ops/kv_cache.py ``KVState``/``QuantKVState``/``PagedKVState``/
``QuantPagedKVState``/``create_kv_state``).

Contiguous caches hold per-layer (B, Hkv, S_max, D) buffers preallocated
once per generation; a single valid ``length`` shared by all layers
advances once per model step.  The JAX states are functional pytrees that
return new states; these update their buffers and length IN PLACE
(``append`` writes a slice, ``advanced`` and ``reset`` move the length and
return ``self``), which is what eager PyTorch wants — no copy of the cache
per step.

Device positions (the captured decode step of models/decode_graphs.py):
while a state is bound to :class:`StepPositions` (``at_positions``), every
append writes at the bound device positions (``index_copy_``; paged rows
computed on the device through the block table, which the host filled for
the whole chunk before the dispatch) and returns the bound device length,
and nothing reads or moves the host ``length``; the host mirrors it after
the chunk (``advanced``).

Every variant may carry an ``ssm`` child: the fixed-size recurrent state of
a hybrid model's ``ssm`` layers (ops/ssm.py::SSMState), attached by
``create_kv_state(..., ssm_specs=...)``, emptied by ``reset``, counted by
``memory_bytes`` (the ledger's ``ssm_state``) and carried by every row
method: ``reset_row`` zeroes the row's state, ``rollback_row`` restores it
from its checkpoint ring, ``row_view``/``merge_row`` slice and write it
back, and the paged hand-off's ``export_row_pages``/``import_row_pages``
carry it under ``"ssm"``.  A pure-SSM model's cache has no K/V layers and
only that child.

``TURBO_QUANT_KV_CACHE=1`` selects the int8 cache with per-token scales;
the attention consumer reads the raw int8 buffers and dequantizes per tile
inside the kernel.

``PAGED_KV_CACHE=1`` selects the paged pool, in the JAX layout: per-layer
head-major pools ``(Hkv, num_pages * page_size, D)``, a ``(B,
pages_per_seq)`` int32 block table with -1 for unassigned pages, and, for
int8 pools, ``(Hkv, rows, 1)`` fp32 per-token scales.  The JAX bump
allocator runs inside jit; here it is host arithmetic on a numpy table
(the authoritative copy), mirrored to a device tensor only when a page is
handed out.  The scatter rows of a step are computed on the device from
the host length (single sequence) or on the host from the descriptors
(packed mixed batches), so no step reads the device back.

``PENROZ_PREFIX_CACHE=1`` (with the paged pool) reserves
``PENROZ_PREFIX_CACHE_PAGES`` pages (default 64) past the rows' static
partition (``create_kv_state(extra_pool_pages=…)``); :class:`RadixPrefixCache`
decides which of them hold which whole-page prompt blocks, and the pool
aliases them into a row's table (``with_row_prefix``) and copies a
finished prompt's pages into them (``copy_pages``).  Every table rewrite
goes through ``_upload_table``, in stream order, so it cannot race a step
still in flight.

Disaggregated prefill moves a finished prompt's pages between two engines'
pools: ``export_row_pages`` gathers a row's logical pages through its block
table into a blob of per-layer planes (on the card for the d2d transport,
on the host for the page-blob codec of utils/checkpoint.py) and
``import_row_pages`` scatters such a blob into another row's own pages.
In the JAX package these are plain array indexing outside any Pallas
kernel, so here they stay torch indexing (``index_select`` and
``index_copy_`` on the pool's planes), with no kernel of their own.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from penroz_tpu_torch.ops.ssm import SSMState

log = logging.getLogger(__name__)

TURBO_QUANT_ENV = "TURBO_QUANT_KV_CACHE"
PAGED_ENV = "PAGED_KV_CACHE"
PAGE_SIZE_ENV = "PENROZ_KV_PAGE_SIZE"
PREFIX_CACHE_ENV = "PENROZ_PREFIX_CACHE"
PREFIX_CACHE_PAGES_ENV = "PENROZ_PREFIX_CACHE_PAGES"

# -- pool-capacity drop accounting ------------------------------------------
# A paged append past ``max_len`` clamps onto the last page (the JAX
# allocator's contract) and a packed append drops its out-of-range slots;
# the callers that can see such an overflow coming count it here, so
# /serving_stats/ can surface silent truncation.
_POOL_DROP_LOCK = threading.Lock()
_POOL_DROPS = 0
_POOL_DROP_WARNED = False


def record_pool_drop(tokens: int = 1, context: str = ""):
    """Count ``tokens`` KV writes dropped/overwritten at pool capacity.
    Logs a warning on the first occurrence (per process)."""
    global _POOL_DROPS, _POOL_DROP_WARNED
    with _POOL_DROP_LOCK:
        _POOL_DROPS += int(tokens)
        first = not _POOL_DROP_WARNED
        _POOL_DROP_WARNED = True
    if first:
        log.warning(
            "KV pool capacity exceeded for the first time (%d token(s) "
            "dropped%s) — sequences hitting this are truncated; grow the "
            "pool (block_size / pool_pages) or admit fewer rows",
            tokens, f"; {context}" if context else "")


def pool_drop_count() -> int:
    return _POOL_DROPS


def reset_pool_drop_count():
    """Test hook: zero the counter and re-arm the first-occurrence warning."""
    global _POOL_DROPS, _POOL_DROP_WARNED
    with _POOL_DROP_LOCK:
        _POOL_DROPS = 0
        _POOL_DROP_WARNED = False


# Radix unpin underflows, process-wide (``penroz_prefix_cache_unpin_underflow``
# on /metrics; each cache also counts its own): any nonzero value is a
# pin/unpin pairing bug.  Warned once per node key.
_UNPIN_UNDERFLOW_LOCK = threading.Lock()
_UNPIN_UNDERFLOWS = 0
_UNPIN_UNDERFLOW_WARNED: set = set()


def record_unpin_underflow(key):
    """Count one negative-refcount unpin on the radix node labelled ``key``;
    warn the first time each distinct key underflows."""
    global _UNPIN_UNDERFLOWS
    with _UNPIN_UNDERFLOW_LOCK:
        _UNPIN_UNDERFLOWS += 1
        first = key not in _UNPIN_UNDERFLOW_WARNED
        _UNPIN_UNDERFLOW_WARNED.add(key)
    if first:
        log.warning("RadixPrefixCache.unpin underflow on node key %r: "
                    "refcount went negative (an unpaired unpin), clamped "
                    "to 0", key)


def unpin_underflow_count() -> int:
    return _UNPIN_UNDERFLOWS


def reset_unpin_underflow_count():
    """Test hook: zero the counter and re-arm the per-key warnings."""
    global _UNPIN_UNDERFLOWS
    with _UNPIN_UNDERFLOW_LOCK:
        _UNPIN_UNDERFLOWS = 0
        _UNPIN_UNDERFLOW_WARNED.clear()


def turbo_quant_enabled() -> bool:
    return os.environ.get(TURBO_QUANT_ENV, "0") == "1"


def paged_enabled() -> bool:
    return os.environ.get(PAGED_ENV, "0") == "1"


def prefix_cache_enabled() -> bool:
    """``PENROZ_PREFIX_CACHE=1`` opts into radix prefix-KV sharing over the
    paged pool (page granularity is the sharing unit; the
    continuous-batching scheduler checks ``PAGED_KV_CACHE=1`` too)."""
    return os.environ.get(PREFIX_CACHE_ENV, "0") == "1"


def prefix_cache_pages() -> int:
    """Pool pages reserved for the radix prefix cache
    (``PENROZ_PREFIX_CACHE_PAGES``, default 64)."""
    raw = os.environ.get(PREFIX_CACHE_PAGES_ENV, "64")
    try:
        pages = int(raw)
        if pages < 0:
            raise ValueError
    except ValueError:
        log.warning("Ignoring invalid %s=%r; using 64",
                    PREFIX_CACHE_PAGES_ENV, raw)
        return 64
    return pages


def default_page_size() -> int:
    raw = os.environ.get(PAGE_SIZE_ENV, "128")
    try:
        size = int(raw)
        if size <= 0:
            raise ValueError
    except ValueError:
        log.warning("Ignoring invalid %s=%r; using 128", PAGE_SIZE_ENV, raw)
        return 128
    return size


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


class StepPositions(NamedTuple):
    """Where one step's T fed tokens go, on the device: ``index`` (T,)
    int64 cache positions shared by every row, or (B, T) one row each;
    ``length`` (B,) int32, the valid length after the append; ``keep``
    (B, T) bool or None: which per-row writes land (a row parked at the
    end of its cache writes nothing)."""
    index: torch.Tensor
    length: torch.Tensor
    keep: Optional[torch.Tensor] = None


def step_positions(pos, T: int, batch: int) -> StepPositions:
    """:class:`StepPositions` of T tokens fed at the (1,) int64 device
    position ``pos`` (the cache length before the step), for ``batch``
    rows sharing it."""
    index = pos if T == 1 else pos + torch.arange(T, device=pos.device)
    length = (pos + T).to(torch.int32).expand(batch)
    return StepPositions(index, length)


def row_positions(lengths, T: int, max_len: int) -> StepPositions:
    """:class:`StepPositions` of T tokens fed to each row at its own (B,)
    int device length ``lengths``: positions past ``max_len`` keep the
    cache as it was (the JAX package drops such writes) and the valid
    length stops at ``max_len``."""
    pos = lengths.to(torch.int64)[:, None] + torch.arange(
        T, device=lengths.device)
    return StepPositions(torch.clamp(pos, max=max_len - 1),
                         torch.clamp(pos[:, -1] + 1, max=max_len).to(
                             torch.int32),
                         pos < max_len)


class KVState:
    """Preallocated KV buffers: per-layer (B, Hkv, S_max, D), updated in
    place.  ``length`` is a host int: the contiguous path never needs a
    device read to know where to write (under :meth:`at_positions` the
    bound device positions take its place)."""

    quantized = False

    def __init__(self, k, v, length: int = 0):
        self.k = list(k)
        self.v = list(v)
        self._length = int(length)
        # (B,) numpy per-row lengths after ``with_lengths`` (the batched
        # decode of the phased scheduler and of generate_tokens_batched)
        self.ragged_lengths = None
        self.ssm = None  # optional ops.ssm.SSMState (hybrid models)
        self.positions = None  # StepPositions while a step is bound

    def at_positions(self, positions):
        """Bind (a :class:`StepPositions`) or unbind (None) the device
        positions the next appends write at; returns ``self``."""
        self.positions = positions
        return self

    @property
    def length(self):
        if self.ragged_lengths is not None:
            return self.ragged_lengths
        return self._length

    @property
    def batch(self) -> int:
        if self.k:
            return self.k[0].shape[0]
        # a pure-SSM model's cache: no K/V layers, the shape it was made at
        return getattr(self, "_shape", (1, 0))[0]

    @classmethod
    def create(cls, specs, batch: int, max_len: int, dtype=torch.float32,
               device=None):
        """``specs``: per-attention-layer (num_kv_heads, head_dim)."""
        k = [torch.zeros((batch, h, max_len, d), dtype=dtype, device=device)
             for h, d in specs]
        v = [torch.zeros((batch, h, max_len, d), dtype=dtype, device=device)
             for h, d in specs]
        out = cls(k, v, 0)
        out._shape = (int(batch), int(max_len))
        return out

    @property
    def max_len(self) -> int:
        return self.k[0].shape[2] if self.k else getattr(self, "_shape",
                                                          (1, 0))[1]

    def _store(self, layer_idx: int, pairs):
        """Write each ``(buffers, new)`` pair's (B, H, T, ·) rows at the
        current length, each row's own (``with_lengths``) or the bound
        device positions; return the valid length after the append (a
        host int, a (B,) numpy array, or the bound (B,) device length)."""
        T = pairs[0][1].shape[2]
        if self.positions is None and self.ragged_lengths is not None:
            lengths = torch.as_tensor(self.ragged_lengths,
                                      device=pairs[0][1].device)
            self.positions = row_positions(lengths, T, self.max_len)
            try:
                self._store(layer_idx, pairs)
            finally:
                self.positions = None
            return self.ragged_lengths + T
        if self.positions is not None and self.positions.index.ndim == 2:
            index, keep = self.positions.index, self.positions.keep
            rows = torch.arange(index.shape[0], device=index.device)[:, None]
            for bufs, new in pairs:
                buf = bufs[layer_idx]
                vals = new.transpose(1, 2).to(buf.dtype)    # (B, T, H, ·)
                if keep is not None:
                    vals = torch.where(keep[..., None, None], vals,
                                       buf[rows, :, index])
                buf[rows, :, index] = vals
            return self.positions.length
        if self.positions is not None:
            for bufs, new in pairs:
                bufs[layer_idx].index_copy_(2, self.positions.index, new)
            return self.positions.length
        start, stop = self._length, self._length + T
        if stop > self.max_len:
            raise ValueError(f"KV append of {T} token(s) at length {start} "
                             f"exceeds capacity {self.max_len}")
        for bufs, new in pairs:
            bufs[layer_idx][:, :, start:stop] = new
        return stop

    def append(self, layer_idx: int, k_new, v_new):
        """Write new K/V at the current length; return the full buffers and
        the length after the append.  Does NOT advance ``length`` — the
        model advances it once per step (``advanced``) after every layer
        has appended."""
        length = self._store(layer_idx, ((self.k, k_new), (self.v, v_new)))
        return self.k[layer_idx], self.v[layer_idx], length

    def advanced(self, num_tokens: int):
        """Advance the valid length by ``num_tokens`` (in place)."""
        if self.ragged_lengths is not None:
            self.ragged_lengths = self.ragged_lengths + int(num_tokens)
        else:
            self._length += int(num_tokens)
        return self

    def reserve(self, length: int):
        """Make room for appends up to ``length`` before they are
        dispatched at device positions (a contiguous cache always has
        it)."""

    def reset(self):
        """Empty the cache (in place; stale rows are never attended)."""
        self._length = 0
        self.ragged_lengths = None
        self._reset_ssm()
        return self

    # -- per-row state (the phased scheduler; JAX ``with_lengths`` and the
    # row methods).  Lengths are host numbers: the scheduler's own array
    # stays authoritative, these only install it.

    def with_lengths(self, lengths):
        """Switch to ragged per-row (B,) valid lengths (in place): every
        row appends at its own position from here on."""
        self.ragged_lengths = np.asarray(lengths, np.int32).reshape(
            self.batch).copy()
        return self

    def with_static_table(self):
        """No-op: the rows of a contiguous cache own their buffers."""
        return self

    def _set_row_length(self, what: str, row: int, length: int):
        if self.ragged_lengths is None:
            raise ValueError(f"{what} requires ragged per-row lengths "
                             "(call with_lengths first)")
        self.ragged_lengths[int(row)] = int(length)
        return self

    @staticmethod
    def _row_length(src) -> int:
        """A batch-1 source's length (a scalar, or its one ragged entry)."""
        return int(np.asarray(src.length).reshape(-1)[0])

    def insert_row(self, row: int, src):
        """Copy a prefilled batch-1 state ``src`` of the same class and
        ``max_len`` into row ``row`` (its buffers, an int8 cache's scales,
        a recurrent child's state and ring) and set the row's ragged
        length to ``src``'s (JAX ``insert_row``: an admission prefilled in
        a cache of its own)."""
        if type(src) is not type(self):
            raise ValueError(f"insert_row source must be a "
                             f"{type(self).__name__} (got "
                             f"{type(src).__name__})")
        if src.max_len != self.max_len:
            raise ValueError(f"insert_row source max_len {src.max_len} != "
                             f"destination max_len {self.max_len}")
        r = int(row)
        for mine, theirs in zip(self._pool_lists(), src._pool_lists()):
            for a, b in zip(mine, theirs):
                a[r:r + 1].copy_(b.to(a.dtype))
        if self.ragged_lengths is None:
            self.with_lengths(np.full(self.batch, self._length, np.int32))
        self.ragged_lengths[r] = self._row_length(src)
        if self.ssm is not None:
            self.ssm.insert_row(r, src.ssm)
        return self

    def reset_row(self, row: int):
        """Zero row ``row``'s valid length (ragged states only); its stale
        entries stay, never attended.  A recurrent child's row is zeroed
        for real."""
        self._set_row_length("reset_row", row, 0)
        if self.ssm is not None:
            self.ssm.reset_row(int(row))
        return self

    def rollback_row(self, row: int, new_length: int):
        """Rewind row ``row``'s valid length to ``new_length`` (the
        speculative verify's rejected suffix; ragged states only): the
        rejected K/V stays as garbage the next append overwrites.  A
        recurrent child cannot be length-masked: its row restores the
        state checkpointed at ``new_length`` (ops/ssm.py ring)."""
        self._set_row_length("rollback_row", row, new_length)
        if self.ssm is not None:
            self.ssm.rollback_row(int(row), int(new_length))
        return self

    def _plane_names(self):
        """The names of the per-layer buffer lists: values, then an int8
        cache's scales (which travel with their values in every copy)."""
        return ("k", "v")

    def _pool_lists(self):
        return tuple(getattr(self, name) for name in self._plane_names())

    def _shallow(self):
        """A state object sharing every buffer, table and counter with
        this one (its lists are new lists of the same tensors)."""
        out = object.__new__(type(self))
        out.__dict__.update(self.__dict__)
        for name in self._plane_names():
            setattr(out, name, list(getattr(self, name)))
        return out

    def row_view(self, row: int, length: int):
        """Batch-1 state over row ``row``'s buffers (views: appends
        through it write the row in place) at scalar valid ``length`` —
        the substrate of a prefill chunk and a verify span.  A recurrent
        child's view is its row's slice too (``SSMState.row_view``)."""
        r = int(row)
        view = self._shallow()
        for name in self._plane_names():
            setattr(view, name, [a[r:r + 1] for a in getattr(self, name)])
        if self.ssm is not None:
            view.ssm = self.ssm.row_view(r)
        view._shape = (1, self.max_len)
        view._length = int(length)
        view.ragged_lengths = None
        view.positions = None
        return view

    def merge_row(self, row: int, view):
        """Write ``view``'s buffers back into row ``row`` (a no-op for a
        :meth:`row_view`, which wrote in place; a copied view, a recurrent
        child's too, is copied).  Lengths are untouched: the scheduler's
        host array stays authoritative."""
        r = int(row)
        for mine, theirs in zip(self._pool_lists(), view._pool_lists()):
            for a, b in zip(mine, theirs):
                dst = a[r:r + 1]
                if dst.data_ptr() != b.data_ptr():
                    dst.copy_(b)
        if self.ssm is not None:
            self.ssm.merge_row(r, view.ssm)
        return self

    def _reset_ssm(self):
        if self.ssm is not None:
            self.ssm.reset()

    def _ssm_bytes(self) -> int:
        return self.ssm.nbytes() if self.ssm is not None else 0

    def memory_bytes(self) -> int:
        """Bytes of the K/V value buffers (int8 scales not included, as in
        the JAX package) and of the recurrent ``ssm`` child."""
        return (sum(a.numel() * a.element_size() for a in (*self.k, *self.v))
                + self._ssm_bytes())

    def logical_bytes(self) -> int:
        """Bytes an unquantized K/V cache of the same shape would occupy."""
        return self.memory_bytes() - self._ssm_bytes()

    def hbm_components(self) -> dict:
        """Device bytes by component for the capacity ledger
        (serve/memledger.py): the K/V buffers and their int8 scales."""
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        return {"kv_values": nbytes((*self.k, *self.v)),
                "kv_scales": nbytes((*getattr(self, "k_scale", ()),
                                     *getattr(self, "v_scale", ()))),
                "kv_block_table": 0,
                "ssm_state": self._ssm_bytes()}


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
        out = cls(k, v, 0, ks, vs, out_dtype=dtype)
        out._shape = (int(batch), int(max_len))
        return out

    def append_raw(self, layer_idx: int, k_new, v_new):
        """Quantize + store; return the RAW int8 buffers and the new length.
        The consumer passes the scales to ``cached_attention`` so that
        dequantization happens per tile inside the kernel — no
        full-precision copy of the cache is ever made."""
        qk, sk = _quantize_int8(k_new)
        qv, sv = _quantize_int8(v_new)
        length = self._store(layer_idx, ((self.k, qk), (self.v, qv),
                                         (self.k_scale, sk),
                                         (self.v_scale, sv)))
        return self.k[layer_idx], self.v[layer_idx], length

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

    def _plane_names(self):
        return ("k", "v", "k_scale", "v_scale")


# ---------------------------------------------------------------------------
# Paged pool
# ---------------------------------------------------------------------------

def build_descriptors(spans, block_q: int, num_blocks: int):
    """Host-side descriptor builder for the ragged unified dispatch.

    ``spans``: an ordered list of ``(row, q_start, q_len)`` work items — a
    decode step is ``q_len = 1``, a prefill chunk ``q_len = chunk``.  Each
    span is cut into ``ceil(q_len / block_q)`` consecutive
    ``block_q``-token descriptor blocks ``(row, q_pos0, q_valid, kv_len)``
    with ``kv_len = q_start + q_len`` (the row's valid length after the
    append), padded with ``(-1, 0, 0, 0)`` rows up to ``num_blocks`` (the
    shape bucket — utils/bucketing.py::bucket_count).  Returns ``(descs,
    offsets)``: the ``(num_blocks, 4)`` int32 numpy array plus each span's
    first block index, so span token ``i`` sits at packed slot
    ``(offsets[s] + i // block_q) * block_q + i % block_q``."""
    descs = np.zeros((num_blocks, 4), np.int32)
    descs[:, 0] = -1
    offsets = []
    nb = 0
    for row, q_start, q_len in spans:
        offsets.append(nb)
        done = 0
        while done < q_len:
            take = min(block_q, q_len - done)
            if nb >= num_blocks:
                raise ValueError(
                    f"spans need more than num_blocks={num_blocks} "
                    f"descriptor blocks of block_q={block_q}")
            descs[nb] = (row, q_start + done, take, q_start + q_len)
            nb += 1
            done += take
    return descs, offsets


def packed_slots(offset: int, q_len: int, block_q: int) -> np.ndarray:
    """Packed-array slot index of each of a span's ``q_len`` tokens, given
    the span's first descriptor block ``offset``."""
    i = np.arange(int(q_len))
    return (int(offset) + i // int(block_q)) * int(block_q) + i % int(block_q)


class PagedKVState(KVState):
    """Paged KV cache: fixed-size pages in a shared pool + a block table.

    Per-layer pools ``(Hkv, num_pages * page_size, D)`` (head-major: one
    page of one head is a contiguous ``(page_size, D)`` block) and one
    ``(B, pages_per_seq)`` block table mapping each sequence's logical page
    to a physical page, -1 where none is assigned.  Pages are handed out by
    a bump allocator that frees only on ``reset``, so ``create`` refuses a
    pool smaller than ``batch * pages_per_seq``.

    The allocator is host arithmetic: ``table`` (numpy) is authoritative,
    ``block_table`` its device copy, rewritten only when an allocation
    hands out a page.  ``length`` is a host int, or a (B,) numpy array for
    ragged batches (``with_lengths``).  The attention kernels read the
    pools through ``block_table`` (ops/kernels/paged_attention.py,
    ops/kernels/ragged_paged_attention.py)."""

    quantized = False

    def __init__(self, k, v, table, page_size: int, pages_per_seq: int,
                 device=None):
        self.k = list(k)
        self.v = list(v)
        self.page_size = int(page_size)
        self.pages_per_seq = int(pages_per_seq)
        self.table = np.asarray(table, np.int32).copy()
        self.ssm = None  # optional ops.ssm.SSMState (hybrid models)
        self.device = (self.k[0].device if self.k
                       else torch.device(device or "cpu"))
        self.block_table = torch.as_tensor(self.table, device=self.device)
        self.positions = None
        self._length = 0
        self.ragged_lengths = None
        self.next_free = 0
        self.assigned_pages = 0
        self._rows_key = None  # (length, T): scatter rows of this step
        self._rows = None

    @classmethod
    def _create_pools(cls, specs, batch, max_len, dtype, page_size,
                      pool_pages, device):
        page = page_size or default_page_size()
        pages_per_seq = -(-max_len // page)
        num_pages = pool_pages or batch * pages_per_seq
        if num_pages < batch * pages_per_seq:
            raise ValueError(
                f"pool_pages={num_pages} cannot back {batch} sequence(s) of "
                f"{pages_per_seq} pages: the bump allocator frees only on "
                "reset, so an undersized pool would alias live pages")
        k = [torch.zeros((h, num_pages * page, d), dtype=dtype, device=device)
             for h, d in specs]
        v = [torch.zeros((h, num_pages * page, d), dtype=dtype, device=device)
             for h, d in specs]
        table = np.full((batch, pages_per_seq), -1, np.int32)
        return k, v, table, page, pages_per_seq

    @classmethod
    def create(cls, specs, batch: int, max_len: int, dtype=torch.float32,
               page_size: int | None = None, pool_pages: int | None = None,
               device=None):
        k, v, table, page, pages = cls._create_pools(
            specs, batch, max_len, dtype, page_size, pool_pages, device)
        return cls(k, v, table, page, pages, device=device)

    @property
    def length(self):
        if self.ragged_lengths is not None:
            return self.ragged_lengths
        return self._length

    @property
    def max_len(self) -> int:
        return self.pages_per_seq * self.page_size

    @property
    def batch(self) -> int:
        return self.table.shape[0]

    @property
    def num_pool_pages(self) -> int:
        if self.k:
            return self.k[0].shape[1] // self.page_size
        return int(self.table.size)

    def _upload_table(self):
        """Copy the host table into ``block_table`` (same address), in
        stream order and without waiting: from a pinned copy on the card,
        so a chunk can be allocated while the previous one runs."""
        table = torch.from_numpy(self.table)
        if self.block_table.is_cuda:
            table = table.pin_memory()
        self.block_table.copy_(table, non_blocking=True)
        self._rows_key = None

    def _allocate(self, new_length):
        """Bump-allocate physical pages covering ``[0, new_length)`` (the
        JAX allocator's arithmetic, on the host).  Idempotent within a
        step: every layer's append calls it with the same length, and
        ``assigned_pages`` makes the later calls hand out nothing.  Ragged
        lengths allocate uniformly to the longest sequence; the counters
        never walk backwards (a recycled row or a static table)."""
        P, S = self.page_size, self.pages_per_seq
        new_length = int(np.max(new_length))
        needed = max(min(-(-new_length // P), S), self.assigned_pages)
        delta = needed - self.assigned_pages
        if delta <= 0:
            return
        slots = np.arange(self.assigned_pages, needed)
        b_idx = np.arange(self.batch)[:, None]
        self.table[:, slots] = (self.next_free + b_idx * delta
                                + (slots[None, :] - self.assigned_pages))
        self.next_free += self.batch * delta
        self.assigned_pages = needed
        self._upload_table()

    def reserve(self, length: int):
        """Hand out the pages covering ``[0, length)`` now, so a chunk of
        steps at device positions finds them in the table."""
        self._allocate(length)

    def _note_overflow(self, T: int):
        over = int(np.max(self.length)) + int(T) - self.max_len
        if over > 0:
            record_pool_drop(over, context=f"paged pool max_len="
                                           f"{self.max_len}")

    def _allocate_rows(self, T: int):
        """Allocate pages for ``T`` new tokens; return the flat pool row of
        each (batch, token), b-major, on the pool's device, and the new
        valid length.  A position past ``max_len`` clamps onto the last
        logical page, as the JAX allocator does.  Under bound device
        positions nothing is allocated (the pages are already in the
        table; an unassigned one reads as page 0) and the rows come from
        the device table."""
        P, S = self.page_size, self.pages_per_seq
        if self.positions is not None:
            index = self.positions.index
            page = torch.clamp(index // P, max=S - 1)
            table = (torch.gather(self.block_table, 1, page)
                     if index.ndim == 2 else self.block_table[:, page])
            phys = torch.clamp(table, min=0)
            rows = phys.to(torch.int64) * P + index % P
            return rows.reshape(-1), self.positions.length
        self._note_overflow(T)
        new_length = self.length + T
        self._allocate(new_length)
        if self.ragged_lengths is not None:
            pos = self.ragged_lengths[:, None] + np.arange(T)[None, :]
            page = np.clip(pos // P, 0, S - 1)
            phys = np.take_along_axis(self.table, page, axis=1)
            rows = torch.as_tensor((phys * P + pos % P).reshape(-1),
                                   dtype=torch.int64, device=self.device)
            return rows, new_length
        key = (self._length, T)
        if self._rows_key != key:
            pos = torch.arange(T, device=self.device) + self._length
            page = torch.clamp(pos // P, max=S - 1)
            phys = self.block_table[:, page].to(torch.int64)  # (B, T)
            self._rows = (phys * P + pos % P).reshape(-1)
            self._rows_key = key
        return self._rows, new_length

    @staticmethod
    def _to_rows(t):
        """(B, H, T, d) -> head-major flat rows (H, B*T, d)."""
        B, H, T, d = t.shape
        return t.transpose(0, 1).reshape(H, B * T, d)

    def _scatter(self, pools, layer_idx, rows, new):
        pool = pools[layer_idx]
        new = new.to(pool.dtype)
        keep = self.positions.keep if self.positions is not None else None
        if keep is not None:    # a parked row's slots keep what they hold
            new = torch.where(keep.reshape(1, -1, 1), new,
                              pool.index_select(1, rows))
        pool.index_copy_(1, rows, new)

    def append_rows(self, layer_idx: int, k_new, v_new):
        """Scatter new K/V into the page pools; return the flat pools and
        the length after the append (not advanced: the model advances it
        once per step).  Precondition ``length + T <= max_len``: past it
        the write clamps onto the last page (counted by
        :func:`record_pool_drop`), as in the JAX package."""
        rows, new_length = self._allocate_rows(k_new.shape[2])
        self._scatter(self.k, layer_idx, rows, self._to_rows(k_new))
        self._scatter(self.v, layer_idx, rows, self._to_rows(v_new))
        return self.k[layer_idx], self.v[layer_idx], new_length

    def append(self, layer_idx: int, k_new, v_new):
        raise TypeError("a paged pool is written by append_rows or "
                        "append_packed and read through its block table")

    # -- ragged packed-batch path (unified mixed dispatch) ------------------

    def packed_rows(self, descs, block_q: int) -> np.ndarray:
        """Flat pool row per PACKED token for a ``(NB, 4)`` descriptor
        array (host numpy, the JAX function's result).  Padding slots
        (row = -1, t >= q_valid, or a position >= max_len) map to the
        pool's row count, past its end: :meth:`append_packed` drops them.
        Requires the rows' tables to be assigned (``with_static_table``)."""
        P = self.page_size
        descs = np.asarray(descs, np.int32)
        t = np.arange(int(block_q), dtype=np.int32)[None, :]
        row = descs[:, 0:1]
        pos = descs[:, 1:2] + t
        valid = (t < descs[:, 2:3]) & (row >= 0) & (pos < self.max_len)
        page = np.clip(pos // P, 0, self.pages_per_seq - 1)
        phys = self.table[np.clip(row, 0, None), page]
        rows = phys.astype(np.int64) * P + pos % P
        oob = self.k[0].shape[1] if self.k else 0
        return np.where(valid & (phys >= 0), rows, oob).reshape(-1)

    def packed_index(self, rows) -> tuple:
        """``(slots, pool_rows)`` (host int64 arrays): the packed slots that
        land in the pool and their rows, from a :meth:`packed_rows` array.
        torch has no dropping scatter — an out-of-range index on the card is
        a device assert — so the dropped slots are left out instead."""
        rows = np.asarray(rows, np.int64)
        oob = self.k[0].shape[1] if self.k else 0
        slots = np.nonzero(rows < oob)[0]
        return slots, rows[slots]

    def _device_index(self, index):
        """``(slots, pool_rows)`` int64 tensors on the pool's device, from a
        :meth:`packed_rows` array or such a pair (host or device)."""
        if not isinstance(index, tuple):
            index = self.packed_index(index)
        return tuple(torch.as_tensor(a, dtype=torch.int64, device=self.device)
                     for a in index)

    def append_packed(self, layer_idx: int, k_new, v_new, index):
        """Scatter a PACKED mixed batch into the pools.  ``k_new``/
        ``v_new``: (1, Hkv, Tp, D); ``index``: a :meth:`packed_rows` array,
        or its :meth:`packed_index` pair (on the device, shared across
        layers, on the hot path).  Lengths are not advanced: the
        descriptors carry the post-append lengths."""
        slots, rows = self._device_index(index)
        self._scatter(self.k, layer_idx, rows, k_new[0][:, slots])
        self._scatter(self.v, layer_idx, rows, v_new[0][:, slots])
        return self.k[layer_idx], self.v[layer_idx]

    def lengths_after_packed(self, descs) -> np.ndarray:
        """Per-row (B,) valid lengths after a packed append: each live
        descriptor raises its row to its ``kv_len``."""
        descs = np.asarray(descs, np.int32)
        lens = self._row_lengths().copy()
        for row, _, _, kv_len in descs:
            if row >= 0:
                lens[row] = max(lens[row], kv_len)
        return lens

    def _row_lengths(self) -> np.ndarray:
        if self.ragged_lengths is not None:
            return self.ragged_lengths
        return np.full(self.batch, self._length, np.int32)

    def advanced(self, num_tokens: int):
        if self.ragged_lengths is not None:
            self.ragged_lengths = self.ragged_lengths + int(num_tokens)
        else:
            self._length += int(num_tokens)
        return self

    def with_lengths(self, lengths):
        """Switch to ragged per-row lengths (in place)."""
        self.ragged_lengths = np.asarray(lengths, np.int32).reshape(
            self.batch).copy()
        return self

    def reset(self):
        self.table[:] = -1
        self._length = 0
        self.ragged_lengths = None
        self.next_free = 0
        self.assigned_pages = 0
        self._upload_table()
        self._reset_ssm()
        return self

    def insert_row(self, row: int, src):
        """Copy a prefilled batch-1 paged state ``src`` (its pages in
        order from the pool's start, the JAX layout) into row ``row``'s
        static-partition pages, with its length and its recurrent child
        (JAX ``PagedKVState.insert_row``).  Partitions the pool first."""
        if type(src) is not type(self):
            raise ValueError(f"insert_row source must be a "
                             f"{type(self).__name__} (got "
                             f"{type(src).__name__})")
        if (src.page_size, src.pages_per_seq) != (self.page_size,
                                                  self.pages_per_seq):
            raise ValueError(
                f"insert_row source page layout ({src.page_size}, "
                f"{src.pages_per_seq}) != destination ({self.page_size}, "
                f"{self.pages_per_seq})")
        self.with_static_table()
        span = self.pages_per_seq * self.page_size
        start = int(row) * span
        for mine, theirs in zip(self._pool_lists(), src._pool_lists()):
            for a, b in zip(mine, theirs):
                a[:, start:start + span].copy_(b[:, :span].to(a.dtype))
        if self.ragged_lengths is None:
            self.with_lengths(np.full(self.batch, self._length, np.int32))
        self.ragged_lengths[int(row)] = self._row_length(src)
        if self.ssm is not None:
            self.ssm.insert_row(int(row), src.ssm)
        return self

    def reset_row(self, row: int):
        """Zero row ``row``'s valid length (ragged states only); its stale
        pages stay, never attended.  A recurrent child's row is zeroed for
        real."""
        if self.ragged_lengths is None:
            raise ValueError("reset_row requires ragged per-row lengths "
                             "(call with_lengths first)")
        self.ragged_lengths[int(row)] = 0
        if self.ssm is not None:
            self.ssm.reset_row(int(row))
        return self

    def with_static_table(self):
        """Partition the pool statically: row ``i`` owns physical pages
        ``[i*S, (i+1)*S)``, so appends are pure scatters into each row's
        own pages and a recycled row overwrites its own stale pages."""
        B, S = self.table.shape
        if self.num_pool_pages < B * S:
            raise ValueError(
                f"static page table needs pool_pages >= batch*pages_per_seq "
                f"({B}*{S}); pool has {self.num_pool_pages}")
        self.table[:] = (np.arange(B, dtype=np.int32)[:, None] * S
                         + np.arange(S, dtype=np.int32)[None, :])
        self.next_free = B * S
        self.assigned_pages = S
        self._upload_table()
        return self

    def with_row_prefix(self, row, prefix_pages):
        """Rebuild row ``row``'s block-table entries as ``prefix_pages``
        aliased over its leading logical pages and its own static-partition
        pages for the rest (radix prefix-KV sharing; in place).  Suffix
        appends land at positions >= ``len(prefix_pages) * page_size``, so
        the shared pages are only ever read.  Requires the static partition
        (:meth:`with_static_table`)."""
        S = self.pages_per_seq
        n = len(prefix_pages)
        if n > S:
            raise ValueError(f"prefix of {n} pages exceeds pages_per_seq={S}")
        entries = np.arange(int(row) * S, int(row) * S + S, dtype=np.int32)
        entries[:n] = np.asarray(list(prefix_pages), np.int32)
        self.table[int(row)] = entries
        self._upload_table()
        return self

    def restore_row_table(self, row):
        """Drop row ``row``'s prefix aliases, restoring its own static
        partition (retirement: the next occupant must not write through
        stale shared entries)."""
        return self.with_row_prefix(row, ())

    def row_view(self, row: int, length: int):
        """Batch-1 view of row ``row`` over the SAME pools, through its
        block-table row (a device view), at scalar valid ``length``:
        appends scatter straight into the row's pages, prefix-aliased
        leading entries included, so :meth:`merge_row` has nothing to
        copy.  The view's allocator is parked (every page of the row is
        assigned: the static partition), so it never walks the shared
        counters.  A recurrent child's view is its row's slice."""
        r = int(row)
        view = self._shallow()
        view.table = self.table[r:r + 1]
        view.block_table = self.block_table[r:r + 1]
        view._length = int(length)
        view.ragged_lengths = None
        view.positions = None
        view.assigned_pages = self.pages_per_seq
        view._rows_key = view._rows = None
        if self.ssm is not None:
            view.ssm = self.ssm.row_view(r)
        return view

    def merge_row(self, row: int, view):
        """Nothing to copy for the pools: the view wrote them in place.  A
        recurrent child has no shared pool: its row is written back
        (nothing to do after a :meth:`row_view`).  Table, counters and
        lengths are untouched."""
        if self.ssm is not None:
            self.ssm.merge_row(int(row), view.ssm)
        return self

    def _page_rows(self, pages) -> torch.Tensor:
        """Flat pool rows of whole physical ``pages``, on the pool's
        device."""
        rows = (np.asarray(list(pages), np.int64)[:, None] * self.page_size
                + np.arange(self.page_size)).reshape(-1)
        return torch.as_tensor(rows, device=self.device)

    def copy_pages(self, src_pages, dst_pages):
        """Copy whole physical pages ``src_pages[i] -> dst_pages[i]`` in
        every layer's pools (in place): prefix-cache registration copies a
        finished prompt's row-private pages into the reserved region, so
        slot recycling cannot clobber them."""
        if len(src_pages) != len(dst_pages):
            raise ValueError("copy_pages needs equal-length page lists")
        if not len(src_pages):
            return self
        src, dst = self._page_rows(src_pages), self._page_rows(dst_pages)
        for pools in self._pool_lists():
            for pool in pools:
                pool.index_copy_(1, dst, pool.index_select(1, src))
        return self

    def _export_pool_rows(self, row: int, n_pages: int) -> np.ndarray:
        """Flat pool rows of row ``row``'s first ``n_pages`` logical pages,
        resolved through its block table (host arithmetic)."""
        phys = self.table[int(row), :n_pages].astype(np.int64)
        return (phys[:, None] * self.page_size
                + np.arange(self.page_size)).reshape(-1)

    def export_row_pages(self, row, length, device: bool = False) -> dict:
        """Gather row ``row``'s first ``ceil(length / page_size)`` logical
        pages through its block table (the disaggregated-prefill export):
        prefix-aliased leading pages come out in position order like the
        row's own.  ``device=True`` (the d2d transport) keeps the planes on
        the pool's device; otherwise they come back as CPU tensors for the
        page-blob codec.  A recurrent ``ssm`` child's row rides the same
        blob under ``"ssm"`` (``SSMState.export_row``): for a pure-SSM row
        that is the whole payload."""
        P, S = self.page_size, self.pages_per_seq
        n = -(-int(length) // P)
        if n > S:
            raise ValueError(f"export of {n} pages exceeds pages_per_seq={S}")
        idx = torch.as_tensor(self._export_pool_rows(row, n),
                              device=self.device)
        blob = {"page_size": P, "pages": n, "length": int(length),
                "quantized": self.quantized}
        for key, pools in zip(self._plane_names(), self._pool_lists()):
            planes = [a.index_select(1, idx) for a in pools]
            blob[key] = planes if device else [t.cpu() for t in planes]
        if self.ssm is not None:
            blob["ssm"] = self.ssm.export_row(int(row), device=device)
        return blob

    def import_row_pages(self, row, blob: dict):
        """Scatter an :meth:`export_row_pages` blob (host or device planes,
        or a loaded page blob) into row ``row``'s own static-partition pages
        (in place).  The row's table is first restored to its own pages, so
        a stale prefix alias is never written through.  A blob's ``"ssm"``
        states go into the recurrent child's row.  A blob of another page
        size or quantization is a ValueError."""
        P, S = self.page_size, self.pages_per_seq
        self._check_blob(blob, P, self.quantized)
        n = int(blob["pages"])
        if n > S:
            raise ValueError(f"import of {n} pages exceeds pages_per_seq={S}")
        self.with_row_prefix(row, ())
        start = int(row) * S * P
        dst = torch.arange(start, start + n * P, device=self.device)
        for key, pools in zip(self._plane_names(), self._pool_lists()):
            for a, plane in zip(pools, blob[key]):
                if not isinstance(plane, torch.Tensor):   # a numpy plane
                    plane = torch.from_numpy(np.array(plane))
                a.index_copy_(1, dst, plane.to(self.device, a.dtype))
        if self.ssm is not None and blob.get("ssm") is not None:
            self.ssm.import_row(int(row), blob["ssm"])
        return self

    @staticmethod
    def _check_blob(blob: dict, page_size: int, quantized: bool):
        if int(blob["page_size"]) != page_size:
            raise ValueError(f"page blob page_size {blob['page_size']} != "
                             f"pool page_size {page_size}")
        if bool(blob["quantized"]) != quantized:
            raise ValueError("page blob quantization does not match pool")

    def export_pages(self, pages, length, device: bool = False) -> dict:
        """Gather an explicit physical page list into an
        :meth:`export_row_pages`-shaped blob (session hibernation's
        export: radix-cache pages belong to no row, so no block table
        resolves them).  ``pages`` are in position order, root to leaf;
        ``length`` is the token count they cover.  ``device=False``
        copies the planes to the host."""
        idx = self._page_rows(pages)
        blob = {"page_size": self.page_size, "pages": len(pages),
                "length": int(length), "quantized": self.quantized}
        for key, pools in zip(self._plane_names(), self._pool_lists()):
            planes = [a.index_select(1, idx) for a in pools]
            blob[key] = planes if device else [t.cpu() for t in planes]
        return blob

    def import_pages(self, pages, blob: dict, blob_offset: int = 0):
        """Scatter blob pages ``[blob_offset, blob_offset + len(pages))``
        into an explicit physical page list, in place (a wake's import
        into freshly inserted radix slots: no row table to restore).  A
        blob longer than that keeps its surplus hibernated."""
        P = self.page_size
        self._check_blob(blob, P, self.quantized)
        n, off = len(pages), int(blob_offset)
        if off + n > int(blob["pages"]):
            raise ValueError(f"import of pages [{off}, {off + n}) exceeds "
                             f"blob pages={blob['pages']}")
        dst = self._page_rows(pages)
        for key, pools in zip(self._plane_names(), self._pool_lists()):
            for a, plane in zip(pools, blob[key]):
                if not isinstance(plane, torch.Tensor):   # a numpy plane
                    plane = torch.from_numpy(np.array(plane))
                a.index_copy_(1, dst, plane[:, off * P:(off + n) * P]
                              .to(self.device, a.dtype))
        return self

    def _row_bytes(self) -> int:
        """Bytes per token row summed over every layer's K and V pool."""
        return sum(a.shape[0] * a.shape[2] * a.element_size()
                   for a in (*self.k, *self.v))

    def hbm_components(self) -> dict:
        """Device bytes by component for the capacity ledger
        (serve/memledger.py): the K/V page pools, their int8 scales and
        the device block table."""
        nbytes = lambda ts: sum(t.numel() * t.element_size()  # noqa: E731
                                for t in ts)
        return {"kv_values": nbytes((*self.k, *self.v)),
                "kv_scales": nbytes((*getattr(self, "k_scale", ()),
                                     *getattr(self, "v_scale", ()))),
                "kv_block_table": nbytes((self.block_table,)),
                "ssm_state": self._ssm_bytes()}

    def assigned_bytes(self) -> int:
        """Bytes of the pages handed out (what live sequences hold)."""
        live = min(self.next_free, self.num_pool_pages)
        return live * self.page_size * self._row_bytes()

    def logical_bytes(self) -> int:
        """Bytes a contiguous per-sequence cache of max_len would occupy."""
        return self.batch * self.max_len * self._row_bytes()


class QuantPagedKVState(PagedKVState):
    """Int8 paged pool: int8 page pools plus ``(Hkv, rows, 1)`` fp32
    per-token scale pools; the kernels dequantize per page on chip."""

    quantized = True

    def __init__(self, k, v, table, page_size, pages_per_seq, k_scale,
                 v_scale, out_dtype=torch.float32, device=None):
        super().__init__(k, v, table, page_size, pages_per_seq,
                         device=device)
        self.k_scale = list(k_scale)
        self.v_scale = list(v_scale)
        self.out_dtype = out_dtype

    @classmethod
    def create(cls, specs, batch: int, max_len: int, dtype=torch.float32,
               page_size: int | None = None, pool_pages: int | None = None,
               device=None):
        k, v, table, page, pages = cls._create_pools(
            specs, batch, max_len, torch.int8, page_size, pool_pages, device)
        rows = k[0].shape[1] if k else 0
        ks = [torch.zeros((h, rows, 1), dtype=torch.float32, device=device)
              for h, _ in specs]
        vs = [torch.zeros((h, rows, 1), dtype=torch.float32, device=device)
              for h, _ in specs]
        return cls(k, v, table, page, pages, ks, vs, out_dtype=dtype,
                   device=device)

    def append_rows(self, layer_idx: int, k_new, v_new):
        """Quantize, then scatter values and scales (same rows)."""
        qk, sk = _quantize_int8(k_new)
        qv, sv = _quantize_int8(v_new)
        rows, new_length = self._allocate_rows(k_new.shape[2])
        for pools, new in ((self.k, qk), (self.v, qv), (self.k_scale, sk),
                           (self.v_scale, sv)):
            self._scatter(pools, layer_idx, rows, self._to_rows(new))
        return self.k[layer_idx], self.v[layer_idx], new_length

    def append_packed(self, layer_idx: int, k_new, v_new, index):
        """Quantize, then scatter a packed batch's values and scales."""
        slots, rows = self._device_index(index)
        qk, sk = _quantize_int8(k_new[0][:, slots])
        qv, sv = _quantize_int8(v_new[0][:, slots])
        for pools, new in ((self.k, qk), (self.v, qv), (self.k_scale, sk),
                           (self.v_scale, sv)):
            self._scatter(pools, layer_idx, rows, new)
        return self.k[layer_idx], self.v[layer_idx]

    def _plane_names(self):
        return ("k", "v", "k_scale", "v_scale")

    def _row_bytes(self) -> int:
        """int8 value rows + fp32 scale rows per token, over every layer."""
        return super()._row_bytes() + sum(
            a.shape[0] * a.shape[2] * a.element_size()
            for a in (*self.k_scale, *self.v_scale))

    def memory_bytes(self) -> int:
        return sum(a.numel() * a.element_size()
                   for a in (*self.k, *self.v, *self.k_scale,
                             *self.v_scale)) + self._ssm_bytes()

    def logical_bytes(self) -> int:
        itemsize = torch.empty((), dtype=self.out_dtype).element_size()
        per_row = sum(a.shape[0] * a.shape[2] * itemsize
                      for a in (*self.k, *self.v))
        return self.batch * self.max_len * per_row


def stage_kv_view(kv: PagedKVState, lo: int, hi: int) -> PagedKVState:
    """A pipeline stage's slice of a paged cache: the pool lists cut to
    attention layers ``[lo, hi)`` (the same tensors, no copy), everything
    else shared with ``kv`` (block table, counters, ragged lengths, page
    geometry).  The serving pipeline's stages write disjoint layers
    through the same host-authored descriptors, so each runs against its
    view and :func:`merge_stage_kv` folds it back."""
    view = kv._shallow()
    for name in kv._plane_names():
        setattr(view, name, getattr(kv, name)[lo:hi])
    return view


def merge_stage_kv(kv: PagedKVState, lo: int, hi: int,
                   stage_kv: PagedKVState) -> PagedKVState:
    """Fold a stage's view back into the full cache (in place): its pools
    replace layers ``[lo, hi)`` and its lengths become the cache's (every
    stage advances them alike)."""
    for name in kv._plane_names():
        getattr(kv, name)[lo:hi] = getattr(stage_kv, name)
    kv._length = stage_kv._length
    kv.ragged_lengths = stage_kv.ragged_lengths
    return kv


def stage_pool_bytes(kv: PagedKVState, lo: int, hi: int) -> int:
    """Device bytes of the pool slices of attention layers ``[lo, hi)``
    (values and int8 scales; the block table is the whole cache's)."""
    return sum(a.numel() * a.element_size()
               for name in kv._plane_names()
               for a in getattr(kv, name)[lo:hi])


def create_kv_state(specs, batch: int, max_len: int, dtype=torch.float32,
                    quantized: bool | None = None, paged: bool | None = None,
                    device=None, ssm_specs=None,
                    extra_pool_pages: int = 0) -> KVState:
    """Factory honouring ``TURBO_QUANT_KV_CACHE=1`` and ``PAGED_KV_CACHE=1``
    (both together: the int8 paged pool, pages of
    ``PENROZ_KV_PAGE_SIZE`` tokens, default 128).  ``ssm_specs``, the
    per-``ssm``-layer ``(num_heads, head_dim, value_dim)`` of a hybrid
    model (models/model.py::CompiledArch.ssm_specs), attaches the
    recurrent ``ssm`` child.  ``extra_pool_pages`` grows a paged pool past
    the per-row partition (``batch * pages_per_seq`` pages): the reserved
    region of the radix prefix cache."""
    if quantized is None:
        quantized = turbo_quant_enabled()
    if paged is None:
        paged = paged_enabled()
    if paged:
        page = default_page_size()
        log.info("%s KV cache enabled (%s=1, page_size=%d)",
                 "Int8 paged" if quantized else "Paged", PAGED_ENV, page)
        cls = QuantPagedKVState if quantized else PagedKVState
        pool_pages = None
        if extra_pool_pages:
            pool_pages = batch * -(-max_len // page) + int(extra_pool_pages)
        state = cls.create(specs, batch, max_len, dtype, page_size=page,
                           pool_pages=pool_pages, device=device)
    elif quantized:
        log.info("TurboQuant KV cache enabled (%s=1)", TURBO_QUANT_ENV)
        state = QuantKVState.create(specs, batch, max_len, dtype, device)
    else:
        state = KVState.create(specs, batch, max_len, dtype, device)
    if ssm_specs:
        state.ssm = SSMState.create(ssm_specs, batch, device=device)
    return state


# ---------------------------------------------------------------------------
# Radix prefix-KV cache (host-side bookkeeping over the paged pool)
# ---------------------------------------------------------------------------

class _RadixNode:
    __slots__ = ("key", "page", "children", "parent", "refs", "last_use")

    def __init__(self, key, page, parent, last_use):
        self.key = key          # page_size-token tuple (edge label)
        self.page = page        # physical pool page holding this block's KV
        self.children = {}
        self.parent = parent
        self.refs = 0           # live rows aliasing this page
        self.last_use = last_use


class RadixPrefixCache:
    """Radix tree over page-granularity prompt blocks -> pages of a
    reserved region of the paged KV pool (JAX ``RadixPrefixCache``).

    Pure host bookkeeping: aliasing matched pages into a row's block table
    and copying a finished prompt's pages into the region are the caller's
    (:meth:`PagedKVState.with_row_prefix`, :meth:`PagedKVState.copy_pages`).
    This class decides WHICH pages, with:

    - whole-page sharing only (suffix appends into a partly filled page
      would corrupt its other readers);
    - refcounted pinning: a page aliased into a live row's table is never
      evicted (its page would be recycled under a reader);
    - LRU eviction of unpinned LEAVES only (an interior page is a prefix
      of its children's chains).

    Greedy outputs with a hit equal a miss's: the aliased pages hold the
    K/V the suffix prefill would recompute, at the same absolute
    positions.  ``namespace`` keys a separate root per set of weights
    (``None``, the base model, is the only one the port uses)."""

    def __init__(self, pages, page_size: int):
        self.page_size = int(page_size)
        self._pages = list(pages)
        self._free = list(reversed(self._pages))
        self._roots: dict = {None: _RadixNode(None, -1, None, 0)}
        self._clock = 0
        self.hits = 0
        self.misses = 0
        self.hit_tokens = 0
        self.inserted_pages = 0
        self.evicted_pages = 0
        self.unpin_underflows = 0

    # -- introspection ------------------------------------------------------

    @property
    def capacity_pages(self) -> int:
        return len(self._pages)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def cached_pages(self) -> int:
        return len(self._pages) - len(self._free)

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "capacity_pages": self.capacity_pages,
            "cached_pages": self.cached_pages,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": (self.hits / total) if total else None,
            "hit_tokens": self.hit_tokens,
            "inserted_pages": self.inserted_pages,
            "evicted_pages": self.evicted_pages,
        }

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks(self, tokens, limit=None):
        P = self.page_size
        n = len(tokens) if limit is None else min(int(limit), len(tokens))
        for b in range(n // P):
            yield tuple(int(t) for t in tokens[b * P:(b + 1) * P])

    # -- lookup / registration ----------------------------------------------

    def _ns_root(self, namespace):
        root = self._roots.get(namespace)
        if root is None:
            root = self._roots[namespace] = _RadixNode(None, -1, None, 0)
        return root

    def chain(self, tokens, limit=None, namespace=None) -> list:
        """The cached node chain of ``tokens``' longest whole-page prefix,
        without hit/miss accounting; touches LRU recency like
        :meth:`match`."""
        nodes = []
        node = self._ns_root(namespace)
        for key in self._blocks(tokens, limit):
            child = node.children.get(key)
            if child is None:
                break
            nodes.append(child)
            node = child
        t = self._tick()
        for nd in nodes:
            nd.last_use = t
        return nodes

    def match(self, tokens, limit=None, namespace=None) -> list:
        """Longest cached whole-page prefix of ``tokens``: the matched node
        chain (``[n.page for n in nodes]`` are the pages to alias, in
        logical order).  ``limit`` caps the usable token count (admission
        passes ``len(prompt) - 1``, so one real token is left to produce
        the first sample).  A hit iff at least one page matched."""
        nodes = self.chain(tokens, limit, namespace)
        if nodes:
            self.hits += 1
            self.hit_tokens += len(nodes) * self.page_size
        else:
            self.misses += 1
        return nodes

    def pin(self, nodes):
        """Hold ``nodes``' pages against eviction while a live row aliases
        them (admission; :meth:`unpin` at retirement)."""
        for nd in nodes:
            nd.refs += 1

    def unpin(self, nodes):
        for nd in nodes:
            nd.refs -= 1
            if nd.refs < 0:  # an unpaired unpin must not become a pin
                nd.refs = 0
                self.unpin_underflows += 1
                record_unpin_underflow(nd.key)

    def iter_nodes(self):
        """Every cached node of every namespace (roots excluded), depth
        first; do not mutate while iterating."""
        stack = [nd for root in self._roots.values()
                 for nd in root.children.values()]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            yield nd

    def page_audit(self) -> list[str]:
        """Violations of the page bookkeeping (empty: sound): cached and
        free must partition the reserved region, no page on both sides,
        on neither (leaked), outside it (foreign) or under two nodes, no
        negative refcount."""
        problems: list[str] = []
        region = set(self._pages)
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            problems.append("duplicate pages on the free list")
        cached: dict = {}
        for nd in self.iter_nodes():
            if nd.page in cached:
                problems.append(f"page {nd.page} owned by two nodes")
            cached[nd.page] = nd
            if nd.page not in region:
                problems.append(f"cached page {nd.page} outside the "
                                f"reserved region")
            if nd.refs < 0:
                problems.append(f"page {nd.page}: negative refs {nd.refs}")
        overlap = free_set & set(cached)
        if overlap:
            problems.append(f"pages both free and cached: {sorted(overlap)}")
        leaked = region - free_set - set(cached)
        if leaked:
            problems.append(f"pages neither free nor cached (leaked): "
                            f"{sorted(leaked)}")
        foreign = free_set - region
        if foreign:
            problems.append(f"free-list pages outside the reserved region: "
                            f"{sorted(foreign)}")
        return problems

    def insert(self, tokens, limit=None,
               namespace=None) -> list[tuple[int, int]]:
        """Ensure a node for every full page block of ``tokens``; returns
        the ``(block_index, page)`` pairs NEWLY allocated, whose K/V the
        caller must ``copy_pages`` in.  Allocation evicts unpinned LRU
        leaves on demand and stops early (no error) when all that is left
        is pinned; a partial chain is a valid prefix.  The chain being
        built is pinned meanwhile, so it never evicts its own nodes."""
        created = []
        chain = []
        node = self._ns_root(namespace)
        t = self._tick()
        try:
            for b, key in enumerate(self._blocks(tokens, limit)):
                child = node.children.get(key)
                if child is None:
                    page = self._alloc()
                    if page is None:
                        break
                    child = _RadixNode(key, page, node, t)
                    node.children[key] = child
                    created.append((b, page))
                    self.inserted_pages += 1
                child.last_use = t
                child.refs += 1
                chain.append(child)
                node = child
        finally:
            for nd in chain:
                nd.refs -= 1
        return created

    def _alloc(self):
        if self._free:
            return self._free.pop()
        victim = self._lru_leaf()
        if victim is None:
            return None
        self._evict(victim)
        return self._free.pop()

    def _lru_leaf(self):
        best = None
        stack = [nd for root in self._roots.values()
                 for nd in root.children.values()]
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            elif nd.refs == 0 and (best is None
                                   or nd.last_use < best.last_use):
                best = nd
        return best

    def _evict(self, node):
        del node.parent.children[node.key]
        self._free.append(node.page)
        self.evicted_pages += 1

    def clear(self):
        """Drop every cached prefix and reclaim all pages (a model reload:
        K/V of the old weights must never serve the new ones).  Called with
        no row in flight, so nothing is pinned; the counters survive."""
        self._roots = {None: _RadixNode(None, -1, None, 0)}
        self._free = list(reversed(self._pages))
