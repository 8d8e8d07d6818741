"""Power-of-two bucketing helpers of the serving stack (copy of
penroz_tpu/utils/bucketing.py; the port keeps its own).

The scheduler's chunked prefill (a pow-2 tail after full chunks), the
unified block's step count (pow-2 floor) and the ragged descriptor count
(pow-2 ceiling) use the same arithmetic as the JAX package, so a request
is cut into the same chunks, steps and descriptor blocks by both
(tests/test_torch_paged_kv.py holds them equal).
"""

from __future__ import annotations


def pow2_floor(n: int) -> int:
    """Largest power of two ≤ ``n`` (``n`` ≥ 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"pow2_floor needs n >= 1, got {n}")
    return 1 << (n.bit_length() - 1)


def pow2_ceil(n: int) -> int:
    """Smallest power of two ≥ ``n`` (``n`` ≥ 1)."""
    n = int(n)
    if n < 1:
        raise ValueError(f"pow2_ceil needs n >= 1, got {n}")
    return 1 << (n - 1).bit_length()


def pow2_tail(rem: int) -> list[int]:
    """``rem`` ≥ 0 decomposed into strictly descending powers of two.

    The binary expansion, most-significant bit first — the unique
    descending-powers decomposition, so the emitted bucket set for any
    remainder below ``chunk`` is at most ``log2(chunk)`` distinct shapes.
    """
    rem = int(rem)
    if rem < 0:
        raise ValueError(f"pow2_tail needs rem >= 0, got {rem}")
    return [1 << b for b in range(rem.bit_length() - 1, -1, -1)
            if rem & (1 << b)]


def chunk_plan(n: int, chunk: int) -> list[int]:
    """Split ``n`` prompt tokens into full ``chunk``-sized pieces plus a
    pow-2-bucketed tail (the chunked-prefill compile-churn guard: every
    piece is either ``chunk`` or a power of two below it, so the program
    set stays O(log chunk) regardless of prompt length)."""
    n, chunk = int(n), int(chunk)
    if chunk < 1:
        raise ValueError(f"chunk_plan needs chunk >= 1, got {chunk}")
    if n < 0:
        raise ValueError(f"chunk_plan needs n >= 0, got {n}")
    return [chunk] * (n // chunk) + pow2_tail(n % chunk)


def clamp_pow2_floor(n: int, lo: int = 1, hi: int | None = None) -> int:
    """Clamp ``n`` into ``[lo, hi]`` then round down to a power of two —
    the superstep planner's step-count bucketing (``1 ≤ result ≤ n`` for
    ``n ≥ lo``, so a fused plan never overshoots the remaining need)."""
    n = int(n)
    if hi is not None:
        n = min(n, int(hi))
    n = max(n, int(lo))
    return pow2_floor(n)


def bucket_count(n: int, minimum: int = 1) -> int:
    """Round ``n`` up to a power of two, at least ``minimum`` (itself
    rounded up) — the ragged descriptor-array shape bucket.  Guarantees
    ``result ≥ max(n, 1)`` and that a workload of any size compiles at
    most ``log2`` distinct descriptor shapes."""
    return pow2_ceil(max(int(n), pow2_ceil(max(int(minimum), 1))))
