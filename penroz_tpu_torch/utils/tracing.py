"""Per-request lifecycle traces (counterpart of penroz_tpu/utils/tracing.py):
where did *this* request's time go?

``/serving_stats/`` answers "how is the fleet doing" with aggregates; it
cannot answer "why did request X take 900 ms".  This module gives every
served generation a ``request_id`` (returned in the ``X-Request-Id``
response header and error bodies, bound into log records via a
contextvar) and a **span tree** recording its full lifecycle as the
scheduler drives it:

    request
    ├─ queue            (enqueue → admission)
    ├─ prefill          (admission → first token)
    │  ├─ prefix_match  [event: cached tokens aliased]
    │  ├─ prefill_chunk (one per chunk, size + start position)
    │  └─ ...
    ├─ decode           (first token → retirement)
    │  ├─ decode_step   (per shared tick this row emitted in; capped)
    │  ├─ verify        (spec-decode multi-token step: drafted/accepted)
    │  └─ ...
    ├─ recovery         [events: engine_crash / engine_reset]
    └─ [meta: retire_reason = stop_token | max_new_tokens | timeout |
        cancelled | error | pool_capacity | completed]

Completed traces land in a bounded ring (``PENROZ_TRACE_BUFFER``
entries, default 256) served by ``GET /trace/`` (summaries) and
``GET /trace/{request_id}`` (the span tree; in-flight requests resolve
too).  ``PENROZ_TRACE_SAMPLE`` (0.0–1.0, default 1.0) samples traces at
admission — at 0 the scheduler's per-request overhead is a single
``is None`` check per event site.

Tracing is host-side bookkeeping only: it never touches device buffers,
so greedy outputs are token-identical with tracing on, sampled, or off
(tests/test_torch_tracing.py holds both).
"""

from __future__ import annotations

import collections
import contextvars
import logging
import os
import random
import threading
import time
import uuid

TRACE_BUFFER_ENV = "PENROZ_TRACE_BUFFER"
TRACE_SAMPLE_ENV = "PENROZ_TRACE_SAMPLE"

# Hard per-trace span cap: a 100k-token generation must not grow an
# unbounded span list — past the cap, spans are counted, not stored.
MAX_SPANS = 1024

_request_id_var: contextvars.ContextVar = contextvars.ContextVar(
    "penroz_request_id", default=None)

_lock = threading.Lock()
_completed: collections.deque = collections.deque(maxlen=256)
_completed_maxlen = 256
_live: dict = {}


def _buffer_size() -> int:
    try:
        return max(1, int(os.environ.get(TRACE_BUFFER_ENV, "256")))
    except ValueError:
        return 256


def _sample_rate() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get(TRACE_SAMPLE_ENV, "1.0"))))
    except ValueError:
        return 1.0


# -- request-id plumbing ----------------------------------------------------

def new_request_id(supplied: str | None = None) -> str:
    """A fresh request id — or the client's own ``X-Request-Id`` when it
    sent a sane one (correlating proxy/server logs beats uniqueness)."""
    if supplied:
        supplied = supplied.strip()
        if 0 < len(supplied) <= 64 and all(
                c.isalnum() or c in "-_." for c in supplied):
            return supplied
    return uuid.uuid4().hex


def bind(request_id: str | None):
    """Bind ``request_id`` into the logging contextvar; returns the token
    for :func:`unbind`."""
    return _request_id_var.set(request_id)


def unbind(token) -> None:
    _request_id_var.reset(token)


def current_request_id() -> str | None:
    return _request_id_var.get()


class RequestIdFilter(logging.Filter):
    """Stamps ``record.request_id`` from the contextvar (``-`` outside any
    request) so formats can carry ``%(request_id)s`` — referenced by
    log_config.json."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.request_id = _request_id_var.get() or "-"
        return True


# -- spans ------------------------------------------------------------------

class Span:
    __slots__ = ("name", "t0", "t1", "meta", "children")

    def __init__(self, name: str, t0: float, meta: dict | None = None):
        self.name = name
        self.t0 = t0
        self.t1: float | None = None
        self.meta = meta or {}
        self.children: list[Span] = []

    def to_dict(self, base: float) -> dict:
        out = {
            "name": self.name,
            "t0_ms": round((self.t0 - base) * 1000.0, 3),
            "t1_ms": (round((self.t1 - base) * 1000.0, 3)
                      if self.t1 is not None else None),
            "duration_ms": (round((self.t1 - self.t0) * 1000.0, 3)
                            if self.t1 is not None else None),
        }
        if self.meta:
            out["meta"] = dict(self.meta)
        if self.children:
            out["children"] = [c.to_dict(base) for c in self.children]
        return out


class Trace:
    """One request's span tree.  All mutation goes through methods that
    take the trace lock — spans arrive from the scheduler worker thread
    while the HTTP layer may be serializing the in-flight tree."""

    def __init__(self, request_id: str, **meta):
        self.request_id = request_id
        self.started_unix = time.time()
        self.t0 = time.monotonic()
        self.meta = dict(meta)
        self.root = Span("request", self.t0)
        self._lock = threading.Lock()
        self._finished = False
        self._span_count = 1
        self.dropped_spans = 0
        # Set by the scheduler once the request is accepted into its
        # queue: from then on the ENGINE guarantees the finish (retire /
        # shed / crash recovery), and the HTTP layer must not finish the
        # trace early — a crash's recovery span is recorded after the
        # error event has already been delivered to the client.
        self.owned = False

    # -- recording (scheduler-side) ----------------------------------------

    def span(self, name: str, t0: float | None = None,
             parent: Span | None = None, **meta) -> Span | None:
        """Open a child span under ``parent`` (the root by default).
        Returns None past the per-trace cap (counted in dropped_spans)."""
        with self._lock:
            if self._finished:
                return None
            if self._span_count >= MAX_SPANS:
                self.dropped_spans += 1
                return None
            sp = Span(name, t0 if t0 is not None else time.monotonic(), meta)
            (parent or self.root).children.append(sp)
            self._span_count += 1
            return sp

    def end(self, sp: Span | None, t1: float | None = None, **meta) -> None:
        if sp is None:
            return
        with self._lock:
            sp.t1 = t1 if t1 is not None else time.monotonic()
            if meta:
                sp.meta.update(meta)

    def event(self, name: str, parent: Span | None = None, **meta) -> None:
        """Point-in-time marker: a zero-length span."""
        now = time.monotonic()
        sp = self.span(name, t0=now, parent=parent, **meta)
        self.end(sp, t1=now)

    def annotate(self, **meta) -> None:
        with self._lock:
            self.meta.update(meta)

    def finish(self, reason: str | None = None) -> None:
        """Close the root span and move the trace to the completed ring.
        Idempotent — the first finish wins (the scheduler retires the
        request; a belt-and-braces handler finish is then a no-op)."""
        with self._lock:
            if self._finished:
                return
            self._finished = True
            self.root.t1 = time.monotonic()
            if reason is not None:
                self.meta.setdefault("retire_reason", reason)
        _complete(self)

    @property
    def finished(self) -> bool:
        return self._finished

    # -- serialization (HTTP-side) -----------------------------------------

    def summary(self) -> dict:
        with self._lock:
            dur = (self.root.t1 if self.root.t1 is not None
                   else time.monotonic()) - self.t0
            return {
                "request_id": self.request_id,
                "started_unix": round(self.started_unix, 3),
                "duration_ms": round(dur * 1000.0, 3),
                "finished": self._finished,
                "spans": self._span_count,
                **{k: v for k, v in self.meta.items()},
            }

    def to_dict(self) -> dict:
        with self._lock:
            return {
                "request_id": self.request_id,
                "started_unix": round(self.started_unix, 3),
                "finished": self._finished,
                "meta": dict(self.meta),
                "dropped_spans": self.dropped_spans,
                "root": self.root.to_dict(self.t0),
            }

    def to_chrome(self) -> dict:
        """The span tree as Chrome trace-event JSON (the ``traceEvents``
        array format) — ``GET /trace/{id}?format=chrome`` loads directly
        into Perfetto / chrome://tracing.  Complete events (``ph: "X"``)
        with microsecond ``ts`` relative to the trace start (monotonic,
        so events never go backwards); ``pid`` is the request id and
        ``tid`` the span depth, which renders the tree as nested tracks.
        In-flight spans clamp to "now" — a live snapshot is still a
        valid, loadable file."""
        with self._lock:
            now = time.monotonic()
            events = []
            stack = [(self.root, 0)]
            while stack:
                sp, depth = stack.pop()
                t1 = sp.t1 if sp.t1 is not None else now
                ev = {
                    "name": sp.name,
                    "ph": "X",
                    "ts": round((sp.t0 - self.t0) * 1e6, 1),
                    "dur": round(max(0.0, t1 - sp.t0) * 1e6, 1),
                    "pid": self.request_id,
                    "tid": depth,
                }
                args = dict(sp.meta)
                if sp is self.root:
                    args.update(self.meta)
                    args["started_unix"] = round(self.started_unix, 3)
                if args:
                    ev["args"] = args
                events.append(ev)
                stack.extend((c, depth + 1) for c in sp.children)
            events.sort(key=lambda e: e["ts"])
            return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- registry ---------------------------------------------------------------

def maybe_trace(request_id: str, **meta) -> Trace | None:
    """Start a trace for ``request_id`` under the sampling rate (None when
    sampled out — every recording site is None-guarded, so the disabled
    path costs one comparison)."""
    rate = _sample_rate()
    if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
        return None
    trace = Trace(request_id, **meta)
    with _lock:
        _live[request_id] = trace
    return trace


def _complete(trace: Trace) -> None:
    global _completed, _completed_maxlen
    with _lock:
        _live.pop(trace.request_id, None)
        size = _buffer_size()
        if size != _completed_maxlen:
            _completed = collections.deque(_completed, maxlen=size)
            _completed_maxlen = size
        _completed.append(trace)
    try:  # scrape counter; utils must not hard-require the serve layer
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.TRACES_COMPLETED.inc()
    except Exception:  # noqa: BLE001 — pragma: no cover
        pass


def get(request_id: str) -> Trace | None:
    """Look up a trace by id — in-flight first, then the completed ring."""
    with _lock:
        trace = _live.get(request_id)
        if trace is not None:
            return trace
        for t in reversed(_completed):
            if t.request_id == request_id:
                return t
    return None


def completed(limit: int = 100) -> list[Trace]:
    """Most-recent-first completed traces (ring order)."""
    with _lock:
        out = list(_completed)
    out.reverse()
    return out[:max(0, limit)]


def live() -> list[Trace]:
    with _lock:
        return list(_live.values())


def reset() -> None:
    """Drop all trace state (tests)."""
    global _completed, _completed_maxlen
    with _lock:
        _completed = collections.deque(maxlen=_buffer_size())
        _completed_maxlen = _completed.maxlen
        _live.clear()
