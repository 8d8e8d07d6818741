"""Resumable token streams: seq-numbered replay rings over /generate/
(counterpart of penroz_tpu/serve/streams.py).

A dropped connection used to cancel the generation, and every token
decoded so far went with it.  Here the stream is a resumable view over the
request:

- Every event the scheduler emits gets a monotone sequence number, and
  the last ``PENROZ_STREAM_REPLAY`` events (default 256) stay in a bounded
  replay ring of the request.
- A client disconnect **detaches** the stream for
  ``PENROZ_STREAM_DETACH_MS`` instead of cancelling it (decoding goes on);
  the default 0 keeps the cancel on disconnect.
- ``GET /generate/{request_id}/stream?from_seq=N`` reattaches: the events
  ``>= N`` replay from the ring under the lock that orders live
  publishing, so the seam is exactly-once (no sequence number missing or
  repeated), across a router failover too: the registry is process-wide.
- When the grace passes with no reconnect, the ordinary cancellation
  fires (``req.cancelled``; the engine retires the row at its next
  emission, its pages through the audited seam).

The JAX package hands events to an asyncio loop; the port's HTTP layer is
``ThreadingHTTPServer``, so a consumer here is a thread-safe
``queue.Queue`` of ``(seq, kind, value)`` events, read by a handler thread.

The ring holds tokens, not KV.  A reconnect asking for events older than
the ring is a typed error (:class:`ReplayGapError`, HTTP 410): resuming
would skip tokens, so the client restarts the request.

Fault site (utils/faults.py): ``stream.resume`` at the top of every
reattach; a failure is the HTTP error, the generation runs on and stays
resumable.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

from penroz_tpu_torch.utils import faults

log = logging.getLogger(__name__)

REPLAY_ENV = "PENROZ_STREAM_REPLAY"          # ring capacity (events)
DETACH_MS_ENV = "PENROZ_STREAM_DETACH_MS"    # disconnect grace; 0 = cancel
_LINGER_S = 60.0        # terminal sessions stay reattachable this long
_TERMINAL = ("done", "error", "timeout")


def replay_capacity() -> int:
    try:
        return max(1, int(os.environ.get(REPLAY_ENV, "256")))
    except ValueError:
        return 256


def detach_grace_ms() -> float:
    try:
        return max(0.0, float(os.environ.get(DETACH_MS_ENV, "0")))
    except ValueError:
        return 0.0


class ReplayGapError(ValueError):
    """``from_seq`` asked for events the bounded ring no longer holds —
    resuming would silently skip tokens, so the client must restart."""


class StreamSession:
    """One request's event ring and its (at most one) attached consumer
    queue.

    ``publish`` runs on the engine's worker thread, attach and detach on
    handler threads.  One lock orders them, which makes the replay-then-
    live seam exactly-once: a publish lands either in the ring snapshot a
    reattach replays or in the queue it subscribes, never both, never
    neither."""

    def __init__(self, request_id: str, req):
        self.request_id = request_id
        self.req = req
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=replay_capacity())
        self._next_seq = 0
        self._consumer = None           # queue.Queue | None
        self._timer: threading.Timer | None = None
        self.detached_at: float | None = None
        self.terminal = False
        self.done_at: float | None = None
        self.expired = False
        self.resumes = 0

    # -- producer side (engine worker thread) -------------------------------

    def publish(self, kind: str, value) -> None:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._ring.append((seq, kind, value))
            if kind in _TERMINAL:
                self.terminal = True
                self.done_at = time.monotonic()
                self._cancel_timer_locked()
            if self._consumer is not None:
                # under the lock: a reattach's backlog and its live events
                # cannot interleave out of order
                self._consumer.put((seq, kind, value))

    # -- consumer side (handler threads) --------------------------------------

    def attach_initial(self, queue) -> None:
        """Bind the original /generate/ handler's queue (seq 0 onward;
        nothing published yet, so no replay needed)."""
        with self._lock:
            self._consumer = queue

    def resume(self, queue, from_seq: int) -> list:
        """Reattach at ``from_seq``: returns the ring backlog to deliver
        first, with the queue subscribed for everything after it —
        atomically, so no event is duplicated or lost across the seam.

        :raises ReplayGapError: the ring has already evicted events
            ``>= from_seq`` (client fell further behind than
            ``PENROZ_STREAM_REPLAY``)."""
        faults.check("stream.resume")
        with self._lock:
            if self.expired:
                raise ReplayGapError(
                    f"stream {self.request_id!r} already expired its "
                    f"detach grace and was cancelled")
            oldest_needed = from_seq
            if self._ring and oldest_needed < self._ring[0][0]:
                raise ReplayGapError(
                    f"from_seq={from_seq} is older than the replay ring "
                    f"(oldest retained seq {self._ring[0][0]}; raise "
                    f"{REPLAY_ENV} or restart the request)")
            if not self._ring and from_seq < self._next_seq:
                raise ReplayGapError(
                    f"from_seq={from_seq} predates the replay ring")
            backlog = [e for e in self._ring if e[0] >= from_seq]
            self._consumer = queue
            self.detached_at = None
            self._cancel_timer_locked()
            self.resumes += 1
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.STREAM_RESUMES.inc()
        STREAMS.note("resumes")
        return backlog

    def try_detach(self) -> bool:
        """Client vanished: keep decoding for the grace window instead of
        cancelling.  Returns False (caller runs the ordinary cancel
        path) when the grace knob is 0 or the stream already ended."""
        grace_ms = detach_grace_ms()
        with self._lock:
            if grace_ms <= 0 or self.terminal or self.expired:
                return False
            self._consumer = None
            self.detached_at = time.monotonic()
            self._cancel_timer_locked()
            self._timer = threading.Timer(grace_ms / 1000.0, self._expire)
            self._timer.daemon = True
            self._timer.start()
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.STREAM_DETACHES.inc()
        STREAMS.note("detaches")
        return True

    def release(self) -> None:
        """Consumer finished reading (terminal event delivered) — drop
        the subscription; the ring lingers for late reconnects."""
        with self._lock:
            self._consumer = None

    def _expire(self):
        with self._lock:
            if self.terminal or self.detached_at is None:
                return
            self.expired = True
            self.detached_at = None
        # The pre-existing cancellation path, deferred by the grace
        # window: the engine observes it at the next emission and
        # retires the row through the audited seam.
        self.req.cancelled = True
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.STREAM_EXPIRED.inc()
        STREAMS.note("expired")
        log.info("stream %s: detach grace expired; generation cancelled",
                 self.request_id)

    def _cancel_timer_locked(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    def snapshot(self) -> dict:
        with self._lock:
            return {"request_id": self.request_id,
                    "next_seq": self._next_seq,
                    "ring": len(self._ring),
                    "attached": self._consumer is not None,
                    "detached": self.detached_at is not None,
                    "terminal": self.terminal,
                    "expired": self.expired,
                    "resumes": self.resumes}


class StreamRegistry:
    """Process-wide ``request_id`` → :class:`StreamSession` map.  Shared
    by every replica (engines are in-process), so a reconnect lands on
    the right ring no matter which replica the router steered the
    original request to — the failover case in the acceptance tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions: dict[str, StreamSession] = {}
        self.detaches = 0
        self.resumes = 0
        self.expired = 0

    def register(self, request_id: str, req) -> StreamSession:
        sess = StreamSession(request_id, req)
        with self._lock:
            self._purge_locked()
            self._sessions[request_id] = sess
        return sess

    def get(self, request_id: str) -> StreamSession | None:
        with self._lock:
            return self._sessions.get(request_id)

    def discard(self, request_id: str) -> None:
        with self._lock:
            sess = self._sessions.pop(request_id, None)
        if sess is not None:
            with sess._lock:
                sess._cancel_timer_locked()

    def _purge_locked(self):
        now = time.monotonic()
        for rid in [rid for rid, s in self._sessions.items()
                    if (s.terminal and s.done_at is not None
                        and now - s.done_at > _LINGER_S) or s.expired]:
            del self._sessions[rid]

    def detached_count(self) -> int:
        with self._lock:
            return sum(1 for s in self._sessions.values()
                       if s.detached_at is not None)

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
        detached = sum(1 for s in sessions if s.detached_at is not None)
        return {"active": len(sessions),
                "detached": detached,
                "detaches": self.detaches,
                "resumes": self.resumes,
                "expired": self.expired,
                "replay_capacity": replay_capacity(),
                "detach_grace_ms": detach_grace_ms()}

    def note(self, what: str):
        with self._lock:
            setattr(self, what, getattr(self, what) + 1)

    def reset(self):
        with self._lock:
            for s in self._sessions.values():
                with s._lock:
                    s._cancel_timer_locked()
            self._sessions.clear()
            self.detaches = 0
            self.resumes = 0
            self.expired = 0


STREAMS = StreamRegistry()


def reset() -> None:
    STREAMS.reset()
