"""Write-ahead journal of the serving state plane (counterpart of
penroz_tpu/serve/journal.py, the same frames byte for byte).

What the serving stack must remember across a process restart is small
host metadata: which sessions are hibernated where (serve/tierstore.py),
which tenant quota overrides were PUT, which LoRA adapters were
registered.  The mutating paths append a record here, and
:meth:`~penroz_tpu_torch.serve.tierstore.TierStore.recover` replays them
at start-up, so a ``kill -9`` leaves the disk tier's blobs reachable.

Wire format (one frame a record, no file header)::

    u32 payload_len (LE) | u32 crc32(payload) | payload (UTF-8 JSON)

A torn tail (the frame a crash cut mid-write) fails the length or CRC
check on replay; replay truncates the file at the first bad frame and
counts what it dropped: the loss is bounded to the newest record(s),
never a crash and never a wrong replay.

Knobs:

- ``PENROZ_JOURNAL_PATH``: the log file.  Unset, journaling is off and
  every hook a no-op.
- ``PENROZ_JOURNAL_FSYNC``: ``always`` fsyncs every append, ``batch``
  (default) every ``_BATCH_EVERY`` records or ``_BATCH_MS`` ms, ``off``
  only flushes to the page cache.
- ``PENROZ_JOURNAL_COMPACT_RATIO``: rewrite the log (temporary file +
  ``os.replace``) once dead records exceed this share of it (default
  0.5, never below ``_COMPACT_MIN`` records).

Fault sites (utils/faults.py): ``journal.append`` before each frame's
write, ``journal.replay`` before replay reads a frame.  An append failure
(injected, or a full disk) is contained: the record is dropped and
counted (``append_errors``), and serving goes on.
"""

from __future__ import annotations

import io
import json
import logging
import os
import struct
import threading
import time
import zlib

from penroz_tpu_torch.utils import faults

log = logging.getLogger(__name__)

PATH_ENV = "PENROZ_JOURNAL_PATH"
FSYNC_ENV = "PENROZ_JOURNAL_FSYNC"          # always | batch | off
COMPACT_RATIO_ENV = "PENROZ_JOURNAL_COMPACT_RATIO"

_FRAME = struct.Struct("<II")               # payload_len, crc32(payload)
_BATCH_EVERY = 64                           # batch policy: fsync every N appends
_BATCH_MS = 100.0                           # ... or this many ms, whichever first
_COMPACT_MIN = 64                           # never compact logs smaller than this


def journal_path() -> str | None:
    return os.environ.get(PATH_ENV) or None


def fsync_policy() -> str:
    pol = os.environ.get(FSYNC_ENV, "batch").strip().lower()
    return pol if pol in ("always", "batch", "off") else "batch"


def _compact_ratio() -> float:
    try:
        return min(1.0, max(0.0, float(
            os.environ.get(COMPACT_RATIO_ENV, 0.5))))
    except ValueError:
        return 0.5


def _encode(record: dict) -> bytes:
    payload = json.dumps(record, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class Journal:
    """The process-wide write-ahead log.  Thread-safe: engine workers
    (hibernation lifecycle) and API threads (quota/adapter PUTs)
    interleave; one lock serializes frame writes so frames never tear
    each other (a *crash* can still tear the last frame — that is what
    replay truncation is for)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._fh: io.BufferedWriter | None = None
        self._fh_path: str | None = None
        self._pending = 0               # appends since last fsync (batch)
        self._last_fsync = 0.0
        self.records_total = 0          # frames in the current file
        self.appended = 0               # lifetime appends (this process)
        self.append_errors = 0
        self.bad_records = 0            # frames dropped by replay truncation
        self.truncated_bytes = 0
        self.compactions = 0
        self.replay_ms = 0.0

    # -- append path ---------------------------------------------------------

    def enabled(self) -> bool:
        return journal_path() is not None

    def _open_locked(self) -> io.BufferedWriter | None:
        path = journal_path()
        if path is None:
            return None
        if self._fh is not None and self._fh_path == path:
            return self._fh
        self._close_locked()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(path, "ab")
        self._fh_path = path
        return self._fh

    def append(self, kind: str, **fields) -> bool:
        """Durably record one state change.  Returns False (and counts)
        instead of raising on any failure — journaling must never make
        serving worse, only restarts better."""
        if not self.enabled():
            return False
        record = dict(fields)
        record["t"] = kind
        record["ts"] = time.time()
        try:
            faults.check("journal.append")
            frame = _encode(record)
            with self._lock:
                fh = self._open_locked()
                if fh is None:
                    return False
                fh.write(frame)
                fh.flush()
                self._fsync_locked(fh)
                self.records_total += 1
                self.appended += 1
        except Exception:  # noqa: BLE001 — contained by design (see docstring)
            with self._lock:
                self.append_errors += 1
            log.warning("journal append failed for %r record (dropped)",
                        kind, exc_info=True)
            from penroz_tpu_torch.serve import metrics as serve_metrics
            serve_metrics.JOURNAL_ERRORS.inc()
            return False
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.JOURNAL_APPENDS.inc()
        return True

    def _fsync_locked(self, fh):
        pol = fsync_policy()
        if pol == "off":
            return
        now = time.monotonic()
        if pol == "always":
            os.fsync(fh.fileno())
            self._last_fsync = now
            self._pending = 0
            return
        self._pending += 1
        if (self._pending >= _BATCH_EVERY
                or (now - self._last_fsync) * 1000.0 >= _BATCH_MS):
            os.fsync(fh.fileno())
            self._last_fsync = now
            self._pending = 0

    def _close_locked(self):
        if self._fh is not None:
            try:
                self._fh.flush()
                if fsync_policy() != "off":
                    os.fsync(self._fh.fileno())
            except OSError:
                pass
            try:
                self._fh.close()
            except OSError:
                pass
        self._fh = None
        self._fh_path = None

    def close(self):
        with self._lock:
            self._close_locked()

    # -- replay path ---------------------------------------------------------

    def replay(self) -> list[dict]:
        """Read every intact record, truncating the file at the first
        bad frame (torn tail / flipped bits).  Raises only for injected
        ``journal.replay`` faults or a filesystem that cannot be read at
        all — the caller treats that as "no journal" and recovers to an
        empty registry."""
        path = journal_path()
        if path is None or not os.path.exists(path):
            return []
        faults.check("journal.replay")
        t0 = time.monotonic()
        records: list[dict] = []
        good_end = 0
        bad = 0
        with self._lock:
            self._close_locked()           # replay owns the file exclusively
            size = os.path.getsize(path)
            with open(path, "rb") as fh:
                while True:
                    head = fh.read(_FRAME.size)
                    if not head:
                        break
                    if len(head) < _FRAME.size:
                        bad += 1
                        break
                    length, crc = _FRAME.unpack(head)
                    payload = fh.read(length)
                    if len(payload) < length or zlib.crc32(payload) != crc:
                        bad += 1
                        break
                    try:
                        records.append(json.loads(payload.decode("utf-8")))
                    except (ValueError, UnicodeDecodeError):
                        bad += 1
                        break
                    good_end = fh.tell()
            if good_end < size:
                # Torn tail: drop it on the floor *in the file too*, so
                # the next append starts a clean frame boundary.
                with open(path, "r+b") as fh:
                    fh.truncate(good_end)
                self.truncated_bytes += size - good_end
                self.bad_records += max(1, bad)
                from penroz_tpu_torch.serve import metrics as serve_metrics
                serve_metrics.JOURNAL_BAD.inc(max(1, bad))
                log.warning(
                    "journal replay: truncated %d torn byte(s) at offset %d "
                    "of %s (%d bad frame(s) dropped)",
                    size - good_end, good_end, path, max(1, bad))
            self.records_total = len(records)
            self.replay_ms = (time.monotonic() - t0) * 1000.0
        return records

    # -- compaction ----------------------------------------------------------

    def should_compact(self, live_records: int) -> bool:
        """Dead-ratio trigger: worth rewriting once more than
        ``PENROZ_JOURNAL_COMPACT_RATIO`` of the frames describe state
        that no longer exists (dropped sessions, superseded quota rows)."""
        with self._lock:
            total = self.records_total
        if total < _COMPACT_MIN or not self.enabled():
            return False
        dead = max(0, total - live_records)
        return dead / total > _compact_ratio()

    def compact(self, live_records: list[dict]) -> bool:
        """Rewrite the log to exactly ``live_records`` via temp file +
        ``os.replace`` — a crash mid-compaction leaves the old log
        intact (plus a swept-at-startup temp file), never a half log."""
        path = journal_path()
        if path is None:
            return False
        tmp = f"{path}.compact.tmp"
        try:
            with self._lock:
                self._close_locked()
                with open(tmp, "wb") as fh:
                    for rec in live_records:
                        fh.write(_encode(rec))
                    fh.flush()
                    if fsync_policy() != "off":
                        os.fsync(fh.fileno())
                os.replace(tmp, path)
                self.records_total = len(live_records)
                self.compactions += 1
        except OSError:
            log.warning("journal compaction failed (keeping old log)",
                        exc_info=True)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        from penroz_tpu_torch.serve import metrics as serve_metrics
        serve_metrics.JOURNAL_COMPACTIONS.inc()
        return True

    # -- introspection / tests ----------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {
                "enabled": self.enabled(),
                "fsync": fsync_policy(),
                "records": self.records_total,
                "appended": self.appended,
                "append_errors": self.append_errors,
                "bad_records": self.bad_records,
                "truncated_bytes": self.truncated_bytes,
                "compactions": self.compactions,
                "replay_ms": round(self.replay_ms, 3),
            }

    def reset(self):
        """Test/bench hook: close the handle and zero counters.  Does
        NOT delete the file — tests that want a clean log point
        ``PENROZ_JOURNAL_PATH`` at a fresh tmp path instead."""
        with self._lock:
            self._close_locked()
            self._pending = 0
            self._last_fsync = 0.0
            self.records_total = 0
            self.appended = 0
            self.append_errors = 0
            self.bad_records = 0
            self.truncated_bytes = 0
            self.compactions = 0
            self.replay_ms = 0.0


JOURNAL = Journal()


def reset() -> None:
    JOURNAL.reset()
