"""Trace capture over ``torch.profiler`` (counterpart of
penroz_tpu/utils/profiling.py, which wraps ``jax.profiler``).

- ``start(log_dir)`` / ``stop()`` — one process-wide capture of host and
  device activity (CPU, and CUDA where there is a card), started and
  stopped by ``POST /profile/`` from any thread; ``stop`` writes it as a
  Chrome trace JSON (``trace_<pid>_<ms>.json``) into ``log_dir``, which
  chrome://tracing and Perfetto open.
- ``span(name)`` — a named range around a hot region
  (``penroz/sched_tick``, ``penroz/sched_mixed``, ``penroz/load_batch``,
  ``penroz/train_epoch``), so that a trace names what the framework was
  doing; a ``torch.profiler.record_function`` for a caller's own
  profiler on its thread.

``torch.profiler`` keeps its state per thread: a capture must start and
stop on one thread, and it records host operations of that thread only.
So a capture runs on a thread of its own, which starts the profiler,
waits for ``stop`` and writes the trace; while it runs, every thread's
``span`` ranges (the scheduler's worker, a training thread, the request
handlers) are kept here and written into the trace beside the
profiler's events, each on its thread's row and on the profiler's clock.
Device activity (kernels, copies) is the card's, whatever thread
launched it.

The JAX package's live gRPC endpoint (``PENROZ_PROFILER_PORT``) has no
counterpart in ``torch.profiler``: :func:`unported_options` refuses it.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time

import torch

log = logging.getLogger(__name__)

PROFILER_PORT_ENV = "PENROZ_PROFILER_PORT"


class _Capture:
    """One capture: a thread that starts the profiler, waits for the stop
    request and writes the trace (``torch.profiler`` must start and stop
    on one thread)."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.ranges: list[tuple] = []   # (name, native tid, t0 ns, t1 ns)
        self._stop = threading.Event()
        self._started = threading.Event()
        self._done = threading.Event()
        self.path = None
        self.error = None
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="penroz-profiler")
        self._thread.start()
        self._started.wait()
        if self.error is not None:
            raise self.error

    def _run(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:  # noqa: BLE001 — raised in start()
            self.error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(self.log_dir, exist_ok=True)
            path = os.path.join(self.log_dir, f"trace_{os.getpid()}_"
                                              f"{int(time.time() * 1000)}"
                                              f".json")
            prof.export_chrome_trace(path)
            _merge_ranges(path, self.ranges)
            self.path = path
        except Exception as e:  # noqa: BLE001 — raised in stop()
            self.error = e
        self._done.set()

    def finish(self) -> str:
        """Stop the profiler and wait for the trace; its path."""
        self._stop.set()
        self._done.wait()
        self._thread.join()
        if self.error is not None:
            raise self.error
        return self.path


_lock = threading.Lock()
_active: _Capture | None = None


def unported_options() -> None:
    """ValueError (HTTP 400) when ``PENROZ_PROFILER_PORT`` asks for the
    JAX package's live-capture server."""
    if os.environ.get(PROFILER_PORT_ENV):
        raise ValueError(f"{PROFILER_PORT_ENV} selects jax.profiler's live "
                         f"capture server, which penroz_tpu_torch does not "
                         f"support; capture with POST /profile/")


def start(log_dir: str) -> bool:
    """Begin a capture into ``log_dir``; False when one is running."""
    global _active
    with _lock:
        if _active is not None:
            return False
        _active = _Capture(log_dir)
        log.info("Profiler trace started -> %s", log_dir)
        return True


def stop() -> str | None:
    """End the running capture and write its Chrome trace into its
    directory; returns the directory (None if nothing runs)."""
    global _active
    with _lock:
        capture, _active = _active, None
        if capture is None:
            return None
        path = capture.finish()
        log.info("Profiler trace stopped -> %s", path)
        return capture.log_dir


def _merge_ranges(path: str, ranges: list[tuple]):
    """Write the threads' ranges into the exported trace as complete
    events.  The profiler's timestamps are microseconds of the wall clock
    after ``baseTimeNanoseconds`` (0 where a version writes none)."""
    if not ranges:
        return
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1000.0
    pid = os.getpid()
    trace.setdefault("traceEvents", []).extend(
        {"ph": "X", "cat": "user_annotation", "name": name, "pid": pid,
         "tid": tid, "ts": t0 / 1000.0 - base_us, "dur": (t1 - t0) / 1000.0}
        for name, tid, t0, t1 in ranges)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, path)


@contextlib.contextmanager
def span(name: str):
    """A named range in captured traces, on whichever thread runs it."""
    capture = _active
    t0 = time.time_ns()
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if capture is not None:
            capture.ranges.append((name, threading.get_native_id(), t0,
                                   time.time_ns()))
