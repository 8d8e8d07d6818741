"""Deterministic fault injection for recovery-path testing (counterpart of
penroz_tpu/utils/faults.py, the same grammar).

A recovery path that has never run is a recovery path that does not work,
so the failures are produced on demand: hot paths carry a one-line
``faults.check("site")`` hook that is a no-op (one environment read)
unless ``PENROZ_FAULT_INJECT`` arms it.

Spec grammar (comma-separated rules)::

    PENROZ_FAULT_INJECT="decode.step:raise@3,ckpt.write:raise@1"
    PENROZ_FAULT_INJECT="decode.step:sleep@200"
    PENROZ_FAULT_INJECT="decode.step:raise@2+"

- ``site:raise@N``  — raise :class:`InjectedFault` on exactly the Nth call
  to ``check(site)`` (1-based; several rules for one site compose, so
  ``s:raise@1,s:raise@2`` fails the first two calls).
- ``site:raise@N+`` — raise on the Nth call and every call after it
  (consecutive failures, the engine circuit breaker's path).
- ``site:sleep@MS`` — sleep MS milliseconds on every call (deadline and
  overload paths).

An unparseable rule is logged and ignored.  Sites in the port:
``decode.step`` (every unified block of the continuous-batching engine,
every phased shared step and superstep),
``decode.prefill_chunk`` (a block that carries a prefill chunk, a phased
chunk), ``decode.verify`` (a block that carries a speculative verify
span, a phased verify), all three before the dispatch, and
``qos.preempt`` (a preemption, before it mutates anything); the
pipeline's ``pipe.handoff`` (a stage-to-stage hand-off, after the stage
ran and before the next takes its activations: a failure is contained,
the activations go through the host, counted in
``pipe_handoff_host_fallbacks``, the tokens unchanged) and
``pipe.stage_crash`` (the top of each stage's dispatch: the tick crashes
and the recovery rebuilds the whole group's cache)
(serve/decode_scheduler.py);
``ckpt.write`` (the checkpoint container write, whose temporary file is
removed, utils/checkpoint.py); ``data.download`` (one dataset download
attempt, data/loaders.py); ``lora.load`` (an adapter checkpoint's load
into the serving registry, serve/adapters.py); the disaggregated-prefill
hand-off's ``disagg.handoff`` (ordinal 1 mid-export, 2 mid-import),
``disagg.d2d`` (the d2d transport's exporter-side gather, then the
importer's scatter) and ``disagg.rebalance`` (an elastic role flip,
before it changes the role) (serve/decode_scheduler.py); the session
tiers' ``tier.demote`` (a background demotion, before the page export)
and ``tier.promote`` (a wake, before the blob import touches the radix
cache or the pool), both crashing the tick into the engine's recovery
(serve/decode_scheduler.py); ``journal.append`` (each journal frame's
write: a failure is contained, the record dropped and counted) and
``journal.replay`` (the start-up replay, before any frame is read: the
registry recovers empty) (serve/journal.py); ``stream.resume`` (a
reattach at ``GET /generate/{id}/stream``, before the replay ring is
read: the HTTP error, the generation running on) (serve/streams.py);
on engines of a model with ``ssm`` layers only, ``ssm.scan`` (before each
unified block and each phased shared step or superstep: a crash drops
the recurrent states with the rest of the engine's state, and the
recovery serves the next request with the same tokens) and
``ssm.handoff`` (inside both hand-off exports, before the blob is
gathered: a failure falls back as ``disagg.handoff`` does, the tokens
unchanged) (serve/decode_scheduler.py).
None sits inside a captured CUDA graph.
Call counters are per site and process-wide; :func:`reset` clears them
and the parsed-spec cache.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time

log = logging.getLogger(__name__)

ENV = "PENROZ_FAULT_INJECT"


class InjectedFault(RuntimeError):
    """The failure an armed ``raise@N`` rule raises: a type of its own, so
    that tests can tell the crash they asked for from any other."""


class _Rule:
    __slots__ = ("mode", "n", "open_ended")

    def __init__(self, mode: str, n: int, open_ended: bool):
        self.mode = mode
        self.n = n
        self.open_ended = open_ended


_LOCK = threading.Lock()
_COUNTS: collections.Counter = collections.Counter()
_CACHED_SPEC: str | None = None
_CACHED_RULES: dict[str, list[_Rule]] = {}


def _parse(spec: str) -> dict[str, list[_Rule]]:
    rules: dict[str, list[_Rule]] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        try:
            site, action = part.split(":", 1)
            mode, arg = action.split("@", 1)
            open_ended = mode == "raise" and arg.endswith("+")
            n = int(arg[:-1] if open_ended else arg)
            if mode not in ("raise", "sleep") or n < 0:
                raise ValueError(part)
        except ValueError:
            log.warning("Ignoring unparseable %s rule %r "
                        "(want site:raise@N[+] or site:sleep@MS)", ENV, part)
            continue
        rules.setdefault(site, []).append(_Rule(mode, n, open_ended))
    return rules


def _rules_for(site: str) -> list[_Rule]:
    global _CACHED_SPEC, _CACHED_RULES
    spec = os.environ.get(ENV, "")
    with _LOCK:
        if spec != _CACHED_SPEC:
            _CACHED_RULES = _parse(spec)
            _CACHED_SPEC = spec
        return _CACHED_RULES.get(site, ())


def check(site: str):
    """No-op unless ``PENROZ_FAULT_INJECT`` arms ``site``.  Sleeps first
    (every matching ``sleep`` rule), then raises if a ``raise`` rule
    matches this call's ordinal, so a ``sleep`` + ``raise`` pair models a
    slow failure."""
    if not os.environ.get(ENV):
        return
    rules = _rules_for(site)
    if not rules:
        return
    with _LOCK:
        _COUNTS[site] += 1
        count = _COUNTS[site]
    for rule in rules:
        if rule.mode == "sleep":
            time.sleep(rule.n / 1000.0)
    for rule in rules:
        if rule.mode == "raise" and (
                count == rule.n or (rule.open_ended and count >= rule.n)):
            raise InjectedFault(
                f"injected fault at {site} (call {count})")


def call_count(site: str) -> int:
    """How many armed ``check(site)`` calls have run (0 while disarmed:
    the fast path counts nothing)."""
    with _LOCK:
        return _COUNTS[site]


def reset():
    """Clear the call counters and the parsed-spec cache."""
    global _CACHED_SPEC, _CACHED_RULES
    with _LOCK:
        _COUNTS.clear()
        _CACHED_SPEC = None
        _CACHED_RULES = {}
