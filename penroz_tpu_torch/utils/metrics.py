"""Dependency-free Prometheus metrics primitives (counterpart of
penroz_tpu/utils/metrics.py, the same buckets, quantile rule and text).

Counters (optionally labelled), gauges (set or computed at scrape time),
and fixed-bucket histograms, with a strict text-exposition renderer
(format 0.0.4: ``# HELP`` / ``# TYPE`` lines, cumulative
``_bucket{le=...}`` series, ``_sum`` and ``_count``).

:class:`Hist` is the raw bucketed data (observe / quantile / merge) that
each ``DecodeEngine`` keeps per latency metric: a histogram keeps every
observation's bucket, so a p99 over an hour of traffic is the hour's p99.
Registered :class:`Histogram` metrics wrap the same class for
``GET /metrics``.  The buckets are the JAX package's, so the quantiles of
the same observations are equal in both packages.

Everything here is host-side and lock-guarded, O(#buckets) at worst per
observation (a binary search and one increment).
"""

from __future__ import annotations

import bisect
import threading

# Default latency buckets (milliseconds): ~sub-ms host work through
# multi-second stalls, dense in the 5-100ms band where serving ITL/TTFT
# actually lives (quantiles resolve to bucket edges — coarse buckets
# would round a 12ms p50 up to the next edge).  Shared by every serving
# histogram so snapshots merge bucket-for-bucket.
LATENCY_BUCKETS_MS = (
    0.5, 1.0, 2.5, 5.0, 7.5, 10.0, 15.0, 20.0, 30.0, 50.0, 75.0,
    100.0, 150.0, 250.0, 500.0, 1000.0, 2500.0, 5000.0, 10000.0,
    30000.0)

# Buckets for token-count-per-dispatch distributions (compiled multi-step
# decode): small integers, dense through the PENROZ_SCHED_SUPERSTEP range —
# a 1-token bucket distinguishes the legacy per-token path from any fusing
# at all, and the tail covers superstep × spec-decode composition headroom.
TOKENS_PER_DISPATCH_BUCKETS = (
    1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)


class Hist:
    """Fixed-bucket histogram data: cumulative-friendly counts, sum,
    count, and observed min/max (quantiles clamp to the observed max so
    the +Inf bucket never reports infinity)."""

    __slots__ = ("buckets", "counts", "sum", "count", "max", "_lock")

    def __init__(self, buckets=LATENCY_BUCKETS_MS):
        self.buckets = tuple(float(b) for b in buckets)
        assert list(self.buckets) == sorted(self.buckets), "sorted buckets"
        self.counts = [0] * (len(self.buckets) + 1)  # last = +Inf
        self.sum = 0.0
        self.count = 0
        self.max = None
        self._lock = threading.Lock()

    def observe(self, value: float) -> None:
        value = float(value)
        idx = bisect.bisect_left(self.buckets, value)
        with self._lock:
            self.counts[idx] += 1
            self.sum += value
            self.count += 1
            if self.max is None or value > self.max:
                self.max = value

    def snapshot(self) -> dict:
        with self._lock:
            return {"buckets": list(self.buckets),
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count, "max": self.max}

    def quantile(self, q: float) -> float | None:
        return quantile_of(self.snapshot(), q)


def quantile_of(snapshot: dict, q: float) -> float | None:
    """Nearest-bucket-upper-bound quantile of a :meth:`Hist.snapshot`
    (or a merge of several): the smallest bucket edge covering the
    q-fraction of observations, clamped to the observed max.  None with
    zero observations — 'never measured' stays distinct from 0."""
    count = snapshot["count"]
    if not count:
        return None
    target = q * count
    cum = 0
    for edge, c in zip(snapshot["buckets"], snapshot["counts"]):
        cum += c
        if cum >= target:
            if snapshot["max"] is not None:
                return min(edge, snapshot["max"])
            return edge
    return snapshot["max"]


def merge_snapshots(snapshots) -> dict:
    """Merge same-layout snapshots (identical bucket edges) into one —
    the cross-engine aggregation path of ``/serving_stats/``."""
    snapshots = [s for s in snapshots if s is not None]
    if not snapshots:
        return {"buckets": list(LATENCY_BUCKETS_MS),
                "counts": [0] * (len(LATENCY_BUCKETS_MS) + 1),
                "sum": 0.0, "count": 0, "max": None}
    base = snapshots[0]
    counts = [0] * len(base["counts"])
    total, smax = 0, None
    ssum = 0.0
    for s in snapshots:
        assert s["buckets"] == base["buckets"], "mismatched bucket layouts"
        for i, c in enumerate(s["counts"]):
            counts[i] += c
        total += s["count"]
        ssum += s["sum"]
        if s["max"] is not None:
            smax = s["max"] if smax is None else max(smax, s["max"])
    return {"buckets": list(base["buckets"]), "counts": counts,
            "sum": ssum, "count": total, "max": smax}


# -- registered metrics -----------------------------------------------------

def _fmt_value(v: float) -> str:
    """Prometheus sample value: integers render bare, floats as repr."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    body = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"')
                     .replace("\n", "\\n"))
        for k, v in sorted(labels.items()))
    return "{" + body + "}"


class Metric:
    kind = "untyped"

    def __init__(self, name: str, help_text: str):
        self.name = name
        self.help = help_text

    def render(self) -> list[str]:
        lines = [f"# HELP {self.name} {self.help}",
                 f"# TYPE {self.name} {self.kind}"]
        lines.extend(self.sample_lines())
        return lines

    def sample_lines(self) -> list[str]:  # pragma: no cover - abstract
        raise NotImplementedError

    def reset(self) -> None:  # pragma: no cover - overridden where stateful
        pass


class Counter(Metric):
    """Monotonic counter, optionally labeled.  An unlabeled counter
    renders even at 0 (scrapers want the series to exist); labeled
    counters render one series per observed label set."""

    kind = "counter"

    def __init__(self, name: str, help_text: str, labelnames=()):
        super().__init__(name, help_text)
        self.labelnames = tuple(labelnames)
        self._values: dict = {}
        self._lock = threading.Lock()

    def inc(self, amount: float = 1, **labels) -> None:
        assert set(labels) == set(self.labelnames), (labels, self.labelnames)
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            self._values[key] = self._values.get(key, 0) + amount

    def value(self, **labels) -> float:
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            return self._values.get(key, 0)

    def sample_lines(self) -> list[str]:
        with self._lock:
            items = sorted(self._values.items())
        if not self.labelnames:
            v = items[0][1] if items else 0
            return [f"{self.name} {_fmt_value(v)}"]
        return [self.name
                + _fmt_labels(dict(zip(self.labelnames, key)))
                + f" {_fmt_value(v)}" for key, v in items]

    def reset(self) -> None:
        with self._lock:
            self._values.clear()


class Gauge(Metric):
    """Instantaneous value — set directly or computed at scrape time via
    ``set_function`` (engine-registry state is read fresh per scrape, so
    the gauge can never go stale).  With ``labelnames`` the callback
    returns a mapping of label-value (single name) or label-value tuple
    (several) to value, rendered as one series per key."""

    kind = "gauge"

    def __init__(self, name: str, help_text: str, fn=None, labelnames=()):
        super().__init__(name, help_text)
        self.labelnames = tuple(labelnames)
        self._value = 0.0
        self._fn = fn

    def set(self, value: float) -> None:
        self._value = float(value)

    def set_function(self, fn) -> None:
        self._fn = fn

    def sample_lines(self) -> list[str]:
        if self.labelnames:
            try:
                values = dict(self._fn()) if self._fn is not None else {}
            except Exception:  # noqa: BLE001 — a scrape must never 500
                values = {}
            lines = []
            for key, v in sorted(values.items()):
                if not isinstance(key, tuple):
                    key = (key,)
                lines.append(self.name
                             + _fmt_labels(dict(zip(self.labelnames, key)))
                             + f" {_fmt_value(v)}")
            return lines
        v = self._value
        if self._fn is not None:
            try:
                v = self._fn()
            except Exception:  # noqa: BLE001 — a scrape must never 500
                v = self._value
            # A callback returning None means "no value right now": the
            # series is ABSENT from the scrape rather than rendered as a
            # misleading 0 (same contract as quantile_of on an empty
            # histogram) — e.g. time-to-exhaustion with no burn rate.
            if v is None:
                return []
            v = float(v)
        return [f"{self.name} {_fmt_value(v)}"]


class Histogram(Metric):
    """Registered histogram wrapping :class:`Hist`; renders cumulative
    ``_bucket`` series plus ``_sum`` / ``_count``.  With ``labelnames``
    each observed label set gets its own :class:`Hist` and renders as a
    distinct series family (``_bucket{le=...,priority=...}`` etc.) — the
    per-SLO-class latency breakdowns the QoS layer exports."""

    kind = "histogram"

    def __init__(self, name: str, help_text: str,
                 buckets=LATENCY_BUCKETS_MS, labelnames=()):
        super().__init__(name, help_text)
        self.labelnames = tuple(labelnames)
        self._buckets = tuple(buckets)
        self.hist = Hist(buckets)          # unlabeled fast path
        self._hists: dict = {}             # label-key tuple -> Hist
        self._lock = threading.Lock()

    def observe(self, value: float, **labels) -> None:
        assert set(labels) == set(self.labelnames), (labels, self.labelnames)
        if not self.labelnames:
            self.hist.observe(value)
            return
        key = tuple(str(labels[k]) for k in self.labelnames)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Hist(self._buckets)
        h.observe(value)

    def _series_lines(self, snap: dict, label_body: str) -> list[str]:
        # label_body is "" or 'k="v",...' — le= is appended alongside so
        # every series in the family carries the full label set.
        sep = "," if label_body else ""
        lines = []
        cum = 0
        for edge, c in zip(snap["buckets"], snap["counts"]):
            cum += c
            lines.append(f'{self.name}_bucket{{{label_body}{sep}'
                         f'le="{_fmt_value(edge)}"}} {cum}')
        lines.append(f'{self.name}_bucket{{{label_body}{sep}le="+Inf"}} '
                     f'{snap["count"]}')
        suffix = "{" + label_body + "}" if label_body else ""
        lines.append(f"{self.name}_sum{suffix} {_fmt_value(snap['sum'])}")
        lines.append(f"{self.name}_count{suffix} {snap['count']}")
        return lines

    def sample_lines(self) -> list[str]:
        if not self.labelnames:
            return self._series_lines(self.hist.snapshot(), "")
        with self._lock:
            items = sorted(self._hists.items())
        lines = []
        for key, h in items:
            body = _fmt_labels(dict(zip(self.labelnames, key)))[1:-1]
            lines.extend(self._series_lines(h.snapshot(), body))
        return lines

    def reset(self) -> None:
        self.hist = Hist(self._buckets)
        with self._lock:
            self._hists.clear()


class Registry:
    def __init__(self):
        self._metrics: dict[str, Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: Metric):
        with self._lock:
            assert metric.name not in self._metrics, metric.name
            self._metrics[metric.name] = metric
        return metric

    def render(self) -> str:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: list[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        """Zero every stateful metric (tests)."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m.reset()
