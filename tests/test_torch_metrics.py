"""The port's metrics primitives (utils/metrics.py) and ``/metrics``
series (serve/metrics.py) against the JAX package's, on the CPU.

- The same observations (numpy seeds) into both ``Hist`` classes give the
  same snapshots, p50 and p99, and the same merged snapshots.
- A registry built the same way in both packages renders byte-equal
  0.0.4 text.
- Every series of the port's ``serve/metrics.py`` is one of the JAX
  package's, with the same type, label names and HELP text, and a scrape
  after real engine traffic parses line by line as 0.0.4 with each
  histogram's ``+Inf`` bucket equal to its ``_count``."""

import re

import numpy as np
import pytest

from penroz_tpu.serve import metrics as jserve_metrics
from penroz_tpu.utils import metrics as jm
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.utils import metrics as m


def _samples(seed, n=500):
    rng = np.random.default_rng(seed)
    kind = seed % 3
    if kind == 0:
        return rng.lognormal(2.5, 1.2, n)            # latencies, ms
    if kind == 1:
        return rng.integers(1, 40, n).astype(float)  # tokens a dispatch
    return np.concatenate([rng.uniform(0, 1, n // 2),
                           rng.uniform(1e3, 5e4, n // 2)])


@pytest.mark.parametrize("buckets", ["latency", "tokens"])
@pytest.mark.parametrize("seed", range(6))
def test_hist_matches_jax(seed, buckets):
    edges = (m.LATENCY_BUCKETS_MS if buckets == "latency"
             else m.TOKENS_PER_DISPATCH_BUCKETS)
    assert edges == (jm.LATENCY_BUCKETS_MS if buckets == "latency"
                     else jm.TOKENS_PER_DISPATCH_BUCKETS)
    ours, ref = m.Hist(edges), jm.Hist(edges)
    assert ours.quantile(0.5) is None and ref.quantile(0.5) is None
    for x in _samples(seed):
        ours.observe(x)
        ref.observe(x)
    assert ours.snapshot() == ref.snapshot()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ours.quantile(q) == ref.quantile(q)
    parts = [m.Hist(edges) for _ in range(3)]
    jparts = [jm.Hist(edges) for _ in range(3)]
    for i, x in enumerate(_samples(seed + 100)):
        parts[i % 3].observe(x)
        jparts[i % 3].observe(x)
    merged = m.merge_snapshots([p.snapshot() for p in parts] + [None])
    jmerged = jm.merge_snapshots([p.snapshot() for p in jparts] + [None])
    assert merged == jmerged
    assert m.quantile_of(merged, 0.99) == jm.quantile_of(jmerged, 0.99)
    assert m.merge_snapshots([]) == jm.merge_snapshots([])


def _registry(mod, seed):
    reg = mod.Registry()
    plain = reg.register(mod.Counter("x_total", "Plain counter"))
    labelled = reg.register(mod.Counter("y_total", "By outcome",
                                        ("outcome",)))
    reg.register(mod.Gauge("g_fn", "Callback", fn=lambda: 2.5))
    reg.register(mod.Gauge("g_none", "Absent", fn=lambda: None))
    reg.register(mod.Gauge("g_lab", "Labelled", labelnames=("state",),
                           fn=lambda: {"free": 3, "row": 7.25}))
    hist = reg.register(mod.Histogram("h_ms", "Latency"))
    by_cls = reg.register(mod.Histogram("hc_ms", "By class",
                                        labelnames=("priority",)))
    rng = np.random.default_rng(seed)
    for x in rng.lognormal(2.0, 1.0, 200):
        plain.inc()
        labelled.inc(outcome=["ok", "err\"or", "a\\b"][int(x) % 3])
        hist.observe(x)
        by_cls.observe(x, priority=["interactive", "batch"][int(x) % 2])
    return reg


@pytest.mark.parametrize("seed", range(3))
def test_registry_renders_byte_equal_to_jax(seed):
    assert _registry(m, seed).render() == _registry(jm, seed).render()


def _series(registry):
    return {name: (metric.kind, tuple(getattr(metric, "labelnames", ())),
                   metric.help)
            for name, metric in registry._metrics.items()}


def test_serve_series_are_a_subset_of_jax():
    ours, ref = _series(serve_metrics.REGISTRY), _series(
        jserve_metrics.REGISTRY)
    assert set(ours) <= set(ref)
    for name, spec in ours.items():
        assert spec == ref[name], name


_LINE = re.compile(
    r'^(# (HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+'
    r'|[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|\\.)*")*)?\})? '
    r'(-?[0-9.e+-]+|\+Inf|NaN))$')


def parse_exposition(text: str) -> dict:
    """Strict 0.0.4 parse: every line matches; returns {series: value}
    (series = name + label body)."""
    assert text.endswith("\n")
    out = {}
    for line in text.rstrip("\n").split("\n"):
        assert _LINE.match(line), line
        if not line.startswith("#"):
            series, value = line.rsplit(" ", 1)
            out[series] = float(value)
    return out


def test_scrape_after_traffic_parses(workdir, monkeypatch, toy_gpt_layers,
                                     toy_optimizer):
    """Engine traffic through the port (two tenants, two classes, a prefix
    hit): the scrape parses strictly, its counters equal
    ``/serving_stats/``'s, and every histogram's ``+Inf`` bucket equals its
    ``_count``."""
    from penroz_tpu.models.dsl import Mapper as JMapper
    from penroz_tpu.models.model import NeuralNetworkModel as JModel
    from penroz_tpu.utils import checkpoint as jckpt
    from penroz_tpu_torch.serve import decode_scheduler as DS
    from penroz_tpu_torch.utils import checkpoint as tckpt
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1"),
                        ("PENROZ_PREFIX_CACHE_PAGES", "8")):
        monkeypatch.setenv(name, value)
    JModel("scrape", JMapper(toy_gpt_layers, toy_optimizer)).serialize(
        sync_flush=True)
    serve_metrics.reset()
    DS.reset()
    try:
        engine = DS.get_engine("scrape", 16, 0.0, None, device="cpu")
        for prompt, pri, tenant in (([1, 2, 3, 4, 5], "batch", "a"),
                                    ([1, 2, 3, 4, 6], "interactive", "b"),
                                    ([7], None, None)):
            DS.run_request(engine, prompt, 4, None, timeout=60,
                           priority=pri, tenant=tenant)
        text = serve_metrics.render()
        stats = DS.serving_stats()
    finally:
        DS.reset()
    got = parse_exposition(text)
    assert got['penroz_requests_total{outcome="completed"}'] == 3
    assert got["penroz_decode_tokens_total"] == stats["decode_tokens"]
    assert got["penroz_dispatches_total"] == stats["dispatches_total"]
    assert got["penroz_prefix_cache_hits_total"] == 1
    assert got["penroz_prefix_cache_misses_total"] == 2
    assert got['penroz_class_admissions_total{priority="batch"}'] == 1
    assert got['penroz_tenant_tokens_total{tenant="default"}'] == 4
    assert got["penroz_engines"] == 1
    assert got["penroz_ttft_ms_count"] == 3
    families = {s.split("_bucket{")[0] + "|" + re.sub(
        r',?le="[^"]*"', "", s.split("_bucket")[1])
        for s in got if "_bucket{" in s}
    for fam in families:
        name, labels = fam.split("|")
        labels = "" if labels == "{}" else labels
        body = labels[1:-1] + "," if labels else ""
        inf = f'{name}_bucket{{{body}le="+Inf"}}'
        assert got[inf] == got[f"{name}_count{labels}"], fam
    # LoRA, the replica router, the session tiers and pipeline serving are
    # ported: the LoRA gauge reads 0 live adapters, no adapter emitted a
    # token, one engine made no router placement or failover, with no
    # session_id no session was hibernated, demoted or woken, and an
    # unpiped engine ran no pipeline tick; XLA's series stay absent
    assert got["penroz_pipe_stages"] == 1
    assert got["penroz_pipe_ticks"] == got["penroz_pipe_bubble_ticks"] == 0
    assert got['penroz_pipe_handoffs{path="device"}'] == 0
    assert got['penroz_pipe_handoffs{path="host"}'] == 0
    assert got["penroz_lora_live_adapters"] == 0
    assert got["penroz_router_failovers_total"] == 0
    assert got["penroz_disagg_role_changes_total"] == 0
    assert got["penroz_sessions_hibernated_total"] == 0
    assert got["penroz_sessions_resident"] == 0
    assert got["penroz_streams_detached"] == 0
    assert {s: v for s, v in got.items()
            if s.startswith("penroz_tier_pages")} == {
        'penroz_tier_pages{tier="hbm"}': 0, 'penroz_tier_pages{tier="host"}':
        0, 'penroz_tier_pages{tier="disk"}': 0}
    assert not any(s.startswith(("penroz_lora_adapter_tokens",
                                 "penroz_router_affinity", "penroz_jit",
                                 "penroz_tier_promotions",
                                 "penroz_tier_demotions"))
                   for s in got)
