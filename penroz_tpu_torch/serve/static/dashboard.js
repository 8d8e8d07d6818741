/* penroz_tpu_torch dashboard (the JAX package's, without the panels of
 * features the port lacks): polls /progress/, /stats/, /serving_stats/,
 * /memory/ and /trace/ and renders them on plain <canvas> (no chart
 * library). */
"use strict";

const $ = (id) => document.getElementById(id);

function getQueryState() {
  const p = new URLSearchParams(location.search);
  return { modelId: p.get("model_id") || "", filter: p.get("filter") || "" };
}

function setQueryState(modelId, filter) {
  const p = new URLSearchParams();
  if (modelId) p.set("model_id", modelId);
  if (filter) p.set("filter", filter);
  history.replaceState(null, "", `${location.pathname}?${p}`);
}

/* ---- tiny canvas plotting helpers ------------------------------------- */

const COLORS = ["#7fd1b9", "#e0b35c", "#7aa2f7", "#e06c75", "#b58cd9",
                "#56b6c2", "#98c379", "#d19a66"];

function prepCanvas(canvas) {
  const ctx = canvas.getContext("2d");
  ctx.clearRect(0, 0, canvas.width, canvas.height);
  return ctx;
}

function drawAxes(ctx, w, h, pad) {
  ctx.strokeStyle = "#2a3642";
  ctx.beginPath();
  ctx.moveTo(pad, 8); ctx.lineTo(pad, h - pad); ctx.lineTo(w - 8, h - pad);
  ctx.stroke();
}

function drawLabel(ctx, text, x, y, color = "#5d7285") {
  ctx.fillStyle = color;
  ctx.font = "11px sans-serif";
  ctx.fillText(text, x, y);
}

/* Draw one or more series as lines. series: [{name, xs, ys}] */
function lineChart(canvas, series, opts = {}) {
  const ctx = prepCanvas(canvas);
  const w = canvas.width, h = canvas.height, pad = 46;
  drawAxes(ctx, w, h, pad);
  const pts = series.flatMap(s => s.ys.filter(Number.isFinite));
  if (!pts.length) { drawLabel(ctx, "no data", w / 2 - 20, h / 2); return; }
  let lo = Math.min(...pts), hi = Math.max(...pts);
  if (lo === hi) { lo -= 1; hi += 1; }
  const xMax = Math.max(...series.map(s => s.xs.length ? Math.max(...s.xs) : 1));
  const xMin = Math.min(...series.map(s => s.xs.length ? Math.min(...s.xs) : 0));
  const sx = (x) => pad + (x - xMin) / Math.max(1e-9, xMax - xMin) * (w - pad - 16);
  const sy = (y) => (h - pad) - (y - lo) / (hi - lo) * (h - pad - 16);

  series.forEach((s, i) => {
    ctx.strokeStyle = COLORS[i % COLORS.length];
    ctx.lineWidth = 1.5;
    ctx.beginPath();
    let started = false;
    s.xs.forEach((x, j) => {
      const y = s.ys[j];
      if (!Number.isFinite(y)) return;
      if (!started) { ctx.moveTo(sx(x), sy(y)); started = true; }
      else ctx.lineTo(sx(x), sy(y));
    });
    ctx.stroke();
  });
  drawLabel(ctx, hi.toPrecision(4), 4, 16);
  drawLabel(ctx, lo.toPrecision(4), 4, h - pad);
  if (opts.legend) {
    series.forEach((s, i) => {
      drawLabel(ctx, s.name, pad + 8 + i * 130, 16, COLORS[i % COLORS.length]);
    });
  }
}

/* Max-normalized bar series on a canvas. */
function drawBars(canvas, ys, color) {
  const ctx = prepCanvas(canvas);
  const w = canvas.width, h = canvas.height, pad = 8;
  const hi = Math.max(...ys, 1e-12);
  const bw = (w - 2 * pad) / ys.length;
  ctx.fillStyle = color;
  ys.forEach((v, i) => {
    const bh = v / hi * (h - 2 * pad);
    ctx.fillRect(pad + i * bw, h - pad - bh, Math.max(1, bw - 1), bh);
  });
  return ctx;
}

/* Histogram as filled bars. data: {x: edges, y: densities} */
function histChart(canvas, data) {
  const w = canvas.width, h = canvas.height, pad = 8;
  if (!data || !data.x || !data.x.length) {
    drawLabel(prepCanvas(canvas), "no data", w / 2 - 20, h / 2); return;
  }
  const n = data.y.length;
  const ctx = drawBars(canvas, data.y, "#3f7f6b");
  drawLabel(ctx, Number(data.x[0]).toPrecision(3), pad, h - 1);
  drawLabel(ctx, Number(data.x[n - 1]).toPrecision(3), w - 50, h - 1);
}

/* ---- data fetch + render ---------------------------------------------- */

async function fetchJson(url) {
  const res = await fetch(url);
  if (!res.ok) throw new Error(`${url}: HTTP ${res.status}`);
  return res.json();
}

function renderProgress(data) {
  const progress = data.progress || [];
  const epochs = progress.map(p => p.epoch);
  const badge = $("status-badge");
  const code = data.status && data.status.code || "—";
  badge.textContent = code;
  badge.className = "badge " + (code === "Error" ? "err" :
    code === "Training" ? "busy" : "ok");

  lineChart($("cost-chart"), [{
    name: "log10(cost)", xs: epochs,
    ys: progress.map(p => Math.log10(Math.max(p.cost, 1e-12))),
  }], { legend: true });

  lineChart($("avg-cost-chart"), [{
    name: "avg cost",
    xs: (data.average_cost_history || []).map((_, i) => i),
    ys: data.average_cost_history || [],
  }]);

  lineChart($("speed-chart"), [{
    name: "tokens/sec", xs: epochs,
    ys: progress.map(p => p.speedPerSec),
  }]);

  // weight update ratios: one series per weight index (log10)
  const nWeights = progress.length ?
    (progress[progress.length - 1].weight_upd_ratio || []).length : 0;
  const series = [];
  for (let wi = 0; wi < nWeights; wi++) {
    const ys = progress.map(p => {
      const r = (p.weight_upd_ratio || [])[wi];
      return r == null ? NaN : Math.log10(Math.max(r, 1e-12));
    });
    if (ys.some(Number.isFinite)) series.push({ name: `w${wi}`, xs: epochs, ys });
  }
  lineChart($("ratio-chart"), series.slice(0, COLORS.length), { legend: false });
}

function matchesFilter(name, idx, filter) {
  if (!filter) return true;
  const f = filter.toLowerCase();
  return name.toLowerCase().includes(f) || String(idx) === f;
}

function renderStats(stats, filter) {
  const grid = $("hist-grid");
  grid.innerHTML = "";
  if (!stats) {
    grid.innerHTML = "<div class='cell'><div class='title'>no stats yet</div></div>";
    return;
  }
  const addCell = (title, meta, draw) => {
    const cell = document.createElement("div");
    cell.className = "cell";
    const canvas = document.createElement("canvas");
    canvas.width = 300; canvas.height = 120;
    cell.innerHTML = `<div class="title">${title}</div><div class="meta">${meta}</div>`;
    cell.appendChild(canvas);
    grid.appendChild(cell);
    draw(canvas);
  };
  const addHistCell = (title, meta, histData) =>
    addCell(title, meta, (canvas) => histChart(canvas, histData));

  (stats.layers || []).forEach((layer, i) => {
    if (!layer || !matchesFilter(layer.algo, i, filter)) return;
    const act = layer.activation;
    addHistCell(`L${i} ${layer.algo} activations`,
      `μ=${act.mean.toPrecision(3)} σ=${act.std.toPrecision(3)} ` +
      `sat=${(act.saturated * 100).toFixed(1)}%`, act.histogram);
    if (layer.gradient) {
      addHistCell(`L${i} ${layer.algo} ∂cost/∂act`,
        `μ=${layer.gradient.mean.toPrecision(3)} σ=${layer.gradient.std.toPrecision(3)}`,
        layer.gradient.histogram);
    }
  });
  (stats.weights || []).forEach((wstat, i) => {
    if (!wstat || !matchesFilter("weight " + wstat.shape, i, filter)) return;
    addHistCell(`W${i} ${wstat.shape} ∂cost/∂w`,
      `w: μ=${wstat.data.mean.toPrecision(3)} σ=${wstat.data.std.toPrecision(3)}`,
      wstat.gradient.histogram);
  });
  // MoE routing: per-expert fraction bars (uniform = balanced; a single
  // tall bar = expert collapse).
  Object.entries(stats.moe_router_fractions || {}).forEach(([name, fr]) => {
    if (!matchesFilter(name, -1, filter)) return;
    const max = Math.max(...fr, 1e-9);
    addCell(name, `${fr.length} experts, max=${(max * 100).toFixed(1)}%`,
      (canvas) => drawBars(canvas, fr, "#4c8dd6"));
  });
}

/* ---- serving tile (continuous batching, /serving_stats/) --------------- */

/* Rolling client-side history so the tile shows a trajectory, not just the
 * latest sample (the endpoint reports instantaneous aggregates). */
const servingHistory = [];

function renderServing(data) {
  const meta = $("serving-meta");
  const canvas = $("serving-chart");
  if (!meta || !canvas) return;
  if (!data) {
    meta.textContent = "serving stats unavailable";
    return;
  }
  const drops = data.kv_pool_capacity_drops || 0;
  if (!data.continuous_batching_enabled && !(data.engines || []).length) {
    meta.textContent =
      `continuous batching off (PENROZ_CONTINUOUS_BATCHING=1 to enable)` +
      ` · KV pool drops ${drops}`;
    lineChart(canvas, []);
    return;
  }
  const occ = data.batch_occupancy || 0;
  const tps = data.decode_tokens_per_sec || 0;
  /* Prefix-cache + chunked-prefill observability (null-safe: the fields
   * only carry values when PENROZ_PREFIX_CACHE / chunked admission ran). */
  const hitRate = data.prefix_cache_hit_rate;
  const prefixTxt = hitRate == null ? "prefix cache off"
    : `prefix hits ${(hitRate * 100).toFixed(0)}% · evicted ` +
      `${data.prefix_cache_evicted_pages || 0} pages`;
  const stall = data.prefill_chunk_stall_ms_p99;
  /* Speculative decoding (PENROZ_SPEC_DECODE=1): accept rate of the
   * prompt-lookup drafts and tokens emitted per decode step — the >1
   * tokens/step headroom speculation buys (null-safe: accept rate is
   * null until the first draft). */
  const acceptRate = data.spec_accept_rate;
  const specTxt = !data.spec_decode_enabled ? "spec off"
    : `spec accept ${acceptRate == null ? "—"
         : (acceptRate * 100).toFixed(0) + "%"} · ` +
      `${(data.tokens_per_decode_step || 0).toFixed(2)} tok/step`;
  /* Compiled multi-step decode (PENROZ_SCHED_SUPERSTEP): tokens emitted
   * per device dispatch — ≈ the superstep size when fused decode runs
   * unconstrained, 1.0 on the legacy per-token dispatch loop (null-safe:
   * no value until the first decode dispatch). */
  const tpd = data.tokens_per_dispatch_avg;
  const multistepTxt = tpd == null
    ? `${data.dispatches_total || 0} dispatches`
    : `${tpd.toFixed(2)} tok/dispatch (${data.dispatches_total || 0} ` +
      `dispatches)`;
  /* Fault-tolerance readouts: shed/timeout counters and the engine
   * circuit breaker — an open breaker is the "stop paging the dashboard,
   * the engine is crash-looping" signal. */
  const crashes = data.crashes_total || 0;
  const breakerTxt = data.breaker_open
    ? `breaker OPEN (${crashes} crashes, ${data.engine_resets || 0} resets)`
    : `breaker ok (${crashes} crashes)`;
  const shedTxt = `shed ${data.queue_rejections || 0} · ` +
    `quota shed ${data.quota_rejections || 0} · ` +
    `timeouts ${data.deadline_timeouts || 0}`;
  /* Multi-tenant QoS (serve/qos.py): per-class p99 TTFT breakdown, the
   * preemption counter with its zero-recompute resume credit, and the
   * per-tenant token totals — "qos idle" until any non-default class,
   * tenant, or preemption shows up. */
  const ttftCls = data.ttft_ms_p99_by_class || {};
  const clsTxt = ["interactive", "standard", "batch"]
    .filter((c) => ttftCls[c] != null)
    .map((c) => `${c.slice(0, 5)} ${ttftCls[c].toFixed(0)}ms`)
    .join(" / ");
  const tenants = Object.entries(data.tenant_tokens || {});
  const tenantTxt = tenants.length === 0 ? ""
    : ` · tenants ${tenants.slice(0, 4)
        .map(([t, n]) => `${t}:${n}`).join(" ")}` +
      (tenants.length > 4 ? ` +${tenants.length - 4}` : "");
  const preempts = data.preemptions_total || 0;
  const qosTxt = (!clsTxt && !preempts && !tenants.length) ? "qos idle"
    : `ttft p99 [${clsTxt || "—"}] · preempts ${preempts} ` +
      `(${data.preempted_resume_cached_tokens || 0} tok resumed cached)` +
      tenantTxt;
  /* Pipeline-parallel serving (PENROZ_SERVE_PIPE_STAGES >= 2): stages,
   * the bubble fraction and the hand-offs (a nonzero host count means a
   * pipe.handoff fault re-staged activations through the host); "pipe
   * off" on unpiped engines. */
  const pipeStages = data.pipe_stages || 1;
  const bubble = data.pipe_bubble_fraction;
  const pipeTxt = pipeStages <= 1 ? "pipe off"
    : `pipe ${pipeStages} stages · bubble ` +
      `${bubble == null ? "—" : (bubble * 100).toFixed(0) + "%"} · ` +
      `handoffs ${data.pipe_handoffs || 0}` +
      `${data.pipe_handoff_host_fallbacks
         ? ` (${data.pipe_handoff_host_fallbacks} host)` : ""}`;
  meta.textContent =
    `rows ${data.active_rows}/${data.capacity} (occupancy ` +
    `${(occ * 100).toFixed(0)}%) · queue ${data.queue_depth} · ` +
    `${shedTxt} · ${breakerTxt}` +
    `${data.draining ? " · DRAINING" : ""} · ` +
    `${tps.toFixed(1)} tok/s · adm p50 ` +
    `${data.admission_latency_ms_p50 == null ? "—"
       : data.admission_latency_ms_p50.toFixed(1) + "ms"} · ` +
    `chunk stall p99 ${stall == null ? "—" : stall.toFixed(1) + "ms"} · ` +
    `${multistepTxt} · ` +
    `${specTxt} · ${prefixTxt} · ${qosTxt} · ${pipeTxt} · ` +
    `${data.engines_stuck ? `STUCK ${data.engines_stuck} · ` : ""}` +
    `KV pool drops ${drops}`;
  servingHistory.push({ occ: occ * 100, tps });
  if (servingHistory.length > 200) servingHistory.shift();
  const xs = servingHistory.map((_, i) => i);
  lineChart(canvas, [
    { name: "tokens/sec", xs, ys: servingHistory.map(h => h.tps) },
    { name: "occupancy %", xs, ys: servingHistory.map(h => h.occ) },
  ], { legend: true });
}

/* ---- tick telemetry strip (/serving_stats/ tick_timeline) -------------- */

/* Bars: per-tick dispatch wall time, colored by phase composition
 * (unified mixed > prefill chunk > verify > plain shared step); line:
 * batch occupancy.  This is the "what is the tick loop actually doing
 * between dispatches" panel — a green bar is a ragged unified tick whose
 * ONE dispatch carried prefill chunks alongside decode rows, a tall
 * amber bar is a phased chunk stall, a purple run is spec-decode verify
 * traffic, the teal line sagging is an underfed batch. */
function renderTickStrip(data) {
  const canvas = $("tick-strip");
  const meta = $("tick-meta");
  if (!canvas || !meta) return;
  const timeline = (data && data.tick_timeline) || [];
  if (!timeline.length) {
    meta.textContent = "no ticks yet";
    prepCanvas(canvas);
    return;
  }
  const fmt = (v) => (v == null ? "—" : v.toFixed(1) + "ms");
  meta.textContent =
    `${timeline.length} recent ticks · dispatch p50 ${fmt(data.tick_ms_p50)}` +
    ` p99 ${fmt(data.tick_ms_p99)} · itl p50 ${fmt(data.itl_ms_p50)}` +
    ` p99 ${fmt(data.itl_ms_p99)} · ttft p99 ${fmt(data.ttft_ms_p99)}`;
  const ticks = timeline.slice().reverse();  // chronological left → right
  const ctx = prepCanvas(canvas);
  const w = canvas.width, h = canvas.height, pad = 8;
  const hi = Math.max(...ticks.map(t => t.dispatch_ms), 1e-9);
  const bw = (w - 2 * pad) / ticks.length;
  ticks.forEach((t, i) => {
    const bh = Math.max(1, t.dispatch_ms / hi * (h - 2 * pad));
    ctx.fillStyle =
      t.unified && t.prefill_chunks > 0 && t.shared_rows > 0 ? "#98c379"
      : t.prefill_chunks > 0 ? "#e0b35c"
      : t.verify_rows > 0 ? "#b58cd9" : "#7aa2f7";
    ctx.fillRect(pad + i * bw, h - pad - bh, Math.max(1, bw - 1), bh);
  });
  ctx.strokeStyle = "#7fd1b9";
  ctx.lineWidth = 1.5;
  ctx.beginPath();
  ticks.forEach((t, i) => {
    const x = pad + i * bw + bw / 2;
    const y = h - pad - t.occupancy * (h - 2 * pad);
    if (i === 0) ctx.moveTo(x, y); else ctx.lineTo(x, y);
  });
  ctx.stroke();
  drawLabel(ctx, `${hi.toFixed(1)}ms`, 4, 12);
  drawLabel(ctx, "mixed", w - 248, 12, "#98c379");
  drawLabel(ctx, "chunk", w - 200, 12, "#e0b35c");
  drawLabel(ctx, "verify", w - 150, 12, "#b58cd9");
  drawLabel(ctx, "step", w - 100, 12, "#7aa2f7");
  drawLabel(ctx, "occupancy", w - 68, 12, "#7fd1b9");
}

/* ---- device capacity ledger (/memory/) --------------------------------- */

/* Owner states in stacked-bar order (occupied states bottom-up, free on
 * top) with their colors — mirrors serve/memledger.py PAGE_STATES. */
const MEM_STATES = ["row", "prefix_pinned", "prefix_evictable", "preempted",
                    "reserved", "free"];
const MEM_COLORS = {
  row: "#7aa2f7", prefix_pinned: "#b58cd9", prefix_evictable: "#56b6c2",
  preempted: "#d19a66", reserved: "#5d7285", free: "#22303c",
};

function fmtBytes(n) {
  if (n >= 1073741824) return (n / 1073741824).toFixed(2) + "GiB";
  if (n >= 1048576) return (n / 1048576).toFixed(1) + "MiB";
  if (n >= 1024) return (n / 1024).toFixed(1) + "KiB";
  return `${n}B`;
}

/* Rolling client-side stacked history of the pool page states (same idea
 * as servingHistory: /memory/ reports an instantaneous partition). */
const memoryHistory = [];

function renderMemory(data) {
  const meta = $("memory-meta");
  const canvas = $("memory-chart");
  if (!meta || !canvas) return;
  if (!data) {
    meta.textContent = "memory ledger unavailable";
    prepCanvas(canvas);
    return;
  }
  if (!data.memledger_enabled) {
    meta.textContent = "memory ledger off (PENROZ_MEMLEDGER=1 to enable)";
    prepCanvas(canvas);
    return;
  }
  const pool = data.pool_pages || {};
  const total = MEM_STATES.reduce((a, s) => a + (pool[s] || 0), 0);
  const used = total - (pool.free || 0);
  const hwmUsed = (data.high_water_pages || {}).used || 0;
  const pagesTxt = total === 0
    ? "no paged pool (PAGED_KV_CACHE=1 for page-granular attribution)"
    : `pages ${used}/${total} used (rows ${pool.row || 0} · pinned ` +
      `${pool.prefix_pinned || 0} · evictable ` +
      `${pool.prefix_evictable || 0} · preempted ${pool.preempted || 0} ` +
      `· reserved ${pool.reserved || 0} · free ${pool.free || 0}) · ` +
      `hwm ${hwmUsed}`;
  const tenants = Object.entries(data.tenant_pages || {});
  const tenantTxt = tenants.length === 0 ? ""
    : ` · tenant pages ${tenants.slice(0, 4)
        .map(([t, n]) => `${t}:${n}`).join(" ")}` +
      (tenants.length > 4 ? ` +${tenants.length - 4}` : "");
  const hbm = data.hbm_bytes || {};
  const hbmTotal = Object.values(hbm).reduce((a, b) => a + b, 0);
  const kvBytes = (hbm.kv_values || 0) + (hbm.kv_scales || 0) +
    (hbm.kv_block_table || 0);
  const hbmTxt = ` · device ${fmtBytes(hbmTotal)} (kv ${fmtBytes(kvBytes)})`;
  const tte = data.time_to_exhaustion_s;
  const tteTxt = ` · exhaustion ${tte == null ? "—" : tte.toFixed(0) + "s"}`;
  /* Leak/pressure health readouts: any nonzero underflow or audit
   * failure is a pin-accounting bug, not load. */
  const healthTxt = ` · pool drops ${data.kv_pool_capacity_drops || 0}` +
    ` · underflows ${data.unpin_underflows || 0}` +
    ` · audit failures ${data.audit_failures || 0}` +
    ` · flight records ${data.flight_records || 0}`;
  meta.textContent = pagesTxt + tenantTxt + hbmTxt + tteTxt + healthTxt;

  memoryHistory.push({ pool, total });
  if (memoryHistory.length > 200) memoryHistory.shift();
  const ctx = prepCanvas(canvas);
  const w = canvas.width, h = canvas.height, pad = 8;
  const hi = Math.max(...memoryHistory.map((m) => m.total), 1);
  const bw = (w - 2 * pad) / memoryHistory.length;
  memoryHistory.forEach((m, i) => {
    let y = h - pad;
    MEM_STATES.forEach((s) => {
      const bh = (m.pool[s] || 0) / hi * (h - 2 * pad);
      if (bh <= 0) return;
      ctx.fillStyle = MEM_COLORS[s];
      ctx.fillRect(pad + i * bw, y - bh, Math.max(1, bw - 1), bh);
      y -= bh;
    });
  });
  drawLabel(ctx, `${hi} pages`, 4, 12);
  let lx = w - 516;
  MEM_STATES.forEach((s) => {
    drawLabel(ctx, s.replace("prefix_", ""), lx, 12, MEM_COLORS[s]);
    lx += 74;
  });
}

/* ---- per-request trace waterfall (/trace/, /trace/{id}) ---------------- */

const SPAN_COLORS = {
  queue: "#5d7285", prefill: "#e0b35c", prefill_chunk: "#c77d0a",
  decode: "#7aa2f7", decode_step: "#56b6c2", verify: "#b58cd9",
  recovery: "#e06c75", legacy_generate: "#98c379",
  preempt: "#d19a66", resume: "#7fd1b9",
};

function flattenSpans(span, depth, out) {
  out.push({ span, depth });
  (span.children || []).forEach((c) => flattenSpans(c, depth + 1, out));
  return out;
}

function renderWaterfall(tree) {
  const canvas = $("trace-waterfall");
  const meta = $("trace-meta");
  if (!canvas || !meta) return;
  if (!tree || !tree.root) {
    meta.textContent =
      "no traces yet (serve a /generate/ request, or paste a request id)";
    prepCanvas(canvas);
    return;
  }
  const total = tree.root.duration_ms != null ? tree.root.duration_ms
    : Math.max(1, ...flattenSpans(tree.root, 0, [])
        .map(r => r.span.t1_ms == null ? r.span.t0_ms : r.span.t1_ms));
  const reason = (tree.meta && tree.meta.retire_reason) ||
    (tree.finished ? "finished" : "in flight");
  meta.textContent = `request ${tree.request_id} · ` +
    `${total.toFixed(1)}ms · ${reason}` +
    (tree.dropped_spans ? ` · ${tree.dropped_spans} spans dropped` : "");
  const rows = flattenSpans(tree.root, 0, []).slice(0, 24);
  const ctx = prepCanvas(canvas);
  const w = canvas.width, pad = 6, rowH = 15;
  const sx = (ms) => pad + 170 + (ms / Math.max(total, 1e-9))
    * (w - pad * 2 - 170);
  rows.forEach(({ span, depth }, i) => {
    const y = pad + i * rowH;
    const t0 = span.t0_ms || 0;
    const t1 = span.t1_ms == null ? total : span.t1_ms;
    ctx.fillStyle = SPAN_COLORS[span.name] || "#3f7f6b";
    ctx.fillRect(sx(t0), y + 3, Math.max(2, sx(t1) - sx(t0)), rowH - 5);
    const dur = span.duration_ms == null ? "…"
      : span.duration_ms.toFixed(1) + "ms";
    drawLabel(ctx, `${"  ".repeat(depth)}${span.name} ${dur}`,
              pad, y + rowH - 3);
  });
}

async function refreshTrace() {
  const input = $("trace-id");
  let id = input ? input.value.trim() : "";
  try {
    if (!id) {
      const list = await fetchJson("/trace/");
      if (list.traces && list.traces.length) id = list.traces[0].request_id;
      else if (list.live && list.live.length) id = list.live[0].request_id;
    }
    renderWaterfall(id
      ? await fetchJson(`/trace/${encodeURIComponent(id)}`) : null);
  } catch (e) {
    renderWaterfall(null);
  }
}

async function refresh() {
  const modelId = $("model-id").value.trim();
  const filter = $("layer-filter").value.trim();
  setQueryState(modelId, filter);
  try {
    const serving = await fetchJson("/serving_stats/");
    renderServing(serving);
    renderTickStrip(serving);
  } catch (e) {
    renderServing(null);
    renderTickStrip(null);
  }
  try {
    renderMemory(await fetchJson("/memory/"));
  } catch (e) {
    renderMemory(null);
  }
  await refreshTrace();
  if (!modelId) return;
  try {
    const progress = await fetchJson(`/progress/?model_id=${encodeURIComponent(modelId)}`);
    renderProgress(progress);
  } catch (e) {
    $("status-badge").textContent = "not found";
    $("status-badge").className = "badge err";
    return;
  }
  try {
    const stats = await fetchJson(`/stats/?model_id=${encodeURIComponent(modelId)}`);
    renderStats(stats, filter);
  } catch (e) {
    renderStats(null, filter);
  }
}

let autoTimer = null;
function setupAuto() {
  if (autoTimer) { clearInterval(autoTimer); autoTimer = null; }
  if ($("auto-refresh").checked) autoTimer = setInterval(refresh, 5000);
}

window.addEventListener("DOMContentLoaded", () => {
  const state = getQueryState();
  $("model-id").value = state.modelId;
  $("layer-filter").value = state.filter;
  $("refresh-btn").addEventListener("click", refresh);
  $("auto-refresh").addEventListener("change", setupAuto);
  [$("model-id"), $("layer-filter"), $("trace-id")].forEach(el => {
    if (el) el.addEventListener("keydown",
      (e) => { if (e.key === "Enter") refresh(); });
  });
  if (state.modelId) refresh();
});
