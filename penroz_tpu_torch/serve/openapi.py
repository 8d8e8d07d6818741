"""OpenAPI 3.1 spec and self-contained docs page for the REST API
(counterpart of penroz_tpu/serve/openapi.py).

The JAX package builds its component schemas with pydantic, which the
machine with the card does not have; here they are built from the port's
own request schemas' ``FIELDS`` tables (serve/schemas.py): a field
without a default is required, a nullable one also takes ``null``.  The
route table lists exactly the routes the port serves (serve/app.py),
templated paths as templates (``/trace/{request_id}``), and the
``/model/`` request example is the GPT-2-124M layer DSL.  ``/docs``
fetches ``/openapi.json`` and renders it in the browser, with no CDN.
"""

from __future__ import annotations

import json
from typing import Optional

from penroz_tpu_torch.serve import schemas


def gpt2_124m_example() -> dict:
    """The ``/model/`` example request: a GPT-2-124M layer DSL (the JAX
    package's example, the same DSL)."""
    vocab, d, heads, block, depth = 50257, 768, 12, 1024, 12
    attn_block = {"sequential": [
        {"layernorm": {"normalized_shape": d}},
        {"linear": {"in_features": d, "out_features": 3 * d},
         "normal": {"mean": 0.0, "std": 0.02}, "zeros": {}},
        {"attention": {"num_heads": heads, "dropout": 0.1}},
        {"linear": {"in_features": d, "out_features": d},
         "normal": {"mean": 0.0, "std": 0.02 / (2 * depth) ** 0.5},
         "zeros": {}},
        {"dropout": {"p": 0.1}}]}
    mlp_block = {"sequential": [
        {"layernorm": {"normalized_shape": d}},
        {"linear": {"in_features": d, "out_features": 4 * d},
         "normal": {"mean": 0.0, "std": 0.02}, "zeros": {}},
        {"gelu": {"approximate": "tanh"}},
        {"linear": {"in_features": 4 * d, "out_features": d},
         "normal": {"mean": 0.0, "std": 0.02 / (2 * depth) ** 0.5},
         "zeros": {}},
        {"dropout": {"p": 0.1}}]}
    layers = ([{"summation": [
                  {"embedding": {"num_embeddings": vocab, "embedding_dim": d},
                   "normal": {"mean": 0.0, "std": 0.02}},
                  {"position": {"num_embeddings": block, "embedding_dim": d},
                   "normal": {"mean": 0.0, "std": 0.02}}]},
               {"dropout": {"p": 0.1}}]
              + [{"residual": [attn_block, mlp_block]} for _ in range(depth)]
              + [{"layernorm": {"normalized_shape": d}},
                 {"linear": {"in_features": d, "out_features": vocab,
                             "bias": False},
                  "normal": {"mean": 0.0, "std": 0.02}},
                 {"softmaxlast": {"dim": -1}}])
    return {
        "model_id": "gpt2-124M",
        "layers": layers,
        "optimizer": {"adamw": {"lr": 6e-4, "betas": [0.9, 0.95],
                                "eps": 1e-8, "weight_decay": 0.1}},
    }


_KINDS = {str: {"type": "string"}, int: {"type": "integer"},
          float: {"type": "number"}, bool: {"type": "boolean"},
          list: {"type": "array"}, dict: {"type": "object"},
          "int_list": {"type": "array", "items": {"type": "integer"}},
          "str_list": {"type": "array", "items": {"type": "string"}},
          "opt_str_list": {"type": "array", "items": {
              "anyOf": [{"type": "string"}, {"type": "null"}]}},
          "int_lists": {"type": "array", "items": {
              "type": "array", "items": {"type": "integer"}}}}


def _kind_schema(kind) -> dict:
    if isinstance(kind, tuple):
        return {"anyOf": [_kind_schema(k) for k in kind]}
    return dict(_KINDS[kind])


def request_schema(cls) -> dict:
    """The JSON schema of one request body, from its ``FIELDS``."""
    props, required = {}, []
    for name, kind, default, nullable in cls.FIELDS:
        prop = _kind_schema(kind)
        if nullable:
            prop = {"anyOf": [prop, {"type": "null"}]}
        if default is schemas._REQUIRED:
            required.append(name)
        else:
            prop["default"] = default
        props[name] = prop
    doc = (cls.__doc__ or "").strip()
    out = {"title": cls.__name__, "type": "object", "properties": props,
           "required": required}
    if doc and not doc.startswith(cls.__name__ + "("):  # not dataclass's
        out["description"] = " ".join(doc.split())
    return out


def _fields_schema(fields) -> dict:
    props = {}
    for name, kind, description in fields:
        if isinstance(kind, tuple) and None in kind:
            prop = {"anyOf": [_kind_schema(k) for k in kind if k is not None]
                    + [{"type": "null"}]}
        else:
            prop = _kind_schema(kind)
        props[name] = dict(prop, description=description)
    return {"type": "object", "properties": props}


def serving_stats_schema() -> dict:
    """``GET /serving_stats/``'s documented fields: the replica router's
    and disaggregation's, aggregate and per engine (``engines``)."""
    out = _fields_schema(schemas.SERVING_STATS_FIELDS)
    out["properties"]["engines"] = {
        "type": "array",
        "items": _fields_schema(schemas.SERVING_STATS_ENGINE_FIELDS)}
    return out


def memory_schema() -> dict:
    """``GET /memory/``'s documented field: each engine's ``stage_pools``
    entries."""
    return {"type": "object", "properties": {"engines": {
        "type": "array", "items": {"type": "object", "properties": {
            "stage_pools": {"type": "array", "items": _fields_schema(
                schemas.STAGE_POOL_FIELDS)}}}}}}


def _query_params(*names: str) -> list[dict]:
    return [{"name": n, "in": "query", "required": True,
             "schema": {"type": "string"}} for n in names]


def _path_params(*names: str) -> list[dict]:
    return [{"name": n, "in": "path", "required": True,
             "schema": {"type": "string"}} for n in names]


def _body(model_name: str, example: Optional[dict] = None) -> dict:
    media: dict = {"schema": {"$ref": f"#/components/schemas/{model_name}"}}
    if example is not None:
        media["example"] = example
    return {"required": True, "content": {"application/json": media}}


def _resp(status: int, description: str) -> tuple[str, dict]:
    return str(status), {"description": description}


def _routes() -> list[dict]:
    """(method, path, summary, body or query params, responses) of every
    route the port serves."""
    ok = _resp(200, "Success")
    shed = [_resp(429, "Admission queue full (PENROZ_SCHED_MAX_QUEUE or "
                       "PENROZ_QOS_MAX_QUEUE_<CLASS>) or the tenant's "
                       "token quota exhausted: retry after the "
                       "Retry-After seconds"),
            _resp(503, "Engine circuit breaker open "
                       "(PENROZ_ENGINE_MAX_CRASHES consecutive crashes): "
                       "retry after the Retry-After seconds"),
            _resp(504, "Request deadline exceeded (timeout_ms / "
                       "PENROZ_REQ_TIMEOUT_MS)")]
    profile = dict(
        summary="Start/stop a torch.profiler capture (host and device "
                "activity, with the penroz/sched_* and penroz/train_* "
                "ranges); stop writes a Chrome trace JSON into log_dir",
        body=_body("ProfileRequest"),
        responses=dict([ok, _resp(409, "Capture state conflict")]))
    return [
        dict(method="get", path="/",
             summary="Redirect to /dashboard",
             responses=dict([_resp(302, "Found")])),
        dict(method="get", path="/dashboard",
             summary="Dashboard: training curves, serving, scheduler "
                     "ticks, the page ledger and request traces",
             responses=dict([_resp(200, "HTML dashboard")])),
        dict(method="get", path="/static/{path}",
             summary="The dashboard's script and style",
             params=_path_params("path"),
             responses=dict([_resp(200, "File"),
                             _resp(404, "No such file")])),
        dict(method="get", path="/metrics",
             summary="Prometheus text exposition (format 0.0.4): request/"
                     "token/shed/crash/QoS counters, engine and capacity-"
                     "ledger gauges, and fixed-bucket TTFT / ITL / "
                     "queue-wait / chunk-stall / tick histograms (per "
                     "class too)",
             responses=dict([_resp(200, "text/plain exposition")])),
        dict(method="get", path="/trace/",
             summary="Recent per-request trace summaries (completed ring "
                     "of PENROZ_TRACE_BUFFER + in flight), sampled via "
                     "PENROZ_TRACE_SAMPLE",
             params=[{"name": "limit", "in": "query", "required": False,
                      "schema": {"type": "integer", "minimum": 1,
                                 "maximum": 1000, "default": 50}}],
             responses=dict([_resp(200, "Trace summaries"),
                             _resp(422, "limit is not an integer")])),
        dict(method="get", path="/trace/{request_id}",
             summary="One request's lifecycle span tree (queue, prefill, "
                     "prefix match, chunks, decode steps, preemption, "
                     "recovery, retire_reason; ids from the X-Request-Id "
                     "header); ?format=chrome gives Chrome trace-event "
                     "JSON",
             params=_path_params("request_id") + [
                 {"name": "format", "in": "query", "required": False,
                  "schema": {"type": "string", "enum": ["json", "chrome"],
                             "default": "json"}}],
             responses=dict([_resp(200, "Span tree (or Chrome "
                                        "trace-event JSON)"),
                             _resp(404, "Unknown or evicted request id"),
                             _resp(422, "Unknown format")])),
        dict(method="get", path="/memory/",
             summary="Capacity ledger: every pool page attributed to an "
                     "owner (free / row / prefix pinned or evictable / "
                     "preempted hold / reserved), pages per tenant, "
                     "device bytes per component (a contiguous cache's "
                     "too), a pipeline group's pool by stage, high-water "
                     "marks and a time-to-exhaustion estimate",
             responses={"200": {"description": "Success", "content": {
                 "application/json": {"schema": memory_schema()}}}}),
        dict(method="get", path="/debug/dump",
             summary="Crash flight recorder: the last "
                     "PENROZ_DEBUG_DUMP_RING engine_crash / circuit_open "
                     "snapshots (ledger, tick tail, queue depths by class "
                     "and tenant, recent trace ids)",
             responses=dict([ok])),
        dict(method="get", path="/tenants/",
             summary="Tenant quota state: rate overrides, tokens charged "
                     "and quota sheds per tenant",
             responses=dict([ok])),
        dict(method="put", path="/tenants/{tenant_id}/quota",
             summary="Set (or clear with null) a tenant's token-rate "
                     "override of PENROZ_QOS_TENANT_TOKENS_PER_S and, with "
                     "tier_mb, its hibernated-session residency cap "
                     "(PENROZ_QOS_TENANT_TIER_MB); journaled",
             params=_path_params("tenant_id"),
             body=_body("TenantQuotaRequest"),
             responses=dict([ok, _resp(400, "Negative tokens_per_s or "
                                            "tier_mb"),
                             _resp(422, "Validation error")])),
        dict(method="get", path="/sessions/",
             summary="Hibernated sessions in the KV tiers (hbm, host, "
                     "disk) across engines and replicas: tier, tokens, "
                     "pages, bytes, replica and age of each",
             responses=dict([ok])),
        dict(method="delete", path="/sessions/{session_id}",
             summary="Evict one hibernated session from every tier "
                     "(idempotent: deleted false when not resident)",
             params=_path_params("session_id"),
             responses=dict([ok])),
        dict(method="get", path="/generate/{request_id}/stream",
             summary="Reattach to a streamed /generate/: seq:value lines "
                     "from from_seq on (replayed from the request's ring, "
                     "then live), exactly once; the terminal line is "
                     "seq:done, seq:timeout or seq:error",
             params=_path_params("request_id") + [
                 {"name": "from_seq", "in": "query", "required": False,
                  "schema": {"type": "integer", "minimum": 0,
                             "default": 0}}],
             responses=dict([_resp(200, "seq:value lines"),
                             _resp(404, "Unknown or purged request id"),
                             _resp(410, "from_seq behind the replay ring "
                                        "(PENROZ_STREAM_REPLAY) or the "
                                        "detach grace expired"),
                             _resp(422, "from_seq not an integer >= 0")])),
        dict(method="get", path="/healthz",
             summary="Liveness probe (always 200 while the server answers)",
             responses=dict([_resp(200, "Alive")])),
        dict(method="get", path="/readyz",
             summary="Readiness probe: 503 while an engine circuit "
                     "breaker is open, a tick is stuck past "
                     "PENROZ_TICK_WATCHDOG_MS, or shutdown drains",
             responses=dict([_resp(200, "Ready to serve"),
                             _resp(503, "Breaker open, stuck or "
                                        "draining")])),
        dict(method="get", path="/openapi.json", summary="This document",
             responses=dict([_resp(200, "OpenAPI 3.1 JSON")])),
        dict(method="get", path="/docs", summary="API docs page",
             responses=dict([_resp(200, "HTML")])),
        dict(method="post", path="/model/",
             summary="Create a model from the layer/optimizer DSL",
             body=_body("CreateModelRequest", gpt2_124m_example()),
             responses=dict([ok, _resp(400, "Invalid DSL"),
                             _resp(422, "Validation error")])),
        dict(method="post", path="/import/",
             summary="Import a HuggingFace checkpoint from a local "
                     "directory",
             body=_body("ImportModelRequest"),
             responses=dict([ok, _resp(400, "A hub id or an unsupported "
                                            "family"),
                             _resp(409, "Import already in progress")])),
        dict(method="get", path="/dataset/",
             summary="List dataset shards and the last download's state",
             params=_query_params("dataset_id"), responses=dict([ok])),
        dict(method="post", path="/dataset/",
             summary="Download + tokenize + shard a HuggingFace dataset",
             body=_body("DownloadDatasetRequest"),
             responses=dict([_resp(202, "Download started"),
                             _resp(409, "Download already in progress")])),
        dict(method="delete", path="/dataset/", summary="Delete all shards",
             params=_query_params("dataset_id"),
             responses=dict([_resp(204, "Deleted")])),
        dict(method="post", path="/tokenize/",
             summary="Tokenize text ('byte' or 'bpe:<model file>')",
             body=_body("TokenizeTextRequest"), responses=dict([ok])),
        dict(method="post", path="/output/",
             summary="Raw forward pass (+ optional cost)",
             body=_body("OutputRequest"),
             responses=dict([ok, _resp(404, "Unknown model")])),
        dict(method="post", path="/evaluate/", summary="Evaluate model cost",
             body=_body("EvaluateRequest"),
             responses=dict([ok, _resp(404, "Unknown model")])),
        dict(method="post", path="/generate/",
             summary="Generate tokens (set stream:true for one per line)",
             body=_body("GenerateRequest"),
             responses=dict([ok, _resp(404, "Unknown model")] + shed)),
        dict(method="post", path="/generate_batch/",
             summary="N prompts of different lengths through the "
                     "continuous-batching scheduler",
             body=_body("GenerateBatchRequest"),
             responses=dict([ok, _resp(404, "Unknown model"),
                             _resp(400, "Prompt + max_new_tokens exceeds "
                                        "block_size, or an empty prompt")]
                            + shed)),
        dict(method="post", path="/decode/", summary="Decode token ids",
             body=_body("DecodeTokensRequest"), responses=dict([ok])),
        dict(method="put", path="/train/",
             summary="Train asynchronously (poll /progress/)",
             body=_body("TrainingRequest"),
             responses=dict([_resp(202, "Training started"),
                             _resp(404, "Unknown model"),
                             _resp(400, "Invalid device or adapter "
                                        "config"),
                             _resp(409, "Training already in progress")])),
        dict(method="post", path="/profile/", **profile),
        dict(method="post", path="/profiler/trace/", **profile),
        dict(method="get", path="/progress/",
             summary="Training progress, average cost history, status",
             params=_query_params("model_id"),
             responses=dict([ok, _resp(404, "Unknown model")])),
        dict(method="get", path="/stats/",
             summary="Activation/gradient/weight histograms",
             params=_query_params("model_id"),
             responses=dict([ok, _resp(404, "Unknown model")])),
        dict(method="get", path="/serving_stats/",
             summary="Continuous-batching scheduler stats: queue depth, "
                     "occupancy, tick timeline, prefix cache, speculation, "
                     "crashes, breaker and shed counters, the replica "
                     "router and disaggregated prefill",
             responses=dict([("200", {
                 "description": "Success",
                 "content": {"application/json": {
                     "schema": serving_stats_schema()}}})])),
        dict(method="delete", path="/model/",
             summary="Delete a model and its LoRA adapters",
             params=_query_params("model_id"),
             responses=dict([_resp(204, "Deleted")])),
        dict(method="post", path="/adapters/",
             summary="Create a LoRA adapter of a model",
             body=_body("CreateAdapterRequest"),
             responses=dict([ok, _resp(404, "Unknown model"),
                             _resp(400, "Rank outside [1, "
                                        "PENROZ_LORA_MAX_RANK], unknown "
                                        "init, or targets matching no "
                                        "Linear"),
                             _resp(409, "Adapter already exists")])),
        dict(method="get", path="/adapters/",
             summary="Every adapter, or one (adapter_id) with its training "
                     "progress",
             params=[{"name": "adapter_id", "in": "query",
                      "required": False, "schema": {"type": "string"}}],
             responses=dict([ok, _resp(404, "Unknown adapter")])),
        dict(method="delete", path="/adapters/",
             summary="Delete a LoRA adapter",
             params=_query_params("adapter_id"),
             responses=dict([_resp(204, "Deleted"),
                             _resp(404, "Unknown adapter")])),
    ]


def build_spec() -> dict:
    paths: dict = {}
    for route in _routes():
        op: dict = {"summary": route["summary"],
                    "responses": route["responses"]}
        if "body" in route:
            op["requestBody"] = route["body"]
        if "params" in route:
            op["parameters"] = route["params"]
        paths.setdefault(route["path"], {})[route["method"]] = op
    return {
        "openapi": "3.1.0",
        "info": {
            "title": "penroz_tpu_torch",
            "version": "1.0.0",
            "description": "The PyTorch port of the penroz_tpu service: "
                           "model lifecycle, datasets, training, "
                           "generation.",
        },
        "paths": paths,
        "components": {"schemas": {cls.__name__: request_schema(cls)
                                   for cls in schemas.REQUESTS}},
    }


_DOCS_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>penroz_tpu_torch API docs</title>
<style>
body{font-family:system-ui,sans-serif;margin:2em auto;max-width:960px;color:#222}
h1{font-size:1.5em} .op{border:1px solid #ddd;border-radius:6px;margin:.8em 0}
.hd{display:flex;gap:.8em;align-items:center;padding:.5em .8em;cursor:pointer;background:#fafafa}
.m{font-weight:700;text-transform:uppercase;min-width:4.5em;text-align:center;
   border-radius:4px;padding:.15em .4em;color:#fff;font-size:.85em}
.get{background:#2b7de9}.post{background:#2fa44f}.put{background:#c77d0a}.delete{background:#c0392b}
.body{display:none;padding:.8em;border-top:1px solid #eee}
.op.open .body{display:block}
pre{background:#f6f8fa;padding:.8em;border-radius:6px;overflow:auto;font-size:.85em}
code{background:#f2f2f2;padding:.1em .3em;border-radius:3px}
.resp{margin:.15em 0}
</style></head><body>
<h1>penroz_tpu_torch API</h1>
<p>Spec: <a href="/openapi.json">openapi.json</a></p>
<div id="ops">loading…</div>
<script>
fetch('/openapi.json').then(r=>r.json()).then(spec=>{
  const root=document.getElementById('ops'); root.textContent='';
  for(const [path,methods] of Object.entries(spec.paths)){
    for(const [method,op] of Object.entries(methods)){
      const div=document.createElement('div'); div.className='op';
      const hd=document.createElement('div'); hd.className='hd';
      hd.innerHTML=`<span class="m ${method}">${method}</span>`+
        `<code>${path}</code><span>${op.summary||''}</span>`;
      hd.onclick=()=>div.classList.toggle('open');
      const body=document.createElement('div'); body.className='body';
      let html='';
      if(op.parameters) html+='<p>Query: '+op.parameters.map(p=>
        `<code>${p.name}</code>`).join(' ')+'</p>';
      const ex=op.requestBody?.content?.['application/json']?.example;
      const ref=op.requestBody?.content?.['application/json']?.schema?.$ref;
      if(ref) html+=`<p>Body schema: <code>${ref.split('/').pop()}</code></p>`;
      if(ex) html+='<p>Example:</p><pre>'+
        JSON.stringify(ex,null,1).slice(0,4000)+'</pre>';
      html+='<p>Responses:</p>'+Object.entries(op.responses).map(([c,r])=>
        `<div class="resp"><code>${c}</code> ${r.description||''}</div>`).join('');
      body.innerHTML=html; div.append(hd,body); root.append(div);
    }
  }
});
</script></body></html>"""


def docs_html() -> str:
    return _DOCS_HTML


def spec_json() -> str:
    return json.dumps(build_spec())
