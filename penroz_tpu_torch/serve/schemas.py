"""Request validation for the REST API in plain Python (counterpart of the
pydantic models of penroz_tpu/serve/schemas.py, which the machine with the
card does not have).

A missing required field, a value of the wrong type or a string off its
field's pattern raises :class:`ValidationError` (→ HTTP 422, as pydantic's
does); unknown fields are ignored, as pydantic's default is.  A validated
request's ``model_fields_set`` names the fields the payload carried.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Optional

_REQUIRED = object()


class ValidationError(Exception):
    """Invalid request body; ``errors`` lists one dict per field."""

    def __init__(self, errors: list[dict]):
        super().__init__("; ".join(f"{e['loc'][0]}: {e['msg']}"
                                   for e in errors))
        self.errors = errors


def _is_int(v) -> bool:
    return isinstance(v, int) and not isinstance(v, bool)


def _check(kind, v) -> tuple[bool, Any]:
    """(ok, coerced value) of ``v`` against a field kind (a tuple of kinds
    takes the first that fits)."""
    if isinstance(kind, tuple):
        for k in kind:
            ok, coerced = _check(k, v)
            if ok:
                return True, coerced
        return False, v
    if kind is str:
        return isinstance(v, str), v
    if kind is int:
        if _is_int(v):
            return True, v
        if isinstance(v, float) and v.is_integer():
            return True, int(v)
        return False, v
    if kind is float:
        ok = _is_int(v) or isinstance(v, float)
        return ok, float(v) if ok else v
    if kind is bool:
        return isinstance(v, bool), v
    if kind is list:
        return isinstance(v, list), v
    if kind is dict:
        return isinstance(v, dict), v
    if kind == "int_list":
        ok = isinstance(v, list) and all(_check(int, x)[0] for x in v)
        return ok, [_check(int, x)[1] for x in v] if ok else v
    if kind == "str_list":
        return isinstance(v, list) and all(isinstance(x, str) for x in v), v
    if kind == "opt_str_list":
        return isinstance(v, list) and all(x is None or isinstance(x, str)
                                           for x in v), v
    if kind == "int_lists":
        ok = isinstance(v, list) and all(_check("int_list", x)[0] for x in v)
        return ok, [_check("int_list", x)[1] for x in v] if ok else v
    raise TypeError(kind)


def _kind_name(kind) -> str:
    if isinstance(kind, tuple):
        return " or ".join(_kind_name(k) for k in kind)
    return getattr(kind, "__name__", kind)


class _Request:
    """Base: ``FIELDS`` is a tuple of (name, kind, default, nullable);
    ``PATTERNS`` maps a string field to the regular expression its value
    must match."""

    FIELDS: tuple = ()
    PATTERNS: dict = {}

    @classmethod
    def model_validate(cls, payload):
        if not isinstance(payload, dict):
            raise ValidationError([{"loc": ["body"], "msg":
                                    "Input should be a JSON object"}])
        values, errors = {}, []
        for name, kind, default, nullable in cls.FIELDS:
            if name not in payload:
                if default is _REQUIRED:
                    errors.append({"loc": [name], "msg": "Field required",
                                   "type": "missing"})
                else:
                    values[name] = default
                continue
            v = payload[name]
            if v is None and nullable:
                values[name] = None
                continue
            ok, coerced = _check(kind, v)
            if not ok:
                errors.append({"loc": [name], "type": "type_error",
                               "msg": f"Input should be of type "
                                      f"{_kind_name(kind)}"})
            elif name in cls.PATTERNS and not re.search(cls.PATTERNS[name],
                                                        coerced):
                errors.append({"loc": [name],
                               "type": "string_pattern_mismatch",
                               "msg": f"String should match pattern "
                                      f"'{cls.PATTERNS[name]}'"})
            values[name] = coerced
        if errors:
            raise ValidationError(errors)
        request = cls(**values)
        request.model_fields_set = {name for name, *_ in cls.FIELDS
                                    if name in payload}
        return request


SESSION_ID_PATTERN = r"^[A-Za-z0-9._-]{1,120}$"


@dataclass
class CreateModelRequest(_Request):
    model_id: str
    layers: list
    optimizer: dict

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("layers", list, _REQUIRED, False),
              ("optimizer", dict, _REQUIRED, False))


@dataclass
class GenerateRequest(_Request):
    """``POST /generate/``.  ``timeout_ms`` is the request's deadline on
    the scheduler path (capped by ``PENROZ_REQ_TIMEOUT_MS``; none when
    absent or not positive).  ``priority`` (``interactive``, ``standard``
    or ``batch``; an unknown class is a 400) and ``tenant`` (quota
    bucket, ``default`` when absent) route a scheduler request through
    the fair queue (serve/qos.py); ``tenant`` absent, an ``adapter_id``
    (a LoRA adapter of the model, serve/adapters.py) is the tenant.
    ``session_id`` (``[A-Za-z0-9._-]{1,120}``: it names a disk-tier blob
    file) hibernates the request's KV at retirement (serve/tierstore.py)."""
    model_id: str
    input: list
    block_size: int
    max_new_tokens: int
    temperature: float = 1.0
    top_k: Optional[int] = None
    stop_token: Optional[int] = None
    stream: bool = False
    timeout_ms: Optional[int] = None
    adapter_id: Optional[str] = None
    priority: Optional[str] = None
    tenant: Optional[str] = None
    session_id: Optional[str] = None

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("input", list, _REQUIRED, False),
              ("block_size", int, _REQUIRED, False),
              ("max_new_tokens", int, _REQUIRED, False),
              ("temperature", float, 1.0, False),
              ("top_k", int, None, True),
              ("stop_token", int, None, True),
              ("stream", bool, False, False),
              ("timeout_ms", int, None, True),
              ("adapter_id", str, None, True),
              ("priority", str, None, True),
              ("tenant", str, None, True),
              ("session_id", str, None, True))

    PATTERNS = {"session_id": SESSION_ID_PATTERN}


@dataclass
class GenerateBatchRequest(_Request):
    """``POST /generate_batch/``: N prompts (ragged lengths) through the
    continuous-batching scheduler; ``timeout_ms`` is each row's deadline,
    and a shed row sheds the batch.  ``priority`` and ``tenant`` apply to
    every row, as on /generate/.  ``adapter_ids`` (one per row, null for
    the base model) overrides the batch-wide ``adapter_id``.
    ``session_ids`` (one per row, null for none) are the rows'
    ``session_id``s."""
    model_id: str
    inputs: list
    block_size: int
    max_new_tokens: int
    temperature: float = 1.0
    top_k: Optional[int] = None
    stop_token: Optional[int] = None
    timeout_ms: Optional[int] = None
    adapter_id: Optional[str] = None
    adapter_ids: Optional[list] = None
    priority: Optional[str] = None
    tenant: Optional[str] = None
    session_ids: Optional[list] = None

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("inputs", "int_lists", _REQUIRED, False),
              ("block_size", int, _REQUIRED, False),
              ("max_new_tokens", int, _REQUIRED, False),
              ("temperature", float, 1.0, False),
              ("top_k", int, None, True),
              ("stop_token", int, None, True),
              ("timeout_ms", int, None, True),
              ("adapter_id", str, None, True),
              ("adapter_ids", list, None, True),
              ("priority", str, None, True),
              ("tenant", str, None, True),
              ("session_ids", "opt_str_list", None, True))


@dataclass
class TokenizeTextRequest(_Request):
    encoding: str
    text: str

    FIELDS = (("encoding", str, _REQUIRED, False),
              ("text", str, _REQUIRED, False))


@dataclass
class DecodeTokensRequest(_Request):
    encoding: str
    tokens: list

    FIELDS = (("encoding", str, _REQUIRED, False),
              ("tokens", "int_list", _REQUIRED, False))


@dataclass
class OutputRequest(_Request):
    """``POST /output/``: the raw forward of ``input`` (token ids, or
    features for a non-token model), with the cost against ``target``
    when given."""
    model_id: str
    input: list
    target: Optional[list | int] = None

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("input", list, _REQUIRED, False),
              ("target", (list, int), None, True))


@dataclass
class AdapterTrainConfig(_Request):
    """``PUT /train/``'s ``adapter``: train this LoRA adapter (created on
    its first training) against the frozen base model.  ``rank`` (1 to
    ``PENROZ_LORA_MAX_RANK``, a 400 outside), ``alpha`` (default 2 ×
    rank: the delta is alpha/r · B·A·x), ``targets`` (substrings of the
    Linear projections' parameter prefixes; null: every one)."""
    adapter_id: str
    rank: int = 8
    alpha: Optional[float] = None
    targets: Optional[list] = None

    FIELDS = (("adapter_id", str, _REQUIRED, False),
              ("rank", int, 8, False),
              ("alpha", float, None, True),
              ("targets", "str_list", None, True))


@dataclass
class CreateAdapterRequest(_Request):
    """``POST /adapters/``: register a fresh LoRA adapter of a model.  B
    starts at zero (the base model exactly, until trained) unless
    ``init`` is ``"random"``; ``seed`` seeds the draws; ``rank``,
    ``alpha``, ``targets`` as on ``PUT /train/``'s ``adapter``."""
    model_id: str
    adapter_id: str
    rank: int = 8
    alpha: Optional[float] = None
    targets: Optional[list] = None
    seed: int = 0
    init: str = "zeros"

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("adapter_id", str, _REQUIRED, False),
              ("rank", int, 8, False),
              ("alpha", float, None, True),
              ("targets", "str_list", None, True),
              ("seed", int, 0, False),
              ("init", str, "zeros", False))


@dataclass
class TrainingRequest(_Request):
    """``PUT /train/``.  ``device`` absent means the server's device (the
    port runs on the card unless told ``"cpu"``; the JAX package's default
    is ``"cpu"``).  ``adapter`` (an :class:`AdapterTrainConfig`,
    validated with the body: 422 on a missing or mistyped field) trains a
    LoRA adapter instead of the model."""
    model_id: str
    dataset_id: str
    shard: int
    epochs: int
    batch_size: int
    block_size: int
    step_size: int
    device: Optional[str] = None
    adapter: Optional[dict] = None

    FIELDS = (("model_id", str, _REQUIRED, False),
              ("dataset_id", str, _REQUIRED, False),
              ("shard", int, _REQUIRED, False),
              ("epochs", int, _REQUIRED, False),
              ("batch_size", int, _REQUIRED, False),
              ("block_size", int, _REQUIRED, False),
              ("step_size", int, _REQUIRED, False),
              ("device", str, None, True),
              ("adapter", dict, None, True))

    @classmethod
    def model_validate(cls, payload):
        body = super().model_validate(payload)
        if body.adapter is not None:
            try:
                body.adapter = AdapterTrainConfig.model_validate(body.adapter)
            except ValidationError as e:
                raise ValidationError([dict(err, loc=["adapter", *err["loc"]])
                                       for err in e.errors])
        return body


@dataclass
class EvaluateRequest(TrainingRequest):
    """``POST /evaluate/``: the training request's fields, and an optional
    dataset to read the targets from.  ``device`` and ``adapter`` are
    accepted and not read, as in the JAX service: the model is evaluated
    on the server's device."""
    target_dataset_id: Optional[str] = None

    FIELDS = TrainingRequest.FIELDS + (
        ("target_dataset_id", str, None, True),)


@dataclass
class ImportModelRequest(_Request):
    """``POST /import/``: a HuggingFace checkpoint in a local directory
    (``hf_repo_id`` names the directory; the port imports no hub id).
    ``device`` absent means the server's device (the card unless the
    server runs on the CPU; the JAX package's default is ``"cpu"``)."""
    hf_repo_id: str
    model_id: str
    revision: Optional[str] = None
    device: Optional[str] = None

    FIELDS = (("hf_repo_id", str, _REQUIRED, False),
              ("model_id", str, _REQUIRED, False),
              ("revision", str, None, True),
              ("device", str, None, True))


@dataclass
class DownloadDatasetRequest(_Request):
    """``POST /dataset/``: a HuggingFace ``datasets`` split, tokenized with
    ``encoding`` into shards of ``shard_size`` tokens."""
    dataset_id: str
    encoding: str
    path: str
    split: str
    shard_size: int
    name: Optional[str] = None

    FIELDS = (("dataset_id", str, _REQUIRED, False),
              ("encoding", str, _REQUIRED, False),
              ("path", str, _REQUIRED, False),
              ("split", str, _REQUIRED, False),
              ("shard_size", int, _REQUIRED, False),
              ("name", str, None, True))


@dataclass
class TenantQuotaRequest(_Request):
    """``PUT /tenants/{tenant_id}/quota``: the tenant's sustained token
    budget per second over emitted + prefilled tokens (burst: one second
    of rate, at least 1 token), overriding
    ``PENROZ_QOS_TENANT_TOKENS_PER_S``; 0 blocks the tenant's new
    admissions, null clears the override.  ``tier_mb`` is the tenant's
    residency cap over the hibernated-session tiers in MB (overriding
    ``PENROZ_QOS_TENANT_TIER_MB``; null clears the override, absent leaves
    it as it is)."""
    tokens_per_s: Optional[float]
    tier_mb: Optional[float] = None

    FIELDS = (("tokens_per_s", float, _REQUIRED, True),
              ("tier_mb", float, None, True))


@dataclass
class ProfileRequest(_Request):
    """``POST /profile/`` and ``/profiler/trace/``: ``"start"`` or
    ``"stop"`` a ``torch.profiler`` capture whose Chrome trace goes into
    ``log_dir`` (start only)."""
    action: str
    log_dir: str = "profiles"

    FIELDS = (("action", str, _REQUIRED, False),
              ("log_dir", str, "profiles", False))


# The request bodies of the routes, by schema name (serve/openapi.py).
REQUESTS = (CreateModelRequest, ImportModelRequest, DownloadDatasetRequest,
            TokenizeTextRequest, OutputRequest, EvaluateRequest,
            GenerateRequest, GenerateBatchRequest, DecodeTokensRequest,
            TrainingRequest, TenantQuotaRequest, ProfileRequest,
            CreateAdapterRequest, AdapterTrainConfig)


_PIPE_FIELDS = (
    ("pipe_stages", int, "Pipeline stages (PENROZ_SERVE_PIPE_STAGES; 1 = "
     "unpiped; the aggregate: the widest group)"),
    ("pipe_ticks", int, "Pipeline schedule ticks (stage-unit rounds)"),
    ("pipe_bubble_fraction", (float, None), "Idle stage-ticks / (ticks x "
     "stages), the aggregate weighted by each group's stage-ticks; null "
     "before the first pipeline tick or when unpiped"),
    ("pipe_handoffs", int, "Stage-to-stage activation hand-offs"),
    ("pipe_handoff_host_fallbacks", int, "Hand-offs re-staged through the "
     "host after a pipe.handoff fault (contained; the tokens unchanged)"),
)
# One pipeline stage's share of a group's paged pool in ``GET /memory/``'s
# ``stage_pools`` (the JAX package's ``StagePoolEntry``).
STAGE_POOL_FIELDS = (
    ("stage", int, "Stage index (0-based, in layer order)"),
    ("kv_layers", int, "Attention layers whose K/V pools the stage holds"),
    ("pool_pages", int, "Logical pool pages the stage sees (= "
     "pool_pages_total)"),
    ("kv_pool_bytes", int, "Pool bytes of the stage's layers (values + "
     "int8 scales); the stages sum to kv_values + kv_scales"),
)

# ``GET /serving_stats/``'s replica-router and disaggregation fields (the
# JAX package's ``EngineStats`` and ``ServingStatsResponse`` fields of the
# same names): (name, kind, description).  serve/openapi.py documents the
# route's response with them.
SERVING_STATS_ENGINE_FIELDS = (
    ("replica", int, "Replica index within the model's router group "
     "(PENROZ_SCHED_REPLICAS; 0 for a standalone engine)"),
    ("mesh_devices", int, "Devices in the engine's serving mesh (always 1: "
     "PENROZ_SERVE_MESH is not ported)"),
    ("role", str, "Disaggregated-prefill role (PENROZ_DISAGG_PREFILL=1): "
     "'prefill' replicas prefill and hand the KV pages off, 'decode' "
     "replicas import them and decode; 'decode' when disaggregation is "
     "off"),
    ("disagg_exports", int, "Finished prefills handed to a decode replica "
     "(prefill replicas)"),
    ("disagg_imports", int, "Hand-offs imported and admitted straight into "
     "the decode phase (decode replicas)"),
    ("disagg_handoff_failures", int, "Hand-offs that fell back (a host "
     "re-send or a monolithic prefill; the request still completes)"),
    ("disagg_handoff_ms_p50", (float, None), "Median prefill-complete to "
     "decode-replica first token per hand-off, ms"),
    ("disagg_handoff_ms_p99", (float, None), "p99 hand-off latency, ms"),
    ("disagg_transport", str, "Hand-off transport in effect "
     "(PENROZ_DISAGG_TRANSPORT): 'd2d' device planes, 'host' a staged shm "
     "page blob"),
    ("disagg_role_changes", int, "Elastic role flips the engine applied "
     "(PENROZ_DISAGG_ELASTIC=1)"),
    *_PIPE_FIELDS,
    ("pipe_microblocks", int, "Micro-blocks the mixed batch splits into "
     "a pipeline tick (PENROZ_SERVE_PIPE_BLOCKS, >= stages; 0 = unpiped)"),
    ("pipe_stage_busy", dict, "Stage-units each stage ran, by stage "
     "index"),
    ("prefill_max_chunks_between_steps", int, "Most prefill chunks one "
     "phased step boundary ran while rows decoded "
     "(PENROZ_SCHED_MAX_STALL_MS)"),
    ("ssm_rows", int, "In-flight rows carrying recurrent (SSM) state: "
     "nonzero only when the served model has ssm layers"),
    ("ssm_state_bytes", int, "Device bytes of the engine's recurrent "
     "state (states and the rollback checkpoint ring): constant whatever "
     "the rows' lengths"),
    ("tick_timeline", list, "Recent ticks, newest first: dispatch_ms, "
     "occupancy, prefill_chunks, verify_rows, shared_rows, emitted, "
     "superstep, unified (False on the phased ticks), prefill_rows, "
     "decode_rows, pipe_ticks (pipeline schedule ticks this tick ran) "
     "and pipe_bubbles (idle stage-ticks among them)"),
)
SERVING_STATS_FIELDS = (
    ("router_replicas", int, "Live engine replicas owned by routers (0: "
     "no router, the single-engine registry)"),
    ("router_affinity_hits", int, "Fingerprinted admissions steered to "
     "the replica whose prefix cache holds the prompt's pages"),
    ("router_affinity_misses", int, "Fingerprinted admissions placed "
     "anywhere else"),
    ("router_affinity_hit_rate", (float, None), "hits / (hits + misses); "
     "null before any fingerprinted admission"),
    ("router_failovers", int, "Admissions rerouted past a refusing replica "
     "(breaker open, queue full, draining)"),
    ("disagg_prefill_replicas", int, "Live prefill-only replicas across "
     "routers (0: disaggregation off)"),
    ("disagg_exports", int, "Hand-off exports across engines"),
    ("disagg_imports", int, "Hand-off imports across engines"),
    ("disagg_handoff_failures", int, "Hand-offs that fell back, across "
     "engines"),
    ("disagg_handoff_ms_p50", (float, None), "Median hand-off latency "
     "across engines (merged histogram buckets), ms"),
    ("disagg_handoff_ms_p99", (float, None), "p99 hand-off latency across "
     "engines, ms"),
    ("disagg_transport", str, "Hand-off transport in effect"),
    ("disagg_role_changes", int, "Elastic role flips applied across "
     "engines"),
    ("ssm_rows", int, "In-flight rows carrying recurrent (SSM) state, "
     "across engines"),
    ("ssm_state_bytes", int, "Device bytes of recurrent state across "
     "engines"),
    *_PIPE_FIELDS,
)
