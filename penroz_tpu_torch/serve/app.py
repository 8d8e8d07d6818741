"""REST API service on the standard library's ``http.server`` (counterpart
of penroz_tpu/serve/app.py, serving and training; the machine with the card
has no aiohttp).

Routes: ``POST /model/``, ``POST /generate/`` (JSON, or ``stream: true``
with one token per line), ``POST /generate_batch/``, ``POST /output/``
(the raw forward and its cost), ``POST /evaluate/`` (forward-only cost over
a dataset), ``POST /decode/``, ``POST /tokenize/``, ``PUT /train/``,
``POST /import/`` (a local HuggingFace checkpoint directory),
``GET /progress/?model_id=…``, ``GET /stats/?model_id=…`` (the training
diagnostics, ``null`` before any training; an MoE model's routing
fractions beside them), ``GET /serving_stats/``,
``DELETE /model/?model_id=…``, ``GET``/``POST``/``DELETE /dataset/``,
``POST /profile/`` and its alias ``POST /profiler/trace/`` (start or stop
a ``torch.profiler`` capture, utils/profiling.py), ``POST``/``GET``/
``DELETE /adapters/`` (LoRA adapters: create from a seed, list, one with
its training progress, delete; serve/adapters.py), ``GET /openapi.json``
and ``GET /docs`` (serve/openapi.py), ``GET /healthz`` (liveness, always
200) and ``GET /readyz`` (503 while an engine's circuit breaker is open,
a tick is stuck past ``PENROZ_TICK_WATCHDOG_MS`` or the server drains).

Observability (the JAX service's routes): ``GET /metrics`` (Prometheus
text, serve/metrics.py), ``GET /trace/`` (recent request traces,
``limit``) and ``GET /trace/{request_id}`` (one request's span tree,
``?format=chrome`` for trace-event JSON; utils/tracing.py),
``GET /memory/`` (the capacity ledger) and ``GET /debug/dump`` (the
flight recorder, serve/memledger.py), ``GET /tenants/`` and
``PUT /tenants/{tenant_id}/quota`` (token-rate quotas, serve/qos.py),
``GET /dashboard`` (``GET /`` redirects there) and ``GET /static/...``.
Sessions and streams (the JAX service's routes): ``GET /sessions/`` (the
hibernated sessions by tier, serve/tierstore.py), ``DELETE
/sessions/{session_id}`` (out of every tier; an unknown id is a 200 with
``deleted: false``) and ``GET /generate/{request_id}/stream?from_seq=N``
(reattach a streamed ``/generate/``: ``seq:value`` lines from ``N`` on,
404 for an unknown id, 410 behind the replay ring or past the detach
grace, 422 for a bad ``from_seq``; serve/streams.py).
Every response carries ``X-Request-Id`` (the client's own when it sent a
sane one), error bodies carry it as ``request_id``, and log records carry
it through :class:`~penroz_tpu_torch.utils.tracing.RequestIdFilter`.
Errors map as in the JAX service: unknown model 404,
missing or mistyped field 422, bad value 400 (a hub id on ``/import/``, a
``block_size`` or an input past the model's learned position table,
refused before any token), a model already training or importing, or a
dataset already downloading, 409, anything else 500 with
``{"detail": "Please refer to server logs"}``.

Each request runs in its own thread; a generate request loads the model's
checkpoint onto the server's device, as the JAX service does per request.
With ``PENROZ_CONTINUOUS_BATCHING=1`` eligible ``/generate/`` requests
and every ``/generate_batch/`` row go to the continuous-batching
scheduler instead (serve/decode_scheduler.py; unified ticks over the
paged pool, phased ticks over the contiguous cache or under
``PENROZ_RAGGED_ATTENTION=0``), whose engines keep their model loaded;
the others take the single-sequence path.  Without it,
``/generate_batch/`` is the legacy batched generation
(``generate_tokens_batched``: one right-padded prefill, then ragged
decode steps; rows with adapters in groups, one bound model each).  A
scheduler request sheds as in the JAX service: a full queue 429
and an open breaker 503, both with ``Retry-After``, an expired deadline
(``timeout_ms``, ``PENROZ_REQ_TIMEOUT_MS``) 504, or on a stream the line
``timeout`` after the tokens so far; under ``PENROZ_SCHED_FALLBACK=1`` an
open breaker sends ``/generate/`` to the single-sequence path and
``/generate_batch/`` to the legacy batched one.  An
``adapter_id`` on ``/generate/`` (``adapter_ids`` per row, or
``adapter_id``, on ``/generate_batch/``) pins the adapter in the registry
for the request: the scheduler mixes it with other adapters and base rows
in one batch, the single-sequence path serves a bound copy of the model
through its decode runner; an unknown adapter is a 400 naming it (every
bad one with its rows on ``/generate_batch/``), one still loading for
another request a 409.  ``DELETE /model/`` deletes the model's adapters
too.  A ``session_id`` on ``/generate/`` (``session_ids`` per row on
``/generate_batch/``, a malformed one a 400 naming its rows) hibernates
the request's KV at retirement; a later prompt that extends it wakes it.
A streamed ``/generate/`` whose client goes away keeps decoding for
``PENROZ_STREAM_DETACH_MS`` (0, the default, cancels it at once).  With
``PENROZ_JOURNAL_PATH`` set, quota overrides, adapter registrations and
the disk tier's sessions are journaled (serve/journal.py), and
:func:`create_app` replays the journal before the socket binds.
Scheduler features that are not ported are refused with a 400 naming
them.  ``shutdown()`` drains: admission stops, the rows in flight
get ``PENROZ_DRAIN_S`` (default 5 s) to finish, and every engine's worker
thread is joined.
``PUT /train/`` answers 202 and trains on a background thread, holding one
lock per model; ``/progress/`` reads the checkpoint's metadata, which
training rewrites at its start, every 10 s and at its end.  With an
``adapter`` (validated before the 202) it trains that LoRA adapter's
factors against the frozen model, under the model's lock, and the
adapter's status and progress are ``GET /adapters/?adapter_id=``'s.
``POST /dataset/`` answers 202 and downloads on a background thread, one
per dataset, retrying ``PENROZ_DOWNLOAD_RETRIES`` times (default 3) with
a backoff of ``PENROZ_DOWNLOAD_BACKOFF_S`` (default 1.0) doubling; its
state (``downloading``, then ``complete`` or ``failed`` with the error)
is ``GET /dataset/``'s ``download``.  The source is the ``datasets``
module: where it is missing, or cannot reach its source, the download
ends ``failed``.

Run: ``python -m penroz_tpu_torch.serve.app [--device cpu] [--port 8000]``.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import mimetypes
import os
import queue
import re
import threading
import time
import types
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, unquote, urlsplit

import torch

from penroz_tpu_torch.data.loaders import Downloader, Loader
from penroz_tpu_torch.data.tokenizers import Tokenizer
from penroz_tpu_torch.device import resolve_device
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import (NeuralNetworkModel,
                                           unported_attention_options,
                                           unported_training_options,
                                           validate_batch_generation)
from penroz_tpu_torch.models import lora
from penroz_tpu_torch.models.model import CompiledArch
from penroz_tpu_torch.parallel import dist
from penroz_tpu_torch.serve import adapters
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import (journal, memledger, openapi, qos,
                                    schemas, streams, tierstore)
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.utils import checkpoint, profiling, tracing

log = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
STATIC_DIR = os.path.join(_HERE, "static")
TEMPLATES_DIR = os.path.join(_HERE, "templates")


class _HTTPError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(detail)
        self.status = status
        self.detail = detail


def _refuse_unported():
    """ValueError (HTTP 400) naming the first scheduler or attention knob
    in the environment of a serving feature that is not ported."""
    unported_attention_options()
    DS.unported_serving_options()


_SESSION_ID_RE = re.compile(schemas.SESSION_ID_PATTERN)


def _batch_session_ids(body, n: int) -> list:
    """The rows' session ids of /generate_batch/ (``session_ids``, null: no
    session), each held to ``GenerateRequest.session_id``'s pattern (it
    names a disk-tier blob file); ValueError (400) for the whole batch
    otherwise, as in the JAX service."""
    if body.session_ids is None:
        return [None] * n
    if len(body.session_ids) != n:
        raise ValueError(
            f"session_ids has {len(body.session_ids)} entries for "
            f"{n} input row(s); pass one per row (null = no session)")
    bad = [i for i, sid in enumerate(body.session_ids)
           if sid is not None and not _SESSION_ID_RE.match(sid)]
    if bad:
        raise ValueError(
            "batched generation rejected: invalid session_id at row(s) "
            + ", ".join(str(i) for i in bad[:8])
            + " (allowed: [A-Za-z0-9._-]{1,120})")
    return list(body.session_ids)


def _stream_disconnect(stream, req):
    """A streaming client went away (a write failed): detach for the grace
    ``PENROZ_STREAM_DETACH_MS`` gives, let a finished stream's ring linger
    for a late reconnect, else cancel the request."""
    if stream.try_detach():
        return
    if stream.terminal:
        stream.release()
        return
    req.cancelled = True
    streams.STREAMS.discard(stream.request_id)


class PenrozServer(ThreadingHTTPServer):
    """HTTP server bound to one device (``cuda`` unless told ``cpu``)."""

    daemon_threads = True

    def __init__(self, address, device=None):
        self.device = resolve_device(device)
        self._guard = threading.Lock()
        self._train_locks: dict[str, threading.Lock] = {}
        self._jobs: list[threading.Thread] = []  # training, downloads
        # Each dataset's last download this process (GET /dataset/'s
        # "download"; "downloading" holds off another): under _guard.
        self.download_status: dict[str, dict] = {}
        super().__init__(address, _Handler)

    def try_lock(self, model_id: str):
        """The model's operation lock, acquired, or None while training or
        an import holds it."""
        with self._guard:
            lock = self._train_locks.setdefault(model_id, threading.Lock())
        return lock if lock.acquire(blocking=False) else None

    def start_training(self, model_id: str, args: tuple) -> bool:
        """Train ``model_id`` on a background thread unless it is already
        training or importing (then False)."""
        lock = self.try_lock(model_id)
        if lock is None:
            return False
        self._start(threading.Thread(target=_train_job,
                                     args=(lock, model_id, args),
                                     name=f"train-{model_id}", daemon=True))
        return True

    def _start(self, thread: threading.Thread):
        with self._guard:
            self._jobs = [t for t in self._jobs if t.is_alive()]
            self._jobs.append(thread)
        thread.start()

    def start_download(self, dataset_id: str, downloader: Downloader,
                       source: tuple) -> bool:
        """Download ``dataset_id`` on a background thread unless it is
        already downloading (then False)."""
        with self._guard:
            status = self.download_status.get(dataset_id)
            if status is not None and status["state"] == "downloading":
                return False
            self.download_status[dataset_id] = {
                "state": "downloading", "attempts": 0, "error": None}
        self._start(threading.Thread(
            target=self._download_job, args=(dataset_id, downloader, source),
            name=f"download-{dataset_id}", daemon=True))
        return True

    def _download_job(self, dataset_id, downloader, source):
        """Up to ``PENROZ_DOWNLOAD_RETRIES`` attempts with a doubling
        backoff, ending ``complete`` or ``failed`` with the last error."""
        attempts = max(1, int(os.environ.get("PENROZ_DOWNLOAD_RETRIES",
                                             "3")))
        backoff_s = float(os.environ.get("PENROZ_DOWNLOAD_BACKOFF_S", "1.0"))
        for attempt in range(1, attempts + 1):
            self._set_download(dataset_id, attempts=attempt)
            try:
                downloader.download(*source)
            except Exception as e:  # noqa: BLE001 — reported to clients
                log.exception("Dataset %s download attempt %d/%d failed",
                              dataset_id, attempt, attempts)
                self._set_download(dataset_id,
                                   error=f"{type(e).__name__}: {e}")
                if attempt < attempts:
                    time.sleep(backoff_s * 2 ** (attempt - 1))
            else:
                self._set_download(dataset_id, state="complete", error=None)
                return
        self._set_download(dataset_id, state="failed")
        log.error("Dataset %s download failed terminally after %d "
                  "attempt(s)", dataset_id, attempts)

    def _set_download(self, dataset_id: str, **fields):
        with self._guard:
            self.download_status[dataset_id] = {
                **self.download_status[dataset_id], **fields}

    def shutdown(self):
        """Stop serving, then drain the scheduler (``PENROZ_DRAIN_S``) and
        join every engine's worker thread; a thread that does not join is
        logged."""
        super().shutdown()
        if not DS.drain_and_shutdown():
            log.error("A decode engine's worker thread did not join")

    def join_training(self, timeout: float = None) -> bool:
        """Wait for the training and download threads; True when none is
        left."""
        with self._guard:
            threads = list(self._jobs)
        for t in threads:
            t.join(timeout)
        return not any(t.is_alive() for t in threads)


def _train_job(lock: threading.Lock, model_id: str, args: tuple):
    adapter = args[-1]
    try:
        NeuralNetworkModel.train_model_on_device(model_id, *args)
    except Exception:  # noqa: BLE001 — recorded in the checkpoint status
        log.exception("Training failed for model %s", model_id)
    else:
        log.info("Training completed for model %s", model_id)
    finally:
        if adapter is not None:
            # the registry's entry holds the factors from before the run:
            # the next request reloads them under a new uid (and prefix
            # namespace)
            adapters.REGISTRY.invalidate(adapter["adapter_id"])
        lock.release()


class _Handler(BaseHTTPRequestHandler):
    server: PenrozServer
    request_id = None
    path_params: dict = {}

    def log_message(self, fmt, *args):
        log.info("%s - %s", self.address_string(), fmt % args)

    # -- plumbing -----------------------------------------------------------

    def send_response(self, code, message=None):
        """Every response, errors, sheds and streams included, carries the
        request's ``X-Request-Id``."""
        super().send_response(code, message)
        if self.request_id is not None:
            self.send_header("X-Request-Id", self.request_id)

    def _send_json(self, status: int, content, headers=None):
        body = json.dumps(content).encode()
        self._send_body(status, "application/json", body, headers)

    def _send_body(self, status: int, content_type: str, body: bytes,
                   headers=None):
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def _send_shed(self, exc):
        """A scheduler shed as the JAX service answers it: a full queue
        429 and an open breaker 503, both with ``Retry-After`` (the queue's
        drain time, the remaining cooldown), an expired deadline 504."""
        retry = {"Retry-After": str(int(getattr(exc, "retry_after", 1)
                                        or 1))}
        if isinstance(exc, DS.QueueFullError):
            self._send_json(429, {"detail": f"Server overloaded: {exc}"},
                            retry)
        elif isinstance(exc, DS.TenantQuotaExceeded):
            self._send_json(429, {"detail": f"Tenant quota exceeded: {exc}"},
                            retry)
        elif isinstance(exc, DS.DeadlineExceeded):
            self._send_json(504, {"detail": f"Deadline exceeded: {exc}"})
        else:
            self._send_json(503, {"detail": f"Service unavailable: {exc}"},
                            retry)

    def _body(self, request_cls):
        length = int(self.headers.get("Content-Length") or 0)
        try:
            payload = json.loads(self.rfile.read(length) or b"null")
        except json.JSONDecodeError:
            raise _HTTPError(422, "Invalid JSON body")
        return request_cls.model_validate(payload)

    def _dispatch(self, routes: dict):
        """Route one request: an exact path first, then the templated
        ones (``{name}`` matches one path segment, bound into
        ``path_params``).  The request's id is bound into log records for
        the handler's duration; error bodies name it."""
        url = urlsplit(self.path)
        self.request_id = tracing.new_request_id(
            self.headers.get("X-Request-Id"))
        token = tracing.bind(self.request_id)
        rid = self.request_id
        try:
            handler, self.path_params = _match(routes, url.path)
            if handler is None:
                raise _HTTPError(404, f"No route {self.command} {url.path}")
            handler(self, parse_qs(url.query))
        except _HTTPError as e:
            self._send_json(e.status, {"detail": e.detail, "request_id": rid})
        except schemas.ValidationError as e:
            self._send_json(422, {"detail": e.errors, "request_id": rid})
        except KeyError as e:
            self._send_json(404, {"detail": f"Not found error occurred: {e}",
                                  "request_id": rid})
        except ValueError as e:
            self._send_json(400, {"detail": f"Value error occurred: {e}",
                                  "request_id": rid})
        except Exception:  # noqa: BLE001 — the server keeps serving
            log.exception("An error occurred on %s %s", self.command,
                          url.path)
            self._send_json(500, {"detail": "Please refer to server logs",
                                  "request_id": rid})
        finally:
            tracing.unbind(token)

    def do_GET(self):
        self._dispatch(_GET)

    def do_POST(self):
        self._dispatch(_POST)

    def do_PUT(self):
        self._dispatch(_PUT)

    def do_DELETE(self):
        self._dispatch(_DELETE)

    def _model_id(self, query) -> str:
        return self._query(query, "model_id")

    @staticmethod
    def _query(query, name: str) -> str:
        value = query.get(name, [None])[0]
        if value is None:
            raise _HTTPError(422, f"Missing query parameter {name}")
        return value

    # -- handlers -----------------------------------------------------------

    def create_model(self, query):
        body = self._body(schemas.CreateModelRequest)
        log.info("Requesting creation of model %s", body.model_id)
        model = NeuralNetworkModel(body.model_id,
                                   Mapper(body.layers, body.optimizer),
                                   device=self.server.device)
        model.serialize()
        self._send_json(200, {"message": f"Model {body.model_id} created "
                                         f"and saved successfully"})

    def _start_stream_response(self):
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()

    def _acquire_adapter(self, adapter_id: str, model_id: str):
        """Pin the adapter's registry entry (a load on a miss); 409 while
        another request loads it, 400 naming an unknown one."""
        try:
            return adapters.REGISTRY.acquire(adapter_id, model_id)
        except adapters.AdapterLoadingError as exc:
            raise _HTTPError(409, f"Conflict: {exc}")

    def _batch_adapters(self, body) -> list:
        """Per-row adapter entries of /generate_batch/ (``adapter_ids``
        over ``adapter_id``; None: the base model), all pinned, or one
        error naming every bad adapter and its rows (400 unknown, 409
        loading), with nothing left pinned."""
        n = len(body.inputs)
        if body.adapter_ids is not None:
            if len(body.adapter_ids) != n:
                raise ValueError(
                    f"adapter_ids has {len(body.adapter_ids)} entries for "
                    f"{n} input row(s); pass one per row (null = base "
                    f"model)")
            row_ids = list(body.adapter_ids)
        else:
            row_ids = [body.adapter_id] * n
        entries: dict = {}
        unknown, loading = [], []
        for aid in row_ids:
            if aid is None or aid in entries:
                continue
            try:
                entries[aid] = adapters.REGISTRY.acquire(aid, body.model_id)
            except adapters.AdapterLoadingError:
                loading.append(aid)
            except ValueError as exc:
                unknown.append((aid, str(exc)))

        def rows_for(aid):
            rows = [i for i, r in enumerate(row_ids) if r == aid]
            return ", ".join(f"row {i}" for i in rows[:8]) + (
                f" and {len(rows) - 8} more" if len(rows) > 8 else "")

        if unknown or loading:
            for entry in entries.values():
                adapters.REGISTRY.release(entry)
        if unknown:
            detail = "; ".join(f"adapter {aid!r} ({rows_for(aid)}): {msg}"
                               for aid, msg in unknown)
            raise ValueError(f"batched generation rejected: {detail}")
        if loading:
            detail = "; ".join(f"adapter {aid!r} ({rows_for(aid)}) is "
                               f"still loading" for aid in loading)
            raise _HTTPError(409, f"Conflict: {detail}; retry shortly")
        return [entries.get(aid) for aid in row_ids]

    def _try_scheduler_generate(self, body, adapter=None) -> bool:
        """Serve /generate/ through the continuous-batching scheduler when
        it is on and the request is eligible; False sends the request to
        the single-sequence path (also an open breaker's request under
        ``PENROZ_SCHED_FALLBACK=1``).  A shed answers with its own status
        line, a stream's too: the request is queued before the 200.  The
        request's trace (utils/tracing.py) is finished by the engine once
        queued, here on a shed."""
        if not DS.enabled():
            return False
        prompt = NeuralNetworkModel._prompt_tokens(body.input)
        if not DS.eligible(prompt, body.block_size, body.max_new_tokens):
            return False
        engine = DS.get_engine(body.model_id, body.block_size,
                               body.temperature, body.top_k,
                               device=self.server.device)
        if engine is None:  # registry at capacity with nothing evictable
            return False
        rid = self.request_id
        trace = tracing.maybe_trace(rid, route="/generate/",
                                    model_id=body.model_id,
                                    stream=bool(body.stream))
        fields = dict(request_id=rid, trace=trace, priority=body.priority,
                      tenant=body.tenant, adapter=adapter,
                      session_id=body.session_id)
        try:
            if not body.stream:
                tokens = DS.run_request(engine, prompt, body.max_new_tokens,
                                        body.stop_token,
                                        timeout_ms=body.timeout_ms,
                                        **fields)
                self._send_json(200, {"tokens": tokens})
                return True
            log.info("Streaming token generation for model %s via the "
                     "continuous-batching scheduler", body.model_id)
            req, events = DS.start_stream(engine, prompt,
                                          body.max_new_tokens,
                                          body.stop_token,
                                          timeout_ms=body.timeout_ms,
                                          **fields)
        except _SHED as exc:
            if trace is not None:
                trace.finish(_SHED_REASON[type(exc)])
            if (isinstance(exc, DS.CircuitOpenError)
                    and DS.fallback_enabled()):
                log.warning("Scheduler circuit open for model %s; falling "
                            "back to the single-sequence path",
                            body.model_id)
                return False
            self._send_shed(exc)
            return True
        except Exception:
            # a trace the engine never accepted is finished here; an
            # accepted one by the engine's own terminal path
            if trace is not None and not trace.owned:
                trace.finish("error")
            raise
        self._start_stream_response()
        self.close_connection = True
        try:
            while True:
                kind, value = DS.next_event(req, events)
                if kind == "token":
                    self.wfile.write(f"{value}\n".encode())
                    self.wfile.flush()
                elif kind == "done":
                    break
                elif kind == "timeout":
                    # the deadline passed mid-stream: the tokens so far went
                    # out; a last non-numeric line ends the stream honestly
                    self.wfile.write(b"timeout\n")
                    self.wfile.flush()
                    break
                else:
                    log.error("Scheduler stream for model %s failed: %r",
                              body.model_id, value)
                    break
        except OSError:
            # the client went away (a write failed): this thread stops
            # writing; the row decodes on into the replay ring for a
            # reconnect within the grace, or is cancelled
            _stream_disconnect(req.stream, req)
            return True
        req.stream.release()
        return True

    def resume_stream(self, query):
        """Reattach to a streamed ``/generate/`` (``GET
        /generate/{request_id}/stream?from_seq=N``): the events the
        request's replay ring holds from sequence number ``N`` on, then
        the live ones, exactly once across the seam (serve/streams.py).
        Lines are ``seq:value`` (a token, or the terminal ``done``,
        ``timeout`` or ``error``).  404 for an unknown or purged id, 410
        when ``N`` fell behind the ring or the detach grace expired, 422
        for a ``from_seq`` that is not an integer >= 0."""
        rid = unquote(self.path_params["request_id"])
        try:
            from_seq = int(query.get("from_seq", ["0"])[0])
        except ValueError:
            raise _HTTPError(422, "from_seq must be an integer")
        if from_seq < 0:
            raise _HTTPError(422, "from_seq must be >= 0")
        sess = streams.STREAMS.get(rid)
        if sess is None:
            raise KeyError(f"no resumable stream for request id {rid!r} "
                           f"(terminal streams linger briefly; expired or "
                           f"unknown ones do not)")
        events: queue.Queue = queue.Queue()
        try:
            backlog = sess.resume(events, from_seq)
        except streams.ReplayGapError as exc:
            self._send_json(410, {"detail": f"Gone: {exc}",
                                  "request_id": self.request_id})
            return
        log.info("Stream %s resumed at seq %d (%d ring event(s) to replay)",
                 rid, from_seq, len(backlog))
        self._start_stream_response()
        self.close_connection = True
        try:
            for seq, kind, value in backlog:
                self._write_seq(seq, kind, value)
                if kind in ("done", "timeout", "error"):
                    break
            else:
                while True:
                    seq, kind, value = events.get()
                    self._write_seq(seq, kind, value)
                    if kind in ("done", "timeout", "error"):
                        break
        except OSError:
            # the resumed client went away too: the same seam
            _stream_disconnect(sess, sess.req)
            return
        sess.release()

    def _write_seq(self, seq: int, kind: str, value):
        line = f"{seq}:{value}\n" if kind == "token" else f"{seq}:{kind}\n"
        self.wfile.write(line.encode())
        self.wfile.flush()

    def generate(self, query):
        body = self._body(schemas.GenerateRequest)
        _refuse_unported()
        entry = None
        if body.adapter_id:
            entry = self._acquire_adapter(body.adapter_id, body.model_id)
        try:
            self._generate_pinned(body, entry)
        finally:
            if entry is not None:
                adapters.REGISTRY.release(entry)

    def _generate_pinned(self, body, entry):
        if self._try_scheduler_generate(body, entry):
            return
        # the single-sequence path: a one-span trace, so that /trace/
        # answers for requests the scheduler did not serve
        trace = tracing.maybe_trace(self.request_id, route="/generate/",
                                    model_id=body.model_id, engine="legacy",
                                    stream=bool(body.stream))
        sp = trace.span("legacy_generate") if trace is not None else None
        try:
            self._generate_single(body, entry)
        except Exception:
            if trace is not None:
                trace.end(sp)
                trace.finish("error")
            raise
        if trace is not None:
            trace.end(sp)
            trace.finish("completed")

    def _generate_single(self, body, entry=None):
        log.info("Generating tokens using model %s%s", body.model_id,
                 f" (adapter {entry.adapter_id})" if entry else "")
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device,
                                               optimizer=False)
        if entry is not None:
            # the single-sequence path serves a bound copy: its decode
            # runner applies the factors (models/lora.py)
            model = lora.bind_model(model, entry.params, entry.config)
        args = (body.input, body.block_size, body.max_new_tokens,
                body.temperature, body.top_k, body.stop_token)
        if not body.stream:
            self._send_json(200, {"tokens": model.generate_tokens(*args)})
            return
        tokens = model.generate_tokens_stream(*args)  # refuses before 200
        self._start_stream_response()
        try:
            for token in tokens:
                self.wfile.write(f"{token}\n".encode())
                self.wfile.flush()
        except Exception:  # noqa: BLE001 — headers went out: end the stream
            log.exception("Streaming generation failed for model %s",
                          body.model_id)
        self.close_connection = True

    def generate_batch(self, query):
        """N prompts through the continuous-batching scheduler when it is
        on (the rows join the shared in-flight batch with any concurrent
        /generate/ traffic, and the batch answers once every row is done),
        else through the legacy batched generation
        (``generate_tokens_batched``), as the JAX service does."""
        body = self._body(schemas.GenerateBatchRequest)
        _refuse_unported()
        row_entries = self._batch_adapters(body)
        try:
            self._generate_batch_pinned(body, row_entries)
        finally:
            for entry in {id(e): e for e in row_entries
                          if e is not None}.values():
                adapters.REGISTRY.release(entry)

    def _generate_batch_pinned(self, body, row_entries):
        prompts = [list(row) for row in body.inputs]
        log.info("Batch-generating %d sequence(s) using model %s",
                 len(prompts), body.model_id)
        engine = None
        if DS.enabled() and body.max_new_tokens >= 1:
            # the whole batch is refused (400) before any row is submitted
            validate_batch_generation(prompts, body.block_size,
                                      body.max_new_tokens)
            engine = DS.get_engine(body.model_id, body.block_size,
                                   body.temperature, body.top_k,
                                   device=self.server.device)
        if engine is not None and self._scheduler_batch(body, prompts,
                                                         row_entries, engine):
            return
        self._send_json(200, {"sequences": self._legacy_batch(
            body, prompts, row_entries)})

    def _scheduler_batch(self, body, prompts, row_entries, engine) -> bool:
        """The rows through ``engine``; False hands the batch to the legacy
        path (an open breaker's shed under ``PENROZ_SCHED_FALLBACK=1``)."""
        sids = _batch_session_ids(body, len(prompts))
        # every row settles, then the batch answers as one: a shed row
        # (429 / 503 / 504) sheds the batch, as in the JAX service.  Each
        # row has a trace of its own, under the id ``<request id>-r<i>``.
        rid = self.request_id
        traces = [tracing.maybe_trace(f"{rid}-r{i}", route="/generate_batch/",
                                      model_id=body.model_id, row=i)
                  for i in range(len(prompts))]
        results = []
        for i, p in enumerate(prompts):
            try:
                results.append(DS.submit_request(
                    engine, p, body.max_new_tokens, body.stop_token,
                    timeout_ms=body.timeout_ms, request_id=f"{rid}-r{i}",
                    trace=traces[i], priority=body.priority,
                    tenant=body.tenant, adapter=row_entries[i],
                    session_id=sids[i]))
            except _SHED as exc:
                results.append(exc)
        for i, handle in enumerate(results):
            if not isinstance(handle, Exception):
                try:
                    results[i] = DS.collect(*handle)
                except Exception as exc:  # noqa: BLE001 — answered below
                    results[i] = exc
        for trace, res in zip(traces, results):
            if trace is not None and not trace.finished and not trace.owned:
                trace.finish(_SHED_REASON.get(type(res), "error")
                             if isinstance(res, Exception) else "completed")
        errors = [r for r in results if isinstance(r, Exception)]
        if not errors:
            self._send_json(200, {"sequences": results})
            return True
        shed = next((e for e in errors if isinstance(e, _SHED)), None)
        if shed is None:
            raise errors[0]
        if isinstance(shed, DS.CircuitOpenError) and DS.fallback_enabled():
            log.warning("Scheduler circuit open for model %s; the batch "
                        "falls back to the legacy path", body.model_id)
            return False
        self._send_shed(shed)
        return True

    def _legacy_batch(self, body, prompts, row_entries) -> list:
        """``generate_tokens_batched`` over the rows; with adapters the
        rows are grouped by adapter, each group through the model bound to
        it, the whole batch validated first (all or nothing)."""
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device,
                                               optimizer=False)
        validate_batch_generation(prompts, body.block_size,
                                  body.max_new_tokens)
        groups: dict = {}
        for i, entry in enumerate(row_entries):
            groups.setdefault(id(entry), (entry, []))[1].append(i)
        sequences: list = [None] * len(prompts)
        for entry, rows in groups.values():
            bound = (model if entry is None
                     else lora.bind_model(model, entry.params, entry.config))
            outs = bound.generate_tokens_batched(
                [prompts[i] for i in rows], body.block_size,
                body.max_new_tokens, body.temperature, body.top_k,
                body.stop_token)
            for i, seq in zip(rows, outs):
                sequences[i] = seq
        return sequences

    def output(self, query):
        body = self._body(schemas.OutputRequest)
        unported_attention_options()
        log.info("Requesting output for model %s", body.model_id)
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device,
                                               optimizer=False)
        output, cost = model.compute_output(body.input, body.target)
        self._send_json(200, {"output": output, "cost": cost})

    def evaluate(self, query):
        body = self._body(schemas.EvaluateRequest)
        unported_attention_options()
        log.info("Requesting evaluation of model %s", body.model_id)
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device,
                                               optimizer=False)
        cost = model.evaluate_model(body.dataset_id, body.target_dataset_id,
                                    body.shard, body.epochs, body.batch_size,
                                    body.block_size, body.step_size)
        self._send_json(200, {"cost": cost})

    def serving_stats(self, query):
        stats = DS.serving_stats()
        # the engines' raw bucket snapshots stay server-side, as the JAX
        # service's response schema drops them
        for engine in stats["engines"]:
            engine.pop("histograms", None)
        self._send_json(200, stats)

    def metrics(self, query):
        """Prometheus text exposition (format 0.0.4)."""
        self._send_body(200, serve_metrics.CONTENT_TYPE,
                        serve_metrics.render().encode())

    def trace_list(self, query):
        """Summaries of the completed ring (most recent first, ``limit``
        of them, clamped to 1-1000) and of the traces in flight."""
        try:
            limit = max(1, min(1000, int(query.get("limit", ["50"])[0])))
        except ValueError:
            raise _HTTPError(422, "limit must be an integer")
        self._send_json(200, {
            "traces": [t.summary() for t in tracing.completed(limit)],
            "live": [t.summary() for t in tracing.live()]})

    def trace_detail(self, query):
        """One request's span tree (in flight too); ``?format=chrome``
        gives Chrome trace-event JSON."""
        rid = self.path_params["request_id"]
        trace = tracing.get(rid)
        if trace is None:
            raise KeyError(f"no trace for request id {rid!r} (ring holds "
                           f"PENROZ_TRACE_BUFFER most recent)")
        fmt = query.get("format", ["json"])[0]
        if fmt == "chrome":
            self._send_json(200, trace.to_chrome())
        elif fmt == "json":
            self._send_json(200, trace.to_dict())
        else:
            raise _HTTPError(422, f"unknown format {fmt!r} (expected "
                                  f"'json' or 'chrome')")

    def memory(self, query):
        """The capacity ledger (serve/memledger.py)."""
        self._send_json(200, memledger.memory_stats())

    def debug_dump(self, query):
        """The flight recorder's ring of pre-crash snapshots, and what the
        last restart recovery replayed, dropped and swept (empty before
        any)."""
        self._send_json(200, dict(
            memledger.FLIGHT_RECORDER.dump(),
            restart_recovery=dict(tierstore.TIERS.last_recovery)))

    def list_tenants(self, query):
        """Quota state: overrides, tokens charged and sheds per tenant."""
        self._send_json(200, {"tenants": qos.QUOTAS.stats(),
                              "default_tokens_per_s": qos.QUOTAS.rate_for(
                                  None)})

    def put_tenant_quota(self, query):
        """A tenant's token-rate override (``tokens_per_s: null`` clears
        it, 0 blocks its new admissions) and, when the body has
        ``tier_mb``, its tier residency cap (null clears it).  The PUT is
        journaled: a restart's recovery replays it, the last one
        winning."""
        tenant_id = unquote(self.path_params["tenant_id"])
        body = self._body(schemas.TenantQuotaRequest)
        if body.tokens_per_s is not None and body.tokens_per_s < 0:
            raise ValueError("tokens_per_s must be >= 0 (or null to clear "
                             "the override)")
        qos.QUOTAS.set_rate(tenant_id, body.tokens_per_s)
        journal_fields = {"tenant": tenant_id, "rate": body.tokens_per_s}
        if "tier_mb" in body.model_fields_set:
            if body.tier_mb is not None and body.tier_mb < 0:
                raise ValueError("tier_mb must be >= 0 (or null to clear "
                                 "the override)")
            qos.QUOTAS.set_tier_mb(tenant_id, body.tier_mb)
            journal_fields["tier_mb"] = body.tier_mb
        journal.JOURNAL.append("quota", **journal_fields)
        log.info("Tenant %s quota %s", tenant_id,
                 "cleared (env default)" if body.tokens_per_s is None
                 else f"set to {body.tokens_per_s} tokens/s")
        self._send_json(200, {
            "tenant": tenant_id,
            "tokens_per_s": qos.QUOTAS.rate_for(tenant_id),
            "override": body.tokens_per_s is not None,
            "tier_bytes": qos.QUOTAS.tier_bytes_for(tenant_id)})

    def list_sessions(self, query):
        """The hibernated sessions in the tiers, across every engine and
        replica: tier, size and age of each."""
        sessions = tierstore.TIERS.list_sessions()
        self._send_json(200, {
            "sessions": sessions, "sessions_resident": len(sessions),
            "sessions_by_tier": tierstore.TIERS.sessions_by_tier(),
            "tier_bytes": tierstore.TIERS.tier_bytes()})

    def delete_session(self, query):
        """Evict one hibernated session from every tier; idempotent (a
        session that is not resident: ``deleted: false``)."""
        sid = unquote(self.path_params["session_id"])
        deleted = tierstore.TIERS.drop(sid, "api")
        log.info("Session %s %s", sid, "evicted from the KV tiers"
                 if deleted else "not resident")
        self._send_json(200, {"session_id": sid, "deleted": deleted})

    def redirect_to_dashboard(self, query):
        self.send_response(302)
        self.send_header("Location", "/dashboard")
        self.send_header("Content-Length", "0")
        self.end_headers()

    def dashboard(self, query):
        with open(os.path.join(TEMPLATES_DIR, "dashboard.html"), "rb") as f:
            self._send_body(200, "text/html; charset=utf-8", f.read())

    def static(self, query):
        """A file of serve/static/ (the dashboard's script and style)."""
        name = unquote(self.path_params["path"])
        path = os.path.join(STATIC_DIR, name)
        if (os.path.dirname(os.path.abspath(path)) != STATIC_DIR
                or not os.path.isfile(path)):
            raise _HTTPError(404, f"No static file {name!r}")
        ctype = mimetypes.guess_type(path)[0] or "application/octet-stream"
        if ctype.startswith("text/") or ctype.endswith("javascript"):
            ctype += "; charset=utf-8"
        with open(path, "rb") as f:
            self._send_body(200, ctype, f.read())

    def decode(self, query):
        body = self._body(schemas.DecodeTokensRequest)
        text = Tokenizer(body.encoding).decode(body.tokens)
        self._send_json(200, {"encoding": body.encoding, "text": text})

    def tokenize(self, query):
        body = self._body(schemas.TokenizeTextRequest)
        tokens = Tokenizer(body.encoding).tokenize(body.text)
        self._send_json(200, {"encoding": body.encoding, "tokens": tokens})

    def _device(self, name):
        """The request's device, or the server's when absent; a card this
        host lacks is a ValueError (HTTP 400)."""
        if name is None:
            return self.server.device
        try:
            return resolve_device(name)
        except RuntimeError as e:
            raise ValueError(str(e))

    def import_model(self, query):
        body = self._body(schemas.ImportModelRequest)
        log.info("Requesting import of HuggingFace model %s as %s",
                 body.hf_repo_id, body.model_id)
        device = self._device(body.device)
        lock = self.server.try_lock(body.model_id)
        if lock is None:
            raise _HTTPError(409, f"Operation already in progress for model "
                                  f"{body.model_id}.")
        try:
            NeuralNetworkModel.from_huggingface(
                body.model_id, body.hf_repo_id, body.revision, device=device)
        finally:
            lock.release()
        self._send_json(200, {
            "model_id": body.model_id, "status": "imported",
            "message": f"Model imported from HuggingFace ({body.hf_repo_id}) "
                       f"and ready for use"})

    def train(self, query):
        body = self._body(schemas.TrainingRequest)
        log.info("Requesting training for model %s on device %s",
                 body.model_id, body.device or self.server.device)
        device = self._device(body.device)
        unported_training_options()
        unported_attention_options()
        checkpoint.load(body.model_id, arrays=())  # unknown model: 404
        adapter_cfg = None
        if body.adapter is not None:
            # a bad adapter config is a 400 now, not an Error status later
            cfg = body.adapter
            adapter_cfg = lora.validate_config({
                "rank": cfg.rank, "alpha": cfg.alpha,
                "targets": cfg.targets})
            adapter_cfg["adapter_id"] = cfg.adapter_id
        # one lock a base model, for its adapters' runs too: an adapter
        # trains against the base weights a base run rewrites
        if not self.server.start_training(body.model_id, (
                device, body.dataset_id, body.shard, body.epochs,
                body.batch_size, body.block_size, body.step_size,
                adapter_cfg)):
            raise _HTTPError(409, f"Training already in progress for model "
                                  f"{body.model_id}.")
        what = (f"adapter {adapter_cfg['adapter_id']} on model "
                f"{body.model_id}" if adapter_cfg is not None
                else f"model {body.model_id}")
        self._send_json(202, {"message": f"Training for {what} started "
                                         f"asynchronously."})

    def progress(self, query):
        model_id = self._model_id(query)
        data = checkpoint.load(model_id, arrays=())
        self._send_json(200, {
            "progress": data.get("progress", []),
            "average_cost": data.get("avg_cost"),
            "average_cost_history": data.get("avg_cost_history", []),
            "status": data.get("status"),
        })

    def model_stats(self, query):
        """The ``/stats/`` document training refreshed (JAX
        ``model_stats``), read from the checkpoint's metadata.  Once it
        exists, an MoE model's per-expert routing fractions go beside it
        under ``moe_router_fractions`` (``{buffer key: [E floats]}``); of
        the checkpoint's arrays only those buffers are read."""
        model_id = self._model_id(query)
        log.info("Requesting stats for model %s", model_id)
        data = checkpoint.load(model_id,
                               arrays=(("buffers", "router_fraction"),))
        stats = data.get("stats")
        if stats is not None:
            routing = {name: [float(x) for x in buf.reshape(-1).tolist()]
                       for name, buf in (data.get("buffers") or {}).items()
                       if name.endswith("router_fraction")}
            if routing:
                stats = dict(stats, moe_router_fractions=routing)
        self._send_json(200, stats)

    def list_dataset(self, query):
        dataset_id = self._query(query, "dataset_id")
        log.info("Requesting list of files for dataset %s", dataset_id)
        with self.server._guard:
            status = self.server.download_status.get(dataset_id)
        self._send_json(200, {"files": Loader(dataset_id).list(),
                              "download": status})

    def download_dataset(self, query):
        body = self._body(schemas.DownloadDatasetRequest)
        log.info("Requesting download of dataset %s", body.dataset_id)
        downloader = Downloader(body.dataset_id, body.shard_size,
                                body.encoding)
        if not self.server.start_download(
                body.dataset_id, downloader,
                (body.path, body.name, body.split)):
            raise _HTTPError(409, f"Downloading dataset {body.dataset_id} "
                                  f"already in progress.")
        self._send_json(202, {"message": f"Downloading Dataset "
                                         f"{body.dataset_id} "
                                         f"asynchronously."})

    def delete_dataset(self, query):
        dataset_id = self._query(query, "dataset_id")
        log.info("Requesting deletion of dataset %s", dataset_id)
        Loader(dataset_id).delete()
        self.send_response(204)
        self.end_headers()

    def delete_model(self, query):
        model_id = self._model_id(query)
        log.info("Requesting deletion of model %s", model_id)
        # its adapters go first, cached and on disk: one never serves
        # without its base, and a blob left behind would come back under a
        # recreated model of the same id
        deleted = adapters.delete_model_adapters(model_id)
        if deleted:
            log.info("Deleted %d adapter(s) of model %s: %s", len(deleted),
                     model_id, ", ".join(deleted))
        NeuralNetworkModel.delete(model_id)
        self.send_response(204)
        self.end_headers()

    # -- LoRA adapters (serve/adapters.py, models/lora.py) -----------------

    def create_adapter(self, query):
        body = self._body(schemas.CreateAdapterRequest)
        log.info("Requesting creation of adapter %s for model %s",
                 body.adapter_id, body.model_id)
        if body.init not in ("zeros", "random"):
            raise ValueError(f"init must be 'zeros' or 'random', "
                             f"got {body.init!r}")
        try:
            checkpoint.peek_adapter_tree(body.adapter_id)
            raise _HTTPError(409, f"Adapter {body.adapter_id} already "
                                  f"exists.")
        except KeyError:
            pass
        # the factors' shapes come from the model's layers: no weights read
        layers = checkpoint.load(body.model_id, arrays=())["layers"]
        with torch.device("meta"):
            arch = CompiledArch(layers)
        model = types.SimpleNamespace(arch=arch, model_id=body.model_id)
        blob = lora.create_adapter(
            body.adapter_id, model,
            {"rank": body.rank, "alpha": body.alpha,
             "targets": body.targets}, seed=body.seed, init=body.init)
        # the factors are durable as a checkpoint already; the record lets
        # a restart's recovery account for every registered adapter
        journal.JOURNAL.append("adapter", adapter_id=body.adapter_id,
                               model_id=body.model_id)
        self._send_json(200, {
            "adapter_id": body.adapter_id, "model_id": body.model_id,
            "config": blob["config"],
            "message": f"Adapter {body.adapter_id} created for model "
                       f"{body.model_id}"})

    def list_adapters(self, query):
        """Every adapter (``{"adapters": [...]}``), or one with its
        training progress when ``adapter_id`` is given (404 unknown)."""
        adapter_id = query.get("adapter_id", [None])[0]
        if adapter_id is not None:
            self._send_json(200, adapters.adapter_detail(adapter_id))
            return
        self._send_json(200, {"adapters": adapters.list_adapters()})

    def delete_adapter(self, query):
        adapter_id = self._query(query, "adapter_id")
        log.info("Requesting deletion of adapter %s", adapter_id)
        checkpoint.peek_adapter_tree(adapter_id)   # unknown: 404
        adapters.REGISTRY.invalidate(adapter_id)
        checkpoint.delete_adapter(adapter_id)
        self.send_response(204)
        self.end_headers()

    def healthz(self, query):
        """Liveness: always 200; an open breaker is a readiness matter."""
        self._send_json(200, {"status": "ok"})

    def readyz(self, query):
        """Readiness: 503 while an engine's breaker is open, a tick is
        stuck past the watchdog, or the server drains.  A replica group
        (``PENROZ_SCHED_REPLICAS`` > 1) is unready only when EVERY replica
        is: one healthy replica keeps the model ready, as the router fails
        admissions over to it."""
        breaker_open = DS.breaker_open_engines()
        stuck = DS.stuck_engines()
        draining = DS.draining()
        ready = not breaker_open and not stuck and not draining
        self._send_json(200 if ready else 503, {
            "ready": ready, "draining": draining,
            "breaker_open_engines": breaker_open, "stuck_engines": stuck})

    def profile(self, query):
        """Start or stop a ``torch.profiler`` capture; 409 on a second
        start or an idle stop."""
        body = self._body(schemas.ProfileRequest)
        if body.action == "start":
            if not profiling.start(body.log_dir):
                raise _HTTPError(409, "A profile capture is already "
                                      "running.")
            self._send_json(200, {"message": f"Profiling started into "
                                             f"{body.log_dir}"})
        elif body.action == "stop":
            log_dir = profiling.stop()
            if log_dir is None:
                raise _HTTPError(409, "No profile capture is running.")
            self._send_json(200, {"message": f"Profiling stopped; trace in "
                                             f"{log_dir}"})
        else:
            raise ValueError(f"Unknown profile action {body.action!r}")

    def openapi_json(self, query):
        self._send_body(200, "application/json", openapi.spec_json().encode())

    def docs(self, query):
        self._send_body(200, "text/html; charset=utf-8",
                        openapi.docs_html().encode())


# the scheduler's sheds, and the retire_reason each gives a trace
_SHED_REASON = {DS.QueueFullError: "queue_full",
                DS.CircuitOpenError: "breaker_open",
                DS.DeadlineExceeded: "timeout",
                DS.TenantQuotaExceeded: "quota"}
_SHED = tuple(_SHED_REASON)

# Route tables by method: a key is an exact path or a template whose
# ``{name}`` parts match one path segment each (:func:`_match`).
_GET = {"/": _Handler.redirect_to_dashboard,
        "/dashboard": _Handler.dashboard,
        "/static/{path}": _Handler.static,
        "/healthz": _Handler.healthz, "/readyz": _Handler.readyz,
        "/metrics": _Handler.metrics,
        "/trace/": _Handler.trace_list,
        "/trace/{request_id}": _Handler.trace_detail,
        "/openapi.json": _Handler.openapi_json, "/docs": _Handler.docs,
        "/progress/": _Handler.progress,
        "/stats/": _Handler.model_stats,
        "/serving_stats/": _Handler.serving_stats,
        "/memory/": _Handler.memory,
        "/debug/dump": _Handler.debug_dump,
        "/tenants/": _Handler.list_tenants,
        "/sessions/": _Handler.list_sessions,
        "/generate/{request_id}/stream": _Handler.resume_stream,
        "/dataset/": _Handler.list_dataset,
        "/adapters/": _Handler.list_adapters}
_POST = {"/model/": _Handler.create_model, "/generate/": _Handler.generate,
         "/generate_batch/": _Handler.generate_batch,
         "/output/": _Handler.output, "/evaluate/": _Handler.evaluate,
         "/import/": _Handler.import_model,
         "/dataset/": _Handler.download_dataset,
         "/decode/": _Handler.decode, "/tokenize/": _Handler.tokenize,
         "/profile/": _Handler.profile,
         "/profiler/trace/": _Handler.profile,
         "/adapters/": _Handler.create_adapter}
_PUT = {"/train/": _Handler.train,
        "/tenants/{tenant_id}/quota": _Handler.put_tenant_quota}
_DELETE = {"/model/": _Handler.delete_model,
           "/dataset/": _Handler.delete_dataset,
           "/adapters/": _Handler.delete_adapter,
           "/sessions/{session_id}": _Handler.delete_session}


@functools.lru_cache(maxsize=None)
def _template_re(template: str):
    return re.compile("^" + re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)",
                                   re.escape(template)) + "$")


def _match(routes: dict, path: str):
    """``(handler, path parameters)`` of ``path`` in ``routes``, or
    ``(None, {})``."""
    handler = routes.get(path)
    if handler is not None:
        return handler, {}
    for template, fn in routes.items():
        m = "{" in template and _template_re(template).match(path)
        if m:
            return fn, m.groupdict()
    return None, {}


def _sweep_orphaned_training():
    """Mark a checkpoint whose status still says ``Training`` as ``Error``
    at server start (the JAX package's sweep, with its message): training
    runs in this process or in a worker this process owns, so when the
    server starts none can be running, and such a status was left by a
    restart or a crash mid-run.  Each check reads the header alone and
    each repair rewrites it alone (``checkpoint.patch_meta``); a failure
    is logged and never blocks the start."""
    for model_id in checkpoint.list_model_ids():
        try:
            if checkpoint.peek_tree(model_id).get(
                    "status", {}).get("code") != "Training":
                continue
            checkpoint.patch_meta(model_id, {"status": {
                "code": "Error",
                "message": "Training interrupted by server restart"}})
            log.warning("Marked orphaned training as Error: %s", model_id)
        except Exception:  # noqa: BLE001 — the sweep never blocks startup
            log.exception("Orphan sweep failed for model %s", model_id)


def create_app(device=None, host: str = "127.0.0.1",
               port: int = 0) -> PenrozServer:
    """A bound, not yet serving, server on ``device`` (``cuda`` unless
    ``"cpu"``); ``port=0`` picks a free port (``server.server_address``).
    Call ``serve_forever()`` (e.g. in a thread) and ``shutdown()``.
    ``PENROZ_PROFILER_PORT`` (the JAX package's live profiler server) is a
    ValueError.  Before the socket binds, a checkpoint left at
    ``Training`` by a crash is marked ``Error``
    (:func:`_sweep_orphaned_training`: a client retrying ``/train/`` at
    once cannot race it), then the journal's restart recovery
    (``tierstore.TIERS.recover()``) runs, so the first ``GET /sessions/``
    lists every session that survived."""
    profiling.unported_options()
    _sweep_orphaned_training()
    tierstore.TIERS.recover()
    return PenrozServer((host, port), device=device)


def _configure_logging():
    """``logging.config.dictConfig`` from the JSON file
    ``PENROZ_LOG_CONFIG`` names, as the JAX service does; without it, or
    when the file is missing (a warning on stderr), a basicConfig whose
    lines carry the request id."""
    import logging.config
    import sys
    config_path = os.environ.get("PENROZ_LOG_CONFIG")
    if config_path and os.path.exists(config_path):
        with open(config_path) as f:
            logging.config.dictConfig(json.load(f))
        return
    if config_path:
        print(f"WARNING: PENROZ_LOG_CONFIG={config_path!r} does not exist; "
              "falling back to basicConfig", file=sys.stderr)
    handler = logging.StreamHandler()
    handler.addFilter(tracing.RequestIdFilter())
    logging.basicConfig(
        level=logging.INFO, handlers=[handler],
        format="%(asctime)s %(levelname)s [%(request_id)s] %(name)s: "
               "%(message)s")


def main(argv=None):
    """Serve until interrupted.  ``HOST`` and ``PORT`` in the environment
    are the defaults of ``--host`` and ``--port`` (127.0.0.1:8000 without
    them), as for the JAX service."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--host", default=os.environ.get("HOST",
                                                         "127.0.0.1"))
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", "8000")))
    args = parser.parse_args(argv)
    _configure_logging()
    # over several ranks (torchrun's environment) every rank serves and
    # gets every /train/ and /evaluate/ request
    dist.initialize()
    server = create_app(args.device, args.host, args.port)
    log.info("Serving on %s:%d (%s)", *server.server_address[:2],
             server.device)
    try:
        server.serve_forever()
    finally:
        server.shutdown()   # returns at once: serve_forever has ended
        server.server_close()
        server.join_training()


if __name__ == "__main__":  # pragma: no cover
    main()
