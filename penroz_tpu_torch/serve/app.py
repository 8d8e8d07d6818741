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
a ``torch.profiler`` capture, utils/profiling.py), ``GET /openapi.json``
and ``GET /docs`` (serve/openapi.py), ``GET /healthz`` (liveness, always
200) and ``GET /readyz`` (503 while an engine's circuit breaker is open,
a tick is stuck past ``PENROZ_TICK_WATCHDOG_MS`` or the server drains).
Errors map as in the JAX service: unknown model 404,
missing or mistyped field 422, bad value 400 (a hub id on ``/import/``, a
``block_size`` or an input past the model's learned position table,
refused before any token), a model already training or importing, or a
dataset already downloading, 409, anything else 500 with
``{"detail": "Please refer to server logs"}``.

Each request runs in its own thread; a generate request loads the model's
checkpoint onto the server's device, as the JAX service does per request.
With ``PENROZ_CONTINUOUS_BATCHING=1`` (and ``PAGED_KV_CACHE=1``) eligible
``/generate/`` requests and every ``/generate_batch/`` row go to the
continuous-batching scheduler instead (serve/decode_scheduler.py), whose
engines keep their model loaded; the others take the single-sequence
path.  A scheduler request sheds as in the JAX service: a full queue 429
and an open breaker 503, both with ``Retry-After``, an expired deadline
(``timeout_ms``, ``PENROZ_REQ_TIMEOUT_MS``) 504, or on a stream the line
``timeout`` after the tokens so far; under ``PENROZ_SCHED_FALLBACK=1`` an
open breaker sends ``/generate/`` to the single-sequence path.  Scheduler
features and request fields that are not ported are refused with a 400
naming them.  ``shutdown()`` drains: admission stops, the rows in flight
get ``PENROZ_DRAIN_S`` (default 5 s) to finish, and every engine's worker
thread is joined.
``PUT /train/`` answers 202 and trains on a background thread, holding one
lock per model; ``/progress/`` reads the checkpoint's metadata, which
training rewrites at its start, every 10 s and at its end.
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
import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from penroz_tpu_torch.data.loaders import Downloader, Loader
from penroz_tpu_torch.data.tokenizers import Tokenizer
from penroz_tpu_torch.device import resolve_device
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import (NeuralNetworkModel,
                                           unported_attention_options,
                                           unported_training_options,
                                           validate_batch_generation)
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import openapi, schemas
from penroz_tpu_torch.utils import checkpoint, profiling

log = logging.getLogger(__name__)


class _HTTPError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(detail)
        self.status = status
        self.detail = detail


# Request fields of JAX-package serving features the port does not have.
_UNPORTED_FIELDS = {
    "adapter_id": "LoRA adapters",
    "adapter_ids": "LoRA adapters",
    "priority": "QoS priority classes",
    "tenant": "tenant quotas",
    "session_id": "KV session hibernation",
    "session_ids": "KV session hibernation",
}


def _refuse_unported(body):
    """ValueError (HTTP 400) naming the first set field, or scheduler or
    attention knob in the environment, of a serving feature that is not
    ported."""
    unported_attention_options()
    for name in body.UNPORTED:
        if getattr(body, name) is not None:
            raise ValueError(f"the request field {name!r} selects "
                             f"{_UNPORTED_FIELDS[name]}, which "
                             f"penroz_tpu_torch does not support yet")
    DS.unported_serving_options()


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
    try:
        NeuralNetworkModel.train_model_on_device(model_id, *args)
    except Exception:  # noqa: BLE001 — recorded in the checkpoint status
        log.exception("Training failed for model %s", model_id)
    else:
        log.info("Training completed for model %s", model_id)
    finally:
        lock.release()


class _Handler(BaseHTTPRequestHandler):
    server: PenrozServer

    def log_message(self, fmt, *args):
        log.info("%s - %s", self.address_string(), fmt % args)

    # -- plumbing -----------------------------------------------------------

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
        url = urlsplit(self.path)
        handler = routes.get(url.path)
        try:
            if handler is None:
                raise _HTTPError(404, f"No route {self.command} {url.path}")
            handler(self, parse_qs(url.query))
        except _HTTPError as e:
            self._send_json(e.status, {"detail": e.detail})
        except schemas.ValidationError as e:
            self._send_json(422, {"detail": e.errors})
        except KeyError as e:
            self._send_json(404, {"detail": f"Not found error occurred: {e}"})
        except ValueError as e:
            self._send_json(400, {"detail": f"Value error occurred: {e}"})
        except Exception:  # noqa: BLE001 — the server keeps serving
            log.exception("An error occurred on %s %s", self.command,
                          url.path)
            self._send_json(500, {"detail": "Please refer to server logs"})

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

    def _try_scheduler_generate(self, body) -> bool:
        """Serve /generate/ through the continuous-batching scheduler when
        it is on and the request is eligible; False sends the request to
        the single-sequence path (also an open breaker's request under
        ``PENROZ_SCHED_FALLBACK=1``).  A shed answers with its own status
        line, a stream's too: the request is queued before the 200."""
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
        try:
            if not body.stream:
                tokens = DS.run_request(engine, prompt, body.max_new_tokens,
                                        body.stop_token,
                                        timeout_ms=body.timeout_ms)
                self._send_json(200, {"tokens": tokens})
                return True
            log.info("Streaming token generation for model %s via the "
                     "continuous-batching scheduler", body.model_id)
            req, events = DS.start_stream(engine, prompt,
                                          body.max_new_tokens,
                                          body.stop_token,
                                          timeout_ms=body.timeout_ms)
        except DS.CircuitOpenError as exc:
            if DS.fallback_enabled():
                log.warning("Scheduler circuit open for model %s; falling "
                            "back to the single-sequence path",
                            body.model_id)
                return False
            self._send_shed(exc)
            return True
        except (DS.QueueFullError, DS.DeadlineExceeded) as exc:
            self._send_shed(exc)
            return True
        self._start_stream_response()
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
        except OSError:  # the client went away: free the row
            req.cancelled = True
        self.close_connection = True
        return True

    def generate(self, query):
        body = self._body(schemas.GenerateRequest)
        _refuse_unported(body)
        if self._try_scheduler_generate(body):
            return
        log.info("Generating tokens using model %s", body.model_id)
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device,
                                               optimizer=False)
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
        """N prompts through the continuous-batching scheduler: the rows
        join the shared in-flight batch (with any concurrent /generate/
        traffic) and the batch answers once every row is done."""
        body = self._body(schemas.GenerateBatchRequest)
        _refuse_unported(body)
        if not DS.enabled():
            raise ValueError(
                f"/generate_batch/ without {DS.ENABLE_ENV}=1 selects the "
                f"legacy batched generation (generate_tokens_batched), "
                f"which penroz_tpu_torch does not support yet")
        prompts = [list(row) for row in body.inputs]
        validate_batch_generation(prompts, body.block_size,
                                  body.max_new_tokens)
        log.info("Batch-generating %d sequence(s) using model %s",
                 len(prompts), body.model_id)
        if body.max_new_tokens < 1:
            self._send_json(200, {"sequences": prompts})
            return
        engine = DS.get_engine(body.model_id, body.block_size,
                               body.temperature, body.top_k,
                               device=self.server.device)
        if engine is None:
            raise _HTTPError(503, "every decode engine is busy; retry")
        # every row settles, then the batch answers as one: a shed row
        # (429 / 503 / 504) sheds the batch, as in the JAX service
        results = []
        for p in prompts:
            try:
                results.append(DS.start_stream(
                    engine, p, body.max_new_tokens, body.stop_token,
                    timeout_ms=body.timeout_ms))
            except (DS.QueueFullError, DS.CircuitOpenError) as exc:
                results.append(exc)
        for i, handle in enumerate(results):
            if not isinstance(handle, Exception):
                try:
                    results[i] = DS.collect(*handle)
                except Exception as exc:  # noqa: BLE001 — answered below
                    results[i] = exc
        errors = [r for r in results if isinstance(r, Exception)]
        if not errors:
            self._send_json(200, {"sequences": results})
            return
        shed = next((e for e in errors if isinstance(e, _SHED)), None)
        if shed is None:
            raise errors[0]
        # an open breaker sheds the batch under PENROZ_SCHED_FALLBACK=1
        # too: the legacy batched path it would take is not ported
        self._send_shed(shed)

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
        self._send_json(200, DS.serving_stats())

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
        if body.adapter is not None:
            raise ValueError("LoRA adapter training is not ported to "
                             "penroz_tpu_torch yet")
        device = self._device(body.device)
        unported_training_options()
        unported_attention_options()
        checkpoint.load(body.model_id, arrays=())  # unknown model: 404
        if not self.server.start_training(body.model_id, (
                device, body.dataset_id, body.shard, body.epochs,
                body.batch_size, body.block_size, body.step_size)):
            raise _HTTPError(409, f"Training already in progress for model "
                                  f"{body.model_id}.")
        self._send_json(202, {"message": f"Training for model "
                                         f"{body.model_id} started "
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
        NeuralNetworkModel.delete(model_id)
        self.send_response(204)
        self.end_headers()

    def healthz(self, query):
        """Liveness: always 200; an open breaker is a readiness matter."""
        self._send_json(200, {"status": "ok"})

    def readyz(self, query):
        """Readiness: 503 while an engine's breaker is open, a tick is
        stuck past the watchdog, or the server drains."""
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


_SHED = (DS.QueueFullError, DS.CircuitOpenError, DS.DeadlineExceeded)

_GET = {"/healthz": _Handler.healthz, "/readyz": _Handler.readyz,
        "/openapi.json": _Handler.openapi_json, "/docs": _Handler.docs,
        "/progress/": _Handler.progress,
        "/stats/": _Handler.model_stats,
        "/serving_stats/": _Handler.serving_stats,
        "/dataset/": _Handler.list_dataset}
_POST = {"/model/": _Handler.create_model, "/generate/": _Handler.generate,
         "/generate_batch/": _Handler.generate_batch,
         "/output/": _Handler.output, "/evaluate/": _Handler.evaluate,
         "/import/": _Handler.import_model,
         "/dataset/": _Handler.download_dataset,
         "/decode/": _Handler.decode, "/tokenize/": _Handler.tokenize,
         "/profile/": _Handler.profile,
         "/profiler/trace/": _Handler.profile}
_PUT = {"/train/": _Handler.train}
_DELETE = {"/model/": _Handler.delete_model,
           "/dataset/": _Handler.delete_dataset}


def create_app(device=None, host: str = "127.0.0.1",
               port: int = 0) -> PenrozServer:
    """A bound, not yet serving, server on ``device`` (``cuda`` unless
    ``"cpu"``); ``port=0`` picks a free port (``server.server_address``).
    Call ``serve_forever()`` (e.g. in a thread) and ``shutdown()``.
    ``PENROZ_PROFILER_PORT`` (the JAX package's live profiler server) is a
    ValueError."""
    profiling.unported_options()
    return PenrozServer((host, port), device=device)


def main(argv=None):  # pragma: no cover
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="'cuda' (default) or 'cpu'")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
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
