"""REST API service on the standard library's ``http.server`` (counterpart
of penroz_tpu/serve/app.py, serving slice; the machine with the card has no
aiohttp).

Routes: ``POST /model/``, ``POST /generate/`` (JSON, or ``stream: true``
with one token per line), ``POST /decode/``, ``POST /tokenize/``,
``DELETE /model/?model_id=…`` and ``GET /healthz``.  Errors map as in the
JAX service: unknown model 404, missing or mistyped field 422, bad value
400, anything else 500 with ``{"detail": "Please refer to server logs"}``.

Each request runs in its own thread; a generate request loads the model's
checkpoint onto the server's device, as the JAX service does per request.

Run: ``python -m penroz_tpu_torch.serve.app [--device cpu] [--port 8000]``.
"""

from __future__ import annotations

import argparse
import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from penroz_tpu_torch.data.tokenizers import Tokenizer
from penroz_tpu_torch.device import resolve_device
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve import schemas

log = logging.getLogger(__name__)


class _HTTPError(Exception):
    def __init__(self, status: int, detail):
        super().__init__(detail)
        self.status = status
        self.detail = detail


class PenrozServer(ThreadingHTTPServer):
    """HTTP server bound to one device (``cuda`` unless told ``cpu``)."""

    daemon_threads = True

    def __init__(self, address, device=None):
        self.device = resolve_device(device)
        super().__init__(address, _Handler)


class _Handler(BaseHTTPRequestHandler):
    server: PenrozServer

    def log_message(self, fmt, *args):
        log.info("%s - %s", self.address_string(), fmt % args)

    # -- plumbing -----------------------------------------------------------

    def _send_json(self, status: int, content):
        body = json.dumps(content).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

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

    def do_DELETE(self):
        self._dispatch(_DELETE)

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

    def generate(self, query):
        body = self._body(schemas.GenerateRequest)
        if body.adapter_id is not None:
            raise ValueError("LoRA adapters are not ported to "
                             "penroz_tpu_torch yet")
        log.info("Generating tokens using model %s", body.model_id)
        model = NeuralNetworkModel.deserialize(body.model_id,
                                               device=self.server.device)
        args = (body.input, body.block_size, body.max_new_tokens,
                body.temperature, body.top_k, body.stop_token)
        if not body.stream:
            self._send_json(200, {"tokens": model.generate_tokens(*args)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/plain; charset=utf-8")
        self.send_header("Connection", "close")
        self.end_headers()
        try:
            for token in model.generate_tokens_stream(*args):
                self.wfile.write(f"{token}\n".encode())
                self.wfile.flush()
        except Exception:  # noqa: BLE001 — headers went out: end the stream
            log.exception("Streaming generation failed for model %s",
                          body.model_id)
        self.close_connection = True

    def decode(self, query):
        body = self._body(schemas.DecodeTokensRequest)
        text = Tokenizer(body.encoding).decode(body.tokens)
        self._send_json(200, {"encoding": body.encoding, "text": text})

    def tokenize(self, query):
        body = self._body(schemas.TokenizeTextRequest)
        tokens = Tokenizer(body.encoding).tokenize(body.text)
        self._send_json(200, {"encoding": body.encoding, "tokens": tokens})

    def delete_model(self, query):
        model_id = query.get("model_id", [None])[0]
        if model_id is None:
            raise _HTTPError(422, "Missing query parameter model_id")
        log.info("Requesting deletion of model %s", model_id)
        NeuralNetworkModel.delete(model_id)
        self.send_response(204)
        self.end_headers()

    def healthz(self, query):
        self._send_json(200, {"status": "ok"})


_GET = {"/healthz": _Handler.healthz}
_POST = {"/model/": _Handler.create_model, "/generate/": _Handler.generate,
         "/decode/": _Handler.decode, "/tokenize/": _Handler.tokenize}
_DELETE = {"/model/": _Handler.delete_model}


def create_app(device=None, host: str = "127.0.0.1",
               port: int = 0) -> PenrozServer:
    """A bound, not yet serving, server on ``device`` (``cuda`` unless
    ``"cpu"``); ``port=0`` picks a free port (``server.server_address``).
    Call ``serve_forever()`` (e.g. in a thread) and ``shutdown()``."""
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
        server.server_close()


if __name__ == "__main__":  # pragma: no cover
    main()
