"""The port's HTTP service on the CPU: /model/ → /generate/ (greedy tokens
equal to the JAX package's on the same weights), streaming, /decode/,
/tokenize/, error statuses and DELETE."""

import json
import threading
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.serve import schemas
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture
def server(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _gen(model_id, **kw):
    body = {"model_id": model_id, "input": [[1, 2, 3, 4, 5]],
            "block_size": 16, "max_new_tokens": 25, "temperature": 0}
    body.update(kw)
    return body


def test_generate_matches_jax_on_shared_checkpoint(server, toy_gpt_layers,
                                                   toy_optimizer):
    jm = JModel("shared", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    expected = jm.generate_tokens([1, 2, 3, 4, 5], 16, 25, temperature=0)
    status, text = _call(server, "POST", "/generate/", _gen("shared"))
    assert status == 200
    assert json.loads(text)["tokens"] == expected
    status, text = _call(server, "POST", "/generate/",
                         _gen("shared", stream=True))
    assert status == 200
    assert [int(t) for t in text.split()] == expected[5:]


def test_model_lifecycle_and_errors(server, toy_gpt_layers, toy_optimizer):
    assert _call(server, "GET", "/healthz")[0] == 200
    status, text = _call(server, "POST", "/model/",
                         {"model_id": "m", "layers": toy_gpt_layers,
                          "optimizer": toy_optimizer})
    assert status == 200, text
    status, text = _call(server, "POST", "/generate/", _gen("m"))
    tokens = json.loads(text)["tokens"]
    assert status == 200 and len(tokens) == 30
    assert _call(server, "POST", "/generate/", _gen("m"))[1] == text
    # unknown model 404, missing field 422, wrong type 422, bad value 400
    assert _call(server, "POST", "/generate/", _gen("nope"))[0] == 404
    body = _gen("m")
    del body["block_size"]
    status, text = _call(server, "POST", "/generate/", body)
    assert status == 422 and "block_size" in text
    assert _call(server, "POST", "/generate/",
                 _gen("m", max_new_tokens="many"))[0] == 422
    assert _call(server, "POST", "/model/",
                 {"model_id": "x", "layers": toy_gpt_layers,
                  "optimizer": {"lion": {}}})[0] == 400
    assert _call(server, "POST", "/decode/",
                 {"encoding": "tiktoken/gpt2", "tokens": [1]})[0] == 400
    assert _call(server, "POST", "/model/",
                 {"model_id": "y", "layers": [{"linear": {"bogus": 1}}],
                  "optimizer": toy_optimizer})[0] == 500
    assert _call(server, "DELETE", "/model/?model_id=m")[0] == 204
    assert _call(server, "POST", "/generate/", _gen("m"))[0] == 404
    assert _call(server, "DELETE", "/model/")[0] == 422


def test_tokenize_decode_round_trip(server):
    status, text = _call(server, "POST", "/tokenize/",
                         {"encoding": "byte", "text": "héllo"})
    tokens = json.loads(text)["tokens"]
    assert status == 200 and tokens[-1] == 256
    status, text = _call(server, "POST", "/decode/",
                         {"encoding": "byte", "tokens": tokens})
    assert status == 200 and json.loads(text)["text"] == "héllo"


@pytest.mark.parametrize("payload,error", [
    ({"model_id": "m", "input": [1], "block_size": 8.0,
      "max_new_tokens": 2}, None),                       # integral float ok
    ({"model_id": "m", "input": [1], "block_size": 8,
      "max_new_tokens": 2, "top_k": None, "temperature": 0}, None),
    ({"model_id": "m", "input": [1], "block_size": True,
      "max_new_tokens": 2}, "block_size"),               # bool is not int
    ({"model_id": "m", "input": [1], "block_size": 8.5,
      "max_new_tokens": 2}, "block_size"),
    ({"model_id": "m", "input": "1", "block_size": 8,
      "max_new_tokens": 2}, "input"),
    ({"model_id": "m", "input": [1], "block_size": 8,
      "max_new_tokens": 2, "stream": None}, "stream"),   # not nullable
    ([1, 2], "body"),
])
def test_generate_request_validation(payload, error):
    if error is None:
        req = schemas.GenerateRequest.model_validate(payload)
        assert isinstance(req.block_size, int) and req.stream is False
        assert isinstance(req.temperature, float)
        return
    with pytest.raises(schemas.ValidationError) as info:
        schemas.GenerateRequest.model_validate(payload)
    assert info.value.errors[0]["loc"] == [error]
