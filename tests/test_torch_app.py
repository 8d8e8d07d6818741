"""The port's HTTP service on the CPU: /model/ → /generate/ (greedy tokens
equal to the JAX package's on the same weights), streaming, /decode/,
/tokenize/, error statuses and DELETE; PUT /train/ (202, 409, 404, 400,
422) and GET /progress/ until Trained or Error."""

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
    assert srv.join_training(timeout=60)


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


def _train_body(model_id, **kw):
    body = {"model_id": model_id, "dataset_id": "toy", "shard": 0,
            "epochs": 3, "batch_size": 2, "block_size": 16, "step_size": 1,
            "device": "cpu"}
    body.update(kw)
    return body


def _poll_progress(base, model_id, until, timeout=60.0):
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, text = _call(base, "GET", f"/progress/?model_id={model_id}")
        assert status == 200, text
        body = json.loads(text)
        if body["status"]["code"] in until:
            return body
        time.sleep(0.05)
    raise AssertionError(f"{model_id} never reached {until}: {body}")


def test_train_202_409_progress(server, toy_gpt_layers, toy_optimizer,
                                toy_shards, monkeypatch):
    """PUT /train/ answers 202 and trains in the background; a second PUT
    while it runs is a 409; /progress/ reaches Trained with one entry per
    epoch.  The run is held at its start by an event so the 409 is not a
    race; the training itself is the real one."""
    from penroz_tpu_torch.models import model as tmodel
    release = threading.Event()
    real = tmodel.NeuralNetworkModel.train_model

    def held(self, *args, **kwargs):
        assert release.wait(30)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(tmodel.NeuralNetworkModel, "train_model", held)
    assert _call(server, "POST", "/model/",
                 {"model_id": "tr", "layers": toy_gpt_layers,
                  "optimizer": toy_optimizer})[0] == 200
    status, text = _call(server, "PUT", "/train/", _train_body("tr"))
    assert status == 202, text
    status, text = _call(server, "PUT", "/train/", _train_body("tr"))
    assert status == 409 and "already in progress" in text
    release.set()
    body = _poll_progress(server, "tr", {"Trained", "Error"})
    assert body["status"]["code"] == "Trained", body
    assert [p["epoch"] for p in body["progress"]] == [1, 2, 3]
    assert body["average_cost"] is not None
    assert len(body["average_cost_history"]) == 1
    # the model trains again once the first run is over
    status, _ = _call(server, "PUT", "/train/", _train_body("tr", epochs=1))
    assert status == 202
    assert _poll_progress(server, "tr", {"Trained", "Error"}, )[
        "status"]["code"] == "Trained"


def test_train_errors(server, toy_gpt_layers, toy_optimizer, monkeypatch):
    assert _call(server, "POST", "/model/",
                 {"model_id": "e", "layers": toy_gpt_layers,
                  "optimizer": toy_optimizer})[0] == 200
    assert _call(server, "PUT", "/train/", _train_body("nope"))[0] == 404
    status, text = _call(server, "PUT", "/train/", _train_body(
        "e", adapter={"adapter_id": "a", "rank": 4}))
    assert status == 400 and "LoRA" in text
    assert _call(server, "PUT", "/train/",
                 _train_body("e", device="tpuu"))[0] == 400
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert _call(server, "PUT", "/train/",
                 _train_body("e", device="cuda"))[0] == 400
    body = _train_body("e")
    del body["epochs"]
    status, text = _call(server, "PUT", "/train/", body)
    assert status == 422 and "epochs" in text
    monkeypatch.setenv("PENROZ_TRAIN_WORKER", "1")
    assert _call(server, "PUT", "/train/", _train_body("e"))[0] == 400
    monkeypatch.delenv("PENROZ_TRAIN_WORKER")
    assert _call(server, "GET", "/progress/?model_id=nope")[0] == 404
    assert _call(server, "GET", "/progress/")[0] == 422
    # a missing dataset fails in the background: status Error
    status, _ = _call(server, "PUT", "/train/",
                      _train_body("e", dataset_id="missing"))
    assert status == 202
    body = _poll_progress(server, "e", {"Error"})
    assert "no shards" in body["status"]["message"]
