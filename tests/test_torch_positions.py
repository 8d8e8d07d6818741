"""Positions past a learned position table, route by route, on the toy GPT
DSL (a 16-row table) with the same weights in both packages.

The JAX package does not check: past the table its gather reads NaN, so it
answers with token 0 (generation) or NaN (``/output/``, ``/evaluate/``).
The port answers a 400 that names the table size, before any token: a
streamed ``/generate/`` gets the 400 too, not a 200 that ends early."""

import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt

PROMPT = [3, 17, 42, 8, 11]
TABLE = 16
TOO_LONG = 24


@pytest.fixture
def jmodel(workdir, monkeypatch, toy_gpt_layers, toy_optimizer, toy_shards):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    jm = JModel("pos", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    return jm


@pytest.fixture
def server(jmodel):
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield "http://%s:%d" % srv.server_address[:2]
    DS.reset()
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def _post(base, path, body):
    req = urllib.request.Request(base + path, data=json.dumps(body).encode(),
                                 method="POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _refused(status, text, what):
    assert status == 400, text
    detail = json.loads(text)["detail"]
    assert f"{what} exceeds the model's learned position table of " \
           f"{TABLE} positions" in detail, detail
    return detail


def _gen(**kw):
    return {"model_id": "pos", "input": [PROMPT], "block_size": TOO_LONG,
            "max_new_tokens": 30, "temperature": 0, **kw}


@pytest.mark.parametrize("stream", [False, True])
def test_generate_past_the_table(server, jmodel, stream):
    jax_tokens = jmodel.generate_tokens(PROMPT, TOO_LONG, 30, temperature=0)
    assert 0 in jax_tokens[TABLE:]  # NaN logits past the table: token 0
    _refused(*_post(server, "/generate/", _gen(stream=stream)),
             f"block_size {TOO_LONG}")
    # within the table both answer the same tokens
    status, text = _post(server, "/generate/", _gen(block_size=TABLE))
    assert status == 200
    assert json.loads(text)["tokens"] == jmodel.generate_tokens(
        PROMPT, TABLE, 30, temperature=0)


def test_generate_batch_past_the_table(server, jmodel, monkeypatch):
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    rows = jmodel.generate_tokens_batched([PROMPT, PROMPT[:2]], TOO_LONG,
                                          19, temperature=0)
    assert 0 in rows[0][TABLE + 1:]
    _refused(*_post(server, "/generate_batch/", {
        "model_id": "pos", "inputs": [PROMPT, PROMPT[:2]],
        "block_size": TOO_LONG, "max_new_tokens": 19, "temperature": 0}),
        f"block_size {TOO_LONG}")
    # a /generate/ under the scheduler is refused the same way
    _refused(*_post(server, "/generate/", _gen(max_new_tokens=12)),
             f"block_size {TOO_LONG}")


def test_evaluate_past_the_table(server, jmodel, toy_shards):
    body = {"model_id": "pos", "dataset_id": toy_shards, "shard": 0,
            "epochs": 1, "batch_size": 2, "block_size": TOO_LONG,
            "step_size": 1}
    args = (toy_shards, None, 0, 1, 2, TOO_LONG, 1)
    assert np.isnan(jmodel.evaluate_model(*args))
    _refused(*_post(server, "/evaluate/", body), f"block_size {TOO_LONG}")


def test_output_past_the_table(server, jmodel):
    tokens = [list(range(20))]
    output, _ = jmodel.compute_output(tokens)
    assert np.isnan(np.asarray(output)).all()
    detail = _refused(*_post(server, "/output/", {"model_id": "pos",
                                                  "input": tokens}),
                      "an input of length 20")
    assert "block_size" not in detail
    status, text = _post(server, "/output/", {"model_id": "pos",
                                              "input": [list(range(16))]})
    assert status == 200
    np.testing.assert_allclose(json.loads(text)["output"],
                               jmodel.compute_output([list(range(16))])[0],
                               atol=1e-5)
