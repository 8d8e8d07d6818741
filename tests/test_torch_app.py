"""The port's HTTP service on the CPU: /model/ → /generate/ (greedy tokens
equal to the JAX package's on the same weights), streaming, /decode/,
/tokenize/, error statuses and DELETE; PUT /train/ (202, 409, 404, 400,
422) and GET /progress/ until Trained or Error; /output/ and /evaluate/
of a hybrid attention/SSM model (the JAX package's numbers on a shared
checkpoint, and their error statuses); POST /import/ of a local
HuggingFace checkpoint → /generate/, its 409 and error statuses, and
imports loading across the two packages."""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.serve import schemas
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture
def app(workdir, monkeypatch):
    """The serving server object; torn down (training threads and
    checkpoint flushes joined) before the test's cwd is restored."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert srv.join_training(timeout=60)
    tckpt.join_flushes()


@pytest.fixture
def server(app):
    host, port = app.server_address[:2]
    return f"http://{host}:{port}"


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


def _poll_progress(base, model_id, until, timeout=60.0, runs=0):
    """Poll /progress/ until the status is in ``until`` and the average-cost
    history holds at least ``runs`` finished runs (a run's end appends
    one; until a new run rewrites the checkpoint, it reads the previous
    run's terminal status)."""
    import time
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, text = _call(base, "GET", f"/progress/?model_id={model_id}")
        assert status == 200, text
        body = json.loads(text)
        if (body["status"]["code"] in until
                and len(body["average_cost_history"]) >= runs):
            return body
        time.sleep(0.05)
    raise AssertionError(f"{model_id} never reached {until}: {body}")


def test_train_202_409_progress(server, app, toy_gpt_layers, toy_optimizer,
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
    # the model trains again once the first run is over: its thread holds
    # the model's training lock a moment after the checkpoint reads Trained
    assert app.join_training(timeout=60)
    status, _ = _call(server, "PUT", "/train/", _train_body("tr", epochs=1))
    assert status == 202
    body = _poll_progress(server, "tr", {"Trained", "Error"}, runs=2)
    assert body["status"]["code"] == "Trained", body
    assert [p["epoch"] for p in body["progress"]] == [1]


def test_train_errors(app, server, toy_gpt_layers, toy_optimizer,
                      monkeypatch, toy_shards):
    assert _call(server, "POST", "/model/",
                 {"model_id": "e", "layers": toy_gpt_layers,
                  "optimizer": toy_optimizer})[0] == 200
    assert _call(server, "PUT", "/train/", _train_body("nope"))[0] == 404
    # an adapter config is validated before the 202: a rank past
    # PENROZ_LORA_MAX_RANK is a 400 naming it, a missing adapter_id a 422
    status, text = _call(server, "PUT", "/train/", _train_body(
        "e", adapter={"adapter_id": "a", "rank": 4096}))
    assert status == 400 and "rank 4096" in text
    status, text = _call(server, "PUT", "/train/", _train_body(
        "e", adapter={"rank": 4}))
    assert status == 422 and "adapter_id" in text
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
    # the training worker process: a 202, and the child's run ends Trained
    monkeypatch.setenv("PENROZ_TRAIN_WORKER", "1")
    assert _call(server, "PUT", "/train/",
                 _train_body("e", epochs=2))[0] == 202
    body = _poll_progress(server, "e", {"Trained", "Error"}, runs=1)
    assert body["status"]["code"] == "Trained", body
    assert [p["epoch"] for p in body["progress"]] == [1, 2]
    assert app.join_training(timeout=60)
    monkeypatch.delenv("PENROZ_TRAIN_WORKER")
    assert _call(server, "GET", "/progress/?model_id=nope")[0] == 404
    assert _call(server, "GET", "/progress/")[0] == 422
    # a missing dataset fails in the background: status Error
    status, _ = _call(server, "PUT", "/train/",
                      _train_body("e", dataset_id="missing"))
    assert status == 202
    body = _poll_progress(server, "e", {"Error"})
    assert "no shards" in body["status"]["message"]


# -- paged pool and continuous batching --------------------------------------

@pytest.fixture
def paged(monkeypatch):
    from penroz_tpu_torch.serve import decode_scheduler
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    yield
    decode_scheduler.reset()


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_paged_generate_matches_jax_past_block(server, paged, monkeypatch,
                                               toy_gpt_layers, toy_optimizer,
                                               int8):
    """Single-sequence /generate/ over the paged pool: 5 + 25 tokens run
    past the 16-token block (crop + re-prefill) with the JAX package's
    greedy tokens, streamed and not."""
    if int8:
        monkeypatch.setenv("TURBO_QUANT_KV_CACHE", "1")
    jm = JModel("paged", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    expected = jm.generate_tokens([1, 2, 3, 4, 5], 16, 25, temperature=0)
    status, text = _call(server, "POST", "/generate/", _gen("paged"))
    assert status == 200, text
    assert json.loads(text)["tokens"] == expected
    status, text = _call(server, "POST", "/generate/",
                         _gen("paged", stream=True))
    assert [int(t) for t in text.split()] == expected[5:]


def test_continuous_batching_matches_single_sequence(
        server, paged, monkeypatch, toy_gpt_layers, toy_optimizer):
    """Three concurrent /generate/ requests (one streamed) and a
    /generate_batch/ of the same prompts share the scheduler's engine and
    return the single-sequence tokens; /serving_stats/ reports the
    unified ticks."""
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PENROZ_PREFILL_CHUNK", "2")
    jm = JModel("cb", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    prompts = [[1, 2, 3], [9, 8, 7, 6, 5], [4, 4, 4, 2, 2, 2, 1]]
    expected = [jm.generate_tokens([p], 16, 6, temperature=0)
                for p in prompts]
    results = [None] * 3

    def fire(i):
        body = _gen("cb", input=[prompts[i]], max_new_tokens=6,
                    stream=i == 1)
        results[i] = _call(server, "POST", "/generate/", body)

    threads = [threading.Thread(target=fire, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert all(r is not None and r[0] == 200 for r in results), results
    assert json.loads(results[0][1])["tokens"] == expected[0]
    assert [int(t) for t in results[1][1].split()] == expected[1][5:]
    assert json.loads(results[2][1])["tokens"] == expected[2]
    status, text = _call(server, "POST", "/generate_batch/", {
        "model_id": "cb", "inputs": prompts, "block_size": 16,
        "max_new_tokens": 6, "temperature": 0})
    assert status == 200, text
    assert json.loads(text)["sequences"] == expected
    status, text = _call(server, "GET", "/serving_stats/")
    assert status == 200
    stats = json.loads(text)
    for key in ("continuous_batching_enabled", "engines", "capacity",
                "active_rows", "queue_depth", "decode_tokens",
                "decode_steps", "dispatches_total", "tick_timeline"):
        assert key in stats, key
    assert stats["continuous_batching_enabled"] is True
    assert stats["capacity"] == 8 and stats["active_rows"] == 0
    # six rows of 6 tokens: the first of each comes from its prefill
    assert stats["decode_tokens"] == 6 * 5
    tick = stats["tick_timeline"][0]
    for key in ("unified", "prefill_rows", "decode_rows", "prefill_chunks",
                "emitted", "superstep", "dispatch_ms"):
        assert key in tick, key
    assert all(t["unified"] for t in stats["tick_timeline"])
    assert sum(t["emitted"] for t in stats["tick_timeline"]) == 36
    # an ineligible request (prompt + new tokens past the block) takes the
    # single-sequence paged path, crop and all
    status, text = _call(server, "POST", "/generate/", _gen("cb"))
    assert status == 200
    assert json.loads(text)["tokens"] == jm.generate_tokens(
        [1, 2, 3, 4, 5], 16, 25, temperature=0)
    assert _call(server, "POST", "/generate/",
                 _gen("nope", max_new_tokens=3))[0] == 404
    status, text = _call(server, "POST", "/generate_batch/", {
        "model_id": "cb", "inputs": [[1] * 12], "block_size": 16,
        "max_new_tokens": 6})
    assert status == 400 and "row 0" in text


@pytest.mark.parametrize("env,field", [
    ({"PENROZ_RAGGED_ATTENTION": "0"}, "served"),
    ({"PAGED_KV_CACHE": "0"}, "served"),
    ({"PENROZ_SERVE_MESH": "1"}, None),
    ({"PENROZ_SERVE_PIPE_STAGES": "2"}, "served"),
    # priority is ported: an unknown class is a 400 naming the field
    ({}, ("priority", "urgent")),
    ({}, ("adapter_id", "a1")),
    ({"PENROZ_CONTINUOUS_BATCHING": "0"}, "batch"),
    ({"PENROZ_PROFILER_PORT": "9012"}, "create_app"),
])
def test_unported_serving_options_400(server, paged, monkeypatch, env,
                                      field, toy_gpt_layers, toy_optimizer):
    """Each scheduler knob of a feature that is not ported is a 400 that
    names it, on /generate/ and /generate_batch/ (an unknown ``priority``
    class and an unknown adapter too); ``PENROZ_PROFILER_PORT``
    (jax.profiler's live server) is a ValueError (400) when the server is
    created.  The phased ticks (``PENROZ_RAGGED_ATTENTION=0``, the
    contiguous cache), pipeline serving and the legacy /generate_batch/
    (continuous batching off) are served: a 200 with the JAX package's
    tokens."""
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    if field == "create_app":
        with pytest.raises(ValueError, match="PENROZ_PROFILER_PORT"):
            create_app(device="cpu")
        return
    jm = JModel("ref", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    body = _gen("ref", max_new_tokens=3)
    batch = {"model_id": "ref", "inputs": [[1, 2]], "block_size": 16,
             "max_new_tokens": 3}
    if field in ("batch", "served"):
        want = jm.generate_tokens([1, 2, 3, 4, 5], 16, 3, temperature=0)
        if field == "served":
            status, text = _call(server, "POST", "/generate/", body)
            assert status == 200, text
            assert json.loads(text)["tokens"] == want
        status, text = _call(server, "POST", "/generate_batch/",
                             dict(batch, temperature=0))
        assert status == 200, text
        assert json.loads(text)["sequences"] == jm.generate_tokens_batched(
            [[1, 2]], 16, 3, temperature=0)
        return
    if field is not None:
        name, value = field
        body[name] = value
        batch[name] = value
        names = [next(iter(env))] if env else [name]
        if name == "adapter_id":
            # ported: an unknown adapter is a 400 naming the adapter, on
            # both routes, as in the JAX service
            names = [f"unknown adapter {value!r}"]
    else:
        names = [next(iter(env))]
    status, text = _call(server, "POST", "/generate/", body)
    assert status == 400 and names[0] in text, text
    status, text = _call(server, "POST", "/generate_batch/", batch)
    assert status == 400 and names[-1] in text, text


@pytest.mark.parametrize("case", [
    "PENROZ_STREAM_DETACH_MS", "PENROZ_STREAM_REPLAY", "PENROZ_JOURNAL_PATH",
    "PENROZ_TIER_HOST_MB", "PENROZ_TIER_DISK_MB", "PENROZ_QOS_TENANT_TIER_MB",
    "session_id", "session_ids"])
def test_session_and_stream_options_serve(server, paged, monkeypatch, case,
                                          toy_gpt_layers, toy_optimizer):
    """The session tiers', journal's and resumable streams' knobs and
    request fields serve (200, the JAX package's greedy tokens) and do
    what they do in the JAX package: the detach grace and the replay
    ring's capacity read as the JAX functions read them (a ring that holds
    the whole stream replays it), the journal records a hibernation in a
    file the JAX package replays, the host and disk caps place a session
    in their tier, the tenant tier quota caps the tenant's residency as
    the JAX quota manager computes it (refusing a session past it), and
    ``session_id`` / ``session_ids`` hibernate the requests' KV."""
    from penroz_tpu.serve import journal as jjournal
    from penroz_tpu.serve import qos as jqos
    from penroz_tpu.serve import streams as jstreams
    from penroz_tpu_torch.serve import journal, qos, streams, tierstore
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE", "1")
    env = {"PENROZ_STREAM_DETACH_MS": "500", "PENROZ_STREAM_REPLAY": "64",
           "PENROZ_JOURNAL_PATH": "journal.log",
           "PENROZ_TIER_HOST_MB": "64", "PENROZ_TIER_DISK_MB": "256",
           "PENROZ_QOS_TENANT_TIER_MB": "64"}
    if case in env:
        monkeypatch.setenv(case, env[case])
    if case == "PENROZ_TIER_DISK_MB":
        monkeypatch.setenv("PENROZ_TIER_HOST_MB", "0")
    jm = JModel("ref", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    want = jm.generate_tokens([1, 2, 3, 4, 5], 16, 3, temperature=0)
    body = _gen("ref", max_new_tokens=3, session_id="s1", tenant="t1")
    if case.startswith("PENROZ_STREAM"):
        body = dict(body, stream=True)
    for mod in (tierstore, journal, qos, streams):
        mod.reset()
    try:
        if case == "session_ids":
            status, text = _call(server, "POST", "/generate_batch/", {
                "model_id": "ref", "inputs": [[1, 2, 3, 4, 5]],
                "block_size": 16, "max_new_tokens": 3, "temperature": 0,
                "session_ids": ["s1"], "tenant": "t1"})
            assert status == 200 and json.loads(text)["sequences"] == [want]
        elif body.get("stream"):
            status, text = _call(server, "POST", "/generate/", body)
            assert status == 200
            assert [int(t) for t in text.split()] == want[5:]
        else:
            status, text = _call(server, "POST", "/generate/", body)
            assert status == 200 and json.loads(text)["tokens"] == want
        tier = {"PENROZ_TIER_DISK_MB": "disk"}.get(case, "host")
        deadline = time.monotonic() + 60
        while (tierstore.TIERS.get("s1") is None
               or tierstore.TIERS.get("s1").tier != tier):
            assert time.monotonic() < deadline, tierstore.TIERS.stats()
            time.sleep(0.01)
        assert tierstore.TIERS.get("s1").tenant == "t1"
        stats = json.loads(_call(server, "GET", "/serving_stats/")[1])
        assert stats["sessions_hibernated"] == 1
        if case == "PENROZ_STREAM_DETACH_MS":
            assert stats["streams"]["detach_grace_ms"] == \
                jstreams.detach_grace_ms() == 500.0
        elif case == "PENROZ_STREAM_REPLAY":
            assert stats["streams"]["replay_capacity"] == \
                jstreams.replay_capacity() == 64
            rid = next(iter(streams.STREAMS._sessions))
            status, text = _call(server, "GET",
                                 f"/generate/{rid}/stream?from_seq=0")
            assert status == 200
            assert [v for v in text.split()][-1] == "3:done"
        elif case == "PENROZ_JOURNAL_PATH":
            journal.JOURNAL.close()
            kinds = [r["t"] for r in jjournal.Journal().replay()]
            assert kinds[:2] == ["register", "demote"]
            assert journal.JOURNAL.stats()["appended"] == len(kinds)
        elif case == "PENROZ_QOS_TENANT_TIER_MB":
            assert qos.QUOTAS.tier_bytes_for("t1") == \
                jqos.QUOTAS.tier_bytes_for("t1") == 64e6
            monkeypatch.setenv(case, "0.000001")    # one byte
            _call(server, "POST", "/generate/", dict(body, session_id="s2"))
            assert tierstore.TIERS.get("s2") is None
            assert tierstore.TIERS.drops["quota_refused"] == 1
        assert stats["tier_demotions"][tier] == 1
    finally:
        for mod in (tierstore, journal, streams):
            mod.reset()


@pytest.mark.parametrize("route", ["generate", "generate_batch"])
@pytest.mark.parametrize("knob", ["PENROZ_PREFIX_CACHE",
                                  "PENROZ_SPEC_DECODE"])
def test_prefix_cache_and_spec_decode_serve(server, paged, monkeypatch,
                                            toy_gpt_layers, toy_optimizer,
                                            knob, route):
    """Under continuous batching the radix prefix cache and speculative
    decoding serve (200) the tokens the knob off gives, twice (a prefix
    hit the second time), on /generate/ (buffered and streamed) and
    /generate_batch/; /serving_stats/ shows the feature at work."""
    from penroz_tpu_torch.serve import decode_scheduler
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    monkeypatch.setenv("PENROZ_SPEC_NGRAM", "1")
    monkeypatch.setenv("PENROZ_SCHED_SUPERSTEP", "1")  # a draft a token
    jm = JModel("knob", JMapper(toy_gpt_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    prompts = [[1, 2, 3, 1, 2, 3, 1, 2], [1, 2, 3, 1, 2, 3, 1, 5, 9]]

    def serve():
        if route == "generate_batch":
            status, text = _call(server, "POST", "/generate_batch/", {
                "model_id": "knob", "inputs": prompts, "block_size": 16,
                "max_new_tokens": 6, "temperature": 0})
            assert status == 200, text
            return json.loads(text)["sequences"]
        out = []
        for i, p in enumerate(prompts):
            status, text = _call(server, "POST", "/generate/", _gen(
                "knob", input=[p], max_new_tokens=6, stream=i == 1))
            assert status == 200, text
            out.append(json.loads(text)["tokens"] if i == 0
                       else p + [int(t) for t in text.split()])
        return out

    off = serve()
    assert off == [jm.generate_tokens([p], 16, 6, temperature=0)
                   for p in prompts]
    decode_scheduler.reset()    # engines are sized when they are built
    monkeypatch.setenv(knob, "1")
    assert serve() == off
    assert serve() == off
    status, text = _call(server, "GET", "/serving_stats/")
    assert status == 200
    stats = json.loads(text)
    engine = next(e for e in stats["engines"] if e["prefix_cache"]
                  or e["spec_decode"])
    if knob == "PENROZ_PREFIX_CACHE":
        assert engine["prefix_cache"]["hits"] >= 2
        assert stats["prefix_cache_hit_rate"] > 0
        assert stats["spec_decode_enabled"] is False
    else:
        assert engine["spec_decode"] is True
        assert stats["spec_decode_enabled"] is True
        assert stats["spec_drafted_tokens"] > 0


@pytest.mark.parametrize("route", ["generate", "generate_batch", "output",
                                   "evaluate", "train"])
def test_disable_flash_400_on_attention_routes(server, paged, monkeypatch,
                                               toy_gpt_layers, toy_optimizer,
                                               toy_shards, route):
    """PENROZ_DISABLE_FLASH=1 selects the JAX package's plain attention
    path, which the port does not have: every route that runs attention
    answers 400 naming it; set to 0 the route serves as before."""
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    assert _call(server, "POST", "/model/",
                 {"model_id": "f", "layers": toy_gpt_layers,
                  "optimizer": toy_optimizer})[0] == 200
    method, path, body = {
        "generate": ("POST", "/generate/", _gen("f", max_new_tokens=3)),
        "generate_batch": ("POST", "/generate_batch/", {
            "model_id": "f", "inputs": [[1, 2]], "block_size": 16,
            "max_new_tokens": 3}),
        "output": ("POST", "/output/", {"model_id": "f",
                                        "input": [[1, 2, 3]]}),
        "evaluate": ("POST", "/evaluate/", {
            "model_id": "f", "dataset_id": toy_shards, "shard": 0,
            "epochs": 1, "batch_size": 2, "block_size": 16,
            "step_size": 1}),
        "train": ("PUT", "/train/", _train_body("f", epochs=1)),
    }[route]
    monkeypatch.setenv("PENROZ_DISABLE_FLASH", "1")
    status, text = _call(server, method, path, body)
    assert status == 400 and "PENROZ_DISABLE_FLASH" in text, text
    monkeypatch.setenv("PENROZ_DISABLE_FLASH", "0")
    status, text = _call(server, method, path, body)
    assert status in (200, 202), text
    if route == "train":
        _poll_progress(server, "f", {"Trained", "Error"})


# -- /output/ and /evaluate/ (hybrid attention/SSM model) --------------------

def test_output_and_evaluate_match_jax(server, toy_hybrid_layers,
                                       toy_optimizer, toy_shards):
    """/output/ and /evaluate/ of a hybrid model checkpointed by the JAX
    package answer the JAX package's numbers (atol 1e-5, rel 1e-5)."""
    jm = JModel("hyb", JMapper(toy_hybrid_layers, toy_optimizer))
    jm.serialize(sync_flush=True)
    x = [[1, 2, 3, 4, 5, 6], [7, 8, 9, 10, 11, 12]]
    y = [[2, 3, 4, 5, 6, 7], [8, 9, 10, 11, 12, 13]]
    want, want_cost = jm.compute_output(x, y)
    status, text = _call(server, "POST", "/output/",
                         {"model_id": "hyb", "input": x, "target": y})
    assert status == 200, text
    body = json.loads(text)
    assert set(body) == {"output", "cost"}
    np.testing.assert_allclose(body["output"], want, atol=1e-5)
    np.testing.assert_allclose(body["cost"], want_cost, atol=1e-5)
    status, text = _call(server, "POST", "/output/",
                         {"model_id": "hyb", "input": x})
    assert status == 200 and json.loads(text)["cost"] is None
    evaluate = {"model_id": "hyb", "dataset_id": toy_shards, "shard": 0,
                "epochs": 2, "batch_size": 2, "block_size": 16,
                "step_size": 1}
    status, text = _call(server, "POST", "/evaluate/", evaluate)
    assert status == 200, text
    np.testing.assert_allclose(json.loads(text)["cost"],
                               jm.evaluate_model(toy_shards, None, 0, 2, 2,
                                                 16, 1), rtol=1e-5)


def test_output_and_evaluate_errors(server, toy_hybrid_layers, toy_optimizer,
                                    toy_shards, monkeypatch):
    assert _call(server, "POST", "/model/",
                 {"model_id": "h", "layers": toy_hybrid_layers,
                  "optimizer": toy_optimizer})[0] == 200
    out = {"model_id": "h", "input": [[1, 2, 3]]}
    assert _call(server, "POST", "/output/", out)[0] == 200
    assert _call(server, "POST", "/output/", dict(out, model_id="nope")
                 )[0] == 404
    status, text = _call(server, "POST", "/output/", dict(out, input=[1, 2]))
    assert status == 400 and "2-D" in text
    status, text = _call(server, "POST", "/output/", {"model_id": "h"})
    assert status == 422 and "input" in text
    assert _call(server, "POST", "/output/", dict(out, target="x"))[0] == 422
    # a fused projection of the wrong width for its ssm layer
    bad = json.loads(json.dumps(toy_hybrid_layers))
    bad[2]["residual"][0]["sequential"][1]["linear"]["out_features"] = 99
    bad[2]["residual"][0]["sequential"][3]["linear"]["in_features"] = 99
    assert _call(server, "POST", "/model/",
                 {"model_id": "bad", "layers": bad,
                  "optimizer": toy_optimizer})[0] == 200
    status, text = _call(server, "POST", "/output/", dict(out, model_id="bad"))
    assert status == 400 and "ssm fused input width 99" in text
    evaluate = {"model_id": "h", "dataset_id": toy_shards, "shard": 0,
                "epochs": 1, "batch_size": 2, "block_size": 16,
                "step_size": 1}
    assert _call(server, "POST", "/evaluate/", evaluate)[0] == 200
    assert _call(server, "POST", "/evaluate/", dict(evaluate, model_id="nope")
                 )[0] == 404
    body = dict(evaluate)
    del body["epochs"]
    status, text = _call(server, "POST", "/evaluate/", body)
    assert status == 422 and "epochs" in text
    status, text = _call(server, "POST", "/evaluate/",
                         dict(evaluate, dataset_id="missing"))
    assert status == 400 and "no shards" in text
    monkeypatch.setenv("PENROZ_MESH_MODEL", "2")
    status, text = _call(server, "POST", "/evaluate/", evaluate)
    assert status == 400 and "PENROZ_MESH_MODEL" in text


def test_ssm_model_refused_under_continuous_batching(server, paged,
                                                     monkeypatch,
                                                     toy_hybrid_layers,
                                                     toy_optimizer):
    """A model with ssm layers is served under continuous batching (its
    rows carry their recurrent state): ``/generate/`` and
    ``/generate_batch/`` give its single-sequence tokens, and
    ``/serving_stats/`` counts its recurrent state's bytes."""
    assert _call(server, "POST", "/model/",
                 {"model_id": "h", "layers": toy_hybrid_layers,
                  "optimizer": toy_optimizer})[0] == 200
    body = _gen("h", input=[[1, 2, 3]], max_new_tokens=4)
    single = _call(server, "POST", "/generate/", body)
    assert single[0] == 200
    rows = [_call(server, "POST", "/generate/",
                  _gen("h", input=[p], max_new_tokens=4))
            for p in ([1, 2], [3])]
    assert all(status == 200 for status, _ in rows)
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    assert _call(server, "POST", "/generate/", body) == single
    status, text = _call(server, "POST", "/generate_batch/",
                         {"model_id": "h", "inputs": [[1, 2], [3]],
                          "block_size": 16, "max_new_tokens": 4,
                          "temperature": 0})
    assert status == 200, text
    assert json.loads(text)["sequences"] == [json.loads(t)["tokens"]
                                             for _, t in rows]
    status, text = _call(server, "GET", "/serving_stats/")
    assert status == 200 and json.loads(text)["ssm_state_bytes"] > 0


def _hf_checkpoint(workdir, name="hf_qwen3"):
    """A tiny Qwen3 checkpoint written by transformers (bf16 safetensors)."""
    import torch
    from transformers import Qwen3Config, Qwen3ForCausalLM
    torch.manual_seed(0)
    model = Qwen3ForCausalLM(Qwen3Config(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=64, tie_word_embeddings=True)).eval()
    path = str(workdir / name)
    model.to(torch.bfloat16).save_pretrained(path, safe_serialization=True)
    return path


def _bf16_bits(value):
    import torch
    if isinstance(value, torch.Tensor):
        return value.view(torch.int16).numpy()
    return np.asarray(value).view(np.int16)


def test_import_then_generate(server, workdir):
    """POST /import/ of a local checkpoint → /progress/ Imported →
    /generate/ (the tokens of the imported model in process, streamed
    too); the errors: a hub id 400, a missing field 422, an unknown
    device 400, and nothing saved by a refused import."""
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    ckpt = _hf_checkpoint(workdir)
    status, text = _call(server, "POST", "/import/",
                         {"hf_repo_id": ckpt, "model_id": "q3"})
    assert status == 200, text
    assert json.loads(text) == {
        "model_id": "q3", "status": "imported",
        "message": f"Model imported from HuggingFace ({ckpt}) and ready "
                   f"for use"}
    status, text = _call(server, "GET", "/progress/?model_id=q3")
    assert json.loads(text)["status"]["code"] == "Imported"
    tckpt.join_flushes()
    local = NeuralNetworkModel.deserialize("q3", device="cpu")
    expected = local.generate_tokens([1, 2, 3, 4, 5], 16, 10, temperature=0)
    status, text = _call(server, "POST", "/generate/",
                         _gen("q3", max_new_tokens=10))
    assert status == 200 and json.loads(text)["tokens"] == expected
    status, text = _call(server, "POST", "/generate/",
                         _gen("q3", max_new_tokens=10, stream=True))
    assert [int(t) for t in text.split()] == expected[5:]

    status, text = _call(server, "POST", "/import/",
                         {"hf_repo_id": "Qwen/Qwen3-0.6B", "model_id": "x"})
    assert status == 400 and "local" in text
    assert _call(server, "POST", "/import/", {"model_id": "x"})[0] == 422
    assert _call(server, "POST", "/import/",
                 {"hf_repo_id": ckpt, "model_id": "x",
                  "device": "tpuu"})[0] == 400
    assert _call(server, "GET", "/progress/?model_id=x")[0] == 404


def test_import_while_importing_is_409(server, workdir, monkeypatch):
    """A second import of the same model_id while the first runs is a 409;
    another model_id is not held up."""
    from penroz_tpu_torch.serve import app as app_mod
    ckpt = _hf_checkpoint(workdir)
    entered, release = threading.Event(), threading.Event()
    real = app_mod.NeuralNetworkModel.from_huggingface

    def slow(model_id, *args, **kwargs):
        if model_id == "slow":
            entered.set()
            assert release.wait(30)
        return real(model_id, *args, **kwargs)

    monkeypatch.setattr(app_mod.NeuralNetworkModel, "from_huggingface",
                        slow)
    results = {}
    first = threading.Thread(target=lambda: results.setdefault(
        "first", _call(server, "POST", "/import/",
                       {"hf_repo_id": ckpt, "model_id": "slow"})))
    first.start()
    assert entered.wait(30)
    status, text = _call(server, "POST", "/import/",
                         {"hf_repo_id": ckpt, "model_id": "slow"})
    assert status == 409 and "already in progress" in text
    assert _call(server, "POST", "/import/",
                 {"hf_repo_id": ckpt, "model_id": "other"})[0] == 200
    release.set()
    first.join(60)
    assert results["first"][0] == 200
    assert _call(server, "POST", "/import/",
                 {"hf_repo_id": ckpt, "model_id": "slow"})[0] == 200


def test_imports_load_across_packages(server, workdir):
    """A checkpoint the port imported loads in the JAX package with the
    same bf16 parameters, and one the JAX package imported serves in the
    port with the port's own import's tokens."""
    ckpt = _hf_checkpoint(workdir)
    assert _call(server, "POST", "/import/",
                 {"hf_repo_id": ckpt, "model_id": "by_port"})[0] == 200
    jm_own = JModel.from_huggingface("by_jax", ckpt)
    tckpt.join_flushes()
    jckpt.join_flushes()
    jm = JModel.deserialize("by_port")
    assert jm.status["code"] == "Imported"
    assert set(jm.params) == set(jm_own.params)
    for key, value in jm_own.params.items():
        np.testing.assert_array_equal(_bf16_bits(jm.params[key]),
                                      _bf16_bits(value), err_msg=key)
    assert len(jm.generate_tokens([1, 2, 3], 16, 4, temperature=0)) == 7
    port_tokens = json.loads(_call(server, "POST", "/generate/",
                                   _gen("by_port"))[1])["tokens"]
    status, text = _call(server, "POST", "/generate/", _gen("by_jax"))
    assert status == 200 and json.loads(text)["tokens"] == port_tokens


def test_main_host_port_env_and_log_config(monkeypatch, tmp_path, capsys):
    """``main`` serves on ``HOST``/``PORT`` from the environment, which
    ``--host``/``--port`` override, and configures logging from the
    ``PENROZ_LOG_CONFIG`` dictConfig; a missing file warns on stderr as
    the JAX service does and falls back."""
    import logging
    from penroz_tpu.serve import app as japp
    from penroz_tpu_torch.serve import app as app_mod
    seen = []

    class _Server:
        server_address = ("h", 1)
        device = "cpu"

        def serve_forever(self):
            pass

        shutdown = server_close = join_training = serve_forever

    def fake_create(device=None, host="127.0.0.1", port=0):
        seen.append((device, host, port))
        return _Server()

    monkeypatch.setattr(app_mod, "create_app", fake_create)
    cfg = tmp_path / "log_config.json"
    # incremental: a full dictConfig would close the test runner's own
    # log handlers
    cfg.write_text(json.dumps({
        "version": 1, "incremental": True,
        "loggers": {"penroz_log_config_probe": {"level": "ERROR"}}}))
    probe = logging.getLogger("penroz_log_config_probe")
    monkeypatch.setattr(probe, "level", probe.level)
    monkeypatch.setenv("PENROZ_LOG_CONFIG", str(cfg))
    monkeypatch.setenv("HOST", "0.0.0.0")
    monkeypatch.setenv("PORT", "8123")
    app_mod.main(["--device", "cpu"])
    assert seen[-1] == ("cpu", "0.0.0.0", 8123)
    assert probe.level == logging.ERROR
    app_mod.main(["--device", "cpu", "--host", "127.0.0.1",
                  "--port", "9001"])
    assert seen[-1] == ("cpu", "127.0.0.1", 9001)
    monkeypatch.setenv("PENROZ_LOG_CONFIG", str(tmp_path / "missing.json"))
    fallbacks = []
    monkeypatch.setattr(logging, "basicConfig",
                        lambda **kw: fallbacks.append(kw["level"]))
    capsys.readouterr()
    app_mod._configure_logging()
    ours = capsys.readouterr().err
    japp._configure_logging()
    assert ours == capsys.readouterr().err
    assert "does not exist" in ours
    assert fallbacks == [logging.INFO, logging.INFO]
