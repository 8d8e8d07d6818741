"""The port's OpenAPI document (penroz_tpu_torch/serve/openapi.py), docs
page and ``/profile/`` route on the CPU: the spec's paths and methods are
exactly the server's route tables (templated routes as templates, their
parameters declared in the path); every request schema's required fields
and properties are its ``FIELDS``; ``/openapi.json`` and ``/docs`` answer
over HTTP; a ``torch.profiler`` capture starts, stops into a Chrome trace
that holds the scheduler worker's ranges, and a second start or an idle
stop answers 409."""

import glob
import json
import os
import re
import threading
import urllib.error
import urllib.request

import pytest

from penroz_tpu.serve import openapi as jopenapi
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.serve import app, openapi, schemas
from penroz_tpu_torch.utils import checkpoint as tckpt


@pytest.fixture
def server(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    srv = app.create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield "http://%s:%d" % srv.server_address[:2]
    srv.shutdown()
    srv.server_close()
    thread.join(10)
    assert not thread.is_alive()


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


def _routes():
    return {(method, path) for method, table in (
        ("get", app._GET), ("post", app._POST), ("put", app._PUT),
        ("delete", app._DELETE)) for path in table}


def test_spec_paths_equal_the_route_tables():
    spec = openapi.build_spec()
    assert spec["openapi"] == "3.1.0"
    got = {(m, p) for p, ops in spec["paths"].items() for m in ops}
    assert got == _routes()
    templated = {p for _, p in got if "{" in p}
    assert templated == {"/trace/{request_id}", "/tenants/{tenant_id}/quota",
                         "/static/{path}", "/sessions/{session_id}",
                         "/generate/{request_id}/stream"}
    for path in templated:
        for op in spec["paths"][path].values():
            declared = {p["name"] for p in op["parameters"]
                        if p["in"] == "path"}
            assert declared == set(re.findall(r"{(\w+)}", path)), path
    # the JAX service's observability and QoS routes, as it spells them
    for route in (("get", "/metrics"), ("get", "/trace/"),
                  ("get", "/trace/{request_id}"), ("get", "/memory/"),
                  ("get", "/debug/dump"), ("get", "/tenants/"),
                  ("put", "/tenants/{tenant_id}/quota"),
                  ("get", "/dashboard"), ("get", "/sessions/"),
                  ("delete", "/sessions/{session_id}")):
        assert route[1] in jopenapi.build_spec()["paths"], route
        assert route in got, route
    # the stream reattach, which the JAX document does not list
    assert ("get", "/generate/{request_id}/stream") in got


@pytest.mark.parametrize("cls", schemas.REQUESTS, ids=lambda c: c.__name__)
def test_request_schemas_follow_their_fields(cls):
    doc = openapi.build_spec()["components"]["schemas"][cls.__name__]
    required = [n for n, _, default, _ in cls.FIELDS
                if default is schemas._REQUIRED]
    assert doc["required"] == required
    assert list(doc["properties"]) == [f[0] for f in cls.FIELDS]
    for name, _, default, nullable in cls.FIELDS:
        prop = doc["properties"][name]
        if default is not schemas._REQUIRED:
            assert prop["default"] == default
        assert ("anyOf" in prop and {"type": "null"} in prop["anyOf"]) \
            == nullable


def test_every_body_reference_resolves_and_the_example_is_gpt2():
    spec = openapi.build_spec()
    components = spec["components"]["schemas"]
    for ops in spec["paths"].values():
        for op in ops.values():
            media = op.get("requestBody", {}).get("content", {}).get(
                "application/json")
            if media:
                assert media["schema"]["$ref"].split("/")[-1] in components
    example = spec["paths"]["/model/"]["post"]["requestBody"]["content"][
        "application/json"]["example"]
    assert example == jopenapi.gpt2_124m_example()


def test_openapi_and_docs_routes(server):
    status, headers, text = _call(server, "GET", "/openapi.json")
    assert status == 200 and "json" in headers["Content-Type"]
    assert json.loads(text) == openapi.build_spec()
    status, headers, text = _call(server, "GET", "/docs")
    assert status == 200 and "text/html" in headers["Content-Type"]
    assert "/openapi.json" in text and "http" not in text.split(
        "<script>")[1].split("fetch(")[0]


@pytest.mark.parametrize("route", ["/profile/", "/profiler/trace/"])
def test_profile_start_stop_409(server, workdir, monkeypatch, route,
                                toy_gpt_layers, toy_optimizer):
    """A capture over a scheduler request: the trace parses and holds the
    worker thread's ``penroz/sched_tick`` and ``penroz/sched_mixed``
    ranges; a second start and an idle stop are 409s; an unknown action
    is a 400 and a missing one a 422."""
    from penroz_tpu_torch.serve import decode_scheduler as DS
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    log_dir = str(workdir / "prof")
    assert _call(server, "POST", "/model/", {
        "model_id": "p", "layers": toy_gpt_layers,
        "optimizer": toy_optimizer})[0] == 200
    try:
        status, _, text = _call(server, "POST", route,
                                {"action": "start", "log_dir": log_dir})
        assert status == 200, text
        assert _call(server, "POST", route, {"action": "start"})[0] == 409
        status, _, text = _call(server, "POST", "/generate/", {
            "model_id": "p", "input": [[1, 2, 3]], "block_size": 16,
            "max_new_tokens": 4, "temperature": 0})
        assert status == 200, text
        status, _, text = _call(server, "POST", route, {"action": "stop"})
        assert status == 200 and log_dir in text
    finally:
        DS.reset()
    assert _call(server, "POST", route, {"action": "stop"})[0] == 409
    assert _call(server, "POST", route, {"action": "pause"})[0] == 400
    assert _call(server, "POST", route, {})[0] == 422
    (path,) = glob.glob(os.path.join(log_dir, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"penroz/sched_tick", "penroz/sched_mixed"} <= names
    ticks = [e for e in events if e.get("name") == "penroz/sched_mixed"]
    assert all(e["dur"] > 0 for e in ticks)
