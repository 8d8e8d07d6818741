"""The port's HTTP observability surface against the JAX service's, over
HTTP on the CPU (the JAX aiohttp app on a localhost port and the port's
``http.server``, one shared checkpoint).

- Every response carries ``X-Request-Id``: a client's sane id is echoed,
  otherwise one is generated — on 200, 400, 404, 422, 429, 503 and 504
  alike; error bodies carry it as ``request_id``.
- ``/trace/`` lists the request and rejects a non-integer ``limit``
  (422); ``/trace/{id}`` gives the span tree and its Chrome rendering, an
  unknown id 404 and an unknown format 422.
- ``/`` answers 302 to ``/dashboard``; ``/dashboard`` and
  ``/static/dashboard.js`` answer 200; every URL the port's
  ``dashboard.js`` fetches is in the port's route tables."""

import asyncio
import json
import os
import re
import threading
import time
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import qos as jqos
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu.utils import tracing as jtracing
from penroz_tpu_torch.serve import app as app_mod
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import qos
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults as tfaults
from penroz_tpu_torch.utils import tracing

BLOCK = 32
WAIT_S = 60.0


class _NoRedirect(urllib.request.HTTPRedirectHandler):
    def redirect_request(self, *args, **kwargs):
        return None


_OPENER = urllib.request.build_opener(_NoRedirect)


def _call(base, method, path, body=None, rid=None):
    headers = {"Content-Type": "application/json"}
    if rid is not None:
        headers["X-Request-Id"] = rid
    req = urllib.request.Request(
        base + path, data=json.dumps(body).encode() if body is not None
        else None, method=method, headers=headers)
    try:
        with _OPENER.open(req, timeout=WAIT_S) as resp:
            return resp.status, resp.headers, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers, e.read().decode()


@pytest.fixture
def servers(workdir, monkeypatch):
    """Both services on one checkpoint, continuous batching over the paged
    pool (pages of 4, 1 row, superstep 1)."""
    from aiohttp import web

    from penroz_tpu.serve import app as japp
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name, value in (("PENROZ_CONTINUOUS_BATCHING", "1"),
                        ("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_SCHED_MAX_ROWS", "1"),
                        ("PENROZ_SCHED_SUPERSTEP", "1")):
        monkeypatch.setenv(name, value)
    for name in (tfaults.ENV, "PENROZ_PREFIX_CACHE", "TURBO_QUANT_KV_CACHE",
                 DS.MAX_QUEUE_ENV, qos.TENANT_RATE_ENV,
                 "PENROZ_TRACE_SAMPLE"):
        monkeypatch.delenv(name, raising=False)
    for mod in (tracing, jtracing, qos, jqos, tfaults, jfaults):
        mod.reset()
    JModel("obs", JMapper(jpresets.gpt2_custom(
        d=64, heads=4, depth=2, vocab=64, block=BLOCK),
        {"sgd": {"lr": 0.1}})).serialize(sync_flush=True)
    srv = app_mod.create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(japp.create_app())
    started, box = threading.Event(), {}

    def run():
        asyncio.set_event_loop(loop)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        box["port"] = site._server.sockets[0].getsockname()[1]
        started.set()
        loop.run_forever()

    jthread = threading.Thread(target=run, daemon=True)
    jthread.start()
    assert started.wait(WAIT_S)
    yield {"torch": "http://%s:%d" % srv.server_address[:2],
           "jax": f"http://127.0.0.1:{box['port']}"}, monkeypatch
    asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(WAIT_S)
    loop.call_soon_threadsafe(loop.stop)
    jthread.join(WAIT_S)
    loop.close()
    srv.shutdown()
    srv.server_close()
    thread.join(WAIT_S)
    for mod in (tracing, jtracing, qos, jqos, tfaults, jfaults):
        mod.reset()


def _gen(prompt=(1, 2, 3), max_new=4, **kw):
    return dict({"model_id": "obs", "input": [list(prompt)],
                 "block_size": BLOCK, "max_new_tokens": max_new,
                 "temperature": 0}, **kw)


def _until_resets(base, n):
    deadline = time.monotonic() + WAIT_S
    while json.loads(_call(base, "GET", "/serving_stats/")[2])[
            "engine_resets"] < n:
        assert time.monotonic() < deadline, f"no reset {n}"
        time.sleep(0.01)


def _scenarios(base, env):
    """(label, status, X-Request-Id sent or None, response) per request."""
    out = []

    def call(label, method, path, body=None, rid=None):
        status, headers, text = _call(base, method, path, body, rid)
        out.append((label, status, rid, headers.get("X-Request-Id"), text))
        return status, text

    call("ok", "POST", "/generate/", _gen(), rid="client-7.a_b")
    call("ok-generated", "POST", "/generate/", _gen())
    call("stream", "POST", "/generate/", _gen(stream=True), rid="strm")
    call("400", "POST", "/generate/", _gen(priority="urgent"), rid="bad")
    call("404", "POST", "/generate/", dict(_gen(), model_id="nope"),
         rid="gone")
    call("422", "POST", "/generate/", {"model_id": "obs"})
    call("insane-id", "GET", "/healthz", rid="has space")
    env.setenv(tfaults.ENV, "decode.step:sleep@150")
    call("504", "POST", "/generate/", _gen(max_new=8, timeout_ms=100),
         rid="late")
    env.delenv(tfaults.ENV)
    # a quota: the first request of the tenant drives its bucket negative
    call("quota-ok", "PUT", "/tenants/t/quota", {"tokens_per_s": 0.01})
    call("quota-first", "POST", "/generate/", _gen(tenant="t"))
    call("429", "POST", "/generate/", _gen(tenant="t"), rid="shed")
    env.setenv(tfaults.ENV, "decode.step:raise@1+")
    for i in range(3):
        call(f"500-{i}", "POST", "/generate/", _gen(), rid=f"crash{i}")
        # the 500 leaves before the crash recovery has failed the queue:
        # the next request goes in once this crash's reset is counted, so
        # that it crashes a tick of its own
        _until_resets(base, i + 1)
    call("503", "POST", "/generate/", _gen(), rid="open")
    env.delenv(tfaults.ENV)
    return out


def test_request_ids_on_every_response(servers):
    urls, env = servers
    got = {}
    for side in ("jax", "torch"):
        for mod in (tfaults, jfaults, DS):
            mod.reset()
        got[side] = _scenarios(urls[side], env)
    for (label, status, sent, echoed, text), ref in zip(got["torch"],
                                                        got["jax"]):
        assert (label, status) == ref[:2], (label, status, ref[:2])
        assert echoed is not None, label
        if sent is not None and " " not in sent:
            assert echoed == sent, label
        else:
            assert re.fullmatch("[0-9a-f]{32}", echoed), label
        if status in (400, 404, 500):
            body = json.loads(text)
            assert body["request_id"] == echoed, label
            assert body["request_id"] == (sent or echoed)
    statuses = [s for _, s, *_ in got["torch"]]
    assert statuses == [200, 200, 200, 400, 404, 422, 200, 504, 200, 200,
                        429, 500, 500, 500, 503]


def test_trace_routes(servers):
    urls, env = servers
    for side in ("jax", "torch"):
        base = urls[side]
        status, _, _ = _call(base, "POST", "/generate/", _gen(), rid="tr-1")
        assert status == 200
        status, _, text = _call(base, "GET", "/trace/?limit=5")
        assert status == 200, side
        listed = json.loads(text)
        assert [t["request_id"] for t in listed["traces"]] == ["tr-1"]
        assert listed["live"] == []
        assert listed["traces"][0]["retire_reason"] == "max_new_tokens"
        assert _call(base, "GET", "/trace/?limit=x")[0] == 422, side
        assert _call(base, "GET", "/trace/?limit=0")[0] == 200, side
        status, _, text = _call(base, "GET", "/trace/tr-1")
        tree = json.loads(text)
        assert status == 200 and tree["request_id"] == "tr-1"
        assert [c["name"] for c in tree["root"]["children"]] == [
            "queue", "prefill", "decode"]
        status, _, text = _call(base, "GET", "/trace/tr-1?format=chrome")
        events = json.loads(text)["traceEvents"]
        assert status == 200 and events[0]["name"] == "request"
        assert _call(base, "GET", "/trace/tr-1?format=xml")[0] == 422
        status, headers, text = _call(base, "GET", "/trace/nope", rid="q")
        assert status == 404 and "nope" in json.loads(text)["detail"]
        assert headers["X-Request-Id"] == "q"
    # the single-sequence path leaves a one-span trace too
    env.setenv("PENROZ_CONTINUOUS_BATCHING", "0")
    for side in ("jax", "torch"):
        assert _call(urls[side], "POST", "/generate/", _gen(),
                     rid="legacy")[0] == 200
        tree = json.loads(_call(urls[side], "GET", "/trace/legacy")[2])
        assert [c["name"] for c in tree["root"]["children"]] == [
            "legacy_generate"]
        assert tree["meta"]["engine"] == "legacy"


def test_dashboard_routes(servers):
    urls, _ = servers
    for side in ("jax", "torch"):
        status, headers, _ = _call(urls[side], "GET", "/")
        assert status == 302 and headers["Location"] == "/dashboard", side
        status, headers, text = _call(urls[side], "GET", "/dashboard")
        assert status == 200 and "text/html" in headers["Content-Type"]
        assert "/static/dashboard.js" in text
        status, headers, _ = _call(urls[side], "GET", "/static/dashboard.js")
        assert status == 200 and "javascript" in headers["Content-Type"]
        assert _call(urls[side], "GET", "/static/dashboard.css")[0] == 200
        assert _call(urls[side], "GET", "/static/nope.js")[0] == 404
    assert _call(urls["torch"], "GET", "/static/..%2Fapp.py")[0] == 404


def test_dashboard_fetches_only_served_routes():
    src = os.path.join(app_mod.STATIC_DIR, "dashboard.js")
    with open(src) as f:
        text = f.read()
    urls = set(re.findall(r'fetchJson\(\s*[`"](/[^`"?$]*)', text))
    assert urls >= {"/trace/", "/serving_stats/", "/memory/", "/progress/",
                    "/stats/"}
    for url in urls | {"/trace/abc"}:
        assert app_mod._match(app_mod._GET, url)[0] is not None, url
    with open(os.path.join(app_mod.TEMPLATES_DIR, "dashboard.html")) as f:
        html = f.read()
    for ref in re.findall(r'(?:src|href)="(/[^"]+)"', html):
        assert app_mod._match(app_mod._GET, ref)[0] is not None, ref
