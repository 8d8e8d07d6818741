"""The fault-tolerance contract of the port's continuous-batching engine
against the JAX package's, over HTTP on the CPU.

Each scenario runs on a JAX service (aiohttp, on a localhost port) and on
the port's service, one after the other, over one shared checkpoint (a
2-layer d-64 GPT, the paged pool with pages of 4, the unified ragged
ticks), and compares what a client sees: statuses, ``Retry-After``
bounds, ``/readyz`` bodies, the typed shed counters, and the survivors'
greedy tokens token for token.  Deadlines and stalls are made certain
with ``decode.step:sleep@MS`` rules (utils/faults.py, one superstep a
block), crashes with ``decode.step:raise@N`` rules; every wait carries a
timeout.  Scenarios: a full queue's 429, a deadline's 504 while queued
and in flight, the stream's ``timeout`` line, the server-wide deadline
cap, the breaker with its default of 3 crashes (503, ``/readyz``, the
probe that closes it), a probe that fails and re-arms the cooldown, the
single-sequence fallback, the admission window, the tick watchdog,
``/readyz`` while draining, the graceful drain and its time limit, a
crash under the prefix cache, and a batch that sheds as one."""

import asyncio
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults as tfaults

BLOCK = 32
MODEL = "res"
WAIT_S = 60.0
PROMPT = [1, 2, 3]
SIDES = ("jax", "torch")


def _faults_reset():
    jfaults.reset()
    tfaults.reset()


@pytest.fixture
def jmodel(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    model = JModel(MODEL, JMapper(jpresets.gpt2_custom(
        d=64, heads=4, depth=2, vocab=64, block=BLOCK),
        {"sgd": {"lr": 0.1}}))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def env(jmodel, monkeypatch):
    """Continuous batching over the paged pool on both sides; every
    resilience knob unset (the defaults)."""
    for name in (jfaults.ENV, "TURBO_QUANT_KV_CACHE", "PENROZ_PREFIX_CACHE",
                 "PENROZ_SPEC_DECODE", DS.REQ_TIMEOUT_ENV, DS.MAX_QUEUE_ENV,
                 DS.MAX_CRASHES_ENV, DS.BREAKER_COOLDOWN_ENV,
                 DS.FALLBACK_ENV, DS.ADMIT_MS_ENV, DS.TICK_WATCHDOG_ENV,
                 DS.DRAIN_S_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    monkeypatch.setenv("PENROZ_SCHED_MAX_ROWS", "2")
    _faults_reset()
    yield monkeypatch
    _faults_reset()


class _JaxServer:
    """The JAX package's aiohttp app on a localhost port, its event loop
    in a thread of its own; ``close`` runs the app's shutdown (drain)."""

    def __init__(self):
        from aiohttp import web

        from penroz_tpu.serve import app as app_mod
        app_mod.model_locks.clear()
        app_mod.dataset_locks.clear()
        self.loop = asyncio.new_event_loop()
        self.runner = web.AppRunner(app_mod.create_app())
        started = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = site._server.sockets[0].getsockname()[1]
            started.set()
            self.loop.run_forever()

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert started.wait(WAIT_S)
        self.base = f"http://127.0.0.1:{self.port}"

    def close(self):
        asyncio.run_coroutine_threadsafe(self.runner.cleanup(),
                                         self.loop).result(WAIT_S)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()
        self.loop.close()


class _TorchServer:
    def __init__(self):
        self.srv = create_app(device="cpu")
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.base = "http://%s:%d" % self.srv.server_address[:2]

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive()


@pytest.fixture
def serve():
    """``serve(side)`` starts that side's server; each is closed (and its
    scheduler registry reset) at the end."""
    from penroz_tpu.serve import decode_scheduler as JDS
    opened = []

    def start(side):
        server = _JaxServer() if side == "jax" else _TorchServer()
        opened.append(server)
        return server

    yield start
    for server in opened:
        if getattr(server, "closed", False):
            continue
        server.close()
    JDS.reset()
    DS.reset()


def _call(base, method, path, body=None):
    """(status, headers, text); a connection the server dropped answers
    status None."""
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
            return resp.status, dict(resp.headers), resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read().decode()
    except (urllib.error.URLError, ConnectionError) as e:
        return None, {}, str(e)


def _gen(prompt=PROMPT, max_new=4, **kw):
    body = {"model_id": MODEL, "input": [prompt], "block_size": BLOCK,
            "max_new_tokens": max_new, "temperature": 0}
    body.update(kw)
    return body


def _tokens(result):
    status, _, text = result
    assert status == 200, result
    return json.loads(text)["tokens"]


def _stats(base):
    return json.loads(_call(base, "GET", "/serving_stats/")[2])


def _readyz(base):
    status, _, text = _call(base, "GET", "/readyz")
    return status, json.loads(text)


def _wait(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


class _Fire:
    """A request on a thread of its own; ``result()`` joins it."""

    def __init__(self, base, method, path, body):
        self.out = None

        def run():
            self.out = _call(base, method, path, body)

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()

    def result(self):
        self.thread.join(WAIT_S)
        assert not self.thread.is_alive(), "request still running"
        return self.out


def _retry_after(headers):
    value = headers.get("Retry-After")
    assert value is not None, headers
    return int(value)


def _both(scenario, serve, jmodel, env):
    """``scenario(base, env)`` on each side, faults reset before each;
    returns {side: observations}."""
    out = {}
    for side in SIDES:
        _faults_reset()
        server = serve(side)
        out[side] = scenario(server.base, env)
        env.delenv(jfaults.ENV, raising=False)
    return out


# -- overload: the bounded queue and deadlines -------------------------------

def test_queue_full_429_keeps_admitted_tokens(serve, jmodel, env):
    """``PENROZ_SCHED_MAX_QUEUE=1`` with one row busy and one request
    queued: the next request is a 429 with a Retry-After in [1, 30], and
    the admitted and queued requests keep their greedy tokens."""
    base_a = jmodel.generate_tokens([PROMPT], BLOCK, 12, temperature=0)
    base_b = jmodel.generate_tokens([[5]], BLOCK, 4, temperature=0)
    env.setenv("PENROZ_SCHED_MAX_ROWS", "1")
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")

    def scenario(base, env):
        _tokens(_call(base, "POST", "/generate/", _gen()))   # warm
        env.setenv(DS.MAX_QUEUE_ENV, "1")
        env.setenv(jfaults.ENV, "decode.step:sleep@80")
        a = _Fire(base, "POST", "/generate/", _gen(max_new=12))
        _wait(lambda: (lambda s: s["active_rows"] >= 1
                       and s["queue_depth"] == 0)(_stats(base)),
              "A admitted")
        b = _Fire(base, "POST", "/generate/", _gen([5]))
        _wait(lambda: _stats(base)["queue_depth"] >= 1, "B queued")
        status, headers, text = _call(base, "POST", "/generate/",
                                      _gen([7, 8]))
        obs = {"c": status, "retry": 1 <= _retry_after(headers) <= 30,
               "overloaded": "overloaded" in json.loads(text)["detail"],
               "a": _tokens(a.result()), "b": _tokens(b.result())}
        obs["rejections"] = _stats(base)["queue_rejections"]
        env.delenv(DS.MAX_QUEUE_ENV)
        return obs

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"]
    assert got["torch"] == {"c": 429, "retry": True, "overloaded": True,
                            "a": base_a, "b": base_b, "rejections": 1}


def test_deadline_504_queued_and_in_flight(serve, jmodel, env):
    """``timeout_ms`` gives a 504 while queued (before any prefill) and in
    flight (the row retired at a block boundary); the request holding the
    row keeps its tokens."""
    base_a = jmodel.generate_tokens([PROMPT], BLOCK, 8, temperature=0)
    env.setenv("PENROZ_SCHED_MAX_ROWS", "1")
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")

    def scenario(base, env):
        _tokens(_call(base, "POST", "/generate/", _gen()))
        env.setenv(jfaults.ENV, "decode.step:sleep@80")
        a = _Fire(base, "POST", "/generate/", _gen(max_new=8))
        _wait(lambda: _stats(base)["active_rows"] >= 1, "A admitted")
        queued = _call(base, "POST", "/generate/",
                       _gen([5], timeout_ms=100))
        a_tokens = _tokens(a.result())
        inflight = _call(base, "POST", "/generate/",
                         _gen([7], max_new=14, timeout_ms=300))
        return {"queued": queued[0],
                "queued_phase": "queued" in json.loads(queued[2])["detail"],
                "a": a_tokens, "inflight": inflight[0],
                "timeouts": _stats(base)["deadline_timeouts"]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"]
    assert got["torch"] == {"queued": 504, "queued_phase": True,
                            "a": base_a, "inflight": 504, "timeouts": 2}


def test_stream_deadline_ends_with_timeout_line(serve, jmodel, env):
    """A streamed request whose deadline passes in flight sends the tokens
    so far (the greedy prefix), then the line ``timeout``."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 13, temperature=0)
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")

    def scenario(url, env):
        _tokens(_call(url, "POST", "/generate/", _gen()))
        env.setenv(jfaults.ENV, "decode.step:sleep@150")
        status, _, text = _call(url, "POST", "/generate/", _gen(
            max_new=13, stream=True, timeout_ms=600))
        lines = text.strip().split("\n")
        streamed = [int(t) for t in lines[:-1]]
        return {"status": status, "last": lines[-1],
                "some": 1 <= len(streamed) < 13,
                "prefix": streamed == base[3:3 + len(streamed)]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {
        "status": 200, "last": "timeout", "some": True, "prefix": True}


def test_server_deadline_caps_every_request(serve, jmodel, env):
    """``PENROZ_REQ_TIMEOUT_MS`` gives requests without ``timeout_ms`` a
    deadline and caps a longer one; a short request still completes."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0)
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")

    def scenario(url, env):
        _tokens(_call(url, "POST", "/generate/", _gen()))
        env.setenv(DS.REQ_TIMEOUT_ENV, "300")
        env.setenv(jfaults.ENV, "decode.step:sleep@100")
        plain = _call(url, "POST", "/generate/", _gen(max_new=13))[0]
        capped = _call(url, "POST", "/generate/",
                       _gen(max_new=13, timeout_ms=100000))[0]
        env.delenv(jfaults.ENV)
        # the capped row's last slept step may still be running: the short
        # request's budget starts once the engine is idle
        _wait(lambda: _stats(url)["active_rows"] == 0, "an idle engine")
        short = _tokens(_call(url, "POST", "/generate/", _gen()))
        env.delenv(DS.REQ_TIMEOUT_ENV)
        return {"plain": plain, "capped": capped, "short": short}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {"plain": 504, "capped": 504,
                                          "short": base}


# -- the circuit breaker -----------------------------------------------------

def test_breaker_default_opens_after_three_crashes_and_probe_closes(
        serve, jmodel, env):
    """No knob set: three crashed requests (500), then 503 with a
    Retry-After in [1, 30] and ``/readyz`` 503 naming the model; after the
    default 1000 ms cooldown one probe returns the pre-crash tokens and
    closes the breaker."""

    def scenario(base, env):
        t0 = _tokens(_call(base, "POST", "/generate/", _gen()))
        env.setenv(jfaults.ENV, "decode.step:raise@1+")
        crashes = []
        for i in range(3):
            crashes.append(_call(base, "POST", "/generate/", _gen())[0])
            # the 500 leaves before the recovery has failed the queue:
            # the next request goes in once this crash's reset is counted,
            # so that it crashes a tick of its own
            _wait(lambda: _stats(base)["engine_resets"] == i + 1,
                  "the reset")
        status, headers, text = _call(base, "POST", "/generate/", _gen())
        shed = (status, 1 <= _retry_after(headers) <= 30,
                "circuit breaker" in json.loads(text)["detail"])
        ready_open = _readyz(base)
        health = _call(base, "GET", "/healthz")[0]
        stats_open = _stats(base)
        env.delenv(jfaults.ENV)
        time.sleep(1.1)
        probe = _tokens(_call(base, "POST", "/generate/", _gen()))
        stats = _stats(base)
        return {"t0": t0, "crashes": crashes, "shed": shed,
                "ready_open": ready_open, "health": health,
                "open": stats_open["breaker_open"],
                "probe_equal": probe == t0, "ready": _readyz(base),
                "closed": not stats["breaker_open"],
                "resets": (stats["crashes_total"], stats["engine_resets"])}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"]
    assert got["torch"]["t0"] == jmodel.generate_tokens([PROMPT], BLOCK, 4,
                                                        temperature=0)
    assert got["torch"]["crashes"] == [500, 500, 500]
    assert got["torch"]["shed"] == (503, True, True)
    assert got["torch"]["ready_open"] == (503, {
        "ready": False, "draining": False, "breaker_open_engines": [MODEL],
        "stuck_engines": []})
    assert got["torch"]["health"] == 200 and got["torch"]["open"]
    assert got["torch"]["probe_equal"] and got["torch"]["closed"]
    assert got["torch"]["ready"] == (200, {
        "ready": True, "draining": False, "breaker_open_engines": [],
        "stuck_engines": []})
    assert got["torch"]["resets"] == (3, 3)


def test_breaker_failed_probe_rearms_the_cooldown(serve, jmodel, env):
    """``PENROZ_ENGINE_MAX_CRASHES=1`` and ``PENROZ_BREAKER_COOLDOWN_MS``:
    one crash opens the breaker; after the cooldown the probe crashes too,
    and the next request is shed again (the cooldown started anew); after
    another cooldown the probe completes."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0)

    def scenario(url, env):
        _tokens(_call(url, "POST", "/generate/", _gen()))
        env.setenv(DS.MAX_CRASHES_ENV, "1")
        env.setenv(DS.BREAKER_COOLDOWN_ENV, "400")
        env.setenv(jfaults.ENV, "decode.step:raise@1+")
        statuses = [_call(url, "POST", "/generate/", _gen())[0]
                    for _ in range(2)]
        time.sleep(0.45)
        statuses.append(_call(url, "POST", "/generate/", _gen())[0])
        statuses.append(_call(url, "POST", "/generate/", _gen())[0])
        env.delenv(jfaults.ENV)
        time.sleep(0.45)
        probe = _tokens(_call(url, "POST", "/generate/", _gen()))
        stats = _stats(url)
        env.delenv(DS.MAX_CRASHES_ENV)
        env.delenv(DS.BREAKER_COOLDOWN_ENV)
        return {"statuses": statuses, "probe": probe,
                "open": stats["breaker_open"],
                "crashes": stats["crashes_total"]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {
        "statuses": [500, 503, 500, 503], "probe": base, "open": False,
        "crashes": 2}


def test_breaker_fallback_serves_single_sequence(serve, jmodel, env):
    """``PENROZ_SCHED_FALLBACK=1``: an open breaker's request is served on
    the single-sequence (paged) path with the greedy tokens, and the
    breaker stays open."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0)

    def scenario(url, env):
        _tokens(_call(url, "POST", "/generate/", _gen()))
        env.setenv(DS.MAX_CRASHES_ENV, "1")
        env.setenv(DS.BREAKER_COOLDOWN_ENV, "100000")
        env.setenv(jfaults.ENV, "decode.step:raise@1")
        crash = _call(url, "POST", "/generate/", _gen())[0]
        shed = _call(url, "POST", "/generate/", _gen())[0]
        env.setenv(DS.FALLBACK_ENV, "1")
        fallback = _tokens(_call(url, "POST", "/generate/", _gen()))
        streamed = _call(url, "POST", "/generate/", _gen(stream=True))
        open_ = _stats(url)["breaker_open"]
        for name in (DS.MAX_CRASHES_ENV, DS.BREAKER_COOLDOWN_ENV,
                     DS.FALLBACK_ENV):
            env.delenv(name)
        return {"crash": crash, "shed": shed, "fallback": fallback,
                "streamed": [int(t) for t in streamed[2].split()],
                "open": open_}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {
        "crash": 500, "shed": 503, "fallback": base, "streamed": base[3:],
        "open": True}


# -- admission window, watchdog, readiness -----------------------------------

def test_admission_window_coalesces_a_burst(serve, jmodel, env):
    """``PENROZ_SCHED_ADMIT_MS``: an idle engine holds its first admission,
    so that two requests 50 ms apart prefill in the same first block."""
    want = [jmodel.generate_tokens([p], BLOCK, 4, temperature=0)
            for p in (PROMPT, [9, 8, 7, 6])]

    def scenario(base, env):
        _tokens(_call(base, "POST", "/generate/", _gen()))
        ticks0 = len(_stats(base)["tick_timeline"])
        env.setenv(DS.ADMIT_MS_ENV, "1000")
        a = _Fire(base, "POST", "/generate/", _gen())
        time.sleep(0.05)
        b = _Fire(base, "POST", "/generate/", _gen([9, 8, 7, 6]))
        tokens = [_tokens(a.result()), _tokens(b.result())]
        env.delenv(DS.ADMIT_MS_ENV)
        timeline = _stats(base)["tick_timeline"]       # newest first
        first = timeline[len(timeline) - ticks0 - 1]
        return {"tokens": tokens, "first_prefill_rows": first["prefill_rows"]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {"tokens": want,
                                          "first_prefill_rows": 2}


def test_tick_watchdog_marks_the_engine_stuck(serve, jmodel, env):
    """``PENROZ_TICK_WATCHDOG_MS``: while one tick runs past it,
    ``/readyz`` answers 503 naming the model in ``stuck_engines``; after
    the tick, 200 again, and the request completes."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 2, temperature=0)

    def scenario(url, env):
        _tokens(_call(url, "POST", "/generate/", _gen()))
        env.setenv(DS.TICK_WATCHDOG_ENV, "100")
        env.setenv(jfaults.ENV, "decode.step:sleep@1500")
        a = _Fire(url, "POST", "/generate/", _gen(max_new=2))
        seen = []
        _wait(lambda: seen.append(_readyz(url)) or seen[-1][0] == 503,
              "a stuck readiness")
        tokens = _tokens(a.result())
        env.delenv(jfaults.ENV)
        # the response can reach the client before the worker has left the
        # tick that emitted its last token: wait for the tick's end (the
        # state /readyz reads) rather than race it with one read
        _wait(lambda: _readyz(url)[0] == 200, "readiness after the tick")
        after = _readyz(url)
        env.delenv(DS.TICK_WATCHDOG_ENV)
        return {"stuck": seen[-1], "tokens": tokens, "after": after[0]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {
        "stuck": (503, {"ready": False, "draining": False,
                        "breaker_open_engines": [], "stuck_engines": [MODEL]}),
        "tokens": base, "after": 200}


def test_readyz_draining_and_healthz(serve, jmodel, env):
    """``/healthz`` is always 200; ``/readyz`` is 200 on a clean server
    and 503 while the scheduler registry drains."""
    from penroz_tpu.serve import decode_scheduler as JDS
    got = {}
    for side, module in zip(SIDES, (JDS, DS)):
        base = serve(side).base
        clean = _readyz(base)
        env.setattr(module, "_DRAINING", True)
        draining = _readyz(base)
        env.setattr(module, "_DRAINING", False)
        got[side] = {"health": _call(base, "GET", "/healthz")[0],
                     "clean": clean, "draining": draining}
    assert got["torch"] == got["jax"] == {
        "health": 200,
        "clean": (200, {"ready": True, "draining": False,
                        "breaker_open_engines": [], "stuck_engines": []}),
        "draining": (503, {"ready": False, "draining": True,
                           "breaker_open_engines": [],
                           "stuck_engines": []})}


# -- graceful drain ----------------------------------------------------------

def _sched_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("penroz-sched")}


def _drain(serve, env, drain_s, max_new, sleep_ms):
    """A request in flight when its server shuts down; returns the
    response and the seconds the shutdown took, and checks that no
    engine thread outlived the shutdown."""
    out = {}
    before = _sched_threads()
    for side in SIDES:
        _faults_reset()
        server = serve(side)
        _tokens(_call(server.base, "POST", "/generate/", _gen()))
        env.setenv(DS.DRAIN_S_ENV, drain_s)
        env.setenv(jfaults.ENV, f"decode.step:sleep@{sleep_ms}")
        a = _Fire(server.base, "POST", "/generate/", _gen(max_new=max_new))
        _wait(lambda: _stats(server.base)["active_rows"] >= 1, "admitted")
        t0 = time.monotonic()
        server.close()
        server.closed = True
        took = time.monotonic() - t0
        out[side] = (a.result(), took)
        env.delenv(jfaults.ENV)
        env.delenv(DS.DRAIN_S_ENV)
        assert _sched_threads() <= before, side
    return out


def test_graceful_drain_finishes_in_flight_rows(serve, jmodel, env):
    """Shutdown with ``PENROZ_DRAIN_S=30``: the row in flight finishes
    (200, its greedy tokens) before the worker threads are joined."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 12, temperature=0)
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    got = _drain(serve, env, "30", 12, 40)
    for side in SIDES:
        assert _tokens(got[side][0]) == base, side


def test_drain_time_limit_fails_what_is_left(serve, jmodel, env):
    """Shutdown with ``PENROZ_DRAIN_S=0.2`` and a row that needs seconds:
    the drain ends at its limit, the row is failed (no 200), and the
    shutdown does not wait for it."""
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    got = _drain(serve, env, "0.2", 28, 100)
    for side in SIDES:
        (status, _, _), took = got[side]
        assert status != 200, side
        assert took < 2.0, (side, took)


# -- crash recovery under the prefix cache; batch shedding -------------------

def test_crash_under_prefix_cache_rematches_cold(serve, jmodel, env):
    """``PENROZ_PREFIX_CACHE=1``: a crash while a row aliases cached pages
    rebuilds the pool and the radix tree; the next shared-prefix request
    matches nothing (a cold prefill) and gives the same tokens, and the
    one after it hits again."""
    prefix = [1, 2, 3, 4, 5, 6, 7, 8]
    prompt = prefix + [9]
    base = jmodel.generate_tokens([prompt], BLOCK, 5, temperature=0)
    env.setenv("PENROZ_PREFIX_CACHE", "1")
    env.setenv("PENROZ_PREFIX_CACHE_PAGES", "8")
    env.setenv("PENROZ_PREFILL_CHUNK", "4")

    def cache(base_url):
        pc = _stats(base_url)["engines"][0]["prefix_cache"]
        return {k: pc[k] for k in ("hits", "misses", "cached_pages")}

    def scenario(url, env):
        first = _tokens(_call(url, "POST", "/generate/",
                              _gen(prompt, max_new=5)))
        hit = _tokens(_call(url, "POST", "/generate/",
                            _gen(prompt, max_new=5)))
        before = cache(url)
        env.setenv(jfaults.ENV, "decode.step:raise@1")
        crash = _call(url, "POST", "/generate/", _gen(prompt, max_new=5))[0]
        env.delenv(jfaults.ENV)
        # the 500 leaves before the recovery has failed the queue: the
        # next request goes in once the reset is counted, which comes
        # after that
        _wait(lambda: _stats(url)["engine_resets"] == 1, "the reset")
        cold = _tokens(_call(url, "POST", "/generate/",
                             _gen(prompt, max_new=5)))
        after_cold = cache(url)
        again = _tokens(_call(url, "POST", "/generate/",
                              _gen(prompt, max_new=5)))
        return {"tokens": [first, hit, cold, again], "before": before,
                "crash": crash, "after_cold": after_cold,
                "after": cache(url),
                "resets": _stats(url)["engine_resets"]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"]
    assert got["torch"]["tokens"] == [base] * 4
    assert got["torch"]["crash"] == 500
    assert got["torch"]["before"]["hits"] == 1
    assert got["torch"]["after_cold"] == {"hits": 0, "misses": 1,
                                          "cached_pages": 2}
    assert got["torch"]["after"]["hits"] == 1
    assert got["torch"]["resets"] == 1
    engine = next(iter(DS._ENGINES.values()))
    assert engine._prefix_cache.page_audit() == []


def test_generate_batch_sheds_as_one(serve, jmodel, env):
    """A ``/generate_batch/`` row whose ``timeout_ms`` expires sheds the
    whole batch with a 504; without a deadline the batch answers every
    row's greedy tokens."""
    prompts = [PROMPT, [5, 6]]
    want = [jmodel.generate_tokens([p], BLOCK, 6, temperature=0)
            for p in prompts]
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")

    def batch(**kw):
        body = {"model_id": MODEL, "inputs": prompts, "block_size": BLOCK,
                "max_new_tokens": 6, "temperature": 0}
        body.update(kw)
        return body

    def scenario(url, env):
        ok = _call(url, "POST", "/generate_batch/", batch())
        env.setenv(jfaults.ENV, "decode.step:sleep@100")
        shed = _call(url, "POST", "/generate_batch/", batch(timeout_ms=250))
        return {"ok": json.loads(ok[2])["sequences"], "shed": shed[0],
                "deadline": "Deadline" in json.loads(shed[2])["detail"]}

    got = _both(scenario, serve, jmodel, env)
    assert got["torch"] == got["jax"] == {"ok": want, "shed": 504,
                                          "deadline": True}


def test_probe_that_times_out_rearms_the_cooldown(serve, jmodel, env):
    """The port only (the JAX engine keeps such a probe in flight, so its
    breaker never admits another): a probe whose deadline expires in
    flight re-arms the cooldown, and the next probe closes the breaker."""
    base = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0)
    env.setenv("PENROZ_SCHED_SUPERSTEP", "1")
    url = serve("torch").base
    _tokens(_call(url, "POST", "/generate/", _gen()))
    env.setenv(DS.MAX_CRASHES_ENV, "1")
    env.setenv(DS.BREAKER_COOLDOWN_ENV, "300")
    env.setenv(jfaults.ENV, "decode.step:raise@1")
    assert _call(url, "POST", "/generate/", _gen())[0] == 500
    env.setenv(jfaults.ENV, "decode.step:sleep@100")
    time.sleep(0.35)
    probe = _call(url, "POST", "/generate/", _gen(max_new=13,
                                                  timeout_ms=250))
    assert probe[0] == 504, probe
    assert _call(url, "POST", "/generate/", _gen())[0] == 503
    env.delenv(jfaults.ENV)
    time.sleep(0.35)
    assert _tokens(_call(url, "POST", "/generate/", _gen())) == base
    assert _readyz(url)[0] == 200
