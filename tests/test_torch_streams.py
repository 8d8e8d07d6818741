"""The port's resumable streams (serve/streams.py, ``GET
/generate/{request_id}/stream``) against the JAX package's, on the CPU.

* The ring: the same publish and reattach sequences give the same
  backlogs, live events and typed errors in both packages (the JAX
  consumer is an asyncio queue, the port's a thread-safe one): the
  replay-then-live seam is exactly-once, a reattach behind the ring or
  after the detach grace raises ``ReplayGapError``, a grace of 0 cancels.
* Over HTTP (the port's server): a finished stream replays as
  ``seq:value`` lines (404 unknown, 422 a bad ``from_seq``); 410 behind
  the ring; a client that drops mid-stream with a grace set reattaches
  and reads every event exactly once, the union equal to the JAX greedy
  tokens; a grace that expires cancels the row with no page or pin left;
  a ``stream.resume`` fault is a 500 and the stream stays resumable; with
  no grace a disconnect cancels.

The engine's pace is gated on the stream's own state (a wrapper of
``publish`` waits until the client is gone), never on a sleep.
"""

import asyncio
import json
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import streams as jstreams
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import qos, streams
from penroz_tpu_torch.serve import metrics as serve_metrics
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
MODEL = "streamgpt"
PROMPT = [1, 2, 3]


@pytest.fixture(autouse=True)
def _fresh(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    for mod in (faults, jfaults, qos, streams, jstreams):
        mod.reset()
    yield
    DS.reset()
    for mod in (faults, jfaults, qos, streams, jstreams):
        mod.reset()


class _Req:
    cancelled = False


def _until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.005)


# -- the ring -----------------------------------------------------------------

class _Consumers:
    """One consumer of each package's kind: the JAX session's asyncio
    queue on a loop, the port's ``queue.Queue``."""

    def __init__(self, pkg):
        import queue
        self.pkg = pkg
        self.loop = asyncio.new_event_loop() if pkg is jstreams else None
        self.q = asyncio.Queue() if self.loop else queue.Queue()

    def resume(self, sess, from_seq):
        if self.loop:
            return sess.resume(self.loop, self.q, from_seq)
        return sess.resume(self.q, from_seq)

    def drain(self):
        if self.loop:
            self.loop.run_until_complete(asyncio.sleep(0.01))
        out = []
        while not self.q.empty():
            out.append(self.q.get_nowait())
        return out

    def close(self):
        if self.loop:
            self.loop.close()


def _ring_sequence(pkg, env):
    """Publish, reattach behind and inside the ring, publish on; expire a
    detached stream; refuse a detach with no grace or after the end."""
    out = []
    env.setenv(pkg.REPLAY_ENV, "4")
    env.delenv(pkg.DETACH_MS_ENV, raising=False)
    c = _Consumers(pkg)
    try:
        sess = pkg.StreamSession("r1", _Req())
        for i in range(10):
            sess.publish("token", 100 + i)
        with pytest.raises(pkg.ReplayGapError):
            c.resume(sess, 2)
        out.append(c.resume(sess, 7))
        sess.publish("token", 110)
        sess.publish("done", None)
        out += [c.drain(), sess.snapshot()]
        out.append(sess.try_detach())         # terminal: no detach
        req = _Req()
        sess2 = pkg.StreamSession("r2", req)
        sess2.publish("token", 0)
        out.append(sess2.try_detach())        # no grace: the caller cancels
        env.setenv(pkg.DETACH_MS_ENV, "20")
        out.append(sess2.try_detach())
        _until(lambda: req.cancelled, "the grace never expired")
        out.append(sess2.snapshot())
        with pytest.raises(pkg.ReplayGapError, match="expired"):
            c.resume(sess2, 0)
    finally:
        c.close()
    return out


def test_ring_sequences_match_jax(monkeypatch):
    """The same sequence on each package's ``StreamSession``: a reattach
    behind the 4-event ring raises ``ReplayGapError``, one inside it
    returns the ring's backlog and then the live events, every sequence
    number once; a terminal stream and a grace of 0 refuse to detach; a
    detached stream's grace expires into ``req.cancelled`` and a later
    reattach raises."""
    got = {}
    for pkg in (jstreams, streams):
        with monkeypatch.context() as env:
            got[pkg] = _ring_sequence(pkg, env)
    assert got[streams] == got[jstreams]
    backlog, live = got[streams][0], got[streams][1]
    assert [e[0] for e in backlog + live] == list(range(7, 12))
    assert live[-1] == (11, "done", None)


def test_registry_counts_and_purges_like_jax(monkeypatch):
    """Detaches, resumes and expiries count in the registry alike; a
    discarded session is gone; ``stats()`` has the JAX keys and values."""
    got = {}
    for pkg in (jstreams, streams):
        with monkeypatch.context() as env:
            env.setenv(pkg.DETACH_MS_ENV, "60000")
            env.setenv(pkg.REPLAY_ENV, "8")
            pkg.reset()
            c = _Consumers(pkg)
            sess = pkg.STREAMS.register("a", _Req())
            sess.publish("token", 1)
            sess.try_detach()
            detached = pkg.STREAMS.detached_count()
            c.resume(sess, 0)
            pkg.STREAMS.register("b", _Req())
            pkg.STREAMS.discard("b")
            got[pkg] = (detached, pkg.STREAMS.detached_count(),
                        pkg.STREAMS.get("b"), pkg.STREAMS.stats())
            c.close()
            pkg.reset()
    assert got[streams] == got[jstreams]
    assert got[streams][3]["detaches"] == got[streams][3]["resumes"] == 1


def test_seam_is_exactly_once_under_concurrent_publishing(monkeypatch):
    """A reattach racing a publishing thread: the backlog and the live
    queue together hold every sequence number from ``from_seq`` once."""
    import queue
    monkeypatch.setenv(streams.REPLAY_ENV, "4096")
    sess = streams.StreamSession("race", _Req())
    n, started = 2000, threading.Event()

    def produce():
        started.set()
        for i in range(n):
            sess.publish("token", i)
        sess.publish("done", None)

    t = threading.Thread(target=produce)
    t.start()
    started.wait()
    q: queue.Queue = queue.Queue()
    while sess.snapshot()["next_seq"] < 50:
        time.sleep(0)
    backlog = sess.resume(q, 10)
    t.join(WAIT_S)
    seqs = [e[0] for e in backlog]
    while not q.empty():
        seqs.append(q.get_nowait()[0])
    assert seqs == list(range(10, n + 1))


# -- over HTTP -----------------------------------------------------------------

@pytest.fixture
def jmodel(workdir):
    model = JModel(MODEL, JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


@pytest.fixture
def server(jmodel, monkeypatch):
    from penroz_tpu_torch.serve.app import create_app
    for name, value in (("PENROZ_CONTINUOUS_BATCHING", "1"),
                        ("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_SCHED_SUPERSTEP", "1")):
        monkeypatch.setenv(name, value)
    serve_metrics.reset()
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.server_address[:2]
    srv.shutdown()
    srv.server_close()
    thread.join(WAIT_S)


def _payload(max_new=6, stream=True):
    return {"model_id": MODEL, "input": [PROMPT], "block_size": BLOCK,
            "max_new_tokens": max_new, "temperature": 0.0, "stream": stream}


def _get(addr, path):
    try:
        with urllib.request.urlopen("http://%s:%d%s" % (*addr, path),
                                    timeout=WAIT_S) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post_stream(addr, rid, max_new=6):
    req = urllib.request.Request(
        "http://%s:%d/generate/" % addr, method="POST",
        data=json.dumps(_payload(max_new)).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
        assert resp.status == 200
        return [int(t) for t in resp.read().decode().split()]


def _seq_lines(text):
    return [(int(s), v) for s, v in (ln.split(":", 1)
                                     for ln in text.strip().split("\n"))]


def _greedy(jmodel, max_new):
    return jmodel.generate_tokens([PROMPT], BLOCK, max_new,
                                  temperature=0.0)[len(PROMPT):]


def test_http_resume_replays_a_finished_stream(server, jmodel):
    """A finished stream lingers: ``from_seq=0`` replays every event as
    ``seq:value`` lines ending ``N:done``, equal to the live stream and the
    JAX greedy tokens; ``from_seq=3`` the suffix; an unknown id 404, a
    ``from_seq`` that is not an integer or negative 422."""
    streamed = _post_stream(server, "resume-a")
    assert streamed == _greedy(jmodel, 6)
    status, text = _get(server, "/generate/resume-a/stream?from_seq=0")
    assert status == 200
    events = _seq_lines(text)
    assert [s for s, _ in events] == list(range(7))
    assert [int(v) for _, v in events[:-1]] == streamed
    assert events[-1][1] == "done"
    status, text = _get(server, "/generate/resume-a/stream?from_seq=3")
    assert [s for s, _ in _seq_lines(text)] == list(range(3, 7))
    assert _get(server, "/generate/never-was/stream?from_seq=0")[0] == 404
    for bad in ("soon", "-3"):
        assert _get(server, f"/generate/resume-a/stream?from_seq={bad}"
                    )[0] == 422


def test_http_resume_behind_the_ring_is_410(server, monkeypatch):
    monkeypatch.setenv(streams.REPLAY_ENV, "2")
    _post_stream(server, "tiny-ring")
    status, body = _get(server, "/generate/tiny-ring/stream?from_seq=0")
    assert status == 410 and "replay ring" in json.loads(body)["detail"]
    assert _get(server, "/generate/tiny-ring/stream?from_seq=5")[0] == 200


def _gate_publishing(monkeypatch, rid, after, until):
    """Hold the worker's publishing of ``rid``'s events from sequence
    number ``after`` on until ``until(session)`` holds: the generation
    waits for the test's client, never the other way round."""
    real = streams.StreamSession.publish

    def publish(self, kind, value):
        if self.request_id == rid and self._next_seq >= after:
            _until(lambda: until(self), f"gate of {rid} never opened")
        real(self, kind, value)

    monkeypatch.setattr(streams.StreamSession, "publish", publish)


def _open_and_drop(addr, rid, max_new):
    """POST a streamed /generate/, read its first line, then reset the
    connection (SO_LINGER 0): the server's next writes fail."""
    sock = socket.create_connection(addr, timeout=WAIT_S)
    body = json.dumps(_payload(max_new)).encode()
    sock.sendall(b"POST /generate/ HTTP/1.1\r\nHost: x\r\n"
                 b"Content-Type: application/json\r\n"
                 + f"X-Request-Id: {rid}\r\nContent-Length: {len(body)}"
                   f"\r\n\r\n".encode() + body)
    f = sock.makefile("rb")
    assert f.readline().split()[1] == b"200"
    while f.readline() not in (b"\r\n", b""):
        pass
    first = int(f.readline())
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                    b"\x01\x00\x00\x00\x00\x00\x00\x00")
    f.close()
    sock.close()
    return first


def test_http_detach_and_reconnect_exactly_once(server, jmodel,
                                                monkeypatch):
    """With a grace, a client that drops after its first token detaches the
    stream: the row decodes on into the ring; a reconnect at
    ``from_seq=1`` reads every later event once, and the first token plus
    the resumed ones are the JAX greedy tokens.  The counters see one
    detach and one resume, no expiry."""
    monkeypatch.setenv(streams.DETACH_MS_ENV, "60000")
    rid = "reconnect-1"
    _gate_publishing(monkeypatch, rid, 2,
                     lambda s: s.snapshot()["detached"])
    first = _open_and_drop(server, rid, 8)
    _until(lambda: streams.STREAMS.get(rid) is not None
           and streams.STREAMS.get(rid).snapshot()["terminal"],
           "the detached row did not decode to its end")
    assert not streams.STREAMS.get(rid).req.cancelled
    status, text = _get(server, f"/generate/{rid}/stream?from_seq=1")
    assert status == 200
    events = _seq_lines(text)
    assert [s for s, _ in events] == list(range(1, 9))
    assert events[-1][1] == "done"
    assert [first] + [int(v) for _, v in events[:-1]] == _greedy(jmodel, 8)
    stats = json.loads(_get(server, "/serving_stats/")[1])["streams"]
    assert (stats["detaches"], stats["resumes"], stats["expired"]) == (1, 1, 0)
    metrics = _get(server, "/metrics")[1]
    assert "penroz_stream_detaches_total 1" in metrics
    assert "penroz_stream_resumes_total 1" in metrics


def test_http_grace_expiry_cancels_the_row(server, monkeypatch):
    """No reconnect within the grace: the ordinary cancellation retires the
    row early (no page or pin left, a clean audit) and a reattach is 404
    or 410."""
    monkeypatch.setenv(streams.DETACH_MS_ENV, "50")
    rid = "abandoned-1"
    _gate_publishing(monkeypatch, rid, 2, lambda s: s.expired)
    _open_and_drop(server, rid, 12)
    _until(lambda: streams.STREAMS.stats()["expired"] == 1, "no expiry")
    _until(lambda: DS.serving_stats()["active_rows"] == 0,
           "the expired row was not retired")
    assert _get(server, f"/generate/{rid}/stream?from_seq=0")[0] in (404,
                                                                     410)
    stats = DS.serving_stats()
    assert stats["decode_tokens"] < 12
    for engine in DS._live_engines():
        assert engine._ledger.audit("test.expired") == []
        snap = engine.memory_snapshot()["pool_pages"]
        assert snap["row"] == snap["prefix_pinned"] == 0
    assert "penroz_stream_detach_expired_total 1" in _get(server,
                                                          "/metrics")[1]


def test_http_zero_grace_disconnect_cancels(server, monkeypatch):
    """Without ``PENROZ_STREAM_DETACH_MS`` a disconnect cancels the row, as
    before, and the stream is gone (404)."""
    rid = "dropped-1"
    _gate_publishing(monkeypatch, rid, 2,
                     lambda s: s.req.cancelled or s.terminal)
    _open_and_drop(server, rid, 12)
    _until(lambda: DS.serving_stats()["active_rows"] == 0
           and streams.STREAMS.get(rid) is None, "the row was not cancelled")
    assert _get(server, f"/generate/{rid}/stream?from_seq=0")[0] == 404
    assert streams.STREAMS.stats()["detaches"] == 0
    assert DS.serving_stats()["decode_tokens"] < 12


def test_http_stream_resume_fault(server, monkeypatch):
    """An injected ``stream.resume`` failure is the HTTP 500; the fault is
    one-shot and the stream stays resumable."""
    streamed = _post_stream(server, "faulty")
    monkeypatch.setenv(faults.ENV, "stream.resume:raise@1")
    faults.reset()
    assert _get(server, "/generate/faulty/stream?from_seq=0")[0] == 500
    status, text = _get(server, "/generate/faulty/stream?from_seq=0")
    assert status == 200
    assert [int(v) for _, v in _seq_lines(text)[:-1]] == streamed
