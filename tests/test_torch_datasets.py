"""The port's ``/dataset/`` routes and ``Downloader`` on a fake
``datasets`` module (the network fetch is faked; tokenizing and sharding
are real): shards byte for byte the JAX package's ``Downloader``'s from
the same source; ``POST`` 202 and a 409 while the same id downloads;
a retry after one failed attempt; the terminal ``failed`` with its error,
also where ``datasets`` is missing, the server still serving; ``GET``'s
listing and status; ``DELETE`` 204."""

import json
import os
import sys
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from penroz_tpu.data.loaders import Downloader as JDownloader
from penroz_tpu_torch.data import loaders as tloaders
from penroz_tpu_torch.serve.app import create_app

TEXTS = ["hello world", "héllo, wörld — again", "", "x" * 150,
         "the quick brown fox"]


def _fake(monkeypatch, load):
    monkeypatch.setitem(sys.modules, "datasets",
                        types.SimpleNamespace(load_dataset=load))


@pytest.fixture
def server(workdir, monkeypatch):
    monkeypatch.setenv("PENROZ_DOWNLOAD_BACKOFF_S", "0.01")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield "http://%s:%d" % srv.server_address[:2]
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert srv.join_training(timeout=30)


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _body(dataset_id, **kw):
    return {"dataset_id": dataset_id, "encoding": "byte", "path": "p",
            "name": None, "split": "train", "shard_size": 64, **kw}


def _settled(base, dataset_id, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        status, text = _call(base, "GET", f"/dataset/?dataset_id={dataset_id}")
        assert status == 200
        doc = json.loads(text)
        if doc["download"] and doc["download"]["state"] != "downloading":
            return doc
        time.sleep(0.02)
    raise AssertionError(f"download of {dataset_id} never settled")


def test_shards_byte_equal_to_jax(workdir, monkeypatch):
    calls = []

    def load(path, name, split):
        calls.append((path, name, split))
        return {"text": TEXTS}

    _fake(monkeypatch, load)
    JDownloader("j", shard_size=64, encoding="byte").download("p", "c", "s")
    tloaders.Downloader("t", shard_size=64, encoding="byte").download(
        "p", "c", "s")
    assert calls == [("p", "c", "s")] * 2
    jfiles = sorted(f for f in os.listdir("data") if f.startswith("j_"))
    tfiles = sorted(f for f in os.listdir("data") if f.startswith("t_"))
    assert len(jfiles) == len(tfiles) > 2  # full shards and a partial one
    assert tloaders.Loader("t").list() == tfiles
    for jf, tf in zip(jfiles, tfiles):
        assert jf[2:] == tf[2:]
        with open(os.path.join("data", jf), "rb") as a, \
                open(os.path.join("data", tf), "rb") as b:
            assert a.read() == b.read(), tf
    assert not [f for f in os.listdir("data") if f.endswith(".tmp")]


def test_download_202_409_list_and_delete(server, monkeypatch):
    entered, release = threading.Event(), threading.Event()

    def load(path, name, split):
        entered.set()
        assert release.wait(30)
        return {"text": TEXTS}

    _fake(monkeypatch, load)
    status, text = _call(server, "POST", "/dataset/", _body("ds"))
    assert status == 202, text
    assert entered.wait(30)
    status, text = _call(server, "GET", "/dataset/?dataset_id=ds")
    assert json.loads(text) == {"files": [], "download": {
        "state": "downloading", "attempts": 1, "error": None}}
    assert _call(server, "POST", "/dataset/", _body("ds"))[0] == 409
    release.set()
    doc = _settled(server, "ds")
    assert doc["download"] == {"state": "complete", "attempts": 1,
                               "error": None}
    assert doc["files"] == tloaders.Loader("ds").list() and doc["files"]
    assert _call(server, "POST", "/dataset/", _body("ds"))[0] == 202
    assert _settled(server, "ds")["download"]["state"] == "complete"
    assert _call(server, "DELETE", "/dataset/?dataset_id=ds")[0] == 204
    status, text = _call(server, "GET", "/dataset/?dataset_id=ds")
    assert json.loads(text)["files"] == []
    # validation: a missing field, a wrong type, no dataset_id, an
    # encoding the port does not carry
    body = _body("ds")
    del body["split"]
    assert _call(server, "POST", "/dataset/", body)[0] == 422
    assert _call(server, "POST", "/dataset/",
                 _body("ds", shard_size="big"))[0] == 422
    assert _call(server, "GET", "/dataset/")[0] == 422
    assert _call(server, "DELETE", "/dataset/")[0] == 422
    assert _call(server, "POST", "/dataset/",
                 _body("ds", encoding="tiktoken/gpt2"))[0] == 400


def test_download_retries_after_a_failed_attempt(server, monkeypatch):
    monkeypatch.setenv("PENROZ_DOWNLOAD_RETRIES", "3")
    attempts = []

    def load(path, name, split):
        attempts.append(1)
        if len(attempts) == 1:
            raise ConnectionError("transient")
        return {"text": TEXTS}

    _fake(monkeypatch, load)
    assert _call(server, "POST", "/dataset/", _body("retry"))[0] == 202
    doc = _settled(server, "retry")
    assert doc["download"] == {"state": "complete", "attempts": 2,
                               "error": None}
    assert doc["files"]


def test_download_fails_terminally(server, monkeypatch):
    monkeypatch.setenv("PENROZ_DOWNLOAD_RETRIES", "2")

    def load(path, name, split):
        raise ConnectionError("no route to host")

    _fake(monkeypatch, load)
    assert _call(server, "POST", "/dataset/", _body("dead"))[0] == 202
    doc = _settled(server, "dead")
    assert doc == {"files": [], "download": {
        "state": "failed", "attempts": 2,
        "error": "ConnectionError: no route to host"}}


def test_download_without_the_datasets_module(server, monkeypatch):
    """Without ``datasets`` the download ends ``failed`` with a
    ModuleNotFoundError, and the server goes on."""
    monkeypatch.setenv("PENROZ_DOWNLOAD_RETRIES", "1")
    monkeypatch.setitem(sys.modules, "datasets", None)
    assert _call(server, "POST", "/dataset/", _body("nomod"))[0] == 202
    doc = _settled(server, "nomod")
    assert doc["download"]["state"] == "failed"
    assert doc["download"]["error"].startswith("ModuleNotFoundError")
    assert _call(server, "GET", "/healthz")[0] == 200
