"""The port's fault-injection switchboard (penroz_tpu_torch/utils/faults.py)
against the JAX package's: the cases of tests/test_faults.py on the
port's module (exact-Nth and open-ended raise rules, sleep rules, rule
composition, unparseable rules, the disabled fast path, ``reset``), one
spec and one call sequence giving the same raise pattern in both modules,
and the port's ``ckpt.write`` (the write rolled back, no file left) and
``data.download`` (the attempt fails, the API layer retries) sites."""

import glob
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _clean_registry(monkeypatch):
    monkeypatch.delenv(faults.ENV, raising=False)
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


def test_same_variable_as_the_jax_package():
    assert faults.ENV == jfaults.ENV == "PENROZ_FAULT_INJECT"


def test_disabled_is_noop_and_counts_nothing():
    for _ in range(3):
        faults.check("decode.step")
    assert faults.call_count("decode.step") == 0


def test_raise_on_exact_nth_call(monkeypatch):
    monkeypatch.setenv(faults.ENV, "decode.step:raise@2")
    faults.check("decode.step")
    with pytest.raises(faults.InjectedFault, match="decode.step"):
        faults.check("decode.step")
    faults.check("decode.step")
    assert faults.call_count("decode.step") == 3


def test_open_ended_raise_from_nth_call(monkeypatch):
    monkeypatch.setenv(faults.ENV, "s:raise@2+")
    faults.check("s")
    for _ in range(3):
        with pytest.raises(faults.InjectedFault):
            faults.check("s")


def test_rules_compose_and_sites_are_independent(monkeypatch):
    monkeypatch.setenv(faults.ENV, "a:raise@1,a:raise@2,b:raise@1")
    with pytest.raises(faults.InjectedFault):
        faults.check("a")
    with pytest.raises(faults.InjectedFault):
        faults.check("a")
    faults.check("a")
    with pytest.raises(faults.InjectedFault):
        faults.check("b")
    faults.check("unarmed.site")


def test_sleep_rule_sleeps_roughly_the_requested_ms(monkeypatch):
    monkeypatch.setenv(faults.ENV, "slow:sleep@50")
    t0 = time.monotonic()
    faults.check("slow")
    assert time.monotonic() - t0 >= 0.045


def test_unparseable_rules_are_ignored_not_fatal(monkeypatch):
    monkeypatch.setenv(faults.ENV, "garbage,a:explode@1,a:raise@nan,"
                                   "a:raise@1")
    with pytest.raises(faults.InjectedFault):
        faults.check("a")


def test_reset_clears_counters_and_respec(monkeypatch):
    monkeypatch.setenv(faults.ENV, "s:raise@1")
    with pytest.raises(faults.InjectedFault):
        faults.check("s")
    faults.reset()
    with pytest.raises(faults.InjectedFault):
        faults.check("s")


@pytest.mark.parametrize("spec", [
    "s:raise@3", "s:raise@2+", "s:raise@1,s:raise@4,t:raise@2",
    "s:sleep@1,s:raise@2", "s:raise@0+,t:bogus@1", "t:raise@1", ""])
def test_raise_pattern_matches_the_jax_module(monkeypatch, spec):
    """One spec and one call sequence over two sites raise on the same
    calls in both modules, and count the same calls."""
    monkeypatch.setenv(faults.ENV, spec)
    calls = ["s", "t", "s", "s", "t", "s", "s", "t"]

    def pattern(module):
        out = []
        for site in calls:
            try:
                module.check(site)
                out.append(False)
            except module.InjectedFault:
                out.append(True)
        return out, [module.call_count(s) for s in ("s", "t")]

    assert pattern(faults) == pattern(jfaults)


def test_ckpt_write_fault_rolls_back_cleanly(workdir, monkeypatch):
    """An injected write failure reaches the caller and leaves no file:
    neither the target nor its temporary sibling; the next write
    succeeds."""
    from penroz_tpu_torch.utils import checkpoint
    monkeypatch.setattr(checkpoint, "SHM_PATH", str(workdir / "shm"))
    monkeypatch.setenv(faults.ENV, "ckpt.write:raise@1")
    tree = {"status": {"code": "Created"},
            "params": {"w": np.ones(4, np.float32)}}
    with pytest.raises(faults.InjectedFault):
        checkpoint.save("faulty", tree, sync_flush=True)
    leftovers = (glob.glob(os.path.join(checkpoint.SHM_PATH, "models", "*"))
                 + glob.glob("models/*"))
    assert leftovers == [], leftovers
    checkpoint.save("faulty", tree, sync_flush=True)
    assert checkpoint.load("faulty")["status"]["code"] == "Created"


def test_data_download_fault_fails_the_attempt(workdir, monkeypatch):
    """``data.download:raise@1`` fails the first attempt before the source
    is touched; POST /dataset/'s retry then completes, and the shards are
    written."""
    import sys
    import types
    from penroz_tpu_torch.serve.app import create_app
    rows = {"text": ["héllo wörld", "abc"]}
    fake = types.ModuleType("datasets")
    fake.load_dataset = lambda path, name=None, split="train": rows
    monkeypatch.setitem(sys.modules, "datasets", fake)
    monkeypatch.setenv(faults.ENV, "data.download:raise@1")
    monkeypatch.setenv("PENROZ_DOWNLOAD_RETRIES", "2")
    monkeypatch.setenv("PENROZ_DOWNLOAD_BACKOFF_S", "0.01")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address[:2]
    try:
        req = urllib.request.Request(
            base + "/dataset/", method="POST",
            data=json.dumps({"dataset_id": "fd", "encoding": "byte",
                             "path": "x", "split": "train",
                             "shard_size": 8}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 202
        assert srv.join_training(timeout=60)
        with urllib.request.urlopen(base + "/dataset/?dataset_id=fd",
                                    timeout=60) as resp:
            listing = json.loads(resp.read())
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(10)
    assert not thread.is_alive()
    assert listing["download"]["state"] == "complete"
    assert listing["download"]["attempts"] == 2
    assert faults.call_count("data.download") == 2
    assert len(listing["files"]) == 3     # 13 + 4 bytes + 2 EOTs in 8s
