"""The port's write-ahead journal (serve/journal.py) and restart recovery
(``TierStore.recover``) against the JAX package's, on the CPU.

* Frames: the same records give the same bytes, and a journal written by
  either package replays in the other; torn tails and flipped bytes
  truncate alike; the fsync policies, compaction and a contained
  ``journal.append`` fault behave as in the JAX package.
* Recovery: the same journal and tier directory recover to the same
  registry and summary in both packages (disk sessions re-admitted,
  volatile, dropped, stale, missing and corrupt ones not, orphans swept,
  quota overrides applied, a ``journal.replay`` fault recovering empty),
  also across the packages.
* Restart: a session hibernated to disk survives a simulated kill and
  ``create_app`` (``/sessions/``, ``/serving_stats/``, ``/debug/dump``),
  and a real ``SIGKILL`` of a serving process, waking with the JAX
  engine's greedy tokens.  The subprocesses run under time limits of
  their own.
"""

import json
import os
import queue
import signal
import struct
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import journal as jjournal
from penroz_tpu.serve import qos as jqos
from penroz_tpu.serve import tierstore as jtier
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import journal as tjournal
from penroz_tpu_torch.serve import qos, streams
from penroz_tpu_torch.serve import tierstore as ttier
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
MODEL = "durgpt"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# package -> (journal, tierstore, checkpoint, faults, qos)
PKGS = {"jax": (jjournal, jtier, jckpt, jfaults, jqos),
        "torch": (tjournal, ttier, tckpt, faults, qos)}


@pytest.fixture(autouse=True)
def _fresh(workdir, tmp_path, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    monkeypatch.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / "tier"))
    mods = (faults, jfaults, qos, jqos, ttier, jtier, tjournal, jjournal,
            streams)
    for mod in mods:
        mod.reset()
    yield
    DS.reset()
    JDS.reset()
    for mod in mods:
        mod.reset()


def _arm(monkeypatch, tmp_path, name):
    """The journal of package ``name`` at a path of its own, fsync always,
    and a tier directory of its own."""
    path = tmp_path / name / "serve.journal"
    monkeypatch.setenv("PENROZ_JOURNAL_PATH", str(path))
    monkeypatch.setenv("PENROZ_JOURNAL_FSYNC", "always")
    monkeypatch.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / name / "tier"))
    return path


RECORDS = [("register", {"session_id": "s1", "tokens": [1, 2, 3],
                         "tenant": "acme", "nbytes": 512,
                         "model_stamp": 1712.25, "quantized": False}),
           ("demote", {"session_id": "s1", "tier": "disk", "nbytes": 512}),
           ("quota", {"tenant": "acme", "rate": 99.0, "tier_mb": None}),
           ("adapter", {"adapter_id": "a1", "model_id": "m"}),
           ("drop", {"session_id": "sé", "reason": "api"})]


# -- frames -------------------------------------------------------------------

def test_frames_equal_jax_byte_for_byte(tmp_path, monkeypatch):
    """The same records at the same clock give the same file, frame for
    frame, and ``_encode`` the same bytes."""
    files = {}
    for name, (jmod, *_rest) in PKGS.items():
        path = _arm(monkeypatch, tmp_path, name)
        monkeypatch.setattr(jmod.time, "time", lambda: 1760000000.5)
        j = jmod.Journal()
        for kind, fields in RECORDS:
            assert j.append(kind, **fields)
        j.close()
        files[name] = path.read_bytes()
        monkeypatch.undo()
        monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    assert files["torch"] == files["jax"] and len(files["jax"]) > 40
    for kind, fields in RECORDS:
        rec = dict(fields, t=kind, ts=1.0)
        assert tjournal._encode(rec) == jjournal._encode(rec)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_journal_crosses_between_packages(tmp_path, monkeypatch, writer):
    """A journal written by either package replays in the other, records
    and stats alike."""
    reader = "torch" if writer == "jax" else "jax"
    _arm(monkeypatch, tmp_path, "shared")
    w = PKGS[writer][0].Journal()
    for kind, fields in RECORDS:
        assert w.append(kind, **fields)
    w.close()
    r = PKGS[reader][0].Journal()
    got = r.replay()
    assert [(rec.pop("t"), rec.pop("ts") > 0) for rec in got] == \
        [(kind, True) for kind, _ in RECORDS]
    assert got == [fields for _, fields in RECORDS]
    assert r.stats()["records"] == len(RECORDS)


def _torn_tail(jmod, path):
    j = jmod.Journal()
    for i in range(3):
        j.append("register", session_id=f"s{i}")
    j.close()
    good = os.path.getsize(path)
    with open(path, "ab") as fh:
        fh.write(struct.pack("<II", 64, 0xDEADBEEF) + b"torn")
    out = [[r["session_id"] for r in j.replay()], j.bad_records,
           j.truncated_bytes, os.path.getsize(path) == good,
           len(j.replay()), j.bad_records,
           j.append("register", session_id="s3")]
    j.close()
    out.append([r["session_id"] for r in j.replay()])
    return out


def _bitflip(jmod, path):
    j = jmod.Journal()
    for i in range(3):
        j.append("register", session_id=f"s{i}")
    j.close()
    raw = bytearray(path.read_bytes())
    len0, _ = struct.unpack_from("<II", raw, 0)
    raw[8 + len0 + 8 + 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    # the first frame's length varies with its timestamp's repr, so the
    # truncation is held to where it must land, not to a byte count
    return [[r["session_id"] for r in j.replay()], j.bad_records,
            os.path.getsize(path) == 8 + len0,
            j.truncated_bytes == len(raw) - 8 - len0]


def _policies(jmod, path, env):
    out = []
    for policy in ("always", "batch", "off", "bogus"):
        env.setenv("PENROZ_JOURNAL_FSYNC", policy)
        j = jmod.Journal()
        out += [jmod.fsync_policy(),
                all(j.append("register", session_id=f"{policy}{i}")
                    for i in range(5))]
        j.close()
    out.append(len(jmod.Journal().replay()))
    return out


def _compaction(jmod, path, env):
    j = jmod.Journal()
    for i in range(80):
        j.append("register", session_id=f"s{i}")
    for i in range(70):
        j.append("drop", session_id=f"s{i}")
    live = [{"t": "register", "session_id": f"s{i}"} for i in range(70, 80)]
    out = [j.should_compact(len(live)), j.compact(live)]
    stats = j.stats()
    out += [stats["compactions"], stats["records"],
            [r["session_id"] for r in j.replay()], j.should_compact(0)]
    env.setenv("PENROZ_JOURNAL_COMPACT_RATIO", "0.95")
    out.append(jmod.Journal().should_compact(0))
    return out


def _append_fault(jmod, path, env):
    fmod = faults if jmod is tjournal else jfaults
    env.setenv(fmod.ENV, "journal.append:raise@1")
    fmod.reset()
    j = jmod.Journal()
    out = [j.append("register", session_id="dropped"), j.append_errors,
           j.append("register", session_id="kept")]
    j.close()
    out.append([r["session_id"] for r in j.replay()])
    stats = j.stats()
    stats.pop("replay_ms")
    return out + [stats]


@pytest.mark.parametrize("case", ["torn_tail", "bitflip", "policies",
                                  "compaction", "append_fault"])
def test_journal_cases_match_jax(tmp_path, monkeypatch, case):
    """Torn-tail truncation, a mid-file flipped byte, the fsync policies,
    dead-ratio compaction and a contained ``journal.append`` fault: the
    same observations in both packages."""
    got = {}
    for name, (jmod, *_rest) in PKGS.items():
        with monkeypatch.context() as env:
            path = _arm(env, tmp_path, name)
            fn = {"torn_tail": lambda: _torn_tail(jmod, path),
                  "bitflip": lambda: _bitflip(jmod, path),
                  "policies": lambda: _policies(jmod, path, env),
                  "compaction": lambda: _compaction(jmod, path, env),
                  "append_fault": lambda: _append_fault(jmod, path, env)}
            got[name] = fn[case]()
    assert got["torch"] == got["jax"]


def test_disabled_journal_is_a_noop():
    j = tjournal.Journal()
    assert os.environ.get("PENROZ_JOURNAL_PATH") is None
    assert not j.enabled() and j.append("register", session_id="s1") is False
    assert j.replay() == [] and j.stats()["appended"] == 0


# -- restart recovery ---------------------------------------------------------

def _blob(pages=2, page_size=4):
    plane = np.arange(pages * page_size * 2, dtype=np.float32).reshape(
        1, pages * page_size, 2)
    return {"page_size": page_size, "pages": pages,
            "length": pages * page_size, "quantized": False,
            "k": [plane], "v": [plane + 1]}


def _stamp_model(model_id="m"):
    """A checkpoint file for the model stamp check; its mtime (the same
    file in both packages: one shm dir)."""
    path = tckpt.source_path(model_id)
    assert path == jckpt._source_path(model_id)
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "wb") as fh:
            fh.write(b"stamp")
    return os.path.getmtime(path)


def _journal_disk_session(jmod, ckpt, sid, tokens, stamp, *, write_blob=True,
                          model_id="m"):
    jmod.JOURNAL.append(
        "register", session_id=sid, tenant="default", model_id=model_id,
        model_stamp=stamp, tokens=list(tokens), kv_len=len(tokens) // 4 * 4,
        page_size=4, quantized=False, nbytes=1024, replica="r0")
    jmod.JOURNAL.append("demote", session_id=sid, tier="disk", nbytes=1024)
    if write_blob:
        ckpt.save_tier_blob(sid, _blob(len(tokens) // 4))


def _recover_everything(pkg, writer=None):
    """Write one journal and tier dir with package ``writer``'s modules
    (default: ``pkg``), recover with ``pkg``'s: the summary (without its
    ms), the registry, the blobs left, the quota overrides."""
    jmod, tmod, ckpt, *_ = PKGS[writer or pkg]
    stamp = _stamp_model()
    _journal_disk_session(jmod, ckpt, "survivor", range(8), stamp)
    _journal_disk_session(jmod, ckpt, "stale", range(8), stamp + 123.0)
    _journal_disk_session(jmod, ckpt, "missing", range(8), stamp,
                          write_blob=False)
    _journal_disk_session(jmod, ckpt, "corrupt", range(8, 16), stamp)
    with open(ckpt.tier_blob_path("corrupt"), "wb") as fh:
        fh.write(b"not a container")
    for sid, tier in (("volatile", "host"), ("gone", None)):
        jmod.JOURNAL.append(
            "register", session_id=sid, tenant="default", model_id="m",
            model_stamp=stamp, tokens=list(range(8)), kv_len=8, page_size=4,
            quantized=False, nbytes=256, replica="r0")
        if tier:
            jmod.JOURNAL.append("demote", session_id=sid, tier=tier,
                                nbytes=256)
        else:
            jmod.JOURNAL.append("drop", session_id=sid, reason="api")
    jmod.JOURNAL.append("quota", tenant="acme", rate=50.0)
    jmod.JOURNAL.append("quota", tenant="acme", rate=125.0)
    jmod.JOURNAL.append("quota", tenant="acme", tier_mb=7.5)
    jmod.JOURNAL.append("adapter", adapter_id="lora1", model_id="m")
    ckpt.save_tier_blob("unreferenced", _blob())
    with open(os.path.join(ckpt.tier_dir(),
                           "tierblob_torn.ckpt.0123456789ab"), "wb") as fh:
        fh.write(b"half-written")
    jmod.JOURNAL.close()
    jmod, tmod, ckpt, _, qmod = PKGS[pkg]
    summary = tmod.TIERS.recover()
    summary.pop("replay_ms")
    rec, depth = tmod.TIERS.match(list(range(9)), model_id="m",
                                  model_stamp=stamp, page_size=4,
                                  quantized=False)
    blob = tmod.TIERS.fetch("survivor")
    second = tmod.TIERS.recover()
    return [summary, [(r["session_id"], r["tier"], r["tokens"], r["replica"])
                      for r in tmod.TIERS.list_sessions()],
            (rec.session_id, depth), np.asarray(blob["v"][0]).tolist(),
            ckpt.list_tier_blob_ids(), qmod.QUOTAS.rate_for("acme"),
            qmod.QUOTAS.tier_bytes_for("acme"),
            {k: second[k] for k in ("sessions_stale", "sessions_blob_missing",
                                    "sessions_blob_corrupt",
                                    "sessions_recovered")}]


@pytest.mark.parametrize("writer", ["same", "jax", "torch"])
def test_recover_matches_jax(tmp_path, monkeypatch, writer):
    """One journal and tier dir of every kind of record: a disk session
    with its blob (re-admitted, content-addressable, its blob readable), a
    host-tier final (volatile), a dropped one, a stale stamp, a missing
    and a corrupt blob (each counted, deleted, re-journaled as dropped so
    a second recovery sees nothing), quota overrides (last one wins), an
    adapter record, an unreferenced blob and a torn temporary (swept).
    Both packages recover it alike, also from the other package's
    files."""
    got = {}
    for name in PKGS:
        with monkeypatch.context() as env:
            _arm(env, tmp_path, f"{name}-{writer}")
            got[name] = _recover_everything(
                name, None if writer == "same" else writer)
    assert got["torch"] == got["jax"]
    summary = got["torch"][0]
    assert (summary["sessions_recovered"], summary["sessions_volatile"],
            summary["sessions_stale"], summary["sessions_blob_missing"],
            summary["sessions_blob_corrupt"], summary["blobs_swept"],
            summary["temp_files_swept"], summary["quota_overrides_replayed"],
            summary["adapter_records_seen"]) == (1, 1, 1, 1, 1, 1, 1, 2, 1)
    assert got["torch"][4] == ["survivor"]


def _replay_fault_and_live_record(name, env):
    jmod, tmod, ckpt, fmod, _ = PKGS[name]
    stamp = _stamp_model()
    _journal_disk_session(jmod, ckpt, "victim", range(8), stamp)
    jmod.JOURNAL.close()
    env.setenv(fmod.ENV, "journal.replay:raise@1")
    fmod.reset()
    first = tmod.TIERS.recover()
    out = [first["replay_errors"], first["sessions_recovered"],
           tmod.TIERS.resident_sessions(), ckpt.list_tier_blob_ids()]
    env.delenv(fmod.ENV)
    fmod.reset()
    # a live record of the same id beats the journal's view of it
    assert tmod.TIERS.register(
        "victim", tenant="default", model_id="m", model_stamp=stamp,
        tokens=tuple(range(12)), kv_len=12, page_size=4, quantized=False,
        nbytes=2048, owner=1, replica="r0")
    second = tmod.TIERS.recover()
    rec = tmod.TIERS.get("victim")
    return out + [second["replay_errors"], second["sessions_recovered"],
                  rec.tier, len(rec.tokens), ckpt.list_tier_blob_ids()]


def test_replay_fault_and_live_registry_match_jax(tmp_path, monkeypatch):
    """A ``journal.replay`` fault recovers to an empty registry and sweeps
    no finished blob; a live record then wins over the journal's, and its
    old disk blob is swept: the same in both packages."""
    got = {}
    for name in PKGS:
        with monkeypatch.context() as env:
            _arm(env, tmp_path, name)
            got[name] = _replay_fault_and_live_record(name, env)
    assert got["torch"] == got["jax"]
    assert got["torch"] == [1, 0, 0, ["victim"], 0, 0, "hbm", 12, []]


# -- restart through create_app -----------------------------------------------

@pytest.fixture
def tier_env(monkeypatch):
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1"),
                        ("PENROZ_PREFIX_CACHE_PAGES", "8"),
                        ("PENROZ_TIER_HOST_MB", "0")):
        monkeypatch.setenv(name, value)
    return monkeypatch


@pytest.fixture
def jmodel(workdir):
    model = JModel(MODEL, JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


PROMPT = [2, 7, 1, 8, 2, 8]


def _collect(engine, prompt, max_new, session_id=None):
    events: queue.Queue = queue.Queue()
    engine.submit(DS.Request(prompt, max_new, None,
                             lambda kind, value: events.put((kind, value)),
                             session_id=session_id))
    tokens = list(prompt)
    while True:
        kind, value = events.get(timeout=WAIT_S)
        if kind == "token":
            tokens.append(value)
        elif kind == "done":
            return tokens
        else:
            raise value


def _until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def test_restart_roundtrip_through_create_app(jmodel, tier_env, tmp_path,
                                              monkeypatch):
    """A session hibernated to disk, a simulated kill (the registry's dicts
    gone, no drop path run, the journal closed), then ``create_app``: the
    recovery ran before the socket bound, ``GET /sessions/`` lists the
    session, ``/serving_stats/`` and ``/debug/dump`` carry the summary, a
    journaled ``tier_mb`` survives, and the next turn wakes from the disk
    blob with the JAX engine's greedy tokens."""
    from penroz_tpu_torch.serve.app import create_app
    _arm(monkeypatch, tmp_path, "restart")
    out = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0.0)
    cont = out + [3]
    base = jmodel.generate_tokens([cont], BLOCK, 3, temperature=0.0)
    engine = DS.DecodeEngine(MODEL, BLOCK, 0.0, None, capacity=2,
                             device="cpu")
    assert _collect(engine, PROMPT, 4, session_id="durable") == out
    _until(lambda: not engine._hib_pending and ttier.TIERS.get("durable")
           is not None and ttier.TIERS.get("durable").tier == "disk",
           "no disk demotion")
    qos.QUOTAS.set_tier_mb("acme", 3.5)
    tjournal.JOURNAL.append("quota", tenant="acme", rate=None, tier_mb=3.5)
    assert tjournal.JOURNAL.stats()["appended"] >= 3
    engine.shutdown()
    with ttier.TIERS._lock:                     # what SIGKILL leaves
        ttier.TIERS._sessions.clear()
        ttier.TIERS._host.clear()
        ttier.TIERS._index.clear()
    tjournal.JOURNAL.close()
    tjournal.reset()
    qos.reset()
    tier_env.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base_url = "http://%s:%d" % srv.server_address[:2]

    def call(method, path, body=None):
        req = urllib.request.Request(
            base_url + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    try:
        status, listing = call("GET", "/sessions/")
        assert status == 200 and listing["sessions_by_tier"]["disk"] == 1
        (sess,) = listing["sessions"]
        assert (sess["session_id"], sess["tier"], sess["replica"]) == (
            "durable", "disk", None)
        stats = call("GET", "/serving_stats/")[1]
        assert stats["restart_recovery"]["sessions_recovered"] == 1
        assert stats["journal"]["enabled"] is True
        assert call("GET", "/debug/dump")[1]["restart_recovery"][
            "sessions_recovered"] == 1
        assert call("GET", "/tenants/")[1]["tenants"]["tier_overrides"] == {
            "acme": 3.5}
        status, body = call("POST", "/generate/", {
            "model_id": MODEL, "input": [cont], "block_size": BLOCK,
            "max_new_tokens": 3, "temperature": 0.0})
        assert status == 200 and body["tokens"] == base
        assert dict(ttier.TIERS.promotions) == {("disk", "ok"): 1}
        # the new process journals on: the quota PUT appends
        before = tjournal.JOURNAL.stats()["appended"]
        assert call("PUT", "/tenants/acme/quota", {
            "tokens_per_s": None, "tier_mb": None})[0] == 200
        assert tjournal.JOURNAL.stats()["appended"] == before + 1
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)


_PHASE1 = """
import queue, sys, time
from penroz_tpu_torch.serve import decode_scheduler as DS, tierstore

prompt = [2, 7, 1, 8, 2, 8]
engine = DS.DecodeEngine("durgpt", 16, 0.0, None, capacity=2, device="cpu")
q = queue.Queue()
engine.submit(DS.Request(prompt, 4, None,
                         lambda kind, value: q.put((kind, value)),
                         session_id="durable"))
tokens = list(prompt)
while True:
    kind, value = q.get(timeout=60)
    if kind == "token":
        tokens.append(value)
    elif kind == "done":
        break
    else:
        raise value
print("TOKENS " + ",".join(map(str, tokens)), flush=True)
deadline = time.monotonic() + 60
while True:
    rec = tierstore.TIERS.get("durable")
    if rec is not None and rec.tier == "disk":
        break
    assert time.monotonic() < deadline, rec
    time.sleep(0.01)
print("HIBERNATED", flush=True)
time.sleep(120)   # held open for the parent's SIGKILL
"""

_PHASE2 = """
import json, queue, sys
from penroz_tpu_torch.serve import app as app_mod
from penroz_tpu_torch.serve import decode_scheduler as DS, tierstore

server = app_mod.create_app(device="cpu")     # the recovery runs here
server.server_close()
summary = dict(tierstore.TIERS.last_recovery)
rec = tierstore.TIERS.get("durable")
assert rec is not None and rec.tier == "disk", (summary, rec)
cont = [int(t) for t in sys.argv[1].split(",")]
engine = DS.DecodeEngine("durgpt", 16, 0.0, None, capacity=2, device="cpu")
q = queue.Queue()
engine.submit(DS.Request(cont, 3, None,
                         lambda kind, value: q.put((kind, value))))
tokens = list(cont)
while True:
    kind, value = q.get(timeout=60)
    if kind == "token":
        tokens.append(value)
    elif kind == "done":
        break
    else:
        raise value
engine.shutdown()
print("RESULT " + json.dumps({
    "recovered": summary["sessions_recovered"],
    "promotions": tierstore.TIERS.promotions.get(("disk", "ok"), 0),
    "tokens": tokens}), flush=True)
"""

# each of the two processes: import, engine build and a few toy steps on
# the CPU take seconds; a hung one is killed at this limit
PHASE_LIMIT_S = 120


def test_sigkill_subprocess_restart_roundtrip(jmodel, tier_env, tmp_path,
                                              monkeypatch):
    """A serving process hibernates a session to disk and is SIGKILLed (no
    exit handler, no drop path); a second process, which shares only the
    journal file and the tier dir with it, recovers the session in
    ``create_app`` and wakes it from disk with the JAX engine's greedy
    tokens.  Each process runs under ``PHASE_LIMIT_S``."""
    journal_path = _arm(monkeypatch, tmp_path, "kill")
    out = jmodel.generate_tokens([PROMPT], BLOCK, 4, temperature=0.0)
    cont = out + [3]
    base = jmodel.generate_tokens([cont], BLOCK, 3, temperature=0.0)
    env = dict(os.environ, PYTHONPATH=REPO_ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               PENROZ_SHM_PATH=tckpt.SHM_PATH,
               PENROZ_JOURNAL_PATH=str(journal_path))
    proc = subprocess.Popen([sys.executable, "-c", _PHASE1], env=env,
                            cwd=str(tmp_path), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    killer = threading.Timer(PHASE_LIMIT_S, proc.kill)
    killer.start()
    lines, first = [], None
    try:
        for line in proc.stdout:
            lines.append(line)
            if line.startswith("TOKENS "):
                first = [int(t) for t in line.split()[1].split(",")]
            if line.startswith("HIBERNATED"):
                break
        else:
            pytest.fail("the first process ended early:\n" + "".join(lines))
    finally:
        killer.cancel()
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)
        proc.stdout.close()
    assert proc.returncode == -signal.SIGKILL
    assert first == out
    done = subprocess.run([sys.executable, "-c", _PHASE2,
                           ",".join(map(str, cont))], env=env,
                          cwd=str(tmp_path), capture_output=True, text=True,
                          timeout=PHASE_LIMIT_S)
    assert done.returncode == 0, done.stdout + done.stderr
    (line,) = [ln for ln in done.stdout.splitlines()
               if ln.startswith("RESULT ")]
    result = json.loads(line.split(" ", 1)[1])
    assert result == {"recovered": 1, "promotions": 1, "tokens": base}
