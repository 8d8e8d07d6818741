"""The port's session tiers (serve/tierstore.py, the engine's hibernation
seam, ``GET``/``DELETE /sessions/``) against the JAX package's, on the CPU.

Two layers:

* the store: the same call sequences on a fresh ``TierStore`` of each
  package (synthetic numpy blobs, no engine) give the same outcomes and the
  same ``stats()``; ``_fingerprints`` hashes alike; tier blobs cross
  between the packages both ways;
* the engine: a session hibernated at retirement wakes from each tier
  (its radix copy, the host blob on a fresh engine, the disk blob once the
  engine that held it is gone) in fp32 and int8 with the greedy tokens and
  the promotion counters of the JAX engine on the same weights; a wake on
  another replica needs no ``session_id``; a corrupt blob recomputes; the
  ledger's ``hibernating`` pages balance; both fault sites crash and
  recover.

Every wait polls state under its own deadline: a hung worker fails one
test, never the run.
"""

import os
import queue
import time

import numpy as np
import pytest

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.ops import kv_cache as JKV
from penroz_tpu.serve import decode_scheduler as JDS
from penroz_tpu.serve import qos as jqos
from penroz_tpu.serve import tierstore as jtier
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import faults as jfaults
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.serve import decode_scheduler as DS
from penroz_tpu_torch.serve import memledger, qos
from penroz_tpu_torch.serve import router as R
from penroz_tpu_torch.serve import tierstore as ttier
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import faults

BLOCK = 16
SGD = {"sgd": {"lr": 0.1}}
WAIT_S = 60.0
MODEL = "tiergpt"
PKGS = {"jax": (jtier, jckpt), "torch": (ttier, tckpt)}


@pytest.fixture(autouse=True)
def _fresh(workdir, tmp_path, monkeypatch):
    """Fresh tier stores, engines, faults and quotas in both packages, the
    disk tier under this test's directory."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    monkeypatch.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / "tier"))
    monkeypatch.setenv("PENROZ_MEMLEDGER_STRICT", "1")
    for mod in (faults, jfaults, qos, jqos, ttier, jtier):
        mod.reset()
    JKV.reset_unpin_underflow_count()
    yield
    DS.reset()
    JDS.reset()
    for mod in (faults, jfaults, qos, jqos, ttier, jtier):
        mod.reset()
    JKV.reset_unpin_underflow_count()


# -- the store ----------------------------------------------------------------

def _register(store, sid, tokens, *, tenant="default", model_id="m",
              stamp=7, page_size=4, nbytes=1024, owner=1, replica="r0",
              quantized=False):
    return store.register(
        sid, tenant=tenant, model_id=model_id, model_stamp=stamp,
        tokens=tuple(tokens), kv_len=(len(tokens) // page_size) * page_size,
        page_size=page_size, quantized=quantized, nbytes=nbytes,
        owner=owner, replica=replica)


def _blob(pages=2, page_size=4, quantized=False, seed=0):
    """An ``export_pages``-shaped blob: one layer, seeded planes."""
    rng = np.random.default_rng(seed)
    plane = lambda: rng.standard_normal(  # noqa: E731
        (1, pages * page_size, 2)).astype(np.float32)
    return {"page_size": page_size, "pages": pages,
            "length": pages * page_size, "quantized": quantized,
            "k": [plane()], "v": [plane()]}


def _rec(rec):
    return None if rec is None else (rec.session_id, rec.tier, rec.kv_len,
                                     rec.nbytes, rec.replica)


def _match(store, tokens, **kw):
    rec, depth = store.match(list(tokens), **{
        "model_id": "m", "model_stamp": 7, "page_size": 4,
        "quantized": False, **kw})
    return _rec(rec), depth


def _seq_match_depths(store, ckpt, env):
    out = [_register(store, "s1", range(8)), _register(store, "s2", range(12))]
    out += [_match(store, range(13)), _match(store, range(12)),
            _match(store, [0, 1, 2, 3, 99, 98, 97, 96, 8]),
            _match(store, range(13), quantized=True),
            _match(store, range(13), model_id="other"),
            # a stale stamp drops the session at match time
            _match(store, range(13), model_stamp=8),
            store.resident_sessions()]
    return out


def _seq_replace_and_owner(store, ckpt, env):
    out = [_register(store, "s1", range(8), owner=1),
           _register(store, "s1", range(12), owner=1),
           store.resident_sessions(), _rec(store.get("s1")),
           _register(store, "s2", range(4), owner=1),
           store.demote_to_host("s2", _blob(1)),
           store.drop_owner(1, "engine_reset"),
           _rec(store.get("s1")), _rec(store.get("s2"))]
    return out


def _seq_tenant_quota(store, ckpt, env):
    env.setenv("PENROZ_QOS_TENANT_TIER_MB", "0.002")     # 2000 bytes
    out = [_register(store, "a1", range(8), tenant="acme", nbytes=900),
           _register(store, "a2", range(4), tenant="acme", nbytes=900),
           _register(store, "b1", range(4), tenant="beta", nbytes=900),
           _register(store, "a3", [50, 51, 52, 53], tenant="acme",
                     nbytes=900),
           _rec(store.get("a1")),
           sorted(r["session_id"] for r in store.list_sessions()),
           _register(store, "a4", range(4), tenant="acme", nbytes=3000),
           _rec(store.get("a2"))]
    return out


def _seq_spill_and_caps(store, ckpt, env):
    blob_bytes = ckpt.page_blob_nbytes(_blob(2))
    env.setenv("PENROZ_TIER_HOST_MB", str(blob_bytes / 1e6))
    out = []
    for i, sid in enumerate(("s1", "s2", "s3")):
        out += [_register(store, sid, range(i * 8, i * 8 + 8)),
                store.demote_to_host(sid, _blob(2, seed=i))]
    out.append(sorted((r["session_id"], r["tier"])
                      for r in store.list_sessions()))
    out.append(ckpt.list_tier_blob_ids())
    env.setenv("PENROZ_TIER_DISK_MB", str(ckpt.tier_blob_nbytes("s1") / 1e6))
    out += [_register(store, "s4", range(40, 48)),
            store.demote_to_host("s4", _blob(2, seed=4)),
            _rec(store.get("s1")), ckpt.tier_blob_nbytes("s1"),
            ckpt.list_tier_blob_ids()]
    return out


def _seq_corrupt_and_missing(store, ckpt, env):
    env.setenv("PENROZ_TIER_HOST_MB", "0")
    out = []
    for sid, toks in (("sc", range(8)), ("sm", range(8, 16)),
                      ("st", range(16, 24))):
        out += [_register(store, sid, toks),
                store.demote_to_host(sid, _blob(2)), store.get(sid).tier]
    path = ckpt.tier_blob_path("sc")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    out += [store.fetch("sc") is None, os.path.exists(path)]
    os.remove(ckpt.tier_blob_path("sm"))
    out.append(store.fetch("sm") is None)
    path = ckpt.tier_blob_path("st")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])
    out += [store.fetch("st") is None, store.corrupt_blobs]
    return out


def _seq_placement(store, ckpt, env):
    out = [_register(store, "s1", range(8), quantized=True),
           _register(store, "s2", range(20, 28))]
    order = list(store._sessions)
    out += [_rec(store.placement(list(range(9)), model_id="m",
                                 page_size=4)),
            list(store._sessions) == order, dict(store.promotions),
            _rec(store.placement([7] * 5, model_id="m", page_size=4))]
    store.match(list(range(9)), model_id="m", model_stamp=7, page_size=4,
                quantized=True)
    out.append(list(store._sessions))
    return out


def _stats(store):
    s = store.stats()
    s.pop("restart_recovery")
    return s, dict(store.drops), dict(store.promotions)


@pytest.mark.parametrize("seq", [
    _seq_match_depths, _seq_replace_and_owner, _seq_tenant_quota,
    _seq_spill_and_caps, _seq_corrupt_and_missing, _seq_placement],
    ids=lambda f: f.__name__[5:])
def test_store_sequences_match_jax(seq, tmp_path, monkeypatch):
    """The JAX package's TierStore unit sequences (match depth and token
    check, stale stamps, re-registration and drop_owner, the tenant quota,
    host-cap spill and disk-cap drops, corrupt and missing blobs, the
    router's placement probe) on a fresh store of each package: the same
    outcomes, the same ``stats()``, drops and promotions, the same blob
    files on disk."""
    got = {}
    for name, (mod, ckpt) in PKGS.items():
        with monkeypatch.context() as env:
            env.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / name))
            store = mod.TierStore()
            got[name] = (seq(store, ckpt, env), _stats(store))
    assert got["torch"] == got["jax"]
    assert got["torch"][0]       # the sequence observed something


def test_fingerprints_equal_jax_and_the_router():
    """``_fingerprints`` gives the JAX function's hashes (Python's int-tuple
    hash, the same in every process), and the router's affinity index
    agrees with it at the pool's page size."""
    rng = np.random.default_rng(17)
    for page in (1, 4, 16):
        for n in (0, 3, 16, 53):
            toks = rng.integers(0, 50304, n).tolist()
            assert ttier._fingerprints(toks, page, 99) == \
                jtier._fingerprints(toks, page, 99)
            assert ttier._fingerprints(toks, page, 2) == \
                jtier._fingerprints(toks, page, 99)[:2]


def test_router_fingerprints_equal_the_store(monkeypatch):
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1")):
        monkeypatch.setenv(name, value)
    toks = list(range(3, 22))
    router = R.EngineRouter.__new__(R.EngineRouter)
    assert router._fingerprints(toks) == ttier._fingerprints(toks, 4, 99)


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_tier_blobs_cross_between_packages(tmp_path, monkeypatch, writer,
                                           quantized):
    """A tier blob written by either package loads in the other, bit for
    bit (fp32 planes, int8 planes with their fp32 scales), and passes the
    other's header check; a truncated one fails it."""
    import torch
    monkeypatch.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / "tier"))
    rng = np.random.default_rng(3)
    blob = {"page_size": 4, "pages": 2, "length": 8, "quantized": quantized}
    if quantized:
        blob["k"] = [rng.integers(-128, 128, (2, 8, 4)).astype(np.int8)]
        blob["v"] = [rng.integers(-128, 128, (2, 8, 4)).astype(np.int8)]
        blob["k_scale"] = [rng.random((2, 8, 1)).astype(np.float32)]
        blob["v_scale"] = [rng.random((2, 8, 1)).astype(np.float32)]
    else:
        blob["k"] = [rng.standard_normal((2, 8, 4)).astype(np.float32)]
        blob["v"] = [rng.standard_normal((2, 8, 4)).astype(np.float32)]
    src, dst = (jckpt, tckpt) if writer == "jax" else (tckpt, jckpt)
    src.save_tier_blob("x1", blob)
    assert dst.list_tier_blob_ids() == ["x1"] and dst.validate_tier_blob("x1")
    assert dst.tier_blob_nbytes("x1") == src.tier_blob_nbytes("x1") > 0
    back = dst.load_tier_blob("x1")
    for key, planes in blob.items():
        if isinstance(planes, list):
            for a, b in zip(planes, back[key]):
                b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
                assert b.dtype == a.dtype and np.array_equal(a, b)
        else:
            assert back[key] == planes
    raw = open(dst.tier_blob_path("x1"), "rb").read()
    with open(dst.tier_blob_path("x1"), "wb") as f:
        f.write(raw[:len(raw) - 8])
    with pytest.raises(ValueError):
        dst.load_tier_blob("x1")
    with open(dst.tier_blob_path("x1"), "wb") as f:
        f.write(raw[:12])
    assert not dst.validate_tier_blob("x1")
    with pytest.raises(KeyError):
        dst.load_tier_blob("nope")


def test_sweep_tier_orphans_matches_jax(tmp_path, monkeypatch):
    """The restart sweep removes torn temporary siblings and unreferenced
    blobs, and with an unknown reference set (None) no finished blob."""
    counts = {}
    for name, (_, ckpt) in PKGS.items():
        monkeypatch.setenv("PENROZ_TIER_DISK_PATH", str(tmp_path / name))
        for sid in ("keep", "orphan"):
            ckpt.save_tier_blob(sid, _blob(1))
        torn = ckpt.tier_blob_path("keep") + ".0123456789ab"
        open(torn, "wb").write(b"torn")
        counts[name] = [ckpt.sweep_tier_orphans(None),
                        ckpt.list_tier_blob_ids(),
                        ckpt.sweep_tier_orphans(["keep"]),
                        ckpt.list_tier_blob_ids(), os.path.exists(torn)]
    assert counts["torch"] == counts["jax"]
    assert counts["torch"][3] == ["keep"]


# -- the engine ---------------------------------------------------------------

@pytest.fixture
def tier_env(monkeypatch):
    """The paged pool with pages of 4 and an 8-page radix region."""
    for name, value in (("PAGED_KV_CACHE", "1"), ("PENROZ_KV_PAGE_SIZE", "4"),
                        ("PENROZ_PREFIX_CACHE", "1"),
                        ("PENROZ_PREFIX_CACHE_PAGES", "8")):
        monkeypatch.setenv(name, value)
    return monkeypatch


@pytest.fixture
def jmodel(workdir):
    """A toy GPT written by the JAX package, read by both (one shm dir)."""
    model = JModel(MODEL, JMapper(jpresets.gpt2_custom(
        d=32, heads=4, depth=2, vocab=64, block=BLOCK), SGD))
    model.serialize(sync_flush=True)
    return model


class _Collector:
    def __init__(self, prompt):
        self.q = queue.Queue()
        self.tokens = list(prompt)

    def on_event(self, kind, value):
        self.q.put((kind, value))

    def result(self, timeout=WAIT_S):
        while True:
            kind, value = self.q.get(timeout=timeout)
            if kind == "token":
                self.tokens.append(value)
            elif kind == "done":
                return self.tokens
            else:
                raise value


def _engine(pkg, replica=0):
    if pkg is DS:
        return DS.DecodeEngine(MODEL, BLOCK, 0.0, None, capacity=2,
                               device="cpu", replica=replica)
    return JDS.DecodeEngine(MODEL, BLOCK, 0.0, None, capacity=2,
                            replica=replica)


def _run(engine, prompt, max_new, pkg, session_id=None):
    collector = _Collector(prompt)
    engine.submit(pkg.Request(prompt, max_new, None, collector.on_event,
                              session_id=session_id))
    return collector.result()


def _until(pred, what, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


def _demoted(engine, store, sid, tier):
    """Wait until the engine's demotion queue has drained and ``sid`` sits
    in ``tier`` (state, not a clock)."""
    _until(lambda: (not engine._hib_pending and not engine._hib_holds
                    and store.get(sid) is not None
                    and store.get(sid).tier == tier),
           f"session {sid} never reached tier {tier}: {store.get(sid)}")


TIER_PROMPT = [1, 2, 3, 4, 5, 6, 7]


def _wake(pkg, store, tier, sid):
    """Hibernate ``TIER_PROMPT`` + 4 tokens under ``sid``, then wake it
    from ``tier`` with one more user token: (turn 1, turn 2, the engine's
    session promotions, the store's promotion counts)."""
    engine = _engine(pkg)
    first = _run(engine, TIER_PROMPT, 4, pkg, session_id=sid)
    if pkg is DS:
        _demoted(engine, store, sid, "disk" if tier == "disk" else "host")
    else:
        _until(lambda: store.get(sid) is not None and store.get(sid).tier
               == ("disk" if tier == "disk" else "host"), "jax demotion")
    if tier != "hbm":
        # a fresh engine: the old pool, and its radix copy, are gone
        engine.shutdown()
        engine = _engine(pkg)
    second = _run(engine, first + [9], 3, pkg)
    promotions = engine.stats()["session_promotions"]
    engine.shutdown()
    return first, second, promotions, dict(store.promotions)


@pytest.mark.parametrize("tier", ["hbm", "host", "disk"])
@pytest.mark.parametrize("int8", [0, 1], ids=["fp32", "int8"])
def test_hibernate_resume_parity_matrix(jmodel, tier_env, tier, int8):
    """A session hibernated at retirement wakes from its radix copy on the
    same engine (``hbm``), from the host blob on a fresh engine (``host``),
    or from the disk blob with a zero host cap (``disk``), in fp32 and
    int8 pages: the port's two turns equal the JAX
    engine's greedy tokens, and so do the promotion counts."""
    if int8:
        tier_env.setenv("TURBO_QUANT_KV_CACHE", "1")
    if tier == "disk":
        tier_env.setenv("PENROZ_TIER_HOST_MB", "0")
    want = _wake(JDS, jtier.TIERS, tier, "j-conv")
    got = _wake(DS, ttier.TIERS, tier, "t-conv")
    assert got == want
    assert got[3] == {(tier, "ok"): 1}
    assert got[2] == (0 if tier == "hbm" else 1)
    engine = _engine(DS)
    assert got[1] == _run(engine, got[0] + [9], 3, DS)    # cold
    engine.shutdown()


def _same_pools(int8: bool):
    """A JAX and a port paged pool (pages of 4, a 4-page radix tail) with
    the same seeded contents, int8 with seeded scales."""
    import jax.numpy as jnp
    import torch
    specs = [(2, 8), (3, 4)]
    rng = np.random.default_rng(5)
    j = JKV.create_kv_state(specs, 3, BLOCK, quantized=int8, paged=True,
                            extra_pool_pages=4).with_static_table()
    t = KV.create_kv_state(specs, 3, BLOCK, quantized=int8, paged=True,
                           extra_pool_pages=4, device="cpu")
    t.with_static_table()
    names = ("k", "v") + (("k_scale", "v_scale") if int8 else ())
    for name in names:
        jl, tl = [], []
        for a in getattr(t, name):
            arr = (rng.integers(-127, 128, a.shape).astype(np.int8)
                   if a.dtype == torch.int8
                   else rng.standard_normal(a.shape).astype(np.float32))
            jl.append(jnp.asarray(arr))
            tl.append(torch.from_numpy(arr.copy()))
        setattr(j, name, jl)
        setattr(t, name, tl)
    return j, t, names


def _equal_planes(jax_blob, port_blob, names):
    for key in ("page_size", "pages", "length", "quantized"):
        assert port_blob[key] == jax_blob[key], key
    assert list(port_blob) == list(jax_blob)
    for name in names:
        for a, b in zip(jax_blob[name], port_blob[name]):
            a = np.asarray(a)
            assert b.numpy().dtype == a.dtype
            np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("int8", [False, True], ids=["fp32", "int8"])
def test_export_import_pages_bit_for_bit_with_jax(tier_env, int8):
    """On the same pool contents, ``export_pages`` of a radix page list
    (out of pool order, as a chain is) gives the JAX blob bit for bit
    (fp32, and int8 with its scales); ``import_pages`` of a blob's tail
    pages at an offset leaves the port's pools equal to the JAX ones."""
    j, t, names = _same_pools(int8)
    pages = [14, 12, 15]
    jb, tb = j.export_pages(pages, 12), t.export_pages(pages, 12)
    _equal_planes(jb, tb, names)
    dev = t.export_pages(pages, 12, device=True)
    for name in names:
        for a, b in zip(dev[name], tb[name]):
            assert a.device.type == "cpu" and bool((a == b).all())
    j2, t2, _ = _same_pools(int8)
    j2 = j2.import_pages([1, 7], jb, blob_offset=1)
    t2.import_pages([1, 7], tb, blob_offset=1)
    for name in names:
        for a, b in zip(getattr(j2, name), getattr(t2, name)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    _equal_planes(j2.export_pages([1, 7], 8), t2.export_pages([1, 7], 8),
                  names)
    with pytest.raises(ValueError, match="exceeds"):
        t2.import_pages([1, 7], tb, blob_offset=2)
    with pytest.raises(ValueError, match="quantization"):
        t2.import_pages([1], dict(tb, quantized=not int8))


def test_cross_replica_wake_without_session_id(jmodel, tier_env):
    """A session hibernated on replica 0 wakes on replica 1 from the
    process-wide host tier, with no ``session_id`` on the waking request,
    as in the JAX package."""
    results = {}
    for pkg, store, sid in ((JDS, jtier.TIERS, "j-nomad"),
                            (DS, ttier.TIERS, "t-nomad")):
        a, b = _engine(pkg, replica=0), _engine(pkg, replica=1)
        first = _run(a, [3, 1, 4, 1, 5], 4, pkg, session_id=sid)
        _until(lambda: store.get(sid) is not None
               and store.get(sid).tier == "host", "demotion")
        replica = store.get(sid).replica
        second = _run(b, first + [2], 3, pkg)
        results[pkg] = (first, second, replica,
                        a.stats()["session_promotions"],
                        b.stats()["session_promotions"],
                        dict(store.promotions))
        a.shutdown()
        b.shutdown()
    assert results[DS] == results[JDS]
    assert results[DS][2:] == (0, 0, 1, {("host", "ok"): 1})


def test_corrupt_disk_blob_recomputes(jmodel, tier_env):
    """A flipped byte in the disk blob: the wake recomputes the JAX
    tokens, the blob counts corrupt, the session is dropped, no crash."""
    tier_env.setenv("PENROZ_TIER_HOST_MB", "0")
    engine = _engine(DS)
    first = _run(engine, [5, 4, 3, 2, 1], 4, DS, session_id="bitrot")
    _demoted(engine, ttier.TIERS, "bitrot", "disk")
    path = tckpt.tier_blob_path("bitrot")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    engine.shutdown()
    engine = _engine(DS)
    got = _run(engine, first + [6], 3, DS)
    assert got == jmodel.generate_tokens([first + [6]], BLOCK, 3,
                                         temperature=0.0)
    assert ttier.TIERS.corrupt_blobs == 1
    assert dict(ttier.TIERS.promotions) == {("disk", "corrupt"): 1}
    assert ttier.TIERS.get("bitrot") is None and not os.path.exists(path)
    assert engine.stats()["crashes_total"] == 0
    engine.shutdown()


def test_memledger_hibernating_state_balances(jmodel, tier_env):
    """Pages under a hibernation hold count ``hibernating`` until the
    demotion releases them into plain cache residency; the strict audit
    balances before and after, and the aggregate's host_tier bytes are the
    store's.  Every read waits for the demotion queue to drain first."""
    engine = _engine(DS)
    # hold the worker's demotion pass so the hold is observable
    gate = __import__("threading").Event()
    real = engine._process_demotions

    def gated():
        if engine._hib_pending:
            assert gate.wait(WAIT_S)
        real()

    engine._process_demotions = gated
    collector = _Collector(TIER_PROMPT)
    engine.submit(DS.Request(TIER_PROMPT, 4, None, collector.on_event,
                             session_id="ledger"))
    collector.result()
    _until(lambda: engine._hib_pending, "no hold pending")
    held = engine.memory_snapshot()["pool_pages"]
    assert held["hibernating"] == 2 and held["prefix_pinned"] == 0
    assert sum(held.values()) == engine.memory_snapshot()["pool_pages_total"]
    assert engine._ledger.audit("test.held") == []
    gate.set()
    _demoted(engine, ttier.TIERS, "ledger", "host")
    pool = engine.memory_snapshot()["pool_pages"]
    assert pool["hibernating"] == 0 and pool["prefix_evictable"] == 2
    assert engine._ledger.audit("test.after_demote") == []
    agg = memledger.memory_stats()
    assert agg["hbm_bytes"]["host_tier"] == \
        ttier.TIERS.tier_bytes()["host_tier"] > 0
    assert agg["pool_pages"]["hibernating"] == 0
    # a session deleted while its hold waits: the worker releases the pin
    engine._process_demotions = gated
    gate.clear()
    _run(engine, TIER_PROMPT + [8], 3, DS, session_id="ledger2")
    _until(lambda: engine._hib_pending, "no second hold")
    assert ttier.TIERS.drop("ledger2", "api")
    gate.set()
    _until(lambda: not engine._hib_pending and not engine._hib_holds,
           "the dropped hold was not released")
    assert engine._ledger.audit("test.after_drop") == []
    assert ttier.TIERS.get("ledger").tier == "host"
    engine.shutdown()


@pytest.mark.parametrize("site", ["tier.demote", "tier.promote"])
def test_tier_fault_sites_crash_recover_with_parity(jmodel, tier_env,
                                                    monkeypatch, site):
    """Each fault site fails its tick into the engine's crash recovery
    (reset, clean strict audit) in both packages alike; afterwards the same
    histories hibernate and wake with the JAX tokens."""
    results = {}
    for pkg, fmod, store, tag in ((JDS, jfaults, jtier.TIERS, "j"),
                                  (DS, faults, ttier.TIERS, "t")):
        monkeypatch.setenv("PENROZ_FAULT_INJECT", f"{site}:raise@1")
        fmod.reset()
        engine = _engine(pkg)
        first = _run(engine, TIER_PROMPT, 4, pkg, session_id=f"{tag}-chaos")
        if site == "tier.demote":
            # the reset counts after the crash recovery failed the queue:
            # a request submitted from here on is not failed with it
            _until(lambda: engine.stats()["engine_resets"] >= 1,
                   "the demote fault never fired")
            error = None
        else:
            _until(lambda: store.get(f"{tag}-chaos") is not None
                   and store.get(f"{tag}-chaos").tier == "host", "demotion")
            for j in range(5):      # evict the session's radix copy
                _run(engine, [30 + j] * 8, 2, pkg)
            with pytest.raises(Exception, match="injected fault") as exc:
                _run(engine, first + [9], 3, pkg)
            error = type(exc.value).__name__
        crashes = engine.stats()["crashes_total"]
        again = _run(engine, TIER_PROMPT, 4, pkg, session_id=f"{tag}-after")
        _until(lambda: store.get(f"{tag}-after") is not None
               and store.get(f"{tag}-after").tier == "host", "demotion")
        second = _run(engine, first + [9], 3, pkg)
        results[tag] = (first, again, second, error, crashes,
                        engine.stats()["breaker_open"])
        if pkg is DS:
            assert engine._ledger.audit("test.recovered") == []
        engine.shutdown()
        monkeypatch.delenv("PENROZ_FAULT_INJECT")
    assert results["t"] == results["j"]
    assert results["t"][4] == 1


def test_shutdown_drops_only_the_engines_hbm_records(jmodel, tier_env):
    """An engine's shutdown drops its hbm-tier records (their pages die
    with the pool) and keeps demoted ones, as in the JAX package; an
    adapter row is not hibernated."""
    engine = _engine(DS)
    _run(engine, [9, 8, 7, 6, 5], 4, DS, session_id="demoted")
    _demoted(engine, ttier.TIERS, "demoted", "host")
    engine._process_demotions = lambda: None     # no demotion runs now
    _run(engine, TIER_PROMPT, 4, DS, session_id="pinned")
    assert ttier.TIERS.get("pinned").tier == "hbm"
    assert engine.shutdown()
    assert ttier.TIERS.get("pinned") is None
    assert ttier.TIERS.get("demoted").tier == "host"
    assert ttier.TIERS.drops["engine_shutdown"] == 1


def _router_steering(pkg, router_mod, store, sid, monkeypatch):
    """Hibernate through a 2-replica router, forget the affinity index,
    wake: the session steers home; open the home's breaker, wake again:
    a redirect, woken elsewhere from the host blob."""
    monkeypatch.setenv("PENROZ_SCHED_REPLICAS", "2")
    router = pkg.get_engine(MODEL, BLOCK, 0.0, None,
                            **({"device": "cpu"} if pkg is DS else {}))
    assert isinstance(router, router_mod.EngineRouter)
    collector = _Collector(TIER_PROMPT)
    router.submit(pkg.Request(TIER_PROMPT, 4, None, collector.on_event,
                              session_id=sid))
    first = collector.result()
    _until(lambda: store.get(sid) is not None
           and store.get(sid).tier == "host", "demotion")
    home = store.get(sid).replica
    out = [first, home]
    for open_home in (False, True):
        router._affinity.clear()
        router.replicas[home]._breaker_open = open_home
        router.replicas[home]._breaker_open_t = time.monotonic()
        collector = _Collector(first + [9])
        router.submit(pkg.Request(first + [9], 3, None, collector.on_event))
        out += [collector.result(), router.session_steers,
                router.session_redirects]
        router.replicas[home]._breaker_open = False
    out.append([e.stats()["session_promotions"] for e in router.replicas])
    pkg.reset()
    return out


def test_router_session_steering_and_redirects(jmodel, tier_env,
                                               monkeypatch):
    """``_session_target``: with no affinity entry a wake is steered at the
    session's home replica (a steer, its radix copy serves it), and with
    the home's breaker open it is redirected (a redirect, the sibling
    imports the host blob): the JAX router's tokens and counters."""
    want = _router_steering(JDS, __import__(
        "penroz_tpu.serve.router", fromlist=["EngineRouter"]), jtier.TIERS,
        "j-home", monkeypatch)
    got = _router_steering(DS, R, ttier.TIERS, "t-home", monkeypatch)
    assert got == want
    assert got[3:5] == [1, 0] and got[6:8] == [1, 1]


# -- the HTTP surface ---------------------------------------------------------

def test_sessions_api_surface(jmodel, tier_env):
    """``session_id`` on /generate/ hibernates; ``GET /sessions/`` lists the
    session by tier; a malformed id is a 422; ``session_ids`` on
    /generate_batch/ (null: none) hibernates those rows, a wrong count or
    a malformed one is a 400; ``DELETE /sessions/{id}`` evicts, and again
    answers ``deleted: false`` (the JAX service's statuses)."""
    import json
    import threading
    import urllib.error
    import urllib.request

    from penroz_tpu_torch.serve.app import create_app
    tier_env.setenv("PENROZ_CONTINUOUS_BATCHING", "1")
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = "http://%s:%d" % srv.server_address[:2]

    def call(method, path, body=None):
        req = urllib.request.Request(
            base + path, method=method,
            data=json.dumps(body).encode() if body is not None else None,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=WAIT_S) as resp:
                return resp.status, json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read() or b"null")

    payload = {"model_id": MODEL, "input": [[1, 2, 3, 4, 5]],
               "block_size": BLOCK, "max_new_tokens": 4,
               "temperature": 0.0, "session_id": "api-conv"}
    batch = {"model_id": MODEL, "inputs": [[1, 2, 3, 9], [4, 5]],
             "block_size": BLOCK, "max_new_tokens": 3, "temperature": 0.0}
    try:
        status, body = call("POST", "/generate/", payload)
        assert status == 200 and len(body["tokens"]) == 9
        _until(lambda: call("GET", "/sessions/")[1]["sessions_by_tier"][
            "host"] == 1, "no host session")
        status, listing = call("GET", "/sessions/")
        (sess,) = listing["sessions"]
        assert sess["session_id"] == "api-conv" and sess["tier"] == "host"
        assert sess["tokens"] == 8 and sess["pages"] == 2
        assert listing["sessions_resident"] == 1
        assert listing["tier_bytes"]["host_tier"] == sess["nbytes"] > 0
        assert call("POST", "/generate/",
                    dict(payload, session_id="bad id!"))[0] == 422
        status, body = call("POST", "/generate_batch/",
                            dict(batch, session_ids=["api-b0", None]))
        assert status == 200 and len(body["sequences"]) == 2
        _until(lambda: ttier.TIERS.get("api-b0") is not None,
               "the batch row did not hibernate")
        assert call("POST", "/generate_batch/",
                    dict(batch, session_ids=["only-one"]))[0] == 400
        status, body = call("POST", "/generate_batch/",
                            dict(batch, session_ids=[None, "bad/id"]))
        assert status == 400 and "row(s) 1" in body["detail"]
        assert call("POST", "/generate_batch/",
                    dict(batch, session_ids=[1, None]))[0] == 422
        assert call("DELETE", "/sessions/api-conv") == (
            200, {"session_id": "api-conv", "deleted": True})
        assert call("DELETE", "/sessions/api-conv") == (
            200, {"session_id": "api-conv", "deleted": False})
        listing = call("GET", "/sessions/")[1]
        assert "api-conv" not in {s["session_id"]
                                  for s in listing["sessions"]}
        stats = call("GET", "/serving_stats/")[1]
        assert stats["sessions_hibernated"] == 2
        assert stats["sessions_resident"] == listing["sessions_resident"]
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(WAIT_S)
