"""``GET /stats/`` in the port against the JAX package, on the CPU, from the
same weights (carried over by ``from_jax_state_dict``): a two-layer GPT
(``gpt2_custom(d=64, heads=4, depth=2, vocab=64, block=16)``) and a small
hybrid attention/SSM model (``hybrid_custom(d=32, heads=4, depth=2,
vocab=64, block=16)``), both fp32.

- ``utils/stats.py`` returns what the JAX module returns on the same numpy
  arrays (exactly);
- ``stats_grads`` (activations, activation gradients and weight gradients
  atol 1e-5 of each tensor's largest magnitude) and ``_compute_stats``
  against JAX's; ``train_model``'s refresh against JAX's;
- the route: ``null`` before training, the document after ``PUT /train/``,
  404 for an unknown model and 422 without ``model_id``;
- ``PENROZ_STATS_INTERVAL`` honoured (under a clock that moves 11 s a
  read), and no longer refused;
- a checkpoint's ``stats`` read across packages, both ways.

Document tolerances: means, stds and saturation fractions rtol 1e-4, atol
1e-6; histogram bin edges within 1e-5 of the histogram's range; the
densities may differ by one sample crossing a bin edge (the two forwards
sum in other orders)."""

import ast
import json
import threading
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu.utils import stats as jstats
from penroz_tpu_torch.models import model as tmodel
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.serve.app import create_app
from penroz_tpu_torch.utils import checkpoint as tckpt
from penroz_tpu_torch.utils import stats as tstats

RTOL, ATOL = 1e-4, 1e-6
EDGE_RTOL = 1e-5
MODELS = {
    "gpt": presets.gpt2_custom(d=64, heads=4, depth=2, vocab=64, block=16),
    "hybrid": presets.hybrid_custom(d=32, heads=4, depth=2, vocab=64,
                                    block=16),
}
TRAIN = dict(epochs=2, batch_size=2, block_size=16, step_size=1)


@pytest.fixture(params=sorted(MODELS))
def layers(request):
    return MODELS[request.param]


@pytest.fixture
def port_dir(workdir, monkeypatch):
    """Both packages read and write the same models/ and shm dirs."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


def _pair(layers, optimizer, jid="j", tid="t"):
    jm = JModel(jid, JMapper(layers, optimizer))
    tm = from_jax_state_dict(jm.state_dict(), layers, optimizer,
                             model_id=tid, device="cpu")
    return jm, tm


def _batch(seed=0, shape=(2, 12)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 64, shape).astype(np.int32),
            rng.integers(0, 64, shape).astype(np.int32))


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=what)


def _hist_close(got, want, n, what):
    """Bin edges within EDGE_RTOL of the range; the counts (density ·
    n · bin width) differ by at most one sample moved across an edge."""
    gx, gy, wx, wy = (np.asarray(h[k], np.float64)
                      for h in (got, want) for k in ("x", "y"))
    assert gx.shape == wx.shape and gy.shape == wy.shape, what
    if not wx.size:
        return
    width = (wx[-1] - wx[0]) / (wx.size - 1)
    np.testing.assert_allclose(gx, wx, rtol=0,
                               atol=EDGE_RTOL * width * wx.size,
                               err_msg=what)
    g_width = (gx[-1] - gx[0]) / (gx.size - 1)
    moved = np.abs(np.rint(gy * n * g_width) - np.rint(wy * n * width))
    assert moved.sum() <= 2, f"{what}: counts differ by {moved.sum()}"


def _summary_close(got, want, n, what):
    for key in ("mean", "std", "saturated"):
        if key in want:
            _close(got[key], want[key], f"{what} {key}")
    _hist_close(got["histogram"], want["histogram"], n, f"{what} histogram")


def assert_stats_close(got, want, act_sizes):
    """``got`` (the port's document) against ``want`` (JAX's);
    ``act_sizes``: the element count of each top-level activation."""
    assert set(got) == set(want) == {"layers", "weights"}
    assert len(got["layers"]) == len(want["layers"]) == len(act_sizes)
    for i, (g, w, n) in enumerate(zip(got["layers"], want["layers"],
                                      act_sizes)):
        assert g["algo"] == w["algo"]
        _summary_close(g["activation"], w["activation"], n, f"layer {i}")
        assert (g["gradient"] is None) == (w["gradient"] is None)
        if w["gradient"] is not None:
            _summary_close(g["gradient"], w["gradient"], n,
                           f"layer {i} gradient")
    assert len(got["weights"]) == len(want["weights"])
    for i, (g, w) in enumerate(zip(got["weights"], want["weights"])):
        assert g["shape"] == w["shape"]
        n = int(np.prod(ast.literal_eval(w["shape"])))  # "(a, b)"
        for key in ("mean", "std"):
            _close(g["data"][key], w["data"][key], f"weight {i} {key}")
        _summary_close(g["gradient"], w["gradient"], n,
                       f"weight {i} gradient")


def _act_sizes(tm, x, y):
    acts, _, _ = tm.arch.stats_grads(torch.as_tensor(x, dtype=torch.int64),
                                     torch.as_tensor(y, dtype=torch.int64))
    return [a.numel() for a in acts]


# -- utils/stats.py ---------------------------------------------------------

@pytest.mark.parametrize("algo", ["embedding", "batchnorm1d", "tanh",
                                  "sigmoid", "relu", "softmax", "linear"])
def test_stats_module_equals_jax(algo):
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, (4, 6, 8)).astype(np.float32)
    assert tstats.saturation_fraction(algo, a) == \
        jstats.saturation_fraction(algo, a)
    assert tstats.histogram(a) == jstats.histogram(a)
    assert tstats.histogram(np.zeros(0)) == jstats.histogram(np.zeros(0))
    assert tstats.rate(3, 4) == jstats.rate(3, 4) and tstats.rate(3, 0) is None
    acts = [a, a * 0.5]
    grads = [a * 1e-3, None]
    weights = [a[0], None]
    wgrads = [a[1], None]
    doc = tstats.build_stats([algo, "relu", "extra"], acts, grads, weights,
                             wgrads)
    assert doc == jstats.build_stats([algo, "relu", "extra"], acts, grads,
                                     weights, wgrads)
    assert len(doc["layers"]) == 2 and doc["weights"][1] is None


# -- the instrumented pass ----------------------------------------------------

def test_stats_grads_match_jax(layers, toy_optimizer):
    jm, tm = _pair(layers, toy_optimizer)
    x, y = _batch()
    j_acts, j_agrads, j_wgrads = jm.arch.stats_grads(jm.params, jm.buffers,
                                                     x, y)
    acts, agrads, wgrads = tm.arch.stats_grads(
        torch.as_tensor(x, dtype=torch.int64),
        torch.as_tensor(y, dtype=torch.int64))
    assert len(acts) == len(j_acts) == len(agrads) == len(j_agrads)
    assert tm.arch.algos == jm.arch.algos
    pairs = list(zip(acts, j_acts)) + list(zip(agrads, j_agrads))
    pairs += [(g, j_wgrads[k]) for g, k in zip(wgrads, jm.arch.param_order)]
    for got, want in pairs:
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * scale)
    # the pass leaves no gradient on the model's own parameters
    assert all(p.grad is None for p in tm.arch.parameters())


def test_compute_stats_matches_jax(layers, toy_optimizer):
    jm, tm = _pair(layers, toy_optimizer)
    x, y = _batch(seed=2)
    want = jm._compute_stats(x, y)
    got = tm._compute_stats(x, y)
    assert_stats_close(got, want, _act_sizes(tm, x, y))
    # the JSON the checkpoint and the route carry is plain
    assert json.loads(json.dumps(got)) == got


def test_train_model_refreshes_stats_like_jax(port_dir, toy_shards, layers,
                                              toy_optimizer):
    jm, tm = _pair(layers, toy_optimizer)
    assert tm.stats is None
    jm.train_model(toy_shards, **TRAIN)
    tm.train_model(toy_shards, **TRAIN)
    x, y = _batch(shape=(TRAIN["batch_size"], TRAIN["block_size"]))
    assert_stats_close(tm.stats, jm.stats, _act_sizes(tm, x, y))


# -- the refresh cadence ------------------------------------------------------

@pytest.mark.parametrize("interval,refreshes", [("0", 4), ("1e9", 1)],
                         ids=["every_checkpoint", "end_only"])
def test_stats_interval_honoured(port_dir, toy_shards, toy_gpt_layers,
                                 toy_optimizer, monkeypatch, interval,
                                 refreshes):
    """Under a clock that moves 11 s a read every epoch writes a
    checkpoint; PENROZ_STATS_INTERVAL=0 refreshes the stats with each (3)
    and at the end, 1e9 only at the end."""
    clock = types.SimpleNamespace(t=0.0)

    def monotonic():
        clock.t += 11.0
        return clock.t

    monkeypatch.setattr(tmodel, "time",
                        types.SimpleNamespace(monotonic=monotonic))
    monkeypatch.setenv("PENROZ_STATS_INTERVAL", interval)
    tm = NeuralNetworkModel("iv", tmodel.Mapper(toy_gpt_layers,
                                                toy_optimizer), device="cpu")
    calls = []
    real = tm._compute_stats

    def counted(x, y):
        calls.append(x.shape)
        return real(x, y)

    tm._compute_stats = counted
    tm.train_model(toy_shards, **dict(TRAIN, epochs=3))
    assert tm.status["code"] == "Trained"
    assert calls == [(2, 16)] * refreshes
    assert tm.stats is not None


# -- the route and the checkpoint ---------------------------------------------

@pytest.fixture
def server(port_dir):
    srv = create_app(device="cpu")
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    yield f"http://{host}:{port}"
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=10)
    assert srv.join_training(timeout=60)
    tckpt.join_flushes()


def _call(base, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(base + path, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_stats_route(server, toy_shards, toy_gpt_layers, toy_optimizer):
    import time
    assert _call(server, "POST", "/model/",
                 {"model_id": "s", "layers": toy_gpt_layers,
                  "optimizer": toy_optimizer})[0] == 200
    status, text = _call(server, "GET", "/stats/?model_id=s")
    assert status == 200 and json.loads(text) is None
    assert _call(server, "GET", "/stats/?model_id=nope")[0] == 404
    status, text = _call(server, "GET", "/stats/")
    assert status == 422 and "model_id" in text
    status, text = _call(server, "PUT", "/train/", {
        "model_id": "s", "dataset_id": toy_shards, "shard": 0, "epochs": 2,
        "batch_size": 2, "block_size": 16, "step_size": 1, "device": "cpu"})
    assert status == 202, text
    deadline = time.monotonic() + 60
    while True:
        status, text = _call(server, "GET", "/progress/?model_id=s")
        code = json.loads(text)["status"]["code"]
        if code in ("Trained", "Error") or time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert code == "Trained"
    status, text = _call(server, "GET", "/stats/?model_id=s")
    assert status == 200
    doc = json.loads(text)
    tm = NeuralNetworkModel.deserialize("s", device="cpu", optimizer=False)
    assert doc == tm.stats and doc is not None
    assert len(doc["layers"]) == len(toy_gpt_layers) - 1  # no softmax
    assert len(doc["weights"]) == len(tm.arch.param_order)
    assert all(np.isfinite(e["activation"]["mean"]) for e in doc["layers"])


def test_stats_interval_no_longer_refused(monkeypatch):
    monkeypatch.setenv("PENROZ_STATS_INTERVAL", "5")
    tmodel.unported_training_options()


def test_checkpoint_stats_cross_package(port_dir, toy_shards, toy_gpt_layers,
                                        toy_optimizer):
    """Stats written by either package read back from the other unchanged
    (the same JSON in the checkpoint's metadata)."""
    jm, tm = _pair(toy_gpt_layers, toy_optimizer, jid="js", tid="ts")
    jm.train_model(toy_shards, **TRAIN)
    jm.serialize(sync_flush=True)
    jckpt.join_flushes()
    assert NeuralNetworkModel.deserialize("js", device="cpu").stats == \
        jm.stats
    tm.train_model(toy_shards, **TRAIN)
    tm.serialize(sync_flush=True)
    tckpt.join_flushes()
    assert JModel.deserialize("ts").stats == tm.stats
    assert tm.stats is not None
