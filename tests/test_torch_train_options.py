"""The port's training options against the JAX package's contracts, on the
CPU: decode priority (the window waits while a decode is in flight, no
longer than ``PENROZ_DECODE_PRIORITY_MS``; a micro-stepped epoch under a
pending decode equals the plain epoch and opens a window before every
micro-step but the first), ``PENROZ_REMAT=1`` (the cross-entropy kernel's
function under ``torch.utils.checkpoint``; a remat epoch, dropout on,
gives the plain epoch's cost and parameters, the forward run twice a
micro-step; an adapter run too), ``PENROZ_TRAIN_WORKER=1`` (the child ends
``Trained``; a killed child leaves ``Error`` and the parent serves; a
clean failure exits nonzero and is logged; an adapter run), and the
startup sweep of an orphaned ``Training`` checkpoint, held to the JAX
package's sweep on the same files.  The cases of tests/test_model.py
(decode priority, micro-steps, the worker), tests/test_losses.py
(``test_under_remat``), tests/test_app.py (the orphan sweep) and
tests/test_lora_serving.py (the worker's exit code) on the port.

Tolerances: remat against plain, the same fp32 arithmetic replayed on the
same seeds, exact; the checkpointed cross-entropy gradient against
``F.cross_entropy``'s, 1e-6 (the JAX test's)."""

import json
import threading
import time

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.serve import app as japp
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models import lora
from penroz_tpu_torch.models import model as model_mod
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.ops import losses
from penroz_tpu_torch.serve import app as tapp
from penroz_tpu_torch.utils import checkpoint as tckpt

ADAMW = {"adamw": {"lr": 1e-3, "betas": [0.9, 0.95], "eps": 1e-8}}
WAIT_S = 120.0


@pytest.fixture
def shared(workdir, monkeypatch, toy_shards):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    for name in (model_mod.TRAIN_WORKER_ENV, model_mod.REMAT_ENV,
                 model_mod.DECODE_PRIORITY_ENV):
        monkeypatch.delenv(name, raising=False)
    return toy_shards


def _dropout(layers, p=0.1):
    """The DSL with every dropout (layers and attention) at ``p``."""
    if isinstance(layers, dict):
        out = {}
        for k, v in layers.items():
            if k == "dropout" and isinstance(v, dict):
                out[k] = {**v, "p": p}
            elif k == "attention" and isinstance(v, dict):
                out[k] = {**v, "dropout": p}
            else:
                out[k] = _dropout(v, p)
        return out
    if isinstance(layers, list):
        return [_dropout(v, p) for v in layers]
    return layers


def _port(layers, model_id="t", seed=0):
    return NeuralNetworkModel(model_id, Mapper(layers, ADAMW), device="cpu",
                              seed=seed)


# -- decode priority ----------------------------------------------------------

def test_decode_priority_yield(monkeypatch):
    """The window returns at once when idle, waits while a decode is
    pending (bounded by the cap), and not at all with the cap at 0."""
    t0 = time.monotonic()
    model_mod._yield_to_decodes()
    assert time.monotonic() - t0 < 0.05
    monkeypatch.setenv(model_mod.DECODE_PRIORITY_ENV, "2000")

    def decode(hold):
        with model_mod.decode_priority():
            time.sleep(hold)

    th = threading.Thread(target=decode, args=(0.15,))
    th.start()
    deadline = time.monotonic() + 2.0
    while model_mod.decode_pending() == 0 and time.monotonic() < deadline:
        time.sleep(0.002)
    assert model_mod.decode_pending() > 0
    t0 = time.monotonic()
    model_mod._yield_to_decodes()
    waited = time.monotonic() - t0
    th.join()
    assert 0.05 < waited < 1.5, waited
    monkeypatch.setenv(model_mod.DECODE_PRIORITY_ENV, "0")
    th = threading.Thread(target=decode, args=(0.3,))
    th.start()
    while model_mod.decode_pending() == 0:
        time.sleep(0.002)
    t0 = time.monotonic()
    model_mod._yield_to_decodes()
    assert time.monotonic() - t0 < 0.05
    th.join()
    assert model_mod.decode_pending() == 0


def test_generation_marks_decodes_pending(shared, toy_gpt_layers,
                                          monkeypatch):
    """Single-sequence and batched generation hold the pending mark while
    they dispatch, and drop it after."""
    model = _port(toy_gpt_layers)
    seen = []
    real = model_mod.decode_graphs.DecodeRunner.decode

    def decode(self, chunk):
        seen.append(model_mod.decode_pending())
        return real(self, chunk)

    monkeypatch.setattr(model_mod.decode_graphs.DecodeRunner, "decode",
                        decode)
    model.generate_tokens([1, 2], 16, 4, temperature=0)
    model.generate_tokens_batched([[1, 2], [3]], 16, 3, temperature=0)
    assert seen and all(n >= 1 for n in seen)
    assert model_mod.decode_pending() == 0


def test_train_microstepped_matches_plain(shared, toy_gpt_layers,
                                          monkeypatch):
    """Under a pending decode the epoch runs micro-step by micro-step with
    windows between them: the same parameters and costs as without."""
    monkeypatch.setenv(model_mod.DECODE_PRIORITY_ENV, "1")
    plain = _port(toy_gpt_layers, "plain")
    plain.train_model(shared, epochs=2, batch_size=4, block_size=16,
                      step_size=1)
    chunked = _port(toy_gpt_layers, "chunked")
    with model_mod.decode_priority():
        chunked.train_model(shared, epochs=2, batch_size=4, block_size=16,
                            step_size=1)
    assert chunked.status["code"] == "Trained"
    for (k, a), (_, b) in zip(plain.arch.state_dict().items(),
                              chunked.arch.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    assert [p["cost"] for p in chunked.progress] == \
        [p["cost"] for p in plain.progress]


def test_train_microstepped_yields_between_micro_steps(shared, toy_gpt_layers,
                                                       monkeypatch):
    """With a decode pending: one window before each epoch and one before
    each of its micro-steps but the first (2 epochs x (1 + 3))."""
    monkeypatch.setenv(model_mod.DECODE_PRIORITY_ENV, "1")
    calls = []
    monkeypatch.setattr(model_mod, "_yield_to_decodes",
                        lambda: calls.append(1))
    model = _port(toy_gpt_layers)
    with model_mod.decode_priority():
        model.train_model(shared, epochs=2, batch_size=4, block_size=16,
                          step_size=1)
    assert len(calls) == 2 * 4, calls
    calls.clear()
    model.train_model(shared, epochs=2, batch_size=4, block_size=16,
                      step_size=1)
    assert len(calls) == 2      # no decode: the between-epoch windows only


# -- rematerialization --------------------------------------------------------

def test_under_remat():
    """The cross-entropy function under ``torch.utils.checkpoint`` still
    gives ``F.cross_entropy``'s gradient."""
    from torch.utils import checkpoint as ckpt
    rng = np.random.default_rng(3)
    logits = torch.tensor(rng.normal(size=(4, 65)), dtype=torch.float32,
                          requires_grad=True)
    targets = torch.tensor(rng.integers(0, 65, (4,)))
    loss = ckpt.checkpoint(losses.fused_cross_entropy_mean, logits, targets,
                           use_reentrant=False)
    (grad,) = torch.autograd.grad(loss, logits)
    ref = logits.detach().clone().requires_grad_(True)
    (want,) = torch.autograd.grad(F.cross_entropy(ref, targets), ref)
    torch.testing.assert_close(grad, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["gpt", "hybrid"])
def test_remat_epoch_equals_plain_with_dropout(shared, toy_gpt_layers,
                                               toy_hybrid_layers, monkeypatch,
                                               which):
    """Dropout on (layers and attention): a ``PENROZ_REMAT=1`` run gives
    the plain run's costs and parameters exactly (the replay draws the
    same dropout seeds), and runs each micro-step's forward twice."""
    layers = _dropout(toy_gpt_layers if which == "gpt"
                      else toy_hybrid_layers)
    plain = _port(layers, "plain")
    plain.train_model(shared, epochs=2, batch_size=4, block_size=16,
                      step_size=2)
    remat = _port(layers, "remat")
    calls = []
    remat.arch.layers[-2].register_forward_hook(
        lambda *args: calls.append(1))
    monkeypatch.setenv(model_mod.REMAT_ENV, "1")
    remat.train_model(shared, epochs=2, batch_size=4, block_size=16,
                      step_size=2)
    assert remat.status["code"] == "Trained"
    # epochs x micro-steps x (forward, replay), and the /stats/ pass
    assert len(calls) == 2 * 2 * 2 + 1
    assert [p["cost"] for p in remat.progress] == \
        [p["cost"] for p in plain.progress]
    for (k, a), (_, b) in zip(plain.arch.state_dict().items(),
                              remat.arch.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)


def test_remat_drops_the_replay_seeds_without_the_restore(shared,
                                                          toy_gpt_layers):
    """The generator restore is what makes the replay exact: without it
    the replay's masks differ and so do the gradients (a check that the
    remat test above can fail)."""
    from torch.utils import checkpoint as ckpt
    model = _port(_dropout(toy_gpt_layers, 0.3))
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.integers(0, 64, (2, 16)))
    y = torch.tensor(rng.integers(0, 64, (2, 16)))
    params = {k: p.detach().requires_grad_(True)
              for k, p in model.arch.named_parameters()}

    def loss(params, x, y, gen):
        return torch.func.functional_call(
            model.arch, params, (x, y),
            {"skip_softmax": True, "training": True, "generator": gen})[1]

    def grads(run):
        gen = torch.Generator().manual_seed(7)
        cost = run(gen)
        cost.backward()
        out = [p.grad.clone() for p in params.values()]
        for p in params.values():
            p.grad = None
        return out

    plain = grads(lambda g: loss(params, x, y, g))
    restored = grads(lambda g: model_mod.remat_loss(
        lambda p, a, b: loss(p, a, b, g), g, model.arch, params, x, y))
    naive = grads(lambda g: ckpt.checkpoint(
        loss, params, x, y, g, use_reentrant=False))
    for a, b in zip(plain, restored):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    assert any(not torch.equal(a, b) for a, b in zip(plain, naive))


def test_adapter_remat_equals_plain(shared, toy_gpt_layers, monkeypatch):
    """An adapter run under ``PENROZ_REMAT=1`` trains the same factors."""
    layers = _dropout(toy_gpt_layers)
    base = _port(layers, "base")
    base.serialize(sync_flush=True)
    cfg = {"rank": 2, "init": "random", "seed": 1}
    run = dict(shard=0, epochs=2, batch_size=4, block_size=16, step_size=2)
    plain = lora.train_adapter(base, "a_plain", cfg, shared, **run)
    monkeypatch.setenv(model_mod.REMAT_ENV, "1")
    remat = lora.train_adapter(base, "a_remat", cfg, shared, **run)
    for k in plain:
        torch.testing.assert_close(remat[k], plain[k], rtol=0, atol=0)


# -- the worker process -------------------------------------------------------

def test_train_worker_process_completes(shared, toy_gpt_layers, monkeypatch):
    """``PENROZ_TRAIN_WORKER=1`` trains in a child process; the parent
    reads ``Trained`` and the epochs' progress from the checkpoint."""
    monkeypatch.setenv(model_mod.TRAIN_WORKER_ENV, "1")
    _port(toy_gpt_layers, "wrk").serialize(sync_flush=True)
    out = NeuralNetworkModel.train_model_on_device("wrk", "cpu", shared, 0,
                                                   2, 4, 16, 1)
    assert out.status["code"] == "Trained"
    assert len(out.progress) == 2
    assert np.isfinite(out.progress[-1]["cost"])
    assert not model_mod._TRAIN_WORKERS


def test_train_worker_crash_contained(shared, toy_gpt_layers, monkeypatch):
    """A worker killed mid-run: the parent marks the model ``Error`` (the
    JAX message) and the last checkpoint still generates."""
    monkeypatch.setenv(model_mod.TRAIN_WORKER_ENV, "1")
    _port(toy_gpt_layers, "wrkk").serialize(sync_flush=True)
    result = {}

    def run():
        result["model"] = NeuralNetworkModel.train_model_on_device(
            "wrkk", "cpu", shared, 0, 100000, 4, 16, 1)

    th = threading.Thread(target=run)
    th.start()
    deadline = time.monotonic() + WAIT_S
    proc = None
    while time.monotonic() < deadline:
        proc = model_mod._TRAIN_WORKERS.get("wrkk")
        if proc is not None:
            try:
                if tckpt.peek_tree("wrkk")["status"]["code"] == "Training":
                    break
            except Exception:  # noqa: BLE001 — a checkpoint mid-write
                pass
        time.sleep(0.05)
    assert proc is not None, "the worker never started"
    proc.kill()
    th.join(timeout=WAIT_S)
    assert not th.is_alive()
    out = result["model"]
    assert out.status["code"] == "Error"
    assert out.status["message"].startswith("Training worker died (rc=")
    assert len(out.generate_tokens([1, 2], 16, 3, temperature=0)) == 5


@pytest.mark.parametrize("adapter", [False, True], ids=["model", "adapter"])
def test_train_worker_clean_failure_exits_nonzero_and_parent_logs(
        shared, toy_gpt_layers, monkeypatch, adapter):
    """A clean failure in the worker (a missing dataset: status ``Error``)
    exits nonzero and the parent logs it (the model's run and an adapter
    run, whose exit code reads the adapter's status)."""
    monkeypatch.setenv(model_mod.TRAIN_WORKER_ENV, "1")
    _port(toy_gpt_layers, "mtgpt").serialize(sync_flush=True)
    errors = []
    monkeypatch.setattr(model_mod.log, "error",
                        lambda msg, *args, **kw: errors.append(
                            msg % tuple(args) if args else msg))
    spec = {"adapter_id": "wa", "rank": 2} if adapter else None
    model = NeuralNetworkModel.train_model_on_device(
        "mtgpt", "cpu", "no-such-dataset", 0, 1, 1, 8, 1, adapter=spec)
    if adapter:
        assert tckpt.peek_adapter_tree("wa")["status"]["code"] == "Error"
        assert model.status["code"] != "Training"
        assert any("Adapter-training worker for wa" in m and "rc=1" in m
                   for m in errors), errors
    else:
        assert model.status["code"] == "Error"
        assert any("Training worker for model mtgpt" in m and "rc=1" in m
                   for m in errors), errors


# -- the orphan sweep ---------------------------------------------------------

def test_orphaned_training_swept_at_startup(shared, toy_gpt_layers):
    """A checkpoint of either package left at ``Training`` reads ``Error``
    (the JAX message) after the port's ``create_app``, as after the JAX
    package's sweep on the same file; another status is untouched, and
    the weights survive the header rewrite."""
    jm = JModel("jorph", JMapper(toy_gpt_layers, ADAMW))
    jm.status = {"code": "Training", "message": None}
    jm.serialize(sync_flush=True)
    for mid, code in (("torph", "Training"), ("done", "Trained")):
        m = _port(toy_gpt_layers, mid)
        m.status = {"code": code, "message": "m"}
        m.serialize(sync_flush=True)
    before = NeuralNetworkModel.deserialize("torph", device="cpu")
    assert tckpt.list_model_ids() == ["done", "jorph", "torph"]
    srv = tapp.create_app(device="cpu")
    srv.server_close()
    ours = {mid: tckpt.peek_tree(mid)["status"]
            for mid in ("jorph", "torph", "done")}
    assert ours["done"] == {"code": "Trained", "message": "m"}
    for mid in ("jorph", "torph"):
        assert ours[mid] == {"code": "Error", "message":
                             "Training interrupted by server restart"}
    after = NeuralNetworkModel.deserialize("torph", device="cpu")
    for (k, a), (_, b) in zip(before.arch.state_dict().items(),
                              after.arch.state_dict().items()):
        torch.testing.assert_close(b, a, rtol=0, atol=0, msg=k)
    # the JAX sweep reads the port's rewrite, and rewrites an orphan the
    # way the port does, byte for byte in the header
    assert jckpt.peek_tree("torph")["status"] == ours["torph"]
    for mid in ("jorph", "torph"):
        tckpt.patch_meta(mid, {"status": {"code": "Training",
                                          "message": None}})
    japp._sweep_orphaned_training()
    theirs = {mid: jckpt.peek_tree(mid)["status"] for mid in ("jorph",
                                                              "torph")}
    assert theirs == {mid: ours[mid] for mid in theirs}
    with open(tckpt.model_path("torph"), "rb") as f:
        jax_header, _ = tckpt._read_header(f)
    tckpt.patch_meta("torph", {"status": {"code": "Training",
                                          "message": None}})
    tapp._sweep_orphaned_training()
    with open(tckpt.model_path("torph"), "rb") as f:
        port_header, _ = tckpt._read_header(f)
    assert json.dumps(port_header) == json.dumps(jax_header)
    assert JModel.deserialize("jorph").status["code"] == "Error"
