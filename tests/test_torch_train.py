"""The port's training path on the CPU against the JAX package's, from the
same initial weights (carried over by ``from_jax_state_dict``) and the same
shards: ``train_model`` parameters, per-epoch cost and update ratios, and
the average cost; a second run continuing from each package's checkpoint
(the saved Adam moments); ``num_steps > 1``; and the checkpoint repair —
each package loads and continues a model the other trained.

Both sides train in fp32 (the CPU).  Tolerances: costs rtol 1e-5 (the same
fp32 forward, summed in another order); parameters atol 1e-4 (after Adam
steps of lr 1e-3, where a gradient entry near zero can turn a normalised
step of up to lr); update ratios atol 1e-3 relative to ratios near
lr / std(w)."""

import numpy as np
import pytest
import torch

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.utils import checkpoint as tckpt

RUN = dict(epochs=2, batch_size=2, block_size=16, step_size=1)


@pytest.fixture
def port_dir(workdir, monkeypatch):
    """Both packages read and write the same models/ and shm dirs, inside
    the test's temporary directory."""
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


@pytest.fixture
def shared(port_dir, toy_shards):
    return toy_shards


def _pair(layers, optimizer, jid="j", tid="t"):
    jm = JModel(jid, JMapper(layers, optimizer))
    tm = from_jax_state_dict(jm.state_dict(), layers, optimizer,
                             model_id=tid, device="cpu")
    return jm, tm


def _assert_same(jm, tm, param_atol=1e-4):
    assert len(jm.progress) == len(tm.progress)
    for a, b in zip(jm.progress, tm.progress):
        assert a["epoch"] == b["epoch"]
        np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-5)
        np.testing.assert_allclose(b["weight_upd_ratio"],
                                   a["weight_upd_ratio"], atol=1e-3)
        assert set(b) == {"epoch", "cost", "durationInSecs", "speedPerSec",
                          "weight_upd_ratio"}
    np.testing.assert_allclose(tm.avg_cost, jm.avg_cost, rtol=1e-5)
    assert len(tm.avg_cost_history) == len(jm.avg_cost_history)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    for key in jsd:
        np.testing.assert_allclose(tsd[key].numpy(), jsd[key],
                                   atol=param_atol, err_msg=key)


@pytest.mark.parametrize("step_size", [1, 2], ids=["one_step", "two_steps"])
def test_train_matches_jax(shared, toy_gpt_layers, toy_optimizer, step_size):
    jm, tm = _pair(toy_gpt_layers, toy_optimizer)
    run = dict(RUN, batch_size=4 if step_size == 2 else 2,
               step_size=step_size)  # batch 4 / step 2: two micro-steps
    jm.train_model(shared, **run)
    tm.train_model(shared, **run)
    _assert_same(jm, tm)
    assert tm.status["code"] == "Trained"
    assert tm.arch.param_order == jm.arch.param_order
    assert len(tm.progress[-1]["weight_upd_ratio"]) == len(
        jm.arch.param_order)


def test_second_run_from_each_checkpoint(shared, toy_gpt_layers,
                                         toy_optimizer):
    """Continue each package's checkpoint in the same package, and then in
    the other: the saved moments carry over both ways."""
    jm, tm = _pair(toy_gpt_layers, toy_optimizer)
    jm.train_model(shared, **RUN)
    tm.train_model(shared, **RUN)
    jckpt.join_flushes()
    tckpt.join_flushes()
    j2 = JModel.deserialize("j")
    t2 = NeuralNetworkModel.deserialize("t", device="cpu")
    j2.train_model(shared, **RUN)
    t2.train_model(shared, **RUN)
    _assert_same(j2, t2, param_atol=2e-4)
    # the repair: the JAX package continues the port's checkpoint, the port
    # the JAX package's, and each matches the same-package continuation
    tckpt.join_flushes()
    jckpt.join_flushes()
    j_from_t = JModel.deserialize("t")
    t_from_j = NeuralNetworkModel.deserialize("j", device="cpu")
    j_from_t.train_model(shared, **RUN)
    t_from_j.train_model(shared, **RUN)
    _assert_same(j_from_t, t_from_j, param_atol=3e-4)


def test_port_checkpoint_loads_in_jax(shared, toy_optimizer):
    """The fault this repairs: the port wrote ``opt_state_leaves: {}`` and
    the JAX package's deserialize raised 'Too few leaves for PyTreeDef'."""
    layers = presets.gpt2_custom(d=32, heads=4, depth=1, vocab=64, block=16)
    tm = NeuralNetworkModel("fresh", Mapper(layers, presets.ADAMW),
                            device="cpu", seed=3)
    tm.serialize(sync_flush=True)
    jm = JModel.deserialize("fresh")
    import jax
    leaves = jax.tree.leaves(jm.opt_state)
    assert len(leaves) == 1 + 2 * len(jm.params)
    assert int(leaves[0]) == 0 and not any(np.asarray(x).any()
                                           for x in leaves[1:])
    jm.train_model(shared, **RUN)
    assert jm.status["code"] == "Trained"


def test_sgd_momentum_state_round_trips(shared, toy_gpt_layers):
    sgd = {"sgd": {"lr": 0.05, "momentum": 0.9, "nesterov": True}}
    jm, tm = _pair(toy_gpt_layers, sgd)
    jm.train_model(shared, **RUN)
    tm.train_model(shared, **RUN)
    _assert_same(jm, tm)
    tckpt.join_flushes()
    back = NeuralNetworkModel.deserialize("t", device="cpu")
    leaves = tckpt.load("t")["opt_state_leaves"]
    params = dict(back.arch.named_parameters())
    assert len(leaves) == len(params)
    for i, key in enumerate(sorted(params)):
        torch.testing.assert_close(
            leaves[i], tm.optimizer.state[
                dict(tm.arch.named_parameters())[key]]["momentum_buffer"])


def test_missing_dataset_sets_error_status(port_dir, toy_gpt_layers,
                                           toy_optimizer):
    tm = NeuralNetworkModel("err", Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu")
    tm.serialize(sync_flush=True)
    with pytest.raises(ValueError, match="no shards"):
        NeuralNetworkModel.train_model_on_device(
            "err", "cpu", "nonexistent-ds", 0, 1, 2, 16, 1)
    tckpt.join_flushes()
    assert NeuralNetworkModel.deserialize(
        "err", device="cpu").status["code"] == "Error"


def test_unported_options_are_refused(port_dir, toy_gpt_layers,
                                      toy_optimizer, monkeypatch):
    tm = NeuralNetworkModel("opt", Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu")
    tm.serialize(sync_flush=True)
    # adapter training is ported: a bad adapter config still refuses
    with pytest.raises(ValueError, match="rank 4096"):
        NeuralNetworkModel.train_model_on_device(
            "opt", "cpu", "toy", 0, 1, 2, 16, 1,
            adapter={"adapter_id": "a", "rank": 4096})
    monkeypatch.setenv("PENROZ_MESH_MODEL", "2")
    with pytest.raises(ValueError, match="PENROZ_MESH_MODEL"):
        NeuralNetworkModel.train_model_on_device(
            "opt", "cpu", "toy", 0, 1, 2, 16, 1)
    monkeypatch.setenv("PENROZ_MESH_MODEL", "1")
    monkeypatch.setenv("PENROZ_TRAIN_DTYPE", "int8")
    with pytest.raises(ValueError, match="PENROZ_TRAIN_DTYPE"):
        tm.train_model("toy", **RUN)


@pytest.mark.parametrize("knob", ["PENROZ_FSDP", "PENROZ_WUS"])
def test_zero_knobs_on_one_process_train_as_jax(shared, toy_gpt_layers,
                                                toy_optimizer, monkeypatch,
                                                knob):
    """``PENROZ_FSDP=1`` / ``PENROZ_WUS=1`` on one process: no sharding,
    as in the JAX package (whose mesh at this batch is one device);
    training and evaluation equal its single-device run."""
    monkeypatch.setenv(knob, "1")
    jm, tm = _pair(toy_gpt_layers, toy_optimizer)
    jm.train_model(shared, **RUN)
    tm.train_model(shared, **RUN)
    _assert_same(jm, tm)
    assert tm._replicas is None
    assert not tckpt._shard_indices("t")
    args = (shared, None, 0, 2, 2, 16, 1)
    np.testing.assert_allclose(tm.evaluate_model(*args),
                               jm.evaluate_model(*args), rtol=1e-5)


def test_serving_load_skips_optimizer_and_refuses_to_save(
        shared, toy_gpt_layers, toy_optimizer):
    tm = NeuralNetworkModel("srv", Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu")
    tm.train_model(shared, **RUN)
    tckpt.join_flushes()
    light = NeuralNetworkModel.deserialize("srv", device="cpu",
                                           optimizer=False)
    assert light.generate_tokens([1, 2], 16, 3, temperature=0) == \
        tm.generate_tokens([1, 2], 16, 3, temperature=0)
    with pytest.raises(RuntimeError, match="optimizer state"):
        light.serialize()
    meta = tckpt.load("srv", arrays=())
    assert meta["status"]["code"] == "Trained"
    assert all(v is None for v in meta["params"].values())


def test_dropout_training_draws_from_the_generator(workdir):
    """Training-mode dropout (modules and attention) is deterministic under
    a fixed generator and off at inference."""
    layers = presets.gpt2_custom(d=64, heads=1, depth=1, vocab=50, block=16,
                                 dropout=0.2)
    tm = NeuralNetworkModel("d", Mapper(layers, presets.ADAMW),
                            device="cpu")
    x = torch.randint(0, 50, (2, 16), generator=torch.Generator().manual_seed(0))
    costs = []
    with torch.no_grad():
        for _ in range(2):
            g = torch.Generator().manual_seed(5)
            _, cost, _ = tm.arch(x, torch.roll(x, -1, 1), skip_softmax=True,
                                 training=True, generator=g)
            costs.append(float(cost))
        _, plain, _ = tm.arch(x, torch.roll(x, -1, 1), skip_softmax=True)
    assert costs[0] == costs[1] and costs[0] != float(plain)
