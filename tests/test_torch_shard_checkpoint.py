"""Checkpoints sharded over ranks, both ways between the packages: shard
files the JAX package writes (``checkpoint.save`` and ``save_shard``,
pieces cut by its own ``_data_axis_spec`` through its ``NamedSharding``s
over a 2-way data axis: FSDP's parameters and WUS's moments) load in the
port bit for bit equal to the JAX package's load, in fp32 and in bf16; a
torn tag and a missing shard raise the same error in both; the port's
shard-file housekeeping (pruning, delete, reading only the parameters'
pieces); and the port's sharded saves in process (ranks faked): a tagged
save writes the rank's pieces, an untagged one only the master's
metadata."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.parallel import mesh as mesh_lib
from penroz_tpu.parallel import sharding as jsharding
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.parallel import dist, zero
from penroz_tpu_torch.utils import checkpoint as tckpt

TAG = 3


@pytest.fixture
def port_dir(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _jax_sharded_checkpoint(model_id, layers, optimizer, shards, dtype):
    """A JAX model trained one epoch (moments that are not zero), cast to
    ``dtype``, written as the JAX package's ``serialize`` writes a state
    whose parameters (FSDP) and moments (WUS) are cut over a 2-way data
    axis: each device's pieces, by ``devices_indices_map``, to its rank's
    shard file; the rest and the ``sharded`` metadata to the blob."""
    jm = JModel(model_id, JMapper(layers, optimizer))
    jm.train_model(shards, epochs=1, batch_size=2, block_size=16)
    if dtype == "bfloat16":
        cast = (lambda x: x.astype(jnp.bfloat16)
                if jnp.issubdtype(x.dtype, jnp.floating) else x)
        jm.params = {k: cast(v) for k, v in jm.params.items()}
        jm.opt_state = jax.tree.map(cast, jm.opt_state)
    devices = jax.devices("cpu")[:2]
    mesh = mesh_lib.make_mesh(devices)
    specs = dict(jsharding.param_shardings(jm.params, mesh, fsdp=True))
    opt_specs = jax.tree.leaves(jsharding.opt_state_sharding_tree(
        jm.opt_state, jm.params, mesh, wus=True))
    specs.update({f"__opt__{i}": s for i, s in enumerate(opt_specs)})
    items = jm._checkpoint_items()
    pieces = [{}, {}]
    sharded, host = {}, {}
    for name, value in items.items():
        arr = np.asarray(value)
        spec = specs.get(name)
        if spec is None or spec.is_fully_replicated:
            host[name] = arr
            continue
        sharded[name] = {"shape": tuple(arr.shape), "dtype": str(arr.dtype)}
        for device, idx in spec.devices_indices_map(arr.shape).items():
            pieces[devices.index(device)][name] = [
                (tuple((sl.start, sl.stop) for sl in idx), arr[idx])]
    assert sharded and all(pieces)
    n_opt = sum(1 for n in items if n.startswith("__opt__"))
    jckpt.save(model_id, {
        "layers": layers, "optimizer": optimizer,
        "params": {k: v for k, v in host.items()
                   if not k.startswith(("__buf__", "__opt__"))},
        "buffers": {k: host[f"__buf__{k}"] for k in jm.buffers},
        "opt_state_leaves": {i: host[f"__opt__{i}"] for i in range(n_opt)
                             if f"__opt__{i}" in host},
        "sharded": sharded, "shard_tag": TAG, "progress": jm.progress,
        "avg_cost": jm.avg_cost, "avg_cost_history": jm.avg_cost_history,
        "stats": None, "status": jm.status}, sync_flush=True)
    for rank in range(2):
        jckpt.save_shard(model_id, rank, {"tag": TAG, "pieces": pieces[rank]},
                         sync_flush=True, world=2)
    return sharded


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jax_shard_files_load_in_the_port(port_dir, toy_shards,
                                          toy_gpt_layers, toy_optimizer,
                                          dtype):
    """The port's load of the JAX package's sharded checkpoint equals the
    JAX package's own load bit for bit: every parameter, buffer and
    optimizer leaf; the serving load (no optimizer) too."""
    model_id = f"js{dtype[:4]}"
    sharded = _jax_sharded_checkpoint(model_id, toy_gpt_layers,
                                      toy_optimizer, toy_shards, dtype)
    assert any(n.startswith("__opt__") for n in sharded)
    assert any(not n.startswith("__opt__") for n in sharded)
    jm = JModel.deserialize(model_id)
    tm = NeuralNetworkModel.deserialize(model_id, device="cpu")
    port = tm.state_dict()
    assert sorted(port) == sorted(list(jm.params) + list(jm.buffers))
    for key, value in list(jm.params.items()) + list(jm.buffers.items()):
        assert port[key].dtype == (torch.bfloat16 if str(value.dtype)
                                   == "bfloat16" else port[key].dtype)
        np.testing.assert_array_equal(_bits(port[key]), _bits(value),
                                      err_msg=key)
    leaves = jax.tree.leaves(jm.opt_state)
    assert sorted(tm._opt_leaves) == list(range(len(leaves)))
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(_bits(tm._opt_leaves[i]), _bits(leaf))
    light = NeuralNetworkModel.deserialize(model_id, device="cpu",
                                           optimizer=False)
    for key, value in light.state_dict().items():
        np.testing.assert_array_equal(_bits(value), _bits(port[key]))


@pytest.mark.parametrize("fault", ["torn", "missing"])
def test_torn_and_missing_shards_raise_as_in_jax(port_dir, toy_shards,
                                                 toy_gpt_layers,
                                                 toy_optimizer, fault):
    """A shard file of another step, or a rank's file gone: both packages
    raise RuntimeError with the same message."""
    _jax_sharded_checkpoint("bad", toy_gpt_layers, toy_optimizer,
                            toy_shards, "float32")
    if fault == "torn":
        payload = jckpt.load_shards("bad")[1]
        payload["tag"] = TAG - 1
        jckpt.save_shard("bad", 1, payload, sync_flush=True)
        match = "is torn: shard file #1 is from step 2"
    else:
        jckpt._remove_shard_files("bad", 1)
        match = "is incomplete: .* across 1 shard file"
    with pytest.raises(RuntimeError, match=match) as want:
        JModel.deserialize("bad")
    with pytest.raises(RuntimeError) as got:
        NeuralNetworkModel.deserialize("bad", device="cpu")
    assert str(got.value) == str(want.value)


def test_shard_files_are_found_pruned_and_deleted(port_dir):
    """Both packages see the same shard indices; rank 0's save removes
    the files of ranks at or past ``world``; delete removes every shard
    file, shm and durable copies alike."""
    for rank in (0, 1, 2, 5):
        jckpt.save_shard("m", rank, {"tag": 1, "pieces": {}},
                         sync_flush=True)
    assert tckpt._shard_indices("m") == jckpt._shard_indices("m") \
        == [0, 1, 2, 5]
    tckpt.save_shard("m", 0, {"tag": 2, "pieces": {}}, sync_flush=True,
                     world=2)
    assert tckpt._shard_indices("m") == jckpt._shard_indices("m") == [0, 1]
    assert [p["tag"] for p in tckpt.load_shards("m")] == [2, 1]
    assert [p["tag"] for p in jckpt.load_shards("m")] == [2, 1]
    tckpt.delete("m")
    assert tckpt._shard_indices("m") == []
    assert not os.listdir("models")


def test_load_shards_reads_only_the_pieces_asked(port_dir):
    """The serving load reads no moment piece: with a predicate, the
    other pieces' arrays decode to None."""
    piece = np.arange(4, dtype=np.float32)
    tckpt.save_shard("p", 0, {"tag": 1, "pieces": {
        "w": [(((0, 4),), piece)], "__opt__1": [(((0, 4),), piece)]}},
        sync_flush=True)
    (shard,) = tckpt.load_shards("p", pieces=lambda n: n == "w")
    assert shard["pieces"]["__opt__1"][0][1] is None
    np.testing.assert_array_equal(shard["pieces"]["w"][0][1].numpy(), piece)
    assert shard["pieces"]["w"][0][0] == [[0, 4]]


@pytest.mark.parametrize("stage", [1, 3])
def test_sharded_saves_in_process(port_dir, toy_gpt_layers, toy_optimizer,
                                  monkeypatch, stage):
    """Rank 0 of 2 (faked; no collective runs): a tagged save writes its
    shard file with its half of every cut moment (and, stage 3, of every
    cut parameter) and a blob without them; an untagged save (the error
    path's) rewrites only the blob's metadata; the whole optimizer is
    refused while the state is sharded."""
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 0)
    tm = NeuralNetworkModel("z", Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu")
    tm.serialize(sync_flush=True)
    leaves = tm._opt_state_leaves()
    tm._replicas = zero.DataParallel(
        dict(tm.arch.named_parameters()), toy_optimizer, stage=stage,
        leaves=leaves)
    tm.serialize(sync_flush=True, tag=7)
    (shard,) = tckpt.load_shards("z")
    blob = tckpt.load("z")
    assert shard["tag"] == blob["shard_tag"] == 7
    assert set(shard["pieces"]) == set(blob["sharded"])
    cut_params = [n for n in shard["pieces"] if not n.startswith("__opt__")]
    assert bool(cut_params) == (stage == 3)
    assert not set(cut_params) & set(blob["params"])
    for name, [(ranges, piece)] in shard["pieces"].items():
        full = blob["sharded"][name]["shape"]
        assert 2 * piece.numel() == int(np.prod(full)), name
        assert sum(a is not None for a, _ in ranges) == 1
    with pytest.raises(RuntimeError, match="sharded over ranks"):
        tm.optimizer
    tm.status = {"code": "Error", "message": "boom"}
    tm.serialize(sync_flush=True)
    after = tckpt.load("z")
    assert after["status"]["code"] == "Error" and after["shard_tag"] == 7
    assert tckpt.load_shards("z")[0]["tag"] == 7
    for key, value in blob["params"].items():
        torch.testing.assert_close(after["params"][key], value)
