"""Training over two gloo ranks on the CPU against the JAX package's
single-device run: data parallelism, ``PENROZ_WUS`` (ZeRO-1) and
``PENROZ_FSDP`` (ZeRO-3), their evaluation, their shard files, and the
data-axis sharding rule.

The equivalence holds by construction: W ranks of ``batch_size`` b and
``step_size`` s read, micro-step by micro-step, the rows one process reads
at ``batch_size`` W·b and ``step_size`` s·W² (rank r's loader starts at
``buffer_size·r`` and moves by ``buffer_size·W``; ``num_steps`` is divided
by W), and the global mean loss is the ranks' mean.  Here W = 2, b = 8,
s = 2 against the JAX package at 16 and 8 (``PENROZ_TRAIN_MESH=0``: one
device), two micro-steps an epoch either way, on
``tests/test_multihost_real.py``'s toy (d 32, 1 block, vocab 64, block
16) with AdamW.  Tolerances are the JAX package's own for its data
parallelism (tests/test_parallel.py): costs rtol 1e-4, parameters atol
1e-5, evaluation rtol 1e-5; the ranks' replicas bit for bit; WUS and FSDP
within 1e-5 of DP everywhere.

One exception against the JAX package: the key third of the fused QKV
projection's bias (elements 32-63 at d 32) has a zero gradient in exact
arithmetic (every score of a query moves by the same q·b_k, which the
softmax ignores), so AdamW's normalised step there follows the sign of
rounding noise, which no two summation orders share.  Any two runs differ
there by up to about lr a step — this package on one device against the
JAX package's differ by 9.9e-5 after two steps, this package's DP against
its own one device by 3.3e-5 — so those elements are held within
2·lr·epochs (every other element of every parameter within 1e-5; measured
at most 3e-8)."""

import glob
import os

import jax
import numpy as np
import pytest
import torch

from _torch_rank_worker import run_ranks
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.parallel import mesh as mesh_lib
from penroz_tpu.parallel import sharding as jsharding
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.parallel import sharding
from penroz_tpu_torch.utils import checkpoint as tckpt
from test_multihost_real import _LAYERS, _OPT

RUN = {"dataset_id": "mh", "shard": 0, "epochs": 2, "batch_size": 8,
       "block_size": 16, "step_size": 2}
MODES = {"dp": {}, "wus": {"PENROZ_WUS": "1"}, "fsdp": {"PENROZ_FSDP": "1"}}
EVAL = ["mh", None, 0, 2, 8, 16, 1]
KEY_BIAS = ("layers.1.0.1.bias", slice(32, 64))
KEY_BIAS_ATOL = 2 * _OPT["adamw"]["lr"] * RUN["epochs"]


def _assert_near_oracle(key, got, want):
    got, want = np.array(got), np.array(want)
    if key == KEY_BIAS[0]:
        np.testing.assert_allclose(got[KEY_BIAS[1]], want[KEY_BIAS[1]],
                                   atol=KEY_BIAS_ATOL, err_msg=key)
        got[KEY_BIAS[1]] = want[KEY_BIAS[1]]
    np.testing.assert_allclose(got, want, atol=1e-5, err_msg=key)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' runs (DP, WUS, FSDP from one checkpoint of the JAX
    package's, then the DP model's evaluation), and the JAX package's
    single-device run and evaluation of the same rows."""
    d = tmp_path_factory.mktemp("zero")
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(d)
        mp.setattr(jckpt, "SHM_PATH", str(d / "shm"))
        mp.setattr(tckpt, "SHM_PATH", str(d / "shm"))
        (d / "data").mkdir()
        np.save(d / "data" / "mh_000000",
                np.random.default_rng(0).integers(0, 64, 8000)
                .astype(np.uint16))
        JModel("init", JMapper(_LAYERS, _OPT)).serialize(sync_flush=True)
        jobs = [{"op": "train", "init": "init", "model_id": mode,
                 "env": env, "run": RUN} for mode, env in MODES.items()]
        jobs.append({"op": "evaluate", "model_id": "dp", "args": EVAL})
        reports = run_ranks(d, jobs, timeout=240)
        mp.setenv("PENROZ_TRAIN_MESH", "0")
        oracle = JModel.deserialize("init")
        oracle.model_id = "oracle"
        oracle.train_model("mh", shard=0, epochs=2, batch_size=16,
                           block_size=16, step_size=8)
        jax_eval = JModel.deserialize("dp").evaluate_model(
            "mh", None, 0, 2, 16, 16, 1)
    gathered = {mode: [dict(np.load(d / f"rank{r}_{mode}.npz"))
                       for r in range(2)] for mode in MODES}
    return {"dir": d, "reports": reports, "gathered": gathered,
            "oracle": {k: np.asarray(v) for k, v in oracle.params.items()},
            "oracle_costs": [p["cost"] for p in oracle.progress],
            "jax_eval": jax_eval}


@pytest.fixture
def in_runs(runs, monkeypatch):
    """Read the runs' checkpoints from their directory, both packages."""
    monkeypatch.chdir(runs["dir"])
    monkeypatch.setattr(jckpt, "SHM_PATH", str(runs["dir"] / "shm"))
    monkeypatch.setattr(tckpt, "SHM_PATH", str(runs["dir"] / "shm"))
    return runs


@pytest.mark.parametrize("mode", list(MODES))
def test_ranks_train_as_one_device(runs, mode):
    """Both ranks end bit-identical; the master's per-epoch costs and the
    parameters match the JAX package's one device at 16 x 8 (DP, WUS and
    FSDP alike), and WUS and FSDP match DP."""
    rank0, rank1 = runs["gathered"][mode]
    assert sorted(rank0) == sorted(rank1)
    for key in rank0:
        np.testing.assert_array_equal(rank0[key], rank1[key], err_msg=key)
    report = runs["reports"][0]["train"][mode]
    assert report["status"] == "Trained"
    assert runs["reports"][1]["train"][mode]["progress"] == []
    np.testing.assert_allclose(report["progress"], runs["oracle_costs"],
                               rtol=1e-4)
    dp = runs["gathered"]["dp"][0]
    for key, want in runs["oracle"].items():
        _assert_near_oracle(key, rank0[f"p:{key}"], want)
        np.testing.assert_allclose(rank0[f"p:{key}"], dp[f"p:{key}"],
                                   atol=1e-5, err_msg=key)


def test_evaluation_over_ranks_matches_jax(runs):
    """Both ranks report the same cost, the JAX package's at batch 16."""
    costs = [r["evaluate"]["dp"] for r in runs["reports"]]
    assert costs[0] == costs[1]
    np.testing.assert_allclose(costs[0], runs["jax_eval"], rtol=1e-5)


def _jax_cut_dims(params: dict) -> dict:
    """The dim JAX's ``_data_axis_spec`` gives each parameter on a 2-way
    data axis (None: whole)."""
    mesh = mesh_lib.make_mesh(jax.devices("cpu")[:2])
    out = {}
    for key, shape in params.items():
        spec = jsharding._data_axis_spec(
            jsharding.param_spec(key, shape, mesh), shape, mesh)
        dims = [i for i, axis in enumerate(spec) if axis == "data"]
        out[key] = dims[0] if dims else None
    return out


@pytest.mark.parametrize("mode", ["wus", "fsdp"])
def test_each_rank_holds_half_of_every_cut_leaf(runs, mode):
    """Every leaf JAX's rule cuts is held as half its elements on each
    rank: the moments under WUS, and the parameters too under FSDP
    (bytes held between steps against DP's)."""
    shapes = {k: v.shape for k, v in runs["oracle"].items()}
    cut = {k for k, d in _jax_cut_dims(shapes).items() if d is not None}
    dp = runs["reports"][0]["train"]["dp"]["held"]
    for report in runs["reports"]:
        entry = report["train"][mode]
        assert set(entry["pieces"]) == cut
        for key, (held, full) in entry["pieces"].items():
            assert 2 * held == full == int(np.prod(shapes[key])), key
        whole = sum(int(np.prod(shapes[k])) * 4 for k in shapes
                    if k not in cut)
        assert entry["held"]["moments"] == (dp["moments"] - 2 * whole) / 2 \
            + 2 * whole
        want_params = (dp["params"] if mode == "wus"
                       else (dp["params"] - whole) / 2 + whole)
        assert entry["held"]["params"] == want_params


@pytest.mark.parametrize("mode", ["wus", "fsdp"])
def test_jax_reassembles_the_port_shard_files(in_runs, mode):
    """Two shard files; the JAX package's ``deserialize`` reassembles
    them into the port's own load and the ranks' gathered state, bit for
    bit (parameters and optimizer leaves)."""
    shards = sorted(glob.glob(f"models/model_{mode}.shard*.ckpt"))
    assert [os.path.basename(p) for p in shards] == [
        f"model_{mode}.shard0.ckpt", f"model_{mode}.shard1.ckpt"]
    meta = tckpt.peek_tree(mode)
    assert meta["shard_tag"] == RUN["epochs"] and meta["sharded"]
    jm = JModel.deserialize(mode)
    tm = NeuralNetworkModel.deserialize(mode, device="cpu")
    gathered = in_runs["gathered"][mode][0]
    port = tm.state_dict()
    for key, value in jm.params.items():
        np.testing.assert_array_equal(_bits(value), port[key].numpy())
        np.testing.assert_array_equal(_bits(value), gathered[f"p:{key}"])
    leaves = jax.tree.leaves(jm.opt_state)
    assert len(leaves) == len(tm._opt_leaves)
    for i, leaf in enumerate(leaves):
        np.testing.assert_array_equal(_bits(leaf),
                                      torch.as_tensor(tm._opt_leaves[i])
                                      .numpy())
        np.testing.assert_array_equal(_bits(leaf), gathered[f"o:{i}"])


@pytest.mark.parametrize("world", [2, 3, 4])
def test_cut_rule_is_the_jax_data_axis_rule(world, toy_gpt_layers):
    """parallel/sharding.py's cut dim of every parameter of two toy
    stacks (and of odd shapes) equals JAX's ``_data_axis_spec`` over a
    data axis of ``world`` devices, and the ranks' ranges tile it."""
    from penroz_tpu.models.model import CompiledArch
    shapes = {}
    for layers in (toy_gpt_layers, _LAYERS):
        params, _ = JMapper(layers, _OPT).init_params(
            CompiledArch.get(layers).mods, seed=0)
        shapes.update({k: tuple(v.shape) for k, v in params.items()})
    shapes.update({"odd.weight": (3, 5), "odd.bias": (7,), "s": (),
                   "m.experts.w": (6, 4, 9)})
    mesh = mesh_lib.make_mesh(jax.devices("cpu")[:world])
    for key, shape in shapes.items():
        spec = jsharding._data_axis_spec(
            jsharding.param_spec(key, shape, mesh), shape, mesh)
        want = [i for i, axis in enumerate(spec) if axis == "data"]
        got = sharding.shard_dim(key, shape, world)
        assert (got,) == (tuple(want) or (None,)), key
        if got is None:
            continue
        stops = [sharding.rank_ranges(shape, got, world, r)[got]
                 for r in range(world)]
        assert stops[0][0] == 0 and stops[-1][1] == shape[got]
        assert all(a[1] == b[0] for a, b in zip(stops, stops[1:]))


@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_spec_is_jax_param_spec(model, toy_gpt_layers):
    """The tensor-parallel spec the data rule reads equals JAX's
    ``param_spec`` for a model axis of ``model``."""
    from penroz_tpu.models.model import CompiledArch
    params, _ = JMapper(toy_gpt_layers, _OPT).init_params(
        CompiledArch.get(toy_gpt_layers).mods, seed=0)
    mesh = mesh_lib.make_mesh(jax.devices("cpu")[:4], model=model)
    for key, value in params.items():
        shape = tuple(value.shape)
        want = tuple(jsharding.param_spec(key, shape, mesh))
        got = sharding.param_spec(key, shape, model=model)
        assert got == want, key
