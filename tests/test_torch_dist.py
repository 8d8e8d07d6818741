"""parallel/dist.py on ``torch.distributed``: one process against the JAX
package's ``dist`` (tests/test_parallel.py's single-process contract),
the backend rule, a world of one joined in process, and two gloo ranks
on 127.0.0.1 (rank processes of tests/_torch_rank_worker.py): the
topology, ``all_reduce_mean``, the tensor collectives, the store barrier
and its timeout, per-rank log files (tests/test_multihost_real.py's
check), and ``PENROZ_TRAIN_MESH=0`` refused over ranks with the JAX
package's error."""

import logging

import numpy as np
import pytest
import torch

from _torch_rank_worker import _free_port, run_ranks
from penroz_tpu.parallel import dist as jdist
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.parallel import dist
from test_multihost_real import _LAYERS, _OPT

RUN = {"dataset_id": "mh", "shard": 0, "epochs": 1, "batch_size": 8,
       "block_size": 16, "step_size": 2}


def test_single_process_topology_is_jax_dist():
    assert (dist.process_index(), dist.process_count(), dist.master_proc(),
            dist.is_distributed()) == (
        jdist.process_index(), jdist.process_count(), jdist.master_proc(),
        jdist.is_distributed()) == (0, 1, True, False)
    assert dist.initialize() is False is jdist.initialize()
    assert dist.backend() is None


@pytest.mark.parametrize("value", [3.5, -0.25, 1e-30])
def test_single_process_all_reduce_mean_is_identity(value):
    assert dist.all_reduce_mean(value) == value == jdist.all_reduce_mean(value)


def test_single_process_barrier_and_logging_are_no_ops(tmp_path):
    dist.barrier("alone", timeout_s=0.01)
    assert dist.reconfig_logging(str(tmp_path)) is None
    assert jdist.reconfig_logging(str(tmp_path)) is None
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("cards,local_world,want", [
    (0, 1, "gloo"), (0, 2, "gloo"), (1, 2, "gloo"), (1, 1, "nccl"),
    (4, 4, "nccl"), (4, 8, "gloo")])
def test_backend_rule(monkeypatch, cards, local_world, want):
    """NCCL when every rank of the host has a card of its own; gloo for
    CPU ranks and for ranks that share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dist.backend_for(local_world) == want


def test_world_of_one_joins_and_leaves(monkeypatch, tmp_path):
    """torchrun's environment at WORLD_SIZE=1 joins a gloo group on the
    CPU; the helpers stay single-process ones, and the group is left."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        assert dist.initialize() is True
        assert dist.initialize() is True   # idempotent
        assert dist.backend() == "gloo"
        assert (dist.process_index(), dist.process_count()) == (0, 1)
        assert dist.all_reduce_mean(2.5) == 2.5
        dist.barrier("one", timeout_s=0.01)
        assert dist.reconfig_logging(str(tmp_path)) is None
        t = torch.arange(4.0)
        assert dist.all_reduce_sum_(t).tolist() == [0.0, 1.0, 2.0, 3.0]
        assert dist.all_gather(t).tolist() == [[0.0, 1.0, 2.0, 3.0]]
    finally:
        dist.shutdown()
    assert dist.backend() is None and dist.process_count() == 1


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """Two gloo ranks: the collectives, one epoch of data-parallel
    training, and a run under PENROZ_TRAIN_MESH=0."""
    d = tmp_path_factory.mktemp("dist")
    with pytest.MonkeyPatch.context() as mp:
        from penroz_tpu_torch.utils import checkpoint as tckpt
        mp.chdir(d)
        mp.setattr(tckpt, "SHM_PATH", str(d / "shm"))
        (d / "data").mkdir()
        np.save(d / "data" / "mh_000000",
                np.random.default_rng(0).integers(0, 64, 8000)
                .astype(np.uint16))
        NeuralNetworkModel("init", Mapper(_LAYERS, _OPT), device="cpu",
                           seed=0).serialize(sync_flush=True)
        reports = run_ranks(d, [
            {"op": "collectives"},
            {"op": "train", "init": "init", "model_id": "dp1", "run": RUN},
            {"op": "train_mesh_off", "init": "init", "model_id": "off",
             "run": RUN}], timeout=180)
    return d, reports


def test_two_ranks_topology_and_collectives(pair):
    _, reports = pair
    for rank, report in enumerate(reports):
        assert report["topology"] == [rank, 2, rank == 0, True, "gloo"]
        assert report["mean"] == 1.5
        assert report["sum"] == [3.0, 3.0, 3.0]
        assert report["gather"] == [[0, 1], [10, 11]]


def test_barrier_that_one_rank_misses_times_out(pair):
    """Rank 0 alone at a barrier raises after its timeout (1 s), and both
    ranks meet at the next one."""
    _, reports = pair
    assert reports[0]["lonely"] == "DistStoreError"
    assert 0.9 <= reports[0]["lonely_s"] < 30
    assert "lonely" not in reports[1]


def test_per_rank_log_files(pair):
    """Each rank mirrors its records into logs/penroz_rank{r}.log with
    ``[rank{r}/2]`` and the banner, training records included."""
    d, _ = pair
    for rank in (0, 1):
        text = (d / "logs" / f"penroz_rank{rank}.log").read_text()
        assert f"[rank{rank}/2]" in text
        assert f"Per-rank logging for process {rank}/2" in text
        assert "Training dp1 over 2 ranks" in text
    assert "Epoch 1: cost=" in (d / "logs" / "penroz_rank0.log").read_text()


def test_train_mesh_off_is_refused_over_ranks(pair):
    """The JAX package's RuntimeError, on both ranks, and an Error status
    in the checkpoint."""
    _, reports = pair
    want = ("PENROZ_TRAIN_MESH=0 is invalid when process_count=2 > 1: "
            "multi-host training requires the global mesh for gradient sync")
    for report in reports:
        assert report["mesh_off"] == want
        assert report["mesh_off_status"] == "Error"


def test_data_parallel_replicas_stay_identical(pair):
    """One epoch over two ranks: every gathered parameter and optimizer
    leaf equal bit for bit on both ranks, one gradient all-reduce a step."""
    d, reports = pair
    a, b = (np.load(d / f"rank{r}_dp1.npz") for r in (0, 1))
    assert sorted(a.files) == sorted(b.files)
    for key in a.files:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    for report in reports:
        assert report["train"]["dp1"]["clock"] == {"all_reduce": 1}
        assert report["train"]["dp1"]["stage"] == 0


def test_rank_logging_installs_one_handler(tmp_path, monkeypatch):
    """``reconfig_logging`` over ranks installs one handler, and a second
    call replaces it (the rank count read from the group)."""
    monkeypatch.setattr(dist, "process_count", lambda: 2)
    monkeypatch.setattr(dist, "process_index", lambda: 1)
    root = logging.getLogger()
    before, level = list(root.handlers), root.level
    try:
        path = dist.reconfig_logging(str(tmp_path))
        assert dist.reconfig_logging(str(tmp_path)) == path
        mine = [h for h in root.handlers
                if getattr(h, "_penroz_rank_handler", False)]
        assert len(mine) == 1
        logging.getLogger("x").warning("hello")
        mine[0].flush()
        text = (tmp_path / "penroz_rank1.log").read_text()
        assert "[rank1/2] x: hello" in text
    finally:
        for h in list(root.handlers):
            if h not in before:
                root.removeHandler(h)
                h.close()
        root.setLevel(level)
