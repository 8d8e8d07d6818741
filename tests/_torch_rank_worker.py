"""Rank processes for the port's multi-rank tests (tests/test_torch_dist.py,
tests/test_torch_zero.py): :func:`run_ranks` starts one process a rank
over gloo on a free 127.0.0.1 port, each running this file with the same
list of jobs, and returns each rank's JSON report.

The workers import torch and the port alone (no JAX): the tests hold
their reports and files against the JAX package in the test process.
Jobs, run in order on every rank:

- ``{"op": "collectives"}``: :mod:`dist`'s topology, ``all_reduce_mean``,
  ``all_reduce_sum_``, ``all_gather``, a barrier, and a barrier that rank
  0 alone enters (it must time out).
- ``{"op": "train", "init", "model_id", "env", "run"}``: load checkpoint
  ``init``, rename it ``model_id``, train it under ``env`` with ``run``'s
  arguments, then report the master's progress, each cut leaf's held and
  full sizes, the held bytes, and write the gathered state to
  ``rank{r}_{model_id}.npz``.
- ``{"op": "evaluate", "model_id", "args"}``: ``evaluate_model(*args)``.
- ``{"op": "train_mesh_off", "init", "run"}``: training under
  ``PENROZ_TRAIN_MESH=0``; its error message.
"""

import json
import math
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(workdir, jobs: list, world: int = 2, timeout: float = 120.0):
    """Run ``jobs`` on ``world`` rank processes in ``workdir``; each
    rank's report (a dict), in rank order.  A rank that fails or outlives
    ``timeout`` fails the caller, with every rank's output."""
    port = _free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_", "PENROZ_", "TURBO_",
                                 "PAGED_", "MASTER_", "WORLD_SIZE", "RANK",
                                 "LOCAL_"))}
    base.update({"PYTHONPATH": REPO, "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": str(port), "WORLD_SIZE": str(world),
                 "LOCAL_WORLD_SIZE": str(world), "GLOO_SOCKET_IFNAME": "lo",
                 "PENROZ_SHM_PATH": os.path.join(str(workdir), "shm"),
                 "OMP_NUM_THREADS": "2"})
    procs = []
    for rank in range(world):
        env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), json.dumps(jobs)],
            env=env, cwd=str(workdir), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"
    reports = []
    for rank in range(world):
        with open(os.path.join(str(workdir), f"report{rank}.json")) as f:
            reports.append(json.load(f))
    return reports


def _collectives(report):
    import time

    import torch

    from penroz_tpu_torch.parallel import dist
    rank = dist.process_index()
    report["topology"] = [dist.process_index(), dist.process_count(),
                          dist.master_proc(), dist.is_distributed(),
                          dist.backend()]
    report["mean"] = dist.all_reduce_mean(float(rank + 1))
    t = torch.full((3,), float(rank + 1))
    report["sum"] = dist.all_reduce_sum_(t).tolist()
    report["gather"] = dist.all_gather(torch.arange(2) + 10 * rank).tolist()
    dist.barrier("both")
    if rank == 0:
        t0 = time.monotonic()
        try:
            dist.barrier("rank0_alone", timeout_s=1.0)
            report["lonely"] = "returned"
        except Exception as e:  # noqa: BLE001 — the report carries it
            report["lonely"] = type(e).__name__
        report["lonely_s"] = time.monotonic() - t0
    dist.barrier("after")


def _train(report, job):
    import numpy as np

    from penroz_tpu_torch.models.model import NeuralNetworkModel
    from penroz_tpu_torch.parallel import dist
    from penroz_tpu_torch.utils import checkpoint
    os.environ.update(job.get("env", {}))
    try:
        model = NeuralNetworkModel.deserialize(job["init"], device="cpu")
        model.model_id = job["model_id"]
        model.train_model(**job["run"])
    finally:
        for name in job.get("env", {}):
            os.environ.pop(name)
    replicas = model._replicas
    replicas.release()   # stage 3: the layout between steps
    entry = {"status": model.status["code"],
             "progress": [p["cost"] for p in model.progress],
             "stage": replicas.stage, "held": replicas.held_bytes(),
             "pieces": {k: [replicas.shards[k].numel(),
                            math.prod(replicas.shapes[k])]
                        for k in replicas.keys
                        if replicas.dims[k] is not None and replicas.stage},
             "clock": replicas.clock.calls}
    params, leaves = replicas.gather_state()
    arrays = {f"p:{k}": v for k, v in params.items()}
    arrays.update({f"o:{i}": v for i, v in leaves.items()})
    np.savez(f"rank{dist.process_index()}_{job['model_id']}.npz",
             **{k: _np(v) for k, v in arrays.items()})
    checkpoint.join_flushes()
    dist.barrier(f"saved_{job['model_id']}")
    report.setdefault("train", {})[job["model_id"]] = entry


def _np(t):
    """A CPU tensor as numpy, bf16 as its 16-bit pattern."""
    import torch
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def main():
    jobs = json.loads(sys.argv[1])
    import torch
    torch.set_num_threads(2)
    from penroz_tpu_torch.parallel import dist
    assert dist.initialize(), "MASTER_ADDR / WORLD_SIZE not picked up"
    report = {}
    for job in jobs:
        op = job["op"]
        if op == "collectives":
            _collectives(report)
        elif op == "train":
            _train(report, job)
        elif op == "evaluate":
            from penroz_tpu_torch.models.model import NeuralNetworkModel
            model = NeuralNetworkModel.deserialize(job["model_id"],
                                                   device="cpu")
            report.setdefault("evaluate", {})[job["model_id"]] = \
                model.evaluate_model(*job["args"])
        elif op == "train_mesh_off":
            from penroz_tpu_torch.models.model import NeuralNetworkModel
            os.environ["PENROZ_TRAIN_MESH"] = "0"
            model = NeuralNetworkModel.deserialize(job["init"], device="cpu")
            model.model_id = job["model_id"]
            try:
                model.train_model(**job["run"])
                report["mesh_off"] = None
            except RuntimeError as e:
                report["mesh_off"] = str(e)
            os.environ.pop("PENROZ_TRAIN_MESH")
            report["mesh_off_status"] = model.status["code"]
        else:
            raise ValueError(f"unknown job {op!r}")
    with open(f"report{dist.process_index()}.json", "w") as f:
        json.dump(report, f)
    dist.shutdown()


if __name__ == "__main__":
    main()
