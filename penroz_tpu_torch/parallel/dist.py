"""Ranks, their topology and collectives over ``torch.distributed``
(counterpart of penroz_tpu/parallel/dist.py).

A run over several ranks is one process a rank, launched the way
``torchrun`` launches them: ``MASTER_ADDR``/``MASTER_PORT`` (the JAX
package's ``JAX_COORDINATOR_ADDRESS``), ``WORLD_SIZE``
(``JAX_NUM_PROCESSES``), ``RANK`` (``JAX_PROCESS_ID``), and ``LOCAL_RANK``
and ``LOCAL_WORLD_SIZE`` for the ranks of one host.  A host with N cards
runs N ranks: the JAX package's in-process data parallelism over a
host's devices has no counterpart here.

- :func:`initialize` — joins the process group once (a no-op without that
  environment).  The backend follows one rule: NCCL when every rank of a
  host has a card of its own, gloo otherwise (CPU ranks, or ranks sharing
  one card, which NCCL refuses).  Under gloo a collective of tensors on a
  card is staged through host memory by :func:`all_reduce_sum_` and
  :func:`all_gather`; the compute stays on the card.
- :func:`process_index`, :func:`process_count`, :func:`master_proc`,
  :func:`is_distributed` — the rank arithmetic of the loaders and the
  master's checkpoint writes.
- :func:`barrier` — a named rendezvous on the group's c10d store (no
  device collective), with a timeout.
- :func:`all_reduce_mean` — a host scalar averaged over a gloo group kept
  beside the main one.
- :func:`reconfig_logging` — per-rank log files.
"""

from __future__ import annotations

import datetime
import logging
import os
import time

import numpy as np
import torch
import torch.distributed as tdist

log = logging.getLogger(__name__)

# The gloo group for host scalars: the main group itself under gloo, a
# second group beside NCCL.  Set by initialize() (process-wide, as the
# default process group is); None before it.
_HOST_GROUP = None
_STAGED = False     # the main group is gloo: stage card tensors through host


def _env_int(name: str, default=None):
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def backend_for(local_world: int) -> str:
    """NCCL when the host has a card for each of its ``local_world``
    ranks, else gloo."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= local_world:
        return "nccl"
    return "gloo"


def initialize(timeout_s: float = 1800.0) -> bool:
    """Join the process group from the environment (idempotent).  False
    without ``MASTER_ADDR`` and ``WORLD_SIZE``: one process, nothing to
    do.  Each rank uses card ``LOCAL_RANK`` modulo the host's cards."""
    global _HOST_GROUP, _STAGED
    if _HOST_GROUP is not None:
        return True
    addr = os.environ.get("MASTER_ADDR")
    world = _env_int("WORLD_SIZE")
    if addr is None or world is None:
        return False
    rank = _env_int("RANK", 0)
    local_rank = _env_int("LOCAL_RANK", rank)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    port = _env_int("MASTER_PORT", 29500)
    backend = backend_for(local_world)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    log.info("Initializing torch.distributed: %s:%d world=%d rank=%d "
             "backend=%s", addr, port, world, rank, backend)
    timeout = datetime.timedelta(seconds=timeout_s)
    tdist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                             world_size=world, rank=rank, timeout=timeout)
    _STAGED = backend == "gloo"
    _HOST_GROUP = (tdist.group.WORLD if _STAGED
                   else tdist.new_group(backend="gloo", timeout=timeout))
    reconfig_logging()
    return True


def shutdown():
    """Leave the process group (tests and scripts that run a world and
    then go on)."""
    global _HOST_GROUP, _STAGED
    if tdist.is_initialized():
        tdist.destroy_process_group()
    _HOST_GROUP, _STAGED = None, False


def backend() -> str | None:
    return tdist.get_backend() if tdist.is_initialized() else None


def process_index() -> int:
    return tdist.get_rank() if tdist.is_initialized() else 0


def process_count() -> int:
    return tdist.get_world_size() if tdist.is_initialized() else 1


def master_proc() -> bool:
    return process_index() == 0


def is_distributed() -> bool:
    return process_count() > 1


def reconfig_logging(log_dir: str | None = None) -> str | None:
    """Mirror this rank's records into ``<log_dir>/penroz_rank{r}.log``
    (``PENROZ_LOG_DIR``, default ``logs``), each carrying
    ``[rank{r}/{W}]`` (JAX ``reconfig_logging``).  Idempotent: a second
    call replaces the handler.  One process: a no-op.  Returns the path
    or None."""
    if process_count() <= 1:
        return None
    import logging.handlers
    log_dir = log_dir or os.environ.get("PENROZ_LOG_DIR", "logs")
    os.makedirs(log_dir, exist_ok=True)
    rank = process_index()
    path = os.path.join(log_dir, f"penroz_rank{rank}.log")
    root = logging.getLogger()
    for h in list(root.handlers):
        if getattr(h, "_penroz_rank_handler", False):
            root.removeHandler(h)
            h.close()
    # handlers already there mean logging was configured on purpose: its
    # level stands
    operator_configured = bool(root.handlers)
    handler = logging.handlers.RotatingFileHandler(
        path, maxBytes=10_000_000, backupCount=3)
    handler.setFormatter(logging.Formatter(
        f"%(asctime)s %(levelname)s [rank{rank}/{process_count()}] "
        f"%(name)s: %(message)s"))
    handler._penroz_rank_handler = True
    root.addHandler(handler)
    if root.level == logging.NOTSET or (
            root.level == logging.WARNING and not operator_configured
            and "PENROZ_LOG_CONFIG" not in os.environ):
        root.setLevel(logging.INFO)
    log.info("Per-rank logging for process %d/%d -> %s", rank,
             process_count(), path)
    return path


def barrier(name: str, timeout_s: float = 600.0) -> None:
    """Wait until every rank has called ``barrier(name)``, at most
    ``timeout_s`` (then raise).  Counted on the group's c10d store, like
    the JAX package's coordination-service barrier: no device collective.
    ``name`` must be the same on every rank and new for each rendezvous
    (derive it from state that advances in lockstep on every rank)."""
    if process_count() == 1:
        return
    from torch.distributed import distributed_c10d
    store = distributed_c10d._get_default_store()
    key = f"penroz_barrier/{name}"
    if store.add(key, 1) == process_count():
        store.set(f"{key}/open", "1")
    store.wait([f"{key}/open"], datetime.timedelta(seconds=timeout_s))


def all_reduce_mean(value: float) -> float:
    """A host scalar averaged over the ranks (float32, as the JAX package
    gathers it); one process: the value."""
    if process_count() == 1:
        return float(value)
    mine = torch.tensor([value], dtype=torch.float32)
    gathered = [torch.empty(1, dtype=torch.float32)
                for _ in range(process_count())]
    tdist.all_gather(gathered, mine, group=_HOST_GROUP)
    return float(np.mean(torch.cat(gathered).numpy()))


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place; every rank gets the same bits.
    Under gloo a tensor on a card goes through host memory."""
    if _STAGED and t.is_cuda:
        host = t.cpu()
        tdist.all_reduce(host)
        t.copy_(host)
    else:
        tdist.all_reduce(t)
    return t


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """``(W, *t.shape)``: every rank's ``t`` in rank order, on ``t``'s
    device (staged through host memory under gloo)."""
    src = t.cpu() if _STAGED and t.is_cuda else t
    out = [torch.empty_like(src) for _ in range(process_count())]
    tdist.all_gather(out, src.contiguous())
    return torch.stack(out).to(t.device)


class CollectiveClock:
    """Seconds each kind of collective took, summed and counted (the card
    is synchronized before and after each, so a time is the collective's
    own)."""

    def __init__(self):
        self.seconds: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def run(self, kind: str, fn, *args):
        sync = torch.cuda.is_available() and torch.cuda.is_initialized()
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        if sync:
            torch.cuda.synchronize()
        self.seconds[kind] = (self.seconds.get(kind, 0.0)
                              + time.perf_counter() - t0)
        self.calls[kind] = self.calls.get(kind, 0) + 1
        return out
