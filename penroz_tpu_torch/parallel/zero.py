"""Training over the ranks: the data-parallel gradient average and the
ZeRO ladder (counterpart of the data axis of the JAX package's training
mesh, penroz_tpu/models/model.py ``train_model`` with ``PENROZ_WUS`` and
``PENROZ_FSDP``).

Every rank runs the same model on its own rows (the loaders are
rank-strided), accumulates its micro-steps' gradients in fp32 and, once
an optimizer step, :meth:`DataParallel.average` sums them over the ranks
in one all-reduce: every rank then holds the same bits, so the replicas
stay identical.  The floating buffers a forward writes (BatchNorm's
statistics, the MoE ``router_fraction``) are averaged in the same
collective, as the JAX package computes them over the global batch.

- stage 0 (plain data parallelism): each rank steps the model's own
  optimizer on the averaged gradients.
- stage 1 (``PENROZ_WUS=1``, ZeRO-1): each rank holds only its range of
  every optimizer moment that parallel/sharding.py cuts, steps its
  pieces of the parameters (the averaged gradients sliced), and the fresh
  pieces are all-gathered into every rank's full parameters.
- stage 3 (``PENROZ_FSDP=1``, ZeRO-3): the parameters too are held as the
  rank's pieces between steps; :meth:`DataParallel.materialize` gathers
  them before a step's forward and backward and the step releases them.

The checkpoint of a sharded state is the JAX package's: every rank writes
its pieces (:meth:`shard_pieces`) to its shard file, the master the blob
with the rest (:meth:`blob_params`, :meth:`blob_opt_leaves`).
"""

from __future__ import annotations

import torch

from penroz_tpu_torch.models import convert, dsl
from penroz_tpu_torch.parallel import dist, sharding
from penroz_tpu_torch.utils import checkpoint

WUS_ENV = "PENROZ_WUS"
FSDP_ENV = "PENROZ_FSDP"


class DataParallel:
    """One model's training state over the ranks of the process group.

    ``params``: the model's named parameters (``{key: nn.Parameter}``);
    ``optimizer``: the model's full optimizer (stage 0), or ``leaves``:
    its full optimizer leaves in the checkpoint layout
    (models/convert.py), which stages 1 and 3 cut into this rank's
    pieces.  Collectives are timed in :attr:`clock`."""

    def __init__(self, params: dict, optimizer_config: dict, *,
                 stage: int = 0, optimizer=None, leaves=None):
        if stage not in (0, 1, 3):
            raise ValueError(f"ZeRO stage {stage}; expected 0, 1 or 3")
        self.world = dist.process_count()
        self.rank = dist.process_index()
        self.stage = stage
        self.config = optimizer_config
        self.params = params
        self.keys = sorted(params)
        self.shapes = {k: tuple(p.shape) for k, p in params.items()}
        self.dims = {k: (sharding.shard_dim(k, self.shapes[k], self.world)
                         if stage else None) for k in self.keys}
        self.sharded = any(d is not None for d in self.dims.values())
        self.clock = dist.CollectiveClock()
        self.released = False
        self.optimizer = optimizer
        # stage >= 1: the optimizer's own tensors, the rank's piece of a
        # cut leaf (a copy), the parameter itself for a whole one
        self.shards: dict = {}
        if not stage:
            return
        with torch.no_grad():
            for k in self.keys:
                p = params[k]
                self.shards[k] = (p if self.dims[k] is None
                                  else self.piece(k, p.detach()).clone())
        self.optimizer = dsl.build_optimizer(
            optimizer_config, [self.shards[k] for k in self.keys])
        if leaves:
            leaf_keys = convert.opt_leaf_keys(optimizer_config, self.keys)
            if isinstance(leaves, dict):
                leaves = [leaves[i] for i in range(len(leaves))]
            mine = [leaf if key is None or self.dims[key] is None
                    else self.piece(key, convert.as_tensor(leaf))
                    for key, leaf in zip(leaf_keys, leaves)]
            convert.load_opt_state_leaves(optimizer_config, self.optimizer,
                                          self.shards, mine)
        if stage == 3:
            self.release()

    # -- layout ------------------------------------------------------------

    def ranges(self, key: str) -> tuple:
        """This rank's ``((start, stop), ...)`` of ``key``."""
        return sharding.rank_ranges(self.shapes[key], self.dims[key],
                                    self.world, self.rank)

    def piece(self, key: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's piece of a tensor of ``key``'s shape (a view)."""
        dim = self.dims[key]
        step = self.shapes[key][dim] // self.world
        return full.narrow(dim, self.rank * step, step)

    def _cut(self) -> list:
        return [k for k in self.keys if self.dims[k] is not None]

    def _gather(self, pieces: dict, dims: dict | None = None) -> dict:
        """The full tensors of ``pieces`` (``{name: this rank's piece}``,
        cut on ``dims[name]``, by default the parameter ``name``'s dim),
        one all-gather a dtype."""
        dims = self.dims if dims is None else dims
        out = {}
        by_dtype: dict = {}
        for k, t in pieces.items():
            by_dtype.setdefault(t.dtype, []).append(k)
        for keys in by_dtype.values():
            flat = torch.cat([pieces[k].reshape(-1) for k in keys])
            every = self.clock.run("all_gather", dist.all_gather, flat)
            off = 0
            for k in keys:
                n, shape = pieces[k].numel(), pieces[k].shape
                out[k] = torch.cat([every[r, off:off + n].view(shape)
                                    for r in range(self.world)],
                                   dim=dims[k])
                off += n
        return out

    def materialize(self):
        """Stage 3: gather the parameters' pieces into every rank's full
        parameters (a collective; a no-op when they are held)."""
        if not self.released:
            return
        with torch.no_grad():
            full = self._gather({k: self.shards[k] for k in self._cut()})
            for k, t in full.items():
                self.params[k].data = t
        self.released = False

    def release(self):
        """Stage 3: drop the full parameters of every cut leaf; the
        rank's pieces (the optimizer's) stay."""
        if self.stage != 3:
            return
        for k in self._cut():
            p = self.params[k]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)
        self.released = True

    # -- the step -----------------------------------------------------------

    def average(self, grads: dict, cost_sum: torch.Tensor, num_steps: int,
                buffers: dict) -> torch.Tensor:
        """Average over the ranks in one all-reduce, in place: ``grads``
        (``{key: fp32 sum of the micro-steps' gradients}``) become the
        ranks' mean of the micro-step mean, the floating ``buffers`` the
        ranks' mean.  Returns the mean cost (fp32 scalar)."""
        floats = [b for b in buffers.values() if b.is_floating_point()]
        flat = torch.cat([grads[k].reshape(-1) for k in self.keys]
                         + [cost_sum.reshape(1).float()]
                         + [b.reshape(-1).float() for b in floats])
        self.clock.run("all_reduce", dist.all_reduce_sum_, flat)
        n_grads = sum(grads[k].numel() for k in self.keys)
        flat[:n_grads + 1].mul_(1.0 / (num_steps * self.world))
        flat[n_grads + 1:].mul_(1.0 / self.world)
        off = 0
        for k in self.keys:
            g = grads[k]
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        cost = flat[off].clone()
        off += 1
        for b in floats:
            b.copy_(flat[off:off + b.numel()].view_as(b))
            off += b.numel()
        return cost

    def step(self, grads: dict, old) -> dict | None:
        """Stages 1 and 3: step this rank's pieces on the averaged
        ``grads``, then all-gather the fresh pieces into the full
        parameters (stage 1) or release them (stage 3).  ``old``: the
        full parameters before the step, for the update ratios (None: no
        ratios).  Returns ``{key: std(Δw) / std(w)}`` or None."""
        for k in self.keys:
            s = self.shards[k]
            g = grads[k] if self.dims[k] is None else self.piece(k, grads[k])
            s.grad = g.to(s.dtype).contiguous()
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        cut = {k: self.shards[k] for k in self._cut()}
        if self.stage == 1:
            for k, t in self._gather(cut).items():
                self.params[k].data.copy_(t)
            ratios = None if old is None else {
                k: update_ratio(self.params[k] - old[k], old[k])
                for k in self.keys}
        else:
            ratios = None if old is None else self._piece_ratios(old)
            self.release()
        return ratios

    def _piece_ratios(self, old: dict) -> dict:
        """Stage 3's update ratios: ``std(w)`` from the full ``old``
        parameters, ``std(Δw)`` of a cut leaf from its pieces' sums over
        the ranks (population std, in fp64; one all-reduce)."""
        cut = self._cut()
        sums = torch.zeros(2 * len(cut), dtype=torch.float64,
                           device=old[self.keys[0]].device)
        for i, k in enumerate(cut):
            dw = self.shards[k].double() - self.piece(k, old[k]).double()
            sums[2 * i] = dw.sum()
            sums[2 * i + 1] = (dw * dw).sum()
        if cut:
            self.clock.run("all_reduce", dist.all_reduce_sum_, sums)
        out = {}
        for k in self.keys:
            if self.dims[k] is None:
                out[k] = update_ratio(self.params[k] - old[k], old[k])
                continue
            i = cut.index(k)
            n = old[k].numel()
            mean = sums[2 * i] / n
            dw_std = torch.sqrt(torch.clamp(sums[2 * i + 1] / n - mean * mean,
                                            min=0.0)).float()
            out[k] = _ratio(dw_std, old[k].float().std(unbiased=False))
        return out

    # -- state --------------------------------------------------------------

    def opt_leaves(self) -> dict:
        """This rank's optimizer leaves in the checkpoint layout (a cut
        moment as its piece), CPU tensors."""
        if self.stage:
            return convert.opt_state_leaves(self.config, self.optimizer,
                                            self.shards)
        return convert.opt_state_leaves(self.config, self.optimizer,
                                        self.params)

    def _cut_leaves(self) -> dict:
        """``{leaf index: key}`` of the optimizer leaves cut over ranks."""
        if not self.stage:
            return {}
        return {i: key for i, key in enumerate(
            convert.opt_leaf_keys(self.config, self.keys))
            if key is not None and self.dims[key] is not None}

    def shard_pieces(self) -> tuple[dict, dict]:
        """``(pieces, sharded)``: this rank's shard-file pieces and the
        blob's ``sharded`` metadata (``{name: {"shape", "dtype"}}``), the
        JAX package's names (a parameter's key; ``__opt__{i}``)."""
        pieces, meta = {}, {}
        if self.stage == 3:
            for k in self._cut():
                pieces[k] = [(self.ranges(k), self.shards[k].detach().cpu())]
                meta[k] = {"shape": list(self.shapes[k]),
                           "dtype": checkpoint.dtype_name(self.shards[k])}
        leaves = self.opt_leaves()
        for i, key in self._cut_leaves().items():
            pieces[f"__opt__{i}"] = [(self.ranges(key), leaves[i])]
            meta[f"__opt__{i}"] = {"shape": list(self.shapes[key]),
                                   "dtype": checkpoint.dtype_name(leaves[i])}
        return pieces, meta

    def blob_params(self) -> dict:
        """The parameters the master's blob holds: all but stage 3's cut
        ones (CPU)."""
        return {k: p.detach().cpu() for k, p in self.params.items()
                if self.stage != 3 or self.dims[k] is None}

    def blob_opt_leaves(self) -> dict:
        """The optimizer leaves the master's blob holds: all but the cut
        ones (``{index: tensor}``, with gaps, as the JAX package writes)."""
        cut = self._cut_leaves()
        return {i: t for i, t in self.opt_leaves().items() if i not in cut}

    def gather_state(self) -> tuple[dict, dict]:
        """``(params, leaves)``: the full parameters and optimizer leaves
        (CPU), gathered over the ranks — a collective every rank calls."""
        with torch.no_grad():
            params = {k: p.detach() for k, p in self.params.items()}
            if self.released:
                params.update(self._gather(
                    {k: self.shards[k] for k in self._cut()}))
            leaves = self.opt_leaves()
            cut = self._cut_leaves()
            device = self.params[self.keys[0]].device
            leaves.update(self._gather(
                {i: leaves[i].to(device) for i in cut},
                {i: self.dims[key] for i, key in cut.items()}))
        return ({k: v.cpu() for k, v in params.items()},
                {i: v.cpu() for i, v in leaves.items()})

    def held_bytes(self) -> dict:
        """Bytes of parameters and optimizer moments this rank holds now
        (stage 3 between steps: the pieces of the cut leaves)."""
        if self.stage:
            params = sum(_nbytes(self.shards[k]) if self.released
                         or self.dims[k] is None
                         else _nbytes(self.params[k]) for k in self.keys)
        else:
            params = sum(_nbytes(p) for p in self.params.values())
        moments = sum(_nbytes(v) for state in self.optimizer.state.values()
                      for name, v in state.items()
                      if name != "step" and isinstance(v, torch.Tensor))
        return {"params": params, "moments": moments}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _ratio(dw_std, w_std):
    ratio = dw_std / (w_std + 1e-12)
    return torch.where(w_std > 0, ratio, torch.zeros_like(ratio))


def update_ratio(dw, w):
    """``std(Δw) / std(w)`` (population std in fp32; 0 where std(w) is
    0), the JAX package's per-weight update ratio."""
    return _ratio(dw.float().std(unbiased=False),
                  w.float().std(unbiased=False))
