"""Carry a JAX-package model into the port, and map optimizer state
between ``torch.optim`` and the JAX package's optax checkpoint leaves.

The JAX package's ``NeuralNetworkModel.state_dict()`` (and its checkpoints)
hold numpy arrays under the same flat keys as the port's module tree, so
conversion is a key- and shape-checked copy (a one-element array where the
module holds a 0-d buffer, as the JAX checkpoint stores BatchNorm1d's int32
counter, is reshaped).  bf16 arrays arrive as
``ml_dtypes`` arrays; they are reinterpreted through 16-bit integers
without importing ``ml_dtypes``.  Optimizer state travels as the flat
``opt_state_leaves`` list of the optax state (:func:`opt_state_leaves`),
so either package continues the other's Adam moments or momentum.
"""

from __future__ import annotations

import numpy as np
import torch


def as_tensor(a) -> torch.Tensor:
    """CPU tensor of a numpy array (bf16 included), or the tensor itself."""
    if isinstance(a, torch.Tensor):
        return a
    arr = np.ascontiguousarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(arr.copy())


def fit_scalar(t: torch.Tensor, shape) -> torch.Tensor:
    """A one-element tensor as the 0-d tensor ``shape`` asks for: the JAX
    package's checkpoint stores a 0-d array (BatchNorm1d's int32
    ``num_batches_tracked``) with shape (1,)."""
    if len(shape) == 0 and tuple(t.shape) == (1,):
        return t.reshape(())
    return t


def _optimizer_kind(config: dict) -> str:
    """'adam' (adamw and adam: count, mu, nu), 'trace' (sgd with momentum)
    or 'none' (plain sgd: optax keeps no state)."""
    (name, args), = config.items()
    if name in ("adamw", "adam"):
        return "adam"
    return "trace" if float(args.get("momentum", 0.0)) else "none"


def opt_state_leaves(config: dict, optimizer, params: dict) -> dict:
    """The optimizer state as the JAX package's checkpoint holds it:
    ``{i: array}`` indexed like ``jax.tree.leaves`` of the optax state
    over the flat parameter dict, whose keys sort.

    - adamw / adam (with or without weight decay): leaf 0 is ``count``
      (int32 scalar), then ``mu`` for each sorted key, then ``nu``;
    - sgd with momentum (or nesterov): one ``trace`` leaf per sorted key;
    - plain sgd: no leaves.

    ``optimizer`` None (never stepped or built) gives the state optax's
    ``init`` would: count 0 and zeros in each parameter's dtype.  Leaves
    are CPU tensors."""
    keys = sorted(params)
    state = optimizer.state if optimizer is not None else {}

    def moment(key, name):
        value = state.get(params[key], {}).get(name)
        if value is None:
            return torch.zeros(params[key].shape, dtype=params[key].dtype)
        return value.detach().to("cpu")

    kind = _optimizer_kind(config)
    if kind == "none":
        leaves = []
    elif kind == "trace":
        leaves = [moment(k, "momentum_buffer") for k in keys]
    else:
        steps = [state[p]["step"] for p in params.values() if p in state]
        count = int(steps[0]) if steps else 0
        leaves = ([torch.tensor(count, dtype=torch.int32)]
                  + [moment(k, "exp_avg") for k in keys]
                  + [moment(k, "exp_avg_sq") for k in keys])
    return dict(enumerate(leaves))


def opt_leaf_keys(config: dict, keys) -> list:
    """The parameter each leaf of :func:`opt_state_leaves` is a moment of
    (its key), None for the step count — the JAX package's rule of which
    optimizer leaves follow a parameter's sharding."""
    keys = sorted(keys)
    kind = _optimizer_kind(config)
    if kind == "none":
        return []
    if kind == "trace":
        return list(keys)
    return [None] + list(keys) + list(keys)


def load_opt_state_leaves(config: dict, optimizer, params: dict, leaves):
    """Install checkpoint leaves (layout of :func:`opt_state_leaves`, a
    dict by index or a list) into a ``torch.optim`` optimizer built over
    ``params``.  An empty set is a fresh state; a count that does not fit
    the layout raises ValueError."""
    if isinstance(leaves, dict):
        leaves = [leaves[i] for i in range(len(leaves))]
    if not leaves:
        return
    keys = sorted(params)
    kind = _optimizer_kind(config)
    expected = {"none": 0, "trace": len(keys), "adam": 1 + 2 * len(keys)}[kind]
    if len(leaves) != expected:
        raise ValueError(f"optimizer state has {len(leaves)} leaves; "
                         f"{config} over {len(keys)} parameters needs "
                         f"{expected}")

    def on(i, key):
        p = params[key]
        t = as_tensor(leaves[i])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"optimizer leaf {i} ({key}): shape "
                             f"{tuple(t.shape)} != {tuple(p.shape)}")
        return t.to(device=p.device, dtype=p.dtype)

    for j, key in enumerate(keys):
        p = params[key]
        if kind == "trace":
            optimizer.state[p] = {"momentum_buffer": on(j, key)}
        elif kind == "adam":
            optimizer.state[p] = {
                "step": torch.tensor(float(as_tensor(leaves[0])),
                                     dtype=torch.float32),
                "exp_avg": on(1 + j, key),
                "exp_avg_sq": on(1 + len(keys) + j, key)}


def from_jax_state_dict(arrays: dict, layers: list[dict], optimizer: dict,
                        model_id: str = "converted", device=None):
    """The port's ``NeuralNetworkModel`` for a layer DSL with the given
    parameters and buffers (``{key: np.ndarray | tensor}``; the MoE
    stacks are parameters like any other).  Dtypes are kept (a bf16
    checkpoint serves in bf16); parameter keys or shapes that do not match
    the DSL raise ValueError, and a buffer the arrays lack keeps its
    module default (``NeuralNetworkModel.load_state``)."""
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    return NeuralNetworkModel(model_id, Mapper(layers, optimizer),
                              device=device, params=arrays)
