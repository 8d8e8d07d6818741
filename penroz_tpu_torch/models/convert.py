"""Carry a JAX-package model into the port.

The JAX package's ``NeuralNetworkModel.state_dict()`` (and its checkpoints)
hold numpy arrays under the same flat keys as the port's module tree, so
conversion is a key- and shape-checked copy.  bf16 arrays arrive as
``ml_dtypes`` arrays; they are reinterpreted through 16-bit integers
without importing ``ml_dtypes``.
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


def from_jax_state_dict(arrays: dict, layers: list[dict], optimizer: dict,
                        model_id: str = "converted", device=None):
    """The port's ``NeuralNetworkModel`` for a layer DSL with the given
    parameters and buffers (``{key: np.ndarray | tensor}``).  Dtypes are
    kept (a bf16 checkpoint serves in bf16); keys or shapes that do not
    match the DSL raise ValueError."""
    from penroz_tpu_torch.models.dsl import Mapper
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    return NeuralNetworkModel(model_id, Mapper(layers, optimizer),
                              device=device, params=arrays)
