"""The data-axis sharding rule of the ZeRO ladder (counterpart of
penroz_tpu/parallel/sharding.py's ``param_spec``, ``_data_axis_spec`` and
the moment rule of ``opt_state_sharding_tree``), as plain functions over
keys and shapes: a spec is a tuple of axis names, one a dim (None: not
cut).

The rule (Xu et al. 2020, arXiv:2004.13336): a leaf is cut over the
ranks on the first dim the tensor-parallel layout leaves free whose size
the world divides, into equal contiguous ranges in rank order; a leaf
with no such dim, and a scalar, stays whole on every rank.  Optimizer
moments (``PENROZ_WUS``) and, under ``PENROZ_FSDP``, the parameters take
the same cut, so a parameter and its moments line up element for element.
The tensor-parallel half (a ``model`` or ``expert`` axis larger than 1)
is not ported: its sizes default to 1, where it leaves every dim free.
"""

from __future__ import annotations

from typing import Optional

MODEL_AXIS = "model"
EXPERT_AXIS = "expert"
DATA_AXIS = "data"


def _divides(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


def param_spec(key: str, shape: tuple, model: int = 1,
               expert: int = 1) -> tuple:
    """The tensor-parallel spec of one flat parameter (JAX ``param_spec``
    for axis sizes ``model`` and ``expert``)."""
    if len(shape) == 3 and ".experts." in key:
        return (EXPERT_AXIS, None, None) if _divides(shape[0], expert) else ()
    if len(shape) != 2:
        return ()
    out_dim, in_dim = shape
    is_embedding = key.endswith(".weight") and out_dim > 8 * in_dim
    if is_embedding and _divides(out_dim, model):
        return (MODEL_AXIS, None)
    if out_dim > in_dim and _divides(out_dim, model):
        return (MODEL_AXIS, None)
    if in_dim > out_dim and _divides(in_dim, model):
        return (None, MODEL_AXIS)
    return ()


def data_axis_dim(spec: tuple, shape: tuple, data: int,
                  sizes: Optional[dict] = None) -> Optional[int]:
    """The dim JAX ``_data_axis_spec`` gives the data axis of size
    ``data``: the first whose axis is None or of size 1 (``sizes``: axis
    sizes, 1 when absent) and whose size ``data`` divides; None when the
    leaf stays whole."""
    if data <= 1 or not shape:
        return None
    sizes = sizes or {}
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, axis in enumerate(entries):
        free = axis is None or sizes.get(axis, 1) == 1
        if free and _divides(shape[dim], data):
            return dim
    return None


def shard_dim(key: str, shape: tuple, world: int) -> Optional[int]:
    """The dim a parameter (and its moments) is cut on over ``world``
    ranks with no tensor-parallel axis, or None."""
    return data_axis_dim(param_spec(key, tuple(shape)), tuple(shape), world)


def rank_ranges(shape: tuple, dim: Optional[int], world: int,
                rank: int) -> tuple:
    """``((start, stop), ...)`` of ``rank``'s piece, ``(None, None)`` on
    every dim not cut (the shard files' form)."""
    out = []
    for d, size in enumerate(shape):
        if d == dim:
            step = size // world
            out.append((rank * step, (rank + 1) * step))
        else:
            out.append((None, None))
    return tuple(out)

