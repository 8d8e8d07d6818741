"""HuggingFace checkpoint weights from a local directory (counterpart of
penroz_tpu/models/hf_loader.py), with a safetensors reader of its own: the
machine with the card has neither ``safetensors`` nor ``ml_dtypes``.

A safetensors file is an 8-byte little-endian header length, a JSON header
naming each tensor's dtype, shape and byte range, and the raw bytes.
Floating tensors come out as float32 numpy arrays (BF16 widened through
16-bit integers, exactly), integer and bool tensors as they are stored, as
the JAX package's loader gives them.  The port imports only from a local
directory: a name that is not one is a ValueError (HTTP 400).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

log = logging.getLogger(__name__)

_HEADER_LIMIT = 100 << 20

# safetensors dtype → numpy dtype of the stored bytes (BF16 as its bits).
_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
           "I64": np.int64, "I32": np.int32, "U8": np.uint8,
           "BOOL": np.bool_}


def resolve_checkpoint_dir(repo_or_path: str,
                           revision: Optional[str] = None) -> str:
    """The checkpoint directory: a local directory is used as it is; any
    other name (a hub id) is refused."""
    if os.path.isdir(repo_or_path):
        return repo_or_path
    raise ValueError(f"{repo_or_path!r} is not a local directory: "
                     f"penroz_tpu_torch imports only from a local checkpoint "
                     f"directory (config.json and *.safetensors), not from "
                     f"the HuggingFace hub")


def read_safetensors(path: str) -> dict:
    """``{name: numpy array}`` of one safetensors file, floating tensors
    widened to float32 (exactly: BF16 bit patterns shifted into the high
    half of a float32)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: not a safetensors file")
        n = int.from_bytes(head, "little")
        if n > _HEADER_LIMIT:
            raise ValueError(f"{path}: header of {n} bytes")
        header = json.loads(f.read(n))
        data = np.fromfile(f, dtype=np.uint8)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which the reader does not "
                             f"support")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        arr = data[begin:end].view(dtype).reshape(shape)
        if info["dtype"] == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] == "F16":
            arr = arr.astype(np.float32)
        out[name] = arr
    return out


def _weight_files(local_dir: str) -> list[str]:
    """Safetensors files to load, relative to ``local_dir``: the sharded
    index, else ``model.safetensors``, else loose ``*.safetensors``, else
    a subfolder's index, else nested files."""
    index = os.path.join(local_dir, "model.safetensors.index.json")
    if os.path.exists(index):
        with open(index) as f:
            return sorted(set(json.load(f)["weight_map"].values()))
    if os.path.exists(os.path.join(local_dir, "model.safetensors")):
        return ["model.safetensors"]
    shards = sorted(f for f in os.listdir(local_dir)
                    if f.endswith(".safetensors"))
    if shards:
        return shards
    for root, _, files in os.walk(local_dir):
        if root != local_dir and "model.safetensors.index.json" in files:
            with open(os.path.join(root,
                                   "model.safetensors.index.json")) as f:
                weight_map = json.load(f)["weight_map"]
            rel = os.path.relpath(root, local_dir)
            return sorted({os.path.join(rel, v)
                           for v in weight_map.values()})
    return sorted(os.path.relpath(os.path.join(root, f), local_dir)
                  for root, _, files in os.walk(local_dir)
                  for f in files if f.endswith(".safetensors"))


def load_state_dict(local_dir: str) -> dict:
    """Checkpoint directory → ``{name: numpy array}`` (floating tensors as
    float32), from safetensors or, when there are none, the torch
    ``pytorch_model*.bin`` files."""
    shards = _weight_files(local_dir)
    if not shards:
        return _normalize(_load_torch_fallback(local_dir))
    sd = {}
    for shard in shards:
        sd.update(read_safetensors(os.path.join(local_dir, shard)))
    return _normalize(sd)


def _normalize(sd: dict) -> dict:
    """The original ``gpt2`` checkpoints were saved from the bare base
    model: their keys lack the ``transformer.`` prefix (and ``lm_head``);
    add it, as transformers' ``base_model_prefix`` retry does."""
    if "wte.weight" in sd and "transformer.wte.weight" not in sd:
        sd = {(k if k.startswith("lm_head.") else f"transformer.{k}"): v
              for k, v in sd.items()}
    return sd


def _load_torch_fallback(local_dir: str) -> dict:
    import torch
    bin_index = os.path.join(local_dir, "pytorch_model.bin.index.json")
    if os.path.exists(bin_index):
        with open(bin_index) as f:
            bins = sorted(set(json.load(f)["weight_map"].values()))
    else:
        bins = sorted(f for f in os.listdir(local_dir)
                      if f.startswith("pytorch_model") and
                      f.endswith(".bin"))
    if not bins:
        raise FileNotFoundError(f"no safetensors or pytorch_model*.bin "
                                f"weight files in {local_dir}")
    log.warning("No safetensors in %s — loading the torch .bin files",
                local_dir)
    sd = {}
    for name in bins:
        blob = torch.load(os.path.join(local_dir, name), map_location="cpu",
                          weights_only=True)
        for key, value in blob.items():
            value = value.detach()
            sd[key] = (value.float() if value.is_floating_point()
                       else value).numpy()
    return sd
