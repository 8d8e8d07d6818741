"""Multi-tenant LoRA adapters (counterpart of penroz_tpu/models/lora.py): a
pair of low-rank factors per targeted ``Linear`` (``ΔW = (alpha/r)·B·A``,
A: (r, in), B: (out, r)) served and trained against one shared base model.

Two bindings apply the delta, both in ``ops/modules.Linear``:

- **bound** (one adapter for the whole forward): :func:`bind` turns an
  adapter tree into ``{prefix: (A, B, scale)}`` tensors on the device,
  carried on ``Ctx.adapter`` (``CompiledArch.forward(adapter=...)``).  The
  shared ``CompiledArch`` is never touched, so other requests keep
  running on the same modules.  Adapter training binds its leaves so;
  single-sequence ``/generate/`` serves a :func:`bind_model` copy of the
  model, whose decode runner copies the factors into buffers of its own
  (models/decode_graphs.py).
- **stacked** (mixed adapters in one batch): :func:`build_pack` stacks the
  live slots' factors into ``{prefix: {a: (L+1, R, in), b: (L+1, out, R),
  scale: (L+1,)}}`` on the device, rank-padded to
  ``PENROZ_LORA_MAX_RANK``, the trailing slot all-zero for base rows, and
  ``Ctx.lora_idx`` (per row ``(B,)`` or per packed token ``(B, T)``) picks
  each row's or token's slot: the continuous-batching engine's form.

Prefixes are the JAX package's flat parameter keys (the port's state-dict
keys), and :func:`target_linears` walks the modules in the JAX package's
order, so an adapter trained or created by either package serves in the
other (checkpoints: utils/checkpoint.py ``adapter_<id>.ckpt``), and
:func:`init_params` draws the same factors from the same seed.

Training (:func:`train_adapter`) freezes the base: gradients reach only the
adapter's leaves, the optimizer (the model's optimizer DSL) holds only
their state, and the checkpoint written every ~10 s and at the end is
adapter-only, loadable at once by the serving registry (serve/adapters.py).

Knobs::

    PENROZ_LORA_MAX_LIVE   adapters stacked per engine batch (default 4)
    PENROZ_LORA_MAX_RANK   rank ceiling and stack padding (default 16)
"""

from __future__ import annotations

import copy
import logging
import os
import time
from typing import Optional

import numpy as np
import torch

from penroz_tpu_torch.ops import modules as M
from penroz_tpu_torch.utils import checkpoint

log = logging.getLogger(__name__)

MAX_LIVE_ENV = "PENROZ_LORA_MAX_LIVE"
MAX_RANK_ENV = "PENROZ_LORA_MAX_RANK"


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, str(default))))
    except ValueError:
        log.warning("Unparseable %s=%r; using default %d", name,
                    os.environ.get(name), default)
        return default


def max_live() -> int:
    """Adapters stackable into one engine batch (``PENROZ_LORA_MAX_LIVE``)."""
    return _env_int(MAX_LIVE_ENV, 4)


def max_rank() -> int:
    """Rank ceiling and stack padding width (``PENROZ_LORA_MAX_RANK``)."""
    return _env_int(MAX_RANK_ENV, 16)


def validate_config(config: dict) -> dict:
    """Normalize an adapter config ``{rank, alpha, targets}``; ValueError
    (HTTP 400) on a rank outside [1, PENROZ_LORA_MAX_RANK]."""
    rank = int(config.get("rank", 8))
    if rank < 1 or rank > max_rank():
        raise ValueError(
            f"adapter rank {rank} outside [1, {max_rank()}] "
            f"(raise {MAX_RANK_ENV} to allow larger ranks)")
    alpha = config.get("alpha")
    alpha = float(alpha) if alpha is not None else 2.0 * rank
    targets = config.get("targets") or None
    if targets is not None:
        targets = [str(t) for t in targets]
    return {"rank": rank, "alpha": alpha, "targets": targets}


def scale(config: dict) -> float:
    return float(config["alpha"]) / float(config["rank"])


def target_linears(arch, targets: Optional[list] = None) -> list[tuple]:
    """(prefix, in_features, out_features) of every targeted ``Linear``, in
    module walk order (the JAX package's ``type(sub) is M.Linear`` walk:
    the attention and MLP projections, ``GatedMLP``'s three, the head).
    ``targets``: substring matchers on the prefix; None or empty targets
    every Linear.  ValueError when nothing matches."""
    out = []
    for prefix, mod in arch.named_modules():
        if type(mod) is not M.Linear:
            continue
        if targets and not any(t in prefix for t in targets):
            continue
        out.append((prefix, mod.in_features, mod.out_features))
    if not out:
        raise ValueError(
            f"adapter targets {targets!r} match no Linear projection in "
            f"this model")
    return out


def init_params(arch, config: dict, seed: int = 0,
                init: str = "zeros") -> dict:
    """A fresh adapter tree of fp32 numpy arrays: A ~ N(0, 1/in) per
    target, B zeros (the base model exactly, until trained), or B ~ N(0,
    1/r) too with ``init='random'``.  The draws are the JAX package's,
    in its order, from ``np.random.default_rng(seed)``: the same bits."""
    rng = np.random.default_rng(seed)
    r = config["rank"]
    params = {}
    for prefix, din, dout in target_linears(arch, config["targets"]):
        params[f"{prefix}.lora_A"] = (
            rng.standard_normal((r, din)) / np.sqrt(din)).astype(np.float32)
        if init == "random":
            params[f"{prefix}.lora_B"] = (
                rng.standard_normal((dout, r)) / np.sqrt(r)
            ).astype(np.float32)
        else:
            params[f"{prefix}.lora_B"] = np.zeros((dout, r), np.float32)
    return params


def _prefixes(params: dict) -> list[str]:
    return [k[:-len(".lora_A")] for k in params if k.endswith(".lora_A")]


def as_tensor(v) -> torch.Tensor:
    """An fp32 tensor of a factor (a numpy array or a tensor)."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.float32)
    return torch.from_numpy(np.asarray(v, np.float32))


def _tensor(v, device) -> torch.Tensor:
    return as_tensor(v).to(device)


def bind(adapter_params: dict, config: dict, device) -> dict:
    """``{prefix: (A, B, scale)}``, fp32 tensors on ``device``: one adapter
    applied to a whole forward (``CompiledArch.forward(adapter=...)``).
    fp32 tensors already on ``device`` are bound as they are (training's
    leaves take their gradients so)."""
    s = torch.tensor(scale(config), dtype=torch.float32, device=device)
    return {p: (_tensor(adapter_params[f"{p}.lora_A"], device),
                _tensor(adapter_params[f"{p}.lora_B"], device), s)
            for p in _prefixes(adapter_params)}


def bind_model(model, adapter_params: dict, config: dict):
    """A shallow copy of ``model`` (NeuralNetworkModel) whose generation
    applies the adapter (JAX ``bind_model``): the copy carries the tree and
    config, its decode runner the factors; the shared ``arch`` is
    untouched."""
    bound = copy.copy(model)
    bound.adapter = (adapter_params, config)
    return bound


def build_pack(slot_params: list, slot_configs: list, n_slots: int,
               device="cpu") -> Optional[dict]:
    """Stack the slots' adapter trees into the mixed-batch pack (JAX
    ``build_pack``): ``{prefix: {a: (n_slots+1, R, in), b: (n_slots+1, out,
    R) (a view of (n_slots+1, R, out) storage), scale: (n_slots+1,)}}``
    fp32 on ``device``, over the union of the
    slots' prefixes, rank-padded to ``PENROZ_LORA_MAX_RANK``.  A slot
    that does not target a prefix, an empty slot (None) and the trailing
    base slot are zero there.  None when no slot is live."""
    R = max_rank()
    shapes: dict = {}
    for params in slot_params:
        if params is None:
            continue
        for prefix in _prefixes(params):
            shapes[prefix] = (int(params[f"{prefix}.lora_A"].shape[1]),
                              int(params[f"{prefix}.lora_B"].shape[0]))
    if not shapes:
        return None
    pack = {}
    for prefix, (din, dout) in shapes.items():
        a = np.zeros((n_slots + 1, R, din), np.float32)
        # B in (slot, rank, out) storage, handed out as its (slot, out,
        # rank) view: the mixed step reads it as one (slots x R, out)
        # matrix without a copy (ops/modules.py ``Linear``)
        b = np.zeros((n_slots + 1, R, dout), np.float32).transpose(0, 2, 1)
        s = np.zeros((n_slots + 1,), np.float32)
        for i, (params, cfg) in enumerate(zip(slot_params, slot_configs)):
            if params is None:
                continue
            ak = params.get(f"{prefix}.lora_A")
            if ak is None:
                continue
            r = ak.shape[0]
            a[i, :r] = np.asarray(ak, np.float32)
            b[i, :, :r] = np.asarray(params[f"{prefix}.lora_B"], np.float32)
            s[i] = scale(cfg)
        pack[prefix] = {
            "a": torch.from_numpy(a).to(device),
            "b": torch.from_numpy(b.transpose(0, 2, 1)).to(device)
                 .permute(0, 2, 1),
            "scale": torch.from_numpy(s).to(device)}
    return pack


def merge_weights(base_params: dict, adapter_params: dict,
                  config: dict) -> dict:
    """Base params with every targeted weight replaced by ``W +
    (alpha/r)·B·A`` in fp32 (numpy, as the JAX package's oracle): the
    offline merge the tests and the chip script hold a served adapter
    to."""
    out = dict(base_params)
    s = scale(config)
    for prefix in _prefixes(adapter_params):
        a = np.asarray(adapter_params[f"{prefix}.lora_A"], np.float32)
        b = np.asarray(adapter_params[f"{prefix}.lora_B"], np.float32)
        key = f"{prefix}.weight"
        w = out[key]
        w = (w.detach().to("cpu", torch.float32).numpy()
             if isinstance(w, torch.Tensor) else np.asarray(w, np.float32))
        out[key] = torch.from_numpy(w + s * (b @ a))
    return out


# ---------------------------------------------------------------------------
# Adapter checkpoints
# ---------------------------------------------------------------------------

def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).numpy()
    return np.asarray(v)


def save_adapter(adapter_id: str, model_id: str, config: dict,
                 params: dict, status: dict, progress: list | None = None,
                 sync_flush: bool = False):
    """Write the adapter checkpoint, in the JAX package's tree."""
    checkpoint.save_adapter(adapter_id, {
        "adapter_id": adapter_id,
        "model_id": model_id,
        "config": config,
        "params": {k: _host(v) for k, v in params.items()},
        "status": status,
        "progress": progress or [],
    }, sync_flush=sync_flush)


def create_adapter(adapter_id: str, model, config: dict, seed: int = 0,
                   init: str = "zeros") -> dict:
    """Initialize and persist a fresh adapter for ``model`` (POST
    /adapters/).  Returns its tree."""
    config = validate_config(config)
    params = init_params(model.arch, config, seed=seed, init=init)
    save_adapter(adapter_id, model.model_id, config, params,
                 {"code": "Created", "message": "Adapter created"},
                 sync_flush=True)
    return {"adapter_id": adapter_id, "model_id": model.model_id,
            "config": config, "params": params}


# ---------------------------------------------------------------------------
# Training: the base frozen, only the adapter tree descends
# ---------------------------------------------------------------------------

def _starting_params(model, adapter_id: str, config: dict) -> dict:
    """An existing checkpoint's factors (continued fine-tuning; its model
    and shape must match, else ValueError), or fresh ones."""
    try:
        existing = checkpoint.load_adapter(adapter_id)
    except KeyError:
        return init_params(model.arch, config)
    if existing.get("model_id") != model.model_id:
        raise ValueError(
            f"adapter {adapter_id!r} belongs to model "
            f"{existing.get('model_id')!r}, not {model.model_id!r}")
    prev = validate_config(existing.get("config") or {})
    if (prev["rank"], prev["targets"]) != (config["rank"],
                                           config["targets"]):
        raise ValueError(
            f"adapter {adapter_id!r} exists with rank={prev['rank']} "
            f"targets={prev['targets']}; retrain with the same shape or "
            f"DELETE /adapters/ first")
    return existing["params"]


def train_adapter(model, adapter_id: str, config: dict, dataset_id: str,
                  shard: int = 0, epochs: int = 1, batch_size: int = 1,
                  block_size: int = 1024, step_size: int = 1):
    """``PUT /train/`` with an ``adapter`` (JAX ``train_adapter``).

    The base parameters are frozen and the forward runs in their own dtype
    (as the JAX package's, which passes no compute dtype): only the
    adapter's fp32 leaves take gradients, through the flash and
    cross-entropy kernels on the card.  The loader is the base trainer's:
    every micro-step reads a full ``(batch_size, block_size)`` buffer and
    ``num_steps = buffer // (step_size · block)`` micro-steps accumulate
    (fp32, averaged) into one step of the model's optimizer DSL over the
    adapter tree.  The adapter-only checkpoint is written at the start
    (``Training``), every ~10 s, and at the end (``Trained``), or with
    ``Error`` and the message.  An existing checkpoint of the same shape
    resumes.  ``PENROZ_REMAT=1`` recomputes each micro-step's forward in
    its backward and the decode-priority windows open between epochs and
    micro-steps, as in the base trainer.  Returns the trained ``{key: fp32
    tensor}``."""
    from penroz_tpu_torch.data.loaders import Loader
    from penroz_tpu_torch.models import dsl
    from penroz_tpu_torch.models import model as model_mod

    config = validate_config(config)
    model_id = model.model_id
    device = model.device
    start = _starting_params(model, adapter_id, config)
    leaves = {k: _tensor(v, device).requires_grad_(True)
              for k, v in start.items()}
    progress: list = []

    def persist(status, sync=False):
        save_adapter(adapter_id, model_id, config, leaves, status, progress,
                     sync_flush=sync)

    persist({"code": "Training",
             "message": f"Training adapter on {dataset_id}"})
    try:
        model.arch.check_positions(block_size, "block_size")
        buffer_size = batch_size * block_size
        num_steps = max(1, buffer_size // (step_size * block_size))
        loader = Loader(dataset_id, begin_shard=shard, begin_idx=0,
                        buffer_size=buffer_size, idx_offset=buffer_size)
        optimizer = dsl.build_optimizer(model.optimizer_config,
                                        list(leaves.values()))
        binding = bind(leaves, config, device)
        base = {k: p.detach() for k, p in model.arch.named_parameters()}
        generator = torch.Generator(device=device).manual_seed(0)
        last_save = time.monotonic()
        remat = model_mod.remat_enabled()

        def loss(x, y):
            return torch.func.functional_call(
                model.arch, base, (x, y),
                {"skip_softmax": True, "training": True,
                 "generator": generator, "adapter": binding})[1]

        for epoch in range(epochs):
            model_mod._yield_to_decodes()
            micro = (num_steps > 1 and model_mod.decode_pending() > 0
                     and model_mod._priority_cap_ms() > 0)
            t0 = time.monotonic()
            grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
            cost_sum = torch.zeros((), dtype=torch.float32, device=device)
            for i in range(num_steps):
                if i and micro:
                    model_mod._yield_to_decodes()
                x, y = loader.next_batch()
                x, y = (torch.from_numpy(a.reshape(batch_size, block_size))
                        .to(device, torch.int64) for a in (x, y))
                with torch.enable_grad():
                    cost = (model_mod.remat_loss(loss, generator, model.arch,
                                                 x, y)
                            if remat else loss(x, y))
                    cost.backward()
                for k, leaf in leaves.items():
                    if leaf.grad is not None:
                        grads[k] += leaf.grad.float()
                        leaf.grad = None
                cost_sum += cost.detach().float()
            inv = 1.0 / num_steps
            for k, leaf in leaves.items():
                leaf.grad = (grads[k] * inv).to(leaf.dtype)
            optimizer.step()
            optimizer.zero_grad(set_to_none=True)
            cost = float(cost_sum * inv)
            duration = time.monotonic() - t0
            progress.append({"epoch": epoch + 1, "cost": cost,
                             "durationInSecs": duration})
            log.info("Adapter %s epoch %d: cost=%.4f", adapter_id,
                     epoch + 1, cost)
            if time.monotonic() - last_save >= 10:
                persist({"code": "Training",
                         "message": f"Training adapter on {dataset_id}"})
                last_save = time.monotonic()
        persist({"code": "Trained",
                 "message": f"Trained {epochs} epoch(s)"}, sync=True)
        log.info("Adapter %s training completed (%d epochs)", adapter_id,
                 epochs)
    except Exception as e:  # noqa: BLE001 — recorded, then re-raised
        try:
            persist({"code": "Error", "message": str(e)}, sync=True)
        except Exception:  # noqa: BLE001
            log.exception("Failed to persist adapter error status")
        raise
    return {k: v.detach() for k, v in leaves.items()}
