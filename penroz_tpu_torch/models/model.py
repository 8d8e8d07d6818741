"""Model runtime: the compiled architecture and the NeuralNetworkModel
facade (counterpart of penroz_tpu/models/model.py: serving and training).

- :class:`CompiledArch` — a layer DSL built into an ``nn.Module`` tree whose
  ``state_dict`` keys equal the JAX package's flat parameter keys, with the
  forward and its cost, one training epoch (``train_epoch``), the
  instrumented ``/stats/`` pass (``stats_grads``) and sampling
  (``_sample_packed``, with positional keys).
- :class:`NeuralNetworkModel` — create, ``state_dict``, serialize /
  deserialize / delete over the ``PENROZC1`` container (optimizer state in
  the JAX package's optax leaf layout), training (``train_model``,
  ``train_model_on_device``, refreshing ``/stats/``), generation
  (``generate_tokens``/``generate_tokens_stream`` over ``_generate_iter``:
  chunks of up to ``PENROZ_DECODE_CHUNK`` steps through the process-wide
  runners of models/decode_graphs.py, CUDA graphs on the card, on the
  contiguous cache or, under ``PAGED_KV_CACHE=1``, the paged pool, with
  the recurrent ``ssm`` child for hybrid models), ragged batched
  generation (``generate_tokens_batched``), the raw forward
  (``compute_output``), forward-only evaluation (``evaluate_model``), the
  continuous-batching scheduler's unified block (``decode_mixed_step``),
  its phased ticks' step-wise decode (``decode_prefill_chunk``,
  ``decode_verify_row``, ``decode_step_batched``, ``decode_superstep``)
  and its pipeline stages (``serve_pipeline``, :class:`ServePipeline`,
  ``decode_pipe_stage``).

Training runs on one device; with an ``adapter`` it trains a LoRA
adapter's factors alone (models/lora.py ``train_adapter``).  Its options,
as in the JAX package: ``PENROZ_TRAIN_WORKER=1`` trains in a child
process (models/train_worker.py, :meth:`NeuralNetworkModel.
_train_in_worker_process`: a crash there leaves the server serving and
the checkpoint at ``Error``); ``PENROZ_REMAT=1`` recomputes each
micro-step's forward in its backward (:func:`remat_loss`, the same
dropout masks); decode priority (:func:`decode_priority`,
``PENROZ_DECODE_PRIORITY_MS``, default 1000, 0 off): while a decode is in
flight, training waits for it between epochs and, within an epoch,
between micro-steps.  Out of this slice, and refused with a ValueError
(HTTP 400) rather than ignored: meshes (``PENROZ_MESH_*``,
``PENROZ_FSDP``, ``PENROZ_WUS``, ``PENROZ_SP_MODE``,
``PENROZ_PIPE_REMAT``): see :func:`unported_training_options`.
Evaluation runs on one device too; the meshes and sequence-parallel modes
it would take are refused the same way (:func:`unported_evaluation_options`).
Every route that runs attention refuses ``PENROZ_DISABLE_FLASH=1``, the
JAX package's switch to its plain attention path
(:func:`unported_attention_options`).

The JAX package fuses up to 128 decode steps per dispatch with
``lax.scan`` over power-of-two chunks; the port dispatches the same chunks
(``_decode_chunk_size``), each as that many replays of one captured step.
The greedy tokens are the same: the cache fills to ``block_size`` either
way, and the overflow crop and re-prefill happen at the same token.
"""

from __future__ import annotations

import atexit
import contextlib
import json
import logging
import os
import random
import threading
import time
from typing import Optional

import numpy as np
import torch
from torch import nn

from penroz_tpu_torch.device import resolve_device
from penroz_tpu_torch.models import convert, decode_graphs, dsl
from penroz_tpu_torch.models.convert import as_tensor, from_jax_state_dict
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.ops import attention as attn_ops
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops import losses
from penroz_tpu_torch.ops import modules as M
from penroz_tpu_torch.parallel import dist, zero
from penroz_tpu_torch.parallel.zero import update_ratio
from penroz_tpu_torch.utils import checkpoint, profiling
from penroz_tpu_torch.utils import stats as stats_lib

log = logging.getLogger(__name__)

# NeuralNetworkModel._opt_leaves of a model deserialized without them.
_NOT_LOADED = object()

# Environment switches of JAX-package training features this port does not
# have: (variable, value that leaves the feature off, what it selects).
_UNPORTED_TRAINING_ENV = (
    ("PENROZ_MESH_MODEL", "1", "a tensor-parallel mesh"),
    ("PENROZ_MESH_SEQUENCE", "1", "sequence parallelism"),
    ("PENROZ_MESH_EXPERT", "1", "an expert-parallel mesh"),
    ("PENROZ_MESH_PIPE", "1", "pipeline parallelism"),
    ("PENROZ_SP_MODE", None, "a sequence-parallel attention mode"),
    ("PENROZ_PIPE_REMAT", None, "a pipeline remat schedule"),
)


# The subset of those that selects a mesh for forward-only evaluation
# (the JAX package's ``_eval_mesh``).
_EVAL_MESH_ENV = ("PENROZ_MESH_MODEL", "PENROZ_MESH_SEQUENCE",
                  "PENROZ_MESH_EXPERT", "PENROZ_MESH_PIPE", "PENROZ_SP_MODE")

# Per-model count of the training runs this process has started: the
# train-end barrier's name, the same on every rank (a run is counted at its
# start, however it ends, and every rank gets every request).  Module-level:
# each /train/ request deserializes a model object of its own.
_TRAIN_SEQ: dict = {}
TRAIN_MESH_ENV = "PENROZ_TRAIN_MESH"


# Decode priority: generation wraps its device work in decode_priority();
# training reads decode_pending() between epochs and micro-steps and waits
# for the decodes in flight (at most PENROZ_DECODE_PRIORITY_MS a window).
_DECODE_PENDING = 0
_DECODE_LOCK = threading.Lock()
DECODE_PRIORITY_ENV = "PENROZ_DECODE_PRIORITY_MS"

# Live training-worker processes by model id (PENROZ_TRAIN_WORKER=1); an
# entry leaves when its worker exits.  The atexit sweep covers a clean
# shutdown; a worker whose parent dies exits by itself
# (train_worker._watch_parent).
_TRAIN_WORKERS: dict = {}
TRAIN_WORKER_ENV = "PENROZ_TRAIN_WORKER"
REMAT_ENV = "PENROZ_REMAT"


def _kill_train_workers():
    for proc in list(_TRAIN_WORKERS.values()):
        if proc.poll() is None:
            proc.kill()


atexit.register(_kill_train_workers)


@contextlib.contextmanager
def decode_priority():
    """Mark a decode's device work in flight for the duration."""
    global _DECODE_PENDING
    with _DECODE_LOCK:
        _DECODE_PENDING += 1
    try:
        yield
    finally:
        with _DECODE_LOCK:
            _DECODE_PENDING -= 1


def decode_pending() -> int:
    return _DECODE_PENDING


def _priority_cap_ms() -> float:
    return float(os.environ.get(DECODE_PRIORITY_ENV, "1000"))


def _yield_to_decodes():
    """Wait while decodes are in flight, at most
    ``PENROZ_DECODE_PRIORITY_MS`` (default 1000; 0 turns the wait off), so
    that a decode storm cannot starve training.  Over several ranks, never:
    one rank's pause would only stall the others' collectives."""
    if dist.process_count() > 1:
        return
    cap_ms = _priority_cap_ms()
    if cap_ms <= 0 or decode_pending() <= 0:
        return
    deadline = time.monotonic() + cap_ms / 1000.0
    while decode_pending() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)


def remat_enabled() -> bool:
    return os.environ.get(REMAT_ENV, "0") == "1"


def remat_loss(fn, generator, module, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (the JAX package's
    ``jax.checkpoint(loss_fn)``): the forward keeps no activations and the
    backward runs it again.  The replay draws the same dropout seeds from
    ``generator`` (its state is set back to the forward's for the replay,
    then to where the forward left it) and sees ``module``'s buffers as
    the forward saw them (a buffer the forward writes in place, BatchNorm's
    statistics, the MoE ``router_fraction``, keeps the forward's value)."""
    from torch.utils import checkpoint as ckpt
    saved = {}

    @contextlib.contextmanager
    def forward_ctx():
        if generator is not None:
            saved["gen"] = generator.get_state()
        saved["bufs"] = {k: b.detach().clone()
                         for k, b in module.named_buffers()}
        yield

    @contextlib.contextmanager
    def recompute_ctx():
        gen_after = generator.get_state() if generator is not None else None
        bufs = dict(module.named_buffers())
        bufs_after = {k: b.detach().clone() for k, b in bufs.items()}
        with torch.no_grad():
            for k, b in bufs.items():
                b.copy_(saved["bufs"][k])
        if generator is not None:
            generator.set_state(saved["gen"])
        try:
            yield
        finally:
            if generator is not None:
                generator.set_state(gen_after)
            with torch.no_grad():
                for k, b in bufs.items():
                    b.copy_(bufs_after[k])

    return ckpt.checkpoint(fn, *args, use_reentrant=False,
                           context_fn=lambda: (forward_ctx(),
                                               recompute_ctx()))


def _refuse_unported(names=None) -> None:
    for name, off, what in _UNPORTED_TRAINING_ENV:
        if names is not None and name not in names:
            continue
        value = os.environ.get(name)
        if value is not None and value != off:
            raise ValueError(f"{name}={value!r} selects {what}, which "
                             f"penroz_tpu_torch does not support yet")


def unported_training_options() -> None:
    """Raise ValueError naming any JAX-package training feature selected by
    the environment that the port does not have (see the module note)."""
    _refuse_unported()


def unported_attention_options() -> None:
    """Raise ValueError when ``PENROZ_DISABLE_FLASH=1`` asks for the plain
    attention path: the JAX package then skips its attention kernels, but
    the port has no plain attention path on the card."""
    value = os.environ.get("PENROZ_DISABLE_FLASH")
    if value == "1":
        raise ValueError(f"PENROZ_DISABLE_FLASH={value!r} selects the plain "
                         f"attention path, which penroz_tpu_torch does not "
                         f"support yet")


def unported_evaluation_options() -> None:
    """Raise ValueError naming a mesh or sequence-parallel mode selected by
    the environment for ``/evaluate/``: the port evaluates on one device
    a rank."""
    _refuse_unported(_EVAL_MESH_ENV)


DECODE_CHUNK_ENV = "PENROZ_DECODE_CHUNK"


def _chunk_budget() -> int:
    """Decode steps fused per dispatch (PENROZ_DECODE_CHUNK, default 128)."""
    return max(1, int(os.environ.get(DECODE_CHUNK_ENV, "128")))


def _decode_chunk_size(remaining: int, cap: int) -> int:
    """Pow-2 ceiling of the remaining tail, clipped by ``cap`` (a non-pow-2
    cap floors back down) — the JAX package's bounded-program-set chunk
    policy."""
    chunk = min(1 << (remaining - 1).bit_length(), cap)
    if chunk & (chunk - 1):
        chunk = 1 << (chunk.bit_length() - 1)
    return chunk


def _max_generate_batch() -> int:
    """Server-side /generate_batch/ row cap (PENROZ_MAX_GENERATE_BATCH)."""
    try:
        return max(1, int(os.environ.get("PENROZ_MAX_GENERATE_BATCH", "64")))
    except ValueError:
        log.warning("Unparseable PENROZ_MAX_GENERATE_BATCH=%r; "
                    "using default 64",
                    os.environ.get("PENROZ_MAX_GENERATE_BATCH"))
        return 64


def validate_batch_generation(prompts: list[list[int]], block_size: int,
                              max_new_tokens: int) -> None:
    """Reject batched-generation requests that cannot be served losslessly
    (JAX ``validate_batch_generation``): an empty prompt, more rows than
    ``PENROZ_MAX_GENERATE_BATCH``, or a row with ``prompt_len +
    max_new_tokens > block_size`` (no overflow crop in a batch) — a
    ValueError (HTTP 400) naming the rows."""
    if not prompts or any(not p for p in prompts):
        raise ValueError("each batched prompt needs at least one token")
    max_batch = _max_generate_batch()
    if len(prompts) > max_batch:
        raise ValueError(
            f"batched generation accepts at most {max_batch} prompts "
            f"(got {len(prompts)}; raise PENROZ_MAX_GENERATE_BATCH to "
            f"override)")
    over = [(i, len(p)) for i, p in enumerate(prompts)
            if len(p) + max_new_tokens > block_size]
    if over:
        detail = ", ".join(f"row {i} (prompt {n} tokens)"
                           for i, n in over[:8])
        more = f" and {len(over) - 8} more" if len(over) > 8 else ""
        raise ValueError(
            f"batched generation needs prompt_len + max_new_tokens "
            f"({max_new_tokens}) <= block_size ({block_size}) for every "
            f"row; overflowing: {detail}{more} — crop prompts first")


def train_compute_dtype(device: torch.device) -> Optional[torch.dtype]:
    """Compute dtype of a training run: bf16 on the card, none (the params'
    own) on the CPU, as the JAX package runs bf16 on its accelerator;
    ``PENROZ_TRAIN_DTYPE=float32|bfloat16|float16`` overrides."""
    name = os.environ.get("PENROZ_TRAIN_DTYPE", "")
    if not name:
        return torch.bfloat16 if device.type == "cuda" else None
    if name == "float32":
        return None
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"PENROZ_TRAIN_DTYPE={name!r} is not a floating "
                         f"dtype")
    return dtype


class CompiledArch(nn.Module):
    """A layer DSL built into modules under ``layers.{i}``."""

    def __init__(self, layers: list[dict]):
        super().__init__()
        self.layers_dsl = layers
        self.layers = nn.ModuleList(dsl.build_modules(layers))
        self.algos = [dsl.layer_algo(entry) for entry in layers]
        self.classification = any(isinstance(m, M.Softmax)
                                  for m in self.layers)
        self.attn_layers: list[M.CausalSelfAttention] = []
        self.ssm_layers: list[M.GatedSSM] = []
        self._index_attention()
        for prefix, mod in self.named_modules():
            if isinstance(mod, M.Linear):
                mod.prefix = prefix     # the key LoRA factors bind to

    @property
    def param_order(self) -> list[str]:
        """Parameter keys in module walk order (the JAX ``param_order``)."""
        return [k for k, _ in self.named_parameters()]

    def _index_attention(self):
        """Assign KV-cache slots and infer head dims from the preceding
        fused QKV projection.  ``ssm`` layers get their own slot sequence:
        their state lives in the cache's recurrent child."""

        def visit(mod):
            if isinstance(mod, M.CausalSelfAttention):
                mod.layer_idx = len(self.attn_layers)
                self.attn_layers.append(mod)
            if isinstance(mod, M.GatedSSM):
                mod.layer_idx = len(self.ssm_layers)
                self.ssm_layers.append(mod)
            if isinstance(mod, M.Sequential):
                prev = None
                for child in mod.layers:
                    if (isinstance(child, M.CausalSelfAttention)
                            and child.head_dim is None
                            and isinstance(prev, M.Linear)):
                        child.head_dim = prev.out_features // (
                            child.num_heads + 2 * child.num_kv_heads)
                    visit(child)
                    prev = child
            else:
                for _, child in mod.named_children():
                    visit(child)

        for mod in self.layers:
            visit(mod)

    @property
    def kv_specs(self) -> list[tuple[int, int]]:
        """Per-attention-layer (num_kv_heads, head_dim) for KV allocation."""
        specs = []
        for mod in self.attn_layers:
            if mod.head_dim is None:
                raise ValueError("Attention head_dim could not be inferred; "
                                 "precede attention with a fused QKV linear "
                                 "or pass head_dim explicitly")
            specs.append((mod.num_kv_heads, mod.head_dim))
        return specs

    @property
    def ssm_specs(self) -> list[tuple[int, int, int]]:
        """Per-``ssm``-layer (num_heads, head_dim, value_dim) for the
        fixed-size recurrent state (ops/ssm.py::SSMState.create)."""
        return [(mod.num_heads, mod.head_dim, mod.value_dim)
                for mod in self.ssm_layers]

    @property
    def max_positions(self) -> Optional[int]:
        """Rows of the smallest learned position table (None without
        one): a packed batch's positions must stay below it."""
        sizes = [m.num_embeddings for m in self.modules()
                 if isinstance(m, M.PositionEmbedding)]
        return min(sizes) if sizes else None

    def check_positions(self, length: int, what: str) -> None:
        """ValueError (HTTP 400) naming the table size when ``length``
        positions (``what``: a ``block_size``, an input's length) do not
        fit the smallest learned position table.  Every route checks
        before its first token; the JAX package does not, and past the
        table its gather reads NaN (NaN logits, token 0)."""
        limit = self.max_positions
        if limit is not None and length > limit:
            raise ValueError(f"{what} {length} exceeds the model's learned "
                             f"position table of {limit} positions")

    def forward(self, tokens, targets=None, *, kv=None, skip_softmax=False,
                training=False, generator=None, pos_offset=None,
                ragged_descs=None, ragged_rows=None, adapter=None,
                lora=None, lora_idx=None, ssm_count=None):
        """Full forward collecting every top-level activation; returns
        ``(activations, cost, new_kv)``: ``cost`` is None without
        ``targets``, and the cache is advanced by the tokens fed (in
        place) — except for a packed batch (``ragged_descs``), whose
        lengths the descriptors carry, and a cache bound to device
        positions (``kv.at_positions``), whose host length the caller
        mirrors.  ``training`` turns dropout on,
        drawing from ``generator``.  The cost reads the logits, the input
        of the first top-level softmax (or the last activation), plus the
        auxiliary losses a training forward collects (the MoE load
        balance), as the JAX package's ``forward`` adds them.  LoRA
        (models/lora.py): ``adapter`` binds one adapter to the whole
        forward; ``lora`` (a pack) with ``lora_idx`` (each row's or
        packed token's slot) mixes adapters in one batch.  ``ssm_count``
        ((B,) tensor) feeds each row's recurrent state only its first
        ``ssm_count[b]`` tokens (a right-padded prompt, a parked row)."""
        ctx = M.Ctx(kv=kv, training=training, generator=generator,
                    pos_offset=pos_offset, ragged_descs=ragged_descs,
                    ragged_rows=ragged_rows, adapter=adapter, lora=lora,
                    lora_idx=lora_idx, ssm_count=ssm_count)
        acts = []
        h = tokens
        logits = None
        for mod in self.layers:
            if isinstance(mod, M.Softmax):
                if logits is None:
                    logits = h
                if skip_softmax:
                    continue
            h = mod(h, ctx)
            acts.append(h)
        cost = (self._cost_from_logits(h if logits is None else logits,
                                       targets)
                if targets is not None else None)
        if cost is not None and ctx.aux_losses:
            cost = cost + sum(ctx.aux_losses)
        new_kv = kv
        if (kv is not None and ragged_descs is None
                and kv.positions is None):
            new_kv = kv.advanced(tokens.shape[-1])
        return acts, cost, new_kv

    def _cost_from_logits(self, logits, targets):
        """CE for classification stacks (the fused cross-entropy kernels),
        MSE otherwise."""
        if self.classification:
            return losses.fused_cross_entropy_mean(logits, targets)
        return torch.mean((logits.float() - targets.float()) ** 2)

    def train_epoch(self, optimizer, xs, ys, *, compute_dtype=None,
                    generator=None, with_ratios=True, remat=False,
                    yield_cb=None, replicas=None):
        """One epoch (JAX ``train_epoch_fn``): ``num_steps = len(xs)``
        micro-steps of (B, T) token batches, gradients accumulated in fp32,
        then one optimizer step.

        The parameters are cast to ``compute_dtype`` once per epoch; each
        micro-step's gradient (in that dtype) is added to an fp32 sum,
        which is averaged and cast to each parameter's dtype before
        ``optimizer.step()``.  Each micro-step's cost carries its own
        auxiliary losses; a buffer a micro-step writes in place (BatchNorm's
        statistics, the MoE ``router_fraction``) is what the next one
        reads, so the last micro-step's value stands, as in the JAX
        package's scan carry.  Returns ``(cost, ratios)``: the mean cost
        (fp32 device scalar) and, when ``with_ratios``, the update ratios
        ``std(Δw) / std(w)`` of every parameter in :attr:`param_order`
        (fp32 device vector), else None.

        ``remat`` (``PENROZ_REMAT=1``) recomputes each micro-step's forward
        in its backward (:func:`remat_loss`: the same dropout masks, the
        same cost and gradients); ``yield_cb`` is called before every
        micro-step but the first (the decode-priority window,
        :func:`_yield_to_decodes`).

        ``replicas`` (a parallel/zero.py ``DataParallel``, a run over
        ranks): the gradients, the cost and the floating buffers are
        averaged over the ranks before the step; under ``PENROZ_FSDP``
        the parameters are gathered first, and under ``PENROZ_WUS`` /
        ``PENROZ_FSDP`` the step is the rank's pieces' (``optimizer`` is
        then unused)."""
        if replicas is not None:
            replicas.materialize()
        named = dict(self.named_parameters())
        params_c = {}
        for key, p in named.items():
            dtype = (compute_dtype if compute_dtype is not None
                     and p.is_floating_point() else p.dtype)
            params_c[key] = p.detach().to(dtype).requires_grad_(True)
        grads = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in named.items()}
        cost_sum = torch.zeros((), dtype=torch.float32, device=xs.device)

        def loss(params, x, y):
            return torch.func.functional_call(
                self, params, (x, y),
                {"skip_softmax": True, "training": True,
                 "generator": generator})[1]

        for i, (x, y) in enumerate(zip(xs, ys)):
            if i and yield_cb is not None:
                yield_cb()
            if remat:
                cost = remat_loss(loss, generator, self, params_c, x, y)
            else:
                cost = loss(params_c, x, y)
            cost.backward()
            for key, leaf in params_c.items():
                if leaf.grad is not None:
                    grads[key] += leaf.grad
                    leaf.grad = None
            cost_sum += cost.detach().float()
        num_steps = len(xs)
        inv = 1.0 / num_steps
        with torch.no_grad():
            del params_c
            if replicas is not None:
                cost = replicas.average(grads, cost_sum, num_steps,
                                        dict(self.named_buffers()))
                inv = 1.0   # the grads are the means now
            else:
                cost = cost_sum * inv
            old = ({k: p.detach().clone() for k, p in named.items()}
                   if with_ratios else None)
            if replicas is not None and replicas.stage:
                by_key = replicas.step(grads, old)
                del grads
            else:
                for key, p in named.items():
                    p.grad = (grads[key] * inv).to(p.dtype)
                del grads
                optimizer.step()
                optimizer.zero_grad(set_to_none=True)
                by_key = ({k: update_ratio(named[k] - old[k], old[k])
                           for k in named} if with_ratios else None)
            ratios = None
            if with_ratios:
                ratios = torch.stack([by_key[k] for k in self.param_order]) \
                    if named else torch.zeros(0)
        return cost, ratios

    def stats_grads(self, x, y):
        """Activations, activation gradients and weight gradients of one
        batch — the ``/stats/`` inputs (JAX ``stats_grads``).  One forward
        in the parameters' dtype with ``training=False`` (no dropout) and
        ``skip_softmax=True``; every top-level activation keeps its
        gradient (``retain_grad``, the reference's own method, where the
        JAX package differentiates zero deltas added to each); the cost
        comes from the logits and one ``backward()`` fills the rest.  The
        SSM layers take their differentiable oracle, as the gradient needs
        (ops/ssm.py::gla_full).  Returns ``(acts, act_grads,
        weight_grads)``, the weight gradients in :attr:`param_order`; a
        tensor the cost does not reach has a zero gradient, as in JAX."""
        params = {k: p.detach().requires_grad_(True)
                  for k, p in self.named_parameters()}
        with torch.enable_grad():
            acts, cost, _ = torch.func.functional_call(
                self, params, (x, y), {"skip_softmax": True})
            for a in acts:
                if a.requires_grad:
                    a.retain_grad()
            cost.backward()

        def grad_of(t):
            return (t.grad if t.grad is not None
                    else torch.zeros_like(t)).detach()

        return ([a.detach() for a in acts], [grad_of(a) for a in acts],
                [grad_of(params[k]) for k in self.param_order])

    @staticmethod
    def _sample_packed(logits, seed, row_ids, positions, temp, top_k):
        """(Tp,) tokens from packed (Tp, V) logits with a POSITIONAL key per
        slot: the Gumbel noise of candidate ``c`` is a counter-based hash
        of ``(seed, row, position, c)``, so a (row, position) pair draws
        the same token whatever packed slot, superstep or chunk split it
        rides in — the invariance of the JAX package's ``fold_in(fold_in(
        rng, row), position)`` keys (the numbers differ: JAX's generator
        is not reproduced).  Gumbel-max draws exactly from
        softmax(logits / temp), top-k restricted when given.  Padding
        slots (``row_ids < 0``) draw as row 0 and are discarded.  ``seed``
        and ``temp`` are host numbers, or device scalars (int64, fp32) that
        a captured step reads at replay."""
        logits = logits.to(torch.float32)
        if isinstance(temp, torch.Tensor):
            logits = logits / torch.clamp(temp, min=1e-6)
        else:
            logits = logits / max(float(temp), 1e-6)
        row = torch.clamp(row_ids, min=0).to(torch.int64)[:, None]
        pos = torch.clamp(positions, min=0).to(torch.int64)[:, None]
        if top_k is not None:
            scores, cand = torch.topk(logits, int(top_k), dim=-1)
        else:
            scores = logits
            cand = torch.arange(logits.shape[-1], device=logits.device
                                )[None, :]
        u = _hash_uniform(seed, row, pos, cand)
        choice = torch.argmax(scores - torch.log(-torch.log(u)), dim=-1)
        if top_k is not None:
            return torch.gather(cand, -1, choice[:, None])[:, 0]
        return choice


class ServePipeline:
    """Stage partition of a compiled arch for pipeline-parallel serving
    (``PENROZ_SERVE_PIPE_STAGES``; JAX ``ServePipeline``).

    Stage ``s`` runs the top-level modules ``arch.layers[lo:hi]`` over
    ``bounds[s]`` (parallel/pipeline.py ``serve_stage_bounds``: contiguous
    runs of the repeated blocks, the embeddings with the first stage, the
    final norm and head with the last).  The stages hold the model's own
    module objects, so they share its parameter tensors: nothing is
    copied.  Stage ``s`` owns attention layers ``kv_bounds[s] = [lo,
    hi)`` of the paged cache and runs against ``stage_kv_view(kv, lo,
    hi)``.  On one card every stage runs on it (the JAX package's
    degenerate single-device group): the partition and the schedule run,
    no placement does."""

    def __init__(self, arch: "CompiledArch", stages: int):
        from penroz_tpu_torch.parallel import pipeline
        if arch.ssm_layers:
            raise ValueError(
                "pipeline serving does not support SSM/recurrent blocks: "
                "stage_kv_view slices attention pools only and would drop "
                "the per-row recurrent state")
        self.stages = int(stages)
        self.bounds = pipeline.serve_stage_bounds(arch.layers_dsl,
                                                  self.stages)
        self.modules = [list(arch.layers[lo:hi]) for lo, hi in self.bounds]
        self.kv_bounds: list[tuple] = []
        off = 0
        for s, mods in enumerate(self.modules):
            n = sum(isinstance(m, M.CausalSelfAttention)
                    for mod in mods for m in mod.modules())
            if n == 0:
                raise ValueError(
                    f"pipeline stage {s} owns no attention layers; lower "
                    f"PENROZ_SERVE_PIPE_STAGES (bounds {self.bounds[s]})")
            self.kv_bounds.append((off, off + n))
            off += n
        if off != len(arch.attn_layers):
            raise ValueError(
                f"stage KV partition covers {off} attention layers, "
                f"model has {len(arch.attn_layers)}")

    def stage_parameters(self, s: int) -> list:
        """The parameter tensors stage ``s`` runs with (the model's own)."""
        return [p for mod in self.modules[s] for p in mod.parameters()]


def _mix32(a, b, c):
    """A lowbias32-style avalanche of three uint32 words (int64 tensors in
    [0, 2^32)) — the mixer of the flash kernels' dropout hash."""
    mul = attn_ops._mul32
    x = mul(a, 0x9E3779B1) ^ mul(b, 0x85EBCA77) ^ mul(c, 0xC2B2AE3D)
    x = x ^ (x >> 16)
    x = mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def _hash_uniform(seed, row, pos, cand):
    """Uniform draws in (0, 1), fp32, one per broadcast (row, position,
    candidate), from a counter-based hash of ``seed`` and the three (the
    seed enters as a host int, no host-to-device copy, or as an int64
    device scalar)."""
    seed = (seed if isinstance(seed, torch.Tensor) else int(seed)) \
        & 0xFFFFFFFF
    h = _mix32(_mix32(seed, row, pos), cand.to(torch.int64), 0x27D4EB2F)
    return ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))


class NeuralNetworkModel:
    """Model lifecycle facade: create, persist, train, generate."""

    def __init__(self, model_id: str, mapper: Mapper, device=None,
                 seed: int = 0, params: Optional[dict] = None):
        """Build the DSL on ``device`` (default ``cuda``) with weights drawn
        from ``seed``, or installed from ``params`` (see
        :meth:`load_state`)."""
        self.model_id = model_id
        self.layers_dsl = mapper.layers
        self.optimizer_config = mapper.optimizer
        self.device = resolve_device(device)
        self.arch = CompiledArch(mapper.layers).eval()
        if params is None:
            mapper.init_params(list(self.arch.layers), seed=seed)
            self.arch.to(self.device)
        else:
            self.load_state(params)
        self.progress: list[dict] = []
        self.avg_cost: Optional[float] = None
        self.avg_cost_history: list[float] = []
        self.stats: Optional[dict] = None
        self.status = {"code": "Created", "message": "Model created"}
        # (adapter params, config) that generation applies, or None: set
        # on a shallow copy by models/lora.py ``bind_model``
        self.adapter = None
        self._generator = self._new_generator()
        # torch.optim optimizer, built at first use; until then the
        # checkpoint's optimizer leaves wait here (None: a fresh state;
        # _NOT_LOADED: deserialized without them).
        self._opt: Optional[torch.optim.Optimizer] = None
        self._opt_leaves = None
        # the training state over ranks of the last run (parallel/zero.py
        # DataParallel), or None: one process
        self._replicas = None

    def _new_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(0)

    # -- introspection ------------------------------------------------------

    @property
    def dtype(self) -> torch.dtype:
        for p in self.arch.parameters():
            if p.is_floating_point():
                return p.dtype
        return torch.float32

    def state_dict(self) -> dict:
        """Flat params + buffers under the JAX package's key names (CPU)."""
        return {k: v.detach().to("cpu")
                for k, v in self.arch.state_dict().items()}

    def load_state(self, arrays: dict):
        """Install parameters and buffers from a flat ``{key: tensor |
        ndarray}`` dict (exact parameter key set and shapes; dtypes are
        kept as given).  A buffer the dict lacks keeps its module default,
        as the JAX package's ``deserialize`` migrates a checkpoint written
        before its module gained the buffer (the MoE ``router_fraction``)."""
        expected = self.arch.state_dict()
        buffers = {k for k, _ in self.arch.named_buffers()}
        missing = sorted(set(expected) - set(arrays) - buffers)
        extra = sorted(set(arrays) - set(expected))
        if missing or extra:
            raise ValueError(f"parameter keys differ from the DSL: missing "
                             f"{missing[:8]}, unexpected {extra[:8]}")
        tensors = {}
        for key, ref in expected.items():
            if key not in arrays:
                tensors[key] = ref.to(self.device)
                continue
            t = convert.fit_scalar(as_tensor(arrays[key]), ref.shape)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            tensors[key] = t.to(self.device)
        self.arch.load_state_dict(tensors, strict=True, assign=True)
        return self

    # -- inference ----------------------------------------------------------

    def _as_input(self, data):
        """A request's input as a tensor on the model's device: integer
        data as int64 token ids, (batch, length) for a model with
        attention layers; anything else in the parameters' dtype."""
        try:
            arr = np.asarray(data)
        except ValueError:
            raise ValueError(
                "input rows have inconsistent lengths; expected a "
                "rectangular batch like [[1, 2, 3], [4, 5, 6]]")
        if arr.dtype.kind in "iu":
            if self.arch.attn_layers and arr.ndim != 2:
                # say what is wrong at the API boundary (HTTP 400) rather
                # than deep in the stack
                raise ValueError(
                    f"token input must be 2-D (batch, length) for this "
                    f"model, e.g. [[1, 2, 3]]; got {arr.ndim}-D")
            return torch.as_tensor(arr.astype(np.int64), device=self.device)
        return torch.as_tensor(arr).to(self.device, self.dtype)

    @torch.inference_mode()
    def compute_output(self, input, target=None):
        """Raw forward: (final activation as nested lists, cost or None)
        (JAX ``compute_output``)."""
        x = self._as_input(input)
        self.arch.check_positions(x.shape[-1], "an input of length")
        t = None
        if target is not None:
            arr = np.asarray(target)
            t = (torch.as_tensor(arr.astype(np.int64), device=self.device)
                 if self.arch.classification
                 else torch.as_tensor(arr, dtype=torch.float32,
                                      device=self.device))
        acts, cost, _ = self.arch(x, t)
        output = acts[-1].to("cpu", torch.float32).tolist()
        return output, (float(cost) if cost is not None else None)

    @torch.inference_mode()
    def evaluate_model(self, dataset_id, target_dataset_id, shard, epochs,
                       batch_size, block_size, step_size) -> float:
        """Forward-only evaluation with the training loader's windows (JAX
        ``evaluate_model``): one ``(batch_size, block_size)`` buffer per
        epoch, forwarded once and weighted by ``1/epochs`` (the reference
        forwards it ``num_steps`` times, with equal results).
        ``target_dataset_id`` reads the targets from a second dataset
        aligned with the inputs; ``step_size`` is unused, as there.  Over
        several ranks each reads its rank-strided windows and the costs are
        averaged (:func:`dist.all_reduce_mean`): every rank must get the
        request.  Each rank evaluates with its full parameters, under
        ``PENROZ_FSDP`` too."""
        from penroz_tpu_torch.data.loaders import Loader
        unported_evaluation_options()
        self.arch.check_positions(block_size, "block_size")
        world, rank = dist.process_count(), dist.process_index()
        buffer_size = batch_size * block_size
        loader = Loader(dataset_id, begin_shard=shard,
                        begin_idx=buffer_size * rank,
                        buffer_size=buffer_size,
                        idx_offset=buffer_size * world)
        target_loader = None
        if target_dataset_id:
            target_loader = Loader(target_dataset_id, begin_shard=shard,
                                   begin_idx=buffer_size * rank,
                                   buffer_size=buffer_size,
                                   idx_offset=buffer_size * world)
        avg_cost = 0.0
        for _ in range(epochs):
            if target_loader is not None:
                x, _ = loader.next_batch(target_offset=0)
                y, _ = target_loader.next_batch(target_offset=0)
            else:
                x, y = loader.next_batch()
            x, y = (torch.from_numpy(a.reshape(batch_size, block_size))
                    .to(self.device, torch.int64) for a in (x, y))
            _, cost, _ = self.arch(x, y, skip_softmax=True)
            avg_cost += float(cost) / epochs
        return dist.all_reduce_mean(avg_cost)

    # -- training -----------------------------------------------------------

    @property
    def optimizer(self) -> torch.optim.Optimizer:
        """The ``torch.optim`` optimizer over the current parameters, built
        from the optimizer DSL at first use and loaded with the
        checkpoint's optax-layout leaves."""
        self._check_whole_optimizer()
        if self._opt is None:
            if self._opt_leaves is _NOT_LOADED:
                raise RuntimeError(f"model {self.model_id} was loaded "
                                   f"without its optimizer state")
            params = dict(self.arch.named_parameters())
            opt = dsl.build_optimizer(self.optimizer_config,
                                      list(params.values()))
            convert.load_opt_state_leaves(self.optimizer_config, opt, params,
                                          self._opt_leaves or [])
            self._opt, self._opt_leaves = opt, None
        return self._opt

    def _check_whole_optimizer(self):
        if self._replicas is not None and self._replicas.stage:
            raise RuntimeError(f"model {self.model_id}'s optimizer state is "
                               f"sharded over ranks ({zero.WUS_ENV} or "
                               f"{zero.FSDP_ENV}): read it from the ranks")

    def _opt_state_leaves(self) -> dict:
        self._check_whole_optimizer()
        if self._opt is None and self._opt_leaves is _NOT_LOADED:
            raise RuntimeError(f"model {self.model_id} was loaded without "
                               f"its optimizer state; refusing to "
                               f"overwrite its checkpoint")
        if self._opt is None and self._opt_leaves:
            return self._opt_leaves
        return convert.opt_state_leaves(self.optimizer_config, self._opt,
                                        dict(self.arch.named_parameters()))

    def train_model(self, dataset_id, shard=0, epochs=1, batch_size=1,
                    block_size=1024, step_size=1):
        """Grad-accumulated training with progress bookkeeping and periodic
        checkpoints (JAX ``train_model``).

        Every micro-step consumes a full ``(batch_size, block_size)``
        buffer from the loader; ``num_steps = batch_size // (step_size *
        world)`` micro-steps accumulate into one optimizer step per epoch.
        ``speedPerSec`` counts ``buffer_size`` tokens per epoch, as the
        JAX package does, although an epoch consumes ``num_steps``
        buffers.  The compute dtype is :func:`train_compute_dtype`;
        update ratios are sampled every ``max(1, epochs // 100)`` epochs;
        a checkpoint is written when 10 s have passed since the last, and
        with it the ``/stats/`` document is refreshed from the epoch's last
        micro-batch when ``PENROZ_STATS_INTERVAL`` seconds (default 60)
        have passed since the last refresh, and always at the end.

        Over ``world`` ranks (parallel/dist.py; every rank gets the same
        request) rank r's loader starts at ``buffer_size * r`` and moves by
        ``buffer_size * world``, and the gradients are averaged once an
        optimizer step (parallel/zero.py), so a step sees the rows that one
        process at ``batch_size * world`` would: ``PENROZ_WUS=1`` shards
        the optimizer moments over the ranks, ``PENROZ_FSDP=1`` the
        parameters too (both no-ops on one process).  The master alone
        records progress and ``/stats/`` and writes the blob; under a
        sharded state every rank writes its shard file at the checkpoints,
        whose epochs the ranks agree on.  The run ends at a barrier
        (:func:`dist.barrier`); ``PENROZ_TRAIN_MESH=0`` is refused over
        several ranks, as in the JAX package."""
        from penroz_tpu_torch.data.loaders import Loader
        master = dist.master_proc()
        saves_shards = False
        _TRAIN_SEQ[self.model_id] = train_seq = \
            _TRAIN_SEQ.get(self.model_id, 0) + 1
        try:
            unported_training_options()
            world, rank = dist.process_count(), dist.process_index()
            buffer_size = batch_size * block_size
            self.progress = []
            self.stats = None
            if world > 1 and os.environ.get(TRAIN_MESH_ENV, "1") == "0":
                # each rank would train a replica of its own on its stride
                # of the data
                raise RuntimeError(
                    f"{TRAIN_MESH_ENV}=0 is invalid when process_count="
                    f"{world} > 1: multi-host training requires the "
                    f"global mesh for gradient sync")
            num_steps = max(1, buffer_size
                            // (step_size * block_size * world))
            loader = Loader(dataset_id, begin_shard=shard,
                            begin_idx=buffer_size * rank,
                            buffer_size=buffer_size,
                            idx_offset=buffer_size * world)
            self.status = {"code": "Training",
                           "message": f"Training on {dataset_id}"}
            if master:
                self.serialize()
            compute_dtype = train_compute_dtype(self.device)
            replicas = self._enter_replicas(world)
            saves_shards = replicas is not None and replicas.sharded
            optimizer = (self.optimizer if replicas is None
                         or not replicas.stage else None)
            sample_every = max(1, epochs // 100)
            generator = torch.Generator(device=self.device).manual_seed(0)
            last_save = time.monotonic()
            last_stats = time.monotonic()
            stats_interval = float(
                os.environ.get("PENROZ_STATS_INTERVAL", "60"))
            last_batch = None  # host micro-batch for /stats/
            remat = remat_enabled()
            for epoch in range(epochs):
                # the decode-priority window: decodes in flight go first
                _yield_to_decodes()
                t0 = time.monotonic()
                long_training = t0 - last_save >= 10
                if saves_shards:
                    # the blob and every shard file from the same step
                    long_training = dist.all_reduce_mean(
                        1.0 if long_training else 0.0) >= 0.5
                with profiling.span("penroz/load_batch"):
                    xs, ys = [], []
                    for _ in range(num_steps):
                        x, y = loader.next_batch()
                        xs.append(x.reshape(batch_size, block_size))
                        ys.append(y.reshape(batch_size, block_size))
                    last_batch = (xs[-1], ys[-1])
                    xs = torch.from_numpy(np.stack(xs)).to(self.device,
                                                           torch.int64)
                    ys = torch.from_numpy(np.stack(ys)).to(self.device,
                                                           torch.int64)
                sampled = epoch % sample_every == 0
                # with a decode in flight, a window before every micro-step
                # bounds its wait to one micro-step
                micro = (world == 1 and num_steps > 1
                         and decode_pending() > 0 and _priority_cap_ms() > 0)
                with profiling.span("penroz/train_epoch"):
                    cost, ratios = self.arch.train_epoch(
                        optimizer, xs, ys, compute_dtype=compute_dtype,
                        generator=generator, with_ratios=sampled,
                        remat=remat,
                        yield_cb=_yield_to_decodes if micro else None,
                        replicas=replicas)
                    cost = float(cost)
                duration = time.monotonic() - t0
                if master:
                    if sampled:
                        self.progress.append({
                            "epoch": epoch + 1,
                            "cost": cost,
                            "durationInSecs": duration,
                            "speedPerSec": buffer_size / max(duration, 1e-9),
                            "weight_upd_ratio":
                                ratios.to("cpu", torch.float64).tolist(),
                        })
                    log.info("Epoch %d: cost=%.4f %.0f tokens/sec",
                             epoch + 1, cost,
                             buffer_size / max(duration, 1e-9))
                if long_training:
                    if replicas is not None:
                        replicas.materialize()  # FSDP: /stats/ reads them
                    if master:
                        refresh = (time.monotonic() - last_stats
                                   >= stats_interval)
                        self._record_overall_progress(
                            last_batch if refresh else None)
                        if refresh:
                            last_stats = time.monotonic()
                    if master or saves_shards:
                        self.serialize(tag=epoch)
                    last_save = time.monotonic()
            if replicas is not None:
                replicas.materialize()
            self.status = {"code": "Trained",
                           "message": f"Trained {epochs} epoch(s)"}
            if master:
                self._record_overall_progress(last_batch)
            if master or saves_shards:
                self.serialize(tag=epochs)
            # the run's end, fenced: a rank racing ahead into the next
            # collective would wait there for the master's bookkeeping; a
            # failure here is a pacing miss, not a failed run
            try:
                dist.barrier(f"train_end_{self.model_id}_{train_seq}")
            except Exception:  # noqa: BLE001
                log.warning("train-end barrier failed; a peer may have "
                            "errored mid-run", exc_info=True)
        except Exception as e:  # noqa: BLE001 — recorded, then re-raised
            self.status = {"code": "Error", "message": str(e)}
            # untagged: ranks get here on their own, so under a sharded
            # state this updates the master's metadata alone and the last
            # agreed checkpoint stands
            if master or saves_shards:
                try:
                    self.serialize(sync_flush=True)
                except Exception:  # noqa: BLE001
                    log.exception("Failed to persist error status")
            # join the train-end fence briefly, so healthy peers go on
            try:
                dist.barrier(f"train_end_{self.model_id}_{train_seq}",
                             timeout_s=60.0)
            except Exception:  # noqa: BLE001
                log.warning("train-end barrier join from error path "
                            "failed", exc_info=True)
            raise

    def _enter_replicas(self, world: int):
        """The run's state over ``world`` ranks (parallel/zero.py), or None
        on one process: stage 3 under ``PENROZ_FSDP=1``, 1 under
        ``PENROZ_WUS=1``, else 0.  A previous run's sharded state on this
        object is gathered back first (a collective: every rank is here)."""
        if self._replicas is not None and self._replicas.stage:
            params, leaves = self._replicas.gather_state()
            params.update({k: b.detach().cpu()
                           for k, b in self.arch.named_buffers()})
            self.load_state(params)
            self._opt, self._opt_leaves = None, leaves
        self._replicas = None
        if world == 1:
            return None
        fsdp = os.environ.get(zero.FSDP_ENV, "0") == "1"
        wus = fsdp or os.environ.get(zero.WUS_ENV, "0") == "1"
        log.info("Training %s over %d ranks (ZeRO stage %d)", self.model_id,
                 world, 3 if fsdp else int(wus))
        params = dict(self.arch.named_parameters())
        if not wus:
            self._replicas = zero.DataParallel(
                params, self.optimizer_config, optimizer=self.optimizer)
        else:
            leaves = self._opt_state_leaves()
            self._opt, self._opt_leaves = None, None
            self._replicas = zero.DataParallel(
                params, self.optimizer_config, stage=3 if fsdp else 1,
                leaves=leaves)
        return self._replicas

    def _record_overall_progress(self, last_batch):
        """Fold the run's progress into the overall average-cost history
        and, given ``last_batch`` ``(x, y)``, refresh ``/stats/`` from it
        (JAX ``_record_overall_progress``)."""
        if self.progress:
            avg_progress_cost = (sum(p["cost"] for p in self.progress)
                                 / len(self.progress))
            self.avg_cost = ((self.avg_cost or avg_progress_cost)
                             + avg_progress_cost) / 2.0
            self.avg_cost_history.append(self.avg_cost)
            if len(self.avg_cost_history) > 100:
                self.avg_cost_history.pop(random.randint(1, 98))
        if last_batch is not None:
            self.stats = self._compute_stats(*last_batch)

    def _compute_stats(self, x, y) -> dict:
        """The ``/stats/`` document of one (batch, length) micro-batch of
        token ids and targets (JAX ``_compute_stats``): the instrumented
        pass (``CompiledArch.stats_grads``), then the numpy histograms of
        utils/stats.py."""
        x, y = (torch.as_tensor(np.asarray(a, np.int64), device=self.device)
                for a in (x, y))
        acts, act_grads, weight_grads = self.arch.stats_grads(x, y)

        def host(ts):
            return [t.to("cpu", torch.float32).numpy() for t in ts]

        named = dict(self.arch.named_parameters())
        weights = host(named[k].detach() for k in self.arch.param_order)
        return stats_lib.build_stats(self.arch.algos, host(acts),
                                     host(act_grads), weights,
                                     host(weight_grads))

    @classmethod
    def train_model_on_device(cls, model_id, device, dataset_id, shard,
                              epochs, batch_size, block_size, step_size,
                              adapter=None):
        """Load the checkpoint onto ``device`` (``cuda`` unless ``"cpu"``)
        and train it (JAX ``train_model_on_device``).  With
        ``PENROZ_TRAIN_WORKER=1`` the run goes to a child process instead
        (:meth:`_train_in_worker_process`), on one process only: over
        several ranks each rank trains in process, as in the JAX
        package."""
        unported_training_options()
        # over several ranks each trains in process, as in the JAX package
        if (os.environ.get(TRAIN_WORKER_ENV, "0") == "1"
                and dist.process_count() == 1):
            return cls._train_in_worker_process(
                model_id, device, dataset_id, shard, epochs, batch_size,
                block_size, step_size, adapter=adapter)
        model = cls.deserialize(model_id, device=device)
        if adapter is not None:
            # the base stays frozen; the checkpoint written is the
            # adapter's alone (models/lora.py)
            from penroz_tpu_torch.models import lora
            lora.train_adapter(model, adapter["adapter_id"], adapter,
                               dataset_id, shard=shard, epochs=epochs,
                               batch_size=batch_size, block_size=block_size,
                               step_size=step_size)
            return model
        model.train_model(dataset_id, shard=shard, epochs=epochs,
                          batch_size=batch_size, block_size=block_size,
                          step_size=step_size)
        return model

    @classmethod
    def _train_in_worker_process(cls, model_id, device, dataset_id, shard,
                                 epochs, batch_size, block_size, step_size,
                                 adapter=None):
        """Train in a child process (``python -m
        penroz_tpu_torch.models.train_worker``) and contain its crashes
        (JAX ``_train_in_worker_process``).  The caller's thread waits for
        the child; the state flows through the checkpoint the child writes
        (every ~10 s and at the end), so ``/progress/`` follows the run and
        the server keeps serving (on the card the child holds its own CUDA
        context).  The child gets the parent's device string, shm directory
        and a ``PYTHONPATH`` that finds this package from the parent's
        working directory.  A child that died mid-run leaves ``Training``
        in the checkpoint: it is rewritten to ``Error`` (the startup orphan
        sweep's contract, applied when the death is seen); a clean failure
        (status ``Error``, exit code 1) is logged."""
        import subprocess
        import sys
        args = {"model_id": model_id,
                "device": None if device is None else str(device),
                "dataset_id": dataset_id, "shard": shard, "epochs": epochs,
                "batch_size": batch_size, "block_size": block_size,
                "step_size": step_size, "adapter": adapter}
        env = dict(os.environ)
        env.pop(TRAIN_WORKER_ENV, None)   # the child trains in process
        env["PENROZ_SHM_PATH"] = checkpoint.SHM_PATH
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        prev = env.get("PYTHONPATH", "")
        env["PYTHONPATH"] = repo + (os.pathsep + prev if prev else "")
        proc = subprocess.Popen(
            [sys.executable, "-m", "penroz_tpu_torch.models.train_worker",
             json.dumps(args)], env=env, cwd=os.getcwd())
        _TRAIN_WORKERS[model_id] = proc
        try:
            rc = proc.wait()
        finally:
            _TRAIN_WORKERS.pop(model_id, None)
        if adapter is not None:
            cls._post_mortem_adapter_worker(adapter["adapter_id"], rc)
            return cls.deserialize(model_id, device=device, optimizer=False)
        meta = checkpoint.peek_tree(model_id)
        code = (meta.get("status") or {}).get("code")
        if rc != 0 and code == "Training":
            log.error("Training worker for model %s died (rc=%s); marking "
                      "Error", model_id, rc)
            checkpoint.patch_meta(model_id, {"status": {
                "code": "Error",
                "message": f"Training worker died (rc={rc}); last "
                           f"checkpoint retained"}})
        elif rc != 0:
            log.error("Training worker for model %s exited rc=%s "
                      "(status %s)", model_id, rc, code)
        return cls.deserialize(model_id, device=device, optimizer=False)

    @staticmethod
    def _post_mortem_adapter_worker(adapter_id: str, rc: int):
        """The adapter run's post-mortem: a worker that died mid-run leaves
        the adapter checkpoint at ``Training``, rewritten to ``Error``; a
        clean failure is logged."""
        try:
            blob = checkpoint.load_adapter(adapter_id)
        except KeyError:
            if rc != 0:
                log.error("Adapter-training worker for %s died (rc=%s) "
                          "before writing any checkpoint", adapter_id, rc)
            return
        code = (blob.get("status") or {}).get("code")
        if rc != 0 and code == "Training":
            log.error("Adapter-training worker for %s died (rc=%s); "
                      "marking Error", adapter_id, rc)
            blob["status"] = {
                "code": "Error",
                "message": f"Training worker died (rc={rc}); last "
                           f"checkpoint retained"}
            checkpoint.save_adapter(adapter_id, blob, sync_flush=True)
        elif rc != 0:
            log.error("Adapter-training worker for %s exited rc=%s "
                      "(status %s)", adapter_id, rc, code)

    # -- generation ---------------------------------------------------------

    def _sampling_setup(self, temperature):
        """(greedy, temp): None/0.0 temperature means greedy; a falsy
        temperature maps the scalar to 1.0."""
        greedy = temperature is None or float(temperature) == 0.0
        temp = float(temperature) if temperature else 1.0
        return greedy, temp

    @staticmethod
    def _prompt_tokens(input) -> list[int]:
        row = input[0] if input and isinstance(input[0], (list, tuple)) \
            else input
        return [int(t) for t in row]

    @torch.inference_mode()
    def _generate_iter(self, context: list[int], block_size: int,
                       max_new_tokens: int, temperature: float,
                       top_k: Optional[int], ramp: bool = False):
        """Yield new tokens one at a time, appending each to ``context``
        (JAX ``_generate_iter``).

        Chunked, pipelined decode through a process-wide runner
        (models/decode_graphs.py; CUDA graphs on the card): one (re)prefill
        dispatch, then up to ``PENROZ_DECODE_CHUNK`` decode-and-sample
        steps a dispatch.  The next chunk is dispatched before the previous
        chunk's tokens are read (an async copy to pinned memory and an
        event); the last sampled token stays on the device as the next
        chunk's input, and a chunk dispatched past a ``stop_token`` is
        abandoned.  When the cache holds ``block_size`` entries the
        context is cropped to ``context[-block_size:]`` and prefilled again
        (the reference's overflow path); that needs the host context, so
        the pipeline drains there.  A chunk is the power-of-two ceiling of
        the tokens still wanted, clipped by the budget, by the room left in
        the block and, with ``ramp`` (streaming), by a budget that starts
        at 8 and doubles each dispatch; the overshoot is discarded.
        Positions stay below ``block_size``, which the callers checked
        against the position table (:meth:`_check_generation`)."""
        greedy, temp = self._sampling_setup(temperature)
        chunk_budget = _chunk_budget()
        ramp_budget = 8 if ramp else chunk_budget
        seed = None if greedy else torch.randint(
            0, 2 ** 31 - 1, (), generator=self._generator,
            device=self.device)
        with decode_graphs.runner(self.arch, self.dtype, block_size, greedy,
                                  top_k, self.device,
                                  adapter=self.adapter) as runner:
            runner.start(self.arch, seed, temp, adapter=self.adapter)
            cache_len = 0
            produced = 0    # tokens yielded to the caller
            dispatched = 0  # tokens sampled on the device (a chunk ahead)
            pending = None  # (host tokens, event, count) to read

            def flush(entry):
                nonlocal produced
                host, event, count = entry
                if event is not None:
                    with decode_priority():
                        event.synchronize()
                for tok in host[0, :count].tolist():
                    context.append(tok)
                    produced += 1
                    yield tok
                    if produced >= max_new_tokens:
                        return

            while produced < max_new_tokens:
                new_pending = None
                if dispatched < max_new_tokens:
                    at_boundary = cache_len == 0 or cache_len >= block_size
                    if at_boundary and pending is not None:
                        # the re-prefill reads the host context: drain first
                        yield from flush(pending)
                        pending = None
                        if produced >= max_new_tokens:
                            break
                    if at_boundary:
                        feed = context[-block_size:]
                        with decode_priority():
                            toks = runner.prefill(feed,
                                                  len(context) - len(feed))
                        cache_len, count = len(feed), 1
                    else:
                        room = block_size - cache_len
                        remaining = max_new_tokens - dispatched
                        chunk = _decode_chunk_size(
                            remaining, min(chunk_budget, ramp_budget, room))
                        count = min(chunk, remaining)
                        with decode_priority():
                            toks = runner.decode(chunk)
                        cache_len += chunk
                        ramp_budget = min(ramp_budget * 2, chunk_budget)
                    new_pending = (*runner.to_host(toks), count)
                    dispatched += count
                # reading the previous chunk overlaps the one just queued
                if pending is not None:
                    yield from flush(pending)
                pending = new_pending
            if pending is not None and produced < max_new_tokens:
                yield from flush(pending)

    def _check_generation(self, context: list[int], block_size: int):
        """Refuse, before any token, a request generation cannot serve: no
        prompt, ``block_size`` < 1, or a ``block_size`` past the learned
        position table (ValueError, HTTP 400)."""
        if not context:
            raise ValueError("generation needs at least one prompt token")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.arch.check_positions(block_size, "block_size")

    def generate_tokens(self, input, block_size, max_new_tokens,
                        temperature=1.0, top_k=None, stop_token=None):
        """Autoregressive generation; returns prompt + generated ids (the
        stop token, when hit, included)."""
        context = self._prompt_tokens(input)
        self._check_generation(context, block_size)
        with contextlib.closing(self._generate_iter(
                context, block_size, max_new_tokens, temperature,
                top_k)) as tokens:
            for tok in tokens:
                if stop_token is not None and tok == stop_token:
                    break
        return context

    def generate_tokens_stream(self, input, block_size, max_new_tokens,
                               temperature=1.0, top_k=None, stop_token=None):
        """Streaming variant: checks the request at once (see
        :meth:`_check_generation`), then returns an iterator of the new
        tokens (chunks ramp up from 8 steps, so the first tokens come
        early)."""
        context = self._prompt_tokens(input)
        self._check_generation(context, block_size)
        return self._stream_tokens(context, block_size, max_new_tokens,
                                   temperature, top_k, stop_token)

    def _stream_tokens(self, context, block_size, max_new_tokens,
                       temperature, top_k, stop_token):
        with contextlib.closing(self._generate_iter(
                context, block_size, max_new_tokens, temperature, top_k,
                ramp=True)) as tokens:
            for tok in tokens:
                yield tok
                if stop_token is not None and tok == stop_token:
                    return

    @torch.inference_mode()
    def decode_mixed_step(self, kv, descs, tok_lit, tok_src, positions,
                          sample_slot, last_tokens, seed: int = 0,
                          temperature=1.0, top_k=None, row_ids=None,
                          verify_slots=None, lora=None, lora_slots=None):
        """Run ``n`` unified RAGGED steps over the paged pool ``kv`` — the
        continuous-batching scheduler's block (JAX ``decode_mixed_step``):
        every step is one packed mixed batch in which prefill chunks and
        decode steps share one forward, appends scatter through the block
        table and every attention layer launches the ragged kernel once.

        The host plans the whole block (serve/decode_scheduler.py
        ``_plan_mixed``):

        - ``descs`` (n, NB, 4) int32 descriptors per step
          (ops/kv_cache.py::build_descriptors);
        - ``tok_lit``/``tok_src`` (n, Tp): slot p feeds
          ``last[tok_src]`` when ``tok_src >= 0`` (a decode step continues
          its row's last token) else the literal (prompt tokens);
        - ``positions`` (n, Tp) absolute position per packed slot;
        - ``sample_slot`` (n, B): the slot whose sample becomes row b's
          carried last token after that step (-1 keeps it);
        - ``verify_slots`` (n, V), optional: the slots of speculative
          verify spans (-1 padding), sampled besides ``sample_slot``'s
          and carried nowhere — the host compares them with the draft;
        - ``row_ids`` (n, Tp): row per slot (-1 padding), the positional
          sampling keys of temperature > 0: a slot at (row, position)
          draws what a plain decode step at that position would;
        - ``lora`` (models/lora.py ``build_pack``, on the device) and
          ``lora_slots`` (n, Tp): each packed token's adapter slot (the
          pack's last, all-zero slot for base rows and padding).

        Only the ``sample_slot`` and ``verify_slots`` slots are sampled.

        The JAX ``lax.scan`` becomes a loop of ``n`` forwards; the plan
        goes to the device in one copy, the carried last tokens stay
        there, and the (n, Tp) samples come back in one read at the end —
        nothing in the loop reads the device.  Returns ``(samples (n, Tp)
        int numpy, -1 at every slot no row samples, kv)``; the caller
        replays emissions and keeps the host lengths authoritative."""
        greedy, temp = self._sampling_setup(temperature)
        descs = np.asarray(descs, np.int32)
        n, NB = descs.shape[0], descs.shape[1]
        tok_lit = np.asarray(tok_lit, np.int64)
        Tp = tok_lit.shape[1]
        if Tp % NB != 0:
            raise ValueError(f"packed length {Tp} must be a multiple of "
                             f"the descriptor count {NB}")
        block_q = Tp // NB
        positions = np.asarray(positions, np.int64).reshape(n, Tp)
        limit = self.arch.max_positions
        if limit is not None and int(positions.max()) >= limit:
            raise ValueError(f"positions up to {int(positions.max())} exceed "
                             f"the model's {limit} position embeddings")
        B = kv.batch
        if row_ids is None:
            row_ids = np.full((n, Tp), -1, np.int64)
        V = 0 if verify_slots is None else int(np.shape(verify_slots)[1])
        parts = [descs, tok_lit, tok_src, positions, sample_slot, row_ids,
                 last_tokens]
        if V:
            parts.append(verify_slots)
        L = int(lora is not None)
        if L:
            parts.append(lora_slots)
        for s in range(n):  # scatter index of every step, from the host table
            parts += kv.packed_index(kv.packed_rows(descs[s], block_q))
        sizes = [int(np.size(a)) for a in parts]
        buf = torch.from_numpy(np.concatenate(
            [np.asarray(a, np.int64).reshape(-1) for a in parts]))
        if self.device.type == "cuda":
            buf = buf.pin_memory()
        dev = buf.to(self.device, non_blocking=True)
        views = list(torch.split(dev, sizes))
        d_descs = views[0].view(n, NB, 4).to(torch.int32)
        d_lit, d_src, d_pos, d_rid = (views[i].view(n, Tp)
                                      for i in (1, 2, 3, 5))
        d_sslot = views[4].view(n, B)
        last = views[6]
        d_vslot = views[7].view(n, V) if V else None
        d_lslot = views[7 + bool(V)].view(n, Tp) if L else None
        d_scatter = views[7 + bool(V) + L:]
        outs = []
        for s in range(n):
            src = d_src[s]
            toks = torch.where(src >= 0, last[torch.clamp(src, min=0)],
                               d_lit[s])
            acts, _, _ = self.arch(
                toks[None, :], kv=kv, skip_softmax=True,
                pos_offset=d_pos[s][None, :], ragged_descs=d_descs[s],
                ragged_rows=(d_scatter[2 * s], d_scatter[2 * s + 1]),
                lora=lora, lora_idx=d_lslot[s][None, :] if L else None)
            sslot = d_sslot[s]
            slots = sslot if not V else torch.cat([sslot, d_vslot[s]])
            at = torch.clamp(slots, min=0)
            logits = acts[-1][0][at]                    # (B [+ V], vocab)
            if greedy:
                picked = torch.argmax(logits.to(torch.float32), dim=-1)
            else:  # keys (row, position) of the sampled slots themselves
                picked = self.arch._sample_packed(logits, seed, d_rid[s][at],
                                                  d_pos[s][at], temp, top_k)
            last = torch.where(sslot >= 0, picked[:B], last)
            # the samples back at their slots; slot Tp sinks the -1s
            out = torch.full((Tp + 1,), -1, dtype=torch.int64,
                             device=picked.device)
            out.scatter_(0, torch.where(slots >= 0, slots, Tp), picked)
            outs.append(out[:Tp])
        return torch.stack(outs).to("cpu").numpy(), kv

    # -- step-wise decode (the phased scheduler, legacy batches) ------------

    def _bound_adapter(self):
        """The bound adapter's factors for a forward (``Ctx.adapter``), or
        None (models/lora.py ``bind_model``)."""
        if self.adapter is None:
            return None
        from penroz_tpu_torch.models import lora
        return lora.bind(*self.adapter, self.device)

    def _pick(self, logits, seed, row_ids, positions, greedy, temp, top_k):
        """Tokens of (N, V) logits: the fp32 argmax, or the positional draw
        of each (row, position) (:meth:`CompiledArch._sample_packed`), the
        unified block's keys, so a stream does not depend on the tick form
        that sampled it."""
        if greedy:
            return torch.argmax(logits.to(torch.float32), dim=-1)
        return self.arch._sample_packed(logits, seed, row_ids, positions,
                                        temp, top_k)

    def _dev(self, values, dtype=torch.int64):
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(
            self.device)

    def _row_span(self, kv, row, tokens, row_len, seed, temperature, top_k,
                  lora, adapter_slot, sample_all: bool):
        """One forward of ``tokens`` for row ``row`` against its batch-1
        view (``row_view``) at valid length ``row_len``, merged back; the
        samples of its last position, or of every position."""
        greedy, temp = self._sampling_setup(temperature)
        T = len(tokens)
        view = kv.row_view(row, row_len)
        x = self._dev([tokens])
        lora_idx = (self._dev([adapter_slot]) if lora is not None else None)
        acts, _, _ = self.arch(x, kv=view, skip_softmax=True,
                               adapter=self._bound_adapter(), lora=lora,
                               lora_idx=lora_idx)
        logits = acts[-1][0] if sample_all else acts[-1][0, -1:]
        first = 0 if sample_all else T - 1
        positions = torch.arange(row_len + first, row_len + T,
                                 device=self.device)
        out = self._pick(logits, seed, torch.full_like(positions, int(row)),
                         positions, greedy, temp, top_k)
        kv.merge_row(row, view)
        return out.tolist()

    @torch.inference_mode()
    def decode_prefill_chunk(self, kv_batch, row: int, tokens, row_len: int,
                             seed: int = 0, temperature=1.0, top_k=None,
                             lora=None, adapter_slot: int = 0):
        """Feed one prompt chunk of row ``row`` into the multi-row state at
        positions ``row_len + [0, T)`` (JAX ``decode_prefill_chunk``): the
        chunk attends the row's cache, prefix-aliased pages included,
        through the cached-attention kernel of its cache, and appends in
        place through ``row_view``.  Returns ``(token, kv_batch)``: the
        sample at the chunk's last position (the request's first token
        when this is its last chunk)."""
        out = self._row_span(kv_batch, row, tokens, row_len, seed,
                             temperature, top_k, lora, adapter_slot, False)
        return int(out[0]), kv_batch

    @torch.inference_mode()
    def decode_verify_row(self, kv_batch, row: int, tokens, row_len: int,
                          seed: int = 0, temperature=1.0, top_k=None,
                          lora=None, adapter_slot: int = 0):
        """Speculative verify of one row (JAX ``decode_verify_row``): one
        forward over its T candidates (the last sampled token, then the
        draft) at ``row_len + [0, T)``, sampled at every position.  Returns
        ``(T tokens, kv_batch)``; the caller rolls the rejected positions
        back (``rollback_row``)."""
        return self._row_span(kv_batch, row, tokens, row_len, seed,
                              temperature, top_k, lora, adapter_slot,
                              True), kv_batch

    def _batched_step(self, kv, tok, lens, seed, greedy, temp, top_k,
                      lora=None, lora_idx=None, active=None):
        """One shared decode step on the device: every row feeds ``tok``
        (B, 1) at its own length ``lens`` (B,) int64 (written through
        device positions, no host read); returns the (B,) samples.
        ``active`` ((B,) bool tensor or None for all): the rows whose
        recurrent state takes the token (a parked row's is left as it
        is; its K/V write is never attended)."""
        B = tok.shape[0]
        kv.at_positions(KV.row_positions(lens, 1, kv.max_len))
        try:
            acts, _, _ = self.arch(tok, kv=kv, skip_softmax=True,
                                   pos_offset=lens[:, None],
                                   adapter=self._bound_adapter(), lora=lora,
                                   lora_idx=lora_idx,
                                   ssm_count=(None if active is None
                                              else active.to(torch.int64)))
        finally:
            kv.at_positions(None)
        return self._pick(acts[-1][:, -1], seed,
                          torch.arange(B, device=tok.device), lens, greedy,
                          temp, top_k)

    @torch.inference_mode()
    def decode_step_batched(self, kv, last_tokens, lengths, seed: int = 0,
                            temperature=1.0, top_k=None, lora=None,
                            row_adapter=None, active=None):
        """One shared decode+sample step over every row of a multi-row
        state (JAX ``decode_step_batched``): row b feeds its last token at
        the host's authoritative length ``lengths[b]`` (0 parks a free
        row: its write lands at position 0 of its own row, never
        attended).  Every attention layer launches its cache's decode
        kernel once with the (B,) lengths.  ``active`` ((B,) bool, None
        for every row): the rows that really decode; the others' recurrent
        states are left as they are (a row mid-prefill, a verified row,
        a free row).  Returns ``((B,) int numpy tokens, kv)`` with the
        lengths installed one further."""
        greedy, temp = self._sampling_setup(temperature)
        lengths = np.asarray(lengths, np.int64).reshape(-1)
        tok = self._dev(np.asarray(last_tokens).reshape(-1, 1))
        lora_idx = (self._dev(row_adapter) if lora is not None else None)
        act = (None if active is None or kv.ssm is None
               else self._dev(np.asarray(active, bool), torch.bool))
        out = self._batched_step(kv, tok, self._dev(lengths), seed, greedy,
                                 temp, top_k, lora, lora_idx, act)
        kv.with_lengths(np.minimum(lengths + 1, kv.max_len))
        return out.cpu().numpy(), kv

    @torch.inference_mode()
    def decode_superstep(self, kv, last_tokens, lengths, active, stop_tokens,
                         remaining, seed: int, n: int, temperature=1.0,
                         top_k=None, lora=None, row_adapter=None):
        """Up to ``n`` shared decode steps in one launch sequence (JAX
        ``decode_superstep``'s ``lax.scan``): the carry (last tokens,
        lengths, the active mask, tokens done) stays on the device; a row
        leaves the mask on its stop token (``stop_tokens``, -1 for none),
        its budget (``remaining``) or a full cache, and then computes and
        discards like a parked row.  No host read inside; one at the end.
        Returns ``(toks (n, B) numpy, -1 where masked, emitted (n, B)
        bool numpy, final lengths (B,) numpy, kv)``."""
        greedy, temp = self._sampling_setup(temperature)
        max_len = kv.max_len
        tok = self._dev(np.asarray(last_tokens).reshape(-1, 1))
        lens = self._dev(np.asarray(lengths).reshape(-1))
        act = self._dev(np.asarray(active, bool), torch.bool)
        stop = self._dev(stop_tokens)
        rem = self._dev(remaining)
        done = torch.zeros_like(lens)
        lora_idx = (self._dev(row_adapter) if lora is not None else None)
        toks, emitted = [], []
        for _ in range(int(n)):
            # a masked row computes and discards, its recurrent state kept
            t = self._batched_step(kv, tok, lens, seed, greedy, temp, top_k,
                                   lora, lora_idx,
                                   act if kv.ssm is not None else None)
            toks.append(torch.where(act, t, -1))
            emitted.append(act)
            tok = torch.where(act, t, tok[:, 0])[:, None]
            lens = lens + act
            done = done + act
            act = act & (t != stop) & (done < rem) & (lens < max_len)
        host = torch.cat([torch.stack(toks).reshape(-1),
                          torch.stack(emitted).reshape(-1).to(torch.int64),
                          lens]).cpu().numpy()
        B = lens.shape[0]
        k = int(n) * B
        final = host[2 * k:]
        kv.with_lengths(final)
        return (host[:k].reshape(int(n), B),
                host[k:2 * k].reshape(int(n), B).astype(bool), final, kv)

    @torch.inference_mode()
    def generate_tokens_batched(self, inputs, block_size, max_new_tokens,
                                temperature=1.0, top_k=None,
                                stop_token=None) -> list[list[int]]:
        """Ragged batched generation (JAX ``generate_tokens_batched``): a
        right-padded batched prefill (each row samples at its own last
        prompt position), then decode steps in which every row appends,
        rotates and attends at its own length (``with_lengths``) on any
        cache (contiguous or paged, fp32 or int8), in chunks of up to
        ``PENROZ_DECODE_CHUNK`` steps read back at once (ramping from 8
        with a ``stop_token``).  Rows stop at their stop token (kept).
        Needs ``max(prompt) + max_new_tokens <= block_size``.  A model
        with ``ssm`` layers feeds each row's recurrent state its own
        prompt only (``ssm_count``): a pad token leaves the state and its
        ring untouched, so each row's greedy tokens are its own
        single-sequence tokens.  (The JAX package's padded prefill runs
        the recurrence over the pads too, so on prompts of unequal length
        its shorter rows leave their own single-sequence tokens: a
        deliberate divergence, ROADMAP Queue 3.)"""
        prompts = [[int(t) for t in (row if isinstance(row, (list, tuple))
                                     else [row])] for row in inputs]
        validate_batch_generation(prompts, block_size, max_new_tokens)
        self._check_generation(prompts[0], block_size)
        outs = [list(p) for p in prompts]
        if max_new_tokens <= 0:
            return outs
        B = len(prompts)
        lens = np.asarray([len(p) for p in prompts], np.int64)
        max_p = int(lens.max())
        greedy, temp = self._sampling_setup(temperature)
        seed = None if greedy else int(torch.randint(
            0, 2 ** 31 - 1, (), generator=self._generator,
            device=self.device))
        padded = np.zeros((B, max_p), np.int64)
        for i, p in enumerate(prompts):
            padded[i, :len(p)] = p
        kv = KV.create_kv_state(self.arch.kv_specs, B, block_size, self.dtype,
                                device=self.device,
                                ssm_specs=self.arch.ssm_specs)
        with decode_priority():
            acts, _, _ = self.arch(self._dev(padded), kv=kv,
                                   skip_softmax=True,
                                   adapter=self._bound_adapter(),
                                   ssm_count=(self._dev(lens)
                                              if kv.ssm is not None
                                              else None))
            rows = torch.arange(B, device=self.device)
            last_pos = self._dev(lens - 1)
            tok = self._pick(acts[-1][rows, last_pos], seed, rows, last_pos,
                             greedy, temp, top_k)
            first = tok.tolist()
        kv.with_lengths(lens)
        kv.reserve(max_p + max_new_tokens)
        done = [False] * B

        def absorb(column):
            for i, t in enumerate(column):
                if not done[i]:
                    outs[i].append(int(t))
                    done[i] = stop_token is not None and int(t) == stop_token

        absorb(first)
        chunk_budget = _chunk_budget()
        ramp_budget = 8 if stop_token is not None else chunk_budget
        dev_lens = self._dev(lens)
        dispatched = 1
        while dispatched < max_new_tokens and not all(done):
            remaining = max_new_tokens - dispatched
            room = block_size - max_p - dispatched
            chunk = _decode_chunk_size(
                remaining, min(chunk_budget, ramp_budget, room))
            count = min(chunk, remaining)
            ramp_budget = min(ramp_budget * 2, chunk_budget)
            steps = []
            with decode_priority():
                for _ in range(chunk):
                    tok = self._batched_step(kv, tok[:, None], dev_lens,
                                             seed, greedy, temp, top_k)
                    dev_lens = dev_lens + 1
                    steps.append(tok)
                columns = torch.stack(steps)[:count].tolist()
            for column in columns:
                absorb(column)
                if all(done):
                    break
            dispatched += count
        return outs

    def serve_pipeline(self, stages: int) -> ServePipeline:
        """The serving stage partition of this model (ValueError when it
        has fewer repeated blocks than ``stages``, a stage would own no
        attention layer, or it has ``ssm`` layers)."""
        return ServePipeline(self.arch, stages)

    @torch.inference_mode()
    def decode_pipe_stage(self, pipe: ServePipeline, s: int, kv_stage, x,
                          descs, positions, row_ids, seed: int = 0,
                          temperature=1.0, top_k=None, slots=None):
        """One pipeline stage of one unified ragged step over one
        micro-block (JAX ``decode_pipe_stage``): stage 0 takes the packed
        tokens ``x`` (Tp,) (the host resolved ``tok_src``), later stages
        the previous stage's hidden states (1, Tp, D) on the device.  Each
        attention layer appends into ``kv_stage``
        (ops/kv_cache.py::stage_kv_view) and launches the ragged kernel
        over its slice of the pools.  A middle stage returns its hidden
        states; the last returns the (Tp,) int numpy samples at
        ``slots`` (every slot when None; -1 elsewhere): the greedy argmax
        or the positional draw of :meth:`decode_mixed_step`, so piped
        streams equal unpiped ones.  Returns ``(out, kv_stage)``."""
        greedy, temp = self._sampling_setup(temperature)
        descs = np.asarray(descs, np.int32)
        NB = descs.shape[0]
        positions = np.asarray(positions, np.int64).reshape(-1)
        Tp = positions.shape[0]
        if Tp % NB != 0:
            raise ValueError(f"packed length {Tp} must be a multiple of "
                             f"the descriptor count {NB}")
        limit = self.arch.max_positions
        if limit is not None and int(positions.max()) >= limit:
            raise ValueError(f"positions up to {int(positions.max())} exceed "
                             f"the model's {limit} position embeddings")
        lo = pipe.kv_bounds[s][0]
        index = kv_stage.packed_index(kv_stage.packed_rows(descs, Tp // NB))
        d_pos = self._dev(positions)
        h = self._dev(np.asarray(x).reshape(1, Tp)) if s == 0 else x
        ctx = M.Ctx(kv=kv_stage, pos_offset=d_pos[None, :],
                    ragged_descs=self._dev(descs, torch.int32),
                    ragged_rows=tuple(self._dev(a) for a in index),
                    kv_base=lo)
        for mod in pipe.modules[s]:
            if not isinstance(mod, M.Softmax):
                h = mod(h, ctx)
        if s < pipe.stages - 1:
            return h, kv_stage
        at = (torch.arange(Tp, device=self.device) if slots is None
              else self._dev(slots))
        picked = self._pick(h[0][at], seed,
                            torch.clamp(self._dev(row_ids), min=0)[at],
                            d_pos[at], greedy, temp, top_k)
        out = torch.full((Tp,), -1, dtype=torch.int64, device=self.device)
        out[at] = picked
        return out.cpu().numpy(), kv_stage

    # -- persistence --------------------------------------------------------

    def serialize(self, sync_flush: bool = False, tag=None):
        """Checkpoint to shm + the durable dir, with the optimizer state as
        the JAX package's optax leaves (models/convert.py), so either
        package loads and continues it.

        A state sharded over ranks (``PENROZ_WUS``, ``PENROZ_FSDP``) is
        written as the JAX package writes it: every rank its pieces to its
        shard file (utils/checkpoint.py ``save_shard``), the master the
        blob with the rest, the pieces' ``sharded`` shapes and dtypes, and
        ``tag`` (the training step, the same on every rank) in both, so a
        load refuses pieces of different steps.  An untagged call on a
        sharded state (not made by every rank together) rewrites only the
        master's metadata (:meth:`_serialize_meta_only`)."""
        replicas = self._replicas
        sharded: dict = {}
        if replicas is not None and replicas.stage:
            if replicas.sharded:
                if tag is None:
                    if dist.master_proc():
                        self._serialize_meta_only()
                    return
                pieces, sharded = replicas.shard_pieces()
                checkpoint.save_shard(
                    self.model_id, dist.process_index(),
                    {"tag": tag, "pieces": pieces}, sync_flush=sync_flush,
                    world=dist.process_count())
                if not dist.master_proc():
                    return
            params = replicas.blob_params()
            opt_leaves = replicas.blob_opt_leaves()
        else:
            params = {k: v.detach().to("cpu")
                      for k, v in self.arch.named_parameters()}
            opt_leaves = self._opt_state_leaves()
        checkpoint.save(self.model_id, {
            "layers": self.layers_dsl,
            "optimizer": self.optimizer_config,
            "params": params,
            "buffers": {k: v.detach().to("cpu")
                        for k, v in self.arch.named_buffers()},
            "opt_state_leaves": opt_leaves,
            "sharded": sharded,
            "shard_tag": tag,
            "progress": self.progress,
            "avg_cost": self.avg_cost,
            "avg_cost_history": self.avg_cost_history,
            "stats": self.stats,
            "status": self.status,
        }, sync_flush=sync_flush)

    def _serialize_meta_only(self):
        """Rewrite progress and status in the existing blob, the weights
        and the shard files untouched (JAX ``_serialize_meta_only``)."""
        try:
            checkpoint.patch_meta(self.model_id, {
                "progress": self.progress,
                "avg_cost": self.avg_cost,
                "avg_cost_history": self.avg_cost_history,
                "stats": self.stats,
                "status": self.status,
            })
        except KeyError:
            log.warning("Meta-only checkpoint skipped: no existing blob "
                        "for %s", self.model_id)

    @staticmethod
    def _reassemble_sharded(model_id: str, sharded_meta: dict,
                            expected_tag=None) -> dict:
        """Full CPU tensors of ``sharded_meta``'s names from every rank's
        shard file (JAX ``_reassemble_sharded``, its messages too): a shard
        file of another step than the blob, or pieces that do not cover an
        array, raise RuntimeError."""
        names = set(sharded_meta)
        shards = []
        for i, payload in enumerate(checkpoint.load_shards(
                model_id, pieces=names.__contains__)):
            if payload.get("tag") != expected_tag:
                raise RuntimeError(
                    f"Sharded checkpoint for {model_id} is torn: shard file "
                    f"#{i} is from step {payload.get('tag')!r} but the "
                    f"metadata blob is from step {expected_tag!r}")
            shards.append(payload["pieces"])
        out = {}
        for name, meta in sharded_meta.items():
            shape = tuple(meta["shape"])
            arr = torch.zeros(shape,
                              dtype=checkpoint.torch_dtype(meta["dtype"]))
            covered = 0
            for pieces in shards:
                for ranges, piece in pieces.get(name, []):
                    idx = tuple(slice(a, b) for a, b in ranges)
                    arr[idx] = piece
                    covered += piece.numel()
            total = int(np.prod(shape))
            if covered < total:
                raise RuntimeError(
                    f"Sharded checkpoint for {model_id} is incomplete: "
                    f"{name} has {covered}/{total} elements across "
                    f"{len(shards)} shard file(s) — all hosts' shard files "
                    f"must be visible to reassemble")
            out[name] = arr
        return out

    @classmethod
    def deserialize(cls, model_id: str, device=None,
                    optimizer: bool = True) -> "NeuralNetworkModel":
        """Load a checkpoint written by either package, keeping its dtypes;
        arrays sharded over ranks are reassembled from the shard files
        (:meth:`_reassemble_sharded`).  The optimizer leaves stay on the
        host until training builds the optimizer; ``optimizer=False``
        skips reading them (serving), and such a model refuses to
        serialize.  :raises KeyError: unknown model."""
        sections = None if optimizer else ("params", "buffers")
        data = checkpoint.load(model_id, arrays=sections)
        arrays = dict(data["params"])
        arrays.update(data.get("buffers") or {})
        leaves = data.get("opt_state_leaves") if optimizer else None
        if isinstance(leaves, list):
            leaves = dict(enumerate(leaves))
        sharded = {name: meta for name, meta in
                   (data.get("sharded") or {}).items()
                   if optimizer or not name.startswith("__opt__")}
        if sharded:
            leaves = dict(leaves or {})
            for name, arr in cls._reassemble_sharded(
                    model_id, sharded, data.get("shard_tag")).items():
                if name.startswith("__buf__"):
                    arrays[name[len("__buf__"):]] = arr
                elif name.startswith("__opt__"):
                    leaves[int(name[len("__opt__"):])] = arr
                else:
                    arrays[name] = arr
        model = from_jax_state_dict(arrays, data["layers"], data["optimizer"],
                                    model_id=model_id, device=device)
        model.progress = data.get("progress", [])
        model.avg_cost = data.get("avg_cost")
        model.avg_cost_history = data.get("avg_cost_history", [])
        model.stats = data.get("stats")
        model.status = data.get("status", {"code": "Created",
                                           "message": None})
        model._opt_leaves = leaves if optimizer else _NOT_LOADED
        return model

    # -- HuggingFace import -------------------------------------------------

    @classmethod
    def from_huggingface(cls, model_id: str, hf_repo_id: str,
                         revision: Optional[str] = None, device=None
                         ) -> "NeuralNetworkModel":
        """Import a local HuggingFace checkpoint directory (JAX
        ``from_huggingface``): its ``config.json`` read as transformers
        would (models/hf_config.py), its weights by the port's own
        safetensors reader (models/hf_loader.py), the family's DSL and key
        remap (models/hf_families.py), every mapped parameter cast to
        bf16, a fresh AdamW state, status ``Imported``, then a checkpoint
        either package loads.  The key set and the shapes must equal the
        DSL's (KeyError, ValueError).  ``revision`` names a hub revision
        and is unused: the port imports only from a local directory
        (ValueError otherwise)."""
        from penroz_tpu_torch.models import hf_config, hf_loader
        local_dir = hf_loader.resolve_checkpoint_dir(hf_repo_id, revision)
        config = hf_config.load(local_dir)
        sd = hf_loader.load_state_dict(local_dir)
        n_layer = Mapper.detect_hf_n_layer(sd)
        if not n_layer:
            cfg = getattr(config, "text_config", None) or config
            n_layer = int(getattr(cfg, "n_layer", 0)
                          or getattr(cfg, "num_hidden_layers", 0))
        layers = Mapper.from_hf_config(config, n_layer_override=n_layer)
        mapper = Mapper(layers, {"adamw": {"lr": 6e-4, "betas": [0.9, 0.95],
                                           "eps": 1e-8}})
        with torch.device("meta"):
            expected = {k: tuple(p.shape) for k, p in
                        CompiledArch(layers).named_parameters()}
        mapped = Mapper.map_hf_state_dict_to_custom(sd, n_layer, config)
        del sd
        if set(expected) != set(mapped):
            raise KeyError(f"HF state dict mismatch: missing "
                           f"{sorted(set(expected) - set(mapped))}, "
                           f"unexpected {sorted(set(mapped) - set(expected))}")
        for key, value in mapped.items():
            if tuple(value.shape) != expected[key]:
                raise ValueError(f"Shape mismatch for {key}: HF "
                                 f"{tuple(value.shape)} vs model "
                                 f"{expected[key]}")
        params = {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)
                                      ).to(torch.bfloat16)
                  for k, v in mapped.items()}
        del mapped
        model = cls(model_id, mapper, device=device, params=params)
        model.status = {"code": "Imported",
                        "message": f"Imported from {hf_repo_id}"}
        model.serialize()
        return model

    @classmethod
    def delete(cls, model_id: str):
        """Remove the checkpoint, and the idle decode runners: one may
        hold the model's weights."""
        checkpoint.delete(model_id)
        decode_graphs.drop_idle()
