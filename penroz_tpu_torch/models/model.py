"""Model runtime: the compiled architecture and the NeuralNetworkModel
facade (counterpart of penroz_tpu/models/model.py, serving slice).

- :class:`CompiledArch` — a layer DSL built into an ``nn.Module`` tree whose
  ``state_dict`` keys equal the JAX package's flat parameter keys, with the
  forward, the one-step decode (``_decode_step``) and sampling
  (``_sample``).
- :class:`NeuralNetworkModel` — create, ``state_dict``, serialize /
  deserialize / delete over the ``PENROZC1`` container, and generation
  (``generate_tokens``/``generate_tokens_stream`` over ``_generate_iter``).

The JAX package fuses up to 128 decode steps per dispatch with
``lax.scan`` over power-of-two chunks; eager PyTorch runs one step per
loop iteration.  The tokens are the same: the cache fills to
``block_size`` either way, and the overflow crop and re-prefill happen at
the same token.
"""

from __future__ import annotations

import logging
from typing import Optional

import torch
from torch import nn

from penroz_tpu_torch.device import resolve_device
from penroz_tpu_torch.models import dsl
from penroz_tpu_torch.models.convert import as_tensor, from_jax_state_dict
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops import modules as M
from penroz_tpu_torch.utils import checkpoint

log = logging.getLogger(__name__)


class CompiledArch(nn.Module):
    """A layer DSL built into modules under ``layers.{i}``."""

    def __init__(self, layers: list[dict]):
        super().__init__()
        self.layers_dsl = layers
        self.layers = nn.ModuleList(dsl.build_modules(layers))
        self.attn_layers: list[M.CausalSelfAttention] = []
        self._index_attention()

    def _index_attention(self):
        """Assign KV-cache slots and infer head dims from the preceding
        fused QKV projection."""

        def visit(mod):
            if isinstance(mod, M.CausalSelfAttention):
                mod.layer_idx = len(self.attn_layers)
                self.attn_layers.append(mod)
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

    def forward(self, tokens, *, kv=None, skip_softmax=False):
        """Full forward collecting every top-level activation; returns
        ``(activations, new_kv)`` with the cache advanced by the tokens
        fed (in place)."""
        ctx = M.Ctx(kv=kv)
        acts = []
        h = tokens
        for mod in self.layers:
            if skip_softmax and isinstance(mod, M.Softmax):
                continue
            h = mod(h, ctx)
            acts.append(h)
        new_kv = kv.advanced(tokens.shape[-1]) if kv is not None else None
        return acts, new_kv

    def _decode_step(self, tokens, kv, generator, temp, *, greedy, top_k):
        """Feed tokens through the stack with the KV cache and sample the
        next token on the device."""
        acts, new_kv = self.forward(tokens, kv=kv, skip_softmax=True)
        logits = acts[-1]
        if logits.ndim == 3:
            logits = logits[:, -1, :]
        tok = self._sample(logits, generator, temp, greedy=greedy,
                           top_k=top_k)
        return tok[:, None], new_kv

    @staticmethod
    def _sample(logits, generator, temp, *, greedy, top_k):
        """(B,) next tokens from (B, V) logits: argmax | top-k |
        categorical, with the temperature floored at 1e-6."""
        logits = logits.to(torch.float32)
        if greedy:
            return torch.argmax(logits, dim=-1)
        logits = logits / max(float(temp), 1e-6)
        if top_k is not None:
            vals, idx = torch.topk(logits, int(top_k), dim=-1)
            choice = torch.multinomial(torch.softmax(vals, dim=-1), 1,
                                       generator=generator)
            return torch.gather(idx, -1, choice)[..., 0]
        return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                 generator=generator)[..., 0]


class NeuralNetworkModel:
    """Model lifecycle facade: create, persist, generate."""

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
        self._generator = self._new_generator()

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
        """Install parameters from a flat ``{key: tensor | ndarray}`` dict
        (exact key set and shapes; dtypes are kept as given)."""
        expected = self.arch.state_dict()
        missing = sorted(set(expected) - set(arrays))
        extra = sorted(set(arrays) - set(expected))
        if missing or extra:
            raise ValueError(f"parameter keys differ from the DSL: missing "
                             f"{missing[:8]}, unexpected {extra[:8]}")
        tensors = {}
        for key, ref in expected.items():
            t = as_tensor(arrays[key])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"{key}: shape {tuple(t.shape)} != "
                                 f"{tuple(ref.shape)}")
            tensors[key] = t.to(self.device)
        self.arch.load_state_dict(tensors, strict=True, assign=True)
        return self

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
                       top_k: Optional[int]):
        """Yield new tokens one at a time, appending each to ``context``.

        Prefill the last ``block_size`` tokens of the context, then decode
        one token per step until the cache holds ``block_size`` entries;
        then crop the context to ``context[-block_size:]`` and prefill
        again (the JAX package's overflow path)."""
        if not context:
            raise ValueError("generation needs at least one prompt token")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        greedy, temp = self._sampling_setup(temperature)
        kv = KV.create_kv_state(self.arch.kv_specs, 1, block_size,
                                self.dtype, device=self.device)
        produced = 0
        last = None
        while produced < max_new_tokens:
            if kv.length == 0 or kv.length >= block_size:
                kv.reset()
                feed = context[-block_size:]
                x = torch.tensor([feed], dtype=torch.int64,
                                 device=self.device)
            else:
                x = last
            last, kv = self.arch._decode_step(x, kv, self._generator, temp,
                                              greedy=greedy, top_k=top_k)
            tok = int(last[0, 0])
            context.append(tok)
            produced += 1
            yield tok

    def generate_tokens(self, input, block_size, max_new_tokens,
                        temperature=1.0, top_k=None, stop_token=None):
        """Autoregressive generation; returns prompt + generated ids (the
        stop token, when hit, included)."""
        context = self._prompt_tokens(input)
        for tok in self._generate_iter(context, block_size, max_new_tokens,
                                       temperature, top_k):
            if stop_token is not None and tok == stop_token:
                break
        return context

    def generate_tokens_stream(self, input, block_size, max_new_tokens,
                               temperature=1.0, top_k=None, stop_token=None):
        """Streaming variant yielding each new token."""
        context = self._prompt_tokens(input)
        for tok in self._generate_iter(context, block_size, max_new_tokens,
                                       temperature, top_k):
            yield tok
            if stop_token is not None and tok == stop_token:
                return

    # -- persistence --------------------------------------------------------

    def serialize(self, sync_flush: bool = False):
        """Checkpoint to shm + the durable dir.  Optimizer state is not
        ported yet, so ``opt_state_leaves`` is empty (ROADMAP.md)."""
        checkpoint.save(self.model_id, {
            "layers": self.layers_dsl,
            "optimizer": self.optimizer_config,
            "params": self.state_dict(),
            "buffers": {},
            "opt_state_leaves": {},
            "sharded": {},
            "shard_tag": None,
            "progress": self.progress,
            "avg_cost": self.avg_cost,
            "avg_cost_history": self.avg_cost_history,
            "stats": self.stats,
            "status": self.status,
        }, sync_flush=sync_flush)

    @classmethod
    def deserialize(cls, model_id: str, device=None) -> "NeuralNetworkModel":
        """Load a checkpoint written by either package, keeping its dtypes.
        The JAX package's optax leaves are skipped until training is
        ported.  :raises KeyError: unknown model."""
        data = checkpoint.load(model_id)
        if data.get("sharded"):
            raise ValueError(f"model {model_id} has a cross-host sharded "
                             f"checkpoint, which the port cannot load yet")
        arrays = dict(data["params"])
        arrays.update(data.get("buffers") or {})
        model = from_jax_state_dict(arrays, data["layers"], data["optimizer"],
                                    model_id=model_id, device=device)
        model.progress = data.get("progress", [])
        model.avg_cost = data.get("avg_cost")
        model.avg_cost_history = data.get("avg_cost_history", [])
        model.stats = data.get("stats")
        model.status = data.get("status", {"code": "Created",
                                           "message": None})
        return model

    @classmethod
    def delete(cls, model_id: str):
        checkpoint.delete(model_id)
