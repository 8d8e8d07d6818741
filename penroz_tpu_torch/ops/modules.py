"""Layer modules for the JSON layer DSL (counterpart of
penroz_tpu/ops/modules.py).

Each module is a ``torch.nn.Module`` whose children register under their
position (``"0"``, ``"1"``, …) and whose parameters under the JAX
package's names, so ``state_dict()`` of the model's root module
(``layers.{i}.{child}…weight``) has the keys of the JAX package's
``Module.key``/``bind`` flat dict, key for key.  ``forward(x, ctx)`` takes a
:class:`Ctx` carrying the KV cache and the position offset; the caches
update in place (ops/kv_cache.py).

Ported: every algo of the JAX package's DSL, for inference and training.
BatchNorm1d's running statistics are registered buffers
(``running_mean``, ``running_var``, an int32 ``num_batches_tracked``) that
a training-mode forward updates in place, as the JAX package's
``ctx.buffer_updates`` do; so is ``MixtureOfExperts``' ``router_fraction``,
whose load-balance loss a training forward appends to ``ctx.aux_losses``.
``Linear`` adds a LoRA adapter's low-rank delta when the Ctx carries
factors for its prefix (models/lora.py): one bound adapter, or a
mixed-batch pack with each row's or packed token's slot.
``MixtureOfExperts`` runs on one device: its expert-parallel dispatch
goes with the meshes, which are not ported.  ``CausalSelfAttention`` has
the no-cache (flash), contiguous-cache, paged and ragged (packed mixed
batch) branches; sequence-parallel attention is still to be ported and
has no state that could reach it.  ``GatedSSM`` has the no-cache (chunked
kernel) and dense cached branches; its packed ragged branch belongs to
the scheduler's SSM rows, which are not ported (the scheduler refuses SSM
models).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from penroz_tpu_torch.ops import attention as attn_ops
from penroz_tpu_torch.ops import kv_cache as KV
from penroz_tpu_torch.ops import ssm as ssm_ops


class Ctx:
    """Per-call context threaded through module application: the KV cache,
    whose length is the position offset of the tokens fed, the training
    flag, and the ``torch.Generator`` (on the model's device) that dropout
    draws from in training mode.

    Ragged unified dispatch (paged caches only): ``ragged_descs`` is the
    (NB, 4) int32 descriptor tensor on the device (ops/kv_cache.py::
    build_descriptors) and ``ragged_rows`` the packed scatter index
    (PagedKVState.packed_index — computed once a step, shared by every
    layer).  When set, attention appends and attends through the packed
    path and ``pos_offset`` holds the (1, Tp) per-token absolute positions
    on the device.

    ``aux_losses`` collects the auxiliary training losses (the MoE load
    balance) that the model adds to its cost.

    LoRA (models/lora.py), read by every :class:`Linear`: ``adapter`` binds
    one adapter to the whole forward, ``{prefix: (A, B, scale)}``;
    ``lora`` is the mixed-batch pack ``{prefix: {a: (L+1, R, in), b: (L+1,
    out, R), scale: (L+1,)}}`` and ``lora_idx`` each row's slot ``(B,)``
    or each packed token's ``(B, T)`` (the last slot is all zero: a base
    row)."""

    def __init__(self, *, kv=None, training: bool = False,
                 generator: Optional[torch.Generator] = None,
                 pos_offset=None, ragged_descs=None, ragged_rows=None,
                 adapter=None, lora=None, lora_idx=None, kv_base: int = 0,
                 ssm_count=None):
        self.kv = kv  # ops.kv_cache.KVState or None
        # (B,) tokens each row feeds its recurrent state (the rest are
        # padding or a parked row's), or None for all of them
        self.ssm_count = ssm_count
        # the attention layer index of the cache's first layer list entry
        # (a serving pipeline stage's view holds layers [kv_base, ...))
        self.kv_base = int(kv_base)
        self.training = training
        self.generator = generator
        self.pos_offset = pos_offset
        self.ragged_descs = ragged_descs
        self.ragged_rows = ragged_rows
        self.adapter = adapter
        self.lora = lora
        self.lora_idx = lora_idx
        self._lora_onehot: dict = {}
        self.aux_losses: list[torch.Tensor] = []

    def lora_onehot(self, n_slots: int, lead) -> torch.Tensor:
        """``lead + (n_slots,)`` fp32 one-hot of each row's or token's
        slot (``lora_idx``, a row's broadcast over its tokens), built once
        a forward and shared by every projection; no host read."""
        key = (n_slots, tuple(lead))
        onehot = self._lora_onehot.get(key)
        if onehot is None:
            idx = self.lora_idx
            if idx.ndim == 1 and len(lead) == 2:
                idx = idx[:, None].expand(tuple(lead))
            onehot = (idx[..., None] == torch.arange(
                n_slots, device=idx.device)).to(torch.float32)
            self._lora_onehot[key] = onehot
        return onehot

    def offset(self):
        """Position offset of the tokens fed: the (1, Tp) per-token
        positions of a packed batch, else the cache length (0 without a
        cache)."""
        if self.pos_offset is not None:
            return self.pos_offset
        return self.kv.length if self.kv is not None else 0

    def require_generator(self) -> torch.Generator:
        if self.generator is None:
            raise ValueError("a torch.Generator is required (dropout in "
                             "training mode)")
        return self.generator

    def dropout_seed(self) -> torch.Tensor:
        """A fresh int32 seed in [0, 2^31 - 1) for the flash kernels' hash
        dropout, drawn on the generator's device (no host read)."""
        g = self.require_generator()
        return torch.randint(0, 2 ** 31 - 1, (), generator=g,
                             device=g.device, dtype=torch.int32)


class Module(nn.Module):
    """Base class for DSL layer modules."""

    def reset_parameters(self, generator: torch.Generator):
        """Torch-default initialization of own (non-child) parameters."""

    def forward(self, x, ctx: Ctx):
        raise NotImplementedError


def _uniform_(t, bound, generator):
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


# ---------------------------------------------------------------------------
# Leaf layers
# ---------------------------------------------------------------------------

class Embedding(Module):
    def __init__(self, num_embeddings: int, embedding_dim: int):
        super().__init__()
        self.num_embeddings = int(num_embeddings)
        self.embedding_dim = int(embedding_dim)
        self.weight = nn.Parameter(torch.empty(self.num_embeddings,
                                               self.embedding_dim))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.normal_(generator=generator)

    def forward(self, x, ctx):
        # F.embedding replaces the JAX package's _gather_rows, a TPU
        # scatter workaround with nothing to port.
        return F.embedding(x, self.weight)


class ScaledEmbedding(Embedding):
    """Embedding whose output is scaled by a constant (Gemma's sqrt(d)).
    The scale is rounded to the output's dtype first, as the JAX package's
    ``jnp.asarray(scale, out.dtype)`` does."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 scale: float = 1.0):
        super().__init__(num_embeddings, embedding_dim)
        self.scale = float(scale)

    def forward(self, x, ctx):
        out = super().forward(x, ctx)
        scale = float(torch.tensor(self.scale, dtype=out.dtype))
        return out * scale


class PositionEmbedding(Embedding):
    """Learned position embedding indexed from the context offset.  Device
    positions (a packed batch's, a captured decode step's) are not read
    back here: the model refuses a ``block_size`` or an input past the
    table before any token (``CompiledArch.check_positions``), so no live
    position passes it, and the clamp only keeps the gather inside the
    table.  (The JAX package's gather does not clamp: past the table it
    reads NaN.)"""

    def forward(self, x, ctx):
        num_positions = x.shape[-1]
        offset = ctx.offset()
        if isinstance(offset, torch.Tensor):
            return F.embedding(torch.clamp(offset,
                                           max=self.num_embeddings - 1),
                               self.weight)
        offset = int(offset)
        if offset + num_positions > self.num_embeddings:
            raise ValueError(f"positions up to {offset + num_positions - 1} "
                             f"exceed the model's {self.num_embeddings} "
                             f"position embeddings")
        positions = offset + torch.arange(num_positions,
                                          device=self.weight.device)
        return F.embedding(positions, self.weight)


class Linear(Module):
    """Dense layer storing weight as (out, in) for state-dict parity.
    ``prefix`` is its flat parameter key (``layers.2.0.1``), assigned by
    ``CompiledArch``: the LoRA factors of the Ctx are keyed by it."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True):
        super().__init__()
        self.in_features = int(in_features)
        self.out_features = int(out_features)
        self.use_bias = bool(bias)
        self.prefix = ""
        self.weight = nn.Parameter(torch.empty(self.out_features,
                                               self.in_features))
        self.bias = (nn.Parameter(torch.empty(self.out_features))
                     if self.use_bias else None)

    def reset_parameters(self, generator):
        bound = 1.0 / math.sqrt(self.in_features)
        _uniform_(self.weight, bound, generator)
        if self.bias is not None:
            _uniform_(self.bias, bound, generator)

    def forward(self, x, ctx):
        out = F.linear(x, self.weight, self.bias)
        if ctx.adapter is None and ctx.lora is None:
            return out
        return self._lora_delta(out, x, ctx)

    def _lora_delta(self, out, x, ctx):
        """``out + scale · (x Aᵀ) Bᵀ`` for this projection's factors (JAX
        ``Linear._maybe_lora``; the factors cast to ``x``'s dtype, the
        scale to ``out``'s).  Stacked factors are not gathered per row or
        token (the JAX package's per-token gather is ``(B, T, out, R)``,
        0.8 GB for a 256-token chunk through GPT-2's head): one product
        against every slot's A, each token's slot kept and scaled by its
        one-hot row times the slots' scales (the other slots' columns
        zeroed), one product against every slot's B (the pack holds B as a
        view of its ``(L+1, R, out)`` storage, so this is a view too);
        five launches a projection, static shapes, no host read."""
        if ctx.adapter is not None:
            ent = ctx.adapter.get(self.prefix)
            if ent is None:
                return out
            a, b, s = ent
            t = torch.matmul(x, a.to(x.dtype).t())
            return out + torch.matmul(t, b.to(x.dtype).t()) * s.to(out.dtype)
        ent = ctx.lora.get(self.prefix)
        if ent is None:
            return out
        a, b, s = ent["a"], ent["b"], ent["scale"]
        n_slots, R = a.shape[0], a.shape[1]
        lead = x.shape[:-1]
        t = torch.matmul(x, a.reshape(n_slots * R, -1).to(x.dtype).t())
        keep = (ctx.lora_onehot(n_slots, lead) * s).to(x.dtype)
        t = (t.reshape(*lead, n_slots, R) * keep[..., None]).reshape(
            *lead, n_slots * R)
        b_all = b.permute(0, 2, 1).reshape(n_slots * R, -1).to(x.dtype)
        return out + torch.matmul(t, b_all).to(out.dtype)


class LayerNorm(Module):
    def __init__(self, normalized_shape, eps: float = 1e-5, bias: bool = True,
                 elementwise_affine: bool = True):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(d) for d in normalized_shape)
        self.eps = float(eps)
        self.affine = bool(elementwise_affine)
        self.use_bias = bool(bias) and self.affine
        self.weight = (nn.Parameter(torch.empty(self.normalized_shape))
                       if self.affine else None)
        self.bias = (nn.Parameter(torch.empty(self.normalized_shape))
                     if self.use_bias else None)

    def reset_parameters(self, generator):
        with torch.no_grad():
            if self.weight is not None:
                self.weight.fill_(1.0)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x, ctx):
        # Normalize in fp32 and cast back before the affine part, as the
        # JAX package does (bf16 statistics would drift).
        out = F.layer_norm(x.to(torch.float32), self.normalized_shape,
                           eps=self.eps).to(x.dtype)
        if self.weight is not None:
            out = out * self.weight
        if self.bias is not None:
            out = out + self.bias
        return out


class Flatten(Module):
    def __init__(self, start_dim: int = 1, end_dim: int = -1):
        super().__init__()
        self.start_dim = start_dim
        self.end_dim = end_dim

    def forward(self, x, ctx):
        start = self.start_dim if self.start_dim >= 0 \
            else x.ndim + self.start_dim
        end = self.end_dim if self.end_dim >= 0 else x.ndim + self.end_dim
        return x.reshape(x.shape[:start] + (-1,) + x.shape[end + 1:])


class BatchNorm1d(Module):
    """Batch normalization over dim 1.  In training the batch statistics
    normalize and the running ones move by ``momentum`` (the variance
    unbiased), in place under no_grad; in eval the running ones
    normalize.  The statistics stay fp32 whatever the compute dtype."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1):
        super().__init__()
        self.num_features = int(num_features)
        self.eps = float(eps)
        self.momentum = float(momentum)
        self.weight = nn.Parameter(torch.ones(self.num_features))
        self.bias = nn.Parameter(torch.zeros(self.num_features))
        self.register_buffer("running_mean", torch.zeros(self.num_features))
        self.register_buffer("running_var", torch.ones(self.num_features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.int32))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x, ctx):
        reduce_dims = (tuple(i for i in range(x.ndim) if i != 1)
                       if x.ndim > 2 else (0,))
        if ctx.training:
            mean = x.mean(dim=reduce_dims)
            var = x.var(dim=reduce_dims, unbiased=False)
            n = x.numel() // x.shape[1]
            m = self.momentum
            with torch.no_grad():
                unbiased = var.detach() * (n / max(n - 1, 1))
                self.running_mean.copy_((1 - m) * self.running_mean
                                        + m * mean.detach())
                self.running_var.copy_((1 - m) * self.running_var
                                       + m * unbiased)
                self.num_batches_tracked.add_(1)
        else:
            mean, var = self.running_mean, self.running_var
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean, var = mean.reshape(shape), var.reshape(shape)
        return ((x - mean) * torch.rsqrt(var + self.eps)
                * self.weight.reshape(shape) + self.bias.reshape(shape))


class GELU(Module):
    def __init__(self, approximate: str = "none"):
        super().__init__()
        self.approximate = "tanh" if approximate == "tanh" else "none"

    def forward(self, x, ctx):
        return F.gelu(x, approximate=self.approximate)


class Softcap(Module):
    """Logit soft-capping ``cap * tanh(x / cap)`` in fp32 (Gemma-2's
    ``final_logit_softcapping``)."""

    def __init__(self, cap: float):
        super().__init__()
        if float(cap) <= 0.0:
            raise ValueError(f"softcap must be > 0, got {cap}")
        self.cap = float(cap)

    def forward(self, x, ctx):
        return (self.cap * torch.tanh(x.to(torch.float32) / self.cap)
                ).to(x.dtype)


class Clamp(Module):
    """Elementwise clipping (OLMo v1 and MPT ``clip_qkv`` on the fused QKV
    projection)."""

    def __init__(self, min: Optional[float] = None,
                 max: Optional[float] = None):
        super().__init__()
        if min is None and max is None:
            raise ValueError("clamp needs at least one of min/max")
        self.min = float(min) if min is not None else None
        self.max = float(max) if max is not None else None

    def forward(self, x, ctx):
        return torch.clamp(x, self.min, self.max)


class RMSNorm(Module):
    """RMS normalization computed in fp32, cast back before the weight."""

    def __init__(self, normalized_shape: int, eps: float = 1e-6):
        super().__init__()
        self.normalized_shape = int(normalized_shape)
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(self.normalized_shape))

    def reset_parameters(self, generator):
        with torch.no_grad():
            self.weight.fill_(1.0)

    def forward(self, x, ctx):
        xf = x.to(torch.float32)
        norm = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                           + self.eps)
        return (xf * norm).to(x.dtype) * self.weight


class ReLU(Module):
    def forward(self, x, ctx):
        return F.relu(x)


class SiLU(Module):
    def forward(self, x, ctx):
        return F.silu(x)


class Sigmoid(Module):
    def forward(self, x, ctx):
        return torch.sigmoid(x)


class Tanh(Module):
    def forward(self, x, ctx):
        return torch.tanh(x)


class Softmax(Module):
    def __init__(self, dim: Optional[int] = None):
        super().__init__()
        self.dim = dim

    def forward(self, x, ctx):
        return torch.softmax(x, dim=self.dim if self.dim is not None else -1)


class SoftmaxOnLast(Softmax):
    """Softmax over the vocabulary of only the final sequence position."""

    def forward(self, x, ctx):
        return torch.softmax(x[:, -1, :],
                             dim=self.dim if self.dim is not None else -1)


class Dropout(Module):
    """Identity at inference; in training mode each element is kept with
    probability ``1 - p`` (a Bernoulli draw from ``ctx.generator``) and
    rescaled.  Only the distribution matches the JAX package's draw."""

    def __init__(self, p: float = 0.5):
        super().__init__()
        self.p = float(p)

    def forward(self, x, ctx):
        if not ctx.training or self.p == 0.0:
            return x
        keep = 1.0 - self.p
        g = ctx.require_generator()
        mask = torch.rand(x.shape, generator=g, device=x.device) < keep
        return torch.where(mask, x / keep,
                           torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# Containers
# ---------------------------------------------------------------------------

class Sequential(Module):
    def __init__(self, *layers: Module):
        super().__init__()
        for i, layer in enumerate(layers):
            self.add_module(str(i), layer)

    @property
    def layers(self) -> list[Module]:
        return list(self._modules.values())

    def forward(self, x, ctx):
        for layer in self.layers:
            x = layer(x, ctx)
        return x


class Summation(Sequential):
    """Sum of each child applied to the same input (token+position embed)."""

    def forward(self, x, ctx):
        layers = self.layers
        out = layers[0](x, ctx)
        for layer in layers[1:]:
            out = out + layer(x, ctx)
        return out


class ResidualConnection(Sequential):
    """x = x + child(x), applied for each child in order."""

    def forward(self, x, ctx):
        for layer in self.layers:
            x = x + layer(x, ctx)
        return x


class ParallelResidual(Sequential):
    """x = x + sum of child(x): every child reads the same input (the
    GPT-NeoX ``use_parallel_residual`` block).  The branches' keys sit one
    level flat (``layers.i.{branch}.*``), which the NeoX remap relies on."""

    def forward(self, x, ctx):
        out = x
        for layer in self.layers:
            out = out + layer(x, ctx)
        return out


class TransformerBlock(Module):
    """Pre-norm decoder block with optional post-norms:
    ``post_norm_on_residual=True`` gives ``h = post_norm(x + branch(x))``,
    ``False`` (Gemma 2) ``h = x + post_norm(branch(x))``."""

    def __init__(self, attn_block: Module, mlp_block: Module,
                 post_attn_norm: Optional[Module] = None,
                 post_mlp_norm: Optional[Module] = None,
                 post_norm_on_residual: bool = True):
        super().__init__()
        self.attn_block = attn_block
        self.mlp_block = mlp_block
        self.post_attn_norm = post_attn_norm
        self.post_mlp_norm = post_mlp_norm
        self.post_norm_on_residual = bool(post_norm_on_residual)

    def forward(self, x, ctx):
        on_residual = self.post_norm_on_residual
        attn_out = self.attn_block(x, ctx)
        if self.post_attn_norm is not None and not on_residual:
            attn_out = self.post_attn_norm(attn_out, ctx)
        h = x + attn_out
        if self.post_attn_norm is not None and on_residual:
            h = self.post_attn_norm(h, ctx)
        mlp_out = self.mlp_block(h, ctx)
        if self.post_mlp_norm is not None and not on_residual:
            mlp_out = self.post_mlp_norm(mlp_out, ctx)
        out = h + mlp_out
        if self.post_mlp_norm is not None and on_residual:
            out = self.post_mlp_norm(out, ctx)
        return out


class GatedMLP(Module):
    """SwiGLU/GeGLU gated MLP: ``down(act(gate(x)) * up(x))``."""

    def __init__(self, in_features: int, intermediate_size: int,
                 bias: bool = False, activation: str = "gelu_pytorch_tanh"):
        super().__init__()
        self.gate_proj = Linear(in_features, intermediate_size, bias=bias)
        self.up_proj = Linear(in_features, intermediate_size, bias=bias)
        self.down_proj = Linear(intermediate_size, in_features, bias=bias)
        self.activation = activation

    def forward(self, x, ctx):
        gated = (_gated_activation(self.activation, self.gate_proj(x, ctx))
                 * self.up_proj(x, ctx))
        return self.down_proj(gated, ctx)


def _gated_activation(name: str, x):
    """silu / gelu / gelu_pytorch_tanh, as the JAX package maps them (any
    other name is the exact gelu)."""
    if name in ("silu", "swish"):
        return F.silu(x)
    return F.gelu(x, approximate="tanh" if name == "gelu_pytorch_tanh"
                  else "none")


class _Weight(nn.Module):
    """Holder that gives a bare parameter its ``…weight`` key (the qk-norm
    weights, filled with ones; the MoE router and expert stacks, which
    their module initializes)."""

    def __init__(self, *shape: int, fill: Optional[float] = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape) if fill is None
                                   else torch.full(shape, fill))


class MixtureOfExperts(Module):
    """Top-k routed mixture of gated-MLP experts (JAX package
    ``MixtureOfExperts``, ops/modules.py:681), on one device.

    The expert weights are stacked on a leading expert dimension under the
    JAX key names (``experts.gate_proj.weight`` (E, H, D), ``up_proj`` the
    same, ``down_proj`` (E, D, H)); ``router.weight`` is (E, D).  Routing
    (:meth:`router_weights`) runs in fp32.  Two dispatch modes:

    - ``"dense"``: every expert runs on every token, and the outputs are
      combined by the router weights (zero off the top-k);
    - ``"capacity"``: the forward's tokens, flattened, are cut into groups
      of ``DISPATCH_GROUP`` (the last padded with rows of zero weight);
      in each group a selected token takes the next slot of its expert's
      queue in token order, and tokens past the capacity ``ceil(top_k ·
      group / E · capacity_factor)`` lose that expert (Switch dropping).
      The dispatch is the JAX package's static one-hot formulation: no
      device read, no data-dependent shape, so it runs inside a captured
      CUDA graph; which tokens drop depends on the tokens a forward gets,
      so callers feed the same blocks as the JAX package.

    ``shared_expert_size`` adds Qwen2-MoE's always-on expert, scaled by a
    sigmoid token gate.  The expert products are PyTorch matrix products:
    the JAX package leaves them to XLA outside any Pallas kernel.  A
    training forward writes the per-expert routing fraction into the
    ``router_fraction`` buffer and, with ``aux_loss_coef`` > 0, appends
    the Switch load-balance loss to ``ctx.aux_losses``."""

    DISPATCH_GROUP = 512

    def __init__(self, in_features: int, intermediate_size: int,
                 num_experts: int, top_k: int = 2, bias: bool = False,
                 activation: str = "silu", aux_loss_coef: float = 0.0,
                 dispatch: str = "dense", capacity_factor: float = 1.25,
                 norm_topk: bool = True, shared_expert_size: int = 0):
        super().__init__()
        if top_k < 1 or top_k > num_experts:
            raise ValueError(f"top_k={top_k} outside [1, {num_experts}]")
        if bias:
            raise ValueError("MixtureOfExperts does not support bias yet")
        if dispatch not in ("dense", "capacity"):
            raise ValueError(f"dispatch must be 'dense' or 'capacity', "
                             f"got {dispatch!r}")
        if float(capacity_factor) <= 0.0:
            raise ValueError(f"capacity_factor must be > 0, "
                             f"got {capacity_factor}")
        d, h, e = int(in_features), int(intermediate_size), int(num_experts)
        self.in_features, self.intermediate_size, self.num_experts = d, h, e
        self.top_k = int(top_k)
        self.activation = activation
        self.aux_loss_coef = float(aux_loss_coef)
        self.dispatch = dispatch
        self.capacity_factor = float(capacity_factor)
        self.norm_topk = bool(norm_topk)
        self.shared_expert_size = int(shared_expert_size)
        # registration order = the JAX param_shapes order
        self.router = _Weight(e, d)
        self.experts = nn.Module()
        self.experts.gate_proj = _Weight(e, h, d)
        self.experts.up_proj = _Weight(e, h, d)
        self.experts.down_proj = _Weight(e, d, h)
        if self.shared_expert_size:
            hs = self.shared_expert_size
            self.shared_expert = nn.Module()
            self.shared_expert.gate_proj = _Weight(hs, d)
            self.shared_expert.up_proj = _Weight(hs, d)
            self.shared_expert.down_proj = _Weight(d, hs)
            self.shared_expert_gate = _Weight(1, d)
        self.register_buffer("router_fraction",
                             torch.zeros(e, dtype=torch.float32))

    def reset_parameters(self, generator):
        # U(-1/sqrt(fan_in), ·) a leaf; fan_in is the trailing dim
        for p in self.parameters():
            _uniform_(p, 1.0 / math.sqrt(p.shape[-1]), generator)

    def router_weights(self, x, ctx):
        """(B, T, E) combine weights in fp32: softmax over every expert,
        top-k (the lower index first among equal probabilities, as
        ``jax.lax.top_k``: a stable descending sort), renormalized when
        ``norm_topk``.  The logits product runs in fp32 too: a bf16
        product flips experts on near-tie tokens."""
        logits = x.to(torch.float32) @ self.router.weight.to(
            torch.float32).t()
        probs = torch.softmax(logits, dim=-1)
        top_vals, top_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
        top_vals = top_vals[..., :self.top_k]
        top_idx = top_idx[..., :self.top_k]
        if self.norm_topk:
            top_vals = top_vals / top_vals.sum(dim=-1, keepdim=True)
        if ctx.training:
            # f_e: the share of routing slots on expert e; P_e: its mean
            # probability.  E · Σ (f_e / k) P_e is 1 under uniform routing.
            counts = torch.zeros_like(probs).scatter_(
                -1, top_idx, 1.0).sum(dim=tuple(range(probs.ndim - 1)))
            fractions = counts / (probs.numel() // self.num_experts)
            mean_probs = probs.mean(dim=tuple(range(probs.ndim - 1)))
            with torch.no_grad():
                self.router_fraction.copy_(fractions / self.top_k)
            if self.aux_loss_coef > 0.0:
                aux = self.num_experts * torch.sum(
                    (fractions / self.top_k) * mean_probs)
                ctx.aux_losses.append(self.aux_loss_coef * aux)
        return torch.zeros_like(probs).scatter(-1, top_idx, top_vals)

    def forward(self, x, ctx):
        w_gate = self.experts.gate_proj.weight
        w_up = self.experts.up_proj.weight
        w_down = self.experts.down_proj.weight
        weights = self.router_weights(x, ctx).to(x.dtype)
        if self.dispatch == "capacity":
            routed = self._apply_capacity(x, weights, w_gate, w_up, w_down)
        else:
            g = torch.einsum("btd,ehd->bteh", x, w_gate)
            u = torch.einsum("btd,ehd->bteh", x, w_up)
            y = torch.einsum("bteh,edh->bted",
                             _gated_activation(self.activation, g) * u,
                             w_down)
            routed = torch.einsum("bted,bte->btd", y, weights)
        if self.shared_expert_size:
            se = self.shared_expert
            shared = F.linear(
                _gated_activation(self.activation,
                                  F.linear(x, se.gate_proj.weight))
                * F.linear(x, se.up_proj.weight), se.down_proj.weight)
            gate = torch.sigmoid(F.linear(x, self.shared_expert_gate.weight))
            routed = routed + gate * shared
        return routed

    def _apply_capacity(self, x, weights, w_gate, w_up, w_down):
        """Capacity dispatch (JAX ``_apply_capacity``): one-hot dispatch
        and combine products over fixed-size groups, static shapes."""
        B, T, d = x.shape
        E = self.num_experts
        tokens = B * T
        group = min(tokens, self.DISPATCH_GROUP)
        padded = -(-tokens // group) * group
        n_groups = padded // group
        cap = int(math.ceil(self.top_k * group / E * self.capacity_factor))
        cap = max(1, min(cap, group))
        flat_x = x.reshape(tokens, d)
        flat_w = weights.reshape(tokens, E)
        if padded != tokens:
            flat_x = F.pad(flat_x, (0, 0, 0, padded - tokens))
            flat_w = F.pad(flat_w, (0, 0, 0, padded - tokens))
        gx = flat_x.reshape(n_groups, group, d)
        gw = flat_w.reshape(n_groups, group, E)
        disp, combine = self._dispatch_plan(gw, cap, x.dtype)
        expert_in = torch.einsum("gsec,gsd->gecd", disp, gx)
        gate = torch.einsum("gecd,ehd->gech", expert_in, w_gate)
        up = torch.einsum("gecd,ehd->gech", expert_in, w_up)
        out_e = torch.einsum("gech,edh->gecd",
                             _gated_activation(self.activation, gate) * up,
                             w_down)
        y = torch.einsum("gsec,gecd->gsd", combine, out_e)
        return y.reshape(padded, d)[:tokens].reshape(B, T, d)

    @staticmethod
    def _dispatch_plan(gw, cap: int, dtype):
        """(dispatch, combine), both (G, S, E, C): a selected token takes
        the next slot of its expert's queue (cumsum order); a token past
        ``cap`` gets the overflow class ``cap``, an all-zero row (the
        comparison with ``arange(cap)``; ``F.one_hot`` would refuse the
        class), so it is dropped."""
        sel = gw > 0
        pos = torch.cumsum(sel.to(torch.int32), dim=1) - 1
        slot = torch.where(sel & (pos < cap), pos, torch.full_like(pos, cap))
        disp = (slot[..., None] == torch.arange(cap, device=gw.device)
                ).to(dtype)
        return disp, disp * gw[..., None]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

class CausalSelfAttention(Module):
    """Causal self-attention over a fused QKV input with GQA + optional
    RoPE, ALiBi, sliding window, softcap and qk-norm (JAX package
    ``CausalSelfAttention``, ops/modules.py:994).

    Consumes a ``(B, T, q_dim + 2*kv_dim)`` projection; the head dim
    follows from the input width.  With a KV cache in the Ctx, new K/V
    are written at the cache length (only ``num_kv_heads`` heads are
    stored) and attention goes through ``cached_attention``; without one,
    through the causal reference."""

    def __init__(self, num_heads: int, dropout: float = 0.0,
                 num_kv_heads: Optional[int] = None,
                 rope_theta: Optional[float] = None,
                 head_dim: Optional[int] = None,
                 rope_scaling: Optional[dict] = None,
                 sliding_window: Optional[int] = None,
                 rope_pct: Optional[float] = None,
                 qk_norm: bool = False, qk_norm_eps: float = 1e-6,
                 qk_norm_scope: str = "head", rope_dim=None,
                 qk_norm_fp32_weight: bool = False, alibi: bool = False,
                 logit_softcap=None, attn_scale=None):
        super().__init__()
        if sliding_window is not None and int(sliding_window) < 1:
            raise ValueError(f"sliding_window must be >= 1, "
                             f"got {sliding_window}")
        if qk_norm_scope not in ("head", "flat"):
            raise ValueError(f"qk_norm_scope must be 'head' or 'flat', "
                             f"got {qk_norm_scope!r}")
        if qk_norm and head_dim is None:
            raise ValueError("qk_norm=True requires an explicit head_dim")
        if alibi and rope_theta is not None:
            raise ValueError("alibi and rope_theta are mutually exclusive "
                             "position encodings")
        if logit_softcap is not None and float(logit_softcap) <= 0.0:
            raise ValueError(f"logit_softcap must be > 0, "
                             f"got {logit_softcap}")
        if rope_pct is not None and not 0.0 < float(rope_pct) <= 1.0:
            raise ValueError(f"rope_pct must be in (0, 1], got {rope_pct}")
        if rope_dim is not None and (int(rope_dim) < 2 or int(rope_dim) % 2):
            raise ValueError(f"rope_dim must be even and >= 2, "
                             f"got {rope_dim}")
        self.qk_norm = bool(qk_norm)
        self.qk_norm_eps = float(qk_norm_eps)
        self.qk_norm_scope = qk_norm_scope
        self.qk_norm_fp32_weight = bool(qk_norm_fp32_weight)
        self.sliding_window = (int(sliding_window)
                               if sliding_window is not None else None)
        self.num_heads = int(num_heads)
        self.num_kv_heads = (int(num_kv_heads) if num_kv_heads is not None
                             else int(num_heads))
        self.dropout = float(dropout)
        self.alibi = bool(alibi)
        self.logit_softcap = (float(logit_softcap)
                              if logit_softcap is not None else None)
        self.attn_scale = float(attn_scale) if attn_scale is not None else None
        self.rope_theta = float(rope_theta) if rope_theta is not None else None
        self.head_dim = int(head_dim) if head_dim is not None else None
        self.rope_pct = float(rope_pct) if rope_pct is not None else None
        self.rope_dim = int(rope_dim) if rope_dim is not None else None
        self.rope_scaling = _validated_rope_scaling(rope_scaling)
        self.layer_idx = 0  # assigned by the model builder
        if self.qk_norm:
            q_w, k_w = ((self.num_heads * self.head_dim,
                         self.num_kv_heads * self.head_dim)
                        if qk_norm_scope == "flat"
                        else (self.head_dim, self.head_dim))
            # keys q_norm.weight, k_norm.weight
            self.q_norm = _Weight(q_w, fill=1.0)
            self.k_norm = _Weight(k_w, fill=1.0)

    def _head_rmsnorm(self, x, w):
        """fp32 RMS over the last dim, learned multiplicative weight."""
        xf = x.to(torch.float32)
        norm = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True)
                           + self.qk_norm_eps)
        if self.qk_norm_fp32_weight:
            return ((xf * norm) * w.to(torch.float32)).to(x.dtype)
        return ((xf * norm).to(x.dtype) * w).to(x.dtype)

    def forward(self, qkv, ctx):
        B, T, total_dim = qkv.shape
        head_dim = total_dim // (self.num_heads + 2 * self.num_kv_heads)
        q_dim = self.num_heads * head_dim
        kv_dim = self.num_kv_heads * head_dim

        q_flat = qkv[..., :q_dim]
        k_flat = qkv[..., q_dim:q_dim + kv_dim]
        if self.qk_norm and self.qk_norm_scope == "flat":
            q_flat = self._head_rmsnorm(q_flat, self.q_norm.weight)
            k_flat = self._head_rmsnorm(k_flat, self.k_norm.weight)
        q = q_flat.reshape(B, T, self.num_heads, head_dim)
        k = k_flat.reshape(B, T, self.num_kv_heads, head_dim)
        v = qkv[..., q_dim + kv_dim:].reshape(B, T, self.num_kv_heads,
                                               head_dim)
        # to (B, H, T, D), contiguous for the cache write and the kernel
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        if self.qk_norm and self.qk_norm_scope == "head":
            q = self._head_rmsnorm(q, self.q_norm.weight)
            k = self._head_rmsnorm(k, self.k_norm.weight)

        offset = ctx.offset()
        if self.rope_theta is not None:
            rotary_dim = None
            if self.rope_dim is not None:
                rotary_dim = None if self.rope_dim >= head_dim \
                    else self.rope_dim
            elif self.rope_pct is not None and self.rope_pct < 1.0:
                rotary_dim = int(head_dim * self.rope_pct) // 2 * 2
            q, k = attn_ops.apply_rope(q, k, self.rope_theta, offset,
                                       scaling=self.rope_scaling,
                                       rotary_dim=rotary_dim)
            q = q.contiguous()

        alibi = attn_ops.alibi_slopes(self.num_heads) if self.alibi else None
        if ctx.kv is not None:
            li = self.layer_idx - ctx.kv_base
            paged = isinstance(ctx.kv, KV.PagedKVState)
            ragged = paged and ctx.ragged_descs is not None
            if ragged:
                store_k, store_v = ctx.kv.append_packed(
                    li, k, v, ctx.ragged_rows)
            elif paged:
                store_k, store_v, length = ctx.kv.append_rows(li, k, v)
            elif ctx.kv.quantized:
                # int8 cache: store + attend on the raw buffers; the
                # kernel dequantizes per tile.
                store_k, store_v, length = ctx.kv.append_raw(li, k, v)
            else:
                store_k, store_v, length = ctx.kv.append(li, k, v)
            # int8 caches carry per-token scales, read after the append
            scales = ({"k_scale": ctx.kv.k_scale[li],
                       "v_scale": ctx.kv.v_scale[li]}
                      if ctx.kv.quantized else {})
            opts = {"window": self.sliding_window, "alibi": alibi,
                    "scale": self.attn_scale, "softcap": self.logit_softcap,
                    **scales}
            if ragged:
                out = attn_ops.ragged_paged_cached_attention(
                    q, store_k, store_v, ctx.kv.block_table,
                    ctx.kv.page_size, ctx.ragged_descs, **opts)
            elif paged:
                if not isinstance(length, int):  # ragged (B,) host lengths
                    length = torch.as_tensor(length, dtype=torch.int32,
                                             device=q.device)
                out = attn_ops.paged_cached_attention(
                    q, store_k, store_v, ctx.kv.block_table,
                    ctx.kv.page_size, offset, length, **opts)
            else:
                if not isinstance(length, (int, torch.Tensor)):
                    length = torch.as_tensor(length, dtype=torch.int32,
                                             device=q.device)
                out = attn_ops.cached_attention(q, store_k, store_v, offset,
                                                length, **opts)
        else:
            rate = self.dropout if ctx.training else 0.0
            out = attn_ops.causal_attention(
                q, k, v, dropout_rate=rate,
                seed=ctx.dropout_seed() if rate > 0.0 else None,
                generator=ctx.generator, window=self.sliding_window,
                alibi=alibi, scale=self.attn_scale,
                softcap=self.logit_softcap)
        return out.transpose(1, 2).reshape(B, T, q_dim)


class GatedSSM(Module):
    """Gated linear-attention (SSD) token mixer with O(1) per-row state
    (JAX package ``GatedSSM``, ops/modules.py:1313).

    Consumes a fused projection laid out ``[q (H·dk) | k (H·dk) | v (H·dv)
    | gate (H)]`` and runs ``S_t = σ(gate_t)·S_{t-1} + k_t ⊗ v_t,
    y_t = q_t·S_t`` (ops/ssm.py), q scaled by ``dk^-0.5`` and the gate in
    fp32.  No positional encoding: the recurrence is the position signal.
    With the cache's ``ssm`` child in the Ctx the tokens go through the
    cached recurrent update (the kernel of ops/kernels/ssm_update.py on
    the card): ``update_packed`` over a unified block's descriptors
    (``ctx.ragged_descs``), else ``update_dense`` at each row's offset,
    taking each row's first ``ctx.ssm_count`` tokens when given; without a
    cache, through :func:`ops.ssm.gla_full` (the chunked kernel on the
    card at inference).  ``layer_idx`` indexes the model's ssm layers, assigned by
    ``CompiledArch``."""

    def __init__(self, num_heads: int, head_dim: int,
                 value_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = int(num_heads)
        self.head_dim = int(head_dim)
        self.value_dim = (int(value_dim) if value_dim is not None
                          else int(head_dim))
        self.layer_idx = 0  # assigned by CompiledArch

    @property
    def fused_dim(self) -> int:
        """Input width the preceding fused Linear must produce."""
        return self.num_heads * (2 * self.head_dim + self.value_dim + 1)

    def forward(self, x, ctx):
        B, T, total = x.shape
        H, dk, dv = self.num_heads, self.head_dim, self.value_dim
        if total != self.fused_dim:
            raise ValueError(f"ssm fused input width {total} != expected "
                             f"{self.fused_dim} (H={H}, dk={dk}, dv={dv})")
        q = x[..., :H * dk].reshape(B, T, H, dk) * (dk ** -0.5)
        k = x[..., H * dk:2 * H * dk].reshape(B, T, H, dk)
        v = x[..., 2 * H * dk:2 * H * dk + H * dv].reshape(B, T, H, dv)
        # fp32 gate: σ saturates in bf16 after ~8 tokens of decay product
        g = torch.sigmoid(x[..., 2 * H * dk + H * dv:].float()
                          ).reshape(B, T, H)
        ssm = getattr(ctx.kv, "ssm", None) if ctx.kv is not None else None
        if ssm is not None and ctx.ragged_descs is not None:
            # the unified block: NB equal blocks of T // NB packed slots
            nb = ctx.ragged_descs.shape[0]
            y = ssm.update_packed(self.layer_idx, q, k, v, g,
                                  ctx.ragged_descs, T // nb)
        elif ssm is not None:
            y = ssm.update_dense(self.layer_idx, q, k, v, g, ctx.offset(),
                                 ctx.ssm_count)
        else:
            y = ssm_ops.gla_full(q, k, v, g, training=ctx.training)
        return y.reshape(B, T, H * dv).to(x.dtype)


def _validated_rope_scaling(rope_scaling: Optional[dict]):
    """Normalized ``rope_scaling`` dict, validated at build time (→ HTTP 400
    on POST /model/) as the JAX module does: 'linear' or 'llama3' only."""
    if not rope_scaling:
        return None
    rope_type = (rope_scaling.get("rope_type") or rope_scaling.get("type")
                 or "default")
    if rope_type == "linear":
        if float(rope_scaling.get("factor", 0.0)) < 1.0:
            raise ValueError("linear rope_scaling needs factor >= 1")
        return {"rope_type": "linear",
                "factor": float(rope_scaling["factor"])}
    if rope_type != "llama3":
        raise ValueError(f"rope_scaling type {rope_type!r} is not "
                         "supported (only 'llama3' and 'linear')")
    missing = [k for k in ("factor", "original_max_position_embeddings")
               if k not in rope_scaling]
    if missing:
        raise ValueError(f"rope_scaling missing keys: {missing}")
    low = float(rope_scaling.get("low_freq_factor", 1.0))
    high = float(rope_scaling.get("high_freq_factor", 4.0))
    if high <= low:
        raise ValueError(f"rope_scaling needs high_freq_factor > "
                         f"low_freq_factor, got {low} >= {high}")
    if float(rope_scaling["factor"]) < 1.0:
        raise ValueError("rope_scaling factor must be >= 1")
    return {"rope_type": "llama3",
            "factor": float(rope_scaling["factor"]),
            "low_freq_factor": low, "high_freq_factor": high,
            "original_max_position_embeddings":
                float(rope_scaling["original_max_position_embeddings"])}
