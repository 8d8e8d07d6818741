"""JSON layer DSL → module trees (counterpart of penroz_tpu/models/dsl.py
``layer_algo``/``to_layer``/``build_modules``, the init overrides and
``Mapper``).  Parameter keys come from module registration (see
ops/modules.py), so there is no separate bind step.

Every algo of the JAX table builds, and the ``transformerblock`` macro;
an unknown algo raises ``ValueError("Unsupported layer: …")`` as
``to_layer`` does.  Initialization draws
from an explicit ``torch.Generator``; its numbers differ from
``jax.random``'s for the same seed, so a model carried over from the JAX
package goes through models/convert.py instead.
"""

from __future__ import annotations

import math

import torch

from penroz_tpu_torch.models import hf_families
from penroz_tpu_torch.ops import modules as M

# Init-override keys that may sit alongside the layer algo in a DSL entry.
INIT_KEYS = ("normal", "xavier_uniform", "kaiming_uniform", "zeros")

_CONTAINER_ALGOS = {
    "sequential": M.Sequential,
    "summation": M.Summation,
    "residual": M.ResidualConnection,
    "parallelresidual": M.ParallelResidual,
}

_LEAF_ALGOS = {
    "linear": M.Linear,
    "embedding": M.Embedding,
    "position": M.PositionEmbedding,
    "scaledembedding": M.ScaledEmbedding,
    "flatten": M.Flatten,
    "batchnorm1d": M.BatchNorm1d,
    "layernorm": M.LayerNorm,
    "rmsnorm": M.RMSNorm,
    "relu": M.ReLU,
    "gelu": M.GELU,
    "silu": M.SiLU,
    "sigmoid": M.Sigmoid,
    "tanh": M.Tanh,
    "softmax": M.Softmax,
    "softmaxlast": M.SoftmaxOnLast,
    "dropout": M.Dropout,
    "attention": M.CausalSelfAttention,
    "ssm": M.GatedSSM,
    "gatedmlp": M.GatedMLP,
    "clamp": M.Clamp,
    "softcap": M.Softcap,
    "moe": M.MixtureOfExperts,
}

_OPTIMIZERS = ("adamw", "adam", "sgd")


def layer_algo(entry: dict) -> str:
    """The single layer-algo key of a DSL entry (init keys are siblings)."""
    algos = [k for k in entry if k not in INIT_KEYS and k != "confidence"]
    if len(algos) != 1:
        raise ValueError(f"Layer entry must have exactly one algo key, got "
                         f"{sorted(entry)}")
    return algos[0]


def to_layer(entry: dict) -> M.Module:
    """Recursively build one module from a DSL entry."""
    algo = layer_algo(entry)
    args = entry[algo]
    if algo in _CONTAINER_ALGOS:
        mod = _CONTAINER_ALGOS[algo](*[to_layer(e) for e in args])
    elif algo == "transformerblock":
        kwargs = {"attn_block": to_layer(args["attn_block"]),
                  "mlp_block": to_layer(args["mlp_block"]),
                  "post_norm_on_residual": bool(
                      args.get("post_norm_on_residual", True))}
        for name in ("post_attn_norm", "post_mlp_norm"):
            if name in args:
                kwargs[name] = to_layer(args[name])
        mod = M.TransformerBlock(**kwargs)
    elif algo in _LEAF_ALGOS:
        mod = _LEAF_ALGOS[algo](**args)
    else:
        raise ValueError(f"Unsupported layer: {algo}")
    mod._algo = algo
    mod._init_spec = {k: entry[k] for k in entry
                      if k in INIT_KEYS or k == "confidence"}
    return mod


def build_modules(layers: list[dict]) -> list[M.Module]:
    """Build the top-level module list (held under ``layers.{i}``)."""
    return [to_layer(entry) for entry in layers]


def _fans(shape: tuple) -> tuple[int, int]:
    """(fan_in, fan_out) for a weight stored as (out, in) — torch layout."""
    if len(shape) >= 2:
        return int(shape[-1]), int(shape[0])
    return int(shape[0]), int(shape[0])


def _override_init(mod: M.Module, spec: dict, generator: torch.Generator):
    """Apply an init-override spec to a module's own weight and bias
    (per-layer init + ``confidence`` weight scaling)."""
    weight = getattr(mod, "weight", None)
    with torch.no_grad():
        if isinstance(weight, torch.nn.Parameter):
            fan_in, fan_out = _fans(tuple(weight.shape))
            if "normal" in spec:
                weight.normal_(float(spec["normal"].get("mean", 0.0)),
                               float(spec["normal"].get("std", 1.0)),
                               generator=generator)
            elif "xavier_uniform" in spec:
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                weight.uniform_(-bound, bound, generator=generator)
            elif "kaiming_uniform" in spec:
                cfg = spec["kaiming_uniform"]
                a = float(cfg.get("a", math.sqrt(5.0)))
                nonlinearity = cfg.get("nonlinearity", "leaky_relu")
                if nonlinearity == "relu":
                    gain = math.sqrt(2.0)
                elif nonlinearity == "leaky_relu":
                    gain = math.sqrt(2.0 / (1.0 + a * a))
                else:
                    gain = 1.0
                bound = gain * math.sqrt(3.0 / fan_in)
                weight.uniform_(-bound, bound, generator=generator)
            if "confidence" in spec:
                weight.mul_(float(spec["confidence"]))
        bias = getattr(mod, "bias", None)
        if "zeros" in spec and isinstance(bias, torch.nn.Parameter):
            bias.zero_()


def init_module_params(mods: list[M.Module], seed: int = 0):
    """Deterministically initialize a bound module list in walk order from
    one generator seeded with ``seed``, honouring init-override specs."""
    generator = torch.Generator().manual_seed(int(seed))
    for top in mods:
        for sub in top.modules():
            if isinstance(sub, M.Module):
                sub.reset_parameters(generator)
                spec = getattr(sub, "_init_spec", None)
                if spec:
                    _override_init(sub, spec, generator)


def validate_optimizer(config: dict) -> str:
    """Name of a one-key optimizer DSL entry; raises like the JAX
    ``build_optimizer`` on anything else."""
    if not isinstance(config, dict) or len(config) != 1:
        raise ValueError(f"Optimizer config must have exactly one key, got "
                         f"{sorted(config) if isinstance(config, dict) else config!r}")
    (name, args), = config.items()
    if name not in _OPTIMIZERS:
        raise ValueError(f"Unsupported optimizer: {name}")
    if not isinstance(args, dict):
        raise ValueError(f"Optimizer {name} arguments must be an object")
    return name


def build_optimizer(config: dict, params) -> torch.optim.Optimizer:
    """Optimizer DSL → ``torch.optim`` over ``params`` (one group), with
    the JAX package's optax semantics (penroz_tpu/models/dsl.py
    ``build_optimizer``):

    - ``adamw``: decoupled weight decay, default 0.01 (``optax.adamw``);
    - ``adam``: ``weight_decay`` (default 0) added to the gradient as L2
      before the moments (``add_decayed_weights`` chained before adam);
    - ``sgd``: ``momentum``/``nesterov`` as optax's ``trace`` (no
      dampening; the first step's trace is the gradient), ``weight_decay``
      as L2 into the gradient.

    ``betas`` is coerced to a pair; ``eps`` is added outside the square
    root, as both libraries do.  Unknown keys are ignored, as there."""
    name = validate_optimizer(config)
    args = dict(config[name])
    lr = float(args.pop("lr", 1e-3))
    if name in ("adamw", "adam"):
        betas = args.pop("betas", (0.9, 0.999))
        b1, b2 = float(betas[0]), float(betas[1])
        eps = float(args.pop("eps", 1e-8))
        cls = torch.optim.AdamW if name == "adamw" else torch.optim.Adam
        weight_decay = float(args.pop("weight_decay",
                                      0.01 if name == "adamw" else 0.0))
        return cls(params, lr=lr, betas=(b1, b2), eps=eps,
                   weight_decay=weight_decay)
    momentum = float(args.pop("momentum", 0.0))
    nesterov = bool(args.pop("nesterov", False))
    weight_decay = float(args.pop("weight_decay", 0.0))
    return torch.optim.SGD(params, lr=lr, momentum=momentum,
                           nesterov=nesterov and momentum > 0.0,
                           weight_decay=weight_decay)


class Mapper:
    """Layer + optimizer DSL front-end."""

    def __init__(self, layers: list[dict], optimizer: dict):
        validate_optimizer(optimizer)
        self.layers = layers
        self.optimizer = optimizer

    def init_params(self, mods: list[M.Module], seed: int = 0):
        init_module_params(mods, seed=seed)

    # -- HuggingFace config and weights (models/hf_families.py) -----------

    from_hf_config = staticmethod(hf_families.from_hf_config)
    detect_hf_n_layer = staticmethod(hf_families.detect_hf_n_layer)
    map_hf_state_dict_to_custom = staticmethod(
        hf_families.map_hf_state_dict_to_custom)
