"""GPT-2, hybrid attention/SSM and makemore-MLP layer-DSL configs (copy of
penroz_tpu/models/presets.py ``gpt2``/``gpt2_custom``/``_ssm_block``/
``hybrid_custom``/``makemore_mlp``).  Plain JSON-able DSL lists accepted by ``POST /model/``
of either package."""

from __future__ import annotations

GPT2_SIZES = {
    # name: (d_model, heads, depth)
    "gpt2": (768, 12, 12),          # 124M
    "gpt2-medium": (1024, 16, 24),  # 350M
    "gpt2-large": (1280, 20, 36),   # 774M
    "gpt2-xl": (1600, 25, 48),      # 1.5B
}

ADAMW = {"adamw": {"lr": 6e-4, "betas": [0.9, 0.95], "eps": 1e-8}}


def gpt2(size: str = "gpt2", vocab: int = 50304, block: int = 1024,
         dropout: float = 0.0) -> list:
    """GPT-2 style DSL at any ladder size; ``vocab`` defaults to the
    64-padded 50304 of the nanoGPT lineage."""
    if size not in GPT2_SIZES:
        raise ValueError(f"unknown gpt2 size {size!r}; "
                         f"one of {sorted(GPT2_SIZES)}")
    d, heads, depth = GPT2_SIZES[size]
    return gpt2_custom(d=d, heads=heads, depth=depth, vocab=vocab,
                       block=block, dropout=dropout)


def gpt2_custom(d: int, heads: int, depth: int, vocab: int = 50304,
                block: int = 1024, dropout: float = 0.0) -> list:
    """GPT-2-shaped DSL at arbitrary dimensions."""
    std = 0.02
    proj_std = std / (2 * depth) ** 0.5
    return ([{"summation": [
                {"embedding": {"num_embeddings": vocab, "embedding_dim": d},
                 "normal": {"mean": 0.0, "std": std}},
                {"position": {"num_embeddings": block, "embedding_dim": d},
                 "normal": {"mean": 0.0, "std": std}}]},
             {"dropout": {"p": dropout}}]
            + [{"residual": [
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 3 * d},
                     "normal": {"mean": 0.0, "std": std}, "zeros": {}},
                    {"attention": {"num_heads": heads, "dropout": dropout}},
                    {"linear": {"in_features": d, "out_features": d},
                     "normal": {"mean": 0.0, "std": proj_std}, "zeros": {}},
                    {"dropout": {"p": dropout}}]},
                {"sequential": [
                    {"layernorm": {"normalized_shape": d}},
                    {"linear": {"in_features": d, "out_features": 4 * d},
                     "normal": {"mean": 0.0, "std": std}, "zeros": {}},
                    {"gelu": {"approximate": "tanh"}},
                    {"linear": {"in_features": 4 * d, "out_features": d},
                     "normal": {"mean": 0.0, "std": proj_std}, "zeros": {}},
                    {"dropout": {"p": dropout}}]}]} for _ in range(depth)]
            + [{"layernorm": {"normalized_shape": d}},
               {"linear": {"in_features": d, "out_features": vocab,
                           "bias": False}},
               {"softmaxlast": {"dim": -1}}])


def _ssm_block(d: int, heads: int, head_dim: int, value_dim: int,
               proj_std: float, dropout: float) -> dict:
    """One gated-SSM residual block: LN → fused qkvg projection → O(1)
    recurrent mix → output projection.  The fused linear emits
    ``heads * (2*head_dim + value_dim + 1)`` features — [q | k | v | gate]
    in :class:`penroz_tpu_torch.ops.modules.GatedSSM`'s split order."""
    std = 0.02
    fused = heads * (2 * head_dim + value_dim + 1)
    return {"residual": [
        {"sequential": [
            {"layernorm": {"normalized_shape": d}},
            {"linear": {"in_features": d, "out_features": fused},
             "normal": {"mean": 0.0, "std": std}, "zeros": {}},
            {"ssm": {"num_heads": heads, "head_dim": head_dim,
                     "value_dim": value_dim}},
            {"linear": {"in_features": heads * value_dim, "out_features": d},
             "normal": {"mean": 0.0, "std": proj_std}, "zeros": {}},
            {"dropout": {"p": dropout}}]},
        {"sequential": [
            {"layernorm": {"normalized_shape": d}},
            {"linear": {"in_features": d, "out_features": 4 * d},
             "normal": {"mean": 0.0, "std": std}, "zeros": {}},
            {"gelu": {"approximate": "tanh"}},
            {"linear": {"in_features": 4 * d, "out_features": d},
             "normal": {"mean": 0.0, "std": proj_std}, "zeros": {}},
            {"dropout": {"p": dropout}}]}]}


def hybrid_custom(d: int, heads: int, depth: int, vocab: int = 50304,
                  block: int = 1024, dropout: float = 0.0,
                  ssm_every: int = 2) -> list:
    """Hybrid attention/SSM stack: every ``ssm_every``-th residual block is a
    gated-SSM block (O(1) per-row state), the rest stay full attention
    (O(T) KV rows).  ``ssm_every=1`` yields a pure-SSM model with no KV
    rows at all."""
    base = gpt2_custom(d=d, heads=heads, depth=depth, vocab=vocab,
                       block=block, dropout=dropout)
    proj_std = 0.02 / (2 * depth) ** 0.5
    head_dim = d // heads
    # Blocks occupy base[2:2+depth]; replace the selected ones in place.
    for i in range(depth):
        if i % ssm_every == 0:
            base[2 + i] = _ssm_block(d, heads, head_dim, head_dim,
                                     proj_std, dropout)
    return base


def makemore_mlp(vocab: int = 27, d_embed: int = 10,
                 d_hidden: int = 200) -> list:
    """Char-level MLP in the makemore style: per-position embedding → tanh
    MLP → softmax cross-entropy."""
    return [
        {"embedding": {"num_embeddings": vocab, "embedding_dim": d_embed},
         "normal": {"mean": 0.0, "std": 0.02}},
        {"linear": {"in_features": d_embed, "out_features": d_hidden},
         "normal": {"mean": 0.0, "std": 0.02}, "zeros": {}},
        {"tanh": {}},
        {"linear": {"in_features": d_hidden, "out_features": vocab},
         "normal": {"mean": 0.0, "std": 0.02}, "zeros": {}},
        {"softmaxlast": {"dim": -1}},
    ]
