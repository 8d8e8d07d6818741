"""GPT-2 layer-DSL configs (copy of penroz_tpu/models/presets.py
``gpt2``/``gpt2_custom``).  Plain JSON-able DSL lists accepted by
``POST /model/`` of either package."""

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
