"""A HuggingFace ``config.json`` read the way ``transformers.AutoConfig``
would hold it, for the family DSL functions of models/hf_families.py (the
machine with the card has no ``transformers``).

transformers fills many values in before a DSL function sees the config:
the config class's ``__init__`` defaults, values derived from others (Qwen2/3
and Gemma-2/3 ``layer_types``, Qwen2's ``sliding_window`` dropped when
``use_sliding_window`` is false, Llama's ``head_dim``, ``rope_scaling``'s
``type`` copied to ``rope_type``, Falcon's ``num_kv_heads`` and
``ffn_hidden_size``), ``attribute_map`` aliases (GPT-2's ``hidden_size`` is
``n_embd``), legacy keys (BLOOM's and Falcon's ``n_embed``) and nested
configs (Gemma-3's ``text_config``, MPT's ``attn_config``).  This module
reproduces, family by family, what those functions read: the defaults
below are those of transformers 4.57's config classes for the keys they
read, and each family's derivations are written out.  A wrong default
would import with silently wrong logits, so tests/test_torch_hf_import.py
holds every family's DSL to the JAX package's over ``AutoConfig``, from the
``config.json`` of ``save_pretrained`` and from a minimal one.

Keys of an unknown ``model_type`` are held as written (``from_hf_config``
refuses an unsupported type; the gemma function's dims-only surface reads
them raw).  transformers' own validation of a config (rope_scaling fields,
layer_types) is not repeated: the DSL functions refuse what they cannot
import.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Optional

# PretrainedConfig's own default for the families whose config class does
# not set it.
_BASE_DEFAULTS = {"tie_word_embeddings": True}

_ROPE = {"rope_theta": 10000.0, "rope_scaling": None}

_DEFAULTS: dict[str, dict[str, Any]] = {
    "gpt2": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
             "n_layer": 12, "n_head": 12, "n_inner": None,
             "activation_function": "gelu_new", "resid_pdrop": 0.1,
             "embd_pdrop": 0.1, "attn_pdrop": 0.1,
             "layer_norm_epsilon": 1e-05},
    "llama": {"vocab_size": 32000, "hidden_size": 4096,
              "intermediate_size": 11008, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": None,
              "hidden_act": "silu", "max_position_embeddings": 2048,
              "rms_norm_eps": 1e-06, "tie_word_embeddings": False, **_ROPE,
              "attention_bias": False, "attention_dropout": 0.0,
              "mlp_bias": False, "head_dim": None},
    "mistral": {"vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "head_dim": None, "hidden_act": "silu",
                "max_position_embeddings": 131072, "rms_norm_eps": 1e-06,
                "tie_word_embeddings": False, "rope_theta": 10000.0,
                "sliding_window": 4096, "attention_dropout": 0.0},
    "mixtral": {"vocab_size": 32000, "hidden_size": 4096,
                "intermediate_size": 14336, "num_hidden_layers": 32,
                "num_attention_heads": 32, "num_key_value_heads": 8,
                "head_dim": None, "hidden_act": "silu",
                "rms_norm_eps": 1e-05, "tie_word_embeddings": False,
                "rope_theta": 1000000.0, "sliding_window": None,
                "attention_dropout": 0.0, "num_experts_per_tok": 2,
                "num_local_experts": 8, "router_aux_loss_coef": 0.001},
    "phi3": {"vocab_size": 32064, "hidden_size": 3072,
             "intermediate_size": 8192, "num_hidden_layers": 32,
             "num_attention_heads": 32, "num_key_value_heads": None,
             "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attention_dropout": 0.0,
             "hidden_act": "silu", "max_position_embeddings": 4096,
             "rms_norm_eps": 1e-05, "tie_word_embeddings": False, **_ROPE,
             "partial_rotary_factor": 1.0, "sliding_window": None},
    "qwen2": {"vocab_size": 151936, "hidden_size": 4096,
              "intermediate_size": 22016, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "hidden_act": "silu", "max_position_embeddings": 32768,
              "rms_norm_eps": 1e-06, "tie_word_embeddings": False, **_ROPE,
              "use_sliding_window": False, "sliding_window": 4096,
              "max_window_layers": 28, "layer_types": None,
              "attention_dropout": 0.0},
    "qwen3": {"vocab_size": 151936, "hidden_size": 4096,
              "intermediate_size": 22016, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": 32,
              "head_dim": 128, "hidden_act": "silu",
              "max_position_embeddings": 32768, "rms_norm_eps": 1e-06,
              "tie_word_embeddings": False, **_ROPE, "attention_bias": False,
              "use_sliding_window": False, "sliding_window": 4096,
              "max_window_layers": 28, "layer_types": None,
              "attention_dropout": 0.0},
    "qwen2_moe": {"vocab_size": 151936, "hidden_size": 2048,
                  "intermediate_size": 5632, "num_hidden_layers": 24,
                  "num_attention_heads": 16, "num_key_value_heads": 16,
                  "hidden_act": "silu", "rms_norm_eps": 1e-06,
                  "tie_word_embeddings": False, **_ROPE,
                  "use_sliding_window": False, "sliding_window": 4096,
                  "max_window_layers": 28, "layer_types": None,
                  "attention_dropout": 0.0, "decoder_sparse_step": 1,
                  "moe_intermediate_size": 1408,
                  "shared_expert_intermediate_size": 5632,
                  "num_experts_per_tok": 4, "num_experts": 60,
                  "norm_topk_prob": False, "router_aux_loss_coef": 0.001,
                  "mlp_only_layers": None},
    "gemma": {"vocab_size": 256000, "hidden_size": 3072,
              "intermediate_size": 24576, "num_hidden_layers": 28,
              "num_attention_heads": 16, "num_key_value_heads": 16,
              "head_dim": 256, "hidden_act": "gelu_pytorch_tanh",
              "hidden_activation": None, "max_position_embeddings": 8192,
              "rms_norm_eps": 1e-06, "tie_word_embeddings": True,
              "rope_theta": 10000.0, "attention_bias": False,
              "attention_dropout": 0.0},
    "gemma2": {"vocab_size": 256000, "hidden_size": 2304,
               "intermediate_size": 9216, "num_hidden_layers": 26,
               "num_attention_heads": 8, "num_key_value_heads": 4,
               "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
               "max_position_embeddings": 8192, "rms_norm_eps": 1e-06,
               "tie_word_embeddings": True, "rope_theta": 10000.0,
               "attention_bias": False, "attention_dropout": 0.0,
               "query_pre_attn_scalar": 256, "sliding_window": 4096,
               "layer_types": None, "final_logit_softcapping": 30.0,
               "attn_logit_softcapping": 50.0},
    "gemma3_text": {"vocab_size": 262208, "hidden_size": 2304,
                    "intermediate_size": 9216, "num_hidden_layers": 26,
                    "num_attention_heads": 8, "num_key_value_heads": 4,
                    "head_dim": 256, "hidden_activation": "gelu_pytorch_tanh",
                    "max_position_embeddings": 131072, "rms_norm_eps": 1e-06,
                    "tie_word_embeddings": True, "rope_theta": 1000000.0,
                    "attention_bias": False, "attention_dropout": 0.0,
                    "query_pre_attn_scalar": 256, "sliding_window": 4096,
                    "layer_types": None, "final_logit_softcapping": None,
                    "attn_logit_softcapping": None, "rope_scaling": None,
                    "rope_local_base_freq": 10000.0,
                    "use_bidirectional_attention": False},
    "gemma3": {"text_config": None},
    "gpt_neox": {"vocab_size": 50432, "hidden_size": 6144,
                 "num_hidden_layers": 44, "num_attention_heads": 64,
                 "intermediate_size": 24576, "hidden_act": "gelu",
                 "rotary_pct": 0.25, "rotary_emb_base": 10000,
                 "attention_dropout": 0.0, "hidden_dropout": 0.0,
                 "max_position_embeddings": 2048, "layer_norm_eps": 1e-05,
                 "tie_word_embeddings": False, "use_parallel_residual": True,
                 "rope_scaling": None, "attention_bias": True},
    "phi": {"vocab_size": 51200, "hidden_size": 2048,
            "intermediate_size": 8192, "num_hidden_layers": 24,
            "num_attention_heads": 32, "num_key_value_heads": None,
            "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attention_dropout": 0.0,
            "hidden_act": "gelu_new", "max_position_embeddings": 2048,
            "layer_norm_eps": 1e-05, "tie_word_embeddings": False, **_ROPE,
            "partial_rotary_factor": 0.5, "qk_layernorm": False},
    "olmo": {"vocab_size": 50304, "hidden_size": 4096,
             "intermediate_size": 11008, "num_hidden_layers": 32,
             "num_attention_heads": 32, "num_key_value_heads": None,
             "hidden_act": "silu", "max_position_embeddings": 2048,
             "tie_word_embeddings": False, **_ROPE, "attention_bias": False,
             "attention_dropout": 0.0, "clip_qkv": None},
    "olmo2": {"vocab_size": 50304, "hidden_size": 4096,
              "intermediate_size": 11008, "num_hidden_layers": 32,
              "num_attention_heads": 32, "num_key_value_heads": None,
              "hidden_act": "silu", "max_position_embeddings": 2048,
              "tie_word_embeddings": False, **_ROPE, "attention_bias": False,
              "attention_dropout": 0.0, "rms_norm_eps": 1e-05},
    "stablelm": {"vocab_size": 50304, "intermediate_size": 6912,
                 "hidden_size": 2560, "num_hidden_layers": 32,
                 "num_attention_heads": 32, "num_key_value_heads": 32,
                 "hidden_act": "silu", "max_position_embeddings": 4096,
                 "layer_norm_eps": 1e-05, "tie_word_embeddings": False,
                 "rope_theta": 10000, "rope_scaling": None,
                 "use_qkv_bias": False, "qk_layernorm": False,
                 "use_parallel_residual": False, "hidden_dropout": 0.0,
                 "attention_dropout": 0.0, "partial_rotary_factor": 0.25},
    "gptj": {"vocab_size": 50400, "n_positions": 2048, "n_embd": 4096,
             "n_layer": 28, "n_head": 16, "rotary_dim": 64, "n_inner": None,
             "activation_function": "gelu_new", "resid_pdrop": 0.0,
             "embd_pdrop": 0.0, "attn_pdrop": 0.0,
             "layer_norm_epsilon": 1e-05, "tie_word_embeddings": False},
    "falcon": {"vocab_size": 65024, "hidden_size": 4544,
               "num_hidden_layers": 32, "num_attention_heads": 71,
               "num_ln_in_parallel_attn": None, "layer_norm_epsilon": 1e-05,
               "hidden_dropout": 0.0, "attention_dropout": 0.0,
               "num_kv_heads": None, "alibi": False,
               "new_decoder_architecture": False, "multi_query": True,
               "parallel_attn": True, "bias": False,
               "max_position_embeddings": 2048, **_ROPE,
               "ffn_hidden_size": None, "activation": "gelu"},
    "gpt_bigcode": {"vocab_size": 50257, "n_positions": 1024, "n_embd": 768,
                    "n_layer": 12, "n_head": 12, "n_inner": None,
                    "activation_function": "gelu_pytorch_tanh",
                    "resid_pdrop": 0.1, "embd_pdrop": 0.1, "attn_pdrop": 0.1,
                    "layer_norm_epsilon": 1e-05, "scale_attn_weights": True,
                    "multi_query": True},
    "opt": {"vocab_size": 50272, "hidden_size": 768, "num_hidden_layers": 12,
            "ffn_dim": 3072, "max_position_embeddings": 2048,
            "do_layer_norm_before": True, "word_embed_proj_dim": None,
            "dropout": 0.1, "attention_dropout": 0.0,
            "num_attention_heads": 12, "activation_function": "relu",
            "enable_bias": True},
    "bloom": {"vocab_size": 250880, "hidden_size": 64, "n_layer": 2,
              "n_head": 8, "layer_norm_epsilon": 1e-05,
              "apply_residual_connection_post_layernorm": False,
              "hidden_dropout": 0.0, "attention_dropout": 0.0},
    "mpt": {"d_model": 2048, "n_heads": 16, "n_layers": 24,
            "expansion_ratio": 4, "max_seq_len": 2048, "vocab_size": 50368,
            "resid_pdrop": 0.0, "layer_norm_epsilon": 1e-05,
            "emb_pdrop": 0.0, "attn_config": None, "no_bias": True},
}

# MptAttentionConfig's defaults (MPT's nested ``attn_config``).
_MPT_ATTN_DEFAULTS = {"attn_type": "multihead_attention", "attn_pdrop": 0,
                      "attn_impl": "torch", "clip_qkv": None,
                      "softmax_scale": None, "prefix_lm": False,
                      "qk_ln": False, "attn_uses_sequence_id": False,
                      "alibi": True, "alibi_bias_max": 8}

_ATTRIBUTE_MAPS = {
    "gpt2": {"hidden_size": "n_embd", "max_position_embeddings":
             "n_positions", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "gptj": {"max_position_embeddings": "n_positions",
             "hidden_size": "n_embd", "num_attention_heads": "n_head",
             "num_hidden_layers": "n_layer"},
    "gpt_bigcode": {"hidden_size": "n_embd", "max_position_embeddings":
                    "n_positions", "num_attention_heads": "n_head",
                    "num_hidden_layers": "n_layer"},
    "bloom": {"num_hidden_layers": "n_layer", "num_attention_heads": "n_head"},
    "mpt": {"num_attention_heads": "n_heads", "hidden_size": "d_model",
            "num_hidden_layers": "n_layers"},
}


class HFConfig:
    """Config attributes with transformers' ``attribute_map`` aliases
    (reads and writes) and ``get_text_config``; an attribute that is
    neither set nor aliased raises AttributeError, so a DSL function's
    ``getattr(cfg, key, default)`` falls back as it would there."""

    def __init__(self, values: dict, attribute_map: Optional[dict] = None):
        object.__setattr__(self, "_attribute_map", dict(attribute_map or {}))
        for key, value in values.items():
            setattr(self, key, value)

    def __setattr__(self, name, value):
        object.__setattr__(self, self._attribute_map.get(name, name), value)

    def __getattr__(self, name):  # only when ordinary lookup fails
        amap = object.__getattribute__(self, "_attribute_map")
        if name in amap:
            return getattr(self, amap[name])
        raise AttributeError(name)

    def get_text_config(self):
        text = self.__dict__.get("text_config")
        return text if text is not None else self


def _kv_heads(cfg):
    if getattr(cfg, "num_key_value_heads", None) is None:
        cfg.num_key_value_heads = cfg.num_attention_heads


def _rope_type(cfg):
    scaling = getattr(cfg, "rope_scaling", None)
    if scaling is not None and "type" in scaling:
        scaling["rope_type"] = scaling["type"]


def _llama(cfg, raw):
    _kv_heads(cfg)
    if cfg.head_dim is None:
        cfg.head_dim = cfg.hidden_size // cfg.num_attention_heads
    _rope_type(cfg)


def _phi3(cfg, raw):
    _kv_heads(cfg)
    scaling = cfg.rope_scaling
    if scaling is not None and scaling.get("type") in ("su", "yarn"):
        scaling["type"] = "longrope"


def _qwen(cfg, raw):
    if not cfg.use_sliding_window:
        cfg.sliding_window = None
    _kv_heads(cfg)
    _rope_type(cfg)
    if cfg.layer_types is None:
        cfg.layer_types = [
            "sliding_attention" if cfg.sliding_window is not None
            and i >= cfg.max_window_layers else "full_attention"
            for i in range(cfg.num_hidden_layers)]


def _gemma2(cfg, raw):
    if cfg.layer_types is None:
        cfg.layer_types = ["sliding_attention" if (i + 1) % 2
                           else "full_attention"
                           for i in range(cfg.num_hidden_layers)]


def _gemma3_text(cfg, raw):
    if cfg.use_bidirectional_attention:
        cfg.sliding_window = cfg.sliding_window // 2 + 1
    pattern = raw.get("sliding_window_pattern", 6)
    if cfg.layer_types is None:
        cfg.layer_types = ["sliding_attention" if (i + 1) % pattern
                           else "full_attention"
                           for i in range(cfg.num_hidden_layers)]


def _gemma3(cfg, raw):
    text = cfg.text_config
    if not isinstance(text, HFConfig):
        text = dict(text or {}, model_type="gemma3_text")
        cfg.text_config = from_dict(text)


def _neox(cfg, raw):
    cfg.partial_rotary_factor = cfg.rotary_pct
    cfg.rope_theta = cfg.rotary_emb_base
    _rope_type(cfg)


def _falcon(cfg, raw):
    # ffn_hidden_size follows the hidden_size argument, not n_embed
    hidden = raw.get("hidden_size", _DEFAULTS["falcon"]["hidden_size"])
    if raw.get("n_embed") is not None:
        cfg.hidden_size = raw["n_embed"]
    if cfg.num_kv_heads is None:
        cfg.num_kv_heads = cfg.num_attention_heads
    if cfg.ffn_hidden_size is None:
        cfg.ffn_hidden_size = hidden * 4
    # properties of FalconConfig
    cfg.head_dim = cfg.hidden_size // cfg.num_attention_heads
    cfg.rotary = not cfg.alibi


def _bigcode(cfg, raw):
    cfg.num_key_value_heads = 1 if cfg.multi_query else cfg.n_head


def _opt(cfg, raw):
    if cfg.word_embed_proj_dim is None:
        cfg.word_embed_proj_dim = cfg.hidden_size


def _bloom(cfg, raw):
    if raw.get("n_embed") is not None:
        cfg.hidden_size = raw["n_embed"]


def _mpt(cfg, raw):
    cfg.attn_config = dict(_MPT_ATTN_DEFAULTS, **(cfg.attn_config or {}))


_DERIVE: dict[str, Callable] = {
    "llama": _llama, "mistral": lambda c, r: _kv_heads(c), "phi3": _phi3,
    "mixtral": lambda c, r: _kv_heads(c),
    "qwen2": _qwen, "qwen3": _qwen, "qwen2_moe": _qwen, "gemma2": _gemma2,
    "gemma3_text": _gemma3_text, "gemma3": _gemma3, "gpt_neox": _neox,
    "phi": lambda c, r: (_kv_heads(c), _rope_type(c)),
    "olmo": lambda c, r: _kv_heads(c), "olmo2": lambda c, r: _kv_heads(c),
    "stablelm": lambda c, r: _rope_type(c), "falcon": _falcon,
    "gpt_bigcode": _bigcode, "opt": _opt, "bloom": _bloom, "mpt": _mpt,
}


def from_dict(raw: dict) -> HFConfig:
    """The config a ``config.json`` dict gives, defaults and derivations
    applied for a known ``model_type``."""
    model_type = raw.get("model_type")
    if not model_type:
        raise ValueError("config.json has no model_type")
    if model_type not in _DEFAULTS:
        return HFConfig(raw)
    values = dict(_BASE_DEFAULTS, **_DEFAULTS[model_type])
    cfg = HFConfig(values, _ATTRIBUTE_MAPS.get(model_type))
    for key, value in raw.items():
        if key != "n_embed":  # a legacy alias the derivations resolve
            setattr(cfg, key, value)
    derive = _DERIVE.get(model_type)
    if derive is not None:
        derive(cfg, raw)
    return cfg


def load(local_dir: str) -> HFConfig:
    """The checkpoint directory's ``config.json``, read as above."""
    path = os.path.join(local_dir, "config.json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no config.json in {local_dir}")
    with open(path) as f:
        return from_dict(json.load(f))
