"""The port's HuggingFace import against the JAX package's, family by
family, from checkpoints that ``transformers`` writes here (offline):

- the port's DSL equals ``Mapper.from_hf_config`` over
  ``transformers.AutoConfig``, for the ``config.json`` that
  ``save_pretrained`` writes and for a minimal one (the dims a published
  config holds, every other value left to the family's defaults), and the
  refusals raise the same ValueError;
- the mapped parameters are bitwise equal to the JAX package's (bf16),
  the MoE families' stacked experts included;
- with both packages' parameters cast to fp32, the logits agree within
  1e-4 (the same fp32 math summed in another order) and the first 8
  greedy tokens are equal;
- the port's safetensors reader equals ``safetensors.numpy.load_file`` on
  every dtype it reads (floating ones widened to float32), and the JAX
  package's loader on the sharded, subfolder and unprefixed layouts; a
  name that is not a directory is a ValueError.
"""

import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models import hf_loader as jloader
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models import hf_config, hf_loader
from penroz_tpu_torch.models.dsl import Mapper
from penroz_tpu_torch.models.model import NeuralNetworkModel
from penroz_tpu_torch.utils import checkpoint as tckpt

transformers = pytest.importorskip("transformers")

PROMPT = [3, 17, 42, 8, 11]
TOKENS = np.array([[3, 17, 42, 8, 11, 60, 2, 33, 71, 5, 9, 24]], np.int64)
LOGITS_ATOL = 1e-4
GREEDY_NEW = 8


@pytest.fixture
def port_dir(workdir, monkeypatch):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return workdir


# (model_type, config class name, model class name, config kwargs, seed)
FAMILIES = {
    "gpt2": ("GPT2Config", "GPT2LMHeadModel", dict(
        vocab_size=96, n_positions=32, n_embd=16, n_layer=2, n_head=2,
        activation_function="gelu_new", resid_pdrop=0.0, embd_pdrop=0.0,
        attn_pdrop=0.0), 0),
    "llama": ("LlamaConfig", "LlamaForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=4,
        intermediate_size=32, max_position_embeddings=64,
        rope_scaling={"rope_type": "llama3", "factor": 8.0,
                      "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                      "original_max_position_embeddings": 16},
        tie_word_embeddings=False), 0),
    "mistral": ("MistralConfig", "MistralForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=4,
        intermediate_size=32, max_position_embeddings=128,
        sliding_window=8, tie_word_embeddings=False), 0),
    "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        pad_token_id=0, tie_word_embeddings=False), 0),
    "qwen2": ("Qwen2Config", "Qwen2ForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, intermediate_size=32,
        max_position_embeddings=64, use_sliding_window=True,
        sliding_window=6, max_window_layers=1, tie_word_embeddings=True),
        0),
    "qwen3": ("Qwen3Config", "Qwen3ForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=64, max_position_embeddings=64,
        rope_theta=1e6, tie_word_embeddings=True), 0),
    "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        intermediate_size=32, max_position_embeddings=64), 3),
    "gemma2": ("Gemma2Config", "Gemma2ForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        intermediate_size=32, max_position_embeddings=64,
        attn_logit_softcapping=2.0, final_logit_softcapping=1.5,
        query_pre_attn_scalar=64, sliding_window=6,
        hidden_activation="gelu_pytorch_tanh"), 5),
    "gemma3_text": ("Gemma3TextConfig", "Gemma3ForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, head_dim=8,
        intermediate_size=32, max_position_embeddings=64,
        rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
        rope_scaling={"rope_type": "linear", "factor": 8.0},
        sliding_window=6, sliding_window_pattern=2,
        query_pre_attn_scalar=64,
        hidden_activation="gelu_pytorch_tanh"), 7),
    "gpt_neox": ("GPTNeoXConfig", "GPTNeoXForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64, rotary_pct=0.25,
        max_position_embeddings=64, tie_word_embeddings=False), 0),
    "phi": ("PhiConfig", "PhiForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        partial_rotary_factor=0.5, max_position_embeddings=64), 0),
    "olmo": ("OlmoConfig", "OlmoForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        max_position_embeddings=64, clip_qkv=0.5, pad_token_id=0,
        eos_token_id=1), 0),
    "olmo2": ("Olmo2Config", "Olmo2ForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        max_position_embeddings=64, pad_token_id=0, eos_token_id=1), 0),
    "stablelm": ("StableLmConfig", "StableLmForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, num_key_value_heads=1, intermediate_size=64,
        partial_rotary_factor=0.5, max_position_embeddings=64,
        use_qkv_bias=True), 0),
    "gptj": ("GPTJConfig", "GPTJForCausalLM", dict(
        vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2,
        rotary_dim=8, bos_token_id=0, eos_token_id=1), 0),
    "falcon": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, max_position_embeddings=64,
        bos_token_id=0, eos_token_id=1), 0),
    "falcon_new_arch": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, new_decoder_architecture=True,
        num_kv_heads=2, max_position_embeddings=64, bos_token_id=0,
        eos_token_id=1), 0),
    "falcon_rw": ("FalconConfig", "FalconForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=4, alibi=True, multi_query=False,
        parallel_attn=False, bias=True, bos_token_id=0, eos_token_id=1),
        21),
    "gpt_bigcode": ("GPTBigCodeConfig", "GPTBigCodeForCausalLM", dict(
        vocab_size=96, n_positions=64, n_embd=32, n_layer=2, n_head=2,
        attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0, bos_token_id=0,
        eos_token_id=1), 0),
    "opt": ("OPTConfig", "OPTForCausalLM", dict(
        vocab_size=96, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, ffn_dim=64, max_position_embeddings=64,
        dropout=0.0, pad_token_id=1, bos_token_id=2, eos_token_id=2), 11),
    "bloom": ("BloomConfig", "BloomForCausalLM", dict(
        vocab_size=96, hidden_size=32, n_layer=2, n_head=4), 13),
    "mpt": ("MptConfig", "MptForCausalLM", dict(
        d_model=32, n_heads=4, n_layers=2, vocab_size=96,
        attn_config={"alibi": True, "clip_qkv": 4.0}), 17),
    "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=4,
        intermediate_size=24, num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, tie_word_embeddings=False), 0),
    "qwen2_moe": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=4,
        intermediate_size=32, moe_intermediate_size=8,
        shared_expert_intermediate_size=24, num_experts=6,
        num_experts_per_tok=3, max_position_embeddings=64,
        tie_word_embeddings=False), 0),
    "qwen2_moe_norm_topk": ("Qwen2MoeConfig", "Qwen2MoeForCausalLM", dict(
        vocab_size=96, hidden_size=16, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2,
        intermediate_size=32, moe_intermediate_size=8,
        shared_expert_intermediate_size=24, num_experts=6,
        num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=64, tie_word_embeddings=False), 0),
}

# A config.json with only the dims a published config names: every other
# value is the family's default (models/hf_config.py).
MINIMAL = {
    "gpt2": {"model_type": "gpt2", "n_embd": 64, "n_layer": 2, "n_head": 4,
             "vocab_size": 128},
    "llama": {"model_type": "llama", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "vocab_size": 128},
    "mistral": {"model_type": "mistral", "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "intermediate_size": 128,
                "vocab_size": 128},
    "phi3": {"model_type": "phi3", "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 128, "vocab_size": 128},
    "qwen2": {"model_type": "qwen2", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "intermediate_size": 128,
              "vocab_size": 128, "use_sliding_window": True,
              "max_window_layers": 1, "sliding_window": 32},
    # Qwen/Qwen3-0.6B's config.json at a smaller depth
    "qwen3": {"model_type": "qwen3", "hidden_size": 1024,
              "num_hidden_layers": 2, "num_attention_heads": 16,
              "num_key_value_heads": 8, "head_dim": 128,
              "intermediate_size": 3072, "vocab_size": 151936,
              "rope_theta": 1000000, "rms_norm_eps": 1e-06,
              "tie_word_embeddings": True, "use_sliding_window": False,
              "sliding_window": None, "max_window_layers": 28,
              "rope_scaling": None, "attention_bias": False},
    "gemma": {"model_type": "gemma", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "intermediate_size": 128, "vocab_size": 128},
    "gemma2": {"model_type": "gemma2", "hidden_size": 64,
               "num_hidden_layers": 3, "num_attention_heads": 4,
               "intermediate_size": 128, "vocab_size": 128},
    "gemma3_text": {"model_type": "gemma3_text", "hidden_size": 64,
                    "num_hidden_layers": 7, "num_attention_heads": 4,
                    "intermediate_size": 128, "vocab_size": 128,
                    "rope_scaling": {"rope_type": "linear", "factor": 8.0}},
    "gemma3": {"model_type": "gemma3", "text_config": {
        "hidden_size": 64, "num_hidden_layers": 7,
        "num_attention_heads": 4, "intermediate_size": 128,
        "vocab_size": 128, "sliding_window_pattern": 3}},
    "gpt_neox": {"model_type": "gpt_neox", "hidden_size": 64,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "vocab_size": 128, "rotary_emb_base": 5000,
                 "rope_theta": 777},
    "phi": {"model_type": "phi", "hidden_size": 64, "num_hidden_layers": 2,
            "num_attention_heads": 4, "vocab_size": 128},
    "olmo": {"model_type": "olmo", "hidden_size": 64,
             "num_hidden_layers": 2, "num_attention_heads": 4,
             "vocab_size": 128},
    "olmo2": {"model_type": "olmo2", "hidden_size": 64,
              "num_hidden_layers": 2, "num_attention_heads": 4,
              "vocab_size": 128},
    "stablelm": {"model_type": "stablelm", "hidden_size": 64,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "vocab_size": 128},
    "gptj": {"model_type": "gptj", "n_embd": 64, "n_layer": 2,
             "n_head": 4, "vocab_size": 128, "rotary_dim": 8},
    "falcon": {"model_type": "falcon", "hidden_size": 64,
               "num_hidden_layers": 2, "num_attention_heads": 4,
               "vocab_size": 128},
    "falcon_n_embed": {"model_type": "falcon", "n_embed": 64,
                       "n_layer": 2, "num_hidden_layers": 2,
                       "n_head": 4, "num_attention_heads": 4,
                       "new_decoder_architecture": True,
                       "num_kv_heads": 2, "vocab_size": 128},
    "gpt_bigcode": {"model_type": "gpt_bigcode", "n_embd": 64,
                    "n_layer": 2, "n_head": 4, "vocab_size": 128},
    "opt": {"model_type": "opt", "hidden_size": 64,
            "num_hidden_layers": 2, "num_attention_heads": 4,
            "vocab_size": 128},
    "bloom": {"model_type": "bloom", "n_embed": 64, "n_layer": 2,
              "num_attention_heads": 4, "vocab_size": 128},
    "mpt": {"model_type": "mpt", "d_model": 64, "n_layers": 2,
            "n_heads": 4, "vocab_size": 128},
    "mixtral": {"model_type": "mixtral", "hidden_size": 64,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "intermediate_size": 128,
                "vocab_size": 128},
    # Qwen/Qwen1.5-MoE-A2.7B's config.json at a smaller depth
    "qwen2_moe": {"model_type": "qwen2_moe", "hidden_size": 2048,
                  "num_hidden_layers": 2, "num_attention_heads": 16,
                  "num_key_value_heads": 16, "intermediate_size": 5632,
                  "moe_intermediate_size": 1408,
                  "shared_expert_intermediate_size": 5632,
                  "num_experts": 60, "num_experts_per_tok": 4,
                  "norm_topk_prob": False, "decoder_sparse_step": 1,
                  "vocab_size": 151936, "max_position_embeddings": 8192,
                  "rope_theta": 1000000.0, "rms_norm_eps": 1e-06,
                  "tie_word_embeddings": False,
                  "router_aux_loss_coef": 0.001,
                  "use_sliding_window": False},
}

# Configs each package must refuse with the same ValueError.
REFUSED = {
    "llama_yarn": {"model_type": "llama", "hidden_size": 64,
                   "num_hidden_layers": 2, "num_attention_heads": 4,
                   "intermediate_size": 128, "vocab_size": 128,
                   "rope_scaling": {"rope_type": "yarn", "factor": 4.0,
                                    "original_max_position_embeddings":
                                        64}},
    "llama_mlp_bias": {"model_type": "llama", "hidden_size": 64,
                       "num_hidden_layers": 2, "num_attention_heads": 4,
                       "intermediate_size": 128, "vocab_size": 128,
                       "mlp_bias": True},
    "phi3_longrope": {"model_type": "phi3", "hidden_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "intermediate_size": 128, "vocab_size": 128,
                      "rope_scaling": {"type": "su",
                                       "short_factor": [1.0] * 8,
                                       "long_factor": [1.0] * 8}},
    "neox_scaling": {"model_type": "gpt_neox", "hidden_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "vocab_size": 128, "rope_scaling": {"rope_type":
                                                         "linear",
                                                         "factor": 2.0}},
    "phi_qk_layernorm": {"model_type": "phi", "hidden_size": 64,
                         "num_hidden_layers": 2, "num_attention_heads": 4,
                         "vocab_size": 128, "qk_layernorm": True},
    "phi_tied": {"model_type": "phi", "hidden_size": 64,
                 "num_hidden_layers": 2, "num_attention_heads": 4,
                 "vocab_size": 128, "tie_word_embeddings": True},
    "gptj_tied": {"model_type": "gptj", "n_embd": 64, "n_layer": 2,
                  "n_head": 4, "vocab_size": 128,
                  "tie_word_embeddings": True},
    "olmo2_scaling": {"model_type": "olmo2", "hidden_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "vocab_size": 128, "rope_scaling": {
                          "type": "linear", "factor": 2.0}},
    "stablelm_parallel": {"model_type": "stablelm", "hidden_size": 64,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "vocab_size": 128, "use_parallel_residual": True},
    "stablelm_qk_layernorm": {"model_type": "stablelm", "hidden_size": 64,
                              "num_hidden_layers": 2,
                              "num_attention_heads": 4, "vocab_size": 128,
                              "qk_layernorm": True},
    "falcon_sequential": {"model_type": "falcon", "hidden_size": 64,
                          "num_hidden_layers": 2, "num_attention_heads": 4,
                          "vocab_size": 128, "parallel_attn": False},
    "falcon_alibi_mq": {"model_type": "falcon", "hidden_size": 64,
                        "num_hidden_layers": 2, "num_attention_heads": 4,
                        "vocab_size": 128, "alibi": True},
    "falcon_one_ln": {"model_type": "falcon", "hidden_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "vocab_size": 128, "new_decoder_architecture": True,
                      "num_ln_in_parallel_attn": 1},
    "bigcode_unscaled": {"model_type": "gpt_bigcode", "n_embd": 64,
                         "n_layer": 2, "n_head": 4, "vocab_size": 128,
                         "scale_attn_weights": False},
    "opt_post_norm": {"model_type": "opt", "hidden_size": 64,
                      "num_hidden_layers": 2, "num_attention_heads": 4,
                      "vocab_size": 128, "do_layer_norm_before": False},
    "opt_proj_dim": {"model_type": "opt", "hidden_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "vocab_size": 128, "word_embed_proj_dim": 32},
    "opt_gelu_new": {"model_type": "opt", "hidden_size": 64,
                     "num_hidden_layers": 2, "num_attention_heads": 4,
                     "vocab_size": 128, "activation_function": "silu"},
    "bloom_post_ln": {"model_type": "bloom", "n_embed": 64, "n_layer": 2,
                      "num_attention_heads": 4, "vocab_size": 128,
                      "apply_residual_connection_post_layernorm": True},
    "mpt_no_alibi": {"model_type": "mpt", "d_model": 64, "n_layers": 2,
                     "n_heads": 4, "vocab_size": 128,
                     "attn_config": {"alibi": False}},
    "mpt_qk_ln": {"model_type": "mpt", "d_model": 64, "n_layers": 2,
                  "n_heads": 4, "vocab_size": 128,
                  "attn_config": {"qk_ln": True}},
    "mpt_softmax_scale": {"model_type": "mpt", "d_model": 64,
                          "n_layers": 2, "n_heads": 4, "vocab_size": 128,
                          "attn_config": {"softmax_scale": 0.5}},
    "mpt_six_heads": {"model_type": "mpt", "d_model": 96, "n_layers": 2,
                      "n_heads": 6, "vocab_size": 128},
    "gemma3n": {"model_type": "gemma3n"},
    "qwen2_moe_sparse_step": {"model_type": "qwen2_moe", "hidden_size": 64,
                              "num_hidden_layers": 2,
                              "num_attention_heads": 4, "vocab_size": 128,
                              "decoder_sparse_step": 2},
    "qwen2_moe_mlp_only": {"model_type": "qwen2_moe", "hidden_size": 64,
                           "num_hidden_layers": 2, "num_attention_heads": 4,
                           "vocab_size": 128, "mlp_only_layers": [1]},
}


def _write_config(tmp, name, values) -> str:
    path = os.path.join(str(tmp), f"cfg_{name}")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(values, f)
    return path


def _outcome(build):
    try:
        return "dsl", build()
    except ValueError as e:
        return "refused", str(e)


def _dsl_pair(path, n_layer=None):
    """(JAX outcome over AutoConfig, port outcome over hf_config)."""
    jcfg = transformers.AutoConfig.from_pretrained(path)
    tcfg = hf_config.load(path)
    return (_outcome(lambda: JMapper.from_hf_config(jcfg, n_layer)),
            _outcome(lambda: Mapper.from_hf_config(tcfg, n_layer)))


@pytest.mark.parametrize("name", sorted(MINIMAL))
def test_dsl_from_minimal_config_matches_jax(tmp_path, name):
    jax_dsl, port_dsl = _dsl_pair(_write_config(tmp_path, name,
                                                MINIMAL[name]))
    assert jax_dsl[0] == "dsl", jax_dsl
    assert port_dsl == jax_dsl


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refusals_match_jax(tmp_path, name):
    jax_out, port_out = _dsl_pair(_write_config(tmp_path, name,
                                                REFUSED[name]))
    assert jax_out[0] == "refused", jax_out
    assert port_out == jax_out


def test_gemma4_dims_only_surface_matches_jax(tmp_path):
    """A gemma type transformers does not know: the DSL function reads the
    config as written (KV-shared layers with double-wide MLPs, per-type
    head dims and kv heads)."""
    raw = {"model_type": "gemma4", "hidden_size": 32,
           "num_hidden_layers": 4, "num_attention_heads": 4,
           "num_key_value_heads": 2, "head_dim": 8, "global_head_dim": 16,
           "num_global_key_value_heads": 1, "intermediate_size": 64,
           "vocab_size": 96, "num_kv_shared_layers": 2,
           "use_double_wide_mlp": True, "sliding_window": 16,
           "layer_types": ["sliding_attention", "full_attention"] * 2,
           "rope_theta": 1e6, "rope_local_base_freq": 1e4}
    port = Mapper.from_hf_config(hf_config.load(
        _write_config(tmp_path, "gemma4", raw)))
    assert port == JMapper.from_hf_config(types.SimpleNamespace(**raw))


@pytest.mark.parametrize("model_type", ["mixtral", "qwen2_moe"])
def test_moe_families_refused_naming_the_algo(tmp_path, model_type):
    """The MoE families were refused naming the ``moe`` algo; now they
    build it: the DSL equals the JAX package's over AutoConfig, each MLP
    a ``moe`` entry (dense dispatch) with the aux coefficient rescaled by
    top_k / n_layers."""
    raw = {"model_type": model_type, "hidden_size": 64,
           "num_hidden_layers": 2, "num_attention_heads": 4,
           "intermediate_size": 128, "vocab_size": 128}
    jax_dsl, port_dsl = _dsl_pair(_write_config(tmp_path, model_type, raw))
    assert port_dsl == jax_dsl and port_dsl[0] == "dsl"
    moes = [b["transformerblock"]["mlp_block"]["sequential"][1]["moe"]
            for b in port_dsl[1][1:3]]
    assert len(moes) == 2 and all("dispatch" not in m for m in moes)
    assert moes[0]["aux_loss_coef"] == pytest.approx(
        0.001 * moes[0]["top_k"] / 2)


def test_unknown_model_type_refused(tmp_path):
    cfg = hf_config.load(_write_config(tmp_path, "t5", {"model_type": "t5"}))
    with pytest.raises(ValueError, match="Unsupported HuggingFace model "
                                         "type: t5"):
        Mapper.from_hf_config(cfg)


def test_qwen3_config_defaults(tmp_path):
    """The values a wrong default would silently change: the published
    Qwen3-0.6B keys give 28 full-attention layers (no window), head_dim
    128 and GQA 16/8; without ``head_dim`` the family default is 128."""
    raw = dict(MINIMAL["qwen3"], num_hidden_layers=28)
    cfg = hf_config.load(_write_config(tmp_path, "q3", raw))
    assert cfg.layer_types == ["full_attention"] * 28
    assert cfg.sliding_window is None and cfg.head_dim == 128
    dsl = Mapper.from_hf_config(cfg)
    attn = dsl[1]["transformerblock"]["attn_block"]["sequential"][2]
    assert attn["attention"] == {
        "num_heads": 16, "num_kv_heads": 8, "rope_theta": 1e6,
        "head_dim": 128, "dropout": 0.0, "qk_norm": True,
        "qk_norm_eps": 1e-6}
    raw.pop("head_dim")
    assert hf_config.load(_write_config(tmp_path, "q3b", raw)).head_dim == 128


# ---------------------------------------------------------------------------
# Whole imports, family by family
# ---------------------------------------------------------------------------

def _checkpoint(tmp, family) -> str:
    cfg_name, model_name, kwargs, seed = FAMILIES[family]
    config = getattr(transformers, cfg_name)(**kwargs)
    torch.manual_seed(seed)
    model = getattr(transformers, model_name)(config).eval()
    path = os.path.join(str(tmp), f"hf_{family}")
    model.to(torch.bfloat16).save_pretrained(path, safe_serialization=True)
    return path


def _bits(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_import_matches_jax(port_dir, family):
    ckpt = _checkpoint(port_dir, family)
    jax_dsl, port_dsl = _dsl_pair(ckpt)
    assert port_dsl == jax_dsl and port_dsl[0] == "dsl"

    jm = JModel.from_huggingface(f"j_{family}", ckpt)
    tm = NeuralNetworkModel.from_huggingface(f"t_{family}", ckpt,
                                             device="cpu")
    assert tm.status == {"code": "Imported",
                         "message": f"Imported from {ckpt}"}
    assert tm.layers_dsl == jm.layers_dsl
    assert tm.dtype == torch.bfloat16
    tsd = tm.state_dict()
    assert set(tsd) == set(jm.params) | set(jm.buffers)
    for key, value in jm.params.items():
        np.testing.assert_array_equal(_bits(tsd[key]), _bits(value),
                                      err_msg=key)

    # fp32 casts of the same bf16 parameters
    jm.params = {k: v.astype(jnp.float32) for k, v in jm.params.items()}
    for p in tm.arch.parameters():
        p.data = p.data.float()
    acts, _, _, _ = jm.arch.jit_forward(jm.params, jm.buffers,
                                        jnp.asarray(TOKENS, jnp.int32),
                                        skip_softmax=True)
    with torch.no_grad():
        tacts, _, _ = tm.arch(torch.as_tensor(TOKENS), skip_softmax=True)
    np.testing.assert_allclose(tacts[-1].numpy(),
                               np.asarray(acts[-1], np.float32),
                               atol=LOGITS_ATOL, rtol=0)
    expected = jm.generate_tokens([PROMPT], 16, GREEDY_NEW, temperature=0)
    got = tm.generate_tokens([PROMPT], 16, GREEDY_NEW, temperature=0)
    assert got == expected and len(got) == len(PROMPT) + GREEDY_NEW


def test_import_key_and_shape_checks(port_dir):
    """A key the remap reads is missing: KeyError; an optional key the DSL
    wants is missing: the key-set KeyError; a wrong shape: ValueError —
    each as the JAX package raises it."""
    import ml_dtypes  # noqa: F401 — lets safetensors.numpy read BF16
    from safetensors.numpy import load_file, save_file
    ckpt = _checkpoint(port_dir, "gpt2")
    path = os.path.join(ckpt, "model.safetensors")
    sd = load_file(path)
    bias = "transformer.h.1.mlp.c_proj.bias"
    save_file({k: v for k, v in sd.items() if k != bias}, path)
    with pytest.raises(KeyError, match=bias):
        NeuralNetworkModel.from_huggingface("broken", ckpt, device="cpu")
    save_file(dict(sd, **{bias: np.zeros(5, sd[bias].dtype)}), path)
    for package in (JModel.from_huggingface,
                    lambda *a: NeuralNetworkModel.from_huggingface(
                        *a, device="cpu")):
        with pytest.raises(ValueError, match=r"Shape mismatch for "
                                             r"layers\.3\.1\.3\.bias: HF "
                                             r"\(5,\) vs model \(16,\)"):
            package("broken", ckpt)
    ckpt = _checkpoint(port_dir, "gpt_bigcode")
    path = os.path.join(ckpt, "model.safetensors")
    sd = load_file(path)
    save_file({k: v for k, v in sd.items()
               if k != "transformer.h.0.attn.c_attn.bias"}, path)
    for package in (JModel.from_huggingface,
                    lambda *a: NeuralNetworkModel.from_huggingface(
                        *a, device="cpu")):
        with pytest.raises(KeyError, match=r"HF state dict mismatch: "
                                           r"missing \['layers\.2\.0\.1"
                                           r"\.bias'\], unexpected \[\]"):
            package("broken", ckpt)


def test_hub_id_refused(port_dir):
    with pytest.raises(ValueError, match="only from a local checkpoint "
                                         "directory"):
        NeuralNetworkModel.from_huggingface("m", "Qwen/Qwen3-0.6B",
                                            device="cpu")


# ---------------------------------------------------------------------------
# The safetensors reader and the checkpoint layouts
# ---------------------------------------------------------------------------

def test_reader_matches_safetensors_on_every_dtype(tmp_path):
    import ml_dtypes  # noqa: F401 — lets safetensors.numpy read BF16
    from safetensors.numpy import load_file
    from safetensors.torch import save_file
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(4, 2, generator=g).half(),
        "bf16": torch.randn(2, 3, 4, generator=g).to(torch.bfloat16),
        "i64": torch.randint(-2 ** 40, 2 ** 40, (6,), generator=g),
        "i32": torch.randint(-2 ** 30, 2 ** 30, (2, 2), generator=g,
                             dtype=torch.int32),
        "u8": torch.randint(0, 256, (7,), generator=g, dtype=torch.uint8),
        "bool": torch.randint(0, 2, (3, 3), generator=g).bool(),
        "scalar": torch.tensor(2.5),
        "empty": torch.zeros(0, 4),
    }
    path = str(tmp_path / "all.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    ref = load_file(path)
    got = hf_loader.read_safetensors(path)
    assert set(got) == set(ref)
    for key, value in ref.items():
        assert got[key].shape == value.shape, key
        if value.dtype.kind in "fV":  # ml_dtypes' bfloat16 is kind V
            assert got[key].dtype == np.float32, key
            want = value.astype(np.float32)
        else:
            assert got[key].dtype == value.dtype, key
            want = value
        np.testing.assert_array_equal(got[key], want, err_msg=key)
    # widening is exact: the BF16 values' bits come back
    np.testing.assert_array_equal(
        got["bf16"].view(np.uint32) >> 16,
        ref["bf16"].view(np.uint16).astype(np.uint32))


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]),
                                      err_msg=key)


def _split_checkpoint(src, dst, sub=None, index=True):
    """Rewrite ``src``'s single file as two shards (with an index unless
    ``index`` is False), under ``dst``/``sub`` when given."""
    import shutil
    from safetensors.torch import load_file, save_file
    sd = load_file(os.path.join(src, "model.safetensors"))
    where = os.path.join(dst, sub) if sub else dst
    os.makedirs(where, exist_ok=True)
    shutil.copy(os.path.join(src, "config.json"),
                os.path.join(dst, "config.json"))
    keys = sorted(sd)
    shards = {"model-00001-of-00002.safetensors": keys[:len(keys) // 2],
              "model-00002-of-00002.safetensors": keys[len(keys) // 2:]}
    weight_map = {}
    for name, names in shards.items():
        save_file({k: sd[k] for k in names}, os.path.join(where, name))
        weight_map.update(dict.fromkeys(names, name))
    if index:
        with open(os.path.join(where, "model.safetensors.index.json"),
                  "w") as f:
            json.dump({"metadata": {}, "weight_map": weight_map}, f)


@pytest.mark.parametrize("layout", ["sharded", "loose", "subfolder_index",
                                    "subfolder_loose"])
def test_layouts_match_jax_loader(port_dir, layout):
    import ml_dtypes  # noqa: F401
    src = _checkpoint(port_dir, "qwen3")
    dst = str(port_dir / layout)
    sub = "weights" if layout.startswith("subfolder") else None
    _split_checkpoint(src, dst, sub, index=layout in ("sharded",
                                                      "subfolder_index"))
    port = hf_loader.load_state_dict(dst)
    _assert_same_state(port, jloader.load_state_dict(dst))
    _assert_same_state(port, hf_loader.load_state_dict(src))
    tm = NeuralNetworkModel.from_huggingface("sharded", dst, device="cpu")
    assert tm.status["code"] == "Imported"


def test_unprefixed_gpt2_checkpoint(port_dir):
    import ml_dtypes  # noqa: F401
    from safetensors.numpy import load_file, save_file
    ckpt = _checkpoint(port_dir, "gpt2")
    path = os.path.join(ckpt, "model.safetensors")
    sd = load_file(path)
    raw = {k.removeprefix("transformer."): v for k, v in sd.items()
           if not k.startswith("lm_head.")}
    raw["h.0.attn.bias"] = np.tril(np.ones((32, 32), np.float32))[None, None]
    save_file(raw, path)
    _assert_same_state(hf_loader.load_state_dict(ckpt),
                       jloader.load_state_dict(ckpt))
    tm = NeuralNetworkModel.from_huggingface("raw", ckpt, device="cpu")
    jm = JModel.from_huggingface("rawj", ckpt)
    for key, value in jm.params.items():
        np.testing.assert_array_equal(_bits(tm.state_dict()[key]),
                                      _bits(value), err_msg=key)


def test_bin_only_checkpoint(port_dir):
    """No safetensors: the torch ``.bin`` files, loaded weights-only."""
    from transformers import GPT2Config, GPT2LMHeadModel
    _, _, kwargs, _ = FAMILIES["gpt2"]
    torch.manual_seed(0)
    model = GPT2LMHeadModel(GPT2Config(**kwargs)).eval()
    ckpt = str(port_dir / "binonly")
    model.save_pretrained(ckpt, safe_serialization=False)
    sd = hf_loader.load_state_dict(ckpt)
    for key, value in model.state_dict().items():
        if key in sd:
            np.testing.assert_array_equal(sd[key], value.float().numpy())
    tm = NeuralNetworkModel.from_huggingface("bin", ckpt, device="cpu")
    assert tm.status["code"] == "Imported"
