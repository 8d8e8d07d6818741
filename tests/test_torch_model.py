"""The port's model runtime against the JAX package's on the same weights:
forward logits (atol 1e-4), greedy generation token for token across the
overflow crop and re-prefill (fp32 and int8 KV), streaming, stop tokens,
and sampling under a fixed generator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu_torch import device as tdevice
from penroz_tpu_torch.models import dsl as tdsl
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.models.model import CompiledArch, NeuralNetworkModel

PROMPT = [1, 2, 3, 4, 5]


@pytest.fixture
def pair(toy_gpt_layers, toy_optimizer):
    """(JAX model, port model) holding the same weights."""
    jm = JModel("j", JMapper(toy_gpt_layers, toy_optimizer))
    tm = from_jax_state_dict(jm.state_dict(), toy_gpt_layers, toy_optimizer,
                             device="cpu")
    return jm, tm


def test_state_dict_keys_match_jax(pair):
    jm, tm = pair
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert list(tsd) == list(jsd)
    for key in jsd:
        np.testing.assert_array_equal(tsd[key].numpy(), jsd[key])


def test_forward_logits_match_jax(pair):
    jm, tm = pair
    x = np.random.default_rng(0).integers(0, 64, (2, 12))
    acts, _, _, _ = jm.arch.forward(jm.params, jm.buffers,
                                    jnp.asarray(x, jnp.int32),
                                    skip_softmax=True)
    with torch.no_grad():
        tacts, _, _ = tm.arch(torch.as_tensor(x), skip_softmax=True)
    np.testing.assert_allclose(tacts[-1].numpy(), np.asarray(acts[-1]),
                               atol=1e-4)
    with torch.no_grad():
        probs, _, _ = tm.arch(torch.as_tensor(x))
    assert probs[-1].shape == (2, 64)


@pytest.mark.parametrize("turbo", ["0", "1"], ids=["fp32_kv", "int8_kv"])
def test_greedy_generation_matches_jax_across_crop(pair, monkeypatch,
                                                   turbo):
    # prompt 5 + 30 new tokens crosses block 16: crop + re-prefill
    monkeypatch.setenv("TURBO_QUANT_KV_CACHE", turbo)
    jm, tm = pair
    expected = jm.generate_tokens(PROMPT, 16, 30, temperature=0)
    got = tm.generate_tokens(PROMPT, 16, 30, temperature=0)
    assert got == expected
    assert len(got) == len(PROMPT) + 30


def test_stream_equals_non_stream_and_nested_input(pair):
    _, tm = pair
    full = tm.generate_tokens([PROMPT], 16, 20, temperature=0)
    streamed = list(tm.generate_tokens_stream(PROMPT, 16, 20,
                                              temperature=0))
    assert full == PROMPT + streamed


def test_stop_token_stops(pair):
    jm, tm = pair
    free = tm.generate_tokens(PROMPT, 16, 20, temperature=0)
    stop = free[len(PROMPT) + 3]
    first = free.index(stop, len(PROMPT))
    got = tm.generate_tokens(PROMPT, 16, 20, temperature=0, stop_token=stop)
    assert got == free[:first + 1]
    assert got == jm.generate_tokens(PROMPT, 16, 20, temperature=0,
                                     stop_token=stop)
    streamed = list(tm.generate_tokens_stream(PROMPT, 16, 20, temperature=0,
                                              stop_token=stop))
    assert streamed == got[len(PROMPT):]


def test_sampling_deterministic_under_fixed_generator(toy_gpt_layers,
                                                      toy_optimizer):
    jm = JModel("j", JMapper(toy_gpt_layers, toy_optimizer))
    runs = []
    for _ in range(2):
        tm = from_jax_state_dict(jm.state_dict(), toy_gpt_layers,
                                 toy_optimizer, device="cpu")
        runs.append(tm.generate_tokens(PROMPT, 16, 12, temperature=1.5,
                                       top_k=5))
    assert runs[0] == runs[1]
    assert all(0 <= t < 64 for t in runs[0])


def test_top_k_draws_stay_in_top_k_set():
    """The keyed draw of generation (seed and temperature as device
    scalars, as a captured step reads them): top-k draws stay in the
    top-k set, and top-1 is the argmax."""
    g = torch.Generator().manual_seed(3)
    logits = torch.randn(64, 50, generator=g)
    top = torch.topk(logits, 4, dim=-1).indices
    rows = torch.zeros(64, dtype=torch.int64)
    positions = torch.arange(64)
    for seed in range(5):
        tok = CompiledArch._sample_packed(logits, torch.tensor(seed), rows,
                                          positions, torch.tensor(2.0), 4)
        assert tok.shape == (64,)
        assert bool((tok[:, None] == top).any(dim=-1).all())
    one = CompiledArch._sample_packed(logits, torch.tensor(0), rows,
                                      positions, torch.tensor(1e-9), 1)
    assert torch.equal(one, logits.argmax(-1))


def test_bf16_model_generates(toy_gpt_layers, toy_optimizer):
    jm = JModel("j", JMapper(toy_gpt_layers, toy_optimizer)).to(jnp.bfloat16)
    tm = from_jax_state_dict(jm.state_dict(), toy_gpt_layers, toy_optimizer,
                             device="cpu")
    assert tm.dtype == torch.bfloat16
    out = tm.generate_tokens(PROMPT, 16, 8, temperature=0)
    assert len(out) == len(PROMPT) + 8 and all(0 <= t < 64 for t in out)


def test_port_init_builds_gpt2_keys_without_jax(toy_optimizer):
    layers = presets.gpt2_custom(d=32, heads=4, depth=2, vocab=64, block=16)
    a = NeuralNetworkModel("a", tdsl.Mapper(layers, toy_optimizer),
                           device="cpu", seed=7)
    b = NeuralNetworkModel("b", tdsl.Mapper(layers, toy_optimizer),
                           device="cpu", seed=7)
    for key, value in a.state_dict().items():
        assert torch.equal(value, b.state_dict()[key]), key
    # "zeros" override → zero biases; "normal" std 0.02 on the embedding
    assert not a.state_dict()["layers.2.0.1.bias"].any()
    assert abs(float(a.state_dict()["layers.0.0.weight"].std()) - 0.02) < 5e-3
    assert a.arch.kv_specs == [(4, 8), (4, 8)]


def test_errors_are_values(toy_gpt_layers, toy_optimizer, monkeypatch):
    with pytest.raises(ValueError, match="Unsupported layer: mixture"):
        tdsl.to_layer({"mixture": {}})
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        tdsl.Mapper(toy_gpt_layers, {"lion": {}})
    tm = NeuralNetworkModel("t", tdsl.Mapper(toy_gpt_layers, toy_optimizer),
                            device="cpu")
    with pytest.raises(ValueError, match="position"):
        tm.generate_tokens(list(range(14)), 32, 4, temperature=0)
    with pytest.raises(ValueError, match="prompt"):
        tm.generate_tokens([], 16, 4, temperature=0)
    monkeypatch.setenv("PAGED_KV_CACHE", "1")
    with pytest.raises(ValueError, match="position"):
        tm.generate_tokens(list(range(14)), 32, 4, temperature=0)
    with pytest.raises(ValueError, match="prompt"):
        tm.generate_tokens([], 16, 4, temperature=0)


def test_device_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve_device("gpu")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="Unknown device"):
        tdevice.resolve_device("tpuu")
