"""The hybrid attention/SSM family in the port against the JAX package, on
the CPU, from the same weights (carried over by ``from_jax_state_dict``):
``hybrid_custom(d=32, heads=4, depth=2, vocab=64, block=16)`` (block 0 an
SSM block, block 1 attention) and its pure-SSM variant (``ssm_every=1``,
no K/V layers).

- ``compute_output``: the final softmax and the cost, atol 1e-5;
- ``evaluate_model`` on a toy shard, with and without a target dataset:
  rel 1e-5;
- greedy generation, token for token across the overflow crop, on the
  contiguous, int8 and paged caches, streamed and not;
- one training micro-step (loss rtol 1e-5, every gradient within
  1e-4 · its max |g|) and ``train_model`` (the training tests'
  tolerances): the ``ssm`` algo does not break ``PUT /train/``.

All of it is fp32 on both sides; the differences are summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import from_jax_state_dict
from penroz_tpu_torch.ops import kv_cache as TKV
from penroz_tpu_torch.ops import modules as M

PROMPT = [1, 2, 3, 4, 5]
TOY = dict(d=32, heads=4, depth=2, vocab=64, block=16)


@pytest.fixture(params=[2, 1], ids=["hybrid", "pure_ssm"])
def ssm_every(request):
    return request.param


@pytest.fixture
def layers(ssm_every):
    return presets.hybrid_custom(**TOY, ssm_every=ssm_every)


@pytest.fixture
def pair(layers, toy_optimizer):
    """(JAX model, port model) holding the same weights."""
    jm = JModel("j", JMapper(layers, toy_optimizer))
    tm = from_jax_state_dict(jm.state_dict(), layers, toy_optimizer,
                             model_id="t", device="cpu")
    return jm, tm


def test_structure(pair, layers, ssm_every):
    """The preset is the JAX package's; ssm layers are indexed apart from
    attention layers."""
    _, tm = pair
    assert layers == jpresets.hybrid_custom(**TOY, ssm_every=ssm_every)
    n_ssm = 2 // ssm_every
    ssm = [m for m in tm.arch.modules() if isinstance(m, M.GatedSSM)]
    assert ssm == tm.arch.ssm_layers and len(ssm) == n_ssm
    assert [m.layer_idx for m in ssm] == list(range(n_ssm))
    assert tm.arch.ssm_specs == [(4, 8, 8)] * n_ssm
    assert len(tm.arch.kv_specs) == 2 - n_ssm


def test_compute_output_matches_jax(pair):
    jm, tm = pair
    rng = np.random.default_rng(0)
    x = rng.integers(0, 64, (2, 12)).tolist()
    y = rng.integers(0, 64, (2, 12)).tolist()
    for target in (None, y):
        j_out, j_cost = jm.compute_output(x, target)
        t_out, t_cost = tm.compute_output(x, target)
        np.testing.assert_allclose(np.asarray(t_out), np.asarray(j_out),
                                   atol=1e-5)
        assert np.asarray(t_out).shape == (2, 64)
        if target is None:
            assert t_cost is None and j_cost is None
        else:
            np.testing.assert_allclose(t_cost, j_cost, atol=1e-5)


def test_compute_output_refuses_flat_tokens(pair):
    """A 1-D token list is a ValueError (HTTP 400) in both packages: named
    at the boundary for a model with attention layers, from the SSM
    layer's (B, T, width) unpacking for a pure-SSM one."""
    jm, tm = pair
    match = "2-D" if tm.arch.attn_layers else "unpack"
    with pytest.raises(ValueError, match=match):
        tm.compute_output([1, 2, 3])
    with pytest.raises(ValueError, match=match):
        jm.compute_output([1, 2, 3])


@pytest.mark.parametrize("separate_targets", [False, True],
                         ids=["shifted", "target_dataset"])
def test_evaluate_matches_jax(workdir, toy_shards, pair, separate_targets):
    jm, tm = pair
    target = None
    if separate_targets:
        rng = np.random.default_rng(3)
        np.save(workdir / "data" / "toyt_000000",
                rng.integers(0, 64, 5000).astype(np.uint16))
        target = "toyt"
    args = (toy_shards, target, 0, 3, 2, 16, 1)
    want = jm.evaluate_model(*args)
    got = tm.evaluate_model(*args)
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_evaluate_refuses_meshes(workdir, toy_shards, pair, monkeypatch):
    _, tm = pair
    for name, value in (("PENROZ_MESH_MODEL", "2"), ("PENROZ_SP_MODE", "ring"),
                        ("PENROZ_MESH_SEQUENCE", "2")):
        monkeypatch.setenv(name, value)
        with pytest.raises(ValueError, match=name):
            tm.evaluate_model(toy_shards, None, 0, 1, 2, 16, 1)
        monkeypatch.delenv(name)
    assert tm.evaluate_model(toy_shards, None, 0, 0, 2, 16, 1) == 0.0


@pytest.mark.parametrize("env", [{}, {"TURBO_QUANT_KV_CACHE": "1"},
                                 {"PAGED_KV_CACHE": "1"}],
                         ids=["contiguous", "int8", "paged"])
def test_greedy_generation_matches_jax_across_crop(pair, monkeypatch, env):
    """5 + 30 tokens cross block 16: the crop resets the recurrent state
    with the cache and re-prefills, in both packages."""
    monkeypatch.setenv("PENROZ_KV_PAGE_SIZE", "4")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    jm, tm = pair
    expected = jm.generate_tokens(PROMPT, 16, 30, temperature=0)
    got = tm.generate_tokens(PROMPT, 16, 30, temperature=0)
    assert got == expected and len(got) == len(PROMPT) + 30
    streamed = list(tm.generate_tokens_stream(PROMPT, 16, 30,
                                              temperature=0))
    assert PROMPT + streamed == got


def test_cached_forward_equals_no_cache_forward(pair):
    """The dense cached path (sequential update_dense) and the no-cache path
    (gla_full) give the same logits, prefill and then one token at a
    time."""
    _, tm = pair
    x = torch.as_tensor(np.random.default_rng(5).integers(0, 64, (1, 10)))
    with torch.inference_mode():
        full, _, _ = tm.arch(x, skip_softmax=True)
        kv = TKV.create_kv_state(tm.arch.kv_specs, 1, 16,
                                 ssm_specs=tm.arch.ssm_specs)
        pre, _, kv = tm.arch(x[:, :6], kv=kv, skip_softmax=True)
        steps = [pre[-1]]
        for t in range(6, 10):
            out, _, kv = tm.arch(x[:, t:t + 1], kv=kv, skip_softmax=True)
            steps.append(out[-1])
    torch.testing.assert_close(torch.cat(steps, dim=1), full[-1], atol=1e-5,
                               rtol=0)


def test_micro_step_matches_jax(pair):
    """Loss and every parameter gradient of one training micro-step (the
    forward ``train_epoch`` differentiates) against the JAX package's."""
    jm, tm = pair
    rng = np.random.default_rng(7)
    x = rng.integers(0, 64, (2, 16))
    y = rng.integers(0, 64, (2, 16))

    def jloss(params):
        return jm.arch.forward(params, jm.buffers, jnp.asarray(x, jnp.int32),
                               jnp.asarray(y, jnp.int32), training=True,
                               rng=jax.random.PRNGKey(0),
                               skip_softmax=True)[1]

    j_cost, j_grads = jax.value_and_grad(jloss)(jm.params)
    named = dict(tm.arch.named_parameters())
    _, cost, _ = tm.arch(torch.as_tensor(x), torch.as_tensor(y),
                         skip_softmax=True, training=True,
                         generator=torch.Generator())
    grads = torch.autograd.grad(cost, list(named.values()))
    np.testing.assert_allclose(float(cost.detach()), float(j_cost),
                               rtol=1e-5)
    assert set(named) == set(j_grads)
    for (key, _), grad in zip(named.items(), grads):
        want = np.asarray(j_grads[key])
        worst = np.abs(grad.numpy() - want).max()
        assert worst <= 1e-4 * np.abs(want).max() + 1e-12, key


def test_train_model_matches_jax(workdir, toy_shards, pair):
    jm, tm = pair
    run = dict(epochs=2, batch_size=2, block_size=16, step_size=1)
    jm.train_model(toy_shards, **run)
    tm.train_model(toy_shards, **run)
    assert tm.status["code"] == "Trained"
    for a, b in zip(jm.progress, tm.progress):
        np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-5)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    for key in jsd:
        np.testing.assert_allclose(tsd[key].numpy(), jsd[key], atol=1e-4,
                                   err_msg=key)
