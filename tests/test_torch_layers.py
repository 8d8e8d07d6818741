"""The port's DSL modules against the JAX package's, on the same parameters
(random, from a numpy seed) and inputs: every algo the port gained with the
HF families (``scaledembedding``, ``flatten``, ``batchnorm1d``,
``softcap``, ``clamp``, ``rmsnorm``, ``relu``, ``silu``, ``sigmoid``,
``tanh``, ``parallelresidual``, ``transformerblock`` in both post-norm
orders, ``gatedmlp`` with each activation).

Tolerances: forward fp32 max abs diff <= 1e-5 and bf16 (parameters and
inputs cast, the JAX package's ``compute_dtype``) <= 2e-2; parameter
gradients of the parametrised modules <= 1e-4 (fp32).  Also: BatchNorm1d's
running statistics over two training steps and through a two-micro-step
epoch, the ``makemore_mlp`` preset trained end to end, and one AdamW step
of a tiny llama-shaped DSL (parameters <= 1e-5); ``moe``'s argument
checks (its parity is tests/test_torch_moe.py's)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from penroz_tpu.models import dsl as jdsl
from penroz_tpu.models import presets as jpresets
from penroz_tpu.models.dsl import Mapper as JMapper
from penroz_tpu.models.model import CompiledArch as JArch
from penroz_tpu.models.model import NeuralNetworkModel as JModel
from penroz_tpu.utils import checkpoint as jckpt
from penroz_tpu_torch.models import dsl as tdsl
from penroz_tpu_torch.models import presets
from penroz_tpu_torch.models.convert import as_tensor, from_jax_state_dict
from penroz_tpu_torch.models.hf_config import from_dict
from penroz_tpu_torch.models.model import CompiledArch as TArch
from penroz_tpu_torch.utils import checkpoint as tckpt

FWD_ATOL = {"float32": 1e-5, "bfloat16": 2e-2}
GRAD_ATOL = 1e-4


def _lin(i, o, **kw):
    return {"linear": {"in_features": i, "out_features": o, **kw}}


def _block(post_norms, on_residual):
    attn = {"attention": {"num_heads": 4, "num_kv_heads": 2,
                          "rope_theta": 10000.0, "head_dim": 4,
                          "qk_norm": True, "qk_norm_eps": 1e-6}}
    block = {"attn_block": {"sequential": [
                 {"rmsnorm": {"normalized_shape": 16}},
                 _lin(16, 32, bias=False), attn, _lin(16, 16, bias=False)]},
             "mlp_block": {"sequential": [
                 {"rmsnorm": {"normalized_shape": 16}},
                 {"gatedmlp": {"in_features": 16, "intermediate_size": 24,
                               "activation": "silu"}}]},
             "post_norm_on_residual": on_residual}
    if post_norms:
        block["post_attn_norm"] = {"rmsnorm": {"normalized_shape": 16}}
        block["post_mlp_norm"] = {"rmsnorm": {"normalized_shape": 16}}
    return [{"embedding": {"num_embeddings": 32, "embedding_dim": 16}},
            {"transformerblock": block}]


# name: (layers, input kind and shape)
CASES = {
    "scaledembedding": ([{"scaledembedding": {
        "num_embeddings": 11, "embedding_dim": 8, "scale": 3.3}}],
        ("tokens", (2, 5), 11)),
    "flatten": ([{"flatten": {}}], ("float", (2, 3, 4))),
    "flatten_0_1": ([{"flatten": {"start_dim": 0, "end_dim": 1}}],
                    ("float", (2, 3, 4))),
    "batchnorm1d": ([_lin(6, 8), {"batchnorm1d": {"num_features": 8}}],
                    ("float", (5, 6))),
    "batchnorm1d_3d": ([{"batchnorm1d": {"num_features": 3,
                                         "eps": 1e-3}}],
                       ("float", (4, 3, 5))),
    "softcap": ([_lin(6, 6), {"softcap": {"cap": 2.0}}],
                ("float", (2, 4, 6))),
    "clamp": ([_lin(6, 6), {"clamp": {"min": -0.3, "max": 0.4}}],
              ("float", (2, 4, 6))),
    "clamp_max": ([_lin(6, 6), {"clamp": {"max": 0.1}}],
                  ("float", (2, 4, 6))),
    "rmsnorm": ([{"rmsnorm": {"normalized_shape": 8, "eps": 1e-5}}],
                ("float", (2, 5, 8))),
    "relu": ([_lin(6, 6), {"relu": {}}], ("float", (2, 4, 6))),
    "silu": ([_lin(6, 6), {"silu": {}}], ("float", (2, 4, 6))),
    "sigmoid": ([_lin(6, 6), {"sigmoid": {}}], ("float", (2, 4, 6))),
    "tanh": ([_lin(6, 6), {"tanh": {}}], ("float", (2, 4, 6))),
    "parallelresidual": ([{"parallelresidual": [
        {"sequential": [{"layernorm": {"normalized_shape": 8}},
                        _lin(8, 8)]},
        {"sequential": [_lin(8, 16), {"silu": {}}, _lin(16, 8)]}]}],
        ("float", (2, 5, 8))),
    "transformerblock_post_on_residual": (_block(True, True),
                                          ("tokens", (2, 6), 32)),
    "transformerblock_post_on_branch": (_block(True, False),
                                        ("tokens", (2, 6), 32)),
    "transformerblock_no_post_norms": (_block(False, True),
                                       ("tokens", (2, 6), 32)),
    "gatedmlp_silu": ([{"gatedmlp": {"in_features": 8,
                                     "intermediate_size": 12,
                                     "activation": "silu"}}],
                      ("float", (2, 3, 8))),
    "gatedmlp_gelu_bias": ([{"gatedmlp": {"in_features": 8,
                                          "intermediate_size": 12,
                                          "bias": True,
                                          "activation": "gelu"}}],
                           ("float", (2, 3, 8))),
    "gatedmlp_gelu_tanh": ([{"gatedmlp": {"in_features": 8,
                                          "intermediate_size": 12}}],
                           ("float", (2, 3, 8))),
}


def _setup(layers, seed=0):
    """(JAX arch, params, buffers, port arch) holding the same random
    parameters and running statistics."""
    rng = np.random.default_rng(seed)
    jarch = JArch(layers)
    params, buffers = jdsl.init_module_params(jarch.mods, seed)
    params = {k: jnp.asarray((rng.normal(size=v.shape) * 0.3)
                             .astype(np.float32)) for k, v in params.items()}
    buffers = dict(buffers)
    for k in buffers:
        if k.endswith("running_mean"):
            buffers[k] = jnp.asarray(rng.normal(size=buffers[k].shape)
                                     .astype(np.float32))
        elif k.endswith("running_var"):
            buffers[k] = jnp.asarray(rng.uniform(0.5, 1.5, buffers[k].shape)
                                     .astype(np.float32))
    tarch = TArch(layers)
    state = {k: as_tensor(np.asarray(v)) for k, v in params.items()}
    state.update({k: as_tensor(np.asarray(v)) for k, v in buffers.items()})
    tarch.load_state_dict(state, strict=True)
    return jarch, params, buffers, tarch


def _input(kind, rng):
    if kind[0] == "tokens":
        return rng.integers(0, kind[2], kind[1]).astype(np.int64)
    return rng.normal(size=kind[1]).astype(np.float32)


def _to(x, dtype):
    if x.dtype.kind == "f":
        return jnp.asarray(x, dtype), torch.as_tensor(x).to(
            getattr(torch, jnp.dtype(dtype).name))
    return jnp.asarray(x, jnp.int32), torch.as_tensor(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, dtype):
    layers, kind = CASES[name]
    jarch, params, buffers, tarch = _setup(layers)
    assert [k for k, _ in tarch.named_parameters()] == jarch.param_order
    x = _input(kind, np.random.default_rng(1))
    jx, tx = _to(x, jnp.dtype(dtype))
    compute = None if dtype == "float32" else jnp.bfloat16
    acts, _, _, _ = jarch.forward(params, buffers, jx, compute_dtype=compute)
    tparams = {k: p.detach().to(getattr(torch, dtype))
               for k, p in tarch.named_parameters()}
    with torch.no_grad():
        tacts, _, _ = torch.func.functional_call(tarch, tparams, (tx,))
    want = np.asarray(acts[-1], np.float32)
    got = tacts[-1].float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=FWD_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("name", sorted(n for n in CASES
                                        if JArch(CASES[n][0]).param_order))
def test_gradients_match_jax(name):
    layers, kind = CASES[name]
    jarch, params, buffers, tarch = _setup(layers)
    rng = np.random.default_rng(2)
    x = _input(kind, rng)
    jx, tx = _to(x, jnp.float32)
    out = jarch.forward(params, buffers, jx)[0][-1]
    cot = rng.normal(size=out.shape).astype(np.float32)

    def loss(p):
        acts, _, _, _ = jarch.forward(p, buffers, jx)
        return jnp.sum(acts[-1] * cot)

    jgrads = jax.grad(loss)(params)
    tacts, _, _ = tarch(tx)
    (tacts[-1] * torch.as_tensor(cot)).sum().backward()
    for key, p in tarch.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgrads[key]),
                                   atol=GRAD_ATOL, rtol=0, err_msg=key)


BN_LAYERS = [_lin(6, 8), {"batchnorm1d": {"num_features": 8,
                                          "momentum": 0.3}},
             {"tanh": {}}, _lin(8, 3)]


def test_batchnorm_running_stats_over_two_training_steps():
    jarch, params, buffers, tarch = _setup(BN_LAYERS)
    rng = np.random.default_rng(3)
    for step in range(2):
        x = rng.normal(size=(7, 6)).astype(np.float32) * 2 + 1
        acts, _, updates, _ = jarch.forward(params, buffers, jnp.asarray(x),
                                            training=True)
        buffers = {**buffers, **updates}
        tacts, _, _ = tarch(torch.as_tensor(x), training=True)
        np.testing.assert_allclose(tacts[-1].detach().numpy(),
                                   np.asarray(acts[-1]), atol=1e-5)
    for key, value in tarch.named_buffers():
        assert value.dtype == as_tensor(np.asarray(buffers[key])).dtype, key
        np.testing.assert_allclose(value.numpy(), np.asarray(buffers[key]),
                                   atol=1e-6, err_msg=key)
    assert int(tarch.state_dict()["layers.1.num_batches_tracked"]) == 2
    # eval mode reads the running statistics
    x = rng.normal(size=(4, 6)).astype(np.float32)
    acts, _, _, _ = jarch.forward(params, buffers, jnp.asarray(x))
    with torch.no_grad():
        tacts, _, _ = tarch(torch.as_tensor(x))
    np.testing.assert_allclose(tacts[-1].numpy(), np.asarray(acts[-1]),
                               atol=1e-5)


def test_batchnorm_epoch_of_two_micro_steps():
    """One SGD epoch of two micro-steps (MSE): parameters, running
    statistics and the cost as the JAX package's epoch gives them."""
    sgd = {"sgd": {"lr": 0.1, "momentum": 0.9}}
    jarch, params, buffers, tarch = _setup(BN_LAYERS, seed=4)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(2, 5, 6)).astype(np.float32)
    ys = rng.normal(size=(2, 5, 3)).astype(np.float32)
    opt = jdsl.build_optimizer(sgd)
    fn = jarch.train_epoch_fn(sgd, 2)
    new_params, _, new_buffers, cost, _ = fn(
        dict(params), opt.init(params), buffers, jnp.asarray(xs),
        jnp.asarray(ys), jax.random.key(0))
    topt = tdsl.build_optimizer(sgd, list(tarch.parameters()))
    tcost, _ = tarch.train_epoch(topt, torch.as_tensor(xs),
                                 torch.as_tensor(ys))
    np.testing.assert_allclose(float(tcost), float(cost), rtol=1e-5)
    for key, value in tarch.state_dict().items():
        want = new_params.get(key, new_buffers.get(key))
        np.testing.assert_allclose(value.numpy(), np.asarray(want),
                                   atol=1e-5, err_msg=key)


def test_buffers_round_trip_with_jax_checkpoints(workdir, monkeypatch):
    """The port writes BatchNorm's statistics to the checkpoint's buffers
    section (int32 counter included): the JAX package loads them, and the
    port loads the JAX package's."""
    from penroz_tpu_torch.models.model import NeuralNetworkModel
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    sgd = {"sgd": {"lr": 0.1}}
    jm = JModel("jbn", JMapper(BN_LAYERS, sgd))
    jm.buffers = {k: (v + 1 if k.endswith("num_batches_tracked") else v * 3)
                  for k, v in jm.buffers.items()}
    jm.serialize(sync_flush=True)
    tm = NeuralNetworkModel.deserialize("jbn", device="cpu")
    tm.model_id = "tbn"
    tm.serialize(sync_flush=True)
    tckpt.join_flushes()
    back = JModel.deserialize("tbn")
    assert set(back.buffers) == set(jm.buffers)
    assert set(back.params) == set(jm.params)
    for key, value in jm.buffers.items():
        assert back.buffers[key].dtype == value.dtype, key
        np.testing.assert_array_equal(np.asarray(back.buffers[key]),
                                      np.asarray(value))


@pytest.fixture
def shared(workdir, monkeypatch, toy_shards):
    monkeypatch.setattr(tckpt, "SHM_PATH", jckpt.SHM_PATH)
    return toy_shards


def _pair(layers, optimizer):
    jm = JModel("j", JMapper(layers, optimizer))
    tm = from_jax_state_dict(jm.state_dict(), layers, optimizer,
                             model_id="t", device="cpu")
    return jm, tm


def test_makemore_mlp_preset_trains_like_jax(shared):
    layers = presets.makemore_mlp(vocab=64)
    assert layers == jpresets.makemore_mlp(vocab=64)
    jm, tm = _pair(layers, {"sgd": {"lr": 0.1}})
    run = dict(epochs=2, batch_size=4, block_size=8, step_size=2)
    jm.train_model(shared, **run)
    tm.train_model(shared, **run)
    assert tm.status["code"] == "Trained"
    for a, b in zip(jm.progress, tm.progress):
        np.testing.assert_allclose(b["cost"], a["cost"], rtol=1e-5)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    for key in jsd:
        np.testing.assert_allclose(tsd[key].numpy(), jsd[key], atol=1e-5,
                                   err_msg=key)
    out, _ = tm.compute_output([[1, 2, 3]])
    jout, _ = jm.compute_output([[1, 2, 3]])
    np.testing.assert_allclose(out, jout, atol=1e-5)


def test_adamw_step_of_a_llama_shaped_dsl(shared):
    raw = {"model_type": "llama", "hidden_size": 16, "num_hidden_layers": 2,
           "num_attention_heads": 4, "num_key_value_heads": 2,
           "intermediate_size": 24, "vocab_size": 64}
    layers = tdsl.Mapper.from_hf_config(from_dict(raw))
    jm, tm = _pair(layers, {"adamw": {"lr": 1e-3, "betas": [0.9, 0.95],
                                      "eps": 1e-8}})
    run = dict(epochs=1, batch_size=2, block_size=16, step_size=2)
    jm.train_model(shared, **run)
    tm.train_model(shared, **run)
    np.testing.assert_allclose(tm.progress[0]["cost"],
                               jm.progress[0]["cost"], rtol=1e-5)
    jsd, tsd = jm.state_dict(), tm.state_dict()
    assert set(tsd) == set(jsd)
    assert tm.arch.param_order == jm.arch.param_order
    for key in jsd:
        np.testing.assert_allclose(tsd[key].numpy(), jsd[key], atol=1e-5,
                                   rtol=0, err_msg=key)


def test_moe_algo_refused():
    """The ``moe`` algo builds; its invalid arguments are refused with the
    JAX package's ValueErrors (tests/test_torch_moe.py holds it to JAX),
    and an unknown algo is still refused."""
    entry = {"moe": {"in_features": 8, "intermediate_size": 16,
                     "num_experts": 4}}
    mod, = tdsl.build_modules([entry])
    assert mod.router.weight.shape == (4, 8) and mod.top_k == 2
    for bad, match in ((dict(top_k=5), r"top_k=5 outside \[1, 4\]"),
                       (dict(bias=True), "does not support bias"),
                       (dict(dispatch="sparse"), "dispatch must be"),
                       (dict(capacity_factor=0), "capacity_factor must")):
        with pytest.raises(ValueError, match=match):
            tdsl.build_modules([{"moe": {**entry["moe"], **bad}}])
    with pytest.raises(ValueError, match="Unsupported layer: nope"):
        tdsl.build_modules([{"nope": {}}])
